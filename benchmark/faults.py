"""Faults planted under the timed path, for the tests and the readings that
show a cell's numbers catch them (`control.py --fault`). Each takes the
runner before its set-up and breaks what the program does underneath."""

from __future__ import annotations

import numpy as np
import torch


def state_unchanged(runner):
    """Every tick returns its outputs but leaves the pool's state as it was."""
    step = runner.step

    def broken(inputs):
        before = runner.snapshot()
        out = step(inputs)
        runner.restore(before)
        return out
    runner.step = broken


def answer_altered(runner):
    """Every stream's first sample of every tick one step off."""
    step = runner.step

    def broken(inputs):
        out = step(inputs)
        for k, v in out.items():
            v = np.array(v, copy=True)
            v[0] = v[0] - 1 if v[0] > 0 else v[0] + 1
            out[k] = v
        return out
    runner.step = broken


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_unchanged(runner):
    """Every training step runs but hands back the parameters it started
    from."""
    step = runner.step

    def broken():
        before = [p.detach().clone() for p in _leaves(runner.trainer.params)]
        m = step()
        with torch.no_grad():
            for p, b in zip(_leaves(runner.trainer.params), before):
                p.copy_(b)
        return m
    runner.step = broken


def half_batch(runner):
    """Every training step on the first half of its batch, the mean taken
    over it."""
    batch = runner.batch

    def broken(k):
        return {n: v[: v.shape[0] // 2] for n, v in batch(k).items()}
    runner.batch = broken


SERVING = {"state_unchanged": state_unchanged, "answer_altered": answer_altered}
TRAINING = {"params_unchanged": params_unchanged, "half_batch": half_batch}
