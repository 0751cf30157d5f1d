"""Vocoder training: `Trainer.train_step` on a fixed set of batches drawn
from the seed at set-up and cycled through the window.

Set-up builds one trainer, drives it through its first three steps on
three different batches (through `train_step`, as the window does), and
hands the same trainer to the window. The reference
(`reference/<config>.py::train_steps`) follows those three steps from the
same weights, batches and noise. Numbers compared: the three losses'
widest relative gap (`loss_gap`), step 1's gradient norm by leaf, the
program's read back from Adam's first moment (`grad_gap`), and the norm of
each leaf's change after the three steps (`change_gap`), each against the
reference's norm of that leaf or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import time

import torch

from .. import generate as G
from .. import weights as W
from ..yardstick import work
from .common import free_device, sync

CHECK_STEPS = 3


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


class Runner:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        self.c, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ref = reference
        self.batches = G.train_batches(traffic, config, G.sub_seed(seed, 1),
                                       device)
        self.raw = W.raw_lpcnet(config, traffic, seed, device)
        self.step_index = 0

    def step_seed(self, k: int) -> int:
        return G.sub_seed(self.seed, 3, k)

    # ---- the program ------------------------------------------------------

    def setup(self):
        from lpcnet_torch.models import lpcnet as M
        from lpcnet_torch.train.train_lpcnet import TrainConfig, Trainer
        c, t = self.c, self.traffic
        cfg = M.LPCNetConfig(rnn_units1=c["rnn_units1"], rnn_units2=c["rnn_units2"],
                             cond_size=c["cond_size"],
                             nb_used_features=c["nb_used_features"],
                             frame_size=c["frame_size"],
                             conv_kernel=c["conv_kernel"],
                             pitch_embed_dim=c["pitch_embed_dim"],
                             lookahead=c["lookahead"])
        o = t["optimizer"]
        self.trainer = Trainer(cfg, TrainConfig(
            batch_size=t["batch"], chunk_frames=t["chunk_frames"],
            ss_prob=t["ss_prob"], lr=o["lr"], decay=o["decay"],
            beta1=o["beta1"], beta2=o["beta2"], input_noise=o["input_noise"]),
            device=self.device)
        self.trainer.set_params(W.clone(self.raw))
        self.gen = torch.Generator(device=self.device)
        self.prog = {"losses": []}
        for k in range(CHECK_STEPS):
            m = self.step()
            self.prog["losses"].append(float(m["loss"].detach()))
            if k == 0:
                self.prog["grad_norms"] = self._first_grad_norms()
        self.prog["change_norms"] = {
            n: float((p.detach() - dict(_leaves(self.raw))[n]).norm())
            for n, p in _leaves(self.trainer.params)}

    def _first_grad_norms(self) -> dict:
        """Step 1's gradient by leaf as the optimizer got it: Adam's first
        moment after one step is (1 - beta1) g."""
        b1 = self.trainer.tc.beta1
        st = self.trainer.optimizer.state
        return {n: float(st[p]["exp_avg"].norm()) / (1.0 - b1)
                for n, p in _leaves(self.trainer.params)}

    def batch(self, k: int) -> dict:
        return self.batches[k % len(self.batches)]

    def step(self):
        k = self.step_index
        self.gen.manual_seed(self.step_seed(k))
        m = self.trainer.train_step(self.batch(k), self.gen)
        self.step_index += 1
        return m

    def window(self, seconds: float, rs=None) -> dict:
        sync(self.device)
        first = self.step_index
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.step()
        sync(self.device)
        self.window_s = time.perf_counter() - start
        self.window_steps = self.step_index - first
        return {"train_step_ms": 1e3 * self.window_s / self.window_steps,
                "units": self.window_steps}

    def stretch(self):
        n = self.traffic["trace_steps"]
        self.traced_steps = n

        def run():
            for _ in range(n):
                self.step()
        return run

    def facts(self) -> dict:
        t = self.traffic
        need = self.window_steps * work.train_step_seconds(
            self.c, t["batch"], t["chunk_frames"])
        return {"batch": t["batch"], "chunk_frames": t["chunk_frames"],
                "window_s": self.window_s, "steps": self.window_steps,
                "least_compute_s": need, "traced_steps": self.traced_steps}

    def counters(self) -> dict:
        return {}

    def free(self):
        self.trainer = None
        free_device()

    # ---- the reference ----------------------------------------------------

    def check(self) -> dict:
        R = self.ref
        cfg = R.model_config(self.c)
        seeds = [self.step_seed(k) for k in range(CHECK_STEPS)]
        ref = R.train_steps(self.raw, cfg, self.traffic["optimizer"], self.batches, seeds,
                            self.device)
        return R.train_gaps(self.prog, ref)

    def control(self, precision: str = "fp8") -> dict:
        """The reference in float8 operands in the program's place, judged
        as `check` judges a run."""
        R = self.ref
        cfg = R.model_config(self.c)
        seeds = [self.step_seed(k) for k in range(CHECK_STEPS)]
        self.prog = R.train_steps(self.raw, cfg, self.traffic["optimizer"], self.batches, seeds,
                                  self.device, precision=precision)
        return self.check()
