"""Comparisons of the program's outputs and states with the reference's."""

from __future__ import annotations

import torch


def rebuild(template, prog):
    """The program's state tree `prog` in the reference's types: NamedTuples
    are rebuilt field by field by the names of `template` (the reference's
    own state of the same kind), tensors cloned. A field the program lacks
    raises."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(rebuild(t, getattr(prog, f))
                                for f, t in zip(template._fields, template)))
    if isinstance(template, tuple):
        return tuple(rebuild(t, p) for t, p in zip(template, prog))
    return prog.detach().clone()


def leaves(tree, path=""):
    """(path, tensor) of a tree of NamedTuples, tuples and dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from leaves(v, f"{path}/{k}")
    else:
        yield path, tree


STATE_TOL = 1e-4


def apart_rows(ref, prog, batch_axis=lambda path: 0, tol: float = STATE_TOL):
    """[B] bool: the streams whose state in `prog` departs from `ref`'s. A
    float leaf departs where a stream's largest difference exceeds `tol`
    times the leaf's largest magnitude in the reference (float32 sums in
    another order part by ~1e-6 of it; one int8 step is 8e-3); an integer
    or boolean leaf where any value differs. `prog` may be the program's
    own tree: it is read in the reference's types first."""
    prog = rebuild(ref, prog)
    apart = None
    for (path, r), (_, p) in zip(leaves(ref), leaves(prog)):
        ax = batch_axis(path)
        r, p = r.detach().movedim(ax, 0), p.detach().to(r.device).movedim(ax, 0)
        if r.is_floating_point():
            scale = max(float(r.abs().max()), 1e-6)
            d = (r.double() - p.double()).abs().reshape(r.shape[0], -1)
            rows = (d.amax(dim=1) if d.shape[1] else d[:, 0] * 0) > tol * scale
        else:
            rows = (r != p.to(r.dtype)).reshape(r.shape[0], -1).any(dim=1)
        apart = rows if apart is None else apart | rows
    return apart


def mismatched_rows(ref_out: torch.Tensor, prog_out, head: int | None = None
                    ) -> torch.Tensor:
    """[B] bool: the streams whose output [B, n] differs in any sample (of
    the first `head` samples, where given)."""
    r = ref_out.reshape(ref_out.shape[0], -1)
    p = torch.as_tensor(prog_out).to(r.device, r.dtype).reshape(r.shape)
    return (r[:, :head] != p[:, :head]).any(dim=1)
