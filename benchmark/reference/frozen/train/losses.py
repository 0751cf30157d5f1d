# Frozen copy of lpcnet_torch/train/losses.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""Training losses and metrics for the vocoder (training_tf2/lossfuncs.py and
tf_funcs.py): differentiable u-law, LPC prediction, bit-tree pdf, CE.
Counterpart of `lpcnet_tpu/train/losses.py`, function by function."""

from __future__ import annotations

import math

import torch

from ..nn.layers import repeat_frames

LOG256 = math.log(256.0)
_SCALE = 255.0 / 32768.0
_SCALE_1 = 32768.0 / 255.0


def tf_l2u(x: torch.Tensor) -> torch.Tensor:
    """Differentiable linear -> u-law (tf_funcs.py:14-19), float output."""
    u = torch.sign(x) * (128.0 * torch.log1p(_SCALE * x.abs()) / LOG256)
    return torch.clamp(128.0 + u, 0.0, 255.0)


def diff_pred(x: torch.Tensor, lpc: torch.Tensor, frame_size: int = 160
              ) -> torch.Tensor:
    """Differentiable LPC prediction (tf_funcs.py:31-42).

    x [B, T] signal, lpc [B, T // frame_size, 16] per-frame coefficients.
    Returns pred [B, T]: pred[t] = -sum_i lpc[t // 160, i] * x[t - i] (taps
    start at lag 0: the signal input is already one sample behind the
    target).
    """
    order = lpc.shape[-1]
    lpc_rep = repeat_frames(lpc, frame_size)                     # [B, T, 16]
    xp = torch.nn.functional.pad(x, (order - 1, 0))
    # wins[t, j] = xp[t + j] = x[t - (order - 1 - j)]
    wins = xp.unfold(-1, order, 1)                               # [B, T, 16]
    return -(lpc_rep * wins.flip(-1)).sum(-1)


def _tree_paths(labels: torch.Tensor):
    """Node index and bit at each of the 8 levels on the way to `labels`."""
    nodes = torch.stack([(labels >> (8 - b)) + (1 << b) for b in range(8)], -1)
    bits = torch.stack([(labels >> (7 - b)) & 1 for b in range(8)], -1)
    return nodes, bits


def tree_to_pdf(p: torch.Tensor) -> torch.Tensor:
    """[..., 256] sigmoid bit-tree outputs -> [..., 256] pdf
    (training_tf2/lpcnet.py:50-58); unit 0 is unused."""
    idx = torch.arange(256, device=p.device)
    pdf = torch.ones_like(p)
    for b in range(8):
        node = (idx >> (8 - b)) + (1 << b)
        bit = (idx >> (7 - b)) & 1
        pb = p[..., node]
        pdf = pdf * torch.where(bit == 1, pb, 1.0 - pb)
    return pdf


def tree_neg_log_pdf(p: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7
                     ) -> torch.Tensor:
    """-log(pdf[label]) in the log domain: the sum over the label's 8 path
    nodes of log(p) (bit 1) or log(1-p) (bit 0), each floored at 1e-20,
    clamped at -log(eps) like the dense path's pdf clipping. The JAX
    package builds the path as 256-wide masks (a TPU lowering concern); a
    gather of the 8 nodes sums the same terms."""
    nodes, bits = _tree_paths(labels.long())
    pb = torch.gather(p, -1, nodes)
    tiny = 1e-20
    term = torch.where(bits == 1, torch.log(torch.clamp(pb, min=tiny)),
                       torch.log(torch.clamp(1.0 - pb, min=tiny)))
    return torch.clamp(-term.sum(-1), max=-math.log(eps))


def _rounded_ulaw(sig_out, tensor_preds):
    e_gt = tf_l2u(sig_out - tensor_preds)
    return torch.clamp(torch.round(e_gt).long(), 0, 255)


def metric_cel_tree(sig_out, tensor_preds, p, eps: float = 1e-7):
    """metric_cel along the target's tree path (no dense pdf)."""
    return tree_neg_log_pdf(p, _rounded_ulaw(sig_out, tensor_preds), eps)
