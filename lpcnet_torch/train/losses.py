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


def tf_u2l(u: torch.Tensor) -> torch.Tensor:
    u = u.to(torch.float32) - 128.0
    return torch.sign(u) * _SCALE_1 * (torch.exp(u.abs() / 128.0 * LOG256) - 1.0)


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


def tree_pdf_at(p: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """pdf[label] from the bit-tree outputs without the dense pdf: the 8 node
    probabilities on the label's path, multiplied in level order (so equal
    bit for bit to `tree_to_pdf(p)` gathered at the label)."""
    nodes, bits = _tree_paths(labels.long())
    pb = torch.gather(p, -1, nodes)
    terms = torch.where(bits == 1, pb, 1.0 - pb)
    val = torch.ones(labels.shape, dtype=p.dtype, device=p.device)
    for b in range(8):
        val = val * terms[..., b]
    return val


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


def tree_distill_kl(q: torch.Tensor, p: torch.Tensor, eps: float = 1e-6
                    ) -> torch.Tensor:
    """KL(Q || P) between the 256-way distributions of two bit trees, q the
    teacher and p the student, level by level: by the chain rule over the 8
    bit decisions, the sum over nodes of reachQ[node] * KL_Bernoulli(q, p).
    Level b occupies nodes [2^b, 2^(b+1))."""
    qc = torch.clamp(q, eps, 1.0 - eps)
    pc = torch.clamp(p, eps, 1.0 - eps)
    reach = torch.ones(q.shape[:-1] + (1,), dtype=q.dtype, device=q.device)
    total = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    for b in range(8):
        qb, pb = qc[..., 1 << b:2 << b], pc[..., 1 << b:2 << b]
        kl = qb * (torch.log(qb) - torch.log(pb)) + \
            (1.0 - qb) * (torch.log1p(-qb) - torch.log1p(-pb))
        total = total + (reach * kl).sum(-1)
        if b < 7:
            reach = torch.stack([reach * (1.0 - qb), reach * qb],
                                dim=-1).reshape(q.shape[:-1] + (2 << b,))
    return total


def _rounded_ulaw(sig_out, tensor_preds):
    e_gt = tf_l2u(sig_out - tensor_preds)
    return torch.clamp(torch.round(e_gt).long(), 0, 255)


def metric_cel_tree(sig_out, tensor_preds, p, eps: float = 1e-7):
    """metric_cel along the target's tree path (no dense pdf)."""
    return tree_neg_log_pdf(p, _rounded_ulaw(sig_out, tensor_preds), eps)


def _interp_mulaw(sig_out, tensor_preds, real_preds, prob_at, gamma):
    e_gt = tf_l2u(sig_out - tensor_preds)
    exc_gt = tf_l2u(sig_out - real_preds)
    prob_comp = (e_gt - 128.0).abs() / 128.0 * LOG256
    regularization = (exc_gt - 128.0).abs() / 128.0 * LOG256
    alpha = e_gt - torch.floor(e_gt)
    ei = torch.clamp(e_gt.long(), 0, 254)
    interp = (1.0 - alpha) * prob_at(ei) + alpha * prob_at(ei + 1)
    ce = -torch.log(torch.clamp(interp, 1e-7, 1.0))
    return ce + prob_comp + gamma * regularization


def interp_mulaw_loss_tree(sig_out, tensor_preds, real_preds, p,
                           gamma: float = 2.0):
    """interp_mulaw_loss via two target-path gathers (same numerics)."""
    return _interp_mulaw(sig_out, tensor_preds, real_preds,
                         lambda i: torch.exp(-tree_neg_log_pdf(p, i)), gamma)


def sparse_cat_ce(labels, probs, eps: float = 1e-7):
    """-log(p[label]) like Keras SparseCategoricalCrossentropy on probs."""
    p = torch.gather(probs, -1, labels.long()[..., None])[..., 0]
    return -torch.log(torch.clamp(p, eps, 1.0))


def metric_cel(sig_out, tensor_preds, pdf):
    """Rounded u-law CE on the LPC residual (lossfuncs.py:74-83)."""
    return sparse_cat_ce(_rounded_ulaw(sig_out, tensor_preds), pdf)


def interp_mulaw_loss(sig_out, tensor_preds, real_preds, pdf,
                      gamma: float = 2.0):
    """Interpolated u-law CE + probability compensation for e2e training
    (lossfuncs.py:25-43), on the dense pdf."""
    return _interp_mulaw(
        sig_out, tensor_preds, real_preds,
        lambda i: torch.gather(pdf, -1, i[..., None])[..., 0], gamma)


def metric_exc_sd(sig_out, tensor_preds):
    return (tf_l2u(sig_out - tensor_preds) - 128.0) ** 2


def loss_matchlar(rc_true, rc_model):
    """LAR matching loss for the e2e RC head (lossfuncs.py:92-99)."""
    lar = lambda x: torch.log((1.01 + x) / (1.01 - x))
    return ((lar(rc_model) - lar(rc_true)) ** 2).mean(-1)
