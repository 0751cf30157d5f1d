"""Sampled-feedback (scheduled-sampling) history for vocoder fine-tuning.

Counterpart of `lpcnet_tpu/train/scheduled.py`. Teacher-forced training
never shows the network its own sampling errors, which compound through the
LPC feedback when it free-runs (exposure bias). For a scheduled fraction of
each training chunk, the signal history fed to the network is therefore the
model's OWN sampled output, and the loss teaches the excitation pdf to
steer back toward the true signal.

Two passes inside a train step:

1. Free-running pass, no gradient (`sampled_signal`): fuse the current
   parameters as inference does, then run the per-sample AR sampler over
   the chunk, one masked sample-loop launch per frame (K2,
   `kernels/sample_loop.py::synthesize_frame_masked_kernel`), with a
   Bernoulli teacher-force mask: the C `preload` resync semantics
   (src/lpcnet.c:256-259). Teacher-forced samples pin the trajectory to the
   target audio.
2. Gradient pass: the teacher-forced training graph with the signal-history
   input replaced, where pass 1 sampled, by the sampled signal
   (`mixed_history`). Gradients stop at the sampled feedback.
"""

from __future__ import annotations

import torch

from ..dsp import lpc as lpc_mod
from ..dsp.constants import LPC_ORDER, PREEMPHASIS
from ..kernels.sample_loop import (kernel_weights, masked_kernel_weights,
                                   synthesize_frame_masked_kernel)
from ..models import lpcnet as M
from ..nn import layers as nn
from ..utils.rng import Kiss99State


def deemphasis_seq(x: torch.Tensor, block: int = 160) -> torch.Tensor:
    """The decoder's de-emphasis IIR out[t] = x[t] + P*out[t-1] along the
    last axis, in closed form: within a block of `block` samples
    out = L x + p * carry, with L the lower-triangular matrix of powers of P
    and p[i] = P^(i+1); one matmul for all blocks, then the carry from block
    to block. (The JAX package uses an associative scan; a per-sample loop
    would be one launch per sample.)"""
    t = x.shape[-1]
    nblk = -(-t // block)
    xp = torch.nn.functional.pad(x, (0, nblk * block - t))
    xb = xp.reshape(x.shape[:-1] + (nblk, block))
    i = torch.arange(block, device=x.device)
    expo = (i[:, None] - i[None, :]).clamp(min=0).to(x.dtype)
    p = torch.tensor(PREEMPHASIS, dtype=x.dtype, device=x.device)
    tri = torch.tril(torch.pow(p, expo))                      # [i, j] = P^(i-j)
    y = torch.matmul(xb, tri.T)
    ramp = torch.pow(p, (i + 1).to(x.dtype))                  # P^(i+1)
    carry = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    out = []
    for k in range(nblk):
        blk = y[..., k, :] + ramp * carry[..., None]
        carry = blk[..., -1]
        out.append(blk)
    return torch.cat(out, dim=-1)[..., :t]


def _kiss_seeds(b: int, rng: torch.Generator, device) -> Kiss99State:
    """Per-stream KISS99 words from the generator (jsr odd, so never 0),
    as int64 tensors holding uint32 values."""
    bits = torch.randint(0, 1 << 32, (4, b), generator=rng,
                         dtype=torch.int64, device=rng.device).to(device)
    return Kiss99State(bits[0], bits[1], bits[2] | 1, bits[3])


@torch.no_grad()
def sampled_signal(params, cfg: M.LPCNetConfig, batch, tf_mask,
                   rng: torch.Generator, gru_states=None, weighting=None):
    """Pass 1: the model's own sampled trajectory over a training chunk.

    batch: dict with sig_out [B, T] (clean target, pre-emphasised domain),
    features [B, Tf, >=20], periods [B, Tf], lpc [B, T//160, 16].
    tf_mask [B, T] bool: True teacher-forces the sample to the target,
    False feeds back the model's own sample. rng seeds the per-stream
    KISS99 state of the sampler. gru_states: optional (h_a, h_b) carry to
    start from. weighting: optional [16] LPC tap weighting (the training
    graph's tensor_preds filter).

    Returns s_hat [B, T] in the pre-emphasised (pcm) domain, aligned with
    sig_out; teacher-forced positions reproduce the target up to the
    de-emphasis state's self-correction and rounding. No gradient flows.
    """
    sig_out = batch["sig_out"]
    b, t = sig_out.shape
    dev = sig_out.device
    fs = cfg.frame_size
    n_frames = t // fs
    p = _detach_tree(params)
    fused = M.fuse_inference_params(p, cfg)
    cfeat = M.frame_network_seq(p, batch["features"], batch["periods"],
                                cfg)[:, :n_frames]
    cond_a = nn.dense(fused["cond_to_a"], cfeat)              # [B, F, 3Na]
    cond_b = nn.dense(fused["cond_to_b"], cfeat)
    if cfg.e2e:
        lpc = lpc_mod.rc2lpc(cfeat[..., :LPC_ORDER])
    else:
        lpc = batch["lpc"][:, :n_frames]
    if weighting is not None:
        lpc = lpc * weighting

    # the masked sampler teacher-forces in the DE-EMPHASISED domain
    # (pcm_tf = target - P*deemph); give it the de-emphasised target so that
    # teacher-forced samples reproduce sig_out
    target_de = deemphasis_seq(sig_out)

    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    state = M.SampleState(
        gru_a=(gru_states[0].detach() if gru_states is not None
               else z(b, cfg.rnn_units1)),
        gru_b=(gru_states[1].detach() if gru_states is not None
               else z(b, cfg.rnn_units2)),
        last_sig=z(b, LPC_ORDER),
        last_exc=torch.full((b,), 128, dtype=torch.int32, device=dev),
        deemph=z(b),
        rng=_kiss_seeds(b, rng, dev),
    )
    kw = masked_kernel_weights(kernel_weights(fused, cfg))
    adv = torch.ones((b, fs), dtype=torch.bool, device=dev)
    out = []
    for f in range(n_frames):
        sl = slice(f * fs, (f + 1) * fs)
        state, pcm = synthesize_frame_masked_kernel(
            kw, state, cond_a[:, f].contiguous(), cond_b[:, f].contiguous(),
            lpc[:, f].contiguous(), target_de[:, sl], tf_mask[:, sl], adv, fs)
        out.append(pcm)
    out = torch.cat(out, dim=1)                               # de-emphasised
    # back to the pre-emphasised (training signal) domain
    prev = torch.cat([z(b, 1), out[:, :-1]], dim=1)
    return out - PREEMPHASIS * prev


def _detach_tree(tree):
    if isinstance(tree, dict):
        return {k: _detach_tree(v) for k, v in tree.items()}
    return tree.detach()


def mixed_history(sig_in, s_hat, tf_mask):
    """Pass-2 input: the signal history with the sampled trajectory where
    pass 1 free-ran. sig_in[t] is the (noise-augmented) target delayed by
    one sample, so position t's history sample is pass-1 position t-1: keep
    sig_in where t-1 was teacher-forced, use s_hat[t-1] where it was
    sampled."""
    b = sig_in.shape[0]
    ones = torch.ones((b, 1), dtype=torch.bool, device=sig_in.device)
    use_data = torch.cat([ones, tf_mask[:, :-1].bool()], dim=1)
    shifted = torch.cat([sig_in[:, :1], s_hat[:, :-1]], dim=1)
    return torch.where(use_data, sig_in, shifted)
