# Frozen copy of lpcnet_torch/dred/entropy.py at commit 027a43f, kept to its
# Python coder: the range encoder, the latent code, the PVQ search and
# index, the fixed-point tables and the payload framing. Part of the
# benchmark's yardstick: not to be edited.
"""DRED entropy coding, host-side: a binary range coder with Q15
probabilities; Laplace-model latent coding that decomposes the reference's
hard_rate_estimate (torch/rdovae/rdovae/rdovae.py:103-132) into a zero flag
with P(0)=p0, a sign bit at P=1/2 and geometric continue flags with
P(continue)=r; an enumerative pyramid-vector-quantizer index for the
decoder's initial state in a fixed ceil(log2 V(24,82)) bits; and the
framed payload of one redundancy packet."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.rdovae import MAX_MAG, pvq_codebook_size, statistical_model

Q15_ONE = 1 << 15
_TOP = 1 << 32
_BOT = 1 << 24


class RangeEncoder:
    """Binary range coder over exact (bignum) interval arithmetic."""

    def __init__(self):
        self.low = 0
        self.range = _TOP - 1   # 0xFFFFFFFF, matching the uint32 native coder
        self.shift = 0          # number of renormalization bytes

    def encode_bit(self, bit: int, p0_q15: int):
        """Encode one binary decision; p0_q15 = P(bit == 0) in [1, 32767]."""
        split = (self.range * p0_q15) >> 15
        split = min(max(split, 1), self.range - 1)
        if bit:
            self.low += split
            self.range -= split
        else:
            self.range = split
        while self.range < _BOT:
            self.low <<= 8
            self.range <<= 8
            self.shift += 1

    def finish(self) -> bytes:
        """Close the stream: pick the codeword in [low, low+range) with the
        most trailing zero bytes; trailing zeros are dropped (the decoder
        reads missing bytes as zero)."""
        nbytes = self.shift + 4
        code = self.low + self.range - 1    # fallback: top of interval
        for m in range(nbytes, -1, -1):
            step = 1 << (8 * m)
            c = (self.low + step - 1) // step * step
            if c < self.low + self.range:
                code = c
                break
        raw = code.to_bytes(nbytes, "big")
        return raw.rstrip(b"\x00")


def clamp_q15(p: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(p), 1, Q15_ONE - 1).astype(np.int64)


def encode_latents(enc: RangeEncoder, zq: np.ndarray, p0_q15: np.ndarray,
                   r_q15: np.ndarray):
    """zq [L, D] int symbols; p0/r [L, D] Q15 per-position probabilities."""
    zq = np.asarray(zq, np.int64).reshape(-1)
    p0 = clamp_q15(p0_q15).reshape(-1)
    r = clamp_q15(r_q15).reshape(-1)
    for z, p, rr in zip(zq, p0, r):
        if z == 0:
            enc.encode_bit(0, int(p))
            continue
        enc.encode_bit(1, int(p))
        enc.encode_bit(1 if z < 0 else 0, Q15_ONE >> 1)
        mag = min(abs(int(z)), MAX_MAG)
        p_stop = Q15_ONE - int(rr)
        for _ in range(mag - 1):
            enc.encode_bit(1, p_stop)
        if mag < MAX_MAG:
            enc.encode_bit(0, p_stop)


def pvq_search(x: np.ndarray, k: int) -> np.ndarray:
    """Nearest signed pulse vector with sum(|y|) == k (greedy cosine search):
    initial projection onto the L1 ball then one pulse at a time maximizing
    correlation^2 / energy."""
    x = np.asarray(x, np.float64)
    ax = np.abs(x)
    l1 = ax.sum()
    y = np.zeros(x.shape, np.int64) if l1 <= 0 else \
        np.floor(k * ax / l1 * 0.9999).astype(np.int64)
    if y.sum() > k:                       # numeric safety
        while y.sum() > k:
            y[np.argmax(y)] -= 1
    corr = float((y * ax).sum())
    energy = float((y * y).sum())
    for _ in range(k - int(y.sum())):
        num = (corr + ax) ** 2
        den = energy + 2.0 * y + 1.0
        i = int(np.argmax(num / den))
        corr += ax[i]
        energy += 2.0 * y[i] + 1.0
        y[i] += 1
    return (np.sign(x).astype(np.int64) * y).astype(np.int64)


def pvq_encode_index(y: Sequence[int], k: int) -> int:
    """Enumerative index of a signed pulse vector (canonical ordering:
    per position, magnitude 0 first then +1,-1,+2,-2,...)."""
    y = list(int(v) for v in y)
    if sum(abs(v) for v in y) != k:
        raise ValueError(f"a PVQ vector of {k} pulses expected")
    n = len(y)
    idx = 0
    for j, v in enumerate(y):
        rem = n - j - 1
        if v != 0:
            idx += pvq_codebook_size(rem, k)
            for m in range(1, abs(v)):
                idx += 2 * pvq_codebook_size(rem, k - m)
            if v < 0:
                idx += pvq_codebook_size(rem, k - abs(v))
        k -= abs(v)
    return idx


def pvq_index_bits(n: int, k: int) -> int:
    return max(1, int(pvq_codebook_size(n, k) - 1).bit_length())


def stats_fixed_point(params, cfg) -> dict:
    """uint16 tables [quant_levels, latent_dim]
    (torch/rdovae/export_rdovae_weights.py:55-64): r Q15, p0 Q15 with
    p0 = 1 - r^(0.5+0.5*theta), from the statistical model in float32,
    rounded in numpy float64."""
    table = params["statistical_model"]["quant_embedding"]["table"]
    q_ids = torch.arange(cfg.quant_levels, device=table.device)
    with torch.no_grad():
        st = statistical_model(params, q_ids, cfg)
    f64 = lambda name: st[name].cpu().numpy().astype(np.float64)
    r, theta = f64("r_hard"), f64("theta_hard")
    p0 = 1.0 - r ** (0.5 + 0.5 * theta)
    return {
        "r_q15": np.clip(np.round(r * Q15_ONE), 1, Q15_ONE - 1).astype(np.uint16),
        "p0_q15": np.clip(np.round(p0 * Q15_ONE), 1, Q15_ONE - 1).astype(np.uint16),
    }


# byte 0      : version (high nibble) | q0 (low nibble)
# byte 1      : q1 (high nibble) | n_latents high nibble
# byte 2      : n_latents low byte
# bytes 3..   : PVQ state index, big-endian, ceil(pvq_index_bits/8) bytes
# bytes  ..   : range-coded latents (oldest..newest, dims ascending)

_VERSION = 1


def payload_q_ids(n_latents: int, q0: int, q1: int) -> np.ndarray:
    """Oldest latent gets the coarsest level q1, newest q0
    (torch/rdovae/fec_encoder.py:125-127)."""
    if n_latents == 1:
        return np.array([q0], np.int32)
    return np.round(q1 + (q0 - q1) * np.arange(n_latents) / (n_latents - 1)
                    ).astype(np.int32)


def encode_payload(zq: np.ndarray, state_pulses: np.ndarray, q0: int, q1: int,
                   stats: dict, state_k: int) -> bytes:
    """zq [L, D] int latent symbols (oldest first), state_pulses [S] ints with
    sum(|.|) == state_k. Returns the framed payload, the latents coded by
    the Python range coder."""
    zq = np.asarray(zq)
    n_latents = zq.shape[0]
    header = bytes([(_VERSION << 4) | q0,
                    (q1 << 4) | (n_latents >> 8),
                    n_latents & 0xFF])
    sbits = pvq_index_bits(len(state_pulses), state_k)
    sidx = pvq_encode_index(state_pulses, state_k)
    sbytes = sidx.to_bytes((sbits + 7) // 8, "big")
    q_ids = payload_q_ids(n_latents, q0, q1)
    enc = RangeEncoder()
    encode_latents(enc, zq, stats["p0_q15"][q_ids], stats["r_q15"][q_ids])
    return header + sbytes + enc.finish()
