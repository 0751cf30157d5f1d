"""DRED entropy coding: redundancy bitstreams, not just rate estimates.

The host code of the JAX package's `dred/entropy.py`, kept as this
package's own copy. The reference ships fixed-point statistical tables for
its DRED latents (torch/rdovae/export_rdovae_weights.py:55-76: quant_scales
Q8, dead_zone Q10, Laplace r Q15, p0 Q15, uint16 per (level, dim)) and
leaves the range coding to its consumer (Opus). This module completes the
pipeline:

* a binary range coder with Q15 probabilities (encoder and decoder);
* Laplace-model latent coding that decomposes the reference's
  hard_rate_estimate (torch/rdovae/rdovae/rdovae.py:103-132) into binary
  decisions: a zero flag with P(0)=p0, a sign bit at P=1/2, and geometric
  continue flags with P(continue)=r, so the achieved rate is the model's
  estimate -log2(0.5*(1-p0)*(1-r)*r^(|z|-1)) up to Q15 rounding;
* an enumerative pyramid-vector-quantizer index for the 24-dim / 82-pulse
  decoder initial state (cf. pvq_quantize, rdovae.py:40-100), coded in a
  fixed ceil(log2 V(24,82)) bits;
* the framed payload of one redundancy packet.

Host-side by design: entropy coding is bit-serial and branchy; the card
computes the symbols and probabilities in batch, the host packs bits. This
is the Python coder; the bytes are those of the JAX package's coder (its
native C++ fast path gives the same bytes).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..models.rdovae import pvq_codebook_size, statistical_model

Q15_ONE = 1 << 15
_TOP = 1 << 32
_BOT = 1 << 24
MAX_MAG = 255          # |z| clamp; keeps the geometric code bounded


class RangeEncoder:
    """Binary range coder over exact (bignum) interval arithmetic.

    The interval [low, low+range) lives at scale 2^(32+8k) after k byte
    renormalizations; `low` is an exact Python int so carries never need
    special-casing. Payloads are ~100 B, so the bignum cost is negligible.
    """

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

    def encode_bits_raw(self, value: int, nbits: int):
        """Raw (equiprobable) bits, MSB first."""
        for i in range(nbits - 1, -1, -1):
            self.encode_bit((value >> i) & 1, Q15_ONE >> 1)

    def finish(self) -> bytes:
        """Close the stream: pick the codeword in [low, low+range) with the
        most trailing zero bytes; trailing zeros are dropped (the decoder
        reads missing bytes as zero)."""
        nbytes = self.shift + 4
        # smallest multiple of 256^m >= low that still falls in the interval
        code = self.low + self.range - 1    # fallback: top of interval
        for m in range(nbytes, -1, -1):
            step = 1 << (8 * m)
            c = (self.low + step - 1) // step * step
            if c < self.low + self.range:
                code = c
                break
        raw = code.to_bytes(nbytes, "big")
        return raw.rstrip(b"\x00")


class RangeDecoder:
    """Mirror of RangeEncoder; bytes past the payload read as zero."""

    def __init__(self, data: bytes):
        self.data = data
        self.low = 0
        self.range = _TOP - 1   # 0xFFFFFFFF, matching the uint32 native coder
        self.code = int.from_bytes(data[:4].ljust(4, b"\x00"), "big")
        self.pos = 4

    def decode_bit(self, p0_q15: int) -> int:
        split = (self.range * p0_q15) >> 15
        split = min(max(split, 1), self.range - 1)
        if self.code < self.low + split:
            bit = 0
            self.range = split
        else:
            bit = 1
            self.low += split
            self.range -= split
        while self.range < _BOT:
            nxt = self.data[self.pos] if self.pos < len(self.data) else 0
            self.low <<= 8
            self.range <<= 8
            self.code = (self.code << 8) | nxt
            self.pos += 1
        return bit

    def decode_bits_raw(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bit(Q15_ONE >> 1)
        return v


# ---------------------------------------------------------------------------
# Laplace-model latent coding
# ---------------------------------------------------------------------------

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
        # geometric: continue-with-prob-r flags; stop implicit at MAX_MAG
        p_stop = Q15_ONE - int(rr)
        for _ in range(mag - 1):
            enc.encode_bit(1, p_stop)
        if mag < MAX_MAG:
            enc.encode_bit(0, p_stop)


def decode_latents(dec: RangeDecoder, p0_q15: np.ndarray, r_q15: np.ndarray
                   ) -> np.ndarray:
    shape = np.asarray(p0_q15).shape
    p0 = clamp_q15(p0_q15).reshape(-1)
    r = clamp_q15(r_q15).reshape(-1)
    out = np.zeros(p0.shape[0], np.int32)
    for i, (p, rr) in enumerate(zip(p0, r)):
        if dec.decode_bit(int(p)) == 0:
            continue
        sign = -1 if dec.decode_bit(Q15_ONE >> 1) else 1
        p_stop = Q15_ONE - int(rr)
        mag = 1
        while mag < MAX_MAG and dec.decode_bit(p_stop) == 1:
            mag += 1
        out[i] = sign * mag
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# PVQ: hard search + enumerative index (decoder initial state)
# ---------------------------------------------------------------------------

def pvq_search(x: np.ndarray, k: int) -> np.ndarray:
    """Nearest signed pulse vector with sum(|y|) == k (greedy cosine search).

    Hard counterpart of soft_pvq (torch/rdovae/rdovae/rdovae.py:40-78):
    initial projection onto the L1 ball then one pulse at a time maximizing
    correlation^2 / energy.
    """
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


def pvq_normalize(y: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(y.astype(np.float64))
    return (y / (n + 1e-15)).astype(np.float32)


def _vcount(n: int, k: int) -> int:
    return pvq_codebook_size(n, k)


def pvq_encode_index(y: Sequence[int], k: int) -> int:
    """Enumerative index of a signed pulse vector (canonical ordering:
    per position, magnitude 0 first then +1,-1,+2,-2,...)."""
    y = list(int(v) for v in y)
    assert sum(abs(v) for v in y) == k
    n = len(y)
    idx = 0
    for j, v in enumerate(y):
        rem = n - j - 1
        if v != 0:
            idx += _vcount(rem, k)                      # the v == 0 block
            for m in range(1, abs(v)):
                idx += 2 * _vcount(rem, k - m)          # +/-m blocks
            if v < 0:
                idx += _vcount(rem, k - abs(v))         # +|v| precedes -|v|
        k -= abs(v)
    return idx


def pvq_decode_index(idx: int, n: int, k: int) -> np.ndarray:
    y = np.zeros(n, np.int64)
    for j in range(n):
        rem = n - j - 1
        block = _vcount(rem, k)
        if idx < block:                                  # v == 0
            continue
        idx -= block
        for m in range(1, k + 1):
            block = _vcount(rem, k - m)
            if idx < block:
                y[j] = m
                break
            idx -= block
            if idx < block:
                y[j] = -m
                break
            idx -= block
        k -= abs(int(y[j]))
        if k == 0:
            break
    return y


def pvq_index_bits(n: int, k: int) -> int:
    total = _vcount(n, k)
    return max(1, int(total - 1).bit_length())


# ---------------------------------------------------------------------------
# Fixed-point statistical tables (the reference's export layout)
# ---------------------------------------------------------------------------

def stats_fixed_point(params, cfg) -> dict:
    """uint16 tables [quant_levels, latent_dim] in the reference's layout
    (torch/rdovae/export_rdovae_weights.py:55-64): quant_scales Q8,
    dead_zone Q10, r Q15, p0 Q15 with p0 = 1 - r^(0.5+0.5*theta). The
    statistical model runs in float32 on its table's device; the rounding
    is numpy float64, as the JAX package's."""
    table = params["statistical_model"]["quant_embedding"]["table"]
    q_ids = torch.arange(cfg.quant_levels, device=table.device)
    with torch.no_grad():
        st = statistical_model(params, q_ids, cfg)
    f64 = lambda name: st[name].cpu().numpy().astype(np.float64)
    r, theta = f64("r_hard"), f64("theta_hard")
    p0 = 1.0 - r ** (0.5 + 0.5 * theta)
    return {
        "quant_scales_q8": np.round(f64("quant_scale") * 256).astype(np.uint16),
        "dead_zone_q10": np.round(f64("dead_zone") * 1024).astype(np.uint16),
        "r_q15": np.clip(np.round(r * Q15_ONE), 1, Q15_ONE - 1).astype(np.uint16),
        "p0_q15": np.clip(np.round(p0 * Q15_ONE), 1, Q15_ONE - 1).astype(np.uint16),
    }


# ---------------------------------------------------------------------------
# Payload framing
# ---------------------------------------------------------------------------
#
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
    sum(|.|) == state_k. Returns the framed payload."""
    zq = np.asarray(zq)
    n_latents = zq.shape[0]
    assert n_latents < (1 << 12) and 0 <= q0 < 16 and 0 <= q1 < 16
    header = bytes([(_VERSION << 4) | q0,
                    (q1 << 4) | (n_latents >> 8),
                    n_latents & 0xFF])
    sbits = pvq_index_bits(len(state_pulses), state_k)
    sidx = pvq_encode_index(state_pulses, state_k)
    sbytes = sidx.to_bytes((sbits + 7) // 8, "big")
    q_ids = payload_q_ids(n_latents, q0, q1)
    p0, r = stats["p0_q15"][q_ids], stats["r_q15"][q_ids]
    enc = RangeEncoder()
    encode_latents(enc, zq, p0, r)
    return header + sbytes + enc.finish()


def decode_payload(payload: bytes, stats: dict, state_dim: int, state_k: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (zq [L, D] oldest-first, state_pulses [S], q_ids [L])."""
    version = payload[0] >> 4
    if version != _VERSION:
        raise ValueError(f"unknown DRED payload version {version}")
    q0 = payload[0] & 0xF
    q1 = payload[1] >> 4
    n_latents = ((payload[1] & 0xF) << 8) | payload[2]
    sbits = pvq_index_bits(state_dim, state_k)
    nsb = (sbits + 7) // 8
    sidx = int.from_bytes(payload[3:3 + nsb], "big")
    state = pvq_decode_index(sidx, state_dim, state_k)
    q_ids = payload_q_ids(n_latents, q0, q1)
    p0, r = stats["p0_q15"][q_ids], stats["r_q15"][q_ids]
    zq = decode_latents(RangeDecoder(payload[3 + nsb:]), p0, r)
    return zq, state, q_ids
