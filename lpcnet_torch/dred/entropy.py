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
computes the symbols and probabilities in batch, the host packs bits.
`encode_payload` codes the latents through the native runtime's range
coder (`runtime.bindings`) where it loads and through the Python coder
here otherwise; both give the same bytes, which are those of the JAX
package's coder. `decode_payload` parses one payload in Python. For a
batch of streams, `pvq_search_batch` runs the PVQ search on the device
and `encode_payloads` frames every stream's payload in one native call
(`encode_payload` a stream without the library), again with the same
bytes; `decode_payloads` parses every stream's payload in one native call
too (`decode_payload` a stream without it), or on CUDA one kernel
(`kernels.dred_parse`), with the same rows.
"""

from __future__ import annotations

import collections.abc
from typing import Optional, Sequence, Tuple

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


def _pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Row sums of a [B, n] float64 tensor in the order of numpy's
    `add.reduce` over a contiguous row (pairwise: eight running sums, a
    tree of them, then the remainder; halves above 128 elements), so
    they equal numpy's bit for bit."""
    n = a.shape[-1]
    if n > 128:
        half = n // 2
        half -= half % 8
        return _pairwise_sum(a[:, :half]) + _pairwise_sum(a[:, half:])
    if n < 8:
        res = a[:, 0]
        for i in range(1, n):
            res = res + a[:, i]
        return res
    r = a[:, :8]
    for i in range(8, n - n % 8, 8):
        r = r + a[:, i:i + 8]
    res = (r[:, 0] + r[:, 1] + (r[:, 2] + r[:, 3])) + (
        r[:, 4] + r[:, 5] + (r[:, 6] + r[:, 7]))
    for i in range(n - n % 8, n):
        res = res + a[:, i]
    return res


@torch.no_grad()
def pvq_search_batch(x: torch.Tensor, k: int) -> torch.Tensor:
    """`pvq_search` of every row of x [B, N] at once, on x's device: pulses
    [B, N] int64, equal to `pvq_search`'s row by row. The same float64
    operations in the same order (numpy's sums replayed by
    `_pairwise_sum`), ties to the lowest index as `np.argmax` takes them.

    The greedy pass runs a fixed number of rounds, each masked to the rows
    with pulses left: the projection leaves fewer than N + 1 + k // 10000
    to place (each floor loses less than one, the 0.9999 factor less than
    k / 10000), and a row of zeros ends as zeros however many run."""
    x = x.to(torch.float64)
    n = x.shape[-1]
    ax = x.abs()
    l1 = _pairwise_sum(ax)[:, None]
    pos = l1 > 0
    y = torch.where(pos, torch.floor(k * ax / torch.where(pos, l1, 1.0)
                                     * 0.9999), 0.0)
    corr = _pairwise_sum(y * ax)
    energy = (y * y).sum(-1)                # integers: exact in any order
    left = k - y.sum(-1)
    cols = torch.arange(n, device=x.device)
    for it in range(min(k, n + 1 + k // 10000)):
        c = corr[:, None] + ax
        v = (c * c) / (energy[:, None] + 2.0 * y + 1.0)
        best = torch.where(v == v.amax(-1, keepdim=True), cols, n).amin(
            -1, keepdim=True)
        live = left > it
        corr = torch.where(live, corr + ax.gather(1, best)[:, 0], corr)
        energy = torch.where(live, energy + (2.0 * y.gather(1, best)[:, 0]
                                             + 1.0), energy)
        y = y + ((cols == best) & live[:, None])
    return (torch.sign(x) * y).to(torch.int64)


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
    from ..runtime.bindings import runtime
    coded = runtime.dred_encode_latents(zq, p0, r)
    if coded is None:                         # no native library: Python path
        enc = RangeEncoder()
        encode_latents(enc, zq, p0, r)
        coded = enc.finish()
    return header + sbytes + coded


class Payloads(collections.abc.Sequence):
    """B framed payloads held in one byte string: payload b is
    `data[starts[b]:starts[b] + lengths[b]]`. Indexing a stream gives its
    bytes; the sequence equals any sequence of the same byte strings."""

    def __init__(self, data: bytes, lengths):
        self.data = data
        self.lengths = np.asarray(lengths, np.int64)
        self.starts = np.cumsum(self.lengths) - self.lengths

    @classmethod
    def of(cls, payloads) -> "Payloads":
        return cls(b"".join(payloads), [len(p) for p in payloads])

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, i: int) -> bytes:
        s = int(self.starts[i])
        return self.data[s:s + int(self.lengths[i])]

    def __eq__(self, other):
        if not isinstance(other, collections.abc.Sequence):
            return NotImplemented
        return list(self) == list(other)

    __hash__ = None


def encode_payloads(zq: np.ndarray, pulses: np.ndarray, q0: int, q1: int,
                    stats: dict, state_k: int,
                    counts: Optional[collections.Counter] = None) -> Payloads:
    """Every stream's framed payload (`encode_payload`'s framing): zq
    [B, L, D] int symbols (oldest latent first), pulses [B, S]. One native
    call frames them all; without the native library, `encode_payload`
    codes a stream at a time. Both give the same bytes. `counts` gets the
    native calls made (`native_calls`) or the payloads coded a stream at a
    time (`python_payloads`)."""
    from ..runtime.bindings import runtime
    q_ids = payload_q_ids(zq.shape[1], q0, q1)
    framed = runtime.dred_frame_payloads(
        zq, pulses, q0, q1, stats["p0_q15"][q_ids], stats["r_q15"][q_ids],
        state_k)
    if framed is not None:
        data, lengths, calls = framed
        if counts is not None:
            counts["native_calls"] += calls
        return Payloads(data, lengths)
    if counts is not None:
        counts["python_payloads"] += len(zq)
    return Payloads.of([encode_payload(z, p, q0, q1, stats, state_k)
                        for z, p in zip(zq, pulses)])


def payload_latent_count(payload: bytes) -> int:
    """The latent count of a payload's header."""
    return ((payload[1] & 0xF) << 8) | payload[2]


def decode_payload(payload: bytes, stats: dict, state_dim: int, state_k: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One payload parsed in Python: (zq [L, D] oldest-first, state_pulses
    [S], q_ids [L]). A batch takes one native call (`decode_payloads`)."""
    sbits = pvq_index_bits(state_dim, state_k)
    nsb = (sbits + 7) // 8
    if len(payload) < 3 + nsb:
        raise ValueError("DRED payload shorter than its header and state index")
    version = payload[0] >> 4
    if version != _VERSION:
        raise ValueError(f"unknown DRED payload version {version}")
    q0 = payload[0] & 0xF
    q1 = payload[1] >> 4
    n_latents = payload_latent_count(payload)
    sidx = int.from_bytes(payload[3:3 + nsb], "big")
    if sidx >= pvq_codebook_size(state_dim, state_k):
        raise ValueError("DRED payload's state index is past the PVQ codebook")
    state = pvq_decode_index(sidx, state_dim, state_k)
    q_ids = payload_q_ids(n_latents, q0, q1)
    p0, r = stats["p0_q15"][q_ids], stats["r_q15"][q_ids]
    zq = decode_latents(RangeDecoder(payload[3 + nsb:]), p0, r)
    return zq, state, q_ids


def split_rows(rows, n_latents: int, latent_dim: int, state_dim: int):
    """Views of `decode_payloads`' rows [B, L * D + S + L] (an array or a
    tensor): (symbols [B, L, D] oldest latent first, pulses [B, S], the
    latents' levels [B, L])."""
    n_sym = n_latents * latent_dim
    return (rows[:, :n_sym].reshape(rows.shape[0], n_latents, latent_dim),
            rows[:, n_sym:n_sym + state_dim], rows[:, n_sym + state_dim:])


def batch_latent_count(payloads: Payloads) -> int:
    """The latent count L of a batch of payloads: its first payload's.
    Raises ValueError on an empty batch, or a first payload without a
    header or of no latent."""
    if len(payloads) == 0 or len(payloads[0]) < 3:
        raise ValueError("decode_payloads: no payload, or a first payload "
                         "without a header")
    n_lat = payload_latent_count(payloads[0])
    if n_lat < 1:
        raise ValueError("decode_payloads: a first payload of no latent")
    return n_lat


def decode_payloads(payloads: Payloads, stats: dict, state_dim: int,
                    state_k: int, counts: Optional[collections.Counter] = None
                    ) -> np.ndarray:
    """Every payload parsed (`decode_payload`'s fields), all of the first
    payload's latent count L (`batch_latent_count`): int16 rows [B, L * D
    + S + L], each a stream's symbols, pulses and latents' levels
    (`split_rows`). One native call parses them all; without the native
    library, `decode_payload` parses a payload at a time. Both give the
    same rows and refuse the same payloads (ValueError); so does the
    card's parse (`kernels.dred_parse`). `counts` gets the native calls
    made (`native_parses`) or the payloads parsed a stream at a time
    (`python_parses`)."""
    from ..runtime.bindings import runtime
    n_lat, dim = batch_latent_count(payloads), stats["p0_q15"].shape[1]
    rows = runtime.dred_parse_payloads(
        payloads.data, payloads.lengths, n_lat, dim, state_dim, state_k,
        stats["p0_q15"], stats["r_q15"])
    if rows is not None:
        if counts is not None:
            counts["native_parses"] += 1
        return rows
    if counts is not None:
        counts["python_parses"] += len(payloads)
    rows = np.empty((len(payloads), n_lat * dim + state_dim + n_lat), np.int16)
    for b, payload in enumerate(payloads):
        zq, pulses, q_ids = decode_payload(payload, stats, state_dim, state_k)
        if zq.shape[0] != n_lat:
            raise ValueError(f"decode_payloads: payload {b} is of another "
                             f"latent count than the batch's first")
        rows[b] = np.concatenate([zq.reshape(-1), pulses, q_ids])
    return rows
