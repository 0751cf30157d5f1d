"""DRED's redundancy payloads parsed on the card (`csrc/dred_parse.cu`):
every stream's payload in one launch, one thread a stream, each row value
for value the native call's (`runtime.bindings.runtime.dred_parse_payloads`,
the parse of `dred/entropy.py::decode_payload`). It replaces no TPU kernel:
the JAX package, like the port's CPU path, parses the payloads on the host.

* `refusal` finds, with numpy over the header and index bytes of every
  payload and no loop over the streams, the first payload the native call
  refuses and why: shorter than its header and index, an unknown version,
  a latent count other than the batch's, a level past the tables, or an
  index past V(S, K). The kernel meets only payloads that passed.
* `prob_table(stats)` is the decoder's probabilities of every level, made
  once: p0 and the stop flag's 32768 - r, clamped as the native call does.
* `Parsing` is a decoder's parse at one shape, and owns all the kernel
  reads and writes: the V(n, k) table (`dred_payload.pvq_table`) and the
  probabilities, uploaded once; a pinned byte stage that holds the
  payloads' int64 starts and then their bytes, and its twin on the card,
  both grown where a batch's bytes pass them; and the rows [B, L * D + S
  + L] int16 on the card, kept while the shape holds and overwritten by
  every launch. A call runs `stage` (the bytes copied in, the checks),
  `upload` (one non-blocking copy) and `launch` (one kernel), all on the
  current stream; nothing is read back.

On the card the parse launches or raises; there is no plain version in
PyTorch: a CPU caller takes the native call, or without the native
library the Python parse of `dred/entropy.py`, which give the same rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime.bindings import PARSE_FAULTS
from .dred_payload import index_bytes, pvq_table

LEVELS = 16     # the levels a header's 4-bit q0 and q1 can name


def refusal(buf: np.ndarray, starts: np.ndarray, n_lat: int, levels: int,
            nsb: int, v_max: np.ndarray) -> Optional[Tuple[int, int]]:
    """The first payload the native parse refuses and its fault (the
    native call's code, -1 to -5, `runtime.bindings.PARSE_FAULTS`), or
    None. `buf` holds the payloads back to back (uint8) and at least 3 +
    nsb bytes after them, `starts` [B + 1] their offsets in it (the last
    the total); n_lat is the batch's latent count, levels the tables'
    rows, v_max the PVQ codebook's size V(S, K) big-endian in nsb bytes."""
    b = len(starts) - 1
    lengths = np.diff(starts)
    head = buf[starts[:b, None] + np.arange(3 + nsb)].astype(np.int64)
    index = head[:, 3:]
    apart = index != v_max
    first = apart.argmax(1)
    codes = np.select(
        [lengths < 3 + nsb,
         head[:, 0] >> 4 != 1,
         ((head[:, 1] & 0xF) << 8 | head[:, 2]) != n_lat,
         np.maximum(head[:, 0] & 0xF, head[:, 1] >> 4) >= levels,
         ~apart.any(1) | (index[np.arange(b), first] > v_max[first])],
        [-1, -2, -3, -4, -5], 0)
    bad = np.flatnonzero(codes)
    return (int(bad[0]), int(codes[bad[0]])) if bad.size else None


def prob_table(stats: dict) -> torch.Tensor:
    """int16 [2, levels, D] of `stats` (`entropy.stats_fixed_point`, at
    most LEVELS rows): p0 clamped to [1, 32767], then the continue flags'
    32768 - r with r clamped likewise (each in [1, 32767])."""
    p0 = np.clip(np.asarray(stats["p0_q15"], np.int64)[:LEVELS], 1, 32767)
    stop = 32768 - np.clip(np.asarray(stats["r_q15"], np.int64)[:LEVELS], 1, 32767)
    return torch.from_numpy(np.stack([p0, stop]).astype(np.int16))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("dred_parse")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lpcnet_dred_parse.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        lib.lpcnet_dred_parse.restype = ci
        _LIB = lib
    return _LIB


class Parsing:
    """The payloads of `batch` streams, n_lat x dim symbols and the
    state_dim pulses of a k-pulse codebook each, parsed on `device` with
    the p0/r tables of `stats` (`entropy.stats_fixed_point`). `rows` is
    the parse, int16 [batch, n_lat * dim + state_dim + n_lat] (symbols
    oldest latent first, pulses, levels: `entropy.split_rows`). `launches`
    (on the class) counts the kernel's launches."""

    launches = 0

    def __init__(self, stats: dict, batch: int, n_lat: int, dim: int,
                 state_dim: int, k: int, device):
        if not 0 < n_lat < 4096:
            raise ValueError("DRED parse kernel: the latent count is out of the "
                             "header's range")
        self.batch, self.n_lat, self.dim = batch, n_lat, dim
        self.state_dim, self.k = state_dim, k
        table = pvq_table(state_dim, k)
        self.nsb = index_bytes(table)
        low, high = (int(w) for w in table[-1, -1].numpy().view(np.uint64))
        self.v_max = np.frombuffer((high << 64 | low).to_bytes(self.nsb, "big"),
                                   np.uint8).astype(np.int64)
        probs = prob_table(stats)
        self.levels = probs.shape[1]
        self.rows = torch.empty((batch, n_lat * (dim + 1) + state_dim),
                                dtype=torch.int16, device=device)
        self.device = self.rows.device      # "cuda" made "cuda:0": what tensors report
        self.vtab = table.to(self.device)
        self.probs = probs.to(self.device)
        self._host: Optional[torch.Tensor] = None    # the stage (pinned on CUDA)
        self._card: Optional[torch.Tensor] = None    # its twin on the card
        self._copied = None     # the event that ends the stage's last copy
        self._staged = 0        # the stage's bytes in use

    def stage(self, payloads) -> None:
        """Copy the payloads (an `entropy.Payloads` of `batch`) and their
        starts into the stage, once its last copy to the card has ended;
        raise ValueError, naming the first payload at fault, on any the
        native parse refuses (`refusal`)."""
        b = self.batch
        if len(payloads) != b:
            raise ValueError(f"DRED parse kernel: {len(payloads)} payloads, "
                             f"expected {b}")
        off, total = 8 * (b + 1), len(payloads.data)
        need = off + total + 3 + self.nsb
        if self._copied is not None:
            self._copied.synchronize()
        if self._host is None or self._host.numel() < need:
            self._host = torch.empty(need + need // 4, dtype=torch.uint8,
                                     pin_memory=self.device.type == "cuda")
        host = self._host.numpy()
        starts = host[:off].view(np.int64)
        starts[0] = 0
        np.cumsum(payloads.lengths, out=starts[1:])
        buf = host[off:]
        buf[:total] = np.frombuffer(payloads.data, np.uint8)
        buf[total:total + 3 + self.nsb] = 0
        fault = refusal(buf, starts, self.n_lat, self.levels, self.nsb, self.v_max)
        if fault is not None:
            raise ValueError(f"DRED parse kernel: payload {fault[0]} is "
                             f"{PARSE_FAULTS[fault[1]]}")
        self._staged = off + total

    def upload(self) -> None:
        """One non-blocking copy of the staged bytes to the card, on the
        current stream; its event is kept for the next `stage`."""
        if self.device.type != "cuda":
            raise ValueError(f"DRED parse kernel: unsupported device {self.device}")
        if self._card is None or self._card.numel() < self._host.numel():
            self._card = torch.empty(self._host.numel(), dtype=torch.uint8,
                                     device=self.device)
        n = self._staged
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device):
            self._card[:n].copy_(self._host[:n], non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(stream)

    def launch(self) -> None:
        """Parse the uploaded payloads into `rows`, one launch on the
        current stream of the parse's card. Nothing waits for the card."""
        if self._card is None:
            raise ValueError("DRED parse kernel: nothing uploaded")
        with torch.cuda.device(self.device):
            err = _lib().lpcnet_dred_parse(
                self._card.data_ptr(), self.vtab.data_ptr(), self.probs.data_ptr(),
                self.rows.data_ptr(), self.batch, self.n_lat, self.dim,
                self.state_dim, self.k, self.nsb, self.levels,
                torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"DRED parse kernel launch failed: CUDA error {err}")
        Parsing.launches += 1

    def __call__(self, payloads) -> torch.Tensor:
        """`stage`, `upload`, `launch`: the payloads' rows on the card."""
        self.stage(payloads)
        self.upload()
        self.launch()
        return self.rows
