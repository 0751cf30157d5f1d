"""DRED's redundancy payloads framed on the card (`csrc/dred_payload.cu`):
every stream's payload in one launch, one thread a stream, byte for byte
the native call's (`runtime.bindings.runtime.dred_frame_payloads`, the
framing of `dred/entropy.py::encode_payload`). It replaces no TPU kernel:
the JAX package, like the port's CPU path, frames the payloads on the
host.

* `pvq_table(state_dim, k)` and `prob_rows(stats, q_ids)` build, on the
  host, the tables the kernel reads: V(n, k) for n <= state_dim and
  k' <= k as the two 64-bit words of an unsigned 128-bit integer, and the
  p0 and r Q15 rows of a payload's levels.
* `Framing` is an encoder's framing at one shape, and owns all the kernel
  reads and writes on the card: the V(n, k) table and the p0/r rows of
  each (q0, q1), made once and kept; a byte buffer (`stage`) that holds
  the int16 symbols and pulses (`sym`), the kernel's lengths and the
  float32 bit estimates (`bits`), so that one copy (`fetch`) brings all
  three to the host; the slots of `stride` bytes and the packed bytes. A
  call runs `stage`, `launch`, `fetch`, then `payloads`, which takes the
  fetched lengths, relaunches at four times the stride while a stream
  passed its slot, and copies the packed bytes over.

On the card the framing launches or raises; there is no plain version in
PyTorch: a CPU caller takes the native call, or without the native
library the Python coder of `dred/entropy.py`, which give the same bytes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_WORD = (1 << 64) - 1


def pvq_table(state_dim: int, k: int) -> torch.Tensor:
    """V(n, k') for n <= state_dim, k' <= k (`models.rdovae.
    pvq_codebook_size`) by the recurrence the native call runs, as int64
    [state_dim + 1, k + 1, 2]: the low word, then the high word of the
    unsigned 128-bit count. Raises where a count reaches 2^127."""
    v = [[1] + [0] * k]
    for n in range(1, state_dim + 1):
        row = [1]
        for j in range(1, k + 1):
            row.append(v[n - 1][j] + row[j - 1] + v[n - 1][j - 1])
        v.append(row)
    if v[state_dim][k] >= 1 << 127:
        raise ValueError(f"DRED payload kernel: the PVQ codebook V({state_dim}, "
                         f"{k}) needs more than 127 bits")
    words = np.array([[(x & _WORD, x >> 64) for x in row] for row in v], np.uint64)
    return torch.from_numpy(words.view(np.int64))


def index_bytes(table: torch.Tensor) -> int:
    """The bytes of the PVQ index over a `pvq_table`'s last entry V(n, k):
    the bits of V - 1 (at least one), rounded up to bytes."""
    low, high = (int(w) for w in table[-1, -1].numpy().view(np.uint64))
    return (max(1, ((high << 64 | low) - 1).bit_length()) + 7) // 8


def prob_rows(stats: dict, q_ids) -> torch.Tensor:
    """The p0 and r Q15 rows of a payload whose latents take the levels
    q_ids: int32 [2, L * D], `stats["p0_q15"][q_ids]` then
    `stats["r_q15"][q_ids]`, flattened as they are (the kernel clamps to
    [1, 32767] as the native call does)."""
    q_ids = np.asarray(q_ids)
    return torch.from_numpy(np.stack([
        np.asarray(stats["p0_q15"])[q_ids].reshape(-1),
        np.asarray(stats["r_q15"])[q_ids].reshape(-1)]).astype(np.int32))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("dred_payload")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lpcnet_dred_frame.argtypes = ([vp] * 6 + [ci] * 8
                                          + [ctypes.c_longlong, vp])
        lib.lpcnet_dred_frame.restype = ci
        _LIB = lib
    return _LIB


def _check(name, t, shape, kind, device):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name} must be a tensor on {device}")
    if t.dtype == torch.bool or t.is_complex() or (kind == "int" and t.is_floating_point()) \
            or (kind == "float" and not t.is_floating_point()):
        raise TypeError(f"{name} has dtype {t.dtype}, expected a {kind} dtype")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


class Framing:
    """The payloads of `batch` streams, n_lat x dim symbols and the
    state_dim pulses of a k-pulse codebook each, framed on `device` with the
    p0/r tables of `stats` (`entropy.stats_fixed_point`). `launches` (on
    the class) counts the kernel's launches; `retries` the relaunches at a
    larger stride since the last `stage`. The stride a relaunch reached is
    kept for the calls after it."""

    launches = 0

    def __init__(self, stats: dict, batch: int, n_lat: int, dim: int,
                 state_dim: int, k: int, device):
        self.stats, self.batch, self.n_lat, self.dim = stats, batch, n_lat, dim
        self.n_sym = n_lat * dim
        self.state_dim, self.k = state_dim, k
        table = pvq_table(state_dim, k)
        self.nsb = index_bytes(table)
        row = self.n_sym + state_dim
        self._sym_bytes = -(-2 * batch * row // 4) * 4
        self.stage_buf = torch.empty(self._sym_bytes + 8 * batch, dtype=torch.uint8,
                                     device=device)
        self.device = self.stage_buf.device     # "cuda" made "cuda:0": what tensors report
        self.vtab = table.to(self.device)
        self._rows = {}                         # (q0, q1) -> p0/r rows, on the device
        self.sym = self.stage_buf[:2 * batch * row].view(torch.int16).view(batch, row)
        self.lengths = self.stage_buf[self._sym_bytes:self._sym_bytes + 4 * batch].view(
            torch.int32)
        self.bits = self.stage_buf[self._sym_bytes + 4 * batch:].view(torch.float32)
        self.stride = 64 + 2 * self.n_sym      # the native binding's first room a stream
        self.slots = self.packed = None
        self.retries = 0

    def stage(self, zq: torch.Tensor, pulses: torch.Tensor, bits: torch.Tensor):
        """Copy zq [batch, n_lat, dim] (whole numbers, |zq| <= MAX_MAG), the
        pulses [batch, state_dim] (an integer dtype) and the bit estimates
        [batch] (a float dtype), all on the framing's device, into the
        stage."""
        b = self.batch
        _check("zq", zq, (b, self.n_lat, self.dim), "real", self.device)
        _check("pulses", pulses, (b, self.state_dim), "int", self.device)
        _check("bits", bits, (b,), "float", self.device)
        self.sym[:, :self.n_sym].copy_(zq.reshape(b, -1))
        self.sym[:, self.n_sym:].copy_(pulses)
        self.bits.copy_(bits)
        self.retries = 0

    def launch(self, q0: int, q1: int, q_ids):
        """Frame every staged stream into its slot and pack the slots, on
        the current stream of the framing's card, the latents at the levels
        q_ids [n_lat] (their p0/r rows made once for each (q0, q1)). Nothing
        waits for the card."""
        if not (0 <= q0 < 16 and 0 <= q1 < 16 and 0 < self.n_lat < 4096):
            raise ValueError("DRED payload kernel: q0, q1 or the latent count "
                             "out of the header's range")
        if len(q_ids) != self.n_lat:
            raise ValueError(f"q_ids has {len(q_ids)} levels, expected {self.n_lat}")
        if self.device.type != "cuda":
            raise ValueError(f"DRED payload kernel: unsupported device {self.device}")
        if (q0, q1) not in self._rows:
            self._rows[q0, q1] = prob_rows(self.stats, q_ids).to(self.device)
        size = self.batch * self.stride
        if self.slots is None or self.slots.numel() != size:
            self.slots = torch.empty(size, dtype=torch.uint8, device=self.device)
            self.packed = torch.empty(size, dtype=torch.uint8, device=self.device)
        with torch.cuda.device(self.device):
            err = _lib().lpcnet_dred_frame(
                self.sym.data_ptr(), self._rows[q0, q1].data_ptr(), self.vtab.data_ptr(),
                self.slots.data_ptr(), self.lengths.data_ptr(), self.packed.data_ptr(),
                self.batch, self.n_lat, self.dim, self.state_dim, self.k, self.nsb,
                q0, q1, self.stride, torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"DRED payload kernel launch failed: CUDA error {err}")
        Framing.launches += 1
        self._args = (q0, q1, q_ids)

    def fetch(self):
        """One copy of the stage to the host: (sym [batch, row] int16,
        lengths [batch] int32, bits [batch] float32), views of one array."""
        host = self.stage_buf.cpu().numpy()
        s = self._sym_bytes
        return (host[:self.sym.numel() * 2].view(np.int16).reshape(self.sym.shape),
                host[s:s + 4 * self.batch].view(np.int32),
                host[s + 4 * self.batch:].view(np.float32))

    def payloads(self, lengths: np.ndarray):
        """The fetched lengths -> (the payloads back to back as bytes,
        lengths [batch] int64). Raises where a stream's pulses do not sum to
        k; relaunches at four times the stride while a stream passed its
        slot, then copies the packed bytes over."""
        if (lengths == -2).any():
            raise ValueError("DRED payload kernel: a stream's pulses do not sum "
                             "to k")
        while lengths.max() > self.stride:
            self.stride *= 4
            self.retries += 1
            self.launch(*self._args)
            lengths = self.lengths.cpu().numpy()
        total = int(lengths.sum(dtype=np.int64))
        return self.packed[:total].cpu().numpy().tobytes(), lengths.astype(np.int64)
