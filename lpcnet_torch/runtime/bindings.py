"""ctypes bindings for the native host runtime (`native/lpcnet_runtime.cc`).

The library is compiled with g++ at first use into `runtime/build/` (not
committed; the file name carries a hash of the source and the flags, so an
edited source is rebuilt) and loaded with ctypes. Every entry point has a
NumPy fallback that follows the C arithmetic step by step, so the package
works without a compiler; the fallbacks are slow Python loops. The DRED
range coder's fallback is the Python coder of `dred/entropy.py` (the entry
points return None and the caller takes it), the batched parse's is
`entropy.decode_payload` a payload at a time.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "lpcnet_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblpcnet_runtime-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True)
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    out = library_path()
    try:
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError):
        _failed = True
        return None
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    ptr = ctypes.POINTER
    lib.lin2ulaw_batch.argtypes = [ptr(ctypes.c_float), ptr(ctypes.c_int32), i64]
    lib.ulaw2lin_batch.argtypes = [ptr(ctypes.c_int32), ptr(ctypes.c_float), i64]
    lib.pack_packets.argtypes = [ptr(ctypes.c_int32), ptr(ctypes.c_uint8), i64]
    lib.unpack_packets.argtypes = [ptr(ctypes.c_uint8), ptr(ctypes.c_int32), i64]
    lib.biquad.argtypes = [ptr(ctypes.c_float)] * 5 + [i64]
    lib.write_audio_frames.argtypes = [
        ptr(ctypes.c_float), ptr(ctypes.c_float), ptr(ctypes.c_int32),
        ptr(ctypes.c_float), ptr(ctypes.c_int32), ptr(ctypes.c_int16), i64]
    lib.compute_noise_frames.argtypes = [ptr(ctypes.c_int32),
                                         ptr(ctypes.c_float), i64, u64]
    lib.gather_frames.argtypes = [ptr(ctypes.c_float), ptr(ctypes.c_int64),
                                  ptr(ctypes.c_int32), ptr(ctypes.c_float),
                                  i64, i64]
    lib.scatter_frames.argtypes = [ptr(ctypes.c_float), ptr(ctypes.c_int32),
                                   ptr(ctypes.c_int16), ptr(ctypes.c_int64),
                                   i64, i64]
    lib.dred_encode_latents.argtypes = [
        ptr(ctypes.c_int32), ptr(ctypes.c_uint16), ptr(ctypes.c_uint16), i64,
        ptr(ctypes.c_uint8), i64]
    lib.dred_encode_latents.restype = i64
    lib.dred_frame_payloads.argtypes = [
        ptr(ctypes.c_int16), ptr(ctypes.c_int16), i64, i64, i64, i64, i64,
        ptr(ctypes.c_uint16), ptr(ctypes.c_uint16), i64, i64,
        ptr(ctypes.c_uint8), i64, ptr(i64)]
    lib.dred_frame_payloads.restype = i64
    lib.dred_parse_payloads.argtypes = [
        ptr(ctypes.c_uint8), ptr(i64), i64, i64, i64, i64, i64,
        ptr(ctypes.c_uint16), ptr(ctypes.c_uint16), i64, ptr(ctypes.c_int16),
        ptr(i64)]
    lib.dred_parse_payloads.restype = i64
    _lib = lib
    return lib


# what `dred_parse_payloads` says of the payload it refuses, by its code
PARSE_FAULTS = {-1: "shorter than its header and state index",
                -2: "of an unknown version",
                -3: "of another latent count than the batch's first",
                -4: "at a level past the statistical tables",
                -5: "with a state index past the PVQ codebook"}


def native_available() -> bool:
    return _load() is not None


def _cp(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _state(arr: np.ndarray, dtype, n: int, name: str) -> None:
    """A state buffer the library updates in place must be a C-contiguous
    array of `dtype` with at least `n` elements."""
    if (not isinstance(arr, np.ndarray) or arr.dtype != dtype
            or not arr.flags.c_contiguous or arr.size < n):
        raise ValueError(f"{name}: need a contiguous {np.dtype(dtype).name} "
                         f"array of {n} elements")


# --------------------------------------------------------------------------
# The C arithmetic in float32, for the fallbacks
# --------------------------------------------------------------------------

_f32 = np.float32
_LOG256 = _f32(5.5451774445)


def _log2_approx(x: np.float32) -> np.float32:
    """log2_approx of the C source (src/common.h:18-33): bit fields and a
    cubic, in float32."""
    i = int(np.array(x, np.float32).view(np.int32))
    integer = (i >> 23) - 127
    frac = np.array(i - (integer << 23), np.int32).view(np.float32)[()] - _f32(1.5)
    frac = _f32(-0.41445418) + frac * (_f32(0.95909232) + frac * (
        _f32(-0.33951290) + frac * _f32(0.16541097)))
    return (_f32(1.0) + _f32(integer)) + frac


def _lin2ulaw(x: np.float32) -> int:
    s = 1 if x >= 0 else -1
    x = _f32(abs(x))
    u = _f32(s) * (_f32(128.0 * 0.69315) * _log2_approx(
        _f32(1.0) + _f32(255.0 / 32768.0) * x) / _LOG256)
    u = min(_f32(255.0), max(_f32(0.0), _f32(128.0) + u))
    return int(math.floor(_f32(0.5) + u))


def _ulaw2lin(u: np.float32) -> np.float32:
    u = _f32(u) - _f32(128.0)
    s = _f32(1.0) if u >= 0 else _f32(-1.0)
    e = _f32(math.exp(float(_f32(abs(u)) / _f32(128.0) * _LOG256)))
    return s * _f32(32768.0 / 255.0) * (e - _f32(1.0))


def _float2short(x) -> int:
    return max(-32767, min(32767, int(math.floor(0.5 + float(x)))))


def _kiss99_seed(data: bytes):
    z, w, jsr, jcong = 362436069, 521288629, 123456789, 380116160
    m = 0xFFFFFFFF
    n, i = len(data), 3
    while i < n:
        z ^= data[i - 3]
        w ^= data[i - 2]
        jsr ^= data[i - 1]
        jcong ^= data[i]
        z = 36969 * (z & 0xFFFF) + (z >> 16)
        w = 18000 * (w & 0xFFFF) + (w >> 16)
        jsr ^= (jsr << 13) & m
        jsr ^= jsr >> 17
        jsr ^= (jsr << 5) & m
        jcong = (69069 * jcong + 1234567) & m
        i += 4
    if i - 3 < n:
        z ^= data[i - 3]
    if i - 2 < n:
        w ^= data[i - 2]
    if i - 1 < n:
        jsr ^= data[i - 1]
    if z in (0, 0x9068FFFF):
        z += 1
    if w in (0, 0x464FFFFF):
        w += 1
    if jsr == 0:
        jsr += 1
    return [z & m, w & m, jsr & m, jcong & m]


def _kiss99_next(st) -> int:
    m = 0xFFFFFFFF
    z, w, jsr, jcong = st
    znew = (36969 * (z & 0xFFFF) + (z >> 16)) & m
    wnew = (18000 * (w & 0xFFFF) + (w >> 16)) & m
    mwc = ((znew << 16) + wnew) & m
    shr3 = jsr ^ ((jsr << 13) & m)
    shr3 ^= shr3 >> 17
    shr3 ^= (shr3 << 5) & m
    cong = (69069 * jcong + 1234567) & m
    st[:] = [znew, wnew, shr3, cong]
    return ((mwc ^ cong) + shr3) & m


class _Runtime:
    """Facade: the native library when it loads, the NumPy fallbacks
    otherwise (or always, with `native=False`)."""

    def __init__(self, native: bool = True):
        self._native = native

    def _lib(self) -> Optional[ctypes.CDLL]:
        return _load() if self._native else None

    def biquad(self, x: np.ndarray, b, a, mem: np.ndarray) -> np.ndarray:
        """Time-invariant biquad with its state `mem` [2] carried in place."""
        x = np.ascontiguousarray(x, np.float32).reshape(-1)
        b = np.ascontiguousarray(b, np.float32)
        a = np.ascontiguousarray(a, np.float32)
        _state(mem, np.float32, 2, "biquad mem")
        if b.size < 2 or a.size < 2:
            raise ValueError("biquad: b and a need 2 coefficients each")
        y = np.empty_like(x)
        lib = self._lib()
        if lib is not None:
            lib.biquad(_cp(y, ctypes.c_float), _cp(mem, ctypes.c_float),
                       _cp(x, ctypes.c_float), _cp(b, ctypes.c_float),
                       _cp(a, ctypes.c_float), len(x))
            return y
        b0, b1, a0, a1 = (float(v) for v in (b[0], b[1], a[0], a[1]))
        for i in range(len(x)):
            xi = float(x[i])
            yi = float(_f32(xi + float(mem[0])))
            mem[0] = float(mem[1]) + (b0 * xi - a0 * yi)
            mem[1] = b1 * xi - a1 * yi
            y[i] = yi
        return y

    def write_audio_frames(self, pcm: np.ndarray, lpc: np.ndarray,
                           noise: np.ndarray, sig_mem: np.ndarray,
                           exc_mem: np.ndarray) -> np.ndarray:
        """The noisy-excitation teacher loop: interleaved int16
        (sig_in, sig_out) pairs; `sig_mem` [16] and `exc_mem` [1] carried
        in place."""
        n_frames = len(pcm) // 160
        pcm = np.ascontiguousarray(pcm, np.float32)
        lpc = np.ascontiguousarray(lpc, np.float32).reshape(-1)
        noise = np.ascontiguousarray(noise, np.int32)
        _state(sig_mem, np.float32, 16, "write_audio_frames sig_mem")
        _state(exc_mem, np.int32, 1, "write_audio_frames exc_mem")
        if lpc.size < n_frames * 16 or noise.size < n_frames * 160:
            raise ValueError("write_audio_frames: lpc needs 16 values and "
                             "noise 160 a frame")
        out = np.empty(n_frames * 160 * 2, np.int16)
        lib = self._lib()
        if lib is not None:
            lib.write_audio_frames(
                _cp(pcm, ctypes.c_float), _cp(lpc, ctypes.c_float),
                _cp(noise, ctypes.c_int32), _cp(sig_mem, ctypes.c_float),
                _cp(exc_mem, ctypes.c_int32), _cp(out, ctypes.c_int16),
                n_frames)
            return out
        for k in range(n_frames):
            lk = lpc[k * 16:(k + 1) * 16]
            for i in range(160):
                n = k * 160 + i
                p = _f32(0.0)
                for j in range(16):
                    p = p - lk[j] * sig_mem[j]
                target = pcm[n]
                e = _lin2ulaw(target - p)
                out[2 * n] = _float2short(sig_mem[0])
                out[2 * n + 1] = _float2short(target)
                e = min(255, max(0, e + int(noise[n])))
                sig_mem[1:] = sig_mem[:-1].copy()
                sig_mem[0] = p + _ulaw2lin(_f32(e))
                exc_mem[0] = e
        return out

    def compute_noise_frames(self, noise_std: np.ndarray, seed: int
                             ) -> np.ndarray:
        """Laplace-like u-law-domain noise, 160 samples a frame, from a
        KISS99 stream seeded with the 8 bytes of `seed`."""
        n_frames = len(noise_std)
        noise_std = np.ascontiguousarray(noise_std, np.float32)
        out = np.empty(n_frames * 160, np.int32)
        lib = self._lib()
        if lib is not None:
            lib.compute_noise_frames(_cp(out, ctypes.c_int32),
                                     _cp(noise_std, ctypes.c_float),
                                     n_frames, seed)
            return out
        st = _kiss99_seed(int(seed).to_bytes(8, "little"))
        inv = _f32(1.0 / 4294967296.0)

        def draw():
            return (_f32(_kiss99_next(st)) + _f32(0.5)) * inv

        for k in range(n_frames):
            g = noise_std[k] * _f32(0.707)
            for i in range(160):
                u1, u2 = draw(), draw()
                d = (_f32(math.log(float(u1))) - _f32(math.log(float(u2))))
                out[k * 160 + i] = math.floor(0.5 + float(g * d))
        return out

    def pack_packets(self, fields: np.ndarray) -> np.ndarray:
        """fields [N, 9] int32 (wire order) -> [N, 8] uint8."""
        fields = np.ascontiguousarray(fields, np.int32)
        n = fields.shape[0]
        out = np.empty((n, 8), np.uint8)
        lib = self._lib()
        if lib is not None:
            lib.pack_packets(_cp(fields, ctypes.c_int32),
                             _cp(out, ctypes.c_uint8), n)
            return out
        from ..codec import packet as P
        names = [f[0] for f in P.FIELDS]
        return P.pack_fields({nm: fields[:, i] for i, nm in enumerate(names)})

    def unpack_packets(self, packets: np.ndarray) -> np.ndarray:
        """[N, 8] uint8 -> fields [N, 9] int32 (wire order)."""
        packets = np.ascontiguousarray(packets, np.uint8).reshape(-1, 8)
        n = packets.shape[0]
        out = np.empty((n, 9), np.int32)
        lib = self._lib()
        if lib is not None:
            lib.unpack_packets(_cp(packets, ctypes.c_uint8),
                               _cp(out, ctypes.c_int32), n)
            return out
        from ..codec import packet as P
        d = P.unpack_fields(packets)
        return np.stack([d[f[0]] for f in P.FIELDS], axis=1).astype(np.int32)

    def dred_encode_latents(self, zq: np.ndarray, p0_q15: np.ndarray,
                            r_q15: np.ndarray) -> Optional[bytes]:
        """Range-code one payload's latent symbols; None -> the caller takes
        the Python coder."""
        lib = self._lib()
        if lib is None:
            return None
        zq = np.ascontiguousarray(zq, np.int32).reshape(-1)
        p0 = np.ascontiguousarray(p0_q15, np.uint16).reshape(-1)
        r = np.ascontiguousarray(r_q15, np.uint16).reshape(-1)
        cap = 64 + 490 * zq.size       # worst case ~15 bits/flag, 257 flags
        out = np.empty(cap, np.uint8)
        n = lib.dred_encode_latents(_cp(zq, ctypes.c_int32),
                                    _cp(p0, ctypes.c_uint16),
                                    _cp(r, ctypes.c_uint16), zq.size,
                                    _cp(out, ctypes.c_uint8), cap)
        if n < 0:
            return None
        return out[:n].tobytes()

    def dred_frame_payloads(self, zq: np.ndarray, pulses: np.ndarray,
                            q0: int, q1: int, p0_q15: np.ndarray,
                            r_q15: np.ndarray, state_k: int):
        """Frame B DRED payloads in one call (`dred/entropy.py::
        encode_payload`'s framing): zq [B, L, D] symbols, pulses [B, S],
        p0/r [L, D] Q15. Returns (the payloads back to back as bytes,
        lengths [B], native calls made: a second only where the first
        buffer was too small), or None -> the caller codes a stream at a
        time."""
        lib = self._lib()
        if lib is None:
            return None
        zq = np.ascontiguousarray(zq, np.int16)
        pulses = np.ascontiguousarray(pulses, np.int16)
        b, n_lat, dim = zq.shape
        p0 = np.ascontiguousarray(p0_q15, np.uint16).reshape(-1)
        r = np.ascontiguousarray(r_q15, np.uint16).reshape(-1)
        if (p0.size != n_lat * dim or r.size != n_lat * dim
                or pulses.ndim != 2 or pulses.shape[0] != b):
            raise ValueError("dred_frame_payloads: zq [B, L, D], pulses "
                             "[B, S] and p0, r [L, D] disagree")
        lengths = np.empty(b, np.int64)
        room, calls = b * (64 + 2 * n_lat * dim), 0
        while True:
            out = np.empty(room, np.uint8)
            n = lib.dred_frame_payloads(
                _cp(zq, ctypes.c_int16), _cp(pulses, ctypes.c_int16), b,
                n_lat, dim, pulses.shape[1], state_k, _cp(p0, ctypes.c_uint16),
                _cp(r, ctypes.c_uint16), q0, q1, _cp(out, ctypes.c_uint8),
                room, _cp(lengths, ctypes.c_int64))
            calls += 1
            if n != -1:
                break
            room *= 4
        if n == -2:
            raise ValueError(f"dred_frame_payloads: a stream's pulses do not "
                             f"sum to {state_k}")
        if n < 0:
            raise ValueError("dred_frame_payloads: q0, q1 or the latent "
                             "count out of the header's range")
        return out[:n].tobytes(), lengths, calls

    def dred_parse_payloads(self, data: bytes, lengths: np.ndarray,
                            n_latents: int, latent_dim: int, state_dim: int,
                            state_k: int, p0_q15: np.ndarray,
                            r_q15: np.ndarray) -> Optional[np.ndarray]:
        """Parse B DRED payloads in one call (the inverse of
        `dred_frame_payloads`): `data` the payloads back to back, lengths
        [B], p0/r [levels, D] Q15 tables of every level. Returns the int16
        rows [B, L * D + S + L]: each stream's symbols
        (oldest latent first), pulses and its latents' levels. None -> the
        caller parses a payload at a time. Raises ValueError on a payload
        the parse refuses."""
        lib = self._lib()
        if lib is None:
            return None
        lengths = np.ascontiguousarray(lengths, np.int64)
        b = lengths.shape[0]
        p0 = np.ascontiguousarray(p0_q15, np.uint16)
        r = np.ascontiguousarray(r_q15, np.uint16)
        if (p0.ndim != 2 or p0.shape != r.shape or p0.shape[1] != latent_dim
                or int(lengths.sum()) != len(data) or (lengths < 0).any()):
            raise ValueError("dred_parse_payloads: lengths, data and the "
                             "[levels, D] tables disagree")
        out = np.empty((b, n_latents * latent_dim + state_dim + n_latents), np.int16)
        buf = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)
        bad = np.zeros(1, np.int64)
        rc = lib.dred_parse_payloads(
            _cp(buf, ctypes.c_uint8), _cp(lengths, ctypes.c_int64), b,
            n_latents, latent_dim, state_dim, state_k, _cp(p0, ctypes.c_uint16),
            _cp(r, ctypes.c_uint16), p0.shape[0], _cp(out, ctypes.c_int16),
            _cp(bad, ctypes.c_int64))
        if rc == -6:
            raise ValueError("dred_parse_payloads: the PVQ codebook needs "
                             "more than 127 bits")
        if rc != 0:
            raise ValueError(f"dred_parse_payloads: payload {int(bad[0])} is "
                             f"{PARSE_FAULTS[int(rc)]}")
        return out


runtime = _Runtime()
