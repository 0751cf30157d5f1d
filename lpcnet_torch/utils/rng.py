"""Random numbers: KISS99, vectorized over streams and bit-exact with the C
decoder, and the training draws of `torch.Generator`s.

The reference drives excitation sampling with KISS99 seeded from the string
"LPCNet" (src/kiss99.c:32-81). PyTorch's CPU backend lacks `<<`, `>>` and
`+` on uint32, so each state word is an int64 tensor holding a value in
[0, 2**32) and every step masks with 0xFFFFFFFF. The CUDA kernel carries the
same words as uint32 registers.

The trainers draw their noise through `draw`, which under a data-parallel
mesh (`ShardDraws`) makes each draw at the global batch's shape and keeps
this rank's slice, and seed a block's steps with `fold_seed`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


class ShardDraws(NamedTuple):
    """A generator shared by the ranks of a data-parallel step. Every draw
    through `draw` is made at the global batch's shape (this rank's shape
    with the batch axis times `world`) and sliced to this rank's share, so
    every rank's generator advances alike and world size N sees the draws
    of world size 1."""
    generator: torch.Generator
    rank: int
    world: int

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(state)


def draw(fn, shape, rng, axis: int = 0, **kw) -> torch.Tensor:
    """`fn(shape, generator=, device=, **kw)` on the generator's device:
    `torch.rand`, `torch.randn` or a partial of `torch.randint`. `rng` is a
    `torch.Generator` or a `ShardDraws`; under the latter the draw is made
    at the global shape and this rank's slice of `axis` comes back."""
    shape = tuple(shape)
    if not isinstance(rng, ShardDraws):
        return fn(shape, generator=rng, device=rng.device, **kw)
    g, rank, world = rng
    n = shape[axis]
    full = shape[:axis] + (n * world,) + shape[axis + 1:]
    return fn(full, generator=g, device=g.device, **kw).narrow(
        axis, rank * n, n)


def fold_seed(base: int, step: int) -> int:
    """A generator seed from (base, step), the counterpart of
    `jax.random.fold_in(key, step)`: splitmix64's finaliser of the two
    words, so neighbouring steps get unrelated streams."""
    z = (base * 0x9E3779B97F4A7C15 + step + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class Kiss99State(NamedTuple):
    z: torch.Tensor
    w: torch.Tensor
    jsr: torch.Tensor
    jcong: torch.Tensor


def kiss99_step(state: Kiss99State):
    """One draw; returns (value int64 in [0, 2**32), new_state)."""
    z, w, jsr, jcong = state
    znew = (36969 * (z & 0xFFFF) + (z >> 16)) & _M32
    wnew = (18000 * (w & 0xFFFF) + (w >> 16)) & _M32
    mwc = ((znew << 16) + wnew) & _M32
    shr3 = jsr ^ ((jsr << 13) & _M32)
    shr3 = shr3 ^ (shr3 >> 17)
    shr3 = shr3 ^ ((shr3 << 5) & _M32)
    cong = (69069 * jcong + 1234567) & _M32
    out = ((mwc ^ cong) + shr3) & _M32
    return out, Kiss99State(znew, wnew, shr3, cong)


def _srand_words(data: bytes):
    """The C kiss99_srand (src/kiss99.c:32-57) on Python ints."""
    z, w, jsr, jcong = 362436069, 521288629, 123456789, 380116160

    def rand(z, w, jsr, jcong):
        z = (36969 * (z & 0xFFFF) + (z >> 16)) & _M32
        w = (18000 * (w & 0xFFFF) + (w >> 16)) & _M32
        jsr ^= (jsr << 13) & _M32
        jsr ^= jsr >> 17
        jsr ^= (jsr << 5) & _M32
        jcong = (69069 * jcong + 1234567) & _M32
        return z, w, jsr, jcong

    i = 3
    while i < len(data):
        z ^= data[i - 3]
        w ^= data[i - 2]
        jsr ^= data[i - 1]
        jcong ^= data[i]
        z, w, jsr, jcong = rand(z, w, jsr, jcong)
        i += 4
    if i - 3 < len(data):
        z ^= data[i - 3]
    if i - 2 < len(data):
        w ^= data[i - 2]
    if i - 1 < len(data):
        jsr ^= data[i - 1]
    if z in (0, 0x9068FFFF):
        z += 1
    if w in (0, 0x464FFFFF):
        w += 1
    if jsr == 0:
        jsr += 1
    return z, w, jsr, jcong


def kiss99_srand(data: bytes = b"LPCNet", n_streams: int | None = None,
                 device="cpu") -> Kiss99State:
    """Seed exactly like the C kiss99_srand.

    With n_streams, stream k is perturbed by k (z ^= k*2654435761,
    jsr ^= k*40503, in uint32), so stream 0 keeps the C decoder's sequence.
    """
    z, w, jsr, jcong = _srand_words(data)
    if n_streams is None:
        mk = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        return Kiss99State(mk(z), mk(w), mk(jsr), mk(jcong))
    ks = np.arange(n_streams, dtype=np.uint32)
    cols = (np.uint32(z) ^ (ks * np.uint32(2654435761)),
            np.full(n_streams, w, np.uint32),
            np.uint32(jsr) ^ (ks * np.uint32(40503)),
            np.full(n_streams, jcong, np.uint32))
    return Kiss99State(*(torch.from_numpy(c.astype(np.int64)).to(device)
                         for c in cols))
