"""The training recurrence of the reset-after GRU (K5), forward and backward,
as hand-written CUDA kernels (`csrc/gru_train.cu`) under a
`torch.autograd.Function`.

Port of `lpcnet_tpu/kernels/gru_train.py` (`_fwd_kernel`, `_bwd_kernel`,
the custom VJP `gru_recurrence`, `gru_seq_pallas`). Per step

    zrec  = bf16(h) . bf16(Wr) + br              (f32 sums; br = bias[1])
    z, r  = sigmoid(g_z + zrec_z), sigmoid(g_r + zrec_r)
    hcand = tanh(g_h + r * zrec_h)
    h'    = z*h + (1-z)*hcand

over precomputed gate inputs g = gate_in[:, t]. The input product
`gate_in = bf16(x) . bf16(kernel) + bias[0]` is one large matrix product
outside the kernel (`torch.matmul`, differentiated by autograd), as the JAX
package leaves it to XLA.

* `gru_recurrence_plain` is the kernel's plain PyTorch version: the same
  casts, step by step, differentiated by autograd. The CPU runs it and the
  chip check holds the kernel against it.
* The backward runs in three phases, each with a plain version used by the
  tests and the chip check: `gate_pass_plain` (the gates and the factors
  that turn d = dh + dhs into the step's gradients, for all rows at once:
  they depend on the forward's hs alone), `chain_plain` (the dependent
  reverse-time chain dh_{t-1} = d z + bf16(dzrec) . bf16(Wr^T)) and
  `dwr_plain`; `rec_backward_plain` composes them (the counterpart of the
  JAX package's `_rec_backward`). `bwd_launch_config` shapes the chain's
  clusters and `pack_bwd_weights` packs each rank's rows of Wr.
* `gru_recurrence` dispatches on the device of `gate_in`: CPU -> plain, CUDA
  -> `GruRecurrence` (the kernels; a build or launch failure raises), any
  other device raises.
* `gru_seq_kernel(params, x, h0=None)` is the counterpart of
  `gru_seq_pallas`: a drop-in for `nn.layers.gru_seq` on the kernel path.

Unlike the TPU kernel, any batch size and any number of steps work, and a
small GRU (16 units) runs at its own width; the unit count must be a
multiple of 16 and at most 1024. The forward's kernel follows the width
(`forward_route`): at N <= 32 (`WARP_MAX_UNITS`) a warp-synchronous kernel
(a stream is N lanes of a warp, lane u owns unit u and keeps its 3N columns
of Wr in registers); where a rank's slice of Wr fits a block (up to 512
units, the training path's 384 among them) the backward chain's cluster
design (`fwd_launch_config`, `pack_fwd_weights`: Wr resident across the
cluster, the product on the tensor cores); above it the first cluster
kernel (`launch_config`, Wr from L2).
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch.autograd.function import once_differentiable

from .masked_loop import SMEM_LIMIT, pack_tiles

# split of the (batch * steps) rows of the dWr product into partial sums:
# enough blocks to fill the card several times over
_DWR_TARGET_BLOCKS = 528
_DWR_MIN_ROWS = 256


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and widen again: the operand of a bf16 product
    whose sums stay float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def gate_input(params, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, in] -> gate_in [B, T, 3N] = bf16(x) . bf16(kernel) + bias[0],
    bf16 operands with float32 sums. A bf16 matmul would round its output
    to bf16; products of bf16 values are exact in float32, so the float32
    matmul of the rounded operands is the bf16-operand product."""
    return (torch.matmul(_bf16(x), _bf16(params["kernel"]))
            + params["bias"][0])


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def gru_recurrence_plain(wr, br, gate_in, h0):
    """K5's plain PyTorch version. wr [N, 3N], br [3N], gate_in [B, T, 3N],
    h0 [B, N] -> (hs [B, T, N], hT [B, N]); autograd gives the backward."""
    n = h0.shape[-1]
    w = _bf16(wr)
    h = h0
    out = []
    for t in range(gate_in.shape[1]):
        g = gate_in[:, t]
        zrec = torch.matmul(_bf16(h), w) + br
        z = torch.sigmoid(g[:, :n] + zrec[:, :n])
        r = torch.sigmoid(g[:, n:2 * n] + zrec[:, n:2 * n])
        hcand = torch.tanh(g[:, 2 * n:] + r * zrec[:, 2 * n:])
        h = z * h + (1.0 - z) * hcand
        out.append(h)
    return torch.stack(out, dim=1), h


def _hprev(h0, hs):
    return torch.cat([h0[:, None], hs[:, :-1]], dim=1)


def gate_pass_plain(wr, br, gate_in, h0, hs):
    """Phase 1 of the backward: for every row (b, t) and unit, from
    hprev = [h0, hs[:-1]], z and the factors fz, fr, fh, fzh that make the
    step's gradients from d = dh + dhs: dgate_in = d [fz | fr | fh],
    dzrec = d [fz | fr | fzh]. Returns (z, fz, fr, fh, fzh), each [B, T, N],
    in the kernel's arithmetic."""
    n = h0.shape[-1]
    hp = _hprev(h0, hs)
    zrec = torch.matmul(_bf16(hp), _bf16(wr)) + br
    z = torch.sigmoid(gate_in[..., :n] + zrec[..., :n])
    r = torch.sigmoid(gate_in[..., n:2 * n] + zrec[..., n:2 * n])
    hc = torch.tanh(gate_in[..., 2 * n:] + r * zrec[..., 2 * n:])
    om = 1.0 - z
    fh = om * (1.0 - hc * hc)
    return (z, (hp - hc) * (z * om), (fh * zrec[..., 2 * n:]) * (r * (1.0 - r)),
            fh, fh * r)


def chain_plain(wr, factors, dhs, dht):
    """Phase 2: the reverse-time chain. factors = `gate_pass_plain`'s,
    dhs [B, T, N], dht [B, N] -> (dgate_in [B, T, 3N], dzh [B, T, N] (the
    candidate part of dzrec), dh0 [B, N], dbr [3N]); per step
    d = dh + dhs, dh <- d z + bf16(dzrec) . bf16(Wr^T)."""
    z, fz, fr, fh, fzh = factors
    wt = _bf16(wr).t()
    dh = dht
    dg, dzh, dbr = [], [], 0.0
    for t in reversed(range(z.shape[1])):
        d = dh + dhs[:, t]
        dpz, dpr, dph, dzv = d * fz[:, t], d * fr[:, t], d * fh[:, t], d * fzh[:, t]
        dg.append(torch.cat([dpz, dpr, dph], dim=-1))
        dzh.append(dzv)
        dzrec = torch.cat([dpz, dpr, dzv], dim=-1)
        dbr = dbr + dzrec
        dh = d * z[:, t] + torch.matmul(_bf16(dzrec), wt)
    return (torch.stack(dg[::-1], dim=1), torch.stack(dzh[::-1], dim=1), dh,
            dbr.sum(dim=0))


def dwr_plain(h0, hs, dg, dzh):
    """Phase 3: dWr = sum over rows of bf16(hprev)^T . bf16(dzrec)."""
    n = h0.shape[-1]
    hp = _hprev(h0, hs).reshape(-1, n)
    dzrec = torch.cat([dg[..., :2 * n], dzh], dim=-1).reshape(-1, 3 * n)
    return torch.matmul(_bf16(hp).t(), _bf16(dzrec))


def rec_backward_plain(wr, br, gate_in, h0, hs, dhs, dht):
    """The three phases composed: (dgate_in, dh0, dWr, dbr), in the order
    of the JAX package's `_rec_backward`."""
    factors = gate_pass_plain(wr, br, gate_in, h0, hs)
    dg, dzh, dh0, dbr = chain_plain(wr, factors, dhs, dht)
    return dg, dh0, dwr_plain(h0, hs, dg, dzh), dbr


# --------------------------------------------------------------------------
# CUDA wrapper
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("gru_train")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lpcnet_gru_train_fwd.argtypes = [ci] * 5 + [vp] * 7
        lib.lpcnet_gru_train_fwd.restype = ci
        lib.lpcnet_gru_train_fwd_warp.argtypes = [ci] * 3 + [vp] * 7
        lib.lpcnet_gru_train_fwd_warp.restype = ci
        lib.lpcnet_gru_train_bwd.argtypes = ([ci] * 8 + [vp] * 13 + [ci, ci]
                                             + [vp] * 4)
        lib.lpcnet_gru_train_bwd.restype = ci
        lib.lpcnet_gru_gate_pass.argtypes = [ci] * 3 + [vp] * 9
        lib.lpcnet_gru_gate_pass.restype = ci
        lib.lpcnet_gru_max_clusters.argtypes = [ci] * 5
        lib.lpcnet_gru_max_clusters.restype = ci
        lib.lpcnet_gru_train_fwd_chain.argtypes = [ci] * 7 + [vp] * 7
        lib.lpcnet_gru_train_fwd_chain.restype = ci
        _LIB = lib
    return _LIB


def _check_units(n: int) -> None:
    if n <= 0 or n % 16 or n > 1024:
        raise ValueError(
            f"GRU training kernel: {n} units (needs a multiple of 16, <= 1024)")


def launch_config(n: int):
    """The first cluster forward's (blocks per cluster, threads per block)
    for N units (`gru_fwd_kernel`, which runs above the resident forward's
    widths, `forward_route`). A
    cluster of thread blocks owns 4 streams; at N >= 256 it has 4 blocks,
    each with a quarter of the units, else one block. A block runs 4
    threads per unit it owns (the k range of a product in 4 parts, then one
    thread per stream and unit)."""
    _check_units(n)
    cluster = 4 if n >= 256 else 1
    return cluster, 4 * (n // cluster)


BWD_STREAMS = (8, 16)        # streams a cluster of the backward chain
BWD_MAX_THREADS = 1024


def bwd_cluster_shape(n: int) -> tuple[int, int]:
    """(C, U) of the backward chain: C = min(8, N / 16) blocks, rank r
    owning units [r U, r U + U), U = 16 ceil(N / 16 C) (U = 48 at N = 384;
    the units past N are padding)."""
    _check_units(n)
    c = min(8, n // 16)
    return c, 16 * -(-n // (16 * c))


def bwd_smem_bytes(n: int, streams: int, resident: bool) -> int:
    """Shared memory of one chain block, bytes (the csrc chain_smem): the
    rank's packed rows of Wr if resident (U x 3N bf16), the dzrec rows of
    two steps ([2][S][3N + 8] bf16) and the S / 2 k parts' sums
    ([S/2][S][U] f32)."""
    _, u = bwd_cluster_shape(n)
    return ((u * 3 * n * 2 if resident else 0) + 2 * streams * (3 * n + 8) * 2
            + streams // 2 * streams * u * 4)


def bwd_launch_config(batch: int, n: int, max_clusters):
    """The chain's launch for `batch` streams of an N-unit GRU:
    {"cluster": C, "units": U, "streams": S, "threads": S U, "clusters":
    ceil(batch / S), "smem": bytes a block, "resident": Wr's rows in shared
    memory, "waves"}. A thread owns one (stream, unit), so S U <= 1024.
    `max_clusters(streams, smem)` is how many such clusters the card holds
    at once (the card's answer on CUDA). S is the smallest of 8 and 16
    whose clusters fit one wave, else the largest allowed (in waves). A
    rank keeps its rows of Wr in shared memory where they fit beside the
    rest (up to N = 384 at S = 16, 448 at S = 8), else reads them from L2."""
    if batch <= 0:
        raise ValueError(f"GRU training kernel: batch {batch}")
    c, u = bwd_cluster_shape(n)
    allowed = [s for s in BWD_STREAMS if s * u <= BWD_MAX_THREADS]
    for s in allowed:
        resident = bwd_smem_bytes(n, s, True) <= SMEM_LIMIT
        smem = bwd_smem_bytes(n, s, resident)
        held = max_clusters(s, smem)
        if -(-batch // s) <= held or s == allowed[-1]:
            break
    clusters = -(-batch // s)
    return {"cluster": c, "units": u, "streams": s, "threads": s * u,
            "clusters": clusters, "smem": smem, "resident": resident,
            "waves": -(-clusters // held)}


def pack_bwd_weights(wr: torch.Tensor) -> torch.Tensor:
    """Wr [N, 3N] -> [C, U / 16, 3N / 16, 32, 8] bf16: rank r's rows (units
    r U .. r U + U, zero past N) as the A operand of the chain's product
    dh^T = Wr_rank . dzrec^T, in `mma.sync` m16n8k16 fragment order
    (`masked_loop.pack_tiles`)."""
    n = wr.shape[0]
    c, u = bwd_cluster_shape(n)
    rows = wr.new_zeros((c * u, 3 * n), dtype=torch.bfloat16)
    rows[:n] = wr.detach().to(torch.bfloat16)
    return pack_tiles(rows.reshape(c, u, 3 * n), 16)


# the widest GRU whose forward runs warp-synchronously: a stream's units fit
# in one warp's lanes, and a lane's 3N weights in its registers
WARP_MAX_UNITS = 32


def forward_uses_warp(n: int) -> bool:
    """Whether the forward of an N-unit GRU runs the warp-synchronous
    kernel (N <= 32) rather than a cluster kernel."""
    launch_config(n)
    return n <= WARP_MAX_UNITS


def fwd_kparts(n: int, streams: int) -> int:
    """The k parts of the resident forward's product (the csrc
    fwd_kparts): as many as the block's S U / 32 warps give each of the 3U
    / 16 gate-column tiles, at most the N / 16 k steps (2 at N = 384,
    S = 16)."""
    _, u = bwd_cluster_shape(n)
    return max(1, min((streams * u // 32) // (3 * u // 16), n // 16))


def fwd_smem_bytes(n: int, streams: int) -> int:
    """Shared memory of one resident forward block, bytes (the csrc
    fwd_chain_smem): the rank's slice of Wr (3U x N bf16), the operand of
    h for two steps ([2][S][C U + 8] bf16) and the k parts' sums
    ([KP][S][3U + 4] f32)."""
    c, u = bwd_cluster_shape(n)
    return (3 * u * n * 2 + 2 * streams * (c * u + 8) * 2
            + fwd_kparts(n, streams) * streams * (3 * u + 4) * 4)


def forward_route(n: int) -> str:
    """The forward kernel of an N-unit GRU, by width alone: "warp" at
    N <= 32 (`gru_fwd_warp_kernel`), "resident" where a rank's slice of Wr
    fits a block beside the rest at S = 8 (`gru_fwd_chain_kernel`, up to
    N = 512), "cluster" above (`gru_fwd_kernel`, Wr from L2)."""
    if forward_uses_warp(n):
        return "warp"
    return "resident" if fwd_smem_bytes(n, 8) <= SMEM_LIMIT else "cluster"


def fwd_launch_config(batch: int, n: int, max_clusters):
    """The resident forward's launch for `batch` streams: the keys of
    `bwd_launch_config` ("cluster", "units", "streams", "threads",
    "clusters", "smem", "waves"; the slice is always resident). The
    cluster shape is the backward chain's (`bwd_cluster_shape`); S is the
    smallest of 8 and 16 whose clusters fit one wave by
    `max_clusters(streams, smem)`, else the largest that fits a block
    (S U <= 1024 threads and the shared memory)."""
    if batch <= 0:
        raise ValueError(f"GRU training kernel: batch {batch}")
    if forward_route(n) != "resident":
        raise ValueError(f"GRU training kernel: {n} units have no resident forward")
    c, u = bwd_cluster_shape(n)
    allowed = [s for s in BWD_STREAMS if s * u <= BWD_MAX_THREADS
               and fwd_smem_bytes(n, s) <= SMEM_LIMIT]
    for s in allowed:
        smem = fwd_smem_bytes(n, s)
        held = max_clusters(s, smem)
        if -(-batch // s) <= held or s == allowed[-1]:
            break
    clusters = -(-batch // s)
    return {"cluster": c, "units": u, "streams": s, "threads": s * u,
            "clusters": clusters, "smem": smem, "waves": -(-clusters // held)}


def pack_fwd_weights(wr: torch.Tensor) -> torch.Tensor:
    """Wr [N, 3N] -> [C, 3U / 16, N / 16, 32, 8] bf16: rank r's 3U gate
    columns [z | r | h] of units r U .. r U + U (zero past N), all N rows
    deep, as the A operand of the resident forward's product
    zrec^T = Wr_rank^T . h^T, in `mma.sync` m16n8k16 fragment order
    (`masked_loop.pack_tiles`)."""
    n = wr.shape[0]
    c, u = bwd_cluster_shape(n)
    cols = wr.new_zeros((3, c * u, n), dtype=torch.bfloat16)    # [gate, unit, k]
    cols[:, :n] = wr.detach().to(torch.bfloat16).t().reshape(3, n, n)
    at = cols.reshape(3, c, u, n).transpose(0, 1).reshape(c, 3 * u, n)
    return pack_tiles(at, 16)


def pack_recurrent(wr: torch.Tensor) -> torch.Tensor:
    """Wr [N, 3N] f32 -> wp [N/4, 3, N, 4] bf16, the forward product's
    operand: four consecutive k of one gate column sit in one 8-byte word."""
    n = wr.shape[0]
    wb = wr.detach().to(torch.bfloat16)
    return wb.view(n // 4, 4, 3, n).permute(0, 2, 3, 1).contiguous()


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


_MAX_CLUSTERS: dict = {}


def _max_clusters(dev, n, direction="bwd"):
    """`bwd_launch_config`'s (or, with direction "fwd",
    `fwd_launch_config`'s) `max_clusters(streams, smem)` on the card `dev`:
    the CUDA occupancy query of that kernel, remembered per card and
    shape."""
    c, u = bwd_cluster_shape(n)
    fwd = {"bwd": 0, "fwd": 1}[direction]

    def ask(streams, smem):
        key = (dev.index, direction, streams, c, u, smem)
        if key not in _MAX_CLUSTERS:
            with torch.cuda.device(dev):
                got = _lib().lpcnet_gru_max_clusters(fwd, streams, c, streams * u, smem)
            if got <= 0:
                raise RuntimeError(
                    f"GRU training kernel: no cluster of {c} blocks with {smem} "
                    f"bytes fits the card (CUDA {-got})")
            _MAX_CLUSTERS[key] = got
        return _MAX_CLUSTERS[key]

    return ask


def gate_pass_kernel(wr, br, gate_in, h0, hs):
    """The backward's gate pass alone on the card (the first of the
    backward launch's three phases), for holding it against
    `gate_pass_plain`: (z, fz, fr, fh, fzh), each [B, T, N]. Not counted:
    the training path runs it inside `GruRecurrence.backward`."""
    dev = gate_in.device
    if dev.type != "cuda":
        raise ValueError(f"GRU gate pass kernel: unsupported device {dev}")
    b, t, n3 = gate_in.shape
    n = n3 // 3
    _check_units(n)
    br, gate_in, h0, hs = (x.detach().contiguous() for x in (br, gate_in, h0, hs))
    for name, x, shape in (("br", br, (n3,)), ("gate_in", gate_in, (b, t, n3)),
                           ("h0", h0, (b, n)), ("hs", hs, (b, t, n))):
        _check(name, x, shape, dev)
    wrt = wr.detach().t().contiguous().to(torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=dev)
    dg = torch.empty((b, t, n3), **f32)
    dzh, zb = (torch.empty((b, t, n), **f32) for _ in range(2))
    with torch.cuda.device(dev):
        err = _lib().lpcnet_gru_gate_pass(
            b, t, n, *(x.data_ptr() for x in (wrt, br, gate_in, h0, hs, dg, dzh, zb)),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"GRU gate pass kernel launch failed: CUDA error {err}")
    return zb, dg[..., :n], dg[..., n:2 * n], dg[..., 2 * n:], dzh


class GruRecurrence(torch.autograd.Function):
    """(wr [N, 3N], br [3N], gate_in [B, T, 3N], h0 [B, N]) -> (hs, hT) on
    the card. Saves (wr, br, gate_in, h0, hs) as the JAX VJP does; the
    backward recomputes the gates in its gate pass, then runs the chain and
    the dWr product (one launch of the three phases).
    `launches` counts kernel launches keyed (direction, N), direction "fwd"
    or "bwd"; `launch_totals()` sums them over N."""

    launches = collections.Counter()

    @classmethod
    def launch_totals(cls) -> dict:
        """{"fwd": launches of the forward kernel, "bwd": of the backward}."""
        return {d: sum(c for (dk, _), c in cls.launches.items() if dk == d)
                for d in ("fwd", "bwd")}

    @classmethod
    def reset_launches(cls) -> None:
        cls.launches.clear()

    @staticmethod
    def forward(ctx, wr, br, gate_in, h0):
        dev = gate_in.device
        if dev.type != "cuda":
            raise ValueError(f"GRU training kernel: unsupported device {dev}")
        b, t, n3 = gate_in.shape
        n = n3 // 3
        wr, br, gate_in, h0 = (x.detach().contiguous()
                               for x in (wr, br, gate_in, h0))
        _check("wr", wr, (n, n3), dev)
        _check("br", br, (n3,), dev)
        _check("gate_in", gate_in, (b, t, n3), dev)
        _check("h0", h0, (b, n), dev)
        route = forward_route(n)
        wp = pack_fwd_weights(wr) if route == "resident" else pack_recurrent(wr)
        hs = torch.empty((b, t, n), dtype=torch.float32, device=dev)
        ht = torch.empty((b, n), dtype=torch.float32, device=dev)
        ptrs = (wp.data_ptr(), br.data_ptr(), gate_in.data_ptr(),
                h0.data_ptr(), hs.data_ptr(), ht.data_ptr())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if route == "warp":
                err = _lib().lpcnet_gru_train_fwd_warp(b, t, n, *ptrs, stream)
            elif route == "resident":
                cfg = fwd_launch_config(b, n, _max_clusters(dev, n, "fwd"))
                err = _lib().lpcnet_gru_train_fwd_chain(
                    b, t, n, cfg["cluster"], cfg["units"], cfg["streams"],
                    cfg["smem"], *ptrs, stream)
            else:
                cluster, threads = launch_config(n)
                err = _lib().lpcnet_gru_train_fwd(b, t, n, cluster, threads,
                                                  *ptrs, stream)
        if err != 0:
            raise RuntimeError(
                f"GRU training kernel (forward) launch failed: CUDA error {err}")
        GruRecurrence.launches[("fwd", n)] += 1
        ctx.save_for_backward(wr, br, gate_in, h0, hs)
        return hs, ht

    @staticmethod
    @once_differentiable
    def backward(ctx, dhs, dht):
        wr, br, gate_in, h0, hs = ctx.saved_tensors
        dev = gate_in.device
        b, t, n3 = gate_in.shape
        n = n3 // 3
        dhs = dhs.contiguous()
        dht = dht.contiguous()
        _check("dhs", dhs, (b, t, n), dev)
        _check("dhT", dht, (b, n), dev)
        want_w = bool(ctx.needs_input_grad[0] or ctx.needs_input_grad[1])
        cfg = bwd_launch_config(b, n, _max_clusters(dev, n))
        wb = pack_bwd_weights(wr)
        wrt = wr.t().contiguous().to(torch.bfloat16)   # the gate pass's operand
        f32 = dict(dtype=torch.float32, device=dev)
        # the gate pass writes its factors into dg and dzh (and z into zb);
        # the chain overwrites them with the gradients
        dg = torch.empty((b, t, n3), **f32)
        dzh = torch.empty((b, t, n), **f32)     # dzrec's candidate part
        zb = torch.empty((b, t, n), **f32)
        dh0 = torch.empty((b, n), **f32)
        slots = cfg["clusters"] * cfg["streams"]
        dbr_part = torch.empty((slots, n3), **f32)   # one partial per stream
        parts, dwr_part, dwr, dbr = 0, None, None, None
        if want_w:
            tiles = -(-n // 128) * -(-n3 // 128)
            parts = max(1, min(-(-_DWR_TARGET_BLOCKS // tiles),
                               -(-b * t // _DWR_MIN_ROWS)))
            dwr_part = torch.empty((parts, n, n3), **f32)
            dwr = torch.empty((n, n3), **f32)
            dbr = torch.empty((n3,), **f32)
        ptr = lambda x: None if x is None else x.data_ptr()
        with torch.cuda.device(dev):
            err = _lib().lpcnet_gru_train_bwd(
                b, t, n, cfg["cluster"], cfg["units"], cfg["streams"],
                cfg["smem"], int(cfg["resident"]), ptr(wb), ptr(wrt), ptr(br),
                ptr(gate_in), ptr(h0), ptr(hs), ptr(dhs), ptr(dht),
                ptr(dg), ptr(dzh), ptr(zb), ptr(dh0), ptr(dbr_part),
                int(want_w), parts, ptr(dwr_part), ptr(dwr), ptr(dbr),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"GRU training kernel (backward) launch failed: CUDA error {err}")
        GruRecurrence.launches[("bwd", n)] += 1
        need = ctx.needs_input_grad
        return (dwr if need[0] else None, dbr if need[1] else None,
                dg if need[2] else None, dh0 if need[3] else None)


def gru_recurrence(wr, br, gate_in, h0):
    """The recurrence on the device of `gate_in`: the plain version on the
    CPU, the CUDA kernels on a card, an error anywhere else."""
    kind = gate_in.device.type
    if kind == "cpu":
        return gru_recurrence_plain(wr, br, gate_in, h0)
    if kind == "cuda":
        return GruRecurrence.apply(wr, br, gate_in, h0)
    raise ValueError(f"GRU training kernel: unsupported device {gate_in.device}")


def gru_seq_kernel(params, x, h0=None):
    """GRU over a sequence x [B, T, in] -> (hs [B, T, N], hT), tanh
    activation, bf16-operand products: the kernel path of the training
    graph (counterpart of `gru_seq_pallas`)."""
    n = params["recurrent"].shape[0]
    gate_in = gate_input(params, x)
    if h0 is None:
        h0 = torch.zeros(x.shape[:-2] + (n,), dtype=torch.float32,
                         device=x.device)
    return gru_recurrence(params["recurrent"], params["bias"][1], gate_in, h0)
