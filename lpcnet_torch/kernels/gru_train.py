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
* `gru_recurrence` dispatches on the device of `gate_in`: CPU -> plain, CUDA
  -> `GruRecurrence` (the kernels; a build or launch failure raises), any
  other device raises.
* `gru_seq_kernel(params, x, h0=None)` is the counterpart of
  `gru_seq_pallas`: a drop-in for `nn.layers.gru_seq` on the kernel path.

Unlike the TPU kernel, any batch size and any number of steps work, and a
small GRU (16 units) runs at its own width; the unit count must be a
multiple of 16 and at most 1024. At N <= 32 (`WARP_MAX_UNITS`) the forward
is a warp-synchronous kernel: a stream is N lanes of a warp, lane u owns
unit u and keeps its 3N columns of Wr in registers.
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch.autograd.function import once_differentiable

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
        lib.lpcnet_gru_train_bwd.argtypes = ([ci] * 5 + [vp] * 12 + [ci, ci]
                                             + [vp] * 4)
        lib.lpcnet_gru_train_bwd.restype = ci
        _LIB = lib
    return _LIB


STREAMS_PER_CLUSTER = 4


def launch_config(n: int):
    """(blocks per cluster, threads per block) for N units. A cluster of
    thread blocks owns 4 streams; at N >= 256 it has 4 blocks, each with a
    quarter of the units, else one block. A block runs 4 threads per unit
    it owns (the k range of a product in 4 parts, then one thread per
    stream and unit)."""
    if n <= 0 or n % 16 or n > 1024:
        raise ValueError(
            f"GRU training kernel: {n} units (needs a multiple of 16, <= 1024)")
    cluster = 4 if n >= 256 else 1
    return cluster, 4 * (n // cluster)


# the widest GRU whose forward runs warp-synchronously: a stream's units fit
# in one warp's lanes, and a lane's 3N weights in its registers
WARP_MAX_UNITS = 32


def forward_uses_warp(n: int) -> bool:
    """Whether the forward of an N-unit GRU runs the warp-synchronous
    kernel (N <= 32) rather than the cluster kernel."""
    launch_config(n)
    return n <= WARP_MAX_UNITS


def pack_recurrent(wr: torch.Tensor) -> torch.Tensor:
    """Wr [N, 3N] f32 -> wp [N/4, 3, N, 4] bf16, the forward product's
    operand: four consecutive k of one gate column sit in one 8-byte word."""
    n = wr.shape[0]
    wb = wr.detach().to(torch.bfloat16)
    return wb.view(n // 4, 4, 3, n).permute(0, 2, 3, 1).contiguous()


def pack_recurrent_t(wr: torch.Tensor) -> torch.Tensor:
    """Wr [N, 3N] f32 -> wtp [3N/4, N, 4] bf16, the operand of the
    backward's Wr^T product: four consecutive gate columns of Wr^T's column
    u sit in one 8-byte word."""
    n = wr.shape[0]
    wb = wr.detach().to(torch.bfloat16)
    return wb.view(n, 3 * n // 4, 4).permute(1, 0, 2).contiguous()


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


class GruRecurrence(torch.autograd.Function):
    """(wr [N, 3N], br [3N], gate_in [B, T, 3N], h0 [B, N]) -> (hs, hT) on
    the card. Saves (wr, br, gate_in, h0, hs) as the JAX VJP does; the
    backward recomputes the gates and reuses the forward's packed Wr.
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
        cluster, threads = launch_config(n)
        wp = pack_recurrent(wr)
        hs = torch.empty((b, t, n), dtype=torch.float32, device=dev)
        ht = torch.empty((b, n), dtype=torch.float32, device=dev)
        ptrs = (wp.data_ptr(), br.data_ptr(), gate_in.data_ptr(),
                h0.data_ptr(), hs.data_ptr(), ht.data_ptr())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if forward_uses_warp(n):
                err = _lib().lpcnet_gru_train_fwd_warp(b, t, n, *ptrs, stream)
            else:
                err = _lib().lpcnet_gru_train_fwd(b, t, n, cluster, threads,
                                                  *ptrs, stream)
        if err != 0:
            raise RuntimeError(
                f"GRU training kernel (forward) launch failed: CUDA error {err}")
        GruRecurrence.launches[("fwd", n)] += 1
        ctx.save_for_backward(wr, br, gate_in, h0, hs)
        ctx.wp = wp
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
        cluster, threads = launch_config(n)
        wp, wtp = ctx.wp, pack_recurrent_t(wr)
        f32 = dict(dtype=torch.float32, device=dev)
        dg = torch.empty((b, t, n3), **f32)
        dzh = torch.empty((b, t, n), **f32)     # dzrec's candidate part
        dh0 = torch.empty((b, n), **f32)
        slots = -(-b // STREAMS_PER_CLUSTER) * STREAMS_PER_CLUSTER
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
                b, t, n, cluster, threads, ptr(wp), ptr(wtp), ptr(br),
                ptr(gate_in), ptr(h0), ptr(hs), ptr(dhs), ptr(dht),
                ptr(dg), ptr(dzh), ptr(dh0), ptr(dbr_part),
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
