"""The PLC-net chain: K masked steps of the PLC feature-prediction network
(`models.plc.compute_plc_pred`) as one CUDA kernel launch
(`csrc/plc_chain.cu`, K4). Port of `lpcnet_tpu/kernels/plc_chain.py`.

The batched PLC frame step makes up to five dependent PLC-net calls: the
prediction that restores a blending stream, one `get_fec_or_pred` per drain
iteration and the lost frame's prediction (src/lpcnet_plc.c:135-166). Their
inputs can all be computed before any of them runs, and blending and lost
streams are disjoint, so the chain is one launch with a mask per stream and
step, and the states after every step and every step's output come back for
the frame-rate program to replay.

* `plc_chain_weights` packs the network's params for the kernel (float32,
  contiguous, no padding).
* `plc_chain_plain` is the plain PyTorch version: the same steps, one at a
  time. The CPU tests use it and the chip check holds the kernel against it.
* `plc_chain_kernel` is the wrapper: on a CPU tensor it runs the plain
  version; on a CUDA tensor it launches the kernel or raises.

The +0.1 boost of the predicted correlation stays with the caller: it
applies to predictions only, not to consumed FEC rows.
"""

from __future__ import annotations

import ctypes

import torch

_CWNAMES = ("d1_w", "d1_b", "g1_in", "g1_rec", "g1_b", "g2_in", "g2_rec",
            "g2_b", "out_w", "out_b")


def plc_chain_weights(plc_params):
    """`models.plc` params -> the kernel's operand bundle."""
    f32 = lambda x: x.to(torch.float32).contiguous()
    d1, g1 = plc_params["plc_dense1"], plc_params["plc_gru1"]
    g2, out = plc_params["plc_gru2"], plc_params["plc_out"]
    return {
        "d1_w": f32(d1["kernel"]), "d1_b": f32(d1["bias"]),
        "g1_in": f32(g1["kernel"]), "g1_rec": f32(g1["recurrent"]),
        "g1_b": f32(g1["bias"]),
        "g2_in": f32(g2["kernel"]), "g2_rec": f32(g2["recurrent"]),
        "g2_b": f32(g2["bias"]),
        "out_w": f32(out["kernel"]), "out_b": f32(out["bias"]),
    }


def _gru(h, x, w_in, w_rec, bias):
    n = h.shape[-1]
    zin = x @ w_in + bias[0]
    zrec = h @ w_rec + bias[1]
    z = torch.sigmoid(zin[:, :n] + zrec[:, :n])
    r = torch.sigmoid(zin[:, n:2 * n] + zrec[:, n:2 * n])
    hc = torch.tanh(zin[:, 2 * n:] + r * zrec[:, 2 * n:])
    return z * h + (1.0 - z) * hc


def plc_chain_plain(cw, h1, h2, inputs, masks, k_steps: int):
    """K4's plain PyTorch version, on whatever device the tensors are on.

    cw from `plc_chain_weights`; h1 [B, n1], h2 [B, n2] initial states;
    inputs [B, K, 57]; masks [B, K] bool or int (0 freezes the stream for
    that step; the step's raw output is still returned).
    Returns (h1_seq [B, K, n1], h2_seq [B, K, n2], outs [B, K, 20]): the
    states after each step and each step's dense output.
    """
    inputs = inputs.to(torch.float32)
    h1s, h2s, outs = [], [], []
    for k in range(k_steps):
        d = torch.tanh(inputs[:, k] @ cw["d1_w"] + cw["d1_b"])
        h1n = _gru(h1, d, cw["g1_in"], cw["g1_rec"], cw["g1_b"])
        h2n = _gru(h2, h1n, cw["g2_in"], cw["g2_rec"], cw["g2_b"])
        outs.append(h2n @ cw["out_w"] + cw["out_b"])
        m = (masks[:, k] > 0)[:, None]
        h1 = torch.where(m, h1n, h1)
        h2 = torch.where(m, h2n, h2)
        h1s.append(h1)
        h2s.append(h2)
    return (torch.stack(h1s, dim=1), torch.stack(h2s, dim=1),
            torch.stack(outs, dim=1))


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("plc_chain")
        lib.lpcnet_plc_chain.argtypes = ([ctypes.c_int] * 7
                                         + [ctypes.c_void_p] * 18)
        lib.lpcnet_plc_chain.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def plc_chain_kernel(cw, h1, h2, inputs, masks, k_steps: int):
    """K masked PLC-net steps in one launch; arguments and results as
    `plc_chain_plain`.

    On a CPU tensor this runs the plain version. On a CUDA tensor it
    launches the CUDA kernel (built on first use) and counts the launch in
    `plc_chain_kernel.launches`; any other device raises. Any batch size.
    """
    dev = h1.device
    if dev.type == "cpu":
        return plc_chain_plain(cw, h1, h2, inputs, masks, k_steps)
    if dev.type != "cuda":
        raise ValueError(f"PLC chain kernel: unsupported device {dev}")
    from .sample_loop import _check
    f32 = torch.float32
    b, n1 = h1.shape
    n2 = h2.shape[1]
    n_in, nd = cw["d1_w"].shape
    n_out = cw["out_w"].shape[1]
    shapes = {"d1_w": (n_in, nd), "d1_b": (nd,), "g1_in": (nd, 3 * n1),
              "g1_rec": (n1, 3 * n1), "g1_b": (2, 3 * n1),
              "g2_in": (n1, 3 * n2), "g2_rec": (n2, 3 * n2),
              "g2_b": (2, 3 * n2), "out_w": (n2, n_out), "out_b": (n_out,)}
    for name in _CWNAMES:
        _check(name, cw[name], shapes[name], f32, dev)
    inputs = inputs.to(f32).contiguous()
    masks = masks.to(torch.int32).contiguous()
    h1, h2 = h1.contiguous(), h2.contiguous()
    _check("inputs", inputs, (b, k_steps, n_in), f32, dev)
    _check("masks", masks, (b, k_steps), torch.int32, dev)
    _check("h1", h1, (b, n1), f32, dev)
    _check("h2", h2, (b, n2), f32, dev)
    h1_seq = torch.empty((b, k_steps, n1), dtype=f32, device=dev)
    h2_seq = torch.empty((b, k_steps, n2), dtype=f32, device=dev)
    outs = torch.empty((b, k_steps, n_out), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().lpcnet_plc_chain(
            b, k_steps, n_in, nd, n1, n2, n_out,
            *(cw[name].data_ptr() for name in _CWNAMES),
            inputs.data_ptr(), masks.data_ptr(), h1.data_ptr(), h2.data_ptr(),
            h1_seq.data_ptr(), h2_seq.data_ptr(), outs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"PLC chain kernel launch failed: CUDA error {err}")
    plc_chain_kernel.launches += 1
    return h1_seq, h2_seq, outs


plc_chain_kernel.launches = 0
