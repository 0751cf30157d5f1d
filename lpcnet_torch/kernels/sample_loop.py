"""The autoregressive sample loop (K1): one 10 ms frame of 160 dependent
steps per stream, as one CUDA kernel launch (`csrc/sample_loop.cu`).

Port of `lpcnet_tpu/kernels/sample_loop.py::_ar_kernel` run free
(masked=False, sampled=True). Each step: LPC prediction, u-law codes, the
three-row embedding gather plus reset-after GRU-A, GRU-B, the dual-FC node
logits, the 8-bit tree descent on KISS99 threshold bytes, de-emphasis, clip
and round. The carried state is (h_a, h_b, last_sig, last_exc, deemph, rng).

* `kernel_weights` builds the kernel's weight bundle (f32/bf16 operands, or
  the q8 form with the per-column-scaled int8 embedding), as the JAX
  package does.
* `sample_loop_plain` is the kernel's plain PyTorch version: the same
  numerics, step by step. The CPU tests use it and the chip check holds the
  kernel against it.
* `synthesize_frame_kernel` is the wrapper: on a CPU tensor it runs the
  plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..dsp import mulaw
from ..dsp.constants import LPC_ORDER, PREEMPHASIS
from ..models.lpcnet import (LPCNetConfig, SampleState, draw_threshold_bytes,
                             sampling_logit_table)
from ..nn import quantized as Q
from ..utils.rng import Kiss99State

_FORMS = {torch.float32: 0, torch.bfloat16: 1}
_FORM_Q8 = 2


def kernel_weights(fused, cfg: LPCNetConfig, dtype=torch.bfloat16,
                   quantized: bool | None = None):
    """The kernel-layout weight bundle from fused params.

    `dtype` is the operand type of the big matrices (embedding table, GRU
    matrices): bfloat16 (default) or float32; sums stay float32.
    `quantized` selects the q8 bundle: the reference's DOT_PROD integer
    numerics for the GRU matrices (round(128*w) weights on floor(0.5+127*h)
    activations, int32 sums, float GRU-A diagonal) and an int8 embedding
    table with per-column scales. It defaults to True when the fused params
    are already int8 (nn.quantized.quantize_fused).
    """
    was_q = Q.is_quantized(fused)
    if quantized is None:
        quantized = was_q
    if was_q:
        # float view of the shared pieces (exact: int8 weights sit on the
        # 1/128 grid)
        fq = fused
        fused = dict(fused)
        rec = (fq["gru_a_rec"]["recurrent_q8"].to(torch.float32) / 128.0
               + torch.cat([torch.diag(d) for d in torch.chunk(
                   fq["gru_a_rec"]["recurrent_diag"], 3)], dim=1))
        fused["gru_a_rec"] = dict(fq["gru_a_rec"], recurrent=rec)
        fused["gru_b_in"] = fused.pop("gru_b_in_q8").to(torch.float32) / 128.0
        fused["gru_b_rec"] = dict(
            fq["gru_b_rec"],
            recurrent=fq["gru_b_rec"]["recurrent_q8"].to(torch.float32) / 128.0)
    emb_cat = torch.cat([fused["embed_sig_a"], fused["embed_pred_a"],
                         fused["embed_exc_a"]], dim=0)          # [768, 3Na]
    dk = fused["dual_fc"]["kernel"]                             # [Nb, 256, 2]
    f32 = lambda x: x.to(torch.float32).contiguous()
    kw = {
        "a_bias1": f32(fused["gru_a_rec"]["bias"][1][None, :]),
        "b_rec": fused["gru_b_rec"]["recurrent"].to(dtype).contiguous(),
        "b_bias1": f32(fused["gru_b_rec"]["bias"][1][None, :]),
        # one [Nb, 512] product gives both channels of every tree node
        "dual_w": f32(torch.cat([dk[:, :, 0], dk[:, :, 1]], dim=1)),
        "dual_bias": f32(torch.cat([fused["dual_fc"]["bias"][:, 0],
                                    fused["dual_fc"]["bias"][:, 1]])[None, :]),
        "dual_factor": f32(torch.cat([fused["dual_fc"]["factor"][:, 0],
                                      fused["dual_fc"]["factor"][:, 1]])[None, :]),
        "logit_table": torch.from_numpy(sampling_logit_table())[None, :].to(
            emb_cat.device),
    }
    if quantized:
        if was_q:
            a_off_q8 = fq["gru_a_rec"]["recurrent_q8"]
            a_diag = fq["gru_a_rec"]["recurrent_diag"]
            b_in_q8 = fq["gru_b_in_q8"]
            b_rec_q8 = fq["gru_b_rec"]["recurrent_q8"]
        else:
            off, a_diag = Q.split_diag(fused["gru_a_rec"]["recurrent"])
            a_off_q8 = Q.quantize_weights_int8(off)
            b_in_q8 = Q.quantize_weights_int8(fused["gru_b_in"])
            b_rec_q8 = Q.quantize_weights_int8(fused["gru_b_rec"]["recurrent"])
        emb = emb_cat.to(torch.float32)
        emb_scale = torch.clamp(emb.abs().amax(dim=0), min=1e-10) / 127.0
        emb_q8 = torch.clamp(torch.round(emb / emb_scale), -127, 127
                             ).to(torch.int8)
        kw.update(emb_q8=emb_q8.contiguous(), emb_scale=emb_scale[None, :],
                  a_rec_q8=a_off_q8.contiguous(),
                  a_diag=f32(a_diag)[None, :],
                  b_in_q8=b_in_q8.contiguous(), b_rec_q8=b_rec_q8.contiguous())
        del kw["b_rec"]
    else:
        kw.update(emb_cat=emb_cat.to(dtype).contiguous(),
                  a_rec=fused["gru_a_rec"]["recurrent"].to(dtype).contiguous(),
                  b_in=fused["gru_b_in"].to(dtype).contiguous())
    return kw


def is_q8_bundle(kw) -> bool:
    return "emb_q8" in kw


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _gru(h0, gate, zrec, n):
    zr = _sigmoid(gate[:, :2 * n] + zrec[:, :2 * n])
    z, r = zr[:, :n], zr[:, n:]
    hc = torch.tanh(gate[:, 2 * n:] + r * zrec[:, 2 * n:])
    return z * h0 + (1.0 - z) * hc


def _qdot(h, w_q):
    """floor(0.5+127h) int8 activations x int8 weights, exact, * SCALE_1."""
    return Q.qmatmul(Q.quantize_act_int8(h), w_q)


def _fdot(h, w32, wdt):
    """Operand-type product (h rounded to the weights' type `wdt`; `w32` is
    the weight widened to f32), f32 sums."""
    return h.to(wdt).to(torch.float32) @ w32


def sample_loop_plain(kw, state: SampleState, cond_a, cond_b, lpc,
                      n_samples: int = 160):
    """K1's plain PyTorch version: the kernel's arithmetic, one step at a
    time, on whatever device the tensors are on.

    Returns (new_state, pcm [B, n_samples] float, rounded, in +-32767).
    """
    q8 = is_q8_bundle(kw)
    na = kw["a_bias1"].shape[-1] // 3
    nb = kw["b_bias1"].shape[-1] // 3
    table = kw["logit_table"][0]
    ha, hb, sig, exc, de, rng = state
    exc = exc.long()
    # widen the operands once (exact); the loop then gathers and multiplies
    if q8:
        emb = kw["emb_q8"].to(torch.int32)
    else:
        emb = kw["emb_cat"].to(torch.float32)
        wdt = kw["a_rec"].dtype
        a_rec, b_in, b_rec = (kw[k].to(torch.float32)
                              for k in ("a_rec", "b_in", "b_rec"))
    out = []
    for _ in range(n_samples):
        pred = -(sig * lpc).sum(-1)
        sig_u = mulaw.lin2ulaw(sig[:, 0]).long()
        pred_u = mulaw.lin2ulaw(pred).long()
        esum = emb[sig_u] + emb[256 + pred_u] + emb[512 + exc]
        if q8:
            gate_a = cond_a + esum.to(torch.float32) * kw["emb_scale"]
            zrec = (_qdot(ha, kw["a_rec_q8"]) + kw["a_diag"]
                    * torch.cat([ha, ha, ha], dim=1) + kw["a_bias1"])
        else:
            gate_a = cond_a + esum
            zrec = _fdot(ha, a_rec, wdt) + kw["a_bias1"]
        ha = _gru(ha, gate_a, zrec, na)
        if q8:
            gate_b = cond_b + _qdot(ha, kw["b_in_q8"])
            zrec_b = _qdot(hb, kw["b_rec_q8"]) + kw["b_bias1"]
        else:
            gate_b = cond_b + _fdot(ha, b_in, wdt)
            zrec_b = _fdot(hb, b_rec, wdt) + kw["b_bias1"]
        hb = _gru(hb, gate_b, zrec_b, nb)

        pre = hb @ kw["dual_w"] + kw["dual_bias"]
        tpre = kw["dual_factor"] * torch.tanh(pre)
        logits = tpre[:, :256] + tpre[:, 256:]                  # [B, 256]
        bytes_, rng = draw_threshold_bytes(rng)
        val = torch.zeros_like(exc)
        for b in range(8):
            node = logits.gather(1, ((1 << b) | val)[:, None])[:, 0]
            val = (val << 1) | (node - table[bytes_[b]] > 0).long()
        pcm = pred + mulaw.ulaw2lin(val)
        exc = val
        sig = torch.cat([pcm[:, None], sig[:, :LPC_ORDER - 1]], dim=1)
        de = pcm + PREEMPHASIS * de
        out.append(torch.floor(0.5 + torch.clamp(de, -32767.0, 32767.0)))
    new_state = SampleState(ha, hb, sig, exc.to(torch.int32), de, rng)
    return new_state, torch.stack(out, dim=1)


# --------------------------------------------------------------------------
# CUDA wrapper
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("sample_loop")
        fn = lib.lpcnet_sample_loop
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 29
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def synthesize_frame_kernel(kw, state: SampleState, cond_a, cond_b, lpc,
                            n_samples: int = 160):
    """One frame of the sample loop: (new_state, pcm [B, n_samples]).

    On a CPU tensor this runs `sample_loop_plain`. On a CUDA tensor it
    launches the CUDA kernel (built on first use) and counts the launch in
    `synthesize_frame_kernel.launches`; any other device raises. Any batch
    size works: the kernel masks the ragged last block of streams.
    """
    dev = cond_a.device
    if dev.type == "cpu":
        return sample_loop_plain(kw, state, cond_a, cond_b, lpc, n_samples)
    if dev.type != "cuda":
        raise ValueError(f"sample loop kernel: unsupported device {dev}")
    q8 = is_q8_bundle(kw)
    b, na3 = cond_a.shape
    na = na3 // 3
    nb = kw["b_bias1"].shape[-1] // 3
    f32, i8 = torch.float32, torch.int8
    if q8:
        form, wdt = _FORM_Q8, i8
        emb, a_rec, b_in, b_rec = (kw["emb_q8"], kw["a_rec_q8"],
                                   kw["b_in_q8"], kw["b_rec_q8"])
        _check("emb_scale", kw["emb_scale"], (1, 3 * na), f32, dev)
        _check("a_diag", kw["a_diag"], (1, 3 * na), f32, dev)
        emb_scale, a_diag = kw["emb_scale"], kw["a_diag"]
    else:
        emb, a_rec, b_in, b_rec = (kw["emb_cat"], kw["a_rec"], kw["b_in"],
                                   kw["b_rec"])
        wdt = emb.dtype
        if wdt not in _FORMS:
            raise TypeError(f"sample loop kernel: operand dtype {wdt}")
        form = _FORMS[wdt]
        emb_scale = a_diag = None
    _check("emb", emb, (768, 3 * na), wdt, dev)
    _check("a_rec", a_rec, (na, 3 * na), wdt, dev)
    _check("b_in", b_in, (na, 3 * nb), wdt, dev)
    _check("b_rec", b_rec, (nb, 3 * nb), wdt, dev)
    for name, shape in (("a_bias1", (1, 3 * na)), ("b_bias1", (1, 3 * nb)),
                        ("dual_w", (nb, 512)), ("dual_bias", (1, 512)),
                        ("dual_factor", (1, 512)), ("logit_table", (1, 256))):
        _check(name, kw[name], shape, f32, dev)
    _check("cond_a", cond_a, (b, 3 * na), f32, dev)
    _check("cond_b", cond_b, (b, 3 * nb), f32, dev)
    _check("lpc", lpc, (b, LPC_ORDER), f32, dev)
    ha_in = state.gru_a.contiguous()
    hb_in = state.gru_b.contiguous()
    sig_in = state.last_sig.contiguous()
    exc_in = state.last_exc.contiguous()
    de_in = state.deemph.contiguous()
    rng_in = torch.stack(tuple(state.rng), dim=1).contiguous()   # [B, 4]
    _check("gru_a", ha_in, (b, na), f32, dev)
    _check("gru_b", hb_in, (b, nb), f32, dev)
    _check("last_sig", sig_in, (b, LPC_ORDER), f32, dev)
    _check("last_exc", exc_in, (b,), torch.int32, dev)
    _check("deemph", de_in, (b,), f32, dev)
    _check("rng", rng_in, (b, 4), torch.int64, dev)

    ha, hb, sig, de = (torch.empty_like(x) for x in (ha_in, hb_in, sig_in,
                                                     de_in))
    exc = torch.empty_like(exc_in)
    rng = torch.empty_like(rng_in)
    pcm = torch.empty((b, n_samples), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().lpcnet_sample_loop(
            form, b, na, nb, n_samples,
            ptr(emb), ptr(emb_scale), ptr(a_rec), ptr(a_diag),
            ptr(kw["a_bias1"]), ptr(b_in), ptr(b_rec), ptr(kw["b_bias1"]),
            ptr(kw["dual_w"]), ptr(kw["dual_bias"]), ptr(kw["dual_factor"]),
            ptr(kw["logit_table"]),
            ptr(cond_a), ptr(cond_b), ptr(lpc),
            ptr(ha_in), ptr(hb_in), ptr(sig_in), ptr(exc_in), ptr(de_in),
            ptr(rng_in),
            ptr(ha), ptr(hb), ptr(sig), ptr(exc), ptr(de), ptr(rng), ptr(pcm),
            stream)
    if err != 0:
        raise RuntimeError(f"sample loop kernel launch failed: CUDA error {err}")
    synthesize_frame_kernel.launches += 1
    new_state = SampleState(ha, hb, sig, exc, de,
                            Kiss99State(*torch.unbind(rng, dim=1)))
    return new_state, pcm


synthesize_frame_kernel.launches = 0
