"""The autoregressive sample loop: one 10 ms frame of 160 dependent steps
per stream, as one CUDA kernel launch, free-running (K1) or under
per-stream, per-sample control masks (K2). K2 is the cluster kernel of
`csrc/masked_loop.cu`, redesigned for Hopper (launch shape and weight
packing in `masked_loop.py`); K1 is that kernel's free-running form (f32 on
clusters of 16 blocks, bf16 and q8 of 8), except f32 at batches that take
more than `F32_CLUSTER_WAVES` waves of clusters, which run the first
design's kernel (`csrc/sample_loop.cu`); K3 is its teacher-forced form; K6
runs K1's kernel on its merged matrices.

Port of `lpcnet_tpu/kernels/sample_loop.py::_ar_kernel`, run free
(masked=False, sampled=True) and masked (masked=True). Each step: LPC
prediction, u-law codes, the three-row embedding gather plus reset-after
GRU-A, GRU-B, the dual-FC node logits, the 8-bit tree descent on KISS99
threshold bytes, de-emphasis, clip and round. The carried state is (h_a,
h_b, last_sig, last_exc, deemph, rng).

* `kernel_weights` builds the kernel's weight bundle (f32/bf16 operands, or
  the q8 form with the per-column-scaled int8 embedding), as the JAX
  package does. Under `LPCNET_EMB=factored` (read at import, `set_emb` at
  run time) a q8 bundle built from fused params that carry the embedding's
  factors also holds the factored operands (`embf_q8`, `embf_w_q8`,
  `embf_scale`): K1, K2 and K3 then gather three rows of the shared
  128-wide int8 embedding and apply GRU-A's input kernel as one more
  exact int8 product, in place of the composed [768, 3Na] table's rows.
* `sample_loop_plain` is the kernel's plain PyTorch version: the same
  numerics, step by step. The CPU tests use it and the chip check holds the
  kernel against it.
* `synthesize_frame_kernel` is the wrapper: on a CPU tensor it runs the
  plain version; on a CUDA tensor it launches the cluster kernel's
  free-running form (f32 by `f32_route`) or raises.
* `sample_loop_masked_plain` / `synthesize_frame_masked_kernel` are the same
  pair for K2; `masked_kernel_weights` adds K2's packed operands to a
  bundle, once, for the callers that launch it many times. An advance mask freezes a stream's whole state (its KISS99
  words included) and emits 0 for the sample; a teacher-force mask takes the
  sample and its excitation from a target in the de-emphasised domain
  (the C preload semantics, src/lpcnet.c:256-259); `sampled=False` skips the
  dual-FC sampler and is legal only when every advanced step is
  teacher-forced. Users: scheduled sampling in training, batched PLC.
* `teacher_force_blocks_plain` / `teacher_force_blocks_kernel` (K3, port of
  `_tf_kernel` / `teacher_force_blocks_pallas`): N conditioning blocks of
  teacher-forced steps with a step count per stream and block, GRU-A and
  GRU-B only. `tf_precompute` gives the closed forms of everything else a
  teacher-forced step would compute (the u-law codes of every step and the
  signal state at the end), so the kernel carries only (h_a, h_b, rng) and
  emits no PCM. On the card it is the teacher-forced form of K2's cluster
  kernel, which takes K2's packs (`masked_kernel_weights`). User: the
  batched PLC's drain of queued audio.
* `merged_kernel_weights` / `sample_loop_merged_plain` /
  `synthesize_frame_merged_kernel` (K6, port of `_sample_kernel_merged` /
  `_synthesize_frame_pallas_merged`): float K1 with each GRU's input and
  recurrent products merged into one product over a `[k_in+k_rec, 4N]`
  matrix, the conditioning remapped to that layout with the recurrent bias
  folded in (`cond4`). A zero block adds nothing to a float32 sum, so K6
  runs K1's kernel (the cluster kernel's free-running form; f32 routed as
  K1's) on the merged matrices' non-zero blocks,
  the padding checked to be zero (`merged_packs`), with the conditioning's
  4N layout converted once a launch into K1's. No path of the package
  selects it: on the card it is K1's kernel after two layout conversions
  and no faster, so every free-running frame runs K1. The tests hold it
  against the JAX package and `chip_smoke.py` times it, by direct calls.
"""

from __future__ import annotations

import ctypes
import os
import warnings

import torch

from ..dsp import mulaw
from ..dsp.constants import LPC_ORDER, PREEMPHASIS
from ..models.lpcnet import (LPCNetConfig, SampleState, draw_threshold_bytes,
                             sampling_logit_table)
from ..nn import quantized as Q
from ..utils.rng import Kiss99State
from . import masked_loop as ML

_FORMS = {torch.float32: 0, torch.bfloat16: 1}
_FORM_Q8 = 2

# the q8 embedding's form: "v1" the composed [768, 3Na] table, "factored"
# the shared [256, 128] embedding and GRU-A's [384, 3Na] input kernel
EMB_MODES = ("v1", "factored")
_EMB = os.environ.get("LPCNET_EMB", "v1")


def set_emb(mode: str) -> str:
    """Select the q8 embedding's form that `kernel_weights` builds ("v1"
    or "factored"); returns the previous one. The default comes from
    LPCNET_EMB at import ("v1" unless set)."""
    global _EMB
    if mode not in EMB_MODES:
        raise ValueError(f"embedding mode {mode!r}: one of {EMB_MODES}")
    prev, _EMB = _EMB, mode
    return prev


def _per_column_q8(x):
    """float [K, N] -> (int8 [K, N], scale [N]): the largest magnitude of a
    column maps to 127, rounding half to even."""
    scale = torch.clamp(x.abs().amax(dim=0), min=1e-10) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def kernel_weights(fused, cfg: LPCNetConfig, dtype=torch.bfloat16,
                   quantized: bool | None = None):
    """The kernel-layout weight bundle from fused params.

    `dtype` is the operand type of the big matrices (embedding table, GRU
    matrices): bfloat16 (default) or float32; sums stay float32.
    `quantized` selects the q8 bundle: the reference's DOT_PROD integer
    numerics for the GRU matrices (round(128*w) weights on floor(0.5+127*h)
    activations, int32 sums, float GRU-A diagonal) and an int8 embedding
    table with per-column scales. It defaults to True when the fused params
    are already int8 (nn.quantized.quantize_fused). Under the factored
    embedding mode (`set_emb`) a q8 bundle whose fused params carry
    `embed_table` and `gru_a_in_kernel` adds the factored operands: the
    embedding e in int8 with per-column scales s_e (`embf_q8`), GRU-A's
    input kernel with s_e folded into its rows, in int8 with per-column
    scales (`embf_w_q8`, `embf_scale`). Without the factors (a DNNw blob)
    the bundle stays composed.
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
        emb_q8, emb_scale = _per_column_q8(emb_cat.to(torch.float32))
        kw.update(emb_q8=emb_q8.contiguous(), emb_scale=emb_scale[None, :],
                  a_rec_q8=a_off_q8.contiguous(),
                  a_diag=f32(a_diag)[None, :],
                  b_in_q8=b_in_q8.contiguous(), b_rec_q8=b_rec_q8.contiguous())
        del kw["b_rec"]
        if _EMB == "factored":
            if "embed_table" in fused:
                kw.update(_factored_operands(fused))
            else:
                warnings.warn("LPCNET_EMB=factored: the fused params carry no "
                              "embedding factors (a DNNw blob); the q8 bundle "
                              "stays composed")
    else:
        kw.update(emb_cat=emb_cat.to(dtype).contiguous(),
                  a_rec=fused["gru_a_rec"]["recurrent"].to(dtype).contiguous(),
                  b_in=fused["gru_b_in"].to(dtype).contiguous())
    return kw


def _factored_operands(fused):
    """The factored embedding's operands, in the JAX package's arithmetic:
    e [256, 128] to int8 with per-column scales s_e; GRU-A's input kernel
    [384, 3Na] times s_e tiled over its three 128-row blocks, to int8 with
    per-column scales t. A step's gate input is then the exact int32
    product of the three gathered int8 rows [B, 384] with that kernel,
    times t."""
    e_q8, s_e = _per_column_q8(fused["embed_table"].to(torch.float32))
    ka = fused["gru_a_in_kernel"].to(torch.float32)
    ka_q8, t = _per_column_q8(ka * s_e.repeat(3)[:, None])
    return {"embf_q8": e_q8.contiguous(), "embf_w_q8": ka_q8.contiguous(),
            "embf_scale": t[None, :].contiguous()}


def is_q8_bundle(kw) -> bool:
    return "emb_q8" in kw


def is_factored(kw) -> bool:
    """Whether K1, K2 and K3 run the bundle's factored embedding."""
    return "embf_q8" in kw


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


def _gru_ab_plain(kw):
    """The kernels' GRU-A and GRU-B step, as a function (h_a, h_b, cond_a,
    cond_b, sig_u, pred_u, exc) -> (new h_a, new h_b) on int64 codes. The
    operands are widened once (exact); a step then gathers three embedding
    rows (factored: three rows of the shared int8 embedding, then their
    exact product with GRU-A's input kernel) and multiplies."""
    q8 = is_q8_bundle(kw)
    fact = is_factored(kw)
    na = kw["a_bias1"].shape[-1] // 3
    nb = kw["b_bias1"].shape[-1] // 3
    if fact:
        emb = kw["embf_q8"]
        emb_w = kw["embf_w_q8"]
    elif q8:
        emb = kw["emb_q8"].to(torch.int32)
    else:
        emb = kw["emb_cat"].to(torch.float32)
        wdt = kw["a_rec"].dtype
        a_rec, b_in, b_rec = (kw[k].to(torch.float32)
                              for k in ("a_rec", "b_in", "b_rec"))

    def step(ha, hb, cond_a, cond_b, sig_u, pred_u, exc):
        if fact:
            # the three gathered int8 rows [B, 384], one exact product
            g = torch.cat([emb[sig_u], emb[pred_u], emb[exc]], dim=1)
            gate_a = cond_a + Q.imatmul(g, emb_w) * kw["embf_scale"]
        else:
            esum = emb[sig_u] + emb[256 + pred_u] + emb[512 + exc]
            gate_a = cond_a + (esum.to(torch.float32) * kw["emb_scale"]
                               if q8 else esum)
        if q8:
            zrec = (_qdot(ha, kw["a_rec_q8"]) + kw["a_diag"]
                    * torch.cat([ha, ha, ha], dim=1) + kw["a_bias1"])
        else:
            zrec = _fdot(ha, a_rec, wdt) + kw["a_bias1"]
        ha_new = _gru(ha, gate_a, zrec, na)
        if q8:
            gate_b = cond_b + _qdot(ha_new, kw["b_in_q8"])
            zrec_b = _qdot(hb, kw["b_rec_q8"]) + kw["b_bias1"]
        else:
            gate_b = cond_b + _fdot(ha_new, b_in, wdt)
            zrec_b = _fdot(hb, b_rec, wdt) + kw["b_bias1"]
        return ha_new, _gru(hb, gate_b, zrec_b, nb)

    return step


def _plain_loop(kw, state: SampleState, cond_a, cond_b, lpc, n_samples,
                preload=None, tf=None, adv=None, sampled=True, gru_ab=None):
    """The kernel's arithmetic, one step at a time; with masks (K2) when
    `preload` [B, n] float, `tf` and `adv` [B, n] bool are given. `gru_ab`
    is the GRU step (`_gru_ab_plain(kw)` unless given)."""
    masked = preload is not None
    table = kw["logit_table"][0]
    ha, hb, sig, exc, de, rng = state
    exc = exc.long()
    gru_ab = gru_ab or _gru_ab_plain(kw)
    out = []
    for t in range(n_samples):
        pred = -(sig * lpc).sum(-1)
        sig_u = mulaw.lin2ulaw(sig[:, 0]).long()
        pred_u = mulaw.lin2ulaw(pred).long()
        ha_new, hb_new = gru_ab(ha, hb, cond_a, cond_b, sig_u, pred_u, exc)

        bytes_, rng_new = draw_threshold_bytes(rng)
        val = torch.zeros_like(exc)
        if sampled:
            pre = hb_new @ kw["dual_w"] + kw["dual_bias"]
            tpre = kw["dual_factor"] * torch.tanh(pre)
            logits = tpre[:, :256] + tpre[:, 256:]              # [B, 256]
            for b in range(8):
                node = logits.gather(1, ((1 << b) | val)[:, None])[:, 0]
                val = (val << 1) | (node - table[bytes_[b]] > 0).long()
        if masked:
            tf_t, adv_t = tf[:, t], adv[:, t]
            pcm_tf = preload[:, t] - PREEMPHASIS * de
            val = torch.where(tf_t, mulaw.lin2ulaw(pcm_tf - pred).long(), val)
            pcm = torch.where(tf_t, pcm_tf, pred + mulaw.ulaw2lin(val))
        else:
            pcm = pred + mulaw.ulaw2lin(val)
        sig_new = torch.cat([pcm[:, None], sig[:, :LPC_ORDER - 1]], dim=1)
        de_new = pcm + PREEMPHASIS * de
        o = torch.floor(0.5 + torch.clamp(de_new, -32767.0, 32767.0))
        if masked:
            a1 = adv_t[:, None]
            ha = torch.where(a1, ha_new, ha)
            hb = torch.where(a1, hb_new, hb)
            sig = torch.where(a1, sig_new, sig)
            exc = torch.where(adv_t, val, exc)
            de = torch.where(adv_t, de_new, de)
            rng = Kiss99State(*(torch.where(adv_t, n, o_)
                                for n, o_ in zip(rng_new, rng)))
            o = torch.where(adv_t, o, torch.zeros_like(o))
        else:
            ha, hb, sig, exc, de, rng = (ha_new, hb_new, sig_new, val, de_new,
                                         rng_new)
        out.append(o)
    new_state = SampleState(ha, hb, sig, exc.to(torch.int32), de, rng)
    return new_state, torch.stack(out, dim=1)


def sample_loop_plain(kw, state: SampleState, cond_a, cond_b, lpc,
                      n_samples: int = 160):
    """K1's plain PyTorch version: the kernel's arithmetic, one step at a
    time, on whatever device the tensors are on.

    Returns (new_state, pcm [B, n_samples] float, rounded, in +-32767).
    """
    return _plain_loop(kw, state, cond_a, cond_b, lpc, n_samples)


def sample_loop_masked_plain(kw, state: SampleState, cond_a, cond_b, lpc,
                             preload, preload_mask, advance_mask,
                             n_samples: int = 160, sampled: bool = True):
    """K2's plain PyTorch version: `sample_loop_plain` under the masks of
    `models.lpcnet.synthesize_frame_masked`, in the kernel's arithmetic.

    preload [B, n] float target (de-emphasised domain), preload_mask and
    advance_mask [B, n] bool. Returns (new_state, pcm [B, n_samples]).
    """
    return _plain_loop(kw, state, cond_a, cond_b, lpc, n_samples,
                       preload=preload.to(torch.float32),
                       tf=preload_mask.bool(), adv=advance_mask.bool(),
                       sampled=sampled)


# --------------------------------------------------------------------------
# CUDA wrapper
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("sample_loop")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lpcnet_sample_loop.argtypes = [ci] * 5 + [vp] * 29
        lib.lpcnet_sample_loop.restype = ci
        _LIB = lib
    return _LIB


_MASKED_LIB = None
_MAX_CLUSTERS: dict = {}


def _masked_lib():
    global _MASKED_LIB
    if _MASKED_LIB is None:
        from ._build import load_library
        lib = load_library("masked_loop")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lpcnet_masked_loop.argtypes = [ci] * 14 + [vp] * 32 + [vp]
        lib.lpcnet_masked_loop.restype = ci
        lib.lpcnet_masked_loop_max_clusters.argtypes = [ci] * 5
        lib.lpcnet_masked_loop_max_clusters.restype = ci
        lib.lpcnet_teacher_force.argtypes = [ci] * 13 + [vp] * 21
        lib.lpcnet_teacher_force.restype = ci
        _MASKED_LIB = lib
    return _MASKED_LIB


# the cluster kernel's kinds (csrc/masked_loop.cu): K2, K1, K3
KIND_MASKED, KIND_FREE, KIND_TF = 0, 1, 2


def _max_clusters(dev, form, na, kind=KIND_MASKED):
    """`max_clusters(nt, smem)` of the cluster kernel's kind `kind` (K2, K1
    or K3) on the card `dev`: how many clusters of that shape the card holds
    at once (the CUDA occupancy query, remembered per card and shape), on
    the form's clusters (`masked_loop.cluster_shape`: 16 blocks in f32)."""
    cluster = ML.cluster_shape(na, form)[0]

    def ask(nt, smem):
        key = (dev.index, form, nt, kind, cluster, smem)
        if key not in _MAX_CLUSTERS:
            with torch.cuda.device(dev):
                got = _masked_lib().lpcnet_masked_loop_max_clusters(
                    form, nt, kind, cluster, smem)
            if got <= 0:
                raise RuntimeError(
                    f"masked sample loop kernel: no cluster of {cluster} blocks with "
                    f"{smem} bytes fits the card (CUDA {-got})")
            _MAX_CLUSTERS[key] = got
        return _MAX_CLUSTERS[key]

    return ask


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _gru_operands(kw, na, nb, dev):
    """The bundle's GRU operands, checked: (form, emb, emb_scale, a_rec,
    a_diag, b_in, b_rec); the scale and the diagonal are None in the float
    forms. What K1, K2 and K3 all read. In the factored q8 form `emb` is the
    shared embedding `embf_q8` [256, 128] and `emb_scale` the input
    kernel's column scales `embf_scale`."""
    f32 = torch.float32
    if is_q8_bundle(kw):
        form, wdt = _FORM_Q8, torch.int8
        emb, a_rec, b_in, b_rec = (kw["emb_q8"], kw["a_rec_q8"],
                                   kw["b_in_q8"], kw["b_rec_q8"])
        emb_scale, a_diag = kw["emb_scale"], kw["a_diag"]
        if is_factored(kw):
            emb, emb_scale = kw["embf_q8"], kw["embf_scale"]
            _check("embf_q8", emb, (256, ML.FACT_K // 3), wdt, dev)
        _check("emb_scale", emb_scale, (1, 3 * na), f32, dev)
        _check("a_diag", a_diag, (1, 3 * na), f32, dev)
    else:
        emb, a_rec, b_in, b_rec = (kw["emb_cat"], kw["a_rec"], kw["b_in"],
                                   kw["b_rec"])
        wdt = emb.dtype
        if wdt not in _FORMS:
            raise TypeError(f"sample loop kernel: operand dtype {wdt}")
        form = _FORMS[wdt]
        emb_scale = a_diag = None
    if not is_factored(kw):
        _check("emb", emb, (768, 3 * na), wdt, dev)
    _check("a_rec", a_rec, (na, 3 * na), wdt, dev)
    _check("b_in", b_in, (na, 3 * nb), wdt, dev)
    _check("b_rec", b_rec, (nb, 3 * nb), wdt, dev)
    _check("a_bias1", kw["a_bias1"], (1, 3 * na), f32, dev)
    _check("b_bias1", kw["b_bias1"], (1, 3 * nb), f32, dev)
    return form, emb, emb_scale, a_rec, a_diag, b_in, b_rec


def _cluster_operands(kw, form, a_rec, na, nb, dev):
    """The cluster kernel's GRU operands (a_w, b_w, f_w), checked: K2's
    pack of GRU-A's slices, of GRU-B's weights (None in f32, whose GRU-B
    reads b_in and b_rec as they are), and f_w the factored embedding's
    packed input kernel, else None."""
    a_w, b_w = kw["k2_a"], kw["k2_b"]
    shape_a, shape_b = ML.packed_shapes(form, na, nb)
    _check("k2_a", a_w, shape_a, a_rec.dtype, dev)
    if form == 0:
        return a_w, None, None
    _check("k2_b", b_w, shape_b, a_rec.dtype, dev)
    f_w = None
    if is_factored(kw):
        f_w = kw["k2_f"]
        c, u = ML.cluster_shape(na, form)
        _check("k2_f", f_w, (c, 3 * u // 16, ML.FACT_K // 32, 32, 16), torch.int8, dev)
    return a_w, b_w, f_w


# f32 K1 (and K6) run the cluster kernel while its launch takes at most
# this many waves of clusters, the first design (csrc/sample_loop.cu, a
# block of 4 streams, every block resident at once) above: on an H100 (7
# clusters of 16 blocks) a wave takes about 4 ms a frame at S = 40, and
# the first design 9-11 ms at any batch up to 1024, so two waves stay
# below it and four do not (chip_smoke.py's f32 sweep, PERF.md)
F32_CLUSTER_WAVES = 2


def f32_route(batch: int, na: int, nb: int, max_clusters) -> str:
    """The kernel of f32 K1 at `batch` streams: "cluster" (the cluster
    kernel's free-running form) while its launch shape
    (`masked_loop.free_launch_config`, `max_clusters(nt, smem)` as there)
    takes at most `F32_CLUSTER_WAVES` waves, else "first" (the first
    design). On an H100 the cluster kernel serves up to 560 streams."""
    cfg = ML.free_launch_config(batch, na, nb, ML.FORMS["f32"], max_clusters)
    return "cluster" if cfg["waves"] <= F32_CLUSTER_WAVES else "first"


def _launch(kw, state: SampleState, cond_a, cond_b, lpc, n_samples,
            masked=None, route=None):
    """Check the operands, allocate the outputs and launch on the current
    stream: `masked` None the free-running loop (K1, K6), (preload, mode,
    sampled) the masked one (K2), both on the cluster kernel with `kw`
    carrying K2's packs, except an f32 free-running launch whose `route`
    (default `f32_route`) is "first": the first design's kernel."""
    dev = cond_a.device
    b = cond_a.shape[0]
    na = kw["a_bias1"].shape[-1] // 3
    nb = kw["b_bias1"].shape[-1] // 3
    f32 = torch.float32
    form, emb, emb_scale, a_rec, a_diag, b_in, b_rec = _gru_operands(
        kw, na, nb, dev)
    weights = (emb, emb_scale, a_rec, a_diag, kw["a_bias1"], b_in, b_rec,
               kw["b_bias1"])
    for name, shape in (("dual_w", (nb, 512)), ("dual_bias", (1, 512)),
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
    if masked is not None:
        preload, mode, sampled = masked
        _check("preload", preload, (b, n_samples), f32, dev)
        _check("mode", mode, (b, n_samples), torch.int32, dev)

    ha, hb, sig, de = (torch.empty_like(x) for x in (ha_in, hb_in, sig_in,
                                                     de_in))
    exc = torch.empty_like(exc_in)
    rng = torch.empty_like(rng_in)
    pcm = torch.empty((b, n_samples), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    tail = tuple(ptr(t) for t in (
        kw["dual_w"], kw["dual_bias"], kw["dual_factor"], kw["logit_table"],
        cond_a, cond_b, lpc, ha_in, hb_in, sig_in, exc_in, de_in, rng_in,
        ha, hb, sig, exc, de, rng, pcm))
    emb, emb_scale, a_rec, a_diag, a_bias1, b_in, b_rec, b_bias1 = weights
    fact = is_factored(kw)
    free = masked is None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if free and form == 0 and route is None:
            route = f32_route(b, na, nb, _max_clusters(dev, form, na, KIND_FREE))
        if free and form == 0 and route == "first":
            err = _lib().lpcnet_sample_loop(form, b, na, nb, n_samples,
                                            *(ptr(t) for t in weights), *tail, stream)
        else:
            if free:
                preload, mode, sampled = None, None, True
                cfg = ML.free_launch_config(b, na, nb, form,
                                            _max_clusters(dev, form, na, KIND_FREE), fact)
            else:
                cfg = ML.masked_launch_config(b, na, nb, form,
                                              _max_clusters(dev, form, na), fact)
            a_w, b_w, f_w = _cluster_operands(kw, form, a_rec, na, nb, dev)
            err = _masked_lib().lpcnet_masked_loop(
                form, cfg["nt"], int(free), cfg["cluster"], cfg["smem"], int(cfg["res_a"]),
                int(cfg["res_b"]), int(fact), int(cfg["res_f"]), b, na, nb, n_samples,
                int(bool(sampled)), *(ptr(t) for t in (
                    emb, emb_scale, a_w, a_diag, a_bias1, b_w, b_in, b_rec, b_bias1, f_w)),
                *tail, ptr(preload), ptr(mode), stream)
    if err != 0:
        raise RuntimeError(f"sample loop kernel launch failed: CUDA error {err}")
    new_state = SampleState(ha, hb, sig, exc, de,
                            Kiss99State(*torch.unbind(rng, dim=1)))
    return new_state, pcm


def synthesize_frame_kernel(kw, state: SampleState, cond_a, cond_b, lpc,
                            n_samples: int = 160):
    """One frame of the sample loop: (new_state, pcm [B, n_samples]).

    On a CPU tensor this runs `sample_loop_plain`. On a CUDA tensor it
    launches the CUDA kernel (built on first use) and counts the launch in
    `synthesize_frame_kernel.launches`; any other device raises. The kernel
    is chosen by the bundle's form and the batch, never by a failure: K2's
    cluster kernel in its free-running form (f32 on clusters of 16 blocks,
    bf16 and q8 of 8), on the packs of `masked_kernel_weights`, built here
    for this call when `kw` lacks them (callers that launch it every frame
    build them once); in f32 above `F32_CLUSTER_WAVES` waves of clusters
    (`f32_route`; on an H100 above 560 streams) the first design's kernel
    (`csrc/sample_loop.cu`), which is the faster there. Any batch size
    works: the kernels mask the ragged last cluster or block of streams. A
    refused launch raises.
    """
    dev = cond_a.device
    if dev.type == "cpu":
        return sample_loop_plain(kw, state, cond_a, cond_b, lpc, n_samples)
    if dev.type != "cuda":
        raise ValueError(f"sample loop kernel: unsupported device {dev}")
    if "k2_a" not in kw:
        kw = masked_kernel_weights(kw)
    out = _launch(kw, state, cond_a, cond_b, lpc, n_samples)
    synthesize_frame_kernel.launches += 1
    return out


synthesize_frame_kernel.launches = 0


def masked_kernel_weights(kw):
    """K2's bundle: `kw` (`kernel_weights`) with GRU-A's slices packed per
    rank (`masked_loop.pack_gru_a` as `k2_a`: the tensor cores' fragment
    order in bf16 and q8, [k quad][3U][4] in f32) and GRU-B's matrices
    packed in fragment order (`pack_gru_b` as `k2_b`; None in f32, whose
    GRU-B reads them as they are), and in the factored q8 form the input
    kernel `embf_w_q8` packed as `k2_f` (`masked_loop.pack_embf`). Every
    other kernel and plain version takes it as it takes `kw`. Build it once
    per weight bundle: the trainer once per step, the PLC pool, the decoder
    and the validator once."""
    if is_q8_bundle(kw):
        a_rec, b_in, b_rec = kw["a_rec_q8"], kw["b_in_q8"], kw["b_rec_q8"]
    elif kw["a_rec"].dtype == torch.float32:
        return dict(kw, k2_a=ML.pack_gru_a(kw["a_rec"]), k2_b=None)
    else:
        a_rec, b_in, b_rec = kw["a_rec"], kw["b_in"], kw["b_rec"]
    packs = dict(k2_a=ML.pack_gru_a(a_rec), k2_b=ML.pack_gru_b(b_in, b_rec))
    if is_factored(kw):
        packs["k2_f"] = ML.pack_embf(kw["embf_w_q8"])
    return dict(kw, **packs)


def synthesize_frame_masked_kernel(kw, state: SampleState, cond_a, cond_b,
                                   lpc, preload, preload_mask, advance_mask,
                                   n_samples: int = 160, sampled: bool = True):
    """One masked frame (K2): (new_state, pcm [B, n_samples]).

    preload [B, n] float target in the de-emphasised domain; preload_mask
    and advance_mask [B, n] bool (see `sample_loop_masked_plain`). `kw` is
    `masked_kernel_weights(...)`, or a `kernel_weights` bundle whose packed
    operands are then built for this call. On a CPU tensor this runs the
    plain version; on a CUDA tensor it launches the masked kernel and counts
    the launch in `synthesize_frame_masked_kernel.launches`; any other
    device raises. Any batch size and any GRU widths work, with no padding
    of streams.
    """
    dev = cond_a.device
    if dev.type == "cpu":
        return sample_loop_masked_plain(kw, state, cond_a, cond_b, lpc,
                                        preload, preload_mask, advance_mask,
                                        n_samples, sampled)
    if dev.type != "cuda":
        raise ValueError(f"sample loop kernel: unsupported device {dev}")
    if "k2_a" not in kw:
        kw = masked_kernel_weights(kw)
    mode = (advance_mask.to(torch.int32)
            | (preload_mask.to(torch.int32) << 1)).contiguous()
    preload = preload.to(torch.float32).contiguous()
    out = _launch(kw, state, cond_a, cond_b, lpc, n_samples,
                  masked=(preload, mode, sampled))
    synthesize_frame_masked_kernel.launches += 1
    return out


synthesize_frame_masked_kernel.launches = 0


# --------------------------------------------------------------------------
# K3: the teacher-forced run (GRU-A and GRU-B only)
# --------------------------------------------------------------------------

def tf_precompute(state: SampleState, lpc, targets, count):
    """The closed forms of a teacher-forced segment of n steps.

    In such a segment everything but the GRU states and the RNG follows
    from the target audio: pcm_t = target_t - 0.85 de_{t-1} with de_t set to
    target_t (the step-by-step form recomputes de_t as pcm_t + 0.85 de_{t-1},
    one rounding more), the signal history is a sliding window over
    [carried last_sig | pcm], the prediction a 16-tap FIR of that window.

    targets [B, n] (de-emphasised domain), count [B] steps each stream runs.
    Returns (sig_u, pred_u, exc_in [B, n] int32 u-law codes that step t
    feeds to GRU-A; new_last_sig, new_last_exc, new_deemph after count
    steps, the old values where count is 0)."""
    targets = targets.to(torch.float32)
    b, n = targets.shape
    count = count.long()
    de_prev = torch.cat([state.deemph[:, None], targets[:, :-1]], dim=1)
    pcm = targets - PREEMPHASIS * de_prev
    ext = torch.cat([torch.flip(state.last_sig, (1,)), pcm], dim=1)  # [B,16+n]
    acc = torch.zeros_like(pcm)
    for k in range(LPC_ORDER):
        acc = acc + lpc[:, k:k + 1] * ext[:, LPC_ORDER - 1 - k:
                                          LPC_ORDER - 1 - k + n]
    pred = -acc
    sig_u = mulaw.lin2ulaw(ext[:, LPC_ORDER - 1:LPC_ORDER - 1 + n])
    pred_u = mulaw.lin2ulaw(pred)
    exc_tf = mulaw.lin2ulaw(pcm - pred)
    exc_in = torch.cat([state.last_exc[:, None].to(torch.int32),
                        exc_tf[:, :-1]], dim=1)

    adv_any = count > 0
    last = torch.clamp(count - 1, min=0)[:, None]
    # the history after the last step: ext[last + 16 - j], newest first
    win = ext.gather(1, last + LPC_ORDER
                     - torch.arange(LPC_ORDER, device=ext.device)[None, :])
    new_sig = torch.where(adv_any[:, None], win, state.last_sig)
    new_exc = torch.where(adv_any, exc_tf.gather(1, last)[:, 0],
                          state.last_exc.to(torch.int32))
    new_de = torch.where(adv_any, targets.gather(1, last)[:, 0], state.deemph)
    return sig_u, pred_u, exc_in, new_sig, new_exc, new_de


def _tf_chain(state: SampleState, lpc_blocks, targets, counts, blk_samples):
    """`tf_precompute` block after block, the signal state carried from one
    to the next. Returns (codes [B, N*blk, 3] int32, the SampleState with the
    final last_sig, last_exc and deemph)."""
    codes = []
    sig_state = state
    for k in range(counts.shape[1]):
        s_u, p_u, e_in, n_sig, n_exc, n_de = tf_precompute(
            sig_state, lpc_blocks[:, k],
            targets[:, k * blk_samples:(k + 1) * blk_samples], counts[:, k])
        codes.append(torch.stack([s_u, p_u, e_in], dim=-1))
        sig_state = sig_state._replace(last_sig=n_sig, last_exc=n_exc,
                                       deemph=n_de)
    return torch.cat(codes, dim=1), sig_state


def teacher_force_blocks_plain(kw, state: SampleState, cond_a_blocks,
                               cond_b_blocks, lpc_blocks, targets, counts,
                               blk_samples: int) -> SampleState:
    """K3's plain PyTorch version: the kernel's arithmetic, one step at a
    time, on whatever device the tensors are on.

    cond_a_blocks [B, N, 3Na], cond_b_blocks [B, N, 3Nb], lpc_blocks
    [B, N, 16], targets [B, N*blk_samples], counts [B, N] int: stream i runs
    the first counts[i, k] steps of block k on that block's conditioning. A
    step past the count leaves the stream's state and RNG as they are."""
    counts = counts.to(torch.int32)
    codes, sig_state = _tf_chain(state, lpc_blocks, targets, counts,
                                 blk_samples)
    codes = codes.long()
    gru_ab = _gru_ab_plain(kw)
    ha, hb, rng = state.gru_a, state.gru_b, state.rng
    for k in range(counts.shape[1]):
        ca, cb = cond_a_blocks[:, k], cond_b_blocks[:, k]
        for t in range(int(counts[:, k].max()) if counts.numel() else 0):
            adv = t < counts[:, k]
            c = codes[:, k * blk_samples + t]
            ha_new, hb_new = gru_ab(ha, hb, ca, cb, c[:, 0], c[:, 1], c[:, 2])
            _, rng_new = draw_threshold_bytes(rng)
            ha = torch.where(adv[:, None], ha_new, ha)
            hb = torch.where(adv[:, None], hb_new, hb)
            rng = Kiss99State(*(torch.where(adv, n, o)
                                for n, o in zip(rng_new, rng)))
    return sig_state._replace(gru_a=ha, gru_b=hb, rng=rng)


def teacher_force_blocks_kernel(kw, state: SampleState, cond_a_blocks,
                                cond_b_blocks, lpc_blocks, targets, counts,
                                blk_samples: int) -> SampleState:
    """N conditioning blocks of teacher-forced steps in one launch (K3); see
    `teacher_force_blocks_plain` for the arguments. The closed forms
    (`tf_precompute`) run in PyTorch before the launch (`tf_codes`).

    On a CPU tensor this runs the plain version. On a CUDA tensor it
    launches the teacher-forced form of K2's cluster kernel (`tf_launch`,
    which counts the launch in `teacher_force_blocks_kernel.launches`); any
    other device raises. There `kw` must be `masked_kernel_weights(...)`: a
    bundle without K2's packs raises (build them once per weight bundle, as
    the PLC pool does). Any batch size works, with no padding of streams."""
    dev = cond_a_blocks.device
    if dev.type == "cpu":
        return teacher_force_blocks_plain(kw, state, cond_a_blocks,
                                          cond_b_blocks, lpc_blocks, targets,
                                          counts, blk_samples)
    if dev.type != "cuda":
        raise ValueError(f"teacher-force kernel: unsupported device {dev}")
    if "k2_a" not in kw:
        raise ValueError("teacher-force kernel: the bundle has no packed "
                         "operands; pass masked_kernel_weights(kw)")
    codes, sig_state = tf_codes(state, lpc_blocks, targets, counts, blk_samples)
    ha, hb, rng = tf_launch(kw, state, cond_a_blocks, cond_b_blocks, counts,
                            codes, blk_samples)
    return sig_state._replace(gru_a=ha, gru_b=hb,
                              rng=Kiss99State(*torch.unbind(rng, dim=1)))


def tf_codes(state: SampleState, lpc_blocks, targets, counts, blk_samples: int):
    """K3's inputs from the closed forms (`_tf_chain`): (codes
    [B, N * blk_samples, 3] uint8, the SampleState with the final signal
    state)."""
    codes, sig_state = _tf_chain(state, lpc_blocks, targets,
                                 counts.to(torch.int32), blk_samples)
    return codes.to(torch.uint8).contiguous(), sig_state


def tf_launch(kw, state: SampleState, cond_a_blocks, cond_b_blocks, counts,
              codes, blk_samples: int):
    """One launch of K3 on the card on `tf_codes`' codes: (h_a, h_b, KISS99
    words [B, 4] int64) after the run. `kw` carries K2's packs. Counts the
    launch in `teacher_force_blocks_kernel.launches`."""
    dev = cond_a_blocks.device
    b, n_blocks = counts.shape
    na = kw["a_bias1"].shape[-1] // 3
    nb = kw["b_bias1"].shape[-1] // 3
    f32 = torch.float32
    counts = counts.to(torch.int32).contiguous()
    form, emb, emb_scale, a_rec, a_diag, b_in, b_rec = _gru_operands(
        kw, na, nb, dev)
    a_w, b_w, f_w = _cluster_operands(kw, form, a_rec, na, nb, dev)
    fact = is_factored(kw)
    ca = cond_a_blocks.contiguous()
    cb = cond_b_blocks.contiguous()
    _check("cond_a_blocks", ca, (b, n_blocks, 3 * na), f32, dev)
    _check("cond_b_blocks", cb, (b, n_blocks, 3 * nb), f32, dev)
    _check("counts", counts, (b, n_blocks), torch.int32, dev)
    _check("codes", codes, (b, n_blocks * blk_samples, 3), torch.uint8, dev)
    ha_in, hb_in = state.gru_a.contiguous(), state.gru_b.contiguous()
    rng_in = torch.stack(tuple(state.rng), dim=1).contiguous()
    _check("gru_a", ha_in, (b, na), f32, dev)
    _check("gru_b", hb_in, (b, nb), f32, dev)
    _check("rng", rng_in, (b, 4), torch.int64, dev)
    ha, hb, rng = (torch.empty_like(x) for x in (ha_in, hb_in, rng_in))
    cfg = ML.tf_launch_config(b, na, nb, form, n_blocks,
                              _max_clusters(dev, form, na, KIND_TF), fact)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = _masked_lib().lpcnet_teacher_force(
            form, cfg["nt"], cfg["cluster"], cfg["smem"], int(cfg["res_a"]),
            int(cfg["res_b"]), int(fact), int(cfg["res_f"]), b, na, nb, n_blocks,
            blk_samples,
            *(ptr(t) for t in (emb, emb_scale, a_w, a_diag, kw["a_bias1"], b_w,
                               b_in, b_rec, kw["b_bias1"], f_w, ca, cb, counts, codes,
                               ha_in, hb_in, rng_in, ha, hb, rng)),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"teacher-force kernel launch failed: CUDA error {err}")
    teacher_force_blocks_kernel.launches += 1
    return ha, hb, rng


teacher_force_blocks_kernel.launches = 0


def teacher_force_prefix_kernel(kw, state: SampleState, cond_a, cond_b, lpc,
                                targets, count) -> SampleState:
    """`count[i]` teacher-forced steps of stream i on one conditioning
    (count 0 freezes it): `teacher_force_blocks_kernel` with a single block.
    It gives what `synthesize_frame_masked_kernel(sampled=False)` gives under
    a prefix advance mask, less the PCM and one rounding in the de-emphasis
    carry."""
    return teacher_force_blocks_kernel(
        kw, state, cond_a[:, None], cond_b[:, None], lpc[:, None], targets,
        count[:, None], targets.shape[-1])


# --------------------------------------------------------------------------
# K6: the merged-product form of K1 (no path of the package selects it)
# --------------------------------------------------------------------------

def _merge(w_in, w_rec, n):
    """[k_in+k_rec, 4n]: columns [z | r | h input side | h recurrent side],
    each operand's rows zero in the column block it does not feed."""
    z = lambda r: w_in.new_zeros((r, n))
    top = torch.cat([w_in[:, :2 * n], w_in[:, 2 * n:], z(w_in.shape[0])], 1)
    bot = torch.cat([w_rec[:, :2 * n], z(w_rec.shape[0]), w_rec[:, 2 * n:]], 1)
    return torch.cat([top, bot], 0).contiguous()


def merged_kernel_weights(kw):
    """K6's operands from a float K1 bundle (`kernel_weights`), as the JAX
    package's `_merged_weights`: `a_merged` [768+Na, 4Na] (embedding rows,
    then GRU-A's recurrent rows), `b_merged` [Na+Nb, 4Nb] (GRU-B's input
    rows, then its recurrent rows), in the bundle's operand type; the biases
    (for `cond4`) and the sampler's tensors are shared with `kw`; and the
    kernel's launch operands built from the merged matrices
    (`merged_packs`). Built only by K6's own callers (its tests and
    timings), so K1's bundle stays as it is."""
    if is_q8_bundle(kw):
        raise TypeError("K6 takes float bundles only (f32 or bf16 operands)")
    na = kw["a_bias1"].shape[-1] // 3
    nb = kw["b_bias1"].shape[-1] // 3
    mw = {k: kw[k] for k in ("a_bias1", "b_bias1", "dual_w", "dual_bias",
                             "dual_factor", "logit_table")}
    mw["a_merged"] = _merge(kw["emb_cat"], kw["a_rec"], na)
    mw["b_merged"] = _merge(kw["b_in"], kw["b_rec"], nb)
    return merged_packs(mw)


def _unmerge(m, k_in, n, name):
    """`_merge`'s inverse: [k_in+k_rec, 4n] -> (w_in [k_in, 3n],
    w_rec [k_rec, 3n]), contiguous, each the [z | r | h] column blocks its
    rows feed. The two blocks `_merge` pads (the input rows' h-recurrent
    block, the recurrent rows' h-input block) are checked, not assumed: a
    non-zero entry there raises ValueError, so a product over the blocks
    returned is the product over the whole merged matrix."""
    top, bot = m[:k_in], m[k_in:]
    for block, what in ((top[:, 3 * n:], "input rows' h-recurrent"),
                        (bot[:, 2 * n:3 * n], "recurrent rows' h-input")):
        if bool(block.any()):
            raise ValueError(f"{name}: the {what} block of the merged layout "
                             f"is not zero")
    return (top[:, :3 * n].contiguous(),
            torch.cat([bot[:, :2 * n], bot[:, 3 * n:]], dim=1).contiguous())


def _h_bias(bias1):
    """[1, 3N] recurrent bias -> [0 | 0 | bias_h]: what is left to add to
    the recurrent sums once `cond4` has folded bias_z and bias_r into the
    conditioning."""
    n = bias1.shape[-1] // 3
    return torch.cat([torch.zeros_like(bias1[..., :2 * n]), bias1[..., 2 * n:]],
                     dim=-1).contiguous()


def merged_packs(mw):
    """`mw` with K6's launch operands under "k6", built from its own merged
    matrices once per operand set (the decoder keeps them with `mw`): a
    bundle in K1's layout whose `emb_cat`, `a_rec`, `b_in` and `b_rec` are
    the non-zero blocks of `a_merged` and `b_merged` (`_unmerge`: the
    padding blocks checked to be zero), whose recurrent biases are
    `_h_bias`'s and whose sampler tensors are `mw`'s, with K2's packs
    (`masked_kernel_weights`). K6 runs K1's kernel on it."""
    a_m, b_m = mw["a_merged"], mw["b_merged"]
    na, nb = a_m.shape[1] // 4, b_m.shape[1] // 4
    emb, a_rec = _unmerge(a_m, 768, na, "a_merged")
    b_in, b_rec = _unmerge(b_m, na, nb, "b_merged")
    k6 = {k: mw[k] for k in ("dual_w", "dual_bias", "dual_factor", "logit_table")}
    k6.update(emb_cat=emb, a_rec=a_rec, b_in=b_in, b_rec=b_rec,
              a_bias1=_h_bias(mw["a_bias1"]), b_bias1=_h_bias(mw["b_bias1"]))
    return dict(mw, k6=masked_kernel_weights(k6))


def cond4(cond, bias1):
    """Per-frame conditioning [..., 3N] in the merged 4N column layout with
    the recurrent bias folded in: [cond_zr + bias_zr | cond_h | bias_h]
    (the JAX package's `_cond4`)."""
    n = cond.shape[-1] // 3
    z = cond.new_zeros(cond.shape[:-1] + (n,))
    c4 = torch.cat([cond[..., :2 * n], cond[..., 2 * n:], z], dim=-1)
    b4 = torch.cat([bias1[..., :2 * n], torch.zeros_like(bias1[..., :n]),
                    bias1[..., 2 * n:]], dim=-1)
    return c4 + b4


def _gru4(h0, m, n):
    z = _sigmoid(m[:, :n])
    r = _sigmoid(m[:, n:2 * n])
    hc = torch.tanh(m[:, 2 * n:3 * n] + r * m[:, 3 * n:])
    return z * h0 + (1.0 - z) * hc


def _gru_ab_merged_plain(mw):
    """K6's GRU-A and GRU-B step, in the signature of `_gru_ab_plain`'s: the
    merged products m = x @ merged + cond4 (the three one-hot rows as a
    gather), then the reset-after update on m's four column blocks."""
    a_m = mw["a_merged"]
    wdt = a_m.dtype
    na = a_m.shape[1] // 4
    emb = a_m[:768].to(torch.float32)
    a_rec = a_m[768:].to(torch.float32)
    b_m = mw["b_merged"].to(torch.float32)
    nb = b_m.shape[1] // 4
    a_b4 = mw["a_bias1"]
    b_b4 = mw["b_bias1"]

    def step(ha, hb, cond_a, cond_b, sig_u, pred_u, exc):
        ma = (emb[sig_u] + emb[256 + pred_u] + emb[512 + exc]
              + _fdot(ha, a_rec, wdt) + cond4(cond_a, a_b4))
        ha_new = _gru4(ha, ma, na)
        xb = torch.cat([ha_new, hb], dim=1)
        mb = _fdot(xb, b_m, wdt) + cond4(cond_b, b_b4)
        return ha_new, _gru4(hb, mb, nb)

    return step


def sample_loop_merged_plain(mw, state: SampleState, cond_a, cond_b, lpc,
                             n_samples: int = 160):
    """K6's plain PyTorch version: K1's step with the merged GRU products,
    one step at a time, on whatever device the tensors are on. `mw` is
    `merged_kernel_weights(kw)`; cond_a [B, 3Na], cond_b [B, 3Nb] in K1's
    layout. Returns (new_state, pcm [B, n_samples])."""
    return _plain_loop(mw, state, cond_a, cond_b, lpc, n_samples,
                       gru_ab=_gru_ab_merged_plain(mw))


def merged_as_k1(mw, cond_a, cond_b):
    """K6's launch in K1's terms: (the K1-layout bundle of `merged_packs`,
    built here when `mw` lacks it, and cond_a, cond_b [B, 3N] converted
    through the merged 4N layout (`cond4`) into K1's: its first 3N columns,
    [cond_zr + bias_zr | cond_h], the last block (bias_h) being the
    bundle's recurrent bias)."""
    if "k6" not in mw:
        mw = merged_packs(mw)
    na, nb = (mw[k].shape[-1] // 3 for k in ("a_bias1", "b_bias1"))
    ca = cond4(cond_a, mw["a_bias1"][0])[:, :3 * na].contiguous()
    cb = cond4(cond_b, mw["b_bias1"][0])[:, :3 * nb].contiguous()
    return mw["k6"], ca, cb


def synthesize_frame_merged_kernel(mw, state: SampleState, cond_a, cond_b,
                                   lpc, n_samples: int = 160):
    """One frame of K6: (new_state, pcm [B, n_samples]); `mw` is
    `merged_kernel_weights(kw)`, cond_a and cond_b in K1's 3N layout.

    On a CPU tensor this runs `sample_loop_merged_plain`. On a CUDA tensor
    it launches K1's kernel (K2's cluster kernel in its free-running form,
    f32 on clusters of 16 blocks or, by `f32_route`, the first design) on
    the
    operands `merged_packs` built from `a_merged` and `b_merged` (here, for
    this call, when `mw` lacks them), and counts the launch in
    `synthesize_frame_merged_kernel.launches`; any other device raises. The
    conditioning is formed in the 4N layout and converted once a launch
    into K1's (`merged_as_k1`). Any batch size works, with no padding of
    streams."""
    dev = cond_a.device
    if dev.type == "cpu":
        return sample_loop_merged_plain(mw, state, cond_a, cond_b, lpc,
                                        n_samples)
    if dev.type != "cuda":
        raise ValueError(f"sample loop kernel: unsupported device {dev}")
    dt = mw["a_merged"].dtype
    if dt not in _FORMS:
        raise TypeError(f"merged sample loop kernel: operand dtype {dt}")
    kw6, ca, cb = merged_as_k1(mw, cond_a, cond_b)
    out = _launch(kw6, state, ca, cb, lpc, n_samples)
    synthesize_frame_merged_kernel.launches += 1
    return out


synthesize_frame_merged_kernel.launches = 0
