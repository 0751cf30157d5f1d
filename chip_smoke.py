"""GPU smoke check of lpcnet_torch: builds every kernel, holds each against its
plain PyTorch version on the card, drives vocoder synthesis and vocoder
training end to end through the public entry points, and times them.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases:
  1. build every kernel from lpcnet_torch/kernels/csrc (one nvcc per source,
     all at once);
  2. the sample-loop kernel (K1) vs its plain version on the shipped demo
     vocoder at 256 streams, 32 steps, in the f32, bf16 and q8 forms;
  3. the synthesis path: api.Synthesizer on the demo vocoder at 1024 streams
     for 20 frames (50 before the training phases were added, to keep the
     run about as long), float (bf16 kernel bundle) and int8 (q8); K1's
     launch count must equal the frame count;
  4. K1 vs its plain version again at that path's shapes (1024 streams,
     160 steps, from the state the path left), then timings: K1 per launch
     (CUDA events) vs its plain version and its bound;
  5. the GRU training kernel (K5, forward and backward) vs its plain version
     at 384 and 16 units, B=128, at T=320 and at the training path's T=2400;
  6. the masked sample-loop kernel (K2) vs its plain version at 256
     streams, 32 steps and one full frame, f32, bf16 and q8, with and
     without the sampler, and again at the training path's shapes (128
     streams, one frame, the bf16 bundle, every stream advancing);
  7. the training path: a corpus written from a seed, then
     train_lpcnet.Trainer at LPCNetConfig() / TrainConfig() (batch 128,
     2400-sample chunks) takes 6 steps through LPCNetLoader, a second
     trainer with ss_prob=0.25 takes 3 through DeviceLPCNetLoader; launch
     counts of K5 and K2, falling loss, constraints and a checkpoint round
     trip are asserted; one more step runs under torch.profiler for the
     device's busy share;
  8. timings of K5 and K2 at the training path's shapes vs their plain
     versions, their bounds and, for K5, torch.nn.GRU (cuDNN) as a
     yardstick.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lpcnet_torch import api
from lpcnet_torch.dsp.constants import NB_TOTAL_FEATURES
from lpcnet_torch.kernels import _build
from lpcnet_torch.kernels import gru_train as G
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn.quantized import quantize_fused
from lpcnet_torch.train import checkpointing
from lpcnet_torch.train import train_lpcnet as T
from lpcnet_torch.train.data import DeviceLPCNetLoader, LPCNetLoader

SEED = 0
KERNEL_SOURCES = ["sample_loop", "gru_train"]
# H100 SXM data-sheet peaks (dense): bytes/s and operations/s by type
HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
MAIN_BATCH = 1024
MAIN_FRAMES = 20
TRAIN_BATCH = 128
TRAIN_STEPS = 6
SS_STEPS = 3
CHECK_BATCH = 256
CHECK_STEPS = 32


def log(msg):
    print(msg, flush=True)


def features(batch, frames, seed):
    """Speech-like feature rows: cepstrum ~ N(0, 0.3), pitch period and
    correlation in their feature ranges."""
    rs = np.random.RandomState(seed)
    f = (rs.normal(size=(frames, batch, NB_TOTAL_FEATURES)) * 0.3
         ).astype(np.float32)
    f[..., 18] = rs.uniform(-0.5, 0.5, (frames, batch))
    f[..., 19] = rs.uniform(0.0, 0.5, (frames, batch))
    return f


def conditioning(fused, cfg, batch, dev):
    """Frame-net outputs after the lookahead has filled (3 frames)."""
    feats = torch.from_numpy(features(batch, 3, SEED + 1)).to(dev)
    fs = M.init_frame_state(batch, cfg, dev)
    for k in range(3):
        fs, _, ca, cb, lpc = M.frame_network(fused, fs, feats[k], cfg)
    return ca.contiguous(), cb.contiguous(), lpc.contiguous()


def time_cuda(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound_ms(kw, cfg, batch, n, masked=False):
    """Least time for one launch: the larger of the bytes it must move over
    HBM bandwidth and its multiply-adds over the peak rate of their type.
    `masked` adds K2's preload and mode words."""
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    gru_macs = na * 3 * na + na * 3 * nb + nb * 3 * nb
    dual_macs = nb * 512
    steps = batch * n
    gru_type = ("int8" if K.is_q8_bundle(kw) else
                "bf16" if kw["emb_cat"].dtype == torch.bfloat16 else "f32")
    op_s = (2 * gru_macs * steps / PEAK[gru_type]
            + 2 * dual_macs * steps / PEAK["f32"])
    weight_bytes = sum(v.numel() * v.element_size() for v in kw.values())
    per_stream = 4 * (3 * na + 3 * nb + 16          # cond_a, cond_b, lpc
                      + 2 * (na + nb + 16 + 1 + 1)  # state in and out
                      + n) + 2 * (4 * 8 + 4)        # rng, exc in/out
    if masked:
        per_stream += 8 * n
    byte_s = (weight_bytes + batch * per_stream) / HBM_BPS
    return 1e3 * max(op_s, byte_s), ("operations" if op_s >= byte_s else "bytes")


def check_k1(fused, cfg, dev):
    """K1 vs its plain version, same inputs, each form at its bar."""
    ca, cb, lpc = conditioning(fused, cfg, CHECK_BATCH, dev)
    s0 = M.init_sample_state(CHECK_BATCH, cfg, dev)
    bundles = {
        "f32": K.kernel_weights(fused, cfg, dtype=torch.float32),
        "bf16": K.kernel_weights(fused, cfg, dtype=torch.bfloat16),
        "q8": K.kernel_weights(quantize_fused(fused), cfg),
    }
    res = {}
    for form, kw in bundles.items():
        # one step: the new GRU states do not depend on the sampler yet, so
        # their difference is the arithmetic's alone (tolerance 1e-4; GRU-B
        # in bf16 1e-2, see check_k1_main_shape)
        s1k, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
        s1p, _ = K.sample_loop_plain(kw, s0, ca, cb, lpc, 1)
        err_a = float((s1k.gru_a - s1p.gru_a).abs().max())
        err_b = float((s1k.gru_b - s1p.gru_b).abs().max())
        step_err = max(err_a, err_b)
        assert err_a <= 1e-4, (form, err_a)
        assert err_b <= (1e-2 if form == "bf16" else 1e-4), (form, err_b)
        sk, pk = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, CHECK_STEPS)
        torch.cuda.synchronize()
        sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, CHECK_STEPS)
        same = float((pk == pp).float().mean())
        rng_eq = all(bool(torch.equal(a, b)) for a, b in zip(sk.rng, sp.rng))
        err = float((sk.gru_a - sp.gru_a).abs().max())
        finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
        rms = float(pk.square().mean().sqrt())
        res[form] = dict(same=same, rng=rng_eq, err=err, finite=finite,
                         rms=rms, step_err=step_err)
        log(f"K1[{form}] vs plain, B={CHECK_BATCH}: one step max|h| err "
            f"{step_err:.3e} (tol 1e-4); n={CHECK_STEPS}: "
            f"exact pcm {same:.4f}, rng equal {rng_eq}, max|gru_a| err "
            f"{err:.3e}, finite {finite}, rms {rms:.1f}")
    f, b, q = res["f32"], res["bf16"], res["q8"]
    assert f["same"] >= 0.98 and f["rng"] and f["err"] <= 2e-2, f
    assert q["same"] > 0.90 and q["rng"] and q["err"] <= 5e-2, q
    assert b["finite"] and b["rng"], b
    rel = abs(b["rms"] - f["rms"]) / max(f["rms"], 1.0)
    assert rel < 0.5, f"bf16 rms {b['rms']} vs f32 {f['rms']}"
    log(f"K1 bars: f32 >=98% exact & err<=2e-2, q8 >90% & err<=5e-2, "
        f"bf16 finite & rms within 0.5 of f32 ({rel:.3f}): pass")


def check_k1_main_shape(kw, st, ca, cb, lpc, form):
    """K1 vs its plain version at the main path's shapes (B=1024, n=160),
    from the live state the main path left. Returns the largest one-step
    state error.

    Bars: after one step GRU-A within 1e-4 (f32 sums in another order).
    GRU-B within 1e-4 in q8, whose products are exact integers, but within
    1e-2 in bf16: GRU-B's operand is the new h_a rounded to bf16, and an
    h_a that differs in its last f32 bit can round to the neighbouring bf16
    value (2^-8 relative). RNG equal and finite in both. Over the frame,
    q8 >90 % exact PCM; bf16, whose streams that rounding sets apart one by
    one, a PCM RMS within 0.5 of the plain version's (the bf16 bar of the
    JAX package's kernel test)."""
    s1k, _ = K.synthesize_frame_kernel(kw, st, ca, cb, lpc, 1)
    s1p, _ = K.sample_loop_plain(kw, st, ca, cb, lpc, 1)
    err_a = float((s1k.gru_a - s1p.gru_a).abs().max())
    err_b = float((s1k.gru_b - s1p.gru_b).abs().max())
    sk, pk = K.synthesize_frame_kernel(kw, st, ca, cb, lpc)
    torch.cuda.synchronize()
    sp, pp = K.sample_loop_plain(kw, st, ca, cb, lpc)
    same = float((pk == pp).float().mean())
    apart = int((pk != pp).any(dim=1).sum())
    rms_k, rms_p = (float(x.square().mean().sqrt()) for x in (pk, pp))
    rng_eq = all(bool(torch.equal(a, b)) for a, b in zip(sk.rng, sp.rng))
    finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
    log(f"K1[{form}] vs plain, B={ca.shape[0]} n={pk.shape[1]}, live state: "
        f"one step max|h_a| err {err_a:.3e} (tol 1e-4), max|h_b| err "
        f"{err_b:.3e}; frame: exact pcm {same:.4f}, streams apart {apart}, "
        f"rms {rms_k:.1f} vs {rms_p:.1f}, rng equal {rng_eq}, finite {finite}")
    assert err_a <= 1e-4 and rng_eq and finite, form
    if form == "q8":
        assert err_b <= 1e-4 and same > 0.90, form
    else:
        assert err_b <= 1e-2 and abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5, form
    return max(err_a, err_b)


def drive_main_path(int8, dev, feats):
    """Synthesizer at full width; returns (pcm [frames, B, 160], seconds,
    K1 launches, the kernel bundle)."""
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, int8=int8, device=dev)
    synth = api.Synthesizer(batch=MAIN_BATCH, fused=fused, cfg=cfg, device=dev)
    K.synthesize_frame_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [synth.synthesize(feats[k]) for k in range(MAIN_FRAMES)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = K.synthesize_frame_kernel.launches
    pcm = np.stack(out)
    form = "q8" if int8 else "bf16"
    assert launches == MAIN_FRAMES, (form, launches)
    assert pcm.dtype == np.int16 and pcm.shape == (MAIN_FRAMES, MAIN_BATCH, 160)
    la = synth.cfg.lookahead
    assert not pcm[:la].any(), f"{form}: warmup frames not silent"
    assert pcm[la:].any(axis=(0, 2)).all(), f"{form}: a stream stayed silent"
    state = synth._dec.sample_state
    assert all(bool(torch.isfinite(x).all()) for x in
               (state.gru_a, state.gru_b, state.last_sig, state.deemph))
    return pcm, secs, launches, synth._dec._kw, synth


# --------------------------------------------------------------------------
# K5: the GRU training recurrence
# --------------------------------------------------------------------------

def gru_case(n, b, t, dev, seed):
    """GRU weights like a fresh init's (glorot input kernel, recurrent gain
    0.8) and unit-variance inputs at the training path's input width."""
    nin = 512
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    params = {"kernel": f(nin, 3 * n) * 0.05,
              "recurrent": f(n, 3 * n) * float(0.8 / np.sqrt(n)),
              "bias": f(2, 3 * n) * 0.1}
    return params, f(b, t, nin), f(b, n) * 0.3, f(b, t, n)


def gru_grads(fn, params, x, h0, w):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    h0 = h0.clone().requires_grad_(True)
    gi = G.gate_input(p, x)
    gi.retain_grad()
    hs, ht = fn(p["recurrent"], p["bias"][1], gi, h0)
    ((hs * w).sum() + (ht ** 2).sum()).backward()
    return hs.detach(), ht.detach(), {
        "dgate_in": gi.grad, "dh0": h0.grad, "dWr": p["recurrent"].grad,
        "dbr": p["bias"].grad[1], "dkernel": p["kernel"].grad}


def check_k5(n, t, dev):
    """K5 vs its plain version at B=128. Returns (largest per-step forward
    error, largest scaled gradient error).

    Bars: every kernel step within 2e-5 of a plain step from the same state
    (hs, and hT = hs[:, -1]); the whole trajectory within 5e-3 of the plain
    version's: the recurrent operand is h rounded to bf16, so an h that
    differs in its last float32 bit (sums in another order) can round to the
    neighbouring bf16 value, which moves later states by ~1e-3; dgate_in,
    dh0, dWr, dbr and the input kernel's gradient within 1e-2 of each leaf's
    largest entry; two backward runs bit-equal."""
    b = TRAIN_BATCH
    params, x, h0, w = gru_case(n, b, t, dev, SEED + 5)
    hk, htk, gk = gru_grads(G.gru_recurrence, params, x, h0, w)
    torch.cuda.synchronize()
    hp, htp, gp = gru_grads(G.gru_recurrence_plain, params, x, h0, w)
    with torch.no_grad():
        gi = G.gate_input(params, x)
        hprev = torch.cat([h0[:, None], hk[:, :-1]], dim=1)
        step, _ = G.gru_recurrence_plain(
            params["recurrent"], params["bias"][1],
            gi.reshape(b * t, 1, 3 * n), hprev.reshape(b * t, n))
    step_err = float((step.reshape(b, t, n) - hk).abs().max())
    traj_err = max(float((hk - hp).abs().max()), float((htk - htp).abs().max()))
    off = float(((hk - hp).abs() > 2e-5).float().mean())
    gerr = {k: float((gk[k] - gp[k]).abs().max())
            / max(1e-3, float(gp[k].abs().max())) for k in gp}
    _, _, gk2 = gru_grads(G.gru_recurrence, params, x, h0, w)
    biteq = all(bool(torch.equal(gk[k], gk2[k])) for k in gk)
    log(f"K5[{n}] vs plain, B={b} T={t}: per-step max|hs| err {step_err:.3e} "
        f"(tol 2e-5); trajectory max err {traj_err:.3e} (tol 5e-3), share "
        f"beyond 2e-5 {off:.5f}; scaled gradient errs "
        + ", ".join(f"{k} {v:.3e}" for k, v in gerr.items())
        + f" (tol 1e-2); backward bit-equal twice: {biteq}")
    assert step_err <= 2e-5 and bool(torch.equal(htk, hk[:, -1])), n
    assert traj_err <= 5e-3, (n, traj_err)
    assert max(gerr.values()) <= 1e-2, (n, gerr)
    assert biteq, n
    return step_err, max(gerr.values())


def k5_bound_ms(n, b, t, backward):
    """Least time: bytes over HBM bandwidth (forward reads gate_in, h0 and
    Wr in bf16, writes hs and hT; backward reads gate_in, hs, dhs and both
    weight layouts, writes dgate_in, dWr, dbr, dh0) against the bf16
    multiply-adds (one product a step forward, three backward)."""
    rows = b * t
    if backward:
        byts = 4 * rows * (3 * n + n + n + 3 * n) + 2 * 2 * 3 * n * n \
            + 4 * (3 * n * n + 3 * n + 3 * b * n)
        ops = 3 * 2 * rows * 3 * n * n
    else:
        byts = 4 * rows * (3 * n + n) + 2 * 3 * n * n + 4 * (3 * n + 2 * b * n)
        ops = 2 * rows * 3 * n * n
    byte_s, op_s = byts / HBM_BPS, ops / PEAK["bf16"]
    return 1e3 * max(byte_s, op_s), ("operations" if op_s >= byte_s else "bytes")


def cudnn_gru(params, n, dev):
    """torch.nn.GRU (cuDNN, reset-after, gates r, z, n) with the same
    weights: the columns z, r, h of the port's layout permuted."""
    perm = lambda m: torch.cat([m[..., n:2 * n], m[..., :n], m[..., 2 * n:]], -1)
    gru = torch.nn.GRU(params["kernel"].shape[0], n, batch_first=True).to(dev)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(perm(params["kernel"]).T)
        gru.weight_hh_l0.copy_(perm(params["recurrent"]).T)
        gru.bias_ih_l0.copy_(perm(params["bias"][0]))
        gru.bias_hh_l0.copy_(perm(params["bias"][1]))
    return gru


def time_k5(n, launches, step_err, grad_err, dev, smi):
    """K5 at the training path's shapes (B=128, T=2400): forward and
    backward per launch (CUDA events), the plain version, the bound, and
    torch.nn.GRU forward / backward against gru_seq_kernel whole. Returns
    (ms of the input product and its backward = whole layer - kernels, the
    two entries of the kernels line)."""
    b, t = TRAIN_BATCH, 2400
    params, x, h0, w = gru_case(n, b, t, dev, SEED + 7)
    wr = params["recurrent"].clone().requires_grad_(True)
    br = params["bias"][1].clone().requires_grad_(True)
    gi = G.gate_input(params, x).requires_grad_(True)
    with torch.no_grad():
        f_ms = time_cuda(lambda: G.gru_recurrence(wr, br, gi, h0), reps=3, warmup=1)
        pf_ms = time_cuda(lambda: G.gru_recurrence_plain(wr, br, gi, h0),
                          reps=1, warmup=0)
    hs, ht = G.gru_recurrence(wr, br, gi, h0)
    dht = torch.zeros_like(ht)
    b_ms = time_cuda(lambda: torch.autograd.grad(
        (hs, ht), (wr, br, gi), (w, dht), retain_graph=True), reps=3, warmup=1)
    del hs, ht
    hs, ht = G.gru_recurrence_plain(wr, br, gi, h0)
    pb_ms = time_cuda(lambda: torch.autograd.grad(
        (hs, ht), (wr, br, gi), (w, dht), retain_graph=True), reps=1, warmup=0)
    del hs, ht, gi
    torch.cuda.empty_cache()

    # the one PyTorch call that computes the same layer, input product
    # included; the port never calls it
    gru = cudnn_gru(params, n, dev)
    pk = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xg = x.clone().requires_grad_(True)
    h0c = h0[None].contiguous()

    def whole_fwd():
        return G.gru_seq_kernel(pk, xg, h0=h0)

    with torch.no_grad():
        lib_f = time_cuda(lambda: gru(x, h0c), reps=3, warmup=1)
        our_f = time_cuda(whole_fwd, reps=3, warmup=1)
        diff = float((gru(x, h0c)[0] - whole_fwd()[0]).abs().max())
    out, _ = gru(xg, h0c)
    lib_b = time_cuda(lambda: torch.autograd.grad(
        out, [xg] + list(gru.parameters()), w, retain_graph=True),
        reps=3, warmup=1)
    del out
    hs, _ = whole_fwd()
    our_b = time_cuda(lambda: torch.autograd.grad(
        hs, [xg] + list(pk.values()), w, retain_graph=True), reps=3, warmup=1)
    del hs
    torch.cuda.empty_cache()
    assert diff < 5e-2, f"K5[{n}] vs torch.nn.GRU (f32): {diff}"
    fb, fby = k5_bound_ms(n, b, t, backward=False)
    bb, bby = k5_bound_ms(n, b, t, backward=True)
    log(f"K5[{n}] B={b} T={t}: forward {f_ms:.3f} ms/launch (plain "
        f"{pf_ms:.1f} ms, bound {fb:.4f} ms by {fby}); backward "
        f"{b_ms:.3f} ms/launch (plain {pb_ms:.1f} ms, bound {bb:.4f} ms by "
        f"{bby}); whole layer with the input product: gru_seq_kernel forward "
        f"{our_f:.3f} ms, backward {our_b:.3f} ms; torch.nn.GRU (cuDNN, f32) "
        f"forward {lib_f:.3f} ms, backward {lib_b:.3f} ms, max|hs| apart "
        f"{diff:.3e} (bf16 vs f32 operands); 2 launches per training step "
        f"each way; card: {smi}")
    src = "lpcnet_torch/kernels/csrc/gru_train.cu"
    products_ms = (our_f - f_ms) + (our_b - b_ms)
    return products_ms, [
        {"name": f"gru_train_fwd[{n}]", "route": "cuda", "source": src,
         "replaces": "lpcnet_tpu/kernels/gru_train.py:72",
         "launches": launches[("fwd", n)], "max_abs_err": step_err,
         "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby,
         "library_ms": lib_f, "pass": True},
        {"name": f"gru_train_bwd[{n}]", "route": "cuda", "source": src,
         "replaces": "lpcnet_tpu/kernels/gru_train.py:141",
         "launches": launches[("bwd", n)], "max_abs_err": grad_err,
         "ms": b_ms, "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
         "library_ms": lib_b, "pass": True},
    ]


# --------------------------------------------------------------------------
# K2: the masked sample loop
# --------------------------------------------------------------------------

def k2_masks(b, n, dev, seed, all_tf):
    rs = np.random.RandomState(seed)
    target = torch.from_numpy((rs.normal(size=(b, n)) * 1000
                               ).astype(np.float32)).to(dev)
    adv = rs.rand(b, n) < 0.7
    adv[: b // 4] = False                       # a quarter never advances
    tf = adv.copy() if all_tf else rs.rand(b, n) < 0.5
    return target, torch.from_numpy(tf).to(dev), torch.from_numpy(adv).to(dev)


def check_k2(fused, cfg, dev):
    """K2 vs its plain version, B=256, 32 steps and one full frame, random
    advance and teacher-force masks, the sampler on and off. Bars: RNG equal;
    streams with advance off bit-equal in state and RNG with PCM 0; q8 with
    every advanced step teacher-forced exact in PCM, state and RNG, and f32
    and bf16 exact in PCM there too (a teacher-forced sample is target -
    0.85 deemph, whatever the network says); sampled steps at K1's bars (f32
    >=98 % exact PCM, q8 >90 %, bf16 finite with its RMS within 0.5 of the
    plain version's and >=95 % exact PCM: teacher-forced samples agree, and
    a stream that bf16 rounding sets apart is pulled back by them)."""
    b = CHECK_BATCH
    ca, cb, lpc = conditioning(fused, cfg, b, dev)
    s0 = M.init_sample_state(b, cfg, dev)
    bundles = {
        "f32": K.kernel_weights(fused, cfg, dtype=torch.float32),
        "bf16": K.kernel_weights(fused, cfg, dtype=torch.bfloat16),
        "q8": K.kernel_weights(quantize_fused(fused), cfg),
    }
    fro = slice(0, b // 4)
    for form, kw in bundles.items():
        for n in (CHECK_STEPS, 160):
            for sampled in (True, False):
                tg, tf, adv = k2_masks(b, n, dev, SEED + n, all_tf=not sampled)
                sk, pk = K.synthesize_frame_masked_kernel(
                    kw, s0, ca, cb, lpc, tg, tf, adv, n, sampled)
                torch.cuda.synchronize()
                sp, pp = K.sample_loop_masked_plain(
                    kw, s0, ca, cb, lpc, tg, tf, adv, n, sampled)
                same = float((pk == pp).float().mean())
                rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
                frozen = (all(bool(torch.equal(a[fro], c[fro])) for a, c in
                              zip(sk[:5], s0[:5]))
                          and all(bool(torch.equal(a[fro], c[fro]))
                                  for a, c in zip(sk.rng, s0.rng))
                          and not bool(pk[~adv].any()))
                err = float((sk.gru_a - sp.gru_a).abs().max())
                rms_k, rms_p = (float(v.square().mean().sqrt()) for v in (pk, pp))
                finite = bool(torch.isfinite(pk).all()
                              and torch.isfinite(sk.gru_a).all())
                log(f"K2[{form}] vs plain, B={b} n={n} sampled={sampled}: exact "
                    f"pcm {same:.4f}, rng equal {rng_eq}, frozen streams "
                    f"untouched {frozen}, max|gru_a| err {err:.3e}, rms "
                    f"{rms_k:.1f} vs {rms_p:.1f}")
                assert rng_eq and frozen and finite, (form, n, sampled)
                if not sampled:
                    assert same == 1.0, (form, n, same)
                if form == "q8" and not sampled:
                    assert err == 0.0, (form, n, err)
                    assert all(bool(torch.equal(a, c)) for a, c in
                               zip(sk[:5], sp[:5])), (form, n)
                elif form == "f32":
                    assert same >= 0.98 and err <= 2e-2, (form, n, same, err)
                elif form == "q8":
                    assert same > 0.90 and err <= 5e-2, (form, n, same, err)
                else:
                    assert same >= 0.95, (form, n, same)
                    assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5, (form, n)
    log("K2 bars: rng equal, frozen streams bit-equal with pcm 0, "
        "teacher-forced pcm exact (q8: state too), f32 >=98% / q8 >90% / "
        "bf16 >=95% exact pcm, bf16 rms within 0.5: pass")


def k2_train_case(fused, cfg, dev):
    """K2's inputs as the training path gives them: B=128, one frame, the
    bf16 bundle, every stream advancing, three quarters of the samples
    teacher-forced in runs of 16."""
    b = TRAIN_BATCH
    kw = K.kernel_weights(fused, cfg)
    ca, cb, lpc = conditioning(fused, cfg, b, dev)
    s0 = M.init_sample_state(b, cfg, dev)
    rs = np.random.RandomState(SEED + 9)
    tg = torch.from_numpy((rs.normal(size=(b, 160)) * 1000).astype(np.float32)).to(dev)
    tf = torch.from_numpy(np.repeat(rs.rand(b, 10) < 0.75, 16, axis=1)).to(dev)
    adv = torch.ones((b, 160), dtype=torch.bool, device=dev)
    return kw, s0, ca, cb, lpc, tg, tf, adv


def check_k2_train_shape(case):
    """K2 vs its plain version on the inputs it is timed on
    (`k2_train_case`). Returns the largest one-step state error.

    Bars: after one step GRU-A within 1e-4 and GRU-B within 1e-2 (K1's
    bf16 bars, see check_k1_main_shape). Over the frame with the sampler:
    RNG equal, finite, >=95 % exact PCM, RMS within 0.5 of the plain
    version's. Over the frame with every step teacher-forced and the sampler
    off, PCM, signal history, de-emphasis state, last excitation and RNG are
    exact, since none of them depends on the network; the GRU states stay
    within 2e-2."""
    kw, s0, ca, cb, lpc, tg, tf, adv = case
    b, n = tg.shape
    run = lambda fn, tf, n, sampled: fn(kw, s0, ca, cb, lpc, tg[:, :n].contiguous(),
                                        tf[:, :n].contiguous(),
                                        adv[:, :n].contiguous(), n, sampled)
    s1k, _ = run(K.synthesize_frame_masked_kernel, tf, 1, True)
    s1p, _ = run(K.sample_loop_masked_plain, tf, 1, True)
    err_a = float((s1k.gru_a - s1p.gru_a).abs().max())
    err_b = float((s1k.gru_b - s1p.gru_b).abs().max())
    assert err_a <= 1e-4 and err_b <= 1e-2, (err_a, err_b)

    sk, pk = run(K.synthesize_frame_masked_kernel, tf, n, True)
    torch.cuda.synchronize()
    sp, pp = run(K.sample_loop_masked_plain, tf, n, True)
    same = float((pk == pp).float().mean())
    rms_k, rms_p = (float(v.square().mean().sqrt()) for v in (pk, pp))
    rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
    finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
    assert rng_eq and finite and same >= 0.95, (rng_eq, finite, same)
    assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5, (rms_k, rms_p)

    sk, pk = run(K.synthesize_frame_masked_kernel, adv, n, False)
    torch.cuda.synchronize()
    sp, pp = run(K.sample_loop_masked_plain, adv, n, False)
    tf_same = float((pk == pp).float().mean())
    tf_err = max(float((sk.gru_a - sp.gru_a).abs().max()),
                 float((sk.gru_b - sp.gru_b).abs().max()))
    assert tf_same == 1.0 and tf_err <= 2e-2, (tf_same, tf_err)
    assert all(bool(torch.equal(a, c)) for a, c in
               zip(sk[2:5] + tuple(sk.rng), sp[2:5] + tuple(sp.rng)))
    log(f"K2[bf16] vs plain, B={b} n={n}, every stream advancing: one step "
        f"max|h_a| err {err_a:.3e} (tol 1e-4), max|h_b| err {err_b:.3e} (tol "
        f"1e-2); frame, 3/4 teacher-forced in runs of 16: exact pcm "
        f"{same:.4f} (bar 0.95), rms {rms_k:.1f} vs {rms_p:.1f}, rng equal "
        f"{rng_eq}; frame, all teacher-forced, sampler off: exact pcm "
        f"{tf_same:.4f} (bar 1), history, deemph, exc and rng equal, max|h| "
        f"err {tf_err:.3e} (tol 2e-2)")
    return max(err_a, err_b)


def time_k2(case, cfg, launches, step_err, smi):
    """K2 per launch on `k2_train_case`'s inputs, the ones
    `check_k2_train_shape` took `step_err` from."""
    kw, s0, ca, cb, lpc, tg, tf, adv = case
    b = tg.shape[0]
    k_ms = time_cuda(lambda: K.synthesize_frame_masked_kernel(
        kw, s0, ca, cb, lpc, tg, tf, adv), reps=10)
    p_ms = time_cuda(lambda: K.sample_loop_masked_plain(
        kw, s0, ca, cb, lpc, tg, tf, adv), reps=1, warmup=1)
    bound, bound_by = k1_bound_ms(kw, cfg, b, 160, masked=True)
    log(f"K2[bf16] B={b} n=160: kernel {k_ms:.4f} ms/launch, plain "
        f"{p_ms:.2f} ms, bound {bound:.4f} ms ({bound_by}), 15 launches per "
        f"training step with ss_prob > 0; library: no single PyTorch call "
        f"computes K2; card: {smi}")
    return {"name": "sample_loop_masked[bf16]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/sample_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:461",
            "launches": launches, "max_abs_err": step_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "pass": True}


# --------------------------------------------------------------------------
# The training path
# --------------------------------------------------------------------------

def write_corpus(directory, batches, seed):
    """A training corpus in dump_data's file format, made from a seed:
    interleaved int16 (sig_in, sig_out) pairs of a smooth random signal and
    rows of 36 float32 features whose LPC part predicts it (first tap
    -0.9), enough for `batches` batches of TRAIN_BATCH 15-frame chunks."""
    rs = np.random.RandomState(seed)
    chunks = batches * TRAIN_BATCH + 1
    samples = chunks * 2400 + 640
    sig = np.zeros(samples + 1, np.float32)
    noise = rs.normal(size=samples + 1).astype(np.float32) * 60
    for blk in range(0, samples + 1, 1 << 16):       # a leaky random walk
        seg = noise[blk:blk + (1 << 16)]
        sig[blk:blk + len(seg)] = np.cumsum(seg) * 0.5
    sig = np.clip(sig - np.convolve(sig, np.ones(400) / 400, "same"),
                  -8000, 8000)
    pcm = np.stack([sig[:-1], sig[1:]], axis=1).round().astype(np.int16)
    frames = chunks * 15 + 8
    feats = (rs.normal(size=(frames, NB_TOTAL_FEATURES)) * 0.3).astype(np.float32)
    feats[:, 18] = rs.uniform(-0.5, 0.5, frames)
    feats[:, 20:36] = rs.normal(size=(frames, 16)).astype(np.float32) * 0.01
    feats[:, 20] -= 0.9
    ppath = os.path.join(directory, "data.s16")
    fpath = os.path.join(directory, "features.f32")
    pcm.tofile(ppath)
    feats.tofile(fpath)
    return ppath, fpath


def flat_params(params, prefix=""):
    """{'a/b': tensor} of a nested parameter dict."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach()
    return out


def clip_holds(params):
    for name, leaf in (("gru_a", "recurrent"), ("gru_b", "kernel"),
                       ("gru_b", "recurrent")):
        w = params[name][leaf].detach().abs()
        if float((w[:, 0::2] + w[:, 1::2]).max()) > 2 * 0.992 + 1e-5:
            return False
    return True


def profile_step(trainer, batch, rng, smi):
    """One more training step under torch.profiler: the device's busy share
    of the step and the kernels that take most of it. Fails where the
    profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch, rng)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    kernels = sorted(((dev_time(e) / 1e3, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(ms for ms, _ in kernels)
    assert busy > 0.0, "torch.profiler recorded no device time"
    top = "; ".join(f"{name[:48]} {ms:.2f} ms" for ms, name in kernels[:8])
    log(f"training step under torch.profiler: {wall_ms:.1f} ms on the host's "
        f"clock (with the profiler's cost), device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %), idle {100 - 100 * busy / wall_ms:.1f}"
        f" %; top kernels: {top}; card: {smi}")


def drive_training(dev, smi, workdir):
    """The trainer at full width on the card: 6 default steps, then 3 with
    scheduled sampling. Returns (the launch counters read after each
    trainer's steps, summed over both: K5's keyed (direction, units), K2's
    under "k2"; {label: ms per step after the first})."""
    ppath, fpath = write_corpus(workdir, TRAIN_STEPS, SEED + 3)
    cfg, tc = M.LPCNetConfig(), T.TrainConfig()
    loader = LPCNetLoader(ppath, fpath, batch_size=tc.batch_size,
                          chunk_frames=tc.chunk_frames, lookahead=tc.lookahead)
    assert len(loader) >= TRAIN_STEPS, len(loader)
    total = collections.Counter()
    step_ms = {}

    def run(trainer, loader, steps, label, want_k2):
        rng = torch.Generator(device=dev)
        rng.manual_seed(SEED + 11)
        before = {k: v.detach().clone() for k, v in
                  flat_params(trainer.params).items()}
        G.GruRecurrence.reset_launches()
        K.synthesize_frame_masked_kernel.launches = 0
        K.synthesize_frame_kernel.launches = 0
        torch.cuda.synchronize()
        metrics, times = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            metrics.append(trainer.train_step(loader[i], rng))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        k5 = dict(G.GruRecurrence.launches)
        k2 = K.synthesize_frame_masked_kernel.launches
        losses = [float(m["loss"]) for m in metrics]
        steady = 1e3 * float(np.mean(times[1:]))
        log(f"training path [{label}]: Trainer B={tc.batch_size} T="
            f"{tc.chunk_samples}, {steps} steps: losses "
            + " ".join(f"{v:.4f}" for v in losses)
            + f"; {steady:.1f} ms/step after the first ({1e3 * times[0]:.1f} "
            f"ms), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB; K5 launches {k5}, K2 launches {k2}; card: {smi}")
        assert np.isfinite(losses).all(), losses
        na, nb = cfg.rnn_units1, cfg.rnn_units2
        assert k5 == {("fwd", na): steps, ("fwd", nb): steps,
                      ("bwd", na): steps, ("bwd", nb): steps}, k5
        assert k2 == want_k2, (label, k2)
        assert K.synthesize_frame_kernel.launches == 0
        after = flat_params(trainer.params)
        assert all(not torch.equal(before[k], after[k]) for k in before
                   if "bias" not in k and "factor" not in k), "a leaf stayed"
        assert all(bool(torch.isfinite(v).all()) for v in after.values())
        assert clip_holds(trainer.params), "WeightClip does not hold"
        total.update(k5)
        total["k2"] += k2
        step_ms[label] = steady
        return losses

    trainer = T.Trainer(cfg, tc, seed=SEED, device=dev)
    assert trainer.gru_impl == "auto" and trainer.device.type == "cuda"
    torch.cuda.reset_peak_memory_stats()
    losses = run(trainer, loader, TRAIN_STEPS, "default", 0)
    assert losses[-1] < losses[0], losses

    # a checkpoint written and restored gives the same next loss
    ck = os.path.join(workdir, "step_6")
    checkpointing.save_train_state(ck, trainer.full_state(), cfg)
    twin = T.Trainer(cfg, tc, seed=SEED + 1, device=dev)
    twin.restore_full_state(checkpointing.restore_train_state(
        ck, twin.full_state()))
    nxt = []
    for tr in (trainer, twin):
        rng = torch.Generator(device=dev)
        rng.manual_seed(SEED + 13)
        nxt.append(float(tr.train_step(loader[0], rng)["loss"]))
    log(f"training path: next loss after checkpoint restore {nxt[1]:.6f} vs "
        f"{nxt[0]:.6f} without")
    assert abs(nxt[0] - nxt[1]) <= 1e-6 * abs(nxt[0]), nxt
    fused, lcfg = api.load_model(ck + ".npz", device=dev)
    assert lcfg == cfg and fused["embed_sig_a"].shape == (256, 3 * cfg.rnn_units1)
    rng = torch.Generator(device=dev)
    rng.manual_seed(SEED + 17)
    profile_step(trainer, loader[1], rng, smi)
    del trainer, twin
    torch.cuda.empty_cache()

    # the second trainer reads the corpus from the card
    on_card = DeviceLPCNetLoader(ppath, fpath, batch_size=tc.batch_size,
                                 chunk_frames=tc.chunk_frames,
                                 lookahead=tc.lookahead, device=dev)
    for k, v in loader[0].items():
        got = on_card[0][k]
        assert got.is_cuda and np.array_equal(got.cpu().numpy(), v), k
    ss = T.Trainer(cfg, T.TrainConfig(ss_prob=0.25), seed=SEED, device=dev)
    run(ss, on_card, SS_STEPS, "ss_prob=0.25", 15 * SS_STEPS)
    del ss, on_card
    torch.cuda.empty_cache()
    return total, step_ms


def log_step_breakdown(entries, products_ms, step_ms, smi):
    """Where a training step goes: the kernels' and the input products'
    times, taken alone at the step's shapes, against the step's time on the
    host's clock."""
    by_name = {e["name"]: e["ms"] for e in entries}
    k5f = sum(v for k, v in by_name.items() if k.startswith("gru_train_fwd"))
    k5b = sum(v for k, v in by_name.items() if k.startswith("gru_train_bwd"))
    for label, ms in step_ms.items():
        parts = {"K5 forward": k5f, "K5 backward": k5b,
                 "input products": products_ms}
        if label != "default":
            parts["K2 (15 launches)"] = 15 * by_name["sample_loop_masked[bf16]"]
        parts["rest"] = ms - sum(parts.values())
        log(f"training step [{label}] {ms:.1f} ms = "
            + ", ".join(f"{k} {v:.1f} ms ({100 * v / ms:.1f} %)"
                        for k, v in parts.items())
            + f"; card: {smi}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    # 1. build
    t0 = time.perf_counter()
    built = _build.build_all(KERNEL_SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f} s for {KERNEL_SOURCES}")
    for name, (_, nvcc_log) in built.items():
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 2. K1 vs plain
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    check_k1(fused, cfg, dev)

    # 3. the main path, then 4. timings on its own inputs
    feats = features(MAIN_BATCH, MAIN_FRAMES, SEED)
    entries = []
    for int8 in (False, True):
        form = "q8" if int8 else "bf16"
        pcm, secs, launches, kw, synth = drive_main_path(int8, dev, feats)
        samples = MAIN_FRAMES * MAIN_BATCH * 160
        log(f"main path [{form}]: Synthesizer B={MAIN_BATCH}, {MAIN_FRAMES} "
            f"frames: {1e3 * secs / MAIN_FRAMES:.3f} ms/frame, "
            f"{samples / secs / 1e6:.3f} Msamples/s, K1 launches {launches}; "
            f"warmup silent, int16, non-zero after; card: {smi}")

        fused_f = synth._dec.fused
        ca, cb, lpc = conditioning(fused_f, cfg, MAIN_BATCH, dev)
        st = synth._dec.sample_state
        step_err = check_k1_main_shape(kw, st, ca, cb, lpc, form)
        k_ms = time_cuda(lambda: K.synthesize_frame_kernel(kw, st, ca, cb, lpc),
                         reps=20)
        p_ms = time_cuda(lambda: K.sample_loop_plain(kw, st, ca, cb, lpc),
                         reps=2, warmup=1)
        fs = M.init_frame_state(MAIN_BATCH, cfg, dev)
        f0 = torch.from_numpy(feats[0]).to(dev)
        fn_ms = time_cuda(lambda: M.frame_network(fused_f, fs, f0, cfg),
                          reps=20)
        log(f"main path [{form}]: frame network {fn_ms:.4f} ms/frame "
            f"(CUDA events, B={MAIN_BATCH}); card: {smi}")
        bound, bound_by = k1_bound_ms(kw, cfg, MAIN_BATCH, 160)
        log(f"K1[{form}] B={MAIN_BATCH} n=160: kernel {k_ms:.4f} ms/launch, "
            f"plain {p_ms:.2f} ms, bound {bound:.4f} ms ({bound_by}), "
            f"1 launch per 10 ms frame; library: no single PyTorch call "
            f"computes K1; card: {smi}")
        entries.append({
            "name": f"sample_loop[{form}]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/sample_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:461",
            "launches": launches, "max_abs_err": step_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None,
            "pass": True,
        })
    K.synthesize_frame_kernel.launches = 0

    # 5. K5 vs plain, 6. K2 vs plain
    k5_err = {}
    for n in (cfg.rnn_units1, cfg.rnn_units2):
        short, full = check_k5(n, 320, dev), check_k5(n, 2400, dev)
        k5_err[n] = tuple(max(a, c) for a, c in zip(short, full))
        torch.cuda.empty_cache()
    check_k2(fused, cfg, dev)
    k2_case = k2_train_case(fused, cfg, dev)
    k2_err = check_k2_train_shape(k2_case)

    # 7. the training path, then 8. timings at its shapes
    with tempfile.TemporaryDirectory() as workdir:
        launches, step_ms = drive_training(dev, smi, workdir)
    entries.append(time_k2(k2_case, cfg, launches["k2"], k2_err, smi))
    products_ms = 0.0
    for n in (cfg.rnn_units1, cfg.rnn_units2):
        prod, k5_entries = time_k5(n, launches, *k5_err[n], dev, smi)
        products_ms += prod
        entries.extend(k5_entries)
    log_step_breakdown(entries, products_ms, step_ms, smi)
    G.GruRecurrence.reset_launches()
    K.synthesize_frame_masked_kernel.launches = 0

    print(json.dumps({"kernels": entries}))
    print(smi)          # nvidia-smi: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
