"""GPU smoke check of lpcnet_torch: builds every kernel, holds each against its
plain PyTorch version on the card, drives vocoder synthesis, vocoder
training, batched packet-loss concealment and the 1.6 kb/s codec (encode,
packet decode through StreamPool) end to end through the public entry
points, and times them.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases:
  1. build every kernel from lpcnet_torch/kernels/csrc (one nvcc per source,
     all at once);
  2. the free-running sample loop (K1: in bf16 and q8 the free-running form
     of csrc/masked_loop.cu's cluster kernel, in f32 the first design of
     csrc/sample_loop.cu) vs its plain version on the shipped demo vocoder
     at 256 streams, 32 steps, in the f32, bf16 and q8 forms, then at the
     ragged batches 1, 130, 1024 and 4097 (one cluster of one stream, one
     wave, two waves, seven);
  3. the synthesis path: api.Synthesizer on the demo vocoder at 1024 streams
     for 10 frames (cut from 50, then 20, as later paths were added, to keep
     the run about as long), float (bf16 kernel bundle) and int8 (q8); K1's
     launch count must equal the frame count;
  4. K1 vs its plain version again at that path's shapes (1024 streams,
     160 steps, from the state the path left), then timings: K1 per launch
     (CUDA events) vs its plain version and its bound;
  5. the GRU training kernel (K5, forward and backward) vs its plain version
     at 384 and 16 units, B=128, at T=320 and at the training path's T=2400,
     and the 16-unit forward (warp-synchronous) again at B=37, T=2400; the
     backward's gate pass alone vs its plain version, and the forward and
     backward at 16, 64, 384, 448, 640 and 1024 units, B=37, T=48 (the
     forward on each of its three routes: warp-synchronous, Wr resident
     across a cluster, the first cluster kernel);
  6. the masked sample-loop kernel (K2, the cluster kernel of
     csrc/masked_loop.cu) vs its plain version at 256 streams, 32 steps and
     one full frame, f32, bf16 and q8, with and without the sampler; at the
     ragged batches 1, 37 and 130, 32 steps, each form, with and without the
     sampler; free-running (every step advancing) vs K1's plain version; at
     Na=640 and at Na=100, Nb=10 on random weights; and at the training
     path's shapes (128 streams, one frame, the bf16 bundle, every stream
     advancing);
  7. the training path: a corpus written from a seed, then
     train_lpcnet.Trainer at LPCNetConfig() / TrainConfig() (batch 128,
     2400-sample chunks) takes 4 steps through LPCNetLoader, a second
     trainer with ss_prob=0.25 takes 2 through DeviceLPCNetLoader; launch
     counts of K5 and K2, falling loss, constraints and a checkpoint round
     trip are asserted; one more step runs under torch.profiler for the
     device's busy share;
  8. timings of K5 and K2 at the training path's shapes vs their plain
     versions, their bounds and, for K5, torch.nn.GRU (cuDNN) as a
     yardstick, with the layer's input product alone, the forward's route
     and the backward's three phases apart (gate pass, chain, dWr); K2 in
     all three forms on the same inputs, and K1 on them; K2 in bf16 at 256
     and 1024 streams;
  9. the teacher-forced run (K3, the teacher-forced form of
     csrc/masked_loop.cu's cluster kernel) vs its plain version at 37 and
     256 streams, 3 blocks of 160 steps, f32, bf16 and q8, and against K2
     with the sampler off; the PLC-net chain (K4, clusters of 8 blocks that
     split its units, csrc/plc_chain.cu) vs its plain version at 256, 37 and
     3 streams; a teacher-forced frame through the decoder (K2);
 10. the PLC path: runtime.serving.PLCStreamPool on the demo vocoder and the
     demo PLC network at 256 streams for 200 frames of a seeded speech-like
     signal, 10 % of the 20 ms packets lost, FEC rows queued for a quarter
     of the streams; then 50 frames more with the chain kernel on beside a
     pool that keeps it off; launch counts of K2, K3 and K4 are asserted;
     one more frame runs under torch.profiler;
 11. K3, both K2 calls and K4 vs their plain versions on the arguments that
     path gave them in one frame (the sample-rate section compacted to 64
     streams), then their timings on those arguments (K3's kernel alone and
     its call with the closed forms in PyTorch), with their bounds, and the
     frame's split;
 12. the non-causal PLC path: PLCStreamPool(non_causal=True) on the demo
     vocoder's weights under LPCNetConfig(lookahead=0) and the demo PLC
     network at 256 streams for 100 frames of the same kind of traffic (no
     FEC: the mode has none), K2 twice and K3 three times a frame asserted,
     never-lost streams 80 samples late bit for bit, one frame under
     torch.profiler; then 20 frames with the DC filter on the traffic plus
     an offset of 300; K2 and K3 vs their plain versions on the five calls
     of the busiest frame (the deferred resync, the section's two
     half-frames and its reverse-time resynthesis, compacted; the good
     streams' resync at 256), timed, with K3's launch and bound at 256
     streams for one block and the frame's split; the two-path step
     (fused_step=False) at 256 streams for 10 frames in each mode; the host
     PLC: `cli plc` in the four modes on the C fixture's PLC input, the
     clean packets held to C's traces;
 13. the merged sample-loop kernel (K6: K1's kernel of its form on the
     merged matrices' checked non-zero blocks) vs its plain version at 256
     streams, 32 steps, f32 and bf16, and one step against K1's kernel;
 14. the codec path: api.LPCNetEncoder on 1024 streams of a seeded
     speech-like signal for 10 superframes, the card's decode of its packets
     against its quantized features, then runtime.serving.StreamPool at 1024
     streams decoding those packets for 10 ticks of 40 ms on the demo
     vocoder, the merged flag off (K1) and on (K6): 4 launches a tick of the
     selected kernel, none of the other; K6 and K1 vs the plain version at
     the main shapes from the K6 pool's state (one step, and the share of
     exact PCM over the 160-step frame), their timings, bounds and the
     tick's split; the C fixture's speech encoded on the card (packets
     bit-exact against C counted) and one `cli encode` -> `cli decode`;
 15. DRED (no TPU kernel of its own: its products are float32 matmuls):
     the demo RDO-VAE on features computed on the card from 1024 streams of
     the seeded signal, 200 frames; the served step (one encode_dframe and
     one decode_qframe a stream a 20 ms dframe) at 1024 streams for 100
     dframes, held against the same functions on the CPU for 8 streams,
     timed and profiled; payloads of 16 streams entropy-coded and decoded
     back exactly; decode_all at 1024 streams; PLCStreamPool at 256 streams
     for 100 frames, 64 of its streams fed their DRED-decoded redundancy
     through fec_add (K2 twice and K3 once a frame asserted); `cli
     fec-encode` of the C fixture's speech through the host PLC (K2 at one
     stream) with no prediction used. A {"dred": ...} line carries its
     numbers.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lpcnet_torch import api
from lpcnet_torch.codec import packet as P
from lpcnet_torch.codec.decoder import LPCNetDecoder
from lpcnet_torch.dsp.constants import NB_TOTAL_FEATURES
from lpcnet_torch.kernels import _build
from lpcnet_torch.kernels import gru_train as G
from lpcnet_torch.kernels import plc_chain as PC
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.nn.quantized import quantize_fused
from lpcnet_torch.plc import batched as BP
from lpcnet_torch.runtime.serving import PLCStreamPool
from lpcnet_torch.train import checkpointing
from lpcnet_torch.train import train_lpcnet as T
from lpcnet_torch.train.data import DeviceLPCNetLoader, LPCNetLoader

SEED = 0
KERNEL_SOURCES = ["sample_loop", "masked_loop", "gru_train", "plc_chain"]
# H100 SXM data-sheet peaks (dense): bytes/s and operations/s by type
HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
MAIN_BATCH = 1024
MAIN_FRAMES = 10
TRAIN_BATCH = 128
TRAIN_STEPS = 4
SS_STEPS = 2
PLC_STREAMS = 256
PLC_FRAMES = 200
PLC_CHAIN_FRAMES = 50
CHECK_BATCH = 256
CHECK_STEPS = 32
NC_STREAMS = 256
NC_FRAMES = 100
NC_DC_FRAMES = 20
TWO_PATH_FRAMES = 10
CODEC_STREAMS = 1024
CODEC_SUPERFRAMES = 10
DRED_STREAMS = 1024
DRED_FRAMES = 200
DRED_CPU_STREAMS = 8
DRED_PAYLOAD_STREAMS = 16
DRED_PLC_STREAMS = 256
DRED_PLC_FRAMES = 100


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
    weight_bytes = sum(v.numel() * v.element_size() for k, v in kw.items()
                       if not k.startswith("k2_"))     # K2's packs: the same bytes
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


def check_k1_batches(fused, cfg, dev):
    """K1 vs its plain version at the ragged batches 1, 130, 1024 and 4097
    (bf16 and q8: one cluster with one stream, one wave of clusters of 16,
    two waves of clusters of 40, seven waves with a ragged last cluster;
    f32 on the first design's blocks of 4), 32 steps, each form from the
    bundle with its packs built once. Bars per call: one step from the
    start within 1e-4 (bf16 h_b 1e-2, see check_k1_main_shape), RNG equal,
    finite; over the frame check_k1's bars (f32 >=98 % exact PCM, q8
    >90 %, bf16 RMS within 0.5 of the plain version's)."""
    bundles = {
        "f32": K.kernel_weights(fused, cfg, dtype=torch.float32),
        "bf16": K.masked_kernel_weights(K.kernel_weights(fused, cfg)),
        "q8": K.masked_kernel_weights(K.kernel_weights(quantize_fused(fused), cfg)),
    }
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    for b in (1, 130, 1024, 4097):
        ca, cb, lpc = conditioning(fused, cfg, b, dev)
        s0 = M.init_sample_state(b, cfg, dev)
        for form, kw in bundles.items():
            s1k, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
            s1p, _ = K.sample_loop_plain(kw, s0, ca, cb, lpc, 1)
            ea = float((s1k.gru_a - s1p.gru_a).abs().max())
            eb = float((s1k.gru_b - s1p.gru_b).abs().max())
            sk, pk = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, CHECK_STEPS)
            torch.cuda.synchronize()
            sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, CHECK_STEPS)
            same = float((pk == pp).float().mean())
            rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
            finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
            rms_k, rms_p = (float(x.square().mean().sqrt()) for x in (pk, pp))
            shape = ("first design, blocks of 4 streams" if form == "f32" else
                     k1_launch_shape(b, na, nb, K.ML.FORMS[form], dev))
            log(f"K1[{form}] vs plain, B={b} n={CHECK_STEPS} ({shape}): one step "
                f"max|h_a| err {ea:.3e}, max|h_b| err {eb:.3e}; exact pcm {same:.4f}, "
                f"rng equal {rng_eq}, rms {rms_k:.1f} vs {rms_p:.1f}")
            assert ea <= 1e-4 and eb <= (1e-2 if form == "bf16" else 1e-4), (form, b)
            assert rng_eq and finite, (form, b)
            if form == "f32":
                assert same >= 0.98, (form, b, same)
            elif form == "q8":
                assert same > 0.90, (form, b, same)
            else:
                assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5, (form, b)
    log("K1 ragged bars: one step, rng, finite, f32 >=98% / q8 >90% exact pcm, "
        "bf16 rms within 0.5: pass")


def k1_launch_shape(b, na, nb, form, dev):
    """K1's free-running cluster launch at b streams, in words."""
    c = K.ML.free_launch_config(b, na, nb, form, K._max_clusters(dev, form, na, K.KIND_FREE))
    res = "+".join(k for k, on in (("GRU-A", c["res_a"]), ("GRU-B", c["res_b"])) if on)
    return (f"clusters of {c['cluster']} blocks, {c['streams']} streams each "
            f"({-(-c['streams'] // c['cluster'])} a rank's tail), {c['clusters']} clusters "
            f"in {c['waves']} wave(s), {c['smem']} bytes of shared memory a block, "
            f"weights in shared memory: {res or 'none'}")


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


def check_k5(n, t, dev, b=TRAIN_BATCH):
    """K5 vs its plain version at B=b (128 unless given). Returns (largest
    per-step forward error, largest scaled gradient error).

    Bars: every kernel step within 2e-5 of a plain step from the same state
    (hs, and hT = hs[:, -1]); the whole trajectory within 5e-3 of the plain
    version's: the recurrent operand is h rounded to bf16, so an h that
    differs in its last float32 bit (sums in another order) can round to the
    neighbouring bf16 value, which moves later states by ~1e-3; dgate_in,
    dh0, dWr, dbr and the input kernel's gradient within 1e-2 of each leaf's
    largest entry; two backward runs bit-equal."""
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
    hk2, _, gk2 = gru_grads(G.gru_recurrence, params, x, h0, w)
    biteq = bool(torch.equal(hk, hk2)) and all(bool(torch.equal(gk[k], gk2[k])) for k in gk)
    log(f"K5[{n}] vs plain, B={b} T={t}, forward {fwd_route_words(n, b, dev)}: "
        f"per-step max|hs| err {step_err:.3e} "
        f"(tol 2e-5); trajectory max err {traj_err:.3e} (tol 5e-3), share "
        f"beyond 2e-5 {off:.5f}; scaled gradient errs "
        + ", ".join(f"{k} {v:.3e}" for k, v in gerr.items())
        + f" (tol 1e-2); forward and backward bit-equal twice: {biteq}")
    assert step_err <= 2e-5 and bool(torch.equal(htk, hk[:, -1])), n
    assert traj_err <= 5e-3, (n, traj_err)
    assert max(gerr.values()) <= 1e-2, (n, gerr)
    assert biteq, n
    return step_err, max(gerr.values())


def check_gate_pass(n, dev, b=TRAIN_BATCH, t=320):
    """The backward's gate pass alone (z and the four factors of every row
    and unit) vs `gate_pass_plain` on the same forward output, B=128,
    T=320. Bar: each field within 1e-5 of its plain value (the fields are
    O(1): zrec's float32 sums run in another order on the tensor cores,
    ~1e-7 relative, and sigmoid and tanh do not amplify it). Returns the
    largest error."""
    params, x, h0, _ = gru_case(n, b, t, dev, SEED + 5)
    with torch.no_grad():
        gi = G.gate_input(params, x)
        hs, _ = G.gru_recurrence(params["recurrent"], params["bias"][1], gi, h0)
        got = G.gate_pass_kernel(params["recurrent"], params["bias"][1], gi, h0, hs)
        torch.cuda.synchronize()
        want = G.gate_pass_plain(params["recurrent"], params["bias"][1], gi, h0, hs)
    errs = {k: float((a - c).abs().max()) for k, a, c in
            zip(("z", "fz", "fr", "fh", "fzh"), got, want)}
    log(f"K5 backward gate pass [{n}] vs plain, B={b} T={t}: max err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (tol 1e-5)")
    assert max(errs.values()) <= 1e-5, (n, errs)
    return max(errs.values())


def fwd_route_words(n, b, dev):
    """The forward kernel an N-unit GRU runs at b streams, in words."""
    route = G.forward_route(n)
    if route == "warp":
        return "gru_fwd_warp_kernel (warp-synchronous, Wr in registers)"
    if route == "cluster":
        c, threads = G.launch_config(n)
        return (f"gru_fwd_kernel (the first cluster design: clusters of {c} blocks "
                f"of {threads} threads, 4 streams, Wr from L2)")
    c = G.fwd_launch_config(b, n, G._max_clusters(dev, n, "fwd"))
    return (f"gru_fwd_chain_kernel (clusters of {c['cluster']} x {c['units']} units, "
            f"{c['streams']} streams, Wr resident, {c['smem']} bytes, "
            f"{c['clusters']} clusters in {c['waves']} wave(s), the product on the "
            f"tensor cores)")


def check_k5_widths(dev):
    """The forward and the backward at 16, 64, 384, 448, 640 and 1024 units
    (forward: warp-synchronous at 16, Wr resident across clusters of 4 and
    8 blocks at 64 to 448, the first cluster kernel at 640 and 1024;
    backward: clusters of 1, 4 and 8 blocks, Wr's rows resident in shared
    memory up to 448, read from L2 at 640 and 1024), B=37 (a ragged last
    cluster), T=48, at check_k5's bars: every forward step within 2e-5 of a
    plain step from the same state, the trajectory within 5e-3, the forward
    bit-equal twice; through autograd from the kernel forward, each gradient
    leaf within 1e-2 of its largest entry, two runs bit-equal."""
    b, t = 37, 48
    for n in (16, 64, 384, 448, 640, 1024):
        params, x, h0, w = gru_case(n, b, t, dev, SEED + 11)
        cfg = G.bwd_launch_config(b, n, G._max_clusters(dev, n))
        hk, _, gk = gru_grads(G.gru_recurrence, params, x, h0, w)
        torch.cuda.synchronize()
        hp, _, gp = gru_grads(G.gru_recurrence_plain, params, x, h0, w)
        hk2, _, gk2 = gru_grads(G.gru_recurrence, params, x, h0, w)
        with torch.no_grad():
            gi = G.gate_input(params, x)
            hprev = torch.cat([h0[:, None], hk[:, :-1]], dim=1)
            step, _ = G.gru_recurrence_plain(
                params["recurrent"], params["bias"][1],
                gi.reshape(b * t, 1, 3 * n), hprev.reshape(b * t, n))
        step_err = float((step.reshape(b, t, n) - hk).abs().max())
        traj_err = float((hk - hp).abs().max())
        gerr = {k: float((gk[k] - gp[k]).abs().max())
                / max(1e-3, float(gp[k].abs().max())) for k in gp}
        biteq = bool(torch.equal(hk, hk2)) and all(
            bool(torch.equal(gk[k], gk2[k])) for k in gk)
        log(f"K5 [{n}] B={b} T={t}: forward {fwd_route_words(n, b, dev)}: per-step "
            f"max|hs| err {step_err:.3e} (tol 2e-5), trajectory {traj_err:.3e} (tol "
            f"5e-3); backward (clusters of {cfg['cluster']} x "
            f"{cfg['units']} units, {cfg['streams']} streams, Wr "
            f"{'resident' if cfg['resident'] else 'from L2'}, {cfg['smem']} bytes): "
            "scaled gradient errs " + ", ".join(f"{k} {v:.3e}" for k, v in gerr.items())
            + f" (tol 1e-2); forward and backward bit-equal twice: {biteq}")
        assert step_err <= 2e-5 and traj_err <= 5e-3, (n, step_err, traj_err)
        assert max(gerr.values()) <= 1e-2 and biteq, (n, gerr, biteq)
        torch.cuda.empty_cache()


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
    route = fwd_route_words(n, b, dev)
    b_ms = time_cuda(lambda: torch.autograd.grad(
        (hs, ht), (wr, br, gi), (w, dht), retain_graph=True), reps=3, warmup=1)
    # the backward's phases: the gate pass alone, then the backward of a
    # graph whose weights ask for no gradient (gate pass and chain, no dWr
    # or dbr); the rest is dWr and the reductions
    with torch.no_grad():
        gate_ms = time_cuda(lambda: G.gate_pass_kernel(wr, br, gi, h0, hs), reps=3,
                            warmup=1)
    hs_nw, ht_nw = G.gru_recurrence(wr.detach(), br.detach(), gi, h0)
    nw_ms = time_cuda(lambda: torch.autograd.grad(
        (hs_nw, ht_nw), (gi,), (w, dht), retain_graph=True), reps=3, warmup=1)
    del hs_nw, ht_nw
    phases = {"gate_pass_ms": gate_ms, "chain_ms": nw_ms - gate_ms,
              "dwr_ms": b_ms - nw_ms}
    bcfg = G.bwd_launch_config(b, n, G._max_clusters(dev, n))
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
        in_ms = time_cuda(lambda: G.gate_input(pk, xg), reps=3, warmup=1)
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
        f"{diff:.3e} (bf16 vs f32 operands); the layer's input product "
        f"gate_input alone {in_ms:.3f} ms; the backward's phases: gate pass "
        f"{gate_ms:.3f} ms, chain {phases['chain_ms']:.3f} ms (clusters of "
        f"{bcfg['cluster']} x {bcfg['units']} units, {bcfg['streams']} streams, "
        f"{bcfg['clusters']} clusters in {bcfg['waves']} wave(s), Wr "
        f"{'resident' if bcfg['resident'] else 'from L2'}), dWr and reductions "
        f"{phases['dwr_ms']:.3f} ms; the forward kernel {route}; "
        f"1 launch per training step each way; card: {smi}")
    src = "lpcnet_torch/kernels/csrc/gru_train.cu"
    products_ms = (our_f - f_ms) + (our_b - b_ms)
    return products_ms, [
        {"name": f"gru_train_fwd[{n}]", "route": "cuda", "source": src,
         "replaces": "lpcnet_tpu/kernels/gru_train.py:72",
         "launches": launches[("fwd", n)], "max_abs_err": step_err,
         "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby,
         "library_ms": lib_f, "pass": True, "design": route},
        {"name": f"gru_train_bwd[{n}]", "route": "cuda", "source": src,
         "replaces": "lpcnet_tpu/kernels/gru_train.py:141",
         "launches": launches[("bwd", n)], "max_abs_err": grad_err,
         "ms": b_ms, "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
         "library_ms": lib_b, "pass": True,
         "phases": "gate_pass_kernel (tensor-core gate pass, off the chain) + "
                   "gru_bwd_chain_kernel (clusters, Wr resident, dh on the tensor "
                   "cores) + dwr_kernel + reduce_parts_kernel",
         **phases},
    ]


# --------------------------------------------------------------------------
# K2: the masked sample loop
# --------------------------------------------------------------------------

def k2_bundles(fused, cfg):
    """K2's weight bundles (`masked_kernel_weights`: the packs built once)
    in the three forms."""
    return {
        "f32": K.masked_kernel_weights(K.kernel_weights(fused, cfg, dtype=torch.float32)),
        "bf16": K.masked_kernel_weights(K.kernel_weights(fused, cfg, dtype=torch.bfloat16)),
        "q8": K.masked_kernel_weights(K.kernel_weights(quantize_fused(fused), cfg)),
    }


def k2_launch_shape(b, na, nb, form, dev):
    cfg2 = K.ML.masked_launch_config(b, na, nb, form, K._max_clusters(dev, form, na))
    res = "+".join(k for k, on in (("GRU-A", cfg2["res_a"]), ("GRU-B", cfg2["res_b"])) if on)
    return (f"clusters of {cfg2['cluster']} blocks x {cfg2['units']} units, "
            f"{cfg2['streams']} streams each, {cfg2['clusters']} clusters in "
            f"{cfg2['waves']} wave(s), {cfg2['smem']} bytes of shared memory a block, "
            f"weights in shared memory: {res or 'none'}")


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
    bundles = k2_bundles(fused, cfg)
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


def check_k2_ragged(fused, cfg, dev):
    """K2 vs its plain version at the ragged batches 1, 37 and 130 (one
    cluster with one stream, clusters of 8 streams with a ragged last one,
    clusters of 16), 32 steps, each form, random masks, the sampler on and
    off. Bars per call: RNG equal; streams that never advance bit-equal
    with PCM 0; teacher-forced samples exact; one step from the start
    within 1e-4 (bf16 h_b 1e-2); with the sampler off PCM exact, q8 state
    too. Over the three batches (168 streams) with the sampler on: f32
    >=98 % exact PCM, q8 >90 %, bf16 >=95 %."""
    bundles = k2_bundles(fused, cfg)
    n = CHECK_STEPS
    same = collections.defaultdict(list)
    for b in (1, 37, 130):
        ca, cb, lpc = conditioning(fused, cfg, b, dev)
        s0 = M.init_sample_state(b, cfg, dev)
        fro = slice(0, b // 4)                  # k2_masks: these never advance
        for form, kw in bundles.items():
            for sampled in (True, False):
                tg, tf, adv = k2_masks(b, n, dev, SEED + 50 + b, all_tf=not sampled)
                args = (kw, s0, ca, cb, lpc, tg, tf, adv, n, sampled)
                one = (kw, s0, ca, cb, lpc, tg[:, :1].contiguous(), tf[:, :1].contiguous(),
                       adv[:, :1].contiguous(), 1, sampled)
                s1k, _ = K.synthesize_frame_masked_kernel(*one)
                s1p, _ = K.sample_loop_masked_plain(*one)
                ea = float((s1k.gru_a - s1p.gru_a).abs().max())
                eb = float((s1k.gru_b - s1p.gru_b).abs().max())
                sk, pk = K.synthesize_frame_masked_kernel(*args)
                torch.cuda.synchronize()
                sp, pp = K.sample_loop_masked_plain(*args)
                rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
                frozen = state_equal(sk, s0, fro) and not bool(pk[~adv].any())
                tf_eq = bool(torch.equal(pk[tf], pp[tf]))
                finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
                eq = (pk == pp).float()
                log(f"K2[{form}] ragged B={b} n={n} sampled={sampled}: one step "
                    f"max|h_a| err {ea:.3e}, max|h_b| err {eb:.3e}; rng equal {rng_eq}, "
                    f"frozen streams untouched {frozen}, teacher-forced pcm exact "
                    f"{tf_eq}, exact pcm {float(eq.mean()):.4f}")
                assert ea <= 1e-4 and eb <= (1e-2 if form == "bf16" else 1e-4), (form, b)
                assert rng_eq and frozen and tf_eq and finite, (form, b, sampled)
                if sampled:
                    same[form].append(eq.flatten())
                else:
                    assert float(eq.mean()) == 1.0, (form, b)
                    if form == "q8":
                        assert state_equal(sk, sp), (form, b)
    share = {f: float(torch.cat(v).mean()) for f, v in same.items()}
    log(f"K2 ragged bars: per call rng, frozen streams, teacher-forced pcm and "
        f"one step; sampler off exact (q8 state too); sampled pcm exact over the "
        f"three batches: f32 {share['f32']:.4f} (>=0.98), q8 {share['q8']:.4f} "
        f"(>0.90), bf16 {share['bf16']:.4f} (>=0.95)")
    assert share["f32"] >= 0.98 and share["q8"] > 0.90 and share["bf16"] >= 0.95, share


def check_k2_free(fused, cfg, dev):
    """K2 with every step advancing and none teacher-forced, the sampler on,
    vs K1's plain version (the free-running loop, K1's function) at B=130,
    32 steps, each form: RNG equal, finite, K1's bars on exact PCM (f32
    >=98 %, q8 >90 %, bf16 >=95 %)."""
    b, n = 130, CHECK_STEPS
    ca, cb, lpc = conditioning(fused, cfg, b, dev)
    s0 = M.init_sample_state(b, cfg, dev)
    on = torch.ones((b, n), dtype=torch.bool, device=dev)
    for form, kw in k2_bundles(fused, cfg).items():
        sk, pk = K.synthesize_frame_masked_kernel(kw, s0, ca, cb, lpc, on.float(), ~on, on, n)
        torch.cuda.synchronize()
        sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, n)
        rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
        same = float((pk == pp).float().mean())
        log(f"K2[{form}] free-running (every step advancing, none teacher-forced) vs "
            f"K1's plain version, B={b} n={n}: rng equal {rng_eq}, exact pcm {same:.4f}")
        assert rng_eq and bool(torch.isfinite(pk).all()), form
        assert same >= {"f32": 0.98, "q8": 0.9, "bf16": 0.95}[form], (form, same)


def check_k2_widths(dev):
    """K2 at widths other than the default's, on random weights from a seed:
    the LPCNet paper's 640-unit GRU-A (the bf16 slice, 307 KB, does not fit
    a block's shared memory and is read from L2) and Na=100, Nb=10 (no
    multiple of 16: padded units), B=37, 32 steps, each form, the sampler on
    and off, at the ragged batches' bars per call."""
    for na, nb in ((640, 16), (100, 10)):
        cfg = M.LPCNetConfig(rnn_units1=na, rnn_units2=nb)
        fused = M.fuse_inference_params(M.init_params(cfg, seed=SEED + na, device=dev), cfg)
        b, n = 37, CHECK_STEPS
        ca, cb, lpc = conditioning(fused, cfg, b, dev)
        s0 = M.init_sample_state(b, cfg, dev)
        fro = slice(0, b // 4)
        for form, kw in k2_bundles(fused, cfg).items():
            log(f"K2[{form}] Na={na} Nb={nb} B={b}: "
                + k2_launch_shape(b, na, nb, K.ML.FORMS[form], dev))
            for sampled in (True, False):
                tg, tf, adv = k2_masks(b, n, dev, SEED + 70 + na, all_tf=not sampled)
                one = (kw, s0, ca, cb, lpc, tg[:, :1].contiguous(), tf[:, :1].contiguous(),
                       adv[:, :1].contiguous(), 1, sampled)
                s1k, _ = K.synthesize_frame_masked_kernel(*one)
                s1p, _ = K.sample_loop_masked_plain(*one)
                ea = float((s1k.gru_a - s1p.gru_a).abs().max())
                eb = float((s1k.gru_b - s1p.gru_b).abs().max())
                args = (kw, s0, ca, cb, lpc, tg, tf, adv, n, sampled)
                sk, pk = K.synthesize_frame_masked_kernel(*args)
                torch.cuda.synchronize()
                sp, pp = K.sample_loop_masked_plain(*args)
                rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
                frozen = state_equal(sk, s0, fro) and not bool(pk[~adv].any())
                tf_eq = bool(torch.equal(pk[tf], pp[tf]))
                finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
                same = float((pk == pp).float().mean())
                log(f"K2[{form}] Na={na} Nb={nb} B={b} n={n} sampled={sampled}: one step "
                    f"max|h_a| err {ea:.3e}, max|h_b| err {eb:.3e}; rng equal {rng_eq}, "
                    f"frozen streams untouched {frozen}, teacher-forced pcm exact "
                    f"{tf_eq}, exact pcm {same:.4f}")
                assert ea <= 1e-4 and eb <= (1e-2 if form == "bf16" else 1e-4), (form, na)
                assert rng_eq and frozen and tf_eq and finite, (form, na, sampled)
                if sampled:
                    assert same >= {"f32": 0.98, "q8": 0.9, "bf16": 0.95}[form], (form, na)
                else:
                    assert same == 1.0, (form, na)
                    if form == "q8":
                        assert state_equal(sk, sp), (form, na)


def k2_train_case(fused, cfg, dev, b=TRAIN_BATCH, kw=None):
    """K2's inputs as the training path gives them: B=128, one frame, the
    bf16 bundle, every stream advancing, three quarters of the samples
    teacher-forced in runs of 16."""
    kw = kw or K.masked_kernel_weights(K.kernel_weights(fused, cfg))
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


def time_k2(case, fused, cfg, launches, step_err, smi):
    """K2 per launch on `k2_train_case`'s inputs, the ones
    `check_k2_train_shape` took `step_err` from, in the bf16 form the
    training path runs and in f32 and q8 (each first held one step against
    its plain version there, at K1's one-step bars); K1 on the same inputs
    (free-running: in bf16 and q8 K2's kernel in its free-running form, in
    f32 the first design)."""
    kw, s0, ca, cb, lpc, tg, tf, adv = case
    b = tg.shape[0]
    bundles = dict(k2_bundles(fused, cfg), bf16=kw)
    ms, errs = {}, {}
    for form, kf in bundles.items():
        one = (kf, s0, ca, cb, lpc, tg[:, :1].contiguous(), tf[:, :1].contiguous(),
               adv[:, :1].contiguous(), 1)
        s1k, _ = K.synthesize_frame_masked_kernel(*one)
        s1p, _ = K.sample_loop_masked_plain(*one)
        ea = float((s1k.gru_a - s1p.gru_a).abs().max())
        eb = float((s1k.gru_b - s1p.gru_b).abs().max())
        assert ea <= 1e-4 and eb <= (1e-2 if form == "bf16" else 1e-4), (form, ea, eb)
        errs[form] = max(ea, eb)
        ms[form] = time_cuda(lambda: K.synthesize_frame_masked_kernel(
            kf, s0, ca, cb, lpc, tg, tf, adv), reps=20)
    k1_ms = {form: time_cuda(lambda: K.synthesize_frame_kernel(kf, s0, ca, cb, lpc),
                             reps=10)
             for form, kf in bundles.items()}
    p_ms = time_cuda(lambda: K.sample_loop_masked_plain(
        kw, s0, ca, cb, lpc, tg, tf, adv), reps=1, warmup=1)
    bound, bound_by = k1_bound_ms(kw, cfg, b, 160, masked=True)
    na, nb, dev = cfg.rnn_units1, cfg.rnn_units2, tg.device
    wide = {}
    for bw in (256, 1024):          # the checks' batch, and one that takes waves
        kw_, s0_, ca_, cb_, lpc_, tg_, tf_, adv_ = k2_train_case(fused, cfg, dev, bw, kw)
        wide[bw] = time_cuda(lambda: K.synthesize_frame_masked_kernel(
            kw_, s0_, ca_, cb_, lpc_, tg_, tf_, adv_), reps=10)
        log(f"K2[bf16] B={bw} n=160: {wide[bw]:.4f} ms/launch "
            f"({k2_launch_shape(bw, na, nb, 1, dev)}); bound "
            f"{k1_bound_ms(kw, cfg, bw, 160, masked=True)[0]:.4f} ms; card: {smi}")
    log(f"K2 B={b} n=160 ({k2_launch_shape(b, na, nb, 1, dev)}; q8: "
        f"{k2_launch_shape(b, na, nb, 2, dev)}; f32: {k2_launch_shape(b, na, nb, 0, dev)}): "
        f"bf16 {ms['bf16']:.4f} ms/launch, f32 {ms['f32']:.4f}, q8 "
        f"{ms['q8']:.4f} (one step against the plain version: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"); K1 on the same inputs, free-running (bf16, q8: the cluster kernel's "
        f"free-running form; f32: the first design): "
        f"bf16 {k1_ms['bf16']:.4f}, f32 {k1_ms['f32']:.4f}, q8 {k1_ms['q8']:.4f}; "
        f"plain {p_ms:.2f} ms, bound {bound:.4f} ms ({bound_by}), 15 launches per "
        f"training step with ss_prob > 0; library: no single PyTorch call "
        f"computes K2; card: {smi}")
    return {"name": "sample_loop_masked[bf16]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/masked_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:461",
            "launches": launches, "max_abs_err": step_err, "ms": ms["bf16"],
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "pass": True, "f32_ms": ms["f32"], "q8_ms": ms["q8"],
            "k1_ms_same_inputs": k1_ms, "bf16_ms_b256": wide[256],
            "bf16_ms_b1024": wide[1024]}


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


def profile_step(step, label, smi):
    """One more step (`step()`) of a path under torch.profiler: the device's
    busy share of the step and the kernels that take most of it. Fails where
    the profiler records no device time. Returns (device busy ms, the step's
    ms on the host's clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    kernels = sorted(((dev_time(e) / 1e3, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(ms for ms, _ in kernels)
    assert busy > 0.0, "torch.profiler recorded no device time"
    top = "; ".join(f"{name[:48]} {ms:.2f} ms" for ms, name in kernels[:8])
    log(f"{label} under torch.profiler: {wall_ms:.1f} ms on the host's "
        f"clock (with the profiler's cost), device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %), idle {100 - 100 * busy / wall_ms:.1f}"
        f" %; top kernels: {top}; card: {smi}")
    return busy, wall_ms


def drive_training(dev, smi, workdir):
    """The trainer at full width on the card: TRAIN_STEPS default steps,
    then SS_STEPS with scheduled sampling. Returns (the launch counters read after each
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
    ck = os.path.join(workdir, f"step_{TRAIN_STEPS}")
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
    profile_step(lambda: trainer.train_step(loader[1], rng), "training step",
                 smi)
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


# --------------------------------------------------------------------------
# K3 and K4, and the PLC path
# --------------------------------------------------------------------------

def tf_case(fused, cfg, b, n, nblk, dev, seed):
    """K3's inputs in the shape of the PLC drain: conditioning blocks from
    consecutive frame-network steps, a carried signal state, targets, and
    prefix counts: an eighth of the streams drain two and a half blocks, an
    eighth one and a half, a quarter half a block, half stay frozen."""
    rs = np.random.RandomState(seed)
    r = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    fs = M.init_frame_state(b, cfg, dev)
    cas, cbs, lpcs = [], [], []
    for _ in range(nblk + 2):
        fs, _, ca, cb, lpc = M.frame_network(fused, fs, r(b, 36) * 0.3, cfg)
        cas.append(ca), cbs.append(cb), lpcs.append(lpc)
    s0 = M.init_sample_state(b, cfg, dev)._replace(last_sig=r(b, 16) * 500,
                                                   deemph=r(b) * 200)
    rows = np.array([[n, n, n // 2], [n, n // 2, 0], [n // 2, 0, 0],
                     [n // 2, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
                     [0, 0, 0]], np.int32)[:, :nblk]
    counts = torch.from_numpy(rows[np.arange(b) % 8]).to(dev)
    stack = lambda xs: torch.stack(xs[-nblk:], dim=1).contiguous()
    return (s0, stack(cas), stack(cbs), stack(lpcs), r(b, nblk * n) * 900, counts)


def check_k3(fused, cfg, dev):
    """K3 vs its plain version at B=37 and 256, 3 blocks of 160 steps,
    drain-shaped counts, each form, on K2's packed bundles (a bundle without
    the packs is refused). Bars: RNG equal; a stream that runs no step
    bit-equal in every field; the signal state equal (the closed forms are
    the same PyTorch code on both sides); one step from a shared state
    within 1e-4 (bf16 GRU-B 1e-2: its operand is the new h_a rounded to
    bf16); over the run f32 within 2e-2 and q8 within 5e-2 (the JAX
    package's bars for this kernel), bf16 finite with a mean |h| error under
    1e-2 (teacher forcing feeds both sides the same codes, so a flipped
    operand does not set a stream adrift as it does in K1); RNG equal to
    K2's with the sampler off under the same prefix mask."""
    n, nblk = 160, 3
    bundles = {
        "f32": K.kernel_weights(fused, cfg, dtype=torch.float32),
        "bf16": K.kernel_weights(fused, cfg, dtype=torch.bfloat16),
        "q8": K.kernel_weights(quantize_fused(fused), cfg),
    }
    for b in (37, CHECK_BATCH):
        s0, ca, cb, lpc, tg, counts = tf_case(fused, cfg, b, n, nblk, dev, SEED + 21)
        one = torch.clamp(counts[:, :1], max=1)
        first = (ca[:, :1].contiguous(), cb[:, :1].contiguous(), lpc[:, :1],
                 tg[:, :n], one, n)
        frozen = counts.sum(1) == 0
        for form, bare in bundles.items():
            try:
                K.teacher_force_blocks_kernel(bare, s0, *first)
            except ValueError:
                pass
            else:
                raise AssertionError("K3 took a bundle without K2's packs")
            kw = K.masked_kernel_weights(bare)
            s1k = K.teacher_force_blocks_kernel(kw, s0, *first)
            s1p = K.teacher_force_blocks_plain(kw, s0, *first)
            err_a = float((s1k.gru_a - s1p.gru_a).abs().max())
            err_b = float((s1k.gru_b - s1p.gru_b).abs().max())
            assert err_a <= 1e-4, (form, err_a)
            assert err_b <= (1e-2 if form == "bf16" else 1e-4), (form, err_b)
            sk = K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, counts, n)
            torch.cuda.synchronize()
            sp = K.teacher_force_blocks_plain(kw, s0, ca, cb, lpc, tg, counts, n)
            rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
            sig_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk[2:5], sp[2:5]))
            inert = state_equal(sk, s0, frozen)
            d = torch.cat([(sk.gru_a - sp.gru_a).abs().flatten(),
                           (sk.gru_b - sp.gru_b).abs().flatten()])
            finite = bool(torch.isfinite(sk.gru_a).all() and torch.isfinite(sk.gru_b).all())
            adv = torch.arange(n, device=dev)[None, :] < counts[:, :1]
            s2, _ = K.synthesize_frame_masked_kernel(
                kw, s0, first[0][:, 0], first[1][:, 0], lpc[:, 0].contiguous(),
                tg[:, :n].contiguous(), adv, adv, n, sampled=False)
            s3 = K.teacher_force_prefix_kernel(kw, s0, ca[:, 0], cb[:, 0], lpc[:, 0],
                                               tg[:, :n], counts[:, 0])
            k2_eq = all(bool(torch.equal(a, c)) for a, c in zip(s2.rng, s3.rng))
            k2_err = float((s2.gru_a - s3.gru_a).abs().max())
            log(f"K3[{form}] vs plain, B={b}, {nblk} blocks x {n}: one step max|h_a| "
                f"err {err_a:.3e}, max|h_b| err {err_b:.3e}; run: rng equal {rng_eq}, "
                f"signal state equal {sig_eq}, frozen streams untouched {inert}, "
                f"max|h| err {float(d.max()):.3e}, mean {float(d.mean()):.3e}; vs K2 "
                f"sampled=False on block 0: rng equal {k2_eq}, max|gru_a| apart "
                f"{k2_err:.3e}; launch {k3_launch_shape(b, cfg, form, nblk, dev)}")
            assert rng_eq and sig_eq and inert and finite and k2_eq, form
            if form == "bf16":
                assert float(d.mean()) <= 1e-2, (form, float(d.mean()))
            else:
                assert float(d.max()) <= (5e-2 if form == "q8" else 2e-2), form
            assert k2_err <= (5e-2 if form == "q8" else 2e-2), (form, k2_err)
    log("K3 bars: rng equal (also to K2's), frozen streams bit-equal, one step "
        "1e-4 (bf16 h_b 1e-2), run f32 2e-2 / q8 5e-2 / bf16 mean 1e-2: pass")


def k3_launch_shape(b, cfg, form, nblk, dev):
    """K3's clusters at `b` streams, as the wrapper picks them."""
    f = K.ML.FORMS[form]
    c = K.ML.tf_launch_config(b, cfg.rnn_units1, cfg.rnn_units2, f, nblk,
                              K._max_clusters(dev, f, cfg.rnn_units1, K.KIND_TF))
    return (f"{c['clusters']} clusters of {c['cluster']} x {c['units']} units, "
            f"{c['streams']} streams, {c['smem']} bytes a block, GRU-A "
            f"{'resident' if c['res_a'] else 'from L2'}, GRU-B "
            f"{'resident' if c['res_b'] else 'from L2'}")


def k4_launch_shape(b, cw):
    """K4's clusters at `b` streams, as the wrapper picks them."""
    dev = cw["d1_w"].device
    n_in, nd = cw["d1_w"].shape
    c = PC.chain_launch_config(
        b, n_in, nd, cw["g1_rec"].shape[0], cw["g2_rec"].shape[0], cw["out_w"].shape[1],
        PC._max_clusters(dev), torch.cuda.get_device_properties(dev).multi_processor_count)
    return (f"{c['clusters']} clusters of {PC.CLUSTER} blocks, {c['streams']} streams, "
            f"a weight ring of {c['stages']} chunks of {c['rows']} rows, {c['smem']} bytes "
            f"a block")


def chain_case(plc_params, b, k_steps, dev, seed):
    rs = np.random.RandomState(seed)
    r = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    masks = torch.from_numpy(rs.rand(b, k_steps) < 0.6).to(dev)
    masks[: max(1, b // 8)] = False
    return (PC.plc_chain_weights(plc_params), torch.tanh(r(b, 256)),
            torch.tanh(r(b, 256)), r(b, k_steps, PM.PLC_INPUT_SIZE) * 0.5, masks)


def check_k4(plc_params, dev):
    """K4 vs its plain version on the demo PLC network at (B, K) = (256, 4),
    (160, 4), (37, 4) and (3, 1) (clusters of 32, 16 and 8 streams): states
    after every step within 2e-5, outputs within 2e-4 (the JAX package's
    bars), frozen streams' states exact, two runs bit-equal."""
    for b, k in ((CHECK_BATCH, 4), (160, 4), (37, 4), (3, 1)):
        cw, h1, h2, inputs, masks = chain_case(plc_params, b, k, dev, SEED + 23)
        got = PC.plc_chain_kernel(cw, h1, h2, inputs, masks, k)
        torch.cuda.synchronize()
        want = PC.plc_chain_plain(cw, h1, h2, inputs, masks, k)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        fro = ~masks.any(dim=1)
        inert = (bool(torch.equal(got[0][fro], h1[fro, None].expand(-1, k, -1)))
                 and bool(torch.equal(got[1][fro], h2[fro, None].expand(-1, k, -1))))
        again = PC.plc_chain_kernel(cw, h1, h2, inputs, masks, k)
        biteq = all(bool(torch.equal(a, c)) for a, c in zip(got, again))
        log(f"K4 vs plain, B={b} K={k}: max err h1 {errs[0]:.3e}, h2 {errs[1]:.3e} "
            f"(tol 2e-5), outputs {errs[2]:.3e} (tol 2e-4); frozen streams exact "
            f"{inert}; bit-equal twice {biteq}; launch {k4_launch_shape(b, cw)}")
        assert errs[0] <= 2e-5 and errs[1] <= 2e-5 and errs[2] <= 2e-4, errs
        assert bool(fro.any()) and inert and biteq


def check_decoder_preload(dev):
    """A teacher-forced frame through the decoder goes through K2 with the
    sampler off: PCM equal to the plain model's, RNG in lockstep."""
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    b = 64
    dec = LPCNetDecoder.from_fused(fused, cfg, b, device=dev)
    rs = np.random.RandomState(SEED + 25)
    fs, ss = dec.frame_state, dec.sample_state
    before = K.synthesize_frame_masked_kernel.launches
    live = 0
    for k in range(4):
        feats = features(b, 1, SEED + 30 + k)[0]
        target = (rs.normal(size=(b, 160)) * 2000).astype(np.float32)
        pcm = dec.synthesize(feats, preload=target)
        fs, _, ca, cb, lpc = M.frame_network(fused, fs, torch.from_numpy(feats).to(dev), cfg)
        if k < cfg.lookahead:
            assert not pcm.any()
            continue
        ss, want = M.synthesize_frame(fused, ss, ca, cb, lpc,
                                      preload=torch.from_numpy(target).to(dev))
        assert np.array_equal(pcm, want.cpu().numpy().astype(np.int16)), k
        assert all(bool(torch.equal(a, c)) for a, c in zip(dec.sample_state.rng, ss.rng))
        err = float((dec.sample_state.gru_a - ss.gru_a).abs().max())
        assert err <= 2e-2, err
        ss = dec.sample_state
        live += 1
    n = K.synthesize_frame_masked_kernel.launches - before
    assert n == 4, n
    log(f"decoder preload: LPCNetDecoder B={b}, 4 teacher-forced frames through "
        f"K2 (sampled=False), {live} live: pcm equal to M.synthesize_frame("
        f"preload=...), rng equal, max|gru_a| apart {err:.3e} (bf16 kernel vs "
        f"f32 model, tol 2e-2); K2 launches {n}")


def plc_traffic(streams, frames, seed):
    """A seeded speech-like signal per stream (a harmonic source with a
    wandering pitch under a syllable-rate envelope, plus noise; integer
    valued), a loss pattern per stream (10 % of the 20 ms packets, the flag
    held for both frames of a packet; the first two packets arrive; one
    stream in 16 never loses), and FEC feature rows."""
    rs = np.random.RandomState(seed)
    n = frames * 160
    t = np.arange(n) / 16000.0
    u = lambda lo, hi: rs.uniform(lo, hi, (streams, 1))
    f0 = u(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * u(1, 3) * t + u(0, 6)))
    phase = 2 * np.pi * np.cumsum(f0, axis=1) / 16000.0
    sig = sum(np.sin(k * phase) / k for k in range(1, 9))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * u(2, 5) * t + u(0, 6))
    pcm = np.round(4000 * env * sig + 60 * rs.standard_normal((streams, n)))
    lost = rs.rand(streams, frames // 2) < 0.10
    lost[:, :2] = False
    lost[np.arange(streams) % 16 == 15] = False
    lost = np.repeat(lost, 2, axis=1)
    fec = features(streams, frames, seed + 1)[..., :20]         # [frames, B, 20]
    return pcm.astype(np.float32).reshape(streams, frames, 160), lost, fec


@contextlib.contextmanager
def capture_kernel_calls():
    """While active, collects the arguments of every kernel call the PLC step
    makes, {wrapper's name: [arguments, ...]}, through the step's own tap."""
    calls = {"teacher_force_blocks_kernel": [],
             "synthesize_frame_masked_kernel": [], "plc_chain_kernel": []}
    BP.kernel_tap = lambda name, args: calls[name].append(args)
    try:
        yield calls
    finally:
        BP.kernel_tap = None


def reset_plc_counts():
    K.synthesize_frame_masked_kernel.launches = 0
    K.teacher_force_blocks_kernel.launches = 0
    PC.plc_chain_kernel.launches = 0


def plc_counts():
    return (K.synthesize_frame_masked_kernel.launches,
            K.teacher_force_blocks_kernel.launches, PC.plc_chain_kernel.launches)


def drive_plc(dev, smi):
    """The PLC path at full width: PLCStreamPool over the demo vocoder and
    the demo PLC network, 256 streams. Returns (launch counts of the 200
    default frames and of the 50 chain frames, ms per frame of each run,
    the kernels' captured arguments)."""
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    plc_params = api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev)
    total = PLC_FRAMES + PLC_CHAIN_FRAMES
    pcm, lost, fec = plc_traffic(PLC_STREAMS, total, SEED + 27)
    sids = [f"call-{i}" for i in range(PLC_STREAMS)]
    with_fec = [i for i in range(PLC_STREAMS) if i % 4 == 0]

    def tick(pool, k):
        if k % 2 == 0:              # a packet's redundancy: two 10 ms rows
            for j in (k, k + 1):
                pool.fec_add({sids[i]: fec[j, i] for i in with_fec})
        out = pool.step({sid: (None if lost[i, k] else pcm[i, k])
                         for i, sid in enumerate(sids)})
        return np.stack([out[sid] for sid in sids])

    def run(pool, frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [tick(pool, k) for k in frames]
        torch.cuda.synchronize()
        return np.stack(outs, axis=1), 1e3 * (time.perf_counter() - t0) / len(frames)

    pool = PLCStreamPool(fused, cfg, plc_params, capacity=PLC_STREAMS, device=dev)
    assert pool.plc.flags == (True, True, False, "auto") and pool.plc.use_kernel
    assert pool.plc.kw["emb_cat"].dtype == torch.bfloat16
    for sid in sids:
        pool.attach(sid)
    assert pool.n_active == PLC_STREAMS
    reset_plc_counts()
    torch.cuda.reset_peak_memory_stats()
    out, frame_ms = run(pool, range(PLC_FRAMES))
    counts = plc_counts()
    stats = dict(pool.plc.stats)
    clean = ~lost.any(axis=1)
    assert out.shape == (PLC_STREAMS, PLC_FRAMES, 160) and np.isfinite(out).all()
    assert out.min() >= -32768 and out.max() <= 32767
    assert clean.sum() == PLC_STREAMS // 16
    assert np.array_equal(out[clean], pcm[clean, :PLC_FRAMES]), "passthrough"
    concealed = out[lost[:, :PLC_FRAMES]]
    assert concealed.any() and np.array_equal(concealed, np.round(concealed))
    assert counts == (2 * PLC_FRAMES, PLC_FRAMES, 0), counts
    assert sum(stats.values()) == PLC_FRAMES and stats["full"] == 0, stats
    st = pool.plc.state
    assert all(bool(torch.isfinite(x).all()) for x in
               (st.sstate.gru_a, st.features, st.plc_net.gru1, st.pcm_buf))
    assert int(st.fec_read.max()) > 0
    rms_in = float(np.sqrt(np.mean(pcm[lost] ** 2)))
    rms_out = float(np.sqrt(np.mean(concealed ** 2)))
    log(f"PLC path: PLCStreamPool {PLC_STREAMS} streams, {PLC_FRAMES} frames, "
        f"{100 * lost[:, :PLC_FRAMES].mean():.2f} % of frames lost, FEC rows for "
        f"{len(with_fec)} streams: {frame_ms:.3f} ms/frame (host clock, fec_add "
        f"and the dicts included), {10.0 / frame_ms * PLC_STREAMS:.1f} streams x "
        f"real time; frames compacted {stats['compacted']}, overflowed "
        f"{stats['overflowed']} (capacity {BP._compact_capacity(PLC_STREAMS)}); "
        f"K2 launches {counts[0]}, K3 {counts[1]}, K4 {counts[2]}; "
        f"{int(clean.sum())} never-lost streams pass through exactly; concealed "
        f"frames rms {rms_out:.0f} (the lost audio's {rms_in:.0f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {smi}")

    # 50 frames more, the chain kernel on beside off. Concealed audio is
    # sampled through the bf16 bundle, where a 1e-6 difference in the
    # features sets a stream adrift within a frame, and from then on its
    # analysis history and features differ too. So the chain pool takes each
    # frame from the state the default pool had before that frame (states
    # are never written in place), and the two are compared after one frame.
    prev = BP.set_plc_flags(fastchain=True)
    try:
        chain = PLCStreamPool(fused, cfg, plc_params, capacity=PLC_STREAMS, device=dev)
    finally:
        BP.set_plc_flags(*prev)
    for sid in sids:
        chain.attach(sid)
    more = range(PLC_FRAMES, total)
    pre, post_d, out_d = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in more:
        pre.append(pool.plc.state)
        out_d.append(tick(pool, k))
        post_d.append(pool.plc.state)
    torch.cuda.synchronize()
    default_ms = 1e3 * (time.perf_counter() - t0) / len(more)
    reset_plc_counts()
    post_c, out_c = [], []
    with capture_kernel_calls() as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, k in enumerate(more):
            chain.plc.state = pre[i]
            out_c.append(tick(chain, k))
            post_c.append(chain.plc.state)
        torch.cuda.synchronize()
        chain_ms = 1e3 * (time.perf_counter() - t0) / len(more)
    chain_counts = plc_counts()
    assert chain_counts == (2 * PLC_CHAIN_FRAMES, PLC_CHAIN_FRAMES,
                            PLC_CHAIN_FRAMES), chain_counts
    feat_err = net_err = 0.0
    for sd, sc in zip(post_d, post_c):
        for f in ("pcm_fill", "skip_analysis", "loss_count", "fec_len", "fec_read",
                  "fec_keep", "fec_skip", "blend", "feat_count"):
            assert bool(torch.equal(getattr(sd, f), getattr(sc, f))), f
        feat_err = max(feat_err, float((sd.features - sc.features).abs().max()))
        net_err = max(net_err, *(float((a - c).abs().max())
                                 for a, c in zip(sd.plc_net, sc.plc_net)))
    assert feat_err <= 2e-4 and net_err <= 2e-5, (feat_err, net_err)
    out_d, out_c = np.stack(out_d, axis=1), np.stack(out_c, axis=1)
    good = ~lost[:, PLC_FRAMES:]
    assert np.array_equal(out_c[clean], out_d[clean])
    assert np.isfinite(out_c).all()
    far = float((np.abs(out_c - out_d)[~good] > 2).mean())
    log(f"PLC path, {PLC_CHAIN_FRAMES} frames more, chain kernel on vs off, each "
        f"frame from the same state: integer state equal; features within "
        f"{feat_err:.3e} (tol 2e-4), PLC-net state within {net_err:.3e} (tol "
        f"2e-5); lost frames' sampled audio (bf16 bundle) more than 2 apart on "
        f"{100 * far:.2f} % of samples; K2 launches {chain_counts[0]}, K3 "
        f"{chain_counts[1]}, K4 {chain_counts[2]}; {chain_ms:.3f} ms/frame with "
        f"the chain kernel, {default_ms:.3f} without (host clock); card: {smi}")

    # the read of the active count that compaction needs: the same frames
    # with compaction off, from the same state
    prev = BP.set_plc_flags(compact="0")
    try:
        full = PLCStreamPool(fused, cfg, plc_params, capacity=PLC_STREAMS, device=dev)
    finally:
        BP.set_plc_flags(*prev)
    for sid in sids:
        full.attach(sid)
    full.plc.state = pool.plc.state
    again = range(total - PLC_CHAIN_FRAMES, total)
    _, full_ms = run(full, again)
    _, auto_ms = run(pool, again)
    log(f"PLC path, compaction: {auto_ms:.3f} ms/frame with it (one read of the "
        f"active count on the host a frame), {full_ms:.3f} ms/frame with the "
        f"section at the full batch and no read; card: {smi}")
    k = total - 1
    profile_step(lambda: tick(pool, k), "PLC frame", smi)
    reset_plc_counts()
    return counts, chain_counts, frame_ms, calls, (fused, cfg, plc_params)


def k3_bound_ms(kw, cfg, counts, n_blocks, blk):
    """Least time for one K3 launch on this run's counts: the multiply-adds
    of the steps that run (0.46 M a step and stream at full width) over the
    peak of their type, against the bytes: the weights once, and per stream
    the conditioning blocks, three code bytes a step, the counts and the
    state in and out."""
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    macs = na * 3 * na + na * 3 * nb + nb * 3 * nb
    steps = int(counts.sum())
    typ = ("int8" if K.is_q8_bundle(kw) else
           "bf16" if kw["emb_cat"].dtype == torch.bfloat16 else "f32")
    op_s = 2 * macs * steps / PEAK[typ]
    used = [v for k_, v in kw.items() if not k_.startswith(("dual", "logit", "k2_"))]
    weight_bytes = sum(v.numel() * v.element_size() for v in used)
    per_stream = (n_blocks * (4 * (3 * na + 3 * nb) + 3 * blk + 4)
                  + 2 * (4 * (na + nb) + 32))
    byte_s = (weight_bytes + counts.shape[0] * per_stream) / HBM_BPS
    return 1e3 * max(op_s, byte_s), ("operations" if op_s >= byte_s else "bytes")


def k4_bound_ms(cw, b, k_steps):
    """Least time for one K4 launch: 0.70 M float32 multiply-adds a step and
    stream (every step runs, masked or not), against the weights once and
    each stream's inputs, masks, states and outputs."""
    n_in, nd = cw["d1_w"].shape
    n1, n2, n_out = cw["g1_rec"].shape[0], cw["g2_rec"].shape[0], cw["out_w"].shape[1]
    macs = n_in * nd + nd * 3 * n1 + n1 * 3 * n1 + n1 * 3 * n2 + n2 * 3 * n2 + n2 * n_out
    op_s = 2 * macs * b * k_steps / PEAK["f32"]
    byts = (sum(cw[name].numel() * 4 for name in PC._CWNAMES)
            + b * 4 * (k_steps * (n_in + 1 + n1 + n2 + n_out) + n1 + n2))
    byte_s = byts / HBM_BPS
    return 1e3 * max(op_s, byte_s), ("operations" if op_s >= byte_s else "bytes")


def time_host(fn, reps=10):
    """ms per call on the host's clock, synchronised: what an eager sequence
    of small launches costs, whichever of host and device is slower."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def log_frame_rate_pieces(fused, cfg, plc_params, b, smi):
    """The frame-rate pieces of a PLC frame, each alone at the pool's batch,
    with how often the causal step calls it."""
    from lpcnet_torch.codec import features as F
    from lpcnet_torch.dsp.burg import burg_cepstral_analysis
    dev = plc_params["plc_out"]["bias"].device
    rs = np.random.RandomState(SEED + 29)
    pcm = torch.from_numpy((rs.normal(size=(b, 160)) * 2000).astype(np.float32)).to(dev)
    feats = torch.from_numpy(features(b, 4, SEED + 31)).to(dev)      # [4, B, 36]
    enc = F.init_encoder_state(b, dev)
    fs = M.init_frame_state(b, cfg, dev)
    net = PM.init_state(b, device=dev)
    x57 = torch.zeros(b, PM.PLC_INPUT_SIZE, device=dev)
    count = torch.full((b,), 2, dtype=torch.int32, device=dev)
    pieces = {
        "burg_cepstral_analysis (1)": lambda: burg_cepstral_analysis(pcm),
        "compute_single_frame_features (1)":
            lambda: F.compute_single_frame_features(enc, pcm),
        "frame_network (4)": lambda: M.frame_network(fused, fs, feats[0], cfg),
        "frame_network_flush (1)": lambda: M.frame_network_flush(
            fused, fs, feats.transpose(0, 1), count, cfg),
        "compute_plc_pred (5 unchained, 1 chained)":
            lambda: PM.compute_plc_pred(plc_params, net, x57),
    }
    log(f"PLC frame-rate pieces alone, B={b} (host clock, synchronised; calls a "
        f"frame in brackets): "
        + ", ".join(f"{k} {time_host(fn):.3f} ms" for k, fn in pieces.items())
        + f"; card: {smi}")


def state_equal(got, want, rows=slice(None)):
    """Every field of two sample states bit-equal on `rows`."""
    return all(bool(torch.equal(a[rows], c[rows])) for a, c in
               zip(got[:5] + tuple(got.rng), want[:5] + tuple(want.rng)))


def check_k3_captured(a3, where):
    """K3 (bf16) against its plain version on arguments a PLC path gave it:
    RNG and signal state equal, streams with no step untouched, one step
    from the captured state within 1e-4 (GRU-B 1e-2), over the run finite
    with a mean |h| error within 1e-2. Returns (one-step error, run error)."""
    kw, s0, ca, cb, lpc, tg, cnt, n = a3
    one = torch.clamp(cnt, max=1)
    one[:, 1:] = 0
    s1k = K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, one, n)
    s1p = K.teacher_force_blocks_plain(kw, s0, ca, cb, lpc, tg, one, n)
    err_a = float((s1k.gru_a - s1p.gru_a).abs().max())
    err_b = float((s1k.gru_b - s1p.gru_b).abs().max())
    sk = K.teacher_force_blocks_kernel(*a3)
    torch.cuda.synchronize()
    sp = K.teacher_force_blocks_plain(*a3)
    rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
    sig_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk[2:5], sp[2:5]))
    inert = state_equal(sk, s0, cnt.sum(1) == 0)
    d = torch.cat([(sk.gru_a - sp.gru_a).abs().flatten(),
                   (sk.gru_b - sp.gru_b).abs().flatten()])
    finite = bool(torch.isfinite(sk.gru_a).all() and torch.isfinite(sk.gru_b).all())
    log(f"K3[bf16] vs plain on {where}, B={cnt.shape[0]}, "
        f"{cnt.shape[1]} blocks x {n}, {int(cnt.sum())} steps: one step max|h_a| "
        f"err {err_a:.3e} (tol 1e-4), max|h_b| err {err_b:.3e} (tol 1e-2); "
        f"run: rng equal {rng_eq}, signal state equal {sig_eq}, streams with "
        f"no step untouched {inert}, max|h| err {float(d.max()):.3e}, mean "
        f"{float(d.mean()):.3e} (tol 1e-2)")
    assert err_a <= 1e-4 and err_b <= 1e-2, (where, err_a, err_b)
    assert rng_eq and sig_eq and inert and finite, where
    assert float(d.mean()) <= 1e-2, (where, float(d.mean()))
    return max(err_a, err_b), float(d.max())


def check_k2_captured(a2, where):
    """K2 (bf16, sampled) against its plain version on arguments a PLC path
    gave it: RNG equal, streams that do not advance untouched with PCM 0,
    teacher-forced samples exact, one step within 1e-4 (GRU-B 1e-2), over
    the call finite, at least 95 % of the advancing streams' PCM exact and
    its RMS within 0.5 of the plain version's. Returns the one-step error."""
    kw, s0, ca, cb, lpc, tg, tf, adv, n = a2
    first = (kw, s0, ca, cb, lpc, tg[:, :1].contiguous(),
             tf[:, :1].contiguous(), adv[:, :1].contiguous(), 1)
    s1k, _ = K.synthesize_frame_masked_kernel(*first)
    s1p, _ = K.sample_loop_masked_plain(*first)
    err_a = float((s1k.gru_a - s1p.gru_a).abs().max())
    err_b = float((s1k.gru_b - s1p.gru_b).abs().max())
    sk, pk = K.synthesize_frame_masked_kernel(*a2)
    torch.cuda.synchronize()
    sp, pp = K.sample_loop_masked_plain(*a2)
    live = adv.any(dim=1)
    rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
    inert = state_equal(sk, s0, ~live) and not bool(pk[~adv].any())
    tf_eq = bool(torch.equal(pk[tf], pp[tf]))
    finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
    same = float((pk == pp)[live].float().mean()) if bool(live.any()) else 1.0
    rms_k, rms_p = ((float(v[live].square().mean().sqrt()) if bool(live.any())
                     else 0.0) for v in (pk, pp))
    log(f"K2[bf16] vs plain on {where}, B={adv.shape[0]} n={n}, "
        f"{int(live.sum())} streams advancing, {int(tf.any(dim=1).sum())} of "
        f"them teacher-forced: one step max|h_a| err {err_a:.3e} (tol 1e-4), "
        f"max|h_b| err {err_b:.3e} (tol 1e-2); call: rng equal {rng_eq}, other "
        f"streams untouched with pcm 0 {inert}, teacher-forced pcm exact "
        f"{tf_eq}, advancing streams' exact pcm {same:.4f} (bar 0.95), rms "
        f"{rms_k:.1f} vs {rms_p:.1f}")
    assert err_a <= 1e-4 and err_b <= 1e-2, (where, err_a, err_b)
    assert rng_eq and inert and tf_eq and finite, where
    assert same >= 0.95, (where, same)
    assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5, (where, rms_k, rms_p)
    return max(err_a, err_b)


def check_plc_captured(a3, k2_calls, a4):
    """K3, both K2 calls and K4 against their plain versions on arguments
    the causal PLC path gave them in one frame (`check_k3_captured`,
    `check_k2_captured`). K4: states within 2e-5, outputs within 2e-4,
    frozen streams' states exact. Returns (K3's one-step and run error, each
    K2 call's one-step error, K4's error)."""
    k3_errs = check_k3_captured(a3, "the PLC path's arguments")
    k2_errs = [check_k2_captured(a2, f"the PLC path's arguments ({which})")
               for which, a2 in zip(("head", "tail"), k2_calls)]

    cw, h1, h2, inputs, masks, k_steps = a4
    got = PC.plc_chain_kernel(*a4)
    torch.cuda.synchronize()
    want = PC.plc_chain_plain(*a4)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    fro = ~masks.any(dim=1)
    inert = (bool(torch.equal(got[0][fro], h1[fro, None].expand(-1, k_steps, -1)))
             and bool(torch.equal(got[1][fro], h2[fro, None].expand(-1, k_steps, -1))))
    log(f"K4 vs plain on the PLC path's arguments, B={h1.shape[0]} K={k_steps}, "
        f"{int((~fro).sum())} streams with a step: max err h1 {errs[0]:.3e}, h2 "
        f"{errs[1]:.3e} (tol 2e-5), outputs {errs[2]:.3e} (tol 2e-4); frozen "
        f"streams exact {inert}")
    assert errs[0] <= 2e-5 and errs[1] <= 2e-5 and errs[2] <= 2e-4, errs
    assert inert
    return k3_errs, k2_errs, max(errs)


def time_plc_kernels(calls, models, counts, chain_counts, frame_ms, smi):
    """K3, K4 and K2 alone, on arguments the PLC path gave them (the frame
    of the captured 50 whose drain ran the most steps): each held against
    its plain version there, then timed, with its bound; the unchained path
    beside K4; the frame's split. Returns K2's times and one-step errors on
    this path, and the kernels line's entries for K3 and K4."""
    fused, cfg, plc_params = models
    k3_calls = calls["teacher_force_blocks_kernel"]
    k2_calls = calls["synthesize_frame_masked_kernel"]
    busiest = max(range(len(k3_calls)), key=lambda i: int(k3_calls[i][6].sum()))
    a3 = k3_calls[busiest]
    a4 = calls["plc_chain_kernel"][busiest]
    k2_pair = k2_calls[2 * busiest:2 * busiest + 2]
    (k3_step_err, k3_err), k2_errs, k4_err = check_plc_captured(a3, k2_pair, a4)
    kw, s0, ca, cb, lpc, tg, cnt, blk = a3
    b3, nblk = cnt.shape
    codes, _ = K.tf_codes(s0, lpc, tg, cnt, blk)
    k3_ms = time_cuda(lambda: K.tf_launch(kw, s0, ca, cb, cnt, codes, blk), reps=20)
    k3_call = time_cuda(lambda: K.teacher_force_blocks_kernel(*a3), reps=10)
    k3_plain = time_cuda(lambda: K.teacher_force_blocks_plain(*a3), reps=1, warmup=0)
    k3_bound, k3_by = k3_bound_ms(kw, cfg, cnt, nblk, a3[7])
    mean_steps = float(np.mean([int(c[6].sum()) for c in k3_calls]))
    k2_ms = [time_cuda(lambda: K.synthesize_frame_masked_kernel(*a2), reps=10)
             for a2 in k2_pair]
    b2, n2 = k2_pair[0][5].shape
    cw, h1, h2, inputs, masks, k_steps = a4
    k4_ms = time_cuda(lambda: PC.plc_chain_kernel(*a4), reps=20)
    k4_plain = time_cuda(lambda: PC.plc_chain_plain(*a4), reps=3, warmup=1)
    k4_bound, k4_by = k4_bound_ms(cw, h1.shape[0], k_steps)

    def unchained():
        st = PM.PLCNetState(h1, h2)
        for k in range(k_steps):
            new, _ = PM.compute_plc_pred(plc_params, st, inputs[:, k])
            st = BP._bwhere(masks[:, k], new, st)
        return st

    un_ms = time_cuda(unchained, reps=20)
    longest = int(max(len(w) for w in K.ML.tf_step_budget(
        cnt.cpu(), K.ML.tf_launch_config(b3, cfg.rnn_units1, cfg.rnn_units2, 1, nblk,
                                         K._max_clusters(cnt.device, 1, cfg.rnn_units1,
                                                         K.KIND_TF))["streams"], blk)[1]))
    log(f"K3[bf16] B={b3} ({nblk} blocks x {blk}, {int(cnt.sum())} steps to run, "
        f"{int((cnt.sum(1) > 0).sum())} streams draining, the busiest cluster "
        f"{longest} dependent steps; mean of the captured frames {mean_steps:.0f} "
        f"steps): the call with its closed forms in PyTorch {k3_call:.4f} ms/launch "
        f"(the kernels line's ms, as earlier runs timed K3), the launch alone "
        f"{k3_ms:.4f} ms ({1e3 * k3_ms / max(longest, 1):.3f} us a dependent step), plain {k3_plain:.2f} ms, bound {k3_bound:.5f} ms "
        f"({k3_by}), 1 launch per frame; library: no single PyTorch call computes "
        f"K3; launch {k3_launch_shape(b3, cfg, 'bf16', nblk, cnt.device)}; card: {smi}")
    log(f"K4 B={h1.shape[0]} K={k_steps}: kernel {k4_ms:.4f} ms/launch, plain "
        f"{k4_plain:.3f} ms, bound {k4_bound:.5f} ms ({k4_by}), 1 launch per "
        f"frame with fastchain, else 0; the unchained path's {k_steps} masked "
        f"compute_plc_pred calls {un_ms:.4f} ms; library: no single PyTorch "
        f"call computes K4; launch {k4_launch_shape(h1.shape[0], cw)}; card: {smi}")
    kernels = k3_call + sum(k2_ms)
    log(f"PLC frame {frame_ms:.3f} ms = K3's call {k3_call:.3f} ms (kernel {k3_ms:.3f} "
        f"ms, closed forms in PyTorch {k3_call - k3_ms:.3f} ms) + K2 head "
        f"{k2_ms[0]:.3f} ms + K2 tail {k2_ms[1]:.3f} ms (B={b2}, n={n2}; CUDA "
        f"events, alone, on the busiest captured frame's arguments) + frame-rate "
        f"rest and host {frame_ms - kernels:.3f} ms "
        f"({100 * (frame_ms - kernels) / frame_ms:.1f} %); card: {smi}")
    log_frame_rate_pieces(fused, cfg, plc_params, h1.shape[0], smi)
    src = "lpcnet_torch/kernels/csrc/"
    return k2_ms, k2_errs, [
        {"name": "teacher_force[bf16]", "route": "cuda",
         "source": src + "masked_loop.cu",
         "replaces": "lpcnet_tpu/kernels/sample_loop.py:785",
         "launches": counts[1] + chain_counts[1], "max_abs_err": k3_err,
         "one_step_err": k3_step_err, "ms": k3_call, "kernel_ms": k3_ms,
         "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": None, "pass": True,
         "design": "masked_loop_kernel<FORM, NT, KIND_TF>: K2's clusters, teacher-forced; "
                   + k3_launch_shape(b3, cfg, "bf16", nblk, cnt.device)},
        {"name": "plc_chain", "route": "cuda", "source": src + "plc_chain.cu",
         "replaces": "lpcnet_tpu/kernels/plc_chain.py:89",
         "launches": chain_counts[2], "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": None, "pass": True,
         "design": "chain_cluster_kernel<S>: the units split over 8 ranks, weights "
                   "streamed by TMA; " + k4_launch_shape(h1.shape[0], cw)},
    ]


# --------------------------------------------------------------------------
# The non-causal PLC path, the two-path steps and the host PLC
# --------------------------------------------------------------------------

def plc_ticker(pool, pcm, lost, sids):
    """One 10 ms tick of `pool` on frame k of the traffic -> [B, 160]."""
    def tick(k):
        out = pool.step({sid: (None if lost[i, k] else pcm[i, k])
                         for i, sid in enumerate(sids)})
        return np.stack([out[sid] for sid in sids])
    return tick


def delayed_exact(out, pcm, rows):
    """The non-causal mode's output of `rows` equals their input 80 samples
    late, bit for bit, from the second frame on; returns the largest
    difference."""
    got = out[rows].reshape(int(rows.sum()), -1)[:, 80:]
    want = pcm[rows].reshape(int(rows.sum()), -1)[:, :got.shape[1]]
    return float(np.abs(got - want).max())


def drive_nc_plc(dev, smi):
    """The non-causal PLC path at full width: PLCStreamPool(non_causal=True)
    over the demo vocoder's weights under LPCNetConfig(lookahead=0) and the
    demo PLC network, 256 streams, then a pool with the DC filter. Returns
    (launch counts of the default run, its ms per frame, its captured kernel
    calls grouped per frame, the DC pool's ms per frame, the models)."""
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    cfg0 = dataclasses.replace(cfg, lookahead=0)
    plc_params = api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev)
    pcm, lost, _ = plc_traffic(NC_STREAMS, NC_FRAMES, SEED + 43)
    sids = [f"call-{i}" for i in range(NC_STREAMS)]
    clean = ~lost.any(axis=1)

    pool = PLCStreamPool(fused, cfg0, plc_params, capacity=NC_STREAMS,
                         non_causal=True, device=dev)
    st = pool.plc.state
    assert pool.plc.use_kernel and pool.plc.flags.fasttf
    assert pool.plc.plc_buf_size == 80 and st.plc_ring.gru1.shape[0] == 1
    for sid in sids:
        pool.attach(sid)
    tick = plc_ticker(pool, pcm, lost, sids)
    per_frame, outs = [], []
    reset_plc_counts()
    with capture_kernel_calls() as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(NC_FRAMES):
            before = plc_counts()
            outs.append(tick(k))
            per_frame.append(tuple(a - c for a, c in zip(plc_counts(), before)))
        torch.cuda.synchronize()
        frame_ms = 1e3 * (time.perf_counter() - t0) / NC_FRAMES
    counts = plc_counts()
    stats = dict(pool.plc.stats)
    out = np.stack(outs, axis=1)
    assert out.shape == (NC_STREAMS, NC_FRAMES, 160) and np.isfinite(out).all()
    assert out.min() >= -32768 and out.max() <= 32767
    assert clean.sum() >= NC_STREAMS // 16
    worst = delayed_exact(out, pcm, clean)
    assert worst == 0.0, ("never-lost streams not 80 samples late", worst)
    assert set(per_frame) == {(2, 3, 0)}, collections.Counter(per_frame)
    assert counts == (2 * NC_FRAMES, 3 * NC_FRAMES, 0), counts
    assert sum(stats.values()) == NC_FRAMES and stats["compacted"] > 0, stats
    concealed = out[lost]
    assert concealed.any() and np.array_equal(concealed, np.round(concealed))
    st = pool.plc.state
    assert all(bool(torch.isfinite(x).all()) for x in
               (st.sstate.gru_a, st.features, st.plc_net.gru1, st.pcm_buf))
    rms_in = float(np.sqrt(np.mean(pcm[lost] ** 2)))
    rms_out = float(np.sqrt(np.mean(concealed ** 2)))
    log(f"non-causal PLC path: PLCStreamPool(non_causal=True) {NC_STREAMS} "
        f"streams, the demo vocoder under lookahead 0, {NC_FRAMES} frames, "
        f"{100 * lost.mean():.2f} % of frames lost: {frame_ms:.3f} ms/frame (host "
        f"clock, the dicts included), {10.0 / frame_ms * NC_STREAMS:.1f} streams "
        f"x real time; K2 launches {counts[0]}, K3 {counts[1]}, K4 {counts[2]} "
        f"(every frame K2 2, K3 3); sections compacted {stats['compacted']}, "
        f"overflowed {stats['overflowed']} (capacity "
        f"{BP._compact_capacity(NC_STREAMS)}); {int(clean.sum())} never-lost "
        f"streams 80 samples late bit for bit; concealed frames rms "
        f"{rms_out:.0f} (the lost audio's {rms_in:.0f}); card: {smi}")
    profile_step(lambda: tick(NC_FRAMES - 1), "non-causal PLC frame", smi)

    dc = PLCStreamPool(fused, cfg0, plc_params, capacity=NC_STREAMS,
                       non_causal=True, remove_dc=True, device=dev)
    for sid in sids:
        dc.attach(sid)
    tick_dc = plc_ticker(dc, pcm + 300.0, lost, sids)
    per_frame, outs = [], []
    reset_plc_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(NC_DC_FRAMES):
        before = plc_counts()
        outs.append(tick_dc(k))
        per_frame.append(tuple(a - c for a, c in zip(plc_counts(), before)))
    torch.cuda.synchronize()
    dc_ms = 1e3 * (time.perf_counter() - t0) / NC_DC_FRAMES
    dc_counts = plc_counts()
    out = np.stack(outs, axis=1)
    worst = delayed_exact(out, pcm[:, :NC_DC_FRAMES] + 300.0, clean)
    assert np.isfinite(out).all() and worst == 0.0, worst
    assert set(per_frame) == {(2, 3, 0)} and dc.plc.stats["compacted"] == 0
    # a never-lost stream's tracker is the C's per-sample recurrence over its
    # input (src/lpcnet_plc.c:404-412), here in float64 on the host
    x = pcm[clean, :NC_DC_FRAMES].reshape(int(clean.sum()), -1) + 300.0
    ref = np.zeros(len(x))
    for i in range(x.shape[1]):
        ref += 0.003 * (x[:, i] - ref)
    dcm = dc.plc.state.dc_mem[torch.from_numpy(clean).to(dev)].cpu().numpy()
    dc_err = float(np.abs(dcm - ref).max())
    assert dc_err < 0.5, dc_err
    log(f"non-causal PLC path with the DC filter (+300 offset): {NC_DC_FRAMES} "
        f"frames, {dc_ms:.3f} ms/frame (host clock; the full-batch program), K2 "
        f"launches {dc_counts[0]}, K3 {dc_counts[1]}; never-lost streams 80 "
        f"samples late bit for bit, their DC trackers within {dc_err:.2e} of "
        f"the float64 recurrence (tol 0.5); card: {smi}")
    reset_plc_counts()
    return counts, frame_ms, calls, dc_counts, dc_ms, (fused, cfg0, plc_params)


def time_nc_kernels(calls, models, counts, frame_ms, smi):
    """K2 and K3 on the arguments of the non-causal frame whose section ran
    the most reverse-time steps (the deferred resync: of the frame that ran
    the most of it): each call held against its plain version
    (`check_k2_captured`, `check_k3_captured`) and timed; K3's launch alone
    and its bound on the full batch's resync; the frame's split. Returns the
    kernels line's additions for K2 and K3."""
    fused, cfg0, plc_params = models
    k3 = calls["teacher_force_blocks_kernel"]
    k2 = calls["synthesize_frame_masked_kernel"]
    frames = len(k2) // 2
    assert len(k3) == 3 * frames
    busiest = max(range(frames), key=lambda f: int(k3[3 * f + 1][6].sum()))
    _, rev, good = k3[3 * busiest:3 * busiest + 3]
    head, tail = k2[2 * busiest:2 * busiest + 2]
    # the busiest frame's recoveries queue their resync for the next frame:
    # the deferred resync is taken from the frame that ran the most of it
    queued = max((k3[3 * f] for f in range(frames)), key=lambda a: int(a[6].sum()))
    named = [("K3 deferred resync", queued), ("K2 first half-frame", head),
             ("K3 reverse-time resynthesis", rev), ("K2 second half-frame", tail),
             ("K3 good streams' resync", good)]
    errs, ms = {}, {}
    for name, a in named:
        where = f"the non-causal path's arguments ({name})"
        errs[name] = (check_k3_captured(a, where) if name.startswith("K3")
                      else (check_k2_captured(a, where), 0.0))
        fn = K.teacher_force_blocks_kernel if name.startswith("K3") else \
            K.synthesize_frame_masked_kernel
        ms[name] = time_cuda(lambda: fn(*a), reps=10)
    kw, s0, ca, cb, lpc, tg, cnt, blk = good
    assert cnt.shape == (NC_STREAMS, 1) and blk == 160
    codes, _ = K.tf_codes(s0, lpc, tg, cnt, blk)
    good_kernel = time_cuda(lambda: K.tf_launch(kw, s0, ca, cb, cnt, codes, blk), reps=20)
    good_plain = time_cuda(lambda: K.teacher_force_blocks_plain(*good), reps=1, warmup=0)
    good_bound, good_by = k3_bound_ms(kw, cfg0, cnt, 1, blk)
    waves = K.ML.tf_launch_config(
        NC_STREAMS, cfg0.rnn_units1, cfg0.rnn_units2, 1, 1,
        K._max_clusters(cnt.device, 1, cfg0.rnn_units1, K.KIND_TF))["waves"]
    for name, a in named:
        log(f"{name} on the busiest non-causal frame's arguments: "
            f"B={a[1].gru_a.shape[0]}, {ms[name]:.4f} ms a call (CUDA events, "
            f"alone); card: {smi}")
    log(f"K3[bf16] at B={NC_STREAMS}, one block of 160 (the good streams' resync, "
        f"{int(cnt.sum())} steps): the call {ms[named[4][0]]:.4f} ms, the launch alone "
        f"{good_kernel:.4f} ms, plain {good_plain:.2f} ms, bound {good_bound:.5f} ms "
        f"({good_by}); launch {k3_launch_shape(NC_STREAMS, cfg0, 'bf16', 1, cnt.device)}, "
        f"{waves} wave(s); card: {smi}")
    kernels = sum(ms.values())
    log(f"non-causal PLC frame {frame_ms:.3f} ms = "
        + " + ".join(f"{name} {v:.3f}" for name, v in ms.items())
        + f" (the calls with their closed forms, alone) + frame-rate rest and host "
        f"{frame_ms - kernels:.3f} ms ({100 * (frame_ms - kernels) / frame_ms:.1f} "
        f"%); card: {smi}")
    k2_add = {"launches_nc_path": counts[0],
              "ms_nc_path": [ms[named[1][0]], ms[named[3][0]]],
              "max_abs_err_nc_path": max(errs[named[1][0]][0], errs[named[3][0]][0])}
    k3_add = {"launches_nc_path": counts[1],
              "ms_nc_path": [ms[named[0][0]], ms[named[2][0]], ms[named[4][0]]],
              "max_abs_err_nc_path": max(errs[n][1] for n, _ in named
                                         if n.startswith("K3")),
              "kernel_ms_nc_full_batch": good_kernel,
              "plain_ms_nc_full_batch": good_plain,
              "bound_ms_nc_full_batch": good_bound,
              "bound_by_nc_full_batch": good_by}
    return k2_add, k3_add


def drive_two_path(dev, smi):
    """The two-path step (fused_step=False, the reference of the fused one)
    at 256 streams, 10 frames of the PLC traffic in each mode, on the demo
    weights (lookahead 0 for the non-causal mode): never-lost streams exact
    (80 samples late in the non-causal mode). Returns the launch counts."""
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    plc_params = api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev)
    pcm, lost, _ = plc_traffic(NC_STREAMS, TWO_PATH_FRAMES, SEED + 45)
    lost[:, 4:6] |= np.arange(NC_STREAMS)[:, None] % 4 == 1     # a loss for sure
    clean = ~lost.any(axis=1)
    all_counts = {}
    for mode in ("causal", "non-causal"):
        nc = mode == "non-causal"
        c = dataclasses.replace(cfg, lookahead=0) if nc else cfg
        plc = BP.BatchedPLC(fused, c, plc_params, NC_STREAMS, non_causal=nc,
                            fused_step=False, device=dev)
        reset_plc_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plc.run(pcm, lost)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TWO_PATH_FRAMES
        counts = plc_counts()
        all_counts[mode] = counts
        assert np.isfinite(out).all() and out[lost].any()
        if nc:
            assert delayed_exact(out, pcm, clean) == 0.0
        else:
            assert np.array_equal(out[clean], pcm[clean])
        assert counts[0] > 0 and counts[2] == 0, counts
        log(f"two-path step [{mode}]: BatchedPLC(fused_step=False) {NC_STREAMS} "
            f"streams, {TWO_PATH_FRAMES} frames: {ms:.3f} ms/frame (host clock, "
            f"outputs on the device until the end), K2 launches {counts[0]}, K3 "
            f"{counts[1]}; {int(clean.sum())} never-lost streams exact; card: {smi}")
    reset_plc_counts()
    return all_counts


def plc_trace_gate(out, ref, lost, delay):
    """test_neural_cref.py's PLC gate: the packets outside a loss-affected
    window (a lost packet and the 2 after it) within 2 of C, int16
    wraparound aware. `delay`: how many samples the C trace lags `out` (the
    non-causal modes' 80, which the driver drops). Returns (packets gated,
    the worst difference among them)."""
    d = np.zeros(len(ref))
    d[delay:] = np.abs(((out[:len(ref) - delay] - ref[delay:].astype(np.float64)
                         + 32768) % 65536) - 32768)
    affected = {p + i for p in np.nonzero(lost)[0].tolist() for i in range(3)}
    gated = [p for p in range(len(lost)) if p not in affected]
    worst = max(float(d[p * 320:(p + 1) * 320].max()) for p in gated)
    return len(gated), worst


def host_plc_on_card(smi):
    """`cli plc` on the card in the four modes, on the C fixture's PLC input
    with its loss pattern written out as a pattern file: int16 of the
    input's length, the clean packets within 2 of C's trace (the causal
    modes on the demo vocoder, the non-causal ones on a seeded lookahead-0
    one; those packets are the input handed through). Returns the K2
    launches of the four runs."""
    from lpcnet_torch import cli
    fx = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures", "neural_cref.npz"))
    reset_plc_counts()
    with tempfile.TemporaryDirectory() as d:
        pin, pat, pout = (os.path.join(d, f) for f in ("in.pcm", "loss.txt", "o.pcm"))
        fx["plc_in_pcm"].astype(np.int16).tofile(pin)
        np.savetxt(pat, fx["plc_lost"].astype(int), fmt="%d")
        for mode, key in (("causal", "causal"), ("causal_dc", "causal_dc"),
                          ("noncausal", "nc"), ("noncausal_dc", "nc_dc")):
            before = K.synthesize_frame_masked_kernel.launches
            t0 = time.perf_counter()
            cli.main(["plc", mode, pat, pin, pout])
            secs = time.perf_counter() - t0
            out = np.fromfile(pout, np.int16)
            assert out.shape == fx["plc_in_pcm"].shape, (mode, out.shape)
            n, worst = plc_trace_gate(out.astype(np.float64), fx[f"plc_{key}_pcm"],
                                      fx["plc_lost"], 80 if key.startswith("nc") else 0)
            launches = K.synthesize_frame_masked_kernel.launches - before
            log(f"cli plc {mode} on the card: {out.size} int16 samples, "
                f"{int(fx['plc_lost'].sum())} of {fx['plc_lost'].size} packets "
                f"lost; {n} clean packets within {worst:.0f} of C (bar 2); K2 "
                f"launches {launches}; {secs:.2f} s; card: {smi}")
            assert worst <= 2 and launches > 0, (mode, worst, launches)
    return K.synthesize_frame_masked_kernel.launches


# --------------------------------------------------------------------------
# K6 and the codec path
# --------------------------------------------------------------------------

def k6_bound_ms(mw, cfg, batch, n):
    """Least time for one K6 launch: K1's multiply-adds (the merged layout
    adds only zeros) over the peak of their type, against the bytes of K6's
    own operands (the merged matrices, zero blocks included, and the
    sampler's tensors) and, per stream, the 4N conditioning, the LPC, the
    state in and out and the PCM."""
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    gru_macs = na * 3 * na + na * 3 * nb + nb * 3 * nb
    steps = batch * n
    typ = "bf16" if mw["a_merged"].dtype == torch.bfloat16 else "f32"
    op_s = (2 * gru_macs * steps / PEAK[typ]
            + 2 * nb * 512 * steps / PEAK["f32"])
    weight_bytes = sum(mw[k].numel() * mw[k].element_size() for k in (
        "a_merged", "b_merged", "dual_w", "dual_bias", "dual_factor",
        "logit_table"))
    per_stream = 4 * (4 * na + 4 * nb + 16 + 2 * (na + nb + 16 + 1 + 1)
                      + n) + 2 * (4 * 8 + 4)
    byte_s = (weight_bytes + batch * per_stream) / HBM_BPS
    return 1e3 * max(op_s, byte_s), ("operations" if op_s >= byte_s else "bytes")


def k6_bundles(fused, cfg):
    """{form: (K1 bundle with its packs, K6 operands)} for f32 and bf16."""
    out = {}
    for form, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kw = K.kernel_weights(fused, cfg, dtype=dt)
        out[form] = (K.masked_kernel_weights(kw), K.merged_kernel_weights(kw))
    return out


def check_k6(fused, cfg, dev):
    """K6 vs its plain version at 256 streams, 32 steps, f32 and bf16, at
    K1's bars; after one step also against K1's kernel on the same inputs."""
    ca, cb, lpc = conditioning(fused, cfg, CHECK_BATCH, dev)
    s0 = M.init_sample_state(CHECK_BATCH, cfg, dev)
    res = {}
    for form, (kw, mw) in k6_bundles(fused, cfg).items():
        s1k, _ = K.synthesize_frame_merged_kernel(mw, s0, ca, cb, lpc, 1)
        s1p, _ = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, 1)
        s11, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
        tol_b = 1e-2 if form == "bf16" else 1e-4
        errs = {}
        for name, other in (("plain", s1p), ("K1", s11)):
            ea = float((s1k.gru_a - other.gru_a).abs().max())
            eb = float((s1k.gru_b - other.gru_b).abs().max())
            assert ea <= 1e-4 and eb <= tol_b, (form, name, ea, eb)
            errs[name] = (ea, eb)
        sk, pk = K.synthesize_frame_merged_kernel(mw, s0, ca, cb, lpc, CHECK_STEPS)
        torch.cuda.synchronize()
        sp, pp = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, CHECK_STEPS)
        same = float((pk == pp).float().mean())
        rng_eq = all(bool(torch.equal(a, b)) for a, b in zip(sk.rng, sp.rng))
        err = float((sk.gru_a - sp.gru_a).abs().max())
        finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
        rms_k, rms_p = (float(x.square().mean().sqrt()) for x in (pk, pp))
        res[form] = dict(same=same, rng=rng_eq, err=err, finite=finite)
        log(f"K6[{form}] vs plain, B={CHECK_BATCH}: one step max|h_a|, max|h_b| "
            f"err {errs['plain'][0]:.3e}, {errs['plain'][1]:.3e} (against K1's "
            f"kernel {errs['K1'][0]:.3e}, {errs['K1'][1]:.3e}; tol 1e-4, bf16 "
            f"h_b 1e-2); n={CHECK_STEPS}: exact pcm {same:.4f}, rng equal "
            f"{rng_eq}, max|gru_a| err {err:.3e}, finite {finite}, rms "
            f"{rms_k:.1f} vs {rms_p:.1f}")
        assert rng_eq and finite, form
        if form == "f32":
            assert same >= 0.98 and err <= 2e-2, res[form]
        else:
            assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5, (rms_k, rms_p)
    log("K6 bars: f32 >=98% exact & err<=2e-2, bf16 rms within 0.5, rng equal, "
        "finite: pass")


def check_k6_main_shape(kw, mw, st, ca, cb, lpc, form):
    """K6 vs its plain version at the main shapes (B=1024, n=160) from the
    live state the codec path left, and one step against K1's kernel, at
    K1's main-shape bars (`check_k1_main_shape`), and the share of exact PCM
    over the frame: f32 at least 95 %; bf16 is logged beside K1's own share
    against K1's plain version on the same inputs (its bar is the RMS, as
    K1's: an h_a one f32 bit apart can round to the neighbouring bf16
    operand and set a stream apart). Returns the largest one-step error
    against the plain version."""
    s1k, _ = K.synthesize_frame_merged_kernel(mw, st, ca, cb, lpc, 1)
    s1p, _ = K.sample_loop_merged_plain(mw, st, ca, cb, lpc, 1)
    s11, _ = K.synthesize_frame_kernel(kw, st, ca, cb, lpc, 1)
    err_a = float((s1k.gru_a - s1p.gru_a).abs().max())
    err_b = float((s1k.gru_b - s1p.gru_b).abs().max())
    k1_a = float((s1k.gru_a - s11.gru_a).abs().max())
    k1_b = float((s1k.gru_b - s11.gru_b).abs().max())
    sk, pk = K.synthesize_frame_merged_kernel(mw, st, ca, cb, lpc)
    torch.cuda.synchronize()
    sp, pp = K.sample_loop_merged_plain(mw, st, ca, cb, lpc)
    same = float((pk == pp).float().mean())
    apart = int((pk != pp).any(dim=1).sum())
    rms_k, rms_p = (float(x.square().mean().sqrt()) for x in (pk, pp))
    rng_eq = all(bool(torch.equal(a, b)) for a, b in zip(sk.rng, sp.rng))
    finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
    _, pk1 = K.synthesize_frame_kernel(kw, st, ca, cb, lpc)
    torch.cuda.synchronize()
    _, pp1 = K.sample_loop_plain(kw, st, ca, cb, lpc)
    same_k1 = float((pk1 == pp1).float().mean())
    log(f"K6[{form}] vs plain, B={ca.shape[0]} n={pk.shape[1]}, live state: "
        f"one step max|h_a| err {err_a:.3e}, max|h_b| err {err_b:.3e} (against "
        f"K1's kernel {k1_a:.3e}, {k1_b:.3e}); frame: exact pcm {same:.4f} (bar "
        f"0.95 {'held' if same >= 0.95 else 'missed'}; K1 vs its plain version on "
        f"the same inputs {same_k1:.4f}), streams apart {apart}, rms {rms_k:.1f} vs "
        f"{rms_p:.1f}, rng equal {rng_eq}, finite {finite}")
    tol_b = 1e-2 if form == "bf16" else 1e-4
    assert err_a <= 1e-4 and k1_a <= 1e-4 and rng_eq and finite, form
    assert err_b <= tol_b and k1_b <= tol_b, form
    assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5, form
    if form == "f32":
        assert same >= 0.95, (form, same)
    return max(err_a, err_b)


def codec_pcm(streams, superframes):
    """The PLC path's seeded speech-like signal, int16-valued: [B, T*640]."""
    pcm, _, _ = plc_traffic(streams, 4 * superframes, SEED + 41)
    return np.clip(pcm.reshape(streams, -1), -32768, 32767)


def drive_codec(dev, smi):
    """The codec path at full width: LPCNetEncoder on 1024 streams of the
    seeded signal for 10 superframes, then the packets through two
    StreamPool(capacity=1024).step_packets on the demo vocoder, 10 ticks with
    the merged flag off (K1) and 10 with it on (K6), taken in turn. Returns ({"K1"|"K6":
    the run's pcm, ms per tick, pool and launches}, the timed parts)."""
    from lpcnet_torch.codec import decoder as CD
    b, n_sf = CODEC_STREAMS, CODEC_SUPERFRAMES
    pcm = codec_pcm(b, n_sf)
    # one superframe on a throwaway encoder first: the first calls at these
    # shapes set up cuFFT plans and cuBLAS workspaces
    api.lpcnet_encode(api.lpcnet_encoder_create(batch=b), pcm[:, :640])
    enc = api.lpcnet_encoder_create(batch=b)
    packets, quantized = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n_sf):
        packets.append(api.lpcnet_encode(enc, pcm[:, t * 640:(t + 1) * 640]))
        quantized.append(enc.quantized)
    enc_ms = 1e3 * (time.perf_counter() - t0) / n_sf
    log(f"codec encode: LPCNetEncoder B={b}, {n_sf} superframes: {enc_ms:.3f} "
        f"ms/superframe ({b * 40.0 / enc_ms:.1f} streams x real time); card: {smi}")

    # the card's decode of the card's packets reproduces the quantized
    # cepstrum and pitch (the JAX round-trip bar, 1e-5)
    cbs = enc.cbs
    vq = torch.zeros(b, 18, device=dev)
    err = 0.0
    for t in range(n_sf):
        fields = {k: torch.as_tensor(v, device=dev)
                  for k, v in P.unpack_fields(packets[t]).items()}
        feats, vq = CD.decode_packet_features(fields, vq, cbs)
        err = max(err, float((feats[..., :20] - quantized[t][..., :20]).abs().max()))
    log(f"codec round trip on the card: decoded features vs the encoder's "
        f"quantized ones, max err {err:.3e} (tol 1e-5)")
    assert err <= 1e-5, err

    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    sids = [f"call-{i}" for i in range(b)]
    # two pools, the merged flag off (K1) and on (K6), their ticks taken in
    # turn (off, on, off, on, ...) so that the host's drift over the run
    # falls on both alike; the flag is read at each frame's launch
    pools, attach_ms, out, ticks, counts = {}, {}, {}, {}, {}
    for flag in (False, True):
        pools[flag] = api.StreamPool(fused, cfg, capacity=b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for sid in sids:                     # a call's set-up, not a tick
            pools[flag].attach(sid)
        torch.cuda.synchronize()
        attach_ms[flag] = 1e3 * (time.perf_counter() - t0)
        out[flag], ticks[flag], counts[flag] = [], [], np.zeros(3, int)
    prev = K.set_merged(False)
    try:
        for t in range(n_sf):
            for flag in (False, True):
                K.set_merged(flag)
                K.synthesize_frame_kernel.launches = 0
                K.synthesize_frame_merged_kernel.launches = 0
                K.synthesize_frame_masked_kernel.launches = 0
                t0 = time.perf_counter()
                got = pools[flag].step_packets(
                    {sid: packets[t][i] for i, sid in enumerate(sids)})
                out[flag].append(np.stack([got[sid] for sid in sids]))
                ticks[flag].append(1e3 * (time.perf_counter() - t0))
                counts[flag] += (K.synthesize_frame_kernel.launches,
                                 K.synthesize_frame_merged_kernel.launches,
                                 K.synthesize_frame_masked_kernel.launches)
    finally:
        K.set_merged(prev)
    runs = {}
    for flag in (False, True):
        name = "K6" if flag else "K1"
        pool, k1, k6, k2 = pools[flag], *(int(c) for c in counts[flag])
        assert (k1, k6, k2) == ((0, 4 * n_sf, 0) if flag else (4 * n_sf, 0, 0)), (k1, k6, k2)
        pcm_out = np.stack(out[flag])                 # [ticks, B, 640]
        assert pcm_out.dtype == np.int16 and pcm_out.shape == (n_sf, b, 640)
        la = cfg.lookahead
        assert not pcm_out[0, :, :la * 160].any(), f"{name}: warmup not silent"
        assert pcm_out[1:].any(axis=(0, 2)).all(), f"{name}: a stream stayed silent"
        # the tick's own time: the mean of ticks 2-10 (the first also sets
        # up the frame network's and the decode's first calls on this pool)
        tk = ticks[flag]
        tick_ms = float(np.mean(tk[1:]))
        runs[name] = dict(pcm=pcm_out, tick_ms=tick_ms, pool=pool, launches=k1 + k6)
        log(f"codec decode [{name}, flag {'on' if flag else 'off'}]: StreamPool "
            f"B={b}, {n_sf} ticks of 40 ms, in turn with the other pool's: "
            f"{tick_ms:.3f} ms/tick (ticks 2-{n_sf}, host clock, PCM on the host; "
            f"range {min(tk[1:]):.3f}-{max(tk[1:]):.3f}; first tick {tk[0]:.3f}), "
            f"{40.0 / tick_ms * b:.1f} streams x real time; {b} attaches before "
            f"the first tick {attach_ms[flag]:.1f} ms; launches K1 {k1}, K6 {k6}, K2 "
            f"{k2}; warmup silent, int16, non-zero after; card: {smi}")
    rms = {k: float(np.sqrt(np.mean(v["pcm"][1:].astype(np.float64) ** 2)))
           for k, v in runs.items()}
    rel = abs(rms["K6"] - rms["K1"]) / max(rms["K1"], 1.0)
    log(f"codec decode flag on vs off: rms {rms['K6']:.1f} vs {rms['K1']:.1f} "
        f"(rel {rel:.4f}, bf16 bar 0.5)")
    assert rel < 0.5, rms

    # a tick's parts, each alone at the pool's batch (CUDA events)
    pool = runs["K6"]["pool"]
    dec = pool.dec
    fields = {k: torch.as_tensor(v, device=dev)
              for k, v in P.unpack_fields(packets[-1]).items()}
    dpf_ms = time_cuda(lambda: CD.decode_packet_features(fields, dec.vq_mem, cbs),
                       reps=20)
    f0 = torch.from_numpy(features(b, 1, SEED + 43)[0]).to(dev)
    fn_ms = time_cuda(lambda: M.frame_network(dec.fused, dec.frame_state, f0, cfg),
                      reps=20)
    host_parts = time_host(lambda: P.unpack_fields(packets[-1]), reps=20)
    return runs, dict(enc_ms=enc_ms, dpf_ms=dpf_ms, fn_ms=fn_ms,
                      unpack_ms=host_parts, round_trip_err=err)


def codec_fixture_on_card(smi):
    """The C fixture's speech through LPCNetEncoder on the card (one
    stream): how many of its 50 packets are bit-exact; then one `cli encode`
    -> `cli decode` of that file on the card."""
    from lpcnet_torch import cli
    fix = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "fixtures", "codec.npz"))
    want = fix["packets"]
    enc = api.lpcnet_encoder_create()
    got = np.stack([api.lpcnet_encode(enc, fix["pcm"][t * 640:(t + 1) * 640])
                    for t in range(want.shape[0])])
    match = np.all(got == want, axis=1)
    log(f"codec fixture on the card: {int(match.sum())}/{len(match)} packets "
        f"bit-exact against the C encoder; rows apart {np.where(~match)[0].tolist()}")
    with tempfile.TemporaryDirectory() as d:
        pin, bits, pout = (os.path.join(d, f) for f in ("in.pcm", "x.lpcnet", "o.pcm"))
        fix["pcm"].astype(np.int16).tofile(pin)
        t0 = time.perf_counter()
        cli.main(["encode", pin, bits])
        cli.main(["decode", bits, pout])
        secs = time.perf_counter() - t0
        pk = np.fromfile(bits, np.uint8).reshape(-1, 8)
        out = np.fromfile(pout, np.int16)
    assert np.array_equal(pk, got), "cli encode differs from the API's packets"
    assert out.shape == (len(pk) * 640,) and not out[:320].any() and out[320:].any()
    log(f"cli encode -> decode on the card: {len(pk)} packets, {out.size} "
        f"samples, {secs:.2f} s; card: {smi}")
    return int(match.sum())


def time_k6(runs, parts, dev, smi):
    """K6 and K1 at the main shapes (B=1024, n=160) from the live state of
    the K6 pool, f32 and bf16 on the same inputs: held against the plain
    version, then timed with their bounds; then the decode tick's split.
    Returns the kernels line's entry for K6 (bf16)."""
    pool = runs["K6"]["pool"]
    dec = pool.dec
    cfg = dec.cfg
    st = dec.sample_state
    ca, cb, lpc = conditioning(dec.fused, cfg, CODEC_STREAMS, dev)
    bundles = k6_bundles(dec.fused, cfg)
    res = {}
    for form, (kw, mw) in bundles.items():
        err = check_k6_main_shape(kw, mw, st, ca, cb, lpc, form)
        k6_ms = time_cuda(lambda: K.synthesize_frame_merged_kernel(mw, st, ca, cb, lpc),
                          reps=10)
        k1_ms = time_cuda(lambda: K.synthesize_frame_kernel(kw, st, ca, cb, lpc),
                          reps=10)
        p_ms = time_cuda(lambda: K.sample_loop_merged_plain(mw, st, ca, cb, lpc),
                         reps=1, warmup=1)
        bound, by = k6_bound_ms(mw, cfg, CODEC_STREAMS, 160)
        k1_bound, _ = k1_bound_ms(kw, cfg, CODEC_STREAMS, 160)
        res[form] = dict(err=err, ms=k6_ms, k1_ms=k1_ms, plain=p_ms, bound=bound, by=by)
        log(f"K6[{form}] B={CODEC_STREAMS} n=160: kernel {k6_ms:.4f} ms/launch, K1 "
            f"on the same inputs {k1_ms:.4f} ms, plain {p_ms:.2f} ms, bound "
            f"{bound:.4f} ms ({by}; K1's {k1_bound:.4f}), 1 launch per 10 ms frame "
            f"with the flag on; library: no single PyTorch call computes K6; "
            f"card: {smi}")
    for name in ("K1", "K6"):
        kern = res["bf16"]["k1_ms" if name == "K1" else "ms"]
        tick = runs[name]["tick_ms"]
        rest = tick - parts["dpf_ms"] - 4 * (parts["fn_ms"] + kern)
        log(f"codec tick [{name}] {tick:.3f} ms = decode_packet_features "
            f"{parts['dpf_ms']:.3f} ms + 4 x frame network {parts['fn_ms']:.3f} ms "
            f"+ 4 x {name} {kern:.3f} ms (CUDA events, alone, B={CODEC_STREAMS}) + "
            f"host rest {rest:.3f} ms ({100 * rest / tick:.1f} %; unpack_fields "
            f"{parts['unpack_ms']:.3f} ms on the host clock); card: {smi}")
    on_off = runs["K6"]["tick_ms"] / runs["K1"]["tick_ms"]
    log(f"codec tick with the merged flag on / off: {on_off:.3f} (K6 runs K1's kernel "
        f"on the merged matrices' blocks); card: {smi}")
    r = res["bf16"]
    return {"name": "sample_loop_merged[bf16]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/masked_loop.cu",
            "design": "K1's kernel of its form on the merged matrices' checked "
                      "non-zero blocks (sample_loop.merged_packs), the 4N "
                      "conditioning converted once a launch: bf16 "
                      "masked_loop_kernel<FORM_BF16, NT, KIND_FREE>, f32 "
                      "ar_kernel<FORM_F32> (csrc/sample_loop.cu)",
            "tick_on_over_off": on_off,
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:554",
            "launches": runs["K6"]["launches"], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain"], "bound_ms": r["bound"],
            "bound_by": r["by"], "library_ms": None, "pass": True,
            "f32_ms": res["f32"]["ms"], "k1_ms_same_inputs": r["k1_ms"],
            "k1_f32_ms_same_inputs": res["f32"]["k1_ms"]}


# --------------------------------------------------------------------------
# DRED
# --------------------------------------------------------------------------

def dred_features(pcm, dev):
    """Per-frame features of [B, frames, 160] pcm, computed on the card by
    the port's encoder: [B, frames, 36] on the host, and ms a frame."""
    b, n, _ = pcm.shape
    # one frame on a throwaway encoder first: cuFFT plans, cuBLAS handles
    api.lpcnet_compute_single_frame_features(
        api.lpcnet_encoder_create(batch=b, device=dev), pcm[:, 0])
    enc = api.lpcnet_encoder_create(batch=b, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [api.lpcnet_compute_single_frame_features(enc, pcm[:, t])
            for t in range(n)]
    return np.stack(rows, axis=1), 1e3 * (time.perf_counter() - t0) / n


def dred_served(params, rcfg, feats, dev):
    """The served step over every dframe of `feats` [B, frames, 20] (a
    tensor on `dev`): DREDEncoder.add_feature_frame twice, then
    decode_qframe of the new latent from the running decoder state. Returns
    (the encoder, decoded frames [B, dframes, 4, 20], ms of each dframe on
    the host's clock, with a synchronise on a card)."""
    from lpcnet_torch.dred.coder import DREDEncoder
    from lpcnet_torch.models import rdovae as RV
    b, n, _ = feats.shape
    sync = torch.cuda.synchronize if feats.is_cuda else (lambda: None)
    enc = DREDEncoder(params, rcfg, batch=b, max_latents=n // 2, device=dev)
    dstate = RV.init_decoder_stream(
        enc.params, torch.zeros(b, rcfg.state_dim, device=dev), rcfg)
    frames, ms = [], []
    with torch.no_grad():
        for d in range(n // 2):
            sync()
            t0 = time.perf_counter()
            enc.add_feature_frame(feats[:, 2 * d])
            enc.add_feature_frame(feats[:, 2 * d + 1])
            dstate, f4 = RV.decode_qframe(enc.params, dstate, enc.z_window[-1], rcfg)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
            frames.append(f4)
    return enc, torch.stack(frames, dim=1), ms


def dred_redundancy(enc, dec, rows, n_frames, q0=9):
    """The redundancy a .fec packet file carries (`cli fec-encode`): each
    dframe's latent quantized at level q0 and decoded alone from its own
    init state; frames [rows, n_frames, 20] in time order."""
    from lpcnet_torch.dred.coder import quantize_latents
    n_d = n_frames // 2
    z = torch.stack(enc.z_window[:n_d], dim=1)[rows]              # [R, n_d, 80]
    st = torch.stack(enc.state_window[:n_d], dim=1)[rows]
    q = np.array([q0], np.int32)
    zq, _ = quantize_latents(enc.params, z.reshape(-1, 1, z.shape[-1]),
                             torch.as_tensor(q, device=z.device), enc.cfg)
    out = dec.decode_all(zq, q, st.reshape(-1, st.shape[-1]))       # [R*n_d, 4, 20]
    # one latent's frames run newest first: [1, 0] are its dframe's two
    return out.reshape(len(rows), n_d, 4, -1)[:, :, [1, 0]].reshape(
        len(rows), n_frames, -1)


def drive_dred(dev, smi):
    """DRED at full width on the card (the demo RDO-VAE, cond 256/256,
    latent 80, state 24): the served step at 1024 streams against the CPU,
    payloads, decode_all, the redundancy into a PLC pool's FEC queues and
    `cli fec-encode` into the host PLC. Returns the {"dred": ...} numbers."""
    from lpcnet_torch.dred import entropy as DE
    from lpcnet_torch.dred.coder import (DREDDecoder, DREDEncoder,
                                         quantize_latents)
    from lpcnet_torch.models import rdovae as RV
    from lpcnet_torch.weights.convert import tree_to
    params, rcfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device=dev)
    b, n = DRED_STREAMS, DRED_FRAMES
    pcm, lost, _ = plc_traffic(b, n, SEED + 51)
    pcm = np.clip(pcm, -32768, 32767)
    feats, feat_ms = dred_features(pcm, dev)
    nf = rcfg.num_features
    feats_dev = torch.from_numpy(feats[..., :nf]).to(dev)
    log(f"DRED features: LPCNetEncoder B={b}, {n} frames on the card: "
        f"{feat_ms:.3f} ms/frame (set-up of this phase); card: {smi}")

    # the served step at 1024 streams; one throwaway dframe first
    dred_served(params, rcfg, feats_dev[:, :2], dev)
    enc, dec_frames, step_ms = dred_served(params, rcfg, feats_dev, dev)
    n_d = n // 2
    z_all = torch.stack(enc.z_window, dim=1)                     # [B, n_d, 80]
    st_all = torch.stack(enc.state_window, dim=1)
    assert z_all.shape == (b, n_d, rcfg.latent_dim)
    assert dec_frames.shape == (b, n_d, rcfg.dec_frames_per_step, nf)
    for x in (z_all, st_all, dec_frames):
        assert bool(torch.isfinite(x).all())
    assert float(st_all.abs().max()) <= 1.0
    steady = step_ms[1:]
    dframe_ms = float(np.median(steady))
    est = RV.init_encoder_stream(b, rcfg, dev)
    f2 = feats_dev[:, :2].reshape(b, -1)
    z0 = enc.z_window[-1]
    dst = RV.init_decoder_stream(enc.params, st_all[:, -1], rcfg)
    with torch.no_grad():
        enc_ms = time_cuda(lambda: RV.encode_dframe(enc.params, est, f2, rcfg), reps=50)
        dec_ms = time_cuda(lambda: RV.decode_qframe(enc.params, dst, z0, rcfg), reps=50)

    def ten_dframes():
        with torch.no_grad():
            for _ in range(10):
                RV.encode_dframe(enc.params, est, f2, rcfg)
                RV.decode_qframe(enc.params, dst, z0, rcfg)
    busy, wall = profile_step(ten_dframes, f"DRED, 10 dframes at B={b}", smi)
    log(f"DRED served step: B={b}, {n_d} dframes (encode_dframe through "
        f"DREDEncoder.add_feature_frame + decode_qframe): {dframe_ms:.3f} ms/dframe "
        f"(median of dframes 2-{n_d}, host clock, a synchronise each; mean "
        f"{np.mean(steady):.3f}, max {max(steady):.3f}; first {step_ms[0]:.3f}) "
        f"against the 20 ms limit, {20.0 / dframe_ms * b:.1f} streams x real time; "
        f"encode_dframe {enc_ms:.4f} ms, decode_qframe {dec_ms:.4f} ms (CUDA "
        f"events, alone); card: {smi}")

    # the same functions on the CPU for the first 8 streams, the same inputs
    c = DRED_CPU_STREAMS
    cpu_params = tree_to(params, "cpu")
    cenc, cframes, _ = dred_served(cpu_params, rcfg, feats_dev[:c].cpu(), "cpu")
    err = {
        "latents": float((z_all[:c].cpu() - torch.stack(cenc.z_window, 1)).abs().max()),
        "init_states": float((st_all[:c].cpu()
                              - torch.stack(cenc.state_window, 1)).abs().max()),
        "decoded_features": float((dec_frames[:c].cpu() - cframes).abs().max())}
    log(f"DRED card vs CPU, {c} streams, all {n_d} dframes: max abs err latents "
        f"{err['latents']:.3e}, init states {err['init_states']:.3e}, decoded "
        f"features {err['decoded_features']:.3e} (tol 1e-4)")
    assert max(err.values()) <= 1e-4, err

    # payloads of 16 streams: entropy-coded and decoded back exactly
    p = DRED_PAYLOAD_STREAMS
    penc = DREDEncoder(params, rcfg, batch=p, device=dev)
    for t in range(n):
        penc.add_feature_frame(feats_dev[:p, t])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = penc.produce_payload(52, q0=9, q1=15)
    pay_enc_ms = 1e3 * (time.perf_counter() - t0) / p
    dec = DREDDecoder(params, rcfg, device=dev)
    batch_feats = dec.decode_all(out["zq"], out["q_ids"], out["state"])
    sizes, pay_dec_ms, batch_err = [], 0.0, 0.0
    for i, payload in enumerate(out["payloads"]):
        zq, pulses, q_ids = DE.decode_payload(payload, penc.fixed_stats,
                                              rcfg.state_dim, rcfg.pvq_num_pulses)
        assert np.array_equal(zq, out["zq"][i]) and np.array_equal(pulses, out["pulses"][i])
        assert np.array_equal(q_ids, out["q_ids"])
        t0 = time.perf_counter()
        got = dec.decode_payload(payload)
        pay_dec_ms += 1e3 * (time.perf_counter() - t0) / p
        want = dec.decode_all(out["zq"][i:i + 1], out["q_ids"], out["state"][i:i + 1])
        assert np.array_equal(got, want), i
        batch_err = max(batch_err, float(np.abs(got[0] - batch_feats[i]).max()))
        sizes.append(len(payload))
    assert batch_err <= 1e-5, batch_err
    log(f"DRED payloads: {p} streams, 52 frames (26 latents, q 9..15): "
        f"{np.mean(sizes):.1f} bytes mean ({min(sizes)}-{max(sizes)}), estimate "
        f"{float(np.mean(out['bits'])) / 8:.1f}; symbols and PVQ pulses decoded "
        f"back exactly, decode_payload's features equal decode_all's of the same "
        f"symbols (against the {p}-stream decode_all {batch_err:.1e}); "
        f"{pay_enc_ms:.3f} ms a payload to encode (produce_payload / {p}), "
        f"{pay_dec_ms:.3f} ms to decode, host clock; card: {smi}")

    # decode_all at 1024 streams on the newest 26 latents
    q_ids = DE.payload_q_ids(26, 9, 15)
    zq_all, _ = quantize_latents(enc.params, z_all[:, -26:],
                                 torch.as_tensor(q_ids, device=dev), rcfg)
    st_last = st_all[:, -1]
    dec.decode_all(zq_all, q_ids, st_last)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_out = dec.decode_all(zq_all, q_ids, st_last)
    decode_all_ms = 1e3 * (time.perf_counter() - t0)
    z_rev = torch.flip(zq_all, dims=(1,))
    with torch.no_grad():
        lat_ms = time_cuda(lambda: dec.decode_latents(z_rev, st_last), reps=5)
    assert all_out.shape == (b, 26 * 4, nf) and np.isfinite(all_out).all()
    log(f"DRED decode_all B={b}, 26 latents: {decode_all_ms:.3f} ms a call (host "
        f"clock, features on the host), {lat_ms:.3f} ms on the device (CUDA "
        f"events, decode_latents); card: {smi}")

    plc = dred_into_plc(enc, dec, pcm, lost, dev, smi)
    host = dred_cli_on_card(smi)
    return {"card": smi, "streams": b, "frames": n, "dframes": n_d,
            "features_ms_per_frame": feat_ms, "ms_per_dframe": dframe_ms,
            "ms_per_dframe_mean": float(np.mean(steady)),
            "ms_per_dframe_max": float(max(steady)), "limit_ms": 20.0,
            "encode_dframe_ms": enc_ms, "decode_qframe_ms": dec_ms,
            "device_busy_ms_10_dframes": busy, "profiled_10_dframes_ms": wall,
            "device_busy_share": busy / wall,
            "cpu_streams": c, "card_vs_cpu_max_abs_err": err,
            "payload_streams": p, "payload_bytes_mean": float(np.mean(sizes)),
            "payload_roundtrip_exact": True, "payload_encode_ms": pay_enc_ms,
            "payload_decode_ms": pay_dec_ms, "decode_all_ms": decode_all_ms,
            "decode_all_device_ms": lat_ms, "plc": plc, "host_plc": host}


def dred_into_plc(enc, dec, pcm, lost, dev, smi):
    """PLCStreamPool at 256 streams over the first 256 DRED streams' pcm and
    the PLC phase's kind of losses, 100 frames; every fourth stream gets its
    DRED-decoded redundancy through fec_add, two rows a 20 ms packet, in
    place of the PLC phase's seeded rows. The loss count after each lost
    frame says how many were concealed from the redundancy (0) and not
    predicted."""
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    plc_params = api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev)
    s, n = DRED_PLC_STREAMS, DRED_PLC_FRAMES
    pcm, lost = pcm[:s, :n], lost[:s, :n]
    sids = [f"call-{i}" for i in range(s)]
    with_fec = [i for i in range(s) if i % 4 == 0]
    red = dred_redundancy(enc, dec, with_fec, n)                   # [64, n, 20]
    pool = PLCStreamPool(fused, cfg, plc_params, capacity=s, device=dev)
    for sid in sids:
        pool.attach(sid)
    fec_rows = torch.tensor(with_fec, device=dev)
    lost_fec = torch.from_numpy(lost[with_fec]).to(dev)
    hits = torch.zeros(len(with_fec), dtype=torch.int64, device=dev)
    outs = []
    reset_plc_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        if k % 2 == 0:
            for j in (k, k + 1):
                pool.fec_add({sids[i]: red[r, j] for r, i in enumerate(with_fec)})
        got = pool.step({sid: (None if lost[i, k] else pcm[i, k])
                         for i, sid in enumerate(sids)})
        outs.append(np.stack([got[sid] for sid in sids]))
        # a lost frame concealed from the queue leaves the loss count at 0
        hits += (lost_fec[:, k] & (pool.plc.state.loss_count[fec_rows] == 0)).long()
    torch.cuda.synchronize()
    frame_ms = 1e3 * (time.perf_counter() - t0) / n
    counts = plc_counts()
    out = np.stack(outs, axis=1)
    clean = ~lost.any(axis=1)
    assert np.array_equal(out[clean], pcm[clean]), "passthrough"
    assert np.isfinite(out).all()
    assert counts == (2 * n, n, 0), counts
    st = pool.plc.state
    had_loss = lost[with_fec].any(axis=1)
    read = st.fec_read[fec_rows].cpu().numpy()
    assert (read[had_loss] > 0).all(), read
    n_hits, n_lost = int(hits.sum()), int(lost[with_fec].sum())
    reset_plc_counts()
    log(f"DRED into concealment: PLCStreamPool {s} streams, {n} frames, "
        f"{100 * lost.mean():.2f} % of frames lost, {len(with_fec)} streams fed "
        f"their DRED-decoded redundancy through fec_add: {frame_ms:.3f} ms/frame "
        f"(host clock); {n_hits} of the FEC streams' {n_lost} lost frames "
        f"concealed from the redundancy (loss count held at 0); fec_read advanced "
        f"on all {int(had_loss.sum())} FEC streams with a loss; {int(clean.sum())} "
        f"never-lost streams exact; K2 launches {counts[0]}, K3 {counts[1]}, K4 "
        f"{counts[2]}; card: {smi}")
    return {"streams": s, "frames": n, "fec_streams": len(with_fec),
            "lost_share": float(lost.mean()), "ms_per_frame": frame_ms,
            "fec_lost_frames": n_lost, "fec_hits": n_hits,
            "k2_launches": counts[0], "k3_launches": counts[1],
            "k4_launches": counts[2], "never_lost_exact": int(clean.sum())}


def dred_cli_on_card(smi):
    """`cli fec-encode` of the C fixture's speech on the card with the demo
    RDO-VAE, then the .fec through the host PLC (K2 at one stream) with a
    seeded 10 % of the packets lost, the last one received (as the JAX
    package's test's pattern ends): loss_count 0 at the end, as that test
    asserts. Each packet's redundancy is queued just before the packet
    (`run_plc_fec_stream`), so a concealment's drain can run the queue dry;
    the loss count after each concealed frame says how many of the lost
    frames were concealed from the redundancy."""
    from lpcnet_torch import cli
    from lpcnet_torch.dred.fec_file import read_fec_packets
    from lpcnet_torch.plc.driver import make_plc, run_plc_fec_stream
    fix = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "fixtures", "codec.npz"))
    speech = fix["pcm"].astype(np.int16)
    with tempfile.TemporaryDirectory() as d:
        pin, fec = os.path.join(d, "in.pcm"), os.path.join(d, "x.fec")
        speech.tofile(pin)
        t0 = time.perf_counter()
        cli.main(["fec-encode", pin, fec, "--model", api.DEMO_RDOVAE_MODEL_PATH])
        enc_s = time.perf_counter() - t0
        packets, rates = read_fec_packets(fec)
    # the zero history the alignment prepends (63 packets of 20 ms): the
    # packets after it line up with the speech's, 69 samples apart
    n_all, packets = len(packets), packets[63:]
    n_pk = len(speech) // 320
    assert len(packets) >= n_pk and all(np.isfinite(x).all() for x in packets)
    losses = (np.random.RandomState(SEED + 53).rand(n_pk) < 0.10).astype(np.int32)
    losses[:2] = 0
    losses[-1] = 0
    plc = make_plc("causal", model_path=api.DEMO_MODEL_PATH)
    counts_after = []
    conceal = plc.conceal

    def conceal_and_read():
        pcm = conceal()
        counts_after.append(plc.loss_count)
        return pcm
    plc.conceal = conceal_and_read
    before = K.synthesize_frame_masked_kernel.launches
    t0 = time.perf_counter()
    out = run_plc_fec_stream(plc, speech.astype(np.float32), losses, packets)
    plc_s = time.perf_counter() - t0
    launches = K.synthesize_frame_masked_kernel.launches - before
    assert out.shape == speech.shape and np.isfinite(out).all()
    assert plc.loss_count == 0 and plc.fec_read_pos > 0 and launches > 0
    hits = int(sum(c == 0 for c in counts_after))
    log(f"cli fec-encode on the card: {n_all} packets ({enc_s:.2f} s, mean "
        f"{np.mean(rates):.0f} bits a packet estimated); the host PLC over "
        f"{int(losses.sum())} of {n_pk} packets lost ({len(counts_after)} frames "
        f"concealed, {hits} of them from the redundancy): loss_count 0 at the end, "
        f"fec_read_pos {plc.fec_read_pos}, K2 launches {launches}, {plc_s:.2f} s; "
        f"card: {smi}")
    return {"packets": n_all, "fec_encode_s": enc_s, "lost_packets":
            int(losses.sum()), "concealed_frames": len(counts_after),
            "concealed_from_redundancy": hits, "loss_count": plc.loss_count,
            "k2_launches": launches, "plc_s": plc_s}


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
    check_k1_batches(fused, cfg, dev)

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
            "source": "lpcnet_torch/kernels/csrc/masked_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:461",
            "launches": launches, "max_abs_err": step_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None,
            "pass": True,
            "design": "masked_loop_kernel<FORM, NT, KIND_FREE>: K2's clusters in "
                      "the free-running form, the tail split over the ranks; "
                      + k1_launch_shape(MAIN_BATCH, cfg.rnn_units1, cfg.rnn_units2,
                                        K.ML.FORMS[form], dev),
        })
    K.synthesize_frame_kernel.launches = 0

    # 5. K5 vs plain, 6. K2 vs plain
    k5_err = {}
    for n in (cfg.rnn_units1, cfg.rnn_units2):
        short, full = check_k5(n, 320, dev), check_k5(n, 2400, dev)
        k5_err[n] = tuple(max(a, c) for a, c in zip(short, full))
        torch.cuda.empty_cache()
    check_k5(cfg.rnn_units2, 2400, dev, b=37)
    gate_err = {n: check_gate_pass(n, dev) for n in (cfg.rnn_units1, cfg.rnn_units2)}
    check_k5_widths(dev)
    check_k2(fused, cfg, dev)
    check_k2_ragged(fused, cfg, dev)
    check_k2_free(fused, cfg, dev)
    check_k2_widths(dev)
    k2_case = k2_train_case(fused, cfg, dev)
    k2_err = check_k2_train_shape(k2_case)

    # 7. the training path, then 8. timings at its shapes
    with tempfile.TemporaryDirectory() as workdir:
        launches, step_ms = drive_training(dev, smi, workdir)
    entries.append(time_k2(k2_case, fused, cfg, launches["k2"], k2_err, smi))
    products_ms = 0.0
    for n in (cfg.rnn_units1, cfg.rnn_units2):
        prod, k5_entries = time_k5(n, launches, *k5_err[n], dev, smi)
        products_ms += prod
        k5_entries[1]["gate_pass_max_abs_err"] = gate_err[n]
        entries.extend(k5_entries)
    log_step_breakdown(entries, products_ms, step_ms, smi)
    G.GruRecurrence.reset_launches()
    K.synthesize_frame_masked_kernel.launches = 0

    # 9. K3 and K4 vs plain, the decoder's teacher-forced frame
    check_k3(fused, cfg, dev)
    check_k4(api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev), dev)
    check_decoder_preload(dev)

    # 10. the PLC path, then 11. timings on its own arguments
    counts, chain_counts, frame_ms, calls, models = drive_plc(dev, smi)
    k2_plc_ms, k2_plc_err, plc_entries = time_plc_kernels(
        calls, models, counts, chain_counts, frame_ms, smi)
    entries.extend(plc_entries)
    k2_entry = next(e for e in entries if e["name"] == "sample_loop_masked[bf16]")
    k2_entry["launches_plc_path"] = counts[0] + chain_counts[0]
    k2_entry["ms_plc_path"] = k2_plc_ms
    k2_entry["max_abs_err_plc_path"] = max(k2_plc_err)

    # 12. the non-causal PLC path, K2 and K3 on its arguments, the two-path
    # steps and the host PLC behind `cli plc`
    nc_counts, nc_ms, nc_calls, nc_dc_counts, nc_dc_ms, nc_models = drive_nc_plc(dev, smi)
    k2_nc, k3_nc = time_nc_kernels(nc_calls, nc_models, nc_counts, nc_ms, smi)
    del nc_calls
    k3_entry = next(e for e in entries if e["name"] == "teacher_force[bf16]")
    k2_entry.update(k2_nc, launches_nc_dc_path=nc_dc_counts[0],
                    ms_nc_frame=nc_ms, ms_nc_dc_frame=nc_dc_ms)
    k3_entry.update(k3_nc, launches_nc_dc_path=nc_dc_counts[1])
    two = drive_two_path(dev, smi)
    k2_entry["launches_two_path"] = [two[m][0] for m in ("causal", "non-causal")]
    k3_entry["launches_two_path"] = [two[m][1] for m in ("causal", "non-causal")]
    k2_entry["launches_host_plc"] = host_plc_on_card(smi)
    torch.cuda.empty_cache()

    # 13. K6 vs plain, 14. the codec path, then K6's timings on its state
    check_k6(fused, cfg, dev)
    runs, parts = drive_codec(dev, smi)
    k6_entry = time_k6(runs, parts, dev, smi)
    k6_entry["codec_fixture_bit_exact"] = codec_fixture_on_card(smi)
    entries.append(k6_entry)
    assert len(entries) == 10 and all(e["launches"] > 0 for e in entries), entries
    torch.cuda.empty_cache()

    # 15. DRED, its redundancy into the PLC pool's FEC queues and the host PLC
    t0 = time.perf_counter()
    dred = drive_dred(dev, smi)
    log(f"DRED phase: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"dred": dred}))
    print(json.dumps({"kernels": entries}))
    print(smi)          # nvidia-smi: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
