"""GPU smoke check of lpcnet_torch: builds every kernel, holds each against its
plain PyTorch version on the card, drives vocoder synthesis end to end
through the public API, and times it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Phases:
  1. build every kernel from lpcnet_torch/kernels/csrc (one nvcc per source,
     all at once);
  2. the sample-loop kernel (K1) vs its plain version on the shipped demo
     vocoder at 256 streams, 32 steps, in the f32, bf16 and q8 forms;
  3. the main path: api.Synthesizer on the demo vocoder at 1024 streams for
     50 frames, float (bf16 kernel bundle) and int8 (q8); K1's launch count
     must equal the frame count;
  4. K1 vs its plain version again at the main path's shapes (1024 streams,
     160 steps, from the state the main path left), then timings: K1 per
     launch (CUDA events) vs its plain version and its bound.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from lpcnet_torch import api
from lpcnet_torch.dsp.constants import NB_TOTAL_FEATURES
from lpcnet_torch.kernels import _build
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn.quantized import quantize_fused

SEED = 0
KERNEL_SOURCES = ["sample_loop"]
# H100 SXM data-sheet peaks (dense): bytes/s and operations/s by type
HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
MAIN_BATCH = 1024
MAIN_FRAMES = 50
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


def k1_bound_ms(kw, cfg, batch, n):
    """Least time for one launch: the larger of the bytes it must move over
    HBM bandwidth and its multiply-adds over the peak rate of their type."""
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

    print(json.dumps({"kernels": entries}))
    print(smi)          # nvidia-smi: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
