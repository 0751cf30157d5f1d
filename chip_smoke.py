"""GPU smoke check of lpcnet_torch: builds every kernel, holds each against its
plain PyTorch version on the card, drives vocoder synthesis, vocoder
training, batched packet-loss concealment, the 1.6 kb/s codec (encode,
packet decode through StreamPool), DRED, the training pipeline (corpus,
dump_data, the PLC and RDO-VAE trainers, held-out validation) and the last
modules (codebook training, train_block, the trainers over
torch.distributed, the PLC ablation sweep, the Pade fitter) end to end
through the public entry points, and times them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++. Phases:
  1. build every kernel from lpcnet_torch/kernels/csrc (one nvcc per source,
     all at once), then the native host runtime from
     lpcnet_torch/runtime/native (g++);
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
     back exactly, through the native runtime's range coder (its bytes
     equal to the Python coder's on the same latents, both timed);
     decode_all at 1024 streams; PLCStreamPool at 256 streams
     for 100 frames, 64 of its streams fed their DRED-decoded redundancy
     through fec_add (K2 twice and K3 once a frame asserted); `cli
     fec-encode` of the C fixture's speech through the host PLC (K2 at one
     stream) with no prediction used. A {"dred": ...} line carries its
     numbers;
 16. the factored q8 embedding (LPCNET_EMB=factored, `set_emb`): the demo
     vocoder loaded int8 from its .npz, its factored bundle asserted to carry
     the factored operands; K1 in that form vs its plain version at 1024
     streams, 160 steps, and at 130 streams, 32 steps, at the composed q8
     form's bars, timed beside the composed form with its bound and layout;
 17. K2 in that form at (64 streams, 80 steps) and (128, 160), the sampler
     on and off, and K3 at 64 streams over 3 x 160 and 256 over one block
     of 160, each at the composed q8 form's bars and timed beside it;
 18. the served paths on the int8 factored vocoder: Synthesizer at 1024
     streams for 10 frames (K1 once a frame), PLCStreamPool at 256 streams
     for 20 frames of the PLC traffic (K2 twice and K3 once a frame,
     never-lost streams exact); their launches are the kernels line's;
 19. `cli synthesis --sampling pdf` (the full-PDF sampler, plain PyTorch)
     on the card: 10 frames at one stream, int16, silent for the lookahead
     and not after; a {"pdf_sampling": ...} line carries its numbers;
 20. the training pipeline: synth_corpus(1500 s, seed=61) through
     dump_data_streams on the card (32 streams, Burg rows, the native
     runtime's biquads, noise and teacher loop); PLCTrainer at PLCConfig()
     / PLCTrainConfig() (batch 128, 1000 frames) for 5 steps on one batch,
     eval_step twice, PLCDeviceLoader.sample_fn's contract; RDOVAETrainer at
     RDOVAEConfig() / RDOVAETrainConfig() (batch 32, 256 frames) for 5
     steps, eval_step at q 4 and 12; Trainer.fit at LPCNetConfig() (batch
     128, EMA 0.999) for 4 steps with a HeldOutValidator on two 4 s clips
     every 2 steps, its K1 (f32) launches counted (200 a frame track x 2
     evaluations x raw and EMA), the log and the best checkpoint read back,
     K1 at the validator's shapes against its plain version and the plain
     synthesize_frame; a {"training_pipeline": ...} line carries its
     numbers, and K1's kernels-line entry gains the validator's;
 21. the last modules, on phase 20's corpus: train_codebooks at full size
     (149,984 frames, 37,495 endpoints; 3 x 1024 stage codes, 4096 diff
     codes) with the runtime quantizers' MSE beside the shipped set's and
     the diff book's group structure, then 8k frames at 64 / 64 codes on
     the card against the CPU from one seed (1e-4); Trainer.train_block at
     LPCNetConfig() / TrainConfig() through DeviceLPCNetLoader, a block of
     4 against 4 train_step calls and against 2 x 2 blocks (bit-equal, or
     where the card's step differs run to run, 1e-6 relative), the default
     blocks under torch.cuda.set_sync_debug_mode (none may synchronise),
     a block of 2 with ss_prob=0.25 and its synchronising calls counted;
     PLCTrainer.train_block at PLCConfig() (B=128, T=1000), a block of 2
     against 2 steps and 2 x 1 blocks; the vocoder Trainer over NCCL at
     world size 1 (init_distributed, make_mesh) bit-equal to no mesh over
     2 steps, the PLC and RDO-VAE trainers a step each with the mesh, the
     one all_reduce a step timed; tools/profile_plc_torch.py's ablation
     sweep at 256 streams, 10 frames a variant in each of 3 rounds (medians);
     fit_pade_odd on the card
     against the CPU (1e-9). K5's and K2's counts in the vocoder's blocks
     join their kernels-line entries; a {"last_modules": ...} line carries
     the numbers.
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
PIPE_SECONDS = 1500.0
PIPE_STREAMS = 32
PIPE_STEPS = 5
FIT_BATCHES = 4
VAL_SECONDS = 4.0
CB_SMALL_FRAMES = 8000
CB_SMALL_CODES = 64
BLOCK_STEPS = 4
SS_BLOCK_STEPS = 2
PLC_BLOCK_STEPS = 2
MESH_STEPS = 2
ABL_STREAMS = 256
ABL_FRAMES = 10


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


def gru_step_macs(kw, cfg):
    """Multiply-adds of one GRU-A and GRU-B step of a stream; the factored
    q8 embedding adds its rows' product with the input kernel, 384 x 3Na."""
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    macs = na * 3 * na + na * 3 * nb + nb * 3 * nb
    return macs + (K.ML.FACT_K * 3 * na if K.is_factored(kw) else 0)


def weight_bytes(kw, skip=()):
    """Bytes of the bundle's operands the kernel reads: K2's packs are the
    same bytes as the matrices they pack, and the factored form reads its
    own embedding operands in place of the composed table."""
    if K.is_factored(kw):
        skip = tuple(skip) + ("emb_q8", "emb_scale")
    return sum(v.numel() * v.element_size() for k, v in kw.items()
               if not k.startswith(("k2_",) + tuple(skip)))


def k1_bound_ms(kw, cfg, batch, n, masked=False):
    """Least time for one launch: the larger of the bytes it must move over
    HBM bandwidth and its multiply-adds over the peak rate of their type.
    `masked` adds K2's preload and mode words."""
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    gru_macs = gru_step_macs(kw, cfg)
    dual_macs = nb * 512
    steps = batch * n
    gru_type = ("int8" if K.is_q8_bundle(kw) else
                "bf16" if kw["emb_cat"].dtype == torch.bfloat16 else "f32")
    op_s = (2 * gru_macs * steps / PEAK[gru_type]
            + 2 * dual_macs * steps / PEAK["f32"])
    weight_bytes_ = weight_bytes(kw)
    per_stream = 4 * (3 * na + 3 * nb + 16          # cond_a, cond_b, lpc
                      + 2 * (na + nb + 16 + 1 + 1)  # state in and out
                      + n) + 2 * (4 * 8 + 4)        # rng, exc in/out
    if masked:
        per_stream += 8 * n
    byte_s = (weight_bytes_ + batch * per_stream) / HBM_BPS
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
    if form.startswith("q8"):
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
    form_bounds = {form: k1_bound_ms(kf, cfg, b, 160, masked=True)
                   for form, kf in bundles.items()}
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
        f"plain {p_ms:.2f} ms, bound {bound:.4f} ms ({bound_by}; by form: "
        + ", ".join(f"{k} {v[0]:.4f} ({v[1]})" for k, v in form_bounds.items())
        + f"), 15 launches per training step with ss_prob > 0; library: no single "
        f"PyTorch call computes K2; card: {smi}")
    return {"name": "sample_loop_masked[bf16]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/masked_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:461",
            "launches": launches, "max_abs_err": step_err, "ms": ms["bf16"],
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "pass": True, "f32_ms": ms["f32"], "q8_ms": ms["q8"],
            "k1_ms_same_inputs": k1_ms, "bf16_ms_b256": wide[256],
            "bf16_ms_b1024": wide[1024],
            "f32_bound_ms": form_bounds["f32"][0], "q8_bound_ms": form_bounds["q8"][0]}


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


def profile_step(step, label, smi, host_ops=True):
    """One more step (`step()`) of a path under torch.profiler: the device's
    busy share of the step and the kernels that take most of it. Fails where
    the profiler records no device time. `host_ops=False` records the
    device's activity alone: a step of tens of thousands of launches then
    costs seconds, not a minute, to gather. Returns (device busy ms, the
    step's ms on the host's clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
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
    of the steps that run (0.46 M a step and stream at full width, 0.90 M in
    the factored q8 form) over the peak of their type, against the bytes:
    the weights once, and per stream
    the conditioning blocks, three code bytes a step, the counts and the
    state in and out."""
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    macs = gru_step_macs(kw, cfg)
    steps = int(counts.sum())
    typ = ("int8" if K.is_q8_bundle(kw) else
           "bf16" if kw["emb_cat"].dtype == torch.bfloat16 else "f32")
    op_s = 2 * macs * steps / PEAK[typ]
    per_stream = (n_blocks * (4 * (3 * na + 3 * nb) + 3 * blk + 4)
                  + 2 * (4 * (na + nb) + 32))
    byte_s = (weight_bytes(kw, ("dual", "logit")) + counts.shape[0] * per_stream) / HBM_BPS
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
    beside K4; the frame's split. Returns K2's times, one-step errors and
    bound on this path, and the kernels line's entries for K3 and K4."""
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
    k2_bound, k2_by = k1_bound_ms(k2_pair[0][0], cfg, b2, n2, masked=True)
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
        f"{k2_ms[0]:.3f} ms + K2 tail {k2_ms[1]:.3f} ms (B={b2}, n={n2}, bound "
        f"{k2_bound:.5f} ms ({k2_by}) each; CUDA "
        f"events, alone, on the busiest captured frame's arguments) + frame-rate "
        f"rest and host {frame_ms - kernels:.3f} ms "
        f"({100 * (frame_ms - kernels) / frame_ms:.1f} %); card: {smi}")
    log_frame_rate_pieces(fused, cfg, plc_params, h1.shape[0], smi)
    src = "lpcnet_torch/kernels/csrc/"
    return k2_ms, k2_errs, k2_bound, [
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
        res[form] = dict(err=err, ms=k6_ms, k1_ms=k1_ms, plain=p_ms, bound=bound, by=by,
                         k1_bound=k1_bound)
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
            "k1_f32_ms_same_inputs": res["f32"]["k1_ms"],
            "f32_bound_ms": res["f32"]["bound"], "k1_bound_ms": r["k1_bound"],
            "k1_f32_bound_ms": res["f32"]["k1_bound"]}


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
        f"{pay_dec_ms:.3f} ms to decode, "
        f"host clock; card: {smi}")
    coder = payload_coders(out, penc.fixed_stats, rcfg, smi)

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
            "payload_decode_ms": pay_dec_ms, "payload_coder": coder,
            "decode_all_ms": decode_all_ms,
            "decode_all_device_ms": lat_ms, "plc": plc, "host_plc": host}


def payload_coders(out, stats, rcfg, smi):
    """The payloads' latents coded by the native runtime's range coder (the
    path encode_payload and decode_payload take) and by the Python coder
    (the library hidden): the same bytes, each decoded back; ms a payload
    of each, host clock."""
    from lpcnet_torch.dred import entropy as DE
    from lpcnet_torch.runtime import bindings as RB
    assert RB.native_available(), "the native runtime did not build"
    k, sd = rcfg.pvq_num_pulses, rcfg.state_dim
    args = [(out["zq"][i].astype(np.int32), out["pulses"][i])
            for i in range(len(out["payloads"]))]

    def code():
        t0 = time.perf_counter()
        coded = [DE.encode_payload(z, s, 9, 15, stats, k) for z, s in args]
        enc_ms = 1e3 * (time.perf_counter() - t0) / len(args)
        t0 = time.perf_counter()
        back = [DE.decode_payload(c, stats, sd, k) for c in coded]
        dec_ms = 1e3 * (time.perf_counter() - t0) / len(args)
        for (z, s), (zq, pulses, _) in zip(args, back):
            assert np.array_equal(zq, z) and np.array_equal(pulses, s)
        return coded, enc_ms, dec_ms

    native, n_enc, n_dec = code()
    saved, RB.runtime = RB.runtime, RB._Runtime(native=False)
    try:
        python, p_enc, p_dec = code()
    finally:
        RB.runtime = saved
    assert native == python == list(out["payloads"]), "payload bytes"
    log(f"DRED payload coder: native (runtime.bindings) and Python give the same "
        f"bytes for {len(args)} payloads; encode {n_enc:.3f} ms a payload native, "
        f"{p_enc:.3f} Python; decode {n_dec:.3f} native, {p_dec:.3f} Python (host "
        f"clock); card: {smi}")
    return {"native_equals_python": True, "payloads": len(args),
            "encode_ms_native": n_enc, "encode_ms_python": p_enc,
            "decode_ms_native": n_dec, "decode_ms_python": p_dec}


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


# --------------------------------------------------------------------------
# The factored q8 embedding (LPCNET_EMB=factored) in K1, K2 and K3, and the
# full-PDF sampler behind `cli synthesis --sampling pdf`
# --------------------------------------------------------------------------

@contextlib.contextmanager
def factored_mode():
    """`kernel_weights` builds factored q8 bundles while active."""
    prev = K.set_emb("factored")
    try:
        yield
    finally:
        K.set_emb(prev)


def q8_bundles(dev):
    """The demo vocoder loaded int8 from its .npz, and its q8 bundles with
    K2's packs: (fused, cfg, composed, factored). Fails unless the factored
    bundle carries its operands, so no phase can run the composed form in
    its place."""
    fq, cfg = api.load_model(api.DEMO_MODEL_PATH, int8=True, device=dev)
    comp = K.masked_kernel_weights(K.kernel_weights(fq, cfg))
    with factored_mode():
        fact = K.masked_kernel_weights(K.kernel_weights(fq, cfg))
    assert K.is_factored(fact) and fact["k2_f"] is not None, "no factored operands"
    assert not K.is_factored(comp)
    return fq, cfg, comp, fact


def fact_layout(kind, b, cfg, dev, nblk=1):
    """The factored form's launch at `b` streams, in words."""
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    if kind == "free":
        c = K.ML.free_launch_config(b, na, nb, 2, K._max_clusters(dev, 2, na, K.KIND_FREE),
                                    fact=True)
    elif kind == "masked":
        c = K.ML.masked_launch_config(b, na, nb, 2, K._max_clusters(dev, 2, na), fact=True)
    else:
        c = K.ML.tf_launch_config(b, na, nb, 2, nblk,
                                  K._max_clusters(dev, 2, na, K.KIND_TF), fact=True)
    res = "+".join(k for k, on in (("GRU-A", c["res_a"]), ("GRU-B", c["res_b"]),
                                   ("input kernel", c["res_f"])) if on)
    return (f"S={c['streams']}, {c['clusters']} clusters of {c['cluster']} blocks in "
            f"{c['waves']} wave(s), {c['smem']} bytes a block, in shared memory: "
            f"{res or 'none'}")


def check_k1_factored(cfg, comp, fact, fq, dev, smi):
    """K1 in the factored form vs its plain version at the main shape
    (B=1024, n=160, from a live state) at check_k1_main_shape's q8 bars, and
    at the ragged B=130, 32 steps at check_k1_batches' (one step within
    1e-4, RNG equal, >90 % exact PCM); then timed beside the composed form
    on the same inputs. Returns the kernels line's entry (launches filled
    in by the served path)."""
    ca, cb, lpc = conditioning(fq, cfg, MAIN_BATCH, dev)
    st, _ = K.synthesize_frame_kernel(fact, M.init_sample_state(MAIN_BATCH, cfg, dev),
                                      ca, cb, lpc)
    step_err = check_k1_main_shape(fact, st, ca, cb, lpc, "q8 factored")
    b = 130
    ca_r, cb_r, lpc_r = conditioning(fq, cfg, b, dev)
    s0 = M.init_sample_state(b, cfg, dev)
    s1k, _ = K.synthesize_frame_kernel(fact, s0, ca_r, cb_r, lpc_r, 1)
    s1p, _ = K.sample_loop_plain(fact, s0, ca_r, cb_r, lpc_r, 1)
    e1 = max(float((s1k.gru_a - s1p.gru_a).abs().max()),
             float((s1k.gru_b - s1p.gru_b).abs().max()))
    sk, pk = K.synthesize_frame_kernel(fact, s0, ca_r, cb_r, lpc_r, CHECK_STEPS)
    sp, pp = K.sample_loop_plain(fact, s0, ca_r, cb_r, lpc_r, CHECK_STEPS)
    same = float((pk == pp).float().mean())
    rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
    finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
    log(f"K1[q8 factored] vs plain, B={b} n={CHECK_STEPS} ({fact_layout('free', b, cfg, dev)}): "
        f"one step max|h| err {e1:.3e}; exact pcm {same:.4f}, rng equal {rng_eq}")
    assert e1 <= 1e-4 and rng_eq and finite and same > 0.90, (e1, same)
    ms_f = time_cuda(lambda: K.synthesize_frame_kernel(fact, st, ca, cb, lpc), reps=20)
    ms_c = time_cuda(lambda: K.synthesize_frame_kernel(comp, st, ca, cb, lpc), reps=20)
    p_ms = time_cuda(lambda: K.sample_loop_plain(fact, st, ca, cb, lpc), reps=2, warmup=1)
    bound, by = k1_bound_ms(fact, cfg, MAIN_BATCH, 160)
    layout = fact_layout("free", MAIN_BATCH, cfg, dev)
    log(f"K1[q8 factored] B={MAIN_BATCH} n=160: kernel {ms_f:.4f} ms/launch, the "
        f"composed q8 form on the same inputs {ms_c:.4f} ms, plain "
        f"{p_ms:.2f} ms, bound {bound:.4f} ms ({by}); launch {layout}; library: no "
        f"single PyTorch call computes K1; card: {smi}")
    return {"name": "sample_loop[q8_factored]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/masked_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:461",
            "launches": 0, "max_abs_err": step_err, "ms": ms_f, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None, "pass": True,
            "composed_ms_same_inputs": ms_c,
            "design": "masked_loop_kernel<FORM_Q8, NT, KIND_FREE> with the factored "
                      "operands: the rows g gathered after the codes' barrier, their "
                      "product on the tensor cores before the gate phase; " + layout}


def check_k2_factored(cfg, comp, fact, fq, dev, smi):
    """K2 in the factored form vs its plain version at B=64, n=80 (the PLC's
    compacted section) and B=128, n=160, random mode words, the sampler on
    and off, at check_k2's q8 bars (RNG equal, frozen streams untouched with
    PCM 0; sampler off: PCM and state exact; on: >90 % exact PCM, gru_a
    within 5e-2) and one step from the start within 1e-4; each shape timed
    beside the composed form. Returns the kernels line's entry."""
    res = {}
    for b, n in ((64, 80), (128, 160)):
        ca, cb, lpc = conditioning(fq, cfg, b, dev)
        s0 = M.init_sample_state(b, cfg, dev)
        fro = slice(0, b // 4)
        errs = []
        for sampled in (True, False):
            tg, tf, adv = k2_masks(b, n, dev, SEED + 70 + b, all_tf=not sampled)
            one = (fact, s0, ca, cb, lpc, tg[:, :1].contiguous(), tf[:, :1].contiguous(),
                   adv[:, :1].contiguous(), 1, sampled)
            s1k, _ = K.synthesize_frame_masked_kernel(*one)
            s1p, _ = K.sample_loop_masked_plain(*one)
            e1 = max(float((s1k.gru_a - s1p.gru_a).abs().max()),
                     float((s1k.gru_b - s1p.gru_b).abs().max()))
            args = (fact, s0, ca, cb, lpc, tg, tf, adv, n, sampled)
            sk, pk = K.synthesize_frame_masked_kernel(*args)
            sp, pp = K.sample_loop_masked_plain(*args)
            same = float((pk == pp).float().mean())
            rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
            frozen = state_equal(sk, s0, fro) and not bool(pk[~adv].any())
            err = float((sk.gru_a - sp.gru_a).abs().max())
            finite = bool(torch.isfinite(pk).all() and torch.isfinite(sk.gru_a).all())
            log(f"K2[q8 factored] vs plain, B={b} n={n} sampled={sampled}: one step "
                f"max|h| err {e1:.3e}; exact pcm {same:.4f}, rng equal {rng_eq}, frozen "
                f"streams untouched {frozen}, max|gru_a| err {err:.3e}")
            assert e1 <= 1e-4 and rng_eq and frozen and finite, (b, n, sampled)
            if sampled:
                assert same > 0.90 and err <= 5e-2, (b, n, same, err)
            else:
                assert same == 1.0 and err == 0.0 and state_equal(sk, sp), (b, n)
            errs.append(e1)
            if sampled:
                timed = args[:-1]
        ms_f = time_cuda(lambda: K.synthesize_frame_masked_kernel(*timed), reps=20)
        ms_c = time_cuda(lambda: K.synthesize_frame_masked_kernel(comp, *timed[1:]),
                         reps=20)
        p_ms = time_cuda(lambda: K.sample_loop_masked_plain(*timed), reps=1, warmup=1)
        bound, by = k1_bound_ms(fact, cfg, b, n, masked=True)
        res[(b, n)] = dict(ms=ms_f, comp=ms_c, plain=p_ms, bound=bound, by=by,
                           err=max(errs))
        log(f"K2[q8 factored] B={b} n={n}: kernel {ms_f:.4f} ms/launch, the composed "
            f"q8 form on the same inputs {ms_c:.4f} ms, plain {p_ms:.2f} ms, bound "
            f"{bound:.5f} ms ({by}); launch {fact_layout('masked', b, cfg, dev)}; "
            f"library: no single PyTorch call computes K2; card: {smi}")
    r = res[(64, 80)]
    return {"name": "sample_loop_masked[q8_factored]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/masked_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:461",
            "launches": 0, "max_abs_err": max(v["err"] for v in res.values()),
            "ms": r["ms"], "plain_ms": r["plain"], "bound_ms": r["bound"],
            "bound_by": r["by"], "library_ms": None, "pass": True,
            "composed_ms_same_inputs": r["comp"],
            "b128_n160": {k: res[(128, 160)][k] for k in ("ms", "comp", "plain", "bound")},
            "design": "masked_loop_kernel<FORM_Q8, NT, KIND_MASKED> with the factored "
                      "operands; " + fact_layout("masked", 64, cfg, dev)}


def check_k3_factored(cfg, comp, fact, fq, dev, smi):
    """K3 in the factored form vs its plain version at B=64 over 3 x 160
    (drain-shaped counts) and B=256 over one block of 160, at check_k3's q8
    bars (RNG and the signal state equal, frozen streams bit-equal, one step
    within 1e-4, the run within 5e-2); each timed beside the composed form,
    the call and the launch alone. Returns the kernels line's entry."""
    res = {}
    n = 160
    for b, nblk in ((64, 3), (256, 1)):
        s0, ca, cb, lpc, tg, counts = tf_case(fq, cfg, b, n, nblk, dev, SEED + 23)
        one = torch.clamp(counts[:, :1], max=1)
        first = (ca[:, :1].contiguous(), cb[:, :1].contiguous(), lpc[:, :1], tg[:, :n],
                 one, n)
        s1k = K.teacher_force_blocks_kernel(fact, s0, *first)
        s1p = K.teacher_force_blocks_plain(fact, s0, *first)
        e1 = max(float((s1k.gru_a - s1p.gru_a).abs().max()),
                 float((s1k.gru_b - s1p.gru_b).abs().max()))
        args = (s0, ca, cb, lpc, tg, counts, n)
        sk = K.teacher_force_blocks_kernel(fact, *args)
        sp = K.teacher_force_blocks_plain(fact, *args)
        rng_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk.rng, sp.rng))
        sig_eq = all(bool(torch.equal(a, c)) for a, c in zip(sk[2:5], sp[2:5]))
        inert = state_equal(sk, s0, counts.sum(1) == 0)
        err = max(float((sk.gru_a - sp.gru_a).abs().max()),
                  float((sk.gru_b - sp.gru_b).abs().max()))
        log(f"K3[q8 factored] vs plain, B={b}, {nblk} x {n}: one step max|h| err "
            f"{e1:.3e}; run: rng equal {rng_eq}, signal state equal {sig_eq}, frozen "
            f"streams untouched {inert}, max|h| err {err:.3e}")
        assert e1 <= 1e-4 and rng_eq and sig_eq and inert and err <= 5e-2, (b, e1, err)
        codes, _ = K.tf_codes(s0, lpc, tg, counts, n)
        call_f = time_cuda(lambda: K.teacher_force_blocks_kernel(fact, *args), reps=10)
        call_c = time_cuda(lambda: K.teacher_force_blocks_kernel(comp, *args), reps=10)
        kern_f = time_cuda(lambda: K.tf_launch(fact, s0, ca, cb, counts, codes, n), reps=20)
        kern_c = time_cuda(lambda: K.tf_launch(comp, s0, ca, cb, counts, codes, n), reps=20)
        p_ms = time_cuda(lambda: K.teacher_force_blocks_plain(fact, *args), reps=1,
                         warmup=0)
        bound, by = k3_bound_ms(fact, cfg, counts, nblk, n)
        res[b] = dict(ms=call_f, kernel_ms=kern_f, comp=call_c, comp_kernel=kern_c,
                      plain=p_ms, bound=bound, by=by, err=err, step_err=e1)
        log(f"K3[q8 factored] B={b} {nblk} x {n} ({int(counts.sum())} steps to run): "
            f"the call {call_f:.4f} ms, the launch alone {kern_f:.4f} ms; the composed "
            f"q8 form on the same inputs {call_c:.4f} / {kern_c:.4f} ms; plain "
            f"{p_ms:.2f} ms, bound {bound:.5f} ms ({by}); launch "
            f"{fact_layout('tf', b, cfg, dev, nblk)}; library: no single PyTorch call "
            f"computes K3; card: {smi}")
    r = res[64]
    return {"name": "teacher_force[q8_factored]", "route": "cuda",
            "source": "lpcnet_torch/kernels/csrc/masked_loop.cu",
            "replaces": "lpcnet_tpu/kernels/sample_loop.py:785",
            "launches": 0, "max_abs_err": max(v["err"] for v in res.values()),
            "one_step_err": max(v["step_err"] for v in res.values()),
            "ms": r["ms"], "kernel_ms": r["kernel_ms"], "plain_ms": r["plain"],
            "bound_ms": r["bound"], "bound_by": r["by"], "library_ms": None,
            "pass": True, "composed_ms_same_inputs": r["comp"],
            "composed_kernel_ms_same_inputs": r["comp_kernel"],
            "b256_1x160": {k: res[256][k] for k in ("ms", "kernel_ms", "comp",
                                                     "comp_kernel", "plain", "bound")},
            "design": "masked_loop_kernel<FORM_Q8, NT, KIND_TF> with the factored "
                      "operands: the rows g gathered a step ahead, their product "
                      "beside GRU-A's; " + fact_layout("tf", 64, cfg, dev, 3)}


def drive_factored_paths(dev, smi, feats, composed_frame_ms):
    """The served paths on the int8 vocoder under the factored embedding:
    Synthesizer at 1024 streams for 10 frames (K1 once a frame), then
    PLCStreamPool at 256 streams for 20 frames of the PLC phase's traffic
    (K2 twice and K3 once a frame; never-lost streams exact). Each path's
    counts are set to 0 just before it and read just after. Returns ((K1,
    K2, K3) launches, the synthesis frame ms, the PLC frame ms)."""
    with factored_mode():
        pcm, secs, k1_launches, kw, synth = drive_main_path(True, dev, feats)
    assert K.is_factored(kw), "the Synthesizer's bundle is not factored"
    frame_ms = 1e3 * secs / MAIN_FRAMES
    log(f"main path [q8 factored]: Synthesizer B={MAIN_BATCH}, {MAIN_FRAMES} frames: "
        f"{frame_ms:.3f} ms/frame (the composed q8 form in this run "
        f"{composed_frame_ms:.3f}), "
        f"{MAIN_FRAMES * MAIN_BATCH * 160 / secs / 1e6:.3f} Msamples/s, K1 launches "
        f"{k1_launches}; warmup silent, int16, non-zero after; card: {smi}")
    del synth
    frames = 20
    fq, cfg = api.load_model(api.DEMO_MODEL_PATH, int8=True, device=dev)
    plc_params = api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev)
    with factored_mode():
        pool = PLCStreamPool(fq, cfg, plc_params, capacity=PLC_STREAMS, device=dev)
    assert K.is_factored(pool.plc.kw) and pool.plc.use_kernel
    pcm_in, lost, _ = plc_traffic(PLC_STREAMS, frames, SEED + 27)
    sids = [f"call-{i}" for i in range(PLC_STREAMS)]
    for sid in sids:
        pool.attach(sid)
    tick = plc_ticker(pool, pcm_in, lost, sids)
    reset_plc_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = np.stack([tick(k) for k in range(frames)], axis=1)
    torch.cuda.synchronize()
    plc_ms = 1e3 * (time.perf_counter() - t0) / frames
    counts = plc_counts()
    reset_plc_counts()
    clean = ~lost.any(axis=1)
    concealed = out[lost]
    assert counts == (2 * frames, frames, 0), counts
    assert np.isfinite(out).all() and clean[np.arange(PLC_STREAMS) % 16 == 15].all()
    assert np.array_equal(out[clean], pcm_in[clean]), "passthrough"
    assert concealed.any() and np.array_equal(concealed, np.round(concealed))
    log(f"PLC path [q8 factored]: PLCStreamPool {PLC_STREAMS} streams, {frames} frames, "
        f"{100 * lost.mean():.2f} % of frames lost: {plc_ms:.3f} ms/frame (host clock); "
        f"K2 launches {counts[0]}, K3 {counts[1]}; the {int(clean.sum())} streams "
        f"that lost nothing pass through exactly; card: {smi}")
    return (k1_launches, counts[0], counts[1]), frame_ms, plc_ms


def cli_pdf_on_card(dev, smi):
    """`cli synthesis --sampling pdf` on the card (its default device): 10
    frames of the seeded features at one stream with the demo vocoder; the
    output int16, not silent after the lookahead. Returns (seconds for the
    call, model load included; ms a frame of the sampler's step-by-step
    synthesis alone, CUDA events)."""
    from lpcnet_torch import cli
    f = features(1, MAIN_FRAMES, SEED + 5)[:, 0]
    with tempfile.TemporaryDirectory() as d:
        fin, fout = os.path.join(d, "f.f32"), os.path.join(d, "o.pcm")
        f.astype(np.float32).tofile(fin)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["synthesis", fin, fout, "--sampling", "pdf"])
        secs = time.perf_counter() - t0
        out = np.fromfile(fout, np.int16)
    la = M.LPCNetConfig().lookahead
    assert out.shape == (MAIN_FRAMES * 160,)
    assert not out[:la * 160].any() and out[la * 160:].any()
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    ca, cb, lpc = conditioning(fused, cfg, 1, dev)
    corr = torch.full((1,), 0.4, device=dev)
    s0 = M.init_sample_state(1, cfg, dev)
    frame_ms = time_cuda(lambda: M.synthesize_frame(fused, s0, ca, cb, lpc,
                                                    pdf_corr=corr), reps=3, warmup=1)
    log(f"cli synthesis --sampling pdf on the card: {MAIN_FRAMES} frames at one stream "
        f"in {secs:.2f} s (model load included), int16, silent for the {la} lookahead "
        f"frames, non-zero after (rms {float(np.sqrt(np.mean(out[la * 160:] ** 2.0))):.1f}); "
        f"the step-by-step frame with the full-PDF sampler alone {frame_ms:.2f} ms "
        f"(plain PyTorch, no kernel, as in the JAX package); card: {smi}")
    return secs, frame_ms


# --------------------------------------------------------------------------
# The training pipeline: corpus, dump_data, the PLC and RDO-VAE trainers, the
# vocoder trainer with held-out validation through K1
# --------------------------------------------------------------------------

def loss_trace(frames, seed):
    """A PLC loss trace in the trainer's format, int8 per frame, 0 = lost:
    10 % of the 20 ms packets lost, the flag held for both frames of a
    packet, as in plc_traffic."""
    rs = np.random.RandomState(seed)
    lost = rs.rand((frames + 1) // 2) < 0.10
    return (~np.repeat(lost, 2)[:frames]).astype(np.int8)


def timed_steps(step, n):
    """step() n times, a synchronise after each: (results, ms of each)."""
    out, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(step())
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


def build_native_runtime():
    """The native host runtime built from lpcnet_torch/runtime/native with
    g++ and loaded. Returns the seconds it took."""
    from lpcnet_torch.runtime import bindings as RB
    t0 = time.perf_counter()
    assert RB.native_available(), "the native runtime did not build"
    secs = time.perf_counter() - t0
    log(f"native runtime: {RB.library_path().name} built with g++ "
        f"{' '.join(RB.CXX_FLAGS)} and loaded in {secs:.2f} s")
    return secs


def pipeline_corpus(workdir, dev, smi):
    """synth_corpus(PIPE_SECONDS, seed=61) dumped on the card by
    dump_data_streams over PIPE_STREAMS streams with Burg rows through the
    native runtime; the feature half written apart for the RDO-VAE and the
    vocoder. Returns (numbers, {name: path})."""
    from lpcnet_torch.runtime import native_available
    from lpcnet_torch.train import corpus
    from lpcnet_torch.train import dump_data as DD
    assert native_available()
    t0 = time.perf_counter()
    audio = corpus.synth_corpus(PIPE_SECONDS, seed=61)
    corpus_s = time.perf_counter() - t0
    paths = {k: os.path.join(workdir, f) for k, f in (
        ("rows72", "plc_features.f32"), ("pcm", "data.s16"),
        ("rows36", "features.f32"), ("lost", "lost.s8"))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    DD.dump_data_streams(audio, paths["rows72"], paths["pcm"], seed=SEED,
                         streams=PIPE_STREAMS, burg=True, device=dev)
    dump_s = time.perf_counter() - t0
    rows = np.fromfile(paths["rows72"], np.float32).reshape(-1, 72)
    m = len(audio) // 160 // PIPE_STREAMS
    assert rows.shape == (PIPE_STREAMS * m, 72) and np.isfinite(rows).all(), rows.shape
    pairs = np.fromfile(paths["pcm"], np.int16).reshape(-1, 2)
    assert pairs.shape == (rows.shape[0] * 160, 2)
    rms_out = float(np.sqrt(np.mean(pairs[:, 1].astype(np.float64) ** 2)))
    assert rms_out > 10.0 and rows[:, 36 + 18].min() >= 0.01 * (66 - 200) - 1e-5
    np.ascontiguousarray(rows[:, 36:]).tofile(paths["rows36"])
    loss_trace(rows.shape[0], SEED + 65).tofile(paths["lost"])
    audio_s = len(audio) / 16000.0
    log(f"training pipeline, corpus: synth_corpus({PIPE_SECONDS:.0f} s, seed=61) in "
        f"{corpus_s:.1f} s; dump_data_streams on the card, {PIPE_STREAMS} streams x {m} "
        f"frames: {rows.shape[0]} rows of 72 floats ({rows.nbytes / 1e6:.1f} MB) and "
        f"{pairs.shape[0]} int16 pairs in {dump_s:.1f} s = {dump_s / audio_s:.4f} s a "
        f"second of audio; sig_out rms {rms_out:.1f}; card: {smi}")
    return {"corpus_seconds": audio_s, "corpus_s": corpus_s,
            "streams": PIPE_STREAMS, "rows": int(rows.shape[0]), "row_floats": 72,
            "dump_s": dump_s, "dump_s_per_audio_s": dump_s / audio_s}, paths


def gru_clip_holds(params, names, c):
    return all(float((params[g][leaf].detach().abs()[:, 0::2]
                      + params[g][leaf].detach().abs()[:, 1::2]).max()) <= 2 * c + 1e-5
               for g in names for leaf in ("kernel", "recurrent"))


def pipeline_plc(paths, dev, smi):
    """PLCTrainer at PLCConfig() / PLCTrainConfig() (batch 128, 1000
    frames) on the dumped rows: PIPE_STEPS steps on one batch, eval_step on
    the held-out batch twice, one profiled step; PLCDeviceLoader's batch on
    the card against the host loader's contract."""
    from lpcnet_torch.train import train_plc as TP
    cfg, tc = PM.PLCConfig(), TP.PLCTrainConfig()
    loader = TP.PLCLoader(paths["rows72"], paths["lost"], tc, seed=SEED, val_seqs=16)
    assert len(loader) >= 1, "the corpus holds no training batch"
    batch = loader[0]
    tr = TP.PLCTrainer(cfg, tc, seed=SEED, device=dev)
    assert tr.device.type == dev.type
    metrics, ms = timed_steps(lambda: tr.train_step(batch), PIPE_STEPS)
    losses = [float(m["loss"]) for m in metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert gru_clip_holds(tr.params, ("plc_gru1", "plc_gru2"), 0.992)
    val = loader.val_batch()
    assert val["plc_input"].shape == (16, tc.seq_length, 57)
    before = {k: v.clone() for k, v in flat_params(tr.params).items()}
    e1, e2 = tr.eval_step(val), tr.eval_step(val)
    assert e1 == e2 and np.isfinite(list(e1.values())).all(), (e1, e2)
    assert all(torch.equal(before[k], v) for k, v in flat_params(tr.params).items())
    busy, wall = profile_step(lambda: tr.train_step(batch), "PLC training step "
                              f"(B={tc.batch_size}, T={tc.seq_length})", smi,
                              host_ops=False)
    step_ms = float(np.mean(ms[1:]))
    log(f"training pipeline, PLC: PLCTrainer B={tc.batch_size} T={tc.seq_length}, "
        f"{PIPE_STEPS} steps on one batch: losses " + " ".join(f"{v:.4f}" for v in losses)
        + f"; {step_ms:.1f} ms/step after the first ({ms[0]:.1f} ms; host clock, "
        f"synchronised), device busy {busy:.1f} ms of it ({100 * busy / step_ms:.1f} %); "
        f"val loss {e1['loss']:.4f} twice, params unchanged; both GRUs within the "
        f"0.992 clip; card: {smi}")

    dl = TP.PLCDeviceLoader(paths["rows72"], paths["lost"], tc, seed=SEED,
                            val_seqs=16, device=dev)
    dv = dl.val_batch()
    assert all(np.array_equal(dv[k], val[k]) for k in val), "val batch"
    feats_d, lost_d = dl.device_arrays
    assert feats_d.device.type == lost_d.device.type == dev.type
    sel = torch.as_tensor(dl.indices[:tc.batch_size], device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 71)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = dl.sample_fn(feats_d, lost_d, sel, g)
    torch.cuda.synchronize()
    sample_ms = 1e3 * (time.perf_counter() - t0)
    x, f = b["plc_input"].cpu().numpy(), feats_d[sel].cpu().numpy()
    flag = x[:, :, 56]
    lost = np.abs(flag)
    assert x.shape == (tc.batch_size, tc.seq_length, 57)
    assert set(np.unique(flag)).issubset({-1.0, 0.0, 1.0})
    assert np.array_equal(b["mask"].cpu().numpy()[:, :, 0], 1.0 - lost)
    assert np.array_equal(x[:, :, 36:56], f[:, :, 36:56] * lost[:, :, None])
    assert np.array_equal(x[:, :, :36], f[:, :, :36] * (lost * (flag + 1.0) / 2.0)[:, :, None])
    assert np.array_equal(b["target"].cpu().numpy(), f[:, :, 36:])
    lost_share = float(1.0 - lost.mean())
    log(f"training pipeline, PLCDeviceLoader: sample_fn B={tc.batch_size} on the card "
        f"{sample_ms:.2f} ms; mask, flag and target contract held; {100 * lost_share:.2f} "
        f"% of frames lost; val batch equal to the host loader's; card: {smi}")
    return {"batch": tc.batch_size, "seq_length": tc.seq_length, "steps": PIPE_STEPS,
            "losses": losses, "ms_per_step": step_ms, "first_step_ms": ms[0],
            "val_loss": e1["loss"], "device_busy_ms": busy, "profiled_step_ms": wall,
            "device_busy_share": busy / wall,
            "device_busy_share_of_step": busy / step_ms, "sample_fn_ms": sample_ms,
            "sample_fn_lost_share": lost_share}


def pipeline_rdovae(paths, dev, smi):
    """RDOVAETrainer at RDOVAEConfig() / RDOVAETrainConfig() (batch 32, 256
    frames) on the feature half: PIPE_STEPS steps on one batch with the same
    noise draw each step, eval_step at q 4 and 12 twice each, one profiled
    step."""
    from lpcnet_torch.models import rdovae as RV
    from lpcnet_torch.train import train_rdovae as TR
    cfg, tc = RV.RDOVAEConfig(), TR.RDOVAETrainConfig()
    ds = TR.RDOVAEDataset(paths["rows36"], tc, cfg, seed=SEED, val_seqs=8)
    batch = next(iter(ds))
    assert batch["features"].shape == (tc.batch_size, tc.sequence_length, cfg.num_features)
    tr = TR.RDOVAETrainer(cfg, tc, seed=SEED, device=dev)
    g = torch.Generator(device=dev)

    def step():
        g.manual_seed(SEED + 73)
        return tr.train_step(batch, g)
    metrics, ms = timed_steps(step, PIPE_STEPS)
    losses = [float(m["total"]) for m in metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for k, v in flat_params(tr.params).items():
        if v.dim() == 2:
            w = v.abs()
            assert float((w[:, 0::2] + w[:, 1::2]).max()) <= 2 * tc.weight_clip + 1e-5, k
    evals = {}
    for q in (4, 12):
        vb = ds.val_batch(q)
        a, b = tr.eval_step(vb), tr.eval_step(vb)
        assert a == b and np.isfinite(list(a.values())).all(), (q, a, b)
        evals[q] = a
    busy, wall = profile_step(step, f"RDO-VAE training step (B={tc.batch_size}, "
                              f"T={tc.sequence_length})", smi, host_ops=False)
    step_ms = float(np.mean(ms[1:]))
    log(f"training pipeline, RDO-VAE: RDOVAETrainer B={tc.batch_size} "
        f"T={tc.sequence_length}, {PIPE_STEPS} steps on one batch: total "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; {step_ms:.1f} ms/step after the first ({ms[0]:.1f} ms), device busy "
        f"{busy:.1f} ms of it ({100 * busy / step_ms:.1f} %); every 2-D leaf "
        f"within the {tc.weight_clip} clip; eval_step deterministic: q=4 total "
        f"{evals[4]['total']:.4f}, q=12 {evals[12]['total']:.4f}; card: {smi}")
    return {"batch": tc.batch_size, "seq_length": tc.sequence_length,
            "steps": PIPE_STEPS, "losses": losses, "ms_per_step": step_ms,
            "first_step_ms": ms[0], "val_total_q4": evals[4]["total"],
            "val_total_q12": evals[12]["total"], "device_busy_ms": busy,
            "profiled_step_ms": wall, "device_busy_share": busy / wall,
            "device_busy_share_of_step": busy / step_ms}


def pipeline_fit(paths, dev, smi):
    """Trainer.fit at LPCNetConfig() / TrainConfig(ema_decay=0.999), batch
    128, on the first FIT_BATCHES batches of the dumped corpus, with a
    HeldOutValidator on two 4 s clips of the seeded speech-like signal (4
    segments of 200 frames) every 2 steps, a metrics log and a best
    checkpoint. K5's and K1's counts are set to 0 just before fit and read
    just after. Returns (numbers, K1's entry keys for the kernels line)."""
    from lpcnet_torch.train.validation import HeldOutValidator
    from lpcnet_torch.weights.checkpoint import load_checkpoint
    cfg, tc = M.LPCNetConfig(), T.TrainConfig(ema_decay=0.999)
    loader = LPCNetLoader(paths["pcm"], paths["rows36"], batch_size=tc.batch_size,
                          chunk_frames=tc.chunk_frames, lookahead=tc.lookahead)
    assert len(loader) >= FIT_BATCHES, len(loader)
    batches = [loader[i] for i in range(FIT_BATCHES)]
    sig, _, _ = plc_traffic(2, int(VAL_SECONDS * 100), SEED + 63)
    clips = [np.clip(s.reshape(-1), -32767, 32767).astype(np.int16) for s in sig]
    t0 = time.perf_counter()
    val = HeldOutValidator(cfg, clips, seg_seconds=2.0, device=dev)
    val_init_s = time.perf_counter() - t0
    n_seg, n_frames = val.features.shape[:2]
    assert (n_seg, n_frames) == (4, 200) and val.features.device.type == dev.type
    eval_ms = []
    evaluate = val.evaluate

    def timed_evaluate(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = evaluate(p)
        eval_ms.append(1e3 * (time.perf_counter() - t))
        return r
    val.evaluate = timed_evaluate
    tr = T.Trainer(cfg, tc, seed=SEED, device=dev)
    logdir = os.path.join(os.path.dirname(paths["pcm"]), "fitlog")
    best = os.path.join(os.path.dirname(paths["pcm"]), "best.npz")
    G.GruRecurrence.reset_launches()
    K.synthesize_frame_kernel.launches = 0
    K.synthesize_frame_masked_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit(batches, epochs=1, log_every=FIT_BATCHES, logdir=logdir, validator=val,
           val_every=2, best_checkpoint_path=best)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k5 = dict(G.GruRecurrence.launches)
    k1 = K.synthesize_frame_kernel.launches
    k2 = K.synthesize_frame_masked_kernel.launches
    val.evaluate = evaluate
    n_evals = FIT_BATCHES // 2
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    assert k5 == {("fwd", na): FIT_BATCHES, ("fwd", nb): FIT_BATCHES,
                  ("bwd", na): FIT_BATCHES, ("bwd", nb): FIT_BATCHES}, k5
    assert k1 == n_frames * n_evals * 2 and k2 == 0, (k1, k2)
    recs = [json.loads(line) for line in open(os.path.join(logdir, "lpcnet_metrics.jsonl"))]
    assert [r["step"] for r in recs if "loss" in r] == list(range(1, FIT_BATCHES + 1))
    vals = [r for r in recs if "kind" in r]
    assert [(r["step"], r["kind"]) for r in vals] == [
        (s, k) for s in range(2, FIT_BATCHES + 1, 2) for k in ("val_raw", "val_ema")]
    assert all(np.isfinite(r["band_lsd_db"]) for r in vals)
    bparams, bcfg = load_checkpoint(best, dev)
    assert bcfg == cfg and set(flat_params(bparams)) == set(flat_params(tr.params))

    # on the card: deterministic, discriminating
    m1, m2 = evaluate(tr.params), evaluate(tr.params)
    assert m1 == m2, (m1, m2)
    m3 = evaluate(M.init_params(cfg, SEED + 5, dev))
    assert m3["band_lsd_db"] != m1["band_lsd_db"]
    # K1 (f32) at the validator's shapes against its plain version, and the
    # first 32 samples of every segment's first frame against the plain
    # synthesize_frame on the card from the same state
    with torch.no_grad():
        fused = M.fuse_inference_params(tr.params, cfg)
        kw = K.kernel_weights(fused, cfg, dtype=torch.float32)
        fs, ss = M.init_frame_state(n_seg, cfg, dev), M.init_sample_state(n_seg, cfg, dev)
        _, _, ca, cb, lpc = M.frame_network(fused, fs, val.features[:, 0], cfg)
        ca, cb, lpc = ca.contiguous(), cb.contiguous(), lpc.contiguous()
        s1k, _ = K.synthesize_frame_kernel(kw, ss, ca, cb, lpc, 1)
        s1p, _ = K.sample_loop_plain(kw, ss, ca, cb, lpc, 1)
        step_err = max(float((s1k.gru_a - s1p.gru_a).abs().max()),
                       float((s1k.gru_b - s1p.gru_b).abs().max()))
        _, pk = K.synthesize_frame_kernel(kw, ss, ca, cb, lpc)
        _, pp = M.synthesize_frame(fused, ss, ca, cb, lpc)
        first32 = [float((pk[i, :32] == pp[i, :32]).float().mean()) for i in range(n_seg)]
        assert step_err <= 1e-4, step_err
        assert min(first32) >= 0.98, first32
        k_ms = time_cuda(lambda: K.synthesize_frame_kernel(kw, ss, ca, cb, lpc), reps=20)
        p_ms = time_cuda(lambda: K.sample_loop_plain(kw, ss, ca, cb, lpc), reps=1, warmup=1)
    bound, bound_by = k1_bound_ms(kw, cfg, n_seg, 160)
    log(f"training pipeline, fit: Trainer B={tc.batch_size} T={tc.chunk_samples}, EMA "
        f"0.999, {FIT_BATCHES} steps with HeldOutValidator({n_seg} segments x {n_frames} "
        f"frames, set-up {val_init_s:.2f} s) every 2 steps: {fit_s:.2f} s; evaluations "
        + " ".join(f"{v:.0f}" for v in eval_ms) + f" ms (host clock; raw and EMA); K5 "
        f"launches {k5}, K1 (f32) {k1} = {n_frames} x {n_evals} x 2, K2 {k2}; "
        f"val_raw/val_ema records and the best checkpoint written and loaded; "
        f"band-LSD {m1['band_lsd_db']:.3f} dB twice, {m3['band_lsd_db']:.3f} on other "
        f"params; card: {smi}")
    log(f"K1[f32] at the validator's shapes (B={n_seg}, n=160): one step max|h| err "
        f"{step_err:.3e} (tol 1e-4); first 32 samples of each segment's first frame "
        f"exact against the plain synthesize_frame: {first32} (bar 0.98); kernel "
        f"{k_ms:.4f} ms/launch, plain {p_ms:.2f} ms, bound {bound:.4f} ms ({bound_by}); "
        f"card: {smi}")
    numbers = {"batch": tc.batch_size, "chunk_samples": tc.chunk_samples,
               "steps": FIT_BATCHES, "segments": n_seg, "segment_frames": n_frames,
               "evaluations": n_evals * 2, "fit_s": fit_s, "evaluate_ms": eval_ms,
               "validator_setup_s": val_init_s, "k1_launches": k1,
               "k5_launches": FIT_BATCHES, "band_lsd_db": m1["band_lsd_db"],
               "mcd_db": m1["mcd_db"], "fwsegsnr_db": m1["fwsegsnr_db"],
               "first32_exact": first32}
    k1_keys = {"launches_validator": k1, "f32_ms_validator": k_ms,
               "f32_plain_ms_validator": p_ms, "f32_bound_ms_validator": bound,
               "f32_bound_by_validator": bound_by,
               "f32_max_abs_err_validator": step_err,
               "f32_first32_exact_validator": min(first32)}
    return numbers, k1_keys


def drive_training_pipeline(dev, smi, workdir):
    """Phase 20, its corpus written under `workdir`. Returns
    ({"training_pipeline": ...} numbers, K1's keys, the corpus' paths)."""
    secs = {}
    t0 = time.perf_counter()
    out, paths = pipeline_corpus(workdir, dev, smi)
    secs["corpus"] = time.perf_counter() - t0
    out["card"] = smi
    for name, part in (("plc", pipeline_plc), ("rdovae", pipeline_rdovae),
                       ("fit", pipeline_fit)):
        t0 = time.perf_counter()
        out[name] = part(paths, dev, smi)
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["fit"], k1_keys = out["fit"]
    out["phase_s"] = secs
    log("training pipeline, seconds by part (host clock, checks included): "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + "; nothing is cut: the PLC batch and its 16 held-out sequences need "
        "144,000 frames, 1440 s of the 1500 s corpus")
    return out, k1_keys, paths


# ---------------------------------------------------------------------------
# 21. the last modules
# ---------------------------------------------------------------------------

def rel_diff(a, b):
    """The largest difference of two parameter trees' leaves over each
    leaf's largest entry; 0.0 when they are bit-equal."""
    fa, fb = flat_params(a), flat_params(b)
    assert set(fa) == set(fb)
    return max(float((fa[k] - fb[k]).abs().max()
                     / fb[k].abs().max().clamp_min(1e-12)) for k in fb)


def hold_equal(what, diff, rerun_diff):
    """Bit-equality of `what`; where the card's step is not deterministic
    run to run (`rerun_diff()`: two identical runs apart) it says so and
    holds `diff` at 1e-6 relative instead. Returns the numbers."""
    if diff == 0.0:
        return {"bit_equal": True, "max_rel": 0.0}
    again = rerun_diff()
    log(f"{what}: {diff:.3e} apart (largest leaf difference over the leaf's "
        f"largest entry); two identical runs are {again:.3e} apart")
    assert again > 0.0, f"{what}: {diff} apart, and the step is deterministic"
    log(f"{what}: the card's step is not deterministic run to run; held at "
        f"1e-6 relative")
    assert diff <= 1e-6, (what, diff)
    return {"bit_equal": False, "max_rel": diff, "run_to_run_rel": again}


@contextlib.contextmanager
def sync_debug(mode):
    """torch.cuda.set_sync_debug_mode(mode) while active; under "warn" the
    synchronising calls' warnings are collected into the yielded list."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def sync_warnings(caught):
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def last_codebooks(paths, dev, smi):
    """Codebook training at full size on phase 20's corpus (stage codes
    1024, diff codes 4096), both MSEs beside the shipped set's, the diff
    book's group structure; then a reduced size on the card and on the CPU
    from one generator seed."""
    from lpcnet_torch.codec import codebooks as CB
    feats = np.fromfile(paths["rows36"], np.float32).reshape(-1, 36)
    n_end = (feats.shape[0] - 4) // 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb = CB.train_codebooks(feats, torch.Generator().manual_seed(SEED),
                            device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    assert [tuple(b.shape) for b in cb] == [(1024, 17)] * 3 + [(4096, 18)]
    assert all(bool(torch.isfinite(b).all()) for b in cb)
    trained = CB.quantization_mse(feats, cb)
    shipped = CB.quantization_mse(feats, CB.load_codebooks(device=dev))
    # entry i serves predictor group i & 3: moving every entry to the next
    # group (rows rolled within each set of four) must cost diff MSE
    rolled = cb._replace(diff4=cb.diff4.view(-1, 4, 18).roll(1, dims=1)
                         .reshape(-1, 18))
    rolled_mse = CB.quantization_mse(feats, rolled)["diff_mse"]
    ends, mid = CB._corpus(feats, dev)
    _, recon = CB._beam_assign(ends[:, 1:], cb.stage1, cb.stage2, cb.stage3)
    left, right = CB._neighbours(torch.cat([ends[:, :1], recon], 1),
                                 mid.shape[0])
    res = CB._diff_residuals(mid, left, right)
    assert torch.equal(res[:, 0], res[:, 1]) and torch.equal(res[:, 2], mid - left)
    entry, _ = CB.quantize_diff(mid, left, right, cb.diff4)
    used = torch.bincount((entry % 4096).long() & 3, minlength=4).tolist()
    assert trained["diff_mse"] < rolled_mse and min(used) > 0, (used, rolled_mse)
    assert np.isfinite(list(trained.values())).all()
    log(f"codebooks: train_codebooks on phase 20's corpus ({feats.shape[0]} frames, "
        f"{n_end} endpoints; 3 x 1024 stage codes, 4096 diff codes, 4 m-best "
        f"passes) on the card in {train_s:.2f} s; runtime-quantizer MSE trained "
        f"stage {trained['stage_mse']:.5f} diff {trained['diff_mse']:.5f}, shipped "
        f"stage {shipped['stage_mse']:.5f} diff {shipped['diff_mse']:.5f}; the diff "
        f"book's entries rolled one group over: diff {rolled_mse:.5f}; groups used "
        f"{used}; card: {smi}")
    small = feats[:CB_SMALL_FRAMES]
    kw = dict(stage_codes=CB_SMALL_CODES, diff_codes=CB_SMALL_CODES)
    t0 = time.perf_counter()
    on_card = CB.train_codebooks(small, torch.Generator().manual_seed(SEED),
                                 device=dev, **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = CB.train_codebooks(small, torch.Generator().manual_seed(SEED),
                                device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    log(f"codebooks, reduced ({CB_SMALL_FRAMES} frames, {CB_SMALL_CODES} / "
        f"{CB_SMALL_CODES} codes, one generator seed): card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s, books max|card - CPU| {err:.3e} (bar 1e-4); card: {smi}")
    assert err <= 1e-4, err
    return {"frames": int(feats.shape[0]), "endpoints": n_end, "train_s": train_s,
            "trained": trained, "shipped": shipped, "rolled_diff_mse": rolled_mse,
            "groups_used": used, "reduced_max_abs_err": err,
            "reduced_card_s": card_s, "reduced_cpu_s": cpu_s}


def k5_k2_counts():
    """K5's launches keyed "fwd[N]" / "bwd[N]" and K2's under "k2"."""
    out = {f"{d}[{n}]": c for (d, n), c in sorted(G.GruRecurrence.launches.items())}
    out["k2"] = K.synthesize_frame_masked_kernel.launches
    return out


def reset_k5_k2():
    G.GruRecurrence.reset_launches()
    K.synthesize_frame_masked_kernel.launches = 0


def last_vocoder_block(paths, dev, smi):
    """Trainer.train_block at LPCNetConfig() / TrainConfig() (batch 128,
    2400 samples) on phase 20's corpus through DeviceLPCNetLoader: a block of
    BLOCK_STEPS against as many train_step calls and against blocks of 2,
    from one start; the blocks under torch.cuda.set_sync_debug_mode; then a
    block of SS_BLOCK_STEPS with ss_prob=0.25."""
    from lpcnet_torch.utils.rng import fold_seed
    cfg, tc = M.LPCNetConfig(), T.TrainConfig()
    loader = DeviceLPCNetLoader(paths["pcm"], paths["rows36"], batch_size=tc.batch_size,
                                chunk_frames=tc.chunk_frames, lookahead=tc.lookahead,
                                seed=SEED, device=dev)
    sels = next(loader.index_blocks(BLOCK_STEPS))
    assert sels.shape == (BLOCK_STEPS, tc.batch_size) and sels.dtype == np.int32
    new = lambda t=tc: T.Trainer(cfg, t, seed=SEED, device=dev)

    def block(tr, parts, mode="error"):
        reset_k5_k2()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off, ms = 0, []
        with sync_debug(mode) as caught:
            for k in parts:
                ms.append(tr.train_block(loader, sels[off:off + k]))
                off += k
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return ms, secs, k5_k2_counts(), sync_warnings(caught)

    def steps(tr):
        reset_k5_k2()
        out, times = [], []
        for sel in sels:
            g = torch.Generator(device=dev)
            g.manual_seed(fold_seed(T.Trainer.BLOCK_SEED, tr.step))
            batch = loader.sample(torch.as_tensor(sel, device=dev).long())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(tr.train_step(batch, g))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, times, k5_k2_counts()

    a = new()
    ma, a_s, a_counts, a_sync = block(a, [BLOCK_STEPS], mode="warn")
    log(f"train_block [vocoder]: the default block of {BLOCK_STEPS} under "
        f"set_sync_debug_mode('warn'): {len(a_sync)} synchronising calls"
        + ("" if not a_sync else f": {sorted(set(a_sync))[:4]}"))
    assert not a_sync, a_sync
    b = new()
    mb, b_times, b_counts = steps(b)
    c = new()
    mc, c_s, c_counts, c_sync = block(c, [2, 2], mode="error")
    assert a.step == b.step == c.step == BLOCK_STEPS
    la = ma[0]["loss"].cpu().numpy()
    lb = np.array([float(m["loss"]) for m in mb])
    lc = np.concatenate([m["loss"].cpu().numpy() for m in mc])
    assert np.isfinite(la).all() and la.shape == (BLOCK_STEPS,)

    def rerun():
        d = new()
        block(d, [BLOCK_STEPS])
        return rel_diff(d.params, a.params)
    vs_steps = hold_equal("train_block [vocoder], one block against its steps",
                          rel_diff(a.params, b.params), rerun)
    vs_split = hold_equal("train_block [vocoder], 1 x 4 against 2 x 2",
                          rel_diff(a.params, c.params), rerun)
    if vs_steps["bit_equal"]:
        assert np.array_equal(la, lb), (la, lb)
    if vs_split["bit_equal"]:
        assert np.array_equal(la, lc), (la, lc)
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    want = {f"{d}[{n}]": BLOCK_STEPS for d in ("bwd", "fwd") for n in (nb, na)}
    want["k2"] = 0
    assert a_counts == b_counts == c_counts == want, (a_counts, b_counts, c_counts)
    block_ms = 1e3 * c_s / BLOCK_STEPS
    step_ms = 1e3 * float(np.mean(b_times[1:]))
    log(f"train_block [vocoder]: B={tc.batch_size} T={tc.chunk_samples}, losses "
        + " ".join(f"{v:.4f}" for v in la) + f"; block {1e3 * a_s / BLOCK_STEPS:.1f} "
        f"(first), {block_ms:.1f} ms/step (2 x 2, under 'error': nothing raised) "
        f"against {step_ms:.1f} ms/step of train_step calls with a synchronise each "
        f"(after the first, {1e3 * b_times[0]:.1f}); launches in a block of "
        f"{BLOCK_STEPS}: {a_counts}; params "
        f"{'bit-equal' if vs_steps['bit_equal'] else vs_steps['max_rel']} against "
        f"the steps, {'bit-equal' if vs_split['bit_equal'] else vs_split['max_rel']} "
        f"against 2 x 2; card: {smi}")
    del a, b, c
    torch.cuda.empty_cache()

    s = new(dataclasses.replace(tc, ss_prob=0.25))
    ms, s_s, s_counts, s_sync = block(s, [SS_BLOCK_STEPS], mode="warn")
    ls = ms[0]["loss"].cpu().numpy()
    assert np.isfinite(ls).all()
    assert s_counts == dict({k: SS_BLOCK_STEPS for k in want if k != "k2"},
                            k2=tc.chunk_frames * SS_BLOCK_STEPS), s_counts
    log(f"train_block [vocoder, ss_prob=0.25]: a block of {SS_BLOCK_STEPS}, "
        f"{1e3 * s_s / SS_BLOCK_STEPS:.1f} ms/step; K2 launches {s_counts['k2']}; "
        f"{len(s_sync)} synchronising calls under 'warn'"
        + ("" if not s_sync else f": {sorted(set(s_sync))[:4]}") + f"; card: {smi}")
    del s
    torch.cuda.empty_cache()
    return {"block_steps": BLOCK_STEPS, "losses": la.tolist(),
            "block_ms_per_step": block_ms, "first_block_ms_per_step": 1e3 * a_s / BLOCK_STEPS,
            "train_step_ms": step_ms, "vs_steps": vs_steps, "vs_2x2": vs_split,
            "launches": a_counts, "sync_calls_default": len(a_sync),
            "ss_block_ms_per_step": 1e3 * s_s / SS_BLOCK_STEPS,
            "ss_launches": s_counts, "sync_calls_ss": len(s_sync),
            "sync_calls_ss_kinds": sorted(set(s_sync))}


def last_plc_block(paths, dev, smi):
    """PLCTrainer.train_block at PLCConfig() / PLCTrainConfig() (batch 128,
    1000 frames) over PLCDeviceLoader: a block of PLC_BLOCK_STEPS against as
    many train_step calls on the same batches and against blocks of 1."""
    from lpcnet_torch.train import train_plc as TP
    from lpcnet_torch.utils.rng import fold_seed
    cfg, tc = PM.PLCConfig(), TP.PLCTrainConfig()
    dl = TP.PLCDeviceLoader(paths["rows72"], paths["lost"], tc, seed=SEED, device=dev)
    # the corpus holds one batch an epoch: a block's steps take two epochs'
    rows = []
    for _ in range(PLC_BLOCK_STEPS):
        rows.append(next(dl.index_blocks(1)))
        dl.on_epoch_end()
    sels = np.concatenate(rows)
    feats_d, lost_d = dl.device_arrays
    new = lambda: TP.PLCTrainer(cfg, tc, seed=SEED, device=dev)

    a = new()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_debug("warn") as caught:
        ma = a.train_block(dl, sels)
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    a_sync = sync_warnings(caught)
    b = new()
    lb, b_times = [], []
    for sel in sels:
        g = torch.Generator(device=dev)
        g.manual_seed(fold_seed(TP.PLCTrainer.BLOCK_SEED, b.step))
        batch = dl.sample_fn(feats_d, lost_d, torch.as_tensor(sel, device=dev).long(), g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lb.append(float(b.train_step(batch)["loss"]))
        torch.cuda.synchronize()
        b_times.append(time.perf_counter() - t0)
    c = new()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = [c.train_block(dl, sels[k:k + 1])["loss"] for k in range(len(sels))]
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    lc = [float(m[0]) for m in mc]
    la = ma["loss"].cpu().numpy()
    assert np.isfinite(la).all() and a.step == b.step == c.step == PLC_BLOCK_STEPS

    def rerun():
        d = new()
        d.train_block(dl, sels)
        return rel_diff(d.params, a.params)
    vs_steps = hold_equal("train_block [PLC], one block against its steps",
                          rel_diff(a.params, b.params), rerun)
    vs_split = hold_equal("train_block [PLC], 1 x 2 against 2 x 1",
                          rel_diff(a.params, c.params), rerun)
    if vs_steps["bit_equal"]:
        assert np.array_equal(la, np.float32(lb)), (la, lb)
    if vs_split["bit_equal"]:
        assert np.array_equal(la, np.float32(lc)), (la, lc)
    block_ms = 1e3 * c_s / PLC_BLOCK_STEPS
    step_ms = 1e3 * float(np.mean(b_times))
    log(f"train_block [PLC]: B={tc.batch_size} T={tc.seq_length}, losses "
        + " ".join(f"{v:.4f}" for v in la) + f"; block {1e3 * a_s / PLC_BLOCK_STEPS:.1f} "
        f"(first), {block_ms:.1f} ms/step (2 x 1, after the steps) against "
        f"{step_ms:.1f} ms/step of train_step calls; {len(a_sync)} synchronising "
        f"calls under 'warn'; params "
        f"{'bit-equal' if vs_steps['bit_equal'] else vs_steps['max_rel']} against the "
        f"steps, {'bit-equal' if vs_split['bit_equal'] else vs_split['max_rel']} "
        f"against 2 x 1; card: {smi}")
    del a, b, c
    torch.cuda.empty_cache()
    return {"block_steps": PLC_BLOCK_STEPS, "losses": la.tolist(),
            "block_ms_per_step": block_ms,
            "first_block_ms_per_step": 1e3 * a_s / PLC_BLOCK_STEPS,
            "train_step_ms": step_ms,
            "vs_steps": vs_steps, "vs_2x1": vs_split, "sync_calls": len(a_sync)}


def last_mesh(paths, dev, smi, workdir):
    """The trainers over torch.distributed with NCCL at world size 1: the
    vocoder's Trainer with a mesh for MESH_STEPS steps at full width against
    one without, the PLC and RDO-VAE trainers one step each with the mesh,
    and the time of the one all-reduce a step."""
    import torch.distributed as dist
    from lpcnet_torch.models import rdovae as RV
    from lpcnet_torch.parallel import mesh as PX
    from lpcnet_torch.train import train_plc as TP
    from lpcnet_torch.train import train_rdovae as TR
    PX.init_distributed("nccl", f"file://{os.path.join(workdir, 'nccl_store')}", 1, 0)
    try:
        mesh = PX.make_mesh()
        assert mesh.group is not None and mesh.world_size == 1
        assert mesh.device.type == dev.type
        cfg, tc = M.LPCNetConfig(), T.TrainConfig()
        loader = LPCNetLoader(paths["pcm"], paths["rows36"], batch_size=tc.batch_size,
                              chunk_frames=tc.chunk_frames, lookahead=tc.lookahead)
        batches = [loader[i] for i in range(MESH_STEPS)]

        def run(m):
            tr = T.Trainer(cfg, tc, seed=SEED, device=dev, mesh=m)
            ms = []
            for i, batch in enumerate(batches):
                g = torch.Generator(device=dev)
                g.manual_seed(SEED + 81 + i)
                ms.append(float(tr.train_step(batch, g)["loss"]))
            return tr, ms
        with_mesh, lm = run(mesh)
        without, l0 = run(None)
        res = hold_equal("mesh [vocoder, NCCL, world size 1] against no mesh",
                         rel_diff(with_mesh.params, without.params),
                         lambda: rel_diff(run(None)[0].params, without.params))
        if res["bit_equal"]:
            assert lm == l0, (lm, l0)
        grads = [p.grad for p in T._leaves(with_mesh.params)]
        n_floats = sum(g.numel() for g in grads)
        ar_ms = time_cuda(lambda: PX.all_reduce_mean(mesh, grads), reps=20)
        del with_mesh, without
        torch.cuda.empty_cache()

        ptc = TP.PLCTrainConfig()
        pl = TP.PLCLoader(paths["rows72"], paths["lost"], ptc, seed=SEED)
        ptr = TP.PLCTrainer(PM.PLCConfig(), ptc, seed=SEED, mesh=mesh)
        pm = float(ptr.train_step(pl[0])["loss"])
        rcfg, rtc = RV.RDOVAEConfig(), TR.RDOVAETrainConfig()
        ds = TR.RDOVAEDataset(paths["rows36"], rtc, rcfg, seed=SEED)
        rtr = TR.RDOVAETrainer(rcfg, rtc, seed=SEED, mesh=mesh)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 83)
        rm = float(rtr.train_step(next(iter(ds)), g)["total"])
        assert np.isfinite([pm, rm]).all(), (pm, rm)
        assert all(bool(torch.isfinite(v).all()) for t in (ptr, rtr)
                   for v in flat_params(t.params).values())
        del ptr, rtr
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(f"mesh: init_distributed('nccl', file://, 1, 0) and make_mesh() on {mesh.device}; "
        f"Trainer with the mesh, {MESH_STEPS} steps at full width: losses "
        + " ".join(f"{v:.4f}" for v in lm) + f", params "
        f"{'bit-equal' if res['bit_equal'] else res['max_rel']} against the trainer "
        f"without one; the one all_reduce a step over {n_floats} floats "
        f"({4 * n_floats / 1e6:.2f} MB) {ar_ms:.4f} ms (CUDA events); PLCTrainer and "
        f"RDOVAETrainer one step each with the mesh: loss {pm:.4f}, total {rm:.4f}, "
        f"finite. One card measures world size 1 only: the reduction's bus time "
        f"across cards is not measured; card: {smi}")
    return {"world_size": 1, "backend": "nccl", "vs_no_mesh": res, "losses": lm,
            "all_reduce_ms": ar_ms, "all_reduce_floats": n_floats,
            "plc_loss": pm, "rdovae_total": rm}


def last_ablation(dev, smi):
    """tools/profile_plc_torch.py's sweep at ABL_STREAMS streams on the demo
    models: the causal frame with each ablation name and with all of them,
    ABL_FRAMES frames a variant in each of the tool's rounds."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "profile_plc_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "tools", "profile_plc_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    bench = tool.FrameBench(ABL_STREAMS, dev)
    res, saved = tool.ablation_sweep(bench, ABL_FRAMES)
    assert BP._ABLATE == frozenset()
    full = res["full"]
    split = {n: saved[n] for n in BP.ABLATION_NAMES}
    log(f"PLC ablation sweep ({ABL_STREAMS} streams, {ABL_FRAMES} frames a variant, "
        f"medians of {tool.ROUNDS} rounds, CUDA events): full frame {full:.3f} ms; "
        f"component share " + ", ".join(f"{n} {v:.3f}" for n, v in split.items())
        + f"; all six ablated (the rump) {res['ALL']:.3f} ms; card: {smi}")
    return {"streams": ABL_STREAMS, "frames": ABL_FRAMES, "rounds": tool.ROUNDS,
            "ms": res, "component_ms": split}


def last_pade(dev, smi):
    from lpcnet_torch.utils import pade
    p, q = pade.fit_pade_odd(device=dev)
    pc, qc = pade.fit_pade_odd(device="cpu")
    err = max(float((p.cpu() - pc).abs().max()), float((q.cpu() - qc).abs().max()))
    e_card, e_cpu = pade.tanh_pade_error(device=dev), pade.tanh_pade_error(device="cpu")
    log(f"pade: fit_pade_odd on the card against the CPU, coefficients max|diff| "
        f"{err:.3e} (bar 1e-9); tanh max error {e_card:.6e} (card) {e_cpu:.6e} (CPU); "
        f"card: {smi}")
    assert err <= 1e-9, err
    return {"coef_max_abs_err": err, "tanh_err_card": e_card, "tanh_err_cpu": e_cpu}


def drive_last_modules(paths, dev, smi, workdir):
    """Phase 21. Returns the {"last_modules": ...} numbers."""
    out, secs = {"card": smi}, {}
    for name, part in (("codebooks", lambda: last_codebooks(paths, dev, smi)),
                       ("vocoder_block", lambda: last_vocoder_block(paths, dev, smi)),
                       ("plc_block", lambda: last_plc_block(paths, dev, smi)),
                       ("mesh", lambda: last_mesh(paths, dev, smi, workdir)),
                       ("ablation", lambda: last_ablation(dev, smi)),
                       ("pade", lambda: last_pade(dev, smi))):
        t0 = time.perf_counter()
        out[name] = part()
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["phase_s"] = secs
    log("last modules, seconds by part (host clock, checks included): "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out


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
    native_s = build_native_runtime()

    # 2. K1 vs plain
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    check_k1(fused, cfg, dev)
    check_k1_batches(fused, cfg, dev)

    # 3. the main path, then 4. timings on its own inputs
    feats = features(MAIN_BATCH, MAIN_FRAMES, SEED)
    entries = []
    main_frame_ms = {}
    for int8 in (False, True):
        form = "q8" if int8 else "bf16"
        pcm, secs, launches, kw, synth = drive_main_path(int8, dev, feats)
        main_frame_ms[form] = 1e3 * secs / MAIN_FRAMES
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
    k2_plc_ms, k2_plc_err, k2_plc_bound, plc_entries = time_plc_kernels(
        calls, models, counts, chain_counts, frame_ms, smi)
    entries.extend(plc_entries)
    k2_entry = next(e for e in entries if e["name"] == "sample_loop_masked[bf16]")
    k2_entry["launches_plc_path"] = counts[0] + chain_counts[0]
    k2_entry["ms_plc_path"] = k2_plc_ms
    k2_entry["max_abs_err_plc_path"] = max(k2_plc_err)
    k2_entry["bound_ms_plc_path"] = k2_plc_bound

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

    # 16-19. the factored q8 embedding: K1, K2 and K3 vs their plain
    # versions and timed beside the composed form; the served paths on the
    # int8 factored vocoder; `cli synthesis --sampling pdf`
    t0 = time.perf_counter()
    fq, cfg_q, comp, fact = q8_bundles(dev)
    fact_entries = [check(cfg_q, comp, fact, fq, dev, smi) for check in
                    (check_k1_factored, check_k2_factored, check_k3_factored)]
    del comp, fact
    launches, syn_ms, plc_ms = drive_factored_paths(dev, smi, feats, main_frame_ms["q8"])
    for entry, n in zip(fact_entries, launches):
        entry["launches"] = n
    fact_entries[0]["ms_frame_synthesis"] = syn_ms
    fact_entries[1]["ms_frame_plc"] = fact_entries[2]["ms_frame_plc"] = plc_ms
    entries.extend(fact_entries)
    assert len(entries) == 13 and all(e["launches"] > 0 for e in entries), entries
    pdf_secs, pdf_frame_ms = cli_pdf_on_card(dev, smi)
    log(f"factored and pdf phases: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as workdir:
        # 20. the training pipeline: corpus, dump_data, the PLC and RDO-VAE
        # trainers, the vocoder trainer with held-out validation through K1
        t0 = time.perf_counter()
        pipeline, k1_keys, paths = drive_training_pipeline(dev, smi, workdir)
        pipeline["native_build_s"] = native_s
        entries[0].update(k1_keys)
        assert len(entries) == 13 and all(e["launches"] > 0 for e in entries), entries
        log(f"training pipeline phase: {time.perf_counter() - t0:.1f} s")

        # 21. the last modules: codebook training, train_block, the mesh,
        # the PLC ablation sweep, the Pade fitter; K5's and K2's counts of
        # the vocoder's blocks join their kernels-line entries
        t0 = time.perf_counter()
        last = drive_last_modules(paths, dev, smi, workdir)
        block = last["vocoder_block"]
        for e in entries:
            if e["name"].startswith("gru_train_"):
                e["launches_train_block"] = block["launches"][e["name"][10:]]
            if e["name"] == "sample_loop_masked[bf16]":
                e["launches_train_block_ss"] = block["ss_launches"]["k2"]
        log(f"last modules phase: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"dred": dred}))
    print(json.dumps({"pdf_sampling": {"cli_s": pdf_secs, "frame_ms": pdf_frame_ms,
                                       "frames": MAIN_FRAMES, "streams": 1}}))
    print(json.dumps({"training_pipeline": pipeline}))
    print(json.dumps({"last_modules": last}))
    print(json.dumps({"kernels": entries}))
    print(smi)          # nvidia-smi: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
