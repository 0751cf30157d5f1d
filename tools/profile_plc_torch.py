#!/usr/bin/env python3
"""On-card cost split of lpcnet_torch's batched PLC frame step (the causal
fused step, `plc.batched._plc_frame_step_fused`) on one CUDA card.

    [LPCNET_BENCH_BATCH=256] [LPCNET_PLC_ABLATE=1|ALL|name,name]
        python tools/profile_plc_torch.py

On the shipped demo vocoder and demo PLC network at LPCNET_BENCH_BATCH
streams (default 256) it times, with CUDA events over N_IN calls after two
warm-up calls and a synchronise, each frame-rate component alone:

  burg        burg_cepstral_analysis on [B, 160]
  enc         one compute_single_frame_features step
  fnet        one frame_network call with the masked select of _fnet_masked
  plcpred     one PLC-net prediction with the masked select
  tail80      one 80-step sampled call of K2 (every stream advancing)
  tail160tf   one 160-step teacher-forced call of K2 with the sampler off
  tf_fast160  one block of 160 teacher-forced steps through K3
  full        the causal fused frame step, from a state warmed by 20 frames
              of the traffic (10 % of the streams lost each frame)

With LPCNET_PLC_ABLATE (1 for every name, ALL for all at once, or a comma
list) it then sweeps the step's ablation set (`plc.batched._ABLATE`): each
named component is replaced by its stand-in inside the same frame step, and
the frame's time against the full frame's is that component's share. ALL
leaves the bookkeeping rump. The frame is host-bound and its time drifts
by more than a small component's share from one timing to the next, so
the sweep runs ROUNDS rounds, each timing the full frame and every variant
in turn, and takes the median of each variant's time and of its paired
difference to the full frame. Only this tool reads the variable.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lpcnet_torch import api  # noqa: E402
from lpcnet_torch.codec import features as F  # noqa: E402
from lpcnet_torch.dsp.burg import burg_cepstral_analysis  # noqa: E402
from lpcnet_torch.kernels import sample_loop as K  # noqa: E402
from lpcnet_torch.models import lpcnet as M  # noqa: E402
from lpcnet_torch.models import plc as PM  # noqa: E402
from lpcnet_torch.plc import batched as BP  # noqa: E402

SWEEP = BP.ABLATION_NAMES + ("ALL",)
N_IN = 20
WARM_FRAMES = 20
ROUNDS = 3


def time_events(fn, n=N_IN, warm=2):
    """ms a call of fn(), CUDA events over n calls after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def load_models(dev):
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, device=dev)
    return fused, cfg, api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device=dev)


def traffic(b, frames, dev, seed=0):
    """Seeded frames of noisy tones [frames, B, 160] and a loss mask
    [frames, B] (10 % of the streams each frame)."""
    rs = np.random.RandomState(seed)
    t = np.arange(frames * 160) / 16000.0
    f0 = rs.uniform(90, 220, (b, 1))
    pcm = np.round(3000 * np.sin(2 * np.pi * f0 * t)
                   + 100 * rs.standard_normal((b, frames * 160)))
    pcm = pcm.astype(np.float32).reshape(b, frames, 160).transpose(1, 0, 2)
    lost = rs.rand(frames, b) < 0.10
    return (torch.from_numpy(np.ascontiguousarray(pcm)).to(dev),
            torch.from_numpy(lost).to(dev))


def components(b, dev):
    """{component: ms a call} of the pieces alone."""
    fused, cfg, plc_params = load_models(dev)
    kw = K.masked_kernel_weights(K.kernel_weights(fused, cfg))
    rs = np.random.RandomState(0)
    pcm = torch.from_numpy((rs.randn(b, 160) * 2000).astype(np.float32)
                           ).to(dev)
    active = torch.from_numpy(rs.rand(b) < 0.5).to(dev)
    sel = lambda n, o: torch.where(
        active.reshape((b,) + (1,) * (n.dim() - 1)), n, o)
    out = {"burg": time_events(lambda: burg_cepstral_analysis(pcm))}
    enc = F.init_encoder_state(b, dev)
    out["enc"] = time_events(lambda: F.compute_single_frame_features(enc, pcm))
    fstate = M.init_frame_state(b, cfg, dev)
    feats36 = torch.zeros((b, 36), dtype=torch.float32, device=dev)

    def fnet():
        new, _, ca, cb, lpc = M.frame_network(fused, fstate, feats36, cfg)
        return BP.tree_map(sel, new, fstate), ca
    out["fnet"] = time_events(fnet)
    pstate = PM.init_state(b, device=dev)
    inp = torch.zeros((b, PM.PLC_INPUT_SIZE), dtype=torch.float32, device=dev)

    def plcpred():
        new, pred = PM.compute_plc_pred(plc_params, pstate, inp)
        return BP.tree_map(sel, new, pstate), pred
    out["plcpred"] = time_events(plcpred)
    sstate = M.init_sample_state(b, cfg, dev)
    z = lambda n: torch.zeros((b, n), dtype=torch.float32, device=dev)
    ca, cb, lpc = z(3 * cfg.rnn_units1), z(3 * cfg.rnn_units2), z(16)
    for name, n, sampled in (("tail80", 80, True), ("tail160tf", 160, False)):
        adv = torch.ones((b, n), dtype=torch.bool, device=dev)
        tf = adv if not sampled else torch.zeros_like(adv)
        out[name] = time_events(lambda: K.synthesize_frame_masked_kernel(
            kw, sstate, ca, cb, lpc, z(n), tf, adv, n, sampled))
    tgt = torch.from_numpy((rs.randn(b, 160) * 2000).astype(np.float32)
                           ).to(dev)
    count = torch.full((b, 1), 160, dtype=torch.int32, device=dev)
    out["tf_fast160"] = time_events(lambda: K.teacher_force_blocks_kernel(
        kw, sstate, ca[:, None], cb[:, None], lpc[:, None], tgt, count, 160))
    return out


class FrameBench:
    """The causal fused step on the demo models at `b` streams, from a
    state warmed by WARM_FRAMES frames of the traffic; `ms(frames)` times
    `frames` more frames from that state (ms a frame)."""

    def __init__(self, b, dev):
        fused, cfg, plc_params = load_models(dev)
        self.plc = BP.BatchedPLC(fused, cfg, plc_params, batch=b, device=dev)
        self.pcm, self.lost = traffic(b, WARM_FRAMES + 64, dev)
        for k in range(WARM_FRAMES):
            self.plc.step_tensors(self.pcm[k], self.lost[k])
        self.state = self.plc.state

    def run(self, frames):
        self.plc.state = self.state
        out = None
        for k in range(frames):
            out = self.plc.step_tensors(self.pcm[WARM_FRAMES + k],
                                        self.lost[WARM_FRAMES + k])
        return out

    def ms(self, frames):
        self.run(2)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.run(frames)
        end.record()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        return start.elapsed_time(end) / frames


def ablation_sweep(bench: FrameBench, frames: int, names=SWEEP,
                   rounds: int = ROUNDS):
    """({"full": ms a frame, name: ms a frame with `name` ablated (ALL:
    every name at once)}, {name: ms the ablation saves}): medians over
    `rounds` rounds of `frames` frames a variant, the saving paired with
    the full frame of its round. `_ABLATE` is empty again after."""
    times = {n: [] for n in ("full",) + tuple(names)}
    try:
        for _ in range(rounds):
            for name in times:
                BP._ABLATE = (frozenset() if name == "full" else
                              frozenset(BP.ABLATION_NAMES) if name == "ALL"
                              else frozenset({name}))
                times[name].append(bench.ms(frames))
    finally:
        BP._ABLATE = frozenset()
    med = lambda v: float(np.median(v))
    saved = {n: med([f - t for f, t in zip(times["full"], times[n])])
             for n in names}
    return {n: med(v) for n, v in times.items()}, saved


def main():
    if not torch.cuda.is_available():
        print("profile_plc_torch: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    b = int(os.environ.get("LPCNET_BENCH_BATCH", "256"))
    print(f"batched PLC at {b} streams on {torch.cuda.get_device_name(0)}",
          flush=True)
    for name, ms in components(b, dev).items():
        print(f"{name:10s} {ms:8.3f} ms a call", flush=True)
    bench = FrameBench(b, dev)
    full = bench.ms(N_IN)
    print(f"{'full':10s} {full:8.3f} ms a frame (budget for real time: 10 ms)",
          flush=True)
    abl = os.environ.get("LPCNET_PLC_ABLATE", "0")
    if abl == "0":
        return 0
    names = SWEEP if abl == "1" else (("ALL",) if abl == "ALL"
                                      else tuple(abl.split(",")))
    unknown = set(names) - set(SWEEP)
    if unknown:
        raise SystemExit(f"unknown ablation names {sorted(unknown)}; "
                         f"known: {', '.join(SWEEP)}")
    res, saved = ablation_sweep(bench, N_IN, names)
    print(f"\nablation split (the frame with the component replaced by its "
          f"stand-in inside the same step; medians of {ROUNDS} rounds):",
          flush=True)
    for name in names:
        if name == "ALL":
            print(f"-ALL       {res[name]:8.3f} ms a frame: the bookkeeping "
                  f"rump", flush=True)
        else:
            print(f"-{name:9s} {res[name]:8.3f} ms a frame: component "
                  f"~{saved[name]:7.3f} ms of {res['full']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
