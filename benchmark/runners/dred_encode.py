"""DRED encoding: `DREDEncoderPool.step_pcm` at a fixed number of attached
streams, every stream 320 samples (20 ms) a tick in and one redundancy
payload out: the newest latents, coded from level q0 (newest) to q1
(oldest), with the PVQ-coded initial state of the decoder.

The reference replays the recorded ticks from the program's state before
each (`reference/<config>.py`): the analysis and the encoder step from the
program's states, the payload window of the program's older latents and
the reference's newest, its symbols, the PVQ search and, for a seeded
sample of streams, the framed payload from the Python range coder. Numbers
compared: the largest difference of the newest unquantised latents over
their largest magnitude (`latent_gap`); the share of the window's symbols
that differ (`symbol_mismatch`); the share of streams whose PVQ pulses
differ (`pulse_mismatch`); the share of the sampled (stream, tick) payloads
whose bytes differ (`payload_mismatch`); and of every stream after every
replayed tick, and of every stream at attach against a fresh stream, the
share whose analysis or encoder state departs from the reference's
(`state_apart`, `compare.apart_rows`).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .. import generate as G
from .. import weights as W
from ..reference import compare as C
from ..yardstick import work_dred
from .common import clone_tree, free_device
from .serving import ServeRunner

FRAME = 160
CHUNK = 128     # streams of speech made at a time at set-up


class Runner(ServeRunner):
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        self.c, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ref = reference
        self.streams = b = traffic["streams"]
        self.tick_audio_s = traffic["tick_audio_s"]
        red = traffic["redundancy"]
        self.frames, self.q0, self.q1 = red["frames"], red["q0"], red["q1"]
        self.n_lat = self.frames // 2
        self.raw = W.load_npz(W.ROOT / config["trained_weights"], device)
        # [ticks, streams, 320] int16 on the host: a tick hands the pool
        # its PCM as a network would
        gen = G.device_generator(G.sub_seed(seed, 1), device)
        ticks = traffic["audio_ticks"]
        self.audio = np.empty((ticks, b, 2 * FRAME), np.int16)
        for s0 in range(0, b, CHUNK):
            n = min(CHUNK, b - s0)
            pcm = G.speech(n, ticks * 2 * FRAME, traffic["speech"], gen, device)
            self.audio[:, s0:s0 + n] = pcm.reshape(n, ticks, 2 * FRAME).transpose(
                0, 1).to(torch.int16).cpu().numpy()

    # ---- the program ------------------------------------------------------

    def setup(self):
        from lpcnet_torch.models import rdovae as RV
        from lpcnet_torch.runtime.serving import DREDEncoderPool
        cfg = RV.RDOVAEConfig(**{k: self.c[k] for k in
                                 RV.RDOVAEConfig.__dataclass_fields__})
        self.pool = DREDEncoderPool(W.clone(self.raw), cfg, streams=self.streams,
                                    num_redundancy_frames=self.frames,
                                    q0=self.q0, q1=self.q1, device=self.device)
        self.start_state = self.snapshot()
        # every timed tick makes a full payload: the window is full first
        for _ in range(max(self.traffic["warmup_ticks"], self.n_lat)):
            self.step(self.inputs(self.next_tick))
            self.next_tick += 1

    def inputs(self, i: int) -> np.ndarray:
        return self.audio[i % len(self.audio)]

    def step(self, pcm: np.ndarray) -> dict:
        return self.pool.step_pcm(pcm)

    def rows(self, x):
        """Inputs and outputs are in slot order already."""
        return x

    def snapshot(self):
        p, e = self.pool, self.pool.enc
        window = lambda w: torch.stack(w, 1).clone() if w else None
        return types.SimpleNamespace(features=clone_tree(p.features),
                                     encoder=clone_tree(e.state),
                                     z=window(e.z_window), st=window(e.state_window))

    def restore(self, snap) -> None:
        p, e = self.pool, self.pool.enc
        p.features = clone_tree(snap.features)
        e.state = clone_tree(snap.encoder)
        e.z_window = [] if snap.z is None else list(snap.z.clone().unbind(1))
        e.state_window = [] if snap.st is None else list(snap.st.clone().unbind(1))

    def facts(self) -> dict:
        ticks = self.window_ticks[1] - self.window_ticks[0]
        return {"streams": self.streams, "window_s": self.window_s,
                "ticks": ticks,
                "least_compute_s": ticks * work_dred.tick_seconds(self.c, self.streams),
                "traced_ticks": self.traced_ticks[1] - self.traced_ticks[0]}

    def counters(self) -> dict:
        return dict(self.pool.stats)

    def free(self):
        self.pool = None
        free_device()

    # ---- the reference ----------------------------------------------------

    def payload_streams(self, tick: int) -> np.ndarray:
        """The streams whose payload bytes the reference codes at `tick`."""
        rs = np.random.Generator(np.random.PCG64(G.sub_seed(self.seed, 3, tick)))
        n = min(self.traffic["payload_check_streams"], self.streams)
        return np.sort(rs.choice(self.streams, n, replace=False))

    def check(self) -> dict:
        R = self.ref
        cfg = R.model_config(self.c)
        k = cfg.pvq_num_pulses
        stats = R.stats_fixed_point(self.raw, cfg)
        template = R.init_state(self.streams, cfg, self.device)
        apart = int(C.apart_rows(template, self.start_state).sum())
        states = self.streams
        gap, sym_apart, sym_n, pulse_apart, pay_apart, pay_n = 0.0, 0, 0, 0, 0, 0
        for i, before, pcm, out, after in self.records:
            new, z, st = R.encode_tick(self.raw, cfg, C.rebuild(template, before),
                                       torch.as_tensor(pcm, device=self.device))
            # a program that kept no latent reads as one of zeros
            mine = torch.zeros_like(z) if after.z is None else after.z[:, -1]
            scale = max(float(z.abs().max()), 1e-30)
            gap = max(gap, float((z - mine.to(z.device)).abs().max()) / scale)
            apart += int(C.apart_rows(new, after).sum())
            states += self.streams
            checked = self.payload_streams(i)
            if out is None:         # no payload where one was due: all apart
                n_sym = self.streams * self.n_lat * cfg.latent_dim
                sym_apart, sym_n = sym_apart + n_sym, sym_n + n_sym
                pulse_apart += self.streams
                pay_apart, pay_n = pay_apart + len(checked), pay_n + len(checked)
                continue
            window = torch.cat([before.z[:, 1 - self.n_lat:].to(z.device),
                                z[:, None]], dim=1)
            zq = R.symbols(self.raw, cfg, window, self.q0, self.q1).cpu().numpy()
            sym_apart += int((zq != out["zq"]).sum())
            sym_n += zq.size
            pulses = R.pvq_rows(st, k)
            pulse_apart += int((pulses != out["pulses"]).any(axis=1).sum())
            for b in checked:
                ref = R.encode_payload(zq[b], pulses[b], self.q0, self.q1, stats, k)
                pay_apart += int(ref != out["payloads"][b])
                pay_n += 1
        n = len(self.records) * self.streams
        return {"latent_gap": gap, "symbol_mismatch": sym_apart / sym_n,
                "pulse_mismatch": pulse_apart / n,
                "payload_mismatch": pay_apart / pay_n,
                "state_apart": apart / states}

    def control(self, n_ticks: int) -> dict:
        """The reference with its encoder's weights and the operands of its
        dense, GRU and conv products rounded to bfloat16 in the program's
        place: the cell's warm-up and `n_ticks` ticks of its traffic, every
        tick recorded (payload bytes for the streams the check samples),
        then judged as `check` judges a run."""
        R = self.ref
        cfg = R.model_config(self.c)
        k = cfg.pvq_num_pulses
        stats = R.stats_fixed_point(self.raw, cfg)
        low = R.bf16_encoder(self.raw)
        state = R.init_state(self.streams, cfg, self.device)
        self.start_state, self.records = state, []
        zs, sts = [], []
        warm = max(self.traffic["warmup_ticks"], self.n_lat)
        for i in range(warm + n_ticks):
            pcm = self.inputs(i)
            new, z, st = R.encode_tick(low, cfg, state,
                                       torch.as_tensor(pcm, device=self.device),
                                       rnd=R.bf16)
            before = types.SimpleNamespace(
                features=state.features, encoder=state.encoder,
                z=torch.stack(zs[-self.n_lat:], 1) if zs else None)
            zs, sts = (zs + [z])[-self.n_lat:], (sts + [st])[-self.n_lat:]
            if i >= warm:
                zq = R.symbols(self.raw, cfg, torch.stack(zs, 1), self.q0,
                               self.q1).cpu().numpy()
                pulses = R.pvq_rows(st, k)
                payloads = {b: R.encode_payload(zq[b], pulses[b], self.q0,
                                                self.q1, stats, k)
                            for b in self.payload_streams(i)}
                after = types.SimpleNamespace(features=new.features,
                                              encoder=new.encoder,
                                              z=torch.stack(zs, 1))
                self.records.append((i, before, pcm, {
                    "zq": zq, "pulses": pulses, "payloads": payloads}, after))
            state = new
        return self.check()
