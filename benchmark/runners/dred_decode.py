"""DRED decoding: `DREDDecoderPool.step_payloads` at a fixed number of
attached streams, every stream one redundancy payload a tick in and its
whole window of feature frames out, on the card.

The payloads are made at set-up, from speech-like audio, by the port's
`DREDEncoderPool` (whose bytes the cell `dred-enc-1024` holds to its
reference): `warmup_ticks` ticks to fill its window, then `payload_ticks`
ticks of payloads kept, which the window cycles. A tick ends when the
features are ready on the card; they are not copied to the host.

The reference checks the recorded ticks (`reference/<config>.py`): for a
seeded sample of streams a tick it parses the payloads' bytes itself, and
it decodes every stream, from the program's parse (`DREDDecoder.parsed`:
symbols, pulses and levels on the card) and, for the sample, from its own.
Numbers compared: the share of the sample's symbols that differ from the
program's parse (`symbol_mismatch`); the share of sampled streams whose
pulses differ (`pulse_mismatch`); and over every stream the largest
difference of the features over the reference's largest magnitude
(`feature_gap`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import generate as G
from .. import weights as W
from ..yardstick import work_dred_dec
from .common import free_device, sync
from .serving import ServeRunner

FRAME = 160
CHUNK = 128     # streams of speech made at a time at set-up


class Runner(ServeRunner):
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        # the program's pool: a program without one stops here, at once
        from lpcnet_torch.runtime.serving import DREDDecoderPool  # noqa: F401
        self.c, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.ref = reference
        self.streams = b = traffic["streams"]
        self.tick_audio_s = traffic["tick_audio_s"]
        red = traffic["redundancy"]
        self.frames, self.q0, self.q1 = red["frames"], red["q0"], red["q1"]
        self.n_lat = self.frames // 2
        self.warm = max(traffic["warmup_ticks"], self.n_lat)
        self.raw = W.load_npz(W.ROOT / config["trained_weights"], device)
        # [ticks, streams, 320] int16 on the host, the encoder's input
        gen = G.device_generator(G.sub_seed(seed, 1), device)
        ticks = self.warm + traffic["payload_ticks"]
        self.audio = np.empty((ticks, b, 2 * FRAME), np.int16)
        for s0 in range(0, b, CHUNK):
            n = min(CHUNK, b - s0)
            pcm = G.speech(n, ticks * 2 * FRAME, traffic["speech"], gen, device)
            self.audio[:, s0:s0 + n] = pcm.reshape(n, ticks, 2 * FRAME).transpose(
                0, 1).to(torch.int16).cpu().numpy()
        self.payloads = None

    def _config(self):
        from lpcnet_torch.models import rdovae as RV
        return RV.RDOVAEConfig(**{k: self.c[k] for k in
                                  RV.RDOVAEConfig.__dataclass_fields__})

    def make_payloads(self) -> None:
        """The cell's payloads (`entropy.Payloads`, one a tick), made by the
        port's encoder pool, which is then freed."""
        from lpcnet_torch.runtime.serving import DREDEncoderPool
        enc = DREDEncoderPool(W.clone(self.raw), self._config(),
                              streams=self.streams,
                              num_redundancy_frames=self.frames, q0=self.q0,
                              q1=self.q1, device=self.device)
        kept = []
        for i, pcm in enumerate(self.audio):
            out = enc.step_pcm(pcm)
            if i >= self.warm:
                kept.append(out["payloads"])
        self.payloads = kept
        del enc
        free_device()

    # ---- the program ------------------------------------------------------

    def setup(self):
        from lpcnet_torch.runtime.serving import DREDDecoderPool
        self.make_payloads()
        if self.device.type == "cuda":
            # the peak is the decoder's, not the encoder's that made the inputs
            torch.cuda.reset_peak_memory_stats(self.device)
        self.pool = DREDDecoderPool(W.clone(self.raw), self._config(),
                                    streams=self.streams, device=self.device)
        for _ in range(self.traffic["warmup_ticks"]):
            self.step(self.inputs(self.next_tick))
            self.next_tick += 1

    def inputs(self, i: int):
        return self.payloads[i % len(self.payloads)]

    def step(self, payloads):
        out = self.pool.step_payloads(payloads)
        sync(self.device)
        return out

    def rows(self, x):
        """Inputs (host bytes) as they are; features copied on the card."""
        return x.clone() if isinstance(x, torch.Tensor) else x

    def snapshot(self):
        """The program's last parse (symbols, pulses, levels on the card):
        the pool keeps no state from one tick to the next but this."""
        parsed = self.pool.dec.parsed
        return None if parsed is None else tuple(t.clone() for t in parsed)

    def restore(self, snap) -> None:
        pass

    def facts(self) -> dict:
        ticks = self.window_ticks[1] - self.window_ticks[0]
        per_tick = work_dred_dec.tick_seconds(self.c, self.streams, self.n_lat)
        return {"streams": self.streams, "window_s": self.window_s,
                "ticks": ticks, "least_compute_s": ticks * per_tick,
                "traced_ticks": self.traced_ticks[1] - self.traced_ticks[0]}

    def counters(self) -> dict:
        return dict(self.pool.stats)

    def free(self):
        self.pool = None
        free_device()

    # ---- the reference ----------------------------------------------------

    def check_streams(self, tick: int) -> np.ndarray:
        """The streams whose payloads the reference parses at `tick`."""
        rs = np.random.Generator(np.random.PCG64(G.sub_seed(self.seed, 3, tick)))
        n = min(self.traffic["check_streams"], self.streams)
        return np.sort(rs.choice(self.streams, n, replace=False))

    def check(self) -> dict:
        R = self.ref
        cfg = R.model_config(self.c)
        stats = R.stats_fixed_point(self.raw, cfg)
        gap, sym_apart, sym_n, pulse_apart, pulse_n = 0.0, 0, 0, 0, 0
        shape = (self.streams, self.n_lat * cfg.dec_frames_per_step,
                 cfg.num_features)
        for i, _, payloads, feats, parsed in self.records:
            checked = self.check_streams(i)
            mine = R.parse_all([payloads[b] for b in checked], stats, cfg,
                               self.device)
            sym_n += mine[0].numel()
            pulse_n += len(checked)
            if (parsed is None or feats is None or tuple(feats.shape) != shape
                    or parsed[0].shape[1:] != mine[0].shape[1:]):
                # nothing, or nothing of this shape, where features were due
                sym_apart += mine[0].numel()
                pulse_apart += len(checked)
                gap = max(gap, 1.0)
                continue
            zq, pulses, q_ids = (t.to(self.device, torch.int64).clone() for t in parsed)
            sym_apart += int((zq[checked] != mine[0]).sum())
            pulse_apart += int((pulses[checked] != mine[1]).any(dim=1).sum())
            # every stream decoded from the program's parse, the sample
            # from the reference's own
            idx = torch.as_tensor(checked, device=self.device)
            for prog, own in zip((zq, pulses, q_ids), mine):
                prog[idx] = own
            want = R.decode(self.raw, cfg, zq, pulses, q_ids)
            scale = max(float(want.abs().max()), 1e-30)
            gap = max(gap, float((want - feats.to(want.device)).abs().max()) / scale)
        return {"symbol_mismatch": sym_apart / sym_n,
                "pulse_mismatch": pulse_apart / pulse_n, "feature_gap": gap}

    def control(self, n_ticks: int) -> dict:
        """The reference with its decoder's weights and the operands of its
        products rounded to bfloat16 in the program's place: its own parse
        of every stream and its decode, `n_ticks` ticks of the cell's
        payloads, judged as `check` judges a run."""
        R = self.ref
        cfg = R.model_config(self.c)
        stats = R.stats_fixed_point(self.raw, cfg)
        low = R.bf16_decoder(self.raw)
        self.make_payloads()
        self.records = []
        for i in range(n_ticks):
            payloads = self.inputs(i)
            parsed = R.parse_all(list(payloads), stats, cfg, self.device)
            feats = R.decode(low, cfg, *parsed, rnd=R.bf16)
            self.records.append((i, None, payloads, feats, parsed))
        return self.check()


def stale_payloads(runner):
    """Every tick decodes the payloads of the first tick the pool was given
    (a parse that never takes the new bytes)."""
    step, first = runner.step, []

    def broken(payloads):
        if not first:
            first.append(payloads)
        return step(first[0])
    runner.step = broken


def features_altered(runner):
    """Every stream's first feature of its newest frame one step off."""
    step = runner.step

    def broken(payloads):
        out = step(payloads).clone()
        out[:, 0, 0] += 1.0
        return out
    runner.step = broken


FAULTS = {"stale_payloads": stale_payloads, "features_altered": features_altered}
