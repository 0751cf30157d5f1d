"""Packet-loss concealment: `PLCStreamPool.step` at a fixed number of
attached streams, every stream one 10 ms frame a tick, real or lost, its
losses from the mix's loss model.

The reference replays the recorded ticks from the program's state before
each (`reference/<config>.py::plc_tick`). Numbers compared: of the
(stream, tick) pairs whose audio the model synthesizes (lost, or blending
back after a loss), the share whose 160 output samples differ in any
sample (`concealed_mismatch`: the sampler's draws part the two sides where
their float arithmetic rounds apart near a threshold, and a stream that
parted stays apart) and in the first 16 (`head_mismatch`); of the others,
whose audio is the input passed through, the share that differ at all
(`received_mismatch`, exact); and of the streams whose audio agreed, and
of every stream at attach against a fresh stream, the share whose state
departs from the reference's (`state_apart`, `compare.apart_rows`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import generate as G
from .. import weights as W
from ..reference import compare as C
from ..yardstick import work
from .common import clone_tree, free_device
from .serving import ServeRunner


HEAD = 16       # the first samples of a tick, before the sides can part


class Runner(ServeRunner):
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        self.c, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.v = config["vocoder"]
        self.ref = reference
        self.streams = b = traffic["streams"]
        self.tick_audio_s = traffic["tick_audio_s"]
        self.sids = [f"s{k}" for k in range(b)]
        self.raw, self.raw_plc = W.raw_plc(config, device)
        gen = G.device_generator(G.sub_seed(seed, 1), device)
        n = traffic["audio_ticks"] * self.v["frame_size"]
        self.audio = G.speech(b, n, traffic["speech"], gen, device).cpu().numpy(
        ).reshape(b, traffic["audio_ticks"], self.v["frame_size"])
        self.loss = G.GilbertLoss(b, traffic["loss"], G.sub_seed(seed, 2))

    # ---- the program ------------------------------------------------------

    def setup(self):
        from lpcnet_torch.models import lpcnet as M
        from lpcnet_torch.nn.quantized import quantize_fused
        from lpcnet_torch.runtime.serving import PLCStreamPool
        v = self.v
        cfg = M.LPCNetConfig(rnn_units1=v["rnn_units1"], rnn_units2=v["rnn_units2"],
                             cond_size=v["cond_size"],
                             nb_used_features=v["nb_used_features"],
                             frame_size=v["frame_size"],
                             conv_kernel=v["conv_kernel"],
                             pitch_embed_dim=v["pitch_embed_dim"],
                             lookahead=v["lookahead"])
        fused = quantize_fused(M.fuse_inference_params(W.clone(self.raw), cfg))
        self.pool = PLCStreamPool(fused, cfg, W.clone(self.raw_plc),
                                  capacity=self.streams,
                                  enable_blending=self.c["blending"],
                                  device=self.device)
        for sid in self.sids:
            self.pool.attach(sid)
        self.order = sorted(self.sids, key=self.pool.slot_of.__getitem__)
        self.start_state = self.snapshot()
        for _ in range(self.traffic["warmup_ticks"]):
            self.step(self.inputs(self.next_tick))
            self.next_tick += 1

    def inputs(self, i: int) -> dict:
        lost = self.loss.lost(i)
        frames = self.audio[:, i % self.audio.shape[1]]
        return {s: None if lost[k] else frames[k] for k, s in enumerate(self.sids)}

    def step(self, inputs: dict) -> dict:
        return self.pool.step(inputs)

    def rows(self, by_stream: dict) -> np.ndarray:
        n = self.v["frame_size"]
        return np.stack([np.zeros(n, np.float32) if by_stream[s] is None
                         else np.asarray(by_stream[s], np.float32)
                         for s in self.order])

    def lost_rows(self, i: int) -> np.ndarray:
        lost = self.loss.lost(i)
        slot = {s: k for k, s in enumerate(self.sids)}
        return np.array([lost[slot[s]] for s in self.order])

    def snapshot(self):
        return clone_tree(self.pool.plc.state)

    def restore(self, snap) -> None:
        self.pool.plc.state = clone_tree(snap)

    def facts(self) -> dict:
        t0, t1 = self.window_ticks
        lost = np.stack([self.loss.lost(i) for i in range(t0 - 1, t1)])
        n_lost = int(lost[1:].sum())
        n_blend = int((~lost[1:] & lost[:-1]).sum())
        need = work.plc_window_seconds(
            self.v, self.c, self.c["numerics"]["serve_gru_type"], self.streams,
            t1 - t0, n_lost + n_blend)
        return {"streams": self.streams, "window_s": self.window_s,
                "ticks": t1 - t0, "least_compute_s": need,
                "traced_ticks": self.traced_ticks[1] - self.traced_ticks[0],
                "lost_stream_ticks": n_lost, "blending_stream_ticks": n_blend}

    def counters(self) -> dict:
        return dict(self.pool.plc.stats)

    def free(self):
        self.pool = None
        free_device()

    # ---- the reference ----------------------------------------------------

    def _reference(self, gru_bits: int = 8):
        R = self.ref
        cfg = R.model_config(self.v)
        return R, cfg, R.plc_config(self.c), R.served_weights(self.raw, cfg, gru_bits)

    def check(self) -> dict:
        R, cfg, pcfg, fused = self._reference()
        template = R.init_state(self.streams, cfg, pcfg, self.device)
        apart = int(C.apart_rows(template, self.start_state, R.batch_axis).sum())
        agreed = self.streams
        concealed = concealed_apart = head_apart = received_apart = 0
        for i, before, pcm, out, after in self.records:
            start = C.rebuild(template, before)
            lost = torch.as_tensor(self.lost_rows(i), device=self.device)
            synth = lost | start.blend          # lost, or blending back
            new, ref_out = R.plc_tick(fused, cfg, self.raw_plc, start,
                                      torch.as_tensor(pcm, device=self.device),
                                      lost)
            mm = C.mismatched_rows(ref_out, out)
            concealed += int(synth.sum())
            concealed_apart += int((mm & synth).sum())
            head_apart += int((C.mismatched_rows(ref_out, out, HEAD) & synth).sum())
            received_apart += int((mm & ~synth).sum())
            apart += int((C.apart_rows(new, after, R.batch_axis) & ~mm).sum())
            agreed += int((~mm).sum())
        received = len(self.records) * self.streams - concealed
        return {"concealed_mismatch": concealed_apart / max(concealed, 1),
                "head_mismatch": head_apart / max(concealed, 1),
                "received_mismatch": received_apart / max(received, 1),
                "state_apart": apart / agreed}

    def control(self, n_ticks: int) -> dict:
        """The reference one precision down in the program's place: the
        vocoder's GRU matrices in 4 bits, the PLC net's float32 weights
        rounded to bfloat16; the cell's warm-up and `n_ticks` ticks of its
        traffic, every tick recorded, then judged as `check` judges a run."""
        R, cfg, pcfg, fused4 = self._reference(gru_bits=4)
        plc16 = W.map_tree(lambda w: w.to(torch.bfloat16).to(torch.float32),
                           self.raw_plc)
        state = R.init_state(self.streams, cfg, pcfg, self.device)
        self.start_state, self.records = state, []
        self.order = self.sids
        warm = self.traffic["warmup_ticks"]
        for i in range(warm + n_ticks):
            inp = self.rows(self.inputs(i))
            lost = torch.as_tensor(self.lost_rows(i), device=self.device)
            new, out = R.plc_tick(fused4, cfg, plc16, state,
                                  torch.as_tensor(inp, device=self.device), lost)
            if i >= warm:
                self.records.append((i, state, inp, out.cpu().numpy(), new))
            state = new
        return self.check()
