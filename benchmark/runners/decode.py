"""Packet decode: `StreamPool.step_packets` at a fixed number of attached
streams, every stream one 8-byte packet a 40 ms tick.

The reference replays the recorded ticks from the program's state before
each (`reference/<config>.py::decode_tick`): the packets' features, the
frame network, LPC and the sample loop with the same KISS99 words. The
sampler's draws part the two sides wherever their float arithmetic rounds
apart near a threshold, and a stream that parted stays apart for the rest
of the tick. Numbers compared: the share of (stream, tick) pairs whose 640
samples differ in any sample (`pcm_mismatch`) and in the first 16
(`head_mismatch`); and of the streams whose audio agreed, and of every
stream at attach against a fresh stream, the share whose state departs
from the reference's (`state_apart`, `compare.apart_rows`).
"""

from __future__ import annotations

import types

import numpy as np

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
        self.ref = reference
        self.streams = traffic["streams"]
        self.tick_audio_s = traffic["tick_audio_s"]
        self.sids = [f"s{k}" for k in range(self.streams)]
        self.packets = G.packets(traffic["packet_ticks"], self.streams,
                                 G.sub_seed(seed, 1))
        self.raw = W.raw_lpcnet(config, traffic, seed, device)

    # ---- the program ------------------------------------------------------

    def setup(self):
        from lpcnet_torch.models import lpcnet as M
        from lpcnet_torch.nn.quantized import quantize_fused
        from lpcnet_torch.runtime.serving import StreamPool
        c = self.c
        cfg = M.LPCNetConfig(rnn_units1=c["rnn_units1"], rnn_units2=c["rnn_units2"],
                             cond_size=c["cond_size"],
                             nb_used_features=c["nb_used_features"],
                             frame_size=c["frame_size"],
                             conv_kernel=c["conv_kernel"],
                             pitch_embed_dim=c["pitch_embed_dim"],
                             lookahead=c["lookahead"])
        fused = quantize_fused(M.fuse_inference_params(W.clone(self.raw), cfg))
        self.pool = StreamPool(fused, cfg, capacity=self.streams,
                               device=self.device)
        for sid in self.sids:
            self.pool.attach(sid)
        self.order = sorted(self.sids, key=self.pool.slot_of.__getitem__)
        self.start_state = self.snapshot()
        for _ in range(self.traffic["warmup_ticks"]):
            self.step(self.inputs(self.next_tick))
            self.next_tick += 1

    def inputs(self, i: int) -> dict:
        rows = self.packets[i % len(self.packets)]
        return dict(zip(self.sids, rows))

    def step(self, inputs: dict) -> dict:
        return self.pool.step_packets(inputs)

    def rows(self, by_stream: dict) -> np.ndarray:
        return np.stack([by_stream[s] for s in self.order])

    def snapshot(self):
        d = self.pool.dec
        return types.SimpleNamespace(frame_state=clone_tree(d.frame_state),
                                     sample_state=clone_tree(d.sample_state),
                                     vq_mem=d.vq_mem.clone())

    def restore(self, snap) -> None:
        d = self.pool.dec
        d.frame_state = clone_tree(snap.frame_state)
        d.sample_state = clone_tree(snap.sample_state)
        d.vq_mem = snap.vq_mem.clone()

    def facts(self) -> dict:
        ticks = self.window_ticks[1] - self.window_ticks[0]
        need = ticks * work.decode_tick_seconds(
            self.c, self.c["numerics"]["serve_gru_type"], self.streams)
        return {"streams": self.streams, "window_s": self.window_s,
                "ticks": ticks, "least_compute_s": need,
                "traced_ticks": self.traced_ticks[1] - self.traced_ticks[0]}

    def counters(self) -> dict:
        return {}

    def free(self):
        self.pool = None
        free_device()

    # ---- the reference ----------------------------------------------------

    def _reference(self, gru_bits: int = 8):
        R = self.ref
        cfg = R.model_config(self.c)
        return R, cfg, R.served_weights(self.raw, cfg, gru_bits), R.codebooks(self.device)

    def check(self) -> dict:
        R, cfg, fused, cbs = self._reference()
        template = R.init_decode_state(self.streams, cfg, self.device)
        apart = int(C.apart_rows(template, self.start_state).sum())
        agreed, head_apart, tick_apart = self.streams, 0, 0
        for _, before, packets, out, after in self.records:
            new, pcm = R.decode_tick(fused, cfg, cbs, C.rebuild(template, before),
                                     packets)
            mm = C.mismatched_rows(pcm, out)
            tick_apart += int(mm.sum())
            head_apart += int(C.mismatched_rows(pcm, out, HEAD).sum())
            apart += int((C.apart_rows(new, after) & ~mm).sum())
            agreed += int((~mm).sum())
        n = len(self.records) * self.streams
        return {"pcm_mismatch": tick_apart / n, "head_mismatch": head_apart / n,
                "state_apart": apart / agreed}

    def control(self, n_ticks: int) -> dict:
        """The reference with 4-bit GRU matrices in the program's place:
        the cell's warm-up and `n_ticks` ticks of its traffic, every tick
        recorded, then judged as `check` judges a run."""
        R, cfg, fused4, cbs = self._reference(gru_bits=4)
        state = R.init_decode_state(self.streams, cfg, self.device)
        self.start_state, self.records = state, []
        warm = self.traffic["warmup_ticks"]
        for i in range(warm + n_ticks):
            packets = self.packets[i % len(self.packets)]
            new, pcm = R.decode_tick(fused4, cfg, cbs, state, packets)
            if i >= warm:
                self.records.append((i, state, packets,
                                     pcm.cpu().numpy().astype(np.int16), new))
            state = new
        return self.check()
