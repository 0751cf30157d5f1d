"""Multi-stream serving: slot management over a fixed device batch.

A `StreamPool` owns a fixed-capacity batch of decoder state on the device;
a `PLCStreamPool` one of PLC state. Streams attach to and detach from
slots; every tick the pool gathers each stream's input (a feature frame, a
packet, or a frame or its loss) into batch order, runs one step for all
slots and hands the audio back per stream. Idle slots step too and their
output is dropped; a slot's state is reset when a stream attaches.

A `DREDEncoderPool` is the sender's side of DRED over a fixed set of
streams: every 20 ms tick it takes each stream's PCM in slot order and
hands back one redundancy payload a stream; on CUDA the tick's two-frame
analysis is one CUDA graph replay (`codec.features.AnalysisGraph`). A
`DREDDecoderPool` is the receiver's side: every tick it takes one payload
a stream and decodes each whole redundancy window into feature frames on
the device, where the concealment's FEC queue reads them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..codec.decoder import LPCNetDecoder
from ..codec.features import AnalysisGraph, init_encoder_state
from ..dred import entropy as EC
from ..dred.coder import DREDDecoder, DREDEncoder
from ..dsp.constants import FRAME_SIZE, LPCNET_COMPRESSED_SIZE, NB_TOTAL_FEATURES
from ..models import lpcnet as M
from ..models import rdovae as RV
from ..plc.batched import BatchedPLC, tree_map
from ..utils.profiling import span


class StreamPool:
    """Synthesis and packet-decode pool over one `LPCNetDecoder` of batch
    `capacity`: `step_features` is a 10 ms tick of feature frames,
    `step_packets` a 40 ms tick of 8-byte packets (4 sample-loop launches).
    Runs on CUDA unless `device="cpu"` is passed."""

    def __init__(self, fused, cfg: M.LPCNetConfig, capacity: int = 256,
                 device=None):
        self.cfg = cfg
        self.capacity = capacity
        self.dec = LPCNetDecoder.from_fused(fused, cfg, batch=capacity,
                                            with_codebooks=True, device=device)
        self.free = list(range(capacity))[::-1]
        self.slot_of: Dict[str, int] = {}
        self._feat_buf = np.zeros((capacity, NB_TOTAL_FEATURES), np.float32)

    def attach(self, stream_id: str) -> int:
        if stream_id in self.slot_of:
            return self.slot_of[stream_id]
        if not self.free:
            raise RuntimeError("stream pool full")
        slot = self.free.pop()
        self.slot_of[stream_id] = slot
        self._reset_slot(slot)
        return slot

    def detach(self, stream_id: str) -> None:
        slot = self.slot_of.pop(stream_id, None)
        if slot is not None:
            self.free.append(slot)

    def _reset_slot(self, slot: int):
        """One slot back to a one-stream decoder's initial state (its KISS99
        words those of stream 0, as a fresh single-stream decoder's), its
        vq_mem and its last feature frame zeroed; the others untouched."""
        dev, dec = self.dec.device, self.dec

        def put(cur, one):
            if isinstance(cur, tuple):
                return type(cur)(*(put(c, o) for c, o in zip(cur, one)))
            cur = cur.clone()
            cur[slot] = one[0]
            return cur

        dec.frame_state = put(dec.frame_state,
                              M.init_frame_state(1, self.cfg, dev))
        dec.sample_state = put(dec.sample_state,
                               M.init_sample_state(1, self.cfg, dev))
        dec.vq_mem = dec.vq_mem.clone()
        dec.vq_mem[slot] = 0.0
        self._feat_buf[slot] = 0.0

    def step_features(self, features: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """One 10 ms tick: {stream_id: [>=20] features} -> {stream_id: [160]
        int16}. An attached stream without a frame this tick repeats its
        last one (concealment belongs to `PLCStreamPool`)."""
        with span("lpcnet.serving.step_features"):
            for sid, feat in features.items():
                slot = self.attach(sid)
                self._feat_buf[slot, :len(feat)] = feat
            pcm = self.dec.synthesize(self._feat_buf)
            return {sid: pcm[slot] for sid, slot in self.slot_of.items()}

    def step_packets(self, packets: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """One 40 ms tick: {stream_id: [8] uint8} -> {stream_id: [640]
        int16}. An attached stream without a packet decodes zero bytes."""
        with span("lpcnet.serving.step_packets"):
            buf = np.zeros((self.capacity, LPCNET_COMPRESSED_SIZE), np.uint8)
            for sid, pkt in packets.items():
                buf[self.attach(sid)] = pkt
            pcm = self.dec.decode(buf)
            return {sid: pcm[slot] for sid, slot in self.slot_of.items()}

    @property
    def n_active(self) -> int:
        return len(self.slot_of)


class PLCStreamPool:
    """Mixed-loss concealment pool over `plc.batched.BatchedPLC`.

    Every 10 ms tick takes {stream_id: [160] pcm or None (lost)} and returns
    concealed audio for every attached stream; each stream follows its own
    loss pattern inside the one batched frame step. The non-causal mode
    (a lookahead-0 vocoder) hands back audio 80 samples late and has no FEC
    queue; `remove_dc` runs the reference's DC filter in either mode;
    `chain` runs the causal step's PLC-net calls as one chain kernel (K4).
    """

    def __init__(self, fused, cfg: M.LPCNetConfig, plc_params,
                 capacity: int = 256, enable_blending: bool = True,
                 non_causal: bool = False, device=None,
                 use_kernel: Optional[bool] = None, remove_dc: bool = False,
                 chain: bool = False):
        self.capacity = capacity
        self.plc = BatchedPLC(fused, cfg, plc_params, batch=capacity,
                              enable_blending=enable_blending,
                              non_causal=non_causal, device=device,
                              use_kernel=use_kernel, remove_dc=remove_dc,
                              chain=chain)
        self.free = list(range(capacity))[::-1]
        self.slot_of: Dict[str, int] = {}
        self._init_slot_state = None

    def attach(self, stream_id: str) -> int:
        if stream_id in self.slot_of:
            return self.slot_of[stream_id]
        if not self.free:
            raise RuntimeError("PLC pool full")
        slot = self.free.pop()
        self.slot_of[stream_id] = slot
        self._reset_slot(slot)
        return slot

    def detach(self, stream_id: str) -> None:
        slot = self.slot_of.pop(stream_id, None)
        if slot is not None:
            self.free.append(slot)

    def _reset_slot(self, slot: int):
        """One slot back to its initial state; the others are untouched."""
        if self._init_slot_state is None:
            self._init_slot_state = self.plc.init_state()
        fresh = self._init_slot_state

        def put_batch(cur, ini):                    # leading batch [B, ...]
            cur = cur.clone()
            cur[slot] = ini[slot]
            return cur

        def put_ring(cur, ini):                     # ring [R, B, ...]
            cur = cur.clone()
            cur[:, slot] = ini[:, slot]
            return cur

        # by field, not by shape: plc_ring is the only [R, B, ...] subtree
        st = self.plc.state
        self.plc.state = type(st)(**{
            k: tree_map(put_ring if k == "plc_ring" else put_batch,
                        getattr(st, k), getattr(fresh, k))
            for k in st._fields})

    def fec_add(self, feats: Dict[str, "np.ndarray | None"]) -> None:
        """Queue one 10 ms redundancy feature frame per stream: feats[sid] a
        [>=20] feature row, or None for a slot known to be missing (keeps the
        stream's FEC queue aligned in time). Streams that are not in the
        dict are untouched. Causal pools only."""
        if self.plc.non_causal:
            raise ValueError("FEC queues: causal pools only (the reference's "
                             "non-causal PLC has no FEC either)")
        f = np.zeros((self.capacity, 20), np.float32)
        have = np.zeros(self.capacity, bool)
        unknown = np.zeros(self.capacity, bool)
        for sid, row in feats.items():
            slot = self.attach(sid)
            if row is None:
                unknown[slot] = True
            else:
                f[slot] = np.asarray(row, np.float32)[:20]
                have[slot] = True
        self.plc.fec_add(f, have=have, unknown=unknown)

    def step(self, frames: Dict[str, "np.ndarray | None"]
             ) -> Dict[str, np.ndarray]:
        """frames[sid] = [160] pcm, or None for a lost frame."""
        pcm = np.zeros((self.capacity, 160), np.float32)
        lost = np.ones(self.capacity, bool)       # idle slots just conceal
        for sid, frame in frames.items():
            slot = self.attach(sid)
            if frame is not None:
                pcm[slot] = frame
                lost[slot] = False
        out = self.plc.step(pcm, lost)
        return {sid: out[slot] for sid, slot in self.slot_of.items()}

    @property
    def n_active(self) -> int:
        return len(self.slot_of)


class DREDEncoderPool:
    """DRED encoding for `streams` streams, attached for the pool's life
    (slot k is row k). Each `step_pcm` is one 20 ms tick: two 10 ms frames
    of each stream through the encoder-side analysis
    (`compute_single_frame_features` twice, its state batched on the
    device; on CUDA one replay of `analysis`, an `AnalysisGraph` captured
    at the first tick), their 20 features twice into
    `DREDEncoder.add_feature_frame`, then `produce_payload`: one payload a
    stream over the newest `num_redundancy_frames / 2` latents, quantised
    from q0 (newest) to q1 (oldest). `stats` is the encoder's counters,
    the analysis graph's (`analysis_captures`, `analysis_replays`,
    `analysis_eager`) among them. `features`, the analysis state, is the
    graph's own buffers after a CUDA tick; a state assigned to it is
    copied in at the next. Runs on CUDA unless `device="cpu"` is
    passed."""

    def __init__(self, params, cfg: Optional[RV.RDOVAEConfig] = None,
                 streams: int = 1024, num_redundancy_frames: int = 52,
                 q0: int = 9, q1: int = 15, device=None):
        self.streams = streams
        self.num_redundancy_frames, self.q0, self.q1 = num_redundancy_frames, q0, q1
        self.enc = DREDEncoder(params, cfg, batch=streams,
                               max_latents=num_redundancy_frames // 2,
                               device=device)
        self.device = self.enc.device
        self.features = init_encoder_state(streams, self.device)
        self.stats = self.enc.stats
        self.analysis = AnalysisGraph(self.stats)

    def step_pcm(self, pcm) -> Optional[dict]:
        """pcm [streams, 320] int16 or float (slot order) -> the dict of
        `DREDEncoder.produce_payload` (its `payloads` one a stream), or
        None while the window holds fewer latents than a payload covers."""
        with span("lpcnet.serving.step_pcm"):
            x = torch.as_tensor(pcm).to(self.device).to(torch.float32)
            if x.shape != (self.streams, 2 * FRAME_SIZE):
                raise ValueError(f"step_pcm: pcm must be [{self.streams}, "
                                 f"{2 * FRAME_SIZE}], got {tuple(x.shape)}")
            with span("lpcnet.dred.features", device=self.device):
                self.features, f0, f1 = self.analysis(self.features, x)
            self.enc.add_feature_frame(f0)
            self.enc.add_feature_frame(f1)
            return self.enc.produce_payload(self.num_redundancy_frames,
                                            self.q0, self.q1)


class DREDDecoderPool:
    """DRED decoding for `streams` streams, attached for the pool's life
    (slot k is row k). Each `step_payloads` takes one redundancy payload a
    stream and decodes them all at once (`DREDDecoder.decode_payloads`).
    On CUDA one copy takes the payloads' bytes to the card, one kernel
    parses every payload there (`kernels.dred_parse`) and nothing comes
    back; on the CPU one native call parses them. The RDO-VAE decoder then
    steps on the device over every stream's latents, newest first. `stats`
    is the decoder's counters (`payloads_parsed`, `latents_decoded`, and
    the parses: on CUDA `device_parses`, one a tick, the engagement count
    of the card's parse, with `native_parses` and `python_parses` 0; on
    the CPU `native_parses`, or `python_parses` without the native
    library). Runs on CUDA unless `device="cpu"` is passed."""

    def __init__(self, params, cfg: Optional[RV.RDOVAEConfig] = None,
                 streams: int = 1024, device=None):
        self.streams = streams
        self.dec = DREDDecoder(params, cfg, device=device)
        self.device = self.dec.device
        self.stats = self.dec.stats

    def step_payloads(self, payloads: EC.Payloads) -> torch.Tensor:
        """One payload a stream in slot order (an `entropy.Payloads`, each
        of one latent count L) -> features [streams, L * 4, 20] on the
        device, newest latent first (`DREDDecoder.decode_all`'s order); the
        call returns once the work is queued."""
        with span("lpcnet.serving.step_payloads"):
            if len(payloads) != self.streams:
                raise ValueError(f"step_payloads: {self.streams} payloads a "
                                 f"tick, got {len(payloads)}")
            return self.dec.decode_payloads(payloads)
