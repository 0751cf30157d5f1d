"""Multi-stream concealment serving: slot management over a fixed device
batch.

A `PLCStreamPool` owns a fixed-capacity batch of PLC state on the device.
Streams attach to and detach from slots; every 10 ms tick the pool gathers
each stream's frame (or its loss) into batch order, runs one frame step for
all slots and hands the concealed audio back per stream. Idle slots step
too (as lost frames) and their output is dropped; a slot's state is reset
when a stream attaches. The synthesis pool with packet decoding
(`StreamPool`) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..models import lpcnet as M
from ..plc.batched import BatchedPLC, tree_map


class PLCStreamPool:
    """Mixed-loss concealment pool over `plc.batched.BatchedPLC`.

    Every 10 ms tick takes {stream_id: [160] pcm or None (lost)} and returns
    concealed audio for every attached stream; each stream follows its own
    loss pattern inside the one batched frame step.
    """

    def __init__(self, fused, cfg: M.LPCNetConfig, plc_params,
                 capacity: int = 256, enable_blending: bool = True,
                 non_causal: bool = False, device=None,
                 use_kernel: Optional[bool] = None):
        self.capacity = capacity
        self.plc = BatchedPLC(fused, cfg, plc_params, batch=capacity,
                              enable_blending=enable_blending,
                              non_causal=non_causal, device=device,
                              use_kernel=use_kernel)
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
        dict are untouched."""
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
