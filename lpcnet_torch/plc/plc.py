"""The packet-loss concealment state machine (causal / non-causal, with or
without the DC filter), on the host.

A port of src/lpcnet_plc.c:188-503 with the PLC_SKIP_UPDATES fast path, as
`lpcnet_tpu/plc/plc.py`: the per-packet control flow runs on the host in
numpy (the non-causal crossfade and the DC loops in float64, as there); the
PLC net, Burg and encoder features and the synthesis run on the core's
device (`plc.core.LPCNetCore`: K2 on CUDA).

Every stream of a batch shares one loss pattern per call (the control flow
depends on the loss, as the C API's one state object per stream). Use
batch=1 per independent stream; `plc.batched.BatchedPLC` gives each stream
its own pattern.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..codec import features as F
from ..dsp.burg import burg_cepstral_analysis
from ..dsp.constants import FRAME_SIZE, NB_BANDS, NB_FEATURES, TRAINING_OFFSET
from ..models import lpcnet as M
from ..models import plc as PM
from ..weights.convert import tree_to
from .batched import ATT_TABLE, DC_CONST
from .core import LPCNetCore

PLC_MAX_FEC = 100

LPCNET_PLC_CAUSAL = 0
LPCNET_PLC_NONCAUSAL = 1
LPCNET_PLC_CODEC = 2
LPCNET_PLC_DC_FILTER = 4


class PLC:
    def __init__(self, fused, cfg: M.LPCNetConfig, plc_params,
                 options: int = LPCNET_PLC_CAUSAL, batch: int = 1,
                 plc_cfg: Optional[PM.PLCConfig] = None, device=None):
        """Runs on CUDA unless `device="cpu"` is passed."""
        mode = options & 0x3
        if mode == LPCNET_PLC_CAUSAL:
            self.enable_blending, self.non_causal = True, False
        elif mode == LPCNET_PLC_NONCAUSAL:
            self.enable_blending, self.non_causal = True, True
        elif mode == LPCNET_PLC_CODEC:
            self.enable_blending, self.non_causal = False, False
        else:
            raise ValueError("bad PLC options")
        if self.non_causal and cfg.lookahead != 0:
            raise ValueError("non-causal PLC needs a lookahead-0 model")
        self.remove_dc = bool(options & LPCNET_PLC_DC_FILTER)
        self.cfg = cfg
        self.batch = batch
        self.plc_cfg = plc_cfg or PM.PLCConfig()
        self.core = LPCNetCore(fused, cfg, batch, device)
        self.device = self.core.device
        self.plc_params = tree_to(plc_params, self.device)
        self.features_delay = cfg.lookahead
        self.plc_buf_size = self.features_delay * FRAME_SIZE + TRAINING_OFFSET
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        b, dev = self.batch, self.device
        self.core.reset()
        self.enc = F.init_encoder_state(b, dev)
        self.plc_net = PM.init_state(b, self.plc_cfg, dev)
        self.plc_copy = [self.plc_net] * (self.features_delay + 1)
        self.pcm = np.zeros((b, self.plc_buf_size + FRAME_SIZE), np.float32)
        self.pcm_fill = self.plc_buf_size
        self.skip_analysis = 0
        self.blend = False
        self.features = np.zeros((b, NB_FEATURES), np.float32)
        self.loss_count = 0
        self.dc_mem = np.zeros(b, np.float64)
        self.syn_dc = np.zeros(b, np.float64)
        self.dc_buf = np.zeros((b, TRAINING_OFFSET), np.float32)
        self.queued_update = False
        self.queued_samples = np.zeros((b, FRAME_SIZE), np.float32)
        self.fec: List[np.ndarray] = []
        self.fec_keep_pos = 0
        self.fec_read_pos = 0
        self.fec_skip = 0

    # ------------------------------------------------------------------
    def _t(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _burg(self, pcm):
        with torch.no_grad():
            return burg_cepstral_analysis(self._t(pcm)).cpu().numpy()

    def _plc_pred(self, plc_input):
        with torch.no_grad():
            self.plc_net, out = PM.compute_plc_pred(
                self.plc_params, self.plc_net, self._t(plc_input))
        return out.cpu().numpy()  # a copy: the features are attenuated in place

    def _enc_single_frame(self, pcm):
        """Pre-emphasis, frame features and single-frame pitch on the
        encoder state (the PLC resets pcount to 0 first, i.e. slots 2, 3)."""
        with torch.no_grad():
            self.enc, feats = F.compute_single_frame_features(self.enc,
                                                              self._t(pcm))
        return feats.cpu().numpy()

    # -- FEC queue (src/lpcnet_plc.c:111-173) ---------------------------
    def fec_add(self, features: Optional[np.ndarray]):
        if features is None:
            self.fec_skip += 1
            return
        if len(self.fec) == PLC_MAX_FEC:
            if self.fec_keep_pos == 0:
                return
            self.fec = self.fec[self.fec_keep_pos:]
            self.fec_read_pos -= self.fec_keep_pos
            self.fec_keep_pos = 0
        f = np.zeros((self.batch, NB_FEATURES), np.float32)
        f[:] = np.asarray(features, np.float32)[..., :NB_FEATURES]
        self.fec.append(f)

    def fec_clear(self):
        self.fec = []
        self.fec_keep_pos = self.fec_read_pos = self.fec_skip = 0

    def _get_fec_or_pred(self) -> bool:
        if self.fec_read_pos != len(self.fec) and self.fec_skip == 0:
            out = self.fec[self.fec_read_pos]
            self.fec_read_pos += 1
            self.fec_keep_pos = max(0, max(self.fec_keep_pos,
                                           self.fec_read_pos - self.features_delay - 1))
            plc_in = np.zeros((self.batch, PM.PLC_INPUT_SIZE), np.float32)
            plc_in[:, 2 * NB_BANDS: 2 * NB_BANDS + NB_FEATURES] = out
            plc_in[:, -1] = -1.0
            self._plc_pred(plc_in)       # state update only
            self.features = out.copy()
            return True
        else:
            zeros = np.zeros((self.batch, PM.PLC_INPUT_SIZE), np.float32)
            self.features = self._plc_pred(zeros)
            if self.fec_skip > 0:
                self.fec_skip -= 1
            return False

    def _fec_rewind(self, offset: int):
        self.fec_read_pos = max(self.fec_read_pos - offset, self.fec_keep_pos)

    # ------------------------------------------------------------------
    def update(self, pcm: np.ndarray) -> np.ndarray:
        """Good packet received. pcm [B, 160] int16/float; returns [B, 160]."""
        pcm = np.array(np.asarray(pcm, np.float32), copy=True)
        if self.non_causal:
            return self._update_non_causal(pcm)
        return self._update_causal(pcm)

    def conceal(self) -> np.ndarray:
        if self.non_causal:
            return self._conceal_non_causal()
        return self._conceal_causal()

    # -- causal (src/lpcnet_plc.c:188-337) ------------------------------
    def _dc_remove_in(self, pcm):
        lp = np.zeros_like(pcm)
        delta = np.trunc(self.syn_dc)
        self.dc_mem += self.syn_dc
        self.syn_dc[:] = 0
        for i in range(pcm.shape[1]):
            lp[:, i] = np.floor(0.5 + self.dc_mem)
            self.dc_mem += DC_CONST * (pcm[:, i] - self.dc_mem)
            pcm[:, i] -= lp[:, i]
        return lp, delta

    def _update_causal(self, pcm):
        lp = np.zeros_like(pcm)
        delta = np.zeros(self.batch)
        if self.remove_dc:
            lp, delta = self._dc_remove_in(pcm)
        burg_feats = self._burg(pcm)
        if self.skip_analysis:
            if self.blend:
                if self.enable_blending:
                    zeros = np.zeros((self.batch, PM.PLC_INPUT_SIZE), np.float32)
                    zeros[:, : 2 * NB_BANDS] = burg_feats
                    zeros[:, -1] = 1.0
                    self.plc_net = self.plc_copy[self.features_delay]
                    self.features = self._plc_pred(zeros)
                    for _ in range(self.features_delay):
                        self.core.frame_network_deferred(self.features)
                    saved = self.core.copy_state()
                    tmp = self.core.synthesize(self.features,
                                               FRAME_SIZE - TRAINING_OFFSET)
                    n = FRAME_SIZE - TRAINING_OFFSET
                    w = 0.5 - 0.5 * np.cos(np.pi * np.arange(n) / n)
                    pcm[:, :n] = np.floor(
                        0.5 + w * pcm[:, :n] + (1 - w) * (tmp - delta[:, None]))
                    self.core.restore_state(saved)
                    self.core.synthesize(self.features, n, preload=pcm[:, :n])
                else:
                    if self.features_delay > 0:
                        self.plc_net = self.plc_copy[self.features_delay - 1]
                    self._fec_rewind(self.features_delay)
                    self.core.reset_signal()
                self.pcm[:, :TRAINING_OFFSET] = pcm[:, FRAME_SIZE - TRAINING_OFFSET:]
                self.pcm_fill = TRAINING_OFFSET
            else:
                self.pcm[:, self.pcm_fill: self.pcm_fill + FRAME_SIZE] = pcm
                self.pcm_fill += FRAME_SIZE
        enc_feats = self._enc_single_frame(pcm)
        if not self.blend:
            plc_in = np.zeros((self.batch, PM.PLC_INPUT_SIZE), np.float32)
            plc_in[:, :2 * NB_BANDS] = burg_feats
            plc_in[:, 2 * NB_BANDS: 2 * NB_BANDS + NB_FEATURES] = enc_feats[:, :NB_FEATURES]
            plc_in[:, -1] = 1.0
            self.features = self._plc_pred(plc_in)
            if self.fec_skip:
                self.fec_skip -= 1
            elif self.fec_read_pos < len(self.fec):
                self.fec_read_pos += 1
            self.fec_keep_pos = max(0, max(self.fec_keep_pos,
                                           self.fec_read_pos - self.features_delay - 1))
        if self.skip_analysis:
            if self.enable_blending:
                self.core.frame_network_deferred(enc_feats)
            self.skip_analysis -= 1
        else:
            self.pcm[:, self.plc_buf_size:] = pcm
            # PLC_SKIP_UPDATES: defer the frame-net update, skip resynthesis
            self.core.frame_network_deferred(enc_feats)
            self.pcm[:, :self.plc_buf_size] = self.pcm[:, FRAME_SIZE:FRAME_SIZE + self.plc_buf_size]
        self.loss_count = 0
        if self.remove_dc:
            pcm += lp
        self.blend = False
        return np.clip(pcm, -32768, 32767)

    def _conceal_causal(self):
        self.core.frame_network_flush()
        while self.pcm_fill > 0:
            update_count = min(self.pcm_fill, FRAME_SIZE)
            output = self.pcm[:, :update_count]
            self.plc_copy = [self.plc_net] + self.plc_copy[:-1]
            self._get_fec_or_pred()
            self.core.synthesize(self.features, update_count, preload=output)
            self.pcm[:, :self.plc_buf_size] = self.pcm[:, FRAME_SIZE:FRAME_SIZE + self.plc_buf_size]
            self.pcm_fill -= update_count
            self.skip_analysis += 1
        self.plc_copy = [self.plc_net] + self.plc_copy[:-1]
        pcm = np.zeros((self.batch, FRAME_SIZE), np.float32)
        pcm[:, : FRAME_SIZE - TRAINING_OFFSET] = self.core.synthesize_tail(
            FRAME_SIZE - TRAINING_OFFSET)
        if self._get_fec_or_pred():
            self.loss_count = 0
        else:
            self.loss_count += 1
        self._attenuate()
        pcm[:, FRAME_SIZE - TRAINING_OFFSET:] = self.core.synthesize(
            self.features, TRAINING_OFFSET)
        self._enc_single_frame(pcm)
        self.blend = True
        if self.remove_dc:
            for i in range(FRAME_SIZE):
                self.syn_dc += DC_CONST * (pcm[:, i] - self.syn_dc)
            pcm += np.floor(0.5 + self.dc_mem)[:, None]
        return np.clip(pcm, -32768, 32767)

    def _attenuate(self):
        if self.loss_count >= 10:
            att = ATT_TABLE[9] - 2 * (self.loss_count - 9)
        else:
            att = ATT_TABLE[self.loss_count]
        self.features[:, 0] = np.maximum(-10.0, self.features[:, 0] + att)

    # -- non-causal (src/lpcnet_plc.c:342-492) --------------------------
    def _process_queued_update(self):
        if self.queued_update:
            self.core.synthesize(self.features, FRAME_SIZE,
                                 preload=self.queued_samples)
            self.queued_update = False

    def _update_non_causal(self, pcm):
        b = self.batch
        lp = np.zeros_like(pcm)
        delta = np.trunc(self.syn_dc)
        mem_bak = self.dc_mem.copy()
        self._process_queued_update()
        if self.remove_dc:
            self.dc_mem += self.syn_dc
            self.syn_dc[:] = 0
            mem_bak = self.dc_mem.copy()
            for i in range(FRAME_SIZE):
                lp[:, i] = np.floor(0.5 + self.dc_mem)
                self.dc_mem += DC_CONST * (pcm[:, i] - self.dc_mem)
                pcm[:, i] -= lp[:, i]
        pcm_save = pcm.copy()
        burg_feats = self._burg(pcm)
        if self.loss_count > 0:
            zeros = np.zeros((b, PM.PLC_INPUT_SIZE), np.float32)
            zeros[:, :2 * NB_BANDS] = burg_feats
            zeros[:, -1] = 1.0
            self.features = self._plc_pred(zeros)
            saved = self.core.copy_state()
            self.pcm[:, FRAME_SIZE - TRAINING_OFFSET:FRAME_SIZE] = \
                self.core.synthesize(self.features, TRAINING_OFFSET)
            if self.remove_dc:
                pcm += lp
                self.dc_mem = mem_bak.copy()
                for i in range(TRAINING_OFFSET):
                    self.syn_dc += DC_CONST * (
                        self.pcm[:, FRAME_SIZE - TRAINING_OFFSET + i] - self.syn_dc)
                self.dc_mem += self.syn_dc
                delta = np.trunc(delta + self.syn_dc)
                self.syn_dc[:] = 0
                for i in range(FRAME_SIZE):
                    lp[:, i] = np.floor(0.5 + self.dc_mem)
                    self.dc_mem += DC_CONST * (pcm[:, i] - self.dc_mem)
                    pcm[:, i] -= lp[:, i]
                pcm_save = pcm.copy()
            rev = pcm[:, ::-1].copy()
            self.core.reset_signal()
            self.core.synthesize(self.features, FRAME_SIZE, preload=rev)
            rev_tail = self.core.synthesize_tail(TRAINING_OFFSET)
            n = TRAINING_OFFSET
            w = 0.5 - 0.5 * np.cos(np.pi * np.arange(n) / n)
            for i in range(n):
                self.pcm[:, FRAME_SIZE - 1 - i] = np.floor(
                    0.5 + w[i] * self.pcm[:, FRAME_SIZE - 1 - i]
                    + (1 - w[i]) * (rev_tail[:, i] + delta))
            self.core.restore_state(saved)
            self.queued_update = True
            self.queued_samples[:, :TRAINING_OFFSET] = \
                self.pcm[:, FRAME_SIZE - TRAINING_OFFSET:FRAME_SIZE]
            self.queued_samples[:, TRAINING_OFFSET:] = pcm[:, :FRAME_SIZE - TRAINING_OFFSET]
            self._enc_single_frame(self.pcm[:, :FRAME_SIZE])
        enc_feats = self._enc_single_frame(pcm)
        if self.loss_count == 0:
            plc_in = np.zeros((b, PM.PLC_INPUT_SIZE), np.float32)
            plc_in[:, :2 * NB_BANDS] = burg_feats
            plc_in[:, 2 * NB_BANDS:2 * NB_BANDS + NB_FEATURES] = enc_feats[:, :NB_FEATURES]
            plc_in[:, -1] = 1.0
            self.features = self._plc_pred(plc_in)
            self.core.synthesize(
                enc_feats, TRAINING_OFFSET,
                preload=self.pcm[:, FRAME_SIZE - TRAINING_OFFSET:FRAME_SIZE])
            self.core.synthesize_tail(
                FRAME_SIZE - TRAINING_OFFSET,
                preload=pcm[:, :FRAME_SIZE - TRAINING_OFFSET])
        out = np.zeros_like(pcm)
        out[:, FRAME_SIZE - TRAINING_OFFSET:] = pcm[:, :TRAINING_OFFSET]
        out[:, :FRAME_SIZE - TRAINING_OFFSET] = self.pcm[:, TRAINING_OFFSET:FRAME_SIZE]
        self.pcm[:, :FRAME_SIZE] = pcm_save
        self.loss_count = 0
        if self.remove_dc:
            out[:, :TRAINING_OFFSET] += self.dc_buf
            out[:, TRAINING_OFFSET:] += lp[:, :FRAME_SIZE - TRAINING_OFFSET]
            self.dc_buf[:] = lp[:, FRAME_SIZE - TRAINING_OFFSET:]
        return np.clip(out, -32768, 32767)

    def _conceal_non_causal(self):
        b = self.batch
        self._process_queued_update()
        zeros = np.zeros((b, PM.PLC_INPUT_SIZE), np.float32)
        self.features = self._plc_pred(zeros)
        self._attenuate()
        pcm = np.zeros((b, FRAME_SIZE), np.float32)
        if self.loss_count == 0:
            pcm[:, :TRAINING_OFFSET] = self.pcm[:, FRAME_SIZE - TRAINING_OFFSET:FRAME_SIZE]
            self.core.synthesize(
                self.features, TRAINING_OFFSET,
                preload=self.pcm[:, FRAME_SIZE - TRAINING_OFFSET:FRAME_SIZE])
            pcm[:, TRAINING_OFFSET:] = self.core.synthesize_tail(
                FRAME_SIZE - TRAINING_OFFSET)
        else:
            pcm[:, :TRAINING_OFFSET] = self.core.synthesize(
                self.features, TRAINING_OFFSET)
            pcm[:, TRAINING_OFFSET:] = self.core.synthesize_tail(
                FRAME_SIZE - TRAINING_OFFSET)
            self.pcm[:, FRAME_SIZE - TRAINING_OFFSET:FRAME_SIZE] = pcm[:, :TRAINING_OFFSET]
            self._enc_single_frame(self.pcm[:, :FRAME_SIZE])
        self.pcm[:, :FRAME_SIZE - TRAINING_OFFSET] = pcm[:, TRAINING_OFFSET:]
        if self.remove_dc:
            dc = np.floor(0.5 + self.dc_mem)
            if self.loss_count == 0:
                for i in range(TRAINING_OFFSET, FRAME_SIZE):
                    self.syn_dc += DC_CONST * (pcm[:, i] - self.syn_dc)
            else:
                for i in range(FRAME_SIZE):
                    self.syn_dc += DC_CONST * (pcm[:, i] - self.syn_dc)
            pcm[:, :TRAINING_OFFSET] += self.dc_buf
            pcm[:, TRAINING_OFFSET:] += dc[:, None]
            self.dc_buf[:] = dc[:, None]
        self.loss_count += 1
        return np.clip(pcm, -32768, 32767)
