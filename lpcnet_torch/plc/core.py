"""A stateful vocoder core, as the C LPCNetState object
(src/lpcnet_private.h:28-48): it holds the current frame conditioning, so
the PLC can call the sample-rate tail apart from the frame network
(lpcnet_synthesize_tail_impl), and the deferred feature buffer
(run_frame_network_deferred/flush, src/lpcnet.c:122-144).

Control flow on the host, the math on the core's device. On the CPU the
tail is the step-by-step float32 model (`models.lpcnet.synthesize_frame`);
on CUDA it is the masked sample-loop kernel (K2), whose advance mask is the
warmup gate and whose teacher-forcing mask is the whole span or none.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..dsp.constants import FRAME_SIZE, LPC_ORDER
from ..kernels import sample_loop as K
from ..models import lpcnet as M
from ..utils.device import resolve_device
from ..weights.convert import tree_to


class LPCNetCore:
    def __init__(self, fused, cfg: M.LPCNetConfig, batch: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.fused = tree_to(fused, self.device)
        self.cfg = cfg
        self.batch = batch
        # K2's bundle, built once (the card only)
        self.kw = (K.masked_kernel_weights(K.kernel_weights(self.fused, cfg))
                   if self.device.type == "cuda" else None)
        self.reset()

    # -- state management -------------------------------------------------
    def reset(self):
        b, cfg, dev = self.batch, self.cfg, self.device
        self.fstate = M.init_frame_state(b, cfg, dev)
        self.sstate = M.init_sample_state(b, cfg, dev)
        self.cond_a = torch.zeros((b, 3 * cfg.rnn_units1), device=dev)
        self.cond_b = torch.zeros((b, 3 * cfg.rnn_units2), device=dev)
        self.lpc = torch.zeros((b, LPC_ORDER), device=dev)
        self.feature_buffer: List[np.ndarray] = []

    def reset_signal(self):
        """lpcnet_reset_signal (src/lpcnet.c:226-233): clear the sample-rate
        state but keep the conditioning and frame counters; the RNG runs on
        (the C does not reseed here)."""
        s = M.init_sample_state(self.batch, self.cfg, self.device)
        self.sstate = s._replace(rng=self.sstate.rng)

    def copy_state(self):
        return (self.fstate, self.sstate, self.cond_a, self.cond_b, self.lpc,
                list(self.feature_buffer))

    def restore_state(self, saved):
        (self.fstate, self.sstate, self.cond_a, self.cond_b,
         self.lpc) = saved[:5]
        self.feature_buffer = list(saved[5])

    # -- frame network ----------------------------------------------------
    def frame_network(self, features):
        f = torch.as_tensor(np.asarray(features, np.float32), device=self.device)
        with torch.no_grad():
            self.fstate, _, self.cond_a, self.cond_b, self.lpc = \
                M.frame_network(self.fused, self.fstate, f, self.cfg)

    def frame_network_deferred(self, features):
        max_buf = 2 * (self.cfg.conv_kernel - 1)
        if len(self.feature_buffer) == max_buf:
            self.feature_buffer.pop(0)
        self.feature_buffer.append(np.array(features, np.float32))

    def frame_network_flush(self):
        for f in self.feature_buffer:
            self.frame_network(f)
        self.feature_buffer = []

    # -- synthesis --------------------------------------------------------
    def synthesize_tail(self, n: int, preload: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        """n samples on the current conditioning -> [B, n] float; with
        `preload` [B, n], the whole span teacher-forced (the only preload
        patterns the PLC uses are none or the full span). A stream whose
        conv pipeline is not primed yet (the reference's warmup) neither
        advances nor emits."""
        b, dev = self.batch, self.device
        live = self.fstate.frame_count > self.cfg.lookahead
        pre = (None if preload is None else
               torch.as_tensor(np.asarray(preload, np.float32), device=dev))
        with torch.no_grad():
            if self.kw is None:
                new_ss, pcm = M.synthesize_frame(
                    self.fused, self.sstate, self.cond_a, self.cond_b,
                    self.lpc, n_samples=n, preload=pre)
                keep = lambda new, old: torch.where(
                    live.reshape((b,) + (1,) * (new.dim() - 1)), new, old)
                self.sstate = M.SampleState(
                    *(keep(x, y) for x, y in zip(new_ss[:5], self.sstate[:5])),
                    type(new_ss.rng)(*(keep(x, y) for x, y in
                                       zip(new_ss.rng, self.sstate.rng))))
                pcm = torch.where(live[:, None], pcm, torch.zeros_like(pcm))
            else:
                adv = live[:, None].expand(b, n)
                tf = adv if pre is not None else torch.zeros_like(adv)
                if pre is None:
                    pre = torch.zeros((b, n), device=dev)
                self.sstate, pcm = K.synthesize_frame_masked_kernel(
                    self.kw, self.sstate, self.cond_a.contiguous(),
                    self.cond_b.contiguous(), self.lpc.contiguous(), pre, tf,
                    adv, n, preload is None)
        return pcm.cpu().numpy()

    def synthesize(self, features, n: int = FRAME_SIZE,
                   preload: Optional[np.ndarray] = None) -> np.ndarray:
        """lpcnet_synthesize_impl: the frame network, then the tail."""
        self.frame_network(features)
        return self.synthesize_tail(n, preload)
