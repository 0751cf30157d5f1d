"""Batched synthesis decoder: one feature frame -> 160 samples per stream
(lpcnet_synthesize, src/lpcnet.c:235-271). Packet decoding is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.sample_loop import kernel_weights as make_kernel_weights
from ..kernels.sample_loop import (synthesize_frame_kernel,
                                    synthesize_frame_masked_kernel)
from ..models import lpcnet as M
from ..utils.device import resolve_device
from ..weights.convert import tree_to


def _select(mask, new, old):
    """Field-wise torch.where over (nested) NamedTuple states; mask [B]."""
    if isinstance(new, tuple):
        return type(new)(*(_select(mask, a, b) for a, b in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _synthesize_one_frame(fused, cfg, fstate, sstate, feats, preload=None,
                          kernel_weights=None):
    """Frame net + sample loop with the reference's warmup semantics.

    Until the conv pipeline is primed (frame_count <= lookahead after the
    frame-net increment) the reference emits silence and does not advance
    the sample-rate state (src/lpcnet.c:239-243); both are masked here. The
    sample loop still runs every frame, so kernel launches equal frames.

    With `kernel_weights` the loop is the sample-loop kernel (its plain
    version for CPU tensors): free-running (K1), or with `preload`
    [B, 160], a whole teacher-forced frame, the masked kernel (K2) with
    every step teacher-forced and the sampler off. Without `kernel_weights`
    the plain model runs, which a CUDA tensor refuses.
    """
    fstate, _, ca, cb, lpc = M.frame_network(fused, fstate, feats, cfg)
    if kernel_weights is None and ca.is_cuda:
        raise ValueError("on CUDA the sample loop runs only as the kernel")
    if kernel_weights is not None and preload is not None:
        if preload.shape[-1] != cfg.frame_size:
            raise ValueError(f"preload must hold {cfg.frame_size} samples, "
                             f"got {preload.shape[-1]}")
        on = torch.ones(preload.shape, dtype=torch.bool, device=ca.device)
        new_sstate, pcm = synthesize_frame_masked_kernel(
            kernel_weights, sstate, ca.contiguous(), cb.contiguous(),
            lpc.contiguous(), preload, on, on, cfg.frame_size, sampled=False)
    elif kernel_weights is not None:
        new_sstate, pcm = synthesize_frame_kernel(
            kernel_weights, sstate, ca.contiguous(), cb.contiguous(),
            lpc.contiguous())
    else:
        new_sstate, pcm = M.synthesize_frame(fused, sstate, ca, cb, lpc,
                                             preload=preload)
    live = fstate.frame_count > cfg.lookahead            # [B] bool
    sstate = _select(live, new_sstate, sstate)
    return fstate, sstate, torch.where(live[:, None], pcm, 0.0)


class LPCNetDecoder:
    """Stateful batched synthesis decoder, cf. LPCNetDecState."""

    @classmethod
    def from_fused(cls, fused, cfg: M.LPCNetConfig, batch: int = 1,
                   use_kernel: bool | None = None,
                   with_codebooks: bool = False, device=None):
        """Build from fused inference params (float or q8).

        On CUDA the sample loop is always the kernel, at any batch (the JAX
        package runs its scan below batch 64; on the card that scan would
        be the plain version, so this deviation is deliberate). On the CPU
        the plain model runs unless `use_kernel=True`, which takes the
        kernel wrapper's plain version. Float params give the bfloat16
        kernel bundle (the JAX package's default); q8 params give the q8
        bundle.
        """
        if with_codebooks:
            raise NotImplementedError("packet decoding is not ported yet")
        dev = resolve_device(device)
        if use_kernel is None:
            use_kernel = dev.type == "cuda"
        if dev.type == "cuda" and not use_kernel:
            raise ValueError("on CUDA the sample loop runs only as the kernel")
        self = cls.__new__(cls)
        self.cfg = cfg
        self.batch = batch
        self.device = dev
        self.fused = tree_to(fused, dev)
        self._kw = make_kernel_weights(self.fused, cfg) if use_kernel else None
        self.reset()
        return self

    def reset(self):
        self.frame_state = M.init_frame_state(self.batch, self.cfg, self.device)
        self.sample_state = M.init_sample_state(self.batch, self.cfg,
                                                self.device)

    def synthesize(self, features: np.ndarray, preload=None) -> np.ndarray:
        """features [B, 36] (one frame) -> pcm [B, 160] int16. `preload`
        [B, 160] teacher-forces the frame onto that waveform
        (src/lpcnet.c:256-259)."""
        feats = torch.as_tensor(np.asarray(features, np.float32),
                                device=self.device)
        if preload is not None:
            preload = torch.as_tensor(np.asarray(preload, np.float32),
                                      device=self.device)
        with torch.no_grad():
            self.frame_state, self.sample_state, pcm = _synthesize_one_frame(
                self.fused, self.cfg, self.frame_state, self.sample_state,
                feats, preload=preload, kernel_weights=self._kw)
        return pcm.cpu().numpy().astype(np.int16)
