"""Batched decoder: one feature frame -> 160 samples per stream
(lpcnet_synthesize, src/lpcnet.c:235-271), and packet decoding: 8 bytes ->
4 feature frames -> 640 samples (decode_packet, src/lpcnet_dec.c:81-155;
lpcnet_decode, src/lpcnet.c:310-319).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..dsp.constants import MULTI_MASK, NB_BANDS, NB_TOTAL_FEATURES
from ..kernels import sample_loop as K
from ..models import lpcnet as M
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..weights.convert import tree_to
from . import packet as P
from . import quantize as Q
from .codebooks import Codebooks, load_codebooks


def decode_packet_features(fields: Dict[str, torch.Tensor],
                           vq_mem: torch.Tensor, cbs: Codebooks
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wire fields ({name: [B] int}) and vq_mem [B, 18] -> (features
    [B, 4, 36], new vq_mem). The LPC columns stay zero: synthesis recomputes
    LPC from the cepstrum (`models.lpcnet.frame_network`), as the reference
    does."""
    f = {k: v.long() for k, v in fields.items()}
    c0_id = f["c0_id"] - 64
    modulation = f["modulation"] - 4
    voiced = modulation != -4
    modulation = torch.where(voiced, modulation, 0)
    period_feat, corr_feat = Q.dequantize_pitch(f["main_pitch"], modulation,
                                                f["corr_id"], voiced)
    f3 = torch.cat([(c0_id.to(torch.float32) / 4.0)[:, None],
                    cbs.stage1[f["vq_end0"]] + cbs.stage2[f["vq_end1"]]
                    + cbs.stage3[f["vq_end2"]]], dim=-1)

    vq_mid = f["vq_mid"]
    n = cbs.diff4.shape[0]
    sign = torch.where(vq_mid >= n, -1.0, 1.0)
    idx = vq_mid & (n - 1)
    diff = sign[:, None] * cbs.diff4[idx]
    sel = (idx & MULTI_MASK)[:, None]
    pred = torch.where(sel < 2, 0.5 * (vq_mem + f3),
                       torch.where(sel == 2, vq_mem, f3))
    f1 = diff + pred
    f0, f2 = Q.apply_double_interp(vq_mem, f1, f3, f["interp"])

    b = f3.shape[0]
    feats = f3.new_zeros((b, 4, NB_TOTAL_FEATURES))
    feats[..., :NB_BANDS] = torch.stack([f0, f1, f2, f3], dim=1)
    feats[..., NB_BANDS] = period_feat
    feats[..., NB_BANDS + 1] = corr_feat[:, None]
    return feats, f3


def _select(mask, new, old):
    """Field-wise torch.where over (nested) NamedTuple states; mask [B]."""
    if isinstance(new, tuple):
        return type(new)(*(_select(mask, a, b) for a, b in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _synthesize_one_frame(fused, cfg, fstate, sstate, feats, preload=None,
                          kernel_weights=None, frame_net=M.frame_network):
    """Frame net + sample loop with the reference's warmup semantics.

    Until the conv pipeline is primed (frame_count <= lookahead after the
    frame-net increment) the reference emits silence and does not advance
    the sample-rate state (src/lpcnet.c:239-243); both are masked here. The
    sample loop still runs every frame, so kernel launches equal frames.

    With `kernel_weights` the loop is a sample-loop kernel (its plain
    version for CPU tensors): free-running, K1
    (`kernels.sample_loop.synthesize_frame_kernel`); or, with `preload`
    [B, 160], a whole teacher-forced frame, the masked kernel (K2) with
    every step teacher-forced and the sampler off. Without
    `kernel_weights` the plain model runs, which a CUDA tensor refuses.
    `frame_net` is `M.frame_network` or a callable of its form (the
    decoder's `M.FrameNetworkGraph`).
    """
    with span("lpcnet.model.frame_network"):
        fstate, _, ca, cb, lpc = frame_net(fused, fstate, feats, cfg)
    if kernel_weights is None and ca.is_cuda:
        raise ValueError("on CUDA the sample loop runs only as the kernel")
    with span("lpcnet.kernels.sample_loop"):
        if kernel_weights is not None and preload is not None:
            if preload.shape[-1] != cfg.frame_size:
                raise ValueError(f"preload must hold {cfg.frame_size} samples, "
                                 f"got {preload.shape[-1]}")
            on = torch.ones(preload.shape, dtype=torch.bool, device=ca.device)
            new_sstate, pcm = K.synthesize_frame_masked_kernel(
                kernel_weights, sstate, ca.contiguous(), cb.contiguous(),
                lpc.contiguous(), preload, on, on, cfg.frame_size, sampled=False)
        elif kernel_weights is not None:
            new_sstate, pcm = K.synthesize_frame_kernel(
                kernel_weights, sstate, ca.contiguous(), cb.contiguous(),
                lpc.contiguous(), cfg.frame_size)
        else:
            new_sstate, pcm = M.synthesize_frame(fused, sstate, ca, cb, lpc,
                                                 preload=preload)
    with span("lpcnet.codec.warmup_mask"):
        live = fstate.frame_count > cfg.lookahead        # [B] bool
        sstate = _select(live, new_sstate, sstate)
        pcm = torch.where(live[:, None], pcm, 0.0)
    return fstate, sstate, pcm


class LPCNetDecoder:
    """Stateful batched decoder, cf. LPCNetDecState: feature frames
    (`synthesize`) or packets (`decode`, with codebooks) in, PCM out.

    Every frame's frame network runs through `frame_graph`
    (`M.FrameNetworkGraph`): on the CPU the plain `M.frame_network`; on
    CUDA one graph replay, captured at the first frame and again when the
    activation implementation or the frame network's weight tensors
    change (the graph is keyed on them). Its counters say how each CUDA
    frame ran.

    `frame_state` may be assigned from outside (a slot reset, a restored
    snapshot): the next frame copies it into the graph's inputs and leaves
    the assigned tensors as they were. Aliasing on CUDA: after a frame,
    `frame_state` is the graph's own buffers, which the next frame writes
    in place, so a reference to `frame_state` taken before a frame holds
    the state after it, unless it was assigned from outside since the last
    frame (then it keeps its values). Clone it to keep a state. On the CPU
    every frame makes new tensors, and a reference keeps its values.
    """

    @classmethod
    def from_fused(cls, fused, cfg: M.LPCNetConfig, batch: int = 1,
                   use_kernel: bool | None = None,
                   with_codebooks: bool = False, device=None):
        """Build from fused inference params (float or q8).

        On CUDA the sample loop is always a kernel, at any batch (the JAX
        package runs its scan below batch 64; on the card that scan would
        be the plain version, so this deviation is deliberate): K1 for a
        free-running frame. On the CPU the plain model runs
        unless `use_kernel=True`, which takes the kernel wrappers' plain
        versions. Float params give the bfloat16 kernel bundle (the JAX
        package's default); q8 params give the q8 bundle.
        `with_codebooks=True` loads the codec's shipped codebooks for
        `decode`.
        """
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
        self._kw = (K.masked_kernel_weights(K.kernel_weights(self.fused, cfg))
                    if use_kernel else None)
        self.frame_graph = M.FrameNetworkGraph()
        self.cbs = None
        if with_codebooks:
            self.cbs = load_codebooks(device=dev)
        self.reset()
        return self

    def reset(self):
        self.frame_state = M.init_frame_state(self.batch, self.cfg, self.device)
        self.sample_state = M.init_sample_state(self.batch, self.cfg,
                                                self.device)
        self.vq_mem = torch.zeros((self.batch, NB_BANDS), dtype=torch.float32,
                                  device=self.device)

    def _frame(self, feats, preload=None):
        self.frame_state, self.sample_state, pcm = _synthesize_one_frame(
            self.fused, self.cfg, self.frame_state, self.sample_state, feats,
            preload=preload, kernel_weights=self._kw,
            frame_net=self.frame_graph)
        return pcm

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
            pcm = self._frame(feats, preload)
        with span("lpcnet.codec.readback"):
            return pcm.cpu().numpy().astype(np.int16)

    def decode(self, packets: np.ndarray) -> np.ndarray:
        """packets [B, 8] uint8 -> pcm [B, 640] int16: each packet's four
        feature frames (vq_mem carried) through the frame network and the
        sample loop."""
        if self.cbs is None:
            raise ValueError("packet decoding needs with_codebooks=True")
        with span("lpcnet.codec.decode"):
            with span("lpcnet.codec.unpack"):
                fields = {k: torch.as_tensor(v, device=self.device)
                          for k, v in P.unpack_fields(packets).items()}
            with torch.no_grad():
                with span("lpcnet.codec.features"):
                    feats, self.vq_mem = decode_packet_features(
                        fields, self.vq_mem, self.cbs)
                pcm = torch.cat([self._frame(feats[:, k]) for k in range(4)],
                                dim=-1)
            with span("lpcnet.codec.readback"):
                return pcm.cpu().numpy().astype(np.int16)
