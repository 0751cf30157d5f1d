"""DRED encoder and decoder drivers.

The C driver's surface (include/dred_rdovae.h, src/dred_rdovae.c:38-52)
and the FEC packetizer (torch/rdovae/fec_encoder.py:136-167), as the JAX
package's `dred/coder.py` has them: the encoder takes feature frames 2 at a
time and keeps the newest latents and decoder-init states; a redundancy
payload quantizes older latents coarser (q from q0 for the newest to q1 for
the oldest); the decoder gives 4 feature frames a latent, newest first.

The stream state, the latents and the init states stay on the device: a
dframe makes no host sync. `DREDEncoder.latents` / `.init_states` copy the
window to the host as the JAX surface gives it (lists of [B, ...] arrays).
Both drivers run on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models import rdovae as RV
from ..utils.device import resolve_device
from ..weights.convert import tree_to
from . import entropy as EC


def _host(window) -> List[np.ndarray]:
    return [x.cpu().numpy() for x in window]


class DREDEncoder:
    """Streaming DRED encoder (cf. RDOVAEEncState, src/dred_rdovae_enc.h:35-40)
    over `batch` streams."""

    def __init__(self, params, cfg: Optional[RV.RDOVAEConfig] = None,
                 batch: int = 1, max_latents: int = 100, device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg or RV.RDOVAEConfig()
        self.batch = batch
        self.max_latents = max_latents
        self.fixed_stats = EC.stats_fixed_point(self.params, self.cfg)
        self.reset()

    def reset(self):
        self.state = RV.init_encoder_stream(self.batch, self.cfg, self.device)
        # the newest max_latents latents [B, latent] and init states
        # [B, state_dim], oldest first, on the device
        self.z_window: List[torch.Tensor] = []
        self.state_window: List[torch.Tensor] = []
        self._frame_buf: Optional[torch.Tensor] = None

    @property
    def latents(self) -> List[np.ndarray]:
        return _host(self.z_window)

    @property
    def init_states(self) -> List[np.ndarray]:
        return _host(self.state_window)

    @torch.no_grad()
    def add_feature_frame(self, features):
        """features [B, >=20] (array or tensor); every second call encodes a
        dframe."""
        f = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device)[..., :self.cfg.num_features]
        if self._frame_buf is None:
            self._frame_buf = f
            return
        pair = torch.cat([self._frame_buf, f], dim=-1)
        self._frame_buf = None
        self.state, z, st = RV.encode_dframe(self.params, self.state, pair,
                                             self.cfg)
        self.z_window.append(z)
        self.state_window.append(st)
        if len(self.z_window) > self.max_latents:
            self.z_window.pop(0)
            self.state_window.pop(0)

    def produce_payload(self, num_redundancy_frames: int = 52,
                        q0: int = 9, q1: int = 15):
        """One redundancy payload from the newest latents.

        Returns a dict: zq [B, L, latent] int-valued symbols (newest last;
        decoding reverses them), q_ids [L], state [B, state_dim] (the
        PVQ-quantized unit-norm decoder init), bits [B] estimated payload
        size, and payloads: B entropy-coded byte strings
        (`entropy.encode_payload`'s framing). None while fewer than
        num_redundancy_frames / 2 latents were encoded.
        """
        n_lat = num_redundancy_frames // 2
        if len(self.z_window) < n_lat:
            return None
        z = torch.stack(self.z_window[-n_lat:], dim=1)            # [B, L, latent]
        # oldest latent (index 0) -> coarsest level q1, newest -> q0
        # (torch/rdovae/fec_encoder.py:125-127)
        q_ids = EC.payload_q_ids(n_lat, q0, q1)
        zq, rates = quantize_latents(self.params, z,
                                     torch.as_tensor(q_ids, device=self.device),
                                     self.cfg)
        bits = 8 * torch.ceil((rates.sum(-1) + 7 + RV.pvq_state_bits(self.cfg)) / 8)
        zq = zq.cpu().numpy()
        raw_state = self.state_window[-1].cpu().numpy()
        k = self.cfg.pvq_num_pulses
        pulses = np.stack([EC.pvq_search(s, k) for s in raw_state])
        state = np.stack([EC.pvq_normalize(p) for p in pulses])
        payloads = [EC.encode_payload(zq[b].astype(np.int32), pulses[b],
                                      q0, q1, self.fixed_stats, k)
                    for b in range(zq.shape[0])]
        return {"zq": zq, "q_ids": q_ids, "state": state,
                "bits": bits.cpu().numpy(), "payloads": payloads,
                "pulses": pulses}


@torch.no_grad()
def quantize_latents(params, z: torch.Tensor, q_ids: torch.Tensor,
                     cfg: RV.RDOVAEConfig):
    """z [B, L, latent], q_ids [L] -> (round-quantized symbols, rates [B, L])
    (RDOVAE.quantize, torch rdovae.py:584-595)."""
    stats = RV.statistical_model(params, q_ids, cfg)
    zq = RV.soft_dead_zone(z * stats["quant_scale"], stats["dead_zone"])
    zq = torch.clamp(torch.round(zq), -EC.MAX_MAG, EC.MAX_MAG)
    rates = RV.hard_rate_estimate(zq, stats["r_hard"], stats["theta_hard"],
                                  reduce=False)
    return zq, rates


@torch.no_grad()
def unquantize_latents(params, zq: torch.Tensor, q_ids: torch.Tensor,
                       cfg: RV.RDOVAEConfig):
    return zq / RV.statistical_model(params, q_ids, cfg)["quant_scale"]


class DREDDecoder:
    """Redundancy decoder (DRED_rdovae_decode_all, src/dred_rdovae.c:38-52)."""

    def __init__(self, params, cfg: Optional[RV.RDOVAEConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg or RV.RDOVAEConfig()
        self._fixed_stats = None

    @torch.no_grad()
    def decode_latents(self, z_rev: torch.Tensor, state: torch.Tensor
                       ) -> torch.Tensor:
        """Unquantized latents in decode order (newest first) [B, L, latent]
        and init states [B, state_dim] -> features [B, L * 4, 20] on the
        device: `decode_qframe` over the latents."""
        dec = RV.init_decoder_stream(self.params, state, self.cfg)
        frames = []
        for i in range(z_rev.shape[1]):
            dec, f = RV.decode_qframe(self.params, dec, z_rev[:, i], self.cfg)
            frames.append(f)
        return torch.cat(frames, dim=1)

    def decode_all(self, zq, q_ids, state) -> np.ndarray:
        """zq [B, L, latent] quantized symbols newest last; q_ids [L];
        state [B, state_dim]. Returns features [B, L * 4, 20] in decode order
        (newest latent first, 4 frames a latent)."""
        dev = self.device
        z = unquantize_latents(self.params,
                               torch.as_tensor(zq, dtype=torch.float32, device=dev),
                               torch.as_tensor(q_ids, device=dev), self.cfg)
        state = torch.as_tensor(state, dtype=torch.float32, device=dev)
        return self.decode_latents(torch.flip(z, dims=(1,)), state).cpu().numpy()

    def decode_payload(self, payload: bytes) -> np.ndarray:
        """An entropy-coded payload (`entropy.encode_payload`'s framing) ->
        features [1, L * 4, 20], newest latent first."""
        if self._fixed_stats is None:
            self._fixed_stats = EC.stats_fixed_point(self.params, self.cfg)
        zq, pulses, q_ids = EC.decode_payload(
            payload, self._fixed_stats, self.cfg.state_dim,
            self.cfg.pvq_num_pulses)
        state = EC.pvq_normalize(pulses)[None]
        return self.decode_all(zq[None], q_ids, state)
