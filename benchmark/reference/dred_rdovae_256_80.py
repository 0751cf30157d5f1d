"""The plain reference of configuration dred-rdovae-256-80: one 20 ms tick
of DRED's sender side for a batch of streams. Each stream's two 10 ms
frames through the encoder-side analysis, the RDO-VAE's streaming encoder
step on their 20 features each, the payload window's symbols at graded
levels, the PVQ search of the decoder's initial state, and the payload
framed with the Python range coder.

Built on `frozen/` (`frozen/codec/features.py`, `frozen/models/rdovae.py`,
`frozen/dred/entropy.py`), float32 products with TF32 off as the run sets
it. It takes from the benchmark the raw float32 weights and the inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .frozen.codec import features as F
from .frozen.dred import entropy as E
from .frozen.models import rdovae as RV

FRAME = 160

encode_payload = E.encode_payload
pvq_search = E.pvq_search
stats_fixed_point = E.stats_fixed_point


def model_config(c: dict) -> RV.RDOVAEConfig:
    return RV.RDOVAEConfig(**{k: c[k] for k in RV.RDOVAEConfig.__dataclass_fields__})


class TickState(NamedTuple):
    features: F.EncoderState
    encoder: RV.EncoderStreamState


def init_state(batch: int, cfg: RV.RDOVAEConfig, device) -> TickState:
    return TickState(F.init_encoder_state(batch, device),
                     RV.init_encoder_stream(batch, cfg, device))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_encoder(params) -> dict:
    """The encoder's weights rounded to bfloat16 (the control's operands);
    the statistical model as it is."""
    enc = {name: {k: bf16(v) for k, v in layer.items()}
           for name, layer in params["encoder"].items()}
    return dict(params, encoder=enc)


@torch.no_grad()
def encode_tick(params, cfg: RV.RDOVAEConfig, state: TickState,
                pcm: torch.Tensor, rnd=None):
    """pcm [B, 320] (a tensor on the state's device) -> (new state, the
    newest latent z [B, latent], the decoder's initial state [B, state])."""
    x = pcm.to(torch.float32)
    fs, f0 = F.compute_single_frame_features(state.features, x[:, :FRAME])
    fs, f1 = F.compute_single_frame_features(fs, x[:, FRAME:])
    n = cfg.num_features
    pair = torch.cat([f0[:, :n], f1[:, :n]], dim=-1)
    es, z, st = RV.encode_dframe(params, state.encoder, pair, cfg,
                                 **({} if rnd is None else {"rnd": rnd}))
    return TickState(fs, es), z, st


@torch.no_grad()
def symbols(params, cfg: RV.RDOVAEConfig, window: torch.Tensor, q0: int,
            q1: int) -> torch.Tensor:
    """window [B, L, latent], oldest first -> the payload's symbols
    [B, L, latent], the oldest at level q1, the newest at q0."""
    q_ids = torch.as_tensor(E.payload_q_ids(window.shape[1], q0, q1),
                            device=window.device)
    return RV.quantize_latents(params, window, q_ids, cfg)[0]


def pvq_rows(states: torch.Tensor, k: int) -> np.ndarray:
    """The PVQ search of every row of [B, state_dim], one row at a time."""
    return np.stack([pvq_search(s, k) for s in states.double().cpu().numpy()])
