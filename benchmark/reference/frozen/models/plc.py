# Frozen copy of lpcnet_torch/models/plc.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""The PLC feature-prediction network.

Architecture (training_tf2/lpcnet_plc.py:65-101, src/lpcnet_plc.c:135-145):
input = [burg_cepstrum(36) | features(20) | lost_flag(1)] -> Dense(128, tanh)
-> GRU(256) -> GRU(256) -> Dense(20, linear); the predicted correlation
feature is boosted by +0.1 (capped at .5). Parameters are nested dicts of
tensors in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..dsp.constants import NB_BANDS, NB_FEATURES
from ..nn import layers as nn

PLC_INPUT_SIZE = 2 * NB_BANDS + NB_FEATURES + 1   # 57


@dataclasses.dataclass(frozen=True)
class PLCConfig:
    dense1_size: int = 128
    gru1_size: int = 256
    gru2_size: int = 256
    nb_features: int = NB_FEATURES
    cond_size: int = PLC_INPUT_SIZE


class PLCNetState(NamedTuple):
    gru1: torch.Tensor   # [B, 256]
    gru2: torch.Tensor   # [B, 256]


def init_state(batch: int, cfg: PLCConfig | None = None, device="cpu"
               ) -> PLCNetState:
    cfg = cfg or PLCConfig()
    z = lambda n: torch.zeros(batch, n, dtype=torch.float32, device=device)
    return PLCNetState(z(cfg.gru1_size), z(cfg.gru2_size))


def compute_plc_pred(params, state: PLCNetState, plc_input: torch.Tensor
                     ) -> Tuple[PLCNetState, torch.Tensor]:
    """One step of feature prediction (src/lpcnet_plc.c:135-145):
    plc_input [B, 57] -> (new_state, features [B, 20]), float32."""
    d = nn.dense(params["plc_dense1"], plc_input, "tanh")
    h1 = nn.gru_step(params["plc_gru1"], state.gru1, d)
    h2 = nn.gru_step(params["plc_gru2"], state.gru2, h1)
    out = nn.dense(params["plc_out"], h2)
    out[..., NB_FEATURES - 1] = torch.clamp(out[..., NB_FEATURES - 1] + 0.1,
                                            max=0.5)
    return PLCNetState(h1, h2), out
