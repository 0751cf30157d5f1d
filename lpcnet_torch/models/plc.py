"""The PLC feature-prediction network.

Architecture (training_tf2/lpcnet_plc.py:65-101, src/lpcnet_plc.c:135-145):
input = [burg_cepstrum(36) | features(20) | lost_flag(1)] -> Dense(128, tanh)
-> GRU(256) -> GRU(256) -> Dense(20, linear); the predicted correlation
feature is boosted by +0.1 (capped at .5). Parameters are nested dicts of
tensors in the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
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


def init_params(seed: int = 0, cfg: PLCConfig | None = None, device="cpu"
                ) -> Dict[str, Any]:
    """Random weights from numpy's RandomState(seed), with the JAX package's
    initializer families (glorot-uniform kernels, per-gate orthogonal GRU
    recurrents, zero biases). The values differ from `jax.random` init for
    the same seed; carry JAX weights across with `weights.convert`."""
    cfg = cfg or PLCConfig()
    rs = np.random.RandomState(seed)

    def glorot(n_in, n_out):
        lim = math.sqrt(6.0 / (n_in + n_out))
        return rs.uniform(-lim, lim, (n_in, n_out))

    def dense(n_in, n_out):
        return {"kernel": glorot(n_in, n_out), "bias": np.zeros(n_out)}

    def gru(n_in, n):
        blocks = []
        for _ in range(3):
            q, r = np.linalg.qr(rs.normal(size=(n, n)))
            blocks.append(q * np.sign(np.diag(r)))
        return {"kernel": glorot(n_in, 3 * n),
                "recurrent": np.concatenate(blocks, axis=1),
                "bias": np.zeros((2, 3 * n))}

    from ..weights.convert import params_to_torch
    return params_to_torch({
        "plc_dense1": dense(PLC_INPUT_SIZE, cfg.dense1_size),
        "plc_gru1": gru(cfg.dense1_size, cfg.gru1_size),
        "plc_gru2": gru(cfg.gru1_size, cfg.gru2_size),
        "plc_out": dense(cfg.gru2_size, NB_FEATURES),
    }, device, torch.float32)


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


def predict_sequence(params, state: PLCNetState, plc_inputs: torch.Tensor):
    """The training-mode sequence form: [B, T, 57] -> [B, T, 20], without
    the +0.1 correlation boost, which is an inference-only tweak
    (training_tf2/lpcnet_plc.py:65-101)."""
    d = nn.dense(params["plc_dense1"], plc_inputs, "tanh")
    h1_seq, h1 = nn.gru_seq(params["plc_gru1"], d, h0=state.gru1)
    h2_seq, h2 = nn.gru_seq(params["plc_gru2"], h1_seq, h0=state.gru2)
    return PLCNetState(h1, h2), nn.dense(params["plc_out"], h2_seq)
