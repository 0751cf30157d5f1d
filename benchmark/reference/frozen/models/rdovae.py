# Frozen copy of lpcnet_torch/models/rdovae.py and of the quantiser of
# lpcnet_torch/dred/coder.py at commit 027a43f, kept to the streaming
# encoder, the statistical model and the quantiser. Part of the benchmark's
# yardstick: not to be edited.
"""DRED's RDO-VAE, the sender's half (torch/rdovae/rdovae/rdovae.py; C
inference in src/dred_rdovae_enc.c:38-95): the core encoder takes 2 feature
frames a step (a "dframe", 20 ms) through an interleaved dense/GRU stack
whose concatenated outputs feed a causal k=4 conv -> 80 latents, plus a 24-d
initial state for the decoder; the statistical model maps a quantization
level to the quant scale, dead zone and Laplace r, theta of the rates.

Plain functions over nested dicts of float32 tensors. `rnd`, where given,
rounds every operand of the dense, GRU and conv products (the inputs and
the state; the weights are the caller's), for the one-precision-down
control.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..nn import layers as nn


@dataclasses.dataclass(frozen=True)
class RDOVAEConfig:
    num_features: int = 20
    latent_dim: int = 80
    quant_levels: int = 16
    cond_size: int = 256
    cond_size2: int = 256
    state_dim: int = 24
    pvq_num_pulses: int = 82
    enc_frames_per_step: int = 2
    dec_frames_per_step: int = 4
    conv_kernel: int = 4
    state_hidden: int = 128

    @property
    def enc_concat_size(self):
        return 5 * self.cond_size + 3 * self.cond_size2


MAX_MAG = 255          # |z| clamp; keeps the geometric code bounded


@functools.lru_cache(maxsize=None)
def pvq_codebook_size(n: int, k: int) -> int:
    if k == 0:
        return 1
    if n == 0:
        return 0
    return (pvq_codebook_size(n - 1, k) + pvq_codebook_size(n, k - 1)
            + pvq_codebook_size(n - 1, k - 1))


def hard_rate_estimate(z, r, theta):
    z_q = torch.round(z)
    p0 = 1 - r ** (0.5 + 0.5 * theta)
    alpha = torch.relu(1 - z_q.abs()) ** 2
    return -torch.sum(
        alpha * torch.log2(p0 * r ** z_q.abs() + 1e-6)
        + (1 - alpha) * torch.log2(0.5 * (1 - p0) * (1 - r)
                                   * r ** (z_q.abs() - 1) + 1e-6),
        dim=-1)


def soft_dead_zone(x, dead_zone):
    d = dead_zone * 0.05
    return x - d * torch.tanh(x / (0.1 + d))


def statistical_model(params, q_ids: torch.Tensor, cfg: RDOVAEConfig):
    ld = cfg.latent_dim
    x = nn.embedding(params["statistical_model"]["quant_embedding"], q_ids)
    softplus = lambda v: torch.logaddexp(v, torch.zeros_like(v))
    return {
        "quant_scale": softplus(x[..., 0 * ld:1 * ld]),
        "dead_zone": softplus(x[..., 1 * ld:2 * ld]),
        "theta_hard": torch.sigmoid(x[..., 4 * ld:5 * ld]),
        "r_hard": torch.sigmoid(x[..., 5 * ld:6 * ld]),
    }


@torch.no_grad()
def quantize_latents(params, z: torch.Tensor, q_ids: torch.Tensor,
                     cfg: RDOVAEConfig):
    """z [B, L, latent], q_ids [L] -> (round-quantized symbols, rates [B, L])
    (RDOVAE.quantize, torch rdovae.py:584-595)."""
    stats = statistical_model(params, q_ids, cfg)
    zq = soft_dead_zone(z * stats["quant_scale"], stats["dead_zone"])
    zq = torch.clamp(torch.round(zq), -MAX_MAG, MAX_MAG)
    return zq, hard_rate_estimate(zq, stats["r_hard"], stats["theta_hard"])


class EncoderStreamState(NamedTuple):
    gru1: torch.Tensor
    gru2: torch.Tensor
    gru3: torch.Tensor
    conv_mem: torch.Tensor      # [B, k-1, concat]


def init_encoder_stream(batch: int, cfg: RDOVAEConfig, device="cpu"
                        ) -> EncoderStreamState:
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return EncoderStreamState(
        z(batch, cfg.cond_size), z(batch, cfg.cond_size), z(batch, cfg.cond_size),
        z(batch, cfg.conv_kernel - 1, cfg.enc_concat_size))


def _keep(x):
    return x


def _dense(p, x, activation, rnd):
    return nn.dense(p, rnd(x), activation)


def _gru(p, h, x, rnd):
    gate_in = torch.matmul(rnd(x), p["kernel"]) + p["bias"][0]
    zrec = torch.matmul(rnd(h), p["recurrent"]) + p["bias"][1]
    return nn._gru_gates(h, gate_in, zrec, "tanh")


@torch.no_grad()
def encode_dframe(params, state: EncoderStreamState, features2: torch.Tensor,
                  cfg: RDOVAEConfig, rnd=_keep):
    """One 20 ms step: features2 [B, 2 * 20] -> (state, z [B, latent],
    init_state [B, state_dim]) (dred_rdovae_encode_dframe,
    src/dred_rdovae_enc.c:38-95)."""
    p = params["encoder"]
    x1 = _dense(p["dense_1"], features2, "tanh", rnd)
    h1 = _gru(p["gru_1"], state.gru1, x1, rnd)
    x3 = _dense(p["dense_2"], h1, "tanh", rnd)
    h2 = _gru(p["gru_2"], state.gru2, x3, rnd)
    x5 = _dense(p["dense_3"], h2, "tanh", rnd)
    h3 = _gru(p["gru_3"], state.gru3, x5, rnd)
    x7 = _dense(p["dense_4"], h3, "tanh", rnd)
    x8 = _dense(p["dense_5"], x7, "tanh", rnd)
    x9 = torch.cat([x1, h1, x3, h2, x5, h3, x7, x8], dim=-1)
    z, conv_mem = nn.conv1d_stream(p["conv1"], rnd(x9), rnd(state.conv_mem),
                                   "linear")
    st = _dense(p["state_dense_1"], x9, "tanh", rnd)
    st = _dense(p["state_dense_2"], st, "tanh", rnd)
    return EncoderStreamState(h1, h2, h3, conv_mem), z, st
