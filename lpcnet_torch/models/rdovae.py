"""DRED's RDO-VAE: the rate-distortion-optimised redundancy coder.

The reference's RDO-VAE (torch/rdovae/rdovae/rdovae.py; C inference in
src/dred_rdovae_enc.c:38-95 and src/dred_rdovae_dec.c:37-98), as the JAX
package's `models/rdovae.py` has it:

* the core encoder takes 2 feature frames a step (a "dframe", 20 ms)
  through an interleaved dense/GRU stack whose concatenated outputs feed a
  causal k=4 conv -> 80 latents, plus a 24-d initial state for the decoder
  (PVQ-coded on the wire);
* the core decoder mirrors the stack, starts from 3 state-init denses and
  gives 4 feature frames a latent; it runs over time-reversed latents
  (redundancy decodes newest first);
* the statistical model maps a quantization level to the quant scale, dead
  zone and Laplace r, theta of the rate estimates.

Plain functions over nested dicts of tensors in the JAX package's layout.
The sequence forms serve training, the streaming forms (`encode_dframe`,
`decode_qframe`, NamedTuple states batched over streams) serving. No TPU
kernel is on this path: the products are float32 `torch.matmul` (TF32 off
on CUDA, see `utils.device`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..nn import init as nn_init
from ..nn import layers as nn
from ..utils.rng import draw


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
    def enc_input_dim(self):
        return self.enc_frames_per_step * self.num_features

    @property
    def enc_concat_size(self):
        return 5 * self.cond_size + 3 * self.cond_size2

    @property
    def dec_concat_size(self):
        # x1(c2), x2(c), x3(c2), x4(c), x5(c2), x6(c), x7(c2), x8(c2);
        # the torch reference writes 4c+4c2 which only matches because its
        # defaults have c == c2 (torch rdovae.py:328 with :337-338)
        return 3 * self.cond_size + 5 * self.cond_size2


def init_params(cfg: RDOVAEConfig | None = None, seed: int = 0,
                device="cpu") -> Dict[str, Any]:
    """Random weights from numpy's RandomState(seed) (`nn.init`), the
    statistical model's table zero, as the JAX package's init. The values
    differ from its `jax.random` init for the same seed."""
    cfg = cfg or RDOVAEConfig()
    rs = np.random.RandomState(seed)
    c, c2 = cfg.cond_size, cfg.cond_size2
    dense = lambda n_in, n_out: nn_init.dense_params(rs, n_in, n_out)
    gru = lambda n_in, n: nn_init.gru_params(rs, n_in, n)
    enc = {
        "dense_1": dense(cfg.enc_input_dim, c2),
        "gru_1": gru(c2, c),
        "dense_2": dense(c, c2),
        "gru_2": gru(c2, c),
        "dense_3": dense(c, c2),
        "gru_3": gru(c2, c),
        "dense_4": dense(c, c),
        "dense_5": dense(c, c),
        "conv1": nn_init.conv1d_params(rs, cfg.conv_kernel,
                                       cfg.enc_concat_size, cfg.latent_dim),
        "state_dense_1": dense(cfg.enc_concat_size, cfg.state_hidden),
        "state_dense_2": dense(cfg.state_hidden, cfg.state_dim),
    }
    dec = {
        "dense_1": dense(cfg.latent_dim, c2),
        "gru_1": gru(c2, c),
        "dense_2": dense(c, c2),
        "gru_2": gru(c2, c),
        "dense_3": dense(c, c2),
        "gru_3": gru(c2, c),
        "dense_4": dense(c, c2),
        "dense_5": dense(c2, c2),
        "output": dense(cfg.dec_concat_size,
                        cfg.dec_frames_per_step * cfg.num_features),
        "gru_1_init": dense(cfg.state_dim, c),
        "gru_2_init": dense(cfg.state_dim, c),
        "gru_3_init": dense(cfg.state_dim, c),
    }
    stats = {"quant_embedding": {"table": np.zeros(
        (cfg.quant_levels, 6 * cfg.latent_dim), np.float32)}}
    from ..weights.convert import params_to_torch
    return params_to_torch({"encoder": enc, "decoder": dec,
                            "statistical_model": stats}, device, torch.float32)


# --------------------------------------------------------------------------
# Quantization and rate utilities (torch rdovae.py:40-149)
# --------------------------------------------------------------------------

def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (1e-15 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))


@torch.no_grad()
def _pvq_quantize(x: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    x_norm1 = x / (1e-15 + x.abs().sum(-1, keepdim=True))
    scale = torch.full(x.shape[:-1] + (1,), float(k), dtype=x.dtype,
                       device=x.device)
    x_scaled = scale * x_norm1
    x_quant = torch.round(x_scaled)         # half to even, as jnp.round
    for _ in range(iters):
        abs_q, abs_s = x_quant.abs(), x_scaled.abs()
        l1 = abs_q.sum(-1)
        plus = 1.0001 * ((abs_q + 0.5) / (abs_s + 1e-15)).amin(-1)
        minus = 0.9999 * ((abs_q - 0.5) / (abs_s + 1e-15)).amax(-1)
        factor = torch.where(l1 > k, minus, plus)
        factor = torch.where(l1 == k, torch.ones_like(factor), factor)
        scale = scale * factor[..., None]
        x_scaled = scale * x_norm1
        x_quant = torch.round(x_scaled)
    return _unit(x_quant)


def soft_pvq(x: torch.Tensor, k: int, iters: int = 10) -> torch.Tensor:
    """Soft pyramid vector quantizer: the unit-norm k-pulse vector found by
    `iters` rescalings, with a straight-through gradient to x's unit
    vector."""
    x_norm2 = _unit(x)
    q = _pvq_quantize(x.detach(), k, iters)
    return x_norm2 + (q - x_norm2).detach()


@functools.lru_cache(maxsize=None)
def pvq_codebook_size(n: int, k: int) -> int:
    if k == 0:
        return 1
    if n == 0:
        return 0
    return (pvq_codebook_size(n - 1, k) + pvq_codebook_size(n, k - 1)
            + pvq_codebook_size(n - 1, k - 1))


def pvq_state_bits(cfg: RDOVAEConfig) -> float:
    return math.log2(pvq_codebook_size(cfg.state_dim, cfg.pvq_num_pulses))


def soft_rate_estimate(z, r, reduce: bool = True):
    rate = torch.sum(-torch.log2((1 - r) / (1 + r) * r ** z.abs() + 1e-6),
                     dim=-1)
    return rate.mean() if reduce else rate


def hard_rate_estimate(z, r, theta, reduce: bool = True):
    z_q = torch.round(z)
    p0 = 1 - r ** (0.5 + 0.5 * theta)
    alpha = torch.relu(1 - z_q.abs()) ** 2
    rate = -torch.sum(
        alpha * torch.log2(p0 * r ** z_q.abs() + 1e-6)
        + (1 - alpha) * torch.log2(0.5 * (1 - p0) * (1 - r)
                                   * r ** (z_q.abs() - 1) + 1e-6),
        dim=-1)
    return rate.mean() if reduce else rate


def soft_dead_zone(x, dead_zone):
    d = dead_zone * 0.05
    return x - d * torch.tanh(x / (0.1 + d))


def hard_quantize(x):
    return x + (torch.round(x) - x).detach()


def noise_quantize(x, generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None):
    """x + U(-0.5, 0.5): the draw from `generator`, or `noise` (a U(0, 1)
    draw of x's shape) where given."""
    if noise is None:
        noise = draw(torch.rand, x.shape, generator, dtype=x.dtype
                     ).to(x.device)
    return x + (noise - 0.5)


def distortion_loss(y_true, y_pred, rate_lambda=None):
    """Feature-weighted distortion (torch rdovae.py:155-173)."""
    ceps_err = y_pred[..., :18] - y_true[..., :18]
    pitch_err = (2 * (y_pred[..., 18:19] - y_true[..., 18:19])
                 / (2 + y_true[..., 18:19]))
    corr_err = y_pred[..., 19:20] - y_true[..., 19:20]
    pitch_weight = torch.relu(y_true[..., 19:20] + 0.5) ** 2
    err = torch.cat([ceps_err ** 2,
                     (10.0 / 18.0) * pitch_err.abs() * pitch_weight,
                     (1.0 / 18.0) * corr_err ** 2], dim=-1)
    loss = err.mean(-1)
    if rate_lambda is not None:
        loss = loss / torch.sqrt(rate_lambda)
    return loss.mean()


# --------------------------------------------------------------------------
# Statistical model
# --------------------------------------------------------------------------

def statistical_model(params, q_ids: torch.Tensor, cfg: RDOVAEConfig):
    ld = cfg.latent_dim
    x = nn.embedding(params["statistical_model"]["quant_embedding"], q_ids)
    softplus = lambda v: torch.logaddexp(v, torch.zeros_like(v))
    return {
        "quant_embedding": x,
        "quant_scale": softplus(x[..., 0 * ld:1 * ld]),
        "dead_zone": softplus(x[..., 1 * ld:2 * ld]),
        "theta_soft": torch.sigmoid(x[..., 2 * ld:3 * ld]),
        "r_soft": torch.sigmoid(x[..., 3 * ld:4 * ld]),
        "theta_hard": torch.sigmoid(x[..., 4 * ld:5 * ld]),
        "r_hard": torch.sigmoid(x[..., 5 * ld:6 * ld]),
    }


# --------------------------------------------------------------------------
# Sequence (training) forms
# --------------------------------------------------------------------------

def _core_stack(p, x1, h0=(None, None, None)):
    """The stack both cores share: dense_1's output x1 through GRU 1,
    dense_2, GRU 2, dense_3, GRU 3, dense_4, dense_5; returns the eight
    outputs concatenated."""
    x2, _ = nn.gru_seq(p["gru_1"], x1, h0=h0[0])
    x3 = nn.dense(p["dense_2"], x2, "tanh")
    x4, _ = nn.gru_seq(p["gru_2"], x3, h0=h0[1])
    x5 = nn.dense(p["dense_3"], x4, "tanh")
    x6, _ = nn.gru_seq(p["gru_3"], x5, h0=h0[2])
    x7 = nn.dense(p["dense_4"], x6, "tanh")
    x8 = nn.dense(p["dense_5"], x7, "tanh")
    return torch.cat([x1, x2, x3, x4, x5, x6, x7, x8], dim=-1)


def encode_seq(params, features: torch.Tensor, cfg: RDOVAEConfig):
    """features [B, T, 20] (T even) -> (z [B, T/2, latent],
    states [B, T/2, state_dim])."""
    p = params["encoder"]
    b, t, _ = features.shape
    x = features.reshape(b, t // cfg.enc_frames_per_step, cfg.enc_input_dim)
    x9 = _core_stack(p, nn.dense(p["dense_1"], x, "tanh"))
    states = nn.dense(p["state_dense_1"], x9, "tanh")
    states = nn.dense(p["state_dense_2"], states, "tanh")
    z = nn.conv1d_seq(p["conv1"], x9, "linear", padding="causal")
    return z, states


def _decoder_init(p, initial_state):
    return tuple(torch.tanh(nn.dense(p[f"gru_{i}_init"], initial_state))
                 for i in (1, 2, 3))


def decode_seq(params, z: torch.Tensor, initial_state: torch.Tensor,
               cfg: RDOVAEConfig):
    """z [B, Tz, latent] (already in decode order), initial_state
    [B, state_dim] -> features [B, Tz * 4, 20]."""
    p = params["decoder"]
    x9 = _core_stack(p, nn.dense(p["dense_1"], z, "tanh"),
                     _decoder_init(p, initial_state))
    out = nn.dense(p["output"], x9)
    b, tz, _ = out.shape
    return out.reshape(b, tz * cfg.dec_frames_per_step, cfg.num_features)


def get_decoder_chunks(z_frames: int, cfg: RDOVAEConfig,
                       chunks_per_offset: int = 4):
    """Stride-congruent split-decoding chunks (torch rdovae.py:467-513)."""
    stride = cfg.dec_frames_per_step // cfg.enc_frames_per_step
    enc_stride = cfg.enc_frames_per_step
    dec_stride = cfg.dec_frames_per_step
    chunks = []
    for offset in range(stride):
        start = offset
        while enc_stride * (start + 1) - dec_stride < 0:
            start += stride
        if start >= z_frames:
            raise ValueError("sequence too short for split decoding")
        stop = z_frames - (z_frames % stride) + offset
        while stop < z_frames:
            stop += stride
        length = stop - start
        split_points = [start + stride * int(i * length / chunks_per_offset / stride)
                        for i in range(chunks_per_offset)] + [stop]
        for i in range(chunks_per_offset):
            chunks.append({
                "z_start": split_points[i],
                "z_stop": split_points[i + 1] - stride + 1,
                "z_stride": stride,
                "features_start": enc_stride * (split_points[i] + 1) - dec_stride,
                "features_stop": enc_stride * (split_points[i + 1] - stride + 1),
            })
    return chunks


def training_forward(params, features, q_ids, generator: torch.Generator | None,
                     cfg: RDOVAEConfig, state_dropout_rate: float = 0.0,
                     noise: torch.Tensor | None = None):
    """Full training graph (torch rdovae.py:516-562).

    features [B, T, 20] (T % 4 == 0), q_ids [B, T/2] int. The soft-quant
    noise and the state-dropout draw come from `generator`; `noise` (a
    U(0, 1) draw of z's shape) replaces the former where given.
    state_dropout_rate zeroes a sequence's quantized decoder-init states
    with this probability (torch rdovae.py:533-537).
    """
    stats = statistical_model(params, q_ids, cfg)
    z, states = encode_seq(params, features, cfg)
    z = z * stats["quant_scale"]
    z = soft_dead_zone(z, stats["dead_zone"])
    z_q = hard_quantize(z) / stats["quant_scale"]
    z_n = noise_quantize(z, generator, noise) / stats["quant_scale"]
    states_q = soft_pvq(states, cfg.pvq_num_pulses)
    if state_dropout_rate > 0:
        drop = draw(torch.rand, states_q.shape[:1], generator
                    ).to(states_q.device) < state_dropout_rate
        states_q = states_q * (1.0 - drop.to(states_q.dtype))[:, None, None]

    outputs_hq, outputs_sq = [], []
    for ch in get_decoder_chunks(z.shape[1], cfg):
        sel = slice(ch["z_start"], ch["z_stop"], ch["z_stride"])
        init = states_q[:, ch["z_stop"] - 1]
        span = (ch["features_start"], ch["features_stop"])
        for zz, outs in ((z_q, outputs_hq), (z_n, outputs_sq)):
            dec = decode_seq(params, torch.flip(zz[:, sel], dims=(1,)), init, cfg)
            outs.append((torch.flip(dec, dims=(1,)),) + span)

    return {"z": z, "states": states, "outputs_hard_quant": outputs_hq,
            "outputs_soft_quant": outputs_sq, "statistical_model": stats}


def rdovae_loss(params, features, rate_lambda, q_ids,
                generator: torch.Generator | None, cfg: RDOVAEConfig,
                state_dropout_rate: float = 0.0,
                noise: torch.Tensor | None = None):
    """Total loss and its parts (train_rdovae.py:195-228)."""
    out = training_forward(params, features, q_ids, generator, cfg,
                           state_dropout_rate=state_dropout_rate, noise=noise)
    stats = out["statistical_model"]
    z = out["z"]
    lam_up = torch.repeat_interleave(rate_lambda, cfg.enc_frames_per_step, dim=1)

    hard_rate = hard_rate_estimate(z, stats["r_hard"], stats["theta_hard"],
                                   reduce=False)
    soft_rate = soft_rate_estimate(z, stats["r_soft"], reduce=False)
    soft_rate_loss = torch.mean(torch.sqrt(rate_lambda) * soft_rate)
    hard_rate_loss = torch.mean(torch.sqrt(rate_lambda) * hard_rate)
    rate_loss = soft_rate_loss + 0.1 * hard_rate_loss

    def dist(outputs):
        return sum(distortion_loss(features[:, a:b], dec, lam_up[:, a:b])
                   / len(outputs) for dec, a, b in outputs)

    dist_h = dist(out["outputs_hard_quant"])
    dist_s = dist(out["outputs_soft_quant"])
    total = rate_loss + (dist_h + dist_s) / 2.0
    metrics = {"rate_loss": rate_loss, "dist_hard": dist_h,
               "dist_soft": dist_s, "hard_rate_bits": hard_rate.mean(),
               "total": total}
    return total, metrics


# --------------------------------------------------------------------------
# Streaming inference (src/dred_rdovae_enc.c, src/dred_rdovae_dec.c)
# --------------------------------------------------------------------------

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


def _core_step(p, x1, h):
    """One step of `_core_stack` from the GRU states h = (h1, h2, h3)."""
    h1 = nn.gru_step(p["gru_1"], h[0], x1)
    x3 = nn.dense(p["dense_2"], h1, "tanh")
    h2 = nn.gru_step(p["gru_2"], h[1], x3)
    x5 = nn.dense(p["dense_3"], h2, "tanh")
    h3 = nn.gru_step(p["gru_3"], h[2], x5)
    x7 = nn.dense(p["dense_4"], h3, "tanh")
    x8 = nn.dense(p["dense_5"], x7, "tanh")
    return (h1, h2, h3), torch.cat([x1, h1, x3, h2, x5, h3, x7, x8], dim=-1)


def encode_dframe(params, state: EncoderStreamState, features2: torch.Tensor,
                  cfg: RDOVAEConfig):
    """One 20 ms step: features2 [B, 2 * 20] -> (state, z [B, latent],
    init_state [B, state_dim]) (dred_rdovae_encode_dframe,
    src/dred_rdovae_enc.c:38-95)."""
    p = params["encoder"]
    h, x9 = _core_step(p, nn.dense(p["dense_1"], features2, "tanh"),
                       state[:3])
    z, conv_mem = nn.conv1d_stream(p["conv1"], x9, state.conv_mem, "linear")
    st = nn.dense(p["state_dense_1"], x9, "tanh")
    st = nn.dense(p["state_dense_2"], st, "tanh")
    return EncoderStreamState(*h, conv_mem), z, st


class DecoderStreamState(NamedTuple):
    gru1: torch.Tensor
    gru2: torch.Tensor
    gru3: torch.Tensor


def init_decoder_stream(params, initial_state: torch.Tensor,
                        cfg: RDOVAEConfig) -> DecoderStreamState:
    """dred_rdovae_dec_init_states (src/dred_rdovae_dec.c:37-47)."""
    return DecoderStreamState(*_decoder_init(params["decoder"], initial_state))


def decode_qframe(params, state: DecoderStreamState, z: torch.Tensor,
                  cfg: RDOVAEConfig):
    """One latent [B, latent] -> (state, 4 feature frames [B, 4, 20])
    (src/dred_rdovae_dec.c:50-98)."""
    p = params["decoder"]
    h, x9 = _core_step(p, nn.dense(p["dense_1"], z, "tanh"), state)
    out = nn.dense(p["output"], x9)
    return DecoderStreamState(*h), out.reshape(
        out.shape[0], cfg.dec_frames_per_step, cfg.num_features)
