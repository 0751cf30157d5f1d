"""The LPCNet vocoder: frame-rate conditioning + the sample-rate AR core,
inference only.

Parameters are nested dicts of tensors in the JAX package's layout
(`lpcnet_tpu/models/lpcnet.py`). For inference they are *fused* as the
reference's export does (training_tf2/dump_lpcnet.py:333-350): the shared
signal embedding is premultiplied into GRU-A's input weights (three
[256, 3*Na] lookup tables) and the feature columns of the GRU kernels become
per-frame conditioning matrices.

`synthesize_frame` here is the plain step-by-step reference of one frame,
float or q8. The production path on the GPU is the CUDA sample-loop kernel
(`kernels/sample_loop.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..dsp import lpc as lpc_mod
from ..dsp import mulaw
from ..dsp.constants import LPC_ORDER, NB_FEATURES, PREEMPHASIS
from ..nn import layers as nn
from ..nn import quantized as Q
from ..utils.rng import Kiss99State, kiss99_srand, kiss99_step

PCM_LEVELS = 256
EMBED_SIZE = 128


@dataclasses.dataclass(frozen=True)
class LPCNetConfig:
    rnn_units1: int = 384
    rnn_units2: int = 16
    cond_size: int = 128
    nb_used_features: int = NB_FEATURES
    frame_size: int = 160
    conv_kernel: int = 3
    pitch_embed_dim: int = 64
    e2e: bool = False
    lpc_gamma: float = 1.0
    lookahead: int = 2          # FEATURES_DELAY

    @property
    def frame_input_size(self) -> int:
        return self.nb_used_features + self.pitch_embed_dim

    @property
    def gru_a_input_size(self) -> int:
        return 3 * EMBED_SIZE + self.cond_size

    @property
    def gru_b_input_size(self) -> int:
        return self.rnn_units1 + self.cond_size


def init_params(cfg: LPCNetConfig, seed: int = 0, device="cpu"
                ) -> Dict[str, Any]:
    """Random weights from numpy's RandomState(seed), with the JAX package's
    initializer families (glorot-uniform kernels, per-gate orthogonal GRU
    recurrents, the PCM-ramp signal embedding, zero biases, unit DualFC
    factors). The values differ from `jax.random` init for the same seed:
    to compare with the JAX package, carry its weights across with
    `weights.convert.params_to_torch`."""
    rs = np.random.RandomState(seed)

    def glorot(shape, fan_in, fan_out):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return rs.uniform(-lim, lim, shape)

    def orthogonal_gates(n):
        blocks = []
        for _ in range(3):
            q, r = np.linalg.qr(rs.normal(size=(n, n)))
            blocks.append(q * np.sign(np.diag(r)))
        return np.concatenate(blocks, axis=1)

    def dense(n_in, n_out):
        return {"kernel": glorot((n_in, n_out), n_in, n_out),
                "bias": np.zeros(n_out)}

    def conv(k, n_in, n_out):
        return {"kernel": glorot((k, n_in, n_out), k * n_in, k * n_out),
                "bias": np.zeros(n_out)}

    def gru(n_in, n):
        return {"kernel": glorot((n_in, 3 * n), n_in, 3 * n),
                "recurrent": orthogonal_gates(n), "bias": np.zeros((2, 3 * n))}

    ramp = math.sqrt(12) * (np.arange(256) - 128 + 0.5) / 256
    na, nb, c = cfg.rnn_units1, cfg.rnn_units2, cfg.cond_size
    params = {
        "embed_pitch": {"table": rs.uniform(-0.05, 0.05,
                                            (256, cfg.pitch_embed_dim))},
        "feature_conv1": conv(cfg.conv_kernel, cfg.frame_input_size, c),
        "feature_conv2": conv(cfg.conv_kernel, c, c),
        "feature_dense1": dense(c, c),
        "feature_dense2": dense(c, c),
        "embed_sig": {"table": 0.1 * (rs.uniform(-1.7321, 1.7321,
                                                 (256, EMBED_SIZE))
                                      + ramp[:, None])},
        "gru_a": gru(cfg.gru_a_input_size, na),
        "gru_b": gru(cfg.gru_b_input_size, nb),
        "dual_fc": {"kernel": glorot((nb, PCM_LEVELS, 2), nb, PCM_LEVELS),
                    "bias": np.zeros((PCM_LEVELS, 2)),
                    "factor": np.ones((PCM_LEVELS, 2))},
    }
    from ..weights.convert import params_to_torch
    return params_to_torch(params, device, torch.float32)


def fuse_inference_params(params: Dict[str, Any], cfg: LPCNetConfig
                          ) -> Dict[str, Any]:
    """Precompute embedding x GRU-A-kernel tables and conditioning matrices
    (dump_lpcnet.py:333-350): embed_{sig,pred,exc}_a [256, 3Na], cond_to_a,
    cond_to_b, gru_a_rec, gru_b_in, gru_b_rec; frame-net params unchanged."""
    e = params["embed_sig"]["table"]
    ka = params["gru_a"]["kernel"]
    return {
        "embed_pitch": params["embed_pitch"],
        "feature_conv1": params["feature_conv1"],
        "feature_conv2": params["feature_conv2"],
        "feature_dense1": params["feature_dense1"],
        "feature_dense2": params["feature_dense2"],
        "embed_sig_a": e @ ka[:EMBED_SIZE],
        "embed_pred_a": e @ ka[EMBED_SIZE:2 * EMBED_SIZE],
        "embed_exc_a": e @ ka[2 * EMBED_SIZE:3 * EMBED_SIZE],
        "cond_to_a": {"kernel": ka[3 * EMBED_SIZE:],
                      "bias": params["gru_a"]["bias"][0]},
        "cond_to_b": {"kernel": params["gru_b"]["kernel"][cfg.rnn_units1:],
                      "bias": params["gru_b"]["bias"][0]},
        "gru_a_rec": {"recurrent": params["gru_a"]["recurrent"],
                      "bias": params["gru_a"]["bias"]},
        "gru_b_in": params["gru_b"]["kernel"][:cfg.rnn_units1],
        "gru_b_rec": {"recurrent": params["gru_b"]["recurrent"],
                      "bias": params["gru_b"]["bias"]},
        "dual_fc": params["dual_fc"],
    }


# --------------------------------------------------------------------------
# Frame-rate network
# --------------------------------------------------------------------------

class FrameState(NamedTuple):
    """Streaming conv state + delayed-LPC FIFO, batched [B, ...]."""
    conv1_mem: torch.Tensor     # [B, k-1, frame_input]
    conv2_mem: torch.Tensor     # [B, k-1, cond]
    old_lpc: torch.Tensor       # [B, max(lookahead, 1), 16]
    frame_count: torch.Tensor   # [B] int32


def init_frame_state(batch: int, cfg: LPCNetConfig, device="cpu") -> FrameState:
    k = cfg.conv_kernel
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return FrameState(
        conv1_mem=z(batch, k - 1, cfg.frame_input_size),
        conv2_mem=z(batch, k - 1, cfg.cond_size),
        old_lpc=z(batch, max(cfg.lookahead, 1), LPC_ORDER),
        frame_count=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def pitch_index(features: torch.Tensor) -> torch.Tensor:
    """features[..., 18] -> pitch embedding index (src/lpcnet.c:92-94)."""
    p = torch.floor(0.1 + 50.0 * features[..., NB_FEATURES - 2] + 100.0)
    return torch.clamp(p.to(torch.int32), 33, 255)


def frame_network(fused, state: FrameState, features: torch.Tensor,
                  cfg: LPCNetConfig):
    """One frame of conditioning; features [B, 36] (or [B, >=20]).

    Returns (new_state, cond [B, cond], cond_a [B, 3Na], cond_b [B, 3Nb],
    lpc [B, 16]). Replicates run_frame_network (src/lpcnet.c:82-120): conv
    warmup zeroing, the delayed-LPC FIFO, the e2e rc path and lpc_gamma.
    """
    f20 = features[..., :cfg.nb_used_features]
    pembed = nn.embedding(fused["embed_pitch"], pitch_index(features))
    x = torch.cat([f20, pembed], dim=-1)
    c1, mem1 = nn.conv1d_stream(fused["feature_conv1"], x, state.conv1_mem)
    conv1_delay = (cfg.conv_kernel - 1) // 2
    c1 = torch.where((state.frame_count < conv1_delay)[..., None], 0.0, c1)
    c2, mem2 = nn.conv1d_stream(fused["feature_conv2"], c1, state.conv2_mem)
    c2 = torch.where((state.frame_count < cfg.lookahead)[..., None], 0.0, c2)
    d1 = nn.dense(fused["feature_dense1"], c2, "tanh")
    cond = nn.dense(fused["feature_dense2"], d1, "tanh")
    cond_a = nn.dense(fused["cond_to_a"], cond)
    cond_b = nn.dense(fused["cond_to_b"], cond)

    if cfg.e2e:
        # cond is tanh-bounded; its first 16 units are reflection coefficients
        lpc = lpc_mod.rc2lpc(cond[..., :LPC_ORDER])
        new_old = state.old_lpc
    else:
        lpc_now = lpc_mod.lpc_from_cepstrum(features[..., :18])
        if cfg.lookahead > 0:
            lpc = state.old_lpc[:, -1]
            new_old = torch.cat([lpc_now[:, None], state.old_lpc[:, :-1]], 1)
        else:
            lpc = lpc_now
            new_old = state.old_lpc
    if cfg.lpc_gamma != 1.0:
        lpc = lpc_mod.lpc_weighting(lpc, cfg.lpc_gamma)
    new_state = FrameState(mem1, mem2, new_old,
                           torch.clamp(state.frame_count + 1, max=1000))
    return new_state, cond, cond_a, cond_b, lpc


# --------------------------------------------------------------------------
# Sample-rate network (plain reference)
# --------------------------------------------------------------------------

class SampleState(NamedTuple):
    """Per-stream AR state, batched [B, ...] (cf. LPCNetState,
    src/lpcnet_private.h:28-48). Field order as in the JAX package."""
    gru_a: torch.Tensor        # [B, Na]
    gru_b: torch.Tensor        # [B, Nb]
    last_sig: torch.Tensor     # [B, 16] most recent first
    last_exc: torch.Tensor     # [B] int32 u-law code
    deemph: torch.Tensor       # [B] de-emphasis memory
    rng: Kiss99State           # [B] int64 words holding uint32 values


def init_sample_state(batch: int, cfg: LPCNetConfig, device="cpu"
                      ) -> SampleState:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return SampleState(
        gru_a=z(batch, cfg.rnn_units1),
        gru_b=z(batch, cfg.rnn_units2),
        last_sig=z(batch, LPC_ORDER),
        last_exc=torch.full((batch,), 128, dtype=torch.int32, device=device),
        deemph=z(batch),
        rng=kiss99_srand(n_streams=batch, device=device),
    )


def sampling_logit_table() -> np.ndarray:
    """t[i] = logit(.025 + .95*i/255) (src/lpcnet.c:188-191), float32."""
    i = np.arange(256, dtype=np.float32)
    p = 0.025 + 0.95 * i / 255.0
    return (-np.log((1.0 - p) / p)).astype(np.float32)


_LOGIT_TABLE = torch.from_numpy(sampling_logit_table())


def draw_threshold_bytes(rng: Kiss99State):
    """Two KISS99 draws -> the 8 per-bit threshold bytes, low byte first."""
    r1, rng = kiss99_step(rng)
    r2, rng = kiss99_step(rng)
    return [(r >> (8 * k)) & 0xFF for r in (r1, r2) for k in range(4)], rng


def sample_excitation(dual_fc, gru_b_state: torch.Tensor, rng: Kiss99State):
    """Bit-tree sampling of the 8-bit u-law excitation (src/nnet.c:163-214).

    Returns (exc [B] int32, new_rng).
    """
    table = _LOGIT_TABLE.to(gru_b_state.device)
    bytes_, rng = draw_threshold_bytes(rng)
    logits = nn.mdense_logits(dual_fc, gru_b_state)          # [B, 256]
    val = torch.zeros(gru_b_state.shape[:-1], dtype=torch.int64,
                      device=gru_b_state.device)
    for b in range(8):
        logit = logits.gather(-1, ((1 << b) | val)[..., None])[..., 0]
        val = (val << 1) | (table[bytes_[b]] < logit).long()
    return val.to(torch.int32), rng


def _gru_layers(fused, state: SampleState, cond_a, cond_b, sig_u, pred_u):
    """GRU-A and GRU-B of one sample step -> (h_a, h_b)."""
    gate_a = (cond_a + fused["embed_sig_a"][sig_u.long()]
              + fused["embed_pred_a"][pred_u.long()]
              + fused["embed_exc_a"][state.last_exc.long()])
    if Q.is_quantized(fused):
        h_a = Q.gru_precomputed_step_q8(fused["gru_a_rec"], state.gru_a, gate_a)
        gate_b = cond_b + Q.qmatmul(Q.quantize_act_int8(h_a),
                                    fused["gru_b_in_q8"])
        h_b = Q.gru_precomputed_step_q8_dense(fused["gru_b_rec"],
                                              state.gru_b, gate_b)
    else:
        h_a = nn.gru_precomputed_step(fused["gru_a_rec"], state.gru_a, gate_a)
        gate_b = cond_b + h_a @ fused["gru_b_in"]
        h_b = nn.gru_precomputed_step(fused["gru_b_rec"], state.gru_b, gate_b)
    return h_a, h_b


def sample_network_step(fused, state: SampleState, cond_a, cond_b,
                        sig_u, pred_u):
    """One sample step given the u-law codes of the last signal and of the
    prediction; float or q8 (nn.quantized.quantize_fused) params."""
    h_a, h_b = _gru_layers(fused, state, cond_a, cond_b, sig_u, pred_u)
    exc, rng = sample_excitation(fused["dual_fc"], h_b, state.rng)
    return h_a, h_b, exc, rng


def synthesize_frame(fused, state: SampleState, cond_a, cond_b, lpc,
                     n_samples: int = 160, preload=None):
    """One frame of audio for a batch of streams, step by step.

    preload: optional [B, n_samples] target waveform for teacher forcing
    (src/lpcnet.c:256-259): the excitation fed back comes from the target.
    Returns (new_state, pcm [B, n_samples] float, rounded, in +-32767).
    Matches lpcnet_synthesize_tail_impl (src/lpcnet.c:235-271).
    """
    st = state
    out = []
    for t in range(n_samples):
        pred = -(st.last_sig * lpc).sum(-1)
        sig_u = mulaw.lin2ulaw(st.last_sig[..., 0])
        pred_u = mulaw.lin2ulaw(pred)
        if preload is not None:
            # the target's excitation replaces the sampled one, so the
            # sampler only has to advance the RNG by its two draws
            h_a, h_b = _gru_layers(fused, st, cond_a, cond_b, sig_u, pred_u)
            _, rng = draw_threshold_bytes(st.rng)
            pcm = preload[..., t] - PREEMPHASIS * st.deemph
            exc = mulaw.lin2ulaw(pcm - pred)
        else:
            h_a, h_b, exc, rng = sample_network_step(
                fused, st, cond_a, cond_b, sig_u, pred_u)
            pcm = pred + mulaw.ulaw2lin(exc)
        sig = torch.cat([pcm[..., None], st.last_sig[..., :-1]], dim=-1)
        o = pcm + PREEMPHASIS * st.deemph
        st = SampleState(h_a, h_b, sig, exc, o, rng)
        out.append(torch.clamp(o, -32767.0, 32767.0))
    return st, torch.floor(0.5 + torch.stack(out, dim=-1))
