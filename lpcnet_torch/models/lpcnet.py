"""The LPCNet vocoder: frame-rate conditioning + the sample-rate AR core,
for inference, and the sequence-form training graph.

Parameters are nested dicts of tensors in the JAX package's layout
(`lpcnet_tpu/models/lpcnet.py`). For inference they are *fused* as the
reference's export does (training_tf2/dump_lpcnet.py:333-350): the shared
signal embedding is premultiplied into GRU-A's input weights (three
[256, 3*Na] lookup tables) and the feature columns of the GRU kernels become
per-frame conditioning matrices.

`synthesize_frame` here is the plain step-by-step reference of one frame,
float or q8. The production path on the GPU is the CUDA sample-loop kernel
(`kernels/sample_loop.py`).

`training_forward` is the training graph (teacher-forced, whole chunks):
the 'valid' frame network, the fractional embedding of the three u-law
inputs, GRU-A and GRU-B over the chunk and the DualFC bit-tree outputs. On
a card its two recurrences run through the CUDA kernel of
`kernels/gru_train.py`.
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
from ..utils.rng import Kiss99State, draw, kiss99_srand, kiss99_step

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
    cond_to_b, gru_a_rec, gru_b_in, gru_b_rec; frame-net params unchanged;
    and the tables' factors embed_table [256, 128] and gru_a_in_kernel
    [384, 3Na]."""
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
        # the composed tables' factors, for the factored q8 embedding
        # (kernels.sample_loop, LPCNET_EMB=factored); a model loaded from a
        # DNNw blob has only the composed tables, so both keys are optional
        "embed_table": e,
        "gru_a_in_kernel": ka[:3 * EMBED_SIZE],
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


_FRAME_NET_PARAMS = ("embed_pitch", "feature_conv1", "feature_conv2",
                     "feature_dense1", "feature_dense2", "cond_to_a",
                     "cond_to_b")


class FrameNetworkGraph:
    """`frame_network` as one CUDA graph, for a caller that runs it at one
    batch every frame (`codec.decoder.LPCNetDecoder`): a call takes and
    returns what `frame_network` does, and on CUDA it copies the features
    (and a state that is not the graph's own) into the graph's inputs and
    replays the graph, in place of ~670 launches from the host.

    On CPU tensors a call is the plain `frame_network`. On CUDA the first
    call captures: a few eager calls on a throwaway copy of the state, on a
    side stream (cuBLAS handles, the cuFFT plan of `irfft`, the device
    constants), then one captured call. A call captures again when what
    the graph holds would differ from what an eager call reads now: the
    config, the features' shape and dtype, the frame network's weight
    tensors (by identity; writes into them reach the graph), the
    activation implementation and its table (`nn.layers.activation_key`),
    the TF32 flag. Inside a CUDA stream capture of the caller's a call runs
    eagerly, so it is captured with the rest.

    The graph reads and writes its own state buffers: a call returns them
    as the new state, written in place, and the cond, cond_a, cond_b and
    lpc it returns are the graph's outputs; all of them are valid until the
    next call. The graph holds the weight tensors it read; the cuFFT plan
    it replays lives in PyTorch's plan cache (cleared or overfull, the
    graph would read a freed plan).

    Counters (CUDA calls only): `captures`, `replays`, and `eager` (calls
    run eagerly inside a caller's capture). Every CUDA call outside one
    replays, the first included.
    """

    WARMUP = 3

    def __init__(self):
        self.captures = self.replays = self.eager = 0
        self._key = None
        self._held = None
        self._graph = None

    def __call__(self, fused, state: FrameState, features: torch.Tensor,
                 cfg: LPCNetConfig):
        if not features.is_cuda:
            return frame_network(fused, state, features, cfg)
        if torch.cuda.is_current_stream_capturing():
            self.eager += 1
            return frame_network(fused, state, features, cfg)
        impl, table = nn.activation_key(features.device)
        held = [t for k in _FRAME_NET_PARAMS for t in fused[k].values()]
        held.append(table)
        key = (cfg, features.shape, features.dtype, impl,
               torch.backends.cuda.matmul.allow_tf32, tuple(map(id, held)))
        if key != self._key:
            self._capture(fused, state, features, cfg)
            self._key, self._held = key, held
        st_in, feats_in, out = self._graph[1:]
        for buf, given in zip(st_in, state):
            if given is not buf:
                buf.copy_(given)
        feats_in.copy_(features)
        self._graph[0].replay()
        self.replays += 1
        return (st_in,) + out

    @staticmethod
    def _body(fused, state, features, cfg):
        """frame_network with its new state written into `state`; lpc (a
        view of the FIFO when lookahead > 0) copied out first."""
        new, cond, ca, cb, lpc = frame_network(fused, state, features, cfg)
        lpc = lpc.clone()
        for buf, val in zip(state, new):
            buf.copy_(val)
        return cond, ca, cb, lpc

    def _capture(self, fused, state, features, cfg):
        self._graph = None                   # the old graph's pool goes
        dev = features.device
        dense = torch.contiguous_format
        st_in = FrameState(*(t.clone(memory_format=dense) for t in state))
        feats_in = features.clone(memory_format=dense)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.stream(side):
            scratch = FrameState(*(t.clone() for t in st_in))
            for _ in range(self.WARMUP):
                self._body(fused, scratch, feats_in, cfg)
            with torch.cuda.graph(graph, stream=side):
                out = self._body(fused, st_in, feats_in, cfg)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph = (graph, st_in, feats_in, out)
        self.captures += 1


def frame_network_flush(fused, state: FrameState, ring: torch.Tensor,
                        count: torch.Tensor, cfg: LPCNetConfig):
    """`count[i]` consecutive frame_network steps of stream i over known
    inputs, as one batched call (count 0 freezes a stream): the batched
    PLC's flush of deferred frames.

    ring [B, T, 36] inputs in flush order; count [B] int in [0, T].
    Returns (new_state, cond_a, cond_b, lpc) of the last active step
    (undefined where count is 0; the caller masks). The convs run once over
    all T windows, the dense stack once on the last active position; the
    per-stream selections are gathers.
    """
    b, T = ring.shape[0], ring.shape[1]
    k = cfg.conv_kernel
    count = count.long()
    rows = torch.arange(b, device=ring.device)
    pembed = nn.embedding(fused["embed_pitch"], pitch_index(ring))
    x = torch.cat([ring[..., :cfg.nb_used_features], pembed], dim=-1)

    def conv_seq(params, mem, seq, zero_before):
        ext = torch.cat([mem, seq], dim=1)               # [B, k-1+T, cin]
        win = ext.unfold(1, k, 1).transpose(-1, -2)      # [B, T, k, cin]
        kernel = params["kernel"]
        y = torch.matmul(win.reshape(b, T, -1),
                         kernel.reshape(-1, kernel.shape[-1])) + params["bias"]
        y = nn.activate(y, "tanh")
        fc_t = state.frame_count[:, None] + torch.arange(T, device=ring.device)
        y = torch.where((fc_t < zero_before)[..., None], 0.0, y)
        # new_mem[:, j] = ext[:, count + j]
        new_mem = torch.stack([ext[rows, count + j] for j in range(k - 1)],
                              dim=1)
        return y, new_mem

    c1, mem1 = conv_seq(fused["feature_conv1"], state.conv1_mem, x,
                        (cfg.conv_kernel - 1) // 2)
    c2, mem2 = conv_seq(fused["feature_conv2"], state.conv2_mem, c1,
                        cfg.lookahead)
    last1 = torch.clamp(count - 1, min=0)
    d1 = nn.dense(fused["feature_dense1"], c2[rows, last1], "tanh")
    cond = nn.dense(fused["feature_dense2"], d1, "tanh")
    cond_a = nn.dense(fused["cond_to_a"], cond)
    cond_b = nn.dense(fused["cond_to_b"], cond)

    if cfg.e2e:
        lpc = lpc_mod.rc2lpc(cond[..., :LPC_ORDER])
        new_old = state.old_lpc
    else:
        lpc_now = lpc_mod.lpc_from_cepstrum(ring[..., :18])   # [B, T, 16]
        if cfg.lookahead > 0:
            # the FIFO pushed `count` times: the emitted lpc and the final
            # FIFO rows are rows of [reversed old FIFO | lpc_now]
            la = cfg.lookahead
            ext2 = torch.cat([torch.flip(state.old_lpc, (1,)), lpc_now], dim=1)
            lpc = ext2[rows, last1]
            top = la + last1 - torch.where(count > 0, 0, 1)
            new_old = torch.stack([ext2[rows, top - j] for j in range(la)],
                                  dim=1)
        else:
            lpc = lpc_now[rows, last1]
            new_old = state.old_lpc
    if cfg.lpc_gamma != 1.0:
        lpc = lpc_mod.lpc_weighting(lpc, cfg.lpc_gamma)
    new_state = FrameState(
        mem1, mem2, new_old,
        torch.clamp(state.frame_count + count.to(torch.int32), max=1000))
    return new_state, cond_a, cond_b, lpc


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


def excitation_pdf(dual_fc, gru_b_state: torch.Tensor, corr: torch.Tensor):
    """The full-PDF sampler's distribution [B, 256]: the bit tree's pdf
    raised to 1 + max(0, 1.5 corr - 0.5), renormalised, 0.002 cut from
    every entry (clipped at 0), renormalised."""
    from ..train.losses import tree_to_pdf
    pdf = tree_to_pdf(nn.mdense(dual_fc, gru_b_state))
    power = torch.clamp(1.5 * corr - 0.5, min=0.0)[..., None]
    pdf = pdf * torch.pow(torch.clamp(pdf, 1e-18, 1.0), power)
    pdf = pdf / (1e-18 + pdf.sum(-1, keepdim=True))
    pdf = torch.clamp(pdf - 0.002, min=0.0)
    return pdf / (1e-8 + pdf.sum(-1, keepdim=True))


def sample_excitation_pdf(dual_fc, gru_b_state: torch.Tensor, rng: Kiss99State,
                          corr: torch.Tensor):
    """Full-PDF sampling with a voicing temperature and a tail cut, the
    sampling of the reference's Python synthesis
    (training_tf2/test_lpcnet.py:107-114): pdf ~ p^(1 + max(0, 1.5 corr -
    0.5)), then p = max(p - 0.002, 0), renormalised, sampled by one KISS99
    draw's uniform.

    corr [B] is the pitch-correlation feature (features[..., 19]).
    Returns (exc [B] int32, new_rng).
    """
    pdf = excitation_pdf(dual_fc, gru_b_state, corr)
    r, rng = kiss99_step(rng)
    u = (r.to(torch.float32) + 0.5) / float(2 ** 32)
    cdf = torch.cumsum(pdf, dim=-1)
    exc = (cdf < u[..., None]).sum(-1)
    return torch.clamp(exc, 0, 255).to(torch.int32), rng


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
                        sig_u, pred_u, pdf_corr=None):
    """One sample step given the u-law codes of the last signal and of the
    prediction; float or q8 (nn.quantized.quantize_fused) params. `pdf_corr`
    [B] selects the full-PDF sampler (`sample_excitation_pdf`) in place of
    the C bit-tree sampler."""
    h_a, h_b = _gru_layers(fused, state, cond_a, cond_b, sig_u, pred_u)
    if pdf_corr is None:
        exc, rng = sample_excitation(fused["dual_fc"], h_b, state.rng)
    else:
        exc, rng = sample_excitation_pdf(fused["dual_fc"], h_b, state.rng,
                                         pdf_corr)
    return h_a, h_b, exc, rng


def synthesize_frame(fused, state: SampleState, cond_a, cond_b, lpc,
                     n_samples: int = 160, preload=None, pdf_corr=None):
    """One frame of audio for a batch of streams, step by step.

    preload: optional [B, n_samples] target waveform for teacher forcing
    (src/lpcnet.c:256-259): the excitation fed back comes from the target.
    pdf_corr: optional [B] pitch correlation; selects the full-PDF sampler
    with its voicing temperature and tail cut (`sample_excitation_pdf`).
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
            # sampler only has to advance the RNG by its draws (two for the
            # tree, one for the full-PDF sampler)
            h_a, h_b = _gru_layers(fused, st, cond_a, cond_b, sig_u, pred_u)
            rng = (draw_threshold_bytes(st.rng)[1] if pdf_corr is None
                   else kiss99_step(st.rng)[1])
            pcm = preload[..., t] - PREEMPHASIS * st.deemph
            exc = mulaw.lin2ulaw(pcm - pred)
        else:
            h_a, h_b, exc, rng = sample_network_step(
                fused, st, cond_a, cond_b, sig_u, pred_u, pdf_corr=pdf_corr)
            pcm = pred + mulaw.ulaw2lin(exc)
        sig = torch.cat([pcm[..., None], st.last_sig[..., :-1]], dim=-1)
        o = pcm + PREEMPHASIS * st.deemph
        st = SampleState(h_a, h_b, sig, exc, o, rng)
        out.append(torch.clamp(o, -32767.0, 32767.0))
    return st, torch.floor(0.5 + torch.stack(out, dim=-1))


def synthesize_frame_masked(fused, state: SampleState, cond_a, cond_b, lpc,
                            preload, preload_mask, advance_mask):
    """synthesize_frame with per-stream, per-sample control masks, step by
    step in plain float32 (or q8) arithmetic.

    preload [B, n] teacher waveform in the de-emphasised domain (read only
    where preload_mask); preload_mask [B, n] bool teacher-forces the sample
    (the C preload semantics, src/lpcnet.c:256-259); advance_mask [B, n]
    bool: where False the stream's state, its RNG included, is frozen and
    the output sample is 0, as if the stream had not been stepped.
    Returns (new_state, pcm [B, n]). The CUDA kernel of this function is
    `kernels.sample_loop.synthesize_frame_masked_kernel`.
    """
    st = state
    out = []
    preload = preload.to(torch.float32)
    preload_mask, advance_mask = preload_mask.bool(), advance_mask.bool()
    for t in range(preload.shape[-1]):
        tf, adv = preload_mask[..., t], advance_mask[..., t]
        pred = -(st.last_sig * lpc).sum(-1)
        sig_u = mulaw.lin2ulaw(st.last_sig[..., 0])
        pred_u = mulaw.lin2ulaw(pred)
        h_a, h_b, exc, rng = sample_network_step(fused, st, cond_a, cond_b,
                                                 sig_u, pred_u)
        pcm_tf = preload[..., t] - PREEMPHASIS * st.deemph
        exc = torch.where(tf, mulaw.lin2ulaw(pcm_tf - pred), exc)
        pcm = torch.where(tf, pcm_tf, pred + mulaw.ulaw2lin(exc))
        sig = torch.cat([pcm[..., None], st.last_sig[..., :-1]], dim=-1)
        o = pcm + PREEMPHASIS * st.deemph
        new = SampleState(h_a, h_b, sig, exc, o, rng)
        keep = lambda n, old: torch.where(
            adv.reshape(adv.shape + (1,) * (n.dim() - adv.dim())), n, old)
        st = SampleState(*(keep(n, old) for n, old in zip(new[:5], st[:5])),
                         Kiss99State(*(keep(n, old)
                                       for n, old in zip(rng, st.rng))))
        out.append(torch.where(adv, torch.clamp(o, -32767.0, 32767.0),
                               torch.zeros_like(o)))
    return st, torch.floor(0.5 + torch.stack(out, dim=-1))


# --------------------------------------------------------------------------
# Training graph (sequence form; training_tf2/lpcnet.py:234-313)
# --------------------------------------------------------------------------

class _FractionalLookup(torch.autograd.Function):
    """(1 - alpha) table[i0] + alpha table[i1] by two row gathers, and the
    table's gradient as the JAX package computes it: the soft one-hot rows
    [N, 256] (1 - alpha at i0, alpha at i1) times the output's gradient, a
    matrix product over row chunks summed in a fixed order. The card's
    `embedding` backward adds the ~10^6 duplicates of each row in an order
    that changes from run to run; this one gives the same bits every run."""

    CHUNK = 1 << 16

    @staticmethod
    def forward(ctx, table, i0, i1, alpha):
        ctx.save_for_backward(table, i0, i1, alpha)
        lo = torch.nn.functional.embedding(i0, table)
        hi = torch.nn.functional.embedding(i1, table)
        return (1.0 - alpha) * lo + alpha * hi

    @staticmethod
    def backward(ctx, grad):
        table, i0, i1, alpha = ctx.saved_tensors
        d_alpha = None
        if ctx.needs_input_grad[3]:
            d_alpha = (grad * (torch.nn.functional.embedding(i1, table)
                               - torch.nn.functional.embedding(i0, table))
                       ).sum(-1, keepdim=True)
        i0, i1, a = (t.reshape(-1, 1) for t in (i0, i1, alpha))
        grad = grad.reshape(-1, grad.shape[-1])
        d_table = grad.new_zeros(table.shape)
        for s in range(0, grad.shape[0], _FractionalLookup.CHUNK):
            c = slice(s, s + _FractionalLookup.CHUNK)
            w = grad.new_zeros(grad[c].shape[0], table.shape[0])
            w.scatter_add_(1, i0[c], 1.0 - a[c])
            w.scatter_add_(1, i1[c], a[c])
            d_table += w.T @ grad[c]
        return d_table, None, None, d_alpha


def diff_embed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fractional embedding lookup (training_tf2/diffembed.py:35-41): weight
    1-alpha on row trunc(x) and alpha on row trunc(x)+1, both clamped to
    0..255, with alpha = x - floor(x). With the input noise on, x goes below
    0, where floor and trunc differ; the index arithmetic is the JAX
    package's. Two row gathers and a lerp; the table's gradient is
    `_FractionalLookup`'s, the same every run on the card.
    """
    alpha = (x - torch.floor(x))[..., None]
    i0 = x.to(torch.int32).long()                  # trunc, like table[i0]
    return _FractionalLookup.apply(table, torch.clamp(i0, 0, 255),
                                   torch.clamp(i0 + 1, 0, 255), alpha)


def frame_network_seq(params, features, periods, cfg: LPCNetConfig):
    """Training-mode frame-rate net with 'valid' convs: features
    [B, Tf, 20], periods [B, Tf] int -> cfeat [B, Tf-4, cond]."""
    pembed = nn.embedding(params["embed_pitch"], torch.clamp(periods, 0, 255))
    x = torch.cat([features[..., :cfg.nb_used_features], pembed], dim=-1)
    x = nn.conv1d_seq(params["feature_conv1"], x, "tanh")
    x = nn.conv1d_seq(params["feature_conv2"], x, "tanh")
    x = nn.dense(params["feature_dense1"], x, "tanh")
    return nn.dense(params["feature_dense2"], x, "tanh")


def _train_gru_impl(device: torch.device, gru_impl: str = "auto"):
    """The GRU-sequence recurrence of the training graph: the CUDA kernel
    (`kernels/gru_train.py`, the CuDNNGRU role of training_tf2/lpcnet.py:32,
    bf16-operand products) on a card, the plain float32 `nn.gru_seq` on the
    CPU. `gru_impl` = "scan" asks for the plain float32 recurrence on any
    device, "kernel" for the kernel path's numerics on any device (on the
    CPU that is the kernel's plain version)."""
    if gru_impl not in ("auto", "scan", "kernel"):
        raise ValueError(f"unknown gru_impl {gru_impl}")
    if gru_impl == "scan" or (gru_impl == "auto" and device.type == "cpu"):
        return nn.gru_seq
    from ..kernels.gru_train import gru_seq_kernel
    return gru_seq_kernel


def _randn(shape, rng, device) -> torch.Tensor:
    """Standard normal draws from `rng` (a torch.Generator or a
    `utils.rng.ShardDraws`), made on the generator's device."""
    return draw(torch.randn, shape, rng, dtype=torch.float32).to(device)


def training_forward(params, cfg: LPCNetConfig, sig_in, features, periods,
                     lpc=None, rng: torch.Generator | None = None,
                     training: bool = True, gru_states=None,
                     noise_std: float = 0.3, exc_hist_override=None,
                     gru_impl: str = "auto"):
    """Full training graph.

    sig_in [B, T] linear signal input (the target delayed by one sample);
    features [B, Tf, 20] with Tf = T//160 + 4 (conv context); periods
    [B, Tf] int pitch indices; lpc [B, T//160, 16] (required unless
    cfg.e2e); rng a torch.Generator for the two Gaussian noise regularizers
    (training only; None = no noise); gru_states optional (h_a, h_b) for
    stateful truncated BPTT.

    Returns a dict with tree_probs [B, T, 256] (the bit-tree sigmoid
    outputs; `train.losses` reads the pdf off them), tensor_preds,
    real_preds, cfeat, rc and the new gru states.
    """
    from ..train import losses as LL

    b, t = sig_in.shape
    dev = sig_in.device
    cfeat = frame_network_seq(params, features, periods, cfg)
    if cfg.e2e:
        rc = cfeat[..., :LPC_ORDER]
        lpc = lpc_mod.rc2lpc(rc)
    else:
        rc = None
        if lpc is None:
            raise ValueError("training_forward: lpc is required unless cfg.e2e")

    weighting = torch.pow(
        torch.full((), cfg.lpc_gamma, dtype=torch.float32, device=dev),
        torch.arange(1, LPC_ORDER + 1, dtype=torch.float32, device=dev))
    real_preds = LL.diff_pred(sig_in, lpc, cfg.frame_size)
    tensor_preds = LL.diff_pred(sig_in, lpc * weighting, cfg.frame_size)
    if exc_hist_override is None:
        # roll wraps the last prediction round to position 0, as the
        # reference does
        past_errors = LL.tf_l2u(sig_in - torch.roll(tensor_preds, 1, dims=-1))
    else:
        # scheduled sampling's "hide-exc" arm: the caller supplies the
        # excitation-history channel (computed from the clean signal)
        past_errors = exc_hist_override

    cpcm = torch.stack([LL.tf_l2u(sig_in), LL.tf_l2u(tensor_preds),
                        past_errors], dim=-1)                   # [B, T, 3]
    noisy = training and rng is not None
    if noisy:
        cpcm = cpcm + noise_std * _randn(cpcm.shape, rng, dev)
    emb = diff_embed(params["embed_sig"]["table"], cpcm).reshape(
        b, t, 3 * EMBED_SIZE)

    rep = nn.repeat_frames(cfeat, cfg.frame_size)                 # [B, T, C]
    rnn_in = torch.cat([emb, rep], dim=-1)
    h_a0 = gru_states[0] if gru_states is not None else None
    h_b0 = gru_states[1] if gru_states is not None else None
    gru_seq = _train_gru_impl(dev, gru_impl)
    gru1, h_a = gru_seq(params["gru_a"], rnn_in, h0=h_a0)
    if noisy:
        gru1 = gru1 + 0.005 * _randn(gru1.shape, rng, dev)
    gru2, h_b = gru_seq(params["gru_b"], torch.cat([gru1, rep], dim=-1),
                        h0=h_b0)
    p = nn.mdense(params["dual_fc"], gru2, "sigmoid")
    return {"tree_probs": p, "tensor_preds": tensor_preds,
            "real_preds": real_preds, "cfeat": cfeat, "rc": rc,
            "gru_states": (h_a, h_b)}
