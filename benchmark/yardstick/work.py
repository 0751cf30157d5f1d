"""The least device time of the model arithmetic a tick or a step needs,
for the `mfu` metrics.

Each multiply-add counts as two operations, in the precision the
configuration states for its matrix (`configs/*.json`, "numerics"), against
that precision's published peak (`peaks.PEAK`). Only the work the inputs
need is counted: elementwise gate arithmetic, DSP analysis and the
sampler's comparisons are left out, so each count is a lower bound and the
share it gives can only read low.
"""

from __future__ import annotations

from .bounds import gru_step_macs
from .peaks import PEAK

PCM_LEVELS = 256
EMBED_SIZE = 128


def frame_net_macs(c: dict) -> int:
    """One streaming frame-network step of one stream: the two convolutions
    (20 features and the 64-wide pitch embedding in), the two dense layers,
    and the conditioning products for GRU-A and GRU-B."""
    k, cond = c["conv_kernel"], c["cond_size"]
    fin = c["nb_used_features"] + c["pitch_embed_dim"]
    return (k * fin * cond + k * cond * cond + 2 * cond * cond
            + cond * 3 * c["rnn_units1"] + cond * 3 * c["rnn_units2"])


def sample_step_seconds(c: dict, gru_type: str) -> float:
    """Least time of one sample step of one stream: the GRU products in the
    GRU type; GRU-A's float diagonal (int8 only) and the DualFC in float32."""
    na, nb = c["rnn_units1"], c["rnn_units2"]
    f32_macs = nb * 2 * PCM_LEVELS + (3 * na if gru_type == "int8" else 0)
    return (2 * gru_step_macs(na, nb) / PEAK[gru_type]
            + 2 * f32_macs / PEAK["f32"])


def frame_net_seconds(c: dict) -> float:
    return 2 * frame_net_macs(c) / PEAK["f32"]


def decode_tick_seconds(c: dict, gru_type: str, streams: int) -> float:
    """A 40 ms packet tick: four frames of the frame network and of the
    160-step sample loop for every stream."""
    n = c["frame_size"]
    return 4 * streams * (frame_net_seconds(c) + n * sample_step_seconds(c, gru_type))


def plc_net_macs(p: dict) -> int:
    """One step of the PLC feature-prediction net of one stream."""
    nin, d, g1, g2, nout = (p["plc_input_size"], p["dense1_size"],
                            p["gru1_size"], p["gru2_size"], p["nb_features"])
    return (nin * d + 3 * (d * g1 + g1 * g1) + 3 * (g1 * g2 + g2 * g2)
            + g2 * nout)


def plc_window_seconds(c: dict, p: dict, gru_type: str, streams: int,
                       ticks: int, active: int) -> float:
    """`ticks` 10 ms concealment ticks: the PLC net once a tick for every
    stream; and for each of the `active` (stream, tick) pairs that are lost
    or blend back after a loss, one frame network and a frame of samples
    (a lost frame's 160; a blend's 80 of continuation and 80
    resynchronised). The drain of queued audio and the deferred frame
    networks at a loss's onset are left out."""
    plc = 2 * plc_net_macs(p) / PEAK["f32"]
    per_active = frame_net_seconds(c) + c["frame_size"] * sample_step_seconds(c, gru_type)
    return ticks * streams * plc + active * per_active


def train_step_seconds(c: dict, batch: int, chunk_frames: int) -> float:
    """One training step, forward and backward (each product's backward
    twice its forward: the gradients of its input and of its weights). The
    GRUs' input and recurrent products in bf16 operands; the DualFC and
    the frame network in float32. The frame network counts its
    `chunk_frames` outputs only."""
    na, nb, cond = c["rnn_units1"], c["rnn_units2"], c["cond_size"]
    rows = batch * chunk_frames * c["frame_size"]
    a_in = 3 * EMBED_SIZE + cond
    bf16_macs = a_in * 3 * na + na * 3 * na + (na + cond) * 3 * nb + nb * 3 * nb
    f32_macs = nb * 2 * PCM_LEVELS
    k = c["conv_kernel"]
    fin = c["nb_used_features"] + c["pitch_embed_dim"]
    frame_macs = k * fin * cond + k * cond * cond + 2 * cond * cond
    return 3 * (2 * rows * bf16_macs / PEAK["bf16"]
                + 2 * rows * f32_macs / PEAK["f32"]
                + 2 * batch * chunk_frames * frame_macs / PEAK["f32"])
