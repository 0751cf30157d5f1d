"""The plain reference of configuration lpcnet-plc-256: one causal
concealment tick with blending (the analysis, the PLC net, the frame
network, the drain of queued audio, the step-by-step sample loop in the
vocoder's int8 numerics and the cross-fade) for a batch of streams, each
with its own loss flag.

Built on `frozen/` (`frozen/plc/batched.py::plc_frame_step`). It takes from
the benchmark the raw float32 weights and the inputs, and derives the
vocoder's fused and quantized forms itself.
"""

from __future__ import annotations

import torch

from . import lpcnet_384_16 as V
from .frozen.models import plc as PM
from .frozen.plc import batched as BP

served_weights = V.served_weights
model_config = V.model_config


def plc_config(p: dict) -> PM.PLCConfig:
    return PM.PLCConfig(dense1_size=p["dense1_size"], gru1_size=p["gru1_size"],
                        gru2_size=p["gru2_size"], nb_features=p["nb_features"])


FEC_Q = 100     # the pool's FEC queue length (BatchedPLC's default)


def init_state(batch: int, cfg, pcfg, device) -> BP.BatchedPLCState:
    return BP.init_state(batch, cfg, pcfg, FEC_Q, device)


def batch_axis(path: str) -> int:
    """The stream axis of a state leaf: the ring of past PLC-net states is
    [R, B, H]; every other leaf leads with the stream."""
    return 1 if path.startswith("/plc_ring") else 0


@torch.no_grad()
def plc_tick(fused, cfg, plc_params, state, pcm, lost):
    """pcm [B, 160] float, lost [B] bool (tensors on the state's device) ->
    (new state, output [B, 160] float)."""
    return BP.plc_frame_step(state, fused, plc_params, pcm, lost, cfg)
