"""The PLC file driver, as lpcnet_demo -plc / -plc_file
(src/lpcnet_demo.c:220-249): 20 ms packets (2 frames), one loss flag per
packet from a pattern file or drawn with a given percentage."""

from __future__ import annotations

import numpy as np

from .. import api
from ..dsp.constants import FRAME_SIZE
from ..models import lpcnet as M
from .plc import (
    LPCNET_PLC_CAUSAL,
    LPCNET_PLC_DC_FILTER,
    LPCNET_PLC_NONCAUSAL,
    PLC,
)

_OPTION_MAP = {
    "causal": LPCNET_PLC_CAUSAL,
    "causal_dc": LPCNET_PLC_CAUSAL | LPCNET_PLC_DC_FILTER,
    "noncausal": LPCNET_PLC_NONCAUSAL,
    "noncausal_dc": LPCNET_PLC_NONCAUSAL | LPCNET_PLC_DC_FILTER,
}


def make_plc(options: str, model_path=None, batch: int = 1,
             plc_model_path=None, seed: int = 0, device=None) -> PLC:
    """A host PLC in mode `options` (a key of `_OPTION_MAP`). Without a
    model path the vocoder is a random init from numpy's RandomState(seed)
    (lookahead 0 for the non-causal modes) and the PLC net one from
    RandomState(seed + 1); a model path is a `.npz` checkpoint or a DNNw
    blob. Runs on CUDA unless `device="cpu"` is passed."""
    if options not in _OPTION_MAP:
        raise SystemExit(
            f"unknown plc mode '{options}'; choose from {sorted(_OPTION_MAP)}")
    flags = _OPTION_MAP[options]
    noncausal = bool(flags & LPCNET_PLC_NONCAUSAL)
    if model_path is None:
        cfg = M.LPCNetConfig(lookahead=0) if noncausal else M.LPCNetConfig()
        fused = M.fuse_inference_params(M.init_params(cfg, seed), cfg)
    else:
        fused, cfg = api.load_model(model_path, device="cpu")
        if noncausal and cfg.lookahead != 0:
            raise ValueError("non-causal PLC requires a lookahead-0 model")
    plc_params = api.load_plc_model(plc_model_path, seed=seed + 1,
                                    device="cpu")
    return PLC(fused, cfg, plc_params, options=flags, batch=batch,
               device=device)


def run_plc_stream(plc: PLC, pcm: np.ndarray, losses: np.ndarray) -> np.ndarray:
    """pcm [N*160], one stream; losses: one 0/1 flag per 20 ms (2 frames).

    Returns the concealed output [N*160]; the non-causal modes drop their
    first 80 samples and add an 80-sample tail, as the demo does."""
    n_frames = len(pcm) // FRAME_SIZE
    skip = 80 if plc.non_causal else 0
    out = []
    loss = 0
    for k in range(n_frames):
        frame = pcm[k * FRAME_SIZE:(k + 1) * FRAME_SIZE].astype(np.float32)[None]
        if k % 2 == 0:
            loss = int(losses[k // 2]) if (k // 2) < len(losses) else 0
        res = plc.conceal() if loss else plc.update(frame)
        out.append(res[0][skip:])
        skip = 0
    if plc.non_causal:
        out.append(plc.conceal()[0][:80])
    return np.concatenate(out)


def run_plc_fec_stream(plc: PLC, pcm: np.ndarray, losses: np.ndarray,
                       fec_packets) -> np.ndarray:
    """PLC with FEC redundancy: before packet k is concealed or decoded,
    its redundancy features are queued (lpcnet_plc_fec_add,
    src/lpcnet_plc.c:111-132), so that _get_fec_or_pred uses them in place
    of predictions.

    fec_packets: one [2, >=20] feature array per 20 ms packet. The queue is
    time-indexed (the read position advances one entry per received frame,
    src/lpcnet_plc.c:218-223), so every packet's features are queued as they
    become available; which later packet carries them over the wire is the
    transport's concern, as in the reference."""
    n_frames = len(pcm) // FRAME_SIZE
    out = []
    loss = 0
    for k in range(n_frames):
        frame = pcm[k * FRAME_SIZE:(k + 1) * FRAME_SIZE].astype(np.float32)[None]
        if k % 2 == 0:
            pkt = k // 2
            loss = int(losses[pkt]) if pkt < len(losses) else 0
            if fec_packets is not None and pkt < len(fec_packets):
                for row in np.asarray(fec_packets[pkt], np.float32):
                    plc.fec_add(row[None])
        res = plc.conceal() if loss else plc.update(frame)
        out.append(res[0])
    return np.concatenate(out)


def run_plc_file(options: str, percent_or_file: str, in_path: str,
                 out_path: str, model_path=None,
                 plc_model_path=api.DEMO_PLC_MODEL_PATH, device=None):
    """lpcnet_demo -plc: conceal a raw 16 kHz s16 file under a loss pattern
    and write the result as s16. The PLC net defaults to the shipped demo
    network, as the demo's built-in plc_data. The losses: one flag per
    packet drawn from RandomState(0) at a percentage, or a pattern file of
    0/1 flags."""
    pcm = np.fromfile(in_path, dtype=np.int16)
    try:
        percent = float(percent_or_file)
    except ValueError:
        losses = np.loadtxt(percent_or_file, dtype=np.int32).reshape(-1)
    else:
        n_packets = len(pcm) // (2 * FRAME_SIZE) + 1
        losses = (np.random.RandomState(0).rand(n_packets) < percent / 100.0
                  ).astype(np.int32)
    plc = make_plc(options, model_path=model_path,
                   plc_model_path=plc_model_path, device=device)
    out = run_plc_stream(plc, pcm, losses)
    out.astype(np.int16).tofile(out_path)
    n = len(pcm) // (2 * FRAME_SIZE)
    print(f"plc: {n} packets, {int(losses[:n].sum())} lost")
