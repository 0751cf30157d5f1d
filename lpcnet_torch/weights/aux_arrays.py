"""Blob array mappings for the PLC feature-prediction network.

Array names match the reference's generated data files
(training_tf2/dump_plc.py: plc_dense1, plc_gru1, plc_gru2, plc_out), so a
PLC model trained here loads in the C runtime and the reference's blobs load
here. GRU layers use the blob's sparse-kernel and dotp-recurrent encodings
(as GRU-B in the vocoder); the gate order is z, r, h throughout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.plc import PLC_INPUT_SIZE, PLCConfig
from . import blob as B
from .lpcnet_arrays import _np, _tensors


def _put_dense(out, name, p):
    out[name + "_weights"] = _np(p["kernel"]).reshape(-1)
    out[name + "_bias"] = _np(p["bias"]).reshape(-1)


def _put_gru(out, name, p, quantize: bool):
    kernel = _np(p["kernel"])
    rec = _np(p["recurrent"])
    bias = _np(p["bias"])
    w_sp, idx = B.encode_sparse(kernel, quantize=quantize)
    out[name + "_weights"] = w_sp
    out[name + "_weights_idx"] = idx
    out[name + "_recurrent_weights"] = (B.encode_dotp_dense(rec) if quantize
                                        else rec.reshape(-1))
    q_in = np.clip(np.round(kernel * 128), -128, 127)
    q_rec = np.clip(np.round(rec * 128), -128, 127)
    subias = bias.copy()
    subias[0] -= np.sum(q_in / 128.0, axis=0)
    subias[1] -= np.sum(q_rec / 128.0, axis=0)
    out[name + "_bias"] = bias.reshape(-1)
    out[name + "_subias"] = subias.reshape(-1)


def _get_dense(arrays, name, n_in, n_out):
    return {"kernel": arrays[name + "_weights"].astype(np.float32).reshape(n_in, n_out),
            "bias": arrays[name + "_bias"].astype(np.float32)}


def _get_gru(arrays, name, n_in, n_units):
    kernel, _ = B.decode_sparse(arrays[name + "_weights"],
                                arrays[name + "_weights_idx"], n_in, 3 * n_units)
    rec_raw = arrays[name + "_recurrent_weights"]
    if rec_raw.dtype == np.int8:
        rec = B.decode_dotp_dense(rec_raw, n_units, 3 * n_units)
    else:
        rec = rec_raw.astype(np.float32).reshape(n_units, 3 * n_units)
    return {"kernel": kernel, "recurrent": rec,
            "bias": arrays[name + "_bias"].astype(np.float32).reshape(2, 3 * n_units)}


def plc_arrays_from_params(params, quantize: bool = True) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _put_dense(out, "plc_dense1", params["plc_dense1"])
    _put_gru(out, "plc_gru1", params["plc_gru1"], quantize)
    _put_gru(out, "plc_gru2", params["plc_gru2"], quantize)
    _put_dense(out, "plc_out", params["plc_out"])
    return out


def plc_params_from_arrays(arrays, cfg: PLCConfig | None = None, device="cpu"):
    """Blob arrays -> the PLC net's params (`models.plc`) on `device`."""
    cfg = cfg or PLCConfig()
    return _tensors({
        "plc_dense1": _get_dense(arrays, "plc_dense1", PLC_INPUT_SIZE, cfg.dense1_size),
        "plc_gru1": _get_gru(arrays, "plc_gru1", cfg.dense1_size, cfg.gru1_size),
        "plc_gru2": _get_gru(arrays, "plc_gru2", cfg.gru1_size, cfg.gru2_size),
        "plc_out": _get_dense(arrays, "plc_out", cfg.gru2_size, cfg.nb_features),
    }, device)


def save_plc_blob(params, quantize: bool = True) -> bytes:
    return B.write_blob(plc_arrays_from_params(params, quantize))


def load_plc_blob(data: bytes, cfg: PLCConfig | None = None, device="cpu"):
    return plc_params_from_arrays(B.read_blob(data), cfg, device)
