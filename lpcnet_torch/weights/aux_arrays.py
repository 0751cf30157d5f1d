"""Blob array mappings for the PLC feature-prediction network and DRED's
RDO-VAE.

Array names match the reference's generated data files, so models trained
here load in the C runtime and the reference's blobs load here:
* PLC:  plc_dense1, plc_gru1, plc_gru2, plc_out (training_tf2/dump_plc.py);
* DRED: enc_dense1..8, bits_dense, gdense1/2; dec_dense1..8, dec_final,
  state1..3 (src/dred_rdovae_enc.c:52-93, src/dred_rdovae_dec.c:44-97,
  training_tf2/dump_rdovae.py:129-151, 225-246).
GRU layers use the blob's sparse-kernel and dotp-recurrent encodings
(as GRU-B in the vocoder); the gate order is z, r, h throughout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.plc import PLC_INPUT_SIZE, PLCConfig
from ..models.rdovae import RDOVAEConfig
from . import blob as B
from .lpcnet_arrays import _np, _tensors


def _put_dense(out, name, p):
    out[name + "_weights"] = _np(p["kernel"]).reshape(-1)
    out[name + "_bias"] = _np(p["bias"]).reshape(-1)


# a conv kernel [k, in, out] is stored flat, as a dense one
_put_conv = _put_dense


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


def _get_conv(arrays, name, k, n_in, n_out):
    kernel = arrays[name + "_weights"].astype(np.float32)
    return {"kernel": kernel.reshape(k, n_in, n_out),
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


# -- DRED ---------------------------------------------------------------------

_ENC_DENSE = [("enc_dense1", "dense_1"), ("enc_dense3", "dense_2"),
              ("enc_dense5", "dense_3"), ("enc_dense7", "dense_4"),
              ("enc_dense8", "dense_5"), ("gdense1", "state_dense_1"),
              ("gdense2", "state_dense_2")]
_ENC_GRU = [("enc_dense2", "gru_1"), ("enc_dense4", "gru_2"),
            ("enc_dense6", "gru_3")]
_DEC_DENSE = [("dec_dense1", "dense_1"), ("dec_dense3", "dense_2"),
              ("dec_dense5", "dense_3"), ("dec_dense7", "dense_4"),
              ("dec_dense8", "dense_5"), ("dec_final", "output"),
              ("state1", "gru_1_init"), ("state2", "gru_2_init"),
              ("state3", "gru_3_init")]
_DEC_GRU = [("dec_dense2", "gru_1"), ("dec_dense4", "gru_2"),
            ("dec_dense6", "gru_3")]


def rdovae_arrays_from_params(params, quantize: bool = True) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    enc, dec = params["encoder"], params["decoder"]
    for cname, pname in _ENC_DENSE:
        _put_dense(out, cname, enc[pname])
    for cname, pname in _ENC_GRU:
        _put_gru(out, cname, enc[pname], quantize)
    _put_conv(out, "bits_dense", enc["conv1"])
    for cname, pname in _DEC_DENSE:
        _put_dense(out, cname, dec[pname])
    for cname, pname in _DEC_GRU:
        _put_gru(out, cname, dec[pname], quantize)
    out["quant_embedding"] = _np(
        params["statistical_model"]["quant_embedding"]["table"]).reshape(-1)
    return out


def rdovae_params_from_arrays(arrays, cfg: RDOVAEConfig | None = None,
                              device="cpu"):
    """Blob arrays -> the RDO-VAE's params (`models.rdovae`) on `device`."""
    cfg = cfg or RDOVAEConfig()
    c, c2 = cfg.cond_size, cfg.cond_size2
    enc_dims = {"dense_1": (cfg.enc_input_dim, c2), "dense_2": (c, c2),
                "dense_3": (c, c2), "dense_4": (c, c), "dense_5": (c, c),
                "state_dense_1": (cfg.enc_concat_size, cfg.state_hidden),
                "state_dense_2": (cfg.state_hidden, cfg.state_dim)}
    dec_dims = {"dense_1": (cfg.latent_dim, c2), "dense_2": (c, c2),
                "dense_3": (c, c2), "dense_4": (c, c2), "dense_5": (c2, c2),
                "output": (cfg.dec_concat_size,
                           cfg.dec_frames_per_step * cfg.num_features),
                "gru_1_init": (cfg.state_dim, c), "gru_2_init": (cfg.state_dim, c),
                "gru_3_init": (cfg.state_dim, c)}
    enc = {pname: _get_dense(arrays, cname, *enc_dims[pname])
           for cname, pname in _ENC_DENSE}
    enc.update({pname: _get_gru(arrays, cname, c2, c) for cname, pname in _ENC_GRU})
    enc["conv1"] = _get_conv(arrays, "bits_dense", cfg.conv_kernel,
                             cfg.enc_concat_size, cfg.latent_dim)
    dec = {pname: _get_dense(arrays, cname, *dec_dims[pname])
           for cname, pname in _DEC_DENSE}
    dec.update({pname: _get_gru(arrays, cname, c2, c) for cname, pname in _DEC_GRU})
    stats = {"quant_embedding": {"table": arrays["quant_embedding"].astype(
        np.float32).reshape(cfg.quant_levels, 6 * cfg.latent_dim)}}
    return _tensors({"encoder": enc, "decoder": dec, "statistical_model": stats},
                    device)


def save_rdovae_blob(params, quantize: bool = True) -> bytes:
    return B.write_blob(rdovae_arrays_from_params(params, quantize))


def load_rdovae_blob(data: bytes, cfg: RDOVAEConfig | None = None, device="cpu"):
    return rdovae_params_from_arrays(B.read_blob(data), cfg, device)
