"""Mapping between DNNw blob arrays and the vocoder's parameters.

The reference's export pipeline (training_tf2/dump_lpcnet.py) stores the
*inference-fused* arrays: embedding x GRU-A-kernel products, conditioning
submatrices, block-sparse quantized recurrent weights. As in the JAX
package's `weights/lpcnet_arrays.py`:

* ``fused_from_arrays``  : blob arrays -> fused inference params (the layout
  of `models.lpcnet.fuse_inference_params`), so the reference's model blobs
  (write_lpcnet_weights.c) load directly;
* ``arrays_from_params`` : training params -> blob arrays (with the SU-bias
  correction, dump_lpcnet.py:131-168), so models trained here load in the
  reference C runtime.

The arithmetic runs in numpy float32 on both sides, so the bytes written
are those of the JAX package's writer for the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.lpcnet import EMBED_SIZE, LPCNetConfig
from . import blob as B


def _f(arrays, name, shape=None):
    a = arrays[name].astype(np.float32)
    return a.reshape(shape) if shape is not None else a


def _matrix(arrays, name, rows, cols):
    """A dense matrix stored float or int8-dotp."""
    a = arrays[name]
    if a.dtype == np.int8:
        return B.decode_dotp_dense(a, rows, cols)
    return a.astype(np.float32).reshape(rows, cols)


def _sparse_matrix(arrays, name, rows, cols, diag_name=None):
    dense, _ = B.decode_sparse(arrays[name], arrays[name + "_idx"], rows, cols)
    if diag_name is not None and diag_name in arrays:
        diag = arrays[diag_name].astype(np.float32)  # [3N] for N=rows
        for k in range(cols // rows):
            dense[np.arange(rows), k * rows + np.arange(rows)] += \
                diag[k * rows:(k + 1) * rows]
    return dense


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def fused_from_arrays(arrays: Dict[str, np.ndarray], cfg: LPCNetConfig,
                      device="cpu") -> Dict[str, Any]:
    """Blob arrays -> fused inference params on `device` (cf.
    init_lpcnet_model, the generated nnet_data.c, src/lpcnet.c:202-210)."""
    na, nb, cond = cfg.rnn_units1, cfg.rnn_units2, cfg.cond_size
    fi = cfg.frame_input_size
    k = cfg.conv_kernel
    gru_b_bias = _f(arrays, "gru_b_bias", (2, 3 * nb))
    fused = {
        "embed_pitch": {"table": _f(arrays, "embed_pitch_weights",
                                    (256, cfg.pitch_embed_dim))},
        "feature_conv1": {"kernel": _f(arrays, "feature_conv1_weights", (k, fi, cond)),
                          "bias": _f(arrays, "feature_conv1_bias")},
        "feature_conv2": {"kernel": _f(arrays, "feature_conv2_weights", (k, cond, cond)),
                          "bias": _f(arrays, "feature_conv2_bias")},
        "feature_dense1": {"kernel": _f(arrays, "feature_dense1_weights", (cond, cond)),
                           "bias": _f(arrays, "feature_dense1_bias")},
        "feature_dense2": {"kernel": _f(arrays, "feature_dense2_weights", (cond, cond)),
                           "bias": _f(arrays, "feature_dense2_bias")},
        "embed_sig_a": _f(arrays, "gru_a_embed_sig_weights", (256, 3 * na)),
        "embed_pred_a": _f(arrays, "gru_a_embed_pred_weights", (256, 3 * na)),
        "embed_exc_a": _f(arrays, "gru_a_embed_exc_weights", (256, 3 * na)),
        "cond_to_a": {"kernel": _f(arrays, "gru_a_dense_feature_weights", (cond, 3 * na)),
                      "bias": _f(arrays, "gru_a_dense_feature_bias")},
        "cond_to_b": {"kernel": _f(arrays, "gru_b_dense_feature_weights", (cond, 3 * nb)),
                      "bias": gru_b_bias[0]},
        "gru_a_rec": {"recurrent": _sparse_matrix(
                          arrays, "sparse_gru_a_recurrent_weights", na, 3 * na,
                          diag_name="sparse_gru_a_recurrent_weights_diag"),
                      "bias": _f(arrays, "sparse_gru_a_bias", (2, 3 * na))},
        "gru_b_in": _sparse_matrix(arrays, "gru_b_weights", na, 3 * nb),
        "gru_b_rec": {"recurrent": _matrix(arrays, "gru_b_recurrent_weights", nb, 3 * nb),
                      "bias": gru_b_bias},
        "dual_fc": {"kernel": _f(arrays, "dual_fc_weights", (256, 2, nb)).transpose(2, 0, 1),
                    "bias": _f(arrays, "dual_fc_bias", (2, 256)).T,
                    "factor": _f(arrays, "dual_fc_factor", (2, 256)).T},
    }
    return _tensors(fused, device)


def load_lpcnet_blob(data: bytes, cfg: LPCNetConfig | None = None,
                     device="cpu") -> Dict[str, Any]:
    """A DNNw blob (write_lpcnet_weights.c, lpcnet_demo's weights_blob.bin)
    -> fused inference params on `device`."""
    return fused_from_arrays(B.read_blob(data), cfg or LPCNetConfig(), device)


def _np(x):
    """A tensor or an array -> numpy float32 (on the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def arrays_from_params(params: Dict[str, Any], cfg: LPCNetConfig,
                       quantize: bool = True) -> Dict[str, np.ndarray]:
    """Training params (tensors or arrays, in the JAX package's layout) ->
    blob arrays, as dump_lpcnet.py writes them.

    With quantize=True the GRU-A recurrent, GRU-B kernel and GRU-B recurrent
    are stored int8 (clipped to the int8 range here whatever training did).
    """
    na = cfg.rnn_units1
    e = _np(params["embed_sig"]["table"])
    ka = _np(params["gru_a"]["kernel"])
    out: Dict[str, np.ndarray] = {}

    def put_dense(name, kernel, bias):
        out[name + "_weights"] = _np(kernel).reshape(-1)
        out[name + "_bias"] = _np(bias).reshape(-1)

    out["gru_a_embed_sig_weights"] = (e @ ka[:EMBED_SIZE]).reshape(-1)
    out["gru_a_embed_pred_weights"] = (e @ ka[EMBED_SIZE:2 * EMBED_SIZE]).reshape(-1)
    out["gru_a_embed_exc_weights"] = (e @ ka[2 * EMBED_SIZE:3 * EMBED_SIZE]).reshape(-1)
    bias_a = _np(params["gru_a"]["bias"])
    put_dense("gru_a_dense_feature", ka[3 * EMBED_SIZE:], bias_a[0])

    kb = _np(params["gru_b"]["kernel"])
    bias_b = _np(params["gru_b"]["bias"])
    put_dense("gru_b_dense_feature", kb[na:], 0 * bias_b[0])

    # GRU-B: sparse input part, dotp recurrent, subias
    kb_in = kb[:na]
    w_sp, idx = B.encode_sparse(kb_in, quantize=quantize)
    out["gru_b_weights"] = w_sp
    out["gru_b_weights_idx"] = idx
    rb = _np(params["gru_b"]["recurrent"])
    out["gru_b_recurrent_weights"] = (B.encode_dotp_dense(rb) if quantize
                                      else rb.reshape(-1))
    q_in = np.clip(np.round(kb_in * 128), -128, 127)
    q_rec = np.clip(np.round(rb * 128), -128, 127)
    subias_b = bias_b.copy()
    subias_b[0] -= np.sum(q_in / 128.0, axis=0)
    subias_b[1] -= np.sum(q_rec / 128.0, axis=0)
    out["gru_b_bias"] = bias_b.reshape(-1)
    out["gru_b_subias"] = subias_b.reshape(-1)

    # frame net, embeddings, dual FC
    for name in ("feature_conv1", "feature_conv2", "feature_dense1",
                 "feature_dense2"):
        put_dense(name, params[name]["kernel"], params[name]["bias"])
    out["embed_pitch_weights"] = _np(params["embed_pitch"]["table"]).reshape(-1)
    dk = _np(params["dual_fc"]["kernel"])            # [in, 256, 2]
    out["dual_fc_weights"] = dk.transpose(1, 2, 0).reshape(-1)
    out["dual_fc_bias"] = _np(params["dual_fc"]["bias"]).T.reshape(-1)
    out["dual_fc_factor"] = _np(params["dual_fc"]["factor"]).T.reshape(-1)

    # sparse GRU-A recurrent: the diagonal apart, blocks encoded, subias
    ra = _np(params["gru_a"]["recurrent"])           # [N, 3N]
    diag = np.concatenate([np.diag(ra[:, k * na:(k + 1) * na]) for k in range(3)])
    ra_nd = ra.copy()
    for k in range(3):
        ra_nd[np.arange(na), k * na + np.arange(na)] = 0.0
    w_sp, idx = B.encode_sparse(ra_nd, quantize=quantize)
    out["sparse_gru_a_recurrent_weights_diag"] = diag.astype(np.float32)
    out["sparse_gru_a_recurrent_weights"] = w_sp
    out["sparse_gru_a_recurrent_weights_idx"] = idx
    q_ra = np.clip(np.round(ra_nd * 128), -128, 127)
    subias_a = bias_a.copy()
    subias_a[1] -= np.sum(q_ra / 128.0, axis=0)
    out["sparse_gru_a_bias"] = bias_a.reshape(-1)
    out["sparse_gru_a_subias"] = subias_a.reshape(-1)
    return out


def save_lpcnet_blob(params: Dict[str, Any], cfg: LPCNetConfig,
                     quantize: bool = True) -> bytes:
    return B.write_blob(arrays_from_params(params, cfg, quantize))
