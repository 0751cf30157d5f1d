"""RDO-VAE checkpoint interchange with the reference's torch training stack.

The reference trains DRED's RDO-VAE in torch (torch/rdovae/rdovae/rdovae.py)
and moves weights through its `wexchange` package
(torch/rdovae/import_rdovae_weights.py:55-81 maps wexchange layer names onto
`core_encoder.module.*` / `core_decoder.module.*` state-dict entries;
export_rdovae_weights.py:55-110 is the reverse). This module converts a
reference checkpoint's state dict to this package's params (and back), as
the JAX package's `weights/rdovae_import.py` does for its own.

Layout conversions (reference -> params):
  nn.Linear   weight [out, in]            -> kernel [in, out] (transpose)
  nn.GRU      weight_ih_l0 [3H, in] in    -> kernel [in, 3H] with gate
              torch gate order (r, z, n)     order (z, r, n); recurrent and
                                             both biases likewise. Both are
              reset-after with the same role for z (torch: h' = (1-z) n +
              z h; nn.layers.gru_step: h' = z h + (1-z) hcand), so the
              reorder is exact.
  nn.Conv1d   weight [out, in, k]         -> kernel [k, in, out]
  nn.Embedding weight                     -> table (unchanged)
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.rdovae import RDOVAEConfig
from .convert import params_to_torch

# reference module path (without the DataParallel '.module.' infix) ->
# (params path, layer kind)
_LAYERS = {
    "core_encoder.dense_1": (("encoder", "dense_1"), "dense"),
    "core_encoder.dense_2": (("encoder", "dense_2"), "dense"),
    "core_encoder.dense_3": (("encoder", "dense_3"), "dense"),
    "core_encoder.dense_4": (("encoder", "dense_4"), "dense"),
    "core_encoder.dense_5": (("encoder", "dense_5"), "dense"),
    "core_encoder.gru_1": (("encoder", "gru_1"), "gru"),
    "core_encoder.gru_2": (("encoder", "gru_2"), "gru"),
    "core_encoder.gru_3": (("encoder", "gru_3"), "gru"),
    "core_encoder.conv1": (("encoder", "conv1"), "conv1d"),
    "core_encoder.state_dense_1": (("encoder", "state_dense_1"), "dense"),
    "core_encoder.state_dense_2": (("encoder", "state_dense_2"), "dense"),
    "core_decoder.dense_1": (("decoder", "dense_1"), "dense"),
    "core_decoder.dense_2": (("decoder", "dense_2"), "dense"),
    "core_decoder.dense_3": (("decoder", "dense_3"), "dense"),
    "core_decoder.dense_4": (("decoder", "dense_4"), "dense"),
    "core_decoder.dense_5": (("decoder", "dense_5"), "dense"),
    "core_decoder.output": (("decoder", "output"), "dense"),
    "core_decoder.gru_1": (("decoder", "gru_1"), "gru"),
    "core_decoder.gru_2": (("decoder", "gru_2"), "gru"),
    "core_decoder.gru_3": (("decoder", "gru_3"), "gru"),
    "core_decoder.gru_1_init": (("decoder", "gru_1_init"), "dense"),
    "core_decoder.gru_2_init": (("decoder", "gru_2_init"), "dense"),
    "core_decoder.gru_3_init": (("decoder", "gru_3_init"), "dense"),
    "statistical_model.quant_embedding":
        (("statistical_model", "quant_embedding"), "embedding"),
}


def _np(x) -> np.ndarray:
    """A tensor or an array -> float32 numpy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _reorder_rzn_to_zrn(w3: np.ndarray) -> np.ndarray:
    """Reorder the leading 3H gate axis from torch (r, z, n) to (z, r, n);
    swapping the first two blocks is its own inverse."""
    h = w3.shape[0] // 3
    return np.concatenate([w3[h:2 * h], w3[:h], w3[2 * h:]], axis=0)


def _strip(name: str) -> str:
    return name.replace(".module.", ".")


def params_from_torch_state_dict(state_dict: Dict[str, Any], device="cpu"
                                 ) -> Dict[str, Any]:
    """A reference RDOVAE state dict (tensors or arrays; the DataParallel
    '.module.' infix optional) -> the RDO-VAE's params on `device`."""
    sd = {_strip(k): v for k, v in state_dict.items()}
    out: Dict[str, Any] = {"encoder": {}, "decoder": {},
                           "statistical_model": {}}
    for tname, ((group, leaf), kind) in _LAYERS.items():
        if kind == "dense":
            out[group][leaf] = {"kernel": _np(sd[tname + ".weight"]).T,
                                "bias": _np(sd[tname + ".bias"])}
        elif kind == "gru":
            w = {k: _reorder_rzn_to_zrn(_np(sd[f"{tname}.{k}_l0"]))
                 for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            out[group][leaf] = {"kernel": w["weight_ih"].T,
                                "recurrent": w["weight_hh"].T,
                                "bias": np.stack([w["bias_ih"], w["bias_hh"]])}
        elif kind == "conv1d":
            out[group][leaf] = {
                "kernel": np.transpose(_np(sd[tname + ".weight"]), (2, 1, 0)),
                "bias": _np(sd[tname + ".bias"])}
        else:
            out[group][leaf] = {"table": _np(sd[tname + ".weight"])}
    return params_to_torch(out, device, torch.float32)


def _with_module_infix(name: str) -> str:
    """Reference checkpoints wrap the cores in nn.DataParallel
    (torch rdovae.py:449-450), so their state-dict keys carry '.module.'."""
    for core in ("core_encoder.", "core_decoder."):
        if name.startswith(core):
            return core + "module." + name[len(core):]
    return name


def state_dict_from_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The RDO-VAE's params -> a reference-shaped state dict of float32
    host tensors with '.module.'-infixed keys, which the reference RDOVAE
    loads directly. The exact inverse of params_from_torch_state_dict."""
    sd: Dict[str, np.ndarray] = {}
    for raw, ((group, leaf), kind) in _LAYERS.items():
        tname = _with_module_infix(raw)
        p = {k: _np(v) for k, v in params[group][leaf].items()}
        if kind == "dense":
            sd[tname + ".weight"] = p["kernel"].T
            sd[tname + ".bias"] = p["bias"]
        elif kind == "gru":
            sd[tname + ".weight_ih_l0"] = _reorder_rzn_to_zrn(p["kernel"].T)
            sd[tname + ".weight_hh_l0"] = _reorder_rzn_to_zrn(p["recurrent"].T)
            sd[tname + ".bias_ih_l0"] = _reorder_rzn_to_zrn(p["bias"][0])
            sd[tname + ".bias_hh_l0"] = _reorder_rzn_to_zrn(p["bias"][1])
        elif kind == "conv1d":
            sd[tname + ".weight"] = np.transpose(p["kernel"], (2, 1, 0))
            sd[tname + ".bias"] = p["bias"]
        else:
            sd[tname + ".weight"] = p["table"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def config_from_model_args(model_args, model_kwargs=None) -> RDOVAEConfig:
    """The reference checkpoint stores (num_features, latent_dim,
    quant_levels, cond_size, cond_size2) + {'state_dim': ...}
    (import_rdovae_weights.py:96-98)."""
    nf, ld, ql, c, c2 = model_args
    kw = dict(model_kwargs or {})
    return RDOVAEConfig(num_features=nf, latent_dim=ld, quant_levels=ql,
                        cond_size=c, cond_size2=c2,
                        state_dim=kw.get("state_dim", 24))


def load_torch_checkpoint(path: str, device="cpu"
                          ) -> Tuple[Dict[str, Any], RDOVAEConfig]:
    """A reference RDO-VAE checkpoint (.pth) -> (params on `device`, cfg):
    a full training checkpoint ({'state_dict', 'model_args',
    'model_kwargs'}) or a bare state dict (default architecture)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        cfg = config_from_model_args(ckpt.get("model_args",
                                              (20, 80, 40, 256, 256)),
                                     ckpt.get("model_kwargs"))
        sd = ckpt["state_dict"]
    else:
        cfg = RDOVAEConfig(quant_levels=40)
        sd = ckpt
    return params_from_torch_state_dict(sd, device), cfg
