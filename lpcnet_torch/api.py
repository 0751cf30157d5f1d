"""Public API: model loading, the batched vocoder, the 1.6 kb/s codec and
the serving pools, with the C API's shape where the reference has one
(include/lpcnet.h).

    fused, cfg = load_model("model.npz", int8=True)       # on the GPU
    synth = Synthesizer(fused=fused, cfg=cfg, batch=256)
    pcm = synth.synthesize(features)                      # [256, 160] int16

    enc = lpcnet_encoder_create(batch=256)
    pkts = lpcnet_encode(enc, pcm640)                     # [256, 8] uint8
    pool = StreamPool(fused, cfg, capacity=1024)          # packet decode
    out = pool.step_packets({"call-3": pkt, ...})         # [640] int16 each

    plc_params = load_plc_model(DEMO_PLC_MODEL_PATH)      # the PLC network
    pool = PLCStreamPool(fused, cfg, plc_params, capacity=256)
    out = pool.step({"caller-7": frame, "caller-9": None})   # None: lost

    rdovae, rcfg = load_rdovae_model(DEMO_RDOVAE_MODEL_PATH)  # DRED
    dred = DREDEncoder(rdovae, rcfg, batch=256)   # dred.add_feature_frame(f)
    red = dred.produce_payload(52)["payloads"]    # 256 byte strings
    feats = DREDDecoder(rdovae, rcfg).decode_payload(red[0])

Everything runs on CUDA unless `device="cpu"` is passed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

import torch

from .codec.decoder import LPCNetDecoder
from .codec.encoder import LPCNetEncoder
from .dred.coder import DREDDecoder, DREDEncoder  # noqa: F401 (public)
from .dsp.constants import NB_BANDS, NB_TOTAL_FEATURES
from .dsp.lpc import lpc_from_cepstrum
from .models import lpcnet as M
from .models import rdovae as RV
from .nn.quantized import quantize_fused
from .runtime.serving import PLCStreamPool, StreamPool  # noqa: F401 (public)
from .utils.device import resolve_device
from .weights.aux_arrays import load_plc_blob, load_rdovae_blob
from .weights.checkpoint import load_checkpoint
from .weights.convert import params_to_torch
from .weights.lpcnet_arrays import load_lpcnet_blob

# the shipped demo vocoder, read by path from the JAX package's data folder
DEMO_MODEL_PATH = str(Path(__file__).resolve().parent.parent / "lpcnet_tpu"
                      / "data" / "demo_model.npz")
DEMO_PLC_MODEL_PATH = str(Path(DEMO_MODEL_PATH).parent / "demo_plc_model.npz")
DEMO_RDOVAE_MODEL_PATH = str(Path(DEMO_MODEL_PATH).parent
                             / "demo_rdovae_model.npz")


def load_model(path: Optional[str] = None, seed: int = 0, int8: bool = False,
               device=None):
    """Load fused inference params: a `.npz` checkpoint, a DNNw weight blob
    (any other path, e.g. the reference's `weights_blob.bin`, read at
    `LPCNetConfig()`), or (path=None) a random init from numpy's
    RandomState(seed). That init cannot reproduce
    the JAX package's `jax.random` weights for the same seed; to compare the
    two packages, carry JAX weights across with `weights.convert`.

    int8=True converts GRU-A's off-diagonal recurrent and GRU-B's matrices
    to int8 (the reference's DOT_PROD numerics); the kernel then runs its q8
    form. Returns (fused params on `device`, cfg).
    """
    dev = resolve_device(device)
    if path is None:
        cfg = M.LPCNetConfig()
        fused = M.fuse_inference_params(M.init_params(cfg, seed, dev), cfg)
    elif path.endswith(".npz"):
        params, cfg = load_checkpoint(path, dev)
        fused = M.fuse_inference_params(params, cfg)
    else:
        cfg = M.LPCNetConfig()
        with open(path, "rb") as f:
            fused = load_lpcnet_blob(f.read(), cfg, dev)
    if int8:
        fused = quantize_fused(fused)
    return fused, cfg


def load_plc_model(path: Optional[str] = None, seed: int = 0, device=None):
    """The PLC feature-prediction network's params (`models.plc`) on
    `device`: a `.npz` checkpoint, a DNNw weight blob (any other path), or
    (path=None) a random init from numpy's RandomState(seed)."""
    from .models import plc as PM
    dev = resolve_device(device)
    if path is None:
        return PM.init_params(seed, device=dev)
    if not path.endswith(".npz"):
        with open(path, "rb") as f:
            return load_plc_blob(f.read(), device=dev)
    params, _ = load_checkpoint(path, dev)
    return params


def load_rdovae_model(path: Optional[str] = None, seed: int = 0,
                      cfg: Optional[RV.RDOVAEConfig] = None, device=None):
    """DRED's RDO-VAE: (params on `device`, RDOVAEConfig) from a `.npz`
    checkpoint (its leaves cast to float32: the demo model stores float16;
    the config from its `__config__`, else `cfg` or the default), a DNNw
    weight blob (any other path, read at `cfg`), or (path=None) a random
    init from numpy's RandomState(seed)."""
    dev = resolve_device(device)
    if path is not None and path.endswith(".npz"):
        with np.load(path) as d:
            raw = d["__config__"].tobytes().decode() if "__config__" in d else "{}"
            flat = {k: d[k] for k in d.files if k != "__config__"}
        cfg_dict = json.loads(raw)
        cfg = RV.RDOVAEConfig(**cfg_dict) if cfg_dict else (cfg or RV.RDOVAEConfig())
        return params_to_torch(flat, dev, torch.float32), cfg
    cfg = cfg or RV.RDOVAEConfig()
    if path is None:
        return RV.init_params(cfg, seed, dev), cfg
    with open(path, "rb") as f:
        return load_rdovae_blob(f.read(), cfg, dev), cfg


class Synthesizer:
    """Batched vocoder: one feature frame per stream in, PCM out."""

    def __init__(self, model_path: Optional[str] = None, batch: int = 1,
                 fused=None, cfg: Optional[M.LPCNetConfig] = None,
                 device=None):
        dev = resolve_device(device)
        if fused is None:
            fused, cfg = load_model(model_path, device=dev)
        self.cfg = cfg or M.LPCNetConfig()
        self.batch = batch
        self._dec = LPCNetDecoder.from_fused(fused, self.cfg, batch,
                                             device=dev)

    def synthesize(self, features: np.ndarray) -> np.ndarray:
        """[B, 36] (or [B, >=20]) one frame of features -> [B, 160] int16."""
        feats = np.zeros((self.batch, NB_TOTAL_FEATURES), np.float32)
        feats[:, :features.shape[-1]] = features
        return self._dec.synthesize(feats)

    def reset(self):
        self._dec.reset()


# ---- C-shaped wrappers (include/lpcnet.h) ----------------------------------

def _one_or_many(fn, x, dtype):
    """Run fn on [B, ...]; a single unbatched item in gives one out."""
    x = np.asarray(x, dtype)
    single = x.ndim == 1
    out = fn(x[None] if single else x)
    return out[0] if single else out


def lpcnet_encoder_create(batch: int = 1, device=None) -> LPCNetEncoder:
    return LPCNetEncoder(batch=batch, device=device)


def lpcnet_encode(enc: LPCNetEncoder, pcm: np.ndarray) -> np.ndarray:
    """pcm [640] or [B, 640] -> packet(s) uint8 [8] / [B, 8]."""
    return _one_or_many(enc.encode, pcm, np.float32)


def lpcnet_compute_features(enc: LPCNetEncoder, pcm: np.ndarray
                            ) -> np.ndarray:
    """pcm [T*640] or [B, T*640] -> unquantized features [T, 4, 36] /
    [B, T, 4, 36]."""
    return _one_or_many(enc.compute_features, pcm, np.float32)


def lpcnet_compute_single_frame_features(enc: LPCNetEncoder, pcm: np.ndarray
                                         ) -> np.ndarray:
    """pcm [160] or [B, 160] -> features [36] / [B, 36]."""
    return _one_or_many(enc.compute_single_frame_features, pcm, np.float32)


def lpcnet_decoder_create(model_path: Optional[str] = None, batch: int = 1,
                          device=None) -> LPCNetDecoder:
    """A packet decoder on the model at `model_path` (None: a seeded random
    init, as `load_model`)."""
    dev = resolve_device(device)
    fused, cfg = load_model(model_path, device=dev)
    return LPCNetDecoder.from_fused(fused, cfg, batch, with_codebooks=True,
                                    device=dev)


def lpcnet_decode(dec: LPCNetDecoder, packet: np.ndarray) -> np.ndarray:
    """packet [8] or [B, 8] uint8 -> pcm [640] / [B, 640] int16."""
    return _one_or_many(dec.decode, packet, np.uint8)


def add_lpc_to_features(features: np.ndarray, device=None) -> np.ndarray:
    """-addlpc mode: columns 20:36 from the cepstrum's LPC
    (src/lpcnet_demo.c:250-259)."""
    features = np.array(features, np.float32, copy=True)
    ceps = torch.as_tensor(features[..., :NB_BANDS],
                           device=resolve_device(device))
    features[..., 20:36] = lpc_from_cepstrum(ceps).cpu().numpy()
    return features
