"""Raw weights: from the run's seed, made on the device in a few large calls
(one uniform and one normal draw a model), in float32, the type the
configurations state for them; or a trained checkpoint read by path
(`load_npz`). The seeded families are those of
`lpcnet_torch.models.lpcnet.init_params`: glorot-uniform kernels, per-gate
orthogonal GRU recurrents, the PCM-ramp signal embedding, zero biases, unit
DualFC factors. Both the program and
the references get these tensors (the program a copy); each derives its
own fused and quantized forms from them."""

from __future__ import annotations

import math

import torch

EMBED_SIZE = 128
PCM_LEVELS = 256


class _Draws:
    """Slices of one uniform draw in [-1, 1) and of one normal draw."""

    def __init__(self, n_uniform: int, n_normal: int, gen, device):
        self.u = 2.0 * torch.rand(n_uniform, generator=gen, device=device) - 1.0
        self.z = torch.randn(n_normal, generator=gen, device=device)
        self.iu = self.iz = 0

    def uniform(self, shape, lim):
        n = math.prod(shape)
        x = self.u[self.iu:self.iu + n].reshape(shape) * lim
        self.iu += n
        return x

    def orthogonal_gates(self, n: int):
        """[n, 3n]: three orthogonal blocks, QR of normal draws with the
        sign fix that makes the factorisation unique."""
        z = self.z[self.iz:self.iz + 3 * n * n].reshape(3, n, n)
        self.iz += 3 * n * n
        q, r = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        return torch.cat(list(q), dim=1)


def _glorot(d: _Draws, shape, fan_in, fan_out):
    return d.uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)))


def _dense(d, n_in, n_out):
    return {"kernel": _glorot(d, (n_in, n_out), n_in, n_out),
            "bias": torch.zeros(n_out, device=d.u.device)}


def _gru(d, n_in, n):
    return {"kernel": _glorot(d, (n_in, 3 * n), n_in, 3 * n),
            "recurrent": d.orthogonal_gates(n),
            "bias": torch.zeros((2, 3 * n), device=d.u.device)}


def lpcnet_params(c: dict, gen: torch.Generator, device) -> dict:
    """The vocoder's raw params (nested dict, `models/lpcnet.py` layout)
    for configuration `c`."""
    na, nb, cond, k = (c["rnn_units1"], c["rnn_units2"], c["cond_size"],
                       c["conv_kernel"])
    fin = c["nb_used_features"] + c["pitch_embed_dim"]
    a_in, b_in = 3 * EMBED_SIZE + cond, na + cond
    n_u = (PCM_LEVELS * c["pitch_embed_dim"] + k * fin * cond + k * cond * cond
           + 2 * cond * cond + PCM_LEVELS * EMBED_SIZE + a_in * 3 * na
           + b_in * 3 * nb + nb * PCM_LEVELS * 2)
    d = _Draws(n_u, 3 * (na * na + nb * nb), gen, device)
    z = lambda *s: torch.zeros(s, device=device)
    ramp = math.sqrt(12) * (torch.arange(PCM_LEVELS, device=device) - 128 + 0.5) / 256
    return {
        "embed_pitch": {"table": d.uniform((PCM_LEVELS, c["pitch_embed_dim"]), 0.05)},
        "feature_conv1": {"kernel": _glorot(d, (k, fin, cond), k * fin, k * cond),
                          "bias": z(cond)},
        "feature_conv2": {"kernel": _glorot(d, (k, cond, cond), k * cond, k * cond),
                          "bias": z(cond)},
        "feature_dense1": _dense(d, cond, cond),
        "feature_dense2": _dense(d, cond, cond),
        "embed_sig": {"table": 0.1 * (d.uniform((PCM_LEVELS, EMBED_SIZE), 1.7321)
                                      + ramp[:, None])},
        "gru_a": _gru(d, a_in, na),
        "gru_b": _gru(d, b_in, nb),
        "dual_fc": {"kernel": _glorot(d, (nb, PCM_LEVELS, 2), nb, PCM_LEVELS),
                    "bias": z(PCM_LEVELS, 2),
                    "factor": torch.ones((PCM_LEVELS, 2), device=device)},
    }


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def clone(tree):
    return map_tree(lambda t: t.clone(), tree)


def load_npz(path, device) -> dict:
    """A checkpoint file ('/'-joined parameter paths -> arrays) as a nested
    dict of float32 tensors on `device`; its `__config__` is left out."""
    import numpy as np
    tree: dict = {}
    with np.load(path) as d:
        for key in d.files:
            if key == "__config__":
                continue
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.as_tensor(d[key], dtype=torch.float32,
                                         device=device)
    return tree


ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def raw_lpcnet(c: dict, traffic: dict, seed: int, device) -> dict:
    """The vocoder's raw params for a cell: the configuration's trained
    checkpoint where the mix asks for "trained" weights, else from the
    seed."""
    if traffic["weights"] == "trained":
        return load_npz(ROOT / c["trained_weights"], device)
    from .generate import device_generator, sub_seed
    return lpcnet_params(c, device_generator(sub_seed(seed, 0), device), device)


def raw_plc(c: dict, device):
    """(vocoder params, PLC-net params) for a concealment cell: the
    configuration's trained checkpoints."""
    w = c["trained_weights"]
    return load_npz(ROOT / w["vocoder"], device), load_npz(ROOT / w["plc"], device)
