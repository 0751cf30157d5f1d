"""Numpy-seeded parameter initializers in the JAX package's families
(`lpcnet_tpu/nn/init.py`): Glorot-uniform kernels, orthogonal recurrent
gates (one orthogonal block per gate), zero biases.

Each takes a `numpy.random.RandomState` and returns a dict of float32 numpy
arrays in the layouts of `nn.layers`; `weights.convert.params_to_torch`
carries a tree of them to a device. The values differ from `jax.random`'s
for the same seed: to compare with the JAX package, carry its weights
across instead.
"""

from __future__ import annotations

import math

import numpy as np


def glorot_uniform(rs: np.random.RandomState, shape) -> np.ndarray:
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)); a conv kernel
    [k, in, out] counts k * in and k * out."""
    if len(shape) == 3:
        fan_in, fan_out = shape[0] * shape[1], shape[0] * shape[2]
    else:
        fan_in, fan_out = shape
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return rs.uniform(-lim, lim, shape).astype(np.float32)


def orthogonal_gates(rs: np.random.RandomState, n: int) -> np.ndarray:
    """A GRU recurrent matrix [n, 3n], each gate's block orthogonal (Keras's
    behaviour)."""
    blocks = []
    for _ in range(3):
        q, r = np.linalg.qr(rs.normal(size=(n, n)))
        blocks.append(q * np.sign(np.diag(r)))
    return np.concatenate(blocks, axis=1).astype(np.float32)


def dense_params(rs: np.random.RandomState, n_in: int, n_out: int):
    return {"kernel": glorot_uniform(rs, (n_in, n_out)),
            "bias": np.zeros(n_out, np.float32)}


def conv1d_params(rs: np.random.RandomState, k: int, n_in: int, n_out: int):
    return {"kernel": glorot_uniform(rs, (k, n_in, n_out)),
            "bias": np.zeros(n_out, np.float32)}


def gru_params(rs: np.random.RandomState, n_in: int, n_units: int):
    return {"kernel": glorot_uniform(rs, (n_in, 3 * n_units)),
            "recurrent": orthogonal_gates(rs, n_units),
            "bias": np.zeros((2, 3 * n_units), np.float32)}
