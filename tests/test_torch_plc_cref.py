"""The port's host PLC (`plc.plc.PLC`) against the reference C's PLC traces
(test_neural_cref.py:325), all five modes, at full width, under the C table
activations.

The weights are the fixture's: jax.random init from the fixture seeds,
carried as numpy through the port's own DNNw writer (SHA-checked against
the fixture, which proves the port writes the bytes the C loaded) and read
back by the port's reader. Concealed stretches are sampled and chaotic, so
the gate is the JAX test's: every packet outside a loss-affected window (a
lost packet and the 2 after it: blending and resync) must match C within 2,
int16-wraparound aware.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from conftest import load_fixture

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.models import plc as JPM

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import layers as L
from lpcnet_torch.plc.plc import PLC
from lpcnet_torch.weights import aux_arrays as AUX
from lpcnet_torch.weights import blob as B
from lpcnet_torch.weights import lpcnet_arrays as LA

torch.set_num_threads(1)

FRAME = 160
PLC_MODES = [("causal", 0), ("causal_dc", 4), ("nc", 1), ("nc_dc", 5),
             ("codec", 2)]


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fx():
    return load_fixture("neural_cref.npz")


@pytest.fixture(scope="module")
def weights(fx):
    """(fused vocoder, PLC-net params) of the fixture, through the port's
    blob writer and reader."""
    params = _numpy(jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1234), JM.LPCNetConfig()))
    blob = LA.save_lpcnet_blob(params, M.LPCNetConfig(), quantize=False)
    assert hashlib.sha256(blob).digest() == fx["voc_blob_sha"].tobytes(), (
        "the port's blob differs from the fixture's")
    plc_blob = AUX.save_plc_blob(_numpy(JPM.init_params(jax.random.PRNGKey(5678))),
                                 quantize=False)
    return (LA.load_lpcnet_blob(blob, M.LPCNetConfig()),
            AUX.load_plc_blob(plc_blob))


@pytest.fixture(autouse=True)
def cref_activations(fx, monkeypatch):
    monkeypatch.setattr(L, "_TANSIG_TABLE", None)
    L.set_cref_tansig_table(fx["tansig_table"])
    with L.activation_impl("cref"):
        yield


def plc_trace(plc, pcm_in, lost):
    """Per 20 ms packet, conceal if lost else update (harness_nn.c's plc
    mode)."""
    out = []
    for k in range(len(pcm_in) // FRAME):
        frame = pcm_in[k * FRAME:(k + 1) * FRAME][None]
        out.append(plc.conceal()[0] if lost[k // 2] else plc.update(frame)[0])
    return np.concatenate(out)


def clean_packets_match(out, ref, lost):
    """test_neural_cref.py's gate: (packet, its worst diff) for every packet
    outside a loss-affected window that is more than 2 from C."""
    d = np.abs(((out - ref.astype(np.float64) + 32768) % 65536) - 32768)
    affected = {p + i for p in np.nonzero(lost)[0].tolist() for i in range(3)}
    return [(p, d[p * 2 * FRAME:(p + 1) * 2 * FRAME].max())
            for p in range(len(lost)) if p not in affected
            and d[p * 2 * FRAME:(p + 1) * 2 * FRAME].max() > 2]


@pytest.mark.parametrize("name,flags", PLC_MODES, ids=[m[0] for m in PLC_MODES])
def test_plc_trace(fx, weights, name, flags):
    fused, plc_params = weights
    cfg = M.LPCNetConfig(lookahead=0) if flags & 1 else M.LPCNetConfig()
    plc = PLC(fused, cfg, plc_params, options=flags, batch=1, device="cpu")
    out = plc_trace(plc, fx["plc_in_pcm"].astype(np.float32), fx["plc_lost"])
    assert out.shape == (len(fx["plc_in_pcm"]),)
    assert not clean_packets_match(out, fx[f"plc_{name}_pcm"], fx["plc_lost"]), (
        f"{name}: state machine out of sync with C")
