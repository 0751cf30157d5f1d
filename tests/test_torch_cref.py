"""lpcnet_torch's plain synthesis vs the reference C decoder: the golden gates
of test_neural_cref.py (free-running window gate and teacher-forced state
gates), float and int8 DOT_PROD, run under the C table activations.

The weights are the fixtures' own: jax.random init from the fixture seed,
through the JAX package's DNNw blob writer/reader (SHA-checked against the
fixture), then carried into the port with weights.convert.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from conftest import load_fixture

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.nn.quantized import quantize_fused as j_quantize_fused
from lpcnet_tpu.weights import blob as B
from lpcnet_tpu.weights import lpcnet_arrays as LA

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import layers as L
from lpcnet_torch.weights.convert import params_to_torch

# the plain path is many small ops: one intra-op thread per process keeps
# parallel pytest workers from oversubscribing the cores
torch.set_num_threads(1)

FRAME = 160
N_FREE = 8          # gated free-running frames after the lookahead


@pytest.fixture(scope="module")
def fx():
    return load_fixture("neural_cref.npz")


@pytest.fixture(scope="module")
def fx_q8():
    return load_fixture("neural_cref_q8.npz")


@pytest.fixture(scope="module")
def jax_params():
    cfg = JM.LPCNetConfig()
    return jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1234), cfg)


def _fused(fixture, params, quantize):
    """The fixture's fused weights (blob SHA-checked), as port tensors."""
    cfg = JM.LPCNetConfig()
    blob = B.write_blob(LA.arrays_from_params(params, cfg, quantize=quantize))
    assert hashlib.sha256(blob).digest() == fixture["voc_blob_sha"].tobytes(), (
        "regenerated weights differ from the fixture's")
    fused = LA.fused_from_arrays(B.read_blob(blob), cfg)
    if quantize:
        fused = j_quantize_fused(fused)
    return params_to_torch(fused), M.LPCNetConfig()


@pytest.fixture(scope="module")
def voc(fx, jax_params):
    return _fused(fx, jax_params, quantize=False)


@pytest.fixture(scope="module")
def voc_q8(fx_q8, jax_params):
    return _fused(fx_q8, jax_params, quantize=True)


@pytest.fixture(autouse=True)
def cref_activations(fx, monkeypatch):
    # monkeypatch puts the previous table back after the test, so later
    # tests in this process see the port's recomputed table again
    monkeypatch.setattr(L, "_TANSIG_TABLE", None)
    L.set_cref_tansig_table(fx["tansig_table"])
    with L.activation_impl("cref"):
        yield


def _run_frames(fixture, voc, n_frames=None, preload=None):
    """frame_network + synthesize_frame per frame, single stream; warmup
    frames emit silence without stepping the sample state."""
    fused, cfg = voc
    feats = torch.from_numpy(np.asarray(fixture["synth_features"], np.float32))
    n_frames = n_frames or feats.shape[0]
    fstate = M.init_frame_state(1, cfg)
    sstate = M.init_sample_state(1, cfg)
    pcm_out, states = [], {}
    with torch.no_grad():
        for k in range(n_frames):
            fstate, _, ca, cb, lpc = M.frame_network(fused, fstate,
                                                     feats[k][None], cfg)
            if k < cfg.lookahead:
                pcm_out.append(np.zeros(FRAME))
                continue
            tgt = None if preload is None else torch.from_numpy(preload[k][None])
            sstate, pcm = M.synthesize_frame(fused, sstate, ca, cb, lpc,
                                             preload=tgt)
            pcm_out.append(pcm.numpy().astype(np.float64)[0])
            states[k] = np.concatenate([
                sstate.gru_a[0].numpy(), sstate.gru_b[0].numpy(),
                sstate.last_sig[0].numpy(), [float(sstate.last_exc[0])],
                [float(sstate.deemph[0])]])
    return np.concatenate(pcm_out), states


def _gate_free_running(fixture, cfg, pcm_out, tol=128.0, max_bad_frames=0):
    """test_neural_cref.py:_gate_free_running: the excitation must stay
    locked to C over the gate window (<15% of samples off by >2), at most
    `max_bad_frames` frames above `tol`, and the last 4 frames re-locked."""
    cpcm = fixture["synth_free_pcm"].astype(np.float64)[:len(pcm_out)]
    warm = cfg.lookahead * FRAME
    assert np.all(pcm_out[:warm] == 0) and np.all(cpcm[:warm] == 0)
    d = np.abs(pcm_out - cpcm)
    gate = d[warm:warm + N_FREE * FRAME]
    assert np.mean(gate > 2) < 0.15, np.mean(gate > 2)
    bad = sum(d[w:w + FRAME].max() > tol
              for w in range(warm, warm + N_FREE * FRAME, FRAME))
    assert bad <= max_bad_frames, bad
    tail = d[warm + (N_FREE - 4) * FRAME:warm + N_FREE * FRAME]
    assert tail.max() <= tol, tail.max()


def _gate_teacher_forced(fixture, cfg, states):
    na, nb = cfg.rnn_units1, cfg.rnn_units2
    cst = fixture["synth_tf_states"]
    for k, st in states.items():
        d = np.abs(st - cst[k])
        assert d[:na].max() < 0.15, (k, d[:na].max())               # gru_a
        assert d[na:na + nb].max() < 0.10, (k, d[na:na + nb].max())  # gru_b
        assert d[na + nb:na + nb + 16].max() < 1.0, k               # last_sig
        assert d[na + nb + 16] <= 1.0, k                            # last_exc
        assert d[na + nb + 17] < 4.0, k                             # deemph


def test_sampling_logit_table(fx):
    d = np.abs(M.sampling_logit_table() - fx["sampling_logit_table"]).max()
    assert d < 5e-7, d


def test_free_running_vs_c(fx, voc):
    pcm, _ = _run_frames(fx, voc, n_frames=voc[1].lookahead + N_FREE)
    _gate_free_running(fx, voc[1], pcm)


def test_teacher_forced_states_vs_c(fx, voc):
    tf_pcm = fx["synth_in_pcm"].astype(np.float32).reshape(-1, FRAME)
    _, states = _run_frames(fx, voc, preload=tf_pcm)
    _gate_teacher_forced(fx, voc[1], states)


def test_free_running_vs_c_q8(fx_q8, voc_q8):
    """int8 DOT_PROD build; as in test_neural_cref.py, one decaying sampler
    flip in frames 1-2 is admitted, re-locked from frame 3 on."""
    pcm, _ = _run_frames(fx_q8, voc_q8, n_frames=voc_q8[1].lookahead + N_FREE)
    _gate_free_running(fx_q8, voc_q8[1], pcm, max_bad_frames=2)


def test_teacher_forced_states_vs_c_q8(fx_q8, voc_q8):
    tf_pcm = fx_q8["synth_in_pcm"].astype(np.float32).reshape(-1, FRAME)
    _, states = _run_frames(fx_q8, voc_q8, preload=tf_pcm)
    _gate_teacher_forced(fx_q8, voc_q8[1], states)
