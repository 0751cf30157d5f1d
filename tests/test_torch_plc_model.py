"""The PLC feature-prediction network and the frame network's flush vs the
JAX package, on the CPU, from one numpy-seeded set of weights."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.models import plc as JPM
from lpcnet_tpu.weights.checkpoint import load_checkpoint as jload

from lpcnet_torch import api
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.weights.convert import params_to_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def plc_params():
    p = _numpy_tree(PM.init_params(seed=5))
    return jax.tree.map(jnp.asarray, p), params_to_torch(p)


def test_init_params_shapes_and_seed():
    a, b, c = PM.init_params(1), PM.init_params(1), PM.init_params(2)
    assert a["plc_dense1"]["kernel"].shape == (57, 128)
    assert a["plc_gru1"]["recurrent"].shape == (256, 768)
    assert a["plc_gru2"]["kernel"].shape == (256, 768)
    assert a["plc_out"]["kernel"].shape == (256, 20)
    assert torch.equal(a["plc_gru1"]["kernel"], b["plc_gru1"]["kernel"])
    assert not torch.equal(a["plc_gru1"]["kernel"], c["plc_gru1"]["kernel"])
    st = PM.init_state(3)
    assert st.gru1.shape == (3, 256) and not st.gru2.any()


def test_compute_plc_pred_matches_jax(plc_params):
    """Five steps in a row, the state carried: features and both GRU states
    within 1e-5; the boosted correlation feature never above 0.5."""
    jp, tp = plc_params
    rs = np.random.RandomState(0)
    js, ts = JPM.init_state(6), PM.init_state(6)
    step = jax.jit(JPM.compute_plc_pred)
    for _ in range(5):
        x = (rs.randn(6, PM.PLC_INPUT_SIZE) * 0.7).astype(np.float32)
        js, jo = step(jp, js, jnp.asarray(x))
        ts, to = PM.compute_plc_pred(tp, ts, torch.from_numpy(x))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(ts.gru1.numpy(), np.asarray(js.gru1), atol=1e-5)
        np.testing.assert_allclose(ts.gru2.numpy(), np.asarray(js.gru2), atol=1e-5)
        assert float(to[:, -1].max()) <= 0.5


def test_predict_sequence_matches_jax(plc_params):
    jp, tp = plc_params
    rs = np.random.RandomState(1)
    x = (rs.randn(3, 7, PM.PLC_INPUT_SIZE) * 0.7).astype(np.float32)
    h = np.tanh(rs.randn(2, 3, 256)).astype(np.float32)
    js, jo = jax.jit(JPM.predict_sequence)(
        jp, JPM.PLCNetState(jnp.asarray(h[0]), jnp.asarray(h[1])), jnp.asarray(x))
    ts, to = PM.predict_sequence(
        tp, PM.PLCNetState(torch.from_numpy(h[0]), torch.from_numpy(h[1])),
        torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(ts.gru2.numpy(), np.asarray(js.gru2), atol=1e-5)


@pytest.mark.parametrize("lookahead", [2, 0])
def test_frame_network_flush_matches_jax(lookahead):
    """Counts 0..4 mixed over the streams, from a state that two ordinary
    frames have warmed: conv memories, LPC FIFO and frame counter of every
    stream and, where count > 0, the conditioning and LPC of its last step,
    within 1e-5 of the JAX package's; and equal to that many single
    frame_network steps."""
    jcfg = JM.LPCNetConfig(lookahead=lookahead, **SMALL)
    tcfg = M.LPCNetConfig(lookahead=lookahead, **SMALL)
    p = _numpy_tree(M.init_params(tcfg, seed=2))
    jf = JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), jcfg)
    tf = M.fuse_inference_params(params_to_torch(p), tcfg)
    rs = np.random.RandomState(3)
    b, T = 7, 4
    feats = lambda *s: (rs.normal(size=s + (36,)) * 0.3).astype(np.float32)
    jfs, tfs = JM.init_frame_state(b, jcfg), M.init_frame_state(b, tcfg)
    for f in feats(2, b):
        jfs = JM.frame_network(jf, jfs, jnp.asarray(f), jcfg)[0]
        tfs = M.frame_network(tf, tfs, torch.from_numpy(f), tcfg)[0]
    ring = feats(b, T)
    count = np.array([0, 1, 2, 3, 4, 0, 4], np.int32)
    jout = JM.frame_network_flush(jf, jfs, jnp.asarray(ring), jnp.asarray(count), jcfg)
    tout = M.frame_network_flush(tf, tfs, torch.from_numpy(ring),
                                 torch.from_numpy(count), tcfg)
    for a, c in zip(tout[0], jout[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5)
    assert tout[0].frame_count.dtype == torch.int32
    on = count > 0
    for a, c in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(a.numpy()[on], np.asarray(c)[on], atol=1e-5)
    # against single steps, stream by stream
    for i in range(b):
        st = M.FrameState(*(x[i:i + 1] for x in tfs))
        for k in range(count[i]):
            st, _, ca, cb, lpc = M.frame_network(
                tf, st, torch.from_numpy(ring[i:i + 1, k]), tcfg)
        for a, c in zip(tout[0], st):
            np.testing.assert_allclose(a[i:i + 1].numpy(), c.numpy(), atol=1e-6)
        if count[i]:
            np.testing.assert_allclose(tout[1][i:i + 1].numpy(), ca.numpy(), atol=1e-6)
            np.testing.assert_allclose(tout[3][i:i + 1].numpy(), lpc.numpy(), atol=1e-6)


def test_load_plc_model_reads_the_shipped_checkpoint(monkeypatch):
    """`api.load_plc_model` gives the leaves the JAX package's loader gives,
    defaults to CUDA and raises without it."""
    assert Path(api.DEMO_PLC_MODEL_PATH) == ROOT / "lpcnet_tpu" / "data" / "demo_plc_model.npz"
    tp = api.load_plc_model(api.DEMO_PLC_MODEL_PATH, device="cpu")
    jp, _ = jload(api.DEMO_PLC_MODEL_PATH)
    assert set(tp) == set(jp) == {"plc_dense1", "plc_gru1", "plc_gru2", "plc_out"}
    for layer in jp:
        for leaf in jp[layer]:
            assert np.array_equal(tp[layer][leaf].numpy(), np.asarray(jp[layer][leaf]))
    assert api.load_plc_model(None, seed=4, device="cpu")["plc_out"]["kernel"].shape == (256, 20)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.load_plc_model(api.DEMO_PLC_MODEL_PATH)
    with pytest.raises(FileNotFoundError):
        api.load_plc_model("plc.bin", device="cpu")
