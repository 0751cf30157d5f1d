"""The PLC-net chain's Python side (K4: weight bundle, plain version,
wrapper) vs the JAX package, on the CPU. The CUDA kernel itself is held
against its plain version in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import plc_chain as JPC
from lpcnet_tpu.models import plc as JPM

from lpcnet_torch.kernels import plc_chain as PC
from lpcnet_torch.models import plc as PM
from lpcnet_torch.weights.convert import params_to_torch

torch.set_num_threads(1)

B = 8


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def params():
    """(JAX params, port params) of the PLC net from one numpy-seeded init,
    with non-zero biases so every term is exercised."""
    rs = np.random.RandomState(7)
    p = _numpy_tree(PM.init_params(seed=3))
    for layer in p.values():
        layer["bias"] = (rs.normal(size=layer["bias"].shape) * 0.1
                         ).astype(np.float32)
    return jax.tree.map(jnp.asarray, p), params_to_torch(p)


def _case(k_steps, seed):
    rs = np.random.RandomState(seed)
    h1 = np.tanh(rs.randn(B, 256)).astype(np.float32)
    h2 = np.tanh(rs.randn(B, 256)).astype(np.float32)
    inputs = (rs.randn(B, k_steps, PM.PLC_INPUT_SIZE) * 0.5).astype(np.float32)
    masks = rs.rand(B, k_steps) < 0.6
    masks[0] = False                                 # one stream never moves
    return h1, h2, inputs, masks


@pytest.mark.parametrize("k_steps", [1, 4])
def test_plain_k4_matches_pallas_interpret(params, monkeypatch, k_steps):
    """K4's plain version vs the TPU kernel run by the Pallas interpreter:
    states after every step within 2e-5, outputs within 2e-4 (the JAX
    package's bars for its kernel), a frozen stream's states exact."""
    monkeypatch.setattr(JPC, "_INTERPRET", True)
    jp, tp = params
    h1, h2, inputs, masks = _case(k_steps, 0)
    jh1, jh2, jout = JPC.plc_chain_pallas(
        JPC.plc_chain_weights(jp), jnp.asarray(h1), jnp.asarray(h2),
        jnp.asarray(inputs), jnp.asarray(masks), k_steps, bt=B)
    t = torch.from_numpy
    th1, th2, tout = PC.plc_chain_plain(PC.plc_chain_weights(tp), t(h1), t(h2),
                                        t(inputs), t(masks), k_steps)
    assert tout.shape == (B, k_steps, 20)
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=2e-5)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), atol=2e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-4)
    for k in range(k_steps):
        assert np.array_equal(th1.numpy()[0, k], h1[0])
        assert np.array_equal(th2.numpy()[0, k], h2[0])


@pytest.mark.parametrize("k_steps", [1, 4])
def test_plain_k4_matches_stepwise_compute_plc_pred(params, k_steps):
    """The chain vs masked `compute_plc_pred` calls in a row (the path the
    flag chooses against), the +0.1 boost applied by the caller as the
    batched step does: states 2e-5, outputs 2e-4; and the wrapper takes the
    plain version on CPU tensors without counting a launch."""
    _, tp = params
    h1, h2, inputs, masks = (torch.from_numpy(x) for x in _case(k_steps, 1))
    before = PC.plc_chain_kernel.launches
    h1s, h2s, outs = PC.plc_chain_kernel(PC.plc_chain_weights(tp), h1, h2,
                                         inputs, masks, k_steps)
    assert PC.plc_chain_kernel.launches == before
    outs[:, :, -1] = torch.clamp(outs[:, :, -1] + 0.1, max=0.5)
    st = PM.PLCNetState(h1, h2)
    for k in range(k_steps):
        new, out = PM.compute_plc_pred(tp, st, inputs[:, k])
        m = masks[:, k][:, None]
        st = PM.PLCNetState(torch.where(m, new.gru1, st.gru1),
                            torch.where(m, new.gru2, st.gru2))
        np.testing.assert_allclose(h1s[:, k].numpy(), st.gru1.numpy(), atol=2e-5)
        np.testing.assert_allclose(h2s[:, k].numpy(), st.gru2.numpy(), atol=2e-5)
        np.testing.assert_allclose(outs[:, k].numpy(), out.numpy(), atol=2e-4)


def test_k4_wrapper_refuses_other_devices(params):
    _, tp = params
    h1, h2, inputs, masks = (torch.from_numpy(x) for x in _case(2, 2))
    with pytest.raises(ValueError):
        PC.plc_chain_kernel(PC.plc_chain_weights(tp), h1.to("meta"), h2,
                            inputs, masks, 2)
