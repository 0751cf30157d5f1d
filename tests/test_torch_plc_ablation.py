"""The batched PLC's profiling ablation set (`plc.batched._ABLATE`) on the
CPU, on the kernel program with the kernels' plain versions: a stand-in
takes effect and leaves nothing behind, every name runs finite with the
state's shapes and types, and the port's tool sweeps the JAX tool's
names."""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.plc import batched as B

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TCFG = M.LPCNetConfig(rnn_units1=32, rnn_units2=16, cond_size=16,
                      pitch_embed_dim=8)
STREAMS, FRAMES, SHORT = 8, 20, 5


@pytest.fixture(scope="module")
def models():
    return (M.fuse_inference_params(M.init_params(TCFG, seed=0), TCFG),
            PM.init_params(seed=1))


@pytest.fixture(scope="module")
def traffic():
    rs = np.random.RandomState(5)
    pcm = (rs.randn(STREAMS, FRAMES, 160) * 2000).astype(np.float32)
    lost = rs.rand(STREAMS, FRAMES) < 0.25
    lost[:, :3] = False
    lost[0] = False
    return pcm, lost


def _run(models, traffic, ablate=frozenset(), **flags):
    prev_flags = B.set_plc_flags(**flags)
    prev = B._ABLATE
    B._ABLATE = frozenset(ablate)
    try:
        plc = B.BatchedPLC(*models[:1], TCFG, models[1], batch=STREAMS,
                           device="cpu", use_kernel=True)
        out = plc.run(*traffic)
    finally:
        B._ABLATE = prev
        B.set_plc_flags(*prev_flags)
    return out, plc.state


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


@pytest.fixture(scope="module")
def plain(models, traffic):
    return _run(models, traffic)


@pytest.fixture(scope="module")
def short(traffic):
    """The first SHORT frames of the traffic: losses from frame 3 on."""
    return tuple(np.ascontiguousarray(x[:, :SHORT]) for x in traffic)


@pytest.fixture(scope="module")
def plain_short(models, short):
    return _run(models, short)


def test_stand_in_takes_effect_and_clears(models, traffic, plain):
    out, _ = _run(models, traffic, {"tails"})
    assert not np.array_equal(out, plain[0])
    again, state = _run(models, traffic)
    np.testing.assert_array_equal(again, plain[0])
    for a, b in zip(_leaves(state), _leaves(plain[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,flags", [
    ("burg", {}), ("enc", {}), ("fnet", {}),
    ("plcnet", {}), ("plcnet", {"fastchain": True}), ("tf", {}),
    ("tf", {"fasttf": False}), ("tails", {}), ("tails", {"fasttf": False}),
    ("ALL", {})])
def test_each_name_runs_with_the_state_unchanged_in_form(
        models, short, plain_short, name, flags):
    names = B.ABLATION_NAMES if name == "ALL" else (name,)
    out, state = _run(models, short, names, **flags)
    want_out, want_state = (plain_short if not flags
                            else _run(models, short, **flags))
    assert out.shape == want_out.shape and out.dtype == want_out.dtype
    assert np.isfinite(out).all()
    got, want = _leaves(state), _leaves(want_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            assert torch.isfinite(a).all()
    assert any(not torch.equal(a, b) for a, b in zip(got, want)), name


def _tool():
    spec = importlib.util.spec_from_file_location(
        "profile_plc_torch", ROOT / "tools" / "profile_plc_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tool_sweeps_the_jax_tools_names():
    tree = ast.parse((ROOT / "tools" / "profile_plc.py").read_text())
    sweeps = [tuple(e.value for e in node.elts) for node in ast.walk(tree)
              if isinstance(node, ast.Tuple) and node.elts
              and all(isinstance(e, ast.Constant) for e in node.elts)
              and "ALL" in [e.value for e in node.elts]]
    assert len(sweeps) == 1
    assert _tool().SWEEP == sweeps[0]
