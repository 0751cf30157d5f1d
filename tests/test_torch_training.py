"""The port's training stack vs the JAX package, on the CPU at a small config:
the same numpy-seeded arrays go through both. Losses function by function,
the training graph and `loss_fn` with their gradients leaf by leaf (noise
off: `rng=None`, since a torch.Generator cannot reproduce jax.random), the
sparsify schedules, the optimizer, the loaders, the checkpoints and the
Trainer."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lpcnet_tpu import api as japi
from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.train import data as JD
from lpcnet_tpu.train import losses as JL
from lpcnet_tpu.train import sparsify as JS
from lpcnet_tpu.train import train_lpcnet as JT
from lpcnet_tpu.weights import checkpoint as JC

from lpcnet_torch import api
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.train import checkpointing as CK
from lpcnet_torch.train import data as D
from lpcnet_torch.train import losses as LL
from lpcnet_torch.train import sparsify as S
from lpcnet_torch.train import train_lpcnet as T
from lpcnet_torch.weights import convert as CV
from lpcnet_torch.weights.checkpoint import save_checkpoint

torch.set_num_threads(1)

TINY = dict(rnn_units1=32, rnn_units2=16, cond_size=16, pitch_embed_dim=8)
JCFG, TCFG = JM.LPCNetConfig(**TINY), M.LPCNetConfig(**TINY)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.detach().numpy()


def _params(cfg=TCFG, seed=4):
    """One numpy-seeded init as (numpy tree, JAX tree)."""
    p = _np_tree(M.init_params(cfg, seed=seed))
    return p, jax.tree.map(jnp.asarray, p)


def fake_batch(seed=0, b=4, frames=3, e2e=False):
    rs = np.random.RandomState(seed)
    t = frames * 160
    sig = np.cumsum(rs.randn(b, t + 1), axis=1).astype(np.float32) * 100
    batch = {
        "sig_in": sig[:, :-1].copy(),
        "sig_out": sig[:, 1:].copy(),
        "features": rs.randn(b, frames + 4, 20).astype(np.float32) * 0.3,
        "periods": rs.randint(33, 255, (b, frames + 4)).astype(np.int32),
    }
    lpc = (rs.randn(b, frames, 16) * 0.05).astype(np.float32)
    if e2e:
        batch["rc"] = np.tanh(rs.randn(b, frames, 16) * 0.3).astype(np.float32)
    else:
        batch["lpc"] = lpc
    return batch


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# losses, function by function
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_inputs():
    rs = np.random.RandomState(2)
    return dict(
        p=(1.0 / (1.0 + np.exp(-rs.randn(3, 11, 256)))).astype(np.float32),
        q=(1.0 / (1.0 + np.exp(-rs.randn(3, 11, 256)))).astype(np.float32),
        labels=rs.randint(0, 256, (3, 11)).astype(np.int32),
        sig_out=(rs.randn(3, 11) * 3000).astype(np.float32),
        tp=(rs.randn(3, 11) * 2500).astype(np.float32),
        rp=(rs.randn(3, 11) * 2600).astype(np.float32),
        x=(rs.randn(2, 320) * 1000).astype(np.float32),
        lpc=(rs.randn(2, 2, 16) * 0.1).astype(np.float32),
        rc=np.tanh(rs.randn(3, 5, 16)).astype(np.float32),
        rc2=np.tanh(rs.randn(3, 5, 16)).astype(np.float32),
    )


LOSS_CASES = {
    "tf_l2u": (lambda L, d, a: L.tf_l2u(a(d["x"])), 1e-5),
    "tf_u2l": (lambda L, d, a: L.tf_u2l(a(d["labels"])), 1e-5),
    "diff_pred": (lambda L, d, a: L.diff_pred(a(d["x"]), a(d["lpc"])), 1e-5),
    "tree_to_pdf": (lambda L, d, a: L.tree_to_pdf(a(d["p"])), 1e-6),
    "tree_pdf_at": (lambda L, d, a: L.tree_pdf_at(a(d["p"]), a(d["labels"])),
                    1e-6),
    "tree_neg_log_pdf": (lambda L, d, a: L.tree_neg_log_pdf(
        a(d["p"]), a(d["labels"])), 1e-5),
    "tree_distill_kl": (lambda L, d, a: L.tree_distill_kl(a(d["q"]),
                                                          a(d["p"])), 1e-5),
    "metric_cel_tree": (lambda L, d, a: L.metric_cel_tree(
        a(d["sig_out"]), a(d["tp"]), a(d["p"])), 1e-5),
    "interp_mulaw_loss_tree": (lambda L, d, a: L.interp_mulaw_loss_tree(
        a(d["sig_out"]), a(d["tp"]), a(d["rp"]), a(d["p"])), 2e-5),
    "metric_exc_sd": (lambda L, d, a: L.metric_exc_sd(a(d["sig_out"]),
                                                      a(d["tp"])), 1e-5),
    "loss_matchlar": (lambda L, d, a: L.loss_matchlar(a(d["rc"]),
                                                      a(d["rc2"])), 1e-5),
    "sparse_cat_ce": (lambda L, d, a: L.sparse_cat_ce(
        a(d["labels"]), L.tree_to_pdf(a(d["p"]))), 1e-5),
    "metric_cel": (lambda L, d, a: L.metric_cel(
        a(d["sig_out"]), a(d["tp"]), L.tree_to_pdf(a(d["p"]))), 1e-5),
    "interp_mulaw_loss": (lambda L, d, a: L.interp_mulaw_loss(
        a(d["sig_out"]), a(d["tp"]), a(d["rp"]), L.tree_to_pdf(a(d["p"]))),
        2e-5),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_function_matches_jax(loss_inputs, name):
    """Same inputs through both packages; relative tolerance per case
    (float32 log/exp of the two backends), absolute floor equal to it."""
    fn, tol = LOSS_CASES[name]
    want = np.asarray(fn(JL, loss_inputs, jnp.asarray))
    got = fn(LL, loss_inputs, _t).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(
        1.0, float(np.abs(want).max())))


def test_tree_pdf_at_is_bitwise_the_dense_tree(loss_inputs):
    p, lab = _t(loss_inputs["p"]), _t(loss_inputs["labels"])
    dense = torch.gather(LL.tree_to_pdf(p), -1, lab.long()[..., None])[..., 0]
    assert torch.equal(LL.tree_pdf_at(p, lab), dense)
    np.testing.assert_allclose(LL.tree_to_pdf(p).sum(-1).numpy(), 1.0,
                               rtol=1e-5)


def test_tree_neg_log_pdf_saturates_like_jax():
    p = np.full((1, 1, 256), 1e-30, np.float32)
    lab = np.full((1, 1), 255, np.int32)
    got = float(LL.tree_neg_log_pdf(_t(p), _t(lab))[0, 0])
    want = float(JL.tree_neg_log_pdf(jnp.asarray(p), jnp.asarray(lab))[0, 0])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, -np.log(1e-7), rtol=1e-6)


# --------------------------------------------------------------------------
# the training graph
# --------------------------------------------------------------------------

def test_diff_embed_matches_jax_with_out_of_range_inputs():
    """Values and the gradient wrt the table and wrt x, with x below 0 and
    above 255 (where trunc and floor, and the index clamps, matter)."""
    rs = np.random.RandomState(3)
    table = rs.randn(256, 128).astype(np.float32)
    x = np.concatenate([rs.uniform(0, 255, 500),
                        [-1.2, -0.4, 0.0, 255.0, 255.7, 256.2]]
                       ).astype(np.float32).reshape(11, 46)
    w = rs.randn(11, 46, 128).astype(np.float32)
    want = np.asarray(JM.diff_embed(jnp.asarray(table), jnp.asarray(x)))
    tt, tx = _t(table).requires_grad_(True), _t(x).requires_grad_(True)
    got = M.diff_embed(tt, tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-6,
                               atol=2e-6)
    gt, gx = jax.grad(lambda t, x: jnp.sum(JM.diff_embed(t, x) * w),
                      argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)


def test_frame_network_seq_matches_jax():
    p, jp = _params()
    b = fake_batch(1)
    want = np.asarray(JM.frame_network_seq(jp, jnp.asarray(b["features"]),
                                           jnp.asarray(b["periods"]), JCFG))
    got = M.frame_network_seq(CV.params_to_torch(p), _t(b["features"]),
                              _t(b["periods"]), TCFG).numpy()
    assert got.shape == (4, 3, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ["tanh", "linear"])
def test_conv1d_seq_matches_jax(activation):
    from lpcnet_tpu.nn import layers as JLy
    from lpcnet_torch.nn import layers as Ly
    rs = np.random.RandomState(5)
    params = {"kernel": rs.randn(3, 7, 5).astype(np.float32) * 0.3,
              "bias": rs.randn(5).astype(np.float32) * 0.1}
    x = rs.randn(2, 9, 7).astype(np.float32)
    want = np.asarray(JLy.conv1d_seq(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x), activation,
                                     padding="valid"))
    got = Ly.conv1d_seq(CV.params_to_torch(params), _t(x), activation).numpy()
    assert got.shape == (2, 7, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gru_seq_and_mdense_match_jax():
    from lpcnet_tpu.nn import layers as JLy
    from lpcnet_torch.nn import layers as Ly
    p, jp = _params()
    rs = np.random.RandomState(6)
    x = rs.randn(3, 9, TCFG.gru_b_input_size).astype(np.float32)
    h0 = rs.randn(3, 16).astype(np.float32) * 0.3
    tp = CV.params_to_torch(p)
    hs_j, ht_j = JLy.gru_seq(jp["gru_b"], jnp.asarray(x), h0=jnp.asarray(h0))
    hs, ht = Ly.gru_seq(tp["gru_b"], _t(x), h0=_t(h0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), np.asarray(ht_j), atol=1e-5)
    want = np.asarray(JLy.mdense(jp["dual_fc"], hs_j))
    np.testing.assert_allclose(Ly.mdense(tp["dual_fc"], hs).numpy(), want,
                               atol=1e-5)


def _assert_grads(tparams, jgrads, tol=1e-2):
    """Leaf by leaf, each within `tol` of the leaf's largest entry."""
    got = CV.grads_to_numpy(tparams)
    want = JC.flatten_tree(jgrads)
    assert set(got) == set(want)
    for k in want:
        scale = max(1e-6, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("e2e", [False, True], ids=["lpc", "e2e"])
def test_training_forward_matches_jax(e2e):
    cfg_kw = dict(TINY, e2e=e2e)
    jcfg, tcfg = JM.LPCNetConfig(**cfg_kw), M.LPCNetConfig(**cfg_kw)
    p, jp = _params(tcfg)
    b = fake_batch(2, e2e=e2e)
    jo = JM.training_forward(jp, jcfg, jnp.asarray(b["sig_in"]),
                             jnp.asarray(b["features"]),
                             jnp.asarray(b["periods"]),
                             lpc=None if e2e else jnp.asarray(b["lpc"]),
                             rng=None)
    to = M.training_forward(CV.params_to_torch(p), tcfg, _t(b["sig_in"]),
                            _t(b["features"]), _t(b["periods"]),
                            lpc=None if e2e else _t(b["lpc"]), rng=None)
    for k in ("tensor_preds", "real_preds"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(to["cfeat"].numpy(), np.asarray(jo["cfeat"]),
                               atol=1e-5)
    np.testing.assert_allclose(to["tree_probs"].numpy(),
                               np.asarray(jo["tree_probs"]), atol=1e-4)
    for a, c in zip(to["gru_states"], jo["gru_states"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-4)
    assert (to["rc"] is None) == (jo["rc"] is None)


@pytest.mark.parametrize("e2e", [False, True], ids=["lpc", "e2e"])
def test_loss_fn_and_gradients_match_jax(e2e):
    """loss within 1e-4 relative on the plain f32 recurrence; gradients leaf
    by leaf within 1e-2 of each leaf's largest entry; with carried GRU
    states."""
    cfg_kw = dict(TINY, e2e=e2e)
    jcfg, tcfg = JM.LPCNetConfig(**cfg_kw), M.LPCNetConfig(**cfg_kw)
    p, jp = _params(tcfg)
    b = fake_batch(3, e2e=e2e)
    rs = np.random.RandomState(7)
    states = (rs.randn(4, 32).astype(np.float32) * 0.2,
              rs.randn(4, 16).astype(np.float32) * 0.2)
    jtc, ttc = JT.TrainConfig(), T.TrainConfig()

    def jloss(pp):
        loss, (metrics, _) = JT.loss_fn(pp, jcfg, jtc, _jb(b), None,
                                        tuple(jnp.asarray(s) for s in states))
        return loss, metrics

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = CV.train_params_to_torch(p)
    tl, (tm, new_states) = T.loss_fn(tp, tcfg, ttc, _tb(b), None,
                                     tuple(_t(s) for s in states))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    assert new_states[0].shape == (4, 32) and new_states[1].shape == (4, 16)
    _assert_grads(tp, jg)


def test_kernel_path_numerics_close_to_f32_path():
    """gru_impl="kernel" on the CPU (the kernel's plain version, bf16
    operands) against "scan" (plain f32): the bound of the JAX package's
    test_training_forward_kernel_vs_scan (loss 2e-2, gradients 5e-2)."""
    p, _ = _params()
    b = fake_batch(4)
    res = {}
    for impl in ("scan", "kernel"):
        tp = CV.train_params_to_torch(p)
        loss, _ = T.loss_fn(tp, TCFG, T.TrainConfig(), _tb(b), None,
                            gru_impl=impl)
        loss.backward()
        res[impl] = (float(loss), CV.grads_to_numpy(tp))
    assert abs(res["kernel"][0] - res["scan"][0]) < 2e-2 * max(
        1.0, abs(res["scan"][0]))
    for k, a in res["scan"][1].items():
        scale = max(1e-3, float(np.abs(a).max()))
        assert float(np.abs(res["kernel"][1][k] - a).max()) / scale < 0.05, k
    with pytest.raises(ValueError):
        M.training_forward(CV.params_to_torch(p), TCFG, _t(b["sig_in"]),
                           _t(b["features"]), _t(b["periods"]),
                           lpc=_t(b["lpc"]), gru_impl="pallas")


def test_training_noise_comes_from_the_generator():
    p, _ = _params()
    tp = CV.params_to_torch(p)
    b = _tb(fake_batch(5))
    run = lambda g: M.training_forward(
        tp, TCFG, b["sig_in"], b["features"], b["periods"], lpc=b["lpc"],
        rng=g)["tree_probs"]
    a = run(torch.Generator().manual_seed(1))
    c = run(torch.Generator().manual_seed(1))
    d = run(torch.Generator().manual_seed(2))
    clean = run(None)
    assert torch.equal(a, c) and not torch.equal(a, d)
    assert not torch.equal(a, clean)
    off = M.training_forward(tp, TCFG, b["sig_in"], b["features"],
                             b["periods"], lpc=b["lpc"], training=False,
                             rng=torch.Generator().manual_seed(1))
    assert torch.equal(off["tree_probs"], clean)


# --------------------------------------------------------------------------
# init, sparsify, constraints, optimizer
# --------------------------------------------------------------------------

def test_init_params_distributions():
    """The initializer families of lpcnet_tpu/nn/init.py: glorot-uniform
    limits and variance, per-gate orthogonal recurrents, the PCM ramp, zero
    biases, unit DualFC factors, and the JAX package's shapes."""
    cfg = M.LPCNetConfig()
    p = _np_tree(M.init_params(cfg, seed=1))
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(1),
                                               JM.LPCNetConfig()))
    assert (jax.tree.map(lambda a: a.shape, p)
            == jax.tree.map(lambda a: a.shape, jp))
    k = p["gru_a"]["kernel"]
    lim = np.sqrt(6.0 / (k.shape[0] + k.shape[1]))
    assert np.abs(k).max() <= lim and np.abs(k).max() > 0.99 * lim
    np.testing.assert_allclose(k.std(), lim / np.sqrt(3), rtol=2e-2)
    c = p["feature_conv1"]["kernel"]                   # [k, in, out]
    lim = np.sqrt(6.0 / (c.shape[0] * (c.shape[1] + c.shape[2])))
    assert np.abs(c).max() <= lim
    np.testing.assert_allclose(c.std(), lim / np.sqrt(3), rtol=3e-2)
    d = p["dual_fc"]["kernel"]                         # fans: in, out
    assert np.abs(d).max() <= np.sqrt(6.0 / (16 + 256))
    for name, n in (("gru_a", 384), ("gru_b", 16)):
        r = p[name]["recurrent"]
        for g in range(3):
            blk = r[:, g * n:(g + 1) * n]
            np.testing.assert_allclose(blk.T @ blk, np.eye(n), atol=1e-4)
        assert not p[name]["bias"].any()
    assert np.all(p["dual_fc"]["factor"] == 1) and not p["dual_fc"]["bias"].any()
    e = p["embed_sig"]["table"]
    ramp = 0.1 * np.sqrt(12) * (np.arange(256) - 127.5) / 256
    np.testing.assert_allclose(e.mean(axis=1), ramp, atol=0.04)
    np.testing.assert_allclose((e - ramp[:, None]).std(), 0.1, rtol=3e-2)
    assert np.abs(p["embed_pitch"]["table"]).max() <= 0.05


SCHEDS = {
    "gru_a": (S.SparsifySchedule.from_scratch_gru_a, JS.SparsifySchedule.from_scratch_gru_a),
    "quant": (lambda: S.SparsifySchedule.quantize_finetune((0.1, 0.1, 0.3), 0.01),
              lambda: JS.SparsifySchedule.quantize_finetune((0.1, 0.1, 0.3), 0.01)),
}


@pytest.mark.parametrize("step", [2000, 2400, 11000, 20000, 25000])
def test_apply_schedules_matches_jax(step):
    """Same weights, same steps: the pruned matrices (so the masks) and the
    schedule arithmetic are exact."""
    cfg = dict(TINY, rnn_units1=64)
    p, jp = _params(M.LPCNetConfig(**cfg), seed=8)
    tp = CV.params_to_torch(p)
    sa, jsa = S.SparsifySchedule.from_scratch_gru_a(), JS.SparsifySchedule.from_scratch_gru_a()
    sb = S.SparsifySchedule.from_scratch_gru_b((0.5, 0.5, 0.8))
    jsb = JS.SparsifySchedule.from_scratch_gru_b((0.5, 0.5, 0.8))
    assert sa.active(step) == jsa.active(step)
    for k in range(3):
        assert sa.current_density(step, k) == jsa.current_density(step, k)
    want = JS.apply_schedules(jp, step, jsa, jsb, 64)
    got = S.apply_schedules(tp, step, sa, sb, 64)
    for name, leaf in (("gru_a", "recurrent"), ("gru_b", "kernel")):
        g, w = got[name][leaf].numpy(), np.asarray(want[name][leaf])
        assert np.array_equal(g == 0, w == 0), (name, step)
        np.testing.assert_array_equal(g, w)
    assert got["gru_a"]["kernel"] is tp["gru_a"]["kernel"]


@pytest.mark.parametrize("step", [50, 150, 400])
def test_quantize_schedule_matches_jax(step):
    p, jp = _params(seed=9)
    tp = CV.params_to_torch(p)
    sq = S.SparsifySchedule.quantize_finetune((1.0, 1.0, 1.0), 0.01)
    jsq = JS.SparsifySchedule.quantize_finetune((1.0, 1.0, 1.0), 0.01)
    assert (sq.t_start, sq.t_end, sq.interval) == (jsq.t_start, jsq.t_end, jsq.interval)
    want = JS.apply_schedules(jp, step, jsq, jsq, 32)
    got = S.apply_schedules(tp, step, sq, sq, 32)
    np.testing.assert_allclose(got["gru_a"]["recurrent"].numpy(),
                               np.asarray(want["gru_a"]["recurrent"]),
                               atol=1e-7)
    w = got["gru_a"]["recurrent"].numpy() * 128
    if step >= sq.t_end:
        np.testing.assert_allclose(w, np.round(w), atol=1e-4)


def test_weight_clip_and_constraints_match_jax():
    rs = np.random.RandomState(10)
    w = (rs.randn(16, 48) * 0.8).astype(np.float32)
    got = S.weight_clip_constraint(_t(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JS.weight_clip_constraint(jnp.asarray(w))), rtol=1e-6)
    assert np.all(np.abs(got[:, 0::2]) + np.abs(got[:, 1::2]) <= 2 * 0.992 + 1e-6)
    p, jp = _params(seed=11)
    p["gru_b"]["kernel"] = p["gru_b"]["kernel"] * 20
    jp = jax.tree.map(jnp.asarray, p)
    want = JT.apply_constraints(jp)
    got = T.apply_constraints(CV.params_to_torch(p))
    for k, v in JC.flatten_tree(want).items():
        np.testing.assert_allclose(CV.params_to_numpy(got)[k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("quantize", [False, True], ids=["scratch", "quantize"])
def test_optimizer_three_updates_match_optax(quantize):
    """Adam(b1 .5, b2 .8, eps 1e-7) with lr/(1 + decay t), t counted from 0:
    three updates from the same gradients, parameters equal after each."""
    kw = dict(lr=1e-2, decay=0.5, quantize=quantize)
    jtc, ttc = JT.TrainConfig(**kw), T.TrainConfig(**kw)
    rs = np.random.RandomState(12)
    p0 = {"a": rs.randn(5, 3).astype(np.float32), "b": {"c": rs.randn(7).astype(np.float32)}}
    grads = [{"a": rs.randn(5, 3).astype(np.float32), "b": {"c": rs.randn(7).astype(np.float32)}}
             for _ in range(3)]
    jopt = JT.make_optimizer(jtc)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = CV.train_params_to_torch(p0)
    topt, tsched = T.make_optimizer(ttc, tp)
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp["a"].grad, tp["b"]["c"].grad = _t(g["a"]), _t(g["b"]["c"])
        topt.step()
        tsched.step()
        np.testing.assert_allclose(tp["a"].detach().numpy(), np.asarray(jp["a"]),
                                   rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(tp["b"]["c"].detach().numpy(),
                                   np.asarray(jp["b"]["c"]), rtol=2e-6, atol=1e-7)
    lr0 = 3e-5 if quantize else 1e-2
    decay = 0.0 if quantize else 0.5
    np.testing.assert_allclose(topt.param_groups[0]["lr"],
                               lr0 / (1 + decay * 3), rtol=1e-12)


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus in dump_data's file format from a seed: interleaved int16
    (sig_in, sig_out) pairs and rows of 36 float32 features."""
    d = tmp_path_factory.mktemp("corpus")
    rs = np.random.RandomState(13)
    cf, chunks = 4, 13      # the device loaders need chunks of >= 4 frames
    frames = chunks * cf + 8
    feats = (rs.randn(frames, 36) * 0.3).astype(np.float32)
    feats[:, 18] = rs.uniform(-1.2, 1.9, frames)
    feats[:, 20:36] = np.tanh(rs.randn(frames, 16) * 0.2) * 0.4
    pcm = np.clip(np.cumsum(rs.randn(chunks * cf * 160 + 1000, 1), 0) * 50
                  + rs.randn(chunks * cf * 160 + 1000, 2) * 20,
                  -30000, 30000).astype(np.int16)
    fpath, ppath = str(d / "features.f32"), str(d / "data.s16")
    feats.tofile(fpath)
    pcm.tofile(ppath)
    return ppath, fpath, cf


@pytest.mark.parametrize("e2e", [False, True], ids=["lpc", "rc"])
@pytest.mark.parametrize("lookahead", [2, 0])
def test_host_loader_matches_jax(corpus, e2e, lookahead):
    ppath, fpath, cf = corpus
    kw = dict(batch_size=4, chunk_frames=cf, lookahead=lookahead, e2e=e2e,
              seed=3, holdout_batches=1)
    jl, tl = JD.LPCNetLoader(ppath, fpath, **kw), D.LPCNetLoader(ppath, fpath, **kw)
    assert len(jl) == len(tl) == 2 and tl.holdout_batches == 1
    assert np.array_equal(jl.indices, tl.indices)
    for a, b in list(zip(jl, tl)) + list(zip(jl.val_batches(), tl.val_batches())):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tl.on_epoch_end()
    jl.on_epoch_end()
    assert np.array_equal(jl.indices, tl.indices)


@pytest.mark.parametrize("e2e", [False, True], ids=["lpc", "rc"])
def test_device_loader_matches_jax_and_host(corpus, e2e):
    ppath, fpath, cf = corpus
    kw = dict(batch_size=4, chunk_frames=cf, lookahead=2, e2e=e2e, seed=3,
              holdout_batches=1)
    jl = JD.DeviceLPCNetLoader(ppath, fpath, **kw)
    tl = D.DeviceLPCNetLoader(ppath, fpath, device="cpu", **kw)
    hl = D.LPCNetLoader(ppath, fpath, **kw)
    assert len(jl) == len(tl) and np.array_equal(jl.indices, tl.indices)
    for a, b, h in list(zip(jl, tl, hl)) + list(
            zip(jl.val_batches(), tl.val_batches(), hl.val_batches())):
        for k in a:
            got = b[k].numpy()
            assert got.shape == np.asarray(a[k]).shape, k
            tol = 1e-5 if k == "rc" else 0
            np.testing.assert_allclose(got, np.asarray(a[k]), atol=tol, err_msg=k)
            np.testing.assert_allclose(got, h[k], atol=tol, err_msg=k)
    assert all(v.device.type == "cpu" for v in tl[0].values())


def test_lpc2rc_matches_jax():
    rs = np.random.RandomState(14)
    lpc = (rs.randn(3, 5, 16) * 0.05).astype(np.float32)
    want = JD.lpc2rc_np(lpc)
    np.testing.assert_array_equal(D.lpc2rc(lpc), want)
    np.testing.assert_allclose(D.lpc2rc(_t(lpc)).numpy(), want, atol=1e-6)


# --------------------------------------------------------------------------
# checkpoints and the Trainer
# --------------------------------------------------------------------------

def _trainer(**kw):
    tc = T.TrainConfig(batch_size=4, chunk_frames=3, **kw)
    return T.Trainer(TCFG, tc, seed=2, device="cpu")


def test_trainer_loss_decreases_and_constraints_hold():
    tr = _trainer()
    before = CV.params_to_numpy(tr.params)
    batch = fake_batch(0)
    g = torch.Generator().manual_seed(0)
    losses = [float(tr.train_step(batch, g)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.1, losses
    after = CV.params_to_numpy(tr.params)
    assert all(not np.array_equal(before[k], after[k]) for k in before
               if "bias" not in k and "factor" not in k)
    for name, leaf in (("gru_a", "recurrent"), ("gru_b", "kernel"), ("gru_b", "recurrent")):
        w = tr.params[name][leaf].detach().abs()
        assert float((w[:, 0::2] + w[:, 1::2]).max()) <= 2 * 0.992 + 1e-6
    assert tr.step == 6 and all(p.requires_grad for p in T._leaves(tr.params))
    # lr/(1 + decay t) after 6 updates
    np.testing.assert_allclose(tr.optimizer.param_groups[0]["lr"],
                               1e-3 / (1 + 5e-5 * 6), rtol=1e-12)


@pytest.mark.parametrize("arm", ["ss_prob", "ss_hide_exc", "ss_distill", "e2e"])
def test_trainer_arms_stay_finite(arm):
    kw = {"ss_prob": dict(ss_prob=0.25),
          "ss_hide_exc": dict(ss_prob=0.25, ss_hide_exc=True),
          "ss_distill": dict(ss_prob=0.25, ss_distill=0.5),
          "e2e": {}}[arm]
    e2e = arm == "e2e"
    cfg = M.LPCNetConfig(**dict(TINY, e2e=e2e))
    tr = T.Trainer(cfg, T.TrainConfig(batch_size=4, chunk_frames=3, **kw),
                   seed=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = fake_batch(0, e2e=e2e)
    ms = [tr.train_step(batch, g) for _ in range(2)]
    assert all(np.isfinite(float(v)) for m in ms for v in m.values())
    assert ("distill_kl" in ms[0]) == (arm == "ss_distill")
    if arm == "ss_prob":
        with pytest.raises(ValueError):
            tr.train_step(batch, None)


def test_trainer_schedules_prune_in_step():
    """With a compressed schedule the sparsify transform runs inside
    train_step once the host step counter says so."""
    tr = _trainer(schedule_scale=0.0005, density=(0.25, 0.25, 0.5))
    assert tr.sched_a.t_end == 10 and not tr.sched_a.dense and tr.sched_b.dense
    g = torch.Generator().manual_seed(0)
    batch = fake_batch(0, frames=1)
    for _ in range(10):
        tr.train_step(batch, g)
    r = tr.params["gru_a"]["recurrent"].detach().numpy()
    off = r[:, :32][~np.eye(32, dtype=bool)]
    assert 0.6 < np.mean(off == 0) < 0.85
    assert np.all(np.diag(r[:, :32]) != 0)


def test_trainer_quantize_finetune_snaps_to_the_grid():
    """quantize=True: lr 3e-5 without decay, the quantize schedule active at
    every step, and past t_end every pruned weight on the 1/128 grid."""
    tr = _trainer(quantize=True, schedule_scale=0.00005)
    assert tr.sched_a.quantize and tr.sched_a.t_end == 1
    g = torch.Generator().manual_seed(0)
    batch = fake_batch(0, frames=1)
    for _ in range(2):
        tr.train_step(batch, g)
    assert tr.optimizer.param_groups[0]["lr"] == 3e-5
    for name, leaf in (("gru_a", "recurrent"), ("gru_b", "kernel")):
        w = tr.params[name][leaf].detach().numpy() * 128
        np.testing.assert_allclose(w, np.round(w), atol=1e-4)


def test_trainer_ema_eval_and_full_state(tmp_path):
    tr = _trainer(ema_decay=0.9)
    g = torch.Generator().manual_seed(0)
    batch = fake_batch(0)
    p0 = CV.params_to_numpy(tr.params)
    for _ in range(2):
        tr.train_step(batch, g)
    ema, p2 = CV.params_to_numpy(tr.ema_params), CV.params_to_numpy(tr.params)
    k = "gru_a/kernel"
    assert not np.array_equal(ema[k], p2[k])
    assert np.abs(ema[k] - p0[k]).max() < np.abs(p2[k] - p0[k]).max()
    ev = tr.eval_loss([batch, batch])
    assert set(ev) == {"loss", "cel", "exc_sd"} and ev == tr.eval_loss([batch])
    assert tr.eval_loss([]) == {}
    assert np.isfinite(tr.eval_loss([batch], params=tr.ema_params)["loss"])

    path = str(tmp_path / "step_2")
    CK.save_train_state(path, tr.full_state(), tr.cfg)
    CK.save_train_state(str(tmp_path / "step_10"), tr.full_state(), tr.cfg)
    assert CK.latest_checkpoint(str(tmp_path)).endswith("step_10.npz")
    assert CK.latest_checkpoint(str(tmp_path / "none")) is None
    tr2 = _trainer(ema_decay=0.9)
    tr2.restore_full_state(CK.restore_train_state(path, tr2.full_state()))
    assert tr2.step == 2 and tr2._gru_states is not None
    np.testing.assert_array_equal(CV.params_to_numpy(tr2.ema_params)[k], ema[k])
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    m1, m2 = tr.train_step(batch, g1), tr2.train_step(batch, g2)
    assert float(m1["loss"]) == float(m2["loss"])
    a, b = CV.params_to_numpy(tr.params), CV.params_to_numpy(tr2.params)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # a state without an EMA re-seeds it from the restored parameters
    full = tr.full_state()
    del full["ema"]
    tr2.restore_full_state(full)
    np.testing.assert_array_equal(CV.params_to_numpy(tr2.ema_params)[k],
                                  CV.params_to_numpy(tr.params)[k])


def test_checkpoint_loads_in_both_packages(tmp_path):
    """A training checkpoint of the port is a model file of either package,
    and the parameters and gradients come back under the JAX leaf names."""
    tr = _trainer()
    tr.train_step(fake_batch(0), torch.Generator().manual_seed(0))
    path = str(tmp_path / "ckpt.npz")
    CK.save_train_state(path, tr.full_state(), tr.cfg)
    want = CV.params_to_numpy(tr.params)
    jparams, jcfg = JC.load_checkpoint(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tr.cfg)
    jflat = JC.flatten_tree({k: v for k, v in jparams.items() if k != "__train__"})
    assert set(jflat) == set(want) == set(CV.grads_to_numpy(tr.params))
    for k in want:
        np.testing.assert_array_equal(jflat[k], want[k])
    jfused, _ = japi.load_model(path)
    tfused, tcfg = api.load_model(path, device="cpu")
    assert tcfg == tr.cfg
    np.testing.assert_allclose(tfused["embed_sig_a"].numpy(),
                               np.asarray(jfused["embed_sig_a"]), atol=1e-5)
    # and a plain weights checkpoint the port's fit() writes
    save_checkpoint(str(tmp_path / "w.npz"), tr.params, tr.cfg)
    jp2, _ = JC.load_checkpoint(str(tmp_path / "w.npz"))
    np.testing.assert_array_equal(np.asarray(jp2["gru_b"]["kernel"]),
                                  want["gru_b/kernel"])
    tr3 = _trainer()
    tr3.set_params(CV.params_to_torch(jp2))
    np.testing.assert_array_equal(CV.params_to_numpy(tr3.params)["gru_a/bias"],
                                  want["gru_a/bias"])


def test_fit_and_main_run_on_a_corpus(corpus, tmp_path, capsys):
    ppath, fpath, cf = corpus
    tr = _trainer()
    loader = D.LPCNetLoader(ppath, fpath, batch_size=4, chunk_frames=cf)
    tr.fit(loader, epochs=1, log_every=1, checkpoint_path=str(tmp_path / "m"))
    assert tr.step == len(loader) and os.path.exists(tmp_path / "m_01.npz")
    assert "epoch 0 step 0: loss=" in capsys.readouterr().out
    out = str(tmp_path / "cli")
    rc = T.main([fpath, ppath, out, "--grua-size", "32", "--cond-size", "16",
                 "--epochs", "1", "--batch-size", "2", "--device", "cpu"])
    assert rc == 0 and os.path.exists(out + "_32_01.npz")
