"""The port's RDO-VAE trainer (`lpcnet_torch.train.train_rdovae`) against the
JAX package's, on the CPU: the dataset's batches, the weight clip, the
optimizer and schedule, one training step on JAX's weights with JAX's
soft-quantization noise fed in, and the trainer's contracts and files."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lpcnet_tpu.models import rdovae as JR
from lpcnet_tpu.parallel import mesh as pmesh
from lpcnet_tpu.train import train_rdovae as JT

from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.train import train_rdovae as TT
from lpcnet_torch.weights.convert import (params_to_numpy, params_to_torch,
                                          train_params_to_torch)

torch.set_num_threads(1)

TINY = dict(latent_dim=8, cond_size=16, cond_size2=12, state_dim=6,
            pvq_num_pulses=12, state_hidden=10)
JCFG, TCFG = JR.RDOVAEConfig(**TINY), RV.RDOVAEConfig(**TINY)


def _mesh():
    return pmesh.make_mesh(jax.devices("cpu")[:1])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def feature_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    p = str(tmp_path_factory.mktemp("rdovae") / "f.f32")
    (rng.randn(8 * 20, 36) * 0.3).astype(np.float32).tofile(p)
    return p


@pytest.fixture(scope="module")
def tiny():
    """JAX params (PRNGKey(0), a non-zero statistical table) as numpy."""
    jp = JR.init_params(jax.random.PRNGKey(0), JCFG)
    jp["statistical_model"]["quant_embedding"]["table"] = 0.3 * jax.random.normal(
        jax.random.PRNGKey(9), (JCFG.quant_levels, 6 * JCFG.latent_dim))
    return jax.tree.map(np.asarray, jp)


def test_dataset_matches_jax_and_holds_out(feature_file):
    """Batches of two epochs and val batches byte-identical to JAX's for the
    same file and seed; the val split's contract (test_rdovae.py)."""
    cfg, jcfg = RV.RDOVAEConfig(), JR.RDOVAEConfig()
    kw = dict(batch_size=2, sequence_length=8)
    jd = JT.RDOVAEDataset(feature_file, JT.RDOVAETrainConfig(**kw), jcfg, seed=3,
                          val_seqs=3)
    td = TT.RDOVAEDataset(feature_file, TT.RDOVAETrainConfig(**kw), cfg, seed=3,
                          val_seqs=3)
    assert td.num_sequences == jd.num_sequences == 17 and len(td) == len(jd) == 8
    for _ in range(2):
        for a, b in zip(jd, td):
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for q in (0, 4, 15):
        a, b = jd.val_batch(q), td.val_batch(q)
        for k in a:
            assert np.array_equal(a[k], b[k]), (q, k)
    vb0, vb1 = td.val_batch(4), td.val_batch(4)
    np.testing.assert_array_equal(vb0["features"], vb1["features"])
    assert vb0["features"].shape[0] == 3
    val_rows = td.features[17 * 8:]
    for batch in td:
        for seq in batch["features"]:
            assert not np.isin(seq[:, 0], val_rows[:, 0]).any()
    assert td.val_batch(12)["rate_lambda"][0, 0] > td.val_batch(4)["rate_lambda"][0, 0]


def test_clip_matches_jax(tiny):
    """The pairwise clip on every 2-D leaf, bit-equal to JAX's."""
    scaled = jax.tree.map(lambda a: a * 4.0, tiny)
    got = params_to_numpy(TT.clip_rdovae_weights(params_to_torch(scaled), 0.496))
    want = _flat(JT.clip_rdovae_weights(jax.tree.map(jnp.asarray, scaled), 0.496))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_optimizer_three_updates_match_optax():
    """Adam(0.9, 0.99, eps 1e-8) under lr/(1 + lr_decay t): three updates
    from the same gradients equal the JAX trainer's optax optimizer at
    rtol 2e-6."""
    kw = dict(lr=1e-2, lr_decay=0.5)
    jtr = JT.RDOVAETrainer(JCFG, JT.RDOVAETrainConfig(**kw), mesh=_mesh())
    rs = np.random.RandomState(12)
    p0 = {"a": rs.randn(5, 3).astype(np.float32),
          "b": {"c": rs.randn(7).astype(np.float32)}}
    grads = [{"a": rs.randn(5, 3).astype(np.float32),
              "b": {"c": rs.randn(7).astype(np.float32)}} for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jtr.optimizer.init(jp)
    tp = train_params_to_torch(p0)
    topt, tsched = TT.make_rdovae_optimizer(TT.RDOVAETrainConfig(**kw), tp)
    for g in grads:
        upd, jstate = jtr.optimizer.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp["a"].grad = torch.from_numpy(g["a"])
        tp["b"]["c"].grad = torch.from_numpy(g["b"]["c"])
        topt.step()
        tsched.step()
        for k, v in _flat(jp).items():
            np.testing.assert_allclose(params_to_numpy(tp)[k], v, rtol=2e-6,
                                       atol=1e-7, err_msg=k)


def _batch(seed, b=2, t=32, q=3):
    rs = np.random.RandomState(seed)
    return {"features": (rs.randn(b, t, 20) * 0.3).astype(np.float32),
            "rate_lambda": np.full((b, t // 2), 0.001, np.float32),
            "q_ids": np.full((b, t // 2), q, np.int32)}


def test_one_step_on_jax_weights_and_noise(tiny):
    """One train step from JAX's weights with JAX's soft-quant noise fed
    in: the loss within 1e-5 of JAX's rdovae_loss, and the updated params
    those of JAX's step (1e-5 of each leaf's scale)."""
    batch = _batch(5)
    tc = dict(lr=1e-3)
    jtr = JT.RDOVAETrainer(JCFG, JT.RDOVAETrainConfig(**tc), mesh=_mesh())
    jtr.state = JT.RDOVAETrainState(jax.tree.map(jnp.asarray, tiny),
                                    jtr.optimizer.init(jax.tree.map(jnp.asarray, tiny)),
                                    jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(6)
    jl, _ = JR.rdovae_loss(jax.tree.map(jnp.asarray, tiny),
                           *(jnp.asarray(batch[k]) for k in ("features", "rate_lambda",
                                                              "q_ids")),
                           key, JCFG)
    jm = jtr.train_step(batch, key)
    noise = np.array(jax.random.uniform(jax.random.split(key)[0],
                                          (2, 16, JCFG.latent_dim)))
    tr = TT.RDOVAETrainer(TCFG, TT.RDOVAETrainConfig(**tc), device="cpu")
    tr.set_params(tiny)
    tm = tr.train_step(batch, None, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(tm["total"]), float(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(tm["total"]), float(jm["total"]), atol=1e-5)
    got = params_to_numpy(tr.params)
    for k, v in _flat(jax.device_get(jtr.state.params)).items():
        scale = max(float(np.abs(v).max()), 1e-6)
        assert float(np.abs(got[k] - v).max()) <= 1e-5 * scale, k


def test_trainer_loss_falls_and_eval_is_deterministic(feature_file, tmp_path):
    """The loss falls over a few steps on a fixed batch; eval_step is
    deterministic; fit writes rdovae_metrics.jsonl and a checkpoint an
    epoch whose leaves are the trainer's params."""
    tr = TT.RDOVAETrainer(TCFG, TT.RDOVAETrainConfig(lr=3e-3), seed=1,
                          device="cpu")
    batch = _batch(7)
    g = torch.Generator().manual_seed(3)
    losses = [float(tr.train_step(batch, g)["total"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for k, v in params_to_numpy(tr.params).items():
        if v.ndim == 2:
            assert float((np.abs(v[:, 0::2]) + np.abs(v[:, 1::2])).max()) <= 2 * 0.496 + 1e-6, k
    m1, m2 = tr.eval_step(batch), tr.eval_step(batch)
    assert m1 == m2 and set(m1) >= {"total", "rate_loss", "dist_hard", "dist_soft"}

    tc = TT.RDOVAETrainConfig(batch_size=2, sequence_length=32)
    ds = TT.RDOVAEDataset(feature_file, tc, TCFG, val_seqs=1)
    ft = TT.RDOVAETrainer(TCFG, tc, device="cpu")
    ft.fit(ds, epochs=2, log_every=1, checkpoint_path=str(tmp_path / "rv"),
           logdir=str(tmp_path / "log"))
    recs = [json.loads(l) for l in open(tmp_path / "log" / "rdovae_metrics.jsonl")]
    assert len(recs) == 2 * len(ds) and "total" in recs[0]
    with np.load(tmp_path / "rv_02.npz") as d:
        for k, v in params_to_numpy(ft.params).items():
            np.testing.assert_array_equal(d[k], v)
    assert ft.eval_step(ds.val_batch(4))["total"] > 0


def test_trainer_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.RDOVAETrainer(TCFG)
