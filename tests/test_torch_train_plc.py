"""The port's PLC trainer (`lpcnet_torch.train.train_plc`) against the JAX
package's, on the CPU at a small config: the losses, their gradients
through `predict_sequence` on carried params, the optimizer and schedule,
the weight clip, both loaders, the trainer's contracts and its files."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import plc as JPM
from lpcnet_tpu.parallel import mesh as pmesh
from lpcnet_tpu.train import sparsify as JS
from lpcnet_tpu.train import train_plc as JP
from lpcnet_tpu.weights import checkpoint as JC

from lpcnet_torch.models import plc as PM
from lpcnet_torch.train import train_plc as TP
from lpcnet_torch.weights import checkpoint as TC
from lpcnet_torch.weights.convert import (grads_to_numpy, params_to_numpy,
                                          params_to_torch,
                                          train_params_to_torch)

torch.set_num_threads(1)

SMALL = dict(dense1_size=16, gru1_size=24, gru2_size=24)
JCFG, TCFG = JPM.PLCConfig(**SMALL), PM.PLCConfig(**SMALL)


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


def _jax_params(seed=0):
    return jax.tree.map(np.asarray, JPM.init_params(jax.random.PRNGKey(seed), JCFG))


def _batch(seed, b=4, t=16):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, 56).astype(np.float32) * 0.3
    lost = (rng.rand(b, t, 1) > 0.3).astype(np.float32)
    return {
        "plc_input": np.concatenate([feats * lost, lost], -1).astype(np.float32),
        "target": feats[:, :, 36:].astype(np.float32),
        "mask": (1 - lost).astype(np.float32),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A [burg 36 | features 20 | lpc 16] row file of 320 frames and a
    0/1 loss trace of 333 frames, from a seed."""
    d = tmp_path_factory.mktemp("plc")
    rng = np.random.RandomState(3)
    feats = (rng.randn(320, 72) * 0.3).astype(np.float32)
    fpath, lpath = str(d / "f.f32"), str(d / "l.s8")
    feats.tofile(fpath)
    (rng.rand(333) > 0.2).astype(np.int8).tofile(lpath)
    return fpath, lpath


def test_plc_loss_and_metrics_match_jax():
    """Within 1e-6 relative of JAX's on the same [B, T, 20] inputs, at both
    bias settings; the zero mask gives exactly 0."""
    rng = np.random.RandomState(0)
    y = rng.randn(3, 10, 20).astype(np.float32)
    pred = rng.randn(3, 10, 20).astype(np.float32)
    mask = (rng.rand(3, 10, 1) > 0.5).astype(np.float32)
    t = torch.from_numpy
    for alpha, bias in ((1.0, 0.0), (0.5, 2.0)):
        got = float(TP.plc_loss(t(y), t(mask), t(pred), alpha, bias))
        want = float(JP.plc_loss(jnp.asarray(y), jnp.asarray(mask),
                                 jnp.asarray(pred), alpha, bias))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    gm = TP.plc_metrics(t(y), t(mask), t(pred))
    wm = JP.plc_metrics(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(pred))
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6, err_msg=k)
    zero = torch.zeros(3, 10, 1)
    assert float(TP.plc_loss(t(y), zero, t(pred))) == 0.0
    assert float(TP.plc_loss(t(y), torch.ones(3, 10, 1), t(pred))) > 0.0


def test_plc_loss_gradients_match_jax():
    """The loss through predict_sequence from init_state on JAX's params
    carried across: the loss within 1e-6 relative, every gradient leaf
    within 1e-5 of its largest entry."""
    npp = _jax_params(1)
    batch = _batch(2)
    j = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        _, pred = JPM.predict_sequence(p, JPM.init_state(4, JCFG), j["plc_input"])
        return JP.plc_loss(j["target"], j["mask"], pred)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, npp))
    tp = train_params_to_torch(npp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, pred = PM.predict_sequence(tp, PM.init_state(4, TCFG), tb["plc_input"])
    tl = TP.plc_loss(tb["target"], tb["mask"], pred)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    tl.backward()
    got, want = grads_to_numpy(tp), _flat(jg)
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-12)
        assert float(np.abs(got[k] - v).max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("quantize", [False, True], ids=["scratch", "quantize"])
def test_plc_optimizer_three_updates_match_optax(quantize):
    """Adam(0.9, 0.99, eps 1e-7) under lr/(1 + decay t), and (3e-5, 0)
    with quantize: three updates from the same gradients equal the JAX
    trainer's optax optimizer at rtol 2e-6."""
    kw = dict(lr=1e-2, decay=0.5, quantize=quantize)
    jtr = JP.PLCTrainer(JCFG, JP.PLCTrainConfig(**kw), mesh=_mesh())
    rs = np.random.RandomState(12)
    p0 = {"a": rs.randn(5, 3).astype(np.float32),
          "b": {"c": rs.randn(7).astype(np.float32)}}
    grads = [{"a": rs.randn(5, 3).astype(np.float32),
              "b": {"c": rs.randn(7).astype(np.float32)}} for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jtr.optimizer.init(jp)
    tp = train_params_to_torch(p0)
    topt, tsched = TP.make_plc_optimizer(TP.PLCTrainConfig(**kw), tp)
    import optax
    for g in grads:
        upd, jstate = jtr.optimizer.update(jax.tree.map(jnp.asarray, g),
                                           jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp["a"].grad = torch.from_numpy(g["a"])
        tp["b"]["c"].grad = torch.from_numpy(g["b"]["c"])
        topt.step()
        tsched.step()
        for k, v in _flat(jp).items():
            np.testing.assert_allclose(params_to_numpy(tp)[k], v, rtol=2e-6,
                                       atol=1e-7, err_msg=k)


def test_plc_clip_matches_jax():
    """WeightClip(0.992) on both GRUs' kernels and recurrents, bit-equal to
    JAX's on a carried tree scaled so that the clip bites."""
    npp = jax.tree.map(lambda a: a * 3.0, _jax_params(4))
    got = params_to_numpy(TP.clip_plc_grus(params_to_torch(npp)))
    for g in ("plc_gru1", "plc_gru2"):
        for leaf in ("kernel", "recurrent"):
            want = np.asarray(JS.weight_clip_constraint(jnp.asarray(npp[g][leaf])))
            assert np.array_equal(got[f"{g}/{leaf}"], want), (g, leaf)
    np.testing.assert_array_equal(got["plc_dense1/kernel"],
                                  npp["plc_dense1"]["kernel"])


def test_plc_loader_matches_jax(files):
    """Every batch of two epochs and the val batch byte-identical to the
    JAX loader's for the same files and seed; the held-out sequences stay
    out of training."""
    fpath, lpath = files
    tc = TP.PLCTrainConfig(batch_size=2, seq_length=16)
    jl = JP.PLCLoader(fpath, lpath, JP.PLCTrainConfig(batch_size=2, seq_length=16),
                      seed=5, val_seqs=4)
    tl = TP.PLCLoader(fpath, lpath, tc, seed=5, val_seqs=4)
    # 320/16 = 20 sequences, 4 held out -> 16 train -> 8 batches of 2
    assert len(jl) == len(tl) == 8
    for _ in range(2):
        for a, b in zip(jl, tl):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        jl.on_epoch_end()
        tl.on_epoch_end()
    jv, tv = jl.val_batch(), tl.val_batch()
    for k in jv:
        assert np.array_equal(jv[k], tv[k]), k
    assert tv["plc_input"].shape == (4, 16, 57)
    v2 = tl.val_batch()
    assert all(np.array_equal(tv[k], v2[k]) for k in tv)


def test_plc_device_loader_contract(files):
    """The val batch byte-identical to the host loader's; the on-device
    batch keeps the host loader's mask, flag and target contract."""
    fpath, lpath = files
    tc = TP.PLCTrainConfig(batch_size=2, seq_length=16)
    host = TP.PLCLoader(fpath, lpath, tc, val_seqs=4)
    dev = TP.PLCDeviceLoader(fpath, lpath, tc, val_seqs=4, device="cpu")
    assert len(dev) == len(host)
    hv, dv = host.val_batch(), dev.val_batch()
    for k in hv:
        assert np.array_equal(hv[k], dv[k]), k

    feats_d, lost_d = dev.device_arrays
    sel = torch.tensor([0, 3])
    g = torch.Generator().manual_seed(7)
    b = dev.sample_fn(feats_d, lost_d, sel, g)
    x = b["plc_input"].numpy()
    f = feats_d.numpy()[sel.numpy()]
    flag = x[:, :, 56]
    lost = np.abs(flag)
    assert set(np.unique(flag)).issubset({-1.0, 0.0, 1.0})
    np.testing.assert_array_equal(b["mask"].numpy()[:, :, 0], 1.0 - lost)
    np.testing.assert_array_equal(x[:, :, 36:56], f[:, :, 36:56] * lost[:, :, None])
    burg_ok = (flag + 1.0) / 2.0
    np.testing.assert_array_equal(x[:, :, :36], f[:, :, :36] * (lost * burg_ok)[:, :, None])
    np.testing.assert_array_equal(b["target"].numpy(), f[:, :, 36:])
    # the generator makes the draws repeatable
    b2 = dev.sample_fn(feats_d, lost_d, sel, torch.Generator().manual_seed(7))
    assert all(torch.equal(b[k], b2[k]) for k in b)
    blocks = list(dev.index_blocks(3))
    assert len(blocks) == 2 and blocks[0].shape == (3, 2)


def test_plc_training_loss_decreases():
    tr = TP.PLCTrainer(TCFG, TP.PLCTrainConfig(batch_size=4, seq_length=16),
                       device="cpu")
    batch = _batch(1)
    losses = [float(tr.train_step(batch)["loss"]) for _ in range(25)]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    for g in ("plc_gru1", "plc_gru2"):
        for leaf in ("kernel", "recurrent"):
            w = tr.params[g][leaf].detach().abs()
            assert float((w[:, 0::2] + w[:, 1::2]).max()) <= 2 * 0.992 + 1e-6


def test_plc_eval_step_and_set_params(files):
    """eval_step is deterministic and leaves the params untouched; with
    JAX's params set, it equals the JAX trainer's eval_step."""
    fpath, lpath = files
    tc = TP.PLCTrainConfig(batch_size=2, seq_length=16)
    v = TP.PLCLoader(fpath, lpath, tc, val_seqs=4).val_batch()
    tr = TP.PLCTrainer(TCFG, tc, device="cpu")
    jtr = JP.PLCTrainer(JCFG, JP.PLCTrainConfig(batch_size=2, seq_length=16),
                        mesh=_mesh())
    tr.set_params(jax.tree.map(np.asarray, jtr.state.params))
    p0 = tr.params["plc_gru1"]["kernel"].detach().clone()
    m1, m2 = tr.eval_step(v), tr.eval_step(v)
    assert np.isfinite(m1["loss"]) and m1 == m2
    assert torch.equal(tr.params["plc_gru1"]["kernel"], p0)
    want = jtr.eval_step(v)
    assert set(want) == set(m1)
    for k in want:
        np.testing.assert_allclose(m1[k], want[k], rtol=1e-5, err_msg=k)


def test_plc_fit_log_and_checkpoints(files, tmp_path):
    """fit writes plc_metrics.jsonl and one checkpoint an epoch, which load
    in both packages to the trainer's params."""
    fpath, lpath = files
    tc = TP.PLCTrainConfig(batch_size=4, seq_length=16)
    loader = TP.PLCLoader(fpath, lpath, tc, val_seqs=4)
    tr = TP.PLCTrainer(TCFG, tc, device="cpu")
    tr.fit(loader, epochs=2, log_every=2, checkpoint_path=str(tmp_path / "plc"),
           logdir=str(tmp_path / "log"))
    recs = [json.loads(l) for l in open(tmp_path / "log" / "plc_metrics.jsonl")]
    assert len(recs) == 2 * len(loader)
    assert {"ts", "step", "epoch", "loss", "l1", "ceps", "band", "pitch"} <= set(recs[0])
    assert all(np.isfinite(r["loss"]) for r in recs)
    want = params_to_numpy(tr.params)
    for e in (1, 2):
        assert os.path.exists(tmp_path / f"plc_{e:02d}.npz")
    tparams, _ = TC.load_checkpoint(str(tmp_path / "plc_02.npz"))
    jparams, _ = JC.load_checkpoint(str(tmp_path / "plc_02.npz"))
    for k, v in want.items():
        np.testing.assert_array_equal(params_to_numpy(tparams)[k], v)
        np.testing.assert_array_equal(np.asarray(_flat(jparams)[k]), v)


def test_plc_entry_points_need_cuda_by_default(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fpath, lpath = files
    tc = TP.PLCTrainConfig(batch_size=2, seq_length=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.PLCTrainer(TCFG, tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.PLCDeviceLoader(fpath, lpath, tc)
