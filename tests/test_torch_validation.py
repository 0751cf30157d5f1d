"""The port's held-out validator (`lpcnet_torch.train.validation`) against the
JAX package's, on the CPU at test_validation.py's config and clips: the
analysis features, the synthesis, the metrics on carried params, the
validator's own contracts, BestTracker, and `Trainer.fit` with a
validator, a metrics log and a best checkpoint."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.train.validation import HeldOutValidator as JHeldOutValidator
from lpcnet_tpu.weights import checkpoint as JC

from lpcnet_torch.kernels import masked_loop as ML
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.train import train_lpcnet as T
from lpcnet_torch.train.data import LPCNetLoader
from lpcnet_torch.train.validation import BestTracker, HeldOutValidator
from lpcnet_torch.weights import checkpoint as TC
from lpcnet_torch.weights.convert import params_to_numpy, params_to_torch

torch.set_num_threads(1)

KW = dict(rnn_units1=32, rnn_units2=8, cond_size=16)
JCFG, TCFG = JM.LPCNetConfig(**KW), M.LPCNetConfig(**KW)


def _clip(seed, seconds=0.5):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000))
    x = 3000 * np.sin(2 * np.pi * 150 * t / 16000)
    x += 200 * rng.randn(len(t))
    return x.astype(np.int16)


def _jax_params(seed):
    return jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), JCFG))


@pytest.fixture(scope="module")
def runs():
    """Both validators on the same clips (4 segments of 25 frames) and the
    port's results on JAX's params for seeds 0 and 7, each computed once."""
    clips = [_clip(1), _clip(2)]
    jv = JHeldOutValidator(JCFG, clips, seg_seconds=0.25)
    tv = HeldOutValidator(TCFG, clips, seg_seconds=0.25, device="cpu")
    p0, p7 = _jax_params(0), _jax_params(7)
    t0 = params_to_torch(p0)
    return {
        "jv": jv, "tv": tv, "p0": p0,
        "syn0": tv.synthesize(t0),
        "m0": tv.evaluate(t0), "m0_again": tv.evaluate(t0),
        "m7": tv.evaluate(params_to_torch(p7)),
        "per_clip0": tv.evaluate_per_clip(t0),
    }


def test_analysis_features_match_jax(runs):
    jf = np.asarray(runs["jv"]._features)
    tf = runs["tv"].features.numpy()
    assert tf.shape == jf.shape == (4, 25, 36)
    np.testing.assert_allclose(tf, jf, atol=1e-4)


def test_synthesis_first_samples_match_jax(runs):
    """The first 32 samples of each segment's first frame at least 98 %
    exact against the JAX validator's scan on the same params."""
    js = np.asarray(runs["jv"]._synth(runs["p0"], runs["jv"]._features))
    ts = runs["syn0"]
    assert ts.shape == js.shape == (4, 4000)
    for i in range(4):
        assert float(np.mean(ts[i, :32] == js[i, :32])) >= 0.98, i
    assert np.isfinite(ts).all() and np.abs(ts).max() <= 32767


def test_metrics_match_jax(runs):
    """evaluate's three metrics within 0.1 dB of JAX's on carried params."""
    want = runs["jv"].evaluate(runs["p0"])
    got = runs["m0"]
    assert set(got) == set(want) == {"band_lsd_db", "mcd_db", "fwsegsnr_db"}
    for k in want:
        assert abs(got[k] - want[k]) <= 0.1, (k, got[k], want[k])


def test_validator_deterministic(runs):
    m1, m2 = runs["m0"], runs["m0_again"]
    for k in m1:
        assert np.isfinite(m1[k])
        assert m1[k] == m2[k], f"eval must be deterministic ({k})"


def test_validator_discriminates(runs):
    assert runs["m0"]["band_lsd_db"] != runs["m7"]["band_lsd_db"]


def test_validator_per_clip(runs):
    per_clip = runs["per_clip0"]
    assert len(per_clip) == 2
    np.testing.assert_allclose(np.mean([c["band_lsd_db"] for c in per_clip]),
                               runs["m0"]["band_lsd_db"], rtol=1e-6)


def test_validator_rejects_short_clip_and_needs_cuda(monkeypatch):
    with pytest.raises(ValueError, match="too short"):
        HeldOutValidator(TCFG, [_clip(1, 0.1)], seg_seconds=0.25, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HeldOutValidator(TCFG, [_clip(1)], seg_seconds=0.25)


def test_validator_packs_the_kernel_bundle_once_a_call(monkeypatch):
    """The kernel path's f32 bundle carries the sample loop's packs
    (`masked_kernel_weights`: GRU-A's f32 rank pack, no GRU-B pack), built
    once a `synthesize` call and launched with every frame. Run on CPU
    tensors, where the kernel wrapper takes its plain version."""
    tv = HeldOutValidator(TCFG, [_clip(1)], seg_seconds=0.25, device="cpu")
    tv.use_kernel = True
    built, seen = [], []
    real_pack, real_k1 = K.masked_kernel_weights, K.synthesize_frame_kernel
    monkeypatch.setattr(K, "masked_kernel_weights",
                        lambda kw: built.append(1) or real_pack(kw))

    def k1(kw, *args, **kwargs):
        seen.append(kw)
        return real_k1(kw, *args, **kwargs)
    monkeypatch.setattr(K, "synthesize_frame_kernel", k1)
    params = M.init_params(TCFG, seed=3)
    syn = tv.synthesize(params)
    tv.synthesize(params)
    frames = syn.shape[1] // 160
    assert len(built) == 2 and len(seen) == 2 * frames
    assert all(kw is seen[0] for kw in seen[:frames]) and seen[frames] is not seen[0]
    kw = seen[0]
    assert kw["a_rec"].dtype == torch.float32 and kw["k2_b"] is None
    assert tuple(kw["k2_a"].shape) == ML.packed_shapes(0, 32, 8)[0]
    assert torch.equal(kw["k2_a"], ML.pack_gru_a(kw["a_rec"]))


def test_best_tracker():
    bt = BestTracker()
    assert bt.update(10, {"band_lsd_db": 5.0})
    assert not bt.update(20, {"band_lsd_db": 6.0})
    assert bt.update(30, {"band_lsd_db": 4.5})
    assert bt.best_step == 30 and bt.best == 4.5


def _corpus(d, chunks=5, cf=3):
    """A corpus in dump_data's file format from a seed."""
    rs = np.random.RandomState(13)
    frames = chunks * cf + 8
    feats = (rs.randn(frames, 36) * 0.3).astype(np.float32)
    feats[:, 18] = rs.uniform(-1.2, 1.9, frames)
    feats[:, 20:36] = np.tanh(rs.randn(frames, 16) * 0.2) * 0.4
    n = chunks * cf * 160 + 500
    pcm = np.clip(np.cumsum(rs.randn(n, 1), 0) * 50 + rs.randn(n, 2) * 20,
                  -30000, 30000).astype(np.int16)
    fpath, ppath = str(d / "features.f32"), str(d / "data.s16")
    feats.tofile(fpath)
    pcm.tofile(ppath)
    return ppath, fpath


def test_fit_with_validator_log_and_best_checkpoint(tmp_path, capsys):
    """fit(val_every=2) with the EMA on, 2 steps: val_raw and val_ema records beside
    the step records in lpcnet_metrics.jsonl, and a best checkpoint that
    loads in both packages to one of the evaluated candidates."""
    ppath, fpath = _corpus(tmp_path, chunks=4)
    tc = T.TrainConfig(batch_size=2, chunk_frames=3, ema_decay=0.5)
    loader = LPCNetLoader(ppath, fpath, batch_size=2, chunk_frames=3)
    n = len(loader)
    assert n == 2
    val = HeldOutValidator(TCFG, [_clip(4, 0.25)], seg_seconds=0.25, device="cpu")
    tr = T.Trainer(TCFG, tc, device="cpu")
    best = str(tmp_path / "best.npz")
    tr.fit(loader, epochs=1, log_every=1, logdir=str(tmp_path / "log"),
           validator=val, val_every=2, best_checkpoint_path=best)
    out = capsys.readouterr().out
    assert "step 2: val raw=" in out and "ema=" in out and "(best " in out
    recs = [json.loads(l) for l in open(tmp_path / "log" / "lpcnet_metrics.jsonl")]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    kinds = [(r["step"], r["kind"]) for r in recs if "kind" in r]
    assert kinds == [(2, "val_raw"), (2, "val_ema")]
    assert all(np.isfinite(r["band_lsd_db"]) for r in recs if "kind" in r)
    assert os.path.exists(best)
    tparams, tcfg = TC.load_checkpoint(best)
    jparams, jcfg = JC.load_checkpoint(best)
    assert tcfg == TCFG and jcfg == JCFG
    flat_t = params_to_numpy(tparams)
    flat_j = JC.flatten_tree(jax.device_get(jparams))
    assert set(flat_t) == set(flat_j) == set(params_to_numpy(tr.params))
    for k in flat_t:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    assert np.isfinite(val.evaluate(tparams)["band_lsd_db"])
