"""The port's codebook trainer (`lpcnet_torch.codec.codebooks`) against the
JAX package's, on the CPU: each function on fixed numpy-seeded inputs, the
whole trainer with the port's perturbations fed JAX's own draws, the JAX
package's five trainer gates at their bars, and the CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.codec import codebooks as J
from lpcnet_torch.codec import codebooks as C

torch.set_num_threads(1)


def _synthetic_features(n=4000, seed=0):
    """The JAX package's test corpus (tests/test_codebook_training.py):
    a random walk, so interpolation predictors differ from the mean."""
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randn(n, 36).astype(np.float32) * 0.25, axis=0)
    walk -= walk.mean(axis=0, keepdims=True)
    walk *= 0.5 / (walk.std() + 1e-6)
    return walk + rng.randn(n, 36).astype(np.float32) * 0.05


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module")
def corpus():
    f = _synthetic_features(2400, seed=9)
    ends = f[3:3 + 2396:4, :18]
    rs = np.random.RandomState(1)
    codes = ends[rs.permutation(len(ends))[:16], 1:]
    return f, ends, codes


def test_dist2_matches_jax(corpus):
    _, ends, codes = corpus
    want = np.asarray(J._dist2(jnp.asarray(ends[:, 1:]), jnp.asarray(codes)))
    got = C._dist2(_t(ends[:, 1:]), _t(codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(
        want).max())


def test_lloyd_matches_jax(corpus):
    _, ends, codes = corpus
    jc, je = J._lloyd(jnp.asarray(ends[:, 1:]), jnp.asarray(codes), 6)
    tc, te = C._lloyd(_t(ends[:, 1:]), _t(codes), 6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)


def test_lloyd_keeps_an_empty_cell():
    data = _t(np.zeros((5, 3)))
    codes = _t([[0, 0, 0], [9, 9, 9]])
    new, _ = C._lloyd(data, codes, 2)
    np.testing.assert_array_equal(new.numpy()[1], [9, 9, 9])


def test_lloyd_multi_sign_matches_jax(corpus):
    f, ends, _ = corpus
    mid = f[5:5 + 2392:4, :18]
    m = mid.shape[0]
    res = np.asarray(J._diff_residuals(jnp.asarray(mid),
                                       jnp.asarray(ends[:-1][:m]),
                                       jnp.asarray(ends[1:][:m])))
    rs = np.random.RandomState(2)
    codes = (rs.randn(16, 18) * 0.1).astype(np.float32)
    jc, je = J._lloyd_multi_sign(jnp.asarray(res), jnp.asarray(codes), 5)
    tc, te = C._lloyd_multi_sign(_t(res), _t(codes), 5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)


def test_diff_residuals_match_jax_exactly(corpus):
    f, ends, _ = corpus
    mid, left, right = f[5:405:4, :18], ends[:100], ends[1:101]
    want = np.asarray(J._diff_residuals(jnp.asarray(mid), jnp.asarray(left),
                                        jnp.asarray(right)))
    got = C._diff_residuals(_t(mid), _t(left), _t(right)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def shipped():
    return J.load_codebooks(), C.load_codebooks()


def test_beam_assign_and_refine_match_jax(corpus, shipped, monkeypatch):
    _, ends, _ = corpus
    jcb, tcb = shipped
    x = ends[:, 1:] * 3.0
    # chunks of 128 rows: the chunked beam must not change an index
    monkeypatch.setattr(C, "CHUNK", 128)
    jidx, jrec = J._beam_assign(jnp.asarray(x), jcb.stage1, jcb.stage2,
                                jcb.stage3)
    tidx, trec = C._beam_assign(_t(x), tcb.stage1, tcb.stage2, tcb.stage3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), atol=1e-5)
    jr = J._mbest_refine_once(jnp.asarray(x), jcb.stage1, jcb.stage2,
                              jcb.stage3)
    tr = C._mbest_refine_once(_t(x), tcb.stage1, tcb.stage2, tcb.stage3)
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_quantization_mse_on_shipped_books_matches_jax(shipped, monkeypatch):
    jcb, tcb = shipped
    feats = _synthetic_features(3000, seed=6) * 4.0
    monkeypatch.setattr(C, "CHUNK", 256)
    want = J.quantization_mse(feats, jcb)
    got = C.quantization_mse(feats, tcb)
    for k in ("stage_mse", "diff_mse"):
        assert _rel(got[k], want[k]) <= 1e-5, (k, got[k], want[k])


def _jax_draws(key, stage_codes, diff_codes):
    """The trainer's uniform draws in the JAX package's key order."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    out = []
    for k in (k1, k2, k3):
        e = 1
        while e < stage_codes:
            k, sub = jax.random.split(k)
            out.append(np.asarray(jax.random.uniform(sub, (e, 17))))
            e <<= 1
    k, sub = jax.random.split(k4)
    out.append(np.asarray(jax.random.uniform(sub, (4, 18))))
    e = 4
    while e < diff_codes:
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(sub, (e, 18))))
        e <<= 1
    return out


def test_train_codebooks_matches_jax_on_its_draws(monkeypatch):
    feats = _synthetic_features()
    kw = dict(stage_codes=32, diff_codes=32, mbest_refine=2)
    want = J.train_codebooks(feats, **kw)
    draws = _jax_draws(jax.random.PRNGKey(0), 32, 32)

    def feed(generator, shape, device):
        d = draws.pop(0)
        assert d.shape == tuple(shape)
        return torch.from_numpy(d.copy()).to(device)

    monkeypatch.setattr(C, "_uniform", feed)
    got = C.train_codebooks(feats, device="cpu", **kw)
    assert not draws
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    jm, tm = J.quantization_mse(feats, want), C.quantization_mse(feats, got)
    for k in jm:
        assert _rel(tm[k], jm[k]) <= 1e-3, (k, tm[k], jm[k])


# -- the JAX package's gates (tests/test_codebook_training.py), on the port --

def test_trained_beats_random_init():
    feats = _synthetic_features()
    cb = C.train_codebooks(feats, stage_codes=32, diff_codes=32,
                           mbest_refine=2, device="cpu")
    rng = np.random.RandomState(1)
    ends = feats[3::4, 1:18]
    sel = rng.permutation(len(ends))[:32]
    rand = C.Codebooks(_t(ends[sel]), _t(ends[sel] * 0.1),
                       _t(ends[sel] * 0.01),
                       _t(np.tile(feats[5::4, :18][:8], (4, 1))))
    trained = C.quantization_mse(feats, cb)
    baseline = C.quantization_mse(feats, rand)
    assert trained["stage_mse"] < baseline["stage_mse"]
    assert trained["diff_mse"] < baseline["diff_mse"]
    assert np.isfinite(trained["stage_mse"]) and trained["stage_mse"] > 0


def test_mbest_refine_does_not_hurt():
    feats = _synthetic_features(n=3000, seed=2)
    kw = dict(stage_codes=16, diff_codes=16, device="cpu")
    cb0 = C.train_codebooks(feats, mbest_refine=0, **kw)
    cb4 = C.train_codebooks(feats, mbest_refine=4, **kw)
    m0, m4 = C.quantization_mse(feats, cb0), C.quantization_mse(feats, cb4)
    assert m4["stage_mse"] <= m0["stage_mse"] * 1.001


def test_diff_group_structure_preserved():
    """Entry i of a trained diff book serves predictor group i & 3: its
    update only ever averages residuals of that group, so a corpus whose
    four groups sit far apart leaves every entry nearest its own group."""
    rs = np.random.RandomState(3)
    offs = np.zeros((4, 18), np.float32)
    offs[2, :9] = 6.0                      # the left predictor's group
    offs[3, 9:] = 6.0                      # the right predictor's group
    res = (rs.randn(800, 4, 18) * 0.3).astype(np.float32)
    res += offs[None]
    res[:, 1] = res[:, 0]                  # groups 0 and 1: the mean
    codes = C._train_multi_sign(_t(res), 32, torch.Generator().manual_seed(0))
    codes = codes.numpy()
    for i in range(32):
        means = res.mean(0)                # [4, 18]
        d = ((np.abs(codes[i])[None] - np.abs(means)) ** 2).sum(1)
        assert d[i & 3] <= d.min() + 1e-6, i
    f = _synthetic_features(n=3000, seed=3)[:, :18]
    ends, mid = f[3:2999:4], f[5:2995:4]
    r = C._diff_residuals(_t(mid), _t(ends[:-1][:len(mid)]),
                          _t(ends[1:][:len(mid)])).numpy()
    np.testing.assert_allclose(r[:, 0], r[:, 1], atol=1e-6)
    np.testing.assert_allclose(r[:, 2], mid - ends[:-1][:len(mid)],
                               atol=1e-5)
    np.testing.assert_allclose(r[:, 3], mid - ends[1:][:len(mid)],
                               atol=1e-5)


def test_sign_folding_used():
    rng = np.random.RandomState(4)
    centers = rng.randn(8, 18).astype(np.float32) * 3.0
    idx = rng.randint(0, 8, 512)
    sign = rng.choice([-1.0, 1.0], 512).astype(np.float32)
    base = centers[idx] * sign[:, None]
    base += rng.randn(512, 18).astype(np.float32) * 0.05
    res = np.tile(base[:, None, :], (1, 4, 1))
    codes = C._train_multi_sign(_t(res), 8, torch.Generator().manual_seed(0))
    codes = codes.numpy()
    cross = np.einsum("nd,kd->nk", res[:, 0], codes)
    rsq = np.sum(res[:, 0] ** 2, axis=1, keepdims=True)
    csq = np.sum(codes ** 2, axis=1)
    d_signed = np.minimum(rsq - 2 * cross + csq, rsq + 2 * cross + csq)
    d_unsigned = rsq - 2 * cross + csq
    assert d_signed.min(axis=1).mean() < 0.25 * d_unsigned.min(axis=1).mean()


def test_lbg_monotone_improvement():
    feats = _synthetic_features(n=2000, seed=5)
    x = _t(feats[3::4, 1:18])
    quick = C._lbg_train(x, 16, torch.Generator().manual_seed(0),
                         split_updates=1, final_updates=1)
    full = C._lbg_train(x, 16, torch.Generator().manual_seed(0),
                        split_updates=4, final_updates=20)
    mse = lambda codes: float(C._dist2(x, codes).min(1).values.mean())
    assert mse(full) <= mse(quick) * 1.001


def test_cli_round_trip(tmp_path, capsys):
    feats = _synthetic_features(n=1200, seed=8)
    fpath, out = tmp_path / "f.f32", tmp_path / "cb.npz"
    feats.tofile(fpath)
    assert C.main([str(fpath), str(out), "--split-updates", "1",
                   "--final-updates", "2", "--mbest-refine", "1",
                   "--eval", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "trained codebooks from 1200 frames" in text
    assert "trained:" in text and "shipped:" in text
    cb = C.load_codebooks(str(out))
    assert [tuple(b.shape) for b in cb] == [(1024, 17)] * 3 + [(4096, 18)]
    assert all(torch.isfinite(b).all() for b in cb)


def test_train_codebooks_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C.train_codebooks(_synthetic_features(n=100))
