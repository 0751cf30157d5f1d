"""The port's scheduled-sampling machinery (`train/scheduled.py`) vs the JAX
package, on the CPU at a small config: the closed-form de-emphasis, the
history mixing rule, the free-running pass under teacher-force masks, and
the loss with `ss_prob > 0`. The sampler's KISS99 seeds come from a
torch.Generator here and from jax.random there, so sampled trajectories are
compared where they do not depend on the seeds (all teacher-forced) and by
their properties elsewhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.train import scheduled as JSS

from lpcnet_torch.dsp.constants import PREEMPHASIS
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.train import scheduled as SS
from lpcnet_torch.train import train_lpcnet as T

torch.set_num_threads(1)

TINY = dict(rnn_units1=32, rnn_units2=16, cond_size=16, pitch_embed_dim=8)
JCFG, TCFG = JM.LPCNetConfig(**TINY), M.LPCNetConfig(**TINY)


def _t(a):
    return torch.from_numpy(np.array(a))


def fake_batch(seed, b=4, frames=3):
    """A training-shaped batch whose signal is a PRE-EMPHASISED bounded
    waveform (like real data): the de-emphasised trajectory must stay inside
    the int16 range, or the sampler's output clip breaks the teacher-force
    reproduction property."""
    rs = np.random.RandomState(seed)
    t = frames * 160
    audio = np.clip(np.cumsum(rs.randn(b, t + 2), axis=1) * 100,
                    -8000, 8000).astype(np.float32)
    sig = audio[:, 1:] - np.float32(PREEMPHASIS) * audio[:, :-1]
    return {
        "sig_in": sig[:, :-1].copy(),
        "sig_out": sig[:, 1:].copy(),
        "features": rs.randn(b, frames + 4, 20).astype(np.float32) * 0.3,
        "periods": rs.randint(33, 255, (b, frames + 4)).astype(np.int32),
        "lpc": (rs.randn(b, frames, 16) * 0.05).astype(np.float32),
    }


@pytest.fixture(scope="module")
def params():
    p = M.init_params(TCFG, seed=4)
    np_tree = lambda t: ({k: np_tree(v) for k, v in t.items()}
                         if isinstance(t, dict) else t.numpy())
    return jax.tree.map(jnp.asarray, np_tree(p)), p


@pytest.mark.parametrize("t", [47, 160, 480, 2400])
def test_deemphasis_seq_matches_jax_and_the_recursion(t):
    """One matmul per 160-sample block plus the carry between blocks vs the
    JAX associative scan and the sample-by-sample recursion: 1e-5 relative,
    1e-2 absolute (the JAX package's own bar against the recursion)."""
    x = (np.random.RandomState(0).randn(3, t) * 1000).astype(np.float32)
    got = SS.deemphasis_seq(_t(x)).numpy()
    want = np.asarray(JSS.deemphasis_seq(jnp.asarray(x)))
    ref = np.zeros_like(x, dtype=np.float64)
    acc = np.zeros(3)
    for i in range(t):
        acc = x[:, i] + PREEMPHASIS * acc
        ref[:, i] = acc
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-2)


def test_mixed_history_matches_jax():
    rs = np.random.RandomState(3)
    sig_in = rs.randn(2, 9).astype(np.float32)
    s_hat = rs.randn(2, 9).astype(np.float32)
    tf = rs.rand(2, 9) > 0.5
    want = np.asarray(JSS.mixed_history(jnp.asarray(sig_in),
                                        jnp.asarray(s_hat), jnp.asarray(tf)))
    got = SS.mixed_history(_t(sig_in), _t(s_hat), _t(tf)).numpy()
    np.testing.assert_array_equal(got, want)
    all_tf = SS.mixed_history(_t(sig_in), _t(s_hat),
                              torch.ones(2, 9, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(all_tf, sig_in)


def test_full_teacher_force_reproduces_target_in_both_packages(params):
    """tf_mask all True: the trajectory is the target (up to the per-sample
    output rounding), whatever the sampler's seeds; the two packages agree
    within that rounding."""
    jp, tp = params
    b = fake_batch(1)
    tf = np.ones(b["sig_out"].shape, bool)
    want = np.asarray(JSS.sampled_signal(
        jp, JCFG, {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(tf),
        jax.random.PRNGKey(7)))
    before = K.synthesize_frame_masked_kernel.launches
    got = SS.sampled_signal(tp, TCFG, {k: _t(v) for k, v in b.items()},
                            _t(tf), torch.Generator().manual_seed(7))
    assert K.synthesize_frame_masked_kernel.launches == before  # CPU: plain
    assert got.shape == b["sig_out"].shape and not got.requires_grad
    assert np.abs(got.numpy() - b["sig_out"]).max() <= 1.0
    assert np.abs(got.numpy() - want).max() <= 2.0


def test_sampled_signal_follows_masks_and_generator(params):
    _, tp = params
    b = {k: _t(v) for k, v in fake_batch(2).items()}
    rs = np.random.RandomState(5)
    tf = _t(np.repeat(rs.rand(4, 30) < 0.6, 16, axis=1))
    run = lambda seed, **kw: SS.sampled_signal(
        tp, TCFG, b, tf, torch.Generator().manual_seed(seed), **kw).numpy()
    a, c, d = run(1), run(1), run(2)
    assert np.isfinite(a).all() and np.array_equal(a, c)
    assert not np.array_equal(a, d)               # the seeds reach the sampler
    err = np.abs(a - b["sig_out"].numpy())
    # a teacher-forced sample that follows another reproduces the target
    both = (tf[:, 1:] & tf[:, :-1]).numpy()
    assert err[:, 1:][both].max() <= 1.0
    assert err[~tf.numpy()].mean() > 10.0         # a random model cannot track
    free = run(1, gru_states=(torch.randn(4, 32), torch.randn(4, 16)),
               weighting=torch.pow(torch.tensor(0.9), torch.arange(1., 17.)))
    assert np.isfinite(free).all() and not np.array_equal(free, a)


def test_kiss_seeds_are_uint32_with_odd_jsr():
    s = SS._kiss_seeds(64, torch.Generator().manual_seed(3), "cpu")
    for w in s:
        assert w.dtype == torch.int64 and w.shape == (64,)
        assert int(w.min()) >= 0 and int(w.max()) < 2 ** 32
    assert bool((s.jsr & 1).all()) and len(set(s.z.tolist())) > 60


@pytest.mark.parametrize("arm", ["plain", "hide_exc", "distill"])
def test_loss_fn_ss_arms_finite_and_with_gradients(params, arm):
    _, tp0 = params
    b = {k: _t(v) for k, v in fake_batch(4, b=2, frames=2).items()}
    kw = {"plain": {}, "hide_exc": dict(ss_hide_exc=True),
          "distill": dict(ss_distill=0.5)}[arm]
    tp = jax.tree.map(lambda p: p.clone().requires_grad_(True), tp0)
    g = torch.Generator().manual_seed(5)
    l0, _ = T.loss_fn(tp, TCFG, T.TrainConfig(ss_prob=0.0), b, g)
    g = torch.Generator().manual_seed(5)
    l1, (m, _) = T.loss_fn(tp, TCFG, T.TrainConfig(ss_prob=0.5, **kw), b, g)
    assert np.isfinite(float(l0)) and np.isfinite(float(l1))
    assert float(l0) != float(l1)
    l1.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               and float(p.grad.abs().sum()) > 0
               for p in T._leaves(tp))
    assert ("distill_kl" in m) == (arm == "distill")


def test_loss_fn_ss_probability_reaches_the_mask(params):
    """ss_prob -> 0+ keeps (almost) every block teacher-forced, so the mixed
    history is the data and the loss the plain one; the same generator seed
    gives the same loss twice."""
    _, tp = params
    b = {k: _t(v) for k, v in fake_batch(6, b=2, frames=2).items()}
    loss = lambda tc, seed: float(T.loss_fn(
        tp, TCFG, tc, b, torch.Generator().manual_seed(seed))[0])
    quiet = dict(input_noise=0.0)
    base = float(T.loss_fn(tp, TCFG, T.TrainConfig(**quiet), b, None)[0])
    nearly = T.TrainConfig(ss_prob=1e-9, **quiet)
    with torch.no_grad():
        # the 0.005 noise on GRU-A's output stays: compare two seeded runs
        a, c = loss(nearly, 8), loss(nearly, 8)
        half = loss(T.TrainConfig(ss_prob=0.5, **quiet), 8)
    assert a == c and abs(a - base) < 0.05 and abs(half - base) > abs(a - base)
