"""The analysis DSP of the port (spectrum, Burg, pitch, per-frame feature
extraction) vs the C fixtures and the JAX package, on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.codec import features as JF
from lpcnet_tpu.dsp import burg as jburg
from lpcnet_tpu.dsp import pitch as jpitch
from lpcnet_tpu.dsp import spectrum as jspec

from lpcnet_torch.codec import features as F
from lpcnet_torch.dsp import burg as tburg
from lpcnet_torch.dsp import pitch as tpitch
from lpcnet_torch.dsp import spectrum as tspec
from lpcnet_torch.weights.convert import encoder_state_to_torch, state_to_numpy

torch.set_num_threads(1)

FIX = Path(__file__).resolve().parent / "fixtures"
t = torch.from_numpy


def _fixture(name):
    return dict(np.load(FIX / name))


def _speech(batch, frames):
    pcm = _fixture("codec.npz")["pcm"].astype(np.float32)
    return np.stack([np.roll(pcm, 37 * i)[:frames * 160] for i in range(batch)])


def test_dct_and_band_energy_match_the_c_fixtures():
    """The JAX package's own gates on the same fixtures: DCT 1e-5, band
    energies rtol 2e-4 / atol 1e-3."""
    tr, bands = _fixture("transforms.npz"), _fixture("bands.npz")
    np.testing.assert_allclose(tspec.dct(t(tr["cin"])).numpy(), tr["dct"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tspec.idct(t(tr["cin"])).numpy(), tr["idct"],
                               rtol=1e-5, atol=1e-5)
    spec = tspec.forward_transform(tspec.apply_window(t(bands["windows"])))
    np.testing.assert_allclose(tspec.compute_band_energy(spec).numpy(),
                               bands["bands"], rtol=2e-4, atol=1e-3)


def test_spectrum_functions_match_jax():
    """Every spectrum function on speech windows and on seeded band
    energies that span the floor/follow clamps: relative 1e-5 (the FFTs'
    sums run in another order), cepstra within 1e-5."""
    wins = _fixture("bands.npz")["windows"][:16]
    jw, tw = jspec.apply_window(wins), tspec.apply_window(t(wins))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    js, ts = jspec.forward_transform(jw), tspec.forward_transform(tw)
    scale = np.abs(np.asarray(js)).max()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6 * scale)
    # the inverse sums 1/|X|^2, which amplifies the FFTs' last bits where
    # a bin is nearly empty
    for name, rtol in (("compute_band_energy", 1e-4),
                       ("compute_band_energy_inverse", 2e-3)):
        want = np.asarray(getattr(jspec, name)(js))
        got = getattr(tspec, name)(ts).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)
    rs = np.random.RandomState(0)
    band_e = (10.0 ** rs.uniform(-4, 9, (32, 18))).astype(np.float32)
    band_e[0] = 0.0                                           # silence
    for name in ("log_band_energy", "cepstrum_from_band_energy"):
        want = np.asarray(getattr(jspec, name)(band_e))
        got = getattr(tspec, name)(t(band_e)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
    x, mem = wins[:, 160:], wins[:, :160]
    _, jb, jm = jspec.frame_analysis(x, mem)
    _, tb, tm = tspec.frame_analysis(t(x), t(mem))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4)
    assert np.array_equal(tm.numpy(), np.asarray(jm))


def test_burg_matches_the_c_fixture_and_the_numpy_oracle():
    """The JAX package's gate against C (rtol and atol 5e-3); the float32
    recursion against the float64 oracle on one half-frame."""
    fx = _fixture("burg.npz")
    got = tburg.burg_cepstral_analysis(t(fx["frames"])).numpy()
    np.testing.assert_allclose(got, fx["burg"], rtol=5e-3, atol=5e-3)
    half = fx["frames"][3, :80].astype(np.float64)
    x = half[1:] - 0.85 * half[:-1]
    a64, nrg64 = tburg.burg_analysis_np(x)
    a32, nrg32 = tburg.burg_half_frame(t(x[None].astype(np.float32)))
    np.testing.assert_allclose(a32[0].numpy(), a64, atol=5e-3)
    np.testing.assert_allclose(float(nrg32[0]), nrg64, rtol=5e-3)
    ja, jn = jburg.burg_analysis_np(x)
    assert np.array_equal(ja, a64) and jn == nrg64


def test_burg_matches_jax_including_silence_and_full_scale():
    """Speech frames, a silent one and one at full scale against the JAX
    package: within 2e-3 on cepstra of magnitude 4-12 (the order-16
    recursion in float32 amplifies the last bit of its correlations; the JAX
    package's own bar against C is 5e-3), finite everywhere, and the silent
    frame exact."""
    frames = np.concatenate([
        _speech(3, 4)[:, 320:480], np.zeros((1, 160), np.float32),
        np.full((1, 160), 32767, np.float32)])
    want = np.asarray(jburg.burg_cepstral_analysis(jnp.asarray(frames)))
    got = tburg.burg_cepstral_analysis(t(frames)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.array_equal(got[3], want[3])


def _exc_bufs(batch, seed):
    """Excitation histories with a clear pitch, one period per stream."""
    rs = np.random.RandomState(seed)
    n = np.arange(416)
    return np.stack([
        1000 * np.sin(2 * np.pi * n / p) + 100 * rs.randn(416)
        for p in np.linspace(40, 200, batch)]).astype(np.float32)


@pytest.mark.parametrize("offset", [0, 80])
def test_half_frame_xcorr_matches_jax(offset):
    """Correlation within 1e-5 of the JAX package's (values in [-1, 1]), the
    frame weight relative 1e-6."""
    bufs = _exc_bufs(5, 1)
    jx, jw = jax.vmap(lambda e: jpitch.half_frame_xcorr(e, offset))(bufs)
    tx, tw = tpitch.half_frame_xcorr(t(bufs), offset)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    silent = tpitch.half_frame_xcorr(torch.zeros(2, 416), offset)
    assert not silent[0].any() and not silent[1].any()


def test_octave_suppress_matches_jax():
    rs = np.random.RandomState(2)
    xc = rs.uniform(-1, 1, (4, 2, 256)).astype(np.float32)
    want = np.asarray(jax.vmap(jax.vmap(jpitch.octave_suppress))(xc))
    assert np.array_equal(tpitch.octave_suppress(t(xc)).numpy(), want)


def test_viterbi_matches_jax_with_ties():
    """Two-subframe tracks over several frames, the carry handed on: the
    periods, the back pointers of a step and the best state exact, path
    metrics and the correlation within 1e-5. Ties: at the start (zero path,
    zero correlation) and on stream 0's constant input every state's metric
    is the same, and the first state wins; with path_max = 6 the restart
    candidate ties the zero jump, and the restart, which comes first, wins:
    the C's strict `>`."""
    rs = np.random.RandomState(3)
    b = 4
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape),
                      jpitch.ViterbiCarry.zeros())
    tc = tpitch.ViterbiCarry.zeros(b)
    _, jprev = jax.vmap(jpitch.viterbi_step)(jc, jnp.zeros((b, 256)), jnp.ones(b))
    _, tprev = tpitch.viterbi_step(tc, torch.zeros(b, 256), torch.ones(b))
    assert np.array_equal(tprev.numpy(), np.asarray(jprev))
    assert np.array_equal(tprev.numpy()[0], np.arange(224))   # the zero jump
    tied_j = jc._replace(path_max=jnp.full((b,), 6.0), best_i=jnp.full((b,), 7))
    tied_t = tc._replace(path_max=torch.full((b,), 6.0),
                         best_i=torch.full((b,), 7, dtype=torch.int32))
    jn, jprev = jax.vmap(jpitch.viterbi_step)(tied_j, jnp.zeros((b, 256)), jnp.ones(b))
    tn, tprev = tpitch.viterbi_step(tied_t, torch.zeros(b, 256), torch.ones(b))
    assert np.array_equal(tprev.numpy(), np.asarray(jprev))
    assert (tprev.numpy() == 7).all()       # the restart, first of the tied
    assert not tn.best_i.numpy().any() and not np.asarray(jn.best_i).any()
    for k in range(6):
        xcs = rs.uniform(-0.2, 1, (b, 2, 256)).astype(np.float32)
        xcs[0] = 0.5                                        # ties for good
        w = rs.uniform(0.5, 1.5, (b, 2)).astype(np.float32)
        jc, jper, jcorr = jax.vmap(jpitch.viterbi_track)(jc, xcs, w)
        tc, tper, tcorr = tpitch.viterbi_track(tc, t(xcs), t(w))
        assert tper.dtype == torch.int32
        assert np.array_equal(tper.numpy(), np.asarray(jper)), k
        assert np.array_equal(tc.best_i.numpy(), np.asarray(jc.best_i)), k
        np.testing.assert_allclose(tcorr.numpy(), np.asarray(jcorr), atol=1e-5)
        np.testing.assert_allclose(tc.path.numpy(), np.asarray(jc.path), atol=1e-5)
        np.testing.assert_allclose(tc.path_max.numpy(), np.asarray(jc.path_max),
                                   atol=1e-5)


def test_single_frame_features_seq_matches_jax():
    """12 frames of the codec fixture's speech on 3 streams (one starts in
    silence): cepstrum within 1e-4, pitch period exact, pitch correlation
    within 1e-4; LPC within 1e-3 on coefficients of magnitude 2 (Levinson in
    float32 on voiced speech amplifies the last bit of the autocorrelation;
    the two packages' `lpc_from_cepstrum` differ by 3.4e-4 on one and the
    same cepstrum, and the JAX package's own bar against C is 2e-2). The
    final state converts leaf by leaf."""
    b, frames = 3, 12
    pcm = _speech(b, frames)
    pcm[2, :320] = 0.0
    js, jf = jax.jit(JF.compute_single_frame_features_seq)(
        JF.init_encoder_state(b), jnp.asarray(pcm))
    ts, tf = F.compute_single_frame_features_seq(F.init_encoder_state(b), t(pcm))
    jf, tf = np.asarray(jf), tf.numpy()
    assert tf.shape == (b, frames, 36)
    np.testing.assert_allclose(tf[..., :18], jf[..., :18], atol=1e-4)
    assert np.array_equal(tf[..., 18], jf[..., 18])
    np.testing.assert_allclose(tf[..., 19], jf[..., 19], atol=1e-4)
    np.testing.assert_allclose(tf[..., 20:], jf[..., 20:], atol=1e-3)
    got = state_to_numpy(ts)
    back = state_to_numpy(encoder_state_to_torch(js))
    assert set(got) == set(JF.EncoderState._fields)
    assert np.array_equal(got["viterbi"]["best_i"], back["viterbi"]["best_i"])
    for f in ("analysis_mem", "pitch_mem", "exc_buf"):
        scale = max(1.0, np.abs(back[f]).max())
        np.testing.assert_allclose(got[f] / scale, back[f] / scale, atol=2e-4,
                                   err_msg=f)
    np.testing.assert_allclose(got["xc"], back["xc"], atol=1e-4)


def test_preemphasis_and_frame_weights_match_jax():
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 160) * 1000).astype(np.float32)
    mem = (rs.randn(3) * 100).astype(np.float32)
    jy, jm = JF.preemphasis(jnp.asarray(x), jnp.asarray(mem))
    ty, tm = F.preemphasis(t(x), t(mem))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    fw = rs.uniform(0, 1e6, (3, 10)).astype(np.float32)
    np.testing.assert_allclose(
        F.normalized_frame_weights(t(fw), 2, 2).numpy(),
        np.asarray(JF.normalized_frame_weights(jnp.asarray(fw), 2, 2)), rtol=1e-6)
