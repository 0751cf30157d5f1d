"""The port's native host runtime (`lpcnet_torch.runtime`) against the JAX
package's bindings on the same inputs (the cases of test_native_runtime.py),
its NumPy fallbacks against its native path, and DRED payloads through the
native range coder against the Python coder and the JAX package's."""

import ctypes

import numpy as np
import pytest

from lpcnet_tpu.runtime import runtime as jrt

from lpcnet_torch.codec import packet as P
from lpcnet_torch.runtime import bindings as B
from lpcnet_torch.runtime import native_available, runtime

FALLBACK = B._Runtime(native=False)


def test_native_builds_from_the_ports_source():
    assert native_available(), "native runtime failed to build"
    path = B.library_path()
    assert path.parent == B.BUILD_DIR and path.exists()
    assert "lpcnet_torch" in str(B._SRC) and B._SRC.exists()


@pytest.mark.parametrize("rt", [runtime, FALLBACK], ids=["native", "fallback"])
def test_pack_matches_python_and_jax(rt):
    rng = np.random.RandomState(0)
    fields = {name: rng.randint(0, 1 << bits, size=(23,)).astype(np.int32)
              for name, bits in P.FIELDS}
    arr = np.stack([fields[f[0]] for f in P.FIELDS], axis=1)
    packed = rt.pack_packets(arr)
    np.testing.assert_array_equal(packed, P.pack_fields(fields))
    np.testing.assert_array_equal(packed, jrt.pack_packets(arr))
    np.testing.assert_array_equal(rt.unpack_packets(packed), arr)


@pytest.mark.parametrize("rt", [runtime, FALLBACK], ids=["native", "fallback"])
def test_biquad_state_carry(rt):
    """Carrying the state over a split equals one call; the output and the
    state equal JAX's bindings (exactly natively, 1e-6 as a fallback)."""
    rng = np.random.RandomState(1)
    x = rng.randn(400).astype(np.float32) * 100
    b = np.array([0.3, -0.2], np.float32)
    a = np.array([-0.5, 0.25], np.float32)
    mem1 = np.zeros(2, np.float32)
    full = rt.biquad(x, b, a, mem1)
    mem2 = np.zeros(2, np.float32)
    h1 = rt.biquad(x[:160], b, a, mem2)
    h2 = rt.biquad(x[160:], b, a, mem2)
    np.testing.assert_allclose(full, np.concatenate([h1, h2]), rtol=1e-6)
    jmem = np.zeros(2, np.float32)
    want = jrt.biquad(x, b, a, jmem)
    np.testing.assert_allclose(full, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mem1, jmem, rtol=1e-6, atol=1e-6)
    if rt is runtime:
        np.testing.assert_array_equal(full, want)


@pytest.mark.parametrize("rt", [runtime, FALLBACK], ids=["native", "fallback"])
def test_write_audio_frames(rt):
    """The teacher loop's pairs and carried memories: bit-exact against
    JAX's bindings, with and without noise; the clean-target properties of
    test_native_runtime.py."""
    rng = np.random.RandomState(2)
    pcm = (rng.randn(320) * 2000).astype(np.float32)
    lpc = (rng.randn(2, 16) * 0.05).astype(np.float32)
    for noise in (np.zeros(320, np.int32), rng.randint(-4, 5, 320).astype(np.int32)):
        sig_mem, exc_mem = np.zeros(16, np.float32), np.zeros(1, np.int32)
        out = rt.write_audio_frames(pcm, lpc, noise, sig_mem, exc_mem)
        jsig, jexc = np.zeros(16, np.float32), np.zeros(1, np.int32)
        want = jrt.write_audio_frames(pcm, lpc, noise, jsig, jexc)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(sig_mem, jsig)
        np.testing.assert_array_equal(exc_mem, jexc)
    out = rt.write_audio_frames(pcm, lpc, np.zeros(320, np.int32),
                                np.zeros(16, np.float32), np.zeros(1, np.int32))
    out = out.reshape(-1, 2)
    np.testing.assert_allclose(out[:, 1], np.round(pcm), atol=1.0)
    err = out[16:, 0].astype(float) - pcm[15:-1]
    assert np.sqrt(np.mean(err ** 2)) < 60.0


def test_state_buffers_are_checked_before_the_library_writes():
    """A state buffer of the wrong type or size is refused before a pointer
    reaches the library."""
    x = np.zeros(160, np.float32)
    b = a = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="mem"):
        runtime.biquad(x, b, a, np.zeros(2, np.float64))
    with pytest.raises(ValueError, match="sig_mem"):
        runtime.write_audio_frames(x, np.zeros(16, np.float32), np.zeros(160, np.int32),
                                   np.zeros(8, np.float32), np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="noise"):
        runtime.write_audio_frames(x, np.zeros(16, np.float32), np.zeros(10, np.int32),
                                   np.zeros(16, np.float32), np.zeros(1, np.int32))


def test_noise_frames_fallback_is_the_native_stream():
    """compute_noise_frames: the fallback's KISS99 stream and float
    arithmetic give the native integers, for two seeds; the native output
    equals JAX's native bindings."""
    rng = np.random.RandomState(4)
    std = np.abs(rng.randn(5)).astype(np.float32) * 4
    for seed in (0, 123456789012):
        got = runtime.compute_noise_frames(std, seed)
        np.testing.assert_array_equal(FALLBACK.compute_noise_frames(std, seed), got)
        np.testing.assert_array_equal(jrt.compute_noise_frames(std, seed), got)
        assert got.shape == (5 * 160,) and np.abs(got).max() > 0


def test_ulaw_of_the_fallback_is_the_c_ulaw():
    """The fallback's u-law pair against the library's batch entry points:
    all 256 codes back to linear, and 4000 values forward."""
    lib = B._load()
    u = np.arange(256, dtype=np.int32)
    lin = np.empty(256, np.float32)
    lib.ulaw2lin_batch(B._cp(u, ctypes.c_int32), B._cp(lin, ctypes.c_float), 256)
    np.testing.assert_array_equal(
        np.array([B._ulaw2lin(np.float32(v)) for v in u], np.float32), lin)
    x = (np.random.RandomState(5).randn(4000) * 4000).astype(np.float32)
    codes = np.empty(4000, np.int32)
    lib.lin2ulaw_batch(B._cp(x, ctypes.c_float), B._cp(codes, ctypes.c_int32), 4000)
    np.testing.assert_array_equal(np.array([B._lin2ulaw(v) for v in x]), codes)


def test_dump_data_end_to_end(tmp_path):
    from lpcnet_torch.train.dump_data import dump_data
    rng = np.random.RandomState(3)
    t = np.arange(16000)
    speech = (3000 * np.sin(2 * np.pi * 150 * t / 16000)
              + 200 * rng.randn(16000)).astype(np.int16)
    fpath, ppath = str(tmp_path / "feat.f32"), str(tmp_path / "data.s16")
    dump_data(speech, fpath, ppath, chunk_frames=50, device="cpu")
    feats = np.fromfile(fpath, np.float32).reshape(-1, 36)
    pairs = np.fromfile(ppath, np.int16).reshape(-1, 2)
    assert feats.shape[0] == 100 and pairs.shape[0] == 100 * 160
    assert np.isfinite(feats).all()
    assert feats[:, 18].min() >= 0.01 * (66 - 200) - 1e-5


def _payload_inputs(seed):
    from lpcnet_torch.dred import entropy as DE
    rng = np.random.RandomState(seed)
    levels, dim, n = 16, 8, 12
    stats = {"p0_q15": rng.randint(2000, 30000, (levels, dim)).astype(np.uint16),
             "r_q15": rng.randint(3000, 28000, (levels, dim)).astype(np.uint16)}
    zq = np.round(rng.laplace(0, 2.0, (n, dim))).astype(np.int32)
    zq[0, 0] = 300                                   # beyond the magnitude clamp
    k, sdim = 12, 6
    pulses = DE.pvq_search(rng.randn(sdim), k)
    return zq, pulses, stats, k, sdim


@pytest.mark.parametrize("seed", [0, 1])
def test_payload_bytes_native_python_and_jax(seed, monkeypatch):
    """encode_payload takes the native coder: its bytes equal the Python
    coder's (the library hidden) and the JAX package's; decode_payload
    reads them back on both paths."""
    from lpcnet_tpu.dred import entropy as JE
    from lpcnet_torch.dred import entropy as DE
    zq, pulses, stats, k, sdim = _payload_inputs(seed)
    native = DE.encode_payload(zq, pulses, 9, 15, stats, k)
    assert native == JE.encode_payload(zq, pulses, 9, 15, stats, k)
    back = DE.decode_payload(native, stats, sdim, k)
    monkeypatch.setattr(B, "runtime", FALLBACK)
    python = DE.encode_payload(zq, pulses, 9, 15, stats, k)
    assert python == native
    py_back = DE.decode_payload(native, stats, sdim, k)
    for a, b in zip(back, py_back):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back[0], np.clip(zq, -255, 255))
    np.testing.assert_array_equal(back[1], pulses)
