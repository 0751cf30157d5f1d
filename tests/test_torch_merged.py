"""K6, the merged-product form of the sample loop, on the CPU: its operands
and its plain version against the JAX package's `_merged_weights`, `_cond4`
and the TPU kernel `_sample_kernel_merged` run by the Pallas interpreter;
its launch operands (`merged_packs`: the merged matrices' non-zero blocks in
K1's layout and fragment packs, the padding checked) and the conversion of
its conditioning that the CUDA wrapper launches (`merged_as_k1`); and the
decoder, which runs K1 on every free-running frame, never K6. The CUDA
kernel itself is held against its plain version in test_torch_cuda.py."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import sample_loop as JK
from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.utils.rng import Kiss99State as JKiss

from lpcnet_torch.codec import decoder as D
from lpcnet_torch.kernels import masked_loop as ML
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import quantized as Q
from lpcnet_torch.weights.convert import params_to_torch, sample_state_to_numpy

torch.set_num_threads(1)

SMALL = dict(rnn_units1=32, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
JCFG, TCFG = JM.LPCNetConfig(**SMALL), M.LPCNetConfig(**SMALL)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def fused():
    """(JAX fused, port fused) from one numpy-seeded init."""
    p = _numpy_tree(M.init_params(TCFG, seed=6))
    return (JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), JCFG),
            M.fuse_inference_params(params_to_torch(p), TCFG))


def _inputs(tf, b, seed=13):
    """Live-LPC conditioning (3 frame-net steps) and a fresh sample state."""
    rs = np.random.RandomState(seed)
    fs = M.init_frame_state(b, TCFG)
    for _ in range(3):
        f = torch.from_numpy((rs.normal(size=(b, 36)) * 0.3).astype(np.float32))
        fs, _, ca, cb, lpc = M.frame_network(tf, fs, f, TCFG)
    return (ca.contiguous(), cb.contiguous(), lpc.contiguous(),
            M.init_sample_state(b, TCFG))


def _jax_state(ts):
    s = sample_state_to_numpy(ts)
    return JM.SampleState(
        *(jnp.asarray(s[k]) for k in ("gru_a", "gru_b", "last_sig",
                                      "last_exc", "deemph")),
        JKiss(*(jnp.asarray(s[k]) for k in ("z", "w", "jsr", "jcong"))))


def _bits(x):
    """Exact comparison form: float32 values (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("form", ["f32", "bf16"])
def test_merged_operands_bit_equal_to_jax(fused, form):
    """`merged_kernel_weights` and `cond4` against the JAX package's
    `_merged_weights` and `_cond4` on the same K1 bundle, bit for bit: the
    bias sits in the z, r and h-recurrent blocks once, the conditioning's h
    part in 2N:3N. Against the JAX package's own float bundle within 1e-6
    in f32 and one bf16 step (2^-7 relative) in bf16: the two packages'
    fused embeddings differ in the last f32 bit, which can round to the
    neighbouring bf16 value (12 of 102,400 entries here)."""
    jf, tf = fused
    na, nb = TCFG.rnn_units1, TCFG.rnn_units2
    kw = K.kernel_weights(tf, TCFG, dtype=DTYPES[form][1])
    mw = K.merged_kernel_weights(kw)
    j = lambda t: jnp.asarray(t.to(torch.float32).numpy()).astype(
        DTYPES[form][0])
    want = JK._merged_weights({k: j(kw[k]) for k in
                               ("emb_cat", "a_rec", "b_in", "b_rec")},
                              na, nb, DTYPES[form][0])
    jkw = JK.kernel_weights(jf, JCFG, dtype=DTYPES[form][0])
    for k, shape in (("a_merged", (768 + na, 4 * na)),
                     ("b_merged", (na + nb, 4 * nb))):
        assert mw[k].dtype == DTYPES[form][1] and mw[k].shape == shape
        assert np.array_equal(_bits(mw[k]), _bits(want[k])), k
        np.testing.assert_allclose(
            _bits(mw[k]), _bits(jkw[k]), atol=1e-6,
            rtol=1e-6 if form == "f32" else 2.0 ** -7, err_msg=k)
    ca, cb, _, _ = _inputs(tf, 8)
    for cond, bias, n in ((ca, "a_bias1", na), (cb, "b_bias1", nb)):
        got = K.cond4(cond, mw[bias][0])
        want4 = JK._cond4(jnp.asarray(cond.numpy()),
                          jnp.asarray(mw[bias][0].numpy()), n)
        assert got.shape == (8, 4 * n)
        assert np.array_equal(got.numpy(), np.asarray(want4)), bias


def _unpack_tiles(pack):
    """The A operand [..., M, K] held by m16n8k16 fragment packs
    [..., M / 16, K / 16, 32, 8]: lane 4 g + t holds, in register i, row
    g + 8 (i & 1) at depth 2 t + 8 (i >> 1) + {0, 1} (the PTX ISA's
    layout, independent of `masked_loop.fragment_index`)."""
    *lead, mts, kts, _, _ = pack.shape
    out = torch.zeros(*lead, mts * 16, kts * 16, dtype=pack.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e in range(8):
            i, half = e // 2, e % 2
            m, k = g + 8 * (i & 1), 2 * t + 8 * (i >> 1) + half
            out[..., m::16, k::16] = pack[..., lane, e]
    return out


@pytest.mark.parametrize("form", ["f32", "bf16"])
def test_merged_packs_hold_the_non_zero_blocks(fused, form):
    """K6's launch operands (`merged_packs`, under "k6") are the non-zero
    blocks of its own merged matrices: the embedding rows' [z | r | h_in],
    the recurrent rows' [z | r | h_rec], GRU-B's likewise, each equal to
    K1's matrix of the same bundle; the recurrent biases reduced to
    [0 | 0 | bias_h]; the packs equal K1's packs of the same bundle: in
    bf16 the fragment packs unpack to those blocks, rank by rank; in f32
    GRU-A's rank pack is the pack of the recurrent block, and GRU-B has
    none."""
    _, tf = fused
    na, nb = TCFG.rnn_units1, TCFG.rnn_units2
    kw = K.masked_kernel_weights(K.kernel_weights(tf, TCFG,
                                                  dtype=DTYPES[form][1]))
    mw = K.merged_kernel_weights(kw)
    k6, a_m, b_m = mw["k6"], mw["a_merged"], mw["b_merged"]
    blocks = {"emb_cat": a_m[:768, :3 * na],
              "a_rec": torch.cat([a_m[768:, :2 * na], a_m[768:, 3 * na:]], 1),
              "b_in": b_m[:na, :3 * nb],
              "b_rec": torch.cat([b_m[na:, :2 * nb], b_m[na:, 3 * nb:]], 1)}
    for k, want in blocks.items():
        assert k6[k].is_contiguous() and torch.equal(k6[k], want), k
        assert torch.equal(k6[k], kw[k]), k
    for k, n in (("a_bias1", na), ("b_bias1", nb)):
        assert not k6[k][:, :2 * n].any()
        assert torch.equal(k6[k][:, 2 * n:], kw[k][:, 2 * n:])
    if form == "f32":
        # the f32 rank pack of the checked block, as K1's bundle has it; no
        # GRU-B pack
        assert torch.equal(k6["k2_a"], kw["k2_a"]) and k6["k2_b"] is None
        assert torch.equal(k6["k2_a"], ML.pack_gru_a(blocks["a_rec"]))
        return
    assert torch.equal(k6["k2_a"], kw["k2_a"]) and torch.equal(k6["k2_b"], kw["k2_b"])
    c, u = ML.cluster_shape(na, ML.FORMS[form])
    at = _unpack_tiles(k6["k2_a"])                  # [C, 3U, ceil(Na/16) 16]
    for r in range(c):
        for q in range(3):
            for j in range(u):
                want = (blocks["a_rec"][:, q * na + r * u + j] if r * u + j < na
                        else torch.zeros(na, dtype=a_m.dtype))
                assert torch.equal(at[r, q * u + j, :na], want), (r, q, j)
    nbp, ksa = ML.padded_nb(nb), -(-na // 16)
    bt = _unpack_tiles(k6["k2_b"])                  # [3Nbp, (ksa + ksbr) 16]
    for q in range(3):
        for j in range(nb):
            assert torch.equal(bt[q * nbp + j, :na], blocks["b_in"][:, q * nb + j])
            assert torch.equal(bt[q * nbp + j, 16 * ksa:16 * ksa + nb],
                               blocks["b_rec"][:, q * nb + j])


@pytest.mark.parametrize("block", ["a_in", "a_rec", "b_in", "b_rec"])
def test_merged_packs_refuse_padding_that_is_not_zero(fused, block):
    """A merged matrix with a non-zero entry in a block the layout pads
    (the input rows' h-recurrent block or the recurrent rows' h-input
    block, of either GRU) is refused when K6's operands are built: the
    kernels skip those blocks."""
    _, tf = fused
    na, nb = TCFG.rnn_units1, TCFG.rnn_units2
    mw = K.merged_kernel_weights(K.kernel_weights(tf, TCFG))
    bad = {k: v for k, v in mw.items() if k != "k6"}
    key, row, col = {"a_in": ("a_merged", 5, 3 * na + 1),
                     "a_rec": ("a_merged", 768 + 2, 2 * na + 3),
                     "b_in": ("b_merged", 1, 3 * nb + 2),
                     "b_rec": ("b_merged", na + 1, 2 * nb)}[block]
    bad[key] = mw[key].clone()
    bad[key][row, col] = 0.5
    with pytest.raises(ValueError, match="not zero"):
        K.merged_packs(bad)
    K.merged_packs({k: v for k, v in mw.items() if k != "k6"})   # the real one passes


def test_k6_in_k1_terms_is_the_plain_k6(fused):
    """What the CUDA wrapper launches for K6 (`merged_as_k1`: K1's plain
    version on the checked blocks, the conditioning converted from the 4N
    layout) against K6's plain version, f32, B=16, 32 steps: RNG equal,
    >=98 % equal PCM, GRU states within 1e-4 (the sums differ only in
    their order: cond4 folds bias_z, bias_r into the conditioning)."""
    _, tf = fused
    mw = K.merged_kernel_weights(K.kernel_weights(tf, TCFG, dtype=torch.float32))
    ca, cb, lpc, s0 = _inputs(tf, 16, seed=17)
    kw6, ca3, cb3 = K.merged_as_k1(mw, ca, cb)
    s1, p1 = K.sample_loop_plain(kw6, s0, ca3, cb3, lpc, 32)
    s6, p6 = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, 32)
    assert all(torch.equal(a, b) for a, b in zip(s1.rng, s6.rng))
    assert float((p1 == p6).float().mean()) >= 0.98
    assert float((s1.gru_a - s6.gru_a).abs().max()) <= 1e-4
    assert float((s1.gru_b - s6.gru_b).abs().max()) <= 1e-4


def test_merged_weights_refuse_q8(fused):
    _, tf = fused
    with pytest.raises(TypeError):
        K.merged_kernel_weights(K.kernel_weights(Q.quantize_fused(tf), TCFG))


@pytest.mark.parametrize("form", ["f32", "bf16"])
def test_plain_k6_matches_pallas_interpret(fused, monkeypatch, form):
    """K6's plain version vs the TPU kernel `_sample_kernel_merged` run by
    the Pallas interpreter: B=8, 32 steps, live LPC. Bars: >=98% exact PCM,
    RNG and excitation equal, GRU states within 1e-4 after 32 steps
    (measured: 100% PCM, h within 9.3e-8 in f32 and 5.4e-7 in bf16); in f32
    one step within 1e-4 of the JAX package's step-by-step model (measured
    7.5e-8; the interpreted kernel runs in octaves of 8 steps)."""
    monkeypatch.setattr(JK, "_INTERPRET", True)
    jf, tf = fused
    jkw = JK.kernel_weights(jf, JCFG, dtype=DTYPES[form][0])
    mw = K.merged_kernel_weights(K.kernel_weights(tf, TCFG,
                                                  dtype=DTYPES[form][1]))
    ca, cb, lpc, s0 = _inputs(tf, 8)
    args = (jkw, _jax_state(s0), ca.numpy(), cb.numpy(), lpc.numpy(), JCFG)
    if form == "f32":
        t1, _ = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, 1)
        jm1, _ = jax.jit(JM.synthesize_frame, static_argnames=("n_samples",))(
            jf, _jax_state(s0), ca.numpy(), cb.numpy(), lpc.numpy(),
            n_samples=1)
        np.testing.assert_allclose(t1.gru_a.numpy(), np.asarray(jm1.gru_a),
                                   atol=1e-4)
        np.testing.assert_allclose(t1.gru_b.numpy(), np.asarray(jm1.gru_b),
                                   atol=1e-4)
    n = 32
    js, jp = JK._synthesize_frame_pallas_merged(*args, n_samples=n, bt=8)
    st, pt = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, n)
    same = np.mean(pt.numpy() == np.asarray(jp))
    assert same >= 0.98, same
    t = sample_state_to_numpy(st)
    for f, x in zip(("z", "w", "jsr", "jcong"), js.rng):
        assert np.array_equal(t[f], np.asarray(x)), f
    assert np.array_equal(t["last_exc"], np.asarray(js.last_exc))
    np.testing.assert_allclose(t["gru_a"], np.asarray(js.gru_a), atol=1e-4)
    np.testing.assert_allclose(t["gru_b"], np.asarray(js.gru_b), atol=1e-4)


def test_plain_k6_agrees_with_plain_k1(fused):
    """The merged layout adds only zeros: over 32 f32 steps K6's and K1's
    plain versions give >=98% equal PCM, equal RNG and gru_a within 1e-4."""
    _, tf = fused
    kw = K.kernel_weights(tf, TCFG, dtype=torch.float32)
    ca, cb, lpc, s0 = _inputs(tf, 16, seed=14)
    s6, p6 = K.sample_loop_merged_plain(K.merged_kernel_weights(kw), s0, ca,
                                        cb, lpc, 32)
    s1, p1 = K.sample_loop_plain(kw, s0, ca, cb, lpc, 32)
    assert float((p6 == p1).float().mean()) >= 0.98
    assert all(torch.equal(a, b) for a, b in zip(s6.rng, s1.rng))
    assert float((s6.gru_a - s1.gru_a).abs().max()) <= 1e-4


@pytest.fixture
def spies(monkeypatch):
    """Counts each kernel wrapper's calls (on the CPU the wrappers run their
    plain versions and count no launches)."""
    calls = {"k1": 0, "k6": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(K, "synthesize_frame_kernel",
                        spy("k1", K.synthesize_frame_kernel))
    monkeypatch.setattr(K, "synthesize_frame_merged_kernel",
                        spy("k6", K.synthesize_frame_merged_kernel))
    return calls


@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_decoder_frames_dispatch_through_the_flag(fused, spies, form):
    """`LPCNetDecoder.synthesize` on the kernel path, a float (bf16) or a
    q8 model: one K1 call a frame and none of K6, with the bundle of the
    model's form."""
    _, tf = fused
    dec = D.LPCNetDecoder.from_fused(Q.quantize_fused(tf) if form == "q8" else tf,
                                     TCFG, 3, device="cpu", use_kernel=True)
    assert K.is_q8_bundle(dec._kw) == (form == "q8")
    rs = np.random.RandomState(15)
    for _ in range(4):
        dec.synthesize((rs.normal(size=(3, 36)) * 0.3).astype(np.float32))
    assert spies == {"k1": 4, "k6": 0}
