"""The factored q8 embedding (LPCNET_EMB=factored) in the port: its operands,
the plain versions of K1, K2 and K3 in that form, the launch layouts and the
packed input kernel, against the JAX package on the CPU. The CUDA kernels
themselves are held against their plain versions in test_torch_cuda.py."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import sample_loop as JK
from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.nn import quantized as JQ
from lpcnet_tpu.utils.rng import Kiss99State as JKiss

from lpcnet_torch.kernels import masked_loop as ML
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import quantized as Q
from lpcnet_torch.weights import lpcnet_arrays as LA
from lpcnet_torch.weights.convert import params_to_torch, state_to_numpy

torch.set_num_threads(1)

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
JCFG, TCFG = JM.LPCNetConfig(**SMALL), M.LPCNetConfig(**SMALL)


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


@pytest.fixture
def factored(monkeypatch):
    """Both packages in the factored embedding mode for one test."""
    monkeypatch.setattr(JK, "_EMB", "factored")
    monkeypatch.setattr(JK, "_INTERPRET", True)
    prev = K.set_emb("factored")
    yield
    K.set_emb(prev)


def _bundles(fused, from_float=False):
    """(JAX q8 bundle, port q8 bundle) in the current embedding mode."""
    jf, tf = fused
    if from_float:
        return (JK.kernel_weights(jf, JCFG, quantized=True),
                K.kernel_weights(tf, TCFG, quantized=True))
    return (JK.kernel_weights(JQ.quantize_fused(jf), JCFG),
            K.kernel_weights(Q.quantize_fused(tf), TCFG))


def _inputs(tf, b, seed=11, frames=3):
    rs = np.random.RandomState(seed)
    fs = M.init_frame_state(b, TCFG)
    for _ in range(frames):
        f = torch.from_numpy((rs.normal(size=(b, 36)) * 0.3).astype(np.float32))
        fs, _, ca, cb, lpc = M.frame_network(tf, fs, f, TCFG)
    return (ca.contiguous(), cb.contiguous(), lpc.contiguous(),
            M.init_sample_state(b, TCFG))


def _jax_state(ts):
    d = state_to_numpy(ts)
    return JM.SampleState(*(jnp.asarray(d[f]) for f in
                            ("gru_a", "gru_b", "last_sig", "last_exc", "deemph")),
                          JKiss(**{k: jnp.asarray(v) for k, v in d["rng"].items()}))


def _assert_states(ts, js, fields=("gru_a", "gru_b"), tol=1e-6):
    """RNG and excitation exact, the named fields within `tol`."""
    t = state_to_numpy(ts)
    for f in ("z", "w", "jsr", "jcong"):
        assert np.array_equal(t["rng"][f], np.asarray(getattr(js.rng, f))), f
    assert np.array_equal(t["last_exc"], np.asarray(js.last_exc))
    for f in fields:
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)), atol=tol,
                                   rtol=0, err_msg=f)


# --------------------------------------------------------------------------
# Operands
# --------------------------------------------------------------------------

@pytest.mark.parametrize("from_float", [False, True], ids=["q8", "q8_from_float"])
def test_factored_operands_match_jax(fused, factored, from_float):
    """embf_q8 and embf_w_q8 bit for bit, embf_scale within one ulp; the
    composed emb_q8 kept beside them, as the JAX bundle keeps it."""
    jkw, tkw = _bundles(fused, from_float)
    assert K.is_factored(tkw) and "embf_q8" in jkw
    assert set(tkw) <= set(jkw)
    for k in ("embf_q8", "embf_w_q8", "emb_q8"):
        assert tkw[k].dtype == torch.int8
        assert np.array_equal(tkw[k].numpy(), np.asarray(jkw[k])), k
    assert tkw["embf_scale"].shape == (1, 3 * TCFG.rnn_units1)
    np.testing.assert_array_max_ulp(tkw["embf_scale"].numpy(),
                                    np.asarray(jkw["embf_scale"]), maxulp=1)


def test_factored_operands_reproduce_composed_tables(fused, factored):
    """tests/test_pallas_kernel.py:300's bar on the port's operands: three
    gathered int8 rows times the scale-folded input kernel reproduce the
    composed float tables within 2 % of each block's largest entry."""
    _, tf = fused
    kw = K.kernel_weights(Q.quantize_fused(tf), TCFG)
    e_q8 = kw["embf_q8"].numpy().astype(np.float32)
    ka_q8 = kw["embf_w_q8"].numpy().astype(np.float32)
    t = kw["embf_scale"].numpy()[0]
    comp = np.concatenate([tf[k].numpy() for k in
                           ("embed_sig_a", "embed_pred_a", "embed_exc_a")])
    idx = np.random.RandomState(3).randint(0, 256, 64)
    for off in range(3):
        got = e_q8[idx] @ ka_q8[off * 128:(off + 1) * 128] * t
        want = comp[off * 256 + idx]
        np.testing.assert_allclose(got, want, atol=0.02 * np.max(np.abs(want)),
                                   err_msg=f"table block {off}")


def test_set_emb_and_models_without_factors(fused):
    """set_emb returns the previous mode and refuses others; a model read
    from a DNNw blob has no factors, so its q8 bundle stays composed (with a
    warning); float bundles are never factored."""
    assert K.set_emb("factored") == "v1"
    try:
        assert K.set_emb("factored") == "factored"
        with pytest.raises(ValueError):
            K.set_emb("composed")
        params = M.init_params(TCFG, seed=2)
        blob = LA.load_lpcnet_blob(LA.save_lpcnet_blob(params, TCFG, quantize=True), TCFG)
        assert "embed_table" not in blob
        with pytest.warns(UserWarning, match="stays composed"):
            kw = K.kernel_weights(Q.quantize_fused(blob), TCFG)
        assert K.is_q8_bundle(kw) and not K.is_factored(kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert not K.is_factored(K.kernel_weights(fused[1], TCFG))
    finally:
        assert K.set_emb("v1") == "factored"
    assert not K.is_factored(K.kernel_weights(Q.quantize_fused(fused[1]), TCFG))


def test_fused_params_carry_the_factors(fused):
    """fuse_inference_params keeps embed_table [256, 128] and
    gru_a_in_kernel [384, 3Na] as the JAX package does; quantize_fused keeps
    them; JAX's fused dict carried across by params_to_torch has both."""
    jf, tf = fused
    for k, shape in (("embed_table", (256, 128)),
                     ("gru_a_in_kernel", (384, 3 * TCFG.rnn_units1))):
        assert tuple(tf[k].shape) == shape
        assert torch.equal(Q.quantize_fused(tf)[k], tf[k])
        across = params_to_torch(jax.tree.map(np.asarray, jf))[k]
        np.testing.assert_array_equal(across.numpy(), np.asarray(jf[k]))
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), rtol=0, atol=0)


# --------------------------------------------------------------------------
# Plain K1, K2, K3 against the JAX package's interpreted factored kernels
# --------------------------------------------------------------------------

def test_plain_k1_factored_matches_pallas_interpret(fused, factored):
    """K1's plain version in the factored form vs the TPU kernel's
    factored form, interpreted: B=8, n=16, live LPC. PCM, excitation and
    RNG exact; GRU states within 1e-6."""
    jkw, tkw = _bundles(fused)
    ca, cb, lpc, s0 = _inputs(fused[1], 8, seed=12)
    n = 16
    js, jp = JK.synthesize_frame_pallas(jkw, _jax_state(s0), ca.numpy(), cb.numpy(),
                                        lpc.numpy(), JCFG, n_samples=n, bt=8)
    ts, tp = K.sample_loop_plain(tkw, s0, ca, cb, lpc, n)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    _assert_states(ts, js)


def _masks(b, n, seed, frozen=2, all_tf=False):
    rs = np.random.RandomState(seed)
    target = torch.from_numpy((rs.normal(size=(b, n)) * 1000).astype(np.float32))
    adv = rs.rand(b, n) < 0.7
    adv[:frozen] = False
    tf = adv.copy() if all_tf else rs.rand(b, n) < 0.5
    return target, torch.from_numpy(tf), torch.from_numpy(adv)


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "unsampled"])
def test_plain_k2_factored_matches_pallas_interpret(fused, factored, sampled):
    """K2's plain version in the factored form vs the TPU kernel's masked
    factored form, interpreted (B=8, n=16, random mode words, two frozen
    streams): PCM, excitation and RNG exact, GRU states within 1e-6, the
    frozen streams untouched."""
    jkw, tkw = _bundles(fused)
    ca, cb, lpc, s0 = _inputs(fused[1], 8, seed=12)
    n = 16
    target, tfm, adv = _masks(8, n, 22, all_tf=not sampled)
    js, jp = JK.synthesize_frame_masked_pallas(
        jkw, _jax_state(s0), ca.numpy(), cb.numpy(), lpc.numpy(), target.numpy(),
        tfm.numpy(), adv.numpy(), JCFG, n_samples=n, bt=8, sampled=sampled)
    ts, tp = K.sample_loop_masked_plain(tkw, s0, ca, cb, lpc, target, tfm, adv, n,
                                        sampled=sampled)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    _assert_states(ts, js)
    t, t0 = state_to_numpy(ts), state_to_numpy(s0)
    for f in ("gru_a", "gru_b", "last_exc"):
        assert np.array_equal(t[f][:2], t0[f][:2]), f
    assert not tp.numpy()[~adv.numpy()].any()


B3, N3, NBLK = 8, 16, 3


def _tf_case(tf, seed=40):
    """Drain-shaped K3 inputs: NBLK conditioning blocks, a carried signal
    state, targets, and full, partial, empty and late-starting counts."""
    rs = np.random.RandomState(seed)
    fs = M.init_frame_state(B3, TCFG)
    cas, cbs, lpcs = [], [], []
    for _ in range(NBLK + 2):
        f = torch.from_numpy((rs.normal(size=(B3, 36)) * 0.3).astype(np.float32))
        fs, _, ca, cb, lpc = M.frame_network(tf, fs, f, TCFG)
        cas.append(ca), cbs.append(cb), lpcs.append(lpc)
    s0 = M.init_sample_state(B3, TCFG)._replace(
        last_sig=torch.from_numpy((rs.normal(size=(B3, 16)) * 500).astype(np.float32)),
        deemph=torch.from_numpy((rs.normal(size=B3) * 200).astype(np.float32)))
    targets = torch.from_numpy((rs.normal(size=(B3, NBLK * N3)) * 900).astype(np.float32))
    counts = np.zeros((B3, NBLK), np.int32)
    counts[0:3] = [N3, N3, 8]
    counts[3:5] = [N3, 0, 0]
    counts[6:8] = [0, N3, N3]
    stack = lambda xs: torch.stack(xs[-NBLK:], dim=1).contiguous()
    return s0, stack(cas), stack(cbs), stack(lpcs), targets, torch.from_numpy(counts)


def test_plain_k3_factored_matches_pallas_interpret(fused, factored):
    """K3's plain version in the factored form vs the TPU kernel's factored
    teacher-forced form, interpreted: B=8, 3 blocks x 16 steps. RNG and
    excitation exact, GRU states within 1e-6, a stream that never advances
    bit-equal."""
    jkw, tkw = _bundles(fused)
    s0, ca, cb, lpc, targets, counts = _tf_case(fused[1])
    js = JK.teacher_force_blocks_pallas(
        jkw, _jax_state(s0), ca.numpy(), cb.numpy(), lpc.numpy(), targets.numpy(),
        counts.numpy(), JCFG, N3, bt=B3)
    ts = K.teacher_force_blocks_plain(tkw, s0, ca, cb, lpc, targets, counts, N3)
    _assert_states(ts, js)
    t, t0 = state_to_numpy(ts), state_to_numpy(s0)
    for f in ("gru_a", "gru_b"):
        assert np.array_equal(t[f][5], t0[f][5]), f


# --------------------------------------------------------------------------
# JAX's own factored bars (test_pallas_kernel.py:332, :370) on the port
# --------------------------------------------------------------------------

def test_factored_close_to_quantized_scan(fused, factored):
    """test_pallas_kernel.py:332's bar on the port at this width: factored
    K1 (plain) vs the quantized step-by-step synthesis from one frame-net
    step, B=64, n=32: >85 % exact PCM, more than half the streams clean,
    gru_a within 8e-2 on those, RNG equal."""
    _, tf = fused
    fq = Q.quantize_fused(tf)
    kw = K.kernel_weights(fq, TCFG)
    assert K.is_factored(kw)
    ca, cb, lpc, s0 = _inputs(tf, 64, seed=9, frames=1)
    n = 32
    s_scan, p_scan = M.synthesize_frame(fq, s0, ca, cb, lpc, n_samples=n)
    s_fac, p_fac = K.sample_loop_plain(kw, s0, ca, cb, lpc, n)
    p_scan, p_fac = p_scan.numpy(), p_fac.numpy()
    assert np.mean(p_scan == p_fac) > 0.85
    clean = np.all(p_scan == p_fac, axis=1)
    assert np.mean(clean) > 0.5
    np.testing.assert_allclose(s_fac.gru_a.numpy()[clean], s_scan.gru_a.numpy()[clean],
                               atol=8e-2)
    assert torch.equal(s_fac.rng.z, s_scan.rng.z)


def test_factored_k3_close_to_composed(fused):
    """test_pallas_kernel.py:370's bar on the port: the factored K3 (plain)
    tracks the composed bundle's within 5e-2 in both GRU states (no
    feedback in a teacher-forced run); frozen streams equal either way."""
    _, tf = fused
    fq = Q.quantize_fused(tf)
    kw_v1 = K.kernel_weights(fq, TCFG)
    prev = K.set_emb("factored")
    try:
        kw_f = K.kernel_weights(fq, TCFG)
    finally:
        K.set_emb(prev)
    assert K.is_factored(kw_f) and not K.is_factored(kw_v1)
    b, n = 64, 16
    ca, cb, lpc, s0 = _inputs(tf, b, seed=12)
    targets = torch.from_numpy((np.random.RandomState(13).normal(size=(b, n))
                                * 1000.0).astype(np.float32))
    count = torch.from_numpy(np.r_[np.full(b // 2, n), np.zeros(b // 2)].astype(np.int32))
    s_v1 = K.teacher_force_prefix_kernel(kw_v1, s0, ca, cb, lpc, targets, count)
    s_f = K.teacher_force_prefix_kernel(kw_f, s0, ca, cb, lpc, targets, count)
    for f in ("gru_a", "gru_b"):
        np.testing.assert_allclose(getattr(s_f, f).numpy(), getattr(s_v1, f).numpy(),
                                   atol=5e-2, err_msg=f)
    assert torch.equal(s_f.gru_a[b // 2:], s0.gru_a[b // 2:])


def test_wrappers_run_the_factored_plain_versions_on_cpu(fused, factored):
    """On CPU tensors K1's, K2's and K3's wrappers run the factored plain
    versions (the packed bundle included) and count no launch."""
    _, tf = fused
    kw = K.masked_kernel_weights(K.kernel_weights(Q.quantize_fused(tf), TCFG))
    assert kw["k2_f"].dtype == torch.int8
    ca, cb, lpc, s0 = _inputs(tf, 5)
    before = (K.synthesize_frame_kernel.launches,
              K.synthesize_frame_masked_kernel.launches,
              K.teacher_force_blocks_kernel.launches)
    st, pcm = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 8)
    sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, 8)
    assert torch.equal(pcm, pp) and torch.equal(st.gru_a, sp.gru_a)
    target, tfm, adv = _masks(5, 8, 3)
    sk, pk = K.synthesize_frame_masked_kernel(kw, s0, ca, cb, lpc, target, tfm, adv, 8)
    sp, pp = K.sample_loop_masked_plain(kw, s0, ca, cb, lpc, target, tfm, adv, 8)
    assert torch.equal(pk, pp) and torch.equal(sk.gru_b, sp.gru_b)
    count = torch.tensor([8, 3, 0, 8, 1], dtype=torch.int32)
    s3 = K.teacher_force_prefix_kernel(kw, s0, ca, cb, lpc, target, count)
    assert torch.isfinite(s3.gru_a).all()
    assert (K.synthesize_frame_kernel.launches,
            K.synthesize_frame_masked_kernel.launches,
            K.teacher_force_blocks_kernel.launches) == before


# --------------------------------------------------------------------------
# The cluster kernel's factored layout and packed input kernel
# --------------------------------------------------------------------------

def _stub(held):
    return lambda nt, smem: held


@pytest.mark.parametrize("na", [384, 64, 100])
def test_pack_embf_fragments_read_back(na):
    """Rank r's lane l of column tile mt and k step ks holds, at element e,
    W[ks 32 + k(l, e)][col] with col = rank_columns[r][16 mt + m(l, e)] of
    the unit-padded [384, 3 C U] matrix: the A-fragment reader of
    csrc/masked_loop.cu's tile_mma with FACT_K = 384."""
    rs = np.random.RandomState(na)
    w = torch.from_numpy(rs.randint(-127, 128, (ML.FACT_K, 3 * na)).astype(np.int8))
    pk = ML.pack_embf(w)
    c, u = ML.cluster_shape(na, ML.FORMS["q8"])
    assert tuple(pk.shape) == (c, 3 * u // 16, ML.FACT_K // 32, 32, 16)
    wp = ML._pad_units(w, na, c * u)
    cols = ML.rank_columns(na, ML.FORMS["q8"])
    mi, ki = ML.fragment_index(32)
    for r in range(c):
        for mt in range(3 * u // 16):
            for ks in (0, 5, ML.FACT_K // 32 - 1):
                want = wp[ks * 32 + ki, cols[r][16 * mt + mi]]
                assert torch.equal(pk[r, mt, ks], want), (r, mt, ks)


@pytest.mark.parametrize("kind", ["free", "masked", "tf"])
def test_factored_layouts_at_na384(kind):
    """At Na=384 every launch of the factored form keeps GRU-A's slice and
    the input kernel's slice in shared memory; the factored regions (the
    slice 3U x 384 bytes, the rows g S x 400 and, at S <= 16, the
    product's sums S x ldz x 4) are what the layout adds to the composed
    one; K1 at 1024 streams keeps its S = 40 in two waves with GRU-B's
    weights resident too (the product's sums live in the gate phase's
    registers)."""
    c, u = ML.cluster_shape(384, ML.FORMS["q8"])
    for b in (64, 128, 256, 1024):
        if kind == "free":
            cfg = ML.free_launch_config(b, 384, 16, 2, _stub(15), fact=True)
            comp = ML.free_launch_config(b, 384, 16, 2, _stub(15))
            extra = dict(free=True)
        elif kind == "masked":
            cfg = ML.masked_launch_config(b, 384, 16, 2, _stub(15), fact=True)
            comp = ML.masked_launch_config(b, 384, 16, 2, _stub(15))
            extra = {}
        else:
            cfg = ML.tf_launch_config(b, 384, 16, 2, 3, _stub(15), fact=True)
            comp = ML.tf_launch_config(b, 384, 16, 2, 3, _stub(15))
            extra = dict(tf_blocks=3)
        assert cfg["res_a"] and cfg["res_f"] and not comp["res_f"]
        assert cfg["nt"] == comp["nt"] and cfg["waves"] == comp["waves"]
        assert cfg["smem"] <= ML.SMEM_LIMIT
        s = cfg["streams"]
        base = ML.masked_smem_bytes(2, 384, 16, cfg["nt"], cfg["res_a"], cfg["res_b"],
                                    **extra)
        added = 3 * u * 384 + s * 400 + (s * (3 * u + 4) * 4 if s <= 16 else 0)
        assert cfg["smem"] == base + added
        if kind == "free" and b == 1024:
            assert s == 40 and cfg["waves"] == 2 and cfg["res_b"]
            assert cfg["smem"] == 223280
    with pytest.raises(ValueError):
        ML.free_launch_config(64, 384, 16, 1, _stub(15), fact=True)


def test_factored_layout_reads_the_input_kernel_from_l2_where_it_must():
    """The tiers drop GRU-B's weights, then the input kernel's slice, then
    GRU-A's: at Na=448 the factored q8 form of the masked kernel keeps
    GRU-A's slice and reads the input kernel from L2 at 32 streams (the
    composed form keeps both GRUs' weights there)."""
    cfg = ML.masked_launch_config(1024, 448, 16, 2, _stub(15), fact=True)
    assert cfg["streams"] == 32 and cfg["smem"] <= ML.SMEM_LIMIT
    assert cfg["res_a"] and not cfg["res_b"] and not cfg["res_f"]
    comp = ML.masked_launch_config(1024, 448, 16, 2, _stub(15))
    assert comp["res_a"] and comp["res_b"] and not comp["res_f"]
