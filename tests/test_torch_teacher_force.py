"""The teacher-forced kernel's Python side (K3: closed forms, plain version,
wrapper) vs the JAX package, on the CPU. The CUDA kernel itself is held
against its plain version in test_torch_cuda.py."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

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
from lpcnet_torch.weights.convert import params_to_torch, state_to_numpy

# the plain path is many small ops: one intra-op thread per process keeps
# parallel pytest workers from oversubscribing the cores
torch.set_num_threads(1)

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
JCFG, TCFG = JM.LPCNetConfig(**SMALL), M.LPCNetConfig(**SMALL)
B, N, NBLK = 8, 16, 3


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def fused():
    """(JAX fused, port fused) from one numpy-seeded init."""
    p = _numpy_tree(M.init_params(TCFG, seed=9))
    return (JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), JCFG),
            M.fuse_inference_params(params_to_torch(p), TCFG))


def _jax_state(ts):
    d = state_to_numpy(ts)
    return JM.SampleState(*(jnp.asarray(d[f]) for f in
                            ("gru_a", "gru_b", "last_sig", "last_exc", "deemph")),
                          JKiss(**{k: jnp.asarray(v) for k, v in d["rng"].items()}))


def _case(tf, seed=40):
    """Drain-shaped inputs: NBLK conditioning blocks from consecutive
    frame-network steps, a carried signal state, targets, and prefix counts
    that include full, partial, empty and late-starting streams."""
    rs = np.random.RandomState(seed)
    fs = M.init_frame_state(B, TCFG)
    cas, cbs, lpcs = [], [], []
    for _ in range(NBLK + 2):                    # the last NBLK have live LPC
        f = torch.from_numpy((rs.normal(size=(B, 36)) * 0.3).astype(np.float32))
        fs, _, ca, cb, lpc = M.frame_network(tf, fs, f, TCFG)
        cas.append(ca), cbs.append(cb), lpcs.append(lpc)
    s0 = M.init_sample_state(B, TCFG)._replace(
        last_sig=torch.from_numpy((rs.normal(size=(B, 16)) * 500).astype(np.float32)),
        deemph=torch.from_numpy((rs.normal(size=B) * 200).astype(np.float32)))
    targets = torch.from_numpy((rs.normal(size=(B, NBLK * N)) * 900
                                ).astype(np.float32))
    counts = np.zeros((B, NBLK), np.int32)
    counts[0:3] = [N, N, 8]
    counts[3:5] = [N, 0, 0]
    counts[5] = [0, 0, 0]
    counts[6:8] = [0, N, N]
    stack = lambda xs: torch.stack(xs[-NBLK:], dim=1).contiguous()
    return s0, stack(cas), stack(cbs), stack(lpcs), targets, torch.from_numpy(counts)


def _bundles(fused, form):
    jf, tf = fused
    if form == "q8":
        return (JK.kernel_weights(JQ.quantize_fused(jf), JCFG),
                K.kernel_weights(Q.quantize_fused(tf), TCFG))
    return (JK.kernel_weights(jf, JCFG, dtype=jnp.float32),
            K.kernel_weights(tf, TCFG, dtype=torch.float32))


def test_tf_precompute_matches_jax(fused):
    """The closed forms against the JAX package's: the three u-law code
    sequences and the final excitation exact, the final history and
    de-emphasis memory within 1e-3 (an ulp of the +-4000 values they are
    differences of; XLA fuses multiply-adds)."""
    s0, _, _, lpcs, targets, counts = _case(fused[1])
    got = K.tf_precompute(s0, lpcs[:, 0], targets[:, :N], counts[:, 2])
    want = JK._tf_precompute(_jax_state(s0), lpcs[:, 0].numpy(),
                             targets[:, :N].numpy(), counts[:, 2].numpy())
    for g, w, name in zip(got[:3], want[:3], ("sig_u", "pred_u", "exc_in")):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w)), name
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-3)
    assert np.array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]), atol=1e-3)
    # a stream that runs no step keeps its signal state
    frozen = counts[:, 2].numpy() == 0
    assert frozen.any()
    assert torch.equal(got[3][frozen], s0.last_sig[frozen])
    assert torch.equal(got[5][frozen], s0.deemph[frozen])


@pytest.mark.parametrize("form", ["f32", "q8"])
def test_plain_k3_matches_pallas_interpret(fused, monkeypatch, form):
    """K3's plain version vs the TPU kernel run by the Pallas interpreter:
    B=8, 3 blocks x 16 steps, drain-shaped counts. Same arithmetic: RNG and
    final excitation exact, a stream that never advances bit-equal in every
    field, GRU states within 1e-4, signal state within 1e-3."""
    monkeypatch.setattr(JK, "_INTERPRET", True)
    jkw, tkw = _bundles(fused, form)
    s0, ca, cb, lpc, targets, counts = _case(fused[1])
    js = JK.teacher_force_blocks_pallas(
        jkw, _jax_state(s0), ca.numpy(), cb.numpy(), lpc.numpy(),
        targets.numpy(), counts.numpy(), JCFG, N, bt=B)
    ts = K.teacher_force_blocks_plain(tkw, s0, ca, cb, lpc, targets, counts, N)
    t = state_to_numpy(ts)
    for f in ("z", "w", "jsr", "jcong"):
        assert np.array_equal(t["rng"][f], np.asarray(getattr(js.rng, f))), f
    assert np.array_equal(t["last_exc"], np.asarray(js.last_exc))
    for f, tol in (("gru_a", 1e-4), ("gru_b", 1e-4), ("last_sig", 1e-3),
                   ("deemph", 1e-3)):
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)), atol=tol,
                                   err_msg=f)
    t0 = state_to_numpy(s0)
    for f in ("gru_a", "gru_b", "last_sig", "last_exc", "deemph"):
        assert np.array_equal(t[f][5], t0[f][5]), f
    assert all(np.array_equal(t["rng"][f][5], t0["rng"][f][5]) for f in t["rng"])
    # two draws per step taken
    assert not np.array_equal(t["rng"]["z"][:5], t0["rng"]["z"][:5])


@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_plain_k3_matches_plain_k2_unsampled(fused, form):
    """K3 is K2 with the sampler off under a prefix advance mask, less the
    PCM: RNG bit-equal; GRU states within 2e-2 (q8 5e-2); the signal state
    within 0.5 and the last excitation within 1, since the closed form sets
    the de-emphasis memory to the target, one rounding fewer (the bars of the
    JAX package's own comparison of its two kernels)."""
    _, tf = fused
    if form == "q8":
        kw = K.kernel_weights(Q.quantize_fused(tf), TCFG)
    else:
        kw = K.kernel_weights(tf, TCFG, dtype={"f32": torch.float32,
                                               "bf16": torch.bfloat16}[form])
    s0, ca, cb, lpc, targets, counts = _case(tf, seed=41)
    count = torch.tensor([0, N, 8, 12, N, 0, 3, N], dtype=torch.int32)
    adv = torch.arange(N)[None, :] < count[:, None]
    tg = targets[:, :N].contiguous()
    before = K.teacher_force_blocks_kernel.launches
    s_tf = K.teacher_force_prefix_kernel(kw, s0, ca[:, 0], cb[:, 0], lpc[:, 0],
                                         tg, count)
    assert K.teacher_force_blocks_kernel.launches == before   # CPU: plain
    s_ref, _ = K.sample_loop_masked_plain(kw, s0, ca[:, 0], cb[:, 0], lpc[:, 0],
                                          tg, adv, adv, N, sampled=False)
    assert all(torch.equal(a, b) for a, b in zip(s_tf.rng, s_ref.rng))
    tol = 5e-2 if form == "q8" else 2e-2
    assert float((s_tf.gru_a - s_ref.gru_a).abs().max()) <= tol
    assert float((s_tf.gru_b - s_ref.gru_b).abs().max()) <= tol
    assert float((s_tf.last_sig - s_ref.last_sig).abs().max()) <= 0.5
    assert float((s_tf.deemph - s_ref.deemph).abs().max()) <= 0.5
    assert int((s_tf.last_exc - s_ref.last_exc).abs().max()) <= 1
    frozen = count == 0
    assert torch.equal(s_tf.gru_a[frozen], s0.gru_a[frozen])
    assert torch.equal(s_tf.last_sig[frozen], s0.last_sig[frozen])


@pytest.mark.parametrize("form", ["f32", "q8"])
def test_plain_k3_blocks_equal_sequential_prefix_calls(fused, form):
    """One call over N blocks equals N single-block calls in a row, bit for
    bit: the same step arithmetic and the same chaining of the closed
    forms."""
    _, tkw = _bundles(fused, form)
    s0, ca, cb, lpc, targets, counts = _case(fused[1], seed=42)
    s_seq = s0
    for k in range(NBLK):
        s_seq = K.teacher_force_prefix_kernel(
            tkw, s_seq, ca[:, k], cb[:, k], lpc[:, k],
            targets[:, k * N:(k + 1) * N], counts[:, k])
    s_blk = K.teacher_force_blocks_kernel(tkw, s0, ca, cb, lpc, targets,
                                          counts, N)
    for a, b in zip(s_blk[:5] + tuple(s_blk.rng), s_seq[:5] + tuple(s_seq.rng)):
        assert torch.equal(a, b)


def test_k3_wrapper_refuses_other_devices(fused):
    _, tkw = _bundles(fused, "f32")
    s0, ca, cb, lpc, targets, counts = _case(fused[1])
    with pytest.raises(ValueError):
        K.teacher_force_blocks_kernel(tkw, s0, ca.to("meta"), cb, lpc, targets,
                                      counts, N)


@pytest.mark.parametrize("streams", [8, 16])
def test_step_budget_mirror_gives_the_plain_versions_steps(fused, streams):
    """The teacher-forced kernel's schedule (`masked_loop.tf_step_budget`:
    each cluster runs block k up to its own streams' largest count, every
    rank walking the same (block, step) pairs) advances each stream by
    exactly the steps `teacher_force_blocks_plain` runs for it: its KISS99
    words, drawn twice for every step of the walk that the stream takes
    (t < counts[s, k]), equal the plain version's, bit for bit, in clusters
    of 8 and 16 streams over a batch with a ragged last cluster, empty
    blocks, a block whose counts are all short of it and streams that never
    move."""
    _, tf = fused
    kw = K.kernel_weights(tf, TCFG, dtype=torch.float32)
    s0, ca, cb, lpc, targets, counts = _case(tf, seed=43)
    counts = counts.clone()
    counts[:, 1] = counts[:, 1] // 2           # no stream fills block 1
    cmax, walks = ML.tf_step_budget(counts, streams, N)
    clamped = counts.clamp(0, N)
    assert cmax.shape == (-(-B // streams), NBLK)
    taken = torch.zeros(B, dtype=torch.long)
    for c, walk in enumerate(walks):
        rows = range(c * streams, min(B, (c + 1) * streams))
        assert len(walk) == int(cmax[c].sum())
        assert walk == sorted(walk)                      # blocks, then steps, in order
        for i in rows:
            taken[i] = sum(1 for k, t in walk if t < clamped[i, k])
    assert torch.equal(taken, clamped.sum(1))
    want = K.teacher_force_blocks_plain(kw, s0, ca, cb, lpc, targets, counts, N)
    rng = s0.rng
    for m in range(int(taken.max())):
        _, nxt = M.draw_threshold_bytes(rng)
        rng = type(rng)(*(torch.where(m < taken, a, b) for a, b in zip(nxt, rng)))
    assert all(torch.equal(a, b) for a, b in zip(rng, want.rng))


@pytest.mark.parametrize("form", ["f32", "q8"])
def test_k3_wrapper_with_packs_runs_plain_on_cpu(fused, monkeypatch, form):
    """With K2's packs in the bundle (`masked_kernel_weights`, what the card
    needs) the wrapper on CPU tensors is the plain version on the bare
    bundle, bit for bit, counts no launch, and holds the bars of the
    interpreted TPU kernel: RNG and excitation exact, GRU states within
    1e-4, signal state within 1e-3."""
    monkeypatch.setattr(JK, "_INTERPRET", True)
    jkw, tkw = _bundles(fused, form)
    packed = K.masked_kernel_weights(tkw)
    assert "k2_a" in packed
    s0, ca, cb, lpc, targets, counts = _case(fused[1], seed=44)
    before = K.teacher_force_blocks_kernel.launches
    got = K.teacher_force_blocks_kernel(packed, s0, ca, cb, lpc, targets, counts, N)
    assert K.teacher_force_blocks_kernel.launches == before
    want = K.teacher_force_blocks_plain(tkw, s0, ca, cb, lpc, targets, counts, N)
    for a, b in zip(got[:5] + tuple(got.rng), want[:5] + tuple(want.rng)):
        assert torch.equal(a, b)
    js = JK.teacher_force_blocks_pallas(
        jkw, _jax_state(s0), ca.numpy(), cb.numpy(), lpc.numpy(),
        targets.numpy(), counts.numpy(), JCFG, N, bt=B)
    t = state_to_numpy(got)
    for f in ("z", "w", "jsr", "jcong"):
        assert np.array_equal(t["rng"][f], np.asarray(getattr(js.rng, f))), f
    assert np.array_equal(t["last_exc"], np.asarray(js.last_exc))
    for f, tol in (("gru_a", 1e-4), ("gru_b", 1e-4), ("last_sig", 1e-3),
                   ("deemph", 1e-3)):
        np.testing.assert_allclose(t[f], np.asarray(getattr(js, f)), atol=tol,
                                   err_msg=f)
