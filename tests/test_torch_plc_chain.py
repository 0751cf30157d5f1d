"""The PLC-net chain's Python side (K4: weight bundle, plain version,
wrapper) vs the JAX package, on the CPU. The CUDA kernel itself is held
against its plain version in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import plc_chain as JPC
from lpcnet_tpu.models import plc as JPM

from lpcnet_torch.kernels import plc_chain as PC
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.plc import batched as BP
from lpcnet_torch.weights.convert import params_to_torch

torch.set_num_threads(1)

B = 8


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def params():
    """(JAX params, port params) of the PLC net from one numpy-seeded init,
    with non-zero biases so every term is exercised."""
    rs = np.random.RandomState(7)
    p = _numpy_tree(PM.init_params(seed=3))
    for layer in p.values():
        layer["bias"] = (rs.normal(size=layer["bias"].shape) * 0.1
                         ).astype(np.float32)
    return jax.tree.map(jnp.asarray, p), params_to_torch(p)


def _case(k_steps, seed):
    rs = np.random.RandomState(seed)
    h1 = np.tanh(rs.randn(B, 256)).astype(np.float32)
    h2 = np.tanh(rs.randn(B, 256)).astype(np.float32)
    inputs = (rs.randn(B, k_steps, PM.PLC_INPUT_SIZE) * 0.5).astype(np.float32)
    masks = rs.rand(B, k_steps) < 0.6
    masks[0] = False                                 # one stream never moves
    return h1, h2, inputs, masks


@pytest.mark.parametrize("k_steps", [1, 4])
def test_plain_k4_matches_pallas_interpret(params, monkeypatch, k_steps):
    """K4's plain version vs the TPU kernel run by the Pallas interpreter:
    states after every step within 2e-5, outputs within 2e-4 (the JAX
    package's bars for its kernel), a frozen stream's states exact."""
    monkeypatch.setattr(JPC, "_INTERPRET", True)
    jp, tp = params
    h1, h2, inputs, masks = _case(k_steps, 0)
    jh1, jh2, jout = JPC.plc_chain_pallas(
        JPC.plc_chain_weights(jp), jnp.asarray(h1), jnp.asarray(h2),
        jnp.asarray(inputs), jnp.asarray(masks), k_steps, bt=B)
    t = torch.from_numpy
    th1, th2, tout = PC.plc_chain_plain(PC.plc_chain_weights(tp), t(h1), t(h2),
                                        t(inputs), t(masks), k_steps)
    assert tout.shape == (B, k_steps, 20)
    np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=2e-5)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), atol=2e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-4)
    for k in range(k_steps):
        assert np.array_equal(th1.numpy()[0, k], h1[0])
        assert np.array_equal(th2.numpy()[0, k], h2[0])


@pytest.mark.parametrize("k_steps", [1, 4])
def test_plain_k4_matches_stepwise_compute_plc_pred(params, k_steps):
    """The chain vs masked `compute_plc_pred` calls in a row (the path the
    flag chooses against), the +0.1 boost applied by the caller as the
    batched step does: states 2e-5, outputs 2e-4; and the wrapper takes the
    plain version on CPU tensors without counting a launch."""
    _, tp = params
    h1, h2, inputs, masks = (torch.from_numpy(x) for x in _case(k_steps, 1))
    before = PC.plc_chain_kernel.launches
    h1s, h2s, outs = PC.plc_chain_kernel(PC.plc_chain_weights(tp), h1, h2,
                                         inputs, masks, k_steps)
    assert PC.plc_chain_kernel.launches == before
    outs[:, :, -1] = torch.clamp(outs[:, :, -1] + 0.1, max=0.5)
    st = PM.PLCNetState(h1, h2)
    for k in range(k_steps):
        new, out = PM.compute_plc_pred(tp, st, inputs[:, k])
        m = masks[:, k][:, None]
        st = PM.PLCNetState(torch.where(m, new.gru1, st.gru1),
                            torch.where(m, new.gru2, st.gru2))
        np.testing.assert_allclose(h1s[:, k].numpy(), st.gru1.numpy(), atol=2e-5)
        np.testing.assert_allclose(h2s[:, k].numpy(), st.gru2.numpy(), atol=2e-5)
        np.testing.assert_allclose(outs[:, k].numpy(), out.numpy(), atol=2e-4)


def test_k4_wrapper_refuses_other_devices(params):
    _, tp = params
    h1, h2, inputs, masks = (torch.from_numpy(x) for x in _case(2, 2))
    with pytest.raises(ValueError):
        PC.plc_chain_kernel(PC.plc_chain_weights(tp), h1.to("meta"), h2,
                            inputs, masks, 2)


# --------------------------------------------------------------------------
# The cluster design's layout (csrc/plc_chain.cu), read back by index
# arithmetic written out apart from the packer's code
# --------------------------------------------------------------------------

C = PC.CLUSTER


@pytest.fixture(scope="module")
def packed(params):
    return PC.plc_chain_weights(params[1])


def test_per_rank_packs_rebuild_every_matrix(packed):
    """Rank r's packed GRU matrix [k, 3U + 8] holds, at local column
    q U + j, gate column q n + r U + j of the original (U = n / C), and zeros
    in the 8 columns of padding; its dense units' pack [n_in, nd / C] holds
    columns r nd / C + j. Together the ranks' packs hold every entry once."""
    cw = packed
    for name, n in (("g1_in", 256), ("g1_rec", 256), ("g2_in", 256), ("g2_rec", 256)):
        w, pk = cw[name].numpy(), cw["k4_" + name].numpy()
        u = n // C
        assert pk.shape == (C, w.shape[0], 3 * u + PC.RING_PAD)
        seen = np.zeros(w.shape, int)
        for r in range(C):
            for lc in range(3 * u):
                col = (lc // u) * n + r * u + lc % u
                assert np.array_equal(pk[r, :, lc], w[:, col]), (name, r, lc)
                seen[:, col] += 1
            assert not pk[r, :, 3 * u:].any()
        assert (seen == 1).all(), name
    d1, pk = cw["d1_w"].numpy(), cw["k4_d1"].numpy()
    ud = d1.shape[1] // C
    for r in range(C):
        assert np.array_equal(pk[r], d1[:, r * ud:(r + 1) * ud])


def test_rank_biases_and_outputs_gather_every_entry(packed):
    """The kernel's gathers of a rank's biases (dst[i] = bias[part 3n +
    (lc / u) n + r u + lc % u], i = part 3u + lc) and of its output columns
    (outputs r, r + C, ...) take every bias of both GRUs and every output
    column once."""
    cw = packed
    for name, n in (("g1_b", 256), ("g2_b", 256)):
        bias = cw[name].numpy().reshape(-1)
        u = n // C
        seen = np.zeros(bias.shape, int)
        for r in range(C):
            for i in range(6 * u):
                part, lc = i // (3 * u), i % (3 * u)
                seen[part * 3 * n + (lc // u) * n + r * u + lc % u] += 1
        assert (seen == 1).all()
    n_out = cw["out_w"].shape[1]
    outs = sorted(r + C * j for r in range(C) for j in range(-(-(n_out - r) // C)))
    assert outs == list(range(n_out))


@pytest.mark.parametrize("streams", PC.STREAMS)
def test_product_tiles_and_parts_cover_each_term_once(streams):
    """The product's thread mapping (tid -> part kp = tid % KP, tile
    tid / KP -> 4 streams x 4 columns) over the block's 384 threads: every
    (stream, column) output is one tile's, every k of it one part's; the KP
    lanes of a tile sit in one warp, a power of two of them, so the
    shuffles that sum them stay in the warp."""
    nc = 3 * 256 // C
    kp_n = PC.k_parts(nc, streams)
    assert kp_n in (1, 2, 4, 8, 16, 32)
    cover = np.zeros((streams, nc, kp_n), int)
    for tid in range(PC.THREADS):
        kp, tile = tid % kp_n, tid // kp_n
        sq, cq = tile % (streams // 4), tile // (streams // 4)
        assert (tile * kp_n) // 32 == (tile * kp_n + kp_n - 1) // 32
        cover[4 * sq:4 * sq + 4, 4 * cq:4 * cq + 4, kp] += 1
    assert (cover == 1).all()


def test_ring_chunks_cover_each_matrix_once():
    """The chunk table a step (the kernel's descriptors): the rows of GRU-1's
    input and recurrent matrices, then GRU-2's input and recurrent ones, in
    chunks of `rows` rows, each row once, the count within the table."""
    for rows, _ in PC.RING_SHAPES:
        chunks = []
        for seg, k in enumerate((128, 256, 256, 256)):
            chunks += [(seg, r0, min(rows, k - r0)) for r0 in range(0, k, rows)]
        assert len(chunks) == PC.ring_chunks(128, 256, 256, rows) <= PC.RING_CHUNKS
        for seg, k in enumerate((128, 256, 256, 256)):
            assert sum(n for s, _, n in chunks if s == seg) == k


@pytest.mark.parametrize("batch", [1, 3, 37, 64, 160, 256, 1024])
def test_chain_launch_config(batch):
    """The launch on a card of 132 SMs that holds 15 clusters of 8 blocks:
    S the smallest of 8, 16, 32 whose clusters fit one wave on at most 132
    SMs, else 32 in waves; the clusters cover each stream once; the ring
    takes the largest chunks that fit (256 streams: 8 clusters of 32, 2
    chunks of 48 rows) and the block's shared memory fits the card."""
    cfg = PC.chain_launch_config(batch, 57, 128, 256, 256, 20, lambda s, smem: 15, 132)
    s = cfg["streams"]
    want = next((x for x in PC.STREAMS if -(-batch // x) <= 15 and -(-batch // x) * C <= 132),
                32)
    assert s == want and cfg["clusters"] == -(-batch // s)
    assert cfg["waves"] == -(-cfg["clusters"] // 15)
    assert cfg["smem"] == PC.chain_smem_bytes(s, 57, 128, 256, 256, 20, cfg["stages"],
                                              cfg["rows"]) <= PC.SMEM_LIMIT
    assert (cfg["rows"], cfg["stages"]) == next(
        rn for rn in PC.RING_SHAPES
        if PC.chain_smem_bytes(s, 57, 128, 256, 256, 20, rn[1], rn[0]) <= PC.SMEM_LIMIT)
    if batch == 256:
        assert (s, cfg["clusters"], cfg["rows"], cfg["stages"]) == (32, 8, 48, 2)
    count = np.zeros(batch, int)
    for c in range(cfg["clusters"]):
        count[c * s:min(batch, (c + 1) * s)] += 1
    assert (count == 1).all()


def test_plc_step_refuses_fastchain_without_chain_weights():
    """The chain (K4) runs only in the causal fused step on the kernels,
    where the pool packs its bundle once: a pool asked for the chain on the
    plain model, the two-path step or the non-causal mode raises before any
    work, and packs nothing."""
    cfg = M.LPCNetConfig(lookahead=0)
    for options in (dict(use_kernel=False),
                    dict(use_kernel=True, fused_step=False),
                    dict(use_kernel=True, non_causal=True)):
        with pytest.raises(ValueError, match="chain kernel"):
            BP.BatchedPLC(None, cfg, None, 1, chain=True, device="cpu",
                          **options)


def test_chain_launch_config_refuses_widths_it_cannot_split():
    with pytest.raises(ValueError):
        PC.chain_launch_config(8, 57, 100, 256, 256, 20, lambda s, smem: 15, 132)
    with pytest.raises(ValueError):
        PC.chain_launch_config(0, 57, 128, 256, 256, 20, lambda s, smem: 15, 132)
