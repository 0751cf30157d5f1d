"""The Python side of the kernels redesigned for Hopper, on the CPU: K2's
launch configuration and weight packing (`lpcnet_torch/kernels/
masked_loop.py`) at every width, K5's warp-synchronous forward (the cut and the reading of
the packed Wr). Each reader here mirrors the CUDA source's index
arithmetic: the PTX ISA's fragment layouts of `mma.sync` m16n8k16 (bf16) and
m16n8k32 (s8), the kernel's column order and its operand rows, written out
apart from the packer's own code. The kernels themselves are held against
their plain versions in test_torch_cuda.py and chip_smoke.py; their plain
versions against the JAX package in test_torch_sample_loop.py and
test_torch_gru_train.py."""

import numpy as np
import pytest
import torch

from lpcnet_torch.kernels import gru_train as G
from lpcnet_torch.kernels import masked_loop as ML
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import quantized as Q

torch.set_num_threads(1)

BATCHES = [1, 37, 129, 256, 1024]


def _bundle(form, na, nb=16):
    cfg = M.LPCNetConfig(rnn_units1=na, rnn_units2=nb, cond_size=32,
                         pitch_embed_dim=8)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=5), cfg)
    if form == "q8":
        return K.kernel_weights(Q.quantize_fused(fused), cfg)
    return K.kernel_weights(fused, cfg, dtype={"f32": torch.float32,
                                               "bf16": torch.bfloat16}[form])


def _a_operands(kw):
    if K.is_q8_bundle(kw):
        return kw["a_rec_q8"], kw["b_in_q8"], kw["b_rec_q8"]
    return kw["a_rec"], kw["b_in"], kw["b_rec"]


def _fragment_element(ks, lane, reg, half):
    """(row m, depth k) of the element that lane `lane` holds in register
    `reg` at position `half` (bf16: 0-1, s8: 0-3) of an A fragment."""
    g, t = lane // 4, lane % 4
    m = g + (8 if reg in (1, 3) else 0)
    if ks == 16:
        return m, 2 * t + half + (8 if reg >= 2 else 0)
    return m, 4 * t + half + (16 if reg >= 2 else 0)


def _read_fragments(pack, ks, rows, depth):
    """A [rows, depth] from packed fragments [rows/16, depth/ks, 32, E]."""
    per = 2 if ks == 16 else 4
    a = np.zeros((rows, -(-depth // ks) * ks), pack.dtype)
    for mt in range(pack.shape[0]):
        for kt in range(pack.shape[1]):
            for lane in range(32):
                for e in range(pack.shape[3]):
                    m, k = _fragment_element(ks, lane, e // per, e % per)
                    a[mt * 16 + m, kt * ks + k] = pack[mt, kt, lane, e]
    return a[:, :depth]


def _numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# (Na, the cluster's (C, U)): the default GRU-A, a small one, the LPCNet
# paper's 640 units, and widths that are not multiples of 16 C
SHAPES = {384: (8, 48), 64: (4, 16), 640: (8, 80), 416: (8, 64), 100: (7, 16)}


@pytest.mark.parametrize("na", [384, 64, 640, 416, 100])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_gru_a_slices_rebuild_the_recurrent_matrix(form, na):
    """Every rank of the cluster the launch picks: rank r's local column
    q U + j is gate column q Na + r U + j where r U + j < Na (the kernel's
    gate phase and its f32 product; the units past Na are padding), and in
    bf16 and q8 its packed slice read through the A fragment layout gives
    back those columns of a_rec and zeros for the padding (q8: the int8
    off-diagonal values; the diagonal is read as a_diag[q Na + r U + j]).
    The ranks together cover every column once."""
    kw = _bundle(form, na)
    a_rec = _a_operands(kw)[0]
    c, u = ML.cluster_shape(na)
    assert (c, u) == SHAPES[na]
    ks = 32 if form == "q8" else 16
    ksa = -(-na // ks)
    want = _numpy(a_rec)
    got = np.full_like(want, 0)
    seen = np.zeros(3 * na, int)
    diag_got = np.zeros(3 * na, np.float32)
    pack = None if form == "f32" else ML.pack_gru_a(a_rec)
    for r in range(c):
        units = [j for j in range(u) if r * u + j < na]
        cols = [q * na + r * u + j for q in range(3) for j in units]
        local = [q * u + j for q in range(3) for j in units]
        seen[cols] += 1
        if pack is None:
            got[:, cols] = want[:, cols]
            continue
        assert tuple(pack.shape) == (c, 3 * u // 16, ksa, 32, 16 if form == "q8" else 8)
        assert tuple(pack.shape) == ML.packed_shapes(ML.FORMS[form], na, 16)[0]
        rank = _read_fragments(_numpy(pack[r]), ks, 3 * u, ksa * ks)
        got[:, cols] = rank[local, :na].T
        pad = [q * u + j for q in range(3) for j in range(u) if r * u + j >= na]
        assert not rank[pad].any() and not rank[:, na:].any()
        if form == "q8":
            for col in cols:                          # the gate phase's index
                diag_got[col] = kw["a_diag"][0, col]
    assert (seen == 1).all()
    assert np.array_equal(got, want)
    if form == "q8":
        assert np.array_equal(diag_got, kw["a_diag"][0].numpy())
    if pack is not None:
        assert pack.is_contiguous() and pack.dtype == a_rec.dtype
        # one rank's slice is the 16-byte words the kernel copies
        assert pack[0].numel() * pack.element_size() == 3 * u * ksa * ks * (1 if form == "q8" else 2)


@pytest.mark.parametrize("na,nb", [(384, 16), (64, 16), (100, 10), (640, 24)])
@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_gru_b_pack_rebuilds_its_matrices(form, na, nb):
    """GRU-B's pack: per column tile the input part's ceil(Na/KS) k steps,
    then the recurrent part's, zero beyond Na and Nb; its columns are gate q,
    unit u at q Nbp + u (Nbp = 16 ceil(Nb / 16), the kernel's GRU-B update),
    zero for the padding units."""
    kw = _bundle(form, na, nb)
    _, b_in, b_rec = _a_operands(kw)
    ks = 32 if form == "q8" else 16
    nbp = ML.padded_nb(nb)
    pack = _numpy(ML.pack_gru_b(b_in, b_rec))
    ksbi, ksbr = -(-na // ks), -(-nb // ks)
    assert pack.shape == (3 * nbp // 16, ksbi + ksbr, 32, 16 if form == "q8" else 8)
    assert pack.shape == ML.packed_shapes(ML.FORMS[form], na, nb)[1]
    cols = [q * nbp + u for q in range(3) for u in range(nb)]
    pad = [q * nbp + u for q in range(3) for u in range(nb, nbp)]
    inp = _read_fragments(pack[:, :ksbi], ks, 3 * nbp, ksbi * ks)
    assert np.array_equal(inp[cols, :na].T, _numpy(b_in))
    assert not inp[:, na:].any() and not inp[pad].any()
    rec = _read_fragments(pack[:, ksbi:], ks, 3 * nbp, ksbr * ks)
    assert np.array_equal(rec[cols, :nb].T, _numpy(b_rec))
    assert not rec[:, nb:].any() and not rec[pad].any()


def _mma_tile(pack_tile, x, ks):
    """The kernel's tile_mma on the CPU: out[n, m] = sum over k steps of the
    fragments' A[m, k] times the operand rows' B[k, n] = x[n, k], B read as
    its loads do (lane (g, t) of stream tile row g: the words at t E and
    t E + KS/2 of each k step)."""
    per = 2 if ks == 16 else 4
    out = np.zeros((8, 16), np.float64)
    for kt in range(pack_tile.shape[0]):
        a = np.zeros((16, ks))
        b = np.zeros((ks, 8))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for e in range(pack_tile.shape[2]):
                m, k = _fragment_element(ks, lane, e // per, e % per)
                a[m, k] = pack_tile[kt, lane, e]
            for half in range(per):
                for hi in range(2):
                    k = t * per + half + hi * ks // 2
                    b[k, g] = x[g, kt * ks + k]
        out += (a @ b).T
    return out


@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_fragment_products_equal_the_plain_product(form):
    """A (column tile, stream tile) of GRU-A's product, formed from the
    packed fragments and padded operand rows as the kernel loads them,
    equals the plain h . W on those columns (q8: exactly, int32)."""
    na = 64
    kw = _bundle(form, na)
    a_rec = _a_operands(kw)[0]
    c, u = ML.cluster_shape(na)
    ks = 32 if form == "q8" else 16
    pack = _numpy(ML.pack_gru_a(a_rec))
    rs = np.random.RandomState(3)
    h = torch.from_numpy(np.tanh(rs.normal(size=(8, na))).astype(np.float32))
    if form == "q8":
        x = Q.quantize_act_int8(h).numpy().astype(np.float64)
        w = a_rec.numpy().astype(np.float64)
    else:
        x = h.to(torch.bfloat16).float().numpy().astype(np.float64)
        w = a_rec.float().numpy().astype(np.float64)
    for r in (0, c - 1):
        cols = [q * na + r * u + j for q in range(3) for j in range(u)]
        for mt in range(3 * u // 16):
            got = _mma_tile(pack[r, mt], x, ks)
            want = x @ w[:, cols[mt * 16:(mt + 1) * 16]]
            if form == "q8":
                assert np.array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= 1e-9


@pytest.mark.parametrize("batch", BATCHES)
def test_launch_config_covers_each_stream_once(batch):
    """The clusters' stream ranges [c S, c S + S) ∩ [0, B) cover every
    stream once; S is the smallest of 8, 16 and 32 whose ceil(B / S)
    clusters fit one wave (15 here, as on an H100), else 32 in waves."""
    cfg = ML.masked_launch_config(batch, 384, 16, 1, lambda nt, smem: 15)
    s = cfg["streams"]
    want = next((s for s in (8, 16, 32) if -(-batch // s) <= 15), 32)
    assert s == want == 8 * cfg["nt"]
    assert cfg["waves"] == -(-cfg["clusters"] // 15)
    assert cfg["waves"] == (1 if batch <= 15 * 32 else 3)
    count = np.zeros(batch, int)
    for c in range(cfg["clusters"]):
        b0 = c * s
        nact = min(s, batch - b0)
        assert nact > 0
        count[b0:b0 + nact] += 1
    assert (count == 1).all()
    assert cfg["cluster"] == 8


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_shared_memory_fits_a_block(form, nt):
    """At Na=384, Nb=16 a block's shared memory is within the H100's
    232,448 bytes in every form and stream tiling the launch can pick; the
    bf16 and q8 forms hold their whole GRU-A slice there, and GRU-B's packed
    weights too at 8 and 16 streams (bf16 at 32 streams reads GRU-B's from
    L2: both would take 246,800 bytes)."""
    f = ML.FORMS[form]
    cfg = ML.masked_launch_config(8 * nt * 15, 384, 16, f, lambda n, smem: 15)
    assert cfg["nt"] == nt
    smem = cfg["smem"]
    assert smem == ML.masked_smem_bytes(f, 384, 16, nt, cfg["res_a"], cfg["res_b"])
    assert smem <= ML.SMEM_LIMIT
    if form != "f32":
        assert cfg["res_a"] and smem > 3 * 48 * 384 * (2 if form == "bf16" else 1)
        assert cfg["res_b"] == (nt < 4 or form == "q8")
    if form == "bf16" and nt == 4:
        assert ML.masked_smem_bytes(f, 384, 16, 4) == 246800


def test_launch_config_follows_the_cards_cluster_count():
    """Where the card holds fewer clusters of 8 streams than the batch
    needs, the launch takes 16 streams a cluster."""
    ask = lambda nt, smem: 12
    assert ML.masked_launch_config(96, 384, 16, 1, ask)["streams"] == 8
    assert ML.masked_launch_config(97, 384, 16, 1, ask)["streams"] == 16


@pytest.mark.parametrize("na,nb", [(0, 16), (384, 0), (8192, 16)])
def test_widths_the_kernel_refuses(na, nb):
    """No width, and a GRU-A too wide for a block's shared memory even with
    its weights in L2 (the first design, a block of 4 streams with its
    state in shared memory, refused 8192 units too)."""
    with pytest.raises(ValueError):
        ML.masked_launch_config(8, na, nb, 1, lambda nt, smem: 16)


@pytest.mark.parametrize("na,nb", [(512, 16), (640, 16), (416, 16), (352, 16),
                                   (48, 16), (100, 10), (384, 8), (1024, 32)])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("batch", [64, 128, 256])
def test_widths_the_first_design_served(form, na, nb, batch):
    """Every width runs: where a block cannot hold its GRU-A slice beside
    the rest (bf16 at Na = 640: 307,200 bytes a slice) it reads it from L2, and GRU-B's
    weights likewise; the layout always fits a block."""
    f = ML.FORMS[form]
    cfg = ML.masked_launch_config(batch, na, nb, f, lambda nt, smem: 15)
    assert cfg["smem"] <= ML.SMEM_LIMIT
    assert cfg["smem"] == ML.masked_smem_bytes(f, na, nb, cfg["nt"], cfg["res_a"],
                                               cfg["res_b"])
    assert (cfg["cluster"], cfg["units"]) == ML.cluster_shape(na)
    assert cfg["cluster"] * cfg["units"] >= na and cfg["units"] % 16 == 0
    if form == "f32":
        assert not cfg["res_a"] and not cfg["res_b"]
    if form == "bf16" and na >= 640:
        assert not cfg["res_a"]
    if (na, form) in ((384, "bf16"), (384, "q8"), (640, "q8")) and batch <= 128:
        assert cfg["res_a"]


@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_masked_kernel_weights_hold_the_packs(form):
    """K2's bundle is the bundle plus the packs (none in f32), built once;
    the wrapper's plain version takes it as it takes the bundle."""
    kw = _bundle(form, 64)
    mk = K.masked_kernel_weights(kw)
    assert all(mk[k] is v for k, v in kw.items())
    if form == "f32":
        assert mk["k2_a"] is None and mk["k2_b"] is None
    else:
        a, bi, br = _a_operands(kw)
        assert torch.equal(mk["k2_a"], ML.pack_gru_a(a))
        assert torch.equal(mk["k2_b"], ML.pack_gru_b(bi, br))
    cfg = M.LPCNetConfig(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
    b, n = 3, 4
    rs = np.random.RandomState(1)
    ca = torch.from_numpy(rs.normal(size=(b, 3 * 64)).astype(np.float32))
    cb = torch.from_numpy(rs.normal(size=(b, 3 * 16)).astype(np.float32))
    lpc = torch.from_numpy(rs.normal(size=(b, 16)).astype(np.float32) * 0.1)
    tg = torch.from_numpy(rs.normal(size=(b, n)).astype(np.float32) * 100)
    tf = torch.from_numpy(rs.rand(b, n) < 0.5)
    adv = torch.ones((b, n), dtype=torch.bool)
    s0 = M.init_sample_state(b, cfg, torch.device("cpu"))
    got = K.synthesize_frame_masked_kernel(mk, s0, ca, cb, lpc, tg, tf, adv, n)
    want = K.sample_loop_masked_plain(kw, s0, ca, cb, lpc, tg, tf, adv, n)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0].gru_a, want[0].gru_a)


@pytest.mark.parametrize("n", [16, 32, 48, 64, 384])
def test_small_forward_cut(n):
    """The warp-synchronous forward takes N <= 32: a stream's units fit in
    a warp's lanes (the C entry refuses other widths); wider GRUs keep the
    cluster forward, whose launch shape is unchanged."""
    assert G.forward_uses_warp(n) == (n <= 32)
    assert G.launch_config(n) == ((4, n) if n >= 256 else (1, 4 * n))


@pytest.mark.parametrize("n", [16, 32])
def test_warp_forward_reads_wr_from_the_packed_layout(n):
    """Lane u of the warp forward loads w[q][4 kq + j] from the 8-byte word
    wp + ((kq * 3 + q) * N + u) * 4: those words rebuild bf16(Wr)."""
    wr = torch.from_numpy(np.random.RandomState(n).normal(
        size=(n, 3 * n)).astype(np.float32))
    flat = G.pack_recurrent(wr).reshape(-1)
    got = torch.empty(n, 3 * n, dtype=torch.bfloat16)
    for u in range(n):
        for kq in range(n // 4):
            for q in range(3):
                base = ((kq * 3 + q) * n + u) * 4
                for j in range(4):
                    got[4 * kq + j, q * n + u] = flat[base + j]
    assert torch.equal(got, wr.to(torch.bfloat16))


# --------------------------------------------------------------------------
# K1: the free-running form of K2's kernel
# --------------------------------------------------------------------------

# streams, and the (S, waves) the design gives on a card that holds 15
# clusters of 8 blocks (an H100): the smallest S of 8, 16, 32 and 40 that
# fits one wave, else the fewest waves
FREE_CASES = {1: (8, 1), 130: (16, 1), 256: (32, 1), 1024: (40, 2), 4097: (40, 7)}


@pytest.mark.parametrize("batch", sorted(FREE_CASES))
@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_free_launch_config_covers_each_stream_once(form, batch):
    """Every stream in one cluster, its GRU-A gate phase in every rank and
    its tail (GRU-B to PCM) in exactly one: rank r of the cluster runs
    streams [r SO, r SO + SO), SO = ceil(S / C) <= 8 (one GRU-B tile of 8
    rows). 1024 streams take two waves of S = 40, not three of 32."""
    cfg = ML.free_launch_config(batch, 384, 16, ML.FORMS[form], lambda nt, smem: 15)
    s, c = cfg["streams"], cfg["cluster"]
    assert (s, cfg["waves"]) == FREE_CASES[batch]
    assert s == 8 * cfg["nt"] and cfg["nt"] in ML.FREE_STREAM_TILES
    assert cfg["clusters"] == -(-batch // s) and cfg["waves"] == -(-cfg["clusters"] // 15)
    so = -(-s // c)
    assert so <= 8 and c == 8
    tail = np.zeros(batch, int)
    gate = np.zeros(batch, int)
    for k in range(cfg["clusters"]):
        b0 = k * s
        nact = min(s, batch - b0)
        assert nact > 0
        gate[b0:b0 + nact] += c
        for r in range(c):
            s0 = r * so
            own = max(0, min(so, s - s0, nact - s0))
            tail[b0 + s0:b0 + s0 + own] += 1
    assert (tail == 1).all() and (gate == c).all()


@pytest.mark.parametrize("nt", [1, 2, 4, 5])
@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_free_shared_memory_fits_a_block(form, nt):
    """The free-running layout fits a block in both of its forms and every
    tiling, GRU-A's slice resident; bf16 at S = 40 takes 224,176 bytes
    with GRU-B's weights read from L2, and S = 48 would not fit with the
    slice resident (243,120 bytes). There is no f32 form: f32 K1 runs the
    first design's kernel."""
    f = ML.FORMS[form]
    cfg = ML.free_launch_config(8 * nt * 15, 384, 16, f, lambda n, smem: 15)
    assert cfg["nt"] == nt
    assert cfg["smem"] == ML.masked_smem_bytes(f, 384, 16, nt, cfg["res_a"],
                                               cfg["res_b"], free=True)
    assert cfg["smem"] <= ML.SMEM_LIMIT
    assert cfg["res_a"]
    with pytest.raises(ValueError):
        ML.free_launch_config(8 * nt * 15, 384, 16, 0, lambda n, smem: 15)
    if form == "bf16" and nt == 5:
        assert cfg["smem"] == 224176 and not cfg["res_b"]
        assert ML.masked_smem_bytes(f, 384, 16, 6, True, False, free=True) == 243120


@pytest.mark.parametrize("na,nb", [(640, 16), (100, 10), (48, 16), (16, 16)])
def test_free_launch_config_at_other_widths(na, nb):
    """Other widths run too: each rank's tail is at most 8 streams (a
    cluster of C < 8 blocks takes S <= 8 C) and the layout fits."""
    for form in (1, 2):
        for batch in (1, 37, 1024):
            cfg = ML.free_launch_config(batch, na, nb, form, lambda n, smem: 15)
            assert -(-cfg["streams"] // cfg["cluster"]) <= 8
            assert cfg["smem"] <= ML.SMEM_LIMIT


@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_k1_dispatch_is_by_form(form):
    """bf16 and q8 bundles run the free-running cluster kernel, f32 the
    first design's kernel: `k1_form` reads the bundle, with or without K2's
    packs."""
    kw = _bundle(form, 64)
    want = ML.FORMS[form]
    assert K.k1_form(kw) == K.k1_form(K.masked_kernel_weights(kw)) == want
    assert (want in K.FREE_FORMS) == (form != "f32")


def test_decoder_holds_k1_packs_built_once(monkeypatch):
    """The decoder's bundle carries K1's packs (`k2_a`, `k2_b`), built
    when the decoder is built and not again for any frame."""
    from lpcnet_torch.codec.decoder import LPCNetDecoder
    cfg = M.LPCNetConfig(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=5), cfg)
    calls = []
    real = K.masked_kernel_weights
    monkeypatch.setattr(K, "masked_kernel_weights",
                        lambda kw: calls.append(1) or real(kw))
    dec = LPCNetDecoder.from_fused(fused, cfg, 3, device="cpu", use_kernel=True)
    assert len(calls) == 1
    kw = dec._kw
    a, bi, br = _a_operands(K.kernel_weights(dec.fused, cfg))
    assert torch.equal(kw["k2_a"], ML.pack_gru_a(a))
    assert torch.equal(kw["k2_b"], ML.pack_gru_b(bi, br))
    packs = (kw["k2_a"], kw["k2_b"])
    rs = np.random.RandomState(2)
    for _ in range(4):
        dec.synthesize((rs.normal(size=(3, 36)) * 0.3).astype(np.float32))
    assert len(calls) == 1
    assert dec._kw["k2_a"] is packs[0] and dec._kw["k2_b"] is packs[1]


@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_k1_wrapper_with_packs_runs_plain_on_cpu_and_refuses_others(form):
    """With K1's packs in the bundle the wrapper still runs
    `sample_loop_plain` on a CPU tensor and counts no launch; a tensor on
    another device is refused."""
    kw = K.masked_kernel_weights(_bundle(form, 64))
    cfg = M.LPCNetConfig(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)
    b, n = 3, 6
    rs = np.random.RandomState(3)
    ca = torch.from_numpy(rs.normal(size=(b, 3 * 64)).astype(np.float32))
    cb = torch.from_numpy(rs.normal(size=(b, 3 * 16)).astype(np.float32))
    lpc = torch.from_numpy(rs.normal(size=(b, 16)).astype(np.float32) * 0.1)
    s0 = M.init_sample_state(b, cfg, torch.device("cpu"))
    before = K.synthesize_frame_kernel.launches
    got = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, n)
    want = K.sample_loop_plain(kw, s0, ca, cb, lpc, n)
    assert K.synthesize_frame_kernel.launches == before
    assert torch.equal(got[1], want[1]) and torch.equal(got[0].gru_a, want[0].gru_a)
    with pytest.raises(ValueError):
        K.synthesize_frame_kernel(kw, s0, ca.to("meta"), cb, lpc, n)


# streams -> (S, clusters) of the teacher-forced form (K3) on a card that
# holds 15 clusters of 8 blocks: the smallest S of 8, 16, 32 in one wave, else
# 32 in waves
TF_CASES = {1: (8, 1), 37: (8, 5), 64: (8, 8), 256: (32, 8), 1024: (32, 32)}


@pytest.mark.parametrize("batch", sorted(TF_CASES))
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_tf_launch_config_covers_each_stream_once(form, batch):
    """K3's launch over 3 conditioning blocks: every stream in one cluster,
    its GRU-A gate phase in every rank, its GRU-B and its KISS99 words in
    exactly one (rank r owns [r SO, r SO + SO), SO = ceil(S / C) <= 8, as
    in the free-running form); the block's shared memory is the layout's
    (csrc K2Layout with the counts of S streams a block) and fits the card.
    The PLC path's compacted drain (64 streams) takes 8 clusters of 8."""
    f = ML.FORMS[form]
    cfg = ML.tf_launch_config(batch, 384, 16, f, 3, lambda nt, smem: 15)
    s, c = cfg["streams"], cfg["cluster"]
    assert (s, cfg["clusters"]) == TF_CASES[batch] and s == 8 * cfg["nt"]
    assert cfg["waves"] == -(-cfg["clusters"] // 15)
    assert cfg["smem"] == ML.masked_smem_bytes(f, 384, 16, cfg["nt"], cfg["res_a"],
                                               cfg["res_b"], tf_blocks=3)
    assert cfg["smem"] <= ML.SMEM_LIMIT
    assert cfg["res_a"] == (form != "f32")
    so = -(-s // c)
    assert so <= 8 and c == 8
    tail = np.zeros(batch, int)
    gate = np.zeros(batch, int)
    for k in range(cfg["clusters"]):
        b0 = k * s
        nact = min(s, batch - b0)
        assert nact > 0
        gate[b0:b0 + nact] += c
        for r in range(c):
            own = max(0, min(so, s - r * so, nact - r * so))
            tail[b0 + r * so:b0 + r * so + own] += 1
    assert (tail == 1).all() and (gate == c).all()


@pytest.mark.parametrize("nt", [1, 2, 4])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_tf_shared_memory_layout(form, nt):
    """The teacher-forced layout at Na=384, Nb=16 against the masked one:
    the tail of 8 rows and the 8 extra operand rows of the free-running
    form, no node logits, codes or threshold table, and 4 (S + 1) bytes a
    conditioning block for the counts; bf16 keeps GRU-A's slice resident at
    every S and GRU-B's below 32 streams (the card's run at 64 streams read
    184,704 bytes a block)."""
    f = ML.FORMS[form]
    base = ML.masked_smem_bytes(f, 384, 16, nt, False, False, free=True)
    tf = {n: ML.masked_smem_bytes(f, 384, 16, nt, False, False, tf_blocks=n)
          for n in (1, 3, 20)}
    s = 8 * nt
    up = lambda x: -(-x // 16) * 16
    free_only = up(8 * 32 * 4) + up((4 * s + 8) * 4) + 256 * 4
    assert tf[3] == base - free_only + up(3 * (s + 1) * 4)
    assert tf[20] - tf[1] == up(20 * (s + 1) * 4) - up((s + 1) * 4)
    if form == "bf16":
        cfg = ML.tf_launch_config(8 * nt * 15, 384, 16, f, 3, lambda n, smem: 15)
        assert cfg["res_a"] and cfg["res_b"] == (nt < 4)
        if nt == 1:
            assert cfg["smem"] == 184704


@pytest.mark.parametrize("na,nb", [(640, 16), (100, 10), (64, 16), (16, 16)])
def test_tf_launch_config_at_other_widths(na, nb):
    """Other widths run too: each rank's GRU-B tail is at most 8 streams and
    the layout fits a block."""
    for form in (0, 1, 2):
        for batch in (1, 37, 256):
            cfg = ML.tf_launch_config(batch, na, nb, form, 3, lambda n, smem: 15)
            assert -(-cfg["streams"] // cfg["cluster"]) <= 8
            assert cfg["smem"] <= ML.SMEM_LIMIT
            assert cfg["clusters"] * cfg["streams"] >= batch


def test_tf_launch_config_refuses_no_blocks():
    with pytest.raises(ValueError):
        ML.tf_launch_config(8, 384, 16, 1, 0, lambda n, smem: 15)
    with pytest.raises(ValueError):
        ML.tf_launch_config(0, 384, 16, 1, 3, lambda n, smem: 15)
