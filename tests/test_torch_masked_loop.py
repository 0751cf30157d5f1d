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


# (Na, the cluster's (C, U)) in bf16 and q8, and in f32 (clusters of up to
# 16 blocks, U a multiple of 4): the default GRU-A, a small one, the LPCNet
# paper's 640 units, and widths that are not multiples of 16 C
SHAPES = {384: (8, 48), 64: (4, 16), 640: (8, 80), 416: (8, 64), 100: (7, 16)}
SHAPES_F32 = {384: (16, 24), 64: (4, 16), 640: (16, 40), 416: (16, 28), 100: (7, 16)}


def _read_f32_pack(rank):
    """A rank's f32 slice [3U | 1, ceil(Na/4) 4] from its pack [kq, 3U | 1,
    4], read as the kernel's f32_tile does: the 16-byte word of (k quad q,
    local column lc) at q (3U | 1) + lc holds k = 4 q .. 4 q + 3."""
    kq, ncolp, _ = rank.shape
    return rank.transpose(1, 0, 2).reshape(ncolp, 4 * kq)


@pytest.mark.parametrize("na", [384, 64, 640, 416, 100])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_gru_a_slices_rebuild_the_recurrent_matrix(form, na):
    """Every rank of the cluster the launch picks: rank r's local column
    q U + j is gate column q Na + r U + j where r U + j < Na (the kernel's
    gate phase; the units past Na are padding), and its packed slice read
    as the kernel reads it (bf16 and q8 through the A fragment layout, f32
    by k quads) gives back those columns of a_rec and zeros for the padding
    and past Na (q8: the int8 off-diagonal values; the diagonal is read as
    a_diag[q Na + r U + j]). The ranks together cover every column once."""
    kw = _bundle(form, na)
    a_rec = _a_operands(kw)[0]
    c, u = ML.cluster_shape(na, ML.FORMS[form])
    assert (c, u) == (SHAPES_F32 if form == "f32" else SHAPES)[na]
    ks = 32 if form == "q8" else 16
    ksa = -(-na // ks)
    want = _numpy(a_rec)
    got = np.full_like(want, 0)
    seen = np.zeros(3 * na, int)
    diag_got = np.zeros(3 * na, np.float32)
    pack = ML.pack_gru_a(a_rec)
    assert tuple(pack.shape) == ML.packed_shapes(ML.FORMS[form], na, 16)[0]
    for r in range(c):
        units = [j for j in range(u) if r * u + j < na]
        cols = [q * na + r * u + j for q in range(3) for j in units]
        local = [q * u + j for q in range(3) for j in units]
        seen[cols] += 1
        if form == "f32":
            assert tuple(pack.shape) == (c, -(-na // 4), 3 * u | 1, 4)
            rank = _read_f32_pack(_numpy(pack[r]))
            got[:, cols] = rank[local, :na].T
            pad = [q * u + j for q in range(3) for j in range(u) if r * u + j >= na]
            assert not rank[pad].any() and not rank[:, na:].any()
            assert not rank[3 * u:].any()             # the odd row's spare word
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
    assert pack.is_contiguous() and pack.dtype == a_rec.dtype
    # one rank's slice is the 16-byte words the kernel copies
    assert pack[0].numel() * pack.element_size() == (
        (3 * u | 1) * -(-na // 4) * 16 if form == "f32" else
        3 * u * ksa * ks * (1 if form == "q8" else 2))


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
    c, u = ML.cluster_shape(na, ML.FORMS[form])
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
    232,448 bytes in every form and stream tiling the launch can pick; every
    form holds its whole GRU-A slice there (f32: 112,128 bytes packed, on
    clusters of 16, at 8 and 16 streams; at 32, 247,824 bytes would not
    fit, so 480 streams take S = 16 in waves), and bf16 and q8 GRU-B's
    packed weights too at 8 and 16 streams (bf16 at 32 streams reads
    GRU-B's from L2: both would take 246,800 bytes)."""
    f = ML.FORMS[form]
    cfg = ML.masked_launch_config(8 * nt * 15, 384, 16, f, lambda n, smem: 15)
    assert cfg["nt"] == (min(nt, 2) if form == "f32" else nt)
    smem = cfg["smem"]
    assert smem == ML.masked_smem_bytes(f, 384, 16, cfg["nt"], cfg["res_a"], cfg["res_b"])
    assert smem <= ML.SMEM_LIMIT
    slice_a = 73 * 96 * 16 if form == "f32" else 3 * 48 * 384 * (2 if form == "bf16" else 1)
    assert cfg["res_a"] and smem > slice_a
    if form == "f32":
        assert cfg["cluster"] == 16 and not cfg["res_b"]
        assert ML.masked_smem_bytes(f, 384, 16, 4) == 247824
    else:
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
    the rest (bf16 at Na = 640: 307,200 bytes a slice; f32 from Na = 512,
    196,608 bytes on clusters of 16) it reads it from L2, and GRU-B's
    weights likewise (f32's always); the layout always fits a block."""
    f = ML.FORMS[form]
    cfg = ML.masked_launch_config(batch, na, nb, f, lambda nt, smem: 15)
    assert cfg["smem"] <= ML.SMEM_LIMIT
    assert cfg["smem"] == ML.masked_smem_bytes(f, na, nb, cfg["nt"], cfg["res_a"],
                                               cfg["res_b"])
    assert (cfg["cluster"], cfg["units"]) == ML.cluster_shape(na, f)
    assert cfg["cluster"] * cfg["units"] >= na
    assert cfg["units"] % (4 if form == "f32" else 16) == 0
    if form == "f32":
        assert cfg["res_a"] == (na <= 416) and not cfg["res_b"]
    if form == "bf16" and na >= 640:
        assert not cfg["res_a"]
    if (na, form) in ((384, "bf16"), (384, "q8"), (640, "q8")) and batch <= 128:
        assert cfg["res_a"]


@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_masked_kernel_weights_hold_the_packs(form):
    """K2's bundle is the bundle plus the packs (f32: GRU-A's rank pack and
    no GRU-B pack), built once; the wrapper's plain version takes it as it
    takes the bundle."""
    kw = _bundle(form, 64)
    mk = K.masked_kernel_weights(kw)
    assert all(mk[k] is v for k, v in kw.items())
    a, bi, br = _a_operands(kw)
    assert torch.equal(mk["k2_a"], ML.pack_gru_a(a))
    if form == "f32":
        assert mk["k2_b"] is None
    else:
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


# streams -> (S, waves) of the f32 free-running form on a card that holds 7
# clusters of 16 blocks (an H100): the smallest S of 8, 16, 32 and 40 in
# one wave, else the fewest waves
F32_FREE_CASES = {1: (8, 1), 4: (8, 1), 37: (8, 1), 1024: (40, 4), 4097: (40, 15)}


@pytest.mark.parametrize("batch", sorted(F32_FREE_CASES))
def test_f32_free_launch_config_covers_each_stream_once(batch):
    """K1 in f32 on clusters of 16 blocks (U = 24 at Na = 384), GRU-A's
    slice resident: every stream in one cluster, its gate phase in every
    rank and its tail in exactly one (SO = ceil(S / 16): at S = 8 ranks
    8-15 own no tail, at 40 ranks 0-12 three each and rank 13 one); the
    block's shared memory is the layout's (csrc k2_layout) and fits the
    card."""
    cfg = ML.free_launch_config(batch, 384, 16, 0, lambda nt, smem: 7)
    s, c = cfg["streams"], cfg["cluster"]
    assert (s, cfg["waves"]) == F32_FREE_CASES[batch] and s == 8 * cfg["nt"]
    assert (c, cfg["units"]) == (16, 24) and cfg["res_a"] and not cfg["res_b"]
    assert cfg["smem"] == ML.masked_smem_bytes(0, 384, 16, cfg["nt"], True, False, free=True)
    assert cfg["smem"] <= ML.SMEM_LIMIT
    assert cfg["clusters"] == -(-batch // s) and cfg["waves"] == -(-cfg["clusters"] // 7)
    so = -(-s // c)
    tail = np.zeros(batch, int)
    gate = np.zeros(batch, int)
    owners = 0
    for k in range(cfg["clusters"]):
        b0 = k * s
        nact = min(s, batch - b0)
        gate[b0:b0 + nact] += c
        for r in range(c):
            own = max(0, min(so, s - r * so, nact - r * so))
            owners += own > 0
            tail[b0 + r * so:b0 + r * so + own] += 1
    assert (tail == 1).all() and (gate == c).all()
    if s == 8:
        assert so == 1 and all(max(0, min(so, s - r * so)) == 0 for r in range(8, 16))


# streams -> the kernel f32 K1 takes on a card that holds 7 clusters of 16
# blocks (an H100): the cluster kernel up to two waves (7 x 40 streams a
# wave), the first design above
F32_ROUTES = {1: "cluster", 4: "cluster", 37: "cluster", 280: "cluster", 560: "cluster",
              561: "first", 1024: "first", 4097: "first"}


@pytest.mark.parametrize("batch", sorted(F32_ROUTES))
def test_f32_route_by_waves(batch):
    """f32 K1 (and K6) run the cluster kernel while its launch takes at
    most `F32_CLUSTER_WAVES` waves and the first design above: by the
    launch shape the card's cluster count gives, never by a failure."""
    stub = lambda nt, smem: 7
    assert K.F32_CLUSTER_WAVES == 2
    assert K.f32_route(batch, 384, 16, stub) == F32_ROUTES[batch]
    waves = ML.free_launch_config(batch, 384, 16, 0, stub)["waves"]
    assert (waves <= 2) == (F32_ROUTES[batch] == "cluster")


@pytest.mark.parametrize("na", [16, 48, 64, 100, 256, 384, 416, 640, 1024])
def test_cluster_shape_by_form(na):
    """bf16 and q8 keep the portable 8 blocks a cluster and units in MMA
    tiles of 16; f32 takes up to 16 blocks (the non-portable size) and
    units in 16-byte words of 4; both cover Na with at most 16 units of
    padding a rank's worth, and a rank of at least 16 units."""
    for form in (0, 1, 2):
        c, u = ML.cluster_shape(na, form)
        assert 1 <= c <= (16 if form == 0 else 8)
        assert u % (4 if form == 0 else 16) == 0 and c * u >= na and u >= 16
        assert c == min(16 if form == 0 else 8, -(-na // 16))
        assert c * (u - (4 if form == 0 else 16)) < na
    assert ML.cluster_shape(384, 0) == (16, 24) and ML.cluster_shape(384, 1) == (8, 48)


def _fma(x, w, acc):
    """float32 x * w + acc, the product exact in float64 (fmaf)."""
    return (x.astype(np.float64) * w.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def _f32_tile_sums(pack_rank, x, na, u, nt_tiles):
    """The kernel's f32 GRU-A product for one rank (csrc f32_tile), in
    float32: warp task (stream tile, group g of 4 local columns); lane l
    runs FMA chains over the k quads l, l + 32, ... into an 8 x 4 tile
    a[4 s + c] (columns past 3U read as zero); then the reduce-scatter: at
    mask m = 16, 8, 4, 2, 1 with n sums left, lane l keeps the half its bit
    m selects and adds its partner's (l ^ m) copy of that half; lane l then
    holds entry l and stores it if within 3U. Returns (the sums [8 NT, 3U],
    how often each was stored)."""
    kq, ncolp, _ = pack_rank.shape
    ncol = 3 * u
    xp = np.zeros((x.shape[0], 4 * kq), np.float32)
    xp[:, :na] = x
    wp = np.zeros((kq, ncolp + 4, 4), np.float32)
    wp[:, :ncol] = pack_rank[:, :ncol]
    out = np.zeros((8 * nt_tiles, ncol), np.float32)
    stores = np.zeros((8 * nt_tiles, ncol), int)
    ngrp = -(-ncol // 4)
    for task in range(ngrp * nt_tiles):
        g, nt = task % ngrp, task // ngrp
        a = np.zeros((32, 32), np.float32)
        for lane in range(32):
            tile = np.zeros((8, 4), np.float32)
            for q in range(lane, kq, 32):
                xs = xp[8 * nt:8 * nt + 8, 4 * q:4 * q + 4]          # [8 s, 4]
                ws = wp[q, 4 * g:4 * g + 4]                          # [4 c, 4]
                for i in range(4):
                    tile = _fma(xs[:, i, None], ws[None, :, i], tile)
            a[lane] = tile.reshape(32)
        n = 32
        for m in (16, 8, 4, 2, 1):
            h = n // 2
            up = (np.arange(32) & m) != 0
            partner = np.arange(32) ^ m
            keep = np.where(up[:, None], a[:, h:n], a[:, :h])
            recv = np.where(up[:, None], a[partner, h:n], a[partner, :h])
            a = (keep.astype(np.float64) + recv.astype(np.float64)).astype(np.float32)
            n = h
        for lane in range(32):
            s, c = lane >> 2, 4 * g + (lane & 3)
            if c < ncol:
                out[8 * nt + s, c] = a[lane, 0]
                stores[8 * nt + s, c] += 1
    return out, stores


@pytest.mark.parametrize("nt", [1, 2, 4, 5])
def test_f32_product_tasks_equal_the_plain_product(nt):
    """GRU-A's f32 product read from the rank pack as the kernel's warp
    tasks read it (8 x 4 register tiles over k quads split by lane, met by
    the reduce-scatter) stores every (stream, local column) sum once and
    equals h . W on the rank's columns within float32 rounding (1e-5 of
    the sums' scale), at every stream tiling of the f32 launch (18 NT
    tasks)."""
    na = 384
    kw = _bundle("f32", na)
    a_rec = kw["a_rec"]
    c, u = ML.cluster_shape(na, 0)
    pack = ML.pack_gru_a(a_rec).numpy()
    rs = np.random.RandomState(nt)
    x = np.tanh(rs.normal(size=(8 * nt, na))).astype(np.float32)
    r = 5
    got, stores = _f32_tile_sums(pack[r], x, na, u, nt)
    assert (stores == 1).all() and -(-3 * u // 4) == 18
    cols = [q * na + r * u + j for q in range(3) for j in range(u)]
    want = x.astype(np.float64) @ a_rec.numpy().astype(np.float64)[:, cols]
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("nt", [1, 2, 4, 5])
@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_free_shared_memory_fits_a_block(form, nt):
    """The free-running layout fits a block in its bf16 and q8 forms and
    every tiling, GRU-A's slice resident; bf16 at S = 40 takes 224,176
    bytes with GRU-B's weights read from L2, and S = 48 would not fit with
    the slice resident (243,120 bytes). The f32 form at the same batch runs
    on clusters of 16 with its slice resident too, at every tiling: one h_a
    operand buffer (S = 40: 211,248 bytes; a second buffer of 62,080 bytes
    would not fit), the ranks' parts of GRU-B's input product
    (16 x ceil(S / 16) x 48 floats) and the rank's 24 rows of its input
    matrix."""
    f = ML.FORMS[form]
    cfg = ML.free_launch_config(8 * nt * 15, 384, 16, f, lambda n, smem: 15)
    assert cfg["nt"] == nt
    assert cfg["smem"] == ML.masked_smem_bytes(f, 384, 16, nt, cfg["res_a"],
                                               cfg["res_b"], free=True)
    assert cfg["smem"] <= ML.SMEM_LIMIT
    assert cfg["res_a"]
    c32 = ML.free_launch_config(8 * nt * 15, 384, 16, 0, lambda n, smem: 15)
    assert c32["nt"] == nt and c32["cluster"] == 16 and c32["res_a"]
    assert c32["smem"] == ML.masked_smem_bytes(0, 384, 16, nt, True, False, free=True)
    assert c32["smem"] <= ML.SMEM_LIMIT
    if nt == 5:
        assert c32["smem"] == 211248 and c32["smem"] + 40 * 388 * 4 > ML.SMEM_LIMIT
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
    """Every form runs the free-running cluster kernel; the bundle's form
    picks its packs and its clusters: at Na = 384, 16 blocks in f32 (its
    f32 rank pack, [C, Na / 4, 3U, 4]), 8 in bf16 and q8 (fragment packs),
    each at the launch shape `free_launch_config` gives that form."""
    f = ML.FORMS[form]
    mk = K.masked_kernel_weights(_bundle(form, 384))
    assert tuple(mk["k2_a"].shape) == ML.packed_shapes(f, 384, 16)[0]
    assert (mk["k2_b"] is None) == (form == "f32")
    cfg = ML.free_launch_config(1024, 384, 16, f, lambda n, smem: 8)
    assert (cfg["cluster"], cfg["units"]) == ML.cluster_shape(384, f)
    assert cfg["cluster"] == (16 if form == "f32" else 8) and cfg["res_a"]


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
    assert cfg["res_a"]
    so = -(-s // c)
    assert so <= 8 and c == (16 if form == "f32" else 8)
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
    conditioning block for the counts; in f32, where K1 has one h_a operand
    buffer and the ranks' parts of GRU-B's input product, K3 keeps two
    buffers (its GRU-B reads step t-1's operand beside step t's product)
    and neither the parts nor the rows of b_in; bf16 keeps GRU-A's slice resident at every S and GRU-B's
    below 32 streams (the card's run at 64 streams read 184,704 bytes a
    block)."""
    f = ML.FORMS[form]
    base = ML.masked_smem_bytes(f, 384, 16, nt, False, False, free=True)
    tf = {n: ML.masked_smem_bytes(f, 384, 16, nt, False, False, tf_blocks=n)
          for n in (1, 3, 20)}
    s = 8 * nt
    up = lambda x: -(-x // 16) * 16
    free_only = up(8 * 32 * 4) + up((4 * s + 8) * 4) + 256 * 4
    if form == "f32":
        free_only += up(16 * -(-s // 16) * 48 * 4) + 24 * 48 * 4 - s * 388 * 4
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
