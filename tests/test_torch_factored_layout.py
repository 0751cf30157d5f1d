"""The factored q8 embedding's design in the cluster kernel
(`lpcnet_torch/kernels/csrc/masked_loop.cu`), on the CPU: the shared-memory
layout of the Python side (`masked_loop.masked_smem_bytes`) against the CUDA
source's own `k2_layout`, compiled here with g++; the warp tasks of g's
product with the input kernel (fused with the gate phase by `fact_gate` at
S >= 32, into an array by `fact_array` below) emulated from
the packed operands as the tensor cores read them; and a walk of K3's steps
with the buffers its factored form reads and writes. The kernels themselves
are held against their plain versions in test_torch_cuda.py and
chip_smoke.py."""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

from lpcnet_torch.kernels import _build
from lpcnet_torch.kernels import masked_loop as ML

torch.set_num_threads(1)

KINDS = {"masked": 0, "free": 1, "tf": 2}


@pytest.fixture(scope="module")
def k2_layout(tmp_path_factory):
    """The CUDA source's k2_layout (and the helpers it uses), compiled as
    host C++: layout(form, na, nb, cluster, s, res_a, res_b, kind,
    n_blocks, fact, res_f, out) fills out with the total and the sizes of
    the regions gop (g's rows) and eacc (the product's sums)."""
    src = (_build.CSRC / "masked_loop.cu").read_text()
    start = src.index("constexpr int FACT_E")
    end = src.index("  return L;\n}\n", start) + len("  return L;\n}\n")
    body = src[start:end]
    assert re.search(r"K2Layout k2_layout\(", body)
    defines = "".join(line + "\n" for line in src.splitlines()
                      if line.startswith(("#define K2_THREADS", "#define K2_WARPS")))
    d = tmp_path_factory.mktemp("k2_layout")
    (d / "layout.cc").write_text(
        "#include <cstddef>\n#include <cstdint>\n#define __host__\n#define __device__\n"
        "enum { FORM_F32 = 0, FORM_BF16 = 1, FORM_Q8 = 2 };\n"
        "enum { KIND_MASKED = 0, KIND_FREE = 1, KIND_TF = 2 };\n" + defines + body +
        "\nextern \"C\" void layout(int form, int na, int nb, int cluster, int s, int res_a,"
        " int res_b, int kind, int n_blocks, int fact, int res_f, long long* out) {\n"
        "  const K2Layout L = k2_layout(form, na, nb, cluster, s, res_a, res_b, kind,"
        " n_blocks, fact, res_f);\n"
        "  out[0] = (long long)L.total; out[1] = (long long)(L.eacc - L.gop);\n"
        "  out[2] = (long long)(L.gbin - L.eacc);\n}\n")
    so = d / "liblayout.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(d / "layout.cc")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.layout.argtypes = [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_longlong)]

    def call(form, na, nb, cluster, s, res_a, res_b, kind, n_blocks, fact, res_f):
        out = (ctypes.c_longlong * 3)()
        lib.layout(form, na, nb, cluster, s, int(res_a), int(res_b), kind, n_blocks,
                   int(fact), int(res_f), out)
        return tuple(out)
    return call


@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("kind", ["masked", "free", "tf"])
def test_layout_equals_the_cuda_sources(k2_layout, kind, form):
    """masked_smem_bytes equals the source's k2_layout total at every stream
    tiling, residency and width, with and without the factored embedding
    (q8); g's rows take S x 400 bytes in every kind, and the product's
    sums S x (3U + 4) int32 at S <= 16 (below, the gate phase holds them in
    registers)."""
    f = ML.FORMS[form]
    tiles = ML.FREE_STREAM_TILES if kind == "free" else ML.STREAM_TILES
    n_blocks = 3 if kind == "tf" else 0
    facts = (False, True) if form == "q8" else (False,)
    for na, nb in ((384, 16), (64, 16), (640, 16), (100, 10)):
        c, u = ML.cluster_shape(na, f)
        for nt in tiles:
            s = 8 * nt
            for res_a in (False, True):
                for res_b in ((False,) if form == "f32" else (False, True)):
                    for fact in facts:
                        for res_f in ((False, True) if fact else (False,)):
                            py = ML.masked_smem_bytes(f, na, nb, nt, res_a, res_b,
                                                      free=kind == "free",
                                                      tf_blocks=n_blocks, fact=fact,
                                                      res_f=res_f)
                            total, gop, sums = k2_layout(f, na, nb, c, s, res_a, res_b,
                                                         KINDS[kind], n_blocks, fact, res_f)
                            assert py == total, (na, nt, res_a, res_b, fact, res_f)
                            assert gop == (s * 400 if fact else 0)
                            want = s * (3 * u + 4) * 4 if fact and s <= 16 else 0
                            assert sums == -(-want // 16) * 16


def test_k1_factored_layout_keeps_gru_b_resident(k2_layout):
    """K1 at 1024 streams on an H100 (15 clusters of 8 at once): S = 40 in
    two waves, every weight set resident (GRU-A's and GRU-B's packs and the
    input kernel's slice), 223,280 bytes a block, with no array of g's
    products; K3 at 256 streams and K2 at 64 keep every weight set
    resident too, K2 with the array of its products (8 x 148 int32)."""
    cfg = ML.free_launch_config(1024, 384, 16, 2, lambda nt, smem: 15, fact=True)
    assert (cfg["streams"], cfg["waves"], cfg["smem"]) == (40, 2, 223280)
    assert cfg["res_a"] and cfg["res_b"] and cfg["res_f"]
    total, gop, sums = k2_layout(2, 384, 16, 8, 40, True, True, 1, 0, True, True)
    assert total == 223280 and gop == 16000 and sums == 0
    tf = ML.tf_launch_config(256, 384, 16, 2, 1, lambda nt, smem: 15, fact=True)
    assert tf["streams"] == 32 and tf["res_b"] and tf["res_f"]
    total, gop, sums = k2_layout(2, 384, 16, 8, 32, True, True, 2, 1, True, True)
    assert total == tf["smem"] and sums == 0
    k2 = ML.masked_launch_config(64, 384, 16, 2, lambda nt, smem: 15, fact=True)
    assert k2["streams"] == 8 and k2["res_a"] and k2["res_b"] and k2["res_f"]
    total, gop, sums = k2_layout(2, 384, 16, 8, 8, True, True, 0, 0, True, True)
    assert total == k2["smem"] and sums == 8 * 148 * 4


# --------------------------------------------------------------------------
# g's product: the warp tasks, emulated from the packed fragments
# --------------------------------------------------------------------------

KSF = ML.FACT_K // 32                            # k steps of the product


def _fact_tasks(units, nt):
    """The product's warp tasks as csrc/masked_loop.cu takes them: [(column
    tiles, first stream tile, stream tiles)]. Fused with the gate phase (S
    >= 32, fact_gate: task i on warp i mod 12), a unit tile ut's three
    gates (column tiles q U/16 + ut) over one stream tile, two at S = 40;
    into the array (S <= 16, fact_array), one column tile of one stream
    tile, as GRU-A's product."""
    ntu = units // 16
    if nt <= 2:
        return [((mt,), n, 1) for n in range(nt) for mt in range(3 * ntu)]
    tpw = 2 if nt > 4 else 1
    out = []
    for i in range(ntu * -(-nt // tpw)):
        ut, nt0 = i % ntu, (i // ntu) * tpw
        out.append(((ut, ntu + ut, 2 * ntu + ut), nt0, min(tpw, nt - nt0)))
    return out


def _fragment_tile(frags):
    """A 16 x 32 s8 tile from its 32 lanes' fragments [32, 16] (the PTX
    ISA's m16n8k32 A layout, `fragment_index`)."""
    mi, ki = ML.fragment_index(32)
    a = np.zeros((16, 32), np.int64)
    a[mi.numpy(), ki.numpy()] = frags
    return a


def _d_fragment(pack_rank, rows, mt):
    """One warp's D fragment [lane, c] of column tile mt over the KSF k
    steps in order: the A fragments as packed, the B fragments lane (gi, t)
    reads from g's rows (words 4t and 16 + 4t of each 32-deep step of row
    gi); c0..c3 = D[gi][2t], D[gi][2t + 1], D[gi + 8][2t], D[gi + 8][2t + 1]
    of D[m][n] = sum_k A[m][k] B[n][k]."""
    d = np.zeros((16, 8), np.int64)
    for ks in range(KSF):
        a = _fragment_tile(pack_rank[mt, ks])
        b = np.zeros((8, 32), np.int64)
        for lane in range(32):
            gi, t = lane >> 2, lane & 3
            for o in (4 * t, 16 + 4 * t):
                b[gi, o:o + 4] = rows[gi, ks * 32 + o:ks * 32 + o + 4]
        d += a @ b.T
    frag = np.zeros((32, 4), np.int64)
    for lane in range(32):
        gi, t = lane >> 2, lane & 3
        frag[lane] = (d[gi, 2 * t], d[gi, 2 * t + 1], d[gi + 8, 2 * t], d[gi + 8, 2 * t + 1])
    return frag


def _emulated_products(pack_rank, g_rows, units, nt):
    """The sums the tasks produce: for each task, stream tile and column
    tile mt, the D fragment, lane (gi, t)'s c0..c3 going to (stream 8 nt +
    2t + (c & 1), local column 16 mt + gi + 8 (c >> 1)), as fact_gate
    updates them (mt = q U/16 + ut: gate q, unit 16 ut + gi + 8 (c >> 1))
    and tile_mma stores them into eacc. Returns (the sums [S, 3U] int64,
    how often each was produced)."""
    out = np.zeros((8 * nt, 3 * units), np.int64)
    hits = np.zeros((8 * nt, 3 * units), int)
    for mts, nt0, ntt in _fact_tasks(units, nt):
        for i in range(ntt):
            rows = g_rows[8 * (nt0 + i):8 * (nt0 + i) + 8].astype(np.int64)
            for mt in mts:
                frag = _d_fragment(pack_rank, rows, mt)
                for lane in range(32):
                    gi, t = lane >> 2, lane & 3
                    for c in range(4):
                        s = 8 * (nt0 + i) + 2 * t + (c & 1)
                        col = 16 * mt + gi + 8 * (c >> 1)
                        out[s, col] += frag[lane, c]
                        hits[s, col] += 1
    return out, hits


@pytest.mark.parametrize("na,nt", [(384, 1), (384, 2), (384, 4), (384, 5), (64, 1), (64, 2),
                                   (100, 1), (640, 4)])
def test_fact_product_tasks_equal_the_plain_product(na, nt):
    """Every (stream, unit, gate) of a rank is produced by exactly one warp
    task's lane, and equals g . W_in on the rank's columns exactly (int32
    sums of int8 products), at every stream tiling and at other widths; at
    Na = 384 the fused tasks fill the block's 12 warps in one round (12 at
    S = 32, 9 of two stream tiles at S = 40), the array's one-gate tasks
    are 9 at S = 8 (one round of K3's nine warps) and 18 at S = 16."""
    rs = np.random.RandomState(na + nt)
    w = torch.from_numpy(rs.randint(-127, 128, (ML.FACT_K, 3 * na)).astype(np.int8))
    pack = ML.pack_embf(w).numpy()
    c, u = ML.cluster_shape(na, ML.FORMS["q8"])
    g_rows = rs.randint(-128, 128, (8 * nt, ML.FACT_K)).astype(np.int8)
    wp = ML._pad_units(w, na, c * u).numpy().astype(np.int64)
    cols = ML.rank_columns(na, ML.FORMS["q8"]).numpy()
    tasks = _fact_tasks(u, nt)
    assert all(1 <= ntt <= 2 for _, _, ntt in tasks)
    if na == 384:
        assert len(tasks) == {1: 9, 2: 18, 4: 12, 5: 9}[nt]
    for r in (0, c - 1):
        got, hits = _emulated_products(pack[r], g_rows, u, nt)
        assert (hits == 1).all()
        want = g_rows.astype(np.int64) @ wp[:, cols[r]]
        assert np.array_equal(got, want), r
        assert np.abs(want).max() < 2 ** 31


# --------------------------------------------------------------------------
# K3: the walk of its steps with the factored form's buffers
# --------------------------------------------------------------------------

def _walk_k3_factored(steps, fused, barrier_b=True):
    """K3's factored loop on one cluster's steps (`tf_step_budget`'s walk),
    as csrc/masked_loop.cu runs it, with the step whose rows g and whose
    product's sums eacc hold: the prologue gathers step 0's rows (all
    threads; unfused, a block barrier, then their product into eacc)
    before a cluster barrier; iteration j then has the product phase
    (neither touched), block barrier A, the gate phase (fused: fact_gate
    reads g; else the per-pair threads read eacc), block barrier B, and the
    cluster barrier's window (the nine product warps write step j+1's rows
    into g; unfused, then a barrier of the nine and their product from g
    into eacc), whose wait orders nothing of the window. Returns (the
    accesses [(block epoch, the nine's epoch, who, op, buffer, step)], the
    steps each gate phase read)."""
    at = lambda i: steps[i] if i < len(steps) else None   # past the last: zero rows
    ev, gates = [], []
    eb = en = 0
    ev.append((eb, en, "all", "w", "g", at(0)))
    if not fused:
        eb += 1; en += 1                             # __syncthreads
        ev.append((eb, en, "all", "r", "g", at(0)))
        ev.append((eb, en, "all", "w", "eacc", at(0)))
    eb += 1; en += 1                                 # cluster.sync
    g = e = at(0)
    for j in range(len(steps)):
        eb += 1; en += 1                             # block barrier A
        ev.append((eb, en, "all", "r", "g" if fused else "eacc", g if fused else e))
        gates.append(g if fused else e)
        if barrier_b:
            eb += 1; en += 1                         # block barrier B
        g = at(j + 1)
        ev.append((eb, en, "nine", "w", "g", g))
        if not fused:
            en += 1                                  # bar.sync 2, 288
            ev.append((eb, en, "nine", "r", "g", g))
            e = g
            ev.append((eb, en, "nine", "w", "eacc", e))
    return ev, gates


def _races(ev):
    """Pairs of accesses to one buffer, one a write, that no barrier
    orders: the same block epoch, and not both the nine's in different
    epochs of their own barrier."""
    out = []
    for i, a in enumerate(ev):
        for b in ev[i + 1:]:
            if a[4] != b[4] or "w" not in (a[3], b[3]) or a[0] != b[0]:
                continue
            if a[2] == b[2] == "nine" and a[1] != b[1]:
                continue
            out.append((a, b))
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["S32", "S8"])
@pytest.mark.parametrize("rows", [
    [[160, 160, 80], [160, 80, 0], [80, 0, 0], [80, 0, 0], [0, 0, 0]],   # the causal drain
    [[160], [160], [80], [0]],                                            # one block of 160
    [[3, 0, 1, 0], [0, 0, 2, 1], [1, 0, 0, 0]],                           # empty blocks between
    [[1], [0]],                                                           # a single step
])
def test_k3_factored_walk_reads_each_step_in_order(rows, fused):
    """Over K3's schedule (blocks with no step skipped, as step_after does)
    the gate phase of step j reads the rows of step j (fused, S >= 32) or
    the products of step j's rows (S <= 16), made in the window of step j-1
    (the prologue for step 0); no product reads a buffer that its own
    barrier epoch writes, so one g and one eacc suffice; without block
    barrier B the window's writes of step j+1 meet step j's gate phase."""
    counts = torch.tensor(rows, dtype=torch.int32)
    _, walks = ML.tf_step_budget(counts, counts.shape[0], 160)
    steps = walks[0]
    ev, gates = _walk_k3_factored(steps, fused)
    assert gates == steps
    assert _races(ev) == []
    bad, _ = _walk_k3_factored(steps, fused, barrier_b=False)
    assert _races(bad)
