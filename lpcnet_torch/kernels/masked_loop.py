"""K2's launch configuration and weight packing (`csrc/masked_loop.cu`).

The masked sample loop runs on clusters of C thread blocks, each cluster
owning S streams (8, 16 or 32) for the whole frame; block rank r owns U of
GRU-A's units, [r U, (r+1) U), and their 3U gate columns, ordered
[z | r | h]. U is a multiple of 16, so C U may exceed Na: the units past Na
are padding (zero weights, a state that stays 0). GRU-B's width is padded to
a multiple of 16 the same way. In the bf16 and q8 forms the weights are
packed in the register order of the tensor cores' A fragments (`mma.sync`
m16n8k16 for bf16, m16n8k32 s8 for q8): the product is out^T = W^T h^T, so
the A operand is a 16-column by KS-deep tile of W^T (KS = 16 in bf16, 32 in
q8, the depth zero-padded to a multiple of KS), and lane l's fragment is the
16 bytes at [.., tile, k step, l, :]. The f32 form runs on the CUDA cores
with K1's arithmetic on clusters of up to 16 blocks (the H100's
non-portable cluster size), so that each rank's f32 slice is as small as a
bf16 slice at C = 8 (110.6 KB at Na = 384: U = 24, a multiple of 4, not
16: no MMA tile); its slice is packed [k quad][3U | 1][4], four k values
of a column in one 16-byte word (`pack_gru_a`). In K1 the f32 form keeps
one h_a operand buffer and the ranks' parts of GRU-B's input product for
its tail streams (`masked_smem_bytes`).

* `cluster_shape(na, form)`, `masked_smem_bytes`, `masked_launch_config`: the
  launch's shape; `free_launch_config` that of the free-running form
  (K1), `tf_launch_config` that of the teacher-forced form (K3), whose
  rank r runs GRU-B for streams [r SO, r SO + SO) as K1's does and keeps
  the counts of its S streams in shared memory; `tf_step_budget` mirrors
  that form's schedule of steps. A block keeps its GRU-A slice and GRU-B's
  packed weights
  in shared memory where they fit and reads them from L2 where they do not
  (the widest GRUs); `masked_launch_config` picks the smallest S that fits
  the card in one wave of clusters.
* `fragment_index(ks)`: which element of a tile each lane's fragment holds.
* `pack_gru_a`, `pack_gru_b`: the packed operands, built once per weight
  bundle by `sample_loop.masked_kernel_weights`; `pack_embf` the factored
  q8 embedding's input kernel, each rank's 3U columns as `pack_gru_a`'s.

The factored q8 embedding (`fact`) adds to a block its rank's [384, 3U]
slice of GRU-A's input kernel (resident where it fits, `res_f`) and the
gathered rows g [S, 384] of its streams as the product's operand, which the
kernel fuses with the gate phase at S >= 32; at S <= 16 the product's int32
sums [S, 3U]. The tiers of `_layout` then drop GRU-B's weights first, the
input kernel's slice next, GRU-A's slice last.
"""

from __future__ import annotations

import torch

MAX_CLUSTER = 8              # blocks a cluster in bf16 and q8 (the portable limit)
MAX_CLUSTER_F32 = 16         # in f32: the H100's non-portable cluster size
SMEM_LIMIT = 232448          # shared memory a block can have on an H100
FORMS = {"f32": 0, "bf16": 1, "q8": 2}
STREAM_TILES = (1, 2, 4)     # S / 8: warp 0 holds a cluster's streams in its lanes
_KS = {0: 16, 1: 16, 2: 32}          # k depth of one MMA
_ESZ = {0: 4, 1: 2, 2: 1}            # operand bytes
_XPAD = {0: 4, 1: 8, 2: 16}          # row padding of the operands
FACT_K = 384                         # the factored embedding's depth: 3 x 128


def check_widths(na: int, nb: int) -> None:
    if na <= 0 or nb <= 0:
        raise ValueError(f"masked sample loop kernel: Na={na}, Nb={nb}")


def check_fact(form: int, fact: bool) -> None:
    if fact and form != FORMS["q8"]:
        raise ValueError("the factored embedding is a q8 operand form")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def cluster_shape(na: int, form: int) -> tuple[int, int]:
    """(C, U) of operand form `form`. bf16 and q8: 8 blocks of U = 16
    ceil(Na / 128) units each (U = 48 at Na = 384), or at Na < 128 one
    block per 16 units. f32: 16 blocks of U = 4 ceil(Na / 64) units (U = 24
    at Na = 384, U = 40 at Na = 640), or at Na < 256 one block per 16
    units."""
    if form == FORMS["f32"]:
        c = min(MAX_CLUSTER_F32, -(-na // 16))
        return c, _up(-(-na // c), 4)
    c = min(MAX_CLUSTER, -(-na // 16))
    return c, _up(-(-na // c), 16)


def padded_nb(nb: int) -> int:
    return _up(nb, 16)


def masked_smem_bytes(form: int, na: int, nb: int, nt: int,
                      res_a: bool = True, res_b: bool = True,
                      free: bool = False, tf_blocks: int = 0,
                      fact: bool = False, res_f: bool = False) -> int:
    """Shared memory of one block, bytes: the csrc K2Layout's total. `res_a`
    keeps GRU-A's slice in shared memory, `res_b` GRU-B's weights (bf16 and
    q8 only). `free` is K1's free-running form, whose tail arrays hold one
    tile of 8 streams (each rank runs the tail of S / C streams), whose
    codes take four words a stream and whose h_a operand buffers have 8 rows
    more in bf16 and q8 (the last rank's GRU-B tile reads past S; f32's
    GRU-B reads its own rows only); in f32 it has one operand buffer, the
    ranks' parts of GRU-B's input product, [C][SO][3Nb rounded up to 4],
    and the rank's U rows of GRU-B's input matrix. `tf_blocks` > 0 is K3's
    teacher-forced form over that many conditioning blocks: the tail and
    the operand rows as the free-running form's (two buffers in every
    form), no node logits, codes or threshold table, and the counts of the
    S streams for each block with each block's largest.
    `fact` adds the factored q8 embedding's regions, `res_f` its input
    kernel's slice in shared memory: the slice, the rows g [S, 400] and, at
    S <= 16, where the gate phase reads g's product from shared memory, its
    sums [S, 3U + 4] int32."""
    s = 8 * nt
    tf = tf_blocks > 0
    k1_f32 = free and not tf and form == FORMS["f32"]
    free = free or tf
    tr = 8 if free else s
    ks, esz, pad = _KS[form], _ESZ[form], _XPAD[form]
    mma = form != 0
    c, u = cluster_shape(na, form)
    nbp = padded_nb(nb)
    ksa, ksbr = -(-na // ks), -(-nb // ks)
    ldx = _up(c * u, 128 // esz) + pad
    ldb = ksbr * ks + pad if mma else nb + pad
    ldz, ldg = 3 * u + 4, 3 * nbp + 4
    slice_a = 3 * u * ksa * ks * esz if mma else -(-na // 4) * (3 * u | 1) * 16
    regions = [
        slice_a if res_a else 0,                         # GRU-A slice
        3 * nbp * (ksa + ksbr) * ks * esz if mma and res_b else 0,  # GRU-B weights
        (1 if k1_f32 else 2) * (s + 8 if free and mma else s) * ldx * esz,  # h_a operand
        tr * ldb * esz,                                  # h_b operand
        s * ldz * 4,                                     # GRU-A products
        2 * tr * ldg * 4,                                # GRU-B products
        s * u * 4,                                       # the rank's h_a
        tr * nb * 4,                                     # h_b
        0 if tf else tr * 32 * 4,                        # visited node logits
        (tf_blocks * (s + 1) if tf else
         (4 if free else 3) * s + tr) * 4,               # codes, tree's top bits
        0 if tf else 256 * 4,                            # threshold logits
        c * -(-s // c) * _up(3 * nb, 4) * 4 if k1_f32 else 0,  # GRU-B's input parts
        u * _up(3 * nb, 4) * 4 if k1_f32 else 0,         # the rank's rows of b_in
        16,                                              # flags
    ]
    if fact:
        regions += [
            3 * u * FACT_K if res_f else 0,              # input kernel's slice
            s * (FACT_K + 16),                           # gathered rows g
            s * ldz * 4 if s <= 16 else 0,               # g's products (S <= 16)
        ]
    return sum(_up(r, 16) for r in regions)


def _layout(form: int, na: int, nb: int, nt: int, free: bool = False,
            tf_blocks: int = 0, fact: bool = False):
    """(smem, res_a, res_b, res_f) of the first of: every weight set
    resident, GRU-A's slice (and the factored input kernel's) only, ...,
    none, that fits a block; None if none does. res_f is False unless
    `fact` (the factored q8 embedding); res_b is False in f32, whose GRU-B
    reads its weights from L2."""
    tiers = (((True, True, True), (True, False, True), (True, False, False),
              (False, False, False)) if fact else
             ((True, True, False), (True, False, False), (False, False, False)))
    for res_a, res_b, res_f in tiers:
        smem = masked_smem_bytes(form, na, nb, nt, res_a, res_b, free, tf_blocks,
                                 fact, res_f)
        if smem <= SMEM_LIMIT:
            return smem, res_a, res_b and form != 0, res_f
    return None


def _tilings(form: int, na: int, nb: int, tiles, **kind):
    """[(nt, layout)] of the stream tilings `tiles` whose layout fits a
    block. In f32, where any of them keeps GRU-A's slice in shared memory,
    only those that do: an f32 product that reads its slice from L2 is the
    first design's bottleneck, so the width, not the wave count, decides
    where the slice lives (bf16 and q8 trade residency for waves)."""
    fits = [(nt, lay) for nt in tiles
            if (lay := _layout(form, na, nb, nt, **kind)) is not None]
    if form == FORMS["f32"] and any(lay[1] for _, lay in fits):
        fits = [(nt, lay) for nt, lay in fits if lay[1]]
    return fits


def masked_launch_config(batch: int, na: int, nb: int, form: int, max_clusters,
                         fact: bool = False):
    """The launch for `batch` streams: {"cluster": C, "units": U, "nt": S / 8,
    "streams": S, "clusters": ceil(batch / S), "smem": bytes a block,
    "res_a", "res_b", "res_f": weights resident in shared memory (res_f:
    the factored q8 embedding's input kernel, `fact`), "waves"}.

    `max_clusters(nt, smem)` is the number of clusters the card holds at
    once in that shape (the card's answer on CUDA; 15 clusters of 8 blocks
    with over 116 KB each on an H100). S is the smallest of 8, 16 and 32
    whose ceil(batch / S) clusters fit in one wave; where none does, S = 32
    and the launch runs in waves (3 at 1024 streams on an H100)."""
    check_widths(na, nb)
    check_fact(form, fact)
    if batch <= 0:
        raise ValueError(f"masked sample loop kernel: batch {batch}")
    cluster, units = cluster_shape(na, form)
    fits = _tilings(form, na, nb, STREAM_TILES, fact=fact)
    if not fits:
        raise ValueError(f"masked sample loop kernel: Na={na}, Nb={nb} needs "
                         f"{masked_smem_bytes(form, na, nb, 1, False, False)} "
                         f"bytes of shared memory a block")
    for nt, lay in fits:
        s = 8 * nt
        held = max_clusters(nt, lay[0])
        if -(-batch // s) <= held or nt == fits[-1][0]:
            break
    smem, res_a, res_b, res_f = lay
    clusters = -(-batch // s)
    return {"cluster": cluster, "units": units, "nt": nt, "streams": s,
            "clusters": clusters, "smem": smem, "res_a": res_a, "res_b": res_b,
            "res_f": res_f, "waves": -(-clusters // held)}


FREE_STREAM_TILES = (1, 2, 4, 5)     # S / 8 of the free-running form (K1)


def free_launch_config(batch: int, na: int, nb: int, form: int, max_clusters,
                       fact: bool = False):
    """K1's launch, the free-running form of K2's kernel, for `batch`
    streams: the keys of `masked_launch_config`. Rank r of a cluster runs
    the tail (GRU-B to PCM) of streams [r SO, r SO + SO), SO = ceil(S / C)
    <= 8, so S is not capped at 32 by warp 0's lanes: S = 40 fits a block
    too. `max_clusters(nt, smem)` as in `masked_launch_config`. S is the
    smallest of 8, 16, 32 and 40 whose clusters fit one wave; where none
    does, the one with the fewest waves (the smaller on a tie): at 1024
    streams on an H100 (15 clusters of 8 blocks) bf16 takes S = 40, 26
    clusters in two waves. f32 runs on clusters of 16 (`cluster_shape`)
    and, at Na = 384, on the tilings that keep its slice resident
    (`_tilings`: all four; at 8 streams ranks 8-15 own no tail; 1024
    streams on an H100, 7 such clusters, take S = 40 in four waves).
    `fact`: the factored q8 embedding's layout."""
    check_widths(na, nb)
    check_fact(form, fact)
    if batch <= 0:
        raise ValueError(f"sample loop kernel: batch {batch}")
    cluster, units = cluster_shape(na, form)
    tiles = [nt for nt in FREE_STREAM_TILES if -(-8 * nt // cluster) <= 8]
    best = None
    for nt, lay in _tilings(form, na, nb, tiles, free=True, fact=fact):
        s = 8 * nt
        held = max_clusters(nt, lay[0])
        clusters = -(-batch // s)
        waves = -(-clusters // held)
        if best is None or waves < best[0]:
            best = (waves, nt, lay, clusters)
        if waves == 1:
            break
    if best is None:
        raise ValueError(f"sample loop kernel: Na={na}, Nb={nb} needs "
                         f"{masked_smem_bytes(form, na, nb, 1, False, False, True)} "
                         f"bytes of shared memory a block")
    waves, nt, (smem, res_a, res_b, res_f), clusters = best
    return {"cluster": cluster, "units": units, "nt": nt, "streams": 8 * nt,
            "clusters": clusters, "smem": smem, "res_a": res_a, "res_b": res_b,
            "res_f": res_f, "waves": waves}


def tf_launch_config(batch: int, na: int, nb: int, form: int, n_blocks: int,
                     max_clusters, fact: bool = False):
    """K3's launch, the teacher-forced form of K2's kernel, for `batch`
    streams over `n_blocks` conditioning blocks: the keys of
    `masked_launch_config`. Rank r of a cluster runs GRU-B for streams
    [r SO, r SO + SO), SO = ceil(S / C) <= 8, as the free-running form
    does. `max_clusters(nt, smem)` as in `masked_launch_config`. S is the
    smallest of 8, 16 and 32 (in f32 those that keep the slice resident,
    `_tilings`) whose clusters fit one wave; where none does, the largest
    in waves. On an H100 (15 clusters of 8 blocks): 64 streams (the PLC
    path's compacted drain) take 8 clusters of 8, 256 take 8 of 32.
    `fact`: the factored q8 embedding's layout."""
    check_widths(na, nb)
    check_fact(form, fact)
    if batch <= 0 or n_blocks <= 0:
        raise ValueError(f"teacher-force kernel: batch {batch}, {n_blocks} blocks")
    cluster, units = cluster_shape(na, form)
    fits = _tilings(form, na, nb, [nt for nt in STREAM_TILES if -(-8 * nt // cluster) <= 8],
                    tf_blocks=n_blocks, fact=fact)
    if not fits:
        raise ValueError(f"teacher-force kernel: Na={na}, Nb={nb}, {n_blocks} "
                         f"blocks need more shared memory than a block has")
    for nt, lay in fits:
        held = max_clusters(nt, lay[0])
        if -(-batch // (8 * nt)) <= held or nt == fits[-1][0]:
            break
    smem, res_a, res_b, res_f = lay
    clusters = -(-batch // (8 * nt))
    return {"cluster": cluster, "units": units, "nt": nt, "streams": 8 * nt,
            "clusters": clusters, "smem": smem, "res_a": res_a, "res_b": res_b,
            "res_f": res_f, "waves": -(-clusters // held)}


def tf_step_budget(counts, streams: int, blk: int):
    """The teacher-forced form's schedule, as the kernel reads it: counts
    [B, n_blocks] -> (the steps each cluster of `streams` streams runs in
    each block, [clusters, n_blocks], the largest of its own streams'
    counts clamped to 0..blk; the (block, step) pairs every rank of
    cluster c walks, in order, skipping blocks with no step)."""
    counts = torch.as_tensor(counts).clamp(0, blk)
    b, nblk = counts.shape
    clusters = -(-b // streams)
    pad = counts.new_zeros(clusters * streams - b, nblk)
    cmax = torch.cat([counts, pad]).reshape(clusters, streams, nblk).amax(dim=1)

    def walk(cm):                   # the kernel's first step and step_after
        k, t, steps = 0, 0, []
        while k < nblk and cm[k] == 0:
            k += 1
        while k < nblk:
            steps.append((k, t))
            t += 1
            if t >= cm[k]:
                t, k = 0, k + 1
                while k < nblk and cm[k] == 0:
                    k += 1
        return steps

    return cmax, [walk(cmax[c].tolist()) for c in range(clusters)]


def fragment_index(ks: int, device="cpu"):
    """(m, k) [32, E] int64: lane l's fragment of a 16 x ks tile A (rows m,
    depth k) holds A[m[l, e], k[l, e]] at element e, in the order of the
    PTX ISA's A fragment (four 32-bit registers, low half first).

    ks 16, bf16 (E = 8): register i holds rows g + 8 (i & 1), depth
    2t + 8 (i >> 1) + {0, 1}; ks 32, s8 (E = 16): register i holds row
    g + 8 (i & 1), depth 4t + 16 (i >> 1) + {0..3}; g = l // 4, t = l % 4."""
    lane = torch.arange(32, device=device)
    g, t = (lane // 4)[:, None], (lane % 4)[:, None]
    if ks == 16:
        e = torch.arange(8, device=device)[None, :]
        reg, part = e // 2, e % 2
        return g + 8 * (reg & 1), 2 * t + 8 * (reg >> 1) + part
    e = torch.arange(16, device=device)[None, :]
    reg, part = e // 4, e % 4
    return g + 8 * (reg & 1), 4 * t + 16 * (reg >> 1) + part


def pack_tiles(at: torch.Tensor, ks: int) -> torch.Tensor:
    """A operand at [..., M, K] (M a multiple of 16; K padded with zeros to
    a multiple of ks) -> [..., M / 16, K / ks, 32, E] in fragment order."""
    *lead, m, k = at.shape
    kp = _up(k, ks)
    if kp != k:
        at = torch.cat([at, at.new_zeros(*lead, m, kp - k)], dim=-1)
    tiles = at.reshape(*lead, m // 16, 16, kp // ks, ks).transpose(-3, -2)
    # the index is made on the operand's device: a host copy would make
    # every pack (each training step packs K5's weights) wait for the card
    mi, ki = fragment_index(ks, at.device)
    return tiles[..., mi, ki].contiguous()


def packed_shapes(form: int, na: int, nb: int):
    """The shapes of `pack_gru_a` and `pack_gru_b` in form 1 (bf16) or 2
    (q8); in form 0 (f32) `pack_gru_a`'s [C, ceil(Na / 4), 3U | 1, 4] and no
    GRU-B pack (None)."""
    c, u = cluster_shape(na, form)
    if form == FORMS["f32"]:
        return (c, -(-na // 4), 3 * u | 1, 4), None
    ks, e = _KS[form], 16 // _ESZ[form]
    ksa, ksbr = -(-na // ks), -(-nb // ks)
    return ((c, 3 * u // 16, ksa, 32, e),
            (3 * padded_nb(nb) // 16, ksa + ksbr, 32, e))


def _pad_units(w: torch.Tensor, n: int, npad: int) -> torch.Tensor:
    """[K, 3n] gate columns [z | r | h] -> [K, 3 npad], zero columns for the
    padding units of each gate."""
    k = w.shape[0]
    out = w.new_zeros(k, 3, npad)
    out[:, :, :n] = w.reshape(k, 3, n)
    return out.reshape(k, 3 * npad)


def rank_columns(na: int, form: int, device="cpu") -> torch.Tensor:
    """[C, 3U]: the column of GRU-A's unit-padded matrix [Na, 3 C U] that
    rank r's local column q U + j holds (gate q, unit r U + j), for the
    cluster shape of `form`."""
    c, u = cluster_shape(na, form)
    lc = torch.arange(3 * u, device=device)[None, :]
    r = torch.arange(c, device=device)[:, None]
    return (lc // u) * (c * u) + r * u + lc % u


def pack_gru_a(a_rec: torch.Tensor) -> torch.Tensor:
    """GRU-A's recurrent matrix [Na, 3Na] -> each rank's slice, contiguous.
    bf16, or q8's int8 off-diagonal part: [C, 3U / 16, ceil(Na / KS), 32,
    E] in fragment order. f32: [C, ceil(Na / 4), 3U | 1, 4], element (r, q,
    lc, i) = a_rec[4 q + i, column of local column lc] (zero past Na, for
    the padding units and in the last word of a quad where 3U is even): a
    warp's lanes read one column's 16-byte words of 32 consecutive k quads,
    an odd number of words apart, so without bank conflicts."""
    na = a_rec.shape[0]
    form = (FORMS["f32"] if a_rec.dtype == torch.float32 else
            FORMS["q8"] if a_rec.dtype == torch.int8 else FORMS["bf16"])
    c, u = cluster_shape(na, form)
    cols = rank_columns(na, form, a_rec.device)
    w = _pad_units(a_rec, na, c * u)
    if form == FORMS["f32"]:
        kp, ncolp = _up(na, 4), 3 * u | 1
        w = torch.cat([w, w.new_zeros(kp - na, w.shape[1])])[:, cols]  # [Kp, C, 3U]
        w = torch.cat([w, w.new_zeros(kp, c, ncolp - 3 * u)], dim=2)
        return w.reshape(kp // 4, 4, c, ncolp).permute(2, 0, 3, 1).contiguous()
    return pack_tiles(w.t()[cols], _KS[form])


def pack_embf(w: torch.Tensor) -> torch.Tensor:
    """The factored embedding's input kernel [384, 3Na] int8 ->
    [C, 3U / 16, 384 / 32, 32, 16], rank r's 3U columns (`rank_columns`)
    contiguous, as `pack_gru_a` packs GRU-A's recurrent matrix."""
    na = w.shape[1] // 3
    c, u = cluster_shape(na, FORMS["q8"])
    cols = rank_columns(na, FORMS["q8"], w.device)
    return pack_tiles(_pad_units(w, na, c * u).t()[cols], 32)


def pack_gru_b(b_in: torch.Tensor, b_rec: torch.Tensor) -> torch.Tensor:
    """GRU-B's input [Na, 3Nb] and recurrent [Nb, 3Nb] matrices, their
    units padded to Nbp = 16 ceil(Nb / 16) ->
    [3Nbp / 16, ceil(Na / KS) + ceil(Nb / KS), 32, E]: per column tile, the
    input part's k steps, then the recurrent part's."""
    nb = b_rec.shape[0]
    nbp = padded_nb(nb)
    ks = 32 if b_in.dtype == torch.int8 else 16
    return torch.cat([pack_tiles(_pad_units(b_in, nb, nbp).t(), ks),
                      pack_tiles(_pad_units(b_rec, nb, nbp).t(), ks)],
                     dim=1).contiguous()
