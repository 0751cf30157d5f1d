"""The PLC-net chain: K masked steps of the PLC feature-prediction network
(`models.plc.compute_plc_pred`) as one CUDA kernel launch
(`csrc/plc_chain.cu`, K4). Port of `lpcnet_tpu/kernels/plc_chain.py`.

The batched PLC frame step makes up to five dependent PLC-net calls: the
prediction that restores a blending stream, one `get_fec_or_pred` per drain
iteration and the lost frame's prediction (src/lpcnet_plc.c:135-166). Their
inputs can all be computed before any of them runs, and blending and lost
streams are disjoint, so the chain is one launch with a mask per stream and
step, and the states after every step and every step's output come back for
the frame-rate program to replay.

* `plc_chain_weights` packs the network's params for the kernel (float32,
  contiguous), with the kernel's per-rank layout (`pack_chain_weights`).
* `plc_chain_plain` is the plain PyTorch version: the same steps, one at a
  time. The CPU tests use it and the chip check holds the kernel against it.
* `plc_chain_kernel` is the wrapper: on a CPU tensor it runs the plain
  version; on a CUDA tensor it launches the kernel or raises.
* `chain_launch_config`, `chain_smem_bytes`, `rank_columns`: the cluster
  design's shape. A cluster of C = 8 blocks owns S streams; rank r owns
  nd / C of the dense layer's units and n / C of each GRU's units with
  their three gate columns, and its weights are packed contiguous, so that
  it reads them from L2 once a step for all S streams.

The +0.1 boost of the predicted correlation stays with the caller: it
applies to predictions only, not to consumed FEC rows.
"""

from __future__ import annotations

import ctypes

import torch

_CWNAMES = ("d1_w", "d1_b", "g1_in", "g1_rec", "g1_b", "g2_in", "g2_rec",
            "g2_b", "out_w", "out_b")
_PACKNAMES = ("k4_d1", "k4_g1_in", "k4_g1_rec", "k4_g2_in", "k4_g2_rec")
# the kernel's weight operands, in its argument order
_LAUNCHNAMES = ("k4_d1", "d1_b", "k4_g1_in", "k4_g1_rec", "g1_b", "k4_g2_in",
                "k4_g2_rec", "g2_b", "out_w", "out_b")


CLUSTER = 8                  # blocks a cluster (the portable limit)
THREADS = 384                # threads a block
STREAMS = (8, 16, 32)        # streams a cluster
SMEM_LIMIT = 232448          # shared memory a block can have on an H100


def plc_chain_weights(plc_params):
    """`models.plc` params -> the kernel's operand bundle: the matrices and
    biases as they are (what the plain version reads) and the kernel's
    per-rank packs (`pack_chain_weights`), built once per network."""
    f32 = lambda x: x.to(torch.float32).contiguous()
    d1, g1 = plc_params["plc_dense1"], plc_params["plc_gru1"]
    g2, out = plc_params["plc_gru2"], plc_params["plc_out"]
    cw = {
        "d1_w": f32(d1["kernel"]), "d1_b": f32(d1["bias"]),
        "g1_in": f32(g1["kernel"]), "g1_rec": f32(g1["recurrent"]),
        "g1_b": f32(g1["bias"]),
        "g2_in": f32(g2["kernel"]), "g2_rec": f32(g2["recurrent"]),
        "g2_b": f32(g2["bias"]),
        "out_w": f32(out["kernel"]), "out_b": f32(out["bias"]),
    }
    cw.update(pack_chain_weights(cw))
    return cw


def rank_columns(n: int, cluster: int = CLUSTER) -> torch.Tensor:
    """[C, 3n / C]: the column of a GRU's [k, 3n] matrix (gates z | r | h)
    that rank r's local column q u + j holds: gate q, unit r u + j, with
    u = n / C."""
    u = n // cluster
    lc = torch.arange(3 * u)[None, :]
    r = torch.arange(cluster)[:, None]
    return (lc // u) * n + r * u + lc % u


def pack_chain_weights(cw, cluster: int = CLUSTER):
    """The kernel's per-rank weights, rank r's contiguous: `k4_d1`
    [C, n_in, nd / C] (dense units r nd / C ..), `k4_g1_in`
    [C, nd, 3 n1 / C + 8], `k4_g1_rec` [C, n1, 3 n1 / C + 8], `k4_g2_in`
    [C, n1, 3 n2 / C + 8], `k4_g2_rec` [C, n2, 3 n2 / C + 8] (the columns of
    `rank_columns`, then 8 zeros: a row lands in the kernel's weight ring as
    it is, and the padding spreads the rows' reads over the banks). The
    biases and the output layer are read as they are."""
    n_in, nd = cw["d1_w"].shape
    n1, n2 = cw["g1_rec"].shape[0], cw["g2_rec"].shape[0]
    for what, n in (("dense", nd), ("GRU-1", n1), ("GRU-2", n2)):
        if n % cluster:
            raise ValueError(f"PLC chain kernel: {what} width {n} is not a "
                             f"multiple of {cluster}")
    def gru(w, n):
        cols = w[:, rank_columns(n, cluster).to(w.device)].permute(1, 0, 2)
        return torch.cat([cols, cols.new_zeros(cols.shape[:2] + (RING_PAD,))], dim=2)

    return {
        "k4_d1": cw["d1_w"].reshape(n_in, cluster, nd // cluster).permute(1, 0, 2).contiguous(),
        "k4_g1_in": gru(cw["g1_in"], n1).contiguous(),
        "k4_g1_rec": gru(cw["g1_rec"], n1).contiguous(),
        "k4_g2_in": gru(cw["g2_in"], n2).contiguous(),
        "k4_g2_rec": gru(cw["g2_rec"], n2).contiguous(),
    }


def k_parts(nc: int, streams: int) -> int:
    """The k parts of a product over nc columns: a thread takes 4 streams x
    4 columns and every k_parts-th k (the CUDA source's `k_parts`); 0 where
    the tiles do not fill the block in a power of two of at most 32 parts."""
    tiles = (nc // 4) * (streams // 4)
    if nc % 4 or tiles == 0 or THREADS % tiles:
        return 0
    kp = THREADS // tiles
    return kp if kp <= 32 and kp & (kp - 1) == 0 else 0


RING_PAD = 8                 # floats of padding a packed row
# (rows a chunk, chunks in the ring) the kernel's weight ring takes, the
# first that fits: 4 chunks of 64 rows at 8 and 16 streams of the shipped
# network, 2 of 48 at 32 (on the card larger chunks beat more of them: each
# chunk costs its waits)
RING_SHAPES = ((64, 4), (48, 2))
RING_CHUNKS = 60             # most chunks a step (the kernel's descriptor table)
_HEAD = 64 + 16 * RING_CHUNKS          # mbarriers, chunk descriptors


def ring_chunks(nd: int, n1: int, n2: int, rows: int) -> int:
    """Chunks of `rows` rows a step: GRU-1's input and recurrent matrices,
    GRU-2's input and recurrent ones."""
    up = lambda k: -(-k // rows)
    return up(nd) + 2 * up(n1) + up(n2)


def chain_smem_bytes(streams: int, n_in: int, nd: int, n1: int, n2: int,
                     n_out: int, nst: int, rows: int) -> int:
    """Shared memory of one block, bytes (the CUDA source's `chain_smem`):
    64 bytes of mbarriers and the chunks' descriptors; per stream the dense
    output, both GRUs' states and candidates, the rank's input and recurrent
    products (one buffer each, for one GRU at a time), the input and the
    mask; once,
    the rank's dense units' weights, its output columns and its units'
    biases; then `nst` chunks of the weight ring, `rows` rows of
    max(3 n1, 3 n2) / C + 8 floats each."""
    nc1, nc2, ud = 3 * n1 // CLUSTER, 3 * n2 // CLUSTER, nd // CLUSTER
    nom, ncm = -(-n_out // CLUSTER), max(nc1, nc2)
    fl = (4 * streams * (nd + 2 * n1 + 2 * n2 + 2 * ncm + n_in + 1)
          + 4 * (n_in * ud + n2 * nom + 2 * nc1 + 2 * nc2 + ud + nom))
    return _HEAD + -(-fl // 16) * 16 + 4 * nst * rows * (ncm + RING_PAD)


def chain_launch_config(batch: int, n_in: int, nd: int, n1: int, n2: int,
                        n_out: int, max_clusters, sms: int):
    """The launch for `batch` streams: {"streams": S, "stages": chunks in
    the weight ring, "rows": rows a chunk, "clusters", "smem", "waves"}. S
    is the smallest of 8, 16 and 32 whose clusters fill no more than the
    card's `sms` multiprocessors and fit one wave (`max_clusters(streams,
    smem)`: the card's answer on CUDA); where none does, 32 (in waves). The
    ring takes the first of `RING_SHAPES` that fits beside the rest. An
    H100 (132 SMs) holds 15 clusters of 8 blocks: 256 streams take 8
    clusters of 32 (a ring of 2 chunks of 48 rows), 37 streams 5 clusters of
    8 (4 chunks of 64 rows)."""
    if batch <= 0:
        raise ValueError(f"PLC chain kernel: batch {batch}")
    fits = []
    if nd % CLUSTER == 0 and n1 % CLUSTER == 0 and n2 % CLUSTER == 0:
        for s in STREAMS:
            ring = next(((rows, nst) for rows, nst in RING_SHAPES
                         if chain_smem_bytes(s, n_in, nd, n1, n2, n_out, nst, rows)
                         <= SMEM_LIMIT and ring_chunks(nd, n1, n2, rows) <= RING_CHUNKS),
                        None)
            if k_parts(3 * n1 // CLUSTER, s) and k_parts(3 * n2 // CLUSTER, s) and ring:
                fits.append((s, ring))
    if not fits:
        raise ValueError(f"PLC chain kernel: widths {n_in}, {nd}, {n1}, {n2} "
                         "do not fit the cluster design")
    for s, (rows, nst) in fits:
        smem = chain_smem_bytes(s, n_in, nd, n1, n2, n_out, nst, rows)
        held = max_clusters(s, smem)
        clusters = -(-batch // s)
        if (clusters <= held and clusters * CLUSTER <= sms) or s == fits[-1][0]:
            break
    return {"streams": s, "stages": nst, "rows": rows, "clusters": clusters,
            "smem": smem, "waves": -(-clusters // held)}


def _gru(h, x, w_in, w_rec, bias):
    n = h.shape[-1]
    zin = x @ w_in + bias[0]
    zrec = h @ w_rec + bias[1]
    z = torch.sigmoid(zin[:, :n] + zrec[:, :n])
    r = torch.sigmoid(zin[:, n:2 * n] + zrec[:, n:2 * n])
    hc = torch.tanh(zin[:, 2 * n:] + r * zrec[:, 2 * n:])
    return z * h + (1.0 - z) * hc


def plc_chain_plain(cw, h1, h2, inputs, masks, k_steps: int):
    """K4's plain PyTorch version, on whatever device the tensors are on.

    cw from `plc_chain_weights`; h1 [B, n1], h2 [B, n2] initial states;
    inputs [B, K, 57]; masks [B, K] bool or int (0 freezes the stream for
    that step; the step's raw output is still returned).
    Returns (h1_seq [B, K, n1], h2_seq [B, K, n2], outs [B, K, 20]): the
    states after each step and each step's dense output.
    """
    inputs = inputs.to(torch.float32)
    h1s, h2s, outs = [], [], []
    for k in range(k_steps):
        d = torch.tanh(inputs[:, k] @ cw["d1_w"] + cw["d1_b"])
        h1n = _gru(h1, d, cw["g1_in"], cw["g1_rec"], cw["g1_b"])
        h2n = _gru(h2, h1n, cw["g2_in"], cw["g2_rec"], cw["g2_b"])
        outs.append(h2n @ cw["out_w"] + cw["out_b"])
        m = (masks[:, k] > 0)[:, None]
        h1 = torch.where(m, h1n, h1)
        h2 = torch.where(m, h2n, h2)
        h1s.append(h1)
        h2s.append(h2)
    return (torch.stack(h1s, dim=1), torch.stack(h2s, dim=1),
            torch.stack(outs, dim=1))


_LIB = None
_MAX_CLUSTERS: dict = {}


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("plc_chain")
        lib.lpcnet_plc_chain.argtypes = ([ctypes.c_int] * 11
                                         + [ctypes.c_void_p] * 18)
        lib.lpcnet_plc_chain.restype = ctypes.c_int
        lib.lpcnet_plc_chain_max_clusters.argtypes = [ctypes.c_int] * 2
        lib.lpcnet_plc_chain_max_clusters.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _max_clusters(dev):
    """`max_clusters(streams, smem)` on the card `dev` (the CUDA occupancy
    query, remembered per card and shape)."""
    def ask(streams, smem):
        key = (dev.index, streams, smem)
        if key not in _MAX_CLUSTERS:
            with torch.cuda.device(dev):
                got = _lib().lpcnet_plc_chain_max_clusters(streams, smem)
            if got <= 0:
                raise RuntimeError(f"PLC chain kernel: no cluster of {CLUSTER} blocks "
                                   f"with {smem} bytes fits the card (CUDA {-got})")
            _MAX_CLUSTERS[key] = got
        return _MAX_CLUSTERS[key]

    return ask


def plc_chain_kernel(cw, h1, h2, inputs, masks, k_steps: int):
    """K masked PLC-net steps in one launch; arguments and results as
    `plc_chain_plain`.

    On a CPU tensor this runs the plain version. On a CUDA tensor it
    launches the CUDA kernel (built on first use) on the per-rank packs of
    `plc_chain_weights` and counts the launch in `plc_chain_kernel.launches`;
    any other device raises. Any batch size.
    """
    dev = h1.device
    if dev.type == "cpu":
        return plc_chain_plain(cw, h1, h2, inputs, masks, k_steps)
    if dev.type != "cuda":
        raise ValueError(f"PLC chain kernel: unsupported device {dev}")
    from .sample_loop import _check
    f32 = torch.float32
    b, n1 = h1.shape
    n2 = h2.shape[1]
    n_in, nd = cw["d1_w"].shape
    n_out = cw["out_w"].shape[1]
    shapes = {"d1_w": (n_in, nd), "d1_b": (nd,), "g1_in": (nd, 3 * n1),
              "g1_rec": (n1, 3 * n1), "g1_b": (2, 3 * n1),
              "g2_in": (n1, 3 * n2), "g2_rec": (n2, 3 * n2),
              "g2_b": (2, 3 * n2), "out_w": (n2, n_out), "out_b": (n_out,)}
    missing = [name for name in _CWNAMES + _PACKNAMES if name not in cw]
    if missing:
        raise ValueError(f"PLC chain kernel: the bundle lacks {missing}; build it "
                         "with plc_chain_weights")
    c = CLUSTER
    l1, l2 = 3 * n1 // c + RING_PAD, 3 * n2 // c + RING_PAD
    shapes.update(k4_d1=(c, n_in, nd // c), k4_g1_in=(c, nd, l1),
                  k4_g1_rec=(c, n1, l1), k4_g2_in=(c, n1, l2), k4_g2_rec=(c, n2, l2))
    for name in _CWNAMES + _PACKNAMES:
        _check(name, cw[name], shapes[name], f32, dev)
    inputs = inputs.to(f32).contiguous()
    masks = masks.to(torch.int32).contiguous()
    # the kernel reads the states 16 bytes at a time
    h1, h2 = (h if h.is_contiguous() and h.data_ptr() % 16 == 0 else h.clone()
              for h in (h1, h2))
    _check("inputs", inputs, (b, k_steps, n_in), f32, dev)
    _check("masks", masks, (b, k_steps), torch.int32, dev)
    _check("h1", h1, (b, n1), f32, dev)
    _check("h2", h2, (b, n2), f32, dev)
    h1_seq = torch.empty((b, k_steps, n1), dtype=f32, device=dev)
    h2_seq = torch.empty((b, k_steps, n2), dtype=f32, device=dev)
    outs = torch.empty((b, k_steps, n_out), dtype=f32, device=dev)
    cfg = chain_launch_config(b, n_in, nd, n1, n2, n_out, _max_clusters(dev),
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        err = _lib().lpcnet_plc_chain(
            cfg["streams"], cfg["stages"], cfg["rows"], cfg["smem"], b, k_steps, n_in, nd,
            n1, n2, n_out,
            *(cw[name].data_ptr() for name in _LAUNCHNAMES),
            inputs.data_ptr(), masks.data_ptr(), h1.data_ptr(), h2.data_ptr(),
            h1_seq.data_ptr(), h2_seq.data_ptr(), outs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"PLC chain kernel launch failed: CUDA error {err}")
    plc_chain_kernel.launches += 1
    return h1_seq, h2_seq, outs


plc_chain_kernel.launches = 0
