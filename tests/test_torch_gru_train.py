"""The GRU training kernel's Python side (K5: plain version, wrapper, weight
packing) vs the JAX package, on the CPU. The same numpy-seeded arrays go
through `lpcnet_tpu.kernels.gru_train.gru_seq_pallas` (the TPU kernel, run by
the Pallas interpreter) and through `lpcnet_torch.kernels.gru_train`; the
resident forward's packed slices, launch shape and route by width against
readers that mirror `csrc/gru_train.cu`. The CUDA kernels themselves are
held against the plain version in test_torch_cuda.py."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import gru_train as JG

from lpcnet_torch.kernels import gru_train as G
from lpcnet_torch.nn import layers as L

torch.set_num_threads(1)


def _mk(seed, n, nin, b, t, rec_gain=0.5):
    """Numpy-seeded GRU weights and inputs. The recurrent matrix has gain
    `rec_gain` (entries N(0, rec_gain / sqrt(n))), a contracting recurrence
    like a trained or freshly initialised GRU's; the JAX package's own
    kernel test draws N(0, 0.2), a gain of 3.9 at 384 units (see
    test_plain_steps_match_pallas_interpret)."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.normal(size=s).astype(np.float32)
    params = {"kernel": f(nin, 3 * n) * 0.2,
              "recurrent": f(n, 3 * n) * np.float32(rec_gain / np.sqrt(n)),
              "bias": f(2, 3 * n) * 0.1}
    return params, f(b, t, nin), f(b, n) * 0.3


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _bf16_dot(a, b):
    return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _scan_ref(params, x, h0):
    """lax.scan reference with the kernel's cast placement (any B, any T)."""
    n = params["recurrent"].shape[0]
    gate_in = _bf16_dot(x, params["kernel"]) + params["bias"][0]
    wr, br = params["recurrent"], params["bias"][1]

    def step(h, g):
        zrec = _bf16_dot(h, wr) + br
        z = jax.nn.sigmoid(g[:, :n] + zrec[:, :n])
        r = jax.nn.sigmoid(g[:, n:2 * n] + zrec[:, n:2 * n])
        hcand = jnp.tanh(g[:, 2 * n:] + r * zrec[:, 2 * n:])
        h2 = z * h + (1.0 - z) * hcand
        return h2, h2

    ht, hs = jax.lax.scan(step, h0, jnp.moveaxis(gate_in, 1, 0))
    return jnp.moveaxis(hs, 0, 1), ht


def _steps_from(p, x, h0, hs_ref):
    """One plain step from every hprev of `hs_ref`, all steps at once: the
    port's next state wherever the reference stood."""
    b, t, n = hs_ref.shape
    gi = G.gate_input(p, torch.from_numpy(x))
    hprev = torch.cat([torch.from_numpy(h0)[:, None],
                       torch.from_numpy(np.array(hs_ref[:, :-1]))], dim=1)
    hs, _ = G.gru_recurrence_plain(p["recurrent"], p["bias"][1],
                                   gi.reshape(b * t, 1, 3 * n),
                                   hprev.reshape(b * t, n))
    return hs.reshape(b, t, n).numpy()


@pytest.mark.parametrize("rec_gain", [0.5, None], ids=["gain0.5", "jaxtest"])
@pytest.mark.parametrize("n,nin,b,t", [(384, 512, 8, 32), (16, 400, 8, 32)])
def test_plain_steps_match_pallas_interpret(n, nin, b, t, rec_gain):
    """Every step of the plain version within 2e-5 of the TPU kernel (the
    JAX package's forward bar): from each state the TPU kernel reached, the
    port's next state equals the TPU kernel's. Same casts, float32 sums in
    another order. Also on the weights of the JAX package's own test
    (N(0, 0.2), id `jaxtest`)."""
    params, x, h0 = _mk(0, n, nin, b, t, rec_gain or 0.2 * np.sqrt(n))
    hs_j, ht_j = JG.gru_seq_pallas(_jnp(params), jnp.asarray(x),
                                   h0=jnp.asarray(h0))
    hs_j = np.asarray(hs_j)
    got = _steps_from(_torch(params), x, h0, hs_j)
    np.testing.assert_allclose(got, hs_j, atol=2e-5)
    np.testing.assert_allclose(got[:, -1], np.asarray(ht_j), atol=2e-5)


@pytest.mark.parametrize("n,nin,b,t", [(384, 512, 8, 32), (16, 400, 8, 32)])
def test_plain_forward_matches_pallas_interpret(n, nin, b, t):
    """The whole trajectory, hs and hT, against the TPU kernel. The first
    step holds the 2e-5 bar. Later steps cannot, between two
    implementations whose float32 sums run in another order: the recurrent
    operand is h rounded to bf16, so an h that differs in its last float32
    bit can round to the neighbouring bf16 value (2^-8 relative), which
    moves the next state by up to ~1e-3 (measured: 2e-5..1e-3 over seeds
    0-2 at gains 0.5 and 1). The bar over 32 steps is 5e-3."""
    params, x, h0 = _mk(0, n, nin, b, t)
    hs_j, ht_j = JG.gru_seq_pallas(_jnp(params), jnp.asarray(x),
                                   h0=jnp.asarray(h0))
    hs, ht = G.gru_seq_kernel(_torch(params), torch.from_numpy(x),
                              h0=torch.from_numpy(h0))
    np.testing.assert_allclose(hs.numpy()[:, 0], np.asarray(hs_j)[:, 0],
                               atol=2e-5)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=5e-3)
    np.testing.assert_allclose(ht.numpy(), np.asarray(ht_j), atol=5e-3)


def _torch_grads(params, x, h0, w):
    p = _torch(params, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ht0 = torch.from_numpy(h0).requires_grad_(True)
    hs, ht = G.gru_seq_kernel(p, xt, h0=ht0)
    ((hs * torch.from_numpy(w)).sum() + (ht ** 2).sum()).backward()
    return {"kernel": p["kernel"].grad, "recurrent": p["recurrent"].grad,
            "bias": p["bias"].grad, "x": xt.grad, "h0": ht0.grad}


def _assert_scaled(got, want, tol=1e-2):
    """Each leaf within `tol` of its largest entry (the JAX package's
    gradient bar: bf16 operands and bf16-rounded cotangents)."""
    for k in want:
        a = np.asarray(want[k])
        scale = max(1e-3, np.abs(a).max())
        np.testing.assert_allclose(got[k].numpy() / scale, a / scale,
                                   atol=tol, err_msg=f"grad mismatch at {k}")


@pytest.mark.parametrize("n,nin,b,t", [(384, 512, 8, 16), (16, 400, 8, 16)])
def test_plain_grads_match_pallas_interpret(n, nin, b, t):
    """Gradients of kernel, recurrent, bias, x and h0 through the plain
    version (autograd) vs the TPU backward kernel (custom VJP)."""
    params, x, h0 = _mk(1, n, nin, b, t)
    w = np.random.RandomState(2).normal(size=(b, t, n)).astype(np.float32)

    def loss(p, x, h0):
        hs, ht = JG.gru_seq_pallas(p, x, h0=h0)
        return jnp.sum(hs * w) + jnp.sum(ht ** 2)

    gp, gx, gh = jax.grad(loss, argnums=(0, 1, 2))(
        _jnp(params), jnp.asarray(x), jnp.asarray(h0))
    want = dict(gp, x=gx, h0=gh)
    _assert_scaled(_torch_grads(params, x, h0, w), want)


def test_plain_ragged_shapes_match_scan():
    """A T that is no multiple of 8 and a B that is no multiple of 8, which
    the TPU kernel's blocking refuses: against the JAX scan with the same
    casts; the first step at 2e-5, the trajectory at 5e-3 (see
    test_plain_forward_matches_pallas_interpret), gradients at the scaled
    1e-2."""
    n, nin, b, t = 32, 40, 5, 13
    params, x, h0 = _mk(3, n, nin, b, t)
    w = np.random.RandomState(4).normal(size=(b, t, n)).astype(np.float32)
    hs_j, ht_j = _scan_ref(_jnp(params), jnp.asarray(x), jnp.asarray(h0))
    hs, ht = G.gru_seq_kernel(_torch(params), torch.from_numpy(x),
                              h0=torch.from_numpy(h0))
    np.testing.assert_allclose(hs.numpy()[:, 0], np.asarray(hs_j)[:, 0],
                               atol=2e-5)
    np.testing.assert_allclose(
        _steps_from(_torch(params), x, h0, np.asarray(hs_j)),
        np.asarray(hs_j), atol=2e-5)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), atol=5e-3)
    np.testing.assert_allclose(ht.numpy(), np.asarray(ht_j), atol=5e-3)

    def loss(p, x, h0):
        hs, ht = _scan_ref(p, x, h0)
        return jnp.sum(hs * w) + jnp.sum(ht ** 2)

    gp, gx, gh = jax.grad(loss, argnums=(0, 1, 2))(
        _jnp(params), jnp.asarray(x), jnp.asarray(h0))
    _assert_scaled(_torch_grads(params, x, h0, w), dict(gp, x=gx, h0=gh))


def test_plain_close_to_f32_recurrence():
    """The bf16-operand recurrence stays near the plain float32 `gru_seq`
    (the drift bound of the JAX package's kernel test)."""
    params, x, h0 = _mk(5, 32, 24, 4, 24)
    p = _torch(params)
    hs, _ = G.gru_seq_kernel(p, torch.from_numpy(x), h0=torch.from_numpy(h0))
    hs32, _ = L.gru_seq(p, torch.from_numpy(x), h0=torch.from_numpy(h0))
    assert float((hs - hs32).abs().max()) < 5e-2


def test_default_h0_is_zero():
    params, x, _ = _mk(6, 16, 12, 3, 7)
    p = _torch(params)
    a, _ = G.gru_seq_kernel(p, torch.from_numpy(x))
    b, _ = G.gru_seq_kernel(p, torch.from_numpy(x), h0=torch.zeros(3, 16))
    assert torch.equal(a, b)


def test_wrapper_runs_plain_on_cpu_without_counting():
    params, x, h0 = _mk(7, 16, 12, 3, 7)
    p = _torch(params)
    gi = G.gate_input(p, torch.from_numpy(x))
    before = dict(G.GruRecurrence.launches)
    hs, ht = G.gru_recurrence(p["recurrent"], p["bias"][1], gi,
                              torch.from_numpy(h0))
    hs_p, ht_p = G.gru_recurrence_plain(p["recurrent"], p["bias"][1], gi,
                                        torch.from_numpy(h0))
    assert G.GruRecurrence.launches == before
    assert torch.equal(hs, hs_p) and torch.equal(ht, ht_p)


def test_launch_totals_sum_the_counter_by_direction():
    saved = G.GruRecurrence.launches.copy()
    try:
        G.GruRecurrence.reset_launches()
        assert G.GruRecurrence.launch_totals() == {"fwd": 0, "bwd": 0}
        G.GruRecurrence.launches.update({("fwd", 384): 2, ("fwd", 16): 3,
                                         ("bwd", 16): 1})
        assert G.GruRecurrence.launch_totals() == {"fwd": 5, "bwd": 1}
    finally:
        G.GruRecurrence.reset_launches()
        G.GruRecurrence.launches.update(saved)


def test_wrapper_refuses_other_devices():
    params, x, h0 = _mk(8, 16, 12, 2, 3)
    p = _torch(params)
    gi = G.gate_input(p, torch.from_numpy(x))
    with pytest.raises(ValueError):
        G.gru_recurrence(p["recurrent"], p["bias"][1], gi.to("meta"),
                         torch.from_numpy(h0))
    # the autograd function itself takes CUDA tensors only
    with pytest.raises(ValueError):
        G.GruRecurrence.apply(p["recurrent"], p["bias"][1], gi,
                              torch.from_numpy(h0))


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 384, 1024])
def test_launch_config_covers_every_unit(n):
    """4 threads for every unit a block owns, at most 1024 a block, the
    units split evenly over the cluster, each k part a whole number of
    4-element words."""
    cluster, threads = G.launch_config(n)
    assert cluster in (1, 4) and n % cluster == 0
    assert threads == 4 * (n // cluster) <= 1024
    assert (n // 4) % 4 == 0


@pytest.mark.parametrize("n", [0, 6, 24, 1040])
def test_launch_config_refuses(n):
    with pytest.raises(ValueError):
        G.launch_config(n)


def test_pack_recurrent_layout():
    """wp[kq, g, u, j] = Wr[4 kq + j, g N + u] (the forward's operand), and
    the backward chain's packed rows (`pack_bwd_weights`, rank r's units
    r U .. r U + U in fragment order) hold Wr[u, j], both rounded to
    bf16."""
    n = 16
    wr = torch.from_numpy(np.random.RandomState(9).normal(
        size=(n, 3 * n)).astype(np.float32))
    wp, wbp = G.pack_recurrent(wr), G.pack_bwd_weights(wr)
    wb = wr.to(torch.bfloat16)
    assert wp.shape == (n // 4, 3, n, 4) and wbp.shape == (1, 1, 3, 32, 8)
    assert wp.dtype == wbp.dtype == torch.bfloat16
    assert wp.is_contiguous() and wbp.is_contiguous()
    for kq, g, u, j in [(0, 0, 0, 0), (1, 2, 5, 3), (3, 1, 15, 2)]:
        assert wp[kq, g, u, j] == wb[4 * kq + j, g * n + u]
    # lane 4 g + t, element e: row g + 8 ((e // 2) & 1), column
    # 16 k + 2 t + 8 (e // 4) + e % 2 of k step k
    for k, lane, e in [(0, 0, 0), (1, 7, 3), (2, 31, 7), (2, 13, 5)]:
        g, t = lane // 4, lane % 4
        u = g + 8 * ((e // 2) & 1)
        j = 16 * k + 2 * t + 8 * (e // 4) + e % 2
        assert wbp[0, 0, k, lane, e] == wb[u, j]


# --------------------------------------------------------------------------
# the resident forward (`gru_fwd_chain_kernel`): its packed slices, launch
# shape and route, against readers that mirror csrc/gru_train.cu
# --------------------------------------------------------------------------

def _read_a_tiles(pack):
    """Rows [M, K] from one rank's packed m16n8k16 A fragments
    [M/16, K/16, 32, 8]: lane l = 4 g + t holds, in register i, row
    g + 8 (i & 1) at depth 2 t + 8 (i >> 1) + {0, 1} (the PTX ISA's layout;
    the kernel reads it as wb[(mt KS + k) 32 + lane])."""
    mts, kts = pack.shape[:2]
    rows = torch.zeros(mts * 16, kts * 16, dtype=pack.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e in range(8):
            i, half = e // 2, e % 2
            rows[g + 8 * (i & 1)::16, 2 * t + 8 * (i >> 1) + half::16] = pack[:, :, lane, e]
    return rows


@pytest.mark.parametrize("n", [64, 384, 448])
def test_pack_fwd_weights_rebuilds_the_rank_columns(n):
    """Rank r's packed slice holds, at row q U + j, Wr's column q N + r U + j
    (gate q of unit r U + j) over all N rows, in bf16; the rows of padding
    units (r U + j >= N: 64 of them at N = 448) are zero."""
    wr = torch.from_numpy(np.random.RandomState(n).normal(
        size=(n, 3 * n)).astype(np.float32))
    c, u = G.bwd_cluster_shape(n)
    pack = G.pack_fwd_weights(wr)
    assert pack.shape == (c, 3 * u // 16, n // 16, 32, 8)
    assert pack.dtype == torch.bfloat16 and pack.is_contiguous()
    wb = wr.to(torch.bfloat16)
    pads = 0
    for r in range(c):
        rows = _read_a_tiles(pack[r])
        for q in range(3):
            for j in range(u):
                unit = r * u + j
                if unit < n:
                    assert torch.equal(rows[q * u + j], wb[:, q * n + unit]), (r, q, j)
                else:
                    assert not rows[q * u + j].any()
                    pads += 1
    assert pads == 3 * (c * u - n)


@pytest.mark.parametrize("n", [48, 64, 384, 448, 512])
@pytest.mark.parametrize("batch", [1, 37, 128, 1024])
def test_fwd_launch_covers_every_stream_and_unit_once(n, batch):
    """The resident forward's clusters cover every (stream, unit) once
    (cluster k owns streams [k S, k S + S) ∩ [0, B), thread (s, u) of rank r
    unit r U + u where that is < N); a block fits 232,448 bytes and 1024
    threads; the product's warp tasks (column tile, k part) cover every
    column tile and k step once; and the exchange (lane 8j + c of a warp
    sends the 16-byte word of its group's 8 units to rank c) delivers every
    8-unit word of every stream to every rank once."""
    cfg = G.fwd_launch_config(batch, n, lambda s, smem: 15)
    c, u, s = cfg["cluster"], cfg["units"], cfg["streams"]
    assert (c, u) == G.bwd_cluster_shape(n) and c * u >= n and u % 16 == 0
    assert cfg["threads"] == s * u <= 1024 and s in (8, 16)
    assert cfg["smem"] == G.fwd_smem_bytes(n, s) <= 232448
    seen = np.zeros((batch, n), int)
    tid = np.arange(cfg["threads"])
    for k in range(cfg["clusters"]):
        for r in range(c):
            b, unit = k * s + tid // u, r * u + tid % u
            keep = (b < batch) & (unit < n)
            np.add.at(seen, (b[keep], unit[keep]), 1)
    assert (seen == 1).all()
    assert cfg["waves"] == -(-cfg["clusters"] // 15)
    # the product: warp w takes column tile w % MT and k part w // MT < KP
    mt, ks, kp = 3 * u // 16, n // 16, G.fwd_kparts(n, s)
    tasks = np.zeros((mt, ks), int)
    for w in range(cfg["threads"] // 32):
        if w // mt < kp:
            p = w // mt
            tasks[w % mt, p * ks // kp:(p + 1) * ks // kp] += 1
    assert (tasks == 1).all()
    # the exchange: (destination rank, stream, first unit of the word)
    words = np.zeros((c, s, c * u // 8), int)
    lane = tid % 32
    for r in range(c):
        first = r * u + tid % u - (lane & 7)
        for t_ in tid[(lane & 7) < c]:
            words[lane[t_] & 7, t_ // u, first[t_] // 8] += 1
        assert (first % 8 == 0).all()
    assert (words == 1).all()
    if n == 384:            # the slice: Wr's 144 columns of 48 units, 110.6 KB
        assert (c, u) == (8, 48)
        assert cfg["smem"] - 2 * s * (c * u + 8) * 2 - kp * s * (3 * u + 4) * 4 == 110592


def test_forward_route_is_chosen_by_width():
    """Warp-synchronous at N <= 32; the resident cluster forward where a
    rank's slice of Wr fits a block beside the operand buffers (48..512
    units, the training path's 384 among them); the first cluster kernel
    above (Wr from L2). The resident forward's S follows the card's cluster
    count as the backward chain's does, and a width without a resident
    forward has no launch of it."""
    want = {16: "warp", 32: "warp", 48: "resident", 64: "resident",
            384: "resident", 448: "resident", 512: "resident",
            528: "cluster", 640: "cluster", 1024: "cluster"}
    assert {n: G.forward_route(n) for n in want} == want
    assert G.fwd_launch_config(128, 384, lambda s, m: 15)["streams"] == 16
    assert G.fwd_launch_config(128, 384, lambda s, m: 16)["streams"] == 8
    assert G.fwd_launch_config(128, 512, lambda s, m: 15)["streams"] == 8
    for n in (16, 640, 1024):
        with pytest.raises(ValueError):
            G.fwd_launch_config(8, n, lambda s, m: 15)
    with pytest.raises(ValueError):
        G.forward_route(24)
