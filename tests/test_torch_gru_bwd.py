"""K5's backward as redesigned for Hopper, on the CPU: the plain versions of
its three phases (`gate_pass_plain`, `chain_plain`, `dwr_plain`, composed by
`rec_backward_plain`) against the JAX package's `_rec_backward` (the TPU
kernel, run by the Pallas interpreter) and against the plain autograd
backward; the chain's packed weights and launch shape against readers that
mirror the CUDA source's index arithmetic (`csrc/gru_train.cu`). The CUDA
kernels themselves are held against these in test_torch_cuda.py and
chip_smoke.py."""

import os

os.environ["LPCNET_PALLAS_INTERPRET"] = "1"  # before the JAX kernels import

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.kernels import gru_train as JG

from lpcnet_torch.kernels import gru_train as G
from lpcnet_torch.kernels import masked_loop as ML

torch.set_num_threads(1)


def _mk(seed, n, nin, b, t, rec_gain=0.5):
    """The recipe of test_torch_gru_train.py: numpy-seeded weights, a
    contracting recurrence of gain `rec_gain`, inputs and h0."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.normal(size=s).astype(np.float32)
    params = {"kernel": f(nin, 3 * n) * 0.2,
              "recurrent": f(n, 3 * n) * np.float32(rec_gain / np.sqrt(n)),
              "bias": f(2, 3 * n) * 0.1}
    return params, f(b, t, nin), f(b, n) * 0.3


class _PhasesBackward(torch.autograd.Function):
    """The plain recurrence whose backward is the three phases composed:
    the CUDA backward's arithmetic, phase by phase, on the CPU."""

    @staticmethod
    def forward(ctx, wr, br, gate_in, h0):
        with torch.no_grad():
            hs, ht = G.gru_recurrence_plain(wr, br, gate_in, h0)
        ctx.save_for_backward(wr, br, gate_in, h0, hs)
        return hs, ht

    @staticmethod
    def backward(ctx, dhs, dht):
        dg, dh0, dwr, dbr = G.rec_backward_plain(*ctx.saved_tensors, dhs, dht)
        return dwr, dbr, dg, dh0


def _phases(wr, br, gate_in, h0):
    return _PhasesBackward.apply(wr, br, gate_in, h0)


def _torch_grads(fn, params, x, h0, w):
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ht0 = torch.from_numpy(h0).requires_grad_(True)
    gi = G.gate_input(p, xt)
    hs, ht = fn(p["recurrent"], p["bias"][1], gi, ht0)
    ((hs * torch.from_numpy(w)).sum() + (ht ** 2).sum()).backward()
    return {"kernel": p["kernel"].grad, "recurrent": p["recurrent"].grad,
            "bias": p["bias"].grad, "x": xt.grad, "h0": ht0.grad}


def _assert_scaled(got, want, tol):
    """Each leaf within `tol` of its largest entry."""
    for k in want:
        a = np.asarray(want[k])
        scale = max(1e-3, np.abs(a).max())
        np.testing.assert_allclose(np.asarray(got[k]) / scale, a / scale,
                                   atol=tol, err_msg=f"grad mismatch at {k}")


@pytest.mark.parametrize("n,nin,b,t", [(384, 512, 8, 16), (16, 400, 8, 16)])
def test_phases_match_pallas_interpret(n, nin, b, t):
    """The composed phases as the layer's backward vs the TPU backward
    kernel (custom VJP), with the recipe and bar of
    test_plain_grads_match_pallas_interpret: gradients of kernel,
    recurrent, bias, x and h0 within 1e-2 of each leaf's largest entry."""
    params, x, h0 = _mk(1, n, nin, b, t)
    w = np.random.RandomState(2).normal(size=(b, t, n)).astype(np.float32)

    def loss(p, x, h0):
        hs, ht = JG.gru_seq_pallas(p, x, h0=h0)
        return jnp.sum(hs * w) + jnp.sum(ht ** 2)

    gp, gx, gh = jax.grad(loss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(h0))
    _assert_scaled(_torch_grads(_phases, params, x, h0, w),
                   dict(gp, x=gx, h0=gh), 1e-2)


@pytest.mark.parametrize("n", [384, 16])
def test_phases_match_rec_backward_directly(n):
    """`rec_backward_plain` vs the JAX package's `_rec_backward` on the
    same (wr, br, gate_in, h0, hs, dhs, dhT): dgate_in, dh0, dWr and dbr
    within 1e-3 of each output's largest entry (measured 3e-4 at 384
    units, 2e-7 at 16: the interpreter's bf16 products round differently)."""
    b, t = 8, 16
    rs = np.random.RandomState(3)
    f = lambda *s: rs.normal(size=s).astype(np.float32)
    wr, br = f(n, 3 * n) * np.float32(0.5 / np.sqrt(n)), f(3 * n) * 0.1
    gi, h0, dhs, dht = f(b, t, 3 * n), f(b, n) * 0.3, f(b, t, n), f(b, n)
    T = torch.from_numpy
    hs, _ = G.gru_recurrence_plain(T(wr), T(br), T(gi), T(h0))
    got = G.rec_backward_plain(T(wr), T(br), T(gi), T(h0), hs, T(dhs), T(dht))
    want = JG._rec_backward(*(jnp.asarray(a) for a in (wr, br, gi, h0)),
                            jnp.asarray(hs.numpy()), jnp.asarray(dhs),
                            jnp.asarray(dht), 8)
    names = ("dgate_in", "dh0", "dWr", "dbr")
    _assert_scaled(dict(zip(names, got)), dict(zip(names, want)), 1e-3)


@pytest.mark.parametrize("n,nin,b,t", [(384, 512, 8, 16), (16, 400, 8, 16),
                                       (32, 40, 5, 13)])
def test_phases_match_plain_autograd(n, nin, b, t):
    """The composed phases vs autograd through `gru_recurrence_plain`, each
    leaf within 1e-2 of its largest entry, the repo's gradient bar
    (measured 3e-4 to 5.3e-3). Not closer: at a bf16 cast autograd rounds
    the gradient itself, bf16(dzrec . bf16(Wr)^T) for dh and
    bf16(sum hprev^T dzrec) for dWr, where the kernel, like the TPU kernel,
    rounds the operand dzrec and keeps float32 sums; and the input
    product's casts round dgate_in's gradient to bf16 on both sides, so a
    last-bit difference there moves the kernel's and x's leaves by up to an
    ulp of bf16 (2^-8 relative). test_gate_pass_factors_make_the_step_gradients
    holds the factored step arithmetic itself to 1e-6."""
    params, x, h0 = _mk(4, n, nin, b, t)
    w = np.random.RandomState(5).normal(size=(b, t, n)).astype(np.float32)
    _assert_scaled(_torch_grads(_phases, params, x, h0, w),
                   _torch_grads(G.gru_recurrence_plain, params, x, h0, w), 1e-2)


def test_gate_pass_factors_make_the_step_gradients():
    """d times the gate pass's factors is the JAX kernel's step arithmetic
    (`_bwd_kernel`: dz = d (hprev - hcand), dpre_h = d (1-z)(1-hcand^2),
    dpre_z = dz z (1-z), dpre_r = dpre_h zrec_h r (1-r), dzrec_h = dpre_h r)
    to 1e-6 of each gradient's largest entry, for any d."""
    n, b, t = 48, 3, 5
    rs = np.random.RandomState(6)
    f = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32))
    wr, br, gi, h0 = f(n, 3 * n) * 0.1, f(3 * n) * 0.1, f(b, t, 3 * n), f(b, n)
    hs, _ = G.gru_recurrence_plain(wr, br, gi, h0)
    z, fz, fr, fh, fzh = G.gate_pass_plain(wr, br, gi, h0, hs)
    hp = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    zrec = G._bf16(hp) @ G._bf16(wr) + br
    zz = torch.sigmoid(gi[..., :n] + zrec[..., :n])
    r = torch.sigmoid(gi[..., n:2 * n] + zrec[..., n:2 * n])
    hc = torch.tanh(gi[..., 2 * n:] + r * zrec[..., 2 * n:])
    d = f(b, t, n)
    dph = d * (1.0 - zz) * (1.0 - hc * hc)
    want = {"dpz": d * (hp - hc) * zz * (1.0 - zz),
            "dpr": dph * zrec[..., 2 * n:] * r * (1.0 - r),
            "dph": dph, "dzh": dph * r, "dkeep": d * zz}
    got = {"dpz": d * fz, "dpr": d * fr, "dph": d * fh, "dzh": d * fzh,
           "dkeep": d * z}
    _assert_scaled(got, want, 1e-6)


def _read_rank_rows(pack, u):
    """Rank rows [U, 3N] from one rank's packed A fragments
    [U/16, 3N/16, 32, 8]: lane l = 4 g + t holds, in register i, row
    g + 8 (i & 1) at depth 2 t + 8 (i >> 1) + {0, 1} (the PTX ISA's
    m16n8k16 A fragment; the chain reads it as wb[(mt KS + k) 32 + lane])."""
    mts, kts = pack.shape[:2]
    rows = torch.zeros(u, kts * 16, dtype=pack.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e in range(8):
            i, half = e // 2, e % 2
            m, k = g + 8 * (i & 1), 2 * t + 8 * (i >> 1) + half
            for mt in range(mts):
                rows[mt * 16 + m, k::16][:kts] = pack[mt, :, lane, e]
    return rows


@pytest.mark.parametrize("n", [16, 64, 384, 640, 1024])
def test_resident_slices_rebuild_wr(n):
    """Rank r's packed rows are Wr's rows of units r U .. r U + U in bf16,
    zero past N; all ranks together rebuild bf16(Wr)."""
    wr = torch.from_numpy(np.random.RandomState(n).normal(
        size=(n, 3 * n)).astype(np.float32))
    c, u = G.bwd_cluster_shape(n)
    pack = G.pack_bwd_weights(wr)
    assert pack.shape == (c, u // 16, 3 * n // 16, 32, 8)
    assert pack.dtype == torch.bfloat16 and pack.is_contiguous()
    rows = torch.cat([_read_rank_rows(pack[r], u) for r in range(c)])
    assert torch.equal(rows[:n], wr.to(torch.bfloat16))
    assert not rows[n:].any()


@pytest.mark.parametrize("n", [16, 64, 384, 640, 1024])
@pytest.mark.parametrize("batch", [1, 37, 128, 1024])
def test_chain_launch_covers_every_unit_and_stream_once(n, batch):
    """The chain's clusters cover every (stream, unit) once: cluster k owns
    streams [k S, k S + S) ∩ [0, B), thread (s, u) of rank r unit r U + u
    where that is < N; a block fits 232,448 bytes and 1024 threads; the
    resident rows of Wr take U x 3N bf16 in it (at N = 384 all of them:
    110,592 bytes)."""
    cfg = G.bwd_launch_config(batch, n, lambda s, smem: 15)
    c, u, s = cfg["cluster"], cfg["units"], cfg["streams"]
    assert (c, u) == G.bwd_cluster_shape(n) and c * u >= n and u % 16 == 0
    assert cfg["threads"] == s * u <= 1024 and s in (8, 16)
    assert cfg["smem"] == G.bwd_smem_bytes(n, s, cfg["resident"]) <= 232448
    assert cfg["smem"] <= ML.SMEM_LIMIT
    seen = np.zeros((batch, n), int)
    tid = np.arange(cfg["threads"])
    for k in range(cfg["clusters"]):
        for r in range(c):
            b, unit = k * s + tid // u, r * u + tid % u
            keep = (b < batch) & (unit < n)
            np.add.at(seen, (b[keep], unit[keep]), 1)
    assert (seen == 1).all()
    assert cfg["waves"] == -(-cfg["clusters"] // 15)
    if n == 384:
        assert cfg["resident"] and (c, u) == (8, 48)
        assert cfg["smem"] - G.bwd_smem_bytes(n, s, False) == 110592
    if n >= 640:
        assert not cfg["resident"]


def test_chain_streams_follow_the_cards_cluster_count():
    """S is the smallest of 8 and 16 whose clusters fit one wave: at 128
    streams and 384 units, 16 when the card holds 15 clusters of 8 blocks,
    8 when it holds 16; N = 1024 takes 8 (a thread per stream and unit,
    U = 128)."""
    assert G.bwd_launch_config(128, 384, lambda s, m: 15)["streams"] == 16
    assert G.bwd_launch_config(128, 384, lambda s, m: 16)["streams"] == 8
    assert G.bwd_launch_config(128, 1024, lambda s, m: 15)["streams"] == 8


@pytest.mark.parametrize("n", [0, 6, 24, 1040])
def test_chain_refuses_widths_as_before(n):
    """The widths the first backward refused (not a multiple of 16, or past
    1024) are refused by the chain's shape too."""
    with pytest.raises(ValueError):
        G.bwd_cluster_shape(n)
    with pytest.raises(ValueError):
        G.bwd_launch_config(8, n, lambda s, m: 15)
    with pytest.raises(ValueError):
        G.launch_config(n)
