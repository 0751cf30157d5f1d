"""DRED's payload framing on the card (`kernels.dred_payload`), the parts a
CPU reaches: the V(n, k) table and the p0/r rows the kernel reads, the
stage's layout (one buffer, one copy), the wrapper's checks of its
operands, and that CPU input still takes the native call. The
kernel's bytes against the native call's are card tests
(`tests/test_torch_cuda.py -k dred_payload`)."""

import collections

import numpy as np
import pytest
import torch

from lpcnet_torch.dred import entropy as EC
from lpcnet_torch.dred.coder import DREDEncoder
from lpcnet_torch.kernels import dred_payload as DP
from lpcnet_torch.models import rdovae as RV

torch.set_num_threads(1)


def _stats(seed=1, levels=16, dim=80):
    rs = np.random.RandomState(seed)
    return {"p0_q15": rs.randint(0, 1 << 16, (levels, dim)).astype(np.uint16),
            "r_q15": rs.randint(0, 1 << 16, (levels, dim)).astype(np.uint16)}


@pytest.mark.parametrize("state_dim,k", [(24, 82), (13, 5), (8, 20), (1, 0), (0, 3)])
def test_pvq_table_holds_the_codebook_sizes(state_dim, k):
    """Every V(n, k') for n <= state_dim, k' <= k, read back from its two
    64-bit words, equals `pvq_codebook_size`."""
    t = DP.pvq_table(state_dim, k)
    assert t.dtype == torch.int64 and t.shape == (state_dim + 1, k + 1, 2)
    assert t.is_contiguous()
    words = t.numpy().view(np.uint64)
    for n in range(state_dim + 1):
        for j in range(k + 1):
            got = int(words[n, j, 0]) | int(words[n, j, 1]) << 64
            assert got == RV.pvq_codebook_size(n, j), (n, j)


def test_pvq_table_refuses_a_codebook_past_127_bits():
    with pytest.raises(ValueError):
        DP.pvq_table(40, 82)


@pytest.mark.parametrize("n_lat,q0,q1", [(26, 9, 15), (1, 3, 3), (4, 0, 15), (13, 15, 0)])
def test_prob_rows_are_the_stats_rows(n_lat, q0, q1):
    stats = _stats()
    q_ids = EC.payload_q_ids(n_lat, q0, q1)
    rows = DP.prob_rows(stats, q_ids)
    assert rows.dtype == torch.int32 and rows.shape == (2, n_lat * 80)
    assert np.array_equal(rows[0].numpy(), stats["p0_q15"][q_ids].reshape(-1))
    assert np.array_equal(rows[1].numpy(), stats["r_q15"][q_ids].reshape(-1))


@pytest.mark.parametrize("state_dim,k", [(24, 82), (13, 5), (8, 20), (1, 1), (3, 0)])
def test_index_bytes_read_the_tables_last_count(state_dim, k):
    """The PVQ index's bytes, read off the table's V(state_dim, k), are the
    Python coder's `pvq_index_bits` rounded up to bytes."""
    want = (EC.pvq_index_bits(state_dim, k) + 7) // 8
    assert DP.index_bytes(DP.pvq_table(state_dim, k)) == want
    assert DP.Framing(_stats(), 2, 1, 5, state_dim, k, "cpu").nsb == want


@pytest.mark.parametrize("batch,n_lat,dim,state_dim", [
    (1, 26, 80, 24), (33, 26, 80, 24), (1000, 26, 80, 24), (3, 1, 5, 3)])
def test_one_stage_holds_symbols_lengths_and_bits(batch, n_lat, dim, state_dim):
    """`stage` writes the symbols, the pulses and the bits into views of one
    buffer (the int16 part padded to 4 bytes) beside the lengths, so one
    copy brings all of them over."""
    f = DP.Framing(_stats(), batch, n_lat, dim, state_dim, 82, "cpu")
    rs = np.random.RandomState(batch)
    zq = rs.randint(-255, 256, (batch, n_lat, dim)).astype(np.float32)
    pulses = rs.randint(-82, 83, (batch, state_dim))
    lengths = rs.randint(0, 5000, batch).astype(np.int32)
    bits = rs.rand(batch).astype(np.float32) * 1e4
    f.stage(torch.from_numpy(zq), torch.from_numpy(pulses), torch.from_numpy(bits))
    f.lengths.copy_(torch.from_numpy(lengths))
    for t in (f.sym, f.lengths, f.bits):
        assert t.untyped_storage().data_ptr() == f.stage_buf.untyped_storage().data_ptr()
    sym = np.concatenate([zq.reshape(batch, -1), pulses], 1).astype(np.int16)
    assert f.stage_buf.numel() == -(-2 * sym.size // 4) * 4 + 8 * batch
    got = f.fetch()
    for g, w in zip(got, (sym, lengths, bits)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert f.stride == 64 + 2 * n_lat * dim and f.retries == 0


def test_stage_takes_strided_operands():
    """Operands that are views with strides of their own stage as their
    values: the kernel reads only the stage."""
    f = DP.Framing(_stats(), 4, 26, 80, 24, 82, "cpu")
    rs = np.random.RandomState(5)
    zq = torch.from_numpy(rs.randint(-9, 10, (80, 26, 4)).astype(np.float32))
    pulses = torch.from_numpy(rs.randint(-3, 4, (24, 4)))
    bits = torch.arange(8, dtype=torch.float32)
    f.stage(zq.permute(2, 1, 0), pulses.t(), bits[::2])
    sym, _, got_bits = f.fetch()
    assert np.array_equal(sym[:, :26 * 80], zq.permute(2, 1, 0).reshape(4, -1).numpy())
    assert np.array_equal(sym[:, 26 * 80:], pulses.t().numpy())
    assert np.array_equal(got_bits, bits[::2].numpy())


def _operands(b=4, n_lat=26, dim=80, state_dim=24):
    rs = np.random.RandomState(6)
    return (torch.from_numpy(rs.randint(-9, 10, (b, n_lat, dim)).astype(np.float32)),
            torch.from_numpy(rs.randint(-3, 4, (b, state_dim))),
            torch.zeros(b))


BAD = {
    "zq_dtype": (TypeError, lambda z, p, b: (z.bool(), p, b)),
    "zq_shape": (ValueError, lambda z, p, b: (z[:, :-1], p, b)),
    "zq_device": (ValueError, lambda z, p, b: (z.to("meta"), p, b)),
    "zq_array": (ValueError, lambda z, p, b: (z.numpy(), p, b)),
    "pulses_dtype": (TypeError, lambda z, p, b: (z, p.float(), b)),
    "pulses_shape": (ValueError, lambda z, p, b: (z, p[:-1], b)),
    "pulses_device": (ValueError, lambda z, p, b: (z, p.to("meta"), b)),
    "bits_dtype": (TypeError, lambda z, p, b: (z, p, b.long())),
    "bits_shape": (ValueError, lambda z, p, b: (z, p, b[None])),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_stage_refuses_what_the_kernel_does_not_take(case):
    """Wrong dtype, shape or device of an operand raise before anything is
    staged or launched."""
    err, bad = BAD[case]
    f = DP.Framing(_stats(), 4, 26, 80, 24, 82, "cpu")
    f.sym.fill_(7)
    launches = DP.Framing.launches
    with pytest.raises(err):
        f.stage(*bad(*_operands()))
    assert DP.Framing.launches == launches and bool((f.sym == 7).all())


@pytest.mark.parametrize("q0,q1,n_ids", [(16, 15, 26), (9, -1, 26), (9, 15, 25), (9, 15, 26)])
def test_launch_refuses_a_header_off_range_levels_or_a_cpu_stage(q0, q1, n_ids):
    """Header fields out of range, a level count that is not the latents',
    and a stage off the card (the framing has no CPU form) raise before
    any launch."""
    f = DP.Framing(_stats(), 4, 26, 80, 24, 82, "cpu")
    f.stage(*_operands())
    launches = DP.Framing.launches
    with pytest.raises(ValueError):
        f.launch(q0, q1, np.full(n_ids, 9))
    assert DP.Framing.launches == launches


def test_bad_pulses_raise_before_any_copy():
    f = DP.Framing(_stats(), 3, 26, 80, 24, 82, "cpu")
    with pytest.raises(ValueError):
        f.payloads(np.array([40, -2, 60], np.int32))


def _symbols(b, seed=3):
    rs = np.random.RandomState(seed)
    zq = np.round(rs.laplace(0, 1.5, (b, 26, 80))).astype(np.int16)
    pulses = np.stack([EC.pvq_search(v, 82) for v in rs.randn(b, 24)]).astype(np.int16)
    return zq, pulses


def test_cpu_tensor_input_takes_the_native_call():
    """CPU tensors go to the one native call, counted in `native_calls`,
    with the same bytes as `encode_payload` a stream: only CUDA tensors
    reach the card's framing."""
    stats = _stats()
    zq, pulses = _symbols(5)
    counts = collections.Counter()
    got = EC.encode_payloads(torch.from_numpy(zq), torch.from_numpy(pulses), 9, 15,
                             stats, 82, counts)
    assert counts == {"native_calls": 1}
    assert got == [EC.encode_payload(z, p, 9, 15, stats, 82) for z, p in zip(zq, pulses)]


def test_a_cpu_encoder_frames_on_the_host():
    """A CPU `DREDEncoder` frames through the native call: no device
    framing is counted."""
    cfg = RV.RDOVAEConfig(cond_size=32, cond_size2=32, latent_dim=20, state_dim=8,
                          pvq_num_pulses=20)
    enc = DREDEncoder(RV.init_params(cfg, seed=2), cfg, batch=3, device="cpu")
    rs = np.random.RandomState(4)
    for _ in range(2 * 4):
        enc.add_feature_frame(rs.randn(3, 20).astype(np.float32))
    out = enc.produce_payload(8)
    assert len(out["payloads"]) == 3
    assert enc.stats["native_calls"] == 1
    assert "device_framings" not in enc.stats and "device_retries" not in enc.stats
