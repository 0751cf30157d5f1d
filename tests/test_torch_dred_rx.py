"""DRED's receiving side served as a pool (`runtime.serving.DREDDecoderPool`)
on the CPU: the one native parse of a batch (`entropy.decode_payloads`)
against `entropy.decode_payload` a payload at a time, with and without the
native library, and the payloads it refuses; the pool against the
benchmark's plain reference on seeded random weights and against
`DREDDecoder.decode_payload` a stream at a time; its counters and spans;
the reference's independence of the port and the cell's work count."""

import collections
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness as H
from benchmark.reference import dred_rdovae_dec_256_80 as R
from lpcnet_torch import api
from lpcnet_torch.dred import coder as C
from lpcnet_torch.dred import entropy as EC
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.runtime import bindings as RB
from lpcnet_torch.runtime.serving import DREDDecoderPool
from lpcnet_torch.utils import profiling as PF

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = H.load_json("configs", "dred-rdovae-dec-256-80")
SMALL = RV.RDOVAEConfig(cond_size=32, cond_size2=32, latent_dim=16, state_dim=8,
                        pvq_num_pulses=20)


def _payloads(params, cfg, batch, levels, frames, seed):
    """DREDEncoder's payloads over seeded random features: one batch a
    (q0, q1) of `levels`, back to back in one `Payloads`."""
    enc = C.DREDEncoder(params, cfg, batch=batch, max_latents=frames // 2,
                        device="cpu")
    rs = np.random.RandomState(seed)
    for _ in range(frames + 4):
        enc.add_feature_frame((rs.randn(batch, cfg.num_features) * 2).astype(np.float32))
    outs = [enc.produce_payload(frames, q0, q1) for q0, q1 in levels]
    return EC.Payloads.of([p for out in outs for p in out["payloads"]]), outs


@pytest.fixture(scope="module")
def demo():
    """64 payloads of the demo RDO-VAE at its published widths: 32 streams
    at levels 9-15 and the same 32 at 3-12, 26 latents each."""
    params, cfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device="cpu")
    payloads, _ = _payloads(params, cfg, 32, [(9, 15), (3, 12)], 52, seed=3)
    return params, cfg, payloads


@pytest.fixture(scope="module")
def small():
    """Seeded random weights at a small width, with a seeded statistical
    table (a zero table makes nearly every symbol zero), and 5 streams'
    payloads of 6 latents."""
    params = RV.init_params(SMALL, seed=6)
    params["statistical_model"]["quant_embedding"]["table"] = torch.from_numpy(
        (0.5 * np.random.RandomState(7).randn(SMALL.quant_levels, 6 * SMALL.latent_dim)
         ).astype(np.float32))
    payloads, outs = _payloads(params, SMALL, 5, [(4, 11)], 12, seed=8)
    return params, payloads, outs[0]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_one_parse_equals_decode_payload_a_stream(demo, native):
    params, cfg, payloads = demo
    stats = EC.stats_fixed_point(params, cfg)
    counts = collections.Counter()
    saved = RB.runtime
    if not native:
        RB.runtime = RB._Runtime(native=False)
    try:
        rows = EC.decode_payloads(payloads, stats, cfg.state_dim, cfg.pvq_num_pulses,
                                  counts)
    finally:
        RB.runtime = saved
    assert counts == ({"native_parses": 1} if native else {"python_parses": 64})
    assert rows.dtype == np.int16 and rows.shape == (64, 26 * 81 + 24)
    zq, pulses, q_ids = EC.split_rows(rows, 26, 80, 24)
    assert np.abs(zq).sum() > 0 and len(set(map(tuple, q_ids))) == 2
    for b, payload in enumerate(payloads):
        z, p, q = EC.decode_payload(payload, stats, 24, 82)
        assert np.array_equal(zq[b], z) and np.array_equal(pulses[b], p)
        assert np.array_equal(q_ids[b], q)


def _bad(payload: bytes, case: str) -> bytes:
    if case == "version":
        return bytes([0x20 | payload[0] & 0xF]) + payload[1:]
    if case == "latents":
        return payload[:2] + bytes([payload[2] + 1]) + payload[3:]
    if case == "short":
        return payload[:5]
    return payload[:3] + b"\xff" * 12 + payload[15:]        # index past V(24, 82)


@pytest.mark.parametrize("case", ["version", "latents", "short", "index"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_the_parse_refuses_what_no_framing_makes(demo, case, native):
    params, cfg, payloads = demo
    stats = EC.stats_fixed_point(params, cfg)
    batch = EC.Payloads.of([payloads[0], _bad(payloads[1], case), payloads[2]])
    saved = RB.runtime
    if not native:
        RB.runtime = RB._Runtime(native=False)
    try:
        with pytest.raises(ValueError):
            EC.decode_payloads(batch, stats, 24, 82)
    finally:
        RB.runtime = saved


def test_pool_matches_the_plain_reference(small):
    """5 streams, 6 latents, random weights: the pool's parse equals the
    reference's Python parse, its features within 1e-5 of their scale."""
    params, payloads, out = small
    pool = DREDDecoderPool(params, SMALL, streams=5, device="cpu")
    feats = pool.step_payloads(payloads)
    stats = R.stats_fixed_point(params, SMALL)
    want = R.parse_all(list(payloads), stats, SMALL, "cpu")
    for got, ref in zip(pool.dec.parsed, want):
        assert torch.equal(got.long(), ref)
    assert np.array_equal(want[0].numpy(), out["zq"]) and want[0].abs().sum() > 0
    ref = R.decode(params, SMALL, *want)
    assert feats.shape == ref.shape == (5, 24, 20)
    scale = float(ref.abs().max())
    assert float((feats - ref).abs().max()) <= 1e-5 * scale


def test_pool_equals_decode_payload_a_stream(small):
    params, payloads, _ = small
    pool = DREDDecoderPool(params, SMALL, streams=5, device="cpu")
    feats = pool.step_payloads(payloads)
    one = C.DREDDecoder(params, SMALL, device="cpu")
    for b, payload in enumerate(payloads):
        got = one.decode_payload(payload)
        assert got.shape == (1, 24, 20)
        np.testing.assert_allclose(got[0], feats[b].numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        pool.step_payloads(EC.Payloads.of(list(payloads)[:4]))


def test_counters_one_native_parse_a_tick(small):
    params, payloads, _ = small
    pool = DREDDecoderPool(params, SMALL, streams=5, device="cpu")
    for tick in range(1, 4):
        pool.step_payloads(payloads)
        assert pool.stats == {"native_parses": tick, "payloads_parsed": 5 * tick,
                              "latents_decoded": 6 * 5 * tick}
    assert pool.stats["python_parses"] == 0
    saved, RB.runtime = RB.runtime, RB._Runtime(native=False)
    try:
        pool.step_payloads(payloads)
    finally:
        RB.runtime = saved
    assert pool.stats["python_parses"] == 5 and pool.stats["native_parses"] == 3


def test_traced_tick_gives_the_features_of_an_untraced_one(small):
    params, payloads, _ = small
    pool = DREDDecoderPool(params, SMALL, streams=5, device="cpu")
    plain = pool.step_payloads(payloads)
    PF.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = pool.step_payloads(payloads)
    spans = PF.take_spans()
    assert torch.equal(plain, traced)
    assert [s.name for s in spans] == ["lpcnet.serving.step_payloads",
                                       "lpcnet.dred.parse", "lpcnet.dred.decode"]
    assert spans[0].parent is None and all(s.parent == 0 for s in spans[1:])
    assert not PF.take_spans()


REFERENCE_ALONE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.dred_rdovae_dec_256_80, benchmark.yardstick.work_dred_dec
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"lpcnet_torch", "lpcnet_tpu", "jax"}})) or "none")
"""


def test_the_reference_imports_nothing_of_the_port():
    out = subprocess.run([sys.executable, "-c", REFERENCE_ALONE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "none"
    for path in (ROOT / "benchmark" / "reference" / "dred_rdovae_dec_256_80.py",
                 ROOT / "benchmark" / "yardstick" / "work_dred_dec.py",
                 ROOT / "benchmark" / "runners" / "dred_decode.py"):
        text = path.read_text()
        for name in ("lpcnet_tpu", "jax"):
            assert f"import {name}" not in text and f"from {name}" not in text


def test_dred_dec_work_counts_by_hand():
    """`yardstick/work_dred_dec.py` against a count by hand at the
    configuration's widths: 1,626,112 MACs a latent, 18,432 an
    initialisation, a 26-latent tick at 1024 streams ~1.29 ms at float32's
    peak."""
    from benchmark.yardstick import work_dred_dec as WD
    from benchmark.yardstick.peaks import PEAK
    step = (80 * 256 + 3 * 3 * 256 * 512 + 3 * 256 * 256 + 256 * 256
            + 2048 * 80)
    assert WD.decoder_latent_macs(CFG) == step == 1626112
    assert WD.decoder_init_macs(CFG) == 3 * 24 * 256 == 18432
    tick = WD.tick_seconds(CFG, 1024, 26)
    assert tick == pytest.approx(1024 * 2 * (18432 + 26 * step) / PEAK["f32"], rel=1e-12)
    assert tick == pytest.approx(1.29e-3, rel=0.01)
