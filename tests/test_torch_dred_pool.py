"""DRED's sender side served as a pool (`runtime.serving.DREDEncoderPool`)
on the CPU: against the benchmark's plain reference tick by tick; the
batched PVQ search against `entropy.pvq_search`; the one native framing
call against `encode_payload` a stream and the Python path; the pool's
counters and spans; and the cell `dred-enc-1024` through the harness at a
tiny size, its bf16 control and its "state kept" fault."""

import collections
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import faults as FT
from benchmark import harness as H
from benchmark.reference import dred_rdovae_256_80 as R
from benchmark.tests.conftest import TINY, bench, cpu_run
from lpcnet_torch.dred import entropy as EC
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.runtime import bindings as RB
from lpcnet_torch.runtime.serving import DREDEncoderPool
from lpcnet_torch.utils import profiling as PF

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL = "dred-enc-1024"
CFG = H.load_json("configs", "dred-rdovae-256-80")
K = CFG["pvq_num_pulses"]


@pytest.fixture(scope="module")
def model():
    """Seeded random weights at the configuration's widths, with a seeded
    statistical table (a zero table makes nearly every symbol zero)."""
    cfg = RV.RDOVAEConfig(**{k: CFG[k] for k in RV.RDOVAEConfig.__dataclass_fields__})
    params = RV.init_params(cfg, seed=4)
    params["statistical_model"]["quant_embedding"]["table"] = torch.from_numpy(
        (0.5 * np.random.RandomState(5).randn(cfg.quant_levels, 6 * cfg.latent_dim)
         ).astype(np.float32))
    return params, cfg


def _speech(streams, ticks, seed=7):
    spec = H.load_json("traffic", CELL)["speech"]
    from benchmark import generate as G
    pcm = G.speech(streams, ticks * 320, spec, G.device_generator(seed, "cpu"), "cpu")
    return pcm.reshape(streams, ticks, 320).transpose(0, 1).to(torch.int16).numpy()


def test_pool_matches_the_reference_tick_by_tick(model):
    """3 streams, 40 ticks, pool and reference from the same zero state:
    every payload's bytes, symbols and pulses equal, every newest latent
    within 1e-5 of the reference's largest."""
    params, cfg = model
    audio = _speech(3, 40)
    pool = DREDEncoderPool(params, cfg, streams=3, device="cpu")
    rcfg = R.model_config(CFG)
    state, zs = R.init_state(3, rcfg, "cpu"), []
    stats = R.stats_fixed_point(params, rcfg)
    made = 0
    for t in range(40):
        out = pool.step_pcm(audio[t])
        state, z, st = R.encode_tick(params, rcfg, state, torch.from_numpy(audio[t]))
        zs = (zs + [z])[-26:]
        gap = float((pool.enc.z_window[-1] - z).abs().max()) / float(z.abs().max())
        assert gap < 1e-5, (t, gap)
        if len(zs) < 26:
            assert out is None
            continue
        zq = R.symbols(params, rcfg, torch.stack(zs, 1), 9, 15).numpy()
        pulses = R.pvq_rows(st, K)
        assert np.array_equal(out["zq"], zq) and np.abs(zq).sum() > 0
        assert np.array_equal(out["pulses"], pulses)
        want = [R.encode_payload(zq[b], pulses[b], 9, 15, stats, K) for b in range(3)]
        assert out["payloads"] == want
        made += 1
    assert made == 15
    assert pool.stats == collections.Counter(
        payloads=45, latents=45 * 26, native_calls=15,
        bytes=pool.stats["bytes"])


PVQ_CASES = {
    "random": lambda rs: rs.randn(300, 24) * np.exp(rs.uniform(-6, 3, (300, 1))),
    "ties": lambda rs: np.concatenate([np.sign(rs.randn(100, 24)),
                                       np.round(rs.randn(100, 24) * 2),
                                       np.tile(np.arange(24.0) % 3, (20, 1))]),
    "zeros": lambda rs: np.concatenate([np.zeros((4, 24)), np.eye(24)[:4] * 1e-300]),
}


@pytest.mark.parametrize("case", sorted(PVQ_CASES))
@pytest.mark.parametrize("n,k", [(24, 82), (8, 20), (13, 5), (150, 40)])
def test_batched_pvq_search_equals_pvq_search(case, n, k):
    rs = np.random.RandomState(11)
    x = PVQ_CASES[case](rs)
    x = np.resize(x, (x.shape[0], n)) if n != 24 else x
    got = EC.pvq_search_batch(torch.from_numpy(x), k).numpy()
    want = np.stack([EC.pvq_search(r, k) for r in x])
    assert got.dtype == np.int64 and np.array_equal(got, want)


def _symbols(rs, b, n_lat=26, dim=80):
    zq = np.round(rs.laplace(0, 1.5, (b, n_lat, dim))).astype(np.int16)
    zq[0, 0, :3] = [255, -255, 254]
    return zq


def test_one_native_call_frames_every_payload(model):
    """The batched call's bytes equal `encode_payload`'s a stream and the
    Python path's (the library hidden); each decodes back."""
    params, cfg = model
    stats = EC.stats_fixed_point(params, cfg)
    rs = np.random.RandomState(3)
    zq = _symbols(rs, 9)
    pulses = np.stack([EC.pvq_search(v, K) for v in rs.randn(9, 24)]).astype(np.int16)
    one = [EC.encode_payload(zq[b].astype(np.int32), pulses[b], 9, 15, stats, K)
           for b in range(9)]
    counts = collections.Counter()
    native = EC.encode_payloads(zq, pulses, 9, 15, stats, K, counts)
    assert counts == {"native_calls": 1}
    saved, RB.runtime = RB.runtime, RB._Runtime(native=False)
    try:
        python = EC.encode_payloads(zq, pulses, 9, 15, stats, K, counts)
    finally:
        RB.runtime = saved
    assert counts == {"native_calls": 1, "python_payloads": 9}
    assert native == one == python and len(native.data) == sum(map(len, one))
    for b, payload in enumerate(native):
        z, p, q = EC.decode_payload(payload, stats, 24, K)
        assert np.array_equal(z, zq[b]) and np.array_equal(p, pulses[b])
        assert np.array_equal(q, EC.payload_q_ids(26, 9, 15))


def test_native_framing_grows_its_buffer_and_refuses_bad_pulses(model):
    params, cfg = model
    stats = EC.stats_fixed_point(params, cfg)
    rs = np.random.RandomState(4)
    # large symbols: more bytes than the first buffer holds
    zq = (rs.choice([-1, 1], (2, 26, 80)) * 200).astype(np.int16)
    pulses = np.stack([EC.pvq_search(v, K) for v in rs.randn(2, 24)]).astype(np.int16)
    got = RB.runtime.dred_frame_payloads(zq, pulses, 9, 15, stats["p0_q15"][EC.payload_q_ids(26, 9, 15)],
                                         stats["r_q15"][EC.payload_q_ids(26, 9, 15)], K)
    data, lengths, calls = got
    assert calls > 1 and lengths.sum() == len(data) > 2 * (64 + 2 * 26 * 80)
    assert EC.Payloads(data, lengths) == [EC.encode_payload(zq[b], pulses[b], 9, 15, stats, K)
                                          for b in range(2)]
    pulses[1, 0] += 1
    with pytest.raises(ValueError):
        EC.encode_payloads(zq, pulses, 9, 15, stats, K)


def test_traced_tick_gives_the_bytes_of_an_untraced_one(model):
    """Two pools on the same audio, one tick traced: the same payloads, and
    under the trace the tick's spans nested under `step_pcm`."""
    params, cfg = model
    audio = _speech(2, 28, seed=9)
    a, b = (DREDEncoderPool(params, cfg, streams=2, device="cpu") for _ in "ab")
    for t in range(27):
        a.step_pcm(audio[t])
        b.step_pcm(audio[t])
    PF.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = a.step_pcm(audio[27])
    spans = PF.take_spans()
    plain = b.step_pcm(audio[27])
    assert traced["payloads"] == plain["payloads"] and len(plain["payloads"]) == 2
    assert np.array_equal(traced["zq"], plain["zq"])
    names = [s.name for s in spans]
    assert names[0] == "lpcnet.serving.step_pcm" and spans[0].parent is None
    assert sorted(names[1:]) == sorted([
        "lpcnet.dred.features", "lpcnet.dred.encode", "lpcnet.dred.quantize",
        "lpcnet.dred.pvq", "lpcnet.dred.readback", "lpcnet.dred.entropy"])
    assert all(s.parent == 0 for s in spans[1:])
    assert not PF.take_spans()


def test_pool_takes_int16_or_float_and_refuses_other_shapes(model):
    params, cfg = model
    audio = _speech(2, 27, seed=2)
    a, b = (DREDEncoderPool(params, cfg, streams=2, device="cpu") for _ in "ab")
    for t in range(27):
        x, y = a.step_pcm(audio[t]), b.step_pcm(audio[t].astype(np.float32))
    assert x["payloads"] == y["payloads"] and a.stats == b.stats
    with pytest.raises(ValueError):
        a.step_pcm(audio[0][:1])


def test_the_cell_through_the_harness():
    """The cell at a tiny size and under the concealment cells' tiny
    overrides: correct, every check exact on the CPU, one native call a
    tick and no payload coded a stream at a time."""
    for over in (dict(streams=4, audio_ticks=30, check_ticks=2,
                      payload_check_streams=3),
                 TINY["plc-q8-256-loss10"]):
        res = cpu_run(CELL, over, seconds=0.5)
        assert res["correct"], res["checks"]
        assert all(v["value"] == 0.0 for v in res["checks"].values()), res["checks"]
        assert {"audio_s_per_s", "tick_ms_p95", "setup_s"} <= set(res["metrics"])
        assert res["attempted"] >= over["streams"]


def test_counters_a_tick():
    cell, run = H.build(CELL, 2 ** 31 + 5, torch.device("cpu"), bench(),
                        traffic_overrides=dict(streams=3, audio_ticks=30))
    run.setup()
    before = collections.Counter(run.counters())
    run.step(run.inputs(run.next_tick))
    d = collections.Counter(run.counters())
    d.subtract(before)
    assert d["native_calls"] == 1 and d["python_payloads"] == 0
    assert d["payloads"] == 3 and d["latents"] == 3 * 26 and d["bytes"] > 3 * 15
    run.free()


def test_bf16_control_and_state_kept_fault_fail():
    cell, run = H.build(CELL, 2 ** 31 + 3, torch.device("cpu"), bench(),
                        traffic_overrides=dict(TINY["plc-q8-256-loss10"]))
    limits = run.traffic["limits"]
    numbers = run.control(2)
    assert numbers["latent_gap"] > limits["latent_gap"], numbers
    res = cpu_run(CELL, dict(TINY["plc-q8-256-loss10"]), plant=FT.state_unchanged,
                  seconds=0.5)
    assert not res["correct"] and res["checks"]["state_apart"]["value"] > 0.5


REFERENCE_ALONE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.dred_rdovae_256_80, benchmark.yardstick.work_dred
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"lpcnet_torch", "lpcnet_tpu", "jax"}})) or "none")
"""


def test_the_reference_imports_nothing_of_the_port():
    out = subprocess.run([sys.executable, "-c", REFERENCE_ALONE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "none"
    for path in [ROOT / "benchmark" / "reference" / "dred_rdovae_256_80.py",
                 *(ROOT / "benchmark" / "reference" / "frozen" / "dred").rglob("*.py"),
                 ROOT / "benchmark" / "reference" / "frozen" / "models" / "rdovae.py"]:
        text = path.read_text()
        for name in ("lpcnet_torch", "lpcnet_tpu", "jax"):
            assert f"import {name}" not in text and f"from {name}" not in text


def test_dred_work_counts_by_hand():
    """`yardstick/work_dred.py` against a count by hand at the
    configuration's widths: 2,372,608 MACs an encoder step, and a tick at
    1024 streams ~0.079 ms at float32's peak."""
    from benchmark.yardstick import work_dred as WD
    from benchmark.yardstick.peaks import PEAK
    enc = (40 * 256 + 3 * 3 * 256 * 512 + 4 * 256 * 256 + 4 * 2048 * 80
           + 2048 * 128 + 128 * 24)
    assert WD.encoder_dframe_macs(CFG) == enc == 2372608
    frame = WD.feature_frame_flops()
    macs = (161 * 18 + 18 * 18 + 18 * 18 + 18 * 161 + 16 * 16 + 160 * 17
            + 4 * 256 * 80 + 4 * 7 * 256)
    ffts = 2 * 2.5 * 320 * np.log2(320)
    assert frame == pytest.approx(2 * macs + ffts + 320 + 3 * 161, rel=1e-12)
    tick = WD.tick_seconds(CFG, 1024)
    assert tick == pytest.approx(1024 * (2 * frame + 2 * enc) / PEAK["f32"], rel=1e-12)
    assert tick == pytest.approx(7.9e-5, rel=0.01)
