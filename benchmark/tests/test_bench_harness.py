"""The harness on the CPU: traffic generators, the frozen roofline and work
arithmetic against hand counts, the data-driven lookup with a dummy mix and
a dummy metric, and the JAX-free import of every cell."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import generate as G
from benchmark import harness as H
from benchmark.reference.frozen.codec.packet import FIELDS, unpack_fields
from benchmark.yardstick import bounds, work
from benchmark.yardstick.peaks import PEAK

from .conftest import ROOT, load

LARGE_SEED = 2 ** 31 + 99


# ---- traffic --------------------------------------------------------------

def test_sub_seed_takes_any_whole_number():
    seeds = {G.sub_seed(s, 1) for s in (0, 1, -5, 2 ** 31 + 1, 2 ** 40)}
    assert len(seeds) == 5
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert G.sub_seed(7, 1) == G.sub_seed(7, 1) != G.sub_seed(7, 2)


def test_packets_deterministic_and_every_field_in_range():
    a = G.packets(40, 64, LARGE_SEED)
    assert a.shape == (40, 64, 8) and a.dtype == np.uint8
    assert np.array_equal(a, G.packets(40, 64, LARGE_SEED))
    assert not np.array_equal(a, G.packets(40, 64, LARGE_SEED + 1))
    fields = unpack_fields(a)
    for name, bits in FIELDS:
        v = fields[name]
        assert v.min() >= 0 and v.max() < 1 << bits
        # uniform over the whole range: both ends' quarters are hit
        assert v.min() < (1 << bits) // 4 and v.max() >= 3 * (1 << bits) // 4


@pytest.mark.parametrize("mix", ["plc-256-loss10", "plc-256-clean"])
def test_gilbert_loss_rate_burst_and_packets(mix):
    spec = load("traffic", mix)["loss"]
    ticks, streams = 8000, 256
    loss = G.GilbertLoss(streams, spec, LARGE_SEED)
    lost = np.stack([loss.lost(i) for i in range(ticks)])
    again = G.GilbertLoss(streams, spec, LARGE_SEED)
    assert np.array_equal(lost, np.stack([again.lost(i) for i in range(ticks)]))
    # each packet's flag held for its ticks; the first packets received
    assert np.array_equal(lost[0::2], lost[1::2])
    assert not lost[:2 * spec["first_packets_received"]].any()
    pk = lost[0::2]
    if spec["mean_loss"] == 0:
        assert not pk.any()
        return
    assert abs(pk.mean() - spec["mean_loss"]) < 0.01
    # mean burst length in packets: lost packets over the bursts' starts
    starts = (pk[1:] & ~pk[:-1]).sum()
    assert abs(pk[1:].sum() / starts - spec["mean_burst_packets"]) < 0.1


def test_speech_deterministic_and_integer_valued():
    spec = load("traffic", "plc-256-loss10")["speech"]
    make = lambda s: G.speech(4, 3200, spec, G.device_generator(s, "cpu"), "cpu")
    a = make(11)
    assert torch.equal(a, make(11)) and not torch.equal(a, make(12))
    assert torch.equal(a, torch.round(a)) and a.abs().max() < 32768


def test_train_batches_shapes_ranges_and_determinism():
    t = dict(load("traffic", "train-b128-t2400"), batch=3, chunk_frames=2,
             batches=2)
    c = load("configs", "lpcnet-384-16")
    a = G.train_batches(t, c, LARGE_SEED, "cpu")
    b = G.train_batches(t, c, LARGE_SEED, "cpu")
    assert len(a) == 2
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    x = a[0]
    assert x["sig_in"].shape == x["sig_out"].shape == (3, 320)
    assert torch.equal(x["sig_in"][:, 1:], x["sig_out"][:, :-1])
    assert x["features"].shape == (3, 6, 20) and x["lpc"].shape == (3, 2, 16)
    r = t["ranges"]
    f = x["features"]
    assert r["c0"][0] <= f[..., 0].min() and f[..., 0].max() <= r["c0"][1]
    assert r["pitch"][0] <= f[..., 18].min() and f[..., 18].max() <= r["pitch"][1]
    assert x["periods"].min() >= 32 and x["periods"].max() <= 255
    assert torch.isfinite(x["lpc"]).all()
    assert not torch.equal(a[0]["sig_in"], a[1]["sig_in"])


# ---- the frozen arithmetic ------------------------------------------------

def test_k1_bound_by_hand():
    # 2 x (384*1152 + 384*48 + 16*48) int8 MACs and 2 x 16*512 float32 MACs
    # per step, 1024 x 160 steps; operations bound
    steps = 1024 * 160
    hand = 1e3 * (2 * 461568 * steps / 1979e12 + 2 * 8192 * steps / 67e12)
    ms, kind = bounds.k1_bound_ms(384, 16, "int8", 1024, 160)
    assert kind == "operations" and ms == pytest.approx(hand, rel=1e-12)
    assert ms == pytest.approx(0.1165, abs=2e-4)        # chip_smoke.py's figure


def test_k5_bound_by_hand():
    # bytes bound at both widths: forward reads gate_in and h0 and Wr
    # (bf16), writes hs and hT; backward reads and writes eight rows' worth
    rows, n = 128 * 2400, 384
    fwd = 4 * rows * 4 * n + 2 * 3 * n * n + 4 * (3 * n + 2 * 128 * n)
    bwd = (4 * rows * 8 * n + 2 * 2 * 3 * n * n
           + 4 * (3 * n * n + 3 * n + 3 * 128 * n))
    ms, kind = bounds.k5_bound_ms(n, 128, 2400, False)
    assert kind == "bytes" and ms == pytest.approx(1e3 * fwd / 3.35e12, rel=1e-12)
    assert ms == pytest.approx(0.5638, abs=1e-4)        # chip_smoke.py's figure
    ms, kind = bounds.k5_bound_ms(n, 128, 2400, True)
    assert kind == "bytes" and ms == pytest.approx(1e3 * bwd / 3.35e12, rel=1e-12)
    assert ms == pytest.approx(1.1281, abs=1e-4)
    # the operations stay under the bytes: 2 x rows x 3n^2 at the bf16 peak
    assert 2 * rows * 3 * n * n / 989e12 < fwd / 3.35e12
    assert bounds.k5_bound_ms(16, 128, 2400, False)[0] == pytest.approx(
        0.0235, abs=1e-4)


def test_work_counts_by_hand():
    c = load("configs", "lpcnet-384-16")
    p = load("configs", "lpcnet-plc-256")
    frame = 3 * 84 * 128 + 3 * 128 * 128 + 2 * 128 * 128 + 128 * 1152 + 128 * 48
    assert work.frame_net_macs(c) == frame == 267776
    assert work.plc_net_macs(p) == 700544
    step = 2 * 461568 / PEAK["int8"] + 2 * (8192 + 1152) / PEAK["f32"]
    assert work.sample_step_seconds(c, "int8") == pytest.approx(step, rel=1e-12)
    tick = 4 * 1024 * (2 * frame / PEAK["f32"] + 160 * step)
    assert work.decode_tick_seconds(c, "int8", 1024) == pytest.approx(tick, rel=1e-12)
    assert tick == pytest.approx(5.2e-4, rel=0.01)
    plc = work.plc_window_seconds(c, p, "int8", 256, 10, 7)
    hand = 10 * 256 * 2 * 700544 / PEAK["f32"] + 7 * (2 * frame / PEAK["f32"] + 160 * step)
    assert plc == pytest.approx(hand, rel=1e-12)
    # training: ~2 TFLOP of bf16 GRU products a step at batch 128, T=2400
    rows = 128 * 2400
    bf16 = 512 * 1152 + 384 * 1152 + 512 * 48 + 16 * 48
    hand = 3 * (2 * rows * bf16 / PEAK["bf16"] + 2 * rows * 8192 / PEAK["f32"]
                + 2 * 128 * 15 * (3 * 84 * 128 + 3 * 128 * 128 + 2 * 128 * 128)
                / PEAK["f32"])
    assert work.train_step_seconds(c, 128, 15) == pytest.approx(hand, rel=1e-12)
    assert 3 * 2 * rows * bf16 == pytest.approx(1.95e12, rel=0.01)


def test_shares_never_pass_100_by_construction():
    """The least times are below the kernels' measured times in every
    record: K1 q8 4.03 ms, K5 ~31 ms a step (PERF.md)."""
    assert bounds.k1_bound_ms(384, 16, "int8", 1024, 160)[0] < 4.03
    total = sum(bounds.k5_bound_ms(n, 128, 2400, b)[0]
                for n in (384, 16) for b in (False, True))
    assert total < 31.0


# ---- the data-driven lookup -----------------------------------------------

def test_a_new_mix_and_metric_are_files_and_entries_only(tmp_path):
    """A copy of the benchmark's files with a dummy mix and a dummy metric
    added as new files and entries: the harness finds and runs them, and
    every file it already had is byte for byte the same."""
    import shutil
    base = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy-cell", "config": "lpcnet-384-16",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy.metric", "unit": "ticks",
                               "better": "higher", "source": "host_clock",
                               "layer": "runtime.serving",
                               "moves": "audio_s_per_s",
                               "workloads": ["dummy-cell"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("audio_s_per_s", "tick_ms_p95"):
            m["workloads"].append("dummy-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = dict(load("traffic", "decode-1024"), streams=2, packet_ticks=4,
               warmup_ticks=1, check_ticks=1)
    (base / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (base / "metrics" / "dummy.metric.py").write_text(
        "def read(ctx):\n    return float(ctx.facts['ticks'])\n")
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()
              and p.name not in ("dummy-mix.json", "dummy.metric.py")}
    import time
    from .conftest import served_form
    with served_form():
        res = H.run_cell("dummy-cell", 5, 0.5, False, torch.device("cpu"),
                         time.perf_counter(), base=base)
    assert res["correct"] and res["attempted"] >= 2
    assert set(res["metrics"]) == {"audio_s_per_s", "tick_ms_p95", "setup_s"}
    assert [m["name"] for m in H.cell_metrics(bench, "dummy-cell", "per_layer")] == [
        "dummy.metric"]
    reader = H.metric_reader("dummy.metric", base)
    import types
    assert reader(types.SimpleNamespace(facts={"ticks": 3})) == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_named_file_exists():
    from .conftest import bench as with_plc
    bench = H.load_benchmark()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert H.load_json("configs", c["name"])["name"] == c["name"]
    for w in with_plc()["workloads"]:
        t = H.load_json("traffic", w["traffic"])
        H.runner_module(t)
        H.reference_module(H.load_json("configs", w["config"]))
    for m in bench["per_layer"]:
        assert callable(H.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in
                                  H.cell_metrics(bench, w, "end_to_end")]


# ---- no JAX ---------------------------------------------------------------

JAX_FREE = """
import sys, time, torch
sys.path.insert(0, {root!r})
from benchmark import harness as H
from benchmark.tests.conftest import TINY, bench
b = bench()
for w in b["workloads"]:
    over = TINY.get(w["name"], TINY["plc-q8-256-loss10"])
    cell, run = H.build(w["name"], 3, torch.device("cpu"), b, traffic_overrides=over)
    run.setup()
print(",".join(H.forbidden_modules()) or "none")
"""


def test_no_cell_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", JAX_FREE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lpcnet_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like.sub", sys)
    assert H.forbidden_modules() == [] or "lpcnet_tpu" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in H.forbidden_modules()


REFERENCE_ALONE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.lpcnet_384_16, benchmark.reference.lpcnet_plc_256
import benchmark.generate, benchmark.weights, benchmark.yardstick.work
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}}
                      & {{"lpcnet_torch", "lpcnet_tpu", "jax"}})) or "none")
"""


def test_the_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c",
                          REFERENCE_ALONE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "none"
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        text = path.read_text()
        assert "import lpcnet_torch" not in text and "from lpcnet_torch" not in text


def test_result_keys_and_checks_last():
    from .conftest import cpu_run, TINY
    res = cpu_run("decode-q8-1024", TINY["decode-q8-1024"])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert all(math.isfinite(v["value"]) for v in res["metrics"].values())
