"""The port's spans (`lpcnet_torch.utils.profiling.span`) on the CPU: off
without a profiler; under one, the decode tick's and the training step's
spans nested under one root each, inside their parents' intervals and in
the profiler's own events, with outputs, state and parameters equal to an
untraced run's; the benchmark's reduction of them
(`benchmark/yardstick/spans.py`) and the per-layer metrics that read it;
and the operator's Chrome trace."""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness as H
from benchmark.yardstick import spans as YS
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.runtime.serving import StreamPool
from lpcnet_torch.train import train_lpcnet as T
from lpcnet_torch.utils import profiling as PF
from lpcnet_torch.weights.convert import params_to_numpy

torch.set_num_threads(1)

TINY = dict(rnn_units1=32, rnn_units2=16, cond_size=16, pitch_embed_dim=8)
STREAMS = ("a", "b", "c")
FRAME_SPANS = ("lpcnet.model.frame_network", "lpcnet.kernels.sample_loop",
               "lpcnet.codec.warmup_mask")


@pytest.fixture(autouse=True)
def empty_buffer():
    PF.take_spans()
    yield
    PF.take_spans()


def _pool():
    cfg = M.LPCNetConfig(**TINY)
    fused = M.fuse_inference_params(M.init_params(cfg, 3), cfg)
    pool = StreamPool(fused, cfg, capacity=4, device="cpu")
    for sid in STREAMS:
        pool.attach(sid)
    return pool


def _packets(tick):
    rs = np.random.RandomState(100 + tick)
    return {sid: rs.randint(0, 256, 8).astype(np.uint8) for sid in STREAMS}


def _traced(fn):
    """fn() under the profiler -> (its result, the names of the profiler's
    events, the spans). The names come from the raw events: building
    `prof.events()` for a plain-model tick takes half a minute on a CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return out, names, PF.take_spans()


def _by_name(records, name):
    return [r for r in records if r.name == name]


def _assert_nested(records):
    """One root; every child inside its parent's interval, with its
    root's id."""
    roots = [r for r in records if r.parent is None]
    assert len(roots) == 1
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert r.root == p.root == roots[0].root
    return roots[0]


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = PF.span("lpcnet.x"), PF.span("lpcnet.y", device=True)
    assert a is b
    with a:
        with PF.span("lpcnet.z"):
            pass
    _pool().step_packets(_packets(0))
    assert PF.take_spans() == []


@pytest.fixture(scope="module")
def ticks():
    """One packet tick of two pools from the same weights: untraced, and
    traced (the first tick: frames in warm-up and after it)."""
    PF.take_spans()
    plain, traced = _pool(), _pool()
    want = plain.step_packets(_packets(0))
    got, names, records = _traced(lambda: traced.step_packets(_packets(0)))
    return plain, traced, want, got, names, records


def test_decode_tick_spans_nest_and_reach_the_profiler(ticks):
    *_, names, records = ticks
    root = _assert_nested(records)
    assert root.name == "lpcnet.serving.step_packets"
    counts = {n: len(_by_name(records, n)) for n in {r.name for r in records}}
    assert counts == {"lpcnet.serving.step_packets": 1, "lpcnet.codec.decode": 1,
                      "lpcnet.codec.unpack": 1, "lpcnet.codec.features": 1,
                      "lpcnet.codec.readback": 1, **{n: 4 for n in FRAME_SPANS}}
    decode = records.index(_by_name(records, "lpcnet.codec.decode")[0])
    assert records[decode].parent == 0
    assert all(r.parent == decode for r in records[decode + 1:])
    assert all(r.device_ms is None for r in records)
    assert set(counts) <= names


def test_traced_decode_tick_equals_untraced(ticks):
    plain, traced, want, got, _, _ = ticks
    assert got.keys() == want.keys()
    for sid in STREAMS:
        np.testing.assert_array_equal(got[sid], want[sid])
    assert any(w.any() for w in want.values())
    a, b = plain.dec, traced.dec
    for x, y in zip(list(a.frame_state) + list(a.sample_state) + [a.vq_mem],
                    list(b.frame_state) + list(b.sample_state) + [b.vq_mem]):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(u, v)


def test_feature_tick_has_its_own_root():
    pool = _pool()
    feats = {sid: np.full(20, 0.1 * k, np.float32) for k, sid in enumerate(STREAMS)}
    _, _, records = _traced(lambda: pool.step_features(feats))
    root = _assert_nested(records)
    assert root.name == "lpcnet.serving.step_features"
    assert sorted(r.name for r in records[1:]) == sorted(
        FRAME_SPANS + ("lpcnet.codec.readback",))


def _fake_batch(seed, b=2, frames=2):
    rs = np.random.RandomState(seed)
    sig = np.cumsum(rs.randn(b, frames * 160 + 1), axis=1).astype(np.float32) * 100
    return {"sig_in": sig[:, :-1].copy(), "sig_out": sig[:, 1:].copy(),
            "features": rs.randn(b, frames + 4, 20).astype(np.float32) * 0.3,
            "periods": rs.randint(33, 255, (b, frames + 4)).astype(np.int32),
            "lpc": (rs.randn(b, frames, 16) * 0.05).astype(np.float32)}


def _trainer():
    tc = T.TrainConfig(batch_size=2, chunk_frames=2, ema_decay=0.9)
    return T.Trainer(M.LPCNetConfig(**TINY), tc, seed=2, device="cpu")


def test_training_step_spans_and_equality():
    plain, traced = _trainer(), _trainer()
    for k in range(2):
        batch = _fake_batch(k)
        want = plain.train_step(batch, torch.Generator().manual_seed(k))
        got, names, records = _traced(
            lambda: traced.train_step(batch, torch.Generator().manual_seed(k)))
        root = _assert_nested(records)
        assert root.name == "lpcnet.train.step"
        assert [r.name for r in records[1:]] == [
            "lpcnet.train.forward", "lpcnet.train.backward", "lpcnet.train.update"]
        assert all(r.parent == 0 for r in records[1:])
        assert all(r.device_ms is None for r in records)
        assert {r.name for r in records} <= names
        assert torch.equal(got["loss"], want["loss"])
    pa, pb = params_to_numpy(plain.params), params_to_numpy(traced.params)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    pa, pb = params_to_numpy(plain.ema_params), params_to_numpy(traced.ema_params)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert plain.step == traced.step == 2


def test_take_inside_a_span_raises_and_a_cpu_device_times_the_host_only():
    with profile(activities=[ProfilerActivity.CPU]):
        with PF.span("lpcnet.outer", device=torch.device("cpu")):
            with pytest.raises(RuntimeError):
                PF.take_spans()
    (rec,) = PF.take_spans()
    assert rec.name == "lpcnet.outer" and rec.device_ms is None
    assert 0 < rec.start_ns <= rec.end_ns


def test_roots_past_the_cap_are_dropped_whole(monkeypatch):
    monkeypatch.setattr(PF, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with PF.span(f"lpcnet.root{k}"):
                with PF.span("lpcnet.child"):
                    with PF.span("lpcnet.grandchild"):
                        pass
    records = PF.take_spans()
    # the second root opened with 3 records kept: it and its spans are not
    assert [r.name for r in records] == ["lpcnet.root0", "lpcnet.child",
                                         "lpcnet.grandchild"]
    assert {"lpcnet.root1", "lpcnet.root2"} <= {e.name for e in prof.events()}


# ---- the benchmark's reduction and readers --------------------------------

def R(name, root, parent, start, end, device_ms=None):
    """A hand-built record, times in ms."""
    return types.SimpleNamespace(name=name, root=root, parent=parent,
                                 start_ns=int(start * 1e6), end_ns=int(end * 1e6),
                                 device_ms=device_ms)


def test_self_time_is_host_time_less_the_children_cover():
    records = [R("root", 0, None, 0, 10), R("a", 0, 0, 1, 3), R("b", 0, 0, 2, 5),
               R("c", 0, 2, 2.5, 3.0), R("root", 1, None, 20, 24),
               R("a", 1, 4, 21, 22)]
    m = YS.reduce(records)
    assert m.roots == 2
    # root 0: children a [1, 3] and b [2, 5] cover 4 of 10; root 1: 1 of 4
    assert m.self_ms["root"] == pytest.approx((6 + 3) / 2)
    assert m.host_ms["root"] == pytest.approx(7)
    assert m.self_ms["a"] == pytest.approx((2 + 1) / 2)
    assert m.self_ms["b"] == pytest.approx(2.5 / 2)
    assert m.self_ms["c"] == m.host_ms["c"] == pytest.approx(0.25)
    assert m.device_ms == {}
    assert m.sum_self("a", "c", "missing") == pytest.approx(1.75)
    assert m.sum_self("missing") is None
    assert YS.reduce([]) is None


def _decode_tick(root, t0):
    """A hand-built decode tick of 24 ms: serving self 2, decode self 3,
    unpack 1, features 1, four frames of network 1, loop 2 and mask 0.5,
    readback 3."""
    rs = [R("lpcnet.serving.step_packets", root, None, t0, t0 + 24),
          R("lpcnet.codec.decode", root, 0, t0 + 1, t0 + 23),
          R("lpcnet.codec.unpack", root, 1, t0 + 2, t0 + 3),
          R("lpcnet.codec.features", root, 1, t0 + 3, t0 + 4)]
    t = t0 + 4
    for _ in range(4):
        rs += [R("lpcnet.model.frame_network", root, 1, t, t + 1),
               R("lpcnet.kernels.sample_loop", root, 1, t + 1, t + 3),
               R("lpcnet.codec.warmup_mask", root, 1, t + 3, t + 3.5)]
        t += 3.5
    rs.append(R("lpcnet.codec.readback", root, 1, t + 1, t + 4))
    return rs


def _train_step(root, t0, dev):
    rs = [R("lpcnet.train.step", root, None, t0, t0 + 10)]
    for k, (name, ms) in enumerate(zip(("forward", "backward", "update"), dev)):
        rs.append(R(f"lpcnet.train.{name}", root, 0, t0 + k, t0 + k + 1, ms))
    return rs


def _offset(records, base):
    for r in records:
        if r.parent is not None:
            r.parent += base
    return records


HAND = _decode_tick(0, 0) + _offset(_decode_tick(1, 100), 17)
HAND_TRAIN = _train_step(5, 0, (20.0, 40.0, 3.0)) + _offset(
    _train_step(6, 50, (22.0, 42.0, 5.0)), 4)

READERS = [
    ("serving_host_ms.decode", HAND, 2.0),
    ("codec_host_ms.decode", HAND, 3.0 + 1 + 1 + 4 * 0.5),
    ("frame_net_host_ms.decode", HAND, 4.0),
    ("sample_loop_host_ms.decode", HAND, 8.0),
    ("readback_wait_ms.decode", HAND, 3.0),
    ("forward_device_ms.train", HAND_TRAIN, 21.0),
    ("backward_device_ms.train", HAND_TRAIN, 41.0),
    ("update_device_ms.train", HAND_TRAIN, 4.0),
]


@pytest.mark.parametrize("name,records,want", READERS, ids=[r[0] for r in READERS])
def test_reader_none_without_spans_and_its_value_with(monkeypatch, name, records, want):
    read = H.metric_reader(name)
    assert read(types.SimpleNamespace()) is None
    taken = []
    monkeypatch.setattr(PF, "take_spans", lambda: taken.append(1) or list(records))
    ctx = types.SimpleNamespace()
    assert read(ctx) == pytest.approx(want)
    assert read(ctx) == pytest.approx(want) and len(taken) == 1


def test_decode_readers_add_up_to_the_tick():
    ctx = types.SimpleNamespace(span_means=YS.reduce(HAND))
    total = sum(H.metric_reader(n)(ctx) for n, recs, _ in READERS if recs is HAND)
    assert total == pytest.approx(24.0)
    assert total == pytest.approx(ctx.span_means.host_ms["lpcnet.serving.step_packets"])


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(PF, "take_spans")
    ctx = types.SimpleNamespace()
    assert all(H.metric_reader(n)(ctx) is None for n, _, _ in READERS)


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    pool = _pool()
    with PF.trace(str(tmp_path / "t")):
        pool.step_packets(_packets(0))
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"lpcnet.serving.step_packets", "lpcnet.codec.decode",
            "lpcnet.model.frame_network"} <= names
