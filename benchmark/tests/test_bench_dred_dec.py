"""The cell dred-dec-1024 on the CPU at a tiny size, through the harness:
correct, every check exact; its bf16 control and its faults (the first
tick's payloads decoded every tick; a feature altered) not correct."""

import collections

import pytest
import torch

from benchmark import harness as H
from benchmark.runners import dred_decode as DD

from .conftest import TINY, bench, cpu_run

CELL = "dred-dec-1024"
SMALL = dict(streams=4, payload_ticks=3, check_ticks=2, check_streams=3)


@pytest.mark.parametrize("over", [SMALL, TINY["plc-q8-256-loss10"]],
                         ids=["small", "plc-tiny"])
def test_the_cell_through_the_harness(over):
    res = cpu_run(CELL, over, seconds=0.5)
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0.0 for v in res["checks"].values()), res["checks"]
    assert set(res["metrics"]) == {"audio_s_per_s", "tick_ms_p95", "setup_s"}
    assert res["attempted"] >= over["streams"]


def test_one_native_parse_a_tick_through_the_runner():
    cell, run = H.build(CELL, 2 ** 31 + 5, torch.device("cpu"), bench(),
                        traffic_overrides=SMALL)
    run.setup()
    before = collections.Counter(run.counters())
    run.step(run.inputs(run.next_tick))
    d = collections.Counter(run.counters())
    d.subtract(before)
    assert +d == {"native_parses": 1, "payloads_parsed": 4, "latents_decoded": 4 * 26}
    run.free()


def test_the_bf16_control_is_not_correct():
    cell, run = H.build(CELL, 2 ** 31 + 3, torch.device("cpu"), bench(),
                        traffic_overrides=SMALL)
    limits = run.traffic["limits"]
    numbers = run.control(2)
    assert numbers["feature_gap"] > limits["feature_gap"], numbers


@pytest.mark.parametrize("fault", sorted(DD.FAULTS))
def test_a_fault_is_not_correct(fault):
    res = cpu_run(CELL, SMALL, plant=DD.FAULTS[fault], seconds=0.5)
    assert not res["correct"], res["checks"]
