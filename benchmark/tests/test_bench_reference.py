"""Each reference against the port's plain path at a tiny size on the CPU,
through the harness (the program on the CPU runs its plain paths), and
each control (the reference in the lower precision in the program's place)
failing at that size."""

import pytest
import torch

from benchmark import harness as H

from .conftest import TINY, bench, cpu_run


@pytest.mark.parametrize("workload", ["decode-q8-1024", "plc-q8-256-loss10",
                                      "train-b128-t2400"])
def test_reference_agrees_with_the_plain_program(workload):
    res = cpu_run(workload, TINY[workload])
    assert res["correct"], res["checks"]
    c = {k: v["value"] for k, v in res["checks"].items()}
    # the same arithmetic in another order: audio passed through agrees
    # exactly, the states and losses to float32 rounding; sampled audio
    # may part where the two round apart near a threshold
    assert c.get("received_mismatch", 0.0) == 0.0, c
    assert c.get("state_apart", 0.0) == 0.0 and c.get("loss_gap", 0.0) < 1e-5, c
    assert res["attempted"] > 0


@pytest.mark.parametrize("workload", ["decode-q8-1024", "plc-q8-256-loss10",
                                      "plc-q8-256-clean"])
def test_serving_control_fails(workload):
    tiny = TINY.get(workload, dict(TINY["plc-q8-256-loss10"],
                                   loss=H.load_json("traffic", "plc-256-clean")["loss"]))
    cell, drv = H.build(workload, 2 ** 31 + 3, torch.device("cpu"), bench(),
                        traffic_overrides=dict(tiny, warmup_ticks=3))
    numbers = drv.control(2)
    limits = drv.traffic["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def test_training_control_reads_above_the_sound_runs():
    cell, drv = H.build("train-b128-t2400", 2 ** 31 + 3, torch.device("cpu"),
                        traffic_overrides=TINY["train-b128-t2400"])
    numbers = drv.control("fp8")
    assert numbers["loss_gap"] > 0 and numbers["grad_gap"] > 1e-3, numbers
