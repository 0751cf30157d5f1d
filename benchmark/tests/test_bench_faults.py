"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU at a tiny size, once for each fault the cell can have."""

import pytest

from benchmark.faults import (answer_altered, half_batch, params_unchanged,
                             state_unchanged)

from .conftest import TINY, cpu_run


@pytest.mark.parametrize("workload", ["decode-q8-1024", "plc-q8-256-loss10"])
@pytest.mark.parametrize("fault", [state_unchanged, answer_altered])
def test_serving_fault_is_not_correct(workload, fault):
    res = cpu_run(workload, TINY[workload], plant=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [params_unchanged, half_batch])
def test_training_fault_is_not_correct(fault):
    res = cpu_run("train-b128-t2400", TINY["train-b128-t2400"], plant=fault)
    assert not res["correct"], res["checks"]
