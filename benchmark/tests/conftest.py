"""Shared fixtures of the benchmark's tests. Tests marked `cuda` decide
inside the `card` fixture whether a GPU is present, never at import."""

import contextlib
import json
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the GPU machine)")
    return torch.device("cuda", 0)


def load(kind: str, name: str) -> dict:
    with open(ROOT / "benchmark" / kind / f"{name}.json") as f:
        return json.load(f)


@contextlib.contextmanager
def served_form():
    """The pools on the CPU in their served arithmetic: the sample-loop
    kernels' plain versions (`use_kernel=True`), which compute what the
    kernels compute on the card (the int8 embedding of the q8 form, the
    concealment step's kernel sections), in place of the plain model."""
    from lpcnet_torch.runtime import serving as S
    dec, plc = S.LPCNetDecoder, S.BatchedPLC

    class Decoder(dec):
        @classmethod
        def from_fused(cls, *a, **k):
            return dec.from_fused.__func__(cls, *a, **dict(k, use_kernel=True))

    def batched(*a, **k):
        return plc(*a, **dict(k, use_kernel=True))

    S.LPCNetDecoder, S.BatchedPLC = Decoder, batched
    try:
        yield
    finally:
        S.LPCNetDecoder, S.BatchedPLC = dec, plc


# the concealment cells, whose files are kept but whose entries are not in
# BENCHMARK.json yet (their host-clock spread is wider than a bound may be)
PLC_CELLS = [
    {"name": "plc-q8-256-loss10", "config": "lpcnet-plc-256",
     "traffic": "plc-256-loss10", "chips": 1, "why": "concealment, 10 % loss"},
    {"name": "plc-q8-256-clean", "config": "lpcnet-plc-256",
     "traffic": "plc-256-clean", "chips": 1, "why": "concealment, no loss"}]


def bench() -> dict:
    """BENCHMARK.json with the concealment cells added where it lacks them."""
    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    names = {w["name"] for w in b["workloads"]}
    b["workloads"] += [w for w in PLC_CELLS if w["name"] not in names]
    return b


def cpu_run(workload, overrides, plant=None, seconds=1.5, seed=2 ** 31 + 7):
    """One cell on the CPU at a tiny size, through the harness, the program
    in its served arithmetic."""
    from benchmark import harness as H
    with served_form():
        return H.run_cell(workload, seed, seconds, False, torch.device("cpu"),
                          time.perf_counter(), bench=bench(),
                          traffic_overrides=overrides, plant=plant)


TINY = {
    "decode-q8-1024": {"streams": 16, "packet_ticks": 6, "check_ticks": 2,
                       "warmup_ticks": 3},
    "plc-q8-256-loss10": {"streams": 3, "audio_ticks": 20, "warmup_ticks": 2,
                          "check_ticks": 2,
                          "loss": {"model": "gilbert", "mean_loss": 0.4,
                                   "mean_burst_packets": 2.0, "packet_ticks": 2,
                                   "first_packets_received": 1}},
    "train-b128-t2400": {"batch": 2, "chunk_frames": 2, "batches": 4},
}
