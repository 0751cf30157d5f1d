"""The port's quality proxies (`lpcnet_torch.utils.quality`) and metrics log
(`lpcnet_torch.utils.profiling`) against the JAX package's, on the CPU: the
three metrics on the same PCM, the properties of test_quality_metrics.py,
and the JSONL records."""

import json

import numpy as np
import pytest
import torch

from lpcnet_tpu.utils import profiling as JPF
from lpcnet_tpu.utils import quality as JQ

from lpcnet_torch.utils import profiling as PF
from lpcnet_torch.utils.quality import format_metrics, quality_metrics

torch.set_num_threads(1)


def _speechlike(n=16000 * 2, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    sig = np.zeros(n)
    for h in range(1, 8):
        sig += np.sin(2 * np.pi * np.cumsum(f0) / 16000 * h) / h
    sig += 0.05 * rng.randn(n)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t) ** 2
    return (sig * env * 8000).astype(np.float32)


@pytest.mark.parametrize("kind", ["noise", "tilt", "shift"])
def test_metrics_match_jax(kind):
    """Each metric within 1e-4 dB of JAX's on the same PCM."""
    x = _speechlike(seed=2)
    rng = np.random.RandomState(3)
    if kind == "noise":
        y = x + 0.1 * np.std(x) * rng.randn(len(x)).astype(np.float32)
    elif kind == "tilt":
        y = x.copy()
        y[1:] = x[1:] - 0.6 * x[:-1]
    else:
        y = np.roll(x, 7)[: len(x) - 100]
    got, want = quality_metrics(x, y), JQ.quality_metrics(x, y)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_identity_is_optimal():
    x = _speechlike()
    m = quality_metrics(x, x)
    assert m["band_lsd_db"] < 1e-4
    assert m["mcd_db"] < 1e-3
    assert m["fwsegsnr_db"] == 35.0  # the clamp's ceiling


def test_monotone_in_noise():
    x = _speechlike()
    rng = np.random.RandomState(1)
    noise = rng.randn(len(x)).astype(np.float32)
    prev = quality_metrics(x, x)
    for snr_amp in (0.01, 0.05, 0.2, 1.0):
        m = quality_metrics(x, x + snr_amp * np.std(x) * noise)
        assert m["band_lsd_db"] >= prev["band_lsd_db"]
        assert m["mcd_db"] >= prev["mcd_db"]
        assert m["fwsegsnr_db"] <= prev["fwsegsnr_db"]
        prev = m
    assert prev["band_lsd_db"] > 3.0
    assert prev["mcd_db"] > 4.0
    assert prev["fwsegsnr_db"] < 10.0


def test_spectral_tilt_registers():
    x = _speechlike()
    y = np.empty_like(x)
    y[0] = x[0]
    y[1:] = x[1:] - 0.6 * x[:-1]
    m = quality_metrics(x, y)
    assert m["mcd_db"] > 1.0
    assert m["band_lsd_db"] > 1.0


def test_format_metrics_mentions_all():
    s = format_metrics({"band_lsd_db": 1.0, "mcd_db": 2.0, "fwsegsnr_db": 3.0})
    assert "band-LSD" in s and "MCD" in s and "fwSegSNR" in s
    assert s == JQ.format_metrics({"band_lsd_db": 1.0, "mcd_db": 2.0,
                                   "fwsegsnr_db": 3.0})


def test_metrics_logger_records_match_jax(tmp_path):
    """The same calls give the same JSONL records as the JAX package's
    logger, apart from `ts`; log_async keeps tensors unfetched until
    flush_async."""
    import jax.numpy as jnp

    def drive(mod, scalar, path):
        lg = mod.MetricsLogger(str(path))
        lg.log(0, loss=scalar(1.5), note="a")
        lg.log_async(1, loss=scalar(0.25), epoch=0)
        lg.log_async(2, kind="val_raw", band_lsd_db=3.0)
        assert len(lg._pending) == 2
        lg.flush_async()
        lg.log_async(3, loss=scalar(0.125))
        lg.close()
        return [json.loads(line) for line in open(path)]

    got = drive(PF, lambda v: torch.tensor(v), tmp_path / "t" / "m.jsonl")
    want = drive(JPF, lambda v: jnp.float32(v), tmp_path / "j" / "m.jsonl")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert isinstance(g.pop("ts"), float)
        w.pop("ts")
        assert g == w

