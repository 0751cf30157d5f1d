"""The port's host PLC (`plc.core`, `plc.plc`, `plc.driver`, `cli plc`) on
the CPU: against the JAX package's host PLC frame by frame in every mode,
then the cases of test_plc.py and test_plc_fec.py, and the file driver and
the command line."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.plc import plc as JP

from lpcnet_torch import api, cli
from lpcnet_torch.codec import features as F
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.plc import plc as P
from lpcnet_torch.plc.driver import (make_plc, run_plc_fec_stream,
                                     run_plc_file, run_plc_stream)
from lpcnet_torch.weights.convert import host_plc_state_to_torch, params_to_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32)
MODES = {"causal": 0, "causal_dc": 4, "codec": 2, "noncausal": 1,
         "noncausal_dc": 5}
LOST = [0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 0]


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    return t.numpy()


def _speech(frames, dc=0.0):
    pcm = np.load(ROOT / "tests" / "fixtures" / "codec.npz")["pcm"].astype(np.float32)
    return np.tile(pcm, frames * 160 // len(pcm) + 1)[:frames * 160] + dc


@pytest.mark.parametrize("name", list(MODES))
def test_each_frame_from_the_jax_state_matches_jax(name):
    """The port's PLC stepping each frame from the JAX host PLC's state
    (`weights.convert.host_plc_state_to_torch`), 14 frames with a loss, a
    recovery and a burst: the host's integer state exact; the features
    within 2e-4 and the conditioning within 1e-4 (Burg, see
    test_torch_plc_batched.py); audio within 1 LSB at every frame (2 with
    the DC filter) and off by more than 1e-3 on under 2 % of the run's
    samples (5 % with it), the bars of test_plc_batched.py:76 and :233. A
    recovery frame can round several samples apart where one of its
    sampled samples does: the crossfade, and with the DC filter the
    tracker's rounded offset, carry that sample on."""
    flags = MODES[name]
    la = 0 if flags & 1 else 2
    jcfg, tcfg = JM.LPCNetConfig(**SMALL, lookahead=la), M.LPCNetConfig(**SMALL, lookahead=la)
    p = _numpy_tree(M.init_params(tcfg, seed=0))
    pp = _numpy_tree(PM.init_params(seed=1))
    jp = JP.PLC(JM.fuse_inference_params(jax.tree.map(jnp.asarray, p), jcfg), jcfg,
                jax.tree.map(jnp.asarray, pp), options=flags, batch=1)
    tp = P.PLC(M.fuse_inference_params(params_to_torch(p), tcfg), tcfg,
               params_to_torch(pp), options=flags, batch=1, device="cpu")
    assert (tp.non_causal, tp.enable_blending, tp.remove_dc) == (
        jp.non_causal, jp.enable_blending, jp.remove_dc)
    dc = bool(flags & 4)
    pcm = _speech(14, 300.0 if dc else 0.0).reshape(14, 1, 160)
    off = []
    for k in range(14):
        host_plc_state_to_torch(jp, tp)
        if LOST[k]:
            jo, to = jp.conceal(), tp.conceal()
        else:
            jo, to = jp.update(pcm[k]), tp.update(pcm[k])
        for f in ("pcm_fill", "skip_analysis", "blend", "loss_count",
                  "queued_update", "fec_read_pos"):
            assert getattr(tp, f) == getattr(jp, f), (k, f)
        assert len(tp.core.feature_buffer) == len(jp.core.feature_buffer)
        np.testing.assert_allclose(tp.features, jp.features, atol=2e-4)
        np.testing.assert_allclose(tp.core.cond_a.numpy(), np.asarray(jp.core.cond_a),
                                   atol=1e-4)
        assert to.shape == (1, 160) and to.dtype == np.float32
        d = np.abs(to - jo)
        assert d.max() <= (2.0 if dc else 1.0), (k, d.max())
        off.append((d > 1e-3).mean())
    assert np.mean(off) < (0.05 if dc else 0.02), off
    assert tp.loss_count == 0 and max(LOST) == 1


def synth_tone(n, f=200.0, amp=3000.0):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / 16000.0)).astype(np.int16)


@pytest.mark.parametrize("options", ["causal", "causal_dc"])
def test_plc_causal_runs(options):
    out = run_plc_stream(make_plc(options, device="cpu"), synth_tone(160 * 12),
                         np.array([0, 0, 1, 0, 0, 1, 1, 0], np.int32))
    assert out.shape == (160 * 12,)
    assert np.isfinite(out).all() and np.max(np.abs(out)) <= 32768


@pytest.mark.parametrize("options", ["noncausal", "noncausal_dc"])
def test_plc_noncausal_runs(options):
    plc = make_plc(options, device="cpu")
    assert plc.cfg.lookahead == 0 and plc.non_causal
    out = run_plc_stream(plc, synth_tone(160 * 8), np.array([0, 1, 0, 1], np.int32))
    assert out.shape == (160 * 8,)
    assert np.isfinite(out).all()


def test_plc_no_loss_passthrough():
    """With no loss the causal PLC without the DC filter hands its input
    back, and the non-causal one too, 80 samples late."""
    pcm = synth_tone(160 * 8)
    out = run_plc_stream(make_plc("causal", device="cpu"), pcm, np.zeros(4, np.int32))
    np.testing.assert_allclose(out, pcm.astype(np.float32), atol=1.0)
    plc = make_plc("noncausal", device="cpu")
    outs = [plc.update(pcm[None, k * 160:(k + 1) * 160])[0] for k in range(8)]
    assert np.array_equal(np.concatenate(outs)[80:], pcm[:-80].astype(np.float32))


def test_plc_fec_queue():
    plc = make_plc("causal", device="cpu")
    feats = np.zeros(20, np.float32)
    plc.fec_add(feats)
    plc.fec_add(None)         # a skip marker
    plc.fec_add(feats + 1)
    assert len(plc.fec) == 2 and plc.fec_skip == 1
    plc.fec_clear()
    assert len(plc.fec) == 0 and plc.fec_skip == 0


def _small_plc():
    cfg = M.LPCNetConfig(**SMALL)
    return P.PLC(M.fuse_inference_params(M.init_params(cfg, seed=0), cfg), cfg,
                 PM.init_params(seed=1), options=P.LPCNET_PLC_CAUSAL, batch=1,
                 device="cpu")


def _true_features(pcm):
    """Per-frame encoder features, as ideal FEC payloads."""
    st = F.init_encoder_state(1)
    rows = []
    for k in range(len(pcm) // 160):
        st, f = F.compute_single_frame_features(
            st, torch.from_numpy(np.asarray(pcm[None, k * 160:(k + 1) * 160],
                                            np.float32)))
        rows.append(f.numpy()[0])
    return np.stack(rows)


def test_fec_queue_is_consumed_and_resets_loss_count():
    """test_plc_fec.py:49: with FEC rows for every lost frame the loss
    count never latches, and the audio differs from concealment on
    predictions."""
    pcm = _speech(10)
    feats = _true_features(pcm)
    losses = np.array([0, 0, 1, 1, 0])
    plc = _small_plc()
    out = run_plc_fec_stream(plc, pcm, losses,
                             [feats[2 * p:2 * p + 2, :20] for p in range(5)])
    assert out.shape == (10 * 160,) and plc.loss_count == 0
    plc2 = _small_plc()
    out2 = run_plc_stream(plc2, pcm, losses)
    assert plc2.loss_count == 0 or not np.allclose(out, out2)
    assert np.isfinite(out).all() and np.isfinite(out2).all()


def test_fec_features_override_prediction():
    """test_plc_fec.py:72: during a loss the queued features take the
    prediction's place; the first conceal's drain consumes several entries
    (the pipeline runs features_delay + TO ahead of wall clock)."""
    pcm = _speech(12)
    feats = _true_features(pcm)
    plc = _small_plc()
    for k in range(12):
        plc.fec_add(feats[k][None, :20])
    for k in range(6):
        plc.update(pcm[None, k * 160:(k + 1) * 160])
    assert plc.fec_read_pos == 6          # one entry a good frame
    plc.conceal()
    assert plc.loss_count == 0
    consumed = plc.fec_read_pos
    assert consumed > 6
    np.testing.assert_allclose(plc.features[0], feats[consumed - 1, :20], atol=1e-5)
    plc.conceal()
    assert plc.loss_count == 0 and plc.fec_read_pos == consumed + 1
    np.testing.assert_allclose(plc.features[0], feats[consumed, :20], atol=1e-5)


def test_run_plc_file_and_cli(tmp_path, capsys, monkeypatch):
    """`run_plc_file` and `cli plc` on a temporary file: int16 of the
    input's length, the loss pattern read from a file or drawn at a
    percentage, clean packets handed back (the non-causal modes 80 samples
    late), CUDA by default."""
    pcm = synth_tone(160 * 10)
    src, dst, pat = tmp_path / "in.pcm", tmp_path / "out.pcm", tmp_path / "loss.txt"
    pcm.tofile(src)
    np.savetxt(pat, [0, 0, 1, 0, 0], fmt="%d")
    run_plc_file("causal", str(pat), str(src), str(dst), device="cpu")
    out = np.fromfile(dst, np.int16)
    assert out.shape == pcm.shape
    assert np.array_equal(out[:640], pcm[:640])
    assert "5 packets, 1 lost" in capsys.readouterr().out
    cli.main(["plc", "noncausal_dc", "0", str(src), str(dst), "--device", "cpu"])
    out = np.fromfile(dst, np.int16)
    assert out.shape == pcm.shape
    assert np.abs(out[:-80].astype(int) - pcm[:-80]).max() <= 1
    cli.main(["plc", "causal", "50", str(src), str(dst), "--device", "cpu",
              "--model", "random"])
    assert np.fromfile(dst, np.int16).shape == pcm.shape
    with pytest.raises(SystemExit):
        cli.main(["plc", "causal", str(src), str(dst)])
    with pytest.raises(SystemExit, match="unknown plc mode"):
        cli.main(["plc", "sideways", "0", str(src), str(dst), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["plc", "causal", "0", str(src), str(dst)])
    with pytest.raises(RuntimeError, match="CUDA"):
        P.PLC(*api.load_model(None, device="cpu"), PM.init_params(seed=0))
