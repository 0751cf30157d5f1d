"""The port's DRED drivers (`lpcnet_torch.dred.coder`), `.fec` files
(`dred.fec_file`) and the redundancy's way into the host PLC, on the CPU:
against the JAX package's drivers on the same weights and features, then
the cases of test_demo_dred.py and test_integration_dred_plc.py on the
port."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lpcnet_tpu.dred import coder as JC
from lpcnet_tpu.dred import fec_file as JF
from lpcnet_tpu.models import rdovae as JR

from lpcnet_torch import api
from lpcnet_torch.codec import features as F
from lpcnet_torch.dred import coder as C
from lpcnet_torch.dred import fec_file as FF
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.plc.driver import run_plc_fec_stream
from lpcnet_torch.plc.plc import LPCNET_PLC_CAUSAL, PLC
from lpcnet_torch.weights.convert import params_to_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(cond_size=32, cond_size2=32, latent_dim=20, state_dim=8,
             pvq_num_pulses=20)


@pytest.fixture(scope="module")
def small():
    """JAX RDO-VAE params at a small width with a seeded statistical table
    (so the symbols are not all zero), and the same weights on the port."""
    jcfg, cfg = JR.RDOVAEConfig(**SMALL), RV.RDOVAEConfig(**SMALL)
    jp = jax.tree.map(np.asarray, JR.init_params(jax.random.PRNGKey(0), jcfg))
    jp["statistical_model"]["quant_embedding"]["table"] = (0.5 * np.random.RandomState(
        2).randn(jcfg.quant_levels, 6 * jcfg.latent_dim)).astype(np.float32)
    return jcfg, cfg, jp, params_to_torch(jp)


def test_drivers_match_jax(small):
    """Batch 3, 24 frames of seeded features through both packages'
    DREDEncoder: every latent and init state within 1e-5, the payload's
    symbols and PVQ state equal, its bytes equal; decode_all and
    decode_payload within 1e-5 of JAX's."""
    jcfg, cfg, jp, tp = small
    jenc = JC.DREDEncoder(jp, jcfg, batch=3)
    enc = C.DREDEncoder(tp, cfg, batch=3, max_latents=10, device="cpu")
    rs = np.random.RandomState(5)
    for _ in range(24):
        f = (rs.randn(3, 36) * 0.5).astype(np.float32)
        jenc.add_feature_frame(f)
        enc.add_feature_frame(f)
    assert len(enc.z_window) == 10 and len(jenc.latents) == 12
    for got, want in ((enc.latents, jenc.latents[-10:]),
                      (enc.init_states, jenc.init_states[-10:])):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    out = enc.produce_payload(num_redundancy_frames=16, q0=3, q1=9)
    jout = jenc.produce_payload(num_redundancy_frames=16, q0=3, q1=9)
    assert out["zq"].shape == (3, 8, cfg.latent_dim)
    assert np.array_equal(out["zq"], jout["zq"])
    assert np.abs(out["zq"]).sum() > 0
    assert np.array_equal(out["q_ids"], jout["q_ids"])
    assert np.array_equal(out["state"], jout["state"])
    np.testing.assert_allclose(out["bits"], jout["bits"], rtol=1e-6)
    assert out["payloads"] == jout["payloads"]

    dec, jdec = C.DREDDecoder(tp, cfg, device="cpu"), JC.DREDDecoder(jp, jcfg)
    feats = dec.decode_all(out["zq"], out["q_ids"], out["state"])
    assert feats.shape == (3, 32, 20)
    np.testing.assert_allclose(
        feats, jdec.decode_all(jout["zq"], jout["q_ids"], jout["state"]),
        atol=1e-5, rtol=0)
    for b, payload in enumerate(out["payloads"]):
        got = dec.decode_payload(payload)
        np.testing.assert_allclose(got, jdec.decode_payload(payload), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got[0], feats[b], atol=1e-5, rtol=0)
    enc.reset()
    assert enc.z_window == [] and enc.produce_payload(16) is None


def test_quantize_latents_match_jax(small):
    jcfg, cfg, jp, tp = small
    rs = np.random.RandomState(6)
    z = (rs.randn(2, 5, cfg.latent_dim) * 3).astype(np.float32)
    q = np.array([0, 3, 7, 11, 15], np.int32)
    zq, rates = C.quantize_latents(tp, torch.from_numpy(z), torch.from_numpy(q), cfg)
    jzq, jrates = JC.quantize_latents(jp, z, q, jcfg)
    assert np.array_equal(zq.numpy(), np.asarray(jzq))
    np.testing.assert_allclose(rates.numpy(), np.asarray(jrates), rtol=1e-5)
    np.testing.assert_allclose(
        C.unquantize_latents(tp, zq, torch.from_numpy(q), cfg).numpy(),
        np.asarray(JC.unquantize_latents(jp, jzq, q, jcfg)), rtol=1e-6)


def test_drivers_need_cuda_by_default(small):
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    _, cfg, _, tp = small
    with pytest.raises(RuntimeError, match="CUDA"):
        C.DREDEncoder(tp, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.DREDDecoder(tp, cfg)


def test_fec_file_roundtrip_and_jax_bytes(tmp_path):
    rng = np.random.RandomState(0)
    packets = [rng.randn(2, 20).astype(np.float32) for _ in range(5)]
    rates = [100 + i for i in range(5)]
    path, jpath = tmp_path / "t.fec", tmp_path / "j.fec"
    FF.write_fec_packets(str(path), packets, rates)
    JF.write_fec_packets(str(jpath), packets, rates)
    assert path.read_bytes() == jpath.read_bytes()
    got, grates = FF.read_fec_packets(str(path))
    assert grates == rates
    for a, b in zip(packets, got):
        np.testing.assert_array_equal(a, b)
    FF.write_fec_packets(str(path), packets)
    assert FF.read_fec_packets(str(path))[1] == [0] * 5


def test_demo_dred_roundtrip():
    """test_demo_dred.py on the port: the shipped demo RDO-VAE (float16
    leaves cast to float32) on the demo features; the redundancy beats a
    zero predictor over the last 40 frames."""
    params, cfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device="cpu")
    feats = np.load(ROOT / "tests" / "fixtures" / "demo_features.npy")[:120]
    enc = C.DREDEncoder(params, cfg, batch=1, device="cpu")
    for f in feats:
        enc.add_feature_frame(f[None])
    p = enc.produce_payload(num_redundancy_frames=20, q0=3, q1=12)
    assert p is not None and float(p["bits"][0]) > 0
    out = C.DREDDecoder(params, cfg, device="cpu").decode_all(
        p["zq"], p["q_ids"], p["state"])
    rec = out[0][::-1][-40:, :18]
    true = feats[-40:, :18]
    mse = float(np.mean((rec - true) ** 2))
    var = float(np.var(true))
    assert np.isfinite(mse)
    assert mse < var, f"DRED should beat zero-predictor: mse={mse} var={var}"


def test_dred_payload_feeds_plc_fec():
    """test_integration_dred_plc.py on the port: an entropy-coded payload
    decoded on the receiver and queued into the host PLC's FEC queue covers
    every loss, so the PLC never predicts."""
    n_frames = 12
    pcm = np.load(ROOT / "tests" / "fixtures" / "codec.npz")["pcm"].astype(np.float32)
    pcm = np.tile(pcm, n_frames * 160 // len(pcm) + 1)[:n_frames * 160]

    rcfg = RV.RDOVAEConfig(**SMALL)
    rparams = RV.init_params(rcfg, 0)
    enc = C.DREDEncoder(rparams, rcfg, batch=1, device="cpu")
    st = F.init_encoder_state(1)
    for k in range(n_frames):
        st, f = F.compute_single_frame_features(
            st, torch.from_numpy(pcm[None, k * 160:(k + 1) * 160]))
        enc.add_feature_frame(f[:, :20])
    out = enc.produce_payload(num_redundancy_frames=n_frames, q0=3, q1=9)
    assert out is not None

    red = C.DREDDecoder(rparams, rcfg, device="cpu").decode_payload(
        out["payloads"][0])[0]                       # newest first, [L*4, 20]
    assert red.shape[0] >= n_frames
    red_by_frame = red[::-1][-n_frames:]             # oldest..newest tail

    cfg = M.LPCNetConfig(rnn_units1=64, rnn_units2=16, cond_size=32)
    fused = M.fuse_inference_params(M.init_params(cfg, 1), cfg)
    plc = PLC(fused, cfg, PM.init_params(2), options=LPCNET_PLC_CAUSAL, batch=1,
              device="cpu")
    fec_packets = [red_by_frame[2 * p:2 * p + 2] for p in range(n_frames // 2)]
    outpcm = run_plc_fec_stream(plc, pcm, np.array([0, 0, 1, 1, 0, 0]), fec_packets)
    assert outpcm.shape == (n_frames * 160,)
    assert np.isfinite(outpcm).all()
    assert plc.loss_count == 0
    assert plc.fec_read_pos > 0
