"""The port's DRED command-line modes on the CPU: `dred-payload` then
`dred-payload-decode` at full width from one `--model` file (the demo
RDO-VAE written as float32) against the JAX package's cli on the same
file and speech, then the other modes (`dred-encode`, `dred-decode`,
`fec-encode`) and the `.fec` file through the host PLC."""

from pathlib import Path

import numpy as np
import pytest
import torch

from lpcnet_tpu import cli as jcli

from lpcnet_torch import api, cli
from lpcnet_torch.dred.fec_file import read_fec_packets

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The codec fixture's speech (200 frames) and the demo RDO-VAE as a
    float32 npz, which both packages read alike."""
    d = tmp_path_factory.mktemp("dred_cli")
    pcm = d / "in.pcm"
    np.load(ROOT / "tests" / "fixtures" / "codec.npz")["pcm"].astype(np.int16).tofile(pcm)
    raw = np.load(api.DEMO_RDOVAE_MODEL_PATH)
    model = d / "rdovae.npz"
    np.savez(model, **{k: (raw[k] if k == "__config__" else raw[k].astype(np.float32))
                       for k in raw.files})
    return d, str(pcm), str(model)


def test_payload_and_decode_match_jax_cli(files):
    """The payload's bytes equal the JAX cli's; the decoded features within
    1e-5 of its decode of the same bytes."""
    d, pcm, model = files
    paths = {k: str(d / k) for k in ("t.bin", "j.bin", "t.f32", "j.f32")}
    assert cli.main(["dred-payload", pcm, paths["t.bin"], "--model", model,
                     "--device", "cpu"]) == 0
    jcli.main(["dred-payload", pcm, paths["j.bin"], "--model", model])
    got, want = (Path(paths[k]).read_bytes() for k in ("t.bin", "j.bin"))
    assert len(got) > 3 and got == want
    cli.main(["dred-payload-decode", paths["t.bin"], paths["t.f32"], "--model",
              model, "--device", "cpu"])
    jcli.main(["dred-payload-decode", paths["t.bin"], paths["j.f32"], "--model", model])
    feats, jfeats = (np.fromfile(paths[k], np.float32) for k in ("t.f32", "j.f32"))
    assert feats.shape == jfeats.shape == (26 * 4 * 20,)
    np.testing.assert_allclose(feats, jfeats, atol=1e-5, rtol=0)


def test_other_dred_modes(files):
    """dred-encode's latents and states, dred-decode's frames, and
    fec-encode's packets feeding the host PLC, which then never predicts."""
    from lpcnet_torch.plc.driver import make_plc, run_plc_fec_stream
    d, pcm, model = files
    lat, dec, fec = (str(d / k) for k in ("z.f32", "dec.f32", "x.fec"))
    common = ["--model", model, "--device", "cpu"]
    cli.main(["dred-encode", pcm, lat] + common)
    z = np.fromfile(lat, np.float32).reshape(-1, 80)
    st = np.fromfile(lat + ".state", np.float32).reshape(-1, 24)
    assert z.shape == (100, 80) and st.shape == (100, 24)
    assert np.isfinite(z).all() and np.abs(st).max() <= 1.0
    cli.main(["dred-decode", lat, dec] + common)
    assert np.fromfile(dec, np.float32).shape == (50 * 4 * 20,)

    cli.main(["fec-encode", pcm, fec, "--no-align"] + common)
    packets, rates = read_fec_packets(fec)
    assert len(packets) == 100 and packets[0].shape == (2, 20)
    assert all(r > 0 for r in rates)
    speech = np.fromfile(pcm, np.int16)[:40 * 160]
    plc = make_plc("causal", device="cpu")
    losses = np.zeros(20, np.int32)
    losses[[6, 7, 12]] = 1
    out = run_plc_fec_stream(plc, speech, losses, packets)
    assert out.shape == speech.shape and np.isfinite(out).all()
    assert plc.loss_count == 0 and plc.fec_read_pos > 0
