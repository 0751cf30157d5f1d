"""The port's reference-torch RDO-VAE interchange
(`lpcnet_torch.weights.rdovae_import`) against the reference's recorded
outputs (tests/fixtures/rdovae_torch.npz, recorded by
tools/record_rdovae_torch.py from the reference torch model): the cases of
test_rdovae_import.py at its bars, on the port's forward."""

import os

import numpy as np
import pytest
import torch

from lpcnet_tpu.weights import rdovae_import as JRI

from lpcnet_torch.models import rdovae as R
from lpcnet_torch.weights import rdovae_import as RI

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "rdovae_torch.npz")


@pytest.fixture(scope="module")
def fx():
    data = np.load(FIX)
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    return data, sd, RI.params_from_torch_state_dict(sd), R.RDOVAEConfig(quant_levels=16)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_encoder_matches_torch(fx):
    data, _, params, cfg = fx
    z, states = R.encode_seq(params, _t(data["features"]), cfg)
    np.testing.assert_allclose(z.numpy(), data["enc_z"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(states.numpy(), data["enc_states"],
                               atol=2e-5, rtol=1e-4)


def test_decoder_matches_torch(fx):
    data, _, params, cfg = fx
    out = R.decode_seq(params, _t(data["z_in"]), _t(data["init_state"]), cfg)
    np.testing.assert_allclose(out.numpy(), data["dec_out"], atol=2e-5, rtol=1e-4)


def test_statistical_model_matches_torch(fx):
    data, _, params, cfg = fx
    stats = R.statistical_model(params, _t(data["q_ids"]), cfg)
    for k in ("quant_scale", "r_hard", "theta_hard", "dead_zone"):
        np.testing.assert_allclose(stats[k].numpy(), data["stats_" + k],
                                   atol=2e-5, rtol=1e-4, err_msg=k)


def test_streaming_matches_imported_sequence(fx):
    data, _, params, cfg = fx
    feats = data["features"]
    b, t, _ = feats.shape
    st = R.init_encoder_stream(b, cfg)
    zs = []
    for k in range(t // 2):
        st, z, _ = R.encode_dframe(params, st, _t(feats[:, 2 * k:2 * k + 2].reshape(b, -1)),
                                   cfg)
        zs.append(z.numpy())
    np.testing.assert_allclose(np.stack(zs, axis=1), data["enc_z"], atol=3e-5, rtol=1e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_state_dict_roundtrip(fx):
    """params -> state dict gives the reference's own state dict back, and
    JAX's converter reads the same params from it; the '.module.' infix is
    optional on the way in."""
    _, sd, params, _ = fx
    back = RI.state_dict_from_params(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k], np.float32),
                                      err_msg=k)
    again = _flat(RI.params_from_torch_state_dict(back))
    plain = _flat(RI.params_from_torch_state_dict(
        {k.replace(".module.", "."): v for k, v in back.items()}))
    jax_params = _flat(JRI.params_from_torch_state_dict(sd))
    leaves = _flat(params)
    assert sorted(again) == sorted(leaves) == sorted(plain) == sorted(jax_params)
    for k, a in leaves.items():
        assert torch.equal(a, again[k]) and torch.equal(a, plain[k]), k
        np.testing.assert_array_equal(a.numpy(), np.asarray(jax_params[k]), err_msg=k)


def test_config_and_checkpoint_loading(tmp_path, fx):
    _, sd, params, _ = fx
    cfg = RI.config_from_model_args((20, 80, 40, 256, 256), {"state_dim": 24})
    assert (cfg.quant_levels, cfg.state_dim, cfg.cond_size) == (40, 24, 256)
    path = tmp_path / "ck.pth"
    torch.save({"state_dict": RI.state_dict_from_params(params),
                "model_args": (20, 80, 16, 256, 256),
                "model_kwargs": {"state_dim": 24}}, path)
    loaded, lcfg = RI.load_torch_checkpoint(str(path))
    assert lcfg == R.RDOVAEConfig(quant_levels=16)
    for k, v in _flat(loaded).items():
        assert torch.equal(v, _flat(params)[k]), k
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    _, bare_cfg = RI.load_torch_checkpoint(str(path))
    assert bare_cfg.quant_levels == 40
