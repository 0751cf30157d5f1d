"""The RDO-VAE's DNNw weight blobs in the port (the DRED half of
`lpcnet_torch.weights.aux_arrays`, `api.load_rdovae_model`) and its C gate:
the writer's bytes against the JAX package's, the reader against its
params, and the DRED part of test_neural_cref.py (blob SHA, encoder and
decoder against the C reference's traces) on the port."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from conftest import load_fixture

from lpcnet_tpu.models import rdovae as JR
from lpcnet_tpu.weights import aux_arrays as JAUX
from lpcnet_tpu.weights import blob as JB

from lpcnet_torch import api
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.weights import aux_arrays as AUX
from lpcnet_torch.weights import blob as B
from lpcnet_torch.weights.convert import params_to_torch

torch.set_num_threads(1)

TINY = dict(latent_dim=8, cond_size=16, cond_size2=12, state_dim=6,
            pvq_num_pulses=12, state_hidden=10)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("quantize", [False, True])
def test_rdovae_blob_roundtrip_and_jax_bytes(quantize, tmp_path):
    """The port's blob of JAX's weights is byte for byte JAX's; read back
    (by `api.load_rdovae_model` too) it gives JAX's reader's params and the
    same encoder and decoder outputs (test_aux_weights_serving.py:27; the
    float blob only, as there: the int8 one rounds the GRU weights)."""
    jcfg, cfg = JR.RDOVAEConfig(**TINY), RV.RDOVAEConfig(**TINY)
    jp = jax.tree.map(np.asarray, JR.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_to_torch(jp)
    data = AUX.save_rdovae_blob(tp, quantize=quantize)
    assert data == JAUX.save_rdovae_blob(jp, quantize=quantize)
    back = AUX.load_rdovae_blob(data, cfg)
    jback = _flat(JAUX.load_rdovae_blob(data, jcfg))
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jback[k]), err_msg=k)
    path = tmp_path / "rdovae.bin"
    path.write_bytes(data)
    loaded, lcfg = api.load_rdovae_model(str(path), cfg=cfg, device="cpu")
    assert lcfg == cfg
    for k, v in _flat(loaded).items():
        assert torch.equal(v, _flat(back)[k]), k
    if quantize:
        return

    feats = torch.from_numpy((np.random.RandomState(2).randn(2, 8, 20) * 0.3
                              ).astype(np.float32))
    z1, s1 = RV.encode_seq(tp, feats, cfg)
    z2, s2 = RV.encode_seq(back, feats, cfg)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(z1, z2, **tol)
    dec1 = RV.decode_seq(tp, z1[:, ::2], s1[:, -1], cfg)
    dec2 = RV.decode_seq(back, z2[:, ::2], s2[:, -1], cfg)
    torch.testing.assert_close(dec1, dec2, **tol)


def test_load_rdovae_model_npz_and_seed(tmp_path):
    """The demo model's float16 leaves come in as float32 at the default
    config; a seeded init is repeatable; entry points need CUDA unless the
    CPU is asked for."""
    params, cfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device="cpu")
    assert cfg == RV.RDOVAEConfig()
    raw = np.load(api.DEMO_RDOVAE_MODEL_PATH)
    for k, v in _flat(params).items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), raw[k].astype(np.float32))
    a, _ = api.load_rdovae_model(seed=3, cfg=RV.RDOVAEConfig(**TINY), device="cpu")
    b, _ = api.load_rdovae_model(seed=3, cfg=RV.RDOVAEConfig(**TINY), device="cpu")
    for k, v in _flat(a).items():
        assert torch.equal(v, _flat(b)[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.load_rdovae_model()


def test_dred_encoder_decoder_against_c():
    """test_neural_cref.py:198-222 on the port: JAX's PRNGKey(91011) weights
    carried across, the port's blob SHA equal to the one C read; latents,
    states and decoded features within 1e-4 of the C traces."""
    fx = load_fixture("neural_cref.npz")
    jp = jax.tree.map(np.asarray, JR.init_params(jax.random.PRNGKey(91011)))
    params, cfg = params_to_torch(jp), RV.RDOVAEConfig()
    blob = B.write_blob(AUX.rdovae_arrays_from_params(params, quantize=False))
    assert hashlib.sha256(blob).digest() == fx["dred_blob_sha"].tobytes()
    assert blob == JB.write_blob(JAUX.rdovae_arrays_from_params(jp, quantize=False))

    feats = torch.from_numpy(fx["dred_features"])[None]
    z, states = RV.encode_seq(params, feats, cfg)
    assert float(np.abs(z[0].numpy() - fx["dred_latents"]).max()) < 1e-4
    assert float(np.abs(states[0].numpy() - fx["dred_states"]).max()) < 1e-4

    init = torch.from_numpy(fx["dred_states"][-1])[None]
    dec = RV.decode_seq(params, z, init, cfg)[0].numpy()
    dec = dec.reshape(fx["dred_dec_features"].shape)
    assert float(np.abs(dec - fx["dred_dec_features"]).max()) < 1e-4

    # the streaming forms from the same weights give the C latents too
    st = RV.init_encoder_stream(1, cfg)
    f = fx["dred_features"]
    for k in range(f.shape[0] // 2):
        st, zk, sk = RV.encode_dframe(params, st, torch.from_numpy(
            f[2 * k:2 * k + 2].reshape(1, -1)), cfg)
        assert float(np.abs(zk[0].numpy() - fx["dred_latents"][k]).max()) < 1e-4
        assert float(np.abs(sk[0].numpy() - fx["dred_states"][k]).max()) < 1e-4
