"""The port's DNNw weight blobs (`weights.blob`, `weights.lpcnet_arrays`,
the PLC half of `weights.aux_arrays`) and the `.bin` loading of
`api.load_model` / `api.load_plc_model`: the cases of test_weights_blob.py
and test_aux_weights_serving.py on the port's modules, the port writer's
bytes against the reference writer's (refblob.npz), and the port reader
against the JAX package's on the same bytes."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.models import plc as JPM
from lpcnet_tpu.weights import aux_arrays as JAUX
from lpcnet_tpu.weights import lpcnet_arrays as JLA

from lpcnet_torch import api
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.weights import aux_arrays as AUX
from lpcnet_torch.weights import blob as B
from lpcnet_torch.weights import lpcnet_arrays as LA

torch.set_num_threads(1)

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fixture_params():
    """The fixture's weights (jax.random, seeds 1234 and 5678) as numpy."""
    params = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1234), JM.LPCNetConfig())
    return _numpy(params), _numpy(JPM.init_params(jax.random.PRNGKey(5678)))


def test_container_roundtrip():
    rng = np.random.RandomState(0)
    arrays = {
        "alpha": rng.randn(37).astype(np.float32),
        "beta_idx": rng.randint(0, 100, 11).astype(np.int32),
        "gamma_q": rng.randint(-128, 128, 64).astype(np.int8),
    }
    data = B.write_blob(arrays)
    assert len(data) % 64 == 0
    back = B.read_blob(data)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
        assert back[k].dtype == arrays[k].dtype
    with pytest.raises(ValueError, match="magic"):
        B.read_blob(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="truncated"):
        B.read_blob(data + b"\0" * 10)
    with pytest.raises(ValueError, match="block size"):
        B.read_blob(data[:70])


def test_sparse_roundtrip():
    rng = np.random.RandomState(1)
    rows, cols = 64, 192
    dense = rng.randn(rows, cols).astype(np.float32) * 0.3
    for rb in range(rows // 4):            # kill ~70 % of the 4x8 blocks
        for cb in range(cols // 8):
            if rng.rand() < 0.7:
                dense[rb * 4:(rb + 1) * 4, cb * 8:(cb + 1) * 8] = 0.0
    w, idx = B.encode_sparse(dense, quantize=True)
    got, mask = B.decode_sparse(w, idx, rows, cols)
    q = np.clip(np.round(dense * 128), -128, 127) / 128.0
    np.testing.assert_allclose(got, q, atol=1e-9)
    assert mask.max() <= 1.0 and np.array_equal(mask > 0, dense != 0)
    w2, idx2 = B.encode_sparse(dense, quantize=False)
    got2, _ = B.decode_sparse(w2, idx2, rows, cols)
    np.testing.assert_allclose(got2, dense, atol=0)


def test_dotp_roundtrip():
    rng = np.random.RandomState(2)
    dense = rng.randn(16, 48).astype(np.float32) * 0.4
    back = B.decode_dotp_dense(B.encode_dotp_dense(dense), 16, 48)
    np.testing.assert_allclose(back, np.clip(np.round(dense * 128), -128, 127)
                               / 128.0, atol=1e-9)


def test_sparse_decode_rejects_corrupt():
    rng = np.random.RandomState(5)
    w, idx = B.encode_sparse(rng.randn(16, 24).astype(np.float32))
    bad = idx.copy()
    bad[0] = 1000                                  # more blocks than the stream
    with pytest.raises(ValueError):
        B.decode_sparse(w, bad, 16, 24)
    bad = idx.copy()
    bad[1] = 3                                     # a row that is not 4-aligned
    with pytest.raises(ValueError):
        B.decode_sparse(w, bad, 16, 24)


def test_reference_writer_byte_identity(fixture_params):
    """The port's writer gives the bytes of the reference's
    write_lpcnet_weights.c (refblob.npz's SHA-256, float and int8), from the
    fixture's weights carried as numpy; those bytes load through the port's
    reader to the fused params the JAX package's reader gives, exactly."""
    fx = load_fixture("refblob.npz")
    params, plc_params = fixture_params
    cfg = M.LPCNetConfig()
    voc = LA.arrays_from_params(params, cfg, quantize=False)
    plc = AUX.plc_arrays_from_params(plc_params, quantize=False)
    blob = B.write_blob({**voc, **plc})
    assert hashlib.sha256(blob).digest() == fx["float_sha"].tobytes()
    qblob = LA.save_lpcnet_blob(params, cfg, quantize=True)
    assert hashlib.sha256(qblob).digest() == fx["q_sha"].tobytes()
    # the writer takes tensors as well as arrays
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    assert LA.save_lpcnet_blob(tparams, cfg, quantize=True) == qblob
    for data in (blob, qblob):
        mine = LA.load_lpcnet_blob(data, cfg)
        theirs = _numpy(JLA.load_lpcnet_blob(data, JM.LPCNetConfig()))
        assert set(mine) == set(theirs)
        for k, v in theirs.items():
            leaves = v.items() if isinstance(v, dict) else [(None, v)]
            for leaf, arr in leaves:
                got = mine[k] if leaf is None else mine[k][leaf]
                assert got.dtype == torch.float32, (k, leaf)
                assert np.array_equal(got.numpy(), arr), (k, leaf)


def test_blob_export_import_fused_equivalence():
    """A float blob of the port's params loads to fused params that act as
    the in-memory fusion does (one frame net and 32 sample steps)."""
    cfg = M.LPCNetConfig(**SMALL)
    params = M.init_params(cfg, seed=0)
    fused_blob = LA.load_lpcnet_blob(LA.save_lpcnet_blob(params, cfg, quantize=False),
                                     cfg)
    fused_mem = M.fuse_inference_params(params, cfg)
    feats = torch.from_numpy(np.random.RandomState(3).normal(size=(2, 36))
                             .astype(np.float32) * 0.3)
    outs = []
    for fused in (fused_mem, fused_blob):
        fs = M.init_frame_state(2, cfg)
        ss = M.init_sample_state(2, cfg)
        fs, _, ca, cb, lpc = M.frame_network(fused, fs, feats, cfg)
        np.testing.assert_allclose(ca.numpy(), M.frame_network(
            fused_mem, M.init_frame_state(2, cfg), feats, cfg)[2].numpy(),
            atol=1e-6)
        outs.append(M.synthesize_frame(fused, ss, ca, cb, lpc, n_samples=32)[1])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=2.0)


def test_blob_quantized_loads():
    cfg = M.LPCNetConfig(**SMALL)
    fused = LA.load_lpcnet_blob(
        LA.save_lpcnet_blob(M.init_params(cfg, seed=0), cfg, quantize=True), cfg)
    # int8-encoded recurrent weights decode to the 1/128 grid
    r = fused["gru_b_rec"]["recurrent"].numpy()
    assert np.allclose(r * 128, np.round(r * 128), atol=1e-4)


def test_plc_blob_roundtrip():
    """test_aux_weights_serving.py:15 on the port: a float PLC blob reads
    back to params that predict as the originals, and the port's bytes are
    the JAX package's for the same weights."""
    params = PM.init_params(seed=0)
    data = AUX.save_plc_blob(params, quantize=False)
    back = AUX.load_plc_blob(data)
    x = torch.from_numpy(np.random.RandomState(1).normal(size=(2, PM.PLC_INPUT_SIZE))
                         .astype(np.float32) * 0.3)
    st = PM.init_state(2)
    np.testing.assert_allclose(PM.compute_plc_pred(back, st, x)[1].numpy(),
                               PM.compute_plc_pred(params, st, x)[1].numpy(),
                               rtol=1e-5, atol=1e-5)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    for quantize in (False, True):
        assert (AUX.save_plc_blob(params, quantize)
                == JAUX.save_plc_blob(jparams, quantize))


def test_api_loads_bin_blobs(tmp_path, fixture_params):
    """`api.load_model` and `api.load_plc_model` read `.bin` blobs (a
    vocoder at LPCNetConfig(), int8 on request; a PLC net), and a missing
    file raises FileNotFoundError."""
    params, plc_params = fixture_params
    cfg = M.LPCNetConfig()
    voc_path, plc_path = tmp_path / "model.bin", tmp_path / "plc.bin"
    voc_path.write_bytes(LA.save_lpcnet_blob(params, cfg, quantize=False))
    plc_path.write_bytes(AUX.save_plc_blob(plc_params, quantize=False))
    fused, got_cfg = api.load_model(str(voc_path), device="cpu")
    assert got_cfg == cfg
    want = LA.load_lpcnet_blob(voc_path.read_bytes(), cfg)
    assert torch.equal(fused["gru_a_rec"]["recurrent"], want["gru_a_rec"]["recurrent"])
    fused_q, _ = api.load_model(str(voc_path), int8=True, device="cpu")
    assert fused_q["gru_a_rec"]["recurrent_q8"].dtype == torch.int8
    net = api.load_plc_model(str(plc_path), device="cpu")
    for layer in plc_params:
        for leaf, arr in plc_params[layer].items():
            assert np.array_equal(net[layer][leaf].numpy(), arr), (layer, leaf)
    with pytest.raises(FileNotFoundError):
        api.load_model(str(tmp_path / "missing.bin"), device="cpu")
    with pytest.raises(FileNotFoundError):
        api.load_plc_model(str(tmp_path / "missing.bin"), device="cpu")

