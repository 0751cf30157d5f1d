"""`Trainer.train_block` and `PLCTrainer.train_block` of the port on the
CPU: block-size invariance, a block against the same steps taken one by
one, the vocoder's block against the JAX package's `train_block` on the
same index blocks (JAX's noise fed in), and `index_blocks` against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as JM
from lpcnet_tpu.parallel import mesh as pmesh
from lpcnet_tpu.train import data as JD
from lpcnet_tpu.train import train_lpcnet as JT
from lpcnet_tpu.train import train_plc as JP

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.train import data as D
from lpcnet_torch.train import train_lpcnet as T
from lpcnet_torch.train import train_plc as TP
from lpcnet_torch.utils.rng import fold_seed
from lpcnet_torch.weights.convert import params_to_numpy

torch.set_num_threads(1)

TINY = dict(rnn_units1=32, rnn_units2=16, cond_size=16, pitch_embed_dim=8)
BS, CF = 4, 5
PLC_SMALL = dict(dense1_size=16, gru1_size=24, gru2_size=24)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX package's block-test corpus (tests/test_training.py):
    25 chunks of 5 frames of seeded int16 pairs and features."""
    d = tmp_path_factory.mktemp("block")
    rng = np.random.RandomState(0)
    nchunks = 25
    pcm = rng.randint(-3000, 3000, nchunks * CF * 160 * 2).astype(np.int16)
    feats = rng.randn((nchunks + 1) * CF * 36).astype(np.float32) * 0.3
    dpath, fpath = str(d / "d.s16"), str(d / "f.f32")
    pcm.tofile(dpath)
    feats.tofile(fpath)
    return dpath, fpath


@pytest.fixture(scope="module")
def plc_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("plcblock")
    rng = np.random.RandomState(3)
    fpath, lpath = str(d / "f.f32"), str(d / "l.s8")
    (rng.randn(320, 72) * 0.3).astype(np.float32).tofile(fpath)
    (rng.rand(320) > 0.2).astype(np.int8).tofile(lpath)
    return fpath, lpath


def _loader(corpus):
    return D.DeviceLPCNetLoader(*corpus, batch_size=BS, chunk_frames=CF,
                                seed=3, device="cpu")


def _sels(loader, k=4):
    blocks = iter(loader.index_blocks(1))
    return np.concatenate([next(blocks) for _ in range(k)], axis=0)


def _trainer(**kw):
    tc = T.TrainConfig(batch_size=BS, chunk_frames=CF, **kw)
    return T.Trainer(M.LPCNetConfig(**TINY), tc, seed=2, device="cpu")


def _equal_params(a, b):
    pa, pb = params_to_numpy(a), params_to_numpy(b)
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_vocoder_block_size_invariant(corpus):
    loader = _loader(corpus)
    sels = _sels(loader)

    def run(block_sizes):
        tr = _trainer(ema_decay=0.999)
        off, losses = 0, []
        for k in block_sizes:
            ms = tr.train_block(loader, sels[off:off + k])
            assert ms["loss"].shape == (k,)
            losses += list(ms["loss"].numpy())
            off += k
        assert tr.step == 4
        return tr, losses

    t1, l1 = run([4])
    t2, l2 = run([2, 2])
    np.testing.assert_array_equal(l1, l2)
    _equal_params(t1.params, t2.params)
    _equal_params(t1.ema_params, t2.ema_params)
    assert all(torch.equal(a, b) for a, b in zip(t1._gru_states,
                                                t2._gru_states))


def test_vocoder_block_equals_its_steps(corpus):
    loader = _loader(corpus)
    sels = _sels(loader)
    blk = _trainer()
    mb = blk.train_block(loader, sels)
    one = _trainer()
    losses = []
    for sel in sels:
        g = torch.Generator().manual_seed(fold_seed(917, one.step))
        batch = loader.sample(torch.from_numpy(sel.astype(np.int64)))
        losses.append(one.train_step(batch, g)["loss"])
    assert torch.equal(mb["loss"], torch.stack(losses))
    _equal_params(blk.params, one.params)


def test_vocoder_block_matches_jax_train_block(corpus, monkeypatch):
    """JAX's train_block and the port's on the same index blocks from the
    same parameters, input noise 0; the 0.005 noise on GRU-A's output is
    JAX's draw (fold_in(PRNGKey(917), step), then split 3), fed to the
    port's draw."""
    jl = JD.DeviceLPCNetLoader(*corpus, batch_size=BS, chunk_frames=CF,
                               seed=3)
    loader = _loader(corpus)
    sels = _sels(loader)
    np.testing.assert_array_equal(_sels(jl), sels)
    kw = dict(batch_size=BS, chunk_frames=CF, input_noise=0.0)
    tr = _trainer(input_noise=0.0)
    p0 = params_to_numpy(tr.params)
    jtr = JT.Trainer(JM.LPCNetConfig(**TINY), JT.TrainConfig(**kw),
                     mesh=pmesh.make_mesh(jax.devices("cpu")[:1]))
    nested = {}
    for k, v in p0.items():
        a, b = k.split("/", 1) if "/" in k else (k, None)
        if b is None:
            nested[a] = jnp.asarray(v)
        else:
            nested.setdefault(a, {})
            node = nested[a]
            parts = b.split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = jnp.asarray(v)
    jtr.state = JT.TrainState(nested, jtr.optimizer.init(nested),
                              jnp.zeros((), jnp.int32))
    jm = jtr.train_block(jl, sels)

    keys = []
    for s in range(4):
        _, k1, k2 = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(917), s), 3)
        keys += [k1, k2]

    def feed(shape, rng, device):
        return torch.from_numpy(np.array(
            jax.random.normal(keys.pop(0), tuple(shape)))).to(device)

    monkeypatch.setattr(M, "_randn", feed)
    tm = tr.train_block(loader, sels)
    assert not keys
    jloss, tloss = np.asarray(jm["loss"]), tm["loss"].numpy()
    assert abs(tloss[0] - jloss[0]) <= 1e-4 * abs(jloss[0])
    np.testing.assert_allclose(tloss[1:], jloss[1:], rtol=1e-3)
    got = params_to_numpy(tr.params)
    want = jax.tree_util.tree_flatten_with_path(jtr.state.params)[0]
    for path, v in want:
        k = "/".join(p.key for p in path)
        v = np.asarray(v)
        scale = max(float(np.abs(v).max()), 1e-6)
        assert float(np.abs(got[k] - v).max()) <= 1e-2 * scale, k


def test_index_blocks_match_jax(corpus):
    jl = JD.DeviceLPCNetLoader(*corpus, batch_size=BS, chunk_frames=CF,
                               seed=3)
    tl = _loader(corpus)
    for k in (1, 2, 4):
        jb, tb = list(jl.index_blocks(k)), list(tl.index_blocks(k))
        assert len(tb) == len(jb) == len(tl) // k
        for a, b in zip(jb, tb):
            assert b.dtype == np.int32 and b.shape == (k, BS)
            np.testing.assert_array_equal(a, b)
    sig_in, sig_out, feats = tl.device_arrays
    sel = torch.tensor([0, 5, 7, 2])
    got = tl.sample_fn(sig_in, sig_out, feats, sel)
    for key, v in tl.sample(sel).items():
        assert torch.equal(got[key], v), key


def _plc(files):
    tc = TP.PLCTrainConfig(batch_size=2, seq_length=16)
    loader = TP.PLCDeviceLoader(*files, tc, seed=0, device="cpu")
    loader.indices = np.arange(loader._n_train)
    tr = TP.PLCTrainer(PM.PLCConfig(**PLC_SMALL), tc, seed=1, device="cpu")
    return loader, tr


def test_plc_block_size_invariant_and_equal_to_its_steps(plc_files):
    """The block half of the JAX package's test_plc_device_loader_and_
    block_path: one block of 4 against two of 2, bit-exact, and against 4
    train_step calls on the same batches."""
    loader, t1 = _plc(plc_files)
    sels = np.arange(8, dtype=np.int32).reshape(4, 2) % len(loader.indices)
    m1 = t1.train_block(loader, sels)
    _, t2 = _plc(plc_files)
    m2 = [t2.train_block(loader, sels[:2]), t2.train_block(loader, sels[2:])]
    assert t1.step == t2.step == 4
    np.testing.assert_array_equal(
        m1["loss"].numpy(), np.concatenate([m["loss"].numpy() for m in m2]))
    _equal_params(t1.params, t2.params)
    _, t3 = _plc(plc_files)
    feats_d, lost_d = loader.device_arrays
    losses = []
    for sel in sels:
        g = torch.Generator().manual_seed(fold_seed(4242, t3.step))
        batch = loader.sample_fn(feats_d, lost_d,
                                 torch.from_numpy(sel.astype(np.int64)), g)
        losses.append(t3.train_step(batch)["loss"])
    assert torch.equal(m1["loss"], torch.stack(losses))
    _equal_params(t1.params, t3.params)
    assert np.isfinite(m1["loss"].numpy()).all()


def test_plc_index_blocks_match_jax(plc_files):
    tc = dict(batch_size=2, seq_length=16)
    jl = JP.PLCDeviceLoader(*plc_files, JP.PLCTrainConfig(**tc), seed=5)
    tl = TP.PLCDeviceLoader(*plc_files, TP.PLCTrainConfig(**tc), seed=5,
                            device="cpu")
    for a, b in zip(jl.index_blocks(3), tl.index_blocks(3)):
        np.testing.assert_array_equal(a, b)
