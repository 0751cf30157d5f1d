"""Data parallelism over `torch.distributed` (`lpcnet_torch.parallel.mesh`
and the trainers' `mesh`) on the CPU with gloo: world size 1 in this
process against trainers without a mesh, world size 2 in two spawned
processes (a `file://` store under the test's tmp_path, a timeout on each)
against world size 1, and batch-sharded synthesis gathered against the
unsharded run."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.models import rdovae as RV
from lpcnet_torch.parallel import mesh as PX
from lpcnet_torch.train import train_lpcnet as T
from lpcnet_torch.train import train_plc as TP
from lpcnet_torch.train import train_rdovae as TR
from lpcnet_torch.weights.convert import params_to_numpy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(rnn_units1=32, rnn_units2=16, cond_size=16, pitch_embed_dim=8)
PLC_SMALL = dict(dense1_size=16, gru1_size=24, gru2_size=24)
RV_TINY = dict(latent_dim=8, cond_size=16, cond_size2=12, state_dim=6,
               pvq_num_pulses=12, state_hidden=10)
SPAWN_TIMEOUT = 120


def fake_batch(seed, b=4, frames=3):
    rs = np.random.RandomState(seed)
    t = frames * 160
    sig = np.cumsum(rs.randn(b, t + 1), axis=1).astype(np.float32) * 100
    return {
        "sig_in": sig[:, :-1].copy(),
        "sig_out": sig[:, 1:].copy(),
        "features": rs.randn(b, frames + 4, 20).astype(np.float32) * 0.3,
        "periods": rs.randint(33, 255, (b, frames + 4)).astype(np.int32),
        "lpc": (rs.randn(b, frames, 16) * 0.05).astype(np.float32),
    }


def rdovae_batch(seed, b=4, t=32):
    rs = np.random.RandomState(seed)
    return {"features": (rs.randn(b, t, 20) * 0.3).astype(np.float32),
            "rate_lambda": np.full((b, t // 2), 0.001, np.float32),
            "q_ids": np.full((b, t // 2), 3, np.int32)}


def write_plc_files(d):
    rs = np.random.RandomState(3)
    fpath, lpath = str(d / "f.f32"), str(d / "l.s8")
    (rs.randn(320, 72) * 0.3).astype(np.float32).tofile(fpath)
    (rs.rand(333) > 0.2).astype(np.int8).tofile(lpath)
    return fpath, lpath


def run_vocoder(mesh):
    tr = T.Trainer(M.LPCNetConfig(**TINY),
                   T.TrainConfig(batch_size=4, chunk_frames=3), seed=2,
                   device="cpu", mesh=mesh)
    ms = [tr.train_step(fake_batch(i), torch.Generator().manual_seed(10 + i))
          for i in range(2)]
    return params_to_numpy(tr.params), ms


def run_plc(mesh, d):
    """The PLC trainer's block of 2 over the files `write_plc_files` put
    in `d`."""
    fpath, lpath = str(d / "f.f32"), str(d / "l.s8")
    tc = TP.PLCTrainConfig(batch_size=4, seq_length=16)
    loader = TP.PLCDeviceLoader(fpath, lpath, tc, seed=3, device="cpu")
    tr = TP.PLCTrainer(PM.PLCConfig(**PLC_SMALL), tc, seed=1, device="cpu",
                       mesh=mesh)
    ms = tr.train_block(loader, next(loader.index_blocks(2)))
    return params_to_numpy(tr.params), ms


def run_rdovae(mesh):
    tr = TR.RDOVAETrainer(RV.RDOVAEConfig(**RV_TINY),
                          TR.RDOVAETrainConfig(lr=1e-3), seed=1,
                          device="cpu", mesh=mesh)
    ms = [tr.train_step(rdovae_batch(i), torch.Generator().manual_seed(i))
          for i in range(2)]
    return params_to_numpy(tr.params), ms


def synth_streams(mesh, b=16):
    """One frame of 16 streams through the plain path: the whole batch, or
    this rank's half of the global state and features."""
    cfg = M.LPCNetConfig(**TINY)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=0), cfg)
    feats = torch.from_numpy(
        (np.random.RandomState(1).randn(b, 36) * 0.3).astype(np.float32))
    fstate, sstate = M.init_frame_state(b, cfg), M.init_sample_state(b, cfg)
    if mesh is not None:
        fstate, sstate, feats = PX.shard_batch(mesh, (fstate, sstate, feats))
    fstate, _, ca, cb, lpc = M.frame_network(fused, fstate, feats, cfg)
    _, pcm = M.synthesize_frame(fused, sstate, ca, cb, lpc)
    if mesh is None:
        return pcm
    parts = [torch.empty_like(pcm) for _ in range(mesh.world_size)]
    dist.all_gather(parts, pcm)
    return torch.cat(parts)


def child(rank, world, d, job):
    """One spawned rank of `job`: its results into d/<job>_<rank>.npz."""
    d = pathlib.Path(d)
    PX.init_distributed("gloo", f"file://{d / 'store'}", world, rank)
    try:
        mesh = PX.make_mesh("cpu")
        if job == "synth":
            out = {"pcm": synth_streams(mesh).numpy()}
        else:
            params, ms = (run_vocoder(mesh) if job == "vocoder"
                          else run_plc(mesh, d))
            out = dict(params)
            out["__loss"] = (np.array([float(m["loss"]) for m in ms])
                             if isinstance(ms, list) else ms["loss"].numpy())
        np.savez(d / f"{job}_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def spawn(d, job, world=2):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    code = ("import sys, test_torch_mesh as t; "
            "t.child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            "sys.argv[4])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(d), job],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-4000:]
    return [dict(np.load(d / f"{job}_{r}.npz")) for r in range(world)]


def _max_rel(got, want):
    """The largest difference of a leaf over its largest entry."""
    assert set(got) >= set(want)
    return max(float(np.abs(got[k] - v).max())
               / max(float(np.abs(v).max()), 1e-12) for k, v in want.items())


# -- no process group (before the module's group exists) ---------------------

def test_single_process_defaults(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if dist.is_initialized():
        pytest.skip("a process group exists in this worker")
    PX.init_distributed()
    assert not dist.is_initialized()
    mesh = PX.make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    x = [torch.arange(4.0)]
    PX.all_reduce_mean(mesh, x)
    assert torch.equal(x[0], torch.arange(4.0))


# -- world size 1, in this process --------------------------------------------

@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    store = tmp_path_factory.mktemp("store1") / "store"
    PX.init_distributed("gloo", f"file://{store}", 1, 0)
    try:
        yield PX.make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_world_size_one_mesh(mesh1):
    assert mesh1.group is not None and mesh1.world_size == 1
    assert mesh1.rank == 0 and mesh1.device == torch.device("cpu")


@pytest.mark.parametrize("which", ["vocoder", "plc", "rdovae"])
def test_trainer_with_a_mesh_of_one_is_bit_equal(mesh1, which, tmp_path):
    write_plc_files(tmp_path)
    run = {"vocoder": run_vocoder, "rdovae": run_rdovae,
           "plc": lambda m: run_plc(m, tmp_path)}[which]
    with_mesh, m1 = run(mesh1)
    without, m0 = run(None)
    assert set(with_mesh) == set(without)
    for k in without:
        np.testing.assert_array_equal(with_mesh[k], without[k], err_msg=k)
    m1 = m1 if isinstance(m1, list) else [m1]
    m0 = m0 if isinstance(m0, list) else [m0]
    for a, b in zip(m1, m0):
        for k in b:
            assert torch.equal(a[k], b[k]), k


def test_all_reduce_mean_is_one_collective(mesh1, monkeypatch):
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, **kw: calls.append(t.numel()) or real(t, **kw))
    xs = [torch.ones(3), torch.full((2, 2), 4.0), None]
    PX.all_reduce_mean(mesh1, xs)
    assert calls == [7]
    assert torch.equal(xs[1], torch.full((2, 2), 4.0))


def test_shard_batch_raises_on_a_batch_that_does_not_divide():
    mesh = PX.Mesh(None, 1, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        PX.shard_batch(mesh, {"a": np.zeros((3, 2))})
    got = PX.shard_batch(mesh, {"b": torch.arange(8),
                                "c": M.init_sample_state(4, M.LPCNetConfig(
                                    **TINY))})
    assert torch.equal(got["b"], torch.arange(4, 8))
    assert got["c"].gru_a.shape[0] == 2 and got["c"].rng.z.shape == (2,)


def test_make_mesh_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PX.make_mesh()


# -- world size 2, two spawned processes ------------------------------------

def test_vocoder_world_size_two(tmp_path):
    r0, r1 = spawn(tmp_path, "vocoder")
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    want, ms = run_vocoder(None)
    np.testing.assert_allclose(r0["__loss"], [float(m["loss"]) for m in ms],
                               rtol=1e-6)
    # the averaged gradient differs from the whole batch's by float32
    # reassociation (about 1e-6 of a leaf's scale), and Adam's first steps,
    # lr g / (|g| + eps), turn that into up to 4.6e-5 of a leaf's scale on
    # the entries whose gradient is near zero: 1e-6 does not hold here
    assert _max_rel(r0, want) <= 1e-4


def test_plc_world_size_two(tmp_path):
    write_plc_files(tmp_path)
    r0, r1 = spawn(tmp_path, "plc")
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    want, ms = run_plc(None, tmp_path)
    np.testing.assert_allclose(r0["__loss"], ms["loss"].numpy(), rtol=1e-6)
    assert _max_rel(r0, want) <= 1e-6


def test_sharded_synthesis_gathers_to_the_unsharded_run(tmp_path):
    r0, r1 = spawn(tmp_path, "synth")
    want = synth_streams(None).numpy()
    assert want.shape == (16, 160) and np.isfinite(want).all()
    np.testing.assert_array_equal(r0["pcm"], want)
    np.testing.assert_array_equal(r1["pcm"], want)
