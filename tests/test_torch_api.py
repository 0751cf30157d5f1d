"""lpcnet_torch's public surface on the CPU: Synthesizer vs the JAX package's
on the shipped demo vocoder, the CLI, independence from JAX, and the
default device."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lpcnet_tpu import api as japi

from lpcnet_torch import api, cli
from lpcnet_torch.codec.decoder import LPCNetDecoder
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.utils.device import resolve_device

# the plain path is many small ops: one intra-op thread per process keeps
# parallel pytest workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DEMO = str(ROOT / "lpcnet_tpu" / "data" / "demo_model.npz")


def _features(batch, frames, seed=3):
    """Real speech features (the C-extracted fixture) spread over streams,
    plus a seeded perturbation per stream."""
    f = np.load(ROOT / "tests" / "fixtures" / "demo_features.npy")
    rs = np.random.RandomState(seed)
    out = np.zeros((frames, batch, 36), np.float32)
    for b in range(batch):
        out[:, b, :20] = f[b:b + frames] + rs.normal(0, 0.05, (frames, 20))
    return out


def _rng_words(state):
    return [x.numpy().astype(np.uint32) for x in state.rng]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_synthesizer_matches_jax(int8):
    """Warmup frames are silent in both; the first live frame agrees on
    >=98% of samples (int8: >90%), with the RNG in lockstep."""
    b, frames = 4, 3
    feats = _features(b, frames)
    jfused, jcfg = japi.load_model(DEMO, int8=int8)
    js = japi.Synthesizer(batch=b, fused=jfused, cfg=jcfg)
    tfused, tcfg = api.load_model(DEMO, int8=int8, device="cpu")
    ts = api.Synthesizer(batch=b, fused=tfused, cfg=tcfg, device="cpu")
    jp = np.stack([js.synthesize(feats[k]) for k in range(frames)])
    tp = np.stack([ts.synthesize(feats[k]) for k in range(frames)])
    la = jcfg.lookahead
    assert tp.dtype == np.int16 and tp.shape == (frames, b, 160)
    assert not jp[:la].any() and not tp[:la].any()
    assert np.abs(tp[la:]).max() > 0
    same = np.mean(jp[la] == tp[la])
    assert same >= (0.90 if int8 else 0.98), same
    jrng = js._dec.sample_state.rng
    for mine, theirs in zip(_rng_words(ts._dec.sample_state), jrng):
        assert np.array_equal(mine, np.asarray(theirs))


def test_decoder_kernel_path_on_cpu():
    """The decoder's kernel path on CPU tensors (the wrapper's plain version,
    with the bf16 bundle that the card runs): warmup frames are silent and
    leave the sample state alone; live frames are the frame network followed
    by the sample loop, exactly."""
    b, frames = 3, 4
    fused, cfg = api.load_model(DEMO, device="cpu")
    feats = _features(b, frames, seed=4)
    dec = LPCNetDecoder.from_fused(fused, cfg, b, device="cpu",
                                   use_kernel=True)
    assert dec._kw["emb_cat"].dtype == torch.bfloat16
    fs, ss = dec.frame_state, dec.sample_state
    for k in range(frames):
        pcm = dec.synthesize(feats[k])
        fs, _, ca, cb, lpc = M.frame_network(fused, fs,
                                             torch.from_numpy(feats[k]), cfg)
        if k < cfg.lookahead:
            assert not pcm.any()
            assert all(torch.equal(a, c) for a, c in
                       zip(dec.sample_state.rng, ss.rng))
            continue
        ss, want = K.sample_loop_plain(dec._kw, ss, ca, cb, lpc)
        assert np.array_equal(pcm, want.numpy().astype(np.int16))
        assert torch.equal(dec.sample_state.gru_a, ss.gru_a)


def test_synthesizer_reset_restarts_the_stream():
    feats = _features(2, 3, seed=5)
    s = api.Synthesizer(DEMO, batch=2, device="cpu")
    first = [s.synthesize(feats[k]) for k in range(3)]
    s.reset()
    again = [s.synthesize(feats[k]) for k in range(3)]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))


def test_load_model_random_init_is_seeded():
    f1, cfg = api.load_model(None, seed=1, device="cpu")
    f2, _ = api.load_model(None, seed=1, device="cpu")
    f3, _ = api.load_model(None, seed=2, device="cpu")
    assert cfg == M.LPCNetConfig()
    assert torch.equal(f1["gru_a_rec"]["recurrent"], f2["gru_a_rec"]["recurrent"])
    assert not torch.equal(f1["gru_a_rec"]["recurrent"],
                           f3["gru_a_rec"]["recurrent"])
    q, _ = api.load_model(None, seed=1, int8=True, device="cpu")
    assert q["gru_b_in_q8"].dtype == torch.int8


def test_cli_synthesis_roundtrip(tmp_path):
    feats = _features(1, 4, seed=6)[:, 0]
    fin, fout = tmp_path / "in.f32", tmp_path / "out.pcm"
    feats.astype(np.float32).tofile(fin)
    cli.main(["synthesis", str(fin), str(fout), "--device", "cpu"])
    pcm = np.fromfile(fout, dtype=np.int16)
    assert pcm.shape == (4 * 160,)
    s = api.Synthesizer(DEMO, batch=1, device="cpu")
    want = np.concatenate([s.synthesize(feats[k][None])[0] for k in range(4)])
    assert np.array_equal(pcm, want)
    assert not pcm[:320].any() and pcm[320:].any()


def test_import_leaves_jax_out():
    code = ("import sys; import lpcnet_torch, lpcnet_torch.api, "
            "lpcnet_torch.cli, lpcnet_torch.kernels.sample_loop; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'lpcnet_tpu'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_neither_jax_nor_lpcnet_tpu():
    files = sorted((ROOT / "lpcnet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lpcnet_tpu"), (f, mod)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fused, cfg = api.load_model(DEMO, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.load_model(DEMO)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Synthesizer(batch=1, fused=fused, cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LPCNetDecoder.from_fused(fused, cfg, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["synthesis", os.devnull, os.devnull])
    assert resolve_device("cpu").type == "cpu"


def test_unported_paths_raise():
    fused, cfg = api.load_model(DEMO, device="cpu")
    with pytest.raises(NotImplementedError):
        LPCNetDecoder.from_fused(fused, cfg, 1, device="cpu",
                                 with_codebooks=True)
    with pytest.raises(NotImplementedError):
        api.load_model("model.bin", device="cpu")
