"""The CUDA sample-loop kernel (K1) vs its plain PyTorch version, on a card.

Imports neither JAX nor the JAX package, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.nn import quantized as Q
from lpcnet_torch.utils.device import resolve_device

SMALL = dict(rnn_units1=64, rnn_units2=16, cond_size=32, pitch_embed_dim=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return resolve_device("cuda")


def _inputs(fused, cfg, b, dev, seed=11):
    rs = np.random.RandomState(seed)
    fs = M.init_frame_state(b, cfg, dev)
    for _ in range(3):
        f = torch.from_numpy((rs.normal(size=(b, 36)) * 0.3
                              ).astype(np.float32)).to(dev)
        fs, _, ca, cb, lpc = M.frame_network(fused, fs, f, cfg)
    return (ca.contiguous(), cb.contiguous(), lpc.contiguous(),
            M.init_sample_state(b, cfg, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_cuda_kernel_matches_plain(cuda, form, width):
    """Same inputs through the kernel and its plain version, at an odd batch
    (a ragged last block). Bars: one-step GRU states within 1e-4 (bf16
    GRU-B 1e-2); over 32
    steps f32 >=98% exact PCM, q8 >90%, bf16 finite; RNG equal; launches
    counted once per kernel call."""
    cfg = M.LPCNetConfig(**SMALL) if width == "small" else M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda),
                                    cfg)
    if form == "q8":
        kw = K.kernel_weights(Q.quantize_fused(fused), cfg)
    else:
        kw = K.kernel_weights(fused, cfg, dtype={"f32": torch.float32,
                                                 "bf16": torch.bfloat16}[form])
    ca, cb, lpc, s0 = _inputs(fused, cfg, 37, cuda)
    before = K.synthesize_frame_kernel.launches
    s1k, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
    s1p, _ = K.sample_loop_plain(kw, s0, ca, cb, lpc, 1)
    assert float((s1k.gru_a - s1p.gru_a).abs().max()) <= 1e-4
    # bf16: GRU-B's operand is h_a rounded to bf16, and an h_a one f32 bit
    # off can round to the neighbouring bf16 value
    assert float((s1k.gru_b - s1p.gru_b).abs().max()) <= (
        1e-2 if form == "bf16" else 1e-4)
    sk, pk = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 32)
    torch.cuda.synchronize()
    assert K.synthesize_frame_kernel.launches == before + 2
    sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, 32)
    assert pk.shape == (37, 32)
    assert all(torch.equal(a, b) for a, b in zip(sk.rng, sp.rng))
    assert bool(torch.isfinite(pk).all()) and bool(torch.isfinite(sk.gru_a).all())
    same = float((pk == pp).float().mean())
    if form != "bf16":
        assert same > (0.90 if form == "q8" else 0.98), same
