"""The CUDA kernels (the sample loop K1, its masked form K2, its merged form
K6, the teacher-forced run K3, the PLC-net chain K4, the GRU training
recurrence K5; K1, K2 and K3 also in the factored q8 embedding's form) vs
their plain PyTorch versions, on a card, `cli synthesis --sampling pdf` on
the card, the packet decode pool's launches, its frame network's CUDA
graph against the eager call (bit for bit), DRED's analysis graph against
the eager analysis (bit for bit), DRED's payloads framed (D1) and parsed
(D2) on the card against the native calls (byte and value for value), the
non-causal PLC pool's and
the host PLC's; and, without a card, that the trainer and the PLC entry
points refuse to start rather than run on the host.

Imports neither JAX nor the JAX package, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test marked `cuda` skips.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lpcnet_torch import api
from lpcnet_torch.codec import features as F
from lpcnet_torch.codec.decoder import LPCNetDecoder
from lpcnet_torch.kernels import gru_train as G
from lpcnet_torch.kernels import plc_chain as PC
from lpcnet_torch.kernels import sample_loop as K
from lpcnet_torch.models import lpcnet as M
from lpcnet_torch.models import plc as PM
from lpcnet_torch.nn import layers as NL
from lpcnet_torch.nn import quantized as Q
from lpcnet_torch.plc.batched import BatchedPLC
from lpcnet_torch.runtime.serving import PLCStreamPool, StreamPool
from lpcnet_torch.train import data as D
from lpcnet_torch.train import train_lpcnet as T
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


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["small", "full"])
@pytest.mark.parametrize("form", ["f32", "bf16"])
def test_cuda_merged_kernel_matches_plain(cuda, form, width):
    """K6 vs its plain version at an odd batch, K1's bars: one-step GRU
    states within 1e-4 (bf16 GRU-B 1e-2), also against K1's kernel; over 32
    steps RNG equal, f32 >=98% exact PCM and gru_a within 2e-2, bf16 finite
    with an RMS within 0.5 of the plain version's; one launch counted a
    call."""
    cfg = M.LPCNetConfig(**SMALL) if width == "small" else M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda),
                                    cfg)
    kw = K.kernel_weights(fused, cfg, dtype={"f32": torch.float32,
                                             "bf16": torch.bfloat16}[form])
    mw = K.merged_kernel_weights(kw)
    ca, cb, lpc, s0 = _inputs(fused, cfg, 37, cuda)
    before = K.synthesize_frame_merged_kernel.launches
    s1k, _ = K.synthesize_frame_merged_kernel(mw, s0, ca, cb, lpc, 1)
    s1p, _ = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, 1)
    s11, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
    tol_b = 1e-2 if form == "bf16" else 1e-4
    for other in (s1p, s11):
        assert float((s1k.gru_a - other.gru_a).abs().max()) <= 1e-4
        assert float((s1k.gru_b - other.gru_b).abs().max()) <= tol_b
    sk, pk = K.synthesize_frame_merged_kernel(mw, s0, ca, cb, lpc, 32)
    torch.cuda.synchronize()
    assert K.synthesize_frame_merged_kernel.launches == before + 2
    sp, pp = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, 32)
    assert pk.shape == (37, 32)
    assert all(torch.equal(a, b) for a, b in zip(sk.rng, sp.rng))
    assert bool(torch.isfinite(pk).all()) and bool(torch.isfinite(sk.gru_a).all())
    if form == "f32":
        assert float((pk == pp).float().mean()) >= 0.98
        assert float((sk.gru_a - sp.gru_a).abs().max()) <= 2e-2
    else:
        rms_k, rms_p = (float(x.square().mean().sqrt()) for x in (pk, pp))
        assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "bf16"])
def test_cuda_merged_kernel_at_the_decode_batch(cuda, form):
    """K6 at the decode pool's 1024 streams (bf16: two waves of K1's
    clusters of 40), full width: one step within 1e-4 of its plain version
    and of K1's kernel on the same inputs (bf16 GRU-B 1e-2); over 32 steps
    RNG equal, finite, f32 >=98 % exact PCM, bf16 RMS within 0.5; one launch
    of K6 and none of K1 counted a call."""
    cfg = M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda), cfg)
    kw = K.masked_kernel_weights(K.kernel_weights(
        fused, cfg, dtype={"f32": torch.float32, "bf16": torch.bfloat16}[form]))
    mw = K.merged_kernel_weights(kw)
    ca, cb, lpc, s0 = _inputs(fused, cfg, 1024, cuda)
    s1k, _ = K.synthesize_frame_merged_kernel(mw, s0, ca, cb, lpc, 1)
    s1p, _ = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, 1)
    s11, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
    for other in (s1p, s11):
        assert float((s1k.gru_a - other.gru_a).abs().max()) <= 1e-4
        assert float((s1k.gru_b - other.gru_b).abs().max()) <= (
            1e-2 if form == "bf16" else 1e-4)
    k1, k6 = K.synthesize_frame_kernel.launches, K.synthesize_frame_merged_kernel.launches
    sk, pk = K.synthesize_frame_merged_kernel(mw, s0, ca, cb, lpc, 32)
    torch.cuda.synchronize()
    assert (K.synthesize_frame_kernel.launches - k1,
            K.synthesize_frame_merged_kernel.launches - k6) == (0, 1)
    sp, pp = K.sample_loop_merged_plain(mw, s0, ca, cb, lpc, 32)
    assert all(torch.equal(a, b) for a, b in zip(sk.rng, sp.rng))
    assert bool(torch.isfinite(pk).all()) and bool(torch.isfinite(sk.gru_a).all())
    if form == "f32":
        assert float((pk == pp).float().mean()) >= 0.98
    else:
        rms_k, rms_p = (float(x.square().mean().sqrt()) for x in (pk, pp))
        assert abs(rms_k - rms_p) / max(rms_p, 1.0) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float", "int8"])
def test_cuda_stream_pool_decodes_through_the_selected_kernel(cuda, case):
    """StreamPool.step_packets on the card: 4 sample-loop launches a 40 ms
    tick, all K1, a float model or a q8 one, none of K6; warmup silent, then
    int16 audio; vq_mem carried."""
    fused, cfg = api.load_model(api.DEMO_MODEL_PATH, int8=case == "int8",
                                device=cuda)
    pkts = np.random.RandomState(5).randint(0, 256, (3, 6, 8)).astype(np.uint8)
    pool = StreamPool(fused, cfg, capacity=6)
    K.synthesize_frame_kernel.launches = 0
    K.synthesize_frame_merged_kernel.launches = 0
    out = [pool.step_packets({f"s{i}": pkts[t, i] for i in range(5)})
           for t in range(3)]
    assert K.synthesize_frame_merged_kernel.launches == 0
    assert K.synthesize_frame_kernel.launches == 12
    pcm = np.stack([np.stack([o[f"s{i}"] for i in range(5)]) for o in out])
    assert pcm.dtype == np.int16 and pcm.shape == (3, 5, 640)
    assert not pcm[0, :, :2 * 160].any() and pcm[1:].any(axis=(0, 2)).all()
    assert bool(pool.dec.vq_mem[:5].abs().amax(dim=1).gt(0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "unsampled"])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_cuda_masked_kernel_matches_plain(cuda, form, sampled):
    """K2 vs its plain version at full width and an odd batch, random
    advance and teacher-force masks over 32 steps. RNG equal; streams with
    advance off bit-equal with PCM 0; f32 and q8 >=98% exact PCM; with
    every advanced step teacher-forced (`unsampled`) PCM exact, q8 state too;
    launches counted once per call."""
    _masked_case(cuda, form, sampled, 37)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 130])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_cuda_masked_kernel_ragged_batches(cuda, form, b):
    """K2 at a batch of one stream (one cluster, 7 of its 8 stream slots
    empty) and at 130 (clusters of 16 streams, the last ragged), with every
    advanced step teacher-forced: the bars of the unsampled case."""
    _masked_case(cuda, form, False, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "unsampled"])
@pytest.mark.parametrize("na,nb", [(640, 16), (100, 10)])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_cuda_masked_kernel_at_other_widths(cuda, form, na, nb, sampled):
    """K2 at the LPCNet paper's 640-unit GRU-A (bf16 reads its GRU-A slice
    from L2: it does not fit a block's shared memory) and at widths that are
    no multiple of 16 (padded units), the bars of the full-width case."""
    _masked_case(cuda, form, sampled, 37, rnn_units1=na, rnn_units2=nb)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_cuda_masked_kernel_free_running_is_k1(cuda, form):
    """With every step advancing and none teacher-forced, K2 computes the
    free-running loop: K1's plain version's RNG, and its PCM at K1's bars."""
    cfg = M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda), cfg)
    kw = _bundle(fused, cfg, form)
    b, n = 37, 32
    ca, cb, lpc, s0 = _inputs(fused, cfg, b, cuda)
    on = torch.ones((b, n), dtype=torch.bool, device=cuda)
    sk, pk = K.synthesize_frame_masked_kernel(kw, s0, ca, cb, lpc, on.float(), ~on, on, n)
    torch.cuda.synchronize()
    sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, n)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert bool(torch.isfinite(pk).all())
    if form != "bf16":
        assert float((pk == pp).float().mean()) > (0.90 if form == "q8" else 0.98)


def _bundle(fused, cfg, form):
    if form == "q8":
        return K.kernel_weights(Q.quantize_fused(fused), cfg)
    return K.kernel_weights(fused, cfg, dtype={"f32": torch.float32,
                                               "bf16": torch.bfloat16}[form])


def _masked_case(cuda, form, sampled, b, **widths):
    cfg = M.LPCNetConfig(**widths)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda),
                                    cfg)
    if form == "q8":
        kw = K.kernel_weights(Q.quantize_fused(fused), cfg)
    else:
        kw = K.kernel_weights(fused, cfg, dtype={"f32": torch.float32,
                                                 "bf16": torch.bfloat16}[form])
    n = 32
    ca, cb, lpc, s0 = _inputs(fused, cfg, b, cuda)
    rs = np.random.RandomState(21)
    target = torch.from_numpy((rs.normal(size=(b, n)) * 1000
                               ).astype(np.float32)).to(cuda)
    adv = rs.rand(b, n) < 0.7
    fro = 5 if b > 5 else 0          # streams that never advance
    adv[:fro] = False
    tf = adv.copy() if not sampled else rs.rand(b, n) < 0.5
    adv, tf = torch.from_numpy(adv).to(cuda), torch.from_numpy(tf).to(cuda)
    before = K.synthesize_frame_masked_kernel.launches
    sk, pk = K.synthesize_frame_masked_kernel(kw, s0, ca, cb, lpc, target, tf,
                                              adv, n, sampled)
    torch.cuda.synchronize()
    assert K.synthesize_frame_masked_kernel.launches == before + 1
    sp, pp = K.sample_loop_masked_plain(kw, s0, ca, cb, lpc, target, tf, adv,
                                        n, sampled)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert torch.equal(sk.gru_a[:fro], s0.gru_a[:fro]) and not bool(pk[:fro].any())
    assert all(torch.equal(a[:fro], c[:fro]) for a, c in zip(sk.rng, s0.rng))
    assert not bool(pk[~adv].any())
    same = float((pk == pp).float().mean())
    if not sampled:     # target - 0.85 deemph, whatever the network says
        assert same == 1.0, same
    if form == "q8" and not sampled:
        assert torch.equal(sk.gru_a, sp.gru_a)
        assert torch.equal(sk.last_exc, sp.last_exc)
    elif form != "bf16":
        assert same >= 0.98, same
    assert bool(torch.isfinite(pk).all())


def _tf_case(fused, cfg, b, n, nblk, dev, seed=40):
    """Drain-shaped inputs of K3: conditioning blocks from consecutive
    frame-network steps, a carried signal state, targets, prefix counts with
    a stream that drains all blocks, full, partial, empty and late-starting
    streams."""
    rs = np.random.RandomState(seed)
    r = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    fs = M.init_frame_state(b, cfg, dev)
    cas, cbs, lpcs = [], [], []
    for _ in range(nblk + 2):
        fs, _, ca, cb, lpc = M.frame_network(fused, fs, r(b, 36) * 0.3, cfg)
        cas.append(ca), cbs.append(cb), lpcs.append(lpc)
    s0 = M.init_sample_state(b, cfg, dev)._replace(last_sig=r(b, 16) * 500,
                                                   deemph=r(b) * 200)
    counts = np.zeros((b, nblk), np.int32)
    counts[: b // 2] = [n] * (nblk - 1) + [n // 2]
    counts[b // 2: 3 * b // 4, 0] = n
    counts[3 * b // 4 + 2:, 1:] = n            # rows between stay frozen
    counts[0] = n                              # the longest drain: every block
    stack = lambda xs: torch.stack(xs[-nblk:], dim=1).contiguous()
    return (s0, stack(cas), stack(cbs), stack(lpcs), r(b, nblk * n) * 900,
            torch.from_numpy(counts).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(37, 32), (64, 160), (256, 32)])
@pytest.mark.parametrize("form", ["f32", "bf16", "q8"])
def test_cuda_teacher_force_kernel_matches_plain(cuda, form, b, n):
    """K3 (the teacher-forced form of K2's cluster kernel) vs its plain
    version at full width, 3 blocks: an odd batch (37, one ragged cluster),
    the PLC path's compacted drain (64 streams, 3 x 160 steps, the longest
    480) and 256 streams (clusters of 32). RNG equal; streams that run no
    step bit-equal; the signal state (closed forms, the same PyTorch code on
    both sides) equal; one step from a shared state within 1e-4 (bf16 GRU-B
    1e-2, see K1); over the run f32 within 2e-2 and q8 within 5e-2 (the JAX
    package's bars for this kernel), bf16 finite with a mean |h| error
    within 1e-2; RNG equal to K2's with the sampler off under the same
    prefix mask; one launch counted per call; a bundle without K2's packs
    refused."""
    cfg = M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda), cfg)
    if form == "q8":
        bare = K.kernel_weights(Q.quantize_fused(fused), cfg)
    else:
        bare = K.kernel_weights(fused, cfg, dtype={"f32": torch.float32,
                                                   "bf16": torch.bfloat16}[form])
    kw = K.masked_kernel_weights(bare)
    nblk = 3
    s0, ca, cb, lpc, tg, counts = _tf_case(fused, cfg, b, n, nblk, cuda)
    with pytest.raises(ValueError):
        K.teacher_force_blocks_kernel(bare, s0, ca, cb, lpc, tg, counts, n)
    one = torch.clamp(counts, max=1)
    first = (ca[:, :1].contiguous(), cb[:, :1].contiguous(), lpc[:, :1],
             tg[:, :n], one[:, :1], n)
    s1k = K.teacher_force_blocks_kernel(kw, s0, *first)
    s1p = K.teacher_force_blocks_plain(kw, s0, *first)
    assert float((s1k.gru_a - s1p.gru_a).abs().max()) <= 1e-4
    assert float((s1k.gru_b - s1p.gru_b).abs().max()) <= (
        1e-2 if form == "bf16" else 1e-4)
    before = K.teacher_force_blocks_kernel.launches
    sk = K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, counts, n)
    torch.cuda.synchronize()
    assert K.teacher_force_blocks_kernel.launches == before + 1
    sp = K.teacher_force_blocks_plain(kw, s0, ca, cb, lpc, tg, counts, n)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert all(torch.equal(a, c) for a, c in zip(sk[2:5], sp[2:5]))
    frozen = counts.sum(1) == 0
    assert bool(frozen.any())
    assert all(torch.equal(a[frozen], c[frozen]) for a, c in
               zip(sk[:5] + tuple(sk.rng), s0[:5] + tuple(s0.rng)))
    assert bool(torch.isfinite(sk.gru_a).all() and torch.isfinite(sk.gru_b).all())
    if form != "bf16":
        tol = 5e-2 if form == "q8" else 2e-2
        assert float((sk.gru_a - sp.gru_a).abs().max()) <= tol
        assert float((sk.gru_b - sp.gru_b).abs().max()) <= tol
    else:
        d = torch.cat([(sk.gru_a - sp.gru_a).abs().flatten(),
                       (sk.gru_b - sp.gru_b).abs().flatten()])
        assert float(d.mean()) <= 1e-2
    adv = torch.arange(n, device=cuda)[None, :] < counts[:, :1]
    s2, _ = K.synthesize_frame_masked_kernel(
        kw, s0, ca[:, 0].contiguous(), cb[:, 0].contiguous(),
        lpc[:, 0].contiguous(), tg[:, :n].contiguous(), adv, adv, n,
        sampled=False)
    s3 = K.teacher_force_prefix_kernel(kw, s0, ca[:, 0], cb[:, 0], lpc[:, 0],
                                       tg[:, :n], counts[:, 0])
    assert all(torch.equal(a, c) for a, c in zip(s2.rng, s3.rng))


@pytest.mark.cuda
@pytest.mark.parametrize("b,k_steps", [(37, 4), (160, 4), (256, 4), (3, 1)])
def test_cuda_plc_chain_kernel_matches_plain(cuda, b, k_steps):
    """K4 vs its plain version (clusters of 8, 16 and 32 streams): states
    after every step within 2e-5, outputs within 2e-4, frozen streams'
    states exact, two runs bit-equal, one launch counted per call; a bundle
    without the per-rank packs is refused."""
    rs = np.random.RandomState(0)
    r = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(cuda)
    params = PM.init_params(seed=3, device=cuda)
    for layer in params.values():
        layer["bias"] = r(*layer["bias"].shape) * 0.1
    cw = PC.plc_chain_weights(params)
    h1, h2 = torch.tanh(r(b, 256)), torch.tanh(r(b, 256))
    inputs = r(b, k_steps, PM.PLC_INPUT_SIZE) * 0.5
    masks = torch.from_numpy(rs.rand(b, k_steps) < 0.6).to(cuda)
    masks[0] = False
    before = PC.plc_chain_kernel.launches
    got = PC.plc_chain_kernel(cw, h1, h2, inputs, masks, k_steps)
    torch.cuda.synchronize()
    assert PC.plc_chain_kernel.launches == before + 1
    want = PC.plc_chain_plain(cw, h1, h2, inputs, masks, k_steps)
    for g, w, tol in zip(got, want, (2e-5, 2e-5, 2e-4)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= tol
    assert torch.equal(got[0][0], h1[0].expand(k_steps, -1))
    assert torch.equal(got[1][0], h2[0].expand(k_steps, -1))
    again = PC.plc_chain_kernel(cw, h1, h2, inputs, masks, k_steps)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    bare = {k: v for k, v in cw.items() if not k.startswith("k4_")}
    with pytest.raises(ValueError):
        PC.plc_chain_kernel(bare, h1, h2, inputs, masks, k_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cuda_decoder_preload_runs_the_masked_kernel(cuda, int8):
    """A teacher-forced frame through the decoder on the card goes through
    K2 with the sampler off: PCM equal to `M.synthesize_frame(preload=...)`
    (it is the target less 0.85 times the de-emphasis memory, whatever the
    network says), the RNG in lockstep, GRU-A within 2e-2 (int8: 5e-2)."""
    fused, cfg = api.load_model(None, seed=3, int8=int8, device=cuda)
    b = 5
    dec = LPCNetDecoder.from_fused(fused, cfg, b, device=cuda)
    rs = np.random.RandomState(2)
    fs, ss = dec.frame_state, dec.sample_state
    before = K.synthesize_frame_masked_kernel.launches
    for k in range(4):
        feats = (rs.normal(size=(b, 36)) * 0.3).astype(np.float32)
        target = (rs.normal(size=(b, 160)) * 2000).astype(np.float32)
        pcm = dec.synthesize(feats, preload=target)
        fs, _, ca, cb, lpc = M.frame_network(
            fused, fs, torch.from_numpy(feats).to(cuda), cfg)
        if k < cfg.lookahead:
            assert not pcm.any()
            continue
        ss, want = M.synthesize_frame(fused, ss, ca, cb, lpc,
                                      preload=torch.from_numpy(target).to(cuda))
        assert np.array_equal(pcm, want.cpu().numpy().astype(np.int16))
        assert all(torch.equal(a, c) for a, c in
                   zip(dec.sample_state.rng, ss.rng))
        assert float((dec.sample_state.gru_a - ss.gru_a).abs().max()) <= (
            5e-2 if int8 else 2e-2)
        ss = dec.sample_state
    assert K.synthesize_frame_masked_kernel.launches == before + 4
    with pytest.raises(ValueError, match="160"):
        dec.synthesize(feats, preload=target[:, :80])


@pytest.mark.cuda
def test_cuda_plc_pool_counts_its_launches(cuda):
    """A small pool on the card, blending on: K2 twice and K3 once a frame,
    K4 once a frame with the chain (`chain=True`) and never without; good
    streams pass through; a slot reset leaves the other slots' state
    alone."""
    cfg = M.LPCNetConfig(**SMALL)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=1, device=cuda), cfg)
    plc_params = api.load_plc_model(None, seed=2, device=cuda)
    rs = np.random.RandomState(3)
    frames = (rs.normal(size=(8, 5, 160)) * 2000).round().astype(np.float32)
    for chain in (False, True):
        pool = PLCStreamPool(fused, cfg, plc_params, capacity=5, chain=chain)
        K.synthesize_frame_masked_kernel.launches = 0
        K.teacher_force_blocks_kernel.launches = 0
        PC.plc_chain_kernel.launches = 0
        for k in range(8):
            lost = k in (4, 5)
            out = pool.step({f"s{i}": (None if lost and i < 2 else frames[k, i])
                             for i in range(5)})
            assert np.array_equal(out["s4"], frames[k, 4])
        assert K.synthesize_frame_masked_kernel.launches == 16
        assert K.teacher_force_blocks_kernel.launches == 8
        assert PC.plc_chain_kernel.launches == (8 if chain else 0)
        keep = pool.plc.state.sstate.gru_a[1].clone()
        pool.detach("s0")
        pool.attach("again")
        assert torch.equal(pool.plc.state.sstate.gru_a[1], keep)
        assert not bool(pool.plc.state.sstate.gru_a[0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "f32"])
def test_cuda_teacher_force_one_block_at_256(cuda, form):
    """K3 as the non-causal step's good-stream resync runs it: 256 streams,
    one block of 160 teacher-forced steps, all but a few streams running
    every step. Launch shape from `tf_launch_config` (every stream in a
    cluster); RNG and signal state equal to the plain version's; streams
    that run no step bit-equal; one step within 1e-4 (bf16 GRU-B 1e-2); over
    the block f32 within 2e-2, bf16 finite with a mean |h| error within
    1e-2 (test_cuda_teacher_force_kernel_matches_plain's bars)."""
    b, n = 256, 160
    cfg = M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda), cfg)
    kw = K.masked_kernel_weights(K.kernel_weights(
        fused, cfg, dtype={"f32": torch.float32, "bf16": torch.bfloat16}[form]))
    s0, ca, cb, lpc, tg, _ = _tf_case(fused, cfg, b, n, 1, cuda)
    counts = torch.full((b, 1), n, dtype=torch.int32, device=cuda)
    counts[::37] = 0
    f = K.ML.FORMS[form]
    lc = K.ML.tf_launch_config(b, cfg.rnn_units1, cfg.rnn_units2, f, 1,
                               K._max_clusters(cuda, f, cfg.rnn_units1, K.KIND_TF))
    assert lc["clusters"] * lc["streams"] >= b
    one = torch.clamp(counts, max=1)
    s1k = K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, one, n)
    s1p = K.teacher_force_blocks_plain(kw, s0, ca, cb, lpc, tg, one, n)
    assert float((s1k.gru_a - s1p.gru_a).abs().max()) <= 1e-4
    assert float((s1k.gru_b - s1p.gru_b).abs().max()) <= (
        1e-2 if form == "bf16" else 1e-4)
    sk = K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, counts, n)
    torch.cuda.synchronize()
    sp = K.teacher_force_blocks_plain(kw, s0, ca, cb, lpc, tg, counts, n)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert all(torch.equal(a, c) for a, c in zip(sk[2:5], sp[2:5]))
    frozen = counts[:, 0] == 0
    assert all(torch.equal(a[frozen], c[frozen]) for a, c in
               zip(sk[:5] + tuple(sk.rng), s0[:5] + tuple(s0.rng)))
    d = torch.cat([(sk.gru_a - sp.gru_a).abs().flatten(),
                   (sk.gru_b - sp.gru_b).abs().flatten()])
    assert bool(torch.isfinite(d).all())
    if form == "f32":
        assert float(d.max()) <= 2e-2
    else:
        assert float(d.mean()) <= 1e-2


@pytest.mark.cuda
def test_cuda_host_plc_core_one_stream_preload(cuda):
    """The host PLC's vocoder core on the card: its tail is K2 at one
    stream, 80 steps, the whole span teacher-forced (the preload the
    non-causal conceal and resync use) or none. Teacher-forced PCM equal to
    the plain model's on the same state, RNG in lockstep, GRU-A within
    2e-2 (the bf16 bundle); a warmup stream emits silence and stays put;
    one launch a call. Then the causal host PLC hands clean packets back."""
    from lpcnet_torch.plc.core import LPCNetCore
    from lpcnet_torch.plc.driver import make_plc, run_plc_stream
    cfg = M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=6, device=cuda), cfg)
    core = LPCNetCore(fused, cfg, batch=1, device=cuda)
    rs = np.random.RandomState(9)
    feats = lambda: (rs.normal(size=(1, 36)) * 0.3).astype(np.float32)
    before = K.synthesize_frame_masked_kernel.launches
    assert not core.synthesize(feats(), 80).any()          # warmup
    assert not core.sstate.gru_a.any()
    for _ in range(cfg.lookahead):
        core.frame_network(feats())
    for preload in (True, False, True):
        core.frame_network(feats())
        target = (rs.normal(size=(1, 80)) * 2000).astype(np.float32)
        s0 = core.sstate
        pcm = core.synthesize_tail(80, target if preload else None)
        assert pcm.shape == (1, 80) and np.isfinite(pcm).all()
        if preload:
            ss, want = M.synthesize_frame(
                core.fused, s0, core.cond_a, core.cond_b, core.lpc, n_samples=80,
                preload=torch.from_numpy(target).to(cuda))
            assert np.array_equal(pcm, want.cpu().numpy())
            assert all(torch.equal(a, c) for a, c in zip(core.sstate.rng, ss.rng))
            assert float((core.sstate.gru_a - ss.gru_a).abs().max()) <= 2e-2
    assert K.synthesize_frame_masked_kernel.launches == before + 4
    plc = make_plc("causal", device=cuda)
    tone = (3000 * np.sin(np.arange(160 * 8) * 0.08)).astype(np.int16)
    out = run_plc_stream(plc, tone, np.zeros(4, np.int32))
    assert np.array_equal(out, tone.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("remove_dc", [False, True], ids=["nc", "nc_dc"])
def test_cuda_non_causal_pool_first_frames(cuda, remove_dc):
    """The non-causal pool on the card (lookahead 0, a small vocoder, 5
    streams): K2 twice and K3 three times a frame, whatever the losses; a
    never-lost stream comes back 80 samples late (within 1 with the DC
    filter); then the two-path step runs the same traffic with that stream
    exact."""
    cfg = M.LPCNetConfig(**SMALL, lookahead=0)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=1, device=cuda), cfg)
    plc_params = api.load_plc_model(None, seed=2, device=cuda)
    rs = np.random.RandomState(3)
    frames = (rs.normal(size=(8, 5, 160)) * 2000).round().astype(np.float32)
    if remove_dc:
        frames += 300.0
    pool = PLCStreamPool(fused, cfg, plc_params, capacity=5, non_causal=True,
                         remove_dc=remove_dc)
    K.synthesize_frame_masked_kernel.launches = 0
    K.teacher_force_blocks_kernel.launches = 0
    lost = np.zeros((8, 5), bool)
    lost[4:6, :2] = True
    for k in range(8):
        out = pool.step({f"s{i}": (None if lost[k, i] else frames[k, i])
                         for i in range(5)})
        if k:
            want = np.concatenate([frames[k - 1, 4, 80:], frames[k, 4, :80]])
            assert np.abs(out["s4"] - want).max() <= (1.0 if remove_dc else 0.0)
    assert K.synthesize_frame_masked_kernel.launches == 16
    assert K.teacher_force_blocks_kernel.launches == 24
    assert bool(pool.plc.state.loss_count[:2].eq(0).all())
    with pytest.raises(ValueError, match="FEC"):
        pool.fec_add({"s0": np.zeros(20, np.float32)})
    if not remove_dc:
        two = BatchedPLC(fused, cfg, plc_params, batch=5, non_causal=True,
                         fused_step=False)
        out = two.run(frames.transpose(1, 0, 2), lost.T)
        flat = frames[:, 4].reshape(-1)
        assert np.array_equal(out[4].reshape(-1)[80:], flat[:-80])


def _gru_case(n, nin, b, t, dev, seed=5):
    rs = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32)).to(dev)
    params = {"kernel": f(nin, 3 * n) * 0.05,
              "recurrent": f(n, 3 * n) * float(0.8 / np.sqrt(n)),
              "bias": f(2, 3 * n) * 0.1}
    return params, f(b, t, nin), f(b, n) * 0.3, f(b, t, n)


def _gru_run(fn, params, x, h0, w):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x, h0 = x.clone().requires_grad_(True), h0.clone().requires_grad_(True)
    gi = G.gate_input(p, x)
    gi.retain_grad()
    hs, ht = fn(p["recurrent"], p["bias"][1], gi, h0)
    ((hs * w).sum() + (ht ** 2).sum()).backward()
    grads = {"kernel": p["kernel"].grad, "recurrent": p["recurrent"].grad,
             "bias": p["bias"].grad, "x": x.grad, "h0": h0.grad,
             "gate_in": gi.grad}
    return hs.detach(), ht.detach(), grads


@pytest.mark.cuda
@pytest.mark.parametrize("n,nin,b,t", [(384, 512, 37, 33), (16, 400, 37, 33),
                                       (64, 96, 9, 17), (384, 512, 128, 1),
                                       (32, 64, 5, 21)])
def test_cuda_gru_kernel_matches_plain(cuda, n, nin, b, t):
    """K5 forward and backward vs the plain version (autograd) at ragged
    batches and step counts. Every kernel step within 2e-5 of a plain step
    from the same state; the trajectory within 5e-3 (an h one float32 bit
    apart can round to the neighbouring bf16 operand); every gradient leaf
    within 1e-2 of its largest entry; two backward runs bit-equal; launches
    counted, forward and backward apart."""
    params, x, h0, w = _gru_case(n, nin, b, t, cuda)
    before = G.GruRecurrence.launches.copy()
    hk, htk, gk = _gru_run(G.gru_recurrence, params, x, h0, w)
    torch.cuda.synchronize()
    assert G.GruRecurrence.launches - before == {("fwd", n): 1, ("bwd", n): 1}
    hp, htp, gp = _gru_run(G.gru_recurrence_plain, params, x, h0, w)
    with torch.no_grad():
        gi = G.gate_input(params, x)
        hprev = torch.cat([h0[:, None], hk[:, :-1]], dim=1)
        step, _ = G.gru_recurrence_plain(
            params["recurrent"], params["bias"][1],
            gi.reshape(b * t, 1, 3 * n), hprev.reshape(b * t, n))
    assert float((step.reshape(b, t, n) - hk).abs().max()) <= 2e-5
    assert torch.equal(htk, hk[:, -1])
    assert float((hk - hp).abs().max()) <= 5e-3
    for k in gp:
        scale = max(1e-3, float(gp[k].abs().max()))
        assert float((gk[k] - gp[k]).abs().max()) / scale <= 1e-2, k
    _, _, gk2 = _gru_run(G.gru_recurrence, params, x, h0, w)
    assert all(torch.equal(gk[k], gk2[k]) for k in gk)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 384, 448, 640, 1024])
def test_cuda_gru_forward_at_every_width(cuda, n):
    """K5's forward on its route by width (resident clusters at 64, 384
    and 448 units, the first cluster kernel at 640 and 1024) at a ragged
    batch and step count: every step within 2e-5 of a plain step from the
    same state, the trajectory within 5e-3 of the plain version's, hT the
    last step's h, two runs bit-equal, one forward launch counted."""
    b, t = 37, 29
    params, x, h0, _ = _gru_case(n, 64, b, t, cuda)
    with torch.no_grad():
        gi = G.gate_input(params, x)
        wr, br = params["recurrent"], params["bias"][1]
        before = G.GruRecurrence.launches[("fwd", n)]
        hk, htk = G.gru_recurrence(wr, br, gi, h0)
        torch.cuda.synchronize()
        assert G.GruRecurrence.launches[("fwd", n)] == before + 1
        hk2, _ = G.gru_recurrence(wr, br, gi, h0)
        hp, _ = G.gru_recurrence_plain(wr, br, gi, h0)
        hprev = torch.cat([h0[:, None], hk[:, :-1]], dim=1)
        step, _ = G.gru_recurrence_plain(wr, br, gi.reshape(b * t, 1, 3 * n),
                                         hprev.reshape(b * t, n))
    assert G.forward_route(n) == ("resident" if n <= 448 else "cluster")
    assert float((step.reshape(b, t, n) - hk).abs().max()) <= 2e-5
    assert float((hk - hp).abs().max()) <= 5e-3
    assert torch.equal(htk, hk[:, -1]) and torch.equal(hk, hk2)


@pytest.mark.cuda
def test_cuda_gru_kernel_skips_weight_gradients_not_asked_for(cuda):
    params, x, h0, w = _gru_case(64, 96, 5, 9, cuda)
    gi = G.gate_input(params, x).requires_grad_(True)
    hs, _ = G.gru_recurrence(params["recurrent"], params["bias"][1], gi, h0)
    (hs * w).sum().backward()
    assert gi.grad is not None and bool(torch.isfinite(gi.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["default", "ss_prob", "ss_distill", "e2e",
                                 "quantize"])
def test_cuda_trainer_steps_through_the_kernels(cuda, arm):
    """A small trainer on the card, every arm: K5 launched twice a step
    forward and twice backward (the distillation teacher, which has no
    gradient, adds two forward launches and no backward one), K2 once per
    frame with scheduled sampling, loss finite."""
    kw = {"default": {}, "ss_prob": dict(ss_prob=0.25),
          "ss_distill": dict(ss_prob=0.25, ss_distill=0.5), "e2e": {},
          "quantize": dict(quantize=True, schedule_scale=0.00005)}[arm]
    e2e = arm == "e2e"
    cfg = M.LPCNetConfig(**dict(SMALL, e2e=e2e))
    rs = np.random.RandomState(0)
    b, frames = 8, 3
    sig = np.cumsum(rs.randn(b, frames * 160 + 1), axis=1).astype(np.float32) * 100
    batch = {"sig_in": sig[:, :-1].copy(), "sig_out": sig[:, 1:].copy(),
             "features": rs.randn(b, frames + 4, 20).astype(np.float32) * 0.3,
             "periods": rs.randint(33, 255, (b, frames + 4)).astype(np.int32)}
    lpc = (rs.randn(b, frames, 16) * 0.05).astype(np.float32)
    batch["rc" if e2e else "lpc"] = np.tanh(lpc) if e2e else lpc
    tr = T.Trainer(cfg, T.TrainConfig(batch_size=b, chunk_frames=frames, **kw),
                   device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    G.GruRecurrence.reset_launches()
    K.synthesize_frame_masked_kernel.launches = 0
    losses = [float(tr.train_step(batch, g)["loss"]) for _ in range(2)]
    assert np.isfinite(losses).all()
    fwd = 8 if arm == "ss_distill" else 4
    assert G.GruRecurrence.launches == {
        ("fwd", 64): fwd // 2, ("fwd", 16): fwd // 2,
        ("bwd", 64): 2, ("bwd", 16): 2}
    assert K.synthesize_frame_masked_kernel.launches == (
        2 * frames if arm.startswith("ss") else 0)
    if arm == "quantize":       # past t_end every weight sits on the grid
        w = tr.params["gru_a"]["recurrent"].detach() * 128
        assert float((w - w.round()).abs().max()) < 1e-3


@pytest.mark.cuda
def test_cuda_device_loader_matches_host_loader(cuda, tmp_path):
    """The corpus on the card, batches gathered there: equal to the host
    loader's, shuffled and held-out batches alike."""
    rs = np.random.RandomState(13)
    cf, chunks = 5, 13
    frames = chunks * cf + 8
    feats = (rs.randn(frames, 36) * 0.3).astype(np.float32)
    feats[:, 18] = rs.uniform(-1.2, 1.9, frames)
    pcm = (rs.randn(chunks * cf * 160 + 1000, 2) * 3000).astype(np.int16)
    fpath, ppath = str(tmp_path / "features.f32"), str(tmp_path / "data.s16")
    feats.tofile(fpath)
    pcm.tofile(ppath)
    kw = dict(batch_size=4, chunk_frames=cf, seed=3, holdout_batches=1)
    host = D.LPCNetLoader(ppath, fpath, **kw)
    card = D.DeviceLPCNetLoader(ppath, fpath, device=cuda, **kw)
    assert len(host) == len(card) == 2
    pairs = list(zip(host, card)) + list(zip(host.val_batches(),
                                             card.val_batches()))
    assert len(pairs) == 3
    for h, c in pairs:
        for k in h:
            assert c[k].is_cuda and np.array_equal(c[k].cpu().numpy(), h[k]), k


def test_trainer_without_cuda_raises_rather_than_train_on_the_host(tmp_path):
    """No `device` means CUDA: where it is missing, the trainer and the
    device loader raise; only `device="cpu"` runs the plain path."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.Trainer(M.LPCNetConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.DeviceLPCNetLoader(str(tmp_path / "a"), str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main([str(tmp_path / "f"), str(tmp_path / "d"), str(tmp_path / "o")])
    cfg = M.LPCNetConfig(**SMALL)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=0), cfg)
    for entry in (BatchedPLC, PLCStreamPool):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(fused, cfg, PM.init_params(1), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.load_plc_model(api.DEMO_PLC_MODEL_PATH)
    assert T.Trainer(M.LPCNetConfig(**SMALL), device="cpu").device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 384, 640, 1024])
def test_cuda_gru_backward_at_every_width(cuda, n):
    """The three-phase backward at 16, 384, 640 and 1024 units (Wr's rows
    resident in shared memory at 16 and 384, read from L2 at 640 and 1024),
    a ragged batch: every gradient leaf within 1e-2 of its largest entry
    against the plain version's autograd, two runs bit-equal."""
    params, x, h0, w = _gru_case(n, 64, 37, 24, cuda)
    _, _, gk = _gru_run(G.gru_recurrence, params, x, h0, w)
    torch.cuda.synchronize()
    _, _, gp = _gru_run(G.gru_recurrence_plain, params, x, h0, w)
    for k in gp:
        scale = max(1e-3, float(gp[k].abs().max()))
        assert float((gk[k] - gp[k]).abs().max()) / scale <= 1e-2, k
    _, _, gk2 = _gru_run(G.gru_recurrence, params, x, h0, w)
    assert all(torch.equal(gk[k], gk2[k]) for k in gk)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 384, 640])
def test_cuda_gru_gate_pass_matches_plain(cuda, n):
    """The backward's gate pass alone: z and the four factors within 1e-5
    of `gate_pass_plain` (zrec's float32 sums in another order on the
    tensor cores)."""
    params, x, h0, _ = _gru_case(n, 64, 37, 24, cuda)
    with torch.no_grad():
        gi = G.gate_input(params, x)
        hs, _ = G.gru_recurrence(params["recurrent"], params["bias"][1], gi, h0)
        got = G.gate_pass_kernel(params["recurrent"], params["bias"][1], gi, h0, hs)
        want = G.gate_pass_plain(params["recurrent"], params["bias"][1], gi, h0, hs)
    for a, c in zip(got, want):
        assert float((a - c).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 130, 1024])
@pytest.mark.parametrize("form", ["bf16", "q8"])
def test_cuda_free_running_k1_ragged_batches(cuda, form, b):
    """K1 in bf16 and q8 is the cluster kernel's free-running form: one
    launch counted, one step within 1e-4 (bf16 h_b 1e-2), RNG equal, q8
    >90 % exact PCM and bf16 RMS within 0.5 of the plain version's, at one
    stream, one wave and two waves of clusters."""
    cfg = M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda), cfg)
    kw = K.masked_kernel_weights(_bundle(fused, cfg, form))
    ca, cb, lpc, s0 = _inputs(fused, cfg, b, cuda)
    s1k, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
    s1p, _ = K.sample_loop_plain(kw, s0, ca, cb, lpc, 1)
    assert float((s1k.gru_a - s1p.gru_a).abs().max()) <= 1e-4
    assert float((s1k.gru_b - s1p.gru_b).abs().max()) <= (1e-2 if form == "bf16" else 1e-4)
    before = K.synthesize_frame_kernel.launches
    sk, pk = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 32)
    torch.cuda.synchronize()
    assert K.synthesize_frame_kernel.launches == before + 1
    sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, 32)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert bool(torch.isfinite(pk).all())
    if form == "q8":
        assert float((pk == pp).float().mean()) > 0.90
    else:
        rk, rp = (float(v.square().mean().sqrt()) for v in (pk, pp))
        assert abs(rk - rp) / max(rp, 1.0) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["cluster", "first"])
@pytest.mark.parametrize("b", [4, 1024])
def test_cuda_f32_k1_matches_plain(cuda, b, route):
    """K1 in f32 on each of its kernels (the cluster kernel on 16-block
    clusters with GRU-A's f32 slice resident; the first design) at the
    validator's 4 streams and at 1024: one step within 1e-4, RNG equal,
    >= 98 % exact PCM over 32 steps with max|gru_a| err <= 2e-2 (the JAX
    bar), >= 95 % over a whole 160-step frame from a live state; the
    wrapper takes `f32_route`'s kernel and counts one launch."""
    cfg = M.LPCNetConfig()
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda), cfg)
    kw = K.masked_kernel_weights(K.kernel_weights(fused, cfg, dtype=torch.float32))
    ca, cb, lpc, s0 = _inputs(fused, cfg, b, cuda)
    run = lambda st, n: K._launch(kw, st, ca, cb, lpc, n, route=route)
    s1k, _ = run(s0, 1)
    s1p, _ = K.sample_loop_plain(kw, s0, ca, cb, lpc, 1)
    assert float((s1k.gru_a - s1p.gru_a).abs().max()) <= 1e-4
    assert float((s1k.gru_b - s1p.gru_b).abs().max()) <= 1e-4
    sk, pk = run(s0, 32)
    torch.cuda.synchronize()
    sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, 32)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert float((pk == pp).float().mean()) >= 0.98
    assert float((sk.gru_a - sp.gru_a).abs().max()) <= 2e-2
    live, _ = K.sample_loop_plain(kw, s0, ca, cb, lpc)
    sk, pk = run(live, 160)
    torch.cuda.synchronize()
    sp, pp = K.sample_loop_plain(kw, live, ca, cb, lpc)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert bool(torch.isfinite(pk).all()) and float((pk == pp).float().mean()) >= 0.95
    before = K.synthesize_frame_kernel.launches
    K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 8)
    assert K.synthesize_frame_kernel.launches == before + 1
    want = K.f32_route(b, 384, 16, K._max_clusters(cuda, 0, 384, K.KIND_FREE))
    assert want in ("cluster", "first")


def _factored_bundle(cfg, cuda):
    """A q8 bundle of the factored embedding (K2's packs built), from
    seeded weights at `cfg`; asserted to carry the factored operands."""
    fused = M.fuse_inference_params(M.init_params(cfg, seed=4, device=cuda), cfg)
    prev = K.set_emb("factored")
    try:
        kw = K.masked_kernel_weights(K.kernel_weights(Q.quantize_fused(fused), cfg))
    finally:
        K.set_emb(prev)
    assert K.is_factored(kw) and kw["k2_f"].is_cuda
    return fused, kw


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 130, 1024])
def test_cuda_factored_k1_matches_plain(cuda, b):
    """K1 in the factored q8 form at one stream, one wave and two waves of
    clusters: one launch counted, one step within 1e-4, RNG equal, >90 %
    exact PCM over 32 steps (the composed q8 form's bars)."""
    cfg = M.LPCNetConfig()
    fused, kw = _factored_bundle(cfg, cuda)
    ca, cb, lpc, s0 = _inputs(fused, cfg, b, cuda)
    s1k, _ = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 1)
    s1p, _ = K.sample_loop_plain(kw, s0, ca, cb, lpc, 1)
    assert float((s1k.gru_a - s1p.gru_a).abs().max()) <= 1e-4
    assert float((s1k.gru_b - s1p.gru_b).abs().max()) <= 1e-4
    before = K.synthesize_frame_kernel.launches
    sk, pk = K.synthesize_frame_kernel(kw, s0, ca, cb, lpc, 32)
    torch.cuda.synchronize()
    assert K.synthesize_frame_kernel.launches == before + 1
    sp, pp = K.sample_loop_plain(kw, s0, ca, cb, lpc, 32)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert bool(torch.isfinite(pk).all())
    assert float((pk == pp).float().mean()) > 0.90


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "unsampled"])
@pytest.mark.parametrize("b", [37, 130])
def test_cuda_factored_k2_matches_plain(cuda, b, sampled):
    """K2 in the factored q8 form under random mode words: RNG equal, frozen
    streams bit-equal with PCM 0, >=98 % exact PCM; with every advanced
    step teacher-forced PCM, h_a and the excitation exact."""
    cfg = M.LPCNetConfig()
    fused, kw = _factored_bundle(cfg, cuda)
    n = 32
    ca, cb, lpc, s0 = _inputs(fused, cfg, b, cuda)
    rs = np.random.RandomState(23)
    target = torch.from_numpy((rs.normal(size=(b, n)) * 1000).astype(np.float32)).to(cuda)
    adv = rs.rand(b, n) < 0.7
    adv[:5] = False
    tf = adv.copy() if not sampled else rs.rand(b, n) < 0.5
    adv, tf = torch.from_numpy(adv).to(cuda), torch.from_numpy(tf).to(cuda)
    sk, pk = K.synthesize_frame_masked_kernel(kw, s0, ca, cb, lpc, target, tf, adv, n,
                                              sampled)
    torch.cuda.synchronize()
    sp, pp = K.sample_loop_masked_plain(kw, s0, ca, cb, lpc, target, tf, adv, n, sampled)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert torch.equal(sk.gru_a[:5], s0.gru_a[:5]) and not bool(pk[~adv].any())
    same = float((pk == pp).float().mean())
    if sampled:
        assert same >= 0.98, same
    else:
        assert same == 1.0 and torch.equal(sk.gru_a, sp.gru_a)
        assert torch.equal(sk.last_exc, sp.last_exc)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nblk", [(37, 32, 3), (64, 160, 3), (256, 160, 1)])
def test_cuda_factored_k3_matches_plain(cuda, b, n, nblk):
    """K3 in the factored q8 form: one launch counted, RNG and the signal
    state equal, streams that run no step bit-equal, one step within 1e-4,
    the run within 5e-2 (the composed q8 form's bars)."""
    cfg = M.LPCNetConfig()
    fused, kw = _factored_bundle(cfg, cuda)
    s0, ca, cb, lpc, tg, counts = _tf_case(fused, cfg, b, n, nblk, cuda)
    one = torch.clamp(counts, max=1)
    first = (ca[:, :1].contiguous(), cb[:, :1].contiguous(), lpc[:, :1], tg[:, :n],
             one[:, :1], n)
    s1k = K.teacher_force_blocks_kernel(kw, s0, *first)
    s1p = K.teacher_force_blocks_plain(kw, s0, *first)
    assert float((s1k.gru_a - s1p.gru_a).abs().max()) <= 1e-4
    assert float((s1k.gru_b - s1p.gru_b).abs().max()) <= 1e-4
    before = K.teacher_force_blocks_kernel.launches
    sk = K.teacher_force_blocks_kernel(kw, s0, ca, cb, lpc, tg, counts, n)
    torch.cuda.synchronize()
    assert K.teacher_force_blocks_kernel.launches == before + 1
    sp = K.teacher_force_blocks_plain(kw, s0, ca, cb, lpc, tg, counts, n)
    assert all(torch.equal(a, c) for a, c in zip(sk.rng, sp.rng))
    assert all(torch.equal(a, c) for a, c in zip(sk[2:5], sp[2:5]))
    frozen = counts.sum(1) == 0
    assert all(torch.equal(a[frozen], c[frozen]) for a, c in
               zip(sk[:5] + tuple(sk.rng), s0[:5] + tuple(s0.rng)))
    assert float((sk.gru_a - sp.gru_a).abs().max()) <= 5e-2
    assert float((sk.gru_b - sp.gru_b).abs().max()) <= 5e-2


@pytest.mark.cuda
def test_cuda_cli_synthesis_pdf_runs_on_the_card(cuda, tmp_path):
    """`cli synthesis --sampling pdf` on its default device (the card): int16
    output, silent while the lookahead fills, not after."""
    from lpcnet_torch import cli
    rs = np.random.RandomState(3)
    f = (rs.normal(size=(4, 36)) * 0.3).astype(np.float32)
    f[:, 19] = 0.5
    fin, fout = tmp_path / "f.f32", tmp_path / "o.pcm"
    f.tofile(fin)
    cli.main(["synthesis", str(fin), str(fout), "--sampling", "pdf"])
    out = np.fromfile(fout, np.int16)
    assert out.shape == (640,) and not out[:320].any() and out[320:].any()


def _recording(net, log):
    """`net` (a frame network callable) that also logs clones of each
    call's new state, cond_a, cond_b and lpc."""
    def call(fused, st, feats, cfg):
        out = net(fused, st, feats, cfg)
        log.append([t.clone() for t in (*out[0], *out[2:])])
        return out
    return call


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_cuda_frame_graph_decode_pool_equals_eager(cuda):
    """The decode pool at 1024 streams with the q8 demo vocoder, its frame
    network replayed as one CUDA graph, against the same pool running it
    eagerly, over 8 ticks of packets with a slot reset (detach and attach)
    before tick 3 and the frame state snapshotted before tick 2 and
    restored before tick 5: every frame's cond_a, cond_b, lpc and frame
    state, the PCM and the end state bit for bit; one capture, and every
    CUDA frame a replay (the first included)."""
    path = str(Path(api.DEMO_MODEL_PATH).parent / "demo_model_q.npz")
    fused, cfg = api.load_model(path, int8=True, device=cuda)
    b, ticks = 1024, 8
    pkts = np.random.RandomState(7).randint(0, 256, (ticks, b, 8)
                                            ).astype(np.uint8)
    sids = [f"s{i}" for i in range(b)]
    pools = {"graph": StreamPool(fused, cfg, capacity=b),
             "eager": StreamPool(fused, cfg, capacity=b)}
    graph = pools["graph"].dec.frame_graph
    logs = {"graph": [], "eager": []}
    pools["graph"].dec.frame_graph = _recording(graph, logs["graph"])
    pools["eager"].dec.frame_graph = _recording(M.frame_network, logs["eager"])
    snaps = {}
    for t in range(ticks):
        pcm = {}
        for name, pool in pools.items():
            dec = pool.dec
            if t == 2:
                snaps[name] = [x.clone() for x in dec.frame_state]
            if t == 3:
                pool.detach("s5")
                pool.attach("s5")
            if t == 5:
                dec.frame_state = M.FrameState(*(x.clone()
                                                 for x in snaps[name]))
            out = pool.step_packets(dict(zip(sids, pkts[t])))
            pcm[name] = np.stack([out[s] for s in sids])
        assert np.array_equal(pcm["graph"], pcm["eager"]), t
        for k, (g, e) in enumerate(zip(logs["graph"], logs["eager"])):
            assert _same(g, e), (t, k)
        assert len(logs["graph"]) == len(logs["eager"]) == 4
        logs["graph"].clear()
        logs["eager"].clear()
    assert _same(pools["graph"].dec.frame_state, pools["eager"].dec.frame_state)
    assert _same(pools["graph"].dec.sample_state[:5],
                 pools["eager"].dec.sample_state[:5])
    assert (graph.captures, graph.replays, graph.eager) == (1, 4 * ticks, 0)


@pytest.mark.cuda
def test_cuda_frame_graph_follows_what_it_read(cuda):
    """A `FrameNetworkGraph` on the card against `frame_network`, frame
    after frame, bit for bit: a write into a weight tensor reaches the
    graph without a capture; a weight tensor replaced, the "cref"
    activations and the return to "exact" each capture anew; inside a
    caller's CUDA graph capture a call runs eagerly (counted), and the
    caller's graph replays to the same values."""
    cfg = M.LPCNetConfig(**SMALL, lpc_gamma=0.9)
    fused = M.fuse_inference_params(M.init_params(cfg, seed=1, device=cuda),
                                    cfg)
    b = 37
    rs = np.random.RandomState(8)
    g = M.FrameNetworkGraph()
    st_e = st_g = M.init_frame_state(b, cfg, cuda)

    def frame():
        nonlocal st_e, st_g
        f = torch.from_numpy((rs.normal(size=(b, 36)) * 0.3
                              ).astype(np.float32)).to(cuda)
        want = M.frame_network(fused, st_e, f, cfg)
        got = g(fused, st_g, f, cfg)
        assert _same(got[0], want[0]) and _same(got[1:], want[1:])
        st_e, st_g = want[0], got[0]

    frame()
    frame()
    assert (g.captures, g.replays) == (1, 2)
    fused["feature_dense1"]["bias"].add_(0.01)
    frame()
    assert g.captures == 1
    fused["feature_dense2"] = {k: v * 0.5
                               for k, v in fused["feature_dense2"].items()}
    frame()
    assert g.captures == 2
    with NL.activation_impl("cref"):
        frame()
        frame()
        assert g.captures == 3
    frame()
    assert (g.captures, g.replays, g.eager) == (4, 7, 0)
    f = torch.from_numpy((rs.normal(size=(b, 36)) * 0.3).astype(np.float32)
                         ).to(cuda)
    st = M.FrameState(*(x.clone() for x in st_e))
    want = M.frame_network(fused, st, f, cfg)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        got = g(fused, st, f, cfg)
    outer.replay()
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1:], want[1:])
    assert (g.captures, g.replays, g.eager) == (4, 7, 1)


@pytest.mark.cuda
def test_cuda_decoder_preload_frames_replay_the_graph(cuda):
    """Teacher-forced (`preload`) and free frames alternate through a
    decoder on the card: the frame network replays the graph for both, and
    the PCM and the frame state equal a twin decoder's that runs the frame
    network eagerly."""
    fused, cfg = api.load_model(None, seed=3, int8=True, device=cuda)
    b = 5
    dec = LPCNetDecoder.from_fused(fused, cfg, b, device=cuda)
    twin = LPCNetDecoder.from_fused(fused, cfg, b, device=cuda)
    twin.frame_graph = M.frame_network
    rs = np.random.RandomState(9)
    for k in range(6):
        feats = (rs.normal(size=(b, 36)) * 0.3).astype(np.float32)
        target = ((rs.normal(size=(b, 160)) * 2000).astype(np.float32)
                  if k % 2 else None)
        assert np.array_equal(dec.synthesize(feats, preload=target),
                              twin.synthesize(feats, preload=target)), k
        assert _same(dec.frame_state, twin.frame_state), k
    g = dec.frame_graph
    assert (g.captures, g.replays, g.eager) == (1, 6, 0)


def _dred_speech(b, ticks, seed):
    """[ticks, b, 320] int16: a harmonic voice a stream with noise."""
    rs = np.random.RandomState(seed)
    t = np.arange(ticks * 320) / 16000.0
    f0 = rs.uniform(90, 220, (b, 1))
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rs.uniform(2, 5, (b, 1)) * t)
    pcm = np.round(4000 * env * sig + 60 * rs.randn(b, len(t)))
    return pcm.astype(np.int16).reshape(b, ticks, 320).transpose(1, 0, 2).copy()


@pytest.mark.cuda
def test_cuda_pvq_search_batch_equals_pvq_search(cuda):
    """The device PVQ search at 4096 rows (random scales, exact ties,
    zeros) equals numpy's `pvq_search` row by row."""
    from lpcnet_torch.dred import entropy as EC
    rs = np.random.RandomState(21)
    x = rs.randn(4096, 24) * np.exp(rs.uniform(-6, 3, (4096, 1)))
    x[:64] = np.sign(rs.randn(64, 24))
    x[64:72] = 0.0
    got = EC.pvq_search_batch(torch.from_numpy(x).to(cuda), 82).cpu().numpy()
    assert np.array_equal(got, np.stack([EC.pvq_search(r, 82) for r in x]))


@pytest.mark.cuda
def test_cuda_dred_pool_at_1024_streams(cuda):
    """`DREDEncoderPool` on the card at 1024 streams with the demo RDO-VAE,
    30 ticks of speech: a payload a stream from the 26th tick, framed on
    the card once a tick (no relaunch), with no native call and no payload
    coded in Python; the pulses equal
    `pvq_search` of the card's own initial states; 16 streams' payloads
    equal `encode_payload`'s of the tick's symbols and decode back to them;
    the first 8 streams' latents within 1e-4 of a CPU pool's."""
    from lpcnet_torch.dred import entropy as EC
    params, rcfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device=cuda)
    cpu_params, _ = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device="cpu")
    b, ticks = 1024, 30
    audio = _dred_speech(b, ticks, seed=5)
    pool = api.DREDEncoderPool(params, rcfg, streams=b, device=cuda)
    host = api.DREDEncoderPool(cpu_params, rcfg, streams=8, device="cpu")
    for t in range(ticks):
        framings = pool.stats["device_framings"]
        out = pool.step_pcm(audio[t])
        host.step_pcm(audio[t, :8])
        gap = float((pool.enc.z_window[-1][:8].cpu() - host.enc.z_window[-1]).abs().max())
        assert gap <= 1e-4, (t, gap)
        if t < 25:
            assert out is None
            continue
        assert len(out["payloads"]) == b and pool.stats["device_framings"] == framings + 1
        st = pool.enc.state_window[-1].double().cpu().numpy()
        assert np.array_equal(out["pulses"], np.stack([EC.pvq_search(s, 82) for s in st]))
    assert pool.stats["python_payloads"] == 0 and pool.stats["payloads"] == 5 * b
    assert pool.stats["native_calls"] == 0 and pool.stats["device_retries"] == 0
    for i in range(0, b, b // 16):
        want = EC.encode_payload(out["zq"][i].astype(np.int32), out["pulses"][i],
                                 9, 15, pool.enc.fixed_stats, 82)
        assert out["payloads"][i] == want
        zq, pulses, _ = EC.decode_payload(want, pool.enc.fixed_stats, 24, 82)
        assert np.array_equal(zq, out["zq"][i]) and np.array_equal(pulses, out["pulses"][i])


@pytest.mark.cuda
def test_cuda_dred_decoder_pool_at_1024_streams(cuda):
    """DRED's receiving side on the card: a 1024-stream encoder pool's
    payloads through `DREDDecoderPool` twice (the stage reused), one parse
    on the card (one D2 launch) a tick, none native and none in Python;
    the card's rows equal the native call's, value for value, and the
    features equal, bit for bit, those decoded from the native call's
    rows; the parse equals the encoder's symbols and pulses and, for 16
    streams, `entropy.decode_payload`'s levels; 8 streams' features within
    1e-4 of their scale of a CPU decoder's."""
    from lpcnet_torch.dred import entropy as EC
    from lpcnet_torch.kernels import dred_parse as DX
    from lpcnet_torch.runtime.bindings import runtime
    params, rcfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device=cuda)
    cpu_params, _ = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device="cpu")
    b = 1024
    audio = _dred_speech(b, 27, seed=6)
    enc = api.DREDEncoderPool(params, rcfg, streams=b, device=cuda)
    for t in range(27):
        out = enc.step_pcm(audio[t])
    pool = api.DREDDecoderPool(params, rcfg, streams=b, device=cuda)
    launches = DX.Parsing.launches
    first = pool.step_payloads(out["payloads"]).clone()
    assert DX.Parsing.launches == launches + 1
    feats = pool.step_payloads(out["payloads"])
    torch.cuda.synchronize()
    assert feats.device.type == "cuda" and feats.shape == (b, 104, 20)
    assert torch.equal(first, feats)
    assert pool.stats == {"device_parses": 2, "payloads_parsed": 2 * b,
                          "latents_decoded": 2 * 26 * b}
    assert DX.Parsing.launches == launches + 2
    assert pool.stats["native_parses"] == pool.stats["python_parses"] == 0
    stats = pool.dec.fixed_stats
    native = runtime.dred_parse_payloads(out["payloads"].data, out["payloads"].lengths,
                                         26, 80, 24, 82, stats["p0_q15"], stats["r_q15"])
    assert np.array_equal(pool.dec._rows.cpu().numpy(), native)
    again = pool.dec.decode_rows(torch.from_numpy(native).to(cuda))
    assert torch.equal(again, feats)
    zq, pulses, q_ids = (t.cpu().numpy() for t in pool.dec.parsed)
    assert np.array_equal(zq, out["zq"]) and np.array_equal(pulses, out["pulses"])
    for i in range(0, b, b // 16):
        _, _, q = EC.decode_payload(out["payloads"][i], pool.dec.fixed_stats, 24, 82)
        assert np.array_equal(q_ids[i], q)
    want = api.DREDDecoder(cpu_params, rcfg, device="cpu").decode_payloads(
        [out["payloads"][i] for i in range(8)])
    gap = float((feats[:8].cpu() - want).abs().max()) / float(want.abs().max())
    assert gap <= 1e-4, gap


def _dred_parse_batch(rs, b, n_lat, stats, mags=1.5):
    """b payloads of n_lat latents, each framed by `encode_payload` at its
    own (q0, q1) (every fifth with q0 = q1); streams 0 and 1 carry the PVQ
    indices 0 and V(24, 82) - 1, the rest `pvq_search`'s pulses."""
    from lpcnet_torch.dred import entropy as EC
    from lpcnet_torch.models import rdovae as RV
    v = RV.pvq_codebook_size(24, 82)
    out = []
    for i in range(b):
        q0, q1 = (int(q) for q in rs.randint(0, 16, 2))
        q1 = q0 if i % 5 == 0 else q1
        pulses = (EC.pvq_decode_index(0 if i == 0 else v - 1, 24, 82) if i < 2
                  else EC.pvq_search(rs.randn(24), 82))
        if mags == "max":
            zq = rs.choice([-255, 255], (n_lat, 80))
        else:
            zq = np.round(rs.laplace(0, mags, (n_lat, 80))).astype(np.int64)
        out.append(EC.encode_payload(zq, pulses, q0, q1, stats, 82))
    return EC.Payloads.of(out)


def _q15_table(rs, clamps=False):
    pick = (lambda: rs.choice([0, 1, 32767, 32768, 65535], (16, 80))) if clamps \
        else (lambda: rs.randint(1000, 32000, (16, 80)))
    return {"p0_q15": pick().astype(np.uint16), "r_q15": pick().astype(np.uint16)}


# (streams, latents, the symbols' Laplace scale or "max", clamping tables)
PARSE_CASES = {"b1": (1, 26, 1.5, False), "b33": (33, 26, 1.5, False),
               "l1": (33, 1, 1.5, False), "l2": (33, 2, 3.0, False),
               "pm255": (4, 26, "max", False), "clamps": (33, 26, 3.0, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_cuda_dred_parse_kernel_equals_the_native_call(cuda, case):
    """D2's rows are the native call's, value for value: one stream and 33
    (mixed (q0, q1), q0 = q1 among them), 1, 2 and 26 latents, the PVQ
    indices 0 and V - 1, symbols at MAX_MAG (payloads of ~5 KB), p0 and r
    at the clamps (0, 32768, 65535); one launch a parse; a second batch of
    other bytes through the same stage."""
    from lpcnet_torch.kernels import dred_parse as DX
    from lpcnet_torch.runtime.bindings import runtime
    b, n_lat, mags, clamps = PARSE_CASES[case]
    rs = np.random.RandomState(len(case) + 30)
    stats = _q15_table(rs, clamps)
    p = DX.Parsing(stats, b, n_lat, 80, 24, 82, cuda)
    for _ in range(2):
        payloads = _dred_parse_batch(rs, b, n_lat, stats, mags)
        launches = DX.Parsing.launches
        rows = p(payloads).cpu().numpy()
        assert DX.Parsing.launches == launches + 1
        want = runtime.dred_parse_payloads(payloads.data, payloads.lengths, n_lat, 80,
                                           24, 82, stats["p0_q15"], stats["r_q15"])
        assert np.array_equal(rows, want)


@pytest.mark.cuda
def test_cuda_dred_parse_refuses_before_the_launch(cuda):
    """A payload at fault raises ValueError naming it, and nothing is
    launched; the next sound batch parses."""
    from lpcnet_torch.dred import entropy as EC
    from lpcnet_torch.kernels import dred_parse as DX
    rs = np.random.RandomState(41)
    stats = _q15_table(rs)
    payloads = list(_dred_parse_batch(rs, 9, 26, stats))
    p = DX.Parsing(stats, 9, 26, 80, 24, 82, cuda)
    bad = payloads[:5] + [bytes([0x20]) + payloads[5][1:]] + payloads[6:]
    launches = DX.Parsing.launches
    with pytest.raises(ValueError, match="payload 5 is"):
        p(EC.Payloads.of(bad))
    assert DX.Parsing.launches == launches
    assert p(EC.Payloads.of(payloads)).shape == (9, 26 * 81 + 24)


@pytest.mark.cuda
def test_cuda_cli_dred_payload_decode_is_the_native_parses_decode(cuda, tmp_path):
    """`cli dred-payload-decode` on the card (one D2 launch at B=1): its
    features are, bit for bit, those the decoder gives from the native
    parse's row of the same payload."""
    from lpcnet_torch import cli
    from lpcnet_torch.dred import coder as DC
    from lpcnet_torch.kernels import dred_parse as DX
    from lpcnet_torch.runtime.bindings import runtime
    params, rcfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device=cuda)
    enc = DC.DREDEncoder(params, rcfg, device=cuda)
    rs = np.random.RandomState(17)
    for _ in range(56):
        enc.add_feature_frame((rs.randn(1, 20) * 2).astype(np.float32))
    payload = enc.produce_payload(52, 9, 15)["payloads"][0]
    src, dst = tmp_path / "p.bin", tmp_path / "f.f32"
    src.write_bytes(payload)
    launches = DX.Parsing.launches
    cli.main(["dred-payload-decode", str(src), str(dst), "--model",
              api.DEMO_RDOVAE_MODEL_PATH])
    assert DX.Parsing.launches == launches + 1
    got = np.fromfile(dst, np.float32).reshape(104, 20)
    dec = DC.DREDDecoder(params, rcfg, device=cuda)
    stats = dec.fixed_stats
    row = runtime.dred_parse_payloads(payload, np.array([len(payload)]), 26, 80, 24, 82,
                                      stats["p0_q15"], stats["r_q15"])
    want = dec.decode_rows(torch.from_numpy(row).to(cuda))[0].cpu().numpy()
    assert np.array_equal(got, want)


def _frame_on_card(zq, pulses, p0, r, k, dev, q0=9, q1=15):
    """`kernels.dred_payload` on numpy symbols [B, L, D], pulses [B, S] and
    p0/r [L, D]: (the payloads' bytes, lengths, relaunches), the launches
    held to one plus the relaunches."""
    from lpcnet_torch.kernels import dred_payload as DP
    b, n_lat, dim = zq.shape
    stats = {"p0_q15": np.asarray(p0, np.uint16), "r_q15": np.asarray(r, np.uint16)}
    f = DP.Framing(stats, b, n_lat, dim, pulses.shape[1], k, dev)
    f.stage(torch.from_numpy(zq.astype(np.float32)).to(dev),
            torch.from_numpy(pulses.astype(np.int64)).to(dev), torch.zeros(b, device=dev))
    launches = DP.Framing.launches
    f.launch(q0, q1, np.arange(n_lat))
    _, lengths, _ = f.fetch()
    data, lengths = f.payloads(lengths)
    assert DP.Framing.launches == launches + 1 + f.retries
    return data, lengths, f.retries


def _pulses(rs, b, k=82, n=24):
    from lpcnet_torch.dred import entropy as EC
    return np.stack([EC.pvq_search(v, k) for v in rs.randn(b, n)]).astype(np.int16)


def _laplace(rs, b, scale=1.5):
    return np.round(rs.laplace(0, scale, (b, 26, 80))).astype(np.int16)


def _q15(rs, lo=1000, hi=32000):
    return rs.randint(lo, hi, (26, 80))


# (symbols, pulses, p0, r) of each case; "carry" makes the backward carry
# ripple through 0xFF bytes (~280 times in its 64 streams), "pm255"
# passes the first slot (every symbol at MAX_MAG) and "clamps" too, holding
# p0 and r at 0, 32768 and 65535 (read as 1 and 32767)
PAYLOAD_CASES = {
    "b1": lambda rs: (_laplace(rs, 1), _pulses(rs, 1), _q15(rs), _q15(rs)),
    "b33": lambda rs: (_laplace(rs, 33), _pulses(rs, 33), _q15(rs), _q15(rs)),
    "b1000": lambda rs: (_laplace(rs, 1000), _pulses(rs, 1000), _q15(rs), _q15(rs)),
    "zeros": lambda rs: (np.zeros((64, 26, 80), np.int16), _pulses(rs, 64),
                         _q15(rs), _q15(rs)),
    "pm255": lambda rs: ((rs.choice([-1, 1], (8, 26, 80)) * 255).astype(np.int16),
                         _pulses(rs, 8), _q15(rs), _q15(rs)),
    "carry": lambda rs: (rs.choice([-1, 1], (64, 26, 80)).astype(np.int16),
                         _pulses(rs, 64), np.ones((26, 80)), np.full((26, 80), 32767)),
    "clamps": lambda rs: (_laplace(rs, 64, 3.0), _pulses(rs, 64),
                          rs.choice([0, 32768, 65535], (26, 80)),
                          rs.choice([0, 32768, 65535], (26, 80))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_cuda_dred_payload_kernel_equals_the_native_call(cuda, case):
    """The card's payloads are byte for byte `runtime.dred_frame_payloads`'
    (ragged stream counts, zeros, MAX_MAG's relaunch, carries, clamps)."""
    from lpcnet_torch.runtime.bindings import runtime
    zq, pulses, p0, r = PAYLOAD_CASES[case](np.random.RandomState(len(case)))
    data, lengths, retries = _frame_on_card(zq, pulses, p0, r, 82, cuda)
    want, want_lengths, calls = runtime.dred_frame_payloads(
        zq, pulses, 9, 15, np.asarray(p0, np.uint16), np.asarray(r, np.uint16), 82)
    assert data == want and np.array_equal(lengths, want_lengths)
    if case in ("pm255", "clamps"):
        assert retries > 0 and calls > 1


@pytest.mark.cuda
def test_cuda_dred_payload_kernel_refuses_pulses_off_k(cuda):
    rs = np.random.RandomState(12)
    pulses = _pulses(rs, 33)
    pulses[20, 3] += 1
    with pytest.raises(ValueError):
        _frame_on_card(_laplace(rs, 33), pulses, _q15(rs), _q15(rs), 82, cuda)


@pytest.mark.cuda
def test_cuda_dred_payload_kernel_on_the_demo_rdovae_at_1024(cuda):
    """The demo RDO-VAE's own symbols at 1024 streams, 26 latents of 80:
    the pool's payloads (one device framing) and the kernel's alone equal
    the native call's on the same symbols and pulses."""
    from lpcnet_torch.dred import entropy as EC
    from lpcnet_torch.runtime.bindings import runtime
    params, rcfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device=cuda)
    b = 1024
    audio = _dred_speech(b, 26, seed=8)
    pool = api.DREDEncoderPool(params, rcfg, streams=b, device=cuda)
    for t in range(26):
        out = pool.step_pcm(audio[t])
    assert pool.stats["device_framings"] == 1 and pool.stats["native_calls"] == 0
    q = EC.payload_q_ids(26, 9, 15)
    st = pool.enc.fixed_stats
    p0, r = st["p0_q15"][q], st["r_q15"][q]
    want, lengths, _ = runtime.dred_frame_payloads(out["zq"], out["pulses"], 9, 15,
                                                   p0, r, 82)
    assert out["payloads"].data == want and np.array_equal(out["payloads"].lengths,
                                                           lengths)
    data, alone, retries = _frame_on_card(out["zq"], out["pulses"], p0, r, 82, cuda)
    assert data == want and np.array_equal(alone, lengths) and retries == 0


@pytest.mark.cuda
def test_cuda_dred_encoder_counts_relaunches(cuda, monkeypatch):
    """An encoder whose symbols all sit at MAX_MAG: the payloads need a
    larger slot, the encoder counts the relaunches in `device_retries`,
    and the bytes are the native call's."""
    from lpcnet_torch.dred import coder as DC
    from lpcnet_torch.dred import entropy as EC
    from lpcnet_torch.runtime.bindings import runtime
    params, rcfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device=cuda)
    enc = DC.DREDEncoder(params, rcfg, batch=5, device=cuda)
    feats = np.random.RandomState(3).randn(4, 5, 20).astype(np.float32) * 0.3
    for f in feats:
        enc.add_feature_frame(f)
    quantize = DC.quantize_latents

    def at_max(params, z, q_ids, cfg):
        zq, rates = quantize(params, z, q_ids, cfg)
        sign = torch.where(torch.arange(zq.numel(), device=zq.device) % 3 == 0, -1.0, 1.0)
        return sign.reshape(zq.shape) * EC.MAX_MAG, rates

    monkeypatch.setattr(DC, "quantize_latents", at_max)
    out = enc.produce_payload(4)
    assert np.abs(out["zq"]).min() == EC.MAX_MAG
    assert enc.stats["device_framings"] == 1 and enc.stats["device_retries"] >= 1
    q = EC.payload_q_ids(2, 9, 15)
    st = enc.fixed_stats
    want, lengths, calls = runtime.dred_frame_payloads(
        out["zq"], out["pulses"], 9, 15, st["p0_q15"][q], st["r_q15"][q], 82)
    assert calls > 1 and out["payloads"].data == want
    assert np.array_equal(out["payloads"].lengths, lengths)


def _analysis_same(a, b):
    la, lb = F._leaves(a), F._leaves(b)
    return len(la) == len(lb) == 11 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
def test_cuda_analysis_graph_equals_eager_at_1024(cuda):
    """`AnalysisGraph` on the card at 1024 streams against the two eager
    `compute_single_frame_features` calls, 36 ticks of speech, bit for
    bit (f0, f1 and every state leaf, the ViterbiCarry's included): a
    snapshot of tick 10's state restored before tick 20 and a fresh state
    before tick 30 are taken up; one capture, a replay every tick."""
    b, ticks = 1024, 36
    audio = torch.from_numpy(_dred_speech(b, ticks, seed=12)).to(cuda).float()
    g = F.AnalysisGraph()
    es = gs = F.init_encoder_state(b, cuda)
    snap = None
    for t in range(ticks):
        if t == 10:
            snap = F._clone_state(es)
        if t == 20:
            es, gs = F._clone_state(snap), F._clone_state(snap)
        if t == 30:
            es, gs = F.init_encoder_state(b, cuda), F.init_encoder_state(b, cuda)
        want = F.AnalysisGraph._plain(es, audio[t])
        got = g(gs, audio[t])
        assert _analysis_same(got[0], want[0]), t
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), t
        es, gs = want[0], got[0]
    assert int(gs.viterbi.best_i.abs().sum()) > 0
    assert dict(g.stats) == {"analysis_captures": 1, "analysis_replays": ticks}


@pytest.mark.cuda
def test_cuda_analysis_graph_recaptures_on_a_new_key(cuda):
    """A batch change captures anew (and the return to the old batch
    again), every call bit for bit the eager pair's; inside a caller's
    CUDA graph capture a call runs eagerly (counted) and the caller's
    graph replays to the eager values."""
    audio = torch.from_numpy(_dred_speech(64, 8, seed=13)).to(cuda).float()
    g = F.AnalysisGraph()
    states = {64: F.init_encoder_state(64, cuda), 37: F.init_encoder_state(37, cuda)}
    for t, b in enumerate([64, 64, 37, 37, 64]):
        st = F._clone_state(states[b])
        want = F.AnalysisGraph._plain(st, audio[t, :b])
        got = g(st, audio[t, :b])
        assert _analysis_same(got[0], want[0]), t
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), t
        states[b] = want[0]
    assert dict(g.stats) == {"analysis_captures": 3, "analysis_replays": 5}
    st = F._clone_state(states[64])
    want = F.AnalysisGraph._plain(st, audio[5])
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        got = g(st, audio[5])
    outer.replay()
    torch.cuda.synchronize()
    assert _analysis_same(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert dict(g.stats) == {"analysis_captures": 3, "analysis_replays": 5,
                             "analysis_eager": 1}


@pytest.mark.cuda
def test_cuda_dred_pool_analysis_graph_equals_eager_pool(cuda):
    """`DREDEncoderPool` at 1024 streams with the demo RDO-VAE, its
    analysis one graph replay a tick, against the same pool running the
    analysis eagerly, over 32 ticks with the analysis state snapshotted
    before tick 12 and restored before tick 20: every payload's bytes,
    symbols and pulses, and the end state, equal; one capture and a replay
    a tick."""
    params, rcfg = api.load_rdovae_model(api.DEMO_RDOVAE_MODEL_PATH, device=cuda)
    b, ticks = 1024, 32
    audio = _dred_speech(b, ticks, seed=14)
    pools = {"graph": api.DREDEncoderPool(params, rcfg, streams=b, device=cuda),
             "eager": api.DREDEncoderPool(params, rcfg, streams=b, device=cuda)}
    pools["eager"].analysis = F.AnalysisGraph._plain
    snaps = {}
    for t in range(ticks):
        out = {}
        for name, pool in pools.items():
            if t == 12:
                snaps[name] = F._clone_state(pool.features)
            if t == 20:
                pool.features = F._clone_state(snaps[name])
            out[name] = pool.step_pcm(audio[t])
        if out["graph"] is None:
            assert out["eager"] is None, t
            continue
        g, e = out["graph"], out["eager"]
        assert g["payloads"].data == e["payloads"].data, t
        assert np.array_equal(g["payloads"].lengths, e["payloads"].lengths), t
        assert np.array_equal(g["zq"], e["zq"]) and np.array_equal(g["pulses"], e["pulses"]), t
    assert t >= 26 and out["graph"] is not None
    assert _analysis_same(pools["graph"].features, pools["eager"].features)
    assert torch.equal(pools["graph"].enc.z_window[-1], pools["eager"].enc.z_window[-1])
    stats = pools["graph"].stats
    assert (stats["analysis_captures"], stats["analysis_replays"],
            stats["analysis_eager"]) == (1, ticks, 0)
    assert not any(k.startswith("analysis_") for k in pools["eager"].stats)
