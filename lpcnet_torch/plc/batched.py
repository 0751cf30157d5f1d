"""Batched packet-loss concealment with a loss pattern per stream.

The reference PLC (src/lpcnet_plc.c:188-492) is a state machine whose
control flow depends on the loss flag, so a batch of streams would have to
share one loss pattern. Here every stream steps through the same frame step
and masks select each stream's behaviour, so a serving node runs hundreds of
independent streams, each with its own losses, in one pass per 10 ms frame.

Structure, as in `lpcnet_tpu/plc/batched.py::_plc_frame_step_fused` and
`_plc_frame_step_nc_fused`: one interleaved program per frame over a single
state. The conceal (lost) and update (good packet) paths' sub-operations are
masked per stream, and corresponding ones share device work, since the
masks are disjoint. The data-dependent pieces (the drain of queued audio,
blending after a loss, the flush of deferred frame-network inputs) are
unrolled to their bounded maxima with enable masks: the causal drain runs at
most ceil(plc_buf_size / 160) = 3 iterations and the deferred feature buffer
holds at most 2*(k-1) = 4 frames. The two-path steps (`fused_step=False`:
both paths on copies of the state, merged per stream) are kept as the
reference the fused steps are held to.

On a card the sample-rate work of a causal frame is three kernel launches:
the teacher-forced drain (K3, `kernels.sample_loop.teacher_force_blocks_kernel`)
and two masked half-frames (K2, `synthesize_frame_masked_kernel`); with
the chain (`BatchedPLC(chain=True)`) the frame's PLC-net calls are one more
(K4, `kernels.plc_chain.plc_chain_kernel`). A non-causal frame is five: K3 for
the deferred resync of the streams that recovered a frame before, K2 for
the first half-frame of the lost and recovering streams, K3 for the
recovering streams' reverse-time resynthesis, K2 for the second half-frame,
and K3 for the good streams' resync on the whole batch.

Scope: the causal mode with or without blending (LPCNET_PLC_CAUSAL /
LPCNET_PLC_CODEC) and its FEC queue of every stream (`fec_add`,
`fec_clear`), the non-causal mode (LPCNET_PLC_NONCAUSAL, which needs a
lookahead-0 vocoder and has no FEC, as in the reference), the DC filter
(`remove_dc`, fused steps only) and the two-path steps.

For profiling, `_ABLATE` names components (`ABLATION_NAMES`) that the step
replaces by cheap stand-ins (`tools/profile_plc_torch.py` sweeps them, as
the JAX package's tool does). A stand-in still consumes its inputs and
perturbs what it would have written by a tiny amount that depends on them,
keeping shapes and dtypes, so an ablated frame does the same bookkeeping
and the same later launches. Serving never sets it; empty, every path is
unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..codec import features as F
from ..dsp.burg import burg_cepstral_analysis
from ..dsp.constants import FRAME_SIZE, NB_BANDS, NB_FEATURES, TRAINING_OFFSET
from ..kernels import plc_chain as PC
from ..kernels import sample_loop as K
from ..models import lpcnet as M
from ..models import plc as PM
from ..utils.device import resolve_device
from ..weights.convert import tree_to

_TO = TRAINING_OFFSET                       # 80
_N1 = FRAME_SIZE - TRAINING_OFFSET          # 80
MAX_DEFER = 4                               # 2*(conv_kernel-1)
MAX_DRAIN = 3                               # ceil(plc_buf_size / FRAME_SIZE)

# src/lpcnet_plc.c: the DC tracker's coefficient and the energy attenuation
# by consecutive lost frames
DC_CONST = 0.003
ATT_TABLE = np.array([0, 0, -.2, -.2, -.4, -.4, -.8, -.8, -1.6, -1.6],
                     np.float32)


class BatchedPLCState(NamedTuple):
    fstate: M.FrameState
    sstate: M.SampleState
    cond_a: torch.Tensor
    cond_b: torch.Tensor
    lpc: torch.Tensor
    feat_ring: torch.Tensor      # [B, MAX_DEFER, 36] deferred frame-net inputs
    feat_count: torch.Tensor     # [B] int32
    enc: F.EncoderState
    plc_net: PM.PLCNetState
    plc_ring: PM.PLCNetState     # leaves [R, B, H]; ring of past net states
    features: torch.Tensor       # [B, 20] current feature estimate
    pcm_buf: torch.Tensor        # [B, plc_buf_size + 160]
    pcm_fill: torch.Tensor       # [B] int32
    skip_analysis: torch.Tensor  # [B] int32
    blend: torch.Tensor          # [B] bool
    loss_count: torch.Tensor     # [B] int32
    queued: torch.Tensor         # [B] bool (non-causal deferred resync)
    queued_samples: torch.Tensor  # [B, 160]
    fec_feats: torch.Tensor      # [B, FEC_Q, 20] queued FEC features
    fec_len: torch.Tensor        # [B] int32 entries in the queue
    fec_read: torch.Tensor       # [B] int32 next entry to consume
    fec_keep: torch.Tensor       # [B] int32 rewind floor
    fec_skip: torch.Tensor       # [B] int32 pending unknown-feature skips
    dc_mem: torch.Tensor         # [B] DC tracker (remove_dc mode)
    syn_dc: torch.Tensor         # [B] synthesis-side DC tracker
    dc_buf: torch.Tensor         # [B, TO] delayed DC offsets (non-causal)


def tree_map(fn, *trees):
    """`fn` over the tensors of (nested) NamedTuples, dicts or None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        items = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*items) if hasattr(t0, "_fields") else tuple(items)
    return fn(*trees)


def _bwhere(mask, new, old):
    """Per-stream select over [B, ...] state trees."""
    return tree_map(
        lambda n, o: torch.where(mask.reshape(mask.shape + (1,) * (n.dim() - 1)),
                                 n, o), new, old)


def _pad36(f):
    return torch.nn.functional.pad(f, (0, 36 - f.shape[-1]))


# --------------------------------------------------------------------------
# The profiling ablation set (tools/profile_plc_torch.py)
# --------------------------------------------------------------------------

ABLATION_NAMES = ("burg", "enc", "fnet", "plcnet", "tf", "tails")
_ABLATE: frozenset = frozenset()


def _abl(name: str) -> bool:
    return name in _ABLATE


def _tensors(xs):
    for x in xs:
        if isinstance(x, dict):
            yield from _tensors(x.values())
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)
        elif x is not None:
            yield x


def _consume(*xs):
    """A device scalar that depends on every tensor of `xs` (nested
    NamedTuples, dicts, lists or None), scaled by 1e-6."""
    return sum(x.to(torch.float32).mean() for x in _tensors(xs)) * 1e-6


# Set to a callable to see every kernel call the step makes, as
# kernel_tap(wrapper's name, arguments), just before the wrapper runs. It
# changes nothing else: the wrappers launch and count as without it.
kernel_tap = None


def _launch(wrapper, *args):
    if kernel_tap is not None:
        kernel_tap(wrapper.__name__, args)
    return wrapper(*args)


def _compact_capacity(b: int) -> int:
    """The sub-batch size of the compacted sample-rate section: b/4 rounded
    up to a multiple of 32 (64 at 256 streams, above the share of a pool
    that is lost or blending at 10 % loss), none below 128 streams."""
    return (b // 4 + 31) // 32 * 32 if b >= 128 else 0


class BatchedPLC:
    """Mixed-loss batched PLC, causal or non-causal.

    Call step(pcm [B, 160], lost [B]) per 10 ms frame; hold each loss flag
    for 2 frames to match the 20 ms packets of lpcnet_demo. The non-causal
    mode's output lags its input by 80 samples.
    """

    def __init__(self, fused, cfg: M.LPCNetConfig, plc_params, batch: int,
                 enable_blending: bool = True, non_causal: bool = False,
                 plc_cfg: Optional[PM.PLCConfig] = None,
                 use_kernel: Optional[bool] = None,
                 fused_step: bool = True, fec_q: int = 100,
                 remove_dc: bool = False, chain: bool = False, device=None):
        """On CUDA the sample-rate work always runs through the kernels, at
        any batch. On the CPU `use_kernel=True` takes the same program with
        the kernels' plain versions; the default there is the step-by-step
        float32 model (`models.lpcnet.synthesize_frame_masked`).
        fused_step=False takes the two-path step, the reference of the fused
        one. `chain=True` runs the causal fused step's PLC-net calls as one
        chain kernel (K4) a frame; it is off by default, as in the JAX
        package, since whether it pays on a given card is a measurement to
        make there."""
        if non_causal and cfg.lookahead != 0:
            raise ValueError("non-causal PLC needs a lookahead-0 model")
        if remove_dc and not fused_step:
            raise ValueError("batched remove_dc: fused step only")
        dev = resolve_device(device)
        if use_kernel is None:
            use_kernel = dev.type == "cuda"
        if dev.type == "cuda" and not use_kernel:
            raise ValueError("on CUDA the sample-rate work runs only through "
                             "the kernels")
        if chain and (non_causal or not fused_step or not use_kernel):
            raise ValueError("the chain kernel runs in the causal fused step "
                             "on the kernels only")
        self.device = dev
        self.fused = tree_to(fused, dev)
        self.cfg = cfg
        self.batch = batch
        self.enable_blending = enable_blending
        self.non_causal = non_causal
        self.fused_step = fused_step
        self.plc_params = tree_to(plc_params, dev)
        self.plc_cfg = plc_cfg or PM.PLCConfig()
        self.delay = cfg.lookahead
        self.plc_buf_size = self.delay * FRAME_SIZE + _TO
        self.fec_q = fec_q
        self.use_kernel = use_kernel
        self.kw = (K.masked_kernel_weights(K.kernel_weights(self.fused, cfg))
                   if use_kernel else None)
        self.remove_dc = remove_dc
        # the causal fused step's PLC-net chain (K4)
        self._cw = PC.plc_chain_weights(self.plc_params) if chain else None
        # the capacity of the compacted sample-rate section (0: the full
        # batch); tests and tools may set it after construction
        self.compact_cap = _compact_capacity(batch)
        # frames whose sample-rate section ran compacted / fell through to
        # the full batch because the active streams exceeded the capacity /
        # ran at the full batch because compaction is off (the fused steps;
        # the non-causal step's deferred resync compacts too, uncounted)
        self.stats = {"compacted": 0, "overflowed": 0, "full": 0}
        self.state = self.init_state()

    def init_state(self) -> BatchedPLCState:
        b, cfg, dev = self.batch, self.cfg, self.device
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        net = PM.init_state(b, self.plc_cfg, dev)
        ring = PM.PLCNetState(*(x[None].repeat(self.delay + 1, 1, 1)
                                for x in net))
        return BatchedPLCState(
            fstate=M.init_frame_state(b, cfg, dev),
            sstate=M.init_sample_state(b, cfg, dev),
            cond_a=z(b, 3 * cfg.rnn_units1), cond_b=z(b, 3 * cfg.rnn_units2),
            lpc=z(b, 16),
            feat_ring=z(b, MAX_DEFER, 36), feat_count=zi(b),
            enc=F.init_encoder_state(b, dev),
            plc_net=net, plc_ring=ring, features=z(b, NB_FEATURES),
            pcm_buf=z(b, self.plc_buf_size + FRAME_SIZE),
            pcm_fill=torch.full((b,), self.plc_buf_size, dtype=torch.int32,
                                device=dev),
            skip_analysis=zi(b), blend=zb(b), loss_count=zi(b),
            queued=zb(b), queued_samples=z(b, FRAME_SIZE),
            fec_feats=z(b, self.fec_q, NB_FEATURES),
            fec_len=zi(b), fec_read=zi(b), fec_keep=zi(b), fec_skip=zi(b),
            dc_mem=z(b), syn_dc=z(b), dc_buf=z(b, _TO))

    def reset(self):
        self.state = self.init_state()

    def fec_add(self, features, have=None, unknown=None):
        """Queue one 10 ms FEC feature frame per stream (the batched
        lpcnet_plc_fec_add): features [B, >=20]; have [B] bool marks the
        streams that received redundancy for this slot. A stream with
        have=False counts an unknown frame (the C's NULL call) unless
        `unknown` narrows that set: pass unknown=np.zeros(B, bool) to leave
        such streams untouched (a pool, where an absent stream should not
        use up a time slot). Causal fused step only: the reference's
        non-causal PLC has no FEC either."""
        if self.non_causal or not self.fused_step:
            raise ValueError("FEC queues: causal fused step only (the "
                             "reference's non-causal PLC has no FEC either)")
        b, dev = self.batch, self.device
        feats = torch.as_tensor(np.asarray(features, np.float32)
                                [:, :NB_FEATURES], device=dev)
        have = (torch.ones(b, dtype=torch.bool, device=dev) if have is None
                else torch.as_tensor(np.asarray(have).astype(bool), device=dev))
        unknown = (~have if unknown is None else
                   torch.as_tensor(np.asarray(unknown).astype(bool), device=dev))
        self.state = _fec_add_op(self.state, feats, have, unknown)

    def fec_clear(self):
        z = torch.zeros(self.batch, dtype=torch.int32, device=self.device)
        self.state = self.state._replace(fec_len=z, fec_read=z, fec_keep=z,
                                         fec_skip=z)

    def step_tensors(self, pcm: torch.Tensor, lost: torch.Tensor
                     ) -> torch.Tensor:
        """One frame on tensors that already lie on the device: pcm [B, 160]
        float, lost [B] bool -> [B, 160] float."""
        with torch.no_grad():
            if not self.fused_step:
                step = _plc_frame_step_nc if self.non_causal else _plc_frame_step
                self.state, out = step(
                    self.state, self.fused, self.plc_params, pcm, lost,
                    self.cfg, self.enable_blending, self.delay,
                    self.plc_buf_size, self.kw)
            elif self.non_causal:
                self.state, out = _plc_frame_step_nc_fused(
                    self.state, self.fused, self.plc_params, pcm, lost,
                    self.cfg, self.kw, remove_dc=self.remove_dc,
                    compact_cap=self.compact_cap, stats=self.stats)
            else:
                self.state, out = _plc_frame_step_fused(
                    self.state, self.fused, self.plc_params, pcm, lost,
                    self.cfg, self.enable_blending, self.delay,
                    self.plc_buf_size, self.kw, remove_dc=self.remove_dc,
                    cw=self._cw, compact_cap=self.compact_cap,
                    stats=self.stats)
        return out

    def step(self, pcm: np.ndarray, lost: np.ndarray) -> np.ndarray:
        """pcm [B, 160] (ignored where lost), lost [B] 0/1. Returns [B, 160]."""
        out = self.step_tensors(
            torch.as_tensor(np.asarray(pcm, np.float32), device=self.device),
            torch.as_tensor(np.asarray(lost).astype(bool), device=self.device))
        return out.cpu().numpy()

    def run(self, pcm, lost, device_out: bool = False):
        """Many frames without a copy to the host per frame: pcm [B, T, 160],
        lost [B, T] (arrays or tensors). Returns [B, T, 160] as numpy, or
        with device_out=True as a tensor left on the device."""
        pcm = torch.as_tensor(pcm, dtype=torch.float32, device=self.device)
        lost = torch.as_tensor(lost, device=self.device).bool()
        outs = [self.step_tensors(pcm[:, k], lost[:, k])
                for k in range(lost.shape[1])]
        out = torch.stack(outs, dim=1)
        return out if device_out else out.cpu().numpy()


# --------------------------------------------------------------------------
# The frame step's pieces
# --------------------------------------------------------------------------

def _fnet_stand_in(s: BatchedPLCState, *inputs):
    eps = _consume(*inputs)
    return s._replace(cond_a=s.cond_a + eps, cond_b=s.cond_b + eps,
                      lpc=s.lpc + eps)


def _fnet_masked(fused, s: BatchedPLCState, feats36, active, cfg):
    if _abl("fnet"):
        return _fnet_stand_in(s, feats36)
    new_f, _, ca, cb, lpc = M.frame_network(fused, s.fstate, feats36, cfg)
    merged = _bwhere(active, (new_f, ca, cb, lpc),
                     (s.fstate, s.cond_a, s.cond_b, s.lpc))
    return s._replace(fstate=merged[0], cond_a=merged[1], cond_b=merged[2],
                      lpc=merged[3])


def _fnet_flush_masked(fused, s: BatchedPLCState, ring, count, cfg):
    """The deferred frame nets of every stream at once: count[i]
    frame_network steps of stream i over ring[:, :count[i]]."""
    if _abl("fnet"):
        return _fnet_stand_in(s, ring, count)
    new_f, ca, cb, lpc = M.frame_network_flush(fused, s.fstate, ring, count,
                                               cfg)
    merged = _bwhere(count > 0, (new_f, ca, cb, lpc),
                     (s.fstate, s.cond_a, s.cond_b, s.lpc))
    return s._replace(fstate=merged[0], cond_a=merged[1], cond_b=merged[2],
                      lpc=merged[3])


def _tail_masked(fused, s: BatchedPLCState, preload, preload_mask,
                 advance_mask, cfg, kw=None, sampled=True, live=None):
    """Sample-rate tail gated by the conv warmup: a stream still in warmup
    neither advances nor emits. With `kw` the tail is the masked sample-loop
    kernel (K2), else the step-by-step float32 model. sampled=False (kernel
    only) drops the sampler for segments whose advanced steps are all
    teacher-forced. `live` overrides the warmup gate."""
    if live is None:
        live = s.fstate.frame_count > cfg.lookahead
    adv = advance_mask & live[:, None]
    if _abl("tails"):
        eps = _consume(s.cond_a, s.cond_b, s.lpc, preload, adv)
        return (s._replace(sstate=s.sstate._replace(
            gru_a=s.sstate.gru_a + eps)),
            torch.zeros_like(preload, dtype=torch.float32) + eps)
    if kw is None:
        new_ss, pcm = M.synthesize_frame_masked(
            fused, s.sstate, s.cond_a, s.cond_b, s.lpc, preload,
            preload_mask & adv, adv)
    else:
        new_ss, pcm = _launch(
            K.synthesize_frame_masked_kernel, kw, s.sstate, s.cond_a.contiguous(), s.cond_b.contiguous(),
            s.lpc.contiguous(), preload, preload_mask & adv, adv,
            preload.shape[-1], sampled)
    return s._replace(sstate=new_ss), pcm


def _tf_prefix(fused, sstate: M.SampleState, ca, cb, lpc, targets, count,
               kw):
    """`count[i]` teacher-forced steps of stream i on explicit conditioning
    (count 0 freezes it); the warmup gate is already folded into `count`.
    With `kw` one block of K3, else the float32 model's masked tail with the
    sampler off. Returns the new sample state."""
    if _abl("tf"):
        return sstate._replace(
            gru_a=sstate.gru_a + _consume(ca, cb, lpc, targets, count))
    n = targets.shape[-1]
    if kw is not None:
        return _launch(K.teacher_force_blocks_kernel, kw, sstate, ca[:, None],
                       cb[:, None], lpc[:, None], targets, count[:, None], n)
    adv = torch.arange(n, device=targets.device)[None, :] < count[:, None]
    return M.synthesize_frame_masked(fused, sstate, ca, cb, lpc, targets,
                                     adv, adv)[0]


def _fec_row(s: BatchedPLCState, read):
    """The queue row at `read` of every stream (any row where the queue is
    read to its end: the caller then does not use it)."""
    q = s.fec_feats.shape[1]
    idx = torch.clamp(read.long(), 0, q - 1)[:, None, None]
    return s.fec_feats.gather(1, idx.expand(-1, 1, NB_FEATURES))[:, 0]


def _fec_input(have, fec_row):
    """The PLC-net input of a consumed FEC row: the row in the feature
    lanes, flag -1; zeros for the streams that predict."""
    inp = fec_row.new_zeros(fec_row.shape[0], PM.PLC_INPUT_SIZE)
    inp[:, 2 * NB_BANDS:2 * NB_BANDS + NB_FEATURES] = fec_row
    inp[:, -1] = -1.0
    return torch.where(have[:, None], inp, torch.zeros_like(inp))


def _good_input(burg_feats, feats20=None):
    """The PLC-net input of a received frame: Burg cepstra, the frame's
    features where known, flag +1."""
    inp = burg_feats.new_zeros(burg_feats.shape[0], PM.PLC_INPUT_SIZE)
    inp[:, :2 * NB_BANDS] = burg_feats
    if feats20 is not None:
        inp[:, 2 * NB_BANDS:2 * NB_BANDS + NB_FEATURES] = feats20
    inp[:, -1] = 1.0
    return inp


def _plc_pred(plc_params, net, plc_in):
    """The PLC net's step, or its stand-in under the `plcnet` ablation."""
    if _abl("plcnet"):
        eps = _consume(plc_in)
        return (tree_map(lambda x: x + eps, net),
                plc_in.new_zeros(plc_in.shape[0], NB_FEATURES) + eps)
    return PM.compute_plc_pred(plc_params, net, plc_in)


def _fec_or_pred_masked(plc_params, s: BatchedPLCState, active, delay):
    """Per-stream get_fec_or_pred (src/lpcnet_plc.c:147-166): a stream with
    a queued FEC frame consumes it (the PLC net is updated with the
    -1-flagged FEC input, the features come from the queue); the rest
    predict. Returns (state, fec_hit mask)."""
    have = (s.fec_read != s.fec_len) & (s.fec_skip == 0)
    fec_row = _fec_row(s, s.fec_read)
    new_net, out = _plc_pred(plc_params, s.plc_net, _fec_input(have, fec_row))
    feats = torch.where(have[:, None], fec_row, out[:, :NB_FEATURES])
    read2 = torch.where(have, s.fec_read + 1, s.fec_read)
    keep2 = torch.where(
        have, torch.clamp(torch.maximum(s.fec_keep, read2 - delay - 1), min=0),
        s.fec_keep)
    skip2 = torch.where(~have & (s.fec_skip > 0), s.fec_skip - 1, s.fec_skip)
    s = s._replace(
        plc_net=_bwhere(active, new_net, s.plc_net),
        features=torch.where(active[:, None], feats, s.features),
        fec_read=torch.where(active, read2, s.fec_read),
        fec_keep=torch.where(active, keep2, s.fec_keep),
        fec_skip=torch.where(active, skip2, s.fec_skip))
    return s, have & active


def _fec_add_op(s: BatchedPLCState, feats, have, unknown):
    """Append one FEC feature frame per stream (lpcnet_plc_fec_add,
    src/lpcnet_plc.c:111-132): `have` streams append, `unknown` streams
    count an unknown frame (fec_skip++, the C's features==NULL call), the
    rest are left alone. A full queue drops the rewind-protected prefix
    where there is one, else the add."""
    q = s.fec_feats.shape[1]
    lanes = torch.arange(q, device=feats.device)[None, :]
    full = s.fec_len == q
    can_compact = have & full & (s.fec_keep > 0)
    drop = full & (s.fec_keep == 0) & have
    idx = torch.clamp(lanes + s.fec_keep[:, None], max=q - 1).long()
    shifted = s.fec_feats.gather(1, idx[..., None].expand(-1, -1, NB_FEATURES))
    feats_q = torch.where(can_compact[:, None, None], shifted, s.fec_feats)
    len2 = torch.where(can_compact, s.fec_len - s.fec_keep, s.fec_len)
    read2 = torch.where(can_compact, s.fec_read - s.fec_keep, s.fec_read)
    keep2 = torch.where(can_compact, torch.zeros_like(s.fec_keep), s.fec_keep)
    add = have & ~drop
    slot = lanes == len2[:, None]
    feats_q = torch.where((add[:, None] & slot)[..., None], feats[:, None, :],
                          feats_q)
    return s._replace(
        fec_feats=feats_q, fec_len=torch.where(add, len2 + 1, len2),
        fec_read=read2, fec_keep=keep2,
        fec_skip=torch.where(unknown, s.fec_skip + 1, s.fec_skip))


def _plc_pred_masked(plc_params, s: BatchedPLCState, plc_in, active,
                     set_features=True):
    new_net, out = _plc_pred(plc_params, s.plc_net, plc_in)
    s = s._replace(plc_net=_bwhere(active, new_net, s.plc_net))
    if set_features:
        s = s._replace(features=torch.where(active[:, None],
                                            out[:, :NB_FEATURES], s.features))
    return s


def _chain_causal(cw, s: BatchedPLCState, L, bl, burg_feats, delay,
                  enable_blending):
    """The inputs of the frame's PLC-net chain, then the chain as one kernel
    launch (K4).

    The causal step's PLC-net calls are the prediction that restores a
    blending stream (bl), one get_fec_or_pred per drain iteration (lost
    streams with queued audio) and the lost frame's get_fec_or_pred. Their
    inputs all follow from the state at entry: the Burg cepstra, and the
    FEC queue rows under a replay of the pointer advance of
    src/lpcnet_plc.c:147-166. Blending and lost streams are disjoint, so
    the restore prediction rides step 0. Returns the outputs and running
    states of every step, the masks and the final FEC pointers, for the
    frame-rate program to replay ring pushes, feature selects and pointer
    writes at their original places.
    """
    k_steps = MAX_DRAIN + 1
    read, keep, skp = s.fec_read, s.fec_keep, s.fec_skip
    inputs, masks, haves, rows = [], [], [], []
    for k in range(k_steps):
        active = (L & (s.pcm_fill > k * FRAME_SIZE)) if k < MAX_DRAIN else L
        have = (read != s.fec_len) & (skp == 0)
        row = _fec_row(s, read)
        inp = _fec_input(have, row)
        mask = active
        if k == 0 and enable_blending:
            inp = torch.where(bl[:, None], _good_input(burg_feats), inp)
            mask = mask | bl
        inputs.append(inp)
        masks.append(mask)
        haves.append(have)
        rows.append(row)
        am = active & have
        read2 = read + 1
        keep2 = torch.clamp(torch.maximum(keep, read2 - delay - 1), min=0)
        read = torch.where(am, read2, read)
        keep = torch.where(am, keep2, keep)
        skp = torch.where(active & ~have & (skp > 0), skp - 1, skp)

    if _abl("plcnet"):
        eps = _consume(inputs, masks)
        rep = lambda h: h[:, None].expand(-1, k_steps, -1) + eps
        h1s, h2s = rep(s.plc_net.gru1), rep(s.plc_net.gru2)
        outs = inputs[0].new_zeros(L.shape[0], k_steps, NB_FEATURES) + eps
    else:
        h1s, h2s, outs = _launch(
            PC.plc_chain_kernel, cw, s.plc_net.gru1, s.plc_net.gru2,
            torch.stack(inputs, dim=1), torch.stack(masks, dim=1), k_steps)
    # the +0.1 correlation boost (models.plc.compute_plc_pred)
    outs[:, :, NB_FEATURES - 1] = torch.clamp(
        outs[:, :, NB_FEATURES - 1] + 0.1, max=0.5)
    return dict(h1s=h1s, h2s=h2s, outs=outs, haves=haves, rows=rows,
                read=read, keep=keep, skip=skp)


def _chain_feats(ch, k):
    """Step k's features: the FEC row where one was consumed, else the
    prediction (as _fec_or_pred_masked)."""
    return torch.where(ch["haves"][k][:, None], ch["rows"][k],
                       ch["outs"][:, k])


def _section_body(kw, sec, enable_blending, remove_dc):
    """The causal step's contiguous sample-rate section on explicit
    per-stream inputs: the teacher-forced drain blocks (K3), the sampled
    head half-frame (K2), the blend cross-fade and sample-state restore, the
    second half-frame, sampled or teacher-forced (K2). It touches only the
    sample state; streams that are neither lost nor blending are frozen bit
    for bit by the kernels' advance masks, which is what makes compaction
    sound."""
    b = sec["L"].shape[0]
    dev = sec["L"].device
    L, bl = sec["L"], sec["bl"]
    if _abl("tf"):
        eps = _consume(sec["ca_blk"], sec["cb_blk"], sec["lpc_blk"],
                       sec["targets"], sec["counts"])
        ss = sec["sstate"]._replace(gru_a=sec["sstate"].gru_a + eps)
    else:
        ss = _launch(
            K.teacher_force_blocks_kernel, kw, sec["sstate"], sec["ca_blk"],
            sec["cb_blk"], sec["lpc_blk"], sec["targets"], sec["counts"],
            FRAME_SIZE)
    act = L | bl
    adv1 = (act & sec["live1"])[:, None].expand(b, _N1)
    zp = torch.zeros((b, _N1), dtype=torch.float32, device=dev)
    zm = torch.zeros((b, _N1), dtype=torch.bool, device=dev)
    if _abl("tails"):
        eps = _consume(sec["ca1"], sec["cb1"], sec["lpc1"], adv1)
        ss, head = ss._replace(gru_a=ss.gru_a + eps), zp + eps
    else:
        ss, head = _launch(
            K.synthesize_frame_masked_kernel, kw, ss,
            sec["ca1"].contiguous(), sec["cb1"].contiguous(),
            sec["lpc1"].contiguous(), zp, zm, adv1, _N1)
    pcm80 = sec["pcm80"]
    if enable_blending:
        w = 0.5 - 0.5 * torch.cos(
            np.pi * torch.arange(_N1, dtype=torch.float32, device=dev) / _N1)
        k2d = head - sec["delta"][:, None] if remove_dc else head
        blended = torch.floor(0.5 + w * pcm80 + (1 - w) * k2d)
        pcm80 = torch.where(bl[:, None], blended, pcm80)
        ss = _bwhere(bl, sec["saved_ss"], ss)
    tf2 = bl[:, None].expand(b, _TO)
    adv2 = (act & sec["live2"])[:, None].expand(b, _TO)
    if _abl("tails"):
        eps = _consume(sec["ca2"], sec["cb2"], sec["lpc2"], adv2, pcm80)
        ss = ss._replace(gru_a=ss.gru_a + eps)
        tail = torch.zeros((b, _TO), dtype=torch.float32, device=dev) + eps
    else:
        ss, tail = _launch(
            K.synthesize_frame_masked_kernel, kw, ss,
            sec["ca2"].contiguous(), sec["cb2"].contiguous(),
            sec["lpc2"].contiguous(), pcm80 * tf2, tf2 & adv2, adv2, _TO)
    return ss, head, tail, pcm80


def _compacted(body, sec, mask, into, cap, stats=None):
    """`body(sec)` at the full batch, or on the sub-batch of `mask`'s
    streams when their number fits the capacity `cap` (0: never).

    `sec` holds the body's per-stream inputs ([B, ...] tensors in nested
    tuples and dicts). `into` is shaped like the body's outputs: the
    full-batch values the sub-batch's outputs are scattered into, so rows
    outside `mask` keep them. The body must leave a stream whose inputs are
    all zeros and whose masks are off as it is: the gather pads every
    tensor with a zero sentinel row, so the unused slots of the sub-batch
    (index B) read zeros and scatter into a row that is dropped. The branch
    needs the number of `mask`'s streams on the host: one read of a device
    scalar. `stats` counts the branch taken."""
    b = mask.shape[0]

    def tally(branch):
        if stats is not None:
            stats[branch] += 1

    if not cap or cap >= b:
        tally("full")
        return body(sec)
    idx = torch.nonzero(mask)[:, 0]
    if idx.shape[0] > cap:
        tally("overflowed")
        return body(sec)
    tally("compacted")
    idx = torch.cat([idx, idx.new_full((cap - idx.shape[0],), b)])

    def gather(x):
        return torch.cat([x, torch.zeros_like(x[:1])], dim=0)[idx]

    def scatter(full, comp):
        fp = torch.cat([full, torch.zeros_like(full[:1])], dim=0)
        fp[idx] = comp
        return fp[:b]

    return tree_map(scatter, into, body(tree_map(gather, sec)))


def _run_sample_section(kw, sec, enable_blending, remove_dc, cap, stats):
    """The causal `_section_body`, compacted to the streams that are lost or
    blending when their number fits the capacity."""
    zeros = torch.zeros_like(sec["pcm80"])
    return _compacted(
        lambda c: _section_body(kw, c, enable_blending, remove_dc), sec,
        sec["L"] | sec["bl"], (sec["sstate"], zeros, zeros, sec["pcm80"]),
        cap, stats)


def _push_plc_ring(s: BatchedPLCState, active):
    new_ring = tree_map(
        lambda ring, cur: torch.where(
            active[None, :, None], torch.cat([cur[None], ring[:-1]], dim=0),
            ring),
        s.plc_ring, s.plc_net)
    return s._replace(plc_ring=new_ring)


def _push_feat_ring(s: BatchedPLCState, feats36, active):
    """Drop the oldest entry when full, then append (as the host's
    frame_network_deferred)."""
    full = s.feat_count >= MAX_DEFER
    ring = torch.where(
        full[:, None, None],
        torch.cat([s.feat_ring[:, 1:], torch.zeros_like(s.feat_ring[:, :1])], 1),
        s.feat_ring)
    count = torch.where(full, torch.full_like(s.feat_count, MAX_DEFER - 1),
                        s.feat_count)
    slot = (torch.arange(MAX_DEFER, device=count.device)[None, :]
            == count[:, None])
    ring = torch.where((active[:, None] & slot)[..., None],
                       feats36[:, None, :], ring)
    return s._replace(feat_ring=ring,
                      feat_count=torch.where(active, count + 1, s.feat_count))


def _burg(pcm):
    """The frame's Burg cepstra [B, 36], or the `burg` stand-in."""
    if _abl("burg"):
        return pcm.new_zeros(pcm.shape[0], 2 * NB_BANDS) + _consume(pcm)
    return burg_cepstral_analysis(pcm)


def _enc_step(s: BatchedPLCState, pcm):
    if _abl("enc"):
        return s, pcm.new_zeros(pcm.shape[0], 36) + _consume(pcm)
    new_enc, feats = F.compute_single_frame_features(s.enc, pcm)
    return s._replace(enc=new_enc), feats


def _shift_buf(buf):
    n = buf.shape[1] - FRAME_SIZE
    return torch.cat([buf[:, FRAME_SIZE:FRAME_SIZE + n], buf[:, n:]], dim=1)


def _write_frame(buf, frame, offset):
    """buf with `frame` written at `offset` [B] of each row; an offset that
    would run past the end is moved back so the frame fits, as
    lax.dynamic_update_slice does (the callers mask such rows away)."""
    off = torch.clamp(offset.long(), 0, buf.shape[1] - frame.shape[1])
    idx = off[:, None] + torch.arange(frame.shape[1], device=buf.device)[None, :]
    return buf.scatter(1, idx, frame)


# the C's per-sample DC tracker (lp[i] = floor(0.5+dc); dc += c*(pcm[i]-dc),
# src/lpcnet_plc.c:195-204) in closed form: dc_i = (1-c)^i dc_0 + (pcm @ M.T)_i
# with M[i, j] = c*(1-c)^(i-1-j) for j < i
_DC_POWS = np.power(1.0 - DC_CONST, np.arange(FRAME_SIZE + 1))
_DC_MAT = np.tril(
    DC_CONST * np.power(
        1.0 - DC_CONST,
        np.maximum(np.arange(FRAME_SIZE)[:, None]
                   - np.arange(FRAME_SIZE)[None, :] - 1, 0)), -1
).astype(np.float32)
_DC_TAIL = (DC_CONST * np.power(1.0 - DC_CONST,
                                FRAME_SIZE - 1 - np.arange(FRAME_SIZE))
            ).astype(np.float32)


def _dc_path(dc0, pcm):
    """(lp [B, 160] the rounded DC estimate before each sample, dc after the
    frame): the linear recurrence as one [B, 160] x [160, 160]
    lower-triangular product."""
    c = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=pcm.device)
    dc = dc0[:, None] * c(_DC_POWS[:FRAME_SIZE])[None] + pcm @ c(_DC_MAT).T
    dc_end = dc0 * float(np.float32(_DC_POWS[FRAME_SIZE])) + pcm @ c(_DC_TAIL)
    return torch.floor(0.5 + dc), dc_end


def _syn_dc_step(syn0, pcm):
    """syn_dc += c*(pcm[i]-syn_dc) over a frame, closed form."""
    tail = torch.as_tensor(_DC_TAIL, device=pcm.device)
    return syn0 * float(np.float32(_DC_POWS[FRAME_SIZE])) + pcm @ tail


_DC_TAIL80 = (DC_CONST * np.power(1.0 - DC_CONST, _TO - 1 - np.arange(_TO))
              ).astype(np.float32)


def _syn_dc_step80(syn0, pcm80):
    """The same recurrence over a half frame (the non-causal mode's
    TRAINING_OFFSET-long accumulations, src/lpcnet_plc.c:385-387, 425)."""
    tail = torch.as_tensor(_DC_TAIL80, device=pcm80.device)
    return syn0 * float(np.float32(_DC_POWS[_TO])) + pcm80 @ tail


def _att_of(lc):
    """Energy attenuation for loss count lc."""
    table = torch.as_tensor(ATT_TABLE, device=lc.device)
    return torch.where(lc >= 10, float(ATT_TABLE[9]) - 2.0 * (lc - 9),
                       table[torch.clamp(lc, max=9).long()])


def _plc_frame_step_fused(state: BatchedPLCState, fused, plc_params, pcm,
                          lost, cfg, enable_blending, delay, plc_buf_size,
                          kw=None, remove_dc=False, cw=None,
                          compact_cap: int = 0, stats: Optional[dict] = None):
    """The causal PLC step as one interleaved program over a single state.

    Lost and good streams are disjoint, so the per-stream masks that drive
    the conceal path (src/lpcnet_plc.c:293-337) and the update path
    (:188-290) interleave both over one state, and their corresponding
    sub-operations share device work:

      * conceal head (free-running, lost) + update tmp (free-running,
        blending) -> one sampled 80-step kernel call;
      * conceal tail (free-running, lost) + update resync (teacher-forced,
        blending) -> one mixed 80-step call;
      * the update path's frame net before the synthesis folds into the last
        drain iteration's (disjoint masks, the same input expression), and
        its frame net after the restore into the conceal path's;
      * feature extraction runs once, on the output selected per stream.

    With `kw` the sample-rate work runs as one section, compacted to the
    lost and blending streams at capacity `compact_cap` (0: the full batch);
    with `cw` (`kernels.plc_chain.plc_chain_weights`, built once by the
    owner) one chain-kernel launch takes the place of the frame's up to five
    dependent PLC-net calls (`_chain_causal`).

    Returns (new state, output [B, 160] float, clipped to int16 range).
    """
    stats = stats if stats is not None else {"compacted": 0, "overflowed": 0,
                                              "full": 0}
    b = pcm.shape[0]
    s = state
    L = lost
    G = ~lost
    pcm = pcm.to(torch.float32)

    # ---- DC removal on incoming audio (good streams; src/lpcnet_plc.c:183,
    # 195-204): the processing runs DC-free and the returned audio gets the
    # tracked offset added back ---------------------------------------------
    if remove_dc:
        delta = torch.trunc(s.syn_dc)
        lp, dcm_end = _dc_path(s.dc_mem + s.syn_dc, pcm)
        pcm = torch.where(G[:, None], pcm - lp, pcm)
        s = s._replace(dc_mem=torch.where(G, dcm_end, s.dc_mem),
                       syn_dc=torch.where(G, torch.zeros_like(s.syn_dc),
                                          s.syn_dc))

    # ---- update-path frame-level prep (good streams) ----------------------
    burg_feats = _burg(pcm)
    skip = s.skip_analysis > 0
    bl = G & skip & s.blend
    blend_old = s.blend      # the update's final prediction masks on the flag
    #                          as it was before it is cleared

    # ---- conceal: flush the deferred frame nets (lost streams) ------------
    s = _fnet_flush_masked(
        fused, s, s.feat_ring,
        torch.where(L, torch.clamp(s.feat_count, max=MAX_DEFER),
                    torch.zeros_like(s.feat_count)), cfg)
    s = s._replace(feat_count=torch.where(L, torch.zeros_like(s.feat_count),
                                          s.feat_count))

    ch = None
    ring_at = lambda k: tree_map(lambda x: x[k], s.plc_ring)
    if enable_blending:
        # update path: restore the PLC net of before the loss, predict the gap
        s = s._replace(plc_net=_bwhere(bl, ring_at(delay), s.plc_net))
        if cw is not None:
            ch = _chain_causal(cw, s, L, bl, burg_feats, delay, True)
            s = s._replace(features=torch.where(bl[:, None], ch["outs"][:, 0],
                                                s.features))
        else:
            s = _plc_pred_masked(plc_params, s, _good_input(burg_feats), bl)
        for _ in range(delay):
            s = _push_feat_ring(s, _pad36(s.features), bl)
    else:
        if delay > 0:
            s = s._replace(plc_net=_bwhere(bl, ring_at(delay - 1), s.plc_net))
        # codec mode rewinds the FEC pointer with the frame net
        s = s._replace(fec_read=torch.where(
            bl, torch.maximum(s.fec_read - delay, s.fec_keep), s.fec_read))
        fresh = M.init_sample_state(b, cfg, pcm.device)._replace(
            rng=s.sstate.rng)
        s = s._replace(sstate=_bwhere(bl, fresh, s.sstate))
        if cw is not None:
            # after the rewind: the pointer replay starts from these values
            ch = _chain_causal(cw, s, L, bl, burg_feats, delay, False)

    # ---- conceal: drain the queued audio (teacher-forced); the update
    # path's frame net before the tmp synthesis rides the last iteration's
    # (disjoint masks, the same input expression). Two passes: the frame-rate
    # chain (PLC net, frame nets, queue bookkeeping) does not depend on the
    # sample-rate tails, so pass 1 does all frame-rate work and records each
    # iteration's conditioning, and pass 2 replays the teacher-forced tails,
    # whose PCM is discarded ------------------------------------------------
    saved = None
    saved_f = None
    drain = []
    for k in range(MAX_DRAIN):
        active = L & (s.pcm_fill > 0)
        count = torch.clamp(s.pcm_fill, max=FRAME_SIZE)
        output = s.pcm_buf[:, :FRAME_SIZE]
        s = _push_plc_ring(s, active)
        if ch is not None:
            s = s._replace(
                features=torch.where(active[:, None], _chain_feats(ch, k),
                                     s.features),
                plc_net=PM.PLCNetState(ch["h1s"][:, k], ch["h2s"][:, k]))
        else:
            s, _ = _fec_or_pred_masked(plc_params, s, active, delay)
        if k == MAX_DRAIN - 1 and enable_blending:
            saved_f = (s.fstate, s.cond_a, s.cond_b, s.lpc)
            fmask = active | bl
        else:
            fmask = active
        s = _fnet_masked(fused, s, _pad36(s.features), fmask, cfg)
        live = s.fstate.frame_count > cfg.lookahead
        drain.append((s.cond_a, s.cond_b, s.lpc, output,
                      torch.where(active & live, count,
                                  torch.zeros_like(count))))
        s = s._replace(
            pcm_buf=torch.where(active[:, None], _shift_buf(s.pcm_buf),
                                s.pcm_buf),
            pcm_fill=torch.where(active, s.pcm_fill - count, s.pcm_fill),
            skip_analysis=torch.where(active, s.skip_analysis + 1,
                                      s.skip_analysis))

    def _lost_featpred(s):
        # conceal: feature prediction and attenuation for the lost frame (a
        # queued FEC frame takes the prediction's place and resets the loss
        # count, src/lpcnet_plc.c:307-316)
        if ch is not None:
            kf = MAX_DRAIN
            fec_hit = ch["haves"][kf] & L
            s = s._replace(
                features=torch.where(L[:, None], _chain_feats(ch, kf),
                                     s.features),
                plc_net=PM.PLCNetState(ch["h1s"][:, kf], ch["h2s"][:, kf]),
                fec_read=ch["read"], fec_keep=ch["keep"], fec_skip=ch["skip"])
        else:
            s, fec_hit = _fec_or_pred_masked(plc_params, s, L, delay)
        lc = torch.where(fec_hit, torch.zeros_like(s.loss_count),
                         s.loss_count + 1)
        f0 = torch.clamp(s.features[:, 0] + _att_of(lc), min=-10.0)
        att_feats = torch.cat([f0[:, None], s.features[:, 1:]], dim=1)
        return s._replace(
            features=torch.where(L[:, None], att_feats, s.features),
            loss_count=torch.where(L, lc, s.loss_count))

    blv = bl if enable_blending else torch.zeros_like(bl)
    if kw is not None:
        # ---- the sample-rate section (the drain's pass 2 and both tails),
        # with all the frame-rate work that used to interleave with it
        # hoisted ahead, so the section can run on the active streams only
        # (_run_sample_section). The reordering is sound: the hoisted
        # operations touch disjoint state (PLC net, features, FEC pointers,
        # frame state and conditioning) and none reads the section's
        # outputs; the blend restore splits into its frame-rate half here
        # (frame state and conditioning, from pass 1's capture) and its
        # sample-state half inside the section after the tmp synthesis.
        s = _push_plc_ring(s, L)
        cond1 = (s.cond_a, s.cond_b, s.lpc)
        live1 = s.fstate.frame_count > cfg.lookahead
        saved_ss = s.sstate if enable_blending else None
        if enable_blending:
            s = s._replace(
                fstate=_bwhere(bl, saved_f[0], s.fstate),
                cond_a=torch.where(bl[:, None], saved_f[1], s.cond_a),
                cond_b=torch.where(bl[:, None], saved_f[2], s.cond_b),
                lpc=torch.where(bl[:, None], saved_f[3], s.lpc))
        s = _lost_featpred(s)
        s = _fnet_masked(fused, s, _pad36(s.features), L | blv, cfg)
        sec = dict(
            sstate=s.sstate, saved_ss=saved_ss,
            ca_blk=torch.stack([d[0] for d in drain], dim=1),
            cb_blk=torch.stack([d[1] for d in drain], dim=1),
            lpc_blk=torch.stack([d[2] for d in drain], dim=1),
            targets=torch.cat([d[3] for d in drain], dim=1),
            counts=torch.stack([d[4] for d in drain], dim=1),
            ca1=cond1[0], cb1=cond1[1], lpc1=cond1[2], live1=live1,
            ca2=s.cond_a, cb2=s.cond_b, lpc2=s.lpc,
            live2=s.fstate.frame_count > cfg.lookahead,
            pcm80=pcm[:, :_N1], delta=delta if remove_dc else None,
            L=L, bl=blv)
        new_ss, head, tail, pcm80 = _run_sample_section(
            kw, sec, enable_blending, remove_dc, compact_cap, stats)
        s = s._replace(sstate=new_ss)
        pcm = torch.cat([pcm80, pcm[:, _N1:]], dim=1)
        pcm_c = torch.cat([head, tail], dim=1)
    else:
        # ---- the float32 model: the drain's pass 2 and both tails in the
        # reference's order
        for k, (ca_k, cb_k, lpc_k, output, count) in enumerate(drain):
            if k == MAX_DRAIN - 1 and enable_blending:
                saved = (saved_f[0], s.sstate, saved_f[1], saved_f[2],
                         saved_f[3])
            s = s._replace(sstate=_tf_prefix(fused, s.sstate, ca_k, cb_k,
                                             lpc_k, output, count, None))

        # ---- shared sampled call 1: conceal head (lost) | update tmp ------
        # (codec mode has no tmp and resync synthesis: only lost streams
        # advance)
        s = _push_plc_ring(s, L)
        zp = torch.zeros((b, _N1), dtype=torch.float32, device=pcm.device)
        zm = torch.zeros((b, _N1), dtype=torch.bool, device=pcm.device)
        adv1 = (L | blv)[:, None].expand(b, _N1)
        s, k2 = _tail_masked(fused, s, zp, zm, adv1, cfg)
        head = k2                           # lost streams' first half-frame

        if enable_blending:
            # update path: cross-fade the model's continuation into the real
            # audio (with remove_dc the model's output carries the residual
            # synthesis DC, subtracted as the truncated delta,
            # src/lpcnet_plc.c:224-231)
            w = 0.5 - 0.5 * torch.cos(
                np.pi * torch.arange(_N1, dtype=torch.float32,
                                     device=pcm.device) / _N1)
            k2d = k2 - delta[:, None] if remove_dc else k2
            blended = torch.floor(0.5 + w * pcm[:, :_N1] + (1 - w) * k2d)
            pcm = torch.cat([torch.where(bl[:, None], blended, pcm[:, :_N1]),
                             pcm[:, _N1:]], dim=1)
            restored = _bwhere(
                bl, saved, (s.fstate, s.sstate, s.cond_a, s.cond_b, s.lpc))
            s = s._replace(fstate=restored[0], sstate=restored[1],
                           cond_a=restored[2], cond_b=restored[3],
                           lpc=restored[4])

        s = _lost_featpred(s)

        # ---- shared frame net: conceal before its tail | update after the
        # restore
        s = _fnet_masked(fused, s, _pad36(s.features), L | blv, cfg)

        # ---- shared call 2: conceal tail (free-running) | update resync
        # (teacher-forced)
        tf2 = blv[:, None].expand(b, _TO)
        adv2 = L[:, None].expand(b, _TO) | tf2
        s, tail = _tail_masked(fused, s, pcm[:, :_TO] * tf2, tf2, adv2, cfg)
        pcm_c = torch.cat([head, tail], dim=1)

    # ---- pcm queue management ---------------------------------------------
    # blending streams restart the queue from the unblended half-frame
    restart = torch.cat([pcm[:, _N1:], s.pcm_buf[:, _TO:]], dim=1)
    s = s._replace(
        pcm_buf=torch.where(bl[:, None], restart, s.pcm_buf),
        pcm_fill=torch.where(bl, torch.full_like(s.pcm_fill, _TO), s.pcm_fill))
    # skipping streams that do not blend queue this frame for later teacher
    # forcing
    nbs = G & skip & ~s.blend
    queued = _write_frame(s.pcm_buf, pcm, s.pcm_fill)
    s = s._replace(
        pcm_buf=torch.where(nbs[:, None], queued, s.pcm_buf),
        pcm_fill=torch.where(nbs, s.pcm_fill + FRAME_SIZE, s.pcm_fill))

    # ---- one feature-extraction step on the merged output -----------------
    enc_in = torch.where(L[:, None], pcm_c, pcm)
    s, enc_feats = _enc_step(s, enc_in)

    # update path: feed the PLC net with the real features
    nb_mask = G & ~blend_old
    s = _plc_pred_masked(plc_params, s,
                         _good_input(burg_feats, enc_feats[:, :NB_FEATURES]),
                         nb_mask)
    # a good frame moves the FEC pointer past this packet's slot
    # (src/lpcnet_plc.c:232-239)
    adv_skip = nb_mask & (s.fec_skip > 0)
    adv_read = nb_mask & ~adv_skip & (s.fec_read < s.fec_len)
    read2 = torch.where(adv_read, s.fec_read + 1, s.fec_read)
    s = s._replace(
        fec_read=read2,
        fec_keep=torch.where(nb_mask, torch.clamp(
            torch.maximum(s.fec_keep, read2 - delay - 1), min=0), s.fec_keep),
        fec_skip=torch.where(adv_skip, s.fec_skip - 1, s.fec_skip))

    steady = G & ~skip
    s = _push_feat_ring(s, enc_feats, G if enable_blending else steady)
    buf_app = torch.cat([s.pcm_buf[:, :plc_buf_size], pcm], dim=1)
    s = s._replace(
        pcm_buf=torch.where(steady[:, None], _shift_buf(buf_app), s.pcm_buf),
        skip_analysis=torch.where(G & skip, s.skip_analysis - 1,
                                  s.skip_analysis),
        loss_count=torch.where(G, torch.zeros_like(s.loss_count),
                               s.loss_count),
        blend=L.clone())

    if remove_dc:
        # conceal tracks the synthesised signal's DC and offsets its output;
        # update adds the removed input DC back (src/lpcnet_plc.c:263-266,
        # 234-235)
        s = s._replace(syn_dc=torch.where(
            L, _syn_dc_step(s.syn_dc, pcm_c), s.syn_dc))
        out = torch.where(L[:, None],
                          pcm_c + torch.floor(0.5 + s.dc_mem)[:, None],
                          pcm + lp)
    else:
        out = torch.where(L[:, None], pcm_c, pcm)
    return s, torch.clamp(out, -32768, 32767)


# --------------------------------------------------------------------------
# The non-causal mode (src/lpcnet_plc.c:342-492)
# --------------------------------------------------------------------------

def _enc_step_masked(s: BatchedPLCState, pcm, active):
    """One feature-extraction step that only `active` streams keep."""
    new_enc, feats = F.compute_single_frame_features(s.enc, pcm)
    return s._replace(enc=_bwhere(active, new_enc, s.enc)), feats


def _queued_body(fused, cfg, kw, sec):
    """The deferred resync queued by a recovery frame (src/lpcnet_plc.c:
    277-281) on explicit per-stream inputs: the frame net on the current
    features, then the queued samples teacher-forced, for the streams of
    `q` only."""
    q = sec["q"]
    new_f, _, caf, cbf, lpf = M.frame_network(fused, sec["fstate"],
                                              _pad36(sec["features"]), cfg)
    fst = _bwhere(q, new_f, sec["fstate"])
    ca, cb, lp = (torch.where(q[:, None], n, o) for n, o in
                  ((caf, sec["ca"]), (cbf, sec["cb"]), (lpf, sec["lpc"])))
    live = fst.frame_count > cfg.lookahead
    n = sec["queued_samples"].shape[-1]
    count = torch.where(q & live, n, 0).to(torch.int32)
    sst = _tf_prefix(fused, sec["sstate"], ca, cb, lp, sec["queued_samples"],
                     count, kw)
    return dict(fstate=fst, sstate=sst, ca=ca, cb=cb, lpc=lp)


def _process_queued_update(fused, s: BatchedPLCState, cfg, kw, cap=0):
    """`_queued_body` for the queued streams, at the full batch, or on the
    kernels' program compacted to them at capacity `cap` (a small share of a
    steady pool: the last frame's recoveries). Clears the queued flags."""
    sec = dict(q=s.queued, fstate=s.fstate, sstate=s.sstate,
               features=s.features, ca=s.cond_a, cb=s.cond_b, lpc=s.lpc,
               queued_samples=s.queued_samples)
    into = dict(fstate=s.fstate, sstate=s.sstate, ca=s.cond_a, cb=s.cond_b,
                lpc=s.lpc)
    out = _compacted(lambda c: _queued_body(fused, cfg, kw, c), sec,
                     s.queued, into, cap if kw is not None else 0)
    return s._replace(fstate=out["fstate"], sstate=out["sstate"],
                      cond_a=out["ca"], cond_b=out["cb"], lpc=out["lpc"],
                      queued=torch.zeros_like(s.queued))


def _nc_section_body(fused, cfg, kw, sec):
    """The non-causal step's sample-rate chain for the lost and recovering
    streams (L | rec) on explicit per-stream inputs: the conceal head or the
    recovery's forward tail (K2, 80 sampled steps, the buffered lookahead
    teacher-forced on a first loss); the recovery's frame net and its
    reverse-time resynthesis from a fresh sample state, RNG kept (K3, 160
    steps); the conceal tail or the recovery's reverse tail (K2, 80 sampled
    steps). Other streams are frozen by the masks, which is what makes
    compaction sound; the caller restores the recovering streams' frame
    state, conditioning and sample state after the section, so only the
    lost streams' sample state and the two tails carry forward."""
    b = sec["L"].shape[0]
    dev = sec["L"].device
    L, rec, first = sec["L"], sec["rec"], sec["first"]
    act = L | rec
    fst = sec["fstate"]
    ca, cb, lp = sec["ca"], sec["cb"], sec["lpc"]
    adv = (act & (fst.frame_count > cfg.lookahead))[:, None].expand(b, _TO)
    sst, t1 = _launch(
        K.synthesize_frame_masked_kernel, kw, sec["sstate"], ca.contiguous(),
        cb.contiguous(), lp.contiguous(), sec["buf_head"].contiguous(),
        first[:, None] & adv, adv, _TO)
    fresh = M.init_sample_state(b, cfg, dev)._replace(rng=sst.rng)
    sst = _bwhere(rec, fresh, sst)
    new_f, _, caf, cbf, lpf = M.frame_network(fused, fst,
                                              _pad36(sec["features"]), cfg)
    fst = _bwhere(rec, new_f, fst)
    ca2, cb2, lp2 = (torch.where(rec[:, None], n, o) for n, o in
                     ((caf, ca), (cbf, cb), (lpf, lp)))
    live = fst.frame_count > cfg.lookahead
    count = torch.where(rec & live, FRAME_SIZE, 0).to(torch.int32)
    sst = _tf_prefix(fused, sst, ca2, cb2, lp2, sec["rev"], count, kw)
    adv80 = (act & live)[:, None].expand(b, _N1)
    sst, t2 = _launch(
        K.synthesize_frame_masked_kernel, kw, sst, ca2.contiguous(),
        cb2.contiguous(), lp2.contiguous(),
        torch.zeros((b, _N1), dtype=torch.float32, device=dev),
        torch.zeros((b, _N1), dtype=torch.bool, device=dev), adv80, _N1)
    return dict(sstate=sst, fstate=fst, ca=ca2, cb=cb2, lpc=lp2, t1=t1, t2=t2)


def _run_nc_section(fused, cfg, kw, s: BatchedPLCState, L, rec, first, pcm,
                    cap, stats):
    """`_nc_section_body`, compacted to the L | rec streams when their
    number fits the capacity. Returns (state, t1, t2)."""
    b = L.shape[0]
    sec = dict(L=L, rec=rec, first=first, sstate=s.sstate, fstate=s.fstate,
               features=s.features, ca=s.cond_a, cb=s.cond_b, lpc=s.lpc,
               buf_head=s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE],
               rev=torch.flip(pcm, (1,)))
    zeros = torch.zeros((b, _TO), dtype=torch.float32, device=pcm.device)
    into = dict(sstate=s.sstate, fstate=s.fstate, ca=s.cond_a, cb=s.cond_b,
                lpc=s.lpc, t1=zeros, t2=zeros)
    out = _compacted(lambda c: _nc_section_body(fused, cfg, kw, c), sec,
                     L | rec, into, cap, stats)
    s = s._replace(sstate=out["sstate"], fstate=out["fstate"],
                   cond_a=out["ca"], cond_b=out["cb"], lpc=out["lpc"])
    return s, out["t1"], out["t2"]


def _set_head(buf, head):
    """buf with `head` in the buffer's head slot [80:160] (the lookahead
    half-frame)."""
    return torch.cat([buf[:, :FRAME_SIZE - _TO], head, buf[:, FRAME_SIZE:]],
                     dim=1)


def _plc_frame_step_nc_fused(state: BatchedPLCState, fused, plc_params, pcm,
                             lost, cfg, kw=None, remove_dc=False,
                             compact_cap: int = 0,
                             stats: Optional[dict] = None):
    """The non-causal PLC step as one interleaved program over a single
    state (the twin of `_plc_frame_step_fused`).

    The per-stream order of sub-operations and the RNG's lockstep are those
    of the two-path `_plc_frame_step_nc`; shared work: the deferred resync
    runs once instead of twice, the conceal head and the recovery's forward
    tail share one sampled call, the conceal tail and the recovery's
    reverse tail another, and the buffer re-analysis (continued loss,
    recovery) is one feature step. With the kernels (and without the DC
    filter, which interleaves full-batch DC passes between the calls) the
    lost and recovering streams' sample-rate chain runs as one section,
    compacted to them at capacity `compact_cap` (`_run_nc_section`), as is
    the deferred resync.

    remove_dc adds the reference's non-causal DC variant (src/lpcnet_plc.c:
    383-393, 404-426, 437-441): the processing runs DC-free; on recovery the
    tracker rewinds and runs again with the synthesised forward tail folded
    in; the half-frame output delay adds the offsets back through `dc_buf`.

    Returns (new state, output [B, 160] float, clipped to int16 range).
    """
    stats = stats if stats is not None else {"compacted": 0, "overflowed": 0,
                                              "full": 0}
    b = pcm.shape[0]
    dev = pcm.device
    s = state
    L = lost
    G = ~lost
    pcm = pcm.to(torch.float32)
    pcm_in = pcm

    # ---- shared: the deferred resync queued by a previous recovery -------
    s = _process_queued_update(fused, s, cfg, kw, compact_cap)

    # ---- DC removal, pass 1, on the incoming audio (good streams,
    # src/lpcnet_plc.c:404-412): the pending synthesis DC folds into the
    # tracker first; delta keeps its truncated residue for the blend --------
    if remove_dc:
        delta = torch.trunc(s.syn_dc)
        dc_out = torch.floor(0.5 + s.dc_mem)       # the conceal's offset
        mem_bak = s.dc_mem + s.syn_dc
        lp, dcm1 = _dc_path(mem_bak, pcm)
        pcm = torch.where(G[:, None], pcm - lp, pcm)
        s = s._replace(dc_mem=torch.where(G, dcm1, s.dc_mem),
                       syn_dc=torch.where(G, torch.zeros_like(s.syn_dc),
                                          s.syn_dc))
    pcm_save = pcm

    burg_feats = _burg(pcm)
    rec = G & (s.loss_count > 0)       # the first good frame after a loss
    gd = G & ~rec
    first = L & (s.loss_count == 0)    # the first lost frame

    # ---- shared PLC-net step: conceal (zero input) | recovery (Burg) ------
    inp = _good_input(burg_feats)
    s = _plc_pred_masked(plc_params, s,
                         torch.where(L[:, None], torch.zeros_like(inp), inp),
                         L | rec)
    # conceal: the attenuation takes the loss count before its increment
    # (src/lpcnet_plc.c:466 against :494)
    f0 = torch.clamp(s.features[:, 0] + _att_of(s.loss_count), min=-10.0)
    s = s._replace(features=torch.where(
        L[:, None], torch.cat([f0[:, None], s.features[:, 1:]], dim=1),
        s.features))

    saved = (s.fstate, s.sstate, s.cond_a, s.cond_b, s.lpc)

    # ---- shared frame net, then the L | rec sample-rate chain -------------
    s = _fnet_masked(fused, s, _pad36(s.features), L | rec, cfg)
    buf_head = s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE]
    # recovery keeps its forward tail in the buffer head; a continued loss
    # refreshes the head with its own continuation
    keeps_t1 = (rec | (L & ~first))[:, None]
    if kw is not None and not remove_dc:
        s, t1, t2 = _run_nc_section(fused, cfg, kw, s, L, rec, first, pcm,
                                    compact_cap, stats)
        head = torch.where(first[:, None], buf_head, t1)
        s = s._replace(pcm_buf=torch.where(keeps_t1, _set_head(s.pcm_buf, t1),
                                           s.pcm_buf))
    else:
        adv = (L | rec)[:, None].expand(b, _TO)
        s, t1 = _tail_masked(fused, s, buf_head, first[:, None] & adv, adv,
                             cfg, kw)
        head = torch.where(first[:, None], buf_head, t1)
        s = s._replace(pcm_buf=torch.where(keeps_t1, _set_head(s.pcm_buf, t1),
                                           s.pcm_buf))

        # ---- DC removal, pass 2 (recovery streams, src/lpcnet_plc.c:
        # 414-426): rewind the tracker, fold in the forward tail's
        # synthesis DC, remove again
        if remove_dc:
            syn_t1 = _syn_dc_step80(torch.zeros_like(s.syn_dc), t1)
            delta = torch.where(rec, torch.trunc(delta + syn_t1), delta)
            lp2, dcm2 = _dc_path(mem_bak + syn_t1, pcm_in)
            pcm = torch.where(rec[:, None], pcm_in - lp2, pcm)
            lp = torch.where(rec[:, None], lp2, lp)
            s = s._replace(dc_mem=torch.where(rec, dcm2, s.dc_mem))
            pcm_save = torch.where(rec[:, None], pcm, pcm_save)

        # recovery: reverse-time synthesis from the incoming audio
        fresh = M.init_sample_state(b, cfg, dev)._replace(rng=s.sstate.rng)
        s = s._replace(sstate=_bwhere(rec, fresh, s.sstate))
        s = _fnet_masked(fused, s, _pad36(s.features), rec, cfg)
        live = s.fstate.frame_count > cfg.lookahead
        s = s._replace(sstate=_tf_prefix(
            fused, s.sstate, s.cond_a, s.cond_b, s.lpc, torch.flip(pcm, (1,)),
            torch.where(rec & live, FRAME_SIZE, 0).to(torch.int32), kw))

        # ---- shared call 2 (80): conceal tail | recovery reverse tail ----
        adv80 = (L | rec)[:, None].expand(b, _N1)
        s, t2 = _tail_masked(
            fused, s, torch.zeros((b, _N1), dtype=torch.float32, device=dev),
            torch.zeros((b, _N1), dtype=torch.bool, device=dev), adv80, cfg,
            kw)
    pcm_c = torch.cat([head, t2], dim=1)

    # recovery: blend the reversed tail into the buffered forward tail, then
    # restore (with remove_dc the reverse synthesis carries the residual
    # DC, offset by the truncated delta, src/lpcnet_plc.c:437-441)
    w = torch.flip(0.5 - 0.5 * torch.cos(
        np.pi * torch.arange(_TO, dtype=torch.float32, device=dev) / _TO), (0,))
    fwd_head = s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE]
    t2_rev = torch.flip(t2, (1,))
    if remove_dc:
        t2_rev = t2_rev + delta[:, None]
    blended = torch.floor(0.5 + w * fwd_head + (1 - w) * t2_rev)
    s = s._replace(pcm_buf=torch.where(
        rec[:, None], _set_head(s.pcm_buf, blended), s.pcm_buf))
    restored = _bwhere(rec, saved,
                       (s.fstate, s.sstate, s.cond_a, s.cond_b, s.lpc))
    s = s._replace(fstate=restored[0], sstate=restored[1], cond_a=restored[2],
                   cond_b=restored[3], lpc=restored[4])
    qs = torch.cat([s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE], pcm[:, :_N1]],
                   dim=1)
    s = s._replace(queued=s.queued | rec,
                   queued_samples=torch.where(rec[:, None], qs,
                                              s.queued_samples))

    # ---- shared buffer re-analysis: continued-loss conceal | recovery -----
    new_enc, _ = F.compute_single_frame_features(
        s.enc, s.pcm_buf[:, :FRAME_SIZE])
    s = s._replace(enc=_bwhere(rec | (L & ~first), new_enc, s.enc))

    # ---- good-frame analysis and the steady streams' resync ---------------
    s, enc_feats = _enc_step_masked(s, pcm, G)
    s = _plc_pred_masked(plc_params, s,
                         _good_input(burg_feats, enc_feats[:, :NB_FEATURES]),
                         gd)
    s = _fnet_masked(fused, s, enc_feats, gd, cfg)
    tf_target = torch.cat([s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE],
                           pcm[:, :_N1]], dim=1)
    live = s.fstate.frame_count > cfg.lookahead
    s = s._replace(sstate=_tf_prefix(
        fused, s.sstate, s.cond_a, s.cond_b, s.lpc, tf_target,
        torch.where(gd & live, FRAME_SIZE, 0).to(torch.int32), kw))

    # ---- outputs, buffer and counters -------------------------------------
    out_u = torch.cat([s.pcm_buf[:, _TO:FRAME_SIZE], pcm[:, :_TO]], dim=1)
    conceal_buf = torch.cat([pcm_c[:, _TO:], s.pcm_buf[:, FRAME_SIZE - _TO:]],
                            dim=1)
    update_buf = torch.cat([pcm_save, s.pcm_buf[:, FRAME_SIZE:]], dim=1)
    s = s._replace(
        pcm_buf=torch.where(L[:, None], conceal_buf, update_buf),
        loss_count=torch.where(L, s.loss_count + 1,
                               torch.zeros_like(s.loss_count)))
    if remove_dc:
        # conceal tracks the synthesised signal's DC (the tail only on a
        # first loss, whose head is the buffered lookahead, src/lpcnet_plc.c:
        # 384-390); the half-frame delay adds offsets back via dc_buf
        syn_c = torch.where(first, _syn_dc_step80(s.syn_dc, t2),
                            _syn_dc_step(s.syn_dc, pcm_c))
        s = s._replace(syn_dc=torch.where(L, syn_c, s.syn_dc))
        out_c = pcm_c + torch.cat([s.dc_buf, dc_out[:, None].expand(b, _N1)],
                                  dim=1)
        out_u = out_u + torch.cat([s.dc_buf, lp[:, :_N1]], dim=1)
        s = s._replace(dc_buf=torch.where(
            L[:, None], dc_out[:, None].expand(b, _TO),
            lp[:, FRAME_SIZE - _TO:]))
        out = torch.where(L[:, None], out_c, out_u)
    else:
        out = torch.where(L[:, None], pcm_c, out_u)
    return s, torch.clamp(out, -32768, 32767)


# --------------------------------------------------------------------------
# The two-path steps (fused_step=False): each path on its own copy of the
# state, merged per stream. The reference the fused steps are held to.
# --------------------------------------------------------------------------

def _conceal_path(fused, plc_params, s: BatchedPLCState, cfg, kw=None):
    """src/lpcnet_plc.c:293-337 for every stream, the drain unrolled and
    masked (no FEC: the two-path step has no queue)."""
    b = s.features.shape[0]
    dev = s.features.device
    ones = torch.ones(b, dtype=torch.bool, device=dev)
    for i in range(MAX_DEFER):
        s = _fnet_masked(fused, s, s.feat_ring[:, i], i < s.feat_count, cfg)
    s = s._replace(feat_count=torch.zeros_like(s.feat_count))
    zeros_in = torch.zeros((b, PM.PLC_INPUT_SIZE), device=dev)
    steps = torch.arange(FRAME_SIZE, device=dev)[None, :]
    for _ in range(MAX_DRAIN):
        active = s.pcm_fill > 0
        count = torch.clamp(s.pcm_fill, max=FRAME_SIZE)
        output = s.pcm_buf[:, :FRAME_SIZE]
        s = _push_plc_ring(s, active)
        s = _plc_pred_masked(plc_params, s, zeros_in, active)
        s = _fnet_masked(fused, s, _pad36(s.features), active, cfg)
        adv = active[:, None] & (steps < count[:, None])
        s, _ = _tail_masked(fused, s, output, adv, adv, cfg, kw, sampled=False)
        s = s._replace(
            pcm_buf=torch.where(active[:, None], _shift_buf(s.pcm_buf),
                                s.pcm_buf),
            pcm_fill=torch.where(active, s.pcm_fill - count, s.pcm_fill),
            skip_analysis=torch.where(active, s.skip_analysis + 1,
                                      s.skip_analysis))
    s = _push_plc_ring(s, ones)
    z80 = torch.zeros((b, _N1), dtype=torch.float32, device=dev)
    zm80 = torch.zeros((b, _N1), dtype=torch.bool, device=dev)
    s, head = _tail_masked(fused, s, z80, zm80, ~zm80, cfg, kw)
    s = _plc_pred_masked(plc_params, s, zeros_in, ones)
    lc = s.loss_count + 1            # incremented before the attenuation
    f0 = torch.clamp(s.features[:, 0] + _att_of(lc), min=-10.0)
    s = s._replace(features=torch.cat([f0[:, None], s.features[:, 1:]], dim=1),
                   loss_count=lc)
    s = _fnet_masked(fused, s, _pad36(s.features), ones, cfg)
    s, tail = _tail_masked(fused, s, z80, zm80, ~zm80, cfg, kw)
    pcm = torch.cat([head, tail], dim=1)
    s, _ = _enc_step(s, pcm)
    s = s._replace(blend=torch.ones_like(s.blend))
    return s, torch.clamp(pcm, -32768, 32767)


def _update_path(fused, plc_params, s: BatchedPLCState, pcm, cfg,
                 enable_blending, delay, plc_buf_size, kw=None):
    """src/lpcnet_plc.c:188-290 for every stream (causal, no DC, no FEC)."""
    b = pcm.shape[0]
    dev = pcm.device
    burg_feats = _burg(pcm)
    skip = s.skip_analysis > 0
    bl = skip & s.blend
    if enable_blending:
        # restore the PLC net of before the loss and predict across the gap
        s = s._replace(plc_net=_bwhere(
            bl, tree_map(lambda x: x[delay], s.plc_ring), s.plc_net))
        s = _plc_pred_masked(plc_params, s, _good_input(burg_feats), bl)
        for _ in range(delay):
            s = _push_feat_ring(s, _pad36(s.features), bl)
        saved = (s.fstate, s.sstate, s.cond_a, s.cond_b, s.lpc)
        s = _fnet_masked(fused, s, _pad36(s.features), bl, cfg)
        adv = bl[:, None].expand(b, _N1)
        s, tmp = _tail_masked(
            fused, s, torch.zeros((b, _N1), dtype=torch.float32, device=dev),
            torch.zeros((b, _N1), dtype=torch.bool, device=dev), adv, cfg, kw)
        w = 0.5 - 0.5 * torch.cos(
            np.pi * torch.arange(_N1, dtype=torch.float32, device=dev) / _N1)
        blended = torch.floor(0.5 + w * pcm[:, :_N1] + (1 - w) * tmp)
        pcm = torch.cat([torch.where(bl[:, None], blended, pcm[:, :_N1]),
                         pcm[:, _N1:]], dim=1)
        # rewind and teacher-force the blended audio back in
        restored = _bwhere(bl, saved,
                           (s.fstate, s.sstate, s.cond_a, s.cond_b, s.lpc))
        s = s._replace(fstate=restored[0], sstate=restored[1],
                       cond_a=restored[2], cond_b=restored[3], lpc=restored[4])
        s = _fnet_masked(fused, s, _pad36(s.features), bl, cfg)
        s, _ = _tail_masked(fused, s, pcm[:, :_N1], adv, adv, cfg, kw,
                            sampled=False)
    else:
        # codec mode: rewind the PLC net one frame and clear the AR state
        if delay > 0:
            s = s._replace(plc_net=_bwhere(
                bl, tree_map(lambda x: x[delay - 1], s.plc_ring), s.plc_net))
        fresh = M.init_sample_state(b, cfg, dev)._replace(rng=s.sstate.rng)
        s = s._replace(sstate=_bwhere(bl, fresh, s.sstate))
    # blending streams restart the queue from the unblended half-frame
    restart = torch.cat([pcm[:, _N1:], s.pcm_buf[:, _TO:]], dim=1)
    s = s._replace(
        pcm_buf=torch.where(bl[:, None], restart, s.pcm_buf),
        pcm_fill=torch.where(bl, torch.full_like(s.pcm_fill, _TO), s.pcm_fill))
    # skipping streams that do not blend queue this frame for later teacher
    # forcing
    nbs = skip & ~s.blend
    s = s._replace(
        pcm_buf=torch.where(nbs[:, None], _write_frame(s.pcm_buf, pcm,
                                                       s.pcm_fill), s.pcm_buf),
        pcm_fill=torch.where(nbs, s.pcm_fill + FRAME_SIZE, s.pcm_fill))
    s, enc_feats = _enc_step(s, pcm)
    s = _plc_pred_masked(plc_params, s,
                         _good_input(burg_feats, enc_feats[:, :NB_FEATURES]),
                         ~s.blend)
    # steady streams run the deferred frame net and advance the queue;
    # skipping streams defer too, but only in blending mode (the codec
    # mode's frame net is resynchronised from scratch after a loss instead)
    steady = ~skip
    s = _push_feat_ring(s, enc_feats,
                        torch.ones_like(steady) if enable_blending else steady)
    buf_app = torch.cat([s.pcm_buf[:, :plc_buf_size], pcm], dim=1)
    s = s._replace(
        pcm_buf=torch.where(steady[:, None], _shift_buf(buf_app), s.pcm_buf),
        skip_analysis=torch.where(skip, s.skip_analysis - 1, s.skip_analysis),
        loss_count=torch.zeros_like(s.loss_count),
        blend=torch.zeros_like(s.blend))
    return s, torch.clamp(pcm, -32768, 32767)


def _conceal_path_nc(fused, plc_params, s: BatchedPLCState, cfg, kw=None):
    """lpcnet_plc_conceal_non_causal (src/lpcnet_plc.c:452-492) for every
    stream."""
    b = s.features.shape[0]
    dev = s.features.device
    ones = torch.ones(b, dtype=torch.bool, device=dev)
    s = _process_queued_update(fused, s, cfg, kw)
    s = _plc_pred_masked(plc_params, s,
                         torch.zeros((b, PM.PLC_INPUT_SIZE), device=dev), ones)
    # the non-causal mode attenuates with the count before its increment
    f0 = torch.clamp(s.features[:, 0] + _att_of(s.loss_count), min=-10.0)
    s = s._replace(features=torch.cat([f0[:, None], s.features[:, 1:]], dim=1))
    first = s.loss_count == 0
    buf_head = s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE]
    s = _fnet_masked(fused, s, _pad36(s.features), ones, cfg)
    adv = ones[:, None].expand(b, _TO)
    # a first loss teacher-forces the buffered lookahead; later ones run free
    s, t1 = _tail_masked(fused, s, buf_head, first[:, None] & adv, adv, cfg,
                         kw)
    head = torch.where(first[:, None], buf_head, t1)
    s, tail = _tail_masked(
        fused, s, torch.zeros((b, _N1), dtype=torch.float32, device=dev),
        torch.zeros((b, _N1), dtype=torch.bool, device=dev),
        ones[:, None].expand(b, _N1), cfg, kw)
    pcm = torch.cat([head, tail], dim=1)
    # a continued loss refreshes the buffer head and analyses it again
    s = s._replace(pcm_buf=torch.where(first[:, None], s.pcm_buf,
                                       _set_head(s.pcm_buf, t1)))
    new_enc, _ = F.compute_single_frame_features(s.enc,
                                                 s.pcm_buf[:, :FRAME_SIZE])
    s = s._replace(enc=_bwhere(~first, new_enc, s.enc))
    s = s._replace(
        pcm_buf=torch.cat([pcm[:, _TO:], s.pcm_buf[:, FRAME_SIZE - _TO:]],
                          dim=1),
        loss_count=s.loss_count + 1)
    return s, torch.clamp(pcm, -32768, 32767)


def _update_path_nc(fused, plc_params, s: BatchedPLCState, pcm, cfg, kw=None):
    """lpcnet_plc_update_non_causal (src/lpcnet_plc.c:349-450) for every
    stream, without the DC filter."""
    b = pcm.shape[0]
    dev = pcm.device
    s = _process_queued_update(fused, s, cfg, kw)
    pcm_save = pcm
    burg_feats = _burg(pcm)
    rec = s.loss_count > 0          # the first good frame after a loss
    # ---- recovery: predict across the gap, blend backwards into the buffer
    inp = _good_input(burg_feats)
    s = _plc_pred_masked(plc_params, s, inp, rec)
    saved = (s.fstate, s.sstate, s.cond_a, s.cond_b, s.lpc)
    s = _fnet_masked(fused, s, _pad36(s.features), rec, cfg)
    adv_to = rec[:, None].expand(b, _TO)
    z80 = torch.zeros((b, _TO), dtype=torch.float32, device=dev)
    zm80 = torch.zeros((b, _TO), dtype=torch.bool, device=dev)
    s, fwd = _tail_masked(fused, s, z80, zm80, adv_to, cfg, kw)
    s = s._replace(pcm_buf=torch.where(rec[:, None], _set_head(s.pcm_buf, fwd),
                                       s.pcm_buf))
    # reverse-time synthesis from the incoming audio back toward the gap
    fresh = M.init_sample_state(b, cfg, dev)._replace(rng=s.sstate.rng)
    s = s._replace(sstate=_bwhere(rec, fresh, s.sstate))
    adv160 = rec[:, None].expand(b, FRAME_SIZE)
    s = _fnet_masked(fused, s, _pad36(s.features), rec, cfg)
    s, _ = _tail_masked(fused, s, torch.flip(pcm, (1,)), adv160, adv160, cfg,
                        kw, sampled=False)
    s, rev_tail = _tail_masked(fused, s, z80, zm80, adv_to, cfg, kw)
    w = torch.flip(0.5 - 0.5 * torch.cos(
        np.pi * torch.arange(_TO, dtype=torch.float32, device=dev) / _TO), (0,))
    head = s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE]
    blended = torch.floor(0.5 + w * head + (1 - w) * torch.flip(rev_tail, (1,)))
    s = s._replace(pcm_buf=torch.where(rec[:, None],
                                       _set_head(s.pcm_buf, blended),
                                       s.pcm_buf))
    restored = _bwhere(rec, saved,
                       (s.fstate, s.sstate, s.cond_a, s.cond_b, s.lpc))
    s = s._replace(fstate=restored[0], sstate=restored[1], cond_a=restored[2],
                   cond_b=restored[3], lpc=restored[4])
    qs = torch.cat([s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE], pcm[:, :_N1]],
                   dim=1)
    s = s._replace(queued=s.queued | rec,
                   queued_samples=torch.where(rec[:, None], qs,
                                              s.queued_samples))
    new_enc, _ = F.compute_single_frame_features(s.enc,
                                                 s.pcm_buf[:, :FRAME_SIZE])
    s = s._replace(enc=_bwhere(rec, new_enc, s.enc))
    # ---- every stream: analyse the incoming frame
    s, enc_feats = _enc_step(s, pcm)
    good = ~rec
    s = _plc_pred_masked(plc_params, s,
                         _good_input(burg_feats, enc_feats[:, :NB_FEATURES]),
                         good)
    s = _fnet_masked(fused, s, enc_feats, good, cfg)
    adv_g = good[:, None].expand(b, _TO)
    s, _ = _tail_masked(fused, s, s.pcm_buf[:, FRAME_SIZE - _TO:FRAME_SIZE],
                        adv_g, adv_g, cfg, kw, sampled=False)
    s, _ = _tail_masked(fused, s, pcm[:, :_N1], adv_g, adv_g, cfg, kw,
                        sampled=False)
    out = torch.cat([s.pcm_buf[:, _TO:FRAME_SIZE], pcm[:, :_TO]], dim=1)
    s = s._replace(
        pcm_buf=torch.cat([pcm_save, s.pcm_buf[:, FRAME_SIZE:]], dim=1),
        loss_count=torch.zeros_like(s.loss_count))
    return s, torch.clamp(out, -32768, 32767)


def _merge_paths(lost, s_c, out_c, s_u, out_u):
    """Per stream: the conceal path's state and output where lost, else the
    update path's (the ring's leaves are [R, B, H])."""
    ring = tree_map(lambda c, u: torch.where(lost[None, :, None], c, u),
                    s_c.plc_ring, s_u.plc_ring)
    merged = _bwhere(lost, s_c._replace(plc_ring=None),
                     s_u._replace(plc_ring=None))
    return (merged._replace(plc_ring=ring),
            torch.where(lost[:, None], out_c, out_u))


def _plc_frame_step(state: BatchedPLCState, fused, plc_params, pcm, lost,
                    cfg, enable_blending, delay, plc_buf_size, kw=None):
    """The causal step as two paths on copies of the state, merged."""
    pcm = pcm.to(torch.float32)
    s_c, out_c = _conceal_path(fused, plc_params, state, cfg, kw)
    s_u, out_u = _update_path(fused, plc_params, state, pcm, cfg,
                              enable_blending, delay, plc_buf_size, kw)
    return _merge_paths(lost, s_c, out_c, s_u, out_u)


def _plc_frame_step_nc(state: BatchedPLCState, fused, plc_params, pcm, lost,
                       cfg, enable_blending, delay, plc_buf_size, kw=None):
    """The non-causal step as two paths on copies of the state, merged."""
    pcm = pcm.to(torch.float32)
    s_c, out_c = _conceal_path_nc(fused, plc_params, state, cfg, kw)
    s_u, out_u = _update_path_nc(fused, plc_params, state, pcm, cfg, kw)
    return _merge_paths(lost, s_c, out_c, s_u, out_u)
