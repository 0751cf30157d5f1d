# Frozen copy of lpcnet_torch/plc/batched.py at commit d7e6271, kept to its plain
# paths. Part of the benchmark's yardstick: not to be edited.
"""Frozen copy of the causal batched PLC frame step, plain path only.

Copied from `lpcnet_torch/plc/batched.py` (`_plc_frame_step_fused` with no
kernel bundle, blending on, no DC filter, no chain kernel) and its helpers,
with the kernel, chain, ablation, compaction and non-causal code taken out.
The sample-rate work runs step by step in float32 or q8
(`models.lpcnet.synthesize_frame_masked`). Not to be edited: it is part of
the benchmark's yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..codec import features as F
from ..dsp.burg import burg_cepstral_analysis
from ..dsp.constants import FRAME_SIZE, NB_BANDS, NB_FEATURES, TRAINING_OFFSET
from ..models import lpcnet as M
from ..models import plc as PM

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


def init_state(b: int, cfg: M.LPCNetConfig, plc_cfg: PM.PLCConfig,
               fec_q: int, device) -> BatchedPLCState:
    """BatchedPLC.init_state: every stream's state at its start."""
    dev, delay = device, cfg.lookahead
    plc_buf_size = delay * FRAME_SIZE + _TO
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    net = PM.init_state(b, plc_cfg, dev)
    ring = PM.PLCNetState(*(x[None].repeat(delay + 1, 1, 1)
                            for x in net))
    return BatchedPLCState(
        fstate=M.init_frame_state(b, cfg, dev),
        sstate=M.init_sample_state(b, cfg, dev),
        cond_a=z(b, 3 * cfg.rnn_units1), cond_b=z(b, 3 * cfg.rnn_units2),
        lpc=z(b, 16),
        feat_ring=z(b, MAX_DEFER, 36), feat_count=zi(b),
        enc=F.init_encoder_state(b, dev),
        plc_net=net, plc_ring=ring, features=z(b, NB_FEATURES),
        pcm_buf=z(b, plc_buf_size + FRAME_SIZE),
        pcm_fill=torch.full((b,), plc_buf_size, dtype=torch.int32,
                            device=dev),
        skip_analysis=zi(b), blend=zb(b), loss_count=zi(b),
        queued=zb(b), queued_samples=z(b, FRAME_SIZE),
        fec_feats=z(b, fec_q, NB_FEATURES),
        fec_len=zi(b), fec_read=zi(b), fec_keep=zi(b), fec_skip=zi(b),
        dc_mem=z(b), syn_dc=z(b), dc_buf=z(b, _TO))


def _fnet_masked(fused, s: BatchedPLCState, feats36, active, cfg):
    new_f, _, ca, cb, lpc = M.frame_network(fused, s.fstate, feats36, cfg)
    merged = _bwhere(active, (new_f, ca, cb, lpc),
                     (s.fstate, s.cond_a, s.cond_b, s.lpc))
    return s._replace(fstate=merged[0], cond_a=merged[1], cond_b=merged[2],
                      lpc=merged[3])


def _tail_masked(fused, s: BatchedPLCState, preload, preload_mask,
                 advance_mask, cfg):
    """Sample-rate tail gated by the conv warmup: a stream still in warmup
    neither advances nor emits; the step-by-step float32 (or q8) model."""
    live = s.fstate.frame_count > cfg.lookahead
    adv = advance_mask & live[:, None]
    new_ss, pcm = M.synthesize_frame_masked(
        fused, s.sstate, s.cond_a, s.cond_b, s.lpc, preload,
        preload_mask & adv, adv)
    return s._replace(sstate=new_ss), pcm


def _tf_prefix(fused, sstate: M.SampleState, ca, cb, lpc, targets, count):
    """`count[i]` teacher-forced steps of stream i on explicit conditioning
    (count 0 freezes it), the sampler's draws still taken. Returns the new
    sample state."""
    n = targets.shape[-1]
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
    """The PLC net's step."""
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


def _plc_pred_masked(plc_params, s: BatchedPLCState, plc_in, active,
                     set_features=True):
    new_net, out = _plc_pred(plc_params, s.plc_net, plc_in)
    s = s._replace(plc_net=_bwhere(active, new_net, s.plc_net))
    if set_features:
        s = s._replace(features=torch.where(active[:, None],
                                            out[:, :NB_FEATURES], s.features))
    return s


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
    """The frame's Burg cepstra [B, 36]."""
    return burg_cepstral_analysis(pcm)


def _enc_step(s: BatchedPLCState, pcm):
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
def _att_of(lc):
    """Energy attenuation for loss count lc."""
    table = torch.as_tensor(ATT_TABLE, device=lc.device)
    return torch.where(lc >= 10, float(ATT_TABLE[9]) - 2.0 * (lc - 9),
                       table[torch.clamp(lc, max=9).long()])


def plc_frame_step(state: BatchedPLCState, fused, plc_params, pcm, lost,
                   cfg):
    """The causal PLC step with blending, as one interleaved program over a
    single state (`_plc_frame_step_fused` on its plain path): the conceal
    path (src/lpcnet_plc.c:293-337) for the lost streams and the update
    path (:188-290) for the others, masked per stream.

    Returns (new state, output [B, 160] float, clipped to int16 range).
    """
    delay = cfg.lookahead
    plc_buf_size = delay * FRAME_SIZE + _TO
    b = pcm.shape[0]
    s = state
    L = lost
    G = ~lost
    pcm = pcm.to(torch.float32)

    # ---- update-path frame-level prep (good streams) ----------------------
    burg_feats = _burg(pcm)
    skip = s.skip_analysis > 0
    bl = G & skip & s.blend
    blend_old = s.blend

    # ---- conceal: run the deferred frame nets (lost streams), one by one --
    for i in range(MAX_DEFER):
        s = _fnet_masked(fused, s, s.feat_ring[:, i],
                         L & (i < s.feat_count), cfg)
    s = s._replace(feat_count=torch.where(L, torch.zeros_like(s.feat_count),
                                          s.feat_count))

    ring_at = lambda k: tree_map(lambda x: x[k], s.plc_ring)
    # update path: restore the PLC net of before the loss, predict the gap
    s = s._replace(plc_net=_bwhere(bl, ring_at(delay), s.plc_net))
    s = _plc_pred_masked(plc_params, s, _good_input(burg_feats), bl)
    for _ in range(delay):
        s = _push_feat_ring(s, _pad36(s.features), bl)

    # ---- conceal: drain the queued audio (teacher-forced); the update
    # path's frame net before the tmp synthesis rides the last iteration's
    saved_f = None
    drain = []
    for k in range(MAX_DRAIN):
        active = L & (s.pcm_fill > 0)
        count = torch.clamp(s.pcm_fill, max=FRAME_SIZE)
        output = s.pcm_buf[:, :FRAME_SIZE]
        s = _push_plc_ring(s, active)
        s, _ = _fec_or_pred_masked(plc_params, s, active, delay)
        if k == MAX_DRAIN - 1:
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

    saved = None
    for k, (ca_k, cb_k, lpc_k, output, count) in enumerate(drain):
        if k == MAX_DRAIN - 1:
            saved = (saved_f[0], s.sstate, saved_f[1], saved_f[2], saved_f[3])
        s = s._replace(sstate=_tf_prefix(fused, s.sstate, ca_k, cb_k, lpc_k,
                                         output, count))

    # ---- sampled call 1: conceal head (lost) | update tmp (blending) ------
    s = _push_plc_ring(s, L)
    zp = torch.zeros((b, _N1), dtype=torch.float32, device=pcm.device)
    zm = torch.zeros((b, _N1), dtype=torch.bool, device=pcm.device)
    adv1 = (L | bl)[:, None].expand(b, _N1)
    s, k2 = _tail_masked(fused, s, zp, zm, adv1, cfg)
    head = k2

    # update path: cross-fade the model's continuation into the real audio
    w = 0.5 - 0.5 * torch.cos(
        np.pi * torch.arange(_N1, dtype=torch.float32, device=pcm.device) / _N1)
    blended = torch.floor(0.5 + w * pcm[:, :_N1] + (1 - w) * k2)
    pcm = torch.cat([torch.where(bl[:, None], blended, pcm[:, :_N1]),
                     pcm[:, _N1:]], dim=1)
    restored = _bwhere(bl, saved, (s.fstate, s.sstate, s.cond_a, s.cond_b,
                                   s.lpc))
    s = s._replace(fstate=restored[0], sstate=restored[1], cond_a=restored[2],
                   cond_b=restored[3], lpc=restored[4])

    # conceal: feature prediction and attenuation for the lost frame (a
    # queued FEC frame takes the prediction's place and resets the loss
    # count, src/lpcnet_plc.c:307-316)
    s, fec_hit = _fec_or_pred_masked(plc_params, s, L, delay)
    lc = torch.where(fec_hit, torch.zeros_like(s.loss_count),
                     s.loss_count + 1)
    f0 = torch.clamp(s.features[:, 0] + _att_of(lc), min=-10.0)
    att_feats = torch.cat([f0[:, None], s.features[:, 1:]], dim=1)
    s = s._replace(features=torch.where(L[:, None], att_feats, s.features),
                   loss_count=torch.where(L, lc, s.loss_count))

    # ---- shared frame net: conceal before its tail | update after restore
    s = _fnet_masked(fused, s, _pad36(s.features), L | bl, cfg)

    # ---- call 2: conceal tail (free-running) | update resync (forced) -----
    tf2 = bl[:, None].expand(b, _TO)
    adv2 = L[:, None].expand(b, _TO) | tf2
    s, tail = _tail_masked(fused, s, pcm[:, :_TO] * tf2, tf2, adv2, cfg)
    pcm_c = torch.cat([head, tail], dim=1)

    # ---- pcm queue management ---------------------------------------------
    restart = torch.cat([pcm[:, _N1:], s.pcm_buf[:, _TO:]], dim=1)
    s = s._replace(
        pcm_buf=torch.where(bl[:, None], restart, s.pcm_buf),
        pcm_fill=torch.where(bl, torch.full_like(s.pcm_fill, _TO), s.pcm_fill))
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
    adv_skip = nb_mask & (s.fec_skip > 0)
    adv_read = nb_mask & ~adv_skip & (s.fec_read < s.fec_len)
    read2 = torch.where(adv_read, s.fec_read + 1, s.fec_read)
    s = s._replace(
        fec_read=read2,
        fec_keep=torch.where(nb_mask, torch.clamp(
            torch.maximum(s.fec_keep, read2 - delay - 1), min=0), s.fec_keep),
        fec_skip=torch.where(adv_skip, s.fec_skip - 1, s.fec_skip))

    steady = G & ~skip
    s = _push_feat_ring(s, enc_feats, G)
    buf_app = torch.cat([s.pcm_buf[:, :plc_buf_size], pcm], dim=1)
    s = s._replace(
        pcm_buf=torch.where(steady[:, None], _shift_buf(buf_app), s.pcm_buf),
        skip_analysis=torch.where(G & skip, s.skip_analysis - 1,
                                  s.skip_analysis),
        loss_count=torch.where(G, torch.zeros_like(s.loss_count),
                               s.loss_count),
        blend=L.clone())
    out = torch.where(L[:, None], pcm_c, pcm)
    return s, torch.clamp(out, -32768, 32767)
