"""The plain reference of configuration lpcnet-384-16: packet decode (the
packet's four feature frames, the frame network, LPC from the cepstrum and
the step-by-step sample loop with the C library's bit-tree sampler, in the
int8 DOT_PROD numerics) and the training step (the teacher-forced graph with
float32 GRU recurrences, the loss, Adam and the weight clip).

Built on `frozen/`. It takes from the benchmark the raw float32 weights and
the inputs, and derives the fused and quantized forms itself.
"""

from __future__ import annotations

import statistics
from pathlib import Path
from typing import NamedTuple

import torch

from .frozen.codec import packet as P
from .frozen.codec import quantize as QZ
from .frozen.codec.codebooks import Codebooks, load_codebooks
from .frozen.dsp.constants import MULTI_MASK, NB_BANDS, NB_TOTAL_FEATURES
from .frozen.models import lpcnet as M
from .frozen.nn import layers as NN
from .frozen.nn import quantized as Q
from .frozen.train import losses as LL

# the shipped codebooks, a raw file the program reads too
CODEBOOKS = (Path(__file__).resolve().parents[2] / "lpcnet_tpu" / "data"
             / "codebooks.npz")


def model_config(c: dict) -> M.LPCNetConfig:
    return M.LPCNetConfig(rnn_units1=c["rnn_units1"], rnn_units2=c["rnn_units2"],
                          cond_size=c["cond_size"],
                          nb_used_features=c["nb_used_features"],
                          frame_size=c["frame_size"], conv_kernel=c["conv_kernel"],
                          pitch_embed_dim=c["pitch_embed_dim"],
                          lookahead=c["lookahead"])


# --------------------------------------------------------------------------
# Serving: packet decode
# --------------------------------------------------------------------------

def _coarse(w_q8: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 weights rounded to `bits` bits, kept on the int8 scale."""
    step = 1 << (8 - bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return (torch.clamp(torch.round(w_q8.float() / step), lo, hi) * step
            ).to(torch.int8)


def per_column_q8(x):
    """float [K, N] -> (int8 [K, N], scale [N]): each column's largest
    magnitude maps to 127, rounding half to even."""
    scale = torch.clamp(x.abs().amax(dim=0), min=1e-10) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def served_weights(params, cfg: M.LPCNetConfig, gru_bits: int = 8):
    """The served int8 weights from raw params: the export's fused tables
    (dump_lpcnet.py:333-350), the DOT_PROD GRU matrices, and the three
    composed [256, 3Na] embedding tables stacked and in int8 with
    per-column scales (the served q8 form the configuration states).
    gru_bits=4 rounds the int8 GRU matrices to 4 bits: the control's lower
    precision."""
    fused = Q.quantize_fused(M.fuse_inference_params(params, cfg))
    emb = torch.cat([fused["embed_sig_a"], fused["embed_pred_a"],
                     fused["embed_exc_a"]], dim=0).to(torch.float32)
    fused["emb_q8"], scale = per_column_q8(emb)
    fused["emb_scale"] = scale[None, :]
    if gru_bits != 8:
        fused["gru_a_rec"] = dict(fused["gru_a_rec"], recurrent_q8=_coarse(
            fused["gru_a_rec"]["recurrent_q8"], gru_bits))
        fused["gru_b_rec"] = dict(fused["gru_b_rec"], recurrent_q8=_coarse(
            fused["gru_b_rec"]["recurrent_q8"], gru_bits))
        fused["gru_b_in_q8"] = _coarse(fused["gru_b_in_q8"], gru_bits)
    return fused


def codebooks(device) -> Codebooks:
    return load_codebooks(str(CODEBOOKS), device)


class DecodeState(NamedTuple):
    frame_state: M.FrameState
    sample_state: M.SampleState
    vq_mem: torch.Tensor


def init_decode_state(batch: int, cfg: M.LPCNetConfig, device) -> DecodeState:
    """A fresh stream in every slot: a one-stream decoder's state (its
    KISS99 words those of stream 0), repeated."""
    one = M.init_sample_state(1, cfg, device)
    sstate = M.init_sample_state(batch, cfg, device)
    rng = M.Kiss99State(*(w.expand(batch).clone() for w in one.rng))
    return DecodeState(M.init_frame_state(batch, cfg, device),
                       sstate._replace(rng=rng),
                       torch.zeros((batch, NB_BANDS), device=device))


def decode_packet_features(fields, vq_mem, cbs: Codebooks):
    """Wire fields ({name: [B] int}) and vq_mem [B, 18] -> (features
    [B, 4, 36], new vq_mem) (decode_packet, src/lpcnet_dec.c:81-155)."""
    f = {k: v.long() for k, v in fields.items()}
    c0_id = f["c0_id"] - 64
    modulation = f["modulation"] - 4
    voiced = modulation != -4
    modulation = torch.where(voiced, modulation, 0)
    period_feat, corr_feat = QZ.dequantize_pitch(f["main_pitch"], modulation,
                                                 f["corr_id"], voiced)
    f3 = torch.cat([(c0_id.to(torch.float32) / 4.0)[:, None],
                    cbs.stage1[f["vq_end0"]] + cbs.stage2[f["vq_end1"]]
                    + cbs.stage3[f["vq_end2"]]], dim=-1)
    vq_mid = f["vq_mid"]
    n = cbs.diff4.shape[0]
    sign = torch.where(vq_mid >= n, -1.0, 1.0)
    idx = vq_mid & (n - 1)
    diff = sign[:, None] * cbs.diff4[idx]
    sel = (idx & MULTI_MASK)[:, None]
    pred = torch.where(sel < 2, 0.5 * (vq_mem + f3),
                       torch.where(sel == 2, vq_mem, f3))
    f1 = diff + pred
    f0, f2 = QZ.apply_double_interp(vq_mem, f1, f3, f["interp"])
    b = f3.shape[0]
    feats = f3.new_zeros((b, 4, NB_TOTAL_FEATURES))
    feats[..., :NB_BANDS] = torch.stack([f0, f1, f2, f3], dim=1)
    feats[..., NB_BANDS] = period_feat
    feats[..., NB_BANDS + 1] = corr_feat[:, None]
    return feats, f3


def _select(mask, new, old):
    if isinstance(new, tuple):
        return type(new)(*(_select(mask, a, b) for a, b in zip(new, old)))
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def decode_frame(fused, cfg, fstate, sstate, feats):
    """One feature frame through the frame network and the sample loop,
    with the C library's warm-up: silence, and the sample state held, until
    the frame network's pipeline is primed (src/lpcnet.c:239-243)."""
    fstate, _, ca, cb, lpc = M.frame_network(fused, fstate, feats, cfg)
    new_sstate, pcm = M.synthesize_frame(fused, sstate, ca, cb, lpc)
    live = fstate.frame_count > cfg.lookahead
    return (fstate, _select(live, new_sstate, sstate),
            torch.where(live[:, None], pcm, 0.0))


@torch.no_grad()
def decode_tick(fused, cfg, cbs, state: DecodeState, packets):
    """packets [B, 8] uint8 (numpy) -> (new state, pcm [B, 640] float, the
    int16 values)."""
    dev = state.vq_mem.device
    fields = {k: torch.as_tensor(v, device=dev)
              for k, v in P.unpack_fields(packets).items()}
    feats, vq_mem = decode_packet_features(fields, state.vq_mem, cbs)
    fstate, sstate, pcm = state.frame_state, state.sample_state, []
    for k in range(4):
        fstate, sstate, out = decode_frame(fused, cfg, fstate, sstate,
                                           feats[:, k])
        pcm.append(out)
    return DecodeState(fstate, sstate, vq_mem), torch.cat(pcm, dim=-1)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def weight_clip(w, c: float = 0.992):
    """Pairwise-saturation weight clip (training_tf2/lpcnet.py:216-232):
    |w[2i]| + |w[2i+1]| <= 2c along pairs of axis 1."""
    pair = w[:, 1::2].abs() + w[:, 0::2].abs()
    return c * w / torch.clamp(pair.repeat_interleave(2, dim=1), min=c)


def _fp8(x):
    return x.to(torch.float8_e4m3fn).to(torch.float32)


def gru_seq_fp8(params, x, h0=None):
    """The GRU recurrence with its products on float8 (e4m3) operands: the
    control's lower precision."""
    n = params["recurrent"].shape[0]
    gate_in = torch.matmul(_fp8(x), _fp8(params["kernel"])) + params["bias"][0]
    w = _fp8(params["recurrent"])
    h = h0 if h0 is not None else x.new_zeros(x.shape[:-2] + (n,))
    hs = []
    for t in range(x.shape[-2]):
        zrec = torch.matmul(_fp8(h), w) + params["bias"][1]
        h = NN._gru_gates(h, gate_in[..., t, :], zrec, "tanh")
        hs.append(h)
    return torch.stack(hs, dim=-2), h


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def train_steps(params, cfg: M.LPCNetConfig, tc: dict, batches, seeds,
                device, precision: str = "f32"):
    """len(seeds) training steps from raw `params` on `batches` (one each),
    the noise of step k drawn from a device generator seeded with seeds[k].
    precision "fp8" takes float8 GRU operands (the control).

    Returns {"losses": [...], "grad_norms": {leaf: norm of step 1's
    gradient}, "change_norms": {leaf: norm of the change after the last
    step}}."""
    gru_seq = gru_seq_fp8 if precision == "fp8" else None
    p = {k: {kk: vv.detach().clone().requires_grad_(True)
             for kk, vv in v.items()} for k, v in params.items()}
    flat = dict(_leaves(p))
    opt = torch.optim.Adam(list(flat.values()), lr=tc["lr"],
                           betas=(tc["beta1"], tc["beta2"]), eps=1e-7)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 1.0 / (1.0 + tc["decay"] * t))
    gen = torch.Generator(device=device)
    b = batches[0]["sig_in"].shape[0]
    states = (torch.zeros((b, cfg.rnn_units1), device=device),
              torch.zeros((b, cfg.rnn_units2), device=device))
    losses, grad_norms = [], {}
    for k, seed in enumerate(seeds):
        batch = batches[k]
        gen.manual_seed(seed)
        opt.zero_grad(set_to_none=True)
        out = M.training_forward(p, cfg, batch["sig_in"], batch["features"],
                                 batch["periods"], lpc=batch["lpc"], rng=gen,
                                 training=True, gru_states=states,
                                 noise_std=tc["input_noise"], gru_seq=gru_seq)
        loss = LL.metric_cel_tree(batch["sig_out"], out["tensor_preds"],
                                  out["tree_probs"]).mean()
        loss.backward()
        if k == 0:
            grad_norms = {n: float(t.grad.norm()) for n, t in flat.items()}
        opt.step()
        sched.step()
        with torch.no_grad():
            for name in ("gru_a/recurrent", "gru_b/kernel", "gru_b/recurrent"):
                flat[name].copy_(weight_clip(flat[name]))
        states = tuple(h.detach() for h in out["gru_states"])
        losses.append(float(loss.detach()))
        del out, loss
    change = {n: float((t.detach() - dict(_leaves(params))[n]).norm())
              for n, t in flat.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def train_gaps(prog: dict, ref: dict) -> dict:
    """The training numbers compared: the widest relative gap of the three
    losses; of step 1's gradient norm by leaf and of the change's norm by
    leaf, each against the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam and
    are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad_norms"].values())
    grad = max(abs(prog["grad_norms"][n] - r) / max(r, g_med)
               for n, r in ref["grad_norms"].items())
    moved = [n for n, g in ref["grad_norms"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change_norms"][n] for n in moved)
    change = max(abs(prog["change_norms"][n] - ref["change_norms"][n])
                 / max(ref["change_norms"][n], c_med) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
