"""The plain reference of configuration dred-rdovae-dec-256-80: DRED's
receiving side for a batch of streams. Each redundancy payload parsed in
plain Python (its header, its PVQ state index decoded in Python integers,
its latents range-decoded one binary decision at a time), the symbols
unquantised at their levels, and the RDO-VAE's decoder (`CoreDecoder`,
torch/rdovae/rdovae/rdovae.py; dred_rdovae_dec_init_states and
dred_rdovae_decode_qframe, src/dred_rdovae_dec.c:37-98, driven as
DRED_rdovae_decode_all, src/dred_rdovae.c:38-52) initialised from the
pulses' unit vector and stepped over the latents newest first, 4 feature
frames a latent.

Built on `frozen/` (`frozen/models/rdovae.py`: the configuration, `_dense`,
`_gru`, the statistical model; `frozen/dred/entropy.py`: the fixed-point
tables, the index width and the payload's levels), float32 products with
TF32 off as the run sets it. It takes from the benchmark the raw float32
weights and the payloads' bytes.

Departures from `CoreDecoder`:

- one latent a step, the C decoder's streaming form, where `CoreDecoder`
  runs the sequence at once: the same recurrence;
- the GRUs in the Keras reset-after layout (gates z, r, h; input and
  recurrent biases apart) where `torch.nn.GRU` orders r, z, n: the same
  equations;
- the payload is the port's framing and binary range coder (a 3-byte
  header, the PVQ index in fixed bits, the latents as zero, sign and
  geometric-continue decisions), not Opus's DRED bitstream: it carries the
  same symbols, pulses and levels;
- the initial state is the pulses over their norm in float64, then
  float32 (Opus computes it in float).
"""

from __future__ import annotations

import numpy as np
import torch

from .frozen.dred import entropy as E
from .frozen.models import rdovae as RV

Q15_HALF = E.Q15_ONE >> 1
_TOP = 1 << 32
_BOT = 1 << 24

stats_fixed_point = E.stats_fixed_point


def model_config(c: dict) -> RV.RDOVAEConfig:
    return RV.RDOVAEConfig(**{k: c[k] for k in RV.RDOVAEConfig.__dataclass_fields__})


class RangeDecoder:
    """The binary range decoder of Q15 decisions over exact integers;
    bytes past the payload read as zero."""

    def __init__(self, data: bytes):
        self.data = data
        self.low = 0
        self.range = _TOP - 1
        self.code = int.from_bytes(data[:4].ljust(4, b"\x00"), "big")
        self.pos = 4

    def bit(self, p0_q15: int) -> int:
        split = min(max((self.range * p0_q15) >> 15, 1), self.range - 1)
        if self.code < self.low + split:
            bit = 0
            self.range = split
        else:
            bit = 1
            self.low += split
            self.range -= split
        while self.range < _BOT:
            nxt = self.data[self.pos] if self.pos < len(self.data) else 0
            self.low <<= 8
            self.range <<= 8
            self.code = (self.code << 8) | nxt
            self.pos += 1
        return bit


def decode_latents(dec: RangeDecoder, p0: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Symbols [n] from p0, r [n] Q15: a zero flag at P(0) = p0, a sign at
    1/2, then continue flags at P(continue) = r up to the magnitude clamp."""
    out = np.zeros(p0.size, np.int64)
    for i, (p, rr) in enumerate(zip(p0.tolist(), r.tolist())):
        if dec.bit(min(max(p, 1), E.Q15_ONE - 1)) == 0:
            continue
        sign = -1 if dec.bit(Q15_HALF) else 1
        p_stop = E.Q15_ONE - min(max(rr, 1), E.Q15_ONE - 1)
        mag = 1
        while mag < RV.MAX_MAG and dec.bit(p_stop) == 1:
            mag += 1
        out[i] = sign * mag
    return out


def pvq_decode_index(idx: int, n: int, k: int) -> np.ndarray:
    """The pulse vector of enumerative index `idx`: per position the zero
    block first, then +1, -1, +2, -2, ..."""
    y = np.zeros(n, np.int64)
    for j in range(n):
        rem = n - j - 1
        block = RV.pvq_codebook_size(rem, k)
        if idx < block:
            continue
        idx -= block
        for m in range(1, k + 1):
            block = RV.pvq_codebook_size(rem, k - m)
            if idx < block:
                y[j] = m
                break
            idx -= block
            if idx < block:
                y[j] = -m
                break
            idx -= block
        k -= abs(int(y[j]))
    return y


def parse(payload: bytes, stats: dict, state_dim: int, k: int):
    """One payload -> (symbols [L, D] oldest latent first, pulses [S], the
    latents' levels [L]); a payload the framing cannot have made raises."""
    nsb = (E.pvq_index_bits(state_dim, k) + 7) // 8
    if len(payload) < 3 + nsb or payload[0] >> 4 != 1:
        raise ValueError("not a DRED payload of this framing")
    q0, q1 = payload[0] & 0xF, payload[1] >> 4
    n_lat = ((payload[1] & 0xF) << 8) | payload[2]
    idx = int.from_bytes(payload[3:3 + nsb], "big")
    if idx >= RV.pvq_codebook_size(state_dim, k):
        raise ValueError("a PVQ index past the codebook")
    q_ids = E.payload_q_ids(n_lat, q0, q1)
    p0, r = stats["p0_q15"][q_ids].reshape(-1), stats["r_q15"][q_ids].reshape(-1)
    zq = decode_latents(RangeDecoder(payload[3 + nsb:]), p0, r)
    return zq.reshape(n_lat, -1), pvq_decode_index(idx, state_dim, k), q_ids


def parse_all(payloads, stats: dict, cfg: RV.RDOVAEConfig, device):
    """Payloads (byte strings) -> (symbols [B, L, D], pulses [B, S], levels
    [B, L]) as int64 tensors on `device`."""
    parts = [parse(p, stats, cfg.state_dim, cfg.pvq_num_pulses) for p in payloads]
    return tuple(torch.as_tensor(np.stack(x).astype(np.int64), device=device)
                 for x in zip(*parts))


def _keep(x):
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_decoder(params) -> dict:
    """The decoder's weights rounded to bfloat16 (the control's operands);
    the statistical model as it is."""
    dec = {name: {k: bf16(v) for k, v in layer.items()}
           for name, layer in params["decoder"].items()}
    return dict(params, decoder=dec)


@torch.no_grad()
def decode(params, cfg: RV.RDOVAEConfig, zq: torch.Tensor, pulses: torch.Tensor,
           q_ids: torch.Tensor, rnd=_keep) -> torch.Tensor:
    """Symbols [B, L, D] (oldest latent first), pulses [B, S] and levels
    [B, L] -> features [B, L * 4, 20], newest latent first. `rnd` rounds
    every operand of the products (the control's)."""
    z = zq.to(torch.float32) / RV.statistical_model(params, q_ids, cfg)["quant_scale"]
    p = pulses.to(torch.float64)
    state = (p / (torch.sqrt((p * p).sum(-1, keepdim=True)) + 1e-15)).to(torch.float32)
    d = params["decoder"]
    h1, h2, h3 = (RV._dense(d[f"gru_{i}_init"], state, "tanh", rnd) for i in (1, 2, 3))
    frames = []
    for i in reversed(range(z.shape[1])):
        x1 = RV._dense(d["dense_1"], z[:, i], "tanh", rnd)
        h1 = RV._gru(d["gru_1"], h1, x1, rnd)
        x3 = RV._dense(d["dense_2"], h1, "tanh", rnd)
        h2 = RV._gru(d["gru_2"], h2, x3, rnd)
        x5 = RV._dense(d["dense_3"], h2, "tanh", rnd)
        h3 = RV._gru(d["gru_3"], h3, x5, rnd)
        x7 = RV._dense(d["dense_4"], h3, "tanh", rnd)
        x8 = RV._dense(d["dense_5"], x7, "tanh", rnd)
        x9 = torch.cat([x1, h1, x3, h2, x5, h3, x7, x8], dim=-1)
        out = RV._dense(d["output"], x9, "linear", rnd)
        frames.append(out.reshape(out.shape[0], cfg.dec_frames_per_step,
                                  cfg.num_features))
    return torch.cat(frames, dim=1)
