"""The one traffic generator: every mix under `traffic/` is a file of
parameters that this module reads. All draws come from the run's `--seed`
through `sub_seed`, so the same seed gives the same inputs.

- `packets`: 8-byte codec packets, each field of the packet layout drawn
  uniformly over its whole range (`reference/frozen/codec/packet.py`).
- `speech`: a speech-like 16 kHz signal per stream, made on the device: a
  harmonic source with a wandering pitch under a syllable-rate envelope,
  plus noise, integer valued. Frozen copy of the source in
  `chip_smoke.py::plc_traffic` at commit d7e6271, in torch.
- `GilbertLoss`: a two-state Gilbert loss model per stream over 20 ms
  packets (each packet's flag held for its ticks). Its mean loss and mean
  burst length come from the mix; the loss pattern's shape (10 % of the
  packets, the first packets received) follows `chip_smoke.py:1597-1612`.
- `train_batches`: the arrays `Trainer.train_step` takes, each field in its
  range, from `speech` and per-field uniform draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.frozen.codec.packet import FIELDS, pack_fields
from .reference.frozen.dsp.lpc import lpc_from_cepstrum

FS = 16000


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed, from any whole number."""
    ss = np.random.SeedSequence([seed & (2 ** 64 - 1), *path])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def packets(n_ticks: int, streams: int, seed: int) -> np.ndarray:
    """[n_ticks, streams, 8] uint8 packets, every field uniform over its
    bit range (all of which the decoder accepts)."""
    rs = np.random.Generator(np.random.PCG64(seed))
    shape = (n_ticks, streams)
    fields = {name: rs.integers(0, 1 << bits, shape) for name, bits in FIELDS}
    return pack_fields(fields)


def speech(streams: int, n: int, spec: dict, gen: torch.Generator,
           device) -> torch.Tensor:
    """[streams, n] float32 integer-valued speech-like signal on `device`."""
    f64 = torch.float64

    def u(lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand((streams, 1), generator=gen,
                                           device=device, dtype=f64)

    t = torch.arange(n, device=device, dtype=f64)[None] / FS
    f0 = u(spec["f0_hz"]) * (1 + spec["vibrato"] * torch.sin(
        2 * math.pi * u(spec["vibrato_hz"]) * t + u([0, 6])))
    phase = 2 * math.pi * torch.cumsum(f0.expand(streams, n), dim=1) / FS
    sig = sum(torch.sin(k * phase) / k for k in range(1, spec["harmonics"] + 1))
    env = 0.55 + 0.45 * torch.sin(2 * math.pi * u(spec["envelope_hz"]) * t
                                  + u([0, 6]))
    noise = torch.randn((streams, n), generator=gen, device=device, dtype=f64)
    pcm = torch.round(spec["amplitude"] * env * sig + spec["noise"] * noise)
    return pcm.to(torch.float32)


class GilbertLoss:
    """Per-stream two-state loss over packets of `packet_ticks` ticks: a
    received packet is followed by a lost one with probability p, a lost
    one by a received one with probability r = 1 / mean burst, so the
    stationary loss is p / (p + r). `lost(tick)` is a [streams] bool array;
    the chain is drawn ahead in blocks, the same for a seed whatever the
    run's speed. A mean loss of 0 loses nothing."""

    BLOCK = 4096

    def __init__(self, streams: int, spec: dict, seed: int):
        self.streams = streams
        self.packet_ticks = spec["packet_ticks"]
        self.first = spec["first_packets_received"]
        loss = spec["mean_loss"]
        self.r = 1.0 / spec["mean_burst_packets"]
        self.p = loss * self.r / (1.0 - loss)
        self.rs = np.random.Generator(np.random.PCG64(seed))
        self.state = self.rs.random(streams) < loss
        self.packets = np.zeros((0, streams), bool)

    def _extend(self):
        u = self.rs.random((self.BLOCK, self.streams))
        out = np.empty((self.BLOCK, self.streams), bool)
        st = self.state
        for k in range(self.BLOCK):
            st = np.where(st, u[k] >= self.r, u[k] < self.p)
            out[k] = st
        self.state = st
        start = len(self.packets)
        out[:max(0, self.first - start)] = False
        self.packets = np.concatenate([self.packets, out])

    def lost(self, tick: int) -> np.ndarray:
        k = tick // self.packet_ticks
        while k >= len(self.packets):
            self._extend()
        return self.packets[k]


def train_batches(spec: dict, cfg: dict, seed: int, device) -> list:
    """`spec["batches"]` batches of `Trainer.train_step`'s arrays on the
    device: sig_in/sig_out [B, T] (a speech-like signal, sig_in the target
    delayed by one sample), features [B, F+4, 20] (cepstrum and pitch
    correlation uniform in their ranges, the pitch feature uniform in its
    range), periods [B, F+4] (the pitch feature's period index), lpc
    [B, F, 16] (from the cepstrum, as the encoder derives it)."""
    gen = device_generator(seed, device)
    b, nf = spec["batch"], spec["chunk_frames"]
    t = nf * cfg["frame_size"]
    r = spec["ranges"]
    out = []
    for _ in range(spec["batches"]):
        sig = speech(b, t + 1, spec["speech"], gen, device)
        u = lambda shape, lo_hi: lo_hi[0] + (lo_hi[1] - lo_hi[0]) * torch.rand(
            shape, generator=gen, device=device)
        cep = u((b, nf + 4, 18), r["cepstrum"])
        cep[..., 0] = u((b, nf + 4), r["c0"])
        pitch = u((b, nf + 4), r["pitch"])
        corr = u((b, nf + 4), r["corr"])
        feats = torch.cat([cep, pitch[..., None], corr[..., None]], dim=-1)
        periods = torch.clamp(torch.floor(0.1 + 50.0 * pitch + 100.0),
                              32, 255).to(torch.int64)
        lpc = lpc_from_cepstrum(cep[:, 2:2 + nf])
        out.append({"sig_in": sig[:, :-1].contiguous(),
                    "sig_out": sig[:, 1:].contiguous(),
                    "features": feats, "periods": periods, "lpc": lpc})
    return out
