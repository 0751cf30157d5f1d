"""DRED encoder and decoder drivers.

The C driver's surface (include/dred_rdovae.h, src/dred_rdovae.c:38-52)
and the FEC packetizer (torch/rdovae/fec_encoder.py:136-167), as the JAX
package's `dred/coder.py` has them: the encoder takes feature frames 2 at a
time and keeps the newest latents and decoder-init states; a redundancy
payload quantizes older latents coarser (q from q0 for the newest to q1 for
the oldest); the decoder gives 4 feature frames a latent, newest first.

The stream state, the latents and the init states stay on the device: a
dframe makes no host sync. `DREDEncoder.latents` / `.init_states` copy the
window to the host as the JAX surface gives it (lists of [B, ...] arrays).
A payload of every stream is made with no Python loop over the streams:
the symbols and the PVQ search on the device; on CUDA one kernel frames
every payload on the card (`kernels.dred_payload`), and two copies bring
the symbols and the payloads' bytes over; on the CPU one readback and one
native call that frames every payload (`entropy.encode_payloads`). A
batch of payloads is decoded the other way round: on CUDA one copy takes
the payloads' bytes to the card and one kernel parses every payload there
(`kernels.dred_parse`), on the CPU one native call parses them
(`entropy.decode_payloads`), and the decoder steps on the device over
every stream at once. The encoder and the decoder run on CUDA unless the
caller passes `device="cpu"`.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np
import torch

from ..kernels import dred_parse as DX
from ..kernels import dred_payload as DP
from ..models import rdovae as RV
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..weights.convert import tree_to
from . import entropy as EC


def _host(window) -> List[np.ndarray]:
    return [x.cpu().numpy() for x in window]


class DREDEncoder:
    """Streaming DRED encoder (cf. RDOVAEEncState, src/dred_rdovae_enc.h:35-40)
    over `batch` streams. `stats` counts the payloads made (`payloads`,
    one a stream), the latents coded, the payload bytes, and how they were
    framed: on the card (`device_framings`, one a call, and
    `device_retries`, the kernel's relaunches at a larger slot), by the
    native call (`native_calls`) or a stream at a time in Python
    (`python_payloads`: the CPU path without the native library)."""

    def __init__(self, params, cfg: Optional[RV.RDOVAEConfig] = None,
                 batch: int = 1, max_latents: int = 100, device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg or RV.RDOVAEConfig()
        self.batch = batch
        self.max_latents = max_latents
        self.fixed_stats = EC.stats_fixed_point(self.params, self.cfg)
        self.stats = collections.Counter()
        self._q_ids = {}
        self._framing = None    # the card's `DP.Framing` at the last shape framed
        self.reset()

    def reset(self):
        self.state = RV.init_encoder_stream(self.batch, self.cfg, self.device)
        # the newest max_latents latents [B, latent] and init states
        # [B, state_dim], oldest first, on the device
        self.z_window: List[torch.Tensor] = []
        self.state_window: List[torch.Tensor] = []
        self._frame_buf: Optional[torch.Tensor] = None

    @property
    def latents(self) -> List[np.ndarray]:
        return _host(self.z_window)

    @property
    def init_states(self) -> List[np.ndarray]:
        return _host(self.state_window)

    @torch.no_grad()
    def add_feature_frame(self, features):
        """features [B, >=20] (array or tensor); every second call encodes a
        dframe."""
        f = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device)[..., :self.cfg.num_features]
        if self._frame_buf is None:
            self._frame_buf = f
            return
        pair = torch.cat([self._frame_buf, f], dim=-1)
        self._frame_buf = None
        with span("lpcnet.dred.encode", device=self.device):
            self.state, z, st = RV.encode_dframe(self.params, self.state,
                                                 pair, self.cfg)
        self.z_window.append(z)
        self.state_window.append(st)
        if len(self.z_window) > self.max_latents:
            self.z_window.pop(0)
            self.state_window.pop(0)

    @torch.no_grad()
    def produce_payload(self, num_redundancy_frames: int = 52,
                        q0: int = 9, q1: int = 15):
        """One redundancy payload a stream from the newest latents.

        Returns a dict: zq [B, L, latent] int16 symbols (newest last;
        decoding reverses them), q_ids [L], pulses [B, state_dim] int16
        (the PVQ search's), state [B, state_dim] (the PVQ-quantized
        unit-norm decoder init), bits [B] estimated payload size, and
        payloads: B entropy-coded byte strings (`entropy.encode_payload`'s
        framing, an `entropy.Payloads`). None while fewer than
        num_redundancy_frames / 2 latents were encoded.
        """
        n_lat = num_redundancy_frames // 2
        if len(self.z_window) < n_lat:
            return None
        k = self.cfg.pvq_num_pulses
        # oldest latent (index 0) -> coarsest level q1, newest -> q0
        # (torch/rdovae/fec_encoder.py:125-127)
        q_ids = EC.payload_q_ids(n_lat, q0, q1)
        with span("lpcnet.dred.quantize", device=self.device):
            key = (n_lat, q0, q1)
            if key not in self._q_ids:
                self._q_ids[key] = torch.as_tensor(q_ids, device=self.device)
            z = torch.stack(self.z_window[-n_lat:], dim=1)        # [B, L, latent]
            zq, rates = quantize_latents(self.params, z, self._q_ids[key],
                                         self.cfg)
            bits = 8 * torch.ceil((rates.sum(-1) + 7 + RV.pvq_state_bits(self.cfg))
                                  / 8)
        with span("lpcnet.dred.pvq"):
            pulses = EC.pvq_search_batch(self.state_window[-1], k)
        frame = self._frame_on_card if self.device.type == "cuda" else self._frame_on_host
        host, bits, payloads = frame(zq, pulses, bits, q0, q1)
        zq = host[:, :-self.cfg.state_dim].reshape(z.shape)
        pulses = host[:, -self.cfg.state_dim:]
        p = pulses.astype(np.float64)
        state = (p / (np.sqrt((p * p).sum(-1, keepdims=True)) + 1e-15)
                 ).astype(np.float32)          # pvq_normalize, row by row
        self.stats.update(payloads=len(payloads), latents=n_lat * len(payloads),
                          bytes=len(payloads.data))
        return {"zq": zq, "q_ids": q_ids, "state": state, "bits": bits,
                "payloads": payloads, "pulses": pulses}

    def _frame_on_host(self, zq: torch.Tensor, pulses: torch.Tensor,
                       bits: torch.Tensor, q0: int, q1: int):
        """`produce_payload`'s framing off the card: one readback, then one
        native call (`entropy.encode_payloads`; without the native library
        the Python coder a stream). Returns as `_frame_on_card`."""
        with span("lpcnet.dred.readback"):
            # |symbol| <= MAX_MAG and |pulse| <= k: int16 holds both, and
            # one copy brings them over
            host = torch.cat([zq.reshape(zq.shape[0], -1), pulses.to(zq.dtype)],
                             dim=1).to(torch.int16).cpu().numpy()
            bits = bits.cpu().numpy()
        s = self.cfg.state_dim
        with span("lpcnet.dred.entropy"):
            payloads = EC.encode_payloads(host[:, :-s].reshape(zq.shape), host[:, -s:],
                                          q0, q1, self.fixed_stats,
                                          self.cfg.pvq_num_pulses, self.stats)
        return host, bits, payloads

    def _frame_on_card(self, zq: torch.Tensor, pulses: torch.Tensor,
                       bits: torch.Tensor, q0: int, q1: int):
        """`produce_payload`'s framing on the card (`kernels.dred_payload`):
        the symbols, pulses and bit estimates staged in one buffer, every
        payload framed and packed there, then one copy of the stage and one
        of the payloads' bytes. Returns (the stage's symbols and pulses
        [B, L * latent + state_dim] int16, bits [B], payloads)."""
        b, n_lat, dim = zq.shape
        f = self._framing
        if f is None or (f.batch, f.n_lat) != (b, n_lat):
            f = self._framing = DP.Framing(self.fixed_stats, b, n_lat, dim,
                                           self.cfg.state_dim, self.cfg.pvq_num_pulses,
                                           self.device)
        with span("lpcnet.dred.entropy"):
            f.stage(zq, pulses, bits)
            f.launch(q0, q1, EC.payload_q_ids(n_lat, q0, q1))
        with span("lpcnet.dred.readback"):
            host, lengths, bits = f.fetch()
        with span("lpcnet.dred.entropy"):
            payloads = EC.Payloads(*f.payloads(lengths))
        self.stats.update(device_framings=1, device_retries=f.retries)
        return host, bits, payloads


@torch.no_grad()
def quantize_latents(params, z: torch.Tensor, q_ids: torch.Tensor,
                     cfg: RV.RDOVAEConfig):
    """z [B, L, latent], q_ids [L] -> (round-quantized symbols, rates [B, L])
    (RDOVAE.quantize, torch rdovae.py:584-595)."""
    stats = RV.statistical_model(params, q_ids, cfg)
    zq = RV.soft_dead_zone(z * stats["quant_scale"], stats["dead_zone"])
    zq = torch.clamp(torch.round(zq), -EC.MAX_MAG, EC.MAX_MAG)
    rates = RV.hard_rate_estimate(zq, stats["r_hard"], stats["theta_hard"],
                                  reduce=False)
    return zq, rates


@torch.no_grad()
def unquantize_latents(params, zq: torch.Tensor, q_ids: torch.Tensor,
                       cfg: RV.RDOVAEConfig):
    return zq / RV.statistical_model(params, q_ids, cfg)["quant_scale"]


class DREDDecoder:
    """Redundancy decoder (DRED_rdovae_decode_all, src/dred_rdovae.c:38-52).

    `decode_payloads` decodes a batch of payloads with no Python loop over
    the streams. On CUDA one copy takes the payloads' bytes to the card
    and one kernel parses every payload there (`kernels.dred_parse`); on
    the CPU one native call parses them all (`entropy.decode_payloads`;
    without the library, the Python parse a payload at a time). Both give
    every stream's symbols, pulses and levels (`parsed`, until the next
    batch overwrites them), and the decoder runs on the device over every
    stream at once. `stats` counts the payloads parsed (`payloads_parsed`),
    the latents decoded (`latents_decoded`) and the parses:
    `device_parses` (one a batch on CUDA), `native_parses` (one a batch)
    or `python_parses` (one a payload)."""

    def __init__(self, params, cfg: Optional[RV.RDOVAEConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg or RV.RDOVAEConfig()
        self.fixed_stats = EC.stats_fixed_point(self.params, self.cfg)
        self.stats = collections.Counter()
        self._rows: Optional[torch.Tensor] = None   # the last batch's parse
        self._n_lat = 0
        self._parsing = None    # the card's `DX.Parsing` at the last shape parsed

    @torch.no_grad()
    def decode_latents(self, z_rev: torch.Tensor, state: torch.Tensor
                       ) -> torch.Tensor:
        """Unquantized latents in decode order (newest first) [B, L, latent]
        and init states [B, state_dim] -> features [B, L * 4, 20] on the
        device: `decode_qframe` over the latents."""
        dec = RV.init_decoder_stream(self.params, state, self.cfg)
        frames = []
        for i in range(z_rev.shape[1]):
            dec, f = RV.decode_qframe(self.params, dec, z_rev[:, i], self.cfg)
            frames.append(f)
        return torch.cat(frames, dim=1)

    def decode_all(self, zq, q_ids, state) -> np.ndarray:
        """zq [B, L, latent] quantized symbols newest last; q_ids [L];
        state [B, state_dim]. Returns features [B, L * 4, 20] in decode order
        (newest latent first, 4 frames a latent)."""
        dev = self.device
        z = unquantize_latents(self.params,
                               torch.as_tensor(zq, dtype=torch.float32, device=dev),
                               torch.as_tensor(q_ids, device=dev), self.cfg)
        state = torch.as_tensor(state, dtype=torch.float32, device=dev)
        return self.decode_latents(torch.flip(z, dims=(1,)), state).cpu().numpy()

    @property
    def parsed(self):
        """The last batch's parse on the device: (symbols [B, L, latent]
        oldest latent first, pulses [B, state_dim], the latents' levels
        [B, L]), int16; None before the first batch."""
        if self._rows is None:
            return None
        return EC.split_rows(self._rows, self._n_lat, self.cfg.latent_dim,
                             self.cfg.state_dim)

    @torch.no_grad()
    def decode_payloads(self, payloads) -> torch.Tensor:
        """B entropy-coded payloads (an `entropy.Payloads`, or byte strings),
        each of the first's latent count L -> features [B, L * 4, 20] on the
        device, newest latent first (`decode_all`'s order)."""
        if not isinstance(payloads, EC.Payloads):
            payloads = EC.Payloads.of(payloads)
        cfg = self.cfg
        with span("lpcnet.dred.parse"):
            n_lat = EC.batch_latent_count(payloads)
            if self.device.type == "cuda":
                self._rows = self._parse_on_card(payloads, n_lat)
            else:
                self._rows = torch.from_numpy(EC.decode_payloads(
                    payloads, self.fixed_stats, cfg.state_dim, cfg.pvq_num_pulses,
                    self.stats))
        self._n_lat = n_lat
        self.stats.update(payloads_parsed=len(payloads),
                          latents_decoded=n_lat * len(payloads))
        with span("lpcnet.dred.decode", device=self.device):
            return self.decode_rows(self._rows)

    def _parse_on_card(self, payloads: EC.Payloads, n_lat: int) -> torch.Tensor:
        """Every payload parsed on the card (`kernels.dred_parse`): the
        bytes staged and checked on the host, one copy, one launch; the
        rows stay on the card."""
        cfg = self.cfg
        p = self._parsing
        if p is None or (p.batch, p.n_lat) != (len(payloads), n_lat):
            p = self._parsing = DX.Parsing(self.fixed_stats, len(payloads), n_lat,
                                           cfg.latent_dim, cfg.state_dim,
                                           cfg.pvq_num_pulses, self.device)
        rows = p(payloads)
        self.stats["device_parses"] += 1
        return rows

    @torch.no_grad()
    def decode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """A parse's rows on the device (`entropy.decode_payloads`' layout,
        int16 [B, L * latent + state_dim + L]) -> features [B, L * 4, 20]
        there, newest latent first: the symbols unquantised at their
        levels, the decoder's initial state the pulses' unit vector in
        float64, as `entropy.pvq_normalize`."""
        cfg = self.cfg
        n_lat = (rows.shape[1] - cfg.state_dim) // (cfg.latent_dim + 1)
        zq, pulses, q_ids = EC.split_rows(rows, n_lat, cfg.latent_dim, cfg.state_dim)
        z = unquantize_latents(self.params, zq.float(), q_ids.long(), cfg)
        p = pulses.double()
        state = (p / (torch.sqrt((p * p).sum(-1, keepdim=True)) + 1e-15)).float()
        return self.decode_latents(torch.flip(z, dims=(1,)), state)

    def decode_payload(self, payload: bytes) -> np.ndarray:
        """An entropy-coded payload (`entropy.encode_payload`'s framing) ->
        features [1, L * 4, 20], newest latent first: `decode_payloads` of
        a batch of one."""
        return self.decode_payloads([payload]).cpu().numpy()
