"""Training data pipeline: memmap'd features and PCM, chunked and shuffled.

Counterpart of `lpcnet_tpu/train/data.py` (training_tf2/dataloader.py and
the slicing of train_lpcnet.py:161-182). The feature file holds rows of 36
float32 (20 used + 16 LPC); the data file holds interleaved
(sig_in, sig_out) int16 pairs as the dump_data augmentation pipeline writes
them. A chunk is 15 frames with 4 context frames of features.

`LPCNetLoader` serves numpy batches from the host. `DeviceLPCNetLoader`
holds the whole corpus on the device and gathers each batch there, so a
step ships only the chunk indices; `Trainer.train_block` takes its
`index_blocks` and gathers through `sample_fn`.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterator

import numpy as np
import torch

from ..dsp.constants import LPC_ORDER, NB_TOTAL_FEATURES
from ..utils.device import resolve_device

FRAME = 160


def lpc2rc(lpc):
    """LPC -> reflection coefficients by the step-down recursion
    (training_tf2/dataloader.py:5-13), on a numpy array or a tensor."""
    if isinstance(lpc, torch.Tensor):
        order = lpc.shape[-1]
        rc = []
        for _ in range(order):
            ki = lpc[..., -1:]
            rc.append(ki)
            lpc = (lpc[..., :-1] - ki * lpc[..., :-1].flip(-1)) / (1 - ki * ki)
        return torch.cat(rc[::-1], dim=-1)
    lpc = np.array(lpc, np.float32, copy=True)
    order = lpc.shape[-1]
    rc = np.zeros_like(lpc)
    for i in range(order, 0, -1):
        rc[..., i - 1] = lpc[..., -1]
        ki = rc[..., i - 1: i]
        lpc = (lpc[..., :-1] - ki * lpc[..., -2::-1]) / (1 - ki * ki)
    return rc


class _ChunkIndex:
    """The shuffled chunk order and the held-out tail shared by both
    loaders: the last `holdout_batches * batch_size` chunks never enter the
    shuffled training indices and are served in order by `val_batches`."""

    def _init_index(self, nb_chunks: int, batch_size: int, seed: int,
                    holdout_batches: int):
        self.nb_batches = nb_chunks // batch_size
        self.holdout_batches = min(holdout_batches,
                                   max(self.nb_batches - 1, 0))
        self.nb_batches -= self.holdout_batches
        self._n_train_chunks = self.nb_batches * batch_size
        self._rng = np.random.RandomState(seed)
        self.on_epoch_end()

    def on_epoch_end(self):
        self.indices = np.arange(self._n_train_chunks)
        self._rng.shuffle(self.indices)

    def val_batches(self):
        """Fixed held-out batches (empty unless holdout_batches > 0)."""
        save = self.indices
        try:
            n = self.holdout_batches * self.batch_size
            self.indices = np.arange(self._n_train_chunks,
                                     self._n_train_chunks + n)
            for i in range(self.holdout_batches):
                yield self[i]
        finally:
            self.indices = save

    def __len__(self):
        return self.nb_batches

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self[i]


def _open_pcm(pcm_path, batch_size, chunk_frames, lookahead):
    pcm_chunk = FRAME * chunk_frames
    data = np.memmap(pcm_path, dtype="int16", mode="r")
    nb_chunks = (len(data) // (2 * pcm_chunk) - 1) // batch_size * batch_size
    data = data[(4 - lookahead) * 2 * FRAME:]
    data = data[: nb_chunks * 2 * pcm_chunk]
    return np.reshape(data, (nb_chunks, pcm_chunk, 2)), nb_chunks


class LPCNetLoader(_ChunkIndex):
    """Shuffled chunk loader over memmap'd training files; numpy batches
    {sig_in, sig_out [B, T] f32, features [B, F+4, 20] f32, periods
    [B, F+4] int32, lpc [B, F, 16] f32 (or rc with e2e)}."""

    def __init__(self, pcm_path: str, feature_path: str, batch_size: int = 128,
                 chunk_frames: int = 15, lookahead: int = 2, e2e: bool = False,
                 seed: int = 0, holdout_batches: int = 0):
        self.batch_size = batch_size
        self.lookahead = lookahead
        self.e2e = e2e
        self.chunk_frames = chunk_frames
        self.data, nb_chunks = _open_pcm(pcm_path, batch_size, chunk_frames,
                                         lookahead)
        features = np.memmap(feature_path, dtype="float32", mode="r")
        sizeof = features.strides[-1]
        nf = NB_TOTAL_FEATURES
        # overlapping windows: chunk i is frames [15 i, 15 i + 19)
        self.features = np.lib.stride_tricks.as_strided(
            features, shape=(nb_chunks, chunk_frames + 4, nf),
            strides=(chunk_frames * nf * sizeof, nf * sizeof, sizeof))
        self.periods = (0.1 + 50.0 * self.features[:, :, 18:19] + 100
                        ).astype("int16")
        self._init_index(nb_chunks, batch_size, seed, holdout_batches)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        sel = self.indices[index * self.batch_size:
                           (index + 1) * self.batch_size]
        data = self.data[sel]
        feats = self.features[sel]
        out = {
            "sig_in": data[:, :, 0].astype(np.float32),
            "sig_out": data[:, :, 1].astype(np.float32),
            "features": np.ascontiguousarray(feats[:, :, :20]
                                             ).astype(np.float32),
            "periods": np.clip(self.periods[sel][:, :, 0], 0, 255
                               ).astype(np.int32),
        }
        la = self.lookahead
        lpc = feats[:, 4 - la: -la if la else None, 20:20 + LPC_ORDER]
        lpc = np.ascontiguousarray(lpc).astype(np.float32)
        if self.e2e:
            out["rc"] = lpc2rc(lpc)
        else:
            out["lpc"] = lpc
        return out


def _sample(sig_in, sig_out, feats, sel, chunk_frames: int, lookahead: int,
            e2e: bool) -> Dict[str, torch.Tensor]:
    """The batch of the chunks `sel` [B] (int64, on the device) gathered
    from the device-resident corpus arrays."""
    nf, cf, la = NB_TOTAL_FEATURES, chunk_frames, lookahead
    nxt = torch.clamp(sel + 1, max=feats.shape[0] - 1)
    f = torch.cat([feats[sel], feats[nxt][:, :4 * nf]], dim=1
                  ).reshape(sel.shape[0], cf + 4, nf)
    periods = torch.clamp(
        (0.1 + 50.0 * f[:, :, 18] + 100).to(torch.int32), 0, 255)
    lw = f[:, 4 - la: cf + 4 - la, 20:20 + LPC_ORDER]
    out = {
        "sig_in": sig_in[sel].to(torch.float32),
        "sig_out": sig_out[sel].to(torch.float32),
        "features": f[:, :, :20],
        "periods": periods,
    }
    if e2e:
        out["rc"] = lpc2rc(lw)
    else:
        out["lpc"] = lw
    return out


class DeviceLPCNetLoader(_ChunkIndex):
    """Device-resident variant of LPCNetLoader: the whole corpus (int16 PCM
    and float32 features) is uploaded once, and each batch is gathered,
    widened and sliced on the device from the [B] chunk indices. Same batch
    contract as LPCNetLoader, with tensors on `device` as values."""

    def __init__(self, pcm_path: str, feature_path: str, batch_size: int = 128,
                 chunk_frames: int = 15, lookahead: int = 2, e2e: bool = False,
                 seed: int = 0, holdout_batches: int = 0, device=None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.lookahead = lookahead
        self.e2e = e2e
        self.chunk_frames = chunk_frames
        data, nb_chunks = _open_pcm(pcm_path, batch_size, chunk_frames,
                                    lookahead)
        put = lambda a: torch.from_numpy(np.array(a)).to(self.device)
        self._sig_in = put(data[:, :, 0])
        self._sig_out = put(data[:, :, 1])
        feats = np.memmap(feature_path, dtype="float32", mode="r")
        nf = NB_TOTAL_FEATURES
        n_rows = min(len(feats) // (chunk_frames * nf), nb_chunks + 1)
        # one flat row of 15 frames per chunk; a window (15 + 4 frames) is
        # row i plus the first 4 frames of row i + 1
        self._features = put(np.reshape(
            feats[: n_rows * chunk_frames * nf], (n_rows, chunk_frames * nf)))
        self._init_index(nb_chunks, batch_size, seed, holdout_batches)
        # the gather as a function of the corpus arrays, for a caller's
        # loop of steps (Trainer.train_block)
        self.sample_fn = functools.partial(
            _sample, chunk_frames=chunk_frames, lookahead=lookahead, e2e=e2e)

    @property
    def device_arrays(self):
        """(sig_in, sig_out, features): the device-resident corpus."""
        return self._sig_in, self._sig_out, self._features

    def sample(self, sel: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch of the chunks `sel` [B] (int64, on the device)."""
        return self.sample_fn(*self.device_arrays, sel)

    def index_blocks(self, block_steps: int):
        """Yield [block_steps, B] int32 index blocks covering one epoch
        (the last partial block is dropped)."""
        bs = self.batch_size
        n = (self.nb_batches // block_steps) * block_steps
        for i in range(0, n, block_steps):
            sel = self.indices[i * bs:(i + block_steps) * bs]
            yield np.reshape(sel, (block_steps, bs)).astype(np.int32)

    def __getitem__(self, index) -> Dict[str, torch.Tensor]:
        sel = self.indices[index * self.batch_size:
                           (index + 1) * self.batch_size]
        return self.sample(torch.from_numpy(np.asarray(sel, np.int64)
                                            ).to(self.device))
