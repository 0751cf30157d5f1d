"""PLC model training: loss-trace simulation, masked losses, the trainer.

Counterpart of `lpcnet_tpu/train/train_plc.py`, after
training_tf2/train_plc.py and plc_loader.py: sequences of
[burg(36) | features(20)] rows, packet-loss traces applied as input masks
with 10 % random Burg dropout, and a composite masked loss (L1 + band-domain
IDCT L1 + clipped pitch terms + one-sided correlation penalty) that scores
only the frames the model had to predict (mask = lost frames).

The trainer runs on one CUDA card unless the caller passes `device="cpu"`;
without CUDA and without that request it raises. The two GRUs run as the
plain per-step recurrence of `models.plc.predict_sequence`, as in the JAX
package; no kernel. A step does not synchronise with the host: its metrics
come back as device scalars, to be fetched at log intervals.

`PLCTrainer.train_block` runs K steps whose batches `PLCDeviceLoader.
sample_fn` assembles on the device from a [K, B] block of sequence indices,
each step's generator seeded from (base seed, step). With a `mesh` the
trainer is data-parallel as `train_lpcnet.Trainer` is.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from ..dsp.spectrum import idct
from ..models import plc as PM
from ..parallel.mesh import replicated
from ..utils.device import resolve_device
from ..utils.rng import draw, fold_seed
from .sparsify import weight_clip_constraint
from .train_lpcnet import (_assign, _block_sels, _carry, _leaves, _map,
                           _mean_over_ranks, _place_batch, _shared_rng,
                           _stack_metrics, _to_device)

NB_BURG = 36
NB_USED = 20


@dataclasses.dataclass(frozen=True)
class PLCTrainConfig:
    batch_size: int = 128
    seq_length: int = 1000
    lr: float = 1e-3
    decay: float = 2.5e-5
    epochs: int = 120
    band_loss: float = 1.0
    loss_bias: float = 0.0
    quantize: bool = False


def plc_loss(y_true, mask, y_pred, alpha: float = 1.0, bias: float = 0.0):
    """Composite masked loss (train_plc.py:100-109).

    Args: y_true [B, T, 20], mask [B, T, 1] (1 = the frame was lost), y_pred.
    """
    e = (y_pred - y_true) * mask
    e_bands = idct(e[..., :18])
    bias_mask = torch.clamp(4.0 * y_true[..., 19:20], 0.0, 1.0)
    l1 = torch.mean(torch.abs(e))
    corr_one_sided = 0.1 * torch.mean(torch.relu(-e[..., 19:20]))
    band = alpha * torch.mean(torch.abs(e_bands)
                              + bias * bias_mask * torch.relu(e_bands))
    pitch1 = torch.mean(torch.clamp(torch.abs(e[..., 18:19]), max=1.0))
    pitch2 = 8.0 * torch.mean(torch.clamp(torch.abs(e[..., 18:19]), max=0.4))
    return l1 + corr_one_sided + band + pitch1 + pitch2


def plc_metrics(y_true, mask, y_pred):
    e = (y_pred - y_true) * mask
    return {
        "l1": torch.mean(torch.abs(e)),
        "ceps": torch.mean(torch.abs(e[..., :18])),
        "band": torch.mean(torch.abs(idct(e[..., :18]))),
        "pitch": torch.mean(torch.clamp(torch.abs(e[..., 18:19]), max=0.4)),
    }


def _read_sequences(feature_path: str, tc: PLCTrainConfig, val_seqs: int):
    """(training sequences [n_train, T, 56], held-out [val_seqs, T, 56] or
    None) of a [burg 36 | features 20 | lpc 16] row file; the last
    `val_seqs` sequences are held out of training entirely."""
    nb_features = NB_BURG + NB_USED + 16
    feats = np.fromfile(feature_path, dtype=np.float32)
    nseq = len(feats) // (nb_features * tc.seq_length)
    nseq_train = (nseq - val_seqs) // tc.batch_size * tc.batch_size
    feats = feats[: nseq * tc.seq_length * nb_features]
    all_feats = feats.reshape(nseq, tc.seq_length, nb_features)[
        :, :, : NB_BURG + NB_USED]
    val = all_feats[nseq - val_seqs:] if val_seqs else None
    return all_feats[:nseq_train], val


def _val_batch(feats, lost):
    """The held-out batch with fixed loss traces and Burg dropout (a fixed
    numpy seed: the same masks at every call). `lost` is the trace stream
    truncated as PLCLoader truncates it."""
    rng = np.random.RandomState(12345)
    b, t, _ = feats.shape
    burg_ok = (rng.rand(b, t, 1) > 0.1).astype(np.float32)
    lo = lost[: (len(lost) // t) * t].reshape(-1, t)
    lost = lo[rng.randint(0, lo.shape[0], b)][:, :, None]
    in_feats = feats * lost
    in_feats = in_feats.copy()
    in_feats[:, :, :NB_BURG] *= burg_ok
    flag = lost * (2 * burg_ok - 1)
    return {
        "plc_input": np.concatenate([in_feats, flag], axis=-1
                                    ).astype(np.float32),
        "target": feats[:, :, NB_BURG:].astype(np.float32),
        "mask": (1.0 - lost).astype(np.float32),
    }


class PLCLoader:
    """Loss-trace fault-injection loader (plc_loader.py:31-73), numpy on the
    host, making the JAX package's numpy draws in the same order.

    features file rows: [burg(36) | used(20) | lpc(16)] per frame (written
    by dump_data(..., burg=True)); lost file: int8 0/1 per frame (0 = lost).
    """

    def __init__(self, feature_path: str, lost_path: str, tc: PLCTrainConfig,
                 seed: int = 0, val_seqs: int = 0):
        self.features, self._val_features = _read_sequences(
            feature_path, tc, val_seqs)
        self.lost = np.fromfile(lost_path, dtype=np.int8).astype(np.float32)
        self.lost = self.lost[: (len(self.lost) // tc.seq_length - 1)
                              * tc.seq_length]
        self.tc = tc
        self._rng = np.random.RandomState(seed)
        self.nb_batches = self.features.shape[0] // tc.batch_size
        self.on_epoch_end()

    def on_epoch_end(self):
        t = self.features.shape[1]
        self.indices = self._rng.permutation(self.features.shape[0])
        offset = self._rng.randint(0, t)
        self.lost_offset = self.lost[offset: len(self.lost) - t + offset
                                     ].reshape(-1, t)
        self.lost_indices = self._rng.randint(0, self.lost_offset.shape[0],
                                              self.features.shape[0])

    def val_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """The held-out batch with fixed loss traces and Burg dropout, the
        same at every call, so the val loss curve is step-comparable."""
        if self._val_features is None:
            return None
        return _val_batch(self._val_features, self.lost)

    def __len__(self):
        return self.nb_batches

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        bs = self.tc.batch_size
        sel = self.indices[index * bs:(index + 1) * bs]
        feats = self.features[sel]
        b, t, _ = feats.shape
        burg_ok = (self._rng.rand(b, t, 1) > 0.1).astype(np.float32)
        lost = self.lost_offset[self.lost_indices[sel]][:, :, None]
        in_feats = feats * lost
        in_feats[:, :, :NB_BURG] *= burg_ok
        flag = lost * (2 * burg_ok - 1)
        return {
            "plc_input": np.concatenate([in_feats, flag], axis=-1
                                        ).astype(np.float32),
            "target": feats[:, :, NB_BURG:].astype(np.float32),
            "mask": (1.0 - lost).astype(np.float32),
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class PLCDeviceLoader:
    """PLCLoader with the data on the device.

    The feature set ([n_train, T, 56] float32) and the loss-trace stream
    are uploaded once; `sample_fn` assembles a batch on the device (the row
    gather, the loss-trace row draw, 10 % Burg dropout, the flag channel
    and the scoring mask) from a `torch.Generator`, with no host traffic.

    Differences from PLCLoader's augmentation (documented, as in the JAX
    package): loss-trace windows come from two fixed reshape banks (offsets
    0 and T/2 into the trace stream) instead of one per-epoch random offset,
    and the Burg dropout and trace choice come from the generator rather
    than numpy. The val batch is byte-identical to PLCLoader's (the same
    fixed numpy seed), so val curves compare across loaders.
    Runs on CUDA unless `device="cpu"` is passed.
    """

    def __init__(self, feature_path: str, lost_path: str, tc: PLCTrainConfig,
                 seed: int = 0, val_seqs: int = 0, device=None):
        self.device = dev = resolve_device(device)
        train, self._val_features = _read_sequences(feature_path, tc,
                                                    val_seqs)
        self._features = torch.from_numpy(np.ascontiguousarray(train)).to(dev)
        lost = np.fromfile(lost_path, dtype=np.int8).astype(np.float32)
        t = tc.seq_length
        n_rows = len(lost) // t - 1
        # two reshape banks (offsets 0 and t//2) stand in for the host
        # loader's per-epoch random offset
        bank0 = lost[: n_rows * t].reshape(n_rows, t)
        bank1 = lost[t // 2: t // 2 + n_rows * t].reshape(n_rows, t)
        self._lost_rows = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([bank0, bank1], axis=0))).to(dev)
        self.tc = tc
        self.batch_size = tc.batch_size
        self._rng = np.random.RandomState(seed)
        self._n_train = train.shape[0]
        self.nb_batches = self._n_train // tc.batch_size
        self.on_epoch_end()
        # truncated as PLCLoader truncates its trace stream, so the val
        # batch's draws are the same for every corpus length
        self._lost_host = lost[: (len(lost) // t - 1) * t]

    @staticmethod
    def sample_fn(feats_d, lost_d, sel, generator: torch.Generator):
        """One batch from the device arrays: `sel` [B] sequence indices.
        `generator` may be a `utils.rng.ShardDraws` (this rank's share of
        the global batch's draws)."""
        dev = feats_d.device
        f = feats_d.index_select(0, sel.to(dev))               # [B, T, 56]
        b, t = f.shape[0], f.shape[1]
        g = generator
        burg_ok = (draw(torch.rand, (b, t, 1), g).to(dev) > 0.1
                   ).to(torch.float32)
        rows = draw(partial(torch.randint, 0, lost_d.shape[0]), (b,), g
                    ).to(dev)
        lost_b = lost_d.index_select(0, rows)[:, :, None]      # [B, T, 1]
        in_feats = f * lost_b
        in_feats = torch.cat([in_feats[:, :, :NB_BURG] * burg_ok,
                              in_feats[:, :, NB_BURG:]], dim=-1)
        flag = lost_b * (2.0 * burg_ok - 1.0)
        return {
            "plc_input": torch.cat([in_feats, flag], dim=-1),
            "target": f[:, :, NB_BURG:],
            "mask": 1.0 - lost_b,
        }

    @property
    def device_arrays(self):
        return self._features, self._lost_rows

    def index_blocks(self, block_steps: int):
        """Yield [block_steps, B] int32 sequence-index blocks covering one
        epoch (the last partial block is dropped)."""
        bs = self.batch_size
        n = (self.nb_batches // block_steps) * block_steps
        for i in range(0, n, block_steps):
            sel = self.indices[i * bs:(i + block_steps) * bs]
            yield np.reshape(sel, (block_steps, bs)).astype(np.int32)

    def on_epoch_end(self):
        self.indices = self._rng.permutation(self._n_train)

    def val_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """Identical to PLCLoader.val_batch (the same fixed numpy seed)."""
        if self._val_features is None:
            return None
        return _val_batch(self._val_features, self._lost_host)

    def __len__(self):
        return self.nb_batches


def make_plc_optimizer(tc: PLCTrainConfig, params):
    """(Adam(0.9, 0.99, eps 1e-7), LambdaLR) over the leaves of `params`:
    lr/(1 + decay*t), t the number of updates already made; quantization
    fine-tuning runs at 3e-5 without decay."""
    lr, decay = (3e-5, 0.0) if tc.quantize else (tc.lr, tc.decay)
    opt = torch.optim.Adam(list(_leaves(params)), lr=lr, betas=(0.9, 0.99),
                           eps=1e-7)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 1.0 / (1.0 + decay * t))
    return opt, sched


def clip_plc_grus(params):
    """WeightClip(0.992) on both GRUs' kernels and recurrents; a new dict."""
    params = dict(params)
    for g in ("plc_gru1", "plc_gru2"):
        params[g] = dict(params[g],
                         kernel=weight_clip_constraint(params[g]["kernel"]),
                         recurrent=weight_clip_constraint(
                             params[g]["recurrent"]))
    return params


class PLCTrainer:
    """The PLC network's trainer on one device, or data-parallel over the
    ranks of `mesh` (its device replaces `device`)."""

    BLOCK_SEED = 4242

    def __init__(self, plc_cfg: Optional[PM.PLCConfig] = None,
                 tc: Optional[PLCTrainConfig] = None, seed: int = 0,
                 device=None, mesh=None):
        self.cfg = plc_cfg or PM.PLCConfig()
        self.tc = tc or PLCTrainConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.params = _map(lambda p: p.requires_grad_(True),
                           PM.init_params(seed, self.cfg, self.device))
        if mesh is not None:
            replicated(mesh, self.params)
        self.optimizer, self.scheduler = make_plc_optimizer(self.tc,
                                                            self.params)
        self.step = 0

    def set_params(self, params) -> None:
        """Replace the parameters (e.g. from a checkpoint or another
        package) and start the optimizer anew over them."""
        with torch.no_grad():
            _assign(self.params, _map(_carry, self.params, params))
        self.optimizer, self.scheduler = make_plc_optimizer(self.tc,
                                                            self.params)

    def _loss(self, params, batch):
        x = batch["plc_input"]
        st0 = PM.init_state(x.shape[0], self.cfg, self.device)
        _, pred = PM.predict_sequence(params, st0, x)
        loss = plc_loss(batch["target"], batch["mask"], pred,
                        self.tc.band_loss, self.tc.loss_bias)
        return loss, plc_metrics(batch["target"], batch["mask"], pred)

    def train_step(self, batch, rng=None) -> Dict[str, torch.Tensor]:
        """One update from `batch` (numpy arrays or tensors; the global
        batch under a mesh). `rng` is accepted for the JAX signature and
        unused: the reference's GaussianNoise between the GRUs is not
        applied (as in JAX). Returns the metrics as device scalars."""
        return self._update(_place_batch(batch, self.device, self.mesh))

    def train_block(self, loader, sels, base_seed: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """sels.shape[0] steps over a PLCDeviceLoader from a [K, B] block
        of sequence indices (`loader.index_blocks`): each step's batch is
        assembled on the device by `loader.sample_fn` with a generator
        seeded from fold_seed(base_seed, step) (default base seed 4242, as
        the JAX package's), then `train_step`'s update. Nothing is read
        back to the host. Returns the metrics as [K] device tensors."""
        base = self.BLOCK_SEED if base_seed is None else base_seed
        sels = _block_sels(sels, self.device, self.mesh)
        feats_d, lost_d = loader.device_arrays
        gen = torch.Generator(device=self.device)
        ms = []
        for sel in sels:
            gen.manual_seed(fold_seed(base, self.step))
            ms.append(self._update(loader.sample_fn(
                feats_d, lost_d, sel, _shared_rng(gen, self.mesh))))
        return _stack_metrics(ms)

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        """The update of one batch on the device (this rank's share)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._loss(self.params, batch)
        loss.backward()
        metrics["loss"] = loss
        metrics = {k: v.detach() for k, v in metrics.items()}
        _mean_over_ranks(self.mesh, self.params, metrics)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        with torch.no_grad():
            _assign(self.params, clip_plc_grus(self.params))
        return metrics

    def eval_step(self, batch) -> Dict[str, float]:
        """Masked loss and metrics on a held-out batch, no update; a batch
        with fixed loss traces and Burg dropout gives a step-comparable
        curve."""
        batch = _to_device(batch, self.device)
        with torch.no_grad():
            loss, m = self._loss(self.params, batch)
        m["loss"] = loss
        return {k: float(v) for k, v in m.items()}

    def fit(self, loader, epochs: Optional[int] = None, log_every: int = 20,
            checkpoint_path: Optional[str] = None,
            logdir: Optional[str] = None):
        """Training loop over `loader`; writes
        `<checkpoint_path>_<epoch>.npz` after each epoch and, with
        `logdir`, `plc_metrics.jsonl` there."""
        from ..weights.checkpoint import save_checkpoint
        metrics_log = None
        if logdir is not None:
            import os

            from ..utils.profiling import MetricsLogger
            metrics_log = MetricsLogger(os.path.join(logdir,
                                                     "plc_metrics.jsonl"))
        for epoch in range(epochs or self.tc.epochs):
            for i, batch in enumerate(loader):
                m = self.train_step(batch)
                if metrics_log is not None:
                    metrics_log.log_async(step=i, epoch=epoch, **m)
                if i % log_every == 0:
                    if metrics_log is not None:
                        metrics_log.flush_async()
                    msg = " ".join(f"{k}={float(v):.4f}" for k, v in m.items())
                    print(f"plc epoch {epoch} step {i}: {msg}", flush=True)
            if metrics_log is not None:
                metrics_log.flush_async()
            if hasattr(loader, "on_epoch_end"):
                loader.on_epoch_end()
            if checkpoint_path:
                save_checkpoint(f"{checkpoint_path}_{epoch + 1:02d}.npz",
                                self.params)
        if metrics_log is not None:
            metrics_log.close()
        return self.params
