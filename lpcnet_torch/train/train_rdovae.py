"""RDO-VAE training: dataset, train step, training loop.

Counterpart of `lpcnet_tpu/train/train_rdovae.py`, after
torch/rdovae/train_rdovae.py: Adam(0.9, 0.99, eps=1e-8) with a
1/(1 + 2.5e-5 t) learning-rate decay, a per-sequence lambda drawn from the
16 quantizer levels (dataset.py:61-67), weight clipping at 0.496, loss =
soft rate + 0.1 hard rate (sqrt(lambda)-weighted) + the mean of the hard and
soft distortions over the decoder's stride-congruent chunks
(`models.rdovae.rdovae_loss`).

The trainer runs on one CUDA card unless the caller passes `device="cpu"`;
without CUDA and without that request it raises. Its recurrences are the
plain per-step GRUs of `models.rdovae`, as in the JAX package; no kernel.
The soft-quantization noise and the state-dropout draws come from a
`torch.Generator` where JAX passes a key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models import rdovae as RV
from ..utils.device import resolve_device
from .sparsify import weight_clip_constraint
from .train_lpcnet import _assign, _carry, _leaves, _map, _to_device


@dataclasses.dataclass(frozen=True)
class RDOVAETrainConfig:
    batch_size: int = 32
    sequence_length: int = 256
    lr: float = 3e-4
    lr_decay: float = 2.5e-5
    epochs: int = 100
    lambda_min: float = 2e-4
    lambda_max: float = 0.0104
    weight_clip: float = 0.496
    state_dropout_rate: float = 0.0   # fault injection: drop decoder inits


class RDOVAEDataset:
    """Feature-file dataset with per-sequence lambda / q draws, numpy on the
    host, making the JAX package's numpy draws in the same order."""

    def __init__(self, feature_path: str, tc: RDOVAETrainConfig,
                 cfg: RV.RDOVAEConfig, num_features: int = 36, seed: int = 0,
                 val_seqs: int = 0):
        feats = np.fromfile(feature_path, dtype=np.float32).reshape(
            -1, num_features)
        self.features = feats[:, : cfg.num_features]
        self.tc = tc
        self.cfg = cfg
        nseq = self.features.shape[0] // tc.sequence_length
        # the last val_seqs sequences are held out of training entirely
        self.num_sequences = nseq - val_seqs
        self._val_range = (self.num_sequences, nseq) if val_seqs else None
        self.denominator = ((cfg.quant_levels - 1)
                            / np.log(tc.lambda_max / tc.lambda_min))
        self._rng = np.random.RandomState(seed)

    def val_batch(self, q: int) -> Optional[Dict[str, np.ndarray]]:
        """The held-out sequences at a fixed quantizer level q: the same
        batch at every call, so val curves are step-comparable and
        rate-distortion points across q are measured on the same data."""
        if self._val_range is None:
            return None
        lo, hi = self._val_range
        sl = self.tc.sequence_length
        feats = np.stack([self.features[s * sl:(s + 1) * sl]
                          for s in range(lo, hi)])
        bs = feats.shape[0]
        q_ids = np.full((bs, sl // self.cfg.enc_frames_per_step), q)
        lam = self.tc.lambda_min * np.exp(q_ids / self.denominator)
        return {"features": feats.astype(np.float32),
                "rate_lambda": lam.astype(np.float32),
                "q_ids": q_ids.astype(np.int32)}

    def __len__(self):
        return max(self.num_sequences // self.tc.batch_size, 0)

    def __iter__(self):
        order = self._rng.permutation(self.num_sequences)
        bs, sl = self.tc.batch_size, self.tc.sequence_length
        for i in range(len(self)):
            sel = order[i * bs:(i + 1) * bs]
            feats = np.stack([self.features[s * sl:(s + 1) * sl] for s in sel])
            q = self._rng.randint(0, self.cfg.quant_levels, (bs, 1))
            q_ids = np.repeat(q, sl // self.cfg.enc_frames_per_step, axis=1)
            lam = self.tc.lambda_min * np.exp(q_ids / self.denominator)
            yield {"features": feats.astype(np.float32),
                   "rate_lambda": lam.astype(np.float32),
                   "q_ids": q_ids.astype(np.int32)}


def clip_rdovae_weights(params, c: float):
    """The pairwise weight clip on every 2-D leaf (torch rdovae.py:201-223
    clips the Linear and GRU weights). Returns a new tree."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = clip_rdovae_weights(v, c)
        elif v.ndim == 2:
            out[k] = weight_clip_constraint(v, c)
        else:
            out[k] = v
    return out


def make_rdovae_optimizer(tc: RDOVAETrainConfig, params):
    """(Adam(0.9, 0.99, eps 1e-8), LambdaLR): lr/(1 + lr_decay*t), t the
    number of updates already made."""
    opt = torch.optim.Adam(list(_leaves(params)), lr=tc.lr, betas=(0.9, 0.99),
                           eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 1.0 / (1.0 + tc.lr_decay * t))
    return opt, sched


class RDOVAETrainer:
    """The RDO-VAE's trainer on one device."""

    def __init__(self, cfg: Optional[RV.RDOVAEConfig] = None,
                 tc: Optional[RDOVAETrainConfig] = None, seed: int = 0,
                 device=None):
        self.cfg = cfg or RV.RDOVAEConfig()
        self.tc = tc or RDOVAETrainConfig()
        self.device = resolve_device(device)
        self.params = _map(lambda p: p.requires_grad_(True),
                           RV.init_params(self.cfg, seed, self.device))
        self.optimizer, self.scheduler = make_rdovae_optimizer(self.tc,
                                                               self.params)
        self.step = 0

    def set_params(self, params) -> None:
        """Replace the parameters and start the optimizer anew over them."""
        with torch.no_grad():
            _assign(self.params, _map(_carry, self.params, params))
        self.optimizer, self.scheduler = make_rdovae_optimizer(self.tc,
                                                               self.params)

    def eval_step(self, batch, params=None) -> Dict[str, float]:
        """Loss metrics on a held-out batch, no update, with a fixed
        generator (the soft-quantization noise is the same at every call)
        and no state dropout: step-comparable val curves."""
        params = self.params if params is None else params
        batch = _to_device(batch, self.device)
        g = torch.Generator(device=self.device)
        g.manual_seed(0)
        with torch.no_grad():
            _, metrics = RV.rdovae_loss(params, batch["features"],
                                        batch["rate_lambda"], batch["q_ids"],
                                        g, self.cfg, 0.0)
        return {k: float(v) for k, v in metrics.items()}

    def train_step(self, batch, rng: Optional[torch.Generator],
                   noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One update. `rng` draws the soft-quantization noise and the state
        dropout; `noise` (a U(0, 1) draw of the latents' shape) replaces the
        former where given. Returns the metrics as device scalars."""
        batch = _to_device(batch, self.device)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = RV.rdovae_loss(
            self.params, batch["features"], batch["rate_lambda"],
            batch["q_ids"], rng, self.cfg, self.tc.state_dropout_rate,
            noise=None if noise is None else noise.to(self.device))
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        with torch.no_grad():
            _assign(self.params, clip_rdovae_weights(self.params,
                                                     self.tc.weight_clip))
        return {k: v.detach() for k, v in metrics.items()}

    def fit(self, loader, epochs: Optional[int] = None, log_every: int = 20,
            checkpoint_path: Optional[str] = None,
            logdir: Optional[str] = None):
        """Training loop over `loader`; writes the flattened params to
        `<checkpoint_path>_<epoch>.npz` after each epoch and, with `logdir`,
        `rdovae_metrics.jsonl` there."""
        from ..weights.checkpoint import flatten_tree
        metrics_log = None
        if logdir is not None:
            import os

            from ..utils.profiling import MetricsLogger
            metrics_log = MetricsLogger(os.path.join(logdir,
                                                     "rdovae_metrics.jsonl"))
        rng = torch.Generator(device=self.device)
        rng.manual_seed(42)
        for epoch in range(epochs or self.tc.epochs):
            for i, batch in enumerate(loader):
                m = self.train_step(batch, rng)
                if metrics_log is not None:
                    metrics_log.log_async(step=i, epoch=epoch, **m)
                if i % log_every == 0:
                    if metrics_log is not None:
                        metrics_log.flush_async()
                    msg = " ".join(f"{k}={float(v):.4f}" for k, v in m.items())
                    print(f"rdovae epoch {epoch} step {i}: {msg}", flush=True)
            if metrics_log is not None:
                metrics_log.flush_async()
            if checkpoint_path:
                np.savez(f"{checkpoint_path}_{epoch + 1:02d}.npz",
                         **flatten_tree(self.params))
        if metrics_log is not None:
            metrics_log.close()
        return self.params
