"""LPCNet vocoder training: loss, train step and the trainer.

    python -m lpcnet_torch.train.train_lpcnet <features.f32> <data.s16> <output>

Counterpart of `lpcnet_tpu/train/train_lpcnet.py`, after
training_tf2/train_lpcnet.py: Adam(beta1=.5, beta2=.8) with the Keras-legacy
lr/(1+decay*t) schedule, 15-frame truncated-BPTT chunks with the GRU states
carried from chunk to chunk, progressive sparsification of GRU-A's recurrent
weights and GRU-B's input weights, optional quantization fine-tuning,
weight-clip constraints, optional scheduled sampling.

The trainer runs on one CUDA card unless the caller passes `device="cpu"`;
without CUDA and without that request it raises. On a card the two GRU
recurrences of the training graph run through the CUDA kernels of
`kernels/gru_train.py` (forward and backward), and scheduled sampling's
free-running pass through the masked sample-loop kernel. A step does not
synchronise with the host: metrics come back as device scalars, to be
fetched at log intervals.

`Trainer.train_block` runs K steps whose batches are gathered on the device
(`DeviceLPCNetLoader.sample_fn`) from a [K, B] block of chunk indices, each
step's generator seeded from (base seed, step), so the result does not
depend on the block size; it reads nothing back to the host. With
`mesh=parallel.mesh.make_mesh()` the trainer is data-parallel over
`torch.distributed`: parameters broadcast from rank 0, each batch split
over the ranks, the gradients (and metrics) averaged by one all-reduce a
step before the update, every random draw made at the global batch's shape
and sliced (`utils.rng.ShardDraws`), so N ranks compute what one does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import lpcnet as M
from ..parallel.mesh import (all_reduce_mean, rank_slice, replicated,
                             shard_batch)
from ..utils.device import resolve_device
from ..utils.rng import ShardDraws, draw, fold_seed
from ..weights.convert import array_to_torch
from . import losses as LL
from .sparsify import SparsifySchedule, apply_schedules, weight_clip_constraint


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128
    chunk_frames: int = 15
    lr: float = 1e-3
    decay: float = 5e-5
    beta1: float = 0.5
    beta2: float = 0.8
    epochs: int = 120
    lookahead: int = 2
    quantize: bool = False
    gamma: float = 2.0            # e2e u-law compensation
    density: Tuple[float, float, float] = (0.05, 0.05, 0.2)
    grub_density: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    schedule_scale: float = 1.0   # compresses sparsify/quantize schedules
    ema_decay: float = 0.0        # >0 keeps an EMA of params for eval/ship
    # scheduled sampling: probability that the signal history fed to the
    # network is the model's OWN sampled output instead of ground truth
    # (train/scheduled.py; 0 = pure teacher forcing)
    ss_prob: float = 0.0
    # the teacher-force / free-run decision is drawn per ss_block samples
    # (1 = independently per sample)
    ss_block: int = 16
    # feed the excitation-history input from the CLEAN signal, so the model
    # cannot read its own sampling deviation off that channel
    ss_hide_exc: bool = False
    # blend (1-w)*correction-CE + w*KL(teacher || student) against the
    # teacher-forced pdf of the same params on the clean history; 0 = off
    ss_distill: float = 0.0
    # std of the Gaussian noise on the u-law (sig, pred, exc) inputs; 0.3
    # is the reference's GaussianNoise(.3) (training_tf2/lpcnet.py:264)
    input_noise: float = 0.3

    @property
    def chunk_samples(self) -> int:
        return self.chunk_frames * 160


def _leaves(tree):
    """The leaf tensors of a nested dict, in its own key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def make_optimizer(tc: TrainConfig, params):
    """(Adam, LambdaLR) over the leaves of `params`: lr/(1 + decay*t) with t
    the number of updates already made (0 for the first), eps 1e-7."""
    if tc.quantize:
        lr, decay = 3e-5, 0.0
    else:
        lr, decay = tc.lr, tc.decay
    opt = torch.optim.Adam(list(_leaves(params)), lr=lr,
                           betas=(tc.beta1, tc.beta2), eps=1e-7)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 1.0 / (1.0 + decay * t))
    return opt, sched


def loss_fn(params, cfg: M.LPCNetConfig, tc: TrainConfig, batch,
            rng: Optional[torch.Generator], gru_states=None,
            gru_impl: str = "auto"):
    """The training loss of one batch -> (loss, (metrics, new gru states)).

    batch: dict of tensors sig_in, sig_out [B, T], features [B, F+4, 20],
    periods [B, F+4], lpc [B, F, 16] (rc [B, F, 16] with cfg.e2e). rng
    draws the scheduled-sampling mask and seeds and the noise regularizers;
    None switches the noise off (and is an error with ss_prob > 0).
    """
    sig_in = batch["sig_in"]
    sig_clean = sig_in
    exc_override = None
    dev = sig_in.device
    ss = tc.ss_prob > 0.0
    if ss:
        from .scheduled import mixed_history, sampled_signal
        if rng is None:
            raise ValueError("scheduled sampling (ss_prob > 0) needs an rng")
        b, t = sig_in.shape
        blk = max(1, tc.ss_block)
        draws = draw(torch.rand, (b, (t + blk - 1) // blk), rng).to(dev)
        tf_mask = (draws < 1.0 - tc.ss_prob).repeat_interleave(
            blk, dim=1)[:, :t]
        weighting = torch.pow(
            torch.full((), cfg.lpc_gamma, dtype=torch.float32, device=dev),
            torch.arange(1, 17, dtype=torch.float32, device=dev))
        s_hat = sampled_signal(params, cfg, batch, tf_mask, rng,
                               gru_states=gru_states, weighting=weighting)
        sig_in = mixed_history(sig_in, s_hat, tf_mask)
        if tc.ss_hide_exc and not cfg.e2e:
            preds_clean = LL.diff_pred(sig_clean, batch["lpc"] * weighting,
                                       cfg.frame_size)
            exc_override = LL.tf_l2u(
                sig_clean - torch.roll(preds_clean, 1, dims=-1))
    noise_state = rng.get_state() if rng is not None else None
    out = M.training_forward(
        params, cfg, sig_in, batch["features"], batch["periods"],
        lpc=batch.get("lpc"), rng=rng, training=True, gru_states=gru_states,
        noise_std=tc.input_noise, exc_hist_override=exc_override,
        gru_impl=gru_impl)
    cel = LL.metric_cel_tree(batch["sig_out"], out["tensor_preds"],
                             out["tree_probs"]).mean()
    distill = None
    if ss and tc.ss_distill > 0.0 and not cfg.e2e:
        # the teacher: the same params on the clean history, no gradient,
        # the same noise draws (the generator is wound back), so only the
        # history differs between teacher and student
        rng.set_state(noise_state)
        with torch.no_grad():
            t_out = M.training_forward(
                params, cfg, sig_clean, batch["features"], batch["periods"],
                lpc=batch.get("lpc"), rng=rng, training=True,
                gru_states=gru_states, noise_std=tc.input_noise,
                gru_impl=gru_impl)
        distill = LL.tree_distill_kl(t_out["tree_probs"],
                                     out["tree_probs"]).mean()
    if cfg.e2e:
        ce = LL.interp_mulaw_loss_tree(batch["sig_out"], out["tensor_preds"],
                                       out["real_preds"], out["tree_probs"],
                                       tc.gamma)
        lar = LL.loss_matchlar(batch["rc"], out["rc"])
        loss = ce.mean() + 2.0 * lar.mean()
    else:
        loss = cel
    if distill is not None:
        w = tc.ss_distill
        loss = (1.0 - w) * loss + w * distill
    metrics = {
        "loss": loss,
        "cel": cel,
        "exc_sd": LL.metric_exc_sd(batch["sig_out"],
                                   out["tensor_preds"]).mean(),
    }
    if distill is not None:
        metrics["distill_kl"] = distill
    return loss, (metrics, out["gru_states"])


def apply_constraints(params):
    """The Keras constraints applied after each update
    (training_tf2/lpcnet.py:286-294): WeightClip(0.992) on GRU-A's recurrent
    and GRU-B's kernel and recurrent weights. Returns a new params dict."""
    params = dict(params)
    params["gru_a"] = dict(
        params["gru_a"],
        recurrent=weight_clip_constraint(params["gru_a"]["recurrent"]))
    params["gru_b"] = dict(
        params["gru_b"],
        kernel=weight_clip_constraint(params["gru_b"]["kernel"]),
        recurrent=weight_clip_constraint(params["gru_b"]["recurrent"]))
    return params


def _assign(params, new) -> None:
    """Copy the leaves of `new` that differ in identity into `params`, in
    place, so the optimizer keeps its tensors."""
    for p, n in zip(_leaves(params), _leaves(new)):
        if n is not p:
            p.copy_(n)


def _carry(p, n):
    """A leaf `n` (a tensor or any array) on `p`'s device and type."""
    n = n if isinstance(n, torch.Tensor) else array_to_torch(n)
    return n.to(p.device, p.dtype)


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _place_batch(batch, device, mesh) -> Dict[str, torch.Tensor]:
    """The batch on `device`, or this rank's slice of it under `mesh`."""
    return _to_device(batch, device) if mesh is None else shard_batch(mesh,
                                                                      batch)


def _shared_rng(rng, mesh):
    """`rng` as the ranks share it: its draws at the global batch's shape."""
    if mesh is None or rng is None:
        return rng
    return ShardDraws(rng, mesh.rank, mesh.world_size)


def _block_sels(sels, device, mesh) -> torch.Tensor:
    """A [K, B] block of batch indices as int64 on `device` (this rank's
    columns under `mesh`). A host array goes up from pinned memory without
    the host waiting for the card."""
    sels = sels if isinstance(sels, torch.Tensor) else torch.from_numpy(
        np.asarray(sels))
    if mesh is not None:
        sels = sels[:, rank_slice(mesh, sels.shape[1])]
    sels = sels.to(torch.int64)
    if device.type == "cuda" and sels.device.type == "cpu":
        return sels.pin_memory().to(device, non_blocking=True)
    return sels.to(device)


def _stack_metrics(ms) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def _mean_over_ranks(mesh, params, metrics) -> None:
    """Under `mesh`, every gradient of `params` and every metric replaced by
    its mean over the ranks, in one all-reduce, before the update."""
    if mesh is not None:
        all_reduce_mean(mesh, [p.grad for p in _leaves(params)]
                        + list(metrics.values()))


class Trainer:
    """End-to-end trainer on one device, or data-parallel over the ranks of
    `mesh` (`parallel.mesh.make_mesh`; its device replaces `device`)."""

    BLOCK_SEED = 917

    def __init__(self, cfg: Optional[M.LPCNetConfig] = None,
                 tc: Optional[TrainConfig] = None, seed: int = 0,
                 device=None, gru_impl: str = "auto", mesh=None):
        self.cfg = cfg or M.LPCNetConfig()
        self.tc = tc or TrainConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.gru_impl = gru_impl
        self.params = _map(lambda p: p.requires_grad_(True),
                           M.init_params(self.cfg, seed, self.device))
        if mesh is not None:
            replicated(mesh, self.params)
        self.optimizer, self.scheduler = make_optimizer(self.tc, self.params)
        self.step = 0
        sc = self.tc.schedule_scale
        if self.tc.quantize:
            self.sched_a = SparsifySchedule.quantize_finetune(self.tc.density, sc)
            self.sched_b = SparsifySchedule.quantize_finetune(self.tc.grub_density, sc)
        else:
            self.sched_a = SparsifySchedule.from_scratch_gru_a(self.tc.density, sc)
            self.sched_b = SparsifySchedule.from_scratch_gru_b(self.tc.grub_density, sc)
        # stateful truncated BPTT: the GRU states carry across successive
        # chunks (the reference trains with stateful=True)
        self._gru_states = None
        self._ema = (_map(lambda p: p.detach().clone(), self.params)
                     if self.tc.ema_decay > 0.0 else None)

    def set_params(self, params) -> None:
        """Replace the parameters (e.g. from a checkpoint) and start the
        optimizer anew over them."""
        with torch.no_grad():
            _assign(self.params, _map(_carry, self.params, params))
        self.optimizer, self.scheduler = make_optimizer(self.tc, self.params)
        self._set_schedule_step(self.step)

    def _zero_states(self, b: int):
        z = lambda n: torch.zeros((b, n), dtype=torch.float32,
                                  device=self.device)
        return z(self.cfg.rnn_units1), z(self.cfg.rnn_units2)

    def train_step(self, batch, rng: Optional[torch.Generator]
                   ) -> Dict[str, torch.Tensor]:
        """One update from `batch` (numpy arrays or tensors; the global
        batch under a mesh). Returns the metrics as device scalars: fetch
        them at log intervals, since a fetch every step makes the host wait
        for the card."""
        return self._update(_place_batch(batch, self.device, self.mesh), rng)

    def train_block(self, loader, sels, base_seed: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """sels.shape[0] steps over a DeviceLPCNetLoader, from a [K, B]
        block of chunk indices (`loader.index_blocks`). Each step gathers
        its batch on the device (`loader.sample_fn`) and takes
        `train_step`'s update with a generator seeded from
        fold_seed(base_seed, step), so the result does not depend on the
        block size (default base seed 917, as the JAX package's). Nothing
        is read back to the host. Returns the metrics as [K] device
        tensors."""
        base = self.BLOCK_SEED if base_seed is None else base_seed
        sels = _block_sels(sels, self.device, self.mesh)
        arrays = loader.device_arrays
        gen = torch.Generator(device=self.device)
        ms = []
        for sel in sels:
            gen.manual_seed(fold_seed(base, self.step))
            ms.append(self._update(loader.sample_fn(*arrays, sel), gen))
        return _stack_metrics(ms)

    def _update(self, batch, rng) -> Dict[str, torch.Tensor]:
        """The update of one batch on the device (this rank's share)."""
        if self._gru_states is None:
            self._gru_states = self._zero_states(batch["sig_in"].shape[0])
        self.optimizer.zero_grad(set_to_none=True)
        loss, (metrics, new_states) = loss_fn(
            self.params, self.cfg, self.tc, batch,
            _shared_rng(rng, self.mesh), self._gru_states, self.gru_impl)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        _mean_over_ranks(self.mesh, self.params, metrics)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        with torch.no_grad():
            _assign(self.params, apply_constraints(self.params))
            # an all-dense run without quantization has nothing to schedule
            if not (self.sched_a.dense and self.sched_b.dense) and (
                    self.sched_a.active(self.step)
                    or self.sched_b.active(self.step)):
                _assign(self.params, apply_schedules(
                    self.params, self.step, self.sched_a, self.sched_b,
                    self.cfg.rnn_units1))
            if self._ema is not None:
                d = self.tc.ema_decay
                for e, p in zip(_leaves(self._ema), _leaves(self.params)):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        self._gru_states = tuple(h.detach() for h in new_states)
        return metrics

    def eval_loss(self, batches, params=None) -> Dict[str, float]:
        """Mean teacher-forced loss over held-out batches (e.g.
        loader.val_batches()): the same surface as the train loss.
        Deterministic: a fixed noise generator, fresh GRU states per batch."""
        params = self.params if params is None else params
        total, n = None, 0
        for batch in batches:
            batch = _to_device(batch, self.device)
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
            with torch.no_grad():
                _, (m, _) = loss_fn(
                    params, self.cfg, self.tc, batch, rng,
                    self._zero_states(batch["sig_in"].shape[0]),
                    self.gru_impl)
            total = m if total is None else {k: total[k] + m[k] for k in total}
            n += 1
        if total is None:
            return {}
        return {k: float(v) / n for k, v in total.items()}

    @property
    def ema_params(self):
        """EMA of the parameters (None when ema_decay == 0)."""
        return self._ema

    def reset_ema(self):
        """Re-seed the EMA from the current parameters (after replacing the
        state from a checkpoint that carried no EMA)."""
        if self.tc.ema_decay > 0.0:
            self._ema = _map(lambda p: p.detach().clone(), self.params)

    def _moments(self, name: str):
        def get(p):
            st = self.optimizer.state.get(p)
            return st[name] if st else torch.zeros_like(p)
        return _map(get, self.params)

    def full_state(self):
        """Everything needed for exact resume: parameters, Adam moments and
        step, the truncated-BPTT carry (+ the EMA when enabled); the
        argument of `checkpointing.save_train_state`."""
        full = {
            "train_state": {
                "params": _map(lambda p: p.detach(), self.params),
                "opt": {"exp_avg": self._moments("exp_avg"),
                        "exp_avg_sq": self._moments("exp_avg_sq")},
                "step": self.step,
            },
            "gru_states": self._gru_states,
        }
        if self._ema is not None:
            full["ema"] = self._ema
        return full

    def _set_schedule_step(self, step: int) -> None:
        self.scheduler.last_epoch = step
        for group, base, lam in zip(self.optimizer.param_groups,
                                    self.scheduler.base_lrs,
                                    self.scheduler.lr_lambdas):
            group["lr"] = base * lam(step)
        self.scheduler._last_lr = [g["lr"] for g in
                                   self.optimizer.param_groups]

    def restore_full_state(self, full) -> None:
        ts = full["train_state"]
        self.step = int(ts["step"])
        with torch.no_grad():
            _assign(self.params, _map(lambda p, n: n.to(p.device, p.dtype),
                                      self.params, ts["params"]))
        self.optimizer, self.scheduler = make_optimizer(self.tc, self.params)
        if self.step > 0:
            for p, m, v in zip(_leaves(self.params),
                               _leaves(ts["opt"]["exp_avg"]),
                               _leaves(ts["opt"]["exp_avg_sq"])):
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(self.step)),
                    "exp_avg": m.detach().clone().to(p.device),
                    "exp_avg_sq": v.detach().clone().to(p.device)}
        self._set_schedule_step(self.step)
        gs = full.get("gru_states")
        self._gru_states = (None if gs is None else
                            tuple(h.detach().to(self.device) for h in gs))
        if self.tc.ema_decay > 0.0:
            if full.get("ema") is not None:
                self._ema = _map(lambda e: e.detach().clone().to(self.device),
                                 full["ema"])
            else:
                # no EMA in the restored state: re-seed from the restored
                # parameters, else it stays an EMA of the random init
                self.reset_ema()

    def fit(self, loader, epochs: Optional[int] = None, log_every: int = 50,
            checkpoint_path: Optional[str] = None, logdir: Optional[str] = None,
            validator=None, val_every: int = 0,
            best_checkpoint_path: Optional[str] = None):
        """Training loop over `loader` (an LPCNetLoader or a
        DeviceLPCNetLoader); writes `<checkpoint_path>_<epoch>.npz` after
        each epoch. The metrics are fetched and printed every `log_every`
        steps, and with `logdir` written to `lpcnet_metrics.jsonl` there.
        With `validator` (train.validation.HeldOutValidator) and
        `val_every`, every `val_every` steps the raw params (and the EMA
        when enabled) are evaluated on held-out audio; the one with the
        lowest band-LSD so far is written to `best_checkpoint_path`."""
        from ..weights.checkpoint import save_checkpoint
        metrics_log = None
        if logdir is not None:
            import os

            from ..utils.profiling import MetricsLogger
            metrics_log = MetricsLogger(os.path.join(logdir,
                                                     "lpcnet_metrics.jsonl"))
        best = None
        if validator is not None and val_every:
            from .validation import BestTracker
            best = BestTracker()
        rng = torch.Generator(device=self.device)
        rng.manual_seed(123)
        epochs = epochs or self.tc.epochs
        for epoch in range(epochs):
            for i, batch in enumerate(loader):
                metrics = self.train_step(batch, rng)
                if metrics_log is not None:
                    metrics_log.log_async(step=self.step, epoch=epoch,
                                          **metrics)
                if i % log_every == 0:
                    if metrics_log is not None:
                        metrics_log.flush_async()
                    msg = " ".join(f"{k}={float(v):.4f}"
                                   for k, v in metrics.items())
                    print(f"epoch {epoch} step {i}: {msg}", flush=True)
                if best is not None and self.step % val_every == 0:
                    cand = [("raw", self.params)]
                    if self.ema_params is not None:
                        cand.append(("ema", self.ema_params))
                    results = {n: validator.evaluate(p) for n, p in cand}
                    win = min(results,
                              key=lambda k: results[k]["band_lsd_db"])
                    if (best.update(self.step, results[win])
                            and best_checkpoint_path):
                        save_checkpoint(best_checkpoint_path,
                                        dict(cand)[win], self.cfg)
                    if metrics_log is not None:
                        for n, r in results.items():
                            metrics_log.log_async(step=self.step,
                                                  kind=f"val_{n}", **r)
                        metrics_log.flush_async()
                    print(f"step {self.step}: val "
                          + " ".join(f"{n}={r['band_lsd_db']:.3f}dB"
                                     for n, r in results.items())
                          + f" (best {best.best:.3f} @ {best.best_step})",
                          flush=True)
            if metrics_log is not None:
                metrics_log.flush_async()
            if checkpoint_path:
                save_checkpoint(f"{checkpoint_path}_{epoch + 1:02d}.npz",
                                self.params, self.cfg)
            if hasattr(loader, "on_epoch_end"):
                loader.on_epoch_end()
        if metrics_log is not None:
            metrics_log.close()
        return self.params


def main(argv=None):
    """CLI mirroring training_tf2/train_lpcnet.py."""
    import argparse

    from ..weights.checkpoint import load_checkpoint
    from .data import LPCNetLoader

    ap = argparse.ArgumentParser(prog="lpcnet_torch.train.train_lpcnet")
    ap.add_argument("features")
    ap.add_argument("data")
    ap.add_argument("output")
    ap.add_argument("--quantize", metavar="<input weights>", default=None)
    ap.add_argument("--retrain", metavar="<input weights>", default=None)
    ap.add_argument("--density-split", nargs=3, type=float,
                    default=(0.05, 0.05, 0.2))
    ap.add_argument("--grua-size", type=int, default=384)
    ap.add_argument("--grub-size", type=int, default=16)
    ap.add_argument("--cond-size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--decay", type=float, default=None)
    ap.add_argument("--end2end", action="store_true")
    ap.add_argument("--lookahead", type=int, default=2)
    ap.add_argument("--lpc-gamma", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    cfg = M.LPCNetConfig(rnn_units1=ns.grua_size, rnn_units2=ns.grub_size,
                         cond_size=ns.cond_size, e2e=ns.end2end,
                         lookahead=ns.lookahead, lpc_gamma=ns.lpc_gamma)
    tc = TrainConfig(batch_size=ns.batch_size, epochs=ns.epochs,
                     lookahead=ns.lookahead, quantize=ns.quantize is not None,
                     density=tuple(ns.density_split),
                     **({"lr": ns.lr} if ns.lr else {}),
                     **({"decay": ns.decay} if ns.decay is not None else {}))
    trainer = Trainer(cfg, tc, device=ns.device)
    init_from = ns.quantize or ns.retrain
    if init_from:
        params, _ = load_checkpoint(init_from, trainer.device)
        trainer.set_params(params)
    loader = LPCNetLoader(ns.data, ns.features, batch_size=ns.batch_size,
                          lookahead=ns.lookahead, e2e=ns.end2end)
    trainer.fit(loader, checkpoint_path=f"{ns.output}_{ns.grua_size}")
    return 0


if __name__ == "__main__":
    main()
