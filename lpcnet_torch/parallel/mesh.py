"""Data parallelism over `torch.distributed`.

Counterpart of `lpcnet_tpu/parallel/mesh.py`. LPCNet-class models are tiny
(GRUs of at most 384 units), so the parallelism that fits is pure data
parallelism: the global batch is split on its leading axis across ranks,
the parameters are replicated, and the gradient is the mean over ranks.
(The reference's only distributed strategy is the equivalent
MultiWorkerMirroredStrategy, training_tf2/train_lpcnet.py:133-135.) Tensor,
pipeline and expert parallelism have nothing to shard here.

Start every process with `init_distributed` (under `torchrun` it reads the
rank and world size from the environment), then build the trainer with
`mesh=make_mesh()`. The trainers broadcast their initial parameters
(`replicated`), take this rank's slice of each batch (`shard_batch`) and
average the gradients in one collective a step (`all_reduce_mean`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group. `group` is None in a
    single process without `torch.distributed`: then nothing is
    communicated."""
    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join the process group, before `make_mesh`.

    A no-op in a single process started without these arguments and
    outside `torchrun` (no RANK and WORLD_SIZE in the environment), and
    when the group exists already. The default backend is NCCL when CUDA is
    available, else gloo; the default `init_method` is `env://`. A backend
    that fails to start raises.
    """
    if dist.is_initialized():
        return
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and rank is None \
            and not from_env:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def make_mesh(device=None) -> Mesh:
    """This rank's mesh: the default process group (or none), its rank and
    size, and the rank's device, `cuda:<local rank>` unless the caller asks
    for another (`device="cpu"`). The local rank is LOCAL_RANK where
    `torchrun` sets it, else the rank modulo the number of cards."""
    dev = resolve_device(device)
    if dist.is_initialized():
        group, rank, world = (dist.group.WORLD, dist.get_rank(),
                              dist.get_world_size())
    else:
        group, rank, world = None, 0, 1
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return Mesh(group, rank, world, dev)


def rank_slice(mesh: Mesh, n: int) -> slice:
    """This rank's share of a batch axis of `n`; raises unless `n` divides
    by the world size, as a JAX sharding does."""
    if n % mesh.world_size:
        raise ValueError(f"shard_batch: a batch of {n} does not divide "
                         f"over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _shard(mesh: Mesh, x):
    x = x[rank_slice(mesh, x.shape[0])]
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


def shard_batch(mesh: Mesh, tree):
    """This rank's slice of each leaf's leading axis (a dict, list, tuple or
    NamedTuple of tensors or numpy arrays), on `mesh.device`. Raises unless
    every leading axis divides by the world size, as a JAX sharding does."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batch(mesh, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return _shard(mesh, tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _flat_collective(mesh: Mesh, tensors, op) -> None:
    """`op(flat)` on one flat buffer of `tensors` (one dtype), copied back
    into them in place."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one dtype per collective, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    op(flat)
    with torch.no_grad():
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def replicated(mesh: Mesh, params):
    """Broadcast the parameter tree from rank 0, in place, so every rank
    starts from rank 0's values. Returns `params`."""
    if mesh.group is not None:
        _flat_collective(mesh, _leaves(params),
                         lambda f: dist.broadcast(f, 0, group=mesh.group))
    return params


def all_reduce_mean(mesh: Mesh, tensors) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    `all_reduce` over a flat buffer of them all (None entries are
    skipped)."""
    tensors = [t for t in tensors if t is not None]
    if mesh.group is None or not tensors:
        return

    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world_size)

    _flat_collective(mesh, tensors, mean)
