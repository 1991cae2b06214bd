"""Data parallelism over ranks: one process per rank, one device per
process. Port of lsenerf_tpu/parallel/mesh.py and the data-parallel part of
the repo's train.py.

The JAX package shards the ray batch over a device mesh inside one jitted
step; the port runs one process a rank, as the reference did (mp.spawn +
NCCL), and keeps the JAX package's invariant: the global batch. The ray
budgets are rounded down to a multiple of the world size and each rank
samples its 1/world share (`round_rays`, the counterpart of
`round_rays_to_mesh`), with the sampler seeded machine.seed + rank.

The parameters are a dict of leaves, not an nn.Module, so the trainer
all-reduces the gradients itself between backward() and Adam
(`DataParallel.average_grads`, in buckets, averaged); K2/K7b each write a
rank's table gradient with atomics and the all-reduce sums them. A loss
that is not a mean over rays (enerf_norm_loss's norms over the batch)
sums over the ranks through an autograd-aware all-reduce (`batch_sum`).
The occupancy update shards its density sweep over the ranks and
combines the decayed-and-scattered grids with an all-reduce MAX, so every
rank holds the same grid. The backend is NCCL on the card and gloo on the
CPU; gloo also takes CUDA tensors, which lets two ranks share one card
(NCCL refuses that).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2**20  # the gradient all-reduce's bucket size (DDP's default)


class DataParallel:
    """This process's rank in a process group of `world_size` ranks."""

    def __init__(self, rank: int, world_size: int, group=None):
        self.rank, self.world_size, self.group = rank, world_size, group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def share(self, n: int) -> tuple[int, int]:
        """This rank's [lo, hi) of n items split into contiguous shares."""
        return n * self.rank // self.world_size, n * (self.rank + 1) // self.world_size

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def broadcast_(self, tensors) -> None:
        """Rank 0's values into every rank's tensors, in place."""
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0, group=self.group)

    def average_grads(self, tensors) -> None:
        """Average the tensors (the leaves' gradients, in the same order on
        every rank) over the ranks, in place, in buckets of BUCKET_BYTES."""
        bucket, size = [], 0

        def flush():
            if len(bucket) == 1:
                dist.all_reduce(bucket[0], group=self.group)
                bucket[0].div_(self.world_size)
            elif bucket:
                flat = torch.cat([g.reshape(-1) for g in bucket])
                dist.all_reduce(flat, group=self.group)
                flat.div_(self.world_size)
                offset = 0
                for g in bucket:
                    g.copy_(flat[offset : offset + g.numel()].view_as(g))
                    offset += g.numel()
            bucket.clear()

        for g in tensors:
            nbytes = g.numel() * g.element_size()
            if bucket and (size + nbytes > BUCKET_BYTES or g.dtype != bucket[0].dtype):
                flush()
                size = 0
            bucket.append(g)
            size += nbytes
        flush()

    def average_metrics(self, metrics: dict) -> dict:
        """The metrics averaged over the ranks in one all-reduce: the
        global batch's value for a mean over equal shares of rays (the
        losses, num_samples_per_ray); psnr is averaged as its MSE."""
        keys = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        if "psnr" in keys:
            i = keys.index("psnr")
            vals[i] = 10.0 ** (-vals[i] / 10.0)
        dist.all_reduce(vals, group=self.group)
        vals = vals / self.world_size
        if "psnr" in keys:
            vals[i] = -10.0 * torch.log10(vals[i])
        return {k: vals[j] for j, k in enumerate(keys)}

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks, with a gradient: the backward sums
        the ranks' cotangents, which with the gradient average gives the
        gradient of the mean of the ranks' losses."""
        import torch.distributed.nn.functional as dist_fn

        return dist_fn.all_reduce(x, group=self.group)

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj):
        """Rank 0's obj on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def init(rank: int, world_size: int, backend: str, init_method: str) -> DataParallel:
    """Join the default process group (`backend` "nccl" or "gloo",
    `init_method` e.g. tcp://localhost:<port>)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return DataParallel(rank, world_size)


def from_env(backend: str) -> DataParallel | None:
    """Join the group that torchrun (or another launcher) describes in
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, where it does; None where
    those are not set."""
    if "RANK" not in os.environ or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return DataParallel(dist.get_rank(), dist.get_world_size())


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, world_size: int, args=()) -> None:
    """fn(rank, *args) in world_size new processes; raises if one fails."""
    import torch.multiprocessing as mp

    mp.spawn(fn, args=tuple(args), nprocs=world_size, join=True)


def round_rays(dm_config, world_size: int):
    """Fit the global ray budgets to the ranks: each rounded down to a
    multiple of world_size, and each rank samples 1/world_size of it
    (dm_config.num_hosts). A deblur pixel's 4 rays and an event ray's prev
    and next render stay on the rank that sampled the pixel."""
    for name in ("train_num_col_rays_per_batch", "train_num_evs_rays_per_batch"):
        setattr(dm_config, name, getattr(dm_config, name) - getattr(dm_config, name) % world_size)
    dm_config.num_hosts = world_size
    return dm_config


def shard_batch(batch: dict, rank: int, world_size: int) -> dict:
    """Rank `rank`'s contiguous share of each per-ray array of a global
    batch (numpy or tensors; each array's rows split evenly)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world_size:
            raise ValueError(f"{k}: {n} rows do not split over {world_size} ranks")
        out[k] = v[n * rank // world_size : n * (rank + 1) // world_size]
    return out


def shard_rays(x, sizes, rank: int, world_size: int):
    """Rank `rank`'s share of per-ray rows laid out as consecutive blocks
    of `sizes` rows (a step's bundles, Trainer.bundle_sizes of the global
    batch): each block's contiguous share, concatenated, which is the
    layout of the rank's own step on its shard_batch."""
    out, start = [], 0
    for n in sizes:
        out.append(x[start + n * rank // world_size : start + n * (rank + 1) // world_size])
        start += n
    return torch.cat(out)
