"""Data parallelism over processes, one per card (the port's counterpart of
`udifftext_tpu/parallel/mesh.py`'s `data` mesh and `multihost.py`).

A run is started by `torchrun --nproc_per_node N`, whose environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) `maybe_init_distributed`
reads: NCCL on the card, gloo on the CPU. Each process loads its share of
the global micro-batch (`data.loader.get_dataloader` divides `batch_size`
by the world size and raises when it does not divide), runs its backward,
and after the accumulation loop `all_reduce_mean_` averages the trainable
gradients in a few flat buckets: one all-reduce per optimizer step, not one
per micro-batch's backward as `DistributedDataParallel` would. Every process
then takes the same AdamW step on the same parameters.

LabelEncoder pretraining's contrastive loss spans the global batch:
`all_gather_rows` gathers every process's rows of a tensor in rank order,
and its backward hands each process its rows of the gradient summed over
the processes. Every process computes the same global loss from the
gathered rows, so the summed gradient of its own rows is W times that
loss's gradient, and the mean that `all_reduce_mean_` then takes of the
parameter gradients is the global loss's gradient.

Every process group has a finite timeout (`TIMEOUT_S`): a collective that a
dead rank never joins fails the run instead of hanging it. `all_reduce_mean_`
takes a `group` (`parallel/mesh.make_groups`); None is the world.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

BUCKET_BYTES = 256 * 2**20  # flat buffer per all-reduce: 75.9 M fp32 gradients go in two
# a collective waits this long for the other ranks: past the first kernel build
# (minutes with a cold nvcc cache), short of a hung run
TIMEOUT_S = 900


def group_timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    return (dist.get_rank(), dist.get_world_size()) if is_distributed() else (0, 1)


def maybe_init_distributed(device: torch.device | str = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes, if any
    and not joined yet (NCCL for a CUDA `device`, gloo otherwise), with the
    process's card set to LOCAL_RANK first. Returns the device this process
    runs on."""
    dev = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not is_distributed():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                                timeout=group_timeout())
        rank, world = rank_and_world()
        print(f"distributed: process {rank}/{world} on {dev}", flush=True)
    return dev


def _buckets(tensors: Sequence[torch.Tensor], cap: int) -> List[List[torch.Tensor]]:
    out: List[List[torch.Tensor]] = [[]]
    size = 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if out[-1] and size + nb > cap:
            out.append([])
            size = 0
        out[-1].append(t)
        size += nb
    return out


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES,
                     group: Any = None) -> None:
    """In place: each tensor ← its mean over `group` (the world for None),
    by one all-reduce of a flat buffer per bucket of one dtype. A no-op
    without a process group or over a group of one."""
    if not is_distributed():
        return
    world = dist.get_world_size(group)
    if world == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same_dtype in by_dtype.values():
        for bucket in _buckets(same_dtype, bucket_bytes):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(world)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = slice(dist.get_rank() * x.shape[0], (dist.get_rank() + 1) * x.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rows]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's x (each of the same shape) concatenated along the
    first axis in rank order, differentiably: the backward returns this
    process's rows of the gradient summed over the processes. `x` itself
    without a process group."""
    return _GatherRows.apply(x) if is_distributed() else x


def broadcast_int(value: int, device: torch.device | str) -> int:
    """Rank 0's `value` on every process (itself without a process group):
    the run's seed, drawn at random by rank 0, so that every rank builds the
    same initial weights."""
    if not is_distributed():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())


def group_src(group: Any = None) -> int:
    """The global rank of `group`'s first process (0 for the world)."""
    return 0 if group is None else dist.get_global_rank(group, 0)


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of `rank` in a run seeded by `seed`: rank 0 keeps
    the run's seed, so a single process draws as before."""
    return (int(seed) + 1_000_003 * int(rank)) % 2**63
