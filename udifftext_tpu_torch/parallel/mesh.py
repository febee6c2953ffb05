"""Process groups over data × tensor (the port's counterpart of
`udifftext_tpu/parallel/mesh.py`'s `(data, tensor)` mesh).

One process per card, as torchrun starts them. The world's ranks are laid out
as the JAX mesh lays out its devices, `reshape(n_data, n_tensor)`: rank
d·n_tensor + t sits at data index d and tensor index t. A data group holds the
ranks of one tensor index (they hold the same shards and average their
gradients); a tensor group holds the ranks of one data index (they split the
UNet's transformer weights, `parallel/sharding.py`, and see the same rows).

`multihost.make_global_batch` has no counterpart: the port's loader already
hands each process its own rows (`data.loader.get_dataloader`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch.distributed as dist

from .dist import group_timeout


class ProcessGrid(NamedTuple):
    """This process's place in the grid: its data group and tensor group,
    and its index in each."""

    data: Any
    tensor: Any
    data_rank: int
    tensor_rank: int


def make_groups(n_data: int, n_tensor: int = 1) -> ProcessGrid:
    """The data and tensor groups of this process over a world of n_data ·
    n_tensor processes (every process must call it, in the same order as
    every other collective). Each group has the finite timeout of
    `dist.group_timeout`, so that a dead rank fails the run."""
    if not dist.is_initialized():
        raise RuntimeError("make_groups needs a process group (torchrun, or "
                           "dist.maybe_init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data < 1 or n_tensor < 1 or n_data * n_tensor != world:
        raise ValueError(f"a {n_data} × {n_tensor} grid needs {n_data * n_tensor} processes, "
                         f"the world has {world}")
    d, t = divmod(rank, n_tensor)
    data = tensor = None
    timeout = group_timeout()
    # every process creates every group, in one order
    for t_ in range(n_tensor):
        g = dist.new_group([d_ * n_tensor + t_ for d_ in range(n_data)], timeout=timeout)
        if t_ == t:
            data = g
    for d_ in range(n_data):
        g = dist.new_group([d_ * n_tensor + t_ for t_ in range(n_tensor)], timeout=timeout)
        if d_ == d:
            tensor = g
    return ProcessGrid(data, tensor, d, t)
