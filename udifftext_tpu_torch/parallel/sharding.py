"""Megatron-style tensor parallelism of the UNet's transformer blocks (the
port's counterpart of `udifftext_tpu/parallel/sharding.py`).

The JAX package states the rules as GSPMD shardings of the parameter tree;
here each process of a tensor group holds its shard of the weights and runs
its share of the heads and hidden units, and two autograd Functions over the
group (Megatron's f and g) put the results together:

- column-parallel: the attention projections `to_q`, `to_k`, `to_v` and the
  GEGLU input projection `ff.net.0.proj` shard dim 0 of the torch weight
  (their output features); each rank computes its heads / hidden units from
  the whole input, which enters through f (identity forward, all-reduce of
  the input's gradient backward);
- row-parallel: `to_out.0` and `ff.net.2` shard dim 1 (their input
  features); each rank's product is a partial sum, which g adds up over the
  group (all-reduce forward, identity backward). A row-parallel bias is
  added once: rank 0's partial carries its value, and every rank's carries
  its gradient (`once`), so the replicated bias gets the same gradient on
  every rank.

Attention is sharded by whole heads: a module whose head count the tensor
degree does not divide stays whole on every rank (`tp_plan(...).whole`,
`tp_report`). At full width with 2 ranks that is the five-head ds1 layers;
the JAX rules shard those kernels by features and GSPMD reshards them.
Every feed-forward shards (I = 1280 / 2560 / 5120 at ds1 / ds2 / ds4).

The GEGLU projection's output rows are [h | g], 2·I of them; rank t's shard
is [h_t | g_t] (rows t·I/n .. (t+1)·I/n of each half), so that the kernel's
convention of g at offset I holds on every rank with I/n in place of I. A
contiguous split would hand rank 0 all of h.

The t_attn maps a sharded layer captures hold the rank's heads only, while
the losses (`diffusion/loss.py`) average every head of a layer: the engine's
network hands them `TensorParallel.head_mean_maps`, each sharded layer's
head sum added up over the group (g) and divided by its total head count,
as one (B, 1, N, L) map whose own mean over heads is that mean.

Checkpoints and `utils/convert.unet_from_jax` keep the whole layout:
`shard_state_dict` cuts a state dict for one rank and `gather_state_dict`
puts the ranks' shards back together, bit for bit. The partial sums are
added in the compute dtype, one rounding of that dtype more per
row-parallel product than the unsharded model (bf16 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _CopyToTensorParallel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient all-reduced backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTensorParallel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor_parallel(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _CopyToTensorParallel.apply(x, group)


def reduce_from_tensor_parallel(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _ReduceFromTensorParallel.apply(x, group)


@dataclasses.dataclass(eq=False)
class TensorParallel:
    """A tensor group as the sharded modules see it: the group, this
    process's index in it, and the total head count of each
    sharded t_attn map (keyed as the UNet keys its captured maps)."""

    group: Any
    rank: int
    map_heads: Dict[str, int] = dataclasses.field(default_factory=dict)

    def once(self, bias: torch.Tensor) -> torch.Tensor:
        """A row-parallel bias for this rank's partial sum: its value on
        rank 0, zero (its value minus itself, exactly) elsewhere, its
        gradient on every rank."""
        return bias if self.rank == 0 else bias - bias.detach()

    def row_parallel(self, y: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor = None) -> torch.Tensor:
        """The row-parallel product y·Wᵀ (+ b) summed over the group, in y's
        dtype."""
        b = None if bias is None else self.once(bias.to(y.dtype))
        return reduce_from_tensor_parallel(F.linear(y, weight.to(y.dtype), b), self.group)

    def head_mean_maps(self, maps: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The captured t_attn maps with each sharded layer's (B, heads/n, N,
        L) replaced by the mean over all its heads, (B, 1, N, L): the heads'
        sum added up over the group, over the total head count. The maps of
        layers kept whole are left as they are."""
        return {k: reduce_from_tensor_parallel(v.sum(dim=1, keepdim=True), self.group)
                / self.map_heads[k] if k in self.map_heads else v for k, v in maps.items()}


class Rule(NamedTuple):
    """How one parameter shards: along `dim`; `geglu` splits each half of
    dim 0 ([h | g]) separately."""

    dim: int
    geglu: bool = False


@dataclasses.dataclass
class TPPlan:
    """The parameters that shard (name → Rule) and the modules kept whole
    (attention whose heads, or a feed-forward whose hidden units, the degree
    does not divide), for `n_tensor` ranks."""

    n_tensor: int
    rules: Dict[str, Rule]
    whole: List[str]


def _attention_modules(model: nn.Module):
    from ..models.attention import CrossAttention, GEGLUFeedForward, SelfAttention

    for name, m in model.named_modules():
        if isinstance(m, (SelfAttention, CrossAttention)):
            yield name, m, "attn"
        elif isinstance(m, GEGLUFeedForward):
            yield name, m, "ff"


def tp_plan(model: nn.Module, n_tensor: int) -> TPPlan:
    """The sharding of `model`'s transformer blocks over n_tensor ranks,
    with state-dict names as `model.state_dict()` has them."""
    rules: Dict[str, Rule] = {}
    whole: List[str] = []
    p = lambda name, leaf: f"{name}.{leaf}" if name else leaf  # noqa: E731
    for name, m, kind in _attention_modules(model):
        if kind == "attn":
            if m.heads % n_tensor:
                whole.append(name)
                continue
            for proj in ("to_q", "to_k", "to_v"):
                rules[p(name, f"{proj}.weight")] = Rule(0)
            rules[p(name, "to_out.0.weight")] = Rule(1)
        else:
            inner = m.net[2].weight.shape[1]
            if inner % n_tensor:
                whole.append(name)
                continue
            rules[p(name, "net.0.proj.weight")] = Rule(0, geglu=True)
            rules[p(name, "net.0.proj.bias")] = Rule(0, geglu=True)
            rules[p(name, "net.2.weight")] = Rule(1)
    return TPPlan(n_tensor, rules, whole)


def tp_report(model: nn.Module, n_tensor: int) -> List[str]:
    """The attention and feed-forward modules that stay whole on every rank."""
    return tp_plan(model, n_tensor).whole


def shard_tensor(t: torch.Tensor, rule: Rule, rank: int, n_tensor: int) -> torch.Tensor:
    """Rank `rank`'s shard of `t` (a contiguous copy)."""
    if rule.geglu:
        h, g = t.chunk(2, dim=0)
        return torch.cat([h.chunk(n_tensor, dim=0)[rank], g.chunk(n_tensor, dim=0)[rank]])
    return t.chunk(n_tensor, dim=rule.dim)[rank].contiguous()


def gather_tensor(parts: Sequence[torch.Tensor], rule: Rule) -> torch.Tensor:
    """The whole tensor of every rank's shard, in rank order."""
    if rule.geglu:
        halves = [p.chunk(2, dim=0) for p in parts]
        return torch.cat([h for h, _ in halves] + [g for _, g in halves])
    return torch.cat(list(parts), dim=rule.dim)


def shard_state_dict(sd: Mapping[str, torch.Tensor], t: int, n_tensor: int,
                     plan: TPPlan) -> Dict[str, torch.Tensor]:
    """Rank t's state dict of a whole one: the planned parameters cut,
    everything else as it is."""
    return {k: shard_tensor(v, plan.rules[k], t, n_tensor) if k in plan.rules else v
            for k, v in sd.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                      plan: TPPlan) -> Dict[str, torch.Tensor]:
    """The whole state dict of every rank's (in rank order); the replicated
    entries are rank 0's."""
    return {k: gather_tensor([s[k] for s in shards], plan.rules[k]) if k in plan.rules else v
            for k, v in shards[0].items()}


def shard_model_(model: nn.Module, group: Any) -> TPPlan:
    """Shard `model`'s transformer blocks in place over the tensor group
    `group` (this process keeps its shard of every planned parameter, as a
    new Parameter with the old one's requires_grad), and give each sharded
    module, and each UNet, the `TensorParallel` it runs with. Call it after
    the weights are loaded and before the optimizer is made. Returns the
    plan."""
    from ..models.unet import UNetModel

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    plan = tp_plan(model, n)
    tp = TensorParallel(group, rank)
    whole = set(plan.whole)
    for name, m, kind in _attention_modules(model):
        if name in whole:
            continue
        if kind == "attn" and (getattr(m, "fuse_qkv", False)):
            raise NotImplementedError(f"{name}: tensor parallelism runs the unfused q/k/v "
                                      "projections only")
        m.tp = tp
        if kind == "attn":
            m.heads //= n
    for pname, rule in plan.rules.items():
        mod_name, leaf = pname.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        old = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(shard_tensor(old.detach(), rule, rank, n),
                                        requires_grad=old.requires_grad))
    for name, m in model.named_modules():
        if isinstance(m, UNetModel):
            prefix = f"{name}." if name else ""
            m.tp = tp
            for key, module_path, heads in m.map_layers():
                if f"{prefix}{module_path}" not in whole:
                    tp.map_heads[key] = heads
    return plan
