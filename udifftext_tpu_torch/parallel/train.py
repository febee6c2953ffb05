"""The fine-tuning step (port of `udifftext_tpu/parallel/train.py`; its
`data` mesh is one process per card, `parallel/dist.py`).

  - Selective trainability: only UNet parameters whose name has a segment
    containing one of `opt_keys` (t_attn, t_norm) train, and the parameters
    of the conditioner embedders marked is_trainable; `build_engine(...,
    train=True)` marks them (requires_grad) and keeps them in fp32. Frozen
    parameters get no gradient, no optimizer state and no update.
  - AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01) with the LR set
    before every update from the per-epoch ×0.95 schedule at the
    optimizer-step count, as optax reads its schedule.
  - Gradient accumulation: one backward per micro-batch summed into .grad,
    divided by the micro-batch count before the update.
  - Data parallelism: under a process group, after the accumulation loop
    the trainable gradients are averaged over the processes (one bucketed
    all-reduce, `dist.all_reduce_mean_`), and so are the returned loss and
    components, so every process logs the global mean.
  - Tensor parallelism (`parallel/sharding.shard_model_` over the tensor
    groups of `parallel/mesh.make_groups`): the model holds its shards and
    its f/g collectives, so the step is the same; the gradient mean runs
    over `data_group` only. A replicated parameter gets the same gradient on
    every rank of a tensor group (f all-reduces the gradient of every
    sharded module's input), the optimizer state and the EMA of a sharded
    parameter are its shard's. The train CLI builds no tensor groups, as the
    JAX `train.py` builds a data-only mesh: tensor parallelism is reached
    through this API, as the JAX `make_train_step(state_sharding_tree=...)`.
  - Spans (`utils.profiling`): `train.step` (key: the optimizer-step
    count) holding `loss.forward` and `loss.backward` for each micro-batch
    and `train.optimizer` (the mean over micro-batches, the all-reduce
    under a process group, AdamW and the EMA).
  - EMA of the trainable parameters (LitEma warm-up decay), updated in
    place after each update. The JAX build keeps an EMA of every parameter;
    a frozen one's EMA is the parameter itself, so the port stores none.
  - The other LR schedules of the reference (`sgm/lr_scheduler.py`):
    warm-up then cosine, cosine cycles, warm-up then linear, as plain
    functions of the step.
  - The STR trainer's optimizer (`scripts/str_train.py`, which the JAX
    script composes from optax): `onecycle_cosine_schedule` (optax's
    `cosine_onecycle_schedule`, which is not torch's OneCycleLR),
    `clip_grad_global_norm_` (optax's `clip_by_global_norm`: no epsilon
    beside the norm), `make_str_optimizer` (optax's `adamw` defaults, weight
    decay 1e-4) and `swa_update`, the equal-weight running mean of
    stochastic weight averaging.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.layers import name_has_key
from ..utils import profiling
from . import dist

LossFn = Callable[[Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]

TRAINABLE_TOP = "unet"  # only the UNet trains, as in the reference
EMBEDDERS = "general_conditioner.embedders."  # a GeneralConditioner's embedders


def trainable_mask(named_params: Iterable[Tuple[str, torch.Tensor]],
                   opt_keys: Sequence[str],
                   trainable_embedders: Sequence[str] = ()) -> Dict[str, bool]:
    """name → True where the top-level module is the UNet and a segment of
    the dotted name contains one of `opt_keys`, and for every parameter of
    the conditioner embedders named in `trainable_embedders`
    ("<index>_<target>", the embedders with is_trainable)."""
    indices = {name.split("_", 1)[0] for name in trainable_embedders}

    def trains(name: str) -> bool:
        if name.startswith(EMBEDDERS):
            return name[len(EMBEDDERS):].split(".", 1)[0] in indices
        return name.split(".")[0] == TRAINABLE_TOP and name_has_key(name, opt_keys)

    return {name: trains(name) for name, _ in named_params}


def epoch_decay_schedule(base_lr: float, steps_per_epoch: int,
                         decay: float = 0.95) -> Callable[[int], float]:
    """lr(step) = base_lr · decay^(step // steps_per_epoch)."""

    def schedule(step: int) -> float:
        return base_lr * decay ** (step // max(steps_per_epoch, 1))

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           lr_min: float = 0.0, lr_start: float = 0.0) -> Callable[[int], float]:
    """LambdaWarmUpCosineScheduler: linear warm-up from lr_start to base_lr,
    then cosine decay to lr_min at total_steps."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr_start + (base_lr - lr_start) * step / max(warmup_steps, 1)
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return lr_min + 0.5 * (base_lr - lr_min) * (1.0 + math.cos(math.pi * t))

    return schedule


def warmup_cosine_cycles_schedule(warm_up_steps: Sequence[int], f_min: Sequence[float],
                                  f_max: Sequence[float], f_start: Sequence[float],
                                  cycle_lengths: Sequence[int],
                                  linear: bool = False) -> Callable[[int], float]:
    """LambdaWarmUpCosineScheduler2 / LambdaLinearScheduler: cycles of the
    given lengths, each a linear warm-up from f_start to f_max then a cosine
    (or linear) decay to f_min; an LR multiplier (use with base LR 1.0).
    Past the last cycle, the last cycle's decay goes on."""
    cum = [0]
    for n in cycle_lengths:
        cum.append(cum[-1] + n)

    def schedule(step: int) -> float:
        cycle = min(bisect.bisect_left(cum[1:], step), len(cycle_lengths) - 1)
        n = step - cum[cycle]
        w, lo, hi, st, ln = (warm_up_steps[cycle], f_min[cycle], f_max[cycle], f_start[cycle],
                             cycle_lengths[cycle])
        if n < w:
            return (hi - st) / max(w, 1.0) * n + st
        if linear:
            return lo + (hi - lo) * (ln - n) / ln
        t = min((n - w) / max(ln - w, 1.0), 1.0)
        return lo + 0.5 * (hi - lo) * (1.0 + math.cos(t * math.pi))

    return schedule


def warmup_linear_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           lr_min: float = 0.0, lr_start: float = 0.0) -> Callable[[int], float]:
    """Linear warm-up from lr_start to base_lr, then linear decay to lr_min
    at total_steps."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr_start + (base_lr - lr_start) * step / max(warmup_steps, 1)
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return base_lr + (lr_min - base_lr) * t

    return schedule


def onecycle_cosine_schedule(total_steps: int, peak_lr: float,
                             pct_start: float = 0.3) -> Callable[[int], float]:
    """optax.cosine_onecycle_schedule at its defaults as a function of the
    step: a cosine from peak_lr / 25 up to peak_lr over [0, int(pct_start ·
    T)), then a cosine down to peak_lr / 25 / 1e4 over [int(pct_start · T),
    T), that value from T on. Where the warm-up has no step (int(pct_start ·
    T) = 0) it starts at the peak (optax's value there is NaN)."""
    if total_steps <= 0:
        raise ValueError(f"onecycle schedule over {total_steps} steps")
    init = peak_lr / 25.0
    final = init / 1e4
    peak_at = int(pct_start * total_steps)
    segments = [(0, peak_at, init, peak_lr), (peak_at, int(total_steps), peak_lr, final)]

    def schedule(step: int) -> float:
        for lo, hi, start, end in segments:
            if lo <= step < hi:
                pct = (step - lo) / (hi - lo)
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return final

    return schedule


@torch.no_grad()
def clip_grad_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: where the global norm is at least
    `max_norm`, every gradient becomes (g / norm) · max_norm. Returns the
    norm (on the device: nothing here waits for it)."""
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def make_str_optimizer(params: Iterable[torch.Tensor], lr: float) -> torch.optim.AdamW:
    """optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay
    1e-4); the caller sets each group's lr before every step."""
    return torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


@torch.no_grad()
def swa_update(avg: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               n_avg: int) -> Dict[str, torch.Tensor]:
    """Stochastic weight averaging in place: avg ← avg + (p − avg) / (n_avg + 1),
    the equal-weight mean of the n_avg snapshots already in `avg` and this
    one. The first snapshot is a clone of the parameters (`swa_start`): an
    average that aliased them would follow the optimizer's in-place updates."""
    w = 1.0 / (n_avg + 1.0)
    for name, a in avg.items():
        a.add_((params[name].detach() - a) * w)
    return avg


@torch.no_grad()
def swa_start(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The average of one snapshot: a copy of each parameter."""
    return {name: p.detach().clone() for name, p in params.items()}


def make_optimizer(params: Iterable[torch.Tensor], base_lr: float = 5e-5) -> torch.optim.AdamW:
    """AdamW over the given (trainable) parameters only."""
    return torch.optim.AdamW(list(params), lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], step: int,
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """In place: ema ← ema·d + p·(1 − d), d = min(decay, (1 + step)/(10 + step))."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    for name, e in ema.items():
        e.mul_(d).add_(params[name].detach() * (1.0 - d))
    return ema


@dataclasses.dataclass
class TrainState:
    """The trainable parameters by name, their optimizer and LR schedule,
    the optimizer-step count and the EMA (None without EMA)."""

    params: Dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, base_lr: float = 5e-5, steps_per_epoch: int = 1000,
               use_ema: bool = False) -> "TrainState":
        """State over `model`'s parameters that require grad."""
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        ema = {n: p.detach().clone() for n, p in params.items()} if use_ema else None
        return cls(params, make_optimizer(params.values(), base_lr),
                   epoch_decay_schedule(base_lr, steps_per_epoch), 0, ema)


def train_step(state: TrainState, micro_batches: Sequence[Any], loss_fn: LossFn,
               ema_decay: float = 0.9999,
               data_group: Any = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimizer update from len(micro_batches) micro-batches: the
    gradients averaged over them (and over the processes of `data_group`,
    the whole process group for None), one AdamW update, then the EMA.
    Returns the loss and each aux component averaged likewise (detached, on
    the device: without a process group nothing here waits for the
    device)."""
    with profiling.span("train.step", state.step):
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        aux_sum: Dict[str, torch.Tensor] = {}
        for mb in micro_batches:
            with profiling.span("loss.forward"):
                loss, aux = loss_fn(mb)
            with profiling.span("loss.backward"):
                loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            for k, v in aux.items():
                aux_sum[k] = v.detach() if k not in aux_sum else aux_sum[k] + v.detach()
        n = len(micro_batches)
        with profiling.span("train.optimizer"):
            for p in state.params.values():
                if p.grad is not None:
                    p.grad.div_(n)
            if dist.is_distributed():
                for p in state.params.values():  # every process reduces the same buffers
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                dist.all_reduce_mean_([p.grad for p in state.params.values()], group=data_group)
                logged = torch.stack([loss_sum] + [aux_sum[k] for k in sorted(aux_sum)]).float()
                dist.all_reduce_mean_([logged], group=data_group)
                loss_sum = logged[0]
                aux_sum = {k: logged[i + 1] for i, k in enumerate(sorted(aux_sum))}
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            if state.ema is not None:
                ema_update(state.ema, state.params, state.step, ema_decay)
        state.step += 1
        return loss_sum / n, {k: v / n for k, v in aux_sum.items()}
