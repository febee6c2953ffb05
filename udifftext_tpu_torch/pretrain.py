"""LabelEncoder pretraining on the port (the flow of the JAX build's root
pretrain.py): the CLIP-style contrastive objective of the character-level
LabelEncoder against a frozen ViTSTR's features of the rendered string,
plus the character and position CEs (λ 0.1 each).

    python -m udifftext_tpu_torch.pretrain [--config ./configs/pretrain.yaml] [--steps N] [--device cpu]
    torchrun --nproc_per_node N -m udifftext_tpu_torch.pretrain   # one process per card

`build_models(cfgs, device, seed)` builds `LabelEncoderPretrain` and the
frozen `ViTSTREncoder` from the run config's model keys (visual_len =
(size // patch)² + 1), drawing their initial weights from `seed`, and loads
the ViTSTR checkpoint at `visual_config.params.ckpt_path` when it exists.
`make_pretrain_step` is one update: the ViTSTR forward without autograd,
the model's heads, `clip_contrastive_loss` over the global batch (the text
and visual projections gathered from every process), backward, and AdamW
(lr from the config, betas (0.9, 0.999), eps 1e-8, weight decay 1e-4: the
defaults of the JAX build's `optax.adamw(lr)`) over the model's parameters
only.

`train(cfgs, batches)` runs `lightning.max_epochs` epochs over `batches`
(this process's batches: "image" (b, S, S, 1) in [0, 1] and "label_ids"
(b, max_len), as `DataLoader` yields them for a `LabelDataset` or
`data.synthetic.SyntheticLabelBatches` makes them), or `max_steps` steps,
printing `loss`, `cls_acc` and `clip_acc` (means over the processes) every
`log_every` steps, and writing a checkpoint (`utils/train_ckpt.py`: the
model's state dict, AdamW's and the step) under
`<ckpt_dir>/udifftext_tpu_torch` every `check_freq` epochs and when
`max_steps` ends the run. `main` adds the process group, the seed (drawn
at random and printed unless given; rank 0's on every rank) and, unless
batches are passed, the `LabelDataset` loader of the config's `dataset`
keys with `batch_size` split over the processes. Runs on the card unless
`device` is "cpu"; without a card the default fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .diffusion.loss import clip_contrastive_loss
from .models.label_encoder import LabelEncoderPretrain
from .models.vit import ViTSTREncoder, vitstr_features
from .parallel import dist
from .train import CKPT_SUBDIR
from .utils.train_ckpt import save_checkpoint

LOG_KEYS = ("loss/full_loss", "loss/clip_loss", "loss/cls_loss", "loss/pos_loss",
            "acc/clip_acc", "acc/cls_acc", "acc/pos_acc")
StepFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class PretrainState:
    """What a pretraining run carries: the model, the frozen visual encoder,
    AdamW, the step count, and one {"step", "epoch", "seconds" (per step
    since the last log line), LOG_KEYS...} row per log line. `ema` is
    always None (`train_ckpt` stores it)."""

    model: LabelEncoderPretrain
    visual: ViTSTREncoder
    optimizer: torch.optim.AdamW
    step: int = 0
    ema: None = None
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def _model_params(cfgs: Mapping[str, Any]) -> Tuple[Mapping[str, Any], Mapping[str, Any]]:
    mp = cfgs["model"]["params"]
    vis = (mp.get("visual_config", {}) or {}).get("params", {}) or {}
    return mp, vis


def build_models(cfgs: Mapping[str, Any], device: torch.device | str = "cuda",
                 seed: int = 0) -> Tuple[LabelEncoderPretrain, ViTSTREncoder]:
    """(LabelEncoderPretrain, frozen ViTSTREncoder in eval mode) on
    `device`, initial weights drawn from `seed` on that device, and the
    ViTSTR checkpoint loaded when the config names one that exists."""
    from .utils.ckpt import load_state_dict, merge_state_dict

    mp, vis = _model_params(cfgs)
    size, patch = int(vis.get("size", 224)), int(vis.get("patch_size", 16))
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(seed)
        model = LabelEncoderPretrain(
            max_len=int(mp.get("max_len", 12)), emb_dim=int(mp.get("emb_dim", 2048)),
            n_heads=int(mp.get("n_heads", 8)), n_trans_layers=int(mp.get("n_trans_layers", 12)),
            visual_len=(size // patch) ** 2 + 1, visual_dim=int(vis.get("embed_dim", 768)))
        visual = ViTSTREncoder(size=size, patch_size=patch,
                               embed_dim=int(vis.get("embed_dim", 768)),
                               depth=int(vis.get("depth", 12)),
                               num_heads=int(vis.get("num_heads", 12)),
                               in_chans=int(vis.get("in_chans", 1)))
    model.to(dev)  # the position code, a buffer made from numpy, starts on the host
    visual.to(dev)
    ckpt = vis.get("ckpt_path")
    if ckpt and os.path.exists(str(ckpt)):
        merge_state_dict(visual, vitstr_features(load_state_dict(str(ckpt))), "vitstr")
        print(f"[vitstr] loaded {ckpt}")
    return model, visual.requires_grad_(False).eval()


def make_optimizer(model: LabelEncoderPretrain, lr: float) -> torch.optim.AdamW:
    """AdamW over the model's parameters with `optax.adamw(lr)`'s defaults
    (weight decay 1e-4, not the fine-tuning optimizer's 0.01)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_pretrain_step(model: LabelEncoderPretrain, visual: ViTSTREncoder,
                       optimizer: torch.optim.Optimizer, lambda_cls: float = 0.1,
                       lambda_pos: float = 0.1) -> StepFn:
    """step(images (b, S, S, 1), ids (b, max_len)) → (loss, {LOG_KEYS}):
    one AdamW update of `model` on this process's rows of the global batch;
    the loss and entries returned are their means over the processes (the
    contrastive part is the global batch's on every process already)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(images: torch.Tensor, ids: torch.Tensor):
        with torch.no_grad():
            visual_emb = visual(images)
        out = model(ids, visual_emb)
        loss, parts = clip_contrastive_loss(
            dist.all_gather_rows(out["text_out"]), dist.all_gather_rows(out["visual_out"]),
            out["logit_scale"], out["cls_out"], out["pos_out"], ids, lambda_cls, lambda_pos)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dist.all_reduce_mean_([p.grad for p in params if p.grad is not None])
        optimizer.step()
        logged = torch.stack([parts[k].detach() for k in LOG_KEYS])
        dist.all_reduce_mean_([logged])
        return logged[0], dict(zip(LOG_KEYS, logged))

    return step


def train(cfgs: Mapping[str, Any], batches, model: LabelEncoderPretrain, visual: ViTSTREncoder,
          max_steps: Optional[int] = None, log_every: int = 10,
          ckpt_dir: Optional[str] = None) -> PretrainState:
    """Pretrain `model` on `batches` for `lightning.max_epochs` epochs or
    `max_steps` steps; returns the state. Checkpoints go to `ckpt_dir`
    (rank 0 writes them) when it is given."""
    mp, _ = _model_params(cfgs)
    dev = next(model.parameters()).device
    rank, _ = dist.rank_and_world()
    state = PretrainState(model, visual, make_optimizer(model, float(mp.get("lr", 1e-5))))
    step = make_pretrain_step(model, visual, state.optimizer, float(mp.get("lambda_cls", 0.1)),
                              float(mp.get("lambda_pos", 0.1)))
    max_epochs = int((cfgs.get("lightning", {}) or {}).get("max_epochs", 1000))
    check_freq = max(int(cfgs.get("check_freq", 5)), 1)

    def save() -> None:
        if ckpt_dir is not None and rank == 0:
            print(f"saved {save_checkpoint(ckpt_dir, model, state)}", flush=True)

    t0 = time.perf_counter()
    for epoch in range(max_epochs):
        for batch in batches:
            images = torch.as_tensor(np.asarray(batch["image"], np.float32)).to(dev)
            ids = torch.as_tensor(np.asarray(batch["label_ids"])).to(dev)
            _, logged = step(images, ids)
            state.step += 1
            if state.step % log_every == 0:
                row = {k: float(v) for k, v in logged.items()}  # waits for the step
                seconds = (time.perf_counter() - t0) / log_every
                state.history.append({"step": state.step, "epoch": epoch, "seconds": seconds,
                                      **row})
                if rank == 0:
                    print(f"epoch {epoch} step {state.step} loss {row['loss/full_loss']:.4f} "
                          f"cls_acc {row['acc/cls_acc']:.3f} clip_acc {row['acc/clip_acc']:.3f} "
                          f"({seconds:.2f}s/step)", flush=True)
                t0 = time.perf_counter()
            if max_steps is not None and state.step >= max_steps:
                save()
                return state
        if (epoch + 1) % check_freq == 0:
            save()
    return state


def main(cfgs: Mapping[str, Any], batches=None, device: torch.device | str = "cuda",
         seed: Optional[int] = None, max_steps: Optional[int] = None,
         log_every: int = 10) -> PretrainState:
    """A pretraining run of the run config `cfgs` (configs/pretrain.yaml's
    keys); `batches` stands in for the config's `LabelDataset` loader."""
    dev = dist.maybe_init_distributed(device)
    seed = random.randint(0, 2**31 - 1) if seed is None else int(seed)
    seed = dist.broadcast_int(seed, dev)
    if dist.rank_and_world()[0] == 0:
        print(f"seed: {seed}", flush=True)
    model, visual = build_models(cfgs, dev, seed)
    if batches is None:
        batches = label_loader(cfgs, seed)
    ckpt_dir = os.path.join(str(cfgs.get("ckpt_dir", "./checkpoints/encoders/LabelEncoder")),
                            CKPT_SUBDIR)
    return train(cfgs, batches, model, visual, max_steps=max_steps, log_every=log_every,
                 ckpt_dir=ckpt_dir)


def label_loader(cfgs: Mapping[str, Any], seed: int):
    """The `LabelDataset` of the config's `dataset.params` behind a
    `DataLoader` of this process's share of `batch_size` (which the world
    size must divide); needs Pillow and a TTF font."""
    from .data.datasets import LabelDataset
    from .data.loader import DataLoader

    mp, _ = _model_params(cfgs)
    dparams = cfgs["dataset"]["params"]
    rank, world = dist.rank_and_world()
    bsz = int(cfgs.get("batch_size", 256))
    if bsz % world:
        raise ValueError(f"batch_size {bsz} must be divisible by the process count {world}")
    dataset = LabelDataset(size=dparams.get("size", 224), length=dparams.get("length", 100000),
                           font_path=dparams.get("font_path"),
                           min_len=dparams.get("min_len", 1), max_len=dparams.get("max_len", 12),
                           seed=dist.rank_seed(seed, rank))
    return DataLoader(dataset, batch_size=bsz // world, max_label_len=int(mp.get("max_len", 12)),
                      seed=seed, process_index=rank, process_count=world,
                      num_workers=int(cfgs.get("num_workers", 0) or 0))


def cli(argv=None) -> None:
    p = argparse.ArgumentParser(description="Pretrain the LabelEncoder against frozen ViTSTR "
                                            "features.")
    p.add_argument("--config", default="./configs/pretrain.yaml")
    p.add_argument("--steps", type=int, default=None, help="stop after this many steps")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pretrain: no CUDA device found; run on a machine with a GPU, or pass "
                         "--device cpu to run (slowly) on the CPU")
    from .config import load_config

    main(load_config(args.config), device=args.device, max_steps=args.steps)


if __name__ == "__main__":
    cli()
