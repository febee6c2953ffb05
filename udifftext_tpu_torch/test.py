"""The evaluation CLI on the port (the flow of the JAX build's root test.py):
inpaint the words of a split, read each generated box with PARSeq for the
OCR sequence accuracy, and write real / fake / grid PNGs.

    python -m udifftext_tpu_torch.test [--config ./configs/test.yaml] [--device cpu]
    torchrun --nproc_per_node N -m udifftext_tpu_torch.test   # eval_data_parallel: True

`test(bundle, sampler, dataloader, cfgs)` wipes `output_dir` and
`temp_dir`, then for each of the first `max_iter` batches: samples with the
init-noise search, CFG and `steps` Euler steps (`make_predictor`); with
`ocr_enabled` and a PARSeq checkpoint, reads each sample's `r_bbox` crop
and prints the expected and read words; writes real/<name>.png,
fake/<name>.png and the grid <name>.png (image, masked, mask, sample
stacked); with `aae_enabled`, prints the per-step local losses and writes
temp/inters/<name>.gif; with `detailed`, writes the middle step's
attention-map grid and temp/seg_map/seg_<name>.npy. Then it prints the mean
OCR accuracy. With `quan_test`, it then prints the FID and the LPIPS score
of fake/ against real/ (`metrics.calc_fid`, `calc_lpips`, on the engine's
device; without the metrics' weights files each prints why it is skipped).
PNGs go through `utils/png.py` (no Pillow needed); the GIF and the map grid
need imageio and matplotlib/seaborn. The seed is drawn at random and
printed; one generator serves every batch.

With `eval_data_parallel`, the run is one process per card under torchrun:
the loader gives each process its share of the split, rank 0 alone wipes
the output directories, and the OCR counts are summed over the processes
before the mean is printed; rank 0 alone computes FID and LPIPS, over every
process's files. Without a process group it raises.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import time
from os.path import join as ospj
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .builders import EngineBundle, SamplerSettings
from .ocr import ParseqPredictor
from .parallel import dist
from .predict import Predictor
from .util import prepare_batch
from .utils.encprop_gate import ckpt_id_if_encprop
from .utils.png import write_png


def load_predictor(cfgs: Mapping[str, Any],
                   device: torch.device | str = "cuda") -> Optional[ParseqPredictor]:
    """PARSeq-base from `predictor_config.params.ckpt_path` (strhub's keys),
    frozen in fp32 on `device`; None, with the JAX build's message, when the
    file is missing."""
    from .models.parseq import PARSeq
    from .utils.ckpt import load_state_dict, merge_state_dict

    ckpt = ((cfgs.get("predictor_config", {}) or {}).get("params", {}) or {}).get("ckpt_path")
    if not (ckpt and os.path.exists(str(ckpt))):
        print(f"[parseq] checkpoint {ckpt} not found — OCR eval disabled")
        return None
    with torch.device(device):
        model = PARSeq()
    merge_state_dict(model, load_state_dict(str(ckpt)), "parseq", verbose=False)
    print(f"[parseq] loaded {ckpt}")
    return ParseqPredictor(model.requires_grad_(False).eval())


def make_predictor(cfgs: Mapping[str, Any], bundle: EngineBundle,
                   sampler: SamplerSettings) -> Predictor:
    """The sampler of the run config: search candidates `noise_iters`
    (default 10; batched only with `noise_search_batched`), attend-and-excite
    and map capture per `aae_enabled` / `detailed`, encoder-propagation
    sampling per `encprop_interval`, gated on the quality report of
    `load_ckpt_path`'s checkpoint."""
    return Predictor(
        bundle.engine,
        num_steps=sampler.num_steps,
        cfg_scale=sampler.cfg_scale,
        noise_iters=int(cfgs.get("noise_iters", 10)),
        aae_enabled=bool(cfgs.get("aae_enabled", False)),
        detailed=bool(cfgs.get("detailed", False)),
        encprop_interval=int(cfgs.get("encprop_interval", 0)),
        ckpt_id=ckpt_id_if_encprop(cfgs),
        noise_search_batched=bool(cfgs.get("noise_search_batched", False)),
    )


def predict(cfgs: Mapping[str, Any], predictor: Predictor, batch: Mapping[str, Any],
            generator: Optional[torch.Generator] = None) -> Tuple[np.ndarray, Dict[str, Any]]:
    """(images (B, H, W, 3) float32 in [0, 1] on the host, aux) of one
    batch."""
    batch, _batch_uc = prepare_batch(cfgs, batch, predictor.engine.device)
    images, aux = predictor(batch, generator)
    return images.float().cpu().numpy(), aux


def _grid_rows(batch: Mapping[str, Any], fake: np.ndarray) -> list:
    """uint8 rows of the grid: image, masked, mask (each batch side by side,
    [-1, 1] or {0, 1} scaled to 0..255), then the samples."""
    rows = []
    for key in ("image", "masked", "mask"):
        if key in batch:
            arr = np.asarray(batch[key], np.float32)
            if key != "mask":
                arr = (arr + 1.0) / 2.0
            arr = np.concatenate(arr * 255, axis=-2)
            if key == "mask":
                arr = np.tile(arr, (1, 1, 3))
            rows.append(arr.astype(np.uint8))
    return rows + [fake]


def test(bundle: EngineBundle, sampler: SamplerSettings, dataloader, cfgs: Mapping[str, Any],
         seed: Optional[int] = None) -> Dict[str, Any]:
    """Run the evaluation; returns {"correct", "total" (OCR counts over
    every process; 0 without OCR), "seconds" (this process's seconds per
    batch, sampling to written files), "names"}, and with `quan_test` on
    rank 0 "fid" and "lpips" (None where skipped)."""
    rank, _ = dist.rank_and_world()
    if cfgs.get("eval_data_parallel") and not dist.is_distributed():
        raise RuntimeError("eval_data_parallel: run one process per card: torchrun "
                           "--nproc_per_node <cards> -m udifftext_tpu_torch.test --config <yaml>")
    output_dir = str(cfgs.get("output_dir", "./outputs"))
    temp_dir = str(cfgs.get("temp_dir", "./temp"))
    if rank == 0:  # stale PNGs from an earlier run would join this one's
        shutil.rmtree(output_dir, ignore_errors=True)
        shutil.rmtree(temp_dir, ignore_errors=True)
        for sub in ("real", "fake"):
            os.makedirs(ospj(output_dir, sub), exist_ok=True)
        for sub in ("attn_map", "seg_map", "inters"):
            os.makedirs(ospj(temp_dir, sub), exist_ok=True)
    if dist.is_distributed():
        torch.distributed.barrier()

    engine = bundle.engine
    dev = engine.device
    ocr = load_predictor(cfgs, dev) if cfgs.get("ocr_enabled", False) else None
    correct_num = total_num = 0
    pipeline = make_predictor(cfgs, bundle, sampler)
    seed = random.randint(0, 2**31 - 1) if seed is None else int(seed)
    print(f"seed: {seed}", flush=True)
    gen = torch.Generator(dev).manual_seed(dist.rank_seed(seed, rank))
    seconds, names = [], []
    for idx, batch in enumerate(dataloader):
        if idx >= int(cfgs.get("max_iter", 100)):
            break
        t0 = time.perf_counter()
        name = batch["name"][0]
        results, aux = predict(cfgs, pipeline, batch, gen)

        if "local_losses" in aux:
            from .utils.viz import save_intermediates_gif

            losses = aux.pop("local_losses").float().cpu().numpy()
            print(f"Local losses: {[round(float(v), 4) for v in losses.mean(axis=-1)]}")
            frames = list(aux.pop("inters").float().cpu().numpy())
            save_intermediates_gif(frames, ospj(temp_dir, "inters", f"{name}.gif"))

        if cfgs.get("detailed"):
            from .utils.viz import average_attn_maps, save_attn_map_grid, save_segment_map

            maps = average_attn_maps({k: v.float().cpu().numpy() for k, v in aux.items()
                                      if k.endswith("t_attn")},
                                     layers=bundle.save_attn_layers or None)
            tokens = batch["label"][0]
            save_attn_map_grid(maps, tokens, ospj(temp_dir, "attn_map", f"attn_map_{name}.png"))
            save_segment_map(maps, tokens, ospj(temp_dir, "seg_map", f"seg_{name}.npy"))

        if ocr is not None:
            crops = [results[i, t:b, l:r]
                     for i, (t, b, l, r) in enumerate(np.asarray(batch["r_bbox"]))]
            pred_txt = ocr.img2txt_ragged(crops)
            gt_txt = list(batch["label"])
            correct = sum(int(p.lower() == g.lower()) for p, g in zip(pred_txt, gt_txt))
            color = "\033[1;32m" if correct == len(gt_txt) else "\033[1;31m"
            print(f"Expected text: {gt_txt}")
            print(f"{color} OCR Result: {pred_txt} \033[0m")
            correct_num += correct
            total_num += len(gt_txt)

        fake = np.concatenate(results * 255, axis=-2).astype(np.uint8)
        rows = _grid_rows(batch, fake)
        write_png(ospj(output_dir, "real", f"{name}.png"), rows[0])
        write_png(ospj(output_dir, "fake", f"{name}.png"), fake)
        write_png(ospj(output_dir, f"{name}.png"), np.concatenate(rows, axis=0))
        seconds.append(time.perf_counter() - t0)
        names.append(name)

    if dist.is_distributed():  # also the point every process's files are written by
        counts = torch.tensor([correct_num, total_num], dtype=torch.int64, device=dev)
        torch.distributed.all_reduce(counts)
        correct_num, total_num = (int(v) for v in counts.tolist())
    if ocr is not None and total_num and rank == 0:
        print(f"OCR test completed. Mean accuracy: {correct_num / total_num}")
    out = {"correct": correct_num, "total": total_num, "seconds": seconds, "names": names}
    if cfgs.get("quan_test") and rank == 0:
        from .metrics import calc_fid, calc_lpips

        fake_dir, real_dir = ospj(output_dir, "fake"), ospj(output_dir, "real")
        out["fid"] = calc_fid(fake_dir, real_dir, device=dev)
        out["lpips"] = calc_lpips(fake_dir, real_dir, device=dev)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Evaluate UDiffText on a split: OCR accuracy and "
                                            "sample images.")
    p.add_argument("--config", default="./configs/test.yaml")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("test: no CUDA device found; run on a machine with a GPU, or pass "
                         "--device cpu to run (slowly) on the CPU")
    from .config import load_config
    from .data.loader import get_dataloader
    from .loading import init_model, init_sampling

    cfgs = load_config(args.config)
    dev = dist.maybe_init_distributed(args.device)
    seed = dist.broadcast_int(random.randint(0, 2**31 - 1), dev)
    bundle = init_model(cfgs, dev, seed=seed)
    test(bundle, init_sampling(cfgs), get_dataloader(cfgs, "val"), cfgs)


if __name__ == "__main__":
    main()
