"""ResBlock composition probe (port of `scripts/resblock_probe.py`).

    python -m udifftext_tpu_torch.scripts.resblock_probe [batch=32] [channels=320] [--device cpu]

Times, at the ds1 shape of the shipped graph (CFG-doubled batch 32, 64×64,
320 channels, bf16), how much of a ResBlock is its two 3×3 convolutions and
how much the GroupNorm+SiLU glue around them, with the glue eager (the port's
`GroupNorm32.plain` then `F.silu`, what the UNet runs under autograd) and as
the one fused kernel `ops.groupnorm.fused_groupnorm_silu` (what `GroupNorm32`
runs on the card without autograd):

  2x conv3x3 only
  ResBlock: GN+SiLU → conv → +emb → GN+SiLU → conv → +x, eager glue
  the same with the fused kernel
  GN+SiLU alone, eager and fused
  max |eager − fused| of the glue's output

The convolutions stay cuDNN (`F.conv2d` on the NHWC view, as
`models/layers.py` runs them). Inputs come from numpy's `RandomState(0)`, as
in the JAX script. Each time is CUDA events around K back-to-back calls,
divided by K, the median of several such runs (on the CPU: the host clock,
for checking the script, not a device time). `run` returns {label: ms}, the
last label holding the difference instead of a time, and prints one line per
label.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import GroupNorm32
from ..ops.groupnorm import fused_groupnorm_silu
from ._timing import probe_device, time_ms

DIFF_LABEL = "max |eager - fused| GN+SiLU"


@torch.no_grad()
def run(batch: int = 32, channels: int = 320, hw: int = 64, reps: int = 20, runs: int = 5,
        device: str = "cuda", dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The probe on a (batch, hw, hw, channels) activation; returns {label: ms}
    plus the glue's eager-fused difference under `DIFF_LABEL`."""
    dev = probe_device("resblock_probe", device)
    clock = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU host clock"
    b, c = batch, channels
    rng = np.random.RandomState(0)

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    x = tensor(rng.randn(b, hw, hw, c) * 0.5)
    # HWIO, as the JAX script draws them → PyTorch's OIHW
    w1, w2 = (tensor(rng.randn(3, 3, c, c) * 0.02).permute(3, 2, 0, 1).contiguous()
              for _ in range(2))
    emb = tensor(rng.randn(b, c) * 0.5)
    gn = GroupNorm32(c).to(dev)  # scale 1, bias 0, fp32: the JAX script's gscale, gbias
    gscale, gbias = gn.weight.detach(), gn.bias.detach()
    results: Dict[str, float] = {}
    print(f"== ResBlock at (B={b}, {hw}x{hw}, C={c}), {dtype}, {clock} ==", flush=True)

    def timed(label: str, fn: Callable[[], object]) -> None:
        ms = results[label] = time_ms(fn, reps, runs, dev)
        print(f"{label:52s} {ms:9.3f} ms", flush=True)

    def conv(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return F.conv2d(h.permute(0, 3, 1, 2), w, None, 1, 1).permute(0, 2, 3, 1)

    def glue_eager(h: torch.Tensor) -> torch.Tensor:
        return gn.plain(h, silu=True)  # the eager path, whatever GroupNorm32's gate would pick

    def glue_fused(h: torch.Tensor) -> torch.Tensor:
        # the wrapper raises unless h is channels-last contiguous, so no hidden copy is timed
        return fused_groupnorm_silu(h, gscale, gbias)

    def resblock(h: torch.Tensor, glue: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        y = conv(glue(h), w1)
        y = y + emb[:, None, None, :]
        return h + conv(glue(y), w2)

    timed("2x conv3x3 only", lambda: conv(conv(x, w1), w2))
    timed("ResBlock, eager GroupNorm32+SiLU", lambda: resblock(x, glue_eager))
    timed("ResBlock, fused GN+SiLU kernel", lambda: resblock(x, glue_fused))
    timed("GN32+SiLU alone, eager", lambda: glue_eager(x))
    timed("GN32+SiLU alone, fused kernel", lambda: glue_fused(x))
    diff = float((glue_eager(x).float() - glue_fused(x).float()).abs().max())
    results[DIFF_LABEL] = diff
    print(f"{DIFF_LABEL}: {diff:.4f}", flush=True)
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=32, help="samples (CFG-doubled)")
    p.add_argument("channels", nargs="?", type=int, default=320)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("resblock_probe: no CUDA device found; pass --device cpu to check the "
                         "script on the CPU")
    run(args.batch, args.channels, device=args.device)


if __name__ == "__main__":
    main()
