"""LPIPS with the AlexNet trunk (port of `udifftext_tpu/models/lpips.py`,
NCHW): the perceptual distance of `lpips.LPIPS(net='alex')`.

Both images go through lpips' scaling layer and torchvision AlexNet's
feature convolutions (indices 0, 3, 6, 8, 10), each followed by a ReLU
whose output is a tap; 3×3 stride-2 max-pools follow taps 1 and 2. Each tap
is unit-normalized over channels as x·rsqrt(Σx² + 1e-10) (the JAX form),
the squared difference weighted per channel by `lin{i}`, averaged over
space and summed over the five taps.

Parameter names are lpips' (`net.slice1.0.weight`, `net.slice2.3.bias`, …,
`lin0.model.1.weight`, `scaling_layer.shift`), so an `lpips.LPIPS(net=
'alex')` state dict loads without a converter; `lpips_alex_state_dict`
also takes the lpips package's lin-only file with torchvision's AlexNet
`features.I.*` weights beside it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .layers import lecun_normal_

# torchvision AlexNet features: (index, in, out, kernel, stride, padding)
ALEX_CONVS = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1),
              (8, 384, 256, 3, 1, 1), (10, 256, 256, 3, 1, 1))
SLICES = ((0, 2), (2, 5), (5, 8), (8, 10), (10, 12))  # lpips' slice1..slice5 of features


def slice_key(index: int) -> str:
    """lpips' module path of torchvision AlexNet's `features.<index>`."""
    k = next(k for k, (lo, hi) in enumerate(SLICES, 1) if lo <= index < hi)
    return f"net.slice{k}.{index}"


class ScalingLayer(nn.Module):
    """lpips' input normalization of RGB in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift) / self.scale


class AlexSlices(nn.Module):
    """torchvision AlexNet's features cut as lpips cuts them: sliceK holds
    the layers of its index range under their torchvision indices; each
    slice ends in a ReLU whose output is a tap."""

    def __init__(self):
        super().__init__()
        layers: Dict[int, nn.Module] = {}
        for idx, cin, cout, k, s, p in ALEX_CONVS:
            layers[idx] = nn.Conv2d(cin, cout, k, s, p)
            lecun_normal_(layers[idx].weight)
            nn.init.zeros_(layers[idx].bias)
            layers[idx + 1] = nn.ReLU()
        layers[2] = nn.MaxPool2d(3, 2)
        layers[5] = nn.MaxPool2d(3, 2)
        for k, (lo, hi) in enumerate(SLICES, 1):
            sl = nn.Sequential()
            for i in range(lo, hi):
                sl.add_module(str(i), layers[i])
            setattr(self, f"slice{k}", sl)

    def forward(self, x: torch.Tensor):
        taps = []
        for k in range(1, len(SLICES) + 1):
            x = getattr(self, f"slice{k}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """lpips' per-channel weighting, a bias-free 1×1 conv to one channel
    (`model.1.weight`, (1, C, 1, 1); lpips' dropout at `model.0` is off at
    evaluation), applied as a weighted channel sum."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bchw,c->bhw", d, self.model[1].weight.view(-1))


class LPIPSAlex(nn.Module):
    """(B, 3, H, W) pairs in [-1, 1] → (B,) perceptual distances."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = AlexSlices()
        for i, conv in enumerate(ALEX_CONVS):
            setattr(self, f"lin{i}", NetLinLayer(conv[2]))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx, fy = self.net(self.scaling_layer(x)), self.net(self.scaling_layer(y))
        total = 0.0
        for i, (tx, ty) in enumerate(zip(fx, fy)):
            nx = tx * torch.rsqrt(tx.square().sum(1, keepdim=True) + 1e-10)
            ny = ty * torch.rsqrt(ty.square().sum(1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((nx - ny).square()).mean(dim=(1, 2))
        return total


def lpips_alex_state_dict(sd: Dict[str, torch.Tensor],
                          alexnet_sd: Optional[Dict[str, torch.Tensor]] = None
                          ) -> Dict[str, torch.Tensor]:
    """`LPIPSAlex`'s state dict from either layout the JAX package's
    `convert_lpips_alex` takes: a full `lpips.LPIPS(net='alex')` dump
    (`net.sliceK.I.*`, `linK.model.1.weight`, `scaling_layer.*`), or lpips'
    lin-only weights with torchvision AlexNet's `features.I.*` in
    `alexnet_sd` (its classifier dropped). The scaling layer's constants are
    the module's own where the file has none."""
    out = {f"scaling_layer.{k}": v for k, v in ScalingLayer().state_dict().items()}
    out.update(sd)
    for key, v in (alexnet_sd or {}).items():
        parts = key.split(".")
        if parts[0] == "features" and int(parts[1]) < SLICES[-1][1]:
            out[f"{slice_key(int(parts[1]))}.{parts[2]}"] = v
    return out
