"""PatchGAN discriminator of the VAE's adversarial training (port of
`udifftext_tpu/models/discriminator.py`).

taming's `NLayerDiscriminator` in its own layout, so its state dict keys are
taming's (`main.0.weight`, `main.3.running_var`, …): a stride-2 4×4 conv
and LeakyReLU(0.2), then `n_layers` bias-free 4×4 convs (stride 2, the last
stride 1) each with BatchNorm and LeakyReLU(0.2), then a 1-channel 4×4
conv. Input NHWC, output the NHWC logit map. Init: conv weights N(0, 0.02²)
and BatchNorm scales N(1, 0.02²) (taming's `weights_init`), conv biases and
BatchNorm shifts 0.

BatchNorm is PyTorch's (momentum 0.1, the JAX build's flax momentum 0.9).
Its running variance takes the unbiased batch variance, as taming's does;
the JAX build takes the biased one, n/(n−1) smaller for n = B·H·W per
channel (ROADMAP "Known differences by design"). Training-mode outputs and
the running means are the same.
"""

from __future__ import annotations

import torch
from torch import nn


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        seq = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        nf_prev = 1
        for n in range(1, n_layers + 1):
            nf = min(2 ** n, 8)
            seq += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, stride=2 if n < n_layers else 1,
                              padding=1, bias=False),
                    nn.BatchNorm2d(ndf * nf, eps=1e-5, momentum=0.1), nn.LeakyReLU(0.2)]
            nf_prev = nf
        seq.append(nn.Conv2d(ndf * nf_prev, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*seq)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        for m in self.main:
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, 0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.normal_(m.weight, 1.0, 0.02)
                nn.init.zeros_(m.bias)

    def batchnorms(self):
        return [m for m in self.main if isinstance(m, nn.BatchNorm2d)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
