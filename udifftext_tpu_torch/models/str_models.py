"""ViTSTR, CRNN and the CTC helpers of the scene-text-recognition hub (port
of `udifftext_tpu/models/str_models.py`).

Parameter names are strhub's, so a strhub checkpoint loads by name (after
its `model.` prefix): ViTSTR is timm's VisionTransformer with a class token
and a per-token `head`; CRNN is the clovaai layout (`cnn.conv{i}`,
`cnn.batchnorm{i}` on convs 2, 4 and 6, `rnn.{0,1}.rnn` bidirectional LSTMs
and `rnn.{0,1}.linear`). Images are NHWC; the conv stacks run on an NCHW
view. BatchNorm reads its running statistics once the module is in eval
mode, as the JAX build's always do (`str_hub.create_model` returns eval
modules).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from .layers import Dense
from .vit import ViTEncoder


class ViTSTRSystem(ViTEncoder):
    """ViTSTR: the first max_label_length + 2 ViT tokens through a per-token
    classifier, the class token's slot dropped → (B, max_label_length + 1,
    num_classes) fp32."""

    def __init__(self, max_label_length: int = 25, img_size: Tuple[int, int] = (32, 128),
                 patch_size: Tuple[int, int] = (4, 8), embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, num_classes: int = 95):
        super().__init__(img_size, patch_size, embed_dim, depth, num_heads, class_token=True)
        self.max_label_length = max_label_length
        self.head = Dense(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = super().forward(x)[:, :self.max_label_length + 2]  # [GO] + chars + [s]
        return self.head(feats)[:, 1:].float()


class BiLSTM(nn.Module):
    """strhub's BidirectionalLSTM: a one-layer bidirectional `nn.LSTM` (gates
    i, f, g, o; the flax cell's one hidden bias is torch's two biases'
    sum) and a projection of both directions."""

    def __init__(self, in_size: int, hidden: int, out: int):
        super().__init__()
        self.rnn = nn.LSTM(in_size, hidden, bidirectional=True, batch_first=True)
        self.linear = nn.Linear(2 * hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.rnn.flatten_parameters()
        return self.linear(self.rnn(x)[0])


class CRNN(nn.Module):
    """CRNN: seven convs (BatchNorm on 2, 4, 6), 2×2 pools then two (2, 2)
    pools of stride (2, 1) padded by one column (−inf), two BiLSTMs.
    (B, 32, W, C) → per-frame CTC logits (B, W/4 + 1, num_classes) fp32."""

    def __init__(self, num_classes: int = 95, in_channels: int = 3, hidden: int = 256,
                 leaky_relu: bool = False):
        super().__init__()
        ks, ps = (3, 3, 3, 3, 3, 3, 2), (1, 1, 1, 1, 1, 1, 0)
        nm = (64, 128, 256, 256, 512, 512, 512)
        cnn = nn.Sequential()

        def conv_relu(i: int, batch_norm: bool = False) -> None:
            c_in = in_channels if i == 0 else nm[i - 1]
            cnn.add_module(f"conv{i}", nn.Conv2d(c_in, nm[i], ks[i], 1, ps[i], bias=not batch_norm))
            if batch_norm:
                cnn.add_module(f"batchnorm{i}", nn.BatchNorm2d(nm[i]))
            cnn.add_module(f"relu{i}", nn.LeakyReLU(0.2) if leaky_relu else nn.ReLU())

        conv_relu(0)
        cnn.add_module("pooling0", nn.MaxPool2d(2, 2))
        conv_relu(1)
        cnn.add_module("pooling1", nn.MaxPool2d(2, 2))
        conv_relu(2, True)
        conv_relu(3)
        cnn.add_module("pooling2", nn.MaxPool2d((2, 2), (2, 1), (0, 1)))
        conv_relu(4, True)
        conv_relu(5)
        cnn.add_module("pooling3", nn.MaxPool2d((2, 2), (2, 1), (0, 1)))
        conv_relu(6, True)
        self.cnn = cnn
        self.rnn = nn.Sequential(BiLSTM(512, hidden, hidden), BiLSTM(hidden, hidden, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cnn(x.permute(0, 3, 1, 2))
        # collapse the height (1 after the stack for a 32-pixel input)
        h = h[:, :, 0] if h.shape[2] == 1 else h.mean(dim=2)
        return self.rnn(h.transpose(1, 2)).float()


def ctc_greedy_decode(logits: torch.Tensor) -> torch.Tensor:
    """Best path: each frame's argmax (collapse with `ctc_collapse`)."""
    return logits.argmax(dim=-1)


def ctc_collapse(ids, blank_id: int = 0) -> List[List[int]]:
    """Repeats merged and blanks removed, on the host."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    out = []
    for row in np.asarray(ids):
        prev, seq = -1, []
        for i in row:
            if i != prev and i != blank_id:
                seq.append(int(i))
            prev = i
        out.append(seq)
    return out
