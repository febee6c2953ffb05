"""TRBA: TPS transformation, FAN ResNet, BiLSTMs and an attention decoder
(port of `udifftext_tpu/models/trba.py`).

Parameter names are strhub's (`Transformation.LocalizationNetwork.conv.0`,
`Transformation.GridGenerator.P_hat`, `FeatureExtraction.ConvNet.layer3.4.bn2`,
`SequenceModeling.1.rnn`, `Prediction.attention_cell.rnn`, …), so a strhub
TRBA checkpoint loads by name after its `model.` prefix. Images are NHWC;
the conv stacks run on an NCHW view; BatchNorm reads its running statistics
in eval mode (the JAX build's always do). The TPS grid's closed-form
constants are buffers, as in strhub, computed by `build_tps_constants`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import grid_sample_bilinear
from .str_models import BiLSTM


def build_tps_constants(F: int, out_h: int, out_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(inv_delta_C (F+3, F+3), P_hat (out_h·out_w, F+3)) fp32: the TPS
    system's inverse over the F fiducials and the output grid's basis
    (transformation.py:106-160; the radial term is r²·log(r + 1e-6))."""
    ctrl_x = np.linspace(-1.0, 1.0, F // 2)
    C = np.concatenate(
        [np.stack([ctrl_x, -np.ones(F // 2)], 1), np.stack([ctrl_x, np.ones(F // 2)], 1)],
        axis=0,
    )  # (F, 2)

    hat_C = np.zeros((F, F))
    for i in range(F):
        for j in range(F):
            r = np.linalg.norm(C[i] - C[j]) + np.eye(F)[i, j]
            hat_C[i, j] = r**2 * np.log(r)
    delta_C = np.concatenate(
        [
            np.concatenate([np.ones((F, 1)), C, hat_C], axis=1),
            np.concatenate([np.zeros((2, 3)), C.T], axis=1),
            np.concatenate([np.zeros((1, 3)), np.ones((1, F))], axis=1),
        ],
        axis=0,
    )
    inv_delta_C = np.linalg.inv(delta_C)

    gx = (np.arange(-out_w, out_w, 2) + 1.0) / out_w
    gy = (np.arange(-out_h, out_h, 2) + 1.0) / out_h
    P = np.stack(np.meshgrid(gx, gy), axis=2).reshape(-1, 2)  # (n, 2)
    n = P.shape[0]
    rbf_norm = np.linalg.norm(P[:, None] - C[None], axis=2, keepdims=True)  # (n, F, 1)
    rbf = np.square(rbf_norm) * np.log(rbf_norm + 1e-6)
    P_hat = np.concatenate([np.ones((n, 1)), P, rbf[..., 0]], axis=1)
    return inv_delta_C.astype(np.float32), P_hat.astype(np.float32)


def _conv_bn_relu_pool(c_in: int, c_out: int, pool: nn.Module):
    return [nn.Conv2d(c_in, c_out, 3, 1, 1, bias=False), nn.BatchNorm2d(c_out), nn.ReLU(), pool]


class LocalizationNetwork(nn.Module):
    """The F fiducial points (B, F, 2) of an image: four conv/BN/ReLU stages
    (2×2 pools after the first three), a global average, two dense layers.
    fc2 starts with zero weights and the rectangle's fiducials as its bias
    (RARE, Fig. 6a)."""

    def __init__(self, F: int = 20, in_channels: int = 3):
        super().__init__()
        self.F = F
        self.conv = nn.Sequential(
            *_conv_bn_relu_pool(in_channels, 64, nn.MaxPool2d(2, 2)),
            *_conv_bn_relu_pool(64, 128, nn.MaxPool2d(2, 2)),
            *_conv_bn_relu_pool(128, 256, nn.MaxPool2d(2, 2)),
            *_conv_bn_relu_pool(256, 512, nn.AdaptiveAvgPool2d(1)),
        )
        self.localization_fc1 = nn.Sequential(nn.Linear(512, 256), nn.ReLU())
        self.localization_fc2 = nn.Linear(256, F * 2)
        ctrl_x = np.linspace(-1.0, 1.0, F // 2)
        top = np.stack([ctrl_x, np.linspace(0.0, -1.0, F // 2)], 1)
        bot = np.stack([ctrl_x, np.linspace(1.0, 0.0, F // 2)], 1)
        with torch.no_grad():
            self.localization_fc2.weight.zero_()
            self.localization_fc2.bias.copy_(torch.from_numpy(
                np.concatenate([top, bot], 0).reshape(-1).astype(np.float32)))

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        h = self.conv(x_nchw).flatten(1)
        return self.localization_fc2(self.localization_fc1(h)).reshape(-1, self.F, 2)


class GridGenerator(nn.Module):
    """The sampling grid of the output size from the predicted fiducials."""

    def __init__(self, F: int, out_size: Tuple[int, int]):
        super().__init__()
        self.out_size = tuple(out_size)
        inv_delta_C, P_hat = build_tps_constants(F, *self.out_size)
        self.register_buffer("inv_delta_C", torch.from_numpy(inv_delta_C))
        self.register_buffer("P_hat", torch.from_numpy(P_hat))

    def forward(self, c_prime: torch.Tensor) -> torch.Tensor:
        cp = torch.cat([c_prime, c_prime.new_zeros(c_prime.shape[0], 3, 2)], dim=1)
        T = torch.matmul(self.inv_delta_C, cp)  # (B, F+3, 2)
        return torch.matmul(self.P_hat, T).reshape(-1, *self.out_size, 2)


class TPSSpatialTransformer(nn.Module):
    def __init__(self, F: int = 20, out_size: Tuple[int, int] = (32, 100), in_channels: int = 3):
        super().__init__()
        self.LocalizationNetwork = LocalizationNetwork(F, in_channels)
        self.GridGenerator = GridGenerator(F, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image → NHWC image of the output size."""
        grid = self.GridGenerator(self.LocalizationNetwork(x.permute(0, 3, 1, 2)))
        return grid_sample_bilinear(x, grid)


def _conv3x3(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, 1, 1, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, bias=False),
                                         nn.BatchNorm2d(planes))
                           if inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class FANResNet(nn.Module):
    """strhub's ResNet feature extractor, blocks [1, 2, 5, 3]: NCHW in,
    (B, C, 1, W') out for a 32-pixel-high input."""

    def __init__(self, in_channels: int = 3, output_channel: int = 512):
        super().__init__()
        oc = output_channel
        widths = (oc // 4, oc // 2, oc, oc)
        self.conv0_1 = _conv3x3(in_channels, oc // 16)
        self.bn0_1 = nn.BatchNorm2d(oc // 16)
        self.conv0_2 = _conv3x3(oc // 16, oc // 8)
        self.bn0_2 = nn.BatchNorm2d(oc // 8)
        inplanes = oc // 8
        for i, (planes, n) in enumerate(zip(widths, (1, 2, 5, 3)), start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                *(BasicBlock(inplanes if b == 0 else planes, planes) for b in range(n))))
            inplanes = planes
            if i < 4:
                setattr(self, f"conv{i}", _conv3x3(planes, planes))
                setattr(self, f"bn{i}", nn.BatchNorm2d(planes))
        self.conv4_1 = nn.Conv2d(oc, oc, 2, stride=(2, 1), padding=(0, 1), bias=False)
        self.bn4_1 = nn.BatchNorm2d(oc)
        self.conv4_2 = nn.Conv2d(oc, oc, 2, stride=1, padding=0, bias=False)
        self.bn4_2 = nn.BatchNorm2d(oc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0_1(self.conv0_1(x)))
        x = F.relu(self.bn0_2(self.conv0_2(x)))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.bn1(self.conv1(self.layer1(x))))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.bn2(self.conv2(self.layer2(x))))
        # inputs are ReLU outputs, so the −inf padding equals the JAX build's zeros
        x = F.max_pool2d(x, 2, (2, 1), (0, 1))
        x = F.relu(self.bn3(self.conv3(self.layer3(x))))
        x = self.layer4(x)
        x = F.relu(self.bn4_1(self.conv4_1(x)))
        return F.relu(self.bn4_2(self.conv4_2(x)))


class ResNetFeatureExtractor(nn.Module):
    def __init__(self, in_channels: int = 3, output_channel: int = 512):
        super().__init__()
        self.ConvNet = FANResNet(in_channels, output_channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvNet(x)


class AttentionCell(nn.Module):
    """Additive attention over the sequence features, then an LSTM cell on
    [context, char embedding] (prediction.py:54-76)."""

    def __init__(self, input_size: int, hidden: int, num_embeddings: int):
        super().__init__()
        self.i2h = nn.Linear(input_size, hidden, bias=False)
        self.h2h = nn.Linear(hidden, hidden)
        self.score = nn.Linear(hidden, 1, bias=False)
        self.rnn = nn.LSTMCell(input_size + num_embeddings, hidden)

    def forward(self, carry, batch_H: torch.Tensor, char_emb: torch.Tensor):
        h_prev, c_prev = carry
        e = self.score(torch.tanh(self.i2h(batch_H) + self.h2h(h_prev)[:, None]))
        alpha = torch.softmax(e, dim=1)  # (B, T, 1)
        context = torch.sum(alpha * batch_H, dim=1)
        h, c = self.rnn(torch.cat([context, char_emb], dim=-1), (h_prev, c_prev))
        return (h, c), alpha


class AttentionDecoder(nn.Module):
    """max_label_length + 1 steps: teacher-forced on `text` (B, steps) when
    given, else greedy from the [GO] id 0 → logits (B, steps, num_class)."""

    def __init__(self, input_size: int, hidden: int, num_class: int,
                 num_char_embeddings: int = 256):
        super().__init__()
        self.hidden = hidden
        self.attention_cell = AttentionCell(input_size, hidden, num_char_embeddings)
        self.generator = nn.Linear(hidden, num_class)
        self.char_embeddings = nn.Embedding(num_class, num_char_embeddings)

    def forward(self, batch_H: torch.Tensor, text: Optional[torch.Tensor],
                max_label_length: int = 25) -> torch.Tensor:
        b = batch_H.shape[0]
        carry = (batch_H.new_zeros(b, self.hidden), batch_H.new_zeros(b, self.hidden))
        targets = torch.zeros(b, dtype=torch.long, device=batch_H.device)
        probs = []
        for i in range(max_label_length + 1):
            inp = text[:, i] if text is not None else targets
            carry, _ = self.attention_cell(carry, batch_H, self.char_embeddings(inp))
            probs.append(self.generator(carry[0]))
            targets = probs[-1].argmax(dim=-1)
        return torch.stack(probs, dim=1)


class TRBA(nn.Module):
    """The full pipeline on (B, 32, 128, C) NHWC images: TPS to img_size,
    FAN ResNet averaged over height, two BiLSTMs, then the attention
    decoder (B, max_label_length + 1, num_class), or with `use_ctc` a linear
    CTC head per frame."""

    def __init__(self, num_class: int = 96, max_label_length: int = 25, num_fiducial: int = 20,
                 output_channel: int = 512, hidden: int = 256,
                 img_size: Tuple[int, int] = (32, 128), use_ctc: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.max_label_length = max_label_length
        self.use_ctc = use_ctc
        self.Transformation = TPSSpatialTransformer(num_fiducial, img_size, in_channels)
        self.FeatureExtraction = ResNetFeatureExtractor(in_channels, output_channel)
        self.SequenceModeling = nn.Sequential(BiLSTM(output_channel, hidden, hidden),
                                              BiLSTM(hidden, hidden, hidden))
        self.Prediction = (nn.Linear(hidden, num_class) if use_ctc
                           else AttentionDecoder(hidden, hidden, num_class))

    def forward(self, x: torch.Tensor, text: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.Transformation(x)
        feat = self.FeatureExtraction(x.permute(0, 3, 1, 2)).mean(dim=2)  # (B, C, W')
        feat = self.SequenceModeling(feat.transpose(1, 2))
        if self.use_ctc:
            return self.Prediction(feat)
        return self.Prediction(feat, text, self.max_label_length)
