"""Inception-v3 feature extractor for FID, KID and PRDC (port of
``imaginaire_tpu/evaluation/inception.py``).

The torchvision ``inception_v3`` graph with the final fc stripped:
imagenet-normalized (B, 3, 299, 299) images in, the (B, 2048) global
average pool out. NCHW; submodules carry the JAX package's names
(``Conv2d_1a_3x3`` ... ``Mixed_7c``, each ``BasicConv`` a ``conv`` and
its frozen BatchNorm as ``bn_scale``/``bn_bias``/``bn_mean``/``bn_var``),
so the converted weights map path for path through ``bridge.py``.
BatchNorm runs on its stored statistics with eps 1e-3 (torchvision's);
the pools of the branches count the padding (``count_include_pad``), as
the unpatched torchvision graph does; the max pools have no padding.

Weights: ``load_params`` reads the flat ``/``-keyed ``.npz`` that
``scripts/convert_weights.py inception_v3`` writes, and fails loudly
without it: metrics from a random network measure nothing.
``random_init=True`` draws seeded weights for tests of the plumbing.

The extractor (``make_extractor``) rounds its input to bf16 and runs the
network in fp32, as the JAX extractor does (a bf16 input to fp32 flax
parameters is promoted to fp32). On the card its convolutions are cuDNN
with TF32 off: the extractor turns TF32 off for its own call and
restores the process's setting after, so a metric does not depend on it.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.bridge import load_flax_variables

BN_EPS = 1e-3
FEATURE_DIM = 2048


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class BasicConv(nn.Module):
    """Conv (no bias) + frozen BatchNorm + ReLU (torchvision BasicConv2d)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, _pair(kernel), stride=_pair(stride),
                              padding=_pair(padding), bias=False)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))
        self.bn_mean = nn.Parameter(torch.zeros(cout))
        self.bn_var = nn.Parameter(torch.ones(cout))

    def forward(self, x):
        x = self.conv(x)
        view = (1, -1, 1, 1)
        x = ((x - self.bn_mean.view(view)) * torch.rsqrt(self.bn_var.view(view) + BN_EPS)
             * self.bn_scale.view(view) + self.bn_bias.view(view))
        return F.relu(x)


def _avg_pool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        p17, p71 = (0, 3), (3, 0)
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=p17)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=p71)
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=p17)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=p17)
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        p13, p31 = (0, 1), (1, 0)
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=p13)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=p31)
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=p13)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=p31)
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """(B, 3, H, W) imagenet-normalized images -> (B, 2048) pooled
    features (H, W >= 75)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))

    @torch.no_grad()
    def init_params(self, generator):
        """Seeded weights for tests of the metric plumbing: conv kernels
        normal with std sqrt(2 / fan_in), so activations keep their scale
        through the ~50 layers of the deepest path; BatchNorm the
        identity. Drawn on the CPU from ``generator`` whatever the
        module's device, so a card and a CPU copy hold the same bits."""
        for name, p in self.named_parameters():
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                w = torch.randn(p.shape, generator=generator) * math.sqrt(2.0 / fan_in)
                p.copy_(w.to(p.device))
            elif name.endswith(("bn_scale", "bn_var")):
                p.fill_(1.0)
            else:
                p.zero_()
        return self


DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights", "inception_v3.npz")


def load_params(path=None, random_init=False, device="cpu", seed=0):
    """An ``InceptionV3`` in eval mode on ``device`` with the converted
    torchvision weights at ``path`` (default ``weights/inception_v3.npz``),
    or, with ``random_init`` and no file, seeded weights (tests only:
    metrics from a random network are meaningless). Raises
    ``FileNotFoundError`` naming the path otherwise."""
    path = path or DEFAULT_WEIGHTS
    model = InceptionV3().requires_grad_(False)
    if os.path.exists(path):
        params = {}
        for key, value in np.load(path).items():
            node = params
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
        load_flax_variables(model, {"params": params})
    elif random_init:
        model.init_params(torch.Generator().manual_seed(int(seed)))
    else:
        raise FileNotFoundError(
            f"Inception-v3 weights not found at {path}. Run "
            f"`python scripts/convert_weights.py inception_v3 {path}` on a "
            "machine with torchvision, or pass random_init=True (tests only).")
    return model.to(device).eval()


def make_extractor(model):
    """(B, 3, 299, 299) imagenet-normalized images -> (B, 2048) fp32:
    the input rounded to bf16, the network in fp32 (TF32 off on the
    card), no autograd."""
    def extractor(images):
        x = images.to(torch.bfloat16).float()
        cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                return model(x).float()
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn
            torch.backends.cuda.matmul.allow_tf32 = matmul

    return extractor
