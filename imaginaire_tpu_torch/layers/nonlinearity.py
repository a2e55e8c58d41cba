"""Nonlinearity factory (port of ``imaginaire_tpu/layers/nonlinearity.py``).
Channels are dim 1 (NCHW, or (N, C) for dense layers)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

VALID = ("", "none", "relu", "leakyrelu", "prelu", "tanh", "sigmoid", "softmax")


def apply_nonlinearity(x, kind, prelu_alpha=None):
    if kind in ("", "none", None):
        return x
    if kind == "relu":
        return F.relu(x)
    if kind == "leakyrelu":
        return F.leaky_relu(x, negative_slope=0.2)
    if kind == "prelu":
        return torch.where(x >= 0, x, prelu_alpha * x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "softmax":
        return torch.softmax(x, dim=1)
    raise ValueError(f"unknown nonlinearity {kind!r}")


def needs_prelu_param(kind):
    return kind == "prelu"
