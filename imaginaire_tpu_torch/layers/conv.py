"""Conv/Linear blocks with the ``order`` micro-DSL (port of
``imaginaire_tpu/layers/conv.py``).

A block = [weight-normalized conv] + [activation norm] + [nonlinearity],
arranged by ``order`` ('CNA', 'NAC', ...). Conditional norms (AdaIN,
SPADE) receive their conditioning through extra positional call args:
``block(x, *cond_inputs)``. NCHW tensors, OIHW kernels. Blocks are built
with their channel counts; the norm's channel count follows the order
(the input's when N comes before C, else the output's). ``PartialConv2d``
is the mask-aware conv of wc-vid2vid's partial SPADE branch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.layers import hyper_ops
from imaginaire_tpu_torch.layers.activation_norm import (
    CONDITIONAL_NORMS,
    get_activation_norm_layer,
)
from imaginaire_tpu_torch.layers.nonlinearity import apply_nonlinearity, needs_prelu_param
from imaginaire_tpu_torch.layers.state import cast_param
from imaginaire_tpu_torch.layers.weight_norm import init_u, spectral_normalize

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate", "circular": "circular"}


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _effective_order(order):
    """Collapse repeated order chars to their first occurrence (a plain
    block keys its layers by op name, so 'NACNAC' acts as 'NAC'); only
    residual blocks split a doubled order into two blocks."""
    out = []
    for op in order:
        if op not in "CNA":
            raise ValueError(f"invalid order char {op!r} in {order!r}")
        if op not in out:
            out.append(op)
    return "".join(out)


def _weight_norm_u(module, weight_norm_type, out_features):
    """Register the spectral-norm vector ``u`` where the JAX package keeps
    it; refuse the weight norms the port does not have yet."""
    if weight_norm_type == "spectral":
        module.register_buffer("u", init_u(out_features))
        return True
    if weight_norm_type in ("", "none", None):
        return False
    raise ValueError(f"weight norm {weight_norm_type!r} is not in the port "
                     f"yet (ROADMAP.md)")


class _WeightNormedConv(nn.Module):
    """2-D conv whose kernel passes through the configured weight norm.
    The kernel is rounded to the step's parameter dtype, normalized, and
    cast to x's type, as the JAX layer does."""

    update_state = False  # advance u in a training forward (layers/state.py)

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups=1, bias=True, padding_mode="zeros",
                 weight_norm_type="", weight_norm_params=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        if padding_mode != "zeros" and padding_mode not in _PAD_MODES:
            raise ValueError(f"unknown padding mode {padding_mode!r}")
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *kernel_size))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter("bias", None)
        self.spectral = _weight_norm_u(self, weight_norm_type, out_channels)
        self.sn_eps = dict(weight_norm_params or {}).get("eps", 1e-12)

    def forward(self, x):
        w = cast_param(self, self.weight)
        if self.spectral:
            w = spectral_normalize(w, self.u, eps=self.sn_eps,
                                   update=self.training and self.update_state)
        w = w.to(x.dtype)
        bias = None if self.bias is None else cast_param(self, self.bias).to(x.dtype)
        if self.padding_mode == "zeros":
            return F.conv2d(x, w, bias, self.stride, self.padding,
                            self.dilation, self.groups)
        ph, pw = self.padding
        x = F.pad(x, (pw, pw, ph, ph), mode=_PAD_MODES[self.padding_mode])
        return F.conv2d(x, w, bias, self.stride, 0, self.dilation, self.groups)


def _norm_channels(order, in_channels, out_channels):
    if "C" in order and order.index("N") > order.index("C"):
        return out_channels
    return in_channels


class Conv2dBlock(nn.Module):
    """Conv + norm + nonlinearity in ``order``."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, dilation=1, groups=1, bias=True,
                 padding_mode="zeros", weight_norm_type="",
                 weight_norm_params=None, activation_norm_type="",
                 activation_norm_params=None, nonlinearity="", order="CNA"):
        super().__init__()
        self.order = _effective_order(order)
        self.nonlinearity = nonlinearity
        self.conditional = activation_norm_type in CONDITIONAL_NORMS
        if "C" in self.order:
            ks, dil = _pair(kernel_size), _pair(dilation)
            pad = (tuple(d * (k - 1) // 2 for k, d in zip(ks, dil))
                   if padding is None else _pair(padding))
            self.conv = _WeightNormedConv(
                in_channels, out_channels, ks, _pair(stride), pad, dil,
                groups=groups, bias=bias, padding_mode=padding_mode,
                weight_norm_type=weight_norm_type,
                weight_norm_params=weight_norm_params)
        self.norm = None
        if "N" in self.order:
            self.norm = get_activation_norm_layer(
                _norm_channels(self.order, in_channels, out_channels),
                activation_norm_type, activation_norm_params)
        if needs_prelu_param(nonlinearity):
            self.prelu_alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x, *cond_inputs):
        for op in self.order:
            if op == "C":
                x = self.conv(x)
            elif op == "N":
                if self.norm is not None:
                    x = self.norm(x, *(cond_inputs if self.conditional else ()))
            else:
                x = apply_nonlinearity(
                    x, self.nonlinearity,
                    cast_param(self, getattr(self, "prelu_alpha", None)))
        return x


class HyperConv2dBlock(Conv2dBlock):
    """Conv block whose conv kernels may arrive at call time:
    ``block(x, *cond, conv_weights=(w, b))`` with w (B, kh, kw, cin,
    cout) runs the per-sample conv (``hyper_ops``, "SAME" padding at the
    block's stride). The JAX block creates its own ``conv`` only when it
    is first called without weights, so ``own_conv`` says whether this
    one has it: a block that always receives weights has no parameters
    of its own, and ``bridge.py`` finds none to fill."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 own_conv=True, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size=kernel_size,
                         stride=stride, **kwargs)
        self.stride = stride if isinstance(stride, int) else stride[0]
        if not own_conv and "C" in self.order:
            del self.conv

    def forward(self, x, *cond_inputs, conv_weights=None):
        for op in self.order:
            if op == "C":
                if conv_weights is not None and conv_weights[0] is not None:
                    x = hyper_ops.per_sample_conv2d(x, *conv_weights,
                                                    stride=self.stride)
                else:
                    x = self.conv(x)
            elif op == "N":
                if self.norm is not None:
                    x = self.norm(x, *(cond_inputs if self.conditional else ()))
            else:
                x = apply_nonlinearity(
                    x, self.nonlinearity,
                    cast_param(self, getattr(self, "prelu_alpha", None)))
        return x


class PartialConv2d(nn.Module):
    """Mask-aware convolution (partial convolution), stride 1: ``conv(x *
    mask)`` rescaled by the window's size over its count of valid pixels,
    plus the bias, zero where the window holds none. ``mask`` has one
    channel (None: all valid). Returns (out, the window-valid mask). Zero
    padding of (k - 1) // 2 each side; no weight norm. Plain ``F.conv2d``:
    no Pallas kernel computes it in the JAX package."""

    def __init__(self, in_channels, out_channels, kernel_size=3):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.padding = tuple((k - 1) // 2 for k in self.kernel_size)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, mask=None):
        if mask is None:
            mask = torch.ones((x.shape[0], 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
        ones = torch.ones((1, 1) + self.kernel_size, dtype=x.dtype, device=x.device)
        mask_sum = F.conv2d(mask, ones, None, 1, self.padding)
        out = F.conv2d(x * mask, cast_param(self, self.weight).to(x.dtype), None, 1,
                       self.padding)
        valid = mask_sum > 0
        win_size = float(self.kernel_size[0] * self.kernel_size[1])
        ratio = torch.where(valid, win_size / torch.clamp_min(mask_sum, 1e-8),
                            torch.zeros_like(mask_sum))
        bias = cast_param(self, self.bias).to(out.dtype).view(1, -1, 1, 1)
        return (out * ratio + bias) * valid, valid.to(x.dtype)


class LinearBlock(nn.Module):
    """Dense + norm + nonlinearity with the same order DSL."""

    update_state = False  # advance u in a training forward (layers/state.py)

    def __init__(self, in_features, out_features, bias=True,
                 weight_norm_type="", activation_norm_type="",
                 activation_norm_params=None, nonlinearity="", order="CNA"):
        super().__init__()
        self.order = _effective_order(order)
        self.nonlinearity = nonlinearity
        self.conditional = activation_norm_type in CONDITIONAL_NORMS
        if "C" in self.order:
            self.weight = nn.Parameter(torch.empty(out_features, in_features))
            if bias:
                self.bias = nn.Parameter(torch.zeros(out_features))
            else:
                self.register_parameter("bias", None)
            self.spectral = _weight_norm_u(self, weight_norm_type, out_features)
        self.norm = None
        if "N" in self.order:
            self.norm = get_activation_norm_layer(
                _norm_channels(self.order, in_features, out_features),
                activation_norm_type, activation_norm_params)
        if needs_prelu_param(nonlinearity):
            self.prelu_alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x, *cond_inputs):
        for op in self.order:
            if op == "C":
                w = cast_param(self, self.weight)
                if self.spectral:
                    w = spectral_normalize(
                        w, self.u, update=self.training and self.update_state)
                bias = (None if self.bias is None
                        else cast_param(self, self.bias).to(x.dtype))
                x = F.linear(x, w.to(x.dtype), bias)
            elif op == "N":
                if self.norm is not None:
                    x = self.norm(x, *(cond_inputs if self.conditional else ()))
            else:
                x = apply_nonlinearity(
                    x, self.nonlinearity,
                    cast_param(self, getattr(self, "prelu_alpha", None)))
        return x
