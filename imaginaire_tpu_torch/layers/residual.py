"""Residual block (port of ``Res2dBlock`` in
``imaginaire_tpu/layers/residual.py``).

Two conv blocks on the main branch plus a learned 1x1 shortcut when the
channel counts differ. ``order`` covers both main-branch convs
('CNACNA', 'NACNAC' or the 'pre_act' alias); the shortcut runs the first
half of the order without the nonlinearity, keeping the (conditional)
norm when ``skip_activation_norm``. The JAX block's stride, dilation,
noise and shortcut-forcing options wait for the families that use
them.

``HyperRes2dBlock`` (fs-vid2vid) takes per-sample conv kernels and
hyper-SPADE weights at call time for its two main-branch steps
(``_HyperConvNorm``); its shortcut is a plain 1x1 conv.
"""

from __future__ import annotations

import torch
from torch import nn

from imaginaire_tpu_torch.layers.activation_norm import get_activation_norm_layer
from imaginaire_tpu_torch.layers.conv import Conv2dBlock, _norm_channels
from imaginaire_tpu_torch.layers.hyper_ops import per_sample_conv2d
from imaginaire_tpu_torch.layers.nonlinearity import apply_nonlinearity, needs_prelu_param
from imaginaire_tpu_torch.layers.state import cast_param
from imaginaire_tpu_torch.utils.misc import upsample_2x


def _split_order(order):
    if order == "pre_act":
        order = "NACNAC"
    if len(order) not in (4, 5, 6):
        raise ValueError(f"residual order must have 4-6 chars, got {order!r}")
    half = (len(order) + 1) // 2
    return order[:half], order[half:]


class Res2dBlock(nn.Module):
    upsample = False  # UpRes2dBlock: 2x nearest after conv_0 and on the shortcut

    def __init__(self, in_channels, out_channels, kernel_size=3, padding=None,
                 bias=True, padding_mode="zeros", weight_norm_type="",
                 weight_norm_params=None, activation_norm_type="",
                 activation_norm_params=None, skip_activation_norm=True,
                 skip_nonlinearity=False, nonlinearity="leakyrelu", order="CNACNA",
                 hidden_channels_equal_out_channels=False):
        super().__init__()
        order0, order1 = _split_order(order)
        hidden = (out_channels if hidden_channels_equal_out_channels
                  else min(in_channels, out_channels))
        if isinstance(bias, (tuple, list)):
            bias_0, bias_1, bias_s = bias
        else:
            bias_0 = bias_1 = bias_s = bias
        common = dict(
            kernel_size=kernel_size, padding=padding, padding_mode=padding_mode,
            weight_norm_type=weight_norm_type,
            weight_norm_params=weight_norm_params,
            activation_norm_type=activation_norm_type,
            activation_norm_params=activation_norm_params,
            nonlinearity=nonlinearity)
        self.conv_0 = Conv2dBlock(in_channels, hidden, order=order0,
                                  bias=bias_0, **common)
        self.conv_1 = Conv2dBlock(hidden, out_channels, order=order1,
                                  bias=bias_1, **common)
        self.conv_s = None
        if in_channels != out_channels:
            common.update(kernel_size=1, padding=0,
                          nonlinearity=nonlinearity if skip_nonlinearity else "")
            if not skip_activation_norm:
                common["activation_norm_type"] = ""
            self.conv_s = Conv2dBlock(in_channels, out_channels, order=order0,
                                      bias=bias_s, **common)

    def _scale_up(self, x):
        return upsample_2x(x) if self.upsample else x

    def forward(self, x, *cond_inputs):
        dx = self._scale_up(self.conv_0(x, *cond_inputs))
        dx = self.conv_1(dx, *cond_inputs)
        xs = self._scale_up(x)
        if self.conv_s is not None:
            xs = self.conv_s(xs, *cond_inputs)
        return xs + dx


class UpRes2dBlock(Res2dBlock):
    """``Res2dBlock`` with a 2x nearest upsample after the first conv and
    on the shortcut, before its conv."""

    upsample = True


class _HyperConvNorm(nn.Module):
    """One conv + norm + nonlinearity step of ``HyperRes2dBlock``, in
    ``order`` as written. The conv takes per-sample kernels when they
    arrive (``conv_weights``, "SAME" padding) and is ``conv`` otherwise,
    which exists only when ``own_conv``; a ``hyper_spatially_adaptive``
    norm receives ``norm_weights``, any other norm ignores them."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 weight_norm_type="", activation_norm_type="hyper_spatially_adaptive",
                 activation_norm_params=None, nonlinearity="leakyrelu",
                 order="CNA", own_conv=True):
        super().__init__()
        self.order = order
        self.nonlinearity = nonlinearity
        self.hyper_norm = activation_norm_type == "hyper_spatially_adaptive"
        self.norm = get_activation_norm_layer(
            _norm_channels(order, in_channels, out_channels),
            activation_norm_type, activation_norm_params)
        if needs_prelu_param(nonlinearity):
            self.prelu_alpha = nn.Parameter(torch.tensor(0.25))
        if own_conv:
            self.conv = Conv2dBlock(in_channels, out_channels, kernel_size,
                                    weight_norm_type=weight_norm_type, order="C")

    def forward(self, x, *cond_inputs, conv_weights=None, norm_weights=None):
        for op in self.order:
            if op == "C":
                if conv_weights is not None and conv_weights[0] is not None:
                    x = per_sample_conv2d(x, *conv_weights)
                else:
                    x = self.conv(x)
            elif op == "N":
                if self.norm is not None:
                    if self.hyper_norm:
                        x = self.norm(x, *cond_inputs, norm_weights=norm_weights)
                    else:
                        x = self.norm(x, *cond_inputs)
            elif op == "A":
                x = apply_nonlinearity(
                    x, self.nonlinearity,
                    cast_param(self, getattr(self, "prelu_alpha", None)))
        return x


class HyperRes2dBlock(nn.Module):
    """Residual block of two ``_HyperConvNorm`` steps whose kernels and
    norm weights may arrive at call time, plus a learned 1x1 shortcut
    when the channel counts differ. ``hyper_conv`` / ``hyper_norm`` say
    that the conv kernels / the first norm condition's weights always
    arrive, so the steps own no ``conv`` / ``gb_0``."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 weight_norm_type="", activation_norm_type="hyper_spatially_adaptive",
                 activation_norm_params=None, nonlinearity="leakyrelu",
                 order="CNACNA", hyper_conv=False, hyper_norm=False):
        super().__init__()
        order0, order1 = _split_order(order)
        hidden = min(in_channels, out_channels)
        anp = dict(activation_norm_params or {}, hyper=hyper_norm)
        common = dict(kernel_size=kernel_size, weight_norm_type=weight_norm_type,
                      activation_norm_type=activation_norm_type,
                      activation_norm_params=anp, nonlinearity=nonlinearity,
                      own_conv=not hyper_conv)
        self.conv_0 = _HyperConvNorm(in_channels, hidden, order=order0, **common)
        self.conv_1 = _HyperConvNorm(hidden, out_channels, order=order1, **common)
        self.conv_s = None
        if in_channels != out_channels:
            self.conv_s = Conv2dBlock(in_channels, out_channels, kernel_size=1,
                                      padding=0, weight_norm_type=weight_norm_type,
                                      order="C")

    def forward(self, x, *cond_inputs, conv_weights=(None, None),
                norm_weights=(None, None)):
        dx = self.conv_0(x, *cond_inputs, conv_weights=conv_weights[0],
                         norm_weights=norm_weights[0])
        dx = self.conv_1(dx, *cond_inputs, conv_weights=conv_weights[1],
                         norm_weights=norm_weights[1])
        xs = x if self.conv_s is None else self.conv_s(x)
        return xs + dx
