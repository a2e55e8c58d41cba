"""Activation normalization layers: instance/batch norm, AdaIN, SPADE.

Port of ``imaginaire_tpu/layers/activation_norm.py``. Every norm takes
``norm(x, *cond_inputs)`` on NCHW tensors. Modules are built with their
channel counts (torch has no lazy shapes): ``num_features`` is x's
channel count and the conditional norms take ``cond_dims``, the channel
count of each conditioning input, as the reference PyTorch project's
norms do. BatchNorm normalizes with the batch statistics in training
mode (the JAX package's ``sync_batch`` on one card) and with its running
statistics in eval mode.

Submodule names mirror the JAX package's parameter tree (``mlp_0``,
``gamma_0``, ``fc``...); a base norm that flax names inline
(``BatchNorm_0``) is registered under that same name, so
``bridge.load_flax_variables`` maps trees path for path.
"""

from __future__ import annotations

import functools
import operator

import torch
import torch.nn.functional as F
from torch import nn

from imaginaire_tpu_torch.layers.hyper_ops import per_sample_conv2d
from imaginaire_tpu_torch.layers.state import cast_param
from imaginaire_tpu_torch.ops.spade_modulation import spade_modulation
from imaginaire_tpu_torch.utils.misc import resize_bilinear, resize_nearest

CONDITIONAL_NORMS = ("adaptive", "spatially_adaptive", "hyper_spatially_adaptive")


def _fusable_modulation(impl, base_norm, x, pairs, masked=False):
    """Whether the SPADE epilogue can route through the fused
    ``ops.spade_modulation`` op: instance-norm statistics only, full-
    spatial gamma/beta maps, and no condition through a partial conv
    (``masked``). ``none``, ``off`` and ``unfused`` keep the composition;
    any other value fuses."""
    if impl in ("", "none", "off", "unfused", None):
        return False
    if masked or base_norm != "instance" or x.dim() != 4 or not pairs:
        return False
    return all(g.shape == x.shape == b.shape for g, b in pairs)


def default_fused_modulation(anp, remat):
    """The generator's default for the epilogue-fusion knob, given its
    remat policy: under an enabled policy ``fused_modulation`` defaults
    to ``none``, as the JAX package measured fusion and block remat to
    be alternatives; a value in the config always wins."""
    from imaginaire_tpu_torch.optim.remat import resolve_policy

    anp = dict(anp)
    if "fused_modulation" not in anp and resolve_policy(remat, where="gen.remat"):
        anp["fused_modulation"] = "none"
    return anp


def _resize(x, hw, method):
    if method == "nearest":
        return resize_nearest(x, hw)
    if method == "bilinear":
        return resize_bilinear(x, hw)
    raise ValueError(f"unknown interpolation {method!r}")


def _channel_view(t, ndim):
    return t.view((1, -1) + (1,) * (ndim - 2))


class NoNorm(nn.Module):
    def forward(self, x, *cond):
        return x


class InstanceNorm(nn.Module):
    """Per-sample, per-channel spatial normalization: fp32 statistics,
    biased variance, eps inside the square root, cast back to x's type."""

    def __init__(self, num_features, affine=True, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.affine = affine
        if affine:
            self.scale = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, *cond):
        axes = tuple(range(2, x.dim()))
        x32 = x.float()
        mean = x32.mean(dim=axes, keepdim=True)
        var = (x32 - mean).square().mean(dim=axes, keepdim=True)
        y = ((x32 - mean) * torch.reciprocal(torch.sqrt(var + self.eps))).to(x.dtype)
        if self.affine:
            y = (y * _channel_view(cast_param(self, self.scale), x.dim()).to(y.dtype)
                 + _channel_view(cast_param(self, self.bias), x.dim()).to(y.dtype))
        return y


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5), the JAX package's
    ``batch``/``sync_batch`` norm on one card. Eval mode normalizes with
    the running ``mean``/``var`` (``batch_stats``). Training mode
    normalizes with the batch statistics, computed in fp32 as flax does
    (``var = max(0, E[x^2] - E[x]^2)``, the biased variance), and
    returns x's type; the running statistics move towards them,
    ``0.9 * old + 0.1 * batch``, with the biased variance (not the
    unbiased one that ``F.batch_norm`` would store), and only in the
    step of the network that owns them (``update_state``). A list in
    ``record`` receives each training forward's (mean, biased variance)
    in fp32: the averaged generator's re-estimation reads them there
    (``trainers/base.py``)."""

    update_state = False  # move the running statistics (layers/state.py)
    record = None

    def __init__(self, num_features, affine=True, eps=1e-5, momentum=0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.scale = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x, *cond):
        scale, bias = cast_param(self, self.scale), cast_param(self, self.bias)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, scale, bias,
                                training=False, eps=self.eps)
        axes = (0,) + tuple(range(2, x.dim()))
        x32 = x.float()
        mean = x32.mean(dim=axes)
        var = torch.clamp_min(x32.square().mean(dim=axes) - mean.square(), 0.0)
        if self.record is not None:
            self.record.append((mean.detach(), var.detach()))
        if self.update_state:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps)
        out_dtype = x.dtype
        if scale is not None:
            mul = mul * scale.float()
            out_dtype = torch.promote_types(out_dtype, scale.dtype)
        y = (x32 - _channel_view(mean, x.dim())) * _channel_view(mul, x.dim())
        if bias is not None:
            y = y + _channel_view(bias.float(), x.dim())
            out_dtype = torch.promote_types(out_dtype, bias.dtype)
        return y.to(out_dtype)


def _base_norm(kind, num_features, affine):
    if kind in ("", "none", None):
        return NoNorm()
    if kind in ("batch", "sync_batch"):
        return BatchNorm(num_features, affine=affine)
    if kind == "instance":
        return InstanceNorm(num_features, affine=affine)
    raise ValueError(f"base norm {kind!r} is not in the port yet (ROADMAP.md)")


class _BaseNormHolder(nn.Module):
    """Registers the paramless base norm under its flax auto-name."""

    def _set_base_norm(self, kind, num_features):
        base = _base_norm(kind, num_features, affine=False)
        self._base_name = f"{type(base).__name__}_0"
        self.add_module(self._base_name, base)

    def base(self, x):
        return getattr(self, self._base_name)(x)


class AdaptiveNorm(_BaseNormHolder):
    """AdaIN: param-free base norm + gamma/beta projected from a style
    vector by a ``linear`` projection. The projected maps broadcast over
    space, which the fused op refuses, so this always runs the
    composition."""

    def __init__(self, num_features, cond_dims, projection="linear",
                 base_norm="instance", separate_projection=False,
                 weight_norm_type=""):
        super().__init__()
        from imaginaire_tpu_torch.layers.conv import LinearBlock

        if projection != "linear":
            raise ValueError(f"AdaptiveNorm projection {projection!r} is not "
                             f"in the port yet (ROADMAP.md)")
        self.separate_projection = separate_projection

        def dense(feats):
            return LinearBlock(cond_dims, feats, order="C",
                               weight_norm_type=weight_norm_type)

        if separate_projection:
            self.fc_gamma = dense(num_features)
            self.fc_beta = dense(num_features)
        else:
            self.fc = dense(2 * num_features)
        self._set_base_norm(base_norm, num_features)

    def forward(self, x, cond):
        if self.separate_projection:
            gamma, beta = self.fc_gamma(cond), self.fc_beta(cond)
        else:
            gamma, beta = self.fc(cond).chunk(2, dim=1)
        shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
        return self.base(x) * (1.0 + gamma.view(shape)) + beta.view(shape)


class SpatiallyAdaptiveNorm(_BaseNormHolder):
    """SPADE: each conditioning map is resized to x's spatial size, pushed
    through a small conv MLP, and contributes additive spatial gamma/beta
    maps: ``out = norm(x) * (1 + sum gamma_i) + sum beta_i``. With an
    instance base norm the epilogue runs as one fused op (the CUDA kernel
    on the card).

    A condition may arrive as an (image, mask) pair (wc-vid2vid's
    guidance); its entry in ``cond_dims`` is then the pair of their
    channel counts. With ``partial`` its ``mlp_{i}`` is a ``PartialConv2d``
    that reads the mask (one channel), and the layer never fuses, as the
    JAX layer does; without ``partial`` the mask is dropped and the image
    goes through the plain conv."""

    def __init__(self, num_features, cond_dims, num_filters=128,
                 kernel_size=3, base_norm="sync_batch",
                 separate_projection=True, partial=False,
                 interpolation="nearest", weight_norm_type="",
                 fused_modulation="auto"):
        super().__init__()
        from imaginaire_tpu_torch.layers.conv import Conv2dBlock, PartialConv2d

        self.partial = partial
        self.num_filters = num_filters
        self.separate_projection = separate_projection
        self.interpolation = interpolation
        self.base_norm = base_norm
        self.fused_modulation = fused_modulation
        cond_dims = [cond_dims] if isinstance(cond_dims, int) else list(cond_dims)

        def conv(cin, cout):
            return Conv2dBlock(cin, cout, kernel_size=kernel_size, order="C",
                               weight_norm_type=weight_norm_type)

        for i, cin in enumerate(cond_dims):
            if cin is None:  # a condition that never arrives
                continue
            masked = isinstance(cin, (tuple, list))
            if masked:
                cin, mask_channels = cin
                if partial and (num_filters <= 0 or mask_channels != 1):
                    raise ValueError(
                        "a partial-conv SPADE condition needs num_filters > 0 and "
                        f"a one-channel mask, got {num_filters} and {mask_channels}")
            hidden = cin
            if masked and partial:
                self.add_module(f"mlp_{i}", PartialConv2d(cin, num_filters, kernel_size))
                hidden = num_filters
            elif num_filters > 0:
                self.add_module(f"mlp_{i}", conv(cin, num_filters))
                hidden = num_filters
            if separate_projection:
                self.add_module(f"gamma_{i}", conv(hidden, num_features))
                self.add_module(f"beta_{i}", conv(hidden, num_features))
            else:
                self.add_module(f"gb_{i}", conv(hidden, 2 * num_features))
        self._set_base_norm(base_norm, num_features)

    def forward(self, x, *cond_inputs):
        hw = x.shape[2:]
        pairs = []
        masked = False
        for i, cond in enumerate(cond_inputs):
            if cond is None:
                continue
            mask = None
            if isinstance(cond, (tuple, list)):
                cond, mask = cond
            cond = _resize(cond, hw, self.interpolation)
            if self.partial and mask is not None:
                hidden, _ = getattr(self, f"mlp_{i}")(
                    cond, _resize(mask, hw, self.interpolation))
                hidden = F.relu(hidden)
                masked = True
            elif self.num_filters > 0:
                hidden = F.relu(getattr(self, f"mlp_{i}")(cond))
            else:
                hidden = cond
            if self.separate_projection:
                gamma = getattr(self, f"gamma_{i}")(hidden)
                beta = getattr(self, f"beta_{i}")(hidden)
            else:
                gamma, beta = getattr(self, f"gb_{i}")(hidden).chunk(2, dim=1)
            pairs.append((gamma, beta))
        if _fusable_modulation(self.fused_modulation, self.base_norm, x, pairs,
                               masked=masked):
            # a shared projection's chunks are strided views; the kernel
            # takes contiguous NCHW
            return spade_modulation(x.contiguous(), [g.contiguous() for g, _ in pairs],
                                    [b.contiguous() for _, b in pairs])
        y = self.base(x)
        if not pairs:
            return y
        gamma_sum = functools.reduce(operator.add, (g for g, _ in pairs))
        beta_sum = functools.reduce(operator.add, (b for _, b in pairs))
        return y * (1.0 + gamma_sum) + beta_sum


class HyperSpatiallyAdaptiveNorm(_BaseNormHolder):
    """SPADE whose first condition's conv may be a runtime input
    (fs-vid2vid): ``norm(x, *cond, norm_weights=(w, b))`` with w (B, kh,
    kw, cin, 2C) predicted per sample turns the first condition into its
    gamma/beta maps by the per-sample conv (``hyper_ops``); every other
    condition has its own conv ``gb_{i}`` (after ``mlp_{i}`` and a ReLU
    when ``num_filters`` > 0), plain convs without a weight norm. The
    conditions are resized (nearest) to x's size. Unlike SPADE the
    pairs apply in sequence, ``out = (norm(x) * (1 + g0) + b0) * (1 +
    g1) + b1 ...``: only the first pair fuses with the instance norm
    (``ops.spade_modulation``, the CUDA kernel on the card). ``hyper``
    says that the first condition's weights always arrive, so it has no
    ``gb_0`` (the JAX layer creates it only when called without them)."""

    def __init__(self, num_features, cond_dims, num_filters=0, kernel_size=3,
                 base_norm="instance", fused_modulation="auto", hyper=False):
        super().__init__()
        from imaginaire_tpu_torch.layers.conv import _WeightNormedConv

        self.num_filters = num_filters
        self.base_norm = base_norm
        self.fused_modulation = fused_modulation
        cond_dims = [cond_dims] if isinstance(cond_dims, int) else list(cond_dims)
        ks, pad = (kernel_size, kernel_size), (kernel_size // 2,) * 2

        def conv(cin, cout):
            return _WeightNormedConv(cin, cout, ks, (1, 1), pad, (1, 1))

        for i, cin in enumerate(cond_dims):
            if cin is None or (i == 0 and hyper):
                continue
            hidden = cin
            if num_filters > 0:
                self.add_module(f"mlp_{i}", conv(cin, num_filters))
                hidden = num_filters
            self.add_module(f"gb_{i}", conv(hidden, 2 * num_features))
        self._set_base_norm(base_norm, num_features)

    def forward(self, x, *cond_inputs, norm_weights=None):
        hw = x.shape[2:]
        pairs = []
        for i, cond in enumerate(cond_inputs):
            if cond is None:
                continue
            if isinstance(cond, (tuple, list)):
                raise NotImplementedError(
                    "masked conditions of the hyper SPADE norm are not in the "
                    "port yet (ROADMAP.md)")
            cond = resize_nearest(cond, hw)
            if i == 0 and norm_weights is not None and norm_weights[0] is not None:
                affine = per_sample_conv2d(cond, *norm_weights)
            else:
                h = cond
                if self.num_filters > 0:
                    h = F.relu(getattr(self, f"mlp_{i}")(h))
                affine = getattr(self, f"gb_{i}")(h)
            pairs.append(affine.chunk(2, dim=1))
        start = 0
        if pairs and _fusable_modulation(self.fused_modulation, self.base_norm,
                                         x, pairs[:1]):
            gamma, beta = pairs[0]
            out = spade_modulation(x.contiguous(), [gamma.contiguous()],
                                   [beta.contiguous()])
            start = 1
        else:
            out = self.base(x)
        for gamma, beta in pairs[start:]:
            out = out * (1.0 + gamma) + beta
        return out


def get_activation_norm_layer(num_features, norm_type, norm_params=None):
    """Norm factory: a module with the ``(x, *cond)`` signature, or None.
    Conditional norms need ``norm_params['cond_dims']``."""
    p = dict(norm_params or {})
    if isinstance(norm_type, str) and norm_type.endswith("_norm"):
        norm_type = norm_type[: -len("_norm")]
    if norm_type in ("", "none", None):
        return None
    if norm_type in ("batch", "sync_batch"):
        return BatchNorm(num_features, affine=p.get("affine", True))
    if norm_type == "instance":
        return InstanceNorm(num_features, affine=p.get("affine", True))
    if norm_type in CONDITIONAL_NORMS and "cond_dims" not in p:
        raise ValueError(f"{norm_type} norm needs activation_norm_params."
                         f"cond_dims (the conditioning channels)")
    if norm_type == "adaptive":
        return AdaptiveNorm(
            num_features, p["cond_dims"],
            projection=p.get("projection", "linear"),
            base_norm=p.get("activation_norm_type", "instance"),
            separate_projection=p.get("separate_projection", False),
            weight_norm_type=p.get("weight_norm_type", ""))
    if norm_type == "spatially_adaptive":
        return SpatiallyAdaptiveNorm(
            num_features, p["cond_dims"],
            num_filters=p.get("num_filters", 128),
            kernel_size=p.get("kernel_size", 3),
            base_norm=p.get("activation_norm_type", "sync_batch"),
            separate_projection=p.get("separate_projection", True),
            partial=p.get("partial", False),
            interpolation=p.get("interpolation", "nearest"),
            weight_norm_type=p.get("weight_norm_type", ""),
            fused_modulation=p.get("fused_modulation", "auto"))
    if norm_type == "hyper_spatially_adaptive":
        return HyperSpatiallyAdaptiveNorm(
            num_features, p["cond_dims"],
            num_filters=p.get("num_filters", 0),
            kernel_size=p.get("kernel_size", 3),
            base_norm=p.get("activation_norm_type", "instance"),
            fused_modulation=p.get("fused_modulation", "auto"),
            hyper=p.get("hyper", False))
    raise ValueError(f"activation norm {norm_type!r} is not in the port yet "
                     f"(ROADMAP.md)")
