"""Frozen FlowNet2 wrapper producing (flow, confidence) (port of
``imaginaire_tpu/flow/flow_net.py``; ref:
imaginaire/third_party/flow_net/flow_net.py:17-94).

Resizes inputs to a /64 grid, runs the cascade, and derives a confidence
map from the warp error (``||im1 - warp(im2, flow)||^2 < 0.02``).
Weights load from a converted checkpoint (``scripts/convert_weights.py
--flownet2``) through the weight bridge; absent weights raise unless
``allow_random_init``, which draws flax's default initialization from a
seed. Tensors are NCHW; the teacher runs in fp32 under
``torch.inference_mode()`` whatever the generator's precision, as the
JAX teacher does.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.flow.flownet2 import FlowNet2
from imaginaire_tpu_torch.model_utils.fs_vid2vid import resample
from imaginaire_tpu_torch.utils.misc import fp32_matmuls, resize_bilinear, resolve_device

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights",
                               "flownet2.npz")
CONF_THRESHOLD = 0.02  # squared warp error below which a pixel is confident
_TRUNC_NORMAL_STD = 0.87962566103423978  # std of a unit normal cut at +-2
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))  # P(|z| < 2) of a unit normal z


def _sq_norm(t):
    return (t * t).sum(dim=1, keepdim=True)


@torch.no_grad()
def flax_default_init_(module, generator):
    """flax's default initialization of every conv and transposed conv of
    ``module``, drawn from ``generator``: kernels LeCun normal (a normal
    cut at 2 standard deviations, scaled to variance 1 / fan_in,
    fan_in = in * kh * kw), biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
            # inverse-CDF draw of the cut normal (nn.init.trunc_normal_'s
            # method, written out: that call is ~8x slower on the CPU)
            m.weight.uniform_(-_ERF_2, _ERF_2, generator=generator).erfinv_()
            m.weight.mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
            if m.bias is not None:
                m.bias.zero_()
    return module


class FlowNet:
    """The frozen teacher on an explicit device (``cuda`` by default).

    ``init_params(seed)`` fills the weights; ``__call__(a, b)`` returns
    the pixel-unit flow from ``a`` to ``b`` (channel 0 = x) and the
    confidence map."""

    def __init__(self, weights_path=None, allow_random_init=False,
                 rgb_max=1.0, device=None):
        self.device = resolve_device(device)
        self.weights_path = weights_path or DEFAULT_WEIGHTS
        self.allow_random_init = allow_random_init
        # shapes only until init_params, which allocates the weights on
        # the device and fills every tensor (no torch default init)
        with torch.device("meta"):
            self.model = FlowNet2(rgb_max=rgb_max).eval().requires_grad_(False)
        self.initialized = False

    def init_params(self, seed=0):
        if os.path.exists(self.weights_path):
            params = load_flownet2_npz(self.weights_path)
        elif self.allow_random_init:
            params = None
        else:
            raise FileNotFoundError(
                f"FlowNet2 weights not found at {self.weights_path}; run "
                "scripts/convert_weights.py --flownet2 <ckpt> or pass "
                "allow_random_init=True (tests only)")
        self.model.to_empty(device=self.device)
        if params is None:
            flax_default_init_(self.model, torch.Generator(
                device=self.device).manual_seed(int(seed)))
        else:
            load_flax_variables(self.model, {"params": params})
        self.initialized = True
        return self.model

    def _flow_fn(self, im1, im2):
        """(ref: flow_net.py:54-91). im1, im2: (N, 3, H, W) fp32."""
        _, _, old_h, old_w = im1.shape
        new_h, new_w = old_h // 64 * 64, old_w // 64 * 64
        resized = (new_h, new_w) != (old_h, old_w)
        if resized:
            with fp32_matmuls():
                im1 = resize_bilinear(im1, (new_h, new_w))
                im2 = resize_bilinear(im2, (new_h, new_w))
        flow = self.model(torch.stack([im1, im2], dim=1))
        conf = (_sq_norm(im1 - resample(im2, flow)) < CONF_THRESHOLD).float()
        if resized:
            with fp32_matmuls():
                flow = resize_bilinear(flow, (old_h, old_w))
                conf = resize_bilinear(conf, (old_h, old_w))
            # per-axis rescale of the pixel-unit components (the reference
            # scales both by old_h / new_h, flow_net.py:86-88)
            scale = torch.tensor([old_w / new_w, old_h / new_h],
                                 dtype=flow.dtype, device=flow.device)
            flow = flow * scale.view(1, 2, 1, 1)
        return flow, conf

    def __call__(self, input_a, input_b):
        """Accepts (B, 3, H, W), (B, N, 3, H, W) or (B, T, N, 3, H, W)
        pairs (tensors or arrays); returns flow (..., 2, H, W) and
        confidence (..., 1, H, W) on the wrapper's device
        (ref: flow_net.py:35-52)."""
        if not self.initialized:
            self.init_params(0)
        a = torch.as_tensor(input_a, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(input_b, dtype=torch.float32, device=self.device)
        if a.dim() not in (4, 5, 6) or a.shape != b.shape or a.shape[-3] != 3:
            raise ValueError(f"FlowNet expects matching (..., 3, H, W) inputs "
                             f"of rank 4-6, got {tuple(a.shape)}, "
                             f"{tuple(b.shape)}")
        lead = a.shape[:-3]
        with torch.inference_mode():
            flow, conf = self._flow_fn(a.reshape((-1,) + a.shape[-3:]),
                                       b.reshape((-1,) + b.shape[-3:]))
        return (flow.reshape(lead + flow.shape[1:]),
                conf.reshape(lead + conf.shape[1:]))


def load_flownet2_npz(path):
    """Load a converted checkpoint into the flax parameter tree layout
    (nested dicts of numpy arrays), which the weight bridge takes."""
    params = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return params
