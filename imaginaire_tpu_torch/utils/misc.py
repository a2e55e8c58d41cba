"""Small tensor utilities (port of ``imaginaire_tpu/utils/misc.py``).

Tensors are NCHW here. The resize helpers reproduce
``jax.image.resize``, which the JAX package calls, rather than torch's
defaults where the two differ:

- ``nearest`` samples at half-pixel centres: torch ``nearest-exact``
  (torch ``nearest`` drops the half pixel and picks other rows when
  shrinking, e.g. 8 pixels apart at 256 -> 16);
- ``bilinear`` antialiases when it shrinks: the triangle kernel widens
  by the shrink factor. torch's ``antialias=True`` computes the same,
  but on CUDA it refuses large factors (the vid2vid label map shrinks
  128x), so it is computed here as two weight matrices;
- ``cubic`` is Keys' kernel with a = -0.5, where torch's ``bicubic``
  uses a = -0.75, so it is computed here as two weight matrices too.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def apply_imagenet_normalization(x):
    """[-1, 1] NCHW images -> imagenet-normalized, in x's type; only the
    first 3 channels are kept."""
    x = (x[:, :3] + 1.0) * 0.5
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when the GPU is asked for and absent; there is
    no silent fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return device


@contextlib.contextmanager
def fp32_matmuls():
    """Run the enclosed CUDA matmuls in full fp32 (TF32 off), then restore
    the caller's setting. The flag is process-wide."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def resize_nearest(x, hw):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


def upsample_2x(x):
    """2x nearest upsample of an NCHW tensor."""
    h, w = x.shape[-2:]
    return resize_nearest(x, (2 * h, 2 * w))


def _triangle(t):
    return np.maximum(0.0, 1.0 - np.abs(t))


def _keys_cubic(t):
    t = np.abs(t)
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = np.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return np.where(t >= 2.0, 0.0, out)


def _resize_weights(in_size, out_size, kernel):
    """(out, in) weights of ``jax.image.resize`` along one axis
    (``scale_and_translate`` with antialiasing: the kernel widens by
    in/out when shrinking)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    w = kernel(dist)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0)


def _resize_separable(x, hw, kernel):
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    wy = torch.as_tensor(_resize_weights(h, hw[0], kernel), dtype=x.dtype,
                         device=x.device)
    wx = torch.as_tensor(_resize_weights(w, hw[1], kernel), dtype=x.dtype,
                         device=x.device)
    return torch.einsum("yh,nchw,xw->ncyx", wy, x, wx)


def resize_bilinear(x, hw):
    """Antialiased bilinear (triangle-kernel) resize of an NCHW tensor."""
    return _resize_separable(x, hw, _triangle)


def resize_cubic(x, hw):
    """Keys-cubic (a = -0.5) resize of an NCHW tensor to ``hw``."""
    return _resize_separable(x, hw, _keys_cubic)


def nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def numeric_only(tree):
    """Drop non-array entries (sample keys, filenames) from a data dict.
    Recurses into dicts only; a list of strings is dropped whole."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = numeric_only(v)
        elif isinstance(v, (str, bytes)):
            continue
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], (str, bytes)):
            continue
        else:
            out[k] = v
    return out


def random_shift_offsets(shape, generator=None, offset=0.05, device=None):
    """The (oy, ox) draws of ``random_shift`` for an NCHW ``shape``: per
    sample, integers in [0, 2 m] with m = max(1, int(offset * size))."""
    b, _, h, w = shape
    mh, mw = max(1, int(offset * h)), max(1, int(offset * w))
    oy = torch.randint(0, 2 * mh + 1, (b,), generator=generator, device=device)
    ox = torch.randint(0, 2 * mw + 1, (b,), generator=generator, device=device)
    return oy, ox


def random_shift(x, offsets, offset=0.05):
    """Translate each NCHW image by whole pixels: reflect-pad by m =
    max(1, int(offset * size)) a side, then take the window at (oy, ox)
    of ``offsets`` (``random_shift_offsets``), as the JAX package's
    ``random_shift`` does with its drawn offsets."""
    b, c, h, w = x.shape
    mh, mw = max(1, int(offset * h)), max(1, int(offset * w))
    pad = F.pad(x, (mw, mw, mh, mh), mode="reflect")
    oy, ox = (torch.as_tensor(o, device=x.device).long() for o in offsets)
    rows = (oy.view(b, 1) + torch.arange(h, device=x.device)).view(b, 1, h, 1)
    cols = (ox.view(b, 1) + torch.arange(w, device=x.device)).view(b, 1, 1, w)
    pad = pad.gather(2, rows.expand(b, c, h, pad.shape[-1]))
    return pad.gather(3, cols.expand(b, c, h, w))


def gradient_penalty(d_apply, images):
    """E[||grad_x D(x)||^2]: the squared L2 norm of the gradient of the
    sum of D's outputs (a tensor or a list of them) with respect to each
    sample of ``images``, averaged over the batch. The graph is kept
    (``create_graph``), so the penalty trains D."""
    images = images.detach().requires_grad_(True)
    out = d_apply(images)
    if isinstance(out, (list, tuple)):
        total = sum(o.sum() for o in out)
    else:
        total = out.sum()
    grads, = torch.autograd.grad(total, images, create_graph=True)
    return grads.square().sum(dim=tuple(range(1, grads.dim()))).mean()
