"""vid2vid model utilities (port of the parts of
``imaginaire_tpu/model_utils/fs_vid2vid.py`` that vid2vid inference
runs).

Frame buffers are (B, T, C, H, W), time at dim 1, NCHW frames.
"""

from __future__ import annotations

import torch

from imaginaire_tpu_torch.ops.resample2d import resample2d


def resample(image, flow):
    """Warp ``image`` (B, C, H, W) by pixel-unit ``flow`` (B, 2, H, W),
    channel 0 = dx. The kernel takes contiguous tensors; a frame sliced
    out of a (B, T, ...) ring is not one when B > 1."""
    return resample2d(image.contiguous(), flow.contiguous())


def fold_time(x):
    """(B, T, C, H, W) -> (B, T*C, H, W), channel t*C + c: the JAX
    package's channel order, which its NHWC layout reaches only through
    a transpose."""
    b, t, c, h, w = x.shape
    return x.reshape(b, t * c, h, w)


def concat_frames(prev, now, n_frames):
    """Append frame ``now`` (B, C, H, W) to ``prev`` (B, T, C, H, W) or
    None, keeping the latest ``n_frames``."""
    now = now.unsqueeze(1)
    if prev is None:
        return now
    if prev.shape[1] == n_frames:
        prev = prev[:, 1:]
    return torch.cat([prev, now], dim=1)
