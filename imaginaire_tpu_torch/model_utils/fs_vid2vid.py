"""vid2vid model utilities (port of the parts of
``imaginaire_tpu/model_utils/fs_vid2vid.py`` that vid2vid inference and
training run).

Frame buffers are (B, T, C, H, W), time at dim 1, NCHW frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def get_fg_mask(densepose_map, has_fg):
    """Foreground mask (B, 1, H, W) from a DensePose label map (B, C, H,
    W), or (B, T, C, H, W) whose first frame is taken: everything but
    the background part (channel 2 above -1 + 2/24), blurred by a 3x3
    box with zero padding; 1.0 without a foreground."""
    if not has_fg or densepose_map is None:
        return 1.0
    if densepose_map.dim() == 5:
        densepose_map = densepose_map[:, 0]
    mask = (densepose_map[:, 2:3] > -1.0 + 2.0 / 24.0).float()
    kernel = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=mask.device)
    return torch.clamp(F.conv2d(mask, kernel, padding=1), 0.0, 1.0)


def skip_stride_span(tD, scale):
    """(t_step, t_span) of temporal scale ``scale``: neighbouring frames
    tD**scale apart, and the distance a stack of tD frames covers."""
    t_step = tD ** scale
    return t_step, t_step * (tD - 1)
