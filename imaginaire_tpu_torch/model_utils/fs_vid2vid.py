"""vid2vid / fs-vid2vid model utilities (port of the parts of
``imaginaire_tpu/model_utils/fs_vid2vid.py`` that vid2vid and
fs-vid2vid run).

Frame buffers are (B, T, C, H, W), time at dim 1, NCHW frames. The face
crop (``crop_face_from_data``) is a data op on the host: numpy frames,
channel last.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imaginaire_tpu_torch.ops.resample2d import resample2d


def resample(image, flow):
    """Warp ``image`` (B, C, H, W) by pixel-unit ``flow`` (B, 2, H, W),
    channel 0 = dx. The kernel takes contiguous tensors; a frame sliced
    out of a (B, T, ...) ring is not one when B > 1."""
    return resample2d(image.contiguous(), flow.contiguous())


def pick_image(images, idx):
    """One of N reference frames a sample: images (B, N, C, H, W) (or a
    list of such, each picked), ``idx`` None (the first), an int, or a
    (B,) tensor of indices."""
    if isinstance(images, list):
        return [pick_image(r, idx) for r in images]
    if images is None:
        return None
    if idx is None:
        return images[:, 0]
    if isinstance(idx, int):
        return images[:, idx]
    idx = idx.reshape(-1).long()
    return images[torch.arange(images.shape[0], device=images.device), idx]


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


def get_face_bbox_for_data(keypoints, orig_img_size, scale, is_inference,
                           rng=None):
    """The square face crop [y0, y1, x0, x1] around (N, 2) landmarks and
    the scale drawn for it. In training the box is jittered: an offset
    in [-0.2, 0.2] of its size along x then y, then (when ``scale`` is
    None) a scale in [0.8, 1.2] along x then y, drawn from ``rng`` (the
    item's ``random.Random``) in the JAX package's order (which draws
    from ``np.random``)."""
    keypoints = np.asarray(keypoints)
    min_y, max_y = int(keypoints[:, 1].min()), int(keypoints[:, 1].max())
    min_x, max_x = int(keypoints[:, 0].min()), int(keypoints[:, 0].max())
    x_cen, y_cen = (min_x + max_x) // 2, (min_y + max_y) // 2
    H, W = orig_img_size
    w = h = max(max_x - min_x, 1)
    if not is_inference:
        if rng is None:
            raise ValueError("a training face crop draws its jitter from the "
                             "item's rng")
        offset = [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2)]
        if scale is None:
            scale = [rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2)]
        w = int(w * scale[0])
        h = int(h * scale[1])
        x_cen += int(offset[0] * w)
        y_cen += int(offset[1] * h)
    # ~2.5x the landmark extent, clamped to the frame
    w = h = int(max(w, h) * 1.25)
    x_cen = min(max(x_cen, w), W - w)
    y_cen = min(max(y_cen, h), H - h)
    y0, y1 = max(y_cen - h, 0), min(y_cen + h, H)
    x0, x1 = max(x_cen - w, 0), min(x_cen + w, W)
    return [y0, y1, x0, x1], scale


def crop_and_resize(arrays, crop_coords, size, method="bilinear"):
    """Crop each (T, H, W, C) stack (or list of HWC frames) to
    ``crop_coords`` and resize it to ``size`` with the port's twin of
    ``cv2.resize`` (``data/augment.py``); None entries pass through."""
    from imaginaire_tpu_torch.data.augment import resize

    interp = "NEAREST" if str(method).lower().startswith("nearest") else "BILINEAR"
    y0, y1, x0, x1 = crop_coords
    out = []
    for arr in arrays:
        if arr is None:
            out.append(None)
            continue
        frames = []
        for f in arr:
            f = np.asarray(f)
            if f.ndim == 2:
                f = f[:, :, None]
            frames.append(resize(np.ascontiguousarray(f[y0:y1, x0:x1]), size, interp))
        out.append(np.stack(frames))
    return out


def crop_face_from_data(cfg, is_inference, data, rng=None):
    """The full-data op of the face datasets: crop every frame of the
    item's data types to the face box of its first frame's landmarks
    (``landmarks-dlib68_xy``, the augmented coordinates) and resize it
    to ``cfg.output_h_w`` (bilinear). ``data`` holds a list of HWC
    frames a data type; the frames stay lists, so the dataset normalizes
    them after. The JAX op crops only the images and a ``label`` entry,
    which its dataset assembles later, and returns the images stacked
    as uint8, which skips their normalization (ROADMAP.md, section C):
    the port crops every type with the same box, as the reference
    project does. The reference window of a few-shot item is an item of
    its own, with its own box and draws."""
    landmarks = data.get("landmarks-dlib68_xy")
    if landmarks is None:
        return data
    from imaginaire_tpu_torch.config import cfg_get

    h, w = [int(v) for v in str(cfg_get(cfg, "output_h_w", "256,256")).split(",")]
    img_size = np.asarray(data["images"][0]).shape[:2]
    crop_coords, _ = get_face_bbox_for_data(np.asarray(landmarks)[0], img_size, None,
                                            is_inference, rng=rng)
    for key, frames in list(data.items()):
        if isinstance(frames, list) and frames and np.asarray(frames[0]).ndim >= 2:
            data[key] = list(crop_and_resize([frames], crop_coords, (h, w))[0])
    return data
