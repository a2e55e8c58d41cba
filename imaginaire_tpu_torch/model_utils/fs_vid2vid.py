"""vid2vid / fs-vid2vid model utilities (port of the parts of
``imaginaire_tpu/model_utils/fs_vid2vid.py`` that vid2vid and
fs-vid2vid run).

Frame buffers are (B, T, C, H, W), time at dim 1, NCHW frames. The face
and person crops (``crop_face_from_data``, ``crop_person_from_data``),
the bystander removal and the DensePose preprocessing are host ops on
numpy frames, channel last; ``extract_valid_pose_labels``, ``roll`` and
``random_roll`` act on the device's NCHW tensors.
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


def _target_person(openpose, ids):
    """(H, W) bool mask of the DensePose instance whose id (``ids``, (H,
    W) int) lies most often under the OpenPose strokes (the first 3
    channels of ``openpose`` above 0), or None where there is no stroke."""
    under = ids[np.any(openpose[..., :3] > 0, axis=-1)]
    return ids == np.bincount(under).argmax() if under.size else None


def remove_other_ppl(labels, densemasks):
    """Keep only the target person of (T, H, W, C) pose labels (DensePose
    in channels 0:3, OpenPose from 3): each frame is masked to the
    DensePose instance id (channel 0 of ``densemasks``, in [0, 1] of
    255) that lies most often under the OpenPose strokes; a frame with
    no stroke is kept whole."""
    labels = np.array(labels, copy=True)
    masks = (np.asarray(densemasks)[..., 0] * 255).astype(np.int64)
    for idx in range(labels.shape[0]):
        keep = _target_person(labels[idx][..., 3:], masks[idx])
        if keep is not None:
            labels[idx] = labels[idx] * keep[..., None]
    return labels


def get_person_bbox_for_data(pose_map, orig_img_size, scale=1.5,
                             crop_aspect_ratio=1.0, offset=None):
    """Pixel box [y0, y1, x0, x1] around the body of (T, H, W, C) pose
    maps (the support of channels 0:3 over all frames): its height the
    body's times ``scale``, at least half the frame's and at most the
    frame's, widened to the body's width times ``scale`` at the crop's
    aspect ratio, moved by ``offset`` (of the half sizes), its centre
    kept inside the frame. The width-driven box can overrun the frame:
    the caller clamps it. Without a body, a box of the frame's height in
    the middle."""
    h, w = orig_img_size
    pose_map = np.asarray(pose_map)
    ys, xs = np.nonzero(np.any(pose_map[..., :3] > 0, axis=(0, -1)))
    if ys.size == 0:
        bw = int(h * crop_aspect_ratio // 2)
        return [0, h, w // 2 - bw, w // 2 + bw]
    y_min, y_max = int(ys.min()), int(ys.max())
    x_min, x_max = int(xs.min()), int(xs.max())
    y_cen, x_cen = (y_min + y_max) // 2, (x_min + x_max) // 2
    y_len, x_len = y_max - y_min, x_max - x_min
    bh = int(min(h, max(h // 2, y_len * scale))) // 2
    bh = max(bh, int(x_len * scale / crop_aspect_ratio) // 2)
    bw = int(bh * crop_aspect_ratio)
    if offset is not None:
        x_cen += int(offset[0] * bw)
        y_cen += int(offset[1] * bh)
    x_cen = max(bw, min(w - bw, x_cen))
    y_cen = max(bh, min(h - bh, y_cen))
    return [y_cen - bh, y_cen + bh, x_cen - bw, x_cen + bw]


def crop_person_from_data(cfg, is_inference, data, rng=None):
    """The full-data op of the pose datasets: crop every frame of the
    item's data types to the person's box and resize it to
    ``cfg.output_h_w``, each type with its configured interpolator.

    The box comes from the DensePose maps (``pose_maps-densepose``);
    with ``human_instance_maps`` the bystanders are masked out of the
    DensePose and rendered OpenPose frames first (``remove_other_ppl``),
    and the instance maps leave the item. In training the box is
    jittered: an offset of N(0, 0.05) of its half sizes along x then y,
    then a scale of 1.5 + N(0, 0.05) within [1, 2], drawn from ``rng``
    (the item's ``random.Random``) in the JAX package's order (which
    draws from ``np.random``). The box is clamped to the frame before
    use, and the keypoint stashes (``<type>_xy``) move with it. At
    inference the box is read from ``data['common_attr']`` when the
    dataset threads one in (a later frame of a pinned sequence reuses
    its first frame's box) and left there for the next."""
    from imaginaire_tpu_torch.config import cfg_get

    dp_key = "pose_maps-densepose"
    if dp_key not in data:
        return data
    dp = np.stack([np.asarray(f, np.float32) for f in data[dp_key]])
    op_key = "pose_maps-openpose" if "pose_maps-openpose" in data else "poses-openpose"
    rendered_op = None
    if op_key in data and hasattr(data[op_key][0], "shape"):
        rendered_op = np.stack([np.asarray(f, np.float32) for f in data[op_key]])
    if "human_instance_maps" in data:
        # remove_other_ppl of (DensePose, OpenPose) frame by frame, in
        # place: the ids as that function reads them from the [0, 1] maps
        inst = [np.asarray(f, np.float32)[..., 0] for f in data["human_instance_maps"]]
        for t in range(len(dp)):
            keep = (_target_person(rendered_op[t], ((inst[t] / 255.0) * 255).astype(np.int64))
                    if rendered_op is not None else inst[t] > 0)
            if keep is not None:
                dp[t] *= keep[..., None]
                if rendered_op is not None:
                    rendered_op[t] *= keep[..., None]
        if rendered_op is not None:
            data[op_key] = list(rendered_op)
        data[dp_key] = list(dp)

    h, w = [int(v) for v in str(cfg_get(cfg, "output_h_w", "256,256")).split(",")]
    img_size = dp.shape[1:3]
    offset, scale = None, 1.5
    if not is_inference:
        if rng is None:
            raise ValueError("a training person crop draws its jitter from the "
                             "item's rng")
        offset = np.clip(np.array([rng.gauss(0.0, 1.0), rng.gauss(0.0, 1.0)]) * 0.05, -1, 1)
        scale = min(2, max(1, scale + rng.gauss(0.0, 1.0) * 0.05))
    common = data.get("common_attr") or {}
    if "crop_coords" in common:
        crop_coords = common["crop_coords"]
    else:
        crop_coords = get_person_bbox_for_data(dp, img_size, scale, w / h, offset)
    ih, iw = img_size
    y0, y1, x0, x1 = crop_coords
    y0, x0, y1, x1 = max(0, y0), max(0, x0), min(ih, y1), min(iw, x1)
    crop_coords = [y0, y1, x0, x1]
    interp_of = {}
    for entry in cfg_get(cfg, "input_types", []) or []:
        for name, props in dict(entry).items():
            interp_of[name] = str(cfg_get(props, "interpolator", "BILINEAR") or "BILINEAR")
    for t, frames in list(data.items()):
        if t == "human_instance_maps" or t.endswith("_xy") or t == "common_attr":
            continue
        if not isinstance(frames, (list, tuple)) or not frames \
                or not hasattr(frames[0], "shape") \
                or np.asarray(frames[0]).shape[:2] != tuple(img_size):
            continue
        method = "nearest" if interp_of.get(t, "").upper() == "NEAREST" else "bilinear"
        data[t] = list(crop_and_resize([frames], crop_coords, (h, w), method=method)[0])
    sy, sx = h / max(y1 - y0, 1), w / max(x1 - x0, 1)
    for t in list(data):
        if t.endswith("_xy") and hasattr(data[t], "shape"):
            pts = np.array(data[t], np.float32, copy=True)
            if pts.shape[-1] >= 2:
                pts[..., 0] = (pts[..., 0] - x0) * sx
                pts[..., 1] = (pts[..., 1] - y0) * sy
                data[t] = pts
    data.pop("human_instance_maps", None)
    if is_inference:
        data.setdefault("common_attr", {})["crop_coords"] = crop_coords
    return data


# the dataset threads ``common_attr`` through a pinned sequence for this op
crop_person_from_data.uses_common_attr = True


def pre_process_densepose(pose_cfg, pose_map, is_infer=False, rng=None):
    """DensePose preprocessing of (..., H, W, C) float pose labels in
    [0, 1] (DensePose's part index / 255 in channel 2), as host numpy:
    in training each of the 24 parts is dropped (channels 0:3 zeroed
    where it lies) with ``random_drop_prob``, one draw of ``rng`` a part
    in order (the JAX package draws from the global ``random``), then the
    part channel is scaled to [0, 1] over 24 parts and every channel to
    [-1, 1]."""
    from imaginaire_tpu_torch.config import cfg_get

    pose_map = np.array(pose_map, np.float32, copy=True)
    part_map = pose_map[..., 2] * 255.0
    random_drop_prob = 0 if is_infer else cfg_get(pose_cfg, "random_drop_prob", 0)
    if random_drop_prob > 0:
        if rng is None:
            raise ValueError("DensePose part drops draw from a given rng")
        for part_id in range(1, 25):
            if rng.random() < random_drop_prob:
                mask = np.abs(part_map - part_id) < 0.1
                pose_map[..., :3][mask] = 0.0
    pose_map[..., 2] = pose_map[..., 2] * (255.0 / 24.0)
    return pose_map * 2.0 - 1.0


def extract_valid_pose_labels(pose_map, pose_type, remove_face_labels, do_remove=True):
    """The pose label channels the generator reads, of an NCHW label
    (B, C, H, W) or (B, T, C, H, W) (or a list of such, or None):
    DensePose in channels 0:3, OpenPose after; ``pose_type`` 'open' keeps
    OpenPose alone; ``remove_face_labels`` (with ``do_remove``) sets the
    DensePose channels to -1 where the preprocessed part channel lies in
    (0.4, 0.6)."""
    if pose_map is None:
        return pose_map
    if isinstance(pose_map, list):
        return [extract_valid_pose_labels(p, pose_type, remove_face_labels, do_remove)
                for p in pose_map]
    c = pose_map.dim() - 3
    if pose_type == "open":
        return pose_map.narrow(c, 3, pose_map.shape[c] - 3)
    if remove_face_labels and do_remove:
        densepose = pose_map.narrow(c, 0, 3)
        part = densepose.narrow(c, 2, 1)
        face = (part > 0.4) & (part < 0.6)
        densepose = torch.where(face, torch.full_like(densepose, -1.0), densepose)
        return torch.cat([densepose, pose_map.narrow(c, 3, pose_map.shape[c] - 3)], dim=c)
    return pose_map


def roll(t, ny, nx, flip=False):
    """Roll (..., C, H, W) by (ny, nx) pixels, then flip it horizontally
    when ``flip``."""
    t = torch.roll(t, (ny, nx), dims=(-2, -1))
    return t.flip(-1) if flip else t


def random_roll(tensors, rng):
    """Roll every tensor of the list (..., C, H, W) by one draw of
    ``rng`` (a ``numpy.random.RandomState``; the JAX package draws from
    ``np.random``): a shift of up to H / 16 (W / 16) pixels from either
    edge, y then x, then a horizontal flip at even odds."""
    h, w = tensors[0].shape[-2:]
    ny = int(rng.choice([rng.randint(max(h // 16, 1)), h - rng.randint(max(h // 16, 1))]))
    nx = int(rng.choice([rng.randint(max(w // 16, 1)), w - rng.randint(max(w // 16, 1))]))
    flip = rng.rand() > 0.5
    return [roll(t, ny, nx, flip) for t in tensors]


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


# ----------------------------------------------------------------------
# Region crops of G's output for the additional (face, hand)
# discriminators. As in the JAX package, the shapes do not depend on the
# data: the boxes are reductions over the pose label on the device, the
# face box of any size is resampled to one fixed patch, and each hand is
# a fixed window; a sample whose region is absent gets a default box and
# a validity flag, so its losses are weighted out rather than skipped.
# Nothing here syncs with the host.


def _masked_minmax(mask):
    """(B, H, W) bool -> per-sample ys, ye, xs, xe, count (int64); an
    empty mask gives ys = xs = 2**30 and ye = xe = -1."""
    _, h, w = mask.shape
    yy = torch.arange(h, device=mask.device).view(1, h, 1)
    xx = torch.arange(w, device=mask.device).view(1, 1, w)
    big = 1 << 30
    ys = torch.where(mask, yy, big).amin(dim=(1, 2))
    ye = torch.where(mask, yy, -1).amax(dim=(1, 2))
    xs = torch.where(mask, xx, big).amin(dim=(1, 2))
    xe = torch.where(mask, xx, -1).amax(dim=(1, 2))
    return ys, ye, xs, xe, mask.sum(dim=(1, 2))


def _latest_frame(pose):
    return pose[:, -1] if pose.dim() == 5 else pose


def _use_openpose(data_cfg):
    from imaginaire_tpu_torch.config import cfg_get

    return "pose_maps-densepose" not in list(cfg_get(data_cfg, "input_labels", None) or [])


def _clip(x, lo, hi):
    """``jnp.clip``: the upper bound wins where the bounds cross."""
    return torch.minimum(torch.maximum(x, lo), hi)


def get_face_bbox_for_output(data_cfg, pose, crop_smaller=0):
    """Per-sample square face box [ys, ye, xs, xe] (B, 4) int64 from the
    pose label (B, C, H, W) or its last frame: OpenPose's one-hot face
    channel (the last) above 0.1, or DensePose's face parts (channel 2
    above 0.9). Its side is 2.5x the face's width (OpenPose; 1.25x the
    height for DensePose) within [32, min(H, W)], centred 2/5 down the
    face; without a face a box of side max(H // 32 * 8, 32) at (H / 4,
    W / 2). The box is shifted into the frame."""
    pose = _latest_frame(pose)
    _, _, h, w = pose.shape
    openpose = _use_openpose(data_cfg)
    mask = pose[:, -1] > 0.1 if openpose else pose[:, 2] > 0.9
    ys0, ye0, xs0, xe0, count = _masked_minmax(mask)
    xc = (xs0 + xe0) // 2
    if openpose:
        yc = (ys0 * 3 + ye0 * 2) // 5
        ylen = (xe0 - xs0) * 5 // 2
    else:
        yc = (ys0 + ye0) // 2
        ylen = (ye0 - ys0) * 5 // 4
    ylen = ylen.clamp(32, min(w, h))
    found = count > 0
    yc = torch.where(found, yc, h // 4)
    xc = torch.where(found, xc, w // 2)
    ylen = torch.where(found, ylen, max(h // 32 * 8, 32))
    half = ylen // 2
    yc = _clip(yc, half, h - 1 - half)
    xc = _clip(xc, half, w - 1 - half)
    return torch.stack([yc - half + crop_smaller, yc + half - crop_smaller,
                        xc - half + crop_smaller, xc + half - crop_smaller], dim=-1)


def _linear_resample_weights(in_size, out_size, scale, translation):
    """(B, in_size, out_size) weights of ``jax.image.scale_and_translate``
    along one axis (``method="linear"``, ``antialias=True``), per-sample
    ``scale`` and ``translation`` (B,) fp32: output pixel o samples input
    position (o + 0.5 - translation) / scale - 0.5 with a triangle kernel
    widened by 1 / scale when it shrinks; the taps' weights are
    normalized over the in-bounds taps, and an output that samples
    outside the input gets none."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)
    x = (sample_f[:, None, :] - torch.arange(in_size, dtype=torch.float32,
                                             device=dev)[None, :, None]).abs()
    weights = torch.clamp_min(1.0 - (x / kernel_scale[:, None, None]).abs(), 0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def crop_face_from_output(data_cfg, image, input_label, crop_smaller=0):
    """The face box of each sample of ``image`` (B, C, H, W; its last 3
    channels, or a list of such images) resampled to a fixed
    (max(H // 32 * 8, 8))² patch as the JAX package's
    ``jax.image.scale_and_translate(..., method="linear")`` does: it
    upsamples a small face and antialiases a large one. The per-sample
    (H, S) and (W, S) weight matrices (cast to the image's type, as
    there) are applied by two batched matrix products, through which
    G's gradient flows."""
    if isinstance(image, (list, tuple)):
        return [crop_face_from_output(data_cfg, im, input_label, crop_smaller)
                for im in image]
    boxes = get_face_bbox_for_output(data_cfg, input_label, crop_smaller)
    _, _, h, w = image.shape
    size = max(h // 32 * 8, 8)
    ys, ye, xs, xe = boxes.unbind(-1)
    sy = size / torch.clamp_min(ye - ys, 1).float()
    sx = size / torch.clamp_min(xe - xs, 1).float()
    wy = _linear_resample_weights(h, size, sy, -ys.float() * sy).to(image.dtype)
    wx = _linear_resample_weights(w, size, sx, -xs.float() * sx).to(image.dtype)
    rows = torch.matmul(wy.transpose(1, 2).unsqueeze(1), image[:, -3:])
    return torch.matmul(rows, wx.unsqueeze(1))


def get_hand_bbox_for_output(data_cfg, pose):
    """Centres (B, 2) y, (B, 2) x and validity (B, 2) bool of the two
    hands' fixed windows, [left, right]: OpenPose's one-hot hand channels
    (-3 left, -2 right) above 0.1, the middle of each hand's extent; a
    missing hand is centred in the frame and invalid. Centres are
    clipped so that the window (max(H // 64 * 8, 8))² lies in the frame."""
    pose = _latest_frame(pose)
    _, _, h, w = pose.shape
    half = max(h // 64 * 8, 8) // 2
    ycs, xcs, valids = [], [], []
    for idx in (-3, -2):
        ys0, ye0, xs0, xe0, count = _masked_minmax(pose[:, idx] > 0.1)
        found = count > 0
        yc = torch.where(found, (ys0 + ye0) // 2, h // 2)
        xc = torch.where(found, (xs0 + xe0) // 2, w // 2)
        ycs.append(yc.clamp(half, h - 1 - half))
        xcs.append(xc.clamp(half, w - 1 - half))
        valids.append(found)
    return torch.stack(ycs, -1), torch.stack(xcs, -1), torch.stack(valids, -1)


def crop_hand_from_output(data_cfg, image, input_label):
    """Both hands' windows of ``image`` (B, C, H, W; its last 3
    channels, or a list of such images): (crops (2B, 3, S, S), the left
    hands then the right, and their validity (2B,) float). The JAX
    package's ``lax.dynamic_slice`` windows, gathered on the device."""
    if isinstance(image, (list, tuple)):
        return [crop_hand_from_output(data_cfg, im, input_label) for im in image]
    ycs, xcs, valid = get_hand_bbox_for_output(data_cfg, input_label)
    b, _, h, w = image.shape
    size = max(h // 64 * 8, 8)
    offsets = torch.arange(size, device=image.device)
    batch = torch.arange(b, device=image.device).view(b, 1, 1)
    crops = []
    for i in range(2):
        top = (ycs[:, i] - size // 2).clamp(0, h - size)
        left = (xcs[:, i] - size // 2).clamp(0, w - size)
        rows = (top[:, None] + offsets).view(b, size, 1)
        cols = (left[:, None] + offsets).view(b, 1, size)
        crops.append(image[:, -3:].permute(0, 2, 3, 1)[batch, rows, cols].permute(0, 3, 1, 2))
    return torch.cat(crops, dim=0), torch.cat([valid[:, 0], valid[:, 1]]).float()
