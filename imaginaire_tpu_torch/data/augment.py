"""Config-driven augmentation (port of ``imaginaire_tpu/data/augment.py``).

The same keys, in the same order, applied jointly to every data type of
an item: ``resize_smallest_side``, ``resize_h_w``,
``random_resize_h_w_aspect``, ``random_scale_limit``,
``rotate``, ``random_rotate_90``, ``random_crop_h_w``,
``center_crop_h_w`` and ``horizontal_flip``. Keypoint data types ((N,
2+) coordinate arrays, e.g. facial landmarks) are not resampled but
moved by the same resizes, quarter turns, crop and flip; a keypoint type
under ``rotate`` raises (not in the port yet). Types whose frames are
not arrays (pickled unprojections) pass through untouched.

Random draws come from an explicit ``random.Random`` (the dataset makes
one an item), in the JAX package's order: scale, rotation, rot90, crop,
flip. The JAX package draws them from the global ``random`` module;
handing the port ``random.Random(s)`` reproduces ``random.seed(s)``
there.

Resizing reproduces ``cv2.resize`` (the JAX package's), computed here in
numpy because the GPU machine has no OpenCV: ``dsize`` is (w, h);
``NEAREST`` takes source index ``floor(i * in / out)``; ``BILINEAR`` on
uint8 uses half-pixel centres, 11-bit fixed-point weights and OpenCV's
vectorized rounding of the vertical pass, and an exact halving averages
2x2 blocks as OpenCV does.

``rotate: r`` turns the frame by an angle drawn uniformly in [-r, r]
degrees about its centre, as ``cv2.getRotationMatrix2D((w / 2, h / 2),
angle, 1)`` and ``cv2.warpAffine`` with the type's interpolator and a
constant 0 border do (the JAX package's): the source coordinates in fp32
from the inverted matrix, each a fused multiply-add of fp32 operands,
then the taps' fp32 lerps (a tap outside the frame reads 0) rounded to
the nearest integer. It lands within one 8-bit level of OpenCV 5's
``warpAffine``. Only the ``BILINEAR`` interpolator rotates in the port
yet: at ``NEAREST`` a rounding tie can pick the neighbouring pixel.

The teacher flow cache reads two things of each call, kept per thread
(the loader's threads share one augmentor): ``last_record``, the call's
spatial draw (``canonical_hw``, ``crop``, ``hflip``, ``canonical_ok``),
and ``last_canonical``, the frames of the ``capture_canonical_types``
at the canonical resolution: after the leading resizes, before the
first op that is not one. ``canonical_ok`` holds when what follows is
crops and flips only, which the cache replays on a cached flow.
"""

from __future__ import annotations

import threading

import numpy as np

_INTERPOLATORS = ("NEAREST", "BILINEAR")
_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE


def _parse_hw(value):
    h, w = str(value).split(",")
    return int(h), int(w)


def deterministic_resize_chain(aug_cfg, hw):
    """The resize ops a sample of original size ``hw`` always receives
    from ``aug_cfg``: (ops, (h, w), deterministic); ``deterministic`` is
    False when the config also draws a random resize per sample
    (``random_resize_h_w_aspect``, or ``random_scale_limit`` with
    ``resize_smallest_side``), so no resolution is canonical."""
    cfg = dict(aug_cfg or {})
    h, w = hw
    ops = []
    if "resize_smallest_side" in cfg:
        s = int(cfg["resize_smallest_side"])
        scale = s / min(h, w)
        h, w = int(round(h * scale)), int(round(w * scale))
        ops.append(("resize", (h, w)))
    if "resize_h_w" in cfg:
        h, w = _parse_hw(cfg["resize_h_w"])
        ops.append(("resize", (h, w)))
    deterministic = not ("random_resize_h_w_aspect" in cfg
                         or ("random_scale_limit" in cfg
                             and "resize_smallest_side" in cfg))
    return ops, (h, w), deterministic


# ------------------------------------------------------------ resizing


def _nearest_index(n_in, n_out):
    step = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out) * step).astype(np.int64),
                      n_in - 1)


def _linear_taps(n_in, n_out, clamp):
    """Source taps and (1 - f, f) weights along one axis: OpenCV computes
    the position in fp64, rounds it to fp32, and clamps the weights at
    the borders along x only (``clamp``); along y it clamps the rows."""
    pos = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    s = np.floor(pos).astype(np.int64)
    f = (pos - s.astype(np.float32)).astype(np.float32)
    if clamp:
        f[(s < 0) | (s >= n_in - 1)] = 0
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            (np.float32(1) - f).astype(np.float32), f)


def _resize_linear(img, h, w):
    src_h, src_w, _ = img.shape
    x0, x1, a0, a1 = _linear_taps(src_w, w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(src_h, h, clamp=False)
    if img.dtype == np.uint8:
        a0, a1, b0, b1 = (np.rint(c * np.float32(_COEF_SCALE)).astype(np.int32)
                          for c in (a0, a1, b0, b1))
        src = img.astype(np.int32)
    else:
        src = img.astype(np.float32)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    r0, r1 = rows[y0], rows[y1]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    if img.dtype != np.uint8:
        return (r0 * b0 + r1 * b1).astype(img.dtype)
    # OpenCV's vector path: (((r >> 4) * b) >> 16) per row, summed, then
    # rounded by 2 bits and saturated
    out = (((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def resize(img, hw, interpolator):
    """``cv2.resize(img, (w, h), interpolation=...)`` of an (H, W, C)
    array, keeping the channel axis."""
    h, w = hw
    if img.shape[:2] == (h, w):
        return img.copy()
    if interpolator == "NEAREST":
        return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]
    if interpolator not in (None, "BILINEAR"):
        raise NotImplementedError(
            f"interpolator {interpolator!r} is not in the port yet "
            f"(ROADMAP.md); it has {_INTERPOLATORS}")
    if img.dtype == np.uint8 and img.shape[0] == 2 * h and img.shape[1] == 2 * w:
        # OpenCV turns an exact halving into its area average
        blocks = img.reshape(h, 2, w, 2, -1).astype(np.int32).sum(axis=(1, 3))
        return ((blocks + 2) >> 2).astype(np.uint8)
    return _resize_linear(img, h, w)


# ------------------------------------------------------------ rotation


def rotation_matrix(center, angle):
    """``cv2.getRotationMatrix2D(center, angle, 1.0)``: (2, 3) float64,
    ``angle`` in degrees, counter-clockwise."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a), np.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m):
    """``cv2.invertAffineTransform``."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def rotate(img, angle, interpolator):
    """``cv2.warpAffine(img, getRotationMatrix2D((w / 2, h / 2), angle,
    1), (w, h), flags=...)`` of an (H, W, C) array, constant 0 border."""
    if interpolator not in (None, "BILINEAR"):
        raise NotImplementedError(
            f"rotate with the {interpolator!r} interpolator is not in the port "
            f"yet (ROADMAP.md); it rotates BILINEAR")
    h, w = img.shape[:2]
    inv = _invert_affine(rotation_matrix((w / 2, h / 2), angle))
    inv = inv.astype(np.float32).astype(np.float64)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    # x * m0 + (y * m1 + m2), each a fused multiply-add rounded to fp32
    src_x, src_y = (
        (inv[i, 0] * xs + (inv[i, 1] * ys + inv[i, 2]).astype(np.float32)).astype(np.float32)
        for i in (0, 1))

    def tap(y, x):
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        return img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)] * inside[..., None]

    x0, y0 = np.floor(src_x), np.floor(src_y)
    ax = (src_x - x0).astype(np.float64)[..., None]
    ay = (src_y - y0).astype(np.float64)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    p00, p01 = tap(y0, x0).astype(np.float32), tap(y0, x0 + 1).astype(np.float32)
    p10, p11 = tap(y0 + 1, x0).astype(np.float32), tap(y0 + 1, x0 + 1).astype(np.float32)
    # each lerp a fused multiply-add rounded to fp32
    top = (p00 + ax * (p01 - p00)).astype(np.float32)
    bottom = (p10 + ax * (p11 - p10)).astype(np.float32)
    out = (top + ay * (bottom - top)).astype(np.float32)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


# --------------------------------------------------------- augmentor


class Augmentor:
    def __init__(self, aug_cfg, interpolators=None, keypoint_data_types=None):
        self.cfg = dict(aug_cfg or {})
        self.interpolators = dict(interpolators or {})
        self.keypoint_data_types = list(keypoint_data_types or [])
        if float(self.cfg.get("rotate", 0) or 0) and self.keypoint_data_types:
            raise NotImplementedError(
                f"augmentations.rotate with keypoint data types "
                f"{self.keypoint_data_types} is not in the port yet (ROADMAP.md)")
        self.max_time_step = int(self.cfg.get("max_time_step", 1))
        self.capture_canonical_types = set()
        self._tls = threading.local()

    @property
    def last_record(self):
        """The spatial draw of this thread's last call: ``original_hw``,
        ``canonical_hw`` (after every resize), ``crop`` ((top, left, h,
        w) in canonical pixels, or None), ``hflip``, ``canonical_ok`` and
        ``resize_deterministic``."""
        return getattr(self._tls, "record", None)

    @property
    def last_canonical(self):
        """{data_type: [canonical HWC frames]} of this thread's last call,
        for the ``capture_canonical_types`` (empty unless the record's
        ``canonical_ok``)."""
        return getattr(self._tls, "canonical", {})

    def perform_augmentation(self, inputs, rng):
        """inputs: {data_type: [HWC arrays]}; ``rng``: the item's
        ``random.Random``. Returns (outputs, is_flipped); one draw is
        applied to every type and frame."""
        first = next(v for t, v in inputs.items()
                     if t not in self.keypoint_data_types and _spatial(v))[0]
        original_hw = tuple(first.shape[:2])
        cfg = self.cfg
        ops, (h, w), resize_deterministic = deterministic_resize_chain(cfg, original_hw)
        if "random_resize_h_w_aspect" in cfg:
            bh, bw = _parse_hw(cfg["random_resize_h_w_aspect"])
            aspect = 1.0 + rng.uniform(0, float(cfg.get("random_scale_limit", 0.2)))
            h, w = int(round(bh * aspect)), int(round(bw * aspect))
            ops.append(("resize", (h, w)))
        elif "random_scale_limit" in cfg and "resize_smallest_side" in cfg:
            scale = 1.0 + rng.uniform(0, float(cfg["random_scale_limit"]))
            h, w = int(round(h * scale)), int(round(w * scale))
            ops.append(("resize", (h, w)))
        rotation = float(cfg.get("rotate", 0) or 0)
        if rotation:
            ops.append(("rotate", rng.uniform(-rotation, rotation)))
        if cfg.get("random_rotate_90", False):
            ops.append(("rot90", rng.randint(0, 3)))
        crop = None
        if "random_crop_h_w" in cfg:
            ch, cw = _parse_hw(cfg["random_crop_h_w"])
            top = rng.randint(0, max(h - ch, 0))
            left = rng.randint(0, max(w - cw, 0))
            crop = (top, left, ch, cw)
        elif "center_crop_h_w" in cfg:
            ch, cw = _parse_hw(cfg["center_crop_h_w"])
            crop = (max(h - ch, 0) // 2, max(w - cw, 0) // 2, ch, cw)
        if crop:
            ops.append(("crop", crop))
        is_flipped = bool(cfg.get("horizontal_flip", False)) and rng.random() < 0.5
        if is_flipped:
            ops.append(("hflip", None))
        cut = next((i for i, (op, _) in enumerate(ops) if op != "resize"), len(ops))
        canonical_ok = all(op in ("crop", "hflip") for op, _ in ops[cut:])
        self._tls.record = {"original_hw": original_hw, "canonical_hw": (h, w),
                            "crop": crop, "hflip": is_flipped,
                            "canonical_ok": canonical_ok,
                            "resize_deterministic": resize_deterministic}
        canonical, out = {}, {}
        for data_type, frames in inputs.items():
            if data_type in self.keypoint_data_types:
                out[data_type] = [_apply_keypoints(f, ops, original_hw) for f in frames]
                continue
            if not _spatial(frames):
                # non-spatial payloads (pickled unprojections) pass through
                # untouched; a post-augmentation op decodes them
                out[data_type] = frames
                continue
            interp = self.interpolators.get(data_type)
            if canonical_ok and data_type in self.capture_canonical_types:
                # the chain in two halves: the output is the same arrays
                pre = [self._apply(f, ops[:cut], interp) for f in frames]
                canonical[data_type] = pre
                out[data_type] = [self._apply(f, ops[cut:], interp) for f in pre]
            else:
                out[data_type] = [self._apply(f, ops, interp) for f in frames]
        self._tls.canonical = canonical
        return out, is_flipped

    def geometry(self):
        """The last call's geometry as the JAX augmentor exposes it to
        ``vis::`` ops: (resize_h, resize_w, crop_h, crop_w, original_h,
        original_w, is_flipped), the resize size being the crop's when
        there is one."""
        rec = self.last_record
        crop_hw = tuple(rec["crop"][2:]) if rec["crop"] else tuple(rec["canonical_hw"])
        return crop_hw + crop_hw + tuple(rec["original_hw"]) + (rec["hflip"],)

    @staticmethod
    def _apply(img, ops, interp):
        if img.ndim == 2:
            img = img[:, :, None]
        for op, arg in ops:
            if op == "resize":
                img = resize(img, arg, interp)
            elif op == "rotate":
                img = rotate(img, arg, interp)
            elif op == "rot90":
                img = np.rot90(img, arg)
            elif op == "crop":
                top, left, ch, cw = arg
                img = img[top:top + ch, left:left + cw]
            elif op == "hflip":
                img = img[:, ::-1]
        return np.ascontiguousarray(img)


def _spatial(frames):
    """Whether a type's frames are arrays (images, maps), not payloads."""
    return not frames or hasattr(frames[0], "shape")


def _apply_keypoints(pts, ops, original_hw):
    """Move (N, 2[+extra]) xy coordinates through the image ops; the
    extra columns (OpenPose's confidence) are kept. OpenPose frames are
    dicts of keypoint groups (``pose``, ``face``, ``hand_l``,
    ``hand_r``; ``utils/visualization/pose.py:openpose_to_npy``), or,
    with every person kept, lists of such dicts: each group of each
    person moves."""
    if isinstance(pts, dict):
        return {k: _apply_keypoints(v, ops, original_hw) for k, v in pts.items()}
    if isinstance(pts, list):
        return [_apply_keypoints(p, ops, original_hw) for p in pts]
    if pts is None:
        return None
    pts = np.asarray(pts, np.float32).copy()
    if pts.ndim != 2 or pts.shape[-1] < 2:
        return pts
    h, w = original_hw
    for op, arg in ops:
        if op == "resize":
            nh, nw = arg
            pts[:, 0] *= nw / max(w, 1)
            pts[:, 1] *= nh / max(h, 1)
            h, w = nh, nw
        elif op == "rot90":
            for _ in range(arg):
                x, y = pts[:, 0].copy(), pts[:, 1].copy()
                pts[:, 0], pts[:, 1] = y, w - 1 - x
                h, w = w, h
        elif op == "crop":
            top, left, ch, cw = arg
            pts[:, 0] -= left
            pts[:, 1] -= top
            h, w = ch, cw
        elif op == "hflip":
            pts[:, 0] = w - 1 - pts[:, 0]
    return pts
