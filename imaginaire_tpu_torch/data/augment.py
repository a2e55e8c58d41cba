"""Config-driven augmentation (port of ``imaginaire_tpu/data/augment.py``).

The same keys, in the same order, applied jointly to every data type of
an item: ``resize_smallest_side``, ``resize_h_w``,
``random_resize_h_w_aspect``, ``random_scale_limit``,
``random_rotate_90``, ``random_crop_h_w``, ``center_crop_h_w`` and
``horizontal_flip``. ``rotate`` other than 0 and keypoint data types
raise until a later slice; ``rotate: 0`` is the identity, as in the JAX
package.

Random draws come from an explicit ``random.Random`` (the dataset makes
one an item), in the JAX package's order: scale, rot90, crop, flip. The
JAX package draws them from the global ``random`` module; handing the
port ``random.Random(s)`` reproduces ``random.seed(s)`` there.

Resizing reproduces ``cv2.resize`` (the JAX package's), computed here in
numpy because the GPU machine has no OpenCV: ``dsize`` is (w, h);
``NEAREST`` takes source index ``floor(i * in / out)``; ``BILINEAR`` on
uint8 uses half-pixel centres, 11-bit fixed-point weights and OpenCV's
vectorized rounding of the vertical pass, and an exact halving averages
2x2 blocks as OpenCV does.
"""

from __future__ import annotations

import numpy as np

_INTERPOLATORS = ("NEAREST", "BILINEAR")
_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE


def _parse_hw(value):
    h, w = str(value).split(",")
    return int(h), int(w)


def deterministic_resize_chain(aug_cfg, hw):
    """The resize ops a sample of original size ``hw`` always receives
    from ``aug_cfg``: (ops, (h, w))."""
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
    return ops, (h, w)


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


# --------------------------------------------------------- augmentor


class Augmentor:
    def __init__(self, aug_cfg, interpolators=None, keypoint_data_types=None):
        self.cfg = dict(aug_cfg or {})
        self.interpolators = dict(interpolators or {})
        if keypoint_data_types:
            raise NotImplementedError(
                "keypoint data types are not in the port yet (ROADMAP.md)")
        if float(self.cfg.get("rotate", 0) or 0):
            raise NotImplementedError(
                f"augmentations.rotate={self.cfg['rotate']} is not in the "
                "port yet (ROADMAP.md); rotate: 0 is the identity")
        self.max_time_step = int(self.cfg.get("max_time_step", 1))

    def perform_augmentation(self, inputs, rng):
        """inputs: {data_type: [HWC arrays]}; ``rng``: the item's
        ``random.Random``. Returns (outputs, is_flipped); one draw is
        applied to every type and frame."""
        first = next(iter(inputs.values()))[0]
        cfg = self.cfg
        ops, (h, w) = deterministic_resize_chain(cfg, first.shape[:2])
        if "random_resize_h_w_aspect" in cfg:
            bh, bw = _parse_hw(cfg["random_resize_h_w_aspect"])
            aspect = 1.0 + rng.uniform(0, float(cfg.get("random_scale_limit", 0.2)))
            h, w = int(round(bh * aspect)), int(round(bw * aspect))
            ops.append(("resize", (h, w)))
        elif "random_scale_limit" in cfg and "resize_smallest_side" in cfg:
            scale = 1.0 + rng.uniform(0, float(cfg["random_scale_limit"]))
            h, w = int(round(h * scale)), int(round(w * scale))
            ops.append(("resize", (h, w)))
        if cfg.get("random_rotate_90", False):
            ops.append(("rot90", rng.randint(0, 3)))
        if "random_crop_h_w" in cfg:
            ch, cw = _parse_hw(cfg["random_crop_h_w"])
            top = rng.randint(0, max(h - ch, 0))
            left = rng.randint(0, max(w - cw, 0))
            ops.append(("crop", (top, left, ch, cw)))
        elif "center_crop_h_w" in cfg:
            ch, cw = _parse_hw(cfg["center_crop_h_w"])
            ops.append(("crop", (max(h - ch, 0) // 2, max(w - cw, 0) // 2, ch, cw)))
        is_flipped = bool(cfg.get("horizontal_flip", False)) and rng.random() < 0.5
        if is_flipped:
            ops.append(("hflip", None))
        out = {}
        for data_type, frames in inputs.items():
            interp = self.interpolators.get(data_type)
            out[data_type] = [self._apply(f, ops, interp) for f in frames]
        return out, is_flipped

    @staticmethod
    def _apply(img, ops, interp):
        if img.ndim == 2:
            img = img[:, :, None]
        for op, arg in ops:
            if op == "resize":
                img = resize(img, arg, interp)
            elif op == "rot90":
                img = np.rot90(img, arg)
            elif op == "crop":
                top, left, ch, cw = arg
                img = img[top:top + ch, left:left + cw]
            elif op == "hflip":
                img = img[:, ::-1]
        return np.ascontiguousarray(img)
