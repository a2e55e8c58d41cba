"""Facial-landmark label maps (port of
``imaginaire_tpu/utils/visualization/face.py:14-171``).

Turns 68-point dlib landmarks into one-channel edge-sketch label maps:
each facial part's keypoint chains are fitted three points at a time by
a short curve (``interp_points``: a quadratic along the dominant axis,
a line for two points; scipy's ``curve_fit``) and rasterized with a
stroke ``max(1, resize_h // 256)`` pixels wide. Host-side numpy, run as
a ``vis::`` post-augmentation data op. The per-part distance transforms
(``for_face_dataset.add_distance_transform``) are not in the port yet.
"""

from __future__ import annotations

import warnings

import numpy as np

from imaginaire_tpu_torch.config import cfg_get

# the 68-landmark facial parts, each a list of keypoint-index chains
FACE_PART_LIST = [
    [list(range(0, 17))],                                   # contour
    [list(range(17, 22))],                                  # right eyebrow
    [list(range(22, 27))],                                  # left eyebrow
    [[28, 31], list(range(31, 36)), [35, 28]],              # nose
    [[36, 37, 38, 39], [39, 40, 41, 36]],                   # right eye
    [[42, 43, 44, 45], [45, 46, 47, 42]],                   # left eye
    [list(range(48, 55)), [54, 55, 56, 57, 58, 59, 48],
     list(range(60, 65)), [64, 65, 66, 67, 60]],            # mouth + tongue
]


def _quad(x, a, b, c):
    return a * x ** 2 + b * x + c


def _linear(x, a, b):
    return a * x + b


def interp_points(x, y):
    """Integer pixel coordinates of a curve fitted through the points
    (x, y), or (None, None) when the fit is degenerate or too curved."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if np.abs(np.diff(x)).max(initial=0) < np.abs(np.diff(y)).max(initial=0):
        curve_y, curve_x = interp_points(y, x)
        if curve_y is None:
            return None, None
        return curve_x, curve_y
    try:
        from scipy.optimize import curve_fit

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if len(x) < 3:
                popt, _ = curve_fit(_linear, x, y)
                fit = _linear
            else:
                popt, _ = curve_fit(_quad, x, y)
                fit = _quad
                if abs(popt[0]) > 1:
                    return None, None
    except Exception:
        return None, None
    if x[0] > x[-1]:
        x = x[::-1]
        y = y[::-1]
    curve_x = np.linspace(x[0], x[-1], int(round(x[-1] - x[0])))
    curve_y = fit(curve_x, *popt)
    return curve_x.astype(int), curve_y.astype(int)


def set_color(im, yy, xx, color):
    """Write ``color`` at (yy, xx); on a 3-channel image a crossing of an
    earlier stroke takes the average."""
    if not isinstance(color, (list, tuple)):
        color = [color] * 3
    if im.ndim == 3 and im.shape[2] == 3:
        if (im[yy, xx] == 0).all():
            im[yy, xx] = color
        else:
            im[yy, xx] = ((im[yy, xx].astype(float) + color) / 2).astype(np.uint8)
    else:
        im[yy, xx] = color[0]


def draw_edge(im, x, y, bw=1, color=(255, 255, 255), draw_end_points=False):
    """Rasterize the curve (x, y) with a stroke ``bw`` pixels to each side."""
    if x is None or np.size(x) == 0:
        return
    h, w = im.shape[:2]
    for i in range(-bw, bw):
        for j in range(-bw, bw):
            set_color(im, np.clip(y + i, 0, h - 1), np.clip(x + j, 0, w - 1), color)
    if draw_end_points:
        ends_y = np.array([y[0], y[-1]])
        ends_x = np.array([x[0], x[-1]])
        for i in range(-bw * 2, bw * 2):
            for j in range(-bw * 2, bw * 2):
                if i ** 2 + j ** 2 < 4 * bw ** 2:
                    set_color(im, np.clip(ends_y + i, 0, h - 1),
                              np.clip(ends_x + j, 0, w - 1), color)


def connect_face_keypoints(resize_h, resize_w, crop_h, crop_w, original_h,
                           original_w, is_flipped, cfgdata, keypoints, rng=None):
    """(T, 68, 2) landmark frames -> T (resize_h, resize_w, 1) float32
    edge maps in [0, 1]. ``for_face_dataset.add_upper_face`` mirrors the
    jaw contour above the brow line first. Draws nothing from ``rng``."""
    face_cfg = cfg_get(cfgdata, "for_face_dataset", None)
    add_upper_face = bool(cfg_get(face_cfg, "add_upper_face", False)) \
        if face_cfg is not None else False
    if face_cfg is not None and cfg_get(face_cfg, "add_distance_transform", False):
        raise NotImplementedError(
            "for_face_dataset.add_distance_transform is not in the port yet "
            "(ROADMAP.md)")
    part_list = [list(p) for p in FACE_PART_LIST]
    keypoints = np.asarray(keypoints, np.float32)
    if add_upper_face:
        part_list[0] = [list(range(0, 17)) + list(range(68, 83)) + [0]]
        pts = keypoints[:, :17].astype(np.int32)
        baseline_y = (pts[:, 0:1, 1] + pts[:, -1:, 1]) / 2
        upper = pts[:, 1:-1].copy()
        upper[:, :, 1] = baseline_y + (baseline_y - upper[:, :, 1]) * 2 // 3
        keypoints = np.concatenate([keypoints, upper[:, ::-1]], axis=1)

    edge_len = 3
    bw = max(1, resize_h // 256)
    outputs = []
    for t in range(keypoints.shape[0]):
        im_edges = np.zeros((resize_h, resize_w, 1), np.uint8)
        for part in part_list:
            for edge in part:
                for i in range(0, max(1, len(edge) - 1), edge_len - 1):
                    sub = list(edge)[i:i + edge_len]
                    cx, cy = interp_points(keypoints[t, sub, 0], keypoints[t, sub, 1])
                    draw_edge(im_edges, cx, cy, bw=bw)
        outputs.append(im_edges.astype(np.float32) / 255.0)
    return outputs
