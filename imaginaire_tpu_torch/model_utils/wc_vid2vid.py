"""World-consistent vid2vid utilities (port of
``imaginaire_tpu/model_utils/wc_vid2vid.py``; numpy, the port's own copy).

The SplatRenderer keeps one color per point of a structure-from-motion
point cloud: each generated frame colors the points it sees for the
first time, and later frames render those colors back as a guidance
image and a validity mask. The point cloud is ragged and data-dependent,
so it stays on the host; the generator reads only the dense (B, 4, H, W)
guidance tensor the trainer builds from ``guidance_tensor``.
"""

from __future__ import annotations

import pickle

import numpy as np


class SplatRenderer:
    """Per-point colors (uint8), seen flags and the frame that first saw
    each point."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.colors = np.zeros((0, 3), np.uint8)
        self.seen_mask = np.zeros((0, 1), np.uint8)
        self.seen_time = np.zeros((0, 1), np.uint16)
        self.call_idx = 0

    def num_points(self):
        return int(self.seen_mask.sum())

    def _ensure_capacity(self, max_point_idx):
        """Grow the per-point arrays to ``max_point_idx`` rows."""
        n = self.colors.shape[0]
        if max_point_idx <= n:
            return
        grow = max_point_idx - n
        self.colors = np.concatenate([self.colors, np.zeros((grow, 3), np.uint8)])
        self.seen_mask = np.concatenate([self.seen_mask, np.zeros((grow, 1), np.uint8)])
        self.seen_time = np.concatenate([self.seen_time, np.zeros((grow, 1), np.uint16)])

    def update_point_cloud(self, image, point_info):
        """Color the points of ``point_info`` ((N, 3) rows of (i, j,
        point_idx)) that no earlier frame saw, from ``image`` ((H, W, 3)
        uint8)."""
        if point_info is None or len(point_info) == 0:
            return
        self.call_idx += 1
        point_info = np.asarray(point_info)
        i, j, idx = point_info[:, 0], point_info[:, 1], point_info[:, 2]
        self._ensure_capacity(int(idx.max()) + 1)
        unseen = self.seen_mask[idx, 0] == 0
        self.colors[idx[unseen]] = image[i[unseen], j[unseen]]
        self.seen_time[idx[unseen]] = self.call_idx
        self.seen_mask[idx] = 1

    def render_image(self, point_info, w, h, return_mask=False):
        """The known colors of the points of ``point_info`` painted into
        an (h, w, 3) uint8 canvas (and an (h, w, 1) mask, 255 where a
        seen point lands)."""
        output = np.zeros((h, w, 3), np.uint8)
        mask = np.zeros((h, w, 1), np.uint8)
        if point_info is not None and len(point_info):
            point_info = np.asarray(point_info)
            i, j, idx = point_info[:, 0], point_info[:, 1], point_info[:, 2]
            self._ensure_capacity(int(idx.max()) + 1)
            output[i, j] = self.colors[idx]
            mask[i, j] = 255 * self.seen_mask[idx]
        if return_mask:
            return output, mask
        return output


def guidance_tensor(renderer, point_info, w, h, flipped=False):
    """The rendered guidance as a float32 (h, w, 4) array: RGB in [-1, 1]
    and the validity mask in [0, 1]; mirrored left-right when the frame
    was flipped."""
    image, mask = renderer.render_image(point_info, w, h, return_mask=True)
    if flipped:
        image = np.fliplr(image).copy()
        mask = np.fliplr(mask).copy()
    image = image.astype(np.float32) / 255.0 * 2.0 - 1.0
    mask = mask.astype(np.float32) / 255.0
    return np.concatenate([image, mask], axis=-1)


def decode_unprojections(data):
    """Unpickle per-frame pixel-to-point mappings into ``{resolution:
    (T, N, 3) int64 array}``. Each frame pickles ``{resolution: flat [i,
    j, point_idx, ...] list}``; every resolution gets an entry for every
    frame (an empty mapping where the frame lacks the key), frames are
    right-padded with -1 rows to the longest mapping, and a last ``(n,
    n, n)`` row carries the frame's real row count, which the trainer's
    ``_point_info`` strips the padding by. The ``convert::`` data op of
    the ``unprojections`` type (``ext: pkl``)."""
    decoded = [pickle.loads(item) for item in data]
    resolutions = sorted({r for info in decoded for r in info})
    per_res = {r: [list(info.get(r) or []) for info in decoded] for r in resolutions}
    outputs = {}
    for resolution, frames in per_res.items():
        max_len = max((len(v) for v in frames), default=0)
        padded = [v + [-1] * (max_len - len(v)) + [len(v) // 3] * 3 for v in frames]
        outputs[resolution] = np.stack(
            [np.asarray(p, np.int64).reshape(-1, 3) for p in padded])
    return outputs
