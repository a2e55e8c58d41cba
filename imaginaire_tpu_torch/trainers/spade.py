"""SPADE trainer, serving half (port of the inference parts of
``imaginaire_tpu/trainers/spade.py``).

On top of the base trainer (``trainers/base.py``: device, seeded
weights, averaged inference weights) it expands integer label maps on
the device and rounds host arrays to the generator's base multiple. The
training methods, the discriminator and the losses come with the
training slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from imaginaire_tpu_torch.trainers.base import BaseTrainer
from imaginaire_tpu_torch.utils.data import (
    get_crop_or_resize_h_w,
    get_paired_input_label_channel_number,
)


class Trainer(BaseTrainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device=device)
        try:
            crop_h, crop_w = get_crop_or_resize_h_w(self.cfg.data.train.augmentations)
            self.base = {256: 16, 512: 32, 1024: 64}.get(min(crop_h, crop_w), 32)
        except (AttributeError, KeyError, ValueError):
            self.base = 32  # size-less config

    def _expand_labels(self, data):
        """One-hot for integer label maps: (B, H, W) ints -> (B, C, H, W)
        in the compute dtype, with ``label_float`` (non-mask label types
        such as edge maps, NCHW) concatenated after the one-hot channels.
        Float label tensors pass through."""
        label = data.get("label")
        if label is None or label.is_floating_point():
            return data
        n = get_paired_input_label_channel_number(self.cfg.data)
        extra = data.get("label_float")
        if extra is not None:
            n = n - extra.shape[1]
        onehot = F.one_hot(label.long(), n).permute(0, 3, 1, 2)
        onehot = onehot.to(self.compute_dtype)
        if extra is not None:
            onehot = torch.cat([onehot, extra.to(onehot.dtype)], dim=1)
        out = dict(data, label=onehot)
        out.pop("label_float", None)
        return out

    def _resize_data(self, data):
        """Round H/W of NHWC host arrays down to the generator's base
        multiple."""
        base = self.base
        out = dict(data)
        for key in ("label", "images", "label_float"):
            if key in out:
                arr = np.asarray(out[key])
                h, w = arr.shape[1:3]
                h2, w2 = (h // base) * base, (w // base) * base
                if (h2, w2) != (h, w):
                    out[key] = arr[:, :h2, :w2]
        return out
