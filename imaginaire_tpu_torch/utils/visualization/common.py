"""Tensor -> image conversions (port of
``imaginaire_tpu/utils/visualization/common.py``).

NHWC numpy in, uint8 out. Files are written as PNG through the port's
own codec (``data/png.py``), where the JAX package writes JPEG through
PIL: the machine with the card has no JPEG encoder.
"""

from __future__ import annotations

import numpy as np

from imaginaire_tpu_torch.data.png import write_png


def tensor2im(image, minus1to1_normalized=True):
    """(H, W, C) float in [-1, 1] (or [0, 1]) -> uint8 RGB."""
    img = np.asarray(image, dtype=np.float32)
    if minus1to1_normalized:
        img = (img + 1.0) / 2.0
    img = np.clip(img, 0.0, 1.0) * 255.0
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img[..., :3].astype(np.uint8)


def save_image_grid(images, path, cols=None):
    """Save HWC uint8 images as one strip / grid (PNG)."""
    images = [np.asarray(im) for im in images]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    cols = cols or len(images)
    rows = (len(images) + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, 3), dtype=np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im[..., :3]
    return write_png(path, canvas)


def save_tensor_strip(tensors, path):
    """(input, label, fake, ...) NHWC batches side by side, one row per
    batch element."""
    rows = []
    for batch in tensors:
        batch = np.asarray(batch)
        rows.append([tensor2im(batch[i]) for i in range(batch.shape[0])])
    images = [im for col in zip(*rows) for im in col]
    return save_image_grid(images, path, cols=len(tensors))
