"""Activation harness for the metrics (port of
``imaginaire_tpu/evaluation/common.py``).

``get_activations`` loops a loader, optionally runs the generator, then
imagenet-normalizes, resizes to 299x299 and feeds the Inception
extractor; ``get_video_activations`` does the same over the pinned
sequences of a video dataset, rolling a trainer out frame by frame. Not
ported: the JAX loops' telemetry spans and their gather across host
processes (the port runs one process, so nothing is sharded by process).
"""

from __future__ import annotations

import numpy as np
import torch

from imaginaire_tpu_torch.utils.misc import apply_imagenet_normalization, resize_bilinear


def preprocess_for_inception(images):
    """[-1, 1] NCHW float images -> imagenet-normalized (B, 3, 299, 299)
    in the images' type. Only the first 3 channels are used; the resize
    is ``jax.image.resize``'s bilinear, which antialiases when it shrinks
    (``utils/misc.py:resize_bilinear``)."""
    x = apply_imagenet_normalization(images.clamp(-1.0, 1.0))
    if tuple(x.shape[-2:]) != (299, 299):
        x = resize_bilinear(x, (299, 299))
    return x


def _as_nchw(images):
    if isinstance(images, np.ndarray):  # a loader's NHWC host batch
        return torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2)
    return images


def get_activations(data_loader, key_real, key_fake, extractor,
                    generator_fn=None, max_batches=None):
    """(N, D) numpy activations of a sweep over ``data_loader``.

    ``generator_fn``: data -> fake NCHW images in [-1, 1], or None to
    read ``data[key_real]`` (an NCHW tensor, or an NHWC numpy batch).
    ``key_fake`` is kept for the JAX signature."""
    acts = []
    for it, data in enumerate(data_loader):
        if max_batches is not None and it >= max_batches:
            break
        images = _as_nchw(data[key_real]) if generator_fn is None else generator_fn(data)
        feats = extractor(preprocess_for_inception(images.float()))
        acts.append(feats.detach().float().cpu().numpy())
    if not acts:
        return np.zeros((0, 2048), np.float32)
    return np.concatenate(acts, axis=0)


def get_video_activations(data_loader, key_real, key_fake, trainer, extractor,
                          sample_size=None):
    """(N, D) numpy activations of the frames of a video dataset's
    sequences, the first ``sample_size`` of them (cut before anything
    else, as the JAX package cuts before sharding). ``data_loader``
    iterates the pinned sequence's frames in order (batch 1) and has the
    ``dataset``. Each sequence is pinned; with a ``trainer``,
    ``trainer.reset()`` starts it and ``trainer.test_single`` generates
    each frame from its own history; without one, ``data[key_real]`` is
    read: (B, T=1, H, W, C) host frames or (B, T, C, H, W) tensors.
    ``key_fake`` is kept for the JAX signature."""
    dataset = data_loader.dataset
    indices = list(range(dataset.num_inference_sequences()))
    if sample_size is not None:
        indices = indices[:sample_size]
    acts = []
    for seq_idx in indices:
        dataset.set_inference_sequence_idx(seq_idx)
        if trainer is not None:
            trainer.reset()
        for data in data_loader:
            if trainer is None:
                images = data[key_real]
                if images.ndim == 5:  # frame windows: time folds into the batch
                    images = images.reshape((-1,) + tuple(images.shape[2:]))
                images = _as_nchw(images)
            else:
                images = trainer.test_single(data)["fake_images"]
            feats = extractor(preprocess_for_inception(images.float()))
            acts.append(feats.detach().float().cpu().numpy())
    if not acts:
        return np.zeros((0, 2048), np.float32)
    return np.concatenate(acts, axis=0)
