"""Config-driven multi-type dataset base (port of
``imaginaire_tpu/data/base.py``).

Per data type the config declares ext / num_channels / normalize /
interpolator / use_dont_care / is_mask. Items come out as channel-last
float32 numpy, as in the JAX package:
  - images /255 when the source was uint8, then to [-1, 1] when
    ``normalize``;
  - mask label maps one-hot expanded to num_channels (+1 dont-care
    channel kept when use_dont_care), or int index maps with
    ``one_hot_on_device`` (the trainer expands them on the device);
  - all ``input_labels`` types concatenated into ``data['label']``.

Each item's augmentation draws from its own ``random.Random``, seeded by
(the loader's seed, the epoch, the item's index), so an item's draw does
not depend on which loader thread fetched it or on how many items came
before it: a resumed run that skips the batches it already trained on
sees the same items an unbroken run sees. (The JAX package draws from
the global ``random`` module.) Sequence items keep time at dim 0,
(T, H, W, C); a video dataset that declares ``supports_temporal_stride``
samples frames ``augmentations.max_time_step`` apart, and any other
dataset refuses the knob. Pre-, post- and full-data ops are for pose
data and raise until a later slice.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.data.augment import Augmentor
from imaginaire_tpu_torch.data.backends import (
    FolderBackend,
    LMDBBackend,
    PackedBackend,
    create_folder_metadata,
)


def _refuse_ops(spec, where):
    if spec not in (None, "None", ""):
        raise NotImplementedError(
            f"{where}={spec!r}: data ops are not in the port yet (ROADMAP.md)")


class BaseDataset:
    # video datasets that honour augmentations.max_time_step set this True
    supports_temporal_stride = False

    def __init__(self, cfg, is_inference=False, is_test=False):
        cfg = as_attrdict(cfg)
        self.cfg = cfg
        self.is_inference = is_inference
        self.is_test = is_test
        self.cfgdata = cfg.test_data if is_test else cfg.data
        data_info = (self.cfgdata.test if is_test
                     else (self.cfgdata.val if is_inference else self.cfgdata.train))
        self.data_info = data_info
        self.roots = list(data_info.roots)
        self.seed = 0
        self.epoch = 0

        backend = "folder"
        if cfg_get(data_info, "is_lmdb", False):
            backend = "lmdb"
        elif cfg_get(data_info, "is_packed", False):
            backend = "packed"

        self.data_types = []
        self.extensions = {}
        self.normalize = {}
        self.interpolators = {}
        self.num_channels = {}
        self.use_dont_care = {}
        self.is_mask = {}
        for data_type in self.cfgdata.input_types:
            (name, info), = data_type.items()
            self.data_types.append(name)
            self.extensions[name] = cfg_get(info, "ext", None)
            self.normalize[name] = cfg_get(info, "normalize", False)
            self.interpolators[name] = cfg_get(info, "interpolator", None)
            self.num_channels[name] = cfg_get(info, "num_channels", None)
            self.use_dont_care[name] = cfg_get(info, "use_dont_care", False)
            self.is_mask[name] = cfg_get(info, "is_mask", False)
            for key in ("pre_aug_ops", "post_aug_ops"):
                _refuse_ops(cfg_get(info, key, None), f"{name}.{key}")
        _refuse_ops(cfg_get(self.cfgdata, "full_data_ops", None), "full_data_ops")
        # ship (H, W) int index maps and one-hot them on the device
        self.one_hot_on_device = bool(cfg_get(self.cfgdata, "one_hot_on_device", False))
        if self.one_hot_on_device and (
                self.supports_temporal_stride
                or "video" in str(cfg_get(self.cfgdata, "type", ""))):
            raise ValueError(
                "one_hot_on_device is implemented for image datasets only; "
                "drop the knob for video dataset types")
        self.input_labels = list(cfg_get(self.cfgdata, "input_labels", None) or [])

        self.backends = {t: [] for t in self.data_types}
        self.sequence_lists = []
        for root in self.roots:
            if backend == "folder":
                self.sequence_lists.append(create_folder_metadata(root, self.data_types))
            else:
                with open(os.path.join(root, "all_filenames.json")) as f:
                    self.sequence_lists.append(json.load(f))
            backend_cls = {"folder": FolderBackend, "lmdb": LMDBBackend,
                           "packed": PackedBackend}[backend]
            for t in self.data_types:
                self.backends[t].append(backend_cls(os.path.join(root, t),
                                                    self.extensions[t]))

        aug_cfg = cfg_get(data_info, "augmentations", None) or {}
        self.augmentor = Augmentor(
            aug_cfg, self.interpolators,
            keypoint_data_types=cfg_get(self.cfgdata, "keypoint_data_types", None))
        if self.augmentor.max_time_step > 1 and not self.supports_temporal_stride:
            raise ValueError(
                f"augmentations.max_time_step={self.augmentor.max_time_step} "
                f"is configured, but {type(self).__module__} does not "
                "implement strided temporal sampling; drop the knob")

    # ------------------------------------------------------------------ api

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def reseed(self, seed, epoch):
        """Set the (seed, epoch) the items' augmentation draws derive from
        (the loader calls it before each epoch)."""
        self.seed, self.epoch = int(seed), int(epoch)

    def item_rng(self, index):
        """The ``random.Random`` of item ``index`` in the current epoch."""
        return random.Random(f"{self.seed}/{self.epoch}/{int(index)}")

    # ------------------------------------------------------------- loading

    def load_item(self, root_idx, sequence_name, filenames):
        """All data types of the given frames -> {type: [HWC arrays]}."""
        return {t: [self.backends[t][root_idx].getitem(f"{sequence_name}/{fname}")
                    for fname in filenames]
                for t in self.data_types}

    def process_item(self, data, rng):
        """Joint augmentation (draws from ``rng``) -> normalize / one-hot.
        Returns {type: (T, H, W, C) float32} and ``is_flipped``."""
        # the /255 is keyed on the source dtype, not on the values
        was_uint8 = {t: len(data[t]) > 0 and getattr(data[t][0], "dtype", None) == np.uint8
                     for t in self.data_types}
        data, is_flipped = self.augmentor.perform_augmentation(data, rng)
        out = {}
        for t in self.data_types:
            frames = []
            for arr in data[t]:
                arr = np.asarray(arr).astype(np.float32)
                if self.is_mask[t] or (self.num_channels[t] and arr.ndim == 3
                                       and arr.shape[-1] == 1
                                       and self.num_channels[t] > 1):
                    if self.one_hot_on_device and self.is_mask[t] \
                            and t in self.input_labels:
                        arr = self._encode_index_map(arr, self.num_channels[t])
                    else:
                        arr = self._encode_onehot(arr, self.num_channels[t],
                                                  self.use_dont_care[t])
                else:
                    if was_uint8[t]:
                        arr = arr / 255.0
                    if self.normalize[t]:
                        arr = arr * 2.0 - 1.0
                frames.append(arr)
            out[t] = np.stack(frames, axis=0)
        out["is_flipped"] = np.asarray(is_flipped)
        return out

    @staticmethod
    def _encode_index_map(label_map, num_labels):
        """(H, W, 1) -> (H, W, 1) int32; out-of-range and negative indices
        become the dont-care index ``num_labels``."""
        idx = label_map[..., :1].astype(np.int32)
        idx[(idx < 0) | (idx >= num_labels)] = num_labels
        return idx

    @staticmethod
    def _encode_onehot(label_map, num_labels, use_dont_care):
        """(H, W, 1) index map -> (H, W, num_labels[+1]) one-hot;
        out-of-range and negative indices become the dont-care index,
        whose channel is kept only with ``use_dont_care``."""
        idx = label_map[..., 0].astype(np.int64)
        idx[(idx < 0) | (idx >= num_labels)] = num_labels
        out = np.zeros(idx.shape + (num_labels + 1,), dtype=np.float32)
        np.put_along_axis(out, idx[..., None], 1.0, axis=-1)
        if not use_dont_care:
            out = out[..., :num_labels]
        return out

    def concat_labels(self, out, squeeze_time=False):
        """All ``input_labels`` types -> ``label`` (channel order of the
        config). With ``one_hot_on_device`` the one mask type stays an
        int index map under ``label`` (channel dim dropped) and the other
        label types concatenate under ``label_float``."""
        if self.input_labels and self.one_hot_on_device:
            mask_types = [t for t in self.input_labels if self.is_mask[t]]
            if len(mask_types) != 1:
                raise ValueError(
                    "one_hot_on_device needs exactly one mask label type, "
                    f"got {mask_types} — disable the knob for this config")
            if mask_types[0] != self.input_labels[0]:
                raise ValueError("one_hot_on_device requires the mask label "
                                 "type first in input_labels (channel-order contract)")
            out["label"] = out.pop(mask_types[0])[..., 0]  # (T, H, W) int32
            floats = [out.pop(t) for t in self.input_labels if t != mask_types[0]]
            if floats:
                out["label_float"] = np.concatenate(floats, axis=-1)
        elif self.input_labels:
            out["label"] = np.concatenate([out.pop(t) for t in self.input_labels],
                                          axis=-1)
        if squeeze_time:
            for k, v in list(out.items()):
                min_ndim = 3 if (k == "label" and self.one_hot_on_device) else 4
                if isinstance(v, np.ndarray) and v.ndim >= min_ndim and v.shape[0] == 1:
                    out[k] = v[0]
        return out
