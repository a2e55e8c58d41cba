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
dataset refuses the knob.

Data ops, as in the JAX package: per type, ``pre_aug_ops`` before the
augmentation and ``post_aug_ops`` after it: the builtins ``decode_json``
and ``to_numpy``, ``module::function`` (a function of the frame list)
and ``vis::module::function``, which also receives the augmentation's
geometry and the item's ``rng`` and turns keypoints into label maps
(the JAX package's pose renderer draws its random stroke drops from the
global ``random``). A rendered map must have the channels its type
declares (``num_channels``): the port raises where it does not, and
guesses no width. The augmented coordinates of each
``keypoint_data_types`` type are kept as ``<type>_xy`` (T, N, 2) before
the post ops run, and come out in the item; OpenPose's dict frames have
no such stash. ``full_data_ops``
(``module::function``) then see the whole item; they receive the item's
``rng`` too, and may consume a data type (the person crop takes
``human_instance_maps`` out of the item). An op marked
``uses_common_attr`` (the person crop) shares attributes across the
windows of a pinned inference sequence: the dataset hands it the
sequence's ``common_attr`` (its first window's crop box) and keeps what
it leaves there; ``set_inference_sequence_idx`` clears them, and a
window processed with ``thread_common_attr=False`` (a few-shot
reference) neither reads nor writes them. ``decode_pkl`` unpickles each frame, and
``convert::module::function`` is a function of the frame list that may
return a structured payload in its place (wc-vid2vid's
``decode_unprojections``: ``{resolution: (T, N, 3)}``), which passes
through to the item as it is. Module paths may name the JAX package:
they resolve to their twins in the port.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import threading

import numpy as np

from imaginaire_tpu_torch.config import as_attrdict, cfg_get
from imaginaire_tpu_torch.data.augment import Augmentor
from imaginaire_tpu_torch.data.backends import (
    FolderBackend,
    LMDBBackend,
    PackedBackend,
    create_folder_metadata,
)
from imaginaire_tpu_torch.registry import resolve_function


def _parse_ops(spec):
    if not spec or spec == "None":
        return []
    return [item.strip() for item in str(spec).split(",")
            if item.strip() and item.strip() != "None"]


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
        self.name = cfg_get(self.cfgdata, "name", "dataset")
        self.roots = list(data_info.roots)
        self.seed = 0
        self.epoch = 0

        backend = "folder"
        if cfg_get(data_info, "is_lmdb", False):
            backend = "lmdb"
        elif cfg_get(data_info, "is_packed", False):
            backend = "packed"
        self.backend_kind = backend

        self.data_types = []
        self.extensions = {}
        self.normalize = {}
        self.interpolators = {}
        self.num_channels = {}
        self.use_dont_care = {}
        self.is_mask = {}
        self.pre_aug_ops = {}
        self.post_aug_ops = {}
        for data_type in self.cfgdata.input_types:
            (name, info), = data_type.items()
            self.data_types.append(name)
            self.extensions[name] = cfg_get(info, "ext", None)
            self.normalize[name] = cfg_get(info, "normalize", False)
            self.interpolators[name] = cfg_get(info, "interpolator", None)
            self.num_channels[name] = cfg_get(info, "num_channels", None)
            self.use_dont_care[name] = cfg_get(info, "use_dont_care", False)
            self.is_mask[name] = cfg_get(info, "is_mask", False)
            self.pre_aug_ops[name] = _parse_ops(cfg_get(info, "pre_aug_ops", None))
            self.post_aug_ops[name] = _parse_ops(cfg_get(info, "post_aug_ops", None))
        self.full_data_ops = _parse_ops(cfg_get(self.cfgdata, "full_data_ops", None))
        # the sequence-level attributes of a pinned inference sequence, the
        # pin they belong to (a window of an earlier pin must not write
        # them), and whether an op uses them
        self.threads_common_attr = is_inference and any(
            getattr(resolve_function(*spec.split("::")), "uses_common_attr", False)
            for spec in self.full_data_ops)
        self._common_attr = None
        self._common_attr_pin = 0
        self._common_attr_lock = threading.Lock()
        self.keypoint_data_types = list(
            cfg_get(self.cfgdata, "keypoint_data_types", None) or [])
        for ops in list(self.pre_aug_ops.values()) + list(self.post_aug_ops.values()):
            for spec in ops:
                self._resolve_op(spec)  # refuse what the port lacks up front
        # ship (H, W) int index maps and one-hot them on the device
        self.one_hot_on_device = bool(cfg_get(self.cfgdata, "one_hot_on_device", False))
        if self.one_hot_on_device and (
                self.supports_temporal_stride
                or "video" in str(cfg_get(self.cfgdata, "type", ""))):
            raise ValueError(
                "one_hot_on_device is implemented for image datasets only; "
                "drop the knob for video dataset types")
        self.input_labels = list(cfg_get(self.cfgdata, "input_labels", None) or [])
        self.input_image = list(cfg_get(self.cfgdata, "input_image", None) or [])

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
        self.augmentor = Augmentor(aug_cfg, self.interpolators,
                                   keypoint_data_types=self.keypoint_data_types)
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

    def process_item(self, data, rng, thread_common_attr=True):
        """Pre-ops -> joint augmentation (draws from ``rng``) -> keypoint
        stash -> post-ops -> full-data ops (with the pinned sequence's
        ``common_attr`` unless ``thread_common_attr`` is False) ->
        normalize / one-hot. Returns {type: (T, H, W, C) float32} of the
        types the ops left, the ``<type>_xy`` keypoint stashes and
        ``is_flipped``."""
        thread = thread_common_attr and self.threads_common_attr
        pin = self._common_attr_pin
        # the /255 is keyed on the source dtype, not on the values
        was_uint8 = {t: len(data[t]) > 0 and getattr(data[t][0], "dtype", None) == np.uint8
                     for t in self.data_types}
        data = self._apply_ops(data, self.pre_aug_ops)
        data, is_flipped = self.augmentor.perform_augmentation(data, rng)
        kp_copies = {}
        for t in self.keypoint_data_types:
            frames = data.get(t)
            if frames and not isinstance(frames[0], (dict, list)):
                try:
                    kp_copies[t + "_xy"] = np.stack([np.asarray(f, np.float32)
                                                     for f in frames])
                except ValueError:  # ragged keypoint counts: no stash
                    pass
        data = self._apply_ops(data, self.post_aug_ops, rng)
        data.update(kp_copies)
        if thread:
            with self._common_attr_lock:
                if self._common_attr and pin == self._common_attr_pin:
                    data["common_attr"] = dict(self._common_attr)
        for spec in self.full_data_ops:
            data = resolve_function(*spec.split("::"))(self.cfgdata, self.is_inference,
                                                       data, rng=rng)
        common_attr = data.pop("common_attr", None)
        if thread and common_attr:
            with self._common_attr_lock:
                if pin == self._common_attr_pin:
                    self._common_attr = common_attr
        out = {k: data[k] for k in kp_copies if k in data}
        for t in self.data_types:
            if t not in data:
                continue  # consumed by a full-data op (the instance maps)
            if not isinstance(data[t], (list, tuple)):
                # a convert:: op replaced the frame list with a structured
                # payload: the item carries it as it is
                out[t] = data[t]
                continue
            frames = []
            for arr in data[t]:
                arr = np.asarray(arr)
                vis_output = arr.ndim == 3 and t in self.keypoint_data_types
                if vis_output and self.num_channels[t] \
                        and arr.shape[-1] != self.num_channels[t]:
                    raise ValueError(
                        f"{t!r} renders {arr.shape[-1]} channels where "
                        f"data.input_types declares num_channels "
                        f"{self.num_channels[t]} (ROADMAP.md §C, C12); for "
                        "OpenPose's 27 set data.for_pose_dataset.pose_one_hot: "
                        "True")
                arr = arr.astype(np.float32)
                if self.is_mask[t] or (self.num_channels[t] and arr.ndim == 3
                                       and arr.shape[-1] == 1
                                       and self.num_channels[t] > 1
                                       and not vis_output):
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

    def clear_common_attr(self):
        """Forget the pinned sequence's attributes (a new pin)."""
        with self._common_attr_lock:
            self._common_attr = None
            self._common_attr_pin += 1

    def _apply_ops(self, data, op_dict, rng=None):
        for t, ops in op_dict.items():
            if t in data:
                for spec in ops:
                    data[t] = self._resolve_op(spec, rng)(data[t])
        return data

    def _resolve_op(self, spec, rng=None):
        """A data-op spec -> a function of one type's frame list; a
        ``vis::`` op also gets the item's ``rng``."""
        if spec == "decode_json":
            return lambda frames: [json.loads(f) if isinstance(f, (str, bytes)) else f
                                   for f in frames]
        if spec == "decode_pkl":
            return lambda frames: [pickle.loads(f) for f in frames]
        if spec == "to_numpy":
            return lambda frames: [np.asarray(f) for f in frames]
        parts = str(spec).split("::")
        if len(parts) == 2:
            return resolve_function(*parts)
        if len(parts) == 3 and parts[0] == "vis":
            fn = resolve_function(*parts[1:])
            return lambda frames: fn(*self.augmentor.geometry(), self.cfgdata, frames,
                                     rng=rng)
        if len(parts) == 3 and parts[0] == "convert":
            return resolve_function(*parts[1:])
        raise NotImplementedError(
            f"data op {spec!r} is not in the port yet (ROADMAP.md); it has "
            "decode_json, decode_pkl, to_numpy, module::function, "
            "vis::module::function and convert::module::function")

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
