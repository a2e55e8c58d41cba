"""Unpaired two-domain image dataset, UNIT / MUNIT (port of
``imaginaire_tpu/data/unpaired_images.py``).

Each data type (``images_a``, ``images_b``) has its own pool of (root,
sequence, stem) files. A training item takes one file of each pool at
random; an inference item takes file ``index`` modulo each pool's size.
Each domain draws its own crop and flip (the augmentor is called once a
domain, as the JAX package's unpaired mode does).
The item's length is the larger pool's.

The draws come from the item's own ``random.Random`` (``item_rng``): the
file of each pool in the order of the types, then each domain's
augmentation in the same order. The JAX package draws the files with the
global ``random.choice``; a ``random.Random(s)`` here reproduces
``random.seed(s)`` there (ROADMAP.md, section C).
"""

from __future__ import annotations

import json
import os

import numpy as np

from imaginaire_tpu_torch.data.backends import create_folder_metadata
from imaginaire_tpu_torch.data.base import BaseDataset


def type_sequences(dataset, root_idx, root, data_type):
    """{sequence: [stems]} of one domain: the folder tree
    ``<root>/<type>/`` of a folder dataset; for a packed one the per-type
    ``<root>/<type>/all_filenames.json`` (``build_packed_dataset`` writes
    it), else a ``data_type`` key of the root's manifest."""
    if dataset.backend_kind == "folder":
        return create_folder_metadata(root, [data_type])
    per_type = os.path.join(root, data_type, "all_filenames.json")
    if os.path.exists(per_type):
        with open(per_type) as f:
            return json.load(f)
    seqs = dataset.sequence_lists[root_idx]
    if isinstance(seqs, dict) and data_type in seqs:
        return seqs[data_type]
    raise ValueError(
        f"unpaired dataset: no per-type file list for {data_type!r} under "
        f"{root!r} (need {per_type} or a {data_type!r} key in the root "
        "all_filenames.json; a shared sequence list would pair the domains)")


def load_unpaired_type(dataset, data_type, root_idx, seq, stem, rng):
    """One domain's image: loaded, augmented by its own draw from
    ``rng``, /255 when the source was uint8, and to [-1, 1] when the type
    normalizes. Returns (HWC float32 array, whether it was flipped)."""
    arr = dataset.backends[data_type][root_idx].getitem(f"{seq}/{stem}")
    was_uint8 = getattr(arr, "dtype", None) == np.uint8
    data = dataset._apply_ops({data_type: [arr]},
                              {data_type: dataset.pre_aug_ops[data_type]})
    # one type a call: the domain draws its own crop and flip
    data, flipped = dataset.augmentor.perform_augmentation(data, rng)
    data = dataset._apply_ops(data, {data_type: dataset.post_aug_ops[data_type]})
    arr = data[data_type][0].astype(np.float32)
    if was_uint8:
        arr = arr / 255.0
    if dataset.normalize[data_type]:
        arr = arr * 2.0 - 1.0
    return arr, flipped


class Dataset(BaseDataset):
    def __init__(self, cfg, is_inference=False, is_test=False):
        super().__init__(cfg, is_inference, is_test)
        self.items = {t: [] for t in self.data_types}
        for root_idx, root in enumerate(self.roots):
            for t in self.data_types:
                for seq, stems in type_sequences(self, root_idx, root, t).items():
                    self.items[t].extend((root_idx, seq, stem) for stem in stems)
        self.epoch_length = max(len(v) for v in self.items.values())

    def __len__(self):
        return self.epoch_length

    def _sample_keys(self, index, rng):
        if self.is_inference:
            return {t: pool[index % len(pool)] for t, pool in self.items.items()}
        return {t: rng.choice(pool) for t, pool in self.items.items()}

    def __getitem__(self, index):
        rng = self.item_rng(index)
        keys = self._sample_keys(index, rng)
        out, flips = {}, []
        for t in self.data_types:
            root_idx, seq, stem = keys[t]
            out[t], flipped = load_unpaired_type(self, t, root_idx, seq, stem, rng)
            flips.append(flipped)
        out["is_flipped"] = np.asarray(flips)
        out["key"] = "|".join(f"{keys[t][1]}/{keys[t][2]}" for t in self.data_types)
        return out
