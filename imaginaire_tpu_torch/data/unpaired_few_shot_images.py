"""Few-shot unpaired class dataset, FUNIT / COCO-FUNIT (port of
``imaginaire_tpu/data/unpaired_few_shot_images.py``).

Layout ``<root>/<type>/<class>/<files>`` for the two types
``images_content`` and ``images_style``: each type has its own pool of
(root, sequence, stem, class) files, the class being the sequence's
first path segment, indexed in sorted order per type
(``class_name_to_idx``, ``items_by_class``). A training item takes one
file of each pool at random. ``set_sample_class_idx(c)`` pins an
inference item to style class ``c``: item ``index`` takes content file
``index`` and the class's style file ``index``, each modulo its pool,
and the length becomes the class's number of style files; an unpinned
inference item draws at random, as a training item does. Each type draws
its own crop and flip. Items carry ``labels_content`` and
``labels_style`` (int32 class indices).

The draws come from the item's own ``random.Random`` (``item_rng``): the
file of each pool in the order of the types, then each type's
augmentation in the same order. The JAX package draws them from the
global ``random`` module; a ``random.Random(s)`` here reproduces
``random.seed(s)`` there (ROADMAP.md, section C).
"""

from __future__ import annotations

import numpy as np

from imaginaire_tpu_torch.data.base import BaseDataset
from imaginaire_tpu_torch.data.unpaired_images import load_unpaired_type, type_sequences


def class_pools(dataset, data_type):
    """(items, {class name: index}, {index: items}) of one type: every
    (root, sequence, stem, class) file of ``dataset``'s roots, the class
    being the sequence's first path segment, indexed in sorted order."""
    items = []
    for root_idx, root in enumerate(dataset.roots):
        for seq, stems in type_sequences(dataset, root_idx, root, data_type).items():
            cls = seq.split("/")[0]
            items.extend((root_idx, seq, stem, cls) for stem in stems)
    name_to_idx = {c: i for i, c in enumerate(sorted({item[3] for item in items}))}
    by_class = {}
    for item in items:
        by_class.setdefault(name_to_idx[item[3]], []).append(item)
    return items, name_to_idx, by_class


class Dataset(BaseDataset):
    def __init__(self, cfg, is_inference=False, is_test=False):
        super().__init__(cfg, is_inference, is_test)
        self.items, self.class_name_to_idx, self.items_by_class = {}, {}, {}
        for t in self.data_types:
            self.items[t], self.class_name_to_idx[t], self.items_by_class[t] = \
                class_pools(self, t)
        self.num_content_classes = len(self.class_name_to_idx["images_content"])
        self.num_style_classes = len(self.class_name_to_idx["images_style"])
        self.set_sample_class_idx(None)

    def set_sample_class_idx(self, class_idx=None):
        """Pin inference items to style class ``class_idx`` (None: unpin)."""
        self.sample_class_idx = class_idx
        if class_idx is None:
            self.epoch_length = max(len(v) for v in self.items.values())
        else:
            self.epoch_length = len(self.items_by_class["images_style"][class_idx])

    def __len__(self):
        return self.epoch_length

    def _sample_keys(self, index, rng):
        if self.is_inference and self.sample_class_idx is not None:
            content = self.items["images_content"]
            style = self.items_by_class["images_style"][self.sample_class_idx]
            return {"images_content": content[index % len(content)],
                    "images_style": style[index % len(style)]}
        return {t: rng.choice(self.items[t]) for t in self.data_types}

    def __getitem__(self, index):
        rng = self.item_rng(index)
        keys = self._sample_keys(index, rng)
        out, flips = {}, []
        for t in self.data_types:
            root_idx, seq, stem, cls = keys[t]
            out[t], flipped = load_unpaired_type(self, t, root_idx, seq, stem, rng)
            flips.append(flipped)
            out["labels_" + t.split("_", 1)[1]] = np.asarray(
                self.class_name_to_idx[t][cls], np.int32)
        out["is_flipped"] = np.asarray(flips)
        out["key"] = "|".join(f"{keys[t][1]}/{keys[t][2]}" for t in self.data_types)
        return out
