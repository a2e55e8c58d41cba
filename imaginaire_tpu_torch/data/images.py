"""Class-conditional image dataset (port of ``imaginaire_tpu/data/images.py``).

Layout ``<root>/<type>/<class>/<files>`` for one image type: a pool of
(root, sequence, stem, class) files, the class being the sequence's
first path segment, indexed in sorted order (``class_name_to_idx``,
``items_by_class``). ``set_sample_class_idx(c)`` restricts the pool to
class ``c``. A training item takes a file of the pool at random, an
inference item file ``index`` modulo the pool. Items carry the image,
its int32 ``labels``, ``is_flipped`` and the ``key``.

The draws come from the item's own ``random.Random`` (``item_rng``): the
file, then the augmentation. The JAX package draws them from the global
``random`` module; a ``random.Random(s)`` here reproduces
``random.seed(s)`` there (ROADMAP.md, section C).
"""

from __future__ import annotations

import numpy as np

from imaginaire_tpu_torch.data.base import BaseDataset
from imaginaire_tpu_torch.data.unpaired_few_shot_images import class_pools
from imaginaire_tpu_torch.data.unpaired_images import load_unpaired_type


class Dataset(BaseDataset):
    def __init__(self, cfg, is_inference=False, is_test=False):
        super().__init__(cfg, is_inference, is_test)
        self.image_type = self.data_types[0]
        self.items, self.class_name_to_idx, self.items_by_class = \
            class_pools(self, self.image_type)
        self.num_classes = len(self.class_name_to_idx)
        self.set_sample_class_idx(None)

    def set_sample_class_idx(self, class_idx=None):
        """Restrict the pool to class ``class_idx`` (None: every class)."""
        self.sample_class_idx = class_idx
        self.epoch_length = (len(self.items) if class_idx is None
                             else len(self.items_by_class[class_idx]))

    def __len__(self):
        return self.epoch_length

    def __getitem__(self, index):
        rng = self.item_rng(index)
        pool = (self.items if self.sample_class_idx is None
                else self.items_by_class[self.sample_class_idx])
        item = pool[index % len(pool)] if self.is_inference else rng.choice(pool)
        root_idx, seq, stem, cls = item
        image, flipped = load_unpaired_type(self, self.image_type, root_idx, seq, stem, rng)
        return {self.image_type: image,
                "labels": np.asarray(self.class_name_to_idx[cls], np.int32),
                "is_flipped": np.asarray(flipped), "key": f"{seq}/{stem}"}
