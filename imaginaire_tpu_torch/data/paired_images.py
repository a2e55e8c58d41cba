"""Paired image dataset, SPADE / pix2pixHD (port of
``imaginaire_tpu/data/paired_images.py``): every (root, sequence, frame)
is one item."""

from __future__ import annotations

from imaginaire_tpu_torch.data.base import BaseDataset


class Dataset(BaseDataset):
    def __init__(self, cfg, is_inference=False, is_test=False):
        super().__init__(cfg, is_inference, is_test)
        self.items = [(root_idx, seq, stem)
                      for root_idx, seqs in enumerate(self.sequence_lists)
                      for seq, stems in seqs.items() for stem in stems]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        root_idx, seq, stem = self.items[index % len(self.items)]
        raw = self.load_item(root_idx, seq, [stem])
        out = self.process_item(raw, self.item_rng(index))
        out = self.concat_labels(out, squeeze_time=True)
        out["key"] = f"{seq}/{stem}"
        return out
