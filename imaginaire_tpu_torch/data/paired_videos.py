"""Paired video dataset, vid2vid (port of
``imaginaire_tpu/data/paired_videos.py:23-177``).

Sequences of aligned frames of each data type. ``sequence_length`` is
set by the trainer's curriculum (``set_sequence_length``); an item is
``sequence_length`` frames of one sequence that has that many, taken
``time_step`` frames apart from a random start. The time step (from
``augmentations.max_time_step``) and the start are drawn from the
item's ``random.Random`` (``item_rng``) in the JAX package's order, then
the augmentation, shared by every frame of the item; the JAX dataset
draws them from the global ``random`` module, so ``random.seed(s)``
before a JAX item equals ``random.Random(s)`` here. Items are
{type: (T, H, W, C)} float32 with the labels concatenated into
``label``; the loader stacks them to (B, T, H, W, C), and the trainer
moves them to the device as (B, T, C, H, W).

An inference dataset can pin one sequence
(``set_inference_sequence_idx``): its items are then that sequence's
frames one by one. The JAX dataset's teacher-cache hook
(``DatasetFlowCacheHook``, its disk lookups in the loader's threads) is
not ported: where a config turns the teacher's cache on, the trainer's
``TeacherFlowCache.attach`` computes or looks up the same flows from
the batch, in the thread that prepares it.
"""

from __future__ import annotations

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.data.base import BaseDataset


class Dataset(BaseDataset):
    supports_temporal_stride = True

    def __init__(self, cfg, is_inference=False, is_test=False):
        super().__init__(cfg, is_inference, is_test)
        self.sequence_length = int(
            cfg_get(self.data_info, "initial_sequence_length", 1)
            if not is_inference else 1)
        self.sequences = []
        self.sequence_length_max = 0
        for root_idx, seqs in enumerate(self.sequence_lists):
            for seq, stems in seqs.items():
                self.sequences.append((root_idx, seq, list(stems)))
                self.sequence_length_max = max(self.sequence_length_max,
                                               len(stems))
        # the first batch is read before the curriculum sets a length
        self.sequence_length = min(self.sequence_length,
                                   max(self.sequence_length_max, 1))
        self.inference_sequence_idx = None
        self._rebuild()

    def set_sequence_length(self, sequence_length):
        self.sequence_length = min(int(sequence_length), self.sequence_length_max)
        self._rebuild()

    def num_inference_sequences(self):
        if not self.is_inference:
            raise ValueError("num_inference_sequences() needs an inference dataset")
        return len(self.sequences)

    def set_inference_sequence_idx(self, index):
        """Pin one sequence: items become its frames one by one."""
        if not self.is_inference:
            raise ValueError("set_inference_sequence_idx() needs an inference "
                             "dataset")
        self.inference_sequence_idx = index % len(self.sequences)
        self.epoch_length = len(self.sequences[self.inference_sequence_idx][2])

    def _rebuild(self):
        self.valid = [s for s in self.sequences
                      if len(s[2]) >= self.sequence_length]
        self.epoch_length = max(len(self.valid), 1)

    def __len__(self):
        return self.epoch_length

    def _sample_time_step(self, rng, extra=0):
        """(frames spanned, time step): a random step in [1,
        max_time_step], or 1 when the strided window (plus ``extra``
        frames) is longer than the longest sequence."""
        time_step = rng.randint(1, self.augmentor.max_time_step)
        required = 1 + (self.sequence_length - 1) * time_step
        if required + extra > self.sequence_length_max:
            required, time_step = self.sequence_length, 1
        return required, time_step

    def __getitem__(self, index):
        rng = self.item_rng(index)
        if self.is_inference and self.inference_sequence_idx is not None:
            root_idx, seq, stems = self.sequences[self.inference_sequence_idx]
            frames = [stems[index % len(stems)]]
        else:
            if self.is_inference:
                required, time_step = self.sequence_length, 1
            else:
                required, time_step = self._sample_time_step(rng)
            candidates = (self.valid if time_step == 1 else
                          [s for s in self.valid if len(s[2]) >= required])
            root_idx, seq, stems = candidates[index % len(candidates)]
            max_start = len(stems) - required
            start = (rng.randint(0, max_start)
                     if not self.is_inference and max_start > 0 else 0)
            frames = stems[start:start + required:time_step]
            if len(frames) != self.sequence_length:
                raise RuntimeError(f"sampled {len(frames)} frames of {seq}, "
                                   f"not {self.sequence_length}")
        out = self.process_item(self.load_item(root_idx, seq, frames), rng)
        out = self.concat_labels(out)
        out["key"] = f"{seq}/{frames[-1]}"
        return out
