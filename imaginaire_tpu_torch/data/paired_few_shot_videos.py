"""Paired few-shot video dataset, fs-vid2vid (port of
``imaginaire_tpu/data/paired_few_shot_videos.py``).

Like the paired video dataset, but each item also carries K reference
frames (``ref_images``, ``ref_labels``: (K, H, W, C)) of the same
sequence, disjoint from the item's window. A training item draws from
its ``random.Random`` (``item_rng``) in the JAX package's order: the
time step, the window's start, the K reference frames (sorted), then
the window's augmentation and full-data ops (the face or person crop's
jitter), then the reference window's. The reference window is processed
as an item of its own: its crop box is its own, and at inference it
neither reads nor writes the pinned sequence's shared attributes (the
driving frames' person crop box; see ``paired_videos.py`` for the
first-frame barrier).

An inference dataset is always pinned: its items are the frames of the
driving sequence (``set_inference_sequence_idx``; the first sequence by
default) one by one, each with the ``k_shot_frame_index``-th frame of
the ``k_shot_index``-th sequence (the driving one by default) as its
reference. ``K`` is ``data.initial_few_shot_K``; ``set_few_shot_K``
changes it.
"""

from __future__ import annotations

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.data.paired_videos import Dataset as VideoDataset


class Dataset(VideoDataset):
    def __init__(self, cfg, is_inference=False, is_test=False):
        self.few_shot_K = 1
        super().__init__(cfg, is_inference, is_test)
        self.few_shot_K = int(cfg_get(self.cfgdata, "initial_few_shot_K", 1))
        self.inference_k_shot_sequence_index = 0
        self.inference_k_shot_frame_index = 0
        if is_inference:
            self.set_inference_sequence_idx(0)
        self._rebuild()

    def set_inference_sequence_idx(self, index, k_shot_index=None,
                                   k_shot_frame_index=0):
        """Pin driving sequence ``index`` and its reference frame."""
        super().set_inference_sequence_idx(index)
        self.inference_k_shot_sequence_index = (
            self.inference_sequence_idx if k_shot_index is None
            else int(k_shot_index) % len(self.sequences))
        self.inference_k_shot_frame_index = int(k_shot_frame_index)

    def set_few_shot_K(self, k):
        self.few_shot_K = int(k)
        self._rebuild()

    def _rebuild(self):
        self.valid = [s for s in self.sequences
                      if len(s[2]) >= self.sequence_length + self.few_shot_K]
        self.epoch_length = max(len(self.valid), 1)
        if self.is_inference and self.inference_sequence_idx is not None:
            self.epoch_length = len(self.sequences[self.inference_sequence_idx][2])

    def __getitem__(self, index):
        rng = self.item_rng(index)
        if self.is_inference:
            root_idx, seq, stems = self.sequences[self.inference_sequence_idx]
            frames = [stems[index % len(stems)]]
            ref_root, ref_seq, ref_stems = self.sequences[
                self.inference_k_shot_sequence_index]
            ref_frames = [ref_stems[self.inference_k_shot_frame_index % len(ref_stems)]]
            out = self._load_pinned(root_idx, seq, stems, index % len(stems), rng)
        else:
            required, time_step = self._sample_time_step(rng, extra=self.few_shot_K)
            candidates = (self.valid if time_step == 1 else
                          [s for s in self.valid
                           if len(s[2]) >= required + self.few_shot_K])
            root_idx, seq, stems = candidates[index % len(candidates)]
            max_start = len(stems) - required - self.few_shot_K
            start = rng.randint(0, max(max_start, 0))
            end = start + required
            frames = stems[start:end:time_step]
            if len(frames) != self.sequence_length:
                raise RuntimeError(f"sampled {len(frames)} frames of {seq}, "
                                   f"not {self.sequence_length}")
            pool = list(range(0, start)) + list(range(end, len(stems)))
            ref_frames = [stems[i] for i in sorted(rng.sample(pool, self.few_shot_K))]
            ref_root, ref_seq = root_idx, seq
            out = self.process_item(self.load_item(root_idx, seq, frames), rng)
        out = self.concat_labels(out)
        ref = self.concat_labels(self.process_item(
            self.load_item(ref_root, ref_seq, ref_frames), rng, thread_common_attr=False))
        out["ref_images"] = ref["images"]
        if "label" in ref:
            out["ref_labels"] = ref["label"]
        out["key"] = f"{seq}/{frames[-1]}"
        return out
