"""Batching loader (port of ``imaginaire_tpu/data/loader.py``).

The epoch order is ``np.random.RandomState(seed + epoch)``'s shuffle of
the item indices, as in the JAX package, batches are dicts of stacked
NHWC numpy arrays, and ``fast_forward`` skips the batches a resumed run
already trained on without loading them. ``num_workers`` > 0 loads items
on that many threads with a bounded read-ahead of ``prefetch_batches``.

One process reads the whole dataset: the JAX package's per-process
split and its ``global_batch_size`` (elastic pods) are not in the port,
and both raise.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from imaginaire_tpu_torch.config import cfg_get
from imaginaire_tpu_torch.registry import resolve


def _world_size():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=True, num_workers=0, prefetch_batches=2,
                 global_batch_size=None):
        if global_batch_size:
            raise NotImplementedError(
                "global_batch_size (the elastic pods' split) is not in the "
                "port yet (ROADMAP.md)")
        if _world_size() > 1:
            raise NotImplementedError(
                "the loader's per-process split is not in the port yet "
                "(ROADMAP.md); run one process")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = max(prefetch_batches, 1)
        # one-shot skip of the next epoch pass's first batches (resume)
        self._skip_batches = 0
        self.set_epoch(0)

    def set_epoch(self, epoch):
        self.epoch = epoch
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(self.seed, epoch)

    def fast_forward(self, n_batches):
        """Skip the first ``n_batches`` of the next epoch pass (one-shot).
        The order is a function of (seed, epoch), so the skipped prefix is
        exactly what a killed run already consumed."""
        self._skip_batches = max(int(n_batches), 0)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return max(n // self.batch_size, 1)
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def _batches(self):
        order = self._order()
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        skip, self._skip_batches = min(self._skip_batches, len(batches)), 0
        return batches[skip:]

    def __iter__(self):
        batches = self._batches()
        if self.num_workers > 0:
            yield from self._iter_prefetch(batches)
            return
        for idxs in batches:
            yield self._collate([self.dataset[int(i)] for i in idxs])

    def _iter_prefetch(self, batches):
        """Items load on a thread pool while the consumer trains on the
        previous batch; a bounded queue caps the read-ahead. A worker's
        exception re-raises in the consumer; abandoning the iterator sets
        a stop flag and drains the queue so the producer always ends."""
        q = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        sentinel = object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              [int(i) for i in idxs]))
                        put(self._collate(items))
            except Exception as e:  # noqa: BLE001 — re-raised by the consumer
                put(e)
            finally:
                put(sentinel)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="data-loader")
        producer.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            producer.join(timeout=10)

    @staticmethod
    def _collate(items):
        out = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], np.ndarray) and vals[0].dtype != object:
                out[k] = np.stack(vals, axis=0)
            else:
                out[k] = vals
        return out


def _build_dataset(cfg, is_inference=False, is_test=False):
    dataset_cls = resolve(cfg.test_data.type if is_test else cfg.data.type, "Dataset")
    return dataset_cls(cfg, is_inference=is_inference, is_test=is_test)


def get_train_and_val_dataloader(cfg, seed=0):
    train_ds = _build_dataset(cfg, is_inference=False)
    val_ds = _build_dataset(cfg, is_inference=True)
    num_workers = cfg_get(cfg.data, "num_workers", 0)
    prefetch = cfg_get(cfg.data, "prefetch", 2)
    train = DataLoader(train_ds, cfg_get(cfg.data.train, "batch_size", 1),
                       shuffle=True, seed=seed, num_workers=num_workers,
                       prefetch_batches=prefetch,
                       global_batch_size=cfg_get(cfg.data.train, "global_batch_size", None))
    val = DataLoader(val_ds, cfg_get(cfg.data.val, "batch_size", 1),
                     shuffle=False, seed=seed, num_workers=num_workers,
                     prefetch_batches=prefetch,
                     global_batch_size=cfg_get(cfg.data.val, "global_batch_size", None))
    return train, val


def get_test_dataloader(cfg):
    ds = _build_dataset(cfg, is_inference=True, is_test=True)
    return DataLoader(ds, cfg_get(cfg.test_data.test, "batch_size", 1),
                      shuffle=False, drop_last=False)
