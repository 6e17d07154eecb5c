"""Ordered prefetch over a dataset on threads, and the train batches
(the port's own copy of ``rvos_tpu/data/loader.py``).

Frame decode, the perturbation and the eval resize run in
``__getitem__`` of the wrapped dataset, on ``num_workers`` threads
(decode and numpy transforms release the GIL), at most ``prefetch``
items ahead of the consumer; items come out in index order, and an
exception raised by a worker reaches the consumer when its item's turn
comes.  One worker reads in the consumer's thread.

``TrainBatcher`` runs the train transform on those threads too, each
item with a generator seeded by (seed, epoch, index), and stacks the
JAX package's batch: ``ref_img``/``prev_img`` [B, H, W, 3],
``curr_img`` [T, B, H, W, 3], labels int32 [B, H, W] / [T, B, H, W],
``obj_num`` int32 [B].  One process (the port trains on one GPU).
"""

from __future__ import annotations

import inspect
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


class PrefetchLoader:
    """Ordered prefetch over dataset[i] for i in indices (threaded)."""

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 num_workers: int = 2, prefetch: int = 4):
        self.dataset = dataset
        self.indices = list(indices) if indices is not None \
            else list(range(len(dataset)))
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return len(self.indices)

    def __iter__(self) -> Iterator:
        if self.num_workers == 1:
            for i in self.indices:
                yield self.dataset[i]
            return

        results: Dict[int, object] = {}
        cond = threading.Condition()
        next_submit = [0]
        next_emit = [0]
        n = len(self.indices)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                with cond:
                    while (next_submit[0] >= n or
                           next_submit[0] - next_emit[0] >= self.prefetch):
                        if next_submit[0] >= n or stop.is_set():
                            return
                        cond.wait(0.05)
                        if stop.is_set():
                            return
                    my_idx = next_submit[0]
                    next_submit[0] += 1
                try:
                    item = self.dataset[self.indices[my_idx]]
                except Exception as e:  # raised to the consumer in order
                    item = e
                with cond:
                    results[my_idx] = item
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with cond:
                    while i not in results:
                        cond.wait(0.05)
                    item = results.pop(i)
                    next_emit[0] = i + 1
                    cond.notify_all()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            with cond:
                cond.notify_all()


class _TransformedView:
    """The dataset with ``transform`` applied in ``__getitem__`` (on the
    loader's threads).  A transform of two positional parameters gets
    ``(sample, rng)``, ``rng`` seeded by (seed, epoch, index)."""

    def __init__(self, dataset, transform: Callable, epoch_idx: int,
                 seed: int):
        self.dataset = dataset
        self.transform = transform
        self.epoch_idx = epoch_idx
        self.seed = seed
        try:
            n_pos = sum(
                1 for p in inspect.signature(transform).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
            self._takes_rng = n_pos >= 2
        except (TypeError, ValueError):
            self._takes_rng = False

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        sample = self.dataset[i]
        if self._takes_rng:
            rng = np.random.default_rng((self.seed, self.epoch_idx, int(i)))
            return self.transform(sample, rng)
        return self.transform(sample)


class TrainBatcher:
    """Fixed-shape numpy train batches, an epoch at a time: the items in
    ``default_rng(epoch).permutation`` order, the last partial batch
    dropped (the JAX package's order at one process)."""

    def __init__(self, dataset, batch_size: int, transform: Callable,
                 seed: int = 0, num_workers: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.seed = seed
        self.num_workers = num_workers

    def epoch(self, epoch_idx: int, start: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of epoch ``epoch_idx`` from its ``start``-th on
        (the ones before are not read)."""
        order = np.random.default_rng(epoch_idx).permutation(len(self.dataset))
        order = order[start * self.batch_size:]
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch_idx)
        view = _TransformedView(self.dataset, self.transform, epoch_idx,
                                self.seed)
        loader = PrefetchLoader(view, order, num_workers=self.num_workers,
                                prefetch=2 * self.batch_size)
        buf = []
        for sample in loader:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate(buf)
                buf = []

    @staticmethod
    def collate(samples) -> Dict[str, np.ndarray]:
        t = len(samples[0]["curr_img"])

        def frames(key):
            return np.stack([np.stack([s[key][i] for s in samples])
                             for i in range(t)])

        return {
            "ref_img": np.stack([s["ref_img"] for s in samples]),
            "prev_img": np.stack([s["prev_img"] for s in samples]),
            "curr_img": frames("curr_img"),
            "ref_label": np.stack([s["ref_label"] for s in samples]
                                  ).astype(np.int32),
            "prev_label": np.stack([s["prev_label"] for s in samples]
                                   ).astype(np.int32),
            "curr_label": frames("curr_label").astype(np.int32),
            "obj_num": np.array([s["meta"]["obj_num"] for s in samples],
                                np.int32),
        }
