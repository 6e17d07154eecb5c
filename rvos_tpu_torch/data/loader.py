"""Ordered prefetch over a dataset on threads (the port's own copy of
``rvos_tpu/data/loader.py::PrefetchLoader``).

Frame decode, the perturbation and the eval resize run in
``__getitem__`` of the wrapped dataset, on ``num_workers`` threads
(decode and numpy transforms release the GIL), at most ``prefetch``
items ahead of the consumer; items come out in index order, and an
exception raised by a worker reaches the consumer when its item's turn
comes.  One worker reads in the consumer's thread.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional, Sequence


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
