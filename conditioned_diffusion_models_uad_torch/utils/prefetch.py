"""Ordered read-ahead on a thread pool (counterpart of
``conditioned_diffusion_models_uad_tpu/native/binding.py::PrefetchLoader``,
same interface, no compiled code): ``fn(item)`` runs on worker threads (zlib
decodes and torch ops release the GIL), and results come back in item order
with up to ``prefetch`` in flight."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


class PrefetchLoader:
    def __init__(self, items: Sequence, fn: Callable, num_threads: int = 4,
                 prefetch: int = 8):
        self.items = list(items)
        self.fn = fn
        self.num_threads = num_threads
        self.prefetch = prefetch

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator:
        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            it = iter(self.items)
            futures = [ex.submit(self.fn, item)
                       for _, item in zip(range(self.prefetch), it)]
            while futures:
                fut = futures.pop(0)
                for item in it:
                    futures.append(ex.submit(self.fn, item))
                    break
                yield fut.result()
