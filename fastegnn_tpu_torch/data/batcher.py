"""Host-side dataset -> GraphBatch streaming (counterpart of
``fastegnn_tpu/data/batcher.py``).

A dataset is a list of *pre-padded* single-graph dicts
(:func:`fastegnn_tpu_torch.graph.pad_graph`) plus a per-graph
:class:`GraphSpec`; a batch stacks ``batch_size`` of them into one
:class:`GraphBatch` on the dataset's device.  Batch shapes depend only on
``(spec, batch_size)``.

A batch is collated on the host into CPU tensors and moved to the device by
the thread that consumes it, with a non-blocking copy, so that the
prefetch threads put no work on a CUDA stream.  On a card the prefetch
thread also copies the batch into page-locked memory (as torch's
``DataLoader`` pins in a thread of its own), which the copy to the card
needs to overlap the host.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence

import numpy as np

from fastegnn_tpu_torch import resolve_device
from fastegnn_tpu_torch.graph import GraphBatch, GraphSpec, batch_graphs


class GraphDataset:
    """A sequence of padded graphs with a shared per-graph spec, batched onto
    ``device`` (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, graphs: Sequence[dict], spec: GraphSpec, device=None):
        if spec.n_graphs != 1:
            raise ValueError("per-graph spec must have n_graphs=1")
        self.graphs: List[dict] = list(graphs)
        self.spec = spec
        self.device = resolve_device(device)
        self._collate_cache: Optional[dict] = None
        # host seconds of each collate, appended by whichever thread ran it
        self.collate_seconds: List[float] = []

    def enable_collate_cache(self) -> None:
        """Memoize collated device batches by index tuple.  Use for eval
        datasets, whose (unshuffled) batches repeat every eval epoch."""
        self._collate_cache = {}

    def __len__(self) -> int:
        return len(self.graphs)

    def batch_spec(self, batch_size: int) -> GraphSpec:
        return dataclasses.replace(self.spec, n_graphs=batch_size)

    def _cached(self, indices) -> Optional[GraphBatch]:
        if self._collate_cache is None:
            return None
        return self._collate_cache.get(tuple(int(i) for i in indices))

    def _host_batch(self, indices) -> Optional[GraphBatch]:
        """The batch as CPU tensors, page-locked when the device is a card;
        None when the cache already holds it.  Runs in the prefetch thread."""
        if self._cached(indices) is not None:
            return None
        t0 = time.perf_counter()
        out = batch_graphs([self.graphs[i] for i in indices],
                           self.batch_spec(len(indices)), device="cpu")
        if self.device.type == "cuda":
            out = out.pin_memory()
        self.collate_seconds.append(time.perf_counter() - t0)
        return out

    def _to_device(self, indices, host: Optional[GraphBatch]) -> GraphBatch:
        """Runs in the consuming thread."""
        hit = self._cached(indices)
        if hit is not None:
            return hit
        out = host.to(self.device, non_blocking=True)
        if self._collate_cache is not None:
            self._collate_cache[tuple(int(i) for i in indices)] = out
        return out

    def collate(self, indices: Sequence[int]) -> GraphBatch:
        return self._to_device(indices, self._host_batch(indices))

    def iter_batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = True,
        prefetch: int = 2,
    ) -> Iterator[GraphBatch]:
        """Yield batches; shuffled when ``rng`` is given.  ``drop_last``
        mirrors the reference loaders.

        ``prefetch`` > 0 collates up to that many batches ahead in
        background threads, so that the host's collate overlaps the
        device's step."""
        order = np.arange(len(self.graphs))
        if rng is not None:
            rng.shuffle(order)
        n = len(order)
        end = n - (n % batch_size) if drop_last else n
        index_lists = [order[lo:lo + batch_size] for lo in range(0, end, batch_size)]
        if prefetch <= 0 or len(index_lists) <= 1:
            for idx in index_lists:
                yield self.collate(idx)
            return
        with ThreadPoolExecutor(max_workers=min(prefetch, 4)) as pool:
            pending = [(idx, pool.submit(self._host_batch, idx))
                       for idx in index_lists[:prefetch]]
            nxt = prefetch
            try:
                while pending:
                    idx, fut = pending.pop(0)
                    if nxt < len(index_lists):
                        nidx = index_lists[nxt]
                        pending.append((nidx, pool.submit(self._host_batch, nidx)))
                        nxt += 1
                    yield self._to_device(idx, fut.result())
            finally:
                for _, fut in pending:
                    fut.cancel()

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self.graphs)
        return n // batch_size if drop_last else -(-n // batch_size)
