"""The one generator of every traffic mix: the batches a cell feeds the
train step, in order, from the mix's parameters.

A mix file (``traffic/<name>.json``) holds:

- ``mode``: ``"stream"`` (the pool reshuffled on every pass, batches
  collated by the port's prefetch threads as they are needed) or
  ``"resident"`` (the pool cut into fixed batches once, each collated once
  and kept on the card by the dataset's collate cache, then cycled; the
  graphs are dealt to the batches by size, so that every seed gets
  batches of the same sizes, in another order);
- ``pool_batches``: the pool's size in batches of the configuration's
  ``batch_size`` (the configuration's ``train_pool`` must equal it);
- ``prefetch``: batches collated ahead (``GraphDataset.iter_collated``);
- ``warmup_steps``: steps run before the window, the first three of them
  the checked ones (at least one pass, so that every batch shape and every
  allocation the window meets has been seen);
- ``trace_steps``: steps of the profiled window of a ``--trace 1`` run.

All the batches stream through one ``iter_collated`` call, so the
prefetch pipeline never restarts.  Batch ``k`` is pass ``k // P`` (``P``
batches a pass), and its step key is ``step_key(seed, 0, pass + 1, k % P)``
as the training loop's.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def balanced_cut(sizes, batch_size: int, rng: np.random.Generator) -> np.ndarray:
    """The pool as whole batches of near-equal total size: the graphs,
    largest first, dealt to the batches back and forth; then each batch's
    graphs and the batches' order shuffled.  Returns the flat order."""
    n = len(sizes)
    per_pass = n // batch_size
    batches = [[] for _ in range(per_pass)]
    for r, i in enumerate(np.argsort(-np.asarray(sizes), kind="stable")):
        row, pos = divmod(r, per_pass)
        batches[pos if row % 2 == 0 else per_pass - 1 - pos].append(int(i))
    return np.concatenate([rng.permutation(batches[b]) for b in rng.permutation(per_pass)])


class BatchOrder(Sequence):
    """The index lists of batch 0, 1, ... (a lazy, practically endless
    sequence): each pass a permutation of the pool drawn from ``(seed,
    pass)``, or, without ``reshuffle``, the same :func:`balanced_cut` of
    the graphs' ``sizes`` every pass."""

    LENGTH = 10**7

    def __init__(self, sizes, batch_size: int, seed: int, reshuffle: bool):
        n_pool = len(sizes)
        if n_pool % batch_size:
            raise ValueError("the pool must be whole batches")
        self.n_pool, self.batch_size, self.seed = n_pool, batch_size, seed
        self.per_pass = n_pool // batch_size
        self.reshuffle = reshuffle
        self._order = None
        self._order_pass = -1
        self._fixed = balanced_cut(sizes, batch_size, np.random.default_rng((seed, 0)))

    def __len__(self) -> int:
        return self.LENGTH

    def _pass_order(self, p: int) -> np.ndarray:
        if not self.reshuffle:
            return self._fixed
        if p != self._order_pass:
            self._order = np.random.default_rng((self.seed, p)).permutation(self.n_pool)
            self._order_pass = p
        return self._order

    def __getitem__(self, k):
        if isinstance(k, slice):
            return [self[i] for i in range(*k.indices(len(self)))]
        p, i = divmod(int(k), self.per_pass)
        lo = i * self.batch_size
        return self._pass_order(p)[lo:lo + self.batch_size].copy()

    def key_args(self, k: int):
        """``(epoch, i)`` of batch ``k`` for ``train.loop.step_key``."""
        p, i = divmod(int(k), self.per_pass)
        return p + 1, i


class Feed:
    """``next()`` -> ``(k, batch, key)``: the cell's batches on the card,
    in order, through the dataset's own streaming."""

    def __init__(self, dataset, cfg: dict, traffic: dict, seed: int):
        from fastegnn_tpu_torch.train.loop import step_key

        mode = traffic["mode"]
        if mode not in ("stream", "resident"):
            raise ValueError(f"unknown traffic mode {mode!r}")
        if cfg["train_pool"] != traffic["pool_batches"] * cfg["batch_size"]:
            raise ValueError("train_pool must be pool_batches x batch_size")
        if len(dataset) != cfg["train_pool"]:
            raise ValueError("the dataset is not the configuration's pool")
        self.order = BatchOrder([g["n_edges"] for g in dataset.graphs], cfg["batch_size"], seed,
                                reshuffle=mode == "stream")
        if mode == "resident":
            dataset.enable_collate_cache()
        self._step_key = step_key
        self.seed = seed
        self._it = dataset.iter_collated(self.order, prefetch=traffic["prefetch"])
        self.k = 0

    def __next__(self):
        batch = next(self._it)
        k = self.k
        self.k += 1
        return k, batch, self._step_key(self.seed, 0, *self.order.key_args(k))

    def close(self) -> None:
        """Stop the prefetch threads and wait for them."""
        self._it.close()
