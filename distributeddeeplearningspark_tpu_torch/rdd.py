"""PartitionedDataset — the port's copy of the RDD surface it uses.

The port of the part of ``distributeddeeplearningspark_tpu/rdd.py`` that
the training path calls: a lazy, partitioned collection whose partitions
are plain Python thunks producing iterables on the host. Transformations
(``map``, ``map_parallel``, ``map_partitions``,
``map_partitions_with_index``, ``shuffle``, ``repeat``) wrap the thunks;
actions (``take``, ``collect``) run them. The device never sees a dataset:
:mod:`.data.feed` stacks its examples into batches.

The wide operations (``reduce_by_key``, ``sort_by``, the exchange), the
sampling and caching helpers and the pyspark camelCase aliases are not
ported yet.
"""

from __future__ import annotations

import functools
import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

PartitionFn = Callable[[], Iterable[Any]]


class PartitionedDataset:
    """A lazy, partitioned dataset (RDD-shaped). ``infinite=True`` marks a
    dataset whose partitions never exhaust (``repeat()``)."""

    def __init__(self, partition_fns: Sequence[PartitionFn], *,
                 infinite: bool = False):
        self._parts: tuple[PartitionFn, ...] = tuple(partition_fns)
        self._infinite = infinite

    @property
    def is_infinite(self) -> bool:
        return self._infinite

    # -- construction -------------------------------------------------------

    @staticmethod
    def parallelize(data: Sequence | Iterable, num_slices: int) -> "PartitionedDataset":
        """Split ``data`` into ``num_slices`` partitions (Spark's slicing rule:
        contiguous, sizes differing by at most one)."""
        if num_slices < 1:
            raise ValueError("num_slices must be >= 1")
        if isinstance(data, np.ndarray):
            chunks = np.array_split(data, num_slices)
            return PartitionedDataset([functools.partial(lambda c: c, c) for c in chunks])
        items = list(data)
        n = len(items)
        bounds = [(i * n // num_slices, (i + 1) * n // num_slices) for i in range(num_slices)]
        return PartitionedDataset(
            [functools.partial(lambda lo, hi: items[lo:hi], lo, hi) for lo, hi in bounds]
        )

    @staticmethod
    def from_generators(gens: Sequence[PartitionFn]) -> "PartitionedDataset":
        return PartitionedDataset(gens)

    # -- transformations (lazy) ---------------------------------------------

    def map(self, f: Callable[[Any], Any]) -> "PartitionedDataset":
        return self.map_partitions(lambda it: map(f, it))

    def map_parallel(self, f: Callable[[Any], Any], *,
                     num_threads: int | None = None) -> "PartitionedDataset":
        """``map`` with a bounded thread pool per partition, order-preserving:
        a sliding window of ``2 × threads`` futures keeps memory bounded and
        works on infinite (``repeat()``) streams. ``num_threads`` 0/1 is a
        plain serial map; the default divides the host's cores by the
        partition count (the feed opens every partition at once)."""
        if num_threads in (0, 1):
            return self.map(f)
        workers = num_threads or min(
            32, max(1, (os.cpu_count() or 4) // max(self.num_partitions, 1)))

        def per_partition(it: Iterable[Any]) -> Iterator[Any]:
            with ThreadPoolExecutor(workers) as ex:
                window: deque = deque()
                for item in it:
                    window.append(ex.submit(f, item))
                    if len(window) >= 2 * workers:
                        yield window.popleft().result()
                while window:
                    yield window.popleft().result()

        return self.map_partitions(per_partition)

    def map_partitions(
        self, f: Callable[[Iterable[Any]], Iterable[Any]]
    ) -> "PartitionedDataset":
        def wrap(part: PartitionFn) -> PartitionFn:
            return lambda: f(part())

        return PartitionedDataset([wrap(p) for p in self._parts],
                                  infinite=self._infinite)

    def map_partitions_with_index(
        self, f: Callable[[int, Iterable[Any]], Iterable[Any]]
    ) -> "PartitionedDataset":
        def wrap(i: int, part: PartitionFn) -> PartitionFn:
            return lambda: f(i, part())

        return PartitionedDataset([wrap(i, p) for i, p in enumerate(self._parts)],
                                  infinite=self._infinite)

    def shuffle(self, seed: int = 0) -> "PartitionedDataset":
        """Per-partition shuffle (``random.Random(seed + i)`` for partition
        i; no cross-partition exchange). Shuffle before ``repeat()``: each
        pass materialises the partition once."""
        if self._infinite:
            raise ValueError(
                "shuffle() on an infinite (.repeat()) dataset would hang or "
                "drop data — apply shuffle() BEFORE .repeat()")

        def shuf(i: int, it: Iterable[Any]) -> Iterable[Any]:
            items = list(it)
            random.Random(seed + i).shuffle(items)
            return items

        return self.map_partitions_with_index(shuf)

    def repeat(self, count: int | None = None) -> "PartitionedDataset":
        """Repeat each partition ``count`` times (None = forever)."""

        def rep(part: PartitionFn) -> PartitionFn:
            def gen() -> Iterator[Any]:
                if count is None:
                    while True:
                        yield from part()
                else:
                    for _ in range(count):
                        yield from part()

            return gen

        return PartitionedDataset([rep(p) for p in self._parts],
                                  infinite=count is None or self._infinite)

    # -- actions (eager, on the host) ---------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def iter_partition(self, i: int) -> Iterator[Any]:
        return iter(self._parts[i]())

    def collect(self) -> list:
        if self._infinite:
            raise ValueError(
                "collect() on an infinite (.repeat()) dataset would hang — "
                "apply collect() BEFORE .repeat()")
        return [x for p in self._parts for x in p()]

    def take(self, n: int) -> list:
        out: list = []
        for p in self._parts:
            for x in p():
                out.append(x)
                if len(out) == n:
                    return out
        return out

    def __repr__(self) -> str:
        return f"PartitionedDataset(num_partitions={self.num_partitions})"
