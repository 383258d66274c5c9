"""PartitionedDataset — the port's copy of the RDD surface.

The port of ``distributeddeeplearningspark_tpu/rdd.py``: a lazy,
partitioned collection whose partitions are plain Python thunks producing
iterables on the host. Transformations (``map``, ``map_parallel``,
``filter``, ``flat_map``, ``map_partitions``, ``map_partitions_with_index``,
``batch``, ``shuffle``, ``repeat``, ``coalesce``, ``union``, ``sample``,
``cache``, ``zip_with_index``) wrap the thunks; actions (``collect``,
``count``, ``take``, ``first``, ``reduce``, ``tree_aggregate``,
``foreach_partition``) run them; pyspark's camelCase spellings are aliases.
The device never sees a dataset: :mod:`.data.feed` stacks its examples into
batches.

The wide operations (``distinct``, ``reduce_by_key``, ``group_by_key``,
``sort_by``) have two paths, as in the JAX package:

- **serial** (no workers): a per-partition combine, then a driver-side
  dict bounded by the ``max_groups`` ceiling (``DLS_AGG_MAX_GROUPS``),
  which refuses high-cardinality keys loudly instead of growing without
  bound;
- **the distributed exchange** (workers resolved above 0 from
  ``num_workers=`` or ``DLS_DATA_WORKERS``): :mod:`.data.exchange`, a
  cross-worker hash-partitioned shuffle with spill-to-disk reduce and no
  ceiling.

Both bucket by the same canonical key hash
(:func:`~.data.exchange.key_bytes`) in that order within each bucket, so
the output is the same at any worker count, and the same as the JAX
package's.
"""

from __future__ import annotations

import functools
import itertools
import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

from distributeddeeplearningspark_tpu_torch.parallel import collectives

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

    def filter(self, pred: Callable[[Any], bool]) -> "PartitionedDataset":
        return self.map_partitions(lambda it: filter(pred, it))

    def flat_map(self, f: Callable[[Any], Iterable[Any]]) -> "PartitionedDataset":
        return self.map_partitions(lambda it: itertools.chain.from_iterable(map(f, it)))

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

    def batch(self, batch_size: int, *, drop_remainder: bool = True) -> "PartitionedDataset":
        """Group elements into lists of ``batch_size`` within each partition."""

        def batcher(it: Iterable[Any]) -> Iterator[list]:
            buf: list = []
            for x in it:
                buf.append(x)
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            if buf and not drop_remainder:
                yield buf

        return self.map_partitions(batcher)

    def _require_finite(self, op: str) -> None:
        if self._infinite:
            raise ValueError(
                f"{op}() on an infinite (.repeat()) dataset would hang or "
                f"drop data — apply {op}() BEFORE .repeat()")

    def shuffle(self, seed: int = 0) -> "PartitionedDataset":
        """Per-partition shuffle (``random.Random(seed + i)`` for partition
        i; no cross-partition exchange). Shuffle before ``repeat()``: each
        pass materialises the partition once."""
        self._require_finite("shuffle")

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

    def coalesce(self, num_partitions: int) -> "PartitionedDataset":
        """Reduce the partition count by concatenating adjacent partitions."""
        self._require_finite("coalesce")
        if num_partitions >= self.num_partitions:
            return self
        groups = np.array_split(np.arange(self.num_partitions), num_partitions)
        parts = self._parts

        def make(idx: np.ndarray) -> PartitionFn:
            return lambda: itertools.chain.from_iterable(parts[i]() for i in idx)

        return PartitionedDataset([make(g) for g in groups],
                                  infinite=self._infinite)

    def union(self, other: "PartitionedDataset") -> "PartitionedDataset":
        """Spark ``union``: the partition lists concatenated (no dedup, no
        shuffle; the partition count is the sum)."""
        if self._infinite or other._infinite:
            raise ValueError("union() with an infinite (.repeat()) dataset "
                             "would never yield the other side's rows")
        return PartitionedDataset(self._parts + other._parts)

    def sample(self, fraction: float, seed: int = 0) -> "PartitionedDataset":
        """Spark ``sample(withReplacement=False)``: keep each element with
        probability ``fraction``, independently (deterministic per seed and
        partition; narrow, nothing materialized)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")

        def samp(i: int, it: Iterable[Any]) -> Iterator[Any]:
            rng = random.Random((seed << 16) ^ i)
            return (x for x in it if rng.random() < fraction)

        return self.map_partitions_with_index(samp)

    def distinct(self, *, num_workers: int | None = None,
                 transport: str | None = None) -> "PartitionedDataset":
        """Spark ``distinct`` (hashable elements).

        With workers: the exchange dedups per bucket with spill-to-disk,
        output hash-partitioned over the input's partition count in
        canonical ``key_bytes`` order; plain ``int``/``float`` batches ride
        the columnar transport unless ``transport="tuple"`` (the same
        output either way). Serial: a cross-partition set on first
        iteration, the output in first-occurrence order collapsed to
        partition 0 (like ``distinct().coalesce(1)``), refusing past the
        ``max_groups`` ceiling."""
        self._require_finite("distinct")
        from distributeddeeplearningspark_tpu_torch.data import exchange

        nw = exchange.resolve_shuffle_workers(num_workers)
        if nw:
            return exchange.distinct(self, nw, transport=transport)
        parts = self._parts
        limit = exchange.max_groups_limit()

        def gen() -> Iterator[Any]:
            seen: set = set()
            for p in parts:
                for x in p():
                    if x not in seen:
                        if len(seen) >= limit:
                            raise ValueError(exchange.serial_refusal(
                                "distinct()", limit, "distinct elements"))
                        seen.add(x)
                        yield x

        return PartitionedDataset([gen])

    def cache(self) -> "PartitionedDataset":
        """Spark ``cache()``: materialize each partition on its first whole
        iteration and serve later iterations from memory (small and medium
        driver-side data: vocab builds, eval sets iterated per epoch)."""
        self._require_finite("cache")

        def cached(part: PartitionFn) -> PartitionFn:
            store: list = []
            done = [False]

            def gen() -> Iterator[Any]:
                if done[0]:
                    return iter(store)

                def fill() -> Iterator[Any]:
                    # build into a local list and commit on completion: a
                    # consumer may stop mid-way (take(n)) or interleave two
                    # live iterators, and a shared store would be corrupted
                    tmp: list = []
                    for x in part():
                        tmp.append(x)
                        yield x
                    store[:] = tmp
                    done[0] = True

                return fill()

            return gen

        return PartitionedDataset([cached(p) for p in self._parts])

    def _hash_partitioned_by_key(self, op: str, num_partitions: int | None,
                                 build: Callable[[], dict]) -> "PartitionedDataset":
        """The byKey ops' serial scaffolding: ``build()`` the key→value dict
        once (memoized), bucket it once by the canonical
        :func:`~.data.exchange.key_bytes` hash, sorted by that key within
        each bucket, and serve bucket i as partition i — the JAX package's
        layout, byte for byte."""
        self._require_finite(op)
        if num_partitions is not None and num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        n_out = num_partitions or len(self._parts)
        memo: dict = {}

        def buckets() -> list:
            if "b" not in memo:
                from distributeddeeplearningspark_tpu_torch.data import exchange

                b: list = [[] for _ in range(n_out)]
                for k, v in build().items():
                    kb = exchange.key_bytes(k)
                    b[exchange.bucket_of(kb, n_out)].append((kb, k, v))
                memo["b"] = [[(k, v) for _kb, k, v in sorted(
                    bi, key=lambda t: t[0])] for bi in b]
            return memo["b"]

        def make(idx: int) -> PartitionFn:
            return lambda: iter(buckets()[idx])

        return PartitionedDataset([make(i) for i in range(n_out)])

    def reduce_by_key(self, f: Callable[[Any, Any], Any],
                      num_partitions: int | None = None, *,
                      num_workers: int | None = None,
                      combine: str | None = None,
                      transport: str | None = None) -> "PartitionedDataset":
        """Spark ``reduceByKey`` over (key, value) pairs (``f`` commutative
        and associative). With workers: through the exchange (mappers
        combine per slice, per-bucket reducers spill to disk under
        ``DLS_SHUFFLE_MEM_MB``, no ceiling). Serial: a map-side combine
        per partition, then a driver-side dict refusing past the
        ``max_groups`` ceiling. Either way the output is hash-partitioned
        over ``num_partitions`` (default: the input's count) in canonical
        key order. ``combine`` (``"sum"``/``"min"``/``"max"``) declares
        ``f``'s numeric semantics, so plain ``int``/``float`` scalar pairs
        ride the exchange's columnar transport (``transport="tuple"``
        keeps the pickled path; the output is the same)."""
        self._require_finite("reduce_by_key")
        from distributeddeeplearningspark_tpu_torch.data import exchange

        if num_partitions is not None and num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        if combine is not None and combine not in exchange.NUMERIC_COMBINES:
            raise ValueError(
                f"combine={combine!r} not in {exchange.NUMERIC_COMBINES}")
        nw = exchange.resolve_shuffle_workers(num_workers)
        if nw:
            return exchange.reduce_by_key(
                self, f, num_partitions or len(self._parts), nw,
                combine=combine, transport=transport)
        parts = self._parts
        limit = exchange.max_groups_limit()

        def merged() -> dict:
            acc: dict = {}
            for p in parts:
                local: dict = {}
                for k, v in p():
                    local[k] = f(local[k], v) if k in local else v
                for k, v in local.items():
                    if k not in acc and len(acc) >= limit:
                        raise ValueError(exchange.serial_refusal(
                            "reduce_by_key()", limit))
                    acc[k] = f(acc[k], v) if k in acc else v
            return acc

        return self._hash_partitioned_by_key("reduce_by_key", num_partitions, merged)

    def group_by_key(self, num_partitions: int | None = None, *,
                     num_workers: int | None = None) -> "PartitionedDataset":
        """Spark ``groupByKey``: (key, [values...]) with the values in
        partition-major encounter order on both paths (the exchange tags
        each value with its source position and sorts the lists back at
        emit). Serial: a dict of lists, refusing past the ``max_groups``
        distinct keys."""
        self._require_finite("group_by_key")
        from distributeddeeplearningspark_tpu_torch.data import exchange

        if num_partitions is not None and num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        nw = exchange.resolve_shuffle_workers(num_workers)
        if nw:
            return exchange.group_by_key(
                self, num_partitions or len(self._parts), nw)
        parts = self._parts
        limit = exchange.max_groups_limit()

        def grouped() -> dict:
            acc: dict = {}
            for p in parts:
                for k, v in p():
                    if k not in acc and len(acc) >= limit:
                        raise ValueError(exchange.serial_refusal(
                            "group_by_key()", limit))
                    acc.setdefault(k, []).append(v)
            return acc

        return self._hash_partitioned_by_key("group_by_key", num_partitions, grouped)

    def sort_by(self, key: Callable[[Any], Any], *, ascending: bool = True,
                num_partitions: int | None = None,
                num_workers: int | None = None) -> "PartitionedDataset":
        """Spark ``sortBy``: totally ordered output, range-partitioned so
        partition i's elements all precede partition i+1's (descending
        reverses it; equal keys keep their encounter order). With workers:
        a range-partitioned external sort through the exchange (boundaries
        from a deterministic sample, spilled sorted runs, a k-way merge);
        the concatenated stream equals the serial sort, the boundaries fall
        on sample quantiles. Serial: one driver-side sort, refusing past
        the ``max_groups`` ceiling (here a bound on all elements)."""
        self._require_finite("sort_by")
        from distributeddeeplearningspark_tpu_torch.data import exchange

        if num_partitions is not None and num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        n_out = num_partitions or len(self._parts)
        nw = exchange.resolve_shuffle_workers(num_workers)
        if nw:
            return exchange.sort_by(self, key, ascending=ascending,
                                    n_out=n_out, num_workers=nw)
        parts = self._parts
        limit = exchange.max_groups_limit()
        memo: dict = {}

        def sorted_all() -> list:
            if "data" not in memo:
                data: list = []
                for p in parts:
                    for x in p():
                        if len(data) >= limit:
                            raise ValueError(exchange.serial_refusal(
                                "sort_by()", limit, "materialized elements"))
                        data.append(x)
                data.sort(key=key, reverse=not ascending)
                memo["data"] = data
            return memo["data"]

        def make(idx: int) -> PartitionFn:
            def gen() -> Iterator[Any]:
                data = sorted_all()
                per = -(-len(data) // n_out) or 1
                return iter(data[idx * per:(idx + 1) * per])
            return gen

        return PartitionedDataset([make(i) for i in range(n_out)])

    def zip_with_index(self) -> "PartitionedDataset":
        """(element, global index) pairs; counts the earlier partitions on
        the driver first."""
        self._require_finite("zip_with_index")
        sizes = [sum(1 for _ in p()) for p in self._parts]
        offsets = list(itertools.accumulate([0] + sizes[:-1]))

        def zipper(i: int, it: Iterable[Any]) -> Iterator[tuple]:
            return ((x, offsets[i] + j) for j, x in enumerate(it))

        return self.map_partitions_with_index(zipper)

    # -- actions (eager, on the host) ---------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def iter_partition(self, i: int) -> Iterator[Any]:
        return iter(self._parts[i]())

    def collect(self) -> list:
        self._require_finite("collect")
        return [x for p in self._parts for x in p()]

    def count(self) -> int:
        self._require_finite("count")
        return sum(sum(1 for _ in p()) for p in self._parts)

    def take(self, n: int) -> list:
        out: list = []
        for p in self._parts:
            for x in p():
                out.append(x)
                if len(out) == n:
                    return out
        return out

    def first(self) -> Any:
        taken = self.take(1)
        if not taken:
            raise ValueError("empty dataset")
        return taken[0]

    def reduce(self, f: Callable[[Any, Any], Any]) -> Any:
        return functools.reduce(f, self.collect())

    def tree_aggregate(self, zero: Any, seq_op: Callable[[Any, Any], Any],
                       comb_op: Callable[[Any, Any], Any]) -> Any:
        """Spark ``treeAggregate``: a fold per partition from a copy of
        ``zero``, then the partials combined on the driver
        (:func:`..parallel.collectives.tree_aggregate`)."""
        return collectives.tree_aggregate((p() for p in self._parts), zero, seq_op,
                                          comb_op)

    def foreach_partition(self, f: Callable[[Iterable[Any]], None]) -> None:
        for p in self._parts:
            f(p())

    # -- pyspark camelCase aliases ------------------------------------------

    mapPartitions = map_partitions
    mapPartitionsWithIndex = map_partitions_with_index
    flatMap = flat_map
    treeAggregate = tree_aggregate
    zipWithIndex = zip_with_index
    foreachPartition = foreach_partition
    reduceByKey = reduce_by_key
    groupByKey = group_by_key
    sortBy = sort_by

    def getNumPartitions(self) -> int:
        """pyspark spells this as a method; kept callable for ported code."""
        return self.num_partitions

    def __repr__(self) -> str:
        return f"PartitionedDataset(num_partitions={self.num_partitions})"
