"""DataFrame — the Spark-SQL-shaped feature-engineering plane.

The port's copy of ``distributeddeeplearningspark_tpu/data/dataframe.py``
(numpy on the host; the one torch path is ``groupBy().agg(transport=
"device")``, through :mod:`.device_agg`). Config 4 ("Wide&Deep / DLRM
recommender on Criteo") feeds the trainer from DataFrame features:
``spark.read.csv`` → ``withColumn`` / ``fillna`` / hashing → executor
partitions → :meth:`DataFrame.to_dataset` → the trainer's feed.

- **Columnar partitions.** A DataFrame partition is a stream of *column
  chunks* (``dict[str, np.ndarray]``, a few thousand rows each). All
  expressions evaluate vectorized over whole chunks — numpy is the host-side
  vector engine standing in for Spark SQL's generated loops — so the
  feature plane does no per-row Python but the text parse and the row view.
- **Lazy + partition-parallel**, riding :class:`~..rdd.PartitionedDataset`:
  transformations compose chunk functions; actions materialize. One
  partition ≙ one data shard, same as the RDD plane.
- **Aggregation on four routes.** ``groupBy(...).agg(...)`` merges chunk
  partials in a driver dict bounded by the ``max_groups`` ceiling without
  workers; with workers it takes the distributed exchange
  (:mod:`.exchange`, ``tuple`` or ``columnar`` transport, spilling to disk,
  no ceiling); ``transport="device"`` folds the numeric combines on the
  card (:mod:`.device_agg`). Every route emits the same rows in the same
  canonical order. Joins are out of scope.

Expressions are :class:`Column` trees built from :func:`col` / :func:`lit`
and composed with operators and functions (:func:`log1p`,
:func:`hash_bucket`, ...), mirroring ``pyspark.sql.functions``.
"""

from __future__ import annotations

import itertools
import zlib
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset

Chunk = dict[str, np.ndarray]

DEFAULT_CHUNK_ROWS = 4096


# ---------------------------------------------------------------------------
# Column expressions
# ---------------------------------------------------------------------------

class Column:
    """A vectorized expression over column chunks (pyspark ``Column``-shaped).

    Wraps ``fn(chunk) -> np.ndarray`` plus the output name. Operators build
    new Columns; nothing evaluates until a DataFrame action runs.
    """

    def __init__(self, fn: Callable[[Chunk], np.ndarray], name: str):
        self._fn = fn
        self._name = name

    def __call__(self, chunk: Chunk) -> np.ndarray:
        return self._fn(chunk)

    @property
    def name(self) -> str:
        return self._name

    def alias(self, name: str) -> "Column":
        return Column(self._fn, name)

    def cast(self, dtype) -> "Column":
        return Column(lambda c: self._fn(c).astype(dtype), self._name)

    # -- operators ----------------------------------------------------------

    def _bin(self, other, op, sym) -> "Column":
        other = other if isinstance(other, Column) else lit(other)
        return Column(lambda c: op(self._fn(c), other._fn(c)),
                      f"({self._name} {sym} {other._name})")

    def __add__(self, o): return self._bin(o, np.add, "+")
    def __radd__(self, o): return lit(o)._bin(self, np.add, "+")
    def __sub__(self, o): return self._bin(o, np.subtract, "-")
    def __rsub__(self, o): return lit(o)._bin(self, np.subtract, "-")
    def __mul__(self, o): return self._bin(o, np.multiply, "*")
    def __rmul__(self, o): return lit(o)._bin(self, np.multiply, "*")
    def __truediv__(self, o): return self._bin(o, np.divide, "/")
    def __mod__(self, o): return self._bin(o, np.mod, "%")
    def __gt__(self, o): return self._bin(o, np.greater, ">")
    def __ge__(self, o): return self._bin(o, np.greater_equal, ">=")
    def __lt__(self, o): return self._bin(o, np.less, "<")
    def __le__(self, o): return self._bin(o, np.less_equal, "<=")
    def __eq__(self, o):  # noqa: D105 — pyspark semantics: expr, not identity
        return self._bin(o, np.equal, "==")
    def __ne__(self, o): return self._bin(o, np.not_equal, "!=")
    def __and__(self, o): return self._bin(o, np.logical_and, "&")
    def __or__(self, o): return self._bin(o, np.logical_or, "|")
    def __invert__(self): return Column(lambda c: np.logical_not(self._fn(c)),
                                        f"(~{self._name})")
    __hash__ = None  # unhashable, like pyspark Columns

    def fillna(self, value) -> "Column":
        """NaN (float) / '' (string) → ``value``."""
        def fn(c: Chunk) -> np.ndarray:
            x = self._fn(c)
            if x.dtype.kind == "f":
                return np.where(np.isnan(x), np.asarray(value, x.dtype), x)
            if x.dtype.kind in ("U", "S", "O"):
                return np.where(x == "", value, x)
            return x
        return Column(fn, self._name)

    def isNotNull(self) -> "Column":
        def fn(c: Chunk) -> np.ndarray:
            x = self._fn(c)
            if x.dtype.kind == "f":
                return ~np.isnan(x)
            if x.dtype.kind in ("U", "S", "O"):
                return x != ""
            return np.ones(len(x), bool)
        return Column(fn, f"({self._name} IS NOT NULL)")

    def isNull(self) -> "Column":
        inner = self.isNotNull()
        return Column(lambda c: ~inner(c), f"({self._name} IS NULL)")


def col(name: str) -> Column:
    def fn(chunk: Chunk) -> np.ndarray:
        try:
            return chunk[name]
        except KeyError:
            raise KeyError(
                f"no column {name!r}; have {sorted(chunk)}") from None
    return Column(fn, name)


def lit(value) -> Column:
    def fn(chunk: Chunk) -> np.ndarray:
        n = len(next(iter(chunk.values()))) if chunk else 0
        return np.full(n, value)
    return Column(fn, str(value))


def log1p(c: Column) -> Column:
    """``log(1+x)`` with negatives clamped to 0 first — the standard Criteo
    dense-feature transform (negatives appear in the raw dumps)."""
    return Column(lambda ch: np.log1p(np.maximum(c(ch), 0.0)),
                  f"log1p({c.name})")


def clip(c: Column, lo, hi) -> Column:
    return Column(lambda ch: np.clip(c(ch), lo, hi), f"clip({c.name})")


def when(cond: Column, value) -> "_When":
    return _When([(cond, value)])


class _When:
    """``when(cond, v).otherwise(d)`` chain (vectorized nested where)."""

    def __init__(self, branches: list):
        self._branches = branches

    def when(self, cond: Column, value) -> "_When":
        return _When(self._branches + [(cond, value)])

    def otherwise(self, default) -> Column:
        branches = self._branches

        def fn(chunk: Chunk) -> np.ndarray:
            default_c = default if isinstance(default, Column) else lit(default)
            out = default_c(chunk)
            for cond, value in reversed(branches):
                value_c = value if isinstance(value, Column) else lit(value)
                out = np.where(cond(chunk), value_c(chunk), out)
            return out
        return Column(fn, "CASE WHEN")


def _hash_int_array(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer — deterministic across processes."""
    z = x.astype(np.uint64, copy=True)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hash_bucket(c: Column, num_buckets: int) -> Column:
    """Stable hash → ``[0, num_buckets)`` int32 (Spark's feature hashing).

    Numeric columns hash via a vectorized splitmix64; string columns via
    crc32 (per-element, host-side — fine at feature-engineering rates).
    Deterministic across runs and processes, unlike Python's ``hash``.
    """
    if num_buckets < 1:
        raise ValueError("num_buckets must be >= 1")

    def fn(chunk: Chunk) -> np.ndarray:
        x = c(chunk)
        if x.dtype.kind in ("i", "u"):
            h = _hash_int_array(x)
        elif x.dtype.kind == "f":
            h = _hash_int_array(x.astype(np.float64).view(np.uint64))
        else:
            h = np.fromiter(
                (zlib.crc32(str(s).encode()) for s in x),
                dtype=np.uint64, count=len(x))
            h = _hash_int_array(h)
        return (h % np.uint64(num_buckets)).astype(np.int32)

    return Column(fn, f"hash_bucket({c.name}, {num_buckets})")


# ---------------------------------------------------------------------------
# DataFrame
# ---------------------------------------------------------------------------

def _chunk_rows(chunk: Chunk) -> int:
    return len(next(iter(chunk.values()))) if chunk else 0


class DataFrame:
    """Lazy columnar dataset: partitions stream column chunks.

    Wraps a :class:`PartitionedDataset` whose elements are chunks
    (``dict[str, np.ndarray]``); ``columns`` is the declared schema order.
    """

    def __init__(self, chunks: PartitionedDataset, columns: Sequence[str]):
        self._chunks = chunks
        self._columns = list(columns)

    # -- schema -------------------------------------------------------------

    @property
    def columns(self) -> list[str]:
        return list(self._columns)

    @property
    def num_partitions(self) -> int:
        return self._chunks.num_partitions

    @property
    def rdd(self) -> PartitionedDataset:
        """Row view: a PartitionedDataset of per-row dicts (Spark ``df.rdd``)."""
        return self.to_dataset()

    # -- transformations (lazy) ---------------------------------------------

    def _map_chunks(self, f: Callable[[Chunk], Chunk],
                    columns: Sequence[str]) -> "DataFrame":
        return DataFrame(
            self._chunks.map_partitions(lambda it: (f(ch) for ch in it)),
            columns)

    def select(self, *exprs: str | Column) -> "DataFrame":
        cols = [col(e) if isinstance(e, str) else e for e in exprs]
        names = [c.name for c in cols]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate output columns: {names}")
        return self._map_chunks(
            lambda ch: {c.name: np.asarray(c(ch)) for c in cols}, names)

    def withColumn(self, name: str, expr: Column) -> "DataFrame":
        names = self._columns + ([] if name in self._columns else [name])

        def f(ch: Chunk) -> Chunk:
            out = dict(ch)
            out[name] = np.asarray(expr(ch))
            return out
        return self._map_chunks(f, names)

    def withColumns(self, mapping: Mapping[str, Column]) -> "DataFrame":
        """All expressions evaluate against the INPUT chunk (pyspark's
        simultaneous semantics: ``{'a': col('b'), 'b': col('a')}`` swaps)."""
        mapping = dict(mapping)
        names = list(self._columns)
        names += [n for n in mapping if n not in names]

        def f(ch: Chunk) -> Chunk:
            out = dict(ch)
            out.update({n: np.asarray(e(ch)) for n, e in mapping.items()})
            return out
        return self._map_chunks(f, names)

    def drop(self, *names: str) -> "DataFrame":
        keep = [c for c in self._columns if c not in names]
        return self._map_chunks(
            lambda ch: {k: v for k, v in ch.items() if k not in names}, keep)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        return self.withColumn(new, col(old)).drop(old) if old != new else self

    def filter(self, cond: Column) -> "DataFrame":
        def f(ch: Chunk) -> Chunk:
            m = cond(ch).astype(bool)
            return {k: v[m] for k, v in ch.items()}
        return self._map_chunks(f, self._columns)

    where = filter

    def fillna(self, value, subset: Sequence[str] | None = None) -> "DataFrame":
        names = subset if subset is not None else self._columns
        return self.withColumns({n: col(n).fillna(value) for n in names})

    def randomSplit(self, weights: Sequence[float], seed: int = 0
                    ) -> list["DataFrame"]:
        """Split rows by a deterministic per-row hash (stable across runs,
        unlike sampling state threaded through an iterator)."""
        w = np.asarray(weights, np.float64)
        if (w <= 0).any():
            raise ValueError("weights must be positive")
        edges = np.cumsum(w / w.sum())

        def part_for(bucket_frac: np.ndarray) -> np.ndarray:
            return np.searchsorted(edges, bucket_frac, side="right")

        outs = []
        for i in range(len(w)):
            def f(ch: Chunk, i=i) -> Chunk:
                n = _chunk_rows(ch)
                # row identity: position within chunk + a per-chunk content
                # fingerprint, so identical positions in different chunks
                # land independently and the split is replay-stable
                base = np.arange(n, dtype=np.uint64)
                first = next(iter(ch.values())) if ch else base
                fp = zlib.crc32(np.asarray(first).tobytes()) if n else 0
                base = base + np.uint64(fp)
                frac = (_hash_int_array(base + np.uint64(seed)) >> np.uint64(11)
                        ).astype(np.float64) / float(1 << 53)
                m = part_for(frac) == i
                return {k: v[m] for k, v in ch.items()}
            outs.append(self._map_chunks(f, self._columns))
        return outs

    def groupBy(self, *keys: str) -> "GroupedData":
        """Spark ``groupBy(...).agg(...)`` — the aggregation half of the
        Criteo feature-engineering surface (per-category counts/means are
        the classic CTR count-features). Chunk-vectorized per partition
        (np.unique over stacked key rows + bincount / ufunc.at — no
        per-row Python), then per-chunk partials merge in a driver dict:
        the same narrow-engine stance as ``rdd.reduce_by_key``'s serial
        path, sized for grouped results that
        fit the driver — which category vocabularies do; with workers
        it takes the exchange instead (:meth:`GroupedData.agg`).

        Multi-column keys are stacked for the unique pass, so mixed key
        dtypes coerce to the numpy common type (int+str keys become
        strings in the output); keep keys same-typed when that matters.
        """
        missing = [k for k in keys if k not in self._columns]
        if missing or not keys:
            raise ValueError(
                f"groupBy keys {missing or '()'} not in columns "
                f"{self._columns}")
        return GroupedData(self, list(keys))

    def repartition(self, n: int) -> "DataFrame":
        """Down: concatenate adjacent partitions. Up: split each partition's
        chunk stream round-robin (each new partition re-walks its source
        partition and keeps every k-th chunk — extra host IO, no shuffle)."""
        cur = self.num_partitions
        if n <= cur:
            return DataFrame(self._chunks.coalesce(n), self._columns)
        chunks = self._chunks
        fan = [[] for _ in range(cur)]
        for j in range(n):
            fan[j % cur].append(j)

        def make(k: int, slot: int, stride: int):
            def gen() -> Iterator[Chunk]:
                for idx, ch in enumerate(chunks.iter_partition(k)):
                    if idx % stride == slot:
                        yield ch
            return gen

        plan: dict[int, Any] = {}
        for k in range(cur):
            for slot, j in enumerate(fan[k]):
                plan[j] = (k, slot, len(fan[k]))
        parts = [make(*plan[j]) for j in range(n)]
        return DataFrame(PartitionedDataset.from_generators(parts),
                         self._columns)

    # -- actions ------------------------------------------------------------

    def _iter_chunks(self) -> Iterator[Chunk]:
        for i in range(self._chunks.num_partitions):
            yield from self._chunks.iter_partition(i)

    def count(self) -> int:
        return sum(_chunk_rows(ch) for ch in self._iter_chunks())

    def take(self, n: int) -> list[dict]:
        rows: list[dict] = []
        for ch in self._iter_chunks():
            for r in range(_chunk_rows(ch)):
                rows.append({k: v[r] for k, v in ch.items()})
                if len(rows) == n:
                    return rows
        return rows

    def collect(self) -> list[dict]:
        return self.take(float("inf"))  # type: ignore[arg-type]

    def toPandas(self):
        """Concatenate all chunks into one dict of arrays, as the JAX
        package's does: pandas is not imported (the columnar dict is what
        callers index anyway)."""
        chunks = list(self._iter_chunks())
        if not chunks:
            return {c: np.empty((0,)) for c in self._columns}
        return {c: np.concatenate([ch[c] for ch in chunks]) for c in self._columns}

    def show(self, n: int = 10) -> None:
        rows = self.take(n)
        print(" | ".join(self._columns))
        for r in rows:
            print(" | ".join(str(r[c]) for c in self._columns))

    # -- bridge to the feed/trainer -----------------------------------------

    def to_dataset(self, *, columns: Sequence[str] | None = None,
                   vector_columns: Mapping[str, Sequence[str]] | None = None
                   ) -> PartitionedDataset:
        """Row view for the device feed: a PartitionedDataset of example dicts.

        ``vector_columns`` packs scalar columns into one feature vector per
        example — e.g. ``{"dense": [f"I{i}" for i in range(13)]}`` yields a
        ``[13]`` float array per row, the DLRM input contract — packed
        vectorized per chunk, not per row.
        """
        names = list(columns) if columns is not None else list(self._columns)
        vec = {k: list(v) for k, v in (vector_columns or {}).items()}
        flat_used = {c for cols in vec.values() for c in cols}
        scalars = [c for c in names if c not in flat_used]

        def rows(it: Iterable[Chunk]) -> Iterator[dict]:
            for ch in it:
                n = _chunk_rows(ch)
                packed = {k: np.stack([ch[c] for c in cols], axis=1)
                          for k, cols in vec.items()}
                for r in range(n):
                    ex = {c: ch[c][r] for c in scalars}
                    ex.update({k: v[r] for k, v in packed.items()})
                    yield ex

        return self._chunks.map_partitions(rows)

    toDataset = to_dataset

    def __repr__(self) -> str:
        return (f"DataFrame(columns={self._columns}, "
                f"num_partitions={self.num_partitions})")


#: supported GroupedData aggregations; mean derives from (sum, count) so
#: every entry here is mergeable across chunk partials
_AGG_FNS = ("count", "sum", "mean", "min", "max")


def _agg_partial(ch: Chunk, keys: Sequence[str],
                 spec: Mapping[str, str]) -> list:
    """One chunk's vectorized group partials: ``[(key_tuple, (count,
    (col_stats, ...)))]`` with one ``col_stats`` per spec column in spec
    order — ``None`` for count-only columns, ``(sum, min|None, max|None)``
    otherwise. Per value column only the stats its fn needs are computed
    (ufunc.at is a per-element C loop; paying min/max passes for a
    sum-only spec would undercut the vectorized claim); mean derives from
    (sum, count). Keys and stats are PYTHON scalars (``.tolist()``), not
    numpy ones — a 10M-key shuffle pickles every entry, and np.int64
    pickles ~20x slower and 5x bigger than int. Keys are unique within the
    returned list (np.unique dedups the chunk). Shared by the serial
    driver merge and the distributed exchange mappers, so both paths
    produce identical partials."""
    n = _chunk_rows(ch)
    if n == 0:
        return []
    key_arrays = [np.asarray(ch[k]) for k in keys]
    for k, a in zip(keys, key_arrays):
        if a.dtype == object:
            # np.unique(axis=0) can't take object arrays and its
            # TypeError names neither column nor fix — fail clearly
            raise ValueError(
                f"groupBy key '{k}' has object dtype (e.g. None "
                f"among values); fillna()/hash_bucket it to a "
                f"concrete dtype first")
        if np.issubdtype(a.dtype, np.floating) and np.isnan(a).any():
            # tuple(nan) dict keys never compare equal, so NaN
            # groups would silently split per chunk instead of
            # merging — the fillna-first flow is the documented fix
            raise ValueError(
                f"groupBy key '{k}' contains NaN; fillna() it "
                f"first (NaN never equals NaN, so NaN groups "
                f"cannot merge)")
    stacked = np.stack(key_arrays, axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    g = uniq.shape[0]
    cnt = np.bincount(inv, minlength=g).tolist()
    cols: list = []
    for c, fn in spec.items():
        if fn == "count":
            # bincount already carries the answer; coercing the
            # column would also crash string-typed count() keys
            cols.append(None)
            continue
        v = np.asarray(ch[c], np.float64)
        s = np.bincount(inv, weights=v, minlength=g)
        mn = mx = None
        if fn == "min":
            mn = np.full(g, np.inf)
            np.minimum.at(mn, inv, v)
        elif fn == "max":
            mx = np.full(g, -np.inf)
            np.maximum.at(mx, inv, v)
        cols.append((s.tolist(),
                     None if mn is None else mn.tolist(),
                     None if mx is None else mx.tolist()))
    # zip-built (C speed): a per-key Python genexpr here was the single
    # hottest line of a 10M-key shuffle's map phase
    per_col: list = []
    for col in cols:
        if col is None:
            per_col.append(itertools.repeat(None, g))
        else:
            s, mn, mx = col
            per_col.append(zip(s,
                               mn if mn is not None
                               else itertools.repeat(None),
                               mx if mx is not None
                               else itertools.repeat(None)))
    entries = zip(cnt, zip(*per_col))
    return list(zip(map(tuple, uniq.tolist()), entries))


def _merge_agg_entry(a: tuple, b: tuple) -> tuple:
    """Merge two group partials (commutative — sum/min/max/count), the
    exchange's combine/merge function for ``groupBy().agg``."""
    cnt = a[0] + b[0]
    out: list = []
    for sa, sb in zip(a[1], b[1]):
        if sa is None:
            out.append(None)
            continue
        out.append((sa[0] + sb[0],
                    sa[1] if sb[1] is None else
                    (sb[1] if sa[1] is None else min(sa[1], sb[1])),
                    sa[2] if sb[2] is None else
                    (sb[2] if sa[2] is None else max(sa[2], sb[2]))))
    return (cnt, tuple(out))


def _agg_row_value(fn: str, cnt: int, stats) -> Any:
    """One output cell from a merged group entry — the ONE formula both
    paths share (mean = sum/count, so bit-equality follows from the
    partials being equal)."""
    if fn == "count":
        return cnt
    s, mn, mx = stats
    return {"sum": s, "mean": s / cnt if cnt else np.nan,
            "min": mn, "max": mx}[fn]


def _agg_plane_layout(spec: Mapping[str, str]) -> tuple[tuple, tuple]:
    """The columnar value-plane layout for one agg spec: plane 0 is the
    int64 group count (combined by sum), then per non-count spec column
    its f64 sum plane (+ a min or max plane when the fn needs one).
    ``slots[i]`` maps spec column i back into the plane tuple —
    ``None`` for count-only columns, else ``(sum_i, min_i, max_i)``."""
    combines: list[str] = ["sum"]
    slots: list = []
    for _c, fn in spec.items():
        if fn == "count":
            slots.append(None)
            continue
        s_i = len(combines)
        combines.append("sum")
        m_i = x_i = None
        if fn == "min":
            m_i = len(combines)
            combines.append("min")
        elif fn == "max":
            x_i = len(combines)
            combines.append("max")
        slots.append((s_i, m_i, x_i))
    return tuple(combines), tuple(slots)


def _agg_partial_planes(ch: Chunk, keys: Sequence[str],
                        spec: Mapping[str, str]):
    """One chunk's group partials as flat planes — the columnar twin of
    :func:`_agg_partial`, staying numpy end to end (no ``.tolist()``, no
    per-key tuples except the one hash pass). Returns ``None`` when the
    chunk's keys are not columnar-eligible (strings, objects, NaN floats,
    uint64) — that chunk then walks :func:`_agg_partial` and ships as
    pickled tuples, byte-identically. The key hashes ARE computed from
    the same python-scalar tuples the tuple path would pickle, so both
    formats land every key in the same bucket at the same sort position."""
    from distributeddeeplearningspark_tpu_torch.data import exchange

    key_arrays = [np.asarray(ch[k]) for k in keys]
    if any(exchange.canon_key_dtype(a.dtype) is None for a in key_arrays):
        return None
    for a in key_arrays:
        if np.issubdtype(a.dtype, np.floating):
            # NaN keys: the tuple path refuses them with the fillna
            # remediation (_agg_partial) — fall back so the error is
            # THAT error, not a silently different grouping. Zeros:
            # -0.0 == 0.0 under np.unique/dict merging but they pickle
            # to different key bytes, and only the tuple path carries
            # the dict-merge semantics — every ±0.0 float key goes
            # there (a columnar +0.0 could never merge with a
            # tuple-path -0.0 from another chunk)
            if np.isnan(a).any():
                return None
            if (a == 0).any():
                return None
    stacked = np.stack(key_arrays, axis=1)
    canon = exchange.canon_key_dtype(stacked.dtype)
    if canon is None:  # mixed dtypes promoted past fixed-width numerics
        return None
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    g = uniq.shape[0]
    h = exchange.hash_rows(list(map(tuple, uniq.tolist())))
    key_cols = tuple(np.ascontiguousarray(uniq[:, i]).astype(canon)
                     for i in range(uniq.shape[1]))
    vals: list[np.ndarray] = [
        np.bincount(inv, minlength=g).astype(np.int64)]
    for c, fn in spec.items():
        if fn == "count":
            continue
        v = np.asarray(ch[c], np.float64)
        vals.append(np.bincount(inv, weights=v, minlength=g))
        if fn == "min":
            mn = np.full(g, np.inf)
            np.minimum.at(mn, inv, v)
            vals.append(mn)
        elif fn == "max":
            mx = np.full(g, -np.inf)
            np.maximum.at(mx, inv, v)
            vals.append(mx)
    return exchange._Planes(h, key_cols, tuple(vals))


def _agg_columnar_plan(keys: Sequence[str], spec: Mapping[str, str]):
    """The agg spec's :class:`~.exchange.ColumnarPlan` plus the slot map
    read-side consumers decode value planes with."""
    from distributeddeeplearningspark_tpu_torch.data import exchange

    combines, slots = _agg_plane_layout(spec)

    def vals_to_acc(vs: tuple):
        per_col = []
        for slot in slots:
            if slot is None:
                per_col.append(None)
            else:
                s_i, m_i, x_i = slot
                per_col.append((vs[s_i],
                                vs[m_i] if m_i is not None else None,
                                vs[x_i] if x_i is not None else None))
        return (vs[0], tuple(per_col))

    plan = exchange.ColumnarPlan(
        combines=combines,
        pre_planes=lambda ch: _agg_partial_planes(ch, keys, spec),
        key_of_row=lambda kr: kr,
        vals_to_acc=vals_to_acc,
        row_emit=lambda k, vs: (k, vals_to_acc(vs)))
    return plan, slots


def _agg_chunk_from_planes(keys: Sequence[str], spec: Mapping[str, str],
                           slots: tuple):
    """Chunk builder off raw combined planes — the read-side finalize
    (mean = sum/count happens HERE, with the same f64 division
    :func:`_agg_row_value` performs per row, so the bytes agree)."""
    def build(pl) -> Chunk:
        ch: Chunk = {k: pl.keys[i] for i, k in enumerate(keys)}
        cnt = pl.vals[0]
        for (c, fn), slot in zip(spec.items(), slots):
            name = f"{fn}({c})"
            if fn == "count":
                ch[name] = cnt
            else:
                s_i, m_i, x_i = slot
                if fn == "sum":
                    ch[name] = pl.vals[s_i]
                elif fn == "mean":
                    ch[name] = pl.vals[s_i] / cnt
                elif fn == "min":
                    ch[name] = pl.vals[m_i]
                else:
                    ch[name] = pl.vals[x_i]
        return ch

    return build


class GroupedData:
    """Result of :meth:`DataFrame.groupBy`; terminal ops produce a
    single-partition DataFrame of one row per group."""

    def __init__(self, df: DataFrame, keys: list[str]):
        self._df = df
        self._keys = keys

    def count(self) -> DataFrame:
        """Group sizes as a ``count`` column (pyspark's ``.count()``)."""
        if "count" in self._keys:
            # withColumnRenamed would REPLACE the key column with the
            # counts, silently losing the group identities
            raise ValueError(
                "a groupBy key is literally named 'count'; use "
                "agg({key: 'count'}) (keeps the 'count(key)' name) or "
                "rename the key column first")
        out = self.agg({self._keys[0]: "count"})
        return out.withColumnRenamed(f"count({self._keys[0]})", "count")

    def agg(self, spec: Mapping[str, str], *,
            max_groups: int | None = None,
            num_workers: int | None = None,
            transport: str | None = None) -> DataFrame:
        """``{"col": "sum"|"mean"|"min"|"max"|"count"}`` → one row per
        distinct key tuple, pyspark-style ``fn(col)`` output names.

        Lazy like every other verb (the module's contract): the source
        scan runs on the output's first iteration, memoized cache()-style
        after that.

        With workers (``num_workers=`` / ``DLS_DATA_WORKERS``): the scan
        routes through the distributed exchange (:mod:`~.exchange`) —
        chunk partials bucket by canonical key hash, per-bucket reducers
        merge with spill-to-disk under ``DLS_SHUFFLE_MEM_MB`` — so there
        is NO cardinality ceiling; a 10M-key aggregation completes under a
        bounded memory budget. Output rows stream bucket-major in
        canonical key order, one partition per bucket.

        ``transport`` (default ``DLS_SHUFFLE_TRANSPORT`` or ``auto``)
        picks the exchange's data-plane format: ``auto``/``columnar``
        ships numeric-key chunks as flat planes (key-hash + key columns +
        value arrays; an order of magnitude faster at 10M keys) with
        byte-identical per-chunk fallback to ``tuple`` for non-conforming
        keys; ``tuple`` forces the per-key pickled path (the measurement
        baseline); ``device`` skips the worker exchange entirely and
        folds the combines on the card (:mod:`~.device_agg`,
        ``scatter_reduce`` under the signature ledger; the active
        ``Session``'s device, else ``cuda``, raising without one) —
        numeric keys required,
        result arrays driver-resident (~32B/key, no ``max_groups``
        ceiling), output bit-equal to the exchange under the float-sum
        exactness proviso both paths share.

        Serial (no workers): chunk partials merge in a DRIVER-SIDE dict —
        fine for the vocab-sized results this plane is documented for
        (Criteo's 26 categorical vocabularies) — bounded by ``max_groups``
        (default ``DLS_AGG_MAX_GROUPS`` or 1_000_000); past the ceiling
        the scan refuses loudly, naming ``DLS_DATA_WORKERS`` (the exchange)
        as the first remediation. Rows come in the SAME canonical bucket-
        major order as the exchange path, so results are byte-identical at
        any worker count.
        """
        keys, df = self._keys, self._df
        from distributeddeeplearningspark_tpu_torch.data import exchange

        if max_groups is None:
            max_groups = exchange.max_groups_limit()
        if max_groups < 1:
            raise ValueError(f"max_groups must be >= 1, got {max_groups}")
        bad = {c: f for c, f in spec.items()
               if f not in _AGG_FNS or c not in df.columns}
        if bad or not spec:
            raise ValueError(
                f"unsupported agg spec {bad or spec!r}; columns="
                f"{df.columns}, fns={_AGG_FNS}")
        names = keys + [f"{f}({c})" for c, f in spec.items()]
        spec = dict(spec)
        n_out = df._chunks.num_partitions
        transport = exchange.resolve_transport(transport, allow_device=True)

        if transport == "device":
            return _device_agg_frame(df, keys, spec, names, n_out)

        nw = exchange.resolve_shuffle_workers(num_workers)
        if nw:
            ex_spec = exchange._Spec(
                pre=lambda ch: _agg_partial(ch, keys, spec),
                combine=_merge_agg_entry)

            def to_chunks(it: Iterable) -> Iterator[Chunk]:
                buf: list[tuple] = []

                def emit(buf: list[tuple]) -> Chunk:
                    ch: Chunk = {
                        k: np.asarray([key[i] for key, _ in buf])
                        for i, k in enumerate(keys)}
                    for ci, (c, f) in enumerate(spec.items()):
                        ch[f"{f}({c})"] = np.asarray(
                            [_agg_row_value(f, cnt, per_col[ci])
                             for _, (cnt, per_col) in buf])
                    return ch

                for rec in it:
                    buf.append(rec)
                    if len(buf) >= DEFAULT_CHUNK_ROWS:
                        yield emit(buf)
                        buf = []
                if buf:
                    yield emit(buf)

            if transport == "tuple":
                recs = exchange._lazy_exchange_dataset(
                    df._chunks._parts, num_workers=nw, n_out=n_out,
                    spec=ex_spec, label="groupBy.agg")
                return DataFrame(recs.map_partitions(to_chunks), names)

            # columnar: share one memoized ShuffleResult so columnar
            # buckets build chunks STRAIGHT from the output planes (no
            # per-row Python on the read side either); tuple-format
            # buckets (mixed-eligibility datasets) fall back to the row
            # reader — same bytes, chunked at the block size instead
            plan, slots = _agg_columnar_plan(keys, spec)
            result = exchange.lazy_exchange(
                df._chunks._parts, num_workers=nw, n_out=n_out,
                spec=ex_spec, label="groupBy.agg", plan=plan)
            from_planes = _agg_chunk_from_planes(keys, spec, slots)

            def make_part(bucket: int):
                def gen() -> Iterator[Chunk]:
                    res = result()
                    pit = res.iter_bucket_planes(bucket)
                    if pit is not None:
                        for pl in pit:
                            if len(pl):
                                yield from_planes(pl)
                    else:
                        yield from to_chunks(res.iter_bucket(bucket))
                return gen

            return DataFrame(
                PartitionedDataset.from_generators(
                    [make_part(b) for b in range(n_out)]), names)

        memo: dict = {}

        def result_chunk() -> Chunk:
            if "chunk" in memo:
                return memo["chunk"]
            acc: dict = {}
            for ch in df._iter_chunks():
                for key, (cnt, per_col) in _agg_partial(ch, keys, spec):
                    if key not in acc:
                        if len(acc) >= max_groups:
                            raise ValueError(
                                f"groupBy({keys}).agg() exceeded max_groups="
                                f"{max_groups} distinct keys — the partials "
                                f"merge in a driver-side dict sized for "
                                f"vocab-scale results, and this key looks "
                                f"high-cardinality (user-id-like). Set "
                                f"DLS_DATA_WORKERS=N (or pass num_workers=) "
                                f"to route through the distributed shuffle "
                                f"exchange, which spills to disk under "
                                f"DLS_SHUFFLE_MEM_MB and has no ceiling; or "
                                f"hash_bucket(col({keys[0]!r}), num_buckets) "
                                f"the key first to bound the result; or "
                                f"raise max_groups= / DLS_AGG_MAX_GROUPS if "
                                f"the grouped result genuinely fits the "
                                f"driver")
                        acc[key] = (cnt, per_col)
                    else:
                        acc[key] = _merge_agg_entry(acc[key],
                                                    (cnt, per_col))
            # canonical bucket-major, key_bytes-ordered rows — the exact
            # layout the exchange path streams, so 0 workers == N workers
            keyed = []
            for k in acc:
                kb = exchange.key_bytes(k)
                keyed.append(((exchange.bucket_of(kb, n_out), kb), k))
            keyed.sort(key=lambda t: t[0])
            rows_keys = [k for _, k in keyed]
            chunk: Chunk = {
                k: np.asarray([rk[i] for rk in rows_keys])
                for i, k in enumerate(keys)
            }
            for ci, (c, f) in enumerate(spec.items()):
                chunk[f"{f}({c})"] = np.asarray(
                    [_agg_row_value(f, acc[rk][0], acc[rk][1][ci])
                     for rk in rows_keys])
            memo["chunk"] = chunk
            return chunk

        return DataFrame(
            PartitionedDataset.from_generators(
                [lambda: iter([result_chunk()])]),
            names)


def _device_agg_frame(df: DataFrame, keys: list[str],
                      spec: Mapping[str, str], names: list[str],
                      n_out: int) -> DataFrame:
    """``groupBy().agg(transport="device")``: serial chunk scan into
    columnar partials, combines folded on the card
    (:func:`~.device_agg.segment_combine` — ``scatter_reduce`` under the
    signature ledger), output in the SAME canonical
    bucket-major key-hash order as the exchange, so the bytes agree.

    Partials compact against ``DLS_SHUFFLE_MEM_MB`` as they accumulate
    (each compaction is itself a device combine), so the scan's resident
    set is bounded; the RESULT is driver-resident flat arrays (~32 bytes
    per key — no ``max_groups`` ceiling, that guard exists for python
    dict blowup, not for arrays). Emits the standard ``shuffle`` done
    event with ``transport="device"`` plus the map/merge phase pair, so
    ``status`` renders it like any exchange. The device is resolved when
    the scan runs (:func:`~.device_agg.available`): there is no host
    fallback."""
    import time as _time

    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.data import device_agg, exchange

    plan, slots = _agg_columnar_plan(keys, spec)
    from_planes = _agg_chunk_from_planes(keys, spec, slots)
    memo: dict = {}

    def buckets() -> dict:
        if "b" in memo:
            return memo["b"]
        device = device_agg.available()
        budget = exchange.mem_budget_bytes()
        t0 = _time.perf_counter()
        telemetry.emit("phase", name="shuffle-map", edge="begin",
                       op="groupBy.agg")
        batches: list = []
        held = elems = pairs = moved = 0
        # compaction threshold doubles when a combine fails to shrink
        # below it (distinct keys legitimately outgrowing the budget) —
        # otherwise EVERY later chunk would re-sort the whole accumulated
        # set and the scan would go quadratic in chunk count
        compact_at = budget
        aborted = True
        try:
            for ch in df._iter_chunks():
                elems += 1
                pl = plan.pre_planes(ch)
                if pl is None:
                    raise ValueError(
                        f"transport='device' needs numeric (int/float/"
                        f"bool, non-NaN, no ±0.0 floats) groupBy keys; "
                        f"{keys} do not conform — fillna()/hash_bucket "
                        f"them first, or use transport='columnar', whose "
                        f"per-chunk tuple fallback handles them")
                pairs += len(pl)
                moved += pl.nbytes
                batches.append(pl)
                held += pl.nbytes
                if held >= compact_at and len(batches) > 1:
                    batches = [device_agg.segment_combine(
                        exchange._Planes.concat(batches), plan,
                        device=device)]
                    held = batches[0].nbytes
                    while held >= compact_at:
                        compact_at *= 2
            aborted = False
        finally:
            map_s = _time.perf_counter() - t0
            telemetry.emit("phase", name="shuffle-map", edge="end",
                           dur_s=map_s, op="groupBy.agg",
                           **({"aborted": True} if aborted else {}))
        t1 = _time.perf_counter()
        telemetry.emit("phase", name="shuffle-merge", edge="begin",
                       op="groupBy.agg")
        aborted = True
        try:
            out: dict[int, Any] = {}
            if batches:
                combined = device_agg.segment_combine(
                    exchange._Planes.concat(batches), plan, device=device)
                out = {b: sub for b, sub
                       in exchange._bucket_split(combined, n_out)}
            aborted = False
        finally:
            merge_s = _time.perf_counter() - t1
            telemetry.emit("phase", name="shuffle-merge", edge="end",
                           dur_s=merge_s, op="groupBy.agg",
                           **({"aborted": True} if aborted else {}))
        rows_list = [len(out.get(b, ())) for b in range(n_out)]
        telemetry.emit(
            "shuffle", edge="done", op="groupBy.agg", workers=0,
            reducers=0, buckets=n_out, elems_in=elems, pairs_in=pairs,
            rows_out=sum(rows_list), bytes_moved=moved, overflow=0,
            spills=0, spill_bytes=0, map_s=round(map_s, 3),
            merge_s=round(merge_s, 3), bucket_rows=rows_list,
            mem_budget_mb=round(budget / (1 << 20), 1),
            transport="device", columnar_pairs=pairs,
            columnar_bytes=moved, tuple_pairs=0, tuple_bytes=0,
            columnar_buckets=sum(1 for r in rows_list if r),
            tuple_buckets=0)
        memo["b"] = out
        return out

    def make_part(bucket: int):
        def gen() -> Iterator[Chunk]:
            pl = buckets().get(bucket)
            if pl is not None and len(pl):
                for lo in range(0, len(pl), DEFAULT_CHUNK_ROWS):
                    yield from_planes(
                        pl.cut(lo, min(lo + DEFAULT_CHUNK_ROWS, len(pl))))
        return gen

    return DataFrame(
        PartitionedDataset.from_generators(
            [make_part(b) for b in range(n_out)]), names)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def from_rows(rows: Sequence[Mapping[str, Any]], *, num_partitions: int = 2,
              chunk_rows: int = DEFAULT_CHUNK_ROWS) -> DataFrame:
    """``createDataFrame``: columnarize a row sequence (driver-side)."""
    if not rows:
        raise ValueError("cannot infer schema from zero rows")
    names = list(rows[0].keys())
    ds = PartitionedDataset.parallelize(list(rows), num_partitions)
    return from_dataset(ds, names, chunk_rows=chunk_rows)


def from_dataset(ds: PartitionedDataset, columns: Sequence[str], *,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> DataFrame:
    """Columnarize a PartitionedDataset of row dicts (the RDD→DF bridge)."""
    names = list(columns)

    def chunker(it: Iterable[Mapping]) -> Iterator[Chunk]:
        buf: list[Mapping] = []
        for r in it:
            buf.append(r)
            if len(buf) == chunk_rows:
                yield {n: np.asarray([b[n] for b in buf]) for n in names}
                buf = []
        if buf:
            yield {n: np.asarray([b[n] for b in buf]) for n in names}

    return DataFrame(ds.map_partitions(chunker), names)


def _expand_paths(paths: str | Sequence[str]) -> list[str]:
    """Glob-or-literal path expansion shared by the readers.

    A string containing glob metacharacters expands (sorted); a literal
    string that exists is used as-is even if it contains ``[``/``?``
    (e.g. ``data[1].parquet``); lists pass through with existence checks.
    """
    import glob as _glob
    import os

    if isinstance(paths, str):
        if os.path.exists(paths):
            expanded = [paths]
        elif any(ch in paths for ch in "*?["):
            expanded = sorted(_glob.glob(paths))
        else:
            expanded = [paths]
    else:
        expanded = list(paths)
    if not expanded:
        raise FileNotFoundError(f"no files match {paths!r}")
    for p in expanded:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    return expanded


def read_csv(
    paths: str | Sequence[str],
    *,
    names: Sequence[str],
    sep: str = ",",
    dtypes: Mapping[str, Any] | None = None,
    num_partitions: int = 2,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
) -> DataFrame:
    """Typed delimited-text reader (``spark.read.csv``-shaped).

    Files (or one file split by contiguous line ranges) spread over
    ``num_partitions``. Missing fields parse as NaN (float columns) / ''
    (string columns). ``dtypes`` maps column → numpy dtype; default f4.
    """
    expanded = _expand_paths(paths)
    names = list(names)
    dtypes = dict(dtypes or {})
    np_dtypes = {n: np.dtype(dtypes.get(n, np.float32)) for n in names}

    def parse_lines(lines: Iterable[str]) -> Iterator[Chunk]:
        buf: list[list[str]] = []

        def flush(buf: list[list[str]]) -> Chunk:
            cols: Chunk = {}
            for j, n in enumerate(names):
                raw = [row[j] if j < len(row) else "" for row in buf]
                dt = np_dtypes[n]
                if dt.kind == "f":
                    cols[n] = np.array(
                        [float(x) if x else np.nan for x in raw], dt)
                elif dt.kind in ("i", "u"):
                    cols[n] = np.array(
                        [int(x) if x else 0 for x in raw], dt)
                else:
                    cols[n] = np.array(raw, dtype=np.str_)
            return cols

        for line in lines:
            line = line.rstrip("\n")
            if not line:
                continue
            buf.append(line.split(sep))
            if len(buf) == chunk_rows:
                yield flush(buf)
                buf = []
        if buf:
            yield flush(buf)

    # several files but fewer than requested partitions: clamp to one
    # partition per file (repartition(n) can split streams afterwards)
    if 1 < len(expanded) < num_partitions:
        num_partitions = len(expanded)
    if len(expanded) >= num_partitions:
        file_groups = np.array_split(np.array(expanded, object), num_partitions)

        def make_part(group) -> Callable[[], Iterator[Chunk]]:
            def gen() -> Iterator[Chunk]:
                def lines() -> Iterator[str]:
                    for fname in group:
                        with open(fname, "r") as f:
                            yield from f
                return parse_lines(lines())
            return gen

        parts = [make_part(g) for g in file_groups if len(g)]
    else:
        # split each file by contiguous line ranges (counted once, driver-side)
        fname = expanded[0]
        with open(fname, "r") as f:
            total = sum(1 for _ in f)
        bounds = [(i * total // num_partitions, (i + 1) * total // num_partitions)
                  for i in range(num_partitions)]

        def make_range(lo: int, hi: int) -> Callable[[], Iterator[Chunk]]:
            def gen() -> Iterator[Chunk]:
                def lines() -> Iterator[str]:
                    with open(fname, "r") as f:
                        for i, line in enumerate(f):
                            if i >= hi:
                                break
                            if i >= lo:
                                yield line
                return parse_lines(lines())
            return gen

        parts = [make_range(lo, hi) for lo, hi in bounds]

    return DataFrame(PartitionedDataset.from_generators(parts), names)


def read_parquet(
    paths: str | Sequence[str],
    *,
    columns: Sequence[str] | None = None,
    num_partitions: int = 2,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
) -> DataFrame:
    """Parquet reader (``spark.read.parquet``-shaped), via pyarrow.

    Files spread over partitions (one partition reads a contiguous file
    group; a single file splits by row-group ranges). Column chunks stream
    batch-at-a-time — a partition never materializes its whole file set.
    """
    import os

    import pyarrow.parquet as pq

    # Spark's canonical input is a directory of part files (escape the
    # directory name so its own glob metacharacters stay literal)
    if isinstance(paths, str) and os.path.isdir(paths):
        import glob as _glob

        paths = os.path.join(_glob.escape(paths), "*.parquet")
    expanded = _expand_paths(paths)
    if columns is not None:
        names = list(columns)
    else:
        names = list(pq.read_schema(expanded[0]).names)

    def batches_to_chunks(batches) -> Iterator[Chunk]:
        for rb in batches:
            yield {n: rb.column(n).to_numpy(zero_copy_only=False)
                   for n in names}

    if 1 < len(expanded) < num_partitions:
        num_partitions = len(expanded)
    if len(expanded) >= num_partitions:
        groups = np.array_split(np.array(expanded, object), num_partitions)

        def make_files(group) -> Callable[[], Iterator[Chunk]]:
            def gen() -> Iterator[Chunk]:
                for fname in group:
                    f = pq.ParquetFile(fname)
                    yield from batches_to_chunks(
                        f.iter_batches(batch_size=chunk_rows, columns=names))
            return gen

        parts = [make_files(g) for g in groups if len(g)]
    else:
        f0 = pq.ParquetFile(expanded[0])
        n_rg = f0.num_row_groups
        rg_bounds = [(i * n_rg // num_partitions, (i + 1) * n_rg // num_partitions)
                     for i in range(num_partitions)]

        def make_rgs(lo: int, hi: int) -> Callable[[], Iterator[Chunk]]:
            def gen() -> Iterator[Chunk]:
                if lo >= hi:
                    return
                f = pq.ParquetFile(expanded[0])
                yield from batches_to_chunks(
                    f.iter_batches(batch_size=chunk_rows, columns=names,
                                   row_groups=list(range(lo, hi))))
            return gen

        parts = [make_rgs(lo, hi) for lo, hi in rg_bounds]

    return DataFrame(PartitionedDataset.from_generators(parts), names)


class DataFrameReader:
    """``session.read`` surface: ``.option(...).schema(...).csv(path)`` /
    ``.parquet(path)``."""

    def __init__(self, *, default_parallelism: int = 2):
        self._opts: dict[str, Any] = {"sep": ","}
        self._names: Sequence[str] | None = None
        self._dtypes: Mapping[str, Any] | None = None
        self._parallelism = default_parallelism

    def option(self, key: str, value) -> "DataFrameReader":
        self._opts[key] = value
        return self

    def schema(self, names: Sequence[str],
               dtypes: Mapping[str, Any] | None = None) -> "DataFrameReader":
        self._names = names
        self._dtypes = dtypes
        return self

    def csv(self, path: str | Sequence[str]) -> DataFrame:
        if self._names is None:
            raise ValueError("call .schema([...column names...]) before .csv()")
        return read_csv(
            path, names=self._names, sep=str(self._opts.get("sep", ",")),
            dtypes=self._dtypes,
            num_partitions=int(self._opts.get(
                "num_partitions", self._parallelism)))

    def parquet(self, path: str | Sequence[str]) -> DataFrame:
        # schema travels in the file; .schema() narrows columns, and its
        # dtypes (meaningful for text parsing in .csv) apply here as casts
        # so the same .schema(...) pipeline behaves identically on parquet
        df = read_parquet(
            path, columns=self._names,
            num_partitions=int(self._opts.get(
                "num_partitions", self._parallelism)))
        if self._dtypes:
            df = df.withColumns(
                {n: col(n).cast(dt) for n, dt in self._dtypes.items()})
        return df
