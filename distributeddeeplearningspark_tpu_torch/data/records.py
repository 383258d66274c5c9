"""Preprocessed array records — the materialized input path, the port of
``distributeddeeplearningspark_tpu/data/records.py``.

Fixed preprocessing (decoded, shorter-side-resized uint8 images) is written
once into sharded binary record files and streamed back at memory rates
instead of paying JPEG decode every epoch; the random augmentation (crop,
flip, normalize) stays online at read time, so records bake in no one
epoch's randomness. The bytes on disk are the JAX package's: records written
by either package read in the other.

Format (one ``part-NNNNN.dlsrec`` file per shard):

- 8-byte magic ``DLSREC01``;
- records back to back, each ``uint32 nbytes`` then the body: ``uint16
  nkeys``, then per key (sorted) ``uint16 klen``, the key in utf-8, ``uint8
  dlen``, the numpy dtype string, ``uint8 ndim``, ``uint64[ndim]`` shape,
  ``uint64 nbytes`` and the array's C-order bytes (no pickle anywhere:
  reading a record never runs code);
- a footer: ``uint64[count]`` record offsets, ``uint64 count``, ``uint64
  footer_offset``, 8-byte magic ``DLSIDX01``.

The offset index makes a shard splittable without a scan: ``array_records``
fans one shard out to many partitions, so the partition count can match the
ranks and workers whatever the number of files the writer produced.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, Sequence

import numpy as np

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset

_MAGIC = b"DLSREC01"
_IDX_MAGIC = b"DLSIDX01"


def _pack_record(example: dict) -> bytes:
    """Dict[str, np.ndarray | scalar] → bytes. Keys are sorted so byte
    output is deterministic for identical content."""
    parts: list[bytes] = [struct.pack("<H", len(example))]
    for key in sorted(example):
        # NOT ascontiguousarray: it promotes 0-d scalars to shape (1,)
        # (ndmin=1 quirk), which would make labels round-trip as [1] arrays
        # and batch to [B, 1] instead of [B]. tobytes() below already
        # serializes any layout as C-order bytes, so no contiguity copy is
        # needed either.
        arr = np.asarray(example[key])
        kb = key.encode("utf-8")
        ds = arr.dtype.str.encode("ascii")  # e.g. b'|u1', b'<f4', b'<i4'
        parts.append(struct.pack("<H", len(kb)))
        parts.append(kb)
        parts.append(struct.pack("<B", len(ds)))
        parts.append(ds)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack("<" + "Q" * arr.ndim, *arr.shape))
        parts.append(struct.pack("<Q", arr.nbytes))
        parts.append(arr.tobytes())
    return b"".join(parts)


def _unpack_record(buf: bytes) -> dict:
    (nkeys,) = struct.unpack_from("<H", buf, 0)
    out: dict = {}
    pos = 2
    for _ in range(nkeys):
        (klen,) = struct.unpack_from("<H", buf, pos); pos += 2
        key = buf[pos:pos + klen].decode("utf-8"); pos += klen
        (dlen,) = struct.unpack_from("<B", buf, pos); pos += 1
        dtype = np.dtype(buf[pos:pos + dlen].decode("ascii")); pos += dlen
        (ndim,) = struct.unpack_from("<B", buf, pos); pos += 1
        shape = struct.unpack_from("<" + "Q" * ndim, buf, pos); pos += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, pos); pos += 8
        arr = np.frombuffer(buf, dtype, count=nbytes // dtype.itemsize,
                            offset=pos).reshape(shape)
        pos += nbytes
        # 0-d arrays come back as numpy scalars, matching the writers' input
        out[key] = arr[()] if ndim == 0 else arr
    return out


class RecordShardWriter:
    """Streams records into one ``part-NNNNN.dlsrec`` file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._offsets: list[int] = []

    def write(self, example: dict) -> None:
        body = _pack_record(example)
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<I", len(body)))
        self._f.write(body)

    def close(self) -> None:
        footer_off = self._f.tell()
        if self._offsets:
            self._f.write(np.asarray(self._offsets, "<u8").tobytes())
        self._f.write(struct.pack("<QQ", len(self._offsets), footer_off))
        self._f.write(_IDX_MAGIC)
        self._f.close()

    def abort(self) -> None:
        """Close WITHOUT a footer and delete the file — a shard that failed
        mid-write must not be left looking complete (the footer is the
        integrity check; writing it for a partial body would make truncation
        undetectable)."""
        self._f.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            self.abort()
        else:
            self.close()


def _read_index(path: str) -> np.ndarray:
    """Record offsets of one shard (from the footer, no scan)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < len(_MAGIC) + 24 or (f.read(8) != _MAGIC):
            raise ValueError(f"{path}: not a DLSREC01 file")
        f.seek(size - 24)
        count, footer_off = struct.unpack("<QQ", f.read(16))
        if f.read(8) != _IDX_MAGIC:
            raise ValueError(f"{path}: missing footer index (truncated write?)")
        f.seek(footer_off)
        return np.frombuffer(f.read(8 * count), "<u8")


def _iter_shard(path: str, lo: int, hi: int) -> Iterator[dict]:
    """Yield records [lo, hi) of one shard by footer-indexed seek."""
    offsets = _read_index(path)
    with open(path, "rb") as f:
        for off in offsets[lo:hi]:
            f.seek(int(off))
            (nbytes,) = struct.unpack("<I", f.read(4))
            yield _unpack_record(f.read(nbytes))


def shard_paths(path: str) -> list[str]:
    """All ``*.dlsrec`` shards of a record dir (or the single file)."""
    if os.path.isfile(path):
        return [path]
    shards = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(".dlsrec")
    )
    if not shards:
        raise FileNotFoundError(f"no .dlsrec shards under {path}")
    return shards


def array_records(path: str, *, num_partitions: int | None = None) -> PartitionedDataset:
    """Read a record dir/file back as a :class:`PartitionedDataset`.

    ``num_partitions=None`` → one partition per shard file. A larger count
    splits shards by record-index ranges via the footer index (so partition
    granularity can match the mesh data axis without rewriting files); a
    smaller count groups whole shards round-robin.
    """
    shards = shard_paths(path)
    counts = [len(_read_index(s)) for s in shards]

    splits: list[list[tuple[str, int, int]]]
    if num_partitions is None or num_partitions == len(shards):
        splits = [[(s, 0, c)] for s, c in zip(shards, counts)]
    elif num_partitions < len(shards):
        splits = [[] for _ in range(num_partitions)]
        for i, (s, c) in enumerate(zip(shards, counts)):
            splits[i % num_partitions].append((s, 0, c))
    else:
        # split each shard into ~equal record ranges; distribute the
        # partition budget proportionally to shard record counts
        total = sum(counts)
        budget = [max(1, round(num_partitions * c / max(1, total))) for c in counts]
        # fix rounding so the total matches exactly
        while sum(budget) > num_partitions:
            budget[int(np.argmax(budget))] -= 1
        while sum(budget) < num_partitions:
            budget[int(np.argmin(budget))] += 1
        splits = []
        for s, c, k in zip(shards, counts, budget):
            bounds = [c * j // k for j in range(k + 1)]
            splits.extend([[(s, bounds[j], bounds[j + 1])] for j in range(k)])

    def make_partition(ranges: Sequence[tuple[str, int, int]]):
        def gen() -> Iterator[dict]:
            for path_, lo, hi in ranges:
                yield from _iter_shard(path_, lo, hi)

        return gen

    return PartitionedDataset([make_partition(r) for r in splits])


def write_array_records(
    dataset: PartitionedDataset | Iterable[dict],
    out_dir: str,
    *,
    num_shards: int | None = None,
) -> list[str]:
    """Materialize a dataset into ``out_dir/part-NNNNN.dlsrec`` shards.

    One shard per source partition by default (preserves the partition
    structure, and each partition streams lazily — never holds a shard in
    memory). Returns the shard paths.
    """
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(dataset, PartitionedDataset):
        parts: list[Iterable[dict]] = [
            dataset.iter_partition(i) for i in range(dataset.num_partitions)
        ]
    else:
        parts = [iter(dataset)]
    if num_shards is not None and num_shards != len(parts):
        # round-robin into N writers WHILE streaming — buffering the whole
        # dataset to reshard would hold ~the full decoded corpus in memory
        writers = [
            RecordShardWriter(os.path.join(out_dir, f"part-{i:05d}.dlsrec"))
            for i in range(num_shards)
        ]
        try:
            i = 0
            for part in parts:
                for ex in part:
                    writers[i % num_shards].write(ex)
                    i += 1
        except BaseException:
            for w in writers:
                w.abort()
            raise
        for w in writers:
            w.close()
        return [w.path for w in writers]
    paths = []
    try:
        for i, part in enumerate(parts):
            p = os.path.join(out_dir, f"part-{i:05d}.dlsrec")
            with RecordShardWriter(p) as w:
                for ex in part:
                    w.write(ex)
            paths.append(p)
    except BaseException:
        # abort every shard: completed earlier shards would otherwise look
        # valid, and a retry into the same out_dir could mix shards from
        # two runs (as the resharding branch aborts)
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        raise
    return paths


def write_imagenet_records(
    root: str,
    out_dir: str,
    *,
    size: int = 256,
    num_shards: int = 8,
    num_threads: int | None = None,
    class_to_index: dict[str, int] | None = None,
) -> list[str]:
    """One-time ImageNet materialization: JPEG → shorter-side-``size`` uint8.

    The expensive fixed work (decode + big-image resize) happens exactly once
    here — parallel across ``num_threads`` (decode/resize release the GIL in
    the native kernels); training then reads records and pays only the cheap
    randomized tail (crop to 224 + flip + normalize) per epoch. ``size=256``
    keeps the standard 256→224 crop margin.
    """
    from distributeddeeplearningspark_tpu_torch.data.sources import imagenet_folder
    from distributeddeeplearningspark_tpu_torch.data.vision import (
        _decode_if_bytes, _resize)

    def preprocess(example: dict) -> dict:
        example = _decode_if_bytes(example)
        img = example["image"]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        h, w = img.shape[:2]
        scale = size / min(h, w)
        if scale < 1.0:  # never upscale at materialization time
            img = _resize(img.astype(np.float32),
                          (int(round(h * scale)), int(round(w * scale))))
        img = np.clip(img, 0, 255).astype(np.uint8)
        return {"image": np.ascontiguousarray(img), "label": example["label"]}

    ds = imagenet_folder(root, num_partitions=num_shards, decode=False,
                         class_to_index=class_to_index)
    return write_array_records(
        ds.map_parallel(preprocess, num_threads=num_threads), out_dir,
        num_shards=num_shards)
