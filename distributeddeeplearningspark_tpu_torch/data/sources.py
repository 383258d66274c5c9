"""Dataset sources — the port's copy of what the ResNet and DLRM paths
read.

The counterparts of ``distributeddeeplearningspark_tpu/data/sources.py``'s
:func:`synthetic_images`, :func:`synthetic_criteo` and :func:`criteo_tsv`,
numpy for numpy, so both packages yield byte-identical examples from the
same seed or file. The MNIST, ImageNet-folder and record sources arrive
with the slices that read them.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset


def synthetic_images(
    num_examples: int,
    *,
    image_size: int = 224,
    num_classes: int = 1000,
    num_partitions: int = 8,
    seed: int = 0,
) -> PartitionedDataset:
    """ImageNet-shaped synthetic images: ``{"image": [S, S, 3] f32 normal
    noise with a weak label signal in the top-left 4×4 corner, "label":
    int32}``, ``num_examples // num_partitions`` per partition, partition
    ``i`` drawn from ``default_rng(seed * 1000 + i)``."""

    def make_partition(pidx: int):
        def gen() -> Iterator[dict]:
            rng = np.random.default_rng(seed * 1000 + pidx)
            n = num_examples // num_partitions
            for _ in range(n):
                label = int(rng.integers(0, num_classes))
                img = rng.normal(0, 1, (image_size, image_size, 3)).astype(np.float32)
                img[:4, :4, :] += (label % 64) / 8.0  # weak label signal
                yield {"image": img, "label": np.int32(label)}

        return gen

    return PartitionedDataset([make_partition(i) for i in range(num_partitions)])


def synthetic_criteo(
    num_examples: int = 4096,
    *,
    num_dense: int = 13,
    vocab_sizes: tuple[int, ...] = (100,) * 26,
    num_partitions: int = 4,
    seed: int = 0,
) -> PartitionedDataset:
    """Criteo-shaped synthetic CTR data: ``{"dense": [num_dense] f32,
    "sparse": [len(vocab_sizes)] int32 local ids, "label": int32}``. The
    click probability depends on a fixed random weighting of the
    categorical ids and two dense features, so CTR models learn (AUC rises
    above chance). Partition ``i`` draws from ``default_rng(seed * 1000 +
    i)``, the weighting from ``default_rng(20260729)``."""

    def make_partition(pidx: int):
        def gen() -> Iterator[dict]:
            rng = np.random.default_rng(seed * 1000 + pidx)
            wrng = np.random.default_rng(20260729)  # shared "ground truth"
            cat_w = [wrng.normal(0, 1.5, v) for v in vocab_sizes]
            dense_w = wrng.normal(0, 1.0, num_dense) * (np.arange(num_dense) < 2)
            n = num_examples // num_partitions
            highs = np.asarray(vocab_sizes)
            for _ in range(n):
                sparse = rng.integers(0, highs, dtype=np.int32)
                dense = rng.exponential(2.0, num_dense).astype(np.float32)
                score = sum(w[s] for w, s in zip(cat_w, sparse)) / len(vocab_sizes)
                score += float(np.log1p(dense) @ dense_w) / num_dense
                label = np.int32(rng.random() < 1 / (1 + np.exp(-3 * score)))
                yield {"dense": dense, "sparse": sparse, "label": label}

        return gen

    return PartitionedDataset([make_partition(i) for i in range(num_partitions)])


#: Criteo display-advertising schema: 13 dense + 26 categorical features
CRITEO_DENSE = 13
CRITEO_SPARSE = 26

#: hashed categorical buckets per feature: a fixed hash-bucket size bounds
#: the table and needs no vocabulary pass over the file
CRITEO_DEFAULT_BUCKETS = (1 << 18,) * 26


def criteo_tsv(
    path: str,
    *,
    num_partitions: int = 8,
    vocab_sizes: tuple[int, ...] = CRITEO_DEFAULT_BUCKETS,
    has_label: bool = True,
) -> PartitionedDataset:
    """Criteo TSV (``label \\t 13 ints \\t 26 hex cats``) → example dicts.

    - missing dense values ('' or absent) → 0.0;
    - categorical hex ids hash into per-feature buckets,
      ``int(feat, 16) % vocab_sizes[i]`` (missing → bucket 0);
    - ``path`` is a file or a directory of shards; partitions byte-split
      files over 1 MiB, each owning the lines that start in its range
      (Spark's TextInputFormat contract).
    """
    if len(vocab_sizes) != CRITEO_SPARSE:
        raise ValueError(f"need {CRITEO_SPARSE} vocab sizes, got {len(vocab_sizes)}")
    if os.path.isdir(path):
        shards = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if not f.startswith(".") and os.path.isfile(os.path.join(path, f))
        )
    else:
        shards = [path]
    if not shards:
        raise FileNotFoundError(f"no Criteo shards under {path}")

    # byte-range splits: partition i of file f starts at the first full line
    # after offset i·size/P
    splits: list[tuple[str, int, int]] = []
    per_file = max(1, num_partitions // len(shards))
    for f in shards:
        size = os.path.getsize(f)
        k = per_file if size > (1 << 20) else 1
        for j in range(k):
            splits.append((f, size * j // k, size * (j + 1) // k))

    highs = np.asarray(vocab_sizes, np.int64)

    def parse_line(line: str):
        cols = line.rstrip("\n").split("\t")
        off = 1 if has_label else 0
        want = off + CRITEO_DENSE + CRITEO_SPARSE
        if len(cols) < want:
            cols = cols + [""] * (want - len(cols))
        label = np.int32(int(cols[0])) if has_label else np.int32(0)
        dense = np.array(
            [float(c) if c else 0.0 for c in cols[off:off + CRITEO_DENSE]],
            np.float32,
        )
        sparse = np.array(
            [
                (int(c, 16) % int(highs[i])) if c else 0
                for i, c in enumerate(
                    cols[off + CRITEO_DENSE:off + CRITEO_DENSE + CRITEO_SPARSE])
            ],
            np.int32,
        )
        return {"dense": dense, "sparse": sparse, "label": label}

    def make_partition(split: tuple[str, int, int]):
        fname, lo, hi = split

        def gen() -> Iterator[dict]:
            # a split owns every line that starts at an offset in (lo, hi]; a
            # reader seeked into the middle of a line discards it
            with open(fname, "rb") as f:
                if lo:
                    f.seek(lo)
                    f.readline()
                while True:
                    if f.tell() > hi:
                        break
                    raw = f.readline()
                    if not raw:
                        break
                    line = raw.decode("utf-8", errors="replace")
                    if line.strip():
                        yield parse_line(line)

        return gen

    return PartitionedDataset([make_partition(s) for s in splits])
