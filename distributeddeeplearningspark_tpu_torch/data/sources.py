"""Dataset sources — the port's copy of what the LeNet, ResNet and DLRM
paths read.

The counterparts of ``distributeddeeplearningspark_tpu/data/sources.py``'s
:func:`synthetic_mnist`, :func:`load_mnist_idx`, :func:`synthetic_images`,
:func:`synthetic_criteo`, :func:`folder_classes`, :func:`imagenet_folder`
and :func:`criteo_tsv`, numpy for numpy, so both packages yield
byte-identical examples from the same seed or file. The record source is
:mod:`.records`.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator

import numpy as np

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset


def synthetic_mnist(
    num_examples: int = 2048, *, num_partitions: int = 2, seed: int = 0
) -> PartitionedDataset:
    """Label-correlated fake MNIST: ``{"image": [28, 28, 1] f32, "label":
    int32}``, class k lighting up a fixed 7×7-block pattern plus noise, so
    LeNet reaches >90% accuracy within ~100 steps. Partition ``i`` draws
    ``num_examples // num_partitions`` examples from ``default_rng(seed *
    1000 + i)``; the class patterns come from ``default_rng(20260729)``, so
    distinct seeds are disjoint draws from one distribution."""

    def make_partition(pidx: int):
        def gen() -> Iterator[dict]:
            rng = np.random.default_rng(seed * 1000 + pidx)
            n = num_examples // num_partitions
            protos = np.zeros((10, 28, 28, 1), np.float32)
            prng = np.random.default_rng(20260729)
            for k in range(10):
                mask = prng.random((4, 4)) > 0.5
                protos[k, :, :, 0] = np.kron(mask, np.ones((7, 7))).astype(np.float32)
            for _ in range(n):
                label = int(rng.integers(0, 10))
                img = protos[label] + rng.normal(0, 0.3, (28, 28, 1)).astype(np.float32)
                yield {"image": img.astype(np.float32), "label": np.int32(label)}

        return gen

    return PartitionedDataset([make_partition(i) for i in range(num_partitions)])


def load_mnist_idx(data_dir: str, split: str = "train", *,
                   num_partitions: int = 2) -> PartitionedDataset:
    """Real MNIST from IDX files (``train-images-idx3-ubyte`` and its
    labels, or ``t10k-...`` for any other split; ``.gz`` beside them is read
    too), normalised to [0, 1], NHWC."""
    prefix = "train" if split == "train" else "t10k"
    imgs = _read_idx(os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"))
    labels = _read_idx(os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"))
    imgs = (imgs.astype(np.float32) / 255.0)[..., None]
    labels = labels.astype(np.int32)
    examples = [{"image": imgs[i], "label": labels[i]} for i in range(len(labels))]
    return PartitionedDataset.parallelize(examples, num_partitions)


def _read_idx(path: str) -> np.ndarray:
    opener = open
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path, opener = path + ".gz", gzip.open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
                 13: np.float32}[dtype_code]
        return np.frombuffer(f.read(), dtype=dtype).reshape(dims)


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


def folder_classes(root: str) -> dict[str, int]:
    """Class → index of a class-per-subdirectory tree, in sorted-name order
    (torchvision's convention). Pin one mapping across splits with it: a
    train and an eval directory that each derive their own misalign the
    labels whenever their sets of directories differ."""
    root = os.path.abspath(root)
    names = sorted(d for d in os.listdir(root)
                   if os.path.isdir(os.path.join(root, d)) and not d.startswith("."))
    if not names:
        raise FileNotFoundError(f"no class directories under {root}")
    return {n: i for i, n in enumerate(names)}


def imagenet_folder(root: str, *, num_partitions: int = 8,
                    class_to_index: dict[str, int] | None = None,
                    decode: bool = True) -> PartitionedDataset:
    """ImageNet's class-per-subdirectory layout (``root/n01440764/x.JPEG``)
    → ``{"image": [H, W, 3] uint8, "label": int32}``, files dealt to the
    partitions round robin in sorted order. Labels follow the sorted class
    directories unless ``class_to_index`` pins them. Decoding
    (``vision.decode_jpeg``; grayscale is repeated to RGB) happens lazily in
    the partition's iterator; ``decode=False`` yields the file's bytes under
    ``"jpeg"`` instead, for a pipeline that decodes inside a later map
    (``vision.imagenet_train`` spreads it over its pool)."""
    root = os.path.abspath(root)
    classes = class_to_index if class_to_index is not None else folder_classes(root)
    files: list[tuple[str, int]] = []
    exts = (".jpeg", ".jpg", ".JPEG", ".JPG")
    for name, idx in sorted(classes.items()):
        cdir = os.path.join(root, name)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if fn.endswith(exts):
                files.append((os.path.join(cdir, fn), idx))
    if not files:
        raise FileNotFoundError(f"no JPEG files under {root}")

    def make_partition(pidx: int):
        shard = files[pidx::num_partitions]

        def gen() -> Iterator[dict]:
            from distributeddeeplearningspark_tpu_torch.data.vision import decode_jpeg

            for path, label in shard:
                if decode:
                    img = decode_jpeg(path)
                    if img.shape[-1] == 1:
                        img = np.repeat(img, 3, axis=-1)
                    yield {"image": img, "label": np.int32(label)}
                else:
                    with open(path, "rb") as f:
                        yield {"jpeg": f.read(), "label": np.int32(label)}

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
