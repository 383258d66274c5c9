"""Image pipeline — the port's copy of the float-image paths of
``distributeddeeplearningspark_tpu/data/vision.py``.

Per-example numpy transforms over a :class:`~..rdd.PartitionedDataset`, run
on the host: :func:`imagenet_train` (shuffle → repeat → crop/flip) and
:func:`imagenet_eval` (center crop), each mapped in a thread pool or, with
``num_workers``, over worker processes (:mod:`.workers`). Augmentation is
seeded by the example's content and the pipeline's seed, so the same
examples get the same crops and flips in both packages and at any thread
or worker count.

Only float images (already normalised, as :func:`~.sources.
synthetic_images` yields) are taken: uint8 images, JPEG bytes, the native
(C++) decode and resize and ``imagenet_train_batched`` are not ported yet.
Resizing is the numpy :func:`resize_bilinear`, whose arithmetic the JAX
package's native resize mirrors.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np

from distributeddeeplearningspark_tpu_torch.data import workers as workers_lib
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset

#: ImageNet channel statistics
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(image: np.ndarray, mean: np.ndarray = IMAGENET_MEAN,
              std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """[0,1] float or uint8 HWC → standardized float32."""
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    return (image.astype(np.float32) - mean) / std


def resize_bilinear(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize (half-pixel centres, edge-clamped), numpy."""
    h, w = image.shape[:2]
    out_h, out_w = size
    if (h, w) == (out_h, out_w):
        return image
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    img = image.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def sample_crop_region(h: int, w: int, rng: np.random.Generator,
                       scale: tuple[float, float] = (0.08, 1.0),
                       ratio: tuple[float, float] = (3 / 4, 4 / 3),
                       ) -> tuple[int, int, int, int] | None:
    """Inception-style crop sampling: (y, x, ch, cw), or None when 10 draws
    of random area/aspect never fit — callers fall back to a center crop."""
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * aspect)))
        ch = int(round(np.sqrt(target / aspect)))
        if cw <= w and ch <= h:
            y = int(rng.integers(0, h - ch + 1))
            x = int(rng.integers(0, w - cw + 1))
            return y, x, ch, cw
    return None


def random_resized_crop(image: np.ndarray, rng: np.random.Generator, size: int = 224,
                        scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3)) -> np.ndarray:
    """Inception-style crop: random area/aspect, resized to ``size``."""
    h, w = image.shape[:2]
    region = sample_crop_region(h, w, rng, scale, ratio)
    if region is None:
        return center_crop(image, size)
    y, x, ch, cw = region
    return resize_bilinear(image[y:y + ch, x:x + cw], (size, size))


def center_crop(image: np.ndarray, size: int = 224, resize_shorter: int = 256) -> np.ndarray:
    """Eval transform: resize the shorter side, then center crop."""
    h, w = image.shape[:2]
    scale = resize_shorter / min(h, w)
    image = resize_bilinear(image, (int(round(h * scale)), int(round(w * scale))))
    h, w = image.shape[:2]
    y, x = (h - size) // 2, (w - size) // 2
    return image[y:y + size, x:x + size]


def random_flip(image: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return image[:, ::-1] if rng.random() < 0.5 else image


def _content_seed(img: np.ndarray) -> int:
    """Process-stable 32-bit hash of the image's first 64 bytes (built-in
    ``hash()`` is salted per process)."""
    return int.from_bytes(
        hashlib.blake2b(img.tobytes()[:64], digest_size=4).digest(), "little")


def _require_float(img: np.ndarray) -> None:
    if img.dtype == np.uint8:
        raise NotImplementedError(
            "uint8 images (raw pixels, JPEG or record input) are not ported "
            "yet: the port's vision pipeline takes normalised float images")


def train_transform(size: int = 224, seed: int = 0) -> Callable[[dict], dict]:
    """Per-example train augmentation of a normalised float image: a random
    resized crop unless it is ``size`` square already, then a random flip,
    both drawn from ``default_rng(seed·2654435761 + content hash)``."""

    def apply(example: dict) -> dict:
        img = example["image"]
        _require_float(img)
        rng = np.random.default_rng(
            (seed * 2654435761 + _content_seed(img)) & 0xFFFFFFFF)
        if img.shape[0] != size or img.shape[1] != size:
            img = random_resized_crop(img, rng, size)
        img = random_flip(img, rng)
        return {**example, "image": np.ascontiguousarray(img, np.float32)}

    return apply


def eval_transform(size: int = 224) -> Callable[[dict], dict]:
    """Eval transform of a normalised float image: a center crop after a
    shorter-side resize to ``round(size / 0.875)``, unless it is ``size``
    square already."""
    resize_shorter = int(round(size / 0.875))

    def apply(example: dict) -> dict:
        img = example["image"]
        _require_float(img)
        if img.shape[0] != size or img.shape[1] != size:
            img = center_crop(img, size, resize_shorter)
        return {**example, "image": np.ascontiguousarray(img, np.float32)}

    return apply


def imagenet_train(dataset: PartitionedDataset, *, size: int = 224, seed: int = 0,
                   num_threads: int | None = None,
                   repeat: bool = False,
                   num_workers: int | None = None) -> PartitionedDataset:
    """shuffle → (repeat) → augment in a thread pool (``num_threads``; 0/1 =
    serial). ``repeat=True`` makes the stream infinite here: shuffle
    precedes repeat, and repeating before the pool keeps one pool alive
    across passes.

    ``num_workers`` (default ``DLS_DATA_WORKERS``, 0 = off): augment over
    worker *processes* instead (:class:`~.workers.WorkerMappedDataset`:
    real cores, no GIL, shared-memory delivery), in place of the thread
    pool, whose ``num_threads`` is then ignored. The batches are the same
    bytes at any count. Each partition's worker walks that partition's
    source: split the source into as many partitions as workers where the
    source's own draw is the expensive part."""
    ds = dataset.shuffle(seed)
    if repeat:
        ds = ds.repeat()
    tf = train_transform(size, seed)
    if workers_lib.resolve_num_workers(num_workers) > 0:
        return workers_lib.WorkerMappedDataset(ds, tf, num_workers,
                                               label="imagenet_train")
    return ds.map_parallel(tf, num_threads=num_threads)


def imagenet_eval(dataset: PartitionedDataset, *, size: int = 224,
                  num_threads: int | None = None,
                  num_workers: int | None = None) -> PartitionedDataset:
    """The eval transform mapped in a thread pool or, with ``num_workers``,
    over worker processes, as :func:`imagenet_train`."""
    if workers_lib.resolve_num_workers(num_workers) > 0:
        return workers_lib.WorkerMappedDataset(
            dataset, eval_transform(size), num_workers, label="imagenet_eval")
    return dataset.map_parallel(eval_transform(size), num_threads=num_threads)
