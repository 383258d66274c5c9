"""Image pipeline — the port of ``distributeddeeplearningspark_tpu/data/vision.py``.

Per-example numpy transforms over a :class:`~..rdd.PartitionedDataset`, run
on the host: :func:`imagenet_train` (shuffle → repeat → decode → crop/flip/
normalize) and :func:`imagenet_eval` (decode → center crop → normalize),
each mapped in a thread pool or, with ``num_workers``, over worker
processes (:mod:`.workers`); and :func:`imagenet_train_batched`, the record
path's feed, which augments a whole batch in one native call. Augmentation
is seeded by the example's content and the pipeline's seed, so the same
examples get the same crops and flips in both packages and at any thread or
worker count.

Images come as uint8 pixels (JPEG bytes under ``"jpeg"``, decoded here by
the port's native baseline decoder, ``csrc/dls_jpeg.cc``, with PIL for
progressive streams; or frames read from records), which are unit-scaled
and standardized with the ImageNet statistics; or as float images already
normalized (``sources.synthetic_images``), which take the geometric steps
only. The uint8 paths run the native (C++) kernels of
:mod:`..utils.native`; their numpy chains are the plain versions, taken
only under ``DLS_DISABLE_NATIVE``.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Iterator

import numpy as np

from distributeddeeplearningspark_tpu_torch.data import workers as workers_lib
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.utils import native

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
    """Bilinear resize (half-pixel centres, edge-clamped), numpy: the plain
    version of the native resize."""
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


def _resize(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize through the native kernel (the same arithmetic as
    :func:`resize_bilinear`, parallel over rows, GIL released)."""
    return native.resize_bilinear(np.asarray(image, np.float32), size)


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
    return _resize(image[y:y + ch, x:x + cw], (size, size))


def center_crop(image: np.ndarray, size: int = 224, resize_shorter: int = 256) -> np.ndarray:
    """Eval transform: resize the shorter side, then center crop."""
    h, w = image.shape[:2]
    scale = resize_shorter / min(h, w)
    image = _resize(image, (int(round(h * scale)), int(round(w * scale))))
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


def decode_jpeg(path_or_bytes) -> np.ndarray:
    """JPEG (a path or the bytes) → uint8 HWC: the native baseline decoder
    (``csrc/dls_jpeg.cc``), or PIL for a stream outside baseline
    (progressive); without PIL such a stream raises. Under
    ``DLS_DISABLE_NATIVE`` every stream goes to PIL."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    try:
        out = native.jpeg_decode(data)
        if out is not None:
            return out
    except native.JpegUnsupported:
        pass  # progressive etc. → PIL
    try:
        import io

        from PIL import Image
    except ImportError as e:
        raise RuntimeError("this JPEG is not baseline (progressive?) and PIL, "
                           "which would decode it, is not installed") from e
    img = Image.open(io.BytesIO(data))
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    return arr[..., None] if arr.ndim == 2 else arr


def _augment_decision(img: np.ndarray, seed: int, size: int
                      ) -> tuple[tuple[int, int, int, int] | None, bool]:
    """The content-seeded crop and flip of a uint8 image → ``(region,
    flip)``, shared by :func:`train_transform`, :func:`_fused_example_transform`
    and :func:`imagenet_train_batched`, so that every path draws the same
    stream: a frame already ``size`` square draws no region (the region is
    the whole frame), then one flip; otherwise the 10-draw crop sampler runs
    first. ``region`` is None when the sampler gave up: the caller takes a
    center crop."""
    rng = np.random.default_rng(
        (seed * 2654435761 + _content_seed(img)) & 0xFFFFFFFF)
    h, w = img.shape[:2]
    if h == w == size:
        region: tuple[int, int, int, int] | None = (0, 0, h, w)
    else:
        region = sample_crop_region(h, w, rng)
    return region, bool(rng.random() < 0.5)


def _decode_if_bytes(example: dict) -> dict:
    """``{"jpeg": bytes}`` (``imagenet_folder(decode=False)``) → the decoded
    ``{"image": ...}``, a grayscale stray repeated to RGB as
    ``imagenet_folder(decode=True)`` repeats it (the JAX package's transform
    keeps its one channel, and its batch then fails to stack). Decoding
    inside the transform lets the thread pool or the worker processes spread
    it over cores."""
    if "jpeg" not in example:
        return example
    out = {k: v for k, v in example.items() if k != "jpeg"}
    img = decode_jpeg(example["jpeg"])
    out["image"] = np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img
    return out


def train_transform(size: int = 224, seed: int = 0) -> Callable[[dict], dict]:
    """Per-example train augmentation, seeded by ``default_rng(seed ·
    2654435761 + content hash)``. A uint8 image (JPEG bytes are decoded
    first): a random resized crop unless it is ``size`` square already,
    a random flip, then ``(x/255 - mean)/std``, in one native pass. A float
    image, normalized already: the crop and the flip only."""

    def apply(example: dict) -> dict:
        example = _decode_if_bytes(example)
        img = example["image"]
        if img.dtype == np.uint8:
            region, flip = _augment_decision(img, seed, size)
            if img.shape[0] == img.shape[1] == size:
                img = native.crop_flip_normalize_batch(
                    img[None], np.zeros(1, np.int32), np.zeros(1, np.int32),
                    np.array([flip], np.uint8), (size, size),
                    IMAGENET_MEAN, IMAGENET_STD)[0]
                return {**example, "image": img}
            fused = (native.rrc_flip_normalize(
                img, region, flip, (size, size), IMAGENET_MEAN, IMAGENET_STD)
                if region is not None else None)
            if fused is not None:
                return {**example, "image": fused}
            if region is not None:
                y, x, ch, cw = region
                img = _resize(img[y:y + ch, x:x + cw].astype(np.float32) / 255.0,
                              (size, size))
            else:
                img = center_crop(img.astype(np.float32) / 255.0, size)
            img = normalize(img[:, ::-1] if flip else img)
        else:
            rng = np.random.default_rng(
                (seed * 2654435761 + _content_seed(img)) & 0xFFFFFFFF)
            if img.shape[0] != size or img.shape[1] != size:
                img = random_resized_crop(img, rng, size)
            img = random_flip(img, rng)
        return {**example, "image": np.ascontiguousarray(img, np.float32)}

    return apply


def eval_transform(size: int = 224) -> Callable[[dict], dict]:
    """The eval transform: a center crop after a shorter-side resize to
    ``round(size / 0.875)``, unless the image is ``size`` square already.
    A uint8 image (JPEG bytes are decoded first) is also standardized; a
    record's frame whose shorter side is that size already is cropped in
    uint8 and normalized in one native pass."""
    resize_shorter = int(round(size / 0.875))

    def apply(example: dict) -> dict:
        example = _decode_if_bytes(example)
        img = example["image"]
        needs_crop = img.shape[0] != size or img.shape[1] != size
        if img.dtype == np.uint8:
            if not needs_crop:
                return {**example, "image": native.normalize_u8_batch(
                    img[None], IMAGENET_MEAN, IMAGENET_STD)[0]}
            h, w = img.shape[:2]
            if min(h, w) == resize_shorter:
                y, x = (h - size) // 2, (w - size) // 2
                return {**example, "image": native.crop_flip_normalize_batch(
                    img[None], np.array([y], np.int32), np.array([x], np.int32),
                    np.zeros(1, np.uint8), (size, size),
                    IMAGENET_MEAN, IMAGENET_STD)[0]}
            img = normalize(center_crop(img.astype(np.float32) / 255.0, size,
                                        resize_shorter))
        elif needs_crop:
            img = center_crop(img, size, resize_shorter)
        return {**example, "image": np.ascontiguousarray(img, np.float32)}

    return apply


def imagenet_train(dataset: PartitionedDataset, *, size: int = 224, seed: int = 0,
                   num_threads: int | None = None,
                   repeat: bool = False,
                   num_workers: int | None = None) -> PartitionedDataset:
    """shuffle → (repeat) → decode and augment in a thread pool
    (``num_threads``; 0/1 = serial). Feed it ``sources.imagenet_folder(root,
    decode=False)`` so that JPEG decode runs in the pool, not on the
    consumer's thread. ``repeat=True`` makes the stream infinite here:
    shuffle precedes repeat, and repeating before the pool keeps one pool
    alive across passes.

    ``num_workers`` (default ``DLS_DATA_WORKERS``, 0 = off): decode and
    augment over worker *processes* instead (:class:`~.workers.
    WorkerMappedDataset`: real cores, no GIL, shared-memory delivery), in
    place of the thread pool, whose ``num_threads`` is then ignored. The
    batches are the same bytes at any count. Each partition's worker walks
    that partition's source: split the source into as many partitions as
    workers where the source's own draw is the expensive part."""
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


def _fused_example_transform(size: int, seed: int) -> Callable[[dict], dict]:
    """The per-example twin of :func:`imagenet_train_batched`'s batch call:
    the varbatch kernel's arithmetic for one image (``csrc/dls_native.cc``
    shares it between ``dls_rrc_flip_normalize`` and the varbatch loop) and
    the batch's decisions and fallbacks, so the worker-pool form of the
    batched feed gives the in-process form's bytes at any ``num_workers``."""
    tf_fallback = train_transform(size, seed)

    def one(ex: dict) -> dict:
        img = ex.get("image")
        if (native.available() and isinstance(img, np.ndarray)
                and img.dtype == np.uint8 and img.ndim == 3):
            region, flip = _augment_decision(img, seed, size)
            if region is not None:
                fused = native.rrc_flip_normalize(
                    img, region, flip, (size, size), IMAGENET_MEAN, IMAGENET_STD)
                if fused is not None:
                    return {**ex, "image": fused}
        return {**ex, "image": tf_fallback(dict(ex))["image"]}

    return one


def imagenet_train_batched(dataset: PartitionedDataset, batch_size: int, *,
                           size: int = 224, seed: int = 0,
                           drop_remainder: bool = True,
                           num_workers: int | None = None) -> Iterator[dict]:
    """The record path's feed: ready train batches, ``{"image": [B, size,
    size, 3] f32, "label": [B] i32}``, each augmented in one native call.

    Records stream serially; each example's crop and flip are drawn from its
    content as :func:`train_transform` draws them; then one
    ``dls_rrc_flip_normalize_varbatch`` call crops, resizes, flips and
    normalizes every image of the batch into the batch's buffer (parallel
    over images, no GIL, no stacking pass). An image the kernel cannot take
    (a float image, or one whose crop sampler gave up) takes the
    per-example chain. Shuffle and repeat the dataset before this feed; its
    partitions are dealt round robin, as ``feed.host_batches`` deals them.

    ``num_workers`` (default ``DLS_DATA_WORKERS``, 0 = off): the
    per-example fused augment runs over worker processes (:mod:`.workers`),
    with the same arithmetic, so the batches are the same bytes at any
    count; the consumer copies each shared-memory view into the batch."""
    if workers_lib.resolve_num_workers(num_workers) > 0:
        mapped = workers_lib.WorkerMappedDataset(
            dataset, _fused_example_transform(size, seed), num_workers,
            label="imagenet_train_batched")

        def stack_mapped(buf: list[dict]) -> dict:
            out = np.empty((len(buf), size, size, 3), np.float32)
            for j, e in enumerate(buf):
                out[j] = e["image"]
            rest = {k: np.stack([np.asarray(e[k]) for e in buf])
                    for k in buf[0] if k != "image"}
            return {"image": out, **rest}

        return _batched(mapped, batch_size, stack_mapped, drop_remainder)

    tf_fallback = train_transform(size, seed)

    def fused_batch(buf: list[dict]) -> dict:
        fused_idx, images, regions, flips = [], [], [], []
        fallback_idx: list[int] = []
        if native.available():
            for j, ex in enumerate(buf):
                img = ex["image"]
                if img.dtype != np.uint8 or img.ndim != 3:
                    fallback_idx.append(j)
                    continue
                region, flip = _augment_decision(img, seed, size)
                if region is None:
                    fallback_idx.append(j)
                    continue
                fused_idx.append(j)
                images.append(img)
                regions.append(region)
                flips.append(flip)
        else:
            fallback_idx = list(range(len(buf)))
        out = np.empty((len(buf), size, size, 3), np.float32)
        if fused_idx:
            out[np.asarray(fused_idx)] = native.rrc_flip_normalize_varbatch(
                images, np.asarray(regions, np.int32), np.asarray(flips, np.uint8),
                (size, size), IMAGENET_MEAN, IMAGENET_STD)
        for j in fallback_idx:
            out[j] = tf_fallback(dict(buf[j]))["image"]
        rest = {k: np.stack([np.asarray(e[k]) for e in buf])
                for k in buf[0] if k != "image"}
        return {"image": out, **rest}

    return _batched(dataset, batch_size, fused_batch, drop_remainder)


def _batched(dataset: PartitionedDataset, batch_size: int,
             make: Callable[[list[dict]], dict], drop_remainder: bool
             ) -> Iterator[dict]:
    """``make`` over consecutive ``batch_size`` examples of ``dataset``'s
    partitions dealt round robin."""
    from distributeddeeplearningspark_tpu_torch.data.feed import _round_robin

    streams = [iter(dataset.iter_partition(i)) for i in range(dataset.num_partitions)]
    buf: list[dict] = []
    for ex in _round_robin(streams):
        buf.append(ex)
        if len(buf) == batch_size:
            yield make(buf)
            buf = []
    if buf and not drop_remainder:
        yield make(buf)
