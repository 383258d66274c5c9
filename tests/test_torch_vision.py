"""The port's image data path against the JAX package's: ``synthetic_images``
→ ``imagenet_train``/``imagenet_eval`` → the one-shard feed, byte for byte
on a multi-partition dataset; the RDD ``shuffle`` and ``map_parallel`` it
adds; the float transforms (crop, resize, flip) that resize, within f32
rounding of the JAX package's numpy resize; and the uint8 paths: raw
frames, a JPEG tree (``imagenet_folder(decode=False)``) and records
through ``imagenet_train``, ``imagenet_eval`` and the record path's
``imagenet_train_batched``, bitwise the JAX package's batches at 0 and 2
worker processes, the batched feed bitwise the per-example chain."""

import numpy as np
import pytest

import io
import os

from distributeddeeplearningspark_tpu.data import feed as jfeed
from distributeddeeplearningspark_tpu.data import records as jrecords
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.data import vision as jvision
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu.utils import native as jnative
from distributeddeeplearningspark_tpu_torch.data import feed as tfeed
from distributeddeeplearningspark_tpu_torch.data import records as trecords
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.data import vision as tvision
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from test_torch_deadline import bounded, per_test

# the JAX package's native library loads lazily without a lock, and a pool
# thread that calls while another loads takes its numpy path: load it first
assert jnative.available()


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_images_match_jax(seed):
    kw = dict(image_size=16, num_classes=100, num_partitions=3, seed=seed)
    got = tsources.synthetic_images(30, **kw)
    want = jsources.synthetic_images(30, **kw)
    assert got.num_partitions == want.num_partitions == 3
    _batches_equal([tfeed.stack_examples(got.collect())],
                   [tfeed.stack_examples(want.collect())])


@pytest.mark.parametrize("threads", [0, 4])
def test_imagenet_train_batches_match_jax_byte_for_byte(threads):
    """224² float images (the synthetic branch of examples/train_resnet.py),
    3 partitions, repeat=True: shuffle, repeat and the content-seeded flip
    give the JAX pipeline's batches, across two passes of the data."""
    src = dict(image_size=224, num_classes=1000, num_partitions=3, seed=1)
    tds = tvision.imagenet_train(tsources.synthetic_images(12, **src), size=224,
                                 seed=5, repeat=True, num_threads=threads)
    jds = jvision.imagenet_train(jsources.synthetic_images(12, **src), size=224,
                                 seed=5, repeat=True, num_threads=threads,
                                 num_workers=0)
    assert tds.is_infinite and jds.is_infinite
    got, want = tfeed.host_batches(tds, 4), jfeed.host_batches(jds, 4)
    _batches_equal([next(got) for _ in range(6)], [next(want) for _ in range(6)])


def test_imagenet_train_crops_images_of_another_size():
    """40×48 images crop and resize to 32²: the same crop and flip as the
    JAX pipeline (the content-seeded draws), the numpy resize within f32
    rounding of the JAX package's resize."""
    rng = np.random.default_rng(0)
    imgs = [{"image": rng.normal(0, 1, (40, 48, 3)).astype(np.float32),
             "label": np.int32(i)} for i in range(6)]
    tds = tvision.imagenet_train(TDataset.parallelize(imgs, 2), size=32, seed=1)
    jds = jvision.imagenet_train(JDataset.parallelize(imgs, 2), size=32, seed=1,
                                 num_workers=0)
    got, want = tds.collect(), jds.collect()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["image"].shape == (32, 32, 3) and g["image"].dtype == np.float32
        assert g["label"] == w["label"]
        np.testing.assert_allclose(g["image"], w["image"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(32, 32, 3), (40, 30, 3), (64, 80, 3)])
def test_imagenet_eval_matches_jax(shape):
    rng = np.random.default_rng(1)
    imgs = [{"image": rng.normal(0, 1, shape).astype(np.float32),
             "label": np.int32(i)} for i in range(4)]
    got = tvision.imagenet_eval(TDataset.parallelize(imgs, 2), size=32).collect()
    want = jvision.imagenet_eval(JDataset.parallelize(imgs, 2), size=32,
                                 num_workers=0).collect()
    for g, w in zip(got, want):
        assert g["image"].shape == (32, 32, 3)
        np.testing.assert_allclose(g["image"], w["image"], rtol=1e-5, atol=1e-5)


def test_float_transforms_match_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvision.normalize(img), jvision.normalize(img))
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(tvision.normalize(u8), jvision.normalize(u8))
    np.testing.assert_array_equal(tvision.resize_bilinear(img, (20, 31)),
                                  jvision.resize_bilinear(img, (20, 31)))
    for seed in range(5):
        assert (tvision.sample_crop_region(37, 53, np.random.default_rng(seed))
                == jvision.sample_crop_region(37, 53, np.random.default_rng(seed)))
        np.testing.assert_array_equal(
            tvision.random_flip(img, np.random.default_rng(seed)),
            jvision.random_flip(img, np.random.default_rng(seed)))
    assert tvision._content_seed(img) == jvision._content_seed(img)
    np.testing.assert_allclose(tvision.center_crop(img, 16, 20),
                               jvision.center_crop(img, 16, 20),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffle_matches_jax(seed):
    data = list(range(23))
    got = TDataset.parallelize(data, 3).shuffle(seed).collect()
    assert got == JDataset.parallelize(data, 3).shuffle(seed).collect()
    assert sorted(got) == data and got != data
    with pytest.raises(ValueError, match="BEFORE"):
        TDataset.parallelize(data, 3).repeat().shuffle(seed)


@pytest.mark.parametrize("threads", [0, 1, 3, None])
def test_map_parallel_keeps_order_on_infinite_streams(threads):
    ds = TDataset.parallelize(list(range(10)), 2).repeat()
    mapped = ds.map_parallel(lambda x: x * x, num_threads=threads)
    assert mapped.is_infinite
    it = mapped.iter_partition(1)
    assert [next(it) for _ in range(12)] == [x * x for x in [5, 6, 7, 8, 9] * 3][:12]
    finite = TDataset.parallelize(list(range(10)), 2).map_parallel(
        lambda x: -x, num_threads=threads)
    assert finite.collect() == [-x for x in range(10)]


# -- the uint8 paths: frames, JPEGs, records ---------------------------------


def _frames(n=10, seed=0):
    """uint8 frames of several sizes: a 32² one (no crop drawn), others
    cropped and resized, one very wide (the crop sampler may give up)."""
    rng = np.random.default_rng(seed)
    shapes = [(32, 32), (40, 52), (61, 45), (33, 90), (20, 150)]
    return [{"image": rng.integers(0, 256, (*shapes[i % 5], 3), dtype=np.uint8),
             "label": np.int32(i % 7)} for i in range(n)]


@pytest.fixture(scope="module")
@bounded()
def jpeg_root(tmp_path_factory):
    """A class-per-subdirectory tree of JPEGs written with PIL: 4:2:0 and
    4:4:4, sizes around the 32² crop."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jpeg")
    rng = np.random.default_rng(11)
    for c in range(3):
        os.makedirs(root / f"n0{c}")
        for i in range(4):
            h, w = 36 + 5 * i + c, 44 - 3 * i
            y, x = np.mgrid[0:h, 0:w]
            arr = np.clip(y[..., None] * 3 + x[..., None] * (c + 1)
                          + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90,
                                      subsampling=0 if i % 2 else 2)
            (root / f"n0{c}" / f"img{i}.jpg").write_bytes(buf.getvalue())
    return root


def _sources(kind, jpeg_root, tmp_path):
    """The same examples in both packages: (port's dataset, JAX's)."""
    if kind == "frames":
        return TDataset.parallelize(_frames(), 3), JDataset.parallelize(_frames(), 3)
    if kind == "jpeg":
        return (tsources.imagenet_folder(str(jpeg_root), num_partitions=3, decode=False),
                jsources.imagenet_folder(str(jpeg_root), num_partitions=3, decode=False))
    out = str(tmp_path / "rec")
    jrecords.write_imagenet_records(str(jpeg_root), out, size=40, num_shards=2)
    return (trecords.array_records(out, num_partitions=3),
            jrecords.array_records(out, num_partitions=3))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kind", ["frames", "jpeg", "records"])
def test_uint8_train_batches_are_the_references(kind, workers, jpeg_root, tmp_path):
    """Raw uint8 frames, JPEG bytes decoded in the pipeline and records
    through ``imagenet_train`` (shuffle, repeat, the content-seeded crop and
    flip, the fused native augment): the JAX pipeline's batches bitwise,
    over two passes, in process and over 2 worker processes."""
    tsrc, jsrc = _sources(kind, jpeg_root, tmp_path)
    tds = tvision.imagenet_train(tsrc, size=32, seed=3, repeat=True,
                                 num_threads=0, num_workers=workers)
    jds = jvision.imagenet_train(jsrc, size=32, seed=3, repeat=True,
                                 num_threads=0, num_workers=0)
    got, want = tfeed.host_batches(tds, 4), jfeed.host_batches(jds, 4)
    try:
        _batches_equal([next(got) for _ in range(6)], [next(want) for _ in range(6)])
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("kind", ["frames", "jpeg", "records"])
def test_uint8_eval_is_the_references(kind, jpeg_root, tmp_path):
    """The eval transform's three uint8 branches (a ``size`` square frame, a
    record frame whose shorter side is the resize target, any other frame)."""
    tsrc, jsrc = _sources(kind, jpeg_root, tmp_path)
    got = tvision.imagenet_eval(tsrc, size=35, num_threads=0).collect()
    want = jvision.imagenet_eval(jsrc, size=35, num_threads=0, num_workers=0).collect()
    _batches_equal([tfeed.stack_examples(got)], [jfeed.stack_examples(want)])
    frame = {"image": np.arange(40 * 52 * 3, dtype=np.uint8).reshape(40, 52, 3) % 251}
    for size in (35, 40):  # round(35 / 0.875) == 40: the record branch
        np.testing.assert_array_equal(tvision.eval_transform(size)(frame)["image"],
                                      jvision.eval_transform(size)(frame)["image"])


@pytest.mark.parametrize("workers", [0, 2])
def test_batched_feed_is_the_per_example_chain(workers, jpeg_root, tmp_path):
    """``imagenet_train_batched`` over records: one varbatch call a batch,
    bitwise ``host_batches`` of ``imagenet_train``'s per-example chain (the
    same crops and flips), and the JAX package's batched feed, in process
    and over 2 worker processes; the tail batch kept when asked."""
    tsrc, jsrc = _sources("records", jpeg_root, tmp_path)
    got = list(tvision.imagenet_train_batched(tsrc.shuffle(2), 5, size=32, seed=2,
                                              drop_remainder=False,
                                              num_workers=workers))
    chain = list(tfeed.host_batches(tvision.imagenet_train(
        tsrc, size=32, seed=2, num_threads=0), 5, drop_remainder=False))
    want = list(jvision.imagenet_train_batched(jsrc.shuffle(2), 5, size=32, seed=2,
                                               drop_remainder=False, num_workers=0))
    assert [len(b["label"]) for b in got] == [5, 5, 2]
    _batches_equal(got, want)
    _batches_equal(got, chain)


@pytest.mark.parametrize("decode", [True, False])
def test_imagenet_folder_is_the_references(decode, jpeg_root):
    got = tsources.imagenet_folder(str(jpeg_root), num_partitions=2, decode=decode)
    want = jsources.imagenet_folder(str(jpeg_root), num_partitions=2, decode=decode)
    assert got.num_partitions == want.num_partitions == 2
    g, w = got.collect(), want.collect()
    assert len(g) == len(w) == 12
    for a, b in zip(g, w):
        assert a.keys() == b.keys() and a["label"] == b["label"]
        if decode:
            assert a["image"].dtype == np.uint8 and a["image"].shape[2] == 3
            np.testing.assert_array_equal(a["image"], b["image"])
        else:
            assert a["jpeg"] == b["jpeg"]


def test_class_mapping_pins_across_trees(jpeg_root, tmp_path):
    """``folder_classes`` is the sorted class directories; an eval tree with
    fewer classes keeps the train tree's labels through ``class_to_index``."""
    classes = tsources.folder_classes(str(jpeg_root))
    assert classes == jsources.folder_classes(str(jpeg_root)) == \
        {"n00": 0, "n01": 1, "n02": 2}
    os.makedirs(tmp_path / "val" / "n02")
    src = jpeg_root / "n02" / "img0.jpg"
    (tmp_path / "val" / "n02" / "a.jpg").write_bytes(src.read_bytes())
    (tmp_path / "val" / ".hidden").mkdir()
    pinned = tsources.imagenet_folder(str(tmp_path / "val"), decode=False,
                                      class_to_index=classes).collect()
    assert [int(e["label"]) for e in pinned] == [2]
    derived = tsources.imagenet_folder(str(tmp_path / "val"), decode=False).collect()
    assert [int(e["label"]) for e in derived] == [0]
    with pytest.raises(FileNotFoundError, match="no class directories"):
        tsources.folder_classes(str(tmp_path / "val" / "n02"))
    with pytest.raises(FileNotFoundError, match="no JPEG files"):
        tsources.imagenet_folder(str(tmp_path / "val"), class_to_index={"zz": 0})


def test_a_grayscale_jpeg_trains_as_its_rgb_frame():
    """A grayscale JPEG in the pipeline is repeated to RGB, as
    ``imagenet_folder(decode=True)`` repeats it: the JAX pipeline's batch of
    the repeated frame, bitwise (the JAX transform keeps one channel)."""
    from PIL import Image

    y, x = np.mgrid[0:45, 0:38]
    buf = io.BytesIO()
    Image.fromarray(((y * 3 + x * 2) % 256).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    frame = np.repeat(jvision.decode_jpeg(buf.getvalue()), 3, axis=-1)
    got = tvision.train_transform(32, seed=1)({"jpeg": buf.getvalue()})
    want = jvision.train_transform(32, seed=1)({"image": frame})
    assert got["image"].shape == (32, 32, 3)
    np.testing.assert_array_equal(got["image"], want["image"])
