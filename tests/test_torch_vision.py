"""The port's image data path against the JAX package's: ``synthetic_images``
→ ``imagenet_train``/``imagenet_eval`` → the one-shard feed, byte for byte
on a multi-partition dataset; the RDD ``shuffle`` and ``map_parallel`` it
adds; and the float transforms (crop, resize, flip) that resize, within
f32 rounding of the JAX package's numpy resize."""

import numpy as np
import pytest

from distributeddeeplearningspark_tpu.data import feed as jfeed
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.data import vision as jvision
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu_torch.data import feed as tfeed
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.data import vision as tvision
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from test_torch_deadline import per_test


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


def test_uint8_images_are_refused():
    ex = {"image": np.zeros((8, 8, 3), np.uint8), "label": np.int32(0)}
    with pytest.raises(NotImplementedError, match="uint8"):
        tvision.train_transform(8)(ex)
    with pytest.raises(NotImplementedError, match="uint8"):
        tvision.eval_transform(8)(ex)


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
