"""The port's ``data/records.py`` against the JAX package's, on the CPU: the
same bytes on disk from the same examples, records written by either package
read bitwise in the other, the same partition splits of a shard through its
footer index, the materialization of a JPEG tree (decode, shorter-side
resize) into the same shards, and the writers' failure paths (a shard that
fails mid-write is deleted; a streaming reshard that fails aborts every
shard; a shard without its footer is refused)."""

import io
import os

import numpy as np
import pytest

from distributeddeeplearningspark_tpu.data import records as jrec
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu.utils import native as jnative
from distributeddeeplearningspark_tpu_torch.data import records as trec
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _examples(n=11, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = 20 + (i % 4) * 3, 30 - (i % 3) * 2
        out.append({"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                    "label": np.int32(i % 5),
                    "feat": rng.normal(size=(3, 2)).astype(np.float32),
                    "ids": np.arange(i, dtype=np.int64),
                    "score": np.float64(i / 7)})
    return out


def _equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            g_, w_ = np.asarray(g[k]), np.asarray(w[k])
            assert g_.dtype == w_.dtype and g_.shape == w_.shape, k
            np.testing.assert_array_equal(g_, w_, err_msg=k)


def test_a_record_packs_to_the_references_bytes():
    for ex in _examples(5):
        body = trec._pack_record(ex)
        assert body == jrec._pack_record(ex)
        _equal([trec._unpack_record(body)], [ex])
    # a 0-d label comes back 0-d, not [1]
    assert np.ndim(trec._unpack_record(trec._pack_record({"y": np.int32(3)}))["y"]) == 0


@pytest.mark.parametrize("num_shards", [None, 3])
def test_shards_are_the_references_bytes_and_cross_read(tmp_path, num_shards):
    exs = _examples()
    tpaths = trec.write_array_records(TDataset.parallelize(exs, 2),
                                      str(tmp_path / "t"), num_shards=num_shards)
    jpaths = jrec.write_array_records(JDataset.parallelize(exs, 2),
                                      str(tmp_path / "j"), num_shards=num_shards)
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    for t, j in zip(tpaths, jpaths):
        assert open(t, "rb").read() == open(j, "rb").read()
    # written by the JAX package, read by the port, and the other way round
    _equal(trec.array_records(str(tmp_path / "j")).collect(),
           jrec.array_records(str(tmp_path / "j")).collect())
    _equal(jrec.array_records(str(tmp_path / "t")).collect(),
           trec.array_records(str(tmp_path / "t")).collect())


@pytest.mark.parametrize("num_partitions", [None, 1, 2, 5, 13])
def test_partition_splits_follow_the_reference(tmp_path, num_partitions):
    exs = _examples(17)
    jrec.write_array_records(JDataset.parallelize(exs, 3), str(tmp_path / "r"))
    got = trec.array_records(str(tmp_path / "r"), num_partitions=num_partitions)
    want = jrec.array_records(str(tmp_path / "r"), num_partitions=num_partitions)
    assert got.num_partitions == want.num_partitions
    for i in range(want.num_partitions):
        g, w = list(got.iter_partition(i)), list(want.iter_partition(i))
        assert len(g) == len(w)
        if w:
            _equal(g, w)
    assert sum(len(list(got.iter_partition(i))) for i in range(got.num_partitions)) == 17


def test_shard_paths_and_a_single_file(tmp_path):
    paths = trec.write_array_records(iter(_examples(4)), str(tmp_path / "r"))
    assert trec.shard_paths(str(tmp_path / "r")) == paths
    assert trec.shard_paths(paths[0]) == [paths[0]]
    _equal(trec.array_records(paths[0]).collect(), _examples(4))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no .dlsrec"):
        trec.shard_paths(str(tmp_path / "empty"))


def test_a_failed_shard_is_not_left_looking_complete(tmp_path):
    p = str(tmp_path / "part-00000.dlsrec")
    with pytest.raises(RuntimeError):
        with trec.RecordShardWriter(p) as w:
            w.write({"x": np.arange(3)})
            raise RuntimeError("decode failed")
    assert not os.path.exists(p)


@pytest.mark.parametrize("num_shards", [None, 3])
def test_a_failed_write_aborts_every_shard(tmp_path, num_shards):
    """A source that fails part-way leaves no shard behind, resharding or not
    (a completed earlier shard would otherwise pass for a whole one)."""
    def gen():
        yield {"x": np.arange(2)}
        yield {"x": np.arange(3)}
        raise RuntimeError("boom")

    parts = TDataset([lambda: iter([{"x": np.arange(4)}]), gen])
    with pytest.raises(RuntimeError, match="boom"):
        trec.write_array_records(parts, str(tmp_path / "rec"), num_shards=num_shards)
    assert not [f for f in os.listdir(tmp_path / "rec") if f.endswith(".dlsrec")]


def test_a_truncated_shard_is_refused(tmp_path):
    (path,) = trec.write_array_records(iter(_examples(3)), str(tmp_path / "r"))
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-5])
    with pytest.raises(ValueError, match="missing footer index"):
        trec.array_records(path)
    open(path, "wb").write(b"NOTAREC!" + data[8:])
    with pytest.raises(ValueError, match="not a DLSREC01 file"):
        trec.array_records(path)


def _jpeg_tree(root, n_per_class=3, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c, name in enumerate(["cat", "dog", "eel"]):
        os.makedirs(root / name)
        for i in range(n_per_class):
            h, w = 40 + 11 * i + c, 60 - 7 * i
            y, x = np.mgrid[0:h, 0:w]
            arr = np.clip(y[..., None] * (c + 1) + x[..., None] * 2
                          + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
            if i == 1 and c == 2:
                arr = arr[..., 0]  # a grayscale stray: repeated to RGB
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90)
            (root / name / f"{i}.jpg").write_bytes(buf.getvalue())


@pytest.mark.parametrize("size", [32, 48])
def test_materialized_imagenet_records_are_the_references(tmp_path, size):
    """``write_imagenet_records``: JPEG decode, a shorter-side resize to
    ``size`` where it shrinks (never an upscale), uint8 frames, labels from
    the sorted classes: the same shard bytes from both packages."""
    _jpeg_tree(tmp_path / "jpeg")
    # load the JAX package's library before its threads do: its lazy load
    # is not locked, and a thread that calls while another loads takes the
    # numpy resize (a pixel 1 off after the cast to uint8); the port's
    # load is locked
    assert jnative.available()
    tpaths = trec.write_imagenet_records(str(tmp_path / "jpeg"), str(tmp_path / "t"),
                                         size=size, num_shards=2)
    jpaths = jrec.write_imagenet_records(str(tmp_path / "jpeg"), str(tmp_path / "j"),
                                         size=size, num_shards=2)
    assert len(tpaths) == len(jpaths) == 2
    for t, j in zip(tpaths, jpaths):
        assert open(t, "rb").read() == open(j, "rb").read()
    got = trec.array_records(str(tmp_path / "t")).collect()
    assert len(got) == 9 and {int(e["label"]) for e in got} == {0, 1, 2}
    for e in got:
        assert e["image"].dtype == np.uint8 and e["image"].shape[2] == 3
        assert min(e["image"].shape[:2]) <= max(size, 40)
