"""The port's host data path against the JAX package's: the RDD surface it
copies, the WordPiece tokenizer, ``synthetic_wikipedia`` and
``mlm_dataset`` (byte for byte, example by example, from the same
documents and seed), the one-shard feed, and the one-device Session."""

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.data import feed as jfeed
from distributeddeeplearningspark_tpu.data import text as jtext
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu_torch.data import feed as tfeed
from distributeddeeplearningspark_tpu_torch.data import text as ttext
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF, Session
from test_torch_deadline import bounded, per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _assert_examples_equal(got: list[dict], want: list[dict]):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module")
@bounded()
def corpus():
    jdocs = jtext.synthetic_wikipedia(96, num_partitions=3, seed=4)
    tdocs = ttext.synthetic_wikipedia(96, num_partitions=3, seed=4)
    lines = jdocs.collect()
    return jdocs, tdocs, lines, jtext.WordPieceTokenizer.train(lines, vocab_size=48)


def test_synthetic_wikipedia_matches_jax(corpus):
    jdocs, tdocs, lines, _ = corpus
    assert tdocs.num_partitions == jdocs.num_partitions
    assert tdocs.collect() == lines


def test_tokenizer_matches_jax(corpus, tmp_path):
    _, _, lines, jtok = corpus
    ttok = ttext.WordPieceTokenizer.train(lines, vocab_size=48)
    assert ttok.vocab == jtok.vocab and ttok.vocab_size == 48
    text = lines[0] + " Zebra-crossing 42!"
    assert ttok.encode(text) == jtok.encode(text)
    assert ttok.decode(ttok.encode(text)) == jtok.decode(jtok.encode(text))
    ttok.save(str(tmp_path / "vocab.txt"))
    assert jtext.WordPieceTokenizer.load(str(tmp_path / "vocab.txt")).vocab == jtok.vocab
    assert ttext.WordPieceTokenizer.load(str(tmp_path / "vocab.txt")).vocab == jtok.vocab


@pytest.mark.parametrize("kw", [
    dict(seq_len=64),
    dict(seq_len=64, max_predictions=12),
    dict(seq_len=64, max_predictions=12, segment_ids=True, seed=3),
    dict(seq_len=48, pack=False, mask_prob=0.3),
], ids=["packed", "gathered", "segments", "padded"])
def test_mlm_dataset_matches_jax_byte_for_byte(corpus, kw):
    jdocs, tdocs, lines, jtok = corpus
    ttok = ttext.WordPieceTokenizer.train(lines, vocab_size=48)
    want = jtext.mlm_dataset(jdocs, jtok, num_workers=0, **kw).collect()
    got = ttext.mlm_dataset(tdocs, ttok, **kw).collect()
    _assert_examples_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(seq_len=64),
    dict(seq_len=64, segment_ids=True),
    dict(seq_len=100, eos_between_docs=False),
    dict(seq_len=4096, segment_ids=True),
    dict(seq_len=64, segment_ids=True, num_workers=2),
], ids=["packed", "segments", "no_eos", "tail_only", "segments_pooled"])
def test_lm_dataset_matches_jax_byte_for_byte(corpus, kw):
    """Config 5's feed: full windows, the corpus tail's short block (its
    padding out of ``loss_mask``, its pads at segment -1), the same bytes
    when tokenized over worker processes."""
    jdocs, tdocs, lines, jtok = corpus
    ttok = ttext.WordPieceTokenizer.train(lines, vocab_size=48)
    want = jtext.lm_dataset(jdocs, jtok, **{**kw, "num_workers": 0}).collect()
    got = ttext.lm_dataset(tdocs, ttok, **kw).collect()
    _assert_examples_equal(got, want)
    assert {"input_ids", "loss_mask"} <= set(got[0])


def test_mlm_dataset_rejects_segments_without_packing(corpus):
    _, tdocs, lines, _ = corpus
    ttok = ttext.WordPieceTokenizer.train(lines, vocab_size=48)
    with pytest.raises(ValueError, match="pack=True"):
        ttext.mlm_dataset(tdocs, ttok, pack=False, segment_ids=True)


@pytest.mark.parametrize("n,slices", [(10, 3), (7, 1), (4, 4)])
def test_parallelize_take_repeat_match_jax(n, slices):
    data = list(range(n))
    j, t = JDataset.parallelize(data, slices), TDataset.parallelize(data, slices)
    assert [list(t.iter_partition(i)) for i in range(t.num_partitions)] == \
        [list(j.iter_partition(i)) for i in range(j.num_partitions)]
    assert t.map(lambda x: x * 2).take(5) == j.map(lambda x: x * 2).take(5)
    assert t.repeat(2).collect() == j.repeat(2).collect()
    assert t.repeat().is_infinite and t.repeat().take(2 * n) == j.repeat().take(2 * n)
    with pytest.raises(ValueError, match="infinite"):
        t.repeat().collect()
    arr = np.arange(n)
    assert [a.tolist() for a in TDataset.parallelize(arr, slices).collect()] == \
        [a.tolist() for a in JDataset.parallelize(arr, slices).collect()]
    gens = [lambda i=i: iter(range(i, n, slices)) for i in range(slices)]
    assert TDataset.from_generators(gens).map_partitions_with_index(
        lambda i, it: (i * 100 + x for x in it)).collect() == \
        JDataset.from_generators(gens).map_partitions_with_index(
            lambda i, it: (i * 100 + x for x in it)).collect()


@pytest.mark.parametrize("parts,batch,drop,pad", [
    (3, 4, True, False), (3, 4, False, False), (3, 4, False, True),
    (1, 5, False, True), (2, 6, True, False),
])
def test_host_batches_match_jax_one_shard(parts, batch, drop, pad):
    def mk(ds_cls):
        return ds_cls.parallelize(
            [{"x": np.full(3, i, np.int32), "y": np.float32(i)} for i in range(17)],
            parts)

    want = list(jfeed.host_batches(mk(JDataset), batch, num_shards=1,
                                   drop_remainder=drop, pad_remainder=pad))
    got = list(tfeed.host_batches(mk(TDataset), batch, drop_remainder=drop,
                                  pad_remainder=pad))
    _assert_examples_equal(got, want)


def test_device_batches_on_cpu_are_tensors():
    ds = TDataset.parallelize([{"x": np.arange(3, dtype=np.int32)}] * 4, 2)
    (b,) = list(tfeed.device_batches(ds, 4, torch.device("cpu")))
    assert b["x"].dtype == torch.int32 and b["x"].shape == (4, 3)


def test_session_on_cpu():
    with Session.builder.master("local[1]").appName("t").config(
            DEVICE_CONF, "cpu").getOrCreate() as spark:
        assert spark.device == torch.device("cpu")
        assert spark.default_parallelism == 1 and spark.num_devices == 1
        assert Session.builder.getOrCreate() is spark
        ds = spark.parallelize(range(5))
        assert ds.num_partitions == 1 and ds.collect() == list(range(5))
    assert Session._active is None


@pytest.mark.parametrize("master,exc,match", [
    ("local[2]", ValueError, "launch the script through"),
    ("yarn", ValueError, "unrecognized master"),
])
def test_session_refuses_what_it_cannot_run(master, exc, match):
    with pytest.raises(exc, match=match):
        Session.builder.master(master).config(DEVICE_CONF, "cpu").getOrCreate()


def test_session_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA error needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session.builder.master("local[1]").getOrCreate()
