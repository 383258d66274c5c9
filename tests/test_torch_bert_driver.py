"""The port's BERT driver and its text sources against the JAX package's.

- ``text.wikipedia_dump`` yields the JAX package's documents from a
  mediawiki XML dump (``.xml`` and ``.xml.bz2``, redirects skipped,
  wikitext cleaned by ``clean_wikitext``), a wikiextractor tree and plain
  text, at one partition and several; ``token_stats`` and the segment
  framers (``segments_from_docs``, ``packed_segments_from_docs``,
  ``padded_segments_from_docs``) give the JAX package's numbers and
  windows.
- The driver: the JAX ``examples/train_bert.py`` runs as a user runs it (a
  process of its own, ``local[1]``, ``--variant tiny``, 3 steps, its
  telemetry in a workdir) over a corpus file and over an XML dump; the
  port's driver runs through its own functions (``parse_args``,
  ``make_docs``, ``make_tokenizer``, ``make_dataset``, ``make_trainer``)
  from the JAX driver's initial weights (its ``Trainer.init`` on the same
  sample batch, seed 0, carried across by ``bert_io.params_from_flax``).
  Both run with dropout 0 (the packages draw their masks from different
  generators), f32 (tiny's dtype): the logged loss and gradient norm at
  step 3 within 1e-3 relative. And the port's driver through its cli at
  ``local[1]`` on the CPU, with ``--token-stats``: its JSON line."""

import bz2
import json
import os
import subprocess
import sys
from pathlib import Path
from xml.sax.saxutils import escape

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import text as jtext
from distributeddeeplearningspark_tpu.models import bert as jbert
from distributeddeeplearningspark_tpu.rdd import PartitionedDataset as JDataset
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu_torch import Session
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import text as ttext
from distributeddeeplearningspark_tpu_torch.examples import train_bert as tdriver
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.models.bert_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset as TDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from test_torch_deadline import bounded, per_test

ROOT = Path(__file__).resolve().parent.parent
BATCH, SEQ, STEPS, LR, WARMUP = 8, 64, 3, 1e-3, 1
FLAGS = ["--variant", "tiny", "--steps", str(STEPS), "--batch-size", str(BATCH),
         "--seq-len", str(SEQ), "--lr", str(LR), "--warmup", str(WARMUP)]
#: f32 on both sides, the same arithmetic summed in another order
RTOL = 1e-3
#: the JAX driver with dropout 0 in its tiny BERT: run as its own script
JAX_DRIVER = """
import runpy, sys
import distributeddeeplearningspark_tpu.models as models
from distributeddeeplearningspark_tpu.models import bert
models.bert_tiny = lambda **kw: bert.bert_tiny(dropout_rate=0.0, **kw)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _docs(n=60, seed=0) -> list[str]:
    return jtext.synthetic_wikipedia(n, num_partitions=2, seed=seed).collect()


def _wikitext(i: int, doc: str) -> str:
    return (f"{{{{Infobox thing|name=T{i}|{{{{nested|x}}}}}}}}\n"
            f"'''Title {i}''' is a [[Link target|{doc[:30]}]] and [[plain]].\n"
            f"{doc}<ref name=\"a\">a cited source</ref> <!-- note -->\n"
            f"== History ==\n* {doc[30:90]}\n[[Category:Things]]\n"
            f"{{| class=\"wikitable\"\n| a || b\n|}}\n[http://example.org the site]")


def _write_xml(path: Path, docs: list[str], compress: bool = False) -> None:
    pages = []
    for i, doc in enumerate(docs):
        pages.append(f"<page><title>T{i}</title><ns>0</ns><id>{i}</id><revision>"
                     f"<text xml:space=\"preserve\">{escape(_wikitext(i, doc))}</text>"
                     f"</revision></page>")
        if i % 7 == 0:
            pages.append(f"<page><title>R{i}</title><redirect title=\"T{i}\" />"
                         f"<revision><text>#REDIRECT [[T{i}]] and more words "
                         f"than sixty four characters in the body</text></revision></page>")
    xml = ("<mediawiki xmlns=\"http://www.mediawiki.org/xml/export-0.10/\">"
           + "\n".join(pages) + "</mediawiki>")
    if compress:
        path.write_bytes(bz2.compress(xml.encode()))
    else:
        path.write_text(xml)


def _write_wikiextractor(root: Path, docs: list[str]) -> None:
    for j, part in enumerate((docs[: len(docs) // 2], docs[len(docs) // 2:])):
        d = root / ("AA" if j == 0 else "AB")
        d.mkdir(parents=True)
        body = "".join(f"<doc id=\"{i}\" url=\"u\" title=\"T{i}\">\nT{i}\n\n{doc}\n"
                       f"second line of {i}\n</doc>\n" for i, doc in enumerate(part))
        (d / "wiki_00").write_text(body)


def _write_plain(path: Path, docs: list[str]) -> None:
    lines = []
    for i, doc in enumerate(docs):
        if i % 5 == 0:  # a paragraph of short lines, then a blank line
            lines += [doc[k:k + 30] for k in range(0, 90, 30)] + [""]
        else:
            lines.append(doc)
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
@bounded()
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    docs = _docs()
    _write_xml(root / "dump.xml", docs)
    _write_xml(root / "dump.xml.bz2", docs, compress=True)
    _write_wikiextractor(root / "extracted", docs)
    _write_plain(root / "plain.txt", docs)
    (root / "corpus.txt").write_text("\n".join(docs) + "\n")
    return root


@pytest.mark.parametrize("name", ["dump.xml", "dump.xml.bz2", "extracted", "plain.txt"])
@pytest.mark.parametrize("parts", [1, 3])
def test_wikipedia_dump_yields_the_references_documents(corpora, name, parts):
    got = ttext.wikipedia_dump(str(corpora / name), num_partitions=parts)
    want = jtext.wikipedia_dump(str(corpora / name), num_partitions=parts)
    assert got.num_partitions == want.num_partitions == parts
    for i in range(parts):
        assert list(got.iter_partition(i)) == list(want.iter_partition(i))
    docs = got.collect()
    assert len(docs) >= 50 and all(len(d) >= 64 for d in docs)
    if name.startswith("dump"):
        # redirects skipped, markup gone, link labels kept
        assert len(docs) == 60 and not any("REDIRECT" in d for d in docs)
        assert not any(s in d for d in docs for s in ("{{", "[[", "<ref", "'''", "=="))


def test_the_dump_formats_agree(corpora):
    xml = ttext.wikipedia_dump(str(corpora / "dump.xml"), num_partitions=1).collect()
    assert ttext.wikipedia_dump(str(corpora / "dump.xml.bz2"),
                                num_partitions=1).collect() == xml
    with pytest.raises(FileNotFoundError, match="no corpus files"):
        os.makedirs(corpora / "empty", exist_ok=True)
        ttext.wikipedia_dump(str(corpora / "empty"))


def test_clean_wikitext_is_the_references():
    for i, doc in enumerate(_docs(8, seed=4)):
        src = _wikitext(i, doc)
        assert ttext.clean_wikitext(src) == jtext.clean_wikitext(src)
    assert ttext.clean_wikitext("[[a|b]] '''c''' {{x|{{y}}}} <b>d</b>") == "b c d"


def _tokenizer(docs):
    return (ttext.WordPieceTokenizer.train(docs, vocab_size=256),
            jtext.WordPieceTokenizer.train(docs, vocab_size=256))


def test_segment_framers_are_the_references():
    docs = _docs(12, seed=2)
    ttok, jtok = _tokenizer(docs)
    for seq in (16, 48):
        for t, j in ((ttext.segments_from_docs(docs, ttok, seq),
                      jtext.segments_from_docs(docs, jtok, seq)),
                     (ttext.padded_segments_from_docs(docs, ttok, seq),
                      jtext.padded_segments_from_docs(docs, jtok, seq))):
            t, j = list(t), list(j)
            assert len(t) == len(j) > 0
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a, b)
        t = list(ttext.packed_segments_from_docs(docs, ttok, seq))
        j = list(jtext.packed_segments_from_docs(docs, jtok, seq))
        assert len(t) == len(j)
        for (a, sa), (b, sb) in zip(t, j):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("pack", [True, False])
def test_token_stats_are_the_references(pack):
    docs = _docs(24, seed=3)
    ttok, jtok = _tokenizer(docs)
    tds = ttext.mlm_dataset(TDataset.parallelize(docs, 2), ttok, seq_len=48, pack=pack)
    jds = jtext.mlm_dataset(JDataset.parallelize(docs, 2), jtok, seq_len=48, pack=pack,
                            num_workers=0)
    got = ttext.token_stats(tds, max_examples=20)
    assert got == jtext.token_stats(jds, max_examples=20)
    assert got["examples"] == 20 and (got["pad_frac"] > 0.1) is (not pack)
    tlm = ttext.lm_dataset(TDataset.parallelize(docs, 2), ttok, seq_len=40)
    jlm = jtext.lm_dataset(JDataset.parallelize(docs, 2), jtok, seq_len=40,
                           num_workers=0)
    assert ttext.token_stats(tlm) == jtext.token_stats(jlm)


def _step_metrics(workdir):
    return [(e["step"], e["metrics"]) for e in jtele.read_events(str(workdir))
            if e["kind"] == "step_metrics"]


def _jax_init(source: list[str]):
    """The JAX driver's initial weights: its documents, vocabulary, dataset,
    model and optimizer, ``Trainer.init`` on the first batch, as its
    ``fit`` does."""
    spark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    try:
        flag, path = source
        parts = max(spark.default_parallelism, 1)
        if flag == "--data-dir":
            docs = jtext.wikipedia_dump(path, num_partitions=parts)
            sample = docs.take(20000)
        else:
            with open(path) as f:
                lines = [ln.rstrip("\n") for ln in f if ln.strip()]
            docs = JDataset.parallelize(lines, spark.default_parallelism)
            sample = docs.collect()
        tok = jtext.WordPieceTokenizer.train(sample, vocab_size=8192)
        ds = jtext.mlm_dataset(docs, tok, seq_len=SEQ,
                               max_predictions=int(SEQ * 0.15) + 4)
        model = jbert.bert_tiny(vocab_size=tok.vocab_size,
                                max_position=max(SEQ, 128), dropout_rate=0.0)
        tx = joptim.with_grad_clip(
            joptim.adamw(joptim.warmup_linear(LR, WARMUP, STEPS)), 1.0)
        trainer = JTrainer(spark, model, jlosses.masked_lm, tx)
        trainer.init(trainer._sample_batch(ds.repeat(), BATCH))
        return jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
    finally:
        spark.stop()


def _drivers(root: Path, name: str, source: list[str]):
    """(the JAX driver's workdir, the port's) for one source."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT),
           jtele.WORKDIR_ENV: str(root / f"jax-{name}")}
    out = subprocess.run(
        [sys.executable, "-c", JAX_DRIVER, str(ROOT / "examples" / "train_bert.py"),
         "--master", "local[1]", *FLAGS, *source],
        env=env, cwd=root, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    params = _jax_init(source)

    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(tdriver.VARIANTS, "tiny",
                   lambda **kw: tbert.bert_tiny(dropout_rate=0.0, **kw))
        args = tdriver.parse_args([*FLAGS, *source])
        spark = Session.builder.master("local[1]").appName("t").config(
            DEVICE_CONF, "cpu").getOrCreate()
        docs = tdriver.make_docs(args, spark)
        tok = tdriver.make_tokenizer(args, docs)
        trainer = tdriver.make_trainer(args, spark, tok.vocab_size)
        trainer.model.load_state_dict(params_from_flax(params))
        mp.setenv(ttele.WORKDIR_ENV, str(root / f"port-{name}"))
        trainer.fit(tdriver.make_dataset(args, docs, tok).repeat(), batch_size=BATCH,
                    steps=STEPS, tokens_per_example=SEQ, log_every=args.log_every)
        ttele.reset()
        spark.stop()
    finally:
        mp.undo()
    return root / f"jax-{name}", root / f"port-{name}"


@pytest.fixture(scope="module")
@bounded()
def runs(corpora):
    return {"corpus": _drivers(corpora, "corpus", ["--corpus", str(corpora / "corpus.txt")]),
            "dump": _drivers(corpora, "dump", ["--data-dir", str(corpora / "dump.xml")])}


@pytest.mark.parametrize("source", ["corpus", "dump"])
def test_port_driver_logs_the_jax_drivers_loss(runs, source):
    jdir, tdir = runs[source]
    want, got = _step_metrics(jdir), _step_metrics(tdir)
    assert [s for s, _ in got] == [s for s, _ in want] == [STEPS]
    for k in ("loss", "grad_norm", "mlm_accuracy"):
        np.testing.assert_allclose(got[0][1][k], want[0][1][k], rtol=RTOL, err_msg=k)
    assert np.isfinite(got[0][1]["loss"])


def test_driver_through_the_cli_with_token_stats(corpora, tmp_path):
    """The port's driver as a user runs it: through its cli at ``local[1]``
    on the CPU over the XML dump, ``--token-stats`` measured on its windows
    (the JAX package's statistics of the same dataset), its JSON line."""
    script = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_bert.py"
    out = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearningspark_tpu_torch.cli",
         "--master", "local[1]", "--conf", f"{DEVICE_CONF}=cpu", "--workdir",
         str(tmp_path), str(script), *FLAGS, "--data-dir", str(corpora / "dump.xml"),
         "--token-stats", "--log-every", "1"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
        text=True, timeout=200)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith('{"train"')]
    assert len(lines) == 1, out.stdout[-2000:]
    got = lines[0]
    assert got["step"] == STEPS and got["source"] == "dump" and got["device"] == "cpu"
    assert np.isfinite(got["train"]["loss"])
    # no card: the flash kernels' plain path, no launch
    assert got["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    docs = jtext.wikipedia_dump(str(corpora / "dump.xml"), num_partitions=1)
    tok = jtext.WordPieceTokenizer.train(docs.take(20000), vocab_size=8192)
    want = jtext.token_stats(jtext.mlm_dataset(docs, tok, seq_len=SEQ,
                                               max_predictions=int(SEQ * 0.15) + 4,
                                               num_workers=0), max_examples=512)
    assert got["token_stats"] == want and got["vocab_size"] == tok.vocab_size
    losses = [e["metrics"]["loss"] for e in jtele.read_events(str(tmp_path))
              if e["kind"] == "step_metrics"]
    assert len(losses) == STEPS and all(np.isfinite(losses))


def test_driver_takes_the_jax_drivers_flags():
    args = tdriver.parse_args(["--variant", "large", "--max-predictions", "0",
                               "--segment-ids", "--no-pack", "--vocab", "v.txt"])
    assert (args.variant, args.max_predictions, args.segment_ids, args.no_pack,
            args.vocab) == ("large", 0, True, True, "v.txt")
    assert tdriver.parse_args([]).batch_size == 64
    cfg = tbert.bert_tiny(device="cpu").cfg
    assert (cfg.num_layers, cfg.hidden_size, cfg.dtype) == (4, 128, torch.float32)
