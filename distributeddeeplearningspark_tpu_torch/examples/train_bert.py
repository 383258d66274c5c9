"""Config-3 training script: BERT MLM pretraining on Wikipedia text.

The port of ``examples/train_bert.py`` (BASELINE.json config 3): documents →
WordPiece tokens → masked windows → BERT → ``Trainer.fit`` with AdamW
under ``warmup_linear``, clipped at a global norm of 1, and ``masked_lm``.
Each executor is a process; launch the gang through the port's cli::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[1] \\
        distributeddeeplearningspark_tpu_torch/examples/train_bert.py \\
        --steps 200 --seq-len 128

(on the CPU, ``--conf spark.dls.device=cpu`` and ``--variant tiny``). The
documents: ``--data-dir`` (a Wikipedia dump: mediawiki ``.xml`` or
``.xml.bz2``, a wikiextractor tree or plain text, through
``text.wikipedia_dump``), ``--corpus`` (a text file, a document a line), or
synthetic Wikipedia-like prose. The vocabulary: ``--vocab``, or 8,192
pieces trained on the corpus (the first 20,000 documents of a dump). The
windows pack documents back to back (``--no-pack``: one padded document a
window), with segment ids under ``--segment-ids``, and the MLM head runs on
at most ``--max-predictions`` gathered positions a window. BERT-base's
attention runs the flash kernels K1 (forward), K2 and K3 (backward) on the
card. ``--token-stats`` measures the windows' padding before training.

Rank 0 prints one JSON line: the train summary, where the run went (world
size, backend, device), the documents' source, the vocabulary's size, the
token statistics and the flash kernels' launches in ``fit``. The JAX
driver's flags are all taken; ``--log-every`` (20, the JAX driver's fixed
value) is the port's own.
"""

import argparse
import json
import logging

from distributeddeeplearningspark_tpu_torch import Session, Trainer, faults
from distributeddeeplearningspark_tpu_torch.data import text as text_lib
from distributeddeeplearningspark_tpu_torch.models import bert
from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.train import losses, optim

VARIANTS = {"base": bert.bert_base, "large": bert.bert_large, "tiny": bert.bert_tiny}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--master", default=None,
                   help="local[N]; default: the launch's, else local[1]")
    p.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=64,
                   help="the global batch, over every rank")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--corpus", default=None,
                   help="text file (one doc per line); synthetic if unset")
    p.add_argument("--data-dir", default=None,
                   help="Wikipedia dump: mediawiki .xml(.bz2), wikiextractor "
                        "tree, or plain-text dir")
    p.add_argument("--vocab", default=None,
                   help="vocab file; trained from the corpus if unset")
    p.add_argument("--max-predictions", type=int, default=-1,
                   help="MLM head on at most this many masked positions a "
                        "window (-1: int(0.15 * seq) + 4; 0: every position)")
    p.add_argument("--segment-ids", action="store_true",
                   help="packed-document segment ids: attention blocked "
                        "across document boundaries")
    p.add_argument("--no-pack", action="store_true",
                   help="one padded document a window instead of packing")
    p.add_argument("--token-stats", action="store_true",
                   help="measure pad_frac/effective_frac over 512 windows "
                        "before training")
    p.add_argument("--log-every", type=int, default=20)
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def make_docs(args: argparse.Namespace, spark: Session) -> PartitionedDataset:
    parts = max(spark.default_parallelism, 1)
    if args.data_dir:
        return text_lib.wikipedia_dump(args.data_dir, num_partitions=parts)
    if args.corpus:
        with open(args.corpus) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        return PartitionedDataset.parallelize(lines, spark.default_parallelism)
    return text_lib.synthetic_wikipedia(2048, num_partitions=parts)


def make_tokenizer(args: argparse.Namespace,
                   docs: PartitionedDataset) -> text_lib.WordPieceTokenizer:
    if args.vocab:
        return text_lib.WordPieceTokenizer.load(args.vocab)
    sample = docs.take(20000) if args.data_dir else docs.collect()
    return text_lib.WordPieceTokenizer.train(sample, vocab_size=8192)


def make_dataset(args: argparse.Namespace, docs: PartitionedDataset,
                 tok: text_lib.WordPieceTokenizer) -> PartitionedDataset:
    max_pred = (int(args.seq_len * 0.15) + 4 if args.max_predictions < 0
                else args.max_predictions or None)
    return text_lib.mlm_dataset(docs, tok, seq_len=args.seq_len,
                                max_predictions=max_pred,
                                segment_ids=args.segment_ids,
                                pack=not args.no_pack)


def make_trainer(args: argparse.Namespace, spark: Session, vocab_size: int) -> Trainer:
    model = VARIANTS[args.variant](vocab_size=vocab_size,
                                   max_position=max(args.seq_len, 128),
                                   device=spark.device, seed=0)
    tx = optim.with_grad_clip(
        optim.adamw(optim.warmup_linear(args.lr, args.warmup, args.steps)), 1.0)
    return Trainer(spark, model, losses.masked_lm, tx)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    faults.die_if_dead_host_on_relaunch()
    builder = Session.builder.appName("bert-mlm")
    if args.master:
        builder = builder.master(args.master)
    spark = builder.getOrCreate()
    print(spark, flush=True)

    docs = make_docs(args, spark)
    tok = make_tokenizer(args, docs)
    ds = make_dataset(args, docs, tok)
    stats = text_lib.token_stats(ds, max_examples=512) if args.token_stats else None
    if stats is not None and spark.rank == 0:
        print(f"input token stats: {stats}", flush=True)
    trainer = make_trainer(args, spark, tok.vocab_size)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [k.launches for k in kernels]
    state, summary = trainer.fit(ds.repeat(), batch_size=args.batch_size,
                                 steps=args.steps, tokens_per_example=args.seq_len,
                                 log_every=args.log_every)
    launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    if spark.rank == 0:
        print(json.dumps({
            "train": summary, "step": state.step, "variant": args.variant,
            "world_size": spark.world_size, "backend": spark.backend,
            "device": str(spark.device),
            "source": ("dump" if args.data_dir else
                       "corpus" if args.corpus else "synthetic"),
            "vocab_size": tok.vocab_size, "token_stats": stats,
            "flash_launches": launches,
        }), flush=True)
    spark.stop()


if __name__ == "__main__":
    main()
