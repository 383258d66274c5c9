"""Config-4 training script: DLRM / Wide&Deep on Criteo, data-parallel over
executors, the embedding table trained row-sparsely.

The port of ``examples/train_dlrm.py`` (BASELINE.json config 4). Each
executor is a process; launch the gang through the port's cli::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_dlrm.py \\
        --steps 3 --batch-size 64 --vocab-size 100 --eval-examples 512

(on the card, drop the ``spark.dls.device`` conf: rank r takes ``cuda:r``).
Run alone, ``python -m distributeddeeplearningspark_tpu_torch.examples.
train_dlrm`` trains on one device. ``synthetic_criteo`` (or
``criteo_tsv`` under ``--data-dir``) → ``DLRM`` or ``WideAndDeep`` →
``Trainer.fit`` with ``binary_xent``, AdamW on the MLPs and row-wise
AdaGrad on the fused table (``sparse_embed_specs``), whose scatter is
kernel K5. At more than one rank each table replica takes the whole global
batch's row update: the step gathers every rank's ids and vector
gradients, and the run ends by checking that the params and ``row_accum``
are the same bytes on every rank.

Then the held-out AUC (config 4's metric): ``predict(output_fn=sigmoid,
with_inputs=True)`` on ``synthetic_criteo(seed=777)`` (or ``--eval-data``),
each rank over its rows, the histograms summed over ranks.

Under the port's supervisor (relaunch from the newest checkpoint when a
rank dies)::

    python -m distributeddeeplearningspark_tpu_torch.supervisor -n 2 \\
        --ckpt-dir WD --progress-path WD -- python \\
        distributeddeeplearningspark_tpu_torch/examples/train_dlrm.py \\
        --steps 3 --batch-size 64 --vocab-size 100 --checkpoint-dir WD --resume

(``--resume`` restores the newest verified step; a restore that raises
exits with the supervisor's ``RESTORE_FAILED_EXIT``).

``--checkpoint-dir``, ``--checkpoint-every`` and ``--resume`` are the
port's (the JAX driver has none): the step's state, the table and its row
accumulators included.

Flags of the JAX driver that the port cannot honour yet fail at parse
time, each naming its ROADMAP item. Rank 0 prints one JSON line: the train
summary, the AUC, where the run went (world size, backend, device), K5's
launches in ``fit`` and the bytes the row merge gathers a step.
"""

import argparse
import json
import logging

import torch

from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer, faults
from distributeddeeplearningspark_tpu_torch.data.sources import (
    criteo_tsv,
    synthetic_criteo,
)
from distributeddeeplearningspark_tpu_torch.examples import (
    add_checkpoint_flags,
    add_not_ported,
    drained,
    resume,
)
from distributeddeeplearningspark_tpu_torch.metrics import auc_from_predictions
from distributeddeeplearningspark_tpu_torch.models.dlrm import (
    DLRM,
    WideAndDeep,
    sparse_embed_specs,
)
from distributeddeeplearningspark_tpu_torch.ops import scatter_rows
from distributeddeeplearningspark_tpu_torch.train import embed, losses, optim
from distributeddeeplearningspark_tpu_torch.utils import sanitize

NOT_PORTED = {
    "--dense-tables": "the dense-table step: ROADMAP Queue 1 item 4",
    "--sql-features": "data/dataframe.py and data/exchange.py: ROADMAP Queue 1 item 4",
}
EXPERT = "the expert-sharded table: ROADMAP Queue 1 item 5"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--master", default=None,
                   help="local[N]; default: the launch's, else local[1]")
    p.add_argument("--model", default="dlrm", choices=["dlrm", "widedeep"])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=256,
                   help="the global batch, over every rank")
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--vocab-size", type=int, default=1000,
                   help="rows per categorical feature")
    p.add_argument("--num-sparse", type=int, default=26)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--expert-shards", type=int, default=1,
                   help="ways to row-shard the table; only 1 is ported")
    p.add_argument("--data-dir", default=None,
                   help="Criteo TSV file or directory of day_* shards; "
                        "synthetic if unset")
    p.add_argument("--eval-data", default=None,
                   help="held-out Criteo TSV (file or dir); synthetic if unset")
    p.add_argument("--eval-examples", type=int, default=100_000,
                   help="cap on eval rows (synthetic eval uses this size)")
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--source-partitions", type=int, default=None,
                   help="partitions of the synthetic source (a multiple of "
                        "the ranks); the global batches are the same at any "
                        "rank count that divides it. Default: the ranks")
    add_checkpoint_flags(p)
    add_not_ported(p, NOT_PORTED)
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.expert_shards != 1:
        p.error(f"--expert-shards {args.expert_shards} is not ported yet ({EXPERT})")
    return args


def make_model(args: argparse.Namespace, device: torch.device):
    vocabs = (args.vocab_size,) * args.num_sparse
    if args.model == "dlrm":
        model = DLRM(vocabs, args.embed_dim, (512, 256, args.embed_dim), device=device)
    else:
        model = WideAndDeep(vocabs, args.embed_dim, device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(0))


def load_criteo(args: argparse.Namespace, spark: Session, path: str):
    return criteo_tsv(path, vocab_sizes=(args.vocab_size,) * args.num_sparse,
                      num_partitions=spark.default_parallelism)


def make_dataset(args: argparse.Namespace, spark: Session):
    if args.data_dir:
        return load_criteo(args, spark, args.data_dir).repeat()
    return synthetic_criteo(args.batch_size * 1024,
                            vocab_sizes=(args.vocab_size,) * args.num_sparse,
                            num_partitions=args.source_partitions
                            or spark.default_parallelism).repeat()


def make_trainer(args: argparse.Namespace, spark: Session,
                 checkpointer: Checkpointer | None = None) -> Trainer:
    model = make_model(args, spark.device)
    return Trainer(spark, model, losses.binary_xent,
                   optim.adamw(args.lr, weight_decay=0.0),
                   sparse_embed=sparse_embed_specs(model, lr=args.lr),
                   checkpointer=checkpointer)


def held_out_auc(args: argparse.Namespace, spark: Session, trainer: Trainer,
                 batch_size: int) -> float:
    """The AUC of the held-out set over every rank: each rank's predictions
    for its own rows (``with_inputs``), at most its share of
    ``--eval-examples``, binned, the bins summed across ranks."""
    if args.eval_data:
        eval_ds = load_criteo(args, spark, args.eval_data)
    else:
        eval_ds = synthetic_criteo(args.eval_examples,
                                   vocab_sizes=(args.vocab_size,) * args.num_sparse,
                                   num_partitions=spark.default_parallelism, seed=777)
    stream = trainer.predict(eval_ds, batch_size=batch_size, with_inputs=True,
                             output_fn=lambda logits: torch.sigmoid(logits.float()))
    return auc_from_predictions(stream,
                                max_examples=args.eval_examples // spark.world_size,
                                device=spark.device)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    faults.die_if_dead_host_on_relaunch()
    builder = Session.builder.appName("dlrm-criteo")
    if args.master:
        builder = builder.master(args.master)
    spark = builder.getOrCreate()
    print(spark, flush=True)

    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    trainer = make_trainer(args, spark, ckpt)
    data_state, restored_step = resume(trainer, ckpt, args.resume)
    start = trainer.state.step if trainer.state is not None else 0
    k5 = scatter_rows.scatter_add_rows.launches
    gathered = embed.make_sparse_embed_train_step.gather_bytes
    state, summary = trainer.fit(make_dataset(args, spark), batch_size=args.batch_size,
                                 steps=args.steps, log_every=args.log_every,
                                 checkpoint_every=args.checkpoint_every if ckpt else None,
                                 data_state=data_state)
    if drained(trainer, ckpt, spark):
        return
    steps = max(state.step - start, 1)
    k5 = scatter_rows.scatter_add_rows.launches - k5
    gathered = embed.make_sparse_embed_train_step.gather_bytes - gathered
    sanitize.assert_replicas_in_sync(
        {**state.params, **{f"{n}.row_accum": s[embed.ROW_ACCUM]
                            for n, s in state.embed_state.items()}},
        what="params and row accumulators")
    auc = held_out_auc(args, spark, trainer, args.batch_size)
    if spark.rank == 0:
        print(json.dumps({
            "train": summary, "eval_auc": auc, "step": state.step,
            "restored_step": restored_step,
            "model": args.model, "world_size": spark.world_size,
            "backend": spark.backend, "device": str(spark.device),
            "k5_launches": k5, "k5_launches_per_step": k5 / steps,
            "merge_bytes_per_step": gathered / steps,
            "replicas_checked": spark.world_size > 1,
        }), flush=True)
    if ckpt:
        ckpt.close()
    spark.stop()


if __name__ == "__main__":
    main()
