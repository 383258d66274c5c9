"""DLRM feature ETL through the distributed shuffle exchange.

The port of ``examples/dlrm_features.py``: a raw click log (string-token
categorical slots, zipf-distributed — user-id-like cardinality) is turned
into trainable DLRM examples without ever materializing a driver-side dict
of the raw token space:

1. **Vocabulary build** — ``flat_map`` every row into ``((slot, token),
   1)`` pairs, ``reduce_by_key`` the counts through the cross-worker
   exchange (``--data-workers`` / ``DLS_DATA_WORKERS``; spills to disk
   under ``DLS_SHUFFLE_MEM_MB``), then keep the top ``--vocab`` tokens per
   slot by (count, token) — the most frequent token gets id 1, id 0 is
   OOV. The top-V selection runs on the card by default
   (:class:`~..data.device_agg.TopV`, ``--topv device``; it raises without
   CUDA unless ``--device cpu``) or in the host heap (``--topv heap``):
   the same vocabulary either way. The summary's ``transports`` key says
   which format and path each stage used.
2. **Negative sampling** — each positive row yields ``1 + --neg-per-pos``
   examples: the clicked row (label 1) and K copies whose item slot is
   re-drawn from the learned item-frequency vocabulary (label 0).
   Deterministic per row index, so the example stream is reproducible at
   any worker count.
3. **Training feed** — the example RDD streams through
   :func:`~..data.feed.host_batches` into ``Trainer.fit`` on a small DLRM
   (embed 16, bottom (64, 16), top (64, 1)) with the dense step
   (``--steps 0`` skips training and only measures the feed).

Run it::

    python -m distributeddeeplearningspark_tpu_torch.examples.dlrm_features \\
        --rows 100000 --data-workers 2            # on the card
    python -m distributeddeeplearningspark_tpu_torch.examples.dlrm_features \\
        --rows 20000 --data-workers 2 --device cpu --topv heap --steps 2

With ``DLS_TELEMETRY_DIR`` set the exchange's events land there and the
summary carries its shuffle block. The summary line is JSON: vocabulary
wall-clock, shuffle stats (with telemetry), feed examples/s and the train
summary.
"""

import argparse
import heapq
import json
import logging
import os
import time

import numpy as np

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset


def synth_clicklog(rows: int, *, num_slots: int, num_dense: int,
                   num_partitions: int, seed: int) -> PartitionedDataset:
    """Raw click log: per row, ``num_slots`` STRING tokens (zipf-ish — a
    long tail of rare tokens), ``num_dense`` floats, and a click label
    correlated with the head tokens so the model has signal to learn. The
    same rows as the JAX example's for the same arguments."""

    def make(pidx: int):
        def gen():
            rng = np.random.default_rng(seed * 997 + pidx)
            n = rows // num_partitions
            for i in range(n):
                toks = rng.zipf(1.3, size=num_slots) - 1
                dense = rng.exponential(2.0, num_dense).astype(np.float32)
                # head tokens click more — learnable signal, zipf tail noise
                score = float(np.mean(1.0 / (1.0 + toks))) * 3.0 - 1.0
                label = np.float32(rng.random() < 1 / (1 + np.exp(-score)))
                yield {
                    "tokens": [f"s{j}:t{t}" for j, t in enumerate(toks)],
                    "dense": dense,
                    "label": label,
                }

        return gen

    return PartitionedDataset([make(p) for p in range(num_partitions)])


def count_tokens(log: PartitionedDataset, *,
                 num_workers: int | None) -> PartitionedDataset:
    """``((slot, token), count)`` through ``reduce_by_key`` — the
    distributed exchange when workers resolve above 0 (``combine="sum"`` is
    declared; the ``(slot, token)`` string keys keep the tuple format)."""
    return log.flat_map(
        lambda r: [((j, t), 1) for j, t in enumerate(r["tokens"])]
    ).reduce_by_key(lambda a, b: a + b, num_workers=num_workers,
                    combine="sum")


def select_vocabs(counts: PartitionedDataset, *, num_slots: int, top_v: int,
                  topv: str = "device", device=None) -> list[list]:
    """The top-``top_v`` tokens of each slot by (count, token), best first:
    on the device (:class:`~..data.device_agg.TopV`, streaming one stable
    sort a block) or in the host heap; both keep the same tie order."""
    if topv not in ("device", "heap"):
        raise ValueError(f"topv={topv!r}: expected 'device' or 'heap'")
    stream = (x for i in range(counts.num_partitions)
              for x in counts.iter_partition(i))
    if topv == "device":
        from distributeddeeplearningspark_tpu_torch.data import device_agg

        block = 65536
        filters = [device_agg.TopV(top_v, block=block, device=device)
                   for _ in range(num_slots)]
        bufs: list[tuple[list, list]] = [([], []) for _ in range(num_slots)]
        for (slot, token), cnt in stream:
            cs, ts = bufs[slot]
            cs.append(cnt)
            ts.append(token)
            if len(cs) >= block:
                filters[slot].update(cs, ts)
                cs.clear()
                ts.clear()
        for slot, (cs, ts) in enumerate(bufs):
            if cs:
                filters[slot].update(cs, ts)
        return [[t for _, t in f.ranked()] for f in filters]
    heaps: list[list] = [[] for _ in range(num_slots)]
    for (slot, token), cnt in stream:
        h = heaps[slot]
        # (count, token) orders ties deterministically; the heap keeps top-V
        item = (cnt, token)
        if len(h) < top_v:
            heapq.heappush(h, item)
        elif item > h[0]:
            heapq.heapreplace(h, item)
    return [[t for _, t in sorted(h, reverse=True)] for h in heaps]


def build_vocabs(log: PartitionedDataset, *, num_slots: int, top_v: int,
                 num_workers: int | None, topv: str = "device", device=None
                 ) -> tuple[list[dict], list[list], str]:
    """Per-slot token→id maps from exchange-reduced counts
    (:func:`count_tokens` then :func:`select_vocabs`). Returns (vocabs,
    item_pools, topv_used): ``vocabs[j][token] -> id`` (1-based; 0 = OOV)
    and the per-slot token list in id order (the negative-sampling pool).
    ``topv="device"`` runs on ``device`` (default: the active session's,
    else the card) and raises where there is none."""
    ranked_all = select_vocabs(count_tokens(log, num_workers=num_workers),
                               num_slots=num_slots, top_v=top_v, topv=topv,
                               device=device)
    vocabs = [{t: i + 1 for i, t in enumerate(ranked)} for ranked in ranked_all]
    return vocabs, ranked_all, topv


def featurize(log: PartitionedDataset, vocabs: list[dict],
              pools: list[list], *, item_slot: int, neg_per_pos: int,
              seed: int) -> PartitionedDataset:
    """Raw rows → DLRM examples with negative sampling.

    Each clicked row emits itself (label 1) plus ``neg_per_pos`` copies
    whose ``item_slot`` token is re-drawn uniformly from that slot's
    vocabulary pool (label 0). The draw is seeded per (partition, row), so
    the stream is deterministic and worker-count independent."""
    pool_ids = np.arange(1, len(pools[item_slot]) + 1, dtype=np.int32)

    def expand(pidx: int, it):
        rng = np.random.default_rng(seed * 31 + pidx)
        for row in it:
            sparse = np.asarray(
                [vocabs[j].get(t, 0) for j, t in enumerate(row["tokens"])],
                np.int32)
            yield {"dense": row["dense"], "sparse": sparse,
                   "label": np.float32(row["label"])}
            for _ in range(neg_per_pos):
                neg = sparse.copy()
                neg[item_slot] = rng.choice(pool_ids)
                yield {"dense": row["dense"], "sparse": neg,
                       "label": np.float32(0.0)}

    return log.map_partitions_with_index(expand)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=100_000,
                   help="raw click-log rows before negative sampling")
    p.add_argument("--slots", type=int, default=8,
                   help="categorical feature slots (slot 0 = item)")
    p.add_argument("--dense", type=int, default=4)
    p.add_argument("--vocab", type=int, default=1000,
                   help="top-V tokens kept per slot (id 0 = OOV)")
    p.add_argument("--neg-per-pos", type=int, default=1)
    p.add_argument("--partitions", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=10,
                   help="DLRM train steps on the assembled feed (0 = "
                        "measure the feed only)")
    p.add_argument("--data-workers", type=int, default=None,
                   help="exchange/shuffle worker processes "
                        "(default: DLS_DATA_WORKERS)")
    p.add_argument("--topv", choices=("device", "heap"), default="device",
                   help="top-V vocabulary selection: the streaming device "
                        "filter (raises without a device) or the host heap")
    p.add_argument("--feed-batches", type=int, default=20,
                   help="batches timed for the feed-rate measurement")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the session's device (spark.dls.device): default "
                        "the card; 'cpu' runs the plain path")
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from distributeddeeplearningspark_tpu_torch import Session, Trainer, telemetry
    from distributeddeeplearningspark_tpu_torch.data.feed import host_batches
    from distributeddeeplearningspark_tpu_torch.models.dlrm import DLRM
    from distributeddeeplearningspark_tpu_torch.train import losses, optim

    wd = os.environ.get("DLS_TELEMETRY_DIR")
    if wd:
        # bind the writer BEFORE the ETL: the vocabulary shuffle runs long
        # before Trainer.fit would configure telemetry
        telemetry.configure(wd)
    builder = Session.builder.appName("dlrm-features")
    if args.device:
        builder = builder.config("spark.dls.device", args.device)
    spark = builder.getOrCreate()

    log = synth_clicklog(
        args.rows, num_slots=args.slots, num_dense=args.dense,
        num_partitions=args.partitions, seed=args.seed).cache()

    t0 = time.perf_counter()
    vocabs, pools, topv_used = build_vocabs(
        log, num_slots=args.slots, top_v=args.vocab,
        num_workers=args.data_workers, topv=args.topv)
    vocab_s = time.perf_counter() - t0

    examples = featurize(
        log, vocabs, pools, item_slot=0, neg_per_pos=args.neg_per_pos,
        seed=args.seed)

    # feed rate: the ETL output through the assembly the trainer consumes
    feed = host_batches(examples.repeat(), args.batch_size)
    first = next(feed)  # includes the warm-up and lazy-open cost
    assert set(first) == {"dense", "sparse", "label"}
    t0 = time.perf_counter()
    seen = 0
    for _ in range(args.feed_batches):
        seen += len(next(feed)["label"])
    feed_rate = seen / (time.perf_counter() - t0)
    feed.close()

    train_summary = None
    if args.steps > 0:
        import torch

        model = DLRM(vocab_sizes=(args.vocab + 1,) * args.slots,
                     embed_dim=16, bottom_mlp=(64, 16), top_mlp=(64, 1),
                     num_dense=args.dense, device=spark.device)
        model.init_weights(torch.Generator(device=spark.device).manual_seed(args.seed))
        trainer = Trainer(spark, model, losses.binary_xent,
                          optim.adamw(1e-3, weight_decay=0.0))
        _, train_summary = trainer.fit(
            examples.repeat(), batch_size=args.batch_size,
            steps=args.steps, log_every=max(1, args.steps // 4))

    shuffle_stats = None
    count_transport = "serial" if not (
        args.data_workers or os.environ.get("DLS_DATA_WORKERS")) else "tuple"
    if wd:
        from distributeddeeplearningspark_tpu_torch import status

        telemetry.reset()  # flush + release before reading back
        shuffle_stats = status.shuffle_from(telemetry.read_events(wd))
        if shuffle_stats:
            # what the exchange actually used for the count stage
            count_transport = shuffle_stats["last"].get(
                "transport", count_transport)
    out = {
        "rows": args.rows,
        "vocab_sizes": [len(v) for v in vocabs],
        "vocab_build_s": round(vocab_s, 2),
        "data_workers": args.data_workers,
        # per-stage data-plane formats: the count shuffle's transport and
        # where the top-V reduce ran
        "transports": {"vocab_counts": count_transport, "topv": topv_used},
        "examples_per_sec": round(feed_rate, 1),
        "neg_per_pos": args.neg_per_pos,
        "shuffle": shuffle_stats and shuffle_stats["last"],
        "train_summary": train_summary,
    }
    print(json.dumps(out, default=str), flush=True)
    spark.stop()
    return out


if __name__ == "__main__":
    main()
