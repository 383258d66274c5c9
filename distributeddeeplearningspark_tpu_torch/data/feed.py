"""Partition → device feed: each process's rows of the global batch.

The port of ``distributeddeeplearningspark_tpu/data/feed.py``. Partitions
are host-side iterators of example dicts (numpy); :func:`host_batches`
assembles them into *global* batches of ``batch_size`` rows split over
``num_shards`` data shards, and with ``shard_range=(lo, hi)`` yields only
the rows of shards [lo, hi): rank r of a data-parallel gang takes shard r,
``shard_range=(r, r + 1)`` (:func:`process_shard_range`). Its rows are
exactly the rows the JAX feed gives shard r, in the same order. Two
assembly modes, as in JAX:

- **aligned** (the partition count and the batch divide evenly by the
  shards): partition *i* feeds shard ``i % num_shards``; a finite dataset
  walks every shard's stream in lockstep so every rank agrees where the
  data ends, an infinite one (``repeat()``) opens only its own shards';
- **chained**: the partitions are concatenated into one stream, dealt out
  in order, and each rank keeps its shards' slice.

A tail that cannot fill every shard equally is dropped, or with
``pad_remainder`` padded with copies of its first row carrying ``eval_mask
== 0`` (:func:`_pad_to_shards`), which every contract loss weighs to
nothing. ``num_workers`` fans a pool-backed dataset's per-example map
out over worker processes (:class:`~.workers.WorkerMappedDataset`); the
batches are the same bytes at any count. :func:`to_device` moves a batch
to the device with a non-blocking copy from pinned memory;
:func:`device_batches` does so in the caller's thread, and
:func:`~.prefetch.prefetch_to_device`, which ``Trainer.fit`` feeds
through, in a background thread ahead of the consumer.

Under context parallelism :func:`seq_shard` then keeps one block of each
row's sequence (JAX's ``batch_spec(seq_sharded=True)``: dim 1 of every
leaf of rank ≥ 2 split over ``seq``, rank-1 leaves whole). Next-token
labels cross the blocks' boundaries, so it first makes them from the
whole rows (``NEXT_IDS``, ``NEXT_MASK``), which ``losses.causal_lm``
then reads instead of shifting the block it holds.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset


def process_shard_range(num_shards: int, *, rank: int | None = None,
                        world_size: int | None = None) -> tuple[int, int] | None:
    """This process's data-shard slice [lo, hi), or None for one process.
    ``rank``/``world_size`` default to this process's group's; under tensor
    parallelism the caller passes its coordinate on the batch axes and
    their size (``Mesh.batch_index``, ``Trainer``), so ``tensor`` peers take
    the same shards."""
    pc = collectives.world_size() if world_size is None else world_size
    if pc == 1:
        return None
    if num_shards % pc:
        raise ValueError(
            f"data shards ({num_shards}) must divide evenly across {pc} processes")
    index = collectives.rank() if rank is None else rank
    spp = num_shards // pc
    return index * spp, (index + 1) * spp


def stack_examples(examples: list[dict[str, Any]]) -> dict[str, np.ndarray]:
    """One batch of the examples' arrays. ``np.stack`` copies, also for a
    batch of one: an example of a worker pool may be a view into its
    shared-memory ring, which must not reach torch uncopied."""
    keys = examples[0].keys()
    try:
        return {k: np.stack([np.asarray(e[k]) for e in examples])
                for k in keys}
    except KeyError as e:
        schemas = {tuple(sorted(ex.keys())) for ex in examples}
        raise ValueError(
            f"batch examples disagree on their keys (missing {e}); "
            f"schemas in this batch: {sorted(schemas)} — every example "
            f"dict in a stream must carry the same fields") from e


def _round_robin(iters: list[Iterator]) -> Iterator:
    """Deal elements from iterators in turn; drained ones drop out so uneven
    partitions lose no data."""
    active = list(iters)
    while active:
        still = []
        for it in active:
            try:
                yield next(it)
                still.append(it)
            except StopIteration:
                pass
        active = still


def _pad_to_shards(rest: list[dict[str, Any]], num_shards: int
                   ) -> dict[str, np.ndarray]:
    """Stack a sub-shard remainder padded to a ``num_shards`` multiple with
    copies of row 0; real rows carry ``eval_mask == 1.0``, pad rows 0.0."""
    n = len(rest)
    target = -(-n // num_shards) * num_shards
    batch = stack_examples(rest + [rest[0]] * (target - n))
    if "eval_mask" in batch:
        raise ValueError(
            "'eval_mask' is reserved for remainder padding — rename the "
            "dataset key or pass pad_remainder=False")
    batch["eval_mask"] = (np.arange(target) < n).astype(np.float32)
    return batch


def _slice_shards(batch: dict[str, np.ndarray], num_shards: int,
                  shard_range: tuple[int, int] | None) -> dict[str, np.ndarray]:
    """The rows of shards [lo, hi) of a padded batch."""
    if shard_range is None:
        return batch
    lo, hi = shard_range
    per = batch["eval_mask"].shape[0] // num_shards
    return {k: v[lo * per:hi * per] for k, v in batch.items()}


def host_batches(
    dataset: PartitionedDataset,
    batch_size: int,
    *,
    num_shards: int = 1,
    drop_remainder: bool = True,
    shard_range: tuple[int, int] | None = None,
    pad_remainder: bool = False,
    num_workers: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield stacked host batches from a dataset of example dicts.

    ``batch_size`` is the GLOBAL batch. ``shard_range=(lo, hi)`` keeps the
    rows of data shards [lo, hi) (``batch_size`` must divide by
    ``num_shards``); every process still advances the shard streams of a
    finite dataset in lockstep, so no rank yields a batch its peers do not.
    ``drop_remainder=False`` keeps the tail where it divides evenly over
    the shards (one process: all of it); ``pad_remainder`` pads it instead
    (:func:`_pad_to_shards`), in every mode.

    ``num_workers`` sets the worker-process count of a pool-backed dataset
    (:class:`~.workers.WorkerMappedDataset`, e.g. from
    ``imagenet_train(num_workers=...)``); ``None`` keeps the dataset's own
    (in the end ``DLS_DATA_WORKERS``), 0 maps in this process. The batches
    are byte-identical either way. A dataset with no map stage ignores
    it."""
    if num_workers is not None and hasattr(dataset, "with_num_workers"):
        dataset = dataset.with_num_workers(num_workers)
    n_parts = dataset.num_partitions
    lo, hi = shard_range if shard_range is not None else (0, num_shards)

    def checked(batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        if pad_remainder and "eval_mask" in batch:
            raise ValueError(
                "'eval_mask' is reserved for remainder padding — rename "
                "the dataset key or pass pad_remainder=False")
        return batch

    if shard_range is not None and batch_size % num_shards:
        raise ValueError(
            f"multi-process feed needs batch_size ({batch_size}) divisible by "
            f"num_shards ({num_shards})")
    aligned = n_parts % num_shards == 0 and batch_size % num_shards == 0
    if aligned and n_parts > 1:
        per_shard = batch_size // num_shards
        # an infinite dataset never needs the ranks to agree where it ends:
        # open and walk only this process's shards
        local_only = dataset.is_infinite and shard_range is not None
        streams: list[Iterator | None] = []
        for s in range(num_shards):
            if local_only and not lo <= s < hi:
                streams.append(None)
                continue
            group = [dataset.iter_partition(i) for i in range(s, n_parts, num_shards)]
            streams.append(_round_robin(group) if len(group) > 1 else group[0])
        while True:
            chunks, short = [], False
            for s in streams:
                chunk = [] if s is None else list(itertools.islice(s, per_shard))
                short |= s is not None and len(chunk) < per_shard
                chunks.append(chunk)
            if short:
                rest = [e for chunk in chunks for e in chunk]
                if not drop_remainder and pad_remainder and rest:
                    yield _slice_shards(_pad_to_shards(rest, num_shards),
                                        num_shards, shard_range)
                elif not drop_remainder and shard_range is None:
                    keep = len(rest) - len(rest) % num_shards
                    if keep:
                        yield stack_examples(rest[:keep])
                return
            batch = checked(stack_examples(
                [e for chunk in chunks[lo:hi] for e in chunk]))
            # release the examples before the next refill: a pool's
            # examples are views into its ring, and holding a batch of
            # them across the refill makes the ring carry two batches
            chunks.clear()
            yield batch
    else:
        per_shard = batch_size // num_shards
        stream = itertools.chain.from_iterable(
            dataset.iter_partition(i) for i in range(n_parts))
        while True:
            chunk = list(itertools.islice(stream, batch_size))
            if len(chunk) < batch_size:
                if chunk and not drop_remainder:
                    if pad_remainder:
                        yield _slice_shards(_pad_to_shards(chunk, num_shards),
                                            num_shards, shard_range)
                    elif shard_range is None:
                        yield stack_examples(chunk)
                return
            if shard_range is not None:
                chunk = chunk[lo * per_shard:hi * per_shard]
            batch = checked(stack_examples(chunk))
            chunk.clear()
            yield batch


#: the whole row's next token at each position (0 at the last), and its
#: weight: the shifted ``loss_mask`` (1 without one), 0 at each row's last
#: position, which has no next token
NEXT_IDS, NEXT_MASK = "next_ids", "next_mask"


def seq_shard(batch: dict[str, np.ndarray], index: int, n: int
              ) -> dict[str, np.ndarray]:
    """Block ``index`` of ``n`` of each row's sequence: dim 1 of every leaf
    of rank ≥ 2 sliced, rank-1 leaves (``eval_mask``) whole. A batch with
    ``input_ids`` first gets ``NEXT_IDS`` and ``NEXT_MASK`` from its whole
    rows, the labels JAX's ``causal_lm`` shifts over the whole row: a
    block's last position is labelled by the next block's first token, and
    only the last block drops its final position. The batch itself at
    ``n`` 1. The sequence must divide by ``n``."""
    if n == 1:
        return batch
    out = dict(batch)
    ids = batch.get("input_ids")
    if ids is not None and ids.ndim == 2:
        nxt = np.zeros_like(ids)
        nxt[:, :-1] = ids[:, 1:]
        weight = np.zeros(ids.shape, np.float32)
        mask = batch.get("loss_mask")
        weight[:, :-1] = 1.0 if mask is None else mask[:, 1:]
        out[NEXT_IDS], out[NEXT_MASK] = nxt, weight
    for k, v in out.items():
        if v.ndim < 2:
            continue
        if v.shape[1] % n:
            raise ValueError(f"{k}: sequence length {v.shape[1]} must divide by "
                             f"the seq degree {n}")
        block = v.shape[1] // n
        out[k] = v[:, index * block:(index + 1) * block]
    return out


def to_device(batch: dict[str, np.ndarray], device: torch.device
              ) -> dict[str, torch.Tensor]:
    """A host batch on ``device``: on CUDA through pinned memory with a
    non-blocking copy on the current stream, on the CPU as it is. Under
    :func:`~.prefetch.prefetch_to_device` this runs in the prefetch
    thread, on its copy stream, so the pinning is that thread's work."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_batches(dataset: PartitionedDataset, batch_size: int,
                   device: torch.device, *, probe=None,
                   num_workers: int | None = None,
                   **kw) -> Iterator[dict[str, torch.Tensor]]:
    """:func:`host_batches` moved to ``device`` in the caller's thread,
    with no prefetch. ``probe`` (a :class:`~.prefetch.StarvationProbe`)
    times each host batch's assembly, which here blocks the consumer."""
    hb = host_batches(dataset, batch_size, num_workers=num_workers, **kw)
    if probe is not None:
        hb = probe.timed(hb)
    try:
        for b in hb:
            yield to_device(b, device)
    finally:
        hb.close()
