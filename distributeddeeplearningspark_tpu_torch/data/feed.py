"""Partition → device feed for one device.

The port of the one-shard case of ``distributeddeeplearningspark_tpu/data/
feed.py``: partitions are host-side iterators of example dicts (numpy);
:func:`host_batches` deals them round-robin, as the JAX feed does for one
data shard, and stacks ``batch_size`` examples into a batch;
:func:`device_batches` moves each batch to the device with a non-blocking
copy from pinned memory. Several shards, several processes and the
prefetch ring are not ported yet (they arrive with data parallelism).
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset


def stack_examples(examples: list[dict[str, Any]]) -> dict[str, np.ndarray]:
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


def host_batches(
    dataset: PartitionedDataset,
    batch_size: int,
    *,
    drop_remainder: bool = True,
    pad_remainder: bool = False,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield stacked host batches, dealing examples from the partitions in
    turn. The short final batch is dropped, or with ``drop_remainder=False``
    yielded; ``pad_remainder`` then marks it with ``eval_mask`` (all 1.0:
    one shard needs no padding rows), as the JAX feed does."""
    stream = _round_robin([dataset.iter_partition(i)
                           for i in range(dataset.num_partitions)])
    while True:
        chunk = list(itertools.islice(stream, batch_size))
        if pad_remainder and chunk and "eval_mask" in chunk[0]:
            raise ValueError(
                "'eval_mask' is reserved for remainder padding — rename the "
                "dataset key or pass pad_remainder=False")
        if len(chunk) < batch_size:
            if chunk and not drop_remainder:
                batch = stack_examples(chunk)
                if pad_remainder:
                    batch["eval_mask"] = np.ones(len(chunk), np.float32)
                yield batch
            return
        yield stack_examples(chunk)


def to_device(batch: dict[str, np.ndarray], device: torch.device
              ) -> dict[str, torch.Tensor]:
    """A host batch on ``device``: on CUDA through pinned memory with a
    non-blocking copy, on the CPU as it is."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def device_batches(dataset: PartitionedDataset, batch_size: int,
                   device: torch.device, **kw) -> Iterator[dict[str, torch.Tensor]]:
    """:func:`host_batches` moved to ``device``."""
    for b in host_batches(dataset, batch_size, **kw):
        yield to_device(b, device)
