"""Dataset sources — the port's copy of what the ResNet path reads.

The counterpart of ``distributeddeeplearningspark_tpu/data/sources.py``'s
:func:`synthetic_images`, the same numpy stream per partition, so both
packages yield the same examples from the same seed. The MNIST, Criteo,
ImageNet-folder and record sources arrive with the slices that read them.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset


def synthetic_images(
    num_examples: int,
    *,
    image_size: int = 224,
    num_classes: int = 1000,
    num_partitions: int = 8,
    seed: int = 0,
) -> PartitionedDataset:
    """ImageNet-shaped synthetic images: ``{"image": [S, S, 3] f32 normal
    noise with a weak label signal in the top-left 4×4 corner, "label":
    int32}``, ``num_examples // num_partitions`` per partition, partition
    ``i`` drawn from ``default_rng(seed * 1000 + i)``."""

    def make_partition(pidx: int):
        def gen() -> Iterator[dict]:
            rng = np.random.default_rng(seed * 1000 + pidx)
            n = num_examples // num_partitions
            for _ in range(n):
                label = int(rng.integers(0, num_classes))
                img = rng.normal(0, 1, (image_size, image_size, 3)).astype(np.float32)
                img[:4, :4, :] += (label % 64) / 8.0  # weak label signal
                yield {"image": img, "label": np.int32(label)}

        return gen

    return PartitionedDataset([make_partition(i) for i in range(num_partitions)])
