"""Host-side data: sources, the text and image pipelines, the worker pool,
the device feed and its prefetch."""

from distributeddeeplearningspark_tpu_torch.data.prefetch import (
    StarvationProbe,
    prefetch_to_device,
)
from distributeddeeplearningspark_tpu_torch.data.workers import (
    WorkerCrashed,
    WorkerMappedDataset,
)

__all__ = ["StarvationProbe", "WorkerCrashed", "WorkerMappedDataset",
           "prefetch_to_device"]
