"""Host-side data: sources, the text and image pipelines, the DataFrame
plane and its shuffle exchange, the worker pool, the device feed and its
prefetch."""

from distributeddeeplearningspark_tpu_torch.data.dataframe import (
    Column,
    DataFrame,
    DataFrameReader,
    GroupedData,
    col,
    from_dataset,
    from_rows,
    hash_bucket,
    lit,
    log1p,
    read_csv,
    read_parquet,
    when,
)
from distributeddeeplearningspark_tpu_torch.data.prefetch import (
    StarvationProbe,
    prefetch_to_device,
)
from distributeddeeplearningspark_tpu_torch.data.workers import (
    WorkerCrashed,
    WorkerMappedDataset,
)

__all__ = ["Column", "DataFrame", "DataFrameReader", "GroupedData",
           "StarvationProbe", "WorkerCrashed", "WorkerMappedDataset", "col",
           "from_dataset", "from_rows", "hash_bucket", "lit", "log1p",
           "prefetch_to_device", "read_csv", "read_parquet", "when"]
