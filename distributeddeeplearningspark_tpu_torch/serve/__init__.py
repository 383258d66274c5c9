"""Serving: the dynamic micro-batching inference engine."""

from distributeddeeplearningspark_tpu_torch.serve.engine import (
    EngineStoppedError,
    InferenceEngine,
    OverloadedError,
    default_buckets,
)

__all__ = ["EngineStoppedError", "InferenceEngine", "OverloadedError",
           "default_buckets"]
