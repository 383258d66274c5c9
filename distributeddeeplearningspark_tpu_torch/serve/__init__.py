"""``dlserve`` — the serving subsystem of the port (the JAX package's
``serve``):

- :mod:`.engine` — the dynamic micro-batching engine: concurrent requests
  coalesce up to ``max_batch`` / ``max_wait_ms`` into a fixed ladder of
  batch buckets, admission is a bounded queue with a typed load-shed
  rejection (:class:`~.engine.OverloadedError`);
- :mod:`.generate` — continuous batched decode over
  :mod:`..models.llama_gen`: a fixed set of KV-cache slots, bucketed
  prefill, mid-flight joins, per-token streaming, the paged KV arena;
- :mod:`.kv` — the paged KV arena's allocator and the prefix cache;
- :mod:`.reload` — checkpoint hot reload: verify each new step against
  its integrity manifest, swap the params between batches, keep the old
  params serving when a candidate fails;
- :mod:`.fleet` + :mod:`.router` — N replicas as processes behind a
  queue-depth/p99-aware router with per-tenant budgets, rolling hot
  reload, failover and restart with peer warm-up;
- :mod:`.cli` — ``dlserve`` (``python -m
  distributeddeeplearningspark_tpu_torch.serve.cli``).

Every request leaves a ``request`` telemetry event and its span tree in
the same JSONL stream the training side writes, which ``dlstatus`` reads.
"""

from distributeddeeplearningspark_tpu_torch.serve.engine import (
    EngineStoppedError,
    InferenceEngine,
    OverloadedError,
    default_buckets,
)
from distributeddeeplearningspark_tpu_torch.serve.fleet import (
    LocalReplica,
    ReplicaHandle,
    ServingFleet,
)
from distributeddeeplearningspark_tpu_torch.serve.generate import ContinuousGenerator
from distributeddeeplearningspark_tpu_torch.serve.kv import PagedKVArena, PrefixCache
from distributeddeeplearningspark_tpu_torch.serve.reload import HotReloader
from distributeddeeplearningspark_tpu_torch.serve.router import (
    NoReplicaError,
    ReplicaDiedError,
    Router,
)

__all__ = [
    "InferenceEngine",
    "ContinuousGenerator",
    "HotReloader",
    "OverloadedError",
    "EngineStoppedError",
    "PagedKVArena",
    "PrefixCache",
    "Router",
    "ServingFleet",
    "ReplicaHandle",
    "LocalReplica",
    "NoReplicaError",
    "ReplicaDiedError",
    "default_buckets",
]
