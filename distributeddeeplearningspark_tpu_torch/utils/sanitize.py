"""Training sanitizers: cross-replica desync detection and NaN guards.

The port of ``distributeddeeplearningspark_tpu/utils/sanitize.py``. Two
failure modes get cheap, explicit checks:

- **replica desync**: every rank of a data-parallel gang holds its own copy
  of the params, and they must stay bit-identical; a nondeterministic
  host-side op, a mismatched generator or a corrupted restore makes one
  rank's copy differ and the gang then trains on as several models.
  :func:`assert_replicas_in_sync` compares a per-tensor fingerprint across
  ranks (``Trainer.fit(sanitize_every=N)`` and the ResNet and DLRM
  drivers call it; it is the package's one replica check);
- **numerical blowup**: NaN/Inf losses or gradients (:func:`nonfinite_metrics`,
  :func:`assert_all_finite`, :func:`tree_all_finite`, which the trainer's
  ``on_nonfinite`` policies use).

Fingerprints are computed on the device: per tensor ``[sum, l2, min,
max]`` in float64, stacked into one ``[L, 4]`` tensor, all-gathered across
the gang through :mod:`..parallel.collectives` (NCCL on the card, gloo on
the CPU) and copied to the host once. Under FSDP and tensor parallelism
each leaf is compared within its replica group: a whole leaf across the
gang, a sharded one (a ``DTensor``) across the ranks that hold the same
shard (the same coordinates on the mesh dims it is sharded over: under
HSDP, the ``data`` replicas of one ``fsdp`` shard); shards that differ by
design are never compared. :func:`tree_all_finite` looks at each rank's
shard and agrees across the gang.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch.parallel import collectives, sharding

__all__ = ["DesyncError", "tree_fingerprint", "assert_replicas_in_sync",
           "nonfinite_metrics", "assert_all_finite", "tree_all_finite",
           "enable_nan_checks", "params_checksum"]


class DesyncError(RuntimeError):
    """Replicated state differs across ranks."""


def _leaves(tree: Any) -> list:
    """The tensor and array leaves of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, (torch.Tensor, np.ndarray)) else []


def _shard_key(leaf: Any) -> float:
    """Which shard of ``leaf`` this rank holds, as one number: its
    coordinates on the mesh dims the leaf is sharded over, mixed-radix (0
    for a whole leaf), and for a pipeline stage's param its stage
    (``sharding.pipe_stage``: the stages' params at one place of the tree
    are different layers). Equal keys, equal shards by design."""
    stage = sharding.pipe_stage(leaf)
    key = 0 if stage is None else (stage + 1) * 2**24
    if not sharding.is_sharded(leaf):
        return float(key)
    mesh, coord, shard = leaf.device_mesh, leaf.device_mesh.get_coordinate(), 0
    for i, p in enumerate(leaf.placements):
        if p.is_shard():
            shard = shard * mesh.size(i) + coord[i]
    return float(key + shard)


def _device_fingerprint(tree: Any) -> torch.Tensor:
    """``[L, 4]`` float64 on the leaves' device: per leaf ``[sum, l2, min,
    max]`` (an empty leaf gives zeros), of a sharded leaf this rank's
    shard."""
    rows = []
    for leaf in _leaves(tree):
        x = sharding.local(torch.as_tensor(leaf)).detach().reshape(-1).to(torch.float64)
        if x.numel() == 0:
            rows.append(torch.zeros(4, dtype=torch.float64, device=x.device))
            continue
        rows.append(torch.stack([x.sum(), torch.linalg.vector_norm(x),
                                 x.min(), x.max()]))
    if not rows:
        return torch.zeros((0, 4), dtype=torch.float64)
    return torch.stack(rows)


def tree_fingerprint(tree: Any) -> np.ndarray:
    """Order-stable per-leaf ``[sum, l2, min, max]`` fingerprint, float64,
    computed on the device and copied to the host once."""
    return _device_fingerprint(tree).cpu().numpy()


def assert_replicas_in_sync(tree: Any, *, atol: float = 0.0,
                            what: str = "params") -> None:
    """Raise :class:`DesyncError` if the ranks' copies of ``tree`` differ:
    every rank's fingerprint is all-gathered with the shard each leaf's
    row describes, and each row is compared at ``atol`` with the first
    rank's that holds the same shard (a gang's replicas must be
    bit-identical, so the default is 0). A no-op outside a gang."""
    if collectives.world_size() == 1:
        return
    leaves = _leaves(tree)
    if not leaves:
        return
    fp = _device_fingerprint(leaves)
    keys = torch.tensor([_shard_key(x) for x in leaves], dtype=torch.float64,
                        device=fp.device)
    rows = torch.cat([fp, keys[:, None]], dim=1)
    gathered = collectives.all_gather_rows(rows).cpu().numpy().reshape(
        collectives.world_size(), *rows.shape)
    all_fps, all_keys = gathered[..., :4], gathered[..., 4]
    # each (rank, leaf) against the first rank holding the same shard
    first = np.argmax(all_keys[None, :, :] == all_keys[:, None, :], axis=1)
    ref = np.take_along_axis(all_fps, first[..., None], axis=0)
    with np.errstate(invalid="ignore"):
        worst = np.max(np.abs(all_fps - ref), axis=(1, 2))
    # a NaN that appears on some ranks only is a desync too
    nan_mismatch = np.any(np.isnan(all_fps) != np.isnan(ref), axis=(1, 2))
    bad = [i for i, (w, n) in enumerate(zip(worst, nan_mismatch)) if n or w > atol]
    if bad:
        raise DesyncError(
            f"{what} desynced across ranks {bad} (max fingerprint deviation "
            f"{float(np.nanmax(worst)):.3e} > atol={atol}); replicated "
            f"tensors must be bit-identical on every rank")


def nonfinite_metrics(metrics: dict[str, Any]) -> dict[str, float]:
    """The NaN/Inf entries of a metrics dict (empty when healthy): the
    non-raising primitive the ``skip``/``rollback`` policies observe."""
    return {k: float(v) for k, v in metrics.items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)
            and not np.all(np.isfinite(np.asarray(v)))}


def assert_all_finite(metrics: dict[str, Any], *, step: int | None = None) -> None:
    """Raise FloatingPointError on NaN/Inf metric values (the loss blowup
    guard, ``on_nonfinite="raise"``)."""
    bad = nonfinite_metrics(metrics)
    if bad:
        at = f" at step {step}" if step is not None else ""
        raise FloatingPointError(f"non-finite metrics{at}: {bad}")


def tree_all_finite(tree: Any) -> bool:
    """True iff every floating leaf of ``tree`` is entirely finite — the
    check a rollback runs on a restored state before trusting it (a
    manifest certifies bytes, not numerics: a NaN state checkpoints and
    restores byte-perfectly). One device-side reduction, one host sync;
    with sharded leaves, each rank's shards are checked and the verdict
    all-reduced, so every rank returns the same."""
    leaves = _leaves(tree)
    flags = [torch.isfinite(torch.as_tensor(sharding.local(x))).all().reshape(1)
             for x in leaves if torch.as_tensor(x).is_floating_point()]
    if any(sharding.is_sharded(x) for x in leaves):
        bad = torch.stack([~f for f in flags]).sum().reshape(1).float()
        return not bool(collectives.all_reduce_sum_(bad).item())
    if not flags:
        return True
    by_device: dict[torch.device, list[torch.Tensor]] = {}
    for f in flags:
        by_device.setdefault(f.device, []).append(f)
    return all(bool(torch.cat(fs).all()) for fs in by_device.values())


def enable_nan_checks(enable: bool = True) -> None:
    """Turn on autograd's anomaly detection (the counterpart of jax's
    ``jax_debug_nans``): every backward op that returns NaN raises, naming
    the forward op that made it. Slow; development only."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def params_checksum(params: Any) -> float:
    """One scalar, the sum of every param's absolute values in f32: equal
    on every rank of a synced gang, a cheap step-to-step corruption log
    line."""
    sums = [torch.as_tensor(x).detach().float().abs().sum() for x in _leaves(params)]
    if not sums:
        return 0.0
    return float(torch.stack([s.to(sums[0].device) for s in sums]).sum())
