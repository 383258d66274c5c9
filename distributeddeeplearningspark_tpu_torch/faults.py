"""Deterministic, env-driven fault injection for recovery drills.

The port's copy of ``distributeddeeplearningspark_tpu/faults.py``. A gang
worker hurts *itself* at a declared step, so the same unmodified driver
script can be driven through every failure mode by the supervisor
(:mod:`.supervisor`)::

    DLS_FAULT=crash@15          # SIGKILL self before train step 15
    DLS_FAULT=hang@15           # stop making progress at step 15 (sleep)
    DLS_FAULT=nan@15            # poison the step-15 batch with NaNs
    DLS_FAULT=truncate_ckpt@20  # after the step-20 checkpoint commits,
                                # tear a byte range out of it, then SIGKILL
                                # (the kill-mid-finalize torn write)
    DLS_FAULT=die_host@15       # kill every rank of ONE host at step 15 —
                                # and keep that host dead on every later
                                # attempt (a dead machine stays dead); the
                                # victim is DLS_FAULT_HOST (default 1)
    DLS_FAULT=sigterm@N         # a preemption NOTICE at step N, not a kill:
                                # the trainer drains the step in flight,
                                # gathers the state live
                                # (parallel/live_reshard.py), writes the
                                # digest-verified handoff, then the DRAIN
                                # evidence, and the whole gang exits clean,
                                # so the supervisor shrinks WITHOUT walking
                                # back through the checkpoint. Targets a
                                # host like die_host (DLS_FAULT_HOST,
                                # default 1) but fires on attempt 0 only.
                                # Scoped: get() returns None for it — only
                                # the trainer's drain consults
                                # sigterm_fault()

``die_shuffle_worker`` parses (a spec written for the JAX package is not
malformed here) and :func:`get` scopes it out as the JAX package does;
its consumer, the shuffle exchange's ``shuffle_fault``, waits with the
exchange (ROADMAP Queue 1 item 4).

Beside the env-declared drills lives one *runtime* channel: the
scheduler's preemption notice (``DLS_PREEMPT_NOTICE`` names a file path;
:func:`deliver_preempt_notice` / :func:`read_preempt_notice`). It takes the
``sigterm`` drain's path but is delivered mid-run instead of declared at
launch: the notice carries a step floor, so every rank of a gang drains at
the same step although each reads the file at its own time (the deliverer
stamps it a margin ahead of the gang's last step), and the supervisor
retires it (:func:`consume_preempt_notice`) when it acts on the drain, so
the shrunk relaunch runs clean.

Determinism rules (the JAX package's, unchanged):

- A fault fires on **attempt 0 only** (``DLS_RESTART`` != "0" disables it),
  so a supervisor relaunch runs clean — set ``DLS_FAULT_ALL_ATTEMPTS=1`` to
  keep faulting across restarts (for testing that the supervisor gives up).
  ``die_host`` is the exception: it persists across attempts by default;
  ``DLS_FAULT_ONCE=1`` restores the first-attempt-only discipline.
- In a gang every process sees the same env; ``DLS_FAULT_RANK=k``
  restricts the fault to rank k (``DLS_PROCESS_ID``, the port's launch
  contract). ``die_host`` instead targets by *host identity*
  (``DLS_HOST_ID``, the supervisor-exported original host ordinal, falling
  back to ``DLS_PROCESS_ID``), so after an elastic shrink renumbers the
  ranks the fault keeps naming the same machine. Where a host is a gang
  of processes (an MPMD pipeline stage of several cards,
  :class:`~.supervisor.PipelineSupervisor`), ``DLS_FAULT_RANK`` narrows
  ``die_host`` to one of them; the JAX package's host is one process.
- ``nan`` fires exactly once (the equality-matched step); ``crash``/``hang``
  never return; ``truncate_ckpt`` fires at the first checkpoint boundary at
  or after its step.

:class:`~.train.trainer.Trainer` consults :func:`get` once per ``fit`` and
pays nothing per step when no fault is declared.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time

from distributeddeeplearningspark_tpu_torch.utils.env import PROCESS_ID_ENV

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.faults")

KINDS = ("crash", "hang", "nan", "truncate_ckpt", "die_host",
         "die_shuffle_worker", "sigterm")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declared fault: ``kind`` fires at train step ``step`` (1-based,
    i.e. the step whose completion would set ``state.step == step``)."""

    kind: str
    step: int


def parse(spec: str) -> Fault:
    """Parse ``kind@step`` (raises ValueError on malformed specs — a typo'd
    drill must fail loudly, not run fault-free and "pass")."""
    kind, sep, at = spec.partition("@")
    if not sep or kind not in KINDS:
        raise ValueError(
            f"bad DLS_FAULT {spec!r}: expected one of "
            f"{'|'.join(KINDS)}@<step>")
    try:
        step = int(at)
    except ValueError:
        raise ValueError(f"bad DLS_FAULT step in {spec!r}: {at!r} is not an int")
    if step < 1:
        raise ValueError(f"bad DLS_FAULT step {step}: steps are 1-based")
    return Fault(kind, step)


def fault_host() -> int:
    """The host ordinal a ``die_host`` fault targets (``DLS_FAULT_HOST``,
    default 1 — the first non-coordinating host, so the survivor keeps the
    shared checkpoint dir it already owns). Validated like the spec: a
    typo'd drill must fail loudly."""
    raw = os.environ.get("DLS_FAULT_HOST", "1")
    try:
        host = int(raw)
    except ValueError:
        raise ValueError(
            f"bad DLS_FAULT_HOST {raw!r}: expected a host ordinal (int >= 0)")
    if host < 0:
        raise ValueError(
            f"bad DLS_FAULT_HOST {host}: host ordinals are >= 0")
    return host


def this_host() -> int:
    """This process's host identity: ``DLS_HOST_ID`` (the supervisor's
    original-host ordinal, stable across elastic renumbering) falling back
    to ``DLS_PROCESS_ID`` (one process per host)."""
    return int(os.environ.get("DLS_HOST_ID",
                              os.environ.get(PROCESS_ID_ENV, "0")) or 0)


def die_if_dead_host_on_relaunch() -> None:
    """"A dead host stays dead": when a ``die_host`` fault targets THIS host
    and this is a relaunch attempt (``DLS_RESTART`` > 0), SIGKILL now.
    Drivers call it before building their session, so the dead rank never
    reaches the gang's rendezvous; ``Trainer.fit`` calls it too, for
    drivers that do not. A no-op in every other case."""
    fault = get()
    if (fault is not None and fault.kind == "die_host"
            and int(os.environ.get("DLS_RESTART", "0") or 0) > 0):
        crash()


def get() -> Fault | None:
    """The fault this process should inject, or None (the common case).

    Reads ``DLS_FAULT`` fresh each call and applies the attempt, rank and
    host gating documented above. For ``die_host`` the returned fault is
    already host-gated: ranks of surviving hosts get None."""
    spec = os.environ.get("DLS_FAULT")
    if not spec:
        return None
    fault = parse(spec)
    if fault.kind in ("die_shuffle_worker", "sigterm"):
        # scoped: the shuffle children and the drain path consult their own
        # accessors; a trainer must never act on either as a crash
        return None
    if fault.kind == "die_host":
        if (os.environ.get("DLS_RESTART", "0") != "0"
                and os.environ.get("DLS_FAULT_ONCE") == "1"):
            return None
        return fault if this_host() == fault_host() and _rank_targeted() else None
    if (os.environ.get("DLS_RESTART", "0") != "0"
            and os.environ.get("DLS_FAULT_ALL_ATTEMPTS") != "1"):
        return None
    return fault if _rank_targeted() else None


def _rank_targeted() -> bool:
    """False where ``DLS_FAULT_RANK`` names another rank than this
    process's ``DLS_PROCESS_ID``."""
    rank = os.environ.get("DLS_FAULT_RANK")
    return rank is None or int(os.environ.get(PROCESS_ID_ENV, "0") or 0) == int(rank)


#: Env var carrying the path of a run's preemption-notice file (a
#: scheduler exports it when launching a placed job; unset, the trainer
#: reads no file).
PREEMPT_NOTICE_ENV = "DLS_PREEMPT_NOTICE"


@dataclasses.dataclass(frozen=True)
class PreemptNotice:
    """A delivered preemption notice: drain host ``host`` once training
    reaches step ``step`` (the floor every rank of a gang drains at)."""

    host: int
    step: int


def preempt_notice_path() -> str | None:
    """Where this run's preemption notice would land (None when the run was
    not launched by a scheduler — the common case)."""
    return os.environ.get(PREEMPT_NOTICE_ENV) or None


def deliver_preempt_notice(path: str, *, host: int, step: int) -> str:
    """Deliver a preemption notice atomically (tmp + rename, as the DRAIN
    evidence): a reader sees the whole notice or none."""
    import json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"host": int(host), "step": int(step), "ts": time.time()}, f)
    os.replace(tmp, path)
    logger.warning("preemption notice delivered: drain host %d at step >= %d "
                   "(%s)", host, step, path)
    return path


def read_preempt_notice(path: str | None = None) -> PreemptNotice | None:
    """The pending preemption notice, or None (no env, no file, or a
    malformed or torn file — never raises: the channel is advisory and a
    bad read must not kill a healthy step)."""
    import json

    path = path if path is not None else preempt_notice_path()
    if not path:
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        return PreemptNotice(host=int(doc["host"]), step=int(doc["step"]))
    except (OSError, ValueError, KeyError, TypeError):
        return None


def consume_preempt_notice(path: str | None, *, ordinal: int) -> None:
    """Retire a notice once the drain it asked for was acted on (kept as
    ``<path>.consumed-<ordinal>``), so the relaunch does not re-drain on
    the stale file. A no-op when there is nothing to consume."""
    if not path:
        return
    try:
        os.replace(path, f"{path}.consumed-{ordinal}")
    except OSError:
        pass


def sigterm_fault() -> Fault | None:
    """The graceful-preemption notice this run should honour, or None.

    Scoped like the JAX package's: :func:`get` never returns ``sigterm``.
    ``DLS_FAULT_HOST`` is validated eagerly; fires on attempt 0 only unless
    ``DLS_FAULT_ALL_ATTEMPTS=1``."""
    spec = os.environ.get("DLS_FAULT")
    if not spec:
        return None
    fault = parse(spec)
    if fault.kind != "sigterm":
        return None
    fault_host()
    if (os.environ.get("DLS_RESTART", "0") != "0"
            and os.environ.get("DLS_FAULT_ALL_ATTEMPTS") != "1"):
        return None
    return fault


# -- the injections ----------------------------------------------------------


def crash() -> None:
    """SIGKILL this process — no atexit, no flush, like a host dropping
    off the network."""
    logger.warning("fault injection: SIGKILL self (pid %d)", os.getpid())
    os.kill(os.getpid(), signal.SIGKILL)


def hang(seconds: float = 3600.0) -> None:
    """Stop making progress without exiting — the silent stuck-collective
    shape. The supervisor's hang watchdog is what should end this."""
    logger.warning("fault injection: hanging for %.0fs", seconds)
    time.sleep(seconds)


def nan_batch(batch: dict) -> dict:
    """Poison every floating leaf of the batch (tensors or numpy arrays,
    on whatever device they lie) by multiplying it by NaN; integer leaves
    stay as they are (a torn input record, the transient divergence
    trigger)."""
    import numpy as np
    import torch

    logger.warning("fault injection: NaN batch")

    def poison(x):
        if isinstance(x, torch.Tensor):
            return x * float("nan") if x.is_floating_point() else x
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
            return x * np.nan
        return x

    return {k: poison(v) for k, v in batch.items()}


def truncate_latest_checkpoint(directory: str) -> str | None:
    """Tear the newest committed checkpoint step: truncate its largest data
    file to half. The manifest (already committed, and spared) now
    disagrees with the bytes on disk — the torn write a SIGKILL
    mid-finalize leaves on a non-atomic filesystem. Returns the truncated
    file's path (None if there was nothing to tear)."""
    from distributeddeeplearningspark_tpu_torch.checkpoint import (
        MANIFEST_NAME,
        latest_step_in,
    )

    step = latest_step_in(directory)
    if step is None:
        return None
    step_dir = os.path.join(directory, str(step))
    victim, vsize = None, 0
    for root, _, files in os.walk(step_dir):
        for f in files:
            if f == MANIFEST_NAME:
                continue  # the manifest must survive to tell on the tear
            p = os.path.join(root, f)
            sz = os.path.getsize(p)
            if sz > vsize:
                victim, vsize = p, sz
    if victim is None:
        return None
    with open(victim, "r+b") as fh:
        fh.truncate(max(1, vsize // 2))
    logger.warning("fault injection: truncated %s (%d -> %d bytes)",
                   victim, vsize, max(1, vsize // 2))
    return victim
