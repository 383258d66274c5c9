"""Elastic supervisor — gang launch, failure detection, restart-from-checkpoint.

The port's copy of ``distributeddeeplearningspark_tpu/supervisor.py``:
the gang :class:`Supervisor` and, for the MPMD pipeline
(:mod:`.train.pipeline_trainer`), :class:`PipelineSupervisor` with its
one :class:`StagePlan` a stage, which restarts a dead stage alone. A gang that
loses a rank cannot go on (every collective waits on it), so recovery is
job-level:

1. train with frequent checkpoints (:mod:`.checkpoint`),
2. detect a dead or failed worker (a process exit, or no progress when a
   hang never surfaces as an exit),
3. tear the gang down and relaunch it; the workers resume from the newest
   verified checkpoint (their driver scripts call ``Trainer.restore``).

The supervisor launches, watches, kills and relaunches; all state lives
in checkpoints. Its workers get the port's launch contract, as the port's
cli (:mod:`.cli`) gives it: ``DLS_COORDINATOR`` (``127.0.0.1:<free
port>``), ``DLS_NUM_PROCESSES``, ``DLS_PROCESS_ID``, the session conf as
``DLS_CONF_*`` (``--conf``; a caller of :class:`Supervisor` passes them in
``env``), the telemetry workdir, ``PYTHONPATH`` naming
the port's parent and, unless set, ``OMP_NUM_THREADS`` = cores / N; and
beside it ``DLS_RESTART`` (the attempt ordinal, which the fault hooks of
:mod:`.faults` gate on), ``DLS_HOST_ID`` (the original host ordinal, stable
across an elastic shrink) and, with a hang watchdog,
``DLS_HEARTBEAT_FILE``. Each worker starts in a process group of its own,
and a kill takes the group, so a rank's forked input workers go with it.
The supervisor touches no device: the workers take the card unless the
caller's conf (``--conf spark.dls.device=cpu``) asks for the CPU.

It writes the JAX package's ``attempt`` and ``recovery`` telemetry records
into the run's stream, so the JAX package's ``dlstatus`` reads a port
run's timeline unchanged. Run it as::

    python -m distributeddeeplearningspark_tpu_torch.supervisor -n N \
        [--max-restarts K] [--ckpt-dir D] [--progress-path D] \
        [--hang-timeout S] [--shrink-after K] [--conf k=v ...] -- cmd ...
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import socket
import subprocess
import sys
import time

from distributeddeeplearningspark_tpu_torch import faults
from distributeddeeplearningspark_tpu_torch import telemetry as telemetry_lib
from distributeddeeplearningspark_tpu_torch.utils.env import (
    COORDINATOR_ENV,
    NUM_PROCESSES_ENV,
    PROCESS_ID_ENV,
    conf_to_env,
)

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.supervisor")

#: seconds a terminated worker's process group gets before it is killed
TERMINATE_GRACE_S = 5.0
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Sentinel exit code workers use to say "I died restoring the checkpoint,
#: not training" (the port's drivers exit with it when ``Trainer.restore``
#: raises under ``--resume``). A relaunch after this code is doomed to the
#: identical crash unless the checkpoint it restores changes — so the
#: supervisor quarantines the latest step and falls back to the previous one
#: instead of burning ``max_restarts`` on a poisoned checkpoint.
RESTORE_FAILED_EXIT = 13

#: Evidence file a gracefully draining gang leaves in the checkpoint root:
#: ``"<doomed_host> <drained_step>"``. Written by rank 0 of the trainer's
#: preemption drain (``Trainer._graceful_drain``) last, after the live
#: handoff has committed on every rank, and read by
#: :meth:`Supervisor._classify` to tell "the gang exited zero because it
#: DRAINED" from "the gang finished" — without it a graceful preemption
#: would look like success (or, had the drain path exited non-zero, burn a
#: backoff slot as a training-crash).
DRAIN_EVIDENCE = "DRAIN"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def drain_evidence_path(directory: str) -> str:
    return os.path.join(directory, DRAIN_EVIDENCE)


def write_drain_evidence(directory: str, *, host: int, step: int) -> str:
    """Atomically record a graceful drain: the doomed host ordinal and the
    step training completed before handing off. The trainer writes this
    LAST (after the live handoff is fully committed) so its existence
    implies an ingestible handoff."""
    path = drain_evidence_path(directory)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{int(host)} {int(step)}\n")
    os.replace(tmp, path)
    return path


def read_drain_evidence(directory: str) -> tuple[int, int] | None:
    """``(doomed_host, drained_step)`` or None (absent/torn evidence)."""
    try:
        with open(drain_evidence_path(directory)) as f:
            host, step = f.read().split()
        return int(host), int(step)
    except (OSError, ValueError):
        return None


def consume_drain_evidence(directory: str, *, ordinal: int) -> None:
    """Retire the evidence once acted on (kept beside the stream as
    ``DRAIN.consumed-<ordinal>`` for post-incident forensics) so a later
    attempt's clean exit is never misread as another drain."""
    path = drain_evidence_path(directory)
    try:
        os.replace(path, f"{path}.consumed-{ordinal}")
    except OSError:
        pass


def _reap_groups(procs: list[subprocess.Popen]) -> None:
    """SIGKILL whatever is left in each worker's process group and reap
    the workers: an attempt leaves no process behind."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        p.wait()


@dataclasses.dataclass
class Attempt:
    """Outcome of one gang launch."""

    ordinal: int
    returncodes: list[int]
    duration_s: float
    #: Failure class: "clean" | "training-crash" | "restore-failure" | "hang"
    #: | "graceful-shutdown" (see :meth:`Supervisor._classify`). Drives the
    #: restart strategy and gives operators one log line naming WHICH
    #: recovery path fired.
    classification: str = ""
    #: Whether any progress evidence (heartbeat/checkpoint mtime) appeared
    #: during the attempt — the signal separating "crashed at restore" from
    #: "crashed mid-training" when no sentinel exit code arrives.
    made_progress: bool = False
    #: On a "hang": the fleet localization (host/phase/stalled_for_s/...)
    #: from the gang's telemetry streams, when they carry enough evidence
    #: to name a single stalled host (telemetry.fleet.localize_hang).
    culprit: dict | None = None
    #: The ORIGINAL host ordinal this failure points at, when the evidence
    #: names exactly one: the hang culprit's host, or the unique first-
    #: failing process (mapped through the surviving-host list, so the id
    #: stays stable across elastic renumbering). None when ambiguous —
    #: the shrink policy only acts on an unambiguous, repeated verdict.
    dead_host: int | None = None
    #: Gang width of this attempt (shrinks when hosts are dropped).
    num_processes: int = 0

    @property
    def ok(self) -> bool:
        # a graceful drain also exits all-zero — it is a handoff, not a
        # completion, and must not end the run
        return (all(rc == 0 for rc in self.returncodes)
                and self.classification != "graceful-shutdown")


@dataclasses.dataclass
class SupervisorResult:
    attempts: list[Attempt]

    @property
    def ok(self) -> bool:
        return bool(self.attempts) and self.attempts[-1].ok

    @property
    def restarts(self) -> int:
        return max(0, len(self.attempts) - 1)


class Supervisor:
    """Launch ``num_processes`` copies of a worker command as one gang.

    ``argv`` is the worker command (e.g. ``[sys.executable, "train.py",
    "--resume"]``); every process gets the rendezvous env plus its own
    ``DLS_PROCESS_ID``. Any non-zero exit (or death by signal) fails the whole
    attempt: survivors are terminated and, up to ``max_restarts`` times, the
    gang is relaunched on a fresh coordinator port.

    ``poll_interval`` bounds failure-detection latency; ``hang_timeout_s``
    (optional) additionally fails an attempt whose processes are all alive but
    have produced no progress for too long — the hang case NCCL users know as
    the silent stuck all-reduce. Progress is observed as mtime changes under
    ``progress_path`` (typically the checkpoint dir), the same signal a human
    operator would watch.

    **Failure classification & restore fallback.** Each failed attempt is
    classified (``Attempt.classification``): a worker exiting with
    :data:`RESTORE_FAILED_EXIT` — or a gang that dies on a restart attempt
    without ever producing progress evidence while a checkpoint exists — is a
    **restore-failure**: relaunching against the same checkpoint would crash
    identically. On the *explicit sentinel* (and only then — circumstantial
    evidence also fits a crash-right-after-restore and must not destroy a
    healthy step), up to ``max_restore_fallbacks`` times per run, the latest
    step under ``ckpt_dir`` is quarantined to ``<step>.corrupt-N`` before
    the relaunch, forcing the gang onto the previous step. Everything else
    is a **training-crash** (or **hang**), where plain restart-from-latest
    is right.

    **Backoff.** Restart delay grows exponentially from
    ``restart_backoff_s`` (doubling per *consecutive fruitless* attempt,
    capped at ``restart_backoff_max_s``) with ``±backoff_jitter`` relative
    jitter so a fleet of supervisors recovering from a shared-infra blip
    doesn't stampede the storage/coordinator in lockstep. An attempt that
    made observed progress (heartbeat/checkpoint evidence — only when
    progress tracking is configured) resets the ladder: a run that trains
    10k steps and then crashes is a fresh incident, not the next rung of
    its early flaky attempts' 30s max-backoff.

    **Shrink-to-survive (elastic).** With ``shrink_after=K``, once K
    consecutive failed attempts point at the SAME dead host (the hang
    localization's culprit, or the unique first-failing process), the
    supervisor stops relaunching a doomed geometry: it drops that host from
    the gang, recomputes ``DLS_NUM_PROCESSES`` (ranks renumber contiguously;
    each process also gets its stable original ordinal as ``DLS_HOST_ID``),
    and relaunches the survivors from the last checkpoint — a checkpoint
    holds whole tensors, so the survivors restore it at their rank count, a
    sharded state included — and the global batch is preserved (the feed
    splits it over fewer hosts, so the per-host share grows; recorded as
    ``batch_policy`` on the ``geometry_change`` recovery event). The gang
    never shrinks below ``min_processes``.

    **Graceful drain.** A gang told of a preemption (``DLS_FAULT=sigterm@N``
    or a ``DLS_PREEMPT_NOTICE`` file) drains: it commits a live handoff,
    writes the ``DRAIN`` evidence and exits 0. The attempt is classified
    ``graceful-shutdown``; the supervisor retires the evidence (and the
    notice) to ``*.consumed-<ordinal>``, shrinks at once with no repeated
    evidence and no backoff (``geometry_change`` with ``resume=
    "live-handoff"`` at the drained step), and the relaunch resumes from
    the handoff. The relaunch does not drain again: the evidence and the
    notice are gone, and ``sigterm`` fires on attempt 0 only.
    """

    def __init__(
        self,
        argv: list[str],
        *,
        num_processes: int = 1,
        max_restarts: int = 3,
        env: dict[str, str] | None = None,
        poll_interval: float = 0.2,
        restart_backoff_s: float = 0.5,
        restart_backoff_max_s: float = 30.0,
        backoff_jitter: float = 0.25,
        hang_timeout_s: float | None = None,
        progress_path: str | None = None,
        startup_grace_s: float | None = None,
        ckpt_dir: str | None = None,
        fallback_on_restore_failure: bool = True,
        max_restore_fallbacks: int = 1,
        telemetry_dir: str | None = None,
        shrink_after: int | None = None,
        min_processes: int = 1,
    ):
        self.argv = list(argv)
        self.num_processes = num_processes
        # surviving ORIGINAL host ordinals, in launch order: rank i of the
        # next attempt is host self._hosts[i]. Shrinks drop entries; ranks
        # renumber contiguously (a process group wants 0..n-1) while
        # DLS_HOST_ID keeps naming the same machine across attempts.
        self._hosts: list[int] = list(range(num_processes))
        self.shrink_after = shrink_after
        self.min_processes = max(1, min_processes)
        self.max_restarts = max_restarts
        self.env = dict(env or {})
        self.poll_interval = poll_interval
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.hang_timeout_s = hang_timeout_s
        self.progress_path = progress_path
        # checkpoint root for the restore-failure fallback; progress_path is
        # "typically the checkpoint dir", so it doubles as the default
        self.ckpt_dir = ckpt_dir if ckpt_dir is not None else progress_path
        self.fallback_on_restore_failure = fallback_on_restore_failure
        # bound on latest-step quarantines per run: exit-13 can also mean a
        # transient storage error, and unbounded fallback would let a blip
        # lasting max_restarts attempts eat the whole retention window
        self.max_restore_fallbacks = max_restore_fallbacks
        # First-progress latency includes JIT compile + checkpoint_every steps,
        # which can dwarf the steady-state checkpoint cadence — give startup
        # its own (longer) window so a healthy gang isn't killed mid-compile.
        # Default: 5× the hang timeout.
        self.startup_grace_s = (
            startup_grace_s if startup_grace_s is not None
            else (hang_timeout_s * 5.0 if hang_timeout_s is not None else None)
        )
        # Per-process heartbeat files (ADVICE r1: checkpoint-dir mtimes alone
        # can't tell "training between checkpoints" from "spinning"): workers
        # touch DLS_HEARTBEAT_FILE at every metrics lap (Trainer.fit does it
        # automatically), and the stamp below folds those mtimes in.
        self._hb_dir: str | None = None
        if hang_timeout_s is not None:
            import tempfile

            self._hb_dir = tempfile.mkdtemp(prefix="dls_hb_")
        # Telemetry workdir: the supervisor appends attempt lifecycle /
        # classification / backoff records to the SAME per-run stream the
        # workers write (it exports DLS_TELEMETRY_DIR to them), so dlstatus
        # shows one merged timeline. Resolution honors the documented env
        # contract first (an operator-exported DLS_TELEMETRY_DIR — also how
        # `dlsubmit --workdir` hands it down — must not be silently
        # overridden), then falls back to the checkpoint root — the
        # directory an operator already has in hand after an incident.
        self.telemetry_dir = (
            telemetry_dir if telemetry_dir is not None
            else (self.env.get(telemetry_lib.WORKDIR_ENV)
                  or os.environ.get(telemetry_lib.WORKDIR_ENV)
                  or self.ckpt_dir))  # ckpt_dir already fell back to progress_path
        self._tele: telemetry_lib.EventWriter | None = None

    def _telemetry(self) -> telemetry_lib.EventWriter | None:
        if self._tele is None and self.telemetry_dir:
            # host=None: the supervisor describes the gang, it is not a
            # member — its events must stay out of the fleet table (they
            # would otherwise pollute host 0's liveness)
            self._tele = telemetry_lib.EventWriter(
                self.telemetry_dir, process="supervisor", host=None)
        return self._tele

    def _emit_attempt(self, edge: str, ordinal: int, **fields) -> None:
        tele = self._telemetry()
        if tele is not None:
            tele.attempt(edge, ordinal, **fields)

    def _localize_hang(self) -> dict | None:
        """Name the stalled host from the gang's own telemetry streams.

        The watchdog only knows "no progress anywhere"; the per-host
        streams know who went silent FIRST and in what phase — the
        difference between "restart the gang" and "drain host 3". Purely
        best-effort: no telemetry dir, no worker streams, or no clear
        single culprit all degrade to the bare classification.
        """
        if not self.telemetry_dir:
            return None
        try:
            from distributeddeeplearningspark_tpu_torch.telemetry import fleet

            # restrict to the CURRENT gang's ranks: after a shrink the
            # dropped rank's stream is forever silent, and folding it in
            # would make every later hang blame the ghost (its silence
            # always leads) instead of the host actually stuck
            width = len(self._hosts)
            events = [e for e in telemetry_lib.read_events(self.telemetry_dir)
                      if e.get("host") is None or int(e["host"]) < width]
            return fleet.localize_hang(events, now=time.time())
        except Exception:  # noqa: BLE001 — diagnosis must not mask recovery
            logger.debug("hang localization failed", exc_info=True)
            return None

    @staticmethod
    def _culprit_fields(attempt: "Attempt") -> dict:
        """The hang culprit flattened into recovery/attempt event fields."""
        c = attempt.culprit
        if not c:
            return {}
        return {"culprit_host": c.get("host"),
                "culprit_phase": c.get("phase"),
                "stalled_for_s": round(float(c.get("stalled_for_s", 0.0)), 1),
                "others_at_step": c.get("others_at_step"),
                "hang_verdict": c.get("verdict")}

    # -- one gang ------------------------------------------------------------

    def _launch(self, ordinal: int) -> list[subprocess.Popen]:
        port = free_port()
        procs = []
        for pid, host in enumerate(self._hosts):
            env = {
                **os.environ,
                **self.env,
                COORDINATOR_ENV: f"127.0.0.1:{port}",
                NUM_PROCESSES_ENV: str(self.num_processes),
                PROCESS_ID_ENV: str(pid),
                # stable machine identity: ranks renumber after a shrink,
                # hosts do not (faults and operators target hosts)
                "DLS_HOST_ID": str(host),
                "DLS_RESTART": str(ordinal),
            }
            env.setdefault("OMP_NUM_THREADS", str(
                max(1, (os.cpu_count() or 1) // self.num_processes)))
            path = env.get("PYTHONPATH")
            env["PYTHONPATH"] = _PKG_PARENT + (os.pathsep + path if path else "")
            if self._hb_dir is not None:
                env["DLS_HEARTBEAT_FILE"] = os.path.join(
                    self._hb_dir, f"hb_{pid}")
            # unconditional when resolved: telemetry_dir already honored an
            # env-supplied value during resolution, and an EXPLICIT
            # constructor argument must win over a conflicting env entry —
            # the whole point is one merged stream, never two half-streams
            if self.telemetry_dir:
                env[telemetry_lib.WORKDIR_ENV] = self.telemetry_dir
            procs.append(subprocess.Popen(self.argv, env=env,
                                          start_new_session=True))
        logger.info(
            "attempt %d: launched %d worker(s) (coordinator :%d)",
            ordinal, self.num_processes, port,
        )
        return procs

    def _progress_stamp(self) -> float:
        """Newest mtime among heartbeat files, progress_path, and its
        immediate children.

        Deliberately shallow: a step dir appears by atomic rename at commit
        (bumping the parent's mtime), so one level is enough — recursing
        into every step's files each poll would hammer the filesystem.
        """
        latest = 0.0
        for d in (self._hb_dir, self.progress_path):
            if not d or not os.path.exists(d):
                continue
            try:
                with os.scandir(d) as it:
                    latest = max(latest, os.stat(d).st_mtime)
                    for entry in it:
                        try:
                            latest = max(latest, entry.stat().st_mtime)
                        except OSError:
                            pass
            except OSError:
                pass
        return latest

    def _has_checkpoint(self) -> bool:
        """A committed (numeric) step dir exists under ckpt_dir — i.e. the
        relaunch WILL go down the restore path."""
        if not self.ckpt_dir or not os.path.isdir(self.ckpt_dir):
            return False
        from distributeddeeplearningspark_tpu_torch.checkpoint import latest_step_in

        return latest_step_in(self.ckpt_dir) is not None

    def _classify(self, codes: list[int], *, ordinal: int, hang: bool,
                  made_progress: bool) -> str:
        """Name the failure mode so run() can pick the right recovery.

        ``restore-failure`` needs either the explicit sentinel exit code or
        the circumstantial case: on a RESTART attempt (ordinal > 0 — attempt
        0 may legitimately crash pre-progress for non-restore reasons, e.g.
        compile OOM, and must not get a healthy checkpoint quarantined), a
        checkpoint exists to restore yet the gang died before producing any
        progress evidence — the shape of "every relaunch crashes at the same
        restore". Without progress tracking (no progress_path/heartbeats)
        the circumstantial branch stays quiet: ``made_progress`` is then
        reported True to avoid misclassifying.

        ``graceful-shutdown`` is evidence-driven, not code-driven: a drained
        gang exits all-zero (it would read as "clean" — run over) and a
        drain raced by the kill path could exit non-zero (it would read as
        "training-crash" and burn a backoff slot). The DRAIN file the
        trainer writes after committing the live handoff overrides both.
        """
        if self._drain_evidence() is not None:
            return "graceful-shutdown"
        if all(c == 0 for c in codes):
            return "clean"
        if hang:
            return "hang"
        if any(c == RESTORE_FAILED_EXIT for c in codes):
            return "restore-failure"
        if ordinal > 0 and not made_progress and self._has_checkpoint():
            return "restore-failure"
        return "training-crash"

    def _drain_evidence(self) -> tuple[int, int] | None:
        """``(doomed_host, drained_step)`` when a graceful drain left its
        evidence in the checkpoint root; None otherwise."""
        if not self.ckpt_dir:
            return None
        return read_drain_evidence(self.ckpt_dir)

    def _dead_host_from(self, culprit: dict | None,
                        first_failed: list[int] | None) -> int | None:
        """The original host ordinal this failure unambiguously names.

        Rank → host goes through the surviving-host list; a localization
        that names several ranks (or none) yields None — the shrink policy
        must never amputate on a guess."""
        rank: int | None = None
        if culprit and culprit.get("host") is not None:
            rank = int(culprit["host"])
        elif first_failed and len(set(first_failed)) == 1:
            rank = first_failed[0]
        if rank is None or not (0 <= rank < len(self._hosts)):
            return None
        return self._hosts[rank]

    def _run_attempt(self, ordinal: int) -> Attempt:
        t0 = time.monotonic()
        self._emit_attempt("begin", ordinal,
                           num_processes=self.num_processes,
                           hosts=list(self._hosts))
        procs = self._launch(ordinal)
        last_progress = time.monotonic()
        track_progress = self._hb_dir is not None or self.progress_path is not None
        stamp0 = stamp = self._progress_stamp() if track_progress else 0.0
        seen_progress = False
        hang = False

        def finish(codes: list[int],
                   first_failed: list[int] | None = None) -> Attempt:
            progressed = (not track_progress
                          or seen_progress
                          or self._progress_stamp() > stamp0)
            cls = self._classify(codes, ordinal=ordinal, hang=hang,
                                 made_progress=progressed)
            if first_failed is None and cls != "clean":
                first_failed = [i for i, c in enumerate(codes) if c != 0]
            culprit = self._localize_hang() if hang else None
            att = Attempt(ordinal, codes, time.monotonic() - t0,
                          classification=cls, made_progress=progressed,
                          culprit=culprit,
                          dead_host=(None if cls == "clean" else
                                     self._dead_host_from(culprit,
                                                          first_failed)),
                          num_processes=self.num_processes)
            if att.culprit:
                logger.warning("attempt %d hang localized: %s", ordinal,
                               att.culprit.get("verdict"))
            self._emit_attempt("end", ordinal, returncodes=att.returncodes,
                               duration_s=att.duration_s, classification=cls,
                               made_progress=progressed,
                               num_processes=self.num_processes,
                               **({"dead_host": att.dead_host}
                                  if att.dead_host is not None else {}),
                               **self._culprit_fields(att))
            return att

        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes):
                    _reap_groups(procs)
                    return finish([int(c) for c in codes])
                if any(c is not None and c != 0 for c in codes):
                    failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
                    logger.warning(
                        "attempt %d: worker(s) %s failed (codes %s); killing gang",
                        ordinal, failed, [codes[i] for i in failed],
                    )
                    self._kill(procs)
                    return finish([int(p.wait()) for p in procs],
                                  first_failed=failed)
                if self.hang_timeout_s is not None:
                    now_stamp = self._progress_stamp()
                    limit = (self.hang_timeout_s if seen_progress
                             else self.startup_grace_s)
                    if now_stamp > stamp:
                        stamp, last_progress = now_stamp, time.monotonic()
                        seen_progress = True
                    elif time.monotonic() - last_progress > limit:
                        logger.warning(
                            "attempt %d: no progress for %.1fs (%s); killing hung gang",
                            ordinal, limit,
                            "steady state" if seen_progress else "startup grace",
                        )
                        hang = True
                        self._kill(procs)
                        return finish([int(p.wait()) for p in procs])
                elif track_progress and not seen_progress:
                    # no hang watchdog, but classification still wants the
                    # progress bit; sample on the same poll cadence
                    now_stamp = self._progress_stamp()
                    if now_stamp > stamp:
                        stamp = now_stamp
                        seen_progress = True
                time.sleep(self.poll_interval)
        except BaseException:
            self._kill(procs)
            raise

    @staticmethod
    def _kill(procs: list[subprocess.Popen]) -> None:
        """SIGTERM every worker's process group, then SIGKILL what is left
        of it after :data:`TERMINATE_GRACE_S` (a rank's forked input
        workers and kernel builds too, also when the rank itself is
        already gone)."""
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + TERMINATE_GRACE_S
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        _reap_groups(procs)

    # -- the restart loop ----------------------------------------------------

    def _backoff_delay(self, ordinal: int) -> float:
        """Exponential backoff before relaunching after failed attempt
        ``ordinal``: base · 2^ordinal, capped, with relative jitter."""
        delay = min(self.restart_backoff_s * (2.0 ** ordinal),
                    self.restart_backoff_max_s)
        if self.backoff_jitter:
            delay *= 1.0 + random.uniform(-self.backoff_jitter,
                                          self.backoff_jitter)
        return max(0.0, delay)

    def _fallback_to_previous_step(self) -> None:
        """Quarantine the latest checkpoint step so the relaunch restores the
        previous one — the recovery for a verified-but-poisoned checkpoint
        (restore crashes even though the bytes match the manifest)."""
        from distributeddeeplearningspark_tpu_torch.checkpoint import (
            latest_step_in,
            quarantine_step_dir,
        )

        step = latest_step_in(self.ckpt_dir)
        if step is None:
            return
        logger.warning(
            "restore-failure: quarantining checkpoint step %d under %s and "
            "falling back to the previous step", step, self.ckpt_dir)
        quarantine_step_dir(self.ckpt_dir, step)
        tele = self._telemetry()
        if tele is not None:
            tele.recovery(step, "restore-fallback", directory=self.ckpt_dir)

    def _shrink(self, dead_host: int, *, streak: int,
                resume_step: int | None = None,
                resume: str = "checkpoint") -> None:
        """Drop ``dead_host`` from the gang and re-plan onto the survivors.

        The destructive half of elasticity that is NOT destructive to state:
        nothing is quarantined or deleted — the next attempt restores the
        last verified checkpoint (or, after a graceful drain, ingests the live handoff and resumes from
        the CURRENT step — ``resume="live-handoff"``), on a gang one host
        narrower. One ``geometry_change`` recovery record ties the evidence
        (dead host, streak) to the action (new geometry, resume source,
        batch policy) for ``dlstatus`` and the span model."""
        from distributeddeeplearningspark_tpu_torch.checkpoint import latest_step_in

        old_n = self.num_processes
        self._hosts.remove(dead_host)
        self.num_processes = len(self._hosts)
        if resume_step is None:
            resume_step = (latest_step_in(self.ckpt_dir)
                           if self.ckpt_dir else None)
        # advisory for workers that want to log/scale on it; the feed math
        # already preserves the global batch by splitting it n-1 ways
        self.env["DLS_ELASTIC_GEOMETRY"] = f"{old_n}:{self.num_processes}"
        logger.warning(
            "shrink-to-survive: host %d blamed by %d consecutive failed "
            "attempt(s) — re-planning the gang %d -> %d process(es) "
            "(survivors: %s), resuming from %s step %s",
            dead_host, streak, old_n, self.num_processes, self._hosts,
            resume, resume_step)
        tele = self._telemetry()
        if tele is not None:
            tele.recovery(
                resume_step, "geometry_change", dead_host=dead_host,
                evidence_attempts=streak, from_processes=old_n,
                to_processes=self.num_processes, hosts=list(self._hosts),
                batch_policy="preserve_global", resume=resume)

    def run(self) -> SupervisorResult:
        attempts: list[Attempt] = []
        fallbacks = 0
        backoff_ordinal = 0  # consecutive fruitless attempts (not launches)
        streak_host: int | None = None
        streak = 0
        try:
            for ordinal in range(self.max_restarts + 1):
                attempt = self._run_attempt(ordinal)
                attempts.append(attempt)
                if attempt.ok:
                    logger.info(
                        "attempt %d succeeded after %.1fs (%d restart(s) total)",
                        ordinal, attempt.duration_s, ordinal,
                    )
                    return SupervisorResult(attempts)
                if attempt.classification == "graceful-shutdown":
                    # a drain is a handoff, not a failure: shrink NOW on the
                    # evidence (no K-attempt streak — the gang told us who is
                    # leaving), resume from the DRAINED step via the live
                    # handoff, and burn no backoff slot relaunching
                    evidence = self._drain_evidence()
                    host, drain_step = (evidence if evidence
                                        else (attempt.dead_host, None))
                    if self.ckpt_dir:
                        consume_drain_evidence(self.ckpt_dir, ordinal=ordinal)
                    # a scheduler-delivered runtime notice is retired the
                    # same way: the shrunk relaunch must not re-drain on
                    # the stale file (the .consumed-<ordinal> rename keeps
                    # it beside the stream for forensics)
                    faults.consume_preempt_notice(
                        self.env.get(
                            faults.PREEMPT_NOTICE_ENV,
                            os.environ.get(faults.PREEMPT_NOTICE_ENV)),
                        ordinal=ordinal)
                    tele = self._telemetry()
                    if tele is not None:
                        tele.recovery(
                            drain_step, "graceful_shutdown", ordinal=ordinal,
                            dead_host=host, drained=True,
                            returncodes=attempt.returncodes)
                    if ordinal >= self.max_restarts:
                        break  # notice arrived with no relaunch budget left
                    logger.warning(
                        "attempt %d drained gracefully at step %s (host %s "
                        "preempted); shrinking and relaunching from the "
                        "live handoff without backoff",
                        ordinal, drain_step, host)
                    if (host is not None and host in self._hosts
                            and self.num_processes > self.min_processes):
                        self._shrink(host, streak=0, resume_step=drain_step,
                                     resume="live-handoff")
                    streak_host, streak = None, 0
                    backoff_ordinal = 0
                    continue
                if attempt.dead_host is not None and attempt.dead_host == streak_host:
                    streak += 1
                elif attempt.dead_host is not None:
                    streak_host, streak = attempt.dead_host, 1
                else:
                    streak_host, streak = None, 0
                if ordinal < self.max_restarts:
                    logger.warning(
                        "attempt %d failed (codes %s, classified %s); "
                        "restarting from checkpoint",
                        ordinal, attempt.returncodes, attempt.classification,
                    )
                    tele = self._telemetry()
                    if tele is not None:
                        # one recovery record per restart decision: the audit
                        # line tying the fault (classification) to the action
                        # (no step — the supervisor doesn't know it, and a
                        # fake one would mislead the dlstatus timeline)
                        # a hang restart names the culprit host the fleet
                        # data localized — "restart (hang)" alone sends the
                        # operator grepping four hosts' logs
                        # dead_host rides along even without a hang culprit
                        # (a crash names one from the first failing rank) so
                        # the incident timeline can attribute every restart,
                        # not just the localized hangs
                        tele.recovery(
                            None, "restart", ordinal=ordinal,
                            classification=attempt.classification,
                            returncodes=attempt.returncodes,
                            **({"dead_host": attempt.dead_host}
                               if attempt.dead_host is not None else {}),
                            **self._culprit_fields(attempt))
                    # destructive fallback only on the EXPLICIT sentinel: the
                    # circumstantial classification (no progress + checkpoint
                    # present) can also fit a deterministic training crash
                    # right after a successful restore, and quarantining a
                    # healthy step there would throw away real work — it
                    # stays a log label + backoff input only
                    if (RESTORE_FAILED_EXIT in attempt.returncodes
                            and self.fallback_on_restore_failure
                            and self.ckpt_dir):
                        if fallbacks < self.max_restore_fallbacks:
                            fallbacks += 1
                            self._fallback_to_previous_step()
                        else:
                            logger.warning(
                                "restore-failure again but %d fallback "
                                "quarantine(s) already spent — relaunching "
                                "against the same step (a transient storage "
                                "error must not eat the retention window)",
                                fallbacks)
                    track = (self._hb_dir is not None
                             or self.progress_path is not None)
                    if attempt.made_progress and track:
                        # OBSERVED progress (not the no-tracking default):
                        # this crash is a fresh incident — restart from the
                        # base delay, not the flaky-era ceiling
                        backoff_ordinal = 0
                    if (self.shrink_after is not None
                            and streak >= self.shrink_after
                            and streak_host is not None
                            and self.num_processes > self.min_processes):
                        self._shrink(streak_host, streak=streak)
                        streak_host, streak = None, 0
                        # new geometry = new incident: fresh backoff ladder
                        backoff_ordinal = 0
                    delay = self._backoff_delay(backoff_ordinal)
                    backoff_ordinal += 1
                    self._emit_attempt("backoff", ordinal + 1, delay_s=delay)
                    time.sleep(delay)
            logger.error("giving up after %d attempt(s)", len(attempts))
            return SupervisorResult(attempts)
        finally:
            if self._tele is not None:
                self._tele.close()
                # a closed writer drops emits by design; a second run() on
                # this Supervisor must get a fresh one, not a dead one
                self._tele = None
            if self._hb_dir is not None:
                import shutil

                shutil.rmtree(self._hb_dir, ignore_errors=True)


# -- MPMD stage pipelines -----------------------------------------------------


@dataclasses.dataclass
class StagePlan:
    """One pipeline stage's launch recipe: the worker command plus any
    stage-specific env (on cards, its ``CUDA_VISIBLE_DEVICES``: the stage's
    cards, rank r of its gang on the r-th). ``argv=None`` uses the built-in
    env-configured stage worker (``python -m
    distributeddeeplearningspark_tpu_torch.train.pipeline_trainer``).
    """

    argv: list[str] | None = None
    env: dict[str, str] = dataclasses.field(default_factory=dict)

    def command(self) -> list[str]:
        if self.argv is not None:
            return list(self.argv)
        return [sys.executable, "-m",
                "distributeddeeplearningspark_tpu_torch.train.pipeline_trainer"]

    def cards(self) -> int | None:
        """How many cards its ``CUDA_VISIBLE_DEVICES`` lists (None: unset)."""
        visible = self.env.get("CUDA_VISIBLE_DEVICES")
        if visible is None:
            return None
        return len([c for c in visible.split(",") if c.strip()])


@dataclasses.dataclass
class PipelineResult:
    """Per-stage attempt histories for one pipeline run."""

    attempts: dict[int, list[Attempt]]

    @property
    def ok(self) -> bool:
        return bool(self.attempts) and all(
            rows and rows[-1].ok for rows in self.attempts.values())

    def restarts_of(self, stage: int) -> int:
        return max(0, len(self.attempts.get(stage, [])) - 1)


class PipelineSupervisor:
    """Launch and monitor an MPMD stage pipeline: one independent gang of
    processes per stage, each with its OWN env, cards, failure domain and
    checkpoint lineage.

    The gang :class:`Supervisor` restarts the WHOLE gang on any failure —
    right for SPMD, where one lost rank poisons every collective. A
    pipeline of stages fails narrower: stages touch each other only through
    the :mod:`.parallel.mpmd` socket transport, so when a rank of stage *k*
    dies or hangs its peers merely block (re-listening / re-dialing,
    stamping their heartbeats) while THIS supervisor kills stage *k*'s
    whole gang (a surviving rank would wait forever in a collective) and
    relaunches it alone with a bumped per-stage ``DLS_RESTART``; the other
    stages' processes keep running, and the reconnected pipeline agrees on
    the resume step and rolls back to it (``PipelineTransport.sync_step``).
    Every attempt/recovery record carries ``stage=`` and
    ``num_processes=`` so ``dlstatus`` shows which stage burned the
    restarts. Classifications: ``clean``, ``stage-crash``,
    ``restore-failure`` (:data:`RESTORE_FAILED_EXIT`) and ``hang`` (the
    heartbeat watchdog: any rank's stale heartbeat is its stage's hang).

    Stage *k* is a gang of n processes, n the size of its stage mesh
    (``DLS_PIPE_SPEC``'s ``stage_meshes[k]``, else ``mesh``; a ``-1`` axis
    absorbs the cards of the stage's ``CUDA_VISIBLE_DEVICES``, one process
    without them: :func:`.train.pipeline_trainer.stage_processes`), with a
    rendezvous of its own drawn anew at each attempt (a port the dead gang
    held may linger in ``TIME_WAIT``). Topology env exported to every
    process: ``DLS_STAGE_ID``, ``DLS_NUM_STAGES``, ``DLS_PIPE_PORTS`` (JSON
    — port *k* carries the k↔k+1 link, which rank 0 of each stage holds),
    ``DLS_PIPE_AUTHKEY``, plus the gang contract within the stage
    (``DLS_COORDINATOR``, ``DLS_NUM_PROCESSES`` = n, ``DLS_PROCESS_ID`` =
    the rank in the stage), ``DLS_HOST_ID`` = the stage ordinal,
    ``DLS_RESTART`` = the per-stage attempt, ``DLS_TELEMETRY_DIR``,
    ``DLS_HEARTBEAT_FILE`` (one a rank) with a watchdog, ``PYTHONPATH``
    naming the port's parent and ``OMP_NUM_THREADS`` = cores / processes
    unless set. ``DLS_FAULT=die_host@N`` with ``DLS_FAULT_HOST=k``
    therefore targets one stage, and ``DLS_FAULT_RANK=r`` one rank of it.
    Each process starts in a process group of its own, which a kill takes
    whole. The supervisor touches no device: a stage takes the cards it
    sees unless its spec asks for the CPU.
    """

    def __init__(self, stages: list[StagePlan], *, max_restarts: int = 3,
                 poll_interval: float = 0.1, restart_backoff_s: float = 0.2,
                 backoff_jitter: float = 0.25,
                 env: dict[str, str] | None = None,
                 telemetry_dir: str | None = None,
                 wall_timeout_s: float | None = None,
                 hang_timeout_s: float | None = None):
        if len(stages) < 2:
            raise ValueError(f"a pipeline needs >= 2 stages, got {len(stages)}")
        self.stages = list(stages)
        self.num_stages = len(stages)
        self.max_restarts = max_restarts
        self.poll_interval = poll_interval
        self.restart_backoff_s = restart_backoff_s
        self.backoff_jitter = backoff_jitter
        self.env = dict(env or {})
        self.wall_timeout_s = wall_timeout_s
        # per-rank heartbeat watchdog: a stage stamps DLS_HEARTBEAT_FILE in
        # every long phase, so a stage that is alive but wedged
        # (DLS_FAULT=hang) is killed and restarted ALONE — without this, its
        # healthy peers would burn their transport timeouts and restart
        # budgets being blamed for it
        self.hang_timeout_s = hang_timeout_s
        self._hb_dir: str | None = None
        if hang_timeout_s is not None:
            import tempfile

            self._hb_dir = tempfile.mkdtemp(prefix="dls_pipe_hb_")
        from distributeddeeplearningspark_tpu_torch.parallel import mpmd

        specs = []
        for i, plan in enumerate(self.stages):
            raw = (plan.env.get(mpmd.ENV_SPEC) or self.env.get(mpmd.ENV_SPEC)
                   or os.environ.get(mpmd.ENV_SPEC))
            if plan.argv is None and raw is None:
                # the built-in worker's ONE required input; without this
                # check every stage dies on a raw KeyError and the
                # supervisor silently burns max_restarts per stage
                raise ValueError(
                    f"stage {i} uses the built-in pipeline worker but no "
                    f"{mpmd.ENV_SPEC} is set (pass it via env= or the "
                    f"StagePlan's env) — the worker cannot boot without "
                    f"its run spec")
            specs.append(json.loads(raw) if raw else None)
        from distributeddeeplearningspark_tpu_torch.train.pipeline_trainer import (
            stage_processes,
        )

        #: each stage's gang size (its stage mesh's size)
        self.sizes = [1 if spec is None else stage_processes(spec, i, plan.cards())
                      for i, (spec, plan) in enumerate(zip(specs, self.stages))]
        for i, (n, plan) in enumerate(zip(self.sizes, self.stages)):
            cards = plan.cards()
            if cards is not None and cards < n:
                raise ValueError(
                    f"stage {i} is a gang of {n} processes but its "
                    f"CUDA_VISIBLE_DEVICES lists {cards} card(s): two ranks "
                    f"would share a card")
        self.ports = [free_port() for _ in range(self.num_stages - 1)]
        import secrets

        self.authkey = secrets.token_hex(16)
        self.telemetry_dir = (
            telemetry_dir
            or self.env.get(telemetry_lib.WORKDIR_ENV)
            or os.environ.get(telemetry_lib.WORKDIR_ENV))
        self._tele: telemetry_lib.EventWriter | None = None
        self._ordinals = [0] * self.num_stages   # per-stage DLS_RESTART
        self._attempt_seq = 0                    # global telemetry ordinal
        self._launch_t0: list[float] = [0.0] * self.num_stages
        self._launch_wall: list[float] = [0.0] * self.num_stages
        self._attempt_ordinal: list[int] = [0] * self.num_stages
        #: each stage's rendezvous port at its current attempt
        self._rendezvous: list[int | None] = [None] * self.num_stages

    def _telemetry(self) -> telemetry_lib.EventWriter | None:
        if self._tele is None and self.telemetry_dir:
            self._tele = telemetry_lib.EventWriter(
                self.telemetry_dir, process="pipeline-supervisor", host=None)
        return self._tele

    def _stage_env(self, idx: int, rank: int = 0) -> dict[str, str]:
        """The env of rank ``rank`` of stage ``idx``'s gang at its current
        attempt."""
        from distributeddeeplearningspark_tpu_torch.parallel import mpmd

        n = self.sizes[idx]
        env = {
            **os.environ,
            **self.env,
            **self.stages[idx].env,
            mpmd.ENV_STAGE: str(idx),
            mpmd.ENV_NUM_STAGES: str(self.num_stages),
            mpmd.ENV_PORTS: json.dumps(self.ports),
            mpmd.ENV_AUTHKEY: self.authkey,
            PROCESS_ID_ENV: str(rank),
            NUM_PROCESSES_ENV: str(n),
            "DLS_HOST_ID": str(idx),
            "DLS_RESTART": str(self._ordinals[idx]),
        }
        if n > 1:
            env[COORDINATOR_ENV] = f"127.0.0.1:{self._rendezvous[idx]}"
        else:
            env.pop(COORDINATOR_ENV, None)
        env.setdefault("OMP_NUM_THREADS", str(
            max(1, (os.cpu_count() or 1) // sum(self.sizes))))
        path = env.get("PYTHONPATH")
        env["PYTHONPATH"] = _PKG_PARENT + (os.pathsep + path if path else "")
        if self.telemetry_dir:
            env[telemetry_lib.WORKDIR_ENV] = self.telemetry_dir
        if self._hb_dir is not None:
            env["DLS_HEARTBEAT_FILE"] = self._hb_path(idx, rank)
        return env

    def _hb_path(self, idx: int, rank: int = 0) -> str:
        assert self._hb_dir is not None
        return os.path.join(self._hb_dir, f"hb_{idx}_{rank}")

    def _hb_stale(self, idx: int, since: float) -> bool:
        """True when any rank of stage ``idx`` has produced no heartbeat for
        ``hang_timeout_s`` (measured from its launch until the first
        stamp, then from the last stamp)."""
        assert self.hang_timeout_s is not None
        for rank in range(self.sizes[idx]):
            try:
                mtime = os.stat(self._hb_path(idx, rank)).st_mtime
            except OSError:
                mtime = None
            last = since if mtime is None else max(since, mtime)
            if time.time() - last > self.hang_timeout_s:
                return True
        return False

    def _launch_stage(self, idx: int) -> list[subprocess.Popen]:
        n = self.sizes[idx]
        if self._hb_dir is not None:
            # reset the liveness clock: a stale file from the previous
            # attempt must not instantly re-condemn the relaunch
            for rank in range(n):
                try:
                    os.remove(self._hb_path(idx, rank))
                except OSError:
                    pass
        # a fresh rendezvous each attempt: the dead gang's port may linger
        self._rendezvous[idx] = free_port() if n > 1 else None
        gang = [subprocess.Popen(self.stages[idx].command(),
                                 env=self._stage_env(idx, rank),
                                 start_new_session=True)
                for rank in range(n)]
        self._launch_t0[idx] = time.monotonic()
        self._launch_wall[idx] = time.time()
        self._attempt_ordinal[idx] = self._attempt_seq
        tele = self._telemetry()
        if tele is not None:
            tele.attempt("begin", self._attempt_seq, stage=idx,
                         stage_restart=self._ordinals[idx],
                         num_processes=n, pids=[p.pid for p in gang])
        self._attempt_seq += 1
        logger.info("pipeline: launched stage %d (attempt %d, %d process(es), "
                    "pids %s)", idx, self._ordinals[idx], n,
                    [p.pid for p in gang])
        return gang

    def _finish_attempt(self, idx: int, codes: list[int], attempts: dict, *,
                        hang: bool = False) -> Attempt:
        ok = all(rc == 0 for rc in codes)
        cls = ("hang" if hang else
               "clean" if ok else
               "restore-failure" if RESTORE_FAILED_EXIT in codes
               else "stage-crash")
        att = Attempt(self._ordinals[idx], list(codes),
                      time.monotonic() - self._launch_t0[idx],
                      classification=cls, num_processes=self.sizes[idx],
                      dead_host=None if ok and not hang else idx)
        attempts.setdefault(idx, []).append(att)
        tele = self._telemetry()
        if tele is not None:
            tele.attempt("end", self._attempt_ordinal[idx], stage=idx,
                         returncodes=list(codes), classification=cls,
                         duration_s=att.duration_s,
                         num_processes=self.sizes[idx],
                         **({} if ok and not hang else {"dead_host": idx}))
        return att

    @staticmethod
    def _gang_outcome(gang: list[subprocess.Popen]) -> list[int] | None:
        """The gang's return codes once it is over: every rank exited 0, or
        some rank exited non-zero (the others are then killed: a rank that
        survives a dead peer would wait forever in a collective). None
        while it runs."""
        codes = [p.poll() for p in gang]
        if all(rc == 0 for rc in codes):
            return codes
        if not any(rc not in (None, 0) for rc in codes):
            return None
        Supervisor._kill(gang)
        return [p.returncode for p in gang]

    def run(self) -> PipelineResult:
        attempts: dict[int, list[Attempt]] = {}
        gangs: list[list[subprocess.Popen] | None] = [
            self._launch_stage(i) for i in range(self.num_stages)]
        completed = [False] * self.num_stages
        t0 = time.monotonic()
        try:
            while True:
                progressed = False
                for idx, gang in enumerate(gangs):
                    if gang is None:
                        continue
                    codes = self._gang_outcome(gang)
                    hang = False
                    if codes is None:
                        if (self.hang_timeout_s is not None
                                and self._hb_stale(
                                    idx, self._launch_wall[idx])):
                            logger.warning(
                                "pipeline: stage %d heartbeat silent for "
                                ">%.0fs — killing the hung stage's gang "
                                "(peers keep running)", idx, self.hang_timeout_s)
                            hang = True
                            Supervisor._kill(gang)
                            codes = [p.returncode for p in gang]
                        else:
                            continue
                    else:
                        _reap_groups(gang)  # what it forked goes with it
                    progressed = True
                    self._finish_attempt(idx, [int(rc) for rc in codes],
                                         attempts, hang=hang)
                    if all(rc == 0 for rc in codes) and not hang:
                        gangs[idx] = None
                        completed[idx] = True
                        logger.info("pipeline: stage %d completed", idx)
                        continue
                    if self._ordinals[idx] >= self.max_restarts:
                        logger.error(
                            "pipeline: stage %d failed rc=%s with "
                            "max_restarts=%d exhausted — tearing down",
                            idx, codes, self.max_restarts)
                        gangs[idx] = None
                        self._teardown(gangs)
                        return PipelineResult(attempts)
                    delay = min(self.restart_backoff_s
                                * (2.0 ** self._ordinals[idx]), 30.0)
                    if self.backoff_jitter:
                        delay *= 1.0 + random.uniform(-self.backoff_jitter,
                                                      self.backoff_jitter)
                    logger.warning(
                        "pipeline: stage %d died rc=%s — restarting ONLY "
                        "this stage's gang in %.2fs (peers block on the "
                        "transport)", idx, codes, delay)
                    tele = self._telemetry()
                    if tele is not None:
                        tele.recovery(None, "stage-restart", stage=idx,
                                      returncode=next((int(rc) for rc in codes
                                                       if rc != 0), -1),
                                      num_processes=self.sizes[idx],
                                      ordinal=self._ordinals[idx] + 1,
                                      delay_s=round(delay, 3))
                    time.sleep(max(0.0, delay))
                    self._ordinals[idx] += 1
                    gangs[idx] = self._launch_stage(idx)
                if all(completed):
                    return PipelineResult(attempts)
                if (self.wall_timeout_s is not None
                        and time.monotonic() - t0 > self.wall_timeout_s):
                    logger.error("pipeline: wall timeout after %.0fs",
                                 self.wall_timeout_s)
                    self._teardown(gangs)
                    for idx, gang in enumerate(gangs):
                        if gang is not None:
                            self._finish_attempt(idx, [int(p.returncode or -1)
                                                       for p in gang], attempts)
                    return PipelineResult(attempts)
                if not progressed:
                    time.sleep(self.poll_interval)
        except BaseException:
            self._teardown(gangs)
            raise
        finally:
            if self._tele is not None:
                self._tele.close()
                self._tele = None
            if self._hb_dir is not None:
                import shutil

                shutil.rmtree(self._hb_dir, ignore_errors=True)
                self._hb_dir = None

    @staticmethod
    def _teardown(gangs: list) -> None:
        Supervisor._kill([p for gang in gangs if gang is not None for p in gang])


def main(argv: list[str] | None = None) -> int:
    """``python -m distributeddeeplearningspark_tpu_torch.supervisor -n N
    [--max-restarts K] [--conf k=v ...] -- worker_cmd ...``"""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m distributeddeeplearningspark_tpu_torch.supervisor",
        description="Gang-launch a training command with restart-from-checkpoint.",
    )
    p.add_argument("-n", "--num-processes", type=int, default=1)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--hang-timeout", type=float, default=None)
    p.add_argument("--progress-path", default=None,
                   help="dir watched for mtime progress (checkpoint dir)")
    p.add_argument("--restart-backoff", type=float, default=0.5,
                   help="base restart delay (doubles per attempt, jittered)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint root for the restore-failure fallback "
                        "(defaults to --progress-path)")
    p.add_argument("--no-restore-fallback", action="store_true",
                   help="never quarantine the latest step on restore-failure")
    p.add_argument("--shrink-after", type=int, default=None, metavar="K",
                   help="elastic shrink-to-survive: after K consecutive "
                        "failed attempts blaming the SAME dead host, drop "
                        "it from the gang and relaunch the survivors from "
                        "the last checkpoint (default: disabled)")
    p.add_argument("--min-processes", type=int, default=1,
                   help="never shrink the gang below this width")
    p.add_argument("--telemetry-dir", default=None,
                   help="run workdir for the telemetry event stream "
                        "(defaults to --ckpt-dir/--progress-path); inspect "
                        "with the JAX package's `dlstatus <dir>`")
    p.add_argument("--conf", action="append", default=[], metavar="KEY=VALUE",
                   help="session conf handed to every worker as DLS_CONF_* "
                        "(e.g. spark.dls.device=cpu; repeatable)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="worker command (prefix with --)")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("missing worker command")
    conf = {}
    for entry in args.conf:
        if "=" not in entry:
            p.error(f"--conf expects KEY=VALUE, got {entry!r}")
        k, _, v = entry.partition("=")
        conf[k] = v
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    result = Supervisor(
        cmd,
        num_processes=args.num_processes,
        max_restarts=args.max_restarts,
        hang_timeout_s=args.hang_timeout,
        progress_path=args.progress_path,
        restart_backoff_s=args.restart_backoff,
        ckpt_dir=args.ckpt_dir,
        fallback_on_restore_failure=not args.no_restore_fallback,
        telemetry_dir=args.telemetry_dir,
        shrink_after=args.shrink_after,
        min_processes=args.min_processes,
        env=conf_to_env(conf),
    ).run()
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
