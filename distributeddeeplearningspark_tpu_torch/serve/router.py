"""Request router — queue-depth/latency-aware dispatch over engine
replicas; the port's copy of ``distributeddeeplearningspark_tpu/serve/
router.py`` (no device code: the same policies).

One :class:`~.engine.InferenceEngine` is one process on one host; "heavy
traffic from millions of users" is N of them behind a dispatcher. The
router is deliberately thin — replicas already own batching, admission,
and telemetry — and adds exactly three policies:

- **Placement by least expected wait.** Each request goes to the live,
  non-draining replica minimizing ``(outstanding + 1) × recent_p99`` —
  outstanding counts requests this router dispatched and not yet resolved
  (its own queue-depth view, no stats round-trip on the hot path), and
  recent p99 is folded from the last ``p99_window`` completions. A replica
  that slows down (compile stall, noisy neighbor, dying host) organically
  sheds load to its peers *before* any health check fires.
- **Per-tenant load-shed budgets.** Global admission control (each
  replica's ``max_queue``) cannot stop one tenant from starving the rest.
  Each tenant gets an outstanding-request budget (``tenant_budgets`` /
  ``default_tenant_budget``); beyond it the router sheds with the same
  typed :class:`~.engine.OverloadedError` contract the engine uses, and
  emits a ``request`` telemetry event (``outcome="shed"``, with the
  tenant) so ``dlstatus`` accounting stays exact.
- **Routing around failure.** A replica whose transport dies mid-request
  fails over: the request is re-dispatched once to the surviving replicas
  (inference is idempotent — retrying cannot double-apply anything), and
  the dead replica stops being a candidate until the fleet restarts it.

Draining (``drain``/``undrain``) is the rolling-hot-reload primitive
(:meth:`~.fleet.ServingFleet.rolling_reload`): a draining replica gets no
new requests but keeps its in-flight ones, so a fleet of N reloads one at
a time with N−1 always serving.

Replica handles only need the small protocol of
:class:`~.fleet.LocalReplica` / :class:`~.fleet.ReplicaHandle`:
``submit(payload, op) -> Future``, ``alive``, ``name``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.serve.engine import OverloadedError
from distributeddeeplearningspark_tpu_torch.telemetry import trace as trace_lib
from distributeddeeplearningspark_tpu_torch.telemetry.fleet import _percentile

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.serve")


class NoReplicaError(RuntimeError):
    """No live, non-draining replica to dispatch to."""


class ReplicaDiedError(RuntimeError):
    """The replica's process/transport died with this request in flight.

    The router retries such requests on a surviving replica; this escapes
    to the caller only when every candidate died."""


class Router:
    """Dispatch requests across replicas; see the module docstring.

    Parameters
    ----------
    replicas:
        Handles implementing ``submit(payload, op) -> Future`` / ``alive``
        / ``name`` — in-process :class:`~.fleet.LocalReplica` adapters or
        :class:`~.fleet.ReplicaHandle` process clients, freely mixed.
    default_tenant_budget:
        Max outstanding requests per tenant (None = unlimited). Overridden
        per tenant by ``tenant_budgets``.
    p99_window:
        Completions per replica folded into the recent-p99 estimate.
    workdir:
        Emit ``request`` shed events for tenant-budget rejections into this
        run directory (replica-side outcomes are emitted by the replicas
        themselves — the router never double-counts them). The router
        writes as a dedicated non-host process (``events-router.jsonl``,
        ``host=None``) so its stream never collides with replica 0's and
        stays out of the host table, like the supervisor's.
    """

    def __init__(
        self,
        replicas: list,
        *,
        default_tenant_budget: int | None = None,
        tenant_budgets: dict[str, int] | None = None,
        p99_window: int = 128,
        workdir: str | None = None,
        name: str = "router",
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.name = name
        self._replicas: dict[str, Any] = {r.name: r for r in replicas}
        if len(self._replicas) != len(replicas):
            raise ValueError("replica names must be unique")
        self.default_tenant_budget = default_tenant_budget
        self.tenant_budgets = dict(tenant_budgets or {})
        self.p99_window = int(p99_window)
        self._tele = (telemetry.EventWriter(workdir, process=name, host=None)
                      if workdir else None)
        self._lock = threading.Lock()
        self._outstanding: dict[str, int] = {n: 0 for n in self._replicas}
        self._lat: dict[str, deque] = {
            n: deque(maxlen=self.p99_window) for n in self._replicas}
        self._draining: set[str] = set()
        self._rid = 0
        self._stats = {"dispatched": 0, "completed": 0, "shed_tenant": 0,
                       "failovers": 0, "errors": 0}
        self._dispatched_to: dict[str, int] = {n: 0 for n in self._replicas}
        self._tenant_out: dict[str, int] = {}

    # -- replica set ---------------------------------------------------------

    def replace(self, replica) -> None:
        """Swap in a (re)started replica under an existing name — the
        fleet's restart path. Outstanding counts reset (the old process's
        in-flight work died with it and was failed over already)."""
        with self._lock:
            self._replicas[replica.name] = replica
            self._outstanding[replica.name] = 0
            self._lat.setdefault(replica.name,
                                 deque(maxlen=self.p99_window))
            self._dispatched_to.setdefault(replica.name, 0)

    def drain(self, name: str) -> None:
        """Stop dispatching to ``name`` (in-flight requests unaffected)."""
        with self._lock:
            if name not in self._replicas:
                raise KeyError(name)
            if len(self._candidates_locked()) <= 1 \
                    and name not in self._draining:
                raise RuntimeError(
                    f"draining {name!r} would leave zero serving replicas")
            self._draining.add(name)

    def undrain(self, name: str) -> None:
        with self._lock:
            self._draining.discard(name)

    def inflight(self, name: str) -> int:
        """Requests dispatched to ``name`` and not yet resolved."""
        with self._lock:
            return self._outstanding.get(name, 0)

    def _candidates_locked(self) -> list[str]:
        return [n for n, r in self._replicas.items()
                if r.alive and n not in self._draining]

    # -- placement -----------------------------------------------------------

    def _recent_p99_locked(self, name: str) -> float:
        lat = self._lat[name]
        if not lat:
            return 1e-3  # optimistic prior: a cold replica attracts load
        return _percentile(sorted(lat), 0.99)

    def _pick(self, exclude: set[str]) -> str:
        with self._lock:
            cands = [n for n in self._candidates_locked()
                     if n not in exclude]
            if not cands:
                raise NoReplicaError(
                    f"no live replica (draining={sorted(self._draining)}, "
                    f"excluded={sorted(exclude)})")
            # least expected wait: queue depth × per-request latency
            name = min(cands, key=lambda n: (
                (self._outstanding[n] + 1) * self._recent_p99_locked(n)))
            self._outstanding[name] += 1
            self._dispatched_to[name] += 1
            self._stats["dispatched"] += 1
            return name

    # -- dispatch ------------------------------------------------------------

    def submit(self, payload: dict[str, Any], *, op: str = "infer",
               tenant: str = "default") -> Future:
        """Route one request; Future resolves to the replica's result.

        ``op`` is the replica-side operation (``"infer"`` for engine
        replicas, ``"generate"`` for continuous-decode replicas); payload
        fields are the op's kwargs. Raises :class:`~.engine.OverloadedError`
        when the tenant's budget is spent (the typed shed contract) and
        :class:`NoReplicaError` when nothing can serve.

        With a workdir bound the router is the **trace root**: it mints
        the request's ``trace_id``, stamps the trace context
        (``{"trace_id", "parent_id"}``) into the payload so the replica's
        stage spans join the same tree across the socket, and at
        resolution emits the root ``request`` span (tenant/outcome/hops)
        plus its own ``place``/``failover`` children. Tenant-budget sheds
        are rejected before any dispatch and carry no trace — their
        evidence is the ``request`` event."""
        budget = self.tenant_budgets.get(tenant, self.default_tenant_budget)
        with self._lock:
            out = self._tenant_out.get(tenant, 0)
            if budget is not None and out >= budget:
                self._stats["shed_tenant"] += 1
                if self._tele is not None:
                    self._tele.emit("request", engine=self.name,
                                    outcome="shed", tenant=tenant,
                                    queue_depth=out)
                raise OverloadedError(out, budget)
            self._tenant_out[tenant] = out + 1
            self._rid += 1
        fut: Future = Future()
        t0 = time.monotonic()
        ctx = None
        if self._tele is not None:
            ctx = {"buf": trace_lib.SpanBuffer(),
                   "root_sid": trace_lib.new_span_id(),
                   "ts0": time.time(), "hops": 0, "tenant": tenant,
                   "done": False}
        try:
            self._dispatch(payload, op, tenant, t0, fut, set(), ctx)
        except BaseException as e:
            with self._lock:
                self._tenant_out[tenant] -= 1
            self._finish_trace(ctx, "error", error=f"{type(e).__name__}: {e}")
            raise
        return fut

    def _finish_trace(self, ctx, outcome: str, error: str | None = None,
                      end_ts: float | None = None) -> None:
        """Close the request's root span and flush the router's whole
        span buffer (root + place/failover children) in ONE emit_many.
        ``end_ts`` lets the caller share ONE timestamp between the last
        stage span and the root's close — two adjacent ``time.time()``
        calls can drift ms apart under GIL contention, and that drift
        would read as unexplained latency in the anatomy's coverage."""
        if ctx is None or ctx["done"] or self._tele is None:
            return
        ctx["done"] = True
        buf = ctx["buf"]
        buf.add("request", ctx["ts0"],
                time.time() if end_ts is None else end_ts,
                span_id=ctx["root_sid"], engine=self.name,
                tenant=ctx["tenant"], outcome=outcome, hops=ctx["hops"],
                **({"error": error} if error else {}))
        buf.flush(self._tele)

    def _dispatch(self, payload, op, tenant, t0, fut: Future,
                  tried: set[str], ctx=None) -> None:
        tp0 = time.time() if ctx is not None else 0.0
        name = self._pick(tried)
        if ctx is not None:
            # t0 = when the ROUTER accepted the request: the replica's
            # queue span starts there, so socket transit + dispatch
            # bookkeeping are accounted as queueing, not lost coverage
            payload = {**payload,
                       "trace": {**ctx["buf"].context(ctx["root_sid"]),
                                 "t0": ctx["ts0"]}}
        try:
            inner = self._replicas[name].submit(payload, op)
        except Exception as e:  # noqa: BLE001 — a handle that can't even
            # accept the request counts as a dead dispatch: fail over
            self._settle(name, None, t0)
            self._failover(payload, op, tenant, t0, fut, tried | {name}, e,
                           ctx, failed=name)
            return
        if ctx is not None:
            ctx["buf"].add("place", tp0, time.time(),
                           parent_id=ctx["root_sid"], replica=name)
        inner.add_done_callback(
            lambda f: self._on_done(f, name, payload, op, tenant, t0, fut,
                                    tried, ctx))

    def _failover(self, payload, op, tenant, t0, fut, tried, exc,
                  ctx=None, failed: str | None = None) -> None:
        with self._lock:
            self._stats["failovers"] += 1
        if ctx is not None:
            ctx["hops"] += 1
            now = time.time()
            # a point span marking the hop: the re-dispatch's own `place`
            # child carries where the request went next
            ctx["buf"].add("failover", now, now, parent_id=ctx["root_sid"],
                           from_replica=failed,
                           error=f"{type(exc).__name__}: {exc}")
        logger.warning("router: replica failed mid-request (%s); "
                       "failing over", exc)
        try:
            self._dispatch(payload, op, tenant, t0, fut, tried, ctx)
        except NoReplicaError:
            self._settle(None, tenant, t0)
            # every replica refused: when the refusal was the typed shed
            # (in-process engines raise OverloadedError from submit), the
            # root must say shed — overload reads as capacity, not a bug
            self._finish_trace(ctx,
                               "shed" if isinstance(exc, OverloadedError)
                               else "error",
                               error=f"{type(exc).__name__}: {exc}")
            fut.set_exception(exc)

    def _settle(self, name: str | None, tenant: str | None, t0: float,
                latency: float | None = None) -> None:
        with self._lock:
            if name is not None:
                # floor at 0: replace() resets a restarted replica's count
                # while the dead process's futures may still be settling
                # on the reader thread — going negative would make
                # (outstanding+1)×p99 vanish and magnetize all traffic
                self._outstanding[name] = max(0, self._outstanding[name] - 1)
                if latency is not None:
                    self._lat[name].append(latency)
            if tenant is not None:
                self._tenant_out[tenant] -= 1

    def _on_done(self, inner: Future, name, payload, op, tenant, t0,
                 fut: Future, tried: set[str], ctx=None) -> None:
        exc = inner.exception()
        if isinstance(exc, ReplicaDiedError):
            # the replica died with this request in flight: inference is
            # idempotent, so retry once per surviving replica
            self._settle(name, None, t0)
            self._failover(payload, op, tenant, t0, fut, tried | {name},
                           exc, ctx, failed=name)
            return
        self._settle(name, tenant, t0,
                     latency=(time.monotonic() - t0) if exc is None else None)
        with self._lock:
            self._stats["completed" if exc is None else "errors"] += 1
        if exc is not None:
            # a replica-side OverloadedError is the typed shed contract,
            # not a failure: the tenant folds (serving_fleet, slo_report)
            # branch on shed vs error, and overload must read as capacity
            self._finish_trace(ctx,
                               "shed" if isinstance(exc, OverloadedError)
                               else "error",
                               error=f"{type(exc).__name__}: {exc}")
            fut.set_exception(exc)
        else:
            now = None
            if ctx is not None:
                # return hop: the replica stamped when its reply left
                # (ReplicaHandle stashes it on the future) — socket
                # transit back + reader dispatch is stream time from the
                # request's point of view, the last stage-sum piece
                rts = getattr(inner, "dls_reply_ts", None)
                if rts is not None:
                    now = time.time()
                    ctx["buf"].add("stream", min(float(rts), now), now,
                                   parent_id=ctx["root_sid"], leg="return")
            self._finish_trace(ctx, "ok", end_ts=now)
            fut.set_result(inner.result())

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                **dict(self._stats),
                "replicas": {
                    n: {"alive": r.alive,
                        "draining": n in self._draining,
                        "outstanding": self._outstanding[n],
                        "dispatched": self._dispatched_to[n],
                        "recent_p99_ms": round(
                            self._recent_p99_locked(n) * 1e3, 3)}
                    for n, r in self._replicas.items()},
                "tenants": {t: o for t, o in self._tenant_out.items() if o},
            }
