"""Checkpoint hot reload — swap serving params without dropping a
request; the port of ``distributeddeeplearningspark_tpu/serve/reload.py``.

The serving engine and the training run meet at the checkpoint directory:
training keeps committing steps (each with its integrity manifest,
:mod:`..checkpoint`), and the reloader watches that directory from the
serving side. Each time a step newer than the one being served appears it
is

1. **verified** against its integrity manifest
   (:func:`~..checkpoint.verify_step_dir`, the walk restore uses),
2. **loaded** (by default params only, through
   :meth:`~..checkpoint.Checkpointer.restore_params`, so the server never
   materialises optimizer state), and
3. **swapped** into the engine between batches
   (:meth:`~.engine.InferenceEngine.swap_params`): the batch in flight
   finishes on the old params; nothing is dropped.

A candidate that fails verification (a torn write, a killed finalize) is
*rejected and remembered*: the previous params keep serving (that is the
rollback), a ``recovery`` telemetry event records the rejection, and the
walk falls back to the next-newest unseen step, so a single bad commit
cannot wedge reloading. A step that verifies but fails to load gets a
few polls of retries, then the same verdict.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable

from distributeddeeplearningspark_tpu_torch import checkpoint as ckpt_lib
from distributeddeeplearningspark_tpu_torch import telemetry

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.serve")


def checkpoint_params_loader(directory: str | os.PathLike) -> Callable[[int], Any]:
    """A ``(step) -> params`` loader over a checkpoint directory.

    Params only (``Checkpointer.restore_params``: the serving process never
    materialises optimizer state and needs no knowledge of which optimizer
    trained the run). The params dict (name → tensor) is the swappable unit
    of :meth:`~.engine.InferenceEngine.for_model` engines and of the
    :class:`~.generate.ContinuousGenerator` alike, so JAX's
    ``wrap_in_variables`` (flax's ``{"params": ...}``) has no counterpart.
    The loader carries a ``close()`` for the private Checkpointer it holds;
    a :class:`HotReloader` given this loader closes it on
    :meth:`~HotReloader.stop`."""
    ck = ckpt_lib.Checkpointer(directory, async_save=False)

    def load(step: int):
        return ck.restore_params(step=step)[0]

    load.close = ck.close  # type: ignore[attr-defined]
    return load


class HotReloader:
    """Watch a checkpoint directory and hot-swap verified new steps.

    Parameters
    ----------
    engine:
        Anything with ``swap_params(params, version=...)`` — the batch
        engine, the continuous generator, or a test double.
    directory:
        The checkpoint root the training run writes (numbered step dirs).
    load_params:
        ``(step) -> params`` loader. Default: a params-only restore
        through a private :class:`~..checkpoint.Checkpointer` (no
        optimizer state materialised; see ``Checkpointer.restore_params``).
    current_step:
        The step already being served (new steps must be strictly newer);
        ``None`` serves whatever appears first.
    interval_s:
        Poll period of the background thread (:meth:`start`). Directory
        mtime is checked first, so an idle poll is two stat calls.
    """

    def __init__(
        self,
        engine,
        directory: str | os.PathLike,
        *,
        load_params: Callable[[int], Any] | None = None,
        current_step: int | None = None,
        interval_s: float = 5.0,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.directory = os.path.abspath(os.fspath(directory))
        self.interval_s = float(interval_s)
        self.current_step = current_step
        self._clock = clock
        self._rejected: set[int] = set()
        # transient-capable failures (a read racing a step still landing on
        # a network filesystem) get a small retry budget before the
        # permanent verdict; manifest CONTRADICTIONS are deterministic
        self._load_failures: dict[int, int] = {}
        self.max_load_retries = 3
        if load_params is None:
            load_params = checkpoint_params_loader(self.directory)
        self.load_params = load_params
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- one check -----------------------------------------------------------

    def _candidates(self) -> list[int]:
        """Unseen steps newer than current, newest first."""
        try:
            steps = [int(d) for d in os.listdir(self.directory)
                     if d.isdigit()
                     and os.path.isdir(os.path.join(self.directory, d))]
        except OSError:
            return []
        floor = self.current_step if self.current_step is not None else -1
        return sorted((s for s in steps
                       if s > floor and s not in self._rejected),
                      reverse=True)

    def poll(self) -> dict | None:
        """Check once; swap if a newer verified step exists.

        Returns an action record (``{"step", "action": "reloaded" |
        "rejected", ...}`` — the newest candidate's outcome) or None when
        nothing new was found. Walks newest → oldest so a corrupt latest
        step falls back to the next-newest verified one."""
        result: dict | None = None
        for step in self._candidates():
            step_dir = os.path.join(self.directory, str(step))
            ok, reason = ckpt_lib.verify_step_dir(step_dir)
            if ok:
                try:
                    params = self.load_params(step)
                except Exception as e:  # noqa: BLE001 — a broken load must
                    # leave the old params serving, like a failed verify —
                    # but unlike a manifest contradiction it may be a read
                    # racing a step still landing on a network filesystem,
                    # so it gets max_load_retries polls before the
                    # permanent verdict
                    ok = False
                    reason = f"load failed: {type(e).__name__}: {e}"
                    n = self._load_failures.get(step, 0) + 1
                    self._load_failures[step] = n
                    if n < self.max_load_retries:
                        logger.warning(
                            "hot-reload of step %d failed (%s); retry "
                            "%d/%d at the next poll", step, reason, n,
                            self.max_load_retries)
                        result = result or {"step": step, "action": "retry",
                                            "reason": reason}
                        continue
            if not ok:
                self._rejected.add(step)
                logger.error(
                    "hot-reload REJECTED checkpoint step %d (%s); previous "
                    "params keep serving", step, reason)
                telemetry.emit("recovery", step=int(step),
                               event="reload-rejected", reason=reason,
                               directory=self.directory,
                               serving_step=self.current_step)
                result = result or {"step": step, "action": "rejected",
                                    "reason": reason}
                continue  # fall back: maybe an older unseen step verifies
            self.engine.swap_params(params, version=step)
            previous = self.current_step
            self.current_step = step
            logger.info("hot-reloaded checkpoint step %d (was %s)",
                        step, previous)
            telemetry.emit("recovery", step=int(step), event="reload",
                           previous_step=previous, directory=self.directory)
            return {"step": step, "action": "reloaded",
                    "previous_step": previous,
                    **({"fell_back_past": result["step"]} if result else {})}
        return result

    # -- background watcher --------------------------------------------------

    def start(self) -> "HotReloader":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="dlserve-reload", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        close = getattr(self.load_params, "close", None)
        if close is not None:
            close()

    def _watch(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception:  # noqa: BLE001 — the watcher must outlive any
                # one poll's surprise; the next interval retries
                logger.exception("hot-reload poll failed")
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "HotReloader":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
