"""Checkpoint/resume with integrity manifests — the port of
``distributeddeeplearningspark_tpu/checkpoint.py``'s :class:`Checkpointer`.

A step lives in ``<directory>/<step>/``: ``state.pt`` (``torch.save`` of
:meth:`~.train.state.TrainState.state_dict`), ``data_state.json`` (the
small JSON rider a deterministic feed fast-forwards from, e.g.
``{"examples_seen": ..., "batch_size": ...}``) and ``dls_manifest.json``.
The integrity layer is the JAX package's, unchanged: manifest format 1
with each file's size and CRC32, written atomically (tmp + ``os.replace``);
:func:`verify_step_dir`; :func:`quarantine_step_dir` renames a bad step to
``<step>.corrupt-N``; :func:`latest_step_in`. A restore without an
explicit step walks back from the newest step to the newest one that
verifies, quarantining each corrupt step it passes, and raises
:class:`RestoreError` when none is left.

How the port differs: the files are written into ``<directory>/
.tmp-<step>/`` and the step is committed by renaming that directory to
``<step>``. The rename is the structural commit marker: the manifest is
written before it, so every committed step has one, and a step whose
manifest went missing later verifies structurally when its ``state.pt``
is there. Rank 0 writes; every other rank's :meth:`Checkpointer.save`
writes nothing, and :meth:`wait` ends with a barrier, so no rank reads a
step before rank 0 has committed it. A sharded state (FSDP,
:mod:`.parallel.sharding`) is saved whole in the same format: every rank
takes part in gathering each sharded leaf (``full_tensor()``), one leaf at
a time, and rank 0 copies it to the host. So a step written at ``fsdp=N``
restores at any rank count, the supervisor's shrink included: the restore
reads the whole tensors on every rank and writes each rank's shard.
On a pipeline each stage's params and optimizer tensors reach rank 0 over
the pipe links (:meth:`~.parallel.pipeline.StageState.whole`) and the step
holds the whole state in the same format, so a step written at ``pipe=P``
restores at ``pipe`` 1, at any ``fsdp``, and back: a restore writes each
stage's part. With ``async_save`` the state is copied to the host on the
loop's thread and the files are written on a background thread;
:meth:`wait` joins it.

Telemetry, through the process-wide writer: the ``checkpoint`` phase
spans :meth:`save`'s blocking part (waiting out the previous write and the
copy to the host), ``checkpoint-wait`` spans :meth:`wait`,
``checkpoint-verify`` each verification of the walk, ``restore`` the
read; a quarantine writes a ``recovery`` event. Each stage of the MPMD
pipeline (:mod:`.train.pipeline_trainer`) saves its own state through a
Checkpointer of its own under ``<workdir>/stage<k>/ckpt`` (no process
group: the stage writes, and its barrier is a no-op). orbax and per-rank
shard files are not ported (ROADMAP Queue 1 item 7, with the rest of
``parallel/reshard.py``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import zlib
from typing import Any

import torch

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.parallel import collectives, sharding

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.checkpoint")

#: Integrity manifest filename, written inside each committed step dir.
MANIFEST_NAME = "dls_manifest.json"
STATE_FILE = "state.pt"
DATA_FILE = "data_state.json"
_TMP_PREFIX = ".tmp-"


class RestoreError(RuntimeError):
    """No intact checkpoint could be restored (all steps corrupt/partial)."""


# -- integrity manifests (plain filesystem) ----------------------------------


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _manifest_entries(step_dir: str) -> dict[str, dict[str, int]]:
    """{relpath: {bytes, crc32}} over every file in the step dir (manifest
    excluded)."""
    entries: dict[str, dict[str, int]] = {}
    for root, _, files in os.walk(step_dir):
        for name in files:
            if name == MANIFEST_NAME:
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, step_dir)
            entries[rel] = {"bytes": os.path.getsize(path),
                            "crc32": _file_crc32(path)}
    return entries


def write_manifest(step_dir: str, *, step: int) -> dict:
    """Scan a step dir and commit its manifest atomically (tmp file +
    ``os.replace``: a crash mid-write leaves no half manifest)."""
    manifest = {
        "format": 1,
        "step": int(step),
        "items": sorted(d for d in os.listdir(step_dir)
                        if os.path.isdir(os.path.join(step_dir, d))),
        "files": _manifest_entries(step_dir),
    }
    tmp = os.path.join(step_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(step_dir, MANIFEST_NAME))
    return manifest


def read_manifest(step_dir: str) -> dict | None:
    try:
        with open(os.path.join(step_dir, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify_step_dir(step_dir: str) -> tuple[bool, str]:
    """(ok, reason) for one step dir. With a manifest, every listed file
    must exist with its size and CRC32 and no file may have been added.
    Without one, the step's committing rename makes it whole if its
    ``state.pt`` is there."""
    if not os.path.isdir(step_dir):
        return False, "step dir missing"
    manifest = read_manifest(step_dir)
    if manifest is None:
        if not os.path.isfile(os.path.join(step_dir, STATE_FILE)):
            return False, f"no manifest and no {STATE_FILE}"
        return True, "no manifest; structurally committed"
    want = manifest.get("files", {})
    have = _manifest_entries(step_dir)
    missing = sorted(set(want) - set(have))
    if missing:
        return False, f"missing files {missing[:3]}"
    extra = sorted(set(have) - set(want))
    if extra:
        return False, f"unexpected files {extra[:3]}"
    for rel, meta in want.items():
        got = have[rel]
        if got["bytes"] != meta["bytes"]:
            return False, f"{rel}: size {got['bytes']} != manifest {meta['bytes']}"
        if got["crc32"] != meta["crc32"]:
            return False, f"{rel}: content checksum mismatch"
    return True, "manifest verified"


def quarantine_step_dir(directory: str, step: int) -> str | None:
    """Rename ``<directory>/<step>`` to ``<directory>/<step>.corrupt-N``;
    returns the new path, or None when the step dir is already gone."""
    src = os.path.join(directory, str(int(step)))
    if not os.path.isdir(src):
        return None
    n = 0
    while os.path.exists(f"{src}.corrupt-{n}"):
        n += 1
    dst = f"{src}.corrupt-{n}"
    try:
        os.rename(src, dst)
    except OSError:
        return None
    logger.warning("quarantined corrupt checkpoint step %s -> %s", step, dst)
    return dst


def _steps_in(directory: str) -> list[int]:
    try:
        return sorted(int(d) for d in os.listdir(directory)
                      if d.isdigit() and os.path.isdir(os.path.join(directory, d)))
    except OSError:
        return []


def latest_step_in(directory: str) -> int | None:
    """Newest committed step number by directory listing."""
    steps = _steps_in(directory)
    return steps[-1] if steps else None


def _to_host(tree: Any, keep: bool = True) -> Any:
    """A copy of ``tree`` with every tensor on the CPU (never sharing the
    live tensor's storage), a sharded one gathered whole first (a
    collective). ``keep=False`` (the ranks that do not write): only take
    part in the gathers."""
    if isinstance(tree, dict):
        return {k: _to_host(v, keep) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v, keep) for v in tree]
    if isinstance(tree, torch.Tensor):
        whole = sharding.full(tree.detach())
        return whole.to("cpu", copy=True) if keep else None
    return tree


def _device(state: Any) -> torch.device:
    """The device the state's params lie on (a pipeline's transfers run
    there)."""
    return sharding.local(next(iter(state.params.values()))).device


class Checkpointer:
    """Checkpoints of a :class:`~.train.state.TrainState` under
    ``directory`` (created if absent), the newest ``max_to_keep`` kept.

    ``async_save`` writes on a background thread, so training goes on
    during the write; :meth:`wait` or :meth:`close` joins it."""

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int = 3,
                 async_save: bool = True):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._writer: threading.Thread | None = None
        self._write_error: Exception | None = None
        if collectives.rank() == 0:
            os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, data_state: dict | None = None) -> bool:
        """Save ``state`` (a TrainState) at ``step``, with an optional JSON
        ``data_state``. Returns True where this rank wrote (rank 0)."""
        pipe = getattr(state, "pipe", None)
        if collectives.rank() != 0:
            if pipe is not None:
                pipe.whole(state, _device(state))
            elif any(sharding.is_sharded(t) for t in state.params.values()):
                _to_host(state.state_dict(), keep=False)
            return False
        with telemetry.phase("checkpoint", step=int(step)):
            self._join_writer()
            host = (pipe.whole(state, _device(state)) if pipe is not None
                    else _to_host(state.state_dict()))
        if self.async_save:
            self._writer = threading.Thread(
                target=self._write_guarded, args=(int(step), host, data_state),
                name=f"dls-checkpoint-{step}", daemon=True)
            self._writer.start()
        else:
            self._write(int(step), host, data_state)
        logger.info("checkpoint step %d %s → %s", step,
                    "queued" if self.async_save else "written", self.directory)
        return True

    def _write_guarded(self, step: int, host: dict, data_state: dict | None) -> None:
        try:
            self._write(step, host, data_state)
        except Exception as e:  # raised on the loop's thread by the next join
            self._write_error = e

    def _write(self, step: int, host: dict, data_state: dict | None) -> None:
        """Write the step's files and manifest into a tmp dir, commit it by
        rename, then drop steps past ``max_to_keep``."""
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        if data_state is not None:
            with open(os.path.join(tmp, DATA_FILE), "w") as f:
                json.dump(data_state, f)
                f.flush()
                os.fsync(f.fileno())
        write_manifest(tmp, step=step)
        if os.path.isdir(final):  # a re-save of a step replaces it whole
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in _steps_in(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _join_writer(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise RuntimeError(f"checkpoint write under {self.directory} "
                               f"failed: {err}") from err

    # -- integrity -----------------------------------------------------------

    def verify(self, step: int) -> bool:
        """True iff ``step``'s bytes match its integrity manifest."""
        with telemetry.phase("checkpoint-verify", step=int(step)):
            ok, reason = verify_step_dir(self._step_dir(step))
        if not ok:
            logger.warning("checkpoint step %d failed integrity: %s", step, reason)
        return ok

    def latest_verified_step(self) -> int | None:
        """Newest step that verifies (nothing quarantined)."""
        for step in reversed(self.all_steps()):
            if verify_step_dir(self._step_dir(step))[0]:
                return step
        return None

    def quarantine(self, step: int) -> None:
        """Rename ``step`` to ``<step>.corrupt-N`` (rank 0, which writes one
        ``recovery`` event for it)."""
        if collectives.rank() == 0:
            quarantine_step_dir(self.directory, step)
            writer = telemetry.get()
            if writer is not None:
                writer.recovery(step, "quarantine", directory=self.directory)

    # -- read ----------------------------------------------------------------

    def latest_step(self) -> int | None:
        return latest_step_in(self.directory)

    def all_steps(self) -> list[int]:
        return _steps_in(self.directory)

    def _pick_step(self) -> int:
        """The newest step that verifies, quarantining every corrupt step
        passed on the way down."""
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        for step in steps:
            with telemetry.phase("checkpoint-verify", step=int(step)):
                ok, reason = verify_step_dir(self._step_dir(step))
            if ok:
                return step
            logger.error("checkpoint step %d is corrupt/partial (%s); "
                         "quarantining and falling back to the previous step",
                         step, reason)
            self.quarantine(step)
        raise RestoreError(
            f"no intact checkpoint under {self.directory}: every step "
            f"{sorted(steps)} failed integrity verification (quarantined as "
            f"*.corrupt-N)")

    def _agreed_step(self, step: int | None) -> int:
        """Rank 0 picks (and checks) the step; every rank gets its choice,
        or raises the error rank 0 met."""
        picked: Any
        if collectives.rank() == 0:
            try:
                if step is None:
                    picked = self._pick_step()
                else:
                    ok, reason = verify_step_dir(self._step_dir(step))
                    if not ok:
                        raise RestoreError(
                            f"requested checkpoint step {step} failed "
                            f"integrity verification: {reason}")
                    picked = int(step)
            except (RestoreError, FileNotFoundError) as e:
                picked = e
        else:
            picked = None
        picked = collectives.broadcast_object(picked)
        if isinstance(picked, BaseException):
            raise picked
        return picked

    def restore(self, state: Any, *, step: int | None = None
                ) -> tuple[Any, dict | None]:
        """Restore ``(state, data_state)`` into ``state`` (a TrainState, in
        place) from ``step``, by default the newest step that verifies.
        An explicitly requested step is verified but never walked back
        from: :class:`RestoreError` if its bytes do not match."""
        self.wait()
        step = self._agreed_step(step)
        step_dir = self._step_dir(step)
        with telemetry.phase("restore", step=int(step)):
            saved = torch.load(os.path.join(step_dir, STATE_FILE),
                               map_location="cpu", weights_only=True)
            state.load_state_dict(saved)
            data_state = None
            if os.path.isfile(os.path.join(step_dir, DATA_FILE)):
                with open(os.path.join(step_dir, DATA_FILE)) as f:
                    data_state = json.load(f)
        logger.info("restored checkpoint step %d from %s", step, self.directory)
        return state, data_state

    # -- lifecycle -----------------------------------------------------------

    def wait(self) -> None:
        """Block until the queued write is committed, on every rank."""
        with telemetry.phase("checkpoint-wait"):
            self._join_writer()
            collectives.barrier()

    def close(self) -> None:
        try:
            self.wait()
        except Exception:  # closing must not mask the original failure
            logger.exception("checkpoint finalize during close() failed")

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
