"""Training scripts of the port, spark-submit shaped (run them through
:mod:`..cli`, or under :mod:`..supervisor` to relaunch a gang that loses a
rank), and what they share: flags of the JAX drivers that the port cannot
honour yet fail at parse time; the checkpoint flags; the resume, which
takes a graceful drain's live handoff first (walking back through the
checkpoint when it is torn) and tells the supervisor a checkpoint it cannot
restore from a crash; and :func:`drained`, the exit of a run that drained.

The drivers: ``train_mnist`` (LeNet-5, config 1), ``train_resnet``
(ResNet, config 2), ``train_dlrm`` (DLRM / Wide&Deep, config 4) and
``train_llama_lora`` (the Llama-2 LoRA fine-tune, config 5)."""

import argparse
import logging
import traceback

from distributeddeeplearningspark_tpu_torch.parallel import collectives, live_reshard
from distributeddeeplearningspark_tpu_torch.supervisor import RESTORE_FAILED_EXIT

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.examples")


class NotPorted(argparse.Action):
    """A JAX-driver flag the port cannot honour: a parse error naming its
    ROADMAP item (the flag's help), never a flag silently ignored."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet ({self.help})")


def add_not_ported(p: argparse.ArgumentParser, flags: dict[str, str]) -> None:
    """``flags``: flag → what it needs and its ROADMAP item. Each takes an
    optional value, as its JAX counterpart takes one or none."""
    for flag, why in flags.items():
        p.add_argument(flag, action=NotPorted, nargs="?", help=why)


def add_checkpoint_flags(p: argparse.ArgumentParser, every: int = 25) -> None:
    p.add_argument("--checkpoint-dir", default=None,
                   help="enable checkpointing to this dir")
    p.add_argument("--checkpoint-every", type=int, default=every)
    p.add_argument("--resume", action="store_true",
                   help="resume from a drain's live handoff, else the "
                        "newest verified checkpoint")


def resume(trainer, ckpt, wanted: bool) -> tuple[dict | None, int | None]:
    """``(data_state, restored step)`` under ``--resume``: from a graceful
    drain's live handoff when one lies beside the checkpoints (the drained
    step, no walk-back), else from the newest verified checkpoint
    (``(None, None)`` without ``--resume``, or with nothing saved). A
    handoff that does not ingest (``HandoffError``) is logged, consumed and
    walked back from through the checkpoint, and a ``reshard`` event with
    ``walk_back`` says so. When the checkpoint's restore raises, the
    process exits with :data:`~..supervisor.RESTORE_FAILED_EXIT`: the
    supervisor then quarantines the step instead of relaunching onto the
    same crash."""
    if not (wanted and ckpt is not None):
        return None, None
    rejected = None
    if live_reshard.has_handoff(ckpt.directory):
        try:
            state, data_state = trainer.restore_live_handoff()
            return data_state, state.step
        except live_reshard.HandoffError as e:
            traceback.print_exc()
            logger.warning("live handoff rejected (%s): walking back through "
                           "the checkpoint", e)
            rejected = str(e)
            collectives.barrier()  # every rank has given up on it
            if collectives.rank() == 0:
                live_reshard.clear_handoff(ckpt.directory)
    restored = (None, None)
    if ckpt.latest_step() is not None:
        try:
            state, data_state = trainer.restore()
        except Exception:
            traceback.print_exc()
            raise SystemExit(RESTORE_FAILED_EXIT)
        restored = (data_state, state.step)
    if rejected is not None:
        live_reshard.emit_reshard_event(
            live_reshard.TransferStats(), step=restored[1] or 0,
            transport="checkpoint", walk_back=True, reason="handoff-rejected",
            error=rejected[:300])
    return restored


def drained(trainer, ckpt, spark) -> bool:
    """After ``fit``: True when the run drained for a preemption (its
    handoff and the DRAIN evidence are written), after closing the
    checkpointer and the session. The driver then exits 0 and writes no
    final artefacts: the shrunk relaunch goes on from the handoff."""
    if trainer.preempted_at is None:
        return False
    logger.warning("drained at step %d for a preemption: exiting clean",
                   trainer.preempted_at)
    if ckpt is not None:
        ckpt.close()
    spark.stop()
    return True
