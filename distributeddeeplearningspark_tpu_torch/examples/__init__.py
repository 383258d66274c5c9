"""Training scripts of the port, spark-submit shaped (run them through
:mod:`..cli`, or under :mod:`..supervisor` to relaunch a gang that loses a
rank), and what they share: flags of the JAX drivers that the port cannot
honour yet fail at parse time; the checkpoint flags and the resume that
tells the supervisor a checkpoint it cannot restore from a crash.

The drivers: ``train_mnist`` (LeNet-5, config 1), ``train_resnet``
(ResNet, config 2), ``train_dlrm`` (DLRM / Wide&Deep, config 4) and
``train_llama_lora`` (the Llama-2 LoRA fine-tune, config 5)."""

import argparse
import traceback

from distributeddeeplearningspark_tpu_torch.supervisor import RESTORE_FAILED_EXIT


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
                   help="resume from the newest verified checkpoint")


def resume(trainer, ckpt, wanted: bool) -> tuple[dict | None, int | None]:
    """``(data_state, restored step)`` from the newest verified checkpoint
    under ``--resume`` (``(None, None)`` without, or with no step saved).
    When the restore raises, the process exits with
    :data:`~..supervisor.RESTORE_FAILED_EXIT`: the supervisor then
    quarantines the step instead of relaunching onto the same crash."""
    if not (wanted and ckpt is not None and ckpt.latest_step() is not None):
        return None, None
    try:
        state, data_state = trainer.restore()
    except Exception:
        traceback.print_exc()
        raise SystemExit(RESTORE_FAILED_EXIT)
    return data_state, state.step
