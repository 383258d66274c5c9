"""Training scripts of the port, spark-submit shaped (run them through
:mod:`..cli`), and what they share: flags of the JAX drivers that the port
cannot honour yet fail at parse time.

The drivers: ``train_mnist`` (LeNet-5, config 1), ``train_resnet``
(ResNet, config 2), ``train_dlrm`` (DLRM / Wide&Deep, config 4) and
``train_llama_lora`` (the Llama-2 LoRA fine-tune, config 5)."""

import argparse


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
