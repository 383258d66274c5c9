"""Config-2 training script: ResNet / ImageNet, data-parallel over executors.

The port of ``examples/train_resnet.py`` (BASELINE.json config 2) on
synthetic images. Each executor is a process; launch the gang through the
port's cli::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_resnet.py \\
        --steps 3 --batch-size 8 --image-size 32 --num-classes 10

(on the card, drop the ``spark.dls.device`` conf: rank r takes ``cuda:r``).
Run alone, ``python -m distributeddeeplearningspark_tpu_torch.examples.
train_resnet`` trains on one device. ``synthetic_images`` →
``imagenet_train(repeat=True)`` (``--data-workers`` worker processes a
rank) → the ``--variant`` (ResNet-50 by default, its bottlenecks' 1×1
conv→BN pairs on kernel K4) → ``Trainer.fit`` with SGD (momentum 0.9,
weight decay 1e-4) under ``warmup_cosine`` and ``softmax_xent``. At more
than one rank every BatchNorm takes the global batch's statistics
(``all_reduce_sum``), and the run ends by checking that the params and
the BatchNorm buffers are the same bytes on every rank.

Two deliberate differences from the JAX driver, which trains on the same
images and weights as this one at ``--source-partitions`` =
``max(default_parallelism, 1)`` (``tests/test_torch_resnet_driver.py``
holds the two drivers' losses together there):

- the source comes in ``default_parallelism × max(1, workers)``
  partitions by default, where the JAX driver draws
  ``max(default_parallelism, 1)``, so that each worker draws a partition
  of its own instead of re-walking one (a pool over one partition re-walks
  it in every worker); ``synthetic_images`` seeds each partition by its
  index, so another count gives other images;
- the bottleneck variants fuse their 1×1 conv→BN pairs on kernel K4
  (``fused_conv_bn=True``); the JAX driver builds its model unfused.

Under the port's supervisor (relaunch from the newest checkpoint when a
rank dies)::

    python -m distributeddeeplearningspark_tpu_torch.supervisor -n 2 \\
        --ckpt-dir WD --progress-path WD -- python \\
        distributeddeeplearningspark_tpu_torch/examples/train_resnet.py \\
        --steps 3 --batch-size 8 --image-size 32 --num-classes 10 --checkpoint-dir WD --resume

(``--resume`` restores the newest verified step; a restore that raises
exits with the supervisor's ``RESTORE_FAILED_EXIT``).

Flags of the JAX driver that the port cannot honour yet fail at parse
time, each naming its ROADMAP item. Rank 0 prints one JSON line: the train
summary, where the run went (world size, backend, device), K4's launches
in ``fit`` and the BatchNorm all-reduces a step (forward and backward).
"""

import argparse
import json
import logging

import torch

from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer, faults
from distributeddeeplearningspark_tpu_torch.data import vision
from distributeddeeplearningspark_tpu_torch.data.sources import synthetic_images
from distributeddeeplearningspark_tpu_torch.data.workers import resolve_num_workers
from distributeddeeplearningspark_tpu_torch.examples import (
    add_checkpoint_flags,
    add_not_ported,
    resume,
)
from distributeddeeplearningspark_tpu_torch.models import resnet
from distributeddeeplearningspark_tpu_torch.ops import conv_bn
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.utils import sanitize

RESNETS = {
    "resnet18": resnet.ResNet18, "resnet34": resnet.ResNet34,
    "resnet50": resnet.ResNet50, "resnet101": resnet.ResNet101,
    "resnet152": resnet.ResNet152,
}

#: flags of the JAX driver the port does not honour yet → their ROADMAP item
NOT_PORTED = {
    "--data-dir": "JPEG decode and imagenet_folder: ROADMAP Queue 1 item 3",
    "--records-dir": "data/records.py: ROADMAP Queue 1 item 3",
    "--materialize-records": "data/records.py: ROADMAP Queue 1 item 3",
    "--record-px": "data/records.py: ROADMAP Queue 1 item 3",
    "--eval-dir": "imagenet_folder and the JPEG eval set: ROADMAP Queue 1 item 3",
    "--weights": "the torchvision state-dict import (models/resnet_io.py's "
                 "import_torchvision_resnet): ROADMAP Queue 1 item 3",
    "--profile-dir": "utils/profiling.py over torch.profiler: ROADMAP Queue 1 item 9",
    "--tensorboard-dir": "the Trainer's TensorBoard writer: ROADMAP Queue 1 item 9",
    "--mfu": "the Trainer's measure_flops (MFU): ROADMAP Queue 1 item 9",
}
LARS = "optim.lars: ROADMAP Queue 1 item 3"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--master", default=None,
                   help="local[N]; default: the launch's, else local[1]")
    p.add_argument("--variant", default="resnet50", choices=sorted(RESNETS))
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256,
                   help="the global batch, over every rank")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--data-workers", type=int, default=None,
                   help="augment worker processes a rank (default: "
                        "DLS_DATA_WORKERS, else 0 = in-process); the same "
                        "bytes at any count")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "lars"])
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--source-partitions", type=int, default=None,
                   help="partitions of the synthetic source (a multiple of "
                        "the ranks); the global batches are the same at any "
                        "rank count that divides it. Default: the ranks × max(1, workers)")
    add_checkpoint_flags(p)
    add_not_ported(p, NOT_PORTED)
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.optimizer == "lars":
        p.error(f"--optimizer lars is not ported yet ({LARS})")
    return args


def make_model(args: argparse.Namespace, device: torch.device) -> resnet.ResNet:
    """The variant at ``--num-classes``, weights from seed 0 (the same on
    every rank); the bottleneck variants fuse their 1×1 conv→BN pairs."""
    cls = RESNETS[args.variant]
    fused = args.variant not in ("resnet18", "resnet34")
    model = cls(num_classes=args.num_classes, fused_conv_bn=fused, device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(0))


def make_dataset(args: argparse.Namespace, spark: Session):
    parts = args.source_partitions or (
        spark.default_parallelism * max(1, resolve_num_workers(args.data_workers)))
    src = synthetic_images(args.batch_size * max(args.steps, 1),
                           image_size=args.image_size, num_classes=args.num_classes,
                           num_partitions=parts)
    return vision.imagenet_train(src, size=args.image_size, repeat=True,
                                 num_workers=args.data_workers)


def make_trainer(args: argparse.Namespace, spark: Session,
                 checkpointer: Checkpointer | None = None) -> Trainer:
    schedule = optim.warmup_cosine(args.lr, min(args.steps // 10, 500), args.steps)
    tx = optim.sgd(schedule, momentum=0.9, weight_decay=1e-4)
    return Trainer(spark, make_model(args, spark.device), losses.softmax_xent, tx,
                   checkpointer=checkpointer)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    faults.die_if_dead_host_on_relaunch()
    builder = Session.builder.appName("resnet-imagenet")
    if args.master:
        builder = builder.master(args.master)
    spark = builder.getOrCreate()
    print(spark, flush=True)

    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    trainer = make_trainer(args, spark, ckpt)
    data_state, restored_step = resume(trainer, ckpt, args.resume)
    start = trainer.state.step if trainer.state is not None else 0
    k4, bn = conv_bn.matmul_stats.launches, collectives.all_reduce_sum.calls
    state, summary = trainer.fit(
        make_dataset(args, spark), batch_size=args.batch_size, steps=args.steps,
        log_every=args.log_every,
        checkpoint_every=args.checkpoint_every if ckpt else None,
        data_state=data_state)
    steps = max(state.step - start, 1)
    k4 = conv_bn.matmul_stats.launches - k4
    bn = collectives.all_reduce_sum.calls - bn
    model = trainer.model
    sanitize.assert_replicas_in_sync(
        {**dict(model.named_parameters()), **dict(model.named_buffers())},
        what="params and BatchNorm buffers")
    if spark.rank == 0:
        print(json.dumps({
            "train": summary, "step": state.step, "restored_step": restored_step,
            "variant": args.variant, "world_size": spark.world_size,
            "backend": spark.backend, "device": str(spark.device),
            "k4_launches": k4, "k4_launches_per_step": k4 / steps,
            "bn_allreduces_per_step": bn / steps,
            "replicas_checked": spark.world_size > 1,
        }), flush=True)
    if ckpt:
        ckpt.close()
    spark.stop()


if __name__ == "__main__":
    main()
