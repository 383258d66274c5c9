"""Config-2 training script: ResNet / ImageNet, data-parallel over executors.

The port of ``examples/train_resnet.py`` (BASELINE.json config 2). Each
executor is a process; launch the gang through the port's cli::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_resnet.py \\
        --steps 3 --batch-size 8 --image-size 32 --num-classes 10

(on the card, drop the ``spark.dls.device`` conf: rank r takes ``cuda:r``).
Run alone, ``python -m distributeddeeplearningspark_tpu_torch.examples.
train_resnet`` trains on one device. The source → ``imagenet_train(repeat=
True)`` (``--data-workers`` worker processes a rank) → the ``--variant``
(ResNet-50 by default, its bottlenecks' 1×1 conv→BN pairs on kernel K4) →
``Trainer.fit`` with SGD (momentum 0.9, weight decay 1e-4) or, with
``--optimizer lars``, LARS, under ``warmup_cosine`` and ``softmax_xent``.
At more than one rank every BatchNorm takes the global batch's statistics
(``all_reduce_sum``), and the run ends by checking that the params and
the BatchNorm buffers are the same bytes on every rank.

The source: ``synthetic_images`` by default; ``--data-dir D`` (ImageNet's
class-per-subdirectory JPEGs, ``imagenet_folder(decode=False)``, decoded in
the pipeline's workers); or ``--records-dir R``, frames materialized once
by ``--data-dir D --materialize-records R`` (decoded and shorter-side
resized to ``--record-px``, by default ``max(256, image_size / 0.875)``;
rank 0 writes them, then the run exits). ``--eval-dir E`` evaluates top-1
and top-5 on that tree after training, its labels pinned to ``--data-dir``'s
classes (so ``--records-dir`` with ``--eval-dir`` needs ``--data-dir``).
``--weights W`` starts from a torchvision-convention state dict
(``torch.load(weights_only=True)``; the head is kept fresh where
``--num-classes`` differs).

Two deliberate differences from the JAX driver, which trains on the same
images and weights as this one at ``--source-partitions`` =
``max(default_parallelism, 1)`` (``tests/test_torch_resnet_driver.py``
holds the two drivers' losses together there, on synthetic images, JPEGs
and records):

- the source comes in ``default_parallelism × max(1, workers)``
  partitions by default (of any source), where the JAX driver takes
  ``max(default_parallelism, 1)``, so that each worker walks a partition
  of its own instead of re-walking one (a pool over one partition re-walks
  it in every worker); ``synthetic_images`` seeds each partition by its
  index, so another count gives other images, and files are dealt to
  partitions round robin, so another count gives another order;
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

``--profile-dir``, ``--mfu`` and ``--tensorboard-dir`` pass ``fit``'s
``profile`` (a window from step ``min(10, steps // 2)``),
``measure_flops`` and ``tensorboard_dir``, as the JAX driver's do. Rank 0
prints one JSON line: the train summary, where the run went (world size,
backend, device), the source and the optimizer, K4's launches in ``fit``,
the BatchNorm all-reduces a step (forward and backward) and the
evaluation's metrics (``--eval-dir``).
"""

import argparse
import json
import logging
import time

import torch

from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer, faults
from distributeddeeplearningspark_tpu_torch.data import records, vision
from distributeddeeplearningspark_tpu_torch.data.sources import (
    folder_classes,
    imagenet_folder,
    synthetic_images,
)
from distributeddeeplearningspark_tpu_torch.data.workers import resolve_num_workers
from distributeddeeplearningspark_tpu_torch.examples import (
    add_checkpoint_flags,
    drained,
    resume,
)
from distributeddeeplearningspark_tpu_torch.models import resnet, resnet_io
from distributeddeeplearningspark_tpu_torch.ops import conv_bn
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.utils import sanitize
from distributeddeeplearningspark_tpu_torch.utils.profiling import ProfileSpec

RESNETS = {
    "resnet18": resnet.ResNet18, "resnet34": resnet.ResNet34,
    "resnet50": resnet.ResNet50, "resnet101": resnet.ResNet101,
    "resnet152": resnet.ResNet152,
}


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
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "lars"],
                   help="lars: layerwise-adaptive rate scaling, the "
                        "large-batch recipe (scale --lr with the batch)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace window into this dir")
    p.add_argument("--tensorboard-dir", default=None)
    p.add_argument("--mfu", action="store_true",
                   help="measure the first step's FLOPs and report MFU")
    p.add_argument("--source-partitions", type=int, default=None,
                   help="partitions of the source (a multiple of the ranks); "
                        "the global batches are the same at any rank count "
                        "that divides it. Default: the ranks × max(1, workers)")
    p.add_argument("--data-dir", default=None,
                   help="ImageNet root (a class-per-subdirectory tree of "
                        "JPEGs); synthetic images if unset")
    p.add_argument("--records-dir", default=None,
                   help="train from record shards made by "
                        "--materialize-records (decoded frames: no JPEG "
                        "decode per epoch)")
    p.add_argument("--materialize-records", default=None, metavar="OUT_DIR",
                   help="decode and shorter-side-resize --data-dir into "
                        "record shards in OUT_DIR once, then exit")
    p.add_argument("--record-px", type=int, default=0,
                   help="the shorter side of materialized frames (0: "
                        "max(256, image-size / 0.875))")
    p.add_argument("--eval-dir", default=None,
                   help="a validation tree (same layout): top-1 and top-5 "
                        "after training, over every image")
    p.add_argument("--weights", default=None,
                   help="a torchvision-convention state dict (.pt/.pth) to "
                        "start from")
    add_checkpoint_flags(p)
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.materialize_records and not args.data_dir:
        p.error("--materialize-records needs --data-dir")
    if args.records_dir and args.eval_dir and not args.data_dir:
        # the records' labels come from the train tree's classes: an eval
        # tree deriving its own would renumber them
        p.error("--records-dir with --eval-dir needs --data-dir too (the "
                "class-per-subdirectory root the records were materialized "
                "from) to pin the class mapping")
    return args


def make_model(args: argparse.Namespace, device: torch.device) -> resnet.ResNet:
    """The variant at ``--num-classes``, weights from seed 0 (the same on
    every rank); the bottleneck variants fuse their 1×1 conv→BN pairs."""
    cls = RESNETS[args.variant]
    fused = args.variant not in ("resnet18", "resnet34")
    model = cls(num_classes=args.num_classes, fused_conv_bn=fused, device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(0))


def source_partitions(args: argparse.Namespace, spark: Session) -> int:
    return args.source_partitions or (
        spark.default_parallelism * max(1, resolve_num_workers(args.data_workers)))


def make_dataset(args: argparse.Namespace, spark: Session):
    parts = source_partitions(args, spark)
    if args.records_dir:
        src = records.array_records(args.records_dir, num_partitions=parts)
    elif args.data_dir:
        # decode=False: JPEG decode runs in imagenet_train's pool or workers
        src = imagenet_folder(args.data_dir, num_partitions=parts, decode=False)
    else:
        src = synthetic_images(args.batch_size * max(args.steps, 1),
                               image_size=args.image_size,
                               num_classes=args.num_classes, num_partitions=parts)
    return vision.imagenet_train(src, size=args.image_size, repeat=True,
                                 num_workers=args.data_workers)


def make_eval_dataset(args: argparse.Namespace, spark: Session):
    """``--eval-dir``'s images, labels pinned to ``--data-dir``'s classes."""
    src = imagenet_folder(
        args.eval_dir, num_partitions=source_partitions(args, spark), decode=False,
        class_to_index=folder_classes(args.data_dir) if args.data_dir else None)
    return vision.imagenet_eval(src, size=args.image_size,
                                num_workers=args.data_workers)


def make_trainer(args: argparse.Namespace, spark: Session,
                 checkpointer: Checkpointer | None = None) -> Trainer:
    schedule = optim.warmup_cosine(args.lr, min(args.steps // 10, 500), args.steps)
    tx = (optim.lars(schedule, momentum=0.9, weight_decay=1e-4)
          if args.optimizer == "lars" else
          optim.sgd(schedule, momentum=0.9, weight_decay=1e-4))
    return Trainer(spark, make_model(args, spark.device), losses.softmax_xent, tx,
                   checkpointer=checkpointer)


def load_weights(trainer: Trainer, path: str) -> None:
    """Overlay a torchvision-convention state dict on the trainer's state;
    a head of another class count stays as initialised."""
    model = trainer.model
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params, stats = resnet_io.import_torchvision_resnet(
        sd, stage_sizes=model.stage_sizes,
        bottleneck=issubclass(model.block_cls, resnet.BottleneckBlock),
        fused_conv_bn=bool(model.conv_bn_layers()))
    if params["head.bias"].shape[0] != model.head.out_features:
        params = {k: v for k, v in params.items() if not k.startswith("head.")}
    if trainer.state is None:
        trainer.init()
    trainer.load_pretrained(params, batch_stats=stats, strict=True,
                            allow_uncovered=("head",))


def materialize(args: argparse.Namespace, spark: Session) -> dict:
    """Rank 0 writes ``--data-dir``'s records into ``--materialize-records``
    (``max(default_parallelism, 8)`` shards, as the JAX driver writes);
    every rank waits for it."""
    record_px = args.record_px or max(256, int(round(args.image_size / 0.875)))
    t0 = time.perf_counter()
    paths: list[str] = []
    if spark.rank == 0:
        paths = records.write_imagenet_records(
            args.data_dir, args.materialize_records, size=record_px,
            num_shards=max(spark.default_parallelism, 8))
    collectives.barrier()
    return {"materialized": len(paths), "records_dir": args.materialize_records,
            "record_px": record_px, "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    faults.die_if_dead_host_on_relaunch()
    builder = Session.builder.appName("resnet-imagenet")
    if args.master:
        builder = builder.master(args.master)
    spark = builder.getOrCreate()
    print(spark, flush=True)

    if args.materialize_records:
        rec = materialize(args, spark)
        if spark.rank == 0:
            print(json.dumps(rec), flush=True)
        spark.stop()
        return

    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    trainer = make_trainer(args, spark, ckpt)
    data_state, restored_step = resume(trainer, ckpt, args.resume)
    if args.weights and restored_step is None:
        load_weights(trainer, args.weights)
    start = trainer.state.step if trainer.state is not None else 0
    k4, bn = conv_bn.matmul_stats.launches, collectives.all_reduce_sum.calls
    profile = (ProfileSpec(args.profile_dir, start_step=min(10, args.steps // 2))
               if args.profile_dir else None)
    state, summary = trainer.fit(
        make_dataset(args, spark), batch_size=args.batch_size, steps=args.steps,
        log_every=args.log_every,
        checkpoint_every=args.checkpoint_every if ckpt else None,
        data_state=data_state, profile=profile, measure_flops=args.mfu,
        tensorboard_dir=args.tensorboard_dir)
    if drained(trainer, ckpt, spark):
        return
    steps = max(state.step - start, 1)
    k4 = conv_bn.matmul_stats.launches - k4
    bn = collectives.all_reduce_sum.calls - bn
    evaluation = (trainer.evaluate(make_eval_dataset(args, spark),
                                   batch_size=args.batch_size)
                  if args.eval_dir else None)
    model = trainer.model
    sanitize.assert_replicas_in_sync(
        {**dict(model.named_parameters()), **dict(model.named_buffers())},
        what="params and BatchNorm buffers")
    if spark.rank == 0:
        print(json.dumps({
            "train": summary, "step": state.step, "restored_step": restored_step,
            "variant": args.variant, "world_size": spark.world_size,
            "source": ("records" if args.records_dir else
                       "jpeg" if args.data_dir else "synthetic"),
            "optimizer": args.optimizer, "eval": evaluation,
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
