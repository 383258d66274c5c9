"""Config-1 training script: MNIST LeNet-5, data-parallel over executors.

The port of ``examples/train_mnist.py`` (BASELINE.json config 1, the
reference's first workload). Each executor is a process; launch the gang
through the port's cli::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_mnist.py --steps 150

(on the card, drop the ``spark.dls.device`` conf: rank r takes ``cuda:r``),
or under the port's supervisor, which relaunches the gang from its newest
checkpoint when a rank dies::

    python -m distributeddeeplearningspark_tpu_torch.supervisor -n 2 \\
        --ckpt-dir WD --progress-path WD [--conf spark.dls.device=cpu] -- \\
        python distributeddeeplearningspark_tpu_torch/examples/train_mnist.py \\
        --steps 150 --checkpoint-dir WD --checkpoint-every 25 --resume

Run alone, ``python -m distributeddeeplearningspark_tpu_torch.examples.
train_mnist`` trains on one device. SGD with momentum 0.9 on
``softmax_xent``; synthetic MNIST unless ``--data-dir`` names IDX files
(in ``--source-partitions`` partitions, by default one a rank: a count
that several rank counts divide keeps the global batches the same across
an elastic shrink); ``--checkpoint-dir`` saves every
``--checkpoint-every`` steps and ``--resume`` continues from the newest
step that verifies (a restore that raises exits with the supervisor's
``RESTORE_FAILED_EXIT``); ``--on-nonfinite`` is ``Trainer.fit``'s
divergence policy. Rank 0 prints one JSON line: the train summary, the
test metrics, and where the run went (backend, device, world size, the
step's all-reduces).
"""

import argparse
import json
import logging

from distributeddeeplearningspark_tpu_torch import Checkpointer, LeNet5, Session, Trainer, faults
from distributeddeeplearningspark_tpu_torch.data.sources import load_mnist_idx, synthetic_mnist
from distributeddeeplearningspark_tpu_torch.examples import add_checkpoint_flags, resume
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.train import losses, optim


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--master", default=None,
                   help="local[N]; default: the launch's, else local[1]")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--data-dir", default=None,
                   help="dir with MNIST IDX files; synthetic if unset")
    p.add_argument("--source-partitions", type=int, default=None,
                   help="partitions of the data (default: one a rank)")
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--on-nonfinite", default="raise",
                   choices=["raise", "skip", "rollback"],
                   help="divergence recovery policy (see Trainer.fit)")
    add_checkpoint_flags(p)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    faults.die_if_dead_host_on_relaunch()
    builder = Session.builder.appName("mnist-lenet5")
    if args.master:
        builder = builder.master(args.master)
    spark = builder.getOrCreate()
    print(spark, flush=True)

    n = args.source_partitions or spark.default_parallelism
    if args.data_dir:
        train_ds = load_mnist_idx(args.data_dir, "train", num_partitions=n)
        test_ds = load_mnist_idx(args.data_dir, "test", num_partitions=n)
    else:
        train_ds = synthetic_mnist(4096, num_partitions=n, seed=0)
        test_ds = synthetic_mnist(512, num_partitions=n, seed=99)

    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    trainer = Trainer(spark, LeNet5(device=spark.device), losses.softmax_xent,
                      optim.sgd(args.lr, momentum=0.9), checkpointer=ckpt)
    data_state, restored_step = resume(trainer, ckpt, args.resume)
    calls = collectives.all_reduce_grads.calls
    state, summary = trainer.fit(
        train_ds.repeat(), batch_size=args.batch_size, steps=args.steps,
        log_every=args.log_every, checkpoint_every=args.checkpoint_every if ckpt else None,
        data_state=data_state, on_nonfinite=args.on_nonfinite)
    allreduces = collectives.all_reduce_grads.calls - calls
    metrics = trainer.evaluate(test_ds, batch_size=args.batch_size)
    if spark.rank == 0:
        print(json.dumps({
            "train": summary, "test": metrics, "step": state.step,
            "restored_step": restored_step, "data_state": data_state,
            "world_size": spark.world_size, "backend": spark.backend,
            "device": str(spark.device), "grad_allreduces": allreduces,
        }), flush=True)
    if ckpt:
        ckpt.close()
    spark.stop()


if __name__ == "__main__":
    main()
