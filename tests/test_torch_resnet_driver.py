"""The port's ResNet driver against the JAX package's, on the same images.

The JAX ``examples/train_resnet.py`` runs as a user runs it (a process of
its own, ``local[1]``, ResNet-50 at 32×32, b=8, 3 steps, its telemetry
in a workdir), drawing ``synthetic_images`` in ``max(default_parallelism,
1)`` partitions. The port's driver runs through its own functions
(``parse_args``, ``make_trainer``, ``make_dataset``) with
``--source-partitions`` set to that count, from the JAX driver's initial
weights (its ``Trainer.init`` on the same sample batch, seed 0, carried
across by ``resnet_io.params_from_flax``). Its bottlenecks' 1×1 conv→BN
pairs run K4's path, on the CPU its plain version; the JAX driver runs
them unfused. Both run bf16 activations, so the logged loss and gradient
norm are held at the bf16 parity tolerance of a kernel's path against the
plain one (``chip_smoke.py``'s ``PARITY_RTOL``)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import sources as jsources
from distributeddeeplearningspark_tpu.data import vision as jvision
from distributeddeeplearningspark_tpu.models import ResNet50 as JResNet50
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu_torch import Session
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.examples import train_resnet as tdriver
from distributeddeeplearningspark_tpu_torch.models.resnet_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.ops import conv_bn as tconv
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from test_torch_deadline import bounded, per_test

ROOT = Path(__file__).resolve().parent.parent
BATCH, SIZE, CLASSES, STEPS, LR = 8, 32, 10, 3, 0.01
FLAGS = ["--steps", str(STEPS), "--batch-size", str(BATCH), "--image-size",
         str(SIZE), "--num-classes", str(CLASSES), "--lr", str(LR)]
#: the JAX driver's source partitions at local[1]
JAX_PARTITIONS = 1
#: K4's path (plain on the CPU) against the unfused chain in bf16: the
#: sound run reads 2.4e-3 (loss) and 3.2e-3 (grad norm), the port's images
#: drawn in 2 partitions instead of the JAX driver's 1 read 9.8e-2
RTOL = 2e-2
#: K4's calls a step: ResNet-50's 16 bottlenecks' two 1×1 conv→BN pairs,
#: each admitted by the gate at 32×32 and b=8 on the CPU
K4_PER_STEP = 32


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _step_metrics(workdir):
    return [(e["step"], e["metrics"]) for e in jtele.read_events(str(workdir))
            if e["kind"] == "step_metrics"]


def _jax_init():
    """The JAX driver's initial weights: its model, optimizer and dataset,
    ``Trainer.init`` on the first batch, as its ``fit`` does."""
    spark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    try:
        src = jsources.synthetic_images(
            BATCH * STEPS, image_size=SIZE, num_classes=CLASSES,
            num_partitions=max(spark.default_parallelism, 1))
        ds = jvision.imagenet_train(src, size=SIZE, repeat=True, num_workers=0)
        tx = joptim.sgd(joptim.warmup_cosine(LR, 0, STEPS), momentum=0.9,
                        weight_decay=1e-4)
        trainer = JTrainer(spark, JResNet50(num_classes=CLASSES),
                           jlosses.softmax_xent, tx)
        trainer.init(trainer._sample_batch(ds, BATCH))
        state = jax.tree.map(np.asarray, jax.device_get(trainer.state))
        return state.params, state.mutable["batch_stats"]
    finally:
        spark.stop()


def _fused_names(sd):
    """An unfused bottleneck's state dict under the fused model's names:
    ``conv_{1,3}.weight`` → ``conv_bn_{1,3}.kernel`` (the same OIHW
    tensor), ``bn_{1,3}.*`` → ``conv_bn_{1,3}.*``."""
    out = {}
    for k, v in sd.items():
        m = re.fullmatch(r"(blocks\.\d+)\.(conv|bn)_([13])\.(\w+)", k)
        if m:
            pre, kind, i, leaf = m.groups()
            k = f"{pre}.conv_bn_{i}.{'kernel' if kind == 'conv' else leaf}"
        out[k] = v
    return out


@pytest.fixture(scope="module")
@bounded()
def runs(tmp_path_factory):
    """(JAX driver's workdir, port's workdir, K4 calls in the port's fit)."""
    root = tmp_path_factory.mktemp("drivers")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT),
           jtele.WORKDIR_ENV: str(root / "jax")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_resnet.py"),
         "--master", "local[1]", *FLAGS],
        env=env, cwd=root, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    params, stats = _jax_init()

    mp = pytest.MonkeyPatch()
    try:
        args = tdriver.parse_args([*FLAGS, "--source-partitions",
                                   str(JAX_PARTITIONS)])
        spark = Session.builder.master("local[1]").appName("t").config(
            DEVICE_CONF, "cpu").getOrCreate()
        trainer = tdriver.make_trainer(args, spark)
        trainer.model.load_state_dict(_fused_names(params_from_flax(params, stats)))
        calls = []
        plain = tconv.matmul_stats
        mp.setattr(tconv, "matmul_stats", lambda x, w: calls.append(1) or plain(x, w))
        mp.setenv(ttele.WORKDIR_ENV, str(root / "port"))
        trainer.fit(tdriver.make_dataset(args, spark), batch_size=BATCH,
                    steps=STEPS, log_every=10)
        ttele.reset()
        spark.stop()
    finally:
        mp.undo()
    return root / "jax", root / "port", len(calls)


def test_port_driver_logs_the_jax_drivers_loss(runs):
    jdir, tdir, _ = runs
    want, got = _step_metrics(jdir), _step_metrics(tdir)
    assert [s for s, _ in got] == [s for s, _ in want] == [STEPS]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[0][1][k], want[0][1][k], rtol=RTOL,
                                   err_msg=k)


def test_port_driver_runs_the_bottleneck_pairs_on_k4s_path(runs):
    *_, calls = runs
    assert calls == K4_PER_STEP * STEPS, calls
