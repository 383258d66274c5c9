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
import jax.numpy as jnp
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


# -- from files: a JPEG tree, then records with LARS and an eval tree ---------

#: ResNet-18 at 32² in f32 on both sides (its BasicBlocks are unfused in
#: both packages): the same arithmetic summed in another order. In bf16 the
#: two frameworks round activations in different places, which at b=8 moves
#: the first step's gradient norm by 4%: a driver's fault would hide there
FILE_RTOL = 1e-3
#: the JAX driver with its ResNet-18 in f32: run as its own script
JAX_RESNET_F32 = """
import functools, runpy, sys
import jax.numpy as jnp
import distributeddeeplearningspark_tpu.models as models
models.ResNet18 = functools.partial(models.ResNet18, dtype=jnp.float32)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
FILE_FLAGS = ["--variant", "resnet18", "--steps", str(STEPS), "--batch-size",
              str(BATCH), "--image-size", str(SIZE), "--num-classes", str(CLASSES),
              "--lr", str(LR)]


def _jpeg_tree(root: Path) -> None:
    """3 classes × 8 JPEGs (PIL, quality 90, 4:2:0 and 4:4:4) around 40×48."""
    import io

    from PIL import Image

    rng = np.random.default_rng(12)
    for c in range(3):
        (root / f"class{c}").mkdir(parents=True)
        for i in range(8):
            h, w = 38 + i, 50 - i
            y, x = np.mgrid[0:h, 0:w]
            arr = np.clip(y[..., None] * (c + 2) + x[..., None] * 3 + 40 * c
                          + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90,
                                      subsampling=2 if i % 2 else 0)
            (root / f"class{c}" / f"{i}.jpg").write_bytes(buf.getvalue())


def _jax_resnet18_init():
    """The JAX driver's initial ResNet-18 weights (``Trainer.init`` on a
    batch of its shapes, seed 0: the init sees only shapes)."""
    from distributeddeeplearningspark_tpu.models import ResNet18 as JResNet18

    spark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    try:
        src = jsources.synthetic_images(BATCH, image_size=SIZE, num_classes=CLASSES,
                                        num_partitions=1)
        ds = jvision.imagenet_train(src, size=SIZE, repeat=True, num_workers=0)
        trainer = JTrainer(spark, JResNet18(num_classes=CLASSES, dtype=jnp.float32),
                           jlosses.softmax_xent,
                           joptim.sgd(0.1))
        trainer.init(trainer._sample_batch(ds, BATCH))
        state = jax.tree.map(np.asarray, jax.device_get(trainer.state))
        return state.params, state.mutable["batch_stats"]
    finally:
        spark.stop()


def _jax_driver(root: Path, name: str, args: list[str]) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT),
           jtele.WORKDIR_ENV: str(root / f"jax-{name}")}
    out = subprocess.run(
        [sys.executable, "-c", JAX_RESNET_F32, str(ROOT / "examples" / "train_resnet.py"),
         "--master", "local[1]", *FILE_FLAGS, *args],
        env=env, cwd=root, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _port_driver(root: Path, name: str, args: list[str], init) -> dict | None:
    """The port's driver through its functions from ``init``, its
    ResNet-18 in f32; the evaluation's metrics under ``--eval-dir``."""
    import functools

    import torch

    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(tdriver.RESNETS, "resnet18",
                   functools.partial(tdriver.resnet.ResNet18, dtype=torch.float32))
        targs = tdriver.parse_args([*FILE_FLAGS, *args, "--source-partitions",
                                    str(JAX_PARTITIONS)])
        spark = Session.builder.master("local[1]").appName("t").config(
            DEVICE_CONF, "cpu").getOrCreate()
        trainer = tdriver.make_trainer(targs, spark)
        trainer.model.load_state_dict(params_from_flax(*init))
        mp.setenv(ttele.WORKDIR_ENV, str(root / f"port-{name}"))
        trainer.fit(tdriver.make_dataset(targs, spark), batch_size=BATCH,
                    steps=STEPS, log_every=10)
        ttele.reset()
        evaluation = (trainer.evaluate(tdriver.make_eval_dataset(targs, spark),
                                       batch_size=BATCH) if targs.eval_dir else None)
        spark.stop()
        return evaluation
    finally:
        mp.undo()


@pytest.fixture(scope="module")
@bounded()
def file_runs(tmp_path_factory):
    """The JAX driver and the port's over a JPEG tree (``--data-dir``), then
    over records the port's driver materialized through its cli (the JAX
    driver trains from them too) with ``--optimizer lars`` and
    ``--eval-dir``."""
    root = tmp_path_factory.mktemp("files")
    _jpeg_tree(root / "jpeg")
    script = ROOT / "distributeddeeplearningspark_tpu_torch" / "examples" / "train_resnet.py"
    mat = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearningspark_tpu_torch.cli",
         "--master", "local[1]", "--conf", f"{DEVICE_CONF}=cpu", "--workdir",
         str(root / "mat"), str(script), "--data-dir", str(root / "jpeg"),
         "--materialize-records", str(root / "rec"), "--record-px", "40"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
        text=True, timeout=200)
    assert mat.returncode == 0, mat.stderr[-4000:]
    init = _jax_resnet18_init()
    jpeg = ["--data-dir", str(root / "jpeg")]
    rec = ["--records-dir", str(root / "rec"), "--optimizer", "lars",
           "--eval-dir", str(root / "jpeg"), *jpeg]
    out = {"materialize": mat.stdout,
           "jpeg_jax_stdout": _jax_driver(root, "jpeg", jpeg),
           "rec_jax_stdout": _jax_driver(root, "rec", rec),
           "jpeg_port_eval": _port_driver(root, "jpeg", jpeg, init),
           "rec_port_eval": _port_driver(root, "rec", rec, init)}
    return root, out


@pytest.mark.parametrize("source", ["jpeg", "rec"])
def test_port_driver_from_files_logs_the_jax_drivers_loss(file_runs, source):
    """ResNet-18 at 32² in f32 over the JPEG tree (SGD), and over the port's
    records with LARS: the JAX driver's logged loss and gradient norm."""
    root, _ = file_runs
    want, got = _step_metrics(root / f"jax-{source}"), _step_metrics(root / f"port-{source}")
    assert [s for s, _ in got] == [s for s, _ in want] == [STEPS]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[0][1][k], want[0][1][k], rtol=FILE_RTOL,
                                   err_msg=f"{source} {k}")


def test_records_materialized_by_the_port_and_the_eval_tree(file_runs):
    """The cli's materialization: rank 0's JSON line, 8 shards of frames
    whose shorter side is at most 40; the eval metrics over the JPEG tree after the
    LARS run, the JAX driver's (which prints them rounded to 4 places)."""
    import ast
    import json

    from distributeddeeplearningspark_tpu_torch.data import records as trecords

    root, out = file_runs
    (line,) = [json.loads(x) for x in out["materialize"].splitlines()
               if x.startswith('{"materialized"')]
    assert line["materialized"] == 8 and line["record_px"] == 40
    frames = trecords.array_records(str(root / "rec")).collect()
    # frames shrunk to a shorter side of 40, none upscaled (38 and 39 stay)
    assert sorted({min(e["image"].shape[:2]) for e in frames}) == [38, 39, 40]
    assert len(frames) == 24
    (jline,) = [x for x in out["rec_jax_stdout"].splitlines()
                if x.startswith("eval metrics:")]
    want = ast.literal_eval(jline.split(":", 1)[1].strip())
    got = out["rec_port_eval"]
    assert {"loss", "accuracy", "top5_accuracy"} <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=FILE_RTOL, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("classes", [10, 1000])
def test_weights_load_a_torchvision_state_dict(tmp_path, classes):
    """``--weights``: a torchvision-convention ResNet-18 state dict (made
    from a seed, saved with ``torch.save``) over the model's params and
    running statistics; a head of another class count stays fresh."""
    import torch
    from test_torch_resnet import _torchvision_state_dict

    sd = _torchvision_state_dict((2, 2, 2, 2), False, 64, 1000, seed=3)
    torch.save(sd, tmp_path / "r18.pth")
    args = tdriver.parse_args(["--variant", "resnet18", "--num-classes", str(classes),
                               "--weights", str(tmp_path / "r18.pth")])
    spark = Session.builder.master("local[1]").appName("t").config(
        DEVICE_CONF, "cpu").getOrCreate()
    try:
        trainer = tdriver.make_trainer(args, spark)
        fresh = trainer.model.head.weight.detach().clone()
        tdriver.load_weights(trainer, args.weights)
        m = trainer.model
        assert torch.equal(m.stem_conv.weight, sd["conv1.weight"])
        assert torch.equal(m.blocks[2].shortcut_conv.weight, sd["layer2.0.downsample.0.weight"])
        assert torch.equal(m.blocks[7].bn_2.var, sd["layer4.1.bn2.running_var"])
        assert torch.equal(m.head.weight, sd["fc.weight"] if classes == 1000 else fresh)
    finally:
        spark.stop()
