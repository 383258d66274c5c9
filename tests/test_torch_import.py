"""The port stands alone: importing it and every one of its modules loads
no jax, no flax and no module of the JAX package, and its sources name none
of them. The JAX package's name is a prefix of the port's, so every check
compares whole dotted names."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distributeddeeplearningspark_tpu_torch as port
from test_torch_deadline import per_test

JAX_PKG = "distributeddeeplearningspark_tpu"
PORT_DIR = Path(port.__file__).parent


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "orbax") or \
        name == JAX_PKG or name.startswith(JAX_PKG + ".")


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("flax.linen", True),
    (JAX_PKG, True), (JAX_PKG + ".telemetry", True),
    (JAX_PKG + "_torch", False), (JAX_PKG + "_torch.ops", False),
    ("torch", False), ("jaxtyping_like", False),
])
def test_forbidden_compares_whole_dotted_names(name, bad):
    assert _forbidden(name) is bad


def test_importing_the_port_loads_no_jax_in_a_fresh_process():
    code = f"""
import json, pkgutil, importlib, sys
import {JAX_PKG}_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for n in names:
    importlib.import_module(n)
print(json.dumps({{"modules": names, "loaded": sorted(sys.modules)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=PORT_DIR.parent)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {"ops.flash_attention", "ops.attention", "ops._build",
                "models.bert", "models.bert_io", "serve.engine",
                "telemetry", "telemetry.trace", "utils.device", "session",
                "rdd", "metrics", "data.text", "data.feed", "train.losses",
                "train.optim", "train.state", "train.step", "train.trainer",
                "ops.conv_bn", "models.resnet", "models.resnet_io",
                "data.sources", "data.vision", "ops.scatter_rows",
                "models.dlrm", "models.dlrm_io", "train.embed",
                "models.lenet", "models.lenet_io", "utils.env",
                "parallel.mesh", "parallel.collectives", "checkpoint", "cli",
                "examples.train_mnist", "data.workers", "data.prefetch",
                "examples", "examples.train_resnet", "examples.train_dlrm",
                "models.llama", "models.llama_io", "examples.train_llama_lora",
                "faults", "supervisor", "utils.sanitize", "telemetry.fleet",
                "data.exchange", "telemetry.anatomy", "telemetry.health",
                "telemetry.series", "status", "utils.profiling", "utils.kineto",
                "utils.memory", "parallel.mpmd", "train.pipeline_trainer",
                "examples.train_llama_mpmd", "parallel.pipeline", "models.llama_pp",
                "parallel.plan", "models.llama_gen", "serve.generate", "serve.kv",
                "serve.reload", "serve.router", "serve.fleet", "serve.cli",
                "examples.serve_mnist", "utils.native", "data.records",
                "examples.train_bert", "data.dataframe", "data.device_agg",
                "examples.dlrm_features"}
    got = {n.split(".", 1)[1] for n in rec["modules"]}
    assert expected <= got, expected - got
    bad = [m for m in rec["loaded"] if _forbidden(m)]
    assert not bad, bad


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 12
    bad = {str(f.relative_to(PORT_DIR)): n for f in files
           for n in _imported_names(f) if _forbidden(n)}
    assert not bad, bad


@pytest.mark.parametrize("module", ["telemetry.anatomy", "telemetry.health",
                                    "telemetry.series", "telemetry.fleet",
                                    "telemetry.trace", "status", "utils.profiling",
                                    "utils.kineto", "utils.memory", "metrics"])
def test_each_observability_module_names_no_jax(module):
    path = PORT_DIR.joinpath(*module.split(".")).with_suffix(".py")
    names = list(_imported_names(path))
    assert names and not [n for n in names if _forbidden(n)]


def test_resnet_driver_takes_the_observability_flags():
    """The three flags it refused (ROADMAP Queue 1 item 9) parse now."""
    from distributeddeeplearningspark_tpu_torch.examples import train_resnet

    args = train_resnet.parse_args(["--profile-dir", "p", "--tensorboard-dir", "tb",
                                    "--mfu"])
    assert (args.profile_dir, args.tensorboard_dir, args.mfu) == ("p", "tb", True)
    assert train_resnet.parse_args([]).mfu is False


def test_chip_smoke_imports_no_jax():
    path = PORT_DIR.parent / "chip_smoke.py"
    bad = [n for n in _imported_names(path) if _forbidden(n)]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["bert_base", "for_model", "engine",
                                   "resolve_device", "session", "trainer",
                                   "resnet50", "dlrm", "lenet", "train_resnet",
                                   "train_dlrm", "llama2_7b", "llama_tiny",
                                   "train_llama_lora", "train_mnist",
                                   "train_llama_mpmd", "stage_program", "train_bert",
                                   "bert_tiny"])
def test_entry_points_without_device_raise_when_cuda_is_absent(entry):
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA error needs a machine without CUDA")
    from distributeddeeplearningspark_tpu_torch import Session, Trainer
    from distributeddeeplearningspark_tpu_torch.examples import (
        train_bert,
        train_dlrm,
        train_llama_lora,
        train_llama_mpmd,
        train_mnist,
        train_resnet,
    )
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.models.bert import (
        BertConfig, BertForMLM, bert_base, bert_tiny)
    from distributeddeeplearningspark_tpu_torch.serve import InferenceEngine
    from distributeddeeplearningspark_tpu_torch.train import losses, optim, pipeline_trainer
    from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

    calls = {
        "bert_base": lambda: bert_base(num_layers=1),
        "resnet50": lambda: port.resnet50(),
        "dlrm": lambda: port.dlrm(vocab_sizes=(10,) * 26),
        "lenet": lambda: port.LeNet5(),
        "for_model": lambda: InferenceEngine.for_model(
            BertForMLM(BertConfig.tiny(num_layers=1), device="cpu")),
        "engine": lambda: InferenceEngine(lambda p, b: b, {}),
        "resolve_device": lambda: resolve_device(),
        "session": lambda: Session.builder.master("local[1]").getOrCreate(),
        "trainer": lambda: Trainer(
            None, BertForMLM(BertConfig.tiny(num_layers=1), device="cpu"),
            losses.masked_lm, optim.adamw(1e-3)),
        # the drivers, run with no conf: the card, not a CPU fallback
        "train_resnet": lambda: train_resnet.main(["--steps", "1", "--image-size", "32"]),
        "train_dlrm": lambda: train_dlrm.main(["--steps", "1", "--vocab-size", "10"]),
        "llama2_7b": lambda: llama.llama2_7b(num_layers=1),
        "llama_tiny": lambda: llama.llama_tiny(),
        "train_llama_lora": lambda: train_llama_lora.main(["--steps", "1"]),
        "train_mnist": lambda: train_mnist.main(["--steps", "1"]),
        "train_llama_mpmd": lambda: train_llama_mpmd.main(["--steps", "1"]),
        "train_bert": lambda: train_bert.main(["--steps", "1", "--variant", "tiny"]),
        "bert_tiny": lambda: bert_tiny(),
        "stage_program": lambda: pipeline_trainer.LlamaStageProgram(
            llama.LlamaConfig.tiny(), 0, 2, optim.sgd(0.1)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_cpu_device_is_taken_and_others_refused():
    from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
