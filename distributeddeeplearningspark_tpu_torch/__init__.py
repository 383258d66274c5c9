"""The PyTorch/CUDA port of ``distributeddeeplearningspark_tpu``.

A second package beside the JAX one, held against it module by module. It
imports ``torch`` and numpy only — never jax, flax, or any module of the
JAX package — and keeps that package's module paths (``ops/``,
``models/``, ``serve/``, ``train/``, ``data/``, ``telemetry/``) so each
counterpart is easy to find. Every TPU kernel on a ported path is a
kernel written by hand for Hopper (``csrc/``), built at first use; its
plain PyTorch version runs for CPU tensors only. Entry points run on the
card unless the caller passes ``device="cpu"`` (a :class:`Session`:
``.config("spark.dls.device", "cpu")``).

It trains LeNet-5 (BASELINE.json config 1, the main path) data-parallel
over N processes, one device each, launched by the port's ``dlsubmit``
(``python -m distributeddeeplearningspark_tpu_torch.cli --master local[2]
script.py``); each rank's script runs the calls of
``examples/train_mnist.py``:

    spark = Session.builder.appName("mnist").getOrCreate()  # joins the gang
    ds = sources.synthetic_mnist(4096, num_partitions=spark.default_parallelism)
    trainer = Trainer(spark, LeNet5(device=spark.device), losses.softmax_xent,
                      optim.sgd(0.01, momentum=0.9),
                      checkpointer=Checkpointer("ckpt"))
    state, summary = trainer.fit(ds.repeat(), batch_size=64, steps=150,
                                 checkpoint_every=25)

It serves BERT-base through :class:`InferenceEngine`:

    model = bert_base()                       # on "cuda", weights from a seed
    with InferenceEngine.for_model(model, max_batch=32) as eng:
        logits = eng.infer({"input_ids": ids, "attention_mask": am})

and trains it through :class:`Session` and :class:`Trainer`, as
``examples/train_bert.py`` drives the JAX package:

    spark = Session.builder.master("local[1]").appName("bert").getOrCreate()
    ds = text.mlm_dataset(docs, tok, seq_len=512, max_predictions=80)
    tx = optim.with_grad_clip(optim.adamw(optim.warmup_linear(1e-4, 10, 30)), 1.0)
    state, summary = Trainer(spark, bert_base(), losses.masked_lm, tx).fit(
        ds.repeat(), batch_size=32, steps=30, tokens_per_example=512)

(the port's ``examples/train_bert.py`` runs these calls through the cli,
from a corpus file or a Wikipedia dump: ``--corpus``, ``--data-dir``),

and trains ResNet-50 with the fused 1×1-conv + BN-statistics kernel (K4),
as ``examples/train_resnet.py`` drives the JAX package on synthetic data
(the port's driver also from a JPEG tree or records, ``--data-dir``,
``--records-dir``, and with ``--optimizer lars``):

    ds = vision.imagenet_train(sources.synthetic_images(1024, num_partitions=1),
                               size=224, repeat=True)
    tx = optim.sgd(optim.warmup_cosine(0.1, 2, 20), momentum=0.9,
                   weight_decay=1e-4)
    state, summary = Trainer(spark, resnet50(), losses.softmax_xent, tx).fit(
        ds, batch_size=256, steps=20)

and trains the config-4 DLRM with its fused table updated row-sparsely by
row-wise AdaGrad, the table scatter on the row scatter-add kernel (K5):

    model = dlrm()                            # 26 × 100,000 rows × 64
    specs = sparse_embed_specs(model, lr=1e-2)
    ds = sources.synthetic_criteo(32_768, vocab_sizes=(100_000,) * 26).repeat()
    state, summary = Trainer(spark, model, losses.binary_xent,
                             optim.adamw(1e-3, weight_decay=0.0),
                             sparse_embed=specs).fit(ds, batch_size=8192, steps=30)

and fine-tunes Llama-2 7B with LoRA adapters on wq and wv (config 5), the
base frozen in bf16, the attention on K1-K3, as ``examples/
train_llama_lora.py`` does:

    model = llama2_7b(lora_rank=16)           # on "cuda", weights from a seed
    ds = text.lm_dataset(docs, tok, seq_len=1024).repeat()
    tx = optim.masked(optim.with_grad_clip(optim.adamw(
        optim.warmup_cosine(1e-4, 1, 10)), 1.0), lora_trainable)
    state, summary = Trainer(spark, model, losses.causal_lm, tx,
                             trainable=lora_trainable).fit(
        ds, batch_size=8, steps=10, tokens_per_example=1024)
"""

import importlib
from typing import TYPE_CHECKING

__version__ = "0.1.0"

#: public name -> defining submodule, resolved lazily (PEP 562) so that
#: importing a light submodule does not pull in the rest
_EXPORTS = {
    "InferenceEngine": "distributeddeeplearningspark_tpu_torch.serve.engine",
    "LeNet5": "distributeddeeplearningspark_tpu_torch.models.lenet",
    "PartitionedDataset": "distributeddeeplearningspark_tpu_torch.rdd",
    "MeshSpec": "distributeddeeplearningspark_tpu_torch.parallel.mesh",
    "ShardingRules": "distributeddeeplearningspark_tpu_torch.parallel.sharding",
    "Plan": "distributeddeeplearningspark_tpu_torch.parallel.plan",
    "Checkpointer": "distributeddeeplearningspark_tpu_torch.checkpoint",
    "BertConfig": "distributeddeeplearningspark_tpu_torch.models.bert",
    "BertForMLM": "distributeddeeplearningspark_tpu_torch.models.bert",
    "bert_base": "distributeddeeplearningspark_tpu_torch.models.bert",
    "bert_large": "distributeddeeplearningspark_tpu_torch.models.bert",
    "bert_tiny": "distributeddeeplearningspark_tpu_torch.models.bert",
    "flash_attention": "distributeddeeplearningspark_tpu_torch.ops.flash_attention",
    "Conv1x1BN": "distributeddeeplearningspark_tpu_torch.ops.conv_bn",
    "ResNet": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "ResNet18": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "ResNet34": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "ResNet50": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "ResNet101": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "ResNet152": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "BottleneckBlock": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "BasicBlock": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "resnet50": "distributeddeeplearningspark_tpu_torch.models.resnet",
    "DLRM": "distributeddeeplearningspark_tpu_torch.models.dlrm",
    "WideAndDeep": "distributeddeeplearningspark_tpu_torch.models.dlrm",
    "dlrm": "distributeddeeplearningspark_tpu_torch.models.dlrm",
    "sparse_embed_specs": "distributeddeeplearningspark_tpu_torch.models.dlrm",
    "SparseEmbedSpec": "distributeddeeplearningspark_tpu_torch.train.embed",
    "LlamaConfig": "distributeddeeplearningspark_tpu_torch.models.llama",
    "LlamaForCausalLM": "distributeddeeplearningspark_tpu_torch.models.llama",
    "llama2_7b": "distributeddeeplearningspark_tpu_torch.models.llama",
    "lora_trainable": "distributeddeeplearningspark_tpu_torch.models.llama",
    "llama_rules": "distributeddeeplearningspark_tpu_torch.models.llama",
    "StreamingAUC": "distributeddeeplearningspark_tpu_torch.metrics",
    "Session": "distributeddeeplearningspark_tpu_torch.session",
    "Trainer": "distributeddeeplearningspark_tpu_torch.train.trainer",
    "TrainState": "distributeddeeplearningspark_tpu_torch.train.state",
}

if TYPE_CHECKING:  # static analyzers see the real names
    from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer
    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
    from distributeddeeplearningspark_tpu_torch.parallel.mesh import MeshSpec
    from distributeddeeplearningspark_tpu_torch.parallel.plan import Plan
    from distributeddeeplearningspark_tpu_torch.parallel.sharding import ShardingRules
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.models.bert import (
        BertConfig,
        BertForMLM,
        bert_base,
        bert_large,
        bert_tiny,
    )
    from distributeddeeplearningspark_tpu_torch.metrics import StreamingAUC
    from distributeddeeplearningspark_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        llama2_7b,
        llama_rules,
        lora_trainable,
    )
    from distributeddeeplearningspark_tpu_torch.models.dlrm import (
        DLRM,
        WideAndDeep,
        dlrm,
        sparse_embed_specs,
    )
    from distributeddeeplearningspark_tpu_torch.models.resnet import (
        BasicBlock,
        BottleneckBlock,
        ResNet,
        ResNet18,
        ResNet34,
        ResNet50,
        ResNet101,
        ResNet152,
        resnet50,
    )
    from distributeddeeplearningspark_tpu_torch.ops.conv_bn import Conv1x1BN
    from distributeddeeplearningspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from distributeddeeplearningspark_tpu_torch.serve.engine import InferenceEngine
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train.embed import SparseEmbedSpec
    from distributeddeeplearningspark_tpu_torch.train.state import TrainState
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value  # cache: next access skips the import
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [*_EXPORTS, "__version__"]
