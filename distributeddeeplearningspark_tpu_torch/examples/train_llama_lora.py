"""Config-5 training script: a Llama-2 LoRA fine-tune.

The port of ``examples/train_llama_lora.py`` (BASELINE.json config 5).
Launch it through the port's cli::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[1] \\
        distributeddeeplearningspark_tpu_torch/examples/train_llama_lora.py \\
        --variant 7b --seq-len 1024 --batch-size 8 --lora-rank 16 --steps 10

(on the CPU: ``--conf spark.dls.device=cpu`` and ``--variant tiny``).
``synthetic_wikipedia`` (or ``--corpus``, one document a line) → a
``WordPieceTokenizer`` trained on it → ``lm_dataset`` (``--segment-ids``:
packed documents never attend across) → ``LlamaForCausalLM`` at
``--variant``'s published widths with LoRA on ``wq``/``wv``, random
weights from seed 0 → ``Trainer.fit`` with ``causal_lm`` and
``masked(with_grad_clip(adamw(warmup_cosine(...)), 1.0), lora_trainable)``:
the clip sees the adapters' gradients only, and the base leaves autograd
(``trainable=lora_trainable``). At S a multiple of 512 in bf16 (7B, 13B)
the attention runs on the flash kernels (K1 forward and in the remat
recompute, K2/K3 backward). At ``local[N]`` each rank holds a whole
replica and the adapters' gradients are all-reduced.

The JAX driver's sharding, sequence and pipeline parallelism, MoE, int8
base, fused head, sampling and the import of real weights (which needs
their tokenizer) are not ported yet: those flags fail at parse time, each
naming its ROADMAP item. Rank 0 prints one JSON line: the train summary,
where the run went (world size, backend, device), the flash kernels'
launches in ``fit`` and the peak device memory.
"""

import argparse
import json
import logging

import torch

from distributeddeeplearningspark_tpu_torch import Session, Trainer
from distributeddeeplearningspark_tpu_torch.data import text as text_lib
from distributeddeeplearningspark_tpu_torch.examples import add_not_ported
from distributeddeeplearningspark_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    lora_trainable,
)
from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.train import losses, optim

NOT_PORTED = {
    "--weights": "a fine-tune from real Llama-2 weights waits for the weights "
                 "and their tokenizer in the repository (models/llama_io.py "
                 "reads them): ROADMAP Queue 1 item 5",
    "--tokenizer": "the HF tokenizer adapter: ROADMAP Queue 1 item 5",
    "--cp-impl": "ring and Ulysses attention: ROADMAP Queue 1 item 6",
    "--microbatches": "the pipeline (models/llama_pp.py): ROADMAP Queue 1 item 6",
    "--moe-experts": "models/moe.py: ROADMAP Queue 1 item 6",
    "--moe-group": "models/moe.py: ROADMAP Queue 1 item 6",
    "--expert": "expert parallelism: ROADMAP Queue 1 item 6",
    "--base-quant": "the int8 frozen base: ROADMAP Queue 1 item 5",
    "--fused-head-loss": "train/fused_ce.py: ROADMAP Queue 1 item 5",
    "--sample-tokens": "models/llama_gen.py: ROADMAP Queue 1 item 8",
}
#: mesh axes of the JAX driver: only size 1 (no sharding) is ported
MESH_AXES = {
    "fsdp": "FSDP (parallel/sharding.py, FSDP2 fully_shard): ROADMAP Queue 1 item 5",
    "tensor": "tensor parallelism (DTensor, llama_rules): ROADMAP Queue 1 item 5",
    "seq_parallel": "context parallelism (ring, Ulysses): ROADMAP Queue 1 item 6",
    "pipeline": "the pipeline (models/llama_pp.py): ROADMAP Queue 1 item 6",
}
VARIANTS = {"7b": LlamaConfig.llama2_7b, "13b": LlamaConfig.llama2_13b}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--master", default=None,
                   help="local[N]; default: the launch's, else local[1]")
    p.add_argument("--variant", default="tiny", choices=["7b", "13b", "tiny"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8,
                   help="the global batch, over every rank")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient-accumulation micro-steps per optimizer step")
    p.add_argument("--segment-ids", action="store_true",
                   help="packed-document isolation: lm_dataset emits document "
                        "ids and attention never crosses document boundaries")
    p.add_argument("--corpus", default=None,
                   help="text file (one document a line); synthetic if unset")
    p.add_argument("--log-every", type=int, default=10)
    for axis, default in (("fsdp", -1), ("tensor", 1), ("seq_parallel", 1),
                          ("pipeline", 1)):
        p.add_argument("--" + axis.replace("_", "-"), type=int, default=default,
                       help=f"only 1 (-1 for --fsdp: no sharding) is ported: "
                            f"{MESH_AXES[axis]}")
    add_not_ported(p, NOT_PORTED)
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    for axis, why in MESH_AXES.items():
        if getattr(args, axis) > 1:
            p.error(f"--{axis.replace('_', '-')} > 1 is not ported yet ({why})")
    return args


def make_config(args: argparse.Namespace, vocab_size: int) -> LlamaConfig:
    if args.variant in VARIANTS:
        cfg = VARIANTS[args.variant](lora_rank=args.lora_rank,
                                     lora_alpha=args.lora_alpha)
        if vocab_size > cfg.vocab_size:
            raise SystemExit(f"tokenizer vocab ({vocab_size}) exceeds model "
                             f"vocab ({cfg.vocab_size})")
        return cfg
    return LlamaConfig.tiny(vocab_size=max(vocab_size, 512),
                            lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    builder = Session.builder.appName("llama-lora")
    if args.master:
        builder = builder.master(args.master)
    spark = builder.getOrCreate()
    print(spark, flush=True)

    if args.corpus:
        with open(args.corpus) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        docs = PartitionedDataset.parallelize(lines, spark.default_parallelism)
    else:
        docs = text_lib.synthetic_wikipedia(
            1024, num_partitions=max(spark.default_parallelism, 1))
    tok = text_lib.WordPieceTokenizer.train(docs.collect(), vocab_size=2048)
    cfg = make_config(args, tok.vocab_size)
    model = LlamaForCausalLM(cfg, device=spark.device)
    model.init_weights(torch.Generator(device=spark.device).manual_seed(0))
    ds = text_lib.lm_dataset(docs, tok, seq_len=args.seq_len,
                             segment_ids=args.segment_ids).repeat()

    # the clip inside the mask: the norm over the adapters' gradients only
    tx = optim.masked(
        optim.with_grad_clip(
            optim.adamw(optim.warmup_cosine(
                args.lr, min(10, max(args.steps // 10, 1)), args.steps)),
            1.0),
        lora_trainable)
    trainer = Trainer(spark, model, losses.causal_lm, tx,
                      accum_steps=args.accum_steps, trainable=lora_trainable)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [k.launches for k in kernels]
    if spark.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(spark.device)
    state, summary = trainer.fit(ds, batch_size=args.batch_size, steps=args.steps,
                                 tokens_per_example=args.seq_len,
                                 log_every=args.log_every)
    launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    if spark.rank == 0:
        print(json.dumps({
            "train": summary, "step": state.step, "variant": args.variant,
            "world_size": spark.world_size, "backend": spark.backend,
            "device": str(spark.device), "flash_launches": launches,
            "trainable_params": sum(p.numel() for n, p in state.params.items()
                                    if lora_trainable(n)),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(spark.device)
                                     if spark.device.type == "cuda" else None),
        }), flush=True)
    spark.stop()


if __name__ == "__main__":
    main()
