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
recompute, K2/K3 backward).

Sharded as the JAX driver shards it: ``--fsdp`` (default ``-1``, every
rank) and ``--tensor`` (default 1) set ``mesh.data=1, mesh.fsdp=--fsdp,
mesh.tensor=--tensor`` and the trainer takes ``rules=llama_rules(cfg)``,
so at ``local[N]`` the base is FSDP-sharded over N/T ranks (FSDP2) and
split over T ranks for tensor parallelism (``DTensor``: the heads, the
MLP's columns and the vocab), each card holding 1/N of it, while the
LoRA adapters and the norm scales stay replicated; at ``local[1]``
nothing is sharded. ``local[N]`` is N processes: JAX's ``local[N]
--tensor T`` is the port's ``local[N·T] --tensor T``. The model is built
on the meta device and the trainer draws its weights from seed 0, each
card keeping its shards (bitwise one card's weights). On the CPU::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_llama_lora.py \\
        --variant tiny --steps 4 --batch-size 4 --seq-len 64 --lora-rank 4 \\
        --tensor 2

``--seq-parallel C`` (default 1) and ``--cp-impl ring|ulysses`` (default
``ring``) are JAX's context parallelism: ``mesh.seq=C``, the model's
``attention_impl`` set to the ``--cp-impl`` when C > 1, and the trainer's
``context_parallel``, so each row's sequence is split into C blocks, one
a rank of each ``seq`` group (the ring rotates K/V blocks over it, Ulysses
trades the sequence split for a head split by all-to-all). It composes
with ``--fsdp`` and ``--tensor``: ``local[N]`` is then fsdp = N/(C·T).
On the CPU::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_llama_lora.py \\
        --variant tiny --steps 4 --batch-size 4 --seq-len 64 --lora-rank 4 \\
        --seq-parallel 2 --cp-impl ulysses

``--source-partitions P`` keeps the global batches the same at any rank
count that divides P.

Under the port's supervisor (relaunch from the newest checkpoint when a
rank dies)::

    python -m distributeddeeplearningspark_tpu_torch.supervisor -n 1 \\
        --ckpt-dir WD --progress-path WD -- python \\
        distributeddeeplearningspark_tpu_torch/examples/train_llama_lora.py \\
        --variant 7b --seq-len 1024 --batch-size 8 --lora-rank 16 \\
        --checkpoint-dir WD --resume

``--checkpoint-dir``, ``--checkpoint-every`` and ``--resume`` are the
port's (the JAX driver has none); a restore that raises exits with the
supervisor's ``RESTORE_FAILED_EXIT``. A checkpoint holds the whole state,
the frozen base included. A preemption notice (``DLS_FAULT=sigterm@N``,
``DLS_PREEMPT_NOTICE``) drains the gang into a live handoff beside the
checkpoints: rank 0 then prints one JSON line with ``preempted_at`` and
the flash kernels' launches, and every rank exits 0; under ``--resume``
the shrunk relaunch goes on from the handoff.

``--moe-experts E`` swaps every layer's MLP for the MoE FFN (E experts,
top-2, capacity factor 1.25; ``--moe-group g`` routes in groups of g
tokens, else one group a sequence), and ``--expert n`` (default 1) sets
``mesh.expert=n``: ``llama_rules`` splits each layer's expert bank over n
ranks, each running its E/n experts on the rows its expert peers take
too, so at ``local[N]`` fsdp = N/(n·C·T). Under ``lora_trainable`` the bank
and the router are frozen with the rest of the base, stored in
``param_dtype`` (bf16 at 7B). The JAX driver's parse-time refusals are
kept, in its words but one: beside ``--base-quant`` it says "the expert
bank trains from scratch in f32", which is not what its LoRA fine-tune
does, so the port's message says why instead (the int8 base has no form
for the bank). On the CPU::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[2] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_llama_lora.py \\
        --variant tiny --steps 4 --batch-size 4 --seq-len 64 --lora-rank 4 \\
        --moe-experts 4 --expert 2

``--pipeline P`` (default 1) and ``--microbatches M`` (default P) are
JAX's GPipe pipeline: ``mesh.pipe=P``, ``llama_rules(cfg, pipeline=True)``
and the trainer's ``pipeline_microbatches``, so each rank runs a stage of
L/P layers on M microbatches of its rows (:mod:`..models.llama_pp`),
holding only that stage's layers; beside ``--fsdp`` and ``--tensor``,
``local[N]`` is then fsdp = N/(P·T). JAX's refusals are kept:
``--segment-ids``, ``--moe-experts`` and ``--fused-head-loss`` with
``--pipeline``. On the CPU::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[4] \\
        --conf spark.dls.device=cpu \\
        distributeddeeplearningspark_tpu_torch/examples/train_llama_lora.py \\
        --variant tiny --steps 4 --batch-size 4 --seq-len 64 --lora-rank 4 \\
        --pipeline 4 --microbatches 2

``--base-quant int8`` stores each projection's frozen base in int8 with
an f32 scale a channel (the model's ``base_quant``; it needs
``--lora-rank`` above 0 and no ``--moe-experts``, JAX's refusals), and
``--fused-head-loss`` trains through ``losses.causal_lm_fused``, which
never makes the ``[B, S, V]`` logits (JAX's refusal beside
``--pipeline`` is kept; the trainer refuses it where the head is sharded,
ROADMAP Queue 1 item 5). On one card::

    python -m distributeddeeplearningspark_tpu_torch.cli --master local[1] \\
        distributeddeeplearningspark_tpu_torch/examples/train_llama_lora.py \\
        --variant 7b --seq-len 1024 --batch-size 8 --lora-rank 16 --steps 10 \\
        --base-quant int8 --fused-head-loss

The JAX driver's sampling and the import of real weights (which needs
their tokenizer) are not ported yet: those flags fail at parse time, each
naming its ROADMAP item. Rank 0 prints one JSON line: the train summary,
where the run went (world size, backend, device, the mesh, the CP
implementation, the pipeline's microbatches), the number of
sharded params (on any axis) and of those split over ``tensor`` and over
``expert``, the MoE's experts (0: dense), the int8 base and the fused head (as
asked), rank 0's resident param bytes and peak device memory in ``fit``,
the attention's local heads a rank, and
for each rank the flash kernels' launches in ``fit``, its resident param
bytes (each shard's ``to_local()``, each replicated param whole) beside
the rule engine's reckoning, its peak device memory in the init and
during ``fit``, and the Megatron all-reduces (over its tensor and
expert groups), the bytes its ring exchanges and all-to-alls sent in
``fit``, its pipeline stage and the bytes it sent stage to stage and in
the bank's broadcast in ``fit`` (and rank 0's seconds in the trainer's
init);
``replicas_checked`` says each param was compared within its replica
group.
"""

import argparse
import dataclasses
import json
import logging
import time

import torch

from distributeddeeplearningspark_tpu_torch import Checkpointer, Session, Trainer, faults
from distributeddeeplearningspark_tpu_torch.data import text as text_lib
from distributeddeeplearningspark_tpu_torch.examples import (
    add_checkpoint_flags,
    add_not_ported,
    drained,
    resume,
)
from distributeddeeplearningspark_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    llama_rules,
    lora_trainable,
)
from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
from distributeddeeplearningspark_tpu_torch.ops import ring_attention, ulysses
from distributeddeeplearningspark_tpu_torch.parallel import collectives, sharding
from distributeddeeplearningspark_tpu_torch.parallel.pipeline import pipeline
from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_TENSOR
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.utils import sanitize

NOT_PORTED = {
    "--weights": "a fine-tune from real Llama-2 weights waits for the weights "
                 "and their tokenizer in the repository (models/llama_io.py "
                 "reads them): ROADMAP Queue 1 item 5",
    "--tokenizer": "the HF tokenizer adapter: ROADMAP Queue 1 item 5",
    "--sample-tokens": "models/llama_gen.py: ROADMAP Queue 1 item 8",
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
    p.add_argument("--source-partitions", type=int, default=None,
                   help="partitions of the synthetic corpus (a multiple of the "
                        "ranks); the global batches are the same at any rank "
                        "count that divides it. Default: one a rank")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--fsdp", type=int, default=-1,
                   help="FSDP axis size (-1: every rank)")
    p.add_argument("--tensor", type=int, default=1,
                   help="tensor-parallel axis size (ranks a layer is split over)")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="context-parallel axis size (shards the sequence over "
                        "the mesh seq axis)")
    p.add_argument("--cp-impl", choices=["ring", "ulysses"], default="ring",
                   help="context-parallel strategy when --seq-parallel > 1: ring "
                        "(K/V blocks rotate, no head constraint) or ulysses "
                        "(all-to-all head scatter; heads must divide by the "
                        "CP degree)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="swap each layer's FFN for a top-2-routed MoE expert bank "
                        "sharded over the expert mesh axis (models/moe.py); 0 = "
                        "dense")
    p.add_argument("--moe-group", type=int, default=0,
                   help="routing-group size for --moe-experts (0 = per-sequence); "
                        "must divide batch*seq_len")
    p.add_argument("--expert", type=int, default=1,
                   help="expert-parallel axis size (with --moe-experts)")
    p.add_argument("--pipeline", type=int, default=1,
                   help="pipeline-parallel axis size (GPipe stages of the layers)")
    p.add_argument("--microbatches", type=int, default=0,
                   help="pipeline microbatches per step (default: the pipe degree)")
    p.add_argument("--base-quant", default=None, choices=["int8"],
                   help="store the frozen base projections int8 with a per-channel "
                        "f32 scale (needs --lora-rank > 0)")
    p.add_argument("--fused-head-loss", action="store_true",
                   help="fuse the LM head into a chunked-vocab loss: the [B, S, V] "
                        "f32 logits never materialize (train/fused_ce.py)")
    add_checkpoint_flags(p)
    add_not_ported(p, NOT_PORTED)
    return p


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The flags, with the JAX driver's refusals (in its words, but for the
    MoE beside the int8 base: see the module docstring); the port's
    refusals of what it has not ported fail while parsing."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.fused_head_loss and args.pipeline > 1:
        p.error("--fused-head-loss is not supported with --pipeline "
                "(the GPipe forward emits real logits)")
    if args.segment_ids and args.pipeline > 1:
        p.error("--segment-ids is not supported with --pipeline (the stage "
                "forward does not thread them; packed batches would "
                "silently attend across documents)")
    if args.moe_experts:
        if args.pipeline > 1:
            p.error("--moe-experts is not supported with --pipeline "
                    "(the stage forward drops the load-balance aux loss)")
        if args.expert > 1 and args.moe_experts % args.expert:
            p.error(f"--moe-experts {args.moe_experts} must divide by "
                    f"--expert {args.expert} (expert-dim sharding)")
    elif args.expert > 1:
        p.error("--expert > 1 without --moe-experts just replicates the "
                "dense model over extra chips; drop --expert or add "
                "--moe-experts")
    elif args.moe_group:
        p.error("--moe-group only applies to the MoE router; add "
                "--moe-experts or drop it")
    if args.base_quant and not args.lora_rank:
        p.error("--base-quant requires --lora-rank > 0 (the quantized base "
                "is frozen; adapters carry the training)")
    if args.base_quant and args.moe_experts:
        p.error("--base-quant is not supported with --moe-experts (the int8 "
                "base quantizes the dense projections only; the expert bank, "
                "frozen with the base under LoRA and stored in bf16 at 7B, "
                "has no int8 form)")
    return args


def make_config(args: argparse.Namespace, vocab_size: int) -> LlamaConfig:
    if args.variant in VARIANTS:
        cfg = VARIANTS[args.variant](lora_rank=args.lora_rank,
                                     lora_alpha=args.lora_alpha)
        if vocab_size > cfg.vocab_size:
            raise SystemExit(f"tokenizer vocab ({vocab_size}) exceeds model "
                             f"vocab ({cfg.vocab_size})")
    else:
        cfg = LlamaConfig.tiny(vocab_size=max(vocab_size, 512),
                               lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)
    if args.seq_parallel > 1:
        cfg = dataclasses.replace(cfg, attention_impl=args.cp_impl)
    if args.moe_experts:
        cfg = dataclasses.replace(cfg, moe_experts=args.moe_experts,
                                  moe_group_size=args.moe_group)
    if args.fused_head_loss:
        cfg = dataclasses.replace(cfg, fused_head_loss=True)
    if args.base_quant:
        cfg = dataclasses.replace(cfg, base_quant=args.base_quant)
    return cfg


def make_session(args: argparse.Namespace, app: str = "llama-lora") -> Session:
    """The session on the JAX driver's mesh: ``mesh.data=1``,
    ``mesh.fsdp=--fsdp``, ``mesh.seq=--seq-parallel``,
    ``mesh.tensor=--tensor``, ``mesh.pipe=--pipeline`` and
    ``mesh.expert=--expert`` (config 5 is FSDP-dominant: the fsdp workers
    are the executors)."""
    builder = (Session.builder.appName(app).config("mesh.data", 1)
               .config("mesh.fsdp", args.fsdp).config("mesh.seq", args.seq_parallel)
               .config("mesh.tensor", args.tensor).config("mesh.pipe", args.pipeline)
               .config("mesh.expert", args.expert))
    if args.master:
        builder = builder.master(args.master)
    return builder.getOrCreate()


def make_dataset(args: argparse.Namespace, spark: Session):
    """(the repeated ``lm_dataset``, its tokenizer): the corpus (or
    ``synthetic_wikipedia``) → a ``WordPieceTokenizer`` trained on it."""
    parts = args.source_partitions or max(spark.default_parallelism, 1)
    if args.corpus:
        with open(args.corpus) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        docs = PartitionedDataset.parallelize(lines, parts)
    else:
        docs = text_lib.synthetic_wikipedia(1024, num_partitions=parts)
    tok = text_lib.WordPieceTokenizer.train(docs.collect(), vocab_size=2048)
    ds = text_lib.lm_dataset(docs, tok, seq_len=args.seq_len,
                             segment_ids=args.segment_ids).repeat()
    return ds, tok


def make_model(cfg: LlamaConfig) -> LlamaForCausalLM:
    """The model at ``cfg`` on the meta device: the trainer lowers the
    rules onto it, allocates each card's shards and draws the weights from
    its seed (0, the same on every rank)."""
    return LlamaForCausalLM(cfg, device="meta")


def make_trainer(args: argparse.Namespace, spark: Session, cfg: LlamaConfig,
                 checkpointer: Checkpointer | None = None) -> Trainer:
    """The LoRA fine-tune's trainer, the params laid out by ``llama_rules``
    over the session's mesh (by stage at ``--pipeline`` above 1), the
    sequence sharded over ``seq`` at ``--seq-parallel`` above 1."""
    # the clip inside the mask: the norm over the adapters' gradients only
    tx = optim.masked(
        optim.with_grad_clip(
            optim.adamw(optim.warmup_cosine(
                args.lr, min(10, max(args.steps // 10, 1)), args.steps)),
            1.0),
        lora_trainable)
    loss = losses.causal_lm_fused if cfg.fused_head_loss else losses.causal_lm
    return Trainer(spark, make_model(cfg), loss, tx,
                   rules=llama_rules(cfg, pipeline=args.pipeline > 1),
                   accum_steps=args.accum_steps,
                   trainable=lora_trainable, checkpointer=checkpointer,
                   context_parallel=args.seq_parallel > 1,
                   pipeline_microbatches=args.microbatches or None)


def local_heads(trainer: Trainer) -> int:
    """The attention heads each rank runs: ``num_heads`` over the split of
    ``wq``'s rows (1 without tensor parallelism)."""
    split = any(n.endswith("attention.wq.weight") for n in trainer.tensor_dims)
    size = trainer.session.mesh.shape[AXIS_TENSOR] if split else 1
    return trainer.model.cfg.num_heads // size


def card_record(trainer: Trainer, launches: dict) -> dict:
    """This rank's card: its flash launches, its resident param bytes beside
    the rule engine's reckoning (from the whole model's shapes, for its
    pipeline stage), and its peak device memory (in ``fit``: since the last
    reset)."""
    named = dict(LlamaForCausalLM(trainer.model.cfg, device="meta").named_parameters())
    device = trainer.device
    mesh = trainer.session.mesh
    return {
        "flash_launches": launches,
        "param_bytes": sharding.resident_param_bytes(trainer.model),
        "param_bytes_reckoned": sharding.bytes_per_card(
            {n: tuple(p.shape) for n, p in named.items()},
            {n: p.element_size() for n, p in named.items()},
            trainer.plan.rules, mesh, stage=mesh.pipe_index),
        "pipe_stage": mesh.pipe_index,
        "handoff_bytes": pipeline.handoff_bytes,
        "broadcast_bytes": pipeline.broadcast_bytes,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    faults.die_if_dead_host_on_relaunch()
    spark = make_session(args)
    print(spark, flush=True)

    ds, tok = make_dataset(args, spark)
    cfg = make_config(args, tok.vocab_size)
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    cuda = spark.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(spark.device)
    t0 = time.perf_counter()
    trainer = make_trainer(args, spark, cfg, ckpt)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(spark.device) if cuda else None
    data_state, restored_step = resume(trainer, ckpt, args.resume)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [k.launches for k in kernels]
    tp_ops = (collectives.all_reduce_forward, collectives.all_reduce_backward)
    tp_before = sum(op.calls for op in tp_ops)
    cp_ops = (ring_attention.exchange, ulysses.all_to_all)
    cp_before = sum(op.bytes_sent for op in cp_ops)
    pipeline.handoff_bytes = pipeline.broadcast_bytes = 0  # counted in fit
    if cuda:
        torch.cuda.reset_peak_memory_stats(spark.device)
    state, summary = trainer.fit(ds, batch_size=args.batch_size, steps=args.steps,
                                 tokens_per_example=args.seq_len,
                                 log_every=args.log_every,
                                 checkpoint_every=args.checkpoint_every if ckpt else None,
                                 data_state=data_state)
    launches = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    if trainer.preempted_at is not None and spark.rank == 0:
        print(json.dumps({"preempted_at": trainer.preempted_at,
                          "restored_step": restored_step,
                          "world_size": spark.world_size, "mesh": spark.mesh.shape,
                          "flash_launches": launches}), flush=True)
    if drained(trainer, ckpt, spark):
        return
    card = card_record(trainer, launches)
    card.update(init_max_memory_allocated=init_peak,
                tensor_all_reduces=sum(op.calls for op in tp_ops) - tp_before,
                cp_bytes_sent=sum(op.bytes_sent for op in cp_ops) - cp_before)
    by_rank = collectives.all_gather_object(card)
    sanitize.assert_replicas_in_sync(state.params, what="replicated params")
    if spark.rank == 0:
        print(json.dumps({
            "train": summary, "step": state.step, "restored_step": restored_step,
            "variant": args.variant,
            "world_size": spark.world_size, "backend": spark.backend,
            "device": str(spark.device), "mesh": spark.mesh.shape,
            "cp_impl": cfg.attention_impl if args.seq_parallel > 1 else None,
            "microbatches": (trainer.model.pipe.num_microbatches
                             if trainer.model.pipe is not None else None),
            "sharded_params": len(set(trainer.shard_dims) | set(trainer.tensor_dims)
                                  | set(trainer.expert_dims)),
            "tensor_split_params": len(trainer.tensor_dims),
            "expert_split_params": len(trainer.expert_dims),
            "moe_experts": cfg.moe_experts,
            "base_quant": cfg.base_quant, "fused_head_loss": cfg.fused_head_loss,
            "param_bytes": by_rank[0]["param_bytes"],
            "local_heads": local_heads(trainer),
            "flash_launches": launches,
            "trainable_params": sum(p.numel() for n, p in state.params.items()
                                    if lora_trainable(n)),
            "max_memory_allocated": by_rank[0]["max_memory_allocated"],
            "init_s": init_s,
            "by_rank": by_rank, "replicas_checked": spark.world_size > 1,
        }), flush=True)
    if ckpt:
        ckpt.close()
    spark.stop()


if __name__ == "__main__":
    main()
