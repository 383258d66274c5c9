#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. build every kernel of the paths from the checkout's sources (one
   ``nvcc`` per source, started together, ``sm_90a``) and print the
   compiler's register/spill report;
2. hold K1 (flash forward) against its plain PyTorch version on the card
   in bf16 cases (the served and the training shape, causal GQA at
   D = 128, segments with padding, a fully masked row, S = 320 at D = 64
   and at D = 128 causal GQA, whole key tiles skipped by padding and
   by segments, Llama-2 7B's b=8, S=1,024, 32 heads, D = 128, causal,
   one card's local heads under tensor parallelism: b=4 at 16 heads,
   b=8 at 8, and a pipeline stage's microbatches of that shape, b=2 and
   b=1, and the MoE 0.9b's), at the stated tolerance, and time the kernel, the
   plain version, one PyTorch library call computing the same function (a
   yardstick the port never calls) and the card's bound for the same work;
3. the same for K2 (dQ) and K3 (dK, dV) against the plain backward, in
   the same cases and more (the training shape, b=32, S=512, every key allowed; the
   served batch; causal GQA at D = 128; segments with padding; a fully
   masked row; S = 320 at D = 64 and at D = 128 causal GQA; whole tiles
   skipped; S = 322 with padding; Llama's, and its two local-head
   shapes), each run twice for equal bits, timing
   ``_delta`` and the whole ``flash_bwd`` beside the two kernels; then the
   gates: "auto" picks the plain path for f32 and for head dims the
   kernels are not built for, an f32 ``Conv1x1BN`` and a bf16 one with
   widths off a multiple of 8 train unfused, and the wrappers raise on such
   inputs;
4. the host input path, W = min(8, cores / 2) worker processes: BERT's
   feed (``mlm_dataset`` at S=512, b=32, tokenize pooled) and ResNet's
   (``imagenet_train`` at 224², b=256), each with its source at 1 and at W
   partitions, at 0 and at W workers; check that the first 4 batches are
   the same bytes at both counts, that the pool ran (W workers, items
   delivered) and that no worker, shared-memory segment or prefetch thread
   outlives the phase; print the host's ms per batch of each and the
   host's core count;
5. train BERT-base MLM at full width (12 layers, hidden 768, vocab 30522,
   S=512, dropout 0.1, random weights from a seed) for 30 steps at b=32
   through the port's ``Session`` → ``synthetic_wikipedia`` →
   ``WordPieceTokenizer`` → ``mlm_dataset`` (tokenize over W workers) →
   ``Trainer.fit`` (which prefetches), the calls of
   ``examples/train_bert.py``; check that every logged loss is finite and
   the last below 0.9x the first, that each kernel ran 12 times per step,
   that every parameter gradient through the kernels agrees with the
   plain attention path on one batch, that the steps' telemetry saw the
   pool at W workers and that nothing of the input path outlives the
   phase; ``fit`` itself profiles its last lap and counts its first step's
   FLOPs (``profile=``, ``measure_flops=True``): check that the count is
   a reckoning of the step's products exactly and the same on the kernel
   route and the plain path, that each lap's ``mfu`` is its flops × steps /
   wall / peak, that the last ``memory`` event's peak is
   ``max_memory_allocated``, that the window's breakdown (the package's
   ``op_breakdown``) holds the ``flash`` family at 12 launches a step of
   each kernel, and that the port's ``dlstatus --anatomy --json`` shows
   the MFU and the memory; print the step time, tokens/s, the MFU and
   ``mfu_device`` (laps before the window), the host's ms per batch, the
   loop's own ms a step with its input ready, the laps' summed wait for
   input, the prefetch ring's depth, the workers'
   utilization, the step's forward/backward/optimizer split, the window's
   breakdown and the peak device memory;
6. serve BERT-base through the port's ``InferenceEngine.for_model`` to 8
   client threads; check every served row against a one-request forward of
   the same module whose attention runs the plain PyTorch path, the first
   layer's attention output of a served batch against that path on the
   same inputs, and that K1 ran 12 times per served batch; print latency
   percentiles and requests/s;
6b. train Llama-2 7B with LoRA (BASELINE.json config 5) at its published
   widths (32 layers, hidden 4096, 32 heads, intermediate 11008, vocab
   32000, bf16 base, rank 16 on wq and wv, random weights from a seed) for
   10 steps at b=8, S=1,024 through the port's ``Session`` →
   ``synthetic_wikipedia`` → ``WordPieceTokenizer`` → ``lm_dataset`` →
   ``Trainer.fit(trainable=lora_trainable)`` with the adapters' AdamW, the
   calls of ``examples/train_llama_lora.py``; check that every logged loss
   is finite and the last below the first, that K1 ran 64 times a step
   (forward and remat recompute) and K2 and K3 32 times, that the
   optimizer state holds the adapters' two moments only, that the peak
   memory stays under a limit that a planted fault (every frozen param's
   gradient zero-filled) breaks, and that at 2 layers the adapters'
   gradients through the kernels agree with the plain attention path from
   nonzero B; ``fit`` profiles its last 3 steps and counts its first
   step's FLOPs, held as BERT's are (K1 64 launches a step in the window,
   K2 and K3 32, the count a reckoning's exactly, at 2 layers the same on
   both routes); print the step time, tokens/s, model TFLOP/s, the MFU and
   ``mfu_device``, the measured count over the model formula's (and why),
   the window's top families and the peak memory; then run the port's driver through its
   ``dlsubmit`` at ``local[1]`` for 5 steps with its default ``--fsdp -1``
   (a one-card mesh: nothing sharded, the card holding what the rule
   engine reckons; the same launch counts a step, finite losses, nothing
   left);
7. hold K4 (the 1×1-conv matmul with BN statistics) against its plain
   version on the card in bf16 at the ten shapes of ResNet-50's fused
   layers at b=256, three that a rank of four gets at 64 images, and six
   small or ragged ones, at the stated tolerances,
   each launched twice for equal bits, and time the kernel, the plain
   version, the library yardstick (``torch.mm`` then ``torch.var_mean``)
   and the bound;
8. train ResNet-50 at full width (stages 3/4/6/3, width 64, 1000 classes,
   224², bf16 activations, ``fused_conv_bn=True``, random weights from a
   seed) for 30 steps at b=256 through the port's ``Session`` →
   ``synthetic_images`` (W partitions) → ``imagenet_train(repeat=True)``
   over W workers → ``Trainer.fit`` with SGD under ``warmup_cosine(0.1)``,
   the calls of ``examples/train_resnet.py``; check that every logged loss
   is finite and the last below the first, that K4 ran 27 times per step,
   that every parameter gradient through K4 agrees with the unfused chain
   on one batch, that the BN statistics moved and an evaluation is
   finite, that the steps' telemetry saw the pool at W workers and that
   nothing of the input path outlives the phase; print the step time,
   images/s, the host's ms per batch, the loop's own ms a step, the input
   gauges, the step's split,
   a profiled window and the peak device memory;
9. hold K5 (the in-place row scatter-add) against its plain version on the
   card, bitwise, in five cases: the DLRM step's shape (the sorted unique
   rows of a real synthetic batch of 8,192 over the 2,600,000 × 64 f32
   table, padded to 212,992 with drop sentinels), the same at D = 1, 700
   unsorted int64 ids at D = 13, all ids sentinels
   (past V and negative), and no ids; guard rows around each table show
   that nothing was written outside it, and its ``data_ptr`` that it was
   not copied. At the DLRM shape, time the kernel, the plain version,
   ``index_add_`` (a yardstick the port never calls on this path) and
   the bound;
10. train the config-4 DLRM at full width (26 × 100,000 rows × 64 in one
   f32 table, bottom MLP 512/256/64, top 512/256/1, bf16 MLPs, random
   weights from a seed) for 20 steps at b=8,192 through the port's
   ``Session`` → ``synthetic_criteo`` → ``Trainer.fit(sparse_embed=...)``
   with ``binary_xent``, AdamW on the MLPs and row-wise AdaGrad on the
   table through K5; check that every logged loss is finite and the last
   below the first, that K5 ran once a step, that no optimizer tensor has
   the table's size, and, on one more batch from one saved state, that
   rows outside the batch do not move and that K5's step, a step whose
   scatter is K5's plain version, and a second K5 step give the same bits;
   print the step time, examples/s, the host's ms per batch, the loop's
   own ms a step, the laps' summed wait for input, a profiled window, the peak device memory, a
   held-out evaluation and its AUC;
11. train LeNet-5 (BASELINE.json config 1, the main path; full width,
   random weights from a seed) through the port's ``dlsubmit``: ``python
   -m distributeddeeplearningspark_tpu_torch.cli --master local[1]`` runs
   the port's ``examples/train_mnist.py`` in a subprocess, a gang of one
   whose ``Session`` joins an NCCL group, for 150 steps at b=64 over
   ``synthetic_mnist(4096)`` with a checkpoint every 25 steps and
   deterministic algorithms on; check that the rank reports backend
   ``nccl`` and device ``cuda:0``, that the gradient all-reduce ran once a
   step, that a held-out evaluation on ``synthetic_mnist(512, seed=99)``
   passes 0.9 accuracy, that the telemetry holds ``step_metrics`` and
   ``checkpoint`` phase records and that every kept step's manifest
   verifies. Then a launch with ``--resume`` restores step 150 and its
   ``data_state`` and runs to 200; 75 steps plus a resume to 150 give the
   same bits as the 150 straight steps; a copy of the newest step with one
   byte flipped is quarantined and the restore walks back to the step
   before it; and a gang of one in this process shows NCCL kernels in a
   profiled window. LeNet runs no hand-written kernel. Print the step
   time, examples/s, the host's ms per batch, the laps' summed wait for
   input, busy and all-reduce ms per step, and checkpoint save and restore
   ms;
12. run the port's drivers through its ``dlsubmit`` at ``local[1]`` (a gang
   of one, NCCL) at full width: ``examples/train_resnet.py`` (ResNet-50 at
   b=256, 224², W workers) and ``examples/train_dlrm.py`` (the config-4
   DLRM at b=8,192, then its held-out AUC), 10 steps each; check that each
   exits 0, that K4 ran 27 times a step and the BatchNorm all-reduces 106
   times a step (K5 once a step), that the logged losses are finite and
   that no process or segment of either run is left; print each run's
   step ms and the launch's seconds; then the ResNet-50 driver again for 6
   steps with ``--profile-dir --mfu --tensorboard-dir``: its window's
   breakdown holds the ``k4`` family at 27 launches a step and its MFU is
   finite; whether the TensorBoard writer ran is printed;
13. hold global BatchNorm statistics on the card: ResNet-50 at b=256 as
   the two halves of a batch, one process each on this card, summing
   their statistics and their gradients through a gloo group as
   ``all_reduce_sum`` does, against the whole batch in this process: every
   BatchNorm's batch mean and variance the same on both halves and the
   whole batch's, and the halves' summed parameter gradients the whole
   batch's, at the stated tolerances, through K4;
14. the recovery chain: ResNet-50 at b=256 (K4) for 6 steps through
   ``Trainer.fit(on_nonfinite="skip")`` with ``DLS_FAULT=nan@3``: the
   skipped step leaves every param, SGD trace, the schedule's count and
   every BatchNorm statistic bitwise as step 2 left them, one skipped
   step, finite steps after it, 27 K4 launches a step, and the train
   step's ms and host syncs (``torch.cuda.set_sync_debug_mode``) with the
   guard against without, in turns; BERT-base at b=32, S=512 (K1-K3) for
   8 steps through ``fit(on_nonfinite="rollback")`` with
   ``DLS_FAULT=nan@6``, a checkpoint and an evaluation on a held-out MLM
   set every 4 steps: one rollback to step 4, the last checkpoint's
   ``examples_seen`` past the window the feed went on over, the final
   params against a second run restored at step 4 and fed from 6 batches
   in (and whether the bits agree), every ``eval_*`` fit logs against
   ``Trainer.evaluate`` at the same step, the kernels' launches, the
   checkpoint's save and restore ms; the port's LeNet driver under the
   port's ``Supervisor`` with ``DLS_FAULT=crash@10``, a checkpoint every 4
   steps and ``--resume``: the attempts ``training-crash`` then ``clean``
   in the telemetry stream, the final params bitwise phase 11's 150
   straight steps, nothing of the killed attempt left, and the seconds
   from the kill to the relaunch's first step;
15. print one JSON line of per-kernel numbers, the card's name and power
   limit (``nvidia-smi``), and last ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --gang`` runs, at one rank per card (2 or more),
the LeNet phase; the port's LeNet driver under the port's ``Supervisor``
at N ranks with ``shrink_after=1`` and ``DLS_FAULT=die_host@25`` on host
1, which must relaunch at N - 1 ranks from the step-20 checkpoint, record
its ``geometry_change`` and log the losses of an uninterrupted N-rank run
at a stated tolerance (a global batch of 96 over 12 source partitions:
the same batches at 4 and 3 ranks); the same gang drained for a
preemption instead (``DLS_FAULT=sigterm@25`` on host 1): every rank exits
0 after the live handoff, the attempt is classified ``graceful-shutdown``,
the relaunch at N - 1 resumes from the handoff at step 25 with no
walk-back and no step logged twice, its losses the uninterrupted run's at
the same tolerance; a planted desync of rank 1's params
(``SANITIZE_FAULTS``) that ``fit(sanitize_every=1)`` must catch as
``DesyncError`` on every rank over NCCL; then the ResNet-50 (b=256
global) and DLRM (b=8,192 global) drivers over NCCL: the replicas in sync, 27 K4 launches a step,
every rank's losses the global batch's and a one-card run's on the same
batches at a stated tolerance, ResNet-50's parameters' change and the
DLRM's row accumulators too; two faults planted into ResNet-50's N-rank
run (the loss not weighed, a rank-local BatchNorm backward) and one into
the DLRM's (a rank-by-rank sparse merge) must each break one of those
limits; each rank's step ms and a profiled window's NCCL kernel time.
Then Llama-2 7B LoRA (config 5) sharded over the cards: the port's Llama
driver through its cli at N ranks (NCCL) with its default ``--fsdp -1``
(global b=8, S=1,024, LoRA rank 16, the base FSDP-sharded, the adapters
and norm scales replicated), with ``--tensor 2`` (fsdp=N/2 × tensor=2)
and ``--tensor 4`` (the base also split over the tensor peers' heads,
columns and vocab), and at one card on the same batches: every rank's
losses one card's at a stated tolerance, K1/K2/K3 64/32/32 launches a
step on every card at its local heads, each param in sync within its
replica group, each card's resident param bytes the rule engine's
reckoning, each card's peak in the init (the model built on the meta
device, each card drawing its shards) below the whole model, and at
fsdp=N each card's peak memory in fit at least half the base below one
card's; comparison runs of the LoRA at fsdp=N and at fsdp=N/2 ×
tensor=2, and of a full fine-tune of the 7B widths cut to 2 layers
(sharded params in training) at fsdp=N, at data=2 × fsdp=N/2 (HSDP) and
on one card, losses and grad norms at stated tolerances; and four planted
faults (``LLAMA_GANG_FAULTS``: the adapters' all-reduce skipped, FSDP2's
reduce-scatter left averaging, the adapters' gradients left unsummed over
the tensor group, the feed sharded by world rank) that must each break
one of those limits; each card's step ms, tokens/s, peak memory, a
profiled window's NCCL time and kernels (their names carry NCCL's
algorithm and protocol), the transports and tuning model NCCL logged for
the driver runs (``NCCL_DEBUG=INFO``, ``NCCL_DEBUG_SUBSYS=INIT,TUNING``,
a file a process, in their environment only), and the tensor=2 driver
again under ``NCCL_PROTO=Simple``, printed beside the rest.
Then config 5's preemption drain (``--gang llama-drain``): the Llama
driver at 7B, full width (S = 1,024, LoRA rank 16, a global batch of 12
over 12 source partitions, 8 steps) at fsdp=N under the port's
``Supervisor`` with ``DLS_FAULT=sigterm@4`` on host 1: the live engine
pulls every FSDP2 shard chunk by chunk to rank 0 (bounded bytes in flight,
what arrived checked against each rank's own blake2b digests), which
writes the handoff, and the relaunch at fsdp=N-1 (every
leaf whole on every card: no dim of 7B divides by 3) ingests it, digests
checked, and runs steps 5–8 with K1/K2/K3 64/32/32 a step on both sides
of the drain; its losses an uninterrupted fsdp=N run's at a stated
tolerance; beside it the same gang's ``die_host@6`` walk-back through a
checkpoint every 4 steps; the drain's gather, digest and write, the
handoff's bytes, rounds and peak bytes in flight, the ingest, and each
relaunch's seconds to its first step and its steps lost.
Then config 5 pipelined over the ``pipe`` axis (``--gang llama-pp``, four
cards): the driver's session, data and trainer at 7B, full width (b = 8,
S = 1,024, LoRA rank 16) at pipe=4 with M = 2, 4 and 8 microbatches, at
fsdp=2 × pipe=2 and pipe=2 × tensor=2 with M = 4, and on one card, on the
same batches, each rank's first step's FLOPs measured; the 2-layer full
fine-tune at pipe=2 and on one card; held: losses and grad norms one
card's, K1/K2/K3 2·(L/P)·M, (L/P)·M and (L/P)·M a step a card, the bytes
each card sends stage to stage and in the bank's broadcast as reckoned,
resident param bytes the rule engine's (3,770,957,824 B a card at
pipe=4), the measured FLOPs one card's, and four planted faults that must
each break a limit; each card's step ms, tokens/s, host ms issuing a step,
and busy share in a profiled window beside the bubble (P − 1)/(M + P − 1).
``--gang llama-pp-steps`` runs its layouts and one card only.
Then config 5 as an MPMD pipeline (``--gang llama-mpmd``, four cards: one
process a stage, one card a stage, activations and gradients over the
authenticated socket transport, ``PipelineSupervisor``): (a) the 7B full
fine-tune (every param trainable, AdamW, b = 8, S = 1,024, M = 4, 6
steps, GPipe-exact) through the supervisor and the built-in stage worker
against the port's GPipe ``Trainer`` at pipe=4 on the same weights and
batches; (b) the same in 1F1B against (a); (c) the 7B widths at 4 layers
under SGD, a thread a stage in this process, against one card's
``Trainer`` (losses and each param's change) and a repeat (bitwise); three
planted faults at (c)'s size that must each break a limit; (d) the kill
drill at (c)'s size (``die_host@5`` on stage 1: only it restarts). Then
stages of two cards, each stage a ``torch.distributed`` gang of one
process a card (NCCL): K1–K3 at a tensor=2 card's shape (16 heads, 2
rows) beside SDPA; (e) the 7B over two stages, stage 0 FSDP2 at fsdp=2 and
stage 1 the Megatron splits at tensor=2, 1F1B, against (b)'s losses, the
layouts checked; (f) ``exact`` at data=2 both stages (the 7B widths at 8
layers) bitwise the port's GPipe ``Trainer`` at data=2 × pipe=2; (g) the
7B widths at 4 layers under SGD (f32 compute), stage 1 restored from the
data=2 run's step-2 checkpoint at tensor=2, its losses the uninterrupted
run's at 1e-5; (h) the kill drill on a gang (``die_host@5`` on rank 1 of
stage 1: only stage 1's two processes are relaunched, bitwise); then the
port's ``examples/train_llama_mpmd.py`` at its defaults (two stages of
two cards). Held beside: K1/K2/K3 64/32/32 a step a stage and
67,108,864 B a step each way on each link in (a) and (b), and in (e)/(f)
K1/K2/K3 a step a card, the link's bytes, the gang's scatter, gather and
broadcast bytes a step, params a card, peak memory below the card's;
printed: each stage's ms a step, tokens/s a card, the transport's ms a
microbatch (device → host, send, host → device), the gang's collective
ms a move, the measured bubble against 3/7 (1/5 for two stages) and the
drills' seconds from the kill to the next step.
``--gang dlrm`` (or ``resnet``, ``llama``, ``llama-cp``, ``llama-drain``,
``llama-moe``, ``llama-pp``, ``llama-mpmd``) runs that part's comparisons only (names
combine), ``--gang llama-mpmd-stages`` (e)–(h) and the driver only (with
its own (b) run), ``--gang recovery`` the shrink, the drain and the desync only.
``python3 chip_smoke.py --recovery`` builds the kernels and runs phases 11
and 14 only (one card); ``--observe`` builds them and runs phases 5 and 6b
and the observed ResNet driver only (one card). ``python3 chip_smoke.py --ckpt-commit TREE``
measures the supervised crash drill's race with TREE's package (one card):
how long the LeNet checkpoint's asynchronous write takes to commit against
the steps a ``crash@8`` kill leaves it. ``python3 chip_smoke.py --input-ab`` times BERT-base, ResNet-50 and the
DLRM through ``Trainer.fit`` with their batches built in the prefetch
thread and in the loop's thread, in turns (one card). ``python3
chip_smoke.py --loop-ab A B B A`` times the unguarded LeNet-5 and DLRM
train loops through the package of each checkout root named, in that
order, each in a process of its own (one card; for a parent commit
unpacked under ``build/`` against this tree).

Exits non-zero, printing no result, when CUDA is absent, when the port's
package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "distributeddeeplearningspark_tpu_torch"

# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# bf16 output (8-bit mantissa) of P rounded to bf16 at running maxima that
# differ between the tiled kernel and the one-pass plain version
O_ATOL, O_RTOL = 1e-2, 1e-2
# f32 log-sum-exp, sums taken in another order (exp2 in the kernel)
LSE_ATOL = 1e-3
# served logits vs the one-request reference forward: bf16 activations
# through 12 post-LN layers, where the batch size changes cuBLAS's tiling
# and so the rounding of every projection
SERVE_ATOL = 0.1
# the first layer's attention output within a served batch vs the plain
# path on the same inputs, relative to its largest value: only the
# attention core differs (bf16 P and O rounded at other points), while a
# wrong tile or an ignored padding mask moves rows by their own magnitude
ATTN_RTOL = 0.02
# K2/K3 gradients vs the plain backward in f32 on the same inputs, per
# element: |g - ref| <= GRAD_TOL*max|ref| + GRAD_TOL*|ref|. The kernels round
# P and dS to bf16 as mma operands (the plain version keeps them in f32) and
# sum over 512-2048 rows in another order, so an element's error scales with
# the gradient's overall size, not only with its own value
GRAD_TOL = 0.02
# BERT-base parameter gradients through the kernels vs the plain attention
# path on one batch, same weights, dropout off, per tensor (Frobenius):
# |g - g_ref| <= PARITY_RTOL*|g_ref| + PARITY_ATOL*|G_ref|, G the whole
# gradient. Both run bf16 activations and differ only in where the attention
# core rounds: the kernels take delta = rowsum(dO*O) from the bf16 output O
# (as FlashAttention and the Pallas kernels do), the plain path's autograd
# sums P*dP in f32. Where a layer's true q/k gradient is near 0 (the key
# bias's is exactly 0: softmax ignores a shift shared by every key), that
# rounding is all there is, so such tensors are held to a small share of
# the whole gradient instead of to their own size
PARITY_RTOL = 2e-2
PARITY_ATOL = 1e-4
# the last logged training loss must be below this fraction of the first
LOSS_DROP = 0.9
# ResNet-50 training: steps and batch (b=256, BASELINE.json config 2's batch)
RESNET_STEPS, RESNET_BATCH = 20, 256
# LeNet-5 (config 1): steps, batch and checkpoint interval of
# examples/train_mnist.py, and where the resume launch runs to
LENET_STEPS, LENET_BATCH, LENET_EVERY, LENET_RESUME_TO = 150, 64, 25, 200
# DLRM (config 4): 26 features of 100,000 rows each, batch 8,192
DLRM_VOCABS = (100_000,) * 26
DLRM_STEPS, DLRM_BATCH = 20, 8192
# H100 SXM data-sheet peak of f32 outside the tensor cores (K5's adds)
PEAK_F32_FLOPS = 67e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, between CUDA
    events; for calls long enough that the host keeps ahead of the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed, so that the host's cost per call (Python, ctypes,
    allocation) is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: autograd runs a backward on its own thread, which the
    # default (global) mode would refuse during the capture
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile, the definition ``dlstatus`` uses."""
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(round(q * (len(sorted_vals) - 1))))]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# -- phase 2: K1 against its plain version -----------------------------------


def _attn_case(torch, name, *, b, s, h, hkv, d, causal, lengths=None,
               doc_starts=None, seed=0):
    """Inputs of one K1 case, made on the card from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(b, s, heads, d, device="cuda",  # noqa: E731
                                   generator=gen, dtype=torch.float32
                                   ).to(torch.bfloat16)
    case = dict(name=name, q=mk(h), k=mk(hkv), v=mk(hkv), causal=causal,
                kv_mask=None, segs=None)
    if lengths is not None:
        pos = torch.arange(s, device="cuda")[None, :]
        case["kv_mask"] = (pos < torch.tensor(lengths, device="cuda")[:, None]
                           ).to(torch.int32).contiguous()
    if doc_starts is not None:
        segs = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        for i, starts in enumerate(doc_starts):
            for doc, st in enumerate(starts):
                segs[i, st:] = doc
        if case["kv_mask"] is not None:
            segs = torch.where(case["kv_mask"] != 0, segs, -1)
        case["segs"] = segs.contiguous()
    return case


def _attn_work(torch, case) -> tuple[int, int]:
    """The (q row, key) pairs the case's masks allow, and the keys that some
    q row may attend, each summed over batch: the products and the K/V rows
    that this run's data needs."""
    b, s = case["q"].shape[:2]
    allowed = torch.ones(b, s, s, dtype=torch.bool, device="cuda")
    if case["causal"]:
        allowed &= torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    if case["kv_mask"] is not None:
        allowed &= (case["kv_mask"] != 0)[:, None, :]
    if case["segs"] is not None:
        allowed &= case["segs"][:, :, None] == case["segs"][:, None, :]
    return int(allowed.sum()), int(allowed.any(dim=1).sum())


def _bound(torch, case) -> tuple[float, str]:
    """The card's least time for the forward: q, the masks and the K/V rows
    of keys that some q row may attend read once, o and LSE written once,
    and the two products over the allowed pairs."""
    q, k = case["q"], case["k"]
    b, s, h, d = q.shape
    pairs, keys = _attn_work(torch, case)
    nbytes = 2 * q.numel() * 2 + 2 * keys * k.shape[2] * d * 2 + b * h * s * 4
    for t in (case["kv_mask"], case["segs"]):
        if t is not None:
            nbytes += t.numel() * 4 * (2 if t is case["segs"] else 1)
    flops = 4 * d * h * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _every_key_allowed(case) -> bool:
    """A key mask of all ones and no segments: the function is then also one
    SDPA call without a mask, which may take a faster backend."""
    return (case["kv_mask"] is not None and case["segs"] is None
            and bool((case["kv_mask"] != 0).all()))


def _library_call(torch, case, masked: bool = True):
    """``fn(q, k, v)``: one ``scaled_dot_product_attention`` call over BSHD
    inputs (BHSD views), with the case's masks as a boolean attend-mask
    made once (none when ``masked`` is false)."""
    import torch.nn.functional as F

    mask = None
    if masked and case["kv_mask"] is not None:
        mask = (case["kv_mask"] != 0)[:, None, None, :]
    if masked and case["segs"] is not None:
        same = (case["segs"][:, None, :, None] == case["segs"][:, None, None, :])
        mask = same if mask is None else mask & same
    gqa = case["q"].shape[2] != case["k"].shape[2]
    return lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        is_causal=case["causal"] and mask is None, enable_gqa=gqa)


def _llama_tp_cases(torch) -> list[dict]:
    """The Llama-2 7B step's attention on one card of a tensor-parallel
    gang (``--gang llama``), each card holding 32/T heads: at fsdp=2 ×
    tensor=2, b = 4 a card and 16 heads; at tensor=4, b = 8 and 8 heads."""
    return [_attn_case(torch, f"llama_tp{t}_b{b}_s1024_h{LLAMA_HEADS // t}_causal_d128",
                       b=b, s=LLAMA_SEQ, h=LLAMA_HEADS // t, hkv=LLAMA_HEADS // t,
                       d=128, causal=True, seed=10 + t)
            for t, b in LLAMA_TP_SHAPES]


def _llama_pp_cases(torch) -> list[dict]:
    """The Llama-2 7B step's attention on a stage of a pipelined gang
    (``--gang llama-pp``): one microbatch, 32 heads, b = 2 rows at M = 4
    and b = 1 at M = 8 (and at fsdp=2 × pipe=2, M = 4)."""
    return [_attn_case(torch, f"llama_pp_b{b}_s1024_causal_d128", b=b, s=LLAMA_SEQ,
                       h=LLAMA_HEADS, hkv=LLAMA_HEADS, d=128, causal=True, seed=20 + b)
            for b in LLAMA_PP_MICRO_ROWS]


def _llama_mpmd_cases(torch) -> list[dict]:
    """The Llama-2 7B step's attention on a card of a tensor=2 MPMD stage
    (``--gang llama-mpmd`` (e)): 16 local heads on a microbatch of 2 rows
    (b = 8 in M = 4)."""
    return [_attn_case(torch, f"llama_mpmd_tp2_b{LLAMA_BATCH // MPMD_MICRO}_s1024_h"
                              f"{LLAMA_HEADS // 2}_causal_d128",
                       b=LLAMA_BATCH // MPMD_MICRO, s=LLAMA_SEQ, h=LLAMA_HEADS // 2,
                       hkv=LLAMA_HEADS // 2, d=128, causal=True, seed=30)]


def check_flash_fwd(torch, fa, cases: list | None = None) -> list[dict]:
    cases = cases or [
        _attn_case(torch, "bert_b32_padded", b=32, s=512, h=12, hkv=12, d=64,
                   causal=False, seed=1,
                   lengths=np.random.default_rng(1).integers(1, 513, 32).tolist()),
        _attn_case(torch, "causal_gqa_d128", b=2, s=2048, h=32, hkv=8, d=128,
                   causal=True, seed=2),
        _attn_case(torch, "segments_and_padding", b=8, s=512, h=12, hkv=12,
                   d=64, causal=False, seed=3,
                   lengths=[512, 400, 300, 512, 128, 77, 511, 256],
                   doc_starts=[[0, 100, 300], [0, 50], [0], [0, 256],
                               [0, 64], [0, 10, 20], [0, 255], [0, 128]]),
        _attn_case(torch, "fully_masked_row", b=4, s=512, h=12, hkv=12, d=64,
                   causal=False, seed=4, lengths=[512, 300, 0, 77]),
        # where BERT training's 360 launches run: every key allowed
        _attn_case(torch, "bert_train_b32", b=32, s=512, h=12, hkv=12, d=64,
                   causal=False, seed=5, lengths=[512] * 32),
        # S not a multiple of the 128-row tile: the last tile's rows past S
        # must read as zeros, not as the next sequence's rows
        _attn_case(torch, "ragged_s320", b=4, s=320, h=12, hkv=12, d=64,
                   causal=False, seed=6),
        _attn_case(torch, "ragged_s320_causal_gqa_d128", b=4, s=320, h=8,
                   hkv=2, d=128, causal=True, seed=7),
        # whole key tiles that no q row may attend: padding past the first
        # 128 keys, and documents whose segment ranges miss a q tile's
        _attn_case(torch, "skip_tiles", b=4, s=1024, h=12, hkv=12, d=64,
                   causal=False, seed=8, lengths=[128, 1024, 1024, 700],
                   doc_starts=[[0], [0, 256, 512, 768], [0, 384],
                               [0, 128, 640]]),
        # where the Llama-2 7B fine-tune's launches run: causal, D = 128
        _attn_case(torch, "llama_b8_s1024_causal_d128", b=LLAMA_BATCH,
                   s=LLAMA_SEQ, h=32, hkv=32, d=128, causal=True, seed=10),
        # each card's local heads under tensor parallelism (--gang llama)
        *_llama_tp_cases(torch),
        # a pipeline stage's microbatches (--gang llama-pp)
        *_llama_pp_cases(torch),
        # a tensor=2 MPMD stage's microbatches (--gang llama-mpmd)
        *_llama_mpmd_cases(torch),
        # the MoE 0.9b's: 16 q heads over 8 kv heads
        _moe_09b_case(torch),
    ]
    results = []
    for c in cases:
        s, d = c["q"].shape[1], c["q"].shape[3]
        kw = dict(kv_mask=c["kv_mask"], q_segs=c["segs"], kv_segs=c["segs"],
                  scale=d ** -0.5, causal=c["causal"])
        o, lse = fa.flash_fwd(c["q"], c["k"], c["v"], **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_reference(c["q"], c["k"], c["v"],
                                                      **kw)
        err = (o.float() - o_ref.float()).abs()
        tol = O_ATOL + O_RTOL * o_ref.float().abs()
        lse_err = float((lse - lse_ref).abs().max())
        masked_rows = lse_ref == fa.MASK_VALUE
        ok = (bool(torch.isfinite(o.float()).all()) and bool((err <= tol).all())
              and lse_err <= LSE_ATOL
              and bool((lse[masked_rows] == fa.MASK_VALUE).all()))
        if c["name"] == "fully_masked_row":
            ok = ok and bool((o[2] == 0).all()) and bool(masked_rows.any())
        fwd = lambda: fa.flash_fwd(c["q"], c["k"], c["v"], **kw)  # noqa: E731
        sdpa = _library_call(torch, c)
        plain = lambda: fa.flash_attention_reference(  # noqa: E731
            c["q"], c["k"], c["v"], **kw)
        bound_ms, bound_by = _bound(torch, c)
        rec = dict(case=c["name"], shape=list(c["q"].shape),
                   kv_heads=c["k"].shape[2], max_abs_err=float(err.max()),
                   tolerance=f"|o-ref| <= {O_ATOL} + {O_RTOL}*|ref|, "
                             f"|lse-ref| <= {LSE_ATOL}",
                   lse_max_abs_err=lse_err, ok=ok,
                   ms=graph_ms(torch, fwd, 20),
                   plain_ms=graph_ms(torch, plain, 3),
                   library_ms=graph_ms(torch, lambda: sdpa(c["q"], c["k"], c["v"]),
                                       20),
                   library_unmasked_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by)
        if _every_key_allowed(c):
            unmasked = _library_call(torch, c, masked=False)
            rec["library_unmasked_ms"] = graph_ms(
                torch, lambda: unmasked(c["q"], c["k"], c["v"]), 20)
        print("K1 flash_fwd " + json.dumps(rec), flush=True)
        check(ok, f"flash_fwd disagrees with its plain version on {c['name']}")
        results.append(rec)
        del o, lse, o_ref, lse_ref, err, tol
        torch.cuda.empty_cache()
    return results


# -- phase 3: K2/K3 against the plain backward ---------------------------------


def _bwd_bound(torch, case, products: int, outputs) -> tuple[float, str]:
    """The card's least time for ``products`` [S, S]x[S, D] products per
    head over the allowed pairs, reading q, dO, LSE, delta and the K/V rows
    of keys that some q row may attend once and writing ``outputs`` once."""
    q, k = case["q"], case["k"]
    b, s, h, d = q.shape
    pairs, keys = _attn_work(torch, case)
    nbytes = (2 * q.numel() + 2 * keys * k.shape[2] * d) * 2 + 2 * b * h * s * 4
    nbytes += sum(t.numel() * t.element_size() for t in outputs)
    for t in (case["kv_mask"], case["segs"]):
        if t is not None:
            nbytes += t.numel() * 4 * (2 if t is case["segs"] else 1)
    flops = products * 2 * d * h * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_bwd_ms(torch, case, do, masked: bool = True) -> float:
    """SDPA's backward as a yardstick the port never calls: a CUDA-graph
    replay of its forward and backward minus one of its forward alone."""
    sdpa = _library_call(torch, case, masked)
    # the output gradient in SDPA's own (BHSD) layout, made once outside the
    # timed calls, as K2/K3 are handed theirs in BSHD
    do_bhsd = do.transpose(1, 2).contiguous()

    def fwd_bwd():
        # fresh leaves per call, so that autograd ties them to the stream the
        # call runs on (a side stream while warming up, then the capture's)
        q, k, v = (t.detach().requires_grad_()
                   for t in (case["q"], case["k"], case["v"]))
        torch.autograd.grad(sdpa(q, k, v), (q, k, v), do_bhsd)

    with torch.no_grad():
        fwd_ms = graph_ms(torch, lambda: sdpa(case["q"], case["k"], case["v"]), 20)
    return graph_ms(torch, fwd_bwd, 20) - fwd_ms


def check_flash_bwd(torch, fa, cases: list | None = None) -> list[dict]:
    cases = cases or [
        _attn_case(torch, "bert_b32_full_mask", b=32, s=512, h=12, hkv=12,
                   d=64, causal=False, seed=5, lengths=[512] * 32),
        _attn_case(torch, "bert_b32_padded", b=32, s=512, h=12, hkv=12, d=64,
                   causal=False, seed=1,
                   lengths=np.random.default_rng(1).integers(1, 513, 32).tolist()),
        _attn_case(torch, "causal_gqa_d128", b=2, s=2048, h=32, hkv=8, d=128,
                   causal=True, seed=2),
        _attn_case(torch, "segments_and_padding", b=8, s=512, h=12, hkv=12,
                   d=64, causal=False, seed=3,
                   lengths=[512, 400, 300, 512, 128, 77, 511, 256],
                   doc_starts=[[0, 100, 300], [0, 50], [0], [0, 256],
                               [0, 64], [0, 10, 20], [0, 255], [0, 128]]),
        _attn_case(torch, "fully_masked_row", b=4, s=512, h=12, hkv=12, d=64,
                   causal=False, seed=4, lengths=[512, 300, 0, 77]),
        # K1's tile edges: the last q and key tiles' rows past S (read as
        # zeros, not as the next sequence), at D = 64 and at D = 128 causal
        # GQA, and whole tiles skipped by padding and by segments
        _attn_case(torch, "ragged_s320", b=4, s=320, h=12, hkv=12, d=64,
                   causal=False, seed=6),
        _attn_case(torch, "ragged_s320_causal_gqa_d128", b=4, s=320, h=8,
                   hkv=2, d=128, causal=True, seed=7),
        _attn_case(torch, "skip_tiles", b=4, s=1024, h=12, hkv=12, d=64,
                   causal=False, seed=8, lengths=[128, 1024, 1024, 700],
                   doc_starts=[[0], [0, 256, 512, 768], [0, 384],
                               [0, 128, 640]]),
        # S not a multiple of 4: no [B*H, S] f32 row of LSE or delta past
        # the first is 16-byte aligned
        _attn_case(torch, "ragged_s322_padding", b=4, s=322, h=12, hkv=12,
                   d=64, causal=False, seed=9, lengths=[322, 200, 1, 130]),
        # the Llama-2 7B fine-tune's shape: causal, D = 128
        _attn_case(torch, "llama_b8_s1024_causal_d128", b=LLAMA_BATCH,
                   s=LLAMA_SEQ, h=32, hkv=32, d=128, causal=True, seed=10),
        *_llama_tp_cases(torch),
        *_llama_pp_cases(torch),
        *_llama_mpmd_cases(torch),
        _moe_09b_case(torch),
    ]
    results = []
    for c in cases:
        s, d = c["q"].shape[1], c["q"].shape[3]
        kw = dict(kv_mask=c["kv_mask"], q_segs=c["segs"], kv_segs=c["segs"],
                  scale=d ** -0.5, causal=c["causal"])
        gen = torch.Generator(device="cuda").manual_seed(100 + len(results))
        do = torch.randn(c["q"].shape, device="cuda", generator=gen
                         ).to(torch.bfloat16)
        o, lse = fa.flash_fwd(c["q"], c["k"], c["v"], **kw)
        grads = fa.flash_bwd(c["q"], c["k"], c["v"], o, lse, do, **kw)
        torch.cuda.synchronize()
        refs = fa.flash_attention_backward_reference(
            c["q"], c["k"], c["v"], o, lse, do, **kw)
        errs, ok = {}, True
        for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
            g, ref = g.float(), ref.float()
            err = (g - ref).abs()
            tol = GRAD_TOL * float(ref.abs().max()) + GRAD_TOL * ref.abs()
            errs[name] = float(err.max())
            errs[name + "_ref_max"] = float(ref.abs().max())
            ok = ok and bool(torch.isfinite(g).all()) and bool((err <= tol).all())
        if c["name"] == "fully_masked_row":
            ok = ok and all(bool((g[2] == 0).all()) for g in grads)
        delta = fa._delta(o, do).contiguous()
        k2 = lambda: fa.flash_bwd_dq(c["q"], c["k"], c["v"], do, lse,  # noqa: E731
                                     delta, **kw)
        k3 = lambda: fa.flash_bwd_dkv(c["q"], c["k"], c["v"], do, lse,  # noqa: E731
                                      delta, **kw)
        # no atomics: two runs on the same inputs give the same bits
        again = (k2(), *k3())
        deterministic = all(bool(torch.equal(a, b))
                            for a, b in zip(grads, again))
        ok = ok and deterministic
        plain = lambda: fa.flash_attention_backward_reference(  # noqa: E731
            c["q"], c["k"], c["v"], o, lse, do, **kw)
        whole = lambda: fa.flash_bwd(c["q"], c["k"], c["v"], o, lse, do,  # noqa: E731
                                     **kw)
        dq_bound = _bwd_bound(torch, c, 3, grads[:1])
        dkv_bound = _bwd_bound(torch, c, 4, grads[1:])
        pair_bound = _bwd_bound(torch, c, 5, grads)
        rec = dict(case=c["name"], shape=list(c["q"].shape),
                   kv_heads=c["k"].shape[2], **errs,
                   tolerance=f"|g-ref| <= {GRAD_TOL}*max|ref| + "
                             f"{GRAD_TOL}*|ref|", ok=ok,
                   deterministic=deterministic,
                   dq_ms=graph_ms(torch, k2, 20),
                   dkv_ms=graph_ms(torch, k3, 20),
                   delta_ms=graph_ms(torch, lambda: fa._delta(o, do), 20),
                   flash_bwd_ms=graph_ms(torch, whole, 20),
                   plain_ms=graph_ms(torch, plain, 3),
                   library_ms=_library_bwd_ms(torch, c, do),
                   library_unmasked_ms=(_library_bwd_ms(torch, c, do, False)
                                        if _every_key_allowed(c) else None),
                   dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
                   dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
                   pair_bound_ms=pair_bound[0], pair_bound_by=pair_bound[1])
        print("K2/K3 flash_bwd " + json.dumps(rec), flush=True)
        check(ok, f"flash_bwd disagrees with its plain version on {c['name']}")
        results.append(rec)
        del o, lse, grads, refs, do, delta, again
        torch.cuda.empty_cache()
    return results


# -- phase 3b: the ring's per-hop compute on one card -----------------------------

#: context parallelism at four cards (``--gang llama``): Llama-2 7B's 32
#: heads, b = 4 of S = 4,096 (Llama-2's max_position) split into 4 blocks
CP_BATCH, CP_SEQ, CP_DEGREE = 4, 4096, 4


def _cp_inputs(torch):
    """q, k, v and dO at b=4, S=4,096, 32 heads, D = 128 (bf16), and packed
    segment ids whose documents cross the blocks' boundaries, so that a hop
    meets q and kv ids that differ."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    mk = lambda: torch.randn(CP_BATCH, CP_SEQ, LLAMA_HEADS, 128, device="cuda",  # noqa: E731
                             generator=gen).to(torch.bfloat16)
    segs = torch.zeros(CP_BATCH, CP_SEQ, dtype=torch.int32, device="cuda")
    for i, starts in enumerate([[0, 700, 1500, 3000], [0, 2048], [0],
                                [0, 1023, 1025, 3077]]):
        for doc, st in enumerate(starts):
            segs[i, st:] = doc
    return dict(q=mk(), k=mk(), v=mk(), do=mk(), segs=segs.contiguous())


def _ring_on_one_card(torch, fa, ra, x, use_flash: bool) -> dict:
    """Every hop of a CP_DEGREE-way ring split, in turn on this card (the
    per-hop compute of ``ops.ring_attention`` without its exchange): each
    rank's forward merged on the LSE, then its backward with the merged LSE
    and ``delta``, the dK/dV of each block summed over the ranks whose hops
    met it. The whole sequence's o, lse [B·H, S], dq, dk and dv."""
    n, sl = CP_DEGREE, CP_SEQ // CP_DEGREE
    blk = lambda t, j: t[:, j * sl:(j + 1) * sl].contiguous()  # noqa: E731
    scale = 128 ** -0.5
    outs, lses, dqs = [], [], []
    dk = torch.zeros(x["k"].shape, dtype=torch.float32, device="cuda")
    dv = torch.zeros_like(dk)
    for r in range(n):
        q, do, qs = blk(x["q"], r), blk(x["do"], r), blk(x["segs"], r)
        acc = None
        hops = [(i, (r + i) % n) for i in range(n) if ra.hop_active(r, i, n, True)]
        for i, j in hops:
            acc = ra.merge(acc, *ra.hop_forward(
                q, blk(x["k"], j), blk(x["v"], j), q_segs=qs, kv_segs=blk(x["segs"], j),
                scale=scale, causal=i == 0, use_flash=use_flash))
        o, lse = acc[0].to(torch.bfloat16), acc[1]
        delta = fa._delta(o, do).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
        for i, j in hops:
            g = ra.hop_backward(q, blk(x["k"], j), blk(x["v"], j), do, lse, delta,
                                q_segs=qs, kv_segs=blk(x["segs"], j), scale=scale,
                                causal=i == 0, use_flash=use_flash)
            dq += g[0].float()
            dk[:, j * sl:(j + 1) * sl] += g[1].float()
            dv[:, j * sl:(j + 1) * sl] += g[2].float()
        outs.append(o)
        lses.append(lse.view(CP_BATCH, LLAMA_HEADS, sl))
        dqs.append(dq)
    return dict(o=torch.cat(outs, 1), lse=torch.cat(lses, 2).reshape(-1, CP_SEQ),
                dq=torch.cat(dqs, 1), dk=dk, dv=dv)


def _cp_kernel_times(torch, fa) -> list[dict]:
    """K1, K2 and K3 where context parallelism runs them on the card: a
    ring hop (b=4, 1,024 q rows against a block of 1,024 keys, every key
    allowed, 32 heads) and Ulysses' full sequence on a head slice (b=4,
    S=4,096, causal, 8 heads); each beside SDPA and its bound."""
    cases = [
        _attn_case(torch, "ring_hop_b4_s1024_h32_d128", b=CP_BATCH,
                   s=CP_SEQ // CP_DEGREE, h=LLAMA_HEADS, hkv=LLAMA_HEADS, d=128,
                   causal=False, seed=41),
        _attn_case(torch, "ulysses_b4_s4096_h8_causal_d128", b=CP_BATCH, s=CP_SEQ,
                   h=LLAMA_HEADS // CP_DEGREE, hkv=LLAMA_HEADS // CP_DEGREE, d=128,
                   causal=True, seed=42),
    ]
    out = []
    for c in cases:
        kw = dict(scale=128 ** -0.5, causal=c["causal"])
        gen = torch.Generator(device="cuda").manual_seed(43)
        do = torch.randn(c["q"].shape, device="cuda", generator=gen).to(torch.bfloat16)
        o, lse = fa.flash_fwd(c["q"], c["k"], c["v"], **kw)
        delta = fa._delta(o, do).contiguous()
        sdpa = _library_call(torch, c)
        fwd_bound = _bound(torch, c)
        dq_bound = _bwd_bound(torch, c, 3, (c["q"],))
        dkv_bound = _bwd_bound(torch, c, 4, (c["k"], c["v"]))
        rec = dict(
            case=c["name"], shape=list(c["q"].shape), causal=c["causal"],
            fwd_ms=graph_ms(torch, lambda: fa.flash_fwd(c["q"], c["k"], c["v"], **kw), 20),
            fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
            fwd_library_ms=graph_ms(torch, lambda: sdpa(c["q"], c["k"], c["v"]), 20),
            fwd_plain_ms=graph_ms(torch, lambda: fa.flash_attention_reference(
                c["q"], c["k"], c["v"], **kw), 3),
            dq_ms=graph_ms(torch, lambda: fa.flash_bwd_dq(
                c["q"], c["k"], c["v"], do, lse, delta, **kw), 20),
            dq_bound_ms=dq_bound[0], dq_bound_by=dq_bound[1],
            dkv_ms=graph_ms(torch, lambda: fa.flash_bwd_dkv(
                c["q"], c["k"], c["v"], do, lse, delta, **kw), 20),
            dkv_bound_ms=dkv_bound[0], dkv_bound_by=dkv_bound[1],
            bwd_plain_ms=graph_ms(torch, lambda: fa.flash_attention_backward_reference(
                c["q"], c["k"], c["v"], o, lse, do, **kw), 3),
            bwd_library_ms=_library_bwd_ms(torch, c, do))
        print("CP kernels " + json.dumps(rec), flush=True)
        out.append(rec)
        del o, lse, delta, do
        torch.cuda.empty_cache()
    return out


def check_ring_hops(torch, fa, ra) -> dict:
    """The ring's per-hop compute for a CP_DEGREE-way split of b=4, S=4,096,
    32 heads, D = 128, every hop in turn on this card: K1 causal on the
    diagonal and non-causal on the earlier blocks with distinct q/kv
    segment ids, merged on the LSE; K2/K3 with the merged LSE and
    ``delta``. Held against the whole sequence's K1 and K2/K3 (causal, the
    same segment ids) and against the same hops on the kernels' plain
    versions, at K1's and K2/K3's tolerances; the inactive hops launch
    nothing (1 + r hops for the rank at index r: 10 launches of each
    kernel). Then the kernels' times at the hop's and at Ulysses' shapes."""
    x = _cp_inputs(torch)
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [k.launches for k in kernels]
    ring = _ring_on_one_card(torch, fa, ra, x, use_flash=True)
    torch.cuda.synchronize()
    launches = [k.launches - b for k, b in zip(kernels, before)]
    want_launches = [sum(1 + r for r in range(CP_DEGREE))] * 3
    kw = dict(q_segs=x["segs"], kv_segs=x["segs"], scale=128 ** -0.5, causal=True)
    o, lse = fa.flash_fwd(x["q"], x["k"], x["v"], **kw)
    whole = dict(o=o, lse=lse, **dict(zip(("dq", "dk", "dv"), fa.flash_bwd(
        x["q"], x["k"], x["v"], o, lse, x["do"], **kw))))
    plain = _ring_on_one_card(torch, fa, ra, x, use_flash=False)
    errs, ok = {}, launches == want_launches
    for ref_name, ref in (("whole", whole), ("plain", plain)):
        o_err = (ring["o"].float() - ref["o"].float()).abs()
        lse_err = float((ring["lse"] - ref["lse"]).abs().max())
        errs[f"o_vs_{ref_name}"] = float(o_err.max())
        errs[f"lse_vs_{ref_name}"] = lse_err
        ok = ok and bool((o_err <= O_ATOL + O_RTOL * ref["o"].float().abs()).all())
        ok = ok and lse_err <= LSE_ATOL
        for g in ("dq", "dk", "dv"):
            got, want = ring[g].float(), ref[g].float()
            err = (got - want).abs()
            errs[f"{g}_vs_{ref_name}"] = float(err.max())
            ok = ok and bool(torch.isfinite(got).all()) and bool(
                (err <= GRAD_TOL * float(want.abs().max()) + GRAD_TOL * want.abs()).all())
    rec = dict(shape=[CP_BATCH, CP_SEQ, LLAMA_HEADS, 128], degree=CP_DEGREE,
               launches=dict(zip((k.__name__ for k in kernels), launches)),
               want_launches=want_launches[0], **errs,
               tolerance=f"o: |o-ref| <= {O_ATOL} + {O_RTOL}*|ref|, lse <= {LSE_ATOL}; "
                         f"grads: |g-ref| <= {GRAD_TOL}*max|ref| + {GRAD_TOL}*|ref|",
               ok=ok)
    print("CP ring hops " + json.dumps(rec), flush=True)
    check(ok, f"the ring's per-hop K1-K3 disagree with the whole sequence's or the "
              f"plain hops, or launched other than {want_launches}: {rec}")
    del x, ring, whole, plain, o, lse
    torch.cuda.empty_cache()
    rec["times"] = _cp_kernel_times(torch, fa)
    return rec


def check_gates(torch, fa, attention, cb) -> None:
    """The dispatch sends the kernels only what they take: "auto" picks the
    plain path for f32 and for head dims the kernels are not built for, an
    f32 ``Conv1x1BN`` and a bf16 one whose widths are not multiples of 8
    (K4's 16-byte rule) train through the unfused chain; the wrappers
    still raise on such inputs (a gate, not a fallback)."""
    mk = lambda d, dtype: torch.zeros(1, 512, 2, d, device="cuda",  # noqa: E731
                                      dtype=dtype)
    picks = {f"{str(dt).split('.')[-1]}_d{d}": attention._pick_impl(
        mk(d, dt), mk(d, dt), None, None)
        for dt, d in ((torch.bfloat16, 64), (torch.bfloat16, 128),
                      (torch.float32, 64), (torch.bfloat16, 32),
                      (torch.bfloat16, 96), (torch.bfloat16, 256))}
    check(picks == {"bfloat16_d64": "flash", "bfloat16_d128": "flash",
                    "float32_d64": "xla", "bfloat16_d32": "xla",
                    "bfloat16_d96": "xla", "bfloat16_d256": "xla"},
          f"attention gate picks {picks}")
    raised = []
    for d, dtype, exc in ((64, torch.float32, TypeError),
                          (32, torch.bfloat16, ValueError)):
        try:
            fa.flash_fwd(mk(d, dtype), mk(d, dtype), mk(d, dtype), scale=1.0)
        except exc:
            raised.append(f"flash_fwd {dtype} d={d}")
    x32 = torch.zeros(512, 64, device="cuda")
    try:
        cb.matmul_stats(x32, torch.zeros(64, 64, device="cuda"))
    except TypeError:
        raised.append("matmul_stats float32")
    try:  # K and N off a multiple of 8: TMA's 16-byte rows
        cb.matmul_stats(torch.zeros(48, 13, device="cuda", dtype=torch.bfloat16),
                        torch.zeros(13, 24, device="cuda", dtype=torch.bfloat16))
    except ValueError:
        raised.append("matmul_stats (48, 13, 24)")
    check(len(raised) == 4, f"wrappers raised only for {raised}")
    unfused = {}
    for cin, cout, dtype in ((64, 64, torch.float32), (13, 24, torch.bfloat16)):
        mod = cb.Conv1x1BN(cin, cout, dtype=dtype, device="cuda")
        torch.nn.init.normal_(mod.kernel, std=0.1)
        mod.train()
        x = torch.randn(4, cin, 8, 8, device="cuda").contiguous(
            memory_format=torch.channels_last)
        before = cb.matmul_stats.launches
        out = mod(x)
        out.float().sum().backward()
        torch.cuda.synchronize()
        name = f"{str(dtype).split('.')[-1]}_{cin}x{cout}"
        unfused[name] = (cb.matmul_stats.launches == before
                         and bool(torch.isfinite(out.float()).all())
                         and out.dtype == dtype
                         and bool(torch.isfinite(mod.kernel.grad).all()))
    check(all(unfused.values()),
          f"Conv1x1BN must train through the unfused chain where K4 declines: "
          f"{unfused}")
    print("gates " + json.dumps(dict(picks=picks, wrappers_raised=raised,
                                     conv1x1bn_unfused=unfused)), flush=True)


# -- phase 4: the host input path ---------------------------------------------

#: batches whose bytes the input phase compares at 0 and W workers, and
#: batches after them over which it times the host's ms per batch: one
#: whole pass of ResNet's 1,024 images, whose shuffle draws the pass's
#: images before its first batch
INPUT_BATCHES, INPUT_TIMED = 4, 4


def input_workers() -> int:
    """W, the worker processes of the input phase and of the BERT and
    ResNet runs: half the host's cores, at most 8."""
    return min(8, (os.cpu_count() or 2) // 2)


def _input_leftovers() -> dict:
    """What of the input path is alive in this process (prefetch threads,
    pool workers, ``dlsw-<pid>-`` segments), after a bounded moment for
    them to end."""
    deadline = time.monotonic() + 5.0
    while True:
        left = dict(
            threads=[t.name for t in threading.enumerate() if t.name == "dls-prefetch"],
            workers=[p.name for p in mp.active_children()
                     if p.name.startswith("dls-worker")],
            segments=[f for f in os.listdir("/dev/shm")
                      if f.startswith(f"dlsw-{os.getpid()}-")])
        if not any(left.values()) or time.monotonic() > deadline:
            return {k: v for k, v in left.items() if v}
        time.sleep(0.05)


def _feed_run(ds, batch_size: int) -> dict:
    """The first INPUT_BATCHES host batches of ``ds``: a digest of each
    one's bytes, the host's ms for the first, the live pools' gauges after
    it, and the host's ms per batch over the INPUT_TIMED batches after
    them."""
    from distributeddeeplearningspark_tpu_torch.data import workers
    from distributeddeeplearningspark_tpu_torch.data.feed import host_batches

    def digest(batch) -> str:
        h = hashlib.sha256()
        for k in sorted(batch):
            h.update(k.encode() + batch[k].dtype.str.encode()
                     + str(batch[k].shape).encode() + batch[k].tobytes())
        return h.hexdigest()

    it = host_batches(ds, batch_size)
    try:
        t0 = time.perf_counter()
        digests = [digest(next(it))]
        t1 = time.perf_counter()
        gauges = workers.pool_gauges()
        digests += [digest(next(it)) for _ in range(INPUT_BATCHES - 1)]
        t2 = time.perf_counter()
        for _ in range(INPUT_TIMED):
            next(it)
        t3 = time.perf_counter()
    finally:
        it.close()
    return dict(digests=digests, first_ms=(t1 - t0) * 1e3,
                host_batch_ms=(t3 - t2) / INPUT_TIMED * 1e3,
                input_workers=gauges.get("input_workers", 0),
                worker_items=gauges.get("worker_items", 0))


def check_input() -> dict:
    """BERT's feed (S=512, b=32) and ResNet's (224², b=256), each with its
    source at 1 and at W partitions, at 0 and at W workers: the same bytes
    at both counts, the pool really ran (W workers, items delivered), the
    host's ms per batch, and nothing of the input path left after."""
    from distributeddeeplearningspark_tpu_torch.data import sources, text, vision

    w = input_workers()
    docs = text.synthetic_wikipedia(2048, num_partitions=1)
    tok = text.WordPieceTokenizer.train(docs.collect(), vocab_size=8192)
    feeds = {}
    for parts in (1, w):
        bert_docs = text.synthetic_wikipedia(2048, num_partitions=parts)
        images = sources.synthetic_images(4 * RESNET_BATCH, image_size=224,
                                          num_classes=1000, num_partitions=parts)
        for n in (0, w):
            feeds[f"bert_p{parts}_w{n}"] = _feed_run(text.mlm_dataset(
                bert_docs, tok, seq_len=512, max_predictions=80,
                num_workers=n).repeat(), 32)
            feeds[f"resnet_p{parts}_w{n}"] = _feed_run(vision.imagenet_train(
                images, size=224, repeat=True, num_workers=n), RESNET_BATCH)
    left = _input_leftovers()
    rec = dict(workers=w, cpu_count=os.cpu_count(), batches=INPUT_BATCHES,
               host_batch_ms={k: v["host_batch_ms"] for k, v in feeds.items()},
               first_batch_ms={k: v["first_ms"] for k, v in feeds.items()},
               pool={k: (v["input_workers"], v["worker_items"])
                     for k, v in feeds.items()}, leftovers=left)
    print("input " + json.dumps(rec), flush=True)
    for model in ("bert", "resnet"):
        for parts in (1, w):
            serial, pooled = (feeds[f"{model}_p{parts}_w{n}"] for n in (0, w))
            check(serial["digests"] == pooled["digests"],
                  f"{model} batches at {parts} partition(s) differ between 0 and "
                  f"{w} workers")
            check(pooled["input_workers"] == w and pooled["worker_items"] > 0
                  and serial["input_workers"] == 0,
                  f"{model} at {parts} partition(s): the pool did not run "
                  f"({pooled['input_workers']} workers, {pooled['worker_items']} "
                  f"items)")
    check(not left, f"the input path outlived its phase: {left}")
    return rec


def _input_gauges(records: list[dict]) -> dict:
    """The input path's gauges over a run's ``step_metrics`` laps: the
    summed wait for input and lap wall, the ring's depth, the pool's size
    and utilization."""
    laps = [r for r in records if r["kind"] == "step_metrics"]
    pooled = [r for r in laps if "input_workers" in r]
    depth = [r["prefetch_depth_mean"] for r in laps if "prefetch_depth_mean" in r]
    return dict(
        input_wait_s=sum(r.get("input_wait_s", 0.0) for r in laps),
        lap_s=sum(r["lap_s"] for r in laps),
        input_wait_by_lap_s=[r.get("input_wait_s") for r in laps],
        prefetch_depth_mean=sum(depth) / len(depth) if depth else None,
        prefetch_depth_min=min((r["prefetch_depth_min"] for r in laps
                                if "prefetch_depth_min" in r), default=None),
        input_workers=sorted({r["input_workers"] for r in pooled}),
        worker_util_mean=pooled[-1]["worker_util_mean"] if pooled else None,
        worker_overflow=pooled[-1]["worker_overflow"] if pooled else None,
        laps=len(laps), laps_with_pool=len(pooled))


def _check_pooled(name: str, gauges: dict, workers: int) -> None:
    check(gauges["laps_with_pool"] > 0 and gauges["input_workers"] == [workers],
          f"{name}'s laps saw pools of {gauges['input_workers']} workers in "
          f"{gauges['laps_with_pool']} of {gauges['laps']} laps, want {workers}")
    left = _input_leftovers()
    check(not left, f"{name}: the input path outlived its phase: {left}")


# -- phase 5: training BERT-base -----------------------------------------------


def _grad_parity(torch, model, loss_fn, batch) -> dict:
    """Every parameter's gradient on ``batch`` through the kernels
    (``attention_impl="auto"``) against the plain path (``"xla"``), with the
    same weights and dropout off (eval mode); and each route's FLOPs of the
    forward and backward (``metrics.counting_flops``: the kernels' formulas
    on one route, the mode's count of the plain products on the other)."""
    from distributeddeeplearningspark_tpu_torch import metrics

    model.eval()
    grads, flops = {}, {}
    try:
        for impl in ("auto", "xla"):
            model.cfg.attention_impl = impl
            model.zero_grad(set_to_none=True)
            with metrics.counting_flops() as n:
                loss_fn(model(batch), batch)[0].backward()
            flops[impl] = n["flops"]
            grads[impl] = {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}
    finally:
        model.cfg.attention_impl = "auto"
        model.zero_grad(set_to_none=True)
    qkv = {n: float(g.norm()) for n, g in grads["auto"].items()
           if any(n.endswith(f".attention.{m}.weight")
                  for m in ("query", "key", "value"))}
    return dict(**_compare_grads(torch, grads["auto"], grads["xla"],
                                 PARITY_RTOL, PARITY_ATOL),
                qkv_weights=len(qkv), qkv_min_grad_norm=min(qkv.values()),
                flops=flops)


def _compare_grads(torch, got: dict, ref: dict, rtol: float, atol: float) -> dict:
    """Per tensor (Frobenius): the relative error of ``got`` against
    ``ref`` and the share it uses of ``rtol·|g_ref| + atol·|G_ref|``, G the
    whole reference gradient; the five that use the most."""
    total = float(torch.stack([g.norm() for g in ref.values()]).norm())
    rel, used = {}, {}
    for n, r in ref.items():
        diff, ref_norm = float((got[n] - r).norm()), float(r.norm())
        rel[n] = diff / ref_norm if ref_norm else (0.0 if diff == 0 else float("inf"))
        used[n] = diff / (rtol * ref_norm + atol * total)
    ranked = sorted(used, key=used.get, reverse=True)
    return dict(tensors=len(rel), grad_norm=total,
                worst=[(n, rel[n], used[n]) for n in ranked[:5]],
                max_tolerance_used=used[ranked[0]],
                median_rel_err=float(np.median(list(rel.values()))),
                tolerance=f"|g-g_ref| <= {rtol}*|g_ref| + {atol}*|G_ref| per tensor")


def _step_split(torch, trainer, batch, repeats: int = 3) -> dict:
    """One train step's forward (with the loss), backward and optimizer
    update, each between CUDA events, averaged over ``repeats`` steps (the
    step's own three parts, run one after another as the train step runs
    them)."""
    from distributeddeeplearningspark_tpu_torch.train.optim import global_norm

    model, state = trainer.model, trainer.state
    params = list(state.params.values())
    model.train()
    sums = [0.0, 0.0, 0.0]
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in params:
            p.grad = None
        ev[0].record()
        loss, _ = trainer.loss_fn(model(batch, generator=state.generator), batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        with torch.no_grad():
            grads = [p.grad for p in params]
            global_norm(grads)
            updates, state.opt_state = trainer.tx.update(grads, state.opt_state,
                                                         params)
            torch._foreach_add_(params, updates)
        ev[3].record()
        ev[3].synchronize()
        for i in range(3):
            sums[i] += ev[i].elapsed_time(ev[i + 1])
    for p in params:
        p.grad = None
    return dict(forward_ms=sums[0] / repeats, backward_ms=sums[1] / repeats,
                optimizer_ms=sums[2] / repeats)


def _loop_ms(torch, trainer, batch, steps: int = 10) -> float:
    """The train loop's own ms a step with its input ready: ``steps`` train
    steps on one batch already on the card, no feed, ending in a sync (the
    step's dispatch and device work, nothing of the host input path)."""
    trainer.state, _ = trainer._train_step(trainer.state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.state, _ = trainer._train_step(trainer.state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


#: where the profiled windows write their traces (one directory a window)
PROFILE_ROOT = ROOT / "build" / "chip_smoke_profiles"


def _window(trace: str, steps: int) -> dict:
    """A profiled window's numbers from its Chrome trace, read by the
    package (``utils.profiling.op_breakdown`` over ``utils.kineto``): the
    device's busy time per step (every stream's kernels, copies and
    memsets; a host range mirrored on the device, NCCL's
    ``nccl:all_reduce``, is not work of its own) against the window's wall
    per step (the trace's extent: the profiler's start to its sync at the
    window's end), the busy time by kernel family, the kernels that take
    most of it, the busiest stream's launches by kernel, and the host-side
    records of the collectives (calls and host ms per step). "not
    measured" when the trace holds no device event."""
    from distributeddeeplearningspark_tpu_torch.utils import kineto, profiling

    # the profiler's own session record spans the trace; the window's wall is
    # its first op to the last event of the device or the host
    events = [e for e in kineto.load(trace) if e.get("cat") != "Trace"]
    wall_ms = (max(float(e["ts"]) + float(e["dur"]) for e in events)
               - min(float(e["ts"]) for e in events)) / 1e3 / steps
    comms: dict[str, dict] = {}
    for e in events:
        if e.get("cat") == "cpu_op" and any(
                k in e["name"].lower() for k in ("allreduce", "all_reduce", "nccl")):
            c = comms.setdefault(e["name"], dict(calls=0, host_ms_per_step=0.0))
            c["calls"] += 1
            c["host_ms_per_step"] += float(e["dur"]) / 1e3 / steps
    fams = profiling.op_breakdown(trace, top=50, streams="all")
    if fams.get("error") or not fams["plane"] or not fams["plane"].startswith("device"):
        return dict(busy_ms_per_step="not measured", wall_ms_per_step=wall_ms,
                    collectives=comms, trace=trace)
    busy_ms = fams["total_ms"] / steps
    top = profiling.op_breakdown(trace, top=10, by="kernel", streams="all")
    stream = profiling.op_breakdown(trace, top=200, by="kernel")
    return dict(steps=steps, wall_ms_per_step=wall_ms, busy_ms_per_step=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                busy_ms_by_family={o["name"]: o["ms"] / steps for o in fams["ops"]},
                top_device_ms_per_step=[(o["name"][:80], o["ms"] / steps)
                                        for o in top["ops"]],
                stream=stream["line"],
                stream_launches_per_step={o["name"][:80]: o["count"] / steps
                                          for o in stream["ops"]},
                collectives=comms, trace=trace)


def _profile_fit(torch, trainer, ds, batch_size: int, fit_kw: dict,
                 steps: int = 4) -> dict:
    """``steps`` more steps of ``fit``, every one in its profiled window
    (``fit(profile=ProfileSpec(...))``), read by :func:`_window`."""
    from distributeddeeplearningspark_tpu_torch.utils.profiling import ProfileSpec

    start = trainer.state.step
    out = PROFILE_ROOT / f"{os.getpid()}.{time.time_ns()}"
    torch.cuda.synchronize()
    trainer.fit(ds, batch_size=batch_size, steps=start + steps, log_every=steps,
                profile=ProfileSpec(str(out), start_step=0, num_steps=steps), **fit_kw)
    traces = sorted(out.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"profiled window wrote {traces}")
    return _window(str(traces[0]), steps)


def _launches_per_step(window: dict, kernels: dict[str, str]) -> dict:
    """The window's launches a step of each of ``kernels`` (name → the
    substring of its device kernel's name), on the busiest stream."""
    got = window.get("stream_launches_per_step", {})
    return {name: sum(n for k, n in got.items() if sub in k)
            for name, sub in kernels.items()}


#: the flash kernels' device names (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
FLASH_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
#: a lap's recorded MFU against flops × steps / wall / peak, both from its
#: record (the record rounds the MFU to 6 decimals)
MFU_ATOL = 1e-6


def _observability(torch, workdir: Path, records: list[dict], window: dict,
                   window_start: int, launches_per_step: dict[str, int],
                   peak_bytes: int, name: str) -> dict:
    """The device-side observability of a phase's ``fit(profile=...,
    measure_flops=True)``: each lap's MFU against its own flops × steps /
    wall / peak, the last ``memory`` event's peak against
    ``max_memory_allocated``, the window's launches a step by kernel, and
    the port's ``dlstatus --anatomy --json`` on the workdir. The MFU and
    step ms are the steady laps' before the window (``window_start``: the
    step it began after), apart from the window's laps, which carry the
    profiler's cost."""
    laps = [r for r in records if r["kind"] == "step_metrics"]
    mems = [r for r in records if r["kind"] == "memory"]
    mfu_off = max(abs(r["mfu"] - r["flops_per_step"] * r["steps"]
                      / r["anatomy_wall_s"] / r["peak_flops_per_chip"]) for r in laps)
    launches = _launches_per_step(window, FLASH_KERNELS)
    res = subprocess.run([sys.executable, "-m", f"{PKG}.status", str(workdir),
                          "--anatomy", "--json"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    status = json.loads(res.stdout.strip().splitlines()[-1]) if res.returncode == 0 else {}
    anatomy = status.get("anatomy") or {}
    steady = [r for r in laps[1:] if r["step"] <= window_start] or laps[-1:]
    profiled = [r for r in laps if r["step"] > window_start]
    rec = dict(
        flops_per_step=laps[-1]["flops_per_step"],
        peak_flops_per_chip=laps[-1]["peak_flops_per_chip"],
        peak_source=laps[-1]["peak_source"],
        mfu=float(np.mean([r["mfu"] for r in steady])),
        mfu_device=float(np.mean([r["mfu_device"] for r in steady])),
        step_ms=1e3 * sum(r["anatomy_wall_s"] for r in steady)
        / sum(r["steps"] for r in steady),
        mfu_window=float(np.mean([r["mfu"] for r in profiled])),
        step_ms_window=1e3 * sum(r["anatomy_wall_s"] for r in profiled)
        / sum(r["steps"] for r in profiled),
        mfu_max_abs_off=mfu_off, laps=len(laps), memory_events=len(mems),
        memory=mems[-1] if mems else None, max_memory_allocated=peak_bytes,
        window_launches_per_step=launches,
        top_families=sorted(window.get("busy_ms_by_family", {}).items(),
                            key=lambda kv: -kv[1])[:5],
        dlstatus_rc=res.returncode,
        dlstatus_mfu=(anatomy.get("mfu") or {}).get("mfu"),
        dlstatus_memory=anatomy.get("memory"))
    print(f"observability {name} " + json.dumps(rec), flush=True)
    # a lap holding the counted first step (a first call: its compile) has
    # no device time for it, and so no mfu_device
    check(all(r.get("mfu") is not None
              and (r.get("mfu_device") is not None) == (r["compile_in_lap_s"] == 0)
              for r in laps) and mfu_off <= MFU_ATOL,
          f"{name}: a lap's mfu is not flops × steps / wall / peak (off by "
          f"{mfu_off}), or its mfu_device is missing")
    check(rec["peak_source"].startswith("spec table"),
          f"{name}: the MFU's peak came from {rec['peak_source']}")
    check(len(mems) == len(laps) and mems[-1]["source"] == "memory_stats"
          and mems[-1]["peak_bytes_in_use_max"] == peak_bytes,
          f"{name}: {len(mems)} memory events for {len(laps)} laps, the last "
          f"{rec['memory']}, max_memory_allocated {peak_bytes}")
    check(launches == launches_per_step,
          f"{name}: the window's flash launches a step {launches}, want "
          f"{launches_per_step}")
    check("flash" in window.get("busy_ms_by_family", {}),
          f"{name}: no flash family in the window's breakdown")
    check(res.returncode == 0 and rec["dlstatus_mfu"] and rec["dlstatus_memory"]
          and rec["dlstatus_memory"].get("source") == "memory_stats",
          f"{name}: the port's dlstatus --anatomy: rc {res.returncode}, "
          f"{anatomy or res.stderr[-2000:]}")
    return rec


def _bert_products(cfg, b: int, s: int, predictions: int) -> int:
    """One BERT MLM step's FLOPs reckoned by hand (2 a multiply-add): every
    param trains and the embeddings' rows want gradients, so each product
    counts three times (forward, dx, dW; QKᵀ and PV their two gradients);
    per layer Q, K, V, O and the two FFN projections on every token, QKᵀ
    and PV over the whole S × S; the MLM head's transform and the tied
    decoder on the ``predictions`` gathered positions."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, p = b * s, b * predictions
    layer = (4 * 2 * n * h * h + 2 * 2 * n * h * i
             + 2 * 2 * b * cfg.num_heads * s * s * (h // cfg.num_heads))
    return 3 * (cfg.num_layers * layer + 2 * p * h * h + 2 * p * h * v)


def train_bert(torch, fa) -> dict:
    """BERT-base MLM at full width through the port's Session → text →
    mlm_dataset (tokenize over W worker processes) → Trainer.fit (its
    prefetch), the calls of examples/train_bert.py at S=512; the run's
    step_metrics telemetry gives the logged losses and the input gauges."""
    import shutil

    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.data import text
    from distributeddeeplearningspark_tpu_torch.data.feed import device_batches
    from distributeddeeplearningspark_tpu_torch.models import bert
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    from distributeddeeplearningspark_tpu_torch.utils.profiling import ProfileSpec

    steps, batch_size, seq, log_every = 30, 32, 512, 10
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    spark = Session.builder.master("local[1]").appName("bert-mlm").getOrCreate()
    docs = text.synthetic_wikipedia(
        2048, num_partitions=max(spark.default_parallelism, 1))
    tok = text.WordPieceTokenizer.train(docs.collect(), vocab_size=8192)
    workers = input_workers()
    ds = text.mlm_dataset(docs, tok, seq_len=seq, max_predictions=80,
                          num_workers=workers).repeat()
    model = bert.bert_base(device="cuda", seed=0)
    cfg = model.cfg
    check(cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.num_heads == 12 and cfg.intermediate_size == 3072
          and cfg.vocab_size == 30522 and cfg.max_position == seq
          and cfg.dropout_rate == 0.1 and cfg.dtype == torch.bfloat16,
          "bert_base is not at BERT-base width")
    check(tok.vocab_size <= cfg.vocab_size,
          f"tokenizer ids reach {tok.vocab_size}, past the model's vocab")
    tx = optim.with_grad_clip(
        optim.adamw(optim.warmup_linear(1e-4, 10, steps)), 1.0)
    trainer = Trainer(spark, model, losses.masked_lm, tx)
    setup_s = time.perf_counter() - t0
    os.environ[telemetry.WORKDIR_ENV] = str(workdir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:  # the main path's run starts here
        k.launches = 0
    t_fit = time.perf_counter()
    try:
        # the last lap profiled; the first step's FLOPs counted
        _, summary = trainer.fit(ds, batch_size=batch_size, steps=steps,
                                 tokens_per_example=seq, log_every=log_every,
                                 measure_flops=True, profile=ProfileSpec(
                                     str(workdir / "profile"),
                                     start_step=steps - log_every, num_steps=log_every))
    finally:
        os.environ.pop(telemetry.WORKDIR_ENV, None)
        telemetry.reset()
    fit_s = time.perf_counter() - t_fit
    launches = {k.__name__: k.launches for k in kernels}
    peak_bytes = torch.cuda.max_memory_allocated()

    records = _events(workdir)
    logged = [(r["step"], r["metrics"]["loss"]) for r in records
              if r["kind"] == "step_metrics"]
    gauges = _input_gauges(records)
    profile = _window(str(sorted((workdir / "profile").glob("*.pt.trace.json"))[-1]),
                      log_every)
    observed = _observability(torch, workdir, records, profile, steps - log_every,
                              {k: cfg.num_layers for k in FLASH_KERNELS}, peak_bytes,
                              "bert-base")
    host_batch_ms = _host_batch_ms(ds, batch_size, 6)
    batch = next(device_batches(ds, batch_size, trainer.device))
    loop_ms = _loop_ms(torch, trainer, batch)
    parity = _grad_parity(torch, model, losses.masked_lm, batch)
    split = _step_split(torch, trainer, batch)
    spark.stop()
    rec = dict(steps=steps, batch_size=batch_size, seq_len=seq,
               tokenizer_vocab=tok.vocab_size, logged_losses=logged,
               loss_ratio_last_first=logged[-1][1] / logged[0][1] if logged else None,
               step_time_ms=summary.get("step_time_ms"),
               tokens_per_sec_per_chip=summary.get("tokens_per_sec_per_chip"),
               launches=launches, max_memory_allocated=peak_bytes,
               fit_s=fit_s, setup_s=setup_s, host_batch_ms=host_batch_ms,
               loop_ms=loop_ms, workers=workers, input=gauges,
               step_split=split, profile=profile, grad_parity=parity,
               mfu=observed["mfu"], mfu_device=observed["mfu_device"],
               flops_per_step=observed["flops_per_step"],
               reckoned_flops_per_step=_bert_products(cfg, batch_size, seq, 80),
               step_time_ms_unprofiled=observed["step_ms"],
               model_tflops_per_s=observed["flops_per_step"]
               / (observed["step_ms"] / 1e3) / 1e12)
    print("train bert-base " + json.dumps(rec), flush=True)
    _check_pooled("train_bert", gauges, workers)
    check(len(logged) == steps // log_every,
          f"{len(logged)} step_metrics records for {steps} steps")
    check(all(np.isfinite(loss) for _, loss in logged),
          f"non-finite logged loss: {logged}")
    check(logged[-1][1] < LOSS_DROP * logged[0][1],
          f"loss did not fall: {logged}")
    want = cfg.num_layers * steps
    check(all(n == want for n in launches.values()),
          f"kernel launches during fit {launches}, want {want} each")
    check(parity["max_tolerance_used"] <= 1.0,
          f"gradients through the kernels are off the plain path's "
          f"(tensor, relative error, share of the tolerance): {parity['worst']}")
    check(parity["qkv_weights"] == 3 * cfg.num_layers
          and parity["qkv_min_grad_norm"] > 0,
          "a query/key/value projection got no gradient through the kernels")
    check(parity["flops"]["auto"] == parity["flops"]["xla"] > 0,
          f"the kernel route and the plain path count other FLOPs: {parity['flops']}")
    check(rec["flops_per_step"] == rec["reckoned_flops_per_step"],
          f"the step's measured FLOPs {rec['flops_per_step']} are not the "
          f"reckoning's {rec['reckoned_flops_per_step']}")
    return rec


# -- phase 6b: Llama-2 7B LoRA (config 5) ----------------------------------------

#: Llama-2 7B at its published widths, LoRA rank 16 (alpha 16) on wq and wv,
#: b=8 sequences of S=1,024: steps in process and through the driver
LLAMA_STEPS, LLAMA_DRIVER_STEPS, LLAMA_BATCH, LLAMA_SEQ, LLAMA_RANK = 10, 5, 8, 1024, 16
#: Llama-2 7B's attention heads
LLAMA_HEADS = 32
#: (tensor, rows a card) of the Llama gang's tensor-parallel runs at four
#: cards: fsdp=2 × tensor=2 (b = 8 over 2 batch shards) and tensor=4
LLAMA_TP_SHAPES = ((2, LLAMA_BATCH // 2), (4, LLAMA_BATCH))
#: a pipeline stage's microbatch rows (--gang llama-pp): b = 8 at M = 4, 8
LLAMA_PP_MICRO_ROWS = (LLAMA_BATCH // 4, LLAMA_BATCH // 8)
#: the in-process phase's peak lr (LoRA fine-tunes run 1e-4 to 1e-3; random
#: base weights need the upper end for the loss to move in 10 steps)
LLAMA_LR = 1e-3
#: flash launches a step: K1 in each layer's forward and again in its remat
#: recompute, K2 and K3 once in each layer's backward
LLAMA_LAUNCHES = {"flash_fwd": 64, "flash_bwd_dq": 32, "flash_bwd_dkv": 32}
#: the training step's peak device memory over the base weights' bytes: the
#: base (13.5 GB in bf16), the 32 layer inputs the remat keeps (2.1 GB), one
#: layer's recompute (~1 GB), the f32 logits and their gradient (~2.1 GB)
#: and the adapters' AdamW state read ~1.5; a step that zero-fills the
#: frozen params' gradients adds the base once more (~2.5)
LLAMA_PEAK_OVER_BASE = 2.0
#: the adapters' gradients through the flash kernels against the plain
#: attention path on one batch, at 2 layers of the 7B widths, from nonzero
#: B (bf16 activations: PARITY_RTOL/PARITY_ATOL, as for BERT)
LLAMA_PARITY_LAYERS = 2
#: the main fit's profiled window: its last steps
LLAMA_WINDOW = 3


def _llama_products(cfg, b: int, s: int) -> int:
    """One LoRA step's FLOPs reckoned by hand (2 a multiply-add), as
    ``FlopCounterMode`` and the kernels' formulas count them. Forward:
    every projection, the adapters (x·A, then ·B), QKᵀ and PV at the q
    heads over the whole S × S (the plain version computes the masked half
    too), the head. Remat: each layer's forward again, all but ``down``
    (the non-reentrant checkpoint stops once it has remade every tensor the
    backward saved). Backward, the base frozen: dx of each projection whose
    input wants a gradient, the adapters' d(x·A), dB, dA and dx through A,
    dP/dQ/dK/dV as q, k and v want them, the head's dx. Layer 0's input
    (the frozen embedding's rows) wants none: its wq/wk/wv get no dx, and
    of q, k, v only those with an adapter want a gradient."""
    n, h, i, v, r = b * s, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, \
        cfg.lora_rank
    kvh = cfg.num_kv_heads * cfg.head_dim
    mm = lambda m_, k_, n_: 2 * m_ * k_ * n_  # noqa: E731
    attn = 2 * b * cfg.num_heads * s * s * cfg.head_dim  # one product
    proj = {"wq": (h, h), "wk": (h, kvh), "wv": (h, kvh), "wo": (h, h),
            "gate": (h, i), "up": (h, i), "down": (i, h)}
    targets = set(cfg.lora_targets)
    fwd = (sum(mm(n, fi, fo) for fi, fo in proj.values()) + 2 * attn
           + sum(mm(n, fi, r) + mm(n, r, fo) for t, (fi, fo) in proj.items()
                 if t in targets))
    total = 2 * mm(n, h, v)  # the head: forward, dx
    for layer in range(cfg.num_layers):
        first = layer == 0
        total += fwd + (fwd - mm(n, i, h) if cfg.remat else 0)
        for t, (fi, fo) in proj.items():
            if not (first and t in ("wq", "wk", "wv")):
                total += mm(n, fi, fo)
            if t in targets:
                total += 2 * mm(n, r, fo) + mm(n, fi, r) * (1 if first else 2)
        if first:
            wq, wk, wv = ("wq" in targets), ("wk" in targets), ("wv" in targets)
            total += attn * ((wq or wk) + wq + wk + wv)
        else:
            total += 4 * attn
    return total


def _llama_grad_parity(torch, fa, batch) -> dict:
    """The adapters' gradients at LLAMA_PARITY_LAYERS layers of the 7B
    widths (the same weights, seed 1, B drawn nonzero) through the kernels
    (``attention_impl="auto"``, which must pick them) and through the plain
    path (``"xla"``) on the same batch; and each route's FLOPs of the
    forward and backward (``metrics.counting_flops``)."""
    from distributeddeeplearningspark_tpu_torch import metrics
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.ops import attention
    from distributeddeeplearningspark_tpu_torch.train import losses

    model = llama.llama2_7b(device="cuda", seed=1, lora_rank=LLAMA_RANK,
                            num_layers=LLAMA_PARITY_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.requires_grad_(llama.lora_trainable(name))
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    model.train()
    q = torch.zeros(LLAMA_BATCH, LLAMA_SEQ, 32, 128, device="cuda", dtype=torch.bfloat16)
    picked = attention._pick_impl(q, q, None, None)
    grads, launches, flops = {}, {}, {}
    for impl in ("auto", "xla"):
        model.cfg.attention_impl = impl
        before = fa.flash_fwd.launches
        model.zero_grad(set_to_none=True)
        with metrics.counting_flops() as counted:
            losses.causal_lm(model(batch), batch)[0].backward()
        flops[impl] = counted["flops"]
        launches[impl] = fa.flash_fwd.launches - before
        grads[impl] = {n: p.grad.detach().float().clone()
                       for n, p in model.named_parameters() if p.grad is not None}
    frozen_grads = [n for n, p in model.named_parameters()
                    if not llama.lora_trainable(n) and p.grad is not None]
    del model
    torch.cuda.empty_cache()
    rec = _compare_grads(torch, grads["auto"], grads["xla"], PARITY_RTOL, PARITY_ATOL)
    return dict(rec, picked=picked, k1_launches=launches, flops=flops,
                lora_a_min_grad_norm=min(float(g.norm()) for n, g in grads["auto"].items()
                                         if n.endswith("lora_a")),
                frozen_with_grad=frozen_grads)


def _llama_peak_with_zero_filled_base(torch, trainer, batch, steps: int = 2) -> int:
    """The peak device memory of ``steps`` train steps with a planted fault
    that zero-fills a gradient for every frozen param and holds it through
    the step, as a step that gives every param a gradient does."""
    frozen = [p for n, p in trainer.state.params.items() if not p.requires_grad]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        zeros = [torch.zeros_like(p) for p in frozen]
        trainer.state, _ = trainer._train_step(trainer.state, batch)
        del zeros
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def train_llama(torch, fa) -> dict:
    """Llama-2 7B LoRA (config 5) at full published width through the port's
    Session → synthetic_wikipedia → WordPieceTokenizer → lm_dataset(S=1,024)
    → Trainer.fit (``trainable=lora_trainable``, the adapters' AdamW), the
    calls of examples/train_llama_lora.py, for LLAMA_STEPS steps at b=8;
    then the port's driver through its cli at ``local[1]``."""
    import gc
    import shutil

    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.data import text
    from distributeddeeplearningspark_tpu_torch.data.feed import device_batches
    from distributeddeeplearningspark_tpu_torch.metrics import llama_model_flops_per_token
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer
    from distributeddeeplearningspark_tpu_torch.utils.profiling import ProfileSpec

    gc.collect()  # what the earlier phases left in the caching allocator
    torch.cuda.empty_cache()
    steps = LLAMA_STEPS
    workdir = ROOT / "build" / "chip_smoke_llama"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    spark = Session.builder.master("local[1]").appName("llama-lora").getOrCreate()
    # the feed and optimizer of examples/train_llama_lora.py
    docs = text.synthetic_wikipedia(1024, num_partitions=max(spark.default_parallelism, 1))
    tok = text.WordPieceTokenizer.train(docs.collect(), vocab_size=2048)
    ds = text.lm_dataset(docs, tok, seq_len=LLAMA_SEQ).repeat()
    tx = optim.masked(optim.with_grad_clip(optim.adamw(optim.warmup_cosine(
        LLAMA_LR, min(10, max(steps // 10, 1)), steps)), 1.0), llama.lora_trainable)
    model = llama.llama2_7b(device="cuda", seed=0, lora_rank=LLAMA_RANK,
                            lora_alpha=16.0)
    cfg = model.cfg
    check((cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
           cfg.num_kv_heads, cfg.intermediate_size, cfg.rope_theta, cfg.rms_eps,
           cfg.param_dtype, cfg.dtype, cfg.remat, tuple(cfg.lora_targets))
          == (32000, 4096, 32, 32, 32, 11008, 10000.0, 1e-5, torch.bfloat16,
              torch.bfloat16, True, ("wq", "wv")),
          f"llama2_7b is not at Llama-2 7B's published widths: {cfg}")
    check(tok.vocab_size <= cfg.vocab_size, "tokenizer ids past the model's vocab")
    base_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                     if not llama.lora_trainable(n))
    trainer = Trainer(spark, model, losses.causal_lm, tx, rules=llama.llama_rules(cfg),
                      trainable=llama.lora_trainable)
    check(not trainer.shard_dims, f"one card sharded {trainer.shard_dims}")
    trainer.init()
    setup_s = time.perf_counter() - t0
    os.environ[telemetry.WORKDIR_ENV] = str(workdir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:  # the main path's run starts here
        k.launches = 0
    t_fit = time.perf_counter()
    try:
        # the last LLAMA_WINDOW steps profiled; the first step's FLOPs counted
        _, summary = trainer.fit(
            ds, batch_size=LLAMA_BATCH, steps=steps, tokens_per_example=LLAMA_SEQ,
            log_every=1, measure_flops=True,
            profile=ProfileSpec(str(workdir / "profile"), start_step=steps - LLAMA_WINDOW,
                                num_steps=LLAMA_WINDOW))
    finally:
        os.environ.pop(telemetry.WORKDIR_ENV, None)
        telemetry.reset()
    fit_s = time.perf_counter() - t_fit
    launches = {k.__name__: k.launches for k in kernels}
    peak_bytes = torch.cuda.max_memory_allocated()
    records = _events(workdir)
    logged = [(r["step"], r["metrics"]["loss"]) for r in records
              if r["kind"] == "step_metrics"]
    opt_numel = sum(t.numel() for t in _tensors(torch, trainer.state.opt_state)
                    if t.dim())  # the moments; the counts are 0-d
    lora_numel = sum(p.numel() for n, p in trainer.state.params.items()
                     if llama.lora_trainable(n))
    profile = _window(str(sorted((workdir / "profile").glob("*.pt.trace.json"))[-1]),
                      LLAMA_WINDOW)
    observed = _observability(torch, workdir, records, profile, steps - LLAMA_WINDOW,
                              LLAMA_LAUNCHES, peak_bytes, "llama-2-7b lora")
    batch = next(device_batches(ds, LLAMA_BATCH, trainer.device))
    fault_peak = _llama_peak_with_zero_filled_base(torch, trainer, batch)
    spark.stop()
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    parity = _llama_grad_parity(torch, fa, batch)
    flops_per_token = llama_model_flops_per_token(cfg, LLAMA_SEQ, frozen_base=True)
    tokens_s = summary.get("tokens_per_sec_per_chip")
    reckoned = _llama_products(cfg, LLAMA_BATCH, LLAMA_SEQ)
    model_step = flops_per_token * LLAMA_BATCH * LLAMA_SEQ
    # the measured count over the model formula's: the formula halves the
    # causal attention and counts no remat recompute; the count takes the
    # whole S × S (as the plain version computes it) and each layer's
    # forward again but down, and layer 0's q/k/v projections get no dx
    measured = dict(flops_per_step=observed["flops_per_step"], reckoned=reckoned,
                    model_formula=model_step,
                    measured_over_model=observed["flops_per_step"] / model_step,
                    why=("the count takes QKᵀ and PV over the whole S × S and "
                         "each layer's remat recompute but down; the model "
                         "formula halves the causal attention and counts no "
                         "recompute"),
                    mfu=observed["mfu"], mfu_device=observed["mfu_device"],
                    step_time_ms_unprofiled=observed["step_ms"],
                    measured_tflops_per_s=observed["flops_per_step"]
                    / (observed["step_ms"] / 1e3) / 1e12,
                    model_tflops_per_s_unprofiled=model_step
                    / (observed["step_ms"] / 1e3) / 1e12)
    print("llama flops " + json.dumps(measured), flush=True)
    rec = dict(steps=steps, batch_size=LLAMA_BATCH, seq_len=LLAMA_SEQ,
               lora_rank=LLAMA_RANK, tokenizer_vocab=tok.vocab_size,
               logged_losses=logged, step_time_ms=summary.get("step_time_ms"),
               tokens_per_sec_per_chip=tokens_s,
               model_flops_per_token=flops_per_token,
               model_tflops_per_s=tokens_s * flops_per_token / 1e12 if tokens_s else None,
               launches=launches, max_memory_allocated=peak_bytes,
               base_bytes=base_bytes, peak_limit=LLAMA_PEAK_OVER_BASE * base_bytes,
               zero_filled_base_peak=fault_peak,
               optimizer_state_numel=opt_numel, lora_numel=lora_numel,
               fit_s=fit_s, setup_s=setup_s, profile=profile, grad_parity=parity,
               flops=measured, observability=observed)
    print("train llama-2-7b lora " + json.dumps(rec), flush=True)
    check(len(logged) == steps and all(np.isfinite(x) for _, x in logged),
          f"logged losses {logged}")
    check(logged[-1][1] < logged[0][1], f"the loss did not fall: {logged}")
    want = {k: n * steps for k, n in LLAMA_LAUNCHES.items()}
    check(launches == want, f"flash launches during fit {launches}, want {want}")
    check(opt_numel == 2 * lora_numel,
          f"optimizer state of {opt_numel} elements, want AdamW's two moments of "
          f"the {lora_numel} adapter elements only")
    check(peak_bytes <= rec["peak_limit"] < fault_peak,
          f"peak memory {peak_bytes} (zero-filled frozen gradients: {fault_peak}) "
          f"against the limit {rec['peak_limit']}")
    check(parity["picked"] == "flash" and parity["k1_launches"]["auto"] > 0
          and parity["k1_launches"]["xla"] == 0,
          f"the Llama shape did not take the flash kernels: {parity}")
    check(not parity["frozen_with_grad"] and parity["lora_a_min_grad_norm"] > 0,
          f"frozen params with a gradient, or an adapter A with none: {parity}")
    check(parity["max_tolerance_used"] <= 1.0,
          f"adapter gradients through the kernels are off the plain path's: "
          f"{parity['worst']}")
    check(parity["flops"]["auto"] == parity["flops"]["xla"] > 0,
          f"at {LLAMA_PARITY_LAYERS} layers the kernel route and the plain path "
          f"count other FLOPs: {parity['flops']}")
    check(observed["flops_per_step"] == reckoned,
          f"the step's measured FLOPs {observed['flops_per_step']} are not the "
          f"reckoning's {reckoned}")
    rec["driver"] = train_llama_driver(torch)
    return rec


def train_llama_driver(torch) -> dict:
    """The port's examples/train_llama_lora.py through its cli at
    ``local[1]`` (a gang of one, NCCL) with its default ``--fsdp -1``, which
    at one card shards nothing (as JAX at one device): 7B at b=8, S=1,024,
    LoRA rank 16, LLAMA_DRIVER_STEPS steps, each logged: it exits 0, the
    mesh is one card's and the card holds the whole model, the flash kernels
    launch LLAMA_LAUNCHES a step, the losses are finite and nothing of the
    run is left."""
    args = ["--variant", "7b", "--seq-len", str(LLAMA_SEQ), "--batch-size",
            str(LLAMA_BATCH), "--lora-rank", str(LLAMA_RANK), "--lora-alpha", "16",
            "--steps", str(LLAMA_DRIVER_STEPS), "--log-every", "1"]
    run = _driver_run("llama_lora", ROOT / "build" / "chip_smoke_llama_driver", 1, args)
    res = run["result"]
    rec = dict(step_time_ms=res["train"].get("step_time_ms"),
               tokens_per_sec_per_chip=res["train"].get("tokens_per_sec_per_chip"),
               launch=run["launch"], logged_losses=run["losses"].get("p0"),
               left=run["left"], **{k: v for k, v in res.items() if k != "train"})
    print("train llama driver " + json.dumps(rec), flush=True)
    check(res["backend"] == "nccl" and res["device"] == "cuda:0"
          and res["world_size"] == 1 and res["step"] == LLAMA_DRIVER_STEPS
          and res["mesh"]["fsdp"] == 1 and res["sharded_params"] == 0
          and res["by_rank"][0]["param_bytes"] == res["by_rank"][0]["param_bytes_reckoned"],
          f"llama driver: {res}")
    logged = rec["logged_losses"] or []
    check(len(logged) == LLAMA_DRIVER_STEPS and all(np.isfinite(x) for x in logged),
          f"llama driver's logged losses: {logged}")
    want = {k: n * LLAMA_DRIVER_STEPS for k, n in LLAMA_LAUNCHES.items()}
    check(res["flash_launches"] == want,
          f"the llama driver's flash launches {res['flash_launches']}, want {want}")
    check(not run["left"], f"llama driver left {run['left']}")
    return rec


# -- phase 5c: the MoE 0.9b on one card -----------------------------------------

#: the MoE 0.9b (the JAX bench's ``_llama_09b_cfg`` with ``llama_moe_e8``'s
#: experts): vocab 32,000, hidden 2,048, 16 layers, 16 q heads over 8 kv
#: heads (D = 128), FFN 5,632, 8 experts top-2 at capacity factor 1.25, one
#: routing group a sequence, LoRA rank 16 on wq/wv, bf16 storage; b=4
#: sequences of S=1,024 (``llama_moe_e8`` pinned b=1 only to fit a 16 GiB
#: TPU chip), MOE_STEPS steps, and the dense 0.9b on the same batches
MOE_BATCH, MOE_EXPERTS, MOE_STEPS, MOE_LAYERS = 4, 8, 10, 16
MOE_VOCAB, MOE_HIDDEN, MOE_FFN = 32000, 2048, 5632
#: flash launches a step of the 16-layer 0.9b: K1 forward and in the
#: remat recompute, K2 and K3 once each a layer
MOE_LAUNCHES = {"flash_fwd": 32, "flash_bwd_dq": 16, "flash_bwd_dkv": 16}
#: the 0.9b's attention heads and kv heads
MOE_HEADS, MOE_KV_HEADS = 16, 8


def moe_09b_config(torch, llama, **kw):
    """The MoE 0.9b's config (``moe_experts=0``: the dense 0.9b)."""
    base = dict(vocab_size=MOE_VOCAB, hidden_size=MOE_HIDDEN, num_layers=MOE_LAYERS,
                num_heads=MOE_HEADS, num_kv_heads=MOE_KV_HEADS, intermediate_size=MOE_FFN,
                max_position=LLAMA_SEQ, lora_rank=LLAMA_RANK, lora_alpha=16.0,
                dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                moe_experts=MOE_EXPERTS)
    base.update(kw)
    return llama.LlamaConfig(**base)


def _moe_09b_case(torch) -> dict:
    """The MoE 0.9b step's attention: b=4, S=1,024, 16 q heads over 8 kv
    heads, causal, D = 128."""
    return _attn_case(torch, f"moe09b_b{MOE_BATCH}_s1024_h{MOE_HEADS}_kv{MOE_KV_HEADS}"
                      "_causal_d128", b=MOE_BATCH, s=LLAMA_SEQ, h=MOE_HEADS,
                      hkv=MOE_KV_HEADS, d=128, causal=True, seed=20)


def _lm_feed(spark, parts: int):
    """synthetic_wikipedia in ``parts`` partitions → a WordPieceTokenizer
    trained on it → ``lm_dataset`` at S=1,024, repeated: the Llama driver's
    feed."""
    from distributeddeeplearningspark_tpu_torch.data import text

    docs = text.synthetic_wikipedia(1024, num_partitions=parts)
    tok = text.WordPieceTokenizer.train(docs.collect(), vocab_size=2048)
    return text.lm_dataset(docs, tok, seq_len=LLAMA_SEQ).repeat(), tok


def _train_09b(torch, fa, spark, ds, experts: int) -> dict:
    """The 0.9b (MoE at ``experts`` above 0) built on the meta device and
    drawn by the Trainer from seed 0, MOE_STEPS LoRA steps at b=4 through
    ``Trainer.fit``, each logged; then a profiled window."""
    import gc
    import shutil

    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.metrics import llama_model_flops_per_token
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    steps = MOE_STEPS
    workdir = ROOT / "build" / f"chip_smoke_llama_moe_{experts}"
    shutil.rmtree(workdir, ignore_errors=True)
    cfg = moe_09b_config(torch, llama, moe_experts=experts)
    tx = optim.masked(optim.with_grad_clip(optim.adamw(optim.warmup_cosine(
        LLAMA_LR, min(10, max(steps // 10, 1)), steps)), 1.0), llama.lora_trainable)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(spark, llama.LlamaForCausalLM(cfg, device="meta"), losses.causal_lm,
                      tx, rules=llama.llama_rules(cfg), trainable=llama.lora_trainable)
    trainer.init()
    setup_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    os.environ[telemetry.WORKDIR_ENV] = str(workdir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:  # the main path's run starts here
        k.launches = 0
    try:
        _, summary = trainer.fit(ds, batch_size=MOE_BATCH, steps=steps,
                                 tokens_per_example=LLAMA_SEQ, log_every=1)
    finally:
        os.environ.pop(telemetry.WORKDIR_ENV, None)
        telemetry.reset()
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    logged = [r["metrics"] for r in _events(workdir) if r["kind"] == "step_metrics"]
    profile = _profile_fit(torch, trainer, ds, MOE_BATCH,
                           dict(tokens_per_example=LLAMA_SEQ), steps=3)
    flops = llama_model_flops_per_token(cfg, LLAMA_SEQ, frozen_base=True)
    tokens_s = summary.get("tokens_per_sec_per_chip")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(experts=experts, layers=cfg.num_layers, param_bytes=param_bytes,
                losses=[m["loss"] for m in logged],
                moe_aux=[m.get("moe_aux") for m in logged],
                moe_dropped_frac=[m.get("moe_dropped_frac") for m in logged],
                step_time_ms=summary.get("step_time_ms"),
                tokens_per_sec_per_chip=tokens_s, model_flops_per_token=flops,
                model_tflops_per_s=tokens_s * flops / 1e12 if tokens_s else None,
                launches=launches, max_memory_allocated=peak, setup_s=setup_s,
                profile=profile)


def train_llama_moe(torch, fa) -> dict:
    """The MoE 0.9b (Queue 1 item 6's ``expert`` axis at one card) through
    the port's Session → synthetic_wikipedia → WordPieceTokenizer →
    lm_dataset(S=1,024) → Trainer.fit (``trainable=lora_trainable``, the
    adapters' AdamW) for MOE_STEPS steps at b=4, then the dense 0.9b on the
    same batches: the MoE's losses finite and falling, ``moe_aux`` and
    ``moe_dropped_frac`` logged each step, K1/K2/K3 MOE_LAUNCHES a step, and
    the routing's cost beside the dense run's step."""
    import gc

    from distributeddeeplearningspark_tpu_torch.session import Session

    gc.collect()
    torch.cuda.empty_cache()
    spark = Session.builder.master("local[1]").appName("llama-moe").getOrCreate()
    try:
        ds, tok = _lm_feed(spark, max(spark.default_parallelism, 1))
        runs = {name: _train_09b(torch, fa, spark, ds, experts)
                for name, experts in (("moe", MOE_EXPERTS), ("dense", 0))}
    finally:
        spark.stop()
    moe, dense = runs["moe"], runs["dense"]
    rec = dict(batch_size=MOE_BATCH, seq_len=LLAMA_SEQ, lora_rank=LLAMA_RANK,
               tokenizer_vocab=tok.vocab_size, **runs,
               moe_over_dense_step=(moe["step_time_ms"] / dense["step_time_ms"]
                                    if dense["step_time_ms"] else None),
               card=nvidia_smi_line())
    print("train llama moe-0.9b " + json.dumps(rec), flush=True)
    for name, run in runs.items():
        check(len(run["losses"]) == MOE_STEPS and all(np.isfinite(run["losses"])),
              f"the {name} 0.9b's logged losses: {run['losses']}")
        want = {k: n * MOE_STEPS for k, n in MOE_LAUNCHES.items()}
        check(run["launches"] == want,
              f"the {name} 0.9b's flash launches {run['launches']}, want {want}")
    check(moe["losses"][-1] < moe["losses"][0], f"the MoE loss did not fall: {moe}")
    check(all(a is not None and np.isfinite(a) and a > 0 for a in moe["moe_aux"])
          and all(d is not None and 0.0 <= d <= 1.0 for d in moe["moe_dropped_frac"]),
          f"moe_aux {moe['moe_aux']}, moe_dropped_frac {moe['moe_dropped_frac']}")
    check(dense["moe_aux"] == [None] * MOE_STEPS, "the dense 0.9b logged moe_aux")
    return rec


# -- phase 7: K4 against its plain version ---------------------------------------

# (M, K, N) of the Conv1x1BN calls that the K4 gate admits in one fused
# ResNet-50 forward at b=256, 224², and how many of the 27 launches of a
# train step each shape takes; then the shapes a rank of four gives it at 64
# images (M = 12,544 rows, no multiple of 512: the gate takes the global
# batch's rows, 50,176, and K4 a rank's), and small and ragged shapes the
# card's gate admits: partial row tiles (M = 48, 392 and 3,136 against 128
# rows), partial column
# tiles at both tile widths (N = 16, 24, 136 at 64; 72 at 128), the K tail
# (K = 40 against 64-deep slices), and W streamed through the ring at the
# 64-wide tile (K = 1024, N = 40)
K4_MAIN_SHAPES = {
    (802816, 64, 64): 1, (802816, 64, 256): 3, (802816, 256, 64): 2,
    (802816, 256, 128): 1, (200704, 128, 512): 4, (200704, 512, 128): 3,
    (200704, 512, 256): 1, (50176, 256, 1024): 6, (50176, 1024, 256): 5,
    (50176, 1024, 512): 1,
}
K4_EXTRA_SHAPES = [(12544, 1024, 256), (12544, 256, 1024), (12544, 1024, 512),
                   (1024, 40, 72), (256, 16, 16), (48, 16, 24), (392, 64, 136),
                   (3136, 2048, 512), (256, 1024, 40)]
# Y: both round one f32 dot product to bf16, the sums taken in another
# order, so Y may sit one bf16 step (at most 2^-7 of |y|) from the plain
# version's y32.to(bf16), plus the f32 order residue near y = 0
K4_Y_RTOL, K4_Y_ATOL = 2 ** -7, 1e-4
# s1, s2: f32 sums over up to 802,816 rows in another order (running sums
# over each block's row tiles in the kernel, then torch's sum over the
# blocks' partial rows); held to each column's sum of |y32| (of y32²): a
# wrong or missing 128-row tile moves a column by about 1/6272 of it, ten
# times this
K4_STATS_RTOL = 2e-5


def _k4_bound(m: int, k: int, n: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes ms, operations ms): X and W read
    once, Y and the two [N] f32 sums written once; 2·M·K·N operations."""
    t_bytes = ((m * k + k * n + m * n) * 2 + 2 * n * 4) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def check_conv_bn(torch, cb) -> list[dict]:
    """K4 at the main path's ten shapes and five small ones, bf16: the
    kernel's (y, s1, s2) against its plain version on the same inputs, and
    a second launch bit for bit against the first (no atomics); the
    wrapper (kernel + the reduce over the blocks' partial rows), the plain
    version and the library yardstick (``torch.mm`` into bf16, then
    ``torch.var_mean``'s one f32-accumulated pass over Y: two calls the
    port never makes) timed from CUDA graphs."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 mm
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for i, (m, k, n) in enumerate([*K4_MAIN_SHAPES, *K4_EXTRA_SHAPES]):
        gen = torch.Generator(device="cuda").manual_seed(50 + i)
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5
             ).to(torch.bfloat16)
        y, s1, s2 = cb.matmul_stats(x, w)
        again = cb.matmul_stats(x, w)
        torch.cuda.synchronize()
        bitwise = all(bool(torch.equal(a, b)) for a, b in zip((y, s1, s2), again))
        del again
        y32 = x.float() @ w.float()
        y_ref, s1_ref, s2_ref = cb.matmul_stats_reference(x, w)
        y_err = (y.float() - y_ref.float()).abs()
        y_tol = K4_Y_RTOL * y32.abs() + K4_Y_ATOL * float(y32.abs().max())
        s1_tol = K4_STATS_RTOL * y32.abs().sum(0)
        s2_tol = K4_STATS_RTOL * (y32 * y32).sum(0)
        ok = (bool(torch.isfinite(y.float()).all())
              and bool((y_err <= y_tol).all())
              and bool(((s1 - s1_ref).abs() <= s1_tol).all())
              and bool(((s2 - s2_ref).abs() <= s2_tol).all()))
        bound_ms, bound_by, bytes_ms, ops_ms = _k4_bound(m, k, n)
        rec = dict(shape=[m, k, n], launches_per_step=K4_MAIN_SHAPES.get((m, k, n), 0),
                   max_abs_err=float(y_err.max()), y_ref_max=float(y32.abs().max()),
                   s1_max_rel_err=float(((s1 - s1_ref).abs() / s1_tol).max()) * K4_STATS_RTOL,
                   s2_max_rel_err=float(((s2 - s2_ref).abs() / s2_tol).max()) * K4_STATS_RTOL,
                   tolerance=f"|y-ref| <= {K4_Y_RTOL}*|y32| + {K4_Y_ATOL}*max|y32|; "
                             f"|s-ref| <= {K4_STATS_RTOL}*sum|y32| (sum y32^2)",
                   ok=ok, bitwise_repeat=bitwise)
        del y, s1, s2, y32, y_ref, s1_ref, s2_ref, y_err, y_tol
        torch.cuda.empty_cache()
        big = m * n >= 50176 * 512
        rec.update(
            ms=graph_ms(torch, lambda: cb.matmul_stats(x, w), 10 if big else 50),
            plain_ms=graph_ms(torch, lambda: cb.matmul_stats_reference(x, w),
                              3 if big else 20),
            library_ms=graph_ms(torch, lambda: torch.var_mean(
                torch.mm(x, w), dim=0, correction=0), 10 if big else 50),
            bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms)
        print("K4 matmul_stats " + json.dumps(rec), flush=True)
        check(ok, f"matmul_stats disagrees with its plain version at {(m, k, n)}")
        check(bitwise, f"two matmul_stats launches differ at {(m, k, n)}")
        results.append(rec)
        del x, w
        torch.cuda.empty_cache()
    return results


# -- phase 8: training ResNet-50 ---------------------------------------------------

# ResNet-50 parameter gradients through K4 (every Conv1x1BN.fused = True)
# vs the unfused chain (fused = False), one batch, the same weights, per
# tensor (Frobenius): |g - g_ref| <= RESNET_PARITY_RTOL*|g_ref| +
# RESNET_PARITY_ATOL*|G_ref|, G the whole gradient. Both run bf16
# activations; they differ where the 27 fused pairs round: K4 takes the BN
# statistics from its f32 accumulator and runs its backward in f32 (the
# JAX custom VJP), the chain takes them from the bf16 Y and backpropagates
# its bf16 matmul in bf16. 53 BNs deep, those bf16 differences compound
RESNET_PARITY_RTOL = 5e-2
RESNET_PARITY_ATOL = 1e-3


def _conv_bn_grad_parity(torch, model, loss_fn, batch) -> dict:
    """Every parameter's gradient on ``batch`` in train mode with K4 against
    the unfused chain; the BN buffers are put back after both passes."""
    layers = model.conv_bn_layers()
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    grads = {}
    model.train()
    try:
        for fused in (True, False):
            for layer in layers:
                layer.fused = fused
            model.zero_grad(set_to_none=True)
            loss_fn(model(batch), batch)[0].backward()
            grads[fused] = {n: p.grad.detach().clone()
                            for n, p in model.named_parameters()}
    finally:
        for layer in layers:
            layer.fused = True
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(buffers[n])
    conv_bn_3 = [float(g.norm()) for n, g in grads[True].items()
                 if ".conv_bn_3.kernel" in n]
    return dict(**_compare_grads(torch, grads[True], grads[False],
                                 RESNET_PARITY_RTOL, RESNET_PARITY_ATOL),
                conv_bn_3_min_grad_norm=min(conv_bn_3))


def _host_batch_ms(ds, batch_size: int, batches: int) -> float:
    """The host's ms per batch, over ``batches`` batches after the first
    (which starts the dataset's worker pools, if it has any; whole passes
    over a small dataset include each pass's shuffle and image draws)."""
    from distributeddeeplearningspark_tpu_torch.data.feed import host_batches

    it = host_batches(ds, batch_size)
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        return (time.perf_counter() - t0) / batches * 1e3
    finally:
        it.close()


def train_resnet(torch, cb) -> dict:
    """ResNet-50 at full width (stages 3/4/6/3, width 64, 1000 classes,
    224², bf16 activations, f32 params and BN state, random weights from a
    seed, fused_conv_bn=True) through the port's Session →
    synthetic_images (W partitions) → imagenet_train(repeat=True, W worker
    processes, one a partition) → Trainer.fit (its prefetch) with SGD
    (momentum 0.9, weight decay 1e-4) under warmup_cosine(0.1) and
    softmax_xent: the calls of examples/train_resnet.py's synthetic
    branch. 4 batches of images, seen several times, so the loss falls."""
    import shutil

    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.data import sources, vision
    from distributeddeeplearningspark_tpu_torch.data.feed import device_batches
    from distributeddeeplearningspark_tpu_torch.models import resnet
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    steps, batch_size, log_every, size = RESNET_STEPS, RESNET_BATCH, 5, 224
    workdir = ROOT / "build" / "chip_smoke_resnet"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    spark = Session.builder.master("local[1]").appName("resnet50").getOrCreate()
    workers = input_workers()
    src = sources.synthetic_images(4 * batch_size, image_size=size,
                                   num_classes=1000, num_partitions=workers)
    ds = vision.imagenet_train(src, size=size, repeat=True, num_workers=workers)
    model = resnet.resnet50(num_classes=1000, fused_conv_bn=True,
                            device="cuda", seed=0)
    check(model.stage_sizes == (3, 4, 6, 3) and model.head.out_features == 1000
          and model.stem_conv.weight.shape[0] == 64
          and model.dtype == torch.bfloat16
          and len(model.conv_bn_layers()) == 32,
          "resnet50 is not ResNet-50 at full width")
    tx = optim.sgd(optim.warmup_cosine(0.1, max(steps // 10, 1), steps),
                   momentum=0.9, weight_decay=1e-4)
    trainer = Trainer(spark, model, losses.softmax_xent, tx)
    setup_s = time.perf_counter() - t0
    os.environ[telemetry.WORKDIR_ENV] = str(workdir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.matmul_stats.launches = 0  # the main path's run starts here
    t_fit = time.perf_counter()
    try:
        _, summary = trainer.fit(ds, batch_size=batch_size, steps=steps,
                                 log_every=log_every)
    finally:
        os.environ.pop(telemetry.WORKDIR_ENV, None)
        telemetry.reset()
    fit_s = time.perf_counter() - t_fit
    launches = cb.matmul_stats.launches
    peak_bytes = torch.cuda.max_memory_allocated()

    records = [json.loads(line) for f in sorted(
        (workdir / telemetry.TELEMETRY_DIRNAME).glob("events-*.jsonl"))
        for line in f.read_text().splitlines()]
    logged = [(r["step"], r["metrics"]["loss"]) for r in records
              if r["kind"] == "step_metrics"]
    gauges = _input_gauges(records)
    moved = sum(1 for n, b in model.named_buffers()
                if n.endswith(".mean") and bool(b.abs().max() > 0))
    host_batch_ms = _host_batch_ms(ds, batch_size, 8)
    profile = _profile_fit(torch, trainer, ds, batch_size, {})
    batch = next(device_batches(ds, batch_size, trainer.device))
    loop_ms = _loop_ms(torch, trainer, batch)
    parity = _conv_bn_grad_parity(torch, model, losses.softmax_xent, batch)
    split = _step_split(torch, trainer, batch)
    eval_ds = vision.imagenet_eval(sources.synthetic_images(
        2 * batch_size, image_size=size, num_classes=1000, num_partitions=1,
        seed=1), size=size)
    evaluation = trainer.evaluate(eval_ds, batch_size=batch_size)
    spark.stop()
    step_ms = summary.get("step_time_ms")
    rec = dict(steps=steps, batch_size=batch_size, image_size=size,
               logged_losses=logged,
               loss_ratio_last_first=logged[-1][1] / logged[0][1] if logged else None,
               step_time_ms=step_ms,
               images_per_sec_per_chip=summary.get("examples_per_sec_per_chip"),
               k4_launches=launches, k4_launches_per_step=launches / steps,
               bn_means_moved=moved, max_memory_allocated=peak_bytes,
               fit_s=fit_s, setup_s=setup_s, host_batch_ms=host_batch_ms,
               loop_ms=loop_ms, workers=workers, source_partitions=workers,
               input=gauges,
               step_split=split, profile=profile, grad_parity=parity,
               evaluation=evaluation)
    print("train resnet-50 " + json.dumps(rec), flush=True)
    _check_pooled("train_resnet", gauges, workers)
    check(len(logged) == steps // log_every,
          f"{len(logged)} step_metrics records for {steps} steps")
    check(all(np.isfinite(loss) for _, loss in logged),
          f"non-finite logged loss: {logged}")
    check(logged[-1][1] < logged[0][1], f"loss did not fall: {logged}")
    check(launches == 27 * steps,
          f"K4 launched {launches} times in {steps} steps, want 27 per step")
    check(parity["max_tolerance_used"] <= 1.0,
          f"gradients through K4 are off the unfused chain's (tensor, "
          f"relative error, share of the tolerance): {parity['worst']}")
    check(parity["conv_bn_3_min_grad_norm"] > 0,
          "a conv_bn_3 kernel got no gradient through K4")
    check(moved == 53, f"{moved} of 53 BN running means moved in training")
    check(all(np.isfinite(v) for v in evaluation.values())
          and {"loss", "accuracy", "top5_accuracy"} <= set(evaluation),
          f"evaluation not finite: {evaluation}")
    return rec


# -- phase 9: K5 against its plain version ---------------------------------------

# K5 and its plain version add one f32 update to each kept element: the
# results must agree bitwise (max_abs_err 0)
K5_GUARD_ROWS = 64


def _criteo_row_ids(torch):
    """The fused-table row ids ``[8192·26]`` (int32, on the card) of the
    first batch the DLRM phase trains on."""
    from distributeddeeplearningspark_tpu_torch.data.feed import host_batches
    from distributeddeeplearningspark_tpu_torch.data.sources import synthetic_criteo
    from distributeddeeplearningspark_tpu_torch.models.dlrm import fused_flat_ids

    batch = next(host_batches(synthetic_criteo(
        DLRM_BATCH, vocab_sizes=DLRM_VOCABS, num_partitions=4), DLRM_BATCH))
    return fused_flat_ids(DLRM_VOCABS,
                          torch.from_numpy(batch["sparse"]).cuda()).reshape(-1)


def _k5_bound(kept: int, k: int, d: int, idx_bytes: int) -> tuple[float, str]:
    """The ids read once, each kept update row read once and each kept
    table row read and written once; one f32 add per kept element."""
    t_bytes = (k * idx_bytes + 3 * kept * d * 4) / PEAK_BYTES_PER_S * 1e3
    t_ops = kept * d / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k5_case(torch, sr, name, v, d, idx, seed) -> dict:
    """Run K5's wrapper on a [V, D] table that lies between guard rows,
    against the plain version on a copy; bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = K5_GUARD_ROWS
    buf = torch.randn(g + v + g, d, device="cuda", generator=gen)
    table = buf[g:g + v]
    upd = torch.randn(idx.numel(), d, device="cuda", generator=gen)
    before = buf.clone()
    want = sr.scatter_add_rows_reference(table.clone(), idx, upd)
    ptr, launches = table.data_ptr(), sr.scatter_add_rows.launches
    sr.scatter_add_rows(table, idx, upd)
    torch.cuda.synchronize()
    launched = sr.scatter_add_rows.launches - launches
    kept = idx[(idx >= 0) & (idx < v)]
    touched = torch.zeros(v, dtype=torch.bool, device="cuda")
    touched[kept.long()] = True
    moved = (table != before[g:g + v]).any(1)
    rec = dict(case=name, v=v, d=d, k=idx.numel(), kept=kept.numel(),
               idx_dtype=str(idx.dtype).replace("torch.", ""),
               max_abs_err=float((table - want).abs().max()),
               bitwise=bool(torch.equal(table, want)),
               untouched_rows_moved=int((moved & ~touched).sum()),
               guards_intact=bool(torch.equal(buf[:g], before[:g])
                                  and torch.equal(buf[g + v:], before[g + v:])),
               in_place=table.data_ptr() == ptr,
               launched=launched)
    rec["ok"] = (rec["bitwise"] and rec["untouched_rows_moved"] == 0
                 and rec["guards_intact"] and rec["in_place"]
                 and launched == (1 if idx.numel() else 0))
    return rec, table, upd


def check_scatter_rows(torch, sr) -> list[dict]:
    """K5 in five cases, bitwise against its plain version; at the DLRM
    shape the wrapper, the plain version and ``index_add_`` over the kept
    rows are timed (the wrapper and ``index_add_`` from CUDA graphs; the
    plain version, whose boolean mask syncs with the host, between events)."""
    from distributeddeeplearningspark_tpu_torch.train.embed import padded_unique

    v = sum(DLRM_VOCABS)
    flat = _criteo_row_ids(torch)
    uniq, _, counts = padded_unique(flat, v)
    n = counts.numel()
    rng = np.random.default_rng(0)
    sentinels = np.concatenate([v + np.arange(256), -1 - np.arange(256)])
    cases = [
        ("dlrm_step", v, 64, uniq),
        ("dlrm_step_d1", v, 1, uniq),
        ("unsorted_int64_d13", 1000, 13,
         torch.from_numpy(rng.permutation(1000)[:700]).cuda()),
        ("all_sentinels", 1000, 64,
         torch.from_numpy(rng.permutation(sentinels).astype(np.int32)).cuda()),
        ("no_ids", 1000, 64, torch.zeros(0, dtype=torch.int32, device="cuda")),
    ]
    fn = sr.scatter_add_rows
    results = []
    for i, (name, cv, d, idx) in enumerate(cases):
        rec, table, upd = _k5_case(torch, sr, name, cv, d, idx, seed=70 + i)
        if name == "dlrm_step":
            kept_idx, kept_upd = idx[:n], upd[:n]
            bound_ms, bound_by = _k5_bound(n, idx.numel(), d, idx.element_size())
            rec.update(
                ms=graph_ms(torch, lambda: fn(table, idx, upd), 20),
                plain_ms=time_ms(torch, lambda: sr.scatter_add_rows_reference(
                    table, idx, upd), 5),
                library_ms=graph_ms(torch, lambda: table.index_add_(
                    0, kept_idx, kept_upd), 20),
                bound_ms=bound_ms, bound_by=bound_by)
            rec["ns_per_kept_row"] = rec["ms"] * 1e6 / n
        print("K5 scatter_add_rows " + json.dumps(rec), flush=True)
        check(rec["ok"], f"scatter_add_rows disagrees with its plain version "
                         f"on {name}: {rec}")
        results.append(rec)
        del table, upd
        torch.cuda.empty_cache()
    return results


# -- phase 10: training DLRM ------------------------------------------------------


def _tensors(torch, tree) -> list:
    """Every tensor in a tree of tuples and lists (an optimizer state)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(torch, x)]
    return []


def _clone_tree(torch, tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_clone_tree(torch, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(torch, x) for x in tree)
    return tree


def _sparse_step_bits(torch, trainer, batch) -> dict:
    """One more step on ``batch`` from one saved state, three times: K5,
    K5 again, and K5's plain version in its place. The table and row
    accumulator of each, and which rows moved."""
    import dataclasses

    from distributeddeeplearningspark_tpu_torch.ops import scatter_rows as sr
    from distributeddeeplearningspark_tpu_torch.train import embed

    model, state = trainer.model, trainer.state
    (spec,) = trainer.sparse_embed
    table = state.params[spec.param_path]
    accum = state.embed_state[spec.name][embed.ROW_ACCUM]
    saved = {n: p.detach().clone() for n, p in state.params.items()}
    saved_accum, saved_opt = accum.clone(), _clone_tree(torch, state.opt_state)
    runs = {}
    step = embed.make_sparse_embed_train_step(model, trainer.tx, trainer.loss_fn,
                                              (spec,))
    for run, scatter in (("cuda", sr.scatter_add_rows),
                         ("cuda_again", sr.scatter_add_rows),
                         ("plain", sr.scatter_add_rows_reference)):
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(saved[n])
            accum.copy_(saved_accum)
        embed.scatter_add_rows = scatter
        try:
            _, metrics = step(dataclasses.replace(
                state, opt_state=_clone_tree(torch, saved_opt)), batch)
        finally:
            embed.scatter_add_rows = sr.scatter_add_rows
        runs[run] = (table.detach().clone(), accum.clone(), float(metrics["loss"]))
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    touched[spec.ids_fn(batch).reshape(-1).long()] = True
    t, a, _ = runs["cuda"]
    moved = (t != saved[spec.param_path]).any(1)
    acc_moved = a != saved_accum
    same = lambda x, y: bool(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]))  # noqa: E731
    rec = dict(batch_rows=int(touched.sum()), rows_moved=int(moved.sum()),
               rows_moved_outside_batch=int((moved & ~touched).sum()),
               accum_moved_outside_batch=int((acc_moved & ~touched).sum()),
               cuda_equals_plain=same(runs["cuda"], runs["plain"]),
               cuda_deterministic=same(runs["cuda"], runs["cuda_again"]),
               losses={k: r[2] for k, r in runs.items()})
    del runs, saved, saved_opt
    torch.cuda.empty_cache()
    return rec


def train_dlrm(torch, sr) -> dict:
    """The config-4 DLRM at full width through the port's Session →
    synthetic_criteo → Trainer.fit(sparse_embed=...) with binary_xent,
    AdamW(1e-3, no weight decay) on the MLPs (examples/train_dlrm.py) and
    row-wise AdaGrad (lr 1e-2, the JAX bench's) on the table through K5.
    4 batches of examples, seen 7.5 times, so the loss falls."""
    import gc
    import shutil

    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.data import sources
    from distributeddeeplearningspark_tpu_torch.data.feed import device_batches
    from distributeddeeplearningspark_tpu_torch.metrics import StreamingAUC
    from distributeddeeplearningspark_tpu_torch.models import dlrm
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    steps, batch_size, log_every = DLRM_STEPS, DLRM_BATCH, 5
    workdir = ROOT / "build" / "chip_smoke_dlrm"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    spark = Session.builder.master("local[1]").appName("dlrm").getOrCreate()
    ds = sources.synthetic_criteo(4 * batch_size, vocab_sizes=DLRM_VOCABS,
                                  num_partitions=4).repeat()
    model = dlrm.dlrm(DLRM_VOCABS, device="cuda", seed=0)
    table = model.embedding.embedding_table
    check(tuple(table.shape) == (2_600_000, 64) and table.dtype == torch.float32
          and [model.bottom_mlp.dense_0.in_features]
          + [getattr(model.bottom_mlp, f"dense_{i}").out_features for i in range(3)]
          == [13, 512, 256, 64]
          and [getattr(model.top_mlp, f"dense_{i}").out_features for i in range(3)]
          == [512, 256, 1] and model.dtype == torch.bfloat16,
          "dlrm is not the config-4 DLRM at full width")
    specs = dlrm.sparse_embed_specs(model, lr=1e-2)
    trainer = Trainer(spark, model, losses.binary_xent,
                      optim.adamw(1e-3, weight_decay=0.0), sparse_embed=specs)
    setup_s = time.perf_counter() - t0
    os.environ[telemetry.WORKDIR_ENV] = str(workdir)
    gc.collect()  # what earlier phases left, so that the peak is this one's
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sr.scatter_add_rows.launches = 0  # the main path's run starts here
    t_fit = time.perf_counter()
    try:
        state, summary = trainer.fit(ds, batch_size=batch_size, steps=steps,
                                     log_every=log_every)
    finally:
        os.environ.pop(telemetry.WORKDIR_ENV, None)
        telemetry.reset()
    fit_s = time.perf_counter() - t_fit
    launches = sr.scatter_add_rows.launches
    peak_bytes = torch.cuda.max_memory_allocated()

    records = [json.loads(line) for f in sorted(
        (workdir / telemetry.TELEMETRY_DIRNAME).glob("events-*.jsonl"))
        for line in f.read_text().splitlines()]
    logged = [(r["step"], r["metrics"]["loss"]) for r in records
              if r["kind"] == "step_metrics"]
    gauges = _input_gauges(records)
    opt_tensors = _tensors(torch, state.opt_state)
    table_sized = [tuple(t.shape) for t in opt_tensors if t.numel() >= table.numel()]
    host_batch_ms = _host_batch_ms(ds, batch_size, 3)
    profile = _profile_fit(torch, trainer, ds, batch_size, {})
    batch = next(device_batches(ds, batch_size, trainer.device))
    loop_ms = _loop_ms(torch, trainer, batch)
    bits = _sparse_step_bits(torch, trainer, batch)
    eval_src = sources.synthetic_criteo(8 * batch_size, vocab_sizes=DLRM_VOCABS,
                                        seed=777)
    evaluation = trainer.evaluate(eval_src, batch_size=batch_size)
    auc = StreamingAUC()
    model.eval()
    with torch.inference_mode():
        for b in device_batches(eval_src, batch_size, trainer.device,
                                drop_remainder=False):
            auc.update(torch.sigmoid(model(b)).cpu().numpy(), b["label"].cpu().numpy())
    spark.stop()
    step_ms = summary.get("step_time_ms")
    rec = dict(steps=steps, batch_size=batch_size, table_rows=table.shape[0],
               embed_dim=table.shape[1], logged_losses=logged,
               loss_ratio_last_first=logged[-1][1] / logged[0][1] if logged else None,
               step_time_ms=step_ms,
               examples_per_sec_per_chip=summary.get("examples_per_sec_per_chip"),
               k5_launches=launches, k5_launches_per_step=launches / steps,
               optimizer_tensors=len(opt_tensors),
               optimizer_bytes=sum(t.numel() * t.element_size() for t in opt_tensors),
               table_sized_optimizer_tensors=table_sized,
               max_memory_allocated=peak_bytes, fit_s=fit_s, setup_s=setup_s,
               host_batch_ms=host_batch_ms, loop_ms=loop_ms, input=gauges,
               profile=profile,
               extra_step=bits, evaluation=evaluation, eval_examples=8 * batch_size,
               eval_auc=auc.compute())
    print("train dlrm " + json.dumps(rec), flush=True)
    check(len(logged) == steps // log_every,
          f"{len(logged)} step_metrics records for {steps} steps")
    check(all(np.isfinite(loss) for _, loss in logged),
          f"non-finite logged loss: {logged}")
    check(logged[-1][1] < logged[0][1], f"loss did not fall: {logged}")
    check(launches == steps * len(specs),
          f"K5 launched {launches} times in {steps} steps, want one per step")
    check(not table_sized, f"optimizer tensors of table size: {table_sized}")
    check(bits["rows_moved"] > 0 and bits["rows_moved_outside_batch"] == 0
          and bits["accum_moved_outside_batch"] == 0,
          f"the sparse step moved rows outside its batch: {bits}")
    check(bits["cuda_equals_plain"],
          "K5's step and the plain scatter's step give different tables")
    check(bits["cuda_deterministic"], "two K5 steps give different tables")
    check(all(np.isfinite(v) for v in evaluation.values())
          and {"loss", "accuracy"} <= set(evaluation),
          f"evaluation not finite: {evaluation}")
    return rec


# -- phase 11: LeNet-5 through the port's dlsubmit ------------------------------

#: steps of the profiled window of each rank
LENET_WINDOW = 20


def _running(script: Path) -> set[int]:
    """The pids of the processes whose command line names ``script``."""
    pids = set()
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if str(script).encode() in (d / "cmdline").read_bytes():
                    pids.add(int(d.name))
            except OSError:
                continue
    return pids


def _launch(workdir: Path, ranks: int, script: Path, args, *,
            deterministic: bool = False, timeout: float = 300,
            pids: set | None = None, env: dict | None = None
            ) -> tuple[list[str], dict]:
    """One launch of ``script`` through the port's cli at ``local[ranks]`` on
    the card (optionally with deterministic algorithms), its telemetry in
    ``workdir``: rank 0's stdout lines, and the launch's wall seconds with
    the part before rank 0's run began (process start, CUDA, the group) and
    the run's own, from its telemetry. Fails on a non-zero exit. ``pids``
    receives the pids of the launch's ranks and of the workers they fork,
    seen every 0.2 s while it runs. ``env`` is added to the launch's
    environment."""
    conf = ["--conf", "spark.dls.deterministic=true"] if deterministic else []
    cmd = [sys.executable, "-m", f"{PKG}.cli", "--master", f"local[{ranks}]",
           *conf, "--workdir", str(workdir), str(script), *args]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, **(env or {})})
    while True:
        try:
            stdout, stderr = proc.communicate(timeout=0.2)
            break
        except subprocess.TimeoutExpired:
            if pids is not None:
                pids |= _running(script)
            if time.time() - t0 > timeout:
                proc.kill()
                proc.communicate()
                raise
    out = subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)
    wall_s = time.time() - t0
    check(out.returncode == 0, f"launch of {script.name} {list(args)} exited "
          f"{out.returncode}: {out.stderr[-2000:]}")
    runs = [r["ts"] for r in _events(workdir, "p0") if r["kind"] == "phase"
            and r.get("name") == "run" and r["ts"] >= t0]
    return out.stdout.splitlines(), dict(
        wall_s=wall_s, before_run_s=runs[0] - t0 if runs else None,
        run_s=runs[-1] - runs[0] if len(runs) >= 2 else None)


def _lenet_launch(workdir: Path, ranks: int, *args: str, script: Path | None = None
                  ) -> tuple[list[str], dict]:
    """:func:`_launch` with deterministic algorithms of ``script`` (default:
    the port's examples/train_mnist.py, checkpointing into ``workdir``)."""
    if script is None:
        script = ROOT / PKG / "examples" / "train_mnist.py"
        args = ("--batch-size", str(LENET_BATCH), "--checkpoint-every",
                str(LENET_EVERY), "--checkpoint-dir", str(workdir / "ckpt"), *args)
    return _launch(workdir, ranks, script, args, deterministic=True)


def _lenet_result(workdir: Path, ranks: int, *args: str) -> tuple[dict, dict]:
    """A launch of the example; rank 0's JSON result line."""
    lines, timing = _lenet_launch(workdir, ranks, *args)
    results = [line for line in lines if line.startswith('{"train"')]
    check(len(results) == 1, f"lenet launch {args} printed {len(results)} "
          f"result lines: {lines[-20:]}")
    return json.loads(results[0]), timing


def _events(workdir: Path, process: str = "*") -> list[dict]:
    return [json.loads(line)
            for f in sorted((workdir / "telemetry").glob(f"events-{process}.jsonl"))
            for line in f.read_text().splitlines()]


def _phase_ms(records: list[dict], name: str) -> list[float]:
    return [r["dur_s"] * 1e3 for r in records if r["kind"] == "phase"
            and r.get("name") == name and r.get("edge") == "end"]


def lenet_rank() -> int:
    """One rank of the profiled gang (``chip_smoke.py --lenet-rank``, run by
    the port's cli): LENET_WINDOW LeNet steps, then as many under the
    profiler; rank 0 prints the profile."""
    import torch

    from distributeddeeplearningspark_tpu_torch.data import sources
    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    spark = Session.builder.appName("lenet-profile").getOrCreate()
    ds = sources.synthetic_mnist(
        4096, num_partitions=spark.default_parallelism).repeat()
    trainer = Trainer(spark, LeNet5(device=spark.device), losses.softmax_xent,
                      optim.sgd(0.01, momentum=0.9))
    trainer.fit(ds, batch_size=LENET_BATCH, steps=LENET_WINDOW, log_every=LENET_WINDOW)
    profile = _profile_fit(torch, trainer, ds, LENET_BATCH, {}, steps=LENET_WINDOW)
    if spark.rank == 0:
        print("lenet profile " + json.dumps(dict(
            profile, backend=spark.backend, world_size=spark.world_size)), flush=True)
    spark.stop()
    return 0


def train_lenet(torch, ranks: int = 1) -> dict:
    """LeNet-5 (config 1) through the port's cli → Session (NCCL, ``ranks``
    processes, one card each) → synthetic_mnist → Trainer.fit with
    checkpoints → resume, resume parity, the walk-back past a corrupt step,
    and a profiled window."""
    import shutil

    from distributeddeeplearningspark_tpu_torch import checkpoint as ckpt_lib
    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.data import sources
    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    root = ROOT / "build" / f"chip_smoke_lenet_{ranks}"
    shutil.rmtree(root, ignore_errors=True)
    main_dir, half_dir, bad_dir = root / "main", root / "half", root / "walk_back"

    # the main path: 150 steps through the cli, then a resume to 200
    res, main_s = _lenet_result(main_dir, ranks, "--steps", str(LENET_STEPS))
    kept = ckpt_lib.Checkpointer(main_dir / "ckpt").all_steps()
    verified = {s: ckpt_lib.verify_step_dir(str(main_dir / "ckpt" / str(s)))
                for s in kept}
    main_records = _events(main_dir)
    resumed, resume_s = _lenet_result(main_dir, ranks, "--steps", str(LENET_RESUME_TO),
                                      "--resume")
    records = _events(main_dir)

    # resume parity: 75 steps, then a resume to 150, against the 150 straight
    half, _ = _lenet_result(half_dir, ranks, "--steps", str(LENET_STEPS // 2))
    half_resumed, _ = _lenet_result(half_dir, ranks, "--steps", str(LENET_STEPS),
                                    "--resume")

    def saved(d: Path, step: int) -> dict:
        return torch.load(d / "ckpt" / str(step) / ckpt_lib.STATE_FILE,
                          map_location="cpu", weights_only=True)

    straight, split = saved(main_dir, LENET_STEPS), saved(half_dir, LENET_STEPS)
    mismatched = [k for k in straight["params"]
                  if not torch.equal(straight["params"][k], split["params"][k])]
    mismatched += [f"opt_state[{i}]" for i, (a, b) in enumerate(
        zip(straight["opt_state"], split["opt_state"]))
        if isinstance(a, torch.Tensor) and not torch.equal(a, b)]

    # the walk-back: a copy of the newest step with one byte flipped
    shutil.copytree(half_dir / "ckpt", bad_dir)
    newest = max(int(p.name) for p in bad_dir.iterdir() if p.name.isdigit())
    target = bad_dir / str(newest) / ckpt_lib.STATE_FILE
    raw = bytearray(target.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    target.write_bytes(bytes(raw))
    spark = Session.builder.master("local[1]").appName("lenet").getOrCreate()
    trainer = Trainer(spark, LeNet5(device=spark.device), losses.softmax_xent,
                      optim.sgd(0.01, momentum=0.9),
                      checkpointer=ckpt_lib.Checkpointer(bad_dir))
    walked, walked_data = trainer.restore()
    walked_step = walked.step
    walked_equal = all(torch.equal(walked.params[k].cpu(), v) for k, v in
                       saved(half_dir, walked_step)["params"].items())
    quarantined = sorted(p.name for p in bad_dir.iterdir() if ".corrupt-" in p.name)
    spark.stop()
    telemetry.reset()  # the restore bound the process's writer to bad_dir

    # the gang again, this script as each rank's: a profiled window
    lines, _ = _lenet_launch(root / "profile", ranks, "--lenet-rank",
                             script=Path(__file__).resolve())
    found = [line for line in lines if line.startswith("lenet profile ")]
    check(len(found) == 1, f"the profiled gang printed {lines[-20:]}")
    profile = json.loads(found[0][len("lenet profile "):])
    host_batch_ms = _host_batch_ms(sources.synthetic_mnist(4096, num_partitions=1),
                                   LENET_BATCH, 20)

    save_ms = _phase_ms(main_records, "checkpoint")
    restore_ms = _phase_ms([r for r in records if r["process"] == "p0"], "restore")
    logged = [(r["step"], r["metrics"]["loss"]) for r in main_records
              if r["kind"] == "step_metrics" and r["process"] == "p0"]
    families = profile.get("busy_ms_by_family", {})
    comms = profile.get("collectives", {})
    summary = res["train"]
    rec = dict(ranks=ranks, steps=LENET_STEPS, batch_size=LENET_BATCH,
               backend=res["backend"], device=res["device"],
               world_size=res["world_size"], grad_allreduces=res["grad_allreduces"],
               test=res["test"], step_time_ms=summary.get("step_time_ms"),
               examples_per_sec=summary.get("examples_per_sec"),
               examples_per_sec_per_chip=summary.get("examples_per_sec_per_chip"),
               host_batch_ms=host_batch_ms,
               input=_input_gauges([r for r in main_records if r["process"] == "p0"]),
               busy_ms_per_step=profile.get("busy_ms_per_step"),
               idle_share=profile.get("idle_share"),
               # NCCL's one-rank all-reduce in place launches no kernel
               allreduce_device_ms_per_step=families.get("nccl", 0.0),
               allreduce_host_ms_per_step=max(
                   (c["host_ms_per_step"] for c in comms.values()), default=None),
               profile=profile,
               checkpoint_save_ms=sum(save_ms) / len(save_ms) if save_ms else None,
               checkpoint_saves=len(save_ms),
               restore_ms=restore_ms[-1] if restore_ms else None,
               kept_steps=kept, verified={s: v[1] for s, v in verified.items()},
               resumed_from=resumed["restored_step"],
               resumed_data_state=resumed["data_state"], resumed_to=resumed["step"],
               resume_parity="bitwise (deterministic algorithms on)",
               resume_parity_mismatched=mismatched, walked_back_to=walked_step,
               walked_back_data_state=walked_data, quarantined=quarantined,
               launch=dict(main=main_s, resume=resume_s), logged_losses=logged,
               nvidia_smi=nvidia_smi_line())
    print("train lenet " + json.dumps(rec), flush=True)
    check(res["backend"] == "nccl" and res["device"] == "cuda:0"
          and res["world_size"] == ranks, f"rank 0 ran on {res['backend']} "
          f"{res['device']} at world size {res['world_size']}")
    check(res["step"] == LENET_STEPS and res["grad_allreduces"] == LENET_STEPS,
          f"{res['grad_allreduces']} gradient all-reduces in {res['step']} steps")
    check(res["test"]["accuracy"] > 0.9, f"held-out accuracy {res['test']}")
    check(len(logged) == LENET_STEPS // LENET_EVERY
          and all(np.isfinite(loss) for _, loss in logged),
          f"step_metrics records: {logged}")
    check(len(save_ms) == LENET_STEPS // LENET_EVERY
          and len(save_ms) == len([r for r in main_records if r["kind"] == "phase"
                                   and r.get("name") == "checkpoint"
                                   and r.get("edge") == "begin"]),
          f"{len(save_ms)} checkpoint phase records for {LENET_STEPS} steps")
    check(kept == [100, 125, 150] and all(v[0] for v in verified.values()),
          f"kept steps {kept}, verification {verified}")
    check(resumed["restored_step"] == LENET_STEPS and resumed["step"] == LENET_RESUME_TO
          and resumed["data_state"] == {"examples_seen": LENET_STEPS * LENET_BATCH,
                                        "batch_size": LENET_BATCH}
          and resumed["grad_allreduces"] == LENET_RESUME_TO - LENET_STEPS,
          f"resume: {resumed}")
    check(half["step"] == LENET_STEPS // 2
          and half_resumed["restored_step"] == LENET_STEPS // 2
          and not mismatched, f"75 + resume to 150 differs from 150 straight "
          f"in {mismatched}")
    check(walked_step == newest - LENET_EVERY and walked_equal
          and quarantined == [f"{newest}.corrupt-0"]
          and walked_data == {"examples_seen": walked_step * LENET_BATCH,
                              "batch_size": LENET_BATCH},
          f"walk-back: step {walked_step}, quarantined {quarantined}")
    # two all-reduces a step (the loss weights with the metrics, the
    # grads); across cards NCCL's kernels run them on the device
    check(profile["backend"] == "nccl" and profile["world_size"] == ranks
          and any(c["calls"] >= 2 * LENET_WINDOW for c in comms.values())
          and (ranks == 1 or families.get("nccl", 0.0) > 0),
          f"the profiled window's collectives: {comms}, {families}")
    return rec


# -- phase 12: the ResNet-50 and DLRM drivers through the port's dlsubmit -------

#: steps and log interval of each driver run on one card
DRIVER_STEPS, DRIVER_LOG_EVERY = 10, 5
#: held-out examples of the DLRM driver's AUC
DRIVER_EVAL_EXAMPLES = 32_768
#: ResNet-50's BatchNorm layers (53), each one all-reduce forward and one
#: backward a step: all_reduce_sum's collectives in a step
BN_ALLREDUCES_PER_STEP = 2 * 53


def _driver_script(name: str) -> Path:
    return ROOT / PKG / "examples" / f"train_{name}.py"


def _driver_args(name: str, *, steps: int, log_every: int, workers: int | None = None,
                 parts: int | None = None) -> list[str]:
    """The driver's flags at full width: ResNet-50 at b=256, 224², 1000
    classes; the config-4 DLRM, 26 × 100,000 × 64, at b=8,192."""
    if name == "resnet":
        args = ["--batch-size", str(RESNET_BATCH), "--image-size", "224",
                "--num-classes", "1000"]
        if workers is not None:
            args += ["--data-workers", str(workers)]
    else:
        args = ["--batch-size", str(DLRM_BATCH), "--vocab-size", str(DLRM_VOCABS[0]),
                "--num-sparse", str(len(DLRM_VOCABS)), "--embed-dim", "64",
                "--eval-examples", str(DRIVER_EVAL_EXAMPLES)]
    args += ["--steps", str(steps), "--log-every", str(log_every)]
    if parts:
        args += ["--source-partitions", str(parts)]
    return args


def _left_behind(script: Path, pids: set) -> dict:
    """Processes still running ``script`` (a rank, or a worker it forked)
    and the ``dlsw-<pid>-`` segments of the launch's processes ``pids``
    (those of another program on the machine are not this run's), after a
    bounded moment for them to end."""
    deadline = time.monotonic() + 10.0
    while True:
        procs = sorted(_running(script))
        segments = sorted(f for f in os.listdir("/dev/shm")
                          if f.startswith("dlsw-")
                          and f.split("-")[1].isdigit() and int(f.split("-")[1]) in pids)
        left = {k: v for k, v in dict(processes=procs, segments=segments).items() if v}
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.1)


def _driver_run(name: str, workdir: Path, ranks: int, args: list[str],
                env: dict | None = None) -> dict:
    """One launch of the port's ``name`` driver through its cli at
    ``local[ranks]``: rank 0's JSON line, the launch's timing, each rank's
    logged losses and step ms (its laps after the first, from its
    telemetry), and what of the run outlived it."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    script = _driver_script(name)
    pids: set[int] = set()
    lines, timing = _launch(workdir, ranks, script, args, timeout=600, pids=pids,
                            env=env)
    results = [json.loads(x) for x in lines if x.startswith('{"train"')]
    check(len(results) == 1, f"{name} driver printed {len(results)} result "
          f"lines: {lines[-20:]}")
    losses: dict[str, list] = {}
    laps: dict[str, list] = {}
    for r in _events(workdir):
        if r["kind"] == "step_metrics":
            losses.setdefault(r["process"], []).append(r["metrics"]["loss"])
            laps.setdefault(r["process"], []).append(r["lap_s"] * 1e3 / r["steps"])
    step_ms = {p: float(np.mean(v[1:] if len(v) > 1 else v)) for p, v in laps.items()}
    return dict(result=results[0], launch=timing, losses=losses, workdir=workdir,
                step_ms_by_rank=step_ms, left=_left_behind(script, pids))


def train_drivers(torch) -> dict:
    """The port's examples/train_resnet.py and examples/train_dlrm.py
    through its cli at ``local[1]`` (a gang of one, NCCL), at full width,
    DRIVER_STEPS steps each: each exits 0, K4 ran 27 times a step and the
    BatchNorm all-reduces 106 times (K5 once a step), the logged losses are
    finite, the AUC is a probability, and nothing of either run is left."""
    root = ROOT / "build" / "chip_smoke_drivers"
    w = input_workers()
    runs = {
        "resnet": _driver_run("resnet", root / "resnet", 1, _driver_args(
            "resnet", steps=DRIVER_STEPS, log_every=DRIVER_LOG_EVERY, workers=w)),
        "dlrm": _driver_run("dlrm", root / "dlrm", 1, _driver_args(
            "dlrm", steps=DRIVER_STEPS, log_every=DRIVER_LOG_EVERY)),
    }
    rec = {name: dict(step_time_ms=run["result"]["train"].get("step_time_ms"),
                      launch=run["launch"], logged_losses=run["losses"].get("p0"),
                      left=run["left"], **{k: v for k, v in run["result"].items()
                                           if k != "train"})
           for name, run in runs.items()}
    rec["workers"] = w
    print("train drivers " + json.dumps(rec), flush=True)
    for name, run in runs.items():
        res = run["result"]
        check(res["backend"] == "nccl" and res["device"] == "cuda:0"
              and res["world_size"] == 1 and res["step"] == DRIVER_STEPS,
              f"{name} driver: {res}")
        logged = run["losses"].get("p0", [])
        check(len(logged) == DRIVER_STEPS // DRIVER_LOG_EVERY
              and all(np.isfinite(x) for x in logged),
              f"{name} driver's logged losses: {logged}")
        check(not run["left"], f"{name} driver left {run['left']}")
    res = runs["resnet"]["result"]
    check(res["variant"] == "resnet50" and res["k4_launches"] == 27 * DRIVER_STEPS,
          f"the resnet driver launched K4 {res['k4_launches']} times in "
          f"{DRIVER_STEPS} steps, want 27 a step")
    check(res["bn_allreduces_per_step"] == BN_ALLREDUCES_PER_STEP,
          f"{res['bn_allreduces_per_step']} BatchNorm all-reduces a step, want "
          f"{BN_ALLREDUCES_PER_STEP}")
    res = runs["dlrm"]["result"]
    check(res["k5_launches"] == DRIVER_STEPS,
          f"the dlrm driver launched K5 {res['k5_launches']} times in "
          f"{DRIVER_STEPS} steps, want one a step")
    check(0.0 <= res["eval_auc"] <= 1.0, f"the dlrm driver's AUC: {res['eval_auc']}")
    return rec


#: the observed ResNet driver's steps (its window: steps min(10, steps // 2)
#: to the end, the driver's own choice)
OBSERVED_DRIVER_STEPS = 6


def train_resnet_driver_observed(torch) -> dict:
    """The port's examples/train_resnet.py through its cli at ``local[1]``
    with ``--profile-dir --mfu --tensorboard-dir``, ResNet-50 at full width
    for OBSERVED_DRIVER_STEPS steps: it exits 0, its window's breakdown
    holds the ``k4`` family at 27 launches a step, its summary's MFU is
    finite, and whether the TensorBoard writer ran is printed (the card's
    machine may lack the ``tensorboard`` package: then the driver warns and
    logs to files only)."""
    from distributeddeeplearningspark_tpu_torch.utils import profiling

    wd = ROOT / "build" / "chip_smoke_drivers" / "resnet_observed"
    steps = OBSERVED_DRIVER_STEPS
    run = _driver_run("resnet", wd, 1, _driver_args(
        "resnet", steps=steps, log_every=1, workers=input_workers()) + [
        "--profile-dir", str(wd / "profile"), "--mfu",
        "--tensorboard-dir", str(wd / "tb")])
    res = run["result"]
    window_steps = steps - min(10, steps // 2)
    traces = profiling.trace_files(str(wd / "profile"))
    window = _window(traces[-1], window_steps) if traces else {}
    k4 = _launches_per_step(window, {"k4": "matmul_stats_kernel"})["k4"]
    laps = [r for r in _events(wd) if r["kind"] == "step_metrics"]
    rec = dict(step_time_ms=res["train"].get("step_time_ms"),
               mfu=res["train"].get("mfu"), launch=run["launch"],
               flops_per_step=laps[-1].get("flops_per_step") if laps else None,
               lap_mfu=[r.get("mfu") for r in laps],
               lap_mfu_device=[r.get("mfu_device") for r in laps],
               memory_events=sum(r["kind"] == "memory" for r in _events(wd)),
               traces=len(traces), window_k4_launches_per_step=k4,
               busy_ms_by_family=window.get("busy_ms_by_family"),
               idle_share=window.get("idle_share"),
               tensorboard_ran=bool(list((wd / "tb").glob("events.out.tfevents.*"))),
               left=run["left"])
    print("resnet driver observed " + json.dumps(rec), flush=True)
    check(res["step"] == steps and res["k4_launches"] == 27 * steps,
          f"the observed resnet driver: {res}")
    check(len(traces) == 1 and "k4" in (window.get("busy_ms_by_family") or {})
          and k4 == 27, f"the resnet driver's window: {len(traces)} traces, "
          f"families {window.get('busy_ms_by_family')}, K4 {k4} a step")
    check(rec["mfu"] is not None and np.isfinite(rec["mfu"]) and rec["mfu"] > 0,
          f"the resnet driver's MFU: {rec['mfu']}")
    check(not run["left"], f"the observed resnet driver left {run['left']}")
    return rec


# -- phase 13: global BatchNorm statistics from two halves, on one card ---------

#: each BatchNorm's batch statistics from the two halves' sums against the
#: whole batch's: |Δmean| <= tol·sqrt(var) and |Δvar| <= tol·var per
#: channel. The halves' convolutions (b=128 against 256) and K4's partial
#: sums round their bf16 activations differently, which 50 layers compound
BN_HALVES_TOL = 2e-2
BN_HALVES_BATCH = RESNET_BATCH


def _bn_step(torch, rows: slice) -> dict:
    """ResNet-50 (seed 0, fused) on ``rows`` of a fixed batch of 256: one
    forward in train mode and one backward of the whole batch's mean loss
    restricted to these rows; each BatchNorm's batch mean and variance
    (read back from its running statistics, which start at 0 and 1), every
    param gradient, K4's launches and all_reduce_sum's collectives."""
    import torch.nn.functional as F

    from distributeddeeplearningspark_tpu_torch.models import resnet
    from distributeddeeplearningspark_tpu_torch.ops import conv_bn as cb
    from distributeddeeplearningspark_tpu_torch.ops.conv_bn import BN_MOMENTUM
    from distributeddeeplearningspark_tpu_torch.parallel import collectives

    model = resnet.resnet50(device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(BN_HALVES_BATCH, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (BN_HALVES_BATCH,), generator=gen, device="cuda")
    k4, calls = cb.matmul_stats.launches, collectives.all_reduce_sum.calls
    logits = model({"image": images[rows]})
    loss = F.cross_entropy(logits, labels[rows], reduction="sum") / BN_HALVES_BATCH
    loss.backward()
    torch.cuda.synchronize()
    keep = 1 - BN_MOMENTUM
    stats = {}
    for name, b in model.named_buffers():
        b = b.detach().double().cpu()
        stats[name] = b / keep if name.endswith(".mean") else (b - BN_MOMENTUM) / keep
    return dict(stats=stats, loss=float(loss.detach()),
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                k4_launches=cb.matmul_stats.launches - k4,
                allreduces=collectives.all_reduce_sum.calls - calls)


def bn_half_rank(rank: int, port: int, out: str) -> int:
    """One half of the batch (``chip_smoke.py --bn-half-rank R PORT OUT``):
    two such processes share the card through a gloo group, which sums
    their CUDA tensors as ``all_reduce_sum`` asks."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    half = BN_HALVES_BATCH // 2
    torch.save(_bn_step(torch, slice(rank * half, (rank + 1) * half)), out)
    dist.destroy_process_group()
    return 0


def check_bn_halves(torch) -> dict:
    """ResNet-50 at b=256 as the two halves of a batch, one process each on
    this card, against the whole batch in this process: every BatchNorm's
    batch mean and variance are the same bits on both halves and the whole
    batch's at BN_HALVES_TOL, and the two halves' param gradients, summed,
    are the whole batch's at the tolerance of K4's gradient parity; each
    half launched K4 27 times and made 106 all-reduces."""
    import socket

    root = ROOT / "build" / "chip_smoke_bn_halves"
    root.mkdir(parents=True, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outs = [root / f"half{r}.pt" for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--bn-half-rank", str(r), str(port), str(outs[r])],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            check(p.returncode == 0, f"a BatchNorm half exited {p.returncode}: "
                  f"{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    halves_s = time.perf_counter() - t0
    halves = [torch.load(o, weights_only=True) for o in outs]
    whole = _bn_step(torch, slice(0, BN_HALVES_BATCH))
    equal = all(torch.equal(halves[0]["stats"][k], halves[1]["stats"][k])
                for k in whole["stats"])
    worst = (0.0, None)
    layers = [k[:-len(".mean")] for k in whole["stats"] if k.endswith(".mean")]
    for layer in layers:
        mean_w, var_w = whole["stats"][f"{layer}.mean"], whole["stats"][f"{layer}.var"]
        mean_h, var_h = halves[0]["stats"][f"{layer}.mean"], halves[0]["stats"][f"{layer}.var"]
        used = max(float(((mean_h - mean_w).abs() / (BN_HALVES_TOL * var_w.clamp_min(1e-12).sqrt())).max()),
                   float(((var_h - var_w).abs() / (BN_HALVES_TOL * var_w.clamp_min(1e-12))).max()))
        if used > worst[0]:
            worst = (used, layer)
    summed = {n: halves[0]["grads"][n] + halves[1]["grads"][n] for n in whole["grads"]}
    grads = _compare_grads(torch, summed, whole["grads"], RESNET_PARITY_RTOL,
                           RESNET_PARITY_ATOL)
    rec = dict(batch=BN_HALVES_BATCH, layers=len(layers), halves_stats_equal=equal,
               stats_max_tolerance_used=worst[0], stats_worst_layer=worst[1],
               stats_tolerance=f"|dmean| <= {BN_HALVES_TOL}*std, "
                               f"|dvar| <= {BN_HALVES_TOL}*var per channel",
               loss_whole=whole["loss"], loss_halves=[h["loss"] for h in halves],
               grads=grads, k4_launches=[h["k4_launches"] for h in halves],
               allreduces=[h["allreduces"] for h in halves], halves_s=halves_s)
    print("bn halves " + json.dumps(rec), flush=True)
    check(len(layers) == 53, f"{len(layers)} BatchNorm layers, want 53")
    check(equal, "the two halves' BatchNorm statistics differ")
    check(worst[0] <= 1.0, f"BatchNorm statistics from the halves are off the "
          f"whole batch's: {worst}")
    check(grads["max_tolerance_used"] <= 1.0,
          f"the halves' summed gradients are off the whole batch's: {grads['worst']}")
    check(all(h["k4_launches"] == 27 for h in halves) and whole["k4_launches"] == 27,
          f"K4 launches {rec['k4_launches']}, whole {whole['k4_launches']}")
    check(all(h["allreduces"] == BN_ALLREDUCES_PER_STEP for h in halves)
          and whole["allreduces"] == 0, f"all-reduces {rec['allreduces']}")
    return rec


# -- phase 14: the recovery chain, on one card ----------------------------------

#: ResNet-50 under on_nonfinite="skip": steps, and the step DLS_FAULT poisons
SKIP_STEPS, SKIP_AT = 6, 3
#: BERT-base under on_nonfinite="rollback" with eval inside fit: steps,
#: checkpoint and eval interval, the poisoned step, the held-out set
ROLLBACK_STEPS, ROLLBACK_EVERY, ROLLBACK_AT, ROLLBACK_EVAL_EXAMPLES = 8, 4, 6, 64
#: the rollback's final params against a run restored at the rollback's
#: step and fed from its feed position (relative, over every param): the
#: same kernels on the same inputs; 0 where the bits agree
ROLLBACK_RTOL = 1e-6
#: every eval_* value fit logs against Trainer.evaluate at the same step
EVAL_RTOL = 1e-6
#: the supervised LeNet drill: the fault and the checkpoint interval; the
#: run's steps and batch are the LeNet phase's, whose 150 straight steps it
#: is held to bitwise. The kill comes after the step-8 save, which joins
#: the step-4 save's asynchronous write first, so step 4 is committed by
#: then (step 8 may be too). A kill at step 8 races that write:
#: ``--ckpt-commit`` timed it at 16–45 ms from queue to commit against
#: 26–48 ms from queue to the end of step 7, and 1 of 32 writes committed
#: after it (the same on the tree before the preemption drain; an H100
#: 80GB HBM3 at 700 W)
CRASH_AT, CRASH_EVERY = 10, 4


def _capture_logged(logger_name: str):
    """A handler on a MetricLogger's logger and the list it fills with
    ``(step, metrics)`` of each ``step N: {json}`` line."""
    import logging

    got: list = []

    class Grab(logging.Handler):
        def emit(self, record):
            if record.msg == "step %d: %s":
                step, text = record.args
                got.append((step, json.loads(text)))

    lg = logging.getLogger(logger_name)
    handler = Grab(logging.INFO)
    lg.setLevel(logging.INFO)
    lg.addHandler(handler)
    return got, lambda: lg.removeHandler(handler)


def _syncs_per_step(torch, trainer, batch, steps: int = 5) -> tuple[float, list]:
    """Host syncs a train step makes (on one batch already on the card,
    after two warm steps), as ``torch.cuda.set_sync_debug_mode("warn")``
    reports them, and the Python lines they came from."""
    import warnings

    for _ in range(2):
        trainer.state, _ = trainer._train_step(trainer.state, batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                trainer.state, _ = trainer._train_step(trainer.state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    return len(syncs) / steps, sorted({f"{Path(w.filename).name}:{w.lineno}"
                                       for w in syncs})


def recovery_skip_resnet(torch, cb) -> dict:
    """ResNet-50 at b=256 under ``fit(on_nonfinite="skip")`` with
    ``DLS_FAULT=nan@3``: the poisoned step leaves every param, SGD trace
    and BatchNorm statistic bitwise as step 2 left them; the guard's loop
    ms and host syncs a step against the step without it."""
    from distributeddeeplearningspark_tpu_torch.data import sources, vision
    from distributeddeeplearningspark_tpu_torch.data.feed import device_batches
    from distributeddeeplearningspark_tpu_torch.models import resnet
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.state import leaves
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    spark = Session.builder.master("local[1]").appName("resnet50-skip").getOrCreate()
    workers = input_workers()
    src = sources.synthetic_images(4 * RESNET_BATCH, image_size=224,
                                   num_classes=1000, num_partitions=workers)
    ds = vision.imagenet_train(src, size=224, repeat=True, num_workers=workers)
    model = resnet.resnet50(num_classes=1000, fused_conv_bn=True, device="cuda", seed=0)
    tx = optim.sgd(optim.warmup_cosine(0.1, 1, SKIP_STEPS), momentum=0.9,
                   weight_decay=1e-4)
    trainer = Trainer(spark, model, losses.softmax_xent, tx)
    snaps: dict[int, dict] = {}

    def snapshot(step, _metrics):
        if step in (SKIP_AT - 1, SKIP_AT):
            st = trainer.state
            snaps[step] = {
                **{f"param {k}": v.detach().clone() for k, v in st.params.items()},
                **{f"opt {i}": t.clone() for i, t in enumerate(
                    x for x in leaves(st.opt_state) if isinstance(x, torch.Tensor))},
                **{f"buffer {k}": v.clone() for k, v in st.mutable.items()}}

    got, done = _capture_logged(f"{PKG}.metrics")
    os.environ["DLS_FAULT"] = f"nan@{SKIP_AT}"
    cb.matmul_stats.launches = 0  # the path's run starts here
    try:
        _, summary = trainer.fit(ds, batch_size=RESNET_BATCH, steps=SKIP_STEPS,
                                 log_every=1, on_nonfinite="skip",
                                 callbacks=[snapshot])
    finally:
        os.environ.pop("DLS_FAULT", None)
        done()
    launches = cb.matmul_stats.launches
    before, after = snaps[SKIP_AT - 1], snaps[SKIP_AT]
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    kinds = {kind: sum(k.startswith(kind) for k in before)
             for kind in ("param", "opt", "buffer")}
    losses_by_step = {s: m["loss"] for s, m in got if "loss" in m}
    skipped_by_step = {s: m["skipped"] for s, m in got if "skipped" in m}
    guard_bytes = trainer._train_step.guard.nbytes
    snaps.clear()

    batch = next(device_batches(ds, RESNET_BATCH, trainer.device))
    batch = {k: v for k, v in batch.items()}
    timing: dict[str, list] = {"guard": [], "plain": []}
    syncs: dict[str, list] = {"guard": [], "plain": []}
    sites: dict[str, list] = {}
    for guarded in (False, True, False, True):  # in turns, in this call
        trainer._guard_nonfinite = guarded
        trainer._build_train_step()
        key = "guard" if guarded else "plain"
        timing[key].append(_loop_ms(torch, trainer, batch))
        n, where = _syncs_per_step(torch, trainer, batch)
        syncs[key].append(n)
        sites[key] = sorted(set(sites.get(key, [])) | set(where))
    spark.stop()
    rec = dict(steps=SKIP_STEPS, batch_size=RESNET_BATCH, poisoned_step=SKIP_AT,
               skipped_steps=summary.get("skipped_steps"), k4_launches=launches,
               logged_losses=losses_by_step, skipped_by_step=skipped_by_step,
               held=kinds, moved_at_poisoned_step=moved[:5],
               guard_snapshot_bytes=guard_bytes,
               loop_ms_guard=float(np.mean(timing["guard"])),
               loop_ms_plain=float(np.mean(timing["plain"])),
               loop_ms_runs=timing, host_syncs_per_step=syncs, host_sync_sites=sites,
               card=nvidia_smi_line())
    print("recovery skip resnet-50 " + json.dumps(rec), flush=True)
    check(summary.get("skipped_steps") == 1.0,
          f"skipped_steps {summary.get('skipped_steps')}, want 1")
    # the opt state: SGD's trace a param and the schedule's count
    check(not moved and kinds["opt"] == len(trainer.state.params) + 1
          and kinds["buffer"] == 106,
          f"the poisoned step moved {moved[:5]} (held {kinds})")
    check(not np.isfinite(losses_by_step[SKIP_AT])
          and all(np.isfinite(losses_by_step[s]) for s in range(SKIP_AT + 1, SKIP_STEPS + 1)),
          f"logged losses {losses_by_step}")
    check(skipped_by_step == {s: float(s == SKIP_AT) for s in range(1, SKIP_STEPS + 1)},
          f"skipped by step {skipped_by_step}")
    check(launches == 27 * SKIP_STEPS,
          f"K4 launched {launches} times in {SKIP_STEPS} steps, want 27 per step")
    check(max(syncs["guard"]) <= min(syncs["plain"]),
          f"host syncs a step with the guard {syncs['guard']}, without "
          f"{syncs['plain']} ({sites})")
    return rec


def recovery_rollback_bert(torch, fa) -> dict:
    """BERT-base MLM at b=32, S=512 under ``fit(on_nonfinite="rollback")``
    with ``DLS_FAULT=nan@6``, checkpoints every 4 steps and eval inside fit
    every 4: one rollback to step 4; the final params against a second run
    restored at step 4 and fed from examples_seen = 6 batches; every logged
    eval_* against Trainer.evaluate at the same step; save and restore ms."""
    import shutil

    from distributeddeeplearningspark_tpu_torch import metrics as metrics_mod
    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer
    from distributeddeeplearningspark_tpu_torch.data import text
    from distributeddeeplearningspark_tpu_torch.models import bert
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    batch_size, seq = 32, 512
    workdir = ROOT / "build" / "chip_smoke_rollback"
    shutil.rmtree(workdir, ignore_errors=True)
    spark = Session.builder.master("local[1]").appName("bert-rollback").getOrCreate()
    docs = text.synthetic_wikipedia(512, num_partitions=1)
    tok = text.WordPieceTokenizer.train(docs.collect(), vocab_size=8192)

    def train_ds():
        return text.mlm_dataset(docs, tok, seq_len=seq, max_predictions=80,
                                num_workers=0).repeat()

    held = text.synthetic_wikipedia(400, num_partitions=1, seed=7)
    eval_ds = text.mlm_dataset(held, tok, seq_len=seq, max_predictions=80,
                               num_workers=0)
    eval_ds = PartitionedDataset.parallelize(eval_ds.take(ROLLBACK_EVAL_EXAMPLES), 1)
    check(eval_ds.count() == ROLLBACK_EVAL_EXAMPLES,
          f"the held-out set holds {eval_ds.count()} examples")

    def make_trainer():
        model = bert.bert_base(device="cuda", seed=0)
        tx = optim.with_grad_clip(
            optim.adamw(optim.warmup_linear(1e-4, 2, ROLLBACK_STEPS)), 1.0)
        return Trainer(spark, model, losses.masked_lm, tx,
                       checkpointer=Checkpointer(workdir / "ckpt"))

    trainer = make_trainer()
    direct: dict[int, dict] = {}

    def evaluate_here(step, _metrics):
        if step % ROLLBACK_EVERY == 0:
            direct[step] = trainer.evaluate(eval_ds, batch_size=batch_size)

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    # what fit hands its MetricLogger, unrounded (the log line rounds)
    got: list = []
    plain_log = metrics_mod.MetricLogger.log
    metrics_mod.MetricLogger.log = lambda self, step, m: (
        got.append((step, dict(m))), plain_log(self, step, m))[1]
    os.environ["DLS_FAULT"] = f"nan@{ROLLBACK_AT}"
    os.environ[telemetry.WORKDIR_ENV] = str(workdir)
    for k in kernels:  # the path's run starts here
        k.launches = 0
    try:
        state, summary = trainer.fit(
            train_ds(), batch_size=batch_size, steps=ROLLBACK_STEPS, log_every=1,
            checkpoint_every=ROLLBACK_EVERY, on_nonfinite="rollback",
            eval_dataset=eval_ds, eval_every=ROLLBACK_EVERY,
            callbacks=[evaluate_here])
    finally:
        os.environ.pop("DLS_FAULT", None)
        os.environ.pop(telemetry.WORKDIR_ENV, None)
        telemetry.reset()
        metrics_mod.MetricLogger.log = plain_log
    launches = {k.__name__: k.launches for k in kernels}
    final = {k: v.detach().float().clone() for k, v in state.params.items()}
    records = _events(workdir)
    rollbacks = [r for r in records if r["kind"] == "recovery"
                 and r.get("event") == "rollback"]
    logged_eval = {s: m for s, m in got if any(k.startswith("eval_") for k in m)}
    data_state = json.loads((workdir / "ckpt" / str(ROLLBACK_STEPS)
                             / "data_state.json").read_text())

    # the second run: restore the rollback's step, feed from where the first
    # run's feed was when it rolled back
    second = make_trainer()
    second.restore(step=ROLLBACK_EVERY)
    telemetry.reset()
    for k in kernels:
        k.launches = 0
    state2, _ = second.fit(train_ds(), batch_size=batch_size, steps=ROLLBACK_STEPS,
                           log_every=ROLLBACK_STEPS,
                           data_state={"examples_seen": ROLLBACK_AT * batch_size,
                                       "batch_size": batch_size})
    launches2 = {k.__name__: k.launches for k in kernels}
    second_final = {k: v.detach().float() for k, v in state2.params.items()}
    num = sum(float((second_final[k] - v).abs().sum()) for k, v in final.items())
    den = sum(float(v.abs().sum()) for v in final.values())
    bitwise = all(torch.equal(second_final[k], v) for k, v in final.items())
    # the rollback's restore, then the second run's (its stream lies in the
    # checkpoint root: no workdir was named for it)
    restore_ms = _phase_ms(records, "restore") + _phase_ms(
        _events(workdir / "ckpt"), "restore")
    save_ms = _phase_ms(records, "checkpoint")
    wait_ms = _phase_ms(records, "checkpoint-wait")
    eval_gap = max(abs(logged_eval[s][f"eval_{k}"] - v) / max(abs(v), 1e-12)
                   for s, m in direct.items() for k, v in m.items())
    spark.stop()
    rec = dict(steps=ROLLBACK_STEPS, batch_size=batch_size, seq_len=seq,
               poisoned_step=ROLLBACK_AT, rollbacks=summary.get("rollbacks"),
               rolled_back=[(r["step"], r["to_step"], r["window"]) for r in rollbacks],
               examples_seen_at_end=data_state["examples_seen"],
               final_rel_diff_vs_restored_run=num / den, final_bitwise=bitwise,
               eval_logged=logged_eval, eval_direct=direct,
               eval_max_rel_diff=eval_gap, launches=launches,
               second_run_launches=launches2,
               checkpoint_save_ms=save_ms, checkpoint_wait_ms=wait_ms,
               restore_ms=restore_ms, card=nvidia_smi_line())
    print("recovery rollback bert-base " + json.dumps(rec), flush=True)
    L = 12
    passes = ROLLBACK_AT + (ROLLBACK_STEPS - ROLLBACK_EVERY)
    evals = 2 * (ROLLBACK_STEPS // ROLLBACK_EVERY) * (ROLLBACK_EVAL_EXAMPLES // batch_size)
    check(summary.get("rollbacks") == 1.0
          and [(s, t) for s, t, _ in rec["rolled_back"]] == [(ROLLBACK_AT, ROLLBACK_EVERY)],
          f"rollbacks {summary.get('rollbacks')}: {rec['rolled_back']}")
    check(data_state["examples_seen"] == (ROLLBACK_STEPS + ROLLBACK_AT - ROLLBACK_EVERY)
          * batch_size, f"the last checkpoint's data_state {data_state}")
    check(num / den <= ROLLBACK_RTOL,
          f"final params {num / den:.3e} (relative) from the restored run's")
    check(sorted(direct) == sorted(logged_eval) == [ROLLBACK_EVERY, ROLLBACK_STEPS]
          and eval_gap <= EVAL_RTOL,
          f"eval inside fit {logged_eval} against evaluate {direct}")
    check(launches == {"flash_fwd": L * (passes + evals), "flash_bwd_dq": L * passes,
                       "flash_bwd_dkv": L * passes},
          f"kernel launches {launches} for {passes} steps and {evals} eval batches")
    check(len(restore_ms) == 2, f"restore phases {restore_ms}")
    return rec


#: fresh LeNet runs of the crash drill's race probe (``--ckpt-commit``)
CRASH_PROBES = 8


def ckpt_commit_tree(tree: str) -> int:
    """The supervised crash drill's race on one tree (``chip_smoke.py
    --ckpt-commit TREE``, with TREE's package first on the path; one card):
    LeNet-5 as the drill's driver trains it (b=64, SGD with momentum, a
    deterministic session, an asynchronous checkpoint every CRASH_EVERY
    steps), CRASH_PROBES fresh runs of 2 * CRASH_EVERY steps in one process.
    For each, the step-CRASH_EVERY save's write on its thread (ms from the
    save's return, the write queued, to the rename that commits it) against
    the ms from that return to the end of step 2 * CRASH_EVERY - 1, where
    ``DLS_FAULT=crash@8`` kills the drill's first attempt: a write that
    commits later is lost to that kill. Prints one ``ckpt commit {json}``
    line."""
    import shutil

    import distributeddeeplearningspark_tpu_torch as pkg
    from distributeddeeplearningspark_tpu_torch.checkpoint import Checkpointer
    from distributeddeeplearningspark_tpu_torch.data import sources
    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    check(Path(pkg.__file__).resolve().parent.parent == Path(tree).resolve(),
          f"{PKG} imported from {pkg.__file__}, not from {tree}")
    spark = Session.builder.master("local[1]").appName("ckpt-commit").config(
        "spark.dls.deterministic", "true").getOrCreate()
    times: dict = {}
    real_save, real_write = Checkpointer.save, Checkpointer._write

    def save(self, step, state, **kw):
        out = real_save(self, step, state, **kw)
        times[("queued", step)] = time.perf_counter()
        return out

    def write(self, step, host, data_state):
        real_write(self, step, host, data_state)
        times[("committed", step)] = time.perf_counter()

    Checkpointer.save, Checkpointer._write = save, write
    kill_step, runs = 2 * CRASH_EVERY - 1, []
    root = ROOT / "build" / "chip_smoke_ckpt_commit"
    for i in range(CRASH_PROBES):
        shutil.rmtree(root, ignore_errors=True)
        times.clear()
        ends: dict = {}
        ckpt = Checkpointer(root)
        trainer = Trainer(spark, LeNet5(device=spark.device), losses.softmax_xent,
                          optim.sgd(0.01, momentum=0.9), checkpointer=ckpt)
        trainer.fit(sources.synthetic_mnist(4096, num_partitions=1, seed=0).repeat(),
                    batch_size=LENET_BATCH, steps=2 * CRASH_EVERY, log_every=1,
                    checkpoint_every=CRASH_EVERY,
                    callbacks=[lambda s, _m: ends.__setitem__(s, time.perf_counter())])
        ckpt.close()
        queued = times[("queued", CRASH_EVERY)]
        committed = times[("committed", CRASH_EVERY)]
        runs.append(dict(queued_to_commit_ms=(committed - queued) * 1e3,
                         queued_to_kill_ms=(ends[kill_step] - queued) * 1e3,
                         committed_before_kill=committed <= ends[kill_step]))
    shutil.rmtree(root, ignore_errors=True)
    spark.stop()
    commit = sorted(r["queued_to_commit_ms"] for r in runs)
    rec = dict(tree=str(Path(tree).resolve()), runs=runs,
               commit_ms_median=commit[len(commit) // 2], commit_ms_max=commit[-1],
               lost_to_the_kill=sum(not r["committed_before_kill"] for r in runs),
               card=nvidia_smi_line())
    print("ckpt commit " + json.dumps(rec), flush=True)
    return 0


def recovery_supervised_lenet(torch) -> dict:
    """The port's LeNet driver under the port's Supervisor on this card,
    ``DLS_FAULT=crash@10``, a checkpoint every 4 steps, ``--resume``: the
    attempts' classifications from the telemetry stream, the relaunch's
    first step one past the newest checkpoint it restored (4, or 8 where
    that write had committed before the kill), the final params
    against the LeNet phase's 150 straight steps, nothing of the killed
    attempt left, and the seconds from the kill to the relaunch's first
    step."""
    import shutil

    from distributeddeeplearningspark_tpu_torch import checkpoint as ckpt_lib
    from distributeddeeplearningspark_tpu_torch.supervisor import Supervisor
    from distributeddeeplearningspark_tpu_torch.utils.env import conf_to_env

    workdir = ROOT / "build" / "chip_smoke_supervised"
    shutil.rmtree(workdir, ignore_errors=True)
    script = ROOT / PKG / "examples" / "train_mnist.py"
    argv = [sys.executable, str(script), "--steps", str(LENET_STEPS),
            "--batch-size", str(LENET_BATCH), "--log-every", "1",
            "--checkpoint-dir", str(workdir / "ckpt"),
            "--checkpoint-every", str(CRASH_EVERY), "--resume"]
    sup = Supervisor(argv, num_processes=1, max_restarts=2, restart_backoff_s=0.1,
                     env={"DLS_FAULT": f"crash@{CRASH_AT}",
                          **conf_to_env({"spark.dls.deterministic": "true"})},
                     ckpt_dir=str(workdir / "ckpt"),
                     progress_path=str(workdir / "ckpt"), telemetry_dir=str(workdir))
    t0 = time.time()
    result = sup.run()
    wall_s = time.time() - t0
    left = _left_behind(script, set())
    records = _events(workdir)
    ends = [r for r in records if r["kind"] == "attempt" and r.get("edge") == "end"]
    begins = [r for r in records if r["kind"] == "attempt" and r.get("edge") == "begin"]
    runs = [r for r in records if r["process"] == "p0" and r["kind"] == "phase"
            and r.get("name") == "run" and r.get("edge") == "begin"]
    steps = [r for r in records if r["process"] == "p0" and r["kind"] == "step_metrics"]
    killed_at = ends[0]["ts"] if ends else None
    after = [r for r in steps if killed_at is not None and r["ts"] > killed_at]
    restored = [r.get("step") for r in records if r["process"] == "p0"
                and r["kind"] == "phase" and r.get("name") == "restore"
                and r.get("edge") == "end" and killed_at is not None
                and r["ts"] > killed_at]
    relaunch = dict(
        kill_to_first_step_s=after[0]["ts"] - killed_at if after else None,
        kill_to_relaunch_s=begins[1]["ts"] - killed_at if len(begins) > 1 else None,
        relaunch_to_run_s=(runs[-1]["ts"] - begins[1]["ts"]
                           if len(begins) > 1 and runs else None),
        run_to_first_step_s=after[0]["ts"] - runs[-1]["ts"] if after and runs else None)
    final = torch.load(workdir / "ckpt" / str(LENET_STEPS) / ckpt_lib.STATE_FILE,
                       map_location="cpu", weights_only=True)["params"]
    straight = torch.load(ROOT / "build" / "chip_smoke_lenet_1" / "half" / "ckpt"
                          / str(LENET_STEPS) / ckpt_lib.STATE_FILE,
                          map_location="cpu", weights_only=True)["params"]
    mismatched = [k for k in straight if not torch.equal(final[k], straight[k])]
    rec = dict(attempts=[(a.ordinal, a.returncodes, a.classification)
                         for a in result.attempts],
               telemetry_classifications=[e["classification"] for e in ends],
               first_step_after_relaunch=after[0]["step"] if after else None,
               restored_step=restored[0] if restored else None,
               mismatched_vs_straight=mismatched, left_behind=left, wall_s=wall_s,
               card=nvidia_smi_line(), **relaunch)
    print("recovery supervised lenet " + json.dumps(rec), flush=True)
    check(result.ok and [a.classification for a in result.attempts]
          == ["training-crash", "clean"] and result.attempts[0].returncodes == [-9],
          f"attempts {rec['attempts']}")
    check(rec["telemetry_classifications"] == ["training-crash", "clean"],
          f"the stream's attempt records: {rec['telemetry_classifications']}")
    check(rec["restored_step"] in (CRASH_EVERY, 2 * CRASH_EVERY)
          and rec["first_step_after_relaunch"] == rec["restored_step"] + 1,
          f"the relaunch restored step {rec['restored_step']} and began at "
          f"{rec['first_step_after_relaunch']}")
    check(not mismatched, f"final params differ from 150 straight steps in {mismatched}")
    check(not left, f"left behind by the supervised runs: {left}")
    return rec


def recovery_main(torch) -> int:
    """``chip_smoke.py --recovery``: the kernels built, phase 11 (whose 150
    straight steps the supervised drill is held to) and phase 14."""
    from distributeddeeplearningspark_tpu_torch.ops import _build
    from distributeddeeplearningspark_tpu_torch.ops import conv_bn as cb
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa

    try:
        _build.build_all()
        train_lenet(torch)
        check_recovery(torch, cb, fa)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_recovery(torch, cb, fa) -> dict:
    """Phase 14: the skip guard on ResNet-50 (K4), the rollback and eval
    inside fit on BERT-base (K1-K3), and the supervised crash drill."""
    return dict(skip=recovery_skip_resnet(torch, cb),
                rollback=recovery_rollback_bert(torch, fa),
                supervised=recovery_supervised_lenet(torch))


# -- chip_smoke.py --gang: the drivers at one rank per card ---------------------

#: steps of the --gang runs (each logged), and of the profiled window
GANG_STEPS, GANG_WINDOW = 6, 4
#: ResNet's worker processes a rank in the --gang runs
GANG_WORKERS = 2
#: each logged loss at N ranks against one card's on the same global
#: batches: bf16 activations, whose convolutions, matmuls and K4 sums round
#: differently at b/N rows than at b, carried through the steps (four H100s
#: read 2.25e-5 for ResNet-50 and 3.37e-5 for the DLRM)
GANG_LOSS_RTOL = 1e-3
#: ResNet-50's parameters' change over the GANG_STEPS steps at N ranks
#: against one card's, |Δ_N − Δ_1| / |Δ_1| over every parameter together.
#: SGD moves them in proportion to the gradient: four H100s read 0.026 from
#: the rounding above, 0.55 with a rank-local BatchNorm backward and 2.4
#: with the loss not weighed (GANG_FAULTS), whose losses read 1.1e-4 and
#: 3.4e-2. The DLRM's change is printed, not held: AdamW and the row-wise
#: AdaGrad take steps of about ±lr wherever a gradient is near 0, so
#: rounding alone flips whole steps there; and both are blind to the
#: gradient's scale, so a loss weighed wrong cannot move them at all.
GANG_PARAM_RTOL = 0.1
#: the DLRM's row accumulators (AdaGrad's Σg² a row, not sign-like) at N
#: ranks against one card's, |acc_N − acc_1| / |acc_1| over every table
#: together, after the first step: later steps' gradients come from weights
#: that AdamW's sign-like steps have already moved apart, while the first
#: step's differ only by the MLPs' bf16 rounding at b/N rows against b,
#: which the row sums' cancellation magnifies. Four H100s read 0.030 sound
#: and 0.105 with the merge-local fault (GANG_FAULTS) after the first step
#: (0.068 sound after 6 steps); a CPU rehearsal (4 gloo ranks, b=256,
#: vocab 1,000, f32 sums in the same order) 1.2e-8 and 0.107
GANG_ROW_ACCUM_RTOL = 5e-2
#: faults planted into each model's N-rank run. Each leaves the replicas
#: equal, so that only the comparison with one card can see it, and the
#: phase fails unless its loss or its held state (ResNet-50's parameters'
#: change, the DLRM's row accumulators) leaves its limit.
GANG_FAULTS = {
    "resnet": {
        "loss-unweighed": "each rank's loss is not weighed by its share of the "
                          "global batch: the ranks' gradients are summed, not "
                          "averaged",
        "bn-backward-local": "BatchNorm's backward sums (Σg and Σg·(x−mean), "
                             "and K4's ds1 and ds2) stay this rank's",
    },
    "dlrm": {
        "merge-local": "the sparse merge folds each rank's rows apart: every "
                       "rank applies the ranks' row updates one after another "
                       "(each rank's duplicates summed, not the global batch's)",
    },
}


def _plant(fault: str) -> None:
    """Plant one of GANG_FAULTS into this process's port ("none": nothing)."""
    from distributeddeeplearningspark_tpu_torch.models import resnet
    from distributeddeeplearningspark_tpu_torch.parallel import collectives
    from distributeddeeplearningspark_tpu_torch.train import embed

    if fault == "loss-unweighed":
        weigh = collectives.weigh_loss

        def unweighed(loss, metrics, rows, group=None):
            weighed, out = weigh(loss, metrics, rows, group)
            return weighed * collectives.world_size(), out

        collectives.weigh_loss = unweighed
    elif fault == "bn-backward-local":
        reduce, backward = collectives.all_reduce_sum, resnet._BatchNormTrain.backward

        def local_backward(ctx, *grads):
            collectives.all_reduce_sum = lambda t: t
            try:
                return backward(ctx, *grads)
            finally:
                collectives.all_reduce_sum = reduce

        resnet._BatchNormTrain.backward = staticmethod(local_backward)
        collectives._AllReduceSum.backward = staticmethod(lambda ctx, g: (g, None))
    elif fault == "merge-local":
        update = embed.rowwise_adagrad_update

        def rank_by_rank(table, accum, ids, d_vecs, **kw):
            n = collectives.world_size()
            for rank_ids, rank_vecs in zip(ids.chunk(n), d_vecs.chunk(n)):
                update(table, accum, rank_ids, rank_vecs, **kw)
            return table, accum

        embed.rowwise_adagrad_update = rank_by_rank
    else:
        check(fault == "none", f"no fault {fault!r}")


def model_rank(argv: list[str]) -> int:
    """One rank of a --gang comparison run (``chip_smoke.py --model-rank
    resnet|dlrm OUT FAULT ARGS``, run by the port's cli): the driver's
    model, data and optimizer, FAULT planted (``none`` or one of
    GANG_FAULTS), GANG_STEPS steps, each logged, and the replicas checked;
    rank 0 saves to OUT the parameters' change over the steps (and the
    DLRM's row accumulators). A sound run at more than one rank then takes
    GANG_WINDOW more steps under the profiler, whose record rank 0 prints."""
    import torch

    from distributeddeeplearningspark_tpu_torch.examples import train_dlrm, train_resnet
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import embed
    from distributeddeeplearningspark_tpu_torch.utils import sanitize

    name, out, fault = argv[:3]
    driver = {"resnet": train_resnet, "dlrm": train_dlrm}[name]
    args = driver.parse_args(argv[3:])
    _plant(fault)
    spark = Session.builder.appName(f"{name}-gang-{fault}").getOrCreate()
    trainer, ds = driver.make_trainer(args, spark), driver.make_dataset(args, spark)
    init = {k: p.detach().to("cpu", copy=True)
            for k, p in trainer.model.named_parameters()}
    first = {}
    if trainer.sparse_embed:  # the row accumulators after the first step too
        state, _ = trainer.fit(ds, batch_size=args.batch_size, steps=1, log_every=1)
        first = {f"{n}.row_accum": s[embed.ROW_ACCUM].detach().to("cpu", copy=True)
                 for n, s in state.embed_state.items()}
    resume = {"examples_seen": args.batch_size, "batch_size": args.batch_size}
    state, _ = trainer.fit(ds, batch_size=args.batch_size, steps=GANG_STEPS,
                           log_every=1, data_state=resume if first else None)
    compare = {k: p.detach().cpu() - init[k] for k, p in state.params.items()}
    compare.update({f"{n}.row_accum": s[embed.ROW_ACCUM].detach().cpu()
                    for n, s in state.embed_state.items()})
    compare.update({f"{k}.step1": v for k, v in first.items()})
    sanitize.assert_replicas_in_sync(
        {**state.params, **dict(trainer.model.named_buffers()),
         **{f"{n}.row_accum": s[embed.ROW_ACCUM] for n, s in state.embed_state.items()}},
        what="params, buffers and row accumulators")
    if spark.rank == 0:
        torch.save(compare, out)
    if fault == "none" and spark.world_size > 1:
        profile = _profile_fit(torch, trainer, ds, args.batch_size, {}, steps=GANG_WINDOW)
        if spark.rank == 0:
            print("model profile " + json.dumps(dict(
                profile, backend=spark.backend, world_size=spark.world_size)), flush=True)
    spark.stop()
    return 0


def _model_run(name: str, workdir: Path, ranks: int, fault: str, args: list[str]) -> dict:
    """A :func:`model_rank` launch at ``local[ranks]``: rank 0's logged
    losses, its step ms (the laps after the first), the change it saved,
    and the profile where it printed one."""
    import shutil

    import torch

    shutil.rmtree(workdir, ignore_errors=True)
    out = workdir / "compare.pt"
    lines, timing = _launch(workdir, ranks, Path(__file__).resolve(),
                            ["--model-rank", name, str(out), fault, *args], timeout=600)
    metrics = [r for r in _events(workdir, "p0") if r["kind"] == "step_metrics"]
    metrics = metrics[:GANG_STEPS]
    laps = [r["lap_s"] * 1e3 / r["steps"] for r in metrics]
    found = [x for x in lines if x.startswith("model profile ")]
    return dict(losses=[r["metrics"]["loss"] for r in metrics],
                step_ms=float(np.mean(laps[1:] or laps)) if laps else None,
                compare=torch.load(out), launch=timing,
                profile=json.loads(found[0][len("model profile "):]) if found else None)


def _loss_gap(got: list, want: list) -> float:
    check(len(got) == len(want) == GANG_STEPS and all(np.isfinite(got + want)),
          f"logged {got} against {want}")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _param_gap(got: dict, want: dict) -> dict:
    """|got − want| / |want| over every tensor together, and the tensor
    where the ratio is largest among those that hold at least 1e-3 of
    |want|."""
    check(sorted(got) == sorted(want), f"{sorted(got)} against {sorted(want)}")
    norms = {k: (float((got[k] - b).double().norm()), float(b.double().norm()))
             for k, b in want.items()}
    num, den = (sum(x[i] ** 2 for x in norms.values()) ** 0.5 for i in (0, 1))
    big = {k: d / n for k, (d, n) in norms.items() if n > 0 and n >= 1e-3 * den}
    where = max(big, key=big.get, default=None)
    return dict(rel=num / den if den else float("inf"), worst_tensor=where,
                worst_rel=big.get(where))


def _row_accums(compare: dict, suffix: str = ".row_accum.step1") -> dict:
    """The row accumulators a model run saved: after its first step (the
    held reading: every rank's and one card's gradients come from the same
    weights), or with ``suffix=".row_accum"`` after the last."""
    return {k: v for k, v in compare.items() if k.endswith(suffix)}


def train_drivers_gang(torch, ranks: int, names=("resnet", "dlrm")) -> dict:
    """ResNet-50 at b=256 global and the DLRM at b=8,192 global at one rank
    per card over NCCL, GANG_STEPS steps, against one card on the same
    source partitions (the same global batches). The drivers through the
    cli: replicas in sync (each driver checks its params and BatchNorm
    buffers or row accumulators), every rank's losses the same, 27 K4
    launches and 106 BatchNorm all-reduces a step, one K5 launch, and
    nothing left behind. The drivers' model, data and optimizer in
    :func:`model_rank` runs at N ranks and on one card: the losses at
    GANG_LOSS_RTOL, ResNet-50's parameters' change at GANG_PARAM_RTOL,
    each rank's step ms and a profiled window for the NCCL kernels' time;
    the DLRM's row accumulators at GANG_ROW_ACCUM_RTOL. Then each of
    GANG_FAULTS planted into a model's N-rank run must leave one of its
    limits."""
    root = ROOT / "build" / f"chip_smoke_gang_{ranks}"
    out = {}
    for name in names:
        workers = GANG_WORKERS if name == "resnet" else None
        parts = ranks * GANG_WORKERS if name == "resnet" else ranks
        args = _driver_args(name, steps=GANG_STEPS, log_every=1, workers=workers,
                            parts=parts)
        many = _driver_run(name, root / name / "driver", ranks, args)
        gang = _model_run(name, root / name / "gang", ranks, "none", args)
        one = _model_run(name, root / name / "one", 1, "none", args)
        got, want, base = many["losses"].get("p0", []), one["losses"], one["compare"]
        profile = gang["profile"] or {}
        rec = dict(ranks=ranks, global_batch=RESNET_BATCH if name == "resnet" else DLRM_BATCH,
                   step_ms_by_rank=many["step_ms_by_rank"], one_card_step_ms=one["step_ms"],
                   losses=got, one_card_losses=want, max_loss_rel_err=_loss_gap(got, want),
                   loss_rtol=GANG_LOSS_RTOL,
                   model_rank_max_loss_rel_err=_loss_gap(gang["losses"], want),
                   params=_param_gap(gang["compare"], base),
                   param_rtol=GANG_PARAM_RTOL if name == "resnet" else None,
                   row_accum=(_param_gap(_row_accums(gang["compare"]),
                                         _row_accums(base))
                              if name == "dlrm" else None),
                   row_accum_last=(_param_gap(_row_accums(gang["compare"], ".row_accum"),
                                              _row_accums(base, ".row_accum"))
                                   if name == "dlrm" else None),
                   row_accum_rtol=GANG_ROW_ACCUM_RTOL if name == "dlrm" else None,
                   launch=many["launch"], left=many["left"],
                   nccl_ms_per_step=profile.get("busy_ms_by_family", {}).get("nccl"),
                   profile=profile, **{k: v for k, v in many["result"].items()
                                       if k != "train"})
        del gang, one
        rec["faults"] = {}
        for fault in GANG_FAULTS[name]:
            bad = _model_run(name, root / name / fault, ranks, fault, args)
            rec["faults"][fault] = dict(
                max_loss_rel_err=_loss_gap(bad["losses"], want),
                params=_param_gap(bad["compare"], base),
                row_accum=(_param_gap(_row_accums(bad["compare"]), _row_accums(base))
                           if name == "dlrm" else None))
            del bad
        del base
        print(f"gang {name} " + json.dumps(rec), flush=True)
        res = many["result"]
        check(res["world_size"] == ranks and res["backend"] == "nccl"
              and res["replicas_checked"], f"{name} gang: {res}")
        check(sorted(many["losses"]) == [f"p{r}" for r in range(ranks)]
              and all(v == got for v in many["losses"].values()),
              f"{name}: the ranks logged different losses")
        check(rec["max_loss_rel_err"] <= GANG_LOSS_RTOL,
              f"{name}: the losses at {ranks} ranks are off one card's "
              f"({rec['max_loss_rel_err']} > {GANG_LOSS_RTOL}): {got} vs {want}")
        check(rec["params"]["rel"] <= (rec["param_rtol"] or float("inf")),
              f"{name}: the parameters' change at {ranks} ranks is off one card's "
              f"({rec['params']} > {GANG_PARAM_RTOL})")
        check(not many["left"], f"{name} left {many['left']}")
        check(profile.get("busy_ms_by_family", {}).get("nccl", 0.0) > 0,
              f"no NCCL kernel in the profiled {name} gang: {profile}")
        if name == "resnet":
            check(res["k4_launches"] == 27 * GANG_STEPS
                  and res["bn_allreduces_per_step"] == BN_ALLREDUCES_PER_STEP,
                  f"resnet gang: {res}, want 27 K4 launches a step at "
                  f"{RESNET_BATCH // ranks} rows a rank")
            for fault, seen in rec["faults"].items():
                check(seen["max_loss_rel_err"] > GANG_LOSS_RTOL
                      or seen["params"]["rel"] > GANG_PARAM_RTOL,
                      f"resnet gang: the planted fault {fault!r} "
                      f"({GANG_FAULTS[name][fault]}) stays within both limits: {seen}")
        else:
            check(res["k5_launches"] == GANG_STEPS
                  and res["merge_bytes_per_step"] == DLRM_BATCH * len(DLRM_VOCABS) * (4 + 64 * 4),
                  f"dlrm gang: {res}")
            check(rec["row_accum"]["rel"] <= GANG_ROW_ACCUM_RTOL,
                  f"dlrm: the row accumulators at {ranks} ranks are off one card's "
                  f"({rec['row_accum']} > {GANG_ROW_ACCUM_RTOL})")
            for fault, seen in rec["faults"].items():
                check(seen["max_loss_rel_err"] > GANG_LOSS_RTOL
                      or seen["row_accum"]["rel"] > GANG_ROW_ACCUM_RTOL,
                      f"dlrm gang: the planted fault {fault!r} "
                      f"({GANG_FAULTS[name][fault]}) stays within both limits: {seen}")
        out[name] = rec
    return out


# -- chip_smoke.py --gang llama: config 5 sharded over the cards -------------------

#: the Llama gang's peak lr: AdamW moves the adapters ~lr a step, so the
#: losses of a sound run and of a run whose adapters drift apart part
LLAMA_GANG_LR = 1e-3
#: the full fine-tune that puts sharded params in training (the LoRA base is
#: frozen, so its gradients never pass FSDP2's reduce-scatter): Llama-2 7B's
#: widths cut to this many layers, f32 params, every param trainable, at a
#: full fine-tune's peak lr. At LLAMA_GANG_LR every param steps ~1e-3 and
#: the run diverges (losses 10.6, 10.6, 14.4, 8.1, 11.2, 8.6 on four H100s
#: and on one), where bf16 rounding at 2 rows a card against 8 grew from
#: 3e-5 at step 3 to 1.08e-3 at step 5, the grad norms 1.5e-4 apart
LLAMA_GANG_FULL_LAYERS, LLAMA_GANG_FULL_LR = 2, 1e-4
#: each logged grad norm at N ranks against one card's on the same batches:
#: bf16 activations summed over b/N rows against b (four H100s read 1.5e-4;
#: an averaged reduce-scatter leaves the sharded gradients 1/N of the
#: global batch's: 0.75 off)
GANG_GRAD_NORM_RTOL = 1e-2
#: faults planted into the Llama gang, by the run they go into: each must
#: break one of its limits
LLAMA_GANG_FAULTS = {
    "adapters-local": ("lora", "the replicated params' all-reduce skipped: each "
                               "rank's LoRA adapters step on its own rows' "
                               "gradient (ignored_params left rank-local)"),
    "reduce-scatter-averaged": ("full", "FSDP2's reduce-scatter left at its "
                                        "default mean: the sharded gradients come "
                                        "back 1/N of the global batch's"),
    "adapters-unsummed": ("lora-tp", "the adapters' gradients left unsummed over "
                                     "the tensor group: each tensor peer's A and B "
                                     "step on its own heads' part"),
    "feed-by-world-rank": ("lora-tp", "the feed sharded by world rank: tensor peers "
                                      "take different rows, each a 1/N share"),
    "rope-local": ("ring-seq4", "the RoPE positions not offset by the seq index: "
                                "each block rotated as if it began the sequence"),
    "cp-grads-unsummed": ("ring-seq4", "the gradients summed over the batch group "
                                       "only: each seq peer's adapters step on its "
                                       "block's part"),
    "bank-grad-summed": ("pp-lora", "the bank's broadcast back-propagated as a sum "
                                    "over the pipe peers: every stage's gradients "
                                    "P times the loss's"),
    "embed-grad-unsummed": ("pp-full", "the embedding's gradient not summed over "
                                       "pipe: only stage 0's copy of it steps on "
                                       "it"),
    "bank-misordered": ("pp-lora", "the last stage banking the microbatches in "
                                   "reverse order: rows meet other rows' labels"),
    "stage-layers-reversed": ("pp-lora", "a stage applying its layers in reverse "
                                         "order"),
}
#: context parallelism's layouts at four cards: name → (``--seq-parallel``,
#: ``--cp-impl``); the rest of the cards go to fsdp (the driver's default
#: ``--fsdp -1``)
LLAMA_CP_LAYOUTS = {"ring-seq4": (4, "ring"), "ulysses-seq4": (4, "ulysses"),
                    "ring-fsdp2-seq2": (2, "ring")}
#: Llama-2 7B's decoder layers, kv heads (multi-head: as many as its
#: LLAMA_HEADS) and head dim
LLAMA_LAYERS, LLAMA_KV_HEADS, LLAMA_HEAD_DIM = 32, 32, 128
#: NCCL's tuning model and transports, logged by the tensor-parallel and
#: FSDP drivers' ranks (their environment only) into a file each
#: (``nccl.<pid>.log`` in the launch's workdir: NCCL logs to stdout
#: otherwise); the algorithm and protocol each collective ran are in the
#: names of its kernels in the profiled windows
NCCL_TUNING_ENV = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,TUNING"}


def _plant_llama(fault: str) -> None:
    """Plant one of LLAMA_GANG_FAULTS into this process's port."""
    import torch

    from distributeddeeplearningspark_tpu_torch.data import feed
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.parallel import collectives, sharding
    from distributeddeeplearningspark_tpu_torch.train import trainer

    if fault == "adapters-local":
        collectives.all_reduce_grads = lambda grads, group=None: None
    elif fault == "reduce-scatter-averaged":
        sharding._sum_gradients = lambda unit: None
    elif fault == "adapters-unsummed":
        def unsummed(a, b, split):
            if split is None:
                return a, b
            if split.dim == 0:
                return a, b.chunk(split.size, 1)[split.index]
            return a.chunk(split.size, 0)[split.index], b
        llama.adapter_shards = unsummed
    elif fault == "rope-local":
        llama.positions = lambda s, device, impl: torch.arange(s, device=device)[None, :]
    elif fault == "cp-grads-unsummed":
        from distributeddeeplearningspark_tpu_torch import Session
        from distributeddeeplearningspark_tpu_torch.parallel.mesh import (
            BATCH_AXES,
            LOSS_AXES,
        )

        summed = collectives.all_reduce_grads

        def batch_group_only(grads, group=None):
            mesh = Session._active.mesh
            if group is mesh.group(LOSS_AXES):
                group = mesh.group(BATCH_AXES)
            return summed(grads, group)
        # the original counts its calls on the module's attribute
        batch_group_only.calls = summed.calls
        collectives.all_reduce_grads = batch_group_only
    elif fault == "bank-grad-summed":
        import torch.distributed as dist

        from distributeddeeplearningspark_tpu_torch.parallel import pipeline

        def summed(g, pg):
            g = g.clone()
            dist.all_reduce(g, group=pg.group)
            return g
        pipeline._bank_grad = summed
    elif fault == "embed-grad-unsummed":
        from distributeddeeplearningspark_tpu_torch.models import llama_pp

        llama_pp.PipelinedForward.first_stage_params = ()
    elif fault == "bank-misordered":
        from distributeddeeplearningspark_tpu_torch.parallel import pipeline

        pipeline._bank = lambda outputs: torch.stack([o.detach() for o in outputs[::-1]])
    elif fault == "stage-layers-reversed":
        from distributeddeeplearningspark_tpu_torch.models import llama_pp

        stage_forward = llama_pp._stage_forward
        llama_pp._stage_forward = lambda layers, x, remat: stage_forward(
            layers[::-1], x, remat)
    elif fault == "feed-by-world-rank":
        def by_world_rank(self, dataset, batch_size, **kw):
            n, r = self.session.world_size, self.session.rank
            return feed.host_batches(dataset, batch_size, num_shards=n,
                                     shard_range=(r, r + 1), **kw)
        trainer.Trainer._host_feed = by_world_rank
    else:
        check(fault == "none", f"no fault {fault!r}")


def _llama_gang_args(ranks: int, steps: int, tensor: int = 1) -> list[str]:
    """The driver's flags of the Llama gang: 7B at the global b=8, S=1,024,
    LoRA rank 16, every rank on the fsdp axis (the default --fsdp -1) but
    the ``tensor`` peers, the corpus in as many partitions as ranks (the
    same batches on one card)."""
    return ["--variant", "7b", "--seq-len", str(LLAMA_SEQ), "--batch-size",
            str(LLAMA_BATCH), "--lora-rank", str(LLAMA_RANK), "--lora-alpha", "16",
            "--lr", str(LLAMA_GANG_LR), "--steps", str(steps), "--log-every", "1",
            "--source-partitions", str(ranks), "--tensor", str(tensor)]


class _TimedStep:
    """A trainer's train step, each call's host seconds kept: the time the
    host takes to issue the step's work (the call does not wait for the
    card), against the step's wall between two log points' syncs."""

    def __init__(self, step):
        self.step, self.host_s = step, []

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.step(*args, **kwargs)
        self.host_s.append(time.perf_counter() - t0)
        return out


def llama_rank(argv: list[str]) -> int:
    """One rank of a Llama gang comparison run (``chip_smoke.py --llama-rank
    OUT MODE FAULT ARGS``, run by the port's cli): the driver's session,
    data and model (MODE ``lora``: its trainer; ``full``: the full fine-tune
    at LLAMA_GANG_FULL_LAYERS layers of the 7B widths under the same
    ``llama_rules``; ``full-hsdp``: the same on ``data=2 × fsdp``), FAULT
    planted, GANG_STEPS steps, each logged; each rank writes
    ``OUT/rank<r>.json``: its card (flash launches, resident param bytes and
    the rule engine's reckoning, peak memory in the init and in ``fit``,
    its ``seq`` index, the RoPE positions its first layer applied, the
    bytes its ring exchanges and all-to-alls sent in ``fit``, its pipeline
    stage and the bytes it sent stage to stage and in the bank's broadcast)
    and whether each param agrees within its replica group. MODE
    ``pp-lora`` and ``pp-full`` are ``lora`` and ``full`` laid out by stage
    at ``--pipeline`` above 1 with ``--microbatches``, their first step's
    FLOPs measured (``fit(measure_flops=True)``). A sound LoRA run at more
    than one rank then takes GANG_WINDOW more steps under the profiler."""
    import dataclasses

    import torch

    from distributeddeeplearningspark_tpu_torch import Session
    from distributeddeeplearningspark_tpu_torch.examples import train_llama_lora as driver
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearningspark_tpu_torch.ops import ring_attention, ulysses
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer
    from distributeddeeplearningspark_tpu_torch.utils import sanitize

    from distributeddeeplearningspark_tpu_torch.parallel.pipeline import pipeline

    out, mode, fault = argv[:3]
    measure = mode.startswith("pp-")
    mode = mode.removeprefix("pp-")
    args = driver.parse_args(argv[3:])
    _plant_llama(fault)
    if mode == "full-hsdp":
        spark = (Session.builder.appName(f"llama-gang-{mode}-{fault}")
                 .config("mesh.data", 2).config("mesh.fsdp", -1).getOrCreate())
    else:
        spark = driver.make_session(args, f"llama-gang-{mode}-{fault}")
    ds, tok = driver.make_dataset(args, spark)
    cfg = driver.make_config(args, tok.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    if mode == "lora":
        trainer = driver.make_trainer(args, spark, cfg)
    else:
        cfg = dataclasses.replace(cfg, num_layers=LLAMA_GANG_FULL_LAYERS, lora_rank=0,
                                  param_dtype=torch.float32)
        tx = optim.with_grad_clip(optim.adamw(optim.warmup_cosine(
            LLAMA_GANG_FULL_LR, 1, args.steps)), 1.0)
        trainer = Trainer(spark, driver.make_model(cfg), losses.causal_lm,
                          tx, rules=llama.llama_rules(cfg, pipeline=args.pipeline > 1),
                          pipeline_microbatches=args.microbatches or None)
    init_peak = torch.cuda.max_memory_allocated()
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = 0
    cp_ops = (ring_attention.exchange, ulysses.all_to_all)
    for op in cp_ops:
        op.bytes_sent = 0
    pipeline.handoff_bytes = pipeline.broadcast_bytes = 0
    # the RoPE positions the first layer applied on this rank: its first,
    # last and count
    positions: list = []
    rope = llama.rotary_embedding

    def recorded_rope(x, pos, theta):
        if not positions:
            flat = pos[0].tolist()
            positions.extend([flat[0], flat[-1], len(flat)])
        return rope(x, pos, theta)

    llama.rotary_embedding = recorded_rope
    timed = trainer._train_step = _TimedStep(trainer._train_step)
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(ds, batch_size=args.batch_size, steps=GANG_STEPS, log_every=1,
                tokens_per_example=args.seq_len, measure_flops=measure)
    trainer._train_step = timed.step
    llama.rotary_embedding = rope
    rec = driver.card_record(trainer, {k.__name__: k.launches for k in kernels})
    rec.update(init_max_memory_allocated=init_peak, positions=positions,
               seq_index=spark.mesh.seq_index,
               cp_bytes_sent=sum(op.bytes_sent for op in cp_ops),
               flops_per_step=trainer._train_step.flops_per_step if measure else None,
               host_call_ms=float(np.mean(timed.host_s[1:])) * 1e3
               if len(timed.host_s) > 1 else None)
    try:
        sanitize.assert_replicas_in_sync(trainer.state.params)
        rec["replicas_in_sync"] = True
    except sanitize.DesyncError as e:
        rec["replicas_in_sync"] = False
        rec["desync"] = str(e)[:200]
    rec.update(rank=spark.rank, world_size=spark.world_size, backend=spark.backend,
               mesh=spark.mesh.shape, local_heads=driver.local_heads(trainer),
               sharded_params=len(set(trainer.shard_dims) | set(trainer.tensor_dims)))
    if mode == "lora" and fault == "none" and spark.world_size > 1:
        rec["profile"] = _profile_fit(torch, trainer, ds, args.batch_size, {},
                                      steps=GANG_WINDOW)
    Path(out, f"rank{spark.rank}.json").write_text(json.dumps(rec))
    spark.stop()
    return 0


def _llama_run(workdir: Path, ranks: int, mode: str, fault: str, args: list[str],
               entry: str = "--llama-rank") -> dict:
    """A :func:`llama_rank` launch of the driver's flags ``args`` (with
    ``entry="--moe-rank"``, a :func:`moe_rank` launch of its layout) at
    ``local[ranks]``: every rank's record, its logged losses, grad norms and
    ``moe_aux`` (None without MoE), and its step ms (the laps after the
    first), from its telemetry."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    _, timing = _launch(workdir, ranks, Path(__file__).resolve(),
                        [entry, str(workdir), mode, fault, *args], timeout=900)
    cards = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(ranks)]
    logged: dict = {}
    for r in _events(workdir):
        if r["kind"] == "step_metrics" and r["step"] <= GANG_STEPS:
            logged.setdefault(r["process"], []).append(
                (r["metrics"]["loss"], r["metrics"]["grad_norm"],
                 r["lap_s"] * 1e3 / r["steps"], r["metrics"].get("moe_aux")))
    by_rank = [logged.get(f"p{r}", []) for r in range(ranks)]
    return dict(cards=cards, launch=timing,
                losses=[[x[0] for x in v] for v in by_rank],
                grad_norms=[[x[1] for x in v] for v in by_rank],
                moe_aux=[[x[3] for x in v] for v in by_rank],
                step_ms=[float(np.mean([x[2] for x in v][1:])) if len(v) > 1 else None
                         for v in by_rank])


def _nccl_env(workdir: Path) -> dict:
    """NCCL_TUNING_ENV, each process's log in ``workdir``."""
    return {**NCCL_TUNING_ENV, "NCCL_DEBUG_FILE": str(workdir / "nccl.%p.log")}


def _nccl_tuning(workdir: Path) -> dict:
    """What NCCL logged in a launch (``_nccl_env``): the transports its
    channels took (``via P2P/...``, ``via SHM/...``) counted over every
    process, and one process's tuning lines (the model's latency and
    bandwidth for each algorithm and protocol), at most 80."""
    import re

    transports: dict[str, int] = {}
    tuning: list[str] = []
    for i, path in enumerate(sorted(workdir.glob("nccl.*.log"))):
        for line in path.read_text(errors="replace").splitlines():
            m = re.search(r" via (\S+)", line)
            if m:
                transports[m.group(1)] = transports.get(m.group(1), 0) + 1
            if i == 0 and ("TUNING" in line or "|" in line):
                tuning.append(line.split("NCCL INFO", 1)[-1].strip()[:200])
    return dict(transports=transports, tuning=tuning[:80])


def _nccl_kernels(profile: dict | None) -> dict:
    """The NCCL kernels of a profiled window by name (their algorithm and
    protocol are in it), device ms a step."""
    return {k: ms for k, ms in (profile or {}).get("top_device_ms_per_step", [])
            if "nccl" in k.lower()}


def _cards_check(res: dict, ranks: int, whole_bytes: int, name: str) -> None:
    """Each card of a sharded driver run: K1/K2/K3 LLAMA_LAUNCHES a step,
    its resident param bytes the rule engine's reckoning and below one
    card's whole model, and its peak in the init below the whole model,
    which building the model whole before sharding it held on every card
    at once."""
    want_launches = {k: n * GANG_STEPS for k, n in LLAMA_LAUNCHES.items()}
    for r, card in enumerate(res["by_rank"]):
        check(card["flash_launches"] == want_launches,
              f"{name} card {r}: flash launches {card['flash_launches']}, want "
              f"{want_launches}")
        check(card["param_bytes"] == card["param_bytes_reckoned"] < whole_bytes,
              f"{name} card {r}: resident param bytes {card['param_bytes']}, the "
              f"rule engine's reckoning {card['param_bytes_reckoned']}, one card's "
              f"{whole_bytes}")
        check(card["init_max_memory_allocated"] < whole_bytes,
              f"{name} card {r}: peak in the init {card['init_max_memory_allocated']} "
              f"is not below the whole model's {whole_bytes}")


def train_llama_gang(torch, ranks: int) -> dict:
    """Llama-2 7B LoRA (config 5) sharded over ``ranks`` cards (NCCL): the
    port's driver through its cli at ``local[ranks]`` with its default
    ``--fsdp -1`` (global b=8, S=1,024, LoRA rank 16), with ``--tensor T``
    for each T of LLAMA_TP_SHAPES that divides ``ranks`` (fsdp = N/T ×
    tensor = T), and at ``local[1]`` on the same batches. Held on each run:
    every rank's losses one card's at GANG_LOSS_RTOL, K1/K2/K3
    LLAMA_LAUNCHES a step on every card at its local heads, each param in
    sync within its replica group, each card's resident param bytes the
    rule engine's reckoning, each card's peak in the init below the whole
    model, and at fsdp=N each card's peak in fit at least half the base
    below one card's. Then comparison runs: the LoRA at fsdp=N and at
    fsdp=N/2 × tensor=2 (each profiled), the full fine-tune at
    LLAMA_GANG_FULL_LAYERS layers (sharded params in training) at fsdp=N,
    at data=2 × fsdp=N/2 (HSDP) and on one card: losses at GANG_LOSS_RTOL
    and grad norms at GANG_GRAD_NORM_RTOL; each of LLAMA_GANG_FAULTS
    planted into its N-rank run must break one of those limits. Prints
    each card's step ms, tokens/s, peak memory, a profiled window's NCCL
    time and kernels, and NCCL's algorithm and protocol for each
    collective of the driver runs."""
    root = ROOT / "build" / f"chip_smoke_llama_gang_{ranks}"
    args = _llama_gang_args(ranks, GANG_STEPS)
    many = _driver_run("llama_lora", root / "driver", ranks, args,
                       env=_nccl_env(root / "driver"))
    one = _driver_run("llama_lora", root / "one", 1, args)
    tps = {t: _driver_run("llama_lora", root / f"driver-tp{t}", ranks,
                          _llama_gang_args(ranks, GANG_STEPS, t),
                          env=_nccl_env(root / f"driver-tp{t}"))
           for t, _ in LLAMA_TP_SHAPES if ranks % t == 0}
    # the fsdp × tensor=2 run again with NCCL's Simple protocol: its step
    # against the protocol NCCL picks (printed, not held)
    simple = (_driver_run("llama_lora", root / "driver-tp2-simple", ranks,
                          _llama_gang_args(ranks, GANG_STEPS, 2),
                          env={**_nccl_env(root / "driver-tp2-simple"),
                               "NCCL_PROTO": "Simple"})
              if 2 in tps else None)
    res, res1 = many["result"], one["result"]
    cards = res["by_rank"]
    whole_bytes = res1["by_rank"][0]["param_bytes"]  # one card holds it all
    got, want = many["losses"].get("p0", []), one["losses"].get("p0", [])
    tokens = LLAMA_BATCH * LLAMA_SEQ

    def driver_rec(run: dict) -> dict:
        r = run["result"]
        losses = run["losses"].get("p0", [])
        return dict(
            mesh=r["mesh"], sharded_params=r["sharded_params"],
            local_heads=r["local_heads"], losses=losses,
            max_loss_rel_err=_loss_gap(losses, want), loss_rtol=GANG_LOSS_RTOL,
            step_ms_by_rank=run["step_ms_by_rank"],
            tokens_per_sec_per_card={p: tokens / ranks / (ms / 1e3)
                                     for p, ms in run["step_ms_by_rank"].items()},
            init_s=r["init_s"], cards=r["by_rank"], launch=run["launch"],
            left=run["left"], nccl=_nccl_tuning(run["workdir"]))

    rec = dict(
        ranks=ranks, global_batch=LLAMA_BATCH, seq_len=LLAMA_SEQ, lora_rank=LLAMA_RANK,
        **driver_rec(many),
        one_card_losses=want, one_card_step_ms=one["step_ms_by_rank"].get("p0"),
        one_card_tokens_per_sec=tokens / (one["step_ms_by_rank"]["p0"] / 1e3),
        one_card=res1["by_rank"][0],
        tensor_parallel={t: driver_rec(run) for t, run in tps.items()},
        tensor_2_nccl_simple=None if simple is None else driver_rec(simple))
    comparisons = {}
    tp_args = _llama_gang_args(ranks, GANG_STEPS, 2)
    for mode, mode_args in (("lora", args), ("lora-tp", tp_args), ("full", args)):
        run_mode = "lora" if mode == "lora-tp" else mode
        runs = {"none": _llama_run(root / f"{mode}-none", ranks, run_mode, "none",
                                   mode_args)}
        if mode == "full":
            runs["one"] = _llama_run(root / "full-one", 1, mode, "none", args)
            if ranks % 2 == 0 and ranks > 2:
                runs["hsdp"] = _llama_run(root / "full-hsdp", ranks, "full-hsdp",
                                          "none", args)
        for fault, (fault_mode, _) in LLAMA_GANG_FAULTS.items():
            if fault_mode == mode:
                runs[fault] = _llama_run(root / f"{mode}-{fault}", ranks, run_mode,
                                         fault, mode_args)
        ref = runs.get("one")
        comparisons[mode] = {
            name: dict(
                losses=run["losses"][0], grad_norms=run["grad_norms"][0],
                step_ms=run["step_ms"], launch=run["launch"],
                mesh=run["cards"][0]["mesh"],
                replicas_in_sync=all(c["replicas_in_sync"] for c in run["cards"]),
                ranks_agree=all(v == run["losses"][0] for v in run["losses"]),
                cards=[{k: c[k] for k in ("flash_launches", "param_bytes",
                                          "param_bytes_reckoned",
                                          "max_memory_allocated",
                                          "init_max_memory_allocated", "local_heads")}
                       for c in run["cards"]],
                profile=run["cards"][0].get("profile"),
                **(dict(max_loss_rel_err=_loss_gap(run["losses"][0], ref["losses"][0]),
                        max_grad_norm_rel_err=_loss_gap(run["grad_norms"][0],
                                                       ref["grad_norms"][0]))
                   if ref is not None and name != "one" else {}))
            for name, run in runs.items()}
    # the LoRA runs and their faults against the sound driver runs' one card
    for mode in ("lora", "lora-tp"):
        for run in comparisons[mode].values():
            run["max_loss_rel_err"] = _loss_gap(run["losses"], want)
    rec["comparisons"] = comparisons
    profiles = {m: comparisons[m]["none"]["profile"] or {} for m in ("lora", "lora-tp")}
    rec["nccl_ms_per_step"] = {m: p.get("busy_ms_by_family", {}).get("nccl")
                               for m, p in profiles.items()}
    rec["nccl_kernels_ms_per_step"] = {m: _nccl_kernels(p) for m, p in profiles.items()}
    rec["card"] = nvidia_smi_line()
    rec["torch_version"] = torch.__version__
    rec["nccl_version"] = torch.cuda.nccl.version()
    print("gang llama " + json.dumps(rec), flush=True)
    check(res["world_size"] == ranks and res["backend"] == "nccl"
          and res["mesh"]["data"] == 1 and res["mesh"]["fsdp"] == ranks
          and res["replicas_checked"] and res["sharded_params"] > 0,
          f"llama gang: {({k: v for k, v in res.items() if k != 'train'})}")
    check(res1["mesh"]["fsdp"] == 1 and res1["sharded_params"] == 0,
          f"the one-card run sharded: {res1['mesh']}, {res1['sharded_params']}")
    for name, run in (("fsdp", many), *((f"tensor={t}", r) for t, r in tps.items())):
        r = run["result"]
        t = r["mesh"]["tensor"]
        check(r["world_size"] == ranks and r["mesh"]["fsdp"] * t == ranks
              and r["replicas_checked"] and r["local_heads"] == LLAMA_HEADS // t,
              f"llama gang {name}: {({k: v for k, v in r.items() if k != 'train'})}")
        logged = run["losses"].get("p0", [])
        check(sorted(run["losses"]) == [f"p{q}" for q in range(ranks)]
              and all(v == logged for v in run["losses"].values()),
              f"llama gang {name}: the ranks logged different losses")
        gap = _loss_gap(logged, want)
        check(gap <= GANG_LOSS_RTOL,
              f"llama gang {name}: the losses at {ranks} cards are off one card's "
              f"({gap} > {GANG_LOSS_RTOL}): {logged} vs {want}")
        _cards_check(r, ranks, whole_bytes, f"llama gang {name}")
        check(not run["left"], f"llama gang {name} left {run['left']}")
    for r, card in enumerate(cards):
        check(res1["by_rank"][0]["max_memory_allocated"] - card["max_memory_allocated"]
              >= whole_bytes / 2,
              f"card {r}: peak {card['max_memory_allocated']} is not half the base "
              f"below one card's {res1['by_rank'][0]['max_memory_allocated']}")
    check(not one["left"], f"left {one['left']}")
    for m, p in profiles.items():
        check(p.get("busy_ms_by_family", {}).get("nccl", 0.0) > 0,
              f"no NCCL kernel in the profiled llama gang ({m}): {p}")
    sound = [comparisons[m]["none"] for m in ("lora", "lora-tp", "full")]
    check(all(run["replicas_in_sync"] and run["ranks_agree"] for run in sound)
          and all(run["max_loss_rel_err"] <= GANG_LOSS_RTOL for run in sound[:2]),
          f"llama gang comparisons: {sound}")
    for name in ("none", "hsdp"):
        full = comparisons["full"].get(name)
        if full is None:
            continue
        check(full["replicas_in_sync"] and full["ranks_agree"]
              and full["max_loss_rel_err"] <= GANG_LOSS_RTOL
              and full["max_grad_norm_rel_err"] <= GANG_GRAD_NORM_RTOL,
              f"the full fine-tune at {full['mesh']} is off one card's: "
              f"{full['max_loss_rel_err']}, {full['max_grad_norm_rel_err']}")
    for fault, (mode, why) in LLAMA_GANG_FAULTS.items():
        if mode in LLAMA_CP_LAYOUTS:  # train_llama_cp_gang's
            continue
        seen = comparisons[mode][fault]
        check(not seen["replicas_in_sync"] or seen["max_loss_rel_err"] > GANG_LOSS_RTOL
              or seen.get("max_grad_norm_rel_err", 0.0) > GANG_GRAD_NORM_RTOL,
              f"llama gang: the planted fault {fault!r} ({why}) stays within every "
              f"limit: {seen}")
    return rec


# -- chip_smoke.py --gang llama-pp: config 5 pipelined over the cards -------------

#: the pipelined layouts of config 5 on four cards: name → (``--pipeline``,
#: ``--microbatches``, ``--tensor``); the rest of the cards go to fsdp (the
#: driver's default ``--fsdp -1``)
LLAMA_PP_LAYOUTS = {"pipe4-m2": (4, 2, 1), "pipe4-m4": (4, 4, 1), "pipe4-m8": (4, 8, 1),
                    "fsdp2-pipe2-m4": (2, 4, 1), "pipe2-tensor2-m4": (2, 4, 2)}
#: the full fine-tune (LLAMA_GANG_FULL_LAYERS layers of the 7B widths, the
#: embedding and the head in training) pipelined on two cards: (``--pipeline``,
#: ``--microbatches``)
LLAMA_PP_FULL = (2, 2)
#: config 5 at pipe=4: each card's resident param bytes (8 layers' bf16 base,
#: f32 LoRA and norms; the bf16 embedding and head and the f32 final norm)
LLAMA_PP4_PARAM_BYTES = 3_770_957_824
#: Llama-2 7B's hidden width (a handoff is a microbatch of it, in bf16)
LLAMA_HIDDEN = 4096


def _pp_reckoning(layers: int, stage: int, pipe: int, micro: int, rows: int) -> dict:
    """What a card of pipeline ``stage`` does each step: its K1/K2/K3
    launches (K1 in each of its layers' forward and remat recompute for
    each microbatch), the bytes it sends stage to stage (a microbatch of
    ``rows // micro`` rows of bf16 activations forward unless it is the
    last stage, its gradient back unless it is the first) and in the
    bank's broadcast (the last stage: every microbatch)."""
    per = layers // pipe * micro
    mb = rows // micro * LLAMA_SEQ * LLAMA_HIDDEN * 2
    return dict(launches={"flash_fwd": 2 * per, "flash_bwd_dq": per, "flash_bwd_dkv": per},
                handoff_bytes=micro * mb * ((stage < pipe - 1) + (stage > 0)),
                broadcast_bytes=micro * mb if stage == pipe - 1 else 0,
                bubble=(pipe - 1) / (micro + pipe - 1))


def train_llama_pp_gang(torch, ranks: int, faults: bool = True) -> dict:
    """Llama-2 7B LoRA (config 5) pipelined over ``ranks`` cards (NCCL): the
    driver's session, data and trainer (:func:`llama_rank`, ``pp-lora``) at
    each of LLAMA_PP_LAYOUTS (pipe=4 at M = 4 and 8, fsdp=2 × pipe=2 and
    pipe=2 × tensor=2 at M = 4) and on one card, on the same global batches
    (b = 8, S = 1,024, full width), GANG_STEPS steps, the first one's FLOPs
    measured; then (with ``faults``) the 2-layer full fine-tune at pipe=2
    on two cards and on one and the planted faults. Held on each run: every rank's losses one card's at
    GANG_LOSS_RTOL and its grad norms at GANG_GRAD_NORM_RTOL, each param in
    sync within its replica group, each card's K1/K2/K3 launches, handoff
    and broadcast bytes as :func:`_pp_reckoning` reckons, its resident param
    bytes the rule engine's (LLAMA_PP4_PARAM_BYTES at pipe=4), the measured
    FLOPs a step one card's; each of the pipeline's LLAMA_GANG_FAULTS
    planted into its run must break one of those limits. Prints each
    card's step ms, tokens/s and busy share in a profiled window beside
    the bubble (P − 1)/(M + P − 1)."""
    root = ROOT / "build" / f"chip_smoke_llama_pp_{ranks}"
    base = _llama_gang_args(ranks, GANG_STEPS)
    one = _llama_run(root / "one", 1, "pp-lora", "none", base)
    runs = {}
    for name, (pipe, micro, tensor) in LLAMA_PP_LAYOUTS.items():
        args = [*_llama_gang_args(ranks, GANG_STEPS, tensor), "--pipeline", str(pipe),
                "--microbatches", str(micro)]
        runs[name] = _llama_run(root / name, ranks, "pp-lora", "none", args)
    planted, full, full_one = {}, None, None
    if faults:
        pipe4 = [*base, "--pipeline", "4", "--microbatches", "4"]
        planted = {f: _llama_run(root / f"pipe4-m4-{f}", ranks, "pp-lora", f, pipe4)
                   for f, (mode, _) in LLAMA_GANG_FAULTS.items() if mode == "pp-lora"}
        full_args = [*base, "--pipeline", str(LLAMA_PP_FULL[0]), "--microbatches",
                     str(LLAMA_PP_FULL[1])]
        full_one = _llama_run(root / "full-one", 1, "pp-full", "none", base)
        full = _llama_run(root / "full-pipe2", LLAMA_PP_FULL[0], "pp-full", "none",
                          full_args)
        planted.update({f: _llama_run(root / f"full-pipe2-{f}", LLAMA_PP_FULL[0],
                                      "pp-full", f, full_args)
                        for f, (mode, _) in LLAMA_GANG_FAULTS.items() if mode == "pp-full"})
    tokens = LLAMA_BATCH * LLAMA_SEQ

    def summary(run: dict, ref: dict, micro: int | None = None, layers: int = LLAMA_LAYERS
                ) -> dict:
        cards = run["cards"]
        mesh = cards[0]["mesh"]
        rows = LLAMA_BATCH // (mesh["data"] * mesh["fsdp"])
        out = dict(
            mesh=mesh, microbatches=micro, losses=run["losses"][0],
            grad_norms=run["grad_norms"][0],
            max_loss_rel_err=_loss_gap(run["losses"][0], ref["losses"][0]),
            max_grad_norm_rel_err=_loss_gap(run["grad_norms"][0], ref["grad_norms"][0]),
            ranks_agree=all(v == run["losses"][0] for v in run["losses"]),
            replicas_in_sync=all(c["replicas_in_sync"] for c in cards),
            flops_per_step=cards[0]["flops_per_step"],
            step_ms_by_rank=run["step_ms"],
            host_call_ms_by_rank=[c["host_call_ms"] for c in cards],
            tokens_per_sec_per_card=[tokens / len(cards) / (ms / 1e3) if ms else None
                                     for ms in run["step_ms"]],
            launch=run["launch"], cards=[])
        for c in cards:
            want = (_pp_reckoning(layers, c["pipe_stage"], mesh["pipe"], micro, rows)
                    if micro else None)
            prof = c.get("profile") or {}
            out["cards"].append(dict(
                stage=c["pipe_stage"], flash_launches=c["flash_launches"],
                param_bytes=c["param_bytes"], param_bytes_reckoned=c["param_bytes_reckoned"],
                handoff_bytes=c["handoff_bytes"], broadcast_bytes=c["broadcast_bytes"],
                reckoned=want, max_memory_allocated=c["max_memory_allocated"],
                busy_share=(1.0 - prof["idle_share"]) if "idle_share" in prof else None,
                bubble=want and want["bubble"],
                busy_ms_per_step=prof.get("busy_ms_per_step"),
                wall_ms_per_step=prof.get("wall_ms_per_step"),
                nccl_ms_per_step=prof.get("busy_ms_by_family", {}).get("nccl"),
                flops_per_step=c["flops_per_step"]))
        return out

    rec = dict(ranks=ranks, global_batch=LLAMA_BATCH, seq_len=LLAMA_SEQ,
               lora_rank=LLAMA_RANK,
               one_card=dict(losses=one["losses"][0], grad_norms=one["grad_norms"][0],
                             step_ms=one["step_ms"][0],
                             host_call_ms=one["cards"][0]["host_call_ms"],
                             tokens_per_sec=tokens / (one["step_ms"][0] / 1e3),
                             flops_per_step=one["cards"][0]["flops_per_step"],
                             flash_launches=one["cards"][0]["flash_launches"],
                             max_memory_allocated=one["cards"][0]["max_memory_allocated"]),
               layouts={name: summary(run, one, LLAMA_PP_LAYOUTS[name][1])
                        for name, run in runs.items()},
               full=full and summary(full, full_one, LLAMA_PP_FULL[1],
                                     LLAMA_GANG_FULL_LAYERS),
               full_one_card=full_one and dict(losses=full_one["losses"][0],
                                               grad_norms=full_one["grad_norms"][0]),
               faults={f: summary(run, full_one if LLAMA_GANG_FAULTS[f][0] == "pp-full"
                                  else one) for f, run in planted.items()},
               card=nvidia_smi_line(), torch_version=torch.__version__,
               nccl_version=torch.cuda.nccl.version())
    print("gang llama-pp " + json.dumps(rec), flush=True)
    want_one = {k: n * GANG_STEPS for k, n in LLAMA_LAUNCHES.items()}
    check(one["cards"][0]["flash_launches"] == want_one,
          f"llama pp: one card's launches {one['cards'][0]['flash_launches']}")
    for name, r in [*rec["layouts"].items(), *([("full", rec["full"])] if full else [])]:
        check(r["ranks_agree"] and r["replicas_in_sync"],
              f"llama pp {name}: the ranks disagree or the replicas desynced: {r}")
        check(r["max_loss_rel_err"] <= GANG_LOSS_RTOL
              and r["max_grad_norm_rel_err"] <= GANG_GRAD_NORM_RTOL,
              f"llama pp {name} at {r['mesh']} is off one card's: losses "
              f"{r['max_loss_rel_err']}, grad norms {r['max_grad_norm_rel_err']}")
        want_flops = (rec["one_card"] if name != "full" else
                      dict(flops_per_step=full_one["cards"][0]["flops_per_step"]))
        check(r["flops_per_step"] == want_flops["flops_per_step"] is not None
              and all(c["flops_per_step"] == r["flops_per_step"] for c in r["cards"]),
              f"llama pp {name}: measured FLOPs {r['flops_per_step']}, one card's "
              f"{want_flops['flops_per_step']}")
        for c in r["cards"]:
            want = c["reckoned"]
            check(c["flash_launches"] == {k: n * GANG_STEPS
                                          for k, n in want["launches"].items()},
                  f"llama pp {name} stage {c['stage']}: launches {c['flash_launches']}, "
                  f"want {want['launches']} a step")
            check(c["handoff_bytes"] == want["handoff_bytes"] * GANG_STEPS
                  and c["broadcast_bytes"] == want["broadcast_bytes"] * GANG_STEPS,
                  f"llama pp {name} stage {c['stage']}: sent {c['handoff_bytes']} + "
                  f"{c['broadcast_bytes']} B, reckoned {want} a step")
            check(c["param_bytes"] == c["param_bytes_reckoned"],
                  f"llama pp {name} stage {c['stage']}: resident {c['param_bytes']} B, "
                  f"the rule engine's reckoning {c['param_bytes_reckoned']}")
            if name.startswith("pipe4"):
                check(c["param_bytes"] == LLAMA_PP4_PARAM_BYTES,
                      f"llama pp {name}: {c['param_bytes']} B a card, reckoned "
                      f"{LLAMA_PP4_PARAM_BYTES}")
            if name != "full":
                check(c["busy_share"] is not None,
                      f"llama pp {name}: no device time in the profiled window")
        check(r["mesh"]["pipe"] > 1, f"llama pp {name}: mesh {r['mesh']}")
    for fault, seen in rec["faults"].items():
        why = LLAMA_GANG_FAULTS[fault][1]
        check(not seen["replicas_in_sync"] or seen["max_loss_rel_err"] > GANG_LOSS_RTOL
              or seen["max_grad_norm_rel_err"] > GANG_GRAD_NORM_RTOL,
              f"llama pp: the planted fault {fault!r} ({why}) stays within every "
              f"limit: {seen}")
    return rec


# -- the expert axis across the cards (--gang llama-moe) -------------------------

#: the MoE comparison runs' layouts at four cards: name → (``mesh.fsdp``,
#: ``mesh.expert``); ``data`` stays 1, and one card is ``one``
MOE_LAYOUTS = {"expert4": (1, 4), "fsdp2-expert2": (2, 2)}
#: the MoE 0.9b full fine-tune: its widths cut to this many layers, f32
#: params, every param (the experts and the router too) trainable
MOE_FULL_LAYERS = 2
#: each logged ``moe_aux`` at four cards against one card's: the load
#: balance's means over the same global batch, from bf16 activations that
#: round differently at b/N rows (a near-tie flipped in one token's first
#: choice moves one layer's aux by about E·p̄/T, 2.4e-4 of its ~1, 1.5e-5 of
#: the 16 layers' sum); means taken over each rank's own rows
#: (``aux-local-means``) move it by the covariance across ranks of each
#: expert's share and mean probability. A CPU rehearsal (4 gloo ranks, the
#: widths cut to 128 hidden, 4 layers, S = 64, bf16) read 1.4e-3 sound at
#: fsdp=2 × expert=2, 1.2e-3 at expert=4 (the combined output summed over
#: the expert group in bf16; at S = 256 7.1e-4 and 9.7e-4: a flip weighs
#: less among more tokens), and 0.217 with the fault
MOE_AUX_RTOL = 2e-3
#: each logged grad norm of the MoE runs against one card's: as
#: GANG_GRAD_NORM_RTOL's, but held tighter, since the router's gradient
#: counted once per expert peer (``ep-router-summed``) moves only the part
#: of x's gradient that the router gives; the rehearsal read 3.0e-4 sound
#: (4.7e-4 at expert=4) and 1.15e-2 with that fault
MOE_GRAD_NORM_RTOL = 2e-3
#: faults planted into the MoE gang, by the (mode, layout) run they go into:
#: each must break one of its limits
MOE_GANG_FAULTS = {
    "ep-output-unsummed": (("lora", "expert4"), "no g after the local experts: "
                           "each card's output holds only its own experts' part"),
    "ep-dx-unsummed": (("lora", "expert4"), "no f before the local experts: x's "
                       "gradient holds only the local experts' part"),
    "ep-router-summed": (("full", "expert4"), "the router's input through f: its "
                         "gradient counted once per expert peer"),
    "ep-gates-unsummed": (("full", "expert4"), "no f on the combine's gates: the "
                          "router's gradient through them only the local slots' part"),
    "aux-local-means": (("lora", "fsdp2-expert2"), "the load balance from each "
                        "rank's own means, not the global batch's"),
}
#: the 7B MoE driver run: ``--variant 7b --moe-experts 8 --expert 4`` at the
#: global b=8, S=1,024, MOE_DRIVER_STEPS steps, built on the meta device
MOE_DRIVER_STEPS = 6


def _plant_moe(fault: str) -> None:
    """Plant one of MOE_GANG_FAULTS into this process's port."""
    from distributeddeeplearningspark_tpu_torch.models import llama, moe

    if fault == "ep-output-unsummed":
        moe._leave = lambda y, splits: y
    elif fault == "ep-dx-unsummed":
        moe._enter = lambda x, splits: x
    elif fault == "ep-gates-unsummed":
        moe._gates = lambda w, splits: w
    elif fault == "ep-router-summed":
        route = moe.MoEMLP._route
        moe.MoEMLP._route = lambda self, x: route(self, moe._enter(x, self.splits()))
    elif fault == "aux-local-means":
        forward = llama.LlamaForCausalLM.forward

        def local_means(self, *a, **kw):
            self.batch_sum = None
            return forward(self, *a, **kw)
        llama.LlamaForCausalLM.forward = local_means
    else:
        check(fault == "none", f"no fault {fault!r}")


def moe_rank(argv: list[str]) -> int:
    """One rank of a MoE gang comparison run (``chip_smoke.py --moe-rank OUT
    MODE FAULT LAYOUT``, run by the port's cli): the session on LAYOUT's
    mesh (MOE_LAYOUTS; ``one`` at one card), the Llama driver's feed in 4
    partitions (the same global batches at 1, 2 and 4 batch shards), MODE
    ``lora`` (the MoE 0.9b LoRA fine-tune, the bank frozen) or ``full``
    (MOE_FULL_LAYERS layers, f32, every param trainable), built on the meta
    device and drawn from seed 0, FAULT planted, GANG_STEPS steps at b=4,
    each logged; each rank writes ``OUT/rank<r>.json``: its card (flash
    launches, resident param bytes and the rule engine's reckoning, peaks),
    its local shard of layer 0's ``w_gate`` and whether each param agrees
    within its replica group. A sound LoRA run at more than one rank then
    takes GANG_WINDOW more steps under the profiler."""
    import torch

    from distributeddeeplearningspark_tpu_torch import Session
    from distributeddeeplearningspark_tpu_torch.examples import train_llama_lora as driver
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearningspark_tpu_torch.parallel import sharding
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer
    from distributeddeeplearningspark_tpu_torch.utils import sanitize

    out, mode, fault, layout = argv[:4]
    _plant_moe(fault)
    fsdp, expert = MOE_LAYOUTS.get(layout, (1, 1))
    spark = (Session.builder.appName(f"moe-gang-{mode}-{layout}-{fault}")
             .config("mesh.data", 1).config("mesh.fsdp", fsdp)
             .config("mesh.expert", expert).getOrCreate())
    ds, _ = _lm_feed(spark, 4)
    torch.cuda.reset_peak_memory_stats()
    if mode == "lora":
        cfg = moe_09b_config(torch, llama)
        tx = optim.masked(optim.with_grad_clip(optim.adamw(optim.warmup_cosine(
            LLAMA_GANG_LR, 1, GANG_STEPS)), 1.0), llama.lora_trainable)
        trainer = Trainer(spark, llama.LlamaForCausalLM(cfg, device="meta"),
                          losses.causal_lm, tx, rules=llama.llama_rules(cfg),
                          trainable=llama.lora_trainable)
    else:
        cfg = moe_09b_config(torch, llama, num_layers=MOE_FULL_LAYERS, lora_rank=0,
                             param_dtype=torch.float32)
        tx = optim.with_grad_clip(optim.adamw(optim.warmup_cosine(
            LLAMA_GANG_FULL_LR, 1, GANG_STEPS)), 1.0)
        trainer = Trainer(spark, llama.LlamaForCausalLM(cfg, device="meta"),
                          losses.causal_lm, tx, rules=llama.llama_rules(cfg))
    init_peak = torch.cuda.max_memory_allocated()
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(ds, batch_size=MOE_BATCH, steps=GANG_STEPS, log_every=1,
                tokens_per_example=LLAMA_SEQ)
    rec = driver.card_record(trainer, {k.__name__: k.launches for k in kernels})
    bank = trainer.model.layers[0].moe.w_gate
    rec.update(init_max_memory_allocated=init_peak,
               bank_local_shape=list(sharding.local(bank).shape),
               expert_split_params=len(trainer.expert_dims))
    try:
        sanitize.assert_replicas_in_sync(trainer.state.params)
        rec["replicas_in_sync"] = True
    except sanitize.DesyncError as e:
        rec["replicas_in_sync"] = False
        rec["desync"] = str(e)[:200]
    rec.update(rank=spark.rank, world_size=spark.world_size, backend=spark.backend,
               mesh=spark.mesh.shape)
    if mode == "lora" and fault == "none" and spark.world_size > 1:
        rec["profile"] = _profile_fit(torch, trainer, ds, MOE_BATCH, {},
                                      steps=GANG_WINDOW)
    Path(out, f"rank{spark.rank}.json").write_text(json.dumps(rec))
    spark.stop()
    return 0


def moe_driver_rank(argv: list[str]) -> int:
    """One rank of the 7B MoE driver run (``chip_smoke.py --moe-driver-rank
    OUT ARGS``, run by the port's cli): the port's driver's ``main(ARGS)``,
    with one change: after its ``fit`` returns, GANG_WINDOW more steps run
    under the profiler (the flash launch counts put back as they were, so
    the driver reports its own run's), and each rank writes the window to
    ``OUT/profile<r>.json``."""
    import torch

    from distributeddeeplearningspark_tpu_torch.examples import train_llama_lora as driver
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    out, args = argv[0], argv[1:]
    fit = Trainer.fit

    def fit_then_profile(self, ds, *, batch_size, **kw):
        res = fit(self, ds, batch_size=batch_size, **kw)
        Trainer.fit = fit  # the window's own fit, and any later one, unwrapped
        kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        counts = [k.launches for k in kernels]
        profile = _profile_fit(torch, self, ds, batch_size,
                               dict(tokens_per_example=kw.get("tokens_per_example")),
                               steps=GANG_WINDOW)
        for k, n in zip(kernels, counts):
            k.launches = n
        Path(out, f"profile{self.session.rank}.json").write_text(json.dumps(profile))
        return res

    Trainer.fit = fit_then_profile
    driver.main(args)
    return 0


def _moe_driver_run(workdir: Path, ranks: int, args: list[str], env: dict) -> dict:
    """A :func:`moe_driver_rank` launch at ``local[ranks]``: rank 0's JSON
    line, each rank's profiled window, logged losses and step ms (its laps
    of the driver's own steps after the first) and its ``collective``
    events, from its telemetry."""
    import shutil

    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    lines, timing = _launch(workdir, ranks, Path(__file__).resolve(),
                            ["--moe-driver-rank", str(workdir), *args], timeout=1200,
                            env=env)
    results = [json.loads(x) for x in lines if x.startswith('{"train"')]
    check(len(results) == 1, f"the MoE driver printed {len(results)} result lines: "
          f"{lines[-20:]}")
    losses: dict[str, list] = {}
    laps: dict[str, list] = {}
    laps_all: dict[str, int] = {}
    probes: dict[str, list] = {}
    for r in _events(workdir):
        p = r["process"]
        if r["kind"] == "step_metrics":
            laps_all[p] = laps_all.get(p, 0) + 1
            if r["step"] <= MOE_DRIVER_STEPS:
                losses.setdefault(p, []).append(r["metrics"]["loss"])
                laps.setdefault(p, []).append(r["lap_s"] * 1e3 / r["steps"])
        elif r["kind"] == "collective":
            probes.setdefault(p, []).append(r)
    barriers = {p: [e for e in v if e["op"] == "barrier"] for p, v in probes.items()}
    profiles = [json.loads((workdir / f"profile{q}.json").read_text())
                for q in range(ranks)]
    return dict(result=results[0], launch=timing, losses=losses, profiles=profiles,
                step_ms_by_rank={p: float(np.mean(v[1:])) for p, v in laps.items()},
                laps_by_rank=laps_all,
                probe_events_by_rank={p: {op: sum(e["op"] == op for e in v)
                                          for op in sorted({e["op"] for e in v})}
                                      for p, v in probes.items()},
                barrier_wait_s_by_rank={p: sum(e["wait_s"] for e in v)
                                        for p, v in barriers.items()})


def train_llama_moe_gang(torch, ranks: int) -> dict:
    """The ``expert`` mesh axis across ``ranks`` (4) cards, NCCL. Comparison
    runs (:func:`moe_rank`) of the MoE 0.9b LoRA fine-tune and of its
    MOE_FULL_LAYERS-layer full fine-tune at ``expert=4`` and at ``fsdp=2 ×
    expert=2`` against one card on the same global batches: each rank's
    losses the same and within GANG_LOSS_RTOL of one card's, the grad norms
    within MOE_GRAD_NORM_RTOL and ``moe_aux`` within MOE_AUX_RTOL, each
    param in sync within its replica group, each card holding its own
    experts (layer 0's bank ``[8/expert, 2,048/fsdp, 5,632]``) at the rule
    engine's resident bytes, K1/K2/K3 at MOE_LAUNCHES a step (and the full
    fine-tune's two layers' share); each of MOE_GANG_FAULTS must break one
    of those limits. Then the port's driver at ``--variant 7b --moe-experts
    8 --expert 4`` (:func:`moe_driver_rank`, b=8, S=1,024,
    MOE_DRIVER_STEPS steps, built on the meta device, ``DLS_COMMS_PROBE=1``):
    each card's resident bytes, its init and fit peaks, finite losses,
    K1/K2/K3 LLAMA_LAUNCHES a step, step ms, tokens/s a card, a profiled
    window's NCCL time, and one ``barrier`` ``collective`` event a log lap
    on every rank (and no other: at ``expert=4`` the loss group is one rank,
    so the load balance's sums make no collective). No one-card run exists
    at that size (37.0B params, 74.1 GB in bf16)."""
    root = ROOT / "build" / f"chip_smoke_llama_moe_gang_{ranks}"
    comparisons: dict = {}
    for mode in ("lora", "full"):
        runs = {"one": _llama_run(root / f"{mode}-one", 1, mode, "none", ["one"],
                                  entry="--moe-rank")}
        for layout in MOE_LAYOUTS:
            runs[layout] = _llama_run(root / f"{mode}-{layout}", ranks, mode, "none",
                                      [layout], entry="--moe-rank")
        for fault, ((fmode, layout), _) in MOE_GANG_FAULTS.items():
            if fmode == mode:
                runs[fault] = _llama_run(root / f"{mode}-{fault}", ranks, mode, fault,
                                         [layout], entry="--moe-rank")
        ref = runs["one"]
        comparisons[mode] = {
            name: dict(
                losses=run["losses"][0], grad_norms=run["grad_norms"][0],
                moe_aux=run["moe_aux"][0], step_ms=run["step_ms"], launch=run["launch"],
                mesh=run["cards"][0]["mesh"],
                replicas_in_sync=all(c["replicas_in_sync"] for c in run["cards"]),
                ranks_agree=all(v == run["losses"][0] for v in run["losses"]),
                cards=[{k: c[k] for k in ("flash_launches", "param_bytes",
                                          "param_bytes_reckoned", "bank_local_shape",
                                          "expert_split_params", "max_memory_allocated",
                                          "init_max_memory_allocated")}
                       for c in run["cards"]],
                profile=run["cards"][0].get("profile"),
                **(dict(max_loss_rel_err=_loss_gap(run["losses"][0], ref["losses"][0]),
                        max_grad_norm_rel_err=_loss_gap(run["grad_norms"][0],
                                                       ref["grad_norms"][0]),
                        max_moe_aux_rel_err=_loss_gap(run["moe_aux"][0],
                                                      ref["moe_aux"][0]))
                   if name != "one" else {}))
            for name, run in runs.items()}
    nccl_env = _nccl_env(root / "driver")
    driver_args = ["--variant", "7b", "--moe-experts", str(MOE_EXPERTS), "--expert",
                   str(ranks), "--seq-len", str(LLAMA_SEQ), "--batch-size",
                   str(LLAMA_BATCH), "--lora-rank", str(LLAMA_RANK), "--lora-alpha", "16",
                   "--lr", str(LLAMA_GANG_LR), "--steps", str(MOE_DRIVER_STEPS),
                   "--log-every", "1", "--source-partitions", str(ranks)]
    drv = _moe_driver_run(root / "driver", ranks, driver_args,
                          env={**nccl_env, "DLS_COMMS_PROBE": "1"})
    res = drv["result"]
    tokens = LLAMA_BATCH * LLAMA_SEQ
    rec = dict(
        ranks=ranks, batch_size=MOE_BATCH, seq_len=LLAMA_SEQ, comparisons=comparisons,
        nccl_ms_per_step={m: (comparisons[m].get("expert4", {}).get("profile") or {})
                          .get("busy_ms_by_family", {}).get("nccl") for m in ("lora",)},
        driver=dict(
            mesh=res["mesh"], moe_experts=res["moe_experts"],
            expert_split_params=res["expert_split_params"], losses=drv["losses"],
            step_ms_by_rank=drv["step_ms_by_rank"],
            tokens_per_sec_per_card={p: tokens / ranks / (ms / 1e3)
                                     for p, ms in drv["step_ms_by_rank"].items()},
            cards=res["by_rank"], init_s=res["init_s"], launch=drv["launch"],
            probe_events_by_rank=drv["probe_events_by_rank"],
            barrier_wait_s_by_rank=drv["barrier_wait_s_by_rank"],
            laps_by_rank=drv["laps_by_rank"],
            nccl_ms_per_step=[(p.get("busy_ms_by_family") or {}).get("nccl")
                              for p in drv["profiles"]],
            nccl_kernels_ms_per_step=_nccl_kernels(drv["profiles"][0]),
            profile=drv["profiles"][0], nccl=_nccl_tuning(root / "driver")),
        card=nvidia_smi_line(), torch_version=torch.__version__,
        nccl_version=torch.cuda.nccl.version())
    print("gang llama-moe " + json.dumps(rec), flush=True)
    want = {"lora": {k: n * GANG_STEPS for k, n in MOE_LAUNCHES.items()},
            "full": {k: n * GANG_STEPS * MOE_FULL_LAYERS // MOE_LAYERS
                     for k, n in MOE_LAUNCHES.items()}}
    for mode, runs in comparisons.items():
        for name, run in runs.items():
            sound = name == "one" or name in MOE_LAYOUTS
            if not sound:
                continue
            fsdp, expert = MOE_LAYOUTS.get(name, (1, 1))
            check(run["mesh"]["fsdp"] == fsdp and run["mesh"]["expert"] == expert,
                  f"moe gang {mode}/{name}: mesh {run['mesh']}")
            check(run["replicas_in_sync"] and run["ranks_agree"],
                  f"moe gang {mode}/{name}: replicas or ranks disagree: {run}")
            for r, card in enumerate(run["cards"]):
                check(card["flash_launches"] == want[mode],
                      f"moe gang {mode}/{name} card {r}: flash launches "
                      f"{card['flash_launches']}, want {want[mode]}")
                check(card["param_bytes"] == card["param_bytes_reckoned"],
                      f"moe gang {mode}/{name} card {r}: resident {card['param_bytes']}, "
                      f"the rule engine's {card['param_bytes_reckoned']}")
                check(card["bank_local_shape"] == [MOE_EXPERTS // expert,
                                                   MOE_HIDDEN // fsdp, MOE_FFN],
                      f"moe gang {mode}/{name} card {r}: layer 0's bank "
                      f"{card['bank_local_shape']}")
            if name == "one":
                continue
            check(run["max_loss_rel_err"] <= GANG_LOSS_RTOL
                  and run["max_grad_norm_rel_err"] <= MOE_GRAD_NORM_RTOL
                  and run["max_moe_aux_rel_err"] <= MOE_AUX_RTOL,
                  f"moe gang {mode}/{name} is off one card's: loss "
                  f"{run['max_loss_rel_err']}, grad norm {run['max_grad_norm_rel_err']}, "
                  f"moe_aux {run['max_moe_aux_rel_err']}")
    for fault, ((mode, _), why) in MOE_GANG_FAULTS.items():
        seen = comparisons[mode][fault]
        check(not seen["replicas_in_sync"] or seen["max_loss_rel_err"] > GANG_LOSS_RTOL
              or seen["max_grad_norm_rel_err"] > MOE_GRAD_NORM_RTOL
              or seen["max_moe_aux_rel_err"] > MOE_AUX_RTOL,
              f"moe gang: the planted fault {fault!r} ({why}) stays within every "
              f"limit: {seen}")
    check(res["world_size"] == ranks and res["backend"] == "nccl"
          and res["mesh"]["expert"] == ranks and res["mesh"]["fsdp"] == 1
          and res["moe_experts"] == MOE_EXPERTS and res["replicas_checked"]
          and res["expert_split_params"] == 3 * LLAMA_LAYERS,
          f"moe driver: {({k: v for k, v in res.items() if k != 'train'})}")
    want7 = {k: n * MOE_DRIVER_STEPS for k, n in LLAMA_LAUNCHES.items()}
    for r, card in enumerate(res["by_rank"]):
        check(card["flash_launches"] == want7,
              f"moe driver card {r}: flash launches {card['flash_launches']}, want {want7}")
        check(card["param_bytes"] == card["param_bytes_reckoned"],
              f"moe driver card {r}: resident {card['param_bytes']}, the rule "
              f"engine's {card['param_bytes_reckoned']}")
    logged = drv["losses"]
    check(sorted(logged) == [f"p{q}" for q in range(ranks)]
          and all(len(v) == MOE_DRIVER_STEPS and all(np.isfinite(v)) and v == logged["p0"]
                  for v in logged.values()),
          f"moe driver's logged losses: {logged}")
    check(all(drv["probe_events_by_rank"].get(p, {}).get("barrier") == n
              for p, n in drv["laps_by_rank"].items()),
          f"moe driver: collective events {drv['probe_events_by_rank']}, a barrier "
          f"a lap {drv['laps_by_rank']}")
    check(all((p.get("busy_ms_by_family") or {}).get("nccl", 0.0) > 0
              for p in drv["profiles"]), "no NCCL kernel in the MoE driver's window")
    return rec


def _llama_cp_args(seq: int, impl: str) -> list[str]:
    """The driver's flags of the CP runs: 7B at the global b=4, S=4,096
    (Llama-2's max_position), LoRA rank 16, the corpus in 4 source
    partitions (the same global batches at 1 and 2 batch shards), and
    ``--seq-parallel``/``--cp-impl`` above one card."""
    cp = ["--seq-parallel", str(seq), "--cp-impl", impl] if seq > 1 else []
    return ["--variant", "7b", "--seq-len", str(CP_SEQ), "--batch-size", str(CP_BATCH),
            "--lora-rank", str(LLAMA_RANK), "--lora-alpha", "16", "--lr",
            str(LLAMA_GANG_LR), "--steps", str(GANG_STEPS), "--log-every", "1",
            "--source-partitions", "4", *cp]


def _cp_prediction(ranks: int, seq: int, impl: str, seq_index: int) -> dict:
    """What a card at ``seq`` index ``seq_index`` should show in GANG_STEPS
    steps, reckoned from the shapes: K1 in each layer's forward and remat
    recompute and K2/K3 in its backward, once for each hop that meets a
    local query (the ring: the diagonal and the 1 + r − 1 blocks before it;
    Ulysses: one full-sequence call); and the bytes it sends: the ring's
    K/V blocks (bf16) N − 1 times forward and again in the recompute, N − 1
    times backward beside N rotations of the f32 dK/dV; Ulysses' 12
    all-to-alls a layer (q, k, v and o; forward, recompute, backward) but
    the first layer's k's backward, each sending (N − 1)/N of its [b, S/N,
    heads, 128] bf16 tensor."""
    rows, sl = CP_BATCH // (ranks // seq), CP_SEQ // seq
    hops = 1 + seq_index if impl == "ring" else 1
    # one bf16 [b, S/N, heads, D] block of q (and o), and of k (and v)
    q_block, kv_block = (rows * sl * h * LLAMA_HEAD_DIM * 2
                         for h in (LLAMA_HEADS, LLAMA_KV_HEADS))
    steps = GANG_STEPS * LLAMA_LAYERS
    if impl == "ring":
        per_step = LLAMA_LAYERS * (2 * (seq - 1) * 2 * kv_block + (seq - 1) * 2 * kv_block
                                   + seq * 4 * kv_block)
    else:
        # the first layer's k takes no gradient (wk and the embedding are
        # frozen), so autograd skips that all-to-all's backward
        per_step = LLAMA_LAYERS * 3 * sum(t * (seq - 1) // seq for t in (
            q_block, kv_block, kv_block, q_block)) - kv_block * (seq - 1) // seq
    return dict(flash_launches={"flash_fwd": 2 * hops * steps, "flash_bwd_dq": hops * steps,
                                "flash_bwd_dkv": hops * steps},
                cp_bytes_sent=per_step * GANG_STEPS,
                positions=[seq_index * sl, seq_index * sl + sl - 1, sl])


def train_llama_cp_gang(torch, ranks: int) -> dict:
    """Context parallelism for config 5 over ``ranks`` cards: Llama-2 7B
    LoRA at the global b=4, S=4,096 through the driver's session, data,
    config and trainer (:func:`llama_rank`), at each layout of
    LLAMA_CP_LAYOUTS (the ring at seq=4, Ulysses at seq=4, the ring at
    fsdp=2 × seq=2) and at one card on the same batches. Held on each
    layout: every rank's losses one card's at GANG_LOSS_RTOL and its grad
    norms at GANG_GRAD_NORM_RTOL, each param in sync within its replica
    group, each card's K1/K2/K3 launches, the bytes its exchanges sent and
    the RoPE positions of its block as :func:`_cp_prediction` reckons
    them, its resident param bytes the rule engine's reckoning, and its
    peak in ``fit`` below one card's. The CP faults of LLAMA_GANG_FAULTS,
    planted into their layout's run, must each break one of those limits.
    Prints each card's step ms, tokens/s, peak memory and a profiled
    window's NCCL time."""
    root = ROOT / "build" / f"chip_smoke_llama_cp_{ranks}"
    one = _llama_run(root / "one", 1, "lora", "none", _llama_cp_args(1, "ring"))
    layouts = {name: lay for name, lay in LLAMA_CP_LAYOUTS.items() if ranks % lay[0] == 0}
    runs = {name: _llama_run(root / name, ranks, "lora", "none", _llama_cp_args(*lay))
            for name, lay in layouts.items()}
    for fault, (layout, _) in LLAMA_GANG_FAULTS.items():
        if layout in layouts:
            runs[fault] = _llama_run(root / fault, ranks, "lora", fault,
                                     _llama_cp_args(*layouts[layout]))
    tokens = CP_BATCH * CP_SEQ
    one_card = one["cards"][0]

    def limits(name: str, run: dict) -> dict:
        """What ``run`` shows against one card and the reckoning."""
        layout = name if name in layouts else LLAMA_GANG_FAULTS[name][0]
        seq, impl = layouts[layout]
        cards = run["cards"]
        want = [_cp_prediction(ranks, seq, impl, c["seq_index"]) for c in cards]
        prof = cards[0].get("profile") or {}
        return dict(
            layout=layout, mesh=cards[0]["mesh"], losses=run["losses"][0],
            max_loss_rel_err=_loss_gap(run["losses"][0], one["losses"][0]),
            max_grad_norm_rel_err=_loss_gap(run["grad_norms"][0], one["grad_norms"][0]),
            ranks_agree=all(v == run["losses"][0] for v in run["losses"]),
            replicas_in_sync=all(c["replicas_in_sync"] for c in cards),
            launches_as_reckoned=all(c["flash_launches"] == w["flash_launches"]
                                     for c, w in zip(cards, want)),
            bytes_as_reckoned=all(c["cp_bytes_sent"] == w["cp_bytes_sent"]
                                  for c, w in zip(cards, want)),
            positions_global=all(c["positions"] == w["positions"]
                                 for c, w in zip(cards, want)),
            resident_as_reckoned=all(c["param_bytes"] == c["param_bytes_reckoned"]
                                     for c in cards),
            peak_below_one_card=all(c["max_memory_allocated"]
                                    < one_card["max_memory_allocated"] for c in cards),
            cards=[{k: c[k] for k in ("seq_index", "flash_launches", "cp_bytes_sent",
                                      "positions", "param_bytes", "max_memory_allocated",
                                      "init_max_memory_allocated")} for c in cards],
            step_ms=run["step_ms"],
            tokens_per_sec_per_card=[tokens / ranks / (ms / 1e3) if ms else None
                                     for ms in run["step_ms"]],
            launch=run["launch"],
            nccl_ms_per_step=prof.get("busy_ms_by_family", {}).get("nccl"),
            nccl_kernels_ms_per_step=_nccl_kernels(prof),
            profile=prof or None)

    seen = {name: limits(name, run) for name, run in runs.items()}
    rec = dict(ranks=ranks, global_batch=CP_BATCH, seq_len=CP_SEQ, lora_rank=LLAMA_RANK,
               one_card=dict(losses=one["losses"][0], step_ms=one["step_ms"][0],
                             tokens_per_sec=tokens / (one["step_ms"][0] / 1e3),
                             card=one_card),
               runs=seen, card=nvidia_smi_line())
    print("gang llama-cp " + json.dumps(rec), flush=True)
    held = ("ranks_agree", "replicas_in_sync", "launches_as_reckoned",
            "bytes_as_reckoned", "positions_global", "resident_as_reckoned",
            "peak_below_one_card")

    def within(r: dict) -> bool:
        return (all(r[k] for k in held) and r["max_loss_rel_err"] <= GANG_LOSS_RTOL
                and r["max_grad_norm_rel_err"] <= GANG_GRAD_NORM_RTOL)

    check(one_card["flash_launches"] == {k: n * GANG_STEPS for k, n in LLAMA_LAUNCHES.items()},
          f"llama cp: one card's launches {one_card['flash_launches']}")
    for name in layouts:
        r = seen[name]
        check(within(r), f"llama cp {name} at {r['mesh']} breaks a limit: "
                         f"{({k: v for k, v in r.items() if k != 'profile'})}")
        check(not r["profile"] or r["nccl_ms_per_step"],
              f"llama cp {name}: no NCCL kernel in the profiled window")
    for fault, (layout, why) in LLAMA_GANG_FAULTS.items():
        if layout in layouts:
            check(not within(seen[fault]),
                  f"llama cp: the planted fault {fault!r} ({why}) stays within every "
                  f"limit: {seen[fault]}")
    return rec


# -- chip_smoke.py --gang llama-drain: config 5's preemption drain ---------------------

#: the drill's global batch and source partitions: both divide by 4 and by 3,
#: so the global batches are the same before and after the shrink (the
#: gang's b = 8 does not divide by 3)
DRAIN_BATCH, DRAIN_PARTITIONS = 12, 12
#: its steps, the step host 1's notice drains at, and the die_host run's
#: checkpoint interval and the step before which host 1 dies: it walks back
#: to the newest committed checkpoint, step 4 if the step's asynchronous
#: write (~13.5 GB) has committed by then, else the start
DRAIN_STEPS, DRAIN_AT, DRAIN_EVERY, DRAIN_DIE_AT = 8, 4, 4, 6


def _llama_drain_args() -> list[str]:
    """The driver's flags of the drain drill: Llama-2 7B at full width, S =
    1,024, LoRA rank 16 on wq/wv, the global b = DRAIN_BATCH."""
    return ["--variant", "7b", "--seq-len", str(LLAMA_SEQ), "--batch-size",
            str(DRAIN_BATCH), "--lora-rank", str(LLAMA_RANK), "--lora-alpha", "16",
            "--lr", str(LLAMA_GANG_LR), "--steps", str(DRAIN_STEPS), "--log-every", "1",
            "--source-partitions", str(DRAIN_PARTITIONS)]


def _handoff_numbers(wd: Path) -> dict:
    """The drained rank 0's drain from its telemetry: the save's wall, and
    in it the pulls with their copies to the host, the hashing threads'
    busy seconds (every rank's own shard, the file's digest and the check
    of what arrived) and the writing thread's (both overlap the pulls); its
    rounds, peak bytes in flight and budget; and the handoff's bytes and
    ingest (the resume's record)."""
    rs = _reshards(_events(wd, "p0"))
    drain = next((r for r in rs if r.get("reason") == "preemption-drain"), {})
    resume = next((r for r in rs if r.get("reason") == "preemption-resume"), {})
    return dict(drain_s=drain.get("wall_s"), pull_s=drain.get("save_pull_s"),
                digest_s=drain.get("save_digest_s"), write_s=drain.get("save_write_s"),
                bytes_gathered=drain.get("bytes_moved"),
                leaves_gathered=drain.get("leaves_moved"), rounds=drain.get("rounds"),
                peak_inflight_bytes=drain.get("peak_inflight_bytes"),
                mem_budget_mb=drain.get("mem_budget_mb"),
                handoff_bytes=resume.get("bytes_moved"),
                handoff_leaves=resume.get("leaves_moved"), ingest_s=resume.get("wall_s"))


def train_llama_drain(torch, ranks: int) -> dict:
    """Config 5's graceful preemption drain at full width: Llama-2 7B LoRA
    through the port's driver at ``fsdp=ranks`` under the port's
    Supervisor with ``DLS_FAULT=sigterm@4`` (host 1), 8 steps at the global
    b = 12 over 12 source partitions. The gang drains at step 4: the live
    engine pulls every FSDP2 shard chunk by chunk to rank 0, which checks
    what arrived against each rank's own digests and writes the handoff,
    and the supervisor relaunches at ``ranks - 1``
    cards (fsdp=3: no dim of 7B divides by 3, so every leaf is whole on
    every card), which ingests it (digests checked on every rank) and runs
    steps 5–8 (:func:`_drain_checks`). Against an uninterrupted run at
    ``ranks`` on the same batches: every logged loss at GANG_LOSS_RTOL;
    K1/K2/K3 launched LLAMA_LAUNCHES a step on both sides of the drain.
    Beside it the same gang's hard loss: ``DLS_FAULT=die_host@6`` with a
    checkpoint every 4 steps, which walks back to step 4 at ``ranks - 1``.
    Prints the drain's gather, digest and write, the handoff's bytes,
    rounds and peak bytes in flight, the ingest, the relaunch to its first
    step and the steps lost, for both. Each run's workdir is removed after
    it is read (the handoff and a checkpoint are ~13.5 GB each)."""
    import shutil

    root = ROOT / "build" / f"chip_smoke_llama_drain_{ranks}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    args = _llama_drain_args()
    driver = _driver_script("llama_lora")
    straight = _driver_run("llama_lora", root / "straight", ranks, args)
    shutil.rmtree(root / "straight", ignore_errors=True)
    want = {i + 1: v for i, v in enumerate(straight["losses"].get("p0", []))}
    runs = {}
    for name, env, kw, every in (
            ("drain", {"DLS_FAULT": f"sigterm@{DRAIN_AT}"}, {"max_restarts": 1},
             DRAIN_STEPS),
            ("walk-back", {"DLS_FAULT": f"die_host@{DRAIN_DIE_AT}"},
             {"max_restarts": 2, "shrink_after": 1}, DRAIN_EVERY)):
        wd = root / name
        argv = [sys.executable, str(driver), *args, "--checkpoint-dir", str(wd / "ckpt"),
                "--checkpoint-every", str(every), "--resume"]
        run = _supervised_run(f"llama {name}", wd, argv, ranks, env, **kw)
        run["handoff"] = _handoff_numbers(wd) if name == "drain" else None
        run["checkpoint_ms"] = _phase_ms(_events(wd, "p0"), "checkpoint")
        shutil.rmtree(wd, ignore_errors=True)
        runs[name] = run
    drain, walk = runs["drain"], runs["walk-back"]
    sides = [x for x in drain["json_lines"] if "flash_launches" in x]
    before = next((x for x in sides if "preempted_at" in x), None)
    after = next((x for x in sides if "train" in x), None)

    def gap(got: dict) -> float:
        return max((abs(got[s] - want[s]) / abs(want[s]) for s in got if s in want),
                   default=float("nan"))

    rec = dict(
        ranks=ranks, global_batch=DRAIN_BATCH, seq_len=LLAMA_SEQ, lora_rank=LLAMA_RANK,
        steps=DRAIN_STEPS, drain_at=DRAIN_AT, die_at=DRAIN_DIE_AT,
        disk_free_gb=free_gb, straight_losses=want,
        straight_step_ms=straight["step_ms_by_rank"].get("p0"),
        drain=dict({k: v for k, v in drain.items() if k != "json_lines"},
                   loss_gap=gap(drain["losses"]), steps_lost=0,
                   launches_before=before and before["flash_launches"],
                   launches_after=after and after["flash_launches"],
                   mesh_after=after and after["mesh"],
                   cards_after=after and [{k: c[k] for k in (
                       "param_bytes", "param_bytes_reckoned", "max_memory_allocated")}
                       for c in after["by_rank"]]),
        walk_back=dict({k: v for k, v in walk.items() if k != "json_lines"},
                       loss_gap=gap(walk["losses"]),
                       steps_lost=DRAIN_DIE_AT - 1 - ((walk["geometry"] or [{}])[0]
                                                      .get("step") or 0)),
        card=nvidia_smi_line())
    print("gang llama drain " + json.dumps(rec), flush=True)
    check(not straight["left"], f"llama drain: the straight run left {straight['left']}")
    _drain_checks("llama drain", drain, ranks, DRAIN_AT)
    check(sorted(drain["losses"]) == list(range(1, DRAIN_STEPS + 1)) and len(want)
          == DRAIN_STEPS, f"llama drain logged {sorted(drain['losses'])}, the straight "
          f"run {sorted(want)}")
    check(rec["drain"]["loss_gap"] <= GANG_LOSS_RTOL,
          f"llama drain: losses {rec['drain']['loss_gap']} off the uninterrupted "
          f"run's: {drain['losses']} vs {want}")
    per_side = {k: v * DRAIN_AT for k, v in LLAMA_LAUNCHES.items()}
    check(before is not None and after is not None
          and before["flash_launches"] == per_side
          and all(c["flash_launches"] == per_side for c in after["by_rank"]),
          f"llama drain: K1-K3 launches before {before and before['flash_launches']}, "
          f"after {after and [c['flash_launches'] for c in after['by_rank']]}, "
          f"want {per_side} on each side")
    check(after["mesh"]["fsdp"] == ranks - 1 and after["world_size"] == ranks - 1,
          f"llama drain: the relaunch's mesh {after['mesh']}")
    h = drain["handoff"]
    check(h["peak_inflight_bytes"] is not None
          and h["peak_inflight_bytes"] <= h["mem_budget_mb"] * 2**20
          and h["handoff_bytes"] and h["bytes_gathered"],
          f"llama drain: the handoff {h}")
    check(not drain["left"], f"llama drain left {drain['left']}")
    check(walk["ok"] and [(a[1], a[3]) for a in walk["attempts"]]
          == [(ranks, "training-crash"), (ranks - 1, "clean")]
          and [g["resume"] for g in walk["geometry"]] == ["checkpoint"]
          and walk["geometry"][0]["step"] in (None, DRAIN_EVERY),
          f"llama walk-back: {walk['attempts']} {walk['geometry']}")
    check(sorted(walk["losses"]) == list(range(1, DRAIN_STEPS + 1))
          and rec["walk_back"]["loss_gap"] <= GANG_LOSS_RTOL,
          f"llama walk-back: losses {walk['losses']} vs {want}")
    check(not walk["left"], f"llama walk-back left {walk['left']}")
    return rec


# -- chip_smoke.py --gang: shrink to survive, and a planted desync ----------------

#: the supervised LeNet gang that loses host 1: steps, a global batch that
#: divides by 4 and by 3, source partitions that both rank counts divide (so
#: the global batches stay the same across the shrink), the checkpoint
#: interval, and the step before which host 1 dies
SHRINK_STEPS, SHRINK_BATCH, SHRINK_PARTITIONS = 40, 96, 12
SHRINK_EVERY, SHRINK_AT = 10, 25
#: the drill's learning rate: the losses stay near their start (~2.3), where
#: a relative gap measures the two runs' gradients. At the driver's 0.01
#: they fall to 7e-4 by step 40, and there the cards' TF32 convolutions
#: over 24 rows a rank (four ranks) against 32 (three) read 1.5e-2
#: relative, though the first step after the shrink matched at 1.3e-5 and
#: each later step drifted further (four H100 80GB HBM3 cards at 700 W)
SHRINK_LR = 1e-3
#: faults planted into the LeNet gang, as GANG_FAULTS into the drivers'
#: runs: each must be caught
SANITIZE_FAULTS = {
    "desync": "after step 2 rank 1's params move by 1e-3 (a replica that stopped "
              "being one): fit(sanitize_every=1) must raise DesyncError on every "
              "rank at step 3, its fingerprints all-gathered over NCCL",
}


def desync_rank(fault: str, out: str) -> int:
    """One rank of the planted desync (``chip_smoke.py --desync-rank FAULT
    OUT``, run by the port's cli): LeNet under ``fit(sanitize_every=1)``
    for 4 steps, FAULT planted after step 2; writes what it caught to
    ``OUT/desync-<rank>.json`` (the ranks share one stdout)."""
    import torch

    from distributeddeeplearningspark_tpu_torch.data import sources
    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer
    from distributeddeeplearningspark_tpu_torch.utils import sanitize

    check(fault in SANITIZE_FAULTS, f"no fault {fault!r}")
    spark = Session.builder.appName("lenet-desync").getOrCreate()
    ds = sources.synthetic_mnist(4096, num_partitions=spark.default_parallelism).repeat()
    trainer = Trainer(spark, LeNet5(device=spark.device), losses.softmax_xent,
                      optim.sgd(0.01, momentum=0.9))

    def plant(step, _metrics):
        if step == 2 and spark.rank == 1:
            with torch.no_grad():
                next(iter(trainer.state.params.values())).add_(1e-3)

    caught = None
    try:
        trainer.fit(ds, batch_size=LENET_BATCH, steps=4, log_every=1,
                    sanitize_every=1, callbacks=[plant])
    except sanitize.DesyncError as e:
        caught = dict(step=trainer.state.step, error=str(e)[:200])
    Path(out, f"desync-{spark.rank}.json").write_text(json.dumps(dict(
        rank=spark.rank, backend=spark.backend, world_size=spark.world_size,
        caught=caught)))
    spark.stop()
    return 0 if caught is not None and caught["step"] == 3 else 1


def gang_desync(torch, ranks: int) -> dict:
    """Each of SANITIZE_FAULTS planted into a LeNet gang at ``local[ranks]``:
    every rank must report the DesyncError at step 3."""
    import shutil

    out = {"card": nvidia_smi_line()}
    for fault in SANITIZE_FAULTS:
        workdir = ROOT / "build" / f"chip_smoke_desync_{fault}"
        shutil.rmtree(workdir, ignore_errors=True)
        _, timing = _launch(workdir, ranks, Path(__file__).resolve(),
                            ["--desync-rank", fault, str(workdir)])
        found = [json.loads(p.read_text()) for p in sorted(workdir.glob("desync-*.json"))]
        out[fault] = dict(ranks=found, launch=timing)
        check(len(found) == ranks and all(r["caught"] and r["caught"]["step"] == 3
                                          for r in found),
              f"planted {fault}: {found}")
    print("gang desync " + json.dumps(out), flush=True)
    return out


def gang_shrink(torch, ranks: int) -> dict:
    """The port's LeNet driver at ``ranks`` processes under the port's
    Supervisor with ``shrink_after=1`` and ``DLS_FAULT=die_host@25`` (host
    1): the gang relaunches at ``ranks - 1`` from the last checkpoint and
    records ``geometry_change``; its losses after the shrink against an
    uninterrupted run at ``ranks``, at GANG_LOSS_RTOL."""
    import shutil

    from distributeddeeplearningspark_tpu_torch.supervisor import Supervisor
    from distributeddeeplearningspark_tpu_torch.utils.env import conf_to_env

    script = ROOT / PKG / "examples" / "train_mnist.py"
    runs = {}
    for name, env, kw in (("straight", {}, {}),
                          ("shrunk", {"DLS_FAULT": f"die_host@{SHRINK_AT}"},
                           {"shrink_after": 1})):
        wd = ROOT / "build" / f"chip_smoke_shrink_{name}"
        shutil.rmtree(wd, ignore_errors=True)
        argv = [sys.executable, str(script), "--steps", str(SHRINK_STEPS),
                "--batch-size", str(SHRINK_BATCH),
                "--source-partitions", str(SHRINK_PARTITIONS), "--log-every", "1",
                "--lr", str(SHRINK_LR),
                "--checkpoint-dir", str(wd / "ckpt"),
                "--checkpoint-every", str(SHRINK_EVERY), "--resume"]
        t0 = time.time()
        result = Supervisor(argv, num_processes=ranks, max_restarts=2,
                            restart_backoff_s=0.1, env={**env, **conf_to_env(
                                {"spark.dls.deterministic": "true"})},
                            ckpt_dir=str(wd / "ckpt"), progress_path=str(wd / "ckpt"),
                            telemetry_dir=str(wd), **kw).run()
        records = _events(wd)
        begins = [r["ts"] for r in records if r["kind"] == "attempt"
                  and r.get("edge") == "begin"]
        last = [r for r in records if r["process"] == "p0"
                and r["kind"] == "step_metrics" and r["ts"] > begins[-1]]
        runs[name] = dict(
            attempts=[(a.ordinal, a.num_processes, a.returncodes, a.classification,
                       a.dead_host) for a in result.attempts],
            ok=result.ok, wall_s=time.time() - t0,
            losses={r["step"]: r["metrics"]["loss"] for r in last},
            geometry=[{k: r.get(k) for k in ("step", "dead_host", "from_processes",
                                             "to_processes", "hosts")}
                      for r in records if r["kind"] == "recovery"
                      and r.get("event") == "geometry_change"],
            left=_left_behind(script, set()))
    straight, shrunk = runs["straight"], runs["shrunk"]
    resumed = sorted(shrunk["losses"])
    pairs = [(shrunk["losses"][s], straight["losses"].get(s, float("nan")))
             for s in resumed]
    gap = max((abs(a - b) / abs(b) for a, b in pairs), default=None)
    rec = dict(ranks=ranks, runs=runs, resumed_steps=[resumed[0], resumed[-1]]
               if resumed else None, loss_gap=gap,
               first_step_gap=abs(pairs[0][0] - pairs[0][1]) / abs(pairs[0][1])
               if pairs else None, steps_lost=SHRINK_AT - 1 - (resumed[0] - 1
                                                               if resumed else 0),
               relaunch=_relaunch_timing(_events(ROOT / "build" / "chip_smoke_shrink_shrunk")),
               card=nvidia_smi_line())
    print("gang shrink " + json.dumps(rec), flush=True)
    check(straight["ok"] and len(straight["attempts"]) == 1,
          f"the uninterrupted run: {straight['attempts']}")
    check(shrunk["ok"] and [(a[1], a[3], a[4]) for a in shrunk["attempts"]]
          == [(ranks, "training-crash", 1), (ranks - 1, "clean", None)],
          f"the shrink drill's attempts: {shrunk['attempts']}")
    last_ckpt = (SHRINK_AT - 1) // SHRINK_EVERY * SHRINK_EVERY
    check(shrunk["geometry"] == [dict(step=last_ckpt, dead_host=1,
                                      from_processes=ranks, to_processes=ranks - 1,
                                      hosts=[h for h in range(ranks) if h != 1])],
          f"geometry_change records: {shrunk['geometry']}")
    check(resumed == list(range(last_ckpt + 1, SHRINK_STEPS + 1)),
          f"the shrunk gang logged steps {resumed}")
    check(bool(pairs) and bool(np.isfinite(pairs).all()),
          f"losses after the shrink against the uninterrupted run's: {pairs}")
    check(gap is not None and gap <= GANG_LOSS_RTOL,
          f"losses after the shrink are {gap} from the uninterrupted run's")
    check(not straight["left"] and not shrunk["left"],
          f"left behind: {straight['left']} {shrunk['left']}")
    return rec


def _relaunch_timing(records: list[dict]) -> dict:
    """Seconds from the end of a supervised run's first attempt (its kill,
    or its drain's exit) to the relaunch, to the relaunch's ``run`` phase
    and to its first step, and each rank's restore (checkpoint or handoff)
    in the relaunch, from the run's telemetry."""
    ends = [r for r in records if r["kind"] == "attempt" and r.get("edge") == "end"]
    begins = [r for r in records if r["kind"] == "attempt" and r.get("edge") == "begin"]
    if not ends or len(begins) < 2:
        return {}
    gone, back = ends[0]["ts"], begins[1]["ts"]
    runs = [r["ts"] for r in records if r["process"] == "p0" and r["kind"] == "phase"
            and r.get("name") == "run" and r.get("edge") == "begin" and r["ts"] > back]
    steps = [r["ts"] for r in records if r["process"] == "p0"
             and r["kind"] == "step_metrics" and r["ts"] > back]
    restores = [r["dur_s"] for r in records if r["kind"] == "phase"
                and r.get("name") == "restore" and r.get("edge") == "end"
                and r["ts"] > back]
    return dict(end_to_relaunch_s=back - gone,
                end_to_first_step_s=steps[0] - gone if steps else None,
                relaunch_to_first_step_s=steps[0] - back if steps else None,
                relaunch_to_run_s=runs[0] - back if runs else None,
                run_to_first_step_s=steps[0] - runs[0] if steps and runs else None,
                restore_s_by_rank=restores)


def _reshards(records: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k not in ("kind", "event")}
            for r in records if r["kind"] == "recovery" and r.get("event") == "reshard"]


def _drain_checks(name: str, run: dict, ranks: int, drain_at: int) -> None:
    """What every drain drill holds: one relaunch, classified
    ``graceful-shutdown`` with every rank exiting 0, a ``geometry_change``
    resuming from the live handoff at the drained step, both reshard
    events (the drain's over collectives on every rank, the resume's from
    the verified handoff on every survivor) and none walking back, and no
    step logged twice."""
    check(run["ok"] and [(a[1], a[2], a[3]) for a in run["attempts"]]
          == [(ranks, [0] * ranks, "graceful-shutdown"),
              (ranks - 1, [0] * (ranks - 1), "clean")],
          f"{name}: attempts {run['attempts']}")
    check([(g["step"], g["resume"], g["dead_host"], g["to_processes"])
           for g in run["geometry"]] == [(drain_at, "live-handoff", 1, ranks - 1)],
          f"{name}: geometry_change records {run['geometry']}")
    drains = [r for r in run["reshards"] if r.get("reason") == "preemption-drain"]
    resumes = [r for r in run["reshards"] if r.get("reason") == "preemption-resume"]
    check(len(drains) == ranks and all(r["transport"] == "collectives"
                                       and r["step"] == drain_at for r in drains)
          and len(resumes) == ranks - 1
          and all(r["transport"] == "handoff" and r["verified"] for r in resumes)
          and not any(r.get("walk_back") for r in run["reshards"]),
          f"{name}: reshard events {run['reshards']}")
    check(len(run["logged_steps"]) == len(set(run["logged_steps"])),
          f"{name}: a step was logged twice: {run['logged_steps']}")


def _supervised_run(name: str, wd: Path, argv: list[str], ranks: int, env: dict,
                    **kw) -> dict:
    """A supervised gang of ``argv`` at ``ranks`` (each worker's output in a
    file of the workdir, ``worker-<attempt>-<rank>.log``): its attempts,
    rank 0's losses by step, the steps it logged, its ``geometry_change``
    and ``reshard`` records, the relaunch's timing, rank 0's JSON lines
    and what of it outlived the run."""
    import shlex
    import shutil

    from distributeddeeplearningspark_tpu_torch.supervisor import Supervisor

    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    wrapped = ["bash", "-c", f"exec {shlex.join(argv)} > {shlex.quote(str(wd))}"
               f"/worker-$DLS_RESTART-$DLS_PROCESS_ID.log 2>&1"]
    t0 = time.time()
    result = Supervisor(wrapped, num_processes=ranks, restart_backoff_s=0.1,
                        env=env, ckpt_dir=str(wd / "ckpt"),
                        progress_path=str(wd / "ckpt"), telemetry_dir=str(wd),
                        **kw).run()
    wall_s = time.time() - t0
    records = _events(wd)
    steps = [r for r in records if r["process"] == "p0" and r["kind"] == "step_metrics"]
    lines = []
    for f in sorted(wd.glob("worker-*-0.log")):
        for x in f.read_text(errors="replace").splitlines():
            if x.startswith("{"):
                try:
                    lines.append(json.loads(x))
                except ValueError:
                    continue
    return dict(
        attempts=[(a.ordinal, a.num_processes, a.returncodes, a.classification,
                   a.dead_host) for a in result.attempts],
        ok=result.ok, wall_s=wall_s, losses={r["step"]: r["metrics"]["loss"] for r in steps},
        logged_steps=[r["step"] for r in steps],
        geometry=[{k: r.get(k) for k in ("step", "dead_host", "from_processes",
                                         "to_processes", "hosts", "resume")}
                  for r in records if r["kind"] == "recovery"
                  and r.get("event") == "geometry_change"],
        reshards=_reshards(records), relaunch=_relaunch_timing(records),
        json_lines=lines, left=_left_behind(Path(argv[1]), set()))


def gang_drain(torch, ranks: int, straight_losses: dict) -> dict:
    """The LeNet drain drill beside :func:`gang_shrink`: the same driver and
    batches at ``ranks`` under the port's Supervisor with
    ``DLS_FAULT=sigterm@25`` (host 1's preemption notice). The gang drains
    at step 25, hands its state off live and exits 0; the supervisor
    shrinks at once and the relaunch at ``ranks - 1`` resumes from the
    handoff at step 25 (:func:`_drain_checks`), its losses the
    uninterrupted run's (:func:`gang_shrink`'s) at GANG_LOSS_RTOL. Prints
    the drain's and the relaunch's timing beside the shrink's."""
    from distributeddeeplearningspark_tpu_torch.utils.env import conf_to_env

    wd = ROOT / "build" / "chip_smoke_drain_lenet"
    script = ROOT / PKG / "examples" / "train_mnist.py"
    argv = [sys.executable, str(script), "--steps", str(SHRINK_STEPS),
            "--batch-size", str(SHRINK_BATCH),
            "--source-partitions", str(SHRINK_PARTITIONS), "--log-every", "1",
            "--lr", str(SHRINK_LR), "--checkpoint-dir", str(wd / "ckpt"),
            "--checkpoint-every", str(SHRINK_EVERY), "--resume"]
    run = _supervised_run("lenet drain", wd, argv, ranks, {
        "DLS_FAULT": f"sigterm@{SHRINK_AT}",
        **conf_to_env({"spark.dls.deterministic": "true"})}, max_restarts=1)
    pairs = [(run["losses"][s], straight_losses.get(s, float("nan")))
             for s in sorted(run["losses"])]
    gap = max((abs(a - b) / abs(b) for a, b in pairs), default=None)
    rec = dict(ranks=ranks, drain_at=SHRINK_AT, steps_lost=0, loss_gap=gap, **run,
               card=nvidia_smi_line())
    rec.pop("json_lines")
    print("gang drain " + json.dumps(rec), flush=True)
    _drain_checks("lenet drain", run, ranks, SHRINK_AT)
    check(sorted(run["losses"]) == list(range(1, SHRINK_STEPS + 1)),
          f"lenet drain logged steps {sorted(run['losses'])}")
    check(gap is not None and np.isfinite(gap) and gap <= GANG_LOSS_RTOL,
          f"lenet drain: losses {gap} from the uninterrupted run's")
    check(not run["left"], f"lenet drain left {run['left']}")
    return rec


# -- chip_smoke.py --loop-ab: the unguarded loops of two trees ------------------

#: timed laps of each model in a tree's run (one warm lap before them), and
#: steps a lap
LOOP_AB_LAPS, LOOP_AB_STEPS = 5, {"lenet": 100, "dlrm": 10}


def loop_ms_tree(tree: str) -> int:
    """One tree's run of --loop-ab (``chip_smoke.py --loop-ms TREE``, with
    TREE's package first on the path): LeNet-5 (b=64, SGD with momentum,
    as examples/train_mnist.py) and the config-4 DLRM (b=8,192, AdamW and
    the sparse table through K5, as phase 10), each unguarded, the train
    loop's ms a step with its input ready (:func:`_loop_ms`) in laps; prints
    one ``loop ms {json}`` line with the kind of the optimizer's counts."""
    import torch

    import distributeddeeplearningspark_tpu_torch as pkg
    from distributeddeeplearningspark_tpu_torch.data import sources
    from distributeddeeplearningspark_tpu_torch.data.feed import device_batches
    from distributeddeeplearningspark_tpu_torch.models import dlrm
    from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    check(Path(pkg.__file__).resolve().parent.parent == Path(tree).resolve(),
          f"{PKG} imported from {pkg.__file__}, not from {tree}")
    spark = Session.builder.master("local[1]").appName("loop-ab").getOrCreate()
    def lenet():
        return (Trainer(spark, LeNet5(device=spark.device), losses.softmax_xent,
                        optim.sgd(0.01, momentum=0.9)),
                sources.synthetic_mnist(4096, num_partitions=1).repeat(), LENET_BATCH)

    def dlrm_run():
        model = dlrm.dlrm(DLRM_VOCABS, device="cuda", seed=0)
        return (Trainer(spark, model, losses.binary_xent,
                        optim.adamw(1e-3, weight_decay=0.0),
                        sparse_embed=dlrm.sparse_embed_specs(model, lr=1e-2)),
                sources.synthetic_criteo(2 * DLRM_BATCH, vocab_sizes=DLRM_VOCABS,
                                         num_partitions=1).repeat(), DLRM_BATCH)

    out = {"tree": tree, "card": nvidia_smi_line()}
    for name, make in (("lenet", lenet), ("dlrm", dlrm_run)):
        trainer, ds, batch_size = make()
        trainer.fit(ds, batch_size=batch_size, steps=2, log_every=2)
        batch = next(device_batches(ds, batch_size, trainer.device))
        laps = [_loop_ms(torch, trainer, batch, LOOP_AB_STEPS[name])
                for _ in range(LOOP_AB_LAPS + 1)][1:]
        counts = sorted({type(x).__name__ for x in
                         _tensors_and_ints(torch, trainer.state.opt_state)
                         if not isinstance(x, torch.Tensor) or x.dim() == 0})
        out[name] = dict(laps_ms=laps, counts=counts)
        del trainer
        torch.cuda.empty_cache()
    spark.stop()
    print("loop ms " + json.dumps(out), flush=True)
    return 0


def _tensors_and_ints(torch, tree) -> list:
    """The tensor and int leaves of a tree of tuples and lists."""
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors_and_ints(torch, v)]
    return [tree] if isinstance(tree, (torch.Tensor, int)) else []


def loop_ab_main(trees: list[str]) -> int:
    """``chip_smoke.py --loop-ab TREE [TREE ...]``: :func:`loop_ms_tree` in a
    process of its own for each TREE (a checkout's root) in the order given
    (for two trees: A, B, B, A), on one card; prints one ``loop ab {json}``
    line: each run's laps and each model's mean over every lap of a tree."""
    runs = []
    for tree in trees:
        root = Path(tree).resolve()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--loop-ms", str(root)], cwd=root, text=True,
                              capture_output=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("loop ms ")]
        if proc.returncode != 0 or not lines:
            print(f"chip_smoke: FAIL: --loop-ms {tree} exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]}", file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1][len("loop ms "):]))
    means = {tree: {m: float(np.mean([lap for r in runs if r["tree"] == str(Path(tree).resolve())
                                      for lap in r[m]["laps_ms"]]))
                    for m in LOOP_AB_STEPS} for tree in dict.fromkeys(trees)}
    print("loop ab " + json.dumps(dict(runs=runs, mean_ms=means,
                                       card=nvidia_smi_line())), flush=True)
    return 0


# -- chip_smoke.py --input-ab: the prefetch thread against the loop's thread ----

#: steps of each timed fit of the A/B, and its laps (the first is left out)
AB_STEPS = {"bert": (20, 4), "resnet": (12, 3), "dlrm": (12, 3)}
#: the interpreter's switch interval of the variants that cut it
AB_SWITCH_S = 1e-4


def _ab_fit(trainer, ds, batch_size: int, model: str, background: bool,
            switch_s: float | None) -> float:
    """Step ms of one fit whose feed is assembled in the prefetch thread
    (``background``) or in the loop's thread, at the given switch interval."""
    import functools

    from distributeddeeplearningspark_tpu_torch.data.prefetch import prefetch_to_device
    from distributeddeeplearningspark_tpu_torch.train import trainer as trainer_mod

    steps, log_every = AB_STEPS[model]
    interval = sys.getswitchinterval()
    trainer_mod.prefetch_to_device = functools.partial(prefetch_to_device,
                                                       background=background)
    if switch_s is not None:
        sys.setswitchinterval(switch_s)
    try:
        start = trainer.state.step if trainer.state is not None else 0
        _, summary = trainer.fit(ds, batch_size=batch_size, steps=start + steps,
                                 log_every=log_every)
    finally:
        trainer_mod.prefetch_to_device = prefetch_to_device
        sys.setswitchinterval(interval)
    return summary["step_time_ms"]


def _ab_model(name: str, trainer, datasets: dict, batch_size: int) -> dict:
    """Every variant of one model, in two rounds (the second in reverse
    order): {variant: [step ms of round 1, of round 2]}."""
    variants = [(ds_name, bg, sw) for ds_name in datasets
                for bg, sw in ((True, None), (False, None), (True, AB_SWITCH_S))]
    times: dict = {}
    for order in (variants, variants[::-1]):
        for ds_name, bg, sw in order:
            key = (f"{ds_name}, {'thread' if bg else 'loop'}"
                   + (f", switch {sw * 1e3:g} ms" if sw else ""))
            times.setdefault(key, []).append(
                _ab_fit(trainer, datasets[ds_name], batch_size, name, bg, sw))
    left = _input_leftovers()
    check(not left, f"{name}: the input path outlived the A/B: {left}")
    return times


def input_ab_main(torch) -> int:
    """``chip_smoke.py --input-ab``: where the prefetch thread helps and where
    the interpreter lock takes it back. BERT-base, ResNet-50 and the DLRM at
    full width, each trained through ``Trainer.fit`` with its batches
    assembled in the prefetch thread (the default) or in the loop's thread
    (``prefetch_to_device(background=False)``), with the thread at the
    interpreter's default switch interval and at 0.1 ms, over the feeds of
    the main script (with W workers and with none). Each variant runs twice,
    the order reversed in the second round; one card."""
    import gc

    from distributeddeeplearningspark_tpu_torch.data import sources, text, vision
    from distributeddeeplearningspark_tpu_torch.models import bert, dlrm, resnet
    from distributeddeeplearningspark_tpu_torch.ops import _build
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    _build.build_all()
    w = input_workers()
    spark = Session.builder.master("local[1]").appName("input-ab").getOrCreate()
    out = dict(workers=w, cpu_count=os.cpu_count(), switch_default_s=sys.getswitchinterval(),
               steps={k: v[0] for k, v in AB_STEPS.items()}, nvidia_smi=nvidia_smi_line())
    try:
        docs = text.synthetic_wikipedia(2048, num_partitions=1)
        tok = text.WordPieceTokenizer.train(docs.collect(), vocab_size=8192)
        trainer = Trainer(spark, bert.bert_base(device="cuda", seed=0), losses.masked_lm,
                          optim.with_grad_clip(optim.adamw(1e-4), 1.0))
        out["bert"] = _ab_model("bert", trainer, {
            f"{n} workers": text.mlm_dataset(docs, tok, seq_len=512, max_predictions=80,
                                             num_workers=n).repeat()
            for n in (w, 0)}, 32)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        src = sources.synthetic_images(4 * RESNET_BATCH, image_size=224,
                                       num_classes=1000, num_partitions=w)
        trainer = Trainer(spark, resnet.resnet50(num_classes=1000, fused_conv_bn=True,
                                                 device="cuda", seed=0),
                          losses.softmax_xent, optim.sgd(0.01, momentum=0.9))
        out["resnet"] = _ab_model("resnet", trainer, {
            f"{n} workers": vision.imagenet_train(src, size=224, repeat=True,
                                                  num_workers=n)
            for n in (w, 0)}, RESNET_BATCH)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        model = dlrm.dlrm(DLRM_VOCABS, device="cuda", seed=0)
        trainer = Trainer(spark, model, losses.binary_xent,
                          optim.adamw(1e-3, weight_decay=0.0),
                          sparse_embed=dlrm.sparse_embed_specs(model, lr=1e-2))
        out["dlrm"] = _ab_model("dlrm", trainer, {"no pool": sources.synthetic_criteo(
            4 * DLRM_BATCH, vocab_sizes=DLRM_VOCABS, num_partitions=4).repeat()},
            DLRM_BATCH)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        spark.stop()
    print("input ab " + json.dumps(out), flush=True)
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- chip_smoke.py --gang llama-mpmd: config 5 as an MPMD pipeline over four cards --------

#: the MPMD pipeline's stages (one card each) and microbatches
MPMD_STAGES, MPMD_MICRO = 4, 4
#: Llama-2 7B's widths (config 5) as DLS_PIPE_SPEC's ``cfg``: bf16 compute
#: and f32 params, LlamaConfig's defaults (the spec's own default is the
#: f32 tiny model of the CPU drills)
MPMD_7B = {"vocab_size": 32000, "hidden_size": 4096, "num_layers": LLAMA_LAYERS,
           "num_heads": LLAMA_HEADS, "num_kv_heads": LLAMA_KV_HEADS,
           "intermediate_size": 11008, "max_position": 4096, "dtype": "bfloat16"}
#: the 7B full fine-tune's AdamW lr: AdamW steps every param ~lr from its
#: first step; LLAMA_GANG_FULL_LR (1e-4) held at 2 layers, 32 layers take
#: a tenth of it so that the losses stay near their start
MPMD_LR = 1e-5
#: (c): the 7B widths cut to one layer a stage (1.07B params), trained with
#: plain SGD (no momentum): a param's change is then lr × its gradient, so
#: two runs' changes compare as their gradients do (AdamW's first steps move
#: every param ±lr by the gradient's sign alone, and a sign flip in a near-
#: zero gradient moves it 2·lr)
MPMD_SMALL_LAYERS, MPMD_SGD_LR = 4, 1e-2
#: (c): each param's change over the run against one card's, |Δ_mpmd −
#: Δ_one| / |Δ_one| per tensor (GANG_PARAM_RTOL's criterion): bf16
#: activations of 2-row microbatches against the whole batch of 8, worst in
#: the norm scales, whose gradients are sums that cancel (the planted
#: ``embed-backward-skipped`` reads 1.0 on the embedding)
MPMD_PARAM_RTOL = 0.1
#: (b): the 1F1B losses against (a)'s (per-microbatch losses and arrival-
#: order accumulation against the full batch's in GPipe order): 4.0e-5
#: measured at 7B, so well under GANG_LOSS_RTOL; its params are held in
#: (c)'s 1F1B run, under SGD against one card's
MPMD_1F1B_RTOL = 2e-4
#: the card's memory, and a stage's reckoned bytes: f32 params, gradients
#: and Adam's two moments, 16 B a param
CARD_BYTES, MPMD_BYTES_PER_PARAM = 80e9, 16
#: faults planted into (c)'s in-process run → (the limit it must break,
#: what it is): ``bitwise``, the params of a repeat of the clean run (which
#: a sound repeat meets); ``losses``, one card's at GANG_LOSS_RTOL;
#: ``params``, each param's change one card's at MPMD_PARAM_RTOL
MPMD_FAULTS = {
    "grad-forward-order": ("bitwise", "the last stage sending its GRAD frames in "
                                      "forward microbatch order: the gradients "
                                      "accumulate in another order than GPipe's"),
    "mask-weight-per-microbatch": ("losses", "the last stage dividing the full "
                                             "batch's loss by one microbatch's mask "
                                             "weight (losses M times one card's)"),
    "embed-backward-skipped": ("params", "stage 0 skipping the embedding's backward "
                                         "(the embedding never moves)"),
}


def _mpmd_spec(layers: int, mode: str = "exact", **kw) -> dict:
    """DLS_PIPE_SPEC of a config-5 MPMD run: ``layers`` of the 7B widths,
    b = 8, S = 1,024, M = 4, GANG_STEPS steps, seed 0."""
    return {"cfg": {**MPMD_7B, "num_layers": layers}, "steps": GANG_STEPS,
            "batch_size": LLAMA_BATCH, "seq": LLAMA_SEQ, "microbatches": MPMD_MICRO,
            "mode": mode, "seed": 0,
            "loss_mode": "full_batch" if mode == "exact" else "per_microbatch",
            "optimizer": {"name": "adamw", "lr": MPMD_LR}, **kw}


def _mpmd_reckoning(spec: dict, stage: int) -> dict:
    """What stage ``stage`` does each step: K1/K2/K3 launches (K1 in each
    of its layers' forward and remat recompute for each microbatch), the
    bf16 activation bytes it sends down and the gradient bytes it sends
    up, its params and the bytes of its f32 training state."""
    cfg = spec["cfg"]
    per = cfg["num_layers"] // MPMD_STAGES * MPMD_MICRO
    h, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    layer = 4 * h * h + 3 * h * f + 2 * h
    params = (cfg["num_layers"] // MPMD_STAGES * layer + (v * h if stage == 0 else 0)
              + (v * h + h if stage == MPMD_STAGES - 1 else 0))
    step_bytes = LLAMA_BATCH * LLAMA_SEQ * h * 2  # M microbatches of b/M rows
    return dict(launches={"flash_fwd": 2 * per, "flash_bwd_dq": per, "flash_bwd_dkv": per},
                act_bytes=step_bytes if stage < MPMD_STAGES - 1 else 0,
                grad_bytes=step_bytes if stage > 0 else 0,
                params=params, state_bytes=params * MPMD_BYTES_PER_PARAM)


def mpmd_ref_rank(argv: list[str]) -> int:
    """One rank of an MPMD gang's reference run (``chip_smoke.py
    --mpmd-ref-rank OUT SPEC PIPE [DATA]``, run by the port's cli): the
    port's ``Trainer`` on the spec's model (its init from the spec's seed),
    its optimizer and its batches (``synthetic_batch_fn``, in one partition:
    the same global batches, DATA shards of them), every param trainable; at
    PIPE > 1 the GPipe pipeline over ``pipe`` with the spec's microbatches.
    Each rank writes
    ``OUT/rank<r>.json`` (its stage, K1/K2/K3 launches, peak memory, its
    final params' digests); on one card also ``OUT/params.pt``, the final
    params."""
    import torch

    from distributeddeeplearningspark_tpu_torch import Session
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.train import losses
    from distributeddeeplearningspark_tpu_torch.train import pipeline_trainer as pt
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    out, spec, pipe = Path(argv[0]), json.loads(argv[1]), int(argv[2])
    data = int(argv[3]) if len(argv) > 3 else 1
    builder = Session.builder.appName(f"mpmd-ref-pipe{pipe}").config("mesh.data", data)
    if pipe > 1:
        builder = builder.config("mesh.pipe", pipe)
    spark = builder.getOrCreate()
    cfg = pt._tiny_cfg(spec)
    batch_fn = pt.synthetic_batch_fn(spec)
    rows = [{k: v[i] for k, v in batch_fn(s).items()}
            for s in range(spec["steps"]) for i in range(spec["batch_size"])]
    trainer = Trainer(spark, llama.LlamaForCausalLM(cfg, device="meta"), losses.causal_lm,
                      pt._optimizer(spec), rules=llama.llama_rules(cfg, pipeline=pipe > 1),
                      pipeline_microbatches=spec["microbatches"] if pipe > 1 else None,
                      seed=spec["seed"])
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(PartitionedDataset.parallelize(rows, 1), batch_size=spec["batch_size"],
                steps=spec["steps"], log_every=1)
    rec = dict(rank=spark.rank, stage=spark.mesh.pipe_index, mesh=spark.mesh.shape,
               flash_launches={k.__name__: k.launches for k in kernels},
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               param_digests=pt.param_digests(dict(trainer.model.named_parameters())))
    if pipe == 1:
        torch.save({n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
                   out / "params.pt")
    (out / f"rank{spark.rank}.json").write_text(json.dumps(rec))
    spark.stop()
    return 0


def _mpmd_ref_run(wd: Path, spec: dict, pipe: int, data: int = 1) -> dict:
    """A :func:`mpmd_ref_rank` launch at ``local[pipe · data]``: rank 0's
    logged losses and step ms (the laps after the first), every rank's
    record."""
    import shutil

    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    _, timing = _launch(wd, pipe * data, Path(__file__).resolve(),
                        ["--mpmd-ref-rank", str(wd), json.dumps(spec), str(pipe),
                         str(data)], timeout=900)
    steps = [r for r in _events(wd, "p0") if r["kind"] == "step_metrics"]
    laps = [r["lap_s"] * 1e3 / r["steps"] for r in steps]
    return dict(losses=[r["metrics"]["loss"] for r in steps],
                step_ms=float(np.mean(laps[1:])) if len(laps) > 1 else None,
                cards=[json.loads((wd / f"rank{r}.json").read_text())
                       for r in range(pipe * data)],
                launch=timing)


def _mpmd_supervised(wd: Path, spec: dict, env: dict | None = None, *,
                     stages: int = MPMD_STAGES, cards: int = 1) -> dict:
    """An MPMD run through ``PipelineSupervisor`` and the built-in stage
    worker, ``stages`` stages of ``cards`` cards each (stage k on cards
    k·n … k·n+n−1, ``CUDA_VISIBLE_DEVICES``), each process's output in
    ``wd/stage-<k>-<attempt>-r<rank>.log``: stage 0's DONE record, each
    stage's summaries by attempt, the restarts, the pipeline block of the
    port's ``status.report``, the telemetry and the wall seconds."""
    import shlex
    import shutil

    from distributeddeeplearningspark_tpu_torch import status, telemetry
    from distributeddeeplearningspark_tpu_torch.examples.train_llama_mpmd import _card_envs
    from distributeddeeplearningspark_tpu_torch.supervisor import (
        PipelineSupervisor,
        StagePlan,
    )

    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    worker = shlex.join([sys.executable, "-m", f"{PKG}.train.pipeline_trainer"])
    argv = ["bash", "-c", f"exec {worker} > {shlex.quote(str(wd))}"
            f"/stage-$DLS_STAGE_ID-$DLS_RESTART-r$DLS_PROCESS_ID.log 2>&1"]
    sup = PipelineSupervisor(
        [StagePlan(argv=argv, env=e) for e in _card_envs(stages, cards)],
        env={"DLS_PIPE_SPEC": json.dumps(spec), **(env or {})}, telemetry_dir=str(wd),
        max_restarts=2, restart_backoff_s=0.1, wall_timeout_s=900, hang_timeout_s=300)
    t0 = time.time()
    res = sup.run()
    wall_s = time.time() - t0
    logs = {p.name: p.read_text(errors="replace")[-1500:] for p in sorted(wd.glob("stage-*.log"))}
    check(res.ok, f"mpmd run {wd.name}: attempts "
          f"{ {k: [(a.returncodes, a.classification) for a in v] for k, v in res.attempts.items()} }"
          f", logs {logs}")
    done = json.loads((wd / "DONE").read_text())
    summaries = {k: [json.loads(p.read_text())
                     for p in sorted((wd / f"stage{k}").glob("summary-*.json"))]
                 for k in range(stages)}
    return dict(done=done, summaries=summaries, wall_s=wall_s,
                restarts={k: res.restarts_of(k) for k in range(stages)},
                attempts={k: [a.classification for a in v] for k, v in res.attempts.items()},
                pipeline=status.report(str(wd), traces=True)["pipeline"],
                events=telemetry.read_events(str(wd)))


def _mpmd_stage_table(run: dict, spec: dict) -> list[dict]:
    """Each stage's last summary beside its reckoning: step ms (the laps
    after the first), tokens/s a card, the transport's ms a microbatch
    (device → host, ``sendall``, host → device), launches, bytes sent and
    peak memory."""
    rows = []
    for k in range(MPMD_STAGES):
        s = run["summaries"][k][-1]
        st = s["stats"]
        frames = sum(st["sent"][kind][0] for kind in ("act", "grad"))
        sendall = sum(v[2] for side in st.get("links", {}).values()
                      for kind, v in side.items() if kind in ("act", "grad"))
        laps = st["lap_s"]
        step_ms = float(np.mean(laps[1:])) * 1e3 if len(laps) > 1 else None
        rows.append(dict(
            stage=k, attempt=s["attempt"], params=s["params"], step_ms=step_ms,
            tokens_per_sec_per_card=(LLAMA_BATCH * LLAMA_SEQ / MPMD_STAGES
                                     / (step_ms / 1e3)) if step_ms else None,
            d2h_ms_per_mb=st["d2h_s"] * 1e3 / frames if frames else None,
            send_ms_per_mb=sendall * 1e3 / frames if frames else None,
            h2d_ms_per_mb=st["h2d_s"] * 1e3 / st["transfers"] if st["transfers"] else None,
            flash_launches=s["flash_launches"], sent=st["sent"], steps=len(laps),
            max_memory_allocated=s.get("max_memory_allocated"),
            reckoned=_mpmd_reckoning(spec, k)))
    return rows


def _mpmd_digests(run: dict) -> dict[int, dict[str, str]]:
    """Each stage's final params' digests, from its last summary."""
    return {k: run["summaries"][k][-1]["param_digests"] for k in range(MPMD_STAGES)}


def _mpmd_checks(name: str, run: dict, spec: dict) -> list[dict]:
    """Each stage of a clean MPMD run: GANG_STEPS steps, K1/K2/K3 as
    reckoned a step, the activation and gradient bytes it sent as reckoned,
    its params the reckoning's and its peak memory below the card's."""
    table = _mpmd_stage_table(run, spec)
    check(run["done"]["step"] == GANG_STEPS and len(run["done"]["losses"]) == GANG_STEPS
          and all(np.isfinite(run["done"]["losses"])),
          f"mpmd {name}: DONE {run['done']}")
    for row in table:
        want = row["reckoned"]
        k = row["stage"]
        check(row["steps"] == GANG_STEPS and row["attempt"] == 0,
              f"mpmd {name} stage {k}: {row['steps']} steps at attempt {row['attempt']}")
        check(row["flash_launches"] == {n: c * GANG_STEPS
                                        for n, c in want["launches"].items()},
              f"mpmd {name} stage {k}: launches {row['flash_launches']}, want "
              f"{want['launches']} a step")
        check(row["sent"]["act"][1] == want["act_bytes"] * GANG_STEPS
              and row["sent"]["grad"][1] == want["grad_bytes"] * GANG_STEPS,
              f"mpmd {name} stage {k}: sent {row['sent']}, reckoned {want} a step")
        check(row["params"] == want["params"],
              f"mpmd {name} stage {k}: {row['params']} params, reckoned {want['params']}")
        check(row["max_memory_allocated"] < CARD_BYTES,
              f"mpmd {name} stage {k}: peak {row['max_memory_allocated']} B")
    return table


def _mpmd_threads(torch, spec: dict, fault: str = "none") -> dict:
    """An MPMD run in this process, one thread a stage, stage k on
    ``cuda:k``, over the socket transport, ``fault`` planted: stage 0's
    losses, every stage's final params (on the host) and the K1/K2/K3
    launches of all stages together."""
    import socket as socket_lib

    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearningspark_tpu_torch.parallel import mpmd
    from distributeddeeplearningspark_tpu_torch.train import pipeline_trainer as pt

    check(fault == "none" or fault in MPMD_FAULTS, f"no fault {fault!r}")
    saved = (pt.backward_order, pt.loss_denominator, pt.LlamaStageProgram.embed_backward)
    if fault == "grad-forward-order":
        pt.backward_order = lambda m: list(range(m))
    elif fault == "mask-weight-per-microbatch":
        pt.loss_denominator = lambda meta: max(float(meta["weight"]) / meta["m"], 1.0)
    elif fault == "embed-backward-skipped":
        def skipped(self, state, ids_dev, d_x_full):
            self._embed_out = None
        pt.LlamaStageProgram.embed_backward = skipped
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = 0
    ports = []
    for _ in range(MPMD_STAGES - 1):
        with socket_lib.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    key = os.urandom(16)
    cfg = pt._tiny_cfg(spec)
    results: dict = {}
    errors: dict = {}

    def run(k: int) -> None:
        try:
            prog = pt.LlamaStageProgram(cfg, k, MPMD_STAGES, pt._optimizer(spec),
                                        device=f"cuda:{k % torch.cuda.device_count()}",
                                        mode=spec["mode"],
                                        loss_mode=spec["loss_mode"])
            tr = mpmd.PipelineTransport(k, MPMD_STAGES, ports, key, pinned=True,
                                        connect_timeout=300)
            runner = pt.PipelineStageRunner(
                prog, tr, pt.StageRunConfig(steps=spec["steps"],
                                            batch_size=spec["batch_size"],
                                            microbatches=spec["microbatches"],
                                            seed=spec["seed"]),
                batch_fn=pt.synthetic_batch_fn(spec) if k == 0 else None)
            out = runner.run()
            results[k] = dict(losses=out["losses"], params={
                n: p.detach().cpu() for n, p in out["state"].params.items()})
        except BaseException as e:  # noqa: BLE001 — reported by the check below
            errors[k] = f"{type(e).__name__}: {e}"

    try:
        threads = [threading.Thread(target=run, args=(k,), name=f"mpmd-stage{k}")
                   for k in range(MPMD_STAGES)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
    finally:
        pt.backward_order, pt.loss_denominator, pt.LlamaStageProgram.embed_backward = saved
    check(not errors and len(results) == MPMD_STAGES,
          f"mpmd in-process run ({fault}): {errors}")
    torch.cuda.empty_cache()
    params = {n: p for k in range(MPMD_STAGES) for n, p in results[k]["params"].items()}
    return dict(losses=results[0]["losses"], params=params,
                digests={k: pt.param_digests(results[k]["params"])
                         for k in range(MPMD_STAGES)},
                launches={k.__name__: k.launches for k in kernels})


def _change_gap(torch, got: dict, want: dict, init: dict) -> dict:
    """Each param's change from ``init`` against ``want``'s, |Δ_got −
    Δ_want| / |Δ_want| per tensor: the worst and where."""
    check(sorted(got) == sorted(want), f"{sorted(got)} against {sorted(want)}")
    gaps = {}
    for n, w in want.items():
        w, g, i = (t.to("cuda:0", torch.float64) for t in (w, got[n], init[n]))
        ch = float((w - i).norm())
        gaps[n] = float((g - w).norm()) / ch if ch else float("inf")
    worst = max(gaps, key=gaps.get)
    return dict(worst=worst, rel=gaps[worst],
                embed=gaps.get("token_embed.weight"))


def _mpmd_drill_timing(run: dict) -> dict:
    """The kill drill's seconds: from the supervisor seeing stage 1 dead to
    its relaunch, and from the kill to stage 0's next step (the first step
    it logged after the kill)."""
    ev = run["events"]
    dead = [e["ts"] for e in ev if e.get("kind") == "attempt" and e.get("edge") == "end"
            and e.get("classification") == "stage-crash"]
    if not dead:
        return {}
    t = dead[0]
    relaunch = [e["ts"] for e in ev if e.get("kind") == "attempt" and e.get("edge") == "begin"
                and e.get("ts", 0) > t]
    nxt = [e for e in ev if e.get("kind") == "step_metrics" and e.get("process") == "p0"
           and e["ts"] > t]
    return dict(relaunch_s=relaunch[0] - t if relaunch else None,
                kill_to_next_step_s=nxt[0]["ts"] - t if nxt else None,
                next_step=nxt[0]["step"] if nxt else None)


# -- chip_smoke.py --gang llama-mpmd, (e)–(h): stages of two cards -------------

#: (e)–(h) and the driver: two stages of two cards each, one process a card
MPMD_GANG_STAGES, MPMD_GANG_CARDS = 2, 2
#: (e): the heterogeneous layouts, JAX's test_mpmd_heterogeneous_stage_meshes:
#: stage 0 FSDP2 over fsdp=2 (every param of 2**10 elements or more), stage
#: 1 the Megatron splits over tensor=2
MPMD_HETERO = {"stage_meshes": {"0": {"data": 1, "fsdp": 2},
                                "1": {"data": 1, "tensor": 2}},
               "stage_plans": {"0": "fsdp", "1": "tensor"}, "fsdp_min_size": 2**10}
#: (f): the 7B widths at 8 layers, exact, both stages at data=2 (a 16-layer
#: stage whole on one card does not fit with AdamW's state)
MPMD_EXACT_LAYERS = 8
#: (g) and (h): the 7B widths at 4 layers under SGD, in f32 compute, so that
#: a tensor-split stage's sums differ from a whole one's at f32 rounding only
#: (the bound is JAX's test_mpmd one, an f32 test's): the geometry change's
#: 4 losses against the uninterrupted run's
MPMD_GEOMETRY_LAYERS, MPMD_GEOMETRY_RTOL = 4, 1e-5


def _mpmd_gang_reckoning(spec: dict, stage: int) -> dict:
    """What each card of stage ``stage`` of a two-stage gang run does a
    step: K1/K2/K3 launches (every card runs its stage's layers on its
    rows, or on every row at tensor=2), the link bytes the stage sends down
    and up, the gang's bytes of each move (scatter and gather of the link's
    microbatches over row shards, broadcast to tensor peers), and the
    params each card holds."""
    cfg = spec["cfg"]
    stages, m = MPMD_GANG_STAGES, spec["microbatches"]
    per_stage = cfg["num_layers"] // stages
    h, v, f = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    dt = 4 if cfg.get("dtype") == "float32" else 2
    mesh = (spec.get("stage_meshes") or {}).get(str(stage)) or spec.get("mesh") or {}
    tensor = int(mesh.get("tensor", 1))
    rows_split = int(mesh.get("data", 1)) * int(mesh.get("fsdp", 1))
    step_bytes = spec["batch_size"] * spec["seq"] * h * dt
    first, last = stage == 0, stage == stages - 1
    norms = (2 * per_stage + (1 if last else 0)) * h
    split = (per_stage * (4 * h * h + 3 * h * f) + (v * h if first else 0)
             + (v * h if last else 0))
    if tensor > 1:
        card_params = split // tensor + norms
    elif mesh.get("fsdp", 1) > 1 and (spec.get("stage_plans") or {}).get(str(stage)) == "fsdp":
        # FSDP2 shards what the plan's fsdp_min_size reaches: a norm scale
        # of H elements at 4,096, not at a narrow model's widths
        fsdp = int(mesh["fsdp"])
        small = h < spec.get("fsdp_min_size", 2**10)
        card_params = split // fsdp + (norms if small else norms // fsdp)
    else:
        card_params = split + norms
    moves = {"broadcast": 0, "scatter": 0, "gather": 0}
    if tensor > 1:
        moves["broadcast"] = step_bytes if not first else 0  # activations in
    elif rows_split > 1:
        moves["scatter"] = step_bytes  # activations in, or gradients back
        moves["gather"] = step_bytes   # what the stage sends
    return dict(launches={"flash_fwd": 2 * per_stage * m, "flash_bwd_dq": per_stage * m,
                          "flash_bwd_dkv": per_stage * m},
                act_bytes=step_bytes if not last else 0,
                grad_bytes=step_bytes if not first else 0,
                moves=moves, moves_count=m, card_params=card_params,
                state_bytes=card_params * MPMD_BYTES_PER_PARAM)


def _mpmd_gang_table(run: dict, spec: dict) -> list[dict]:
    """Each stage's last summary and each of its cards against the
    reckoning: GANG_STEPS steps, K1/K2/K3 a step a card, the
    link's and the gang's bytes a step, params and peak memory a card; and
    each stage's ms a step, tokens/s a card, the transport's ms a
    microbatch and the gang's collective ms a move."""
    rows = []
    cards = MPMD_GANG_STAGES * MPMD_GANG_CARDS
    for k in range(MPMD_GANG_STAGES):
        s = run["summaries"][k][-1]
        st, want = s["stats"], _mpmd_gang_reckoning(spec, k)
        gang = st["gang"]
        moves = sum(gang[x][0] for x in ("broadcast", "scatter", "gather"))
        laps = st["lap_s"]
        step_ms = float(np.mean(laps[1:])) * 1e3 if len(laps) > 1 else None
        frames = sum(st["sent"][kind][0] for kind in ("act", "grad"))
        sendall = sum(v[2] for side in st.get("links", {}).values()
                      for kind, v in side.items() if kind in ("act", "grad"))
        row = dict(stage=k, mesh=s["mesh"], plan=s["plan"], mode=s["mode"],
                   attempt=s["attempt"], steps=len(laps), step_ms=step_ms,
                   tokens_per_sec_per_card=(spec["batch_size"] * spec["seq"] / cards
                                            / (step_ms / 1e3)) if step_ms else None,
                   d2h_ms_per_mb=st["d2h_s"] * 1e3 / frames if frames else None,
                   send_ms_per_mb=sendall * 1e3 / frames if frames else None,
                   h2d_ms_per_mb=st["h2d_s"] * 1e3 / st["transfers"] if st["transfers"] else None,
                   gang_ms_per_move=gang["collective_s"] * 1e3 / moves if moves else None,
                   gang=gang, sent=st["sent"], ranks=s["ranks"], layout=s["layout"],
                   reckoned=want)
        rows.append(row)
        check(row["steps"] == GANG_STEPS, f"mpmd gang stage {k}: {row['steps']} steps")
        check(st["sent"]["act"][1] == want["act_bytes"] * GANG_STEPS
              and st["sent"]["grad"][1] == want["grad_bytes"] * GANG_STEPS,
              f"mpmd gang stage {k}: link bytes {st['sent']}, reckoned {want} a step")
        for kind, nbytes in want["moves"].items():
            count = want["moves_count"] * GANG_STEPS if nbytes else 0
            check(gang[kind] == [count, nbytes * GANG_STEPS],
                  f"mpmd gang stage {k}: {kind} {gang[kind]}, reckoned "
                  f"{count} moves of {nbytes * GANG_STEPS} B")
        check(len(s["ranks"]) == MPMD_GANG_CARDS, f"mpmd gang stage {k}: ranks {s['ranks']}")
        for card in s["ranks"]:
            check(card["flash_launches"] == {n: c * GANG_STEPS
                                             for n, c in want["launches"].items()},
                  f"mpmd gang stage {k} rank {card['rank']}: launches "
                  f"{card['flash_launches']}, want {want['launches']} a step")
            check(card["params"] == want["card_params"],
                  f"mpmd gang stage {k} rank {card['rank']}: {card['params']} params, "
                  f"reckoned {want['card_params']}")
            check(card["max_memory_allocated"] < CARD_BYTES,
                  f"mpmd gang stage {k} rank {card['rank']}: peak "
                  f"{card['max_memory_allocated']} B")
    return rows


def _attempt_pids(run: dict) -> dict[int, list[list[int]]]:
    """Each stage's attempts' pids, from the supervisor's ``attempt`` events."""
    out: dict[int, list[list[int]]] = {}
    for e in run["events"]:
        if e.get("kind") == "attempt" and e.get("edge") == "begin":
            out.setdefault(e["stage"], []).append(e["pids"])
    return out


def _print_gang_table(name: str, table: list[dict]) -> None:
    for row in table:
        peaks = [c.get("max_memory_allocated", 0) / 1e9 for c in row["ranks"]]
        print(f"mpmd {name} stage {row['stage']} ({row['plan'] or row['mode']}, "
              f"mesh {dict((a, n) for a, n in row['mesh'].items() if n > 1)}): "
              f"{row['step_ms']:.1f} ms a step, {row['tokens_per_sec_per_card']:.0f} "
              f"tokens/s a card, transport ms a microbatch d2h {row['d2h_ms_per_mb']} "
              f"send {row['send_ms_per_mb']} h2d {row['h2d_ms_per_mb']}, gang collective "
              f"ms a move {row['gang_ms_per_move']}, peak GB a card {peaks} (reckoned "
              f"state {row['reckoned']['state_bytes'] / 1e9:.2f} GB)", flush=True)


def train_llama_mpmd_stages(torch, b_losses: list | None) -> dict:
    """Stages of two cards (``--gang llama-mpmd``, four cards): (e) config
    5's 7B full fine-tune over two stages, stage 0 FSDP2 at fsdp=2 and stage
    1 the Megatron splits at tensor=2, ``sharded`` 1F1B, against (b)'s
    losses (the one-card stages in 1F1B on the same weights and batches) at
    MPMD_1F1B_RTOL, the layouts FSDP2 and ``DTensor``; (f) ``exact`` at
    data=2 both stages, the 7B widths at MPMD_EXACT_LAYERS layers, against
    the port's GPipe ``Trainer`` at data=2 × pipe=2 in this call: per-step
    losses and final params bitwise; (g) MPMD_GEOMETRY_LAYERS layers under
    SGD in f32 compute, data=2 stages with a checkpoint every 2 steps, and
    stage 1 restarted at tensor=2 (``sharded``, the full-batch loss) from
    the step-2 checkpoints: the 4 losses at MPMD_GEOMETRY_RTOL; (h) the
    kill drill on (g)'s run (``die_host@5`` on rank 1 of stage 1): only
    stage 1's two processes relaunched, stage 0's pids unchanged, losses
    and final params bitwise; then the driver at its defaults (two stages
    of two cards). K1–K3 at a tensor=2 card's shape (16 heads, 2 rows)
    beside SDPA first. ``b_losses``: (b)'s, None to run (b) here."""
    import shutil
    import subprocess as sp

    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa

    root = ROOT / "build" / "chip_smoke_mpmd_stages"
    shape_k1 = check_flash_fwd(torch, fa, _llama_mpmd_cases(torch))
    shape_k23 = check_flash_bwd(torch, fa, _llama_mpmd_cases(torch))
    torch.cuda.empty_cache()
    if b_losses is None:
        run_b = _mpmd_supervised(root / "b-1f1b", _mpmd_spec(LLAMA_LAYERS, "sharded"))
        b_losses = run_b["done"]["losses"]
        shutil.rmtree(root / "b-1f1b", ignore_errors=True)
    theory = (MPMD_GANG_STAGES - 1) / (MPMD_MICRO + MPMD_GANG_STAGES - 1)
    gang = dict(stages=MPMD_GANG_STAGES, cards=MPMD_GANG_CARDS)

    # (e) the 7B, heterogeneous
    spec_e = _mpmd_spec(LLAMA_LAYERS, "sharded", **MPMD_HETERO)
    run_e = _mpmd_supervised(root / "e-hetero", spec_e, **gang)
    table_e = _mpmd_gang_table(run_e, spec_e)
    lay0, lay1 = table_e[0]["layout"], table_e[1]["layout"]
    # FSDP2 shards each stage-0 param of 2**10 elements or more on its
    # largest dim over fsdp; stage 1 holds DTensors over tensor alone
    first = f"layers.{LLAMA_LAYERS // MPMD_GANG_STAGES}"
    layouts_ok = (lay0["fsdp_modules"] > 0 and lay1["fsdp_modules"] == 0
                  and all(m == ["fsdp"] and len(pl) == 1 and pl[0].startswith("Shard(")
                          for m, pl in lay0["sharded"].values())
                  and {"token_embed.weight", "layers.0.mlp.gate.weight"} <= set(lay0["sharded"])
                  and all(m == ["tensor"] for m, _ in lay1["sharded"].values())
                  and lay1["sharded"].get("lm_head.weight") == [["tensor"], ["Shard(0)"]]
                  and lay1["sharded"].get(f"{first}.mlp.down.weight")
                  == [["tensor"], ["Shard(1)"]])
    e = dict(losses=run_e["done"]["losses"], b_losses=b_losses,
             max_loss_rel_err=_loss_gap(run_e["done"]["losses"], b_losses),
             layouts_ok=layouts_ok, sharded_params=(len(lay0["sharded"]), len(lay1["sharded"])),
             wall_s=run_e["wall_s"], bubble=run_e["pipeline"], stages=table_e)
    shutil.rmtree(root / "e-hetero", ignore_errors=True)

    # (f) exact at data=2 against the GPipe Trainer at data=2 × pipe=2
    spec_f = _mpmd_spec(MPMD_EXACT_LAYERS, mesh={"data": MPMD_GANG_CARDS})
    ref_f = _mpmd_ref_run(root / "f-gpipe", spec_f, MPMD_GANG_STAGES, MPMD_GANG_CARDS)
    run_f = _mpmd_supervised(root / "f-exact", spec_f, **gang)
    table_f = _mpmd_gang_table(run_f, spec_f)
    gpipe = {card["stage"]: card["param_digests"] for card in ref_f["cards"]}
    digests_f = {k: run_f["summaries"][k][-1]["param_digests"] for k in range(2)}
    f = dict(losses=run_f["done"]["losses"], gpipe_losses=ref_f["losses"],
             max_loss_rel_err=_loss_gap(run_f["done"]["losses"], ref_f["losses"]),
             bitwise=[np.float32(x).tobytes() for x in run_f["done"]["losses"]]
             == [np.float32(x).tobytes() for x in ref_f["losses"]],
             params_bitwise=all(bool(digests_f[k]) and all(
                 gpipe.get(k, {}).get(n) == d for n, d in digests_f[k].items())
                 for k in range(2)),
             params_differing=sorted(n for k in range(2) for n, d in digests_f[k].items()
                                     if gpipe.get(k, {}).get(n) != d),
             gpipe_step_ms=ref_f["step_ms"], gpipe_cards=ref_f["cards"],
             wall_s=run_f["wall_s"], bubble=run_f["pipeline"], stages=table_f)
    shutil.rmtree(root / "f-gpipe", ignore_errors=True)
    shutil.rmtree(root / "f-exact", ignore_errors=True)

    # (g) the geometry change on restore, from (g)'s clean run's step 2
    sgd = {"name": "sgd", "lr": MPMD_SGD_LR}
    f32 = {**MPMD_7B, "num_layers": MPMD_GEOMETRY_LAYERS, "dtype": "float32"}
    spec_g = _mpmd_spec(MPMD_GEOMETRY_LAYERS, optimizer=sgd, checkpoint_every=2,
                        mesh={"data": MPMD_GANG_CARDS}, cfg=f32)
    clean = _mpmd_supervised(root / "g-clean", spec_g, **gang)
    moved = root / "g-moved"
    shutil.rmtree(moved, ignore_errors=True)
    for k in range(2):
        shutil.copytree(root / "g-clean" / f"stage{k}" / "ckpt" / "2",
                        moved / f"stage{k}" / "ckpt" / "2", copy_function=os.link)
    spec_moved = {**spec_g, "steps": 4, "mode": "sharded", "loss_mode": "full_batch",
                  "stage_meshes": {"1": {"data": 1, "tensor": MPMD_GANG_CARDS}},
                  "stage_plans": {"1": "tensor"}}
    run_g = _mpmd_supervised(moved, spec_moved, **gang)
    want_g = clean["done"]["losses"][:4]
    got_g = run_g["done"]["losses"]
    g = dict(losses=got_g, uninterrupted=want_g,
             max_loss_rel_err=max(abs(a - b) / abs(b) for a, b in zip(got_g, want_g))
             if len(got_g) == len(want_g) == 4 else None,
             stage1=dict(mesh=run_g["summaries"][1][-1]["mesh"],
                         plan=run_g["summaries"][1][-1]["plan"],
                         sharded=len(run_g["summaries"][1][-1]["layout"]["sharded"])),
             wall_s=run_g["wall_s"])
    shutil.rmtree(moved, ignore_errors=True)

    # (h) the kill drill on a gang, against (g)'s clean run
    run_h = _mpmd_supervised(root / "h-drill", spec_g, {
        "DLS_FAULT": "die_host@5", "DLS_FAULT_HOST": "1", "DLS_FAULT_RANK": "1",
        "DLS_FAULT_ONCE": "1"}, **gang)
    pids = _attempt_pids(run_h)
    h = dict(losses=run_h["done"]["losses"], restarts=run_h["restarts"],
             attempts=run_h["attempts"], pids=pids,
             stage0_pids_kept=[c["pid"] for c in run_h["summaries"][0][-1]["ranks"]]
             == (pids.get(0) or [[]])[0] and len(pids.get(0, [])) == 1,
             stage1_relaunched=len(pids.get(1, [])) == 2
             and not set(pids[1][0]) & set(pids[1][1])
             and len(pids[1][1]) == MPMD_GANG_CARDS,
             bitwise=run_h["done"]["losses"] == clean["done"]["losses"],
             params_bitwise=all(run_h["summaries"][k][-1]["param_digests"]
                                == clean["summaries"][k][-1]["param_digests"]
                                for k in range(2)),
             timing=_mpmd_drill_timing(run_h), wall_s=run_h["wall_s"],
             recoveries=[(ev.get("event"), ev.get("stage")) for ev in run_h["events"]
                         if ev.get("kind") == "recovery"])
    shutil.rmtree(root / "g-clean", ignore_errors=True)
    shutil.rmtree(root / "h-drill", ignore_errors=True)

    # the driver at its defaults: two stages of two cards
    drv_wd = root / "driver"
    shutil.rmtree(drv_wd, ignore_errors=True)
    t0 = time.time()
    drv = sp.run([sys.executable, "-m", f"{PKG}.examples.train_llama_mpmd", "--workdir",
                  str(drv_wd)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    drv_s = time.time() - t0
    drv_lines = [x for x in drv.stdout.splitlines() if x.startswith("{")]
    check(drv.returncode == 0 and len(drv_lines) == 1,
          f"mpmd driver exited {drv.returncode}: {drv.stdout[-1500:]} {drv.stderr[-1500:]}")
    driver = json.loads(drv_lines[0])

    rec = dict(theoretical_bubble=theory, e=e, f=f, g=g, h=h,
               driver=dict(extra=driver["extra"], value=driver["value"], wall_s=drv_s),
               k1_tp2=shape_k1, k23_tp2=shape_k23,
               card=nvidia_smi_line(), torch_version=torch.__version__)
    print("gang llama-mpmd stages " + json.dumps(rec, default=str), flush=True)
    _print_gang_table("e", table_e)
    _print_gang_table("f", table_f)
    for kr in shape_k1 + shape_k23:
        print(f"mpmd tp2 shape {kr.get('case')}: ms {kr.get('ms')} plain "
              f"{kr.get('plain_ms')} SDPA {kr.get('library_ms')} bound {kr.get('bound_ms')}",
              flush=True)
    print(f"mpmd gang bubble: e {run_e['pipeline'].get('measured_bubble_frac')} f "
          f"{run_f['pipeline'].get('measured_bubble_frac')} theory {theory:.4f}; drill "
          f"{h['timing']}", flush=True)
    check(e["max_loss_rel_err"] <= MPMD_1F1B_RTOL,
          f"mpmd e: losses {e['losses']} off (b)'s {b_losses}")
    check(layouts_ok, f"mpmd e: the layouts are not FSDP2 | DTensor: {lay0} {lay1}")
    check(f["bitwise"] and f["params_bitwise"],
          f"mpmd f: losses {f['losses']} (or final params {f['params_differing']}) not "
          f"bitwise the GPipe Trainer's {f['gpipe_losses']}")
    check(g["max_loss_rel_err"] is not None and g["max_loss_rel_err"] <= MPMD_GEOMETRY_RTOL
          and g["stage1"]["mesh"]["tensor"] == MPMD_GANG_CARDS and g["stage1"]["sharded"] > 0,
          f"mpmd g: losses {g['losses']} against {g['uninterrupted']}, stage 1 {g['stage1']}")
    check(h["restarts"] == {0: 0, 1: 1} and h["stage0_pids_kept"] and h["stage1_relaunched"],
          f"mpmd h: restarts {h['restarts']}, pids {h['pids']}")
    check(("stage-restart", 1) in h["recoveries"] and ("pipeline-resync", 0) in h["recoveries"],
          f"mpmd h: recoveries {h['recoveries']}")
    check(h["bitwise"] and h["params_bitwise"],
          f"mpmd h: losses (or final params) not bitwise the clean run's: {h}")
    check(driver["extra"]["ok"] and driver["extra"]["final_step"] == 8
          and driver["extra"]["devices_per_stage"] == MPMD_GANG_CARDS
          and all(v == 0 for v in driver["extra"]["restarts_per_stage"].values()),
          f"mpmd driver: {driver}")
    return rec


def train_llama_mpmd_gang(torch, ranks: int) -> dict:
    """Config 5 as an MPMD pipeline of MPMD_STAGES one-card stages
    (``--gang llama-mpmd``, four cards): (a) the 7B full fine-tune (every
    param trainable, AdamW MPMD_LR, b = 8, S = 1,024, M = 4, GANG_STEPS
    steps, ``exact``) through ``PipelineSupervisor`` and the built-in stage
    worker, against the port's GPipe ``Trainer`` at pipe=4 on the same
    weights and batches; (b) the same in ``sharded``/1F1B, against (a);
    (c) the 7B widths at MPMD_SMALL_LAYERS layers under SGD, in this
    process (a thread a stage), against one card's ``Trainer``: losses and
    each param's change, and a repeat bitwise; the same in 1F1B; the
    planted MPMD_FAULTS at (c)'s size; (d) the kill drill at (c)'s size (``die_host@5`` on stage
    1, a checkpoint every 2 steps), then (e)–(h) and the driver
    ``examples/train_llama_mpmd.py`` at its defaults, two stages of two cards
    (:func:`train_llama_mpmd_stages`). Held: (a)'s losses
    and final params bitwise the GPipe ``Trainer``'s, (b)'s losses at
    MPMD_1F1B_RTOL, (c)'s at GANG_LOSS_RTOL and its params' changes at
    MPMD_PARAM_RTOL in both modes, (d)'s losses and final params bitwise
    (c)'s, K1/K2/K3 and each link's bytes as reckoned a step a
    stage, peak memory below the card's, only the killed stage restarting,
    each fault breaking a limit. Prints each stage's ms a step, tokens/s a
    card, the transport's ms a microbatch, the measured bubble against
    (P − 1)/(M + P − 1) and the drill's seconds."""
    check(ranks >= MPMD_STAGES, f"mpmd: {ranks} cards, the pipeline takes {MPMD_STAGES}")
    root = ROOT / "build" / "chip_smoke_mpmd"
    spec_a = _mpmd_spec(LLAMA_LAYERS)
    ref_a = _mpmd_ref_run(root / "gpipe-pipe4", spec_a, MPMD_STAGES)
    run_a = _mpmd_supervised(root / "a-exact", spec_a)
    table_a = _mpmd_checks("a", run_a, spec_a)
    spec_b = _mpmd_spec(LLAMA_LAYERS, "sharded")
    run_b = _mpmd_supervised(root / "b-1f1b", spec_b)
    table_b = _mpmd_checks("b", run_b, spec_b)

    sgd = {"name": "sgd", "lr": MPMD_SGD_LR}
    spec_c = _mpmd_spec(MPMD_SMALL_LAYERS, optimizer=sgd)
    ref_c = _mpmd_ref_run(root / "c-one-card", spec_c, 1)
    one_params = torch.load(root / "c-one-card" / "params.pt", weights_only=True)
    (root / "c-one-card" / "params.pt").unlink()
    from distributeddeeplearningspark_tpu_torch.models import llama
    from distributeddeeplearningspark_tpu_torch.train import pipeline_trainer as pt

    init_model = llama.LlamaForCausalLM(pt._tiny_cfg(spec_c), device="meta")
    init_model.to_empty(device="cuda:0")
    init_model.init_weights(torch.Generator("cuda:0").manual_seed(spec_c["seed"]))
    init = {n: p.detach().cpu() for n, p in init_model.named_parameters()}
    del init_model
    torch.cuda.empty_cache()
    run_c = _mpmd_threads(torch, spec_c)
    repeat_c = _mpmd_threads(torch, spec_c)
    run_c1 = _mpmd_threads(torch, {**spec_c, "mode": "sharded",
                                   "loss_mode": "per_microbatch"})
    faults = {f: _mpmd_threads(torch, spec_c, f) for f in MPMD_FAULTS}

    def bitwise(a: dict, b: dict) -> bool:
        return sorted(a) == sorted(b) and all(torch.equal(a[n], b[n]) for n in a)

    c = dict(losses=run_c["losses"], one_card_losses=ref_c["losses"],
             max_loss_rel_err=_loss_gap(run_c["losses"], ref_c["losses"]),
             change=_change_gap(torch, run_c["params"], one_params, init),
             repeat_bitwise=bitwise(run_c["params"], repeat_c["params"])
             and run_c["losses"] == repeat_c["losses"],
             launches=run_c["launches"],
             sharded=dict(losses=run_c1["losses"],
                          max_loss_rel_err=_loss_gap(run_c1["losses"], ref_c["losses"]),
                          change=_change_gap(torch, run_c1["params"], one_params, init)))
    fault_rec = {f: dict(losses=r["losses"],
                         max_loss_rel_err=_loss_gap(r["losses"], ref_c["losses"]),
                         change=_change_gap(torch, r["params"], one_params, init),
                         bitwise_clean=bitwise(r["params"], run_c["params"]))
                 for f, r in faults.items()}
    del faults, repeat_c, run_c1

    spec_d = _mpmd_spec(MPMD_SMALL_LAYERS, optimizer=sgd, checkpoint_every=2)
    run_d = _mpmd_supervised(root / "d-drill", spec_d, {
        "DLS_FAULT": "die_host@5", "DLS_FAULT_HOST": "1", "DLS_FAULT_ONCE": "1"})
    import shutil

    for k in range(MPMD_STAGES):  # checkpoints of 1-3 GB a stage
        shutil.rmtree(root / "d-drill" / f"stage{k}" / "ckpt", ignore_errors=True)

    theory = (MPMD_STAGES - 1) / (MPMD_MICRO + MPMD_STAGES - 1)
    gpipe_digests = {card["stage"]: card["param_digests"] for card in ref_a["cards"]}
    digests_a = _mpmd_digests(run_a)
    rec = dict(
        stages=MPMD_STAGES, microbatches=MPMD_MICRO, global_batch=LLAMA_BATCH,
        seq_len=LLAMA_SEQ, lr=MPMD_LR, theoretical_bubble=theory,
        a=dict(losses=run_a["done"]["losses"], gpipe_losses=ref_a["losses"],
               max_loss_rel_err=_loss_gap(run_a["done"]["losses"], ref_a["losses"]),
               bitwise_gpipe=[np.float32(x).tobytes() for x in run_a["done"]["losses"]]
               == [np.float32(x).tobytes() for x in ref_a["losses"]],
               params_bitwise_gpipe=all(
                   bool(digests_a[k]) and all(gpipe_digests.get(k, {}).get(n) == d
                                              for n, d in digests_a[k].items())
                   for k in range(MPMD_STAGES)),
               gpipe_step_ms=ref_a["step_ms"], gpipe_cards=ref_a["cards"],
               wall_s=run_a["wall_s"], bubble=run_a["pipeline"], stages=table_a),
        b=dict(losses=run_b["done"]["losses"],
               max_loss_rel_err=_loss_gap(run_b["done"]["losses"], run_a["done"]["losses"]),
               wall_s=run_b["wall_s"], bubble=run_b["pipeline"], stages=table_b),
        c=c, one_card_step_ms=ref_c["step_ms"], faults=fault_rec,
        d=dict(losses=run_d["done"]["losses"], restarts=run_d["restarts"],
               attempts=run_d["attempts"],
               max_loss_rel_err=_loss_gap(run_d["done"]["losses"], run_c["losses"]),
               bitwise_c=run_d["done"]["losses"] == run_c["losses"],
               params_bitwise_c=_mpmd_digests(run_d) == run_c["digests"],
               timing=_mpmd_drill_timing(run_d), wall_s=run_d["wall_s"],
               recoveries=[(e.get("event"), e.get("stage")) for e in run_d["events"]
                           if e.get("kind") == "recovery"]),
        card=nvidia_smi_line(), torch_version=torch.__version__)
    print("gang llama-mpmd " + json.dumps(rec, default=str), flush=True)
    for row in table_a:
        print(f"mpmd a stage {row['stage']}: {row['step_ms']:.1f} ms a step, "
              f"{row['tokens_per_sec_per_card']:.0f} tokens/s a card, transport ms a "
              f"microbatch d2h {row['d2h_ms_per_mb']} send {row['send_ms_per_mb']} "
              f"h2d {row['h2d_ms_per_mb']}, peak {row['max_memory_allocated'] / 1e9:.2f} GB "
              f"(reckoned state {row['reckoned']['state_bytes'] / 1e9:.2f} GB)", flush=True)
    print(f"mpmd bubble: a {run_a['pipeline'].get('measured_bubble_frac')} b "
          f"{run_b['pipeline'].get('measured_bubble_frac')} theory {theory:.4f}; drill "
          f"{rec['d']['timing']}", flush=True)
    check(rec["a"]["bitwise_gpipe"] and rec["a"]["params_bitwise_gpipe"],
          f"mpmd a: losses {rec['a']['losses']} (or final params) not bitwise the "
          f"GPipe Trainer's {rec['a']['gpipe_losses']}")
    check(rec["b"]["max_loss_rel_err"] <= MPMD_1F1B_RTOL,
          f"mpmd b (1F1B): losses {rec['b']['losses']} off (a)'s")
    for mode, seen in (("exact", c), ("1F1B", c["sharded"])):
        check(seen["max_loss_rel_err"] <= GANG_LOSS_RTOL
              and seen["change"]["rel"] <= MPMD_PARAM_RTOL,
              f"mpmd c ({mode}): off one card's: {seen}")
    check(c["repeat_bitwise"], "mpmd c: a repeat of the clean run is not bitwise the same")
    for f, seen in fault_rec.items():
        limit, why = MPMD_FAULTS[f]
        broke = {"bitwise": not seen["bitwise_clean"],
                 "losses": seen["max_loss_rel_err"] > GANG_LOSS_RTOL,
                 "params": seen["change"]["rel"] > MPMD_PARAM_RTOL}
        check(broke[limit], f"mpmd: the planted fault {f!r} ({why}) keeps its limit "
                            f"({limit}): {seen}")
    d = rec["d"]
    check(d["restarts"] == {k: int(k == 1) for k in range(MPMD_STAGES)},
          f"mpmd d: restarts {d['restarts']}, only stage 1 should restart")
    check(("stage-restart", 1) in d["recoveries"] and ("pipeline-resync", 0) in d["recoveries"],
          f"mpmd d: recoveries {d['recoveries']}")
    check(d["bitwise_c"] and d["params_bitwise_c"],
          f"mpmd d: losses (or final params) not bitwise (c)'s: {d}")
    rec["stages_of_two_cards"] = train_llama_mpmd_stages(torch, run_b["done"]["losses"])
    return rec


def gang_main(torch, names: list[str]) -> int:
    """``chip_smoke.py --gang [resnet|dlrm|recovery|llama|llama-cp|llama-drain|
    llama-moe|llama-pp|llama-mpmd ...]``: at one rank per visible card (2 or
    more), NCCL between them, the LeNet phase, the supervised shrink, the
    drain and the planted desync, the ResNet-50 and DLRM drivers
    (:func:`train_drivers_gang`), then Llama-2 7B LoRA sharded over the
    cards (:func:`train_llama_gang`, :func:`train_llama_cp_gang`), drained
    for a preemption (:func:`train_llama_drain`), the MoE Llamas over the
    ``expert`` axis (:func:`train_llama_moe_gang`), config 5 pipelined
    over the ``pipe`` axis (:func:`train_llama_pp_gang`, four cards) and as
    an MPMD pipeline of one-card stages (:func:`train_llama_mpmd_gang`,
    four cards); with names, only those parts."""
    ranks = torch.cuda.device_count()
    if ranks < 2:
        print(f"chip_smoke --gang: {ranks} card(s); it needs 2 or more",
              file=sys.stderr)
        return 2
    parts = ["llama", "llama-cp", "llama-drain", "llama-moe", "llama-mpmd",
             "llama-mpmd-stages", "llama-pp", "llama-pp-steps", "recovery"]
    if not set(names) <= set(GANG_FAULTS) | set(parts):
        print(f"chip_smoke --gang: no part {names}; choose from "
              f"{sorted(GANG_FAULTS) + parts}", file=sys.stderr)
        return 2
    try:
        if not names:
            train_lenet(torch, ranks)
        if not names or "recovery" in names:
            shrink = gang_shrink(torch, ranks)
            gang_drain(torch, ranks, shrink["runs"]["straight"]["losses"])
            gang_desync(torch, ranks)
        drivers = tuple(n for n in names if n in GANG_FAULTS)
        if drivers or not names:
            train_drivers_gang(torch, ranks, drivers or tuple(GANG_FAULTS))
        if not names or "llama" in names:
            train_llama_gang(torch, ranks)
        if not names or "llama-cp" in names:
            train_llama_cp_gang(torch, ranks)
        if not names or "llama-drain" in names:
            train_llama_drain(torch, ranks)
        if not names or "llama-moe" in names:
            train_llama_moe_gang(torch, ranks)
        if not names or "llama-pp" in names:
            train_llama_pp_gang(torch, ranks)
        if "llama-pp-steps" in names:  # the layouts' steps only, no faults
            train_llama_pp_gang(torch, ranks, faults=False)
        if not names or "llama-mpmd" in names:
            train_llama_mpmd_gang(torch, ranks)
        if "llama-mpmd-stages" in names:  # (e)-(h) and the driver only
            train_llama_mpmd_stages(torch, None)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(out.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ranks}}))
    return 0


# -- phase 6: serving BERT-base -----------------------------------------------


def serve_bert(torch, fa, bert, engine_mod) -> dict:
    n_req, n_clients, seq = 64, 8, 512
    t0 = time.perf_counter()
    model = bert.bert_base(device="cuda", seed=0)
    cfg = model.cfg
    check(cfg.num_layers == 12 and cfg.hidden_size == 768
          and cfg.vocab_size == 30522 and cfg.max_position == seq,
          "bert_base is not at BERT-base width")
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(n_req):
        am = np.zeros(seq, np.int32)
        am[:int(rng.integers(1, seq + 1))] = 1
        reqs.append({"input_ids": rng.integers(0, cfg.vocab_size, seq
                                               ).astype(np.int32),
                     "attention_mask": am})
    # the first served batch's layer-0 attention: inputs and output
    captured: dict = {}

    def capture(module, args, out):
        if "out" not in captured:
            captured.update(x=args[0].clone(), mask=args[1].clone(),
                            out=out.clone())

    workdir = ROOT / "build" / "chip_smoke_telemetry"
    eng = engine_mod.InferenceEngine.for_model(
        model, max_batch=32, max_wait_ms=5.0, workdir=str(workdir),
        name="bert-base")
    eng.start()
    try:
        eng.warmup(reqs[0])
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        before = eng.stats()
        results: list = [None] * n_req
        lat = [0.0] * n_req
        errors: list[BaseException] = []

        def client(idx):
            try:
                futs = [(i, time.perf_counter(), eng.submit(reqs[i])) for i in idx]
                for i, ts, f in futs:
                    results[i] = f.result(600)
                    lat[i] = time.perf_counter() - ts
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client,
                                    args=(range(c, n_req, n_clients),))
                   for c in range(n_clients)]
        hook = model.encoder.layers[0].attention.register_forward_hook(capture)
        fa.flash_fwd.launches = 0  # the main path's run starts here
        t_run = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t_run
        launches = fa.flash_fwd.launches
        after = eng.stats()
        hook.remove()
    finally:
        eng.stop()
    check(not errors, f"client error: {errors[:1]}")
    check(all(r is not None for r in results), "a request got no result")
    batches = after["batches"] - before["batches"]

    check("out" in captured, "no served batch reached layer 0")
    # every served row against a one-request forward through the plain path,
    # and the served layer-0 attention against it on the same inputs
    max_err = ref_max = 0.0
    cfg.attention_impl = "xla"
    try:
        with torch.inference_mode():
            attn_ref = model.encoder.layers[0].attention(
                captured["x"], captured["mask"]).float()
            attn_err = float((captured["out"].float() - attn_ref).abs().max())
            attn_max = float(attn_ref.abs().max())
            for req, got in zip(reqs, results):
                check(got.shape == (seq, cfg.vocab_size),
                      f"served logits shape {got.shape}")
                check(bool(np.isfinite(got).all()), "non-finite served logits")
                want = model({k: torch.from_numpy(v)[None].cuda()
                              for k, v in req.items()})[0].float().cpu().numpy()
                max_err = max(max_err, float(np.abs(got - want).max()))
                ref_max = max(ref_max, float(np.abs(want).max()))
    finally:
        cfg.attention_impl = "auto"

    # where a full batch's time goes: the forward on the device, then the
    # f32 logits to the host
    full = {k: torch.from_numpy(np.stack([r[k] for r in reqs[:32]])).cuda()
            for k in reqs[0]}
    with torch.inference_mode():
        forward_ms = time_ms(torch, lambda: model(full), 3, warmup=1)
        logits = model(full)
        torch.cuda.synchronize()
        t_copy = time.perf_counter()
        logits.cpu()
        to_host_ms = (time.perf_counter() - t_copy) * 1e3
    del logits, full
    lat_ms = sorted(x * 1e3 for x in lat)
    rec = dict(requests=n_req, clients=n_clients, batches=batches,
               bucket_counts=after["bucket_counts"],
               flash_fwd_launches=launches, layers=cfg.num_layers,
               max_abs_err=max_err, ref_max_abs=ref_max,
               tolerance=f"|served-ref| <= {SERVE_ATOL}",
               attn_max_abs_err=attn_err, attn_ref_max_abs=attn_max,
               attn_tolerance=f"|attn-ref| <= {ATTN_RTOL}*max|ref|",
               batch32_forward_ms=forward_ms,
               batch32_logits_to_host_ms=to_host_ms,
               p50_ms=percentile(lat_ms, 0.50), p99_ms=percentile(lat_ms, 0.99),
               requests_per_s=n_req / wall, wall_s=wall, setup_s=setup_s)
    print("serve bert-base " + json.dumps(rec), flush=True)
    check(max_err <= SERVE_ATOL,
          f"served logits differ from the reference forward by {max_err}")
    check(attn_err <= ATTN_RTOL * attn_max,
          f"served layer-0 attention differs from the plain path by "
          f"{attn_err} (max |ref| {attn_max})")
    check(batches > 0 and launches == cfg.num_layers * batches,
          f"flash_fwd launched {launches} times for {batches} batches "
          f"of a {cfg.num_layers}-layer model")
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--loop-ms"]:  # another tree's package, on its own
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        return loop_ms_tree(sys.argv[2])
    if sys.argv[1:2] == ["--loop-ab"]:
        return loop_ab_main(sys.argv[2:])
    if sys.argv[1:2] == ["--ckpt-commit"]:  # another tree's package, on its own
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        return ckpt_commit_tree(sys.argv[2])
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:] == ["--lenet-rank"]:
        return lenet_rank()
    if sys.argv[1:2] == ["--model-rank"]:
        return model_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--llama-rank"]:
        return llama_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--mpmd-ref-rank"]:
        return mpmd_ref_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--moe-rank"]:
        return moe_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--moe-driver-rank"]:
        return moe_driver_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--desync-rank"]:
        return desync_rank(*sys.argv[2:4])
    if sys.argv[1:2] == ["--bn-half-rank"]:
        rank, port, out = sys.argv[2:5]
        return bn_half_rank(int(rank), int(port), out)
    try:
        import distributeddeeplearningspark_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port's package is not here: {e}", file=sys.stderr)
        return 2
    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: {PKG} imported from {pkg.__file__}, not from "
              f"beside this script", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--gang"]:
        return gang_main(torch, sys.argv[2:])
    if sys.argv[1:] == ["--input-ab"]:
        return input_ab_main(torch)
    if sys.argv[1:] == ["--recovery"]:
        return recovery_main(torch)
    from distributeddeeplearningspark_tpu_torch.models import bert
    from distributeddeeplearningspark_tpu_torch.ops import _build
    from distributeddeeplearningspark_tpu_torch.ops import attention
    from distributeddeeplearningspark_tpu_torch.ops import conv_bn as cb
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearningspark_tpu_torch.ops import ring_attention as ra
    from distributeddeeplearningspark_tpu_torch.ops import scatter_rows as sr
    from distributeddeeplearningspark_tpu_torch.serve import engine as engine_mod

    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {sys.version.split()[0]}", flush=True)
    try:
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build: {', '.join(_build.SOURCES)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name in _build.SOURCES:
            for line in _build.build_log(name).splitlines():
                if any(s in line for s in ("Function properties", "registers",
                                           "spill")):
                    print(f"  {name}: {line.strip()}")
        print(f"flash_fwd built against CUDA runtime "
              f"{_build.load('flash_fwd').dls_flash_fwd_cuda_version()}",
              flush=True)

        if sys.argv[1:] == ["--observe"]:
            train_bert(torch, fa)
            train_llama(torch, fa)
            train_resnet_driver_observed(torch)
            print(nvidia_smi_line())
            return 0
        k1 = check_flash_fwd(torch, fa)
        k23 = check_flash_bwd(torch, fa)
        check_ring_hops(torch, fa, ra)
        if sys.argv[1:] == ["--cp"]:
            print(nvidia_smi_line())
            return 0
        if sys.argv[1:] == ["--moe"]:
            train_llama_moe(torch, fa)
            print(nvidia_smi_line())
            return 0
        check_gates(torch, fa, attention, cb)
        check_input()
        train = train_bert(torch, fa)
        serve = serve_bert(torch, fa, bert, engine_mod)
        llama = train_llama(torch, fa)
        moe = train_llama_moe(torch, fa)
        k4 = check_conv_bn(torch, cb)
        resnet = train_resnet(torch, cb)
        k5 = check_scatter_rows(torch, sr)
        dlrm_rec = train_dlrm(torch, sr)
        train_lenet(torch)
        drivers = train_drivers(torch)
        train_resnet_driver_observed(torch)
        check_bn_halves(torch)
        recovery = check_recovery(torch, cb, fa)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    src = "distributeddeeplearningspark_tpu/ops/flash_attention.py"
    rollback = recovery["rollback"]
    fwd = k1[0]  # the shape the served batches of 32 give the kernel
    bwd = k23[0]  # the training shape: b=32, S=512, every key allowed
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": f"{PKG}/csrc/flash_fwd.cu", "replaces": f"{src}:131",
        # the served batches', BERT's, Llama's (in process and through the
        # driver), the MoE and dense 0.9b's and the rollback drill's two
        # runs, each counted from 0
        "launches": serve["flash_fwd_launches"] + train["launches"]["flash_fwd"]
        + llama["launches"]["flash_fwd"] + llama["driver"]["flash_launches"]["flash_fwd"]
        + moe["moe"]["launches"]["flash_fwd"] + moe["dense"]["launches"]["flash_fwd"]
        + rollback["launches"]["flash_fwd"] + rollback["second_run_launches"]["flash_fwd"],
        "max_abs_err": max(c["max_abs_err"] for c in k1),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
    }]
    for name, key, line, grads in (("flash_bwd_dq", "dq", 256, ("dq",)),
                                   ("flash_bwd_dkv", "dkv", 303, ("dk", "dv"))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/flash_bwd.cu", "replaces": f"{src}:{line}",
            "launches": train["launches"][name] + llama["launches"][name]
            + llama["driver"]["flash_launches"][name] + moe["moe"]["launches"][name]
            + moe["dense"]["launches"][name] + rollback["launches"][name]
            + rollback["second_run_launches"][name],
            "max_abs_err": max(c[g] for c in k23 for g in grads),
            "ms": bwd[f"{key}_ms"], "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{key}_bound_ms"], "bound_by": bwd[f"{key}_bound_by"],
            # the faster SDPA call for the same function: without a mask
            # where every key is allowed
            "library_ms": min(bwd["library_ms"],
                              bwd["library_unmasked_ms"] or bwd["library_ms"]),
        })
    # K4's numbers per launch, averaged over the 27 launches of a train step
    # at the main path's shapes
    main = [c for c in k4 if c["launches_per_step"]]
    per_step = sum(c["launches_per_step"] for c in main)
    mean = lambda key: sum(c[key] * c["launches_per_step"]  # noqa: E731
                           for c in main) / per_step
    kernels.append({
        "name": "conv_bn_stats", "route": "cuda",
        "source": f"{PKG}/csrc/conv_bn.cu",
        "replaces": "distributeddeeplearningspark_tpu/ops/conv_bn.py:62",
        # the in-process phase's, the driver's and the skip drill's runs,
        # each counted from 0
        "launches": resnet["k4_launches"] + drivers["resnet"]["k4_launches"]
        + recovery["skip"]["k4_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in k4),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if mean("bytes_ms") >= mean("ops_ms") else "operations",
        "library_ms": mean("library_ms"),
    })
    k5_step = k5[0]  # the DLRM step's shape
    kernels.append({
        "name": "scatter_add_rows", "route": "cuda",
        "source": f"{PKG}/csrc/scatter_rows.cu",
        "replaces": "distributeddeeplearningspark_tpu/ops/scatter_rows.py:39",
        "launches": dlrm_rec["k5_launches"] + drivers["dlrm"]["k5_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in k5),
        "ms": k5_step["ms"], "plain_ms": k5_step["plain_ms"],
        "bound_ms": k5_step["bound_ms"], "bound_by": k5_step["bound_by"],
        "library_ms": k5_step["library_ms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
