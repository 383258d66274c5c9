#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. build every kernel of the paths from the checkout's sources (one
   ``nvcc`` per source, started together, ``sm_90a``) and print the
   compiler's register/spill report;
2. hold K1 (flash forward) against its plain PyTorch version on the card
   in eight bf16 cases (the served and the training shape, causal GQA at
   D = 128, segments with padding, a fully masked row, S = 320 at D = 64
   and at D = 128 causal GQA, and whole key tiles skipped by padding and
   by segments), at the stated tolerance, and time the kernel, the
   plain version, one PyTorch library call computing the same function (a
   yardstick the port never calls) and the card's bound for the same work;
3. the same for K2 (dQ) and K3 (dK, dV) against the plain backward, in
   nine cases (the training shape, b=32, S=512, every key allowed; the
   served batch; causal GQA at D = 128; segments with padding; a fully
   masked row; S = 320 at D = 64 and at D = 128 causal GQA; whole tiles
   skipped; S = 322 with padding), each run twice for equal bits, timing
   ``_delta`` and the whole ``flash_bwd`` beside the two kernels; then the
   gates: "auto" picks the plain path for f32 and for head dims the
   kernels are not built for, an f32 ``Conv1x1BN`` trains unfused, and the
   wrappers raise on such inputs;
4. train BERT-base MLM at full width (12 layers, hidden 768, vocab 30522,
   S=512, dropout 0.1, random weights from a seed) for 30 steps at b=32
   through the port's ``Session`` → ``synthetic_wikipedia`` →
   ``WordPieceTokenizer`` → ``mlm_dataset`` → ``Trainer.fit``, the calls of
   ``examples/train_bert.py``; check that every logged loss is finite and
   the last below 0.9x the first, that each kernel ran 12 times per step,
   and that every parameter gradient through the kernels agrees with the
   plain attention path on one batch; print the step time, tokens/s, the
   step's forward/backward/optimizer split, a profiled window and the peak
   device memory;
5. serve BERT-base through the port's ``InferenceEngine.for_model`` to 8
   client threads; check every served row against a one-request forward of
   the same module whose attention runs the plain PyTorch path, the first
   layer's attention output of a served batch against that path on the
   same inputs, and that K1 ran 12 times per served batch; print latency
   percentiles and requests/s;
6. hold K4 (the 1×1-conv matmul with BN statistics) against its plain
   version on the card in bf16 at the ten shapes of ResNet-50's fused
   layers at b=256 and three small, ragged ones, at the stated tolerances,
   and time the kernel, the plain version, the library yardstick
   (``torch.mm`` then ``torch.var_mean``) and the bound;
7. train ResNet-50 at full width (stages 3/4/6/3, width 64, 1000 classes,
   224², bf16 activations, ``fused_conv_bn=True``, random weights from a
   seed) for 30 steps at b=256 through the port's ``Session`` →
   ``synthetic_images`` → ``imagenet_train(repeat=True)`` → ``Trainer.fit``
   with SGD under ``warmup_cosine(0.1)``, the calls of
   ``examples/train_resnet.py``; check that every logged loss is finite and
   the last below the first, that K4 ran 27 times per step, that every
   parameter gradient through K4 agrees with the unfused chain on one
   batch, that the BN statistics moved and an evaluation is finite; print
   the step time, images/s, the host's ms per batch, the step's split, a
   profiled window and the peak device memory;
8. hold K5 (the in-place row scatter-add) against its plain version on the
   card, bitwise, in five cases: the DLRM step's shape (the sorted unique
   rows of a real synthetic batch of 8,192 over the 2,600,000 × 64 f32
   table, padded to 212,992 with drop sentinels), the same at D = 1, 700
   unsorted int64 ids at D = 13, all ids sentinels
   (past V and negative), and no ids; guard rows around each table show
   that nothing was written outside it, and its ``data_ptr`` that it was
   not copied. At the DLRM shape, time the kernel, the plain version,
   ``index_add_`` (a yardstick the port never calls on this path) and
   the bound;
9. train the config-4 DLRM at full width (26 × 100,000 rows × 64 in one
   f32 table, bottom MLP 512/256/64, top 512/256/1, bf16 MLPs, random
   weights from a seed) for 30 steps at b=8,192 through the port's
   ``Session`` → ``synthetic_criteo`` → ``Trainer.fit(sparse_embed=...)``
   with ``binary_xent``, AdamW on the MLPs and row-wise AdaGrad on the
   table through K5; check that every logged loss is finite and the last
   below the first, that K5 ran once a step, that no optimizer tensor has
   the table's size, and, on one more batch from one saved state, that
   rows outside the batch do not move and that K5's step, a step whose
   scatter is K5's plain version, and a second K5 step give the same bits;
   print the step time, examples/s, the host's ms per batch, a profiled
   window, the peak device memory, a held-out evaluation and its AUC;
10. print one JSON line of per-kernel numbers, the card's name and power
   limit (``nvidia-smi``), and last ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is absent, when the port's
package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import json
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
RESNET_STEPS, RESNET_BATCH = 30, 256
# DLRM (config 4): 26 features of 100,000 rows each, batch 8,192
DLRM_VOCABS = (100_000,) * 26
DLRM_STEPS, DLRM_BATCH = 30, 8192
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


def check_flash_fwd(torch, fa) -> list[dict]:
    cases = [
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


def check_flash_bwd(torch, fa) -> list[dict]:
    cases = [
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


def check_gates(torch, fa, attention, cb) -> None:
    """The dispatch sends the kernels only what they take: "auto" picks the
    plain path for f32 and for head dims the kernels are not built for, an
    f32 ``Conv1x1BN`` trains through the unfused chain; the wrappers still
    raise on such inputs (a gate, not a fallback)."""
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
    check(len(raised) == 3, f"wrappers raised only for {raised}")
    mod = cb.Conv1x1BN(64, 64, dtype=torch.float32, device="cuda")
    torch.nn.init.normal_(mod.kernel, std=0.1)
    mod.train()
    x = torch.randn(4, 64, 8, 8, device="cuda").contiguous(
        memory_format=torch.channels_last)
    before = cb.matmul_stats.launches
    out = mod(x)
    torch.cuda.synchronize()
    check(cb.matmul_stats.launches == before and bool(torch.isfinite(out).all())
          and out.dtype == torch.float32,
          "an f32 Conv1x1BN must train through the unfused chain")
    print("gates " + json.dumps(dict(picks=picks, wrappers_raised=raised,
                                     conv1x1bn_f32_unfused=True)), flush=True)


# -- phase 4: training BERT-base -----------------------------------------------


def _grad_parity(torch, model, loss_fn, batch) -> dict:
    """Every parameter's gradient on ``batch`` through the kernels
    (``attention_impl="auto"``) against the plain path (``"xla"``), with the
    same weights and dropout off (eval mode)."""
    model.eval()
    grads = {}
    try:
        for impl in ("auto", "xla"):
            model.cfg.attention_impl = impl
            model.zero_grad(set_to_none=True)
            loss_fn(model(batch), batch)[0].backward()
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
                qkv_weights=len(qkv), qkv_min_grad_norm=min(qkv.values()))


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


def _kernel_family(name: str) -> str:
    """A device kernel's family, from its name: the port's kernels, cuDNN
    convolutions, cuBLAS GEMMs, or other (elementwise, reductions, copies)."""
    if "flash_" in name:
        return "flash"
    if "matmul_stats" in name:
        return "k4"
    if "scatter_add_rows" in name:
        return "k5"
    if any(s in name for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                               "implicit")):
        return "conv"
    if any(s in name for s in ("gemm", "nvjet", "cutlass")):
        return "gemm"
    return "other"


def _profile_fit(torch, trainer, ds, batch_size: int, fit_kw: dict,
                 steps: int = 4) -> dict:
    """``steps`` more steps of ``fit`` under ``torch.profiler``: the device's
    busy time per step (the sum of the times of the kernels and copies that
    ran on it, one stream, so none overlap) against the wall time per step,
    and the kernels that take most of it. The profiler's own cost is in the
    wall time; "not measured" when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = trainer.state.step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.fit(ds, batch_size=batch_size, steps=start + steps,
                    log_every=steps, **fit_kw)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    own = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in own) / steps
    if not own:
        return dict(busy_ms_per_step="not measured", wall_ms_per_step=wall_ms)
    top = sorted(own, key=lambda kv: -kv[1])[:10]
    groups: dict[str, float] = {}
    for k, ms in own:  # by kernel family, from the kernels' names
        group = _kernel_family(k)
        groups[group] = groups.get(group, 0.0) + ms / steps
    return dict(steps=steps, wall_ms_per_step=wall_ms, busy_ms_per_step=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, busy_ms_by_family=groups,
                top_device_ms_per_step=[(k[:80], ms / steps) for k, ms in top])


def train_bert(torch, fa) -> dict:
    """BERT-base MLM at full width through the port's Session → text →
    mlm_dataset → Trainer.fit, the calls of examples/train_bert.py at
    S=512; the run's step_metrics telemetry gives the logged losses."""
    import os
    import shutil

    from distributeddeeplearningspark_tpu_torch import telemetry
    from distributeddeeplearningspark_tpu_torch.data import text
    from distributeddeeplearningspark_tpu_torch.data.feed import (
        device_batches,
        host_batches,
    )
    from distributeddeeplearningspark_tpu_torch.models import bert
    from distributeddeeplearningspark_tpu_torch.session import Session
    from distributeddeeplearningspark_tpu_torch.train import losses, optim
    from distributeddeeplearningspark_tpu_torch.train.trainer import Trainer

    steps, batch_size, seq, log_every = 30, 32, 512, 10
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    spark = Session.builder.master("local[1]").appName("bert-mlm").getOrCreate()
    docs = text.synthetic_wikipedia(
        2048, num_partitions=max(spark.default_parallelism, 1))
    tok = text.WordPieceTokenizer.train(docs.collect(), vocab_size=8192)
    ds = text.mlm_dataset(docs, tok, seq_len=seq, max_predictions=80).repeat()
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
        _, summary = trainer.fit(ds, batch_size=batch_size, steps=steps,
                                 tokens_per_example=seq, log_every=log_every)
    finally:
        os.environ.pop(telemetry.WORKDIR_ENV, None)
        telemetry.reset()
    fit_s = time.perf_counter() - t_fit
    launches = {k.__name__: k.launches for k in kernels}
    peak_bytes = torch.cuda.max_memory_allocated()

    records = [json.loads(line) for f in sorted(
        (workdir / telemetry.TELEMETRY_DIRNAME).glob("events-*.jsonl"))
        for line in f.read_text().splitlines()]
    logged = [(r["step"], r["metrics"]["loss"]) for r in records
              if r["kind"] == "step_metrics"]
    host = host_batches(ds, batch_size)
    next(host)
    t_host = time.perf_counter()
    for _ in range(5):
        next(host)
    host_batch_ms = (time.perf_counter() - t_host) / 5 * 1e3
    profile = _profile_fit(torch, trainer, ds, batch_size,
                           dict(tokens_per_example=seq))
    batch = next(device_batches(ds, batch_size, trainer.device))
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
               step_split=split, profile=profile, grad_parity=parity)
    print("train bert-base " + json.dumps(rec), flush=True)
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
    return rec


# -- phase 6: K4 against its plain version ---------------------------------------

# (M, K, N) of the Conv1x1BN calls that the K4 gate admits in one fused
# ResNet-50 forward at b=256, 224², and how many of the 27 launches of a
# train step each shape takes; then small and ragged shapes the gate admits
# (K, N not multiples of 8 take the element-wise load path)
K4_MAIN_SHAPES = {
    (802816, 64, 64): 1, (802816, 64, 256): 3, (802816, 256, 64): 2,
    (802816, 256, 128): 1, (200704, 128, 512): 4, (200704, 512, 128): 3,
    (200704, 512, 256): 1, (50176, 256, 1024): 6, (50176, 1024, 256): 5,
    (50176, 1024, 512): 1,
}
K4_EXTRA_SHAPES = [(1024, 40, 72), (256, 16, 16), (48, 13, 24)]
# Y: both round one f32 dot product to bf16, the sums taken in another
# order, so Y may sit one bf16 step (at most 2^-7 of |y|) from the plain
# version's y32.to(bf16), plus the f32 order residue near y = 0
K4_Y_RTOL, K4_Y_ATOL = 2 ** -7, 1e-4
# s1, s2: f32 sums over up to 802,816 rows in another order (128-row tiles
# in the kernel, then torch's sum over the tiles); held to each column's
# sum of |y32| (of y32²): a wrong or missing 128-row tile moves a column by
# about 1/6272 of it, ten times this
K4_STATS_RTOL = 2e-5


def _k4_bound(m: int, k: int, n: int) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes ms, operations ms): X and W read
    once, Y and the two [N] f32 sums written once; 2·M·K·N operations."""
    t_bytes = ((m * k + k * n + m * n) * 2 + 2 * n * 4) / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / PEAK_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def check_conv_bn(torch, cb) -> list[dict]:
    """K4 at the main path's ten shapes and three small ones, bf16: the
    kernel's (y, s1, s2) against its plain version on the same inputs; the
    wrapper (kernel + the reduce over row tiles), the plain version and the
    library yardstick (``torch.mm`` into bf16, then ``torch.var_mean``'s
    one f32-accumulated pass over Y: two calls the port never makes) timed
    from CUDA graphs."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 mm
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for i, (m, k, n) in enumerate([*K4_MAIN_SHAPES, *K4_EXTRA_SHAPES]):
        gen = torch.Generator(device="cuda").manual_seed(50 + i)
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5
             ).to(torch.bfloat16)
        y, s1, s2 = cb.matmul_stats(x, w)
        torch.cuda.synchronize()
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
                   ok=ok)
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
        results.append(rec)
        del x, w
        torch.cuda.empty_cache()
    return results


# -- phase 7: training ResNet-50 ---------------------------------------------------

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
    """The host's ms per batch, over ``batches`` fresh batches (whole passes
    over a small dataset include each pass's shuffle and image draws)."""
    from distributeddeeplearningspark_tpu_torch.data.feed import host_batches

    it = host_batches(ds, batch_size)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    return (time.perf_counter() - t0) / batches * 1e3


def train_resnet(torch, cb) -> dict:
    """ResNet-50 at full width (stages 3/4/6/3, width 64, 1000 classes,
    224², bf16 activations, f32 params and BN state, random weights from a
    seed, fused_conv_bn=True) through the port's Session →
    synthetic_images → imagenet_train(repeat=True) → Trainer.fit with SGD
    (momentum 0.9, weight decay 1e-4) under warmup_cosine(0.1) and
    softmax_xent: the calls of examples/train_resnet.py's synthetic
    branch. 4 batches of images, seen several times, so the loss falls."""
    import os
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
    src = sources.synthetic_images(4 * batch_size, image_size=size,
                                   num_classes=1000, num_partitions=1)
    ds = vision.imagenet_train(src, size=size, repeat=True)
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
    moved = sum(1 for n, b in model.named_buffers()
                if n.endswith(".mean") and bool(b.abs().max() > 0))
    host_batch_ms = _host_batch_ms(ds, batch_size, 8)
    profile = _profile_fit(torch, trainer, ds, batch_size, {})
    batch = next(device_batches(ds, batch_size, trainer.device))
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
               step_split=split, profile=profile, grad_parity=parity,
               evaluation=evaluation)
    print("train resnet-50 " + json.dumps(rec), flush=True)
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


# -- phase 8: K5 against its plain version ---------------------------------------

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


# -- phase 9: training DLRM ------------------------------------------------------


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
    import os
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
    opt_tensors = _tensors(torch, state.opt_state)
    table_sized = [tuple(t.shape) for t in opt_tensors if t.numel() >= table.numel()]
    host_batch_ms = _host_batch_ms(ds, batch_size, 3)
    profile = _profile_fit(torch, trainer, ds, batch_size, {})
    batch = next(device_batches(ds, batch_size, trainer.device))
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
               host_batch_ms=host_batch_ms, profile=profile,
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


# -- phase 5: serving BERT-base -----------------------------------------------


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
    sys.path.insert(0, str(ROOT))
    try:
        import distributeddeeplearningspark_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port's package is not here: {e}", file=sys.stderr)
        return 2
    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: {PKG} imported from {pkg.__file__}, not from "
              f"beside this script", file=sys.stderr)
        return 2
    from distributeddeeplearningspark_tpu_torch.models import bert
    from distributeddeeplearningspark_tpu_torch.ops import _build
    from distributeddeeplearningspark_tpu_torch.ops import attention
    from distributeddeeplearningspark_tpu_torch.ops import conv_bn as cb
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
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

        k1 = check_flash_fwd(torch, fa)
        k23 = check_flash_bwd(torch, fa)
        check_gates(torch, fa, attention, cb)
        train = train_bert(torch, fa)
        serve = serve_bert(torch, fa, bert, engine_mod)
        k4 = check_conv_bn(torch, cb)
        resnet = train_resnet(torch, cb)
        k5 = check_scatter_rows(torch, sr)
        dlrm_rec = train_dlrm(torch, sr)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    src = "distributeddeeplearningspark_tpu/ops/flash_attention.py"
    fwd = k1[0]  # the shape the served batches of 32 give the kernel
    bwd = k23[0]  # the training shape: b=32, S=512, every key allowed
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": f"{PKG}/csrc/flash_fwd.cu", "replaces": f"{src}:131",
        "launches": serve["flash_fwd_launches"]
        + train["launches"]["flash_fwd"],
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
            "launches": train["launches"][name],
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
        "launches": resnet["k4_launches"],
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
        "launches": dlrm_rec["k5_launches"],
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
