#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. build every kernel of the path from the checkout's sources (``nvcc``,
   ``sm_90a``) and print the compiler's register/spill report;
2. hold each kernel against its plain PyTorch version on the card, in
   bf16, at the stated tolerance, and time the kernel, the plain version,
   one PyTorch library call computing the same function (a yardstick the
   port never calls) and the card's bound for the same work;
3. serve BERT-base at full width (12 layers, hidden 768, vocab 30522,
   S=512, random weights from a seed) through the port's
   ``InferenceEngine.for_model`` to 8 client threads; check every served
   row against a one-request forward of the same module whose attention
   runs the plain PyTorch path, the first layer's attention output of a
   served batch against that path on the same inputs, and that the kernel
   ran 12 times per served batch; print latency percentiles and
   requests/s;
4. print one JSON line of per-kernel numbers, the card's name and power
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
    with torch.cuda.graph(graph):
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


def _allowed_pairs(torch, case) -> int:
    """(q row, key) pairs the case's masks allow, summed over batch; the
    work that this run's data needs."""
    b, s = case["q"].shape[:2]
    allowed = torch.ones(b, s, s, dtype=torch.bool, device="cuda")
    if case["causal"]:
        allowed &= torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    if case["kv_mask"] is not None:
        allowed &= (case["kv_mask"] != 0)[:, None, :]
    if case["segs"] is not None:
        allowed &= case["segs"][:, :, None] == case["segs"][:, None, :]
    return int(allowed.sum())


def _bound(torch, case) -> tuple[float, str]:
    q, k = case["q"], case["k"]
    b, s, h, d = q.shape
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + b * h * s * 4
    for t in (case["kv_mask"], case["segs"]):
        if t is not None:
            nbytes += t.numel() * 4 * (2 if t is case["segs"] else 1)
    flops = 4 * d * h * _allowed_pairs(torch, case)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_call(torch, case):
    """One ``scaled_dot_product_attention`` call over the same inputs (BHSD
    views), with the masks as a boolean attend-mask."""
    import torch.nn.functional as F

    q, k, v = (t.transpose(1, 2) for t in (case["q"], case["k"], case["v"]))
    mask = None
    if case["kv_mask"] is not None:
        mask = (case["kv_mask"] != 0)[:, None, None, :]
    if case["segs"] is not None:
        same = (case["segs"][:, None, :, None] == case["segs"][:, None, None, :])
        mask = same if mask is None else mask & same
    gqa = q.shape[1] != k.shape[1]
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=case["causal"] and mask is None,
        enable_gqa=gqa)


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
                   library_ms=graph_ms(torch, _library_call(torch, c), 20),
                   bound_ms=bound_ms, bound_by=bound_by)
        print("K1 flash_fwd " + json.dumps(rec), flush=True)
        check(ok, f"flash_fwd disagrees with its plain version on {c['name']}")
        results.append(rec)
        del o, lse, o_ref, lse_ref, err, tol
        torch.cuda.empty_cache()
    return results


# -- phase 3: serving BERT-base -----------------------------------------------


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
    from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearningspark_tpu_torch.serve import engine as engine_mod

    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {sys.version.split()[0]}", flush=True)
    try:
        t0 = time.perf_counter()
        _build.build("flash_fwd")
        print(f"build: flash_fwd in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in _build.build_log("flash_fwd").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  flash_fwd: {line.strip()}")

        k1 = check_flash_fwd(torch, fa)
        serve = serve_bert(torch, fa, bert, engine_mod)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    main_case = k1[0]  # the shape the served batches of 32 give the kernel
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": f"{PKG}/csrc/flash_fwd.cu",
        "replaces": "distributeddeeplearningspark_tpu/ops/flash_attention.py:131",
        "launches": serve["flash_fwd_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in k1),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
