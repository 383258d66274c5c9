"""torch.profiler (Kineto) traces → a device-time breakdown by op class.

The port's counterpart of ``distributeddeeplearningspark_tpu/utils/
xplane.py``: where the JAX package reads an XPlane capture, the port reads
the Chrome trace JSON that ``torch.profiler`` exports
(``*.pt.trace.json``) and answers the question a training engineer asks
first, which ops are eating the step, without TensorBoard.

Which line is read (xplane's rule, on Kineto's events):

- **On the card**, the device line: the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events of the busiest stream (the one with the most device
  time; a stream runs one at a time, so they do not overlap and their sum is
  the stream's busy time). ``streams="all"`` takes every stream instead (a
  copy stream or NCCL's beside the compute stream; their sum may then
  exceed the wall). A ``gpu_user_annotation`` is skipped: it is a host
  range mirrored on the device over the kernels it encloses (NCCL's
  ``nccl:all_reduce``, ``record_function`` ranges), not work of its own.
- **On the CPU**, where a trace holds no device event, the busiest host
  thread's ``cpu_op`` events, outermost only (an op's children run inside
  its time).

Device kernels are classed by :func:`kernel_family`, from their names: the
port's kernels (``flash`` K1–K3, ``k4``, ``k5``), cuDNN convolutions
(``conv``), cuBLAS/CUTLASS GEMMs (``gemm``), NCCL (``nccl``) and ``other``
(elementwise work, reductions, copies); ``by="kernel"`` keeps each kernel's
own name. A CPU op is classed by its name (``aten::mm``).

Output, :func:`parse`: ``{"plane", "line", "total_ms", "event_count",
"ops": [{"name", "ms", "pct", "count", "top_instance"}, ...]}``, ops
sorted by total time, the longest single event of each class in
``top_instance``. The parse runs in the caller's process (JSON needs none
of the subprocess XPlane's protobuf runtime forces on the JAX reader).
"""

from __future__ import annotations

import json
from typing import Any

#: the device event categories that are work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_family(name: str) -> str:
    """A device kernel's family, from its name: the port's kernels, cuDNN
    convolutions, cuBLAS GEMMs, NCCL, or other (elementwise, reductions,
    copies)."""
    if "flash_" in name:
        return "flash"
    if "matmul_stats" in name:
        return "k4"
    if "scatter_add_rows" in name:
        return "k5"
    if "nccl" in name.lower():
        return "nccl"
    if any(s in name for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                               "implicit")):
        return "conv"
    if any(s in name for s in ("gemm", "nvjet", "cutlass")):
        return "gemm"
    return "other"


def load(path: str) -> list[dict]:
    """A trace file's complete (``ph == "X"``) events."""
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
            and "dur" in e]


def _outermost(events: list[dict]) -> list[dict]:
    """One thread's events less those inside an earlier one."""
    out: list[dict] = []
    end = float("-inf")
    for e in sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"]))):
        t0 = float(e["ts"])
        if t0 >= end:
            out.append(e)
            end = t0 + float(e["dur"])
    return out


def _by_line(events: list[dict]) -> dict[tuple, list[dict]]:
    lines: dict[tuple, list[dict]] = {}
    for e in events:
        lines.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    return lines


def select_line(events: list[dict], *, streams: str = "busiest"
                ) -> tuple[str, str, list[dict], bool]:
    """``(plane, line, events, on_device)``: the events :func:`parse`
    aggregates (the module docstring's rule)."""
    if streams not in ("busiest", "all"):
        raise ValueError(f"streams must be 'busiest' or 'all', got {streams!r}")
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if device:
        if streams == "all":
            pids = sorted({str(e.get("pid")) for e in device})
            return f"device {','.join(pids)}", "all streams", device, True
        lines = _by_line(device)
        key = max(lines, key=lambda k: sum(float(e["dur"]) for e in lines[k]))
        return f"device {key[0]}", f"stream {key[1]}", lines[key], True
    host = [e for e in events if e.get("cat") == "cpu_op"]
    if not host:
        return "", "", [], False
    lines = {k: _outermost(v) for k, v in _by_line(host).items()}
    key = max(lines, key=lambda k: sum(float(e["dur"]) for e in lines[k]))
    return f"host {key[0]}", f"thread {key[1]}", lines[key], False


def parse(path: str, *, top: int = 25, by: str = "family",
          streams: str = "busiest") -> dict[str, Any]:
    """The breakdown of one trace file (the module docstring's schema).
    ``by``: ``"family"`` (device kernels by :func:`kernel_family`) or
    ``"kernel"`` (each kernel's name); CPU ops always by name."""
    if by not in ("family", "kernel"):
        raise ValueError(f"by must be 'family' or 'kernel', got {by!r}")
    plane, line, events, on_device = select_line(load(path), streams=streams)
    if not events:
        return {"plane": None, "line": None, "total_ms": 0.0,
                "event_count": 0, "ops": []}
    agg: dict[str, dict] = {}
    total_us = 0.0
    for e in events:
        name = str(e.get("name", ""))
        cls = kernel_family(name) if on_device and by == "family" else name
        rec = agg.setdefault(cls, {"us": 0.0, "count": 0, "top_us": -1.0, "top": ""})
        dur = float(e["dur"])
        rec["us"] += dur
        rec["count"] += 1
        if dur > rec["top_us"]:
            rec["top_us"], rec["top"] = dur, name
        total_us += dur
    ops = sorted(agg.items(), key=lambda kv: -kv[1]["us"])[:top]
    return {
        "plane": plane,
        "line": line,
        "total_ms": round(total_us / 1e3, 6),
        "event_count": len(events),
        "ops": [{"name": cls, "ms": round(rec["us"] / 1e3, 6),
                 "pct": round(100.0 * rec["us"] / total_us, 2) if total_us else 0.0,
                 "count": rec["count"], "top_instance": rec["top"][:160]}
                for cls, rec in ops],
    }

