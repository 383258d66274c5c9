"""The port's device-side observability (``telemetry/anatomy.py``) on the
CPU, holding the JAX package's contracts of ``tests/test_anatomy.py``:

- the lap's split and MFU arithmetic under a fake clock (JAX's
  hand-computed case);
- the peak's resolution order: ``DLS_PEAK_FLOPS``, the spec table by the
  card's name, the labelled nominal CPU figure, ``unknown-device``; a
  malformed override ignored;
- the memory watermarks: the allocator's stats on a card (faked here: no
  card on the CPU) with the peak that ``max_memory_allocated`` reports, the
  process's resident bytes on the CPU; the fold prefers the stats;
- ``anatomy_report`` equal to the JAX package's on the same events;
- the signature ledger: one ``compile`` event a new input signature, in a
  ``compile`` phase span, exactly one flagged recompile for a second
  signature; ``prepare`` measures the FLOPs and is the call itself;
- ``fit``: every lap's record carries JAX's MFU keys with
  ``measure_flops`` (and the MFU is flops × steps / wall / peak), none
  without, and a ``memory`` event follows every lap.
"""

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu.telemetry import anatomy as janatomy
from distributeddeeplearningspark_tpu_torch import Session, Trainer, telemetry
from distributeddeeplearningspark_tpu_torch import metrics
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.telemetry import anatomy
from distributeddeeplearningspark_tpu_torch.train import losses, optim

from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


@pytest.fixture(autouse=True)
def _stop_session():
    """The port's ``Session`` is one a process: a test's must not be the
    next test's (a worker runs file after file)."""
    yield
    if Session._active is not None:
        Session._active.stop()
    telemetry.reset()


@pytest.fixture
def workdir(tmp_path):
    """The process-wide writer bound to a temp workdir, unbound after."""
    telemetry.configure(tmp_path)
    yield str(tmp_path)
    telemetry.reset()


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- the lap ------------------------------------------------------------------------


def test_step_anatomy_split_and_mfu_arithmetic(monkeypatch):
    """JAX's case: 10 steps of 2e9 FLOPs over 4 chips in a 10 s lap at a
    1e9 FLOP/s/chip peak → MFU = 2e9·10/10/4/1e9 = 0.5; device 6 s (4
    dispatch + 2 drain), compile 1 s, input 0.5 s, host the 2.5 s rest. A
    lap holding a first call (the compile: the step itself in the port)
    has no ``mfu_device``; a lap without one has JAX's record."""
    monkeypatch.setenv(anatomy.PEAK_FLOPS_ENV, "1e9")
    clock = FakeClock()
    anat = anatomy.StepAnatomy(clock=clock)
    anat.reset()
    anat.note_compile(1.0)
    anat.note_dispatch(4.0)
    clock.t = 8.0
    with anat.drain():
        clock.t = 10.0
    rec = anat.lap(steps=10, input_wait_s=0.5, flops_per_step=2e9, num_chips=4)
    assert rec["anatomy_wall_s"] == 10.0
    assert rec["device_s"] == 6.0
    assert rec["device_dispatch_s"] == 4.0
    assert rec["device_drain_s"] == 2.0
    assert rec["compile_in_lap_s"] == 1.0
    assert rec["device_dispatches"] == 1
    assert rec["host_s"] == pytest.approx(2.5)
    assert rec["mfu"] == pytest.approx(0.5)
    assert "mfu_device" not in rec
    assert rec["peak_flops_per_chip"] == 1e9
    assert rec["peak_source"] == anatomy.PEAK_FLOPS_ENV
    clock.t = 12.0
    rec2 = anat.lap(steps=0)
    assert rec2["anatomy_wall_s"] == 2.0
    assert rec2["device_s"] == 0.0 and rec2["host_s"] == 2.0
    assert "mfu" not in rec2 and "flops_per_step" not in rec2
    # a lap without a first call, through the port's and JAX's StepAnatomy:
    # the same record, mfu_device = 2e9·10 / 6 s / 4 / 1e9
    recs = []
    for mod in (anatomy, janatomy):
        clock = FakeClock()
        anat = mod.StepAnatomy(clock=clock)
        anat.reset()
        anat.note_dispatch(4.0)
        clock.t = 8.0
        with anat.drain():
            clock.t = 10.0
        recs.append(anat.lap(steps=10, input_wait_s=0.5, flops_per_step=2e9,
                             num_chips=4))
    assert recs[0] == recs[1]
    assert recs[0]["mfu_device"] == pytest.approx(2e9 * 10 / 6.0 / 4 / 1e9)
    assert recs[0]["host_s"] == pytest.approx(3.5)


def test_resolve_peak_flops_order(monkeypatch):
    monkeypatch.setenv(anatomy.PEAK_FLOPS_ENV, "123.5")
    assert anatomy.resolve_peak_flops() == (123.5, anatomy.PEAK_FLOPS_ENV)
    monkeypatch.delenv(anatomy.PEAK_FLOPS_ENV)
    peak, source = anatomy.resolve_peak_flops("cpu")
    assert peak and peak > 0 and source.startswith("nominal-cpu")
    monkeypatch.setenv(anatomy.PEAK_FLOPS_ENV, "not-a-number")
    assert anatomy.resolve_peak_flops("cpu")[0] == peak  # ignored, not fatal
    monkeypatch.delenv(anatomy.PEAK_FLOPS_ENV)
    for name, want in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert anatomy.resolve_peak_flops("cuda") == (want, f"spec table ({name})")
        assert metrics.device_peak_flops("cuda") is None or torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other GPU")
    assert anatomy.resolve_peak_flops("cuda") == (None, "unknown-device (Some Other GPU)")


# -- memory -------------------------------------------------------------------------------


def test_memory_watermarks_on_the_cpu_count_the_resident_set():
    keep = torch.ones(1 << 20)  # noqa: F841 — 4 MiB held live
    rec = anatomy.memory_watermarks("cpu")
    assert rec["source"] == "process-rss" and rec["devices"] == 1
    assert rec["live_bytes"] >= keep.nbytes


def test_memory_watermarks_on_a_card_read_the_allocator(monkeypatch):
    stats = {"allocated_bytes.all.current": 300, "allocated_bytes.all.peak": 700,
             "reserved_bytes.all.current": 1024}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d=None: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (9000, 10000))
    rec = anatomy.memory_watermarks("cuda")
    assert rec == {"source": "memory_stats", "devices": 1, "bytes_in_use_max": 300,
                   "peak_bytes_in_use_max": 700, "bytes_limit_min": 10000,
                   "headroom_bytes": 9300}


def test_memory_fold_prefers_stats_and_computes_headroom():
    events = [
        {"ts": 1.0, "kind": "memory", "process": "p0", "source": "memory_stats",
         "bytes_in_use_max": 100, "peak_bytes_in_use_max": 150,
         "bytes_limit_min": 1000, "headroom_bytes": 850},
        {"ts": 2.0, "kind": "memory", "process": "p1", "source": "memory_stats",
         "bytes_in_use_max": 200, "peak_bytes_in_use_max": 300,
         "bytes_limit_min": 900, "headroom_bytes": 600},
        {"ts": 3.0, "kind": "memory", "process": "bench", "source": "process-rss",
         "live_bytes": 7},
    ]
    mem = anatomy.anatomy_report(events)["memory"]
    assert mem == {"source": "memory_stats", "bytes_in_use_max": 200,
                   "peak_bytes_in_use_max": 300, "bytes_limit_min": 900,
                   "headroom_bytes": 600}
    assert anatomy.anatomy_report([events[-1]])["memory"] == {
        "source": "live-buffers", "live_bytes": 7}


# -- the report against JAX's --------------------------------------------------------------


def _lap_event(proc, ts, **kw):
    rec = {"ts": ts, "kind": "step_metrics", "process": proc, "step": 10,
           "steps": 10, "lap_s": 10.0, "input_wait_s": 0.5, "anatomy_wall_s": 10.0,
           "device_s": 6.0, "device_dispatch_s": 4.0, "device_drain_s": 2.0,
           "host_s": 2.5, "compile_in_lap_s": 1.0, "num_chips": 4,
           "peak_flops_per_chip": 1e9, "peak_source": "DLS_PEAK_FLOPS",
           "flops_per_step": 2e9, "mfu": 0.5}
    rec.update(kw)
    return rec


def _compile(ts, proc="p0", sig_hash="aa", recompile=False):
    return {"ts": ts, "kind": "compile", "process": proc, "fn": "train_step",
            "sig": "i32[4,32]", "sig_hash": sig_hash, "compile_s": 2.0,
            "flops": 2e9, "bytes_accessed": None, "recompile": recompile,
            "aot": False, "plan": "dp", "plan_sig": "ab12"}


STREAMS = {
    "laps_and_ledger": [_compile(0.0), _lap_event("p0", 10.0),
                        _lap_event("p0", 20.0, mfu=0.4, flops_per_step=3e9)],
    "recompile": [_compile(0.0), _compile(5.0, sig_hash="bb", recompile=True),
                  _lap_event("p0", 10.0, host_s=8.0, device_s=1.0)],
    "restart_duplicates": [_compile(0.0), _compile(10.0, proc="p1")],
    "two_processes_and_memory": [
        _lap_event("p0", 10.0), _lap_event("p1", 11.0, input_wait_s=6.0, host_s=0.1),
        {"ts": 12.0, "kind": "memory", "process": "p0", "source": "memory_stats",
         "bytes_in_use_max": 5, "peak_bytes_in_use_max": 9, "bytes_limit_min": 80,
         "headroom_bytes": 71}],
    "cpu_memory_only": [{"ts": 1.0, "kind": "memory", "process": "p0",
                         "source": "process-rss", "live_bytes": 123}],
    "nothing": [{"ts": 0.0, "kind": "heartbeat"}],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_anatomy_report_equals_jax(stream):
    events = STREAMS[stream]
    assert anatomy.anatomy_report(events) == janatomy.anatomy_report(events)


# -- the signature ledger ------------------------------------------------------------------


def test_a_new_signature_flags_exactly_one_recompile(workdir):
    calls = []

    def step(state, batch):
        calls.append(batch["x"].shape)
        return state + 1, {"loss": batch["x"].sum()}

    fn = anatomy.instrument(step, name="train_step")
    assert anatomy.instrument(fn, name="other") is fn
    anat = anatomy.StepAnatomy()
    fn.attach_anatomy(anat)
    state = 0
    for shape in ((4, 8), (4, 8), (4, 8), (2, 8), (2, 8)):
        state, _ = fn(state, {"x": torch.ones(shape)})
    assert state == 5 and len(calls) == 5
    recs = fn.records
    assert [r["recompile"] for r in recs] == [False, True]
    assert [r["sig"] for r in recs] == ["int[] f32[4,8]", "int[] f32[2,8]"]
    lap = anat.lap(steps=5)
    assert lap["device_dispatches"] == 3 and lap["compile_in_lap_s"] > 0
    events = telemetry.read_events(workdir)
    compiles = [e for e in events if e["kind"] == "compile"]
    assert [e["recompile"] for e in compiles] == [False, True]
    assert all(e["aot"] is False and e["fn"] == "train_step" for e in compiles)
    spans = [(e["name"], e["edge"]) for e in events if e["kind"] == "phase"]
    assert spans == [("compile", "begin"), ("compile", "end")] * 2
    rep = anatomy.anatomy_report(events)
    assert rep["compile_ledger"]["flagged_recompiles"] == 1
    assert rep["verdicts"]["recompile"].startswith("RECOMPILES")


def test_prepare_counts_the_call_and_is_the_call(workdir):
    w = torch.randn(16, 4)
    fn = anatomy.instrument(lambda x: x @ w, name="proj")
    out, rec = fn.prepare(torch.ones(8, 16))
    assert torch.equal(out, torch.ones(8, 16) @ w)
    assert rec["flops"] == fn.flops_per_step == metrics.matmul_flops(8, 16, 4)
    assert fn(torch.ones(8, 16)).shape == (8, 4) and len(fn.records) == 1
    # a seen signature, counted again (a later fit(measure_flops=True)):
    # no second compile, no recompile flagged
    out, rec = fn.prepare(torch.ones(8, 16))
    assert rec["flops"] == metrics.matmul_flops(8, 16, 4) and not rec["recompile"]
    assert len(fn.records) == 1
    assert sum(e["kind"] == "compile" for e in telemetry.read_events(workdir)) == 1


# -- fit ---------------------------------------------------------------------------------------


def _fit(tmp_path, monkeypatch, *, measure: bool):
    monkeypatch.setenv(telemetry.WORKDIR_ENV, str(tmp_path))
    monkeypatch.setenv(anatomy.PEAK_FLOPS_ENV, "1e12")
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    cfg = tllama.LlamaConfig.tiny(lora_rank=4, num_layers=2)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ds = PartitionedDataset.parallelize(
        [{"input_ids": rng.integers(0, 512, 32).astype(np.int32)} for _ in range(8)], 2)
    trainer = Trainer(spark, model, losses.causal_lm,
                      optim.masked(optim.adamw(1e-3), tllama.lora_trainable),
                      trainable=tllama.lora_trainable)
    try:
        _, summary = trainer.fit(ds.repeat(), batch_size=4, steps=6, log_every=2,
                                 measure_flops=measure)
    finally:
        telemetry.reset()
    return telemetry.read_events(tmp_path), trainer, summary


def test_fit_laps_carry_mfu_and_a_memory_event(tmp_path, monkeypatch):
    events, trainer, summary = _fit(tmp_path, monkeypatch, measure=True)
    laps = [e for e in events if e["kind"] == "step_metrics"]
    assert [e["step"] for e in laps] == [2, 4, 6]
    flops = trainer._train_step.flops_per_step
    for e in laps:
        assert e["flops_per_step"] == flops and e["num_chips"] == 1
        assert e["peak_flops_per_chip"] == 1e12 and e["peak_source"] == "DLS_PEAK_FLOPS"
        assert e["mfu"] == pytest.approx(flops * e["steps"] / e["anatomy_wall_s"] / 1e12,
                                         abs=1e-6)
        assert e["mfu"] > 0
        assert (e["mfu_device"] >= e["mfu"]) if e["compile_in_lap_s"] == 0 \
            else "mfu_device" not in e
    kinds = [e["kind"] for e in events]
    # one memory event right after each lap's record
    after = [kinds[i + 1] for i, k in enumerate(kinds) if k == "step_metrics"]
    assert after == ["memory"] * 3
    assert summary["mfu"] == pytest.approx(
        flops / (summary["step_time_ms"] / 1e3) / 1e12)
    compiles = [e for e in events if e["kind"] == "compile"]
    assert len(compiles) == 1 and compiles[0]["flops"] == flops
    assert laps[0]["compile_in_lap_s"] > 0 == laps[1]["compile_in_lap_s"]
    rep = anatomy.anatomy_report(events)
    assert rep["mfu"]["flops_per_step"] == flops and rep["memory"]["live_bytes"] > 0


def test_fit_without_measure_flops_has_no_mfu_keys(tmp_path, monkeypatch):
    events, trainer, summary = _fit(tmp_path, monkeypatch, measure=False)
    laps = [e for e in events if e["kind"] == "step_metrics"]
    assert laps and not any("mfu" in e or "flops_per_step" in e for e in laps)
    assert all("anatomy_wall_s" in e and "peak_source" in e for e in laps)
    assert trainer._train_step.flops_per_step is None and "mfu" not in summary
    assert sum(e["kind"] == "memory" for e in events) == 3


def test_measure_flops_is_refused_on_an_expert_mesh(monkeypatch):
    from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_EXPERT

    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(num_layers=1), device="cpu")
    trainer = Trainer(spark, model, losses.causal_lm, optim.adamw(1e-3))
    monkeypatch.setitem(spark.mesh.shape, AXIS_EXPERT, 2)
    with pytest.raises(NotImplementedError, match="expert"):
        trainer.fit(PartitionedDataset.parallelize([{"input_ids": np.zeros(8, np.int32)}] * 4,
                                                   1).repeat(),
                    batch_size=2, steps=1, measure_flops=True)
