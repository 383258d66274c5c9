"""The port's serving engine on the CPU: the cases of tests/test_serve.py
(bucket ladder, coalescing, results mapped back across buckets, load shed,
stop without drain, params swapped mid-traffic with zero dropped
requests), BERT served through ``for_model``, and a run's telemetry read by
the JAX package's ``dlstatus``."""

import threading
import time

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.serve import (
    EngineStoppedError,
    InferenceEngine,
    OverloadedError,
    default_buckets,
)
from test_torch_deadline import per_test


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _mul_forward(params, batch):
    return {"y": batch["x"] * params["w"]}


def _mk_engine(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5.0)
    kw.setdefault("max_queue", 64)
    return InferenceEngine(_mul_forward, {"w": torch.tensor(1.0)},
                           device="cpu", **kw)


@pytest.fixture(autouse=True)
def _unbind_telemetry():
    yield
    telemetry.reset()


@pytest.mark.parametrize("max_batch,want", [
    (32, (1, 2, 4, 8, 16, 32)),
    (24, (1, 2, 4, 8, 16, 24)),
    (16, (1, 2, 4, 8, 16)),
    (1, (1,)),
])
def test_default_buckets(max_batch, want):
    assert default_buckets(max_batch) == want


def test_coalesces_waiting_requests_into_one_batch():
    eng = _mk_engine(max_batch=16)
    futs = [eng.submit({"x": np.float32(i)}) for i in range(10)]
    with eng:
        res = [f.result(30) for f in futs]
    for i, r in enumerate(res):
        assert float(r["y"]) == float(i)
    st = eng.stats()
    assert st["batches"] == 1, st
    assert st["bucket_counts"] == {16: 1}, st  # 10 requests → bucket 16


def test_bucket_shapes_stay_within_the_ladder():
    eng = _mk_engine(max_batch=8, max_wait_ms=1.0)
    with eng:
        assert eng.warmup({"x": np.float32(0)}) == len(eng.batch_sizes)
        after_warmup = eng.stats()["compiled_batch_shapes"]
        assert after_warmup == len(eng.batch_sizes)
        for wave in range(4):  # varying arrival counts — same buckets
            futs = [eng.submit({"x": np.float32(i)}) for i in range(1 + 2 * wave)]
            for f in futs:
                f.result(30)
        st = eng.stats()
    assert st["compiled_batch_shapes"] == after_warmup, st
    assert st["requests"] == 1 + 3 + 5 + 7
    assert set(st["bucket_counts"]) <= set(eng.batch_sizes)


def test_results_map_back_to_their_requests_across_buckets():
    rng = np.random.default_rng(0)
    eng = _mk_engine(max_batch=4, max_wait_ms=2.0, max_queue=512)
    xs = rng.normal(0, 1, (100,)).astype(np.float32)
    with eng:
        futs = [eng.submit({"x": x}) for x in xs]
        res = [float(f.result(30)["y"]) for f in futs]
    np.testing.assert_allclose(res, xs, rtol=1e-6)


def test_load_shed_under_full_queue():
    eng = _mk_engine(max_queue=4)  # not started: nothing drains
    futs = [eng.submit({"x": np.float32(i)}) for i in range(4)]
    with pytest.raises(OverloadedError) as ei:
        eng.submit({"x": np.float32(99)})
    assert ei.value.queue_depth == 4 and ei.value.max_queue == 4
    st = eng.stats()
    assert st["shed"] == 1 and st["queue_depth"] == 4
    with eng:
        pass  # stop() drains
    assert [float(f.result(5)["y"]) for f in futs] == [0.0, 1.0, 2.0, 3.0]


def test_stop_without_drain_fails_queued_requests():
    eng = _mk_engine()
    fut = eng.submit({"x": np.float32(1)})
    eng.stop(drain=False)
    with pytest.raises(EngineStoppedError):
        fut.result(5)
    with pytest.raises(EngineStoppedError):
        eng.submit({"x": np.float32(2)})


def test_swap_params_mid_traffic_zero_dropped():
    """Every request completes, and every result comes from exactly one of
    the param versions (no torn batch, no dropped future)."""
    eng = _mk_engine(max_batch=4, max_wait_ms=1.0, max_queue=4096)
    n = 200
    futs = []
    with eng:
        for i in range(n):
            futs.append(eng.submit({"x": np.float32(1.0)}))
            if i % 20 == 10:
                eng.swap_params({"w": torch.tensor(float(i))})
            if i % 7 == 0:
                time.sleep(0.001)
        res = [float(f.result(30)["y"]) for f in futs]
    assert len(res) == n
    valid = {1.0} | {float(i) for i in range(n) if i % 20 == 10}
    assert set(res) <= valid, sorted(set(res) - valid)
    assert eng.stats()["reloads"] == len(valid) - 1


def test_bad_batch_fails_its_requests_and_the_loop_survives():
    def forward(params, batch):
        if bool((batch["x"] < 0).any()):
            raise ValueError("negative input")
        return batch["x"] * params

    eng = InferenceEngine(forward, torch.tensor(2.0), device="cpu",
                          max_batch=1, max_wait_ms=0.0)
    with eng:
        bad = eng.submit({"x": np.float32(-1)})
        with pytest.raises(ValueError, match="negative"):
            bad.result(10)
        assert float(eng.infer({"x": np.float32(3)})) == 6.0
    assert eng.stats()["errors"] == 1


def _bert_requests(n, vocab, seq, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        am = np.zeros(seq, np.int32)
        am[:int(rng.integers(1, seq + 1))] = 1
        reqs.append({"input_ids": rng.integers(0, vocab, seq).astype(np.int32),
                     "attention_mask": am})
    return reqs


def test_bert_served_through_for_model_matches_one_request_forwards():
    """The slice's path at tiny size: concurrent clients, ragged lengths,
    each served row equal to a one-request forward of the same module."""
    model = tbert.BertForMLM(tbert.BertConfig.tiny(num_layers=2),
                             device="cpu").eval()
    model.init_weights(torch.Generator().manual_seed(0))
    reqs = _bert_requests(24, 1024, 32)
    results = [None] * len(reqs)
    with InferenceEngine.for_model(model, device="cpu", max_batch=8,
                                   max_wait_ms=2.0) as eng:
        def client(idx):
            for i in idx:
                results[i] = eng.submit(reqs[i]).result(60)

        threads = [threading.Thread(target=client, args=(range(c, 24, 4),))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    with torch.inference_mode():
        for req, got in zip(reqs, results):
            want = model({k: torch.from_numpy(v)[None] for k, v in req.items()})
            assert got.shape == (32, 1024)
            np.testing.assert_allclose(got, want[0].numpy(), atol=1e-4,
                                       rtol=1e-4)
    assert eng.stats()["rows"] == 24


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA error needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(_mul_forward, {"w": torch.tensor(1.0)})


def test_dlstatus_reads_a_port_run(tmp_path):
    """The port writes the shared event schema: the JAX package's dlstatus
    folds a port engine's run into its serving rollup and request traces."""
    from distributeddeeplearningspark_tpu import status
    from distributeddeeplearningspark_tpu.telemetry import trace as jtrace

    eng = _mk_engine(max_batch=4, max_wait_ms=1.0, max_queue=4,
                     workdir=str(tmp_path), name="port")
    with eng:
        for i in range(6):
            eng.infer({"x": np.float32(i)})
        eng.heartbeat_interval_s = 0.0
        eng._maybe_heartbeat()
    shed_eng = _mk_engine(max_queue=1, workdir=str(tmp_path), name="port")
    shed_eng.submit({"x": np.float32(0)})
    with pytest.raises(OverloadedError):
        shed_eng.submit({"x": np.float32(1)})
    shed_eng.stop(drain=True)
    telemetry.reset()

    rep = status.report(str(tmp_path))
    sv = rep["serving"]
    assert sv["engines"] == ["port"]
    assert sv["requests"] == 8 and sv["ok"] == 7 and sv["shed"] == 1
    assert sv["latency_p50_s"] > 0 and sv["mean_batch_size"] >= 1
    from distributeddeeplearningspark_tpu import telemetry as jtele

    anatomy = jtrace.request_anatomy(jtele.read_events(str(tmp_path)))
    assert len(anatomy) == 7
    assert all(not a["incomplete"] and set(a["stages"]) == {"queue", "infer"}
               for a in anatomy)
    assert status.main([str(tmp_path)]) == 0
