"""The port's sanitizers (``utils/sanitize.py``) against the JAX package's
on the same inputs, and at two ranks: two gloo processes launched by the
port's cli, this file being their script (``python
tests/test_torch_sanitize.py OUTDIR`` per rank; it imports no jax).

Each rank of the gang writes to OUTDIR:

- ``assert_replicas_in_sync`` on equal params (passes) and with rank 1's
  params perturbed by one ulp (``DesyncError`` on both ranks);
- ``fit(sanitize_every=1)`` raising ``DesyncError`` on both ranks at the
  step after a callback desynchronizes rank 1;
- the non-finite guard at 2 ranks: ``DLS_FAULT=nan@3`` on rank 1 only
  (``DLS_FAULT_RANK=1``) under ``on_nonfinite="skip"``; the gradient
  all-reduce carries the NaN to rank 0, so both ranks skip step 3 (and
  only it), keep step 2's params bitwise, and stay in sync.
"""

import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import LeNet5, Session, Trainer
from distributeddeeplearningspark_tpu_torch.data import sources as tsources
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim
from distributeddeeplearningspark_tpu_torch.utils import sanitize
from test_torch_deadline import bounded, per_test
from test_torch_dist import params_digest

GUARD_STEPS = 5


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# -- one process against the JAX package ---------------------------------------


def _tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float64),
                  "d": np.arange(6, dtype=np.int32)}}


def test_tree_fingerprint_matches_jax():
    from distributeddeeplearningspark_tpu.utils import sanitize as jsanitize

    tree = _tree()
    want = jsanitize.tree_fingerprint(tree)
    got = sanitize.tree_fingerprint(
        {"a": torch.from_numpy(tree["a"]),
         "b": {"c": torch.from_numpy(tree["b"]["c"]),
               "d": torch.from_numpy(tree["b"]["d"])}})
    assert got.dtype == np.float64 and got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("metrics", [
    {"loss": 1.0, "acc": 0.5},
    {"loss": float("nan"), "acc": 0.5},
    {"loss": float("inf"), "grad_norm": float("-inf"), "step": 3},
])
def test_nonfinite_checks_match_jax(metrics):
    from distributeddeeplearningspark_tpu.utils import sanitize as jsanitize

    got = sanitize.nonfinite_metrics(metrics)
    want = jsanitize.nonfinite_metrics(metrics)
    assert set(got) == set(want)
    assert all(math.isnan(got[k]) == math.isnan(want[k]) for k in got)
    for mod in (sanitize, jsanitize):
        if want:
            with pytest.raises(FloatingPointError, match="at step 7"):
                mod.assert_all_finite(metrics, step=7)
        else:
            mod.assert_all_finite(metrics, step=7)


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_tree_all_finite_and_checksum_match_jax(poison):
    from distributeddeeplearningspark_tpu.utils import sanitize as jsanitize

    tree = _tree(1)
    if poison:
        tree["a"][1, 2] = float(poison)
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"]),
                   "d": torch.from_numpy(tree["b"]["d"])}}
    assert sanitize.tree_all_finite(ttree) == jsanitize.tree_all_finite(tree) \
        == (poison is None)
    if poison is None:
        np.testing.assert_allclose(sanitize.params_checksum(ttree),
                                   jsanitize.params_checksum(tree), rtol=1e-6)


def test_replica_check_is_a_no_op_outside_a_gang():
    sanitize.assert_replicas_in_sync({"w": torch.ones(4)})


def test_enable_nan_checks_maps_onto_anomaly_detection():
    x = torch.tensor([0.0], requires_grad=True)
    try:
        sanitize.enable_nan_checks(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).backward()
    finally:
        sanitize.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


# -- the gang's script -----------------------------------------------------------


def _lenet_trainer(spark) -> Trainer:
    torch.manual_seed(0)
    return Trainer(spark, LeNet5(device="cpu"), losses.softmax_xent,
                   optim.sgd(0.05, momentum=0.9))


def _mnist(spark):
    return tsources.synthetic_mnist(256, num_partitions=spark.default_parallelism,
                                    seed=1).repeat()


def _worker(outdir: Path) -> None:
    spark = Session.builder.appName("sanitize-gang").getOrCreate()
    rank = spark.rank
    rec: dict = {"world_size": spark.world_size}

    w = torch.linspace(-1.0, 1.0, 33)
    sanitize.assert_replicas_in_sync({"w": w})
    rec["synced_passes"] = True
    skewed = w.clone()
    if rank == 1:
        skewed[7] = torch.nextafter(skewed[7], torch.tensor(2.0))
    try:
        sanitize.assert_replicas_in_sync({"w": skewed})
        rec["desync_caught"] = None
    except sanitize.DesyncError as e:
        rec["desync_caught"] = str(e)

    trainer = _lenet_trainer(spark)

    def desync(step, _metrics):
        if step == 2 and rank == 1:
            with torch.no_grad():
                next(iter(trainer.state.params.values())).add_(1e-3)

    try:
        trainer.fit(_mnist(spark), batch_size=16, steps=4, log_every=1,
                    sanitize_every=1, callbacks=[desync])
        rec["fit_desync"] = None
    except sanitize.DesyncError as e:
        rec["fit_desync"] = (trainer.state.step, str(e))

    os.environ["DLS_FAULT"] = "nan@3"
    os.environ["DLS_FAULT_RANK"] = "1"
    trainer = _lenet_trainer(spark)
    digests, skipped = {}, {}

    def watch(step, metrics):
        digests[step] = params_digest(trainer.state.params)
        skipped[step] = metrics.get("skipped")

    _, summary = trainer.fit(_mnist(spark), batch_size=16, steps=GUARD_STEPS,
                             log_every=1, on_nonfinite="skip", callbacks=[watch])
    sanitize.assert_replicas_in_sync(trainer.state.params)
    rec["guard"] = dict(skipped_steps=summary["skipped_steps"], skipped=skipped,
                        step2_equals_step3=digests[2] == digests[3],
                        step3_equals_step4=digests[3] == digests[4],
                        final=digests[GUARD_STEPS])
    (outdir / f"rank{rank}.json").write_text(json.dumps(rec))
    spark.stop()


# -- the test side ----------------------------------------------------------------


@pytest.fixture(scope="module")
@bounded()
def gang(tmp_path_factory):
    from test_torch_dist import run_gang

    outdir = tmp_path_factory.mktemp("sanitize-gang")
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(outdir)])
    assert res.returncode == 0, res.stderr[-4000:]
    return [json.loads((outdir / f"rank{r}.json").read_text()) for r in (0, 1)]


def test_planted_desync_raises_on_both_ranks(gang):
    for rec in gang:
        assert rec["world_size"] == 2 and rec["synced_passes"]
        assert rec["desync_caught"] and "ranks [1]" in rec["desync_caught"]


def test_sanitize_every_catches_a_desync_at_the_next_step(gang):
    for rec in gang:
        step, msg = rec["fit_desync"]
        assert step == 3 and "desynced" in msg


def test_guard_skips_the_same_step_on_both_ranks(gang):
    guards = [rec["guard"] for rec in gang]
    for g in guards:
        assert g["skipped_steps"] == 1.0
        assert g["skipped"] == {"1": 0.0, "2": 0.0, "3": 1.0, "4": 0.0, "5": 0.0}
        assert g["step2_equals_step3"] and not g["step3_equals_step4"]
    assert guards[0]["final"] == guards[1]["final"]


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
