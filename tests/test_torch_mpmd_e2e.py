"""The MPMD pipeline end to end on threads over real sockets (JAX's
``_run_pipeline_threads`` idiom), against the JAX one-device train step.

The tiny Llama at 6 layers (f32), the weights of JAX's init converted by
``llama_io.params_from_flax``, distinct-token batches from a numpy seed
(b = 8, S = 32, M = 4), AdamW 1e-3, 3 steps: the port's stage runners at 2
and 3 stages, ``exact`` (GPipe, the full-batch loss) and ``sharded`` (1F1B,
the per-microbatch loss), against ``step_lib``'s train step of the whole
model on one device (ROADMAP Queue 3 item 3: the one-device run is the
oracle for pipelines). The per-step losses at :data:`LOSS_RTOL`, and each
updated param, reassembled from the stages, by its change over the 3 steps
(``tests/test_torch_pp.py``'s criterion) at :data:`JAX_CHANGE_RTOL`, and
at :data:`ONE_CARD_CHANGE_RTOL` against the port's own whole model trained
the same 3 steps on one device. Besides: each stage
reckons the activation and gradient bytes it sent, and the spans fold into
the bubble accounting; and the 2-stage ``exact`` run is **bitwise** the
port's one-program GPipe ``Trainer`` at ``pipe=2`` (a 2-rank gloo gang;
this file is its script): the same ops in the same order, per-step losses
and every updated param.

The process-level drills under ``PipelineSupervisor`` are
``tests/test_torch_mpmd_drill.py``.
"""

import json
import os
import socket
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.parallel import mpmd
from distributeddeeplearningspark_tpu_torch.telemetry import fleet as tfleet
from distributeddeeplearningspark_tpu_torch.train import optim
from distributeddeeplearningspark_tpu_torch.train import pipeline_trainer as tpt

from test_torch_deadline import bounded, per_test
from test_torch_dist import run_gang

#: the loss of each step against the JAX one-device step's (f32)
LOSS_RTOL = 1e-5
#: each param's change over the 3 AdamW steps, |Δ_port − Δ_jax| / |Δ_jax|
#: per tensor (test_torch_pp.py's criterion): AdamW's first step is
#: g / (|g| + eps), so where |g| is below eps a rounding of g moves the step
#: by a good part of lr. On these batches the port's own whole model on one
#: device lies 1.54e-3 off JAX's in layers.4.mlp.gate.weight (the MPMD runs
#: 1.57e-3), above test_torch_pp.py's 1e-3 on its batches: one element,
#: whose first gradient (5.8e-9) is the tensor's smallest, carries 99.99%
#: of its square, and the rest agrees within 2e-5
#: (:func:`test_the_one_device_gap_lies_in_a_near_zero_gradient`)
JAX_CHANGE_RTOL = 3e-3
#: Adam's eps (optax's and the port's default): a first gradient below it
#: steps by g / (|g| + eps), not ±1
ADAM_EPS = 1e-8
#: the same against the port's whole model on one device, which the MPMD
#: runs meet within 3.5e-5
ONE_CARD_CHANGE_RTOL = 1e-4
LAYERS, B, T, M, STEPS, SEED, LR = 6, 8, 32, 4, 3, 7, 1e-3


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _batch_fn(vocab: int):
    def batch_fn(step):
        rng = np.random.default_rng(100 + step)
        ids = rng.permutation(vocab)[: B * T].reshape(B, T)
        mask = np.ones((B, T), np.float32)
        mask[step % B, -5:] = 0.0  # a few masked targets: the weight is not B·(T−1)
        return {"input_ids": ids.astype(np.int32), "loss_mask": mask}

    return batch_fn


@pytest.fixture(scope="module")
@bounded()
def jax_reference():
    """The JAX one-device train step of the whole 6-layer tiny Llama (optax
    AdamW 1e-3) for STEPS steps: its init (converted), its losses and its
    final params (converted)."""
    import jax
    import optax

    from distributeddeeplearningspark_tpu.data.feed import put_global
    from distributeddeeplearningspark_tpu.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec
    from distributeddeeplearningspark_tpu.parallel.sharding import ShardingRules
    from distributeddeeplearningspark_tpu.train import losses, step as step_lib

    cfg = LlamaConfig.tiny(num_layers=LAYERS)
    batch_fn = _batch_fn(cfg.vocab_size)
    tx = optax.adamw(LR)
    mesh = MeshSpec(data=1).build(jax.devices()[:1])
    model = LlamaForCausalLM(cfg)
    state, sh = step_lib.init_state(model, tx, batch_fn(0), mesh, ShardingRules(),
                                    seed=SEED)
    tcfg = tllama.LlamaConfig.tiny(num_layers=LAYERS)

    def port_names(params):
        return {k: v.numpy().copy() for k, v in tllama_io.params_from_flax(
            jax.tree.map(lambda a: np.array(a), params), tcfg).items()}

    init = port_names(jax.device_get(state.params))
    ts = step_lib.jit_train_step(
        step_lib.make_train_step(model.apply, tx, losses.causal_lm), mesh, sh)
    ref = []
    for s in range(STEPS):
        state, met = ts(state, put_global(batch_fn(s), mesh))
        ref.append(float(jax.device_get(met["loss"])))
    return dict(init=init, losses=ref, final=port_names(jax.device_get(state.params)),
                batch_fn=batch_fn, one_card=_port_one_device(init, batch_fn))


def _port_one_device(init: dict, batch_fn) -> dict:
    """The port's whole model from ``init``, STEPS AdamW steps of
    ``losses.causal_lm`` on the CPU: its final params."""
    import torch

    from distributeddeeplearningspark_tpu_torch.train import losses

    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(num_layers=LAYERS),
                                    device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    tx = optim.adamw(LR, weight_decay=1e-4)
    named = dict(model.named_parameters())
    params = list(named.values())
    opt_state = tx.init(params)
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in batch_fn(s).items()}
        loss, _ = losses.causal_lm(model(batch), batch)
        loss.backward()
        with torch.no_grad():
            updates, opt_state = tx.update([p.grad for p in params], opt_state, params)
            torch._foreach_add_(params, updates)
        for p in params:
            p.grad = None
    return {n: p.detach().numpy().copy() for n, p in named.items()}


def test_the_one_device_gap_lies_in_a_near_zero_gradient(jax_reference):
    """Where the port's one-device run lies off JAX's in
    ``layers.4.mlp.gate.weight``: the elements that carry 99% of the
    squared gap of the 3-step change are few, each with a first-step
    gradient below Adam's eps and among the tensor's smallest 0.1%; without
    them the change agrees within 1e-4 of its size (the port's one-device
    Llama holds JAX's where AdamW's steps do not hang on a rounding)."""
    ref = jax_reference
    name = "layers.4.mlp.gate.weight"
    init = ref["init"][name].ravel()
    d_jax = ref["final"][name].ravel() - init
    d_port = ref["one_card"][name].ravel() - init
    sq = (d_port - d_jax).astype(np.float64) ** 2
    assert 1e-3 < np.sqrt(sq.sum()) / np.linalg.norm(d_jax) <= JAX_CHANGE_RTOL
    order = np.argsort(sq)[::-1]
    carriers = order[:int(np.searchsorted(np.cumsum(sq[order]) / sq.sum(), 0.99)) + 1]
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(num_layers=LAYERS),
                                    device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ref["init"].items()})
    batch = {k: torch.from_numpy(v) for k, v in ref["batch_fn"](0).items()}
    from distributeddeeplearningspark_tpu_torch.train import losses

    losses.causal_lm(model(batch), batch)[0].backward()
    grad = np.abs(dict(model.named_parameters())[name].grad.numpy().ravel())
    listed = {int(i): (float(grad[i]), float(np.sqrt(sq[i]) / LR)) for i in carriers}
    assert len(carriers) <= 4, listed
    smallest = np.quantile(grad, 1e-3)
    assert all(grad[i] < ADAM_EPS and grad[i] <= smallest for i in carriers), listed
    rest = np.ones(init.size, bool)
    rest[carriers] = False
    assert np.sqrt(sq[rest].sum()) <= 1e-4 * np.linalg.norm(d_jax[rest]), listed


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pipeline_threads(make_stage, num_stages: int, *, steps: int, batch_size: int,
                         microbatches: int, batch_fn, seed: int = SEED,
                         ckpt_every: int | None = None, timeout: float = 200) -> dict:
    """Drive ``num_stages`` stage runners on threads over real sockets;
    ``make_stage(stage) -> (program, checkpointer or None)``."""
    ports = [_free_port() for _ in range(num_stages - 1)]
    key = os.urandom(16)
    results: dict = {}
    errors: dict = {}

    def run(stage):
        try:
            program, ckpt = make_stage(stage)
            tr = mpmd.PipelineTransport(stage, num_stages, ports, key,
                                        connect_timeout=60)
            cfg = tpt.StageRunConfig(steps=steps, batch_size=batch_size,
                                     microbatches=microbatches, seed=seed,
                                     checkpoint_every=ckpt_every)
            runner = tpt.PipelineStageRunner(
                program, tr, cfg, batch_fn=batch_fn if stage == 0 else None,
                checkpointer=ckpt)
            results[stage] = runner.run()
        except BaseException as e:  # noqa: BLE001 — reported via assert
            import traceback

            traceback.print_exc()
            errors[stage] = e

    ths = [threading.Thread(target=run, args=(s,)) for s in range(num_stages)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout)
    assert not errors, errors
    assert set(results) == set(range(num_stages))
    return results


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("mode", ["exact", "sharded"])
def test_mpmd_matches_the_jax_one_device_step(jax_reference, stages, mode):
    ref = jax_reference
    tcfg = tllama.LlamaConfig.tiny(num_layers=LAYERS)

    def make_stage(stage):
        return tpt.LlamaStageProgram(
            tcfg, stage, stages, optim.adamw(LR, weight_decay=1e-4), device="cpu",
            mode=mode, loss_mode="full_batch" if mode == "exact" else "per_microbatch",
            init_params=ref["init"]), None

    results = run_pipeline_threads(make_stage, stages, steps=STEPS, batch_size=B,
                                   microbatches=M, batch_fn=ref["batch_fn"])
    np.testing.assert_allclose(results[0]["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert all(results[k]["state"].step == STEPS for k in range(stages))
    got = {}
    for k in range(stages):
        for n, p in results[k]["state"].params.items():
            assert n not in got, f"{n} on two stages"
            got[n] = p.detach().numpy()
    assert set(got) == set(ref["final"])
    for n, want in ref["final"].items():
        change = np.linalg.norm(want - ref["init"][n])
        assert change > 0, n
        assert np.linalg.norm(got[n] - want) <= JAX_CHANGE_RTOL * change, n
        one = ref["one_card"][n]
        assert np.linalg.norm(got[n] - one) <= ONE_CARD_CHANGE_RTOL * np.linalg.norm(
            one - ref["init"][n]), n
    # each link carried M activations forward and M gradients back a step,
    # a microbatch's rows of hidden f32 each
    mb_bytes = B // M * T * tcfg.hidden_size * 4
    for k in range(stages):
        sent = results[k]["stats"]["sent"]
        assert sent["act"] == ([STEPS * M, STEPS * M * mb_bytes] if k < stages - 1
                               else [0, 0]), (k, sent)
        assert sent["grad"] == ([STEPS * M, STEPS * M * mb_bytes] if k > 0
                                else [0, 0]), (k, sent)
        assert len(results[k]["stats"]["lap_s"]) == STEPS


def test_spans_fold_into_the_bubble_accounting(jax_reference, tmp_path):
    """A traced 2-stage run: the port's pipeline_anatomy reads its spans."""
    from distributeddeeplearningspark_tpu_torch import telemetry

    ref = jax_reference
    tcfg = tllama.LlamaConfig.tiny(num_layers=LAYERS)
    telemetry.configure(tmp_path)
    try:
        run_pipeline_threads(
            lambda stage: (tpt.LlamaStageProgram(
                tcfg, stage, 2, optim.adamw(LR, weight_decay=1e-4), device="cpu",
                init_params=ref["init"]), None),
            2, steps=STEPS, batch_size=B, microbatches=M, batch_fn=ref["batch_fn"])
    finally:
        telemetry.reset()
    pl = tfleet.pipeline_anatomy(telemetry.read_events(tmp_path))
    assert pl["m"] == M and pl["p"] == 2 and pl["schedule"] == "gpipe"
    assert pl["theoretical_bubble_frac"] == pytest.approx(tpt.theoretical_bubble(M, 2))
    assert pl["measured_bubble_frac"] is not None
    assert pl["microbatch_traces"] == STEPS * M


# -- exact mode is the one-program GPipe step, bitwise -----------------------------


def _gpipe_worker(outdir: Path) -> None:
    """One rank of the pipe=2 gang: the port's GPipe ``Trainer`` on the
    converted JAX init and the same batches; each rank writes its losses
    and its stage's params."""
    from distributeddeeplearningspark_tpu_torch import Session, Trainer
    from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
    from distributeddeeplearningspark_tpu_torch.train import losses

    spark = (Session.builder.appName("mpmd-gpipe").config("mesh.data", 1)
             .config("mesh.pipe", 2).getOrCreate())
    cfg = tllama.LlamaConfig.tiny(num_layers=LAYERS)
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in np.load(outdir / "init.npz").items()})
    trainer = Trainer(spark, model, losses.causal_lm, optim.adamw(LR, weight_decay=1e-4),
                      rules=tllama.llama_rules(cfg, pipeline=True),
                      pipeline_microbatches=M)
    batch_fn = _batch_fn(cfg.vocab_size)
    rows = [{k: v[i] for k, v in batch_fn(s).items()} for s in range(STEPS) for i in range(B)]
    logged: list = []
    trainer.fit(PartitionedDataset.parallelize(rows, 1), batch_size=B, steps=STEPS,
                log_every=1, callbacks=[lambda step, m: logged.append(m["loss"])])
    stage = spark.mesh.pipe_index
    owned = {n for n, _ in trainer.model.named_parameters()
             if not n.startswith("layers.") or int(n.split(".")[1]) // (LAYERS // 2) == stage}
    np.savez(outdir / f"params_rank{spark.rank}.npz",
             **{n: p.detach().numpy() for n, p in trainer.model.named_parameters()
                if n in owned})
    (outdir / f"rank{spark.rank}.json").write_text(json.dumps({"losses": logged}))
    spark.stop()


def test_exact_mode_is_the_gpipe_trainer_bitwise(jax_reference, tmp_path):
    from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF

    ref = jax_reference
    np.savez(tmp_path / "init.npz", **ref["init"])
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(tmp_path)])
    assert res.returncode == 0, res.stderr[-4000:]
    tcfg = tllama.LlamaConfig.tiny(num_layers=LAYERS)
    results = run_pipeline_threads(
        lambda stage: (tpt.LlamaStageProgram(
            tcfg, stage, 2, optim.adamw(LR, weight_decay=1e-4), device="cpu",
            init_params=ref["init"]), None),
        2, steps=STEPS, batch_size=B, microbatches=M, batch_fn=ref["batch_fn"])
    gpipe = [json.loads((tmp_path / f"rank{r}.json").read_text())["losses"] for r in (0, 1)]
    assert gpipe[0] == gpipe[1]
    assert [np.float32(x).tobytes() for x in results[0]["losses"]] == \
        [np.float32(x).tobytes() for x in gpipe[0]]
    for k in (0, 1):
        want = dict(np.load(tmp_path / f"params_rank{k}.npz"))
        got = {n: p.detach().numpy() for n, p in results[k]["state"].params.items()}
        # the GPipe stages also hold the replicated head and embedding;
        # each MPMD stage holds its own share of them only
        assert set(got) <= set(want)
        for n, g in got.items():
            assert g.tobytes() == want[n].tobytes(), n


if __name__ == "__main__":
    _gpipe_worker(Path(sys.argv[1]))
