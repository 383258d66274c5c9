"""``Trainer.fit`` and ``Trainer.evaluate`` of the port against the JAX
``Trainer`` on a one-device CPU session: the same synthetic corpus through
each package's ``mlm_dataset``, a tiny BERT started from the same weights
(the JAX trainer's init carried across by ``params_from_flax``), dropout 0,
f32. The logged losses come from each run's ``step_metrics`` telemetry,
which the JAX package's status reader also reads for the port's run."""

import math

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu import Session as JSession
from distributeddeeplearningspark_tpu import Trainer as JTrainer
from distributeddeeplearningspark_tpu import status
from distributeddeeplearningspark_tpu import telemetry as jtele
from distributeddeeplearningspark_tpu.data import text as jtext
from distributeddeeplearningspark_tpu.models import bert as jbert
from distributeddeeplearningspark_tpu.train import losses as jlosses
from distributeddeeplearningspark_tpu.train import optim as joptim
from distributeddeeplearningspark_tpu_torch import Session, Trainer, TrainState
from distributeddeeplearningspark_tpu_torch import telemetry as ttele
from distributeddeeplearningspark_tpu_torch.data import text as ttext
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.models.bert_io import params_from_flax
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses as tlosses
from distributeddeeplearningspark_tpu_torch.train import optim as toptim
from test_torch_deadline import bounded, per_test

SEQ, BATCH, STEPS, LOG_EVERY = 64, 4, 6, 2
# f32 on both sides; the residue is summation order, compounded over the
# steps through Adam (which magnifies noise in near-zero gradients)
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _corpus(text_mod):
    docs = text_mod.synthetic_wikipedia(48, num_partitions=2, seed=1)
    tok = text_mod.WordPieceTokenizer.train(docs.collect(), vocab_size=64)
    return docs, tok


def _step_metrics(workdir):
    return [(e["step"], e["metrics"]) for e in jtele.read_events(str(workdir))
            if e["kind"] == "step_metrics"]


@pytest.fixture(scope="module")
@bounded()
def runs(tmp_path_factory):
    """One JAX run and one port run: (JAX workdir, port workdir, JAX eval,
    port eval, port state, port summary)."""
    root = tmp_path_factory.mktemp("runs")
    cfg_kw = dict(num_layers=2, dropout_rate=0.0, max_position=SEQ)
    mp = pytest.MonkeyPatch()
    try:
        jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
        jdocs, jtok = _corpus(jtext)
        jds = jtext.mlm_dataset(jdocs, jtok, seq_len=SEQ, max_predictions=10,
                                num_workers=0)
        jtrainer = JTrainer(jspark, jbert.BertForMLM(jbert.BertConfig.tiny(**cfg_kw)),
                            jlosses.masked_lm,
                            joptim.with_grad_clip(joptim.adamw(
                                joptim.warmup_linear(2e-3, 2, STEPS)), 1.0))
        jtrainer.init(jtrainer._sample_batch(jds, BATCH))
        params = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
        jeval = jtrainer.evaluate(jds, batch_size=3)
        mp.setenv(jtele.WORKDIR_ENV, str(root / "jax"))
        jtrainer.fit(jds.repeat(), batch_size=BATCH, steps=STEPS,
                     tokens_per_example=SEQ, log_every=LOG_EVERY)
        jtele.reset()
        jspark.stop()

        spark = Session.builder.master("local[1]").appName("t").config(
            DEVICE_CONF, "cpu").getOrCreate()
        tdocs, ttok = _corpus(ttext)
        tds = ttext.mlm_dataset(tdocs, ttok, seq_len=SEQ, max_predictions=10)
        model = tbert.BertForMLM(tbert.BertConfig.tiny(**cfg_kw), device="cpu")
        model.load_state_dict(params_from_flax(params))
        trainer = Trainer(spark, model, tlosses.masked_lm,
                          toptim.with_grad_clip(toptim.adamw(
                              toptim.warmup_linear(2e-3, 2, STEPS)), 1.0))
        teval = trainer.evaluate(tds, batch_size=3)
        mp.setenv(ttele.WORKDIR_ENV, str(root / "port"))
        state, summary = trainer.fit(tds.repeat(), batch_size=BATCH, steps=STEPS,
                                     tokens_per_example=SEQ, log_every=LOG_EVERY)
        ttele.reset()
        spark.stop()
    finally:
        mp.undo()
    return root / "jax", root / "port", jeval, teval, state, summary


def test_fit_logs_the_jax_losses(runs):
    jdir, tdir, *_ = runs
    want, got = _step_metrics(jdir), _step_metrics(tdir)
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4, 6]
    for (_, tm), (_, jm) in zip(got, want):
        assert set(tm) == set(jm) == {"loss", "mlm_accuracy", "grad_norm"}
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=RTOL)
    assert got[-1][1]["loss"] < got[0][1]["loss"]


def test_evaluate_matches_jax_with_a_tail_batch(runs):
    """Same weights, the whole finite dataset in batches of 3 (a short tail
    batch), combined by the loss's weight on both sides."""
    *_, jeval, teval, _, _ = runs
    assert set(teval) == set(jeval) == {"loss", "mlm_accuracy"}
    for k in jeval:
        np.testing.assert_allclose(teval[k], jeval[k], rtol=RTOL)


def test_fit_returns_state_and_meter_summary(runs):
    *_, state, summary = runs
    assert isinstance(state, TrainState) and state.step == STEPS
    assert {"step_time_ms", "tokens_per_sec_per_chip", "loss",
            "grad_norm"} <= set(summary)
    assert summary["tokens_per_sec_per_chip"] == pytest.approx(
        BATCH * SEQ / (summary["step_time_ms"] / 1e3))


def test_status_reader_reads_a_port_training_run(runs):
    _, tdir, *_ = runs
    rep = status.report(str(tdir))
    assert rep["last_step"] == STEPS and rep["num_events"] > 0
    kinds = {e["kind"] for e in jtele.read_events(str(tdir))}
    assert {"phase", "step_metrics", "heartbeat"} <= kinds
    assert status.main([str(tdir)]) == 0


def _tiny_trainer(loss_fn=tlosses.masked_lm):
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    model = tbert.BertForMLM(tbert.BertConfig.tiny(num_layers=1, max_position=SEQ),
                             device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    docs, tok = _corpus(ttext)
    ds = ttext.mlm_dataset(docs, tok, seq_len=SEQ, max_predictions=10).repeat()
    return spark, Trainer(spark, model, loss_fn,
                          toptim.adamw(1e-3)), ds


def test_fit_raises_on_a_non_finite_loss():
    def nan_loss(out, batch):
        loss, m = tlosses.masked_lm(out, batch)
        loss = loss * float("nan")
        return loss, {**m, "loss": loss}

    spark, trainer, ds = _tiny_trainer(nan_loss)
    try:
        with pytest.raises(FloatingPointError, match="step 2"):
            trainer.fit(ds, batch_size=2, steps=4, log_every=2)
    finally:
        spark.stop()


def test_fit_is_seeded_through_the_dropout_generator():
    """Two trainers with the same seed and weights log the same losses with
    dropout on; the state's generator is the one the masks came from."""
    losses = []
    for _ in range(2):
        spark, trainer, ds = _tiny_trainer()
        try:
            state, summary = trainer.fit(ds, batch_size=2, steps=2, log_every=1)
        finally:
            spark.stop()
        assert state.generator.initial_seed() == 0
        losses.append(summary["loss"])
    assert losses[0] == losses[1] and math.isfinite(losses[0])


def test_trainer_refuses_a_model_off_the_session_device():
    """A model whose params lie off the session's device is refused; one on
    the meta device is refused unless it can draw its weights
    (``init_weights``), and then it is materialised on the session's
    device with the weights of the same model built there."""
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    try:
        model = torch.nn.Linear(4, 4, device="meta")
        with pytest.raises(ValueError, match="session's device"):
            Trainer(spark, model, tlosses.masked_lm, toptim.adamw(1e-3))
        cfg = tbert.BertConfig.tiny(num_layers=1)
        model = tbert.BertForMLM(cfg, device="meta")
        trainer = Trainer(spark, model, tlosses.masked_lm, toptim.adamw(1e-3), seed=3)
        eager = tbert.BertForMLM(cfg, device="cpu").init_weights(
            torch.Generator().manual_seed(3))
        for (n, p), (_, q) in zip(trainer.model.named_parameters(),
                                  eager.named_parameters()):
            assert p.device.type == "cpu" and torch.equal(p, q), n
    finally:
        spark.stop()


# -- Llama LoRA: trainable, accum_steps -------------------------------------------

LLAMA_SEQ, LLAMA_BATCH, LLAMA_STEPS = 64, 4, 6


def _lora_tx(optim_mod, llama_mod):
    return optim_mod.masked(optim_mod.with_grad_clip(optim_mod.adamw(
        optim_mod.warmup_cosine(1e-2, 1, LLAMA_STEPS)), 1.0), llama_mod.lora_trainable)


@pytest.fixture(scope="module")
@bounded()
def lora_runs(tmp_path_factory):
    """The tiny Llama's LoRA fine-tune (the config-5 driver's optimizer,
    ``trainable=lora_trainable``, ``accum_steps=2``, packed documents with
    segment ids) through the JAX ``Trainer`` and the port's, from the same
    weights: (JAX workdir, port workdir, port trainer, initial params)."""
    from distributeddeeplearningspark_tpu.models import llama as jllama
    from distributeddeeplearningspark_tpu_torch.models import llama as tllama
    from distributeddeeplearningspark_tpu_torch.models.llama_io import (
        params_from_flax as llama_from_flax)

    root = tmp_path_factory.mktemp("lora")
    mp = pytest.MonkeyPatch()
    try:
        jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
        jdocs, jtok = _corpus(jtext)
        jds = jtext.lm_dataset(jdocs, jtok, seq_len=LLAMA_SEQ, segment_ids=True,
                               num_workers=0).repeat()
        jcfg = jllama.LlamaConfig.tiny(vocab_size=64, lora_rank=4)
        jtrainer = JTrainer(jspark, jllama.LlamaForCausalLM(jcfg), jlosses.causal_lm,
                            _lora_tx(joptim, jllama), accum_steps=2,
                            trainable=jllama.lora_trainable)
        jtrainer.init(jtrainer._sample_batch(jds, LLAMA_BATCH))
        params = jax.tree.map(np.asarray, jax.device_get(jtrainer.state.params))
        mp.setenv(jtele.WORKDIR_ENV, str(root / "jax"))
        jtrainer.fit(jds, batch_size=LLAMA_BATCH, steps=LLAMA_STEPS,
                     tokens_per_example=LLAMA_SEQ, log_every=LOG_EVERY)
        jtele.reset()
        jspark.stop()

        spark = Session.builder.master("local[1]").appName("t").config(
            DEVICE_CONF, "cpu").getOrCreate()
        tdocs, ttok = _corpus(ttext)
        tds = ttext.lm_dataset(tdocs, ttok, seq_len=LLAMA_SEQ,
                               segment_ids=True).repeat()
        tcfg = tllama.LlamaConfig.tiny(vocab_size=64, lora_rank=4)
        model = tllama.LlamaForCausalLM(tcfg, device="cpu")
        init = llama_from_flax(params, tcfg)
        model.load_state_dict(init)
        trainer = Trainer(spark, model, tlosses.causal_lm, _lora_tx(toptim, tllama),
                          accum_steps=2, trainable=tllama.lora_trainable)
        mp.setenv(ttele.WORKDIR_ENV, str(root / "port"))
        trainer.fit(tds, batch_size=LLAMA_BATCH, steps=LLAMA_STEPS,
                    tokens_per_example=LLAMA_SEQ, log_every=LOG_EVERY)
        ttele.reset()
        spark.stop()
    finally:
        mp.undo()
    return root / "jax", root / "port", trainer, init


def test_lora_fit_with_accumulation_logs_the_jax_losses(lora_runs):
    jdir, tdir, *_ = lora_runs
    want, got = _step_metrics(jdir), _step_metrics(tdir)
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4, 6]
    for (_, tm), (_, jm) in zip(got, want):
        assert set(tm) == set(jm) == {"loss", "perplexity", "grad_norm"}
        for k in tm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
    assert got[-1][1]["loss"] < got[0][1]["loss"]


def test_lora_fit_trains_the_adapters_only(lora_runs):
    *_, trainer, init = lora_runs
    state = trainer.state
    lora = [n for n in state.params if ".lora_" in n]
    assert len(lora) == 16 and trainer.accum_steps == 2
    adam = state.opt_state[1][0]  # chain(clip, chain(adam, decay, lr))
    assert sum(t.numel() for t in (*adam.mu, *adam.nu)) == \
        2 * sum(state.params[n].numel() for n in lora)
    for n, p in state.params.items():
        moved = not torch.equal(p.detach(), init[n])
        assert moved == (n in lora), n
        assert p.requires_grad == (n in lora) and p.grad is None, n


def test_accum_steps_and_trainable_refusals():
    from distributeddeeplearningspark_tpu_torch.models.dlrm import dlrm, sparse_embed_specs

    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    try:
        model = dlrm(vocab_sizes=(10,) * 26, device="cpu")
        specs = sparse_embed_specs(model)
        with pytest.raises(ValueError, match="accum_steps is not supported"):
            Trainer(spark, model, tlosses.binary_xent, toptim.adamw(1e-3),
                    sparse_embed=specs, accum_steps=2)
        with pytest.raises(ValueError, match="trainable is not supported"):
            Trainer(spark, model, tlosses.binary_xent, toptim.adamw(1e-3),
                    sparse_embed=specs, trainable=lambda n: True)
        trainer = Trainer(spark, model, tlosses.binary_xent, toptim.adamw(1e-3),
                          sparse_embed=specs)
        with pytest.raises(ValueError, match="accum_steps is not supported"):
            trainer.fit(None, batch_size=4, accum_steps=2)
        _, bert, ds = _tiny_trainer()
        bert.accum_steps = 1
        with pytest.raises(ValueError, match="must divide by accum_steps 2"):
            bert.fit(ds, batch_size=3, steps=1, accum_steps=2)
    finally:
        spark.stop()
