"""Measured FLOPs in the port (``metrics.measured_flops_per_step``) on the
CPU, against ``FlopCounterMode``'s count of each kernel's plain version,
against a reckoning of a step's products, against the JAX package's
``compiled_cost`` and across a gloo gang:

- each kernel's FLOP formula (K1 ``flash_fwd_flops``, K2 + K3
  ``flash_bwd_flops`` as the gradients wanted select them, K4
  ``matmul_flops``, K5 none) equals what the mode counts for the plain
  version at the same shapes: causal and not, GQA, padding, segments, the
  head dims the kernels take, ResNet's 1×1 shapes; and the plain attention
  path the models take counts the same;
- ``replicated_matmul`` gives autograd's values bitwise and is counted only
  where asked;
- one step of a tiny Llama LoRA (frozen base: no base dW, layer 0's frozen
  projections no dx and its k no gradient) and of a tiny BERT (every
  product three times) counts exactly their products, reckoned by hand;
- BERT's and LeNet-5's counts against the JAX ``compiled_cost`` of the
  same step: XLA's cost analysis also counts elementwise work (softmax,
  GELU, LayerNorm, the optimizer), so the port's count is lower by that
  share, held within stated bounds;
- a 2-rank gloo gang at ``fsdp=2`` and at ``tensor=2`` (this file is its
  script) counts what one process counts for the whole global batch;
- ``fit(measure_flops=True)`` leaves the parameters bitwise those of a run
  without it.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from distributeddeeplearningspark_tpu_torch import Session, Trainer, metrics, telemetry
from distributeddeeplearningspark_tpu_torch.data import text as ttext
from distributeddeeplearningspark_tpu_torch.models import bert as tbert
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models.lenet import LeNet5
from distributeddeeplearningspark_tpu_torch.ops import attention as tattention
from distributeddeeplearningspark_tpu_torch.ops import conv_bn, scatter_rows
from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset
from distributeddeeplearningspark_tpu_torch.session import DEVICE_CONF
from distributeddeeplearningspark_tpu_torch.train import losses, optim

from test_torch_deadline import per_test
from test_torch_dist import run_gang

#: the tiny Llama's batch: rows, tokens a row, LoRA rank
B, S, RANK = 4, 32, 4
#: the gangs: their session's mesh conf
GANGS = {"fsdp": {"mesh.data": 1, "mesh.fsdp": -1},
         "tensor": {"mesh.data": 1, "mesh.fsdp": -1, "mesh.tensor": 2}}


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


def _count(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


def _qkv(b, s, h, hkv, d, *, needs=(False, False, False), seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, n, d, generator=g).requires_grad_(w)
            for n, w in ((h, needs[0]), (hkv, needs[1]), (hkv, needs[2]))]


# -- each kernel's formula against its plain version --------------------------------

ATTN_CASES = {
    "plain": dict(b=2, s=24, h=4, hkv=4, d=64, causal=False),
    "causal": dict(b=2, s=24, h=4, hkv=4, d=64, causal=True),
    "causal_gqa_d128": dict(b=1, s=40, h=8, hkv=2, d=128, causal=True),
    "padding": dict(b=3, s=16, h=2, hkv=1, d=64, causal=False, pad=True),
    "segments": dict(b=2, s=32, h=4, hkv=2, d=64, causal=True, segs=True),
}


def _operands(c):
    b, s = c["b"], c["s"]
    kv_mask = q_segs = None
    if c.get("pad"):
        kv_mask = (torch.arange(s)[None, :] < torch.tensor([s, s - 5, 3])[:, None]
                   ).to(torch.int32)
    if c.get("segs"):
        q_segs = (torch.arange(s)[None, :] >= s // 3).to(torch.int32).expand(b, s)
        q_segs = q_segs.contiguous()
    return dict(kv_mask=kv_mask, q_segs=q_segs, kv_segs=q_segs,
                scale=c["d"] ** -0.5, causal=c["causal"])


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_k1_formula_is_the_plain_forward_count(case):
    c = ATTN_CASES[case]
    q, k, v = _qkv(c["b"], c["s"], c["h"], c["hkv"], c["d"])
    got = _count(lambda: fa.flash_attention_reference(q, k, v, **_operands(c)))
    assert got == metrics.flash_fwd_flops(c["b"], c["s"], c["s"], c["h"], c["d"])


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, True),
                                   (False, False, True), (True, True, False)])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_k2_k3_formula_is_the_plain_backward_count(case, needs):
    """Autograd's backward of the plain version computes dP, dQ, dK, dV as
    the inputs want gradients; the formula K2 and K3 note is the same."""
    c = ATTN_CASES[case]
    q, k, v = _qkv(c["b"], c["s"], c["h"], c["hkv"], c["d"], needs=needs)
    o, _ = fa.flash_attention_reference(q, k, v, **_operands(c))
    g = torch.randn_like(o)
    got = _count(lambda: o.backward(g))
    one = metrics.flash_bwd_flops(c["b"], c["s"], c["s"], c["h"], c["d"]) // 4
    want = one * (fa._bwd_products(needs, "dP", "dQ")
                  + fa._bwd_products(needs, "dK", "dV"))
    assert got == want
    if needs == (True, True, True):
        assert got == metrics.flash_bwd_flops(c["b"], c["s"], c["s"], c["h"], c["d"])


@pytest.mark.parametrize("case", ["plain", "causal", "causal_gqa_d128"])
def test_the_plain_attention_path_counts_what_the_kernels_note(case):
    """The models' plain path (``impl="xla"``), forward and backward, counts
    K1's and K2 + K3's formulas: the route does not change the count."""
    c = ATTN_CASES[case]
    q, k, v = _qkv(c["b"], c["s"], c["h"], c["hkv"], c["d"], needs=(True, True, True))
    o = []
    fwd = _count(lambda: o.append(tattention.dot_product_attention(
        q, k, v, causal=c["causal"], impl="xla")))
    bwd = _count(lambda: o[0].backward(torch.ones_like(o[0])))
    shape = (c["b"], c["s"], c["s"], c["h"], c["d"])
    assert fwd == metrics.flash_fwd_flops(*shape)
    assert bwd == metrics.flash_bwd_flops(*shape)


@pytest.mark.parametrize("m,k,n", [(64, 32, 16), (128, 64, 256), (392, 256, 64),
                                   (48, 13, 24)])
def test_k4_formula_is_the_plain_product(m, k, n):
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g)
    assert _count(lambda: conv_bn.matmul_stats_reference(x, w)) == \
        metrics.matmul_flops(m, k, n)


def test_k5_counts_nothing_as_index_add_counts_nothing():
    table = torch.zeros(50, 8)
    idx = torch.tensor([3, 7, 49, -1, 50])
    upd = torch.ones(5, 8)
    assert _count(lambda: scatter_rows.scatter_add_rows(table, idx, upd)) == 0
    assert _count(lambda: table.index_add_(0, idx[:3], upd[:3])) == 0


# -- the counter ------------------------------------------------------------------------


def test_counting_adds_the_kernels_notes_to_the_modes_count():
    x, w = torch.randn(8, 4), torch.randn(4, 2)
    with metrics.counting_flops() as n:
        x @ w
        metrics.note_kernel_flops(1000)
    assert n["flops"] == metrics.matmul_flops(8, 4, 2) + 1000
    metrics.note_kernel_flops(5)  # outside a count: nothing to add to
    with pytest.raises(RuntimeError, match="nest"):
        with metrics.counting_flops():
            with metrics.counting_flops():
                pass


@pytest.mark.parametrize("counted", [True, False])
def test_replicated_matmul_is_autograds_and_counted_where_asked(counted):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 5, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 4, generator=g, requires_grad=True)
    gy = torch.randn(3, 5, 4, generator=g)
    with metrics.counting_flops() as n:
        y = metrics.replicated_matmul(x, w, counted=counted)
        y.backward(gy)
    dx, dw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    y0 = x @ w
    y0.backward(gy)
    assert torch.equal(y, y0) and torch.equal(dx, x.grad) and torch.equal(dw, w.grad)
    assert n["flops"] == (3 * metrics.matmul_flops(15, 16, 4) if counted else 0)


#: one remat LoRA step on the CPU, its peak resident bytes over the model's
#: (a process of its own each): plain, counted, and under FlopCounterMode
#: as it is, whose module tracker holds each module's inputs and outputs
PEAK_PROBE = """
import resource, sys, torch
from distributeddeeplearningspark_tpu_torch import metrics
from distributeddeeplearningspark_tpu_torch.models import llama
from distributeddeeplearningspark_tpu_torch.train import losses
from torch.utils.flop_counter import FlopCounterMode
torch.set_num_threads(1)
cfg = llama.LlamaConfig.tiny(hidden_size=512, num_layers=8, num_heads=8, num_kv_heads=8,
                             intermediate_size=1408, vocab_size=2048, max_position=512,
                             lora_rank=8, remat=True)
m = llama.LlamaForCausalLM(cfg, device="cpu")
m.init_weights(torch.Generator().manual_seed(0))
for n, p in m.named_parameters():
    p.requires_grad_(llama.lora_trainable(n))
ids = torch.randint(0, 2048, (4, 512), generator=torch.Generator().manual_seed(1))
ctx = {"plain": __import__("contextlib").nullcontext, "counted": metrics.counting_flops,
       "mode": lambda: FlopCounterMode(display=False)}[sys.argv[1]]
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
with ctx():
    losses.causal_lm(m({"input_ids": ids}), {"input_ids": ids})[0].backward()
print(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - base)
"""


def test_a_counted_remat_step_keeps_the_plain_steps_peak():
    """The counter drops ``FlopCounterMode``'s module tracker: under it a
    remat step's activations stay alive (a 7B LoRA step on the card
    peaked at 35.9 GB against 20.9 without); counted, the step's peak
    stays well below the tracker's (near the plain step's)."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    procs = {how: subprocess.Popen([sys.executable, "-c", PEAK_PROBE, how], cwd=root,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True)
             for how in ("plain", "counted", "mode")}
    peak = {}
    try:
        for how, proc in procs.items():
            out, err = proc.communicate(timeout=180)
            assert proc.returncode == 0, err[-2000:]
            peak[how] = int(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    # resident bytes move with the machine's load, the tracker's held
    # activations by 2-3× the plain step's: held against the tracker's run
    assert peak["counted"] < 0.75 * peak["mode"], peak


# -- a step's count against its products ---------------------------------------------------


def _llama_dataset(n: int = 8, seed: int = 3) -> PartitionedDataset:
    rng = np.random.default_rng(seed)
    return PartitionedDataset.parallelize(
        [{"input_ids": rng.integers(0, 512, S).astype(np.int32)} for _ in range(n)], 2)


def _llama_trainer(spark, *, remat: bool = False, **kw) -> Trainer:
    cfg = tllama.LlamaConfig.tiny(lora_rank=RANK, remat=remat)
    model = tllama.LlamaForCausalLM(cfg, device=spark.device)
    model.init_weights(torch.Generator().manual_seed(0))
    tx = optim.masked(optim.adamw(1e-3), tllama.lora_trainable)
    return Trainer(spark, model, losses.causal_lm, tx,
                   trainable=tllama.lora_trainable, **kw)


def _llama_reckoning(cfg, b: int, s: int) -> int:
    """One LoRA step's products (2 flops a multiply-add). Forward: every
    projection, the adapters (x·A, then ·B), the attention's QKᵀ and PV at
    the q heads, the head. Backward (frozen base): dx of every projection
    whose input wants a gradient, dP/dQ/dK/dV as q, k, v want them, the
    adapters' four products (three where their input wants none). Layer
    0's input (the frozen embedding's rows) wants no gradient: its wq/wk/wv
    products get no backward and its k (no adapter on wk) none."""
    n, h, i, v, r = b * s, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.lora_rank
    kvh = cfg.num_kv_heads * cfg.head_dim
    mm = lambda m_, k_, n_: 2 * m_ * k_ * n_  # noqa: E731
    attn = 2 * b * cfg.num_heads * s * s * cfg.head_dim  # one product
    proj = {"wq": (h, h), "wk": (h, kvh), "wv": (h, kvh), "wo": (h, h),
            "gate": (h, i), "up": (h, i), "down": (i, h)}
    total = mm(n, h, v) * 2  # the head forward, its dx (frozen: no dW)
    for layer in range(cfg.num_layers):
        first = layer == 0
        for name, (fi, fo) in proj.items():
            total += mm(n, fi, fo)  # forward
            if not (first and name in ("wq", "wk", "wv")):
                total += mm(n, fi, fo)  # dx
            if name in cfg.lora_targets:
                total += mm(n, fi, r) + mm(n, r, fo)  # x·A, (x·A)·B
                total += 2 * mm(n, r, fo)  # d(x·A), dB
                total += mm(n, fi, r) * (1 if first else 2)  # dA; dx through A
        total += 2 * attn  # QKᵀ, PV
        total += attn * (3 if first else 4)  # dP, dQ, (dK), dV
    return total


def test_a_tiny_llama_lora_step_counts_its_products_exactly():
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    trainer = _llama_trainer(spark)
    trainer.fit(_llama_dataset().repeat(), batch_size=B, steps=1, measure_flops=True)
    assert trainer._train_step.flops_per_step == \
        _llama_reckoning(trainer.model.cfg, B, S)


def test_remat_adds_the_recomputed_forward():
    """Remat's recompute is counted, as XLA counts it: the checkpointed
    layers' forward products run again in the backward, all but each
    layer's last (``down``): torch's non-reentrant checkpoint stops
    recomputing once it has remade every tensor the backward saved, and
    ``down``'s output is saved by none."""
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    counts = {}
    for remat in (False, True):
        trainer = _llama_trainer(spark, remat=remat)
        trainer.fit(_llama_dataset().repeat(), batch_size=B, steps=1, measure_flops=True)
        counts[remat] = trainer._train_step.flops_per_step
    cfg = tllama.LlamaConfig.tiny(lora_rank=RANK)
    down = cfg.num_layers * 2 * B * S * cfg.intermediate_size * cfg.hidden_size
    assert counts[True] - counts[False] == _layers_forward(cfg) - down


def _layers_forward(cfg) -> int:
    """The layers' forward products of one step (what remat recomputes)."""
    n, h, i, r = B * S, cfg.hidden_size, cfg.intermediate_size, cfg.lora_rank
    kvh = cfg.num_kv_heads * cfg.head_dim
    mm = lambda m_, k_, n_: 2 * m_ * k_ * n_  # noqa: E731
    one = (mm(n, h, h) * 2 + mm(n, h, kvh) * 2 + mm(n, h, i) * 2 + mm(n, i, h)
           + mm(n, h, r) + mm(n, r, h) + mm(n, h, r) + mm(n, r, kvh)
           + 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim)
    return cfg.num_layers * one


BERT_SEQ, BERT_BATCH, BERT_PRED = 32, 4, 10


def _bert_corpus(text_mod):
    docs = text_mod.synthetic_wikipedia(48, num_partitions=2, seed=1)
    tok = text_mod.WordPieceTokenizer.train(docs.collect(), vocab_size=64)
    return text_mod.mlm_dataset(docs, tok, seq_len=BERT_SEQ, max_predictions=BERT_PRED,
                                **({"num_workers": 0} if text_mod is not ttext else {}))


def _bert_count() -> tuple[int, tbert.BertConfig]:
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    cfg = tbert.BertConfig.tiny(num_layers=1, dropout_rate=0.0, max_position=BERT_SEQ)
    model = tbert.BertForMLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Trainer(spark, model, losses.masked_lm, optim.adamw(1e-3))
    trainer.fit(_bert_corpus(ttext).repeat(), batch_size=BERT_BATCH, steps=1,
                measure_flops=True)
    return trainer._train_step.flops_per_step, cfg


def test_a_tiny_bert_step_counts_three_times_its_forward_products():
    """Every param trains and the embeddings' rows want gradients: each
    product has its dx and its dW, each attention product its two
    gradients; the MLM head runs on the ``max_predictions`` positions."""
    flops, cfg = _bert_count()
    n, p = BERT_BATCH * BERT_SEQ, BERT_BATCH * BERT_PRED
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    d = h // cfg.num_heads
    fwd = cfg.num_layers * (2 * n * h * h * 4 + 2 * n * h * i * 2
                            + 2 * 2 * BERT_BATCH * cfg.num_heads * BERT_SEQ ** 2 * d)
    fwd += 2 * p * h * h + 2 * p * h * v
    assert flops == 3 * fwd


# -- against the JAX package's compiled_cost ---------------------------------------------

#: the port's count over XLA's for the same step. XLA's cost analysis also
#: counts the elementwise work the mode does not: the softmax over S², GELU,
#: LayerNorm, the loss and AdamW over every param for this tiny BERT (the
#: port's count is 0.935 of XLA's), ReLU, pooling, the loss and SGD for
#: LeNet-5 (0.956); the bounds hold that gap to about ±1.5%
BERT_RATIO = (0.92, 0.95)
LENET_RATIO = (0.94, 0.97)


def test_bert_count_against_jax_compiled_cost():
    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.data import text as jtext
    from distributeddeeplearningspark_tpu.models import bert as jbert
    from distributeddeeplearningspark_tpu.train import losses as jlosses
    from distributeddeeplearningspark_tpu.train import optim as joptim

    jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    jcfg = jbert.BertConfig.tiny(num_layers=1, dropout_rate=0.0, max_position=BERT_SEQ)
    jt = JTrainer(jspark, jbert.BertForMLM(jcfg), jlosses.masked_lm, joptim.adamw(1e-3))
    jt.fit(_bert_corpus(jtext).repeat(), batch_size=BERT_BATCH, steps=1,
           measure_flops=True)
    jflops = jt._train_step.flops_per_step
    jspark.stop()
    flops, _ = _bert_count()
    assert BERT_RATIO[0] <= flops / jflops <= BERT_RATIO[1], (flops, jflops)


def _images(n: int = 16, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(0, 1, (28, 28, 1)).astype(np.float32),
             "label": np.int32(i % 10)} for i in range(n)]


def test_lenet_count_against_jax_compiled_cost():
    import optax

    from distributeddeeplearningspark_tpu import PartitionedDataset as JDataset
    from distributeddeeplearningspark_tpu import Session as JSession
    from distributeddeeplearningspark_tpu import Trainer as JTrainer
    from distributeddeeplearningspark_tpu.models import LeNet5 as JLeNet5
    from distributeddeeplearningspark_tpu.train import losses as jlosses

    jspark = JSession.builder.master("local[1]").appName("j").getOrCreate()
    jt = JTrainer(jspark, JLeNet5(), jlosses.softmax_xent, optax.sgd(0.01))
    jt.fit(JDataset.parallelize(_images(), 2).repeat(), batch_size=8, steps=1,
           measure_flops=True)
    jflops = jt._train_step.flops_per_step
    jspark.stop()
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    trainer = Trainer(spark, LeNet5(device="cpu"), losses.softmax_xent, optim.sgd(0.01))
    trainer.fit(PartitionedDataset.parallelize(_images(), 2).repeat(), batch_size=8,
                steps=1, measure_flops=True)
    flops = trainer._train_step.flops_per_step
    assert LENET_RATIO[0] <= flops / jflops <= LENET_RATIO[1], (flops, jflops)


# -- a gang counts one process's count of the global batch ------------------------------


def _gang_rank(outdir: Path, gang: str) -> None:
    builder = Session.builder.appName(f"flops-{gang}")
    for k, v in GANGS[gang].items():
        builder = builder.config(k, v)
    spark = builder.getOrCreate()
    assert spark.backend == "gloo" and spark.world_size == 2
    trainer = _llama_trainer(spark, rules=tllama.llama_rules(
        tllama.LlamaConfig.tiny(lora_rank=RANK), fsdp_min_size=1))
    trainer.fit(_llama_dataset().repeat(), batch_size=B, steps=1, measure_flops=True)
    (outdir / f"{gang}_rank{spark.rank}.json").write_text(json.dumps(dict(
        flops=trainer._train_step.flops_per_step, mesh=spark.mesh.shape,
        sharded=sorted(trainer.shard_dims), split=sorted(trainer.tensor_dims))))
    spark.stop()


@pytest.mark.parametrize("gang", sorted(GANGS))
def test_a_gang_counts_one_process_count_of_the_global_batch(tmp_path, gang):
    res = run_gang(["--master", "local[2]", "--conf", f"{DEVICE_CONF}=cpu",
                    str(Path(__file__).resolve()), str(tmp_path), gang])
    assert res.returncode == 0, res.stderr[-4000:]
    ranks = [json.loads((tmp_path / f"{gang}_rank{r}.json").read_text()) for r in (0, 1)]
    assert ranks[0]["split"] if gang == "tensor" else ranks[0]["sharded"]
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    trainer = _llama_trainer(spark)
    trainer.fit(_llama_dataset().repeat(), batch_size=B, steps=1, measure_flops=True)
    one = trainer._train_step.flops_per_step
    assert ranks[0]["flops"] == ranks[1]["flops"] == one


# -- measure_flops trains the same ------------------------------------------------------------


def test_measure_flops_adds_no_step_and_leaves_the_params_bitwise():
    spark = Session.builder.master("local[1]").config(DEVICE_CONF, "cpu").getOrCreate()
    finals = []
    for measure in (False, True):
        trainer = _llama_trainer(spark, remat=True)
        state, _ = trainer.fit(_llama_dataset().repeat(), batch_size=B, steps=3,
                               log_every=1, measure_flops=measure)
        assert state.step == 3
        finals.append({k: p.detach().clone() for k, p in trainer.model.named_parameters()})
    assert finals[0].keys() == finals[1].keys()
    for k in finals[0]:
        assert torch.equal(finals[0][k], finals[1][k]), k


if __name__ == "__main__":
    _gang_rank(Path(sys.argv[1]), sys.argv[2])
