"""The port's copy of ``utils/memory.py`` against the port's Llama and the
JAX package's module, on the CPU:

- ``llama_param_count`` equals the ``numel`` of the port's Llama, base and
  LoRA apart, exactly (tiny, the 7B on the meta device, the 0.9b MoE, LoRA
  on every target);
- ``llama_memory_report`` equals the JAX package's for the same config,
  batch, sequence and mesh (the port's config has no ``remat_policy``; its
  whole-layer remat reads as JAX's policy None).
"""

import pytest

from distributeddeeplearningspark_tpu.models import llama as jllama
from distributeddeeplearningspark_tpu.utils import memory as jmemory
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.utils import memory as tmemory

from test_torch_deadline import per_test

ALL_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
CONFIGS = {
    "tiny": ("tiny", dict(lora_rank=4)),
    "tiny_all_targets": ("tiny", dict(lora_rank=8, lora_targets=ALL_TARGETS)),
    "tiny_moe": ("tiny", dict(lora_rank=4, moe_experts=4, moe_top_k=2)),
    "7b_lora": ("llama2_7b", dict(lora_rank=16)),
    "7b_full": ("llama2_7b", dict(lora_rank=0)),
}


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _cfgs(name):
    ctor, kw = CONFIGS[name]
    return getattr(tllama.LlamaConfig, ctor)(**kw), getattr(jllama.LlamaConfig, ctor)(**kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_count_is_the_port_models_numel(name):
    tcfg, _ = _cfgs(name)
    model = tllama.LlamaForCausalLM(tcfg, device="meta")
    lora = sum(p.numel() for n, p in model.named_parameters() if tllama.lora_trainable(n))
    base = sum(p.numel() for n, p in model.named_parameters()
               if not tllama.lora_trainable(n))
    assert tmemory.llama_param_count(tcfg) == {"base": base, "lora": lora}


@pytest.mark.parametrize("mesh", [None, {"fsdp": 4}, {"fsdp": 2, "tensor": 2},
                                  {"data": 2, "seq": 2}])
@pytest.mark.parametrize("name", ["tiny", "7b_lora", "7b_full"])
def test_memory_report_equals_jax(name, mesh):
    tcfg, jcfg = _cfgs(name)
    trainable = "lora" if tcfg.lora_rank else "full"
    kw = dict(batch=8, seq=1024, mesh_shape=mesh, trainable=trainable,
              hbm_per_chip_gib=80.0)
    got = tmemory.llama_memory_report(tcfg, **kw)
    want = jmemory.llama_memory_report(jcfg, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.fits(80 * tmemory.GiB) == want.fits(80 * jmemory.GiB)
    assert tmemory.llama_param_count(tcfg) == jmemory.llama_param_count(jcfg)
