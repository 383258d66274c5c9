"""Autoregressive generation for Llama with the KV cache — the port of
``distributeddeeplearningspark_tpu/models/llama_gen.py``.

The model's decode mode (:class:`~.llama.KVCache`, the module docstring of
:mod:`.llama`) serves both calls of a generation: a prefill writes the
whole prompt at index 0 in one pass, then each step appends one token.
Sampling is JAX's: greedy (``temperature=0``), or temperature softmax with
top-k truncation first and then nucleus (top-p) truncation, in which the
first sorted token always survives. Randomness comes from an explicit
``torch.Generator`` seeded from ``seed`` on the model's device, so a run is
reproducible, but it is not JAX's random stream: a sampled run draws other
tokens than JAX's from the same kept set. An ``eos_id`` freezes finished
rows, which emit ``pad_id`` from then on, while the batch keeps stepping.

The loop runs eagerly under ``torch.inference_mode()`` on one card (the
model's): a model with sharded params (FSDP2, tensor parallelism) or on a
pipeline is refused, since ``inference_mode`` and FSDP2 do not mix
(ROADMAP Queue 3 item 7) and generation with sharded params is ROADMAP
Queue 1 item 8's remainder. Equal-length prompts per batch (the shared
cache index of JAX's design; the continuous-batching server,
:mod:`..serve.generate`, keys each row at its own index).
"""

from __future__ import annotations

import dataclasses

import torch

from distributeddeeplearningspark_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    LlamaForCausalLM,
)
from distributeddeeplearningspark_tpu_torch.parallel.sharding import is_sharded


def _sample(logits: torch.Tensor, generator: torch.Generator | None, *,
            temperature: float, top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """[B, V] f32 logits → [B] int32 token ids (JAX's ``_sample``).

    ``top_k`` and ``top_p`` compose: k-truncation first, then the smallest
    prefix of the remaining sorted probabilities whose mass reaches
    ``top_p`` (the first token always survives). Greedy ties go to the
    lowest id, as ``jnp.argmax``'s do."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep sorted position j while the mass BEFORE it is < top_p
        keep = (cum - probs) < top_p
        kept_min = torch.where(keep, sorted_logits, float("inf")).min(
            dim=-1, keepdim=True).values
        logits = torch.where(logits < kept_min, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def decode_model(cfg: LlamaConfig, max_cache_len: int, *, device=None
                 ) -> LlamaForCausalLM:
    """The decode-mode twin of a training config (same param names), its
    params uninitialised on ``device`` (default: meta, for a params dict
    bound with ``load_state_dict(..., assign=True)``)."""
    return LlamaForCausalLM(dataclasses.replace(
        cfg, decode=True, max_cache_len=max_cache_len, attention_impl="xla",
        remat=False), device="meta" if device is None else device)


def _check_lengths(cfg: LlamaConfig, prompt: int, new: int, total: int) -> None:
    if prompt + new > total:
        raise ValueError(
            f"prompt {prompt} + new {new} exceeds max_cache_len {total} "
            f"— cache writes would clamp and corrupt output")
    if total > cfg.max_position:
        raise ValueError(
            f"cache length {total} exceeds max_position {cfg.max_position}")


def _check_one_card(model: LlamaForCausalLM) -> torch.device:
    """The device of a model whose every param is whole on it."""
    if model.pipe is not None or any(is_sharded(p) for p in model.parameters()):
        raise NotImplementedError(
            "generate with sharded params or on a pipeline: gather them into "
            "a one-card model first (ROADMAP Queue 1 item 8)")
    return model.token_embed.weight.device


@torch.inference_mode()
def generate(model: LlamaForCausalLM, input_ids, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: int = 0, eos_id: int | None = None, pad_id: int = 0,
             max_cache_len: int | None = None) -> torch.Tensor:
    """``[B, max_new_tokens]`` int32 continuations of ``input_ids`` [B, T]
    (token 0 from the prefill) on the model's device.

    ``model`` is the training model (its LoRA adapters and int8 base stay
    active; merge first with ``llama_io.merge_lora`` for merged-weight
    speed). Deterministic for ``temperature=0`` (greedy)."""
    cfg = model.cfg
    device = _check_one_card(model)
    ids = torch.as_tensor(input_ids, device=device).long()
    b, t = ids.shape
    total = max_cache_len or (t + max_new_tokens)
    _check_lengths(cfg, t, max_new_tokens, total)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    cache = KVCache.zeros(cfg, b, max_cache_len=total, device=device)
    logits, cache = model({"input_ids": ids}, cache=cache)
    gen = torch.Generator(device=device).manual_seed(seed)
    tok = _sample(logits[:, -1].float(), gen, **sample)
    done = (tok == eos_id) if eos_id is not None else None
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = model({"input_ids": tok[:, None].long()}, cache=cache)
        nxt = _sample(logits[:, -1].float(), gen, **sample)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)
