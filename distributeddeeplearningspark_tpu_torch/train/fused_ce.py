"""Chunked-vocab softmax cross-entropy fused with the LM head — the port of
``distributeddeeplearningspark_tpu/train/fused_ce.py``.

The plain path makes the model emit f32 logits ``[B, S, V]`` and the loss
take their softmax: two vocab-sized buffers, the logits and their
cotangent in the backward (config 5 at b = 8, S = 1,024: 8·1,024·32,000·4
B = 1.05 GB each). A decoder LM's logits feed one reduction, so neither
needs to exist: :func:`chunked_softmax_xent` takes the per-token loss from
the hidden states before the head and the head's weight, walking the
vocabulary in ``num_chunks`` slices with a running max and sum-exp, and
its backward recomputes each slice's logits (2·N·H·V more FLOPs, for the
memory). Same math as JAX's ``custom_vjp`` (per token n with label ℓ):
``loss_n = lse_n − h_n·W[ℓ_n]``, ``dh = (softmax·g)·W − g·W[ℓ]`` and
``dW = (softmax·g)ᵀ·h − scatter(g·h → rows ℓ)``.

The weight is the port's ``lm_head.weight``, torch's ``[V, H]`` (JAX's
kernel transposed). Every head product takes the hidden dtype's operands
(the weight cast to it) with f32 results, as ``jnp.dot(...,
preferred_element_type=f32)``: one ``mm`` with an f32 output on the card,
f32 operands (the narrower ones' exact values) on the CPU. The backward's
products with the softmax are f32, as JAX's. The vocabulary is cut into
slices of ⌈V / num_chunks⌉ columns, JAX's padded geometry
(:func:`_chunk_geometry`), so a prime vocabulary still chunks; JAX masks
the padded columns to −inf, where they add exp(−inf) = 0 to every sum, so
here the last slices simply hold the real columns left (none past V). No
``[N, V]`` tensor is ever made: the largest is one slice's ``[N, ⌈V/C⌉]``
f32. Duplicate labels sum in ``dW`` (``index_add_``). These are
``torch.mm`` calls, as the JAX module is XLA dots, not a Pallas kernel.

Used by :func:`.losses.causal_lm_fused` with a model that returns its
hidden states and head weight instead of logits
(``LlamaConfig.fused_head_loss``).
"""

from __future__ import annotations

import torch


def is_fused_output(out) -> bool:
    """Is ``out`` the ``{"hidden", "lm_head"}`` dict of a fused-head model?
    (One predicate shared by the loss and the predict paths.)"""
    return isinstance(out, dict) and "hidden" in out and "lm_head" in out


def materialize_logits(out: dict) -> torch.Tensor:
    """A fused-head output's real logits, as the model's head computes them
    (the weight cast to the hidden dtype, the result f32): prediction is
    the one consumer that wants the ``[..., V]`` logits."""
    hidden = out["hidden"]
    return torch.nn.functional.linear(hidden, out["lm_head"].to(hidden.dtype)).float()


def _chunk_geometry(vocab: int, requested: int) -> tuple[int, int]:
    """(num_chunks, columns a chunk): the vocabulary padded up to a chunk
    multiple, JAX's geometry, so every vocabulary size chunks."""
    num_chunks = max(1, min(requested, vocab))
    return num_chunks, -(-vocab // num_chunks)


def _slices(vocab: int, num_chunks: int) -> list[tuple[int, int]]:
    """The real columns ``[lo, hi)`` of each chunk that holds any."""
    num_chunks, per = _chunk_geometry(vocab, num_chunks)
    return [(c * per, min((c + 1) * per, vocab)) for c in range(num_chunks)
            if c * per < vocab]


def _logits(hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``hidden · wᵀ`` (``w`` a slice ``[Vc, H]``) from ``hidden``'s dtype
    with f32 results."""
    w = w.to(hidden.dtype)
    if hidden.dtype != torch.float32 and hidden.is_cuda:
        return torch.mm(hidden, w.t(), out_dtype=torch.float32)
    return hidden.float() @ w.float().t()


class _ChunkedXent(torch.autograd.Function):
    """Per-token loss ``[N]`` f32 of ``hidden`` ``[N, H]``, ``weight``
    ``[V, H]`` and ``labels`` ``[N]``; the backward is JAX's ``_vjp_bwd``
    (``dW`` only where the weight needs a gradient)."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, num_chunks):
        n = hidden.shape[0]
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=hidden.device)
        s = torch.zeros(n, dtype=torch.float32, device=hidden.device)
        for lo, hi in _slices(weight.shape[0], num_chunks):
            logits = _logits(hidden, weight[lo:hi])
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
        lse = m + torch.log(s)
        # the label logit from a row gather of the weight: O(N·H), no vocab dim
        label_logit = (hidden.float() * weight[labels].float()).sum(-1)
        ctx.save_for_backward(hidden, weight, labels, lse)
        ctx.num_chunks = num_chunks
        return lse - label_logit

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, lse = ctx.saved_tensors
        need_dw = ctx.needs_input_grad[1]
        gf = g.float()
        hf = hidden.float()
        dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
        dw = (torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
              if need_dw else None)
        for lo, hi in _slices(weight.shape[0], ctx.num_chunks):
            wc = weight[lo:hi]
            pg = torch.exp(_logits(hidden, wc) - lse[:, None]) * gf[:, None]
            dh += pg @ wc.float()
            if need_dw:
                dw[lo:hi] = pg.t() @ hf
            del pg
        # the label corrections (the −onehot of softmax − onehot)
        dh -= gf[:, None] * weight[labels].float()
        if need_dw:
            dw.index_add_(0, labels, -(hf * gf[:, None]))  # duplicate labels sum
            dw = dw.to(weight.dtype)
        return dh.to(hidden.dtype), dw, None, None


def chunked_softmax_xent(hidden: torch.Tensor, weight: torch.Tensor,
                         labels: torch.Tensor, *, num_chunks: int = 16
                         ) -> torch.Tensor:
    """Per-token cross-entropy of ``softmax(hidden · weightᵀ)`` against
    ``labels``. ``hidden`` ``[..., H]`` (any float dtype; the products give
    f32), ``weight`` ``[V, H]``, ``labels`` ``[...]`` int. Returns the
    per-token loss ``[...]`` f32, the vocabulary walked in ``num_chunks``
    slices (the module docstring)."""
    if weight.dim() != 2 or hidden.shape[-1] != weight.shape[1]:
        raise ValueError(f"weight must be [vocab, hidden={hidden.shape[-1]}], "
                         f"got {tuple(weight.shape)}")
    lead = hidden.shape[:-1]
    if tuple(labels.shape) != tuple(lead):
        raise ValueError(f"labels shape {tuple(labels.shape)} != {tuple(lead)}")
    flat = _ChunkedXent.apply(hidden.reshape(-1, hidden.shape[-1]), weight,
                              labels.reshape(-1).long(), num_chunks)
    return flat.reshape(lead)
