"""DLRM and Wide-and-Deep recommenders (config 4): the port of
``models/dlrm.py``.

- **One fused table**: the 26 per-feature tables are one
  ``[sum(vocab_sizes), embed_dim]`` f32 parameter, and feature ``i``'s
  local id is shifted by a static offset (:func:`fused_flat_ids`): one
  gather a step.
- The embeddings gather in f32; the MLPs run bf16 matmuls on f32 params,
  as flax ``Dense(dtype=bf16)`` computes them (input, kernel and bias cast
  to bf16, the output in bf16).
- The table trains row-sparsely through :mod:`..train.embed`
  (:func:`sparse_embed_specs`): in train mode the sparse step hands the
  model its gathered rows through ``overrides`` and the lookup is skipped.

Batch dict: ``dense`` ``[B, 13]`` f32, ``sparse`` ``[B, 26]`` int32
(per-feature local ids), ``label`` ``[B]`` {0, 1}. The models return the
CTR logit ``[B]`` f32. The JAX module's sharding rules (``dlrm_rules``,
``EMBEDDING_RULE``, ``ROW_ACCUM_RULE``) arrive with the port's mesh.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

#: Criteo Kaggle/Terabyte schema: 13 dense + 26 categorical
CRITEO_DENSE = 13
CRITEO_SPARSE = 26

# std of a unit normal cut at ±2σ (flax's truncated lecun-normal rescales by it)
_TRUNC_STD = 0.87962566103423978


@functools.lru_cache(maxsize=None)
def _offsets(vocab_sizes: tuple[int, ...], device: torch.device) -> torch.Tensor:
    offsets = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)
    return torch.from_numpy(offsets).to(device)


def fused_flat_ids(vocab_sizes: Sequence[int], sparse_ids: torch.Tensor) -> torch.Tensor:
    """Per-feature local ids ``[B, N]`` → fused-table row ids (static
    offsets), int32 for int32 ids."""
    return sparse_ids + _offsets(tuple(vocab_sizes), sparse_ids.device)[None, :]


class FusedEmbedding(nn.Module):
    """N categorical features → one table ``embedding_table`` ``[sum(vocab),
    D]`` f32 and static offsets. ``override``: pre-gathered vectors ``[B,
    N, D]`` from the row-sparse step; the lookup is then skipped, so no
    dense table gradient exists."""

    def __init__(self, vocab_sizes: Sequence[int], embed_dim: int, *, device=None):
        super().__init__()
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = embed_dim
        self.embedding_table = nn.Parameter(
            torch.empty(sum(self.vocab_sizes), embed_dim, device=device))

    def forward(self, sparse_ids: torch.Tensor,
                override: torch.Tensor | None = None) -> torch.Tensor:
        if override is not None:
            return override
        return self.embedding_table[fused_flat_ids(self.vocab_sizes, sparse_ids)]


class MLP(nn.Module):
    """flax ``MLP``: ``dense_0 … dense_{n-1}`` ``Linear`` layers with f32
    params run in ``dtype``, ReLU after each (the last too when
    ``final_activation``)."""

    def __init__(self, in_features: int, features: Sequence[int], *,
                 dtype: torch.dtype = torch.bfloat16, final_activation: bool = True,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.final_activation = final_activation
        self.num_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_features, f, device=device))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            layer = getattr(self, f"dense_{i}")
            x = F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
                         layer.bias.to(self.dtype))
            if i < self.num_layers - 1 or self.final_activation:
                x = F.relu(x)
        return x


def dot_interaction(bottom: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """DLRM's pairwise-dot interaction: ``bottom`` ``[B, D]``, ``emb`` ``[B,
    N, D]`` → ``bottom`` beside the strict lower triangle of the Gram matrix
    of the N+1 vectors, row-major (``jnp.tril_indices(N+1, k=-1)``'s
    order, which ``torch.tril_indices(N+1, N+1, -1)`` shares)."""
    z = torch.cat([bottom[:, None, :], emb], dim=1)  # [B, N+1, D]
    gram = torch.bmm(z, z.transpose(1, 2))  # [B, N+1, N+1]
    n = z.shape[1]
    li, lj = torch.tril_indices(n, n, -1, device=z.device)
    return torch.cat([bottom, gram[:, li, lj]], dim=1)


def _lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's lecun-normal: a normal of variance 1/fan_in truncated at ±2σ,
    σ rescaled for the truncation; values outside ±2σ are redrawn."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    p.normal_(0.0, std, generator=generator)
    out = p.abs() > 2 * std
    while bool(out.any()):
        p[out] = torch.empty(int(out.sum()), device=p.device).normal_(
            0.0, std, generator=generator)
        out = p.abs() > 2 * std


class _Recommender(nn.Module):
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's initialisers from ``generator``: tables normal with std
        ``1/sqrt(D)``, Dense kernels lecun-normal, biases zero."""
        for m in self.modules():
            if isinstance(m, FusedEmbedding):
                m.embedding_table.normal_(0.0, 1.0 / math.sqrt(m.embed_dim),
                                          generator=generator)
            elif isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
        return self


def _dense_features(batch: dict[str, torch.Tensor]) -> torch.Tensor:
    # log-transform the dense counters in f32 (Criteo counts reach 1e7;
    # bf16 before the log would quantize them)
    return torch.log1p(torch.clamp(batch["dense"].float(), min=0.0))


class DLRM(_Recommender):
    """Deep Learning Recommendation Model (Naumov et al.) for Criteo CTR:
    bottom MLP over the dense features, the fused embedding, the dot
    interaction in f32, top MLP, an f32 logit ``[B]``."""

    def __init__(self, vocab_sizes: Sequence[int], embed_dim: int = 64,
                 bottom_mlp: Sequence[int] = (512, 256, 64),
                 top_mlp: Sequence[int] = (512, 256, 1), *,
                 dtype: torch.dtype = torch.bfloat16, num_dense: int = CRITEO_DENSE,
                 device=None):
        super().__init__()
        if bottom_mlp[-1] != embed_dim:
            raise ValueError(
                f"bottom_mlp output {bottom_mlp[-1]} must equal embed_dim "
                f"{embed_dim} for dot interaction")
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.bottom_mlp = MLP(num_dense, bottom_mlp, dtype=dtype, device=device)
        self.embedding = FusedEmbedding(self.vocab_sizes, embed_dim, device=device)
        n = len(self.vocab_sizes) + 1
        self.top_mlp = MLP(embed_dim + n * (n - 1) // 2, top_mlp, dtype=dtype,
                           final_activation=False, device=device)

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None,
                overrides: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        overrides = overrides or {}
        bottom = self.bottom_mlp(_dense_features(batch).to(self.dtype))
        emb = self.embedding(batch["sparse"], override=overrides.get("embedding"))
        feats = dot_interaction(bottom.float(), emb)
        logit = self.top_mlp(feats.to(self.dtype))
        return logit[:, 0].float()


class WideAndDeep(_Recommender):
    """Wide (a linear model over the categorical ids, a fused table of
    width 1, and an f32 Dense over the dense features) + Deep (embeddings
    and dense features → MLP) CTR model."""

    def __init__(self, vocab_sizes: Sequence[int], embed_dim: int = 32,
                 deep_mlp: Sequence[int] = (256, 128, 1), *,
                 dtype: torch.dtype = torch.bfloat16, num_dense: int = CRITEO_DENSE,
                 device=None):
        super().__init__()
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.wide_table = FusedEmbedding(self.vocab_sizes, 1, device=device)
        self.wide_dense = nn.Linear(num_dense, 1, device=device)
        self.embedding = FusedEmbedding(self.vocab_sizes, embed_dim, device=device)
        self.deep_mlp = MLP(len(self.vocab_sizes) * embed_dim + num_dense, deep_mlp,
                            dtype=dtype, final_activation=False, device=device)

    def forward(self, batch: dict[str, torch.Tensor],
                generator: torch.Generator | None = None,
                overrides: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
        overrides = overrides or {}
        dense = _dense_features(batch)
        wide = self.wide_table(batch["sparse"], override=overrides.get("wide_table"))
        wide_logit = wide[..., 0].sum(-1) + self.wide_dense(dense)[:, 0]
        emb = self.embedding(batch["sparse"], override=overrides.get("embedding"))
        deep_in = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=1)
        deep_logit = self.deep_mlp(deep_in.to(self.dtype))[:, 0]
        return wide_logit + deep_logit.float()


def sparse_embed_specs(model: DLRM | WideAndDeep, *, lr: float = 1e-2) -> tuple:
    """Row-sparse training specs (:mod:`..train.embed`) for DLRM /
    WideAndDeep: each fused table's param name, its batch → row-ids
    function and the row-wise AdaGrad lr. Hand them to
    ``Trainer(sparse_embed=...)``."""
    from distributeddeeplearningspark_tpu_torch.train.embed import SparseEmbedSpec

    ids_fn = functools.partial(_batch_row_ids, tuple(model.vocab_sizes))
    names = ["embedding"] + (["wide_table"] if isinstance(model, WideAndDeep) else [])
    return tuple(SparseEmbedSpec(name=name, param_path=f"{name}.embedding_table",
                                 ids_fn=ids_fn, lr=lr)
                 for name in names)


def _batch_row_ids(vocab_sizes: tuple[int, ...], batch: dict) -> torch.Tensor:
    return fused_flat_ids(vocab_sizes, batch["sparse"])


def dlrm(vocab_sizes: Sequence[int] = (100_000,) * CRITEO_SPARSE, embed_dim: int = 64,
         bottom_mlp: Sequence[int] = (512, 256, 64),
         top_mlp: Sequence[int] = (512, 256, 1), *, device="cuda", seed: int = 0,
         dtype: torch.dtype = torch.bfloat16) -> DLRM:
    """The config-4 DLRM (the JAX bench's shape): 13 dense + 26 categorical
    features, 26 × 100,000 rows of a fused f32 table of width 64,
    ``bottom_mlp=(512, 256, 64)``, ``top_mlp=(512, 256, 1)``, bf16 MLPs; on
    ``device`` (the card unless ``device="cpu"``), weights made from
    ``seed``."""
    dev = resolve_device(device)
    model = DLRM(vocab_sizes, embed_dim, bottom_mlp, top_mlp, dtype=dtype, device=dev)
    return model.init_weights(torch.Generator(device=dev).manual_seed(seed))
