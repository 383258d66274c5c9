"""Mixture-of-Experts FFN — the port of
``distributeddeeplearningspark_tpu/models/moe.py``, the consumer of the
mesh's ``expert`` axis.

The same function as the flax ``MoEMLP``, which the CPU tests hold it to
(outputs, the load-balance loss, the dropped share, the routing and the
gradients):

- **Top-k routing with capacity dropping** (GShard, Switch): the router's
  logits and softmax in f32 whatever the activations' dtype; k rounds of
  argmax, each masking out the experts chosen before; a token's position
  in its expert's capacity is the cumulative count of the tokens routed
  there, dropped ones included (GShard's cumsum runs over the assignment
  before the drop, so later rounds see holes), and a position at or past
  the capacity ``max(1, int(capacity_factor · g · k / E))`` drops the
  assignment (the residual connection carries the token). The kept gates
  are renormalised to sum to 1 over a token's kept slots.
- **Routing groups**: one a sequence by default (g = S); ``group_size``
  regroups the ``[B, S]`` tokens B-major into ``[B·S/g, g]`` (it must
  divide B·S), capacity being enforced per group.
- **SwiGLU experts** stacked ``[E, H, I]`` (``w_gate``, ``w_up``) and
  ``[E, I, H]`` (``w_down``) in ``param_dtype``, run in ``dtype``; the
  router ``[H, E]`` is f32. These are the flax layouts (no torch
  ``Linear`` transposes them), so the rules name the same dims as JAX's.
- **The load-balance loss** (Switch eq. 4), E · Σₑ fₑ · p̄ₑ: fₑ the share
  of tokens whose first choice is e, p̄ₑ the mean router probability of e,
  both over the batch; and the dropped share of the B·S·k assignments.

The flax module dispatches by one-hot einsums against a ``[G, S, E, C]``
tensor, a TPU choice (static shapes, MXU matmuls). Here dispatch is by
index, PyTorch's way: the kept tokens are gathered into ``[G, E, C, H]``,
the experts run as batched matmuls over ``[E, G·C, H]``, and each token's
k slot outputs are gathered back ``[G, S, k, H]`` and weighted by its
gates (the gates cast to ``dtype`` first, as the flax combine is, the
weighted sum in f32).

:meth:`MoEMLP.forward` returns ``(y, (aux, dropped_frac))`` as the flax
module does; :meth:`MoEMLP.forward_sums` returns ``(y, sums)``, the batch
sums the two are made from (:func:`load_balance`), so a model can add them
over the ranks that hold distinct rows before the product: fₑ and p̄ₑ are
means over the *global* batch (``LlamaForCausalLM.batch_sum``, which the
train step sets).

**Expert parallelism.** Where the lowering split the bank over ``expert``
(a ``DTensor``: ``llama_rules`` puts dim 0 of each bank on ``expert`` and
its FFN dim on ``tensor``), each rank holds E/n experts and runs only
those, on the same rows as its expert peers (``BATCH_AXES`` leaves
``expert`` out). The routing is computed whole on every rank, from the
replicated router. The tokens enter the local experts through Megatron's
``f`` over the expert group (:func:`_enter`: the identity forward, the
gradient of x summed over the group, each peer holding the part its
experts give). Each rank weighs its own experts' slot outputs by their
gates and sums a token's slots in f32 (a slot of another rank's expert is
zero there), and that combined output ``[b, s, h]`` leaves through ``g``
(:func:`_leave`: summed over the group, the gradient passed on as it is),
the contraction over E that GSPMD turns into a sum across the group: one
``[b, s, h]`` all-reduce a layer, not one of the ``[b, s, k, h]`` slots.
The gates pass ``f`` too (:func:`_gates`): each rank's gradient of them
holds only its own slots' part, and summed over the group it is whole, so
the router's gradient through the combine is one card's. The router's
input, the load-balance sums and the aux do not pass ``f``: their
gradients are whole on every rank already, and summed over the group they
would count once per expert peer. The sum over the group runs in
``dtype``, as GSPMD's sum of the combine's partials does (bf16 at the 0.9b
and 7B configs, half the bytes of the bf16 slots; an f32 sum would move as
many as they did at k = 2): a token whose kept slots lie on two ranks is
rounded once on each and once in the sum, where one card rounds the f32
sum once, so at bf16 its output may differ from one card's by about an
ulp, and a near-tie in a later layer's routing may flip (the four-card
comparisons in ``chip_smoke.py --gang llama-moe`` hold the losses to
``GANG_LOSS_RTOL``, the grad norms and ``moe_aux`` to ``MOE_GRAD_NORM_RTOL``
and ``MOE_AUX_RTOL``); in f32 ``tests/test_torch_ep.py`` holds every
layout to the one-device JAX reference at 1e-4. With the bank's FFN
dim split over ``tensor`` as well, the expert input, the gates and the
combined output also pass ``f`` and ``g`` over the ``tensor`` group (each
tensor peer's slot outputs a part of the sum, Megatron's
row-split ``w_down``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearningspark_tpu_torch.metrics import replicated_matmul
from distributeddeeplearningspark_tpu_torch.parallel import collectives
from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_EXPERT, AXIS_TENSOR
from distributeddeeplearningspark_tpu_torch.parallel.sharding import (
    TensorSplit,
    local_value,
    mesh_split,
)


def load_balance(sums: torch.Tensor, num_experts: int, top_k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(aux, dropped_frac)`` from batch sums ``[..., 2E + 2]``
    (:meth:`MoEMLP.forward_sums`: the first choices' counts a expert, the
    router probabilities' sums a expert, the dropped assignments, the
    tokens): ``E · Σₑ (countₑ / T) · (probₑ / T)`` and ``dropped / (T ·
    k)``."""
    e = num_experts
    tokens = sums[..., -1:]
    frac = sums[..., :e] / tokens
    mean_p = sums[..., e:2 * e] / tokens
    aux = e * (frac * mean_p).sum(-1)
    return aux, sums[..., -2] / (tokens[..., 0] * top_k)


def _enter(x: torch.Tensor, splits: Sequence[TensorSplit]) -> torch.Tensor:
    """The experts' input: ``f`` over each group the bank is split over
    (its gradient summed across the group)."""
    for sp in splits:
        x = collectives.all_reduce_backward(x, sp.group)
    return x


def _gates(w: torch.Tensor, splits: Sequence[TensorSplit]) -> torch.Tensor:
    """The combine's gates: ``f`` over each group the bank is split over
    (each rank's gradient of them holds its own slots' part)."""
    for sp in splits:
        w = collectives.all_reduce_backward(w, sp.group)
    return w


def _leave(y: torch.Tensor, splits: Sequence[TensorSplit]) -> torch.Tensor:
    """The combined output: ``g`` over each group the bank is split over
    (summed across the group)."""
    for sp in splits:
        y = collectives.all_reduce_forward(y, sp.group)
    return y


class MoEMLP(nn.Module):
    """Drop-in for a SwiGLU FFN: ``[B, S, H] → ([B, S, H], (aux,
    dropped_frac))`` (the module docstring)."""

    def __init__(self, hidden_size: int, intermediate_size: int, num_experts: int, *,
                 top_k: int = 2, capacity_factor: float = 1.25, group_size: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        h, i, e = hidden_size, intermediate_size, num_experts
        self.num_experts, self.top_k = e, top_k
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(h, e, dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, h, i, dtype=param_dtype, device=device))
        self.w_up = nn.Parameter(torch.empty(e, h, i, dtype=param_dtype, device=device))
        self.w_down = nn.Parameter(torch.empty(e, i, h, dtype=param_dtype, device=device))

    @torch.no_grad()
    def init_weights(self, draw, generator: torch.Generator) -> None:
        """flax's ``lecun_normal`` scales (normal, std 1/√fan_in, not
        truncated, as the port's Llama draws its projections), fan_in
        flax's: every dim but the last (H for the router, E·H or E·I for an
        expert kernel). ``draw(param, fill)`` fills each param whole (a
        sharded one keeping its shard)."""
        for p in (self.router, self.w_gate, self.w_up, self.w_down):
            std = (p.numel() // p.shape[-1]) ** -0.5
            draw(p, lambda t, std=std: t.normal_(0.0, std, generator=generator))

    def splits(self) -> list[TensorSplit]:
        """How the bank is split: over ``expert`` (dim 0), then ``tensor`` (the
        FFN dim), each where it is."""
        return [sp for sp in (mesh_split(self.w_gate, AXIS_EXPERT),
                              mesh_split(self.w_gate, AXIS_TENSOR)) if sp is not None]

    def _route(self, x: torch.Tensor) -> torch.Tensor:
        """The router's probabilities ``[G, g, E]`` in f32. Under a
        ``tensor`` split every peer routes the same tokens: the product is
        counted on one (:func:`~..metrics.replicated_matmul`)."""
        router = local_value(self.router).float()
        split = mesh_split(self.w_gate, AXIS_TENSOR)
        logits = (x.float() @ router if split is None else
                  replicated_matmul(x.float(), router, counted=split.index == 0))
        return torch.softmax(logits, dim=-1)

    def forward(self, x: torch.Tensor):
        y, sums = self.forward_sums(x)
        return y, load_balance(sums, self.num_experts, self.top_k)

    def forward_sums(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(y, sums)``: the output and this batch's sums ``[2E + 2]``
        (:func:`load_balance`)."""
        e, k, dt = self.num_experts, self.top_k, self.dtype
        if not 1 <= k <= e:
            raise ValueError(f"top_k {k} must be in [1, {e}]")
        bb, ss, h = x.shape
        if self.group_size:
            if (bb * ss) % self.group_size:
                raise ValueError(
                    f"group_size {self.group_size} must divide B*S ({bb}*{ss}); "
                    f"pick a divisor of the per-step token count or 0 for "
                    f"per-sequence groups")
            x = x.reshape(bb * ss // self.group_size, self.group_size, h)
        b, s, _ = x.shape
        cap = max(1, int(self.capacity_factor * s * k / e))
        probs = self._route(x)                                     # [b, s, e] f32

        remaining = probs
        claimed = torch.zeros(b, e, dtype=torch.long, device=x.device)
        experts, positions, gates = [], [], []
        gate_sum = torch.zeros(b, s, device=x.device)
        dropped = torch.zeros((), device=x.device)
        first = None
        for _ in range(k):
            idx = remaining.argmax(-1)                             # [b, s]
            onehot = F.one_hot(idx, e)                             # [b, s, e]
            if first is None:
                first = onehot
            # the chosen expert's count so far, this token included
            pos = ((onehot.cumsum(1) - 1 + claimed[:, None, :]) * onehot).sum(-1)
            keep = pos < cap
            dropped = dropped + (~keep).sum()
            kept_gate = probs.gather(-1, idx[..., None])[..., 0] * keep
            gate_sum = gate_sum + kept_gate
            experts.append(idx)
            positions.append(torch.where(keep, pos, -1))
            gates.append(kept_gate)
            claimed = claimed + onehot.sum(1)
            remaining = remaining * (1 - onehot).float()
        weights = torch.stack(gates, -1) / gate_sum.clamp(min=1e-9)[..., None]

        splits = self.splits()
        w_gate, w_up, w_down = (local_value(w) for w in (self.w_gate, self.w_up,
                                                         self.w_down))
        local_e = w_gate.shape[0]
        lo = 0
        for sp in splits:
            if sp.dim == 0:
                lo = sp.index * local_e
        # each (token, round)'s slot among this rank's experts' b·E_l·C;
        # dropped and other ranks' assignments point past the end
        idx, pos = torch.stack(experts, -1), torch.stack(positions, -1)  # [b, s, k]
        mine = (pos >= 0) & (idx >= lo) & (idx < lo + local_e)
        end = local_e * cap
        slot = torch.where(mine, (idx - lo) * cap + pos, end).reshape(b, s * k)
        # the token each slot holds (s: a zero row), every kept slot once
        token = torch.full((b, end + 1), s, dtype=torch.long, device=x.device)
        token.scatter_(1, slot, torch.arange(s, device=x.device).repeat_interleave(k)
                       .expand(b, -1).contiguous())
        xin = _enter(x.to(dt), splits)
        xin = torch.cat([xin, xin.new_zeros(b, 1, h)], 1)
        xe = xin.gather(1, token[:, :end, None].expand(-1, -1, h))        # [b, E_l·C, h]
        xe = xe.view(b, local_e, cap, h).transpose(0, 1).reshape(local_e, b * cap, h)
        act = F.silu(torch.bmm(xe, w_gate.to(dt))) * torch.bmm(xe, w_up.to(dt))
        ye = torch.bmm(act, w_down.to(dt))                                 # [E_l, b·C, h]
        ye = ye.view(local_e, b, cap, h).transpose(0, 1).reshape(b, end, h)
        ye = torch.cat([ye, ye.new_zeros(b, 1, h)], 1)
        out = ye.gather(1, slot[..., None].expand(-1, -1, h)).view(b, s, k, h)
        gates = _gates(weights, splits).to(dt).float()
        y = _leave((gates[..., None] * out.float()).sum(2).to(dt), splits)
        if self.group_size:
            y = y.reshape(bb, ss, h)

        sums = torch.cat([first.sum((0, 1)).float(), probs.sum((0, 1)),
                          dropped.float()[None],
                          torch.full((1,), float(b * s), device=x.device)])
        return y.to(x.dtype), sums
