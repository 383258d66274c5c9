"""Ring attention — context parallelism over the mesh ``seq`` axis.

The port of ``distributeddeeplearningspark_tpu/ops/ring_attention.py``'s
flash path (``_ring_fwd_flash``, ``_ring_bwd_flash``, the custom VJP,
``_flash_hop_qualifies``, ``ring_attention``, ``set_default_mesh``). Each
rank of a ``seq`` group of N holds one block of ``S/N`` positions of every
row (the JAX ``shard_map``'s local view; the port has no global one), and
K/V blocks rotate around the group so the local queries meet every block:

- **Forward** (:class:`_RingAttention`): hop 0 is the diagonal block, K1
  (``flash_fwd``) with the local ``causal`` mask; hop i ≥ 1 holds the
  block of ``seq`` peer ``(my + i) mod N``, received from the next peer
  while each rank sends its current block to the previous one (JAX's
  ``perm``), and runs K1 with ``causal=False``. The key mask and the kv
  side's segment ids ride the ring with their block; the q side reads
  the local ids. Partial outputs merge in f32 on the LSE:
  ``lse' = logaddexp(lse, lse_i)``, ``o' = o·e^(lse−lse') + o_i·e^(lse_i−lse')``
  (:func:`merge`).
- **Backward**: ``delta = rowsum(dO∘O)`` once, from the merged output;
  each hop calls K2 (``flash_bwd_dq``) and K3 (``flash_bwd_dkv``) with the
  merged LSE and that ``delta`` (never ``flash_bwd``, which would take
  ``delta`` from its own inputs). dQ accumulates at home in f32; dK/dV
  accumulate in f32 and ride the ring with their K/V block, and one final
  rotation brings them home.
- **Inactive hops.** Under ``causal``, a hop whose block lies wholly after
  the local queries (``my + i < N``) contributes nothing. JAX computes it
  and selects it away, since its SPMD program runs in lockstep; here each
  rank knows its index on the host and launches no kernel for it
  (:func:`hop_active`), so no inf·0 can arise. The block still rotates.
  The rank at ``seq`` index r launches K1 ``1 + r`` times a call, and
  K2/K3 ``1 + r`` times each in the backward.
- **Exchange**: ``torch.distributed.batch_isend_irecv`` over the ``seq``
  group, peers by their global ranks (:class:`SeqGroup`). The next hop's
  K/V exchange is posted before the current hop's kernels and waited on
  before use. At ``seq`` degree 1 there is one hop and no collective, so a
  model may take ``impl="ring"`` unconditionally.

The per-hop compute (:func:`hop_forward`, :func:`merge`,
:func:`hop_backward`) is split from the exchange, so every hop of an
N-way split can run in turn on one device with no group.

**The gate** (:func:`flash_hop_qualifies`): the kernels run each hop where
they qualify under the port's kernel rules applied to ``S/N`` (a CUDA
tensor, bf16, a head dim in ``KERNEL_HEAD_DIMS``) and JAX's divisibility
rule (``S/N`` a multiple of the kernel block, or at most one block).
Elsewhere each hop runs the kernels' plain versions
(``flash_attention_reference``, ``_backward_plain``), which compute the
same: that is what the CPU runs. An explicit ``use_flash=True`` that does
not qualify raises, as in JAX. The JAX einsum path (``_ring_fwd_local``,
``_ring_bwd_local``) is not copied: it is the same function as the plain
hops, which the gate already keeps for every input the kernels refuse.

Each hop's exchange counts its calls and the bytes this rank sends in
``exchange.calls`` and ``exchange.bytes_sent``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from distributeddeeplearningspark_tpu_torch.ops import flash_attention as fa
from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_SEQ

#: the JAX kernel's block: a local sequence longer than it must be a
#: multiple of it (JAX's ``_flash_hop_qualifies``)
DEFAULT_BLOCK = 512

#: the mesh of a call that names none and finds no active session (JAX's
#: fallback for models, which hold no mesh)
_default_mesh: Any = None


def set_default_mesh(mesh) -> None:
    """The mesh :func:`resolve_mesh` falls back on (None clears it)."""
    global _default_mesh
    _default_mesh = mesh


def resolve_mesh(mesh=None):
    """``mesh``, else the active session's, else :func:`set_default_mesh`'s
    (JAX's order); RuntimeError without any."""
    if mesh is not None:
        return mesh
    from distributeddeeplearningspark_tpu_torch.session import Session

    if Session._active is not None and not Session._active._stopped:
        return Session._active.mesh
    if _default_mesh is not None:
        return _default_mesh
    raise RuntimeError("ring attention needs a mesh: pass mesh=, create a "
                       "Session, or call ops.ring_attention.set_default_mesh(mesh)")


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """This rank's ``seq`` group: its index, the size, the process group
    (None: the whole gang, or no group at size 1)."""

    index: int
    size: int
    group: Any = None

    def peer(self, offset: int) -> int:
        """The global rank of the peer ``offset`` places along the ring."""
        j = (self.index + offset) % self.size
        if self.group is None:
            return j
        import torch.distributed as dist

        return dist.get_global_rank(self.group, j)


def seq_group(mesh) -> SeqGroup:
    """The ``seq`` group of ``mesh`` (a session's :class:`~..parallel.mesh.Mesh`)."""
    n = mesh.shape[AXIS_SEQ]
    return SeqGroup(mesh.seq_index, n, mesh.group((AXIS_SEQ,)) if n > 1 else None)


def flash_hop_qualifies(q: torch.Tensor, s_local: int) -> bool:
    """May each hop over blocks of ``s_local`` positions run the CUDA
    kernels? A CUDA tensor in bf16 with a head dim in ``KERNEL_HEAD_DIMS``
    (the port's kernel rules), and ``s_local`` a multiple of the block it
    tiles by, ``min(DEFAULT_BLOCK, s_local)`` (JAX's rule)."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        return False
    if q.shape[-1] not in fa.KERNEL_HEAD_DIMS or s_local < 1:
        return False
    return s_local % min(DEFAULT_BLOCK, s_local) == 0


def hop_active(index: int, hop: int, size: int, causal: bool) -> bool:
    """Does hop ``hop`` of the rank at ``index`` (its K/V block
    ``(index + hop) mod size``) reach any local query? Under ``causal``
    only the diagonal and the blocks before it do."""
    return not causal or hop == 0 or index + hop >= size


def hop_forward(q, k, v, *, kv_mask=None, q_segs=None, kv_segs=None,
                scale: float, causal: bool, use_flash: bool):
    """One hop: the local queries over one K/V block, ``(o, lse)`` — K1,
    or its plain version."""
    fn = fa.flash_fwd if use_flash else fa.flash_attention_reference
    return fn(q, k, v, kv_mask=kv_mask, q_segs=q_segs, kv_segs=kv_segs,
              scale=scale, causal=causal)


def merge(acc, o_i: torch.Tensor, lse_i: torch.Tensor):
    """Fold one hop's ``(o_i, lse_i)`` into ``acc`` (``(o f32, lse)``, or
    None before the first active hop), in f32 on the LSE. A hop whose rows
    saw no key has ``o_i = 0`` and ``lse_i = -1e30``, which the merge
    leaves out."""
    if acc is None:
        return o_i.float(), lse_i
    o, lse = acc
    new = torch.logaddexp(lse, lse_i)
    b, s, h, _ = o.shape

    def weight(x):  # [B·H, S] → [B, S, H, 1]
        return torch.exp(x - new).view(b, h, s).transpose(1, 2)[..., None]

    return o * weight(lse) + o_i.float() * weight(lse_i), new


def hop_backward(q, k, v, do, lse, delta, *, kv_mask=None, q_segs=None,
                 kv_segs=None, scale: float, causal: bool, use_flash: bool):
    """One hop's ``(dq, dk, dv)`` from the merged ``lse`` and ``delta`` —
    K2 and K3, or their plain version."""
    kw = dict(kv_mask=kv_mask, q_segs=q_segs, kv_segs=kv_segs, scale=scale,
              causal=causal)
    if not use_flash:
        return fa._backward_plain(q, k, v, lse, delta, do, **kw)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))


def exchange(tensors: list, sg: SeqGroup):
    """Post one rotation: each of ``tensors`` sent to the previous peer, its
    like received from the next. Returns a callable that waits and gives
    the received tensors."""
    import torch.distributed as dist

    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, t, sg.peer(-1), sg.group))
        ops.append(dist.P2POp(dist.irecv, buf, sg.peer(1), sg.group))
    works = dist.batch_isend_irecv(ops)
    exchange.calls += 1
    exchange.bytes_sent += sum(t.numel() * t.element_size() for t in tensors)

    def wait() -> list:
        for w in works:
            w.wait()
        return bufs

    return wait


exchange.calls = 0
exchange.bytes_sent = 0


def _block(ride: list, has_mask: bool) -> tuple:
    """(k, v, kv_mask, kv_segs) out of a riding list ``[k, v, mask?, segs?]``."""
    k, v, *extras = ride
    mask = extras[0] if has_mask else None
    segs = extras[-1] if len(extras) > int(has_mask) else None
    return k, v, mask, segs


def _ring_forward(q, k, v, kv_mask, segs, sg: SeqGroup, scale, causal, use_flash):
    """The forward revolution: ``(o, lse)``, o in q's dtype."""
    ride = [x for x in (k, v, kv_mask, segs) if x is not None]
    acc = None
    for i in range(sg.size):
        pending = exchange(ride, sg) if i + 1 < sg.size else None
        if hop_active(sg.index, i, sg.size, causal):
            kk, vv, mask_i, kseg_i = _block(ride, kv_mask is not None)
            acc = merge(acc, *hop_forward(
                q, kk, vv, kv_mask=mask_i, q_segs=segs, kv_segs=kseg_i,
                scale=scale, causal=causal and i == 0, use_flash=use_flash))
        if pending is not None:
            ride = pending()
    o, lse = acc
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, kv_mask, segs, o, lse, do, sg: SeqGroup, scale,
                   causal, use_flash):
    """The backward revolution: ``(dq, dk, dv)`` in the inputs' dtypes."""
    delta = fa._delta(o, do).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    ride = [x for x in (k, v, kv_mask, segs) if x is not None]
    for i in range(sg.size):
        pending = exchange(ride, sg) if i + 1 < sg.size else None
        if hop_active(sg.index, i, sg.size, causal):
            kk, vv, mask_i, kseg_i = _block(ride, kv_mask is not None)
            dqi, dki, dvi = hop_backward(
                q, kk, vv, do, lse, delta, kv_mask=mask_i, q_segs=segs,
                kv_segs=kseg_i, scale=scale, causal=causal and i == 0,
                use_flash=use_flash)
            dq += dqi.float()
            dk += dki.float()
            dv += dvi.float()
        if sg.size > 1:  # the block's gradient rides with it; the last hop's goes home
            dk, dv = exchange([dk, dv], sg)()
        if pending is not None:
            ride = pending()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring's forward and its blockwise backward. Saves q, k, v, the
    merged o and LSE, and the masks (which get no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, segs, sg, scale, causal, use_flash):
        o, lse = _ring_forward(q, k, v, kv_mask, segs, sg, scale, causal, use_flash)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask, segs)
        ctx.sg, ctx.scale, ctx.causal, ctx.use_flash = sg, scale, causal, use_flash
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask, segs = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, kv_mask, segs, o, lse, do.contiguous(),
                                    ctx.sg, ctx.scale, ctx.causal, ctx.use_flash)
        return dq, dk, dv, None, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh=None, causal: bool = True, scale: float | None = None,
                   mask=None, bias=None, segment_ids=None,
                   use_flash: bool | None = None) -> torch.Tensor:
    """Exact attention over a sequence sharded on the mesh's ``seq`` axis,
    differentiable.

    ``q`` ``[B, S/N, H, D]``, ``k``/``v`` ``[B, S/N, Hkv, D]``: this rank's
    block of the sequence (block ``seq`` index of N), with the local heads
    under tensor parallelism; GQA K/V ride the ring at ``Hkv`` heads.
    ``mask``: a key-only padding mask of the local block (``[B, S/N]``,
    ``[S/N]`` or ``[B, 1, 1, S/N]``, :func:`..flash_attention.as_kv_mask`);
    one that varies over queries or heads raises. ``segment_ids``: the
    local block's packed-document ids ``[B, S/N]``. ``mesh=None``: the
    active session's (:func:`resolve_mesh`). ``use_flash``: None picks the
    kernels where :func:`flash_hop_qualifies`, True raises where they do
    not, False takes the plain hops. Returns the local block's output
    ``[B, S/N, H, D]`` in q's dtype."""
    if bias is not None:
        raise NotImplementedError(
            "ring attention does not take additive bias; use impl='xla'")
    mesh = resolve_mesh(mesh)
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes must match: {tuple(k.shape)} vs {tuple(v.shape)}")
    b, s, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if (bk, sk, dk) != (b, s, d):
        raise ValueError(f"q/k shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {hkv}")
    qualifies = flash_hop_qualifies(q, s)
    if use_flash and not qualifies:
        # an explicit opt-in must not silently take the plain hops
        raise ValueError(
            f"use_flash=True but the local shapes do not satisfy the kernels' "
            f"rules (a CUDA bf16 tensor, head dim in {fa.KERNEL_HEAD_DIMS}, a "
            f"local sequence that tiles by {DEFAULT_BLOCK}): s_local={s}, d={d}, "
            f"{q.dtype} on {q.device}; pass use_flash=None/False")
    if use_flash is None:
        use_flash = qualifies
    kv_mask = fa.as_kv_mask(mask, b, s, q.device) if mask is not None else None
    segs = None
    if segment_ids is not None:
        segs = torch.as_tensor(segment_ids, device=q.device)
        if tuple(segs.shape) != (b, s):
            raise ValueError(f"segment_ids must be [batch, seq] = {(b, s)}, "
                             f"got {tuple(segs.shape)}")
        segs = segs.to(torch.int32).contiguous()
    scale = scale if scale is not None else d ** -0.5
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                kv_mask, segs, seq_group(mesh), scale, causal,
                                bool(use_flash))
