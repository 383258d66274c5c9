"""Pipeline parallelism — GPipe over the ``pipe`` mesh axis, the port of
``distributeddeeplearningspark_tpu/parallel/pipeline.py``.

JAX runs the schedule as one ``shard_map`` body: a ``lax.scan`` of M + P − 1
ticks in which every stage applies ``stage_fn`` each tick (stage 0 ingesting
microbatch t, zeros once the input is exhausted), hands its output to the
next stage with ``lax.ppermute``, and the last stage banks microbatch
t − (P − 1); the banked outputs are ``psum``'d over ``pipe``, so every pipe
peer holds the trunk's output, and autodiff carries the backward through
the scan. The port computes the same function eagerly, on the pipe group's
point-to-point links (``torch.distributed`` ``P2POp``/``batch_isend_irecv``,
as :func:`..parallel.collectives.ppermute_shift`):

- forward: stage k takes microbatch i (stage 0 from its input, the others
  received from stage k − 1), applies its layers and sends the result to
  stage k + 1; the last stage banks microbatch i in place i; then the
  bank, ``[M, B/M, ...]``, is broadcast from the last stage over the pipe
  group (JAX's ``psum`` of the one-hot contribution);
- backward (in the backward of one ``torch.autograd.Function``, so the
  train step's single ``loss.backward()`` drives it): the last stage takes
  its own gradient of the bank (every pipe peer computes the same loss on
  the same rows, so the loss counts once: the peers' gradients are not
  summed), then from microbatch M − 1 down to 0 each stage receives the
  gradient of its output from stage k + 1, back-propagates its own graph of
  that microbatch (its params' gradients accumulate in ``.grad``) and sends
  its input's gradient to stage k − 1; stage 0's is the input's.

A stage computes exactly its M microbatches, forward and backward, and
nothing on bubble ticks (JAX's stages run ``stage_fn`` on zeros there), so
the step's FLOPs are one device's; the order of its M + P − 1 ticks, and so
the bubble (P − 1)/(M + P − 1), is GPipe's. The rows of each rank's batch
split into M microbatches in order (JAX reshapes the global ``[B]`` into
``[M, B/M]`` with the rows sharded over ``(data, fsdp)``; the loss is a sum
over rows either way).

:func:`stage_layers` is the counterpart of ``stack_stages``: stage k of P
holds layers ``k·L/P … (k+1)·L/P − 1`` (``[L] → [P, L/P]``). The bytes a
rank sends stage to stage are counted in ``pipeline.handoff_bytes`` and
the bank's broadcast (counted at its source) in
``pipeline.broadcast_bytes``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from distributeddeeplearningspark_tpu_torch.parallel.mesh import AXIS_PIPE

StageFn = Callable[[torch.Tensor], torch.Tensor]


def stage_layers(num_layers: int, stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``stages`` runs, in order (JAX's
    ``stack_stages`` regroups ``[L, ...]`` into ``[P, L/P, ...]``)."""
    if num_layers % stages:
        raise ValueError(f"{num_layers} layers not divisible into {stages} stages")
    n = num_layers // stages
    return range(stage * n, (stage + 1) * n)


@dataclasses.dataclass(frozen=True)
class PipeGroup:
    """This rank's place on the ``pipe`` axis: its stage, the number of
    stages, the pipe process group (None: the whole gang) and the global
    rank at each stage of it."""

    stage: int
    stages: int
    group: Any
    peers: tuple[int, ...]

    @classmethod
    def of(cls, mesh) -> "PipeGroup":
        stages = mesh.shape[AXIS_PIPE]
        group = mesh.group((AXIS_PIPE,)) if stages > 1 else None
        return cls(mesh.pipe_index, stages, group,
                   tuple(mesh.pipe_peer(k) for k in range(stages)))

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1


def _post(op: str, t: torch.Tensor, peer: int, pg: PipeGroup):
    """One point-to-point op to or from ``peer`` over the pipe group; its
    work."""
    import torch.distributed as dist

    if op == "send":
        pipeline.handoff_bytes += t.numel() * t.element_size()
    fn = dist.isend if op == "send" else dist.irecv
    return dist.batch_isend_irecv([dist.P2POp(fn, t, peer, pg.group)])[0]


def _recv(like: torch.Tensor, peer: int, pg: PipeGroup) -> torch.Tensor:
    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    _post("recv", buf, peer, pg).wait()
    return buf


def _bank(outputs: list[torch.Tensor]) -> torch.Tensor:
    """The last stage's bank: microbatch i's output in place i."""
    return torch.stack([o.detach() for o in outputs])


def _broadcast(bank: torch.Tensor, pg: PipeGroup) -> torch.Tensor:
    """The last stage's bank on every pipe peer (JAX's ``psum`` of the
    one-hot contribution)."""
    import torch.distributed as dist

    if pg.stages == 1:
        return bank
    if pg.last:
        pipeline.broadcast_bytes += bank.numel() * bank.element_size()
    dist.broadcast(bank, src=pg.peers[-1], group=pg.group)
    return bank


def _bank_grad(g: torch.Tensor, pg: PipeGroup) -> torch.Tensor:
    """The gradient of the bank the last stage back-propagates (every stage
    calls it; only the last stage's is used): its own. Every pipe peer
    computed the same loss from the same bank, and the loss counts once,
    so the peers' gradients are not summed."""
    return g


class _Run:
    """One call's schedule on this rank: the microbatches' inputs and
    outputs (each microbatch's own graph), between the forward and the
    backward."""

    def __init__(self, stage_fn: StageFn, pg: PipeGroup, graph: bool):
        self.stage_fn, self.pg, self.graph = stage_fn, pg, graph
        self.inputs: list = []
        self.outputs: list = []

    def forward(self, x_mb: torch.Tensor) -> torch.Tensor:
        pg = self.pg
        sent = []
        for i in range(x_mb.shape[0]):
            if pg.stage == 0:
                inp = x_mb[i]
            else:
                inp = _recv(x_mb[i], pg.peers[pg.stage - 1], pg)
            if self.graph:
                # stage 0's input needs a gradient only where the caller's
                # does (a frozen embedding's does not), the others' always
                inp = inp.detach().requires_grad_(pg.stage > 0 or x_mb.requires_grad)
            with torch.enable_grad() if self.graph else contextlib.nullcontext():
                out = self.stage_fn(inp)
            if not pg.last:
                t = out.detach().contiguous()
                sent.append((t, _post("send", t, pg.peers[pg.stage + 1], pg)))
            self.inputs.append(inp)
            self.outputs.append(out)
        for _, work in sent:
            work.wait()
        bank = (_bank(self.outputs) if pg.last
                else torch.empty((x_mb.shape[0],) + tuple(self.outputs[0].shape),
                                 dtype=self.outputs[0].dtype, device=x_mb.device))
        if not self.graph:
            self.inputs, self.outputs = [], []
        return _broadcast(bank, pg)

    def backward(self, g: torch.Tensor) -> torch.Tensor | None:
        pg = self.pg
        g = _bank_grad(g, pg)
        dx: list = [None] * len(self.outputs)
        sent = []
        for i in reversed(range(len(self.outputs))):
            out, inp = self.outputs[i], self.inputs[i]
            gi = g[i] if pg.last else _recv(out, pg.peers[pg.stage + 1], pg)
            if out.requires_grad:
                with torch.enable_grad():
                    torch.autograd.backward(out, gi)
            self.outputs[i] = self.inputs[i] = None  # free the microbatch's graph
            if pg.stage > 0:
                t = (torch.zeros_like(inp) if inp.grad is None
                     else inp.grad).contiguous()
                sent.append((t, _post("send", t, pg.peers[pg.stage - 1], pg)))
            else:
                dx[i] = inp.grad
        for _, work in sent:
            work.wait()
        if pg.stage > 0 or dx[0] is None:
            return None
        return torch.stack(dx)


class _GPipe(torch.autograd.Function):
    """The schedule as one node of the caller's graph: its forward runs
    the M microbatches through this stage and broadcasts the bank, its
    backward the reverse schedule (the module docstring). ``anchor``, a
    leaf that needs a gradient, puts the node in the graph on every stage,
    whatever its input."""

    @staticmethod
    def forward(ctx, x_mb, anchor, run: _Run):
        ctx.run = run
        return run.forward(x_mb)

    @staticmethod
    def backward(ctx, g):
        run, ctx.run = ctx.run, None
        return run.backward(g.contiguous()), None, None


def pipeline(stage_fn: StageFn, x: torch.Tensor, *, mesh,
             num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through the pipe axis's P stages; returns the last stage's
    output on every pipe peer, shaped like ``x``.

    ``stage_fn(activation) -> activation`` applies this rank's stage (it
    must keep the activation's shape and dtype). ``x`` is this rank's batch
    ``[B, ...]``: stage 0 reads it, the other stages only its shape and
    dtype (an expanded scalar will do). B must divide by
    ``num_microbatches``. Differentiable: under autograd the backward runs
    the reverse schedule inside the caller's backward."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} must divide by microbatches {num_microbatches}")
    pg = PipeGroup.of(mesh)
    x_mb = x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))
    graph = torch.is_grad_enabled()
    run = _Run(stage_fn, pg, graph)
    if not graph:
        out = run.forward(x_mb)
    else:
        anchor = torch.empty(0, device=x.device, requires_grad=True)
        out = _GPipe.apply(x_mb, anchor, run)
    return out.reshape((b,) + tuple(out.shape[2:]))


pipeline.handoff_bytes = 0
pipeline.broadcast_bytes = 0


# -- a stage's share of the train state, and the whole one a checkpoint holds --


def _runs(tree: Any) -> list[int | None]:
    """The runs of an optimizer state's leaves in flattened order
    (``train.state.leaves``): None for one leaf (a count), n for a list of
    n tensors, one for each param the optimizer updates (Adam's moments,
    SGD's trace: the optimizers keep those in lists, everything else in
    tuples)."""
    out: list[int | None] = []
    if isinstance(tree, dict):
        for v in tree.values():
            out += _runs(v)
    elif isinstance(tree, list):
        out.append(len(tree))
    elif isinstance(tree, tuple):
        for v in tree:
            out += _runs(v)
    else:
        out.append(None)
    return out


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.rsplit(".", 1)[-1])


@dataclasses.dataclass(frozen=True)
class StageState:
    """How one stage's :class:`~..train.state.TrainState` lies in the whole
    one, so a checkpoint keeps the format of ``pipe`` 1 (JAX keeps the
    pipelined tree "byte-compatible with non-PP checkpoints"): the stage's
    place (:class:`PipeGroup`), the names of the params its optimizer
    updates in its order, and those of every stage in the whole model's
    order."""

    pg: PipeGroup
    opt_names: tuple[str, ...]
    whole_opt_names: tuple[str, ...]

    def local(self, sd: dict, state) -> dict:
        """The whole state dict ``sd`` (a checkpoint's) cut to this stage's
        ``state``: its params, and of each per-param list of the optimizer
        state its own entries."""
        flat, out, pos = list(sd["opt_state"]), [], 0
        where = {n: i for i, n in enumerate(self.whole_opt_names)}
        n_whole = len(self.whole_opt_names)
        for run in _runs(state.opt_state):
            if run is None:
                out.append(flat[pos])
                pos += 1
                continue
            if run != len(self.opt_names):
                raise ValueError(f"an optimizer list of {run} tensors, want one for "
                                 f"each of the stage's {len(self.opt_names)} params")
            seg = flat[pos:pos + n_whole]
            out += [seg[where[n]] for n in self.opt_names]
            pos += n_whole
        if pos != len(flat):
            raise ValueError(f"optimizer state has {len(flat)} leaves, the "
                             f"whole model's layout {pos}")
        return {**sd, "params": {k: v for k, v in sd["params"].items()
                                 if k in state.params}, "opt_state": out}

    def whole(self, state, device) -> dict | None:
        """Every stage's state as one whole state dict on the host, on rank
        0 (None elsewhere): a collective over the gang. Each stage's
        sharded tensors are gathered whole within it; then the ranks of
        rank 0's pipe group send rank 0 their stage's params and optimizer
        entries over the pipe links, one tensor at a time."""
        import torch.distributed as dist

        from distributeddeeplearningspark_tpu_torch.parallel import sharding

        pg = self.pg
        sd = state.state_dict()
        params = {k: sharding.full(v) for k, v in sd["params"].items()}
        flat = [sharding.full(x) if isinstance(x, torch.Tensor) else x
                for x in sd["opt_state"]]
        rank = dist.get_rank()
        if pg.peers[0] != 0:  # not in rank 0's pipe group
            return None
        # this stage's entries: its params, its per-param optimizer tensors
        owned = {n for n, p in state.params.items() if sharding.pipe_stage(p) is not None}
        mine_params = {k: v for k, v in params.items() if k in owned}
        mine_opt: dict[tuple[int, str], torch.Tensor] = {}
        pos = 0
        for r, run in enumerate(_runs(state.opt_state)):
            if run is None:
                pos += 1
                continue
            for n, t in zip(self.opt_names, flat[pos:pos + run]):
                if n in owned or pg.stage == 0:
                    mine_opt[(r, n)] = t
            pos += run
        if rank != 0:
            meta = ([(k, tuple(v.shape), str(v.dtype)) for k, v in mine_params.items()],
                    [(r, n, tuple(v.shape), str(v.dtype)) for (r, n), v in mine_opt.items()])
            dist.send_object_list([meta], dst=0, group=pg.group, device=device)
            for t in [*mine_params.values(), *mine_opt.values()]:
                dist.send(t.detach().contiguous(), dst=0, group=pg.group)
            return None
        host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        whole_params = {k: host(v) for k, v in params.items()}
        entries = {key: host(v) for key, v in mine_opt.items()}
        for k in range(1, pg.stages):
            box = [None]
            dist.recv_object_list(box, src=pg.peers[k], group=pg.group, device=device)
            p_meta, o_meta = box[0]
            for key, shape, dt in [(m[0], m[1], m[2]) for m in p_meta] + [
                    ((m[0], m[1]), m[2], m[3]) for m in o_meta]:
                buf = torch.empty(shape, dtype=_dtype(dt), device=device)
                dist.recv(buf, src=pg.peers[k], group=pg.group)
                if isinstance(key, str):
                    whole_params[key] = buf.cpu()
                else:
                    entries[key] = buf.cpu()
        out, pos = [], 0
        for r, run in enumerate(_runs(state.opt_state)):
            if run is None:
                x = flat[pos]
                out.append(host(x) if isinstance(x, torch.Tensor) else x)
                pos += 1
                continue
            out += [entries[(r, n)] for n in self.whole_opt_names]
            pos += run
        return {**sd, "params": whole_params, "opt_state": out,
                "mutable": {k: host(v) for k, v in sd["mutable"].items()},
                "embed_state": {}}
