"""Continuous batched decode for the Llama family — KV-cache slot serving;
the port of ``distributeddeeplearningspark_tpu/serve/generate.py``.

Plain :func:`~..models.llama_gen.generate` is a batch call: every row
starts together and the call returns when the slowest row finishes.
Continuous batching keeps a fixed pool of **KV-cache slots** stepping
together:

- the decode loop is ONE single-token step over all ``slots`` rows (each
  row at its own cache index: :class:`~..models.llama.KVCache`);
- when a sequence completes, its slot frees and the next queued request
  **joins mid-flight**: its prompt is prefilled in a separate bucketed
  ``[1, bucket]`` call (a fixed ladder of prefill shapes) and its cache row
  is inserted into the pool while the neighbouring slots are hundreds of
  tokens into their own sequences;
- each sampled token goes through the request's optional streaming
  callback the step it is produced.

**Paged KV arena** (``page_size=N``): KV storage becomes a pool of
fixed-size pages (``[L, num_pages, page_size, nkv, hd]`` for K and for V)
with a block table per slot (:mod:`.kv`). Each call gathers the slots'
dense cache view from their pages (:meth:`ContinuousGenerator.assemble`)
and writes the updated view back (:meth:`ContinuousGenerator.scatter`),
so the attention, and every sampled token, is the fixed-slot pool's; what
changes is the memory discipline: pages reclaim out of order on eos, and
**prefix caching** lets requests sharing a page-aligned prompt prefix (a
system prompt) reference the same prefilled pages and prefill only their
remainder. The gather and scatter are the reference's own formulation
and move the whole dense view each step (ROADMAP Queue 1 item 8 queues a
paged-attention kernel that reads the pages in place).

The decode model holds the params dict (the names of ``LlamaForCausalLM``'s
params) bound without a copy, rebound when a swap hands it another, on
``device`` (the card unless the caller asks for the CPU), under
``torch.inference_mode()``, on
the plain attention of the decode mode (no kernel lies on this path, as in
JAX, whose decode twin runs ``impl="xla"``). Params are read once per
step, so :meth:`ContinuousGenerator.swap_params` (checkpoint hot reload)
takes effect at the next token without dropping or restarting in-flight
sequences; a swap also flushes the prefix cache (its K/V was computed
under the old params). Admission is the bounded-queue / typed-shed
contract of :mod:`.engine`. Host arrays (the tokens, the positions, the
block tables) are copied to the device before the host touches them
again, so a step never reads a position the loop has already advanced.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.models.llama import KVCache
from distributeddeeplearningspark_tpu_torch.models.llama_gen import _sample, decode_model
from distributeddeeplearningspark_tpu_torch.serve.engine import (
    EngineStoppedError,
    OverloadedError,
    conform,
    host_numpy,
)
from distributeddeeplearningspark_tpu_torch.serve.kv import PagedKVArena, PrefixCache
from distributeddeeplearningspark_tpu_torch.telemetry import anatomy as anatomy_lib
from distributeddeeplearningspark_tpu_torch.telemetry import trace as trace_lib
from distributeddeeplearningspark_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.serve")


def default_prompt_buckets(max_cache_len: int) -> tuple[int, ...]:
    """Powers of two up to ``max_cache_len`` (8 at minimum): each bucket
    is one prefill shape, so the ladder is short by construction."""
    sizes = []
    b = 8
    while b < max_cache_len:
        sizes.append(b)
        b *= 2
    sizes.append(max_cache_len)
    return tuple(sizes)


def reset_index(cache: KVCache, end: int) -> KVCache:
    """A prefilled cache resumed at ``end``, the prompt's true end: the
    bucket's pads were written beyond it and stay masked until decode
    overwrites them."""
    return dataclasses.replace(cache, index=torch.full_like(cache.index, end))


@dataclass
class _GenRequest:
    rid: int
    prompt: np.ndarray                      # [T] int32
    max_new_tokens: int
    stream: Callable[[int], None] | None
    future: Future = field(default_factory=Future)
    t_submit: float = 0.0
    t_admit: float = 0.0
    tokens: list[int] = field(default_factory=list)
    prefix_hit: bool = False                # admission reused cached pages
    prefix_tokens: int = 0                  # prompt tokens NOT re-prefilled
    # wall-clock stage marks of the request's span tree: queue [ts_submit,
    # ts_pick] → admission [ts_pick, ts_prefill0] → prefill [ts_prefill0,
    # ts_prefill1] → decode [ts_prefill1, last token] → stream [last token,
    # done]; token_ts holds each sampled token's wall time
    trace: dict | None = None               # upstream trace context
    ts_submit: float = 0.0
    ts_pick: float | None = None            # first admission attempt
    ts_prefill0: float | None = None
    ts_prefill1: float | None = None
    token_ts: list[float] = field(default_factory=list)
    deferred: int = 0                       # page-pressure admission waits
    bucket: int = 0                         # prefill pad bucket used


class ContinuousGenerator:
    """A slot-pool decode server over one Llama params dict.

    ``cfg`` is the model's :class:`~..models.llama.LlamaConfig` (the
    training config; the decode twin is made here by
    :func:`~..models.llama_gen.decode_model`), ``params`` its params by
    name (tensors or numpy; moved to ``device``). The rest are JAX's:
    ``slots`` (the decode step's fixed batch), ``max_cache_len`` (every
    request needs ``len(prompt) + max_new_tokens <= max_cache_len``), the
    sampling of :func:`~..models.llama_gen.generate`, ``prompt_buckets``
    (the prefill pad ladder; pads sit after the real tokens), ``max_queue``
    (beyond it :meth:`submit` sheds with :class:`~.engine.OverloadedError`),
    ``page_size`` (None: the fixed-slot pool; an int: the paged arena, which
    must divide ``max_cache_len`` and every bucket), ``kv_pages`` (default
    ``slots × pages_per_slot + pages_per_slot + 1``), ``prefix_cache``
    (paged mode), ``gauge_interval_s`` (the ``serve`` gauge and heartbeat
    with a ``workdir``), ``step_delay_s`` (a sleep before every step: the
    "one replica got slow" drill)."""

    def __init__(
        self,
        cfg,
        params: Any,
        *,
        device: str | torch.device = "cuda",
        slots: int = 4,
        max_cache_len: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: int | None = None,
        pad_id: int = 0,
        seed: int = 0,
        prompt_buckets: Sequence[int] | None = None,
        max_queue: int = 256,
        page_size: int | None = None,
        kv_pages: int | None = None,
        prefix_cache: bool = True,
        gauge_interval_s: float = 5.0,
        step_delay_s: float = 0.0,
        workdir: str | None = None,
        name: str = "generate",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = int(slots)
        self.max_cache_len = int(max_cache_len or cfg.max_position)
        if self.max_cache_len > cfg.max_position:
            raise ValueError(
                f"max_cache_len {self.max_cache_len} exceeds max_position "
                f"{cfg.max_position}")
        self.name = name
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.max_queue = int(max_queue)
        if prompt_buckets is None:
            prompt_buckets = default_prompt_buckets(self.max_cache_len)
            if page_size:
                # paged prefill scatters whole pages, so the DEFAULT ladder
                # rounds each bucket up to a page multiple (explicit
                # buckets are validated, not rewritten)
                prompt_buckets = {
                    min(self.max_cache_len, -(-b // int(page_size)) * int(page_size))
                    for b in prompt_buckets}
        self.prompt_buckets = tuple(sorted(set(prompt_buckets)))
        if self.prompt_buckets[-1] > self.max_cache_len:
            raise ValueError(
                f"largest prompt bucket {self.prompt_buckets[-1]} exceeds "
                f"max_cache_len {self.max_cache_len}")
        # request events only with a workdir (telemetry-silent otherwise)
        self._tele = telemetry.configure(workdir) if workdir else None
        self.gauge_interval_s = float(gauge_interval_s)
        self._last_gauge = 0.0
        # floored: a negative delay would kill the serving thread the first
        # time the loop hands it to time.sleep()
        self.step_delay_s = max(0.0, float(step_delay_s))

        self._model = decode_model(cfg, self.max_cache_len)
        names = {n for n, _ in self._model.named_parameters()}
        params = conform(dict(params), None, self.device)
        if set(params) != names:
            raise ValueError(
                f"params do not match the model: missing "
                f"{sorted(names - set(params))[:3]}, unexpected "
                f"{sorted(set(params) - names)[:3]}")
        self._params = params
        self._bound = None
        self.params_version: int | str = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sample_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)

        # in the signature ledger (telemetry/anatomy.py): prefill's expected
        # set is the prompt-bucket ladder, the step and the insert one each
        buckets = len(self.prompt_buckets)
        self.page_size = int(page_size) if page_size is not None else None
        if self.page_size is None:
            self._arena = None
            self._prefix = None
            self._cache = KVCache.zeros(cfg, self.slots, max_cache_len=self.max_cache_len,
                                        device=self.device)
            self._prefill = anatomy_lib.instrument(
                self._dense_prefill, name="decode-prefill", expected_signatures=buckets)
            self._step = anatomy_lib.instrument(self._dense_step, name="decode-step")
            self._insert = anatomy_lib.instrument(self._dense_insert, name="decode-insert")
        else:
            self._init_paged(kv_pages, prefix_cache)
            self._prefill = anatomy_lib.instrument(
                self._paged_prefill, name="decode-prefill", expected_signatures=buckets)
            self._step = anatomy_lib.instrument(self._paged_step, name="decode-step")
        self._cur_tok = np.zeros((self.slots,), np.int32)

        self._queue: list[_GenRequest] = []
        self._active: list[_GenRequest | None] = [None] * self.slots
        self._cond = threading.Condition()
        # accepting from construction, like InferenceEngine: requests queue
        # up; decoding begins when start() spawns the serving thread
        self._stopped = False
        self._thread: threading.Thread | None = None
        self._rid = itertools.count()
        self._stats = {"requests": 0, "shed": 0, "completed": 0, "steps": 0,
                       "admitted": 0, "reloads": 0, "max_active": 0,
                       "tokens": 0, "deferred": 0}

    # -- the device calls ----------------------------------------------------

    def _forward(self, params, ids: torch.Tensor, cache: KVCache):
        """The decode model on ``params``, bound to it (without a copy) when
        the snapshot changes: the serving thread alone calls it, so a swap
        lands between steps."""
        if params is not self._bound:
            self._model.load_state_dict(params, assign=True)
            self._bound = params
        with torch.inference_mode():
            return self._model({"input_ids": ids}, cache=cache)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return _sample(logits.float(), self._gen, **self._sample_kw)

    def _ids(self, host: np.ndarray) -> torch.Tensor:
        """A host int array as a fresh device tensor (copied now: the host
        array may change before the step runs)."""
        return torch.tensor(host, dtype=torch.long, device=self.device)

    def _dense_prefill(self, params, ids: torch.Tensor, true_len: int):
        """``[1, bucket]`` prompt → (its cache row, resumed at ``true_len``;
        the first token)."""
        row = KVCache.zeros(self.cfg, 1, max_cache_len=self.max_cache_len,
                            device=self.device)
        logits, row = self._forward(params, ids, row)
        return reset_index(row, true_len), self._sample(logits[:, true_len - 1])

    def _dense_step(self, params, cache: KVCache, tok: torch.Tensor):
        """One decode token for every slot at once."""
        logits, cache = self._forward(params, tok[:, None], cache)
        return cache, self._sample(logits[:, -1])

    def _dense_insert(self, cache: KVCache, row: KVCache, slot: int) -> KVCache:
        """Write a prefilled ``[1, ...]`` cache row into pool slot ``slot``."""
        with torch.inference_mode():
            cache.k[:, slot] = row.k[:, 0]
            cache.v[:, slot] = row.v[:, 0]
            cache.index[slot] = row.index[0]
        return cache

    # -- paged KV arena ------------------------------------------------------

    def _init_paged(self, kv_pages, prefix_cache) -> None:
        """The page pool (K and V ``[L, num_pages, page_size, nkv, hd]``),
        the block tables and the arena. Positions live host-side in
        ``self._pos`` and become the dense view's index at assemble time."""
        page = self.page_size
        if self.max_cache_len % page:
            raise ValueError(
                f"page_size {page} must divide max_cache_len {self.max_cache_len}")
        bad = [b for b in self.prompt_buckets if b % page]
        if bad:
            raise ValueError(
                f"page_size {page} must divide every prompt bucket "
                f"(violating: {bad}) — prefill scatters whole pages")
        self._pps = self.max_cache_len // page
        num_pages = (int(kv_pages) if kv_pages is not None
                     else self.slots * self._pps + self._pps + 1)
        if num_pages < self._pps + 1:
            raise ValueError(
                f"kv_pages {num_pages} cannot back one full sequence "
                f"({self._pps} pages + the trash page)")
        self._arena = PagedKVArena(num_pages, page)
        self._prefix = PrefixCache(self._arena) if prefix_cache else None
        self._prefix_version = self.params_version
        cfg = self.cfg
        shape = (cfg.num_layers, num_pages, page, cfg.num_kv_heads, cfg.head_dim)
        self._pool = (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                      torch.zeros(shape, dtype=cfg.dtype, device=self.device))
        self._tables = np.zeros((self.slots, self._pps), np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(self.slots)]
        self._pos = np.zeros((self.slots,), np.int32)

    def assemble(self, tables: torch.Tensor, pos: torch.Tensor) -> KVCache:
        """The dense cache view of the rows ``tables`` ``[R, pages_per_slot]``
        backs: their pages gathered and merged into the length axis, the
        index ``pos`` ``[R]``."""
        k_pool, v_pool = self._pool
        layers, rows = k_pool.shape[0], tables.shape[0]
        with torch.inference_mode():
            k, v = (pool[:, tables].reshape(layers, rows, self.max_cache_len,
                                             *pool.shape[3:])
                    for pool in (k_pool, v_pool))
        return KVCache(k, v, pos)

    def scatter(self, cache: KVCache, tables: torch.Tensor) -> None:
        """Write a dense cache view back to its pages. Duplicate page ids in
        the tables (shared prefix pages, the trash page) land in any order:
        shared pages always receive identical values (decode never writes
        below a prompt's end), and the trash page is garbage by contract."""
        flat = tables.reshape(-1)
        with torch.inference_mode():
            for pool, dense in zip(self._pool, (cache.k, cache.v)):
                pool[:, flat] = dense.reshape(pool.shape[0], flat.shape[0],
                                              *pool.shape[2:])

    def _paged_step(self, params, tables: torch.Tensor, pos: torch.Tensor,
                    tok: torch.Tensor) -> torch.Tensor:
        cache = self.assemble(tables, pos)
        logits, cache = self._forward(params, tok[:, None], cache)
        self.scatter(cache, tables)
        return self._sample(logits[:, -1])

    def _paged_prefill(self, params, row_tables: torch.Tensor, start: int,
                       ids: torch.Tensor, true_end: int) -> torch.Tensor:
        """Prefill ``ids`` (a window at cache position ``start``) into the
        row ``row_tables`` backs: ``start=0`` is a whole prefill, above 0 it
        continues from cached prefix pages. The row resumes at
        ``true_end``."""
        row = self.assemble(row_tables, torch.full((1,), start, dtype=torch.int32,
                                                   device=self.device))
        logits, row = self._forward(params, ids, row)
        row = reset_index(row, true_end)
        tok = self._sample(logits[:, true_end - start - 1])
        self.scatter(row, row_tables)
        return tok

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ContinuousGenerator":
        with self._cond:
            if self._thread is not None:
                return self
            self._stopped = False
            self._thread = threading.Thread(
                target=self._loop, name=f"dlserve-{self.name}", daemon=True)
            self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop admission; by default finish queued + in-flight sequences.
        A never-started generator with queued requests starts the serving
        thread just to drain them: drain=True never strands a future."""
        if drain and self._thread is None and self._queue:
            self.start()
        with self._cond:
            if self._stopped and self._thread is None:
                return
            self._stopped = True
            if not drain:
                for req in self._queue:
                    req.future.set_exception(
                        EngineStoppedError("generator stopped before admission"))
                    if self._tele is not None:
                        self._tele.clear_span(("gen", req.rid))
                self._queue.clear()
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
        self._thread = None

    def __enter__(self) -> "ContinuousGenerator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               stream: Callable[[int], None] | None = None,
               trace: dict | None = None) -> Future:
        """Enqueue a prompt; the Future resolves to the np.int32 tokens.

        ``stream`` is called with each token id the step it is sampled (from
        the serving thread: keep it cheap). ``trace`` is an upstream trace
        context (``{"trace_id", "parent_id"}``) the request's stage spans
        join instead of rooting a fresh trace."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_cache_len:
            raise ValueError(
                f"prompt {prompt.size} + new {max_new_tokens} exceeds "
                f"max_cache_len {self.max_cache_len}")
        if prompt.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt {prompt.size} exceeds largest prompt bucket "
                f"{self.prompt_buckets[-1]}")
        req = _GenRequest(rid=next(self._rid), prompt=prompt,
                          max_new_tokens=int(max_new_tokens), stream=stream,
                          trace=(trace if isinstance(trace, dict)
                                 and trace.get("trace_id") else None))
        req.t_submit = time.monotonic()
        req.ts_submit = time.time()
        with self._cond:
            if self._stopped:
                raise EngineStoppedError("generator is stopped")
            if len(self._queue) >= self.max_queue:
                self._stats["shed"] += 1
                if self._tele is not None:
                    self._tele.emit("request", engine=self.name, id=req.rid,
                                    outcome="shed", queue_depth=len(self._queue),
                                    **({"trace": req.trace["trace_id"]}
                                       if req.trace else {}))
                raise OverloadedError(len(self._queue), self.max_queue)
            self._queue.append(req)
            self._stats["requests"] += 1
            if self._tele is not None:
                # under the lock: once it drops, the loop may finish the
                # request and clear its span before a late note re-opens it
                self._tele.note_span(("gen", req.rid), "request")
            self._cond.notify_all()
        return req.future

    def generate(self, prompt, max_new_tokens: int, *,
                 timeout: float | None = 120.0,
                 stream: Callable[[int], None] | None = None) -> np.ndarray:
        """Blocking convenience: ``submit`` + ``result``."""
        return self.submit(prompt, max_new_tokens, stream=stream).result(
            timeout=timeout)

    def stats(self) -> dict[str, Any]:
        with self._cond:
            out = dict(self._stats)
            out["queue_depth"] = len(self._queue)
            out["active"] = sum(r is not None for r in self._active)
        out["params_version"] = self.params_version
        if self._arena is not None:
            out.update(self._arena.stats())
        if self._prefix is not None:
            out.update(self._prefix.stats())
        return out

    # -- hot reload ----------------------------------------------------------

    def swap_params(self, params: Any, *, version: int | str | None = None) -> None:
        """Swap the params between decode steps: in-flight sequences keep
        their KV cache and go on with the new params at the next token. The
        prefix cache is flushed by the serving thread before its next
        admission (its pages hold K/V of the old params). Numpy leaves (a
        peer's export) become tensors in the dtype of the param they
        replace."""
        params = conform(dict(params), self._params, self.device)
        with self._cond:
            self._params = params
            self._stats["reloads"] += 1
            if version is not None:
                self.params_version = version
            elif isinstance(self.params_version, int):
                self.params_version += 1

    def export_params(self) -> tuple[Any, int | str]:
        """Host snapshot of the serving params, ``(dict, version)``: the
        :meth:`.engine.InferenceEngine.export_params` contract (numpy
        leaves, bf16 as f32; the version from the same swap)."""
        with self._cond:
            params = self._params
            version = self.params_version
        return {k: host_numpy(v) for k, v in params.items()}, version

    # -- serving loop --------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return self.prompt_buckets[-1]

    def _finish(self, req: _GenRequest, *, n_active: int) -> None:
        done = time.monotonic()
        req.future.set_result(np.asarray(req.tokens, np.int32))
        ts_done = time.time()
        with self._cond:
            self._stats["completed"] += 1
            self._stats["tokens"] += len(req.tokens)
        if self._tele is not None:
            self._tele.emit(
                "request", engine=self.name, id=req.rid, outcome="ok",
                tokens=len(req.tokens),
                queue_wait_s=round(req.t_admit - req.t_submit, 6),
                latency_s=round(done - req.t_submit, 6),
                batch_size=n_active,
                **({"trace": req.trace["trace_id"]} if req.trace else {}),
                **({"prefix_hit": req.prefix_hit,
                    "prefix_tokens": req.prefix_tokens}
                   if self.paged and self._prefix is not None else {}))
            self._emit_request_spans(req, ts_done, outcome="ok")
            self._tele.clear_span(("gen", req.rid))

    def _emit_request_spans(self, req: _GenRequest, ts_done: float, *,
                            outcome: str, error: str | None = None) -> None:
        """The request's whole stage tree in ONE ``emit_many`` flush at
        completion: queue → admission → prefill → decode → stream. The
        stages tile ``[submit, done]`` by construction."""
        buf = trace_lib.SpanBuffer.from_context(req.trace)
        parent = buf.parent_id
        if not buf.joined:
            parent = buf.add("request", req.ts_submit, ts_done,
                             engine=self.name, outcome=outcome,
                             **({"error": error} if error else {}))
        ts_pick = req.ts_pick if req.ts_pick is not None else ts_done
        # queue starts at the ROUTER's accept time when the context carries
        # one: transit and dispatch are queueing from the request's view
        buf.add("queue", trace_lib.SpanBuffer.upstream_t0(
            req.trace, req.ts_submit), ts_pick, parent_id=parent)
        if req.ts_prefill0 is not None:
            buf.add("admission", ts_pick, req.ts_prefill0, parent_id=parent,
                    deferred=req.deferred, prefix_hit=req.prefix_hit,
                    prefix_tokens=req.prefix_tokens)
            if req.ts_prefill1 is None and error is not None:
                # the prefill itself raised: its elapsed time is the prefill
                buf.add("prefill", req.ts_prefill0, ts_done, parent_id=parent,
                        prompt_tokens=int(req.prompt.size), bucket=req.bucket,
                        error=error)
                buf.flush(self._tele)
                return
            ts_p1 = (req.ts_prefill1 if req.ts_prefill1 is not None
                     else req.ts_prefill0)
            buf.add("prefill", req.ts_prefill0, ts_p1, parent_id=parent,
                    prompt_tokens=int(req.prompt.size), bucket=req.bucket,
                    prefix_tokens=req.prefix_tokens)
            last_tok = req.token_ts[-1] if req.token_ts else ts_p1
            timeline = req.token_ts[:trace_lib.MAX_TOKEN_TIMELINE]
            buf.add("decode", ts_p1, last_tok, parent_id=parent,
                    tokens=len(req.tokens),
                    first_token_s=(round(req.token_ts[0] - req.ts_submit, 6)
                                   if req.token_ts else None),
                    token_ms=[round((t - ts_p1) * 1e3, 2) for t in timeline])
            buf.add("stream", last_tok, ts_done, parent_id=parent)
        elif error is not None:
            # died before prefill: the queue span plus the error evidence
            buf.add("admission", ts_pick, ts_done, parent_id=parent,
                    deferred=req.deferred, error=error)
        buf.flush(self._tele)

    def _emit_token(self, req: _GenRequest, tok: int) -> bool:
        """Record one sampled token; True when the sequence is complete."""
        req.tokens.append(tok)
        req.token_ts.append(time.time())
        if req.stream is not None:
            try:
                req.stream(tok)
            except Exception:  # noqa: BLE001 — a client callback must not
                logger.exception("stream callback failed (request %d)", req.rid)
        return (len(req.tokens) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id))

    def _admit(self, req: _GenRequest, slot: int, params, version) -> bool:
        """Prefill ``req`` and insert its cache row into ``slot``.

        ``version`` is the caller's snapshot, taken with ``params`` under one
        lock hold: prefix-cache entries are keyed by the version of the
        params that computed them. False when admission must wait (paged
        mode, the arena out of pages until a completion frees some); the
        caller re-queues the request at the front. The dense path always
        admits."""
        if self.paged:
            return self._admit_paged(req, slot, params, version)
        req.t_admit = time.monotonic()
        bucket = self._bucket(req.prompt.size)
        req.bucket = bucket
        ids = np.full((1, bucket), self.pad_id, np.int32)
        ids[0, :req.prompt.size] = req.prompt
        req.ts_prefill0 = time.time()
        row, tok = self._prefill(params, self._ids(ids), int(req.prompt.size))
        tok = int(tok[0])
        req.ts_prefill1 = time.time()
        with self._cond:
            self._stats["admitted"] += 1
        n_active = sum(r is not None for r in self._active) + 1
        if self._emit_token(req, tok):
            # a one-token request (or an instant eos) never holds the slot
            self._finish(req, n_active=n_active)
            return True
        self._cache = self._insert(self._cache, row, slot)
        self._cur_tok[slot] = tok
        self._active[slot] = req
        with self._cond:
            self._stats["max_active"] = max(self._stats["max_active"], n_active)
        return True

    def _admit_paged(self, req: _GenRequest, slot: int, params, version) -> bool:
        page = self.page_size
        plen = int(req.prompt.size)
        total = plen + req.max_new_tokens

        # the longest cached prefix, shrunk until a remainder bucket fits the
        # cache (a near-full prompt may need a shallower reuse depth)
        n_shared, shared = (self._prefix.lookup(req.prompt, version)
                            if self._prefix is not None else (0, []))
        while True:
            start = n_shared * page
            rem = plen - start
            rb = next((b for b in self.prompt_buckets
                       if b >= rem and start + b <= self.max_cache_len), None)
            if rb is not None:
                break
            # submit() guarantees plen fits the largest bucket, so the loop
            # ends at n_shared == 0 at the latest
            self._arena.release([shared.pop()])
            n_shared -= 1
        hit = n_shared > 0

        # back every position prefill or decode will touch
        cover = -(-max(total, start + rb) // page)
        owned = self._arena.alloc(cover - n_shared)
        if owned is None and self._prefix is not None:
            # the cache scavenges free pages, never refuses admission: evict
            # LRU entries until the allocation fits
            self._prefix.evict_until(cover - n_shared)
            owned = self._arena.alloc(cover - n_shared)
        if owned is None:
            # in-flight slots hold the pages; a completion will free them.
            # Re-queued by the caller: a full sequence always fits an empty
            # arena (the constructor's check), so progress is certain
            if shared:
                self._arena.release(shared)
            with self._cond:
                self._stats["deferred"] += 1
            req.deferred += 1
            return False

        pages = shared + owned
        self._slot_pages[slot] = pages
        self._tables[slot, :] = 0
        self._tables[slot, :len(pages)] = pages

        req.t_admit = time.monotonic()
        req.prefix_hit, req.prefix_tokens = hit, start
        req.bucket = rb
        ids = np.full((1, rb), self.pad_id, np.int32)
        ids[0, :rem] = req.prompt[start:]
        req.ts_prefill0 = time.time()
        try:
            tok = self._prefill(params, self._ids(self._tables[slot:slot + 1]),
                                start, self._ids(ids), plen)
            tok = int(tok[0])
            req.ts_prefill1 = time.time()
        except BaseException:
            # a poisoned prompt fails ITS future in _loop, but the pages just
            # allocated or retained go back, or each failure leaks them
            self._release_slot(slot)
            raise
        if self._prefix is not None:
            self._prefix.record(start if hit else 0)
            # register every page-aligned depth of THIS prompt (retains the
            # pages) before any release, so an instant finish cannot reclaim
            # pages the cache wants
            self._prefix.register(req.prompt, pages[:plen // page], version)
        with self._cond:
            self._stats["admitted"] += 1
        n_active = sum(r is not None for r in self._active) + 1
        if self._emit_token(req, tok):
            self._release_slot(slot)
            self._finish(req, n_active=n_active)
            return True
        self._pos[slot] = plen
        self._cur_tok[slot] = tok
        self._active[slot] = req
        with self._cond:
            self._stats["max_active"] = max(self._stats["max_active"], n_active)
        return True

    def _release_slot(self, slot: int) -> None:
        """Return a slot's pages to the arena (pages the prefix cache
        retained survive at a lower refcount) and reset its table row."""
        if self._slot_pages[slot]:
            self._arena.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
        self._tables[slot, :] = 0
        self._pos[slot] = 0

    # -- telemetry gauges ----------------------------------------------------

    def _maybe_gauge(self, *, force: bool = False) -> None:
        if self._tele is None:
            return
        now = time.monotonic()
        if not force and now - self._last_gauge < self.gauge_interval_s:
            return
        self._last_gauge = now
        # a liveness stamp on the gauge's cadence: when the loop wedges in a
        # step, this heartbeat is the stream's last record and names the
        # oldest in-flight request
        self._tele.heartbeat()
        fields: dict[str, Any] = {
            "engine": self.name,
            "active": sum(r is not None for r in self._active),
            "queue_depth": len(self._queue),
            "completed": self._stats["completed"],
            "params_version": self.params_version,
        }
        if self._arena is not None:
            fields.update(self._arena.stats())
        if self._prefix is not None:
            fields.update(self._prefix.stats())
        self._tele.emit("serve", **fields)

    # -- the loop ------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                idle = not self._queue and all(r is None for r in self._active)
                if idle:
                    if self._stopped:
                        self._maybe_gauge(force=True)
                        return
                    self._cond.wait(0.05)
                    continue
                # one lock hold: the version must be THE version of this
                # params snapshot (admissions key prefix-cache entries by it)
                params = self._params
                version = self.params_version
            # a swap stales every cached prefix K/V: flush before any
            # admission could hit one (the serving thread owns the cache)
            if self._prefix is not None and self._prefix_version != version:
                self._prefix.flush()
                self._prefix_version = version
            while True:
                with self._cond:
                    free = next((s for s in range(self.slots)
                                 if self._active[s] is None), None)
                    if free is None or not self._queue:
                        break
                    req = self._queue.pop(0)
                if req.ts_pick is None:    # first admission attempt only:
                    req.ts_pick = time.time()  # re-queues keep queue = wait
                try:
                    admitted = self._admit(req, free, params, version)
                except Exception as e:  # noqa: BLE001 — a poisoned prompt
                    # fails ITS future; the pool keeps serving the rest
                    logger.exception("prefill failed (request %d)", req.rid)
                    req.future.set_exception(e)
                    if self._tele is not None:
                        err = f"{type(e).__name__}: {e}"
                        self._tele.emit("request", engine=self.name, id=req.rid,
                                        outcome="error", error=err,
                                        **({"trace": req.trace["trace_id"]}
                                           if req.trace else {}))
                        self._emit_request_spans(req, time.time(),
                                                 outcome="error", error=err)
                        self._tele.clear_span(("gen", req.rid))
                    continue
                if not admitted:
                    # the arena is full: the request keeps its place and
                    # waits for a completion to free pages
                    with self._cond:
                        self._queue.insert(0, req)
                    break
            self._maybe_gauge()
            if all(r is None for r in self._active):
                continue
            if self.step_delay_s:
                time.sleep(self.step_delay_s)
            tok = self._ids(self._cur_tok)
            if self.paged:
                # positions and tables copied to the device before the host
                # advances them below
                nxt = self._step(params, self._ids(self._tables),
                                 torch.tensor(self._pos, device=self.device), tok)
                nxt = nxt.cpu().numpy()
                for slot, req in enumerate(self._active):
                    if req is not None:
                        self._pos[slot] += 1
            else:
                self._cache, nxt = self._step(params, self._cache, tok)
                nxt = nxt.cpu().numpy()
            with self._cond:
                self._stats["steps"] += 1
            n_active = sum(r is not None for r in self._active)
            for slot, req in enumerate(self._active):
                if req is None:
                    continue
                tok = int(nxt[slot])
                if self._emit_token(req, tok):
                    self._active[slot] = None       # frees the slot: the
                    if self.paged:                  # next queued request
                        self._release_slot(slot)    # joins mid-flight
                    self._finish(req, n_active=n_active)
                    continue
                self._cur_tok[slot] = tok
