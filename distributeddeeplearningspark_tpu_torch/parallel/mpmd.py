"""MPMD inter-stage transport — authenticated socket links between stage
processes, the port of ``distributeddeeplearningspark_tpu/parallel/mpmd.py``.

Each pipeline stage of :mod:`..train.pipeline_trainer` is its own process on
its own card and never joins a collective: activations go down the chain and
gradients come back up over these links.

- **Framing** (JAX's, unchanged): a length-prefixed frame, magic, version,
  kind, sender stage, microbatch index, payload CRC32 and payload length.
  The CRC and the magic turn a torn or corrupted frame into a typed
  :class:`FrameError` instead of a desync that decodes garbage.
- **Payloads** (the port's codec): JAX pickles numpy, which has no bf16.
  Here a payload is a small pickled skeleton (ints, floats, strings, the
  trace context) in which each tensor or numpy array is replaced by a
  :class:`_Blob` (dtype, shape, byte offset); the raw bytes of each follow
  the skeleton, each on a 64-byte boundary, and the CRC covers them all.
  :func:`encode_payload` copies a CUDA tensor to the host once, into a
  pinned buffer, on the caller's (compute) thread; the receiver reads a
  frame's bytes straight into one buffer (pinned on a card), and
  :func:`to_device` copies each tensor to the card with ``non_blocking`` on
  the caller's thread. A link thread never touches a CUDA tensor and never
  pickles a large object: it runs ``sendall``, ``recv_into`` and
  ``zlib.crc32``, which release the interpreter lock, so the compute thread
  keeps issuing kernels while a frame is in flight.
- **Auth**: a mutual HMAC-SHA256 challenge on the raw socket (hex key via
  env); an unauthenticated peer never reaches the frame loop.
- **Double buffering**: each :class:`StageLink` runs a sender and a
  receiver thread over bounded deques (default depth 2), so stage *k*
  computes microbatch *i* while *i+1* is in flight, and a slow consumer
  propagates bounded backpressure (deque full → TCP buffer full → sender
  blocks) instead of buffering without bound.
- **Failure typing**: a peer process dying tears the socket; every blocked
  and later ``send``/``recv`` raises :class:`PeerDiedError` within a
  bounded wait. A peer alive but silent past ``timeout`` raises
  :class:`TransportTimeout`. The pipeline supervisor restarts only the
  dead stage; the survivors block in :meth:`PipelineTransport.connect`
  until it returns, calling their ``tick`` (the heartbeat) while they wait.
- **Chain topology + resync**: stage *k* listens on ``ports[k]`` for stage
  *k+1* and dials ``ports[k-1]``; after any (re)connect
  :meth:`PipelineTransport.sync_step` runs a forward-min / backward-
  broadcast wave so every stage agrees on the checkpoint step to resume
  from.
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import pickle
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

logger = logging.getLogger("distributeddeeplearningspark_tpu_torch.mpmd")

MAGIC = b"DLSP"
VERSION = 1

#: frame kinds. ACT/GRAD are the data plane (bounded queues, double-
#: buffered); the rest are control (small, effectively unbounded).
HELLO = 0
ACT = 1
GRAD = 2
META = 3
SYNC_FWD = 4
SYNC_BWD = 5
METRICS = 6
DONE = 7

_KIND_NAMES = {HELLO: "hello", ACT: "act", GRAD: "grad", META: "meta",
               SYNC_FWD: "sync-fwd", SYNC_BWD: "sync-bwd",
               METRICS: "metrics", DONE: "done"}

#: header: magic, version, kind, sender stage, microbatch index,
#: payload crc32, payload length.
_HEADER = struct.Struct("!4sBBhiII")
#: a payload opens with its skeleton's length
_META_LEN = struct.Struct("!I")
#: each tensor's bytes start on this boundary of the payload
_ALIGN = 64

#: env contract exported by the PipelineSupervisor to every stage process.
ENV_STAGE = "DLS_STAGE_ID"
ENV_NUM_STAGES = "DLS_NUM_STAGES"
ENV_PORTS = "DLS_PIPE_PORTS"
ENV_AUTHKEY = "DLS_PIPE_AUTHKEY"
ENV_SPEC = "DLS_PIPE_SPEC"


class TransportError(RuntimeError):
    """Base class for inter-stage transport failures."""


class PeerDiedError(TransportError):
    """The peer stage's socket tore (process death / connection reset).
    Raised to every blocked and subsequent caller within a bounded wait."""


class FrameError(TransportError):
    """The byte stream desynced: bad magic, impossible length, CRC
    mismatch, or a frame torn mid-payload. Unlike a clean peer death the
    stream cannot be trusted past this point — the link is marked dead."""


class TransportTimeout(TransportError):
    """The peer is (as far as TCP knows) alive but nothing arrived/ drained
    within the caller's timeout."""


# -- the payload codec -----------------------------------------------------------


class _Blob(NamedTuple):
    """A tensor's place in a payload's skeleton: ``kind`` "torch" or
    "numpy", its dtype's name, shape, and its bytes' offset and length."""

    kind: str
    dtype: str
    shape: tuple
    offset: int
    nbytes: int


class Encoded:
    """A payload ready for the wire: the skeleton's bytes and each tensor's
    host bytes (``parts``, in payload order, padding included), and their
    total length."""

    def __init__(self, parts: list, nbytes: int, tensor_bytes: int):
        self.parts = parts
        self.nbytes = nbytes
        #: the tensors' own bytes (padding and skeleton excluded)
        self.tensor_bytes = tensor_bytes

    def tobytes(self) -> bytes:
        return b"".join(bytes(p) for p in self.parts)

    def crc32(self) -> int:
        crc = 0
        for p in self.parts:
            crc = zlib.crc32(p, crc)
        return crc & 0xFFFFFFFF


def _host_bytes(t: torch.Tensor, pin: bool) -> np.ndarray:
    """``t``'s bytes on the host, contiguous, as a flat uint8 array: a
    CUDA tensor copied once (into pinned memory with ``pin``); a CPU
    tensor as it is (a copy only when not contiguous)."""
    t = t.detach()
    if t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        host.copy_(t)
        t = host
    else:
        t = t.contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


def encode_payload(obj: Any, *, pin: bool = False) -> Encoded:
    """``obj`` (dicts, lists and tuples of plain values, tensors and numpy
    arrays) as an :class:`Encoded` payload. Runs on the caller's thread:
    a CUDA tensor's copy to the host happens here, into pinned memory with
    ``pin``."""
    blobs: list[np.ndarray] = []
    offset = [0]  # the tensors' bytes' offset past the skeleton, so far

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(walk(v) for v in x)
        if isinstance(x, torch.Tensor):
            raw, kind, dtype = _host_bytes(x, pin), "torch", str(x.dtype).split(".")[-1]
        elif isinstance(x, np.ndarray):
            raw = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
            kind, dtype = "numpy", x.dtype.str
        else:
            return x
        start = -(-offset[0] // _ALIGN) * _ALIGN
        offset[0] = start + raw.nbytes
        blobs.append(raw)
        return _Blob(kind, dtype, tuple(x.shape), start, raw.nbytes)

    skeleton = walk(obj)
    meta = pickle.dumps(skeleton, protocol=4)
    head = _META_LEN.pack(len(meta)) + meta
    base = -(-len(head) // _ALIGN) * _ALIGN
    parts: list = [head + bytes(base - len(head))]
    pos = 0
    for raw in blobs:
        pad = (-pos) % _ALIGN
        if pad:
            parts.append(bytes(pad))
        parts.append(raw)
        pos += pad + raw.nbytes
    return Encoded(parts, base + pos, sum(b.nbytes for b in blobs))


def _as_buffer(data) -> torch.Tensor:
    """A received payload as a flat uint8 tensor (bytes are copied)."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def decode_payload(data) -> Any:
    """The object :func:`encode_payload` encoded, from the payload's bytes
    (bytes, or the flat uint8 tensor :func:`read_frame` returns): each
    tensor a view of that buffer (on the CPU; pinned where the buffer is),
    each numpy array a view too."""
    buf = _as_buffer(data)
    raw = buf.numpy()
    (meta_len,) = _META_LEN.unpack_from(raw, 0)
    skeleton = pickle.loads(raw[_META_LEN.size:_META_LEN.size + meta_len].tobytes())
    base = -(-(_META_LEN.size + meta_len) // _ALIGN) * _ALIGN

    def walk(x):
        if isinstance(x, _Blob):
            lo, hi = base + x.offset, base + x.offset + x.nbytes
            if x.kind == "numpy":
                return raw[lo:hi].view(np.dtype(x.dtype)).reshape(x.shape)
            return buf[lo:hi].view(getattr(torch, x.dtype)).view(x.shape)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(skeleton)


def to_device(obj: Any, device) -> Any:
    """``obj`` with each tensor copied to ``device`` (``non_blocking``: from
    a pinned buffer the copy is asynchronous and stream-ordered before the
    kernels that read it). Run it on the compute thread."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def pack_frame(kind: int, stage: int, mb: int, payload) -> bytes:
    """One whole frame (``payload``: bytes or an :class:`Encoded`)."""
    data = payload.tobytes() if isinstance(payload, Encoded) else bytes(payload)
    return _HEADER.pack(MAGIC, VERSION, kind, stage, mb,
                        zlib.crc32(data) & 0xFFFFFFFF, len(data)) + data


def _read_exact(sock: socket.socket, n: int, *, what: str,
                into: memoryview | None = None) -> bytes | memoryview:
    """Read exactly ``n`` bytes (into ``into`` when given). EOF at offset 0
    returns b'' (clean close); EOF mid-read raises FrameError (a torn
    frame)."""
    view = memoryview(bytearray(n)) if into is None else into
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except OSError as e:
            raise PeerDiedError(f"socket error reading {what}: {e}") from e
        if k == 0:
            if got == 0:
                return b""
            raise FrameError(
                f"torn frame: stream ended {got}/{n} bytes into {what}")
        got += k
    return bytes(view) if into is None else view


def _plain_buffer(n: int) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8)


def _pinned_buffer(n: int) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8, pin_memory=True)


def read_frame(sock: socket.socket, *, max_payload: int = 1 << 31,
               alloc: Callable[[int], torch.Tensor] = _plain_buffer
               ) -> tuple[int, int, int, torch.Tensor] | None:
    """One (kind, stage, mb, payload) frame, the payload a flat uint8
    tensor from ``alloc`` (the bytes read straight into it), or None on
    clean EOF at a frame boundary. Validates magic, version, length
    sanity, and payload CRC — any mismatch is a :class:`FrameError`."""
    head = _read_exact(sock, _HEADER.size, what="frame header")
    if not head:
        return None
    magic, version, kind, stage, mb, crc, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r} (stream desync)")
    if version != VERSION:
        raise FrameError(f"frame version {version} != {VERSION}")
    if length > max_payload:
        raise FrameError(f"frame length {length} exceeds cap {max_payload}")
    payload = alloc(length)
    what = f"{_KIND_NAMES.get(kind, kind)} payload"
    if length:
        got = _read_exact(sock, length, what=what,
                          into=memoryview(payload.numpy()))
        if not got:
            raise FrameError("torn frame: stream ended before payload")
    if (zlib.crc32(payload.numpy()) & 0xFFFFFFFF) != crc:
        raise FrameError(
            f"payload checksum mismatch on {_KIND_NAMES.get(kind, kind)} "
            f"frame (mb={mb}) — torn or corrupted in flight")
    return kind, stage, mb, payload


# -- authkey handshake (the serve/fleet idiom on a raw socket) ----------------


def _challenge(sock: socket.socket, authkey: bytes, *, server: bool) -> None:
    """Mutual HMAC-SHA256 challenge. Both sides prove possession of the
    key; failure closes the socket with TransportError (an unauthenticated
    peer must never reach the frame loop)."""
    def send_nonce() -> bytes:
        nonce = os.urandom(16)
        sock.sendall(b"DLSPCHAL" + nonce)
        return nonce

    def answer() -> None:
        tag = _read_exact(sock, 8, what="challenge tag")
        if tag != b"DLSPCHAL":
            raise TransportError(f"bad challenge tag {tag!r}")
        nonce = _read_exact(sock, 16, what="challenge nonce")
        if len(nonce) != 16:
            raise TransportError("short challenge nonce")
        sock.sendall(hmac.new(authkey, nonce, "sha256").digest())

    def verify(nonce: bytes) -> None:
        digest = _read_exact(sock, 32, what="challenge response")
        want = hmac.new(authkey, nonce, "sha256").digest()
        if not hmac.compare_digest(digest, want):
            raise TransportError("authkey challenge failed")

    if server:
        nonce = send_nonce()
        verify(nonce)
        answer()
    else:
        answer()
        nonce = send_nonce()
        verify(nonce)


class StageLink:
    """One authenticated, framed, double-buffered link to a peer stage.

    ``send(kind, obj, mb)`` enqueues (bounded; blocks past ``depth`` in
    flight = the backpressure bound) and a sender thread writes frames;
    ``recv(kind)`` pops from that kind's bounded inbox filled by the
    receiver thread. Control kinds (META/SYNC/METRICS/DONE) share an
    unbounded-depth inbox — they are tiny and must never deadlock behind
    a full data queue. ``pinned``: frames are received into pinned host
    memory (a stage on a card), so :func:`to_device` copies them
    asynchronously. The sender thread counts the frames, payload bytes
    and ``sendall`` seconds of each kind it sent (``sent``).
    """

    def __init__(self, sock: socket.socket, *, stage: int, peer_stage: int,
                 depth: int = 2, hello: dict | None = None,
                 hello_timeout: float = 60.0, pinned: bool = False):
        self.stage = stage
        self.peer_stage = peer_stage
        self.sock = sock
        self.depth = max(1, int(depth))
        self._alloc = _pinned_buffer if pinned else _plain_buffer
        self._cond = threading.Condition()
        self._send_q: deque = deque()
        self._inbox: dict[int, deque] = {ACT: deque(), GRAD: deque()}
        self._ctrl: deque = deque()
        self._err: TransportError | None = None
        self._done_seen = False
        self._closed = False
        #: kind → [frames, payload bytes, sendall seconds], by the sender
        self.sent: dict[int, list] = {}
        # HELLO crosses synchronously before the threads exist, so both
        # ends learn (stage, committed step, attempt) — the resync wave's
        # inputs — before any data frame can race it.
        sock.settimeout(hello_timeout)
        sock.sendall(pack_frame(HELLO, stage, -1,
                                encode_payload(dict(hello or {}, stage=stage))))
        first = read_frame(sock)
        if first is None:
            raise PeerDiedError(f"peer stage {peer_stage} closed before hello")
        kind, pstage, _, payload = first
        if kind != HELLO:
            raise FrameError(f"expected hello, got {_KIND_NAMES.get(kind, kind)}")
        self.peer_hello: dict = decode_payload(payload)
        if int(self.peer_hello.get("stage", pstage)) != peer_stage:
            raise TransportError(
                f"connected to stage {self.peer_hello.get('stage')}, "
                f"expected {peer_stage} (port map mismatch)")
        sock.settimeout(None)
        self._sender = threading.Thread(
            target=self._send_loop, name=f"mpmd-s{stage}-send", daemon=True)
        self._receiver = threading.Thread(
            target=self._recv_loop, name=f"mpmd-s{stage}-recv", daemon=True)
        self._sender.start()
        self._receiver.start()

    # -- state ---------------------------------------------------------------

    @property
    def dead(self) -> bool:
        return self._err is not None

    def _die(self, err: TransportError) -> None:
        with self._cond:
            if self._err is None:
                self._err = err
            self._cond.notify_all()

    def _raise_dead(self) -> None:
        assert self._err is not None
        raise type(self._err)(*self._err.args)

    # -- worker threads ------------------------------------------------------

    def _send_loop(self) -> None:
        while True:
            with self._cond:
                while not self._send_q and self._err is None and not self._closed:
                    self._cond.wait()
                if self._err is not None or (self._closed and not self._send_q):
                    return
                kind, mb, enc = self._send_q.popleft()
                self._cond.notify_all()
            t0 = time.perf_counter()
            try:
                # crc32 and sendall release the interpreter lock: the
                # compute thread runs on while the bytes go out
                self.sock.sendall(_HEADER.pack(MAGIC, VERSION, kind, self.stage, mb,
                                               enc.crc32(), enc.nbytes))
                for part in enc.parts:
                    self.sock.sendall(part)
            except OSError as e:
                self._die(PeerDiedError(
                    f"peer stage {self.peer_stage} died mid-send: {e}"))
                return
            row = self.sent.setdefault(kind, [0, 0, 0.0])
            row[0] += 1
            row[1] += enc.nbytes
            row[2] += time.perf_counter() - t0

    def _recv_loop(self) -> None:
        while True:
            try:
                frame = read_frame(self.sock, alloc=self._alloc)
            except TransportError as e:
                if self._done_seen and isinstance(e, PeerDiedError):
                    return  # socket torn after DONE: expected teardown
                self._die(e if isinstance(e, (PeerDiedError, FrameError))
                          else PeerDiedError(str(e)))
                return
            if frame is None:
                if self._done_seen or self._closed:
                    return
                self._die(PeerDiedError(
                    f"peer stage {self.peer_stage} closed the link"))
                return
            kind, _, mb, payload = frame
            try:
                obj = decode_payload(payload)
            except Exception as e:  # noqa: BLE001 — checksum passed but the
                # skeleton is bad: protocol violation, not recoverable
                self._die(FrameError(f"undecodable {_KIND_NAMES.get(kind, kind)} "
                                     f"payload: {e}"))
                return
            with self._cond:
                if kind == DONE:
                    self._done_seen = True
                    self._ctrl.append((kind, mb, obj))
                elif kind in self._inbox:
                    q = self._inbox[kind]
                    # bounded inbox: stop draining the socket when the
                    # consumer lags `depth` frames — TCP backpressure then
                    # stalls the sender (bounded memory at both ends)
                    while len(q) >= self.depth and self._err is None \
                            and not self._closed:
                        self._cond.wait()
                    if self._err is not None or self._closed:
                        return
                    q.append((kind, mb, obj))
                else:
                    self._ctrl.append((kind, mb, obj))
                self._cond.notify_all()

    # -- caller API ----------------------------------------------------------

    def send(self, kind: int, obj: Any, *, mb: int = -1,
             timeout: float | None = None) -> None:
        """Enqueue one frame (async); ``obj`` may be already
        :class:`Encoded` (a caller that retries encodes once). Blocks while
        ``depth`` frames are already queued — the bounded-buffering
        contract; ``timeout`` bounds that wait with
        :class:`TransportTimeout`."""
        enc = obj if isinstance(obj, Encoded) else encode_payload(obj)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._send_q) >= self.depth:
                if self._err is not None:
                    self._raise_dead()
                if self._closed:
                    raise TransportError("link closed")
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise TransportTimeout(
                        f"send queue to stage {self.peer_stage} full "
                        f"({self.depth} frames) for {timeout:.1f}s — peer "
                        f"not draining")
                self._cond.wait(wait)
            if self._err is not None:
                self._raise_dead()
            if self._closed:
                raise TransportError("link closed")
            self._send_q.append((kind, mb, enc))
            self._cond.notify_all()

    def recv(self, kind: int, *, timeout: float | None = 120.0
             ) -> tuple[int, Any]:
        """Next ``(mb, payload)`` of ``kind``. Buffered frames are delivered
        even after the peer died (they arrived intact); then the typed
        error surfaces."""
        q = self._inbox.get(kind, self._ctrl)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                item = self._pop(q, kind)
                if item is not None:
                    self._cond.notify_all()  # wake the receiver (space freed)
                    return item[1], item[2]
                if self._err is not None:
                    self._raise_dead()
                if self._closed:
                    raise TransportError("link closed")
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise TransportTimeout(
                        f"no {_KIND_NAMES.get(kind, kind)} frame from stage "
                        f"{self.peer_stage} within {timeout:.1f}s")
                self._cond.wait(wait)

    def try_recv(self, kind: int) -> tuple[int, Any] | None:
        """Non-blocking :meth:`recv`: ``(mb, payload)`` or None. Raises the
        link's typed error only when dead AND nothing is buffered."""
        q = self._inbox.get(kind, self._ctrl)
        with self._cond:
            item = self._pop(q, kind)
            if item is not None:
                self._cond.notify_all()
                return item[1], item[2]
            if self._err is not None:
                self._raise_dead()
            return None

    def _pop(self, q: deque, kind: int):
        if q is self._ctrl:
            for i, item in enumerate(q):
                if item[0] == kind:
                    del q[i]
                    return item
            return None
        return q.popleft() if q else None

    def close(self, *, send_done: bool = True) -> None:
        try:
            if send_done and self._err is None:
                self.send(DONE, {}, timeout=5.0)
        except TransportError:
            pass
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        # let queued frames (incl. DONE) drain before tearing the socket
        self._sender.join(timeout=5.0)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# -- chain topology -----------------------------------------------------------

#: the longest a blocked connect or resync waits between two ``tick`` calls
TICK_S = 1.0


class PipelineTransport:
    """Stage *k*'s two links: ``up`` (to stage k−1) and ``down`` (to k+1).

    Owns the persistent listener on ``ports[stage]`` (SO_REUSEADDR — a
    restarted stage re-binds the same port) so a dead neighbor can
    reconnect without coordination: on :class:`PeerDiedError` the runner
    calls :meth:`connect` again, which re-accepts/re-dials only the broken
    side, then :meth:`sync_step` agrees on the resume step. ``tick`` (the
    stage's heartbeat) is called at least every :data:`TICK_S` while
    :meth:`connect` or :meth:`sync_step` blocks: a survivor waiting for a
    restarted peer is alive, not hung. ``pinned``: the links receive into
    pinned host memory.
    """

    def __init__(self, stage: int, num_stages: int, ports: list[int],
                 authkey: bytes, *, depth: int = 2,
                 connect_timeout: float = 120.0, pinned: bool = False,
                 tick: Callable[[], None] | None = None):
        if num_stages < 2:
            raise ValueError(f"a pipeline needs >= 2 stages, got {num_stages}")
        if len(ports) < num_stages - 1:
            raise ValueError(
                f"need {num_stages - 1} ports for {num_stages} stages, "
                f"got {len(ports)}")
        self.stage = stage
        self.num_stages = num_stages
        self.ports = list(ports)
        self.authkey = authkey
        self.depth = depth
        self.connect_timeout = connect_timeout
        self.pinned = pinned
        self.tick = tick or (lambda: None)
        self.up: StageLink | None = None
        self.down: StageLink | None = None
        self._listener: socket.socket | None = None
        if stage < num_stages - 1:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind(("127.0.0.1", ports[stage]))
            self._listener.listen(4)

    @classmethod
    def from_env(cls, **kw) -> "PipelineTransport":
        return cls(
            int(os.environ[ENV_STAGE]),
            int(os.environ[ENV_NUM_STAGES]),
            json.loads(os.environ[ENV_PORTS]),
            bytes.fromhex(os.environ[ENV_AUTHKEY]),
            **kw,
        )

    def _link(self, sock: socket.socket, peer: int, hello: dict | None) -> StageLink:
        return StageLink(sock, stage=self.stage, peer_stage=peer, depth=self.depth,
                         hello=hello, pinned=self.pinned)

    def connect(self, *, hello: dict | None = None,
                timeout: float | None = None) -> None:
        """(Re)establish whichever links are missing or dead.

        Down (accept) before up (dial): the chain then resolves tail-first
        — the last stage dials immediately, each accept unblocks the next
        dial — and the same order is deadlock-free for any single-stage
        restart (the survivors' broken sides are complementary)."""
        deadline = time.monotonic() + (timeout or self.connect_timeout)
        if self._listener is not None and (self.down is None or self.down.dead):
            self.down = self._accept(deadline, hello)
        if self.stage > 0 and (self.up is None or self.up.dead):
            self.up = self._dial(deadline, hello)

    def _accept(self, deadline: float, hello: dict | None) -> StageLink:
        assert self._listener is not None
        while True:
            left = deadline - time.monotonic()
            self._listener.settimeout(min(TICK_S, max(0.1, left)))
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                if time.monotonic() > deadline:
                    raise TransportTimeout(
                        f"stage {self.stage}: stage {self.stage + 1} never "
                        f"connected (waited {self.connect_timeout:.0f}s)")
                self.tick()
                continue
            try:
                sock.settimeout(None)
                _challenge(sock, self.authkey, server=True)
                return self._link(sock, self.stage + 1, hello)
            except TransportError as e:
                logger.warning("stage %d: rejected downstream connection: %s",
                               self.stage, e)
                try:
                    sock.close()
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    raise

    def _dial(self, deadline: float, hello: dict | None) -> StageLink:
        port = self.ports[self.stage - 1]
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=5.0)
                _challenge(sock, self.authkey, server=False)
                return self._link(sock, self.stage - 1, hello)
            except (OSError, TransportError) as e:
                if time.monotonic() > deadline:
                    raise TransportTimeout(
                        f"stage {self.stage}: could not reach stage "
                        f"{self.stage - 1} on port {port} within "
                        f"{self.connect_timeout:.0f}s: {e}")
                self.tick()
                time.sleep(0.2)

    def reset(self) -> None:
        """Drop both links (keeping the listener) ahead of a reconnect —
        a resync must never read a stale pre-failure frame."""
        for link in (self.up, self.down):
            if link is not None:
                link.close(send_done=False)
        self.up = self.down = None

    def _recv_ticking(self, link: StageLink, kind: int, timeout: float) -> Any:
        """``link.recv(kind)`` within ``timeout``, ticking while it waits."""
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            try:
                return link.recv(kind, timeout=max(0.0, min(TICK_S, left)))[1]
            except TransportTimeout:
                if time.monotonic() >= deadline:
                    raise
                self.tick()

    def sync_step(self, my_step: int, *, timeout: float = 120.0) -> int:
        """Chain consensus on the resume step: forward min-wave, backward
        broadcast. Every stage returns the same global minimum of the
        committed checkpoint steps — the step all stages can restore."""
        cur = int(my_step)
        if self.up is not None:
            cur = min(cur, int(self._recv_ticking(self.up, SYNC_FWD, timeout)["step"]))
        if self.down is not None:
            self.down.send(SYNC_FWD, {"step": cur})
            cur = int(self._recv_ticking(self.down, SYNC_BWD, timeout)["step"])
        if self.up is not None:
            self.up.send(SYNC_BWD, {"step": cur})
        return cur

    def close(self) -> None:
        for link in (self.up, self.down):
            if link is not None:
                link.close()
        self.up = self.down = None
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
