"""The MPMD pipeline's parts against the JAX package, on the CPU.

- **The transport** (``parallel/mpmd.py``, the port's copy): JAX's
  contracts (``tests/test_mpmd.py``): frame round trip, torn frame, bad
  magic and bad CRC as typed ``FrameError``s, link round trip, peer death
  typed within a bounded wait, buffered frames surviving a death, bounded
  backpressure, clean teardown on ``DONE``, ``sync_step`` consensus over a
  3-stage chain, a wrong authkey refused; and the port's tensor codec,
  bit for bit, for bf16, f32, int32, non-contiguous tensors and numpy.
- **The stage program** (``LlamaStageProgram``) against JAX's on one
  device, stages 0, 1 and 2 of 3 of the tiny Llama at 6 layers (f32), the
  weights JAX's init converted by ``llama_io.params_from_flax``, numpy-
  seeded inputs: ``embed``, ``fwd``, ``bwd`` (the params' gradients and the
  input's), ``loss_backward`` (loss sum, weight, the activations' and the
  head's gradients) and one ``apply_grads`` (AdamW), at :data:`TOL`.
- **The supervisor**: the stage env contract (a ``StagePlan``'s
  ``CUDA_VISIBLE_DEVICES`` included), two stages needed, the hang
  watchdog's plumbing, a spec required for the built-in worker.
- **Stage layouts and what stays refused**: ``stage_plan`` builds
  ``fsdp``, ``tensor`` and ``zero`` (a plan record too); a stage mesh of two devices is a gang of two processes,
  which ``exact`` refuses on a ``tensor`` mesh; ``mode="exact"`` with
  ``per_microbatch``; the driver's two cards a stage by default (its card
  lists); and a stage worker with no card and no ``"device": "cpu"``.

The end-to-end runs and the drills are ``tests/test_torch_mpmd_e2e.py``.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from distributeddeeplearningspark_tpu_torch import telemetry
from distributeddeeplearningspark_tpu_torch.models import llama as tllama
from distributeddeeplearningspark_tpu_torch.models import llama_io as tllama_io
from distributeddeeplearningspark_tpu_torch.parallel import mesh as tmesh
from distributeddeeplearningspark_tpu_torch.parallel import mpmd
from distributeddeeplearningspark_tpu_torch.parallel import plan as tplan
from distributeddeeplearningspark_tpu_torch.train import optim
from distributeddeeplearningspark_tpu_torch.train import pipeline_trainer as tpt

from test_torch_deadline import bounded, per_test

#: the stage methods against JAX's, f32 on the CPU: every compared tensor
#: at this rtol and atol
TOL = 1e-5
#: the program comparison: 3 stages of a 6-layer tiny Llama, b rows of t
STAGES, LAYERS, B, T = 3, 6, 4, 16


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


# -- framing ------------------------------------------------------------------


def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    payload = mpmd.encode_payload(
        {"act": torch.arange(12, dtype=torch.float32).reshape(3, 4), "step": 7})
    a.sendall(mpmd.pack_frame(mpmd.ACT, 1, 3, payload))
    kind, stage, mb, raw = mpmd.read_frame(b)
    assert (kind, stage, mb) == (mpmd.ACT, 1, 3)
    obj = mpmd.decode_payload(raw)
    assert obj["step"] == 7
    assert torch.equal(obj["act"], torch.arange(12, dtype=torch.float32).reshape(3, 4))
    a.close()
    assert mpmd.read_frame(b) is None  # clean EOF at a frame boundary
    b.close()


def test_torn_frame_is_typed():
    a, b = socket.socketpair()
    frame = mpmd.pack_frame(mpmd.GRAD, 0, 1, mpmd.encode_payload({"x": 1}))
    a.sendall(frame[: len(frame) - 3])  # die mid-payload
    a.close()
    with pytest.raises(mpmd.FrameError, match="torn"):
        mpmd.read_frame(b)
    b.close()


def test_bad_magic_is_typed():
    a, b = socket.socketpair()
    a.sendall(b"GARBAGEGARBAGEGARBAGEGARBAGE")
    with pytest.raises(mpmd.FrameError, match="magic"):
        mpmd.read_frame(b)
    a.close()
    b.close()


def test_corrupted_payload_checksum_is_typed():
    a, b = socket.socketpair()
    frame = bytearray(mpmd.pack_frame(mpmd.ACT, 0, 0,
                                      mpmd.encode_payload({"x": torch.ones(8)})))
    frame[-1] ^= 0xFF  # flip one tensor byte; header CRC now disagrees
    a.sendall(bytes(frame))
    with pytest.raises(mpmd.FrameError, match="checksum"):
        mpmd.read_frame(b)
    a.close()
    b.close()


# -- the tensor codec -------------------------------------------------------------


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int32])
def test_codec_round_trips_bit_for_bit(dtype):
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(3, 5, 7, generator=gen) * 100).to(dtype)
    nc = x.transpose(0, 2)  # non-contiguous
    assert not nc.is_contiguous()
    obj = {"a": x, "nc": nc, "scalar": x[0, 0, 0], "empty": x[:0],
           "np": np.arange(10, dtype=np.int64).reshape(2, 5)[:, ::2],
           "nested": [{"k": (x[1], 3.5)}], "s": "text"}
    enc = mpmd.encode_payload(obj)
    raw = mpmd.pack_frame(mpmd.ACT, 0, 0, enc)
    a, b = socket.socketpair()
    a.sendall(raw)
    kind, _, _, payload = mpmd.read_frame(b)
    a.close()
    b.close()
    got = mpmd.decode_payload(payload)
    assert enc.tensor_bytes == sum(t.numel() * t.element_size()
                                   for t in (x, nc, x[0, 0, 0], x[:0], x[1])) + 6 * 8
    for key, want in (("a", x), ("nc", nc), ("scalar", x[0, 0, 0]), ("empty", x[:0])):
        assert got[key].dtype == dtype and got[key].shape == want.shape, key
        assert _bits(got[key]) == _bits(want), key
    assert _bits(got["nested"][0]["k"][0]) == _bits(x[1])
    assert got["nested"][0]["k"][1] == 3.5 and got["s"] == "text"
    np.testing.assert_array_equal(got["np"], obj["np"])
    assert got["np"].dtype == np.int64
    # each tensor's bytes start on the codec's boundary
    assert got["a"].data_ptr() % 64 == 0 and got["nc"].data_ptr() % 64 == 0
    assert mpmd.to_device(got, "cpu")["a"].device.type == "cpu"


# -- StageLink ----------------------------------------------------------------


def _link_pair(depth=2):
    a, b = socket.socketpair()
    out = {}

    def make(sock, stage, peer):
        out[stage] = mpmd.StageLink(sock, stage=stage, peer_stage=peer,
                                    depth=depth, hello={"step": stage * 10})

    t0 = threading.Thread(target=make, args=(a, 0, 1))
    t1 = threading.Thread(target=make, args=(b, 1, 0))
    t0.start(); t1.start(); t0.join(5); t1.join(5)
    return out[0], out[1]


def test_link_hello_and_data_roundtrip():
    l0, l1 = _link_pair()
    assert l0.peer_hello["step"] == 10 and l1.peer_hello["step"] == 0
    l0.send(mpmd.ACT, {"v": torch.ones(4, dtype=torch.bfloat16)}, mb=2)
    mb, obj = l1.recv(mpmd.ACT, timeout=5.0)
    assert mb == 2 and obj["v"].shape == (4,) and obj["v"].dtype == torch.bfloat16
    l1.send(mpmd.GRAD, {"g": 1}, mb=2)
    assert l0.recv(mpmd.GRAD, timeout=5.0) == (2, {"g": 1})
    l0.close(); l1.close()
    assert l0.sent[mpmd.ACT][0] == 1 and l1.sent[mpmd.GRAD][0] == 1


def test_peer_death_typed_within_bounded_wait():
    l0, l1 = _link_pair()
    got: dict = {}

    def wait():
        t0 = time.monotonic()
        try:
            l0.recv(mpmd.GRAD, timeout=30.0)
        except mpmd.TransportError as e:
            got["err"] = e
            got["waited"] = time.monotonic() - t0

    th = threading.Thread(target=wait)
    th.start()
    time.sleep(0.1)
    # SIGKILL shape: the kernel tears the socket
    l1.sock.shutdown(socket.SHUT_RDWR)
    th.join(10.0)
    assert isinstance(got.get("err"), mpmd.PeerDiedError)
    assert got["waited"] < 5.0  # bounded: death is detected, not timed out
    with pytest.raises(mpmd.PeerDiedError):
        l0.send(mpmd.ACT, {}, mb=0)  # subsequent calls fail typed too
    l0.close(send_done=False)


def test_buffered_frames_survive_peer_death():
    l0, l1 = _link_pair()
    l1.send(mpmd.GRAD, {"g": 7}, mb=0)
    time.sleep(0.3)  # let it land in l0's inbox
    l1.sock.shutdown(socket.SHUT_RDWR)
    assert l0.recv(mpmd.GRAD, timeout=5.0) == (0, {"g": 7})  # intact frame
    with pytest.raises(mpmd.PeerDiedError):
        l0.recv(mpmd.GRAD, timeout=5.0)  # then the death surfaces
    l0.close(send_done=False)


def test_send_backpressure_is_bounded():
    l0, l1 = _link_pair(depth=1)
    # the peer never drains: depth-1 send queue + depth-1 remote inbox +
    # the TCP buffers absorb a few frames, then send must BLOCK (and time
    # out typed), never buffer without bound
    big = mpmd.encode_payload({"x": torch.zeros(1 << 20, dtype=torch.uint8)})
    with pytest.raises(mpmd.TransportTimeout):
        for _ in range(8):
            l0.send(mpmd.ACT, big, mb=0, timeout=0.3)
    assert len(l0._send_q) <= 1  # the bound held
    l0.close(send_done=False); l1.close(send_done=False)


def test_done_makes_teardown_clean():
    l0, l1 = _link_pair()
    l0.close(send_done=True)   # sends DONE then tears the socket
    time.sleep(0.3)
    assert not l1.dead          # EOF after DONE is an expected teardown
    l1.close(send_done=False)


# -- chain topology + resync --------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_transport_chain_sync_step_consensus():
    ports = [_free_port(), _free_port()]
    key = os.urandom(16)
    steps = {0: 12, 1: 8, 2: 12}
    agreed: dict = {}
    errs: dict = {}

    def run(stage):
        try:
            tr = mpmd.PipelineTransport(stage, 3, ports, key,
                                        connect_timeout=20)
            tr.connect(hello={"step": steps[stage]})
            agreed[stage] = tr.sync_step(steps[stage], timeout=20)
            tr.close()
        except Exception as e:  # noqa: BLE001 — surfaced via assert below
            errs[stage] = e

    ths = [threading.Thread(target=run, args=(s,)) for s in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert not errs, errs
    assert agreed == {0: 8, 1: 8, 2: 8}  # min over committed steps


def test_transport_rejects_wrong_authkey():
    ports = [_free_port()]
    server = mpmd.PipelineTransport(0, 2, ports, b"right-key",
                                    connect_timeout=5)
    result: dict = {}

    def accept():
        try:
            server.connect()
            result["ok"] = True
        except mpmd.TransportError as e:
            result["err"] = e

    th = threading.Thread(target=accept)
    th.start()
    with pytest.raises(mpmd.TransportError):
        bad = mpmd.PipelineTransport(1, 2, ports, b"wrong-key",
                                     connect_timeout=3)
        bad.connect()
    th.join(10)
    server.close()
    assert "ok" not in result  # the unauthenticated dial never linked


def test_blocked_connect_ticks():
    """A stage waiting for its peer calls ``tick`` (its heartbeat) at least
    every TICK_S, then times out typed."""
    ticks: list = []
    tr = mpmd.PipelineTransport(0, 2, [_free_port()], b"k", connect_timeout=2.5,
                                tick=lambda: ticks.append(time.monotonic()))
    with pytest.raises(mpmd.TransportTimeout):
        tr.connect()
    tr.close()
    assert len(ticks) >= 2 and max(np.diff(ticks)) <= mpmd.TICK_S + 0.5


# -- the stage program against JAX's ------------------------------------------------


def test_theoretical_bubble():
    from distributeddeeplearningspark_tpu.train.pipeline_trainer import (
        theoretical_bubble,
    )

    for m, p in ((4, 2), (8, 4), (4, 4)):
        assert tpt.theoretical_bubble(m, p) == theoretical_bubble(m, p)
    assert tpt.theoretical_bubble(4, 4) == pytest.approx(3 / 7)


@pytest.fixture(scope="module")
@bounded()
def jax_stages():
    """JAX's 3 stage programs of the 6-layer tiny Llama on one device each
    (AdamW 1e-3), their states from seed 7, the whole init converted to the
    port's names, and the numpy inputs."""
    import jax
    import optax

    from distributeddeeplearningspark_tpu.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from distributeddeeplearningspark_tpu.parallel.mesh import MeshSpec
    from distributeddeeplearningspark_tpu.train.pipeline_trainer import (
        LlamaStageProgram,
    )

    cfg = LlamaConfig.tiny(num_layers=LAYERS)
    mesh = MeshSpec(data=1).build(jax.devices()[:1])
    progs = [LlamaStageProgram(cfg, k, STAGES, mesh, optax.adamw(1e-3))
             for k in range(STAGES)]
    sample = {"input_ids": np.zeros((2, 8), np.int32),
              "loss_mask": np.ones((2, 8), np.float32)}
    states = [p.init_state(sample, 7) for p in progs]
    model = LlamaForCausalLM(cfg)
    model_rng, _ = jax.random.split(jax.random.PRNGKey(7))
    whole = model.init({"params": model_rng, "dropout": model_rng}, sample,
                       train=False)["params"]
    init = {k: v.numpy().copy() for k, v in tllama_io.params_from_flax(
        jax.tree.map(np.asarray, whole), _tcfg()).items()}
    rng = np.random.default_rng(11)
    inputs = dict(
        ids=rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        mask=(rng.random((B, T)) > 0.2).astype(np.float32),
        x=rng.normal(0, 1, (B, T, cfg.hidden_size)).astype(np.float32),
        dy=rng.normal(0, 1e-2, (B, T, cfg.hidden_size)).astype(np.float32))
    return dict(progs=progs, states=states, init=init, inputs=inputs)


def _tcfg():
    return tllama.LlamaConfig.tiny(num_layers=LAYERS)


def _port_stage(jx, stage: int) -> tuple:
    prog = tpt.LlamaStageProgram(_tcfg(), stage, STAGES,
                                 optim.adamw(1e-3, weight_decay=1e-4),
                                 device="cpu", init_params=jx["init"])
    return prog, prog.init_state(7)


def _jax_to_port(tree: dict, stage: int) -> dict[str, np.ndarray]:
    """A JAX stage's params or gradients (its ``layers`` slice, stage 0's
    ``token_embed``, the last stage's ``final_norm``/``lm_head``) under the
    port's names."""
    import jax

    tree = jax.tree.map(np.asarray, tree)
    lo = stage * (LAYERS // STAGES)
    h, v = 128, 512
    full = {"token_embed": tree.get("token_embed", {"embedding": np.zeros((v, h))}),
            "final_norm": tree.get("final_norm", {"scale": np.zeros(h)}),
            "lm_head": tree.get("lm_head", {"kernel": np.zeros((h, v))}),
            "layers": tree["layers"]}
    cfg = tllama.LlamaConfig.tiny(num_layers=LAYERS // STAGES)
    out = {}
    for k, t in tllama_io.params_from_flax(full, cfg).items():
        if k.startswith("layers."):
            i, rest = k.split(".", 2)[1:]
            out[f"layers.{lo + int(i)}.{rest}"] = t.numpy()
        elif k in tree or k.split(".")[0] in tree:
            out[k] = t.numpy()
    return out


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_program_matches_jax(jax_stages, stage):
    """One step of each stage program: the port's methods against JAX's
    on the same weights and inputs."""
    jx = jax_stages
    jprog, jstate = jx["progs"][stage], jx["states"][stage]
    prog, state = _port_stage(jx, stage)
    inp = jx["inputs"]
    assert set(state.params) == set(_jax_to_port(jstate.params, stage))
    for n, p in state.params.items():
        _close(p.detach(), _jax_to_port(jstate.params, stage)[n], f"init {n}")
    jprog.start_step()
    prog.start_step()
    if stage == 0:
        jx_full = jprog.embed(jstate, jprog.put_rows(inp["ids"]))
        x_full = prog.embed(state, prog.put_rows(inp["ids"]))
        _close(x_full, jx_full, "embed")
        jx_in, x_in = jx_full, x_full
    else:
        jx_in, x_in = jprog.put_rows(inp["x"]), prog.put_rows(inp["x"])
    jy = jprog.fwd(jstate, jx_in)
    y = prog.fwd(state, x_in, 0)
    _close(y, jy, "fwd")
    if stage == STAGES - 1:
        denom = max(float(inp["mask"][:, 1:].sum()), 1.0)
        assert prog.mask_weight(prog.put_rows(inp["mask"])) == \
            jprog.mask_weight(jprog.put_rows(inp["mask"]))
        jmet, jdy = jprog.loss_backward(jstate, jy, jprog.put_rows(inp["ids"]),
                                        jprog.put_rows(inp["mask"]), denom)
        met, dy = prog.loss_backward(state, y, prog.put_rows(inp["ids"]),
                                     prog.put_rows(inp["mask"]), denom)
        for k in ("loss", "loss_sum", "weight"):
            assert met[k] == pytest.approx(jmet[k], rel=TOL), k
        _close(dy, jdy, "d_acts")
        jdy_in, dy_in = jdy, dy
    else:
        jdy_in, dy_in = jprog.put_rows(inp["dy"]), prog.put_rows(inp["dy"])
    jdx = jprog.bwd(jstate, jx_in, jdy_in)
    dx = prog.bwd(state, 0, dy_in)
    _close(dx, jdx, "bwd dx")
    if stage == 0:
        jprog.embed_backward(jstate, jprog.put_rows(inp["ids"]), jdx)
        prog.embed_backward(state, prog.put_rows(inp["ids"]), dx)
    jgrads = {}
    for tree in jprog._acc.values():
        jgrads.update(jprog._collect(tree))
    want = _jax_to_port(jgrads, stage)
    got = prog.grads()
    assert set(got) == set(want)
    for n, g in got.items():
        _close(g, want[n], f"grad {n}")
    jnew = jprog.apply_grads(jstate)
    new = prog.apply_grads(state)
    assert new.step == int(jnew.step) == 1
    want = _jax_to_port(jnew.params, stage)
    for n, p in new.params.items():
        _close(p.detach(), want[n], f"updated {n}")


# -- the supervisor -----------------------------------------------------------


def test_pipeline_supervisor_stage_env_contract(tmp_path):
    from distributeddeeplearningspark_tpu_torch.supervisor import (
        PipelineSupervisor,
        StagePlan,
    )

    sup = PipelineSupervisor(
        [StagePlan(env={"CUDA_VISIBLE_DEVICES": "2"}),
         StagePlan(env={"CUDA_VISIBLE_DEVICES": "3"})],
        env={mpmd.ENV_SPEC: json.dumps({"steps": 1})},
        telemetry_dir=str(tmp_path))
    env0 = sup._stage_env(0)
    env1 = sup._stage_env(1)
    assert env0[mpmd.ENV_STAGE] == "0" and env1[mpmd.ENV_STAGE] == "1"
    assert env0[mpmd.ENV_NUM_STAGES] == "2"
    ports = json.loads(env0[mpmd.ENV_PORTS])
    assert len(ports) == 1 and ports == json.loads(env1[mpmd.ENV_PORTS])
    assert env0[mpmd.ENV_AUTHKEY] == env1[mpmd.ENV_AUTHKEY]
    # stage-targetable identity: DLS_FAULT=die_host@N + DLS_FAULT_HOST=k
    # kills exactly stage k
    assert env0["DLS_HOST_ID"] == "0" and env1["DLS_HOST_ID"] == "1"
    # each stage a gang of one: rank 0 of 1, no rendezvous
    assert env0["DLS_PROCESS_ID"] == "0" and env1["DLS_PROCESS_ID"] == "0"
    assert env0["DLS_NUM_PROCESSES"] == env1["DLS_NUM_PROCESSES"] == "1"
    assert "DLS_COORDINATOR" not in env0 and sup.sizes == [1, 1]
    assert env0["DLS_RESTART"] == "0"
    assert env0["CUDA_VISIBLE_DEVICES"] == "2" and env1["CUDA_VISIBLE_DEVICES"] == "3"
    assert env0[telemetry.WORKDIR_ENV] == str(tmp_path)
    assert env0["PYTHONPATH"].split(os.pathsep)[0] == str(
        __import__("pathlib").Path(tpt.__file__).resolve().parents[2])
    assert "DLS_HEARTBEAT_FILE" not in env0
    assert StagePlan().command()[-1].endswith("_torch.train.pipeline_trainer")


def test_pipeline_supervisor_needs_two_stages():
    from distributeddeeplearningspark_tpu_torch.supervisor import (
        PipelineSupervisor,
        StagePlan,
    )

    with pytest.raises(ValueError, match=">= 2 stages"):
        PipelineSupervisor([StagePlan()])


def test_pipeline_supervisor_hang_watchdog_plumbing(tmp_path):
    import shutil

    from distributeddeeplearningspark_tpu_torch.supervisor import (
        PipelineSupervisor,
        StagePlan,
    )

    sup = PipelineSupervisor(
        [StagePlan(argv=["true"]), StagePlan(argv=["true"])],
        telemetry_dir=str(tmp_path), hang_timeout_s=5.0)
    env0 = sup._stage_env(0)
    assert env0["DLS_HEARTBEAT_FILE"] == sup._hb_path(0, 0)
    now = time.time()
    sup._launch_wall[0] = now
    assert not sup._hb_stale(0, now)           # just launched: in grace
    assert sup._hb_stale(0, now - 60.0)        # silent past the timeout
    with open(sup._hb_path(0), "w") as f:      # a heartbeat resets it
        f.write("1")
    assert not sup._hb_stale(0, now - 60.0)
    shutil.rmtree(sup._hb_dir, ignore_errors=True)


def test_pipeline_supervisor_requires_spec_for_builtin_worker(monkeypatch):
    from distributeddeeplearningspark_tpu_torch.supervisor import (
        PipelineSupervisor,
        StagePlan,
    )

    monkeypatch.delenv(mpmd.ENV_SPEC, raising=False)
    with pytest.raises(ValueError, match="DLS_PIPE_SPEC"):
        PipelineSupervisor([StagePlan(), StagePlan()])
    # a custom argv does not need the spec; a per-stage env satisfies it
    PipelineSupervisor([StagePlan(argv=["true"]), StagePlan(argv=["true"])])
    PipelineSupervisor([StagePlan(env={mpmd.ENV_SPEC: "{}"}),
                        StagePlan(env={mpmd.ENV_SPEC: "{}"})])


def test_heartbeat_stamps_through_a_long_phase(tmp_path, monkeypatch):
    hb = tmp_path / "hb"
    monkeypatch.setenv("DLS_HEARTBEAT_FILE", str(hb))
    stamps = []
    with tpt.beating(period=0.1):
        for _ in range(6):
            time.sleep(0.1)
            if hb.exists():
                stamps.append(hb.stat().st_mtime_ns)
    assert len(set(stamps)) >= 3


# -- the refusals -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fsdp", "tensor", "zero"])
def test_stage_plan_refuses_multi_card_layouts(name):
    """``fsdp``, ``tensor`` and ``zero`` build JAX's stage layouts (a
    tensor stage needs the cfg; ``zero`` is ``zero_plan(Plan("stage"))``:
    replicated params, the optimizer state sliced over the batch axes), in
    ``stage_plan`` and in a spec; the spec's refusals pass them all."""
    assert tplan.stage_plan("replicated").name == "stage-replicated"
    with pytest.raises(tplan.PlanError, match="unknown stage plan"):
        tplan.stage_plan("magic")
    plan = tplan.stage_plan(name, _tcfg(), fsdp_min_size=2**10)
    assert plan.name == f"stage-{name}"
    if name == "zero":
        assert plan.zero_axes == plan.batch_axes and not plan.rules.rules
        assert plan.signature() == tplan.zero_plan(tplan.Plan(name="stage"),
                                                   name="stage-zero").signature()
        mesh = tmesh.Mesh(tmesh.MeshSpec(data=2).shape(2))
    elif name == "fsdp":
        assert plan.rules.fsdp and plan.rules.fsdp_min_size == 2**10 and not plan.rules.rules
    else:
        with pytest.raises(tplan.PlanError, match="cfg"):
            tplan.stage_plan(name)
        assert not plan.rules.fsdp
        assert dict(plan.rules.rules)["(wq|wk|wv)/weight"] == ("tensor", None)
    if name != "zero":
        mesh = tmesh.Mesh(tmesh.MeshSpec(data=1, **{name: 2}).shape(2))
    assert tpt.stage_plan_of({"mode": "sharded", "stage_plans": {"1": name}}, 1,
                             _tcfg()).name == plan.name
    # a serialized plan record is taken too, and validated on the stage's mesh
    rec = plan.to_record()
    assert tpt.stage_plan_of({"plan": rec}, 0, _tcfg()).signature() == plan.signature()
    plan.validate(mesh)
    tpt.refuse_multi_card_stage({"mode": "sharded", "stage_plans": {"1": name}}, 1)


@pytest.mark.parametrize("spec", [{"mesh": {"data": 2}},
                                  {"stage_meshes": {"0": {"fsdp": 2}}},
                                  {"mesh": {"data": 1, "tensor": 2}}])
def test_stage_mesh_of_more_than_one_device_is_refused(spec):
    """A stage mesh of two devices is a gang of two processes (the
    supervisor's ``stage_processes``, a ``-1`` axis taking the stage's
    cards); ``exact`` refuses a mesh with an axis other than data/fsdp
    (JAX's refusal), ``sharded`` takes it."""
    assert tpt.stage_processes(spec, 0) == 2
    assert tpt.stage_processes({"mesh": {"data": -1}}, 0, cards=4) == 4
    assert tpt.stage_processes({}, 1) == 1
    tpt.refuse_multi_card_stage({"mesh": {"data": -1}, "plan": "replicated"}, 0)
    if "tensor" in json.dumps(spec):
        with pytest.raises(ValueError, match="exact"):
            tpt.refuse_multi_card_stage(spec, 0)
        with pytest.raises(ValueError, match="exact"):
            tpt.LlamaStageProgram(_tcfg(), 0, 2, optim.sgd(0.1), device="cpu",
                                  mesh=tmesh.Mesh(tmesh.MeshSpec(
                                      data=1, tensor=2).shape(2)))
        tpt.refuse_multi_card_stage({**spec, "mode": "sharded"}, 0)
    else:
        tpt.refuse_multi_card_stage(spec, 0)


def test_stage_program_validation():
    tx = optim.sgd(0.1)
    with pytest.raises(ValueError, match="full_batch"):
        tpt.LlamaStageProgram(_tcfg(), 0, 2, tx, device="cpu", mode="exact",
                              loss_mode="per_microbatch")
    with pytest.raises(ValueError, match="mode"):
        tpt.LlamaStageProgram(_tcfg(), 0, 2, tx, device="cpu", mode="magic")
    with pytest.raises(ValueError, match="divide"):
        tpt.LlamaStageProgram(tllama.LlamaConfig.tiny(), 0, 3, tx, device="cpu")


def test_driver_refuses_more_than_one_device_a_stage(capsys):
    """The driver's default is two cards a stage, as JAX's: stage k takes
    cards 2k and 2k+1, its mesh {"data": 2}; fewer cards than stages × n
    are refused (round robin would put two ranks on one card)."""
    from distributeddeeplearningspark_tpu_torch.examples import train_llama_mpmd

    assert train_llama_mpmd.parse_args([]).devices_per_stage == 2
    with pytest.raises(SystemExit):
        train_llama_mpmd.parse_args(["--devices-per-stage", "0"])
    assert "at least 1" in capsys.readouterr().err
    cards = [str(c) for c in range(4)]
    assert train_llama_mpmd._card_envs(2, 2, cards) == [
        {"CUDA_VISIBLE_DEVICES": "0,1"}, {"CUDA_VISIBLE_DEVICES": "2,3"}]
    assert train_llama_mpmd._card_envs(4, 1, cards)[3] == {"CUDA_VISIBLE_DEVICES": "3"}
    with pytest.raises(ValueError, match="need 6 cards"):
        train_llama_mpmd._card_envs(3, 2, cards)


def test_stage_worker_without_a_card_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA error needs a machine without CUDA")
    monkeypatch.setenv(mpmd.ENV_SPEC, json.dumps({"steps": 1}))
    monkeypatch.setenv(mpmd.ENV_STAGE, "0")
    monkeypatch.setenv(mpmd.ENV_NUM_STAGES, "2")
    monkeypatch.delenv(telemetry.WORKDIR_ENV, raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpt.stage_main()


def test_param_digests_follow_the_bits():
    """A stage summary's digests: equal for equal bits whatever the layout,
    different after one flipped bit."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 5, generator=g).to(torch.bfloat16)
    params = {"a": w.t(), "b": torch.randn(7, generator=g)}
    same = tpt.param_digests({"a": w.t().contiguous(), "b": params["b"].clone()})
    assert tpt.param_digests(params) == same
    flipped = params["b"].clone()
    flipped.view(torch.int32)[3] ^= 1
    other = tpt.param_digests({**params, "b": flipped})
    assert other["a"] == same["a"] and other["b"] != same["b"]


def test_tiny_cfg_takes_config_5_widths():
    cfg = tpt._tiny_cfg({"cfg": {"vocab_size": 32000, "hidden_size": 4096,
                                 "num_layers": 32, "num_heads": 32, "num_kv_heads": 32,
                                 "intermediate_size": 11008, "max_position": 4096,
                                 "dtype": "bfloat16"}})
    assert cfg == tllama.LlamaConfig(max_position=4096)
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert tpt._tiny_cfg({}) == tllama.LlamaConfig.tiny()
