"""The port's wire plane on the CPU, held to the JAX package's.

The codec must be byte-compatible with ``repro.transport.codec``: for
every frame kind, the same seeded numpy inputs encode to the same bytes in
both packages, and each package decodes the other's frames (so an actor
host of one package could dial a gateway of the other, which the loopback
tests here do over real sockets and shared-memory rings). The rejection
cases of the reference's tests hold for the port with the same errors.
The shared-memory ring, the backoff schedule, the restart budget and the
failover re-hash are held to the reference's tests.

The load-bearing system test is parity: under a deterministic policy, a
`SeedSystem` run whose actors live in spawned actor-host processes, over
TCP or over the shm rings, produces a per-lane unroll stream bit-identical
to the in-process run's. Four tests spawn processes (parity over socket,
parity over shm, R2D2 over the socket, V-trace over the socket); every
check is on counts and values, never on rates.
"""

import functools
import io
import queue
import socket
import time
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fault.backoff import BackoffPolicy as JBackoffPolicy  # noqa: E402
from repro.transport import codec as jcodec  # noqa: E402
from repro.transport.shm import ShmRing as JShmRing  # noqa: E402
from repro.transport.socket import InferenceGateway as JInferenceGateway  # noqa: E402
from repro.transport.socket import SyncSocketTransport as JSyncSocketTransport  # noqa: E402
from repro_torch.configs.r2d2_atari import AtariConfig  # noqa: E402
from repro_torch.core.inference import InferenceServer, ReplyError  # noqa: E402
from repro_torch.core.system import SeedSystem  # noqa: E402
from repro_torch.envs.catch import CatchEnv  # noqa: E402
from repro_torch.fault import BackoffPolicy, RestartBudget  # noqa: E402
from repro_torch.launch import train_r2d2, train_vtrace  # noqa: E402
from repro_torch.launch.actor_host import ActorHostPool  # noqa: E402
from repro_torch.transport import codec  # noqa: E402
from repro_torch.transport.shm import ShmRing, ShmRingError  # noqa: E402
from repro_torch.transport.socket import (InferenceGateway, ShmTransport,  # noqa: E402
                                          SocketTransport, SyncSocketTransport)

torch.set_num_threads(1)

CPU_CATCH = functools.partial(CatchEnv, device="cpu")
# the example's reduced config (examples/train_atari_r2d2.py)
REDUCED = AtariConfig(obs_size=42, obs_channels=2, core_dim=128, num_actions=6, burn_in=4,
                      unroll=16, n_step=3, target_update_period=50)


def det_policy(obs, ids):
    """Deterministic and slot-order independent, so batching and arrival
    order (which legitimately differ across transports) cannot change
    actions (the reference tests' policy)."""
    flat = np.abs(obs.reshape(obs.shape[0], -1))
    return (flat.sum(axis=1) * 997.0).astype(np.int64) % CatchEnv.num_actions


# ------------------------------------------------------------------ codec

def _traj(rng, t=8, obs=(50,), onpolicy=False):
    out = {"obs": rng.random((t,) + obs).astype(np.float32),
           "actions": rng.integers(0, 3, t).astype(np.int32),
           "rewards": rng.choice([-1.0, 0.0, 1.0], t).astype(np.float32),
           "dones": (rng.random(t) < 0.2).astype(np.float32)}
    if onpolicy:
        out["behavior_logprobs"] = np.log(rng.random(t) + 0.1).astype(np.float32)
        out["param_version"] = np.int64(rng.integers(0, 1000))
    return out


def _atari_frames(rng, n=4):
    """uint8 lanes with long runs, as Atari frames have: RLE shrinks them."""
    arr = np.zeros((n, 84, 84), np.uint8)
    arr[:, 40:44] = 255
    arr[:, rng.integers(0, 84, 6), rng.integers(0, 84, 6)] = rng.integers(0, 256, 6)
    return arr


# name -> (frame kind, encoder taking a codec module and a seeded rng)
FRAMES = {
    "request_u8": (1, lambda c, r: c.encode_request(7, 123, (r.random((4, 84, 84)) * 255)
                                                    .astype(np.uint8))),
    "request_f32": (1, lambda c, r: c.encode_request(3, 2 ** 40, r.random((8, 50))
                                                     .astype(np.float32), trace_seq=99)),
    "request_i64_scalar": (1, lambda c, r: c.encode_request(1, 2, r.integers(0, 9, (1, 4)),
                                                            scalar=True)),
    "request_empty": (1, lambda c, r: c.encode_request(0, 0, np.zeros((0, 84, 84), np.uint8))),
    "reply": (2, lambda c, r: c.encode_reply(9, r.integers(0, 18, 6))),
    "reply_onpolicy_version": (2, lambda c, r: c.encode_reply(
        9, np.stack([r.integers(0, 3, 8), r.random(8)], 1).astype(np.float32), version=17,
        trace_seq=5)),
    "error": (3, lambda c, r: c.encode_error(0, "server died: boom")),
    "trajectory": (4, lambda c, r: c.encode_trajectory(3, _traj(r))),
    "trajectory_onpolicy": (4, lambda c, r: c.encode_trajectory(3, _traj(r, onpolicy=True))),
    "traj_batch": (6, lambda c, r: c.encode_traj_batch(
        9, [_traj(r, onpolicy=True) for _ in range(5)])),
    "hello": (5, lambda c, r: c.encode_hello(c.SUPPORTED_CODECS)),
    "shm": (7, lambda c, r: c.encode_shm("psm_c2s_x", "psm_s2c_y", 1 << 20, 64)),
    "rle_u8": (1, lambda c, r: c.encode_request(7, 9, _atari_frames(r), compress=True)),
    "rle_traj_batch": (6, lambda c, r: c.encode_traj_batch(
        2, [{"obs": _atari_frames(r, 8), "actions": r.integers(0, 18, 8).astype(np.int32)}
            for _ in range(3)], compress=True)),
    "f16": (1, lambda c, r: c.encode_request(1, 2, ((r.random((16, 50)) - 0.5) * 40)
                                             .astype(np.float32), quant="f16")),
    "q8": (1, lambda c, r: c.encode_request(3, 4, (r.random((16, 50)) * 7 - 3)
                                            .astype(np.float32), quant="q8")),
    "q8_traj": (4, lambda c, r: c.encode_trajectory(5, _traj(r, t=16), quant="q8")),
}


def _same_frame(a, b):
    for field in ("kind", "actor_id", "request_id", "flags", "param_version", "trace_seq",
                  "message", "codecs", "shm"):
        assert getattr(a, field) == getattr(b, field), field
    arrays = [(a.array, b.array)] if a.array is not None or b.array is not None else []
    trajs = ([(a.arrays, b.arrays)] if a.arrays is not None or b.arrays is not None
             else list(zip(a.traj_batch or [], b.traj_batch or [])))
    assert len(a.traj_batch or []) == len(b.traj_batch or [])
    for ta, tb in trajs:
        assert list(ta) == list(tb)
        arrays += [(ta[k], tb[k]) for k in ta]
    for x, y in arrays:
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(FRAMES))
def test_codec_frames_byte_identical_to_reference(name, seed):
    kind, encode = FRAMES[name]
    ours = encode(codec, np.random.default_rng(seed))
    ref = encode(jcodec, np.random.default_rng(seed))
    assert isinstance(ours, bytes) and ours == ref
    frame = codec.read_frame(io.BytesIO(ref).read)      # the port reads JAX's
    jframe = jcodec.read_frame(io.BytesIO(ours).read)   # and JAX reads the port's
    assert frame.kind == jframe.kind == kind
    _same_frame(frame, jframe)
    if name in ("rle_u8", "rle_traj_batch", "f16", "q8", "q8_traj"):
        flag = {"rle": codec.FLAG_RLE, "f16": codec.FLAG_F16, "q8": codec.FLAG_Q8}[
            name.split("_")[0]]
        assert frame.flags & flag, "the optional encoding was not taken"


def test_codec_constants_and_parts_match_reference():
    names = ("MAGIC", "VERSION", "KIND_REQUEST", "KIND_REPLY", "KIND_ERROR", "KIND_TRAJ",
             "KIND_HELLO", "KIND_TRAJ_BATCH", "KIND_SHM", "FLAG_SCALAR", "FLAG_RLE",
             "FLAG_F16", "FLAG_Q8", "CODEC_RLE", "CODEC_ONPOLICY", "CODEC_QUANT",
             "CODEC_TRAJBATCH", "CODEC_SHM", "SUPPORTED_CODECS", "DEFAULT_MAX_FRAME")
    assert {n: getattr(codec, n) for n in names} == {n: getattr(jcodec, n) for n in names}
    assert codec.DEFAULT_MAX_FRAME == 64 << 20
    rng = np.random.default_rng(4)
    obs = rng.random((4, 50)).astype(np.float32)
    parts = codec.encode_request_parts(2, 3, obs)
    assert b"".join(bytes(p) for p in parts) == jcodec.encode_request(2, 3, obs)
    assert codec.parts_len(parts) == len(jcodec.encode_request(2, 3, obs))
    assert any(isinstance(p, memoryview) for p in parts), "the parts copy the payload"


@pytest.mark.parametrize("seed", range(8))
def test_codec_q8_and_f16_byte_identical_on_edge_draws(seed):
    """q8 on fixed seeds, spans from 1e-2 to 1e4, constant arrays and
    arrays too small to win: the port's bytes are the reference's, byte for
    byte (no error bound is asserted; the reference computes the same)."""
    rng = np.random.default_rng(seed)
    span = 10.0 ** rng.uniform(-2, 4)
    for arr in (((rng.random(int(rng.integers(3, 200))) - 0.5) * span).astype(np.float32),
                np.full((4, 50), np.float32(rng.random()), np.float32),
                np.zeros(2, np.float32),
                np.array([np.inf, 1.0, 2.0, 3.0, 4.0], np.float32)):
        for quant in ("f16", "q8"):
            ours = codec.encode_request(1, seed, arr, quant=quant)
            assert ours == jcodec.encode_request(1, seed, arr, quant=quant)
            got = codec.decode_frame(ours[4:]).array
            np.testing.assert_array_equal(got, jcodec.decode_frame(ours[4:]).array)


def _raises_alike(fn):
    """The exception class name and message `fn(module)` raises in the
    port and in the reference; they must be the same."""
    out = []
    for mod in (codec, jcodec):
        with pytest.raises(mod.CodecError) as e:
            fn(mod)
        out.append((type(e.value).__name__, str(e.value)))
    assert out[0] == out[1]
    return out[0]


def _flip(wire, at, bits):
    body = bytearray(wire[4:])
    body[at] |= bits
    return bytes(body)


REJECTIONS = {
    "truncated_len": (lambda c: c.read_frame(io.BytesIO(
        c.encode_request(1, 1, np.ones((4, 10), np.float32))[:2]).read), "TruncatedFrame"),
    "truncated_header": (lambda c: c.read_frame(io.BytesIO(
        c.encode_request(1, 1, np.ones((4, 10), np.float32))[:6]).read), "TruncatedFrame"),
    "truncated_prologue": (lambda c: c.read_frame(io.BytesIO(
        c.encode_request(1, 1, np.ones((4, 10), np.float32))[:24]).read), "TruncatedFrame"),
    "truncated_data": (lambda c: c.read_frame(io.BytesIO(
        c.encode_request(1, 1, np.ones((4, 10), np.float32))[:-3]).read), "TruncatedFrame"),
    "oversized": (lambda c: c.read_frame(io.BytesIO(
        c.encode_request(1, 1, np.zeros((4, 10), np.float32))).read, max_frame=16),
        "FrameTooLarge"),
    "unknown_flag": (lambda c: c.decode_frame(_flip(
        c.encode_request(1, 1, np.zeros((2, 4), np.float32)), 4, 0x80)), "CodecError"),
    "array_flag_on_error": (lambda c: c.decode_frame(_flip(
        c.encode_error(0, "boom"), 4, c.FLAG_RLE)), "CodecError"),
    "rle_total": (lambda c: c.rle_decode_u8(bytes([5, 1]), expected=4), "CodecError"),
    "rle_zero_run": (lambda c: c.rle_decode_u8(bytes([0, 1]), expected=0), "CodecError"),
    "rle_odd": (lambda c: c.rle_decode_u8(bytes([5]), expected=5), "CodecError"),
    "rle_expansion": (lambda c: c.decode_frame(c.encode_request(
        1, 1, np.zeros(4096, np.uint8), compress=True)[4:], max_frame=1024), "CodecError"),
    "q8_expansion": (lambda c: c.decode_frame(c.encode_request(
        1, 1, np.eye(1, 4096, dtype=np.float32)[0], quant="q8")[4:], max_frame=1024),
        "CodecError"),
    "older_version": (lambda c: c.decode_frame(bytes(
        bytearray(c.encode_reply(1, np.arange(3))[4:6]) + bytes([c.VERSION - 1])
        + c.encode_reply(1, np.arange(3))[7:])), "CodecError"),
    "newer_version": (lambda c: c.decode_frame(bytes(
        bytearray(c.encode_reply(1, np.arange(3))[4:6]) + bytes([c.VERSION + 1])
        + c.encode_reply(1, np.arange(3))[7:])), "CodecError"),
    "bad_magic": (lambda c: c.decode_frame(b"\x00" * 40), "CodecError"),
    "trailing_bytes": (lambda c: c.decode_frame(
        c.encode_reply(1, np.zeros(3, np.float32))[4:] + b"xx"), "CodecError"),
    "object_dtype": (lambda c: c.encode_reply(1, np.array([object()], dtype=object)),
                     "CodecError"),
    "unknown_quant": (lambda c: c.encode_request(1, 1, np.zeros((4, 50), np.float32),
                                                 quant="lz4"), "CodecError"),
    "empty_batch": (lambda c: c.encode_traj_batch(9, []), "CodecError"),
}


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_codec_rejects_as_the_reference(name):
    fn, cls = REJECTIONS[name]
    got_cls, message = _raises_alike(fn)
    assert got_cls == cls, message
    if name.endswith("version"):
        assert "wire version" in message
    # a clean EOF at a frame boundary is no error in either package
    assert codec.read_frame(io.BytesIO(b"").read) is None


# ------------------------------------------------------------- shm ring

def test_shm_ring_roundtrip_and_fill():
    ring = ShmRing.create(slot_size=256, num_slots=4)
    try:
        assert ring.fill() == 0
        assert ring.try_get() is None
        assert ring.try_put([b"hello ", b"world"])
        assert ring.fill() == 1
        peer = ShmRing.attach(ring.name, 256, 4)
        assert peer.try_get() == b"hello world"
        assert peer.try_get() is None
        peer.close()
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_rejects_oversized_and_overflow_returns_false():
    ring = ShmRing.create(slot_size=64, num_slots=2)
    try:
        assert not ring.try_put([b"x" * 65])          # > slot payload
        assert ring.try_put([b"a"])
        assert ring.try_put([b"b"])
        assert not ring.try_put([b"c"])               # full: caller spills
        assert ring.try_get() == b"a"
        assert ring.try_put([b"c"])                   # space reclaimed
        assert ring.try_get() == b"b"
        assert ring.try_get() == b"c"
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("seed", [3, 4])
def test_shm_ring_fuzz_wraparound_against_deque_model(seed):
    """Randomized put/get against a deque model, with a ring small enough
    that every slot wraps many times — ordering and payload bytes must
    match the model exactly, including zero-length payloads."""
    rng = np.random.default_rng(seed)
    ring = ShmRing.create(slot_size=128, num_slots=3)
    model = deque()
    try:
        for _ in range(2000):
            if rng.random() < 0.55:
                payload = rng.bytes(int(rng.integers(0, 129)))
                ok = ring.try_put([payload])
                assert ok == (len(model) < 3)
                if ok:
                    model.append(payload)
            else:
                got = ring.try_get()
                want = model.popleft() if model else None
                assert got == want
            assert ring.fill() == len(model)
        while model:
            assert ring.try_get() == model.popleft()
    finally:
        ring.close()
        ring.unlink()


def test_shm_ring_attach_validates_geometry():
    ring = ShmRing.create(slot_size=256, num_slots=4)
    try:
        with pytest.raises(ShmRingError):
            ShmRing.attach(ring.name, 512, 4)         # wrong slot size
        with pytest.raises(ShmRingError):
            ShmRing.attach(ring.name, 256, 8)         # wrong slot count
        with pytest.raises((ShmRingError, FileNotFoundError)):
            ShmRing.attach("psm_does_not_exist_xyz", 256, 4)
        with pytest.raises(ShmRingError):
            ShmRing.create(slot_size=0, num_slots=4)
    finally:
        ring.close()
        ring.unlink()


@pytest.mark.parametrize("creator", ["port", "reference"])
def test_shm_ring_layout_shared_with_reference(creator):
    """One segment layout: a ring either package creates, the other
    attaches to and reads, frame for frame and in order."""
    make, peer_cls = (ShmRing, JShmRing) if creator == "port" else (JShmRing, ShmRing)
    ring = make.create(slot_size=128, num_slots=4)
    try:
        peer = peer_cls.attach(ring.name, 128, 4)
        frames = [codec.encode_hello(i) for i in range(6)]
        got = []
        for f in frames:
            assert ring.try_put([f])
            got.append(peer.try_get())
        assert got == frames and peer.try_get() is None
        peer.close()
    finally:
        ring.close()
        ring.unlink()


# ------------------------------------------------------- socket loopback

def _serve(policy=det_policy, max_batch=8, gateway=InferenceGateway, **gw_kwargs):
    srv = InferenceServer(policy, max_batch=max_batch, deadline_ms=2.0)
    gw = gateway(srv, **gw_kwargs)
    srv.start()
    return srv, gw, gw.start()


def test_socket_loopback_roundtrip_and_recurrent_slots():
    seen_slots = {}

    def slot_recording_policy(obs, ids):
        for slot in np.asarray(ids):
            seen_slots[int(slot)] = seen_slots.get(int(slot), 0) + 1
        return det_policy(obs, ids)

    srv, gw, addr = _serve(slot_recording_policy)
    tr = SocketTransport.connect(addr)
    try:
        obs = np.random.default_rng(0).random((4, 50)).astype(np.float32)
        for _ in range(3):
            got = tr.submit_batch(11, obs).get(timeout=5.0)
            assert np.array_equal(got, det_policy(obs, None))
        scalar = tr.submit(12, np.zeros(50, np.float32)).get(timeout=5.0)
        assert np.ndim(scalar) == 0
        # 4 lanes of actor 11 + 1 lane of actor 12 = 5 distinct slots, and
        # lane slots are stable across repeated requests
        assert srv.num_slots == 5 and sorted(seen_slots) == [0, 1, 2, 3, 4]
        assert all(c == 3 for s, c in seen_slots.items() if s < 4)
    finally:
        tr.close()
        gw.stop()
        srv.stop()


@pytest.mark.parametrize("client, gateway", [
    (SyncSocketTransport, JInferenceGateway), (JSyncSocketTransport, InferenceGateway),
    (ShmTransport, InferenceGateway)])
def test_sync_transport_round_trips_across_packages(client, gateway):
    """A client of one package against a gateway of the other (or the
    port's shm client against the port's gateway): replies equal the
    policy's, on-policy versions ride the reply header, and a trajectory
    reaches the sink with its keys and values."""
    version = {"v": 3}
    sunk = []
    srv, gw, addr = _serve(gateway=gateway, sink=sunk.append,
                           version_source=lambda: version["v"], onpolicy=True,
                           **({"allow_shm": True} if client is ShmTransport else {}))
    tr = client.connect(addr, onpolicy=True)
    try:
        assert tr.wait_hello(5.0) and tr.onpolicy_granted
        obs = np.random.default_rng(1).random((2, 50)).astype(np.float32)
        for v in (3, 8):
            version["v"] = v
            reply = tr.submit_batch(0, obs)
            try:
                got = reply.get(timeout=1e-5)    # the actor loop's timeout contract
            except queue.Empty:
                got = reply.get(timeout=5.0)
            assert np.array_equal(got, det_policy(obs, None)) and tr.param_version == v
        traj = _traj(np.random.default_rng(2), onpolicy=True)
        tr.send_trajectory(traj)
        tr.submit_batch(0, obs).get(timeout=5.0)   # a request flushes coalesced records
        deadline = time.perf_counter() + 5.0
        while not sunk and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert len(sunk) == 1 and sorted(sunk[0]) == sorted(traj)
        for k in traj:
            np.testing.assert_array_equal(sunk[0][k], traj[k])
        if client is ShmTransport:
            assert tr.shm_frames > 0 and gw.stats["shm_conns"] == 1
    finally:
        tr.close()
        gw.stop()
        srv.stop()


@pytest.mark.parametrize("connect", [False, True])
def test_gateway_stop_ends_every_thread(connect):
    """stop() wakes the accept loop (closing the listener alone does not
    on Linux, and the join then gave up after 5 s with the thread still
    blocked in accept) and every connection's reader: after it returns,
    no gateway thread is alive."""
    srv, gw, addr = _serve()
    tr = SyncSocketTransport.connect(addr) if connect else None
    try:
        if tr is not None:
            tr.submit_batch(0, np.zeros((2, 50), np.float32)).get(timeout=5.0)
    finally:
        gw.stop()
        alive = [t.name for t in gw._threads if t.is_alive()]
        if tr is not None:
            tr.close()
        srv.stop()
    assert len(gw._threads) == 1 + connect and alive == []


def test_transport_poisons_pending_on_gateway_loss():
    block = []

    def blocking_policy(obs, ids):
        deadline = time.perf_counter() + 10.0
        while not block and time.perf_counter() < deadline:
            time.sleep(0.01)
        return np.zeros((obs.shape[0],), np.int32)

    srv, gw, addr = _serve(blocking_policy, max_batch=1)
    tr = SocketTransport.connect(addr)
    try:
        reply = tr.submit_batch(0, np.zeros((1, 4), np.float32))
        time.sleep(0.1)
        gw.stop()                     # connection drops mid-request
        assert isinstance(reply.get(timeout=5.0), ReplyError)
        assert tr.error is not None
        # subsequent submits fail fast, no new hang
        assert isinstance(tr.submit_batch(0, np.zeros((1, 4), np.float32)).get(timeout=1.0),
                          ReplyError)
    finally:
        block.append(True)
        tr.close()
        srv.stop()


# -------------------------------------------------- backoff and failover

def test_backoff_no_jitter_is_exact_doubling_to_cap():
    p = BackoffPolicy(base_s=0.05, cap_s=0.4, max_retries=6, jitter=0.0)
    assert list(p.delays()) == pytest.approx([0.05, 0.1, 0.2, 0.4, 0.4, 0.4])


@pytest.mark.parametrize("kw", [dict(base_s=2.0, cap_s=1.0), dict(max_retries=-1),
                                dict(jitter=1.5)])
def test_backoff_validation(kw):
    with pytest.raises(ValueError):
        BackoffPolicy(**kw)
    with pytest.raises(ValueError):
        JBackoffPolicy(**kw)


def test_backoff_seeded_schedules_equal_the_reference():
    """Never exceeds the cap, gives up after exactly max_retries, stays
    positive, deterministic under a seed — and the same delays as the
    reference's for the same parameters."""
    import random
    rng = random.Random(0)
    for _ in range(60):
        kw = dict(base_s=rng.uniform(1e-3, 1.0), cap_s=rng.uniform(1.0, 8.0),
                  max_retries=rng.randrange(13), jitter=rng.uniform(0.0, 1.0),
                  seed=rng.randrange(2 ** 31))
        d = list(BackoffPolicy(**kw).delays())
        assert d == list(BackoffPolicy(**kw).delays()) == list(JBackoffPolicy(**kw).delays())
        assert len(d) == kw["max_retries"] and all(0.0 < x <= kw["cap_s"] for x in d)


def test_restart_budget_window():
    b = RestartBudget(max_restarts=2, window_s=1.0)
    assert b.spend(now=0.0)
    assert b.spend(now=0.1)
    assert not b.spend(now=0.2)              # 3rd inside the window: over
    assert b.spend(now=5.0)                  # old spends aged out
    assert b.spent == 1


def _tcp_pair():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    a = socket.create_connection(lst.getsockname())
    b, _ = lst.accept()
    lst.close()
    return a, b


def test_pick_address_rehashes_over_survivors():
    a, b = _tcp_pair()
    try:
        tr = SyncSocketTransport(
            a, reconnect=BackoffPolicy(max_retries=1),
            failover_addresses=[("127.0.0.1", 1), ("127.0.0.1", 2)], host_id=3)
        tr._dialed_address = ("127.0.0.1", 2)
        assert tr._pick_address() == ("127.0.0.1", 2)   # 3 % 2 -> idx 1
        tr._dead_addresses.add(("127.0.0.1", 2))
        assert tr._pick_address() == ("127.0.0.1", 1)   # re-hash over live
        tr._dead_addresses.add(("127.0.0.1", 1))
        # everything dead: marks forgotten, full list retried
        assert tr._pick_address() == ("127.0.0.1", 2)
    finally:
        a.close()
        b.close()


def test_recover_is_opt_in_and_flap_guarded():
    a, b = _tcp_pair()
    c, d = _tcp_pair()
    try:
        tr = SyncSocketTransport(a)          # reconnect=None: fail-fast
        tr.error = "wire cut"
        assert tr._recover() is False
        tr2 = SyncSocketTransport(c, reconnect=BackoffPolicy(
            base_s=0.001, cap_s=0.002, max_retries=1))
        tr2.error = "wire cut"
        tr2._consec_recoveries = 8           # flapping: plane is gone
        assert tr2._recover() is False
        assert "consecutive-recovery cap" in tr2.error
    finally:
        for s in (a, b, c, d):
            s.close()


def test_actor_host_child_in_process_with_a_small_ring_geometry():
    """The child's entry point, run in this process against a gateway: it
    dials one shm connection an actor with the pool's ring geometry
    (slots of 1 KiB here, so every trajectory batch of 3 lanes spills to
    TCP while requests ride the ring), warms up, runs its window and
    reports counts that add up, with CUDA untouched."""
    import sys
    from repro_torch.launch.actor_host import ActorHostConfig, run_actor_host

    sunk = []
    srv, gw, addr = _serve(sink=sunk.append, allow_shm=True)
    interval = sys.getswitchinterval()
    out = queue.Queue()
    try:
        t_start = time.perf_counter()
        run_actor_host(ActorHostConfig(address=addr, host_id=0, actor_ids=(0, 1),
                                       env_factory=CPU_CATCH, envs_per_actor=3, unroll=4,
                                       seconds=0.5, use_shm=True, shm_geometry=(1024, 8),
                                       heartbeat=True), out)
        t_end = time.perf_counter()
        frames = []
        while not out.empty():
            frames.append(out.get(timeout=1.0))
        stats = frames[-1]
        beats = [f for f in frames[:-1] if "__heartbeat__" in f]
        # the last flushes may still be in the gateway's readers: wait for
        # them before the stop, which would drop what is left unread
        deadline = time.perf_counter() + 10.0
        while len(sunk) < 3 * stats["unrolls"] and time.perf_counter() < deadline:
            time.sleep(0.01)
    finally:
        sys.setswitchinterval(interval)
        gw.stop()
        srv.stop()
    assert stats["error"] is None and not stats["cuda_initialized"]
    assert stats["frames"] == stats["iterations"] * 3 > 0
    # beats from birth; those after the window starts carry its end
    assert beats and all(b["__heartbeat__"] == 0 and b["__epoch__"] == 0 for b in beats)
    ends = {b["__window_end__"] for b in beats if "__window_end__" in b}
    assert len(ends) <= 1 and all(t_start + 0.5 < e < t_end for e in ends)
    assert len(sunk) == 3 * stats["unrolls"] > 0
    assert stats["shm_frames"] > 0 and stats["spill_frames"] >= stats["unrolls"]
    assert gw.stats["shm_conns"] == 2


class _Proc:
    """A stand-in for a child process the supervisor scans."""

    def __init__(self, alive, exitcode=None):
        self.alive, self.exitcode, self.killed = alive, exitcode, False

    def is_alive(self):
        return self.alive

    def kill(self):
        self.killed, self.alive = True, False


def _supervised_pool(faults):
    pool = ActorHostPool(CPU_CATCH, num_actors=4, envs_per_actor=2, unroll=4, num_hosts=2,
                         supervise=True, max_host_restarts=1, host_stall_s=5.0,
                         fault_callback=lambda h, why: faults.append((h, why)))
    spawned = []

    def spawn(host_id, actor_ids, addresses, seconds, epoch, result_q, ctx):
        spawned.append((host_id, actor_ids, epoch, seconds))
        pool._hosts[host_id] = {"proc": _Proc(True), "epoch": epoch, "actor_ids": actor_ids,
                                "last_beat": 0.0, "beaten": True, "reported": False,
                                "draining": False, "stop_event": None}

    pool._spawn = spawn
    pool._running = True                 # as inside run()'s collect loop
    for h, ids in enumerate(pool._partitions()):
        spawn(h, ids, None, 10.0, 0, None, None)
    spawned.clear()
    return pool, spawned


def test_supervisor_respawns_a_dead_host_with_its_ids_then_spends_its_budget():
    """A host that died without reporting is reported once, killed for
    certain and respawned with the same actor ids at the next epoch for
    what is left of the window; a second death past the restart budget
    leaves a tombstone carrying the error, not a hang."""
    faults = []
    pool, spawned = _supervised_pool(faults)
    assert [st["actor_ids"] for st in pool._hosts.values()] == [(0, 1), (2, 3)]
    budget = RestartBudget(pool.max_host_restarts, window_s=60.0)
    results = {}
    pool._hosts[1]["proc"] = _Proc(False, exitcode=-9)
    pool._scan(results, [("127.0.0.1", 1)], 10.0, None, None, budget, now=1.0)
    assert spawned == [(1, (2, 3), 1, 9.0)] and pool.host_restarts == 1 and results == {}
    assert len(faults) == 1 and faults[0][0] == 1 and "exitcode=-9" in faults[0][1]
    pool._hosts[1]["proc"] = _Proc(False, exitcode=1)
    pool._scan(results, [("127.0.0.1", 1)], 10.0, None, None, budget, now=2.0)
    assert len(spawned) == 1 and pool.host_restarts == 1 and len(faults) == 2
    assert "restart budget exhausted" in results[1]["error"] and results[1]["epoch"] == 1
    assert results[1]["frames"] == 0 and pool._hosts[1]["reported"]
    assert 0 not in results and pool.live_hosts() == 1


def test_supervisor_kills_a_silent_host_and_tombstones_after_the_window():
    """Missed heartbeats past host_stall_s count as a death: the silent
    incarnation is killed before anything replaces it; with the window
    over, the death is absorbed as a tombstone without an error."""
    faults = []
    pool, spawned = _supervised_pool(faults)
    budget = RestartBudget(pool.max_host_restarts, window_s=60.0)
    results = {}
    pool._hosts[0]["last_beat"] = 6.0            # beat 3.8 s ago: alive
    silent = pool._hosts[1]["proc"]
    pool._scan(results, [("127.0.0.1", 1)], 9.9, None, None, budget, now=9.8)
    assert silent.killed and "missed heartbeats" in faults[0][1] and not spawned
    assert results[1]["error"] is None and "missed heartbeats" in results[1]["fault"]
    assert not pool._hosts[0]["proc"].killed and 0 not in results


def test_supervisor_gives_a_host_that_never_beat_the_startup_headroom():
    """Until its first beat a host is starting (its bootstrap imports
    torch), not silent: past host_stall_s it is left alone, past the
    pool's grace_s it counts as stalled; once it has beaten, host_stall_s
    applies again. A dead host is a death whether it beat or not."""
    faults = []
    pool, spawned = _supervised_pool(faults)
    budget = RestartBudget(5, window_s=600.0)
    results = {}
    for st in pool._hosts.values():
        st["beaten"] = False
    pool._scan(results, [("127.0.0.1", 1)], 200.0, None, None, budget, now=30.0)
    assert faults == [] and not spawned
    pool._hosts[0]["beaten"] = True                 # host 0 beat at 0.0, then fell silent
    pool._scan(results, [("127.0.0.1", 1)], 200.0, None, None, budget, now=30.0)
    assert [f[0] for f in faults] == [0] and "> 5.0s" in faults[0][1]
    pool._hosts[0]["last_beat"] = pool.grace_s       # its replacement beats
    pool._scan(results, [("127.0.0.1", 1)], 200.0, None, None, budget,
               now=pool.grace_s + 1.0)
    assert [f[0] for f in faults] == [0, 1] and f"> {pool.grace_s}s" in faults[1][1]
    assert [s[0] for s in spawned] == [0, 1] and results == {}


def test_supervisor_respawns_within_the_hosts_window_not_its_own():
    """A beat carrying a constructed host's window end (its window starts
    after its bootstrap and warm-up) moves the window the pool serves: a
    death past the pool's own 10 s but inside the hosts' 20 s is respawned
    for what is left of theirs. The replacement's and a grown host's
    later windows move nothing; a dead epoch's beat is counted and
    dropped."""
    faults = []
    pool, spawned = _supervised_pool(faults)
    budget = RestartBudget(5, window_s=600.0)
    end = pool._note_beat({"__heartbeat__": 0, "__epoch__": 0, "__window_end__": 20.0},
                          now=12.0, window_end=10.0)
    assert end == 20.0 and pool._hosts[0]["last_beat"] == 12.0
    assert pool._note_beat({"__heartbeat__": 1, "__epoch__": 0}, now=12.5,
                           window_end=end) == 20.0
    pool._hosts[1]["proc"] = _Proc(False, exitcode=-9)
    pool._scan({}, [("127.0.0.1", 1)], end, None, None, budget, now=13.0)
    assert spawned == [(1, (2, 3), 1, 7.0)] and pool.host_restarts == 1
    assert pool._note_beat({"__heartbeat__": 1, "__epoch__": 0, "__window_end__": 99.0},
                           now=14.0, window_end=end) == 20.0
    assert pool.stale_frames_rejected == 1
    for h, epoch in ((1, 1), (2, 0)):            # the replacement; a grown host
        assert pool._note_beat({"__heartbeat__": h, "__epoch__": epoch,
                                "__window_end__": 27.0}, now=15.0, window_end=end) == 20.0
    assert pool._hosts[1]["last_beat"] == 15.0


def test_host_fault_moves_pending_frames_to_the_fault_bucket():
    """SeedSystem's per-death seam: a dead host's queued, untrained
    unrolls leave as fault drops and the ledger stays conserved."""
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=det_policy, num_actors=2, unroll=4,
                        envs_per_actor=2, transport="socket", num_actor_hosts=2,
                        algo="vtrace", supervise_hosts=True)
    for v in range(3):
        system.onpolicy_queue.put({**_traj(np.random.default_rng(v), t=4),
                                   "param_version": np.int64(0)})
    system._host_fault(1, "actor-host-1 (epoch 0) died without reporting")
    onp = system.onpolicy_queue.stats()
    assert onp["frames_dropped_fault"] == 12 and onp["frames_pending"] == 0
    assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"]
    assert system._recovery_stats()["host_faults"] == 1
    assert system._recovery_stats()["frames_dropped_by_fault"] == 12


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("kw", [
    {"telemetry": object()}, {"ops_port": 0}, {"autoscale": object()},
    {"telemetry": object(), "transport": "shm"}, {"autoscale": object(), "transport": "socket"}])
def test_ops_plane_stays_refused_on_every_transport(kw):
    """The ops plane's validation on every transport (the name predates
    its port): a wrong `telemetry` or `autoscale` raises TypeError before a
    gateway or a pool exists; ``ops_port=0`` builds the default bundle and
    answers /healthz over HTTP until `stop_ops`."""
    def make():
        return SeedSystem(env_factory=CPU_CATCH, policy_step=det_policy, num_actors=1,
                          unroll=4, **kw)
    if "ops_port" in kw:
        import json
        import urllib.request
        system = make()
        try:
            host, port = system.ops_address
            with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=5) as r:
                assert r.status == 200 and json.loads(r.read())["verdict"] == "healthy"
        finally:
            system.stop_ops()
        return
    name = "telemetry" if "telemetry" in kw else "autoscale"
    with pytest.raises(TypeError, match=f"{name} must be a repro_torch"):
        make()


@pytest.mark.parametrize("kw", [{"telemetry": True}, {"elastic": True}])
def test_actor_host_pool_refuses_the_ops_branches(kw):
    """Both ops branches construct (they were refused before their port);
    outside a run an elastic pool refuses grow and drain, and no host is
    up to kill."""
    pool = ActorHostPool(CPU_CATCH, num_actors=1, envs_per_actor=2, unroll=4, **kw)
    assert pool.telemetry is kw.get("telemetry", False)
    assert pool.elastic is kw.get("elastic", False)
    assert pool.request_grow() is False and pool.request_drain() is False
    assert pool.kill_host(0) is False
    assert (pool.hosts_grown, pool.hosts_drained, pool.hw_actors) == (0, 0, 1)
    assert pool.live_hosts() == 1


def test_wire_validation_as_the_reference():
    with pytest.raises(ValueError, match="exceeds num_actor_hosts"):
        SeedSystem(env_factory=CPU_CATCH, policy_step=det_policy, num_actors=2, unroll=4,
                   transport="socket", num_actor_hosts=1, num_gateways=2)
    with pytest.raises(ValueError, match="must be in"):
        SeedSystem(env_factory=CPU_CATCH, policy_step=det_policy, num_actors=1, unroll=4,
                   transport="shm", num_actor_hosts=2)


# ------------------------------------- system runs over spawned actor hosts

def _recording(system):
    """Record every unroll the system's sink stores, in arrival order."""
    got = []
    add = system.replay.add

    def record(traj, priority):
        got.append(traj)
        add(traj, priority)

    system.replay.add = record
    return got


def _rollouts(transport, seconds):
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=det_policy, num_actors=1, unroll=4,
                        envs_per_actor=3, deadline_ms=2.0, transport=transport,
                        replay_capacity=4096)
    got = _recording(system)
    system.warmup()
    stats = system.run(seconds=seconds, with_learner=False)
    return system, stats, got


@pytest.mark.parametrize("transport", ["socket", "shm"])
def test_wire_rollouts_bit_identical_to_inproc(transport):
    """THE transport contract: same seeds, same warm-up, a deterministic
    policy -> the per-lane unroll stream that crosses the wire (one
    spawned actor host, its Catch lanes on its own CPU) equals the
    in-process one, bitwise; the counters add up and no child touched
    CUDA."""
    n = 6
    _, stats_in, want = _rollouts("inproc", 0.5)
    system, stats, got = _rollouts(transport, 1.5)
    assert stats["host_errors"] == [] and stats["inference_error"] is None
    assert stats["host_cuda_initialized"] == [False]
    assert len(want) >= n and len(got) >= n, (len(want), len(got))
    for i, (ta, tb) in enumerate(zip(want[:n], got[:n])):
        assert sorted(ta) == sorted(tb)
        for k in ta:
            va, vb = np.asarray(ta[k]), np.asarray(tb[k])
            assert va.dtype == vb.dtype, (i, k)
            assert np.array_equal(va, vb), f"unroll {i} key {k} diverged"
    assert stats["env_frames"] == stats["actor_iterations"] * 3
    # the gateways stop as soon as the hosts report, so a flush still
    # unread then is not sunk; what was sunk, the gateway counted
    assert len(got) == stats["gateway_traj_frames"] == 3 * stats["gateway_traj_batch_frames"]
    assert stats["gateway_traj_batch_frames"] <= stats["unroll_flushes"]
    assert stats["actor_hosts"] == 1 and stats["gateway_connections"] == 1
    if transport == "shm":
        assert stats["gateway_shm_conns"] == 1 and stats["host_shm_frames"] > 0
    else:
        assert stats["gateway_shm_conns"] == 0 and stats["host_shm_frames"] == 0
    assert system.actors == [] and stats["recovery"]["host_faults"] == 0


def test_r2d2_over_the_socket_trains_with_two_hosts_and_gateways():
    """`train_r2d2.build(transport="socket")` at the reduced agent: two
    actor hosts of one actor each, hashed across two gateways, ALESimEnv
    from the picklable default factory; replay fills over the wire and
    the learner steps on it."""
    run = train_r2d2.build(REDUCED, actors=2, envs_per_actor=2, device="cpu",
                           transport="socket", actor_hosts=2, gateways=2)
    stats = run.system.run(seconds=2.0)
    assert stats["host_errors"] == [] and stats["learner_error"] is None
    assert stats["inference_error"] is None
    assert stats["learner_steps"] > 0 and len(run.system.replay) > 0
    assert stats["env_frames"] == stats["actor_iterations"] * 2 > 0
    assert stats["num_gateways"] == 2 and stats["per_gateway_connections"] == [1, 1]
    assert 0 < stats["gateway_traj_frames"] <= 2 * stats["unroll_flushes"]
    assert stats["host_cuda_initialized"] == [False, False]


def test_vtrace_over_the_socket_conserves_the_ledger():
    """V-trace with its actors in two spawned hosts: CODEC_ONPOLICY is
    negotiated, behavior logprobs and versions ride the wire into the
    trajectory queue, the learner trains, and generated == trained +
    dropped with nothing pending."""
    run, stats = train_vtrace.run_point(2, 2.0, device="cpu", transport="socket",
                                        actor_hosts=2)
    onp = stats["onpolicy"]
    assert stats["host_errors"] == [] and stats["actor_hosts"] == 2
    assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"]
    assert onp["frames_pending"] == 0 and onp["frames_trained"] > 0
    assert onp["frames_generated"] <= stats["env_frames"] == stats["actor_iterations"] * 4
    assert stats["gateway_traj_frames"] > 0 and stats["learner_steps"] > 0
    assert stats["recovery"]["frames_dropped_by_fault"] == 0
