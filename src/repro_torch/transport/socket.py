"""TCP + shared-memory transport: disaggregated actor hosts behind a wire.

A copy of ``repro.transport.socket`` with its imports taken from the
port (`core.inference`, `fault.backoff`, `telemetry`), so that it imports
nothing of the JAX package.

Client side — `SocketTransport`: all actor threads on one host share ONE
TCP connection; a per-connection ``request_id`` demultiplexes replies back
to the right actor's reply queue (gRPC-stream-shaped, like SEED RL's
inference RPC). Trajectory unrolls ride the same connection as ``TRAJ``
frames, so an actor host needs exactly one socket to the learner box.
`SyncSocketTransport` is the per-actor variant (SEED's streaming-RPC
shape): the submitting thread reads its own reply — zero wakeups.
`ShmTransport` extends it for co-located hosts: after a ``CODEC_SHM``
HELLO grant the client creates a pair of `repro_torch.transport.shm.ShmRing`
segments and frames ride shared memory — zero syscalls — with the TCP
connection retained for spill (ring full / frame too big), control, and
liveness.

Sends are scatter-gather: the codec's ``encode_*_parts`` emit header
bytes + memoryviews over the source arrays, and `sendmsg_all` hands the
list to ``socket.sendmsg`` — no concatenation copy on the hot path.
Optional encodings ride the per-connection HELLO negotiation:
``compress=True`` offers ``CODEC_RLE`` (uint8 payloads), ``quant=``16'/
'q8'`` offers ``CODEC_QUANT`` (float32 observation payloads), and
``coalesce=True`` offers ``CODEC_TRAJBATCH`` so a whole actor flush of
unroll records leaves as ONE ``TRAJ_BATCH`` frame (one syscall / ring
slot) instead of one frame per lane record.

Server side — `InferenceGateway`: accepts N actor-host connections and
demultiplexes request frames into the central `InferenceServer`'s request
queues — the SAME routing the in-process actors use, so remote and local
actors batch together and the batching deadline + per-(actor, lane)
recurrent-slot semantics hold unchanged across the wire. Each request
carries a `_WireReply` whose ``put`` encodes the reply and hands it to the
connection's reply channel: a dedicated `_ConnWriter` thread (bounded
queue) for TCP peers, or a direct s2c ring write for shm peers — the
latter runs on the server's batch-loop thread itself, saving two thread
wakeups and two syscalls per frame, which on an oversubscribed host is
most of the loopback reply latency. A writer whose queue fills is failed
and its connection closed: the client's pending replies poison, which is
the fail-fast contract, not a silent stall. To shard the accept loop
itself, run several gateways in front of one server
(`SeedSystem(num_gateways=G)`) and hash actor hosts across their
addresses (`launch.actor_host`).

Fail-fast: a dead server drains its queues with poison `ReplyError`s which
the writers forward as ``ERROR`` frames before exiting; a dropped
connection poisons every pending reply client-side. The shm rings carry
NO liveness state — peer death is always detected on the TCP socket, so a
dead reader severs the connection exactly like the plain socket path.

Failure domains (`repro_torch.fault` integration — see also `repro.fault`'s
docstring for the system-wide matrix):

  what dies                  what survives                 ledger records
  -------------------------  ----------------------------  ----------------
  one TCP connection         the gateway, every other      unrolls already
  (sever / RST / peer        conn; the client reconnects   sunk stay
  crash)                     with `reconnect=` backoff,    `trained`-able;
                             re-HELLOs, re-sends the one   in-flight reply
                             in-flight request             is re-requested
  one gateway (of G)         the server + other gateways;  same — TRAJ
                             clients re-hash host_id %     frames buffered
                             |surviving| over              client-side
                             `failover_addresses`          flush after
                                                           failover
  the shm ring pair          the TCP spill path; on        identical to the
  (peer died mid-attach)     reconnect the client unlinks  TCP sever row
                             and creates FRESH rings
  the whole client host      gateway reader exits with a   frames that
  (SIGKILL)                  postmortem; `ActorHostPool`   never reached
                             respawns the host (same       the sink were
                             host_id -> same slots);       never generated;
                             stale pending unrolls drain   pending drains to
                             via `drop_pending()`          `dropped_fault`

Reconnect is strictly opt-in (`reconnect=None` keeps every path
bit-identical to the fail-fast behavior above). The multiplexed
`SocketTransport` does NOT reconnect — its N-actors-one-wire sharing
makes transparent re-submit ambiguous; deployments that want survival
use the per-actor sync transports, where the one-in-flight-request
contract makes recovery exact. One caveat: a recovered request re-runs
the policy forward for that observation, so recurrent slots see one
duplicated step per failover (feedforward policies are unaffected).
"""

import contextlib
import itertools
import os
import queue
import select as _select
import socket as _socket
import struct
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.inference import InferenceRequest, ReplyError
from repro_torch.fault.backoff import BackoffPolicy
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracer import next_trace_seq
from repro_torch.transport.codec import (CODEC_ONPOLICY, CODEC_QUANT,
                                         CODEC_RLE, CODEC_SHM, CODEC_TRAJBATCH,
                                         DEFAULT_MAX_FRAME, FLAG_F16, FLAG_Q8,
                                         FLAG_RLE, KIND_ERROR, KIND_HELLO,
                                         KIND_REPLY, KIND_REQUEST, KIND_SHM,
                                         KIND_TRAJ, KIND_TRAJ_BATCH,
                                         SUPPORTED_CODECS, CodecError,
                                         decode_frame, encode_error,
                                         encode_hello, encode_reply,
                                         encode_reply_parts, encode_request,
                                         encode_request_parts, encode_shm,
                                         encode_traj_batch_parts,
                                         encode_trajectory,
                                         encode_trajectory_parts, read_frame,
                                         recv_exact)
from repro_torch.transport.local import Transport
from repro_torch.transport.shm import (DEFAULT_NUM_SLOTS, DEFAULT_SLOT_SIZE,
                                       ShmRing, ShmRingError)

Address = Tuple[str, int]

_LEN = struct.Struct(">I")

# TRAJ keys only sent once the gateway granted CODEC_ONPOLICY (an old
# gateway would forward them into a replay sink that never asked for them)
_ONPOLICY_TRAJ_KEYS = ("behavior_logprobs", "param_version")

# buffered unroll records before a TRAJ_BATCH flush is forced even without
# an intervening request (an actor flushes E records then submits, so the
# cap only matters for pathological callers)
_TRAJ_COALESCE_CAP = 256

_IOV_MAX = 1024        # POSIX minimum for sendmsg iovec count

# shared no-op context for "tracer is None" code paths
_NOOP_CTX = contextlib.nullcontext()


def _is_loopback(host: str) -> bool:
    return host.startswith("127.") or host in ("::1", "localhost")


def sendmsg_all(sock: _socket.socket, parts: List) -> None:
    """Scatter-gather ``sendall``: one ``sendmsg`` syscall carries the
    whole header+payload parts list in the common case; partial sends
    resume by slicing memoryviews, never by copying."""
    views = []
    for p in parts:
        v = p if isinstance(p, memoryview) else memoryview(p)
        if v.format != "B" or v.ndim != 1:
            v = v.cast("B")
        if v.nbytes:
            views.append(v)
    while views:
        sent = sock.sendmsg(views[:_IOV_MAX])
        while views and sent:
            if sent >= views[0].nbytes:
                sent -= views[0].nbytes
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


class _SpinBackoff:
    """Ring-poll wait strategy: a few ``sched_yield`` passes first (on an
    oversubscribed host the peer is probably runnable RIGHT NOW and just
    needs the core), then exponential sleep up to 1 ms so an idle
    connection costs ~nothing."""

    def __init__(self, yields: int = 32, max_sleep: float = 1e-3):
        self._yields = yields
        self._max = max_sleep
        self._n = 0
        self._sleep = 1e-5

    def reset(self):
        self._n = 0
        self._sleep = 1e-5

    def wait(self):
        if self._n < self._yields:
            self._n += 1
            os.sched_yield()
            return
        time.sleep(self._sleep)
        self._sleep = min(self._sleep * 2.0, self._max)


def _offer_mask(compress: bool, onpolicy: bool, quant: Optional[str] = None,
                coalesce: bool = False, shm: bool = False) -> int:
    """HELLO capability offer: only the codecs the caller actually wants —
    offering everything we support would silently enable features the
    deployment didn't opt into."""
    return ((CODEC_RLE if compress else 0)
            | (CODEC_ONPOLICY if onpolicy else 0)
            | (CODEC_QUANT if quant else 0)
            | (CODEC_TRAJBATCH if coalesce else 0)
            | (CODEC_SHM if shm else 0))


def _apply_hello_grant(transport, frame) -> None:
    """Apply a gateway HELLO grant to a client transport — ONE definition
    for every read path (async recv loop, sync wait_hello, sync reply
    read), so a future capability bit cannot be granted on one path and
    missed on another. `_post_hello` is the subclass hook that runs AFTER
    the grant lands (the shm transport creates its rings there)."""
    transport._rle = bool(frame.codecs & CODEC_RLE)
    transport._onpolicy = bool(frame.codecs & CODEC_ONPOLICY)
    transport._quant = bool(frame.codecs & CODEC_QUANT)
    transport._trajbatch = bool(frame.codecs & CODEC_TRAJBATCH)
    transport._shm_granted = bool(frame.codecs & CODEC_SHM)
    transport._post_hello()


def _strip_onpolicy_keys(arrays: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """Drop on-policy metadata before sending TRAJ to a peer that did not
    grant CODEC_ONPOLICY (interop: the frame stays decodable AND
    semantically what an old gateway expects)."""
    if any(k in arrays for k in _ONPOLICY_TRAJ_KEYS):
        return {k: v for k, v in arrays.items()
                if k not in _ONPOLICY_TRAJ_KEYS}
    return arrays


def _check_quant(quant: Optional[str]) -> Optional[str]:
    if quant not in (None, "f16", "q8"):
        raise ValueError(f"quant={quant!r}; expected None, 'f16' or 'q8'")
    return quant


class _ScalarReply:
    """Unwrap a lane-batched (1,) reply to a scalar action client-side, so
    the legacy single-obs ``submit`` never needs a wire flag round-trip."""

    def __init__(self, inner: "queue.Queue"):
        self._inner = inner

    def get(self, timeout=None):
        out = self._inner.get(timeout=timeout)
        return out if isinstance(out, ReplyError) else out[0]


class SocketTransport(Transport):
    """Client half of the wire. One connection, many actor threads."""

    def __init__(self, sock: _socket.socket,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 compress: bool = False, onpolicy: bool = False,
                 quant: Optional[str] = None, telemetry=None):
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._sock = sock
        self._dialed_address: Optional[Address] = None
        self.max_frame = max_frame
        self._tracer = (telemetry.tracer
                        if telemetry is not None and telemetry.enabled
                        else None)
        self._send_lock = threading.Lock()
        self._pending: Dict[int, "queue.Queue"] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 1          # 0 is the broadcast id — never assigned
        self._closed = threading.Event()
        self.error: Optional[str] = None
        # capabilities start OFF and only turn on when the gateway's HELLO
        # grants them (requests sent in the negotiation window go raw — a
        # correct, just unoptimized, encoding)
        self._rle = False
        self._onpolicy = False
        self._quant = False
        self._trajbatch = False
        self._shm_granted = False
        self._quant_mode = _check_quant(quant)
        self._hello = threading.Event()
        self.param_version = 0     # latest behavior version seen on replies
        offer = _offer_mask(compress, onpolicy, quant=quant)
        self._onpolicy_offered = bool(offer & CODEC_ONPOLICY)
        if offer:
            try:
                sock.sendall(encode_hello(offer))
            except OSError as e:
                self.error = f"send failed: {e}"
        else:
            self._hello.set()      # nothing to negotiate
        self._recv_thread = threading.Thread(target=self._recv_loop,
                                             daemon=True)
        self._recv_thread.start()

    @classmethod
    def connect(cls, address: Address, timeout_s: float = 10.0,
                max_frame: int = DEFAULT_MAX_FRAME,
                compress: bool = False, onpolicy: bool = False,
                **kwargs) -> "SocketTransport":
        """Dial the gateway, retrying while it binds (actor hosts and the
        learner box start concurrently). Extra kwargs reach the
        constructor, so subclasses (sync / shm) share this dialer."""
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                sock = _socket.create_connection(address, timeout=2.0)
                sock.settimeout(None)
                t = cls(sock, max_frame=max_frame, compress=compress,
                        onpolicy=onpolicy, **kwargs)
                # remember where we dialed so the reconnect path can re-dial
                # (a raw-socket constructor has no address to remember)
                t._dialed_address = address
                return t
            except OSError:
                if time.perf_counter() >= deadline:
                    raise
                time.sleep(0.05)

    @property
    def onpolicy_granted(self) -> bool:
        """True once the gateway's HELLO granted CODEC_ONPOLICY."""
        return self._onpolicy

    @property
    def _quant_eff(self) -> Optional[str]:
        """Quantization mode actually on the wire: the requested mode once
        (and only once) the gateway granted CODEC_QUANT."""
        return self._quant_mode if self._quant else None

    def _post_hello(self):
        """Subclass hook: runs after every HELLO grant is applied."""

    def wait_hello(self, timeout_s: float = 5.0) -> bool:
        """Block until the gateway answered our HELLO (or no offer was
        made). Returns False on timeout/error — callers that REQUIRE a
        capability should fail fast rather than stream stripped frames."""
        return self._hello.wait(timeout=timeout_s) and self.error is None

    # ------------------------------------------------------- actor surface

    def submit_batch(self, actor_id: int, obs: np.ndarray,
                     trace_seq: int = 0) -> "queue.Queue":
        obs = np.asarray(obs)
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        if self.error is not None or self._closed.is_set():
            reply.put(ReplyError(self.error or "transport closed"))
            return reply
        with self._pending_lock:
            request_id = self._next_id
            self._next_id += 1
            self._pending[request_id] = reply
        try:
            self._send_parts(encode_request_parts(
                actor_id, request_id, obs, compress=self._rle,
                quant=self._quant_eff, trace_seq=trace_seq))
        except OSError as e:
            self._fail(f"send failed: {e}")
        return reply

    def submit(self, actor_id: int, obs: np.ndarray):
        return _ScalarReply(
            self.submit_batch(actor_id, np.asarray(obs)[None]))

    def send_trajectory(self, arrays: Dict[str, np.ndarray],
                        actor_id: int = 0):
        """Trajectory sink over the same wire (``flush_lane_unrolls``
        schema); drops silently once the transport has failed — the actor
        is already being torn down on `error`. (This multiplexed client
        sends one TRAJ frame per record; the per-actor sync client is the
        one that coalesces, since its flush boundary is unambiguous.)"""
        if self.error is not None or self._closed.is_set():
            return
        if self._onpolicy_offered and not self._hello.is_set():
            # an offered grant races the first unroll only at connect
            # time (the gateway answers HELLO immediately): wait it out
            # rather than strip metadata the deployment asked for
            self._hello.wait(timeout=5.0)
        if not self._onpolicy:
            arrays = _strip_onpolicy_keys(arrays)
        tr = self._tracer
        seq = next_trace_seq() if tr is not None else 0
        try:
            with (tr.trace_span("wire/traj_send", seq=seq)
                  if tr is not None else _NOOP_CTX):
                self._send_parts(encode_trajectory_parts(
                    actor_id, arrays, compress=self._rle,
                    quant=self._quant_eff, trace_seq=seq))
        except OSError as e:
            self._fail(f"send failed: {e}")

    def close(self):
        self._closed.set()
        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._recv_thread.join(timeout=5.0)

    # ------------------------------------------------------------ plumbing

    def _send(self, frame: bytes):
        with self._send_lock:
            self._sock.sendall(frame)

    def _send_parts(self, parts: List):
        with self._send_lock:
            sendmsg_all(self._sock, parts)

    def _fail(self, message: str):
        """Poison every pending reply so no actor blocks on a dead wire."""
        if self.error is None:
            self.error = message
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for reply in pending.values():
            reply.put(ReplyError(self.error))

    def _pop(self, request_id: int) -> Optional["queue.Queue"]:
        with self._pending_lock:
            return self._pending.pop(request_id, None)

    def _recv_loop(self):
        try:
            while not self._closed.is_set():
                frame = read_frame(lambda n: recv_exact(self._sock, n),
                                   self.max_frame)
                if frame is None:                      # clean peer close
                    break
                if frame.kind == KIND_REPLY:
                    if frame.param_version > self.param_version:
                        self.param_version = frame.param_version
                    reply = self._pop(frame.request_id)
                    if reply is not None:
                        reply.put(frame.array)
                elif frame.kind == KIND_HELLO:
                    # the gateway granted (or refused) our codec offer
                    _apply_hello_grant(self, frame)
                    self._hello.set()
                elif frame.kind == KIND_ERROR:
                    if frame.request_id == 0:          # broadcast: all fail
                        self._fail(frame.message)
                    else:
                        reply = self._pop(frame.request_id)
                        if reply is not None:
                            reply.put(ReplyError(frame.message))
                else:
                    raise CodecError(
                        f"unexpected frame kind {frame.kind} on client")
        except (OSError, CodecError) as e:
            if not self._closed.is_set():
                self._fail(f"connection lost: {e}")
            return
        except Exception as e:       # never die silently holding replies
            self._fail(f"receiver crashed: {e!r}")
            return
        # clean EOF before OUR close() is a gateway shutdown: poison any
        # in-flight requests and mark the wire dead so actors stop
        if not self._closed.is_set():
            self._fail("gateway closed the connection")


class _ConnWriter:
    """Per-connection reply writer: the server's batch loop hands encoded
    frames (bytes, or scatter-gather parts lists) to a bounded queue and
    returns immediately; this thread does the blocking send. One actor
    host with a full TCP buffer can therefore stall only its own writer —
    every other connection (and the batch loop itself) keeps moving. A
    queue that fills means the peer has stopped reading: the writer FAILS
    the connection (shutdown), which poisons the client's pending replies
    — fail-fast, not a hidden stall.

    `stop()` poisons the queue with a sentinel; frames already enqueued
    (including the ``ERROR`` drain of a dying server) are flushed first,
    so the fail-fast wire contract survives the async hop."""

    _POISON = object()

    def __init__(self, sock, maxsize: int = 256, health=None,
                 name: Optional[str] = None):
        self._sock = sock
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self.failed = False
        # optional HeartbeatRegistry: the poll loop wakes at least every
        # 0.25 s even when idle, so a 2 s deadline catches a writer thread
        # wedged inside sendall (peer stopped reading but kept the socket)
        self._health = health
        self._hb_name = name
        if health is not None and name is not None:
            health.register(name, stale_after_s=2.0)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def send(self, frame: bytes):
        if self.failed or self._stop.is_set():
            return
        try:
            self._q.put_nowait(frame)
        except queue.Full:
            self.fail()

    def send_parts(self, parts: List):
        if self.failed or self._stop.is_set():
            return
        try:
            self._q.put_nowait(list(parts))
        except queue.Full:
            self.fail()

    def fail(self):
        """Slow or dead consumer: sever the connection so the client's
        recv loop poisons its pending replies, and unblock any in-flight
        sendall."""
        self.failed = True
        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass

    def stop(self):
        self._stop.set()
        try:
            self._q.put_nowait(self._POISON)
        except queue.Full:
            pass                 # loop polls _stop, so it still exits
        self._thread.join(timeout=5.0)

    def _loop(self):
        hb, hb_name = self._health, self._hb_name
        try:
            while True:
                if hb is not None and hb_name is not None:
                    hb.beat(hb_name)
                try:
                    frame = self._q.get(timeout=0.25)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    continue
                if frame is self._POISON:
                    return
                if self.failed:
                    continue     # drain without sending
                try:
                    if isinstance(frame, list):
                        sendmsg_all(self._sock, frame)
                    else:
                        self._sock.sendall(frame)
                except OSError:
                    self.failed = True
        finally:
            if hb is not None and hb_name is not None:
                hb.unregister(hb_name)


class _ShmReplyChannel:
    """Reply channel for an shm-attached connection: frames go straight
    into the s2c ring FROM THE CALLING THREAD (the server's batch loop) —
    a memcpy instead of a queue hand-off + writer wakeup + sendall. Falls
    back to the TCP writer when the ring is full or the frame exceeds a
    slot (the client polls both paths, so spill preserves delivery)."""

    def __init__(self, ring: ShmRing, writer: _ConnWriter,
                 gateway: "InferenceGateway"):
        self._ring = ring
        self._writer = writer
        self._gateway = gateway

    def send(self, frame: bytes):
        if not self._ring.try_put([frame]):
            self._gateway._bump("shm_spill_frames")
            self._writer.send(frame)

    def send_parts(self, parts: List):
        if not self._ring.try_put(parts):
            self._gateway._bump("shm_spill_frames")
            self._writer.send_parts(parts)


class _WireReply:
    """Queue-shaped reply proxy: ``put(result)`` encodes the action array
    (or poison `ReplyError`) on the caller's thread — cheap; actions are a
    few dozen bytes — and hands the parts to the connection's reply
    channel: the `_ConnWriter` thread for TCP peers, a direct ring write
    for shm peers. Writer failures are contained: a vanished actor host
    must not take the server (and every other connection's actors) down
    with it."""

    def __init__(self, gateway: "InferenceGateway", channel,
                 request_id: int, trace_seq: int = 0):
        self._gateway = gateway
        self._channel = channel
        self._request_id = request_id
        self._trace_seq = trace_seq

    def put(self, result):
        if isinstance(result, ReplyError):
            self._gateway._bump("error_frames")
            self._channel.send(encode_error(self._request_id,
                                            result.message))
        else:
            self._gateway._bump("reply_frames")
            tr = self._gateway._tracer
            seq = self._trace_seq
            with (tr.trace_span("gateway/reply_encode", seq=seq)
                  if tr is not None and seq else _NOOP_CTX):
                # the REPLY echoes the REQUEST's stitch id so the actor-
                # side decode leg lands on the same flow
                self._channel.send_parts(encode_reply_parts(
                    self._request_id, np.asarray(result),
                    version=self._gateway._version(), trace_seq=seq))


class _SyncReply:
    """Reply handle for `SyncSocketTransport`: `get` reads the socket in
    the calling (actor) thread. Raises `queue.Empty` on timeout to match
    the `queue.Queue` contract the actor loop already handles."""

    def __init__(self, transport: "SyncSocketTransport", request_id: int):
        self._transport = transport
        self._request_id = request_id

    def get(self, timeout: Optional[float] = None):
        return self._transport._read_reply(self._request_id, timeout)


class SyncSocketTransport(Transport):
    """One connection per actor thread, replies read synchronously.

    The multiplexed `SocketTransport` pays two client-side thread wakeups
    per reply (recv thread -> pending queue -> actor); under a busy GIL
    each wakeup can convoy for milliseconds. This variant is SEED's
    per-actor streaming-RPC shape instead: the actor thread that submitted
    the request parses the reply off the socket itself — zero wakeups.
    NOT thread-safe: one actor, one in-flight request at a time (the
    actor loop's contract anyway). Trajectory sends from the same thread
    interleave safely because TRAJ frames are strictly client -> gateway.
    A mid-frame timeout keeps partial bytes buffered, so retrying `get` on
    the same reply never desynchronizes the stream.

    ``coalesce=True`` offers ``CODEC_TRAJBATCH``: unroll records buffer
    client-side and leave as ONE ``TRAJ_BATCH`` frame at the next request
    submit (the actor's flush-then-submit cadence makes that boundary
    tight: at most one request of extra latency) or on `close()` — so the
    trajectory ledger is conserved, just batched.
    """

    def __init__(self, sock: _socket.socket,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 compress: bool = False, onpolicy: bool = False,
                 quant: Optional[str] = None, coalesce: bool = False,
                 telemetry=None, _offer_shm: bool = False,
                 reconnect: Optional[BackoffPolicy] = None,
                 failover_addresses: Optional[List[Address]] = None,
                 host_id: int = 0):
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._sock = sock
        self._dialed_address: Optional[Address] = None
        self.max_frame = max_frame
        self._tracer = (telemetry.tracer
                        if telemetry is not None and telemetry.enabled
                        else None)
        self._buf = bytearray()
        self._next_id = 1
        self._rle = False        # enabled by the gateway's HELLO grant
        self._onpolicy = False
        self._quant = False
        self._trajbatch = False
        self._shm_granted = False
        self._quant_mode = _check_quant(quant)
        self._coalesce = coalesce
        self._traj_buf: List[Tuple[int, Dict[str, np.ndarray]]] = []
        self._hello_seen = False
        self.param_version = 0   # latest behavior version seen on replies
        self.error: Optional[str] = None
        # survival knobs (repro_torch.fault): None keeps every path bit-identical
        # to the historical fail-fast behavior
        self._reconnect = reconnect
        self._addresses = list(failover_addresses or [])
        self._host_id = host_id
        self._dead_addresses: set = set()
        self._inflight: Optional[Tuple[int, np.ndarray, int]] = None
        self._consec_recoveries = 0   # reset on every successful reply
        self.reconnects = 0           # successful re-dials
        self.gateway_failovers = 0    # re-dials that changed address
        self._offer = _offer_mask(compress, onpolicy, quant=quant,
                                  coalesce=coalesce, shm=_offer_shm)
        if not self._offer:
            self._hello_seen = True          # nothing to negotiate
        else:
            try:
                sock.sendall(encode_hello(self._offer))
            except OSError as e:
                self.error = f"send failed: {e}"

    connect = classmethod(SocketTransport.connect.__func__)

    @property
    def onpolicy_granted(self) -> bool:
        """True once the gateway's HELLO granted CODEC_ONPOLICY."""
        return self._onpolicy

    @property
    def _quant_eff(self) -> Optional[str]:
        return self._quant_mode if self._quant else None

    def _post_hello(self):
        """Subclass hook: runs after every HELLO grant is applied."""

    def wait_hello(self, timeout_s: float = 5.0) -> bool:
        """Drain frames in the calling thread until the gateway's HELLO
        answer lands (only HELLO/ERROR can precede our first request).
        Returns False on timeout/error — a caller that REQUIRES a
        capability should fail fast rather than stream stripped frames."""
        deadline = time.perf_counter() + timeout_s
        while not self._hello_seen and self.error is None:
            try:
                frame = self._next_frame(deadline)
            except queue.Empty:
                return False
            except (ConnectionError, CodecError) as e:
                self.error = str(e)
                return False
            if frame.kind == KIND_HELLO:
                _apply_hello_grant(self, frame)
                self._hello_seen = True
            elif frame.kind == KIND_ERROR:
                self.error = frame.message
        return self._hello_seen and self.error is None

    def submit_batch(self, actor_id: int, obs: np.ndarray,
                     trace_seq: int = 0) -> _SyncReply:
        obs = np.asarray(obs)
        if self.error is not None:
            self._recover()      # no-op (and still failed) without a policy
        self._flush_traj()
        # the one-in-flight-request contract makes transparent recovery
        # exact: this is the only request a reconnect could ever re-send
        self._inflight = (actor_id, obs, trace_seq)
        return _SyncReply(self, self._send_request(actor_id, obs, trace_seq))

    def _send_request(self, actor_id: int, obs: np.ndarray,
                      trace_seq: int) -> int:
        request_id = self._next_id
        self._next_id += 1
        if self.error is None:
            self._send_parts(encode_request_parts(
                actor_id, request_id, obs,
                compress=self._rle, quant=self._quant_eff,
                trace_seq=trace_seq))
            if self.error is not None and self._recover():
                # re-encode under the fresh connection's grants; a new
                # request id keeps any half-sent frame unambiguous
                return self._send_request(actor_id, obs, trace_seq)
        return request_id

    def submit(self, actor_id: int, obs: np.ndarray):
        return _ScalarReply(
            self.submit_batch(actor_id, np.asarray(obs)[None]))

    def send_trajectory(self, arrays: Dict[str, np.ndarray],
                        actor_id: int = 0):
        if self.error is not None:
            return
        if not self._onpolicy:
            arrays = _strip_onpolicy_keys(arrays)
        if self._coalesce and self._trajbatch:
            # records are freshly-stacked copies (flush_lane_unrolls), so
            # holding them until the next request boundary is safe
            self._traj_buf.append((actor_id, arrays))
            if len(self._traj_buf) >= _TRAJ_COALESCE_CAP:
                self._flush_traj()
            return
        tr = self._tracer
        seq = next_trace_seq() if tr is not None else 0
        with (tr.trace_span("wire/traj_send", seq=seq)
              if tr is not None else _NOOP_CTX):
            self._send_parts(encode_trajectory_parts(
                actor_id, arrays, compress=self._rle,
                quant=self._quant_eff, trace_seq=seq))

    def _flush_traj(self):
        if not self._traj_buf:
            return
        buf, self._traj_buf = self._traj_buf, []
        if self.error is not None:
            return
        by_actor: Dict[int, List[Dict[str, np.ndarray]]] = {}
        for aid, arrays in buf:
            by_actor.setdefault(aid, []).append(arrays)
        tr = self._tracer
        for aid, trajs in by_actor.items():
            # each coalesced flush frame gets its own stitch id so the
            # gateway-side ingest span pairs with this client-side send
            seq = next_trace_seq() if tr is not None else 0
            with (tr.trace_span("wire/traj_flush", seq=seq,
                                args={"records": len(trajs)})
                  if tr is not None else _NOOP_CTX):
                self._send_parts(encode_traj_batch_parts(
                    aid, trajs, compress=self._rle, quant=self._quant_eff,
                    trace_seq=seq))

    def close(self):
        self._flush_traj()       # conserve the trajectory ledger
        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    # ------------------------------------------------------------ sending

    def _send_parts(self, parts: List):
        try:
            # clear any sub-second timeout a previous timed get() left on
            # the socket: a partially-sent frame on a send timeout would
            # desynchronize the whole stream
            self._sock.settimeout(None)
            sendmsg_all(self._sock, parts)
        except OSError as e:
            self.error = f"send failed: {e}"

    # ------------------------------------------------------------ reading

    def _fill(self, n: int, deadline: Optional[float]):
        """Grow the buffer to >= n bytes; `queue.Empty` on deadline, with
        any partial bytes retained for the next attempt."""
        while len(self._buf) < n:
            if deadline is None:
                self._sock.settimeout(None)
            else:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise queue.Empty
                self._sock.settimeout(remaining)
            try:
                chunk = self._sock.recv(1 << 16)
            except TimeoutError:
                raise queue.Empty from None
            except OSError as e:
                raise ConnectionError(f"recv failed: {e}") from None
            if not chunk:
                raise ConnectionError("gateway closed the connection")
            self._buf += chunk

    def _next_frame(self, deadline):
        self._fill(4, deadline)
        (body_len,) = struct.unpack(">I", self._buf[:4])
        if body_len > self.max_frame:
            raise CodecError(
                f"frame of {body_len} bytes exceeds max_frame={self.max_frame}")
        self._fill(4 + body_len, deadline)
        body = bytes(self._buf[4:4 + body_len])
        del self._buf[:4 + body_len]
        return decode_frame(body, max_frame=self.max_frame)

    def _read_reply(self, request_id: int, timeout: Optional[float]):
        if self.error is not None:
            return ReplyError(self.error)
        deadline = None if timeout is None else \
            time.perf_counter() + timeout
        try:
            while True:
                frame = self._next_frame(deadline)
                if frame.kind == KIND_REPLY:
                    if frame.param_version > self.param_version:
                        self.param_version = frame.param_version
                    if frame.request_id == request_id:
                        self._inflight = None
                        self._consec_recoveries = 0
                        return frame.array
                    continue            # stale reply from an abandoned rid
                if frame.kind == KIND_HELLO:
                    _apply_hello_grant(self, frame)
                    self._hello_seen = True
                    continue
                if frame.kind == KIND_ERROR:
                    if frame.request_id in (0, request_id):
                        return ReplyError(frame.message)
                    continue
                raise CodecError(
                    f"unexpected frame kind {frame.kind} on sync client")
        except queue.Empty:
            raise
        except ConnectionError as e:
            self.error = str(e)
            if self._recover():
                # the old socket died with our reply; re-send the in-flight
                # request on the fresh connection and wait for THAT reply
                # (a fresh socket cannot deliver stale replies, so the new
                # request id is the only one we will ever see)
                rid = self._resubmit_inflight()
                if rid is not None and self.error is None:
                    return self._read_reply(rid, timeout)
            return ReplyError(self.error)
        except CodecError as e:
            self.error = str(e)
            return ReplyError(self.error)
        except Exception as e:       # decode bug must not kill the actor
            self.error = f"receiver crashed: {e!r}"
            return ReplyError(self.error)

    # ------------------------------------------------------------ recovery

    def _pre_reconnect(self):
        """Subclass hook: runs before each re-dial (shm unlinks rings)."""

    def _pick_address(self) -> Optional[Address]:
        """Re-hash `host_id` over the surviving gateway list — the stable
        failover rule: every host computes the same assignment from the
        same survivor set, no coordination needed."""
        live = [a for a in self._addresses
                if tuple(a) not in self._dead_addresses]
        if not live:
            # everything is marked dead: forget the marks and retry the
            # full list (a restarted gateway reuses its address)
            self._dead_addresses.clear()
            live = list(self._addresses)
        if not live:
            return self._dialed_address
        return tuple(live[self._host_id % len(live)])

    def _recover(self) -> bool:
        """Bounded exponential-backoff reconnect: re-dial (re-hashing over
        surviving gateway addresses), re-HELLO, re-negotiate capabilities.
        Returns True with `error` cleared on success; False leaves the
        transport failed exactly like the historical fail-fast path."""
        if self._reconnect is None:
            return False
        if self._consec_recoveries >= 8:
            # flapping guard: repeated recoveries without one successful
            # reply in between means the plane is gone, not blinking
            self.error = (self.error or "wire lost") \
                + " [consecutive-recovery cap hit]"
            return False
        self._consec_recoveries += 1
        was_onpolicy = self._onpolicy
        if self._dialed_address is not None:
            self._dead_addresses.add(tuple(self._dialed_address))
        try:
            self._sock.close()
        except OSError:
            pass
        self._pre_reconnect()
        for delay in self._reconnect.delays():
            addr = self._pick_address()
            if addr is None:
                break            # raw-socket construction: nowhere to dial
            try:
                sock = _socket.create_connection(addr, timeout=2.0)
            except OSError:
                self._dead_addresses.add(tuple(addr))
                time.sleep(delay)
                continue
            sock.settimeout(None)
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            self._sock = sock
            self._buf = bytearray()
            # grants are per-connection: reset and re-negotiate from scratch
            self._rle = self._onpolicy = self._quant = False
            self._trajbatch = self._shm_granted = False
            self._hello_seen = not self._offer
            self.error = None
            if self._offer:
                try:
                    sock.sendall(encode_hello(self._offer))
                except OSError as e:
                    self.error = f"send failed: {e}"
                if self.error is not None or not self.wait_hello(5.0) \
                        or (was_onpolicy and not self._onpolicy):
                    # no (or wrong) HELLO answer: a gateway that stopped
                    # granting what the deployment requires is as dead as
                    # one that refused the dial
                    self.error = self.error or \
                        "reconnect HELLO re-negotiation failed"
                    self._dead_addresses.add(tuple(addr))
                    time.sleep(delay)
                    continue
            failover = (self._dialed_address is not None
                        and tuple(addr) != tuple(self._dialed_address))
            self._dialed_address = tuple(addr)
            self._dead_addresses.discard(tuple(addr))
            self.reconnects += 1
            if failover:
                self.gateway_failovers += 1
            return True
        self.error = self.error or "reconnect retries exhausted"
        return False

    def _resubmit_inflight(self) -> Optional[int]:
        if self._inflight is None:
            return None
        aid, obs, seq = self._inflight
        return self._send_request(aid, obs, seq)


class ShmTransport(SyncSocketTransport):
    """Co-located client: frames ride a shared-memory ring pair, TCP
    stays as the spill + control + liveness channel.

    The handshake is all client-driven: ``CODEC_SHM`` is offered only
    when dialing a loopback address; once the gateway grants it the
    client CREATES a (c2s, s2c) `ShmRing` pair and announces names +
    geometry in one ``KIND_SHM`` frame over TCP. Ring slots persist until
    the reader consumes them, so the client may start writing c2s
    immediately — the attach frame is ordered before any spilled TCP
    frame on the same stream, and ring frames are only read after it.

    Sends: a frame goes into the ring as one slot (a memcpy, no syscall);
    if the ring is full or the frame exceeds the slot payload it spills
    to TCP via the normal ``sendmsg`` path. Receives: the reply wait
    polls the s2c ring, then the socket (spill / HELLO / ERROR / EOF),
    then backs off (`_SpinBackoff`). Gateway death is therefore noticed
    exactly like the plain socket transport — TCP EOF — and poisons the
    pending reply; the rings never hold liveness state.
    """

    def __init__(self, sock: _socket.socket,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 compress: bool = False, onpolicy: bool = False,
                 quant: Optional[str] = None, coalesce: bool = False,
                 telemetry=None, slot_size: int = DEFAULT_SLOT_SIZE,
                 num_slots: int = DEFAULT_NUM_SLOTS,
                 reconnect: Optional[BackoffPolicy] = None,
                 failover_addresses: Optional[List[Address]] = None,
                 host_id: int = 0):
        self._c2s: Optional[ShmRing] = None
        self._s2c: Optional[ShmRing] = None
        self._slot_size = slot_size
        self._num_slots = num_slots
        self._backoff = _SpinBackoff()
        # single-thread counters (one actor per transport); mirrored into
        # the telemetry registry at report time by `run_actor_host` so the
        # ring hot path stays lock-free
        self.shm_frames = 0      # frames that rode the ring (sent)
        self.shm_replies = 0     # frames that arrived via the ring
        self.spill_frames = 0    # frames that fell back to TCP
        peer = sock.getpeername()[0]
        super().__init__(sock, max_frame=max_frame, compress=compress,
                         onpolicy=onpolicy, quant=quant, coalesce=coalesce,
                         telemetry=telemetry, _offer_shm=_is_loopback(peer),
                         reconnect=reconnect,
                         failover_addresses=failover_addresses,
                         host_id=host_id)

    @property
    def shm_active(self) -> bool:
        return self._c2s is not None

    def _post_hello(self):
        if not self._shm_granted or self._c2s is not None \
                or self.error is not None:
            return
        c2s = ShmRing.create(self._slot_size, self._num_slots)
        s2c = ShmRing.create(self._slot_size, self._num_slots)
        try:
            self._sock.settimeout(None)
            self._sock.sendall(encode_shm(c2s.name, s2c.name,
                                          self._slot_size,
                                          self._num_slots))
        except OSError as e:
            self.error = f"send failed: {e}"
            c2s.unlink()
            s2c.unlink()
            return
        self._c2s, self._s2c = c2s, s2c

    # ------------------------------------------------------------ sending

    def _send_parts(self, parts: List):
        if self._c2s is not None and self.error is None:
            if self._c2s.try_put(parts):
                self.shm_frames += 1
                return
            self.spill_frames += 1
        super()._send_parts(parts)

    # ------------------------------------------------------------ reading

    def _next_frame(self, deadline):
        if self._s2c is None:
            return super()._next_frame(deadline)
        while True:
            payload = self._s2c.try_get()
            if payload is not None:
                self._backoff.reset()
                self.shm_replies += 1
                return _decode_ring_frame(payload, self.max_frame)
            if self._buf:
                # mid-frame on the TCP path: finish it (the rest of the
                # bytes are already in flight on loopback)
                return super()._next_frame(deadline)
            readable, _, _ = _select.select([self._sock], [], [], 0)
            if readable:
                self._backoff.reset()
                return super()._next_frame(deadline)
            if deadline is not None and time.perf_counter() >= deadline:
                raise queue.Empty
            self._backoff.wait()

    def _pre_reconnect(self):
        """Rings are per-connection state: unlink the old pair so the
        post-reconnect HELLO grant creates a FRESH pair (`_post_hello`
        skips creation only while `_c2s` is set). The gateway side closed
        its attachments when the old reader died."""
        for ring in (self._c2s, self._s2c):
            if ring is not None:
                ring.unlink()    # client created them, client unlinks
        self._c2s = self._s2c = None
        self._backoff.reset()

    def close(self):
        super().close()          # flush trajectories, sever TCP
        for ring in (self._c2s, self._s2c):
            if ring is not None:
                ring.unlink()    # client created them, client unlinks
        self._c2s = self._s2c = None


def _decode_ring_frame(payload: bytes, max_frame: int):
    """Ring slots carry whole wire frames (length prefix included) so the
    shm and TCP paths share one codec; cross-check the prefix against the
    slot length before decoding."""
    if len(payload) < 4:
        raise CodecError(f"ring frame of {len(payload)} bytes")
    (body_len,) = _LEN.unpack_from(payload)
    if body_len != len(payload) - 4:
        raise CodecError(
            f"ring frame length prefix {body_len} != payload "
            f"{len(payload) - 4}: ring corrupt")
    return decode_frame(memoryview(payload)[4:], max_frame=max_frame,
                        zero_copy=True)


class InferenceGateway:
    """Server half of the wire: N connections -> one `InferenceServer`.

    Per connection, a reader thread decodes frames — requests into the
    server's queue (each carrying a `_WireReply` that writes the response
    back from the server thread), trajectories into ``sink``. ``port=0``
    binds an ephemeral loopback port; read ``address`` after `start()`.

    Co-located peers that negotiated ``CODEC_SHM`` attach a ring pair via
    one ``KIND_SHM`` frame; from then on the reader polls ring + socket
    and replies go straight into the s2c ring from the server's batch
    loop. ``allow_shm=False`` refuses the grant (deployment policy);
    non-loopback peers are refused unconditionally.
    """

    def __init__(self, server, sink: Optional[Callable] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 gil_switch_interval_s: Optional[float] = 1e-3,
                 version_source: Optional[Callable] = None,
                 onpolicy: bool = False, allow_shm: bool = True,
                 telemetry=None):
        self.server = server
        self.sink = sink
        self._tracer = (telemetry.tracer
                        if telemetry is not None and telemetry.enabled
                        else None)
        # ops plane (None without a full Telemetry bundle): conn readers
        # heartbeat, a severed connection files a postmortem
        self._health = getattr(telemetry, "health", None)
        self._flightrec = getattr(telemetry, "flightrec", None)
        self._conn_seq = itertools.count()
        self._bind = (host, port)
        self.max_frame = max_frame
        # learner's published param version, stamped onto every REPLY so
        # remote actor hosts can staleness-stamp their unrolls (on-policy
        # plane); None keeps replies at version 0 (unversioned)
        self.version_source = version_source
        # deployment policy, not codec capability: only an on-policy
        # gateway GRANTS CODEC_ONPOLICY — granting it from a replay-based
        # system would invite TRAJ metadata its sink never asked for
        # (mirror of the client-side _offer_mask principle)
        self.onpolicy = onpolicy
        self.allow_shm = allow_shm
        # every wire reply crosses two thread wakeups in this process
        # (reader -> server loop -> send); under CPython's default 5 ms GIL
        # slice a compute-bound peer thread turns each wakeup into a
        # multi-ms convoy, dominating the loopback RTT. A 1 ms slice
        # measured ~1.6x end-to-end frames/s on a 2-core host. None keeps
        # the process default; the old value is restored on stop().
        self._gil_interval = gil_switch_interval_s
        self._old_gil_interval: Optional[float] = None
        self.address: Optional[Address] = None
        self._listener: Optional[_socket.socket] = None
        self._stop = threading.Event()
        self._threads = []
        self._conns = []
        self._lock = threading.Lock()
        # traj_frames counts trajectory RECORDS delivered to the sink (a
        # TRAJ_BATCH frame counts each coalesced record), so the ledger is
        # conserved whether or not the client coalesces. Counters live in
        # a PRIVATE registry (each gateway owns its names; a shared one
        # would collide across `num_gateways` shards) — `stats` stays the
        # historical dict, now as an atomic snapshot; SeedSystem attaches
        # the registry to the Telemetry bundle for metrics.jsonl export.
        self.metrics = MetricsRegistry()
        self._c = self.metrics.counters("gateway", (
            "connections", "request_frames", "reply_frames", "error_frames",
            "traj_frames", "hello_frames", "rle_request_frames",
            "quant_request_frames", "traj_batch_frames", "shm_conns",
            "shm_frames", "shm_spill_frames"))
        self.error: Optional[str] = None

    @property
    def stats(self) -> dict:
        """Point-in-time atomic counter snapshot (historical dict shape)."""
        return {k: int(v) for k, v in self.metrics.read(self._c).items()}

    def _bump(self, key: str, n: int = 1):
        # N reader threads + the server loop all count; Counter.add locks
        self._c[key].add(n)

    def _version(self) -> int:
        return self.version_source() if self.version_source else 0

    def start(self) -> Address:
        if self._gil_interval is not None:
            self._old_gil_interval = sys.getswitchinterval()
            sys.setswitchinterval(self._gil_interval)
        self._listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._listener.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._listener.bind(self._bind)
        self._listener.listen(128)
        self.address = self._listener.getsockname()
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self.address

    def stop(self):
        self._stop.set()
        if self._old_gil_interval is not None:
            sys.setswitchinterval(self._old_gil_interval)
            self._old_gil_interval = None
        if self._listener is not None:
            # close() alone does not wake a thread blocked in accept() on
            # Linux, so the accept loop's join below waited its full 5 s
            # timeout; shutdown() wakes it (the reference's copy waits)
            try:
                self._listener.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        with self._lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        for t in self._threads:
            t.join(timeout=5.0)

    def sever_connection(self, index: int = 0) -> bool:
        """Fault-injection / ops hook: forcibly shut down one LIVE client
        connection (`index` into the live set, modulo). The reader thread
        takes the normal sever path — error recorded, postmortem filed —
        and a client with a reconnect policy re-dials; one without poisons
        fail-fast, exactly as if the wire had been cut by the network.
        Returns False when no live connection exists."""
        with self._lock:
            live = [s for s in self._conns if s.fileno() != -1]
            if not live:
                return False
            sock = live[index % len(live)]
        try:
            sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        return True

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return                       # listener closed by stop()
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(sock)
            self._bump("connections")
            t = threading.Thread(target=self._read_conn, args=(sock,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------- per-connection

    def _next_conn_frame(self, sock, state):
        """One frame from this connection: blocking TCP read until a ring
        is attached; afterwards poll ring first (the hot path), then the
        socket (spill / control / EOF), then back off. Returns
        (frame, via_shm); frame None means clean EOF or gateway stop."""
        c2s = state["c2s"]
        if c2s is None:
            return read_frame(lambda n: recv_exact(sock, n),
                              self.max_frame, zero_copy=True), False
        backoff = state["backoff"]
        hb, hb_name = self._health, state.get("hb_name")
        while not self._stop.is_set():
            payload = c2s.try_get()
            if payload is not None:
                backoff.reset()
                return _decode_ring_frame(payload, self.max_frame), True
            readable, _, _ = _select.select([sock], [], [], 0)
            if readable:
                backoff.reset()
                return read_frame(lambda n: recv_exact(sock, n),
                                  self.max_frame, zero_copy=True), False
            if hb is not None and hb_name is not None:
                # the shm poller never blocks in a syscall, so an idle ring
                # still stamps liveness every backoff tick
                hb.beat(hb_name)
            backoff.wait()
        return None, False

    def _handle_frame(self, frame, sock, writer, state) -> None:
        tr = self._tracer
        if tr is not None and frame.trace_seq and frame.kind in (
                KIND_REQUEST, KIND_TRAJ, KIND_TRAJ_BATCH):
            # the gateway leg of the stitched round-trip: decode already
            # happened, this span is the reader-thread dispatch
            name = ("gateway/dispatch" if frame.kind == KIND_REQUEST
                    else "gateway/traj_ingest")
            with tr.trace_span(name, seq=frame.trace_seq):
                self._dispatch_frame(frame, sock, writer, state)
        else:
            self._dispatch_frame(frame, sock, writer, state)

    def _dispatch_frame(self, frame, sock, writer, state) -> None:
        if frame.kind == KIND_REQUEST:
            self._bump("request_frames")
            if frame.flags & FLAG_RLE:
                self._bump("rle_request_frames")
            if frame.flags & (FLAG_F16 | FLAG_Q8):
                self._bump("quant_request_frames")
            if frame.array.ndim < 1:
                # contain malformed requests to THIS connection: a 0-d obs
                # would blow up inside the server's batch loop and
                # _fatal() the whole plane for every peer
                raise CodecError(
                    "REQUEST obs must be lane-batched (ndim >= 1), "
                    f"got a {frame.array.ndim}-d array")
            self.server.submit_request(InferenceRequest(
                frame.actor_id, frame.array,
                _WireReply(self, state["reply_channel"], frame.request_id,
                           trace_seq=frame.trace_seq),
                trace_seq=frame.trace_seq))
        elif frame.kind == KIND_TRAJ:
            self._bump("traj_frames")
            if self.sink is not None:
                self.sink(frame.arrays)
        elif frame.kind == KIND_TRAJ_BATCH:
            self._bump("traj_batch_frames")
            self._bump("traj_frames", len(frame.traj_batch))
            if self.sink is not None:
                for arrays in frame.traj_batch:
                    self.sink(arrays)
        elif frame.kind == KIND_HELLO:
            # negotiate per connection: grant the intersection of the
            # client's offer, what this codec supports, and what this
            # gateway's deployment opted into
            self._bump("hello_frames")
            grant = SUPPORTED_CODECS
            if not self.onpolicy:
                grant &= ~CODEC_ONPOLICY
            if not (self.allow_shm and state["loopback"]):
                grant &= ~CODEC_SHM       # shm only for co-located peers
            writer.send(encode_hello(frame.codecs & grant))
        elif frame.kind == KIND_SHM:
            if not (self.allow_shm and state["loopback"]):
                raise CodecError("SHM attach without a CODEC_SHM grant")
            if state["c2s"] is not None:
                raise CodecError("duplicate SHM attach on one connection")
            c2s = ShmRing.attach(frame.shm["c2s"], frame.shm["slot_size"],
                                 frame.shm["num_slots"])
            try:
                s2c = ShmRing.attach(frame.shm["s2c"],
                                     frame.shm["slot_size"],
                                     frame.shm["num_slots"])
            except Exception:
                c2s.close()
                raise
            state["c2s"], state["s2c"] = c2s, s2c
            state["reply_channel"] = _ShmReplyChannel(s2c, writer, self)
            self._bump("shm_conns")
        else:
            raise CodecError(
                f"unexpected frame kind {frame.kind} on gateway")

    def _read_conn(self, sock):
        hb = self._health
        conn_n = next(self._conn_seq)
        hb_name = f"gateway/conn{conn_n}"
        # replies leave via this thread; the writer heartbeats on its own
        # 0.25 s poll, the reader's deadline stays informational (None)
        # because a TCP read legitimately blocks for as long as the peer
        # is quiet — only the shm poll path stamps continuously
        writer = _ConnWriter(
            sock, health=hb,
            name=(f"{hb_name}/writer" if hb is not None else None))
        if hb is not None:
            hb.register(hb_name, stale_after_s=None)
        try:
            peer = sock.getpeername()[0]
        except OSError:
            peer = ""
        state = {"c2s": None, "s2c": None, "reply_channel": writer,
                 "loopback": _is_loopback(peer),
                 "backoff": _SpinBackoff(),
                 "hb_name": hb_name if hb is not None else None}
        try:
            while not self._stop.is_set():
                if hb is not None:
                    hb.beat(hb_name)
                frame, via_shm = self._next_conn_frame(sock, state)
                if frame is None:
                    break
                if via_shm:
                    self._bump("shm_frames")
                self._handle_frame(frame, sock, writer, state)
        except (OSError, CodecError, ShmRingError):
            if not self._stop.is_set():
                self.error = traceback.format_exc()
                if self._flightrec is not None:
                    self._flightrec.trigger(
                        "gateway_sever",
                        f"conn{conn_n} reader died:\n{self.error}")
        finally:
            if hb is not None:
                hb.unregister(hb_name)
            writer.stop()
            sock.close()
            for ring in (state["c2s"], state["s2c"]):
                if ring is not None:
                    ring.close()         # client owns unlink
