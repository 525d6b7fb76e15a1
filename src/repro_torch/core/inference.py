"""Central inference server — SEED RL's core mechanism, now data-parallel.

A copy of ``repro.core.inference`` (pure Python and numpy): the port keeps
its own so that it imports nothing of the JAX package. `policy_step` must
return a host array; the torch policies copy their actions to numpy, which
also synchronises the device, so ``inference/compute_s`` times real work.

Actors do NOT run the policy network locally (IMPALA-style); they send
observations to this server, which batches them and runs one jitted
forward step on the accelerator, returning actions. Three SEED details are
first-class here:

  * **batching deadline** (straggler mitigation): a replica closes a batch
    when it is full OR when `deadline_ms` elapses, so one slow actor cannot
    stall the pipeline — the learner's analogue of the paper's observation
    that slow environment interaction starves the accelerator;
  * **lane flattening** (vectorized actors): each request carries a whole
    lane-batch `obs[E, ...]` from one actor; the server concatenates lanes
    across requests into a single policy forward, so the accelerator batch
    is `sum(E_i)` lanes, not "number of requests";
  * **recurrent state residency**: per-*lane* core state (LSTM / KV / SSM)
    stays on the server, keyed by `(actor_id, env_id)` slots, so actors
    exchange only (obs -> action) and lanes keep distinct recurrent state.

**Lane sharding** (`num_replicas > 1`): GA3C showed the single predictor
queue is the first structure to saturate; past that point the server runs
N data-parallel replica workers, each with its own request queue, batch
loop, and shard of the `max_batch` lane budget. Requests are routed by a
STABLE actor-id hash (`replica_for`), so every lane's `(actor_id, env_id)`
recurrent slot only ever appears on one replica — core state never
migrates. Slot ids stay globally dense (one shared table) so a single
`policy_step` state array serves all replicas; replicas touch disjoint
slot rows and may call `policy_step` concurrently. `num_replicas=1` is
bit-for-bit the historical single-loop server.

The queue API below (`submit_batch` -> reply `get`) is the transport seam.
The JAX package's `repro.transport` implements it twice (not ported yet):
`InProcTransport` (the in-process
default, identical to handing actors this server directly) and
`SocketTransport`/`InferenceGateway` (a wire-level TCP transport so actors
can live on remote CPU hosts — the paper's disaggregated provisioning; one
gateway per replica composes with the sharding here).
Replies are either an action array or a poison `ReplyError`: when the
server dies or stops, every pending request is drained with one so no
actor ever blocks forever on a reply that cannot come (fail-fast).
"""

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.telemetry.metrics import MetricsRegistry


@dataclass
class ReplyError:
    """Poison reply: the server (or transport) died or stopped before this
    request could be served. Actors treat it as a stop signal and surface
    `message` instead of deadlocking on an empty reply queue."""
    message: str


@dataclass
class InferenceRequest:
    actor_id: int
    obs: np.ndarray              # (E, ...) lane-batched observations
    reply: "queue.Queue"
    scalar: bool = False         # legacy single-obs submit: unwrap the reply
    trace_seq: int = 0           # telemetry stitch id (0 = untraced)
    t_enqueue: float = field(default_factory=time.perf_counter)

    @property
    def lanes(self) -> int:
        return self.obs.shape[0]


# "requests" counts LANES (the supply quantity the paper sweeps);
# "rpcs" counts request messages (the transport quantity).
_STAT_KEYS = ("batches", "requests", "rpcs",
              "batch_occupancy", "queue_wait_s", "compute_s")
_INT_KEYS = ("batches", "requests", "rpcs")


def _as_stats(raw: dict) -> dict:
    """Registry counters are floats; the historical dict shape keeps the
    event counts as ints."""
    return {k: int(v) if k in _INT_KEYS else v for k, v in raw.items()}


def _derive_stats(s: dict) -> dict:
    """Normalized views of the accumulated counters, so callers don't each
    need to know which raw sum divides by which count: occupancy as a
    fraction of the lane budget, queue wait per lane, and the batching
    ratios (lanes per forward / per RPC)."""
    return {
        "mean_batch_occupancy": s["batch_occupancy"] / max(s["batches"], 1),
        "mean_queue_wait_ms": 1e3 * s["queue_wait_s"] / max(s["requests"], 1),
        "mean_lanes_per_batch": s["requests"] / max(s["batches"], 1),
        "mean_lanes_per_rpc": s["requests"] / max(s["rpcs"], 1),
    }


class _Replica:
    """One data-parallel inference worker: its own request queue, batch
    loop thread, stats shard, and `lane_budget` share of the server's
    `max_batch`. Routing (`InferenceServer.replica_for`) guarantees a
    given actor's lanes only ever land here, so the slot rows this replica
    passes to `policy_step` are disjoint from every other replica's."""

    def __init__(self, server: "InferenceServer", replica_id: int,
                 lane_budget: int):
        self.server = server
        self.replica_id = replica_id
        self.lane_budget = lane_budget
        self.requests: "queue.Queue[InferenceRequest]" = queue.Queue()
        # registry-backed counters: one shared lock makes every stats
        # snapshot point-in-time atomic (the old plain-dict shard could be
        # read mid-batch-update by throughput())
        self._c = server.metrics.counters(f"inference/r{replica_id}",
                                          _STAT_KEYS)
        server.metrics.gauge(f"inference/r{replica_id}/queue_depth",
                             fn=self.requests.qsize)
        self._thread: Optional[threading.Thread] = None

    @property
    def stats(self) -> dict:
        """Atomic counter snapshot in the historical dict shape."""
        return _as_stats(self.server.metrics.read(self._c))

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"inference-replica-{self.replica_id}")
        self._thread.start()

    def join(self, timeout: float = 5.0):
        if self._thread:
            self._thread.join(timeout=timeout)

    def _loop(self):
        # record a fatal policy_step/shape error instead of dying silently:
        # actors wait on replies indefinitely, so a silent death here would
        # stall the whole system with no trace (same class as Learner.error)
        hb = self.server._health
        name = f"inference/replica{self.replica_id}"
        if hb is not None:
            # _collect polls at >= 20 Hz even idle, so a 1.5 s deadline
            # means a wedged policy_step flips /healthz well inside the
            # 2 s the ops plane promises
            hb.register(name, stale_after_s=1.5)
        try:
            self._serve()
        except Exception:
            self.server._fatal(traceback.format_exc())
        finally:
            if hb is not None:
                hb.unregister(name)

    def _serve(self):
        srv = self.server
        hb = srv._health
        hb_name = f"inference/replica{self.replica_id}"
        while not srv._stop.is_set():
            if hb is not None:
                hb.beat(hb_name)
            batch = self._collect()
            if not batch:
                continue
            t0 = time.perf_counter()
            try:
                obs = np.concatenate([r.obs for r in batch])  # (N_lanes, ...)
                ids = np.concatenate(
                    [srv.slot_ids(r.actor_id, r.lanes) for r in batch])
                actions = np.asarray(srv.policy_step(obs, ids))
            except Exception:
                # poison the IN-FLIGHT batch too, not just the queues: these
                # requests were already popped by _collect, and for wire
                # transports the poison is the only signal the remote actor
                # will ever receive (it cannot read this server's .error)
                err = traceback.format_exc()
                for r in batch:
                    r.reply.put(ReplyError(err))
                srv._fatal(err)
                return
            dt = time.perf_counter() - t0
            lanes = 0
            waits = []
            for r in batch:
                a = actions[lanes:lanes + r.lanes]
                lanes += r.lanes
                r.reply.put(a[0] if r.scalar else a)
                waits.append(t0 - r.t_enqueue)
            # ONE lock acquisition per batch: counters + histograms move
            # together, so no snapshot can see a batch counted without its
            # requests (or a wait histogram ahead of its rpc count)
            c = self._c
            with srv.metrics.lock:
                c["queue_wait_s"].value += sum(
                    w * r.lanes for w, r in zip(waits, batch))
                c["compute_s"].value += dt
                c["batches"].value += 1
                c["requests"].value += lanes
                c["rpcs"].value += len(batch)
                c["batch_occupancy"].value += min(lanes / self.lane_budget,
                                                  1.0)
                for w in waits:
                    srv._h_wait.record_locked(max(w, 0.0))
                srv._h_compute.record_locked(dt)
            tr = srv._tracer
            if tr is not None:
                t1_ns = time.perf_counter_ns()
                t0_ns = t1_ns - int(dt * 1e9)
                for w, r in zip(waits, batch):
                    if r.trace_seq:
                        # after-the-fact spans from the request's enqueue
                        # stamp: the batch wait, then the shared forward —
                        # both carry the request's stitch id
                        tr.record(f"replica{self.replica_id}/batch_wait",
                                  t0_ns - int(max(w, 0.0) * 1e9),
                                  int(max(w, 0.0) * 1e9), seq=r.trace_seq)
                        tr.record(f"replica{self.replica_id}/forward",
                                  t0_ns, t1_ns - t0_ns, seq=r.trace_seq,
                                  args={"lanes": lanes, "rpcs": len(batch)})

    def _collect(self):
        """Fill a batch until `lane_budget` LANES or the deadline —
        straggler cut. One request's lanes are never split across forwards
        (or replicas)."""
        batch = []
        try:
            batch.append(self.requests.get(timeout=0.05))
        except queue.Empty:
            return batch
        lanes = batch[0].lanes
        deadline = time.perf_counter() + self.server.deadline_ms / 1e3
        while lanes < self.lane_budget:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                r = self.requests.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(r)
            lanes += r.lanes
        return batch


class InferenceServer:
    """policy_step: (stacked_obs (N, ...), slot_ids (N,)) -> actions (N,).

    N is the total number of *lanes* flattened across the batched requests
    of ONE replica's forward. `slot_ids` are dense ints assigned per
    (actor_id, env_id) on first sight, globally unique across replicas;
    the callable owns all device state (params, per-slot recurrent state)
    and indexes it with them. With `num_replicas > 1` the callable may be
    invoked concurrently from several replica threads, always on disjoint
    slot sets (routing is sticky per actor).
    """

    def __init__(self, policy_step: Callable, max_batch: int,
                 deadline_ms: float = 10.0, num_replicas: int = 1,
                 telemetry=None):
        if not isinstance(num_replicas, int) or num_replicas < 1:
            raise ValueError(
                f"num_replicas must be a positive int, got {num_replicas!r}")
        if num_replicas > max_batch:
            raise ValueError(
                f"num_replicas={num_replicas} exceeds the max_batch="
                f"{max_batch} lane budget: each replica needs at least one "
                f"lane of batch budget (lower num_replicas or raise "
                f"inference_batch)")
        self.policy_step = policy_step
        self.max_batch = max_batch           # TOTAL lane budget per round
        self.deadline_ms = deadline_ms
        self.num_replicas = num_replicas
        # stats always live in a registry (private one when no telemetry is
        # attached) so snapshots are atomic either way; the tracer rides
        # along only when a Telemetry bundle asks for spans
        self.metrics = (telemetry.metrics if telemetry is not None
                        else MetricsRegistry())
        self._tracer = (telemetry.tracer
                        if telemetry is not None and telemetry.enabled
                        else None)
        self._h_wait = self.metrics.histogram("inference/batch_wait_s")
        self._h_compute = self.metrics.histogram("inference/compute_s")
        # ops plane (both None without a full Telemetry bundle): replica
        # loops stamp heartbeats; _fatal files a postmortem on the way down
        self._health = getattr(telemetry, "health", None)
        self._flightrec = getattr(telemetry, "flightrec", None)
        # each replica serves a shard of the lane budget; ceil so the
        # shards cover max_batch and N=1 keeps the budget bit-identical
        budget = -(-max_batch // num_replicas)
        self._replicas = [_Replica(self, k, budget)
                          for k in range(num_replicas)]
        # elastic activation: routing spreads actors over the first
        # `active_replicas` workers only; the rest stay started but idle
        # (their queues drain, then _collect just times out). The
        # autoscaler raises/lowers this within [1, num_replicas].
        self._active = num_replicas
        self.metrics.gauge("inference/active_replicas",
                           fn=lambda: self._active)
        self._stop = threading.Event()
        self._slots: Dict[Tuple[int, int], int] = {}   # (actor, lane) -> slot
        self._slot_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._slot_lock = threading.Lock()
        self.error: Optional[str] = None     # traceback of a fatal loop error

    # ------------------------------------------------------------- routing

    def replica_for(self, actor_id: int) -> int:
        """STABLE actor -> replica hash over the ACTIVE worker count: the
        whole point of sharding the dense slot table is that a lane's
        recurrent state is never touched by two replicas at once, so
        between resizes this must be a pure function of actor_id (not
        load, not time). Plain modulo also spreads the contiguous
        actor-id blocks that `ActorHostPool` assigns per host across all
        active replicas.

        A resize re-homes some actors to a different replica, which is
        safe under the system's one-in-flight-request-per-actor
        discipline: an actor's next request is only routed after its
        previous reply was delivered, so the old replica has finished
        with that actor's slot rows before the new one can see them —
        stickiness holds at every instant even though the mapping moves.
        """
        return actor_id % self._active

    @property
    def active_replicas(self) -> int:
        return self._active

    def set_active_replicas(self, n: int) -> int:
        """Activate/drain replica workers, clamped to [1, num_replicas]
        (capacity can only be toggled, never built: every worker thread,
        queue, and lane-budget shard was constructed up front). Draining
        is passive — routing stops sending to the tail workers and their
        queues empty naturally; no request is dropped or re-queued.
        Returns the resulting active count."""
        n = max(1, min(int(n), self.num_replicas))
        self._active = n
        return n

    # ------------------------------------------------------------ lifecycle

    def start(self):
        for rep in self._replicas:
            rep.start()

    def stop(self):
        self._stop.set()
        for rep in self._replicas:
            rep.join(timeout=5.0)
        self._drain_pending(self.error or "inference server stopped")

    def _fatal(self, err: str):
        """A replica died: record the first traceback, stop EVERY replica
        (a half-sharded server would silently serve a fraction of lanes),
        and poison all queues."""
        first = self.error is None
        if first:
            self.error = err
        self._stop.set()
        self._drain_pending(self.error)
        if first and self._flightrec is not None:
            # after the drain: the bundle's stacks/metrics show the system
            # as the poisoned actors will find it
            self._flightrec.trigger("server_fatal", err)

    def _drain_pending(self, message: str):
        """Fail-fast: poison every queued request on every replica so
        blocked actors wake up with a `ReplyError` instead of hanging on a
        reply that will never be produced."""
        for rep in self._replicas:
            while True:
                try:
                    r = rep.requests.get_nowait()
                except queue.Empty:
                    break
                r.reply.put(ReplyError(message))

    # -------------------------------------------------------------- submit

    def submit_request(self, r: InferenceRequest):
        """Transport-facing entry: enqueue a request whose `reply` is any
        object with `put(result)` — a `queue.Queue` for in-process actors,
        a wire-writing proxy for the gateway. Poisons immediately if the
        server is already stopped/dead (fail-fast)."""
        if self._stop.is_set():
            r.reply.put(ReplyError(self.error or "inference server stopped"))
            return r.reply
        self._replicas[self.replica_for(r.actor_id)].requests.put(r)
        if self._stop.is_set():
            # stop()/death may have drained between the check above and our
            # put — drain again so this request cannot strand unanswered
            # (each request is popped at most once, so no double replies)
            self._drain_pending(self.error or "inference server stopped")
        return r.reply

    def submit(self, actor_id: int, obs: np.ndarray) -> "queue.Queue":
        """Single-observation submit; the reply holds one action."""
        return self.submit_request(InferenceRequest(
            actor_id, np.asarray(obs)[None], queue.Queue(maxsize=1),
            scalar=True))

    def submit_batch(self, actor_id: int, obs: np.ndarray,
                     trace_seq: int = 0) -> "queue.Queue":
        """Lane-batched submit: obs is (E, ...); the reply holds (E,) actions."""
        return self.submit_request(InferenceRequest(
            actor_id, np.asarray(obs), queue.Queue(maxsize=1),
            trace_seq=trace_seq))

    # --------------------------------------------------------------- slots

    def slot_ids(self, actor_id: int, lanes: int) -> np.ndarray:
        """Dense per-(actor, lane) slots — recurrent-state indices. The
        mapping is immutable once assigned, so steady state is one dict
        hit. Globally dense across replicas: one policy-side state table
        serves all of them, and sticky routing keeps each row on exactly
        one replica."""
        cached = self._slot_cache.get((actor_id, lanes))
        if cached is not None:
            return cached
        with self._slot_lock:
            out = np.empty((lanes,), np.int32)
            for lane in range(lanes):
                key = (actor_id, lane)
                if key not in self._slots:
                    self._slots[key] = len(self._slots)
                out[lane] = self._slots[key]
            self._slot_cache[(actor_id, lanes)] = out
        return out

    @property
    def num_slots(self) -> int:
        return len(self._slots)

    # --------------------------------------------------------------- stats

    @property
    def stats(self) -> dict:
        """Aggregated raw counters, summed across replicas (the historical
        single-loop shape; with num_replicas=1 it IS replica 0's dict).
        One registry-lock acquisition covers every replica, so the sum is
        a point-in-time snapshot — no replica can count half a batch into
        it (the pre-registry dicts could)."""
        raws = self.metrics.read_groups([rep._c for rep in self._replicas])
        out = {k: 0.0 for k in _STAT_KEYS}
        for raw in raws:
            for k, v in raw.items():
                out[k] += v
        return _as_stats(out)

    def derived_stats(self) -> dict:
        """Aggregate derived means (see `_derive_stats`); the per-replica
        decomposition is `per_replica_stats()`. All ratios are zero-guarded:
        a server that served nothing reports 0.0 means, it never raises."""
        return _derive_stats(self.stats)

    def per_replica_stats(self) -> list:
        """Raw + derived stats per replica — the sharded decomposition
        `SeedSystem.throughput()` reports, so batch-fill starvation on one
        replica (occupancy collapsing as N grows) is visible per shard.
        All replicas are read under ONE lock acquisition: the rows are
        mutually consistent, so their sum is itself a valid aggregate
        snapshot (same guarantee `stats` gives)."""
        raws = self.metrics.read_groups([rep._c for rep in self._replicas])
        return [dict(_as_stats(raw), replica=rep.replica_id,
                     lane_budget=rep.lane_budget,
                     **_derive_stats(raw))
                for rep, raw in zip(self._replicas, raws)]
