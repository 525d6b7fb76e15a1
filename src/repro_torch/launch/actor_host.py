"""Actor hosts: OS processes of vectorized actors against remote gateways.

A copy of ``repro.launch.actor_host`` with its imports taken from the port
(`core.actor`, `transport.socket`, `fault.supervisor`, `telemetry`).

This is the paper's disaggregated provisioning made runnable: the learner
box keeps the `InferenceServer` + its `InferenceGateway`s, and env
interaction moves to K separate *processes* — stand-ins for K separate CPU
hosts. Each actor thread on a host dials its gateway with its own
`SyncSocketTransport` connection (SEED's per-actor streaming-RPC shape:
the reply is parsed in the submitting thread, no relay hop), so a host
with A actors holds A connections. On one machine this exercises the full
wire path over loopback; pointing the addresses at another box is the
same code.

With G > 1 gateway addresses (`SeedSystem(num_gateways=G)` — the
multi-gateway sharding that removes the single accept loop), hosts are
HASHED across them: host h dials ``addresses[h % G]``. The hash is stable
in host_id, so a host's actors — and therefore their (actor_id, env_id)
recurrent slots — always enter the server through the same gateway, and
trajectory frames ride that gateway's connections into the shared learner
sink.

Processes are spawned (never forked: torch holds threads at import time
and fork would deadlock them), so `env_factory` must be picklable — a
class like `ALESimEnv` or a module-level factory function or a
``functools.partial`` of one, not a lambda. A child steps its envs on the
host and opens no CUDA context: a batched torch env must be built for the
CPU (``functools.partial(CatchEnv, device="cpu")``); `TorchVectorEnv`
hands the actor numpy either way, which is what the codec frames. A child
that cannot build its env reports the error in its stats. Each
child warms its vector envs up before its measured window, runs for
`seconds`, then reports counters through a result queue. The parent
enforces a hard timeout: a wire-level deadlock kills the run with an error
instead of hanging the caller (or CI) forever.

Determinism note: actor ids are partitioned contiguously across hosts and
each `Actor` seeds its lanes from its id exactly as the in-process backend
does, so a socket run with the same (num_actors, envs_per_actor, seed) is
bit-identical to in-proc under a deterministic policy — the loopback
parity contract `tests/test_torch_transport.py` asserts.
"""

import multiprocessing as mp
import queue as _queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

from repro_torch.fault.supervisor import RestartBudget


@dataclass
class ActorHostConfig:
    """Everything one child process needs; must pickle under spawn."""
    address: Tuple[str, int]     # this host's gateway (already hashed)
    host_id: int
    actor_ids: Tuple[int, ...]
    env_factory: Any
    envs_per_actor: int
    unroll: int
    seconds: float
    seed: Optional[int] = None
    connect_timeout_s: float = 15.0
    compress: bool = False       # negotiate RLE for uint8 obs payloads
    onpolicy: bool = False       # negotiate CODEC_ONPOLICY: actors decode
    #                              (E, 2) [action, logprob] replies and
    #                              stamp unrolls with the REPLY-borne
    #                              behavior-param version
    telemetry: bool = False      # build a child-process Telemetry: spans
    #                              stamped with wire trace_seq ids + a
    #                              metrics registry, both shipped back
    #                              through the result queue for the parent
    #                              to absorb (a Telemetry OBJECT cannot
    #                              cross spawn — it holds locks/threads —
    #                              so the flag travels, not the instance)
    use_shm: bool = False        # dial with ShmTransport: co-located hosts
    #                              negotiate CODEC_SHM and ride a
    #                              shared-memory ring pair, TCP as spill
    quant: Optional[str] = None  # negotiate CODEC_QUANT: 'f16' or 'q8'
    #                              float32 obs framing (lossy; leave None
    #                              for bit-parity with in-proc)
    coalesce: bool = True        # negotiate CODEC_TRAJBATCH: one frame
    #                              per unroll flush instead of per record
    heartbeat: bool = False      # piggyback liveness on the result queue:
    #                              a daemon thread puts
    #                              {"__heartbeat__": host_id} every 0.5 s
    #                              and the parent relays each beat into its
    #                              HeartbeatRegistry, so the watchdog
    #                              covers child PROCESSES over the same
    #                              protocol the final stats already ride
    #                              (no extra pipe to leak across spawn)
    epoch: int = 0               # incarnation counter: bumped on every
    #                              supervised respawn; every frame this
    #                              child puts on the result queue carries
    #                              it, so the parent rejects stale frames
    #                              from a dead incarnation (the wire side
    #                              needs no epoch — TCP replies die with
    #                              the connection)
    addresses: Optional[Tuple[Tuple[str, int], ...]] = None
    #                              full gateway list for failover re-hash
    #                              (None: no failover, fail-fast)
    reconnect: Any = None        # fault.BackoffPolicy (picklable) or
    #                              None = historical fail-fast wire
    shm_geometry: Optional[Tuple[int, int]] = None
    #                              (slot_size, num_slots) of each shm ring;
    #                              None = the module defaults (1 MiB x 64)
    stop_event: Any = None       # mp.Event (spawn-inheritable): graceful
    #                              drain — when set, the child leaves its
    #                              measured window early, stops its actors
    #                              cleanly (in-flight unroll flushed or
    #                              discarded BEFORE the ledger, so frame
    #                              conservation is exact by construction),
    #                              and reports final stats like a normal
    #                              window end


def run_actor_host(cfg: ActorHostConfig, result_q) -> None:
    """Child entry point: dial the gateway, drive actors, report stats."""
    stats = {"host_id": cfg.host_id, "elapsed_s": 0.0, "iterations": 0,
             "frames": 0, "episodes": 0, "returns": [], "error": None,
             "unrolls": 0, "param_lag_total": 0, "epoch": cfg.epoch}
    hb_stop = None
    window = {}                  # the measured window's end, once it starts
    if cfg.heartbeat:
        # beat from birth: the slow phases (torch import, env build, env
        # reset) are exactly when the parent most wants proof of life
        hb_stop = threading.Event()

        def _beat_loop():
            while not hb_stop.wait(0.5):
                try:
                    result_q.put({"__heartbeat__": cfg.host_id,
                                  "__epoch__": cfg.epoch, **window})
                except Exception:
                    return       # queue torn down: parent is gone anyway

        threading.Thread(target=_beat_loop, daemon=True).start()
    try:
        import sys

        import numpy as np

        from repro_torch.core.actor import Actor
        from repro_torch.transport.socket import (ShmTransport,
                                                  SyncSocketTransport)

        # compute-bound sibling actors convoy thread wakeups under
        # CPython's default 5 ms GIL slice; this process exists only to
        # run actors, so a finer slice is safe and worth real latency.
        sys.setswitchinterval(1e-3)
        # SEED's per-actor streaming-RPC shape: one connection per actor,
        # replies parsed in the actor thread itself (no recv-thread hop).
        # use_shm upgrades each connection to a shared-memory ring pair
        # when the gateway grants CODEC_SHM (loopback peers only; a remote
        # gateway just leaves these as plain TCP connections).
        transport_cls = ShmTransport if cfg.use_shm else SyncSocketTransport
        tel = None
        if cfg.telemetry:
            from repro_torch.telemetry import Telemetry
            # per-child Telemetry: same CLOCK_MONOTONIC timeline and
            # pid-salted trace_seq space as the parent, so the parent can
            # merge spans verbatim after absorbing them from the result q;
            # it holds no tensor and opens no CUDA context
            tel = Telemetry(process_name=f"actor-host-{cfg.host_id}")
        geometry = {}
        if cfg.use_shm and cfg.shm_geometry is not None:
            geometry = {"slot_size": cfg.shm_geometry[0],
                        "num_slots": cfg.shm_geometry[1]}
        transports = [
            transport_cls.connect(cfg.address,
                                  timeout_s=cfg.connect_timeout_s,
                                  compress=cfg.compress,
                                  onpolicy=cfg.onpolicy,
                                  quant=cfg.quant,
                                  coalesce=cfg.coalesce,
                                  telemetry=tel,
                                  reconnect=cfg.reconnect,
                                  failover_addresses=(
                                      list(cfg.addresses)
                                      if cfg.addresses else None),
                                  host_id=cfg.host_id, **geometry)
            for _ in cfg.actor_ids]
        if cfg.onpolicy:
            # on-policy data is useless without logprobs + version stamps,
            # so REQUIRE the grant before the first frame crosses the wire
            # (the grant also closes the negotiation window: no unroll is
            # ever sent stripped)
            for tr in transports:
                if not tr.wait_hello(cfg.connect_timeout_s) \
                        or not tr.onpolicy_granted:
                    raise RuntimeError(
                        "gateway did not grant CODEC_ONPOLICY "
                        f"(error={tr.error}); on-policy actor hosts need "
                        "an on-policy gateway")
        actors = [
            Actor(aid, cfg.env_factory, tr, tr.send_trajectory,
                  cfg.unroll, num_envs=cfg.envs_per_actor,
                  seed=None if cfg.seed is None else cfg.seed + aid,
                  version_source=(lambda tr=tr: tr.param_version),
                  with_logprobs=cfg.onpolicy, stamp_records=cfg.onpolicy,
                  telemetry=tel)
            for aid, tr in zip(cfg.actor_ids, transports)]
        # pay the envs' first reset and step before the measured window,
        # exactly as `SeedSystem.warmup` does for in-process actors: the
        # port's envs draw from their generators in reset and step
        # (TorchVectorEnv, ALESimEnv), so the same warm-up keeps a wire
        # run's rollouts bit-identical to a warmed in-process run's
        for a in actors:
            a.vec.reset()
            a.vec.step(np.zeros(a.num_envs, np.int32))
        t0 = time.perf_counter()
        # beats carry the window's end from now on (perf_counter is the
        # machine's CLOCK_MONOTONIC, shared with the parent): the pool's
        # respawns and grows serve the hosts' windows, not its own
        window["__window_end__"] = t0 + cfg.seconds
        for a in actors:
            a.start()
        deadline = t0 + cfg.seconds
        while time.perf_counter() < deadline:
            # exit the window early once the run is dead: a wire failure
            # sets transport.error, but a server-stop poison reply only
            # sets actor.error (the actor thread then exits) — wait on
            # neither for the full measured window
            if any(tr.error is not None for tr in transports):
                break
            if all(not a._thread.is_alive() for a in actors):
                break
            if cfg.stop_event is not None and cfg.stop_event.is_set():
                stats["drained"] = True      # autoscaler shrink: leave the
                break                        # window early but exit CLEANLY
            time.sleep(0.02)
        for a in actors:
            a.stop()
        for a in actors:
            a.join(timeout=5.0)
        stats["elapsed_s"] = time.perf_counter() - t0
        for tr in transports:
            tr.close()
        stats["iterations"] = sum(a.iterations for a in actors)
        stats["frames"] = sum(a.frames for a in actors)
        stats["episodes"] = sum(a.episodes for a in actors)
        stats["unrolls"] = sum(a.unrolls for a in actors)
        stats["param_lag_total"] = sum(a.param_lag_total for a in actors)
        stats["shm_frames"] = sum(
            getattr(tr, "shm_frames", 0) for tr in transports)
        stats["spill_frames"] = sum(
            getattr(tr, "spill_frames", 0) for tr in transports)
        stats["reconnects"] = sum(
            getattr(tr, "reconnects", 0) for tr in transports)
        stats["gateway_failovers"] = sum(
            getattr(tr, "gateway_failovers", 0) for tr in transports)
        stats["returns"] = [r for a in actors for r in a.returns[-20:]]
        stats["error"] = next(
            (tr.error for tr in transports if tr.error), None) or next(
            (a.error for a in actors if a.error), None)
        # the child steps its envs on the host: a CUDA context here would
        # be one more on the card per actor host
        torch = sys.modules.get("torch")
        stats["cuda_initialized"] = bool(torch is not None
                                         and torch.cuda.is_initialized())
        if tel is not None:
            # mirror the shm transports' plain-int hot-path counters into
            # the registry once, at report time (they are single-threaded
            # ints precisely so the ring path stays lock-free)
            c = tel.metrics.counters(
                "host_wire", ("shm_frames", "shm_replies", "spill_frames"))
            with tel.metrics.lock:
                for k, cnt in c.items():
                    cnt.value += float(
                        sum(getattr(tr, k, 0) for tr in transports))
            stats["trace_events"] = tel.tracer.export_events()
            stats["metrics_snapshot"] = tel.metrics.snapshot()
    except Exception:
        stats["error"] = traceback.format_exc()
    if hb_stop is not None:
        hb_stop.set()            # stats is the LAST frame this child sends
    result_q.put(stats)


class ActorHostPool:
    """Spawn K actor-host processes and collect their run stats.

    The pool partitions `num_actors` contiguously across `num_hosts` (host
    h gets ids [h*per, ...)); globally-unique actor ids keep the gateway's
    (actor_id, env_id) recurrent-slot mapping collision-free across hosts.

    With ``supervise=True`` the pool is also the actor plane's SUPERVISOR:
    a host that dies (exit without reporting) or goes silent (missed
    ``__heartbeat__`` frames past ``host_stall_s``) is killed for certain,
    reported through ``fault_callback`` (the SeedSystem seam that files the
    postmortem, degrades /healthz, and moves the dead incarnation's pending
    frames to the fault-drop ledger), and respawned with the SAME host_id
    and actor_ids under a `RestartBudget`. Same ids means the replacement
    re-adopts the exact (actor_id, env_id) slot rows the dead host owned —
    the server's slot table stays dense and sticky across the crash. Each
    incarnation carries an ``epoch``; result-queue frames from a dead
    epoch (late stats, buffered beats) are rejected, never recorded.
    """

    def __init__(self, env_factory, num_actors: int, envs_per_actor: int,
                 unroll: int, num_hosts: int = 1,
                 seed: Optional[int] = None, grace_s: float = 90.0,
                 compress: bool = False, onpolicy: bool = False,
                 use_shm: bool = False, quant: Optional[str] = None,
                 coalesce: bool = True, telemetry: bool = False,
                 pid_callback=None, heartbeat_callback=None,
                 heartbeat_close=None, failure_callback=None,
                 supervise: bool = False, max_host_restarts: int = 3,
                 host_stall_s: float = 5.0,
                 min_respawn_window_s: float = 0.25,
                 reconnect=None, fault_callback=None,
                 elastic: bool = False,
                 shm_geometry: Optional[Tuple[int, int]] = None):
        if not 1 <= num_hosts <= num_actors:
            raise ValueError(
                f"num_hosts={num_hosts} must be in [1, num_actors={num_actors}]")
        self.env_factory = env_factory
        self.num_actors = num_actors
        self.envs_per_actor = envs_per_actor
        self.unroll = unroll
        self.num_hosts = num_hosts
        self.seed = seed
        self.grace_s = grace_s       # spawn + torch import + env headroom
        self.compress = compress
        self.onpolicy = onpolicy
        self.use_shm = use_shm
        self.quant = quant
        self.coalesce = coalesce
        # (slot_size, num_slots) of every shm ring; each connection maps
        # two rings, so a small /dev/shm needs a smaller geometry than the
        # defaults' 2 x 64 MiB (tmpfs faults past its size with SIGBUS)
        self.shm_geometry = shm_geometry
        self.telemetry = telemetry
        # pid_callback(name, pid) fires right after each spawn — the seam
        # `Telemetry.watch_process` plugs into so the parent's utilization
        # sampler reads the children's /proc/<pid>/stat from birth (and a
        # caller can check the children's CUDA contexts)
        self.pid_callback = pid_callback
        # heartbeat_callback(name) relays each child's piggybacked beat
        # (HeartbeatRegistry.beat: auto-registers under the default
        # watched deadline); heartbeat_close(name) runs once per host when
        # run() finishes so completed children don't read as stalled
        # forever after; failure_callback(msg) fires on the hard-timeout
        # path right before the RuntimeError (the flight recorder's seam)
        self.heartbeat_callback = heartbeat_callback
        self.heartbeat_close = heartbeat_close
        self.failure_callback = failure_callback
        # --- supervision (all opt-in: supervise=False is the historical
        # fail-fast pool, byte-identical collect loop semantics) ---------
        self.supervise = supervise
        self.max_host_restarts = max_host_restarts
        self.host_stall_s = host_stall_s
        self.min_respawn_window_s = min_respawn_window_s
        self.reconnect = reconnect   # BackoffPolicy for child transports
        # fault_callback(host_id, reason) fires ONCE per detected death,
        # BEFORE the respawn — the parent-side ledger/health/postmortem
        # seam (exceptions swallowed: supervision must not die of its
        # own observer)
        self.fault_callback = fault_callback
        # recovery counters (cumulative over the pool's lifetime; surfaced
        # via SeedSystem.throughput()["recovery"] and /varz)
        self.host_restarts = 0
        self.stale_frames_rejected = 0
        self.fault_log: List[str] = []
        self._hosts: dict = {}       # host_id -> incarnation record
        self._all_procs: List[Any] = []
        self.last_stats: List[dict] = []
        # --- elasticity (the autoscaler's actor-plane actuator) ----------
        # request_grow/request_drain enqueue commands that ONLY the collect
        # loop executes (self._hosts is single-threaded by design; the
        # controller thread never touches it). `elastic=True` also caps the
        # idle poll at 0.25 s so commands execute promptly without
        # supervision. hw_actors is the HIGH-WATER actor-id mark — it only
        # grows, because the server's (actor_id, env_id) slot table never
        # shrinks and the slot auditor's budget must cover every id ever
        # issued; num_actors stays the constructed base partition.
        self.elastic = elastic
        self.hw_actors = num_actors
        self.hosts_grown = 0
        self.hosts_drained = 0
        self._commands: "_queue.Queue" = _queue.Queue()
        self._running = False
        self._expected = num_hosts   # hosts whose final stats run() awaits
        self._next_host_id = num_hosts
        self._grow_log: List[str] = []

    def _partitions(self) -> List[Tuple[int, ...]]:
        ids = list(range(self.num_actors))
        base, extra = divmod(self.num_actors, self.num_hosts)
        parts, at = [], 0
        for h in range(self.num_hosts):
            n = base + (1 if h < extra else 0)
            parts.append(tuple(ids[at:at + n]))
            at += n
        return parts

    @staticmethod
    def _normalize_addresses(address) -> List[Tuple[str, int]]:
        """Accept one gateway address ``(host, port)`` or a list of them
        (multi-gateway sharding)."""
        if len(address) and isinstance(address[0], str):
            return [tuple(address)]
        addrs = [tuple(a) for a in address]
        if not addrs:
            raise ValueError("need at least one gateway address")
        return addrs

    def _spawn(self, host_id: int, actor_ids: Tuple[int, ...],
               addresses: List[Tuple[str, int]], seconds: float,
               epoch: int, result_q, ctx) -> None:
        # an mp.Event is spawn-inheritable through Process args, so every
        # incarnation carries a drain flag even if elasticity never fires
        stop_event = ctx.Event() if self.elastic else None
        cfg = ActorHostConfig(
            address=addresses[host_id % len(addresses)], host_id=host_id,
            actor_ids=tuple(actor_ids), env_factory=self.env_factory,
            envs_per_actor=self.envs_per_actor, unroll=self.unroll,
            seconds=seconds, seed=self.seed, compress=self.compress,
            onpolicy=self.onpolicy, use_shm=self.use_shm,
            quant=self.quant, coalesce=self.coalesce,
            telemetry=self.telemetry,
            heartbeat=(self.heartbeat_callback is not None
                       or self.supervise),
            epoch=epoch,
            addresses=(tuple(addresses)
                       if self.reconnect is not None else None),
            reconnect=self.reconnect, shm_geometry=self.shm_geometry,
            stop_event=stop_event)
        p = ctx.Process(target=run_actor_host, args=(cfg, result_q),
                        daemon=True)
        p.start()
        if self.pid_callback is not None:
            self.pid_callback(f"actor-host-{host_id}", p.pid)
        self._hosts[host_id] = {
            "proc": p, "epoch": epoch, "actor_ids": tuple(actor_ids),
            "last_beat": time.perf_counter(), "beaten": False,
            "reported": False, "draining": False, "stop_event": stop_event}
        self._all_procs.append(p)

    # ---------------------------------------------------------- elasticity

    def live_hosts(self) -> int:
        """Hosts currently producing frames (spawned, not reported, not
        draining). Before/after a run the constructed count is reported so
        the autoscaler's bounds checks stay meaningful."""
        if not self._running:
            return self.num_hosts
        return sum(1 for st in self._hosts.values()
                   if not st["reported"] and not st["draining"])

    def request_grow(self) -> bool:
        """Ask the collect loop to spawn one more actor host mid-window
        (thread-safe; executes within one poll tick). The new host gets
        the next host_id — `host_id % G` hashes it onto a live gateway,
        which accepts connections continuously — and a FRESH contiguous
        actor-id block above `hw_actors`, so its (actor_id, env_id)
        recurrent slots are new rows in the server's dense table, never a
        collision with an existing host's. Returns False when no window
        is running or the pool was not built elastic."""
        if not (self.elastic and self._running):
            return False
        self._commands.put("grow")
        return True

    def request_drain(self) -> bool:
        """Ask the collect loop to gracefully drain the newest live host:
        its stop_event is set, the child leaves its window early, stops
        actors cleanly and reports final stats like a normal window end —
        frames stay exactly conserved because partial unrolls never enter
        the ledger. LIFO (highest host_id first) keeps the constructed
        base partition intact."""
        if not (self.elastic and self._running):
            return False
        self._commands.put("drain")
        return True

    def _execute_commands(self, addresses, window_end, result_q, ctx,
                          now) -> None:
        """Drain the command queue inside the collect loop — the ONLY
        place `self._hosts` is ever mutated, so grow/drain need no lock
        against `_scan` or the heartbeat relay."""
        while True:
            try:
                cmd = self._commands.get_nowait()
            except _queue.Empty:
                return
            if cmd == "grow":
                remaining = window_end - now
                if remaining < self.min_respawn_window_s:
                    self._grow_log.append(
                        f"grow skipped: {remaining:.2f}s left in window")
                    continue
                host_id = self._next_host_id
                self._next_host_id += 1
                per = max(len(p) for p in self._partitions())
                actor_ids = tuple(range(self.hw_actors,
                                        self.hw_actors + per))
                self.hw_actors += per
                self._expected += 1
                self._spawn(host_id, actor_ids, addresses, remaining, 0,
                            result_q, ctx)
                self.hosts_grown += 1
                self._grow_log.append(
                    f"grew actor-host-{host_id} (actors {actor_ids[0]}.."
                    f"{actor_ids[-1]}, {remaining:.1f}s left)")
            elif cmd == "drain":
                live = [h for h, st in self._hosts.items()
                        if not st["reported"] and not st["draining"]
                        and st["stop_event"] is not None]
                if len(live) <= 1:
                    self._grow_log.append(
                        "drain skipped: would leave no live host")
                    continue
                h = max(live)
                st = self._hosts[h]
                st["draining"] = True
                st["stop_event"].set()
                self.hosts_drained += 1
                self._grow_log.append(f"draining actor-host-{h}")

    def kill_host(self, host_id: int) -> bool:
        """Chaos hook: SIGKILL the live incarnation of `host_id` (no
        cleanup, no final stats — the worst-case death the supervisor
        must absorb). Returns False when the host isn't currently up."""
        st = self._hosts.get(host_id)
        if st is None or not st["proc"].is_alive():
            return False
        st["proc"].kill()
        return True

    def _scan(self, results, addresses, window_end, result_q, ctx,
              budget, now) -> None:
        """One supervision sweep: detect dead/silent hosts, respawn."""
        for h, st in list(self._hosts.items()):
            if st["reported"] or st["draining"]:
                # a draining host exits on purpose; seeing its (still
                # queued) final stats as a death would respawn the host
                # the autoscaler just removed
                continue
            dead = not st["proc"].is_alive()
            # a child can beat only once its bootstrap is over (interpreter
            # start, re-import of the parent's main module, unpickling its
            # config, which imports torch through the env factory): until
            # its first beat it is starting, not silent, and gets the
            # pool's startup headroom (the reference counts host_stall_s
            # from the spawn, which a slow torch import outlasts)
            limit = self.host_stall_s if st["beaten"] \
                else max(self.grace_s, self.host_stall_s)
            stalled = not dead and now - st["last_beat"] > limit
            if not (dead or stalled):
                continue
            reason = (
                f"actor-host-{h} (epoch {st['epoch']}) died without "
                f"reporting (exitcode={st['proc'].exitcode})" if dead else
                f"actor-host-{h} (epoch {st['epoch']}) missed heartbeats "
                f"for {now - st['last_beat']:.1f}s > {limit}s")
            self.fault_log.append(reason)
            if self.fault_callback is not None:
                try:
                    self.fault_callback(h, reason)
                except Exception:
                    pass
            # a silent-but-alive incarnation must be GONE before its
            # replacement re-adopts the slot rows (two incarnations of one
            # actor_id would interleave frames on the learner side)
            try:
                st["proc"].kill()
            except Exception:
                pass
            remaining = window_end - now
            tombstone = {
                "host_id": h, "elapsed_s": 0.0, "iterations": 0,
                "frames": 0, "episodes": 0, "returns": [], "error": None,
                "unrolls": 0, "param_lag_total": 0, "epoch": st["epoch"],
                "fault": reason}
            if remaining < self.min_respawn_window_s:
                # window is over: record a tombstone so run() completes
                # with a dense per-host stats list (zero counters, the
                # fault noted; NOT an error — the death was absorbed)
                st["reported"] = True
                results[h] = tombstone
            elif budget.spend(now=now):
                self.host_restarts += 1
                self._spawn(h, st["actor_ids"], addresses, remaining,
                            st["epoch"] + 1, result_q, ctx)
            else:
                st["reported"] = True
                tombstone["error"] = (f"{reason}; restart budget exhausted "
                                      f"({budget.spent} restarts within "
                                      f"window)")
                results[h] = tombstone

    def _note_beat(self, r: dict, now: float, window_end: float) -> float:
        """One child's beat: a dead epoch's is counted and dropped, a live
        one stamps its host and is relayed. Returns the window the pool's
        respawns and grows serve. Each host measures its window from the
        end of its bootstrap and warm-up and its beats carry that window's
        end once it starts, so the window runs to the latest of the
        constructed hosts' first incarnations' (the reference counts it
        from the spawn, which a slow torch import leaves little of). A
        replacement's or a grown host's window starts later and does not
        move it, or each grow would lengthen the run."""
        h = r["__heartbeat__"]
        st = self._hosts.get(h)
        if st is not None and r.get("__epoch__", 0) < st["epoch"]:
            self.stale_frames_rejected += 1           # dead epoch
            return window_end
        if st is not None:
            st["last_beat"] = now
            st["beaten"] = True
        if self.heartbeat_callback is not None:
            self.heartbeat_callback(f"actor-host-{h}")
        if h >= self.num_hosts or r.get("__epoch__", 0) > 0:
            return window_end
        return max(window_end, r.get("__window_end__", window_end))

    def run(self, address, seconds: float) -> List[dict]:
        """Block until every host reports (or the hard timeout trips).

        `address` is one gateway ``(host, port)`` or a list of them; hosts
        hash across the list with the stable ``host_id % G`` map (see
        module docstring). mp start method is ALWAYS "spawn" — torch holds
        threads at import time, so fork would deadlock the children.

        With ``supervise=True`` the collect loop doubles as the
        supervision loop: idle queue ticks run a death scan (see `_scan`),
        and result-queue frames are epoch-checked so a dead incarnation's
        late frames never reach the stats or the heartbeat registry.
        """
        addresses = self._normalize_addresses(address)
        ctx = mp.get_context("spawn")
        result_q = ctx.Queue()
        self._hosts = {}
        self._all_procs = []
        self._commands = _queue.Queue()      # no stale commands carry over
        self._expected = self.num_hosts
        self._next_host_id = self.num_hosts
        t0 = time.perf_counter()
        window_end = t0 + seconds
        budget = RestartBudget(self.max_host_restarts,
                               window_s=max(seconds + self.grace_s, 60.0))
        for host_id, actor_ids in enumerate(self._partitions()):
            self._spawn(host_id, actor_ids, addresses, seconds, 0,
                        result_q, ctx)
        deadline = window_end + self.grace_s
        results: dict = {}           # host_id -> final stats (one epoch)
        self._running = True
        try:
            # heartbeats interleave with final stats on the ONE queue, so
            # collect by count, not by iteration: a {"__heartbeat__": h}
            # frame is relayed and skipped. The deadline is re-checked
            # explicitly — a child whose actors wedged keeps beating, and
            # those beats must not let it dodge the hard timeout.
            # `_expected` is re-read every iteration: an autoscale grow
            # adds a host (and its final stats) to this window on the fly.
            while len(results) < self._expected:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self._timed_out(list(results.values()), seconds)
                # supervision AND elasticity both need prompt idle ticks
                # (death scans / command execution within 0.25 s)
                poll = min(max(remaining, 0.1), 0.25) \
                    if (self.supervise or self.elastic) \
                    else max(remaining, 0.1)
                try:
                    r = result_q.get(timeout=poll)
                except _queue.Empty:
                    r = None
                    if not (self.supervise or self.elastic):
                        self._timed_out(list(results.values()), seconds)
                now = time.perf_counter()
                if isinstance(r, dict) and "__heartbeat__" in r:
                    window_end = self._note_beat(r, now, window_end)
                elif r is not None:
                    h = r.get("host_id")
                    st = self._hosts.get(h)
                    if st is not None and r.get("epoch", 0) < st["epoch"]:
                        self.stale_frames_rejected += 1   # late stats from
                        #                                   a dead epoch
                    else:
                        if st is not None:
                            st["reported"] = True
                        if self.heartbeat_close is not None:
                            # final stats are the child's LAST frame — drop
                            # its heartbeat now so a drained host doesn't
                            # read as stalled for the rest of the window
                            self.heartbeat_close(f"actor-host-{h}")
                        results[h] = r
                if self.supervise:
                    self._scan(results, addresses, window_end, result_q,
                               ctx, budget, now)
                if self.elastic:
                    self._execute_commands(addresses, window_end, result_q,
                                           ctx, now)
        finally:
            self._running = False
            if self.heartbeat_close is not None:
                # completed (or killed) children stop beating; drop their
                # registry entries so they don't read as stalled forever
                for host_id in self._hosts:
                    self.heartbeat_close(f"actor-host-{host_id}")
            for p in self._all_procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
        self.last_stats = sorted(results.values(),
                                 key=lambda s: s["host_id"])
        return self.last_stats

    def _timed_out(self, results, seconds):
        msg = (
            f"actor host timed out after {seconds + self.grace_s:.0f}s "
            f"({len(results)}/{self._expected} reported) — wire-level "
            f"deadlock or crash; partial stats: {results}")
        if self.failure_callback is not None:
            try:
                self.failure_callback(msg)   # postmortem BEFORE the raise:
            except Exception:                # the bundle must exist even if
                pass                         # the caller swallows the error
        raise RuntimeError(msg)
