"""End-to-end SEED system wiring: N actors x E env lanes + central
inference + learner.

This is the measured system behind the Fig-3 reproduction: construct with
`num_actors` (CPU threads) and `envs_per_actor` (lanes per thread — the
CuLE-style batching axis) and run; `throughput()` reports env-frames/s
(= actor iterations x E), inference batch occupancy, and learner steps/s —
the quantities the paper sweeps.

Mirrors ``repro.core.system`` for what the port has so far, with
checkpointing through `repro_torch.checkpoint.CheckpointManager`. Two
backends:
  * `backend="host"`: actor threads step host or batched torch envs and
    query the central `InferenceServer` once per vector step
    (`policy_step` is a host callable `(obs, slot_ids) -> actions`), with
    `num_replicas` data-parallel policy workers behind sticky
    actor->replica routing (see `core.inference`);
  * `backend="device"`: `RolloutWorker` threads drive
    `repro_torch.rollout` engines, env step and policy forward
    (`policy_apply`) fused into one T-step unroll on the env's device (one
    CUDA graph replay and one copy back per unroll on the card), with
    `engine_shards` engines a worker. No inference server: the workers
    read the learner's params from the publish seam, which hands them a
    snapshot (the port's train steps update params in place).
Both algorithms:
  * `algo="r2d2"` (default): unrolls land in `PrioritizedReplay` and the
    learner trains recurrent Q-learning;
  * `algo="vtrace"`: unrolls land in a bounded staleness-aware
    `repro_torch.onpolicy.TrajectoryQueue` (every unroll stamped with the
    behavior-param version; lag > `max_param_lag` is dropped and counted),
    actors decode `(E, 2) [action, logprob]` replies
    (`onpolicy.SamplingPolicy`) or the device unroll records the behavior
    logprobs, and the learner trains V-trace over `(B, T)` batches.
    `throughput()["onpolicy"]` reports the conserved frame ledger
    (generated = trained + dropped after `run()`).

The host backend picks a transport (`repro_torch.transport`):
  * `transport="inproc"` (default): actor threads in this process, queue
    round-trips;
  * `transport="socket"`: actors move to `num_actor_hosts` spawned OS
    processes (`launch.actor_host`, stand-ins for remote CPU hosts) that
    dial `num_gateways` TCP `InferenceGateway`s in front of the same
    `InferenceServer`; unrolls return over the wire into the same sink.
    The children step their envs on the host and open no CUDA context, so
    `env_factory` must be picklable and build its envs for the CPU (a
    class, a module-level factory or a ``functools.partial``, such as
    ``partial(CatchEnv, device="cpu")``; not a lambda);
  * `transport="shm"`: the same layout, each connection upgraded to a
    shared-memory ring pair (`transport.shm`) with TCP kept for spill and
    liveness; bit-identical to "socket" when `wire_quant` is None.
The learner, the inference server and the policy stay in this process, on
the card.

The constructor takes the reference's arguments and validates them with
its messages. `throughput()` keeps the reference's keys for each layout.

The ops and survival planes, all opt-in:
  * `telemetry=` (a `repro_torch.telemetry.Telemetry`): spans, the
    metrics registry, the utilization sampler, and
    `throughput()["bottleneck"]`, the measured CPU/GPU-ratio attribution;
    wire actor hosts build their own bundle and ship it home;
  * `ops_port=` (0 = ephemeral): the live HTTP plane (`/metrics`,
    `/healthz`, `/varz`, ...), the heartbeat watchdog and the continuous
    invariant auditor (frame ledger, slot table); builds a default
    `Telemetry` when none is given;
  * `autoscale=` (a `repro_torch.autoscale.AutoscaleConfig`, host backend):
    the closed-loop controller that grows and drains actor hosts
    (`ActorHostPool(elastic=True)`) and inference replicas.
"""

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.autoscale import AutoscaleConfig, AutoscaleController
from repro_torch.core.actor import Actor
from repro_torch.core.inference import InferenceServer
from repro_torch.core.learner import BatchSourceClosed, Learner
from repro_torch.core.replay import PrioritizedReplay
from repro_torch.onpolicy import TrajectoryQueue, VTraceBatcher
from repro_torch.rollout import DeviceRolloutEngine, RolloutWorker, ShardedRolloutEngine
from repro_torch.telemetry import Telemetry
from repro_torch.telemetry.slo import SLO, SLOSet

# /varz document schema (bumped when top-level keys change so external
# scrapers can dispatch): 2 = schema_version/uptime_s + always-present
# onpolicy/recovery stats keys + optional autoscale block
VARZ_SCHEMA_VERSION = 2

# the frame ledger's stable key set: `throughput()["onpolicy"]` carries
# exactly these keys on EVERY run — zero-valued when the vtrace queue is
# off — so time-series collectors never see ledger keys appear mid-run
ZERO_LEDGER = {
    "frames_generated": 0, "frames_trained": 0, "frames_dropped": 0,
    "frames_dropped_stale": 0, "frames_dropped_overflow": 0,
    "frames_dropped_shutdown": 0, "frames_dropped_fault": 0,
    "frames_pending": 0, "drop_rate": 0.0, "unrolls_trained": 0,
    "mean_trained_lag": 0.0, "max_param_lag": 0, "capacity": 0,
}


def _snapshot(params):
    """A detached copy of a tree of tensors (other leaves as they are),
    made where it is called: on the card it is queued after the work
    already issued on the stream, so it holds one version."""
    return pytree.tree_map(
        lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, params)


class SeedSystem:
    def __init__(self, *, env_factory: Callable, policy_step: Optional[Callable] = None,
                 num_actors: int, unroll: int, envs_per_actor: int = 1,
                 backend: str = "host", policy_apply: Optional[Callable] = None,
                 init_params=None, init_core: Optional[Callable] = None,
                 train_step: Optional[Callable] = None, state=None,
                 learner_batch: int = 8, replay_capacity: int = 512,
                 min_replay: int = 16, deadline_ms: float = 5.0,
                 inference_batch: Optional[int] = None,
                 transport: str = "inproc", num_actor_hosts: int = 1,
                 gateway_host: str = "127.0.0.1", gateway_port: int = 0,
                 num_replicas: int = 1, num_gateways: int = 1,
                 engine_shards: int = 1, wire_compression: bool = False,
                 wire_quant: Optional[str] = None,
                 checkpoint_manager=None, checkpoint_every: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_s: float = 0.0,
                 algo: str = "r2d2", max_param_lag: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 gamma: Optional[float] = None,
                 policy_publish: Optional[Callable] = None,
                 telemetry=None, ops_port: Optional[int] = None,
                 supervise_hosts: bool = False,
                 max_host_restarts: int = 3, host_stall_s: float = 5.0,
                 wire_reconnect=None, autoscale=None):
        if backend not in ("host", "device"):
            raise ValueError(f"unknown backend {backend!r}; use 'host' or 'device'")
        if algo not in ("r2d2", "vtrace"):
            raise ValueError(
                f"unknown algo {algo!r}; use 'r2d2' (replay) or 'vtrace' "
                f"(on-policy trajectory queue)")
        if algo != "vtrace":
            # reject rather than silently ignore: these knobs only exist
            # on the on-policy trajectory plane
            for name, val in (("max_param_lag", max_param_lag),
                              ("queue_capacity", queue_capacity),
                              ("gamma", gamma)):
                if val is not None:
                    raise ValueError(
                        f"{name}={val} applies to algo='vtrace' (replay-"
                        f"based R2D2 has no trajectory queue to tune)")
        queue_capacity = 64 if queue_capacity is None else queue_capacity
        gamma = 0.99 if gamma is None else gamma
        if transport not in ("inproc", "socket", "shm"):
            raise ValueError(
                f"unknown transport {transport!r}; use 'inproc', 'socket' "
                f"or 'shm'")
        wire = transport in ("socket", "shm")    # disaggregated layouts
        if wire and backend != "host":
            raise ValueError(f"transport={transport!r} applies to "
                             "backend='host' (the device backend has no "
                             "inference wire)")
        if not isinstance(num_gateways, int) or num_gateways < 1:
            raise ValueError(
                f"num_gateways must be a positive int, got {num_gateways!r}")
        if num_gateways > 1 and not wire:
            raise ValueError(
                f"num_gateways={num_gateways} applies to wire transports "
                f"(the in-process path has no gateways to shard)")
        if num_gateways > num_actor_hosts and wire:
            raise ValueError(
                f"num_gateways={num_gateways} exceeds num_actor_hosts="
                f"{num_actor_hosts}: hosts hash across gateways, so extra "
                f"gateways would sit idle — raise num_actor_hosts or lower "
                f"num_gateways")
        if num_gateways > 1 and gateway_port != 0:
            raise ValueError(
                f"num_gateways={num_gateways} requires gateway_port=0 "
                f"(ephemeral): a fixed port cannot be bound by more than "
                f"one gateway")
        if engine_shards != 1 and backend != "device":
            raise ValueError(
                f"engine_shards={engine_shards} applies to backend='device' "
                f"(the host backend has no scan engines to shard)")
        if num_replicas != 1 and backend != "host":
            raise ValueError(
                f"num_replicas={num_replicas} applies to backend='host' "
                f"(the device backend has no central inference server)")
        if wire_compression and not wire:
            raise ValueError(
                "wire_compression applies to wire transports (there is "
                "no wire to compress in-process)")
        if wire_quant is not None and not wire:
            raise ValueError(
                "wire_quant applies to wire transports (there is no wire "
                "to quantize in-process)")
        if wire_quant not in (None, "f16", "q8"):
            raise ValueError(
                f"wire_quant={wire_quant!r}; expected None, 'f16' or 'q8'")
        if telemetry is not None and not (
                hasattr(telemetry, "metrics") and hasattr(telemetry, "tracer")
                and hasattr(telemetry, "sampler")):
            raise TypeError(
                f"telemetry must be a repro_torch.telemetry.Telemetry (or "
                f"None), got {type(telemetry).__name__} — construct one with "
                f"Telemetry(process_name=...) and pass the same instance "
                f"you will later dump()/report from")
        if ops_port is not None:
            if not isinstance(ops_port, int) or isinstance(ops_port, bool) \
                    or ops_port < 0:
                raise ValueError(
                    f"ops_port must be a non-negative int (0 = ephemeral "
                    f"port) or None, got {ops_port!r}")
            if telemetry is None:
                # the ops plane needs somewhere to read from; a bare
                # SeedSystem(ops_port=0) gets a default telemetry bundle
                telemetry = Telemetry(process_name="learner")
        if checkpoint_dir is not None:
            if checkpoint_manager is not None:
                raise ValueError(
                    "pass checkpoint_dir OR checkpoint_manager, not both "
                    "(checkpoint_dir constructs a CheckpointManager)")
            from repro_torch.checkpoint import CheckpointManager
            checkpoint_manager = CheckpointManager(checkpoint_dir)
        if checkpoint_every_s and checkpoint_manager is None:
            raise ValueError(
                f"checkpoint_every_s={checkpoint_every_s} needs somewhere "
                f"to save — pass checkpoint_dir or checkpoint_manager")
        if (supervise_hosts or wire_reconnect is not None) and not wire:
            raise ValueError(
                "supervise_hosts / wire_reconnect apply to wire transports "
                "(in-process actors have no host processes to supervise "
                "or connections to re-dial)")
        if autoscale is not None:
            if not isinstance(autoscale, AutoscaleConfig):
                raise TypeError(
                    f"autoscale must be a repro_torch.autoscale.AutoscaleConfig "
                    f"(or None), got {type(autoscale).__name__}")
            if backend != "host":
                raise ValueError(
                    "autoscale applies to backend='host' (the device "
                    "backend has no actor hosts or inference replicas "
                    "to resize)")
            if telemetry is None:
                # the controller senses through the registry + bottleneck
                # attribution; a bare SeedSystem(autoscale=...) gets a
                # default bundle exactly like ops_port does
                telemetry = Telemetry(process_name="learner")
        self.backend = backend
        self.transport = transport
        self.algo = algo
        self.telemetry = telemetry
        self.envs_per_actor = envs_per_actor
        self.engine_shards = engine_shards
        self.server = None
        self.gateways = []
        self.pool = None
        self.num_actors = num_actors
        self.ops_address = None
        self._run_t0 = None
        self._t_created = time.perf_counter()    # /varz uptime_s
        self.autoscaler = None
        self.host_faults = 0                 # see throughput()["recovery"]
        # ops-plane handles (None when telemetry is absent or duck-typed
        # without them — everything downstream null-checks)
        self._health = getattr(telemetry, "health", None)
        self._flightrec = getattr(telemetry, "flightrec", None)
        self.replay = PrioritizedReplay(replay_capacity)
        self.min_replay = min_replay
        self.learner_batch = learner_batch
        self._policy_publish = policy_publish
        self._ckpt = checkpoint_manager
        # the publish/version seam: actors read the version for staleness
        # stamping; `policy_publish` pushes params into the policy
        self._live = {"params": init_params, "version": 0}
        self._live_lock = threading.Lock()
        onpolicy = algo == "vtrace"
        self.onpolicy_queue = None
        if onpolicy:
            self.onpolicy_queue = TrajectoryQueue(
                queue_capacity, max_param_lag=max_param_lag,
                version_source=self._version,
                metrics=telemetry.metrics if telemetry else None,
                health=self._health)
        if backend == "host":
            if policy_step is None:
                raise ValueError("backend='host' requires policy_step")
            # raises ValueError when num_replicas exceeds the lane budget
            self.server = InferenceServer(
                policy_step,
                max_batch=inference_batch or max(num_actors * envs_per_actor, 1),
                deadline_ms=deadline_ms, num_replicas=num_replicas,
                telemetry=telemetry)
            if wire:
                from repro_torch.launch.actor_host import ActorHostPool
                from repro_torch.transport.socket import InferenceGateway
                use_shm = transport == "shm"
                self.gateways = [
                    InferenceGateway(self.server, sink=self._sink,
                                     host=gateway_host, port=gateway_port,
                                     version_source=self._version,
                                     onpolicy=onpolicy,
                                     # grant CODEC_SHM only when the
                                     # deployment asked for the shm plane,
                                     # so transport='socket' measures the
                                     # honest TCP path
                                     allow_shm=use_shm,
                                     telemetry=telemetry)
                    for _ in range(num_gateways)]
                if telemetry is not None:
                    # gateways keep private registries (G gateways would
                    # collide on counter names in a shared one); attach
                    # them so snapshots/metrics.jsonl still see every frame
                    for gi, gw in enumerate(self.gateways):
                        telemetry.attach(f"gateway{gi}", gw.metrics)
                self.pool = ActorHostPool(
                    env_factory, num_actors=num_actors,
                    envs_per_actor=envs_per_actor, unroll=unroll,
                    num_hosts=num_actor_hosts, compress=wire_compression,
                    onpolicy=onpolicy, use_shm=use_shm, quant=wire_quant,
                    telemetry=telemetry is not None,
                    pid_callback=(telemetry.watch_process
                                  if telemetry is not None else None),
                    heartbeat_callback=(self._health.beat
                                        if self._health is not None else None),
                    heartbeat_close=(self._health.unregister
                                     if self._health is not None else None),
                    failure_callback=(
                        (lambda msg: self._flightrec.trigger(
                            "pool_timeout", msg))
                        if self._flightrec is not None else None),
                    supervise=supervise_hosts,
                    max_host_restarts=max_host_restarts,
                    host_stall_s=host_stall_s, reconnect=wire_reconnect,
                    fault_callback=self._host_fault,
                    elastic=autoscale is not None)
                self.actors = []
            else:
                self.actors = [Actor(i, env_factory, self.server, self._sink,
                                     unroll, num_envs=envs_per_actor,
                                     version_source=self._version,
                                     with_logprobs=onpolicy, stamp_records=onpolicy,
                                     telemetry=telemetry)
                               for i in range(num_actors)]
        else:
            if policy_apply is None:
                raise ValueError("backend='device' requires policy_apply")
            if init_params is None and isinstance(state, dict):
                # workers start from the learner's params, in the tree the
                # first publish will have, or the unroll captures anew
                init_params = state.get("params")
            # a snapshot: the first train step updates them in place
            self._live["params"] = _snapshot(init_params)

            def make_engine(i):
                if engine_shards == 1:
                    return DeviceRolloutEngine(env_factory, policy_apply,
                                               envs_per_actor, unroll,
                                               init_core=init_core, seed=i,
                                               with_logprobs=onpolicy)
                # raises ValueError when shards exceed lanes / no devices
                return ShardedRolloutEngine(env_factory, policy_apply,
                                            envs_per_actor, unroll,
                                            num_shards=engine_shards,
                                            init_core=init_core, seed=i,
                                            with_logprobs=onpolicy)

            self.actors = [
                RolloutWorker(i, make_engine(i), self._sink,
                              self._param_source, stamp_records=onpolicy,
                              health=self._health)
                for i in range(num_actors)]
        self.learner = None
        if train_step is not None:
            if onpolicy:
                batch_fn = VTraceBatcher(self.onpolicy_queue, learner_batch,
                                         gamma=gamma)
                poison = self.onpolicy_queue.close
                priority_update = None
            else:
                batch_fn = self._learner_batch
                poison = None
                priority_update = lambda idx, pri: \
                    self.replay.update_priorities(idx, pri)
            self.learner = Learner(
                train_step, state, batch_fn,
                publish=self._publish,
                priority_update=priority_update,
                checkpoint_manager=checkpoint_manager,
                checkpoint_every=checkpoint_every,
                checkpoint_every_s=checkpoint_every_s,
                poison=poison,
                telemetry=telemetry)
        auditor = getattr(telemetry, "auditor", None)
        if auditor is not None:
            # continuous invariant audits: re-check the conserved ledger
            # and slot-table bounds WHILE training runs (tests only pin
            # them at quiescence)
            self._audit_prev_slots = 0
            if self.onpolicy_queue is not None:
                auditor.add_check("frame_ledger", self._audit_ledger)
            if self.server is not None:
                auditor.add_check("slot_table", self._audit_slots)
        if ops_port is not None:
            # the HTTP listener binds now (address known before run());
            # the watchdog/auditor threads start inside telemetry.start()
            self.ops_address = telemetry.serve_ops(port=ops_port)
            telemetry.ops.set_varz(self._varz)
            telemetry.ops.add_collector(self._ops_ledger_gauges)
        if autoscale is not None:
            slos = autoscale.slos
            if slos is None:
                # deliberately loose defaults: a 1 frame/s floor ("not
                # stalled"), the drop-rate knee the learner-bound override
                # uses, and a generous batch-wait ceiling — operators
                # tighten via AutoscaleConfig(slos=SLOSet([...]))
                slos = SLOSet([
                    SLO(name="frames_floor", series="frames_generated",
                        target=1.0, kind="floor", mode="rate",
                        fast_window_s=3.0, slow_window_s=10.0),
                    SLO(name="drop_rate", series="drop_rate", target=0.5,
                        kind="ceiling", fast_window_s=3.0,
                        slow_window_s=10.0),
                    SLO(name="infer_p99_ms", series="infer_p99_ms",
                        target=1000.0, kind="ceiling", fast_window_s=3.0,
                        slow_window_s=10.0),
                ])
            self.autoscaler = AutoscaleController(
                autoscale, telemetry, stats_fn=self._autoscale_stats,
                pool=self.pool, server=self.server, slos=slos)
            self.autoscaler.store.add_source(self._live_series)
            telemetry.flightrec.add_provider("autoscaler",
                                             self.autoscaler.dump)
            if telemetry.ops is not None:
                telemetry.ops.set_autoscaler(self.autoscaler.dump)
                telemetry.ops.set_timeseries(self.autoscaler.store.dump)

    # --------------------------------------------------------- fault plane

    def _host_fault(self, host_id: int, reason: str):
        """ActorHostPool's per-death seam (fires BEFORE the respawn):
        file the postmortem, force /healthz to at least `degraded` (a
        fast respawn would otherwise beat the staleness window and the
        death would be observable nowhere), and move the dead
        incarnation's queued-but-untrained frames into the FAULT drop
        bucket — the conserved ledger's answer to 'where did the dead
        host's in-flight unrolls go?'. They are counted `frames_dropped`,
        never `frames_trained`."""
        self.host_faults += 1
        if self._flightrec is not None:
            self._flightrec.trigger("host_death", reason)
        if self._health is not None:
            self._health.event(f"actor-host-{host_id}", reason)
        if self.onpolicy_queue is not None:
            self.onpolicy_queue.drop_pending()

    def _recovery_stats(self) -> dict:
        """One consistent snapshot of the recovery counters — shared by
        `throughput()["recovery"]`, the `/metrics` collector, and /varz so
        every surface reports the same numbers."""
        out = {
            "host_faults": self.host_faults,
            "host_restarts": (self.pool.host_restarts
                              if self.pool is not None else 0),
            "stale_frames_rejected": (self.pool.stale_frames_rejected
                                      if self.pool is not None else 0),
            "reconnects": 0, "gateway_failovers": 0,
            "checkpoint_saves": self._ckpt.saves if self._ckpt else 0,
            "checkpoint_restores": self._ckpt.restores if self._ckpt else 0,
            "frames_dropped_by_fault": (
                self.onpolicy_queue.frames_dropped_fault
                if self.onpolicy_queue is not None else 0),
        }
        if self.pool is not None:
            # transport-side counters live in the children and ride home
            # in the final stats frames (a killed incarnation's counts die
            # with it — the supervisor's own counters above don't)
            out["reconnects"] = sum(s.get("reconnects", 0)
                                    for s in self.pool.last_stats)
            out["gateway_failovers"] = sum(s.get("gateway_failovers", 0)
                                           for s in self.pool.last_stats)
        return out

    def resume(self) -> int:
        """Learner crash recovery: restore the latest checkpoint into the
        live loop and make the system runnable again. Returns the version
        the restored params were re-published under: ``max(restored_step,
        current_version)``, so `param_version` stays monotonic across the
        crash boundary. The params themselves are the checkpointed ones,
        bit-exact."""
        if self.learner is None or self.learner.ckpt is None:
            raise RuntimeError(
                "resume() needs a learner with a checkpoint manager "
                "(construct SeedSystem with checkpoint_dir=...)")
        state, step = self.learner.ckpt.restore(self.learner.state)
        version = max(step, self._version())
        self.learner.state = state
        self.learner.steps = version
        self.learner.error = None
        self.learner._stop.clear()
        self._publish(state["params"], version)
        if self.onpolicy_queue is not None:
            # a vtrace learner's stop() closed the queue (poison seam); the
            # resumed run must admit again — the ledger carries over
            self.onpolicy_queue.reopen()
        if self.server is not None:
            self.server.error = None
            self.server._stop.clear()
        for a in self.actors:
            # actors are re-runnable (start() builds a fresh thread) but
            # stop() latches _stop — unlatch for the next run
            a.error = None
            a._stop.clear()
        return version

    # ---------------------------------------------------------- ops plane

    def _ops_ledger_gauges(self):
        """Per-scrape gauges whose cross-field invariants must hold WITHIN
        one exposition: the frame ledger comes from a single
        `TrajectoryQueue.stats()` call (atomic under the queue lock), so a
        scrape can never observe generated != trained+dropped+pending —
        individual callback gauges cannot promise that."""
        out = {}
        ledger = (self.onpolicy_queue.stats()
                  if self.onpolicy_queue is not None else ZERO_LEDGER)
        for k, v in ledger.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            out[f"onpolicy/{k}"] = v
        if self.server is not None:
            out["inference/num_slots"] = self.server.num_slots
        for k, v in self._recovery_stats().items():
            out[f"recovery/{k}"] = v
        return out

    def _autoscale_stats(self) -> dict:
        """Mid-run stats document for the controller's bottleneck
        attribution. `throughput()` needs the pool's final per-host stats
        (which only land at window end), so this feeds the ledger's live
        frame count instead — `bottleneck_report` falls back to registry
        lane counters when `env_frames` is absent."""
        elapsed = (time.perf_counter() - self._run_t0) \
            if self._run_t0 is not None else 0.0
        stats = {"elapsed_s": max(elapsed, 1e-9)}
        if self.onpolicy_queue is not None:
            s = self.onpolicy_queue.stats()
            stats["onpolicy"] = s
            stats["env_frames"] = s["frames_generated"]
        return stats

    def _live_series(self) -> dict:
        """The time-series sampler source: one flat {name: value} dict per
        tick, read from single atomic snapshots (queue stats, registry
        histograms, recovery counters) so points are mutually consistent."""
        out = {}
        if self.onpolicy_queue is not None:
            s = self.onpolicy_queue.stats()
            for k in ("frames_generated", "frames_trained",
                      "frames_dropped", "frames_pending", "drop_rate"):
                out[k] = s[k]
            out["queue_depth"] = len(self.onpolicy_queue)
        elif self.telemetry is not None:
            # r2d2/replay runs: lanes served is the frame-supply counter
            out["frames_generated"] = \
                self.telemetry._counter_total("/requests")
        if self.telemetry is not None:
            h = self.telemetry.metrics.snapshot()["histograms"].get(
                "inference/batch_wait_s")
            if h and h.get("count") and h.get("p99") is not None:
                out["infer_p99_ms"] = 1e3 * h["p99"]
        if self.autoscaler is not None:
            # derived view over the points already in the store (up to the
            # previous tick) — the decision log's headline trigger value
            out["frames_per_s"] = self.autoscaler.store.rate(
                "frames_generated", 5.0)
        for k, v in self._recovery_stats().items():
            out[f"recovery/{k}"] = v
        return out

    def _varz(self) -> dict:
        """The /varz document: live throughput()/BottleneckReport/ledger/
        occupancy stats plus health and postmortem paths — the
        autoscaler's input."""
        elapsed = (time.perf_counter() - self._run_t0) \
            if self._run_t0 is not None else 0.0
        stats = self.throughput(max(elapsed, 1e-9))
        out = {"schema_version": VARZ_SCHEMA_VERSION,
               "uptime_s": round(time.perf_counter() - self._t_created, 3),
               "stats": stats}
        if self.autoscaler is not None:
            out["autoscale"] = {
                "topology": self.autoscaler.topology(),
                "ticks": self.autoscaler.ticks,
                "actions_applied": dict(self.autoscaler.actions_applied)}
        if self.telemetry is not None:
            try:
                out["bottleneck"] = \
                    self.telemetry.bottleneck_report(stats).as_dict()
            except Exception:
                pass             # a scrape must never 500 on attribution
        if self._health is not None:
            out["health"] = self._health.report().as_dict()
        if self._flightrec is not None:
            out["postmortems"] = list(self._flightrec.bundles)
        return out

    def _audit_ledger(self):
        s = self.onpolicy_queue.stats()
        v = []
        accounted = (s["frames_trained"] + s["frames_dropped"]
                     + s["frames_pending"])
        if s["frames_generated"] != accounted:
            v.append(f"frame ledger not conserved: generated="
                     f"{s['frames_generated']} != trained+dropped+pending="
                     f"{accounted}")
        if s["frames_pending"] < 0:
            v.append(f"negative frames_pending: {s['frames_pending']}")
        depth = len(self.onpolicy_queue)
        if depth > s["capacity"]:
            v.append(f"queue depth {depth} exceeds capacity "
                     f"{s['capacity']}")
        return v

    def _audit_slots(self):
        v = []
        n = self.server.num_slots
        # the pool's high-water actor-id mark, not the constructed count:
        # autoscale grows issue fresh actor ids, and their slots are
        # legitimate table rows forever (slots never shrink)
        actors = (self.pool.hw_actors if self.pool is not None
                  else self.num_actors)
        budget = actors * self.envs_per_actor
        if n > budget:
            v.append(f"slot table has {n} slots > lane budget {budget}")
        if n < self._audit_prev_slots:
            v.append(f"slot table shrank: {self._audit_prev_slots} -> {n} "
                     f"(slots are never removed)")
        else:
            self._audit_prev_slots = n
        return v

    def stop_ops(self):
        """Tear down the ops HTTP server. It deliberately outlives run()
        (a post-run scrape must still see the final quiescent ledger), so
        tests and long-lived embedders call this when done."""
        if self.telemetry is not None:
            self.telemetry.close_ops()
        self.ops_address = None

    def _sink(self, traj):
        if self.onpolicy_queue is not None:
            self.onpolicy_queue.put(traj)
            return
        self.replay.add(traj, priority=float(np.abs(traj["rewards"]).mean()) + 1.0)

    def _learner_batch(self):
        while len(self.replay) < max(self.min_replay, self.learner_batch):
            if self.learner is not None and self.learner.stopped:
                # stop() must not wait on replay that may never fill
                raise BatchSourceClosed("system stopping before min_replay")
            time.sleep(0.005)
        batch, idx, w = self.replay.sample(self.learner_batch)
        batch["is_weights"] = w
        return batch, idx

    def _publish(self, params, step):
        """Learner -> actors param seam: the version feeds the actors'
        staleness stamping; an optional `policy_publish` hook pushes the
        params into the host-side policy. Device workers read the params
        themselves, so they get a snapshot taken here, in the learner's
        thread, fresh each publish and stored with its version: the next
        train step updates the learner's tensors in place."""
        if self.backend == "device":
            params = _snapshot(params)
        with self._live_lock:
            self._live = {"params": params, "version": step}
        if self._policy_publish is not None:
            self._policy_publish(params, step)

    def _version(self) -> int:
        with self._live_lock:
            return self._live["version"]

    def _param_source(self):
        with self._live_lock:
            return self._live["params"], self._live["version"]

    def warmup(self):
        """Step every actor's envs once, or capture every device worker's
        unroll (without advancing it), so that a short measured `run()`
        window is steady-state. Wire actor hosts warm up inside their own
        processes before their measured window, so this is a no-op for
        them."""
        for a in self.actors:
            if self.backend == "device":
                a.warmup()
            else:
                a.vec.reset()
                a.vec.step(np.zeros(a.num_envs, np.int32))

    def run(self, seconds: float, with_learner: bool = True):
        self._run_t0 = time.perf_counter()
        if self.telemetry is not None:
            self.telemetry.start()
        if self.autoscaler is not None:
            # the controller thread senses/decides/acts while the window
            # runs; pool commands execute inside the collect loop, replica
            # activation is a plain attribute flip — both thread-safe
            self.autoscaler.start()
        if self.pool is not None:
            try:
                return self._run_socket(seconds, with_learner)
            finally:
                if self.autoscaler is not None:
                    self.autoscaler.stop()
                if self.telemetry is not None:
                    self.telemetry.stop()
        if self.server:
            self.server.start()
        for a in self.actors:
            a.start()
        if self.learner and with_learner:
            self.learner.start()
        t0 = time.perf_counter()
        time.sleep(seconds)
        elapsed = time.perf_counter() - t0
        for a in self.actors:
            a.stop()
        if self.server:
            self.server.stop()
        if self.learner and with_learner:
            self.learner.stop()
            self.learner.join()
        for a in self.actors:
            a.join()
        if self.onpolicy_queue is not None:
            # settle the frame ledger: pending drains into the dropped
            # count so generated == trained + dropped in throughput()
            # (learner.stop() already closed it when a learner ran)
            self.onpolicy_queue.close()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.telemetry is not None:
            self.telemetry.stop()
        return self.throughput(elapsed)

    def _run_socket(self, seconds: float, with_learner: bool):
        """Disaggregated run: G gateways + server here, actors in K
        spawned host processes hashed across the gateway addresses.
        `elapsed` is the actor hosts' own measured window (spawn, torch
        import and env warm-up excluded), so frames/s is comparable with
        the in-proc backend's steady-state window."""
        try:
            # inside the try: a bind failure here must still unwind the
            # already-started server/gateways (stop() on a never-started
            # gateway is safe), or we leak threads, a listener, and the
            # 1 ms GIL switch interval a started gateway installed
            self.server.start()
            addresses = [gw.start() for gw in self.gateways]
            if self.learner and with_learner:
                self.learner.start()
            host_stats = self.pool.run(addresses, seconds)
        finally:
            # even if the pool trips its hard timeout, tear the learner,
            # gateways (which also restore the GIL switch interval) and
            # server down — never leak threads or a bound listener
            if self.learner and with_learner:
                self.learner.stop()
                self.learner.join()
            # reverse order: each gateway saved the GIL switch interval it
            # found at start(), so unwinding the stack restores the real
            # process default, not a sibling gateway's 1 ms slice
            for gw in reversed(self.gateways):
                gw.stop()
            self.server.stop()
            if self.onpolicy_queue is not None:
                # after the gateways: TRAJ frames still in flight land as
                # counted shutdown drops, not unrecorded frames
                self.onpolicy_queue.close()
        if self.telemetry is not None:
            # fold each host's spans + registry snapshot (shipped through
            # the mp result queue) into this process's telemetry; pops the
            # bulky keys so last_stats stays a plain counter report
            for s in host_stats:
                self.telemetry.absorb_host(s)
        elapsed = max((s["elapsed_s"] for s in host_stats), default=seconds)
        return self.throughput(max(elapsed, 1e-9))

    def throughput(self, elapsed: float):
        if self.pool is not None:
            hs = self.pool.last_stats
            iterations = sum(s["iterations"] for s in hs)
            frames = sum(s["frames"] for s in hs)
            returns = [r for s in hs for r in s["returns"]]
        else:
            iterations = sum(a.iterations for a in self.actors)
            frames = sum(a.frames for a in self.actors)  # = iterations*E
            returns = [r for a in self.actors for r in a.returns[-20:]]
        out = {
            "elapsed_s": elapsed,
            "backend": self.backend,
            "transport": self.transport,
            "algo": self.algo,
            "envs_per_actor": self.envs_per_actor,
            "actor_iterations": iterations,
            "env_frames": frames,
            "env_frames_per_s": frames / elapsed,
            "learner_steps": self.learner.steps if self.learner else 0,
            "learner_steps_per_s": (self.learner.steps / elapsed) if self.learner else 0.0,
            "learner_error": self.learner.error if self.learner else None,
            "episode_return_mean": float(np.mean(returns or [0.0])),
        }
        if self.ops_address is not None:
            out["ops_address"] = f"{self.ops_address[0]}:{self.ops_address[1]}"
        if self.server:
            # actors stamp the behavior-param version on every unroll: mean
            # lag (in learner publishes) of the unrolls this run flushed
            if self.pool is not None:
                unroll_flushes = sum(s["unrolls"] for s in self.pool.last_stats)
                lag_total = sum(s["param_lag_total"] for s in self.pool.last_stats)
            else:
                unroll_flushes = sum(a.unrolls for a in self.actors)
                lag_total = sum(a.param_lag_total for a in self.actors)
            out["unroll_flushes"] = unroll_flushes
            out["mean_param_lag"] = lag_total / max(unroll_flushes, 1)
        # the conserved frame ledger: generated == trained + dropped
        # (+ pending mid-run). ALWAYS present — zero-valued when the vtrace
        # queue is off — so the schema stays stable
        out["onpolicy"] = (self.onpolicy_queue.stats()
                           if self.onpolicy_queue is not None
                           else dict(ZERO_LEDGER))
        out["recovery"] = self._recovery_stats()
        if self.server:
            s = self.server.stats           # summed across replicas
            actor_error = next(
                (e for e in (getattr(a, "error", None) for a in self.actors) if e), None)
            out.update({
                "inference_batches": s["batches"],
                "inference_lanes": s["requests"],
                "inference_rpcs": s["rpcs"],
                # raw accumulated counters, plus the derived means so
                # callers never have to know which sum divides by what
                "batch_occupancy_sum": s["batch_occupancy"],
                "queue_wait_s_sum": s["queue_wait_s"],
                "inference_compute_s": s["compute_s"],
                "inference_error": self.server.error or actor_error,
                "num_replicas": self.server.num_replicas,
                **self.server.derived_stats(),
            })
            if self.server.num_replicas > 1:
                # ONE snapshot for both views: per-replica lane counts and
                # occupancy expose batch-fill starvation per shard
                per = self.server.per_replica_stats()
                out["replica_lanes"] = [r["requests"] for r in per]
                out["replica_occupancy"] = [r["mean_batch_occupancy"] for r in per]
            if self.pool is not None:
                gs = [gw.stats for gw in self.gateways]
                hs = self.pool.last_stats
                out.update({
                    "actor_hosts": self.pool.num_hosts,
                    "actor_hosts_live": self.pool.live_hosts(),
                    "hosts_grown": self.pool.hosts_grown,
                    "hosts_drained": self.pool.hosts_drained,
                    "num_gateways": len(self.gateways),
                    "gateway_connections": sum(g["connections"] for g in gs),
                    "gateway_request_frames": sum(g["request_frames"] for g in gs),
                    "gateway_traj_frames": sum(g["traj_frames"] for g in gs),
                    "gateway_traj_batch_frames": sum(g["traj_batch_frames"]
                                                     for g in gs),
                    "gateway_shm_conns": sum(g["shm_conns"] for g in gs),
                    "gateway_shm_frames": sum(g["shm_frames"] for g in gs),
                    "host_shm_frames": sum(s_.get("shm_frames", 0) for s_ in hs),
                    "host_spill_frames": sum(s_.get("spill_frames", 0) for s_ in hs),
                    "per_gateway_connections": [g["connections"] for g in gs],
                    "host_errors": [s_["error"] for s_ in hs if s_["error"]],
                    "host_cuda_initialized": [s_.get("cuda_initialized", False)
                                              for s_ in hs],
                })
        else:
            # device backend: no central inference — one transfer per
            # unroll. scans == actor_iterations; each supplies T*E frames.
            refreshes = sum(a.param_refreshes for a in self.actors)
            lag = sum(a.param_lag_total for a in self.actors)
            out.update({
                "inference_batches": 0,
                "inference_lanes": 0,
                "mean_batch_occupancy": 0.0,
                "mean_queue_wait_ms": 0.0,
                "inference_compute_s": 0.0,
                "inference_error": next(
                    (a.error for a in self.actors if a.error), None),
                "scans": iterations,
                "engine_shards": self.engine_shards,
                "param_refreshes": refreshes,
                "mean_param_lag": lag / max(iterations, 1),
            })
        if self.telemetry is not None:
            # the measured CPU/GPU-ratio attribution the paper's method
            # is built on — computed from this same stats dict plus the
            # registry/sampler, never raises on an empty window
            out["bottleneck"] = self.telemetry.bottleneck_report(out).as_dict()
        return out
