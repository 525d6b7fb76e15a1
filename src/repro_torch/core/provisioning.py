"""The paper's contribution #3: the CPU/GPU-ratio provisioning metric and
the actor/learner system-throughput model behind Figs 3-4.

Model (per actor): one env interaction costs `t_env` of CPU time and a
`t_inf(n)` inference round-trip during which the actor's thread is idle
(SEED central inference). With H hardware threads and n actors:

    T(n) = n / (t_env * max(1, n / H) + t_inf(n)),   t_inf(n) = t0 + t1 * n

  * n <= H: oversubscription hides inference latency -> near-linear,
    degraded by the batch-linear term t1*n (the paper's sub-linear 5.8x
    for 4 -> 40);
  * n > H: CPU contention multiplies t_env -> throughput approaches the
    ceiling H / t_env (the paper's saturation: only 2x more from 40->256).

Fig 4 (accelerator derating): with compute scaled by f (SMs disabled),
round time T(f) = t_overlap + t_serial / f — actors hide most accelerator
time, so halving the accelerator costs only ~6%.

The provisioning rule: balance actor supply against learner demand and
express the required host threads per 'SM equivalent' of accelerator
compute (paper: ratio >= 1 for current-generation SMs).

A copy of ``repro.core.provisioning``; only its imports differ. The port
keeps its own so that it imports nothing of the JAX package.
"""

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.hw import ChipSpec, HostSpec, sm_equivalents


@dataclass(frozen=True)
class SystemModel:
    """Two regimes:
      * latency-limited: each actor cycles t_env + t_inf(batch), and the
        inference batch grows with the number of concurrent actors up to
        the server's batch cap (SEED batches inference requests);
      * capacity-limited: H hardware threads can sustain at most H / t_env
        env-steps/s regardless of actor count (actors beyond that only
        hide inference latency, which is already hidden).
    """
    t_env: float          # CPU seconds per env step (per lane)
    t_inf0: float         # inference round-trip base latency (s)
    t_inf1: float         # inference latency growth per batched lane (s)
    hw_threads: int
    batch_cap: int = 64   # SEED inference server max lane batch
    envs_per_actor: int = 1   # E lanes vectorized per actor thread
    backend: str = "host"     # "host" | "network" | "device"
    t_dev0: float = 0.0   # device: fixed per-scan-step cost (launch/dispatch)
    t_dev1: float = 0.0   # device: per-lane compute per scan step
    t_net: float = 0.0    # network: wire RTT added per inference round-trip
    n_actor_hosts: int = 1    # network: CPU hosts supplying actor threads
    n_replicas: int = 1   # data-parallel inference replicas (lane sharding)
    wire: str = "tcp"     # network: which wire carries the frames —
    #                       "tcp" (loopback/remote sockets) or "shm"
    #                       (co-located shared-memory rings). A label for
    #                       the operating point: the calibrated t_net IS
    #                       the difference (fig4's measured RTT sweep).

    def throughput(self, n_actors):
        """Env frames/s at n actor threads, each stepping E lanes.

        Host backend: one actor cycle supplies E frames and costs E*t_env
        of CPU plus ONE inference round-trip over the flattened lane batch
        (n*E lanes, up to the server cap) — the vectorization amortizes
        t_inf over E. The CPU capacity ceiling H / t_env is unchanged:
        lanes still cost t_env of thread time each, so E>1 raises the
        latency-limited regime, not the saturation ceiling.

        Device backend (fused env+policy scan): both t_env (host CPU) and
        t_inf (round-trip) drop out — per scan step the whole n*E lane
        batch advances in t_dev0 + t_dev1 * lanes of accelerator time, so
        throughput = lanes / t_step, asymptotically bounded by the scan
        throughput 1/t_dev1 (not by host threads).

        Network backend (socket transport, `with_network`): the host model
        with the wire RTT t_net added to every inference round-trip — a
        pure latency-regime tax — while the capacity ceiling scales with
        the AGGREGATE threads of the n_actor_hosts disaggregated CPU hosts.
        That asymmetry IS the design tradeoff the paper's ratio metric
        prices: the wire costs only where latency already dominates, and
        buys a ceiling no single host has.

        Sharded inference (`with_sharded`, host/network backends): N
        data-parallel replicas each forward 1/N of the flattened lanes —
        per-replica batch min(n*E, cap)/N, exactly the runtime's
        `max_batch // num_replicas` budget split — so the batch-linear
        latency term divides by N: forward capacity xN. The fixed cost
        t_inf0 does NOT divide (each replica still pays the round-trip
        floor), so gains taper once per-replica batches starve: as
        n*E/N shrinks, t_inf -> t_inf0 and extra replicas buy nothing.
        """
        n = np.asarray(n_actors, np.float64)
        E = float(self.envs_per_actor)
        if self.backend == "device":
            if self.t_dev1 <= 0.0:
                raise ValueError(
                    "device backend needs per-lane scan cost t_dev1 > 0; "
                    "construct via with_device(t_dev0, t_dev1)")
            lanes = n * E
            t_step = self.t_dev0 + self.t_dev1 * lanes
            return lanes / t_step
        t_inf = (self.t_inf0 + self.t_net
                 + self.t_inf1 * np.minimum(n * E, self.batch_cap)
                 / self.n_replicas)
        latency_limited = n * E / (self.t_env * E + t_inf)
        capacity = self.hw_threads * self.n_actor_hosts / self.t_env
        return np.minimum(latency_limited, capacity)

    def speedup(self, n_actors, base_actors=4):
        return self.throughput(n_actors) / self.throughput(base_actors)

    def with_envs(self, envs_per_actor: int) -> "SystemModel":
        """Same calibration, different lane count — the second sweep axis."""
        return replace(self, envs_per_actor=envs_per_actor)

    def with_device(self, t_dev0: float = 0.05,
                    t_dev1: float = 0.002) -> "SystemModel":
        """The device-resident operating point (fused `lax.scan` rollouts).

        Costs are in t_env units like t_inf0/t_inf1. Defaults: the scan
        amortizes kernel launches over the unroll, so the fixed per-step
        cost is a few % of a host env step, and per-lane device compute is
        ~500x cheaper than the host step it replaces — the CuLE-style
        measurement the paper's ratio analysis argues for.
        """
        return replace(self, backend="device", t_dev0=t_dev0, t_dev1=t_dev1)

    def with_network(self, t_rtt: float, n_hosts: int = 1,
                     wire: str = "tcp") -> "SystemModel":
        """The networked operating point (`repro.transport` wire path):
        actors live on `n_hosts` remote CPU hosts and every inference
        round-trip pays the wire RTT `t_rtt` (same units as t_inf0) on top
        of the batching latency. Throughput at fixed n can only drop
        (latency regime), but the capacity ceiling becomes
        n_hosts * hw_threads / t_env — the CPU/GPU-ratio knob turned by
        adding hosts instead of swapping chips.

        `wire` labels which data plane the calibration came from: "tcp"
        (the socket transport; loopback or a real network) or "shm"
        (co-located shared-memory rings — `transport="shm"`). The shm
        operating point is the SAME model at a smaller measured t_rtt:
        fig4's `measure_wire_ping()` best-of-N probe supplies both, and
        the tcp-vs-shm gap is precisely the per-round-trip syscall +
        wakeup tax the ring removes.
        """
        if t_rtt < 0:
            raise ValueError(f"t_rtt must be >= 0, got {t_rtt}")
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if wire not in ("tcp", "shm"):
            raise ValueError(f"wire={wire!r}; expected 'tcp' or 'shm'")
        return replace(self, backend="network", t_net=float(t_rtt),
                       n_actor_hosts=int(n_hosts), wire=wire)

    def with_sharded(self, n_replicas: int) -> "SystemModel":
        """The sharded-inference operating point (`num_replicas` in
        `SeedSystem` / `InferenceServer`): N data-parallel policy workers,
        each forwarding a 1/N shard of the lane batch, behind sticky
        actor->replica routing. Composes with `with_network` (one gateway
        per replica) — forward capacity xN until per-replica batch fill
        starves (see `throughput`). Same validation rule as the runtime
        server: each replica needs at least one lane of batch budget.
        """
        if not isinstance(n_replicas, int) or n_replicas < 1:
            raise ValueError(
                f"n_replicas must be a positive int, got {n_replicas!r}")
        if n_replicas > self.batch_cap:
            raise ValueError(
                f"n_replicas={n_replicas} exceeds batch_cap="
                f"{self.batch_cap}: each replica needs at least one lane "
                f"of batch budget")
        if self.backend == "device":
            # mirrors the runtime: SeedSystem(backend='device',
            # num_replicas=N) raises too — the device path has no central
            # inference term for replicas to divide (its sharding knob is
            # engine_shards, which scales 1/t_dev1 with devices instead)
            raise ValueError(
                "with_sharded applies to the host/network backends; the "
                "device operating point has no central inference replicas")
        return replace(self, n_replicas=n_replicas)

    def onpolicy_point(self, n_actors, *, learner_step_s: float,
                       batch_size: int, unroll: int,
                       queue_capacity: int = 64) -> "OnPolicyPoint":
        """The ALGORITHMIC operating point (`SeedSystem(algo='vtrace')`):
        what fraction of the frames this hardware configuration supplies
        can an on-policy learner actually absorb, and how stale are they
        when it does.

        Replay-based R2D2 decouples supply from demand (the buffer eats
        any imbalance), so its operating point is purely the hardware
        curve above. On-policy V-trace re-couples them: the learner
        consumes ``batch_size * unroll / learner_step_s`` frames/s, and
        every generated frame beyond that is DROPPED by the bounded
        trajectory queue — the paper's actor-scaling knee seen from the
        algorithm side. Past the knee, adding actors buys drop rate, not
        learning; the staleness of what does train is the queue residency
        (a full queue at steady state) converted to learner steps — the
        `mean_param_lag` the runtime reports.

        ``learner_step_s`` is seconds per learner step in the same time
        units as t_env; ``queue_capacity`` is in unrolls, matching
        `TrajectoryQueue`.
        """
        if learner_step_s <= 0:
            raise ValueError(
                f"learner_step_s must be > 0, got {learner_step_s}")
        if batch_size < 1 or unroll < 1 or queue_capacity < 1:
            raise ValueError("batch_size, unroll and queue_capacity must "
                             "be >= 1")
        generated = float(self.throughput(n_actors))
        consumable = batch_size * unroll / learner_step_s
        trained = min(generated, consumable)
        drop_rate = max(0.0, 1.0 - consumable / generated) \
            if generated > 0 else 0.0
        if generated <= consumable:
            # learner-starved: an unroll waits one batch-fill, and the
            # version advances once per fill -> lag ~= 1 learner step
            residency_s = batch_size * unroll / max(generated, 1e-12)
        else:
            # actor-saturated: the queue sits full; an admitted unroll
            # waits capacity/consumption-rate before training, during
            # which the learner steps at full rate -> lag ~= capacity in
            # batches (queue_capacity / batch_size)
            residency_s = queue_capacity * unroll / consumable
        # versions only advance when the learner actually steps, so the
        # staleness conversion uses the ACHIEVED step rate, not 1/step_s
        steps_per_s = trained / (batch_size * unroll)
        return OnPolicyPoint(
            frames_generated_per_s=generated,
            frames_trained_per_s=trained,
            drop_rate=drop_rate,
            mean_param_lag=residency_s * steps_per_s,
            learner_bound=generated > consumable)


@dataclass(frozen=True)
class OnPolicyPoint:
    """`SystemModel.onpolicy_point` output: the on-policy frame ledger at
    one (hardware curve, learner latency) pair. `drop_rate` rises past the
    point where actor supply exceeds what the learner can absorb;
    `mean_param_lag` (in learner steps) is the staleness V-trace must
    correct — the model twin of `throughput()["onpolicy"]`."""
    frames_generated_per_s: float
    frames_trained_per_s: float
    drop_rate: float
    mean_param_lag: float
    learner_bound: bool       # True once generation exceeds consumption


def fit_paper_actor_model(hw_threads=40, target_5p8=5.8, target_2p0=2.0):
    """Solve (t_inf0, t_inf1)/t_env so the model reproduces the paper's
    measured speedups exactly: 4->40 actors = 5.8x, 40->256 = 2.0x.

    With T(n) = n/(1 + t0 + t1*min(n, cap)) below capacity H/t_env:
      4->40:  10 (1 + t0 + 4 t1) / (1 + t0 + 40 t1) = 5.8
      40->256: capacity-bound at 256 -> H (1 + t0 + 40 t1) / H = 2.0
    => t0 + 40 t1 = 1, t0 + 4 t1 = 2*5.8/10 - 1.
    """
    a = target_2p0 - 1.0                     # t0 + 40 t1
    b = 2.0 * target_5p8 / 10.0 - 1.0        # t0 + 4 t1
    t1 = (a - b) / 36.0
    t0 = b - 4.0 * t1
    m = SystemModel(1.0, t0, t1, hw_threads)
    s40 = float(m.speedup(40, 4))
    s256 = float(m.throughput(256) / m.throughput(40))
    err = np.sqrt((s40 / target_5p8 - 1) ** 2 + (s256 / target_2p0 - 1) ** 2)
    return m, float(err)


@dataclass(frozen=True)
class DeratingModel:
    """Fig 4: slowdown when accelerator compute is scaled by f (SM-disable).

    `overlap_s` is calibrated per lane at E=1; with E lanes vectorized per
    actor (the `SystemModel.with_envs` axis) each training round overlaps
    E times as much actor-side env time, so derating hides behind a larger
    window: `with_envs(8).slowdown(0.5) < slowdown(0.5)`.
    """
    overlap_s: float      # actor-side time the accelerator hides behind (E=1)
    accel_s: float        # accelerator-serial time at full compute
    envs_per_actor: int = 1   # E lanes per actor thread (scales the overlap)

    def slowdown(self, f):
        f = np.asarray(f, np.float64)
        o = self.overlap_s * self.envs_per_actor
        t_full = o + self.accel_s
        return (o + self.accel_s / f) / t_full

    def with_envs(self, envs_per_actor: int) -> "DeratingModel":
        """Same calibration, different lane count — sweep Fig 4 along E."""
        return replace(self, envs_per_actor=envs_per_actor)


def fit_paper_derating(slowdown_at_half=1.06):
    """Calibrate so that 40/80 SMs costs 6% (paper's Fig 4)."""
    # T(0.5) = o + 2a = s * (o + a)  ->  a = o (s - 1) / (2 - s)
    o = 1.0
    a = o * (slowdown_at_half - 1.0) / (2.0 - slowdown_at_half)
    return DeratingModel(overlap_s=o, accel_s=a)


def cpu_gpu_ratio(host: HostSpec, chip: ChipSpec, n_chips: int = 1):
    """The paper's metric: host hardware threads per (V100-)SM-equivalent."""
    return host.hw_threads / (sm_equivalents(chip) * n_chips)


@dataclass(frozen=True)
class RatioBreakdown:
    """Disaggregated CPU/GPU ratio: which host contributes how much, and —
    once the inference plane is sharded — how the supply divides across
    the data-parallel replicas each host's gateway feeds."""
    total: float                       # sum of per-host contributions
    sm_equivalents: float
    per_host: tuple                    # ((name, hw_threads, contribution), ..)
    per_replica: tuple = ()            # ((replica, hw_threads, ratio), ..)


def cpu_gpu_ratio_breakdown(hosts, chip: ChipSpec, n_chips: int = 1,
                            n_replicas: int = 1) -> RatioBreakdown:
    """The ratio metric once actors are disaggregated (`repro.transport`):
    the learner's accelerators are served by SEVERAL CPU hosts over the
    wire, so threads are additive across hosts and the metric decomposes
    per host. `hosts` is a sequence of `HostSpec` (repeat an entry for
    identical hosts). With one host this reduces to `cpu_gpu_ratio`.

    With `n_replicas > 1` (sharded inference, one gateway per replica) the
    breakdown ALSO decomposes per replica: hosts hash to replicas with the
    same stable ``host % n_replicas`` map the runtime uses
    (`ActorHostPool`), each replica owns a 1/N slice of the accelerator,
    and its ratio is the threads it is actually fed over that slice — so
    an uneven host count shows up as replica-level imbalance (one shard
    starved, another over-provisioned) instead of vanishing into the
    aggregate.
    """
    hosts = list(hosts)
    if not hosts:
        raise ValueError("need at least one actor host")
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    sm_eq = sm_equivalents(chip) * n_chips
    per = tuple((h.name, h.hw_threads, h.hw_threads / sm_eq) for h in hosts)
    per_replica = ()
    if n_replicas > 1:
        threads_r = [0.0] * n_replicas
        for h_id, h in enumerate(hosts):
            threads_r[h_id % n_replicas] += h.hw_threads
        sm_slice = sm_eq / n_replicas
        per_replica = tuple((r, t, t / sm_slice)
                            for r, t in enumerate(threads_r))
    return RatioBreakdown(total=sum(c for _, _, c in per),
                          sm_equivalents=sm_eq, per_host=per,
                          per_replica=per_replica)


@dataclass(frozen=True)
class Provisioning:
    frames_demand_per_s: float    # env frames/s the learner+inference consume
    threads_required: float       # host threads to supply that
    sm_equivalents: float
    ratio_required: float         # threads per SM-equivalent
    ratio_available: float
    balanced: bool


def provision(chip: ChipSpec, host: HostSpec, n_chips: int, *,
              train_flops_per_frame: float, infer_flops_per_frame: float,
              mfu: float = 0.4, replay_ratio: float = 1.0):
    """Balance actor supply vs accelerator demand for an RL workload.

    train_flops_per_frame: learner FLOPs per environment frame consumed
    (batch*unroll amortized); replay_ratio: times each frame is replayed.
    """
    accel_flops = chip.peak_bf16_flops * n_chips * mfu
    flops_per_fresh_frame = (train_flops_per_frame * replay_ratio
                             + infer_flops_per_frame)
    demand = accel_flops / flops_per_fresh_frame          # frames/s at full util
    threads = demand / host.env_steps_per_thread_s
    sm_eq = sm_equivalents(chip) * n_chips
    avail = host.hw_threads / sm_eq
    return Provisioning(
        frames_demand_per_s=demand,
        threads_required=threads,
        sm_equivalents=sm_eq,
        ratio_required=threads / sm_eq,
        ratio_available=avail,
        balanced=avail >= threads / sm_eq,
    )
