"""Actor: environment-interaction loop (the paper's bottleneck resource).

A copy of ``repro.core.actor`` (numpy only) with its imports taken from
the port, so that it imports nothing of the JAX package.

Each actor owns a *vector* of E environment lanes
(`repro_torch.envs.vector`), queries the central inference server for a whole lane-batch of actions in
ONE round-trip, and emits fixed-length per-lane unrolls to the trajectory
sink (replay buffer or on-policy queue). Actors are plain threads: in the
paper's terms, each consumes one CPU hardware thread while stepping — so
E > 1 multiplies the env-frames supplied per thread by amortizing both the
inference round-trip and (for `JaxVectorEnv`) the Python dispatch over E
lanes, the CuLE-style design point the paper's CPU/GPU-ratio metric favors.
"""

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.inference import ReplyError
from repro_torch.envs.vector import make_vector_env
from repro_torch.telemetry.tracer import next_trace_seq


# canonical per-lane dtypes; keys outside this map pass through unchanged
_LANE_DTYPES = {"actions": np.int32, "rewards": np.float32,
                "dones": np.float32, "behavior_logprobs": np.float32}


def flush_lane_unrolls(stacked, sink: Callable, extra=None):
    """Split a (T, E, ...) trajectory dict into E per-lane records — the
    single schema ALL rollout backends (host actors, device
    `RolloutWorker`s, and wire TRAJ frames) feed the trajectory sink.
    Any key in `stacked` is split along the lane axis (on-policy rollouts
    add ``behavior_logprobs``); ``extra`` entries (e.g. the behavior
    ``param_version`` stamp) are copied verbatim into every lane record."""
    for lane in range(stacked["actions"].shape[1]):
        rec = {}
        for k, v in stacked.items():
            lane_v = v[:, lane]
            dtype = _LANE_DTYPES.get(k)
            rec[k] = lane_v if dtype is None else lane_v.astype(dtype)
        if extra:
            rec.update(extra)
        sink(rec)


def account_episode_ends(rewards, dones, episode_returns, returns) -> int:
    """Fold one vector step's (E,) rewards/dones into the per-lane running
    returns; appends finished-episode returns and returns how many ended."""
    episode_returns += rewards
    ended = np.flatnonzero(dones)
    for lane in ended:
        returns.append(float(episode_returns[lane]))
        episode_returns[lane] = 0.0
    return len(ended)


class Actor:
    def __init__(self, actor_id: int, env, server, sink: Callable,
                 unroll: int, num_envs: int = 1, seed: Optional[int] = None,
                 version_source: Optional[Callable] = None,
                 with_logprobs: bool = False, stamp_records: bool = False,
                 telemetry=None):
        """``version_source() -> int`` is the learner's published param
        version: when set, each unroll is stamped with the version current
        at its FIRST step (the behavior version) and the actor accumulates
        ``param_lag_total`` — the host-side analogue of the device
        worker's on-policy lag counter. ``with_logprobs=True`` switches
        the reply convention to the on-policy ``(E, 2) float32 [action,
        behavior_logprob]`` rows (see `onpolicy.SamplingPolicy`);
        ``stamp_records=True`` additionally writes the ``param_version``
        stamp into the sink records themselves (the on-policy queue's
        admission key — replay records stay byte-identical without it)."""
        if stamp_records and version_source is None:
            raise ValueError(
                "stamp_records=True requires a version_source: unstamped "
                "records read as lag-0 fresh, silently disabling the "
                "on-policy queue's staleness admission")
        self.actor_id = actor_id
        self.vec = make_vector_env(
            env, num_envs, seed=actor_id if seed is None else seed)
        self.num_envs = self.vec.num_envs
        self.server = server
        self.sink = sink                     # sink(traj_dict)
        self.unroll = unroll
        self.version_source = version_source
        self.with_logprobs = with_logprobs
        self.stamp_records = stamp_records
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.iterations = 0                  # vector steps (1 per round-trip)
        self.frames = 0                      # env frames = iterations * E
        self.episodes = 0
        self.episode_returns = np.zeros(self.num_envs, np.float64)
        self.returns = []
        self.unrolls = 0                     # unroll flushes (E records each)
        self.param_lag_total = 0             # sum over unrolls of version lag
        self.error: Optional[str] = None     # server/transport death, surfaced
        # telemetry is opt-in; the loop hoists these into locals and the
        # disabled path is a single `is None` branch per use
        self._tracer = (telemetry.tracer
                        if telemetry is not None and telemetry.enabled
                        else None)
        self._h_rtt = (telemetry.metrics.histogram("wire/rtt_s")
                       if telemetry is not None else None)
        # ops plane (None without a full Telemetry bundle): the loop
        # heartbeats, and a poison reply files a postmortem
        self._health = getattr(telemetry, "health", None)
        self._flightrec = getattr(telemetry, "flightrec", None)

    @property
    def steps(self):
        """Total env frames across lanes (back-compat alias)."""
        return self.frames

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def join(self, timeout=5.0):
        if self._thread:
            self._thread.join(timeout=timeout)

    def _version(self) -> int:
        return self.version_source() if self.version_source else 0

    def _fresh_buf(self):
        buf = {"obs": [], "actions": [], "rewards": [], "dones": []}
        if self.with_logprobs:
            buf["behavior_logprobs"] = []
        return buf

    def _loop(self):
        hb = self._health
        hb_name = f"actor/{self.actor_id}"
        if hb is not None:
            # the reply-retry loop wakes at least every 1 s even when a
            # replica is wedged, so a 5 s deadline isolates blame: the
            # wedged REPLICA goes stale, its blocked actors stay healthy
            hb.register(hb_name, stale_after_s=5.0)
        try:
            self._run()
        finally:
            if hb is not None:
                hb.unregister(hb_name)

    def _run(self):
        E = self.num_envs
        tr = self._tracer
        h_rtt = self._h_rtt
        hb = self._health
        hb_name = f"actor/{self.actor_id}"
        obs = self.vec.reset()                       # (E, ...)
        # lanes step in lockstep, so one batched accumulator suffices: O(1)
        # appends per iteration, split into per-lane unrolls only at flush
        buf = self._fresh_buf()
        # behavior version of the unroll being accumulated = version at its
        # first step (the most stale params any of its actions used)
        unroll_version = self._version()
        while not self._stop.is_set():
            if hb is not None:
                hb.beat(hb_name)
            # ONE request per iteration; on timeout keep waiting on the SAME
            # reply — resubmitting would advance the server's per-lane
            # recurrent state twice for one observation. Fail fast instead
            # of waiting forever: a stopped/dead server drains pending
            # requests with a poison `ReplyError`, and `server.error` is
            # the backstop for a request that died in-flight inside a batch
            if tr is not None:
                # fresh stitch id per round-trip: every span this request
                # touches (here, the gateway, the replica) shares it, so
                # the trace viewer renders one connected flow. The kwarg
                # is only passed when tracing so bare test doubles that
                # implement the two-arg signature keep working.
                seq = next_trace_seq()
                t0_ns = time.perf_counter_ns()
                reply = self.server.submit_batch(
                    self.actor_id, obs, trace_seq=seq)
            else:
                seq = 0
                t0_ns = time.perf_counter_ns() if h_rtt is not None else 0
                reply = self.server.submit_batch(self.actor_id, obs)
            actions = None
            while not self._stop.is_set():
                try:
                    result = reply.get(timeout=1.0)
                except queue.Empty:
                    if hb is not None:
                        # still alive, just waiting on a reply — without
                        # this beat a wedged replica would mark its
                        # blocked actors stale too and blur the blame
                        hb.beat(hb_name)
                    err = getattr(self.server, "error", None)
                    if err is not None:
                        self.error = err
                        break
                    continue
                if isinstance(result, ReplyError):
                    # a poison that lands AFTER our own stop() is just the
                    # server draining our in-flight request during normal
                    # shutdown — not an error worth surfacing
                    if not self._stop.is_set():
                        self.error = result.message
                        if self._flightrec is not None:
                            self._flightrec.trigger(
                                "actor_poisoned",
                                f"actor {self.actor_id}: {result.message}")
                    break
                actions = np.asarray(result)         # (E,) or (E, 2)
                break
            if actions is None:
                break
            if tr is not None or h_rtt is not None:
                dur_ns = time.perf_counter_ns() - t0_ns
                if tr is not None:
                    tr.record("actor/inference_rtt", t0_ns, dur_ns, seq=seq,
                              args={"lanes": E})
                if h_rtt is not None:
                    h_rtt.record(dur_ns * 1e-9)
            logprobs = None
            if self.with_logprobs:
                # on-policy reply rows: [action, behavior_logprob]
                if actions.ndim != 2 or actions.shape[-1] != 2:
                    self.error = (
                        f"with_logprobs=True needs (E, 2) [action, logprob] "
                        f"replies, got shape {actions.shape} — use an "
                        f"on-policy policy_step (onpolicy.SamplingPolicy)")
                    break
                logprobs = actions[:, 1].astype(np.float32)
                actions = actions[:, 0].astype(np.int32)
            nobs, rewards, dones = self.vec.step(actions)
            self.iterations += 1
            self.frames += E
            buf["obs"].append(obs)
            buf["actions"].append(actions)
            buf["rewards"].append(rewards)
            buf["dones"].append(dones)
            if logprobs is not None:
                buf["behavior_logprobs"].append(logprobs)
            self.episodes += account_episode_ends(
                rewards, dones, self.episode_returns, self.returns)
            if len(buf["actions"]) >= self.unroll:
                stacked = {k: np.stack(v) for k, v in buf.items()}  # (T, E, ..)
                extra = None
                if self.version_source is not None:
                    self.param_lag_total += max(
                        self._version() - unroll_version, 0)
                    self.unrolls += 1
                    if self.stamp_records:
                        extra = {"param_version": np.int64(unroll_version)}
                flush_lane_unrolls(stacked, self.sink, extra=extra)
                buf = self._fresh_buf()
                unroll_version = self._version()
            obs = nobs
