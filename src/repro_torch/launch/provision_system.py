"""The paper's contribution as a tool: given a workload and a candidate
system, report the CPU/GPU ratio, whether actor supply can match learner
demand, and the Fig-3/Fig-4 curves for the configuration.

The port's counterpart of ``examples/provision_system.py``, with the same
sections and rows; where the reference reports a TPU v5e-8, this reports
this machine with one H100 (`h100_host`, `H100_SXM`). It only computes,
so it needs no card.

    PYTHONPATH=src python -m repro_torch.launch.provision_system
"""

from repro_torch.core.provisioning import (cpu_gpu_ratio, cpu_gpu_ratio_breakdown,
                                           fit_paper_actor_model, fit_paper_derating,
                                           provision)
from repro_torch.hw import DGX1_HOST, H100_SXM, V100, h100_host

WORKLOADS = (("r2d2-atari (2M conv-LSTM)", 2e6),
             ("internvl2-1b policy", 0.9e9),
             ("qwen3-moe-30b-a3b (3B active)", 3.3e9))


def report(host=None):
    """The tool's lines for this machine (`host` defaults to `h100_host()`)."""
    host = host or h100_host()
    out = ["== the paper's systems, through the ratio metric",
           f"   DGX-1    : {cpu_gpu_ratio(DGX1_HOST, V100, 8):.4f} "
           f"(paper: 1/16 = {1/16:.4f})",
           f"   H100 host: {cpu_gpu_ratio(host, H100_SXM, 1):.4f} "
           f"({host.hw_threads} host threads, one H100)",
           "   rule     : ratio >= 1 for balanced RL training (Conclusion 3)"]

    out.append("\n== actor-scaling model calibrated to the paper (Fig 3)")
    model, err = fit_paper_actor_model()
    out.append(f"   fit residual {err:.3f}; t_inf0/t_env={model.t_inf0:.2f}, "
               f"t_inf1/t_env={model.t_inf1:.4f}")
    for n in (4, 40, 256):
        out.append(f"   {n:4d} actors -> speedup {float(model.speedup(n, 4)):.2f}x")

    out.append("\n== the four rollout design points (40 actors x 8 lanes, model)")
    m8 = model.with_envs(8)
    out += [f"   per-step host    : {float(model.throughput(40)):8.1f} frames/s",
            f"   vectorized host  : {float(m8.throughput(40)):8.1f} frames/s",
            f"   networked actors : {float(m8.with_network(0.2).throughput(40)):8.1f}"
            f" frames/s (socket transport; RTT=0.2 t_env units)",
            f"   device-resident  : {float(m8.with_device().throughput(40)):8.1f}"
            f" frames/s (fused unroll; bound by scan throughput, not threads)"]

    out.append("\n== disaggregation: the ratio knob the transport unlocks")
    for hosts in (1, 4, 16):
        t = float(m8.with_network(0.2, n_hosts=hosts).throughput(40 * hosts))
        b = cpu_gpu_ratio_breakdown([DGX1_HOST] * hosts, V100, 8)
        out.append(f"   {hosts:2d} actor hosts x 40 threads: ratio {b.total:.3f}, "
                   f"{t:10.1f} frames/s at {40 * hosts} actors")

    out.append("\n== sharding the inference plane (SeedSystem num_replicas /")
    out.append("   num_gateways; model point: with_sharded, E=1 to isolate it)")
    m_net = model.with_network(0.2, n_hosts=4)
    base = float(m_net.throughput(160))
    for R in (1, 2, 4, 8):
        t = float(m_net.with_sharded(R).throughput(160))
        out.append(f"   {R} replica(s): {t:10.1f} frames/s ({t / base:.2f}x) — batch-linear "
                   f"latency / {R}, t_inf0 floor remains")
    b = cpu_gpu_ratio_breakdown([DGX1_HOST] * 3, V100, 8, n_replicas=2)
    out.append("   per-replica ratio, 3 hosts hashed across 2 replicas "
               "(imbalance is visible, not averaged away):")
    for r, threads, ratio in b.per_replica:
        out.append(f"     replica {r}: {threads:.0f} threads over a 1/2 "
                   f"accelerator slice -> ratio {ratio:.3f}")

    out += ["\n== the ALGORITHMIC operating point (SeedSystem algo='vtrace'):",
            "   on-policy drop rate vs actor count (SystemModel.onpolicy_point",
            "   — learner: 8-unroll x 20-step batches, 8 t_env-units/step)"]
    for n in (16, 40, 128, 256):
        p = model.onpolicy_point(n, learner_step_s=8.0, batch_size=8,
                                 unroll=20, queue_capacity=64)
        knee = "LEARNER-BOUND" if p.learner_bound else "balanced"
        out.append(f"   {n:4d} actors: {p.frames_generated_per_s:6.1f} gen -> "
                   f"{p.frames_trained_per_s:5.1f} trained frames/s, "
                   f"drop {p.drop_rate:4.0%}, param lag {p.mean_param_lag:4.1f} "
                   f"steps ({knee})")
    out += ["   rule: past the knee, actors buy drop rate, not learning —",
            "   replay (r2d2) decouples the planes; on-policy re-couples them."]

    out.append("\n== accelerator derating (Fig 4), swept along E like Fig 3")
    der = fit_paper_derating()
    for sm in (80, 40, 8, 2):
        out.append(f"   {sm:3d}/80 SMs -> slowdown {float(der.slowdown(sm / 80)):.2f}x"
                   f"  (E=8: {float(der.with_envs(8).slowdown(sm / 80)):.2f}x)")

    out.append(f"\n== provisioning RL workloads on this machine ({host.hw_threads} threads, "
               f"one H100)")
    for name, n_params in WORKLOADS:
        p = provision(H100_SXM, host, 1, train_flops_per_frame=6 * n_params,
                      infer_flops_per_frame=2 * n_params, mfu=0.4)
        verdict = "balanced" if p.balanced else \
            f"UNDER-PROVISIONED (needs {p.threads_required:.0f} threads)"
        out.append(f"   {name:32s} demand {p.frames_demand_per_s:10.0f} frames/s "
                   f"-> {verdict}")
    out.append("\nImplication (paper Conclusion 2/3): small policies need orders-"
               "of-magnitude more CPU per chip; LLM policies flip the balance.")
    return out


def main():
    lines = report()
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
