"""Hardware model constants for the provisioning and bottleneck analysis.

The port's counterpart of ``repro.hw``. The paper's V100 and DGX-1
constants are kept with the reference's values, so that Figs 2-4 can be
expressed in the paper's own units. In place of the reference's TPU v5e
and its host, the deployment target is one NVIDIA H100 SXM5 80 GB
(`H100_SXM`) in the machine it sits in (`h100_host`, built at run time).
"""

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float   # FLOP/s per chip
    hbm_bandwidth: float     # bytes/s per chip
    ici_bandwidth: float     # bytes/s per link
    ici_links: int           # links per chip participating in a collective
    hbm_bytes: float         # HBM capacity per chip
    idle_power_w: float      # power at ~0 utilization
    peak_power_w: float      # power at full utilization


# The deployment target, from NVIDIA's H100 Tensor Core GPU datasheet (SXM5
# 80 GB column; dense rates, without sparsity): bf16 tensor cores, HBM3,
# NVLink 4 (18 links, 900 GB/s both directions together), the 700 W
# maximum power. idle_power_w is read on the card: `nvidia-smi
# --query-gpu=power.draw` with nothing running read 72.14, 70.92 and
# 71.00 W on an NVIDIA H100 80GB HBM3 with a 700.00 W power limit.
H100_SXM = ChipSpec(
    name="h100-sxm5-80gb",
    peak_bf16_flops=989.4e12,
    hbm_bandwidth=3.35e12,
    ici_bandwidth=25e9,          # NVLink 4 per link, per direction
    ici_links=18,
    hbm_bytes=80e9,
    idle_power_w=71.0,
    peak_power_w=700.0,
)

# The same datasheet's fp32 rate outside the tensor cores: the rate of a
# step computed in fp32 with TF32 off, as the port's R2D2 learner is.
H100_FP32_FLOPS = 67e12

# The paper's accelerator (for fig2/fig3/fig4 calibration in paper units).
V100 = ChipSpec(
    name="v100-sxm2",
    peak_bf16_flops=125e12,      # tensor-core fp16
    hbm_bandwidth=900e9,
    ici_bandwidth=25e9,          # NVLink per-direction per-link
    ici_links=6,
    hbm_bytes=16e9,
    idle_power_w=70.0,           # the paper reports ~70 W at low utilization
    peak_power_w=300.0,
)


@dataclass(frozen=True)
class HostSpec:
    """The CPU side of the system — the paper's primary bottleneck."""
    name: str
    hw_threads: int
    env_steps_per_thread_s: float  # sustainable env interactions /s /thread


# The paper's host: 20-core Xeon E5-2698 v4, 40 hardware threads.
DGX1_HOST = HostSpec(name="xeon-e5-2698v4", hw_threads=40,
                     env_steps_per_thread_s=1500.0)


def h100_host() -> HostSpec:
    """The machine the card sits in, as this process sees it: the hardware
    threads it may run on, and the paper's 1500 env steps a thread a
    second (the reference assumes the same for its TPU host)."""
    return HostSpec(name="h100-host", hw_threads=len(os.sched_getaffinity(0)),
                    env_steps_per_thread_s=1500.0)


def sm_equivalents(chip: ChipSpec, reference_sm_flops: float = 125e12 / 80) -> float:
    """Express a chip's compute as 'V100-SM equivalents'.

    The paper's CPU/GPU ratio counts V100 SMs; to compare provisioning across
    accelerator generations we normalize by per-SM V100 tensor throughput.
    """
    return chip.peak_bf16_flops / reference_sm_flops
