"""The paper's contribution #1: sequential-idealization bottleneck
attribution (Fig 2).

A copy of ``repro.core.bottleneck``, whose names it keeps: the port keeps
its own so that it imports nothing of the JAX package.

The paper idealizes V100 components outermost-first (DRAM bandwidth ->
DRAM latency -> memory system -> SM occupancy) in NVArchSim and attributes
the execution-time reduction of each step. The reference derives the
three roofline terms (collectives -> HBM -> occupancy) of a step from the
compiled XLA artifact. In the port nothing is compiled, so the terms are
fed from the step itself (`repro_torch.benchmarks.fig2_breakdown`):
FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` over one eager
step (it counts matmuls and convolutions, not elementwise work), bytes
counted analytically from the step's shapes (``ncu`` does not run on the
card's machine), and the occupancy derate calibrated so that the terms
add up to the device-busy time ``torch.profiler`` measures. The
attribution then works as in the reference: idealize in order, measure
the drop.
"""

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.hw import ChipSpec


@dataclass(frozen=True)
class RooflineTerms:
    """Seconds per step per chip, at nominal hardware."""
    compute_s: float      # HLO FLOPs / (chips * peak)
    memory_s: float       # HLO bytes / (chips * HBM bw)
    collective_s: float   # collective bytes / (chips * ICI bw)
    occupancy: float = 1.0  # MXU utilization derate on the compute term

    @property
    def effective_compute_s(self):
        return self.compute_s / max(self.occupancy, 1e-9)

    def total(self, overlap: str = "serial") -> float:
        t = (self.effective_compute_s, self.memory_s, self.collective_s)
        return max(t) if overlap == "perfect" else sum(t)

    def dominant(self) -> str:
        terms = {"compute": self.effective_compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


def terms_from_hlo(flops: float, hbm_bytes: float, collective_bytes: float,
                   n_chips: int, chip: ChipSpec, occupancy: float = 1.0
                   ) -> RooflineTerms:
    """flops/bytes are PER-CHIP quantities (cost_analysis on the SPMD module
    reports per-partition values); collective_bytes per chip over its links."""
    return RooflineTerms(
        compute_s=flops / chip.peak_bf16_flops,
        memory_s=hbm_bytes / chip.hbm_bandwidth,
        collective_s=collective_bytes / (chip.ici_bandwidth * chip.ici_links),
        occupancy=occupancy,
    )


def sequential_idealization(terms: RooflineTerms, overlap: str = "serial"
                            ) -> Dict[str, float]:
    """Fig-2-style attribution. Idealize collective -> memory -> occupancy;
    the residual is 'math' (true compute at peak). Returns fractions of the
    baseline step time, summing to 1."""
    t0 = terms.total(overlap)

    def total(collective, memory, occupancy):
        c = terms.compute_s / max(occupancy, 1e-9)
        vals = (c, memory, collective)
        return max(vals) if overlap == "perfect" else sum(vals)

    t1 = total(0.0, terms.memory_s, terms.occupancy)       # ideal interconnect
    t2 = total(0.0, 0.0, terms.occupancy)                  # + ideal memory
    t3 = total(0.0, 0.0, 1.0)                              # + full occupancy
    return {
        "collective": (t0 - t1) / t0,
        "memory": (t1 - t2) / t0,
        "occupancy": (t2 - t3) / t0,
        "math": t3 / t0,
        "baseline_s": t0,
    }


def paper_fig2_reference() -> Dict[str, float]:
    """The paper's measured V100 attribution for SEED-RL/R2D2 (Fig 2)."""
    return {"math": 0.57, "occupancy": 0.15, "memory": 0.12, "other": 0.16}
