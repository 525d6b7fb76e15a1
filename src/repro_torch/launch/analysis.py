"""A dry-run step's report: roofline terms and memory of one rank.

The port's counterpart of ``repro.launch.analysis``. The reference reads a
compiled XLA artifact (cost_analysis, memory_analysis and an HLO scan);
the port runs the step eagerly on meta shards under ``op_cost.OpCounter``
and reads the counts. Conventions as the reference's: FLOPs and bytes are
per rank; collective bytes per rank over its links, an all-reduce counted
twice, an all-gather by its gathered output, a reduce-scatter by its
unscattered input.

The terms come from ``core.bottleneck.terms_from_hlo`` with the H100's
published peaks (``hw.H100_SXM``: bf16 tensor-core FLOP/s, HBM3 bytes/s,
18 NVLink links of 25 GB/s a direction). They are modelled from the spec,
not measured. A mesh axis of 16 ranks spans two 8-GPU nodes, whose link is
slower than NVLink, so there the collective term is a lower bound.
"""

from repro_torch.core.bottleneck import terms_from_hlo
from repro_torch.hw import H100_SXM


def local_bytes(tree) -> int:
    """Bytes of one rank's shards of every tensor in `tree` (a DTensor's
    local shard, a plain tensor whole; modules by their parameters)."""
    import torch
    from torch import nn
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import tree_leaves_with_keys

    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    total = 0
    for _, x in tree_leaves_with_keys(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def analyze_step(counts: dict, *, argument_bytes: int, output_bytes: int, alias_bytes: int,
                 n_chips: int, chip=H100_SXM, occupancy: float = 1.0) -> dict:
    """Roofline terms and memory of one rank from `counts`
    (``OpCounter.report()``) and the step's argument, output and aliased
    (donated and written in place) bytes a rank. The reference's keys, plus
    the collective bytes by kind and the FLOPs by operation."""
    flops = counts["flops"]
    hbm_bytes = argument_bytes + output_bytes
    temp = counts["peak_temp_bytes"]
    terms = terms_from_hlo(flops, hbm_bytes, counts["collective_bytes"], n_chips, chip,
                           occupancy)
    return {
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": hbm_bytes,
        "collective_bytes_per_chip": counts["collective_bytes"],
        "collective_count": counts["collective_count"],
        "collectives": counts["collectives"],
        "flops_by_op": counts["flops_by_op"],
        "chip": chip.name,
        "terms": terms,
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias_bytes,
            "total_bytes": argument_bytes + output_bytes + temp - alias_bytes,
        },
    }
