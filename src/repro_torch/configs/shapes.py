"""The assigned input-shape set (applies to every architecture).

A copy of ``repro.configs.shapes``: the port keeps its own so that it
imports nothing of the JAX package.
"""

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Sub-quadratic archs only, per assignment (see DESIGN.md §6 for skips).
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")


def shape_cells(arch: str):
    """The (shape) list that applies to `arch` — 40 nominal cells minus the
    documented long_500k skips for full-attention archs."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells
