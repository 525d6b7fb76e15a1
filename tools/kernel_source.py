"""Copies of the port's CUDA sources for the variant tools: a source with
its ``csrc/*.cuh`` headers pasted in, and a source changed by patches."""

import re
import sys
from pathlib import Path

sys.path.append(str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.build import CSRC, INCLUDE  # noqa: E402


def standalone(text: str) -> str:
    """`text`, the source of a csrc/*.cu, with each csrc/*.cuh it includes
    (directly or through another header) pasted in at its first include,
    so that a copy compiles outside csrc/ and a patch can match the
    headers' code too."""
    seen = set()

    def paste(match):
        name = match.group(1)
        if name in seen:
            return ""
        seen.add(name)
        header = re.sub(r"^#pragma once\n", "", (CSRC / name).read_text(), flags=re.M)
        return INCLUDE.sub(paste, header)
    return INCLUDE.sub(paste, text)


def patched(src: str, patches, what: str) -> str:
    """`src` with each (regex, replacement) of `patches` applied; raises if
    a regex matches nowhere (`what` names the patch in the message)."""
    for pattern, new in patches:
        src, n = re.subn(pattern, new, src)
        if n == 0:
            raise RuntimeError(f"{what}: {pattern!r} is not in the source or its headers")
    return src
