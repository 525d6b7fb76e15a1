"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: there is
no silent fallback, so a run that meant to measure the GPU cannot quietly
measure the host instead.
"""

import torch


def resolve(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def dtype_of(name) -> torch.dtype:
    """'float32' / 'bfloat16' / torch.dtype -> torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def seeded_generator(dev: torch.device, seed: int):
    """A torch.Generator on `dev` seeded by `seed`; None on the meta device,
    where parameters take a shape and no values (the dry run)."""
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)
