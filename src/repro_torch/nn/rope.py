"""Rotary position embeddings (half-split convention, fp32 rotation)."""

import torch


def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) integer."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                  # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    # broadcast over the head axis if present
    for _ in range(x.dim() - angles.dim() - 1):
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
