"""Plain PyTorch oracles for the kernels (the allclose ground truth).

Mirrors ``repro.kernels.ref``: every product is taken in fp32 after a cast,
as the TPU kernels do. On the card these are the yardsticks the CUDA
kernels are held to; on the CPU they are what the kernel wrappers run.
"""

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale=None, causal=True, window=0, softcap=None):
    """q (BH, S, D); k, v (BH, S_kv, D). Mirrors
    kernels.flash_attention.flash_attention, whose k and v share q's S; a
    length of their own (the encoder-decoder's cross-attention) comes
    unmasked, and the masks here are then defined on row and column index
    alone."""
    bh, s, d = q.shape
    s_kv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s_kv, device=q.device)[None, :]
    ok = torch.ones((s, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= cols <= rows
    if window:
        ok &= (rows - cols) < window
    logits = torch.where(ok, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, scale=None, softcap=None, return_lse=False):
    """q (B,H,D); k,v (B,S,H,D); lengths (B,) valid prefix lengths. With
    `softcap`, the scaled logits are capped before the mask, as the JAX
    model's decode (``attend_ref``) does. Returns (B,H,D) in q's dtype;
    with `return_lse`, (out (B,H,D) fp32, the masked logits' log-sum-exp
    (B,H) fp32), so that a partial is rounded only after its combine. A
    length-0 row's output is the mean of all S rows of v, its log-sum-exp
    -1e30 + log S, which is -1e30 in fp32."""
    b, s, h, d = k.shape
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    ok = torch.arange(s, device=q.device)[None, None, :] < lengths[:, None, None]
    logits = torch.where(ok, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", w, v.float())
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out.to(q.dtype)


def ssd_ref(x, dt, a, b, c, h0=None):
    """Sequential SSD recurrence (the definitional oracle).

    x (B,S,H,P); dt (B,S,H) post-softplus; a (H,) negative;
    b,c (B,S,H,N) (groups already expanded). Returns (y, final_state)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    state = h0 if h0 is not None else torch.zeros((bs, h, p, n), dtype=torch.float32,
                                                  device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a)                                  # (B,H)
        upd = torch.einsum("bhp,bhn,bh->bhpn", x[:, t].float(), b[:, t].float(), dt[:, t])
        state = da[..., None, None] * state + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", c[:, t].float(), state))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros(x.shape, dtype=torch.float32)
    return y.to(x.dtype), state


def rglru_ref(a, b, h0=None):
    """Sequential linear recurrence h_t = a_t h_{t-1} + b_t. a,b (B,S,W).
    Returns (the fp32 h sequence (B,S,W), the last h (B,W))."""
    bs, s, w = a.shape
    h = (h0 if h0 is not None else torch.zeros((bs, w), device=a.device)).float()
    hs = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
