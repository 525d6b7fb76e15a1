"""Serving entry points: prefill and decode (serve_step) builders.

serve_step is the SEED central-inference step at LM scale: one new token
for every sequence in the batch against the KV cache. PyTorch runs eagerly,
so the builders return plain functions (no jit); they run under
``torch.no_grad``. Under a sharding context the last position's logits
are gathered whole before the argmax (``to_plain``), so the next tokens
are a plain tensor on every rank, as the serving loop reads them.
"""

import torch

from repro_torch.sharding.ctx import to_plain


def make_serve_step(bundle):
    @torch.no_grad()
    def serve_step(params, tokens_t, cache):
        out, cache = bundle.decode_step(params, tokens_t, cache)
        next_tok = torch.argmax(to_plain(out.logits[:, -1]), dim=-1).to(torch.int32)
        return next_tok[:, None], cache
    return serve_step


def make_prefill(bundle, max_len, dtype=torch.bfloat16):
    @torch.no_grad()
    def prefill(params, batch):
        out, cache = bundle.prefill(params, batch, max_len=max_len, dtype=dtype)
        next_tok = torch.argmax(to_plain(out.logits[:, -1]), dim=-1).to(torch.int32)
        return next_tok[:, None], cache
    return prefill


def greedy_generate(bundle, params, batch, steps, max_len, dtype=torch.bfloat16):
    """Host loop driving prefill + serve_step (examples / tests). -> (B, steps)."""
    prefill = make_prefill(bundle, max_len, dtype)
    step = make_serve_step(bundle)
    tok, cache = prefill(params, batch)
    toks = [tok]
    for _ in range(steps - 1):
        tok, cache = step(params, tok, cache)
        toks.append(tok)
    return torch.cat(toks, dim=1)
