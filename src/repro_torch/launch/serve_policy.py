"""Central-inference serving at LM scale (SEED's design applied to an LLM
policy): batched prefill, then N clients decode token by token through the
``InferenceServer``, which batches their requests into one decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve_policy --arch qwen3-14b
    PYTHONPATH=src python -m repro_torch.launch.serve_policy --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve_policy --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve_policy --arch gemma2-9b
    PYTHONPATH=src python -m repro_torch.launch.serve_policy --arch qwen3-moe-30b-a3b
    PYTHONPATH=src python -m repro_torch.launch.serve_policy --arch deepseek-v3-671b
    PYTHONPATH=src python -m repro_torch.launch.serve_policy --arch seamless-m4t-large-v2

runs the reduced config (``smoke_config``) of a ported arch on the card
(``--arch`` takes every LM of ``configs.registry.list_archs``: also
starcoder2-15b, qwen2.5-32b, internvl2-1b, qwen3-moe-30b-a3b,
deepseek-v3-671b and seamless-m4t-large-v2); ``--device cpu`` runs the
plain PyTorch path. ``serve(mesh=, rules=)`` serves with the params as
DTensors on a device mesh under the rules.
``chip_smoke.py`` serves them at their published widths in bf16 by calling
``serve`` directly: every arch at full depth but deepseek-v3-671b, whose
bf16 weights (about 1.3 TB) do not fit one card, so it is served at its
full width cut to 4 layers (its 3 first dense layers and 1 MoE layer, with
the MTP block built). The dense and MoE LMs decode against a KV cache of
``max_len`` slots (gemma2's local layers a ring of min(``max_len``,
window) slots; deepseek's MLA a compressed cache of kv_lora_rank +
qk_rope_head_dim values a token); mamba2-2.7b carries a fixed-size state
per layer and ignores ``max_len``; recurrentgemma-2b carries a state per
recurrent layer and a ring per local-attention layer. internvl2-1b is
served on text prompts: its frontend's patch embeddings are not part of
a serving request, as in the JAX package's serving example. seamless-m4t-large-v2, the
encoder-decoder, is served on seeded frames: its prefill batch carries
frame embeddings (clients, frontend_tokens, frontend_dim), drawn from the
seed after the prompts, which the encoder reads once; the decoder's
cross-attention K/V sit in the cache, so decode steps carry tokens only.
An MoE routes
the whole batch at once, as the reference's serve step does, so with
capacity drops a client's tokens depend on the other clients in its batch.

Every client gets its own seeded prompt. The server hands out slots in
first-sight order, so the slots are claimed for clients 0..N-1 before the
prefill, and prompt row `slot_ids(cid)` is client cid's (and frame row, for
the encoder-decoder). A decode step
advances every row of the shared cache (one index for the batch, as in the
JAX serve step); rows whose client was not in the batch are fed the token
they last produced.
"""

import argparse
import contextlib
import functools
import json
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.configs.registry import list_archs, make_model, smoke_config
from repro_torch.core.inference import InferenceServer, ReplyError
from repro_torch.device import dtype_of, resolve
from repro_torch.launch.serve import make_prefill, make_serve_step
from repro_torch.sharding.ctx import is_dtensor, sharding_ctx
from repro_torch.sharding.param import distribute_module

REPLY_TIMEOUT_S = 300.0   # a client gives up on a reply after this long


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, *, clients=4, prompt_len=8, tokens=12, max_len=64,
          device="cuda", seed=0, deadline_ms=10.0, params=None, mesh=None, rules=None):
    """Prefill `clients` seeded prompts, then decode `tokens` tokens per
    client through the InferenceServer. Params (made from `seed` unless
    given) and the KV cache take `cfg.compute_dtype`. Returns a dict of the
    tokens each client received, the first tokens from prefill, the
    prompts, the encoder-decoder's frames (else None), each in client
    order, the server's stats and host-clock times (prefill_s, decode_s)
    that end in a device sync.

    With `mesh` (a ``DeviceMesh``) and `rules`, the params are distributed
    onto the mesh by the rules (unless they already are DTensors) and the
    prefill and every decode step run under ``sharding_ctx(mesh, rules)``,
    entered in the thread that runs them (the server's for decode): the
    cache is made of DTensors and the kernels run on each rank's shards."""
    dev = resolve(device)
    dt = dtype_of(cfg.compute_dtype)
    if prompt_len + clients * tokens > max_len:
        # a decode step may serve only part of the clients, so up to
        # clients * tokens steps can run; each writes one cache slot
        raise ValueError(f"max_len {max_len} < prompt_len {prompt_len} + "
                         f"clients*tokens {clients * tokens}")
    bundle = make_model(cfg)
    if params is None:
        params = bundle.init(seed, device=dev, dtype=dt)
    ctx = contextlib.nullcontext
    if mesh is not None:
        if not any(is_dtensor(p) for p in params.parameters()):
            distribute_module(params, mesh, rules)
        ctx = functools.partial(sharding_ctx, mesh, rules)
    prefill = make_prefill(bundle, max_len=max_len, dtype=dt)
    sstep = make_serve_step(bundle)

    state = {}

    def policy_step(obs, ids):
        # one replica, so one caller at a time
        ids_t = torch.as_tensor(ids, device=dev).long()
        t = state["tok"].clone()
        t[ids_t, 0] = torch.as_tensor(obs[:, 0], device=dev).to(t.dtype)
        with ctx():
            state["tok"], state["cache"] = sstep(params, t, state["cache"])
        return state["tok"][ids_t, 0].cpu().numpy()   # syncs the device

    server = InferenceServer(policy_step, max_batch=clients,
                             deadline_ms=deadline_ms)
    slots = [int(server.slot_ids(cid, 1)[0]) for cid in range(clients)]
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (clients, prompt_len), dtype=np.int64)
    rows = np.empty_like(prompts)
    rows[slots] = prompts
    batch = {"tokens": torch.as_tensor(rows, device=dev)}
    frames = None
    if cfg.family == "encdec":
        frames = rng.standard_normal((clients, cfg.frontend_tokens, cfg.frontend_dim),
                                     dtype=np.float32)
        frame_rows = np.empty_like(frames)
        frame_rows[slots] = frames
        batch["frontend"] = torch.as_tensor(frame_rows, device=dev)

    t0 = time.perf_counter()
    with ctx():
        tok, cache = prefill(params, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    state.update(tok=tok, cache=cache)
    first = tok[:, 0].cpu().numpy()

    results = {cid: [] for cid in range(clients)}
    errors = []

    def client(cid):
        last = int(first[slots[cid]])
        for _ in range(tokens):
            try:
                reply = server.submit(cid, np.array([last], np.int32)).get(
                    timeout=REPLY_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"client {cid}: no reply in {REPLY_TIMEOUT_S} s")
                return
            if isinstance(reply, ReplyError):
                errors.append(reply.message)
                return
            last = int(reply)
            results[cid].append(last)

    server.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _sync(dev)
    decode_s = time.perf_counter() - t0
    server.stop()
    if errors or server.error:
        raise RuntimeError(f"serving failed: {server.error or errors[0]}")
    return {"tokens": results, "first": {c: int(first[s]) for c, s in enumerate(slots)},
            "prompts": prompts, "frames": frames, "stats": server.stats, "prefill_s": prefill_s,
            "decode_s": decode_s, "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-14b", choices=list_archs())
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, prompt_len = smoke_config(args.arch), 8
    out = serve(cfg, clients=args.clients, prompt_len=prompt_len,
                tokens=args.tokens,
                max_len=prompt_len + args.clients * args.tokens,
                device=args.device)
    total = args.clients * args.tokens
    st = out["stats"]
    print(f"== {cfg.name} (reduced, {cfg.compute_dtype}, {out['device']}): "
          f"{total} tokens for "
          f"{args.clients} clients in {out['decode_s']:.3f}s "
          f"({total / out['decode_s']:.1f} tok/s), prefill {out['prefill_s']:.3f}s")
    print(f"   batches={st['batches']} occupancy="
          f"{st['batch_occupancy'] / max(st['batches'], 1):.2f}")
    for cid, toks in out["tokens"].items():
        print(f"   client {cid}: {toks[:8]}...")
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
