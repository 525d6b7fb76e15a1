#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving paths' shapes in bf16 and in fp32 with TF32 off, with a
   length-0 decode row, ragged S, head_dim 256 with a window shorter than
   S (K1) and 10 query heads per kv head (K1, K2); K2 also at its split
   edges (only split 0 live, a chunk's edge and one past it, a length past
   S, B 1) and captured in a CUDA graph, replayed at new lengths written in
   place; K1's bf16 cases at D 64,
   128 and 256 take its tensor-core route and its fp32 cases its CUDA-core
   route, each case logging its route; K3's bf16 cases with P a multiple
   of 64 and N 64 or 128 take its tensor-core route (ragged S, S under
   one chunk, two groups, no initial state, B 1, N 64) and its fp32 cases
   and a bf16 one at P 16 its CUDA-core route, each case logging its
   route, with a nonzero initial state, fewer groups than heads, and in
   fp32 its final state against the sequential oracle; K4 (a chunked scan
   over S) with S over many of its tiles and ragged, S 1, S under one
   chunk, W under its strip and not a multiple of it, B 1, an fp32 and a
   bf16 y each with and without an initial state; kernel, plain and
   library times, each call's bound, K3's TFLOP/s, TB/s and CTA plan, and
   K4's TB/s, CTA plan (lanes a strip, steps a chunk, chunks a tile, CTAs,
   waves), registers and spills, and its time on inputs cold in L2;
4. serve: qwen3-14b at full width (40 layers, bf16 params made on the card
   from a seed) answers four clients through the port's InferenceServer;
   the kernels' launch counts must rise by 40 per prefill (K1) and by 40
   per decode step (K2), and K3 and K4 must not run; then mamba2-2.7b at
   full width (64 layers, bf16) the same way, where K3 must rise by 64 per
   prefill and by 0 per decode step and nothing else may run; then
   recurrentgemma-2b at full width (26 layers, bf16), where K4 must rise by
   18 per prefill and 0 per decode step, K1 by 8 per prefill and K2 by 8
   per decode step; every K1 and K3 launch of a serve run must take the
   tensor-core route; the served tokens must equal greedy decoding, and each
   path gets a profiler breakdown of a prefill and a decode step, in which
   each kernel the path launches must hold device time in its group;
5. parity: at each arch's reduced config, prefill logits and greedy tokens
   from the port on the card equal the port on the CPU (the plain
   versions), in fp32;
6. grad guards: K1's bf16 route, K2 and K3 raise under autograd (they
   have no backward kernel) instead of returning a tensor with no grad_fn;
7. train parity: recurrentgemma-2b at 3 layers of full width, fp32: the
   V-trace loss and every gradient leaf through K1, K1-bwd, K4 and K4-bwd
   against the same through their plain versions on the card;
8. train: recurrentgemma-2b at full width (26 layers, 2.89 B params, fp32
   params and AdamW moments) takes 3 steps at batch 4 x seq 256 through
   ``repro_torch.launch.train``'s functions; K1 and K1-bwd must rise by 8
   a step, K4 and K4-bwd by 18, K2 and K3 not at all; loss and grad_norm
   finite; then the step's wall time, tokens/s, the forward, backward and
   optimizer parts, peak memory and a profiler breakdown;
9. train restart: the launcher at the reduced config on the card,
   checkpointing every 2 steps, restarts from its checkpoint after a
   failure injected at step 3 and ends at step 6.

The kernel phase (3) also holds K1-bwd and K4-bwd to their plain versions
(the formulas each kernel computes) at the train call, the smoke widths
and D 128 with 5 query heads a kv head, and times them against their
bounds (K1-bwd also against SDPA's fp32 backward: forward and backward,
less forward).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or run from a directory
that does not hold the repository, it fails and prints no result.
"""

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, and
# HBM3 bandwidth. Bounds are stated against these.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

CLIENTS, TOKENS = 4, 16
# arch -> (prompt length, cache length); mamba's state ignores the latter,
# which only has to admit prompt + CLIENTS * TOKENS steps
SERVE = {"qwen3-14b": (256, 512), "mamba2-2.7b": (512, 576),
         "recurrentgemma-2b": (512, 576)}
PROMPT_LEN, MAX_LEN = SERVE["qwen3-14b"]
# the attention calls of recurrentgemma-2b's path: 10 query heads on one kv
# head of 256, window 2048 (longer than the prompt), a ring of 576 slots
RG = dict(h=10, kh=1, d=256, window=2048)
# the training path: recurrentgemma-2b at full width in fp32, its K1 and K4
# calls at batch 4 x seq 256
TRAIN = dict(arch="recurrentgemma-2b", batch=4, seq=256, steps=3)
GRAD_TOL = 1e-4   # of a gradient tensor's max |value|, and relative


def log(msg):
    print(msg, flush=True)


def card_identity():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(name, fn, iters=20, warmup=3):
    """Mean device time of one call, CUDA events around `iters` calls. A
    sleeping kernel first holds the stream for about 50 ms, so that the
    host queues every call before the first one runs: a call whose host
    side is slower than its kernel would otherwise time the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)   # cycles, ~50 ms at the H100's 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if start.query():   # the stream woke before the host had queued every call
        log(f"   ({name} is host-limited: the host could not queue ahead, so "
            "its time includes host gaps)")
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, tol, atol=None):
    """Elementwise |got - want| <= atol + tol * |want| (atol = rtol = tol by
    default, the JAX package's kernel-test tolerances: fp32 2e-5, bf16
    2e-2)."""
    err = max_err(got, want)
    atol = tol if atol is None else atol
    g, w = got.float(), want.float()
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(g).all())
          and bool(((g - w).abs() <= atol + tol * w.abs()).all()))
    log(f"   {name}: max_abs_err {err:.3e} (atol {atol:.3g}, rtol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def kernel_phase(k4_ptxas, bwd_ptxas):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as K2
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as K4
    from repro_torch.kernels import ssd_scan as K3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    rows = {}

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # ---- K1 ----
    log("== kernels: K1 flash attention (prefill)")
    for dt in tol:   # the route the library picks is the one the wrapper records
        for hd in K1.HEAD_DIMS:
            if K1.kernel_route(dt, hd) != K1.route(dt, hd):
                raise AssertionError(f"K1 route of {dt} D {hd}: library "
                                     f"{K1.kernel_route(dt, hd)}, wrapper {K1.route(dt, hd)}")
    b, s, h, kh, d = CLIENTS, PROMPT_LEN, 40, 8, 128       # qwen3's call
    rs = SERVE["recurrentgemma-2b"][0]
    cases = [((b, s, h, kh, d), torch.bfloat16, {}),
             ((b, rs, RG["h"], RG["kh"], RG["d"]), torch.bfloat16,   # RecurrentGemma's call
              {"window": RG["window"]}),
             ((1, 64, 1, 1, 128), torch.bfloat16, {}),                # one tile
             ((2, 128, 4, 2, 64), torch.bfloat16, {}),                # D 64
             ((2, 200, 4, 2, 128), torch.bfloat16, {}),               # ragged S
             ((2, 256, 4, 4, 128), torch.bfloat16, {"softcap": 30.0}),
             ((2, 300, 10, 1, 256), torch.bfloat16, {"window": 100}),  # ragged, window < S
             ((2, 130, 4, 2, 128), torch.bfloat16, {"causal": False}),
             ((2, 300, 10, 1, 256), torch.float32, {"window": 128}),  # D 256, window < S
             ((2, 200, 4, 2, 64), torch.float32, {"window": 64}),    # ragged S
             ((2, 77, 4, 4, 64), torch.float32, {"softcap": 30.0}),
             ((2, 24, 4, 2, 16), torch.float32, {}),                  # qwen3 reduced config
             ((2, 150, 4, 1, 16), torch.float32, {"window": 32})]     # RecurrentGemma reduced
    main_err = None
    for (cb, cs, ch, ckh, cd), dt, kw in cases:
        q = rand(cb, cs, ch, cd, dtype=dt)
        k, v = rand(cb, cs, ckh, cd, dtype=dt), rand(cb, cs, ckh, cd, dtype=dt)
        kw = {"causal": True, **kw}
        got = K1.flash_attention(q, k, v, scale=cd ** -0.5, **kw)
        want = ops.flash_attention_plain(q, k, v, scale=cd ** -0.5, **kw)
        torch.cuda.synchronize()
        err = check_close(f"K1 {(cb, cs, ch, ckh, cd)} {str(dt)[6:]} {kw} "
                          f"[{K1.route(dt, cd)}]", got, want, tol[dt])
        main_err = err if main_err is None else main_err

    def time_k1(b, s, h, kh, d, window=0):
        q = rand(b, s, h, d, dtype=torch.bfloat16)
        k, v = rand(b, s, kh, d, dtype=torch.bfloat16), rand(b, s, kh, d, dtype=torch.bfloat16)
        sc = d ** -0.5
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        assert window == 0 or window >= s   # then the window masks nothing: SDPA's causal
        ms = time_ms("K1", lambda: K1.flash_attention(q, k, v, scale=sc, window=window))
        plain_ms = time_ms("K1 plain", lambda: ops.flash_attention_plain(
            q, k, v, scale=sc, window=window))
        lib_ms = time_ms("K1 library", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=sc, enable_gqa=True))
        flops = 4 * d * (s * (s + 1) // 2) * b * h             # causal pairs only
        nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * q.element_size()
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(flops, nbytes, "bfloat16"), tflops=flops / ms / 1e9)
        log(f"   K1 at ({b},{s},{h},{kh},{d}) bf16 [{K1.route(q.dtype, d)}]: kernel_ms {ms:.4f} "
            f"({row['tflops']:.1f} TFLOP/s) plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"(SDPA) bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")
        return row

    # the serving calls are bf16 at D 128 and 256: the tensor-core route
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda", variant=K1.route(torch.bfloat16, d),
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=main_err, **time_k1(b, s, h, kh, d))
    time_k1(b, rs, RG["h"], RG["kh"], RG["d"], RG["window"])

    # ---- K2 ----
    log("== kernels: K2 decode attention (split-S pass, then combine)")
    S = MAX_LEN
    rmax = SERVE["recurrentgemma-2b"][1]
    qwen, rg1 = (b, S, h, kh, d), (1, rmax, RG["h"], RG["kh"], RG["d"])
    sms = K2.num_sms(torch.cuda.current_device())
    cases = [(qwen, torch.bfloat16, [0, 1, 263, S]),
             ((b, rmax, RG["h"], RG["kh"], RG["d"]), torch.bfloat16,   # RecurrentGemma's ring
              [0, 1, rs + 8, rmax]),
             # the split edges at qwen3's call (chunk 32 at 132 SMs): only split 0
             # live, a chunk's edge and one past it, a length past S, a length 0
             (qwen, torch.bfloat16, [1, 32, 33, S + 100]),
             (qwen, torch.float32, [1, 32, 33, S + 100]),
             (qwen, torch.float32, [0, 16, 264, S]),
             (rg1, torch.bfloat16, [rs + 8]),                           # B 1: the fewest CTAs
             (rg1, torch.bfloat16, [17]),
             (rg1, torch.float32, [0]),
             (rg1, torch.float32, [16]),
             ((2, 333, 10, 1, 256), torch.float32, [5, 333]),          # D 256, 10 heads a kv head
             ((3, 333, 8, 8, 64), torch.float32, [0, 5, 333]),          # ragged S, expanded
             ((2, 64, 4, 2, 16), torch.float32, [0, 33]),               # qwen3 reduced config
             ((2, 32, 4, 1, 16), torch.float32, [7, 32])]               # RecurrentGemma reduced
    main_err = None
    for (cb, cs, ch, ckh, cd), dt, lens in cases:
        q = rand(cb, ch, cd, dtype=dt)
        k, v = rand(cb, cs, ckh, cd, dtype=dt), rand(cb, cs, ckh, cd, dtype=dt)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = K2.decode_attention(q, k, v, ln, scale=cd ** -0.5)
        want = ops.decode_attention_plain(q, k, v, ln, scale=cd ** -0.5)
        torch.cuda.synchronize()
        chunk, splits = K2.plan(cb, cs, ch, ckh, cd, dt, sms)
        err = check_close(f"K2 {(cb, cs, ch, ckh, cd)} {str(dt)[6:]} lengths {lens} "
                          f"[chunk {chunk}, {splits} splits]", got, want, tol[dt])
        main_err = err if main_err is None else main_err

    # capture: the plan reads no length on the host, so one captured call
    # replays right at lengths written in place afterwards
    q = rand(b, h, d, dtype=torch.bfloat16)
    k, v = rand(b, S, kh, d, dtype=torch.bfloat16), rand(b, S, kh, d, dtype=torch.bfloat16)
    ln = torch.tensor([5, 100, 264, S], dtype=torch.int32, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K2.decode_attention(q, k, v, ln)
    for lens in ([1, 33, 0, S + 9], [264, 32, S - 1, 2]):
        ln.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        want = ops.decode_attention_plain(q, k, v, ln)
        torch.cuda.synchronize()
        check_close(f"K2 {qwen} bf16 captured once, replayed at lengths {lens}", captured,
                    want, tol[torch.bfloat16])
    del graph, captured

    def rotating(fn, pairs):
        it = [0]

        def call():
            kk, vv = pairs[it[0] % len(pairs)]
            it[0] += 1
            return fn(kk, vv)
        return call

    def k2_passes(call, n=32):
        """Device ms a call of K2's split kernel, of its combine kernel
        (launched while the split pass runs, so their spans overlap), and
        of both together, from a profiler trace of `n` calls."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        spans = {"split": [], "combine": []}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for name, found in spans.items():
                    if f"decode_{name}_kernel" in e.name:
                        found.append((e.time_range.start, e.time_range.end))
        passes = {name: union_ms(found) / n for name, found in spans.items()}
        passes["both"] = union_ms(spans["split"] + spans["combine"]) / n
        return passes

    @contextlib.contextmanager
    def k2_planning_for(n_sms):
        """K2's wrapper planning for `n_sms` SMs in place of the card's."""
        real = K2.num_sms
        K2.num_sms = lambda index: n_sms
        try:
            yield
        finally:
            K2.num_sms = real

    def time_k2(b, S, h, kh, d, n_valid):
        """Timing at a serving path's mid-run length, with enough caches in
        rotation that their valid rows exceed the 50 MB L2: a decode step
        finds each layer's cache cold. Also times each chunk of a sweep, the
        plan picking it for an SM count other than the card's."""
        sc = d ** -0.5
        q = rand(b, h, d, dtype=torch.bfloat16)
        n_caches = max(16, -(-100_000_000 // (2 * b * S * kh * d * 2)))
        kvs = [(rand(b, S, kh, d, dtype=torch.bfloat16), rand(b, S, kh, d, dtype=torch.bfloat16))
               for _ in range(n_caches)]
        ln = torch.full((b,), n_valid, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev) < n_valid).expand(b, 1, 1, S)
        kvt = [(kk.transpose(1, 2).contiguous(), vv.transpose(1, 2).contiguous())
               for kk, vv in kvs]
        chunk, splits = K2.plan(b, S, h, kh, d, torch.bfloat16, sms)
        ms = time_ms("K2", rotating(
            lambda kk, vv: K2.decode_attention(q, kk, vv, ln, scale=sc), kvs), iters=32)
        sweep = {}
        for c in (16, 32, 64):   # each chunk through the plan, for an SM count that picks it
            fake = b * kh * -(-S // c) // 2
            assert K2.plan(b, S, h, kh, d, torch.bfloat16, fake)[0] == c
            with k2_planning_for(fake):
                sweep[c] = time_ms(f"K2 chunk {c}", rotating(
                    lambda kk, vv: K2.decode_attention(q, kk, vv, ln, scale=sc), kvs), iters=32)
        passes = k2_passes(rotating(
            lambda kk, vv: K2.decode_attention(q, kk, vv, ln, scale=sc), kvs))
        plain_ms = time_ms("K2 plain", rotating(
            lambda kk, vv: ops.decode_attention_plain(q, kk, vv, ln, scale=sc), kvs), iters=32)
        lib_ms = time_ms("K2 library", rotating(lambda kk, vv: F.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=mask, scale=sc, enable_gqa=True), kvt), iters=32)
        nbytes = (2 * b * h * d + 2 * b * n_valid * kh * d) * q.element_size() + 4 * b
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(4 * b * h * n_valid * d, nbytes, "bfloat16"),
                   chunk=chunk, splits=splits, ctas=b * kh * splits)
        log(f"   K2 at ({b},{S},{h},{kh},{d}) bf16, length {n_valid}, {n_caches} caches; plan "
            f"chunk {chunk}, {splits} splits, {b * kh * splits} CTAs "
            f"({b * kh * -(-n_valid // chunk)} live): kernel_ms {ms:.4f} "
            f"({nbytes / ms / 1e9:.3f} TB/s) plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"(SDPA) bound_ms {row['bound_ms']:.5f} ({row['bound_by']}, {nbytes / 1e6:.2f} MB); "
            "kernel_ms by chunk " + ", ".join(f"{c}: {t:.4f}" for c, t in sweep.items()))
        log(f"   K2 passes, device ms a call from a profiler trace: split {passes['split']:.4f}, "
            f"combine {passes['combine']:.4f} (from its launch during the split pass), both "
            f"{passes['both']:.4f}")
        del kvs, kvt
        return row

    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:51",
        max_abs_err=main_err, **time_k2(b, S, h, kh, d, PROMPT_LEN + TOKENS // 2))
    time_k2(b, rmax, RG["h"], RG["kh"], RG["d"], rs + TOKENS // 2)

    # ---- K3 ----
    log("== kernels: K3 SSD chunked scan (Mamba2 prefill)")
    # atol is stated against max|y_ref| (tests/test_kernels.py:73-75): 3e-5
    # in fp32; 2e-2 in bf16, where the plain version rounds the products
    # C.B^T and C.S_prev^T to bf16 and the tensor-core route rounds M and
    # S_prev; the final state is held to 3e-5 of its largest value in both
    k3_tol = {torch.float32: (3e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}

    def ssd_inputs(b, s, h, p, n, g, dtype, with_h0):
        x = (rand(b, s, h, p, dtype=torch.float32) * 0.5).to(dtype)
        dt = F.softplus(rand(b, s, h, dtype=torch.float32) - 2.0)
        a = -torch.exp(rand(h, dtype=torch.float32) * 0.5 + 1.0)
        bm, cm = ((rand(b, s, g, n, dtype=torch.float32) * 0.3).to(dtype) for _ in range(2))
        h0 = rand(b, h, p, n, dtype=torch.float32) * 0.2 if with_h0 else None
        return x, dt, a, bm, cm, h0

    for dt_ in tol:   # the route the library picks is the one the wrapper records
        for p_ in (16, 64, 80, 128):
            for n_ in (16, 64, 96, 128):
                if K3.kernel_route(dt_, p_, n_) != K3.route(dt_, p_, n_):
                    raise AssertionError(f"K3 route of {dt_} P {p_} N {n_}: library "
                                         f"{K3.kernel_route(dt_, p_, n_)}, wrapper "
                                         f"{K3.route(dt_, p_, n_)}")
    mb, ms_, mh, mp, mn, mg = CLIENTS, SERVE["mamba2-2.7b"][0], 80, 64, 128, 1  # serving call
    cases = [((mb, ms_, mh, mp, mn, mg), torch.bfloat16, True),
             ((2, 200, 4, 64, 128, 1), torch.bfloat16, True),    # ragged S
             ((1, 37, 2, 64, 128, 1), torch.bfloat16, False),    # under one chunk, no h0
             ((2, 256, 4, 64, 128, 2), torch.bfloat16, False),   # two groups of two heads
             ((1, 130, 3, 128, 64, 3), torch.bfloat16, True),    # B 1, N 64, two p tiles
             ((2, 100, 4, 16, 32, 2), torch.bfloat16, True),     # bf16 on the CUDA cores
             ((2, 200, 4, 16, 32, 2), torch.float32, True),    # ragged S, G < H, h0
             ((1, 37, 2, 64, 128, 1), torch.float32, False),   # S shorter than one chunk
             ((2, 150, 16, 8, 16, 1), torch.float32, True)]    # reduced config
    main_err = None
    for (cb, cs, ch, cp, cn, cg), dt_, with_h0 in cases:
        x, dt, a, bm, cm, h0 = ssd_inputs(cb, cs, ch, cp, cn, cg, dt_, with_h0)
        y, st = K3.ssd_scan(x, dt, a, bm, cm, h0=h0, return_state=True)
        yp, sp = ops.ssd_scan_plain(x, dt, a, bm, cm, chunk=256, h0=h0)
        torch.cuda.synchronize()
        atol, rtol = k3_tol[dt_]
        name = (f"K3 {(cb, cs, ch, cp, cn, cg)} {str(dt_)[6:]} h0={with_h0} "
                f"[{K3.route(dt_, cp, cn)}]")
        scale = max(float(yp.float().abs().max()), 1.0)
        err = check_close(f"{name} y", y, yp, rtol, atol * scale)
        check_close(f"{name} state", st, sp, 1e-4, 3e-5 * max(float(sp.abs().max()), 1.0))
        main_err = err if main_err is None else main_err
        if dt_ == torch.float32:   # the final state against the sequential oracle
            r = ch // cg
            yr, sr = ref.ssd_ref(x, dt, a, bm.repeat_interleave(r, 2),
                                 cm.repeat_interleave(r, 2), h0)
            check_close(f"{name} y vs ssd_ref", y, yr, 1e-4,
                        3e-5 * max(float(yr.abs().max()), 1.0))
            check_close(f"{name} state vs ssd_ref", st, sr, 1e-4,
                        3e-5 * max(float(sr.abs().max()), 1.0))
    # timing: the serving path's call (the prefill passes the cache's zero
    # state as h0 and asks for the final state)
    x, dt, a, bm, cm, _ = ssd_inputs(mb, ms_, mh, mp, mn, mg, torch.bfloat16, False)
    h0 = torch.zeros(mb, mh, mp, mn, device=dev)
    ms = time_ms("K3", lambda: K3.ssd_scan(x, dt, a, bm, cm, h0=h0, return_state=True))
    plain_ms = time_ms("K3 plain", lambda: ops.ssd_scan_plain(x, dt, a, bm, cm, chunk=256,
                                                              h0=h0))
    esz = x.element_size()
    nbytes = (2 * x.numel() + bm.numel() + cm.numel()) * esz + 4 * (dt.numel() + a.numel()) \
        + 2 * 4 * h0.numel()
    flops = 4 * mp * mn * mb * ms_ * mh                    # the recurrence's, per token and head
    # the tensor-core route's issued work: per chunk of 64 steps and 64
    # columns p, C.B^T and C.S_prev^T (K = N), M.X (K = 64) and the update
    # with v in two bf16 parts (K = 64, N wide)
    chunks = mb * mh * -(-ms_ // 64) * (mp // 64)
    tc_flops = chunks * (2 * 2 * 64 * 64 * mn + 2 * 64 * 64 * 64 + 2 * 2 * 64 * mn * 64)
    heads_per_cta, ctas = K3.plan(mb, mh, mp)
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", variant=K3.route(x.dtype, mp, mn),
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:56",
        max_abs_err=main_err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(flops, nbytes, "bfloat16"), tflops=tc_flops / ms / 1e9,
        tbps=nbytes / ms / 1e9, heads_per_cta=heads_per_cta, ctas=ctas)
    log(f"   K3 at ({mb},{ms_},{mh},{mp},{mn},{mg}) bf16, h0 and final state "
        f"[{K3.route(x.dtype, mp, mn)}; {heads_per_cta} head a CTA, {ctas} CTAs]: kernel_ms "
        f"{ms:.4f} ({rows['ssd_scan']['tflops']:.1f} TFLOP/s of {tc_flops / 1e9:.1f} GFLOP "
        f"issued, {rows['ssd_scan']['tbps']:.3f} TB/s) plain_ms {plain_ms:.4f} library_ms none "
        f"(no PyTorch call computes the SSD scan) bound_ms {rows['ssd_scan']['bound_ms']:.4f} "
        f"({rows['ssd_scan']['bound_by']}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")

    # ---- K4 ----
    log("== kernels: K4 RG-LRU scan (RecurrentGemma prefill)")
    # the model's gates: a = exp(-8 softplus(lam) r) in (0, 1), b the gated x

    def rglru_inputs(b, s, w, with_h0):
        a = torch.sigmoid(rand(b, s, w, dtype=torch.float32) + 2.0)
        bb = rand(b, s, w, dtype=torch.float32) * 0.1
        h0 = rand(b, w, dtype=torch.float32) if with_h0 else None
        return a, bb, h0

    gb, gs, gw = CLIENTS, SERVE["recurrentgemma-2b"][0], 2560       # the serving call
    # atol is stated against max|h| (tests/test_kernels.py:78-86 holds the
    # Pallas kernel to rglru_ref at 1e-5): 1e-5 in fp32; a bf16 y is the
    # same fp32 h rounded once, so it may differ by one bf16 rounding
    cases = [((gb, gs, gw), torch.float32, False),
             ((gb, gs, gw), torch.bfloat16, True),          # as the prefill calls it
             ((2, 4096, 256), torch.float32, True),         # S over 64 tiles
             ((1, 2049, 96), torch.bfloat16, True),         # ragged S over 33 tiles, B 1
             ((1, 2049, 96), torch.float32, False),
             ((3, 1, 37), torch.float32, True),             # S 1, W 37: a strip and 5 lanes
             ((1, 5, 37), torch.bfloat16, False),           # S under one chunk, B 1
             ((2, 300, 20), torch.bfloat16, True),          # W under one strip
             ((2, 37, 200), torch.float32, True),           # ragged S and W
             ((2, 150, 64), torch.float32, True)]           # the reduced config
    main_err = None
    for (cb, cs, cw), out_dt, with_h0 in cases:
        a, bb, h0 = rglru_inputs(cb, cs, cw, with_h0)
        y, h_last = K4.rglru_scan(a, bb, h0=h0, out_dtype=out_dt)
        yp, hp = ops.rglru_scan_plain(a, bb, h0=h0, out_dtype=out_dt)
        torch.cuda.synchronize()
        scale = max(float(yp.float().abs().max()), 1.0)
        p = K4.plan(cb, cs, cw)
        name = (f"K4 {(cb, cs, cw)} y {str(out_dt)[6:]} h0={with_h0} "
                f"[{p['tiles']} tiles, {p['ctas']} CTAs]")
        rtol = 1e-5 if out_dt == torch.float32 else tol[out_dt]
        err = check_close(f"{name} y", y, yp, rtol, rtol * scale)
        check_close(f"{name} h_last", h_last, hp, 1e-5, 1e-5 * scale)
        main_err = err if main_err is None else main_err
    # timing: the serving path's call (bf16 y, the cache's zero state as h0,
    # the last state written); warm (one set of inputs, 52.5 MB against the
    # 50 MB L2) and cold (four sets of a and b in rotation; the last four
    # outputs are kept, so y rotates over five buffers)
    sets = [rglru_inputs(gb, gs, gw, False)[:2] for _ in range(4)]
    a, bb = sets[0]
    h0 = torch.zeros(gb, gw, device=dev)
    ms = time_ms("K4", lambda: K4.rglru_scan(a, bb, h0=h0, out_dtype=torch.bfloat16))
    kept, turn = [None] * len(sets), [0]

    def cold_call():
        i = turn[0] % len(sets)
        turn[0] += 1
        kept[i] = K4.rglru_scan(*sets[i], h0=h0, out_dtype=torch.bfloat16)
    cold_ms = time_ms("K4 cold", cold_call, iters=32)
    plain_ms = time_ms("K4 plain", lambda: ops.rglru_scan_plain(
        a, bb, h0=h0, out_dtype=torch.bfloat16), iters=3, warmup=1)
    nbytes = 4 * (a.numel() + bb.numel()) + 2 * a.numel() + 2 * 4 * h0.numel()
    flops = 2 * a.numel()
    p = K4.plan(gb, gs, gw)   # the built kernel's own
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = p["ctas"] / (p["ctas_per_sm"] * sms)
    rows["rglru_scan"] = dict(
        name="rglru_scan", route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:39",
        max_abs_err=main_err, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(flops, nbytes, "float32"), tbps=nbytes / ms / 1e9, cold_ms=cold_ms,
        cold_tbps=nbytes / cold_ms / 1e9, **{k: p[k] for k in ("lw", "t", "nc", "ctas",
                                                               "ctas_per_sm")},
        waves=waves, **k4_ptxas)
    regs = ", ".join(f"{k} {v}" for k, v in k4_ptxas.items()) or "ptxas not run (built before)"
    log(f"   K4 at ({gb},{gs},{gw}) fp32 a and b, bf16 y, h0 and last state [plan: LW "
        f"{p['lw']}, T {p['t']}, NC {p['nc']}, {p['tiles']} tiles of {p['t'] * p['nc']} steps, "
        f"{p['ctas']} CTAs of {p['lw'] * p['nc']} threads, {p['ctas_per_sm']} an SM, "
        f"{waves:.2f} waves on {sms} SMs; {regs}]: "
        f"kernel_ms {ms:.4f} "
        f"({rows['rglru_scan']['tbps']:.3f} TB/s), cold in L2 {cold_ms:.4f} "
        f"({rows['rglru_scan']['cold_tbps']:.3f} TB/s), plain_ms {plain_ms:.4f} library_ms none "
        f"(no PyTorch call computes a linear recurrence) bound_ms "
        f"{rows['rglru_scan']['bound_ms']:.4f} ({rows['rglru_scan']['bound_by']}, "
        f"{nbytes / 1e6:.1f} MB)")
    del sets, kept

    # ---- K1-bwd ----
    log("== kernels: K1-bwd flash attention backward (fp32, CUDA cores)")
    # the gradients sum up to S * H / KH products in another order than the
    # plain version's einsums: held to GRAD_TOL of each tensor's max |value|
    tb, ts = TRAIN["batch"], TRAIN["seq"]
    cases = [((tb, ts, RG["h"], RG["kh"], RG["d"]), {"window": RG["window"]}),  # the train call
             ((2, 200, 10, 2, 128), {}),              # D 128, 5 query heads a kv head (qwen3's)
             ((2, 300, 10, 1, 256), {"window": 100}),  # ragged S over tiles, window < S
             ((2, 77, 4, 2, 64), {"softcap": 30.0}),
             ((1, 40, 4, 4, 16), {"causal": False}),
             ((2, 48, 4, 2, 16), {}),                  # qwen3 reduced config
             ((2, 150, 4, 1, 16), {"window": 32})]     # RecurrentGemma reduced config
    main_err = None
    for (cb, cs, ch, ckh, cd), kw in cases:
        q = rand(cb, cs, ch, cd, dtype=torch.float32)
        k, v = rand(cb, cs, ckh, cd, dtype=torch.float32), rand(cb, cs, ckh, cd,
                                                               dtype=torch.float32)
        do = rand(cb, cs, ch, cd, dtype=torch.float32)
        kw = {"causal": True, "scale": cd ** -0.5, **kw}
        o, lse = K1.flash_attention(q, k, v, return_lse=True, **kw)
        got = K1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        lse_want = ops.flash_attention_lse_plain(q, k, **kw)
        torch.cuda.synchronize()
        shown = {k_: v_ for k_, v_ in kw.items() if k_ != "scale"}
        name = f"K1-bwd {(cb, cs, ch, ckh, cd)} {shown}"
        check_close(f"{name} lse", lse, lse_want, tol[torch.float32])
        errs = [check_close(f"{name} {g}", x, w, GRAD_TOL,
                            GRAD_TOL * max(float(w.abs().max()), 1e-30))
                for g, x, w in zip(("dq", "dk", "dv"), got, want)]
        main_err = max(errs) if main_err is None else main_err
    # timing at the train call
    (cb, cs, ch, ckh, cd), kw = cases[0]
    sc = cd ** -0.5
    q = rand(cb, cs, ch, cd, dtype=torch.float32)
    k, v = rand(cb, cs, ckh, cd, dtype=torch.float32), rand(cb, cs, ckh, cd, dtype=torch.float32)
    do = rand(cb, cs, ch, cd, dtype=torch.float32)
    o, lse = K1.flash_attention(q, k, v, scale=sc, return_lse=True, **kw)
    ms = time_ms("K1-bwd", lambda: K1.flash_attention_bwd(q, k, v, o, lse, do, scale=sc, **kw))
    plain_ms = time_ms("K1-bwd plain", lambda: ops.flash_attention_bwd_plain(
        q, k, v, o, lse, do, scale=sc, **kw), iters=5, warmup=1)
    # the library yardstick: SDPA's fp32 forward and backward with the same
    # boolean mask, less its forward alone
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    rows_i = torch.arange(cs, device=dev)[:, None]
    cols_i = torch.arange(cs, device=dev)[None, :]
    mask = (cols_i <= rows_i) & ((rows_i - cols_i) < kw["window"])
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, attn_mask=mask, scale=sc, enable_gqa=True)
    lib_fwd = time_ms("SDPA fp32 forward", sdpa, iters=10)
    lib_both = time_ms("SDPA fp32 forward and backward", lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), iters=10)
    k1_passes = kernel_spans(
        lambda: K1.flash_attention_bwd(q, k, v, o, lse, do, scale=sc, **kw),
        ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_reduce", "flash_bwd_dq"))
    pairs = int(mask.sum())
    flops = 10 * cd * pairs * cb * ch                 # five products over the kept pairs
    nbytes = 4 * (4 * cb * cs * ch * cd + 4 * cb * cs * ckh * cd + cb * ch * cs)
    rows["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda", variant="cuda_cores",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=main_err, ms=ms, plain_ms=plain_ms, library_ms=lib_both - lib_fwd,
        library_fwd_and_bwd_ms=lib_both, library_fwd_ms=lib_fwd,
        kernel_split_ms=k1_passes,
        **bound(flops, nbytes, "float32"), tflops=flops / ms / 1e9, **bwd_ptxas["k1"])
    r = rows["flash_attention_bwd"]
    log(f"   K1-bwd at ({cb},{cs},{ch},{ckh},{cd}) fp32, window {kw['window']} (the train call; "
        f"{' '.join(f'{k_} {v_}' for k_, v_ in bwd_ptxas['k1'].items())}): kernel_ms "
        f"{ms:.4f} ({r['tflops']:.2f} TFLOP/s) plain_ms {plain_ms:.4f} library_ms "
        f"{r['library_ms']:.4f} (SDPA fp32 with a boolean mask: forward and backward "
        f"{lib_both:.4f} less forward {lib_fwd:.4f}) bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']}, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); device ms a call "
        f"by kernel (profiler): " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in k1_passes.items()))
    del qt, kt, vt

    # ---- K4-bwd ----
    log("== kernels: K4-bwd RG-LRU scan backward (fp32)")
    # held to 1e-5 of max |gradient|, as K4 is to max |h|: the same chain of
    # fp32 FMAs as the plain reverse loop, rounded apart
    gw = 2560
    cases = [((tb, ts, gw), False, False),    # the train call: no h0, h_last unused
             ((tb, ts, gw), True, True),
             ((1, 2049, 96), True, True),      # ragged S, B 1
             ((3, 1, 37), True, False),        # S 1, W 37
             ((2, 37, 200), False, True),
             ((2, 48, 64), False, False)]      # the reduced config
    main_err = None
    for (cb, cs, cw), with_h0, with_dh in cases:
        a, bb, h0 = rglru_inputs(cb, cs, cw, with_h0)
        y, _ = K4.rglru_scan(a, bb, h0=h0)
        dy = rand(cb, cs, cw, dtype=torch.float32)
        dh = rand(cb, cw, dtype=torch.float32) if with_dh else None
        got = K4.rglru_scan_bwd(a, y, h0, dy, dh)
        want = ops.rglru_scan_bwd_plain(a, y, h0, dy, dh)
        torch.cuda.synchronize()
        name = f"K4-bwd {(cb, cs, cw)} h0={with_h0} dh_last={with_dh}"
        errs = [check_close(f"{name} {g}", x, w, 1e-5, 1e-5 * max(float(w.abs().max()), 1e-30))
                for g, x, w in zip(("da", "db", "dh0"), got, want) if w is not None]
        if (got[2] is None) != (h0 is None):
            raise AssertionError(f"{name}: dh0 given without h0, or missing with it")
        main_err = max(errs) if main_err is None else main_err
    a, bb, _ = rglru_inputs(tb, ts, gw, False)
    y, _ = K4.rglru_scan(a, bb)
    dy = rand(tb, ts, gw, dtype=torch.float32)
    ms = time_ms("K4-bwd", lambda: K4.rglru_scan_bwd(a, y, None, dy, None))
    plain_ms = time_ms("K4-bwd plain", lambda: ops.rglru_scan_bwd_plain(a, y, None, dy, None),
                       iters=3, warmup=1)
    nbytes = 4 * 5 * a.numel()                   # a, y, dy read; da, db written
    rows["rglru_scan_bwd"] = dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
        replaces="src/repro/kernels/rglru_scan.py:39", max_abs_err=main_err, ms=ms,
        plain_ms=plain_ms, library_ms=None, **bound(3 * a.numel(), nbytes, "float32"),
        tbps=nbytes / ms / 1e9, **bwd_ptxas["k4"])
    r = rows["rglru_scan_bwd"]
    log(f"   K4-bwd at ({tb},{ts},{gw}) fp32, no h0, no dh_last (the train call; "
        f"{' '.join(f'{k_} {v_}' for k_, v_ in bwd_ptxas['k4'].items())}): kernel_ms {ms:.4f} "
        f"({r['tbps']:.3f} TB/s) plain_ms {plain_ms:.4f} library_ms none (no PyTorch call "
        f"computes a linear recurrence's gradient) bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']}, {nbytes / 1e6:.1f} MB)")
    return rows


def kernel_spans(call, names, n=8):
    """Device ms a call of each kernel whose name contains one of `names`,
    from a profiler trace of `n` calls."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    spans = {name: [] for name in names}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    spans[name].append((e.time_range.start, e.time_range.end))
    return {name: union_ms(found) / n for name, found in spans.items()}


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def expected_launches(cfg, steps):
    """Launches of a serve run (one prefill, `steps` decode steps): the
    dense LM runs K1 once per layer in prefill and K2 once per layer in
    each decode step; Mamba runs K3 once per layer in prefill and nothing
    in decode; RecurrentGemma runs K4 once per recurrent layer in prefill
    and nothing in decode, and K1 and K2 as the dense LM does on its
    local-attention layers. Serving runs no backward kernel."""
    bwd = {"flash_attention_bwd": 0, "rglru_scan_bwd": 0}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "decode_attention": 0, "ssd_scan": cfg.num_layers,
                "rglru_scan": 0, **bwd}
    if cfg.family == "hybrid":
        from repro_torch.models.recurrentgemma import layer_kinds
        n_rec = layer_kinds(cfg).count("rglru")
        n_att = cfg.num_layers - n_rec
        return {"flash_attention": n_att, "decode_attention": n_att * steps, "ssd_scan": 0,
                "rglru_scan": n_rec, **bwd}
    return {"flash_attention": cfg.num_layers, "decode_attention": cfg.num_layers * steps,
            "ssd_scan": 0, "rglru_scan": 0, **bwd}


def describe(cfg):
    if cfg.family == "hybrid":
        return (f"d_model {cfg.d_model}, lru_width {cfg.lru_width}, pattern "
                f"{'/'.join(cfg.block_pattern)}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
                f"head_dim {cfg.head_dim}, window {cfg.local_window}, d_ff {cfg.d_ff}, vocab "
                f"{cfg.vocab_size}, tied embeddings {cfg.tie_embeddings}")
    if cfg.family == "ssm":
        return (f"d_model {cfg.d_model}, d_inner {cfg.ssm_dinner}, {cfg.ssm_nheads} heads of "
                f"{cfg.ssm_headdim}, state {cfg.ssm_state}, groups {cfg.ssm_ngroups}, conv "
                f"{cfg.ssm_conv}, vocab {cfg.vocab_size}, tied embeddings "
                f"{cfg.tie_embeddings}")
    return (f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")


def serve_phase(arch):
    from repro_torch.configs.registry import get_config, make_model
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import serve_policy
    from repro_torch.launch.serve import greedy_generate, make_prefill, make_serve_step

    prompt_len, max_len = SERVE[arch]
    cfg = get_config(arch).with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    log(f"== serve: {cfg.name} {describe(cfg)}, {cfg.num_layers} layers")
    dev = torch.device("cuda")
    bundle = make_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"   params: {n} ({n * 2 / 1e9:.2f} GB bf16) built on the card in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # warm-up at the main path's shapes (cuBLAS handles and heuristics, the
    # caching allocator); its launches are not counted
    prompts = torch.randint(0, cfg.vocab_size, (CLIENTS, prompt_len), device=dev)
    prefill = make_prefill(bundle, max_len, torch.bfloat16)
    step = make_serve_step(bundle)
    t0 = time.perf_counter()
    tok, cache = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    step(params, tok, cache)
    del tok, cache
    torch.cuda.synchronize()
    log(f"   warm-up: first prefill {cold_ms:.2f} ms (cold)")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_policy.serve(cfg, clients=CLIENTS, prompt_len=prompt_len, tokens=TOKENS,
                             max_len=max_len, device=dev, params=params,
                             deadline_ms=1000.0)
    counts = ops.launch_counts()
    k1_routes = dict(K1.flash_attention.launches_by_route)
    k3_routes = dict(K3.ssd_scan.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    st = out["stats"]
    steps = st["batches"]
    log(f"   launches: {counts}; decode steps (batches) {steps}, occupancy "
        f"{st['batch_occupancy'] / max(steps, 1):.2f}")
    want = expected_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    # every prefill attention call is bf16 at D 128 or 256: all on wgmma
    if k1_routes != {"wgmma": want["flash_attention"], "cuda_cores": 0}:
        raise AssertionError(f"K1 launches by route {k1_routes}: expected all "
                             f"{want['flash_attention']} on wgmma")
    # every prefill SSD scan is bf16 at P 64, N 128: all on wgmma
    if k3_routes != {"wgmma": want["ssd_scan"], "cuda_cores": 0}:
        raise AssertionError(f"K3 launches by route {k3_routes}: expected all "
                             f"{want['ssd_scan']} on wgmma")
    log(f"   K1 launches by route: {k1_routes}; K3 launches by route: {k3_routes}")
    total = CLIENTS * TOKENS
    log(f"   prefill_ms {out['prefill_s'] * 1e3:.2f} ({CLIENTS}x{prompt_len} tokens); "
        f"decode {out['decode_s'] * 1e3 / steps:.2f} ms/step wall, "
        f"{st['compute_s'] * 1e3 / steps:.2f} ms/step in policy_step; "
        f"{total / out['decode_s']:.1f} tok/s; peak memory {peak / 1e9:.2f} GB")
    for cid, toks in out["tokens"].items():
        if len(toks) != TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"client {cid} got {toks}")
    if steps != TOKENS:
        raise AssertionError(f"{steps} decode steps for {TOKENS} tokens: a batch "
                             f"missed a client")
    greedy = greedy_generate(bundle, params, {"tokens": torch.as_tensor(
        out["prompts"], device=dev)}, steps=TOKENS + 1, max_len=max_len,
        dtype=torch.bfloat16).cpu()
    for cid in range(CLIENTS):
        if [out["first"][cid]] + out["tokens"][cid] != greedy[cid].tolist():
            raise AssertionError(f"client {cid}: served tokens differ from greedy")
    log(f"   served tokens equal greedy decoding; client 0: {out['tokens'][0][:8]}...")

    # where the device time goes: one profiled prefill and three decode steps
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        tok, cache = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
    pre, pre_ops = device_breakdown(prof, 1)
    with profile(activities=acts) as prof:
        for _ in range(3):
            tok, cache = step(params, tok, cache)
        torch.cuda.synchronize()
    dec, dec_ops = device_breakdown(prof, 3)
    # a kernel the path launches holds device time in its group, and only then
    for g, name, found in (("K1", "flash_attention", pre), ("K2", "decode_attention", dec),
                           ("K3", "ssd_scan", pre), ("K4", "rglru_scan", pre)):
        if (want[name] > 0) != (found[g] > 0):
            raise AssertionError(f"profiler group {g} holds {found[g]} ms; the path "
                                 f"launches {name} {want[name]} times a serve run")
    wall_step = out["decode_s"] * 1e3 / steps
    log(f"   device time per prefill (ms): {json.dumps(pre)}")
    log(f"   device time per decode step (ms): {json.dumps(dec)}; device idle share "
        f"{1 - dec['busy'] / wall_step:.3f} of the {wall_step:.2f} ms wall step")
    log(f"   device operations (kernels, copies, fills) per decode step {dec_ops:.0f} "
        f"({dec_ops / cfg.num_layers:.1f} per layer), per prefill {pre_ops:.0f}")
    return counts, {"prefill_ms": out["prefill_s"] * 1e3, "prefill_cold_ms": cold_ms,
                    "decode_ms_per_step": wall_step,
                    "policy_step_ms": st["compute_s"] * 1e3 / steps,
                    "tok_per_s": total / out["decode_s"], "peak_gb": peak / 1e9,
                    "prefill_device_ms": pre, "decode_device_ms_per_step": dec,
                    "decode_idle_share": 1 - dec["busy"] / wall_step,
                    "prefill_device_ops": pre_ops, "decode_device_ops_per_step": dec_ops}


def union_ms(spans):
    """Milliseconds covered by (start, end) spans in microseconds, each
    instant counted once however many spans cover it."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def device_breakdown(prof, n):
    """Device time per call from a profiler trace, grouped: the port's
    kernels (K1 and K3 either route, K2 its split and combine passes, K1-bwd
    its three kernels), GEMMs
    (cuBLAS / CUTLASS), and everything else; and the number of device
    kernels per call. A group's time, and "busy" over all of them, count
    each instant once: K2's combine is launched while its split pass runs."""
    spans = {g: [] for g in ("K1", "K1-bwd", "K2", "K3", "K4", "K4-bwd", "gemm", "other")}
    kernels = 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        kernels += 1
        name = e.name.lower()
        if "flash_kernel" in name or "flash_wgmma_kernel" in name:
            g = "K1"
        elif "flash_bwd_" in name:
            g = "K1-bwd"
        elif "rglru_bwd_kernel" in name:
            g = "K4-bwd"
        elif "decode_split_kernel" in name or "decode_combine_kernel" in name:
            g = "K2"
        elif "ssd_chunk_kernel" in name or "ssd_wgmma_kernel" in name:
            g = "K3"
        elif "rglru_chunk_kernel" in name:
            g = "K4"
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas")):
            g = "gemm"
        else:
            g = "other"
        spans[g].append((e.time_range.start, e.time_range.end))
    groups = {"busy": union_ms([s for found in spans.values() for s in found]) / n}
    groups.update({g: union_ms(found) / n for g, found in spans.items()})
    if groups["busy"] <= 0:
        raise AssertionError("the profiler recorded no device time")
    return groups, kernels / n


def parity_phase(arch, prompt_len):
    from repro_torch.configs.registry import make_model, smoke_config
    from repro_torch.launch.serve import greedy_generate

    log(f"== parity: {arch} reduced config, card vs CPU, fp32, TF32 off, "
        f"{prompt_len}-token prompts")
    cfg = smoke_config(arch)
    bundle = make_model(cfg)
    cpu = bundle.init(0, device="cpu", dtype=torch.float32)
    gpu = bundle.init(0, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=gen)
    max_len = prompt_len + 40
    o_cpu, _ = bundle.prefill(cpu, {"tokens": tokens}, max_len=max_len, dtype=torch.float32)
    o_gpu, _ = bundle.prefill(gpu, {"tokens": tokens.cuda()}, max_len=max_len,
                              dtype=torch.float32)
    err = max_err(o_gpu.logits.cpu(), o_cpu.logits)
    if not (torch.isfinite(o_gpu.logits).all() and err < 1e-4):
        raise AssertionError(f"prefill logits differ by {err}")
    t_cpu = greedy_generate(bundle, cpu, {"tokens": tokens}, 12, max_len, torch.float32)
    t_gpu = greedy_generate(bundle, gpu, {"tokens": tokens.cuda()}, 12, max_len, torch.float32)
    if not torch.equal(t_gpu.cpu(), t_cpu):
        raise AssertionError(f"greedy tokens differ:\n{t_gpu.cpu()}\n{t_cpu}")
    log(f"   prefill logits max_abs_err {err:.3e} (< 1e-4); 12 greedy tokens equal: "
        f"{t_cpu[0].tolist()}")


def grad_guard_phase():
    """A kernel with no backward kernel refuses an input that requires a
    gradient, rather than return a tensor with no grad_fn."""
    from repro_torch.kernels import ops
    log("== grad guards: K1 bf16, K2 and K3 under autograd on the card")
    dev = torch.device("cuda")
    q = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn(1, 32, 2, 64, device=dev, requires_grad=True)
    x = torch.randn(1, 16, 2, 16, device=dev, requires_grad=True)
    bm = torch.randn(1, 16, 1, 16, device=dev)
    calls = {"K1 bf16": lambda: ops.flash_attention(q, q, q),
             "K2": lambda: ops.decode_attention(kv[:, 0], kv, kv,
                                                torch.ones(1, dtype=torch.int32, device=dev)),
             "K3": lambda: ops.ssd_scan(x, torch.rand(1, 16, 2, device=dev),
                                        -torch.ones(2, device=dev), bm, bm)}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            log(f"   {name}: NotImplementedError: {str(e)[:90]}...")
        else:
            raise AssertionError(f"{name} ran under autograd with no backward kernel")
    with torch.no_grad():
        if ops.flash_attention(q, q, q).grad_fn is not None:
            raise AssertionError("K1 under no_grad recorded a graph")


@contextlib.contextmanager
def plain_versions(ops):
    """The model's calls of K1 and K4 (``ops.flash_attention``,
    ``ops.rglru_scan``) taken by their plain versions on the card, for the
    gradient comparison only; the port's wrappers never do this."""
    saved = ops.flash_attention, ops.rglru_scan
    ops.flash_attention = lambda q, k, v, **kw: ops.flash_attention_plain(q, k, v, **kw)
    ops.rglru_scan = lambda a, b, **kw: ops.rglru_scan_plain(a, b, **kw)
    try:
        yield
    finally:
        ops.flash_attention, ops.rglru_scan = saved


def live_table(params, cfg):
    """Scale the tied embedding table by 1 / d_model, in place. At the
    published init (N(0, 1), sigma 1) the residual stream carries each
    input token's own embedding, whose logit (d_model sigma, 2560 here)
    dwarfs the others (std sqrt(d_model) sigma, 51): the softmax is
    one-hot, and in fp32 the V-trace loss and every gradient are exactly 0,
    so a step would carry no gradient through the backward kernels. At
    sigma = 1 / d_model the self logit is 1 and every term of the loss is
    alive."""
    with torch.no_grad():
        params.embed.table.mul_(1.0 / cfg.d_model)


def train_parity_phase():
    """At 3 layers (rglru, rglru, local) of full width, the V-trace loss and
    every gradient leaf through K1, K1-bwd, K4 and K4-bwd against the same
    through their plain versions under autograd, on the card in fp32."""
    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = TRAIN["batch"], TRAIN["seq"]
    run = train.setup(TRAIN["arch"], batch=b, seq=s, steps=1, device="cuda", num_layers=3)
    log(f"== train parity: {run.cfg.name} at {run.cfg.num_layers} layers, full width, fp32, "
        f"batch {b} x seq {s}: gradients through the kernels vs their plain versions")
    params = run.make_state()["params"]
    live_table(params, run.cfg)
    named = dict(params.named_parameters())
    batch = run.batch_at(0)
    loss_fn = make_vtrace_loss(run.bundle)
    ops.reset_launch_counts()
    loss, _ = loss_fn(params, batch)
    got = param_grads(loss, named)
    counts = ops.launch_counts()
    with plain_versions(ops):
        loss_p, _ = loss_fn(params, batch)
        want = param_grads(loss_p, named)
    if ops.launch_counts() != counts or counts["flash_attention_bwd"] != 1 \
            or counts["rglru_scan_bwd"] != 2:
        raise AssertionError(f"launches {counts} then {ops.launch_counts()}: want 1 K1 and 2 K4 "
                             "calls and backward calls through the kernels, none through the "
                             "plain versions")
    check_close("loss", loss.detach(), loss_p.detach(), 1e-5)
    worst = max((float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30), n)
                for n, w in want.items())
    for n, w in want.items():
        err = (got[n] - w).abs()
        if not bool((err <= GRAD_TOL * float(w.abs().max()) + GRAD_TOL * w.abs()).all()):
            raise AssertionError(f"gradient {n}: kernels vs plain versions differ by "
                                 f"{float(err.max()):.3e} of max {float(w.abs().max()):.3e}")
    log(f"   loss {float(loss):.6f} (plain {float(loss_p):.6f}); {len(want)} gradient leaves "
        f"within {GRAD_TOL:g} of each leaf's max |g| (the worst {worst[0]:.2e}, {worst[1]})")
    del params, named, got, want, loss, loss_p


def expected_train_launches(cfg, steps):
    """A V-trace step of RecurrentGemma runs K1 and K1-bwd once per local
    layer, K4 and K4-bwd once per recurrent layer, and no K2 or K3."""
    from repro_torch.models.recurrentgemma import layer_kinds
    n_rec = layer_kinds(cfg).count("rglru")
    n_att = cfg.num_layers - n_rec
    return {"flash_attention": n_att * steps, "decode_attention": 0, "ssd_scan": 0,
            "rglru_scan": n_rec * steps, "flash_attention_bwd": n_att * steps,
            "rglru_scan_bwd": n_rec * steps}


def train_phase():
    """recurrentgemma-2b at full width trains TRAIN["steps"] steps through
    ``repro_torch.launch.train``'s functions, from its init with the table
    scaled by ``live_table``; then two steps timed on the
    host clock around a synchronised step, the step's parts on CUDA events,
    and a profiler breakdown of one step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import apply_updates
    from repro_torch.utils.tree import tree_bytes, tree_size

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    run = train.setup(TRAIN["arch"], batch=b, seq=s, steps=steps, device="cuda")
    cfg = run.cfg
    log(f"== train: {cfg.name} {describe(cfg)}, {cfg.num_layers} layers, fp32 params and AdamW "
        f"moments, batch {b} x seq {s}, {steps} steps through repro_torch.launch.train")
    t0 = time.perf_counter()
    state = run.make_state()
    live_table(state["params"], cfg)
    torch.cuda.synchronize()
    n = tree_size(state["params"])
    log(f"   params {n} ({tree_bytes(state['params']) / 1e9:.2f} GB fp32; with both moments "
        f"{3 * tree_bytes(state['params']) / 1e9:.2f} GB) built on the card in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = train.train_loop(run, state, 0, steps, log=lambda m: log(f"   {m}"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    k1_routes = dict(K1.flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != expected {want}")
    if k1_routes != {"wgmma": 0, "cuda_cores": want["flash_attention"]}:
        raise AssertionError(f"K1 launches by route {k1_routes}: fp32 takes the CUDA cores")
    loss = [float(m["loss"]) for m in history]
    gnorm = [float(m["grad_norm"]) for m in history]
    if not (all(map(math.isfinite, loss + gnorm)) and min(gnorm) > 0) or state["step"] != steps:
        raise AssertionError(f"loss {loss}, grad_norm {gnorm} (finite and > 0 wanted), "
                             f"step {state['step']}")
    log(f"   launches: {counts}; K1 by route {k1_routes}; loss {loss}, grad_norm {gnorm}; "
        f"{steps} steps in {run_s:.2f} s (the first warms cuBLAS and the allocator); peak "
        f"memory {peak / 1e9:.2f} GB")

    step_ms = []
    for i in range(2):
        batch = run.batch_at(steps + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    # the step's parts, called as make_train_step calls them, CUDA events
    # between: each part's share of the step's device timeline
    loss_fn = make_vtrace_loss(run.bundle)
    named = dict(state["params"].named_parameters())
    batch = run.batch_at(steps + 2)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    lv, _ = loss_fn(state["params"], batch)
    ev[1].record()
    grads = param_grads(lv, named)
    ev[2].record()
    updates, state["opt_state"], _ = run.opt.update(grads, state["opt_state"], named,
                                                    state["step"])
    apply_updates(named, updates)
    ev[3].record()
    torch.cuda.synchronize()
    state["step"] += 1
    del lv, grads, updates
    parts = {p: ev[i].elapsed_time(ev[i + 1])
             for i, p in enumerate(("forward", "backward", "optimizer"))}
    total = sum(parts.values())
    log(f"   step wall (host clock, synchronised) {step_ms[0]:.2f}, {step_ms[1]:.2f} ms; "
        f"{b * s / (step_ms[1] / 1e3):.0f} tokens/s; parts (CUDA events) "
        + ", ".join(f"{p} {t:.2f} ms ({t / total:.3f})" for p, t in parts.items()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = run.train_step(state, run.batch_at(steps + 3))
        torch.cuda.synchronize()
    groups, n_ops = device_breakdown(prof, 1)
    for g in ("K1", "K1-bwd", "K4", "K4-bwd"):
        if groups[g] <= 0:
            raise AssertionError(f"profiler group {g} holds no device time in a train step")
    if groups["K2"] or groups["K3"]:
        raise AssertionError(f"K2 or K3 ran in a train step: {groups}")
    log(f"   device time of a step (ms): {json.dumps(groups)}; {n_ops:.0f} device operations")
    del state, named, m
    return counts, {"step_ms": step_ms, "tokens_per_s": b * s / (step_ms[1] / 1e3),
                    "parts_ms": parts, "peak_gb": peak / 1e9, "params": n, "loss": loss,
                    "grad_norm": gnorm, "device_ms": groups, "device_ops": n_ops}


def train_restart_phase():
    """The launcher on the card at the reduced config: checkpoints every 2
    steps, a failure injected at step 3, the supervisor restores step 2 and
    runs to the end."""
    import io
    import tempfile

    from repro_torch.launch import train
    log("== train restart: recurrentgemma-2b reduced config on the card, --ckpt-every 2 "
        "--fail-at 3 --steps 6")
    with tempfile.TemporaryDirectory() as d:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = train.main(["--arch", TRAIN["arch"], "--smoke", "--steps", "6", "--seq",
                                "48", "--ckpt-dir", d, "--ckpt-every", "2", "--fail-at", "3"])
        lines = out.getvalue().splitlines()
    for line in lines:
        log(f"   {line}")
    if "done (restarts: 1)" not in lines or "final step: 6" not in lines \
            or state["step"] != 6 or not state["params"].embed.table.is_cuda:
        raise AssertionError("the launcher did not restart from its checkpoint to the end")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from the "
              "repository's root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    card = card_identity()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    log(f"== build: {', '.join(build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    k4_ptxas, bwd_ptxas = {}, {"k1": {}, "k4": {}}
    for name, rep in reports.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", rep)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", rep) if int(x)]
        log(f"   {name}: {len(regs)} instantiations, {min(regs)}-{max(regs)} registers "
            f"a thread, {len(spills)} with spills ({sum(spills)} bytes)")
        for entry in rep.split("Compiling entry function")[1:]:
            # K1's and K3's tensor-core routes, one line an instantiation
            found = re.search(r"(flash_wgmma_kernel|ssd_wgmma_kernel)ILi(\d+)E", entry)
            if found:
                used = re.search(r"Used (\d+) registers", entry).group(1)
                spill = re.search(r"(\d+) bytes spill stores", entry).group(1)
                log(f"   {found.group(1)}<{found.group(2)}>: {used} registers, {spill} bytes "
                    f"of spill stores")
            found = re.search(r"rglru_chunk_kernelI(f|13__nv_bfloat16)E", entry)
            if found:   # K4, one line an output type
                y = "fp32" if found.group(1) == "f" else "bf16"
                k4_ptxas[f"registers_{y}_y"] = int(re.search(r"Used (\d+) registers",
                                                             entry).group(1))
                k4_ptxas[f"spill_bytes_{y}_y"] = int(re.search(r"(\d+) bytes spill stores",
                                                               entry).group(1))
                log(f"   rglru_chunk_kernel<{y} y>: {k4_ptxas[f'registers_{y}_y']} registers, "
                    f"{k4_ptxas[f'spill_bytes_{y}_y']} bytes of spill stores")
            # K1-bwd, one line a kernel and head_dim, and K4-bwd
            found = re.search(r"(flash_bwd_dkdv_kernel|flash_bwd_dq_kernel)ILi(\d+)E|"
                              r"(flash_bwd_delta_kernel|flash_bwd_reduce_kernel|"
                              r"rglru_bwd_kernel)", entry)
            if found:
                kernel = found.group(1) or found.group(3)
                used = int(re.search(r"Used (\d+) registers", entry).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
                log(f"   {kernel}{f'<{found.group(2)}>' if found.group(2) else ''}: {used} "
                    f"registers, {spill} bytes of spill stores")
                if kernel == "rglru_bwd_kernel":
                    bwd_ptxas["k4"].update(registers=used, spill_bytes=spill)
                elif found.group(2) == "256":   # the train call's head_dim
                    short = kernel.split("_")[2]
                    bwd_ptxas["k1"].update({f"registers_{short}_256": used,
                                            f"spill_bytes_{short}_256": spill})

    rows = kernel_phase(k4_ptxas, bwd_ptxas)
    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's launches are the sum over the paths that run it
    # (K1 and K2 run on qwen3's and RecurrentGemma's)
    serve_metrics, launches = {}, dict.fromkeys(rows, 0)
    for arch in SERVE:
        counts, serve_metrics[arch] = serve_phase(arch)
        for name in launches:
            launches[name] += counts[name]
        torch.cuda.empty_cache()
    # mamba: 150 tokens span two of K3's 64-step chunks and a tail;
    # RecurrentGemma: 150 tokens overflow the reduced config's window of 32,
    # so K1's window mask and the ring's wrap in prefill and decode all run
    parity_phase("qwen3-14b", 24)
    parity_phase("mamba2-2.7b", 150)
    parity_phase("recurrentgemma-2b", 150)
    grad_guard_phase()
    train_parity_phase()
    torch.cuda.empty_cache()
    counts, train_metrics = train_phase()
    for name in launches:
        launches[name] += counts[name]
    torch.cuda.empty_cache()
    train_restart_phase()

    for name, row in rows.items():
        row["launches"] = launches[name]
    for arch, metrics in serve_metrics.items():
        log(f"serve {arch}: {json.dumps(metrics)}")
    log(f"train {TRAIN['arch']}: {json.dumps(train_metrics)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
