#!/usr/bin/env python3
"""K1's 3xTF32 route (the fp32 forward, with its log-sum-exp) beside patched
copies of its source, on one GPU: its timing against another stage count,
its error against fp64 against that of other roundings, and diagnostics.

    python3 tools/k1_fwd_variants.py [--baseline PATH]

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` (with
the headers it includes pasted in) changed by patches:
- ``two_stages``: a second K/V stage, the next tile's copies issued behind
  the current tile's products (174 KB at D 256, one CTA an SM): a design
  that could ship, held to the tolerances;
- accuracy variants, held to the tolerances: ``round_small``, the small
  part of each operand rounded to TF32 to nearest instead of truncated by
  the tensor core; ``four_terms``, the a_small b_small product taken too;
- diagnostics, which show where the time goes and are not fp32-grade or
  not right at all (their error is reported): ``one_tf32``, each product
  one TF32 product; ``no_split``, each operand handed to the tensor core
  with a zero small part; ``no_scores``, S = Q K^T skipped (its tile taken
  as zeros); ``no_products``, O += P V skipped; ``no_stream``, only the
  first K/V tile loaded (later tiles read it again).
``--baseline`` adds another ``flash_attention.cu`` with the same C entry
point (S_kv after S, since the encoder-decoder's slice) (another checkout's, whose fp32 route may be another kernel), built
as it is. All are built by ``build.compile_sources`` into
``build/kernels/k1_fwd_variants/``; the shipped source, the baseline, the
design and the accuracy variants are checked against
``ops.flash_attention_plain`` (2e-5) and ``ops.flash_attention_lse_plain``
(1e-5). Every build's output is also held against
``chip_smoke.flash_attention_fp64`` at the training call (its max and mean
|error|), beside the plain fp32 version's. Each build is then timed by
``chip_smoke.time_ms``, in turn, ROUNDS times, at the training call (B 4,
S 256, 10 query heads on 1 kv head, D 256, window 2048) and at qwen3's
shape in fp32 (B 4, S 256, 40 query heads on 8 kv heads, D 128). Prints
the card, and one JSON line a build with its times, errors, and the
registers and spills of its fp32 instantiations from ``-Xptxas -v``.
Needs CUDA.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import LSE_TOL, card_identity, flash_attention_fp64, time_ms  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as K1  # noqa: E402
from kernel_source import patched, standalone  # noqa: E402

ROUNDS = 2
# (B, S, H, KH, D, options)
CALLS = {"train_call": (4, 256, 10, 1, 256, {"window": 2048}),
         "qwen3_d128": (4, 256, 40, 8, 128, {})}
# variant -> [(regex of a piece of the shipped source, its replacement)]
DESIGNS = {
    "two_stages": [
        (r"    if \(k0 \+ BK < kv_end\) \{   // the next tile, once every warp is done with "
         r"this one\n      __syncthreads\(\);\n      load_tile<D, NT>\(sk, kb, k0 \+ BK, Skv, ks\);\n"
         r"      load_tile<D, NT>\(sv, vb, k0 \+ BK, Skv, ks\);\n      cp_async_commit\(\);\n    \}\n",
         ""),
        (r"\(3 \* TILE \+ BQ \* SP \+ 4 \* BQ\)", "(5 * TILE + BQ * SP + 4 * BQ)"),
        (r"float\* sv = sk \+ C::TILE;", "float* sv = sk + 2 * C::TILE;"),
        (r"float\* sp = sv \+ C::TILE;", "float* sp = sv + 2 * C::TILE;"),
        (r"  for \(int k0 = kv_begin; k0 < kv_end; k0 \+= BK\) \{\n"
         r"    cp_async_wait<0>\(\);\n    __syncthreads\(\);[^\n]*\n",
         "  for (int k0 = kv_begin, stage = 0; k0 < kv_end; k0 += BK, stage ^= 1) {\n"
         "    cp_async_wait<0>();\n    __syncthreads();\n"
         "    const float* tk = sk + stage * C::TILE;\n"
         "    const float* tv = sv + stage * C::TILE;\n"
         "    if (k0 + BK < kv_end) {\n"
         "      load_tile<D, NT>(sk + (stage ^ 1) * C::TILE, kb, k0 + BK, Skv, ks);\n"
         "      load_tile<D, NT>(sv + (stage ^ 1) * C::TILE, vb, k0 + BK, Skv, ks);\n"
         "      cp_async_commit();\n    }\n"),
        (r"score_tile<D>\(sq \+ wm \* 16 \* C::P, sk \+",
         "score_tile<D>(sq + wm * 16 * C::P, tk +"),
        (r"load_b_kn\(sv \+ kk", "load_b_kn(tv + kk"),
    ],
}
ACCURACY = {
    "round_small": [(r"  small = __float_as_uint\(x - __uint_as_float\(big\)\);\n",
                     "  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & "
                     "0xFFFFE000u;\n")],
    "four_terms": [(r"  mma_tf32\((c|lo), a\.small, b\.big\);\n",
                    r"  mma_tf32(\1, a.small, b.small);\n  mma_tf32(\1, a.small, b.big);\n")],
}
DIAGNOSTICS = {
    "one_tf32": [(r"  mma_tf32\((c|lo), a\.small, b\.big\);\n  mma_tf32\(\1, a\.big, b\.small\);\n",
                  "")],
    "no_split": [(r"  big = \(__float_as_uint\(x\) \+ 0x1000u\) & 0xFFFFE000u;\n"
                  r"  small = __float_as_uint\(x - __uint_as_float\(big\)\);\n",
                  "  big = __float_as_uint(x);\n  small = 0u;\n")],
    "no_scores": [(r"score_tile<D>\([^;]*;", "x[0] = x[1] = x[2] = x[3] = 0.f;")],
    "no_products": [(r"for \(int kk = split \* KPS; kk < \(split \+ 1\) \* KPS; \+\+kk\)",
                     "for (int kk = 0; kk < 0; ++kk)")],
    "no_stream": [(r"if \(k0 \+ BK < kv_end\) \{", "if (false) {")],
}
PATCHES = {**DESIGNS, **ACCURACY, **DIAGNOSTICS}


def build_all(baseline=None) -> dict:
    """{key: (typed entry point, {instantiation: (registers, spill bytes)})}."""
    out_dir = build.BUILD_DIR / "k1_fwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = standalone((build.CSRC / "flash_attention.cu").read_text())
    texts = {"shipped": shipped}
    texts.update((name, patched(shipped, patches, f"variant {name}"))
                 for name, patches in PATCHES.items())
    if baseline:   # another checkout's source: its headers are this checkout's
        texts["baseline"] = standalone(Path(baseline).read_text())
    jobs = {}
    for key, text in texts.items():
        cu = out_dir / f"flash_attention_{key}.cu"
        cu.write_text(text)
        jobs[key] = (cu, out_dir / f"libflash_attention_{key}.so")
    reports = build.compile_sources(jobs)
    built = {}
    for key, (_, lib) in jobs.items():
        ptxas = {}
        for entry in reports[key].split("Compiling entry function")[1:]:
            found = re.search(r"(flash_tf32x3_kernel|flash_kernel)IfLi(\d+)E", entry)
            if found:   # the fp32 instantiations, one a head_dim
                ptxas[f"{found.group(1)}<fp32, {found.group(2)}>"] = (
                    int(re.search(r"Used (\d+) registers", entry).group(1)),
                    int(re.search(r"(\d+) bytes spill stores", entry).group(1)))
        built[key] = (K1.entry(ctypes.CDLL(str(lib))), ptxas)
    return built


def fp64_error(out, want64) -> dict:
    err = (out.double() - want64).abs()
    return {"max": float(err.max()), "mean": float(err.mean())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another flash_attention.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_fwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_identity()
    print(f"card: {card}", flush=True)
    built = build_all(args.baseline)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev)   # noqa: E731
    calls, errs, fp64 = {}, {key: {} for key in built}, {}
    for call, (b, s, h, kh, d, opts) in CALLS.items():
        q, k, v = rand(b, s, h, d), rand(b, s, kh, d), rand(b, s, kh, d)
        kw = dict(scale=d ** -0.5, **opts)
        want = ops.flash_attention_plain(q, k, v, **kw)
        want_lse = ops.flash_attention_lse_plain(q, k, **kw)
        want64 = flash_attention_fp64(q, k, v, **kw) if call == "train_call" else None
        if want64 is not None:
            fp64["plain_fp32"] = fp64_error(want, want64)
        for key, (fn, _) in built.items():
            go = lambda fn=fn, q=q, k=k, v=v, kw=kw: K1.fwd_launch(   # noqa: E731
                fn, q, k, v, return_lse=True, **kw)
            calls[key, call] = go
            out, lse = go()
            torch.cuda.synchronize()
            errs[key][call] = (float((out - want).abs().max()), float((lse - want_lse).abs().max()))
            if want64 is not None:
                fp64[key] = fp64_error(out, want64)
            if key not in DIAGNOSTICS:
                torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
                torch.testing.assert_close(lse, want_lse, atol=LSE_TOL, rtol=LSE_TOL)
        del want64
    print(json.dumps({"train_call_fp32_plain_vs_fp64": fp64["plain_fp32"]}), flush=True)
    runs = {key: [] for key in calls}
    for _ in range(ROUNDS):
        for (key, call), go in calls.items():
            runs[key, call].append(time_ms(f"K1 {key} {call}", go))
    for key, (_, ptxas) in built.items():
        print(json.dumps({"build": key, "ms": {call: runs[key, call] for call in CALLS},
                          "max_abs_err_out_lse": errs[key],
                          "train_call_out_vs_fp64": fp64[key],
                          "registers_spill_bytes": ptxas}), flush=True)
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
