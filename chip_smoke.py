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
   128 and 256 take its wgmma route and its fp32 cases and a bf16 one at
   D 16 its 3xTF32 route (whose log-sum-exp is held at 1e-5, at the edges
   of its 32 x 32 tiles too), each case logging its route; K3's bf16 cases with P a multiple
   of 64 and N 64 or 128 take its tensor-core route (ragged S, S under
   one chunk, two groups, no initial state, B 1, N 64), its fp32 cases
   its 3xTF32 route (also at the train call, two p tiles with N 64, and
   P and N off multiples of 4) and a bf16 one at P 16 its CUDA-core
   route, each case logging its route, with a nonzero initial state,
   fewer groups than heads, and in fp32 its final state against the
   sequential oracle; K4 (a chunked scan
   over S) with S over many of its tiles and ragged, S 1, S under one
   chunk, W under its strip and not a multiple of it, B 1, an fp32 and a
   bf16 y each with and without an initial state; kernel, plain and
   library times, each call's bound, K3's TFLOP/s, TB/s and CTA plan, and
   K4's TB/s, CTA plan (lanes a strip, steps a chunk, chunks a tile, CTAs,
   waves), registers and spills, and its time on inputs cold in L2; K1
   and K2 at gemma2-9b's calls with its attention softcap of 50 (K1 at
   4352 tokens with its window of 4096 ending inside them, and without a
   window; K2 on a global cache of 4416 slots and a wrapped ring of 4096,
   and at the reduced widths in fp32), also with q scaled so that the cap
   bends the logits, and timed there, where SDPA (no softcap) is timed
   beside them but is no library cell; K1 also at starcoder2-15b's and
   internvl2-1b's calls; K1 and K2 at qwen3-moe-30b-a3b's calls, and K1
   at deepseek's MLA call (q and k of 192, v of 128, zero-padded to
   head_dim 256), held to its plain version and to SDPA on the unpadded
   inputs, which is its library cell; K1 with k and v of a length of their
   own (no mask) on both routes: seamless-m4t-large-v2's encoder call (4,
   1024, 16/16, D 64) and cross call (256 queries over 1024 frames), S_kv
   ragged against the key tiles, shorter and longer than S, and the
   reduced config's cross call in fp32 (with its log-sum-exp), timed at
   seamless's three calls beside SDPA; K2 at seamless's cross decode (1024
   frames, all valid) and self decode, timed too; K1 (prefill, causal, bf16
   and fp32, D 128) and K2 (decode, at its split edges, bf16 and fp32) at
   qwen3-14b's production TP padding, 48 query heads over 8 kv heads (a
   group of 6, which no other call has), K1 and K2 timed there beside SDPA;
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
   each kernel the path launches must hold device time in its group; then
   the rest of the dense family at full width and depth, K1 once a layer a
   prefill and K2 once a layer a decode step: gemma2-9b (42 layers,
   4352-token prompts past its window of 4096, so its local layers' rings
   wrap, which the phase checks), starcoder2-15b (40), qwen2.5-32b (64,
   65.5 GB of weights) and internvl2-1b (24, text prompts); each of these
   phases prints its seconds; then the MoE family: qwen3-moe-30b-a3b at
   full width and depth (48 layers of 128 experts, top 8, 61 GB of bf16
   weights), K1 48 a prefill and K2 48 a decode step, and deepseek-v3-671b
   at full width cut to 4 layers (3 first dense layers and 1 MoE layer of
   256 experts, MLA, the MTP block built), K1 4 a prefill on the padded
   head_dim 256 and no K2 (MLA decodes in its absorbed form, plain);
   each checks that the fp32 router runs without TF32, prints the (token,
   expert) pairs the capacity dropped in the prefill and in the decode
   steps, and holds the served batch's logits at every prefill position
   and 3 decode steps' logits to the plain versions, with the kernels'
   routing forced (bf16, rms error <= 5e-2 of the rms) and routing for
   themselves (each MoE layer's share of (token, k) choices in common;
   argmax equal on at least MOE_ARGMAX_SHARE of the rows); its profiler
   breakdown adds the groups moe_gemm, moe_dispatch (with its costliest
   kernels) and mla_decode; then the ring wrap: gemma2-9b cut to one
   local and one global layer at full width, fp32, 4352-token prompts:
   the prefill's logits at every position and 16 decode steps' logits and
   greedy tokens through K1 and K2 against their plain versions; then the
   encoder-decoder: seamless-m4t-large-v2 at full width and depth (24
   encoder and 24 decoder layers, 1.63 B params, bf16) on 256-token
   prompts over 1024 seeded frames, K1 72 a prefill (24 encoder, 24 self-
   and 24 cross-attention calls, all on `wgmma`) and K2 48 a decode step
   (24 self, 24 cross), its served batch's logits after the prefill and 3
   decode steps held to the plain versions (rms error <= 5e-2 of the rms);
   then sharded serving: qwen3-14b at its production TP padding (tp 16:
   40 query heads padded to 48 over 8 kv heads, vocab 151936 padded to
   152064), full width and depth, bf16, its params DTensors on a one-rank
   CUDA DeviceMesh with the decode rules active, through the
   InferenceServer: K1 40 a prefill and K2 40 a step (the kernels on each
   rank's shards through local_map), served tokens equal greedy decoding
   under the mesh, the prefill's last logits and 3 decode steps' held to
   the plain versions (the real vocab's; the padded ids' -1e30 apart),
   random values in the padded rows of every wq and wo leaving the
   kernels' logits bit-identical, and prefill ms, decode ms a step, device
   ms and peak memory printed beside the unpadded phase's; then reshard:
   the reduced qwen3-14b's tp-2 train state checkpointed on the host and
   restored by ``launch.ft.reshard_state`` onto the one-rank CUDA mesh,
   every leaf bit-equal and on the card;
5. parity: at each arch's reduced config, prefill logits and greedy tokens
   from the port on the card equal the port on the CPU (the plain
   versions), in fp32 (150-token prompts for gemma2-9b, starcoder2-15b,
   qwen2.5-32b and internvl2-1b: gemma2's reduced window is 32; and for
   qwen3-moe-30b-a3b and deepseek-v3-671b at capacity factors 8.0 and
   1.25, where pairs must drop, every route compared; and for
   seamless-m4t-large-v2, 12-token prompts over the reduced config's 8
   frames, so that K1's fp32 cross call has k and v of a length of their
   own);
6. grad guards: K1's bf16 route, K2 and K3's bf16 routes raise under
   autograd (they have no backward kernel) instead of returning a tensor
   with no grad_fn; K3 in fp32 and K1 in fp32 with k and v of a length of
   their own return tensors with a grad_fn;
7. train parity: recurrentgemma-2b at 3 layers of full width, fp32: the
   V-trace loss through K1, K1-bwd, K4 and K4-bwd against the same
   through their plain versions on the card; each of those kernel calls
   (outputs and input gradients) against its plain version on the same
   inputs; every gradient leaf with K1 and K1-bwd in the model; every
   gradient leaf with all four kernels against K1 and K4 in fp64, no
   farther than FP64_MARGIN times the plain fp32 versions are; then
   mamba2-2.7b at 3 layers and seamless-m4t-large-v2 at 2+2 layers of full
   width, fp32 (``family_train_parity_phase``): the loss through K3 and
   K3-bwd, or K1 and K1-bwd (its cross calls at S_kv 1024 against S 256),
   against the plain versions within 1e-5, one step's launches, and every
   gradient leaf within GRAD_TOL of the plain versions' or, where farther,
   held to the kernels in fp64 as RecurrentGemma's leaves are;
8. train: recurrentgemma-2b (26 layers, 2.89 B params), mamba2-2.7b (64
   layers) and seamless-m4t-large-v2 (24+24 layers, over 1024 seeded
   frames) at full width and depth, fp32 params and AdamW moments, each
   take 3 steps at batch 4 x seq 256 through ``repro_torch.launch.train``'s
   functions; launches a step: RecurrentGemma K1 and K1-bwd 8, K4 and
   K4-bwd 18; Mamba2 K3 and K3-bwd 64; seamless K1 and K1-bwd 72, 24 of
   each at S_kv 1024 against S 256; no K2 anywhere; loss and grad_norm
   finite; then the step's wall time, tokens/s, the forward, backward and
   optimizer parts, peak memory, a profiler breakdown (the family's
   kernel groups non-zero, every other kernel group empty) and the phase's
   seconds;
9. train restart: the launcher at the reduced config on the card,
   checkpointing every 2 steps, restarts from its checkpoint after a
   failure injected at step 3 and ends at step 6;
10. R2D2 parity: the conv-LSTM agent at the example's reduced config, fp32
   with TF32 off: the forward's q-values and final LSTM state,
   decode_step, and make_r2d2_loss's loss, priorities and every gradient
   leaf, with and without is_weights, card against CPU within 1e-4 of
   each tensor's max;
11. R2D2 learner at the published widths (84x84x4, core 512, 18 actions,
   burn-in 40, unroll 80): batches of 64 x 120 from prioritized replay
   through the R2D2 train step, 3 warm steps and 5 timed; ms/step, frames
   trained/s, the parts (online forward, target forward, loss, backward,
   optimizer) on CUDA events, a profiler breakdown (convolutions, GEMMs,
   the LSTM gates, the rest; device operations; idle share; AdamW alone),
   peak memory, the host's cost of sampling a batch and moving it, and
   the FLOPs FlopCounterMode counts over one step (Fig 2's card row);
12. R2D2 system: SeedSystem (host backend, in-process transport) built by
   ``repro_torch.launch.train_r2d2.build`` at the published widths,
   actors from the host's core count, 8 lanes each of ALESimEnv(frame=84,
   channels=4), learner batch 64, for a 20 s window: env frames/s, learner
   steps/s, batch occupancy, queue wait, inference and learner seconds;
   env_frames == actor_iterations * lanes, learner steps > 0, no learner or
   inference error, every parameter and the slot state on the card;
13. V-trace parity: Fig 3f's model, mlp_actor_critic(50, 3, hidden=64),
   from seeded params, fp32 with TF32 off, card against CPU: logits and
   values within 1e-5 of their max; one V-trace train step's loss,
   metrics and every updated leaf within 1e-4 of each one's max; the
   sampling policy's logprob at its sampled action against the CPU's
   log_softmax, and against the learner's (B, T) forward on the card (the
   ratio mean_rho reads at lag 0), within 1e-6; Catch's step on every live
   state with every action: reward, done, and the obs and state of every
   lane that goes on, equal;
14. V-trace system (Fig 3f): SeedSystem (host backend, in-process
   transport, algo="vtrace") built by ``repro_torch.launch.train_vtrace``
   for 1, 2 and 4 actors x 4 lanes of CatchEnv(10, 5) batched on the card,
   unroll 8, learner batch 4, max_param_lag 50, every point from the same
   seeded params, a 5 s window each: generated and trained frames/s, drop
   rate, mean param lag and trained lag, learner steps, occupancy, queue
   wait, inference compute_s, the learner's train against wait seconds;
   generated == trained + dropped, none pending, trained > 0, env_frames
   == actor_iterations * 4, no learner or inference error, every param,
   AdamW moment, the policy's copy and the env's state on the card; then
   the train step alone at 4 x 8: ms a step on CUDA events and the device's
   idle share from the profiler; and an actor iteration's two parts alone
   on the host clock, the policy call and a Catch vector step at 4 lanes;
15. device-backend parity: ``repro_torch.rollout``'s engine, its T-step
   unroll captured as one CUDA graph, on CatchEnv(10, 5), CartPole and
   TokenWorld at E 8 and 4096, T 16, with the V-trace sampler on
   mlp_actor_critic (TokenWorld's token one-hot), fp32 with TF32 off:
   after `warmup`, two back-to-back replays against a step-by-step loop
   on the card from the seed over 2T steps (actions, dones and Catch's and
   TokenWorld's obs exactly; rewards, CartPole's obs and the behavior
   logprobs within 1e-6, the logprobs also against log_softmax at the
   recorded obs and actions); the two replays draw different actions; one
   capture an engine; a changed param is seen by the next replay;
16. device-backend system: ``repro_torch.launch.rollout_backends``'s three
   design points (per-step host E 1, vectorized host E 8, device-resident
   E 8; 2 actors, unroll 16, CatchEnv(10, 5), uniform random policy) and
   its engine_shards 1 and 2 (unroll 8), 5 s each: env frames/s, scans,
   env_frames == scans * T * E, one capture an engine, and the reference's
   device-resident >= vectorized-host line (printed, not asserted); then
   V-trace through ``train_vtrace.build(backend="device")`` at 1, 2 and 4
   actors x 4 lanes, unroll 8, learner batch 4, max_param_lag 10: the Fig
   3f row, drops by cause, the learner's train against wait seconds, the
   ledger conserved and settled, trained > 0, no error, one capture an
   engine, every param, AdamW moment, engine param copy and env state on
   the card; then one engine alone at E 8, 64, 512 and 4096, T 16: ms a
   replay on CUDA events, the host ms of the copy back and of the
   per-lane flush, device operations of a replay from the profiler and
   its idle share (the profiler's busy time over the replay's CUDA-event
   time), one RolloutWorker's env frames/s, and t_dev0 and t_dev1
   fitted by least squares, in seconds and in units of t_env (a Catch
   vector step at 1 lane alone);
17. the wire: `df -h /dev/shm` (each shm connection maps 2 x 64 MiB; a
   small /dev/shm gets a smaller ring geometry, said in the log); R2D2 at
   the published widths through ``repro_torch.launch.train_r2d2.build``,
   4 actors x 8 lanes of ALESimEnv(frame=84, channels=4), learner batch
   64, 12 s windows, in process, over TCP with 4 spawned actor hosts of
   one actor each, and over the shm rings with 4 hosts: env frames/s,
   learner steps/s, occupancy, queue wait, the learner's train and wait
   seconds and the gateway's and hosts' frame counts (an R2D2 flush, 27
   MB, spills from the 1 MiB slots to TCP); then V-trace at Fig 3f's
   configuration over shm at 1, 2 and 4 hosts of one actor, Catch on each
   child's CPU, 5 s each: the Fig-3f row and drops by cause. Each wire
   point: no host error, learner steps, env_frames == iterations x lanes
   summed over the hosts, trajectory frames over the wire, one shm
   connection a host on shm, the V-trace ledger conserved, every param
   and the slot state on the card, and no actor host with a CUDA
   context (each child reports torch.cuda.is_initialized(); nvidia-smi's
   compute list, sampled each second, lists none of their PIDs and no
   process but this one);
18. the paper's figures through ``repro_torch.benchmarks`` and
   ``repro_torch.launch.provision_system``, every row logged with the
   card's name and power limit: Fig 3a and 3c (ALESimEnv and a random
   policy on the host) and 3e's replica sweep (Catch on the card, a
   sleeping policy) at the reference's --smoke windows; 3d, 3e's engine
   shards and 3f reused from phases 16 and 14; the calibrated models (the
   3b checks within 1e-9 of the paper's 5.8 and 2.0) and the card's Fig
   3d row at phase 16's t_dev0 and t_dev1; Fig 4's derating, ratios (this
   machine with one H100 in place of the reference's TPU host) and wire
   sweep (in process, TCP, shm, Catch on the host's CPU; the shm probe's
   gate recorded, not asserted); Fig 2's card row from phase 11's step
   (shares summing to 1); the provisioning tool's report. No point may
   read zero frames or an inference error;
19. the ops and survival planes: R2D2 at phase 17's socket point (4 hosts
   of one actor x 8 lanes of ALESimEnv(frame=84, channels=4), learner
   batch 64, the policy and learner on the card) built with a
   `repro_torch.telemetry.Telemetry` and ``ops_port=0``, an 8 s window
   while a side thread scrapes /metrics, /healthz and /varz: every
   exposition validates, /healthz reads healthy in steady state, the
   auditor counts no violation, the registry's lanes equal the stats'
   and frames trail them by at most the lanes in flight, one dumped trace
   holds spans of 5 processes and flow events stitching actor ->
   gateway -> replica -> reply, no host opened CUDA; the BottleneckReport
   (class, CPU/GPU ratio, seconds a frame a plane, CPU seconds a
   process) printed beside the learner process's CPU cores and its
   compute + train seconds; then Fig 3's --telemetry, --chaos and
   --autoscale modes at --smoke through their module functions, writing
   under build/bench_torch/: every correctness check asserted, their
   wall-clock overhead gates (< 3% frames/s) printed beside their limit.
   No kernel of the port may launch in phases 10-19 (the paths have no
   Pallas kernel): the counts are set to 0 before them and read after;
20. the quickstart (``repro_torch.launch.quickstart``) on the card: the
   reduced qwen3-14b trained 20 steps (K1 on its 3xTF32 route and K1-bwd,
   4 a step), checkpointed and restored at step 20, greedy-decoded (K1 4,
   K2 28), then the SEED demos (vector lanes, the device backend, socket
   and shm hosts, replicas x gateways, engine shards, V-trace on both
   backends, telemetry, the live ops plane, a learner crash and resume),
   ending in "ok"; then ``repro_torch.benchmarks.check_trend`` on the
   history ledger phase 19 wrote (build/bench_torch/BENCH_history.json),
   exit 0 and "trend_summary,ok".

The kernel phase (3) also holds K1-bwd, K4-bwd and K3-bwd to their plain
versions (the passes each kernel runs) at the train calls, the smoke
widths, D 128 with 5 query heads a kv head, and the edges of their tiles
(K1-bwd: S 33, 65 and 300 against its 32-row tiles, a window ending
inside a key tile, D 16, and k and v of a length of their own, S_kv 1024
against S 256 at seamless's cross call, shorter and longer than S; K4-bwd:
S over many of its tiles, S 1, W 37, B 1; K3-bwd: mamba2's train call with
and without h0 and d(final state), ragged S, G < H and G == H, two p
tiles, under one chunk; K3-bwd's cases each run twice and held equal to
the bit), each case logging its route or plan, and times
them against their bounds: K1-bwd (3xTF32 on the tensor cores) against
SDPA's fp32 backward (forward and backward, less forward), split by
kernel, with its registers and spills, at RecurrentGemma's call and at
seamless's cross call; K4-bwd warm and cold in L2 with its plan; K3-bwd
(3xTF32 on the tensor cores) split by kernel, with its plan (CTAs, CTAs
an SM from the library, waves), registers and spills a kernel and its
bounds at the 3xTF32 and fp32 CUDA-core rates. K1's fp32 forward
(3xTF32) is timed at the train call too, beside SDPA's fp32 forward,
against its bounds at the 3xTF32 and the fp32 CUDA-core rates, with its
registers and spills, and K3's fp32 forward (3xTF32) at mamba2's, the
same fields as K3-bwd's, in a row of its own (``ssd_scan_tf32x3``, its
launches those of that route in the train phase).

After phase 20, when no other phase runs, a child process runs the dry
run (``python -m repro_torch.launch.dryrun``'s ``main``, no card: a fake
process group of 256 ranks on the meta device) for qwen3-14b x decode_32k,
qwen3-moe-30b-a3b x decode_32k (serving's full EP through ``moe_ep``) and
mamba2-2.7b x long_500k on the (16, 16) mesh, then the port's roofline
over its JSONL, and prints each row's FLOPs, bytes, collective bytes and
memory a rank, its terms (modelled on ``H100_SXM``'s spec, not measured)
and its wall seconds; it must exit 0.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or run from a directory
that does not hold the repository, it fails and prints no result.
"""

import contextlib
import functools
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
# HBM3 bandwidth. Bounds are stated against these. "tf32x3" is an fp32
# product on the tensor cores as three TF32 products (495 TFLOP/s dense),
# K1-bwd's arithmetic: a third of the TF32 rate in fp32 flops.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12

CLIENTS, TOKENS = 4, 16
# arch -> (prompt length, cache length); mamba's state ignores the latter,
# which only has to admit prompt + CLIENTS * TOKENS steps
SERVE = {"qwen3-14b": (256, 512), "mamba2-2.7b": (512, 576),
         "recurrentgemma-2b": (512, 576),
         # the prompt passes gemma2's window of 4096: K1's window ends inside
         # it, and each local layer's ring of 4096 slots wraps in the prefill
         # and goes on wrapping in decode
         "gemma2-9b": (4352, 4352 + CLIENTS * TOKENS),
         "starcoder2-15b": (256, 512), "qwen2.5-32b": (256, 512),
         "internvl2-1b": (256, 512),
         "qwen3-moe-30b-a3b": (256, 512), "deepseek-v3-671b": (256, 512),
         # the encoder-decoder: 256-token prompts against 1024 seeded frames
         "seamless-m4t-large-v2": (256, 512)}
PROMPT_LEN, MAX_LEN = SERVE["qwen3-14b"]
# the MoE archs: qwen3-moe-30b-a3b at full depth (48 layers, 61 GB of bf16
# weights); deepseek-v3-671b at its full width cut to 4 layers (its 3 first
# dense layers and 1 MoE layer, with the MTP block built: 53 GB), since its
# 61 layers take 1.3 TB
MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
SERVE_LAYERS = {"deepseek-v3-671b": 4}
# their reduced configs' parity, card against CPU: at the reference's smoke
# capacity factor (no drops) and at the published 1.25, where pairs drop
MOE_CAPACITY = (8.0, 1.25)
# qwen3-moe's attention (32 query heads on 4 kv heads of 128) and
# deepseek's MLA prefill (128 heads, q and k of 128 + 64, v of 128, zero-
# padded to K1's head_dim 256)
QMOE = dict(h=32, kh=4, d=128)
# qwen3-14b at its production TP padding (tp 16, the (16, 16) mesh's
# 'model' axis): 40 query heads padded to 48 over 8 kv heads of 128
TP16 = dict(h=48, kh=8, d=128, tp=16)
MLA_CALL = dict(h=128, dqk=192, dv=128, d=256)
# the share of full-depth logit rows whose argmax must agree between the
# kernels and the plain versions when each side routes for itself (a near
# tie in a router's top-k may flip an expert between them)
MOE_ARGMAX_SHARE = 0.5
# the attention calls of recurrentgemma-2b's path: 10 query heads on one kv
# head of 256, window 2048 (longer than the prompt), a ring of 576 slots
RG = dict(h=10, kh=1, d=256, window=2048)
# gemma2-9b's: 16 query heads on 8 kv heads of 256, every scaled logit
# capped at 50; its local layers' window of 4096 is their ring's size
GEMMA = dict(h=16, kh=8, d=256, window=4096, softcap=50.0, scale=0.0625)
# seamless-m4t-large-v2's attention: 16 query heads on 16 kv heads of 64;
# the encoder's K1 over its 1024 frames, the decoder's cross-attention K1
# (prefill) and K2 (decode) over them
SEAMLESS = dict(h=16, kh=16, d=64, frames=1024)
# its reduced config's parity, card against CPU: 12 tokens against 8 frames,
# so that K1's cross call has k and v of a length of their own
ENCDEC_PARITY_PROMPT = 12
# the new archs' reduced configs, card against CPU: 150 tokens pass the
# reduced window of 32 (gemma2's rings wrap)
DENSE_PARITY = ("gemma2-9b", "starcoder2-15b", "qwen2.5-32b", "internvl2-1b")
# the training path: recurrentgemma-2b at full width in fp32, its K1 and K4
# calls at batch 4 x seq 256
TRAIN = dict(arch="recurrentgemma-2b", batch=4, seq=256, steps=3)
# the archs trained at full width and depth, fp32, batch 4 x seq 256 (seamless's
# text over its 1024 frames)
TRAIN_ARCHS = ("recurrentgemma-2b", "mamba2-2.7b", "seamless-m4t-large-v2")
GRAD_TOL = 1e-4   # of a gradient tensor's max |value|, and relative
# K1-bwd's one route: every head_dim on the tensor cores, 3xTF32 mma.sync
K1_BWD_ROUTE = "tensor cores, 3xTF32 mma.sync"
LSE_TOL = 1e-5   # K1's log-sum-exp against its plain version, and relative
# how much farther from an fp64 reference a gradient leaf through the
# kernels may be than the same leaf through the plain fp32 versions
FP64_MARGIN = 2.0
# a leaf of the new families' train parity whose every element lies within
# this share of the largest leaf's max |g| of the reference passes whatever
# its own scale: the key biases' gradients are sums over every position of
# rotated dk (exactly 0 in cross-attention, which takes no rope), which
# cancel to 1e-11 to 1e-7 of the largest leaf's, where K1-bwd's dk, within
# GRAD_TOL of its own max, moves them by more than GRAD_TOL of theirs
LEAF_FLOOR = 1e-6


def log(msg):
    print(msg, flush=True)


def card_identity():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(name, fn, iters=20, warmup=3):
    """Mean device time of one call, CUDA events around `iters` calls
    behind a sleeping kernel (`repro_torch.benchmarks.timing.device_ms`)."""
    from repro_torch.benchmarks.timing import device_ms

    ms, host_limited = device_ms(fn, iters=iters, warmup=warmup)
    if host_limited:
        log(f"   ({name} is host-limited: the host could not queue ahead, so "
            "its time includes host gaps)")
    return ms


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, tol, atol=None):
    """Elementwise |got - want| <= atol + tol * |want| (atol = rtol = tol by
    default, the JAX package's kernel-test tolerances: fp32 2e-5, bf16
    2e-2). `atol` may be a tensor that broadcasts against `want`: each
    row's own."""
    err = max_err(got, want)
    atol = tol if atol is None else atol
    g, w = got.float(), want.float()
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(g).all())
          and bool(((g - w).abs() <= atol + tol * w.abs()).all()))
    said = (f"{atol:.3g}" if not torch.is_tensor(atol) else
            f"{float(atol.min()):.3g}..{float(atol.max()):.3g} by row")
    log(f"   {name}: max_abs_err {err:.3e} (atol {said}, rtol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def row_atol(want, tol, dims):
    """`tol` times the rms of each row of `want` over `dims`: an atol on the
    output's own scale. A softmax spread over thousands of keys gives
    outputs of about 0.025, where a fixed atol of 2e-2 would pass a kernel
    that dropped a split of them."""
    return tol * want.float().pow(2).mean(dims, keepdim=True).sqrt()


def gemma2_attention_checks(rand, b=CLIENTS):
    """gemma2-9b's attention calls, bf16, every scaled logit capped at 50,
    K1 and K2 against their plain versions on the card, with rtol 2e-2 and
    an atol of 2e-2 of each query row's rms (`row_atol`). `rand(*shape,
    dtype=)` draws the inputs on the card."""
    from repro_torch.kernels import decode_attention as K2
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops

    tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    gs, gmax = SERVE["gemma2-9b"]
    # K1 on wgmma: a local layer's call, whose window of 4096 ends inside the
    # 4352-token prompt (key tiles wholly outside it are skipped), and a
    # global layer's; then the local call with q scaled by 40, so that the
    # logits reach about 40 a standard deviation and the cap bends them
    # (held against the uncapped plain version too), at B 1
    gkw = {"softcap": GEMMA["softcap"], "scale": GEMMA["scale"]}
    for (cb, cs, ch, ckh, cd), kw, qmul in (
            ((b, gs, GEMMA["h"], GEMMA["kh"], GEMMA["d"]), {"window": GEMMA["window"]}, 1.0),
            ((b, gs, GEMMA["h"], GEMMA["kh"], GEMMA["d"]), {}, 1.0),
            ((1, gs, GEMMA["h"], GEMMA["kh"], GEMMA["d"]), {"window": GEMMA["window"]}, 40.0)):
        q = (rand(cb, cs, ch, cd, dtype=torch.float32) * qmul).to(torch.bfloat16)
        k, v = rand(cb, cs, ckh, cd, dtype=torch.bfloat16), rand(cb, cs, ckh, cd,
                                                                  dtype=torch.bfloat16)
        kw = {**gkw, **kw}
        got = K1.flash_attention(q, k, v, **kw)
        want = ops.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check_close(f"K1 gemma2 {(cb, cs, ch, ckh, cd)} bf16 {kw}, q x {qmul:g} "
                    f"[{K1.route(q.dtype, cd)}]", got, want, tol[torch.bfloat16],
                    row_atol(want, tol[torch.bfloat16], (2, 3)))
        if qmul > 1:
            bent = max_err(want, ops.flash_attention_plain(q, k, v, **{**kw, "softcap": None}))
            log(f"   the cap moved the plain output by {bent:.3e}")
            if bent <= tol[torch.bfloat16]:
                raise AssertionError("the softcap case does not bend the logits")
        del q, k, v, got, want

    # K2, the cap in the split pass: a global layer's cache of max_len slots
    # at a served length, one live split, a length 0 and a full cache; a
    # local layer's ring of 4096 slots after the wrap (every slot valid);
    # the reduced config's in fp32 (a global cache, a ring of 32); then q
    # scaled so that the cap bends the logits, held against the uncapped
    # plain version too
    dev = torch.device("cuda")
    sms = K2.num_sms(torch.cuda.current_device())
    gcall = (b, gmax, GEMMA["h"], GEMMA["kh"], GEMMA["d"])
    gring = (b, GEMMA["window"], GEMMA["h"], GEMMA["kh"], GEMMA["d"])
    for (cb, cs, ch, ckh, cd), dt, lens, qmul in (
            (gcall, torch.bfloat16, [gs + 8, 1, 0, gmax], 1.0),
            (gring, torch.bfloat16, [GEMMA["window"]] * b, 1.0),
            ((2, 48, 4, 2, 16), torch.float32, [0, 33], 1.0),
            ((2, 32, 4, 2, 16), torch.float32, [32, 7], 1.0),
            (gring, torch.bfloat16, [GEMMA["window"], 4000, 129, 1], 40.0),
            ((2, 48, 4, 2, 16), torch.float32, [48, 17], 8.0)):
        q = (rand(cb, ch, cd, dtype=torch.float32) * qmul).to(dt)
        k, v = rand(cb, cs, ckh, cd, dtype=dt), rand(cb, cs, ckh, cd, dtype=dt)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(scale=cd ** -0.5, softcap=GEMMA["softcap"])
        got = K2.decode_attention(q, k, v, ln, **kw)
        want = ops.decode_attention_plain(q, k, v, ln, **kw)
        torch.cuda.synchronize()
        chunk, splits = K2.plan(cb, cs, ch, ckh, cd, dt, sms)
        check_close(f"K2 {(cb, cs, ch, ckh, cd)} {str(dt)[6:]} softcap {GEMMA['softcap']:g}, "
                    f"q x {qmul:g}, lengths {lens} [chunk {chunk}, {splits} splits]", got,
                    want, tol[dt], row_atol(want, tol[dt], (1, 2)))
        if qmul > 1:
            bent = max_err(want, ops.decode_attention_plain(q, k, v, ln, scale=cd ** -0.5))
            log(f"   the cap moved the plain output by {bent:.3e}")
            if bent <= tol[dt]:
                raise AssertionError("the softcap case does not bend the logits")
        del q, k, v


@functools.cache
def compiled_flex_attention():
    from torch.nn.attention.flex_attention import flex_attention
    return torch.compile(flex_attention, dynamic=False)


def flex_attention_call(q, *, scale, softcap, mask_mod, q_len, kv_len):
    """One call of PyTorch's `flex_attention` (compiled) computing K1's or
    K2's function with gemma2's cap: q (B,H,Sq,D), k, v (B,KH,S,D), the cap
    as its score_mod (after the scale, before the mask, as the kernels),
    `mask_mod` as a block mask built here once. Returns a callable of
    (k, v). Timed as the library cell only; the port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask
    block_mask = create_block_mask(mask_mod, q.shape[0], None, q_len, kv_len,
                                   device=q.device)

    def cap(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    flex = compiled_flex_attention()
    return lambda kk, vv: flex(q, kk, vv, score_mod=cap, block_mask=block_mask, scale=scale,
                               enable_gqa=True)


def time_k1_mla(b, s, rand):
    """K1 at deepseek-v3's MLA prefill call: q and k of 128 + 64, v of 128,
    128 heads, zero-padded to head_dim 256 as ``nn/mla.py`` pads them. The
    padded call's output, cut to v's 128, is held to the plain version's and
    to SDPA's on the unpadded inputs (the library cell). The bound counts
    the unpadded work; the padding's share is noted beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops

    h, dqk, dv, dp = MLA_CALL["h"], MLA_CALL["dqk"], MLA_CALL["dv"], MLA_CALL["d"]
    sc = dqk ** -0.5
    q, k = rand(b, s, h, dqk, dtype=torch.bfloat16), rand(b, s, h, dqk, dtype=torch.bfloat16)
    v = rand(b, s, h, dv, dtype=torch.bfloat16)
    qp, kp, vp = (F.pad(x, (0, dp - x.shape[-1])).contiguous() for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    got = K1.flash_attention(qp, kp, vp, scale=sc)[..., :dv]
    want = ops.flash_attention_plain(qp, kp, vp, scale=sc)[..., :dv]
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=sc).transpose(1, 2)
    err = check_close(f"K1 MLA ({b},{s},{h},{h}) q, k {dqk}, v {dv} padded to {dp} bf16 "
                      f"[{K1.route(torch.bfloat16, dp)}]", got, want, 2e-2)
    check_close("   its plain version against SDPA on the unpadded inputs", lib, want, 2e-2)
    ms = time_ms("K1 MLA", lambda: K1.flash_attention(qp, kp, vp, scale=sc))
    plain_ms = time_ms("K1 MLA plain", lambda: ops.flash_attention_plain(qp, kp, vp, scale=sc))
    lib_ms = time_ms("K1 MLA library", lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=sc))
    pairs = s * (s + 1) // 2
    flops = 2 * (dqk + dv) * pairs * b * h            # q.k over 192, p.v over 128
    padded_flops = 2 * 2 * dp * pairs * b * h
    nbytes = b * s * h * (2 * dqk + 2 * dv) * 2       # q, k, v read, out written, unpadded
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library="SDPA, unpadded",
               **bound(flops, nbytes, "bfloat16"), tflops=flops / ms / 1e9,
               max_abs_err=err, padded_flops=padded_flops,
               padded_bound_ms=bound(padded_flops, b * s * h * 4 * dp * 2, "bfloat16")[
                   "bound_ms"])
    log(f"   K1 at MLA's call ({b},{s},{h},{h}), q and k {dqk}, v {dv}, padded to {dp}, bf16 "
        f"[{K1.route(torch.bfloat16, dp)}]: kernel_ms {ms:.4f} ({row['tflops']:.1f} TFLOP/s of "
        f"the unpadded work) plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA on the "
        f"unpadded 192/128 inputs) bound_ms {row['bound_ms']:.4f} ({row['bound_by']}, "
        f"{flops / 1e9:.1f} GFLOP unpadded; the padding makes it {padded_flops / 1e9:.1f} "
        f"GFLOP, {padded_flops / flops:.2f}x, bound {row['padded_bound_ms']:.4f})")
    return row


def kernel_phase(k1_ptxas, k4_ptxas, bwd_ptxas):
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
             ((2, 150, 4, 1, 16), torch.float32, {"window": 32}),     # RecurrentGemma reduced
             # the 3xTF32 route's 32 x 32 tiles: the train call's shape at B
             # 1, one past a tile, ragged over ten with a window ending
             # inside a key tile, no mask, D 128, and bf16 at D 16
             ((1, 256, 10, 1, 256), torch.float32, {"window": 2048}),
             ((2, 33, 4, 2, 64), torch.float32, {}),
             ((2, 300, 4, 1, 128), torch.float32, {"window": 45}),
             ((1, 65, 2, 2, 16), torch.float32, {"causal": False, "softcap": 5.0}),
             ((2, 50, 4, 2, 16), torch.bfloat16, {"window": 20}),
             # the other dense archs' calls: starcoder2-15b (48 query heads on
             # 4 kv heads of 128), internvl2-1b (14 on 2 of 64, bf16 on wgmma
             # at D 64), gemma2-9b's reduced config (window 32, capped at 50)
             ((b, s, 48, 4, 128), torch.bfloat16, {}),
             ((b, s, 14, 2, 64), torch.bfloat16, {}),
             ((2, 150, 4, 2, 16), torch.float32, {"window": 32, "softcap": 50.0}),
             # qwen3-moe-30b-a3b's call (32 query heads on 4 kv heads of 128),
             # deepseek's MLA call at K1's padded head_dim 256 (128 heads, no
             # GQA; its zero padding is checked and timed below) and the
             # reduced MLA configs' (q and k of 24, v of 16, padded to 64)
             ((b, s, QMOE["h"], QMOE["kh"], QMOE["d"]), torch.bfloat16, {}),
             ((b, s, MLA_CALL["h"], MLA_CALL["h"], MLA_CALL["d"]), torch.bfloat16, {}),
             ((2, 150, 4, 4, 64), torch.float32, {}),
             # qwen3-14b at its production TP padding (tp 16): 48 query heads
             # on 8 kv heads of 128, a group of 6, which no other call has
             ((b, s, TP16["h"], TP16["kh"], TP16["d"]), torch.bfloat16, {}),
             ((2, 200, TP16["h"], TP16["kh"], TP16["d"]), torch.float32, {})]
    main_err = None
    for (cb, cs, ch, ckh, cd), dt, kw in cases:
        q = rand(cb, cs, ch, cd, dtype=dt)
        k, v = rand(cb, cs, ckh, cd, dtype=dt), rand(cb, cs, ckh, cd, dtype=dt)
        kw = {"causal": True, **kw}
        x3 = K1.route(dt, cd) == "tf32x3"   # the route that writes the log-sum-exp
        got = K1.flash_attention(q, k, v, scale=cd ** -0.5, return_lse=x3, **kw)
        want = ops.flash_attention_plain(q, k, v, scale=cd ** -0.5, **kw)
        torch.cuda.synchronize()
        name = f"K1 {(cb, cs, ch, ckh, cd)} {str(dt)[6:]} {kw} [{K1.route(dt, cd)}]"
        if x3:
            got, lse = got
            check_close(f"{name} lse", lse, ops.flash_attention_lse_plain(
                q, k, scale=cd ** -0.5, **kw), LSE_TOL)
        err = check_close(name, got, want, tol[dt])
        main_err = err if main_err is None else main_err

    # k and v of a length of their own (the encoder-decoder's cross-
    # attention: no causal mask, no window), on both routes: seamless's
    # encoder call (S_kv == S, unmasked) and cross call (256 text queries
    # over 1024 frames), S_kv ragged against the key tiles and shorter or
    # longer than S, BK 64 at D 256, and the reduced config's cross call;
    # bf16 with an atol of 2e-2 of each row's rms (a softmax over 1024 keys
    # gives outputs of about 0.03)
    sm = SEAMLESS
    for (cb, cs, cskv, ch, ckh, cd), dt in (
            ((b, sm["frames"], sm["frames"], sm["h"], sm["kh"], sm["d"]), torch.bfloat16),
            ((b, SERVE["seamless-m4t-large-v2"][0], sm["frames"], sm["h"], sm["kh"], sm["d"]),
             torch.bfloat16),
            ((2, 300, 77, 4, 2, 64), torch.bfloat16),
            ((2, 70, 300, 2, 1, 128), torch.bfloat16),
            ((2, 65, 129, 2, 2, 256), torch.bfloat16),
            ((2, ENCDEC_PARITY_PROMPT, 8, 4, 2, 16), torch.float32),
            ((2, 100, 70, 4, 2, 64), torch.float32),
            ((2, 33, 300, 2, 1, 128), torch.float32),
            ((2, 50, 77, 4, 2, 16), torch.bfloat16)):
        q = rand(cb, cs, ch, cd, dtype=dt)
        k, v = rand(cb, cskv, ckh, cd, dtype=dt), rand(cb, cskv, ckh, cd, dtype=dt)
        kw = dict(causal=False, scale=cd ** -0.5)
        x3 = K1.route(dt, cd) == "tf32x3"
        got = K1.flash_attention(q, k, v, return_lse=x3, **kw)
        want = ops.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        name = f"K1 q {(cb, cs, ch, cd)}, k/v {(cb, cskv, ckh, cd)} {str(dt)[6:]} unmasked " \
               f"[{K1.route(dt, cd)}]"
        if x3:
            got, lse = got
            check_close(f"{name} lse", lse, ops.flash_attention_lse_plain(q, k, **kw), LSE_TOL)
        check_close(name, got, want, tol[dt],
                    row_atol(want, tol[dt], (2, 3)) if dt == torch.bfloat16 else None)
        del q, k, v, got, want

    gemma2_attention_checks(rand, b)

    def time_k1(b, s, h, kh, d, window=0, softcap=None, scale=None):
        q = rand(b, s, h, d, dtype=torch.bfloat16)
        k, v = rand(b, s, kh, d, dtype=torch.bfloat16), rand(b, s, kh, d, dtype=torch.bfloat16)
        sc = scale or d ** -0.5
        kw = dict(scale=sc, window=window, softcap=softcap)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms("K1", lambda: K1.flash_attention(q, k, v, **kw))
        plain_ms = time_ms("K1 plain", lambda: ops.flash_attention_plain(q, k, v, **kw))
        lib_ms = time_ms("K1 library", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=sc, enable_gqa=True))
        w = window if 0 < window < s else s
        pairs = w * (w + 1) // 2 + (s - w) * w                 # the pairs the mask keeps
        flops = 4 * d * pairs * b * h
        nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * q.element_size()
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(flops, nbytes, "bfloat16"), tflops=flops / ms / 1e9)
        lib = f"library_ms {lib_ms:.4f} (SDPA)"
        if softcap or w < s:
            # SDPA computes no softcap and no window; flex_attention computes
            # both, and its time is the library cell, SDPA's beside it
            flex = flex_attention_call(
                qt, scale=sc, softcap=softcap,
                mask_mod=lambda b_, h_, qi, ki: (qi >= ki) & (qi - ki < w), q_len=s, kv_len=s)
            want = ops.flash_attention_plain(q, k, v, **kw)
            check_close(f"K1 library, flex_attention at ({b},{s},{h},{kh},{d}) window {window}",
                        flex(kt, vt).transpose(1, 2), want, 2e-2, row_atol(want, 2e-2, (2, 3)))
            del want
            row["library_ms"] = time_ms("K1 flex_attention", lambda: flex(kt, vt))
            row.update(library="flex_attention", sdpa_causal_uncapped_ms=lib_ms)
            lib = (f"library_ms {row['library_ms']:.4f} (flex_attention, compiled; SDPA "
                   f"causal, uncapped, unwindowed {lib_ms:.4f})")
        log(f"   K1 at ({b},{s},{h},{kh},{d}) bf16, window {window}, softcap {softcap} "
            f"[{K1.route(q.dtype, d)}]: kernel_ms {ms:.4f} ({row['tflops']:.1f} TFLOP/s) "
            f"plain_ms {plain_ms:.4f} {lib} bound_ms {row['bound_ms']:.4f} ({row['bound_by']})")
        return row

    # the serving calls are bf16 at D 128 and 256: the tensor-core route
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda", variant=K1.route(torch.bfloat16, d),
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=main_err, **time_k1(b, s, h, kh, d))
    time_k1(b, rs, RG["h"], RG["kh"], RG["d"], RG["window"])
    gs, gmax = SERVE["gemma2-9b"]
    gkw = {"softcap": GEMMA["softcap"], "scale": GEMMA["scale"]}
    rows["flash_attention"]["gemma2_call"] = time_k1(
        b, gs, GEMMA["h"], GEMMA["kh"], GEMMA["d"], GEMMA["window"], **gkw)
    rows["flash_attention"]["gemma2_global_call"] = time_k1(
        b, gs, GEMMA["h"], GEMMA["kh"], GEMMA["d"], **gkw)
    rows["flash_attention"]["qwen3_moe_call"] = time_k1(b, s, QMOE["h"], QMOE["kh"], QMOE["d"])
    rows["flash_attention"]["mla_call"] = time_k1_mla(b, s, rand)
    rows["flash_attention"]["qwen3_tp16_call"] = time_k1(b, s, TP16["h"], TP16["kh"], TP16["d"])

    def time_k1_unmasked(b, s, skv, h, kh, d):
        """K1 without a mask, q of S positions over k and v of S_kv, bf16
        (seamless's encoder and cross calls), beside SDPA's unmasked call."""
        q = rand(b, s, h, d, dtype=torch.bfloat16)
        k, v = rand(b, skv, kh, d, dtype=torch.bfloat16), rand(b, skv, kh, d, dtype=torch.bfloat16)
        kw = dict(causal=False, scale=d ** -0.5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms("K1 unmasked", lambda: K1.flash_attention(q, k, v, **kw))
        plain_ms = time_ms("K1 unmasked plain", lambda: ops.flash_attention_plain(q, k, v, **kw))
        lib_ms = time_ms("K1 unmasked library", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=d ** -0.5, enable_gqa=True))
        flops = 4 * d * s * skv * b * h
        nbytes = (2 * b * s * h * d + 2 * b * skv * kh * d) * q.element_size()
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(flops, nbytes, "bfloat16"), tflops=flops / ms / 1e9)
        log(f"   K1 at q ({b},{s},{h},{d}), k/v ({b},{skv},{kh},{d}) bf16, unmasked "
            f"[{K1.route(q.dtype, d)}]: kernel_ms {ms:.4f} ({row['tflops']:.1f} TFLOP/s) "
            f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA) bound_ms "
            f"{row['bound_ms']:.4f} ({row['bound_by']}, {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        return row

    # seamless-m4t-large-v2's three calls: the encoder's over its frames, the
    # decoder's causal self-attention, its cross-attention over the frames
    ss = SERVE["seamless-m4t-large-v2"][0]
    rows["flash_attention"]["seamless_encoder_call"] = time_k1_unmasked(
        b, sm["frames"], sm["frames"], sm["h"], sm["kh"], sm["d"])
    rows["flash_attention"]["seamless_self_call"] = time_k1(b, ss, sm["h"], sm["kh"], sm["d"])
    rows["flash_attention"]["seamless_cross_call"] = time_k1_unmasked(
        b, ss, sm["frames"], sm["h"], sm["kh"], sm["d"])

    # ---- K2 ----
    log("== kernels: K2 decode attention (split-S pass, then combine)")
    S = MAX_LEN
    rmax = SERVE["recurrentgemma-2b"][1]
    qwen, rg1 = (b, S, h, kh, d), (1, rmax, RG["h"], RG["kh"], RG["d"])
    sms = K2.num_sms(torch.cuda.current_device())
    cases = [(qwen, torch.bfloat16, [0, 1, 263, S]),
             ((b, S, QMOE["h"], QMOE["kh"], QMOE["d"]), torch.bfloat16,   # qwen3-moe's call
              [0, 1, 263, S]),
             ((b, rmax, RG["h"], RG["kh"], RG["d"]), torch.bfloat16,   # RecurrentGemma's ring
              [0, 1, rs + 8, rmax]),
             # seamless's calls: cross-attention over 1024 frames, all valid;
             # the self-attention's cache
             ((b, SEAMLESS["frames"], SEAMLESS["h"], SEAMLESS["kh"], SEAMLESS["d"]),
              torch.bfloat16, [SEAMLESS["frames"]] * b),
             ((b, S, SEAMLESS["h"], SEAMLESS["kh"], SEAMLESS["d"]), torch.bfloat16,
              [0, 1, 263, S]),
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
             ((2, 32, 4, 1, 16), torch.float32, [7, 32]),               # RecurrentGemma reduced
             # qwen3-14b at tp 16: 48 query heads on 8 kv heads, a group of 6
             # in one CTA, at the call and its split edges, in both dtypes
             ((b, S, TP16["h"], TP16["kh"], TP16["d"]), torch.bfloat16, [0, 1, 263, S]),
             ((b, S, TP16["h"], TP16["kh"], TP16["d"]), torch.bfloat16, [32, 33, 64, S + 9]),
             ((b, S, TP16["h"], TP16["kh"], TP16["d"]), torch.float32, [1, 32, 33, S])]
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

    def time_k2(b, S, h, kh, d, n_valid, softcap=None):
        """Timing at a serving path's mid-run length, with enough caches in
        rotation that their valid rows exceed the 50 MB L2: a decode step
        finds each layer's cache cold. Also times each chunk of a sweep, the
        plan picking it for an SM count other than the card's. SDPA computes
        no softcap: with one, flex_attention's time is the library cell and
        SDPA's uncapped time stands beside it, labelled."""
        sc = d ** -0.5
        cap = dict(softcap=softcap)
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
            lambda kk, vv: K2.decode_attention(q, kk, vv, ln, scale=sc, **cap), kvs), iters=32)
        sweep = {}
        for c in (16, 32, 64):   # each chunk through the plan, for an SM count that picks it
            fake = b * kh * -(-S // c) // 2
            assert K2.plan(b, S, h, kh, d, torch.bfloat16, fake)[0] == c
            with k2_planning_for(fake):
                sweep[c] = time_ms(f"K2 chunk {c}", rotating(
                    lambda kk, vv: K2.decode_attention(q, kk, vv, ln, scale=sc, **cap), kvs),
                    iters=32)
        passes = k2_passes(rotating(
            lambda kk, vv: K2.decode_attention(q, kk, vv, ln, scale=sc, **cap), kvs))
        plain_ms = time_ms("K2 plain", rotating(
            lambda kk, vv: ops.decode_attention_plain(q, kk, vv, ln, scale=sc, **cap), kvs),
            iters=32)
        lib_ms = time_ms("K2 library", rotating(lambda kk, vv: F.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=mask, scale=sc, enable_gqa=True), kvt), iters=32)
        nbytes = (2 * b * h * d + 2 * b * n_valid * kh * d) * q.element_size() + 4 * b
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bound(4 * b * h * n_valid * d, nbytes, "bfloat16"),
                   chunk=chunk, splits=splits, ctas=b * kh * splits)
        lib = f"library_ms {lib_ms:.4f} (SDPA)"
        if softcap:
            flex = flex_attention_call(
                q[:, :, None].contiguous(), scale=sc, softcap=softcap,
                mask_mod=lambda b_, h_, qi, ki: ki < ln[b_], q_len=1, kv_len=S)
            kk, vv = kvs[0]
            want = ops.decode_attention_plain(q, kk, vv, ln, scale=sc, **cap)
            check_close(f"K2 library, flex_attention at ({b},{S},{h},{kh},{d}) length {n_valid}",
                        flex(*kvt[0])[:, :, 0], want, 2e-2, row_atol(want, 2e-2, (1, 2)))
            row["library_ms"] = time_ms("K2 flex_attention", rotating(flex, kvt), iters=32)
            row.update(library="flex_attention", softcap=softcap, sdpa_uncapped_ms=lib_ms)
            lib = (f"library_ms {row['library_ms']:.4f} (flex_attention, compiled; SDPA "
                   f"uncapped {lib_ms:.4f})")
        log(f"   K2 at ({b},{S},{h},{kh},{d}) bf16, length {n_valid}, softcap {softcap}, "
            f"{n_caches} caches; plan chunk {chunk}, {splits} splits, {b * kh * splits} CTAs "
            f"({b * kh * -(-n_valid // chunk)} live): kernel_ms {ms:.4f} "
            f"({nbytes / ms / 1e9:.3f} TB/s) plain_ms {plain_ms:.4f} {lib} "
            f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']}, {nbytes / 1e6:.2f} MB); "
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
    # gemma2's calls at a served length: a global layer's cache of max_len
    # slots, and a local layer's wrapped ring (all 4096 slots valid)
    rows["decode_attention"]["gemma2_call"] = time_k2(
        b, gmax, GEMMA["h"], GEMMA["kh"], GEMMA["d"], gs + TOKENS // 2, GEMMA["softcap"])
    rows["decode_attention"]["gemma2_ring_call"] = time_k2(
        b, GEMMA["window"], GEMMA["h"], GEMMA["kh"], GEMMA["d"], GEMMA["window"],
        GEMMA["softcap"])
    rows["decode_attention"]["qwen3_moe_call"] = time_k2(
        b, S, QMOE["h"], QMOE["kh"], QMOE["d"], PROMPT_LEN + TOKENS // 2)
    rows["decode_attention"]["qwen3_tp16_call"] = time_k2(
        b, S, TP16["h"], TP16["kh"], TP16["d"], PROMPT_LEN + TOKENS // 2)
    # seamless's decode: cross-attention over the 1024 cached frames, every
    # one valid, and the self-attention's cache of max_len slots
    smax = SERVE["seamless-m4t-large-v2"][1]
    rows["decode_attention"]["seamless_cross_call"] = time_k2(
        b, sm["frames"], sm["h"], sm["kh"], sm["d"], sm["frames"])
    rows["decode_attention"]["seamless_self_call"] = time_k2(
        b, smax, sm["h"], sm["kh"], sm["d"], ss + TOKENS // 2)

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
             ((2, 150, 16, 8, 16, 1), torch.float32, True),    # reduced config
             ((TRAIN["batch"], TRAIN["seq"], mh, mp, mn, mg), torch.float32, False),  # train
             ((1, 130, 3, 80, 64, 3), torch.float32, True),    # two p tiles, N 64, G == H
             ((1, 70, 2, 5, 7, 1), torch.float32, True)]       # P, N off 4: 4-byte copies
    main_err, k3_fp32_err = None, 0.0
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
            k3_fp32_err = max(k3_fp32_err, err)
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
    cold_ms = time_ms("K4 cold", rotating_kept(
        lambda a_, b_: K4.rglru_scan(a_, b_, h0=h0, out_dtype=torch.bfloat16), sets), iters=32)
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
    del sets

    # ---- K1-bwd ----
    log("== kernels: K1-bwd flash attention backward (fp32, 3xTF32 on the tensor cores)")
    # the gradients sum up to S * H / KH products in another order than the
    # plain version's einsums: held to GRAD_TOL of each tensor's max |value|
    tb, ts = TRAIN["batch"], TRAIN["seq"]
    cases = [((tb, ts, RG["h"], RG["kh"], RG["d"]), {"window": RG["window"]}),  # the train call
             ((2, 200, 10, 2, 128), {}),              # D 128, 5 query heads a kv head (qwen3's)
             ((2, 300, 10, 1, 256), {"window": 100}),  # ragged S over tiles, window < S
             ((2, 77, 4, 2, 64), {"softcap": 30.0}),
             ((1, 40, 4, 4, 16), {"causal": False}),
             ((2, 48, 4, 2, 16), {}),                  # qwen3 reduced config
             ((2, 150, 4, 1, 16), {"window": 32}),     # RecurrentGemma reduced config
             # the edges of its 32-row by 32-key tiles: one past a tile, one
             # past two, ragged over ten; a window ending inside a key tile; D 16
             ((2, 33, 4, 2, 64), {}),
             ((1, 65, 10, 1, 256), {"window": 20}),
             ((2, 300, 4, 1, 128), {"window": 45}),
             ((2, 65, 4, 2, 16), {"window": 7}),
             ((1, 33, 2, 1, 16), {"causal": False, "softcap": 5.0}),
             # k and v of a length of their own (unmasked): seamless's cross
             # call in training, 256 queries over 1024 frames; S_kv shorter
             # and longer than S, ragged against the 32-key tiles; the
             # reduced config's cross call
             ((tb, ts, SEAMLESS["h"], SEAMLESS["kh"], SEAMLESS["d"]),
              {"causal": False, "skv": SEAMLESS["frames"]}),
             ((2, 100, 4, 2, 64), {"causal": False, "skv": 70}),
             ((2, 33, 2, 1, 16), {"causal": False, "skv": 300}),
             ((1, 77, 4, 4, 128), {"causal": False, "skv": 129}),
             ((2, ENCDEC_PARITY_PROMPT, 4, 2, 16), {"causal": False, "skv": 8})]
    main_err = None
    for (cb, cs, ch, ckh, cd), kw in cases:
        kw = dict(kw)
        cskv = kw.pop("skv", cs)
        q = rand(cb, cs, ch, cd, dtype=torch.float32)
        k, v = rand(cb, cskv, ckh, cd, dtype=torch.float32), rand(cb, cskv, ckh, cd,
                                                                 dtype=torch.float32)
        do = rand(cb, cs, ch, cd, dtype=torch.float32)
        kw = {"causal": True, "scale": cd ** -0.5, **kw}
        o, lse = K1.flash_attention(q, k, v, return_lse=True, **kw)
        got = K1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        lse_want = ops.flash_attention_lse_plain(q, k, **kw)
        torch.cuda.synchronize()
        shown = {k_: v_ for k_, v_ in kw.items() if k_ != "scale"}
        if cskv != cs:
            shown["S_kv"] = cskv
        name = f"K1-bwd {(cb, cs, ch, ckh, cd)} {shown} [{K1_BWD_ROUTE}]"
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
    pairs = int(mask.sum())
    # K1's own fp32 call in training (the 3xTF32 route, writing the
    # log-sum-exp), beside SDPA's fp32 forward on the same inputs; bound at
    # the 3xTF32 rate and at the fp32 CUDA-core rate
    fwd_ms = time_ms("K1 fp32 train call", lambda: K1.flash_attention(
        q, k, v, scale=sc, return_lse=True, **kw))
    fwd_plain = time_ms("K1 fp32 plain", lambda: ops.flash_attention_plain(
        q, k, v, scale=sc, **kw), iters=5, warmup=1)
    fwd_flops = 4 * cd * pairs * cb * ch                 # two products over the kept pairs
    fwd_bytes = 4 * (2 * cb * cs * ch * cd + 2 * cb * cs * ckh * cd + cb * ch * cs)
    fwd_bound = bound(fwd_flops, fwd_bytes, "tf32x3")
    fwd_cuda_cores = bound(fwd_flops, fwd_bytes, "float32")
    rows["flash_attention"]["train_call"] = dict(
        ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd, **fwd_bound,
        bound_fp32_cuda_cores_ms=fwd_cuda_cores["bound_ms"], tflops=fwd_flops / fwd_ms / 1e9,
        variant=K1.route(torch.float32, cd), **k1_ptxas)
    log(f"   K1 at ({cb},{cs},{ch},{ckh},{cd}) fp32, window {kw['window']}, with its "
        f"log-sum-exp (the train call) [{K1.route(torch.float32, cd)}; "
        f"{' '.join(f'{k_} {v_}' for k_, v_ in k1_ptxas.items()) or 'ptxas not run'}]: "
        f"kernel_ms {fwd_ms:.4f} ({fwd_flops / fwd_ms / 1e9:.2f} TFLOP/s) plain_ms "
        f"{fwd_plain:.4f} library_ms {lib_fwd:.4f} (SDPA fp32 forward, boolean mask) bound_ms "
        f"{fwd_bound['bound_ms']:.4f} ({fwd_bound['bound_by']} at the 3xTF32 rate; "
        f"{fwd_cuda_cores['bound_ms']:.4f} on the fp32 CUDA cores; {fwd_flops / 1e9:.2f} GFLOP, "
        f"{fwd_bytes / 1e6:.1f} MB)")
    k1_passes = kernel_spans(
        lambda: K1.flash_attention_bwd(q, k, v, o, lse, do, scale=sc, **kw),
        ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_reduce", "flash_bwd_dq"))
    flops = 10 * cd * pairs * cb * ch                 # five products over the kept pairs
    nbytes = 4 * (4 * cb * cs * ch * cd + 4 * cb * cs * ckh * cd + cb * ch * cs)
    cuda_core_bound = bound(flops, nbytes, "float32")
    rows["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda", variant=K1_BWD_ROUTE,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:63",
        max_abs_err=main_err, ms=ms, plain_ms=plain_ms, library_ms=lib_both - lib_fwd,
        library_fwd_and_bwd_ms=lib_both, library_fwd_ms=lib_fwd,
        kernel_split_ms=k1_passes, **bound(flops, nbytes, "tf32x3"),
        bound_fp32_cuda_cores_ms=cuda_core_bound["bound_ms"], tflops=flops / ms / 1e9,
        **bwd_ptxas["k1"])
    r = rows["flash_attention_bwd"]
    log(f"   K1-bwd at ({cb},{cs},{ch},{ckh},{cd}) fp32, window {kw['window']} (the train call; "
        f"[{K1_BWD_ROUTE}]; "
        f"{' '.join(f'{k_} {v_}' for k_, v_ in bwd_ptxas['k1'].items())}): kernel_ms "
        f"{ms:.4f} ({r['tflops']:.2f} TFLOP/s) plain_ms {plain_ms:.4f} library_ms "
        f"{r['library_ms']:.4f} (SDPA fp32 with a boolean mask: forward and backward "
        f"{lib_both:.4f} less forward {lib_fwd:.4f}) bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']} at the 3xTF32 rate; {cuda_core_bound['bound_ms']:.4f} on the fp32 "
        f"CUDA cores; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); device ms a call by "
        f"kernel (profiler): " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in k1_passes.items()))
    del qt, kt, vt

    # seamless's cross call in training: 256 text queries over 1024 frames,
    # fp32, unmasked, K1-bwd beside SDPA's fp32 backward (forward and
    # backward, less forward) on the same inputs
    sm = SEAMLESS
    cb, cs, cskv, ch, ckh, cd = tb, ts, sm["frames"], sm["h"], sm["kh"], sm["d"]
    ckw = dict(causal=False, scale=cd ** -0.5)
    q = rand(cb, cs, ch, cd, dtype=torch.float32)
    k, v = (rand(cb, cskv, ckh, cd, dtype=torch.float32) for _ in range(2))
    do = rand(cb, cs, ch, cd, dtype=torch.float32)
    o, lse = K1.flash_attention(q, k, v, return_lse=True, **ckw)
    cross = lambda: K1.flash_attention_bwd(q, k, v, o, lse, do, **ckw)   # noqa: E731
    ms = time_ms("K1-bwd cross", cross)
    plain_ms = time_ms("K1-bwd cross plain", lambda: ops.flash_attention_bwd_plain(
        q, k, v, o, lse, do, **ckw), iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, scale=ckw["scale"], enable_gqa=True)
    lib_fwd = time_ms("SDPA fp32 cross forward", sdpa, iters=10)
    lib_both = time_ms("SDPA fp32 cross forward and backward", lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), iters=10)
    flops = 10 * cd * cs * cskv * cb * ch               # five products over every pair
    nbytes = 4 * (4 * cb * cs * ch * cd + 4 * cb * cskv * ckh * cd + cb * ch * cs)
    cuda_core_bound = bound(flops, nbytes, "float32")
    r = rows["flash_attention_bwd"]["seamless_cross_call"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_both - lib_fwd, library_fwd_and_bwd_ms=lib_both,
        library_fwd_ms=lib_fwd, kernel_split_ms=kernel_spans(
            cross, ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_reduce", "flash_bwd_dq")),
        **bound(flops, nbytes, "tf32x3"), bound_fp32_cuda_cores_ms=cuda_core_bound["bound_ms"],
        tflops=flops / ms / 1e9)
    log(f"   K1-bwd at q ({cb},{cs},{ch},{cd}), k/v ({cb},{cskv},{ckh},{cd}) fp32, unmasked "
        f"(seamless's cross call in training) [{K1_BWD_ROUTE}]: kernel_ms {ms:.4f} "
        f"({r['tflops']:.2f} TFLOP/s) plain_ms {plain_ms:.4f} library_ms "
        f"{r['library_ms']:.4f} (SDPA fp32: forward and backward {lib_both:.4f} less forward "
        f"{lib_fwd:.4f}) bound_ms {r['bound_ms']:.4f} ({r['bound_by']} at the 3xTF32 rate; "
        f"{cuda_core_bound['bound_ms']:.4f} on the fp32 CUDA cores; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB); device ms a call by kernel (profiler): "
        + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in r["kernel_split_ms"].items()))
    del q, k, v, do, o, lse, qt, kt, vt, dot

    # ---- K4-bwd ----
    log("== kernels: K4-bwd RG-LRU scan backward (fp32)")
    # held to 1e-5 of max |gradient|, as K4 is to max |h|: the same chain of
    # fp32 FMAs as the plain reverse loop, rounded apart
    gw = 2560
    cases = [((tb, ts, gw), False, False),    # the train call: no h0, h_last unused
             ((tb, ts, gw), True, True),
             ((2, 4096, 256), True, True),     # S over 64 tiles
             ((1, 2049, 96), True, True),      # ragged S over 33 tiles, B 1
             ((1, 2049, 96), False, False),
             ((3, 1, 37), True, False),        # S 1, W 37: a strip and 5 lanes
             ((1, 1, 37), False, True),
             ((1, 5, 37), True, True),         # S under one chunk, B 1
             ((2, 300, 20), False, True),      # W under one strip
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
        bp = K4.bwd_plan(cb, cs, cw)
        name = (f"K4-bwd {(cb, cs, cw)} h0={with_h0} dh_last={with_dh} "
                f"[{bp['tiles']} tiles, {bp['ctas']} CTAs]")
        errs = [check_close(f"{name} {g}", x, w, 1e-5, 1e-5 * max(float(w.abs().max()), 1e-30))
                for g, x, w in zip(("da", "db", "dh0"), got, want) if w is not None]
        if (got[2] is None) != (h0 is None):
            raise AssertionError(f"{name}: dh0 given without h0, or missing with it")
        main_err = max(errs) if main_err is None else main_err
    # timing at the train call: warm (one set of inputs, 52.4 MB against the
    # 50 MB L2) and cold (four sets of a, y and dy in rotation; the last
    # four outputs are kept)
    sets = []
    for _ in range(4):
        a, bb, _ = rglru_inputs(tb, ts, gw, False)
        sets.append((a, K4.rglru_scan(a, bb)[0], rand(tb, ts, gw, dtype=torch.float32)))
    a, y, dy = sets[0]
    ms = time_ms("K4-bwd", lambda: K4.rglru_scan_bwd(a, y, None, dy, None))
    cold_ms = time_ms("K4-bwd cold", rotating_kept(
        lambda a_, y_, dy_: K4.rglru_scan_bwd(a_, y_, None, dy_, None), sets), iters=32)
    plain_ms = time_ms("K4-bwd plain", lambda: ops.rglru_scan_bwd_plain(a, y, None, dy, None),
                       iters=3, warmup=1)
    nbytes = 4 * 5 * a.numel()                   # a, y, dy read; da, db written
    p = K4.bwd_plan(tb, ts, gw)
    waves = p["ctas"] / (p["ctas_per_sm"] * sms)
    rows["rglru_scan_bwd"] = dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
        replaces="src/repro/kernels/rglru_scan.py:39", max_abs_err=main_err, ms=ms,
        plain_ms=plain_ms, library_ms=None, **bound(3 * a.numel(), nbytes, "float32"),
        tbps=nbytes / ms / 1e9, cold_ms=cold_ms, cold_tbps=nbytes / cold_ms / 1e9,
        **{k_: p[k_] for k_ in ("lw", "t", "nc", "ctas", "ctas_per_sm")}, waves=waves,
        **bwd_ptxas["k4"])
    r = rows["rglru_scan_bwd"]
    log(f"   K4-bwd at ({tb},{ts},{gw}) fp32, no h0, no dh_last (the train call) [plan: LW "
        f"{p['lw']}, T {p['t']}, NC {p['nc']}, {p['tiles']} tiles of {p['t'] * p['nc']} steps, "
        f"{p['ctas']} CTAs of {p['lw'] * p['nc']} threads, {p['ctas_per_sm']} an SM, "
        f"{waves:.2f} waves on {sms} SMs; "
        f"{' '.join(f'{k_} {v_}' for k_, v_ in bwd_ptxas['k4'].items())}]: kernel_ms {ms:.4f} "
        f"({r['tbps']:.3f} TB/s), cold in L2 {cold_ms:.4f} ({r['cold_tbps']:.3f} TB/s), "
        f"plain_ms {plain_ms:.4f} library_ms none (no PyTorch call computes a linear "
        f"recurrence's gradient) bound_ms {r['bound_ms']:.4f} ({r['bound_by']}, "
        f"{nbytes / 1e6:.1f} MB)")
    del sets

    # ---- K3-bwd ----
    log("== kernels: K3-bwd SSD chunked scan backward (fp32, 3xTF32 tensor cores)")
    # held to GRAD_TOL of each gradient's max |value|, and relative: dB and
    # dC sum over a chunk and a group's heads, da over batch and steps, in
    # another order than the plain version's einsums; two calls must give
    # the same bits (every sum is taken in one fixed order, no atomics)
    mh, mp, mn = 80, 64, 128          # mamba2-2.7b's heads, head_dim and state
    cases = [((tb, ts, mh, mp, mn, 1), False, False),   # the train call
             ((tb, ts, mh, mp, mn, 1), True, True),     # with h0 and d(final state)
             ((2, 200, 4, 16, 32, 2), True, True),      # ragged S, G < H
             ((1, 37, 2, 80, 128, 2), True, False),     # under one chunk, two p tiles
             ((1, 64, 3, 64, 64, 3), False, True),      # G == H, one whole chunk, N 64
             ((2, 150, 16, 8, 16, 1), False, True)]     # the reduced config
    main_err = None
    for (cb, cs, ch, cp, cn, cg), with_h0, with_ds in cases:
        x, dt, a, bm, cm, h0 = ssd_inputs(cb, cs, ch, cp, cn, cg, torch.float32, with_h0)
        dy = rand(cb, cs, ch, cp, dtype=torch.float32)
        ds = rand(cb, ch, cp, cn, dtype=torch.float32) if with_ds else None
        got = K3.ssd_scan_bwd(x, dt, a, bm, cm, h0, dy, ds)
        again = K3.ssd_scan_bwd(x, dt, a, bm, cm, h0, dy, ds)
        want = ops.ssd_scan_bwd_plain(x, dt, a, bm, cm, h0, dy, ds)
        torch.cuda.synchronize()
        name = f"K3-bwd {(cb, cs, ch, cp, cn, cg)} fp32 h0={with_h0} dstate={with_ds}"
        if (got[5] is None) != (h0 is None):
            raise AssertionError(f"{name}: dh0 given without h0, or missing with it")
        if not all(torch.equal(u, v) for u, v in zip(got, again) if u is not None):
            raise AssertionError(f"{name}: two calls differ")
        errs = [check_close(f"{name} {g_}", x_, w_, GRAD_TOL,
                            GRAD_TOL * max(float(w_.abs().max()), 1e-30))
                for g_, x_, w_ in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want)
                if w_ is not None]
        main_err = max(errs) if main_err is None else main_err
    log(f"   K3-bwd: two calls of each of the {len(cases)} cases equal to the bit")
    # timing at the train call (no h0; the final state unused), and K3's
    # own fp32 call there (the 3xTF32 route, returning the final state)
    x, dt, a, bm, cm, _ = ssd_inputs(tb, ts, mh, mp, mn, 1, torch.float32, False)
    dy = rand(tb, ts, mh, mp, dtype=torch.float32)
    fwd = lambda: K3.ssd_scan(x, dt, a, bm, cm, return_state=True)   # noqa: E731
    fwd_ms = time_ms("K3 fp32 train call", fwd)
    fwd_plain = time_ms("K3 fp32 plain", lambda: ops.ssd_scan_plain(x, dt, a, bm, cm, chunk=256),
                        iters=5, warmup=1)
    bwd = lambda: K3.ssd_scan_bwd(x, dt, a, bm, cm, None, dy, None)   # noqa: E731
    ms = time_ms("K3-bwd", bwd)
    plain_ms = time_ms("K3-bwd plain", lambda: ops.ssd_scan_bwd_plain(
        x, dt, a, bm, cm, None, dy, None), iters=5, warmup=1)
    fwd_passes = kernel_spans(fwd, K3.FWD_KERNELS)
    passes = kernel_spans(bwd, K3.BWD_KERNELS)
    fwd_plan = K3.tf32x3_plan(tb, ts, mh, mp, mn, sms=sms)
    bwd_plan = K3.tf32x3_plan(tb, ts, mh, mp, mn, backward=True, sms=sms)
    # the work, a chunk of L steps and a head: products over the chunk's
    # live triangle of L (L + 1) / 2 pairs, and over its L steps of P x N
    L = K3.CHUNK
    chunk_heads = tb * mh * -(-ts // L)
    tri = L * (L + 1) // 2
    fwd_flops = 2 * chunk_heads * (tri * (mn + mp) + 2 * L * mp * mn)   # C.B^T, M.X; C.S, update
    fwd_bytes = 4 * (2 * x.numel() + dt.numel() + 2 * bm.numel() + mh + tb * mh * mp * mn)
    # C.B^T, dy.x^T, M^T.dy, dG.B, dG^T.C; dS.B, x.dS, dy.S, the dS share, the state recompute
    flops = 2 * chunk_heads * (tri * (3 * mn + 2 * mp) + 5 * L * mp * mn)
    nbytes = 4 * (3 * x.numel() + 2 * dt.numel() + 4 * bm.numel() + 2 * mh)

    def plan_text(plan):
        return "; ".join(f"{k_[:-7]} {v_['ctas']} CTAs of {v_['threads']} threads, "
                         f"{v_['smem'] / 1024:.1f} KB, {v_['ctas_per_sm']} an SM, "
                         f"{v_['waves']:.2f} waves" for k_, v_ in plan.items())

    def ptxas_text(regs):
        return " ".join(f"{k_} {v_}" for k_, v_ in regs.items())
    fb = bound(fwd_flops, fwd_bytes, "tf32x3")
    fb_cores = bound(fwd_flops, fwd_bytes, "float32")
    rows["ssd_scan_tf32x3"] = dict(
        name="ssd_scan_tf32x3", route="cuda", variant=K3.route(x.dtype, mp, mn),
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:56", max_abs_err=k3_fp32_err, ms=fwd_ms,
        plain_ms=fwd_plain, library_ms=None, **fb,
        bound_fp32_cuda_cores_ms=fb_cores["bound_ms"], tflops=fwd_flops / fwd_ms / 1e9,
        tbps=fwd_bytes / fwd_ms / 1e9, kernel_split_ms=fwd_passes, plan=fwd_plan,
        **bwd_ptxas["k3_fwd"])
    r = rows["ssd_scan_tf32x3"]
    log(f"   K3 at ({tb},{ts},{mh},{mp},{mn},1) fp32, no h0, final state out (the train call) "
        f"[{r['variant']}; {plan_text(fwd_plan)}; {ptxas_text(bwd_ptxas['k3_fwd'])}]: kernel_ms "
        f"{fwd_ms:.4f} ({r['tflops']:.2f} TFLOP/s) plain_ms {fwd_plain:.4f} library_ms none "
        f"bound_ms {fb['bound_ms']:.4f} ({fb['bound_by']} at the 3xTF32 rate; "
        f"{fb_cores['bound_ms']:.4f} on the fp32 CUDA cores; {fwd_flops / 1e9:.2f} GFLOP, "
        f"{fwd_bytes / 1e6:.1f} MB); device ms a call by kernel (profiler): "
        + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in fwd_passes.items()))
    cores = bound(flops, nbytes, "float32")
    rows["ssd_scan_bwd"] = dict(
        name="ssd_scan_bwd", route="cuda", variant="tf32x3",
        source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan.py:56", max_abs_err=main_err, ms=ms,
        plain_ms=plain_ms, library_ms=None, **bound(flops, nbytes, "tf32x3"),
        bound_fp32_cuda_cores_ms=cores["bound_ms"], tflops=flops / ms / 1e9,
        kernel_split_ms=passes, plan=bwd_plan, repeat_equal=True, **bwd_ptxas["k3"])
    r = rows["ssd_scan_bwd"]
    log(f"   K3-bwd at ({tb},{ts},{mh},{mp},{mn},1) fp32, no h0, no dstate (the train call; "
        f"{plan_text(bwd_plan)}; {ptxas_text(bwd_ptxas['k3'])}): kernel_ms {ms:.4f} "
        f"({r['tflops']:.2f} TFLOP/s) plain_ms {plain_ms:.4f} library_ms none (no PyTorch call "
        f"computes the SSD scan's gradient) bound_ms {r['bound_ms']:.4f} ({r['bound_by']} at "
        f"the 3xTF32 rate; {cores['bound_ms']:.4f} on the fp32 CUDA cores, "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); device ms a call by kernel "
        f"(profiler): " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in passes.items()))
    del x, dt, a, bm, cm, dy
    return rows


def rotating_kept(fn, sets):
    """A call of fn on each set of inputs in turn that keeps the last
    len(sets) outputs alive, so that a timing finds inputs and outputs
    cold in L2 when the sets together exceed it."""
    kept, turn = [None] * len(sets), [0]

    def call():
        i = turn[0] % len(sets)
        turn[0] += 1
        kept[i] = fn(*sets[i])
    return call


def kernel_spans(call, names, n=8):
    """Device ms a call of each kernel whose name contains one of `names`,
    from a profiler trace of `n` calls: the mean of the launches the trace
    kept, times the launches a call. A trace can lose launches (the later
    traces of one process kept 6 or 7 of 8 on the H100), which a sum over
    the n calls would leave as time in no kernel."""
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
    return {name: union_ms(found) / len(found) * max(1, round(len(found) / n)) if found else 0.0
            for name, found in spans.items()}


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
    local-attention layers. The encoder-decoder runs K1 once per encoder
    layer and twice per decoder layer (self- and cross-attention) in
    prefill, and K2 twice per decoder layer in each decode step. Serving
    runs no backward kernel."""
    bwd = {"flash_attention_bwd": 0, "ssd_scan_bwd": 0, "rglru_scan_bwd": 0}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.enc_layers + 2 * cfg.dec_layers,
                "decode_attention": 2 * cfg.dec_layers * steps, "ssd_scan": 0, "rglru_scan": 0,
                **bwd}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "decode_attention": 0, "ssd_scan": cfg.num_layers,
                "rglru_scan": 0, **bwd}
    if cfg.family == "hybrid":
        from repro_torch.models.recurrentgemma import layer_kinds
        n_rec = layer_kinds(cfg).count("rglru")
        n_att = cfg.num_layers - n_rec
        return {"flash_attention": n_att, "decode_attention": n_att * steps, "ssd_scan": 0,
                "rglru_scan": n_rec, **bwd}
    # MLA decodes in its absorbed form, plain PyTorch: no K2
    per_step = 0 if cfg.mla else cfg.num_layers
    return {"flash_attention": cfg.num_layers, "decode_attention": per_step * steps,
            "ssd_scan": 0, "rglru_scan": 0, **bwd}


def describe(cfg):
    if cfg.family == "encdec":
        return (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers, d_model "
                f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
                f"{cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.act}, ungated, MLP biases), "
                f"{cfg.norm}, qkv biases, vocab {cfg.vocab_size} untied, a frontend of "
                f"{cfg.frontend_tokens} seeded frames x {cfg.frontend_dim}")
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
    extra = [what for what, on in (
        (f"pattern {'/'.join(cfg.attn_pattern)}, window {cfg.local_window}",
         cfg.attn_pattern != ("global",)),
        (f"softcaps {cfg.attn_softcap} (attention) and {cfg.final_softcap} (logits)",
         cfg.attn_softcap or cfg.final_softcap),
        ("sandwich norms", cfg.post_block_norm), (cfg.norm, cfg.norm != "rmsnorm"),
        ("qkv biases", cfg.qkv_bias), ("MLP biases", cfg.mlp_bias),
        ("tied embeddings", cfg.tie_embeddings),
        (f"a frontend of {cfg.frontend_tokens} x {cfg.frontend_dim} (not served: text "
         "prompts, as the JAX package's serving example)", cfg.frontend_tokens),
        (f"MoE: {cfg.num_experts} experts of {cfg.moe_d_ff}, top {cfg.num_experts_per_tok}, "
         f"{cfg.router_score} router, capacity factor {cfg.capacity_factor}"
         + (f", {cfg.n_shared_experts} shared expert" if cfg.n_shared_experts else ""),
         cfg.family == "moe"),
        (f"first dense layers {cfg.first_dense_layers}", cfg.first_dense_layers),
        (f"MLA: q rank {cfg.q_lora_rank}, kv rank {cfg.kv_lora_rank}, qk {cfg.qk_nope_head_dim}"
         f" + {cfg.qk_rope_head_dim}, v {cfg.v_head_dim}", cfg.mla),
        (f"MTP depth {cfg.mtp_depth} (built, not served)", cfg.mtp_depth),
    ) if on]
    heads = (f"heads {cfg.num_heads}" if cfg.mla else
             f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}")
    return (f"d_model {cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
            + "".join(f", {e}" for e in extra))


def serve_phase(arch):
    from repro_torch.configs.registry import get_config, make_model
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import serve_policy
    from repro_torch.launch.serve import greedy_generate, make_prefill, make_serve_step

    from repro_torch.models.lm import layer_plan

    prompt_len, max_len = SERVE[arch]
    cfg = get_config(arch).with_(param_dtype="bfloat16", compute_dtype="bfloat16",
                                 num_layers=SERVE_LAYERS.get(arch, get_config(arch).num_layers))
    cut = f" (cut from {get_config(arch).num_layers})" if arch in SERVE_LAYERS else ""
    log(f"== serve: {cfg.name} {describe(cfg)}, {cfg.num_layers} layers{cut}")
    if cfg.family == "moe":
        # the router's product is fp32 on an fp32 copy of the activations, as
        # the reference's; TF32 would round its operands to 10 mantissa bits
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
        if tf32 != (False, "highest"):
            raise AssertionError(f"the fp32 router would run on TF32: {tf32}")
        log(f"   the router's fp32 product without TF32 (allow_tf32, precision: {tf32})")
    dev = torch.device("cuda")
    bundle = make_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"   params: {n} ({n * 2 / 1e9:.2f} GB bf16) built on the card in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    if arch in DENSE_PARITY and cfg.tie_embeddings:
        # as ring_wrap_phase: gemma2's logits at init saturate its final cap
        params.embed.table.mul_(0.1)
        log("   the tied table scaled by 0.1 (the logits then stay mostly inside a final cap)")

    # warm-up at the main path's shapes (cuBLAS handles and heuristics, the
    # caching allocator); its launches are not counted
    prompts = torch.randint(0, cfg.vocab_size, (CLIENTS, prompt_len), device=dev)
    batch = {"tokens": prompts}
    if cfg.family == "encdec":   # the encoder's seeded frames
        batch["frontend"] = torch.randn(CLIENTS, cfg.frontend_tokens, cfg.frontend_dim,
                                        device=dev)
    prefill = make_prefill(bundle, max_len, torch.bfloat16)
    step = make_serve_step(bundle)
    t0 = time.perf_counter()
    tok, cache = prefill(params, batch)
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
    if k1_routes != {"wgmma": want["flash_attention"], "tf32x3": 0}:
        raise AssertionError(f"K1 launches by route {k1_routes}: expected all "
                             f"{want['flash_attention']} on wgmma")
    # every prefill SSD scan is bf16 at P 64, N 128: all on wgmma
    if k3_routes != {**dict.fromkeys(K3.ROUTES, 0), "wgmma": want["ssd_scan"]}:
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
    # the greedy run repeats the served batches (every client in each), so
    # its MoE calls are the served ones: their dropped pairs are counted here
    served = {"tokens": torch.as_tensor(out["prompts"], device=dev)}
    if out["frames"] is not None:
        served["frontend"] = torch.as_tensor(out["frames"], device=dev)
    with routes_recorded() as rec:
        greedy = greedy_generate(bundle, params, served, steps=TOKENS + 1, max_len=max_len,
                                 dtype=torch.bfloat16).cpu()
    for cid in range(CLIENTS):
        if [out["first"][cid]] + out["tokens"][cid] != greedy[cid].tolist():
            raise AssertionError(f"client {cid}: served tokens differ from greedy")
    log(f"   served tokens equal greedy decoding; client 0: {out['tokens'][0][:8]}...")
    moe_metrics = {}
    if cfg.family == "moe":
        n_moe = sum(spec.moe for spec in layer_plan(cfg))
        k = cfg.num_experts_per_tok
        pre = sum(int(r["dropped"]) for r in rec[:n_moe])
        dec = sum(int(r["dropped"]) for r in rec[n_moe:])
        moe_metrics = {"moe_layers": n_moe, "cap_prefill": rec[0]["cap"],
                       "cap_decode": rec[n_moe]["cap"], "dropped_prefill": pre,
                       "pairs_prefill": CLIENTS * prompt_len * k * n_moe,
                       "dropped_decode": dec, "pairs_decode": CLIENTS * k * n_moe * TOKENS}
        log(f"   capacity drops: prefill {pre} of {moe_metrics['pairs_prefill']} (token, expert) "
            f"pairs (cap {rec[0]['cap']} an expert a layer), {TOKENS} decode steps {dec} of "
            f"{moe_metrics['pairs_decode']} (cap {rec[n_moe]['cap']})")
    del rec
    plain = {}
    if arch in DENSE_PARITY:
        # both sides of the greedy check run the kernels, and a tied-embedding
        # model's greedy tokens echo its input at init: the full-depth logits
        # are held to the plain versions too
        plain = full_depth_plain_check(bundle, params, prompts[:1], max_len)
    elif cfg.family == "moe":
        # the served batch: its routing and drops are the served ones
        plain = full_depth_plain_check(bundle, params, prompts, max_len)
    elif cfg.family == "encdec":
        # the encoder (K1 unmasked), the self- and cross-attention prefill
        # (K1) and decode (K2) against their plain versions at full depth
        plain = full_depth_plain_check(bundle, params, prompts, max_len,
                                       frontend=batch["frontend"])

    # where the device time goes: one profiled prefill and three decode steps
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with annotated_layers(), profile(activities=acts) as prof:
        tok, cache = prefill(params, batch)
        torch.cuda.synchronize()
    pre, pre_ops = device_breakdown(prof, 1)
    with annotated_layers(), profile(activities=acts) as prof:
        for _ in range(3):
            tok, cache = step(params, tok, cache)
        torch.cuda.synchronize()
    dec, dec_ops = device_breakdown(prof, 3)
    if cfg.family == "moe":
        # the MoE (router, sort, searchsorted, gathers, bmm) and MLA's
        # absorbed decode are groups of their own, read from the annotations
        for where, found in (("prefill", pre), ("decode", dec)):
            if not (found.get("moe_gemm", 0) > 0 and found.get("moe_dispatch", 0) > 0):
                raise AssertionError(f"no MoE device time in the {where} breakdown: {found}")
        if cfg.mla and not dec.get("mla_decode", 0) > 0:
            raise AssertionError(f"no MLA decode device time in the breakdown: {dec}")
    if cfg.family == "dense" and "local" in cfg.attn_pattern:
        # the ring of a local layer: after the prefill and 3 decode steps it
        # holds the last `size` positions, wrapped where the prompt passed it
        from repro_torch.models.lm import layer_kinds
        ring = cache["layers"][layer_kinds(cfg).index("local")]["pos"]
        size, end = ring.numel(), prompt_len + 3
        if sorted(p for p in ring.tolist() if p >= 0) != list(range(max(0, end - size), end)):
            raise AssertionError("a local layer's ring does not hold the last positions")
        log(f"   a local layer's ring of {size} slots holds positions {max(0, end - size)}.."
            f"{end - 1}; slot 0 holds position {int(ring[0])}")
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
    return counts, {"layers": cfg.num_layers, "params": n, **moe_metrics,
                    "prefill_ms": out["prefill_s"] * 1e3, "prefill_cold_ms": cold_ms,
                    "decode_ms_per_step": wall_step,
                    "policy_step_ms": st["compute_s"] * 1e3 / steps,
                    "tok_per_s": total / out["decode_s"], "peak_gb": peak / 1e9,
                    "prefill_device_ms": pre, "decode_device_ms_per_step": dec,
                    "decode_idle_share": 1 - dec["busy"] / wall_step,
                    "prefill_device_ops": pre_ops, "decode_device_ops_per_step": dec_ops,
                    **plain,
                    "tokens": {cid: [out["first"][cid]] + out["tokens"][cid]
                               for cid in range(CLIENTS)}}


def logits_path(bundle, params, prompts, max_len, steps, feed=None, every_position=False,
                frontend=None):
    """The fp32 logits after the prefill (the last position's, or with
    `every_position` all of them, (B*S, V)), then the logits after each of
    `steps` decode steps, each fed `feed[i]` or else the previous logits'
    argmax. `frontend`: the encoder-decoder's frames. Returns (the logits,
    the tokens fed)."""
    batch = {"tokens": prompts} if frontend is None else {"tokens": prompts,
                                                          "frontend": frontend}
    from repro_torch.sharding.ctx import to_plain   # a DTensor's logits, gathered whole

    with torch.no_grad():
        out, cache = bundle.prefill(params, batch, max_len=max_len, dtype=torch.bfloat16)
        logits = to_plain(out.logits)
        last = logits[:, -1].float()
        rows = [logits.reshape(-1, logits.shape[-1]) if every_position else last]
        fed = []
        del out, logits
        for i in range(steps):
            tok = last.argmax(-1, keepdim=True) if feed is None else feed[i]
            fed.append(tok)
            out, cache = bundle.decode_step(params, tok, cache)
            last = to_plain(out.logits)[:, -1].float()
            rows.append(last)
            del out
    return rows, fed


@contextlib.contextmanager
def routes_recorded():
    """Yield a list that gets, for each MoE call inside, its expert ids
    "idx" (N, k), its capacity "cap" and "dropped", the (token, k) pairs
    past capacity (a device tensor): an expert keeps its first `cap` pairs
    in the stable order, so it drops max(0, pairs - cap). Measurement
    only: ``nn.moe.route`` is wrapped while the block runs."""
    from repro_torch.nn import moe as moe_mod
    calls, real = [], moe_mod.route

    def route(cfg, p, xf):
        gates, idx, aux = real(cfg, p, xf)
        cap = moe_mod.capacity(cfg, xf.shape[0])
        load = torch.zeros(cfg.num_experts, dtype=torch.long, device=idx.device)
        load.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
        calls.append({"idx": idx, "cap": cap, "dropped": (load - cap).clamp(min=0).sum()})
        return gates, idx, aux
    moe_mod.route = route
    try:
        yield calls
    finally:
        moe_mod.route = real


@contextlib.contextmanager
def forced_routing(records):
    """Each ``moe`` call inside takes the expert ids `records` hold, in call
    order, in place of its own top-k (with its own scores at those ids),
    for a comparison only: the same routing, hence the same drops."""
    from repro_torch.nn import moe as moe_mod
    ids = iter([r["idx"] for r in records])
    real = moe_mod.top_k

    def top_k(scores, k):
        idx = next(ids)
        return torch.gather(scores, -1, idx), idx
    moe_mod.top_k = top_k
    try:
        yield
    finally:
        moe_mod.top_k = real


def routing_agreement(cfg, got, want):
    """For each MoE layer, the share of (token, k) choices that two runs'
    records (call order: prefill layers, then each step's) have in common."""
    from repro_torch.models.lm import layer_plan
    n_moe = sum(spec.moe for spec in layer_plan(cfg))
    same, total = [0] * n_moe, [0] * n_moe
    for i, (a, b) in enumerate(zip(got, want)):
        hot = torch.zeros(a["idx"].shape[0], cfg.num_experts, dtype=torch.bool,
                          device=a["idx"].device)
        both = hot.scatter(1, a["idx"], True) & hot.scatter(1, b["idx"], True)
        same[i % n_moe] += int(both.sum())
        total[i % n_moe] += a["idx"].numel()
    return [x / t for x, t in zip(same, total)]


def full_depth_plain_check(bundle, params, prompts, max_len, steps=3, rel=5e-2,
                           frontend=None):
    """The prompts' last-position logits after the prefill, then `steps`
    decode steps' logits (every path fed the kernels' greedy tokens),
    through K1 and K2 against the same through their plain versions on the
    card, at the serving path's full depth in bf16: each rms(got - want)
    <= `rel` times rms(want). The kernels and the plain versions round
    differently (bf16 P on wgmma; fp32 softmax then one bf16 rounding),
    and a layer's difference carries through the rest of the stack.

    With MoE the prefill's logits are compared at every position, and a
    near tie in a router's top-k can flip an expert between the two paths:
    a flipped expert moves a token's output by far more than rounding, and
    through the capacity it moves which later tokens of that expert are
    dropped. So the plain versions run twice: routing for themselves,
    where each layer's share of (token, k) choices in common with the
    kernels' is printed and the argmax must agree on at least
    ``MOE_ARGMAX_SHARE`` of the rows; and with the kernels' routing forced
    (``forced_routing``), which is held to `rel`. With a padded vocab
    (tp > 1) the real vocab's logits are compared, the padded ids' -1e30
    checked apart."""
    from repro_torch.kernels import ops

    cfg = bundle.cfg

    def rel_rms(got, want):
        return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())

    def compare(got, want):
        errs = [rel_rms(g, w) for g, w in zip(got, want)]
        same = [g.argmax(-1) == w.argmax(-1) for g, w in zip(got, want)]
        return errs, [bool(x.all()) for x in same], float(torch.cat(same).float().mean())

    plain = functools.partial(plain_versions, ops, k1=True, k4=False, k2=True)
    path = functools.partial(logits_path, bundle, params, prompts, max_len, steps,
                             every_position=cfg.family == "moe", frontend=frontend)
    with routes_recorded() as rec:
        got, fed = path()
    if cfg.padded_vocab != cfg.vocab_size:
        # the padded ids hold -1e30 on both sides: compared apart, so that
        # they do not swamp the rms of the real vocab's logits
        pad = [g[..., cfg.vocab_size:] for g in got]
        if not all(bool((x == -1e30).all()) for x in pad):
            raise AssertionError("a padded vocab id's logit is not -1e30")
        got = [g[..., :cfg.vocab_size] for g in got]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    res = {}
    if cfg.family == "moe":
        with plain(), routes_recorded() as rec_free:
            free, _ = path(fed)
        free = [w[..., :cfg.vocab_size] for w in free]
        errs, same, share = compare(got, free)
        agree = routing_agreement(cfg, rec, rec_free)
        drops = [sum(int(r["dropped"]) for r in x) for x in (rec, rec_free)]
        log(f"   full depth, plain versions routing for themselves ({prompts.shape[0]} x "
            f"{prompts.shape[1]} prompts, every position, then {steps} decode steps): logits "
            "rms error / rms " + ", ".join(f"{e:.3e}" for e in errs) + f"; argmax equal on "
            f"{share:.3f} of the {sum(g.shape[0] for g in got)} rows "
            f"(>= {MOE_ARGMAX_SHARE}); dropped pairs, kernels {drops[0]}, plain {drops[1]}; "
            "(token, k) choices in common by MoE layer: "
            + " ".join(f"{a:.4f}" for a in agree))
        res.update(free_routing_rel_rms_err=errs, free_routing_argmax_share=share,
                   routing_agreement_by_layer=agree, dropped_kernels_plain=drops)
        if share < MOE_ARGMAX_SHARE:
            raise AssertionError(f"argmax agrees on {share:.3f} of the rows, routing free")
        forced = forced_routing(rec)
    else:
        forced = contextlib.nullcontext()
    with plain(), forced:
        want, _ = path(fed)
    want = [w[..., :cfg.vocab_size] for w in want]
    errs, same, share = compare(got, want)
    log(f"   full depth against the plain versions{' (the kernels routing forced)' if res else ''}"
        f" ({prompts.shape[0]} x {prompts.shape[1]} prompt, then {steps} decode steps): logits "
        "rms error / rms " + ", ".join(f"{e:.3e}" for e in errs) + f" (<= {rel:g}); argmax "
        f"equal {same} ({share:.3f} of the rows); finite {finite}")
    if not (finite and max(errs) <= rel):
        raise AssertionError(f"full-depth logits differ from the plain versions' by {errs}")
    return {"plain_rel_rms_err": errs, "plain_argmax_equal": same, "plain_argmax_share": share,
            **res}


@contextlib.contextmanager
def annotated_layers():
    """The LM's MoE calls and MLA decode calls inside profiler ranges named
    "moe" and "mla_decode" (``torch.profiler.record_function``), so that
    ``device_breakdown`` can group their kernels; for measurement only."""
    from repro_torch.models import lm

    def named(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return run
    real = lm.moe, lm.mla_decode
    lm.moe, lm.mla_decode = named("moe", lm.moe), named("mla_decode", lm.mla_decode)
    try:
        yield
    finally:
        lm.moe, lm.mla_decode = real


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
    kernels (K1 either route, K3 any route and the 3xTF32 route's three
    passes, K2 its split and combine passes, K1-bwd its four kernels, K3-bwd
    its five), GEMMs (cuBLAS / CUTLASS), and everything else; and
    the number of device kernels per call. A group's time, and "busy" over all of them, count
    each instant once: K2's combine is launched while its split pass runs.
    Under ``annotated_layers`` the kernels inside an MoE call form the groups
    "moe_gemm" (its GEMMs: router, bmm, shared experts) and "moe_dispatch"
    (the rest: softmax, sort, searchsorted, gathers, the combine), and those
    inside MLA's absorbed decode the group "mla_decode"."""
    import bisect
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = sorted((e.time_range.start, e.time_range.end, e.name) for e in cuda
                   if getattr(e, "is_user_annotation", False)
                   and e.name in ("moe", "mla_decode"))
    starts = [m[0] for m in marks]

    def mark_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return marks[i][2] if i >= 0 and t < marks[i][1] else None

    spans = {g: [] for g in ("K1", "K1-bwd", "K2", "K3", "K3-bwd", "K4", "K4-bwd", "gemm",
                             "other")}
    if marks:
        spans.update({g: [] for g in ("moe_gemm", "moe_dispatch", "mla_decode")})
    kernels, dispatch = 0, {}
    for e in cuda:
        if getattr(e, "is_user_annotation", False):
            continue
        kernels += 1
        name = e.name.lower()
        mark = mark_of(e.time_range.start) if marks else None
        is_gemm = any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas"))
        if mark == "moe":
            g = "moe_gemm" if is_gemm else "moe_dispatch"
            if not is_gemm:
                dispatch[e.name] = dispatch.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / n
        elif mark == "mla_decode":
            g = "mla_decode"
        elif "flash_tf32x3_kernel" in name or "flash_wgmma_kernel" in name:
            g = "K1"
        elif "flash_bwd_" in name:
            g = "K1-bwd"
        elif "rglru_bwd_" in name:
            g = "K4-bwd"
        elif "ssd_bwd_" in name:
            g = "K3-bwd"
        elif "decode_split_kernel" in name or "decode_combine_kernel" in name:
            g = "K2"
        elif any(k in name for k in ("ssd_chunk_kernel", "ssd_wgmma_kernel", "ssd_state_kernel",
                                     "ssd_pass_kernel", "ssd_out_kernel")):
            g = "K3"
        elif "rglru_chunk_kernel" in name:
            g = "K4"
        elif is_gemm:
            g = "gemm"
        else:
            g = "other"
        spans[g].append((e.time_range.start, e.time_range.end))
    groups = {"busy": union_ms([s for found in spans.values() for s in found]) / n}
    groups.update({g: union_ms(found) / n for g, found in spans.items()})
    if groups["busy"] <= 0:
        raise AssertionError("the profiler recorded no device time")
    if dispatch:   # the dispatch's costliest kernels, by name (names cut to 60)
        top = sorted(dispatch.items(), key=lambda kv: -kv[1])[:5]
        groups["moe_dispatch_top"] = {name[:60]: ms for name, ms in top}
    return groups, kernels / n


def parity_phase(arch, prompt_len, **override):
    """At `arch`'s reduced config (with `override`), the port on the card
    against the port on the CPU, fp32 with TF32 off: prefill logits within
    1e-4, 12 greedy tokens equal. With MoE, the dropped (token, k) pairs
    are printed, and where the two devices route a call differently the
    layer and tokens are reported before the check fails."""
    from repro_torch.configs.registry import make_model, smoke_config
    from repro_torch.launch.serve import greedy_generate

    shown = "".join(f", {k} {v}" for k, v in override.items())
    log(f"== parity: {arch} reduced config{shown}, card vs CPU, fp32, TF32 off, "
        f"{prompt_len}-token prompts")
    cfg = smoke_config(arch).with_(**override)
    bundle = make_model(cfg)
    cpu = bundle.init(0, device="cpu", dtype=torch.float32)
    gpu = bundle.init(0, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    b_cpu = {"tokens": torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=gen)}
    if cfg.family == "encdec":   # seeded frames for the encoder
        b_cpu["frontend"] = torch.randn(2, cfg.frontend_tokens, cfg.frontend_dim,
                                        generator=gen)
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    max_len = prompt_len + 40
    with routes_recorded() as rec_cpu:
        o_cpu, _ = bundle.prefill(cpu, b_cpu, max_len=max_len, dtype=torch.float32)
        t_cpu = greedy_generate(bundle, cpu, b_cpu, 12, max_len, torch.float32)
    with routes_recorded() as rec_gpu:
        o_gpu, _ = bundle.prefill(gpu, b_gpu, max_len=max_len, dtype=torch.float32)
        t_gpu = greedy_generate(bundle, gpu, b_gpu, 12, max_len, torch.float32)
    moe_note = ""
    if cfg.family == "moe":
        from repro_torch.models.lm import layer_plan
        n_moe = sum(spec.moe for spec in layer_plan(cfg))
        for i, (c, g) in enumerate(zip(rec_cpu, rec_gpu)):
            rows = (c["idx"] != g["idx"].cpu()).any(-1).nonzero().flatten().tolist()
            if rows:   # the call order: prefill's layers, greedy's prefill, its steps
                log(f"   ROUTE DIFFERS: call {i} (MoE layer {i % n_moe}): tokens {rows[:16]}")
        drops = [sum(int(r["dropped"]) for r in rec) for rec in (rec_cpu, rec_gpu)]
        moe_note = f"; dropped (token, k) pairs, CPU {drops[0]}, card {drops[1]}"
        if (drops[1] > 0) != (cfg.capacity_factor < 2):
            raise AssertionError(f"capacity factor {cfg.capacity_factor}: {drops[1]} pairs "
                                 "dropped on the card")
    err = max_err(o_gpu.logits.cpu(), o_cpu.logits)
    if not (torch.isfinite(o_gpu.logits).all() and err < 1e-4):
        raise AssertionError(f"prefill logits differ by {err}")
    if not torch.equal(t_gpu.cpu(), t_cpu):
        raise AssertionError(f"greedy tokens differ:\n{t_gpu.cpu()}\n{t_cpu}")
    log(f"   prefill logits max_abs_err {err:.3e} (< 1e-4); 12 greedy tokens equal: "
        f"{t_cpu.tolist() if moe_note else t_cpu[0].tolist()}{moe_note}")


def rows_max_err(a, b, rows=256):
    """max |a - b| over (B, S, ...) tensors, S taken `rows` at a time, so
    that no temporary of a whole vocab-wide logits tensor is made."""
    return max(max_err(a[:, i:i + rows], b[:, i:i + rows]) for i in range(0, a.shape[1], rows))


def ring_wrap_phase():
    """gemma2-9b at full width cut to its first period, one local and one
    global layer, fp32 with TF32 off: a 4352-token prompt passes the window
    of 4096, so K1's window ends inside the prompt and the local layer's
    ring of 4096 slots wraps in the prefill and goes on wrapping in decode.
    The prefill's logits at every position, then 16 decode steps' logits
    (both paths fed the kernels' greedy token) and greedy tokens, through
    K1 and K2 against the same through their plain versions on the card."""
    from repro_torch.configs.registry import get_config, make_model
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    prompt_len, steps = SERVE["gemma2-9b"][0], TOKENS
    cfg = get_config("gemma2-9b").with_(num_layers=len(get_config("gemma2-9b").attn_pattern))
    log(f"== ring wrap: {cfg.name} at full width, layers {'/'.join(cfg.attn_pattern)} "
        f"(window {cfg.local_window}), fp32, TF32 off, 2 x {prompt_len}-token prompts and "
        f"{steps} decode steps, kernels against their plain versions on the card")
    bundle = make_model(cfg)
    params = bundle.init(0, device="cuda", dtype=torch.float32)
    # the tied table scaled by 0.1, as the train parity tests do: the logits
    # are then about 6 a standard deviation, mostly inside the cap of 30,
    # where at init they are 60 and saturate it. The greedy tokens still
    # echo the input token at this init (its own logit stands far above the
    # rest), so the comparison rests on the logits
    params.embed.table.mul_(0.1)
    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=gen).cuda()}
    max_len = prompt_len + steps
    ops.reset_launch_counts()
    with torch.no_grad():
        out, cache = bundle.prefill(params, batch, max_len=max_len, dtype=torch.float32)
        routes = dict(K1.flash_attention.launches_by_route)
        with plain_versions(ops, k1=True, k4=False, k2=True):
            want, pcache = bundle.prefill(params, batch, max_len=max_len, dtype=torch.float32)
        err = rows_max_err(out.logits, want.logits)
        v_err = max_err(out.value, want.value)
        finite = bool(torch.isfinite(out.logits).all())
        ring = cache["layers"][0]["pos"]
        if sorted(ring.tolist()) != list(range(prompt_len - cfg.local_window, prompt_len)):
            raise AssertionError("the local layer's ring does not hold the last 4096 positions")
        log(f"   prefill through K1 {routes} against the plain versions: logits (2, "
            f"{prompt_len}, {cfg.vocab_size}) max_abs_err {err:.3e}, value {v_err:.3e} (< 1e-3; "
            f"the logits are capped at {cfg.final_softcap}); finite {finite}; slot 0 of the "
            f"ring holds position {int(ring[0])}")
        if not (finite and err < 1e-3 and v_err < 1e-3):
            raise AssertionError(f"ring-wrap prefill differs from the plain versions by {err}")
        tok = out.logits[:, -1].argmax(-1, keepdim=True)
        ptok = want.logits[:, -1].argmax(-1, keepdim=True)
        del out, want
        toks, ptoks, d_err = [tok], [ptok], 0.0
        for _ in range(steps):
            o, cache = bundle.decode_step(params, tok, cache)
            with plain_versions(ops, k1=True, k4=False, k2=True):
                w, pcache = bundle.decode_step(params, tok, pcache)
            d_err = max(d_err, max_err(o.logits, w.logits), max_err(o.value, w.value))
            tok, ptok = o.logits[:, -1].argmax(-1, keepdim=True), w.logits[:, -1].argmax(
                -1, keepdim=True)
            toks.append(tok)
            ptoks.append(ptok)
    counts = ops.launch_counts()
    got, plain = torch.cat(toks, 1), torch.cat(ptoks, 1)
    if counts != {**dict.fromkeys(counts, 0), "flash_attention": cfg.num_layers,
                  "decode_attention": cfg.num_layers * steps}:
        raise AssertionError(f"launches {counts}: expected K1 {cfg.num_layers} and K2 "
                             f"{cfg.num_layers * steps}")
    if not (d_err < 1e-3 and torch.equal(got, plain)):
        raise AssertionError(f"decode differs from the plain versions: logits by {d_err}, "
                             f"tokens\n{got.cpu()}\n{plain.cpu()}")
    seconds = time.perf_counter() - t0
    log(f"   {steps} decode steps (positions {prompt_len}..{max_len - 1}, the ring's slots "
        f"{prompt_len % cfg.local_window}..{(max_len - 1) % cfg.local_window}): logits and "
        f"value max_abs_err {d_err:.3e} (< 1e-3), greedy tokens equal the plain versions' "
        f"(row 0: {got[0, :6].tolist()}...); launches {counts}; {seconds:.1f} s")
    return {"prefill_logits_max_abs_err": err, "value_max_abs_err": v_err,
            "decode_max_abs_err": d_err, "seconds": seconds}


def grad_guard_phase():
    """A kernel with no backward kernel (K1 bf16, K2, K3 bf16) refuses an
    input that requires a gradient, rather than return a tensor with no
    grad_fn; K3 in fp32 and K1 in fp32 with k and v of a length of their
    own, which have backward kernels, return tensors with a grad_fn."""
    from repro_torch.kernels import ops
    log("== grad guards: K1 bf16, K2 and K3 bf16 raise under autograd on the card; K3 fp32 and "
        "K1 fp32 with k and v of a length of their own record a graph")
    dev = torch.device("cuda")
    q = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    q32 = torch.randn(1, 64, 2, 64, device=dev, requires_grad=True)
    frames = torch.randn(1, 96, 2, 64, device=dev)
    kv = torch.randn(1, 32, 2, 64, device=dev, requires_grad=True)
    x = torch.randn(1, 16, 2, 16, device=dev, requires_grad=True)
    bm = torch.randn(1, 16, 1, 16, device=dev)
    dt, a = torch.rand(1, 16, 2, device=dev), -torch.ones(2, device=dev)
    xb, bb = x.detach().bfloat16().requires_grad_(), bm.bfloat16()
    calls = {"K1 bf16": lambda: ops.flash_attention(q, q, q),
             "K2": lambda: ops.decode_attention(kv[:, 0], kv, kv,
                                                torch.ones(1, dtype=torch.int32, device=dev)),
             "K3 bf16": lambda: ops.ssd_scan(xb, dt, a, bb, bb)}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            log(f"   {name}: NotImplementedError: {str(e)[:90]}...")
        else:
            raise AssertionError(f"{name} ran under autograd with no backward kernel")
    recorded = {"K1 fp32, S_kv != S": lambda: ops.flash_attention(q32, frames, frames,
                                                                  causal=False),
                "K3 fp32": lambda: ops.ssd_scan(x, dt, a, bm, bm)}
    for name, call in recorded.items():
        out = call()
        if out.grad_fn is None:
            raise AssertionError(f"{name} under autograd returned a tensor with no grad_fn")
        log(f"   {name}: grad_fn {type(out.grad_fn).__name__}")
    with torch.no_grad():
        if ops.flash_attention(q, q, q).grad_fn is not None:
            raise AssertionError("K1 under no_grad recorded a graph")


@contextlib.contextmanager
def plain_versions(ops, k1=True, k4=True, k2=False, k3=False):
    """The model's calls of K1, K4, K2 and/or K3 (``ops.flash_attention``,
    ``ops.rglru_scan``, ``ops.decode_attention``, ``ops.ssd_scan``) taken by
    their plain versions on the card, for a comparison only; the port's
    wrappers never do this."""
    saved = ops.flash_attention, ops.rglru_scan, ops.decode_attention, ops.ssd_scan

    def ssd_plain(x, dt, a, b, c, *, chunk=128, h0=None, return_state=False):
        y, state = ops.ssd_scan_plain(x, dt, a, b, c, chunk=chunk, h0=h0)
        return (y, state) if return_state else y
    if k1:
        ops.flash_attention = lambda q, k, v, **kw: ops.flash_attention_plain(q, k, v, **kw)
    if k4:
        ops.rglru_scan = lambda a, b, **kw: ops.rglru_scan_plain(a, b, **kw)
    if k2:
        ops.decode_attention = lambda q, k, v, lengths, **kw: ops.decode_attention_plain(
            q, k, v, lengths, **kw)
    if k3:
        ops.ssd_scan = ssd_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.rglru_scan, ops.decode_attention, ops.ssd_scan = saved


def flash_attention_fp64(q, k, v, *, causal=True, window=0, softcap=None, scale=None):
    """K1's function computed in fp64 (any device), returned in fp64: the
    reference that K1's kernel and its plain fp32 version are both held
    against."""
    from repro_torch.kernels import ops
    h, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    x = torch.einsum("bqhd,bkhd->bhqk", q.double(), ops._expand_kv(k, h).double()) * scale
    if softcap:
        x = softcap * torch.tanh(x / softcap)
    x = torch.where(ops._mask(q.shape[1], causal, window, q.device, k.shape[1]), x, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(x, -1), ops._expand_kv(v, h).double())


def rglru_scan_fp64(a, b, *, h0=None, out_dtype=torch.float32):
    """K4's function, h_t = a_t h_{t-1} + b_t, with an fp64 carry; y in
    `out_dtype`, h_last in fp32, as ``ops.rglru_scan_plain`` returns them."""
    h = a.new_zeros(a[:, 0].shape, dtype=torch.float64) if h0 is None else h0.double()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + b[:, t].double()
        hs.append(h)
    return torch.stack(hs, dim=1).to(out_dtype), h.float()


def ssd_scan_fp64(x, dt, a, b, c, *, chunk=128, h0=None, return_state=False):
    """K3's function computed in fp64 (the plain chunked algorithm on fp64
    inputs); y in x's dtype and the final state in fp32, as
    ``ops.ssd_scan`` returns them."""
    from repro_torch.kernels import ops
    y, state = ops.ssd_scan_plain(*(t.double() for t in (x, dt, a, b, c)), chunk=chunk,
                                  h0=None if h0 is None else h0.double())
    y, state = y.to(x.dtype), state.float()
    return (y, state) if return_state else y


@contextlib.contextmanager
def fp64_versions(ops):
    """The model's calls of K1, K3 and K4 taken in fp64
    (``flash_attention_fp64``, ``ssd_scan_fp64``, ``rglru_scan_fp64``; the
    rest of the model stays fp32), for the gradient comparison only."""
    saved = ops.flash_attention, ops.rglru_scan, ops.ssd_scan
    ops.flash_attention = lambda q, k, v, **kw: flash_attention_fp64(q, k, v, **kw).to(q.dtype)
    ops.rglru_scan = rglru_scan_fp64
    ops.ssd_scan = ssd_scan_fp64
    try:
        yield
    finally:
        ops.flash_attention, ops.rglru_scan, ops.ssd_scan = saved


def leaf_distances(grads, ref) -> dict:
    """Each gradient leaf's distance from the reference's: the largest
    |g - g_ref| / (GRAD_TOL (max |g_ref| + |g_ref|)) over its elements, above
    1 where the leaf misses GRAD_TOL of its max."""
    out = {}
    for n, r in ref.items():
        tol = GRAD_TOL * (float(r.abs().max()) + r.abs())
        out[n] = float(((grads[n] - r).abs() / tol.clamp_min(1e-38)).max())
    return out


def fp64_verdict(got, plain, ref) -> dict:
    """The gradient leaves `got` (through kernels) against `ref` (fp64
    versions), beside the same leaves `plain` (plain fp32 versions): a leaf
    fails where it is beyond GRAD_TOL of its max from `ref` and more than
    FP64_MARGIN times as far as the plain fp32 leaf. Returns the failures
    (name, distance, plain's distance), the leaf nearest to failing, and the
    farthest leaf of each run."""
    d_got, d_plain = leaf_distances(got, ref), leaf_distances(plain, ref)
    limit = {n: max(1.0, FP64_MARGIN * d_plain[n]) for n in ref}
    worst = max(ref, key=lambda n: d_got[n] / limit[n])
    return {"failed": [(n, d_got[n], d_plain[n]) for n in ref if d_got[n] > limit[n]],
            "nearest": (worst, d_got[worst], d_plain[worst]),
            "farthest": max((d, n) for n, d in d_got.items()),
            "farthest_plain": max((d, n) for n, d in d_plain.items())}


@contextlib.contextmanager
def recorded_calls(K1, K4):
    """Every call of K1's and K4's autograd Functions (``FlashAttention``,
    ``RGLRUScan``) recorded as it runs: its inputs, options and outputs, and
    in the backward the output gradients and the input gradients that the
    backward kernel returns (K1 also its log-sum-exp)."""
    calls = []
    fa, rg = K1.FlashAttention, K4.RGLRUScan
    saved = fa.forward, fa.backward, rg.forward, rg.backward
    det = lambda t: None if t is None else t.detach()   # noqa: E731

    def fa_fwd(ctx, q, k, v, scale, causal, window, softcap):
        out = saved[0](ctx, q, k, v, scale, causal, window, softcap)
        ctx.rec = dict(kernel="K1", ins=(q.detach(), k.detach(), v.detach()), out=(out.detach(),),
                       opts=dict(scale=scale, causal=causal, window=window, softcap=softcap))
        calls.append(ctx.rec)
        return out

    def fa_bwd(ctx, do):
        grads = saved[1](ctx, do)
        ctx.rec.update(lse=ctx.saved_tensors[4].detach(), dout=(do.detach(),), grads=grads[:3])
        return grads

    def rg_fwd(ctx, a, b, h0, out_dtype):
        y, h_last = saved[2](ctx, a, b, h0, out_dtype)
        ctx.rec = dict(kernel="K4", ins=(a.detach(), b.detach(), det(h0)),
                       out=(y.detach(), h_last.detach()), opts=dict(out_dtype=out_dtype))
        calls.append(ctx.rec)
        return y, h_last

    def rg_bwd(ctx, dy, dh_last):
        grads = saved[3](ctx, dy, dh_last)
        ctx.rec.update(dout=(det(dy), det(dh_last)), grads=grads[:3])
        return grads

    fa.forward, fa.backward = staticmethod(fa_fwd), staticmethod(fa_bwd)
    rg.forward, rg.backward = staticmethod(rg_fwd), staticmethod(rg_bwd)
    try:
        yield calls
    finally:
        fa.forward, fa.backward, rg.forward, rg.backward = (staticmethod(f) for f in saved)


def check_call(ops, rec):
    """One recorded call of K1 or K4 in the model against its plain version
    on the same inputs: the outputs at the kernel's tolerance (K1 2e-5 and
    its log-sum-exp LSE_TOL, K4 1e-5 of max |h|), the input gradients from
    the same output gradients at GRAD_TOL of each one's max (autograd of
    the plain forward). Returns the worst gradient error over its max."""
    ins = [None if t is None else t.clone().requires_grad_() for t in rec["ins"]]
    leaves = [t for t in ins if t is not None]
    if rec["kernel"] == "K1":
        outs = (ops.flash_attention_plain(*ins, **rec["opts"]),)
        check_close("K1 output", rec["out"][0], outs[0].detach(), 2e-5)
        check_close("K1 log-sum-exp", rec["lse"], ops.flash_attention_lse_plain(
            *rec["ins"][:2], **rec["opts"]), LSE_TOL)
        names = ("dq", "dk", "dv")
    else:
        outs = ops.rglru_scan_plain(ins[0], ins[1], h0=ins[2])
        for name, got, want in zip(("y", "h_last"), rec["out"], outs):
            scale = float(want.detach().abs().max())
            check_close(f"K4 {name}", got, want.detach().to(got.dtype), 0.0, 1e-5 * scale)
        names = ("da", "db", "dh0")
    pairs = [(o, g) for o, g in zip(outs, rec["dout"]) if g is not None]
    want = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])
    worst = 0.0
    for name, got, w in zip(names, [g for g in rec["grads"] if g is not None], want):
        scale = max(float(w.abs().max()), 1e-30)
        err = check_close(f"{rec['kernel']} {name}", got, w, GRAD_TOL, GRAD_TOL * scale)
        worst = max(worst, err / scale)
    return worst


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
    """At 3 layers (rglru, rglru, local) of full width, fp32 on the card:
    the V-trace loss through K1, K1-bwd, K4 and K4-bwd against the same
    through their plain versions under autograd; every call of K1 and K4
    in that run, its outputs and its input gradients, against the plain
    version on the same inputs and output gradients (``check_call``); every
    gradient leaf with K1 and K1-bwd in the model (K4 plain on both sides)
    against the plain versions, within GRAD_TOL of each leaf's max; and
    every gradient leaf with all four kernels in the model against K1 and
    K4 taken in fp64 (``fp64_versions``), beside the plain fp32 versions
    against the same (``fp64_verdict``).

    The leaves with every kernel in the model are held against fp64, not
    against the plain fp32 versions: several (the RG-LRU gates' biases,
    value_head.b) have gradients of 1e-8 to 2e-7 where the largest leaf's
    is 4e-5, and any fp32 rounding of K1's and K4's function, the plain
    versions' too, moves them by more than GRAD_TOL of their own max from
    fp64 (tools/train_parity_fp64.py)."""
    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as K4
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = TRAIN["batch"], TRAIN["seq"]
    run = train.setup(TRAIN["arch"], batch=b, seq=s, steps=1, device="cuda", num_layers=3)
    log(f"== train parity: {run.cfg.name} at {run.cfg.num_layers} layers, full width, fp32, "
        f"batch {b} x seq {s}: the kernels against their plain versions and against fp64")
    params = run.make_state()["params"]
    live_table(params, run.cfg)
    named = dict(params.named_parameters())
    batch = run.batch_at(0)
    loss_fn = make_vtrace_loss(run.bundle)
    ops.reset_launch_counts()
    with recorded_calls(K1, K4) as calls:
        loss, _ = loss_fn(params, batch)
        got = param_grads(loss, named)
    counts = ops.launch_counts()
    with plain_versions(ops):
        loss_p, _ = loss_fn(params, batch)
        want = param_grads(loss_p, named)
    if ops.launch_counts() != counts or counts["flash_attention_bwd"] != 1 \
            or counts["rglru_scan_bwd"] != 2 or [c["kernel"] for c in calls] != ["K4", "K4", "K1"]:
        raise AssertionError(f"launches {counts} then {ops.launch_counts()}, calls "
                             f"{[c['kernel'] for c in calls]}: want 1 K1 and 2 K4 calls and "
                             "backward calls through the kernels, none through the plain versions")
    check_close("loss", loss.detach(), loss_p.detach(), 1e-5)
    worst_call = max(check_call(ops, c) for c in calls)
    with plain_versions(ops, k1=False):
        got_k1 = param_grads(loss_fn(params, batch)[0], named)
    k1_far = leaf_distances(got_k1, want)
    if max(k1_far.values()) > 1:
        raise AssertionError("gradient leaves with K1 and K1-bwd beyond GRAD_TOL of their max "
                             "from the plain versions: "
                             f"{ {n: d for n, d in k1_far.items() if d > 1} }")
    del got_k1
    with fp64_versions(ops):
        ref = param_grads(loss_fn(params, batch)[0], named)
    verdict = fp64_verdict(got, want, ref)
    if verdict["failed"]:
        raise AssertionError("gradient leaves with every kernel farther from fp64 than GRAD_TOL "
                             f"and than {FP64_MARGIN:g} times the plain fp32 versions' "
                             f"(leaf, distance, plain's distance): {verdict['failed']}")
    k1_worst = max((d, n) for n, d in k1_far.items())
    (n_near, d_near, p_near), far, far_p = (verdict[k] for k in ("nearest", "farthest",
                                                                  "farthest_plain"))
    log(f"   loss {float(loss.detach()):.6f} (plain {float(loss_p.detach()):.6f}); {len(calls)} "
        f"kernel calls, each output and input gradient within tolerance (the worst gradient "
        f"{worst_call:.2e} of its max); {len(want)} gradient leaves with K1 and K1-bwd within "
        f"{GRAD_TOL:g} of each leaf's max |g| of the plain versions (the worst at "
        f"{k1_worst[0]:.3f} of it, {k1_worst[1]}); with every kernel, each leaf's distance from "
        f"fp64 within max(1, {FP64_MARGIN:g} x plain fp32's), in units of {GRAD_TOL:g} of its "
        f"max: the farthest {far[0]:.3f} ({far[1]}), plain fp32's farthest {far_p[0]:.3f} "
        f"({far_p[1]}), the nearest to its limit {n_near} at {d_near:.3f} (plain {p_near:.3f})")
    del params, named, got, want, ref, loss, loss_p, calls


def expected_train_launches(cfg, steps):
    """Launches of `steps` V-trace steps, by family; no training path runs
    K2. RecurrentGemma runs K1 and K1-bwd once per local layer, K4 and
    K4-bwd once per recurrent layer; Mamba2 K3 and K3-bwd once per layer;
    the encoder-decoder K1 and K1-bwd once per encoder layer and twice per
    decoder layer (self- and cross-attention)."""
    want = dict.fromkeys(("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
                          "flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd"), 0)
    if cfg.family == "hybrid":
        from repro_torch.models.recurrentgemma import layer_kinds
        n_rec = layer_kinds(cfg).count("rglru")
        n_att = cfg.num_layers - n_rec
        want.update(flash_attention=n_att * steps, flash_attention_bwd=n_att * steps,
                    rglru_scan=n_rec * steps, rglru_scan_bwd=n_rec * steps)
    elif cfg.family == "ssm":
        want.update(ssd_scan=cfg.num_layers * steps, ssd_scan_bwd=cfg.num_layers * steps)
    elif cfg.family == "encdec":
        n = (cfg.enc_layers + 2 * cfg.dec_layers) * steps
        want.update(flash_attention=n, flash_attention_bwd=n)
    else:
        raise ValueError(f"no train path on the card for the {cfg.family} family")
    return want


# the profiler groups a train step of each family must fill, and those it
# must leave empty
TRAIN_GROUPS = {"hybrid": ("K1", "K1-bwd", "K4", "K4-bwd"), "ssm": ("K3", "K3-bwd"),
                "encdec": ("K1", "K1-bwd")}
KERNEL_GROUPS = ("K1", "K1-bwd", "K2", "K3", "K3-bwd", "K4", "K4-bwd")


@contextlib.contextmanager
def kv_len_calls(K1):
    """Counts of the calls of K1's autograd Function (``FlashAttention``:
    every K1 and K1-bwd call of a train step) whose k and v have a length
    of their own (S_kv != S), by "S x S_kv", forward and backward apart,
    read from their inputs while the block runs."""
    counts = {"flash_attention": {}, "flash_attention_bwd": {}}
    fa = K1.FlashAttention
    saved = fa.forward, fa.backward

    def tally(name, q, k):
        if k.shape[1] != q.shape[1]:
            key = f"{q.shape[1]}x{k.shape[1]}"
            counts[name][key] = counts[name].get(key, 0) + 1

    def fwd(ctx, q, k, v, *opts):
        tally("flash_attention", q, k)
        return saved[0](ctx, q, k, v, *opts)

    def bwd(ctx, do):
        q, k = ctx.saved_tensors[:2]
        tally("flash_attention_bwd", q, k)
        return saved[1](ctx, do)
    fa.forward, fa.backward = staticmethod(fwd), staticmethod(bwd)
    try:
        yield counts
    finally:
        fa.forward, fa.backward = (staticmethod(f) for f in saved)


@contextlib.contextmanager
def relu_masks(masks=None):
    """The ReLU MLP's activation (``nn/mlp.py``'s ``ACTS["relu"]``, the
    encoder-decoder's) with its sign masks recorded in call order into the
    list yielded (`masks` None), or replayed from `masks` (h * mask: the
    same value and gradient wherever the two runs agree on the sign), for
    the gradient comparison only. ReLU's gradient jumps at 0: a
    pre-activation within rounding of 0 takes another sign under another
    rounding of the attention, and moves its leaf by one token's share."""
    import torch.nn.functional as F
    from repro_torch.nn import mlp as mlp_mod
    saved = mlp_mod.ACTS["relu"]
    out = []
    replay = None if masks is None else iter(masks)

    def act(h):
        if replay is not None:
            return h * next(replay).to(h.dtype)
        out.append(h.detach() > 0)
        return F.relu(h)
    mlp_mod.ACTS["relu"] = act
    try:
        yield out
    finally:
        mlp_mod.ACTS["relu"] = saved


# the families' train parity at a few layers of full width: the layers each
# keeps
TRAIN_PARITY = {"mamba2-2.7b": dict(num_layers=3),
                "seamless-m4t-large-v2": dict(enc_layers=2, dec_layers=2, num_layers=4)}


def family_train_parity_phase(arch):
    """`arch` at TRAIN_PARITY's layers of full width, fp32 on the card: the
    V-trace loss through its kernels and their backward kernels (Mamba2: K3
    and K3-bwd; the encoder-decoder: K1 and K1-bwd, its cross calls at S_kv
    != S) against the same through their plain versions under autograd,
    within 1e-5; the launch counts of one step; and every gradient leaf
    against the plain versions' within GRAD_TOL of the leaf's max, or,
    where a leaf is farther, against the kernels taken in fp64
    (``fp64_versions``): within GRAD_TOL of its max of fp64, or no farther
    than FP64_MARGIN times the plain fp32 versions are (``fp64_verdict``).
    The plain and fp64 runs take the kernel run's ReLU masks
    (``relu_masks``; the encoder-decoder's MLPs): the leaves of a run with
    its own masks differ by the pre-activations whose sign the rounding
    flips, which are counted and logged with that run's farthest leaf."""
    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    b, s = TRAIN["batch"], TRAIN["seq"]
    run = train.setup(arch, batch=b, seq=s, steps=1, device="cuda", **TRAIN_PARITY[arch])
    cfg = run.cfg
    log(f"== train parity: {cfg.name} at {TRAIN_PARITY[arch]}, full width, fp32, batch {b} x "
        f"seq {s}{f' over {cfg.frontend_tokens} frames' if cfg.family == 'encdec' else ''}: "
        "the kernels against their plain versions, and against fp64 where the plain versions "
        "sit farther")
    params = run.make_state()["params"]
    if cfg.tie_embeddings:
        live_table(params, cfg)
    named = dict(params.named_parameters())
    batch = run.batch_at(0)
    loss_fn = make_vtrace_loss(run.bundle)
    ops.reset_launch_counts()
    with kv_len_calls(K1) as kv_calls, relu_masks() as masks:
        loss, _ = loss_fn(params, batch)
        got = param_grads(loss, named)
    counts = ops.launch_counts()
    want_counts = expected_train_launches(cfg, 1)
    if counts != want_counts:
        raise AssertionError(f"launches {counts} != expected {want_counts}")
    if cfg.family == "encdec":
        key = f"{s}x{cfg.frontend_tokens}"
        want_kv = {"flash_attention": {key: cfg.dec_layers},
                   "flash_attention_bwd": {key: cfg.dec_layers}}
        if kv_calls != want_kv:
            raise AssertionError(f"K1 calls at S_kv != S {kv_calls}, want {want_kv}")
    with plain_versions(ops, k1=True, k4=False, k3=True), relu_masks() as free_masks:
        loss_p, _ = loss_fn(params, batch)
        free = leaf_distances(got, param_grads(loss_p, named))
    flips = sum(int((m != f).sum()) for m, f in zip(masks, free_masks))
    del free_masks
    with plain_versions(ops, k1=True, k4=False, k3=True), relu_masks(masks):
        want = param_grads(loss_fn(params, batch)[0], named)
    if ops.launch_counts() != counts:
        raise AssertionError(f"the plain runs launched a kernel: {ops.launch_counts()}")
    check_close("loss", loss.detach(), loss_p.detach(), 1e-5)
    d_plain = leaf_distances(got, want)
    with fp64_versions(ops), relu_masks(masks):
        ref = param_grads(loss_fn(params, batch)[0], named)
    verdict = fp64_verdict(got, want, ref)
    far = {n for n, d in d_plain.items() if d > 1}
    top = max(float(w.abs().max()) for w in want.values())
    floored, failed = {}, []
    for n, d, dp in verdict["failed"]:
        if n not in far:
            continue
        dev = float((got[n] - want[n]).abs().max())
        if dev <= LEAF_FLOOR * top:   # (its max |g|, its deviation) over the largest leaf's
            floored[n] = (float(want[n].abs().max()) / top, dev / top)
        else:
            failed.append((n, d, dp, dev / top))
    if failed:
        raise AssertionError("gradient leaves farther than GRAD_TOL from the plain versions', "
                             f"than {FP64_MARGIN:g} times the plain fp32 versions' from fp64, and "
                             f"than {LEAF_FLOOR:g} of the largest leaf's max (leaf, distance, "
                             f"plain's distance, deviation over the largest leaf's max): {failed}")
    worst = max((d, n) for n, d in d_plain.items())
    far_fp64 = verdict["farthest"]
    free_worst = max((d, n) for n, d in free.items())
    seconds = time.perf_counter() - t0
    log(f"   loss {float(loss.detach()):.6f} (plain {float(loss_p.detach()):.6f}); launches "
        f"{ {k: v for k, v in counts.items() if v} }"
        f"{f'; K1 calls at S_kv != S {kv_calls}' if cfg.family == 'encdec' else ''}; "
        f"{len(want)} gradient leaves, {len(want) - len(far)} within {GRAD_TOL:g} of each "
        f"leaf's max |g| of the plain versions (the farthest at {worst[0]:.3f} of it, "
        f"{worst[1]}), {len(far)} farther, each within max(1, {FP64_MARGIN:g} x plain fp32's) "
        f"distance of fp64 (in units of {GRAD_TOL:g} of its max: the farthest leaf with the "
        f"kernels {far_fp64[0]:.3f} ({far_fp64[1]}), plain fp32's farthest "
        f"{verdict['farthest_plain'][0]:.3f} ({verdict['farthest_plain'][1]}))"
        + (f"; {len(floored)} within {LEAF_FLOOR:g} of the largest leaf's max (leaf: its max "
           f"|g|, its deviation, over the largest leaf's max): {floored}" if floored else "")
        + (f"; with ReLU masks of their own ({len(masks)} ReLU calls) the plain versions flip "
           f"{flips} pre-activations' signs, and the farthest leaf is at {free_worst[0]:.3f} "
           f"({free_worst[1]})" if masks else "") + f"; {seconds:.1f} s")
    out = {"loss": float(loss.detach()), "loss_plain": float(loss_p.detach()),
           "seconds": seconds, "leaves": len(d_plain), "beyond_plain_tol": sorted(far),
           "farthest_vs_plain": worst, "farthest_vs_fp64": far_fp64, "relu_calls": len(masks),
           "relu_sign_flips": flips, "farthest_vs_plain_own_masks": free_worst,
           "within_leaf_floor": floored}
    del params, named, got, want, ref, loss, loss_p, masks
    return out


def train_phase(arch):
    """`arch` at full width and depth trains TRAIN["steps"] steps through
    ``repro_torch.launch.train``'s functions, from its init (a tied table
    scaled by ``live_table``), its launches those of
    ``expected_train_launches`` (the encoder-decoder's cross calls at S_kv
    != S counted apart), every K1 launch on K1's fp32 route and every K3
    launch on K3's (the imported tree's fp32 route: 3xTF32 since it has
    one); then two steps timed on the host clock
    around a synchronised step, the step's parts on CUDA events, and a
    profiler breakdown of one step, in which the family's kernel groups
    (TRAIN_GROUPS) hold device time and no other kernel runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import train
    from repro_torch.optim import apply_updates
    from repro_torch.utils.tree import tree_bytes, tree_size

    torch.backends.cuda.matmul.allow_tf32 = False
    phase_t0 = time.perf_counter()
    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    run = train.setup(arch, batch=b, seq=s, steps=steps, device="cuda")
    cfg = run.cfg
    frames = f" over {cfg.frontend_tokens} frames" if cfg.family == "encdec" else ""
    log(f"== train: {cfg.name} {describe(cfg)}, {cfg.num_layers} layers, fp32 params and AdamW "
        f"moments, batch {b} x seq {s}{frames}, {steps} steps through repro_torch.launch.train")
    t0 = time.perf_counter()
    state = run.make_state()
    if cfg.tie_embeddings:
        live_table(state["params"], cfg)
    torch.cuda.synchronize()
    n = tree_size(state["params"])
    log(f"   params {n} ({tree_bytes(state['params']) / 1e9:.2f} GB fp32; with both moments "
        f"{3 * tree_bytes(state['params']) / 1e9:.2f} GB) built on the card in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with kv_len_calls(K1) as kv_calls:
        state, history = train.train_loop(run, state, 0, steps, log=lambda m: log(f"   {m}"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    k1_routes = dict(K1.flash_attention.launches_by_route)
    k3_routes = dict(K3.ssd_scan.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != expected {want}")
    k1_route = K1.route(torch.float32, cfg.head_dim)
    if k1_routes != {**dict.fromkeys(K1.ROUTES, 0), k1_route: want["flash_attention"]}:
        raise AssertionError(f"K1 launches by route {k1_routes}: fp32 takes {k1_route}")
    k3_route = K3.route(torch.float32, cfg.ssm_headdim, cfg.ssm_state)
    if k3_routes != {**dict.fromkeys(K3.ROUTES, 0), k3_route: want["ssd_scan"]}:
        raise AssertionError(f"K3 launches by route {k3_routes}: fp32 takes {k3_route}")
    counts["ssd_scan_tf32x3"] = k3_routes.get("tf32x3", 0)   # the 3xTF32 route's own row
    want_kv = {}
    if cfg.family == "encdec":
        key = f"{s}x{cfg.frontend_tokens}"
        want_kv = {"flash_attention": {key: cfg.dec_layers * steps},
                   "flash_attention_bwd": {key: cfg.dec_layers * steps}}
    if {k: v for k, v in kv_calls.items() if v} != want_kv:
        raise AssertionError(f"K1 calls at S_kv != S {kv_calls}, want {want_kv}")
    loss = [float(m["loss"]) for m in history]
    gnorm = [float(m["grad_norm"]) for m in history]
    if not (all(map(math.isfinite, loss + gnorm)) and min(gnorm) > 0) or state["step"] != steps:
        raise AssertionError(f"loss {loss}, grad_norm {gnorm} (finite and > 0 wanted), "
                             f"step {state['step']}")
    log(f"   launches: {counts}; K1 by route {k1_routes}; K3 by route {k3_routes}"
        f"{f'; K1 and K1-bwd calls at S_kv != S (S x S_kv: calls) {want_kv}' if want_kv else ''}"
        f"; loss {loss}, grad_norm {gnorm}; {steps} steps in {run_s:.2f} s (the first warms "
        f"cuBLAS and the allocator); peak memory {peak / 1e9:.2f} GB")

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
    for g in KERNEL_GROUPS:
        if (g in TRAIN_GROUPS[cfg.family]) != (groups[g] > 0):
            raise AssertionError(f"profiler group {g} holds {groups[g]} ms of a train step of "
                                 f"{cfg.name}, which runs {TRAIN_GROUPS[cfg.family]}")
    log(f"   device time of a step (ms): {json.dumps(groups)}; {n_ops:.0f} device operations")
    del state, named, m
    seconds = time.perf_counter() - phase_t0
    log(f"   train {cfg.name}: {seconds:.1f} s")
    return counts, {"step_ms": step_ms, "tokens_per_s": b * s / (step_ms[1] / 1e3),
                    "parts_ms": parts, "peak_gb": peak / 1e9, "params": n, "loss": loss,
                    "grad_norm": gnorm, "device_ms": groups, "device_ops": n_ops,
                    "kv_len_calls": want_kv, "seconds": seconds}


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


# the R2D2 path: the example's reduced config for the card-vs-CPU parity,
# and the learner's batch of Kapturowski et al. 2019 at the published widths
R2D2_REDUCED = dict(obs_size=42, obs_channels=2, core_dim=128, num_actions=6, burn_in=4,
                    unroll=16, n_step=3, target_update_period=50)
R2D2_BATCH = 64
R2D2_WINDOW_S = 20.0
# sequences of 120 frames of 84 x 84 x 4 (3.39 MB each); R2D2 keeps about
# 1M transitions, 8333 such sequences, 28 GB of frames at 120 a sequence
R2D2_CAPACITY = 1024
# the V-trace path at Fig 3f's configuration (benchmarks/fig3_actor_scaling.py
# measured_vtrace_sweep): CatchEnv(10, 5), mlp_actor_critic(50, 3, hidden=64),
# 4 lanes an actor, unroll 8, learner batch 4; a longer window than its 1.2 s
VTRACE_ACTORS = (1, 2, 4)
VTRACE_WINDOW_S = 5.0
VTRACE = dict(envs_per_actor=4, unroll=8, learner_batch=4, max_param_lag=50)


def set_fp32():
    """The R2D2 path is fp32, as the reference's params are: TF32 off for
    cuBLAS's products and cuDNN's convolutions (cuDNN's default is on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_rel(name, got, want, tol=GRAD_TOL):
    """|got - want| <= tol * max |want| elementwise, finite, same shape."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = max_err(got, want) if want.numel() else 0.0
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or err > tol * scale:
        raise AssertionError(f"{name}: card vs CPU differ by {err:.3e} of max {scale:.3e}")
    return err, scale


def r2d2_parity_phase():
    """At the example's reduced config, fp32 with TF32 off: the forward's
    q-values and final LSTM state, decode_step, and make_r2d2_loss's loss,
    priorities and every gradient leaf, with and without is_weights, on the
    card against the CPU on the same params."""
    from repro_torch.configs.r2d2_atari import AtariConfig
    from repro_torch.core.losses import make_r2d2_loss, param_grads
    from repro_torch.models.atari import atari_forward, make_atari

    set_fp32()
    acfg = AtariConfig(**R2D2_REDUCED)
    bundle = make_atari(acfg)
    b, t = 4, acfg.burn_in + acfg.unroll
    log(f"== R2D2 parity: reduced config (frame {acfg.obs_size}, {acfg.obs_channels} channels, "
        f"core {acfg.core_dim}, burn {acfg.burn_in}, unroll {acfg.unroll}), card vs CPU, fp32, "
        f"TF32 {{matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}}}, batch {b} x {t}")
    nets = {}
    for dev in ("cpu", "cuda"):
        online, target = bundle.init(0, device=dev), bundle.init(1, device=dev)
        if dev == "cuda":
            online.load_state_dict(nets["cpu"][0].state_dict())
            target.load_state_dict(nets["cpu"][1].state_dict())
        nets[dev] = (online.requires_grad_(True), target)
    gen = torch.Generator().manual_seed(3)
    frame = (acfg.obs_size, acfg.obs_size, acfg.obs_channels)
    batch = {"obs": torch.randint(0, 256, (b, t) + frame, generator=gen, dtype=torch.uint8),
             "actions": torch.randint(0, acfg.num_actions, (b, t), generator=gen),
             "rewards": torch.randn(b, t, generator=gen),
             "dones": (torch.rand(b, t, generator=gen) < 0.1).float(),
             "core": tuple(0.5 * torch.randn(b, acfg.core_dim, generator=gen) for _ in range(2)),
             "is_weights": 0.2 + 0.8 * torch.rand(b, generator=gen)}

    def on(dev, x):
        return tuple(v.to(dev) for v in x) if isinstance(x, tuple) else x.to(dev)

    res = {}
    for dev, (online, target) in nets.items():
        db = {k: on(dev, v) for k, v in batch.items()}
        with torch.no_grad():
            out, (h, c) = atari_forward(acfg, online, db)
            q1, (h1, c1) = bundle.decode_step(online, db["obs"][:, 0], db["core"])
        loss_fn = make_r2d2_loss(bundle, acfg)
        r = {"forward q": out.logits, "forward h": h, "forward c": c, "decode_step q": q1,
             "decode_step h": h1, "decode_step c": c1}
        named = dict(online.named_parameters())
        for case in ("plain", "is_weights"):
            cb = db if case == "is_weights" else {k: v for k, v in db.items()
                                                  if k != "is_weights"}
            loss, m = loss_fn(online, target, cb)
            r[f"{case} loss"], r[f"{case} priorities"] = loss.detach(), m["priorities"]
            for n, g in param_grads(loss, named).items():
                r[f"{case} grad {n}"] = g
        res[dev] = r
    worst = (0.0, "")
    for name, want in res["cpu"].items():
        err, scale = check_rel(name, res["cuda"][name], want)
        if scale and err / scale > worst[0]:
            worst = (err / scale, name)
    zero = [n for n, v in res["cpu"].items() if n.startswith("is_weights grad") and v.any()]
    live = [n for n, v in res["cpu"].items() if n.startswith("plain grad") and not v.any()]
    if zero or live:
        raise AssertionError(f"gradients: with is_weights not zero {zero}; plain all-zero {live}")
    log(f"   {len(res['cpu'])} tensors within {GRAD_TOL:g} of each one's max (the worst "
        f"{worst[0]:.2e}, {worst[1]}): q {float(res['cpu']['forward q'].abs().max()):.3f}; "
        f"loss {float(res['cuda']['plain loss']):.6f} (CPU {float(res['cpu']['plain loss']):.6f}), "
        f"with is_weights {float(res['cuda']['is_weights loss']):.6f}; the weighted loss's "
        "gradient is zero on both, as the reference's is (ROADMAP section 3)")


def r2d2_breakdown(prof, n):
    """Device ms per call of an R2D2 step from a profiler trace, grouped by
    `fig2_breakdown.busy_groups_s` (cuDNN's convolutions, GEMMs, the LSTM
    gates, everything else, and "counted", the convolutions and GEMMs
    whose FLOPs FlopCounterMode counts); the port's CUDA kernels must not
    appear."""
    from repro_torch.benchmarks import fig2_breakdown as fig2

    spans = fig2.device_spans(prof, torch.device("cuda"))
    for name, _, _ in spans:
        if any(k in name.lower() for k in ("flash_", "decode_split", "decode_combine", "ssd_",
                                           "rglru_")):
            raise AssertionError(f"a port kernel ran in the R2D2 path: {name}")
    groups = {g: 1e3 * s / n for g, s in fig2.busy_groups_s(spans).items()}
    if groups["busy"] <= 0:
        raise AssertionError("the profiler recorded no device time")
    return groups, len(spans) / n


def r2d2_learner_phase():
    """The learner at the published R2D2 widths (AtariConfig(), nothing
    cut): batches of 64 sequences of 120 steps sampled from prioritized
    replay, moved to the card as the system's learner moves them, through
    the R2D2 train step (AdamW, target net); 3 warm steps, 5 timed, the
    step's parts on CUDA events, profiler breakdowns, peak memory, and the
    host's cost of sampling a batch and of its transfer."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks import fig2_breakdown as fig2
    from repro_torch.configs.r2d2_atari import AtariConfig
    from repro_torch.core.losses import (init_train_state, make_r2d2_loss, make_train_step,
                                         param_grads)
    from repro_torch.core.r2d2 import r2d2_loss
    from repro_torch.core.replay import PrioritizedReplay
    from repro_torch.launch.train_r2d2 import device_batch
    from repro_torch.models.atari import atari_forward, make_atari
    from repro_torch.optim import adamw, apply_updates
    from repro_torch.utils.tree import tree_size

    set_fp32()
    acfg = AtariConfig()
    t = acfg.burn_in + acfg.unroll
    b = R2D2_BATCH
    dev = torch.device("cuda")
    bundle = make_atari(acfg)
    opt = adamw(5e-4)
    state = init_train_state(bundle, opt, 0, dev, with_target=True)
    train_step = make_train_step(bundle, opt, algo="r2d2", acfg=acfg)
    log(f"== R2D2 learner: {acfg.name} at the published widths ({acfg.obs_size}x{acfg.obs_size}x"
        f"{acfg.obs_channels} frames, core {acfg.core_dim}, {acfg.num_actions} actions, burn-in "
        f"{acfg.burn_in}, unroll {acfg.unroll}, n-step {acfg.n_step}, gamma {acfg.gamma}), "
        f"{tree_size(state['params'])} params, fp32, AdamW; batch {b} x {t} from replay")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (t, acfg.obs_size, acfg.obs_size, acfg.obs_channels),
                           dtype=np.uint8) for _ in range(16)]
    replay = PrioritizedReplay(2 * b, alpha=acfg.priority_exponent, seed=0)
    for i in range(2 * b):
        replay.add({"obs": frames[i % 16],
                    "actions": rng.integers(0, acfg.num_actions, t).astype(np.int32),
                    "rewards": (rng.random(t) < 0.05).astype(np.float32),
                    "dones": (rng.random(t) < 0.002).astype(np.float32)},
                   priority=float(rng.uniform(0.5, 2.0)))

    def next_batch(times):
        t0 = time.perf_counter()
        batch, idx, _ = replay.sample(b)
        t1 = time.perf_counter()
        db = device_batch(batch, dev, acfg.core_dim)
        torch.cuda.synchronize()
        times["sample"].append((t1 - t0) * 1e3)
        times["transfer"].append((time.perf_counter() - t1) * 1e3)
        return db, idx

    host = {"sample": [], "transfer": []}
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(8):
        db, idx = next_batch(host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, db)
        torch.cuda.synchronize()
        if i >= 3:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        replay.update_priorities(idx, m["priorities"].cpu().numpy())
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses)) or state["step"] != 8:
        raise AssertionError(f"losses {losses}, step {state['step']}")
    mean_ms = sum(step_ms) / len(step_ms)
    log(f"   steps (host clock around a synchronised step) {', '.join(f'{x:.2f}' for x in step_ms)}"
        f" ms: mean {mean_ms:.2f} ms, {b * t / (mean_ms / 1e3):.0f} frames trained/s; losses "
        f"{[round(x, 5) for x in losses]}; peak memory {peak / 1e9:.3f} GB")
    log(f"   host, one batch of {b} x {t}: replay.sample "
        f"{', '.join(f'{x:.1f}' for x in host['sample'])} ms; transfer to the card (obs uint8, "
        f"{b * t * acfg.obs_size ** 2 * acfg.obs_channels / 1e6:.0f} MB) "
        f"{', '.join(f'{x:.1f}' for x in host['transfer'])} ms")

    # the step's parts, called as the train step calls them, CUDA events
    # between: each part's share of the step's device timeline
    db, _ = next_batch(host)
    params, target = state["params"], state["target"]
    named = dict(params.named_parameters())
    burn = acfg.burn_in
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    ev[0].record()
    out, _ = atari_forward(acfg, params, db)
    ev[1].record()
    with torch.no_grad():
        tout, _ = atari_forward(acfg, target, db)
    ev[2].record()
    res = r2d2_loss(None, out.logits[:, burn:], tout.logits[:, burn:], db["actions"][:, burn:],
                    db["rewards"][:, burn:], db["dones"][:, burn:], n_step=acfg.n_step,
                    gamma=acfg.gamma, priority_exponent=acfg.priority_exponent)
    ev[3].record()
    grads = param_grads(res.loss, named)
    ev[4].record()
    updates, state["opt_state"], _ = opt.update(grads, state["opt_state"], named, state["step"])
    apply_updates(named, updates)
    ev[5].record()
    torch.cuda.synchronize()
    state["step"] += 1
    parts = {p: ev[i].elapsed_time(ev[i + 1]) for i, p in enumerate(
        ("online_forward", "target_forward", "loss", "backward", "optimizer"))}
    total = sum(parts.values())
    log("   parts (CUDA events) " + ", ".join(f"{p} {v:.2f} ms ({v / total:.3f})"
                                              for p, v in parts.items()))
    del out, tout, res, grads, updates

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = train_step(state, db)
        torch.cuda.synchronize()
    groups, n_ops = r2d2_breakdown(prof, 1)
    loss_fn = make_r2d2_loss(bundle, acfg)
    loss, _ = loss_fn(params, target, db)
    grads = param_grads(loss, named)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        updates, state["opt_state"], _ = opt.update(grads, state["opt_state"], named,
                                                    state["step"])
        apply_updates(named, updates)
        torch.cuda.synchronize()
    state["step"] += 1
    adamw_ms, adamw_ops = r2d2_breakdown(prof, 1)
    idle = 1.0 - groups["busy"] / mean_ms
    log(f"   device time of a step (ms): {json.dumps(groups)}; {n_ops:.0f} device operations; "
        f"idle share {idle:.3f} of the mean step; AdamW alone {adamw_ms['busy']:.2f} ms in "
        f"{adamw_ops:.0f} operations")
    del grads, updates, loss
    # the FLOPs of one step as FlopCounterMode counts them (Fig 2's card row)
    flops, state = fig2.step_flops(train_step, state, db)
    log(f"   FlopCounterMode over one step: {flops:.4e} FLOPs (matmuls and convolutions)")
    return {"flops": flops, "step_ms": step_ms, "mean_step_ms": mean_ms,
            "frames_trained_per_s": b * t / (mean_ms / 1e3), "parts_ms": parts,
            "device_ms": groups, "device_ops": n_ops, "idle_share": idle,
            "adamw_ms": adamw_ms["busy"], "adamw_ops": adamw_ops, "peak_gb": peak / 1e9,
            "sample_ms": host["sample"], "transfer_ms": host["transfer"], "losses": losses}


def r2d2_system_phase():
    """The SEED R2D2 system at the published widths through
    ``repro_torch.launch.train_r2d2.build``: host backend, in-process
    transport, ALESimEnv(frame=84, channels=4) at its defaults, N actors x E
    lanes from the host's core count, the learner at batch 64; a window of
    R2D2_WINDOW_S seconds after warm-up."""
    import os

    from repro_torch.configs.r2d2_atari import AtariConfig
    from repro_torch.envs.alesim import ALESimEnv
    from repro_torch.launch.train_r2d2 import build

    acfg = AtariConfig()
    cpus = os.cpu_count()
    actors, lanes = max(2, cpus // 2), 8
    run = build(acfg, actors=actors, envs_per_actor=lanes, device="cuda",
                env_factory=functools.partial(ALESimEnv, frame=84, channels=4),
                learner_batch=R2D2_BATCH,
                replay_capacity=R2D2_CAPACITY)
    system = run.system
    log(f"== R2D2 system: SeedSystem host/inproc, {acfg.name} at the published widths, "
        f"os.cpu_count() {cpus}: {actors} actors x {lanes} lanes of ALESimEnv(frame=84, "
        f"channels=4), learner batch {R2D2_BATCH} x {acfg.burn_in + acfg.unroll}, replay "
        f"capacity {R2D2_CAPACITY} sequences (cut: R2D2 keeps about 1M transitions), "
        f"{R2D2_WINDOW_S:.0f} s window; TF32 {run.tf32}")
    system.warmup()
    stats = system.run(seconds=R2D2_WINDOW_S)
    learner = system.learner
    keys = ("env_frames_per_s", "env_frames", "actor_iterations", "learner_steps",
            "learner_steps_per_s", "mean_batch_occupancy", "mean_queue_wait_ms",
            "inference_batches", "inference_compute_s", "mean_param_lag", "unroll_flushes")
    out = {k: stats[k] for k in keys}
    out.update(learner_train_s=learner.train_time_s, learner_wait_s=learner.wait_time_s,
               replay_size=len(system.replay), actors=actors, lanes=lanes, cpus=cpus)
    log(f"   {json.dumps(out)}")
    if stats["env_frames"] != stats["actor_iterations"] * lanes:
        raise AssertionError(f"env_frames {stats['env_frames']} != actor_iterations "
                             f"{stats['actor_iterations']} x {lanes}")
    if stats["learner_steps"] <= 0:
        raise AssertionError("the learner took no step")
    if stats["learner_error"] or stats["inference_error"]:
        raise AssertionError(f"learner error {stats['learner_error']}; inference error "
                             f"{stats['inference_error']}")
    tensors = [*learner.state["params"].parameters(), *learner.state["target"].parameters(),
               *run.published.params.parameters(), *run.core.values()]
    if not all(x.is_cuda for x in tensors):
        raise AssertionError("a parameter or the slot state is not on the card")
    return out


def vtrace_parity_phase():
    """Fig 3f's model (mlp_actor_critic(50, 3, hidden=64)) from seeded
    params, fp32 with TF32 off, card against CPU: logits and values
    (within 1e-5 of max), one V-trace train step's loss, metrics and every
    updated leaf (GRAD_TOL), the sampling policy's logprob at its action
    against the CPU's log_softmax (1e-6), the behavior and target logprobs
    of one set of obs on the card (mean_rho's ratio at lag 0), and Catch's
    step on every live state and action, exactly."""
    import numpy as np

    from repro_torch.envs.catch import CatchEnv, CatchState
    from repro_torch.onpolicy import (SamplingPolicy, assemble_vtrace_batch,
                                      make_vtrace_train_step, mlp_actor_critic)
    from repro_torch.optim import adamw

    set_fp32()
    b, t = VTRACE["learner_batch"], VTRACE["unroll"]
    env = {dev: CatchEnv(device=dev) for dev in ("cpu", "cuda")}
    obs_dim = env["cpu"].obs_shape[0]
    init_fn, apply_fn = mlp_actor_critic(obs_dim, CatchEnv.num_actions)
    log(f"== V-trace parity: mlp_actor_critic({obs_dim}, 3, hidden=64), card vs CPU, fp32, "
        f"TF32 {torch.backends.cuda.matmul.allow_tf32}, batch {b} x {t}")
    rng = np.random.default_rng(0)
    unrolls = [{"obs": rng.standard_normal((t, obs_dim)).astype(np.float32),
                "actions": rng.integers(0, 3, t).astype(np.int32),
                "rewards": rng.choice([-1.0, 0.0, 0.0, 1.0], t).astype(np.float32),
                "dones": (rng.random(t) < 0.15).astype(np.float32),
                "behavior_logprobs": (np.log(1 / 3) + 0.3 * rng.standard_normal(t)
                                      ).astype(np.float32),
                "param_version": np.int64(i)} for i in range(b)]
    batch = assemble_vtrace_batch(unrolls, gamma=0.99)
    opt = adamw(1e-3)
    step = make_vtrace_train_step(apply_fn, opt)
    res, stepped = {}, {}
    for dev in ("cpu", "cuda"):
        params = init_fn(torch.Generator().manual_seed(0), dev)
        with torch.no_grad():
            logits, values = apply_fn(params, torch.from_numpy(batch["obs"]).to(dev))
        state, m = step({"params": params, "opt_state": opt.init(params), "step": 0}, batch)
        res[dev] = {"logits": logits, "values": values,
                    **{f"metric {k}": v for k, v in m.items()},
                    **{f"param {k}": v for k, v in state["params"].items()}}
        stepped[dev] = state["params"]
    worst = (0.0, "")
    for name, want in res["cpu"].items():
        tol = 1e-5 if name in ("logits", "values") else GRAD_TOL
        err, scale = check_rel(name, res["cuda"][name], want, tol)
        if scale and err / scale > worst[0]:
            worst = (err / scale, name)
    # the policy on the card from the CPU's stepped params, against the CPU
    obs = rng.standard_normal((b * t, obs_dim)).astype(np.float32)
    policy = SamplingPolicy(apply_fn, stepped["cpu"], seed=0, device="cuda")
    out = policy(obs, None)
    actions = torch.from_numpy(out[:, 0].astype(np.int64))
    with torch.no_grad():
        lp = torch.log_softmax(apply_fn(stepped["cpu"], torch.from_numpy(obs))[0], -1)
        want = torch.gather(lp, -1, actions[:, None])[:, 0]
        # lag 0: the learner's (B, T) forward on the card of the same obs
        target = torch.log_softmax(apply_fn(policy._params, torch.from_numpy(obs).cuda()
                                            .reshape(b, t, obs_dim))[0], -1)
        target = torch.gather(target.reshape(b * t, -1), -1, actions.cuda()[:, None])[:, 0]
    lp_err = float((torch.from_numpy(out[:, 1]) - want).abs().max())
    rho_err = float((target.cpu() - torch.from_numpy(out[:, 1])).abs().max())
    if lp_err > 1e-6 or rho_err > 1e-6:
        raise AssertionError(f"sampling logprob: {lp_err:.3e} from the CPU's, {rho_err:.3e} "
                             "from the learner's forward on the card")
    # Catch: every live state with every action, card against CPU
    rows, cols = env["cpu"].rows, env["cpu"].cols
    grid = torch.tensor([(r, c, q, a) for r in range(rows - 1) for c in range(cols)
                         for q in range(cols) for a in range(3)]).T
    stepped_env = {}
    for dev, e in env.items():
        st = CatchState(*(x.to(dev) for x in grid[:3]))
        new, o, r, d = e.step(st, grid[3].to(dev), torch.Generator(device=dev).manual_seed(0))
        stepped_env[dev] = [x.cpu() for x in (*new, o, r, d)]
    (nb, nc, npd, o, r, d), (gb, gc, gpd, go, gr, gd) = stepped_env["cpu"], stepped_env["cuda"]
    live = ~d
    if not (torch.equal(r, gr) and torch.equal(d, gd) and torch.equal(o[live], go[live])
            and torch.equal(nb, gb) and torch.equal(nc[live], gc[live])
            and torch.equal(npd[live], gpd[live]) and bool((gb[gd] == 0).all())
            and bool(((gc >= 0) & (gc < cols) & (gpd >= 0) & (gpd < cols)).all())):
        raise AssertionError("Catch's step on the card differs from the CPU's")
    log(f"   {len(res['cpu'])} tensors within tolerance (logits and values 1e-5, the step "
        f"{GRAD_TOL:g}; the worst {worst[0]:.2e}, {worst[1]}): loss "
        f"{float(res['cuda']['metric loss']):.7f} (CPU {float(res['cpu']['metric loss']):.7f}), "
        f"mean_rho {float(res['cuda']['metric mean_rho']):.7f}; sampling logprob {lp_err:.2e} "
        f"from the CPU's, {rho_err:.2e} from the learner's forward; Catch {grid.shape[1]} "
        f"states x actions equal ({int(d.sum())} ending)")
    return {"worst_rel": worst[0], "worst": worst[1], "sampling_lp_err": lp_err,
            "behavior_target_lp_err": rho_err}


def vtrace_system_phase():
    """Fig 3f on the card through ``repro_torch.launch.train_vtrace``: for
    each actor count a SeedSystem (host backend, in-process transport,
    algo="vtrace") built from the same seeded params, VTRACE_WINDOW_S
    seconds after warm-up, its Fig-3f row and what explains it; then the
    train step alone at the learner's batch, on CUDA events and under the
    profiler, and an actor iteration's two parts alone (the policy call
    and a Catch vector step, each ending in its copy to the host)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.envs.catch import CatchEnv
    from repro_torch.envs.vector import make_vector_env
    from repro_torch.launch.train_vtrace import build, fig3f_row, run_point
    from repro_torch.onpolicy import assemble_vtrace_batch

    log(f"== V-trace system (Fig 3f): SeedSystem host/inproc algo=vtrace, CatchEnv(10, 5) on the "
        f"card, mlp_actor_critic(50, 3, hidden=64), actors {VTRACE_ACTORS} x "
        f"{VTRACE['envs_per_actor']} lanes, unroll {VTRACE['unroll']}, learner batch "
        f"{VTRACE['learner_batch']}, max_param_lag {VTRACE['max_param_lag']}, queue 64 unrolls, "
        f"{VTRACE_WINDOW_S:.0f} s a point")
    rows = []
    for n in VTRACE_ACTORS:
        run, stats = run_point(n, VTRACE_WINDOW_S, device="cuda", **VTRACE)
        system, onp = run.system, stats["onpolicy"]
        row = fig3f_row(n, stats)
        row.update({k: stats[k] for k in ("env_frames", "actor_iterations", "unroll_flushes",
                                          "mean_batch_occupancy", "mean_queue_wait_ms",
                                          "inference_batches", "inference_compute_s")})
        row.update({k: onp[k] for k in ("frames_generated", "frames_trained", "frames_dropped",
                                        "frames_dropped_stale", "frames_dropped_overflow",
                                        "frames_dropped_shutdown")})
        row.update(learner_train_s=system.learner.train_time_s,
                   learner_wait_s=system.learner.wait_time_s, elapsed_s=stats["elapsed_s"],
                   tf32=run.tf32)
        log(f"   {json.dumps(row)}")
        if stats["env_frames"] != stats["actor_iterations"] * VTRACE["envs_per_actor"]:
            raise AssertionError(f"env_frames {stats['env_frames']} != actor_iterations "
                                 f"{stats['actor_iterations']} x {VTRACE['envs_per_actor']}")
        if onp["frames_trained"] <= 0:
            raise AssertionError(f"no frame trained: {onp}")
        state = system.learner.state
        tensors = [*state["params"].values(), *state["opt_state"]["m"].values(),
                   *state["opt_state"]["v"].values(), *run.policy._params.values(),
                   *(x for a in system.actors for x in a.vec._state)]
        if not all(x.is_cuda for x in tensors):
            raise AssertionError("a param, an AdamW moment, the policy's copy or an env's "
                                 "state is not on the card")
        rows.append(row)

    # the train step alone at the learner's batch, on a batch of real
    # shapes; warm first
    run = build(1, device="cuda", **VTRACE)
    b, t = VTRACE["learner_batch"], VTRACE["unroll"]
    rng = np.random.default_rng(0)
    unrolls = [{"obs": (rng.random((t, 50)) < 0.04).astype(np.float32),
                "actions": rng.integers(0, 3, t).astype(np.int32),
                "rewards": np.zeros(t, np.float32), "dones": np.zeros(t, np.float32),
                "behavior_logprobs": np.full(t, np.log(1 / 3), np.float32)} for _ in range(b)]
    batch = assemble_vtrace_batch(unrolls, gamma=0.99)
    state, step = run.system.learner.state, run.learner.train_step
    for _ in range(5):
        state, _ = step(state, batch)
    n = 50
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    for _ in range(n):
        state, m = step(state, batch)
    ev[1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    event_ms = ev[0].elapsed_time(ev[1]) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / n
    groups, n_ops = device_breakdown(prof, n)
    if any(groups[k] for k in ("K1", "K1-bwd", "K2", "K3", "K4", "K4-bwd")):
        raise AssertionError(f"a port kernel ran in the V-trace step: {groups}")
    if not math.isfinite(float(m["loss"])):
        raise AssertionError(f"train step loss {float(m['loss'])}")
    step_metrics = {"batch": [b, t], "event_ms": event_ms, "host_ms": host_ms,
                    "profiled_ms": prof_ms, "device_busy_ms": groups["busy"],
                    "gemm_ms": groups["gemm"], "other_ms": groups["other"],
                    "device_ops": n_ops, "idle_share": 1.0 - groups["busy"] / prof_ms}
    log(f"   train step alone, batch {b} x {t}, {n} steps: {event_ms:.3f} ms a step on CUDA "
        f"events ({host_ms:.3f} on the host clock); under the profiler {prof_ms:.3f} ms, device "
        f"busy {groups['busy']:.4f} ms in {n_ops:.0f} operations (GEMMs {groups['gemm']:.4f}), "
        f"idle share {step_metrics['idle_share']:.3f}")
    # an actor iteration's two parts alone, each ending in its copy to the
    # host: the policy call at one actor's lanes and one Catch vector step
    lanes = VTRACE["envs_per_actor"]
    vec = make_vector_env(lambda: CatchEnv(device="cuda"), lanes, seed=0)
    obs = vec.reset()
    zeros = np.zeros(lanes, np.int32)
    for name, fn in (("policy_call_ms", lambda: run.policy(obs, None)),
                     ("catch_step_ms", lambda: vec.step(zeros))):
        for _ in range(10):
            fn()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        step_metrics[name] = (time.perf_counter() - t0) * 1e3 / 200
    log(f"   alone, host clock: the policy call at {lanes} lanes "
        f"{step_metrics['policy_call_ms']:.3f} ms, a Catch vector step of {lanes} lanes "
        f"{step_metrics['catch_step_ms']:.3f} ms")
    return {"rows": rows, "train_step": step_metrics}


# the device backend (phases 15-16): unroll 16 (launch/rollout_backends.py's
# three design points), the parity lanes, the cost sweep's lanes, and the
# device half of examples/quickstart.py's onpolicy_demo (max_param_lag 10)
DEVICE_T = 16
DEVICE_PARITY_LANES = (8, 4096)
DEVICE_SWEEP_LANES = (8, 64, 512, 4096)
DEVICE_WINDOW_S = 5.0
DEVICE_SWEEP_WINDOW_S = 2.0
DEVICE_VTRACE = dict(envs_per_actor=4, unroll=8, learner_batch=4, max_param_lag=10)


def device_parity_envs():
    """The three batched envs on the card, each with a sampling policy
    (mlp_actor_critic at hidden 64 from a seed; TokenWorld's token one-hot
    into it) and its params."""
    import torch.nn.functional as F

    from repro_torch.envs.cartpole import CartPoleEnv
    from repro_torch.envs.catch import CatchEnv
    from repro_torch.envs.tokenworld import TokenWorld
    from repro_torch.onpolicy import make_device_sampling_policy, mlp_actor_critic

    out = {}
    for name, env in (("catch", CatchEnv(device="cuda")), ("cartpole", CartPoleEnv(device="cuda")),
                      ("tokenworld", TokenWorld(device="cuda"))):
        token = name == "tokenworld"
        init_fn, apply_fn = mlp_actor_critic(env.vocab_size if token else env.obs_shape[0],
                                             env.num_actions)
        if token:
            apply_fn = (lambda f, v: lambda p, o: f(p, F.one_hot(o, v).to(torch.float32)))(
                apply_fn, env.vocab_size)
        params = init_fn(torch.Generator().manual_seed(0), "cuda")
        out[name] = (env, apply_fn, make_device_sampling_policy(apply_fn), params)
    return out


def host_rollout(env, policy, params, lanes, steps, seed):
    """The device engine's oracle: env and policy stepped one call at a time
    on the card, from generators seeded as the engine seeds its own (the env
    stream as TorchVectorEnv's, the action stream `action_generator`'s)."""
    from repro_torch.rollout import action_generator

    gen = torch.Generator(device=env.device).manual_seed(seed)
    act = action_generator(seed, env.device)
    state, obs = env.reset(lanes, gen)
    out = {k: [] for k in ("obs", "actions", "rewards", "dones", "behavior_logprobs")}
    with torch.no_grad():
        for _ in range(steps):
            actions, lp, _ = policy(params, None, obs, act)
            out["obs"].append(obs)
            out["actions"].append(actions)
            out["behavior_logprobs"].append(lp)
            state, obs, reward, done = env.step(state, actions, gen)
            out["rewards"].append(reward)
            out["dones"].append(done)
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}


def device_parity_phase():
    """The device backend's engine on the card, fp32 with TF32 off: for
    CatchEnv(10, 5), CartPole and TokenWorld at E 8 and 4096, T 16, the
    graph-replayed engine (after `warmup`) over two back-to-back rollouts
    against `host_rollout` from the seed over 2T steps: actions, dones and
    Catch's and TokenWorld's obs exactly, rewards, CartPole's obs and the
    behavior logprobs within 1e-6; the logprobs also against log_softmax
    of the policy's logits at the recorded obs and actions; the two
    replays' actions differ; one capture an engine; a changed param is
    seen by the next replay."""
    import numpy as np

    from repro_torch.rollout import DeviceRolloutEngine

    set_fp32()
    T = DEVICE_T
    log(f"== device backend parity: graph-replayed engine vs a step-by-step loop on the card, "
        f"T {T}, E {DEVICE_PARITY_LANES}, 2 rollouts, fp32, TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    out = {}
    for name, (env, apply_fn, policy, params) in device_parity_envs().items():
        for lanes in DEVICE_PARITY_LANES:
            seed = lanes + 7
            eng = DeviceRolloutEngine(env, policy, lanes, T, seed=seed, with_logprobs=True)
            eng.warmup(params)
            got = [eng.rollout(params) for _ in range(2)]
            graph = {k: np.concatenate([g[k] for g in got]) for k in got[0]}
            ref = host_rollout(env, policy, params, lanes, 2 * T, seed)
            errs = {}
            for k, want in ref.items():
                have = graph[k]
                if have.shape != want.shape:
                    raise AssertionError(f"{name} E {lanes} {k}: shape {have.shape} != "
                                         f"{want.shape}")
                errs[k] = float(np.abs(have.astype(np.float64) - want.astype(np.float64)).max())
                exact = k in ("actions", "dones") or (k == "obs" and name != "cartpole")
                if errs[k] > (0.0 if exact else 1e-6):
                    raise AssertionError(f"{name} E {lanes}: {k} differs from the step-by-step "
                                         f"loop by {errs[k]:.3e}")
            with torch.no_grad():
                obs = torch.from_numpy(graph["obs"]).cuda()
                lp = torch.log_softmax(apply_fn(params, obs)[0], -1)
                lp = torch.gather(lp, -1, torch.from_numpy(graph["actions"]).long().cuda()[..., None])
            errs["logprob_vs_log_softmax"] = float(
                (lp[..., 0].cpu() - torch.from_numpy(graph["behavior_logprobs"])).abs().max())
            if errs["logprob_vs_log_softmax"] > 1e-6:
                raise AssertionError(f"{name} E {lanes}: behavior logprobs "
                                     f"{errs['logprob_vs_log_softmax']:.3e} from log_softmax")
            differ = float((got[0]["actions"] != got[1]["actions"]).mean())
            if differ == 0.0:
                raise AssertionError(f"{name} E {lanes}: two replays drew the same actions")
            # a changed param reaches the next replay: action 0 everywhere
            pinned = {k: v.detach().clone() for k, v in params.items()}
            pinned["bp"][0] += 1e3
            seen = eng.rollout(pinned)
            if not (seen["actions"] == 0).all() or eng.captures != 1:
                raise AssertionError(f"{name} E {lanes}: the changed param was not seen "
                                     f"(actions {np.unique(seen['actions'])}, captures "
                                     f"{eng.captures})")
            out[f"{name}_E{lanes}"] = {**errs, "actions_differing": differ,
                                       "captures": eng.captures, "dones": int(graph["dones"].sum())}
            log(f"   {name} E {lanes}: {2 * T} steps equal ({int(graph['dones'].sum())} episode "
                f"ends; rewards {errs['rewards']:.1e}, obs {errs['obs']:.1e}, logprobs "
                f"{errs['behavior_logprobs']:.1e}, {errs['logprob_vs_log_softmax']:.1e} from "
                f"log_softmax); replays differ on {differ:.3f} of the actions; 1 capture; a "
                f"changed param seen")
            del eng
    torch.cuda.empty_cache()
    return out


def device_system_phase():
    """The device backend through the entry points, DEVICE_WINDOW_S a point:
    launch/rollout_backends.py's three design points and its engine shards
    (frames/s, scans, the frame counts), the device-resident >= vectorized
    host line (printed, not asserted); V-trace through
    `train_vtrace.build(..., backend="device")` at 1, 2 and 4 actors (Fig
    3f's row, learner train against wait seconds, drops by cause; the
    ledger conserved and settled, trained > 0, every param, the engines'
    param copies and the env state on the card); then
    `fig3_actor_scaling.measure_t_dev`'s sweep, one engine alone on
    CatchEnv(10, 5) at E DEVICE_SWEEP_LANES: ms a replay on CUDA events
    behind a sleeping kernel, and beside it the host ms of the copy back
    and of the flush apart, the device operations a replay under the
    profiler and the idle share of a replay (busy time over its CUDA-event
    time), one RolloutWorker's env frames/s at that E (no learner), and
    t_dev0 and t_dev1 fitted by least squares (seconds a scan step and a lane a scan step, and in
    units of t_env, the median of five trials of a Catch vector step at 1
    lane alone)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks import fig3_actor_scaling as fig3
    from repro_torch.core.actor import account_episode_ends, flush_lane_unrolls
    from repro_torch.core.system import SeedSystem
    from repro_torch.envs.catch import CatchEnv
    from repro_torch.launch import rollout_backends, train_vtrace

    set_fp32()
    out = {"points": {}, "shards": {}, "vtrace": [], "sweep": {}}
    log(f"== device backend system: launch/rollout_backends.py's points, CatchEnv(10, 5) on the "
        f"card, 2 actors, uniform random policy, {DEVICE_WINDOW_S:.0f} s a point")
    for name, backend, lanes in rollout_backends.POINTS:
        system, stats = rollout_backends.run_point(backend, lanes, unroll=DEVICE_T,
                                                   seconds=DEVICE_WINDOW_S, device="cuda")
        row = {k: stats.get(k) for k in ("env_frames_per_s", "env_frames", "actor_iterations",
                                         "scans", "mean_batch_occupancy", "mean_queue_wait_ms",
                                         "inference_compute_s")}
        if backend == "device":
            row["captures"] = [a.engine.captures for a in system.actors]
            if row["captures"] != [1] * len(system.actors):
                raise AssertionError(f"{name}: captures {row['captures']}, not one an engine")
        out["points"][name] = row
        log(f"   fig3d {name} (E {lanes}): {json.dumps(row)}")
    for k in rollout_backends.SHARDS:
        system, stats = rollout_backends.run_point("device", 8, unroll=8, engine_shards=k,
                                                   seconds=DEVICE_WINDOW_S, device="cuda")
        captures = [a.engine.captures for a in system.actors]
        if captures != [k] * len(system.actors):
            raise AssertionError(f"engine_shards {k}: captures {captures}, not one an engine")
        row = {"env_frames_per_s": stats["env_frames_per_s"], "scans": stats["scans"],
               "env_frames": stats["env_frames"], "inference_compute_s":
               stats["inference_compute_s"], "captures": captures}
        out["shards"][k] = row
        log(f"   fig3e engine_shards {k}: {json.dumps(row)} (env_frames == scans x 8 x 8)")
    p = out["points"]
    held = p["device_resident"]["env_frames_per_s"] >= p["vectorized_host"]["env_frames_per_s"]
    out["device_ge_vectorized"] = held
    log(f"   device_resident >= vectorized_host: {held} "
        f"({p['device_resident']['env_frames_per_s']:.1f} vs "
        f"{p['vectorized_host']['env_frames_per_s']:.1f} env frames/s)")

    log(f"== device backend V-trace: train_vtrace.build(backend='device'), actors {VTRACE_ACTORS} "
        f"x {DEVICE_VTRACE['envs_per_actor']} lanes, unroll {DEVICE_VTRACE['unroll']}, learner "
        f"batch {DEVICE_VTRACE['learner_batch']}, max_param_lag {DEVICE_VTRACE['max_param_lag']}, "
        f"{DEVICE_WINDOW_S:.0f} s a point")
    for n in VTRACE_ACTORS:
        run, stats = train_vtrace.run_point(n, DEVICE_WINDOW_S, device="cuda", backend="device",
                                            **DEVICE_VTRACE)
        system, onp = run.system, stats["onpolicy"]
        row = train_vtrace.fig3f_row(n, stats)
        row.update({k: stats[k] for k in ("env_frames", "scans", "param_refreshes")})
        row.update({k: onp[k] for k in ("frames_generated", "frames_trained", "frames_dropped",
                                        "frames_dropped_stale", "frames_dropped_overflow",
                                        "frames_dropped_shutdown")})
        row.update(learner_train_s=system.learner.train_time_s,
                   learner_wait_s=system.learner.wait_time_s, elapsed_s=stats["elapsed_s"],
                   captures=[a.engine.captures for a in system.actors], tf32=run.tf32)
        log(f"   {json.dumps(row)}")
        if stats["env_frames"] != stats["scans"] * DEVICE_VTRACE["unroll"] * \
                DEVICE_VTRACE["envs_per_actor"] or onp["frames_trained"] <= 0:
            raise AssertionError(f"frames {stats['env_frames']} != scans {stats['scans']} x "
                                 f"T x E, or none trained: {onp}")
        if row["captures"] != [1] * n:
            raise AssertionError(f"captures {row['captures']}, not one an engine")
        state = system.learner.state
        tensors = [*state["params"].values(), *state["opt_state"]["m"].values(),
                   *(x for a in system.actors for x in a.engine._params.values()),
                   *(x for a in system.actors for x in a.engine._carry[0])]
        if not all(x.is_cuda for x in tensors):
            raise AssertionError("a param, an AdamW moment, an engine's param copy or an env's "
                                 "state is not on the card")
        out["vtrace"].append(row)

    log(f"== device backend cost: one engine, CatchEnv(10, 5), uniform random policy, T "
        f"{DEVICE_T}, E {DEVICE_SWEEP_LANES}")
    n = 50

    def more_columns(lanes, eng):
        """Beside fig3.measure_t_dev's replay time: the copy back, the flush,
        a profiled replay and one RolloutWorker over the same lanes."""
        flat = eng.dispatch(None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            traj = eng.to_host(flat)
        copy_ms = (time.perf_counter() - t0) * 1e3 / n
        sunk, returns = [], []
        ep = np.zeros(lanes)
        t0 = time.perf_counter()
        for _ in range(n):
            for t in range(DEVICE_T):
                account_episode_ends(traj["rewards"][t], traj["dones"][t], ep, returns)
            flush_lane_unrolls(traj, sunk.append)
        flush_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                eng.dispatch(None)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3 / n
        groups, n_ops = device_breakdown(prof, n)
        if eng.captures != 1 or len(sunk) != n * lanes:
            raise AssertionError(f"E {lanes}: captures {eng.captures}, records {len(sunk)}")
        # the same engine's lanes behind one RolloutWorker thread, no learner
        system = SeedSystem(env_factory=lambda: CatchEnv(device="cuda"), backend="device",
                            policy_apply=policy, num_actors=1, unroll=DEVICE_T,
                            envs_per_actor=lanes)
        system.warmup()
        stats = system.run(seconds=DEVICE_SWEEP_WINDOW_S, with_learner=False)
        if stats["inference_error"] or stats["env_frames"] != stats["scans"] * DEVICE_T * lanes:
            raise AssertionError(f"E {lanes} worker: {stats['inference_error']}, frames "
                                 f"{stats['env_frames']}, scans {stats['scans']}")
        return {"copy_back_ms": copy_ms, "flush_ms": flush_ms, "profiled_replay_ms": prof_ms,
                "device_busy_ms": groups["busy"], "device_ops": n_ops,
                "idle_share_profiled_wall": 1.0 - groups["busy"] / prof_ms,
                "trajectory_bytes": int(flat.numel()),
                "frames_per_s_worker": stats["env_frames_per_s"], "worker_scans": stats["scans"]}

    policy = rollout_backends.device_policy(CatchEnv.num_actions)
    fit = fig3.measure_t_dev("cuda", lanes=DEVICE_SWEEP_LANES, unroll=DEVICE_T, iters=n,
                             each=more_columns)
    for lanes, row in fit.pop("sweep").items():
        replay_ms = row["replay_ms"]
        row.update(idle_share=1.0 - row["device_busy_ms"] / replay_ms,
                   frames_per_s_replay=DEVICE_T * lanes / (replay_ms / 1e3),
                   frames_per_s_parts=DEVICE_T * lanes
                   / ((replay_ms + row["copy_back_ms"] + row["flush_ms"]) / 1e3))
        out["sweep"][lanes] = row
        log(f"   E {lanes}: replay {replay_ms:.4f} ms (CUDA events behind a sleeping kernel"
            f"{', host-limited' if row['host_limited'] else ''}), copy back "
            f"{row['copy_back_ms']:.4f} ms ({row['trajectory_bytes']} bytes), flush "
            f"{row['flush_ms']:.4f} ms (host clock); under the profiler device busy "
            f"{row['device_busy_ms']:.4f} ms in {row['device_ops']:.1f} operations a replay, idle "
            f"{row['idle_share']:.3f} of its CUDA-event time ({row['profiled_replay_ms']:.4f} ms "
            f"a replay on the host clock there, idle {row['idle_share_profiled_wall']:.3f} of "
            f"it); one worker {row['frames_per_s_worker']:.1f} env frames/s "
            f"({row['frames_per_s_parts']:.1f} from the parts)")
    out["fit"] = fit
    t_dev0, t_dev1, t_env = fit["t_dev0_s"], fit["t_dev1_s"], fit["t_env_s"]
    log(f"   fit of ms a replay / T = t_dev0 + t_dev1 * E (fig3.measure_t_dev): t_dev0 "
        f"{t_dev0:.4e} s, t_dev1 {t_dev1:.4e} s a lane; t_env (a Catch vector step at 1 lane "
        f"alone, host clock, the median of {len(fit['t_env_trials_s'])} trials "
        f"{', '.join(f'{x:.4e}' for x in fit['t_env_trials_s'])} s) {t_env:.4e} s, so t_dev0 "
        f"{t_dev0 / t_env:.4f} and t_dev1 {t_dev1 / t_env:.3e} t_env "
        f"(SystemModel.with_device's guessed defaults: 0.05 and 0.002)")
    return out


# the wire (phase 17): actors in spawned actor-host processes behind
# InferenceGateways, the learner and the server on the card. R2D2 at the
# system phase's 4 actors x 8 lanes, one actor a host; V-trace at Fig 3f's
# configuration over shm, one actor a host, Catch on each child's CPU
WIRE_R2D2 = (("inproc", 1), ("socket", 4), ("shm", 4))
WIRE_R2D2_ACTORS, WIRE_R2D2_LANES = 4, 8
WIRE_R2D2_WINDOW_S = 12.0
WIRE_VTRACE_HOSTS = (1, 2, 4)
WIRE_VTRACE_WINDOW_S = 5.0


def compute_pids():
    """PIDs of the processes holding a CUDA context on the card, one entry
    a process, as nvidia-smi lists them (its PID namespace may not be this
    one's)."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [int(x) for x in res.stdout.split()]


def shm_room():
    """/dev/shm's `df -h` line and its free bytes."""
    import shutil
    df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True, text=True, timeout=60)
    return df.stdout.strip().splitlines()[-1], shutil.disk_usage("/dev/shm").free


def shm_geometry(conns, free):
    """The rings' (slot_size, num_slots), or None for the module defaults
    (2 rings of 64 x 1 MiB a connection) when /dev/shm holds twice what
    `conns` connections map; else 16 slots, halving the slot (down to
    256 KiB) until they fit (a tmpfs faults past its size with SIGBUS)."""
    from repro_torch.transport.shm import DEFAULT_NUM_SLOTS, DEFAULT_SLOT_SIZE

    def need(slot, n):
        return conns * 2 * n * (slot + 16)

    if need(DEFAULT_SLOT_SIZE, DEFAULT_NUM_SLOTS) * 2 <= free:
        return None
    slot, n = DEFAULT_SLOT_SIZE, 16
    while need(slot, n) * 2 > free and slot > 1 << 18:
        slot //= 2
    if need(slot, n) * 2 > free:
        raise AssertionError(f"/dev/shm has {free} bytes free: too little for {conns} ring pairs")
    return slot, n


def watch_hosts(system):
    """Record each actor host's PID as the pool spawns it, and sample
    nvidia-smi's compute processes once a second while the run lasts.
    Returns (host pids, listed: {"pids": every PID listed, "entries": the
    most processes one sample listed}, stop)."""
    import threading

    pids, listed, done = [], {"pids": set(), "entries": 0}, threading.Event()
    prev = system.pool.pid_callback          # the telemetry sampler's, if any

    def note(name, pid):
        pids.append(pid)
        if prev is not None:
            prev(name, pid)

    system.pool.pid_callback = note

    def sample():
        while not done.wait(1.0):
            apps = compute_pids()
            listed["pids"].update(apps)
            listed["entries"] = max(listed["entries"], len(apps))

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()

    def stop():
        done.set()
        thread.join()

    return pids, listed, stop


def check_wire(stats, lanes, hosts, transport, pids, listed):
    """The conditions every wire point holds; returns the host-side
    summary logged beside its numbers."""
    import os

    if stats.get("host_errors"):
        raise AssertionError(f"actor hosts failed: {stats['host_errors']}")
    if stats["learner_steps"] <= 0:
        raise AssertionError(f"{transport}: the learner took no step")
    if stats["learner_error"] or stats["inference_error"]:
        raise AssertionError(f"learner error {stats['learner_error']}; inference error "
                             f"{stats['inference_error']}")
    if stats["env_frames"] != stats["actor_iterations"] * lanes:
        raise AssertionError(f"env_frames {stats['env_frames']} != actor_iterations "
                             f"{stats['actor_iterations']} x {lanes}")
    if transport == "inproc":
        return {}
    if stats["actor_hosts"] != hosts or len(pids) != hosts:
        raise AssertionError(f"{stats['actor_hosts']} actor hosts, {len(pids)} spawned; "
                             f"{hosts} asked")
    if stats["gateway_traj_frames"] <= 0:
        raise AssertionError("no trajectory crossed the wire")
    if transport == "shm" and stats["gateway_shm_conns"] != hosts:
        raise AssertionError(f"{stats['gateway_shm_conns']} shm connections, {hosts} hosts")
    # nvidia-smi may list PIDs of another namespace: beside the PIDs, this
    # process must be the only one it lists
    if any(stats["host_cuda_initialized"]) or listed["pids"] & set(pids) \
            or listed["entries"] > 1:
        raise AssertionError(f"an actor host opened a CUDA context: "
                             f"{stats['host_cuda_initialized']}, listed {listed}, hosts {pids}")
    return {"host_pids": pids, "nvidia_smi_pids": sorted(listed["pids"]),
            "nvidia_smi_entries": listed["entries"], "parent_listed": os.getpid() in listed["pids"],
            "host_cuda_initialized": stats["host_cuda_initialized"]}


WIRE_KEYS = ("elapsed_s", "env_frames", "actor_iterations", "env_frames_per_s", "learner_steps",
             "learner_steps_per_s", "mean_batch_occupancy", "mean_queue_wait_ms",
             "inference_batches", "inference_compute_s", "mean_param_lag", "unroll_flushes")
GATEWAY_KEYS = ("gateway_connections", "gateway_request_frames", "gateway_traj_frames",
                "gateway_traj_batch_frames", "gateway_shm_conns", "gateway_shm_frames",
                "host_shm_frames", "host_spill_frames")


def wire_phase():
    """Phase 17, the wire: R2D2 at the published widths through
    ``launch/train_r2d2.build`` in process, over TCP and over the shm rings
    with each actor in its own spawned host; then V-trace at Fig 3f's
    configuration over shm at 1, 2 and 4 hosts, through
    ``launch/train_vtrace.run_point``. Each wire point: no host error,
    learner steps, frames == iterations x lanes summed over the hosts,
    trajectories over the wire, one shm connection a host on shm, the
    params and the slot state on the card, no actor host on nvidia-smi's
    compute list nor with CUDA initialised."""
    import gc

    from repro_torch.configs.r2d2_atari import AtariConfig
    from repro_torch.envs.alesim import ALESimEnv
    from repro_torch.launch import train_r2d2, train_vtrace

    line, free = shm_room()
    log(f"== wire: /dev/shm {line}")
    acfg = AtariConfig()
    out = {"dev_shm": line, "r2d2": [], "vtrace": []}
    lanes = WIRE_R2D2_LANES
    for transport, hosts in WIRE_R2D2:
        run = train_r2d2.build(acfg, actors=WIRE_R2D2_ACTORS, envs_per_actor=lanes,
                               device="cuda",
                               env_factory=functools.partial(ALESimEnv, frame=84, channels=4),
                               learner_batch=R2D2_BATCH, replay_capacity=R2D2_CAPACITY,
                               transport=transport, actor_hosts=hosts)
        system, pids, listed = run.system, [], None
        geometry = None
        if system.pool is not None:
            if transport == "shm":
                geometry = system.pool.shm_geometry = shm_geometry(hosts, free)
            pids, listed, stop = watch_hosts(system)
        log(f"   R2D2 {transport}: {WIRE_R2D2_ACTORS} actors x {lanes} lanes of "
            f"ALESimEnv(frame=84, channels=4), {hosts} host(s), "
            f"learner batch {R2D2_BATCH} x {acfg.burn_in + acfg.unroll}, "
            f"{WIRE_R2D2_WINDOW_S:.0f} s window, ring geometry "
            f"{geometry or 'the defaults, 1 MiB x 64'}")
        system.warmup()
        try:
            stats = system.run(seconds=WIRE_R2D2_WINDOW_S)
        finally:
            if system.pool is not None:
                stop()
        learner = system.learner
        row = {"transport": transport, "hosts": hosts,
               **{k: stats[k] for k in WIRE_KEYS}, **{k: stats.get(k) for k in GATEWAY_KEYS},
               "learner_train_s": learner.train_time_s, "learner_wait_s": learner.wait_time_s,
               "replay_size": len(system.replay)}
        row.update(check_wire(stats, lanes, hosts, transport, pids, listed))
        tensors = [*learner.state["params"].parameters(),
                   *learner.state["target"].parameters(),
                   *run.published.params.parameters(), *run.core.values()]
        if not all(x.is_cuda for x in tensors):
            raise AssertionError("a parameter or the slot state is not on the card")
        log(f"   {json.dumps(row)}")
        out["r2d2"].append(row)
        del run, system, learner, tensors
        gc.collect()
        torch.cuda.empty_cache()

    for hosts in WIRE_VTRACE_HOSTS:
        run = train_vtrace.build(hosts, device="cuda", transport="shm", actor_hosts=hosts,
                                 **VTRACE)
        system = run.system
        system.pool.shm_geometry = shm_geometry(hosts, free)
        pids, listed, stop = watch_hosts(system)
        try:
            stats = system.run(seconds=WIRE_VTRACE_WINDOW_S)
        finally:
            stop()
        train_vtrace.check(stats)
        onp = stats["onpolicy"]
        row = {**train_vtrace.fig3f_row(hosts, stats), "hosts": hosts,
               **{k: stats[k] for k in ("elapsed_s", "env_frames", "actor_iterations",
                                        "mean_batch_occupancy", "mean_queue_wait_ms")},
               **{k: stats[k] for k in GATEWAY_KEYS},
               **{k: onp[k] for k in ("frames_generated", "frames_trained", "frames_dropped",
                                      "frames_dropped_stale", "frames_dropped_overflow",
                                      "frames_dropped_shutdown", "frames_dropped_fault")},
               "learner_train_s": system.learner.train_time_s,
               "learner_wait_s": system.learner.wait_time_s}
        row.update(check_wire(stats, VTRACE["envs_per_actor"], hosts, "shm", pids, listed))
        if onp["frames_trained"] <= 0:
            raise AssertionError(f"no frame trained: {onp}")
        state = system.learner.state
        tensors = [*state["params"].values(), *state["opt_state"]["m"].values(),
                   *state["opt_state"]["v"].values(), *run.policy._params.values()]
        if not all(x.is_cuda for x in tensors):
            raise AssertionError("a param, an AdamW moment or the policy's copy is not on "
                                 "the card")
        log(f"   V-trace shm, {hosts} host(s) x 1 actor x {VTRACE['envs_per_actor']} lanes of "
            f"CatchEnv(10, 5) on the host's CPU: {json.dumps(row)}")
        out["vtrace"].append(row)
    return out


# the paper's figures (phase 18): Figs 3 and 4 at their --smoke windows
FIG_WINDOW_S = 0.3
FIG3B_TOL = 1e-9


def figures_phase(card, r2d2, vtrace, device):
    """The paper's figures through the port's measurement surfaces, every
    row logged with the card's name and power limit: Fig 3a, 3c and 3e's
    replicas measured at the reference's --smoke windows, 3d, 3e's engine
    shards and 3f from phases 16 and 14, the models, the card's Fig 3d row
    at phase 16's t_dev0 and t_dev1; Fig 4's model rows and its wire sweep
    (in process, TCP, shm, Catch on the host's CPU) with the best-of-N
    probe; Fig 2's card row from phase 11's step; provision_system. The
    sections are the modules' own (`fig3.report`, `fig4.report`). Fails on
    a zero-frame point, an inference error, a Fig 3b check off by more
    than FIG3B_TOL, a ratio or a Fig 3d card row that is not finite, or
    Fig 2 readings that cannot describe one step (`fig2.card_row` raises
    where the counted kernels' time exceeds the busy time, the busy time
    the wall, or the counted FLOPs at the fp32 rate do not fit in the
    counted time)."""
    from repro_torch.benchmarks import fig2_breakdown as fig2
    from repro_torch.benchmarks import fig3_actor_scaling as fig3
    from repro_torch.benchmarks import fig4_cpu_gpu_ratio as fig4
    from repro_torch.configs.r2d2_atari import AtariConfig
    from repro_torch.launch import provision_system, rollout_backends

    t0 = time.perf_counter()
    out = {}

    def emit(title, lines):
        log(f"== {title}  [{card}]")
        for line in "\n".join(lines).splitlines():
            if line.strip():
                log(f"   {line}  [{card}]")

    rows = {"a": fig3.measured_sweep(actor_counts=(1, 2), seconds=FIG_WINDOW_S),
            "c": fig3.measured_env_sweep(env_counts=(1, 4), seconds=FIG_WINDOW_S),
            "d": [dict(device["points"][name], name=name, envs_per_actor=lanes)
                  for name, _, lanes in rollout_backends.POINTS],
            "t_dev": device["fit"],
            "e": fig3.measured_replica_sweep(replica_counts=(1, 2), seconds=FIG_WINDOW_S,
                                             device="cuda"),
            "shards": [dict(row, engine_shards=k, envs_per_actor=8)
                       for k, row in device["shards"].items()],
            "f": vtrace["rows"]}
    for key, measured in rows.items():
        if key != "t_dev":
            fig3.check_measured(measured)
    _, _, sw = fig3.model_sweep()
    s40, s256_40 = fig3.fig3b_checks(sw)
    if abs(s40 - 5.8) / 5.8 > FIG3B_TOL or abs(s256_40 - 2.0) / 2.0 > FIG3B_TOL:
        raise AssertionError(f"fig3b checks {s40}, {s256_40} against the paper's 5.8 and 2.0")
    fit = device["fit"]
    card_3d, over = fig3.model_device_card(fit["t_dev0_in_t_env"], fit["t_dev1_in_t_env"])
    if not (math.isfinite(card_3d) and math.isfinite(over)):
        raise AssertionError(f"fig3d's card row at t_dev {fit} is not finite")
    log("   fig3 (d), (e)'s engine shards and (f) are phases 16 and 14's rows, the card's "
        "fig3d model row phase 16's t_dev0 and t_dev1")
    for title, lines in fig3.report(rows, card, "the card"):
        emit(title, lines)
    out["fig3"] = {"a": rows["a"], "c": rows["c"], "e": rows["e"], "s40": s40,
                   "s256_40": s256_40, "device_card_frames_per_t_env": card_3d,
                   "device_card_over_vectorized": over}

    ratios = fig4.ratio_rows()
    if not all(math.isfinite(r) and r > 0 for _, r in ratios):
        raise AssertionError(f"a CPU/GPU ratio is not finite: {ratios}")
    wire_lines, bench, gate_failed = fig4.wire_sweep(smoke=True)
    for name, row in bench["transports"].items():
        if not row["env_frames"] > 0 or row["error"] or \
                row["env_frames"] != row["actor_iterations"] * bench["envs_per_actor"]:
            raise AssertionError(f"fig4 {name}: {row}")
    for title, lines in fig4.report(wire_lines):
        emit(title, lines)
    log(f"   fig4 shm probe gate: {gate_failed or 'passed'} (the reference's hard gate; "
        "recorded here, not asserted)")
    out["fig4"] = {"ratios": ratios, "wire": bench, "shm_gate": gate_failed}

    # card_row raises where the readings cannot describe one step: the
    # counted kernels' time beyond the busy time or that beyond the wall, or
    # the counted FLOPs at the fp32 rate not fitting in the counted time
    learner = r2d2["learner"]
    row = fig2.card_row(learner["flops"], fig2.step_bytes(AtariConfig(), R2D2_BATCH),
                        learner["mean_step_ms"] / 1e3, learner["device_ms"]["busy"] / 1e3,
                        learner["device_ms"]["counted"] / 1e3)
    total = sum(row["shares"].values())
    if not (all(math.isfinite(v) and v >= 0 for v in row["shares"].values())
            and abs(total - 1.0) < 1e-9 and 0 < row["occupancy"] <= 1):
        raise AssertionError(f"fig2 shares {row['shares']} (sum {total}), derate "
                             f"{row['occupancy']}")
    emit("fig2: the reference's analytic V100 rows", fig2.paper_lines())
    emit("fig2: the card's row, phase 11's R2D2 step (64 x 120, fp32)",
         fig2.card_lines(row, card))
    out["fig2"] = row

    emit("provision_system", provision_system.report())
    out["seconds"] = time.perf_counter() - t0
    log(f"   figures phase {out['seconds']:.1f} s")
    return out


# the ops and survival planes (phase 19): R2D2 at phase 17's socket point
# with the telemetry bundle and the live ops plane, then Fig 3's ops modes
OPS_HOSTS, OPS_LANES = 4, 8
OPS_WINDOW_S = 8.0
OPS_SCRAPE_S = 0.5
OPS_STITCH = ("actor/inference_rtt", "gateway/dispatch", "/forward", "gateway/reply_encode")


def stitched_chains(events):
    """From a trace's events: the processes holding "X" spans, the flow
    events, and the trace_seqs whose spans hold every OPS_STITCH stage
    (an actor's round trip, the gateway's dispatch, a replica's forward
    and the gateway's reply) across at least two processes."""
    pids, by_seq = set(), {}
    for e in events:
        if e.get("ph") == "X":
            pids.add(e["pid"])
            seq = (e.get("args") or {}).get("trace_seq")
            if seq:
                by_seq.setdefault(seq, []).append(e)
    flows = [e for e in events if e.get("ph") in ("s", "t", "f")]
    chains = [seq for seq, evs in by_seq.items()
              if len({e["pid"] for e in evs}) >= 2
              and all(any(stage in e["name"] for e in evs) for stage in OPS_STITCH)]
    return pids, flows, chains


def ops_phase(card):
    """Phase 19: the ops and survival planes on the card (see the module
    docstring). Returns the phase's numbers."""
    import os
    import threading
    import urllib.error
    import urllib.request

    from repro_torch.benchmarks import fig3_actor_scaling as fig3
    from repro_torch.configs.r2d2_atari import AtariConfig
    from repro_torch.envs.alesim import ALESimEnv
    from repro_torch.launch import train_r2d2
    from repro_torch.telemetry import (Telemetry, parse_prometheus, read_process_cpu_s,
                                       validate_prometheus)

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "bench_torch"
    acfg = AtariConfig()
    tel = Telemetry(process_name="learner", out_dir=str(out_dir / "ops_r2d2"))
    run = train_r2d2.build(acfg, actors=OPS_HOSTS, envs_per_actor=OPS_LANES, device="cuda",
                           env_factory=functools.partial(ALESimEnv, frame=84, channels=4),
                           learner_batch=R2D2_BATCH, replay_capacity=R2D2_CAPACITY,
                           transport="socket", actor_hosts=OPS_HOSTS, telemetry=tel, ops_port=0)
    system = run.system
    base = "http://%s:%d" % system.ops_address
    log(f"== ops planes [{card}]: R2D2 socket, {OPS_HOSTS} hosts x 1 actor x {OPS_LANES} lanes "
        f"of ALESimEnv(frame=84, channels=4), learner batch {R2D2_BATCH} x "
        f"{acfg.burn_in + acfg.unroll}, {OPS_WINDOW_S:.0f} s window, Telemetry + ops plane at "
        f"{base}")
    scrapes = {"metrics": 0, "lint": [], "verdicts": [], "varz": 0, "errors": []}
    done = threading.Event()

    def get(route):
        with urllib.request.urlopen(base + route, timeout=5.0) as r:
            return r.read().decode()

    def scrape():
        while not done.wait(OPS_SCRAPE_S):
            try:
                text = get("/metrics")
                scrapes["metrics"] += 1
                scrapes["lint"] += validate_prometheus(text)
                try:
                    hz = get("/healthz")
                except urllib.error.HTTPError as e:      # 503 carries the report
                    hz = e.read().decode()
                rep = json.loads(hz)
                scrapes["verdicts"].append((rep["verdict"], tuple(rep["stale"]),
                                            sorted(rep["components"])))
                json.loads(get("/varz"))["stats"]
                scrapes["varz"] += 1
            except Exception as e:       # noqa: BLE001 — counted and asserted below
                scrapes["errors"].append(repr(e))

    pids, listed, stop = watch_hosts(system)
    scraper = threading.Thread(target=scrape, daemon=True)
    system.warmup()
    cpu0, w0 = read_process_cpu_s(os.getpid()), time.perf_counter()
    scraper.start()
    try:
        stats = system.run(seconds=OPS_WINDOW_S)
    finally:
        done.set()
        scraper.join(timeout=10.0)
        stop()
    learner_cpu_s = read_process_cpu_s(os.getpid()) - cpu0
    learner_wall_s = time.perf_counter() - w0
    host = check_wire(stats, OPS_LANES, OPS_HOSTS, "socket", pids, listed)
    final = get("/metrics")
    lint = scrapes["lint"] + validate_prometheus(final)
    system.stop_ops()
    if scrapes["errors"] or not scrapes["metrics"] or scrapes["varz"] != scrapes["metrics"] \
            or lint:
        raise AssertionError(f"ops scrapes: {scrapes['metrics']} /metrics, {scrapes['varz']} "
                             f"/varz, errors {scrapes['errors'][:3]}, exposition {lint[:3]}")
    # steady state: every host beating, no component stale
    steady = [v for v in scrapes["verdicts"]
              if all(f"actor-host-{h}" in v[2] for h in range(OPS_HOSTS))]
    if not steady or any(v[0] != "healthy" for v in steady):
        raise AssertionError(f"/healthz in steady state: {scrapes['verdicts']}")
    if tel.auditor.violations:
        raise AssertionError(f"auditor violations: {tel.auditor.violations}")
    lanes = tel._counter_total("/requests")
    in_flight = OPS_HOSTS * OPS_LANES
    if int(lanes) != stats["inference_lanes"] or not 0 <= lanes - stats["env_frames"] <= in_flight:
        raise AssertionError(f"ledger: registry lanes {lanes}, stats lanes "
                             f"{stats['inference_lanes']}, env frames {stats['env_frames']}")
    parsed = parse_prometheus(final)
    ledger = {n[len("onpolicy_"):]: v for n, _, v in parsed["samples"]
              if n.startswith("onpolicy_frames")}
    if any(ledger.get(k) != stats["onpolicy"][k] for k in ("frames_generated", "frames_trained",
                                                            "frames_dropped", "frames_pending")):
        raise AssertionError(f"/metrics ledger {ledger} against {stats['onpolicy']}")
    paths = tel.dump()
    with open(paths["trace"]) as f:
        events = json.load(f)["traceEvents"]
    trace_pids, flows, chains = stitched_chains(events)
    if len(trace_pids) != OPS_HOSTS + 1 or not flows or not chains:
        raise AssertionError(f"trace: spans of {len(trace_pids)} processes, {len(flows)} flow "
                             f"events, {len(chains)} stitched actor->gateway->replica->reply")
    report = tel.bottleneck_report(stats)
    b = report.as_dict()
    if not (math.isfinite(report.cpu_gpu_ratio) and report.bottleneck.endswith("-bound")):
        raise AssertionError(f"bottleneck report: {b}")
    device_s = b["detail"]["inference_compute_s"] + b["detail"]["learner_train_s"]
    row = {"env_frames_per_s": stats["env_frames_per_s"], "env_frames": stats["env_frames"],
           "elapsed_s": stats["elapsed_s"], "learner_steps": stats["learner_steps"],
           "inference_lanes": stats["inference_lanes"], "bottleneck": b,
           "learner_process_cpu_s": learner_cpu_s, "learner_process_wall_s": learner_wall_s,
           "learner_process_cores": learner_cpu_s / learner_wall_s,
           "compute_plus_train_s": device_s, "scrapes": scrapes["metrics"],
           "healthz_steady": len(steady), "trace_processes": len(trace_pids),
           "trace_events": len(events), "flow_events": len(flows),
           "stitched_chains": len(chains), "auditor_ticks": tel.auditor.ticks,
           "host": host}
    log(f"   {report}  [{card}]".replace("\n", f"  [{card}]\n   "))
    log(f"   cpu seconds a process since the sampler started: {b['detail']['cpu_cores']}; "
        f"learner process {learner_cpu_s:.3f} CPU s over {learner_wall_s:.3f} s wall "
        f"({learner_cpu_s / learner_wall_s:.3f} cores) against inference compute_s + "
        f"learner train_s {device_s:.3f} s, which the in-process formula would net out of it "
        f"[{card}]")
    log(f"   {json.dumps(row)}")

    modes = {}
    for mode, fn in fig3.OPS_MODES.items():
        kw = {} if mode == "telemetry" else {"device": "cuda"}
        m0 = time.perf_counter()
        payload, lines = fn(True, out_dir, **kw)
        log(f"== fig3 --{mode} --smoke ({time.perf_counter() - m0:.1f} s)  [{card}]")
        for line in lines:
            log(f"   {line}  [{card}]")
        hard = [f for f in payload["failures"] if f not in payload["gate_failures"]]
        if hard:
            raise AssertionError(f"fig3 --{mode}: {hard}")
        gate = {k: v for k, v in payload.items() if k.endswith("overhead_frac")}
        log(f"   fig3 --{mode} overhead gate: {gate} against the limit "
            f"{fig3.OVERHEAD_GATE} ({'passed' if not payload['gate_failures'] else 'over'}; "
            f"recorded, not asserted)  [{card}]")
        modes[mode] = {k: v for k, v in payload.items() if k not in ("bottleneck",)}
    out = {"r2d2": row, "fig3": modes, "seconds": time.perf_counter() - t0}
    log(f"   ops phase {out['seconds']:.1f} s")
    return out


def quickstart_phase(card):
    """Phase 20: the port's quickstart on the card, as a user runs it
    (``repro_torch.launch.quickstart.main``), then the trend guard
    (``repro_torch.benchmarks.check_trend``) on the history ledger that
    phase 19 wrote under build/bench_torch/. Its LM part trains the reduced
    qwen3-14b (fp32: K1 on its 3xTF32 route and K1-bwd, once a layer a
    step), then greedy-decodes 8 tokens (K1 once a layer in the prefill, K2
    once a layer a step); nothing else it runs launches a port kernel.
    Returns (the launch counts, the phase's numbers)."""
    import io

    from repro_torch.benchmarks import check_trend
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart

    t0 = time.perf_counter()
    log(f"== quickstart [{card}]: python -m repro_torch.launch.quickstart (on the card)")
    layers = smoke_config("qwen3-14b").num_layers
    steps, greedy = 20, 8
    ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = quickstart.main(["--out-dir", str(ROOT / "build" / "quickstart")])
    counts = ops.launch_counts()
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"   {line}")
    want = {"flash_attention": layers * (steps + 1), "flash_attention_bwd": layers * steps,
            "decode_attention": layers * (greedy - 1), "ssd_scan": 0, "rglru_scan": 0,
            "ssd_scan_bwd": 0, "rglru_scan_bwd": 0}
    log(f"   launches: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"quickstart launch counts {counts} != expected {want}")
    if lines[-1] != "ok" or res["restored_step"] != 20 or not all(
            math.isfinite(x) for x in res["losses"]):
        raise AssertionError("the quickstart did not run to its end")
    quick_s = time.perf_counter() - t0

    ledger = ROOT / "build" / "bench_torch" / "BENCH_history.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = check_trend.main([str(ledger)])
    trend = out.getvalue().splitlines()
    log(f"== check_trend on {ledger.relative_to(ROOT)}: exit {rc}")
    for line in trend:
        log(f"   {line}")
    if rc != 0 or not trend[-1].startswith("trend_summary,ok"):
        raise AssertionError("check_trend did not read 'ok' on phase 19's history ledger")
    return counts, {"seconds": quick_s, "losses": res["losses"][::5],
                    "generated": res["generated"].tolist(), "check_trend_exit": rc,
                    "check_trend": trend[2:]}



def sharded_serve_phase(unpadded):
    """qwen3-14b at its production TP padding, served on the card under a
    device mesh: ``launch.dryrun.production_config`` for the (16, 16)
    mesh's decode cells (tp 16: 40 query heads padded to 48 over 8 kv
    heads, a group of 6; vocab 151936 padded to 152064), bf16, full width
    and depth, its params DTensors on ``single_device_mesh()`` with
    ``rules_for(cfg, mesh, "decode")`` active, through the InferenceServer
    (``serve_policy.serve(mesh=, rules=)``). K1 must rise by 40 a prefill
    and K2 by 40 a step (the kernels on each rank's shards, through
    ``local_map``; a DTensor reaching a wrapper raises); served tokens equal
    greedy decoding under the mesh; the prefill's last logits and 3 decode
    steps' against the plain versions (``full_depth_plain_check``); random
    values in the padded rows of every wq and wo leave the kernels' logits
    bit-identical; prefill ms, decode ms a step, device ms and peak memory
    printed beside the unpadded serve phase's (`unpadded`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import make_model
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_policy
    from repro_torch.launch.dryrun import production_config
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.serve import greedy_generate, make_prefill, make_serve_step
    from repro_torch.launch.specs import rules_for
    from repro_torch.sharding.ctx import is_dtensor, sharding_ctx
    from repro_torch.sharding.param import distribute_module
    from repro_torch.sharding.rules import AbstractMesh

    arch = "qwen3-14b"
    prompt_len, max_len = SERVE[arch]
    cfg = production_config(arch, AbstractMesh((16, 16), ("data", "model")), "decode")
    if (cfg.tp, cfg.padded_heads, cfg.num_kv_heads, cfg.padded_vocab) != (
            TP16["tp"], TP16["h"], TP16["kh"], 152064):
        raise AssertionError(f"production config: tp {cfg.tp}, heads {cfg.padded_heads} over "
                             f"{cfg.num_kv_heads}, vocab {cfg.padded_vocab}")
    log(f"== sharded serve: {arch} at its production TP padding (tp {cfg.tp}): "
        f"{cfg.num_heads} query heads padded to {cfg.padded_heads} over {cfg.num_kv_heads} kv "
        f"heads (a group of {cfg.padded_heads // cfg.num_kv_heads}), vocab {cfg.vocab_size} "
        f"padded to {cfg.padded_vocab}, {cfg.num_layers} layers, {cfg.param_dtype}")
    dev = torch.device("cuda")
    mesh = single_device_mesh("cuda")
    rules = rules_for(cfg, mesh, "decode")
    bundle = make_model(cfg)
    t0 = time.perf_counter()
    params = bundle.init(0, device=dev, dtype=torch.bfloat16)
    distribute_module(params, mesh, rules)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    if not all(is_dtensor(p) for p in params.parameters()):
        raise AssertionError("a parameter is not a DTensor")
    log(f"   mesh {mesh}, rules heads={rules['heads']} act_batch={rules['act_batch']} "
        f"act_kv_seq={rules['act_kv_seq']}; params: {n} ({n * 2 / 1e9:.2f} GB bf16, "
        f"DTensors) built in {time.perf_counter() - t0:.1f} s")

    ctx = functools.partial(sharding_ctx, mesh, rules)
    prompts = torch.randint(0, cfg.vocab_size, (CLIENTS, prompt_len), device=dev)
    prefill, step = make_prefill(bundle, max_len, torch.bfloat16), make_serve_step(bundle)
    with ctx():
        t0 = time.perf_counter()
        tok, cache = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        if not is_dtensor(cache["layers"][0]["k"]):
            raise AssertionError("the cache under the mesh is not made of DTensors")
        step(params, tok, cache)
        torch.cuda.synchronize()
    del tok, cache
    log(f"   warm-up: first prefill {cold_ms:.2f} ms (cold)")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_policy.serve(cfg, clients=CLIENTS, prompt_len=prompt_len, tokens=TOKENS,
                             max_len=max_len, device=dev, params=params, deadline_ms=1000.0,
                             mesh=mesh, rules=rules)
    counts = ops.launch_counts()
    k1_routes = dict(K1.flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    st = out["stats"]
    steps = st["batches"]
    want = expected_launches(cfg, steps)
    log(f"   launches: {counts}; decode steps (batches) {steps}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if k1_routes != {"wgmma": want["flash_attention"], "tf32x3": 0}:
        raise AssertionError(f"K1 launches by route {k1_routes}")
    if steps != TOKENS:
        raise AssertionError(f"{steps} decode steps for {TOKENS} tokens")
    served = torch.as_tensor(out["prompts"], device=dev)
    with ctx():
        greedy = greedy_generate(bundle, params, {"tokens": served}, steps=TOKENS + 1,
                                 max_len=max_len, dtype=torch.bfloat16).cpu()
    for cid in range(CLIENTS):
        if [out["first"][cid]] + out["tokens"][cid] != greedy[cid].tolist():
            raise AssertionError(f"client {cid}: served tokens differ from greedy")
    log(f"   served tokens equal greedy decoding under the mesh; client 0: "
        f"{out['tokens'][0][:8]}...")
    with ctx():
        plain = full_depth_plain_check(bundle, params, prompts, max_len)
        # the padded heads are inert: random values in their rows of wq and
        # wo, then the kernels' logits again, bit for bit
        before, fed = logits_path(bundle, params, prompts[:1], max_len, 3)
        gen = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for blk in params.blocks:
                wq, wo = blk.attn.wq.to_local(), blk.attn.wo.to_local()
                wq[:, cfg.num_heads:] = torch.randn(wq[:, cfg.num_heads:].shape, generator=gen,
                                                    device=dev).to(wq.dtype)
                wo[cfg.num_heads:] = torch.randn(wo[cfg.num_heads:].shape, generator=gen,
                                                 device=dev).to(wo.dtype)
        after, _ = logits_path(bundle, params, prompts[:1], max_len, 3, feed=fed)
    inert = all(torch.equal(a, b) for a, b in zip(before, after))
    log(f"   padded heads' rows of wq and wo randomised: the kernels' logits (prefill and 3 "
        f"decode steps) bit-identical {inert}")
    if not inert:
        raise AssertionError("randomising the padded heads changed the logits")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with ctx():
        with profile(activities=acts) as prof:
            tok, cache = prefill(params, {"tokens": prompts})
            torch.cuda.synchronize()
        pre, pre_ops = device_breakdown(prof, 1)
        with profile(activities=acts) as prof:
            for _ in range(3):
                tok, cache = step(params, tok, cache)
            torch.cuda.synchronize()
        dec, dec_ops = device_breakdown(prof, 3)
    del tok, cache
    if not (pre["K1"] > 0 and dec["K2"] > 0):
        raise AssertionError(f"no K1/K2 device time: prefill {pre}, decode {dec}")
    wall_step = out["decode_s"] * 1e3 / steps
    m = {"layers": cfg.num_layers, "params": n, "padded_heads": cfg.padded_heads,
         "padded_vocab": cfg.padded_vocab, "prefill_ms": out["prefill_s"] * 1e3,
         "prefill_cold_ms": cold_ms, "decode_ms_per_step": wall_step,
         "policy_step_ms": st["compute_s"] * 1e3 / steps, "peak_gb": peak / 1e9,
         "prefill_device_ms": pre, "decode_device_ms_per_step": dec,
         "decode_idle_share": 1 - dec["busy"] / wall_step,
         "prefill_device_ops": pre_ops, "decode_device_ops_per_step": dec_ops, **plain,
         "tokens": {cid: [out["first"][cid]] + out["tokens"][cid] for cid in range(CLIENTS)}}
    for key in ("prefill_ms", "decode_ms_per_step", "peak_gb"):
        log(f"   {key}: {m[key]:.2f} at tp 16 under the mesh, {unpadded[key]:.2f} unpadded "
            "(printed, not asserted)")
    log(f"   device ms a prefill {pre['busy']:.3f} (unpadded {unpadded['prefill_device_ms']['busy']:.3f})"
        f", a decode step {dec['busy']:.3f} (unpadded "
        f"{unpadded['decode_device_ms_per_step']['busy']:.3f}); device operations a decode step "
        f"{dec_ops:.0f} (unpadded {unpadded['decode_device_ops_per_step']:.0f})")
    del params
    return counts, m


def reshard_phase():
    """The reduced qwen3-14b's tp-2 train state, checkpointed on the host,
    restored by ``launch.ft.reshard_state`` onto the one-rank CUDA mesh:
    every leaf bit-equal and on the card."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import make_model, smoke_config
    from repro_torch.core.losses import init_train_state
    from repro_torch.launch.ft import reshard_state
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.optim import adamw

    log("== reshard: the reduced qwen3-14b's tp-2 train state onto the one-rank CUDA mesh")
    cfg = smoke_config("qwen3-14b").with_(tp=2)
    bundle, opt = make_model(cfg), adamw(1e-3)
    state = init_train_state(bundle, opt, 0, "cpu")
    d = ROOT / "build" / "reshard_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    mgr = CheckpointManager(str(d), async_save=False)
    mgr.save(state, 5)
    restored, step = reshard_state(mgr, bundle, opt, cfg, single_device_mesh("cuda"))
    leaves = [(n_, p, dict(restored["params"].named_parameters())[n_])
              for n_, p in state["params"].named_parameters()]
    leaves += [(f"{k}.{n_}", t, restored["opt_state"][k][n_])
               for k, v in state["opt_state"].items() for n_, t in v.items()]
    unequal = [n_ for n_, a, b in leaves if not torch.equal(a.detach(), b.full_tensor().cpu())]
    where = {b.to_local().device.type for _, _, b in leaves}
    log(f"   step {step}; {len(leaves)} leaves (params and AdamW moments); unequal {unequal}; "
        f"on {sorted(where)}")
    if step != 5 or unequal or where != {"cuda"}:
        raise AssertionError(f"reshard: step {step}, unequal {unequal}, devices {where}")
    shutil.rmtree(d, ignore_errors=True)
    return {"leaves": len(leaves), "step": step}


# the dry run's cells: a decode cell (the sharded serve phase's model on the
# (16, 16) mesh), an MoE decode cell through moe_ep under serving's full EP,
# and a long-context cell
DRYRUN_CELLS = (("qwen3-14b", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k"),
                ("mamba2-2.7b", "long_500k"))


def dryrun_phase(timeout=600):
    """The dry run in a child process of its own (it holds a fake process
    group of 256 ranks; no card: CUDA_VISIBLE_DEVICES is empty), run when no
    other phase runs: each of DRYRUN_CELLS through ``launch.dryrun.main``,
    then the roofline over its JSONL. Returns each cell's FLOPs, bytes,
    collective bytes and memory a rank, its terms (modelled on H100_SXM's
    spec, not measured) and wall seconds."""
    import os
    log("== dry run (child process, fake (16, 16) mesh of 256 ranks, meta tensors, no card)")
    out = ROOT / "build" / "dryrun_torch.jsonl"
    out.unlink(missing_ok=True)
    code = ("import sys, time\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.benchmarks import roofline\n"
            f"for arch, shape in {DRYRUN_CELLS!r}:\n"
            "    t0 = time.perf_counter()\n"
            f"    dryrun.main(['--arch', arch, '--shape', shape, '--out', {str(out)!r}])\n"
            "    print(f'WALL {arch} {shape} {time.perf_counter() - t0:.1f}', flush=True)\n"
            f"roofline.main(['--path', {str(out)!r}])\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    try:
        child = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the dry-run child ran past {timeout} s") from None
    text = child.stdout + child.stderr
    out.with_suffix(".log").write_text(text)
    for line in text.splitlines():
        if line.startswith(("[", "WALL", "roofline_", "OK:", "FAILED", "name,")):
            log(f"   {line}")
    if child.returncode != 0:
        log(text[-3000:])
        raise AssertionError(f"the dry-run child exited {child.returncode}")
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    walls = {tuple(x.split()[1:3]): float(x.split()[3]) for x in text.splitlines()
             if x.startswith("WALL ")}
    if [(r["arch"], r["shape"]) for r in rows] != list(DRYRUN_CELLS):
        raise AssertionError(f"dry-run rows {[(r['arch'], r['shape']) for r in rows]}")
    res = []
    for r in rows:
        t = r["terms"]
        res.append({"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                    "flops_per_rank": r["flops_per_chip"], "hbm_bytes_per_rank":
                    r["hbm_bytes_per_chip"], "collective_bytes_per_rank":
                    r["collective_bytes_per_chip"], "memory": r["memory"],
                    "terms_modelled_on": t["modelled_on"], "compute_s": t["compute_s"],
                    "memory_s": t["memory_s"], "collective_s": t["collective_s"],
                    "dominant": t["dominant"], "wall_s": walls[(r["arch"], r["shape"])]})
        if not (r["flops_per_chip"] > 0 and t["dominant"] in ("compute", "memory",
                                                               "collective")):
            raise AssertionError(f"dry-run row {r}")
    log("   the terms are modelled from H100_SXM's published peaks (bf16 989.4 TFLOP/s, HBM3 "
        "3.35 TB/s, 18 NVLink links of 25 GB/s), not measured; a 'model' axis of 16 ranks "
        "spans two 8-GPU nodes, whose link is slower than NVLink, so there the collective "
        "term is a lower bound")
    return res


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
    k1_ptxas, k4_ptxas, bwd_ptxas = {}, {}, {"k1": {}, "k3": {}, "k3_fwd": {}, "k4": {}}
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
            found = re.search(r"flash_tf32x3_kernelI(f|13__nv_bfloat16)Li(\d+)E", entry)
            if found:   # K1's 3xTF32 route, one line a dtype and head_dim
                used = int(re.search(r"Used (\d+) registers", entry).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
                dt = "fp32" if found.group(1) == "f" else "bf16"
                log(f"   flash_tf32x3_kernel<{dt}, {found.group(2)}>: {used} registers, {spill} "
                    "bytes of spill stores")
                if (dt, found.group(2)) == ("fp32", "256"):   # the train call's
                    k1_ptxas.update(registers=used, spill_bytes=spill)
            found = re.search(r"rglru_chunk_kernelI(f|13__nv_bfloat16)E", entry)
            if found:   # K4, one line an output type
                y = "fp32" if found.group(1) == "f" else "bf16"
                k4_ptxas[f"registers_{y}_y"] = int(re.search(r"Used (\d+) registers",
                                                             entry).group(1))
                k4_ptxas[f"spill_bytes_{y}_y"] = int(re.search(r"(\d+) bytes spill stores",
                                                               entry).group(1))
                log(f"   rglru_chunk_kernel<{y} y>: {k4_ptxas[f'registers_{y}_y']} registers, "
                    f"{k4_ptxas[f'spill_bytes_{y}_y']} bytes of spill stores")
            found = re.search(r"(ssd_state_kernel|ssd_pass_kernel|ssd_out_kernel)", entry)
            if found:   # K3's 3xTF32 route, one line a pass
                used = int(re.search(r"Used (\d+) registers", entry).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
                log(f"   {found.group(1)}: {used} registers, {spill} bytes of spill stores")
                short = found.group(1).split("_")[1]
                bwd_ptxas["k3_fwd"].update({f"registers_{short}": used,
                                            f"spill_bytes_{short}": spill})
            # K1-bwd, one line a kernel and head_dim, K4-bwd and K3-bwd
            found = re.search(r"(flash_bwd_dkdv_kernel|flash_bwd_dq_kernel)ILi(\d+)E|"
                              r"(flash_bwd_delta_kernel|flash_bwd_reduce_kernel|"
                              r"rglru_bwd_chunk_kernel|ssd_bwd_\w+?_kernel)", entry)
            if found:
                kernel = found.group(1) or found.group(3)
                used = int(re.search(r"Used (\d+) registers", entry).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
                log(f"   {kernel}{f'<{found.group(2)}>' if found.group(2) else ''}: {used} "
                    f"registers, {spill} bytes of spill stores")
                if kernel == "rglru_bwd_chunk_kernel":
                    bwd_ptxas["k4"].update(registers=used, spill_bytes=spill)
                elif kernel.startswith("ssd_bwd_"):   # one pair a pass
                    short = kernel[len("ssd_bwd_"):-len("_kernel")]
                    bwd_ptxas["k3"].update({f"registers_{short}": used,
                                            f"spill_bytes_{short}": spill})
                elif found.group(2) == "256":   # the train call's head_dim
                    short = kernel.split("_")[2]
                    bwd_ptxas["k1"].update({f"registers_{short}_256": used,
                                            f"spill_bytes_{short}_256": spill})

    rows = kernel_phase(k1_ptxas, k4_ptxas, bwd_ptxas)
    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's launches are the sum over the paths that run it
    # (K1 and K2 run on qwen3's and RecurrentGemma's)
    serve_metrics, launches, phase_s = {}, dict.fromkeys(rows, 0), {}
    for arch in SERVE:
        t0 = time.perf_counter()
        counts, serve_metrics[arch] = serve_phase(arch)
        for name in launches:
            launches[name] += counts.get(name, 0)
        torch.cuda.empty_cache()
        phase_s[f"serve {arch}"] = serve_metrics[arch]["seconds"] = time.perf_counter() - t0
        log(f"   serve {arch}: {phase_s[f'serve {arch}']:.1f} s")
    # qwen3-14b at its production TP padding, under a one-rank device mesh
    t0 = time.perf_counter()
    counts, sharded_metrics = sharded_serve_phase(serve_metrics["qwen3-14b"])
    for name in launches:
        launches[name] += counts.get(name, 0)
    torch.cuda.empty_cache()
    phase_s["sharded serve qwen3-14b tp16"] = sharded_metrics["seconds"] = \
        time.perf_counter() - t0
    t0 = time.perf_counter()
    reshard_metrics = reshard_phase()
    phase_s["reshard"] = time.perf_counter() - t0
    # a comparison with the plain versions: its launches are not the path's
    ring_metrics = ring_wrap_phase()
    phase_s["ring wrap gemma2-9b"] = ring_metrics["seconds"]
    torch.cuda.empty_cache()
    # mamba: 150 tokens span two of K3's 64-step chunks and a tail;
    # RecurrentGemma and gemma2: 150 tokens overflow the reduced config's
    # window of 32, so K1's window mask and the ring's wrap in prefill and
    # decode all run
    parity_phase("qwen3-14b", 24)
    parity_phase("mamba2-2.7b", 150)
    parity_phase("recurrentgemma-2b", 150)
    for arch in DENSE_PARITY:
        t0 = time.perf_counter()
        parity_phase(arch, 150)
        phase_s[f"parity {arch}"] = time.perf_counter() - t0
        log(f"   parity {arch}: {phase_s[f'parity {arch}']:.1f} s")
    # the encoder-decoder: 12 tokens against the reduced config's 8 frames,
    # so that K1's cross call (fp32, 3xTF32) has k and v of a length of their own
    t0 = time.perf_counter()
    parity_phase("seamless-m4t-large-v2", ENCDEC_PARITY_PROMPT)
    phase_s["parity seamless-m4t-large-v2"] = time.perf_counter() - t0
    for arch in MOE_ARCHS:
        for cf in MOE_CAPACITY:
            t0 = time.perf_counter()
            parity_phase(arch, 150, capacity_factor=cf)
            phase_s[f"parity {arch} cf {cf}"] = time.perf_counter() - t0
            log(f"   parity {arch} at capacity {cf}: {phase_s[f'parity {arch} cf {cf}']:.1f} s")
    grad_guard_phase()
    t0 = time.perf_counter()
    train_parity_phase()
    phase_s[f"train parity {TRAIN['arch']}"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    train_parity = {}
    for arch in TRAIN_PARITY:
        train_parity[arch] = family_train_parity_phase(arch)
        phase_s[f"train parity {arch}"] = train_parity[arch]["seconds"]
        torch.cuda.empty_cache()
    train_metrics = {}
    for arch in TRAIN_ARCHS:
        counts, train_metrics[arch] = train_phase(arch)
        for name in launches:
            launches[name] += counts.get(name, 0)
        phase_s[f"train {arch}"] = train_metrics[arch]["seconds"]
        torch.cuda.empty_cache()
    train_restart_phase()
    torch.cuda.empty_cache()
    # the R2D2, V-trace, device-backend and wire paths, the figures and the
    # ops planes reach none of the port's kernels: the counts are set to 0
    # before their phases (10-19) and must read 0 after
    from repro_torch.kernels import flash_attention as K1, ops, ssd_scan as K3
    ops.reset_launch_counts()
    r2d2_parity_phase()
    r2d2_metrics = {"learner": r2d2_learner_phase()}
    torch.cuda.empty_cache()
    r2d2_metrics["system"] = r2d2_system_phase()
    torch.cuda.empty_cache()
    vtrace_metrics = {"parity": vtrace_parity_phase()}
    vtrace_metrics["system"] = vtrace_system_phase()
    torch.cuda.empty_cache()
    device_metrics = {"parity": device_parity_phase()}
    device_metrics["system"] = device_system_phase()
    torch.cuda.empty_cache()
    wire_metrics = wire_phase()
    torch.cuda.empty_cache()
    figure_metrics = figures_phase(card, r2d2_metrics, vtrace_metrics["system"],
                                   device_metrics["system"])
    torch.cuda.empty_cache()
    ops_metrics = ops_phase(card)
    counts = ops.launch_counts()
    if any(counts.values()) or any(K1.flash_attention.launches_by_route.values()) \
            or any(K3.ssd_scan.launches_by_route.values()):
        raise AssertionError(f"the R2D2, V-trace, device-backend, wire, figures or ops "
                             f"phases launched a port kernel: {counts}")
    log(f"   R2D2, V-trace, device-backend, wire, figures and ops phases: kernel launches "
        f"{counts} (none, as the paths have no Pallas kernel)")
    torch.cuda.empty_cache()
    counts, quick_metrics = quickstart_phase(card)
    for name in launches:
        launches[name] += counts.get(name, 0)

    # the dry run needs no card; it runs alone, so no phase's times share
    # the host with it
    t0 = time.perf_counter()
    dryrun_metrics = dryrun_phase()
    phase_s["dry run"] = time.perf_counter() - t0

    for name, row in rows.items():
        row["launches"] = launches[name]
    for arch, metrics in serve_metrics.items():
        log(f"serve {arch}: {json.dumps(metrics)}")
    log(f"sharded serve qwen3-14b tp16: {json.dumps(sharded_metrics)}")
    log(f"reshard: {json.dumps(reshard_metrics)}")
    log(f"dry run: {json.dumps(dryrun_metrics)}")
    log(f"ring wrap gemma2-9b: {json.dumps(ring_metrics)}")
    log(f"seconds of the serve, ring-wrap, parity and train phases: "
        f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    for arch, metrics in train_parity.items():
        log(f"train parity {arch}: {json.dumps(metrics)}")
    for arch, metrics in train_metrics.items():
        log(f"train {arch}: {json.dumps(metrics)}")
    log(f"r2d2: {json.dumps(r2d2_metrics)}")
    log(f"vtrace: {json.dumps(vtrace_metrics)}")
    log(f"device backend: {json.dumps(device_metrics)}")
    log(f"wire: {json.dumps(wire_metrics)}")
    log(f"figures: {json.dumps(figure_metrics, default=str)}")
    log(f"ops: {json.dumps(ops_metrics, default=str)}")
    log(f"quickstart: {json.dumps(quick_metrics)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
