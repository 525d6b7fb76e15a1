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
   K2 also with its log-sum-exp at every case, gemma2's capped calls
   included (the fp32 output and the lse against the plain version's, the
   output without it that output rounded once, bit for bit:
   ``check_k2_lse``), and timed at the tp-16 call with and without it,
   alternated (`lse_ms`, `no_lse_ms`);
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
   the rest of the dense family at full width, K1 once a layer a prefill
   and K2 once a layer a decode step: gemma2-9b (10 of its 42 layers,
   4352-token prompts past its window of 4096, so its local layers' rings
   wrap, which the phase checks), starcoder2-15b (10 of 40), qwen2.5-32b
   (16 of 64) and internvl2-1b (24, its full depth, text prompts); then
   the MoE family: qwen3-moe-30b-a3b at full width cut to 12 of its 48
   layers of 128 experts, top 8, K1 12 a prefill and K2 12 a decode step
   (the depths cut to keep the whole run within its time with the
   production-dtype training phases; SERVE_LAYERS), and deepseek-v3-671b
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
   ms and peak memory printed beside the unpadded phase's; then the same
   params under the reference's decode layout, a (1, 1) ("data", "model")
   mesh, where ``act_kv_seq`` maps to "model": the cache sharded on its
   sequence, K2 40 a step all with its log-sum-exp (the sequence-sharded
   branch's combine on one rank), tokens equal the ("data",) mesh's, the
   full-depth check, decode ms a step, device busy ms and operations a
   step beside the ("data",) mesh's; then the sequence-sharded decode on 2
   and 4 ranks of the card (processes over gloo and a file store, each
   holding its chunk of one seeded cache as a DTensor) at the tp-16 call
   and gemma2's capped global call, the valid length ending in rank 0's
   chunk, on a boundary and in the last chunk, held to K2 on the whole
   cache and to the plain version; then reshard:
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
6. grad guards: K2 raises under autograd (it has no backward kernel)
   instead of returning a tensor with no grad_fn; K1 in bf16 at head_dim
   16 (its backward on K1-bwd's 3xTF32 kernels, one launch under that
   route, its gradient within BF16_GRAD_TOL of the plain backward's), at
   64, 128 and 256, K3 in bf16 and fp32, and K1 in fp32 with k and v of a
   length of their own return tensors with a grad_fn;
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
   held to the kernels in fp64 as RecurrentGemma's leaves are; then
   qwen3-14b, mamba2-2.7b and recurrentgemma-2b at 3 layers,
   seamless-m4t-large-v2 at 2 + 2 and gemma2-9b at one local and one
   global layer (batch 1 x 4352, past its window of 4096), all of full
   width, at the production dtypes (bf16 params and compute, full remat;
   ``bf16_train_parity_phase``): the loss through K1 (wgmma) and K1-bwd's
   bf16 route, K3 and K3-bwd's wgmma route, or K4 and K4-bwd, against
   their plain versions paired as the kernels pair them
   (``plain_bf16_pairs``: the bf16 K1-bwd's plain version with its
   roundings; K4's by ``plain_versions``) within 1e-2 relative, one step's
   launches on those routes (seamless's cross calls at S_kv 1024 counted
   apart), and every gradient leaf within BF16_LEAF_TOL (5e-2) of the plain
   versions' or, where farther, held to the kernels in fp64, the plain
   and fp64 runs replaying the kernel run's ReLU masks; then at the same
   dtypes starcoder2-15b at 2 layers, qwen2.5-32b at 2 (batch 2 x 256),
   internvl2-1b at 3 (256 frontend tokens before 256 text tokens),
   qwen3-moe-30b-a3b at 2 MoE layers (the plain and fp64 runs replaying
   the kernel run's expert choices, the backward's recompute held to the
   forward's choices) and deepseek-v3-671b's 3 dense MLA layers (batch 2
   x 256, K1 and K1-bwd on the padded head_dim 256);
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
   seconds; then the same at the reference's production dtypes (bf16
   params and compute, full remat, AdamW moments in the config's
   optimizer_dtype, asserted: bf16 for deepseek, fp32 else): qwen3-14b at full
   width cut to 4 of 40 layers (2.88 B params), batch 16 x 256 in its
   config's 4 micro-batches, K1 32 and K1-bwd 16 a step (remat runs each
   layer's forward again; K1 on wgmma, K1-bwd on its bf16 route),
   mamba2-2.7b at full width and depth, batch 4 x 256, K3 128 and K3-bwd
   64 a step (K3 and K3-bwd on their wgmma routes), recurrentgemma-2b at
   full width and depth, batch 4 x 256 (K1 16 and K1-bwd 8, K4 36 and
   K4-bwd 18 a step), seamless-m4t-large-v2 at full width and depth over
   4 x 1024 frames (K1 144 and K1-bwd 72 a step, 48 and 24 of them at S_kv
   1024), and gemma2-9b at full width cut to 4 of 42 layers, batch 4 x
   4352 in its config's 4 micro-batches (K1 32 and K1-bwd 16 a step, the
   cap, the scale 0.0625 and the local layers' window of 4096 binding),
   starcoder2-15b at 4 of 40 layers, 16 x 256 in 4 micro-batches (K1 32,
   K1-bwd 16 a step: a group of 12 query heads), qwen2.5-32b at 4 of 64,
   16 x 256 in 8 micro-batches of 2 (K1 64, K1-bwd 32), internvl2-1b at
   full depth, 4 x 256 text tokens after 256 seeded frontend tokens (K1
   48, K1-bwd 24 at S 512, 14/2 heads of 64), qwen3-moe-30b-a3b at 4 of 48
   layers, 16 x 256 in 4 micro-batches (K1 32, K1-bwd 16; its profile
   groups the MoE calls' forward, recompute and backward kernels as
   moe_gemm and moe_dispatch) and deepseek-v3-671b's 3 dense MLA layers
   without the MTP block, 16 x 256 in 8 micro-batches of 2, bf16 moments
   (K1 48, K1-bwd 24 on the padded head_dim 256); after qwen3-14b's step,
   on its params and batch, remat "dots" (``remat_dots_phase``: the
   reference's dots_with_no_batch_dims_saveable, the products with no
   batch dimension saved and the rest recomputed) against "full" through
   ``make_train_step`` with an optimizer that moves no param (GradsKept):
   REMAT_ROUNDS rounds alternated and "none" once (each step's wall and
   peak), one profiled step under each (device busy and GEMM ms), and one
   micro-batch under each (the memory its forward leaves, its peak); then
   one step of mamba2-2.7b (2 layers), recurrentgemma-2b (3),
   seamless-m4t-large-v2 (2 + 2) and qwen3-moe-30b-a3b (2, its expert
   choices replayed) at full width, batch 4 x 256, "full", "dots", "full";
   every "dots" run's loss and gradient leaves equal to "full"'s to the
   bit (or, where two "full" runs differ, no farther from them than they
   are apart), each run's launches those of its policy (the forward
   kernels twice a micro-batch under "dots", as under "full");
   then the smoke configs of qwen3-14b, recurrentgemma-2b and
   seamless-m4t-large-v2 (head_dim 16) at those dtypes, 3 steps each
   through the launcher's functions, K1 and K1-bwd on their 3xTF32
   kernels on bf16;
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

Every phase prints its seconds on a line of its own (``phase <name>: N
s``), and the run all of them in one JSON line before the results.

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
launches those of that route in the train phase). For training at the
production dtypes (``bf16_kernel_phase``): K1's wgmma route with its
log-sum-exp (held to LSE_BF16_TOL, 1e-4) and the bf16 K1-bwd against its
plain version with its roundings (BF16_GRAD_TOL, 1e-2 of each gradient's
max) at qwen3-14b's micro-batch call (4, 256, 40/8, 128), D 64, 128 and
256, 5 query heads a kv head, a window, softcap 50, S_kv != S unmasked and
the edges of 32- and 64-row tiles, two calls at qwen3's call equal to the
bit (its wgmma kernels sum each kv head's query heads in a fixed order);
K3-bwd's bf16 routes (``wgmma`` at P a multiple of 64 and N 64 or 128,
``staged`` elsewhere) at mamba2's train call, the fp32 route's edges plus
P and N off 8, and one ``wgmma`` edge (ragged S, G 2, P 128, N 64, h0 and
d(final state)), each case logging its route, counted under it, run twice
and held equal to the bit; each timed at its train call beside its bound
(K1-bwd also beside SDPA's bf16 backward), with its registers and spills
(K3-bwd with its plan: slices, CTAs, CTAs an SM, waves), in the rows
``flash_attention_bwd_bf16`` and ``ssd_scan_bwd_bf16`` and K1's
``qwen3_train_call``. The bf16 K1-bwd is also held once and timed at
RecurrentGemma's, seamless's (encoder, self, cross), gemma2's (local,
global), starcoder2's (48/4), qwen2.5's, internvl2's (14/2 at D 64, S 512),
qwen3-moe's and MLA's padded (128/128, q and k 192, v 128 in D 256, the
padded columns of dq, dk and dv exactly 0, SDPA on the unpadded inputs)
train calls (``k1_bwd_call``; SDPA's bf16 backward beside it where one
SDPA call computes the same function), and K1-bwd on bf16 at head_dim
16 (the 3xTF32 kernels) at the smoke step's calls and its tiles' edges
against the plain backward at BF16_GRAD_TOL, each case twice equal to the
bit, timed at the smoke call (``flash_attention_bwd``'s
``bf16_d16_call``).

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
import gc
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
# the MoE archs: qwen3-moe-30b-a3b; deepseek-v3-671b at its full width cut
# to 4 layers (its 3 first dense layers and 1 MoE layer, with the MTP block
# built: 53 GB), since its 61 layers take 1.3 TB
MOE_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
# serve paths served at full width with their depth cut: deepseek to fit
# the card; qwen3-moe (48 layers), qwen2.5-32b (64), gemma2-9b (42, an even
# count keeps its local/global alternation) and starcoder2-15b (40) so that
# the run, with the production-dtype training phases, stays within its time
SERVE_LAYERS = {"deepseek-v3-671b": 4, "qwen3-moe-30b-a3b": 12, "qwen2.5-32b": 16,
                "gemma2-9b": 10, "starcoder2-15b": 10}
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
# the encoder-decoder's train parity: 2 encoder and 2 decoder layers
TRAIN_PARITY_ENCDEC = dict(enc_layers=2, dec_layers=2, num_layers=4)
GRAD_TOL = 1e-4   # of a gradient tensor's max |value|, and relative
# K1-bwd's one route: every head_dim on the tensor cores, 3xTF32 mma.sync
K1_BWD_ROUTE = "tensor cores, 3xTF32 mma.sync"
LSE_TOL = 1e-5   # K1's and K2's log-sum-exp against their plain versions, and relative
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
# training at the reference's production dtypes (its launch/dryrun.py's
# production_config): bf16 params and compute, full remat, AdamW moments in
# each config's optimizer_dtype (bf16 for deepseek-v3-671b, fp32 for the
# others), each config's gradient accumulation (none where it is pure
# data-parallel: tp 1). qwen3-14b at full width cut to 4 of 40 layers, batch
# 16 x 256 in its config's 4 micro-batches (K1 and K1-bwd at (4, 256, 40/8,
# 128), the serving prefill's call); mamba2-2.7b at full width and depth,
# batch 4 x 256 (K3 and K3-bwd at (4, 256, 80, 64, 128)); recurrentgemma-2b
# at full width and depth, batch 4 x 256 (K1 and K1-bwd at (4, 256, 10/1,
# 256), window 2048; K4 and K4-bwd at (4, 256, 2560)); seamless-m4t-large-v2
# at full width and depth over 4 x 1024 frames (K1 and K1-bwd at D 64, 16/16:
# the encoder's 1024 frames unmasked, the decoder's 256 causal, the cross
# calls 256 over 1024); gemma2-9b at full width cut to 4 of 42 layers (2
# local, 2 global; 9.2 B params at 12 bytes do not fit the card), batch 4 x
# 4352 in its config's 4 micro-batches (K1 and K1-bwd at (1, 4352, 16/8,
# 256), every logit capped at 50, scale 0.0625, a window of 4096 on the
# local layers: 4352 is the serve phase's prompt, past the window, so that
# rows past 4096 lose their first keys). starcoder2-15b 4 of 40 layers, 16 x
# 256 in 4 micro-batches (K1 and K1-bwd at (4, 256, 48/4, 128): a group of 12
# query heads); qwen2.5-32b 4 of 64 layers, 16 x 256 in 8 micro-batches of 2
# ((2, 256, 40/8, 128), qkv biases); internvl2-1b at full depth, 4 x 256
# text tokens after 256 seeded frontend tokens ((4, 512, 14/2, 64): 7 at D
# 64); qwen3-moe-30b-a3b 4 of 48 layers, 16 x 256 in 4 micro-batches
# ((4, 256, 32/4, 128); 128 experts, top 8, 80 slots an expert at capacity
# 1.25); deepseek-v3-671b its 3 first dense (MLA) layers without the MTP
# block, 16 x 256 in 8 micro-batches of 2 (K1 at (2, 256, 128/128) on
# MLA's q and k of 192 and v of 128 zero-padded to D 256), since one MoE
# block at 8 bytes a param (bf16 p, g, m, v) is 91 GB. The dense and MoE
# cuts keep 22.0-671 B params off a card of 80 GB. "seq" defaults to
# TRAIN's.
PRODUCTION = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")
BF16_TRAIN = {"qwen3-14b": dict(batch=16, num_layers=4), "mamba2-2.7b": dict(batch=4),
              "recurrentgemma-2b": dict(batch=4), "seamless-m4t-large-v2": dict(batch=4),
              "gemma2-9b": dict(batch=4, seq=4352, num_layers=4),
              "starcoder2-15b": dict(batch=16, num_layers=4),
              "qwen2.5-32b": dict(batch=16, num_layers=4), "internvl2-1b": dict(batch=4),
              "qwen3-moe-30b-a3b": dict(batch=16, num_layers=4),
              "deepseek-v3-671b": dict(batch=16, num_layers=3, mtp_depth=0)}
# their train parity at a few layers of full width in one micro-batch, batch
# 4 x 256 unless named, the kernels against their plain versions paired as
# the kernels pair them: 3 layers (RecurrentGemma's rglru, rglru, local),
# seamless's 2 + 2, gemma2's local and global layer at batch 1 x 4352, past
# its window; qwen2.5 and deepseek at their micro-batch of 2, deepseek's 3
# dense MLA layers; qwen3-moe's 2 MoE layers at 1024 tokens (capacity 1.25,
# the plain and fp64 runs taking the kernel run's expert choices)
BF16_TRAIN_PARITY = {"qwen3-14b": dict(num_layers=3), "mamba2-2.7b": dict(num_layers=3),
                     "recurrentgemma-2b": dict(num_layers=3),
                     "seamless-m4t-large-v2": TRAIN_PARITY_ENCDEC,
                     "gemma2-9b": dict(num_layers=2, batch=1, seq=4352),
                     "starcoder2-15b": dict(num_layers=2),
                     "qwen2.5-32b": dict(num_layers=2, batch=2), "internvl2-1b": dict(num_layers=3),
                     "qwen3-moe-30b-a3b": dict(num_layers=2),
                     "deepseek-v3-671b": dict(num_layers=3, mtp_depth=0, batch=2)}
# remat "dots" against "full" (``remat_dots_phase``): qwen3-14b at
# BF16_TRAIN's call on the bf16 train phase's params, "full" and "dots"
# alternated REMAT_ROUNDS rounds; then one step of each REMAT_DOTS model at a
# few layers of full width, 4 x 256 in one micro-batch, at the production
# dtypes: K3 and K3-bwd on wgmma (mamba2), K4, K4-bwd, K1 and K1-bwd at D 256
# (rglru, rglru, local), K1 and K1-bwd at D 64 over encoder, self and cross
# calls (seamless), the MoE dispatch with its expert choices replayed
REMAT_ROUNDS = 2
REMAT_DOTS = {"mamba2-2.7b": dict(num_layers=2), "recurrentgemma-2b": dict(num_layers=3),
              "seamless-m4t-large-v2": TRAIN_PARITY_ENCDEC,
              "qwen3-moe-30b-a3b": dict(num_layers=2)}
# the smoke configs of the attention families at the production dtypes,
# trained a few steps on the card: K1 and K1-bwd at head_dim 16, bf16, on
# their 3xTF32 kernels
BF16_SMOKE = ("qwen3-14b", "recurrentgemma-2b", "seamless-m4t-large-v2")
BF16_SMOKE_RUN = dict(batch=4, seq=48, steps=3)
# a bf16 backward kernel's bf16 outputs against its plain version with the
# kernel's roundings: 2.5 bf16 ulps of each tensor's max |value| (an
# element rounds one ulp the other way; a P or dX that rounds the other way
# moves a sum by one ulp of that term)
BF16_GRAD_TOL = 1e-2
# a bf16 gradient leaf of the train parity against the plain versions'
BF16_LEAF_TOL = 5e-2
LSE_BF16_TOL = 1e-4   # the wgmma route's log-sum-exp, and relative
LSE_ROUNDS = 4   # K2 at the tp-16 call with and without its log-sum-exp, alternated
# the sequence-sharded decode on R ranks of one card (``seq_shard_phase``):
# K2's partials over each rank's chunk of one seeded cache, combined by
# gloo all-reduces (``nn.attention._decode_call``), at the tp-16 call and
# gemma2's capped global call, the valid length ending in rank 0's chunk,
# on a chunk boundary and in the last chunk at R 2 and 4
SEQ_RANKS = (2, 4)
SEQ_CALLS = {"qwen3_tp16_call": dict(b=4, s=512, h=48, kh=8, d=128, softcap=None,
                                     scale=128 ** -0.5, lengths=(100, 256, 500)),
             "gemma2_call": dict(b=4, s=4416, h=16, kh=8, d=256, softcap=50.0, scale=0.0625,
                                 lengths=(1000, 2208, 4400))}


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


def check_k2_lse(name, got, q, k, v, lengths, **kw):
    """K2 with its log-sum-exp (a sequence-sharded cache's partial) on the
    inputs of a call whose output without it was `got`: the fp32 output
    and the lse against the plain version's (fp32 arithmetic on the same
    inputs either way: 2e-5 and LSE_TOL), and `got` that output rounded
    once, bit for bit."""
    from repro_torch.kernels import decode_attention as K2
    from repro_torch.kernels import ops

    out, lse = K2.decode_attention(q, k, v, lengths, return_lse=True, **kw)
    want, want_lse = ops.decode_attention_plain(q, k, v, lengths, return_lse=True, **kw)
    check_close(f"{name} with lse: fp32 output", out, want, 2e-5)
    check_close(f"{name} with lse: lse", lse, want_lse, LSE_TOL)
    if not torch.equal(got, out.to(got.dtype)):
        raise AssertionError(f"{name}: the output without lse is not the lse call's output "
                             "rounded once")


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
        name = (f"K2 {(cb, cs, ch, ckh, cd)} {str(dt)[6:]} softcap {GEMMA['softcap']:g}, "
                f"q x {qmul:g}, lengths {lens}")
        check_close(f"{name} [chunk {chunk}, {splits} splits]", got, want, tol[dt],
                    row_atol(want, tol[dt], (1, 2)))
        check_k2_lse(name, got, q, k, v, ln, **kw)
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
    as its score_mod (after the scale, before the mask, as the kernels;
    none without a cap), `mask_mod` as a block mask built here once.
    Returns a callable of (k, v); q may require grad, for the backward.
    Timed as the library cell only; the port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask
    block_mask = create_block_mask(mask_mod, q.shape[0], None, q_len, kv_len,
                                   device=q.device)

    def cap(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    flex = compiled_flex_attention()
    return lambda kk, vv: flex(q, kk, vv, score_mod=cap if softcap else None,
                               block_mask=block_mask, scale=scale, enable_gqa=True)


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
        name = f"K2 {(cb, cs, ch, ckh, cd)} {str(dt)[6:]} lengths {lens}"
        err = check_close(f"{name} [chunk {chunk}, {splits} splits]", got, want, tol[dt])
        main_err = err if main_err is None else main_err
        check_k2_lse(name, got, q, k, v, ln, scale=cd ** -0.5)

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
        for kernel, start, end, _ in device_events(prof):
            for name, found in spans.items():
                if f"decode_{name}_kernel" in kernel:
                    found.append((start, end))
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

    def time_k2(b, S, h, kh, d, n_valid, softcap=None, lse=False):
        """Timing at a serving path's mid-run length, with enough caches in
        rotation that their valid rows exceed the 50 MB L2: a decode step
        finds each layer's cache cold. Also times each chunk of a sweep, the
        plan picking it for an SM count other than the card's. SDPA computes
        no softcap: with one, flex_attention's time is the library cell and
        SDPA's uncapped time stands beside it, labelled. With `lse`, the
        call with the log-sum-exp (the sequence-sharded decode's) and
        without it, alternated over LSE_ROUNDS rounds: `lse_ms` and
        `no_lse_ms`, each the mean of its rounds."""
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
        if lse:
            rounds = {False: [], True: []}
            for _ in range(LSE_ROUNDS):
                for with_lse in (False, True):
                    rounds[with_lse].append(time_ms(f"K2 lse {with_lse}", rotating(
                        lambda kk, vv: K2.decode_attention(q, kk, vv, ln, scale=sc,
                                                           return_lse=with_lse, **cap), kvs),
                        iters=32))
            # the lse call writes fp32 out (2x q's bytes) and 4 bytes a row more
            lse_bytes = nbytes + b * h * d * (4 - q.element_size()) + 4 * b * h
            row.update(no_lse_ms=sum(rounds[False]) / LSE_ROUNDS,
                       lse_ms=sum(rounds[True]) / LSE_ROUNDS,
                       lse_rounds_ms={"without": rounds[False], "with": rounds[True]},
                       lse_bound_ms=lse_bytes / PEAK_BYTES * 1e3)
            log(f"   K2 with and without lse, alternated over {LSE_ROUNDS} rounds: lse_ms "
                f"{row['lse_ms']:.4f} ({', '.join(f'{t:.4f}' for t in rounds[True])}), "
                f"no_lse_ms {row['no_lse_ms']:.4f} "
                f"({', '.join(f'{t:.4f}' for t in rounds[False])}); lse bound_ms "
                f"{row['lse_bound_ms']:.5f}")
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
        b, S, TP16["h"], TP16["kh"], TP16["d"], PROMPT_LEN + TOKENS // 2, lse=True)
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


def bf16_kernel_phase(rows, bwd_ptxas):
    """The kernels of training at the production dtypes, against their
    plain versions and timed: K1's wgmma route writing its log-sum-exp (held
    to LSE_BF16_TOL), the bf16 K1-bwd (against
    ``ops.flash_attention_bwd_bf16_plain``, its roundings, at BF16_GRAD_TOL
    of each gradient's max) and the bf16 route of K3-bwd (its bf16 outputs
    at BF16_GRAD_TOL, its fp32 ones at GRAD_TOL, each case run twice and
    held equal to the bit), each timed at its train call beside its bound
    and, for K1-bwd, SDPA's bf16 backward. Adds the rows
    ``flash_attention_bwd_bf16`` and ``ssd_scan_bwd_bf16`` and K1's
    ``qwen3_train_call``. K1-bwd at qwen3's call runs twice and is held
    equal to the bit."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K3

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    log("== kernels: training at the production dtypes: K1's wgmma route with its "
        "log-sum-exp, K1-bwd's and K3-bwd's bf16 routes")
    qb, qs = BF16_TRAIN["qwen3-14b"]["batch"] // get_config("qwen3-14b").grad_accum, TRAIN["seq"]
    qcall = (qb, qs, 40, 8, 128)          # qwen3-14b's micro-batch call
    # D 64, 128, 256; 5 query heads a kv head; a window; softcap 50; S_kv !=
    # S unmasked; S off the 32-row tiles; the tiles' edges (one past a tile,
    # one past two, ragged over ten; a window ending inside a key tile)
    cases = [(qcall, {}),
             ((2, 77, 5, 1, 64), {}),
             ((2, 200, 10, 2, 256), {"window": 64}),
             ((2, 96, 4, 2, 128), {"softcap": 50.0}),
             ((2, 33, 4, 4, 64), {"window": 20, "softcap": 50.0}),
             ((1, 65, 10, 1, 256), {"window": 20}),
             ((2, 300, 4, 1, 128), {"window": 45}),
             ((2, 65, 5, 1, 128), {"causal": False}),
             ((2, 40, 4, 2, 64), {"causal": False, "skv": 100}),
             ((1, 130, 2, 2, 256), {"causal": False, "skv": 33}),
             ((TRAIN["batch"], TRAIN["seq"], SEAMLESS["h"], SEAMLESS["kh"], SEAMLESS["d"]),
              {"causal": False, "skv": SEAMLESS["frames"]})]
    k1_err = 0.0
    for (cb, cs, ch, ckh, cd), kw in cases:
        kw = dict(kw)
        cskv = kw.pop("skv", cs)
        q, do = rand(cb, cs, ch, cd), rand(cb, cs, ch, cd)
        k, v = rand(cb, cskv, ckh, cd), rand(cb, cskv, ckh, cd)
        kw = {"causal": True, "scale": cd ** -0.5, **kw}
        o, lse = K1.flash_attention(q, k, v, return_lse=True, **kw)
        got = K1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ops.flash_attention_bwd_bf16_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        shown = {k_: v_ for k_, v_ in kw.items() if k_ != "scale"}
        if cskv != cs:
            shown["S_kv"] = cskv
        name = f"K1-bwd bf16 {(cb, cs, ch, ckh, cd)} {shown}"
        check_close(f"K1 {(cb, cs, ch, ckh, cd)} {shown} [wgmma] lse", lse,
                    ops.flash_attention_lse_plain(q, k, **kw), LSE_BF16_TOL)
        check_close(f"K1 {(cb, cs, ch, ckh, cd)} {shown} [wgmma] output", o,
                    ops.flash_attention_plain(q, k, v, **kw), 2e-2)
        errs = [check_close(f"{name} {g} [bf16]", x, w, BF16_GRAD_TOL,
                            BF16_GRAD_TOL * max(float(w.float().abs().max()), 1e-30))
                for g, x, w in zip(("dq", "dk", "dv"), got, want)]
        if (cb, cs, ch, ckh, cd) == qcall:
            k1_err = max(errs)
            again = K1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            log(f"   {name}: a second call {'equal to the bit' if same else 'DIFFERS'}")
            if not same:
                raise AssertionError(f"{name}: two calls differ")
            del again
        del q, k, v, do, o, lse, got, want

    # timing at qwen3's micro-batch call: K1 with its log-sum-exp, K1-bwd
    cb, cs, ch, ckh, cd = qcall
    sc = cd ** -0.5
    q, do = rand(cb, cs, ch, cd), rand(cb, cs, ch, cd)
    k, v = rand(cb, cs, ckh, cd), rand(cb, cs, ckh, cd)
    fwd = lambda: K1.flash_attention(q, k, v, scale=sc, return_lse=True)   # noqa: E731
    o, lse = fwd()
    fwd_ms = time_ms("K1 bf16 with lse", fwd)
    fwd_plain = time_ms("K1 bf16 plain with lse", lambda: (
        ops.flash_attention_plain(q, k, v, scale=sc),
        ops.flash_attention_lse_plain(q, k, scale=sc)), iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, is_causal=True, scale=sc, enable_gqa=True)
    lib_fwd = time_ms("SDPA bf16 forward", sdpa)
    lib_both = time_ms("SDPA bf16 forward and backward", lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot))
    pairs = cs * (cs + 1) // 2
    fwd_flops = 4 * cd * pairs * cb * ch
    fwd_bytes = 2 * (2 * cb * cs * ch * cd + 2 * cb * cs * ckh * cd) + 4 * cb * ch * cs
    fb = bound(fwd_flops, fwd_bytes, "bfloat16")
    rows["flash_attention"]["qwen3_train_call"] = dict(
        ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd, **fb,
        tflops=fwd_flops / fwd_ms / 1e9, variant=K1.route(bf, cd), with_lse=True)
    log(f"   K1 at {qcall} bf16, causal, with its log-sum-exp (qwen3-14b's micro-batch call "
        f"in training) [{K1.route(bf, cd)}]: kernel_ms {fwd_ms:.4f} "
        f"({fwd_flops / fwd_ms / 1e9:.1f} TFLOP/s) plain_ms {fwd_plain:.4f} library_ms "
        f"{lib_fwd:.4f} (SDPA bf16 forward, causal) bound_ms {fb['bound_ms']:.4f} "
        f"({fb['bound_by']}; {fwd_flops / 1e9:.2f} GFLOP, {fwd_bytes / 1e6:.1f} MB)")
    bwd = lambda: K1.flash_attention_bwd(q, k, v, o, lse, do, scale=sc)   # noqa: E731
    ms = time_ms("K1-bwd bf16", bwd)
    plain_ms = time_ms("K1-bwd bf16 plain", lambda: ops.flash_attention_bwd_bf16_plain(
        q, k, v, o, lse, do, scale=sc), iters=5, warmup=1)
    split = kernel_spans(bwd, K1.BWD_BF16_KERNELS)
    flops = 10 * cd * pairs * cb * ch                 # five products over the kept pairs
    nbytes = 2 * (4 * cb * cs * ch * cd + 4 * cb * cs * ckh * cd) + 4 * cb * ch * cs
    rows["flash_attention_bwd_bf16"] = r = dict(
        name="flash_attention_bwd_bf16", route="cuda",
        variant="bf16 wgmma on TMA-fed 64-row tiles, GQA summed in the CTA",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:63", max_abs_err=k1_err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_both - lib_fwd, library_fwd_and_bwd_ms=lib_both,
        library_fwd_ms=lib_fwd, kernel_split_ms=split, **bound(flops, nbytes, "bfloat16"),
        tflops=flops / ms / 1e9, repeat_equal=True, **bwd_ptxas["k1_bf16"])
    log(f"   K1-bwd at {qcall} bf16, causal (qwen3-14b's micro-batch call in training) "
        f"[bf16 wgmma; {' '.join(f'{k_} {v_}' for k_, v_ in bwd_ptxas['k1_bf16'].items())}]"
        f": kernel_ms {ms:.4f} ({r['tflops']:.1f} TFLOP/s) plain_ms {plain_ms:.4f} library_ms "
        f"{r['library_ms']:.4f} (SDPA bf16 with enable_gqa: forward and backward "
        f"{lib_both:.4f} less forward {lib_fwd:.4f}) bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); device ms a call "
        f"by kernel (profiler): " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in split.items()))
    del q, k, v, do, o, lse, qt, kt, vt, dot

    # K1-bwd's bf16 route at the other train calls at the production dtypes,
    # each held to the rounding plain version once and timed beside its
    # bound and the library's bf16 backward: SDPA's where one SDPA call
    # computes the same function (no softcap, no window that binds), else
    # compiled flex_attention's
    ss, sf = TRAIN["seq"], SEAMLESS["frames"]
    calls = {"rg_train_call": ((TRAIN["batch"], ss, RG["h"], RG["kh"], RG["d"]),
                               {"window": RG["window"]}),   # window 2048 > S: SDPA causal
             "seamless_encoder_call": ((TRAIN["batch"], sf, SEAMLESS["h"], SEAMLESS["kh"],
                                        SEAMLESS["d"]), {"causal": False}),
             "seamless_self_call": ((TRAIN["batch"], ss, SEAMLESS["h"], SEAMLESS["kh"],
                                     SEAMLESS["d"]), {}),
             "seamless_cross_call": ((TRAIN["batch"], ss, SEAMLESS["h"], SEAMLESS["kh"],
                                      SEAMLESS["d"]), {"causal": False, "skv": sf}),
             "gemma2_local_call": ((1, BF16_TRAIN["gemma2-9b"]["seq"], GEMMA["h"], GEMMA["kh"],
                                    GEMMA["d"]), {"window": GEMMA["window"],
                                                  "softcap": GEMMA["softcap"],
                                                  "scale": GEMMA["scale"]}),
             "gemma2_global_call": ((1, BF16_TRAIN["gemma2-9b"]["seq"], GEMMA["h"], GEMMA["kh"],
                                     GEMMA["d"]), {"softcap": GEMMA["softcap"],
                                                   "scale": GEMMA["scale"]}),
             # the new production-dtype steps' micro-batch calls: starcoder2-15b
             # (a group of 12), qwen2.5-32b (2 sequences), internvl2-1b (256
             # frontend and 256 text positions: a group of 7 at D 64),
             # qwen3-moe-30b-a3b (8), deepseek-v3-671b's MLA (q, k 192 and v
             # 128 zero-padded to D 256, scale 192^-0.5)
             "starcoder2_train_call": ((4, ss, 48, 4, 128), {}),
             "qwen2_5_train_call": ((2, ss, 40, 8, 128), {}),
             "internvl2_train_call": ((4, 2 * ss, 14, 2, 64), {}),
             "qwen3_moe_train_call": ((4, ss, QMOE["h"], QMOE["kh"], QMOE["d"]), {}),
             "mla_train_call": ((2, ss, MLA_CALL["h"], MLA_CALL["h"], MLA_CALL["d"]),
                                {"dqk": MLA_CALL["dqk"], "dv": MLA_CALL["dv"],
                                 "scale": MLA_CALL["dqk"] ** -0.5})}
    for call_name, ((cb, cs, ch, ckh, cd), kw) in calls.items():
        r[call_name] = k1_bwd_call(call_name, cb, cs, ch, ckh, cd, rand, bf16_route=True, **kw)

    # ---- K1-bwd on bf16 at head_dim 16 (the smoke configs' width): the
    # 3xTF32 kernels on bf16 (widened as staged, rounded once on the store),
    # against the plain backward on the same inputs (fp32 inside, rounded
    # once) at BF16_GRAD_TOL; the smoke step's calls and the 32-row tiles'
    # edges, KH == H too (dK and dV through the workspace all the same)
    sm = (BF16_SMOKE_RUN["batch"], BF16_SMOKE_RUN["seq"])
    d16_cases = [((*sm, 4, 2, 16), {}),                                  # qwen3's smoke call
                 ((*sm, 4, 1, 16), {"window": 32}),                      # recurrentgemma's local
                 ((*sm, 4, 2, 16), {"window": 32, "softcap": 50.0, "scale": 0.0625}),  # gemma2's
                 ((*sm, 4, 2, 16), {"causal": False, "skv": 8}),         # seamless's cross call
                 ((2, 77, 4, 4, 16), {"causal": False}),                 # ragged S, KH == H
                 ((1, 300, 2, 1, 16), {"window": 45})]                   # window inside a tile
    d16_err = 0.0
    for (cb, cs, ch, ckh, cd), kw in d16_cases:
        kw = dict(kw)
        cskv = kw.pop("skv", cs)
        q, do = rand(cb, cs, ch, cd), rand(cb, cs, ch, cd)
        k, v = rand(cb, cskv, ckh, cd), rand(cb, cskv, ckh, cd)
        kw = {"causal": True, "scale": cd ** -0.5, **kw}
        before = dict(K1.flash_attention_bwd.launches_by_route)
        o, lse = K1.flash_attention(q, k, v, return_lse=True, **kw)
        got = K1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = K1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        want = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        shown = {k_: v_ for k_, v_ in kw.items() if k_ != "scale"}
        if cskv != cs:
            shown["S_kv"] = cskv
        name = f"K1-bwd bf16 {(cb, cs, ch, ckh, cd)} {shown} [{K1.bwd_route(bf, cd)}]"
        if K1.flash_attention_bwd.launches_by_route != {**before, "tf32x3": before["tf32x3"] + 2}:
            raise AssertionError(f"{name}: launches by route "
                                 f"{K1.flash_attention_bwd.launches_by_route}, before {before}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}: two calls differ")
        check_close(f"K1 {(cb, cs, ch, ckh, cd)} {shown} [tf32x3] lse", lse,
                    ops.flash_attention_lse_plain(q, k, **kw), LSE_TOL)
        for g_, x_, w_ in zip(("dq", "dk", "dv"), got, want):
            err = check_close(f"{name} {g_}", x_, w_, BF16_GRAD_TOL,
                              BF16_GRAD_TOL * max(float(w_.float().abs().max()), 1e-30))
            if (cb, cs, ch, ckh, cd) == d16_cases[0][0]:
                d16_err = max(d16_err, err)
        del q, k, v, do, o, lse, got, again, want
    log(f"   K1-bwd bf16 at head_dim 16: two calls of each of the {len(d16_cases)} cases equal "
        "to the bit, each on the tf32x3 route")
    rows["flash_attention_bwd"]["bf16_d16_call"] = dict(
        k1_bwd_call("bf16_d16_call", *d16_cases[0][0], rand, bf16_route=False),
        max_abs_err=d16_err, **bwd_ptxas["k1_d16"])

    # ---- K3-bwd's bf16 route: mamba2's train call and the fp32 route's edges
    def ssd_inputs(b, s, h, p, n, g, with_h0):
        x = (rand(b, s, h, p, dtype=torch.float32) * 0.5).to(bf)
        dt = F.softplus(rand(b, s, h, dtype=torch.float32) - 2.0)
        a = -torch.exp(rand(h, dtype=torch.float32) * 0.5 + 1.0)
        bm, cm = ((rand(b, s, g, n, dtype=torch.float32) * 0.3).to(bf) for _ in range(2))
        h0 = rand(b, h, p, n, dtype=torch.float32) * 0.2 if with_h0 else None
        return x, dt, a, bm, cm, h0

    tb, ts = BF16_TRAIN["mamba2-2.7b"]["batch"], TRAIN["seq"]
    mh, mp, mn = 80, 64, 128          # mamba2-2.7b's heads, head_dim and state
    cases = [((tb, ts, mh, mp, mn, 1), False, False),   # the train call
             ((tb, ts, mh, mp, mn, 1), True, True),     # with h0 and d(final state)
             ((2, 200, 4, 16, 32, 2), True, True),      # ragged S, G < H
             ((1, 37, 2, 80, 128, 2), True, False),     # under one chunk, two p tiles
             ((1, 64, 3, 64, 64, 3), False, True),      # G == H, one whole chunk, N 64
             ((2, 150, 16, 8, 16, 1), False, True),     # the reduced config
             ((1, 70, 2, 20, 12, 1), True, True),       # P, N off 8: one-value staging
             ((2, 200, 4, 128, 64, 2), True, True)]     # wgmma: ragged S, G 2, P 128, N 64
    k3_err = 0.0
    for (cb, cs, ch, cp, cn, cg), with_h0, with_ds in cases:
        x, dt, a, bm, cm, h0 = ssd_inputs(cb, cs, ch, cp, cn, cg, with_h0)
        dy = rand(cb, cs, ch, cp)
        ds = rand(cb, ch, cp, cn, dtype=torch.float32) if with_ds else None
        route = K3.bwd_route(bf, cp, cn)
        before = dict(K3.ssd_scan_bwd.launches_by_route)
        got = K3.ssd_scan_bwd(x, dt, a, bm, cm, h0, dy, ds)
        again = K3.ssd_scan_bwd(x, dt, a, bm, cm, h0, dy, ds)
        want = ops.ssd_scan_bwd_plain(x, dt, a, bm, cm, h0, dy, ds)
        torch.cuda.synchronize()
        name = f"K3-bwd {(cb, cs, ch, cp, cn, cg)} bf16 h0={with_h0} dstate={with_ds} [{route}]"
        if K3.kernel_bwd_route(bf, cp, cn) != route or K3.ssd_scan_bwd.launches_by_route != {
                **before, route: before[route] + 2}:
            raise AssertionError(f"{name}: launches by route {K3.ssd_scan_bwd.launches_by_route}, "
                                 f"before {before}; the library's route "
                                 f"{K3.kernel_bwd_route(bf, cp, cn)}")
        if (got[5] is None) != (h0 is None):
            raise AssertionError(f"{name}: dh0 given without h0, or missing with it")
        if not all(torch.equal(u, w) for u, w in zip(got, again) if u is not None):
            raise AssertionError(f"{name}: two calls differ")
        for g_, x_, w_ in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want):
            if w_ is None:
                continue
            t_ = BF16_GRAD_TOL if w_.dtype == bf else GRAD_TOL
            err = check_close(f"{name} {g_} [{str(w_.dtype)[6:]}]", x_, w_, t_,
                              t_ * max(float(w_.float().abs().max()), 1e-30))
            if (cb, cs, ch, cp, cn, cg) == cases[0][0] and not with_h0:
                k3_err = max(k3_err, err)
        del x, dt, a, bm, cm, h0, dy, ds, got, again, want
    log(f"   K3-bwd bf16: two calls of each of the {len(cases)} cases equal to the bit, each "
        "on its route")
    x, dt, a, bm, cm, _ = ssd_inputs(tb, ts, mh, mp, mn, 1, False)
    dy = rand(tb, ts, mh, mp)
    bwd = lambda: K3.ssd_scan_bwd(x, dt, a, bm, cm, None, dy, None)   # noqa: E731
    ms = time_ms("K3-bwd bf16", bwd)
    plain_ms = time_ms("K3-bwd bf16 plain", lambda: ops.ssd_scan_bwd_plain(
        x, dt, a, bm, cm, None, dy, None), iters=5, warmup=1)
    passes = kernel_spans(bwd, K3.BWD_WGMMA_KERNELS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = K3.wgmma_bwd_plan(tb, ts, mh, mp, mn, sms=sms, query=True)
    L = K3.CHUNK
    chunk_heads = tb * mh * -(-ts // L)
    tri = L * (L + 1) // 2
    flops = 2 * chunk_heads * (tri * (3 * mn + 2 * mp) + 5 * L * mp * mn)
    # the bf16 products the route issues, every fp32 operand in two parts:
    # a chunk and head, the scores both ways (dy x^T, C B^T), U = B dS^T, dx,
    # dG^T C, x dS, dG B, dy S, and the state walks' two updates, over whole
    # 64 x 64 tiles
    issued_flops = 2 * chunk_heads * (4 * L * L * mp + 6 * L * L * mn + 10 * L * mp * mn)
    # x, dy, dx and b, c, db, dc in bf16; dt, ddt, a, da in fp32
    nbytes = 2 * (3 * x.numel() + 4 * bm.numel()) + 4 * (2 * dt.numel() + 2 * mh)
    issued = bound(issued_flops, nbytes, "bfloat16")
    kernels = {k_: v_ for k_, v_ in plan.items() if isinstance(v_, dict)}
    rows["ssd_scan_bwd_bf16"] = r = dict(
        name="ssd_scan_bwd_bf16", route="cuda", variant=K3.bwd_route(bf, mp, mn),
        source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan.py:56", max_abs_err=k3_err, ms=ms,
        plain_ms=plain_ms, library_ms=None, **bound(flops, nbytes, "bfloat16"),
        bound_issued_bf16_ms=issued["bound_ms"], tflops=flops / ms / 1e9,
        tflops_issued=issued_flops / ms / 1e9, kernel_split_ms=passes, plan=plan,
        repeat_equal=True, **bwd_ptxas["k3_wgmma"])
    log(f"   K3-bwd at ({tb},{ts},{mh},{mp},{mn},1) bf16, no h0, no dstate (mamba2-2.7b's "
        f"train call; route {r['variant']}; "
        f"{' '.join(f'{k_} {v_}' for k_, v_ in bwd_ptxas['k3_wgmma'].items())}; "
        f"{plan['slices']} slices of {plan['heads_per_cta']} heads; "
        + "; ".join(f"{k_[:-7]} {v_['ctas']} CTAs of {v_['threads']} threads, "
                    f"{v_['smem'] / 1024:.1f} KB, {v_['ctas_per_sm']} an SM, "
                    f"{v_['waves']:.2f} waves" for k_, v_ in kernels.items())
        + f"): kernel_ms {ms:.4f} ({r['tflops']:.2f} TFLOP/s; {r['tflops_issued']:.2f} issued) "
        f"plain_ms {plain_ms:.4f} library_ms none (no PyTorch call computes it) bound_ms "
        f"{r['bound_ms']:.4f} ({r['bound_by']} at the bf16 rate; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB; the {issued_flops / 1e9:.2f} GFLOP it issues "
        f"{issued['bound_ms']:.4f}); device ms a call by kernel (profiler): "
        + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in passes.items()))
    del x, dt, a, bm, cm, dy


def k1_bwd_call(name, b, s, h, kh, d, rand, *, bf16_route, skv=None, causal=True, window=0,
                softcap=None, scale=None, dqk=None, dv=None):
    """K1-bwd on bf16 at one train call (k and v of S_kv rows, unmasked,
    where `skv` is given): held once to its plain version (the bf16 route's
    with its roundings, or, on the 3xTF32 route at head_dim 16, the plain
    backward rounded once) at BF16_GRAD_TOL of each gradient's max, then
    timed beside its bound (the bf16 rate: the inputs' type) and the
    library's bf16 backward, forward and backward less forward: SDPA's
    where one SDPA call computes the same function (no softcap, and a
    window only where it does not bind, S <= window), else compiled
    `flex_attention`'s (``flex_attention_call``: the cap as its score_mod,
    the causal window as a block mask), its gradients first held to the
    plain version's at 2e-2 of each gradient's max, as K1's flex row holds
    its output. With `dqk` and `dv` (MLA's call) q and k hold `dqk` and v
    and dO `dv` nonzero columns of head_dim `d`, as ``nn/mla.py`` pads
    them: the padded columns of dq, dk and dv must come back exactly 0,
    the bound counts the unpadded work and SDPA runs on the unpadded
    inputs. Returns the call's fields."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    skv = skv or s
    dqk, dv = dqk or d, dv or d
    kw = dict(scale=scale or dqk ** -0.5, causal=causal, window=window, softcap=softcap)

    def padded(x, width):
        return torch.nn.functional.pad(x[..., :width], (0, d - width))
    q, do = padded(rand(b, s, h, d), dqk), padded(rand(b, s, h, d), dv)
    k, v = padded(rand(b, skv, kh, d), dqk), padded(rand(b, skv, kh, d), dv)
    o, lse = K1.flash_attention(q, k, v, return_lse=True, **kw)
    got = K1.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    plain = ops.flash_attention_bwd_bf16_plain if bf16_route else ops.flash_attention_bwd_plain
    want = plain(q, k, v, o, lse, do, **kw)
    route = K1.bwd_route(q.dtype, d)
    err = max(check_close(f"K1-bwd {name} {(b, s, h, kh, d)} S_kv {skv} {g_} [{route}]", x_, w_,
                          BF16_GRAD_TOL, BF16_GRAD_TOL * max(float(w_.float().abs().max()), 1e-30))
              for g_, x_, w_ in zip(("dq", "dk", "dv"), got, want))
    pad_max = max(float(x_[..., w:].abs().max()) if w < d else 0.0
                  for x_, w in zip(got, (dqk, dqk, dv)))
    if pad_max != 0.0:
        raise AssertionError(f"K1-bwd {name}: the padded columns of dq, dk, dv reach {pad_max}")
    del got
    ms = time_ms(f"K1-bwd {name}", lambda: K1.flash_attention_bwd(q, k, v, o, lse, do, **kw))
    pairs = int(ops._mask(s, causal, window, "cpu", skv).sum())
    # five products over the kept pairs: S = Q K^T, dQ, dK at dqk; dP, dV at dv
    flops = 2 * (3 * dqk + 2 * dv) * pairs * b * h
    # q, dq, k, dk at dqk; o, dO, v, dv at dv; the lse fp32
    nbytes = 2 * (2 * (dqk + dv) * b * s * h + 2 * (dqk + dv) * b * skv * kh) + 4 * b * h * s
    out = dict(shape=[b, s, h, kh, d], s_kv=skv, causal=causal, window=window, softcap=softcap,
               route=route, ms=ms, max_abs_err=err, **bound(flops, nbytes, "bfloat16"),
               tflops=flops / ms / 1e9, gflop=flops / 1e9, mb=nbytes / 1e6)
    if (dqk, dv) != (d, d):
        flops_p = 10 * d * pairs * b * h
        out.update(dqk=dqk, dv=dv, padded_max_abs=pad_max, padded_gflop=flops_p / 1e9,
                   padded_bound_ms=bound(flops_p, 2 * (4 * b * s * h * d + 4 * b * skv * kh * d)
                                         + 4 * b * h * s, "bfloat16")["bound_ms"])
    if route == "tf32x3":
        out["bound_tf32x3_ms"] = flops / PEAK_FLOPS["tf32x3"] * 1e3
    qt, kt = (x[..., :dqk].transpose(1, 2).contiguous().requires_grad_() for x in (q, k))
    vt = v[..., :dv].transpose(1, 2).contiguous().requires_grad_()
    dot = do[..., :dv].transpose(1, 2).contiguous()
    binds = 0 < window < s
    if not softcap and not binds:
        library = "SDPA bf16"
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, is_causal=causal, scale=kw["scale"], enable_gqa=kh < h)
    else:
        if not causal and binds:
            raise ValueError(f"{name}: no K1 train call has a window without the causal mask")
        library = "flex_attention bf16, compiled"
        w = window if binds else skv
        keep = ((lambda b_, h_, qi, ki: (qi >= ki) & (qi - ki < w)) if causal else
                (lambda b_, h_, qi, ki: ki >= 0))
        flex = flex_attention_call(qt, scale=kw["scale"], softcap=softcap, mask_mod=keep,
                                   q_len=s, kv_len=skv)
        lib = lambda: flex(kt, vt)   # noqa: E731
        for g_, x_, w_ in zip(("dq", "dk", "dv"), torch.autograd.grad(lib(), (qt, kt, vt), dot),
                              want):
            check_close(f"   its library, flex_attention, {g_}", x_.transpose(1, 2), w_, 2e-2,
                        2e-2 * max(float(w_.float().abs().max()), 1e-30))
    del want
    lib_fwd = time_ms(f"{library} forward {name}", lib)
    lib_both = time_ms(f"{library} forward and backward {name}",
                       lambda: torch.autograd.grad(lib(), (qt, kt, vt), dot))
    out.update(library_ms=lib_both - lib_fwd, library=library, library_fwd_and_bwd_ms=lib_both,
               library_fwd_ms=lib_fwd)
    del qt, kt, vt, dot
    widths = f" (q, k {dqk}, v {dv}: zero-padded; padded columns 0)" if "dqk" in out else ""
    log(f"   K1-bwd bf16 at {name} {(b, s, h, kh, d)}{widths}, S_kv {skv}, causal {causal}, window "
        f"{window}, softcap {softcap} [{route}]: kernel_ms {ms:.4f} ({out['tflops']:.1f} TFLOP/s) "
        f"bound_ms {out['bound_ms']:.4f} ({out['bound_by']}; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB" + (f"; {out['bound_tf32x3_ms']:.4f} at the 3xTF32 rate"
                                    if route == "tf32x3" else "")
        + f") library_ms {out['library_ms']:.4f} ({library}: forward and backward "
        f"{lib_both:.4f} less forward {lib_fwd:.4f})")
    del q, k, v, do, o, lse
    return out


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
    for kernel, start, end, _ in device_events(prof):
        for name in names:
            if name in kernel:
                spans[name].append((start, end))
    return {name: union_ms(found) / len(found) * max(1, round(len(found) / n)) if found else 0.0
            for name, found in spans.items()}


def k3_bwd_route(K3, dtype, p, n):
    """K3-bwd's route for (dtype, P, N) in the checkout `K3` comes from;
    before the bf16 wgmma route the rule took the dtype alone (another
    checkout's K3, as ``tools/bwd_timing.py`` times one)."""
    try:
        return K3.bwd_route(dtype, p, n)
    except TypeError:
        return K3.bwd_route(dtype)


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
    from repro_torch.nn.moe import expert_choices

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
    with expert_choices() as rec:
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
    (``nn.moe.expert_choices``), which is held to `rel`. With a padded vocab
    (tp > 1) the real vocab's logits are compared, the padded ids' -1e30
    checked apart."""
    from repro_torch.kernels import ops
    from repro_torch.nn.moe import expert_choices

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
    with expert_choices() as rec:
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
        with plain(), expert_choices() as rec_free:
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
        forced = expert_choices(rec)
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


class _BackwardRangeOpen(torch.autograd.Function):
    """Identity on an MoE call's output. Its backward, the first of the
    call's backward, unpacks the tensor it saved (under remat "full" the
    block's recompute runs there, before the range opens) and opens the
    profiler range "moe_backward" that ``_BackwardRangeClose`` closes."""

    @staticmethod
    def forward(ctx, y, box):
        ctx.save_for_backward(y)
        ctx.box = box
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        _ = ctx.saved_tensors   # under remat the unpack runs the block's recompute
        ctx.box["range"] = torch.profiler.record_function("moe_backward")
        ctx.box["range"].__enter__()
        return dy, None


class _BackwardRangeClose(torch.autograd.Function):
    """Identity on an MoE call's input; its backward, the last of the
    call's backward (every path of the call meets there), closes the range."""

    @staticmethod
    def forward(ctx, x, box):
        ctx.box = box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        opened = ctx.box.pop("range", None)
        if opened is not None:
            opened.__exit__(None, None, None)
        return dx, None


@contextlib.contextmanager
def annotated_layers():
    """The LM's MoE calls and MLA decode calls inside profiler ranges named
    "moe" and "mla_decode" (``torch.profiler.record_function``), so that
    ``device_breakdown`` can group their kernels; for measurement only.
    Autograd runs an MoE call's backward on its own thread, outside the
    forward's range: the range "moe_backward" spans it, opened and closed
    by two identity Functions on the call's output and input."""
    from repro_torch.models import lm

    def named(name, fn):
        def run(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return run
    real = lm.moe, lm.mla_decode
    moe_call = named("moe", lm.moe)

    def moe(cfg, p, x, *args, **kw):
        box = {}
        y, aux = moe_call(cfg, p, _BackwardRangeClose.apply(x, box), *args, **kw)
        return _BackwardRangeOpen.apply(y, box), aux
    lm.moe, lm.mla_decode = moe, named("mla_decode", lm.mla_decode)
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


def device_events(prof):
    """(name, start us, end us, whether a user annotation) of every device
    event of a profiler trace, read from its Kineto events: what
    ``prof.events()`` lists for the device, without building the tree of
    the CPU ops, which takes seconds for a train step's tens of thousands."""
    cuda, found = torch.autograd.DeviceType.CUDA, prof.profiler.kineto_results
    t0 = found.trace_start_ns()   # integer ns: the times keep their ns in a float
    return [(e.name(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
             e.is_user_annotation()) for e in found.events() if e.device_type() == cuda]


def device_breakdown(prof, n):
    """Device time per call from a profiler trace, grouped: the port's
    kernels (K1 either route, K3 any route and the 3xTF32 route's three
    passes, K2 its split and combine passes, K1-bwd its four kernels, K3-bwd
    its five), GEMMs (cuBLAS / CUTLASS), and everything else; and
    the number of device kernels per call. A group's time, and "busy" over all of them, count
    each instant once: K2's combine is launched while its split pass runs.
    Under ``annotated_layers`` the kernels inside an MoE call, its forward
    (with the remat recompute's) and its backward ("moe_backward", also
    reported alone), form the groups "moe_gemm" (its GEMMs: router, bmm,
    shared experts) and "moe_dispatch" (the rest: softmax, sort,
    searchsorted, gathers, the combine, their gradients), and those inside
    MLA's absorbed decode the group "mla_decode"; a port kernel keeps its
    own group wherever it runs."""
    import bisect
    events = device_events(prof)
    marks = sorted((start, end, name) for name, start, end, note in events
                   if note and name in ("moe", "moe_backward", "mla_decode"))
    starts = [m[0] for m in marks]

    def mark_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return marks[i][2] if i >= 0 and t < marks[i][1] else None

    spans = {g: [] for g in ("K1", "K1-bwd", "K2", "K3", "K3-bwd", "K4", "K4-bwd", "gemm",
                             "other")}
    if marks:
        spans.update({g: [] for g in ("moe_gemm", "moe_dispatch", "mla_decode")})
    kernels, dispatch, moe_backward = 0, {}, []
    for full_name, start, end, note in events:
        if note:
            continue
        kernels += 1
        name = full_name.lower()
        mark = mark_of(start) if marks else None
        is_gemm = any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas"))
        if "flash_tf32x3_kernel" in name or "flash_wgmma_kernel" in name:
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
        elif mark in ("moe", "moe_backward"):
            g = "moe_gemm" if is_gemm else "moe_dispatch"
            if not is_gemm:
                dispatch[full_name] = dispatch.get(full_name, 0.0) + (end - start) / 1e3 / n
            if mark == "moe_backward":
                moe_backward.append((start, end))
        elif mark == "mla_decode":
            g = "mla_decode"
        elif is_gemm:
            g = "gemm"
        else:
            g = "other"
        spans[g].append((start, end))
    groups = {"busy": union_ms([s for found in spans.values() for s in found]) / n}
    groups.update({g: union_ms(found) / n for g, found in spans.items()})
    if marks:
        groups["moe_backward"] = union_ms(moe_backward) / n
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
    from repro_torch.nn.moe import expert_choices

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
    with expert_choices() as rec_cpu:
        o_cpu, _ = bundle.prefill(cpu, b_cpu, max_len=max_len, dtype=torch.float32)
        t_cpu = greedy_generate(bundle, cpu, b_cpu, 12, max_len, torch.float32)
    with expert_choices() as rec_gpu:
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
    """A kernel with no backward kernel for its inputs (K2) refuses an input
    that requires a gradient, rather than return a tensor with no grad_fn;
    K1 in bf16 at head_dim 16 (its backward on K1-bwd's 3xTF32 kernels,
    counted under that route, its gradients within BF16_GRAD_TOL of the
    plain backward's), at 64, 128 and 256, K3 in bf16 (its bf16 backward
    routes), K3 in fp32 and K1 in fp32 with k and v of a length of their own
    return tensors with a grad_fn."""
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    log("== grad guards: K2 raises under autograd on the card; K1 bf16 at head_dim 16 "
        "(3xTF32 backward), 64/128/256, K3 bf16 and fp32, K1 fp32 with k and v of a length of "
        "their own record a graph")
    dev = torch.device("cuda")
    q16 = torch.randn(1, 64, 2, 16, device=dev, dtype=torch.bfloat16, requires_grad=True)
    q32 = torch.randn(1, 64, 2, 64, device=dev, requires_grad=True)
    frames = torch.randn(1, 96, 2, 64, device=dev)
    kv = torch.randn(1, 32, 2, 64, device=dev, requires_grad=True)
    x = torch.randn(1, 16, 2, 16, device=dev, requires_grad=True)
    bm = torch.randn(1, 16, 1, 16, device=dev)
    dt, a = torch.rand(1, 16, 2, device=dev), -torch.ones(2, device=dev)
    xb, bb = x.detach().bfloat16().requires_grad_(), bm.bfloat16()
    try:
        ops.decode_attention(kv[:, 0], kv, kv, torch.ones(1, dtype=torch.int32, device=dev))
    except NotImplementedError as e:
        log(f"   K2: NotImplementedError: {str(e)[:90]}...")
    else:
        raise AssertionError("K2 ran under autograd with no backward kernel")
    recorded = {"K1 fp32, S_kv != S": lambda: ops.flash_attention(q32, frames, frames,
                                                                  causal=False),
                "K3 fp32": lambda: ops.ssd_scan(x, dt, a, bm, bm),
                "K3 bf16": lambda: ops.ssd_scan(xb, dt, a, bb, bb)}
    for d in (16, 64, 128, 256):
        qd = q16 if d == 16 else torch.randn(1, 64, 2, d, device=dev, dtype=torch.bfloat16,
                                             requires_grad=True)
        recorded[f"K1 bf16 at head_dim {d}"] = lambda qd=qd: ops.flash_attention(qd, qd, qd)
    for name, call in recorded.items():
        out = call()
        if out.grad_fn is None:
            raise AssertionError(f"{name} under autograd returned a tensor with no grad_fn")
        log(f"   {name}: grad_fn {type(out.grad_fn).__name__}")
    # K1 bf16 at head_dim 16 through its backward: one K1-bwd call on its
    # 3xTF32 route, against the plain backward on the same bf16 inputs
    do = torch.randn_like(q16)
    by_route = dict(K1.flash_attention_bwd.launches_by_route)
    (got,) = torch.autograd.grad(ops.flash_attention(q16, q16, q16), (q16,), do)
    if K1.flash_attention_bwd.launches_by_route != {**by_route,
                                                    "tf32x3": by_route["tf32x3"] + 1}:
        raise AssertionError(f"K1 bf16 at head_dim 16's backward launched "
                             f"{K1.flash_attention_bwd.launches_by_route}, before {by_route}")
    o, lse = K1.flash_attention(q16.detach(), q16.detach(), q16.detach(), return_lse=True)
    want = sum(ops.flash_attention_bwd_plain(*(q16.detach(),) * 3, o, lse, do)).to(torch.bfloat16)
    err = check_close("K1 bf16 at head_dim 16: dq + dk + dv", got, want, BF16_GRAD_TOL,
                      BF16_GRAD_TOL * float(want.float().abs().max()))
    log(f"   K1 bf16 at head_dim 16 under autograd: one K1-bwd launch on tf32x3, its gradient "
        f"{err:.2e} from the plain backward's at most (BF16_GRAD_TOL {BF16_GRAD_TOL:g} of its "
        "max)")
    with torch.no_grad():
        if ops.flash_attention(q16, q16, q16).grad_fn is not None:
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


@contextlib.contextmanager
def plain_bf16_pairs(ops):
    """The model's calls of K1 and K3 taken by their plain versions paired
    as the kernels pair them on the bf16 routes, for a comparison only: K1
    by ``flash_attention_plain`` (and its log-sum-exp) with
    ``flash_attention_bwd_bf16_plain`` (P and dX rounded to bf16, as the
    bf16 K1-bwd rounds them) as its backward; K3 by ``ssd_scan_plain`` at
    the kernel's chunk with ``ssd_scan_bwd_plain`` as its backward."""
    from repro_torch.kernels import ssd_scan as K3

    class PlainK1(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, kw):
            o = ops.flash_attention_plain(q, k, v, **kw)
            lse = ops.flash_attention_lse_plain(q, k, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.kw = kw
            return o

        @staticmethod
        def backward(ctx, do):
            return (*ops.flash_attention_bwd_bf16_plain(*ctx.saved_tensors, do.contiguous(),
                                                        **ctx.kw), None)

    class PlainK3(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, a, b, c, h0):
            y, state = ops.ssd_scan_plain(x, dt, a, b, c, chunk=K3.CHUNK, h0=h0)
            ctx.save_for_backward(x, dt, a, b, c, h0)
            return y, state

        @staticmethod
        def backward(ctx, dy, dstate):
            saved = ctx.saved_tensors   # unpacked once: remat's checkpoint allows no more
            dy = torch.zeros_like(saved[0]) if dy is None else dy.contiguous()
            return ops.ssd_scan_bwd_plain(*saved, dy, dstate)

    def ssd(x, dt, a, b, c, *, chunk=128, h0=None, return_state=False):
        y, state = PlainK3.apply(x, dt, a, b, c, h0)
        return (y, state) if return_state else y
    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention = lambda q, k, v, **kw: PlainK1.apply(q, k, v, kw)
    ops.ssd_scan = ssd
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = saved


def leaf_distances(grads, ref, tol=GRAD_TOL) -> dict:
    """Each gradient leaf's distance from the reference's: the largest
    |g - g_ref| / (tol (max |g_ref| + |g_ref|)) over its elements, in fp32,
    above 1 where the leaf misses `tol` (GRAD_TOL) of its max."""
    out = {}
    for n, r in ref.items():
        r = r.float()
        bar = tol * (float(r.abs().max()) + r.abs())
        out[n] = float(((grads[n].float() - r).abs() / bar.clamp_min(1e-38)).max())
    return out


def fp64_verdict(got, plain, ref, tol=GRAD_TOL) -> dict:
    """The gradient leaves `got` (through kernels) against `ref` (fp64
    versions), beside the same leaves `plain` (plain versions): a leaf
    fails where it is beyond `tol` (GRAD_TOL) of its max from `ref` and
    more than FP64_MARGIN times as far as the plain leaf. Returns the
    failures (name, distance, plain's distance), the leaf nearest to
    failing, and the farthest leaf of each run."""
    d_got, d_plain = leaf_distances(got, ref, tol), leaf_distances(plain, ref, tol)
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
    K2. The dense LM and the MoE LM run K1 and K1-bwd once per layer (the
    MoE LM's first dense layers and MLA's too), and a built MTP block once
    more, outside remat: one K1 and one K1-bwd a micro-batch; RecurrentGemma K1
    and K1-bwd once per local layer, K4 and K4-bwd once per recurrent layer;
    Mamba2 K3 and K3-bwd once per layer; the encoder-decoder K1 and K1-bwd
    once per encoder layer and twice per decoder layer (self- and
    cross-attention). Each micro-batch of ``cfg.grad_accum`` runs them, and
    under remat "full" the backward runs each layer's forward again, so the
    forward kernels launch twice; so they do under "dots", whose recompute
    runs the same forward with the saved products taken from its cache: the
    kernels are ``ctypes`` calls that its policy never sees."""
    want = dict.fromkeys(("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
                          "flash_attention_bwd", "ssd_scan_bwd", "rglru_scan_bwd"), 0)
    bwd = steps * max(1, cfg.grad_accum)
    fwd = bwd * (2 if cfg.remat in ("full", "dots") else 1)
    if cfg.family in ("dense", "moe"):
        mtp = 1 if cfg.mtp_depth else 0
        want.update(flash_attention=cfg.num_layers * fwd + mtp * bwd,
                    flash_attention_bwd=(cfg.num_layers + mtp) * bwd)
    elif cfg.family == "hybrid":
        from repro_torch.models.recurrentgemma import layer_kinds
        n_rec = layer_kinds(cfg).count("rglru")
        n_att = cfg.num_layers - n_rec
        want.update(flash_attention=n_att * fwd, flash_attention_bwd=n_att * bwd,
                    rglru_scan=n_rec * fwd, rglru_scan_bwd=n_rec * bwd)
    elif cfg.family == "ssm":
        want.update(ssd_scan=cfg.num_layers * fwd, ssd_scan_bwd=cfg.num_layers * bwd)
    elif cfg.family == "encdec":
        n = cfg.enc_layers + 2 * cfg.dec_layers
        want.update(flash_attention=n * fwd, flash_attention_bwd=n * bwd)
    else:
        raise ValueError(f"no train path on the card for the {cfg.family} family")
    return want


def check_routes(cfg, dtype, want, k1, k1_bwd, k3, k3_bwd):
    """Raise unless every launch of a train run of `cfg` in `dtype` (`want`:
    ``expected_train_launches``) took its route: K1 and K1-bwd the routes
    ``route`` and ``bwd_route`` give (dtype, head_dim; MLA's padded
    head_dim), K3 and K3-bwd those of (dtype, P, N); `k1` .. `k3_bwd` are
    the launches by route."""
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.nn.mla import padded_head_dim

    def only(routes, route, n):   # n launches, all on `route`
        return {**dict.fromkeys(routes, 0), **({route: n} if n else {})}
    attends = cfg.family != "ssm"
    d = padded_head_dim(cfg) if cfg.mla else cfg.head_dim
    checks = {"K1": (k1, K1.ROUTES, attends and K1.route(dtype, d), want["flash_attention"]),
              "K1-bwd": (k1_bwd, K1.BWD_ROUTES, attends and K1.bwd_route(dtype, d),
                         want["flash_attention_bwd"]),
              "K3": (k3, K3.ROUTES, K3.route(dtype, cfg.ssm_headdim, cfg.ssm_state),
                     want["ssd_scan"]),
              "K3-bwd": (k3_bwd, K3.BWD_ROUTES,
                         k3_bwd_route(K3, dtype, cfg.ssm_headdim, cfg.ssm_state)
                         if cfg.family == "ssm" else "tf32x3", want["ssd_scan_bwd"])}
    for name, (got, routes, route, n) in checks.items():
        if got != only(routes, route, n):
            raise AssertionError(f"{name} launches by route {got}: want {n} on {route} "
                                 f"({dtype})")


# the profiler groups a train step of each family must fill, and those it
# must leave empty
TRAIN_GROUPS = {"dense": ("K1", "K1-bwd"), "hybrid": ("K1", "K1-bwd", "K4", "K4-bwd"),
                "ssm": ("K3", "K3-bwd"),
                "encdec": ("K1", "K1-bwd"), "moe": ("K1", "K1-bwd")}
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

    def tally(name, s, s_kv):
        if s_kv != s:
            key = f"{s}x{s_kv}"
            counts[name][key] = counts[name].get(key, 0) + 1

    def fwd(ctx, q, k, v, *opts):
        # the lengths kept on ctx: under remat a call's saved tensors unpack once
        ctx.lengths = (q.shape[1], k.shape[1])
        tally("flash_attention", *ctx.lengths)
        return saved[0](ctx, q, k, v, *opts)

    def bwd(ctx, do):
        tally("flash_attention_bwd", *ctx.lengths)
        return saved[1](ctx, do)
    fa.forward, fa.backward = staticmethod(fwd), staticmethod(bwd)
    try:
        yield counts
    finally:
        fa.forward, fa.backward = (staticmethod(f) for f in saved)


# the families' train parity at a few layers of full width: the layers each
# keeps
TRAIN_PARITY = {"mamba2-2.7b": dict(num_layers=3), "seamless-m4t-large-v2": TRAIN_PARITY_ENCDEC}


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
    from repro_torch.nn.mlp import relu_masks

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


def bf16_train_parity_phase(arch):
    """`arch` at BF16_TRAIN_PARITY's layers of full width at the production
    dtypes (bf16 params and compute, full remat), in one micro-batch (batch
    4 x 256 unless named: gemma2 1 x 4352, past its window): the V-trace
    loss through its kernels and their backward kernels (K1 and K1-bwd on
    the routes ``route`` and ``bwd_route`` give bf16 at its head_dim; K3 and
    K3-bwd's bf16 route; K4 and K4-bwd) against the same through their
    plain versions paired as the kernels pair them (``plain_bf16_pairs``, K4
    by ``plain_versions``), within 1e-2 relative; one step's launch counts,
    each on its route (the encoder-decoder's cross calls at S_kv != S
    counted apart, ``kv_len_calls``); and every gradient leaf against the
    plain versions' within BF16_LEAF_TOL of the leaf's max, or, where a leaf
    is farther, against the kernels taken in fp64 (``fp64_versions``; the
    rest of the model bf16): within BF16_LEAF_TOL of its max of fp64, or no
    farther than FP64_MARGIN times the plain versions are
    (``fp64_verdict``). The plain and fp64 runs replay the kernel run's
    ReLU masks (``relu_masks``; seamless's MLPs) and expert choices
    (``nn.moe.expert_choices``; the MoE layers). Under remat
    "full" each MoE call runs again in the backward, the layers in reverse
    order: the recompute must choose the forward's experts, and each run
    must make as many MoE calls as the kernel run."""
    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import train
    from repro_torch.models.lm import layer_plan
    from repro_torch.nn.mlp import relu_masks
    from repro_torch.nn.moe import expert_choices

    t0 = time.perf_counter()
    over = dict(BF16_TRAIN_PARITY[arch])
    b, s = over.pop("batch", TRAIN["batch"]), over.pop("seq", TRAIN["seq"])
    run = train.setup(arch, batch=b, seq=s, steps=1, device="cuda", grad_accum=1,
                      **PRODUCTION, **over)
    cfg = run.cfg
    frames = f" over {cfg.frontend_tokens} frames" if cfg.family == "encdec" else ""
    log(f"== train parity: {cfg.name} at {over}, full width, bf16 params and compute, remat "
        f"full, batch {b} x seq {s}{frames}: the kernels and their backward kernels against "
        "their plain versions, and against fp64 where the plain versions sit farther")
    params = run.bundle.init(run.seed, device=run.device).requires_grad_(True)
    if cfg.tie_embeddings:
        live_table(params, cfg)
    named = dict(params.named_parameters())
    batch = run.batch_at(0)
    loss_fn = make_vtrace_loss(run.bundle)
    ops.reset_launch_counts()
    with kv_len_calls(K1) as kv_calls, relu_masks() as masks, expert_choices() as experts:
        loss, _ = loss_fn(params, batch)
        got = param_grads(loss, named)
    counts = ops.launch_counts()
    want_counts = expected_train_launches(cfg, 1)
    if counts != want_counts:
        raise AssertionError(f"launches {counts} != expected {want_counts}")
    n_moe = sum(spec.moe for spec in layer_plan(cfg)) if cfg.family == "moe" else 0
    mtp = 1 if cfg.family == "moe" and cfg.mtp_depth else 0   # its block: no remat
    # "dots" recomputes the layer as "full" does, its router product saved
    again = n_moe if cfg.remat in ("full", "dots") else 0
    if len(experts) != n_moe + mtp + again:
        raise AssertionError(f"{len(experts)} MoE calls, want {n_moe + mtp + again}")
    # call order: the layers' forward, the MTP block's, then the recompute,
    # last layer first
    for i in range(again):
        if not torch.equal(experts[i]["idx"], experts[-1 - i]["idx"]):
            raise AssertionError(f"MoE layer {i}: the backward's recompute chose other experts "
                                 "than the forward")
    routes = {"K1": dict(K1.flash_attention.launches_by_route),
              "K1-bwd": dict(K1.flash_attention_bwd.launches_by_route),
              "K3": dict(K3.ssd_scan.launches_by_route),
              "K3-bwd": dict(K3.ssd_scan_bwd.launches_by_route)}
    check_routes(cfg, torch.bfloat16, counts, *routes.values())
    want_kv = {}
    if cfg.family == "encdec":
        key = f"{s}x{cfg.frontend_tokens}"
        want_kv = {"flash_attention": {key: 2 * cfg.dec_layers},   # remat: each forward twice
                   "flash_attention_bwd": {key: cfg.dec_layers}}
    if {k_: v_ for k_, v_ in kv_calls.items() if v_} != want_kv:
        raise AssertionError(f"K1 calls at S_kv != S {kv_calls}, want {want_kv}")
    with plain_bf16_pairs(ops), plain_versions(ops, k1=False, k4=True), relu_masks(masks), \
            expert_choices(experts) as replayed:
        loss_p, _ = loss_fn(params, batch)
        want = param_grads(loss_p, named)
    if ops.launch_counts() != counts:
        raise AssertionError(f"the plain runs launched a kernel: {ops.launch_counts()}")
    check_close("loss", loss.detach(), loss_p.detach(), 1e-2, 1e-2 * abs(float(loss_p)))
    d_plain = leaf_distances(got, want, BF16_LEAF_TOL)
    with fp64_versions(ops), relu_masks(masks), expert_choices(experts) as replayed_fp64:
        ref = param_grads(loss_fn(params, batch)[0], named)
    if not replayed["calls"] == replayed_fp64["calls"] == len(experts):
        raise AssertionError(f"MoE calls: kernels {len(experts)}, plain {replayed['calls']}, "
                             f"fp64 {replayed_fp64['calls']}")
    drops = sum(int(r["dropped"]) for r in experts[:n_moe])
    verdict = fp64_verdict(got, want, ref, BF16_LEAF_TOL)
    far = {n for n, d in d_plain.items() if d > 1}
    failed = [f_ for f_ in verdict["failed"] if f_[0] in far]
    if failed:
        raise AssertionError(f"gradient leaves farther than {BF16_LEAF_TOL:g} from the plain "
                             f"versions' and than {FP64_MARGIN:g} times the plain versions' "
                             f"from fp64 (leaf, distance, plain's distance): {failed}")
    worst = max((d, n) for n, d in d_plain.items())
    gnorm = math.sqrt(sum(float(g.float().square().sum()) for g in got.values()))
    if not (math.isfinite(float(loss)) and math.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"loss {float(loss)}, gradient norm {gnorm}: finite and > 0 wanted")
    seconds = time.perf_counter() - t0
    log(f"   loss {float(loss.detach()):.6f} (plain {float(loss_p.detach()):.6f}); gradient "
        f"norm {gnorm:.4g}; launches { {k_: v_ for k_, v_ in counts.items() if v_} }, by route "
        f"{ {k_: {r_: n_ for r_, n_ in v_.items() if n_} for k_, v_ in routes.items()} }"
        f"{f'; K1 calls at S_kv != S {want_kv}' if want_kv else ''}; "
        f"{len(want)} gradient leaves, {len(want) - len(far)} within {BF16_LEAF_TOL:g} of each "
        f"leaf's max |g| of the plain versions (the farthest at {worst[0]:.3f} of it, "
        f"{worst[1]}), {len(far)} farther, each within max(1, {FP64_MARGIN:g} x the plain "
        f"versions') distance of fp64 (in units of {BF16_LEAF_TOL:g} of its max: the farthest "
        f"leaf with the kernels {verdict['farthest'][0]:.3f} ({verdict['farthest'][1]}), the "
        f"plain versions' farthest {verdict['farthest_plain'][0]:.3f} "
        f"({verdict['farthest_plain'][1]}))"
        + (f"; {len(masks)} ReLU calls' masks replayed" if masks else "")
        + (f"; {len(experts)} MoE calls' expert choices replayed ({n_moe} layers, their "
           f"recompute choosing the forward's experts; {experts[0]['cap']} slots an expert, "
           f"{drops} (token, k) pairs dropped a forward; the replay changed "
           f"{replayed['changed']} and {replayed_fp64['changed']} of the plain and fp64 runs' "
           f"{sum(r['idx'].numel() for r in experts)} (token, k) choices)" if experts else "")
        + f"; {seconds:.1f} s")
    out = {"loss": float(loss.detach()), "loss_plain": float(loss_p.detach()),
           "grad_norm": gnorm, "seconds": seconds, "leaves": len(d_plain), "batch": b, "seq": s,
           "layers": cfg.num_layers, "beyond_plain_tol": sorted(far), "farthest_vs_plain": worst,
           "farthest_vs_fp64": verdict["farthest"],
           "farthest_plain_vs_fp64": verdict["farthest_plain"],
           "relu_calls": len(masks), "kv_len_calls": want_kv, "moe_calls": len(experts),
           "moe_dropped_pairs": drops,
           "moe_choices_changed": [replayed["changed"], replayed_fp64["changed"]]}
    del params, named, got, want, ref, loss, loss_p, masks, experts
    return out


def train_phase(arch, production=False, keep=False):
    """`arch` trains TRAIN["steps"] steps through ``repro_torch.launch.train``'s
    functions, from its init (a tied table scaled by ``live_table``): at
    full width and depth in fp32, batch 4 x 256, or with
    `production` at the reference's production dtypes (PRODUCTION: bf16
    params and compute, full remat; the moments in the config's
    optimizer_dtype, asserted) at BF16_TRAIN's batch, sequence and depth. Its
    launches are those of ``expected_train_launches`` (the encoder-decoder's
    cross calls at S_kv != S counted apart), every K1 and K3 launch on the
    route of the compute dtype (fp32: 3xTF32; bf16: wgmma at K1's head_dims
    64-256) and every K1-bwd and K3-bwd launch on its backward route (fp32:
    3xTF32; bf16: bf16, K3-bwd by its widths); then two steps
    timed on the host clock around a synchronised step, the step's parts
    (forward, backward, optimizer, summed over the micro-batches) on CUDA
    events, and a profiler breakdown of one step, in which the family's
    kernel groups (TRAIN_GROUPS) hold device time and no other kernel
    runs; an MoE step's profile runs under ``annotated_layers``, whose
    groups "moe_gemm" and "moe_dispatch" take the MoE calls' kernels of the
    forward, the remat recompute and the backward, and must hold time where
    the model has an MoE layer. With `keep`, the run and its train state
    come back too, for a later phase on the same params."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.device import dtype_of
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import train
    from repro_torch.models.lm import layer_plan
    from repro_torch.optim import apply_updates
    from repro_torch.utils.tree import tree_bytes, tree_size

    torch.backends.cuda.matmul.allow_tf32 = False
    phase_t0 = time.perf_counter()
    s, steps = TRAIN["seq"], TRAIN["steps"]
    over = {}
    if production:
        over = dict(PRODUCTION, **BF16_TRAIN[arch])
        b, s = over.pop("batch"), over.pop("seq", s)
    else:
        b = TRAIN["batch"]
    run = train.setup(arch, batch=b, seq=s, steps=steps, device="cuda", **over)
    cfg = run.cfg
    dtype = dtype_of(cfg.compute_dtype)
    moment_dtype = dtype_of(get_config(arch).optimizer_dtype)
    accum = max(1, cfg.grad_accum)
    frames = f" over {cfg.frontend_tokens} frames" if cfg.family == "encdec" else ""
    log(f"== train: {cfg.name} {describe(cfg)}, {cfg.num_layers} layers, {cfg.param_dtype} "
        f"params, {cfg.compute_dtype} compute, remat {cfg.remat}, {cfg.optimizer_dtype} AdamW "
        f"moments, batch {b} x seq {s}{frames} in {accum} micro-batch(es), {steps} steps "
        "through repro_torch.launch.train")
    t0 = time.perf_counter()
    state = run.make_state()
    if cfg.tie_embeddings:
        live_table(state["params"], cfg)
    torch.cuda.synchronize()
    n = tree_size(state["params"])
    moments = tree_bytes(state["opt_state"])
    held = {str(m.dtype) for part in state["opt_state"].values() for m in part.values()}
    if held != {str(moment_dtype)}:
        raise AssertionError(f"AdamW moments in {held}: {cfg.name}'s config keeps them in "
                             f"{moment_dtype}")
    log(f"   params {n} ({tree_bytes(state['params']) / 1e9:.2f} GB {cfg.param_dtype}; both "
        f"moments {moments / 1e9:.2f} GB, {moment_dtype}, the config's) built on the card in "
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
    k1_bwd_routes = dict(K1.flash_attention_bwd.launches_by_route)
    k3_bwd_routes = dict(K3.ssd_scan_bwd.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(cfg, steps)
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != expected {want}")
    check_routes(cfg, dtype, want, k1_routes, k1_bwd_routes, k3_routes, k3_bwd_routes)
    counts.update(route_rows(k1_bwd_routes, k3_routes, k3_bwd_routes))
    want_kv = {}
    if cfg.family == "encdec":
        key = f"{s}x{cfg.frontend_tokens}"
        bwd = cfg.dec_layers * steps * max(1, cfg.grad_accum)
        want_kv = {"flash_attention": {key: bwd * (2 if cfg.remat in ("full", "dots") else 1)},
                   "flash_attention_bwd": {key: bwd}}
    if {k: v for k, v in kv_calls.items() if v} != want_kv:
        raise AssertionError(f"K1 calls at S_kv != S {kv_calls}, want {want_kv}")
    loss = [float(m["loss"]) for m in history]
    gnorm = [float(m["grad_norm"]) for m in history]
    if not (all(map(math.isfinite, loss + gnorm)) and min(gnorm) > 0) or state["step"] != steps:
        raise AssertionError(f"loss {loss}, grad_norm {gnorm} (finite and > 0 wanted), "
                             f"step {state['step']}")
    log(f"   launches: {counts}; K1 by route {k1_routes}; K1-bwd by route {k1_bwd_routes}; K3 by "
        f"route {k3_routes}; K3-bwd by route {k3_bwd_routes}"
        f"{f'; K1 and K1-bwd calls at S_kv != S (S x S_kv: calls) {want_kv}' if want_kv else ''}"
        f"; loss {loss}, grad_norm {gnorm}; {steps} steps in {run_s:.2f} s (the first warms "
        f"cuBLAS and the allocator); peak memory {peak / 1e9:.2f} GB "
        f"({torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB on the card)")

    step_ms = []
    # the caching allocator's retries (a failed cudaMalloc, its cache freed
    # and the call repeated: the host waits on the device) over the two steps
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for i in range(2):
        batch = run.batch_at(steps + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    # the step's parts, called as make_train_step calls them (per
    # micro-batch: the loss, then its gradients summed in fp32), CUDA events
    # between: each part's share of the step's device timeline
    loss_fn = make_vtrace_loss(run.bundle)
    named = dict(state["params"].named_parameters())
    batch = run.batch_at(steps + 2)
    parts = dict.fromkeys(("forward", "backward", "optimizer"), 0.0)
    mbs = b // accum
    gsum = None
    for i in range(accum):
        micro = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        lv, _ = loss_fn(state["params"], micro)
        ev[1].record()
        grads = param_grads(lv, named)
        if accum > 1:
            with torch.no_grad():
                if gsum is None:
                    gsum = {n_: g.float() for n_, g in grads.items()}
                else:
                    for n_, g in grads.items():
                        gsum[n_].add_(g.float())
        ev[2].record()
        torch.cuda.synchronize()
        parts["forward"] += ev[0].elapsed_time(ev[1])
        parts["backward"] += ev[1].elapsed_time(ev[2])
        del lv
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    if accum > 1:
        with torch.no_grad():
            grads = {n_: g.div_(accum).to(named[n_].dtype) for n_, g in gsum.items()}
        del gsum
    updates, state["opt_state"], _ = run.opt.update(grads, state["opt_state"], named,
                                                    state["step"])
    apply_updates(named, updates)
    ev[1].record()
    torch.cuda.synchronize()
    parts["optimizer"] = ev[0].elapsed_time(ev[1])
    state["step"] += 1
    del grads, updates
    total = sum(parts.values())
    log(f"   step wall (host clock, synchronised) {step_ms[0]:.2f}, {step_ms[1]:.2f} ms "
        f"({retries} allocator retries in the two); {b * s / (step_ms[1] / 1e3):.0f} tokens/s; "
        "parts (CUDA events) "
        + ", ".join(f"{p}{' (AdamW)' if p == 'optimizer' else ''} {t:.2f} ms ({t / total:.3f})"
                    for p, t in parts.items()))

    has_moe = cfg.family == "moe" and any(spec.moe for spec in layer_plan(cfg))
    with (annotated_layers() if cfg.family == "moe" else contextlib.nullcontext()), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = run.train_step(state, run.batch_at(steps + 3))
        torch.cuda.synchronize()
    groups, n_ops = device_breakdown(prof, 1)
    for g in KERNEL_GROUPS:
        if (g in TRAIN_GROUPS[cfg.family]) != (groups[g] > 0):
            raise AssertionError(f"profiler group {g} holds {groups[g]} ms of a train step of "
                                 f"{cfg.name}, which runs {TRAIN_GROUPS[cfg.family]}")
    moe_groups = ("moe_gemm", "moe_dispatch", "moe_backward")
    if cfg.family == "moe" and any((groups.get(g, 0.0) > 0) != has_moe for g in moe_groups):
        raise AssertionError(f"MoE groups { {g: groups.get(g) for g in moe_groups} } of a train "
                             f"step of {cfg.name}, which has {'' if has_moe else 'no '}MoE layer")
    idle = 1.0 - groups["busy"] / step_ms[1]
    log(f"   device time of a step (ms): {json.dumps(groups)}; {n_ops:.0f} device operations; "
        f"device idle share {idle:.3f} (1 - busy over the second timed step's wall)")
    log(f"   a step's device ms: GEMMs {groups['gemm']:.2f}"
        + (f", experts {groups['moe_gemm']:.2f} and dispatch {groups['moe_dispatch']:.2f} "
           f"(the MoE calls' backward {groups['moe_backward']:.2f} of them)" if has_moe else "")
        + "".join(f", {g} {groups[g]:.2f}" for g in TRAIN_GROUPS[cfg.family])
        + f", other {groups['other']:.2f} of busy {groups['busy']:.2f}; params "
        f"{tree_bytes(state['params']) / 1e9:.2f} GB, moments {moments / 1e9:.2f} GB, peak "
        f"{peak / 1e9:.2f} GB")
    del named, m
    if not keep:
        del state
    seconds = time.perf_counter() - phase_t0
    log(f"   train {cfg.name}{' (production dtypes)' if production else ''}: {seconds:.1f} s")
    metrics = {"step_ms": step_ms, "tokens_per_s": b * s / (step_ms[1] / 1e3),
               "parts_ms": parts, "peak_gb": peak / 1e9, "params": n, "loss": loss,
               "grad_norm": gnorm, "device_ms": groups, "device_ops": n_ops,
               "idle_share": idle, "alloc_retries": retries,
               "kv_len_calls": want_kv, "seconds": seconds, "layers": cfg.num_layers,
               "batch": b, "micro_batches": accum, "dtypes": [cfg.param_dtype,
                                                              cfg.compute_dtype],
               "moments": cfg.optimizer_dtype, "moments_gb": moments / 1e9,
               "remat": cfg.remat}
    return (counts, metrics, (run, state)) if keep else (counts, metrics)


class GradsKept:
    """An optimizer for ``make_train_step`` that keeps the step's gradients
    (``grads``, the leaves as the step hands them to its optimizer) and
    moves no param: each update is a 0-d zero, which ``apply_updates`` adds.
    Every run of a comparison then sees the same params; AdamW, the same
    under every remat policy, is left out of its time."""

    def __init__(self):
        self.grads = None

    def update(self, grads, opt_state, params, step):
        self.grads = grads
        zero = {}
        for g in grads.values():
            zero.setdefault(g.dtype, torch.zeros((), dtype=g.dtype, device=g.device))
        return {n: zero[g.dtype] for n, g in grads.items()}, opt_state, {}


def remat_step(run, state, batch, remat, choices=None, profiled=False):
    """One step of `run`'s train call on `batch` through ``make_train_step``
    under `remat` (the config's own field), its optimizer ``GradsKept``; an
    MoE model's calls replay `choices` (``nn.moe.expert_choices``) when
    given, else record them. Returns the loss, the gradients, the launch
    counts and routes, the host wall ms of the synchronised step, the peak
    memory allocated during it (and above its start), the MoE calls'
    records and, when `profiled`, the device breakdown of the step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import make_model
    from repro_torch.core.losses import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.nn.moe import expert_choices

    keep = GradsKept()
    step = make_train_step(make_model(run.cfg.with_(remat=remat)), keep)
    moe = run.cfg.family == "moe"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    with (expert_choices(choices) if moe else contextlib.nullcontext()) as experts, \
            (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
             else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    out = {"loss": metrics["loss"].detach(), "grads": keep.grads, "wall_ms": wall,
           "peak_gb": peak / 1e9, "peak_over_start_gb": (peak - start) / 1e9,
           "counts": ops.launch_counts(), "experts": experts, "routes": launch_routes()}
    if profiled:
        out["device_ms"], out["device_ops"] = device_breakdown(prof, 1)
    return out


def grads_apart(got, ref):
    """{leaf: max |got - ref|} over the leaves that are not equal to the bit."""
    return {n: float((g.float() - ref[n].float()).abs().max())
            for n, g in got.items() if not torch.equal(g, ref[n])}


def launch_routes():
    """K1's, K1-bwd's, K3's and K3-bwd's launches by route since the counts
    were last reset."""
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ssd_scan as K3
    return [dict(K1.flash_attention.launches_by_route),
            dict(K1.flash_attention_bwd.launches_by_route),
            dict(K3.ssd_scan.launches_by_route), dict(K3.ssd_scan_bwd.launches_by_route)]


def route_rows(k1_bwd, k3, k3_bwd):
    """The launches of the routes that have their own rows in the kernels'
    line, from K1-bwd's, K3's and K3-bwd's launches by route."""
    return {"ssd_scan_tf32x3": k3.get("tf32x3", 0),
            "flash_attention_bwd_bf16": k1_bwd.get("bf16", 0),
            "ssd_scan_bwd_bf16": k3_bwd.get("wgmma", k3_bwd.get("bf16", 0))}


def add_launches(launches, r):
    """Add a run's launches (``remat_step``'s "counts" and "routes") to
    `launches`, with the routes' own rows."""
    for k, v in {**r["counts"], **route_rows(*r["routes"][1:])}.items():
        launches[k] = launches.get(k, 0) + v


def remat_compare(run, state, batch, rounds, runs, also=()):
    """`run`'s step (``remat_step``) under "full", then `rounds` times
    "dots" and "full" in turn, then once under each of `also`, held to the
    first "full" run, the reference; an MoE model's later runs replay the
    reference's expert choices. Each run launches as
    ``expected_train_launches`` says, on the routes of ``check_routes``;
    an MoE model's remat recompute chooses its forward's experts. Where
    every later "full" run equals the reference to the bit (loss and every
    gradient leaf), every "dots" run must too. Where two "full" runs
    already differ (an op whose result depends on the order of its atomic
    adds), one more "full" runs, and at each leaf where the "full" runs
    differ each "dots" run must lie no farther from the nearest "full" run
    than the farthest two "full" runs lie apart; every other leaf, and the
    loss where the "full" losses agree, equal to the bit. A run of `also`
    is reported, not held. Only the reference's gradients are kept, and a
    later run's leaves that differ from them. Each run's result (its
    gradients dropped) is appended to `runs`; returns the verdict."""
    from repro_torch.models.lm import layer_plan

    cfg = run.cfg
    n_moe = sum(spec.moe for spec in layer_plan(cfg)) if cfg.family == "moe" else 0
    ref, choices = None, None

    def one(remat):
        nonlocal ref, choices
        r = remat_step(run, state, batch, remat, choices)
        want = expected_train_launches(cfg.with_(remat=remat), 1)
        if r["counts"] != want:
            raise AssertionError(f"{cfg.name} under remat {remat}: launches {r['counts']} != "
                                 f"expected {want}")
        check_routes(cfg, torch.bfloat16, want, *r["routes"])
        again = n_moe if remat in ("full", "dots") else 0
        if n_moe and choices is None:
            experts = r["experts"]
            if len(experts) != n_moe + again:
                raise AssertionError(f"{len(experts)} MoE calls, want {n_moe + again}")
            for i in range(again):   # the recompute runs last layer first
                if not torch.equal(experts[i]["idx"], experts[-1 - i]["idx"]):
                    raise AssertionError(f"MoE layer {i}: the {remat} recompute chose other "
                                         "experts than the forward")
            choices = experts
        elif n_moe and r["experts"]["calls"] != n_moe + again:
            raise AssertionError(f"{r['experts']['calls']} MoE calls replayed, want "
                                 f"{n_moe + again}")
        grads = r.pop("grads")
        if ref is None:
            ref = dict(r, grads=grads)
        else:
            r["apart"] = grads_apart(grads, ref["grads"])
            r["leaves"] = {n: grads[n] for n in r["apart"]}
        del grads
        runs.append((remat, r))
        return r

    one("full")
    for _ in range(rounds):
        one("dots")
        one("full")
    fulls = [ref] + [r for remat, r in runs[1:] if remat == "full"]
    loss_noisy = any(not torch.equal(r["loss"], ref["loss"]) for r in fulls)
    if loss_noisy or any(r["apart"] for r in fulls[1:]):
        fulls.append(one("full"))
    noisy = {}   # leaf: the farthest two "full" runs apart

    def leaf(r, n):
        return ref["grads"][n] if r is ref else r["leaves"].get(n, ref["grads"][n])
    for n in {n for r in fulls[1:] for n in r["apart"]}:
        noisy[n] = max(float((leaf(a, n).float() - leaf(b, n).float()).abs().max())
                       for i, a in enumerate(fulls) for b in fulls[i + 1:])
    dots = [r for remat, r in runs if remat == "dots"]
    verdict = {"full_runs": len(fulls), "dots_runs": len(dots),
               "full_runs_differ_at": noisy, "full_losses_differ": loss_noisy,
               "dots_bit_equal": all(not r["apart"] and torch.equal(r["loss"], ref["loss"])
                                     for r in dots)}
    for r in dots:
        if not loss_noisy and not torch.equal(r["loss"], ref["loss"]):
            raise AssertionError(f"{cfg.name}: the loss under remat dots {float(r['loss'])!r} "
                                 f"!= full {float(ref['loss'])!r}")
        for n, d in r["apart"].items():
            if n not in noisy:
                raise AssertionError(f"{cfg.name}: gradient leaf {n} under remat dots differs "
                                     f"from full by {d:.3g}, where every full run agrees to "
                                     "the bit")
            near = min(float((r["leaves"][n].float() - leaf(f, n).float()).abs().max())
                       for f in fulls)
            if near > noisy[n]:
                raise AssertionError(f"{cfg.name}: gradient leaf {n} under remat dots lies "
                                     f"{near:.3g} from the nearest full run, the full runs "
                                     f"{noisy[n]:.3g} apart")
    for remat in also:
        r = one(remat)
        verdict[f"{remat}_leaves_apart"] = len(r["apart"])
        verdict[f"{remat}_farthest"] = max(r["apart"].values(), default=0.0)
        verdict[f"{remat}_loss_bit_equal"] = bool(torch.equal(r["loss"], ref["loss"]))
    for _, r in runs:
        r.pop("leaves", None)
    if n_moe:
        verdict["moe_replay_changed"] = [r["experts"]["changed"] for _, r in runs[1:]]
    return verdict


def dots_saved_bytes(cfg, tokens):
    """Bytes of the products with no batch dimension that remat "dots" keeps
    for `tokens` tokens over every layer of a dense LM of `cfg` in its
    compute dtype (q, k, v and o, and the MLP's gate, up and down), and of
    those the reference's policy does not keep: the down projections, each
    of which ends its rematted layer and feeds only the residual add."""
    from repro_torch.device import dtype_of
    width = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim + 2 * cfg.d_model \
        + 2 * cfg.d_ff
    per_width = tokens * cfg.num_layers * dtype_of(cfg.compute_dtype).itemsize
    return per_width * width, per_width * cfg.d_model


def micro_batch_memory(run, params, micro, remat):
    """One micro-batch's V-trace loss and gradients under `remat`: the
    memory its forward leaves allocated (what the backward will read, and
    the loss's tensors) and its peak over forward and backward, both in
    bytes above the start, and its launches (``remat_step``'s "counts" and
    "routes")."""
    from repro_torch.configs.registry import make_model
    from repro_torch.core.losses import make_vtrace_loss, param_grads
    from repro_torch.kernels import ops

    loss_fn = make_vtrace_loss(make_model(run.cfg.with_(remat=remat)))
    named = dict(params.named_parameters())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    loss, _ = loss_fn(params, micro)
    held = torch.cuda.memory_allocated() - start
    grads = param_grads(loss, named)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    del grads, loss
    return held, peak, {"counts": ops.launch_counts(), "routes": launch_routes()}


def remat_dots_phase(run, state):
    """remat "dots" (``models.common.dots_with_no_batch_dims_saveable``, the
    reference's ``dots_with_no_batch_dims_saveable``) against "full" on the
    card, through ``make_train_step`` (``remat_compare``): qwen3-14b at its
    production train call on the bf16 train phase's `run` and `state` (4 of
    40 layers, 16 x 256 in 4 micro-batches), "full" and "dots" alternated
    REMAT_ROUNDS rounds, "none" once, then one profiled step under each:
    the host wall ms, the peak memory (and above the step's start), device
    busy and GEMM ms of each; then one step of each REMAT_DOTS model at a
    few layers of full width, batch 4 x 256 in one micro-batch, "full",
    "dots", "full". Every "dots" run equals "full" to the bit (or, where
    "full" runs already differ, as ``remat_compare`` holds it) and
    launches as ``expected_train_launches`` says: the forward kernels
    twice a micro-batch, as under "full". Returns (every run's launches
    summed, ``add_launches``; the metrics)."""
    from repro_torch.launch import train

    t_start = time.perf_counter()
    cfg = run.cfg
    b = BF16_TRAIN[cfg.name]["batch"]
    mbs = b // max(1, cfg.grad_accum)
    saved, beyond = (x / 1e9 for x in dots_saved_bytes(cfg, TRAIN["seq"] * mbs))
    log(f"== remat dots: {cfg.name} at its production train call ({cfg.num_layers} layers, "
        f"{b} x {TRAIN['seq']} in {cfg.grad_accum} micro-batches; the step less AdamW), 'full' "
        f"and 'dots' alternated {REMAT_ROUNDS} rounds, then 'none'. Predicted: 'dots' keeps "
        f"{saved:.3f} GB of products a micro-batch that 'full' recomputes ({beyond:.3f} GB of "
        "them the down projections, which the reference's policy does not keep), so a "
        "micro-batch's forward leaves that much more allocated; 'none' more than both")
    batch = run.batch_at(0)
    runs, launches = [], {}
    verdict = {cfg.name: remat_compare(run, state, batch, REMAT_ROUNDS, runs, also=("none",))}
    for remat in ("none", "full", "dots"):
        runs.append((remat, remat_step(run, state, batch, remat, profiled=True)))
        runs[-1][1].pop("grads")
        if runs[-1][1]["counts"] != expected_train_launches(cfg.with_(remat=remat), 1):
            raise AssertionError(f"launches under remat {remat}: {runs[-1][1]['counts']}")
    micro = {k: v[:mbs] for k, v in batch.items()}
    memory = {}
    for remat in ("none", "full", "dots"):
        held, peak, r = micro_batch_memory(run, state["params"], micro, remat)
        memory[remat] = {"forward_held_gb": held / 1e9, "peak_gb": peak / 1e9}
        want = expected_train_launches(cfg.with_(remat=remat, grad_accum=1), 1)
        if r["counts"] != want:
            raise AssertionError(f"a micro-batch under remat {remat}: launches {r['counts']} "
                                 f"!= expected {want}")
        check_routes(cfg, torch.bfloat16, want, *r["routes"])
        add_launches(launches, r)
    by = {}
    for remat, r in runs:
        add_launches(launches, r)
        m = by.setdefault(remat, {"wall_ms": [], "peak_gb": [], "peak_over_start_gb": []})
        if "device_ms" in r:
            m["busy_ms"], m["gemm_ms"] = r["device_ms"]["busy"], r["device_ms"]["gemm"]
            m["kernels_ms"] = {g: r["device_ms"][g] for g in ("K1", "K1-bwd")}
            m["device_ops"], m["profiled_wall_ms"] = r["device_ops"], r["wall_ms"]
        else:
            m["wall_ms"].append(r["wall_ms"])
            m["peak_gb"].append(r["peak_gb"])
            m["peak_over_start_gb"].append(r["peak_over_start_gb"])
    for remat, m in by.items():
        log(f"   remat {remat}: wall (host clock, synchronised) "
            f"{', '.join(f'{x:.2f}' for x in m['wall_ms'])} ms; peak "
            f"{', '.join(f'{x:.3f}' for x in m['peak_gb'])} GB "
            f"({', '.join(f'{x:.3f}' for x in m['peak_over_start_gb'])} above the step's "
            f"start); profiled step: device busy {m['busy_ms']:.2f} ms, GEMMs "
            f"{m['gemm_ms']:.2f} ms, K1 {m['kernels_ms']['K1']:.2f}, K1-bwd "
            f"{m['kernels_ms']['K1-bwd']:.2f} ms, {m['device_ops']:.0f} device operations")
    for remat, m in memory.items():
        by[remat].update(micro_batch=m)
        log(f"   remat {remat}, one micro-batch ({mbs} x {TRAIN['seq']}): its forward leaves "
            f"{m['forward_held_gb']:.3f} GB allocated, its forward and backward peak "
            f"{m['peak_gb']:.3f} GB above the start")
    dots_over_full = {k: memory["dots"][k] - memory["full"][k] for k in memory["full"]}
    log(f"   {cfg.name}: {verdict[cfg.name]}; 'dots' against 'full' a micro-batch: the "
        f"forward's memory {dots_over_full['forward_held_gb']:+.3f} GB (predicted "
        f"+{saved:.3f}), the peak {dots_over_full['peak_gb']:+.3f} GB; launches of the "
        f"{len(runs) + len(memory)} runs { {k: v for k, v in launches.items() if v} }")
    out = {cfg.name: {"by_remat": by, "verdict": verdict[cfg.name],
                      "predicted_saved_gb": saved, "predicted_beyond_reference_gb": beyond,
                      "dots_over_full_gb": dots_over_full}}
    del runs, batch
    for arch, over in REMAT_DOTS.items():
        t0 = time.perf_counter()
        one = train.setup(arch, batch=TRAIN["batch"], seq=TRAIN["seq"], steps=1, device="cuda",
                          grad_accum=1, **PRODUCTION, **over)
        params = one.bundle.init(one.seed, device=one.device).requires_grad_(True)
        if one.cfg.tie_embeddings:
            live_table(params, one.cfg)
        runs = []
        verdict[arch] = remat_compare(one, {"params": params, "opt_state": None, "step": 0},
                                      one.batch_at(0), 1, runs)
        for _, r in runs:
            add_launches(launches, r)
        last = dict(runs)   # the last run of each: the first warms the model's calls
        log(f"   {one.cfg.name} at {over}: {verdict[arch]}; launches a step "
            f"{ {k: v for k, v in last['dots']['counts'].items() if v} }; wall "
            f"{last['full']['wall_ms']:.2f} ms full (the second run), {last['dots']['wall_ms']:.2f} "
            f"ms dots; peak above the start {last['full']['peak_over_start_gb']:.3f} GB full, "
            f"{last['dots']['peak_over_start_gb']:.3f} GB dots; {time.perf_counter() - t0:.1f} s")
        out[arch] = {"verdict": verdict[arch], "layers": one.cfg.num_layers,
                     "wall_ms": {k: last[k]["wall_ms"] for k in ("full", "dots")},
                     "peak_over_start_gb": {k: last[k]["peak_over_start_gb"]
                                            for k in ("full", "dots")}}
        del params, runs, last, one
    out["seconds"] = time.perf_counter() - t_start
    log(f"   remat dots: {out['seconds']:.1f} s")
    return launches, out


def bf16_smoke_train_phase():
    """The smoke configs of the attention families (BF16_SMOKE: head_dim
    16) at the production dtypes on the card, BF16_SMOKE_RUN's steps each
    through ``repro_torch.launch.train``'s ``setup`` and ``train_loop``
    (a tied table scaled by ``live_table``): K1 and K1-bwd in bf16 at head_dim
    16, both on their 3xTF32 kernels (and K4 and K4-bwd in RecurrentGemma's);
    the launches those of ``expected_train_launches``, each on its route;
    the loss and gradient norm finite, the norm > 0. Returns the launches
    summed over the archs, and each arch's metrics."""
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import train

    b, s, steps = (BF16_SMOKE_RUN[k] for k in ("batch", "seq", "steps"))
    log(f"== train at the production dtypes, smoke configs (head_dim 16): {', '.join(BF16_SMOKE)}, "
        f"batch {b} x seq {s}, {steps} steps each through repro_torch.launch.train")
    total, metrics = {}, {}
    for arch in BF16_SMOKE:
        t0 = time.perf_counter()
        run = train.setup(arch, smoke=True, batch=b, seq=s, steps=steps, device="cuda",
                          **PRODUCTION)
        cfg = run.cfg
        state = run.make_state()
        if cfg.tie_embeddings:
            live_table(state["params"], cfg)
        ops.reset_launch_counts()
        state, history = train.train_loop(run, state, 0, steps, log=lambda m: log(f"   {m}"))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = expected_train_launches(cfg, steps)
        if counts != want:
            raise AssertionError(f"{arch} smoke, bf16: launches {counts} != expected {want}")
        k1_bwd = dict(K1.flash_attention_bwd.launches_by_route)
        check_routes(cfg, torch.bfloat16, want, dict(K1.flash_attention.launches_by_route),
                     k1_bwd, dict(K3.ssd_scan.launches_by_route),
                     dict(K3.ssd_scan_bwd.launches_by_route))
        loss = [float(m["loss"]) for m in history]
        gnorm = [float(m["grad_norm"]) for m in history]
        if not (all(map(math.isfinite, loss + gnorm)) and min(gnorm) > 0) \
                or state["step"] != steps or state["params"].embed.table.dtype != torch.bfloat16:
            raise AssertionError(f"{arch} smoke, bf16: loss {loss}, grad_norm {gnorm} (finite "
                                 f"and > 0 wanted), step {state['step']}")
        seconds = time.perf_counter() - t0
        log(f"   {arch} smoke (head_dim {cfg.head_dim}, {cfg.num_layers} layers), bf16: launches "
            f"{ {k_: v_ for k_, v_ in counts.items() if v_} }, K1-bwd by route "
            f"{ {k_: v_ for k_, v_ in k1_bwd.items() if v_} }; loss {loss}, grad_norm {gnorm}; "
            f"{seconds:.1f} s")
        for k_, v_ in counts.items():
            total[k_] = total.get(k_, 0) + v_
        metrics[arch] = {"launches": {k_: v_ for k_, v_ in counts.items() if v_}, "loss": loss,
                         "grad_norm": gnorm, "seconds": seconds}
        del run, state, history
    return total, metrics


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
    printed beside the unpadded serve phase's (`unpadded`); no K2 launch
    with the log-sum-exp. Then the same params under the reference's
    decode layout, a (1, 1) ("data", "model") mesh (``seq_sharded_serve``).
    Returns the launches of both runs, summed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import make_model
    from repro_torch.kernels import decode_attention as K2
    from repro_torch.kernels import flash_attention as K1
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_policy
    from repro_torch.launch.dryrun import production_config
    from repro_torch.launch.mesh import make_mesh, single_device_mesh
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
    with_lse = K2.decode_attention.launches_with_lse
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
    if with_lse:
        raise AssertionError(f"{with_lse} K2 launches with lse on the ('data',) mesh")
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
    # the reference's decode layout: the same params on a (1, 1) ("data",
    # "model") mesh
    mesh2 = make_mesh((1, 1), ("data", "model"), "cuda")
    rules2 = rules_for(cfg, mesh2, "decode")
    counts2, m["seq_sharded"] = seq_sharded_serve(bundle, remesh(params, mesh2, rules2), mesh2,
                                                  rules2, prompts, max_len, m)
    del params
    return {k: counts[k] + counts2[k] for k in counts}, m


def remesh(params, mesh, rules):
    """`params`, DTensors on a one-rank mesh, laid out on the one-rank `mesh`
    by `rules`, in place: each local tensor is the whole parameter, so no
    value is copied."""
    from repro_torch.sharding.param import distribute_module
    with torch.no_grad():
        for name, p in list(params.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = params.get_submodule(owner) if owner else params
            setattr(mod, leaf, torch.nn.Parameter(p.to_local(), requires_grad=p.requires_grad))
    return distribute_module(params, mesh, rules)


def seq_sharded_serve(bundle, params, mesh, rules, prompts, max_len, data_mesh):
    """qwen3-14b at tp 16 served under the reference's decode layout: its
    params DTensors on a (1, 1) ("data", "model") mesh, where ``rules_for(cfg,
    mesh, "decode")`` maps ``act_kv_seq`` and ``heads`` to "model", so the
    cache is sharded on its sequence and every decode layer takes the
    sequence-sharded branch (K2 over the rank's chunk with its log-sum-exp,
    then the combine, which on one rank weighs by exp(0) and divides by
    1). K1 40 a prefill and K2 40 a step, every K2 launch with the
    log-sum-exp; the served tokens equal the ("data",) mesh's
    (`data_mesh`, that run's metrics); the full-depth check against the
    plain versions; decode ms a step, device busy ms and device operations
    a step printed beside the ("data",) mesh's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import decode_attention as K2
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_policy
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.sharding.ctx import sharding_ctx

    cfg = bundle.cfg
    log(f"   the reference's decode layout: mesh {mesh}, rules heads={rules['heads']} "
        f"act_batch={rules['act_batch']} act_kv_seq={rules['act_kv_seq']}")
    if rules["act_kv_seq"] != ("model",) or rules["heads"] != ("model",):
        raise AssertionError(f"decode rules on the (1, 1) mesh: {dict(rules)}")
    ctx = functools.partial(sharding_ctx, mesh, rules)
    prefill, step = make_prefill(bundle, max_len, torch.bfloat16), make_serve_step(bundle)
    with ctx():   # warm-up
        tok, cache = prefill(params, {"tokens": prompts})
        placed = str(tuple(cache["layers"][0]["k"].placements))
        step(params, tok, cache)
        torch.cuda.synchronize()
    del tok, cache
    if placed != "(Shard(dim=0), Shard(dim=1))":
        raise AssertionError(f"the cache's k is placed {placed}, not on its sequence")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_policy.serve(cfg, clients=CLIENTS, prompt_len=prompts.shape[1], tokens=TOKENS,
                             max_len=max_len, device=prompts.device, params=params,
                             deadline_ms=1000.0, mesh=mesh, rules=rules)
    counts = ops.launch_counts()
    with_lse = K2.decode_attention.launches_with_lse
    steps = out["stats"]["batches"]
    want = expected_launches(cfg, steps)
    log(f"   launches: {counts}, K2 with lse {with_lse}; decode steps (batches) {steps}; "
        f"cache k placed {placed}")
    if counts != want or with_lse != want["decode_attention"] or steps != TOKENS:
        raise AssertionError(f"launch counts {counts} (K2 with lse {with_lse}) != expected "
                             f"{want}, or {steps} steps for {TOKENS} tokens")
    tokens = {cid: [out["first"][cid]] + out["tokens"][cid] for cid in range(CLIENTS)}
    if tokens != data_mesh["tokens"]:
        raise AssertionError(f"tokens on the (1, 1) mesh {tokens} differ from the ('data',) "
                             f"mesh's {data_mesh['tokens']}")
    log("   served tokens equal those on the ('data',) mesh")
    with ctx():
        plain = full_depth_plain_check(bundle, params, prompts, max_len)
        tok, cache = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                tok, cache = step(params, tok, cache)
            torch.cuda.synchronize()
    del tok, cache
    dec, dec_ops = device_breakdown(prof, 3)
    if not dec["K2"] > 0:
        raise AssertionError(f"no K2 device time in a decode step: {dec}")
    wall_step = out["decode_s"] * 1e3 / steps
    m = {"prefill_ms": out["prefill_s"] * 1e3, "decode_ms_per_step": wall_step,
         "decode_device_ms_per_step": dec, "decode_idle_share": 1 - dec["busy"] / wall_step,
         "decode_device_ops_per_step": dec_ops, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
         "k2_with_lse": with_lse, "cache_k_placements": placed, **plain, "tokens": tokens}
    log(f"   (1, 1) mesh: decode ms a step {wall_step:.2f} (('data',) mesh "
        f"{data_mesh['decode_ms_per_step']:.2f}), device busy ms a step {dec['busy']:.3f} "
        f"({data_mesh['decode_device_ms_per_step']['busy']:.3f}), K2 ms a step {dec['K2']:.3f} "
        f"({data_mesh['decode_device_ms_per_step']['K2']:.3f}), device operations a step "
        f"{dec_ops:.0f} ({data_mesh['decode_device_ops_per_step']:.0f}), prefill ms "
        f"{m['prefill_ms']:.2f} ({data_mesh['prefill_ms']:.2f}) (printed, not asserted)")
    return counts, m


def seq_rank_worker(rank, world, store):
    """One rank of ``seq_shard_phase``: a gloo group of `world` ranks over
    the file `store`, every rank on cuda:0, a (1, world) ("data", "model")
    mesh. For each of SEQ_CALLS, one seeded cache (the same on every rank)
    of which the rank keeps its chunk of the sequence as a DTensor
    (``DTensor.from_local``, Shard(1) over "model"), and at each valid
    length ``nn.attention._decode_call``: K2 with its log-sum-exp over the
    chunk, the partials combined by all-reduces of CUDA tensors through
    gloo. The result against K2 on the whole cache and against the plain
    version, within K2's bf16 tolerance (2e-2, atol 2e-2 of each row's
    rms). Prints one RESULT line."""
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import decode_attention as K2
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn import attention

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh((1, world), ("data", "model"), "cuda")
    res = {}
    for name, c in SEQ_CALLS.items():
        b, s, h, kh, d = (c[x] for x in ("b", "s", "h", "kh", "d"))
        gen = torch.Generator(device=dev).manual_seed(17)
        q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        size = s // world
        ck, cv = (DTensor.from_local(t[:, rank * size:(rank + 1) * size].contiguous(), mesh,
                                     (Replicate(), Shard(1)), run_check=False, shape=t.shape,
                                     stride=t.stride()) for t in (k, v))
        qd = DTensor.from_local(q, mesh, (Replicate(), Replicate()), run_check=False)
        for n in c["lengths"]:
            before = K2.decode_attention.launches_with_lse
            got = attention._decode_call(qd, ck, cv, torch.tensor([n], device=dev),
                                         scale=c["scale"], softcap=c["softcap"]).to_local()
            torch.cuda.synchronize()
            ln = torch.full((b,), n, dtype=torch.int32, device=dev)
            whole = ops.decode_attention(q, k, v, ln, scale=c["scale"], softcap=c["softcap"])
            plain = ops.decode_attention_plain(q, k, v, ln, scale=c["scale"],
                                               softcap=c["softcap"])
            ranks_live = -(-n // size)
            tag = f"R {world} rank {rank} {name} length {n} ({ranks_live} of {world} ranks live)"
            res[f"{name} {n}"] = {
                "err_whole": check_close(f"{tag}: against K2 on the whole cache", got, whole,
                                         2e-2, row_atol(whole, 2e-2, (2,))),
                "err_plain": check_close(f"{tag}: against the plain version", got, plain, 2e-2,
                                         row_atol(plain, 2e-2, (2,))),
                "lse_launches": K2.decode_attention.launches_with_lse - before}
            if res[f"{name} {n}"]["lse_launches"] != 1:
                raise AssertionError(f"{tag}: K2 ran {res[f'{name} {n}']['lse_launches']} "
                                     "times with lse, not once")
    dist.barrier()
    print("RESULT " + json.dumps({"rank": rank, "world": world, "checks": res}), flush=True)
    dist.destroy_process_group()


def seq_shard_phase():
    """The sequence-sharded decode on more than one rank, on one card: for
    R in SEQ_RANKS, R processes on cuda:0 over a gloo group with a file
    store, each running ``seq_rank_worker``; every rank's checks must pass.
    NCCL cannot put two ranks on one device; gloo stages its all-reduces
    of CUDA tensors through the host."""
    import os
    store_dir = ROOT / "build" / "seq_shard_store"
    store_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(SRC)]),
               OMP_NUM_THREADS="1")
    out = {}
    for world in SEQ_RANKS:
        log(f"== sequence-sharded decode on {world} ranks of one card (gloo, a file store): "
            f"{', '.join(SEQ_CALLS)}")
        store = store_dir / f"store_{world}"
        store.unlink(missing_ok=True)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.seq_rank_worker({r}, {world}, "
             f"{str(store)!r})"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r, (p, (o, e)) in enumerate(zip(procs, outs)):
            for line in o.splitlines():   # rank 0's checks; the others' in their RESULT
                if r == 0 and not line.startswith("RESULT "):
                    print(f"   [rank {r}] {line}", flush=True)
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {world} exited {p.returncode}: {e[-3000:]}")
            results.append(json.loads([x for x in o.splitlines()
                                       if x.startswith("RESULT ")][-1][len("RESULT "):]))
        worst = {key: max(max(x["checks"][key]["err_whole"], x["checks"][key]["err_plain"])
                          for x in results) for key in results[0]["checks"]}
        out[world] = {"seconds": time.perf_counter() - t0, "max_abs_err": worst}
        log(f"   R {world}: every rank's checks pass in {out[world]['seconds']:.1f} s; "
            f"max_abs_err by call and length {json.dumps(worst)}")
        store.unlink(missing_ok=True)
    return out


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
    k1_ptxas, k4_ptxas = {}, {}
    bwd_ptxas = {"k1": {}, "k3": {}, "k3_fwd": {}, "k4": {}, "k1_bf16": {}, "k3_bf16": {},
                 "k3_wgmma": {}, "k1_d16": {}}
    for name, rep in reports.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", rep)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", rep) if int(x)]
        log(f"   {name}: {len(regs)} instantiations, {min(regs)}-{max(regs)} registers "
            f"a thread, {len(spills)} with spills ({sum(spills)} bytes)")
        for entry in rep.split("Compiling entry function")[1:]:
            # K3-bwd's wgmma route, one line an instantiation (N; the chunk
            # kernel's P 64 or P > 64); the row keeps N 128, P 64's
            found = re.search(r"ssd_bwd_wgmma_(state|chunk|reduce)_kernel"
                              r"(?:ILi(\d+)E(?:Lb([01])E)?)?", entry)
            if found:
                used = int(re.search(r"Used (\d+) registers", entry).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
                short, n_, one_p = found.groups()
                at = (f"<N {n_}" + ("" if one_p is None else
                                    f", {'P 64' if one_p == '1' else 'P > 64'}") + ">"
                      if n_ else "")
                log(f"   ssd_bwd_wgmma_{short}_kernel{at}: {used} registers, {spill} bytes of "
                    "spill stores")
                if n_ in (None, "128") and one_p in (None, "1"):
                    bwd_ptxas["k3_wgmma"].update({f"registers_{short}": used,
                                                  f"spill_bytes_{short}": spill})
                continue
            # the bf16 backward routes: K1-bwd's kernels, one line a kernel
            # and head_dim, and K3-bwd's staged bf16 instantiations
            found = re.search(r"flash_bwd_wgmma_(dkdv|dq)_kernelILi(\d+)E|"
                              r"flash_bwd_bf16_(delta)_kernel|"
                              r"ssd_bwd_(\w+?)_kernelI13__nv_bfloat16E", entry)
            if found:
                used = int(re.search(r"Used (\d+) registers", entry).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
                if found.group(4):
                    short = found.group(4)
                    log(f"   ssd_bwd_{short}_kernel<bf16>: {used} registers, {spill} bytes of "
                        "spill stores")
                    bwd_ptxas["k3_bf16"].update({f"registers_{short}": used,
                                                 f"spill_bytes_{short}": spill})
                else:
                    short = found.group(1) or found.group(3)
                    at = f"<{found.group(2)}>" if found.group(2) else ""
                    kind = "wgmma" if found.group(2) else "bf16"
                    log(f"   flash_bwd_{kind}_{short}_kernel{at}: {used} registers, {spill} bytes "
                        "of spill stores")
                    if found.group(2) in (None, "128"):   # qwen3-14b's head_dim
                        bwd_ptxas["k1_bf16"].update({f"registers_{short}": used,
                                                     f"spill_bytes_{short}": spill})
                continue
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
            # K1-bwd's 3xTF32 kernels, one line a kernel, element type and
            # head_dim; K4-bwd and K3-bwd
            found = re.search(r"(flash_bwd_dkdv_kernel|flash_bwd_dq_kernel|flash_bwd_delta_kernel|"
                              r"flash_bwd_reduce_kernel)I(f|13__nv_bfloat16)(?:Li(\d+))?E|"
                              r"(rglru_bwd_chunk_kernel|ssd_bwd_\w+?_kernel)", entry)
            if found:
                kernel = found.group(1) or found.group(4)
                used = int(re.search(r"Used (\d+) registers", entry).group(1))
                spill = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
                args = [{"f": "fp32", "13__nv_bfloat16": "bf16"}[found.group(2)]] \
                    if found.group(2) else []
                args += [found.group(3)] if found.group(3) else []
                log(f"   {kernel}{f'<{chr(44).join(args)}>' if args else ''}: {used} "
                    f"registers, {spill} bytes of spill stores")
                if kernel == "rglru_bwd_chunk_kernel":
                    bwd_ptxas["k4"].update(registers=used, spill_bytes=spill)
                elif kernel.startswith("ssd_bwd_"):   # one pair a pass
                    short = kernel[len("ssd_bwd_"):-len("_kernel")]
                    bwd_ptxas["k3"].update({f"registers_{short}": used,
                                            f"spill_bytes_{short}": spill})
                elif found.group(3) == "256" and found.group(2) == "f":   # the train call's
                    short = kernel.split("_")[2]
                    bwd_ptxas["k1"].update({f"registers_{short}_256": used,
                                            f"spill_bytes_{short}_256": spill})
                elif found.group(2) != "f" and found.group(3) == "16":   # bf16 at head_dim 16
                    short = kernel.split("_")[2]
                    bwd_ptxas["k1_d16"].update({f"registers_{short}": used,
                                                f"spill_bytes_{short}": spill})

    phase_s = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args, **kw):
        """Run one phase; its seconds go into phase_s and on a line of
        their own. Then its tensors go back to the card: a tensor that a
        reference cycle holds (a model's modules, a server's threads, a
        mesh) lives on until Python's collector runs, and no allocation on
        the card makes it run, so a later phase could find the card full.
        A phase that leaves more than 1 GB allocated is collected, since a
        collection costs host time; the line gives the memory allocated
        before and after."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        held, t1 = torch.cuda.memory_allocated() / 1e9, time.perf_counter()
        if held > 1.0:
            gc.collect()
        torch.cuda.empty_cache()
        log(f"   phase {name}: {phase_s[name]:.1f} s; card memory allocated after it "
            f"{held:.2f} GB, {torch.cuda.memory_allocated() / 1e9:.2f} GB after "
            f"{time.perf_counter() - t1:.2f} s of collection")
        return out

    rows = timed("kernels", kernel_phase, k1_ptxas, k4_ptxas, bwd_ptxas)
    timed("kernels bf16 backward", bf16_kernel_phase, rows, bwd_ptxas)
    # each path is driven with the counts set to 0 just before it and read
    # just after; a kernel's launches are the sum over the paths that run it
    # (K1 and K2 run on qwen3's and RecurrentGemma's)
    serve_metrics, launches = {}, dict.fromkeys(rows, 0)

    def add(counts):
        for name in launches:
            launches[name] += counts.get(name, 0)

    for arch in SERVE:
        counts, serve_metrics[arch] = timed(f"serve {arch}", serve_phase, arch)
        serve_metrics[arch]["seconds"] = phase_s[f"serve {arch}"]
        add(counts)
    # qwen3-14b at its production TP padding, under a one-rank device mesh
    counts, sharded_metrics = timed("sharded serve qwen3-14b tp16", sharded_serve_phase,
                                    serve_metrics["qwen3-14b"])
    sharded_metrics["seconds"] = phase_s["sharded serve qwen3-14b tp16"]
    add(counts)
    # the same decode on 2 and 4 ranks of the card, each its own process:
    # a comparison with K2 on the whole cache, not a main path's launches
    seq_metrics = timed("sequence-sharded decode on ranks", seq_shard_phase)
    reshard_metrics = timed("reshard", reshard_phase)
    # a comparison with the plain versions: its launches are not the path's
    ring_metrics = timed("ring wrap gemma2-9b", ring_wrap_phase)
    # mamba: 150 tokens span two of K3's 64-step chunks and a tail;
    # RecurrentGemma and gemma2: 150 tokens overflow the reduced config's
    # window of 32, so K1's window mask and the ring's wrap in prefill and
    # decode all run
    timed("parity qwen3-14b", parity_phase, "qwen3-14b", 24)
    timed("parity mamba2-2.7b", parity_phase, "mamba2-2.7b", 150)
    timed("parity recurrentgemma-2b", parity_phase, "recurrentgemma-2b", 150)
    for arch in DENSE_PARITY:
        timed(f"parity {arch}", parity_phase, arch, 150)
    # the encoder-decoder: 12 tokens against the reduced config's 8 frames,
    # so that K1's cross call (fp32, 3xTF32) has k and v of a length of their own
    timed("parity seamless-m4t-large-v2", parity_phase, "seamless-m4t-large-v2",
          ENCDEC_PARITY_PROMPT)
    for arch in MOE_ARCHS:
        for cf in MOE_CAPACITY:
            timed(f"parity {arch} cf {cf}", parity_phase, arch, 150, capacity_factor=cf)
    timed("grad guards", grad_guard_phase)
    timed(f"train parity {TRAIN['arch']}", train_parity_phase)
    train_parity = {}
    for arch in TRAIN_PARITY:
        train_parity[arch] = timed(f"train parity {arch}", family_train_parity_phase, arch)
    for arch in BF16_TRAIN_PARITY:
        train_parity[f"{arch} bf16"] = timed(f"train parity {arch} bf16",
                                             bf16_train_parity_phase, arch)
    train_metrics = {}
    for arch in TRAIN_ARCHS:
        counts, train_metrics[arch] = timed(f"train {arch}", train_phase, arch)
        add(counts)
    # training at the reference's production dtypes; qwen3-14b's params and
    # moments then go on to remat "dots" against "full"
    remat_metrics = None
    for arch in BF16_TRAIN:
        keep = arch == "qwen3-14b"
        counts, train_metrics[f"{arch} bf16"], *kept = timed(
            f"train {arch} bf16", train_phase, arch, production=True, keep=keep)
        add(counts)
        if keep:
            counts, remat_metrics = timed("remat dots", remat_dots_phase, *kept[0])
            add(counts)
            del kept
            gc.collect()
            torch.cuda.empty_cache()
    # and the smoke configs (head_dim 16) at those dtypes: K1-bwd's 3xTF32
    # kernels on bf16
    counts, train_metrics["smoke configs bf16"] = timed("train smoke configs bf16",
                                                        bf16_smoke_train_phase)
    add(counts)
    timed("train restart", train_restart_phase)
    # the R2D2, V-trace, device-backend and wire paths, the figures and the
    # ops planes reach none of the port's kernels: the counts are set to 0
    # before their phases (10-19) and must read 0 after
    from repro_torch.kernels import flash_attention as K1, ops, ssd_scan as K3
    ops.reset_launch_counts()
    timed("r2d2 parity", r2d2_parity_phase)
    r2d2_metrics = {"learner": timed("r2d2 learner", r2d2_learner_phase)}
    r2d2_metrics["system"] = timed("r2d2 system", r2d2_system_phase)
    vtrace_metrics = {"parity": timed("vtrace parity", vtrace_parity_phase)}
    vtrace_metrics["system"] = timed("vtrace system", vtrace_system_phase)
    device_metrics = {"parity": timed("device parity", device_parity_phase)}
    device_metrics["system"] = timed("device system", device_system_phase)
    wire_metrics = timed("wire", wire_phase)
    figure_metrics = timed("figures", figures_phase, card, r2d2_metrics,
                           vtrace_metrics["system"], device_metrics["system"])
    ops_metrics = timed("ops", ops_phase, card)
    counts = ops.launch_counts()
    if any(counts.values()) or any(K1.flash_attention.launches_by_route.values()) \
            or any(K3.ssd_scan.launches_by_route.values()):
        raise AssertionError(f"the R2D2, V-trace, device-backend, wire, figures or ops "
                             f"phases launched a port kernel: {counts}")
    log(f"   R2D2, V-trace, device-backend, wire, figures and ops phases: kernel launches "
        f"{counts} (none, as the paths have no Pallas kernel)")
    counts, quick_metrics = timed("quickstart", quickstart_phase, card)
    add(counts)

    # the dry run needs no card; it runs alone, so no phase's times share
    # the host with it
    dryrun_metrics = timed("dry run", dryrun_phase)

    for name, row in rows.items():
        row["launches"] = launches[name]
    for arch, metrics in serve_metrics.items():
        log(f"serve {arch}: {json.dumps(metrics)}")
    log(f"sharded serve qwen3-14b tp16: {json.dumps(sharded_metrics)}")
    log(f"sequence-sharded decode on ranks: {json.dumps(seq_metrics)}")
    log(f"reshard: {json.dumps(reshard_metrics)}")
    log(f"dry run: {json.dumps(dryrun_metrics)}")
    log(f"ring wrap gemma2-9b: {json.dumps(ring_metrics)}")
    log(f"seconds of every phase: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    for arch, metrics in train_parity.items():
        log(f"train parity {arch}: {json.dumps(metrics)}")
    for arch, metrics in train_metrics.items():
        log(f"train {arch}: {json.dumps(metrics)}")
    log(f"remat dots: {json.dumps(remat_metrics)}")
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
