#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`kubeflow_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card (`nvidia-smi` name and power limit) and builds the
   CUDA kernels from `kubeflow_tpu_torch/ops/csrc` (one `nvcc` a source,
   all at once), timing the build and printing each kernel's registers
   and spills at every (element type, head_dim) it is built for.
2. Kernel phase, every instantiation of the flash kernels' domain
   (`KERNEL_DOMAIN`: bf16 and f16 at head_dim 64 and 128 on the three
   warp-specialised sm_90a kernels, a TMA producer thread feeding an
   mbarrier ring and two consumer warpgroups running wgmma; bf16 and
   f16 at 256 on the wgmma forward (64-key tiles) and dq (32-key tiles)
   and the split wgmma dk/dv of flash_bwd_dkv_split.cu; f32 at 64, 128
   and 256 on the three SIMT kernels of flash_simple.cu, f32 FMAs on 64
   x 64 tiles, register-blocked, their streamed operands in cp.async
   rings), at llama-1b's attention shapes (q
   [8, 2048, 32, 64] with 8 kv heads; llama-1b-hd128's [8, 2048, 16,
   128] with 4; [8, 2048, 8, 256] with 2), causal: runs each kernel and
   holds it against its plain PyTorch version on the same inputs, the
   plain version blocked at that kernel's own tiles (`KERNEL_TILES`),
   then again with a sliding window and with packed-sequence segment
   ids. The limit is per row (`kubeflow_tpu_torch/ops/kernel_check.py`):
   every row's L2 error within 1e-2 of that row's L2 norm (2e-2 for dq,
   whose rows cancel), lse within 1e-3.
   Times each kernel, its plain version and the PyTorch library call for
   the same function (scaled_dot_product_attention at that dtype, TF32
   off, forward / backward): CUDA events around a run of back-to-back
   launches, per launch, the median of such runs, so the host's launch
   overhead overlaps the device's work. Works out each kernel's bound at
   its dtype's peak (f32: the CUDA cores' FMA rate).
3. LM-head check: the card's bf16 head GEMM (`ops/xent.py`) against its
   plain f32 formula on the same card tensors, at one main-path chunk:
   logits, dx and dkernel, each within 1e-2 per row.
4. Small reference check: a 2-layer llama-1b-width model gives the same
   logits through the flash kernel as through reference attention, each
   token's logits within 2e-2 per row (two layers of bf16 activations).
   Then the D256 model check: llama-1b's width over 8 heads of 256 with
   2 kv heads, 2 layers, one batch [8, 2048], one forward and backward
   each in bf16 through flash, in bf16 through reference attention and
   in f32 through reference attention, same weights: flash's logits
   within 2e-2 per row of the bf16 reference's, its loss within 1e-2
   relative, each gradient within 1e-2 per row beyond the bf16
   reference's own row error against the f32 run, and 2 launches each
   of flash_fwd, flash_bwd_dq and flash_bwd_dkv_split at bfloat16/256
   (none of any other kernel, flash_simple_bwd_dq among them).
5. Remat check: a 2-layer llama-1b-width bf16 model, one batch [8, 2048],
   8 xent chunks. Under each remat policy (full, dots, mlp, slim,
   slim@1) the loss and every parameter gradient are held against no
   remat, per row within 1e-2 (the largest difference is printed; it
   should be 0), and the flash forward must launch twice per layer under
   full, which replays it, and once under the others.
6. Main paths, each through the port launcher for 5 steps at llama-1b,
   seq 2048, batch 8, 8 xent chunks, attention_impl auto; each must
   launch every kernel 16 times a step (one per layer) with a finite
   loss: (a) the first slices' adamw with no remat; (b) the operating
   point `tools/lm_best.json` pins for the reference: adafactor, slim
   remat, with `bench.py run_lm`'s lr 3e-4, warmup 5 and weight_decay
   1e-4. Under slim, 16 forward launches a step are the proof that no
   flash forward replays.
7. Gradient accumulation: the pinned config at 4 layers with
   grad_accum_steps 2, 2 steps: every kernel launches 2 x 4 times a
   step, and the loss is finite.
8. Profile: the pinned config, then the adamw one: two warm-up steps,
   then two under torch.profiler (three before PR 19, which cut one to
   keep the script in its time: about 5 s of trace processing); prints
   the device time by kind of kernel, the device's busy share of the
   step and the peak device memory, then the optimizer update's own
   kernel time (two updates profiled by themselves), so the breakdowns
   and the main paths' numbers come from one run.
9. Serving, (a) correctness: gpt-350m width, 4 layers, f32, TF32 off,
   8 ragged prompts (a shared-prefix pair among them): the slot
   decoder's greedy tokens, dense and paged (page size 16), equal
   generate()'s; chunked prefill equals the per-token oracle, logits
   within 1e-4 per row; the page allocator checks clean and every page
   is free for admission at the end; an int8 KV-cache run agrees with
   the f32 run on >= 75% of generated tokens and int8 weights give
   prompt logits that correlate with f32's above 0.99 (the reference's
   bars, tests/test_quant.py); the int8-weight run's share of equal
   generated tokens is printed: one flipped token changes the rest of
   its row, and on a random model of this width the reference's own
   share is as low (tests/test_torch_quant.py). At bf16: chunked prefill
   against the oracle within 2e-2 per row; the bf16-vs-f32 logits row
   error and the share of identical tokens are printed, not held.
10. Serving, (b) the pinned point (`tools/serve_best.json` with
   prompt_len 512): gpt-350m at full depth, bf16, int8 weights, the
   continuous decoder with 16 slots, vocab 32000, random weights from
   seed 0, behind the port's ModelServer on 127.0.0.1: a warm-up of one
   two-instance predict (not the reference's 31 requests: the script's
   time), then 32 requests at concurrency 16 over HTTP; every response must hold 64
   ids in range. Prints tokens/s, requests/s, p50/p95/p99, peak memory
   and the cache's bytes; then 16 ticks of the same decoder with every
   slot busy, timed on the host clock, and 8 more under torch.profiler:
   device time per tick by kind (projection GEMMs, attention bmm,
   sampling, the rest: elementwise, casts and dequantization) against
   the host time per tick, and 16 ticks with the weights dequantized
   once up front (what dequantizing at every tick costs). The dense
   cache must hold 905,969,664 bytes.
11. Entry (run after phase 4): `kubeflow_tpu_torch.entry.entry()` on
   the card (gpt-125m widths, 4 layers, vocab 8192, zero params, tokens
   ones [2, 256], bf16): logits [2, 256, 8192], finite, and 4 flash
   forward launches (one per layer); the flash forward against its
   plain version at that shape ([2, 256, 12, 64], 12 kv heads) per
   row, timed with its plain version and SDPA; then random weights
   (seed 0) at the same config, flash against reference attention,
   within 2e-2 per row.
12. Rolling cache: (a) gpt-350m width, 4 layers, f32, window 16,
   prompts of up to 24 tokens and 24 new (the cache wraps twice): the
   rolling cache's greedy tokens equal the full cache's under the same
   window, for generate() and the slot decoder, dense and int8 cache,
   and its tensors are W-sized; (b) phase 10's point with window 256
   and the rolling cache (prompts up to 511 tokens wrap it at
   prefill), 16 requests (phase 10's 32 halved to keep the script in
   its time) after a warm-up of one two-instance predict, as phase
   13b's (PR 19 dropped phase 10's warm-up of 31 requests here for the
   script's time: 33.7 of the phase's 70.7 s were set-up and that
   warm-up in PR 19's first whole run, against 12.5 s for phase 13b's):
   the cache must hold exactly 402,653,184 bytes; the same figures and
   tick profile as phase 10.
13. Speculative decoding: (a) 4 layers, f32: speculative_generate and
   the lockstep slot decoder, dense and paged target, equal greedy
   generate(), with the target's own weights as the draft (accepted ==
   drafted) and with an independent draft; (b) phase 10's point with
   a gpt-125m draft (int8, random from seed 1) and k 4, 16 requests:
   acceptance rate, rounds, tokens/s, p50/p95, peak memory; in bf16
   the share of tokens equal to phase 10's plain greedy is printed,
   not held, beside a witness of why rows differ: for each row, at its
   first differing token, the bf16 target's top-1 minus top-2 logit
   margin on that row's prefix, against the margins of the steps
   before it, and whether the two runs' tokens are that forward's top
   two; (c) the same point computed in f32 (TF32 off) with the target
   cut to 6 of its 24 layers (the script's time; the hold is the same
   at any depth), 16
   requests through the speculative server and a plain one: tokens
   equal token for token (16 busy slots, prompts of up to 511 tokens
   left-padded to 512, int8 target and draft).
14. Router: two ModelServer replicas on the card (gpt-350m width, 4
   layers, f32, continuous batching, paged cache) behind the port's
   RouterFrontend over HttpTransport, 16 concurrent predicts: both
   replicas serve, every response equals a direct replica call, and
   router_queue_depth returns to 0.
15. Resume (run after phase 8): the training runtime at the pinned
   point through `python -m kubeflow_tpu_torch.runtime.launcher` as a
   subprocess, under an injected TRACEPARENT with KFTPU_TRACE_FILE set
   and CUBLAS_WORKSPACE_CONFIG=:4096:8. Packed KFR1 shards from numpy
   draws (documents of 64-3000 tokens packed at seq 2048 with
   `pack_documents`, 8 batches over two shards, and an eval shard of 2
   batches) read by the native loader (`RecordDataset(native=True)`,
   g++-built) through the Prefetcher, so segment ids reach the flash
   kernels; shuffle_buffer 16, checkpoint_every 2, keep 2, eval every 3
   steps over 2 batches, a profiler window at step 2. Run A is SIGTERMed
   after its "step 3" line: exit 75, a strictly valid summary with
   "preempted", the preempted step on disk and in manifest.json, the
   profile naming the three flash kernels. Run B resumes it to step 6:
   start_step that step, exit 0, a finite eval with smoke 0. Run C
   trains 6 steps straight, sharing the card with run A (its step times
   are not read), with two jobs of its own: its checkpoint directory
   is a `file://` URI, so fsspec's path writes its step (committed by
   its marker) and restores the params B is held to (where fsspec does
   not import, the refusal is held instead and the URI path is printed
   as untested); and JAXRT_PROFILER_PORT=0 starts its on-demand capture
   server, whose port is read from its log: after its first step a
   `GET /capture?steps=2` must answer a Chrome trace of two consecutive
   steps holding exactly the flash kernels' launches of those steps (16
   of each a step, 16 more forwards per eval batch in the window), by
   kernel event. B's final parameters
   are held to C's per row within 1e-2, the final losses within 1e-3
   relative (the largest difference is printed); every run launches
   each kernel 16 times a step and the forward 16 more per eval batch
   (read from each launcher's log line); each trace dump is one tree
   (worker under the injected parent, train.fit under worker,
   train.step and train.checkpoint inside). Prints the checkpoint's
   bytes, and from run B, the phase's only run then (phases 30 and 35
   may still share the card and the host), the seconds each save blocks
   the loop and writes in the background, the restore's seconds, the
   step time on shards against
   phase 6's synthetic one, and the seconds a restart spends skipping
   2,500 consumed batches before its first step (token_batches over the
   looped shards, and the record reader alone; 10,000 before PR 19,
   which cut them for the script's time: the two loops took 9.86 and
   9.01 s of the phase in PR 19's first whole run).
16. Serve from checkpoint: `serve_lm_generator(checkpoint_dir=` run B's
   `)` on llama-1b, continuous batching, 4 slots, 4 greedy requests of
   32 new tokens, against generate() on the params `restore_params`
   reads: in f32 (TF32 off) the tokens are equal; in bf16 the share of
   equal tokens is printed and a row may differ only at a near tie: the
   two runs' tokens the top two of that forward, and its top-1 minus
   top-2 margin under 0.25x the median margin of the agreeing steps.
   A draft checkpoint directory with no step fails registration. The
   checkpoints are removed at the end.
17. ResNet-50 through the launcher: `examples/resnet50.yaml` (batch
   256, 224px, space_to_depth, sgdm, bf16) in a copy with total_steps
   10, log_every 5 and a checkpoint directory, run as
   `python -m kubeflow_tpu_torch.runtime.launcher` in a subprocess:
   exit 0, a finite loss, a summary line and no flash launch; prints
   images/s, step ms, MFU (the StepMeter over `fwd_flops`: 6.34 TFLOP
   a step) and the peak memory the launcher logs. Then the profile of
   phase 8 on that config: device time of a step by kind of kernel
   (convolutions, BatchNorm, elementwise, the SGD update), the busy
   share and the peak memory.
18. ResNet-50 on the card against the CPU: full width and depth, batch
   8, 224px, the same weights, f32 with TF32 off. After one sgdm step,
   the train-mode logits before it and the eval-mode logits after it
   and every BatchNorm statistic within 1e-3 relative, every parameter
   within 1e-2 per row; then bf16 on the card against that f32 run,
   logits within 2e-2 per row.
19. Classifier server: `serve_flax_classifier("resnet50")` behind the
   port's ModelServer on 127.0.0.1 answers 8 predicts over HTTP, its
   softmax rows sum to 1 within 1e-3 and equal a direct call to the
   model within 1e-3; then the same from phase 17's checkpoint, whose
   batch_stats must have moved. Prints p50 latency.
20. ViT-B/16 (batch 128, 224px; 13.4 TFLOP a step) and BERT-base (seq
   512, batch 32, every other row ending in 64-383 pad tokens, so the
   segment mask is exercised; 9.28 TFLOP a step): 5 sgdm steps each in
   bf16 through the Trainer, a finite loss, no flash launch, step ms,
   MFU and peak memory; then bf16 against f32 on the card with the
   trained weights: the final norm's output within 2e-2 per token row,
   and ViT's logits within 2e-2 per row (BERT's two logits a row are
   printed, not held: the reference's own bf16 logits miss that limit,
   tests/test_torch_bert.py).
21. The world on one card (`examples/gpt-125m.yaml`'s model and data
   shape at full width and depth: gpt-125m, seq 1024, vocab 32000,
   global batch 64, adamw, remat, the loss in 8 chunks (the pinned main
   path's `xent_chunks`; it takes a rank's peak from 19.1 to 6.6 GB
   reserved); mesh data 2, since the yaml's fsdp 4 x model 2 needs 8
   GPUs): (a) two port launchers
   (`JAXJOB_NUM_PROCESSES=2`, `JAXJOB_PROCESS_ID` 0 and 1, a local
   coordinator, `--nproc-per-node 1`) share the card over gloo (NCCL
   refuses two ranks on one device) for 3 steps at local batch 32: both
   print the same losses, each launches each flash kernel 12 times a
   step (the forward 24: full remat replays it), and the final params
   equal one process at global batch 64 per row within 1e-2, the final
   loss within 1e-3 relative; prints each rank's step time and the
   gradient reduce's share of it (the `train.grad_reduce` spans). (b)
   the same world to a total of 5 steps, rank 1 SIGTERMed after step 2:
   both ranks stop at one step and exit 75; one process resumes that
   world-2 checkpoint at world 1 to step 5 and is held like (a) against
   5 straight one-process steps. Three waves share the card, none of
   whose times a check holds: the one-process run with (a)'s world,
   (a)'s control with (b)'s world, (b)'s two resumes; phases 34 and 36
   run beside them.
22. NCCL at one rank: a one-rank NCCL world through the port's `gpu`
   backend, a DeviceMesh on cuda, an all-reduce, a reduce-scatter /
   all-gather round trip and the backend's hierarchical_reduce on card
   tensors, held exactly; prints the NCCL version. Multi-rank NCCL,
   FSDP and tensor parallelism need more than one GPU: they are held on
   the CPU (tests/test_torch_spmd.py).
23. MoE training: gpt-moe-8e (24 layers, 8 experts top-2 every second
   layer) through the port launcher at the reference's MoE point: batch
   4, seq 2048, dots remat, adafactor, 8 xent chunks, flash attention,
   synthetic tokens, 7 steps: a finite loss, moe_sparse_dispatch 1.0
   (the trainer's one-rank mesh takes the sparse path) and 24 launches a
   step of each flash kernel (dots saves the forward's out and lse);
   then `kubeflow_tpu_torch.bench`'s run_lm at that point, 2 warm-up and
   5 timed steps: ms per step, tokens/s, MFU over active parameters,
   peak memory and the moe_* keys; then phase 8's profile of that
   config (one profiled step), with the device time inside the MoE forward's moe.router,
   moe.dispatch, moe.experts and moe.combine ranges.
24. MoE block at gpt-moe-8e's width (batch 2, seq 2048, bf16, capacity
   factor 4, so no token drops): the sparse dispatch's output and
   gradients against the dense one-hot oracle's per row within
   MOE_BLOCK_TOL; a planted control (one routed token's gate zeroed)
   must exceed it; fill and drop of both paths at capacity factor 1.25.
25. MoE card vs CPU: gpt-moe-8e at 2 layers, f32, TF32 off, batch 2,
   seq 256, the same weights: losses of two sgdm steps within 1e-3
   relative and the parameters after them within 1e-2 per row (phase
   18's limits).
26. MoE serving: gpt-moe-8e at full depth in f32 through
   serve_lm_generator, the generator (batching window 50 ms) and the
   continuous slot decoder (4 slots), 4 greedy requests of 32 new
   tokens at concurrency 4 each:
   tokens/s, and equal tokens (neither has a mesh, so both take the
   reference's meshless dense dispatch); no flash launch.
27. Long-context dispatch at one rank: llama-1b cut to 4 layers and
   batch 2, seq 2048, through the launcher with attention_impl flash,
   ulysses, reference and ring, 3 steps each: Ulysses launches the
   flash kernels exactly as flash (4 a step of each), ring none, as
   reference; final losses ulysses vs flash and ring vs reference within
   1e-3 relative, flash vs reference within 2e-2.
28. gloo on CUDA tensors: two `--gloo-probe` ranks sharing the card over
   gloo try all_to_all, all_gather, broadcast and send/recv of CUDA
   tensors (nothing staged through the host by the probe) and print what
   gloo answers (on torch 2.11: all_to_all, all_gather and broadcast
   work, send/recv crashes the sender).
29. Expert 2 on one card: two port launchers over gloo, mesh data 1 x
   expert 2 (gpt-moe-8e cut to 4 layers, seq 1024, batch 8, capacity
   factor 4, adamw, 3 steps, f32 with TF32 off and the plain attention,
   so no flash launch), the sparse dispatch's all-to-all across the
   ranks, against one process on the dense oracle: equal rank losses,
   moe_sparse_dispatch 1.0 on the ranks and 0.0 on the one process,
   each rank's parameter change per row within 1e-2 of one process's
   (its slice of the experts against that slice), a
   planted control (the all-to-all returning its input) beyond it, the
   final loss within 1e-3 relative. Its three worlds and phase 28's
   probe start at once (their step times are printed, not held).
30. The LM over a serving mesh: llama-1b at full width served by two
   ranks of `python -m kubeflow_tpu_torch.serving --mesh model=2`
   sharing the card over gloo (continuous batching, 4 slots, prompt_len
   128, 8 new tokens, 8 ragged requests over HTTP to rank 0, so the
   second four reuse the slots): in f32 (TF32 off), at 4 of its 16
   layers (for the script's time, when the job path was added, the f32
   worlds were cut from 16 layers to 4 and every request from 16 new
   tokens to 8: the tick is gloo's all-gathers, whatever the depth), the
   tokens equal one process's slot decoder on the same seeded weights
   and depth, and a planted control (rank 1 seeded 1) differs; each
   rank's device memory placing and serving, tokens/s, rank 0's host ms
   per tick and the share of it blocked in collectives (gloo: the
   collectives' own time); both ranks launch no flash kernel while
   serving; then bf16 at full depth, the share of equal tokens printed.
31. The classifiers on meshes: ViT-B/16 served at model=2 by two CLI
   ranks, 8 images' softmax rows within 1e-5 of one process (f32),
   beside the training runs; ViT-B/16 trained 3 steps at model=2 and at fsdp=2 (batch 16, 224 px)
   and ResNet-50 one step at fsdp=2, by two port launchers over gloo:
   each rank's parameter change per row within 0.25 of one process's
   (phase 21's limit), a planted control beyond it (model: no sum of the
   partial outputs; fsdp: no gradient reduce-scatter), ResNet-50's
   BatchNorm statistics within 1e-3 relative of one process's; neither
   the serving ranks nor the training ranks launch a flash kernel.
32. The seq axis with local attention on one card: llama-1b at full
   width (d 2048, 32 q / 8 kv heads of 64) cut to 4 layers, seq 2048,
   global batch 4, adamw, 3 steps, synthetic tokens, f32 with TF32 off;
   at once: one process, two ranks at mesh seq 2 with attention_impl
   auto over gloo (each rank's q block over the key prefix gathered from
   both, `ops/seq_attention.py`: the f32 SIMT kernels, once per layer a
   step on each rank), the planted control `no-kv-gather` (each rank
   attends its own block only), two Ulysses ranks at seq 2 and their
   control `no-ulysses-exchange` (the all-to-alls return their input):
   each rank's parameter change per row within 1e-2 of one process's,
   each control beyond it, equal rank losses, the final loss within 1e-3
   relative; the same seq world in bf16 beside the Ulysses worlds (alone
   after them until phase 36 was added: the script's time), its step ms
   (not held) and its wgmma kernel launches. Prints each world's
   start-up breakdown (`_startup`).
33. Classifier remat: ResNet-50 at examples/resnet50.yaml's point
   without remat and with whole-forward remat `full` and `dots`, from
   the same weights and batch: after two steps each remat run's
   parameters within 1e-2 per row of no remat's, its eval-mode logits
   and BatchNorm statistics within 1e-3 relative; step ms, images/s and
   peak GB of each; no flash launch.
34. The control plane's job path: one GPU node on the port's
   FakeCluster (its product label the card's name in GKE's spelling,
   nvidia.com/gpu: 2, two ranks sharing the card over the loopback
   backend), the port's JAXJob controller, gang scheduler and
   LocalPodExecutor running a JAXJob of 2 one-GPU workers whose default
   command is the port's launcher, on phase 21's config (gpt-125m at
   full width and depth, bf16, flash, full remat), 5 steps, a checkpoint
   directory: the pods claim nvidia.com/gpu: 1 with the product and
   node-pool selectors before the gang gate lifts; a third 1-GPU gang
   stays gated and unbound while the first runs; the sidecar gate is
   True on the card and False on an empty root; both ranks log equal
   losses and launch each flash kernel 12 times a step (the forward 24);
   a SIGTERM to rank 1 after its step 2 stops both ranks at one step
   with exit 75, the job counts preemptions 1 and restarts 0, and the
   recreated gang resumes at that step and ends Succeeded; prints the
   condition sequence, each incarnation's launch-to-first-step seconds
   and step time (not held: it runs beside phase 21 and phase 36).
35. The control plane's services path: one GPU node on the port's
   FakeCluster (nvidia.com/gpu: 2) behind the port's ApiServer on
   127.0.0.1; the gang scheduler as its own process (`python -m
   kubeflow_tpu_torch.control.scheduler --enable-leader-election`); the
   JAXService controller in-process on the port's RestClient, its drain
   gated by RegistrySignals over the router's registry; the
   LocalPodExecutor running `examples/jaxservice.yaml`'s service (its
   `tpu:` as `gpu:`, gpt-125m at full width and depth with seeded
   weights, bf16, 16 slots, prompt 512, 64 new tokens, replicas 2) as
   two `python -m kubeflow_tpu_torch.serving` processes sharing the
   card; the router in-process, its members only from `watch_endpoints`.
   Holds each replica's GPU claim, selectors and command before its gang
   gate lifts, the scheduler's Lease, Ready with two endpoints, 16
   concurrent requests answered with 64 tokens by both replicas, a
   scale-down to 1 with 8 requests in flight (cordoned, no new dispatch,
   every request answered, deleted only after its in-flight tokens read
   0, its process gone), the service's deletion (the last process gone)
   and the scheduler's exit 0 on SIGTERM with its Lease released
   (`services_phase`).
36. The platform's user path: the port's FakeCluster with one GPU
   node (the card's product, nvidia.com/gpu: 2: two trials share the
   card) behind the port's ApiServer; the Profile, Notebook, JAXJob and
   StudyJob controllers and the gang scheduler in-process on the port's
   RestClient; the Jupyter web app over HTTP; the LocalPodExecutor as
   the kubelet, through `Spawned`. A Profile `team-ml` with a quota of
   requests.nvidia.com/gpu: 2 (namespace, owner binding, the quota
   naming no TPU); a notebook POSTed to the JWA as a user with the form
   `gpu: {count: 1, product}` (the CR's limit and selector, the
   StatefulSet's pod template claiming nvidia.com/gpu: 1, the JWA's
   list; no pod runs: the JAX package has no StatefulSet controller);
   examples/studyjob-sweep.yaml cut to a grid over `opt` (adamw,
   adafactor) at one `lr`, two one-GPU trials at once, each the port's
   launcher with a `--config` written for its ${opt}: gpt-125m at full
   width and depth, seq 1024, global batch 16, bf16, flash, full remat,
   3 steps. Holds each trial pod's GPU claim, selectors and command
   before its gang gate lifts, each trial's flash launches (phase 34's
   count) and finite final.loss, the collector's objective annotation
   read from the pod's summary line, Running -> Succeeded, bestTrial the
   lower loss, and the deletion taking the trials (`user_path_phase`).
   It runs on a thread beside phase 34, whose times no check holds
   (`beside`: the script's time); its own seconds, and phase 34's,
   are printed.
37. The platform's deploy path: `tpctl`'s Coordinator applies a TpuDef
   with platform gke-gpu (the card's product in GKE's spelling, a pool
   of its one GPU) through `GkeGpuPlatform`, whose runner is a stateful
   gcloud double (the card's machine has no gcloud): one create of
   a3-highgpu-8g with `--accelerator=type=<product>,count=8`, one node,
   the product and node-pool labels; a second apply creates nothing and
   writes no object; TpuDefAvailable; every rendered object stored;
   every rendered `python -m kubeflow_tpu_torch....` of a ported
   component found (kfam, the gatekeeper and the metric collector
   among them since phase 38's slice), those of the two not yet ported
   (`manifests.UNPORTED`: the dashboard, the Tensorboards web app)
   absent. The node
   added for the card carries the create's labels. The PodDefault
   webhook's own `serve()` (plain HTTP: TLS is held on the CPU, and
   nothing here imports `utils/tlscerts`) answers the cluster's
   admission hook, which applies its JSONPatch; a PodDefault injects
   KFTPU_TRACE_FILE under a Tensorboard's logspath into the pods of a
   JAXJob of 1 replica of 1 GPU whose default command (the port's
   launcher) trains phase 36's config (gpt-125m at full width and depth,
   seq 1024, batch 16, bf16, flash, full remat, adamw, 3 steps) with a
   profiler window over steps [1, 3) under the logspath. Holds the bound
   pod's GPU claim, selectors, injected env and annotation, Succeeded,
   the span dump at the injected path (3 train.step spans), 72 / 36 / 36
   launches, a Tensorboard's Deployment with `--logdir` that logspath
   and the trace under it holding 48 / 24 / 24 flash kernel events (the
   launches of its two steps); then the job, the Tensorboard and the
   deployment are deleted (the double's pool gone) and every process
   reaped (`deploy_path_phase`). It runs on a lane beside phase 31.
38. The observability plane over a paged replica: the port's
   FakeCluster holds a JAXService `chat` (min 1, max 2) whose one
   replica pod, made by a reconcile of the port's JAXService
   controller, runs as `python -m kubeflow_tpu_torch.serving` through
   `Spawned`: gpt-125m at full width and depth, seeded weights, bf16,
   continuous batching with 16 slots, prompts of 512 and 64 new tokens,
   a paged KV cache of 64-token pages, 72 usable (8 requests of 9
   pages reserved at admission) plus the trash page, no prefix cache;
   the next reconcile publishes its address in the endpoints
   annotation (targetReplicas 1). The port's router in-process in front
   of it, an AvailabilityProber on its /healthz, and a FleetPlane on a
   virtual clock (15 s a tick) discovering it through
   `jaxservice_targets(cluster)`, scraping the router's and the
   prober's registries, with `default_rule_pack()` and a
   RemediationEngine over `default_remediations(client=cluster)`.
   Holds: before load up 1, 72 free pages, availability 1; 16
   concurrent requests of exactly 512 tokens through the router, a tick
   reading 0 free pages while more than 8 requests are inside the
   replica, and the ticks at +15 s and +45 s taking KVPagesExhausted
   pending -> firing (service chat, namespace default); one executed
   jaxservice-scale-up decision, the nudge annotation "2", and a
   reconcile leaving targetReplicas 2 with the annotation cleared and no
   second process; every request 200 with 64 tokens, and the next tick
   resolving the alert; `ServingSLO.from_store` counting what
   `from_registry` counted since the first tick (16 requests) and the
   slo:router_p95:short series; SIGTERM to the replica, then up 0, no
   instant serving_kv_pages_free (the staleness markers) and
   availability 0; a TsdbPersister snapshot restored into a fresh store
   answering the phase's queries alike; no flash kernel launched in the
   script's process. Prints the replica's launch to serving, the scrape
   and rule-pass ms on the host clock (not held) and the virtual
   seconds from first exhaustion to firing (`obs_plane_phase`). It runs
   beside the resume lane, after phase 35.
The order, for the script's time (a `Lane` runs phases on a thread
beside the script's own; no check holds the times of a phase that
shares the card, and each pair fits the card's 80 GB at its measured
peaks): phases 1-8 and 11 alone; phase 15 on a lane beside phases 30,
35 and 38, then 24-27 and 14 (checks whose times nothing reads), then
phase 16 alone; the serving points (10, 12b, 13b and its witness)
alone; phase 17 alone; phase 31 with phase 37 beside it on a lane
beside the checks 9, 12a, 13a, 13c, 18 and 19; the ResNet-50 profile
and phase 20
alone; phase 21 beside a lane of phase 34 with phase 36 beside it; then
phases 22, 23, 28, 29, 32 and 33 alone, in that order (phase 29's and
32's worlds each fill the card).
In-process serving loops next to launchers lose half their speed or
more (the launchers take the host's cores, in-process controllers this
process's lock), so nothing runs beside a measured in-process phase.
Each phase prints its wall seconds (and whether it ran beside a lane),
and the script its own at the end.
No process the script starts outlives it: `main()` makes it the child
subreaper of its descendants, and after every phase (after a lane's
block, for its phases and those beside it), and once more before the
last line, `check_no_stragglers` fails on any descendant
still alive (naming its pid, command line and the phase, and killing
its group); `check_no_threads` fails on a non-daemon thread left.
Any kernel that ptxas reports spilling registers fails the build phase.

Any failure exits non-zero. The lines before the last hold the
`{"kernels": [...]}` record, one row per kernel and instantiation (`name`
`kernel[dtype/head_dim]`; `launches`: the launches of that
instantiation, counted by instantiation (`flash_attention.
INSTANCE_LAUNCHES`), for bf16 at head_dim 64 on the pinned main path,
for the f32 SIMT kernels at 64 on phase 32's rank 0 and for bf16 at 256
on phase 4's D256 model check (`launches_path` names it); null for the
instantiations no path runs, which are timed at
the kernel phase's shapes; `kernel_launches_by_path`, for the three
that paths run, each path's count of the kernel over all its instantiations
(`flash_attention.LAUNCHES`, which holds all seven kernels): the
`d256_model` check, the training paths, entry, `resume`
(run B: 16 a step of each kernel, 16 more forwards per eval batch), and
the serving, rolling, speculative, router and checkpoint-serving paths
and the classification paths (resnet50, classifier, vit-b16,
bert-base), which must run none of them, `world_rank1`, phase 21 (a)'s ranks, `moe_train` (phase 23's 7 steps),
`moe_serving` (none), `ulysses` and `ring` (phase 27's 3 steps),
`expert_rank0` / `expert_rank1` (phase 29's ranks), and `mesh_serving`
(the two serving ranks of phase 30's f32 run and of phase 31's ViT run,
each counted from its reset after registration to its stop: none;
phase 31's training worlds are held at none too), `seq_f32_rank0/1`,
`uly_f32_rank0/1` and `seq_bf16_rank0/1` (phase 32's ranks),
`classifier_remat` (none), `job_rank0/1` (phase 34's ranks, both
incarnations), `services` (phase 35, this process: none; the
replicas decode by bmm in processes of their own), `obs_plane` (phase
38, this process: none; the replica decodes in its own),
`study_trial0/1` (phase 36's trials) and `deploy_trial` (phase 37's
trial); the bf16 flash forward's row also holds its
figures at the entry shape) and the card; the last line is
`{"ok": true, "device": {...}}`. Needs one CUDA GPU, `nvcc`, `g++` and
no network.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import random
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

# llama-1b attention at the training operating point
B, L, H, HKV, D = 8, 2048, 32, 8, 64
STEPS = 5
LAYERS = 16
REF_ROW_TOL = 2e-2         # 2-layer logits, flash vs reference attention
PEAK_BF16 = 989e12         # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
SRC = "kubeflow_tpu/ops/flash_attention.py"
# the main path: llama-1b at the operating point tools/lm_best.json pins
# for the reference (adafactor, slim remat, 8 xent chunks), with bench.py
# run_lm's lr 3e-4, warmup 5 and weight_decay 1e-4 (adafactor adds the
# decay unscaled by the learning rate: 0.1 would shrink the weights 10%
# a step)
MAIN_PATH = {
    "model": "llama-1b", "task": "lm",
    "model_kwargs": {"attention_impl": "auto"},
    "global_batch": B, "seq_len": L, "vocab_size": 32000,
    "optimizer": "adafactor", "learning_rate": 3e-4, "weight_decay": 1e-4,
    "warmup_steps": 5, "total_steps": STEPS, "remat": True,
    "remat_policy": "slim", "xent_chunks": 8, "seed": 0, "log_every": 1,
}
# the first slices' main path, kept beside it: adamw, no remat
ADAMW_PATH = {
    **MAIN_PATH, "optimizer": "adamw", "weight_decay": 0.1,
    "warmup_steps": 2, "remat": False,
}
REMAT_POLICIES = ("full", "dots", "mlp", "slim", "slim@1")
ACCUM_LAYERS, ACCUM_STEPS = 4, 2
# serving: the point tools/serve_best.json pins for the reference, with
# tools/serve_bench.py's default prompt_len 512
SERVE = {"model": "gpt-350m", "vocab": 32000, "prompt_len": 512,
         "max_new": 64, "slots": 16, "concurrency": 16, "requests": 32,
         "param_dtype": "int8"}
CHECK_LAYERS, CHECK_P, CHECK_N, CHECK_PAGE = 4, 64, 16, 16
# the pinned point's dense cache, and the rolling one at window 256:
# layers x (k, v) x slots x positions x kv heads x head_dim x bf16 bytes
DENSE_CACHE_BYTES = 24 * 2 * 16 * 576 * 16 * 64 * 2       # 905,969,664
ROLLING_WINDOW = 256
ROLLING_CACHE_BYTES = 24 * 2 * 16 * ROLLING_WINDOW * 16 * 64 * 2  # 402,653,184
ROLL_W, ROLL_P, ROLL_N = 16, 24, 24   # the rolling check wraps W twice
ROLLING_REQUESTS = 16
SPEC_K, SPEC_REQUESTS = 4, 16
# the f32 speculative point's target depth (of gpt-350m's 24 layers): the
# script's time; its hold (speculative tokens equal plain greedy ones) is
# the same at any depth
SPEC_F32_LAYERS = 6
SPEC_DRAFT = "gpt-125m"
ROUTER_P, ROUTER_N, ROUTER_REQUESTS = 64, 16, 16
PREFILL_ROW_TOL = 1e-4     # f32 chunked prefill vs the per-token oracle
QUANT_AGREE = 0.75         # int8 cache vs f32, generated tokens
QUANT_CORR = 0.99          # int8-weight vs f32 logits, same tokens


# the serving ranks phases 30-31 start (`_start_mesh`): a failure kills
# those still running before the script exits
_MESH_PROCS: list = []


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    for proc in _MESH_PROCS:
        if proc.poll() is None:
            proc.kill()
    sys.exit(1)


# -- the process guard ---------------------------------------------------------

PR_SET_CHILD_SUBREAPER = 36     # <linux/prctl.h>
# Helpers that by design live until this interpreter exits, by a pattern
# of their command line, each with the reason the check lets it be. The
# check reads only this table; it is empty: no phase starts one.
LONG_LIVED: dict[str, str] = {}


def become_subreaper() -> None:
    """Make this process the child subreaper of its descendants
    (prctl(PR_SET_CHILD_SUBREAPER), on this process only): a process
    whose parent exits is re-parented here rather than to init, so
    `live_descendants` still sees it."""
    import ctypes
    import os

    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong, ctypes.c_ulong,
                           ctypes.c_ulong, ctypes.c_ulong]
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        fail(f"prctl(PR_SET_CHILD_SUBREAPER): "
             f"{os.strerror(ctypes.get_errno())}")


def _proc_field(pid: int, name: str) -> str:
    try:
        return Path(f"/proc/{pid}/{name}").read_bytes().decode(
            errors="replace")
    except OSError:
        return ""


def live_descendants(root: int | None = None) -> list[tuple[int, str]]:
    """(pid, command line) of every live descendant of `root` (this
    process), read from /proc/<pid>/task/*/children, recursively;
    zombies, which have ended and only wait to be reaped, are skipped."""
    import os

    out, todo = [], [root or os.getpid()]
    while todo:
        pid = todo.pop()
        kids = set()
        for f in Path(f"/proc/{pid}/task").glob("*/children"):
            with contextlib.suppress(OSError):
                kids.update(int(k) for k in f.read_text().split())
        for kid in sorted(kids):
            todo.append(kid)
            stat = _proc_field(kid, "stat")
            if not stat or stat.rsplit(")", 1)[-1].split()[0] == "Z":
                continue
            cmdline = _proc_field(kid, "cmdline").replace("\0", " ").strip()
            if not any(re.search(p, cmdline) for p in LONG_LIVED):
                out.append((kid, cmdline))
    return out


STRAGGLER_GRACE_S = 5.0   # for a process already on its way out


def check_no_stragglers(phase: str) -> None:
    """After a phase: no descendant of this script may be alive (one
    still exiting gets STRAGGLER_GRACE_S). Each straggler is named with
    its pid, command line and the phase, its process group is killed
    (the process alone when it shares this script's group), and the
    script fails."""
    import os
    import signal

    deadline = time.monotonic() + STRAGGLER_GRACE_S
    while (left := live_descendants()) and time.monotonic() < deadline:
        time.sleep(0.1)
    if not left:
        return
    for pid, cmdline in left:
        print(f"chip_smoke: straggler after phase {phase!r}: pid {pid}: "
              f"{cmdline[:300]}", file=sys.stderr, flush=True)
        with contextlib.suppress(ProcessLookupError):
            pgid = os.getpgid(pid)
            if pgid == os.getpgrp():
                os.kill(pid, signal.SIGKILL)
            else:
                os.killpg(pgid, signal.SIGKILL)
    fail(f"{len(left)} process(es) outlived phase {phase!r}")


def check_no_threads() -> None:
    """Before the last line: no non-daemon thread but the main one."""
    import threading

    left = [t.name for t in threading.enumerate()
            if t is not threading.main_thread() and not t.daemon
            and t.is_alive()]
    if left:
        fail(f"non-daemon threads still alive: {left}")


def _launch_counts(fwd: int, dq: int, dkv: int, family=None) -> dict:
    """Every flash kernel's launches when only `family`'s three kernels
    (the wgmma ones by default) run: fwd, dq and dk/dv of them."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    return {**dict.fromkeys(fa.LAUNCHES, 0),
            **dict(zip(family or fa.SM90, (fwd, dq, dkv)))}


LAUNCH_LINE = re.compile(r"flash kernel launches: (\{.*?\}); "
                         r"by instantiation: (\{.*?\})")
# each path's flash launches by instantiation, for the kernels line: the
# main path's (in process) and phase 32's f32 ranks' (from their logs)
INSTANCE_COUNTS: dict[str, dict] = {}


def _logged_launches(out: str) -> tuple:
    """The last flash launch counts a launcher logged: (by kernel, by
    instantiation), or (None, None)."""
    m = LAUNCH_LINE.findall(out)
    return tuple(json.loads(x) for x in m[-1]) if m else (None, None)


def check_rows(name: str, got, want, tol: float) -> dict:
    """kernel_check.errors of got against want; fails past tol per row."""
    from kubeflow_tpu_torch.ops import kernel_check

    e = kernel_check.errors(got, want)
    if not e["max_row_err"] <= tol:
        fail(f"{name}: max row err {e['max_row_err']:.4g} (limit {tol}), "
             f"max abs err {e['max_abs_err']:.4g}")
    return e


# the kernel phase: every (dtype, head_dim) of the kernels' domain
# (ops/flash_attention.py KERNEL_DOMAIN) at llama-1b's attention shapes:
# the main path's at head_dim 64, llama-1b-hd128's at 128, and at 256 the
# same width over 8 heads of 256 with 2 kv heads; (batch, length, q heads,
# kv heads)
KERNEL_SHAPES = {
    ("bfloat16", 64): (B, L, H, HKV), ("float16", 64): (B, L, H, HKV),
    ("float32", 64): (B, L, H, HKV),
    ("bfloat16", 128): (8, 2048, 16, 4), ("float16", 128): (8, 2048, 16, 4),
    ("float32", 128): (8, 2048, 16, 4),
    ("bfloat16", 256): (8, 2048, 8, 2), ("float16", 256): (8, 2048, 8, 2),
    ("float32", 256): (8, 2048, 8, 2),
}
# peak rate of each input type (NVIDIA's H100 SXM data sheet, dense):
# tensor cores for the 2-byte types; f32 at the CUDA cores' FMA rate, since
# TF32 would not compute the same function
PEAK_OPS = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": 67e12}
# TPU kernel each port kernel replaces, by role, and its source
REPLACES = {"fwd": f"{SRC}:140", "dq": f"{SRC}:305", "dkv": f"{SRC}:362"}
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd_dq": "flash_bwd.cu",
           "flash_bwd_dkv": "flash_bwd_dkv.cu",
           "flash_bwd_dkv_split": "flash_bwd_dkv_split.cu",
           **dict.fromkeys(("flash_simple_fwd", "flash_simple_bwd_dq",
                            "flash_simple_bwd_dkv"), "flash_simple.cu")}


def _kernel_rows(fa, ptxas: dict, dtype_name: str, d: int) -> list[dict]:
    """The three kernels that take (dtype, d) at KERNEL_SHAPES' shape:
    held against their plain versions (each at its kernel's tiles) under
    the causal mask, a window of 512 and packed segment ids, per row
    (kernel_check); timed with their plain versions and SDPA at that
    dtype (TF32 off); the bound at the dtype's peak. One row each."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import kernel_check

    dtype = getattr(torch, dtype_name)
    b, l, h, hkv = KERNEL_SHAPES[(dtype_name, d)]
    names = fa.kernels_for(dtype, d)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    q, dout = randn(b, l, h, d), randn(b, l, h, d)
    k, v = randn(b, l, hkv, d), randn(b, l, hkv, d)
    scale = d ** -0.5
    errs: dict[str, dict[str, dict]] = {}
    cuts = torch.rand(b, l, device="cuda", generator=gen) < 4.0 / l
    seg = torch.cumsum(cuts.int(), dim=1).to(torch.int32).contiguous()
    for tag, extra, window in (("causal", (), 0), ("window", (), 512),
                               ("segments", (seg, seg), 0)):
        got = kernel_check.flash_errors(q, k, v, dout, *extra, scale=scale,
                                        causal=True, window=window)
        bad = kernel_check.failures(got, dtype)
        if bad:
            fail(f"flash kernels {dtype_name}/{d} vs plain, {tag}: "
                 f"{'; '.join(bad)}")
        for name in names:
            errs.setdefault(name, {})[tag] = {
                key: max(got[o][key] for o in kernel_check.KERNEL_OUTPUTS[name])
                for key in ("max_abs_err", "max_row_err")}

    cfg = dict(scale=scale, causal=True, window=0)
    fwd, dq_name, dkv = names
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, **cfg,
                                      **fa.kernel_blocks(fwd, d))
    delta = fa.flash_delta(out_p, dout)
    timed = kernel_check.device_ms

    def reps(slow: bool) -> dict:             # the SIMT kernels, f32 SDPA
        return dict(n=5, reps=3) if slow else {}

    ms = {
        fwd: timed(lambda: fa.flash_fwd_cuda(q, k, v, **cfg),
                   **reps(fwd in fa.SIMPLE)),
        dq_name: timed(lambda: fa.flash_bwd_dq_cuda(
            q, k, v, dout, lse_p, delta, **cfg),
            **reps(dq_name in fa.SIMPLE)),
        dkv: timed(lambda: fa.flash_bwd_dkv_cuda(
            q, k, v, dout, lse_p, delta, **cfg), **reps(dkv in fa.SIMPLE)),
    }
    # the plain versions at each kernel's tiles; the plain backward
    # computes dq, dk and dv together
    plain_ms = {fwd: timed(lambda: fa.flash_fwd_plain(
        q, k, v, **cfg, **fa.kernel_blocks(fwd, d)), n=1, reps=3, warmup=1)}
    for name in (dq_name, dkv):
        plain_ms[name] = timed(lambda: fa.flash_bwd_plain(
            q, k, v, out_p, lse_p, dout, **cfg, **fa.kernel_blocks(name, d)),
            n=1, reps=3, warmup=1)

    # library yardstick: SDPA on [B, H, L, D] at this dtype, kv heads
    # expanded outside the timed region; its backward computes dq, dk and
    # dv together
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.repeat_interleave(h // hkv, 2).transpose(1, 2).detach().requires_grad_()
    vt = v.repeat_interleave(h // hkv, 2).transpose(1, 2).detach().requires_grad_()
    gt = dout.transpose(1, 2)
    slow = dtype == torch.float32
    sdpa_fwd = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), **reps(slow))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_bwd = timed(lambda: torch.autograd.grad(
        o, (qt, kt, vt), gt, retain_graph=True), **reps(slow))
    library_ms = {fwd: sdpa_fwd, dq_name: sdpa_bwd, dkv: sdpa_bwd}

    # bound: the larger of the operations over the dtype's peak and the
    # bytes (inputs read once, outputs written once) over HBM bandwidth;
    # causal pairs only
    size = q.element_size()
    pairs = b * h * l * (l + 1) / 2
    q_bytes, kv_bytes = size * b * l * h * d, size * b * l * hkv * d
    row_bytes = 4 * b * h * l
    work = {
        fwd: (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        dq_name: (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        dkv: (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }
    rows = []
    for role, name in zip(("fwd", "dq", "dkv"), names):
        flops, nbytes = work[name]
        t_ops = flops / PEAK_OPS[dtype_name] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        reg = ptxas[name][(dtype_name.replace("bfloat", "bf").replace(
            "float", "f"), d)]
        rows.append({
            "name": f"{name}[{dtype_name}/{d}]", "kernel": name,
            "dtype": dtype_name, "head_dim": d, "route": "cuda",
            "source": f"kubeflow_tpu_torch/ops/csrc/{SOURCES[name]}",
            "replaces": REPLACES[role], "launches": None,
            "shape": [b, l, h, d], "kv_heads": hkv,
            "tile": list(fa.KERNEL_TILES[name][d]),
            "registers": reg.get("registers"),
            "spill_bytes": reg.get("spill_bytes"),
            "max_abs_err": errs[name]["causal"]["max_abs_err"],
            "max_row_err": {t: e["max_row_err"] for t, e in errs[name].items()},
            "max_abs_err_window": errs[name]["window"]["max_abs_err"],
            "max_abs_err_segments": errs[name]["segments"]["max_abs_err"],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms[name],
        })
        print(f"kernel {name} {dtype_name}/{d} at {[b, l, h, d]} kv {hkv}, "
              f"tile {fa.KERNEL_TILES[name][d]}: {ms[name]:.3f} ms (bound "
              f"{bound:.3f} ms, {100 * bound / ms[name]:.1f}% of it; plain "
              f"{plain_ms[name]:.1f} ms, sdpa {library_ms[name]:.3f} ms), "
              f"{reg}, row errors "
              f"{ {t: round(e['max_row_err'], 5) for t, e in errs[name].items()} }",
              flush=True)
    bwd = ms[dq_name] + ms[dkv]
    print(f"backward {dtype_name}/{d}: dq + dk/dv {bwd:.3f} ms against sdpa's "
          f"whole backward {sdpa_bwd:.3f} ms ({bwd / sdpa_bwd:.2f}x)",
          flush=True)
    del q, k, v, dout, qt, kt, vt, o, out_p, lse_p, delta
    return rows


def kernel_phase(fa, ptxas: dict) -> list[dict]:
    """Every instantiation of the flash kernels (`_kernel_rows` for each
    (dtype, head_dim) of KERNEL_SHAPES); one row each."""
    import torch

    rows = []
    for dtype_name, d in KERNEL_SHAPES:
        rows += _kernel_rows(fa, ptxas, dtype_name, d)
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def head_check() -> None:
    """The LM head on the card (bf16 GEMM, f32 out) against its plain
    formula (f32 GEMM of the rounded operands), same card tensors, at one
    main-path chunk: x [8, 256, 2048] bf16, kernel [2048, 32000] f32."""
    import torch

    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.ops.xent import head_logits, head_logits_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(B, L // 8, 2048, device="cuda", generator=gen).to(
        torch.bfloat16)
    w = torch.randn(2048, 32000, device="cuda", generator=gen) * 0.02
    g = torch.randn(B, L // 8, 32000, device="cuda", generator=gen)
    res = {}
    for name, fn in (("card", head_logits), ("plain", head_logits_plain)):
        xi = x.detach().requires_grad_()
        wi = w.detach().requires_grad_()
        logits = fn(xi, wi, torch.bfloat16).reshape(g.shape)
        logits.backward(g)
        res[name] = (logits.detach(), xi.grad, wi.grad)
    out = {}
    for i, what in enumerate(("logits", "dx", "dkernel")):
        got, want = res["card"][i], res["plain"][i]
        if got.dtype != want.dtype:
            fail(f"LM head {what}: {got.dtype} on the card, {want.dtype} "
                 "in the plain formula")
        out[what] = check_rows(f"LM head {what}", got, want,
                               kernel_check.ROW_TOL)["max_row_err"]
    print(f"head check: bf16 head GEMM vs plain formula, max row err {out}",
          flush=True)


def reference_check() -> None:
    """llama-1b widths, 2 layers, 256 tokens: flash kernel vs reference
    attention through the whole model, same weights."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model

    tokens = torch.randint(0, 32000, (1, 256), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    logits = {}
    for impl in ("flash", "reference"):
        model = get_model("llama-1b", device="cuda", seed=0, n_layers=2,
                          attention_impl=impl)
        with torch.no_grad():
            logits[impl] = model(tokens)
        del model
    got, want = logits["flash"], logits["reference"]
    if got.shape != (1, 256, 32000) or got.dtype != torch.float32:
        fail(f"logits {tuple(got.shape)} {got.dtype}")
    e = check_rows("llama-1b 2-layer logits flash vs reference", got, want,
                   REF_ROW_TOL)
    print(f"reference check: 2-layer llama-1b logits, flash vs reference "
          f"attention, max row err {e['max_row_err']:.4g}, max abs err "
          f"{e['max_abs_err']:.4g}", flush=True)


# the D256 model check: llama-1b's width over 8 heads of 256 with 2 kv
# heads (KERNEL_SHAPES' D256 shape), cut to 2 layers
D256_MODEL = dict(n_layers=2, n_heads=8, n_kv_heads=2, head_dim=256)


def d256_model_check(fa) -> dict:
    """One forward and backward of `D256_MODEL` at [B, L], same weights and
    tokens, three times: in bf16 through the flash kernels, in bf16
    through reference attention, and in f32 through reference attention
    (TF32 off), the exact-dtype computation of the same function. Holds
    flash's logits to the bf16 reference's within REF_ROW_TOL per row and
    its loss within kernel_check's ROW_TOL; each gradient's rows to the
    f32 run's within the bf16 reference's own distance from it plus
    ROW_TOL (two bf16 attention paths differ by 1-3% per gradient row,
    each as far from f32: the limit is the error the kernels add). The
    flash run must launch each of its three D256 kernels once per layer
    (the wgmma forward and dq, the split dk/dv) and nothing else.
    Returns its launches by kernel; by instantiation they go to
    INSTANCE_COUNTS["d256_model"]."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import kernel_check

    layers = D256_MODEL["n_layers"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    tok = torch.randint(0, 32000, (B, L + 1), device="cuda", generator=gen)
    res = {}
    for tag, impl, dtype in (("flash", "flash", torch.bfloat16),
                             ("reference", "reference", torch.bfloat16),
                             ("f32", "reference", torch.float32)):
        model = get_model("llama-1b", device="cuda", seed=0,
                          attention_impl=impl, dtype=dtype, **D256_MODEL)
        fa.reset_launches()
        logits = model(tok[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tok[:, 1:].reshape(-1))
        loss.backward()
        torch.cuda.synchronize()
        res[tag] = (logits.detach(), loss.detach().reshape(1, 1),
                    {n: p.grad for n, p in model.named_parameters()},
                    dict(fa.LAUNCHES), dict(fa.INSTANCE_LAUNCHES))
        del model, logits, loss
    logits, loss, grads, launches, inst = res["flash"]
    want_inst = {fa.instance_name(n, "bfloat16", 256): layers
                 for n in fa.SM90_D256}
    if launches != {**dict.fromkeys(fa.LAUNCHES, 0),
                    **dict.fromkeys(fa.SM90_D256, layers)} \
            or inst != want_inst:
        fail(f"d256 model: flash launches {launches}, by instantiation "
             f"{inst}, want {want_inst}")
    for tag in ("reference", "f32"):
        if any(res[tag][3].values()):
            fail(f"d256 model: reference attention ({tag}) launched "
                 f"{res[tag][3]}")
    if logits.shape != (B, L, 32000) or logits.dtype != torch.float32:
        fail(f"d256 model: logits {tuple(logits.shape)} {logits.dtype}")
    INSTANCE_COUNTS["d256_model"] = inst
    e = check_rows("d256 model logits flash vs reference", logits,
                   res["reference"][0], REF_ROW_TOL)
    e_loss = check_rows("d256 model loss flash vs reference", loss,
                        res["reference"][1], kernel_check.ROW_TOL)
    worst = (-math.inf, "", 0.0, 0.0)
    for name, g in grads.items():
        row = g.shape[-1]
        exact = res["f32"][2][name].reshape(-1, row)
        floor = kernel_check.errors(res["reference"][2][name].reshape(-1, row),
                                    exact)["max_row_err"]
        got = check_rows(f"d256 model gradient {name}: flash vs f32 (the "
                         f"bf16 reference's own row err {floor:.4g})",
                         g.reshape(-1, row), exact,
                         floor + kernel_check.ROW_TOL)["max_row_err"]
        worst = max(worst, (got - floor, name, got, floor))
    print(f"d256 model check: llama-1b width, 8 heads of 256 (2 kv), "
          f"{layers} layers, bf16 [{B}, {L}]: flash vs reference logits max "
          f"row err {e['max_row_err']:.4g}, loss {loss.item():.6f} "
          f"(rel err {e_loss['max_row_err']:.3g}); {len(grads)} gradients "
          f"against f32, largest excess over the bf16 reference's row err "
          f"{worst[0]:.4g} ({worst[1]}: {worst[2]:.4g} against "
          f"{worst[3]:.4g}, limit +{kernel_check.ROW_TOL}); launches {inst}",
          flush=True)
    del res, logits, grads
    return launches


def remat_check(fa) -> None:
    """2 layers at llama-1b width, bf16, one batch [B, L], 8 xent chunks:
    the loss and every gradient under each remat policy against no
    remat, and the flash launches each policy makes."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.ops.xent import chunked_lm_xent

    layers = 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    tok = torch.randint(0, 32000, (B, L + 1), device="cuda", generator=gen)
    want = None
    for policy in (None, *REMAT_POLICIES):
        kw = {} if policy is None else {"remat": True, "remat_policy": policy}
        model = get_model("llama-1b", device="cuda", seed=0, n_layers=layers,
                          **kw)
        fa.reset_launches()
        hidden = model(tok[:, :-1], return_hidden=True)
        loss, _ = chunked_lm_xent(hidden, model.lm_head.kernel, tok[:, 1:], 8,
                                  compute_dtype=model.cfg.dtype)
        del hidden
        loss.backward()
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        got = {"loss": loss.detach().reshape(1, 1),
               **{n: p.grad for n, p in model.named_parameters()}}
        del model, loss
        if not torch.isfinite(got["loss"]).all():
            fail(f"remat {policy}: loss {got['loss'].item()}")
        fwd = (2 if policy == "full" else 1) * layers
        if launches != _launch_counts(fwd, layers, layers):
            fail(f"remat {policy}: launches {launches}, want {fwd} forward "
                 f"and {layers} of each backward kernel")
        if want is None:
            want = got
            continue
        worst_row = worst_abs = 0.0
        for name, g in got.items():
            row = g.shape[-1]
            e = check_rows(f"remat {policy}: {name}", g.reshape(-1, row),
                           want[name].reshape(-1, row), kernel_check.ROW_TOL)
            worst_row = max(worst_row, e["max_row_err"])
            worst_abs = max(worst_abs, e["max_abs_err"])
        print(f"remat check {policy}: loss and {len(got) - 1} gradients vs no "
              f"remat, max row err {worst_row:.3g}, max abs diff "
              f"{worst_abs:.3g}; launches {launches}", flush=True)
        del got
    del want
    gc.collect()
    torch.cuda.empty_cache()


def launch_in_process(fa, _build, cfg: dict, tag: str
                      ) -> tuple[dict, dict, float]:
    """Train `cfg` through the port launcher in this process, the flash
    launch counts set to 0 just before; fails on a non-zero exit or a
    loss that is not finite. Returns (summary, launches, wall s)."""
    from kubeflow_tpu_torch.runtime import launcher

    path = _build.build_dir() / f"chip_smoke_{tag}.json"
    path.write_text(json.dumps(cfg))
    buf = io.StringIO()
    fa.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launcher.main(["--config", str(path)])
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    INSTANCE_COUNTS[tag] = dict(fa.INSTANCE_LAUNCHES)
    print(buf.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"{tag}: launcher exit {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])["summary"]
    loss = summary["final"].get("loss")
    if loss is None or not math.isfinite(loss):
        fail(f"{tag}: loss {loss}")
    return summary, launches, wall


def main_path(fa, _build, cfg: dict, tag: str) -> tuple[dict, float]:
    """Train `cfg` through the port launcher; every kernel must launch
    once per layer per step and the loss be finite. Returns the launches
    and the mean metered step time (s)."""
    summary, launches, wall = launch_in_process(fa, _build, cfg, tag)
    loss = summary["final"]["loss"]
    want = _launch_counts(*[LAYERS * STEPS] * 3)
    if launches != want:
        fail(f"launches {launches} in {STEPS} steps, want {want}: the main "
             f"path did not run every wgmma kernel, or ran another")
    by_inst = {fa.instance_name(k, "bfloat16", D): LAYERS * STEPS
               for k in fa.SM90}
    if INSTANCE_COUNTS[tag] != by_inst:
        fail(f"main path {tag}: launches by instantiation "
             f"{INSTANCE_COUNTS[tag]}, want {by_inst}")
    tokens_s = summary["examples_per_sec"] * L
    mfu = summary["mfu"]
    print(f"main path {tag} ({cfg['optimizer']}, remat "
          f"{cfg.get('remat') and cfg['remat_policy']}): llama-1b seq {L} "
          f"batch {B}, {STEPS} steps in {wall:.1f}s; step "
          f"{summary['step_time_s'] * 1e3:.1f} ms, {tokens_s:.0f} tokens/s, "
          f"mfu {'n/a' if mfu is None else f'{mfu:.4f}'}, final loss "
          f"{loss:.4f}, launches {launches}", flush=True)
    return launches, summary["step_time_s"]


def grad_accum_check(fa) -> None:
    """The pinned config at ACCUM_LAYERS layers, grad_accum_steps 2:
    each kernel launches once per layer per microbatch."""
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    cfg = TrainConfig.from_dict({
        **MAIN_PATH, "grad_accum_steps": 2, "total_steps": ACCUM_STEPS,
        "model_kwargs": {**MAIN_PATH["model_kwargs"],
                         "n_layers": ACCUM_LAYERS}})
    trainer = Trainer(cfg, device="cuda")
    fa.reset_launches()
    summary = trainer.fit()
    launches = dict(fa.LAUNCHES)
    loss = summary["final"].get("loss")
    if loss is None or not math.isfinite(loss):
        fail(f"grad accumulation: loss {loss}")
    want = _launch_counts(*[2 * ACCUM_LAYERS * ACCUM_STEPS] * 3)
    if launches != want:
        fail(f"grad accumulation: launches {launches}, want {want}")
    print(f"grad accumulation: {ACCUM_LAYERS} layers, 2 microbatches of "
          f"{B // 2}, {ACCUM_STEPS} steps, final loss {loss:.4f}, launches "
          f"{launches}", flush=True)


KINDS = (  # profile phase: kernel name -> kind, first match wins
    ("flash attention", ("flash_",)),
    ("batchnorm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("convolution", ("implicit_gemm", "fprop", "dgrad", "wgrad", "convolve",
                     "conv2d")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_")),
    ("optimizer", ("multi_tensor", "adam", "foreach")),
    ("softmax/xent", ("softmax", "logsumexp", "nll", "cross_entropy")),
    ("reduction", ("reduce",)),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "cat",
                          "fill", "index", "embedding", "memcpy", "memset")),
)


def _kernel_ms(prof, steps: int) -> dict[str, float]:
    """Device time per step of each kernel a torch.profiler run saw."""
    import torch

    kernels: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        # kernels only: a user annotation's device range spans kernels
        # that are counted already
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / steps
    return kernels


def _range_ms(prof, steps: int, prefix: str) -> dict[str, float]:
    """Device time per step inside each `record_function` range whose
    name starts with `prefix` (the MoE forward's moe.router,
    moe.dispatch, moe.experts and moe.combine): the range's device-side
    annotation, which spans the kernels launched inside it. The
    backward's kernels run outside these ranges."""
    import torch

    out: dict[str, float] = {}
    for evt in prof.key_averages():
        if (evt.key.startswith(prefix)
                and evt.device_type == torch.autograd.DeviceType.CUDA):
            us = getattr(evt, "device_time_total", 0.0)
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3 / steps
    return out


def profile_phase(cfg: dict, tag: str, steps: int = 3) -> None:
    """Device time of a step of `cfg` by kind of kernel, under
    torch.profiler, the device's busy share of the step (the rest is the
    device idle, waiting on the host) and the peak device memory of the
    warm-up and profiled steps; then the optimizer update alone: `steps`
    updates from one step's gradients, profiled by themselves (device
    time of their kernels, and the host clock around each update)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(TrainConfig.from_dict(cfg), device="cuda")
    batch = next(trainer._device_iter(trainer.data_iter()))
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _kernel_ms(prof, steps)
    device_ms = sum(kernels.values())
    if device_ms == 0:
        fail("the profiler saw no device time")
    ranges = _range_ms(prof, steps, "moe.")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=activities) as prof_opt:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.opt.step()
            torch.cuda.synchronize()
        opt_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    optimizer_ms = sum(_kernel_ms(prof_opt, steps).values())
    by_kind: dict[str, float] = {}
    for name, ms in kernels.items():
        kind = next((k for k, keys in KINDS
                     if any(key in name.lower() for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    print(f"profile {tag} ({cfg['optimizer']}, remat "
          f"{cfg.get('remat') and cfg['remat_policy']}): one step, top "
          "kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:9.3f} ms  {name[:110]}")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  [{kind}] {100 * ms / device_ms:.1f}%")
    print(f"  optimizer update alone: {optimizer_ms:.3f} ms of kernels, "
          f"{opt_wall_ms:.3f} ms on the host clock")
    for name, ms in sorted(ranges.items()):
        print(f"  {ms:9.3f} ms  [{name}, forward range]")
    print(f"profile {tag}: " + json.dumps({
        "step_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms, "by_kind_ms": by_kind,
        "optimizer_ms": optimizer_ms, "optimizer_wall_ms": opt_wall_ms,
        "peak_mem_gb": peak_gb, **({"ranges_ms": ranges} if ranges else {})}),
        flush=True)
    del trainer, batch, prof, prof_opt
    gc.collect()
    torch.cuda.empty_cache()


def _left_padded(prompts: list[list[int]], p: int):
    import torch

    rows = [[0] * (p - len(r)) + r for r in prompts]
    pads = [p - len(r) for r in prompts]
    return (torch.tensor(rows, device="cuda"),
            torch.tensor(pads, device="cuda"))


def _decode_all(dec, prompts: list[list[int]]) -> list[list[int]]:
    """Every prompt through a SlotDecoder at once, one thread each."""
    import threading

    outs: list = [None] * len(prompts)

    def go(i: int) -> None:
        try:
            outs[i] = dec.submit(prompts[i])
        except Exception as e:  # noqa: BLE001 - reported below
            outs[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    bad = [o for o in outs if not isinstance(o, list)]
    if bad:
        fail(f"slot decoder: {bad[0]!r}")
    return outs


def serving_check() -> None:
    """Phase 9: decode and the slot decoder against generate() and the
    prefill oracle, in f32 at gpt-350m width and CHECK_LAYERS layers;
    the quantized runs against the f32 run; then the same at bf16."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.runtime.generate import (
        generate, init_cache, prefill_per_token, prefill_scan)
    from kubeflow_tpu_torch.serving.continuous import SlotDecoder
    from kubeflow_tpu_torch.serving.quant import QuantizedModel, quantize_params

    p, n = CHECK_P, CHECK_N
    rng = random.Random(1)
    ragged = [[rng.randrange(1, SERVE["vocab"]) for _ in range(k)]
              for k in (5, p // 4 + 1, p // 2 + 1, p, 3 * p // 4, 1)]
    shared = [rng.randrange(1, SERVE["vocab"]) for _ in range(p)]
    prompts = ragged + [shared, shared]      # full hit, then copy-on-write

    def model(dtype="float32", **kw):
        m = get_model(SERVE["model"], device="cuda", seed=0,
                      n_layers=CHECK_LAYERS, vocab_size=SERVE["vocab"],
                      max_seq_len=p + n, dtype=dtype, **kw)
        m.load_state_dict(weights)
        return m

    weights = get_model(SERVE["model"], device="cuda", seed=0,
                        n_layers=CHECK_LAYERS, vocab_size=SERVE["vocab"],
                        max_seq_len=p + n, dtype="float32").state_dict()
    toks, pads = _left_padded(prompts, p)

    def tokens(m, params=None):
        with torch.no_grad():
            return generate(m, params, toks, max_new_tokens=n,
                            pad_len=pads)[:, p:].tolist()

    def agree(a, b) -> float:
        pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
        return sum(x == y for x, y in pairs) / len(pairs)

    base = model()
    want = tokens(base)
    dec = SlotDecoder(base, None, slots=4, prompt_len=p, max_new_tokens=n)
    try:
        got = _decode_all(dec, prompts)
    finally:
        dec.close()
    if got != want:
        fail(f"dense slot decoder vs generate: {agree(got, want):.3f} of "
             "tokens equal, want all (f32)")
    pages = 4 * -(-(p + n) // CHECK_PAGE) + 2 * p // CHECK_PAGE + 1
    paged = model(kv_pages=pages, kv_page_size=CHECK_PAGE)
    dec = SlotDecoder(paged, None, slots=4, prompt_len=p, max_new_tokens=n)
    try:
        got = _decode_all(dec, ragged)
        got += [dec.submit(shared), dec.submit(shared)]
        st = dec.stats()
        dec.alloc.check()
        free = dec.alloc.available()
    finally:
        dec.close()
    if got != want:
        fail(f"paged slot decoder vs generate: {agree(got, want):.3f} of "
             "tokens equal, want all (f32)")
    if st["prefix_hit_pages"] < p // CHECK_PAGE or st["cow_clones"] < 1:
        fail(f"paged: prefix reuse or copy-on-write did not run: {st}")
    if free != pages - 1:
        fail(f"paged: {free} of {pages - 1} pages free for admission at "
             "the end")
    with torch.no_grad():
        logits = {}
        for dtype in ("float32", "bfloat16"):
            m = base if dtype == "float32" else model(dtype)
            for name, fn in (("chunked", prefill_scan),
                             ("per_token", prefill_per_token)):
                _, logits[dtype, name] = fn(m, None, init_cache(m, len(prompts)),
                                            toks, pads)
    e32 = check_rows("f32 chunked prefill vs per-token", logits["float32", "chunked"],
                     logits["float32", "per_token"], PREFILL_ROW_TOL)
    e16 = check_rows("bf16 chunked prefill vs per-token",
                     logits["bfloat16", "chunked"],
                     logits["bfloat16", "per_token"], REF_ROW_TOL)
    mixed = kernel_check.errors(logits["bfloat16", "chunked"],
                                logits["float32", "chunked"])
    kv8 = agree(tokens(model(kv_cache_dtype="int8")), want)
    if kv8 < QUANT_AGREE:
        fail(f"the int8-cache run agrees with f32 on {kv8:.3f} of tokens, "
             f"want >= {QUANT_AGREE}")
    qm = QuantizedModel(base)
    qp = quantize_params(base.state_dict(), base.cfg.head_dim)
    w8 = agree(tokens(qm, qp), want)
    with torch.no_grad():
        full = base.apply(None, toks, decode_index=0, pad_len=pads,
                          cache=init_cache(base, len(prompts)))
        quant = qm.apply(qp, toks, decode_index=0, pad_len=pads,
                         cache=init_cache(base, len(prompts)))
    corr = torch.corrcoef(torch.stack([full.flatten(), quant.flatten()]))[
        0, 1].item()
    del full, quant
    if not corr > QUANT_CORR:
        fail(f"int8-weight logits correlate with f32 at {corr:.5f}, want > "
             f"{QUANT_CORR}")
    bf = model("bfloat16")
    want16 = tokens(bf)
    dec = SlotDecoder(bf, None, slots=4, prompt_len=p, max_new_tokens=n)
    try:
        got16 = _decode_all(dec, prompts)
    finally:
        dec.close()
    print(f"serving check ({SERVE['model']} width, {CHECK_LAYERS} layers, "
          f"{len(prompts)} prompts, P {p}, N {n}): f32 slot decoder dense "
          f"and paged == generate; paged {st['prefix_hit_pages']} prefix "
          f"pages hit, {st['cow_clones']} copy-on-write; prefill chunked vs "
          f"per-token row err f32 {e32['max_row_err']:.3g}, bf16 "
          f"{e16['max_row_err']:.3g}; generated tokens equal to f32's: "
          f"int8 cache {kv8:.3f}, int8 weights {w8:.3f} (not held; their "
          f"prompt logits correlate at {corr:.5f}); bf16 vs f32 logits row err "
          f"{mixed['max_row_err']:.3g}, bf16 tokens equal to f32's "
          f"{agree(want16, want):.3f}, bf16 slot decoder equal to bf16 "
          f"generate {agree(got16, want16):.3f}", flush=True)
    del base, paged, bf, weights
    gc.collect()
    torch.cuda.empty_cache()


SERVE_OPS = (  # tick profile: CPU op -> kind (device time of its kernels)
    ("projection GEMMs and LM head", ("aten::mm", "aten::addmm")),
    ("attention bmm (scores, probs x values)", ("aten::bmm",)),
    ("sampling", ("aten::argmax", "aten::multinomial", "aten::sort")),
)


def tick_profile(dec, ticks: int = 8, timed: int = 16) -> dict:
    """Every slot of `dec` busy (prefilled at the serving prompt
    length), then `timed` ticks back to back on the host clock and
    `ticks` more under torch.profiler: device time per tick by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serve_bench import bench_prompts
    from kubeflow_tpu_torch.serving.quant import (
        QuantizedModel, dequantize_params)

    s, p = dec.S, dec.P
    prompts = bench_prompts(s, p, SERVE["vocab"])
    toks, pads = _left_padded(prompts, p)
    with torch.no_grad():
        st = dec._fresh_state()
        cache_k, logits_k = dec._prefill(dec._params, toks, pads)
        slots = torch.arange(s, device="cuda")
        st = dec._install(st, cache_k, logits_k, slots, pads,
                          torch.full((s,), dec.N, device="cuda"))
        del cache_k
        for _ in range(2):
            st = dec._tick(dec._params, st)

        def host_ms(params, n):
            nonlocal st
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                st = dec._tick(params, st)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        tick_ms = host_ms(dec._params, timed)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ticks):
                st = dec._tick(dec._params, st)
            torch.cuda.synchronize()
        # the same ticks with the weights dequantized once, up front:
        # what the per-tick dequantization costs
        plain_ms = None
        if isinstance(dec.model, QuantizedModel):
            quantized, dec.model = dec.model, dec.model._model
            try:
                plain_ms = host_ms(dequantize_params(dec._params), timed)
            finally:
                dec.model = quantized
    kernels = _kernel_ms(prof, ticks)
    device_ms = sum(kernels.values())
    if device_ms == 0:
        fail("the profiler saw no device time in the decode ticks")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:9.3f} ms/tick  {name[:110]}")
    by_kind = {}
    for evt in prof.key_averages():
        for kind, names in SERVE_OPS:
            if evt.key in names:
                by_kind[kind] = by_kind.get(kind, 0.0) + getattr(
                    evt, "device_time_total", 0.0) / 1e3 / ticks
    by_kind["elementwise, casts, dequantization, gathers, softmax"] = (
        device_ms - sum(by_kind.values()))
    active = int((st.remaining > 0).sum())
    if active != s:
        fail(f"tick profile: {active} of {s} slots active")
    return {"host_ms_per_tick": tick_ms, "device_ms_per_tick": device_ms,
            "device_busy_share": device_ms / tick_ms, "by_kind_ms": by_kind,
            "host_ms_per_tick_weights_dequantized_once": plain_ms,
            "launches_per_tick": sum(
                evt.count for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and getattr(evt, "self_device_time_total", 0) > 0) / ticks}


def serving_pinned(card: str, tag: str = "pinned serving",
                   requests: int = SERVE["requests"], warm: bool = True,
                   profile: bool = True, cache_bytes: int | None = None,
                   **extra) -> tuple[dict, list]:
    """The pinned serving point behind the ModelServer, over HTTP on
    127.0.0.1 (`extra`: more serve_lm_generator options, e.g. the
    rolling cache or a draft model): a warm-up (one predict of each
    power of two up to the concurrency, or of two instances when `warm`
    is false), then `requests` single-instance predicts at concurrency
    16. Holds every response and, when given, the decode cache's bytes;
    returns the result line and the outputs in prompt order."""
    import urllib.request

    import torch

    from kubeflow_tpu_torch.serve_bench import (
        bench_prompts, closed_loop, spec_stats, warm_up)
    from kubeflow_tpu_torch.serving.server import (
        ModelServer, serve_lm_generator)

    sv = SERVE
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = serve_lm_generator(
        "chat", sv["model"], prompt_len=sv["prompt_len"],
        max_new_tokens=sv["max_new"], continuous_batching=True,
        decode_slots=sv["slots"], param_dtype=sv["param_dtype"],
        vocab_size=sv["vocab"], seed=0, device="cuda", **extra)
    server = ModelServer()
    server.register(served)
    svc = server.serve(host="127.0.0.1", port=0).serve_background()
    url = f"http://127.0.0.1:{svc.port}/v1/models/chat:predict"

    def post(instances: list) -> list:
        req = urllib.request.Request(
            url, data=json.dumps({"instances": instances}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=900) as resp:
            return json.loads(resp.read())["predictions"]

    try:
        prompts = bench_prompts(requests, sv["prompt_len"], sv["vocab"])
        if warm:
            warm_up(post, prompts, sv["concurrency"])
        else:
            post([{"tokens": p} for p in prompts[:2]])
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        latencies, outs, wall = closed_loop(
            lambda pr: post([{"tokens": pr}])[0], prompts, sv["concurrency"])
        for out in outs:
            if len(out) != sv["max_new"] or not all(
                    isinstance(t, int) and 0 <= t < sv["vocab"] for t in out):
                fail(f"{tag}: bad response {out}")
        dec = served.decoder()
        stats = dec.stats()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if cache_bytes is not None and stats["cache_bytes"] != cache_bytes:
            fail(f"{tag}: decode cache holds {stats['cache_bytes']} bytes, "
                 f"want {cache_bytes}")

        def pct(q: float) -> float:
            return latencies[min(len(latencies) - 1, int(q * len(latencies)))]

        result = {
            "mode": "continuous", "model": sv["model"],
            "param_dtype": sv["param_dtype"], "slots": sv["slots"],
            "concurrency": sv["concurrency"], "requests": requests,
            "prompt_len": sv["prompt_len"], "max_new_tokens": sv["max_new"],
            **extra,
            "tokens_per_sec": requests * sv["max_new"] / wall,
            "requests_per_sec": requests / wall,
            "p50_ms": pct(0.50) * 1e3, "p95_ms": pct(0.95) * 1e3,
            "p99_ms": pct(0.99) * 1e3, "wall_s": wall,
            "setup_and_warmup_s": setup_s, "peak_mem_gb": peak,
            "cache_bytes": stats["cache_bytes"],
            "completed": stats["completed"], "card": card,
            **(spec_stats(stats) if stats["speculative"] else {}),
        }
        print(f"{tag}: " + json.dumps(result), flush=True)
        if profile:
            prof = tick_profile(dec)
            print(f"{tag} ticks ({sv['slots']} slots busy): host "
                  f"{prof['host_ms_per_tick']:.2f} ms/tick, device "
                  f"{prof['device_ms_per_tick']:.2f} ms/tick (busy "
                  f"{100 * prof['device_busy_share']:.0f}%), "
                  f"{prof['launches_per_tick']:.0f} kernel launches/tick; "
                  "host "
                  f"{prof['host_ms_per_tick_weights_dequantized_once']:.2f} "
                  "ms/tick with the weights dequantized once")
            for kind, ms in sorted(prof["by_kind_ms"].items(),
                                   key=lambda kv: -kv[1]):
                print(f"  {ms:9.3f} ms  [{kind}]")
            print(f"{tag} ticks: " + json.dumps(prof), flush=True)
    finally:
        svc.shutdown()
        server.close()
    del served
    gc.collect()
    torch.cuda.empty_cache()
    return result, outs


def entry_phase(fa) -> tuple[dict, dict]:
    """The entry() twin on the card: logits [2, 256, 8192], finite, with
    one flash forward launch per layer; the flash forward held against
    its plain version at this path's shape ([2, 256, 12, 64], 12 kv
    heads) and timed there; then the same config with random weights
    (seed 0), flash against reference attention, per row. Returns the
    entry call's launch counts."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch import entry as E
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import kernel_check

    t0 = time.perf_counter()
    fn, (params, tokens) = E.entry()
    fa.reset_launches()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    layers = E.CONFIG["n_layers"]
    if tuple(logits.shape) != (2, 256, 8192) or not torch.isfinite(
            logits).all():
        fail(f"entry: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    if launches != _launch_counts(layers, 0, 0):
        fail(f"entry: launches {launches}, want {layers} flash_fwd")
    del fn, params, logits
    # the kernel at this path's shape against its plain version
    b, l, h = 2, 256, 12
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)

    q, k, v, dout = randn(b, l, h, D), randn(b, l, h, D), randn(b, l, h, D), \
        randn(b, l, h, D)
    cfg = dict(scale=D ** -0.5, causal=True, window=0)
    errs = kernel_check.flash_errors(q, k, v, dout, **cfg)
    bad = kernel_check.failures(errs, torch.bfloat16)
    if bad:
        fail(f"entry shape: flash kernels vs plain: {'; '.join(bad)}")
    timed = kernel_check.device_ms
    pairs = b * h * l * (l + 1) / 2
    t_ops = 4 * D * pairs / PEAK_BF16 * 1e3
    t_bytes = (2 * 4 * b * l * h * D + 4 * b * h * l) / PEAK_BYTES * 1e3
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    at_shape = {
        "shape": [b, l, h, D], "kv_heads": h,
        "max_row_err": max(errs[o]["max_row_err"]
                           for o in kernel_check.KERNEL_OUTPUTS["flash_fwd"]),
        "ms": timed(lambda: fa.flash_fwd_cuda(q, k, v, **cfg)),
        "plain_ms": timed(lambda: fa.flash_fwd_plain(
            q, k, v, **cfg, **fa.kernel_blocks("flash_fwd", D)),
            n=3, reps=3, warmup=1),
        "library_ms": timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    # random weights: flash against reference attention through the model
    toks = torch.randint(0, 8192, (2, 256), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5))
    out = {}
    for impl in ("auto", "reference"):
        m = get_model("gpt-125m", device="cuda", seed=0, attention_impl=impl,
                      **E.CONFIG)
        with torch.no_grad():
            out[impl] = m(toks)
        del m
    e = check_rows("entry config, random weights, flash vs reference",
                   out["auto"], out["reference"], REF_ROW_TOL)
    print(f"entry: logits [2, 256, 8192] finite, launches {launches}; flash "
          f"fwd at [2, 256, 12, 64] vs plain row err "
          f"{at_shape['max_row_err']:.3g}, {at_shape['ms']:.4f} ms (plain "
          f"{at_shape['plain_ms']:.3f}, sdpa {at_shape['library_ms']:.4f}, "
          f"bound {at_shape['bound_ms']:.4f} ms by {at_shape['bound_by']}); "
          f"random weights flash vs reference row err {e['max_row_err']:.3g}"
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches, at_shape


def _check_model(name: str = SERVE["model"], layers: int = CHECK_LAYERS,
                 seed: int = 0, **kw):
    from kubeflow_tpu_torch.models.registry import get_model

    return get_model(name, device="cuda", seed=seed, n_layers=layers,
                     vocab_size=SERVE["vocab"], dtype="float32", **kw)


def rolling_check() -> None:
    """gpt-350m width, CHECK_LAYERS layers, f32: with window ROLL_W and
    prompts of ROLL_P tokens decoding ROLL_N more (the cache wraps
    twice), the rolling cache's greedy tokens equal the full cache's
    under the same window, for generate() and the slot decoder, with
    the dense and the int8 cache; the rolling cache is W-sized."""
    import torch

    from kubeflow_tpu_torch.runtime.generate import generate, init_cache
    from kubeflow_tpu_torch.serving.continuous import SlotDecoder

    t0 = time.perf_counter()
    rng = random.Random(2)
    prompts = [[rng.randrange(1, SERVE["vocab"]) for _ in range(k)]
               for k in (ROLL_P, ROLL_P - 5, 3, ROLL_P - 1)]
    toks, pads = _left_padded(prompts, ROLL_P)
    seq = ROLL_P + ROLL_N
    report = []
    for kv in ("auto", "int8"):
        kw = dict(max_seq_len=seq, attention_window=ROLL_W,
                  kv_cache_dtype=kv)
        full = _check_model(**kw)
        roll = _check_model(rolling_kv_cache=True, **kw)
        shapes = {tuple(t.shape[:2]) for t in init_cache(roll, 2).values()}
        if shapes != {(2, ROLL_W)}:
            fail(f"rolling {kv}: cache shapes {shapes}, want [2, {ROLL_W}]")
        with torch.no_grad():
            want = generate(full, None, toks, max_new_tokens=ROLL_N,
                            pad_len=pads)[:, ROLL_P:].tolist()
            got = generate(roll, None, toks, max_new_tokens=ROLL_N,
                           pad_len=pads)[:, ROLL_P:].tolist()
        if got != want:
            fail(f"rolling {kv}: generate tokens differ from the full "
                 "cache's under the same window (f32)")
        dec = SlotDecoder(roll, None, slots=2, prompt_len=ROLL_P,
                          max_new_tokens=ROLL_N)
        try:
            slot = _decode_all(dec, prompts)
            cache_bytes = dec.stats()["cache_bytes"]
        finally:
            dec.close()
        if slot != want:
            fail(f"rolling {kv}: slot decoder tokens differ from the full "
                 "cache's generate (f32)")
        report.append(f"{kv}: {cache_bytes} cache bytes")
        del full, roll
    print(f"rolling check ({SERVE['model']} width, {CHECK_LAYERS} layers, "
          f"f32, W {ROLL_W}, {len(prompts)} prompts of up to {ROLL_P} + "
          f"{ROLL_N} new): rolling == full cache for generate() and the "
          f"slot decoder, dense and int8 ({'; '.join(report)}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def speculative_check() -> None:
    """CHECK_LAYERS layers, f32: speculative_generate and the lockstep
    slot decoder, dense and paged target, equal the target's greedy
    generate(), with the target's own weights as the draft (every
    proposal accepted: accepted == drafted) and with an independent
    draft (SPEC_DRAFT width, 2 layers, seed 1)."""
    import torch

    from kubeflow_tpu_torch.runtime.generate import generate
    from kubeflow_tpu_torch.runtime.speculative import speculative_generate
    from kubeflow_tpu_torch.serving.continuous import SlotDecoder

    t0 = time.perf_counter()
    p, n, k = CHECK_P, CHECK_N, SPEC_K
    seq = p + n + k
    rng = random.Random(3)
    prompts = [[rng.randrange(1, SERVE["vocab"]) for _ in range(m)]
               for m in (p, p // 2, 7, p - 3)]
    toks, pads = _left_padded(prompts, p)
    target = _check_model(max_seq_len=seq)
    pages = 4 * -(-seq // CHECK_PAGE) + 1
    paged = _check_model(max_seq_len=seq, kv_pages=pages,
                         kv_page_size=CHECK_PAGE)
    with torch.no_grad():
        want = generate(target, None, toks, max_new_tokens=n,
                        pad_len=pads)[:, p:].tolist()
    drafts = {"self": target,
              "independent": _check_model(SPEC_DRAFT, layers=2, seed=1,
                                          max_seq_len=seq)}
    report = []
    for dname, draft in drafts.items():
        totals = {"rounds": 0, "drafted": 0, "accepted": 0}
        for r in range(len(prompts)):
            got, st = speculative_generate(
                target, None, draft, None, toks[r:r + 1], max_new_tokens=n,
                k=k, pad_len=pads[r:r + 1])
            if got[0, p:].tolist() != want[r]:
                fail(f"speculative_generate ({dname} draft) differs from "
                     f"greedy generate on prompt {r} (f32)")
            for key in totals:
                totals[key] += st[key]
        if dname == "self" and totals["accepted"] != totals["drafted"]:
            fail(f"self-draft: accepted {totals['accepted']} of "
                 f"{totals['drafted']} drafted, want all")
        lock = {}
        for tname, tm in (("dense", target), ("paged", paged)):
            dec = SlotDecoder(tm, None, slots=2, prompt_len=p,
                              max_new_tokens=n, draft_model=draft, draft_k=k)
            try:
                got = _decode_all(dec, prompts)
                st = dec.stats()
                if tname == "paged":
                    dec.alloc.check()
            finally:
                dec.close()
            if got != want:
                fail(f"lockstep slot decoder ({dname} draft, {tname} "
                     "target) differs from greedy generate (f32)")
            lock[tname] = (f"{st['spec_tokens_accepted']}/"
                           f"{st['spec_drafted']}")
        report.append(f"{dname} draft: batch-1 {totals['accepted']}/"
                      f"{totals['drafted']} accepted in {totals['rounds']} "
                      f"rounds, lockstep dense {lock['dense']}, paged "
                      f"{lock['paged']}")
    print(f"speculative check ({SERVE['model']} width, {CHECK_LAYERS} layers, "
          f"f32, k {k}, {len(prompts)} prompts, P {p}, N {n}): batch-1 and "
          f"lockstep dense/paged == greedy generate; {'; '.join(report)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del target, paged, drafts
    gc.collect()
    torch.cuda.empty_cache()


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def _first_difference_margins(model, params, toks, pads, got: list,
                              want: list) -> tuple[list, list, int, int]:
    """The near-tie reading of rows where `got` departs from `want`:
    `model` prefills row r's left-padded prompt (`toks[r]`, `pads[r]`)
    plus the tokens both runs share and takes the top-1 minus top-2
    logit margin at every step up to the first difference. Returns the
    margins at the first differences, the margins of the agreeing steps
    before them, on how many rows the two runs' tokens are that
    forward's top two, and how many rows differ."""
    import torch

    from kubeflow_tpu_torch.runtime.generate import init_cache

    p = toks.shape[1]
    at_diff, before, top_two, rows = [], [], 0, 0
    for r, (a, b) in enumerate(zip(got, want)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        rows += 1
        seq = torch.cat([toks[r:r + 1], torch.tensor(
            [b[:j]], device=toks.device, dtype=toks.dtype)], 1)
        with torch.no_grad():
            logits = model.apply(params, seq, decode_index=0,
                                 pad_len=pads[r:r + 1],
                                 cache=init_cache(model, 1))[0, p - 1:]
        top = logits.float().topk(2, dim=-1)
        margin = (top.values[:, 0] - top.values[:, 1]).tolist()
        at_diff.append(margin[j])
        before.extend(margin[:j])
        top_two += set(top.indices[j].tolist()) == {a[j], b[j]}
    return at_diff, before, top_two, rows


def near_tie_witness(spec_outs: list, plain_outs: list) -> str:
    """Why bf16 speculative rows differ from plain greedy ones: phase
    13b's bf16 int8 target, built again from its seed as
    serve_lm_generator builds it, prefills each differing row's
    left-padded prompt plus the tokens both runs share, and reads the
    top-1 minus top-2 logit margin at every step up to the first
    difference. A near tie has a margin far below the steps that agree,
    and the two runs' tokens are its top two."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serve_bench import bench_prompts
    from kubeflow_tpu_torch.serving.quant import QuantizedModel, quantize_params

    sv = SERVE
    prompts = bench_prompts(len(spec_outs), sv["prompt_len"], sv["vocab"])
    base = get_model(sv["model"], device="cuda", seed=0,
                     vocab_size=sv["vocab"],
                     max_seq_len=sv["prompt_len"] + sv["max_new"] + SPEC_K)
    model = QuantizedModel(base)
    with torch.no_grad():
        params = quantize_params(
            {k: v.detach() for k, v in base.state_dict().items()},
            base.cfg.head_dim)
    toks, pads = _left_padded(prompts, sv["prompt_len"])
    at_diff, before, top_two, rows = _first_difference_margins(
        model, params, toks, pads, spec_outs, plain_outs)
    del base, model, params
    if not rows:
        return "no row differs"
    return (f"{rows} of {len(spec_outs)} rows differ; at the first "
            f"difference the bf16 target's top-1 - top-2 logit margin is "
            f"median {_median(at_diff):.4f} (max {max(at_diff):.4f}) against "
            f"median {_median(before):.4f} over the {len(before)} agreeing "
            f"steps before it; the two runs' tokens are that forward's top "
            f"two on {top_two} of {rows} rows")


def speculative_pinned_f32() -> str:
    """Phase 13b's point computed in f32 (TF32 off): SERVE's model at
    SPEC_F32_LAYERS of its 24 layers (the script's time) with int8
    weights, SPEC_REQUESTS prompts of
    up to 511
    tokens on as many busy slots, the SPEC_DRAFT int8 draft with k
    SPEC_K. The speculative server's tokens must equal a plain greedy
    server's on the same weights, token for token."""
    import torch

    from kubeflow_tpu_torch.serve_bench import (
        bench_prompts, closed_loop, spec_stats)
    from kubeflow_tpu_torch.serving.server import serve_lm_generator

    sv = SERVE
    prompts = bench_prompts(SPEC_REQUESTS, sv["prompt_len"], sv["vocab"])
    outs, st = {}, {}
    for arm, extra in (("plain", {}), ("speculative", {
            "draft_model": SPEC_DRAFT, "draft_k": SPEC_K})):
        served = serve_lm_generator(
            arm, sv["model"], prompt_len=sv["prompt_len"],
            max_new_tokens=sv["max_new"], continuous_batching=True,
            decode_slots=sv["slots"], param_dtype=sv["param_dtype"],
            vocab_size=sv["vocab"], seed=0, device="cuda", dtype="float32",
            n_layers=SPEC_F32_LAYERS, **extra)
        try:
            _, outs[arm], _ = closed_loop(
                lambda q: served.predict([{"tokens": q}])[0], prompts,
                SPEC_REQUESTS)
            if extra:
                st = spec_stats(served.decoder().stats())
        finally:
            served.close()
        gc.collect()
        torch.cuda.empty_cache()
    bad = [r for r, (a, b) in enumerate(zip(outs["speculative"],
                                            outs["plain"])) if a != b]
    if bad:
        fail(f"speculative pinned f32: rows {bad} differ from plain greedy "
             "serving")
    return (f"{len(prompts)} requests x {sv['max_new']} tokens equal plain "
            f"greedy (f32, TF32 off, {SPEC_F32_LAYERS} layers); acceptance "
            f"{st['spec_tokens_accepted']}/{st['spec_drafted']} in "
            f"{st['spec_rounds']} slot-rounds")


def router_phase() -> None:
    """Two port ModelServer replicas on the card (gpt-350m width,
    CHECK_LAYERS layers, f32, continuous batching, paged cache) behind
    the port's RouterFrontend over HttpTransport: ROUTER_REQUESTS
    concurrent predicts; both replicas serve, every response equals a
    direct call of a replica on the same prompt, and the router's queue
    depth and in-flight tokens return to 0."""
    import concurrent.futures as cf
    import urllib.request

    import torch

    from kubeflow_tpu_torch.runtime.metrics import REGISTRY
    from kubeflow_tpu_torch.serving import router as R
    from kubeflow_tpu_torch.serving.server import (
        ModelServer, serve_lm_generator)

    t0 = time.perf_counter()
    slots = 8
    pages = slots * -(-(ROUTER_P + ROUTER_N) // CHECK_PAGE) + 1
    replicas = []
    for _ in range(2):
        srv = ModelServer()
        srv.register(serve_lm_generator(
            "lm", SERVE["model"], prompt_len=ROUTER_P,
            max_new_tokens=ROUTER_N, continuous_batching=True,
            decode_slots=slots, kv_pages=pages, kv_page_size=CHECK_PAGE,
            vocab_size=SERVE["vocab"], n_layers=CHECK_LAYERS,
            dtype="float32", seed=0, device="cuda"))
        replicas.append((srv, srv.serve(host="127.0.0.1", port=0)
                         .serve_background()))
    counts: dict = {}

    class Counting:
        def __init__(self, inner, name):
            self.inner, self.name = inner, name

        def predict(self, model, body, headers=None):
            counts[self.name] = counts.get(self.name, 0) + 1
            return self.inner.predict(model, body, headers)

    router = R.TokenRouter(service="chip", namespace="smoke", max_queue=64,
                           replica_token_budget=slots * (ROUTER_P + ROUTER_N))
    router.sync_endpoints(
        [{"name": f"replica-{i}", "addr": f"http://127.0.0.1:{svc.port}",
          "state": R.STATE_ACTIVE} for i, (_, svc) in enumerate(replicas)],
        transport_factory=lambda ep: Counting(R.HttpTransport(ep["addr"]),
                                              ep["name"]))
    front = R.RouterFrontend(router, max_new_tokens=ROUTER_N)
    fsvc = front.serve(host="127.0.0.1", port=0).serve_background()
    rng = random.Random(4)
    prompts = [[rng.randrange(1, SERVE["vocab"])
                for _ in range(rng.randrange(4, ROUTER_P))]
               for _ in range(ROUTER_REQUESTS)]

    def post(port: int, prompt: list[int]) -> list[int]:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:predict",
            data=json.dumps({"instances": [{"tokens": prompt}]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())["predictions"][0]

    try:
        t1 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=ROUTER_REQUESTS) as pool:
            routed = list(pool.map(lambda pr: post(fsvc.port, pr), prompts))
        routed_s = time.perf_counter() - t1
        direct = [post(replicas[0][1].port, pr) for pr in prompts]
    finally:
        fsvc.shutdown()
        for srv, svc in replicas:
            svc.shutdown()
            srv.close()
    if routed != direct:
        same = sum(a == b for a, b in zip(routed, direct))
        fail(f"router: {same} of {len(prompts)} routed responses equal a "
             "direct call (f32)")
    if len(counts) != 2 or sum(counts.values()) != len(prompts):
        fail(f"router: dispatches by replica {counts}, want both of 2 "
             f"serving {len(prompts)} requests")
    sig = R.RegistrySignals(REGISTRY)
    depth = sig.queue_depth("smoke", "chip")
    inflight = sig.inflight_tokens("smoke", "chip")
    if depth != 0 or inflight != 0 or router.queue_depth() != 0:
        fail(f"router: router_queue_depth {depth}, in-flight tokens "
             f"{inflight} after the run, want 0")
    print(f"router: 2 replicas ({SERVE['model']} width, {CHECK_LAYERS} "
          f"layers, f32, paged) behind RouterFrontend, {len(prompts)} "
          f"concurrent predicts in {routed_s:.2f} s, dispatches {counts}, "
          "every response == a direct replica call, router_queue_depth 0; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


# -- phases 15-16: the training runtime through the launcher -----------------

RESUME_STEPS, RESUME_EVAL_STEPS, RESUME_EVAL_EVERY = 6, 2, 3
RESUME_SIGTERM_AFTER = 3          # "step 3" log line
RESUME_LOSS_RTOL = 1e-3
RESUME_DOC_TOKENS = (64, 3000)    # document lengths drawn for the shards
RESUME_SKIP_BATCHES = 2_500       # batches a restart skips, timed alone
TRACE_ROOT = ("0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331")
SERVE_CKPT_SLOTS, SERVE_CKPT_P, SERVE_CKPT_N = 4, 64, 32
# a bf16 row of phase 16 may differ from generate() only at a near tie:
# its margin at the first difference under this share of the median
# margin of the steps that agree, and the two tokens that forward's top two
NEAR_TIE_RATIO = 0.25
# what the profile window must show: each flash kernel by its name
PROFILE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkv_kernel")
CAPTURE_STEPS = 2     # run C's on-demand capture
CAPTURE_LINE = re.compile(r"profiler capture server on :(\d+)")


class _OnDemandCapture:
    """Run C's on-demand capture: once its log names the capture port
    and its first step is done, `GET /capture?steps=CAPTURE_STEPS` on a
    thread (the request is answered when the window closes)."""

    def __init__(self):
        self.port = self.thread = self.result = self.error = None
        self.seconds = None

    def on_line(self, line: str) -> None:
        m = CAPTURE_LINE.search(line)
        if m:
            self.port = int(m.group(1))
        if (self.thread is None and self.port
                and "first step (incl. kernel build)" in line):
            import threading

            self.thread = threading.Thread(target=self._get, daemon=True)
            self.thread.start()

    def _get(self) -> None:
        import urllib.error
        import urllib.request

        url = (f"http://127.0.0.1:{self.port}/capture?steps={CAPTURE_STEPS}"
               "&timeout=300")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(url, timeout=600) as r:
                self.result = (r.status, dict(r.headers), r.read())
        except urllib.error.HTTPError as e:
            self.result = (e.code, dict(e.headers), e.read())
        except OSError as e:
            self.error = e
        self.seconds = time.perf_counter() - t0

    def held(self, evals_every: int) -> dict:
        """The capture's kernel events against the launches its steps
        make; fails the phase otherwise."""
        from kubeflow_tpu_torch.ops import flash_attention as fa

        if self.thread is None:
            fail(f"resume run C: no capture was requested (port {self.port})")
        self.thread.join(60)
        if self.error is not None or self.result is None:
            fail(f"resume run C: the capture request failed: {self.error}")
        status, headers, body = self.result
        if status != 200:
            fail(f"resume run C: capture answered {status}: {body[:300]!r}")
        first, last = map(int, headers["X-Capture-Steps"].split("-"))
        events = json.loads(body)["traceEvents"]
        got = {n: sum(1 for e in events if e.get("cat") == "kernel"
                      and f"{n}_kernel" in e.get("name", ""))
               for n in fa.SM90}
        want = _want_launches(first, last + 1,
                              _evals_in(first, last + 1, evals_every))
        want = {n: want[n] for n in fa.SM90}
        if last - first + 1 != CAPTURE_STEPS or got != want:
            fail(f"resume run C: capture of steps {first}-{last} holds "
                 f"kernel events {got}, want {want} over {CAPTURE_STEPS} "
                 "steps")
        return {"steps": [first, last], "kernel_events": got,
                "trace_mb": len(body) / 1e6, "request_s": self.seconds}


def _write_resume_shards(root) -> tuple[str, str]:
    """Packed KFR1 shards from numpy draws: documents of 64-3000 tokens
    packed at seq L, enough rows for 8 training batches over two shards,
    and a separate eval shard of 2 batches (its own draw)."""
    import numpy as np

    from kubeflow_tpu_torch.runtime import records

    def packed(seed: int, rows: int):
        rng = np.random.default_rng(seed)
        docs, tok = [], np.zeros((0, L + 1), np.int32)
        while tok.shape[0] < rows:
            lo, hi = RESUME_DOC_TOKENS
            docs += [rng.integers(1, MAIN_PATH["vocab_size"], int(n),
                                  dtype=np.int32)
                     for n in rng.integers(lo, hi + 1, 16)]
            tok, seg = records.pack_documents(docs, L)
        return tok[:rows], seg[:rows]

    tok, seg = packed(0, 8 * B)
    half = tok.shape[0] // 2
    for i, sl in enumerate((slice(0, half), slice(half, None))):
        records.write_packed_token_shard(str(root / f"train-{i}.kfr"),
                                         tok[sl], seg[sl])
    tok, seg = packed(1, RESUME_EVAL_STEPS * B)
    records.write_packed_token_shard(str(root / "eval.kfr"), tok, seg)
    segments = int((seg > 0).sum()) / seg.size
    return str(root / "train-*.kfr"), f"{segments:.3f} of eval positions in a document"


def _launch(cfg: dict, root, tag: str, sigterm_after: int | None = None,
            env_extra: dict | None = None, on_line=None) -> dict:
    """The port launcher as a subprocess on `cfg`, under an injected
    TRACEPARENT, with its span dump in KFTPU_TRACE_FILE; SIGTERM after
    its "step N" line when `sigterm_after` is given; `env_extra` on top
    of the env, and `on_line(line)` called on each line of its output as
    it comes. Returns the exit code, the output, the summary and the
    spans."""
    import os
    import re
    import signal
    import threading

    from kubeflow_tpu_torch.obs import trace as obs_trace

    cfg_path, trace_path = root / f"{tag}.json", root / f"{tag}.trace.jsonl"
    cfg_path.write_text(json.dumps(cfg))
    env = {**os.environ, "TRACEPARENT": f"00-{TRACE_ROOT[0]}-{TRACE_ROOT[1]}-01",
           "KFTPU_TRACE_FILE": str(trace_path), "JAXRT_METRICS_PORT": "0",
           # deterministic cuBLAS: a resumed run equals an uninterrupted one
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8", **(env_extra or {})}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
         "--config", str(cfg_path)],
        cwd=str(Path(__file__).resolve().parent), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines, signalled = [], None
    # a run that hangs without output is killed, so reading ends
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    try:
        for line in proc.stdout:
            lines.append(line)
            if on_line is not None:
                on_line(line)
            if (sigterm_after is not None and signalled is None
                    and re.search(rf"\bstep {sigterm_after} loss=", line)):
                proc.send_signal(signal.SIGTERM)
                signalled = time.perf_counter() - t0
        rc = proc.wait(timeout=600)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    wall = time.perf_counter() - t0
    summary_lines = [ln for ln in lines if ln.startswith('{"summary"')]
    if not summary_lines:
        print(out[-6000:], flush=True)
        fail(f"launcher run {tag}: exit {rc} with no summary line")
    # strictly valid JSON: no bare NaN / Infinity
    summary = json.loads(summary_lines[-1], parse_constant=lambda c: fail(
        f"launcher run {tag}: summary holds {c}"))["summary"]
    launches = _logged_launches(out)[0]
    spans = (obs_trace.read_jsonl(str(trace_path))
             if trace_path.exists() else [])
    return {"rc": rc, "out": out, "summary": summary, "launches": launches,
            "spans": spans, "wall": wall, "signalled": signalled}


def _check_trace(run: dict, tag: str) -> dict:
    """The dump is one connected tree: worker under the injected parent,
    train.fit under worker, train.step and train.checkpoint inside."""
    from kubeflow_tpu_torch.obs import trace as obs_trace

    spans = run["spans"]
    by_name: dict[str, list] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    workers, fits = by_name.get("worker", []), by_name.get("train.fit", [])
    if len(workers) != 1 or workers[0].parent_id != TRACE_ROOT[1] or \
            workers[0].trace_id != TRACE_ROOT[0]:
        fail(f"resume {tag} trace: worker spans "
             f"{[(w.trace_id, w.parent_id) for w in workers]}, want one "
             f"under {TRACE_ROOT}")
    if len(fits) != 1 or fits[0].parent_id != workers[0].span_id:
        fail(f"resume {tag} trace: train.fit not under worker")
    for name in ("train.step", "train.checkpoint"):
        inside = [s for s in by_name.get(name, [])
                  if s.parent_id == fits[0].span_id]
        if not inside or len(inside) != len(by_name[name]):
            fail(f"resume {tag} trace: {name} spans "
                 f"{len(by_name.get(name, []))}, {len(inside)} under "
                 "train.fit")
    reach = obs_trace.reachable(spans, TRACE_ROOT[1])
    if any(s.span_id not in reach for s in spans):
        fail(f"resume {tag} trace: spans outside the injected tree")
    return {name: len(v) for name, v in sorted(by_name.items())}


def _want_launches(start: int, end: int, evals: int) -> dict:
    steps = end - start
    return _launch_counts(LAYERS * (steps + RESUME_EVAL_STEPS * evals),
                          LAYERS * steps, LAYERS * steps)


def _evals_in(start: int, end: int, every: int) -> int:
    return sum(1 for s in range(start + 1, end + 1) if every and s % every == 0)


def resume_phase(card: str, synthetic_step_s: float, root) -> dict:
    """Phase 15: the pinned main path at full width through the launcher
    as a subprocess, on packed shards (segment ids reach the flash
    kernels) through the native loader and the Prefetcher, with
    checkpoints, evals, a profiler window and a SIGTERM: run A is
    preempted after its "step 3" line, run B resumes it to step 6, run C
    runs 6 steps straight; B is held to C. C shares the card with A (its
    results are held, its times not read); B is the phase's only run
    then, so the step time on shards and the checkpoint's seconds are
    B's (the script runs phases 30 and 35 beside this phase, whose
    launchers may still share the card and the host). Returns run B's
    launches and its checkpoint directory."""
    import concurrent.futures as cf
    import re

    import torch

    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.runtime import checkpoint as ckpt_mod
    from kubeflow_tpu_torch.runtime import records

    t0 = time.perf_counter()
    free_gb = shutil.disk_usage(root).free / 1e9
    data_path, seg_note = _write_resume_shards(root)
    ds = records.RecordDataset(sorted(map(str, root.glob("train-*.kfr"))), B,
                               native=True)        # raises without g++
    first = next(ds)
    ds.close()
    if not ds.native or first.shape != (B, 2 * 4 * (L + 1)):
        fail(f"resume: native loader {ds.native}, batch {first.shape}")
    cfg = {**MAIN_PATH, "data_path": data_path, "packed_data": True,
           "shuffle_buffer": 16, "checkpoint_every": 2, "checkpoint_keep": 2,
           "total_steps": RESUME_STEPS, "eval_every": RESUME_EVAL_EVERY,
           "eval_steps": RESUME_EVAL_STEPS,
           "eval_data_path": str(root / "eval.kfr"),
           "checkpoint_dir": str(root / "ckpt"),
           "profile_dir": str(root / "profile"), "profile_start_step": 2,
           "profile_steps": 1}
    print(f"resume: shards written ({seg_note}), native loader, "
          f"{free_gb:.0f} GB free on the checkout's disk; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # run C checkpoints through fsspec to a file:// URI where fsspec
    # imports; where it does not, the refusal is held
    uri_c = f"file://{root / 'ckpt_c'}"
    try:
        import fsspec  # noqa: F401
        ckpt_c = uri_c
    except ImportError:
        try:
            ckpt_mod.Checkpointer(uri_c)
        except ValueError as e:
            if "fsspec" not in str(e):
                raise
            print(f"resume: fsspec does not import here, a URI directory "
                  f"is refused ({e}): the URI checkpoint path went untested",
                  flush=True)
        else:
            fail("resume: a URI checkpoint directory was taken without "
                 "fsspec")
        ckpt_c = str(root / "ckpt_c")
    cfg_c = {**cfg, "checkpoint_dir": ckpt_c,
             "checkpoint_every": 0, "eval_every": 0, "profile_dir": None}
    capture = _OnDemandCapture()
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        run_c = pool.submit(_launch, cfg_c, root, "run_c",
                            env_extra={"JAXRT_PROFILER_PORT": "0"},
                            on_line=capture.on_line)
        a = _launch(cfg, root, "run_a", sigterm_after=RESUME_SIGTERM_AFTER)
        c = run_c.result()
    m = re.search(r"preempted at step (\d+)", a["out"])
    steps_a = ckpt_mod.list_steps(cfg["checkpoint_dir"])
    manifest = json.loads((root / "ckpt" / "manifest.json").read_text())
    if a["rc"] != 75 or not a["summary"].get("preempted") or not m:
        print(a["out"][-6000:], flush=True)
        fail(f"resume run A: exit {a['rc']} (want 75), summary "
             f"{a['summary']}, SIGTERM at {a['signalled']}")
    k = int(m.group(1))
    if k < RESUME_SIGTERM_AFTER or k >= RESUME_STEPS or not steps_a or \
            steps_a[-1] != k or manifest.get("latest_step") != k:
        fail(f"resume run A: preempted at {k}, steps on disk {steps_a}, "
             f"manifest {manifest}")
    want_a = _want_launches(0, k, _evals_in(0, k, RESUME_EVAL_EVERY))
    if a["launches"] != want_a:
        fail(f"resume run A: launches {a['launches']}, want {want_a}")
    tree_a = _check_trace(a, "A")
    traces = sorted((root / "profile").glob("*.json"))
    text = traces[0].read_text() if traces else ""
    missing = [n for n in PROFILE_KERNELS if n not in text]
    if len(traces) != 1 or missing:
        fail(f"resume run A: profile {traces}, kernels missing {missing}")

    b = _launch(cfg, root, "run_b")
    sb = b["summary"]
    ev = sb.get("eval") or {}
    if b["rc"] != 0 or sb.get("start_step") != k or sb.get("steps") != \
            RESUME_STEPS or "preempted" in sb:
        print(b["out"][-6000:], flush=True)
        fail(f"resume run B: exit {b['rc']}, summary {sb}, want start {k}")
    if ev.get("smoke") != 0.0 or not all(
            isinstance(ev.get(x), float) and math.isfinite(ev[x])
            for x in ("loss", "accuracy", "perplexity")):
        fail(f"resume run B: eval {ev}")
    want_b = _want_launches(k, RESUME_STEPS,
                            _evals_in(k, RESUME_STEPS, RESUME_EVAL_EVERY))
    if b["launches"] != want_b:
        fail(f"resume run B: launches {b['launches']}, want {want_b}")
    tree_b = _check_trace(b, "B")

    if c["rc"] != 0 or c["summary"].get("start_step") != 0:
        print(c["out"][-6000:], flush=True)
        fail(f"resume run C: exit {c['rc']}, summary {c['summary']}")
    want_c = _want_launches(0, RESUME_STEPS, 0)
    if c["launches"] != want_c:
        fail(f"resume run C: launches {c['launches']}, want {want_c}")
    captured = capture.held(cfg_c["eval_every"])

    # run B's final parameters against run C's, per row; C's restored
    # from its directory (through fsspec under the URI)
    pb = torch.load(root / "ckpt" / str(RESUME_STEPS) / ckpt_mod.PARAMS_FILE,
                    map_location="cuda", weights_only=True)["params"]
    if ckpt_mod.list_steps(ckpt_c) != [RESUME_STEPS]:
        fail(f"resume run C: steps {ckpt_mod.list_steps(ckpt_c)} in "
             f"{ckpt_c}, want [{RESUME_STEPS}]")
    t_restore = time.perf_counter()
    pc, _ = ckpt_mod.restore_params(ckpt_c)
    restore_c_s = time.perf_counter() - t_restore
    pc = {k: v.to("cuda") for k, v in pc.items()}
    if set(pb) != set(pc):
        fail("resume: runs B and C saved different parameters")
    worst = (0.0, 0.0, "")
    for name in sorted(pb):
        g, w = pb[name].float(), pc[name].float()
        g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
        e = check_rows(f"resume: run B vs run C {name}", g, w,
                       kernel_check.ROW_TOL)
        worst = max(worst, (e["max_row_err"], e["max_abs_err"], name))
    lb, lc = sb["final"]["loss"], c["summary"]["final"]["loss"]
    if not abs(lb - lc) <= RESUME_LOSS_RTOL * abs(lc):
        fail(f"resume: final loss B {lb} vs C {lc}, beyond "
             f"{RESUME_LOSS_RTOL} relative")
    del pb, pc

    # what a restart pays before its first step: fit skips the batches
    # the earlier run consumed through token_batches, as run B did; timed
    # here for RESUME_SKIP_BATCHES batches over the looped shards (so from
    # the page cache: a cold disk's read rate comes on top), and through
    # the record reader alone, without the per-batch token arrays
    paths = sorted(map(str, root.glob("train-*.kfr")))
    skip_s = {}
    for how, it in (
            ("token_batches", records.token_batches(
                paths, B, L, shuffle_buffer=16, seed=0, loop=True,
                segmented=True)),
            ("records", records.RecordDataset(
                paths, B, shuffle_buffer=16, loop=True, native=True))):
        t = time.perf_counter()
        for _ in range(RESUME_SKIP_BATCHES):
            next(it)
        skip_s[how] = time.perf_counter() - t
        it.close()

    def logged(run, pattern):
        return [float(x) for x in re.findall(pattern, run["out"])]

    nbytes = logged(a, r"queued save at step \d+ -> .* \((\d+) bytes")
    blocking = [s.duration for s in b["spans"] if s.name == "train.checkpoint"]
    writes = logged(b, r"written in ([\d.]+) s")
    restore_s = logged(b, r"restored step \d+ from .* in ([\d.]+) s")
    figures = {
        "preempted_at": k, "sigterm_after_s": a["signalled"],
        "checkpoint_bytes": int(nbytes[0]) if nbytes else None,
        "checkpoint_blocking_s": blocking,
        "checkpoint_write_s": writes, "restore_s": restore_s,
        "step_s_shards_prefetcher": sb["step_time_s"],
        "step_s_synthetic_phase6": synthetic_step_s,
        "resumed_vs_straight_max_row_err": worst[0],
        "resumed_vs_straight_max_abs_diff": worst[1],
        "resumed_vs_straight_worst_param": worst[2],
        "final_loss_b_c": [lb, lc],
        "eval": ev, "launches": {"A": a["launches"], "B": b["launches"],
                                 "C": c["launches"]},
        "spans": {"A": tree_a, "B": tree_b},
        "wall_s": {"A": a["wall"], "B": b["wall"], "C": c["wall"]},
        "run_c": {"checkpoint_dir": ckpt_c.split(":")[0] if "://" in ckpt_c
                  else "path",
                  "checkpoint_write_s": logged(c, r"written in ([\d.]+) s"),
                  "restore_params_s": restore_c_s,
                  "capture": captured},
        "profile_trace_mb": traces[0].stat().st_size / 1e6,
        "resume_skip": {"batches": RESUME_SKIP_BATCHES,
                        "bytes": RESUME_SKIP_BATCHES * first.size,
                        "s": skip_s},
    }
    print(f"resume ({card}): " + json.dumps(figures), flush=True)
    print(f"resume: run C's capture of steps {captured['steps']} holds "
          f"{captured['kernel_events']} flash kernel events "
          f"({captured['trace_mb']:.1f} MB, answered in "
          f"{captured['request_s']:.1f} s); its checkpoint through "
          f"{figures['run_c']['checkpoint_dir']} written in "
          f"{figures['run_c']['checkpoint_write_s']} s, params restored in "
          f"{restore_c_s:.2f} s", flush=True)
    print(f"resume: A preempted at step {k} (exit 75), B resumed {k} -> "
          f"{RESUME_STEPS}, B == C per row (max row err {worst[0]:.3g}, "
          f"max abs diff {worst[1]:.3g} in {worst[2]}), final loss "
          f"{lb:.6f} vs {lc:.6f}; checkpoint "
          f"{figures['checkpoint_bytes']} bytes, blocking {blocking} s, "
          f"write {writes} s, restore {restore_s} s (run B's); step "
          f"{sb['step_time_s'] * 1e3:.1f} ms on shards (run B) vs "
          f"{synthetic_step_s * 1e3:.1f} ms synthetic; skipping "
          f"{RESUME_SKIP_BATCHES} batches on resume "
          f"{skip_s['token_batches']:.2f} s (the record reader alone "
          f"{skip_s['records']:.2f} s); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(root / "ckpt_c", ignore_errors=True)
    shutil.rmtree(root / "profile", ignore_errors=True)
    return {"launches": b["launches"], "checkpoint_dir": root / "ckpt"}


def _serve_from_checkpoint(checkpoint_dir, prompts: list, dtype: str
                           ) -> tuple[list, list, str]:
    """4 greedy requests through serve_lm_generator(checkpoint_dir=...)
    (continuous batching, 4 slots) with `dtype` weights and compute, and
    generate() over the same prompts on the params restore_params reads,
    cast alike. Returns both token lists and, where rows differ, the
    near-tie witness (_first_difference_margins on generate()'s model),
    which fails unless every differing row is at a near tie: its
    margin under NEAR_TIE_RATIO of the agreeing steps' median and the
    two runs' tokens that forward's top two."""
    import concurrent.futures as cf

    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime.checkpoint import restore_params
    from kubeflow_tpu_torch.runtime.generate import generate
    from kubeflow_tpu_torch.serving.server import cast_params, serve_lm_generator

    p, n = SERVE_CKPT_P, SERVE_CKPT_N
    served = serve_lm_generator(
        "ckpt", "llama-1b", prompt_len=p, max_new_tokens=n, device="cuda",
        checkpoint_dir=str(checkpoint_dir), param_dtype=dtype, dtype=dtype,
        continuous_batching=True, decode_slots=SERVE_CKPT_SLOTS)
    try:
        with cf.ThreadPoolExecutor(max_workers=len(prompts)) as pool:
            got = list(pool.map(
                lambda pr: [int(t) for t in
                            served.predict([{"tokens": pr}])[0]], prompts))
    finally:
        served.close()
    params, step = restore_params(str(checkpoint_dir))
    model = get_model("llama-1b", device="cuda", max_seq_len=p + n,
                      dtype=dtype)
    model.load_state_dict(params)
    cast = cast_params({k: v.detach() for k, v in model.state_dict().items()},
                       dtype)
    toks, pads = _left_padded(prompts, p)
    with torch.no_grad():
        want = generate(model, cast, toks, max_new_tokens=n,
                        pad_len=pads)[:, p:].tolist()
    at_diff, before, top_two, rows = _first_difference_margins(
        model, cast, toks, pads, got, want)
    del model, cast, params
    witness = ""
    if rows:
        med = _median(before)
        witness = (f"{rows} of {len(got)} rows differ; margin at the first "
                   f"difference max {max(at_diff):.4f} against median "
                   f"{med:.4f} over the {len(before)} agreeing steps before "
                   f"it; the runs' tokens are that forward's top two on "
                   f"{top_two} of {rows} rows")
        if top_two != rows or not max(at_diff) < NEAR_TIE_RATIO * med:
            fail(f"serve from checkpoint ({dtype}): {witness}: a row "
                 f"differs by more than a near tie (margin under "
                 f"{NEAR_TIE_RATIO}x the agreeing steps' median and the "
                 "top two)")
    return got, want, witness


def serve_checkpoint_phase(checkpoint_dir, root) -> None:
    """Phase 16: serve_lm_generator(checkpoint_dir=run B's) on llama-1b
    with continuous batching, 4 slots, 4 greedy requests of 32 new
    tokens, against generate() on the params restore_params reads: in
    f32 (TF32 off) the tokens must be equal; in bf16, the serving dtype,
    the share of equal tokens is printed and a row may differ only at a
    near tie (see _serve_from_checkpoint): the slot decoder prefills a
    request alone or beside others, generate() all four at once, and on
    a model 6 steps from random init the top two logits are often
    within bf16's rounding. A draft checkpoint directory with no step
    fails registration."""
    import torch

    from kubeflow_tpu_torch.serving.server import serve_lm_generator

    t0 = time.perf_counter()
    p, n = SERVE_CKPT_P, SERVE_CKPT_N
    rng = random.Random(7)
    prompts = [[rng.randrange(1, 32000) for _ in range(k)]
               for k in (p, p // 2, 7, 3 * p // 4)]
    got, want, _ = _serve_from_checkpoint(checkpoint_dir, prompts, "float32")
    if got != want:
        same = sum(x == y for r, s in zip(got, want) for x, y in zip(r, s))
        fail(f"serve from checkpoint (f32): {same} of {len(prompts) * n} "
             "tokens equal generate() on the restored params")
    got16, want16, witness = _serve_from_checkpoint(checkpoint_dir, prompts,
                                                    "bfloat16")
    same16 = sum(x == y for r, s in zip(got16, want16) for x, y in zip(r, s))
    empty = root / "empty_draft"
    empty.mkdir(exist_ok=True)
    try:
        serve_lm_generator("bad", "llama-1b", prompt_len=p, max_new_tokens=n,
                           device="cuda", draft_model="gpt-125m",
                           draft_checkpoint_dir=str(empty),
                           continuous_batching=True)
    except FileNotFoundError as e:
        refused = str(e)
    else:
        fail("serve from checkpoint: an empty draft checkpoint directory "
             "registered")
    print(f"serve from checkpoint: llama-1b, {SERVE_CKPT_SLOTS} slots, "
          f"{len(prompts)} greedy requests x {n} tokens; f32 == generate() "
          f"on restore_params; bf16 {same16} of {len(prompts) * n} tokens "
          f"equal ({witness or 'all rows equal'}); empty draft dir refused "
          f"({refused}); {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


# -- the classification models (phases 17-20) -------------------------------

RESNET_YAML = "examples/resnet50.yaml"
RESNET_STEPS, RESNET_LOG_EVERY = 10, 5
RESNET50_STEP_FLOPS = 6.34e12      # fwd_flops(space_to_depth) x 3 x 256
CPU_REL_TOL = 1e-3                 # f32 card vs CPU: logits, statistics
BF16_ROW_TOL = 2e-2                # bf16 vs f32 logits, per row
CHECK_BATCH, SERVE_PREDICTS = 8, 8
ENCODERS = {  # full width: ViT-B/16 at 224px, BERT-base at seq 512
    "vit-b16": {"model": "vit-b16", "task": "classification",
                "global_batch": 128, "image_size": 224,
                "flops": 13.4e12},
    "bert-base": {"model": "bert-base", "task": "seq_classification",
                  "global_batch": 32, "seq_len": 512, "vocab_size": 30522,
                  "num_classes": 2, "flops": 9.28e12},
}
ENCODER_STEPS = 5


def resnet_yaml_config() -> dict:
    """examples/resnet50.yaml as a TrainConfig dict (the file itself is
    read, never written)."""
    from kubeflow_tpu_torch.utils import yaml_lite

    here = Path(__file__).resolve().parent
    return yaml_lite.loads((here / RESNET_YAML).read_text())


def resnet_launcher_phase(root) -> dict:
    """Phase 17: examples/resnet50.yaml through the port launcher as a
    subprocess, at full width and depth (batch 256, 224px,
    space_to_depth, sgdm, bf16), total_steps and log_every overridden in
    a copy, with a checkpoint directory. Requires exit 0, a finite loss,
    a summary line and no flash launch; prints images/s, step ms, MFU
    and the peak memory the launcher logs. Returns the run."""
    import re

    cfg = resnet_yaml_config()
    cfg.update(total_steps=RESNET_STEPS, log_every=RESNET_LOG_EVERY,
               checkpoint_dir=str(root / "resnet50_ckpt"))
    run = _launch(cfg, root, "resnet50")
    if run["rc"] != 0:
        print(run["out"][-6000:], flush=True)
        fail(f"resnet50 launcher: exit {run['rc']}")
    s = run["summary"]
    loss = s["final"].get("loss")
    if loss is None or not math.isfinite(loss) or s["steps"] != RESNET_STEPS:
        fail(f"resnet50 launcher: summary {s}")
    if run["launches"] is None or any(run["launches"].values()):
        fail(f"resnet50 launcher: flash launches {run['launches']}, want 0")
    peak = re.findall(r"peak device memory: ([0-9.]+) GB", run["out"])
    if not peak:
        fail("resnet50 launcher: no peak memory line")
    run["peak_gb"] = float(peak[-1])
    flops = s["examples_per_sec"] / cfg["global_batch"] * RESNET50_STEP_FLOPS
    print(f"resnet50 launcher ({RESNET_YAML}, {RESNET_STEPS} steps): "
          f"{s['examples_per_sec']:.1f} images/s, step "
          f"{s['step_time_s'] * 1e3:.2f} ms, mfu {s['mfu']}, "
          f"{flops / 1e12:.1f} TFLOP/s, peak {run['peak_gb']:.2f} GB, "
          f"final loss {loss:.4f}, wall {run['wall']:.1f} s", flush=True)
    return run


def _resnet_step(trainer, batch: dict) -> dict:
    """Train-mode logits of `batch` (moving the BatchNorm statistics
    once), one sgdm step on it, then its eval-mode logits; the model's
    state after the step."""
    import torch

    trainer.model.train()
    with torch.no_grad():
        before = trainer.model(batch["image"]).float().cpu()
    trainer.train_step(batch)
    trainer.model.eval()
    with torch.no_grad():
        evl = trainer.model(batch["image"]).float().cpu()
    return {"train_logits": before, "eval_logits": evl,
            "state": {k: v.float().cpu()
                      for k, v in trainer.model.state_dict().items()}}


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-12))


def resnet_card_vs_cpu_phase() -> None:
    """Phase 18: ResNet-50 at full width and depth, batch 8, 224px, the
    same weights on the card and on the CPU, f32 with TF32 off: after
    one sgdm step the logits (train mode before it, eval mode after) and
    every BatchNorm statistic within 1e-3 relative, every parameter
    within 1e-2 per row (kernel_check's limit); then bf16 on the card
    against that f32 run, logits within 2e-2 per row."""
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    base = {"model": "resnet50", "task": "classification",
            "global_batch": CHECK_BATCH, "image_size": 224,
            "optimizer": "sgdm", "learning_rate": 0.1, "warmup_steps": 0,
            "total_steps": 10}
    f32 = {**base, "model_kwargs": {"stem": "space_to_depth",
                                    "dtype": "float32"}}
    cpu = Trainer(TrainConfig.from_dict(f32), device="cpu")
    init = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    host = next(cpu.data_iter())
    runs = {}
    for tag, cfg, dev in (("cpu", f32, "cpu"), ("card f32", f32, "cuda"),
                          ("card bf16", {**base, "model_kwargs": {
                              "stem": "space_to_depth"}}, "cuda")):
        t = cpu if dev == "cpu" else Trainer(TrainConfig.from_dict(cfg),
                                             device=dev)
        t.model.load_state_dict(init)
        runs[tag] = _resnet_step(t, t._to_device(host))
        del t
    want, got = runs["cpu"], runs["card f32"]
    worst = {}
    for key in ("train_logits", "eval_logits"):
        worst[key] = max(_rel(g, w) for g, w in zip(got[key], want[key]))
        if not worst[key] <= CPU_REL_TOL:
            fail(f"resnet50 card vs cpu: {key} row error {worst[key]:.3g}")
    params = {n for n in want["state"] if not n.endswith((".mean", ".var"))}
    worst["batch_stats"] = max(_rel(got["state"][n], want["state"][n])
                               for n in want["state"] if n not in params)
    if not worst["batch_stats"] <= CPU_REL_TOL:
        fail(f"resnet50 card vs cpu: batch_stats {worst['batch_stats']:.3g}")
    moved = max(_rel(want["state"][n], init[n].float()) for n in params
                if init[n].abs().sum() > 0)

    def rows(t):             # a kernel's rows are its outputs; a vector is one
        return t.reshape(t.shape[0], -1) if t.ndim > 1 else t[None]

    worst["params"] = max(
        check_rows(f"resnet50 {n}", rows(got["state"][n]),
                   rows(want["state"][n]), 1e-2)["max_row_err"]
        for n in params)
    bf = runs["card bf16"]
    e16 = check_rows("resnet50 bf16 vs f32 logits", bf["train_logits"],
                     got["train_logits"], BF16_ROW_TOL)
    print(f"resnet50 card vs cpu (batch {CHECK_BATCH}, f32, TF32 off): "
          f"train logits {worst['train_logits']:.3g}, eval logits "
          f"{worst['eval_logits']:.3g}, batch_stats "
          f"{worst['batch_stats']:.3g} (relative), params "
          f"{worst['params']:.3g} per row (the step moved them up to "
          f"{moved:.3g}); bf16 logits {e16['max_row_err']:.4f} per row; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def classifier_server_phase(checkpoint_dir: str) -> None:
    """Phase 19: serve_flax_classifier("resnet50") behind the REST server
    on 127.0.0.1, 8 predicts over HTTP: softmax rows sum to 1 within
    1e-3 and equal a direct call to the model; then the same from the
    phase 17 checkpoint (its params and batch_stats, which must have
    moved from their initial values). Prints p50 latency."""
    import urllib.request

    import numpy as np
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime.checkpoint import restore_variables
    from kubeflow_tpu_torch.serving.server import (
        ModelServer,
        serve_flax_classifier,
    )

    kw = {"num_classes": 1000, "stem": "space_to_depth"}
    images = np.random.default_rng(3).random(
        (SERVE_PREDICTS, 224, 224, 3), dtype=np.float32)
    variables, step = restore_variables(checkpoint_dir)
    stats = variables.get("batch_stats") or {}
    if not stats or all(float(v.abs().max()) == 0.0 for n, v in
                        stats.items() if n.endswith(".mean")):
        fail(f"classifier: checkpoint step {step} holds no moved "
             "batch_stats")
    for tag, ckpt in (("random", None), ("checkpoint", checkpoint_dir)):
        server = ModelServer()
        server.register(serve_flax_classifier(
            "resnet50", "resnet50", checkpoint_dir=ckpt, **kw))
        svc = server.serve(host="127.0.0.1", port=0).serve_background()
        lat, rows = [], []
        try:
            for img in images:
                body = json.dumps({"instances": [img.tolist()]}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{svc.port}/v1/models/resnet50:predict",
                    data=body, method="POST")
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as r:
                    rows.append(json.loads(r.read())["predictions"][0])
                lat.append(time.perf_counter() - t)
        finally:
            svc.shutdown()
            server.close()
        got = np.asarray(rows, np.float64)
        model = get_model("resnet50", device="cuda", **kw).eval()
        if ckpt:
            model.load_state_dict({**variables["params"], **stats})
        with torch.no_grad():
            want = torch.cat([torch.softmax(model(torch.from_numpy(
                img[None]).cuda()).float(), -1).cpu() for img in images])
        sums = np.abs(got.sum(-1) - 1.0).max()
        diff = np.abs(got - want.double().numpy()).max()
        if got.shape != (SERVE_PREDICTS, 1000) or not sums <= 1e-3 \
                or not diff <= 1e-3:
            fail(f"classifier {tag}: shape {got.shape}, row sums off by "
                 f"{sums:.3g}, vs direct call {diff:.3g}")
        print(f"classifier server ({tag} weights"
              f"{f', step {step}' if ckpt else ''}): {SERVE_PREDICTS} "
              f"predicts over HTTP, p50 {sorted(lat)[len(lat) // 2] * 1e3:.1f}"
              f" ms, row sums within {sums:.2g} of 1, max diff to a direct "
              f"call {diff:.2g}", flush=True)
        del model
        torch.cuda.empty_cache()


def _encoder_batch(name: str, spec: dict) -> dict:
    """The synthetic batch of `spec`; BERT's tokens end in a run of
    0-padding (64-383 positions) on every other row."""
    import numpy as np

    from kubeflow_tpu_torch.runtime import data

    b = spec["global_batch"]
    if spec["task"] == "classification":
        return dict(next(data.synthetic_images(b, spec["image_size"],
                                               1000, 0)))
    batch = dict(next(data.synthetic_token_classes(
        b, spec["seq_len"], spec["vocab_size"], spec["num_classes"], 0)))
    tok = batch["tokens"].copy()
    tok[tok == 0] = 1
    pads = np.random.default_rng(1).integers(64, 384, b)
    for r in range(0, b, 2):
        tok[r, -pads[r]:] = 0
    batch["tokens"] = tok
    return batch


def encoder_phase(name: str, card: str) -> dict:
    """Phase 20: `name` (vit-b16, bert-base) at full width, a few sgdm
    steps in bf16 through the Trainer: a finite loss, step ms (steps 2
    onward between two synchronizes), MFU and peak memory; then bf16
    logits against f32 on the card with the same weights, within 2e-2
    per row. Returns the figures."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.metrics import StepMeter
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    spec = ENCODERS[name]
    cfg = {k: v for k, v in spec.items() if k != "flops"}
    cfg.update(optimizer="sgdm", learning_rate=0.1, warmup_steps=2,
               total_steps=ENCODER_STEPS)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(TrainConfig.from_dict(cfg), device="cuda")
    if abs(trainer.flops_per_step() - spec["flops"]) > 0.01 * spec["flops"]:
        fail(f"{name}: {trainer.flops_per_step() / 1e12:.2f} TFLOP a step, "
             f"want {spec['flops'] / 1e12}")
    host = _encoder_batch(name, spec)
    batch = trainer._to_device(host)
    x = batch["image" if spec["task"] == "classification" else "tokens"]
    fa.reset_launches()
    times = []
    for i in range(ENCODER_STEPS):
        t = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    loss = float(m["loss"])
    launches = dict(fa.LAUNCHES)
    if not math.isfinite(loss):
        fail(f"{name}: loss {loss}")
    if any(launches.values()):
        fail(f"{name}: flash launches {launches}: the reference attends by "
             "its plain einsum here")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = sum(times[1:]) / (len(times) - 1)
    meter = StepMeter(trainer.flops_per_step(), torch.cuda.get_device_name())
    meter._times.append(step_s)
    trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    # bf16 against f32 on the trained weights (ViT's head starts at zero):
    # the final norm's output, every token's row, and the logits
    logits, hidden = {}, {}
    for dtype in ("bfloat16", "float32"):
        c = {**cfg, "model_kwargs": {"dtype": dtype}}
        model = Trainer(TrainConfig.from_dict(c), device="cuda").model
        model.load_state_dict(trained)
        hook = model.ln_f.register_forward_hook(
            lambda mod, i, o, d=dtype: hidden.__setitem__(d, o.float().cpu()))
        with torch.no_grad():
            logits[dtype] = model(x[:8]).float().cpu()
        hook.remove()
        del model
        torch.cuda.empty_cache()
    eh = check_rows(f"{name} bf16 vs f32 hidden", hidden["bfloat16"],
                    hidden["float32"], BF16_ROW_TOL)
    if spec["task"] == "classification":
        el = check_rows(f"{name} bf16 vs f32 logits", logits["bfloat16"],
                        logits["float32"], BF16_ROW_TOL)
    else:
        # two logits a row: a projection of the [CLS] row onto two
        # directions, whose relative error is the hidden row's only up
        # to cancellation; the reference's own bf16 logits miss 2e-2 a
        # row here (tests/test_torch_bert.py), so they are printed
        from kubeflow_tpu_torch.ops import kernel_check

        el = kernel_check.errors(logits["bfloat16"], logits["float32"])
    out = {"step_ms": step_s * 1e3, "mfu": meter.mfu, "peak_gb": peak,
           "loss": loss, "bf16_hidden_row_err": eh["max_row_err"],
           "bf16_logit_row_err": el["max_row_err"], "launches": launches}
    held = "held" if spec["task"] == "classification" else "not held"
    print(f"{name} ({cfg['global_batch']} x "
          f"{cfg.get('seq_len') if spec['task'] != 'classification' else str(cfg['image_size']) + 'px'}"
          f", {card}): step {out['step_ms']:.2f} ms, mfu "
          f"{out['mfu']:.4f}, peak {peak:.2f} GB, final loss {loss:.4f}; "
          f"bf16 vs f32 on the trained weights: hidden "
          f"{eh['max_row_err']:.4f} per row, logits "
          f"{el['max_row_err']:.4f} per row ({held}), max abs "
          f"{el['max_abs_err']:.4g}; flash launches {launches}", flush=True)
    return out


WORLD_YAML = "examples/gpt-125m.yaml"
WORLD_STEPS = 3                 # (a): steps of each run
WORLD_RESUME_STEPS = 5          # (b): the schedule's total and the resumed end
WORLD_SIGTERM_AFTER = 2         # (b): rank 1's "step 2" line
WORLD_ROW_TOL = 1e-2            # final params per row, as kernel_check's
WORLD_LOSS_RTOL = 1e-3
# the pinned main path's chunked loss: a rank at local batch 32 peaks at
# 6.6 GB reserved instead of 19.1, so three runs and phase 34's gang fit
# the card at once
WORLD_XENT_CHUNKS = 8
# The parameter change (final minus initial) of a world against one
# process's, per row relative to that row of one process's change
# (kernel_check.errors). The schedule's first learning rates are 0, 3e-6,
# 6e-6 (warmup 100): the params move by ~1e-5, so their own rows cannot
# tell a wrong world from a right one, their change can. The limit is
# set from the sound runs' readings on an H100 (0.074 for (a)'s ranks,
# 0.076 for (b)'s resume; bf16 rounding at other batch splits, which
# AdamW's sign-like first steps magnify) against the controls' (1.27 and
# 0.84): the phase plants a control, the same world with the gradient
# reduce skipped, that must exceed it.
WORLD_DELTA_TOL = 0.25


def world_config(root, tag: str, data: int, total_steps: int,
                 checkpoint_every: int = 0) -> dict:
    """examples/gpt-125m.yaml's model and data shape at full width and
    depth (gpt-125m, seq 1024, vocab 32000, global batch 64, adamw,
    remat), on a data-parallel mesh of `data` ranks (the yaml's fsdp 4 x
    model 2 needs 8 GPUs), the loss in WORLD_XENT_CHUNKS chunks, a
    checkpoint directory per run."""
    from kubeflow_tpu_torch.utils import yaml_lite

    here = Path(__file__).resolve().parent
    cfg = yaml_lite.loads((here / WORLD_YAML).read_text())
    cfg.update(mesh={"data": data}, total_steps=total_steps, log_every=1,
               xent_chunks=WORLD_XENT_CHUNKS,
               checkpoint_every=checkpoint_every,
               checkpoint_dir=str(root / f"{tag}_ckpt"))
    return cfg


def world_worker(argv: list[str]) -> int:
    """`chip_smoke.py --world-worker DUMP STEPS FAULT LAUNCHER-ARGS...`:
    the port launcher in this process, as one rank of phase 21. At each
    global step in STEPS (comma-separated) the trainer's parameter
    change since fit began (f32, on the host) is saved to
    `DUMP.<step>.pt` (DUMP `-`: none). FAULT `no-reduce` is the phase's
    control: the trainer skips its gradient reduce, so each rank steps
    on its own rows' gradients; `no-exchange` is phase 29's: the MoE
    all-to-all returns its input, so each rank's tokens meet its own
    experts only (the reference's dropped all_to_all); phase 31's
    `no-tp-sum` leaves out tensor parallelism's sum of the ranks' partial
    outputs, `no-fsdp-sync` FSDP2's gradient reduce-scatter; phase 32's
    `no-kv-gather` leaves out the seq axis' K/V gather (each rank attends
    its own block only: what the old refusal of local impls on a seq
    mesh guarded against) and `no-ulysses-exchange` the Ulysses
    all-to-alls; `none` runs the port as it is. Where fsdp or model split the parameters, the
    dump holds them gathered whole."""
    import torch

    from kubeflow_tpu_torch.runtime import launcher
    from kubeflow_tpu_torch.runtime import trainer as T

    dump, steps, fault = argv[:3]
    steps = {int(x) for x in steps.split(",") if x}
    fit = T.Trainer.fit

    def params(trainer) -> dict:
        shape = trainer.mesh.shape
        src = (trainer.payload()["params"]
               if shape["fsdp"] > 1 or shape["model"] > 1
               else dict(trainer.model.named_parameters()))
        return {n: p.detach().to("cpu", torch.float32, copy=True)
                for n, p in src.items()}

    def fit_dumping(self, *args, **kwargs):
        init = params(self)         # a resumed run restores inside fit

        def at_step(i, m):
            if self.step in steps:
                torch.save({n: v - init[n] for n, v in params(self).items()},
                           f"{dump}.{self.step}.pt")

        return fit(self, *args, callback=at_step, **kwargs)

    if dump != "-":
        T.Trainer.fit = fit_dumping
    if fault == "no-reduce":
        T.Trainer._reduce_grads = lambda self: None
    elif fault == "no-exchange":
        from kubeflow_tpu_torch.ops import moe

        moe.all_to_all = lambda x, group: x
    elif fault == "no-tp-sum":
        from kubeflow_tpu_torch.parallel import shardings as S

        S._Exit.forward = staticmethod(lambda ctx, x, group: x.clone())
    elif fault == "no-fsdp-sync":
        from kubeflow_tpu_torch.parallel import shardings as S

        apply_fsdp = S.apply_fsdp

        def unsynced(model, plan, mesh):
            apply_fsdp(model, plan, mesh)
            for m in model.modules():
                if hasattr(m, "set_requires_gradient_sync"):
                    m.set_requires_gradient_sync(False, recurse=False)

        S.apply_fsdp = unsynced
    elif fault == "no-kv-gather":
        from kubeflow_tpu_torch.ops import seq_attention as SA

        SA.gather_seq = lambda x, seq: x
    elif fault == "no-ulysses-exchange":
        from kubeflow_tpu_torch.ops import ulysses

        ulysses.all_to_all = lambda x, group: x
    elif fault != "none":
        fail(f"world worker: unknown fault {fault!r}")
    return launcher.main(argv[3:])


def _free_port_pair() -> int:
    """A port p with p + 1 free too (the loopback backend's barrier binds
    p, its gloo store p + 1), drawn below the kernel's ephemeral range
    (`parallel.dist.free_port`): a port of bind(0) is an ephemeral one,
    which any connect() on the host (a phase beside this one opens many)
    may take before rank 0 binds it."""
    import socket

    from kubeflow_tpu_torch.parallel.dist import free_port

    for _ in range(100):
        p = free_port()
        with socket.socket() as b:
            try:
                b.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
        return p
    fail("no two adjacent free ports")


def _launch_world(cfg: dict, root, tag: str, world: int,
                  sigterm_after: int | None = None, dump_steps=(),
                  fault: str = "none") -> list[dict]:
    """`world` port launchers as subprocesses on one card
    (`world_worker`), one per JAXJOB_PROCESS_ID around one coordinator,
    through the loopback collectives backend (a gloo world: NCCL refuses
    two ranks on one device), `--nproc-per-node 1`; rank 1 is SIGTERMed
    after its "step N" line when `sigterm_after` is given; each rank's
    parameter change at `dump_steps` goes to `<tag>.rank<r>.<step>.pt`.
    Returns each rank's exit code, output, summary, flash launches and
    spans."""
    import os
    import signal

    from kubeflow_tpu_torch.obs import trace as obs_trace

    cfg_path = root / f"{tag}.json"
    cfg_path.write_text(json.dumps(cfg))
    port = _free_port_pair()
    procs, logs = [], []
    t0 = time.perf_counter()
    spawned = time.time()
    for rank in range(world):
        logs.append(root / f"{tag}.rank{rank}.log")
        # the ranks split the host's cores
        env = {**os.environ, "JAXRT_METRICS_PORT": "0",
               "KFTPU_TRACE_FILE": str(root / f"{tag}.rank{rank}.trace"),
               "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
               "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // world))}
        if world > 1:
            env.update(JAXJOB_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAXJOB_NUM_PROCESSES=str(world),
                       JAXJOB_PROCESS_ID=str(rank),
                       JAXJOB_COLLECTIVES_BACKEND="loopback")
        dump = str(root / f"{tag}.rank{rank}") if dump_steps else "-"
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--world-worker",
             dump, ",".join(map(str, dump_steps)), fault,
             "--config", str(cfg_path), "--nproc-per-node", "1"],
            cwd=str(Path(__file__).resolve().parent), env=env,
            stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + 600
        if sigterm_after is not None:
            while not re.search(rf"\bstep {sigterm_after} loss=",
                                logs[1].read_text()):
                if time.monotonic() > deadline or procs[1].poll() is not None:
                    print(logs[1].read_text()[-6000:], flush=True)
                    fail(f"world {tag}: rank 1 never logged step "
                         f"{sigterm_after}")
                time.sleep(0.2)
            procs[1].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    runs = []
    for rank, rc in enumerate(rcs):
        out = logs[rank].read_text()
        lines = [ln for ln in out.splitlines() if ln.startswith('{"summary"')]
        if not lines:
            print(out[-6000:], flush=True)
            fail(f"world {tag} rank {rank}: exit {rc} with no summary line")
        launches, instances = _logged_launches(out)
        trace = root / f"{tag}.rank{rank}.trace"
        runs.append({"rc": rc, "out": out, "wall": wall,
                     "summary": json.loads(lines[-1])["summary"],
                     "launches": launches, "instances": instances,
                     "startup": _startup(out, spawned, wall),
                     "spans": obs_trace.read_jsonl(str(trace))
                     if trace.exists() else []})
    return runs


# a launcher's log lines that close each part of its start-up
_STARTUP_MARKS = (("python, torch, cuda", r"collectives backend: "),
                  ("world", r"process \d+/\d+ "),
                  ("config", r"trainer mesh: "),
                  ("trainer build", r"first step \(incl\. kernel build\)"),
                  ("first step", r"first step \(incl\. kernel build\)"))


def _startup(out: str, spawned: float, wall: float) -> dict:
    """Where a launcher's seconds went, from the timestamps of its log
    lines: process start to the collectives backend (interpreter, torch,
    the CUDA context), the world's formation, the config, the trainer's
    build (weights, optimizer, data), the first step (kernel load,
    cuBLAS, the allocator; its own logged seconds), the later steps, and
    from the last step line to the process's exit (the last checkpoint
    write, teardown)."""
    import datetime

    def at(line: str) -> float:
        return datetime.datetime.strptime(
            line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()

    stamped = [ln for ln in out.splitlines()
               if re.match(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} ", ln)]
    parts, last = {}, spawned
    for name, pattern in _STARTUP_MARKS:
        hit = next((ln for ln in stamped if re.search(pattern, ln)), None)
        if hit is None:
            return parts
        parts[name] = round(at(hit) - last, 2)
        last = at(hit)
    # the first step's own seconds, which it logs, out of the trainer's
    first = re.search(r"first step \(incl\. kernel build\): ([\d.]+)s", out)
    parts["first step"] = float(first.group(1))
    parts["trainer build"] = round(parts["trainer build"] -
                                   parts["first step"], 2)
    steps = [ln for ln in stamped if re.search(r"\bstep \d+ loss=", ln)]
    if not steps:
        return parts
    parts["later steps"] = round(at(steps[-1]) - last, 2)
    parts["to exit"] = round(spawned + wall - at(steps[-1]), 2)
    return parts


def _final_params(run_root, tag: str, step: int | None = None) -> tuple:
    from kubeflow_tpu_torch.runtime.checkpoint import restore_params

    return restore_params(str(run_root / f"{tag}_ckpt"), step)


def _hold_params(name: str, got: tuple, want: tuple, tol: float) -> float:
    """Every parameter of checkpoint `got` against `want` per row; the
    largest row error."""
    (gp, gstep), (wp, wstep) = got, want
    if gstep != wstep or set(gp) != set(wp):
        fail(f"{name}: checkpoint step {gstep} vs {wstep}, "
             f"{len(gp)} vs {len(wp)} params")
    worst = 0.0
    for k, w in wp.items():
        g, w = gp[k].float(), w.float()
        if g.ndim < 2:
            g, w = g[None], w[None]
        e = check_rows(f"{name} {k}", g.reshape(g.shape[0], -1),
                       w.reshape(w.shape[0], -1), tol)
        worst = max(worst, e["max_row_err"])
    return worst


def _delta_errors(got_path, want_path, rank: int = 0) -> dict:
    """A run's parameter change against one process's (`world_worker`'s
    dumps), on the card: the largest per-row error over every parameter
    (kernel_check.errors: each row's L2 error over that row's L2 norm of
    one process's change), the parameter it is in, and the whole change's
    L2 error over its L2 norm. A parameter the rank holds a dim-0 slice
    of (experts under `expert`) is held against that slice, `rank` its
    index."""
    import torch

    from kubeflow_tpu_torch.ops import kernel_check

    got = torch.load(got_path, map_location="cuda", weights_only=True)
    want = torch.load(want_path, map_location="cuda", weights_only=True)
    if set(got) != set(want):
        fail(f"{got_path}: {len(got)} params vs {len(want)}")
    worst, where, diff2, norm2 = -1.0, "", 0.0, 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            w = w.chunk(w.shape[0] // g.shape[0], 0)[rank]
        if g.ndim < 2:
            g, w = g[None], w[None]
        g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        e = kernel_check.errors(g, w)["max_row_err"]
        if e > worst:
            worst, where = e, k
        diff2 += float((g - w).square().sum())
        norm2 += float(w.square().sum())
    return {"max_row_err": worst, "param": where,
            "whole": math.sqrt(diff2 / max(norm2, 1e-30))}


def _hold_delta(name: str, got_path, want_path, control_path,
                rank: int = 0, tol: float = WORLD_DELTA_TOL) -> str:
    """Hold a world's parameter change against one process's within
    `tol` per row, and the control's beyond it (else the check could not
    tell a world without its reduce from a right one)."""
    e = _delta_errors(got_path, want_path, rank)
    c = _delta_errors(control_path, want_path, rank)
    if not e["max_row_err"] <= tol:
        fail(f"{name}: parameter change max row err {e['max_row_err']:.4g} "
             f"in {e['param']} (limit {tol}; whole {e['whole']:.4g})")
    if not c["max_row_err"] > tol:
        fail(f"{name}: the control (the planted fault) reads "
             f"{c['max_row_err']:.4g} per row, within the limit {tol}: the "
             "check cannot fail a wrong world")
    return (f"parameter change max row err {e['max_row_err']:.4g} "
            f"({e['param']}; whole {e['whole']:.4g}) against the control's "
            f"{c['max_row_err']:.4g} ({c['param']}; whole {c['whole']:.4g}), "
            f"limit {tol}")


def _reduce_share(run: dict) -> tuple[float, float]:
    """(mean metered step s, mean gradient-reduce s): the train.grad_reduce
    spans (the reduce's time on the card, CUDA events) after the first
    step's."""
    reduces = [s.duration for s in run["spans"]
               if s.name == "train.grad_reduce"][1:]
    step = run["summary"]["step_time_s"]
    return step, (sum(reduces) / len(reduces) if reduces else float("nan"))


def _world_launches(run: dict, steps: int, tag: str) -> dict:
    """Each flash kernel's launches on one rank: 12 layers a step; the
    forward twice under the yaml's remat (policy full replays it)."""
    want = _launch_counts(2 * 12 * steps, 12 * steps, 12 * steps)
    if run["launches"] != want:
        fail(f"world {tag}: flash launches {run['launches']}, want {want}")
    return run["launches"]


def _ok(runs: list[dict], tag: str, rc: int = 0) -> None:
    for r, run in enumerate(runs):
        if run["rc"] != rc:
            print(run["out"][-6000:], flush=True)
            fail(f"world {tag} rank {r}: exit {run['rc']}, want {rc}")


def world_phase(root) -> dict:
    """Phase 21, the world on one card, against one process (5 straight
    steps of examples/gpt-125m.yaml's model at full width and depth,
    global batch 64, its parameter change dumped at steps 3 and 5).
    (a) two port launchers share the card over gloo (mesh data 2, local
    batch 32) for 3 steps: both print the same losses, each launches each
    flash kernel 12 times a step (the forward 24: full remat replays it),
    each rank's parameter change equals one process's per row within
    WORLD_DELTA_TOL while the control's (the same world with the reduce
    skipped) does not, the final params per row within 1e-2 and the
    final loss within 1e-3 relative; prints each rank's step time and
    the gradient reduce's share of it (the one process runs beside it).
    (b) the same world with total_steps 5, rank 1 SIGTERMed after step
    2: both ranks stop at the
    same step with exit 75; one process resumes that world-2 checkpoint
    at world 1 (Preserve: the same global batch) to step 5, held like
    (a) against the straight steps, and so is the control's checkpoint
    resumed the same way, which must miss. Returns the launches."""
    import concurrent.futures as cf

    launches = {}
    # three waves, each sharing the card (no check holds their times):
    # one process with (a)'s world, (a)'s control with (b)'s stopped
    # world, (b)'s two resumes
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        straight = pool.submit(
            _launch_world, world_config(root, "straight", 1,
                                        WORLD_RESUME_STEPS,
                                        checkpoint_every=WORLD_STEPS),
            root, "straight", 1, dump_steps=(WORLD_STEPS, WORLD_RESUME_STEPS))
        two = pool.submit(_launch_world,
                          world_config(root, "two", 2, WORLD_STEPS), root,
                          "two", 2, dump_steps=(WORLD_STEPS,))
        straight, two = straight.result()[0], two.result()
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        control = pool.submit(
            _launch_world, world_config(root, "control", 2, WORLD_STEPS),
            root, "control", 2, dump_steps=(WORLD_STEPS,),
            fault="no-reduce")
        stop = pool.submit(
            _launch_world, world_config(root, "gang", 2, WORLD_RESUME_STEPS),
            root, "gang", 2, sigterm_after=WORLD_SIGTERM_AFTER)
        control, stop = control.result(), stop.result()
    _ok([straight, *two, *control], "(a)")
    if "trainer mesh: Mesh(data=2) on 2x " not in two[0]["out"]:
        fail("world (a): rank 0 did not build the data=2 mesh")
    losses = [[ln.split("loss=")[1].split()[0] for ln in r["out"].splitlines()
               if " loss=" in ln] for r in two]
    if losses[0] != losses[1] or len(losses[0]) < WORLD_STEPS - 1:
        fail(f"world (a): rank losses differ {losses}")
    for r, run in enumerate(two):
        launches[f"world_rank{r}"] = _world_launches(run, WORLD_STEPS,
                                                     f"(a) rank {r}")
    _world_launches(straight, WORLD_RESUME_STEPS, "one process")
    one = root / f"straight.rank0.{WORLD_STEPS}.pt"
    held = [_hold_delta(f"world (a) rank {r}",
                        root / f"two.rank{r}.{WORLD_STEPS}.pt", one,
                        root / f"control.rank0.{WORLD_STEPS}.pt")
            for r in range(2)]
    worst = _hold_params("world (a) params", _final_params(root, "two"),
                         _final_params(root, "straight", WORLD_STEPS),
                         WORLD_ROW_TOL)
    lo = two[0]["summary"]["final"]["loss"]
    lw = float(re.search(rf"\bstep {WORLD_STEPS} loss=(\S+)",
                         straight["out"]).group(1))
    if not abs(lo - lw) <= WORLD_LOSS_RTOL * abs(lw):
        fail(f"world (a): final loss {lo} vs one process {lw}")
    shares = []
    for r, run in enumerate(two):
        step, red = _reduce_share(run)
        shares.append(f"rank {r}: step {step * 1e3:.1f} ms, gradient reduce "
                      f"{red * 1e3:.1f} ms ({100 * red / step:.1f}%)")
    print(f"world (a) data 2 over gloo on one card (the yaml's fsdp 4 x "
          f"model 2 needs 8 GPUs): losses {losses[0]}; final loss {lo:.6f} "
          f"vs one process {lw:.4f}; rank 0 {held[0]}; rank 1 {held[1]}; "
          f"params max row err {worst:.3g}; step times (the one process "
          f"and the two ranks sharing the card and the host with each "
          f"other and phases 34 and 36, not held): one process "
          f"{straight['summary']['step_time_s'] * 1e3:.1f} ms; "
          + "; ".join(shares), flush=True)
    shutil.rmtree(root / "two_ckpt", ignore_errors=True)

    _ok(stop, "(b)", rc=75)
    steps = []
    for r, run in enumerate(stop):
        m = [ln for ln in run["out"].splitlines() if "preempted at step" in ln]
        if not run["summary"].get("preempted") or not m:
            print(run["out"][-6000:], flush=True)
            fail(f"world (b) rank {r}: not preempted")
        steps.append(int(m[-1].split("preempted at step ")[1].split(":")[0]))
    if steps[0] != steps[1]:
        fail(f"world (b): ranks stopped at steps {steps}")
    # one process resumes the world's checkpoint, and the control's
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        res = pool.submit(
            _launch_world, world_config(root, "gang", 1, WORLD_RESUME_STEPS),
            root, "resume", 1, dump_steps=(WORLD_RESUME_STEPS,))
        res_control = pool.submit(
            _launch_world,
            world_config(root, "control", 1, WORLD_RESUME_STEPS), root,
            "resume_control", 1, dump_steps=(WORLD_RESUME_STEPS,))
        res, res_control = res.result()[0], res_control.result()[0]
    _ok([res, res_control], "(b) resume")
    for name, run, at in (("resume", res, steps[0]),
                          ("control resume", res_control, WORLD_STEPS)):
        if run["summary"]["start_step"] != at:
            fail(f"world (b) {name}: resumed at "
                 f"{run['summary']['start_step']}, saved at {at}")
    held = _hold_delta("world (b) resume",
                       root / f"resume.rank0.{WORLD_RESUME_STEPS}.pt",
                       root / f"straight.rank0.{WORLD_RESUME_STEPS}.pt",
                       root / f"resume_control.rank0.{WORLD_RESUME_STEPS}.pt")
    worst = _hold_params("world (b) params", _final_params(root, "gang"),
                         _final_params(root, "straight"), WORLD_ROW_TOL)
    lo = res["summary"]["final"]["loss"]
    lw = straight["summary"]["final"]["loss"]
    if not abs(lo - lw) <= WORLD_LOSS_RTOL * abs(lw):
        fail(f"world (b): final loss {lo} vs straight {lw}")
    print(f"world (b): SIGTERM to rank 1 after step {WORLD_SIGTERM_AFTER}: "
          f"both ranks exit 75 at step {steps[0]}; world-2 checkpoint "
          f"resumed at world 1 to step {WORLD_RESUME_STEPS}: final loss "
          f"{lo:.6f} vs straight {lw:.6f}, {held}; params max row err "
          f"{worst:.3g}", flush=True)
    return launches


def nccl_phase() -> None:
    """Phase 22, NCCL at one rank: a one-rank NCCL world formed through
    the port's hierarchical backend (`gpu`), its mesh (a DeviceMesh on
    cuda), then an all-reduce on the world and a reduce-scatter /
    all-gather round trip on the mesh's data group, on card tensors,
    held exactly. Multi-rank NCCL, FSDP and tensor parallelism need
    more than the one GPU this machine has; they are held on the CPU
    (tests/test_torch_spmd.py)."""
    import socket

    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import backends as B
    from kubeflow_tpu_torch.parallel import dist as D

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = B.get_backend(B.BACKEND_GPU)
    gpu.form_group(D.DistConfig(f"127.0.0.1:{port}", 1, 0), dev)
    try:
        if dist.get_backend() != "nccl":
            fail(f"nccl phase: the group's backend is {dist.get_backend()}")
        mesh = gpu.mesh({"data": -1}, "cuda")
        if mesh.device_mesh is None or mesh.device_mesh.device_type != "cuda":
            fail("nccl phase: no DeviceMesh on cuda")
        x = torch.arange(4096.0, device=dev).reshape(64, 64)
        y = x.clone()
        dist.all_reduce(y)
        g = mesh.device_mesh.get_group("data")
        part = torch.empty_like(x)
        dist.reduce_scatter_tensor(part, x, group=g)
        back = torch.empty_like(x)
        dist.all_gather_into_tensor(back, part, group=g)
        red = gpu.hierarchical_reduce([x.clone()], mesh=mesh)[0]
        torch.cuda.synchronize()
        for name, t in (("all_reduce", y), ("reduce_scatter/all_gather", back),
                        ("hierarchical_reduce", red)):
            if not torch.equal(t, x):
                fail(f"nccl phase: {name} differs from its input")
        print(f"nccl: one rank, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"
              ", all_reduce, reduce_scatter/all_gather and the gpu backend's "
              "hierarchical_reduce exact on card tensors; multi-rank NCCL, "
              "FSDP and tensor parallelism are held on the CPU only (one GPU "
              "here)", flush=True)
    finally:
        gpu.leave()


# -- phases 23-28: mixture-of-experts, sequence and pipeline parallelism -----

# the reference's first MoE point (BASELINE.md: gpt-moe-8e at batch 4,
# dots remat, sparse dispatch), with the port's main-path optimizer and
# xent chunks; 2 warm-up steps, then 5 timed
MOE_MODEL, MOE_LAYERS, MOE_BATCH = "gpt-moe-8e", 24, 4
MOE_WARMUP, MOE_STEPS = 2, 5
MOE_TRAIN = {
    "model": MOE_MODEL, "task": "lm",
    "model_kwargs": {"attention_impl": "auto"},
    "global_batch": MOE_BATCH, "seq_len": L, "vocab_size": 32000,
    "optimizer": "adafactor", "learning_rate": 3e-4, "weight_decay": 1e-4,
    "warmup_steps": 5, "total_steps": MOE_WARMUP + MOE_STEPS, "remat": True,
    "remat_policy": "dots", "xent_chunks": 8, "seed": 0, "log_every": 1,
}
# phase 24: one block at gpt-moe-8e's width; sparse vs dense at capacity
# factor 4 (no token drops), bf16, per row
MOE_BLOCK_B, MOE_BLOCK_CF = 2, 4.0
MOE_BLOCK_TOL = 1e-2
# phase 26: the served MoE
MOE_SERVE_P, MOE_SERVE_N, MOE_SERVE_SLOTS, MOE_SERVE_REQUESTS = 64, 32, 4, 4
# phase 27: llama-1b cut to 4 layers and batch 2 (the plain attention of
# `reference` and of ring at one rank holds [2, 32, 2048, 2048] f32 scores
# per layer), 3 steps per attention_impl
LONGCTX_LAYERS, LONGCTX_BATCH, LONGCTX_STEPS = 4, 2, 3
LONGCTX_SAME_RTOL = 1e-3     # same attention code: phase 15's loss limit
LONGCTX_PAIR_RTOL = 2e-2     # flash vs reference: phase 4's row limit


def _flash_per_step(layers: int, policy: str | None) -> dict:
    """Flash launches a training step makes: one forward per layer (two
    under `full`, which replays it) and one of each backward kernel."""
    return _launch_counts(layers * (2 if policy == "full" else 1), layers,
                          layers)


def moe_train_phase(fa, _build) -> dict:
    """Phase 23: gpt-moe-8e through the port launcher at the reference's
    MoE point (batch 4, seq 2048, dots remat, adafactor, flash attention,
    synthetic tokens): the sparse dispatch (moe_sparse_dispatch 1.0), a
    finite loss, and the flash launches per step that the layer count and
    the policy give; then `python -m kubeflow_tpu_torch.bench`'s run_lm at
    the same point, 2 warm-up and 5 timed steps: ms per step, tokens/s,
    MFU over active parameters, peak memory and the moe_* keys."""
    import torch

    from kubeflow_tpu_torch import bench

    steps = MOE_WARMUP + MOE_STEPS
    summary, launches, wall = launch_in_process(fa, _build, MOE_TRAIN,
                                                "moe_train")
    final = summary["final"]
    want = {k: v * steps for k, v in
            _flash_per_step(MOE_LAYERS, MOE_TRAIN["remat_policy"]).items()}
    if launches != want:
        fail(f"gpt-moe-8e: launches {launches} in {steps} steps, want {want}")
    if final.get("moe_sparse_dispatch") != 1.0:
        fail(f"gpt-moe-8e: moe_sparse_dispatch {final.get('moe_sparse_dispatch')}"
             ", want 1.0: the trainer's one-rank mesh takes the sparse path")
    gc.collect()
    torch.cuda.empty_cache()
    args = bench.parse_args([
        "--lm-model", MOE_MODEL, "--lm-batch", str(MOE_BATCH),
        "--seq-len", str(L), "--lm-remat-policy", "dots",
        "--lm-attention", "auto", "--lm-xent-chunks", "8",
        "--warmup", str(MOE_WARMUP), "--steps", str(MOE_STEPS)])
    line = bench.run_lm(args)
    if line.get("moe_sparse_dispatch") != 1.0:
        fail(f"gpt-moe-8e bench: {line}")
    print(f"gpt-moe-8e train (launcher, {steps} steps in {wall:.1f}s): final "
          f"loss {final['loss']:.4f}, moe_fill {final['moe_fill']:.4f}, "
          f"moe_drop {final['moe_drop']:.4f}, moe_sparse_dispatch "
          f"{final['moe_sparse_dispatch']}, launches {launches}", flush=True)
    print("gpt-moe-8e bench: " + json.dumps(line), flush=True)
    return launches


def moe_block_phase() -> None:
    """Phase 24: one MoE block at gpt-moe-8e's width (d 1024, d_ff 4096,
    8 experts, top-2), batch 2, seq 2048, bf16, capacity factor 4 (no
    token drops): the sparse dispatch's output and its gradients (of x
    and of the three expert weights) against the dense one-hot oracle's,
    per row within MOE_BLOCK_TOL; a planted control, the sparse path with
    one routed token's gate zeroed, must exceed it. Then the default
    capacity factor 1.25 on a fresh random batch: fill and drop of both
    paths, printed."""
    import torch

    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.ops import kernel_check, moe

    cfg = TransformerConfig(d_model=1024, d_ff=4096, n_experts=8,
                            expert_top_k=2, moe_every=2)
    gen = torch.Generator(device="cuda").manual_seed(11)
    block = moe.MoEBlock(cfg, "cuda")
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    d, k = cfg.d_model, cfg.expert_top_k

    def batch():
        return torch.randn(MOE_BLOCK_B, L, d, device="cuda", generator=gen,
                           dtype=torch.bfloat16)

    x = batch()
    ct = torch.randn(x.shape, device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    with torch.no_grad():
        _, gates, idx = moe.router(x, block.router.weight, k)
    weights = (block.w_gate, block.w_up, block.w_down)

    def run(sparse: bool, g, cf=MOE_BLOCK_CF, xx=x):
        xi = xx.detach().requires_grad_(True)
        for w in weights:
            w.grad = None
        if sparse:
            y, kept, routed, slots = moe.sparse_dispatch_mlp(
                xi.reshape(-1, d), g.reshape(-1, k), idx.reshape(-1, k),
                *weights, cf, torch.bfloat16)
            y = y.reshape(xi.shape)
        else:
            y, kept, routed, slots = moe.dense_dispatch_mlp(
                xi, g, idx, *weights, cf, torch.bfloat16)
        (y.float() * ct.float()).sum().backward()
        return ({"y": y.detach(), "dx": xi.grad,
                 **{n: w.grad.clone() for n, w in
                    zip(("dw_gate", "dw_up", "dw_down"), weights)}},
                float(kept), float(routed), float(slots))

    dense, kd, rd, _ = run(False, gates)
    sparse, ks, rs, _ = run(True, gates)
    if not kd == rd == ks == rs:
        fail(f"moe block: tokens dropped at capacity factor {MOE_BLOCK_CF}: "
             f"dense {kd}/{rd}, sparse {ks}/{rs}")
    errs = {}
    for name, want in dense.items():
        row = want.shape[-1]
        errs[name] = check_rows(f"moe block sparse vs dense {name}",
                                sparse[name].reshape(-1, row),
                                want.reshape(-1, row),
                                MOE_BLOCK_TOL)["max_row_err"]
    planted = gates.clone()
    planted[0, 0, 0] = 0.0
    control, *_ = run(True, planted)
    ctl = kernel_check.errors(control["y"].reshape(-1, d),
                              dense["y"].reshape(-1, d))["max_row_err"]
    if not ctl > MOE_BLOCK_TOL:
        fail(f"moe block: the planted control (one gate zeroed) reads "
             f"{ctl:.4g}, within the limit {MOE_BLOCK_TOL}")
    x2 = batch()
    with torch.no_grad():
        _, gates, idx = moe.router(x2, block.router.weight, k)
    fills = {}
    for tag, sp in (("dense", False), ("sparse", True)):
        _, kept, routed, slots = run(sp, gates, cf=cfg.moe_capacity_factor,
                                     xx=x2)
        fills[tag] = (kept / slots, 1.0 - kept / routed)
    print("moe block (d 1024, d_ff 4096, 8 experts top-2, batch 2, seq "
          f"2048, bf16, capacity factor {MOE_BLOCK_CF}): sparse vs dense max "
          "row err " + ", ".join(f"{n} {e:.4g}" for n, e in errs.items())
          + f" (limit {MOE_BLOCK_TOL}); planted control {ctl:.4g}; at "
          f"capacity factor {cfg.moe_capacity_factor}: "
          + ", ".join(f"{t} fill {f:.4f} drop {dr:.4f}"
                      for t, (f, dr) in fills.items()), flush=True)


def moe_card_vs_cpu_phase() -> None:
    """Phase 25: gpt-moe-8e at 2 layers (layer 1 an MoE block), f32, TF32
    off, batch 2, seq 256, the same weights on the card and on the CPU,
    both through the Trainer (the sparse path): the loss before and after
    one sgdm step within CPU_REL_TOL relative and every parameter after
    it within 1e-2 per row, the limits phase 18 holds ResNet-50 to."""
    import torch

    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    cfg = TrainConfig.from_dict({
        "model": MOE_MODEL, "task": "lm", "global_batch": 2, "seq_len": 256,
        "vocab_size": 32000, "optimizer": "sgdm", "learning_rate": 0.1,
        "warmup_steps": 0, "total_steps": 10,
        "model_kwargs": {"dtype": "float32", "n_layers": 2,
                         "attention_impl": "reference"}})
    cpu = Trainer(cfg, device="cpu")
    init = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    host = next(cpu.data_iter())
    runs = {}
    for tag, dev in (("cpu", "cpu"), ("card", "cuda")):
        t = cpu if dev == "cpu" else Trainer(cfg, device=dev)
        t.model.load_state_dict(init)
        batch = t._to_device(host)
        m1 = t.train_step(batch)
        m2 = t.train_step(batch)
        runs[tag] = {"losses": [float(m1["loss"]), float(m2["loss"])],
                     "sparse": float(m1["moe_sparse_dispatch"]),
                     "params": {n: p.detach().cpu() for n, p in
                                t.model.named_parameters()}}
        del t
    want, got = runs["cpu"], runs["card"]
    if got["sparse"] != 1.0 or want["sparse"] != 1.0:
        fail(f"moe card vs cpu: dispatch {got['sparse']} / {want['sparse']}")
    for a, b in zip(got["losses"], want["losses"]):
        if not abs(a - b) <= CPU_REL_TOL * abs(b):
            fail(f"moe card vs cpu: losses {got['losses']} vs {want['losses']}")

    def rows(t):
        return t.reshape(-1, t.shape[-1]) if t.ndim > 1 else t[None]

    worst = max(check_rows(f"moe card vs cpu {n}", rows(got["params"][n]),
                           rows(p), 1e-2)["max_row_err"]
                for n, p in want["params"].items())
    print(f"moe card vs cpu (gpt-moe-8e, 2 layers, f32, batch 2, seq 256): "
          f"losses card {got['losses']} cpu {want['losses']}, params after "
          f"two sgdm steps max row err {worst:.3g}", flush=True)


def moe_serving_phase() -> None:
    """Phase 26: gpt-moe-8e at full depth served through the port's
    serve_lm_generator, the LM generator (a 50 ms batching window, so the
    4 concurrent requests make one batch) and the continuous slot decoder
    (4 slots), in f32 with TF32 off: a warm-up, then 4 greedy requests
    of 32 new tokens at concurrency 4 each; tokens/s printed. Neither
    path has a mesh, so both take the reference's meshless dense
    dispatch, and their tokens must be equal."""
    import concurrent.futures as cf

    import torch

    from kubeflow_tpu_torch.serving.server import serve_lm_generator

    rng = random.Random(5)
    prompts = [[rng.randrange(1, 32000) for _ in range(rng.randint(8, 64))]
               for _ in range(MOE_SERVE_REQUESTS)]
    toks, rates = {}, {}
    for tag, cont in (("generator", False), ("slot decoder", True)):
        served = serve_lm_generator(
            "moe", MOE_MODEL, prompt_len=MOE_SERVE_P,
            max_new_tokens=MOE_SERVE_N, device="cuda", param_dtype="float32",
            dtype="float32", continuous_batching=cont,
            decode_slots=MOE_SERVE_SLOTS, max_batch=MOE_SERVE_SLOTS,
            batch_window_ms=0.0 if cont else 50.0)
        try:
            served.predict([{"tokens": prompts[0]}])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=MOE_SERVE_SLOTS) as pool:
                toks[tag] = list(pool.map(
                    lambda pr: [int(t) for t in
                                served.predict([{"tokens": pr}])[0]],
                    prompts))
            dt = time.perf_counter() - t0
        finally:
            served.close()
        rates[tag] = sum(map(len, toks[tag])) / dt
        gc.collect()
        torch.cuda.empty_cache()
    if any(len(t) != MOE_SERVE_N for t in toks["generator"]):
        fail("moe serving: a response without 32 ids")
    if toks["generator"] != toks["slot decoder"]:
        same = sum(a == b for ra, rb in zip(toks["generator"],
                                            toks["slot decoder"])
                   for a, b in zip(ra, rb))
        fail(f"moe serving: the two paths differ in f32 ({same} of "
             f"{MOE_SERVE_REQUESTS * MOE_SERVE_N} tokens equal)")
    print(f"moe serving (gpt-moe-8e, 24 layers, f32, {MOE_SERVE_REQUESTS} "
          f"requests of {MOE_SERVE_N} new tokens at concurrency "
          f"{MOE_SERVE_SLOTS}, dense dispatch): generator "
          f"{rates['generator']:.1f} tokens/s, slot decoder "
          f"{rates['slot decoder']:.1f} tokens/s; tokens equal", flush=True)


def longctx_phase(fa, _build) -> dict:
    """Phase 27: llama-1b cut to LONGCTX_LAYERS layers, batch
    LONGCTX_BATCH, seq 2048, through the port launcher at one rank with
    attention_impl flash, ulysses, reference and ring, LONGCTX_STEPS steps
    each (adafactor, slim remat). Ulysses at one rank is the local
    dispatch: it must launch the flash kernels exactly as flash does;
    ring at one rank is the plain attention: it must launch none, as
    reference. The final losses: ulysses against flash and ring against
    reference within LONGCTX_SAME_RTOL, flash against reference within
    LONGCTX_PAIR_RTOL. Returns the launches of ulysses and ring."""
    out, launches = {}, {}
    for impl in ("flash", "ulysses", "reference", "ring"):
        cfg = {**MAIN_PATH, "global_batch": LONGCTX_BATCH,
               "total_steps": LONGCTX_STEPS,
               "model_kwargs": {"attention_impl": impl,
                                "n_layers": LONGCTX_LAYERS}}
        summary, launches[impl], _ = launch_in_process(
            fa, _build, cfg, f"longctx_{impl}")
        out[impl] = summary
    flash = {k: v * LONGCTX_STEPS for k, v in
             _flash_per_step(LONGCTX_LAYERS, "slim").items()}
    none = {k: 0 for k in flash}
    for impl, want in (("flash", flash), ("ulysses", flash),
                       ("reference", none), ("ring", none)):
        if launches[impl] != want:
            fail(f"longctx {impl}: launches {launches[impl]}, want {want}")
    loss = {k: v["final"]["loss"] for k, v in out.items()}
    for a, b, tol in (("ulysses", "flash", LONGCTX_SAME_RTOL),
                      ("ring", "reference", LONGCTX_SAME_RTOL),
                      ("flash", "reference", LONGCTX_PAIR_RTOL)):
        if not abs(loss[a] - loss[b]) <= tol * abs(loss[b]):
            fail(f"longctx: {a} loss {loss[a]} vs {b} {loss[b]} (limit "
                 f"{tol} relative)")
    print(f"longctx (llama-1b, {LONGCTX_LAYERS} layers, batch "
          f"{LONGCTX_BATCH}, seq {L}, {LONGCTX_STEPS} steps): final losses "
          + ", ".join(f"{k} {v:.6f}" for k, v in loss.items())
          + "; step ms " + ", ".join(
              f"{k} {v['step_time_s'] * 1e3:.1f}" for k, v in out.items())
          + f"; launches ulysses {launches['ulysses']}, ring "
          f"{launches['ring']}", flush=True)
    return {"ulysses": launches["ulysses"], "ring": launches["ring"]}


GLOO_MODES = ("all_to_all", "all_gather", "broadcast", "send_recv")


def gloo_probe_worker(argv: list[str]) -> int:
    """`chip_smoke.py --gloo-probe MODE RANK PORT`: one of two ranks that
    share the card in a gloo world (the loopback backend's transport)
    tries MODE (`all_to_all`, `all_gather`, `broadcast` or `send_recv`)
    on CUDA tensors and prints
    one JSON line: "ok", "wrong" or the error. Nothing is staged through
    the host."""
    import torch
    import torch.distributed as dist

    mode, rank, port = argv[0], int(argv[1]), int(argv[2])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    x = torch.arange(8.0, device="cuda") + 100 * rank
    try:
        if mode == "all_to_all":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            want = torch.cat([torch.arange(4.0) + 4 * rank,
                              torch.arange(4.0) + 4 * rank + 100]).cuda()
        elif mode == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            out = torch.cat(parts)
            want = torch.cat([torch.arange(8.0),
                              torch.arange(8.0) + 100]).cuda()
        elif mode == "broadcast":
            out = x.clone()
            dist.broadcast(out, 0)
            want = torch.arange(8.0, device="cuda")
        else:
            out = torch.empty_like(x)
            if rank == 0:
                dist.send(x, 1)
                dist.recv(out, 1)
            else:
                dist.recv(out, 0)
                dist.send(x, 0)
            want = torch.arange(8.0, device="cuda") + 100 * (1 - rank)
        torch.cuda.synchronize()
        res = "ok" if torch.equal(out, want) else f"wrong: {out.tolist()}"
    except Exception as e:          # the probe reports what gloo says
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    print(json.dumps({"mode": mode, "rank": rank, "result": res}),
          flush=True)
    return 0


def gloo_probe_phase() -> dict:
    """Phase 28: can two ranks sharing the card over gloo (the loopback
    backend) all_to_all, all_gather, broadcast and send/recv CUDA
    tensors? A pair of `--gloo-probe` processes per mode, each with its
    own port;
    prints each rank's answer (a crash or a hang past 120 s counts as a
    no). The answer decides where expert, seq and pipe above 1 can run,
    and whether the serving mesh's all_gather needs the loopback
    backend's host staging: this phase records it; it fails only if a
    probe cannot start."""
    procs = []
    for mode in GLOO_MODES:
        port = _free_port_pair()
        for rank in (0, 1):
            procs.append((mode, rank, subprocess.Popen(
                [sys.executable, __file__, "--gloo-probe", mode, str(rank),
                 str(port)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    answers = {}
    for mode, rank, p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n(timed out)"
        line = next((json.loads(s) for s in out.splitlines()
                     if s.startswith('{"mode"')), None)
        answers[f"{mode} rank {rank}"] = (
            line["result"] if line else
            f"exit {p.returncode}: {out.strip().splitlines()[-1:]}")
    works = {m: all(v == "ok" for k, v in answers.items() if k.startswith(m))
             for m in GLOO_MODES}
    print("gloo on CUDA tensors, two ranks sharing the card: " + json.dumps(
        answers), flush=True)
    print("gloo probe verdict: " + json.dumps(works), flush=True)
    return works


# phase 29: expert 2 on the card over gloo (phase 28 found that gloo's
# all_to_all takes CUDA tensors): gpt-moe-8e cut to 4 layers (2 MoE
# layers), seq 1024, global batch 8, capacity factor 4 (no drops), adamw,
# f32 with TF32 off and the plain attention: in bf16 the dense path's
# gates are rounded (its combine is a bf16 einsum) and adamw's sign-like
# first steps blow that rounding up, so the hold would measure bf16, not
# the exchange
EP_STEPS = 3
EP_DELTA_TOL = 1e-2          # per row, the parameter change (kernel_check's)


def _ep_config(impl: str, mesh: dict | None) -> dict:
    return {"model": MOE_MODEL, "task": "lm",
            "model_kwargs": {"n_layers": 4, "moe_impl": impl,
                             "moe_capacity_factor": 4.0, "dtype": "float32",
                             "attention_impl": "reference"},
            "global_batch": 8, "seq_len": 1024, "vocab_size": 32000,
            "optimizer": "adamw", "learning_rate": 3e-4,
            "warmup_steps": 1, "total_steps": EP_STEPS, "seed": 0,
            "log_every": 1, **({"mesh": mesh} if mesh else {})}


def _startup_note(runs: dict) -> str:
    """Rank 0's start-up breakdown (`_startup`) of each world."""
    return "; ".join(f"{tag}: " + ", ".join(
        f"{k} {v:.1f}" for k, v in ws[0]["startup"].items())
        for tag, ws in runs.items())


def expert_world_phase(root) -> dict:
    """Phase 29: two port launchers share the card over gloo with mesh
    data 1 x expert 2 (each holds 4 of the 8 experts; the sparse
    dispatch's all-to-all crosses the ranks) for 3 steps, against one
    process on the dense one-hot oracle: both ranks print the same
    losses and moe_sparse_dispatch 1.0 (the one process 0.0), each rank's
    parameter change (its slice of the experts against the same slice)
    equals one process's per row within EP_DELTA_TOL, and a planted
    control, the same world with the all-to-all returning its input (the
    reference's dropped all_to_all), misses it; the final loss within
    1e-3 relative. f32 with the plain attention: no flash launch. Returns
    the flash launches of each rank. The three worlds, whose step times
    are printed but not held, share the card at once (as phase 30's), and
    phase 28's gloo probe runs beside them."""
    import concurrent.futures as cf

    ep = {"data": 1, "expert": 2}
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        probe = pool.submit(gloo_probe_phase)
        worlds = {tag: pool.submit(_launch_world, cfg, root, tag, world,
                                   dump_steps=(EP_STEPS,), fault=fault)
                  for tag, cfg, world, fault in (
                      ("ep_one", _ep_config("dense", None), 1, "none"),
                      ("ep_two", _ep_config("sparse", ep), 2, "none"),
                      ("ep_control", _ep_config("sparse", ep), 2,
                       "no-exchange"))}
        worlds = {tag: f.result() for tag, f in worlds.items()}
        probe.result()
    one, two, control = (worlds[t] for t in ("ep_one", "ep_two",
                                             "ep_control"))
    one = one[0]
    print(f"expert 2 start-up (s): {_startup_note(worlds)}", flush=True)
    _ok([one, *two, *control], "expert 2")
    want = {k: 0 for k in _flash_per_step(4, None)}
    for r, run in enumerate([one, *two]):
        if run["launches"] != want:
            fail(f"expert 2 run {r}: launches {run['launches']}, want {want}")
    losses = [[ln.split("loss=")[1].split()[0] for ln in r["out"].splitlines()
               if " loss=" in ln] for r in two]
    if losses[0] != losses[1] or len(losses[0]) < EP_STEPS - 1:
        fail(f"expert 2: rank losses differ {losses}")
    dispatch = [r["summary"]["final"].get("moe_sparse_dispatch")
                for r in (one, *two)]
    if dispatch != [0.0, 1.0, 1.0]:
        fail(f"expert 2: moe_sparse_dispatch {dispatch}, want dense on one "
             "process and sparse on the ranks")
    held = [_hold_delta(f"expert 2 rank {r}",
                        root / f"ep_two.rank{r}.{EP_STEPS}.pt",
                        root / f"ep_one.rank0.{EP_STEPS}.pt",
                        root / f"ep_control.rank{r}.{EP_STEPS}.pt", rank=r,
                        tol=EP_DELTA_TOL)
            for r in range(2)]
    lo, lw = (two[0]["summary"]["final"]["loss"],
              one["summary"]["final"]["loss"])
    if not abs(lo - lw) <= WORLD_LOSS_RTOL * abs(lw):
        fail(f"expert 2: final loss {lo} vs one process {lw}")
    print(f"expert 2 over gloo on one card (gpt-moe-8e, 4 layers, seq 1024, "
          f"batch 8, capacity factor 4): losses {losses[0]}; final loss "
          f"{lo:.6f} vs one process (dense) {lw:.6f}; rank 0 {held[0]}; "
          f"rank 1 {held[1]}; step ms (the three worlds sharing the card at "
          f"once) one process {one['summary']['step_time_s'] * 1e3:.1f}, "
          "ranks "
          + ", ".join(f"{r['summary']['step_time_s'] * 1e3:.1f}" for r in two),
          flush=True)
    return {f"expert_rank{r}": run["launches"] for r, run in enumerate(two)}


# phase 30: the LM over a serving mesh on one card. llama-1b at full width
# and depth, f32 with TF32 off (tokens held equal), then bf16 (the share
# of equal tokens printed); two ranks of the CLI share the card over gloo
MESH_LM = "llama-1b"
MESH_P, MESH_N, MESH_SLOTS, MESH_REQUESTS = 128, 8, 4, 8
# the f32 worlds (the held one and its control) and their one process
# serve llama-1b cut to 4 of its 16 layers (the script's time); bf16
# keeps the full depth. A meshed tick is gloo's all-gathers of the
# vocab-sharded embedding and head, which the depth does not change: the
# decode's time follows MESH_N
MESH_F32_LAYERS = 4


def _mesh_prompts() -> list[list[int]]:
    rng = random.Random(30)
    return [[rng.randrange(1, 32000) for _ in range(k)]
            for k in (MESH_P, 97, 12, 128, 64, 33, 120, 5)[:MESH_REQUESTS]]


def mesh_worker(argv: list[str]) -> int:
    """`chip_smoke.py --mesh-worker LAYERS CLI...`: the serving CLI
    (`python -m kubeflow_tpu_torch.serving CLI...`) in this process,
    with MESH_LM cut to LAYERS layers."""
    from kubeflow_tpu_torch.models import transformer as TM
    from kubeflow_tpu_torch.serving.server import main as serve

    TM.CONFIGS[MESH_LM]["n_layers"] = int(argv[0])
    return serve(argv[1:])


def _start_mesh(root, tag: str, cli: list[str], seeds=(0, 0),
                layers: int | None = None) -> dict:
    """Two ranks of `python -m kubeflow_tpu_torch.serving --mesh model=2
    CLI...` sharing the card over gloo (the loopback backend), rank r
    with seed seeds[r], MESH_LM cut to `layers` layers when given
    (`mesh_worker`); returns their processes, logs and rank 0's URL once
    it answers /readyz."""
    import os
    import socket
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        http = sock.getsockname()[1]
    port = _free_port_pair()
    procs, logs = [], []
    for rank in (0, 1):
        logs.append(root / f"{tag}.rank{rank}.log")
        env = {**os.environ, "JAXJOB_COORDINATOR_ADDRESS":
               f"127.0.0.1:{port}", "JAXJOB_NUM_PROCESSES": "2",
               "JAXJOB_PROCESS_ID": str(rank),
               "JAXJOB_COLLECTIVES_BACKEND": "loopback",
               "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))}
        entry = (["-m", "kubeflow_tpu_torch.serving"] if layers is None
                 else [str(Path(__file__).resolve()), "--mesh-worker",
                       str(layers)])
        procs.append(subprocess.Popen(
            [sys.executable, *entry, "--mesh", "model=2", *cli, "--port",
             str(http), "--seed", str(seeds[rank])],
            cwd=str(Path(__file__).resolve().parent),
            env=env, stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT))
        _MESH_PROCS.append(procs[-1])
    url = f"http://127.0.0.1:{http}"
    deadline = time.monotonic() + 300
    while True:
        if any(p.poll() is not None for p in procs):
            for log in logs:
                print(log.read_text()[-4000:], flush=True)
            fail(f"mesh {tag}: a rank exited before rank 0 was ready")
        try:
            with urllib.request.urlopen(f"{url}/readyz", timeout=5) as r:
                if r.status == 200:
                    break
        except OSError:
            pass
        if time.monotonic() > deadline:
            fail(f"mesh {tag}: rank 0 not ready after 300 s")
        time.sleep(0.5)
    return {"procs": procs, "logs": logs, "url": url, "tag": tag}


def _stop_mesh(run: dict) -> list[dict]:
    """SIGTERM rank 0 (an orderly stop: it tells rank 1); both must exit
    0. Returns each rank's serving line (device memory, the flash
    launches while serving)."""
    import signal

    run["procs"][0].send_signal(signal.SIGTERM)
    rcs = []
    for p in run["procs"]:
        try:
            rcs.append(p.wait(timeout=120))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    mem = []
    for rank, log in enumerate(run["logs"]):
        out = log.read_text()
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"serving_rank"')]
        if rcs[rank] != 0 or not lines:
            print(out[-6000:], flush=True)
            fail(f"mesh {run['tag']} rank {rank}: exit {rcs[rank]}")
        mem.append(lines[-1])
    return mem


def _served_launches(tag: str, lines: list[dict]) -> dict:
    """The flash launches both serving ranks counted while serving (each
    resets its counts once its models are registered); fails on any."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    total = dict.fromkeys(fa.LAUNCHES, 0)
    for ln in lines:
        for k, n in ln["launches"].items():
            total[k] += n
    if any(total.values()):
        fail(f"mesh {tag}: the serving ranks launched flash kernels {total}"
             ": decode and the classifiers reach no Pallas kernel")
    return total


def _post_all(url: str, name: str, instances: list) -> tuple[list, float]:
    """Each instance as its own concurrent request; (predictions, wall s)."""
    import concurrent.futures as cf
    import urllib.request

    def one(inst):
        req = urllib.request.Request(
            f"{url}/v1/models/{name}:predict", method="POST",
            data=json.dumps({"instances": [inst]}).encode())
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())["predictions"][0]

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(instances)) as pool:
        out = list(pool.map(one, instances))
    return out, time.perf_counter() - t0


def _metric(url: str, name: str) -> float:
    import urllib.request

    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        text = r.read().decode()
    m = re.search(rf"^{name}\{{[^}}]*\}} (\S+)$", text, re.M)
    if not m:
        fail(f"/metrics has no {name}")
    return float(m.group(1))


def _one_process_lm(dtype: str, prompts: list, layers: int | None = None
                    ) -> tuple[list, float, int]:
    """The same model (cut to `layers` layers when given), seed and
    decoder in this process: (tokens, wall s, peak bytes)."""
    import torch

    from kubeflow_tpu_torch.serving.server import serve_lm_generator

    torch.cuda.reset_peak_memory_stats()
    served = serve_lm_generator(
        "one", MESH_LM, prompt_len=MESH_P, max_new_tokens=MESH_N,
        device="cuda", dtype=dtype, continuous_batching=True,
        decode_slots=MESH_SLOTS, seed=0,
        **({"n_layers": layers} if layers else {}))
    try:
        import concurrent.futures as cf

        served.predict([{"tokens": prompts[0]}])         # warm
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=len(prompts)) as pool:
            out = list(pool.map(lambda p: [int(t) for t in served.predict(
                [{"tokens": p}])[0]], prompts))
        wall = time.perf_counter() - t0
    finally:
        served.close()
    peak = torch.cuda.max_memory_allocated()
    del served
    gc.collect()
    torch.cuda.empty_cache()
    return out, wall, peak


def mesh_serving_phase(root) -> None:
    """Phase 30: llama-1b at full width (d 2048, 32 q / 8 kv heads)
    served over `--mesh model=2` by two ranks of the CLI sharing the
    card over gloo: continuous batching, 4 slots, prompt_len 128,
    MESH_N (8) new tokens, 8 ragged requests over HTTP to rank 0. In f32
    (TF32 off), at MESH_F32_LAYERS (4) of its 16 layers, the tokens must
    equal one process's slot decoder on the same seeded weights and
    depth, and a
    planted control (rank 1 drawing its weights from another seed) must
    differ; prints each rank's device memory (the peak while the weights
    were placed, then while serving), tokens/s of both, rank 0's host ms
    per tick and the share of the tick blocked in collectives. Then bf16
    at full depth: the share of equal tokens, printed, not held. Returns
    the f32 run's flash launches on both ranks while serving (none)."""
    import concurrent.futures as cf

    prompts = _mesh_prompts()
    insts = [{"tokens": p} for p in prompts]
    cli = ["--lm", f"llama={MESH_LM}", "--continuous-batching",
           "--decode-slots", str(MESH_SLOTS), "--prompt-len", str(MESH_P),
           "--max-new-tokens", str(MESH_N)]
    want, one_wall, one_peak = _one_process_lm("float32", prompts,
                                               MESH_F32_LAYERS)
    # the three worlds start at once; the control and the bf16 pair stay
    # idle (a heartbeat a second) while the f32 world is timed
    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        run = pool.submit(_start_mesh, root, "mesh_f32",
                          [*cli, "--dtype", "float32"],
                          layers=MESH_F32_LAYERS)
        control = pool.submit(_start_mesh, root, "mesh_control",
                              [*cli, "--dtype", "float32"], (0, 1),
                              layers=MESH_F32_LAYERS)
        bf16 = pool.submit(_start_mesh, root, "mesh_bf16", cli)
        run, control, bf16 = run.result(), control.result(), bf16.result()
    _post_all(run["url"], "llama", insts[:1])                 # warm
    base = [_metric(run["url"], f"serving_decode_{k}_total")
            for k in ("ticks", "tick_seconds", "collective_host_seconds")]
    got, wall = _post_all(run["url"], "llama", insts)
    ticks, tick_s, coll_s = (
        _metric(run["url"], f"serving_decode_{k}_total") - b
        for k, b in zip(("ticks", "tick_seconds", "collective_host_seconds"),
                        base))
    mem = _stop_mesh(run)
    if got != want:
        same = sum(a == b for r, w in zip(got, want) for a, b in zip(r, w))
        fail(f"mesh serving (f32): {same} of {MESH_REQUESTS * MESH_N} tokens "
             "equal one process's")
    # the control, the bf16 pair and its one process at once: not timed
    with cf.ThreadPoolExecutor(max_workers=3) as pool:
        planted = pool.submit(_post_all, control["url"], "llama", insts)
        got16 = pool.submit(_post_all, bf16["url"], "llama", insts)
        want16 = pool.submit(_one_process_lm, "bfloat16", prompts)
        (planted, _), (got16, _), (want16, _, _) = (
            planted.result(), got16.result(), want16.result())
    _stop_mesh(control)
    _stop_mesh(bf16)
    if planted == want:
        fail("mesh serving: the control (rank 1 on other weights) gave one "
             "process's tokens: the hold cannot fail a wrong mesh")
    same16 = sum(a == b for r, w in zip(got16, want16) for a, b in zip(r, w))
    tokens = MESH_REQUESTS * MESH_N
    gb = [(m["placed_peak_bytes"] / 1e9, m["peak_bytes"] / 1e9) for m in mem]
    print(f"mesh serving: {MESH_LM} f32 at {MESH_F32_LAYERS} of its 16 "
          f"layers over model=2 (two ranks, gloo, one card), {MESH_SLOTS} "
          f"slots, {MESH_REQUESTS} requests x {MESH_N} "
          f"tokens: tokens equal one process (held); control (rank 1 "
          f"seeded 1) {sum(a == b for r, w in zip(planted, want) for a, b in zip(r, w))}"
          f" of {tokens} equal (must differ); peak GB placing / serving: "
          f"rank 0 {gb[0][0]:.2f} / {gb[0][1]:.2f}, rank 1 {gb[1][0]:.2f} / "
          f"{gb[1][1]:.2f}, one process {one_peak / 1e9:.2f}; tokens/s "
          f"mesh {tokens / wall:.1f}, one process {tokens / one_wall:.1f}; "
          f"rank 0 host ms per tick {1e3 * tick_s / max(ticks, 1):.1f} over "
          f"{ticks:.0f} ticks, blocked in collectives "
          f"{100 * coll_s / tick_s:.1f}%; "
          f"bf16 (16 layers) {same16} of {tokens} tokens equal one process "
          f"(not held)",
          flush=True)
    return _served_launches("mesh_f32", mem)


# phase 31: the classifiers on meshes on one card, two ranks over gloo
MESH_VIT_IMAGES = 8
MESH_ROW_TOL = 1e-5          # softmax rows, f32, TF32 off
MESH_CLS_STEPS = 3


def _vit_config(mesh: dict | None) -> dict:
    return {"model": "vit-b16", "task": "classification", "global_batch": 16,
            "image_size": 224, "optimizer": "adamw", "learning_rate": 1e-3,
            "warmup_steps": 1, "total_steps": MESH_CLS_STEPS, "seed": 0,
            "log_every": 1, "model_kwargs": {"dtype": "float32"},
            **({"mesh": mesh} if mesh else {})}


def _resnet_config(root, tag: str, mesh: dict | None) -> dict:
    return {"model": "resnet50", "task": "classification",
            "global_batch": 32, "image_size": 224, "optimizer": "sgdm",
            "learning_rate": 0.1, "warmup_steps": 0, "total_steps": 1,
            "seed": 0, "log_every": 1, "checkpoint_every": 1,
            "checkpoint_dir": str(root / f"{tag}_ckpt"),
            "model_kwargs": {"dtype": "float32"},
            **({"mesh": mesh} if mesh else {})}


def _vit_checkpoint(root) -> str:
    """A port checkpoint of ViT-B/16 (10 classes) from seed 0 with its
    head drawn too (the reference zero-initializes it: every row would be
    uniform)."""
    import torch

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime.checkpoint import Checkpointer

    model = get_model("vit-b16", device="cuda", seed=0, num_classes=10,
                      dtype="float32")
    with torch.no_grad():
        model.head_kernel.normal_(0.0, 0.02, generator=torch.Generator(
            device="cuda").manual_seed(31))
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    directory = str(root / "vit_ckpt")
    ckpt = Checkpointer(directory, keep=0, world_size=1, num_slices=1)
    try:
        ckpt.save(0, {"step": 0, "params": params, "batch_stats": {},
                      "opt_state": {}}, force=True)
    finally:
        ckpt.close()
    del model
    return directory


def mesh_classifier_phase(root) -> None:
    """Phase 31: (a) ViT-B/16 served over `--mesh model=2` by two ranks
    of the CLI from a checkpoint (seeded weights, its head drawn too): 8
    images' softmax rows within MESH_ROW_TOL of one process (f32, TF32
    off); (b) ViT-B/16 trained 3 steps (batch 16, 224 px, f32,
    adamw) at model=2 and at fsdp=2, and ResNet-50 one sgdm step (batch
    32, 224 px, f32) at fsdp=2, each by two port launchers over gloo:
    each rank's parameter change (gathered whole) per row within
    WORLD_DELTA_TOL of one process's, a planted control beyond it (model:
    the ranks' partial outputs never summed; fsdp: no gradient
    reduce-scatter); ResNet-50's BatchNorm statistics after the step
    within CPU_REL_TOL of one process's. No flash launch: returns the
    ViT serving ranks' launches (the training ranks are held apart)."""
    import concurrent.futures as cf

    import numpy as np
    import torch

    from kubeflow_tpu_torch.runtime.checkpoint import restore_variables
    from kubeflow_tpu_torch.serving.server import serve_flax_classifier

    # (b), training: every run at once on the card (the holds, not the
    # times), while (a) serves beside them
    runs = {
        "vit_one": (_vit_config(None), 1, "none"),
        "vit_tp": (_vit_config({"data": 1, "model": 2}), 2, "none"),
        "vit_tp_control": (_vit_config({"data": 1, "model": 2}), 2,
                           "no-tp-sum"),
        "vit_fsdp": (_vit_config({"data": 1, "fsdp": 2}), 2, "none"),
        "vit_fsdp_control": (_vit_config({"data": 1, "fsdp": 2}), 2,
                             "no-fsdp-sync"),
        "rn_one": (_resnet_config(root, "rn_one", None), 1, "none"),
        "rn_fsdp": (_resnet_config(root, "rn_fsdp", {"data": 1, "fsdp": 2}),
                    2, "none"),
        "rn_fsdp_control": (_resnet_config(root, "rn_fsdp_control",
                                           {"data": 1, "fsdp": 2}), 2,
                            "no-fsdp-sync"),
    }
    steps = {k: MESH_CLS_STEPS if k.startswith("vit") else 1 for k in runs}
    pool = cf.ThreadPoolExecutor(max_workers=len(runs))
    futs = {k: pool.submit(_launch_world, cfg, root, k, world,
                           dump_steps=(steps[k],), fault=fault)
            for k, (cfg, world, fault) in runs.items()}
    try:
        t0 = time.perf_counter()
        images = np.random.default_rng(31).standard_normal(
            (MESH_VIT_IMAGES, 224, 224, 3)).astype(np.float32)
        ckpt = _vit_checkpoint(root)
        one = serve_flax_classifier("one", "vit-b16", num_classes=10,
                                    device="cuda", dtype="float32",
                                    checkpoint_dir=ckpt)
        want = np.asarray(one.predict(list(images)))
        del one
        run = _start_mesh(root, "mesh_vit", [
            "--model", f"vit=vit-b16@{ckpt}", "--dtype", "float32"])
        import urllib.request

        req = urllib.request.Request(
            f"{run['url']}/v1/models/vit:predict", method="POST",
            data=json.dumps({"instances": images.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=600) as r:
            got = np.asarray(json.loads(r.read())["predictions"])
        mem = _stop_mesh(run)
        launched = _served_launches("mesh_vit", mem)
        err = float(np.abs(got - want).max())
        if got.shape != want.shape or not err <= MESH_ROW_TOL:
            fail(f"mesh classifier: ViT-B/16 rows {got.shape} differ by "
                 f"{err:.3g} from one process's (limit {MESH_ROW_TOL})")
        serve_s = time.perf_counter() - t0
        out = {k: f.result() for k, f in futs.items()}
    finally:
        pool.shutdown(wait=True)
    for k, rs in out.items():
        _ok(rs, f"mesh classifier {k}")
        for r in rs:
            if r["launches"] and any(r["launches"].values()):
                fail(f"mesh classifier {k}: flash launches {r['launches']}")
    held = {}
    for k, one_k in (("vit_tp", "vit_one"), ("vit_fsdp", "vit_one"),
                     ("rn_fsdp", "rn_one")):
        held[k] = [_hold_delta(
            f"mesh classifier {k} rank {r}",
            root / f"{k}.rank{r}.{steps[k]}.pt",
            root / f"{one_k}.rank0.{steps[k]}.pt",
            root / f"{k}_control.rank{r}.{steps[k]}.pt") for r in range(2)]
    stats = {}
    for k in ("rn_one", "rn_fsdp"):
        v, _ = restore_variables(str(root / f"{k}_ckpt"))
        stats[k] = v["batch_stats"]
    worst = 0.0
    for n, w in stats["rn_one"].items():
        g = stats["rn_fsdp"][n]
        rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    if not worst <= CPU_REL_TOL:
        fail(f"mesh classifier: ResNet-50 batch statistics at fsdp=2 differ "
             f"by {worst:.3g} (relative) from one process's")
    step_ms = {k: 1e3 * out[k][0]["summary"]["step_time_s"]
               for k in ("vit_one", "vit_tp", "vit_fsdp", "rn_one", "rn_fsdp")}
    print(f"mesh classifier: ViT-B/16 served at model=2: {MESH_VIT_IMAGES} "
          f"rows max abs err {err:.3g} vs one process (limit {MESH_ROW_TOL}); "
          f"serving peak GB rank 0 / 1 {mem[0]['peak_bytes'] / 1e9:.2f} / "
          f"{mem[1]['peak_bytes'] / 1e9:.2f}; {serve_s:.1f} s (sharing the "
          "card with the training runs)", flush=True)
    for k, lines in held.items():
        print(f"mesh classifier {k}: rank 0 {lines[0]}; rank 1 {lines[1]}",
              flush=True)
    print(f"mesh classifier: ResNet-50 batch statistics at fsdp=2 max rel "
          f"err {worst:.3g} (limit {CPU_REL_TOL}); step ms (all runs "
          f"sharing the card at once, not comparable to one run alone): "
          + ", ".join(f"{k} {v:.1f}" for k, v in step_ms.items()), flush=True)
    torch.cuda.empty_cache()
    return launched


# phase 32: the seq axis with the local attention impls on one card.
# llama-1b at full width (d 2048, 32 q / 8 kv heads of 64) cut to 4
# layers, seq 2048, global batch 4, adamw; two ranks at seq 2 share the
# card over gloo (its all_gather, all-reduce and all_to_all take CUDA
# tensors). f32 (TF32 off) for the holds, as phase 29: auto then takes
# the SIMT f32 kernels on every rank's q block over the gathered keys
SEQ_MODEL, SEQ_LAYERS, SEQ_BATCH, SEQ_STEPS = "llama-1b", 4, 4, 3
SEQ_DELTA_TOL = 1e-2         # per row, the parameter change (phase 29's)


def _seq_config(impl: str, mesh: dict | None, dtype: str = "float32"
                ) -> dict:
    return {"model": SEQ_MODEL, "task": "lm",
            "model_kwargs": {"n_layers": SEQ_LAYERS, "dtype": dtype,
                             "attention_impl": impl},
            "global_batch": SEQ_BATCH, "seq_len": L, "vocab_size": 32000,
            "optimizer": "adamw", "learning_rate": 3e-4, "warmup_steps": 1,
            "total_steps": SEQ_STEPS, "seed": 0, "log_every": 1,
            **({"mesh": mesh} if mesh else {})}


def _seq_launches(run: dict, tag: str, dtype: str) -> dict:
    """A rank's launches: each kernel that takes `dtype` at head_dim 64
    once per layer a step (no remat), at that instantiation; no other."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa

    n = SEQ_LAYERS * SEQ_STEPS
    family = fa.kernels_for(getattr(torch, dtype), 64)
    want = _launch_counts(n, n, n, family)
    by_inst = {fa.instance_name(k, dtype, 64): n for k in family}
    if run["launches"] != want or run["instances"] != by_inst:
        fail(f"seq {tag}: flash launches {run['launches']}, by "
             f"instantiation {run['instances']}, want {want}, {by_inst}")
    return run["launches"]


def seq_world_phase(root) -> dict:
    """Phase 32: the seq axis with attention_impl auto (the K/V gather,
    ops/seq_attention.py) and the owed Ulysses check, each against one
    process. In f32, in two waves that each share the card at once (their
    step times are not read; nine f32 processes at once would not fit its
    memory): one process, two ranks at seq 2 (each rank's q block over
    the gathered key prefix, through the f32 SIMT kernels) and the
    planted control `no-kv-gather` (each rank attends its own block
    only); then two Ulysses ranks at seq 2 and their control
    `no-ulysses-exchange`, beside the same seq world in bf16. Each
    rank's parameter change after 3 steps per row within SEQ_DELTA_TOL of
    one process's, each control beyond it, the rank losses equal and the
    final loss within 1e-3 relative; each rank launches every SIMT kernel
    once per layer a step. The bf16 world: its step ms (printed, not
    held) and its wgmma kernel launches. Returns each rank's launches."""
    import concurrent.futures as cf

    seq2 = {"data": 1, "seq": 2}
    plan = {"seq_one": (_seq_config("auto", None), 1, "none"),
            "seq_two": (_seq_config("auto", seq2), 2, "none"),
            "seq_control": (_seq_config("auto", seq2), 2, "no-kv-gather"),
            "uly_two": (_seq_config("ulysses", seq2), 2, "none"),
            "uly_control": (_seq_config("ulysses", seq2), 2,
                            "no-ulysses-exchange")}
    runs = {}
    # the bf16 seq world, whose step times no check holds, shares the
    # second wave (it ran alone after both until the user path was added:
    # the script's time)
    plan["seq_bf16"] = (_seq_config("auto", seq2, "bfloat16"), 2, "none")
    for wave in (("seq_one", "seq_two", "seq_control"),
                 ("uly_two", "uly_control", "seq_bf16")):
        with cf.ThreadPoolExecutor(max_workers=len(wave)) as pool:
            futs = {tag: pool.submit(_launch_world, plan[tag][0], root, tag,
                                     plan[tag][1], dump_steps=(
                                         () if tag == "seq_bf16"
                                         else (SEQ_STEPS,)),
                                     fault=plan[tag][2])
                    for tag in wave}
            runs.update({tag: f.result() for tag, f in futs.items()})
    bf16 = runs.pop("seq_bf16")
    _ok([r for ws in runs.values() for r in ws], "seq")
    one = runs["seq_one"][0]
    out = {}
    for tag in ("seq_two", "uly_two"):
        ranks = runs[tag]
        if "trainer mesh: Mesh(seq=2) on 2x " not in ranks[0]["out"]:
            fail(f"seq {tag}: rank 0 did not build the seq=2 mesh")
        losses = [[ln.split("loss=")[1].split()[0]
                   for ln in r["out"].splitlines() if " loss=" in ln]
                  for r in ranks]
        if losses[0] != losses[1] or len(losses[0]) < SEQ_STEPS - 1:
            fail(f"seq {tag}: rank losses differ {losses}")
        control = tag.replace("two", "control")
        held = [_hold_delta(f"seq {tag} rank {r}",
                            root / f"{tag}.rank{r}.{SEQ_STEPS}.pt",
                            root / f"seq_one.rank0.{SEQ_STEPS}.pt",
                            root / f"{control}.rank{r}.{SEQ_STEPS}.pt",
                            tol=SEQ_DELTA_TOL) for r in range(2)]
        lo, lw = ranks[0]["summary"]["final"]["loss"], \
            one["summary"]["final"]["loss"]
        if not abs(lo - lw) <= WORLD_LOSS_RTOL * abs(lw):
            fail(f"seq {tag}: final loss {lo} vs one process {lw}")
        for r, run in enumerate(ranks):
            path = f"{tag.replace('two', 'f32')}_rank{r}"
            out[path] = _seq_launches(run, f"{tag} rank {r}", "float32")
            INSTANCE_COUNTS[path] = run["instances"]
        print(f"seq {tag} (llama-1b, {SEQ_LAYERS} layers, seq {L}, batch "
              f"{SEQ_BATCH}, f32, seq 2 over gloo on one card): losses "
              f"{losses[0]}; final loss {lo:.6f} vs one process {lw:.6f}; "
              f"rank 0 {held[0]}; rank 1 {held[1]}", flush=True)
    _seq_launches(one, "one process", "float32")
    print(f"seq start-up (s), in waves of three worlds each: "
          f"{_startup_note(runs)}", flush=True)
    _ok(bf16, "seq bf16")
    for r, run in enumerate(bf16):
        out[f"seq_bf16_rank{r}"] = _seq_launches(run, f"bf16 rank {r}",
                                                 "bfloat16")
    print(f"seq bf16 (beside the Ulysses worlds, not held): step ms "
          + ", ".join(f"{r['summary']['step_time_s'] * 1e3:.1f}"
                      for r in bf16)
          + f", launches a rank {out['seq_bf16_rank0']} over {SEQ_STEPS} "
          f"steps; start-up (s) {_startup_note({'seq_bf16': bf16})}",
          flush=True)
    return out


def classifier_remat_phase() -> dict:
    """Phase 33: ResNet-50 at examples/resnet50.yaml's point (batch 256,
    224px, space_to_depth, sgdm, bf16) without remat, then with
    whole-forward remat `full` and `dots` (the reference's
    `--resnet-remat`), from the same weights and batch: after two steps
    (the schedule's first updates) each remat run's parameters per row
    within 1e-2 of no remat's, its eval-mode logits and BatchNorm
    statistics within 1e-3 relative (phase 18's limits: the statistics
    move once a step); then 5 timed steps after 2 warm-up, step ms,
    images/s and peak GB beside no remat's; no flash launch."""
    import torch

    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.ops import kernel_check
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    base = {**resnet_yaml_config(), "log_every": 10**9}
    init = host = want = None
    figures = {}
    for policy in ("none", "full", "dots"):
        cfg = TrainConfig.from_dict({**base, "remat": policy != "none",
                                     "remat_policy": "full"
                                     if policy == "none" else policy})
        t = Trainer(cfg, device="cuda")
        if init is None:
            init = {k: v.clone() for k, v in t.model.state_dict().items()}
            host = next(t.data_iter())
        else:
            t.model.load_state_dict(init)
        batch = t._to_device(host)
        fa.reset_launches()
        for _ in range(2):
            t.train_step(batch)
        t.model.eval()
        with torch.no_grad():
            logits = t.model(batch["image"]).float()
        t.model.train()
        params = dict(t.model.named_parameters())
        got = {"logits": logits,
               "params": {n: p.detach().float().clone()
                          for n, p in params.items()},
               "stats": {n: b.detach().float().clone()
                         for n, b in t.model.named_buffers()}}
        for _ in range(2):
            t.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            m = t.train_step(batch)
        float(m["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
        launched = dict(fa.LAUNCHES)
        if any(launched.values()):
            fail(f"classifier remat {policy}: flash launches {launched}")
        figures[policy] = {
            "step_ms": dt * 1e3, "images_per_s": base["global_batch"] / dt,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del t, params, batch
        gc.collect()
        torch.cuda.empty_cache()
        if want is None:
            want = got
            continue
        worst = 0.0
        for n, w in want["params"].items():
            g = got["params"][n]
            rows = (lambda x: x.reshape(x.shape[0], -1) if x.ndim > 1
                    else x[None])
            worst = max(worst, check_rows(f"classifier remat {policy} {n}",
                                          rows(g), rows(w),
                                          kernel_check.ROW_TOL)["max_row_err"])
        rel = {"logits": _rel(got["logits"], want["logits"]),
               "stats": max(_rel(got["stats"][n], w)
                            for n, w in want["stats"].items())}
        if not max(rel.values()) <= CPU_REL_TOL:
            fail(f"classifier remat {policy}: relative errors {rel} (limit "
                 f"{CPU_REL_TOL})")
        figures[policy].update(params_max_row_err=worst, **{
            f"{k}_rel_err": v for k, v in rel.items()})
    print("classifier remat (ResNet-50, batch 256, 224px, bf16): "
          + json.dumps(figures), flush=True)
    return figures


# phase 34: the control plane's job path on the card
JOB_STEPS = 5                   # the job's total steps
JOB_SIGTERM_AFTER = 2           # rank 1's "step 2" line
JOB_TIMEOUT = 300
# torch.cuda.get_device_name -> GKE's accelerator label value
GKE_PRODUCTS = {"NVIDIA H100 80GB HBM3": "nvidia-h100-80gb",
                "NVIDIA H100 PCIe": "nvidia-h100-80gb",
                "NVIDIA H200": "nvidia-h200-141gb",
                "NVIDIA A100-SXM4-80GB": "nvidia-a100-80gb",
                "NVIDIA A100-SXM4-40GB": "nvidia-tesla-a100",
                "NVIDIA L4": "nvidia-l4"}


def gke_product(device_name: str) -> str:
    """GKE's spelling of a card (its cloud.google.com/gke-accelerator
    value): the table's, else the name lower-cased with dashes."""
    for prefix, label in sorted(GKE_PRODUCTS.items(), key=lambda kv:
                                -len(kv[0])):
        if device_name.startswith(prefix):
            return label
    return re.sub(r"[^a-z0-9]+", "-", device_name.lower()).strip("-")


def _conditions(job: dict) -> dict[str, str]:
    return {c["type"]: f"{c['status']}({c.get('reason', '')})"
            for c in (job.get("status") or {}).get("conditions") or []}


def job_path_phase(root, card: str) -> dict:
    """Phase 34: the port's control plane runs a JAXJob on the card.
    One GPU node on the port's FakeCluster, its product label the card's
    own name in GKE's spelling, advertising nvidia.com/gpu: 2 (two ranks
    share the one card over the loopback backend, as phase 21's); the
    port's JAXJob controller and gang scheduler, and its LocalPodExecutor
    as the kubelet, whose env hook points the headless-service
    coordinator at 127.0.0.1 (one port pair per gang incarnation) and
    sets JAXJOB_COLLECTIVES_BACKEND=loopback. The job: 2 replicas of 1
    GPU, gang-scheduled, the default command (the port's launcher) with
    a --config of phase 21's (examples/gpt-125m.yaml's model at full
    width and depth, bf16, flash, full remat, global batch 64 on mesh
    data 2), JOB_STEPS steps, a checkpoint directory. Holds: before the
    scheduler lifts the gang gate, every pod claims nvidia.com/gpu: 1,
    names the product and node-pool selectors and runs the launcher; a
    third 1-GPU gang submitted beside it stays gated and unbound while
    the first runs (then is deleted); the sidecar's gpu_devices_present
    is True here and False against an empty root (the control); both
    ranks of each incarnation log equal losses and launch each flash
    kernel as phase 21's config implies (_world_launches); rank 1 is
    SIGTERMed after its step 2 through kill_pod: both ranks exit 75 at
    one step, the job shows preemptions 1 and restarts 0, and the new
    gang resumes at that step and ends Succeeded. Prints the job's
    condition sequence, each incarnation's seconds from launch to its
    first step, the seconds from the SIGTERM to the new gang's first
    step, and each rank's step time. Returns each rank's launches over
    both incarnations."""
    import datetime
    import os
    import signal

    import torch

    from kubeflow_tpu_torch.control.jaxjob import types as JT
    from kubeflow_tpu_torch.control.jaxjob.controller import build_controller
    from kubeflow_tpu_torch.control.k8s import objects as ob
    from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
    from kubeflow_tpu_torch.control.k8s.kubelet import LocalPodExecutor
    from kubeflow_tpu_torch.control.runtime import seed_controller
    from kubeflow_tpu_torch.control.scheduler import GATE_GANG
    from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
    from kubeflow_tpu_torch.control.scheduler.scheduler import build_scheduler
    from kubeflow_tpu_torch.sidecar.controller import gpu_devices_present

    empty = root / "empty_root"
    empty.mkdir()
    gate = (gpu_devices_present(), gpu_devices_present(str(empty)))
    if gate != (True, False):
        fail(f"job path: gpu_devices_present on the card / an empty root "
             f"gave {gate}, want (True, False)")

    product = gke_product(torch.cuda.get_device_name(0))
    cluster = FakeCluster()
    ctl = seed_controller(build_controller(cluster))
    sched = seed_controller(build_scheduler(cluster, record_events=False))
    cluster.create(new_gpu_node("gpu-node-0", product=product,
                                node_pool="card", gpus=2))
    print(f"job path: node gpu-node-0 ({product}, pool card) advertises "
          "nvidia.com/gpu: 2 for the one card: the gang's two ranks share "
          "it over the loopback backend, as phase 21's", flush=True)
    cfg_path = root / "job.json"
    cfg_path.write_text(json.dumps(world_config(root, "job", 2, JOB_STEPS)))
    here = Path(__file__).resolve().parent
    # `python` in the pods' command is this interpreter
    shim = root / "bin"
    shim.mkdir()
    (shim / "python").write_text(f'#!/bin/sh\nexec {sys.executable} "$@"\n')
    (shim / "python").chmod(0o755)
    ports: dict[str, int] = {}

    def env_hook(pod, env):
        epoch = pod["metadata"]["annotations"][JT.ANNOTATION_EPOCH]
        port = ports.setdefault(epoch, _free_port_pair())
        env.update({JT.ENV_COORD: f"127.0.0.1:{port}",
                    "JAXJOB_COLLECTIVES_BACKEND": "loopback",
                    "PATH": f"{shim}{os.pathsep}{env.get('PATH', '')}",
                    "JAXRT_METRICS_PORT": "0",
                    "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
                    "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2)
                                               // 2))})
        return env

    # the kubelet runs the job's pods only: the third gang is never run
    executor = LocalPodExecutor(
        cluster, label_selector={"matchLabels": {JT.LABEL_JOB_NAME: "gpt"}},
        env_hook=env_hook, cwd=str(here), log_dir=str(root))
    job = JT.new_jaxjob("gpt", replicas=2, product=product,
                        node_pool="card", gpus_per_worker=1,
                        gang_schedule=True)
    job["spec"]["template"]["spec"]["containers"][0]["args"] = [
        "--config", str(cfg_path)]
    submitted = time.perf_counter()
    cluster.create(job)
    cluster.create(JT.new_jaxjob("third", replicas=1, product=product,
                                 node_pool="card", gpus_per_worker=1,
                                 gang_schedule=True))
    ctl.run_until_idle(advance_delayed=True)
    pods = cluster.list("v1", "Pod", namespace="default")
    if len(pods) != 3:
        fail(f"job path: {len(pods)} pods, want 3")
    for p in pods:
        spec, c = p["spec"], p["spec"]["containers"][0]
        held = (spec.get("schedulingGates") == [{"name": GATE_GANG}]
                and not spec.get("nodeName")
                and c["resources"]["limits"] == {JT.RESOURCE_GPU: 1}
                and spec["nodeSelector"] == {JT.NODESELECTOR_ACCEL: product,
                                             JT.NODESELECTOR_POOL: "card"}
                and c["command"] == list(JT.DEFAULT_COMMAND))
        if not held:
            fail(f"job path: pod {p['metadata']['name']} before admission: "
                 f"{json.dumps(spec)[:1500]}")

    seq: list[str] = []         # the job's condition transitions, in order
    state: dict[str, str] = {}
    third_held = 0
    sent = sent_at = None
    deadline = time.monotonic() + JOB_TIMEOUT
    try:
        while True:
            ctl.run_until_idle(advance_delayed=True)
            sched.run_until_idle(advance_delayed=True)
            executor.poll_once()
            gang = cluster.list("v1", "Pod", namespace="default",
                                label_selector={"matchLabels": {
                                    JT.LABEL_JOB_NAME: "gpt"}})
            if any((q.get("status") or {}).get("phase") == "Failed"
                   for q in gang) and not executor.settle(120):
                fail("job path: a rank outlived its peer's exit by 120 s")
            job = cluster.get(JT.API_VERSION, JT.KIND, "gpt", "default")
            for kind, now in _conditions(job).items():
                if state.get(kind) != now:
                    state[kind] = now
                    seq.append(f"{kind}={now}")
            third = cluster.get_or_none("v1", "Pod", "third-worker-0",
                                        "default")
            if third is not None and sent is None and \
                    ob.cond_is_true(job, JT.COND_RUNNING):
                if third["spec"].get("nodeName") or \
                        not third["spec"].get("schedulingGates"):
                    fail("job path: the third gang was admitted while the "
                         "first ran: all-or-nothing broken")
                third_held += 1
            log1 = next((e for e in reversed(executor.logs)
                         if e["name"] == "gpt-worker-1"), None)
            if sent is None and log1 is not None and re.search(
                    rf"\bstep {JOB_SIGTERM_AFTER} loss=",
                    Path(log1["path"]).read_text(errors="replace")):
                if not third_held:
                    fail("job path: the third gang was never seen pending "
                         "beside the running gang")
                cluster.delete(JT.API_VERSION, JT.KIND, "third", "default")
                if not executor.kill_pod("gpt-worker-1", sig=signal.SIGTERM):
                    fail("job path: no live process behind gpt-worker-1")
                sent, sent_at = log1["uid"], time.time()
            if ob.cond_is_true(job, JT.COND_SUCCEEDED):
                break
            if ob.cond_is_true(job, JT.COND_FAILED) or time.monotonic() > deadline:
                for e in executor.logs:
                    print(f"--- {e['name']} rc {e.get('rc')}\n"
                          + Path(e["path"]).read_text(errors="replace")[-4000:],
                          flush=True)
                fail(f"job path: the job did not succeed: {_conditions(job)}")
            time.sleep(0.2)
    finally:
        executor.shutdown()
    total_s = time.perf_counter() - submitted
    status = job["status"]
    if (status.get("preemptions"), status.get("restarts", 0)) != (1, 0):
        fail(f"job path: preemptions {status.get('preemptions')}, restarts "
             f"{status.get('restarts', 0)}; want 1 and 0")
    # the two incarnations, each a pair of ranks
    runs = []
    for e in executor.logs:
        out = Path(e["path"]).read_text(errors="replace")
        lines = [ln for ln in out.splitlines() if ln.startswith('{"summary"')]
        if not lines:
            print(out[-6000:], flush=True)
            fail(f"job path: {e['name']} exit {e.get('rc')} with no summary")
        launches, _ = _logged_launches(out)
        # the launcher's log line closing its first step, by its stamp
        first = re.search(r"^(\S+ \S+) .*first step \(incl\. kernel "
                          r"build\)", out, re.M)
        if first is None:
            fail(f"job path: {e['name']} logged no first step")
        runs.append({**e, "out": out, "launches": launches,
                     "summary": json.loads(lines[-1])["summary"],
                     "first_step_at": datetime.datetime.strptime(
                         first.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp(),
                     "losses": re.findall(r"\bstep \d+ loss=(\S+)", out)})
    if len(runs) != 4 or [r["name"] for r in runs] != [
            "gpt-worker-0", "gpt-worker-1"] * 2:
        fail(f"job path: incarnations {[r['name'] for r in runs]}")
    for r in runs:
        r["to_first_step"] = r["first_step_at"] - r["started"]
    stopped, resumed = runs[:2], runs[2:]
    # the restart: the SIGTERM to the new gang's first step done
    restart_s = max(r["first_step_at"] for r in resumed) - sent_at
    steps = set()
    for r in stopped:
        m = re.search(r"preempted at step (\d+)", r["out"])
        if r.get("rc") != 75 or not r["summary"].get("preempted") or not m:
            print(r["out"][-6000:], flush=True)
            fail(f"job path: {r['name']} of the first gang exit "
                 f"{r.get('rc')}, not a preemption at one step")
        steps.add(int(m.group(1)))
    if len(steps) != 1:
        fail(f"job path: the ranks stopped at steps {sorted(steps)}")
    at = steps.pop()
    for r in resumed:
        if r.get("rc") != 0 or r["summary"]["start_step"] != at:
            print(r["out"][-6000:], flush=True)
            fail(f"job path: {r['name']} of the new gang exit {r.get('rc')}, "
                 f"resumed at {r['summary']['start_step']}, stopped at {at}")
    launches = {"job_rank0": {}, "job_rank1": {}}
    for pair, n in ((stopped, at), (resumed, JOB_STEPS - at)):
        if pair[0]["losses"] != pair[1]["losses"]:
            fail(f"job path: rank losses differ {pair[0]['losses']} / "
                 f"{pair[1]['losses']}")
        for rank, r in enumerate(pair):
            got = _world_launches(r, n, f"job path rank {rank}")
            acc = launches[f"job_rank{rank}"]
            for k, v in got.items():
                acc[k] = acc.get(k, 0) + v
    print(f"job path ({card}): conditions {' -> '.join(seq)}; preempted "
          f"at step {at} by a SIGTERM to gpt-worker-1 after its step "
          f"{JOB_SIGTERM_AFTER}: both ranks exit 75, preemptions 1, "
          f"restarts 0, the new gang resumed at step {at} and ended "
          f"Succeeded; seconds from launch to the first step "
          f"{[round(r['to_first_step'], 2) for r in stopped]} (first gang) "
          f"/ {[round(r['to_first_step'], 2) for r in resumed]} (resumed); "
          f"the SIGTERM to the new gang's first step {restart_s:.1f} s; "
          f"step ms {[round(1e3 * r['summary']['step_time_s'], 1) for r in runs]}"
          f"; losses {stopped[0]['losses']} / {resumed[0]['losses']}; the "
          f"third gang held pending over {third_held} polls; submit to "
          f"Succeeded {total_s:.1f} s", flush=True)
    return launches


# -- phase 35: the control plane's services path ------------------------------

SERVICE_YAML = "examples/jaxservice.yaml"
SERVICE_REF = "gpt-125m"        # full width and depth, seeded weights
SERVICE_VOCAB = 32000           # the zoo LM's vocabulary
SERVICE_REQUESTS = 16           # concurrent requests once Ready
SERVICE_DRAIN_REQUESTS = 8      # in flight across the scale-down
SERVICE_TIMEOUT = 240           # seconds any one wait of the phase may take
SCHEDULER_EXIT_S = 10.0         # SIGTERM to exit 0, the bound held
PROCESS_GRACE_S = 10.0          # a spawned group's SIGTERM to its SIGKILL


class Spawned:
    """The one way the services phase starts a process: each in a session
    (and process group) of its own, recorded, so that one `killpg`
    reaches whatever it starts. `reap` — called on leaving the `with`
    block, whatever happened — sends SIGTERM to every recorded group,
    waits up to PROCESS_GRACE_S in all, then SIGKILLs the groups and
    waits for every process."""

    def __init__(self):
        self.procs: list[subprocess.Popen] = []

    def start(self, cmd: list[str], **kw) -> subprocess.Popen:
        proc = subprocess.Popen(cmd, start_new_session=True, **kw)
        self.procs.append(proc)
        return proc

    @staticmethod
    def _signal_group(proc: subprocess.Popen, sig) -> None:
        import os

        try:
            os.killpg(proc.pid, sig)   # the session leader's pgid is its pid
        except ProcessLookupError:
            pass                       # the group is empty: nothing left

    def reap(self) -> None:
        import signal

        for proc in self.procs:
            self._signal_group(proc, signal.SIGTERM)
        deadline = time.monotonic() + PROCESS_GRACE_S
        for proc in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(max(0.0, deadline - time.monotonic()))
        for proc in self.procs:
            self._signal_group(proc, signal.SIGKILL)
            proc.wait(PROCESS_GRACE_S)

    def __enter__(self) -> "Spawned":
        return self

    def __exit__(self, *exc) -> None:
        self.reap()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def service_manifest(product: str) -> dict:
    """examples/jaxservice.yaml's service on this card: `tpu:` becomes
    `gpu: {product, nodePool, gpusPerWorker: 1}`, the model the zoo's
    SERVICE_REF with seeded weights (no checkpoint to read), replicas
    min 2, max 2; promptLen 512, maxNewTokens 64, 16 decode slots,
    continuous batching, bfloat16 and the gang scheduler as written."""
    from kubeflow_tpu_torch.utils import yaml_lite

    here = Path(__file__).resolve().parent
    svc = yaml_lite.loads((here / SERVICE_YAML).read_text())
    spec = svc["spec"]
    spec.pop("tpu")
    spec["gpu"] = {"product": product, "nodePool": "card",
                   "gpusPerWorker": 1}
    spec["model"]["ref"] = SERVICE_REF
    spec["replicas"] = {"min": 2, "max": 2}
    return svc


def _replica_args(cmd: list[str]) -> list[str]:
    """A replica's command as the kubelet runs it (a seam: a rehearsal
    off the card adds its own flags here)."""
    return cmd


def _services_kubelet(cluster, spawned: Spawned, root, env_hook=None):
    """The port's LocalPodExecutor as the node's kubelet, its processes
    started through `spawned`. Replicas share this host, so each
    replica's `--port` (where its command has one) is rewritten to a
    free port of its own (`ports`, by pod name), and `python` is this
    interpreter. `launched` holds each launch's pod as the kubelet saw
    it, its process, port and start time. `env_hook` is the executor's
    (the pod, its env -> the env the process gets)."""
    from kubeflow_tpu_torch.control.k8s.kubelet import LocalPodExecutor

    class ServiceKubelet(LocalPodExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.ports: dict[str, int] = {}
            self.launched: dict[str, dict] = {}

        def _spawn(self, pod, cmd, env, stdout):
            name = pod["metadata"]["name"]
            cmd = list(cmd)
            if cmd[0] == "python":
                cmd[0] = sys.executable
            port = None
            if "--port" in cmd:
                port = self.ports[name] = _free_port()
                cmd[cmd.index("--port") + 1] = str(port)
            proc = spawned.start(_replica_args(cmd), env=env, cwd=self.cwd,
                                 stdout=stdout, stderr=subprocess.STDOUT)
            self.launched[name] = {"pod": pod, "proc": proc,
                                   "at": time.perf_counter(), "port": port}
            return proc

    return ServiceKubelet(cluster, cwd=str(Path(__file__).resolve().parent),
                          log_dir=str(root), env_hook=env_hook)


def _readyz(port: int) -> bool:
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                    timeout=2) as resp:
            return resp.status == 200
    except OSError:
        return False


def services_phase(root, card: str) -> None:
    """Phase 35: the control plane's services path. The port's
    FakeCluster with one GPU node (the card's product in GKE's spelling,
    nvidia.com/gpu: 2) behind the port's ApiServer on 127.0.0.1; the gang
    scheduler as its own process (`python -m
    kubeflow_tpu_torch.control.scheduler --apiserver ... --metrics-port 0
    --enable-leader-election`, a session of its own); the JAXService
    controller in-process on the port's RestClient, its drain gated by
    RegistrySignals over the in-process router's registry; the
    LocalPodExecutor as the kubelet (`_services_kubelet`); the router
    (TokenRouter + RouterFrontend) in-process, its membership only from
    `watch_endpoints` against the apiserver, its transport mapping a
    published address (`http://<pod>.<svc>.<ns>.svc:<port>`) to that
    replica's 127.0.0.1 port. The service: `service_manifest`.
    Holds: before the scheduler lifts each replica's gang gate, the pod
    claims nvidia.com/gpu: 1, names the product and node-pool selectors
    and runs `python -m kubeflow_tpu_torch.serving`; the scheduler
    process holds the Lease and binds each replica to the node; Ready
    with both replicas `active` in the endpoints annotation and the
    router's members the same two; SERVICE_REQUESTS concurrent requests
    (prompts of 4-512 tokens) answer 200 with 64 tokens each and both
    replicas serve some; spec.replicas lowered to 1 while
    SERVICE_DRAIN_REQUESTS more are in flight: one replica is cordoned,
    the router dispatches nothing to it after it sees the cordon, every
    in-flight request completes, the pod is deleted only after the
    controller read its router_tokens_inflight as 0 (having read it
    above 0 first), and its process is gone; deleting the JAXService
    takes the last replica's process; SIGTERM to the scheduler: exit 0
    within SCHEDULER_EXIT_S and the Lease's renewTime null. Every
    process is started through `Spawned` and reaped before return.
    Prints the condition sequence and the phase's seconds: submit to
    Ready, each replica's launch to serving, tokens/s over the
    requests (not held), the scale-down to the deletion, the
    scheduler's exit."""
    import concurrent.futures as cf
    import os
    import signal
    import threading
    import urllib.request
    from urllib.parse import urlsplit

    import torch

    from kubeflow_tpu_torch.control import leases
    from kubeflow_tpu_torch.control.jaxjob import types as JT
    from kubeflow_tpu_torch.control.jaxservice import types as T
    from kubeflow_tpu_torch.control.jaxservice import watch_endpoints
    from kubeflow_tpu_torch.control.jaxservice.controller import (
        build_controller)
    from kubeflow_tpu_torch.control.k8s import objects as ob
    from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer
    from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
    from kubeflow_tpu_torch.control.k8s.rest import RestClient
    from kubeflow_tpu_torch.control.scheduler import GATE_GANG
    from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
    from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
    from kubeflow_tpu_torch.serving import router as R

    t_phase = time.perf_counter()
    product = gke_product(torch.cuda.get_device_name(0))
    svc_obj = service_manifest(product)
    name, ns = svc_obj["metadata"]["name"], svc_obj["metadata"]["namespace"]
    replica = [T.replica_name(name, i) for i in range(2)]
    cluster = FakeCluster()
    cluster.create(new_gpu_node("gpu-node-0", product=product,
                                node_pool="card", gpus=2))
    apiserver = ApiServer(cluster).serve_background()
    client = RestClient(base_url=apiserver.url)
    registry = MetricsRegistry()      # the router's, read by the controller
    drain_reads: list = []            # (t, replica, inflight, drained)

    class RecordingSignals(R.RegistrySignals):
        def replica_drained(self, namespace, service, replica_name):
            inflight = self.inflight_tokens(namespace, service,
                                            replica_name)
            drained = super().replica_drained(namespace, service,
                                              replica_name)
            drain_reads.append((time.perf_counter(), replica_name,
                                inflight, drained))
            return drained

    router = R.TokenRouter(service=name, namespace=ns, registry=registry)
    front = R.RouterFrontend(router, max_new_tokens=64)
    dispatches: list = []             # (t, replica)

    class Counting:
        def __init__(self, inner, replica_name):
            self.inner, self.name = inner, replica_name

        def predict(self, model, body, headers=None):
            dispatches.append((time.perf_counter(), self.name))
            return self.inner.predict(model, body, headers)

    # filled once the kubelet exists; the router's transport reads it
    kubelet_ports: dict[str, int] = {}

    def transport(ep: dict):
        pod = urlsplit(ep["addr"]).hostname.split(".")[0]
        return Counting(R.HttpTransport(
            f"http://127.0.0.1:{kubelet_ports[pod]}"), ep["name"])

    added: dict[str, dict] = {}       # each replica pod as first created
    pod_watch = cluster.watch("v1", "Pod")
    stop = threading.Event()
    seq: list[str] = []
    state: dict[str, str] = {}
    ctl = fsvc = None
    with Spawned() as spawned:
        kubelet = _services_kubelet(cluster, spawned, root)
        kubelet_ports = kubelet.ports
        sched_log = open(root / "scheduler.log", "wb")
        try:
            sched = spawned.start(
                [sys.executable, "-m", "kubeflow_tpu_torch.control.scheduler",
                 "--apiserver", apiserver.url, "--metrics-port", "0",
                 "--enable-leader-election"],
                cwd=str(Path(__file__).resolve().parent),
                env={**os.environ, "POD_NAME": "gang-scheduler-0",
                     "POD_NAMESPACE": "kubeflow"},
                stdout=sched_log, stderr=subprocess.STDOUT)
            ctl = build_controller(
                client, signals=RecordingSignals(registry)).run(workers=2)
            threading.Thread(
                target=watch_endpoints,
                args=(apiserver.url, ns, name, router),
                kwargs={"frontend": front, "stop": stop,
                        "transport_factory": transport},
                daemon=True, name="router-endpoints-watch").start()
            fsvc = front.serve(host="127.0.0.1", port=0).serve_background()

            def poll():
                """One turn of the node and the watchers: the kubelet's
                pass, the pods' first versions, the conditions."""
                kubelet.poll_once()
                while (ev := pod_watch.poll()) is not None:
                    pod_name = ev.object["metadata"]["name"]
                    added.setdefault(pod_name, ev.object)
                got = cluster.get_or_none(T.API_VERSION, T.KIND, name, ns)
                for c in ((got or {}).get("status") or {}).get(
                        "conditions") or []:
                    now = f"{c['status']}({c.get('reason', '')})"
                    if state.get(c["type"]) != now:
                        state[c["type"]] = now
                        seq.append(f"{c['type']}={now}")
                if sched.poll() is not None and not stopping:
                    fail(f"services path: the scheduler exited "
                         f"{sched.returncode}: " + (root / "scheduler.log")
                         .read_text(errors="replace")[-3000:])
                return got

            def wait(what: str, cond):
                deadline = time.monotonic() + SERVICE_TIMEOUT
                while True:
                    got = poll()
                    out = cond(got)
                    if out:
                        return out
                    if time.monotonic() > deadline:
                        for e in kubelet.logs:
                            print(f"--- {e['name']} rc {e.get('rc')}\n"
                                  + Path(e["path"]).read_text(
                                      errors="replace")[-3000:], flush=True)
                        fail(f"services path: no {what} within "
                             f"{SERVICE_TIMEOUT} s; conditions {seq}")
                    time.sleep(0.05)

            stopping = False
            submitted = time.perf_counter()
            client.create(svc_obj)
            wait("replica pods", lambda s: all(r in added for r in replica))
            for r in replica:
                pod = added[r]
                spec, c = pod["spec"], pod["spec"]["containers"][0]
                held = (spec.get("schedulingGates") == [{"name": GATE_GANG}]
                        and not spec.get("nodeName")
                        and c["resources"]["limits"] == {JT.RESOURCE_GPU: 1}
                        and spec["nodeSelector"] == {
                            JT.NODESELECTOR_ACCEL: product,
                            JT.NODESELECTOR_POOL: "card"}
                        and c["command"][:3] == [
                            "python", "-m", "kubeflow_tpu_torch.serving"])
                if not held:
                    fail(f"services path: pod {r} before admission: "
                         f"{json.dumps(spec)[:1500]}")
            lease = wait("scheduler Lease", lambda s: cluster.get_or_none(
                leases.API_VERSION, leases.KIND, "gang-scheduler-controller",
                "kubeflow"))
            holder = lease["spec"]["holderIdentity"]
            if not holder.startswith("gang-scheduler-0_"):
                fail(f"services path: the Lease is held by {holder!r}, not "
                     "the scheduler process")
            wait("launches", lambda s: all(r in kubelet.launched
                                          for r in replica))
            for r in replica:
                spec = kubelet.launched[r]["pod"]["spec"]
                if spec.get("nodeName") != "gpu-node-0" or \
                        spec.get("schedulingGates"):
                    fail(f"services path: {r} launched unbound or gated: "
                         f"{json.dumps(spec)[:800]}")
            ready_s = {}

            def serving(_):
                for r in replica:
                    if r not in ready_s and _readyz(kubelet.launched[r]
                                                    ["port"]):
                        ready_s[r] = (time.perf_counter()
                                      - kubelet.launched[r]["at"])
                return len(ready_s) == 2

            t_ready = None

            def ready(s):
                nonlocal t_ready
                if s is None or not ob.cond_is_true(s, T.COND_READY):
                    return False
                if t_ready is None:
                    t_ready = time.perf_counter() - submitted
                eps = {e["name"]: e["state"]
                       for e in R.parse_endpoints(s)}
                return (eps == {r: R.STATE_ACTIVE for r in replica}
                        and router.members() == eps)

            wait("Ready with both endpoints", ready)
            wait("both replicas serving", serving)
            serving_s = time.perf_counter() - submitted
            rng = random.Random(35)
            lengths = [4, 512] + [rng.randint(4, 512)
                                  for _ in range(SERVICE_REQUESTS
                                                 + SERVICE_DRAIN_REQUESTS - 2)]
            prompts = [[rng.randrange(1, SERVICE_VOCAB) for _ in range(n)]
                       for n in lengths]

            def post(prompt: list[int]) -> tuple[int, list[int]]:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{fsvc.port}/v1/models/"
                    f"{svc_obj['spec']['model']['name']}:predict",
                    data=json.dumps({"instances": [{"tokens": prompt}]})
                    .encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=300) as resp:
                    return resp.status, json.loads(resp.read())[
                        "predictions"][0]

            def held_answers(outs, what):
                bad = [(code, len(toks)) for code, toks in outs
                       if code != 200 or len(toks) != 64
                       or not all(0 <= t < SERVICE_VOCAB for t in toks)]
                if bad:
                    fail(f"services path: {what}: answers (status, tokens) "
                         f"{bad[:4]}, want 200 and 64 ids in range")

            t1 = time.perf_counter()
            with cf.ThreadPoolExecutor(SERVICE_REQUESTS) as pool:
                outs = list(pool.map(post, prompts[:SERVICE_REQUESTS]))
            req_s = time.perf_counter() - t1
            held_answers(outs, f"{SERVICE_REQUESTS} requests")
            served = {r: sum(1 for _, n in dispatches if n == r)
                      for r in replica}
            if min(served.values()) == 0:
                fail(f"services path: dispatches by replica {served}: "
                     "both must serve")
            tokens_s = SERVICE_REQUESTS * 64 / req_s
            # the scale-down, with SERVICE_DRAIN_REQUESTS in flight
            gone, kept = replica[1], replica[0]
            gone_proc = kubelet.launched[gone]["proc"]
            with cf.ThreadPoolExecutor(SERVICE_DRAIN_REQUESTS) as pool:
                futs = [pool.submit(post, p)
                        for p in prompts[SERVICE_REQUESTS:]]
                wait(f"requests in flight on {gone}",
                     lambda s: router.inflight_tokens(gone) > 0)
                t_down = time.perf_counter()
                client.patch(T.API_VERSION, T.KIND, name,
                             {"spec": {"replicas": {"min": 1, "max": 1}}},
                             ns)
                t_cordon = wait("the router to see the cordon", lambda s:
                                router.members().get(gone)
                                == R.STATE_CORDONED
                                and time.perf_counter())
                wait("the drained pod's deletion", lambda s:
                     cluster.get_or_none("v1", "Pod", gone, ns) is None)
                t_deleted = time.perf_counter()
                drain_outs = [f.result() for f in futs]
            held_answers(drain_outs, "requests across the scale-down")
            late = [t - t_cordon for t, n in dispatches
                    if n == gone and t > t_cordon]
            if late:
                fail(f"services path: {len(late)} dispatches to the "
                     f"cordoned {gone} after the router saw the cordon")
            reads = [(t, v, d) for t, n, v, d in drain_reads if n == gone]
            first_yes = next((t for t, _, d in reads if d), None)
            if first_yes is None or first_yes > t_deleted or \
                    not any(v > 0 and not d for _, v, d in reads):
                fail(f"services path: the controller's drain reads of "
                     f"{gone} {[(round(v), d) for _, v, d in reads]}: want "
                     "in-flight tokens above 0, then 0, before deletion")
            wait(f"{gone}'s process reaped", lambda s: gone_proc.returncode
                 is not None)
            with contextlib.suppress(ProcessLookupError):
                os.kill(gone_proc.pid, 0)
                fail(f"services path: {gone}'s process {gone_proc.pid} "
                     "is still there after its pod was deleted")
            if router.members() != {kept: R.STATE_ACTIVE}:
                wait("the router's one member", lambda s:
                     router.members() == {kept: R.STATE_ACTIVE})
            # the service goes: its last replica's process with it
            kept_proc = kubelet.launched[kept]["proc"]
            client.delete(T.API_VERSION, T.KIND, name, ns)
            wait(f"{kept}'s process reaped", lambda s: kept_proc.returncode
                 is not None and cluster.get_or_none("v1", "Pod", kept, ns)
                 is None)
            stopping = True
            t2 = time.perf_counter()
            sched.send_signal(signal.SIGTERM)
            try:
                rc = sched.wait(SCHEDULER_EXIT_S)
            except subprocess.TimeoutExpired:
                fail(f"services path: the scheduler did not exit within "
                     f"{SCHEDULER_EXIT_S} s of SIGTERM")
            sched_exit_s = time.perf_counter() - t2
            lease = cluster.get(leases.API_VERSION, leases.KIND,
                                "gang-scheduler-controller", "kubeflow")
            if rc != 0 or lease["spec"].get("renewTime") is not None:
                fail(f"services path: the scheduler exit {rc}, Lease "
                     f"renewTime {lease['spec'].get('renewTime')}; want 0 "
                     "and null: " + (root / "scheduler.log").read_text(
                         errors="replace")[-3000:])
        finally:
            stop.set()
            if ctl is not None:
                ctl.stop()
            kubelet.shutdown()
            if fsvc is not None:
                fsvc.shutdown()
            pod_watch.stop()
            apiserver.shutdown()
            sched_log.close()
    print(f"services path ({card}): conditions {' -> '.join(seq)}; submit "
          f"to Ready {t_ready:.2f} s, to both replicas serving "
          f"{serving_s:.2f} s; launch to serving "
          f"{ {r: round(s, 2) for r, s in sorted(ready_s.items())} } s; "
          f"{SERVICE_REQUESTS} requests (prompts 4-512, 64 new) in "
          f"{req_s:.2f} s, {tokens_s:.1f} tokens/s (not held), dispatches "
          f"{served}; scale-down to {gone}'s deletion "
          f"{t_deleted - t_down:.2f} s (cordon seen by the router "
          f"{t_cordon - t_down:.2f} s) with {SERVICE_DRAIN_REQUESTS} in "
          f"flight, all 200; the scheduler's exit {sched_exit_s:.2f} s, "
          f"Lease released; {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 36: the platform's user path ---------------------------------------

STUDY_YAML = "examples/studyjob-sweep.yaml"
USER_NS = "team-ml"                # the sweep's namespace, the Profile's name
USER = "alice@example.com"         # the Profile's owner, the JWA's caller
USER_GPU_QUOTA = 2
STUDY_LR = 3.0e-4                  # examples/gpt-125m.yaml's learning rate
STUDY_STEPS = 3
STUDY_BATCH = 16
STUDY_TIMEOUT = 300                # seconds any one wait of the phase may take


def study_config(opt: str) -> dict:
    """A trial's launcher config: examples/gpt-125m.yaml's model and data
    shape at full width and depth (gpt-125m, seq 1024, vocab 32000, remat
    full, bf16 and flash by default) at global batch 16 on one process
    (the yaml's fsdp 4 x model 2 needs 8 GPUs), `opt` as the optimizer,
    STUDY_STEPS steps, no checkpoint."""
    from kubeflow_tpu_torch.utils import yaml_lite

    here = Path(__file__).resolve().parent
    cfg = yaml_lite.loads((here / WORLD_YAML).read_text())
    for key in ("mesh", "checkpoint_dir", "checkpoint_every"):
        cfg.pop(key, None)
    cfg.update(optimizer=opt, learning_rate=STUDY_LR,
               global_batch=STUDY_BATCH, total_steps=STUDY_STEPS,
               log_every=1)
    return cfg


def study_manifest(product: str, root) -> dict:
    """examples/studyjob-sweep.yaml in USER_NS, cut for one card: grid
    over `opt` (adamw, adafactor) with `lr` fixed at STUDY_LR, two trials
    at once, each one replica of one GPU (`gpu: {product, card, 1}` for
    the yaml's `tpu:` of 4 replicas of 4 chips), gang-scheduled; the
    trial runs the port's launcher with `--config` of the config written
    for its ${lr} and ${opt} (the launcher takes no hyperparameter flag)
    on the port's image."""
    from kubeflow_tpu_torch.control.jaxjob import types as JT
    from kubeflow_tpu_torch.control.scheduler import SCHEDULER_NAME
    from kubeflow_tpu_torch.utils import yaml_lite

    here = Path(__file__).resolve().parent
    study = yaml_lite.loads((here / STUDY_YAML).read_text())
    study["metadata"]["namespace"] = USER_NS
    spec = study["spec"]
    spec["algorithm"] = {"algorithmName": "grid", "seed": 0}
    params = {p["name"]: p for p in spec["parameters"]}
    params["lr"]["feasible"] = {"min": STUDY_LR, "max": STUDY_LR,
                                "steps": 1}
    spec["maxTrialCount"] = spec["parallelTrialCount"] = 2
    trial = spec["trialTemplate"]["spec"]
    trial.pop("tpu")
    trial.update(replicas=1, schedulerName=SCHEDULER_NAME,
                 gpu={"product": product, "nodePool": "card",
                      "gpusPerWorker": 1})
    c = trial["template"]["spec"]["containers"][0]
    c["image"] = JT.DEFAULT_IMAGE
    c["command"] = list(JT.DEFAULT_COMMAND) + [
        "--config", str(root / "lr${lr}-${opt}.json")]
    return study


def user_path_phase(root, card: str) -> dict:
    """Phase 36: the platform's user path. The port's FakeCluster with
    one GPU node (the card's product in GKE's spelling, nvidia.com/gpu:
    2: the two trials share the one card, as phase 34's ranks) behind the
    port's ApiServer on 127.0.0.1; the Profile, Notebook, JAXJob and
    StudyJob controllers and the gang scheduler in-process on the port's
    RestClient; the Jupyter web app served on 127.0.0.1 on that client;
    the LocalPodExecutor as the kubelet (`_services_kubelet`, every
    process through `Spawned`). (1) A Profile USER_NS with a quota of
    requests.nvidia.com/gpu: USER_GPU_QUOTA: its namespace, owner role
    binding and ResourceQuota appear, the quota naming nvidia.com/gpu and
    no TPU. (2) A notebook POSTed to the JWA over HTTP as USER with the
    form `gpu: {count: 1, product}`: the Notebook CR has that limit and
    selector, the StatefulSet the notebook controller makes claims
    nvidia.com/gpu: 1 with the product selector in its pod template, the
    JWA's GET lists it (no pod runs: the JAX package has no StatefulSet
    controller); the Profile and Notebook controllers then stop (each
    writes its status on every reconcile, and the write queues the
    next). (3) `study_manifest`'s StudyJob: both trial pods claim
    nvidia.com/gpu: 1 with the product and node-pool selectors and run
    the launcher before the scheduler lifts their gang gates; each
    trial's launcher launches each flash kernel as its config implies
    (phase 34's count: gpt-125m's 12 layers, the forward twice under full
    remat) on the card and prints a finite final.loss; the collector, the
    reconciler's injectable one, reads that line from the trial pod's
    output and writes the objective annotation; the StudyJob goes Running
    -> Succeeded with the lower loss its bestTrial; its deletion takes
    its trials and their pods. Prints each step's seconds: submit to the
    trials bound, launch to first step, launch to the study's Succeeded,
    and the phase. Returns each trial's launches."""
    import datetime
    import math
    import os
    import threading
    import urllib.request

    import torch

    from kubeflow_tpu_torch.control.jaxjob import types as JT
    from kubeflow_tpu_torch.control.jaxjob.controller import (
        build_controller as build_jobs, worker_name)
    from kubeflow_tpu_torch.control.k8s import objects as ob
    from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer
    from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
    from kubeflow_tpu_torch.control.k8s.rest import RestClient
    from kubeflow_tpu_torch.control.notebook import types as NT
    from kubeflow_tpu_torch.control.notebook.controller import (
        build_controller as build_notebooks)
    from kubeflow_tpu_torch.control.profile import types as PT
    from kubeflow_tpu_torch.control.profile.controller import (
        build_controller as build_profiles)
    from kubeflow_tpu_torch.control.scheduler import GATE_GANG
    from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
    from kubeflow_tpu_torch.control.scheduler.scheduler import build_scheduler
    from kubeflow_tpu_torch.tune import studyjob as S
    from kubeflow_tpu_torch.webapps.jwa import JupyterWebApp

    t_phase = time.perf_counter()
    product = gke_product(torch.cuda.get_device_name(0))
    study = study_manifest(product, root)
    name = study["metadata"]["name"]
    for opt in study["spec"]["parameters"][1]["feasible"]["list"]:
        (root / f"lr{STUDY_LR}-{opt}.json").write_text(
            json.dumps(study_config(opt)))
    cluster = FakeCluster()
    cluster.create(new_gpu_node("gpu-node-0", product=product,
                                node_pool="card", gpus=USER_GPU_QUOTA))
    apiserver = ApiServer(cluster).serve_background()
    client = RestClient(base_url=apiserver.url)
    added: dict[str, dict] = {}       # each pod as first created
    bound: dict[str, float] = {}      # each trial pod's first bound version
    pod_watch = cluster.watch("v1", "Pod")
    seq: list[str] = []
    state: dict[str, str] = {}

    def env_hook(pod, env):
        env.update(JAXRT_METRICS_PORT="0",
                   OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2)))
        return env

    def trial_log(trial: str) -> str | None:
        entry = next((e for e in reversed(kubelet.logs)
                      if e["name"] == worker_name(trial, 0)), None)
        return None if entry is None else Path(entry["path"]).read_text(
            errors="replace")

    def summary_of(out: str) -> dict | None:
        lines = [ln for ln in out.splitlines() if ln.startswith('{"summary"')]
        return json.loads(lines[-1])["summary"] if lines else None

    def collector(job: dict) -> float | None:
        """The trial's objective: final.loss from its pod's summary line,
        written as the objective annotation (the JAX design's injectable
        collector, studyjob.py:16-19, 280)."""
        trial = job["metadata"]["name"]
        out = trial_log(trial)
        summary = summary_of(out) if out else None
        loss = (summary or {}).get("final", {}).get("loss")
        if loss is None:
            return None
        if ob.annotations_of(job).get(S.ANNO_OBJECTIVE) != str(loss):
            client.patch(JT.API_VERSION, JT.KIND, trial,
                         {"metadata": {"annotations": {
                             S.ANNO_OBJECTIVE: str(loss)}}}, USER_NS)
        return loss

    ctls: dict[str, object] = {}
    jwa = None
    with Spawned() as spawned:
        kubelet = _services_kubelet(cluster, spawned, root, env_hook=env_hook)
        try:
            ctls = {"profile": build_profiles(client),
                    "notebook": build_notebooks(client),
                    "jaxjob": build_jobs(client),
                    "studyjob": S.build_controller(client,
                                                   collector=collector),
                    "scheduler": build_scheduler(client,
                                                 record_events=False)}
            for ctl in ctls.values():
                ctl.run(workers=2)
            jwa = JupyterWebApp(client).serve(
                host="127.0.0.1", port=0).serve_background()

            def poll():
                kubelet.poll_once()
                while (ev := pod_watch.poll()) is not None:
                    pod = ev.object
                    pod_name = pod["metadata"]["name"]
                    added.setdefault(pod_name, pod)
                    if pod["spec"].get("nodeName") and not pod["spec"].get(
                            "schedulingGates"):
                        bound.setdefault(pod_name, time.perf_counter())
                got = cluster.get_or_none(S.API_VERSION, S.KIND, name,
                                          USER_NS)
                for c in ((got or {}).get("status") or {}).get(
                        "conditions") or []:
                    now = f"{c['status']}({c.get('reason', '')})"
                    if state.get(c["type"]) != now:
                        state[c["type"]] = now
                        seq.append(f"{c['type']}={now}")
                return got

            def wait(what: str, cond):
                deadline = time.monotonic() + STUDY_TIMEOUT
                while True:
                    out = cond(poll())
                    if out:
                        return out
                    if time.monotonic() > deadline:
                        for e in kubelet.logs:
                            print(f"--- {e['name']} rc {e.get('rc')}\n"
                                  + Path(e["path"]).read_text(
                                      errors="replace")[-3000:], flush=True)
                        fail(f"user path: no {what} within {STUDY_TIMEOUT} "
                             f"s; study conditions {seq}")
                    time.sleep(0.05)

            # (1) the Profile: namespace, owner binding, the GPU quota
            t1 = time.perf_counter()
            client.create(PT.new_profile(USER_NS, USER,
                                         gpu_quota=USER_GPU_QUOTA))
            quota = wait("Profile quota", lambda s: cluster.get_or_none(
                "v1", "ResourceQuota", PT.QUOTA_NAME, USER_NS))
            wait("Profile Ready", lambda s: ob.cond_is_true(
                cluster.get(PT.API_VERSION, PT.KIND, USER_NS), "Ready"))
            ns = cluster.get_or_none("v1", "Namespace", USER_NS)
            admin = cluster.get_or_none("rbac.authorization.k8s.io/v1",
                                        "RoleBinding", "namespaceAdmin",
                                        USER_NS)
            if ns is None or ob.annotations_of(ns).get("owner") != USER or \
                    admin is None or admin["subjects"][0]["name"] != USER:
                fail(f"user path: profile namespace {ns} / owner binding "
                     f"{admin}")
            if quota["spec"]["hard"] != {PT.QUOTA_GPU: USER_GPU_QUOTA} or \
                    "tpu" in json.dumps(quota):
                fail(f"user path: the quota {quota['spec']}, want "
                     f"{{{PT.QUOTA_GPU!r}: {USER_GPU_QUOTA}}} and no TPU")
            profile_s = time.perf_counter() - t1

            # (2) a notebook through the JWA over HTTP
            t2 = time.perf_counter()
            base = f"http://127.0.0.1:{jwa.port}/api/namespaces/{USER_NS}" \
                "/notebooks"
            req = urllib.request.Request(
                base, method="POST", headers={
                    "kubeflow-userid": USER,
                    "Content-Type": "application/json"},
                data=json.dumps({"name": "gpu-nb", "gpu": {
                    "count": 1, "product": product}}).encode())
            with urllib.request.urlopen(req, timeout=60) as resp:
                posted = json.loads(resp.read())
            if posted != {"status": "ok", "name": "gpu-nb"}:
                fail(f"user path: the JWA answered {posted}")
            nb = cluster.get(NT.API_VERSION, NT.KIND, "gpu-nb", USER_NS)
            want = ({JT.RESOURCE_GPU: 1}, {JT.NODESELECTOR_ACCEL: product})
            nb_spec = nb["spec"]["template"]["spec"]
            if (nb_spec["containers"][0]["resources"].get("limits"),
                    nb_spec.get("nodeSelector")) != want:
                fail(f"user path: the Notebook's pod spec {nb_spec}")
            sts = wait("the notebook's StatefulSet", lambda s:
                       cluster.get_or_none("apps/v1", "StatefulSet",
                                           "gpu-nb", USER_NS))
            tmpl = sts["spec"]["template"]["spec"]
            if (tmpl["containers"][0]["resources"].get("limits"),
                    tmpl.get("nodeSelector")) != want or \
                    sts["spec"]["replicas"] != 1:
                fail(f"user path: the StatefulSet's pod template {tmpl}")
            with urllib.request.urlopen(urllib.request.Request(
                    base, headers={"kubeflow-userid": USER}),
                    timeout=60) as resp:
                rows = json.loads(resp.read())["notebooks"]
            if [r["name"] for r in rows] != ["gpu-nb"]:
                fail(f"user path: the JWA lists {rows}")
            notebook_s = time.perf_counter() - t2
            for key in ("profile", "notebook"):
                ctls.pop(key).stop()

            # (3) the StudyJob: two trials on the card
            submitted = time.perf_counter()
            client.create(study)
            trials = [f"{name}-trial-{i}" for i in range(2)]
            pods = [worker_name(t, 0) for t in trials]
            wait("trial pods", lambda s: all(p in added for p in pods))
            for p in pods:
                spec, c = added[p]["spec"], added[p]["spec"]["containers"][0]
                held = (spec.get("schedulingGates") == [{"name": GATE_GANG}]
                        and not spec.get("nodeName")
                        and c["resources"]["limits"] == {JT.RESOURCE_GPU: 1}
                        and spec["nodeSelector"] == {
                            JT.NODESELECTOR_ACCEL: product,
                            JT.NODESELECTOR_POOL: "card"}
                        and c["command"][:3] == list(JT.DEFAULT_COMMAND))
                if not held:
                    fail(f"user path: trial pod {p} before admission: "
                         f"{json.dumps(spec)[:1500]}")
            wait("both trials bound", lambda s: all(p in bound for p in pods))
            bound_s = max(bound[p] for p in pods) - submitted
            wait("both trials launched", lambda s: all(
                p in kubelet.launched for p in pods))
            for p in pods:
                spec = kubelet.launched[p]["pod"]["spec"]
                if spec.get("nodeName") != "gpu-node-0" or \
                        spec.get("schedulingGates"):
                    fail(f"user path: {p} launched unbound or gated")
            got = wait("the study's end", lambda s: s is not None and (
                ob.cond_is_true(s, S.COND_SUCCEEDED)
                or ob.cond_is_true(s, S.COND_FAILED)) and s)
            t_done = time.time()
            if not ob.cond_is_true(got, S.COND_SUCCEEDED):
                for e in kubelet.logs:
                    print(f"--- {e['name']} rc {e.get('rc')}\n"
                          + Path(e["path"]).read_text(
                              errors="replace")[-3000:], flush=True)
                fail(f"user path: the study did not succeed: {seq}")
            if [x.split("=")[0] for x in seq[:1]] != ["Running"] or \
                    "Running=True(TrialsRunning)" not in seq:
                fail(f"user path: the study's conditions {seq}: want "
                     "Running before Succeeded")
            runs, launches = {}, {}
            for t, p in zip(trials, pods):
                entry = [e for e in kubelet.logs if e["name"] == p]
                out = trial_log(t)
                summary = summary_of(out) if out else None
                loss = (summary or {}).get("final", {}).get("loss")
                first = re.search(r"^(\S+ \S+) .*first step \(incl\. "
                                  r"kernel build\)", out or "", re.M)
                if len(entry) != 1 or entry[0].get("rc") != 0 or \
                        loss is None or not math.isfinite(loss) or \
                        first is None:
                    print((out or "")[-6000:], flush=True)
                    fail(f"user path: trial {t} exit "
                         f"{[e.get('rc') for e in entry]}, final loss "
                         f"{loss}: want one run, exit 0 on the card and a "
                         "finite loss")
                # the flash kernels launch on the card alone: a trial on
                # the CPU launches none and fails this count
                run = {"launches": _logged_launches(out)[0]}
                launches[f"study_trial{t.rsplit('-', 1)[1]}"] = \
                    _world_launches(run, STUDY_STEPS, f"user path trial {t}")
                runs[t] = {"loss": loss, "started": entry[0]["started"],
                           "first": datetime.datetime.strptime(
                               first.group(1),
                               "%Y-%m-%d %H:%M:%S,%f").timestamp(),
                           "step_ms": 1e3 * summary["step_time_s"]}
                job = cluster.get(JT.API_VERSION, JT.KIND, t, USER_NS)
                if ob.annotations_of(job).get(S.ANNO_OBJECTIVE) != str(loss):
                    fail(f"user path: {t}'s objective annotation "
                         f"{ob.annotations_of(job).get(S.ANNO_OBJECTIVE)}, "
                         f"its summary's loss {loss}")
            best = got["status"].get("bestTrial") or {}
            low = min(r["loss"] for r in runs.values())
            if best.get("objective") != low or \
                    runs.get(best.get("trial"), {}).get("loss") != low:
                fail(f"user path: bestTrial {best}, trial losses "
                     f"{ {t: r['loss'] for t, r in runs.items()} }")
            # the deletion cascades to the trials and their pods
            client.delete(S.API_VERSION, S.KIND, name, USER_NS)
            wait("the trials' deletion", lambda s: not cluster.list(
                JT.API_VERSION, JT.KIND, namespace=USER_NS) and not
                cluster.list("v1", "Pod", namespace=USER_NS))
        finally:
            for ctl in ctls.values():
                ctl.stop()
            kubelet.shutdown()
            if jwa is not None:
                jwa.shutdown()
            pod_watch.stop()
            apiserver.shutdown()
    launch0 = min(r["started"] for r in runs.values())
    print(f"user path ({card}): profile {USER_NS} with "
          f"{PT.QUOTA_GPU}: {USER_GPU_QUOTA} in {profile_s:.2f} s; notebook "
          f"gpu-nb (nvidia.com/gpu: 1, {product}) through the JWA over HTTP "
          f"to its StatefulSet in {notebook_s:.2f} s; study {name} "
          f"conditions {' -> '.join(seq)}; submit to the trials bound "
          f"{bound_s:.2f} s; launch to first step "
          f"{ {t: round(r['first'] - r['started'], 2) for t, r in runs.items()} }"
          f" s; launch to the study's Succeeded {t_done - launch0:.1f} s; "
          f"step ms { {t: round(r['step_ms'], 1) for t, r in runs.items()} }; "
          f"final losses { {t: r['loss'] for t, r in runs.items()} }, best "
          f"{best['trial']}, each objective annotated from its summary "
          f"line; the deletion took the trials; "
          f"{time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# -- phase 37: the platform's deploy path --------------------------------------

DEPLOY_NAME = "kubeflow"           # the TpuDef; its node pool is kubeflow-gpu
DEPLOY_NS = "default"              # the job's, the PodDefault's, the board's
DEPLOY_JOB = "train"
DEPLOY_TIMEOUT = 300               # seconds any one wait of the phase may take
DEPLOY_PROFILE = (1, 2)            # the trial's profiler window: steps [1, 3)


class GcloudDouble:
    """gcloud's `container node-pools` describe, create and delete as an
    in-process runner for `GkeGpuPlatform` (the card's machine has no
    gcloud): stateful as tests/test_torch_tpctl_gcloud.py's double,
    describing a pool's machine, accelerators, labels and node count
    from its create flags; every argv kept in `calls`."""

    def __init__(self):
        self.pools: dict[str, dict] = {}
        self.calls: list[list[str]] = []

    @staticmethod
    def labels(flags: dict) -> dict[str, str]:
        return dict(kv.split("=", 1) for kv in
                    flags.get("--node-labels", "").split(",") if kv)

    def __call__(self, cmd, check=False, capture_output=True, text=True):
        self.calls.append(list(cmd))

        def done(rc: int, out: str = "", err: str = ""):
            return subprocess.CompletedProcess(cmd, rc, out, err)

        flags = dict(a.split("=", 1) if "=" in a else (a, True)
                     for a in cmd[5:])
        if cmd[:3] != ["gcloud", "container", "node-pools"] or any(
                f not in flags for f in ("--project", "--zone", "--cluster")):
            return done(2, err=f"unsupported: {' '.join(cmd)}")
        verb, name = cmd[3], cmd[4]
        if verb == "describe":
            if name not in self.pools:
                return done(1, err=f"ERROR: Not found: nodePools/{name}")
            f = self.pools[name]
            acc = dict(kv.split("=", 1) for kv in f["--accelerator"].split(","))
            return done(0, json.dumps({
                "name": name, "initialNodeCount": int(f["--num-nodes"]),
                "config": {"machineType": f["--machine-type"],
                           "labels": self.labels(f),
                           "accelerators": [{
                               "acceleratorType": acc["type"],
                               "acceleratorCount": acc["count"]}]}}))
        if verb == "create":
            if name in self.pools:
                return done(1, err=f"ERROR: Already exists: {name}")
            self.pools[name] = flags
            return done(0)
        if verb == "delete" and flags.get("--quiet") is True:
            if name not in self.pools:
                return done(1, err=f"ERROR: Not found: nodePools/{name}")
            del self.pools[name]
            return done(0)
        return done(2, err=f"unsupported: {' '.join(cmd)}")


class _PodDefaultInformer:
    """The webhook's client: the cluster's PodDefaults from a watch,
    drained at each lookup. A pod's admission holds the cluster's lock
    while it waits for the webhook's answer (as an apiserver waits on its
    webhooks), so the webhook reads a watch-fed view, as a webhook reads
    its informer cache, never the store."""

    def __init__(self, cluster):
        from kubeflow_tpu_torch.control.poddefault import webhook as PW

        self._watch = cluster.watch(PW.API_VERSION, PW.KIND)
        self._objs: dict[tuple, dict] = {}

    def list(self, api_version: str, kind: str, namespace=None, **kw):
        while (ev := self._watch.poll()) is not None:
            m = ev.object["metadata"]
            key = (m.get("namespace"), m["name"])
            if ev.type == "DELETED":
                self._objs.pop(key, None)
            else:
                self._objs[key] = ev.object
        return [o for (ns, _), o in sorted(self._objs.items())
                if namespace in (None, ns)]

    def stop(self) -> None:
        self._watch.stop()


def deploy_config(logspath: Path) -> dict:
    """The trial's launcher config: phase 36's (examples/gpt-125m.yaml's
    model at full width and depth, seq 1024, global batch 16, bf16,
    flash, full remat, STUDY_STEPS steps, one process) with adamw and a
    profiler window over DEPLOY_PROFILE, its Chrome trace under the
    Tensorboard's logspath where TensorBoard's profile plugin looks."""
    cfg = study_config("adamw")
    cfg.update(profile_dir=str(logspath / "plugins" / "profile" / DEPLOY_JOB),
               profile_start_step=DEPLOY_PROFILE[0],
               profile_steps=DEPLOY_PROFILE[1])
    return cfg


def _trace_kernel_events(path: Path) -> dict:
    """Each flash kernel's events in a Chrome trace (a seam: a rehearsal
    off the card, where no kernel runs, replaces it)."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    events = json.loads(path.read_text())["traceEvents"]
    return {n: sum(1 for e in events if e.get("cat") == "kernel"
                   and f"{n}_kernel" in e.get("name", ""))
            for n in fa.SM90}


def _deploy_apply(cluster, card_product: str) -> dict:
    """Phase 37 (1): the TpuDef through `Coordinator.apply` twice, its
    holds; returns what the later steps need."""
    import importlib.util

    from kubeflow_tpu_torch.control.jaxjob import types as JT
    from kubeflow_tpu_torch.control.k8s import objects as ob
    from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
    from kubeflow_tpu_torch.tpctl import manifests
    from kubeflow_tpu_torch.tpctl.apply import Coordinator, GkeGpuPlatform
    from kubeflow_tpu_torch.tpctl.tpudef import COND_AVAILABLE, TpuDef

    gcloud = GcloudDouble()
    provider = GkeGpuPlatform(runner=gcloud)
    coord = Coordinator(cluster, provider=provider,
                        registry=MetricsRegistry())
    cfg = TpuDef(name=DEPLOY_NAME, platform="gke-gpu", project="card",
                 zone="local", accelerator=card_product, gpus=1)
    pool = provider.pool_name(cfg)
    t = time.perf_counter()
    stored = coord.apply(cfg)
    available_s = time.perf_counter() - t
    machine, per_node = provider.MACHINE_TYPES[card_product]
    want = {"--project": "card", "--zone": "local", "--cluster": DEPLOY_NAME,
            "--machine-type": machine,
            "--accelerator": f"type={card_product},count={per_node}",
            "--num-nodes": "1",
            "--node-labels": f"{JT.NODESELECTOR_ACCEL}={card_product},"
                             f"{JT.NODESELECTOR_POOL}={pool}"}
    creates = [c for c in gcloud.calls if c[3] == "create"]
    if len(creates) != 1 or gcloud.pools.get(pool) != want:
        fail(f"deploy path: create commands {creates}, want one for pool "
             f"{pool} with {want}")
    if not ob.cond_is_true(stored, COND_AVAILABLE):
        fail(f"deploy path: TpuDef status {stored.get('status')}")
    rendered = manifests.render(cfg)

    def stored_objects() -> dict:
        return {(o["kind"], o["metadata"]["name"]):
                o["metadata"]["resourceVersion"] for o in cluster.dump()
                if o["kind"] != "TpuDef"}

    before = stored_objects()
    if set(before) != {(o["kind"], o["metadata"]["name"]) for o in rendered}:
        fail(f"deploy path: stored {sorted(before)}, rendered "
             f"{sorted((o['kind'], o['metadata']['name']) for o in rendered)}")
    again = coord.apply(cfg)
    if [c[3] for c in gcloud.calls].count("create") != 1 or \
            not ob.cond_is_true(again, COND_AVAILABLE) or \
            stored_objects() != before:
        fail("deploy path: the second apply created a pool or wrote an "
             "object")
    launched = manifests.launched_modules(rendered)
    unported = {manifests.MODULES[n] for n in manifests.UNPORTED}
    wrong = {m: found for m in launched
             if (found := importlib.util.find_spec(m) is not None)
             == (m in unported)}
    if wrong:
        fail(f"deploy path: modules against their port status (True: found "
             f"though listed unported): {wrong}")
    return {"coord": coord, "cfg": cfg, "gcloud": gcloud, "pool": pool,
            "rendered": rendered, "available_s": available_s,
            "machine": f"{machine}, {card_product} x {per_node} a node",
            "modules": (len(launched) - len(unported), len(unported))}


def deploy_path_phase(root, card: str) -> dict:
    """Phase 37: the platform's deploy path on the port's FakeCluster, in
    this process, its one launcher through `Spawned`. (1) Deploy
    (`_deploy_apply`): `Coordinator.apply` of a TpuDef with platform
    gke-gpu, the card's product in GKE's spelling and a pool of its one
    GPU, the provider's runner a GcloudDouble: one create command with
    the machine type, accelerator, node count and labels; a second apply
    creates nothing and writes no object; TpuDefAvailable True; every
    rendered object stored; every rendered `python -m
    kubeflow_tpu_torch....` of a ported component resolves (`find_spec`)
    and those of the unported ones (`manifests.UNPORTED`) do not. The
    node the phase then adds for the card carries the labels the create
    command set. (2) Admit: the PodDefault webhook's own `serve()` on
    127.0.0.1 (plain HTTP: TLS is held on the CPU, and nothing here
    imports `utils/tlscerts`) behind a cluster admission hook that
    posts each pod's AdmissionReview and applies the JSONPatch it
    answers; a PodDefault selecting the job's pods injects
    KFTPU_TRACE_FILE under the Tensorboard's logspath. (3) Train: a
    JAXJob of 1 replica of 1 GPU, the default command (the port's
    launcher) on `deploy_config`, run by the JAXJob controller, the gang
    scheduler and the LocalPodExecutor: the bound pod claims
    nvidia.com/gpu: 1 with the product and node-pool selectors and
    carries the PodDefault's env and annotation; the job ends Succeeded;
    the span dump is at the injected path with one train.step span a
    step; the launcher logs phase 36's count of each flash kernel. (4)
    Inspect: a Tensorboard CR on that logspath; its controller renders a
    Deployment of TENSORBOARD_IMAGE whose --logdir is the logspath; the
    one Chrome trace under it holds each flash kernel's events for the
    profiled steps' launches. (5) Reap: the job and the Tensorboard (their
    children go with them), then `Coordinator.delete` (the double's pool
    gone, every rendered object and the TpuDef with it); every process
    reaped. Prints the seconds from apply to Available, launch to first
    step, the step time and the phase's seconds; returns the trial's
    launches."""
    import base64
    import datetime
    import os
    import urllib.request

    import torch

    from kubeflow_tpu_torch.control.jaxjob import types as JT
    from kubeflow_tpu_torch.control.jaxjob.controller import (
        build_controller as build_jobs, worker_name)
    from kubeflow_tpu_torch.control.k8s import objects as ob
    from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
    from kubeflow_tpu_torch.control.poddefault import webhook as PW
    from kubeflow_tpu_torch.control.runtime import seed_controller
    from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
    from kubeflow_tpu_torch.control.scheduler.scheduler import build_scheduler
    from kubeflow_tpu_torch.control.tensorboard import controller as TB
    from kubeflow_tpu_torch.obs import trace as obs_trace

    t_phase = time.perf_counter()
    product = gke_product(torch.cuda.get_device_name(0))
    cluster = FakeCluster()

    # (1) deploy: the pool through the double, the manifests, Available
    dep = _deploy_apply(cluster, product)
    pool, gcloud = dep["pool"], dep["gcloud"]
    labels = GcloudDouble.labels(gcloud.pools[pool])
    node = cluster.create(new_gpu_node("gpu-node-0", product=product,
                                       node_pool=pool, gpus=1, labels=labels))
    if {k: ob.labels_of(node).get(k) for k in labels} != labels:
        fail(f"deploy path: node labels {ob.labels_of(node)}, the create "
             f"set {labels}")

    # (2) admit: the webhook over HTTP as the cluster's admission hook
    root = Path(root)
    logspath = root / "logs"          # the board's volume: it exists
    logspath.mkdir()
    trace_file = logspath / f"{DEPLOY_JOB}.spans.jsonl"
    cfg_path = root / "train.json"
    cfg_path.write_text(json.dumps(deploy_config(logspath)))
    informer = _PodDefaultInformer(cluster)
    webhook = PW.PodDefaultMutator(informer).serve(
        host="127.0.0.1", port=0).serve_background()
    admitted: list[str] = []

    def admit(verb: str, obj: dict) -> dict:
        if verb != "CREATE" or obj.get("kind") != "Pod":
            return obj
        review = {"apiVersion": "admission.k8s.io/v1",
                  "kind": "AdmissionReview",
                  "request": {"uid": obj["metadata"]["name"],
                              "namespace": obj["metadata"].get(
                                  "namespace", DEPLOY_NS),
                              "object": obj}}
        req = urllib.request.Request(
            f"http://127.0.0.1:{webhook.port}/apply-poddefault",
            data=json.dumps(review).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            answer = json.loads(resp.read())["response"]
        if not answer.get("allowed"):
            raise ob.Invalid(f"admission refused {obj['metadata']['name']}")
        if answer.get("patch"):
            obj = ob.json_patch(obj, json.loads(base64.b64decode(
                answer["patch"])))
        admitted.append(obj["metadata"]["name"])
        return obj

    cluster.add_admission_hook(admit)
    cluster.create(PW.new_poddefault(
        "trace-to-logs", DEPLOY_NS,
        selector={"matchLabels": {JT.LABEL_JOB_NAME: DEPLOY_JOB}},
        desc="span dumps under the Tensorboard's logspath",
        env=[{"name": "KFTPU_TRACE_FILE", "value": str(trace_file)}]))

    # (3) train: the JAXJob through the controller, scheduler and kubelet
    ctls = (seed_controller(build_jobs(cluster)),
            seed_controller(build_scheduler(cluster, record_events=False)),
            seed_controller(TB.build_controller(cluster)))

    def env_hook(pod, env):
        env.update(JAXRT_METRICS_PORT="0",
                   OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2)))
        return env

    job = JT.new_jaxjob(DEPLOY_JOB, DEPLOY_NS, replicas=1, product=product,
                        node_pool=pool, gpus_per_worker=1, gang_schedule=True)
    job["spec"]["template"]["spec"]["containers"][0]["args"] = [
        "--config", str(cfg_path)]
    pod_name = worker_name(DEPLOY_JOB, 0)
    seq: list[str] = []
    state: dict[str, str] = {}
    with Spawned() as spawned:
        kubelet = _services_kubelet(cluster, spawned, root, env_hook=env_hook)
        try:
            def pump():
                for ctl in ctls:
                    ctl.run_until_idle(advance_delayed=True)
                kubelet.poll_once()
                got = cluster.get_or_none(JT.API_VERSION, JT.KIND,
                                          DEPLOY_JOB, DEPLOY_NS)
                for kind, now in _conditions(got or {}).items():
                    if state.get(kind) != now:
                        state[kind] = now
                        seq.append(f"{kind}={now}")
                return got

            def wait(what: str, cond):
                deadline = time.monotonic() + DEPLOY_TIMEOUT
                while not (out := cond(pump())):
                    if time.monotonic() > deadline:
                        for e in kubelet.logs:
                            print(f"--- {e['name']} rc {e.get('rc')}\n"
                                  + Path(e["path"]).read_text(
                                      errors="replace")[-4000:], flush=True)
                        fail(f"deploy path: no {what} within "
                             f"{DEPLOY_TIMEOUT} s; job conditions {seq}")
                    time.sleep(0.1)
                return out

            def bound(_):
                p = cluster.get_or_none("v1", "Pod", pod_name, DEPLOY_NS)
                return p if p and p["spec"].get("nodeName") and not \
                    p["spec"].get("schedulingGates") else None

            cluster.create(job)
            pod = wait("bound pod", bound)
            c0 = pod["spec"]["containers"][0]
            env = {e["name"]: e.get("value") for e in c0.get("env") or []}
            if not (c0["resources"]["limits"] == {JT.RESOURCE_GPU: 1}
                    and pod["spec"]["nodeSelector"] == {
                        JT.NODESELECTOR_ACCEL: product,
                        JT.NODESELECTOR_POOL: pool}
                    and pod["spec"]["nodeName"] == "gpu-node-0"
                    and c0["command"] == list(JT.DEFAULT_COMMAND)
                    and env.get("KFTPU_TRACE_FILE") == str(trace_file)
                    and f"{PW.ANNOTATION_PREFIX}/poddefault-trace-to-logs"
                    in ob.annotations_of(pod) and admitted == [pod_name]):
                fail(f"deploy path: the bound pod {json.dumps(pod)[:2000]}; "
                     f"admitted {admitted}")
            done = wait("the job's end", lambda j: j and (
                ob.cond_is_true(j, JT.COND_SUCCEEDED)
                or ob.cond_is_true(j, JT.COND_FAILED)) and j)
            runs = [e for e in kubelet.logs if e["name"] == pod_name]
            out = Path(runs[-1]["path"]).read_text(errors="replace") \
                if runs else ""
            if not ob.cond_is_true(done, JT.COND_SUCCEEDED) or \
                    [e.get("rc") for e in runs] != [0]:
                print(out[-6000:], flush=True)
                fail(f"deploy path: the job did not succeed: {seq}; runs "
                     f"{[e.get('rc') for e in runs]}")
            summaries = [ln for ln in out.splitlines()
                         if ln.startswith('{"summary"')]
            summary = json.loads(summaries[-1])["summary"] if summaries \
                else {}
            loss = (summary.get("final") or {}).get("loss")
            first = re.search(r"^(\S+ \S+) .*first step \(incl\. kernel "
                              r"build\)", out, re.M)
            if loss is None or not math.isfinite(loss) or first is None:
                print(out[-6000:], flush=True)
                fail(f"deploy path: final loss {loss}, first step logged "
                     f"{first is not None}")
            to_first = datetime.datetime.strptime(
                first.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp() - \
                runs[0]["started"]
            launches = _world_launches({"launches": _logged_launches(out)[0]},
                                       STUDY_STEPS, "deploy path trial")
            if not trace_file.exists():
                fail(f"deploy path: no span dump at {trace_file}")
            steps = sum(1 for s in obs_trace.read_jsonl(str(trace_file))
                        if s.name == "train.step")
            if steps != STUDY_STEPS:
                fail(f"deploy path: the span dump holds {steps} train.step "
                     f"spans, want {STUDY_STEPS}")

            # (4) inspect: a Tensorboard on the logspath, its trace
            cluster.create(TB.new_tensorboard("profiles", DEPLOY_NS,
                                              str(logspath)))
            board = wait("the Tensorboard's Deployment", lambda j:
                         cluster.get_or_none("apps/v1", "Deployment",
                                             "profiles", DEPLOY_NS))
            c_board = board["spec"]["template"]["spec"]["containers"][0]
            if f"--logdir={logspath}" not in c_board["command"] or \
                    c_board["image"] != JT.TENSORBOARD_IMAGE:
                fail(f"deploy path: the Tensorboard's container {c_board}")
            traces = sorted(logspath.rglob("trace_*.json"))
            window = re.search(r"profiler: tracing steps \[(\d+), (\d+)\)",
                               out)
            if len(traces) != 1 or window is None:
                fail(f"deploy path: traces under the logspath {traces}, "
                     f"window logged {window is not None}")
            profiled = min(int(window.group(2)), STUDY_STEPS) - \
                int(window.group(1))
            events = _trace_kernel_events(traces[0])
            want = {n: launches[n] // STUDY_STEPS * profiled for n in events}
            if events != want or profiled != DEPLOY_PROFILE[1]:
                fail(f"deploy path: the trace's flash kernel events "
                     f"{events}, want {want} over {profiled} profiled steps")

            # (5) reap: the job and the board, their children with them
            cluster.delete(JT.API_VERSION, JT.KIND, DEPLOY_JOB, DEPLOY_NS)
            cluster.delete(TB.API_VERSION, TB.KIND, "profiles", DEPLOY_NS)
            wait("the job's pod and the board's Deployment gone", lambda j:
                 j is None and not cluster.list("v1", "Pod",
                                                namespace=DEPLOY_NS)
                 and cluster.get_or_none("apps/v1", "Deployment", "profiles",
                                         DEPLOY_NS) is None)
        finally:
            kubelet.shutdown()
            webhook.shutdown()
            informer.stop()
    coord, cfg = dep["coord"], dep["cfg"]
    coord.delete(cfg)
    left = [(o["kind"], o["metadata"]["name"]) for o in dep["rendered"]
            if cluster.get_or_none(o["apiVersion"], o["kind"],
                                   o["metadata"]["name"],
                                   o["metadata"].get("namespace"))]
    if gcloud.pools or coord.status(DEPLOY_NAME) is not None or left:
        fail(f"deploy path: after the delete, pools {list(gcloud.pools)}, "
             f"TpuDef {coord.status(DEPLOY_NAME) is not None}, rendered "
             f"objects left {left}")
    print(f"deploy path ({card}): TpuDef {DEPLOY_NAME} on gke-gpu, pool "
          f"{pool} ({dep['machine']}, 1 node) through the gcloud double; "
          f"apply to Available {dep['available_s']:.3f} s, "
          f"{len(dep['rendered'])} objects, the second apply a no-op; "
          f"rendered modules {dep['modules'][0]} found, {dep['modules'][1]} "
          f"unported and absent; job {DEPLOY_JOB} conditions "
          f"{' -> '.join(seq)}, admitted with KFTPU_TRACE_FILE by the "
          f"webhook over HTTP; launch to first step {to_first:.2f} s; step "
          f"{1e3 * summary['step_time_s']:.1f} ms; final loss {loss}; "
          f"launches {launches}; {steps} train.step spans in the dump; the "
          f"Tensorboard's trace holds {events} kernel events over "
          f"{profiled} profiled steps (launches {want}); deleted, the pool "
          f"gone; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"deploy_trial": launches}


# -- phase 38: the observability plane over a paged replica ------------------

# The replica: SERVICE_REF at full width and depth with seeded weights,
# bf16, 16 decode slots, prompts of exactly 512 and 64 new tokens, and a
# paged KV cache of pages of 64 tokens sized to hold "held" requests at
# once: admission reserves a request's ceil((512 + 64) / 64) = 9
# pages up front (serving/continuous.py `_admit_paged`), so 8 x 9 = 72
# usable pages (plus the trash page) read 0 free while requests wait.
OBS = {"ref": SERVICE_REF, "vocab": SERVICE_VOCAB, "prompt": 512, "new": 64,
       "slots": 16, "page": 64, "held": 8, "requests": 16,
       "dtype": "bfloat16"}
OBS_TICK = 15.0                 # the plane's scrape interval, virtual s
OBS_FOR = 30.0                  # KVPagesExhausted's for-duration
OBS_TIMEOUT = 240               # seconds any one wait of the phase may take
OBS_POLL = 0.05                 # real seconds between ticks under load


class _VirtualClock:
    """The plane's clock: the phase sets ``t``."""

    t = 0.0

    def __call__(self) -> float:
        return self.t


def _on_this_host(url: str) -> str:
    """A replica address as the controller publishes it
    (`http://<pod>.<service>.<namespace>.svc:<port>`) resolved to this
    host: the phase's stand-in for the cluster's DNS, as phase 35's
    router transport is."""
    from urllib.parse import urlsplit, urlunsplit

    parts = urlsplit(url)
    return urlunsplit(parts._replace(netloc=f"127.0.0.1:{parts.port}"))


def obs_plane_phase(root, card: str, cfg: dict = OBS) -> None:
    """Phase 38: the observability plane over a paged serving replica on
    the card. The port's FakeCluster holds a JAXService `chat` (min 1,
    max 2 replicas); one reconcile of the port's JAXService controller
    makes its replica pod, whose command (`python -m
    kubeflow_tpu_torch.serving` with the spec's model, prompt, tokens,
    slots and dtype) the phase runs through `Spawned` with the paged
    cache's flags added (`--kv-pages`, `--kv-page-size`, no prefix
    cache); once it answers /readyz the pod reads Running, and the next
    reconcile publishes its address in the endpoints annotation with
    status.targetReplicas 1. The port's router runs in-process in front
    of it (its own MetricsRegistry), an AvailabilityProber probes its
    /healthz into a registry of its own before every tick, and a
    FleetPlane on a virtual clock (OBS_TICK a tick) discovers the
    replica through `jaxservice_targets(cluster)` (`_on_this_host`
    resolving the published name), scrapes the router's and the
    prober's registries, runs `default_rule_pack()` and a
    RemediationEngine over `default_remediations(client=cluster)`.
    Holds, before load (after one warm-up request through the router):
    up 1, serving_kv_pages_free the usable pages, kubeflow_availability
    1. Under load (cfg["requests"] prompts of exactly cfg["prompt"]
    tokens, distinct by seed, through the router at once): once the
    replica's own /metrics reads the cache exhausted while requests
    wait, a tick at t0 reads free 0 while more requests are inside the
    replica than the cache holds, and the ticks at t0 + 15 s and + 45 s
    take KVPagesExhausted pending -> firing with service "chat" and
    namespace "default" (an attempt whose three ticks do not all read 0
    is retried while requests are queued, after a tick that clears the
    pending alert it left); one executed jaxservice-scale-up decision in
    the audit, the nudge annotation "2", and one reconcile leaves
    status.targetReplicas 2 and the annotation cleared, with no second
    process started. After load: every request 200 with cfg["new"]
    tokens in range, and the next tick resolves the alert;
    `ServingSLO.from_store` over the load's window counts what
    `from_registry` counted on the router's registry since the first
    tick (the warm-up is in both registry reads: the router's latency
    histogram is born at its first observation, so the plane's first
    sample of it is 1, not 0), fast and total, total cfg["requests"];
    the slo:router_p95:short series exists. SIGTERM to the replica: the
    next tick reads up 0, no instant serving_kv_pages_free (the
    staleness markers) and kubeflow_availability 0. A TsdbPersister
    snapshot restored into a fresh store answers the phase's queries at
    each held instant as the plane did. The script's process launches no
    flash kernel (the replica decodes in its own). Prints the replica's
    launch to serving, the scrape and rule-pass ms on the host clock
    (not held), the virtual seconds from first exhaustion to firing and
    the phase's seconds."""
    import concurrent.futures as cf
    import signal
    import statistics
    import urllib.request

    from kubeflow_tpu_torch.control.jaxservice import types as T
    from kubeflow_tpu_torch.control.jaxservice.controller import (
        build_controller)
    from kubeflow_tpu_torch.control.k8s import objects as ob
    from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
    from kubeflow_tpu_torch.control.runtime import seed_controller
    from kubeflow_tpu_torch.metric_collector.prober import AvailabilityProber
    from kubeflow_tpu_torch.obs import expofmt
    from kubeflow_tpu_torch.obs import goodput as gp
    from kubeflow_tpu_torch.obs.events import EventRecorder
    from kubeflow_tpu_torch.obs.persist import TsdbPersister
    from kubeflow_tpu_torch.obs.plane import FleetPlane
    from kubeflow_tpu_torch.obs.remediate import (RemediationEngine,
                                                  default_remediations)
    from kubeflow_tpu_torch.obs.rules import Evaluator
    from kubeflow_tpu_torch.obs.trace import TraceCollector
    from kubeflow_tpu_torch.obs.tsdb import (RegistryTarget, TimeSeriesStore,
                                             jaxservice_targets)
    from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
    from kubeflow_tpu_torch.serving import router as R

    t_phase = time.perf_counter()
    ns, name = "default", "chat"
    replica = T.replica_name(name, 0)
    instance = f"{ns}/{replica}"
    # pages reserved at admission, for every request the cache holds
    usable = cfg["held"] * -(-(cfg["prompt"] + cfg["new"]) // cfg["page"])
    # the phase's reads: what each tick holds and what the restored
    # store must answer alike
    queries = {
        "up": f'up{{instance="{instance}"}}',
        "free": f'serving_kv_pages_free{{instance="{instance}"}}',
        "queue": f'serving_queue_depth{{instance="{instance}"}}',
        "availability": f'kubeflow_availability{{target="{replica}"}}',
        "alerts": 'ALERTS{alertname="KVPagesExhausted"}',
        "p95": 'slo:router_p95:short{service="chat"}',
        "requests": 'sum(router_requests_total{outcome="completed"})',
    }
    port = _free_port()
    cluster = FakeCluster()
    svc = T.new_jaxservice(name, ns, model=cfg["ref"], model_name=name,
                           min_replicas=1, max_replicas=2, port=port)
    svc["spec"]["model"].update(
        promptLen=cfg["prompt"], maxNewTokens=cfg["new"],
        decodeSlots=cfg["slots"], continuousBatching=True,
        paramDtype=cfg["dtype"])
    cluster.create(svc)
    ctl = seed_controller(build_controller(cluster,
                                           registry=MetricsRegistry()))
    ctl.run_until_idle()
    pod = cluster.get("v1", "Pod", replica, ns)
    cmd = list(pod["spec"]["containers"][0]["command"])
    if cmd[:3] != ["python", "-m", "kubeflow_tpu_torch.serving"] or \
            cmd[cmd.index("--port") + 1] != str(port):
        fail(f"obs plane: the replica pod's command {cmd}")
    cmd[0] = sys.executable
    cmd += ["--kv-pages", str(usable + 1), "--kv-page-size",
            str(cfg["page"]), "--no-prefix-cache", "--host", "127.0.0.1"]
    vclock = _VirtualClock()
    router_reg, prober_reg, plane_reg = (MetricsRegistry(),
                                         MetricsRegistry(), MetricsRegistry())
    ms = {"scrape": [], "rules": []}
    fsvc = None
    ticks: list[dict] = []

    def discover():
        targets = jaxservice_targets(cluster)
        for t in targets:
            t.url = _on_this_host(t.url)
        return targets

    with Spawned() as spawned, open(root / "replica.log", "wb") as log:
        t_launch = time.perf_counter()
        proc = spawned.start(_replica_args(cmd), cwd=str(
            Path(__file__).resolve().parent), stdout=log,
            stderr=subprocess.STDOUT)

        def wait(what: str, cond, timeout: float = OBS_TIMEOUT,
                 alive: bool = True):
            deadline = time.monotonic() + timeout
            while not (out := cond()):
                if alive and proc.poll() is not None:
                    fail(f"obs plane: the replica exited {proc.returncode} "
                         f"waiting for {what}: " + (root / "replica.log")
                         .read_text(errors="replace")[-3000:])
                if time.monotonic() > deadline:
                    fail(f"obs plane: no {what} within {timeout} s: "
                         + (root / "replica.log").read_text(
                             errors="replace")[-3000:])
                time.sleep(0.05)
            return out

        wait("replica serving", lambda: _readyz(port))
        to_serving = time.perf_counter() - t_launch
        pod = cluster.get("v1", "Pod", replica, ns)
        pod["status"] = {"phase": "Running"}
        cluster.update_status(pod)
        ctl.run_until_idle()
        svc = cluster.get(T.API_VERSION, T.KIND, name, ns)
        eps = R.parse_endpoints(svc)
        addr = f"http://{replica}.{name}.{ns}.svc:{port}"
        if [(e["name"], e["addr"], e["state"]) for e in eps] != [
                (replica, addr, R.STATE_ACTIVE)] or \
                svc["status"].get("targetReplicas") != 1 or \
                not ob.cond_is_true(svc, T.COND_READY):
            fail(f"obs plane: the JAXService after the replica ran: "
                 f"endpoints {eps}, status {json.dumps(svc['status'])[:600]}")
        router = R.TokenRouter(service=name, namespace=ns,
                               registry=router_reg)
        router.sync_from_object(svc, transport_factory=lambda ep: (
            R.HttpTransport(_on_this_host(ep["addr"]))))
        front = R.RouterFrontend(router, max_new_tokens=cfg["new"])
        prober = AvailabilityProber(
            {replica: f"http://127.0.0.1:{port}/healthz"},
            registry=prober_reg)
        recorder = EventRecorder(cluster, component="obs-plane")
        remediator = RemediationEngine(default_remediations(client=cluster),
                                       recorder=recorder, registry=plane_reg,
                                       clock=vclock)
        plane = FleetPlane(
            registry=plane_reg, recorder=recorder,
            targets=[RegistryTarget("router", router_reg,
                                    labels={"job": "router"}),
                     RegistryTarget("prober", prober_reg,
                                    labels={"job": "prober"})],
            discover=discover, interval_s=OBS_TICK, clock=vclock,
            collector=TraceCollector(), remediator=remediator)

        def timed(fn, key):
            def run(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                ms[key].append(1e3 * (time.perf_counter() - t))
                return out
            return run

        plane.scraper.scrape_once = timed(plane.scraper.scrape_once, "scrape")
        plane.engine.evaluate_once = timed(plane.engine.evaluate_once,
                                           "rules")

        def tick(at: float) -> dict:
            vclock.t = at
            prober.probe_once()
            out = plane.tick(at=at)
            out["reads"] = {k: plane.query(q, at=at)["result"]
                            for k, q in queries.items()}
            ticks.append(out)
            return out

        def one(out: dict, key: str):
            """The one value a tick read for ``key``, else None."""
            vals = [r["value"] for r in out["reads"][key]]
            return vals[0] if len(vals) == 1 else None

        rng = random.Random(38)
        prompts = [[rng.randrange(1, cfg["vocab"])
                    for _ in range(cfg["prompt"])]
                   for _ in range(cfg["requests"] + 1)]
        fsvc = front.serve(host="127.0.0.1", port=0).serve_background()

        def post(prompt: list[int]) -> tuple[int, list[int]]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{fsvc.port}/v1/models/{name}:predict",
                data=json.dumps({"instances": [{"tokens": prompt}]}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=OBS_TIMEOUT) as resp:
                return resp.status, json.loads(resp.read())["predictions"][0]

        def held_answers(outs, what):
            bad = [(code, len(toks)) for code, toks in outs
                   if code != 200 or len(toks) != cfg["new"]
                   or not all(0 <= t < cfg["vocab"] for t in toks)]
            if bad:
                fail(f"obs plane: {what}: answers (status, tokens) "
                     f"{bad[:4]}, want 200 and {cfg['new']} ids in range")

        # before load: one warm-up request, then the first tick
        held_answers([post(prompts[-1])], "the warm-up")
        before = tick(OBS_TICK)
        reg_before = gp.ServingSLO().from_registry(router_reg, ns, name)
        got = (one(before, "up"), one(before, "free"),
               one(before, "availability"))
        if got != (1.0, float(usable), 1.0) or \
                before["scrape"]["failed"] != 0:
            fail(f"obs plane: before load up, free pages, availability "
                 f"{got}, want (1, {usable}, 1); scrape {before['scrape']}")
        # under load: read the replica's own /metrics until the cache is
        # exhausted while requests wait, then tick at t0, +15 s, +45 s;
        # an attempt whose ticks do not all read 0 free pages is retried
        # (after a tick that clears a pending alert it left) while
        # requests are still queued
        def replica_reads() -> tuple[float, float]:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                    body = r.read().decode()
            except OSError:
                return -1.0, 0.0
            got = {s.name: s.value for s in expofmt.parse(body)
                   if s.name in ("serving_kv_pages_free",
                                 "serving_queue_depth")}
            return (got.get("serving_kv_pages_free", -1.0),
                    got.get("serving_queue_depth", 0.0))

        def kv_alert_active() -> bool:
            return any(a["alert"] == "KVPagesExhausted"
                       for a in plane.engine.active_alerts())

        t_load = time.perf_counter()
        attempts, t0, fired = 0, None, None
        with cf.ThreadPoolExecutor(cfg["requests"]) as pool:
            futs = [pool.submit(post, p) for p in prompts[:cfg["requests"]]]
            deadline = time.monotonic() + OBS_TIMEOUT
            while fired is None and not all(f.done() for f in futs):
                if time.monotonic() > deadline:
                    fail(f"obs plane: no exhaustion within {OBS_TIMEOUT} s")
                free, queue = replica_reads()
                if kv_alert_active():
                    if free != 0.0:
                        tick(vclock.t + OBS_TICK)
                    time.sleep(OBS_POLL)
                    continue
                if not (free == 0.0 and queue > cfg["held"]):
                    time.sleep(OBS_POLL)
                    continue
                attempts += 1
                t0 = vclock.t + OBS_TICK
                run = [tick(t0)]
                if not (one(run[0], "free") == 0.0
                        and (one(run[0], "queue") or 0) > cfg["held"]):
                    continue
                run += [tick(t0 + OBS_TICK), tick(t0 + OBS_TICK + OBS_FOR)]
                if [one(o, "free") for o in run] != [0.0, 0.0, 0.0]:
                    continue
                trs = [[(t["alert"], t["to"], t["labels"].get("service"),
                         t["labels"].get("namespace"))
                        for t in o["transitions"]
                        if t["alert"] == "KVPagesExhausted"] for o in run]
                want = [[("KVPagesExhausted", "pending", name, ns)], [],
                        [("KVPagesExhausted", "firing", name, ns)]]
                if trs != want:
                    fail(f"obs plane: KVPagesExhausted transitions {trs} at "
                         f"{t0} / +15 / +45 s, want {want}")
                fired = run[2]
            outs = [f.result() for f in futs]
        load_s = time.perf_counter() - t_load
        if fired is None:
            fail(f"obs plane: the load ended ({load_s:.2f} s, {attempts} "
                 "exhausted reads) before three ticks read 0 free pages "
                 "in a row")
        held_answers(outs, f"{cfg['requests']} requests under load")
        decisions = [(d["action"], d["result"])
                     for d in plane.remediation_audit()["audit"]]
        if decisions != [("jaxservice-scale-up", "executed")] or \
                [(d["action"], d["result"]) for d in fired["remediations"]] \
                != decisions:
            fail(f"obs plane: remediation audit {decisions}, want one "
                 "executed jaxservice-scale-up at the firing tick")
        svc = cluster.get(T.API_VERSION, T.KIND, name, ns)
        nudge = ob.annotations_of(svc).get(T.ANNOTATION_SCALE_NUDGE)
        if nudge != "2":
            fail(f"obs plane: the scale nudge annotation {nudge!r}, want "
                 "'2'")
        reconciles = ctl.run_until_idle()
        svc = cluster.get(T.API_VERSION, T.KIND, name, ns)
        if svc["status"].get("targetReplicas") != 2 or \
                T.ANNOTATION_SCALE_NUDGE in ob.annotations_of(svc):
            fail(f"obs plane: after {reconciles} reconciles targetReplicas "
                 f"{svc['status'].get('targetReplicas')}, annotations "
                 f"{ob.annotations_of(svc)}")
        if len(spawned.procs) != 1:
            fail(f"obs plane: {len(spawned.procs)} processes started")
        # after load: the alert resolves; the SLO over the load's window
        after = tick(vclock.t + OBS_TICK)
        if ("KVPagesExhausted", "resolved") not in [
                (t["alert"], t["to"]) for t in after["transitions"]]:
            fail(f"obs plane: after load, transitions "
                 f"{after['transitions']} (free {one(after, 'free')})")
        reg_after = gp.ServingSLO().from_registry(router_reg, ns, name)
        window = vclock.t - OBS_TICK + 1.0      # back past the first tick
        store_slo = gp.ServingSLO().from_store(plane.store, vclock.t, window,
                                               service=name)

        def fast(s):
            return round(s["attainment"] * s["requests"])

        got = (fast(store_slo), store_slo["requests"])
        want = (fast(reg_after) - fast(reg_before),
                reg_after["requests"] - reg_before["requests"])
        if got != want or want[1] != cfg["requests"]:
            fail(f"obs plane: from_store (fast, total) {got}, from_registry "
                 f"since the first tick {want}, want total "
                 f"{cfg['requests']}")
        if plane.store.series_count("slo:router_p95:short") == 0:
            fail("obs plane: no slo:router_p95:short series")
        p95 = one(after, "p95")
        # the replica stops: up 0, its series stale, the prober reads 0
        proc.send_signal(signal.SIGTERM)
        wait("the replica's exit", lambda: proc.poll() is not None, 30,
             alive=False)
        stopped = tick(vclock.t + OBS_TICK)
        got = (one(stopped, "up"), stopped["reads"]["free"],
               one(stopped, "availability"))
        if got != (0.0, [], 0.0):
            fail(f"obs plane: after SIGTERM up, free pages, availability "
                 f"{got}, want (0, [], 0); the replica exited "
                 f"{proc.returncode}")
        # persistence: a snapshot restored answers the same
        persisted = TsdbPersister(plane.store, str(root / "tsdb"),
                                  clock=vclock).snapshot_now()
        fresh = TimeSeriesStore(max_points=plane.store.max_points,
                                max_series=plane.store.max_series)
        TsdbPersister(fresh, str(root / "tsdb")).restore()
        ev = Evaluator(fresh, lookback_s=plane.engine.evaluator.lookback_s)
        for out in (before, fired, after, stopped):
            at = out["scrape"]["at"]
            for q in queries.values():
                if ev.query(q, at) != plane.engine.query(q, at=at):
                    fail(f"obs plane: the restored store answers {q} at "
                         f"{at} with {ev.query(q, at)}, the plane with "
                         f"{plane.engine.query(q, at=at)}")
    if fsvc is not None:
        fsvc.shutdown()
    print(f"obs plane ({card}): replica {cfg['ref']} ({cfg['dtype']}, "
          f"{cfg['slots']} slots, {usable} usable pages of {cfg['page']}) "
          f"launch to serving {to_serving:.2f} s; {len(ticks)} ticks, "
          f"scrape ms median {statistics.median(ms['scrape']):.2f} max "
          f"{max(ms['scrape']):.2f}, rule pass ms median "
          f"{statistics.median(ms['rules']):.2f} max {max(ms['rules']):.2f} "
          f"(host clock, not held); first exhaustion at {t0:.0f} virtual "
          f"s ({attempts} exhausted read(s)), firing "
          f"{fired['scrape']['at'] - t0:.0f} virtual s later; "
          f"{cfg['requests']} requests in {load_s:.2f} s "
          f"({cfg['requests'] * cfg['new'] / load_s:.1f} tokens/s, not "
          f"held); nudge consumed in {reconciles} reconcile(s), "
          f"targetReplicas 2; resolved; SLO from the store {store_slo}, "
          f"p95 {p95}; stale on stop; snapshot of "
          f"{persisted['samples']} samples restored equal; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def beside(main: tuple, other: tuple) -> dict:
    """Run `other` (a function and its arguments) on a thread while
    `main` runs here; print each one's seconds and return both results
    merged. A failure of either fails the script, `other`'s only after it
    ended (so no process of it outlives the check that follows)."""
    import concurrent.futures as cf

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"{fn.__name__}: {time.perf_counter() - t:.1f} s (beside "
              "another phase)", flush=True)
        return out

    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(timed, *other)
        try:
            out = timed(*main)
        finally:
            got = fut.result()
    return {**out, **got}


class Lane:
    """One phase on a thread beside the phases the script runs meanwhile
    (`with Lane(phase_s, name, fn, *args) as lane:`); its seconds go into
    `phase_s`, its result into `lane.result`. While a lane is open it is
    `Lane.current`, and the script's phases skip the straggler check
    (the lane's processes are alive); the block's end waits for the
    lane's phase (whose own `finally`s reap its processes), raises its
    failure and checks for stragglers. A failure of the lane fails the
    script before the script's next phase starts (`raise_if_failed`)."""

    current: "Lane | None" = None

    def __init__(self, phase_s: dict, name: str, fn, *args):
        self.phase_s, self.name, self.call = phase_s, name, (fn, *args)
        self.result = None
        self.failure: BaseException | None = None
        self.thread = threading.Thread(target=self._run, name="lane")

    def _run(self) -> None:
        fn, *args = self.call
        t = time.perf_counter()
        try:
            self.result = fn(*args)
        except BaseException as e:      # fail() raises SystemExit
            self.failure = e
            return
        self.phase_s[self.name] = round(time.perf_counter() - t, 1)
        print(f"phase {self.name}: {self.phase_s[self.name]} s (on a lane "
              "beside the script's phases)", flush=True)

    def raise_if_failed(self) -> None:
        if self.failure is not None:
            raise self.failure

    def __enter__(self) -> "Lane":
        Lane.current = self
        self.thread.start()
        return self

    def __exit__(self, kind, err, tb) -> None:
        self.thread.join()
        Lane.current = None
        if err is None:
            self.raise_if_failed()
            check_no_stragglers(f"{self.name} and the phases beside it")


def earlier_phases_worker(argv: list[str]) -> int:
    """`--earlier-phases TREE`: the pinned training step, the pinned
    serving point and MoE serving as the checkout at TREE (this one or
    a parent's `git archive`) runs them, through that checkout's own
    chip_smoke.py and package. A comparison of two commits runs this
    once per tree in one call: parent, change, change, parent."""
    import importlib.util

    import torch

    tree = Path(argv[0]).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(tree):
        fail(f"the package came from {fa.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"earlier phases of {tree}: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    c.main_path(fa, _build, c.MAIN_PATH, "pinned")
    c.serving_pinned(card, cache_bytes=c.DENSE_CACHE_BYTES)
    c.moe_serving_phase()
    return 0


def main() -> int:
    t_start = time.perf_counter()
    become_subreaper()
    try:
        import torch
    except ImportError as e:
        fail(f"torch missing: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from kubeflow_tpu_torch.ops import _build
        from kubeflow_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          f"({', '.join(p.name for p in paths.values())})", flush=True)
    ptxas = _build.ptxas_report(paths)
    for name, by_d in sorted(ptxas.items()):
        for (dt, d), r in sorted(by_d.items()):
            print(f"  {name} {dt} head_dim {d}: {r.get('registers')} "
                  f"registers (ptxas, at launch), {r.get('spill_bytes')} "
                  "bytes spilled")
    built = {(n, dt, d) for n, by_d in ptxas.items() for dt, d in by_d}
    want = {(n, {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}[
        str(t).removeprefix("torch.")], d)
            for (t, d), names in fa.KERNEL_DOMAIN.items() for n in names}
    if built != want:
        fail(f"build log names kernels {sorted(built)}, want {sorted(want)}")
    spilled = {f"{n}[{dt}/{d}]": r.get("spill_bytes")
               for n, by_d in ptxas.items() for (dt, d), r in by_d.items()
               if r.get("spill_bytes") != 0}
    if spilled:
        fail(f"kernels spill registers (bytes, or no report): {spilled}")

    phase_s = {}

    def timed_phase(name, fn, *args, **kwargs):
        lane = Lane.current
        if lane is not None:
            lane.raise_if_failed()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name}: {phase_s[name]} s"
              + (f" (beside {lane.name}, on a lane)" if lane else ""),
              flush=True)
        if lane is None:
            check_no_stragglers(name)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def fresh(name: str) -> Path:
        root = _build.build_dir() / name
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        return root

    rows = timed_phase("kernels", kernel_phase, fa, ptxas)
    timed_phase("head", head_check)
    timed_phase("reference", reference_check)
    launches = {"d256_model": timed_phase("d256 model", d256_model_check, fa)}
    launches["entry"], at_entry = timed_phase("entry", entry_phase, fa)
    timed_phase("remat", remat_check, fa)
    step_s = {}
    for tag, cfg in (("adamw", ADAMW_PATH), ("pinned", MAIN_PATH)):
        launches[tag], step_s[tag] = timed_phase(
            f"main path {tag}", main_path, fa, _build, cfg, tag)
    timed_phase("grad accumulation", grad_accum_check, fa)
    for tag, cfg in (("pinned", MAIN_PATH), ("adamw", ADAMW_PATH)):
        timed_phase(f"profile {tag}", profile_phase, cfg, tag, steps=2)
    # The training runtime's subprocess launches (their counts come from
    # each launcher's log) on a lane, beside the LM over a serving mesh,
    # the control plane's services path (the scheduler process, the
    # JAXService controller, two replica servers and the router), then
    # the observability plane over a paged replica, then the MoE checks,
    # long-context dispatch and the router; the lane's
    # in-process part reaches no flash kernel, so this process's counts
    # over each of these are that path's. Then
    # serving from the resumed checkpoint, alone: its bf16 witness reads
    # the admission order of four concurrent requests.
    roots = [fresh(n) for n in ("chip_smoke_resume", "chip_smoke_mesh",
                                "chip_smoke_services", "chip_smoke_obs")]
    resume_root, mesh_root, svc_root, obs_root = roots
    try:
        with Lane(phase_s, "resume", resume_phase, card, step_s["pinned"],
                  resume_root) as lane:
            lm = timed_phase("mesh serving", mesh_serving_phase, mesh_root)
            fa.reset_launches()
            timed_phase("services path", services_phase, svc_root, card)
            launches["services"] = dict(fa.LAUNCHES)
            # the observability plane over a paged replica (its decode in
            # a process of its own): a check whose times nothing reads
            fa.reset_launches()
            timed_phase("obs plane", obs_plane_phase, obs_root, card)
            launches["obs_plane"] = dict(fa.LAUNCHES)
            # checks whose times nothing reads, while phase 15 runs on
            timed_phase("moe block", moe_block_phase)
            timed_phase("moe card vs cpu", moe_card_vs_cpu_phase)
            fa.reset_launches()
            timed_phase("moe serving", moe_serving_phase)
            launches["moe_serving"] = dict(fa.LAUNCHES)
            launches.update(timed_phase("long context", longctx_phase, fa,
                                        _build))
            fa.reset_launches()
            timed_phase("router", router_phase)
            launches["router"] = dict(fa.LAUNCHES)
        resumed = lane.result
        launches["resume"] = resumed["launches"]
        fa.reset_launches()
        timed_phase("serve from checkpoint", serve_checkpoint_phase,
                    resumed["checkpoint_dir"], resume_root)
        launches["serve_checkpoint"] = dict(fa.LAUNCHES)
    finally:
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    # The serving points, alone: their tokens/s and tick profiles are
    # measurements. The serving paths run no flash kernel (decode attends
    # by bmm over the cache); their counts are read like every path's.
    fa.reset_launches()
    # after a two-instance warm-up (not the reference's 31 requests: the
    # script's time), as the rolling and speculative points
    _, plain_outs = timed_phase("pinned serving", serving_pinned, card,
                                warm=False, cache_bytes=DENSE_CACHE_BYTES)
    launches["serving"] = dict(fa.LAUNCHES)
    fa.reset_launches()
    # 16 requests (the pinned point's 32 halved): the script's time
    timed_phase("rolling pinned", serving_pinned, card, tag="rolling pinned",
                requests=ROLLING_REQUESTS, warm=False,
                cache_bytes=ROLLING_CACHE_BYTES,
                attention_window=ROLLING_WINDOW, rolling_kv_cache=True)
    launches["rolling"] = dict(fa.LAUNCHES)
    fa.reset_launches()
    spec, spec_outs = timed_phase(
        "speculative pinned", serving_pinned, card, tag="speculative pinned",
        requests=SPEC_REQUESTS, warm=False, profile=False,
        cache_bytes=DENSE_CACHE_BYTES + 24 * 2 * 16 * SPEC_K * 16 * 64 * 2,
        draft_model=SPEC_DRAFT, draft_k=SPEC_K)
    launches["speculative"] = dict(fa.LAUNCHES)
    # bf16: a near-tie argmax can go either way between the verify chunk
    # and a single tick, so the share equal to plain greedy is printed
    pairs = [(a, b) for ra, rb in zip(spec_outs, plain_outs)
             for a, b in zip(ra, rb)]
    print(f"speculative pinned: acceptance {spec['acceptance_rate']:.4f} "
          f"({spec['spec_tokens_accepted']}/{spec['spec_drafted']}), "
          f"{spec['spec_rounds']} slot-rounds, "
          f"{spec['tokens_per_sec']:.1f} tokens/s, p50 "
          f"{spec['p50_ms']:.0f} ms, p95 {spec['p95_ms']:.0f} ms, peak "
          f"{spec['peak_mem_gb']:.2f} GB; tokens equal to plain greedy "
          f"(bf16, not held): {sum(a == b for a, b in pairs) / len(pairs):.3f}",
          flush=True)
    print("speculative pinned witness: " + timed_phase(
        "speculative witness", near_tie_witness, spec_outs,
        plain_outs[:SPEC_REQUESTS]), flush=True)
    # ResNet-50 through the launcher, alone (its images/s are a
    # measurement; its counts from the launcher's log line). Then the
    # checks whose times nothing reads here: the serving checks and
    # ResNet-50 against the CPU and behind the server; on a lane
    # beside them the classifiers on meshes (its one-process ViT serves
    # in this process and reaches no flash kernel either) with the
    # platform's deploy path beside it (its one trial's counts from its
    # launcher's log line)
    roots = [fresh(n) for n in ("chip_smoke_classify",
                                "chip_smoke_mesh_classify",
                                "chip_smoke_deploy")]
    cls_root, cls_mesh_root, deploy_root = roots
    try:
        launches["resnet50"] = timed_phase(
            "resnet50 launcher", resnet_launcher_phase, cls_root)["launches"]
        with Lane(phase_s, "mesh classifiers and deploy path", beside,
                  (mesh_classifier_phase, cls_mesh_root),
                  (deploy_path_phase, deploy_root, card)) as lane:
            timed_phase("serving check", serving_check)
            timed_phase("rolling check", rolling_check)
            timed_phase("speculative check", speculative_check)
            print("speculative pinned f32: " + timed_phase(
                "speculative pinned f32", speculative_pinned_f32),
                flush=True)
            fa.reset_launches()
            timed_phase("resnet50 card vs cpu", resnet_card_vs_cpu_phase)
            timed_phase("classifier server", classifier_server_phase,
                        str(cls_root / "resnet50_ckpt"))
            launches["classifier"] = dict(fa.LAUNCHES)
        vit = lane.result
        launches["deploy_trial"] = vit.pop("deploy_trial")
        launches["mesh_serving"] = {k: lm[k] + vit[k] for k in lm}
    finally:
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    for name in ("rolling", "speculative", "router", "serving",
                 "serve_checkpoint", "services", "obs_plane", "moe_serving"):
        if any(launches[name].values()):
            fail(f"the {name} path launched flash kernels in the script "
                 f"{launches[name]}: decode attends by bmm over the cache")
    # the classification models (ResNet-50 above), then ViT-B/16 and
    # BERT-base; none reaches a flash kernel
    timed_phase("profile resnet50", profile_phase, resnet_yaml_config(),
                "resnet50")
    for name in ENCODERS:
        launches[name] = timed_phase(name, encoder_phase, name,
                                     card)["launches"]
    for name in ("resnet50", "classifier", *ENCODERS):
        if any(launches[name].values()):
            fail(f"the {name} path launched flash kernels {launches[name]}"
                 ": the reference's classifiers reach no Pallas kernel")
    # The world on one card (launcher subprocesses, their counts from
    # each rank's log); on a lane beside it the control plane's job path
    # with phase 36's user path beside that (the port's controllers,
    # scheduler and kubelet run the gang and the StudyJob's two trials,
    # their counts from each rank's log; no check holds the times of
    # either). Then NCCL at one rank.
    roots = [fresh(n) for n in ("chip_smoke_world", "chip_smoke_job",
                                "chip_smoke_user")]
    world_root, job_root, user_root = roots
    try:
        with Lane(phase_s, "job and user paths", beside,
                  (job_path_phase, job_root, card),
                  (user_path_phase, user_root, card)) as lane:
            launches.update(timed_phase("world on one card", world_phase,
                                        world_root))
        launches.update(lane.result)
    finally:
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    timed_phase("nccl", nccl_phase)
    # mixture-of-experts training at one rank (its checks ran above),
    # then expert parallelism
    launches["moe_train"] = timed_phase("moe train", moe_train_phase, fa,
                                        _build)
    # one profiled step (the pinned config's three): the script's time
    timed_phase("profile moe", profile_phase, MOE_TRAIN, MOE_MODEL, steps=1)
    ep_root = fresh("chip_smoke_expert")
    try:
        launches.update(timed_phase("expert 2 on one card",
                                    expert_world_phase, ep_root))
    finally:
        shutil.rmtree(ep_root, ignore_errors=True)
    # the seq axis with local attention (and the owed Ulysses check), then
    # whole-forward remat for the classifiers
    seq_root = fresh("chip_smoke_seq")
    try:
        launches.update(timed_phase("seq on one card", seq_world_phase,
                                    seq_root))
    finally:
        shutil.rmtree(seq_root, ignore_errors=True)
    fa.reset_launches()
    timed_phase("classifier remat", classifier_remat_phase)
    launches["classifier_remat"] = dict(fa.LAUNCHES)
    # the launches of each instantiation that a path runs, counted by
    # instantiation: the bf16 head_dim 64 ones on the pinned main path, the
    # f32 head_dim 64 SIMT ones on phase 32's f32 rank 0, the bf16 head_dim
    # 256 ones on the D256 model check; no path runs the others (launches
    # null; their rows: the kernel phase's shapes). Beside them, every
    # path's count of the kernel over all its instantiations.
    for row in rows:
        k, inst = row["kernel"], (row["dtype"], row["head_dim"])
        paths = {"pinned": ("bfloat16", 64),
                 "seq_f32_rank0": ("float32", 64),
                 "d256_model": ("bfloat16", 256)}
        main = next((t for t, i in paths.items() if i == inst), None)
        if main is not None:
            row["launches"] = INSTANCE_COUNTS[main].get(row["name"], 0)
            row["launches_path"] = main
            row["kernel_launches_by_path"] = {t: n[k]
                                              for t, n in launches.items()}
        if k == "flash_fwd" and inst == ("bfloat16", 64):
            row["at_entry_shape"] = at_entry
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    check_no_stragglers("the end of the script")
    check_no_threads()
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world-worker"]:
        sys.exit(world_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--gloo-probe"]:
        sys.exit(gloo_probe_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--earlier-phases"]:
        sys.exit(earlier_phases_worker(sys.argv[2:]))
    sys.exit(main())
