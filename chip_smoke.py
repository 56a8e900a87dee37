"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

What it does (every phase fails the run if it fails), in this order save
that phases 9 and 10 run right after phases 6 and 7, and phases 12, 13 and
16 right after phase 5 (phases 14, 15 and 17-27 run last, after phase
11):

  1. prints the card's name and power limit (``nvidia-smi``);
  2. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
     (``nvcc``, ``sm_90a``; the build directory is emptied first) and prints
     the build time;
  3. kernel phase — holds each kernel against its plain PyTorch version on
     the card at the fleet path's shapes: ``spike_hist`` in float64 on a
     10,000 x 256 block with six bin sizes and values on and within 1e-12
     of every bin edge (counts exactly equal), in float32 at jobs = 1
     (exactly equal); ``ema_scan`` against its plain float32 version and
     against the float64 prefix doubling (tolerances below); the engine's
     blocked float64 EMA (``ema_scan_blocks``) against its plain twin,
     exactly, at the edge lengths (1, 255, 256, 257, 512, 4 x 256 + 3 and
     empty rows) for alpha 0.5, 1.0 and 0.999 with and without state, 300
     ragged rows, and the main path's three forms (a group advance of
     (10,000, 256), a snapshot of 42 pending views of 4-250 samples, a
     builder's (1, 256) ingest), each timed beside the eager composition it
     replaced and the bound; and times the
     kernels, their plain versions and the bound of each, a builder commit
     ((1, 256) float64 with ``divisor=`` and ``out=``, equal to the divide,
     bin, cast and add it replaced) and a diagnostic build of the
     histogram kernel with its divides replaced by multiplies (marked WRONG
     where its counts differ; never used by the port);
  4. card-vs-host phase — a small fleet (the micro zoo, 300 jobs) through the
     port on the card and on the CPU: reference-library traces, the
     engine's histograms and EMA state (filtered by the blocked EMA kernel
     on the card) must be bitwise equal, and so must every decision;
  5. main path — ``benchmarks/bench_fleet_scale.py``'s full configuration
     through the port on the card: ``build_reference_library`` (28
     workloads x 9 frequencies), 10,000 jobs of ``fleet_job_mix(seed=11)``
     on a zero-variability 64-device inventory, ``admit_many`` +
     ``run(mux)`` with ``repack="tick"``, a budget squeeze-and-release under
     ``count_classifier_calls``, and the bench's ground-truth budget check
     with every trace EMA-filtered on the card (``spikes.ema_filter``).  The
     decision counts must equal ``results/fleet_scale.json`` and every
     kernel must have launched during this phase, ``ema_scan`` in each of
     the library build, the fleet drive and the ground truth (counted
     apart);
  6. LM kernel phase — prints the flash library's ptxas report (registers,
     shared memory, spills) and the count of HGMMA (warpgroup MMA)
     instructions in its SASS (``cuobjdump -sass``), and fails if there is
     none; ``flash_attention`` (bfloat16 causal at glm4-9b's heads: b=4 x
     s=1024, the serving path's ragged s=1000 and s=2048, a cached-prefill
     sq < skv case, float32, head_dim 64 and 32, granite-moe-3b-a800m's
     prefill (4, 1000) and (1, 2048) with 24 query heads over 8 KV heads
     at head_dim 64, q, k, v read through the strides of a packed QKV
     tensor, and in bfloat16 and float32 every shape of the vlm and
     whisper paths: the vlm's causal self-attention at (4, 1000) and
     (1, 2048) and its non-causal cross-attention of those queries over
     1,600 image tokens, at 32 / 8 heads, dh 128; whisper's non-causal
     encoder over (4, 1500) and (1, 1500) frames at 16 / 16 heads, dh 64,
     its causal decoder at (4, 64) and (1, 384) and its cross-attention of
     those over 1,500; a phase-26 rank's shapes (the vlm's 8 / 2 heads,
     dh 128: bf16 causal (4, 1000) and float32 (4, 1000) over 1,600;
     whisper's 4 / 4, dh 64: float32 (4, 1500) and (4, 64) over 1,500,
     bf16 causal (4, 64)); ``train_lm_torch``'s (16, 128) causal at 10 / 2
     heads, dh 64; command-r-35b's (4, 1000) causal at 64 / 8 heads and
     at a phase-23 rank's 16 / 2, dh 128) and ``rmsnorm`` (bfloat16 at
     (4096, 4096), the prefill rows
     (4000, 4096) and the decode rows (4, 4096); float32; and the MoE
     paths' norms, bfloat16 rows and scale at granite's width 1536,
     deepseek's 5120, MLA's latent 512 and ``train_lm_torch``'s 640 over
     4000, 2048, 4 and 1 rows (deepseek's two and the vlm's 4096 over a
     phase-25 / 26 rank's 1000 rows too), and command-r-35b's 8192 over
     4000, 1000, 4 and 1 rows (one card's and a phase-23 rank's prefill,
     decode),
     with and without pdl), and ``ssm_scan`` at phase 24's shapes
     (jamba-1.5-large-398b's d_inner 16384 on one card and a rank's 4096,
     d_state 16: the (4, 1000) prefill with bf16 x, and a decode step with
     float32 and bf16 x advancing the state in place) against their plain
     versions on the card; times
     each kernel, its plain version and the one PyTorch call that computes
     the same function (``scaled_dot_product_attention``, ``rms_norm``) at
     the serving path's shapes (flash at (4, 1000), (4, 1024) and (1, 2048),
     at granite's (4, 1000) heads, and at the vlm's and whisper's ten
     shapes in the dtype each path runs, each with its bound); rmsnorm at the
     decode rows with and without
     programmatic dependent launch (pdl), the decode chain (81 pairs of a
     residual add and a norm, as one glm4-9b forward, for the kernel with
     and without pdl, ``rms_norm`` and the adds alone) and the host
     microseconds per ``ops.rmsnorm`` call;
  7. LM card-vs-host phase — the reduced glm4-9b (2 layers) with the same
     seeded weights on the card (kernels) and on the CPU (plain versions):
     prefill logits within 1e-4 with float32 parameters and within rtol
     2e-2 + atol 5e-2 with bfloat16 ones; teacher-forced decode logits and
     the caches (bfloat16 for both, as in the reference) within the latter;
  8. serving path — full-width glm4-9b (40 layers, 9.4 B bfloat16
     parameters, the port's seeded init) answers two requests through
     ``ServeEngine.generate``: 4 x 1000-token prompts and 1 x 2048, 32 new
     tokens each.  Tokens must be in range, every step's logits finite, and
     the kernels must have launched exactly as the model dictates (40 flash
     launches per prefill, 81 rmsnorm launches per forward, no scan);
  9. SSM kernel phase — prints ``ssm_scan``'s ptxas report and, per
     kernel, its SASS mix (``MUFU.EX2``, ``FFMA``, ``FMUL``, ``LDS``,
     ``SHFL``, ``BAR`` from ``cuobjdump -sass``; fails without an
     ``MUFU.EX2``); ``ssm_scan`` against its plain version on the card
     (y and h_last): bf16 and float32 at the prefill shapes (4, 1024, 8192,
     16) and (1, 2048, 8192, 16), the decode shape (4, 1, 8192, 16) with
     h0, 5-step tail blocks (s = 1029, at b = 4 and 2), a ragged case and
     ``tests/test_kernels.py``'s shapes, within that file's tolerances; the
     state advanced in place (h_out = h0, at (4, 1), (1, 1) and (2, 100))
     and the skip term left out as the model calls it; times of the kernel
     and the plain version, and the bound, at the serving path's prefill
     and decode shapes;
 10. Mamba card-vs-host phase — the reduced falcon-mamba-7b (2 layers) with
     the same seeded weights on the card and on the CPU, float32 and
     bfloat16 parameters: prefill logits, 8 teacher-forced decode steps and
     the state and conv caches within 1e-4 (float32) or rtol 2e-2 + atol
     5e-2 (bfloat16);
 11. Mamba serving path — full-width falcon-mamba-7b (64 layers, 7.3 B
     bfloat16 parameters, the port's seeded init; the glm4-9b engine is
     released first) answers 4 x 1024 and 1 x 2048 prompts, 32 new tokens
     each: tokens in range, logits finite, exactly 64 scan and 65 rmsnorm
     launches per forward (33 forwards a request) and no flash launch;
 12. session path — the outcome targets through
     ``repro_torch.api.MinosSession`` on the card, each ported from its
     bench (``benchmarks/`` is not imported) and held to its json:
     ``bench_fleet.py --smoke`` (``results/fleet.json``),
     ``bench_chaos.py --smoke``'s seeded fail / degrade / restore / fail
     schedule (``results/chaos.json``; the same drive on the host must
     leave bitwise the same engine columns), ``bench_recovery.py --smoke``
     (a child process drives the durable session on the card and SIGKILLs
     itself; this process resumes the store on the card:
     ``results/recovery.json``, 0 classifier calls) and
     ``bench_online_cap.py``'s 28 workloads on phase 5's library
     (``results/online_cap.json``); then phase 5's 10,000 jobs through
     ``submit_many`` + ``run()`` without and with a journal
     (``SCALE_SNAPSHOT_EVERY``), each with ``fleet_scale.json``'s counts
     (``repacks`` follows the session's per-decision cadence and is printed
     only), and a resume of that store with 0 classifier calls and every
     decision and plan equal to the live session's.  ``spike_hist`` and
     ``ema_scan`` must launch in every part (counted apart, the drains
     after a re-profile and after the resume included);
 13. discovery and the rest of ``core/`` — ``bench_discovery.py --smoke``
     through the port's ``MinosSession(discovery=...)`` on the card, held
     to ``results/discovery.json`` but its two latencies (printed): every
     count, the promoted class names, the baseline / before / after
     blocks, 0 classifier calls on the swap and on the resume (every
     classifier any library mints spied), resumed version 2, discovery-off
     identical; then the bench's full configuration (four novel families,
     1.0 s profiles) under the bench's asserts, its numbers printed.  In
     both, the resumed session takes one more arrival of each family,
     which must classify to its discovered class.  ``spike_hist`` and
     ``ema_scan`` must launch in each part (library, submissions,
     ``discover``, arrivals after the promotion, the resume and its
     arrivals; counted apart).  Then phase 12's 10,000-job session once
     more with ``discovery=True`` (quarantine only): every decision and
     plan equal to the plain session's, the quarantined count and jobs/s
     printed.  Last, on phase 5's library: the float32 Lloyd on the card
     bitwise equal to the host's for every (k, restart) of the silhouette
     sweep, and ``classification.json`` (Table 1's class columns, k_best,
     the silhouettes, the dendrogram), ``holdout.json`` and
     ``baseline_cmp.json`` exactly;
 14. MoE card-vs-host phase — the reduced granite-moe-3b-a800m,
     deepseek-v2-236b (MLA) and jamba-1.5-large-398b (Mamba, attention and
     MoE) with the same seeded weights on the card and on the CPU, float32
     and bfloat16 parameters: 2 x 100 prompts and 8 teacher-forced decode
     steps; the launches per forward checked exactly (flash per prefill /
     rmsnorm / ssm_scan per forward: granite 4 / 9 / 0, deepseek 0 / 13 /
     0, jamba 2 / 9 / 2); each MoE block's routing (every token's top-k
     experts in order) compared forward by forward and layer by layer (a
     choice that differs must be a near tie, and the prefill's MoE inputs
     before it agree within the tolerance); without a
     flip, the prefill logits within the parameters' tolerance and the
     decode logits and caches within rtol 2e-2 + atol 5e-2; then sublayer
     by sublayer, each card sublayer fed the host's input (and a copy of
     its cache slices at decode): every norm, block output, cache and the
     logits of the prefill and all 8 decode steps within the tolerance,
     whatever the whole models' routing does, and the routing of the same
     input equal up to float32 near ties; the smallest top-k margin of
     each MoE layer printed;
 15. MoE serving — granite-moe-3b-a800m at full width and depth (32
     layers, 3.375 B bfloat16 parameters), then, its engine released,
     deepseek-v2-236b at full width on 4 of its 60 layers (17.26 B), each
     answering phase 8's two requests, 32 new tokens each: tokens in range,
     logits finite, and exactly 32 flash per prefill and 65 rmsnorm per
     forward for granite, no flash and 13 rmsnorm per forward for
     deepseek, no scan;
 16. the paper's remaining tables — each bench's ``run()`` ported
     (``benchmarks/`` is not imported) and run on phase 5's library:
     ``savings.json`` (the abstract's 89 % profiling saving),
     ``freq_scaling.json``, ``binsize.json``, ``case_study.json`` (the
     held-out workloads' profiles built on the card, where ``spike_hist``
     and ``ema_scan`` must launch) and ``cdfs.json`` (the host simulator's
     traces, their CDFs and p90s on the card), each exactly;
 17. vlm and enc-dec card vs host — the reduced llama-3.2-vision-11b and
     whisper-medium with the same seeded weights and gates drawn in [0.5,
     1.5] (``seed_gates``; zero at init) on the card and on the CPU,
     float32 and bfloat16 parameters, float32 image embeddings or frames:
     prefill logits and every prefill cache (self and cross) within the
     parameters' tolerance, 8 teacher-forced decode steps and the bfloat16
     decode caches within rtol 2e-2 + atol 5e-2, launches exactly as the
     models dictate (flash per prefill / rmsnorm per forward: vlm 6 / 11,
     whisper 10 / 0);
 18. vlm and enc-dec serving — llama-3.2-vision-11b at full width and
     depth (40 layers, a gated cross-attention layer every 5th, 10.11 B
     bfloat16 parameters, gates drawn as in phase 17) answers phase 8's
     two requests with 1,600 image embeddings each, then, its engine
     released, whisper-medium (24 + 24 layers, 0.81 B) answers 4 x 64 and
     1 x 384 token prompts over 1,500 frames; 32 new tokens each: tokens
     in range, logits finite, exactly 48 flash per prefill and 89 rmsnorm
     per forward for the vlm, 72 flash and no rmsnorm for whisper, no scan;
     first token, decode ms/step and peak memory of each request printed;
 19. training checks — the flash backward library's ptxas registers and
     spills of every kernel and its HGMMA count (a bf16 product kernel
     without one fails), and the rmsnorm library's for every backward
     instantiation (a spill fails); the backward kernels against their
     plain twins on unit-scale inputs and gradients: ``flash_attention_bwd``
     (and the forward's ``lse`` within the forward's tolerance) at glm4-9b's
     heads (4, 1024) and (1, 4096) causal, granite-moe's (24 / 8, dh 64) at
     (4, 1024), the vlm's cross-attention (4, 1024 x 1600, 32 / 8, dh 128)
     and whisper's encoder (4, 1024, 16 / 16, dh 64), non-causal, dh 64
     and 32, non-causal 300 x 700, a ragged causal 333 and
     ``train_lm_torch``'s (16, 128, 10 / 2, dh 64) causal, each in
     bfloat16 (the wgmma kernels) and float32 (the SIMT kernels; ptxas
     must report no spill in any float32 instantiation), each shape's plan
     printed (tiles, split, CTAs); ``rmsnorm_bwd`` at glm4-9b's (4096,
     4096), granite-moe's (4096, 1536), deepseek's latent (4096, 512)
     and ``train_lm_torch``'s (2048, 640) with every pair of bfloat16 / float32 x and scale (each shape's plan
     printed: warps a row, rows a step, stages, CTAs); dq, dk, dv, dx,
     dscale within rtol = atol = 1e-4 (float32) or 2e-2 (bfloat16), two
     launches bitwise equal; the five training shapes in both dtypes,
     the four bf16 norms and the float32 (4096, 4096) norm timed
     beside their plain twins, their bounds (10 dh flops a visible pair
     at the bf16 tensor or the float32 rate; x and dy read, dx written),
     the library calls' forward + backward through autograd
     (``scaled_dot_product_attention`` with the KV heads repeated,
     ``F.rms_norm``) and, for the norm, a ``torch.add(x, dy, out=dx)``
     (the same bytes read and written: the byte floor).  Then the reduced
     glm4-9b, llama-3.2-vision-11b (gates drawn as in phase 17) and
     whisper-medium in float32, 3 ``Trainer`` steps each on the card and
     on the host from one seeded checkpoint: losses within 1e-5 relative,
     grad norms and parameters after step 3 within 1e-4 (whisper's key
     biases, whose gradient is zero up to rounding, within AdamW's reach
     of 2 lr a step), and the card's launches per step exactly as
     ``train_launches_of`` dictates (remat, one microbatch: 2L flash, L
     ``flash_attention_bwd``, 4L + 1 rmsnorm and 2L + 1 ``rmsnorm_bwd``
     for L dense layers; the vlm's cross sublayers add an attention and a
     norm each; whisper's E + 2D attentions, no rmsnorm).  Last, ``python -m
     repro_torch.launch.train --arch glm4-9b --smoke --steps 6
     --minos-cap powercentric`` on the card must print the reference's cap
     (``MINOS_CAP``), and ``--arch llama-3.2-vision-11b --smoke`` and
     ``--arch whisper-medium --smoke`` must each train 2 steps there.
     The selective scan's backward: the ``ssm_scan_bwd`` library's ptxas
     registers and spills (a spill fails, as does a report of fewer than
     its ``SSM_BWD_KERNELS`` kernels) and SASS mix, the layout
     ``bwd_plan`` gives each shape, the kernel against its plain
     twin at falcon-mamba-7b's training shape (4, 1024, 8192, 16) with bf16
     x and float32 dt and in float32 (both timed beside the twin and the
     bound, ``kernels.scan_bwd_work``), at 1 x 1000 (batch 1, an odd s),
     and with D, h0 and dh_last at (2, 100, 1024, 16) in both dtype pairs,
     a ragged (3, 77, 1000, 16) and ds = 37 (16 threads a channel): every
     output within ``SSM_TOL`` of its dtype scaled by max(1, max |plain|),
     two launches bitwise equal; the reduced falcon-mamba-7b and jamba in
     float32, 3 steps card vs host as above (the mamba rule: 2L
     ``ssm_scan`` and L ``ssm_scan_bwd`` for L Mamba sublayers, one norm
     each), and ``launch.train --arch falcon-mamba-7b --smoke`` and
     ``--arch jamba-1.5-large-398b --smoke`` 2 steps each on the card;
 20. training glm4-9b at full width on 8 of its 40 layers (2.873 B
     parameters, bfloat16, float32 AdamW moments, seeded init,
     ``SyntheticTokens``): 6 ``Trainer`` steps at 4 x 1024 with
     checkpoints at steps 3 and 6, a fresh ``Trainer`` resumed from step
     3 (steps 4-6 within rtol 1e-5 of the uninterrupted run; whether bit
     for bit is printed), then 6 steps at 1 x 4096; finite losses, the
     launches of every run exactly as phase 19's rule dictates, step ms
     (median of steps 2-6), tokens/s and peak GiB printed; then, the same
     way at 4 x 1024 without checkpoints, whisper-medium whole (0.81 B, 24
     + 24 layers, float32 frames: 144 flash, 72 ``flash_attention_bwd``
     launches a step, no rmsnorm) and llama-3.2-vision-11b on 10 of its 40
     layers (3.316 B, 2 gated cross sublayers over 1,600 float32 image
     embeddings), and falcon-mamba-7b at full width on 8 of its 64 layers
     (1.375 B parameters, 16.5 GB of train state; the whole model's 87.3
     GB does not fit): 16 ``ssm_scan``, 8 ``ssm_scan_bwd``, 17 rmsnorm and
     9 ``rmsnorm_bwd`` launches a step.  With ``--trace``, a glm4-9b, a
     whisper and a falcon-mamba-7b step are traced (whisper's device time
     split among the float32 backward and forward, the bf16 flash kernels,
     GEMMs and elementwise work; falcon-mamba's among the scan's backward
     and forward, the norms, GEMMs and elementwise work);
 21. the dry run against the card — glm4-9b on phase 20's 8 layers at 4 x
     1024 (prefill, one decode step at that cache, one train step) and
     falcon-mamba-7b's phase-20 train step, each counted on meta tensors
     by ``repro_torch.launch.dryrun.run_cell`` and then run once on the
     card under the same ``CostCounter`` and once under
     ``FlopCounterMode``: the two costs equal field by field, the kernel
     calls equal to ``build.LAUNCHES`` (reset just before), the counted
     product flops equal to ``FlopCounterMode``'s,
     the meta peak within 5 % of ``max_memory_allocated`` (less what was
     allocated before the cell's tensors were made); then each step
     timed (median of 5 after a warm-up) beside its roofline at the H100
     data sheet: ``t_compute``, ``t_memory``, ``bound_time``, bound over
     step and ``mfu`` (model flops over the step at 989 TFLOP/s);
 22. the tail of the reference — ``repro_torch.lint`` over the port's
     tree in this process (0 active findings; the counts printed), both
     facade examples (``examples/quickstart_torch.py``,
     ``examples/fleet_power_planner_torch.py``, each planner with a
     temporary store of its own) on the card and then on the host, their
     lines equal but the planner's build seconds and the byte count of the
     quickstart's report (which of them differed is printed), and
     ``spike_hist`` and ``ema_scan`` launched in each card run; then
     ``repro_torch.legacy``'s seed loops against the kernels on the card
     at ``tests/test_profiling_engine.py``'s tolerances: the float32 EMA
     within rtol 2e-4 + atol 2e-3 and the engine's blocked float64 EMA
     within 1e-9 of ``ema_filter_loop`` (3,000 samples, seed 3), and
     ``spike_hist`` over traces of 96·128, 1,280, 130, 125·128 and 250·128
     samples in float32 and float64 counting every sample >= 0.5 once,
     equal to the plain twin; then the two LM examples through their
     command lines: ``examples/serve_lm_torch.py --arch A`` for each of the
     ten archs (reduced, at the example's defaults: 4 requests of 32
     tokens, 24 sampled) on the card (its default device) and with
     ``--device cpu`` on the host, the request line and the prefill /
     decode counts equal (the wall time masked), 24 ids in the vocabulary
     on both (the generators differ), and the card's launches exactly what
     the reduced model dictates (flash per prefill, rmsnorm and
     ``ssm_scan`` per forward: ``serve_example_launches``), none on the
     host; each card request then replayed on the host with the card's
     weights, each decode step fed the id the card sampled: every
     forward's logits within ``LM_TOL[bf16]``, or, for the three archs
     with MoE blocks, every sublayer on the host's input
     (``serve_replay``); and ``examples/train_lm_torch.py`` at the
     reference example's defaults (the ~100M glm4 reduction, 300 steps of
     16 x 128, checkpoints
     every 100 steps under this run's temporary directory, removed after):
     every loss finite and the last below the first, three checkpoints,
     20 flash, 10 ``flash_attention_bwd``, 41 rmsnorm and 21
     ``rmsnorm_bwd`` launches a step (``train_launches(10)``), step ms
     (median and spread), tokens/s, checkpoint seconds and peak GiB
     printed; its Minos part launching ``spike_hist`` and ``ema_scan``,
     its line equal to the host's (``classify_job`` on the CPU);
 23. tensor-parallel serving — command-r-35b (32.38 B parameters, 64.8 GB
     in bfloat16: one card holds its weights only just) over a (1, 4)
     mesh with the reference's layouts (``models.common.Topo``): prints
     the cards there are and the group; with 4 cards or more, 4 NCCL
     processes (one a card) serve all 40 layers; with fewer, the 4 ranks
     are ``LocalGroup`` threads on the cards there are and serve 8 of the
     40 layers (said on a line of its own).  Either way the 4 ranks on 8
     of 40 layers, seeded as one card seeds, are held to the unsharded
     model on one card at 4 x 1000: prefill logits and 8 teacher-forced
     decode steps within ``LM_TOL[bf16]``, greedy ids equal on every rank
     and to one card's, a row up to a step where one card's choice is a
     near tie (one card's preference within the two logit rows'
     difference at the two tokens, and the ranks' own logits preferring
     the ranks' token; printed);
     every rank launches exactly L ``flash_attention`` a prefill and 2L +
     1 ``rmsnorm`` a forward (counted on the rank alone,
     ``build.rank_counts``); each rank's first-token ms, decode ms/step
     (median and spread), weights and peak GiB, and the bytes each
     collective took in a prefill and a decode step are printed;
 24. tensor-parallel MoE and Mamba serving — jamba-1.5-large-398b at full
     width (d_model 8192, 64 / 8 heads, d_inner 16384, 16 experts top 2,
     d_ff 24576) over a (1, 4) mesh, phase 23's path on its other blocks:
     the MoE's ``ep`` experts in prefill and ``ep_decode``'s d_ff columns in
     decode, the Mamba layers cut over their channels.  With 4 cards or
     more, 4 NCCL processes serve one whole published period (8 layers: 7
     Mamba + 1 attention, 4 MoE + 4 MLP; 90.5 GB in bfloat16, ~42 GB a
     rank); with fewer, 4 threads on the cards there are serve 2 of the 72
     layers at the reduction's interleave (layer 0 Mamba + MLP, layer 1
     attention + MoE).  Either way the 4 ranks on those 2 layers are held
     to the unsharded model on one card as in phase 23, the MoE routings
     recorded on both: every rank routes alike, the MoE inputs stay
     within ``LM_TOL[bf16]`` of one card's, a token the ranks route
     otherwise must be a near tie (one card's margin within the router
     noise those inputs cause), and only a row whose token was so
     rerouted may leave
     ``LM_TOL[bf16]`` or part its greedy ids (``tp_routes_part``); every
     rank launches exactly one ``flash_attention`` per attention layer and
     prefill, one ``ssm_scan`` per Mamba layer and forward and one
     ``rmsnorm`` per sublayer and forward plus the final one
     (``tp_launches``); the same times, memory and collectives as phase 23
     are printed;
 25. tensor-parallel MLA serving — deepseek-v2-236b at full width
     (d_model 5120, 128 heads, a 512 + 64 latent, 160 experts top 6, 2
     shared) over a (1, 4) mesh: MLA's heads cut in prefill (every rank
     computing the whole latent caches), its decode row-parallel over
     d_model with the latent caches sequence-sharded and ``w_kvb`` cut on
     its last dim (ranks 0-1 k_nope columns, ranks 2-3 value columns), the
     MoE as in phase 24.  With 4 cards or more, 4 NCCL processes serve 8 of
     the 60 layers (66.9 GB in bfloat16, 32.8 GB a rank); with fewer, 4
     threads serve the 2-layer check model (layer 0 MLA + dense MLP, layer
     1 MLA + MoE, so that the MoE is the last sublayer as in phase 24).
     The 4 ranks on those 2 layers are held to one card as in phase 24;
     every rank launches no flash and 3L + 1 ``rmsnorm`` a forward.
     Phase 25 draws the routed experts at their own fan-in
     (``seed_experts``: the seeded init's 1/sqrt(E) makes deepseek's MoE
     output dwarf the residual); phase 24 keeps the seeded init;
 26. tensor-parallel cross-attention serving — llama-3.2-vision-11b at
     full width over 1,600 image embeddings (all 40 layers on 4 NCCL
     cards, or one 5-layer period with its gated cross layer on the
     threads), then whisper-medium whole (24 + 24 layers) at 4 x 64 over a
     1,500-frame window (its encoder over the frames and its cross caches
     cut over them; the threads serve it 8 new tokens, not 32), both with
     gates and biases drawn away from 0
     (``seed_cross``) and held to one card as in phase 23; a vlm rank
     launches L + L/5 flash a prefill (the cross layers in float32) and 2L
     + L/5 + 1 ``rmsnorm`` a forward, a whisper rank 24 + 2 x 24 flash a
     prefill and no ``rmsnorm``;
 27. tensor-parallel training — glm4-9b and falcon-mamba-7b at full width
     over a (1, 4) mesh at 4 x 1024 (the residual cut over the sequence,
     the reference's train layouts: attention ``megatron`` over the heads,
     Mamba over its channels).  With 4 cards or more the ranks are 4 NCCL
     processes; with fewer, 4 gloo processes sharing the cards (threads
     cannot run backward passes on one card together; said on a line of
     its own).  (a) The check models, 2 of 40 and 2 of 64 layers, seeded
     as one card seeds them, against the unsharded model on one card for
     3 steps: each step's loss within rtol 2e-3 and grad norm within rtol
     2e-2, every rank's parameter and moment blocks after the last step
     within ``LM_TOL[bf16]`` of one card's (read on the card where one
     card keeps them), the leaves every rank holds whole bitwise equal
     across the ranks after every step, every rank launching a step what
     one card launches (``train_launches_of``: its heads and channels
     through the forward and backward kernels), its collectives a step
     (calls and bytes) equal to the meta count (``tp_train_counts``).  (b)
     With 4 cards, both whole (40 and 64 layers, ~28 GB and ~22 GB of
     train state a rank), 3 steps through ``launch.train.train_rank``:
     finite losses, the launches, step ms (median and range), tokens/s and
     each rank's peak GiB; skipped, and said so, with fewer cards.  (c)
     falcon-mamba-7b's check model: 4 uninterrupted steps, 2 with a
     checkpoint at step 2 (rank 0 writes the blocks gathered whole, 4.75
     GB), and a fresh spawn resumed from it: steps 3-4 within rtol 1e-5 of
     the uninterrupted run; the directory removed after.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a usable CUDA card the script
exits non-zero and prints no result.  Options: ``--trace`` adds one more
fleet drive and one more request of each served model under
``torch.profiler`` (device busy share, top operators, ``spike_hist``'s and
the blocked EMA's device time in the fleet drive, device ops per builder
commit and per blocked-EMA call of each form, which must be 1);
``--fleet-kernels-only``, ``--lm-kernels-only`` and ``--ssm-kernel-only``
build the kernels and run phase 3, 6 or 9 alone,
without a result line (for work on a kernel); ``--session-only`` and
``--discovery-only`` build them and the 28-workload library and run phase
12 alone or phases 13 and 16; ``--moe-only`` builds them and runs phases
14 and 15 alone (with ``--trace``, granite's traced request adds the
device time of the MoE blocks' routing, dispatch and combine beside their
expert products); ``--cross-only`` builds them and runs phases 17 and 18
alone; ``--train-only`` builds them and runs phases 19 and 20 alone;
``--dryrun-only`` builds them and runs phase 21 alone; ``--tail-only``
builds them and runs phase 22 alone; ``--tp-only`` builds them and runs
phases 23-26 alone; ``--tp-train-only`` builds them and runs phase 27
alone; ``--out DIR`` writes
the measurements (``chip_smoke.json``) and the trace tables
(``trace_summary.txt``, ``trace_serve_<arch>.txt``) into DIR.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis.hardware import H100  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.ema_scan import (ema_blocks_work,  # noqa: E402
                                          ema_rows_work)
from repro_torch.kernels.rmsnorm import norm_work  # noqa: E402
from repro_torch.kernels.spike_hist import hist_work  # noqa: E402

# H100 SXM data-sheet peaks (``analysis.hardware.H100``: HBM3 bandwidth; fp64
# and fp32 outside the tensor cores; bf16 dense on the tensor cores; exp on
# the special-function units)
HBM_BYTES_PER_S = H100.hbm_bw
PEAK_OPS = {"f64": H100.peak_flops_f64, "f32": H100.peak_flops_f32,
            "bf16_tensor": H100.peak_flops_bf16, "sfu_exp": H100.peak_exp}

BINS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.5)
FLEET = {"tpu-v5e": 32, "tpu-v5p": 16, "tpu-v6e": 16}
GATES = dict(min_confidence=0.2, min_fraction=0.1, min_spike_samples=50)
EMA_F32_TOL = 1e-5          # x max|x|: f32 rounding of an alpha=0.5 filter
SUSTAIN_WINDOW = 50

GLM = "glm4-9b"
# granite-moe-3b-a800m's prefill heads: 24 query heads over 8 KV heads
GRANITE_HEADS = dict(H=24, KV=8, dh=64)
# train_lm_torch's ~100M glm4 reduction: 10 query heads over 2 KV heads
LM_TRAIN_HEADS = dict(H=10, KV=2, dh=64)
# command-r-35b's heads on one card and on each rank of phase 23's (1, 4)
# mesh: a GQA group of 8 at head_dim 128
TP_HEADS = dict(H=64, KV=8, dh=128)
TP_RANK_HEADS = dict(H=16, KV=2, dh=128)
# a rank's heads at tp = 4 in phase 26: the vlm's 32 / 8 and whisper's
# 16 / 16
VLM_RANK_HEADS = dict(H=8, KV=2, dh=128)
WHISPER_RANK_HEADS = dict(H=4, KV=4, dh=64)
# tests/test_kernels.py's tolerances (bf16 rounding of the output, f32
# rounding of a softmax / mean of squares in another order)
KERNEL_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
              torch.float32: dict(rtol=3e-5, atol=3e-5)}
# tests/test_torch_models.py's tolerances for a whole model's logits/caches
LM_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=5e-2),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}
REQUESTS = ((4, 1000), (1, 2048))          # (batch, prompt tokens)
NEW_TOKENS = 32

MAMBA = "falcon-mamba-7b"
MAMBA_REQUESTS = ((4, 1024), (1, 2048))    # multiples of 128, as the
                                           # reference's prefill needs
# tests/test_kernels.py's ssm_scan tolerances: bf16 rounding of the output,
# float32 sums over the states in another order
SSM_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float32: dict(rtol=2e-4, atol=2e-4)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, iters: int, flush: torch.Tensor | None = None) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events around
    each call), with the 50 MB L2 cache flushed before each call when
    ``flush`` is given.  The card first spins for ~25 ms so that the host
    enqueues every call before the card reaches it: the events then time
    the card's work, not the host's launch overhead (a call that syncs
    inside, like the plain versions, still includes its host gaps)."""
    fn()
    torch.cuda.synchronize()
    events = []
    torch.cuda._sleep(50_000_000)
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def chain_time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of one call of ``fn`` (a chain of many launches)
    between two events, the L2 flushed before it; before each call the
    card spins for ~20 ms, so that the host has enqueued the whole chain
    before the card reaches it."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def edge_values() -> torch.Tensor:
    from repro_torch.core.spikes import SPIKE_LO, num_bins
    edges = torch.tensor([SPIKE_LO + k * c for c in BINS
                          for k in range(num_bins(c) + 1)],
                         dtype=torch.float64)
    up = torch.nextafter(edges, torch.full_like(edges, 10.0))
    down = torch.nextafter(edges, torch.full_like(edges, -10.0))
    return torch.cat([edges, up, down, edges + 1e-12, edges - 1e-12])


def kernel_phase(dev, flush) -> dict:
    from repro_torch.core.spikes import num_bins
    from repro_torch.kernels import (build, ema_scan_plain, ema_scan_rows,
                                     spike_hist_batch, spike_hist_batch_plain)
    nb = tuple(num_bins(c) for c in BINS)
    rng = np.random.default_rng(0)
    r = rng.uniform(0.0, 2.5, (10_000, 256))
    r[rng.random(r.shape) < 0.05] = -np.inf       # the engine's padding
    edges = edge_values().numpy()
    r.reshape(-1)[:len(edges)] = edges
    r.reshape(-1)[-len(edges):] = edges[::-1]
    rt = torch.from_numpy(r).to(dev)
    got = spike_hist_batch(rt, BINS, nb)
    want = spike_hist_batch_plain(rt, BINS, nb)
    torch.cuda.synchronize()
    err64 = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err64 != 0:
        raise AssertionError(f"spike_hist f64 disagrees with its plain "
                             f"version by {err64} counts")
    # float32 at jobs = 1 (ops.spike_hist's path), bin width (hi-lo)/n
    r32 = torch.from_numpy(rng.uniform(0.0, 2.2, (1, 4000))
                           .astype(np.float32)).to(dev)
    for n in (15, 30, 6):
        w = 1.5 / n
        a = spike_hist_batch(r32, (w,), (n,))
        b = spike_hist_batch_plain(r32, (w,), (n,))
        if not torch.equal(a, b):
            raise AssertionError(f"spike_hist f32 (n_bins={n}) disagrees "
                                 f"with its plain version")
    # ema_scan: against the plain f32 version and the f64 prefix doubling
    from repro_torch.core import spikes
    x64 = torch.from_numpy(rng.uniform(50.0, 300.0, 4_000)).to(dev)
    x32 = x64.to(torch.float32)
    k = ema_scan_rows(x32)
    p = ema_scan_plain(x32)
    ref64 = spikes.ema_filter(x64, backend="torch")
    torch.cuda.synchronize()
    err_plain = float((k - p).abs().max())
    err_f64 = float((k.to(torch.float64) - ref64).abs().max())
    tol = EMA_F32_TOL * float(x64.abs().max())
    if not (err_plain <= tol and err_f64 <= tol):
        raise AssertionError(f"ema_scan off: {err_plain} vs plain, {err_f64}"
                             f" vs f64, tolerance {tol}")
    rows_k = ema_scan_rows(torch.stack([x32, x32.flip(0)]))
    if not torch.equal(rows_k[0], k):
        raise AssertionError("ema_scan rows are not independent")
    log(f"kernel check: spike_hist f64 10000x256x6 bins max|err|={err64} "
        f"(exact), f32 jobs=1 exact; ema_scan n=4000 max|err| {err_plain:.3e}"
        f" vs plain f32, {err_f64:.3e} vs f64 (tolerance {tol:.3e})")
    before = dict(build.LAUNCHES)
    # timings at the fleet path's shapes, L2 flushed before every call
    t_hist1 = cuda_time_ms(lambda: spike_hist_batch(r32, (0.1,), (15,)), 30,
                           flush)            # jobs = 1 (ops.spike_hist)
    hist1 = hist_work(1, r32.shape[1], 4, 1, 15,
                      int((r32 >= 0.5).sum()))
    hist1_bytes = hist1["bytes"]
    hist1_bound = max(hist1_bytes / HBM_BYTES_PER_S,
                      hist1["flops"] / PEAK_OPS["f32"]) * 1e3
    log(f"spike_hist f32 jobs=1 (1, {r32.shape[1]}), 15 bins: kernel "
        f"{t_hist1:.4f} ms, bound {hist1_bound:.6f} ms ({hist1_bytes} B)")
    t_hist = cuda_time_ms(lambda: spike_hist_batch(rt, BINS, nb), 30, flush)
    t_hist_warm = cuda_time_ms(lambda: spike_hist_batch(rt, BINS, nb), 30)
    t_hist_plain = cuda_time_ms(
        lambda: spike_hist_batch_plain(rt, BINS, nb), 10, flush)
    commit = builder_commit(dev, flush, r[0] * 197.0, 197.0, nb)
    diag = divide_diagnostic(rt, nb, flush, t_hist)
    build.LAUNCHES.update(before)          # timing launches do not count
    n_spike = int((rt >= 0.5).sum())
    return {"spike_hist": dict(err=err64, ms=t_hist, plain_ms=t_hist_plain,
                               warm_ms=t_hist_warm, jobs1_ms=t_hist1,
                               jobs1_bound_ms=hist1_bound,
                               shape=list(rt.shape), n_spike=n_spike,
                               numel=rt.numel(), commit=commit,
                               divide_as_multiply=diag),
            "ema_scan": dict(err=err_plain, err_f64=err_f64),
            "ema_blocks": ema_blocks_phase(dev, flush)}


def builder_commit(dev, flush, power: np.ndarray, tdp: float, nb) -> dict:
    """One ``ProfileBuilder._commit`` of 256 float64 samples of power: the
    fused launch (divide by the TDP, bin, add into the float64 histograms)
    against the composition it replaced (divide, bin, cast, add), equal
    histograms required; times and the bound."""
    from repro_torch.core import spikes
    from repro_torch.kernels import spike_hist_batch
    arr = torch.from_numpy(power).to(dev)
    tdp_t = spikes.scalar(tdp, arr)
    hist = torch.zeros(sum(nb), dtype=torch.float64, device=dev)
    steps = torch.zeros_like(hist)

    def fused():
        spike_hist_batch(arr[None, :], BINS, nb, lo=spikes.SPIKE_LO,
                         divisor=tdp_t, out=hist[None, :])

    def composed():
        steps.add_(spike_hist_batch(arr[None, :] / tdp_t, BINS, nb,
                                    lo=spikes.SPIKE_LO)[0]
                   .to(torch.float64))
    fused()
    composed()
    torch.cuda.synchronize()
    if not torch.equal(hist, steps):
        raise AssertionError("the fused builder commit differs from divide, "
                             "bin, cast and add")
    n = arr.numel()
    n_spike = int((arr / tdp_t >= spikes.SPIKE_LO).sum())
    # samples, TDP, histograms read and written
    work = hist_work(1, n, 8, len(BINS), sum(nb), n_spike, divisor=1,
                     out=True)
    nbytes, ops = work["bytes"], work["flops"]
    bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["f64"]) * 1e3
    out = dict(shape=[1, n], ms=cuda_time_ms(fused, 50, flush),
               composed_ms=cuda_time_ms(composed, 50, flush),
               bound_ms=bound, bytes=nbytes, ops=ops)
    log(f"spike_hist builder commit (1, {n}) f64, divisor + out: fused "
        f"{out['ms']:.4f} ms, divide/bin/cast/add {out['composed_ms']:.4f} "
        f"ms, bound {bound:.6f} ms ({nbytes} B)")
    return out


# the diagnostic variant of csrc/spike_hist.cu: each bin size's divide
# replaced by a multiply with its reciprocal (WRONG at the bin edges: it is
# there to time what the float64 divides cost, never shipped)
DIVIDE_AS_MULTIPLY = [
    ("s_size[threadIdx.x] = static_cast<T>(a.sizes[threadIdx.x]);",
     "s_size[threadIdx.x] = static_cast<T>(1.0 / a.sizes[threadIdx.x]);"),
    ("const T q = shifted / s_size[b];", "const T q = shifted * s_size[b];"),
    ("sz[b] = static_cast<T>(a.sizes[b]);",
     "sz[b] = static_cast<T>(1.0 / a.sizes[b]);"),
    ("q = shifted / sz[b];", "q = shifted * sz[b];")]


def build_variants(source: str, variants: dict) -> dict:
    """name -> loaded library of ``csrc/<source>.cu`` with that name's text
    substitutions (``[[old, new], ...]``), each built with the port's nvcc
    flags into ``<build dir>/variants``, all at once; prints each build's
    registers (ptxas).  Raises if a substitution does not apply or a build
    fails."""
    import ctypes
    from repro_torch.kernels import build
    with open(os.path.join(build.CSRC, f"{source}.cu")) as f:
        src = f.read()
    out = os.path.join(build.build_dir(), "variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in "
                                 f"{source}.cu")
            text = text.replace(old, new)
        cu = os.path.join(out, f"{source}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            build.nvcc_command(cu, so),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        try:
            text, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{text}")
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in text.splitlines() if "Used" in ln})
        spills = max([int(m.group(1)) for m in re.finditer(
            r"(\d+) bytes spill stores", text)], default=0)
        serial = text.count("C7512")       # wgmma serialised by ptxas
        # the float32 flash backward's own entries (ptxas prints an entry's
        # spill line after its "Compiling entry" line)
        f32 = [int(m.group(1)) for m in re.finditer(
            r"Compiling entry[^\n]*_f32_kernel[^\n]*\n(?:[^\n]*Function "
            r"properties[^\n]*\n)?[^\n]*?(\d+) bytes spill stores", text)]
        log(f"{source} variant {name}: built, {', '.join(regs)}, at most "
            f"{spills} bytes of spill stores, {serial} kernels with wgmma "
            f"serialised (C7512)"
            + (f"; float32 kernels at most {max(f32)} bytes of spill stores"
               if f32 else ""))
        lib = ctypes.CDLL(so)
        for fn, argtypes in build._SIGNATURES[source].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def divide_diagnostic(rt, nb, flush, t_base: float) -> dict:
    """The divide-as-multiply variant through the same wrapper at the
    engine's shape: its time beside the shipped kernel's (and again after
    it, in turns), and whether its counts still equal the plain version's."""
    from repro_torch.kernels import build, spike_hist_batch
    from repro_torch.kernels import spike_hist_batch_plain
    lib = build_variants("spike_hist", {
        "divide_as_multiply": DIVIDE_AS_MULTIPLY})["divide_as_multiply"]
    shipped = build.library("spike_hist")

    def run():
        return spike_hist_batch(rt, BINS, nb)
    build._libs["spike_hist"] = lib
    try:
        exact = torch.equal(run(), spike_hist_batch_plain(rt, BINS, nb))
        t_var = cuda_time_ms(run, 30, flush)
    finally:
        build._libs["spike_hist"] = shipped
    t_again = cuda_time_ms(run, 30, flush)
    log(f"spike_hist divide as multiply (diagnostic"
        f"{'' if exact else ', WRONG'}): {t_var:.4f} ms against the "
        f"shipped kernel's {t_base:.4f} / {t_again:.4f} ms (before / after)")
    return dict(ms=t_var, base_ms=[t_base, t_again], exact=exact)


# the blocked float64 EMA's edge lengths: one sample, a block and one either
# side, two blocks, four blocks and three, and empty rows among them
EMA_EDGE_LENGTHS = (1, 255, 256, 0, 257, 512, 4 * 256 + 3, 0)


def ema_forms(dev) -> dict:
    """The profiling engine's three blocked-EMA call forms at the main path's
    shapes, each as ``kernel`` (the call the port makes), ``plain`` (the
    plain twin on the same inputs) and ``composed`` (the eager
    ``ema_filter_block`` composition the call site ran before), with the
    bytes and float64 operations of the work:

      * ``group``: a ``_advance_group`` of 10,000 rows, one 256-sample block
        each out of (10,000, 300) buffers, states read from and written to
        the engine's slot column;
      * ``snapshot``: a ``snapshot_batch`` of 42 slots' pending views, 4-250
        samples each with state, read at their slots;
      * ``ingest``: a ``ProfileBuilder`` chunk of 256 samples through
        ``_BlockedEMA.ingest`` (the reference library's build)."""
    from repro_torch.kernels import (ema_filter_block, ema_scan_blocks,
                                     ema_scan_blocks_plain)
    from repro_torch.pipeline.builder import _BlockedEMA
    rng = np.random.default_rng(23)
    cap = 16_384                       # the engine's capacity on the path
    col = torch.from_numpy(rng.uniform(0.0, 400.0, cap)).to(dev)
    hcol = torch.ones(cap, dtype=torch.bool, device=dev)
    forms = {}

    buf = torch.from_numpy(rng.uniform(0.0, 400.0, (10_000, 300))).to(dev)
    idx = torch.from_numpy(rng.permutation(cap)[:10_000]).to(dev)
    group = dict(n=256, index=idx, state_out=col, has_out=hcol)

    def group_composed():              # the eager _advance_group
        filt = torch.empty((10_000, 256), dtype=torch.float64, device=dev)
        out = ema_filter_block(buf[:, :256], col[idx], 0.5, 0.5)
        filt[:, :256] = out
        col[idx] = out[:, -1]
        hcol[idx] = True
    forms["group"] = dict(
        shape=[10_000, 256], rows=10_000, samples=10_000 * 256,
        row_bytes=8 + 8 + 8 + 1,       # index, state read and written, flag
        kernel=lambda: ema_scan_blocks(buf, col, True, 0.5, **group),
        plain=lambda: ema_scan_blocks_plain(buf, col, True, 0.5, **group),
        composed=group_composed)

    lengths = rng.integers(4, 251, 42)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    xs = torch.from_numpy(rng.uniform(0.0, 400.0, int(offs[-1]))).to(dev)
    slots = rng.permutation(cap)[:42]
    sidx = torch.from_numpy(slots).to(dev)
    snap = dict(offsets=offs, index=sidx)
    pieces = [(int(a), int(b), int(s)) for a, b, s in
              zip(offs, offs[1:], slots)]

    def snapshot_composed():           # the eager per-slot pending view
        for a, b, s in pieces:
            ema_filter_block(torch.cat([xs[a:b]]), col[s], 0.5, 0.5)
    forms["snapshot"] = dict(
        shape=[42, int(lengths.min()), int(lengths.max())], rows=42,
        samples=int(offs[-1]), row_bytes=8 + 8 + 1 + 8,   # + its bounds
        kernel=lambda: ema_scan_blocks(xs, col, hcol, 0.5, **snap),
        plain=lambda: ema_scan_blocks_plain(xs, col, hcol, 0.5, **snap),
        composed=snapshot_composed)

    chunk = torch.from_numpy(rng.uniform(0.0, 400.0, 256)).to(dev)
    ema = _BlockedEMA()
    ema.ingest(chunk)                  # from here on every block has state
    st0 = col[7]
    forms["ingest"] = dict(
        shape=[1, 256], rows=1, samples=256, row_bytes=8 + 8,
        kernel=lambda: ema.ingest(chunk),
        plain=lambda: ema_scan_blocks_plain(chunk, st0, True, 0.5),
        composed=lambda: ema_filter_block(torch.cat([chunk]), st0, 0.5, 0.5))
    for f in forms.values():
        work = ema_blocks_work(f["samples"], f["rows"], f["row_bytes"])
        f["bytes"], f["ops"] = work["bytes"], work["flops"]
        f["bound_ms"] = max(f["bytes"] / HBM_BYTES_PER_S,
                            f["ops"] / PEAK_OPS["f64"]) * 1e3
    return forms


def ema_blocks_check(dev) -> int:
    """``ema_scan_blocks`` against its plain twin on the card, exactly
    (``torch.equal``, the written state and flag columns included): the
    edge lengths at alpha 0.5, 1.0 and 0.999 with no state, every row's
    state and every other row's; one row with and without a 0-dim state
    (the builder's form); 300 ragged rows (bounds copied to the card); and
    the main path's three forms.  Returns the number of cases."""
    from repro_torch.kernels import ema_scan_blocks, ema_scan_blocks_plain
    rng = np.random.default_rng(29)
    n_cases = 0

    def check(what, x, state, has, alpha, commit=False, **kw):
        nonlocal n_cases
        got = []
        for fn in (ema_scan_blocks, ema_scan_blocks_plain):
            c = h = None
            if commit:
                c = state.clone()
                h = has.clone() if isinstance(has, torch.Tensor) else \
                    torch.zeros(state.numel(), dtype=torch.bool, device=dev)
            out = fn(x, state if c is None else c,
                     h if isinstance(has, torch.Tensor) and commit else has,
                     alpha, state_out=c, has_out=h, **kw)
            got.append([out] + ([c, h] if commit else []))
        torch.cuda.synchronize()
        for a, b in zip(*got):
            if not torch.equal(a, b):
                raise AssertionError(f"ema_scan_blocks {what} differs from "
                                     f"its plain version")
        n_cases += 1

    def ragged(lengths, cap):
        offs = np.concatenate([[0], np.cumsum(lengths)])
        x = torch.from_numpy(rng.uniform(0.0, 400.0, int(offs[-1]))).to(dev)
        col = torch.from_numpy(rng.uniform(0.0, 400.0, cap)).to(dev)
        idx = torch.from_numpy(rng.permutation(cap)[:len(lengths)]).to(dev)
        return x, col, idx, offs

    for alpha in (0.5, 1.0, 0.999):
        x, col, idx, offs = ragged(EMA_EDGE_LENGTHS, 64)
        check(f"edges alpha={alpha} no state", x, None, False, alpha,
              offsets=offs)
        for mode in ("all", "mixed"):
            has = torch.ones(64, dtype=torch.bool, device=dev)
            if mode == "mixed":
                has[idx[::2]] = False
            for commit in (False, True):
                check(f"edges alpha={alpha} {mode} state", x, col, has,
                      alpha, commit=commit, offsets=offs, index=idx)
        for n in EMA_EDGE_LENGTHS:
            row = x[:n]
            check(f"one row n={n} alpha={alpha}", row, None, False, alpha)
            check(f"one row n={n} alpha={alpha} with state", row, col[3],
                  True, alpha)
    x, col, idx, offs = ragged(rng.integers(0, 601, 300), 512)
    check("300 ragged rows", x, col, True, 0.5, commit=True, offsets=offs,
          index=idx)
    buf = torch.from_numpy(rng.uniform(0.0, 400.0, (10_000, 300))).to(dev)
    col = torch.from_numpy(rng.uniform(0.0, 400.0, 16_384)).to(dev)
    idx = torch.from_numpy(rng.permutation(16_384)[:10_000]).to(dev)
    for has in (False, True):
        check(f"group (10000, 256) has={has}", buf, col, has, 0.5,
              commit=True, n=256, index=idx)
    x, col, idx, offs = ragged(rng.integers(4, 251, 42), 16_384)
    has = torch.ones(16_384, dtype=torch.bool, device=dev)
    check("snapshot 42 x 4-250", x, col, has, 0.5, offsets=offs, index=idx)
    check("finalize 42 x 4-250", x, col, has, 0.5, commit=True,
          offsets=offs, index=idx)
    check("ingest (1, 256)", buf[0, :256], col[5], True, 0.5)
    return n_cases


def ema_blocks_phase(dev, flush) -> dict:
    """The blocked float64 EMA: the exact checks, then each main-path form's
    kernel, plain twin and old composition timed with the L2 flushed, beside
    the bound."""
    from repro_torch.kernels import build
    n_cases = ema_blocks_check(dev)
    log(f"kernel check: ema_scan_blocks f64 equals its plain version exactly "
        f"(torch.equal) in {n_cases} cases: edge lengths, alpha 0.5 / 1.0 / "
        f"0.999, with and without state, 300 ragged rows, the main path's "
        f"shapes")
    before = dict(build.LAUNCHES)
    out = {"cases": n_cases}
    for name, f in ema_forms(dev).items():
        r = dict(shape=f["shape"], bytes=f["bytes"], ops=f["ops"],
                 bound_ms=f["bound_ms"],
                 ms=cuda_time_ms(f["kernel"], 50, flush),
                 composed_ms=cuda_time_ms(f["composed"], 20, flush),
                 plain_ms=cuda_time_ms(f["plain"], 10, flush))
        out[name] = r
        log(f"ema_scan_blocks {name} {r['shape']} f64: kernel {r['ms']:.4f} "
            f"ms, old composition {r['composed_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bytes']} B)")
    build.LAUNCHES.update(before)          # timing launches do not count
    return out


def device_ops(fn, n: int) -> dict:
    """Device operations (kernels, memsets, copies) by name that ``n`` calls
    of ``fn`` ran, counted by ``torch.profiler``: only those that started
    inside a marked window around the calls, with one call before and one
    after it (a profile has been seen to drop an event at its edge).  The
    card idles 10 ms between each edge of the window and the nearest
    launch, since the device's timestamps are placed on the host's clock
    only approximately (a neighbour's kernel was once counted in)."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    cuda = torch.autograd.DeviceType.CUDA
    gap = 0.01
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(gap)
        with record_function("counted calls"):
            time.sleep(gap)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(gap)
        time.sleep(gap)
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    win = next(e for e in events if e.name == "counted calls"
               and e.device_type != cuda)
    ops: dict[str, int] = {}
    for e in events:
        if e.device_type == cuda and e.name != "counted calls" and \
                win.time_range.start <= e.time_range.start \
                <= win.time_range.end:
            ops[e.name] = ops.get(e.name, 0) + 1
    return ops


def ema_call_ops(dev, card: str, n: int = 20) -> dict:
    """Device operations per blocked-EMA call of each main-path form over
    ``n`` calls (``device_ops``): the kernel's (must be 1) and the old
    composition's."""
    out = {}
    for name, f in ema_forms(dev).items():
        per = {kind: sum(device_ops(f[kind], n).values()) / n
               for kind in ("kernel", "composed")}
        out[name] = per
        log(f"trace [{card}]: device ops per EMA call, {name}: kernel "
            f"{per['kernel']:g}, old composition {per['composed']:g}")
        if per["kernel"] != 1:
            raise AssertionError(f"a blocked-EMA call ({name}) ran "
                                 f"{per['kernel']} device ops, not 1")
    return out


def time_ema(dev, flush, n: int) -> tuple[float, float, float]:
    """Kernel and plain times of ``ema_scan`` on one trace of ``n`` samples,
    and the kernel's max |error| against the plain version there."""
    from repro_torch.kernels import build, ema_scan_plain, ema_scan_rows
    x = torch.from_numpy(np.random.default_rng(1).uniform(50, 300, n)
                         .astype(np.float32)).to(dev)
    before = dict(build.LAUNCHES)
    err = float((ema_scan_rows(x) - ema_scan_plain(x)).abs().max())
    if err > EMA_F32_TOL * 300:
        raise AssertionError(f"ema_scan at n={n} off by {err}")
    t = cuda_time_ms(lambda: ema_scan_rows(x), 50, flush)
    t_plain = cuda_time_ms(lambda: ema_scan_plain(x), 20, flush)
    build.LAUNCHES.update(before)
    return t, t_plain, err


# ---------------------------------------------------------------------------
# phases 4-5: the fleet path
# ---------------------------------------------------------------------------
def drive_fleet(lib, streams, counts, n_jobs, device, with_jobs=None):
    """bench_fleet_scale's drive through the port; returns the fleet, its
    result, the final packing, classifier calls on repack, timings and the
    per-group ground-truth inputs."""
    from repro_torch.core.classify import count_classifier_calls
    from repro_torch.fleet import (DeviceInventory, FleetCapController,
                                   FleetTelemetryMux, VariabilityModel)
    from repro_torch.telemetry import stream_telemetry
    inventory = DeviceInventory.generate(counts, VariabilityModel.none(),
                                         seed=7)
    jobs = with_jobs if with_jobs is not None else \
        [(streams[i % len(streams)], 32) for i in range(n_jobs)]
    assigned = [(s, chips, inventory[i % len(inventory)])
                for i, (s, chips) in enumerate(jobs)]
    nameplate = sum(chips * dev.nameplate_w for _, chips, dev in assigned)
    budget = 0.75 * nameplate
    seeds = {name: 500 + i for i, name in
             enumerate(sorted({s.name for s, _, _ in assigned}))}
    telemetry = {}
    for stream, _, dev in assigned:
        key = (stream.name, dev.model)
        if key not in telemetry:
            meta, chunks = stream_telemetry(
                stream, 1.0, dev.power_model(), seed=seeds[stream.name],
                target_duration=0.4, chunk_samples=256)
            telemetry[key] = (meta, list(chunks))
    fleet = FleetCapController(lib, budget_w=budget, provision_quantile="p99",
                               repack="tick", device=device, **GATES)
    mux = FleetTelemetryMux()
    t0 = time.perf_counter()
    job_ids = fleet.admit_many(
        dict(device=dev, meta=telemetry[(s.name, dev.model)][0], chips=c,
             job_id=f"j{i:05d}:{s.name}")
        for i, (s, c, dev) in enumerate(assigned))
    sync(device)
    t_admit = time.perf_counter() - t0
    for (s, _, dev), job_id in zip(assigned, job_ids):
        meta, chunks = telemetry[(s.name, dev.model)]
        mux.add_job(job_id, meta, chunks, device_id=dev.device_id)
    result = fleet.run(mux)
    sync(device)
    elapsed = time.perf_counter() - t0
    calls = count_classifier_calls(fleet.clf)
    fleet.set_budget(budget * 0.9)
    fleet.set_budget(budget)
    final = fleet.repacks[-1]
    return dict(fleet=fleet, result=result, final=final, calls=calls["n"],
                admit_s=t_admit, run_s=elapsed - t_admit, elapsed=elapsed,
                assigned=assigned, seeds=seeds, budget=budget)


def decision_key(d):
    s = d.selection
    return (d.target, d.cap, d.early, d.fraction, d.n_samples, d.device_id,
            s.bin_size, s.power_neighbor, s.util_neighbor, s.power_distance,
            s.util_distance, s.f_pwr, s.f_perf, d.confidence)


def card_vs_host_phase(dev) -> None:
    from repro_torch.kernels import build
    from repro_torch.pipeline import ReferenceLibrary, stream_profile_workload
    from repro_torch.telemetry import TPUPowerModel, kernel_stream as ks
    streams = [ks.micro_gemm(), ks.micro_spmv_memory(),
               ks.micro_spmv_compute(), ks.micro_idle_burst(),
               ks.micro_stencil()]
    model = TPUPowerModel()
    runs = {}
    build.reset_launches()
    for device in (dev, "cpu"):
        lib = ReferenceLibrary(
            (stream_profile_workload(s, model, (0.6, 0.8, 1.0),
                                     model.spec.tdp_w, seed=i,
                                     target_duration=1.0, device=device)
             for i, s in enumerate(streams)), built_on=model.spec.name,
            device=device)
        runs[str(device)] = (lib, drive_fleet(
            lib, streams, {"tpu-v5e": 4, "tpu-v5p": 2}, 300, device))
    (lib_c, card), (lib_h, host) = runs[str(dev)], runs["cpu"]
    if lib_c.fingerprint() != lib_h.fingerprint():
        raise AssertionError("reference traces built on the card differ "
                             "from the host's")
    for c in lib_c.bin_sizes:
        if not torch.equal(lib_c.spike_matrix(c).cpu(), lib_h.spike_matrix(c)):
            raise AssertionError(f"library spike matrix {c} differs")
    engine_columns_equal(card["fleet"].engine, host["fleet"].engine,
                         "the micro fleet")
    if build.LAUNCHES["ema_scan"] == 0:
        raise AssertionError("the micro fleet on the card ran no EMA kernel")
    dc, dh = card["result"].decisions, host["result"].decisions
    if [decision_key(d) for d in dc.values()] != \
            [decision_key(d) for d in dh.values()]:
        raise AssertionError("decisions on the card differ from the host's")
    if [p.job_id for p in card["final"].placed] != \
            [p.job_id for p in host["final"].placed]:
        raise AssertionError("placements on the card differ from the host's")
    log(f"card vs host: micro fleet of 300 jobs, {len(dc)} decisions, "
        f"library traces, engine histograms and EMA state bitwise equal "
        f"(blocked EMA on the card: {build.LAUNCHES['ema_scan']} launches)")


def ground_truth(run, dev) -> tuple[int, float, int]:
    """The bench's sustained-budget check; every group's trace is filtered
    on the card through ``spikes.ema_filter`` (the EMA kernel).  Returns the
    violations, the peak sustained watts and the median trace length."""
    from repro_torch.core import spikes
    from repro_torch.telemetry import simulate
    placed = {p.job_id: p for p in run["final"].placed}
    group_chips: dict[tuple, int] = {}
    for i, (stream, chips, d) in enumerate(run["assigned"]):
        plan = placed.get(f"j{i:05d}:{stream.name}")
        if plan is None:
            continue
        key = (stream.name, d.model, plan.cap)
        group_chips[key] = group_chips.get(key, 0) + plan.chips
    streams = {s.name: s for s, _, _ in run["assigned"]}
    models = {d.model: d.power_model() for _, _, d in run["assigned"]}
    traces = []
    for (name, model, cap), n_chips in sorted(group_chips.items()):
        sim = simulate(streams[name], cap, models[model],
                       seed=run["seeds"][name], target_duration=0.4)
        raw = torch.from_numpy(sim.power_raw).to(dev)
        filt = spikes.trim_idle(spikes.ema_filter(raw),
                                torch.from_numpy(sim.busy).to(dev))
        traces.append(filt * n_chips)
    n = max(len(t) for t in traces)
    agg = torch.zeros(n, dtype=torch.float64, device=dev)
    for t in traces:
        reps = -(-n // len(t))
        agg += t.repeat(reps)[:n]                 # np.resize semantics
    kernel = torch.full((1, 1, SUSTAIN_WINDOW), 1.0 / SUSTAIN_WINDOW,
                        dtype=torch.float64, device=dev)
    sustained = torch.nn.functional.conv1d(agg[None, None], kernel)[0, 0]
    return (int((sustained > run["budget"]).sum()), float(sustained.max()),
            int(np.median([len(t) for t in traces])))


def main_path(dev, want: dict):
    """Returns the reference library built on the card and the measurements;
    raises unless the counts equal ``want`` (results/fleet_scale.json)."""
    from repro_torch.kernels import build
    from repro_torch.pipeline import build_reference_library
    from repro_torch.telemetry import TPUPowerModel
    from repro_torch.telemetry.workloads import fleet_job_mix
    build.reset_launches()
    t0 = time.perf_counter()
    lib = build_reference_library(TPUPowerModel(), target_duration=3.0,
                                  device=dev)
    torch.cuda.synchronize()
    t_lib = time.perf_counter() - t0
    ema_lib = build.LAUNCHES["ema_scan"]
    log(f"reference library: {len(lib)} profiles x 9 frequencies built on "
        f"the card in {t_lib:.3f} s")
    run = drive_fleet(lib, None, FLEET, 10_000, dev,
                      with_jobs=fleet_job_mix(10_000, seed=11))
    ema_fleet = build.LAUNCHES["ema_scan"] - ema_lib
    t0 = time.perf_counter()
    violations, peak, ema_n = ground_truth(run, dev)
    torch.cuda.synchronize()
    t_truth = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] for k in ("spike_hist", "ema_scan")}
    # the blocked f64 EMA of the library's builders and of the fleet's
    # engine; the ground truth's traces through the f32 entry
    ema_split = {"library": ema_lib, "fleet": ema_fleet,
                 "ground_truth": launches["ema_scan"] - ema_lib - ema_fleet}
    res, final = run["result"], run["final"]
    got = {"decisions": len(res.decisions),
           "early_decisions": res.early_decisions,
           "repacks": res.repacks, "chunks_dropped": res.chunks_dropped,
           "placed": len(final.placed), "deferred": len(final.deferred),
           "clf_calls_on_repack": run["calls"],
           "budget_violations": violations}
    for key, value in got.items():
        if value != want[key]:
            raise AssertionError(f"{key}: port on the card {value}, "
                                 f"results/fleet_scale.json {want[key]}")
    rel = abs(final.planned_power_w - want["planned_power_w"]) \
        / want["planned_power_w"]
    if rel > 1e-9:
        raise AssertionError(f"planned_power_w {final.planned_power_w} vs "
                             f"{want['planned_power_w']} (rel {rel:.2e})")
    for name, n in {**launches, **{f"ema_scan ({k})": v
                                   for k, v in ema_split.items()}}.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    jobs_per_s = len(run["assigned"]) / run["elapsed"]
    log(f"main path: ema_scan launches {json.dumps(ema_split)}")
    log(f"main path: {json.dumps(got)} planned_power_w="
        f"{final.planned_power_w!r} (json {want['planned_power_w']}); "
        f"peak sustained {peak!r} W (json {want['peak_sustained_w']})")
    return lib, dict(got, planned_power_w=final.planned_power_w,
                peak_sustained_w=peak, library_s=t_lib,
                admit_s=run["admit_s"], run_s=run["run_s"],
                jobs_per_s=jobs_per_s, truth_s=t_truth, launches=launches,
                ema_launches=ema_split,
                engine_slots=run["fleet"].engine.capacity, ema_n=ema_n,
                row_loop_s=run["fleet"].engine.row_loop_s,
                repack_s=run["fleet"].repack_s)


def trace_phase(lib, dev, card: str, out: str | None) -> dict:
    """The fleet drive once more under ``torch.profiler``: the card's busy
    share of admit + run, and the operators that take the most device and
    host time (tables written to ``out/trace_summary.txt``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry.workloads import fleet_job_mix
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = drive_fleet(lib, None, FLEET, 10_000, dev,
                          with_jobs=fleet_job_mix(10_000, seed=11))
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # kernels and copies only: operator rows repeat their kernels' time
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = device_us / 1e6 / run["elapsed"]
    log(f"trace [{card}]: admit+run {run['elapsed']:.3f} s under the "
        f"profiler, device busy {device_us / 1e6:.3f} s = {busy:.2%} "
        f"(idle {1 - busy:.2%})")
    hist = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
            and "spike_hist" in e.key]
    hist_us = sum(e.self_device_time_total for e in hist)
    hist_n = sum(e.count for e in hist)
    log(f"trace [{card}]: spike_hist in admit+run: {hist_us / 1e3:.3f} ms of "
        f"device time over {hist_n} launches")
    ema = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
           and "ema_blocks" in e.key]
    ema_us = sum(e.self_device_time_total for e in ema)
    ema_n = sum(e.count for e in ema)
    log(f"trace [{card}]: ema_scan f64 blocks in admit+run: "
        f"{ema_us / 1e3:.3f} ms of device time over {ema_n} launches")
    if out is not None:
        by_dev = ka.table(sort_by="self_device_time_total", row_limit=15)
        by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=15)
        with open(os.path.join(out, "trace_summary.txt"), "w") as f:
            f.write(f"{card}\nadmit+run {run['elapsed']:.3f} s traced, "
                    f"device busy {device_us / 1e6:.3f} s ({busy:.3%}); "
                    f"spike_hist {hist_us:.1f} us over {hist_n} launches; "
                    f"ema_scan f64 blocks {ema_us:.1f} us over {ema_n} "
                    f"launches\n\n"
                    f"{by_dev}\n\n{by_cpu}\n")
    return dict(spike_hist_device_us=hist_us, spike_hist_launches=hist_n,
                ema_blocks_device_us=ema_us, ema_blocks_launches=ema_n)


def builder_commit_ops(dev, card: str, n: int = 20) -> dict:
    """Device operations (kernels, memsets, copies) per
    ``ProfileBuilder._commit`` of 256 samples over ``n`` commits of one
    builder on the card (``device_ops``)."""
    import itertools
    from repro_torch.pipeline import ProfileBuilder
    from repro_torch.telemetry import TraceMeta
    meta = TraceMeta(name="commit", domain="t", sample_dt=1e-3,
                     n_samples=256 * (n + 1), exec_time=1.0, app_sm_util=0.5,
                     app_dram_util=0.5)
    builder = ProfileBuilder(meta, 197.0, device=dev)
    arrs = itertools.cycle(
        [torch.from_numpy(np.random.default_rng(i).uniform(0, 400, 256))
         .to(dev) for i in range(n + 1)])
    ops = device_ops(lambda: builder._commit(next(arrs)), n)
    per = sum(ops.values()) / n
    log(f"trace [{card}]: device ops per builder commit {per:g} "
        f"({json.dumps(ops)} over {n} commits)")
    if per != 1:
        raise AssertionError(f"a builder commit ran {per} device ops, not 1")
    return dict(per_commit=per, ops=ops, commits=n)


# ---------------------------------------------------------------------------
# phases 6-8: the dense-LM serving path
# ---------------------------------------------------------------------------
def close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> float:
    """max |got - want|; raises unless |got - want| <= atol + rtol |want|."""
    got, want = got.float(), want.float().to(got.device)
    err = (got - want).abs()
    if not bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all()):
        raise AssertionError(f"{what}: max|err| {float(err.max()):.3e} beyond"
                             f" rtol {tol['rtol']} + atol {tol['atol']}")
    return float(err.max())


def attn_inputs(dev, b, sq, skv, dtype, seed, H=None, KV=None, dh=None):
    """q, k, v of normal values; glm4-9b's heads unless given."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[GLM]
    H, KV, dh = (H or cfg.num_heads, KV or cfg.num_kv_heads,
                 dh or cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, sq, H, dh), (b, skv, KV, dh), (b, skv, KV, dh))]


def packed_attn_inputs(dev, b, s, H, KV, dh, seed):
    """q, k, v as head slices of one packed (b, s, H + 2 KV, dh) tensor, as
    a fused QKV projection leaves them: strided, not contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, H + 2 * KV, dh), generator=g, device=dev)
    return list(qkv.to(torch.bfloat16).split([H, KV, KV], dim=2))


def build_report(source: str, ops: tuple[str, ...]) -> dict:
    """ptxas's registers / shared memory / spills for the library built
    from ``source``, as lines and per kernel (``ptxas_by_kernel``:
    registers, stack, spill store and load bytes) and, per kernel, the
    count of each opcode in ``ops`` in its SASS (``cuobjdump -sass``; an
    opcode counts with any suffix, so LDS counts every width but not
    LDSM)."""
    from repro_torch.kernels import build
    log_lines = str(build.BUILD_INFO.get(f"{source}_ptxas", "")).splitlines()
    ptxas = [ln.strip() for ln in log_lines
             if any(w in ln for w in ("Used", "spill", "Compiling entry",
                                      "arning", "Performance"))]
    by_entry, entry = {}, None
    for ln in log_lines:
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", ln)
        if m is not None:
            entry = m.group(1)
            by_entry.setdefault(entry, {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m is not None:
            by_entry[entry].update(stack=int(m.group(1)),
                                   spill_stores=int(m.group(2)),
                                   spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m is not None:
            by_entry[entry]["registers"] = int(m.group(1))
    bindir = os.path.dirname(build._nvcc())
    sass = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                           build.build_all()[source]],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    by_kernel, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            by_kernel[name] = dict.fromkeys(ops, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     ln)
        if m is None or name is None:
            continue
        for key in ops:
            if m.group(1) == key or m.group(1).startswith(key + "."):
                by_kernel[name][key] += 1
    filt = os.path.join(bindir, "cu++filt")

    def demangled(table: dict) -> dict:
        if not os.path.exists(filt) or not table:
            return table
        names = list(table)
        plain = subprocess.run([filt, *names], capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(plain) != len(names):
            return table
        return {p.strip(): table[n] for n, p in zip(names, plain)}
    return dict(ptxas=ptxas, ptxas_by_kernel=demangled(by_entry),
                sass=demangled(by_kernel))


# every flash shape (b, sq, skv, heads, causal) of phase 18's requests:
# the vlm's causal self-attention (32 / 8 heads, dh 128) and its
# cross-attention over 1,600 image tokens (sq > skv at 1 x 2048);
# whisper's encoder over 1,500 frames (16 / 16 heads, dh 64), its
# decoder's causal self-attention at the prompt lengths and its
# cross-attention over the encoder's output
VLM_HEADS = dict(H=32, KV=8, dh=128)
WHISPER_HEADS = dict(H=16, KV=16, dh=64)
VLM_WHISPER_FLASH = (
    (4, 1000, 1000, VLM_HEADS, True), (1, 2048, 2048, VLM_HEADS, True),
    (4, 1000, 1600, VLM_HEADS, False), (1, 2048, 1600, VLM_HEADS, False),
    (4, 1500, 1500, WHISPER_HEADS, False),
    (1, 1500, 1500, WHISPER_HEADS, False),
    (4, 64, 64, WHISPER_HEADS, True), (1, 384, 384, WHISPER_HEADS, True),
    (4, 64, 1500, WHISPER_HEADS, False),
    (1, 384, 1500, WHISPER_HEADS, False))
# each timed in the dtype its serving path runs it in: the float32 image
# embeddings and frames promote every non-causal one to float32
VLM_WHISPER_TIMED = tuple(
    (b, sq, skv, heads, causal,
     torch.bfloat16 if causal else torch.float32)
    for b, sq, skv, heads, causal in VLM_WHISPER_FLASH)


def time_flash(dev, flush, card: str, b, sq, skv, heads, causal,
               dtype) -> dict:
    """The kernel, its plain version and ``scaled_dot_product_attention``
    at one shape, with the bound (4 dh flops per visible pair at the
    dtype's peak: the tensor cores' for bf16, the SIMT float32 rate for
    float32; or the bytes)."""
    import torch.nn.functional as F
    from repro_torch.kernels import (attn_work, flash_attention,
                                     flash_attention_plain)
    q, k, v = attn_inputs(dev, b, sq, skv, dtype, 11 + sq + skv, **heads)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    if causal and sq != skv:
        raise ValueError("SDPA's causal mask is top-left when sq != skv")
    close(sdpa().transpose(1, 2), flash_attention_plain(q, k, v, causal),
          KERNEL_TOL[dtype], "scaled_dot_product_attention")
    flops, nbytes = attn_work(b, sq, skv, heads["H"], heads["KV"],
                              heads["dh"], q.element_size(), causal)
    peak = PEAK_OPS["bf16_tensor" if dtype == torch.bfloat16 else "f32"]
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    r = dict(b=b, s=sq, skv=skv, **heads, causal=causal,
             dtype=str(dtype).split(".")[1], flops=flops, bytes=nbytes,
             bound_ms=max(t_ops, t_bytes) * 1e3,
             bound_by="operations" if t_ops > t_bytes else "bytes",
             ms=cuda_time_ms(lambda: flash_attention(q, k, v, causal=causal),
                             20, flush),
             library_ms=cuda_time_ms(sdpa, 20, flush),
             plain_ms=cuda_time_ms(
                 lambda: flash_attention_plain(q, k, v, causal), 5, flush))
    r["tflops"] = flops / r["ms"] * 1e-9
    log(f"flash_attention {r['dtype']} b={b} sq={sq} skv={skv} "
        f"H={heads['H']} KV={heads['KV']} dh={heads['dh']} "
        f"{'causal' if causal else 'non-causal'} [{card}]: kernel "
        f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound), "
        f"scaled_dot_product_attention {r['library_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({flops:.4e} flop, {nbytes:.4e} B; {r['bound_by']})")
    return r


F32_SASS_OPS = ("FFMA", "FMUL", "FADD", "LDS")
# (b, sq, skv, H, KV, dh, causal): tests/test_torch_cuda.py's float32 edges
F32_EDGES = (
    (1, 63, 63, 8, 1, 128, True), (2, 64, 64, 8, 2, 64, False),
    (1, 65, 65, 4, 4, 32, True), (2, 65, 129, 8, 2, 128, True),
    (1, 1, 65, 8, 1, 64, True), (2, 129, 63, 8, 8, 32, False),
    (3, 127, 65, 96, 12, 128, False), (3, 128, 64, 96, 24, 64, False),
    (3, 129, 129, 96, 96, 128, True),
    (3, 128, 191, 96, 24, 128, True),
    (3, 1, 63, 96, 12, 64, True), (3, 200, 127, 96, 12, 64, False))


def lm_kernel_phase(dev, flush, card: str) -> dict:
    """Both LM kernels against their plain versions (and ``ssm_scan`` at
    phase 24's shapes), then timings of the kernel, the plain version and
    the library call at the serving path's shapes (launches made here do
    not count)."""
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import (build, flash_attention,
                                     flash_attention_plain, rmsnorm,
                                     rmsnorm_plain, ssm_scan, ssm_scan_plain)
    cfg = ARCHS[GLM]
    H, KV, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    report = build_report("flash_attention", ("HGMMA",) + F32_SASS_OPS)
    sass = report.pop("sass")
    report["hgmma_by_kernel"] = {k: c["HGMMA"] for k, c in sass.items()}
    report["hgmma"] = sum(report["hgmma_by_kernel"].values())
    for ln in report["ptxas"]:
        log(f"  flash_attention ptxas: {ln}")
    log(f"  flash_attention SASS: {report['hgmma']} HGMMA instructions "
        f"{json.dumps(report['hgmma_by_kernel'])}")
    if report["hgmma"] == 0:
        raise AssertionError("the flash_attention library has no HGMMA "
                             "(wgmma) instruction")
    # the float32 kernel: each instantiation's registers and spills, and
    # its SASS mix (its products must be FFMA, not FMUL + FADD)
    report["f32_ptxas"] = {k: r for k, r in
                           report["ptxas_by_kernel"].items()
                           if "fa_f32_kernel" in k}
    report["f32_sass"] = {k: {op: c[op] for op in F32_SASS_OPS}
                          for k, c in sass.items() if "fa_f32_kernel" in k}

    def short(name: str) -> str:           # fa_f32_kernel<(int)DH, (int)BM>
        m = re.search(r"fa_f32_kernel<[^>]*>", name)
        return m.group(0) if m else name
    for name, r in report["f32_ptxas"].items():
        log(f"  {short(name)} ptxas: "
            f"{r.get('registers')} registers, {r.get('stack')} bytes stack "
            f"frame, {r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads")
    for name, c in report["f32_sass"].items():
        log(f"  {short(name)} SASS: {json.dumps(c)}")
    if not report["f32_sass"] or \
            any(c["FFMA"] == 0 for c in report["f32_sass"].values()):
        raise AssertionError(f"fa_f32_kernel has no FFMA: "
                             f"{json.dumps(report['f32_sass'])}")
    before = dict(build.LAUNCHES)
    fa_err, rn_err = 0.0, 0.0
    # glm4-9b's heads at the serving shapes, a cached-prefill sq < skv case,
    # float32; then every other head_dim the kernel is built for, and q, k,
    # v read through the strides of a packed QKV tensor
    cases = [((4, 1024, 1024, torch.bfloat16), {}),
             ((4, 1000, 1000, torch.bfloat16), {}),
             ((1, 2048, 2048, torch.bfloat16), {}),
             ((2, 100, 1000, torch.bfloat16), {}),
             ((1, 1000, 1000, torch.float32), {}),
             ((2, 300, 300, torch.bfloat16), dict(H=16, KV=4, dh=64)),
             ((4, 1000, 1000, torch.bfloat16), GRANITE_HEADS),
             ((1, 2048, 2048, torch.bfloat16), GRANITE_HEADS),
             ((2, 200, 333, torch.bfloat16), dict(H=8, KV=8, dh=32)),
             ((2, 1000, 1000, torch.bfloat16), dict(packed=True)),
             ((16, 128, 128, torch.bfloat16), LM_TRAIN_HEADS),
             ((4, 1000, 1000, torch.bfloat16), TP_RANK_HEADS),
             ((4, 1000, 1000, torch.bfloat16), TP_HEADS)]
    # the float32 kernel around its 64-key tiles and its 64- and 128-row
    # blocks (128 at dh 128 from b H ceil(sq / 128) >= the SM count: b 3 x
    # H 96), dh 32 / 64 / 128, GQA 1 / 4 / 8, causal sq < skv, one query
    # row, non-causal sq > skv
    cases += [((b, sq, skv, torch.float32), dict(H=H_, KV=KV_, dh=dh_,
                                                  causal=c))
              for b, sq, skv, H_, KV_, dh_, c in F32_EDGES]
    # every shape the vlm and whisper serving paths give the kernel, in
    # both dtypes (the float32 image embeddings and frames promote the
    # cross-attention and whisper's encoder to float32)
    cases += [((b, sq, skv, dtype), dict(heads, causal=causal))
              for b, sq, skv, heads, causal in VLM_WHISPER_FLASH
              for dtype in (torch.bfloat16, torch.float32)]
    # a rank's launches in phase 26 (tp = 4): the vlm's bf16 causal
    # self-attention and float32 cross-attention over 1,600 image tokens;
    # whisper's float32 encoder over 1,500 frames, its bf16 causal
    # decoder and float32 cross-attention over the 1,500 frames
    cases += [((b, sq, skv, dtype), dict(heads, causal=causal))
              for b, sq, skv, heads, causal, dtype in (
                  (4, 1000, 1000, VLM_RANK_HEADS, True, torch.bfloat16),
                  (4, 1000, 1600, VLM_RANK_HEADS, False, torch.float32),
                  (4, 1500, 1500, WHISPER_RANK_HEADS, False, torch.float32),
                  (4, 64, 64, WHISPER_RANK_HEADS, True, torch.bfloat16),
                  (4, 64, 1500, WHISPER_RANK_HEADS, False, torch.float32))]
    for (b, sq, skv, dtype), kw in cases:
        causal = kw.pop("causal", True)
        if kw.get("packed"):
            q, k, v = packed_attn_inputs(dev, b, sq, H, KV, dh, sq + 1)
        else:
            q, k, v = attn_inputs(dev, b, sq, skv, dtype, sq + skv, **kw)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        what = (f"flash_attention b={b} sq={sq} skv={skv} H={q.shape[2]} "
                f"KV={k.shape[2]} dh={q.shape[3]} {dtype}"
                f"{' causal' if causal else ' non-causal'}"
                f"{' packed qkv strides' if kw.get('packed') else ''}")
        err = close(got, flash_attention_plain(q, k, v, causal=causal),
                    KERNEL_TOL[dtype], what)
        fa_err = max(fa_err, err)
        log(f"{what}: max|err| {err:.3e} vs plain")

    g = torch.Generator(device=dev).manual_seed(5)
    for n, dtype in ((4096, torch.bfloat16), (4000, torch.bfloat16),
                     (4, torch.bfloat16), (4096, torch.float32)):
        x = (torch.randn((n, d), generator=g, device=dev) * 3).to(dtype)
        sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dtype)
        got = rmsnorm(x, sc, cfg.norm_eps)
        torch.cuda.synchronize()
        err = close(got, rmsnorm_plain(x, sc, cfg.norm_eps),
                    KERNEL_TOL[dtype], f"rmsnorm ({n}, {d}) {dtype}")
        rn_err = max(rn_err, err)
        log(f"rmsnorm check ({n}, {d}) {dtype}: max|err| {err:.3e} vs plain")
    # the MoE paths' norms (granite's and deepseek's widths, MLA's latent
    # norm) and train_lm_torch's ~100M model's (640), bfloat16 rows and
    # scale, prefill and decode rows (2048 = its 16 x 128 batch; 1,000 = a
    # rank's run of a 4 x 1000 prompt in phases 23, 25 and 26), launched
    # as the models launch them (pdl) and without pdl
    gcfg, dcfg, tcfg = ARCHS[GRANITE], ARCHS[DEEPSEEK], ARCHS[TP_ARCH]
    vcfg = ARCHS[VLM]
    lm = example_globals("train_lm_torch.py")["hundred_m_config"]()
    for dw, eps, rows in ((gcfg.d_model, gcfg.norm_eps, (4000, 2048, 4, 1)),
                          (dcfg.d_model, dcfg.norm_eps,
                           (4000, 2048, 1000, 4, 1)),
                          (dcfg.kv_lora_rank, dcfg.norm_eps,
                           (4000, 2048, 1000, 4, 1)),
                          (vcfg.d_model, vcfg.norm_eps, (4000, 1000, 4, 1)),
                          (lm.d_model, lm.norm_eps, (4000, 2048, 4, 1)),
                          (tcfg.d_model, tcfg.norm_eps, (4000, 1000, 4, 1))):
        sc = (1 + 0.1 * torch.randn(dw, generator=g, device=dev)).to(
            torch.bfloat16)
        w_err = 0.0
        for n in rows:
            x = (torch.randn((n, dw), generator=g, device=dev) * 3).to(
                torch.bfloat16)
            want = rmsnorm_plain(x, sc, eps)
            for pdl in (True, False):
                got = rmsnorm(x, sc, eps, pdl=pdl)
                torch.cuda.synchronize()
                what = f"rmsnorm ({n}, {dw}) bf16 pdl={pdl}"
                w_err = max(w_err, close(got, want,
                                         KERNEL_TOL[torch.bfloat16], what))
        rn_err = max(rn_err, w_err)
        log(f"rmsnorm check d={dw} bf16 (rows "
            f"{', '.join(map(str, rows))}; pdl on and off): max|err| "
            f"{w_err:.3e} vs plain")
    # ssm_scan at phase 24's shapes, as the Mamba block calls it: a rank's
    # d_inner / 4 channels and one card's d_inner of jamba-1.5-large-398b,
    # the 4 x 1000 prefill (x bf16, dt float32, no skip term) and a decode
    # step (x float32, as the block passes it, and bf16; D, the state
    # advanced in place)
    jcfg = ARCHS[JAMBA]
    scan_err = 0.0
    for di in (jcfg.d_inner // TP, jcfg.d_inner):
        ds = jcfg.ssm_state
        cases = [(TP_REQUEST[0], TP_REQUEST[1], torch.bfloat16, False),
                 (TP_REQUEST[0], 1, torch.float32, True),
                 (TP_REQUEST[0], 1, torch.bfloat16, True)]
        for i, (b, s, xdt, decode) in enumerate(cases):
            args, h0 = scan_inputs(dev, b, s, di, ds, xdt, torch.float32,
                                   60 + i, h0=decode)
            if not decode:
                args[5] = None
            y_p, h_p = ssm_scan_plain(*args, h0=h0)
            state = h0.clone() if decode else None
            y, h = ssm_scan(*args, h0=state, h_out=state)
            torch.cuda.synchronize()
            what = (f"ssm_scan ({b}, {s}, {di}, {ds}) x {xdt} "
                    f"{'decode, state in place' if decode else 'prefill'}")
            e_y = close(y, y_p, SSM_TOL[xdt], f"{what}: y")
            e_h = close(h, h_p, SSM_TOL[torch.float32], f"{what}: h_last")
            scan_err = max(scan_err, e_y, e_h)
            log(f"{what}: max|err| y {e_y:.3e}, h_last {e_h:.3e} vs plain")

    # timings at the serving path's prefill shapes (glm4-9b's, granite's,
    # the vlm's and whisper's): the kernel, the plain version and
    # scaled_dot_product_attention; a first timing is thrown away (the
    # first in a process reads high)
    q, k, v = attn_inputs(dev, 4, 1000, 1000, torch.bfloat16, 6)
    cuda_time_ms(lambda: flash_attention(q, k, v), 20, flush)
    glm = dict(H=H, KV=KV, dh=dh)
    shapes = [time_flash(dev, flush, card, b, s, s, heads, True,
                         torch.bfloat16)
              for b, s, heads in ((4, 1000, glm), (4, 1024, glm),
                                  (1, 2048, glm), (4, 1000, GRANITE_HEADS))]
    shapes += [time_flash(dev, flush, card, *shape)
               for shape in VLM_WHISPER_TIMED]
    first = shapes[0]
    fa = dict(err=fa_err, shape=[first["b"], first["s"], H, KV, dh],
              shapes=shapes, build=report,
              **{k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                       "flops", "bytes", "bound_ms",
                                       "bound_by")})

    b, s = REQUESTS[0]        # the prefill norm over 4,000 rows, decode over 4
    rows = b * s
    x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(
        torch.bfloat16)
    xd = x[:b].contiguous()
    eps = cfg.norm_eps
    rn = dict(ms=cuda_time_ms(lambda: rmsnorm(x, sc, eps), 50, flush),
              plain_ms=cuda_time_ms(lambda: rmsnorm_plain(x, sc, eps), 20,
                                    flush),
              library_ms=cuda_time_ms(
                  lambda: F.rms_norm(x, (d,), weight=sc, eps=eps), 50, flush),
              decode_ms=cuda_time_ms(lambda: rmsnorm(xd, sc, eps), 50, flush),
              decode_library_ms=cuda_time_ms(
                  lambda: F.rms_norm(xd, (d,), weight=sc, eps=eps), 50,
                  flush))
    close(F.rms_norm(x, (d,), weight=sc, eps=eps), rmsnorm_plain(x, sc, eps),
          KERNEL_TOL[torch.bfloat16], "rms_norm")
    x1 = x[:1].contiguous()
    rn.update(one_row_ms=cuda_time_ms(lambda: rmsnorm(x1, sc, eps), 50, flush),
              one_row_library_ms=cuda_time_ms(
                  lambda: F.rms_norm(x1, (d,), weight=sc, eps=eps), 50, flush),
              decode=rmsnorm_decode(dev, flush, card, d, eps))
    work = norm_work(rows, d, 2, 2)   # bf16 x and scale
    nbytes, flops = work["bytes"], work["flops"]
    rn.update(err=rn_err, bytes=nbytes, flops=flops, shape=[rows, d],
              bound_ms=max(nbytes / HBM_BYTES_PER_S,
                           flops / PEAK_OPS["f32"]) * 1e3,
              bound_by="bytes")
    log(f"rmsnorm bf16 ({rows}, {d}) [{card}]: kernel {rn['ms']:.4f} ms, "
        f"plain {rn['plain_ms']:.4f} ms, rms_norm {rn['library_ms']:.4f} ms,"
        f" bound {rn['bound_ms']:.4f} ms ({nbytes:.4e} B); decode rows "
        f"({b}, {d}): kernel {rn['decode_ms']:.4f} ms, rms_norm "
        f"{rn['decode_library_ms']:.4f} ms; one row (1, {d}): kernel "
        f"{rn['one_row_ms']:.4f} ms, rms_norm {rn['one_row_library_ms']:.4f}"
        f" ms")
    build.LAUNCHES.update(before)          # check/timing launches do not count
    return {"flash_attention": fa, "rmsnorm": rn,
            "ssm_scan_tp": dict(err=scan_err)}


DECODE_PAIRS = 81                # rmsnorm launches in one glm4-9b forward


def rmsnorm_decode(dev, flush, card: str, d: int, eps: float) -> dict:
    """rmsnorm at the decode rows: one flushed launch at (4, d) and (1, d),
    with and without programmatic dependent launch (pdl); the decode chain
    (DECODE_PAIRS pairs of a residual add h = h + y and y = rmsnorm(h,
    scale_l), one event pair around the chain, L2 flushed before it) for the
    kernel with and without pdl, for ``F.rms_norm`` and for the adds alone;
    and the host microseconds per ``ops.rmsnorm`` call as ``Norm`` makes
    it (pdl)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm, rmsnorm_plain, rmsnorm_rows
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(8)
    h0 = torch.randn((4, d), generator=g, device=dev).to(bf16)
    scales = [(1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf16)
              for _ in range(DECODE_PAIRS)]
    out = {"single": {}, "chain_ms_per_pair": {}}
    for n in (4, 1):
        x = h0[:n].contiguous()
        want = rmsnorm_plain(x, scales[0], eps)
        for pdl in (False, True):
            key = f"{n}x{d}{' pdl' if pdl else ''}"
            close(rmsnorm_rows(x, scales[0], eps, pdl=pdl), want,
                  KERNEL_TOL[bf16], f"rmsnorm {key}")
            out["single"][key] = cuda_time_ms(
                lambda: rmsnorm_rows(x, scales[0], eps, pdl=pdl), 50, flush)

    def chain(norm):
        def run():
            h, y = h0, h0
            for sc in scales:
                h = h + y
                y = norm(h, sc)
            return y
        return run
    norms = {"kernel": lambda h, sc: rmsnorm_rows(h, sc, eps),
             "kernel pdl": lambda h, sc: rmsnorm_rows(h, sc, eps, pdl=True),
             "rms_norm": lambda h, sc: F.rms_norm(h, (d,), weight=sc,
                                                  eps=eps),
             "adds alone": lambda h, sc: h0}
    plain = chain(lambda h, sc: rmsnorm_plain(h, sc, eps))()
    ends = {}
    for name, norm in norms.items():
        ends[name] = chain(norm)()
        out["chain_ms_per_pair"][name] = chain_time_ms(
            chain(norm), 10, flush) / DECODE_PAIRS
    for name in ("kernel", "kernel pdl"):
        close(ends[name], plain, LM_TOL[bf16], f"rmsnorm decode chain {name}")
    if not torch.equal(ends["kernel"], ends["kernel pdl"]):
        raise AssertionError("the decode chain differs with programmatic "
                             "dependent launch")
    # host time per call, the card kept busy so that the queue never blocks
    host = {}
    x = h0
    for name, fn in (("ops.rmsnorm", lambda: rmsnorm(x, scales[0], eps,
                                                     pdl=True)),
                     ("rms_norm", lambda: F.rms_norm(x, (d,),
                                                     weight=scales[0],
                                                     eps=eps))):
        spent = 0.0
        for _ in range(4):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            spent += time.perf_counter() - t0
        torch.cuda.synchronize()
        host[name] = spent / 2000 * 1e6
    out["host_us_per_call"] = host
    log(f"rmsnorm single launches (ms) [{card}]: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["single"].items()))
    log(f"rmsnorm decode chain, {DECODE_PAIRS} pairs of add + norm on (4, "
        f"{d}) bf16, ms per pair [{card}]: "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    out["chain_ms_per_pair"].items()))
    log(f"rmsnorm host us per call at (4, {d}), 2000 calls [{card}]: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    return out


def lm_card_vs_host_phase(dev) -> None:
    """Reduced glm4-9b with the same weights: kernels on the card against
    the plain versions on the CPU, prefill and teacher-forced decode."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS[GLM].reduced(num_layers=2)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 100))
    for dtype in (torch.float32, torch.bfloat16):
        host = ServeEngine(cfg, max_len=120, device="cpu", dtype=dtype)
        host.init_params(0)
        card = ServeEngine(cfg, max_len=120, device=dev, dtype=dtype)
        card.model.load_state_dict(host.model.state_dict())
        tol = LM_TOL[dtype]
        # the host first: its logits, caches and greedy tokens
        lh, ch = host.model.prefill({"tokens": tokens})
        ch = host._pad_caches(ch, 2)
        host_logits, fed = [lh], []
        for i in range(8):
            fed.append(torch.argmax(host_logits[-1], dim=-1))
            lh, ch = host.model.decode_step(ch, fed[-1], 100 + i)
            host_logits.append(lh)
        # then the card, fed the host's tokens
        before = dict(build.LAUNCHES)
        lc, cc = card.model.prefill({"tokens": tokens})
        cc = card._pad_caches(cc, 2)
        card_logits = [lc]
        for i in range(8):
            lc, cc = card.model.decode_step(cc, fed[i].to(dev), 100 + i)
            card_logits.append(lc)
        if build.LAUNCHES["flash_attention"] - before["flash_attention"] \
                != 2 or build.LAUNCHES["rmsnorm"] - before["rmsnorm"] \
                != 5 * 9:
            raise AssertionError("the reduced LM on the card did not run "
                                 "its kernels")
        # the decode caches and decode softmax weights are bf16 for either
        # parameter dtype, as in the reference: one bf16 rounding that
        # falls differently moves the logits by more than 1e-4
        errs = [close(card_logits[0], host_logits[0], tol,
                      f"prefill logits {dtype}")]
        bf16 = LM_TOL[torch.bfloat16]
        errs += [close(c, h, bf16, f"decode logits {dtype} step {i}")
                 for i, (c, h) in enumerate(zip(card_logits[1:],
                                                host_logits[1:]))]
        for key in ("k", "v"):
            errs.append(close(cc["l0_attn"][key], ch["l0_attn"][key], bf16,
                              f"cache {key} {dtype}"))
        build.LAUNCHES.update(before)
        log(f"LM card vs host: reduced {GLM} (2 layers) {dtype}, 2 x 100 "
            f"prompt: prefill logits max|err| {errs[0]:.3e} (tolerance rtol "
            f"{tol['rtol']} + atol {tol['atol']}); 8 teacher-forced decode "
            f"steps and bf16 caches max|err| {max(errs[1:]):.3e} (rtol "
            f"{bf16['rtol']} + atol {bf16['atol']})")


# ---------------------------------------------------------------------------
# phases 9-11: the Mamba serving path
# ---------------------------------------------------------------------------
def scan_inputs(dev, b, s, di, ds, xdtype, dtdtype, seed, h0=False):
    """tests/test_kernels.py's distributions for ssm_scan on the card:
    x, dt (b, s, di) in their dtypes, A (di, ds), B, C (b, s, ds), D (di,)
    float32, and a float32 h0 when asked."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = (n(b, s, di) * 0.5).to(xdtype)
    dt = torch.nn.functional.softplus(n(b, s, di) * 0.2 - 1).to(dtdtype)
    args = [x, dt, -torch.exp(n(di, ds) * 0.3), n(b, s, ds) * 0.5,
            n(b, s, ds) * 0.5, 1 + 0.1 * n(di)]
    return args, (n(b, di, ds) if h0 else None)


def scan_bound(work: dict) -> dict:
    """The least time of one scan from ``kernels.scan_work``'s counts: its
    bytes over the memory rate or its exps over the special-function
    units' rate and its other float32 operations over the float32 rate,
    whichever is larger."""
    times = {"bytes": work["bytes"] / HBM_BYTES_PER_S,
             "operations": max(work["exps"] / PEAK_OPS["sfu_exp"],
                               work["flops"] / PEAK_OPS["f32"])}
    bound_by = max(times, key=times.get)
    return dict(work, bound_by=bound_by, bound_ms=times[bound_by] * 1e3)


SASS_OPS = ("MUFU.EX2", "FFMA", "FMUL", "LDS", "SHFL", "BAR")


def ssm_kernel_phase(dev, flush, card: str) -> dict:
    """ssm_scan's ptxas report and SASS mix, the kernel against its plain
    version on the card (y and h_last), then the kernel's and the plain
    version's times and the bound at the serving path's shapes (launches
    made here do not count)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build, scan_work, ssm_scan, ssm_scan_plain
    cfg = ARCHS[MAMBA]
    di, ds = cfg.d_inner, cfg.ssm_state
    bf16, f32 = torch.bfloat16, torch.float32
    report = build_report("ssm_scan", SASS_OPS)
    for ln in report["ptxas"]:
        log(f"  ssm_scan ptxas: {ln}")
    for name, counts in report["sass"].items():
        log(f"  ssm_scan SASS {name}: {json.dumps(counts)}")
    if not any(c["MUFU.EX2"] for c in report["sass"].values()):
        raise AssertionError("the ssm_scan library has no MUFU.EX2")
    before = dict(build.LAUNCHES)
    err = 0.0
    cases = [(4, 1024, di, ds, bf16, f32, False),   # the model's prefill
             (4, 1024, di, ds, f32, f32, False),
             (1, 2048, di, ds, bf16, f32, False),   # batch 1
             (1, 2048, di, ds, f32, f32, False),
             (4, 1, di, ds, f32, f32, True),        # the model's decode
             (4, 1029, di, ds, bf16, f32, True),    # a 5-step tail block
             (2, 1029, 1024, ds, bf16, bf16, True),  # (eight and four
             (2, 1029, 1024, ds, f32, f32, False),   # states a thread)
             (3, 77, 1000, ds, bf16, f32, True),    # ragged s and di
             (1, 64, 128, 8, f32, f32, False),      # tests/test_kernels.py
             (2, 128, 256, 16, f32, f32, False),
             (1, 96, 384, 16, f32, f32, False),
             (1, 64, 128, 8, bf16, bf16, False),
             (2, 128, 256, 16, bf16, bf16, False),
             (1, 96, 384, 16, bf16, bf16, False)]
    for i, (b, s, d_i, d_s, xdt, dtdt, with_h0) in enumerate(cases):
        args, h0 = scan_inputs(dev, b, s, d_i, d_s, xdt, dtdt, 20 + i,
                               with_h0)
        y, h = ssm_scan(*args, h0=h0)
        torch.cuda.synchronize()
        y_p, h_p = ssm_scan_plain(*args, h0=h0)
        what = f"ssm_scan ({b}, {s}, {d_i}, {d_s}) x {xdt} dt {dtdt}" + \
            (" with h0" if with_h0 else "")
        e_y = close(y, y_p, SSM_TOL[xdt], f"{what}: y")
        e_h = close(h, h_p, SSM_TOL[f32], f"{what}: h_last")
        err = max(err, e_y, e_h)
        log(f"{what}: max|err| y {e_y:.3e}, h_last {e_h:.3e} vs plain")
    # the skip term left out and the state advanced in place, as the model
    # calls the kernel in prefill and decode
    for b, s, seed in ((4, 1, 40), (1, 1, 41), (2, 100, 42)):
        args, h0 = scan_inputs(dev, b, s, di, ds, f32, f32, seed, True)
        y_d, h_d = ssm_scan(*args, h0=h0)
        state = h0.clone()
        y_i, _ = ssm_scan(*args, h0=state, h_out=state)
        y_0, _ = ssm_scan(*args[:5], None, h0=h0)
        torch.cuda.synchronize()
        if not (torch.equal(state, h_d) and torch.equal(y_i, y_d)):
            raise AssertionError(f"ssm_scan ({b}, {s}) with h_out = h0 "
                                 f"differs")
        close(y_0 + args[5] * args[0], y_d, SSM_TOL[f32],
              f"ssm_scan ({b}, {s}) without D")
        y_p, h_p = ssm_scan_plain(*args, h0=h0)
        err = max(err, close(y_i, y_p, SSM_TOL[f32],
                             f"ssm_scan ({b}, {s}) in place: y"),
                  close(state, h_p, SSM_TOL[f32],
                        f"ssm_scan ({b}, {s}) in place: h_last"))
        log(f"ssm_scan ({b}, {s}, {di}, {ds}) with h_out = h0: equal to a "
            f"fresh h_out, within tolerance of plain; without D within "
            f"tolerance")

    # timings at the serving path's shapes: prefill as the model calls it
    # (x bf16, dt float32, no skip term), and one decode step; a first
    # timing is thrown away (the first in a process reads high)
    out = {"err": err, "build": report}
    for key, (b, s) in (("prefill", MAMBA_REQUESTS[0]),
                        ("prefill_b1", MAMBA_REQUESTS[1])):
        args, _ = scan_inputs(dev, b, s, di, ds, bf16, f32, 50)
        args[5] = None
        if key == "prefill":
            cuda_time_ms(lambda: ssm_scan(*args), 20, flush)
        work = scan_bound(scan_work(b, s, di, ds, 2, 4, skip=False,
                                    h0=False))
        out[key] = dict(
            shape=[b, s, di, ds],
            ms=cuda_time_ms(lambda: ssm_scan(*args), 20, flush),
            plain_ms=cuda_time_ms(lambda: ssm_scan_plain(*args), 3, flush),
            **work)
    args, h0 = scan_inputs(dev, 4, 1, di, ds, f32, f32, 51, True)
    out["decode"] = dict(
        shape=[4, 1, di, ds],
        ms=cuda_time_ms(lambda: ssm_scan(*args, h0=h0, h_out=h0), 50,
                        flush),
        plain_ms=cuda_time_ms(lambda: ssm_scan_plain(*args, h0=h0), 20,
                              flush),
        **scan_bound(scan_work(4, 1, di, ds, 4, 4, skip=True, h0=True)))
    build.LAUNCHES.update(before)          # check/timing launches do not count
    for key in ("prefill", "prefill_b1", "decode"):
        r = out[key]
        log(f"ssm_scan {key} {tuple(r['shape'])} [{card}]: kernel "
            f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the bound),"
            f" plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes']:.4e} B, {r['exps']:.4e} exp, "
            f"{r['flops']:.4e} flop)")
    return out


def mamba_card_vs_host_phase(dev) -> None:
    """Reduced falcon-mamba-7b with the same weights: the kernels on the
    card against the plain versions on the CPU, prefill, teacher-forced
    decode and both caches."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS[MAMBA].reduced(num_layers=2)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 100))
    for dtype in (torch.float32, torch.bfloat16):
        host = ServeEngine(cfg, max_len=120, device="cpu", dtype=dtype)
        host.init_params(0)
        card = ServeEngine(cfg, max_len=120, device=dev, dtype=dtype)
        card.model.load_state_dict(host.model.state_dict())
        tol = LM_TOL[dtype]
        lh, ch = host.model.prefill({"tokens": tokens})
        ch = host._pad_caches(ch, 2)
        host_logits, fed = [lh], []
        for i in range(8):
            fed.append(torch.argmax(host_logits[-1], dim=-1))
            lh, ch = host.model.decode_step(ch, fed[-1], 100 + i)
            host_logits.append(lh)
        before = dict(build.LAUNCHES)
        lc, cc = card.model.prefill({"tokens": tokens})
        cc = card._pad_caches(cc, 2)
        card_logits = [lc]
        for i in range(8):
            lc, cc = card.model.decode_step(cc, fed[i].to(dev), 100 + i)
            card_logits.append(lc)
        got = {k: build.LAUNCHES[k] - before[k]
               for k in ("ssm_scan", "rmsnorm", "flash_attention")}
        if got != {"ssm_scan": 2 * 9, "rmsnorm": 3 * 9,
                   "flash_attention": 0}:
            raise AssertionError(f"the reduced {MAMBA} on the card launched "
                                 f"{got}")
        # no bf16 cache with float32 parameters here (the state is float32
        # and the conv window takes x's dtype), so decode is held to the
        # parameters' tolerance too
        errs = [close(c, h, tol, f"{MAMBA} logits {dtype} step {i}")
                for i, (c, h) in enumerate(zip(card_logits, host_logits))]
        for key in ("state", "conv"):
            if cc["l0_mamba"][key].dtype != ch["l0_mamba"][key].dtype:
                raise AssertionError(f"cache {key}: "
                                     f"{cc['l0_mamba'][key].dtype} on the "
                                     f"card, {ch['l0_mamba'][key].dtype} "
                                     f"on the host")
            errs.append(close(cc["l0_mamba"][key], ch["l0_mamba"][key], tol,
                              f"{MAMBA} cache {key} {dtype}"))
        build.LAUNCHES.update(before)
        log(f"Mamba card vs host: reduced {MAMBA} (2 layers) {dtype}, 2 x "
            f"100 prompt: prefill logits max|err| {errs[0]:.3e}, 8 "
            f"teacher-forced decode steps {max(errs[1:9]):.3e}, state and "
            f"conv caches {max(errs[9:]):.3e} (tolerance rtol {tol['rtol']}"
            f" + atol {tol['atol']})")



def attn_launches(cfg, n_requests: int) -> dict:
    """What glm4-9b and granite-moe-3b-a800m dictate: one flash launch per
    layer and prefill, one rmsnorm per norm (two a layer and the final
    one) and forward."""
    return {"flash_attention": cfg.num_layers * n_requests,
            "rmsnorm": (2 * cfg.num_layers + 1) * (1 + NEW_TOKENS)
            * n_requests, "ssm_scan": 0}


def mla_launches(cfg, n_requests: int) -> dict:
    """What deepseek-v2-236b dictates: no flash (MLA's prefill attention is
    plain PyTorch), three rmsnorms a layer (the two norms and MLA's latent
    norm) and the final one per forward, no scan."""
    return {"flash_attention": 0,
            "rmsnorm": (3 * cfg.num_layers + 1) * (1 + NEW_TOKENS)
            * n_requests, "ssm_scan": 0}


def mamba_launches(cfg, n_requests: int) -> dict:
    """What falcon-mamba-7b dictates: one scan and one rmsnorm per layer
    and forward (prefill and every decode step), the final rmsnorm, no
    attention."""
    forwards = (1 + NEW_TOKENS) * n_requests
    return {"ssm_scan": cfg.num_layers * forwards,
            "rmsnorm": (cfg.num_layers + 1) * forwards,
            "flash_attention": 0}


def serve_phase(dev, card: str, cfg, requests, dictates,
                trace_out: str | None, trace: bool, inputs=None) -> dict:
    """``cfg`` at full width answers ``requests`` through
    ServeEngine.generate; the launch counts are reset just before and read
    just after, and must equal ``dictates(cfg, len(requests))``.
    ``inputs(cfg, b)`` adds a request's stub inputs (image embeddings,
    frames) to its batch; a model with gates gets them drawn away from 0
    after the seeded init (``seed_gates``)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    arch = cfg.name
    full = ARCHS[arch].num_layers
    depth = ("full depth" if cfg.num_layers == full else
             f"{cfg.num_layers} of its {full} layers")
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, max_len=max(s for _, s in requests)
                         + NEW_TOKENS + 4, device=dev)
    engine.init_params(0)
    gates = seed_gates(engine.model)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.model.parameters())
    if gates:
        log(f"{arch}: gates drawn in [0.5, 1.5] after the seeded init "
            f"(zero there): {json.dumps(gates)}")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
               for b, s in requests]
    batches = [dict({"tokens": tokens},
                    **(inputs(cfg, tokens.shape[0]) if inputs else {}))
               for tokens in prompts]
    torch.cuda.reset_peak_memory_stats(dev)
    peak = 0
    build.reset_launches()
    results = []
    for batch in batches:
        tokens = batch["tokens"]
        before = dataclasses.replace(engine.stats)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = engine.generate(batch, NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        request_peak = torch.cuda.max_memory_allocated(dev)
        peak = max(peak, request_peak)
        b, s = tokens.shape
        if out.shape != (b, NEW_TOKENS) or out.min() < 0 or \
                out.max() >= cfg.vocab_size:
            raise AssertionError(f"request {b} x {s}: tokens {out.shape} "
                                 f"out of range [{out.min()}, {out.max()}]")
        first = engine.stats.first_token_s - before.first_token_s
        rest = engine.stats.next_tokens_s - before.next_tokens_s
        results.append(dict(batch=b, prompt=s, wall_s=wall,
                            first_token_ms=first * 1e3,
                            decode_ms_per_step=rest / (NEW_TOKENS - 1) * 1e3,
                            tokens_per_s=b * NEW_TOKENS / (first + rest),
                            peak_gib=request_peak / 2**30,
                            first_tokens=out[:, :4].tolist()))
    want = dictates(cfg, len(requests))
    launches = {k: build.LAUNCHES[k] for k in want}
    if launches != want:
        raise AssertionError(f"{arch} serving path launches {launches}, the "
                             f"model dictates {want}")
    log(f"serving path [{card}]: {arch} full width, {depth}, {n_params} "
        f"parameters (bf16), seeded init {t_init:.3f} s; launches "
        f"{json.dumps(launches)}; peak memory {peak / 2**30:.3f} GiB")
    for r in results:
        log(f"  request {r['batch']} x {r['prompt']} -> {NEW_TOKENS} tokens "
            f"[{card}]: first token {r['first_token_ms']:.3f} ms, decode "
            f"{r['decode_ms_per_step']:.3f} ms/step, {r['tokens_per_s']:.2f} "
            f"tokens/s, peak {r['peak_gib']:.3f} GiB, wall "
            f"{r['wall_s']:.3f} s")
    traced = trace_serve(engine, batches[0], card, trace_out) if trace \
        else None
    return dict(requests=results, launches=launches, peak_bytes=peak,
                n_params=n_params, init_s=t_init, num_layers=cfg.num_layers,
                gates=gates, trace=traced)


MOE_RANGES = ("forward", "_route", "_experts", "_shared")


@contextlib.contextmanager
def moe_ranges():
    """Wrap the MoE block's forward and its parts in profiler ranges named
    ``moe.<method>`` (only while tracing; the class is restored after)."""
    from torch.profiler import record_function
    from repro_torch.models.moe import MoE
    saved = {n: getattr(MoE, n) for n in MOE_RANGES}

    def ranged(name, fn):
        def inner(self, *args, **kwargs):
            with record_function(f"moe.{name}"):
                return fn(self, *args, **kwargs)
        return inner

    for n, fn in saved.items():
        setattr(MoE, n, ranged(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(MoE, n, fn)


def moe_device_times(ka) -> dict:
    """Device ms of the MoE block's parts from ``moe_ranges``: routing,
    dispatch and combine (the block but its expert products), the routed
    experts' and the shared experts' products."""
    cpu = torch.autograd.DeviceType.CPU
    us = {e.key: e.device_time_total for e in ka
          if e.key.startswith("moe.") and e.device_type == cpu}
    whole = us.get("moe.forward", 0.0)
    experts = us.get("moe._experts", 0.0)
    shared = us.get("moe._shared", 0.0)
    return {"route_dispatch_combine_ms": (whole - experts - shared) / 1e3,
            "of_it_route_ms": us.get("moe._route", 0.0) / 1e3,
            "experts_ms": experts / 1e3, "shared_experts_ms": shared / 1e3}


def trace_serve(engine, batch: dict, card: str, out: str | None) -> dict:
    """One more request under ``torch.profiler``: device busy share and
    device time by kernel (table in ``out/trace_serve_<arch>.txt``); for a
    MoE model also the device time of the block's parts."""
    from torch.profiler import ProfilerActivity, profile
    moe = bool(engine.cfg.moe_num_experts)
    torch.cuda.synchronize()
    with moe_ranges() if moe else contextlib.nullcontext(), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(batch, NEW_TOKENS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    tokens = batch["tokens"]
    ka = prof.key_averages()
    # the device-side spans of moe_ranges' annotations are not kernels
    kernels = [e for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("moe.")]
    device_us = sum(e.self_device_time_total for e in kernels)
    shares, counts = {}, {}
    for e in kernels:
        name = e.key.lower()
        group = ("flash_attention" if "fa_bf16" in name else
                 "flash_attention f32" if "fa_f32" in name else
                 "rmsnorm" if "rmsnorm" in name else
                 "ssm_scan decode" if "ssm_scan_step" in name else
                 "ssm_scan" if "ssm_scan" in name else
                 "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass",
                                                    "gemv", "splitk",
                                                    "nvjet")) else
                 "other")
        shares[group] = shares.get(group, 0.0) + e.self_device_time_total
        counts[group] = counts.get(group, 0) + e.count
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / device_us:.1%}, "
                      f"{counts[k]} launches)"
                      for k, v in sorted(shares.items(), key=lambda x: -x[1]))
    if moe:
        moe_ms = moe_device_times(ka)
        parts += "; MoE blocks: " + ", ".join(f"{k} {v:.3f}"
                                              for k, v in moe_ms.items())
    log(f"trace serve {engine.cfg.name} [{card}]: request "
        f"{tokens.shape[0]} x {tokens.shape[1]} -> {NEW_TOKENS} tokens in "
        f"{elapsed:.3f} s under the profiler, device busy {device_us / 1e6:.3f} s = "
        f"{device_us / 1e6 / elapsed:.2%}; by kernel: {parts}")
    if out is not None:
        with open(os.path.join(out, f"trace_serve_{engine.cfg.name}.txt"),
                  "w") as f:
            f.write(f"{card}\n{elapsed:.3f} s traced, device busy "
                    f"{device_us / 1e6:.3f} s\n{parts}\n\n"
                    f"{ka.table(sort_by='self_device_time_total', row_limit=25)}"
                    f"\n")
    return dict(elapsed_s=elapsed, device_busy_s=device_us / 1e6,
                by_kernel_ms={k: v / 1e3 for k, v in shares.items()},
                launches_by_kernel=counts,
                **({"moe_ms": moe_device_times(ka)} if moe else {}))


# ---------------------------------------------------------------------------
# phases 14-15: MoE, MLA and hybrid serving
# ---------------------------------------------------------------------------
GRANITE = "granite-moe-3b-a800m"
DEEPSEEK = "deepseek-v2-236b"
JAMBA = "jamba-1.5-large-398b"
DEEPSEEK_LAYERS = 4              # of 60: the 4-layer cut fits one card
# launches of the reduced models: flash per prefill, rmsnorm and ssm_scan
# per forward (jamba: 4 layers, attention on layers 1 and 3, Mamba on 0
# and 2)
MOE_REDUCED_LAUNCHES = {
    GRANITE: {"flash_attention": 4, "rmsnorm": 9, "ssm_scan": 0},
    DEEPSEEK: {"flash_attention": 0, "rmsnorm": 3 * 4 + 1, "ssm_scan": 0},
    JAMBA: {"flash_attention": 2, "rmsnorm": 9, "ssm_scan": 2}}
# a routing choice that flips between the whole models on two devices must
# be this near a tie (the least gap between neighbouring router
# probabilities among a token's first k + 1): float32 rounding in another
# order (tests/test_torch_moe.py's margin for an equal routing), or the
# bfloat16 ulps by which the router inputs differ (the flips seen on an
# H100 had margins of 1.2e-4 to 2.2e-4, PERF.md)
NEAR_TIE = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# a block fed the same input on both devices routes by float32 products of
# the same operands, so only float32 rounding may flip a choice
SAME_INPUT_NEAR_TIE = 1e-4


def record_moe_inputs(model, store: dict) -> list:
    """Forward pre-hooks that append each MoE block's input to
    ``store[(period, sublayer)]``; returns the handles."""
    hooks = []
    for i, layer in enumerate(model.layers):
        for name, sub in layer.items():
            if sub.kind == "moe":
                hooks.append(sub.core.register_forward_pre_hook(
                    lambda m, a, key=(i, name):
                    store.setdefault(key, []).append(a[0])))
    return hooks


def route_order(moe, x: torch.Tensor):
    """Each token's top-k experts in order (the order decides which pass
    claims a capacity slot) and its margin: the least gap between two
    neighbouring router probabilities among the first k + 1, on the
    host."""
    p = moe._probs(x.reshape(-1, x.shape[-1]))
    v, i = torch.sort(p, dim=-1, descending=True, stable=True)
    k = moe.top_k
    gaps = v[:, :k] - v[:, 1:k + 1]
    return i[:, :k].cpu(), gaps.min(dim=-1).values.cpu()


def route_diff(moe_h, moe_c, x: torch.Tensor, what: str):
    """Both devices' routings of the same MoE input ``x`` (host tensor):
    the tokens whose choices or slots differ (a (T,) host mask), the
    flipped choices, and the host's least margin.  A flipped choice must be
    a near tie, and a slot may move only in a group where a choice
    flipped."""
    xs = x[:, None, :] if x.dim() == 2 else x
    T, d = xs.shape[0] * xs.shape[1], xs.shape[-1]
    S = moe_h.group(T)
    rh = moe_h._route(xs.reshape(T // S, S, d))
    rc = moe_c._route(xs.reshape(T // S, S, d).to(moe_c.router.device))
    _, margin = route_order(moe_h, x)
    flip = (rh.topi != rc.topi.cpu()).any(dim=-1).reshape(-1)
    moved = (rh.dispatched != rc.dispatched.cpu()).any(dim=-1).reshape(-1)
    flips = []
    for t in torch.nonzero(flip)[:, 0].tolist():
        flips.append(dict(token=t, host_margin=float(margin[t])))
        if margin[t] >= SAME_INPUT_NEAR_TIE:
            raise AssertionError(f"{what}: token {t} routes differently on "
                                 f"the same input, margin {margin[t]:.3e} "
                                 f"not a near tie (< {SAME_INPUT_NEAR_TIE})")
    flip_groups = set((torch.nonzero(flip)[:, 0] // S).tolist())
    for t in torch.nonzero(moved & ~flip)[:, 0].tolist():
        if t // S not in flip_groups:
            raise AssertionError(f"{what}: token {t}'s slots differ on the "
                                 f"same input with no flipped choice in "
                                 f"its group")
    return flip | moved, flips, float(margin.min())


def moe_sublayers_vs_host(host_engine, card, dev, tokens, fed, dtype,
                          arch: str) -> dict:
    """Sublayer by sublayer, each card sublayer fed the host's input (and,
    at decode, a copy of the host's cache slices): the prefill and every
    teacher-forced decode step of ``host_engine``'s model (on the CPU) and
    the model ``card``.  Every norm, block output and cache of every layer
    and step is held to the tolerance whatever the whole models' routing
    does; a MoE block's tokens whose routing differs (near ties only) are
    left out of its output.  Decode's attention reads bfloat16 caches for
    either parameter dtype, so its output and those caches are held to the
    bfloat16 tolerance there.  A bfloat16 MoE output is a float32 sum of k
    expert rows each rounded to bfloat16, which may cancel far below the
    rows' size, so it is held to atol + rtol x its token's largest |value|
    (elementwise otherwise).  Every failure is listed; launches made here
    do not count."""
    from repro_torch.kernels import build
    from repro_torch.models.transformer import (apply_sublayer,
                                                decode_sublayer)
    host = host_engine.model
    before = dict(build.LAUNCHES)
    tol, bf16 = LM_TOL[dtype], LM_TOL[torch.bfloat16]
    keys = ("norm", "block", "moe", "cache", "logits")
    errs, used = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    flips, margins, failures = [], {}, []

    def note(key, got, want, tol, what, keep=None, row_scale=False):
        d = want.shape[-1]
        got = got.float().cpu().reshape(-1, d)
        want = want.float().reshape(-1, d)
        if keep is not None:
            got, want = got[keep], want[keep]
        if not want.numel():
            return
        err = (got - want).abs()
        scale = (want.abs().amax(dim=-1, keepdim=True) if row_scale
                 else want.abs())
        frac = float((err / (tol["atol"] + tol["rtol"] * scale)).max())
        errs[key] = max(errs[key], float(err.max()))
        used[key] = max(used[key], frac)
        if frac > 1:
            failures.append(f"{what}: max|err| {float(err.max()):.3e}, "
                            f"{frac:.2f} x the tolerance (rtol "
                            f"{tol['rtol']} + atol {tol['atol']}"
                            f"{', by row' if row_scale else ''})")

    def layer_pass(h, step, run):
        for i, (lh, lc) in enumerate(zip(host.layers, card.layers)):
            for name, kind in host.period_kinds:
                sh, sc = lh[name], lc[name]
                what = f"{arch} {dtype} {step} layer {i} {name}"
                x = sh.norm(h)
                note("norm", sc.norm(h.to(dev)), x, tol, f"{what} norm")
                keep = None
                if kind == "moe":
                    diff, fl, m = route_diff(sh.core, sc.core, x, what)
                    keep = ~diff
                    margins[(i, name)] = min(margins.get((i, name), 1.0), m)
                    flips.extend(dict(step=step, layer=[i, name], **f)
                                 for f in fl)
                out, got, block_tol = run(i, name, kind, sh, sc, x, what)
                note("moe" if kind == "moe" else "block", got, out,
                     block_tol, f"{what} output", keep,
                     row_scale=kind == "moe" and dtype == torch.bfloat16)
                h = h + out
        hn = host.final_norm(h)
        note("norm", card.final_norm(h.to(dev)), hn, tol,
             f"{arch} {dtype} {step} final norm")
        last = hn if hn.dim() == 2 else hn[:, -1]
        note("logits", card.embed.logits(last.to(dev)),
             host.embed.logits(last), tol, f"{arch} {dtype} {step} logits")

    with torch.no_grad():
        th = torch.as_tensor(tokens).long()
        positions = torch.arange(th.shape[1])
        caches = {}

        def prefill(i, name, kind, sh, sc, x, what):
            out, kv = apply_sublayer(sh, x, positions)
            got, kvc = apply_sublayer(sc, x.to(dev), positions.to(dev))
            for key in kv or {}:
                note("cache", kvc[key], kv[key], tol, f"{what} cache {key}")
                caches.setdefault(name, {}).setdefault(key, []).append(
                    kv[key])
            return out, got, tol

        def step(i, name, kind, sh, sc, x, what):
            entry = {key: c[i] for key, c in caches.get(name, {}).items()}
            copy = {key: c.to(dev, copy=True) for key, c in entry.items()}
            got = decode_sublayer(sc, x.to(dev), t, copy)
            out = decode_sublayer(sh, x, t, entry)
            for key in entry:
                note("cache", copy[key], entry[key],
                     bf16 if key in ("k", "v", "ckv", "krope") else tol,
                     f"{what} cache {key}")
            return out, got, bf16 if kind in ("attn", "mla") else tol

        layer_pass(host.embed.embed(th), "prefill", prefill)
        caches = host_engine._pad_caches(
            {name: {key: torch.stack(v) for key, v in entry.items()}
             for name, entry in caches.items()}, th.shape[0])
        for f, tok in enumerate(fed):
            t = th.shape[1] + f
            h = host.embed.embed(tok.long())
            host.promote_conv(caches, h.dtype)
            layer_pass(h, f"decode {f}", step)
    sync(dev)
    build.LAUNCHES.update(before)
    if failures:
        raise AssertionError(f"{arch} {dtype}: {len(failures)} sublayer "
                             f"comparison(s) beyond the tolerance:\n"
                             + "\n".join(failures[:40]))
    return dict(err=errs, of_tolerance=used, flips=flips,
                margins={f"{k[0]}/{k[1]}": v for k, v in margins.items()})


def moe_card_vs_host(dev, arch: str, dtype) -> dict:
    """One reduced model with the same weights on the card (kernels) and
    on the CPU (plain versions): prefill and 8 teacher-forced decode steps,
    launches per forward checked exactly, routing compared forward by
    forward and layer by layer, then every sublayer on the host's input
    (``moe_sublayers_vs_host``)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS[arch].reduced()
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 100))
    host = ServeEngine(cfg, max_len=120, device="cpu", dtype=dtype)
    host.init_params(0)
    card = ServeEngine(cfg, max_len=120, device=dev, dtype=dtype)
    card.model.load_state_dict(host.model.state_dict())
    xs_h, xs_c = {}, {}
    hooks = record_moe_inputs(host.model, xs_h)
    lh, ch = host.model.prefill({"tokens": tokens})
    ch = host._pad_caches(ch, 2)
    host_logits, fed = [lh], []
    for i in range(8):
        fed.append(torch.argmax(host_logits[-1], dim=-1))
        lh, ch = host.model.decode_step(ch, fed[-1], 100 + i)
        host_logits.append(lh)
    for h in hooks:
        h.remove()
    hooks = record_moe_inputs(card.model, xs_c)
    before = dict(build.LAUNCHES)
    lc, cc = card.model.prefill({"tokens": tokens})
    cc = card._pad_caches(cc, 2)
    card_logits = [lc]
    for i in range(8):
        lc, cc = card.model.decode_step(cc, fed[i].to(dev), 100 + i)
        card_logits.append(lc)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    got = {k: build.LAUNCHES[k] - before[k] for k in before}
    build.LAUNCHES.update(before)
    per = MOE_REDUCED_LAUNCHES[arch]
    want = {"flash_attention": per["flash_attention"],
            "rmsnorm": 9 * per["rmsnorm"], "ssm_scan": 9 * per["ssm_scan"],
            "spike_hist": 0, "ema_scan": 0, "flash_attention_bwd": 0,
            "rmsnorm_bwd": 0, "ssm_scan_bwd": 0}
    if got != want:
        raise AssertionError(f"reduced {arch} {dtype} on the card launched "
                             f"{got}; 1 prefill + 8 decode steps dictate "
                             f"{want}")

    # routing, forward by forward (prefill, then each decode step) and
    # layer by layer, up to the first choice that differs; before it the
    # prefill's MoE inputs agree within the tolerance
    tol = LM_TOL[dtype]
    margins, flips = {}, []
    keys = sorted(xs_h)
    for f in range(9):
        for key in keys:
            moe_h = host.model.layers[key[0]][key[1]].core
            moe_c = card.model.layers[key[0]][key[1]].core
            xh, xc = xs_h[key][f], xs_c[key][f]
            if f == 0 and not flips:
                close(xc, xh, tol, f"{arch} {dtype} MoE input {key}")
            sh, mh = route_order(moe_h, xh)
            sc, _ = route_order(moe_c, xc)
            margins[key] = min(margins.get(key, 1.0), float(mh.min()))
            if not flips:
                for t in torch.nonzero((sh != sc).any(dim=-1))[:, 0].tolist():
                    flips.append(dict(forward=f, layer=list(key), token=t,
                                      host_margin=float(mh[t]),
                                      host=sh[t].tolist(),
                                      card=sc[t].tolist()))
                    if mh[t] >= NEAR_TIE[dtype]:
                        raise AssertionError(
                            f"{arch} {dtype}: routing differs at {flips[-1]},"
                            f" not a near tie (< {NEAR_TIE[dtype]})")
    errs = {}
    if not flips:
        # decode caches (and so the decode softmax) are bf16 for either
        # parameter dtype: decode and every cache after it (a Mamba state
        # too, fed by attention over bf16 caches) are held to the bf16
        # tolerance, as in phase 7
        bf16 = LM_TOL[torch.bfloat16]
        errs["prefill_logits"] = close(card_logits[0], host_logits[0], tol,
                                       f"{arch} prefill logits {dtype}")
        errs["decode_logits"] = max(
            close(c, h, bf16, f"{arch} decode logits {dtype} step {i}")
            for i, (c, h) in enumerate(zip(card_logits[1:],
                                           host_logits[1:])))
        errs["caches"] = max(
            close(cc[name][key], ch[name][key], bf16,
                  f"{arch} cache {name}/{key} {dtype}")
            for name in cc for key in cc[name])
    per_sub = moe_sublayers_vs_host(host, card.model, dev, tokens, fed,
                                    dtype, arch)
    log(f"MoE card vs host, sublayer by sublayer on the host's inputs: "
        f"reduced {arch} {dtype}, prefill and 8 decode steps: "
        + ", ".join(f"{k} max|err| {v:.3e} ({per_sub['of_tolerance'][k]:.2f}"
                    f" of the tolerance)" for k, v in per_sub["err"].items())
        + f"; {len(per_sub['flips'])} token(s) routed differently on the "
        f"same input"
        + (f" (first {json.dumps(per_sub['flips'][0])})"
           if per_sub["flips"] else ""))
    log(f"MoE card vs host: reduced {arch} ({cfg.num_layers} layers) {dtype}"
        f", 2 x 100 prompt, 8 teacher-forced decode steps: launches "
        f"{json.dumps({k: got[k] for k in per})}; "
        + (", ".join(f"{k} max|err| {v:.3e}" for k, v in errs.items())
           + f" (prefill rtol {tol['rtol']} + atol {tol['atol']}; decode and"
           f" bf16 caches rtol 2e-2 + atol 5e-2)" if not flips else
           f"routing flips at a near tie, first {json.dumps(flips[0])} "
           f"({len(flips)} token(s)): MoE inputs held up to it, the whole "
           f"model's logits and caches not compared")
        + "; smallest routing margin per MoE layer "
        + ", ".join(f"{k[0]}/{k[1]} {v:.3e}" for k, v in margins.items()))
    return dict(launches={k: got[k] for k in per}, err=errs, flips=flips,
                margins={f"{k[0]}/{k[1]}": v for k, v in margins.items()},
                sublayers=per_sub)


def moe_card_vs_host_phase(dev, card: str) -> dict:
    """Phase 14: the reduced granite-moe, deepseek-v2 and jamba models,
    float32 and bfloat16 parameters, on the card against the host."""
    t0 = time.perf_counter()
    out = {f"{arch} {str(dtype)[6:]}": moe_card_vs_host(dev, arch, dtype)
           for arch in (GRANITE, DEEPSEEK, JAMBA)
           for dtype in (torch.float32, torch.bfloat16)}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14 (MoE, MLA, hybrid card vs host): {out['seconds']:.3f} s "
        f"[{card}]")
    return out


def moe_serve_phase(dev, card: str, trace_out: str | None,
                    trace: bool) -> dict:
    """Phase 15: granite-moe-3b-a800m at full width and depth, then (its
    engine released) deepseek-v2-236b at full width on 4 of its 60 layers,
    each answering ``REQUESTS``."""
    from repro_torch.configs import ARCHS
    t0 = time.perf_counter()
    out = {GRANITE: serve_phase(dev, card, ARCHS[GRANITE], REQUESTS,
                                attn_launches, trace_out, trace)}
    torch.cuda.empty_cache()
    cut = dataclasses.replace(ARCHS[DEEPSEEK], num_layers=DEEPSEEK_LAYERS)
    log(f"{DEEPSEEK}: cut to {DEEPSEEK_LAYERS} of its "
        f"{ARCHS[DEEPSEEK].num_layers} layers at full width (244.2 B "
        f"parameters do not fit one card; 4 layers hold 17.26 B)")
    out[DEEPSEEK] = serve_phase(dev, card, cut, REQUESTS, mla_launches,
                                trace_out, False)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 15 (MoE serving): {out['seconds']:.3f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phases 17-18: VLM and encoder-decoder serving
# ---------------------------------------------------------------------------
VLM = "llama-3.2-vision-11b"
WHISPER = "whisper-medium"
WHISPER_FRAMES = 1500        # whisper's 30 s window (arXiv:2212.04356)
WHISPER_REQUESTS = ((4, 64), (1, 384))


def seed_gates(model, seed: int = 21) -> list:
    """Each vlm gate (zero at init, where ``tanh(0)`` leaves the cross
    sublayers out of the output) set to a draw in [0.5, 1.5] from ``seed``,
    in parameter order: test data, the same on the card and the host.
    Returns the values."""
    rng = np.random.default_rng(seed)
    values = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                value = float(rng.uniform(0.5, 1.5))
                p.fill_(value)
                values.append(value)
    return values


def stub_inputs(cfg, b: int, memory: int | None = None,
                seed: int = 13) -> dict:
    """A request's stub input as the launchers draw it (``standard_normal
    * 0.02``, float32): the vlm's image embeddings (b, num_image_tokens,
    d) or the enc-dec's frames (b, memory, d)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_embeds": (rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
            * 0.02)}
    return {"frames": rng.standard_normal(
        (b, memory, cfg.d_model)).astype(np.float32) * 0.02}


def vlm_launches(cfg, n_requests: int, new_tokens: int | None = None
                 ) -> dict:
    """What llama-3.2-vision-11b dictates: one flash launch per self- and
    per cross-attention layer and prefill (decode attends in plain
    PyTorch), one rmsnorm per norm and forward (two a layer, one a cross
    sublayer, the final one), no scan."""
    n_cross = cfg.num_layers // cfg.cross_attn_period
    forwards = 1 + (NEW_TOKENS if new_tokens is None else new_tokens)
    return {"flash_attention": (cfg.num_layers + n_cross) * n_requests,
            "rmsnorm": (2 * cfg.num_layers + n_cross + 1) * forwards
            * n_requests, "ssm_scan": 0}


def encdec_launches(cfg, n_requests: int, new_tokens: int | None = None
                    ) -> dict:
    """What whisper-medium dictates: one flash launch per encoder layer and
    per decoder self- and cross-attention layer and prefill; LayerNorm
    everywhere, so no rmsnorm; no scan."""
    return {"flash_attention": (cfg.num_encoder_layers + 2 * cfg.num_layers)
            * n_requests, "rmsnorm": 0, "ssm_scan": 0}


def cross_card_vs_host(dev, arch: str, dtype) -> dict:
    """One reduced model with the same weights (gates drawn away from 0)
    on the card (kernels) and on the CPU (plain versions): prefill logits
    within the parameters' tolerance, the prefill's caches (self and
    cross) too, 8 teacher-forced decode steps and the decode caches within
    bf16's (the engine keeps them in bf16), launches exactly as the model
    dictates."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    cfg = ARCHS[arch].reduced()
    steps, prompt = 8, 100
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, prompt))}
    batch.update(stub_inputs(cfg, 2, memory=150))
    mem_len = batch["frames"].shape[1] if "frames" in batch else None
    host = ServeEngine(cfg, max_len=prompt + steps + 4, device="cpu",
                       dtype=dtype)
    host.init_params(0)
    gates = seed_gates(host.model)
    card = ServeEngine(cfg, max_len=prompt + steps + 4, device=dev,
                       dtype=dtype)
    card.model.load_state_dict(host.model.state_dict())
    tol, bf16 = LM_TOL[dtype], LM_TOL[torch.bfloat16]
    lh, ch0 = host.model.prefill(batch)
    ch = host._pad_caches(ch0, 2, memory_len=mem_len)
    host_logits, fed = [lh], []
    for i in range(steps):
        fed.append(torch.argmax(host_logits[-1], dim=-1))
        lh, ch = host.model.decode_step(ch, fed[-1], prompt + i)
        host_logits.append(lh)
    before = dict(build.LAUNCHES)
    lc, cc0 = card.model.prefill(batch)
    cc = card._pad_caches(cc0, 2, memory_len=mem_len)
    card_logits = [lc]
    for i in range(steps):
        lc, cc = card.model.decode_step(cc, fed[i].to(dev), prompt + i)
        card_logits.append(lc)
    dictates = vlm_launches if cfg.family == "vlm" else encdec_launches
    want = dictates(cfg, 1, new_tokens=steps)
    got = {k: build.LAUNCHES[k] - before[k] for k in want}
    build.LAUNCHES.update(before)
    if got != want:
        raise AssertionError(f"the reduced {arch} on the card launched "
                             f"{got}, the model dictates {want}")
    errs = {"prefill_logits": close(card_logits[0], host_logits[0], tol,
                                    f"{arch} prefill logits {dtype}")}
    errs["prefill_caches"] = max(
        close(cc0[name][key], ch0[name][key], tol,
              f"{arch} prefill cache {name}.{key} {dtype}")
        for name in ch0 for key in ch0[name])
    errs["decode_logits"] = max(
        close(c, h, bf16, f"{arch} decode logits {dtype} step {i}")
        for i, (c, h) in enumerate(zip(card_logits[1:], host_logits[1:])))
    errs["decode_caches"] = max(
        close(cc[name][key], ch[name][key], bf16,
              f"{arch} decode cache {name}.{key} {dtype}")
        for name in ch for key in ch[name])
    return dict(launches=got, errors=errs, gates=gates,
                caches=sorted(ch0))


def cross_card_vs_host_phase(dev, card: str) -> dict:
    """Phase 17: the reduced llama-3.2-vision-11b and whisper-medium, card
    against host, float32 and bfloat16."""
    t0 = time.perf_counter()
    out = {}
    for arch in (VLM, WHISPER):
        for dtype in (torch.float32, torch.bfloat16):
            r = cross_card_vs_host(dev, arch, dtype)
            tol = LM_TOL[dtype]
            out[f"{arch} {str(dtype).split('.')[1]}"] = r
            log(f"cross-attention card vs host: reduced {arch} {dtype} "
                f"(gates {json.dumps([round(g, 4) for g in r['gates']])}), "
                f"2 x 100 prompt: max|err| {json.dumps(r['errors'])} "
                f"(prefill within rtol {tol['rtol']} + atol {tol['atol']}, "
                f"decode and bf16 caches within the bf16 tolerance); "
                f"launches {json.dumps(r['launches'])}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17 (vlm and enc-dec card vs host): {out['seconds']:.3f} s "
        f"[{card}]")
    return out


def cross_serve_phase(dev, card: str, trace_out: str | None,
                      trace: bool) -> dict:
    """Phase 18: llama-3.2-vision-11b at full width and depth answering
    ``REQUESTS`` with 1,600 image embeddings each, then (its engine
    released) whisper-medium answering ``WHISPER_REQUESTS`` over 1,500
    frames."""
    from repro_torch.configs import ARCHS
    t0 = time.perf_counter()
    out = {VLM: serve_phase(dev, card, ARCHS[VLM], REQUESTS, vlm_launches,
                            trace_out, trace,
                            inputs=lambda cfg, b: stub_inputs(cfg, b))}
    torch.cuda.empty_cache()
    out[WHISPER] = serve_phase(
        dev, card, ARCHS[WHISPER], WHISPER_REQUESTS, encdec_launches,
        trace_out, trace,
        inputs=lambda cfg, b: stub_inputs(cfg, b, memory=WHISPER_FRAMES))
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18 (vlm and enc-dec serving): {out['seconds']:.3f} s "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 12: the session path (MinosSession, its store, the fleet's failures)
# ---------------------------------------------------------------------------
SESSION_BUDGET_FRACTION = 0.75     # the benches' oversubscription target
CHAOS_CHUNK_SAMPLES = 100          # bench_chaos / bench_recovery chunks
RECOVERY_FAIL_FRACTION = 0.40      # bench_recovery: fail at 40 % of chunks
RECOVERY_CRASH_FRACTION = 0.55     # ... and SIGKILL at 55 %
ONLINE_FRACTIONS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
# journal records between snapshots in the 10,000-job stored run: its
# ~20,000 records (admits and decisions) give two cadence snapshots, where
# the store's default of 25 would write ~800 snapshots of up to 10,000 jobs
SCALE_SNAPSHOT_EVERY = 10_000


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def take_launches() -> dict:
    """The profiling kernels' launch counts since the last call, which
    sets them to 0 again (every part of the phase starts from 0)."""
    from repro_torch.kernels import build
    got = {k: build.LAUNCHES[k] for k in ("spike_hist", "ema_scan")}
    build.reset_launches()
    return got


def micro_streams():
    from repro_torch.telemetry import kernel_stream as ks
    return [ks.micro_gemm(), ks.micro_spmv_memory(), ks.micro_spmv_compute(),
            ks.micro_idle_burst(), ks.micro_stencil()]


def micro_library(device, target_duration: float):
    """The benches' smoke library: the five micro streams at 0.6/0.8/1.0."""
    from repro_torch.api import (ReferenceLibrary, TPUPowerModel,
                                 stream_profile_workload)
    model = TPUPowerModel()
    return ReferenceLibrary(
        (stream_profile_workload(s, model, (0.6, 0.8, 1.0), model.spec.tdp_w,
                                 seed=i, target_duration=target_duration,
                                 device=device)
         for i, s in enumerate(micro_streams())),
        built_on=model.spec.name, device=device)


def smoke_assignment(counts: dict, jobs):
    """The benches' round-robin placement on a seeded variability-on
    inventory and their 75 %-of-nameplate budget."""
    from repro_torch.api import DeviceInventory, VariabilityModel
    inventory = DeviceInventory.generate(counts, VariabilityModel(), seed=7)
    assigned = [(s, chips, inventory[i % len(inventory)])
                for i, (s, chips) in enumerate(jobs)]
    nameplate = sum(chips * dev.nameplate_w for _, chips, dev in assigned)
    return inventory, assigned, SESSION_BUDGET_FRACTION * nameplate


def sustained_violations(report, assigned, inventory, budget, seed0: int,
                         target_duration: float, job_id) -> tuple[int, float]:
    """The benches' ground truth: every placed job re-simulated at its cap
    on its final device, the time-aligned aggregate's 50-sample rolling
    mean held to the budget.  Returns (violations, peak sustained W)."""
    from repro_torch.api import simulate
    placed = {p.job_id: p for p in report.schedule.placed}
    traces = []
    for i, (stream, _, _) in enumerate(assigned):
        plan = placed.pop(job_id(i, stream), None)
        if plan is None:
            continue
        dev = inventory.get(plan.device_id)
        tr = simulate(stream, plan.cap, dev.power_model(), seed=seed0 + i,
                      target_duration=target_duration)
        traces.append(plan.chips * tr.power_filtered)
    if placed:
        raise AssertionError(f"unmatched placed plans: {sorted(placed)}")
    n = max(len(t) for t in traces)
    agg = np.sum([np.resize(t, n) for t in traces], axis=0)
    sustained = np.convolve(agg, np.ones(SUSTAIN_WINDOW) / SUSTAIN_WINDOW,
                            mode="valid")
    return int(np.sum(sustained > budget)), float(sustained.max())


def short_id(i: int, stream) -> str:
    return f"j{i:02d}:{stream.name}"


def session_fleet_smoke(device) -> dict:
    """``bench_fleet.py --smoke`` through the port's ``MinosSession``."""
    from repro_torch.api import MinosSession
    streams = micro_streams()
    lib = micro_library(device, 1.0)
    inventory, assigned, budget = smoke_assignment(
        {"tpu-v5e": 2, "tpu-v5p": 1},
        [(s, 4 * (i % 3 + 1)) for i, s in enumerate(streams)])
    take_launches()
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           objective="powercentric", quantile="p99",
                           min_confidence=0.2, device=device)
    for i, (stream, chips, dev) in enumerate(assigned):
        session.submit(stream, device=dev, chips=chips,
                       job_id=short_id(i, stream), seed=500 + i,
                       target_duration=1.0)
    report = session.run()
    sync(device)
    launches = take_launches()
    violations, _ = sustained_violations(report, assigned, inventory, budget,
                                         500, 1.0, short_id)
    return dict(early_decisions=report.early_decisions,
                repacks=report.repacks, chunks_dropped=report.chunks_dropped,
                placed=len(report.schedule.placed),
                deferred=len(report.schedule.deferred),
                planned_power_w=round(report.schedule.planned_power_w, 1),
                budget_violations=violations, launches=launches)


def chaos_schedule(total_chunks: int, assigned, seed: int):
    """bench_chaos's seeded schedule: kill one loaded device a quarter of
    the way in, degrade another at half, restore the first at 70 %, kill a
    second at 80 %."""
    rng = np.random.default_rng(seed)
    loaded = sorted({dev.device_id for _, _, dev in assigned})
    victims = [loaded[int(rng.integers(len(loaded)))]]
    rest = [d for d in loaded if d not in victims]
    degraded = rest[int(rng.integers(len(rest)))]
    second = [d for d in rest if d != degraded]
    victims.append(second[int(rng.integers(len(second)))])
    return [(int(0.25 * total_chunks), "fail", victims[0]),
            (int(0.50 * total_chunks), "degrade", degraded),
            (int(0.70 * total_chunks), "restore", victims[0]),
            (int(0.80 * total_chunks), "fail", victims[1])]


def session_chaos_smoke(device) -> dict:
    """``bench_chaos.py --smoke`` through the port's ``MinosSession``:
    seeded fail / degrade / restore / fail mid-stream, the mid-profile
    migrants re-profiled, then the session drained (its straggler monitor
    sends the drain down the per-chunk path).  Returns the counts, the
    session, and the launches of the drain after the re-profiling."""
    from repro_torch.api import (FleetTelemetryMux, MinosSession,
                                 StragglerMonitor, count_classifier_calls,
                                 stream_telemetry)
    streams = micro_streams()
    lib = micro_library(device, 1.0)
    inventory, assigned, budget = smoke_assignment(
        {"tpu-v5e": 3, "tpu-v5p": 2},
        [(s, 4 * (i % 3 + 1)) for i, s in enumerate(streams)])
    take_launches()
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           objective="powercentric", quantile="p99",
                           min_confidence=0.2,
                           stragglers=StragglerMonitor(), device=device)
    mux = FleetTelemetryMux()
    handles = {}
    for i, (stream, chips, dev) in enumerate(assigned):
        meta, chunks = stream_telemetry(
            stream, 1.0, dev.power_model(), seed=700 + i,
            target_duration=1.0, chunk_samples=CHAOS_CHUNK_SAMPLES,
            device_id=dev.device_id)
        handle = session.submit(meta, device=dev, chips=chips,
                                job_id=short_id(i, stream))
        handles[handle.job_id] = handle
        mux.add_job(handle.job_id, meta, chunks)
    total = sum(-(-h.meta.n_samples // CHAOS_CHUNK_SAMPLES)
                for h in handles.values())
    pending = chaos_schedule(total, assigned, seed=23)
    calls = count_classifier_calls(session.classifier)
    chaos_calls = 0
    failed_now: set[str] = set()

    def apply(action, device_id):
        nonlocal chaos_calls
        n0 = calls["n"]
        if action == "fail":
            session.fail_device(device_id)
            mux.drop_device(device_id)
            failed_now.add(device_id)
        elif action == "degrade":
            session.degrade_device(device_id)
        else:
            session.restore_device(device_id)
            failed_now.discard(device_id)
        chaos_calls += calls["n"] - n0

    for n, fchunk in enumerate(mux):
        while pending and n >= pending[0][0]:
            apply(*pending.pop(0)[1:])
        if fchunk.device_id in failed_now:
            continue
        handles[fchunk.job_id].feed(fchunk.chunk)
    for _, action, device_id in pending:
        apply(action, device_id)
    reprofiled = 0
    for i, (stream, _, _) in enumerate(assigned):
        handle = handles[short_id(i, stream)]
        if not handle.decided and handle.fraction == 0.0:
            handle.reprofile(stream, seed=900 + i, target_duration=1.0,
                             chunk_samples=CHAOS_CHUNK_SAMPLES)
            reprofiled += 1
    sync(device)
    before_restart = take_launches()
    report = session.run()
    sync(device)
    after_restart = take_launches()
    violations, _ = sustained_violations(report, assigned, inventory, budget,
                                         700, 1.0, short_id)
    return dict(failures=report.failures, migrations=report.migrations,
                reprofiled_jobs=reprofiled, repacks=report.repacks,
                placed=len(report.schedule.placed),
                deferred=len(report.schedule.deferred),
                planned_power_w=round(report.schedule.planned_power_w, 1),
                classifier_calls_chaos=chaos_calls,
                budget_violations=violations,
                device_health=session.device_health,
                launches={k: before_restart[k] + after_restart[k]
                          for k in before_restart},
                launches_after_restart=after_restart, session=session)


def recovery_setup(device):
    """bench_recovery's smoke scenario, identical in the crashing child
    and the resuming parent."""
    streams = micro_streams()
    lib = micro_library(device, 1.0)
    inventory, assigned, budget = smoke_assignment(
        {"tpu-v5e": 3, "tpu-v5p": 2},
        [(s, 4 * (i % 3 + 1)) for i, s in enumerate(streams)])
    return lib, inventory, assigned, budget


def recovery_child(store: str, device) -> None:
    """The crash target: drive the durable session, fail the first job's
    device at 40 % of the chunks, SIGKILL this process at 55 %."""
    import signal
    from repro_torch.api import (FleetTelemetryMux, MinosSession,
                                 stream_telemetry)
    lib, inventory, assigned, budget = recovery_setup(device)
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           min_confidence=0.2, store=store, device=device)
    mux = FleetTelemetryMux()
    handles = {}
    for i, (stream, chips, dev) in enumerate(assigned):
        meta, chunks = stream_telemetry(
            stream, 1.0, dev.power_model(), seed=700 + i,
            target_duration=1.0, chunk_samples=CHAOS_CHUNK_SAMPLES,
            device_id=dev.device_id)
        handle = session.submit(meta, device=dev, chips=chips,
                                job_id=short_id(i, stream))
        handles[handle.job_id] = handle
        mux.add_job(handle.job_id, meta, chunks)
    total = sum(-(-h.meta.n_samples // CHAOS_CHUNK_SAMPLES)
                for h in handles.values())
    fail_at = int(RECOVERY_FAIL_FRACTION * total)
    crash_at = int(RECOVERY_CRASH_FRACTION * total)
    victim = assigned[0][2].device_id
    failed = False
    for n, fchunk in enumerate(mux):
        if n >= crash_at:
            sync(device)
            os.kill(os.getpid(), signal.SIGKILL)     # the crash under test
        if not failed and n >= fail_at:
            session.fail_device(victim)
            mux.drop_device(victim)
            failed = True
        if failed and fchunk.device_id == victim:
            continue
        handles[fchunk.job_id].feed(fchunk.chunk)
    raise AssertionError("stream drained before the scheduled crash")


def session_recovery_smoke(device, workdir: str) -> dict:
    """``bench_recovery.py --smoke``: a child process drives the port's
    durable session on ``device`` and SIGKILLs itself; this process resumes
    the store on ``device`` with the classifier spied, re-profiles the jobs
    that were mid-profile and drains the session."""
    import signal
    from repro_torch.api import MinosSession, count_classifier_calls
    store = os.path.join(workdir, "recovery-store")
    shutil.rmtree(store, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--recovery-child",
         store, "--child-device", str(device)], timeout=600)
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"recovery child exited {proc.returncode}, "
                             f"not by SIGKILL")
    lib, inventory, assigned, budget = recovery_setup(device)
    clf = lib.classifier()
    calls = count_classifier_calls(clf)
    t0 = time.perf_counter()
    session = MinosSession.resume(store, references=clf, device=device)
    sync(device)
    resume_ms = (time.perf_counter() - t0) * 1e3
    resume_calls = calls["n"]
    decided = [jid for jid, h in session.jobs.items() if h.decided]
    take_launches()
    reprofiled = 0
    for i, (stream, _, _) in enumerate(assigned):
        handle = session.jobs[short_id(i, stream)]
        if not handle.decided:
            handle.reprofile(stream, seed=900 + i, target_duration=1.0,
                             chunk_samples=CHAOS_CHUNK_SAMPLES)
            reprofiled += 1
    report = session.run()
    session.close()
    sync(device)
    launches = take_launches()
    with open(os.path.join(store, "journal.jsonl"), "rb") as f:
        journal_records = sum(1 for _ in f)
    violations, _ = sustained_violations(report, assigned, inventory, budget,
                                         700, 1.0, short_id)
    return dict(classifier_calls_resume=resume_calls,
                decisions_recovered=len(decided), reprofiled_jobs=reprofiled,
                migrations=report.migrations,
                placed=len(report.schedule.placed),
                deferred=len(report.schedule.deferred),
                planned_power_w=round(report.schedule.planned_power_w, 1),
                budget_violations=violations, resume_ms=resume_ms,
                journal_records=journal_records,
                launches_after_restart=launches)


def session_online_cap(lib, device) -> dict:
    """``bench_online_cap.py``'s full run: each of the 28 zoo workloads
    submitted to one port session (``profile_to_completion``) and fed
    chunk by chunk, Algorithm 1 on the partial profile at each tenth of the
    trace against the completed profile's caps, the confidence gate riding
    along."""
    from repro_torch.api import (MinosSession, TPUPowerModel,
                                 reference_streams, select_optimal_freq,
                                 stream_telemetry)
    model = TPUPowerModel()
    streams = reference_streams()
    take_launches()
    session = MinosSession(lib, objective="powercentric", actuator="none",
                           min_confidence=0.2, device=device)
    clf = session.classifier
    agree = {obj: {f: 0 for f in ONLINE_FRACTIONS}
             for obj in ("powercentric", "perfcentric")}
    rows = []

    def caps(sel):
        return {"powercentric": sel.f_pwr, "perfcentric": sel.f_perf}

    for i, stream in enumerate(streams):
        meta, chunks = stream_telemetry(stream, 1.0, model, seed=1000 + i,
                                        target_duration=4.0)
        job = session.submit(meta, profile_to_completion=True)
        partial, next_f = {}, 0
        for chunk in chunks:
            job.feed(chunk)
            while next_f < len(ONLINE_FRACTIONS) and \
                    job.fraction >= ONLINE_FRACTIONS[next_f] - 1e-12:
                partial[ONLINE_FRACTIONS[next_f]] = caps(
                    select_optimal_freq(job.snapshot(), clf))
                next_f += 1
        gate = job.decision(finalize=False)
        final = caps(select_optimal_freq(job.profile(), clf))
        for f in ONLINE_FRACTIONS[next_f:]:
            partial[f] = final
        conv = {}
        for obj in agree:
            conv_f = 1.0
            for f in reversed(ONLINE_FRACTIONS):
                if partial[f][obj] != final[obj]:
                    break
                conv_f = f
            conv[obj] = conv_f
            for f in ONLINE_FRACTIONS:
                agree[obj][f] += partial[f][obj] == final[obj]
        rows.append({
            "target": meta.name, "final_cap": final, "converged_at": conv,
            "gate_fraction": None if gate is None else round(gate.fraction, 3),
            "gate_confidence": None if gate is None
            else round(gate.confidence, 3),
            "gate_cap_matches": None if gate is None
            else gate.cap == final["powercentric"]})
    sync(device)
    n = len(streams)
    gated = [r for r in rows if r["gate_fraction"] is not None]
    return {
        "agreement_curve": {obj: {str(f): round(agree[obj][f] / n, 4)
                                  for f in ONLINE_FRACTIONS}
                            for obj in agree},
        "agreement_at_half": {obj: round(agree[obj][0.5] / n, 4)
                              for obj in agree},
        "controller_gate": {
            "decided_early": len(gated), "n_targets": n,
            "mean_fraction": round(float(np.mean(
                [r["gate_fraction"] for r in gated])), 3),
            "cap_match_rate": round(float(np.mean(
                [r["gate_cap_matches"] for r in gated])), 3)},
        "per_workload": rows, "launches": take_launches()}


def session_scale(lib, device, store_dir: str | None,
                  discovery=None) -> dict:
    """``bench_fleet_scale``'s 10,000 jobs through ``MinosSession``:
    ``submit_many`` (round-robin over the 64-device inventory) + ``run()``,
    with a journal in ``store_dir`` when given and ``discovery`` passed to
    the session (quarantine only: no profiler is attached)."""
    from repro_torch.api import (DeviceInventory, MinosSession, SessionStore,
                                 VariabilityModel, fleet_job_mix,
                                 stream_telemetry, to_dict)
    inventory = DeviceInventory.generate(FLEET, VariabilityModel.none(),
                                         seed=7)
    jobs = fleet_job_mix(10_000, seed=11)
    assigned = [(s, c, inventory[i % len(inventory)])
                for i, (s, c) in enumerate(jobs)]
    budget = 0.75 * sum(c * d.nameplate_w for _, c, d in assigned)
    seeds = {name: 500 + i for i, name in
             enumerate(sorted({s.name for s, _, _ in assigned}))}
    telemetry = {}
    for stream, _, dev in assigned:
        key = (stream.name, dev.model)
        if key not in telemetry:
            meta, chunks = stream_telemetry(
                stream, 1.0, dev.power_model(), seed=seeds[stream.name],
                target_duration=0.4, chunk_samples=256)
            telemetry[key] = (meta, list(chunks))
    store, snapshots = None, [0]
    if store_dir is not None:
        shutil.rmtree(store_dir, ignore_errors=True)
        store = SessionStore.create(store_dir,
                                    snapshot_every=SCALE_SNAPSHOT_EVERY)
        flush = store.flush_snapshot

        def counted_flush(*args, **kw):
            wrote = flush(*args, **kw)
            snapshots[0] += bool(wrote)
            return wrote
        store.flush_snapshot = counted_flush
    sync(device)
    take_launches()
    t0 = time.perf_counter()
    session = MinosSession(lib, inventory=inventory, budget_w=budget,
                           quantile="p99", store=store, device=device,
                           discovery=discovery, **GATES)
    session.submit_many(
        [telemetry[(s.name, d.model)] for s, _, d in assigned],
        chips=[c for _, c, _ in assigned],
        job_ids=[f"j{i:05d}:{s.name}" for i, (s, _, _) in
                 enumerate(assigned)])
    report = session.run()
    sync(device)
    elapsed = time.perf_counter() - t0
    fleet = session._fleet
    out = dict(decisions=len(report.decisions),
               early_decisions=report.early_decisions,
               repacks=report.repacks, chunks_dropped=report.chunks_dropped,
               placed=len(report.schedule.placed),
               deferred=len(report.schedule.deferred),
               planned_power_w=report.schedule.planned_power_w,
               jobs_per_s=len(assigned) / elapsed, seconds=elapsed,
               launches=take_launches(),
               state={jid: (to_dict(j.decision), to_dict(j.plan)
                            if j.plan is not None else None)
                      for jid, j in fleet.jobs.items()})
    if session.discovery is not None:
        out["quarantined"] = session.discovery.quarantined
        out["pool"] = len(session.discovery.pool)
    if store is not None:
        out["journal_records"] = store.journal.last_seq
        session.close()
        out["snapshots_written"] = snapshots[0]
        out["journal_bytes"] = sum(
            os.path.getsize(os.path.join(store_dir, f))
            for f in os.listdir(store_dir) if f.startswith("journal"))
        out["snapshot_files"] = sorted(
            f for f in os.listdir(store_dir) if f.startswith("snapshot"))
        out["snapshot_bytes"] = sum(
            os.path.getsize(os.path.join(store_dir, f))
            for f in out["snapshot_files"])
    return out


def session_scale_resume(lib, device, store_dir: str, live: dict) -> dict:
    """Resume the 10,000-job store on ``device`` with the classifier spied:
    0 calls, every decision and plan equal to the live session's."""
    from repro_torch.api import MinosSession, count_classifier_calls, to_dict
    clf = lib.classifier()
    calls = count_classifier_calls(clf)
    sync(device)
    t0 = time.perf_counter()
    session = MinosSession.resume(store_dir, references=clf, device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    got = {jid: (to_dict(j.decision), to_dict(j.plan)
                 if j.plan is not None else None)
           for jid, j in session._fleet.jobs.items()}
    session.close()
    if calls["n"] != 0:
        raise AssertionError(f"resume of the 10,000-job store classified "
                             f"{calls['n']} times")
    if got != live["state"]:
        bad = [jid for jid in live["state"] if got.get(jid)
               != live["state"][jid]]
        raise AssertionError(f"resumed decisions/plans differ from the "
                             f"live session's for {len(bad)} jobs "
                             f"(first {bad[:3]})")
    return dict(seconds=seconds, classifier_calls=calls["n"],
                jobs=len(got))


def engine_columns_equal(card, host, what: str) -> None:
    """Every column of the engine ``card`` bitwise equal to ``host``'s
    after the same drive (slot recycling after migrations and re-profiles
    included)."""
    for name in ("_hist_all", "_ema_state", "_ema_has", "_energy", "_busy",
                 "_next_index", "_n_pending", "_n_committed", "_seen_busy",
                 "_live", "_tdp"):
        if not torch.equal(getattr(card, name).cpu(), getattr(host, name)):
            raise AssertionError(f"engine column {name} on the card differs "
                                 f"from the host's after {what}")


def check_counts(what: str, got: dict, want: dict, keys) -> None:
    for key in keys:
        if got[key] != want[key]:
            raise AssertionError(f"{what}: {key} is {got[key]!r} through the "
                                 f"port's session, {want[key]!r} in the "
                                 f"reference's results")


def check_launches(what: str, launches: dict) -> None:
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{what}: kernel {name} was not launched")


def session_phase(dev, card: str, lib, want_scale: dict,
                  workdir: str) -> dict:
    """Phase 12: the outcome targets through the port's ``MinosSession`` on
    the card, the 10,000-job session with and without a journal, its
    resume, and the kernels' launches in each part."""
    t_phase = time.perf_counter()
    results = {}
    with open(os.path.join(ROOT, "results", "fleet.json")) as f:
        want = json.load(f)
    got = session_fleet_smoke(dev)
    check_counts("fleet.json", got, want,
                 ("early_decisions", "repacks", "chunks_dropped", "placed",
                  "deferred", "planned_power_w", "budget_violations"))
    check_launches("fleet.json drive", got["launches"])
    results["fleet"] = got
    log(f"session fleet.json smoke: {json.dumps(got)}")

    with open(os.path.join(ROOT, "results", "chaos.json")) as f:
        want = json.load(f)
    got = session_chaos_smoke(dev)
    host = session_chaos_smoke("cpu")
    engine_columns_equal(got.pop("session")._fleet.engine,
                         host.pop("session")._fleet.engine,
                         "the chaos schedule")
    check_counts("chaos.json", got, want,
                 ("failures", "migrations", "reprofiled_jobs", "repacks",
                  "placed", "deferred", "planned_power_w",
                  "classifier_calls_chaos", "budget_violations",
                  "device_health"))
    check_launches("chaos.json drive", got["launches"])
    check_launches("chaos.json drain after the re-profile",
                   got["launches_after_restart"])
    results["chaos"] = got
    log(f"session chaos.json smoke: {json.dumps(got)}; engine columns "
        f"bitwise equal to the host's after the schedule")

    with open(os.path.join(ROOT, "results", "recovery.json")) as f:
        want = json.load(f)
    got = session_recovery_smoke(dev, workdir)
    check_counts("recovery.json", got, want,
                 ("classifier_calls_resume", "decisions_recovered",
                  "reprofiled_jobs", "migrations", "placed", "deferred",
                  "planned_power_w", "budget_violations"))
    check_launches("recovery.json drain after the resume",
                   got["launches_after_restart"])
    results["recovery"] = got
    log(f"session recovery.json smoke: {json.dumps(got)}")

    with open(os.path.join(ROOT, "results", "online_cap.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    got = session_online_cap(lib, dev)
    got["seconds"] = time.perf_counter() - t0
    check_counts("online_cap.json", got, want,
                 ("agreement_curve", "agreement_at_half", "controller_gate",
                  "per_workload"))
    check_launches("online_cap.json drive", got["launches"])
    results["online_cap"] = {k: v for k, v in got.items()
                             if k != "per_workload"}
    log(f"session online_cap.json (28 workloads): "
        f"{json.dumps(results['online_cap'])}")

    scale = {}
    for mode, store_dir in (("plain", None),
                            ("journal", os.path.join(workdir, "scale-store"))):
        got = session_scale(lib, dev, store_dir)
        check_counts(f"fleet_scale.json ({mode})", got, want_scale,
                     ("decisions", "early_decisions", "chunks_dropped",
                      "placed", "deferred"))
        rel = abs(got["planned_power_w"] - want_scale["planned_power_w"]) \
            / want_scale["planned_power_w"]
        if rel > 1e-9:
            raise AssertionError(f"fleet_scale.json ({mode}): planned_power_w"
                                 f" {got['planned_power_w']} (rel {rel:.2e})")
        check_launches(f"10,000-job session ({mode})", got["launches"])
        scale[mode] = got
    if scale["plain"]["state"] != scale["journal"]["state"]:
        raise AssertionError("the journaled 10,000-job session decided "
                             "differently from the plain one")
    resume = session_scale_resume(lib, dev, os.path.join(workdir,
                                                         "scale-store"),
                                  scale["journal"])
    results["plain_state"] = scale["plain"]["state"]   # for phase 13
    for got in scale.values():
        got.pop("state")
    results["scale"] = dict(scale, resume=resume,
                            snapshot_every=SCALE_SNAPSHOT_EVERY)
    for mode, got in scale.items():
        log(f"session 10,000 jobs ({mode}) [{card}]: "
            f"{got['jobs_per_s']:.1f} jobs/s ({got['seconds']:.3f} s), "
            f"{json.dumps({k: v for k, v in got.items() if k not in ('jobs_per_s', 'seconds')})}")
    log(f"session 10,000-job resume [{card}]: {resume['seconds']:.3f} s, "
        f"{resume['classifier_calls']} classifier calls, {resume['jobs']} "
        f"jobs' decisions and plans equal to the live session's")
    results["launches"] = {
        "fleet": results["fleet"]["launches"],
        "chaos": results["chaos"]["launches"],
        "chaos_after_restart": results["chaos"]["launches_after_restart"],
        "recovery_after_resume": results["recovery"]["launches_after_restart"],
        "online_cap": results["online_cap"]["launches"],
        "scale_plain": scale["plain"]["launches"],
        "scale_journal": scale["journal"]["launches"]}
    log(f"phase 12 launches: {json.dumps(results['launches'])}")
    results["seconds"] = time.perf_counter() - t_phase
    log(f"phase 12 (session path): {results['seconds']:.3f} s [{card}]")
    return results


# ---------------------------------------------------------------------------
# phase 13: online class discovery and the rest of core/ (K-Means,
# silhouette, baselines)
# ---------------------------------------------------------------------------
# bench_discovery's configuration: the quarantine threshold sits above the
# ~0.7-0.9 band at which a novel family matches an existing class
# decisively-but-wrongly
DISCOVERY = {"quarantine_below": 0.9, "min_cluster": 3,
             "recluster_every": 1000, "promote_agreement": 0.5,
             "cluster_distance": 0.5}
DISCOVERY_FREQS = (0.6, 0.8, 1.0)           # micro_library's sweep
SEEDS_PER_FAMILY = 3             # arrivals per novel family (>= min_cluster)
DISCOVERY_LATENCIES = ("swap_latency_ms", "resume_latency_ms")
DISCOVERY_PARTS = ("library", "submissions", "discover", "after_promotion",
                   "resume")


def discovery_setup(device, smoke: bool):
    """``bench_discovery._setup``: the micro library (five streams) and the
    novel families' full-profile ground truth."""
    from repro_torch.api import (TPUPowerModel, novel_streams,
                                 stream_profile_workload)
    model = TPUPowerModel()
    target_duration = 0.5 if smoke else 1.0
    novel = novel_streams()[:2 if smoke else 4]
    lib = micro_library(device, target_duration)
    truth = {s.name: stream_profile_workload(
        s, model, DISCOVERY_FREQS, model.spec.tdp_w, seed=50 + i,
        target_duration=target_duration, device=device)
        for i, s in enumerate(novel)}
    return model, lib, micro_streams(), novel, truth, target_duration


def discovery_submit(session, streams, model, seeds, target_duration,
                     chips=2):
    """One job per (stream, seed) pair, each run to its decision."""
    from repro_torch.api import stream_telemetry
    handles = []
    for i, stream in enumerate(streams):
        for j in seeds:
            meta = stream_telemetry(stream, 1.0, model,
                                    seed=1000 * (i + 1) + j,
                                    target_duration=target_duration)
            h = session.submit(meta, chips=chips)
            h.run()
            handles.append(h)
    return handles


def discovery_score(handles, truth_by_name, objective) -> dict:
    """Cap agreement against full-profile ground truth + decision stats."""
    from repro_torch.api import truth_selection
    hits, fracs, confs = 0, [], []
    for h in handles:
        d = h.decision()
        truth_cap = objective.cap(truth_selection(
            truth_by_name[h.meta.name], d.selection.bin_size))
        hits += int(d.cap == truth_cap)
        fracs.append(d.fraction)
        confs.append(d.confidence)
    n = len(handles)
    return {"n_jobs": n,
            "cap_agreement": round(hits / n, 4) if n else 0.0,
            "mean_fraction": round(sum(fracs) / n, 4) if n else 0.0,
            "mean_confidence": round(sum(confs) / n, 4) if n else 0.0}


def discovery_bench(device, smoke: bool, workdir: str) -> dict:
    """``bench_discovery.py`` through the port on ``device``, under the
    bench's asserts: in-library baseline, the novel families before
    discovery, the durable discovery loop with the live classifier spied
    across the swap, fresh arrivals after the promotion, the resume across
    the version bump with every classifier any library mints spied (then
    one arrival of each family on the resumed session, which must classify
    to its discovered class), and the discovery-off checks.  The profiling
    kernels' launches are counted part by part."""
    from repro_torch.api import (MinosSession, ReferenceLibrary,
                                 count_classifier_calls, resolve_objective,
                                 stream_profiler, to_json)
    launches = {}
    sync(device)
    take_launches()
    model, lib, library_streams, novel, truth, target_duration = \
        discovery_setup(device, smoke)
    sync(device)
    launches["library"] = take_launches()
    objective = resolve_objective("powercentric")
    seeds = range(SEEDS_PER_FAMILY)
    truth_in_library = {p.name: p for p in lib}

    plain = MinosSession(lib, device=device, **GATES)
    baseline = discovery_score(discovery_submit(
        plain, library_streams, model, seeds, target_duration),
        truth_in_library, objective)
    before_session = MinosSession(lib, device=device, **GATES)
    novel_before = discovery_score(discovery_submit(
        before_session, novel, model, seeds, target_duration), truth,
        objective)
    store = os.path.join(workdir, f"discovery-{'smoke' if smoke else 'full'}")
    shutil.rmtree(store, ignore_errors=True)
    session = MinosSession(lib, store=store, discovery=DISCOVERY,
                           device=device, **GATES)
    discovery_submit(session, novel, model, seeds, target_duration)
    quarantined = len(session.discovery.pool)
    sync(device)
    launches["submissions"] = take_launches()

    session.discovery.profiler = stream_profiler(
        novel, model, DISCOVERY_FREQS, model.spec.tdp_w,
        target_duration=target_duration, device=device)
    live_calls = count_classifier_calls(session._fleet.clf)
    t0 = time.perf_counter()
    promo = session.discover(force=True)
    sync(device)
    swap_ms = (time.perf_counter() - t0) * 1e3
    swap_calls = live_calls["n"]
    promoted = promo["classes"] if promo else []
    launches["discover"] = take_launches()

    after_handles = discovery_submit(session, novel, model,
                                     [100 + s for s in seeds],
                                     target_duration)
    novel_after = discovery_score(after_handles, truth, objective)
    absorbed = sum(1 for h in after_handles
                   if h.decision().selection.power_neighbor in promoted)
    sync(device)
    launches["after_promotion"] = take_launches()

    session.close()
    spies = []
    orig_classifier = ReferenceLibrary.classifier

    def spied_classifier(self, *a, **k):
        clf = orig_classifier(self, *a, **k)
        spies.append(count_classifier_calls(clf))
        return clf

    ReferenceLibrary.classifier = spied_classifier
    try:
        t0 = time.perf_counter()
        resumed = MinosSession.resume(store, references=lib, device=device)
        sync(device)
        resume_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ReferenceLibrary.classifier = orig_classifier
    resume_calls = sum(s["n"] for s in spies)
    resumed_version = (resumed.discovery.version
                       if resumed.discovery else 1)
    resume_only = dict(take_launches())
    continued = discovery_submit(resumed, novel, model, [200], target_duration)
    continued_absorbed = sum(
        1 for h in continued
        if h.decision().selection.power_neighbor in promoted)
    resumed.close()
    sync(device)
    launches["resume"] = {k: resume_only[k] + n
                          for k, n in take_launches().items()}

    def library_traffic(discovery=None):
        s = MinosSession(lib, discovery=discovery, device=device, **GATES)
        handles = discovery_submit(s, library_streams, model, seeds,
                                   target_duration)
        return to_json(s.report()), [
            (d.target, d.cap, d.early, round(d.fraction, 6))
            for d in (h.decision() for h in handles)]

    rep_a, dec_a = library_traffic()
    rep_b, dec_b = library_traffic()
    _, dec_c = library_traffic(DISCOVERY)          # quarantine only
    discovery_off_identical = (rep_a == rep_b and dec_a == dec_b
                               and dec_a == dec_c)
    take_launches()
    out = {
        "config": {"smoke": smoke, "novel_families": [s.name for s in novel],
                   "seeds_per_family": SEEDS_PER_FAMILY,
                   "discovery": DISCOVERY},
        "baseline": baseline,
        "novel_before": novel_before,
        "novel_after": novel_after,
        "quarantined": quarantined,
        "promoted": promoted,
        "absorbed_by_promoted": absorbed,
        "swap_latency_ms": round(swap_ms, 3),
        "swap_classifier_calls": swap_calls,
        "resume_latency_ms": round(resume_ms, 3),
        "resume_classifier_calls": resume_calls,
        "resumed_library_version": resumed_version,
        "discovery_off_identical": bool(discovery_off_identical),
    }
    if not promoted:
        raise AssertionError(f"no class promoted from {quarantined} "
                             f"quarantined novel arrivals")
    if swap_calls != 0 or resume_calls != 0:
        raise AssertionError(f"classifier calls: {swap_calls} on the swap, "
                             f"{resume_calls} on the resume (must be 0)")
    if resumed_version < 2:
        raise AssertionError(f"resume came back at library version "
                             f"{resumed_version}")
    if not discovery_off_identical:
        raise AssertionError("a session without the discovery key is not "
                             "byte-identical run-to-run, or a quarantine-"
                             "only session changed decisions")
    if novel_after["cap_agreement"] < baseline["cap_agreement"] - 0.25:
        raise AssertionError(f"post-promotion novel agreement "
                             f"{novel_after['cap_agreement']} fell more than "
                             f"0.25 below the baseline "
                             f"{baseline['cap_agreement']}")
    if continued_absorbed != len(continued):
        raise AssertionError(f"{len(continued) - continued_absorbed} of "
                             f"{len(continued)} arrivals after the resume "
                             f"missed the discovered classes")
    return dict(result=out, launches=launches, resume_only=resume_only,
                continued=len(continued))


def check_discovery_json(got: dict, want: dict) -> None:
    """``results/discovery.json`` exactly, but the two latencies."""
    for key, value in want.items():
        if key in DISCOVERY_LATENCIES:
            continue
        if got[key] != value:
            raise AssertionError(f"discovery.json: {key} is {got[key]!r} "
                                 f"through the port, {value!r} in the "
                                 f"reference's results")


def classification_tables(lib) -> dict:
    """``bench_classification.py`` on the port: Table 1's class columns,
    the silhouette sweep and the dendrogram text (paper Figs. 3-4)."""
    from repro_torch.core.clustering import dendrogram_order
    refs = lib.profiles
    clf = lib.classifier()
    names = lib.names
    Z = clf.power_linkage()
    power_labels = clf.power_classes(k=3)
    means = {}
    for c in set(power_labels):
        members = [refs[i] for i in range(len(refs)) if power_labels[i] == c]
        means[c] = np.mean([m.p_quantile(90) for m in members])
    rank = {c: i for i, c in enumerate(sorted(means, key=means.get))}
    tags = ["Low-spike", "Mixed", "High-spike"]
    power_class = {n: tags[rank[c]] for n, c in zip(names, power_labels)}
    util_labels, centers, k_best, sil_scores = clf.util_classes()
    cmeans = {c: centers[c][1] - centers[c][0] for c in range(k_best)}
    crank = {c: i for i, c in enumerate(sorted(cmeans, key=cmeans.get))}
    utags = ["M", "H", "C"] if k_best == 3 else [f"U{i}" for i in
                                                  range(k_best)]
    util_class = {n: utags[crank[c]] for n, c in zip(names, util_labels)}
    rows = [{"workload": r.name, "domain": r.domain,
             "pwr_class": power_class[r.name],
             "util_class": util_class[r.name],
             "p90": round(r.p_quantile(90), 3),
             "mean": round(r.mean_power, 3),
             "sm_util": round(r.sm_util, 3),
             "dram_util": round(r.dram_util, 3)} for r in refs]
    lines = ["power-spike dendrogram (ward/cosine), leaves in merge order:"]
    for i in dendrogram_order(Z):
        lines.append(f"  [{power_class[names[i]][0]}] {names[i]}")
    return {"table1": rows,
            "silhouette_by_k": {str(k): round(v, 4)
                                for k, v in (sil_scores or {}).items()},
            "k_best": k_best, "dendrogram": "\n".join(lines)}


def unique_library(lib):
    """``benchmarks/common.unique_library``: the train cell of each arch and
    every microbenchmark, as a sub-library (cached rows carried over)."""
    keep, seen = set(), set()
    for r in lib.profiles:
        if ":" in r.name:
            arch, shape = r.name.split(":")
            if shape != "train_4k" or arch in seen:
                continue
            seen.add(arch)
        keep.add(r.name)
    return lib.subset(lambda p: p.name in keep)


def nearest_freq(profile, f: float) -> float:
    return min(profile.scaling, key=lambda x: abs(x - f))


def holdout_power_error(target, neighbor, quantile: str = "p90"):
    """(abs prediction error, selected cap, observed value), PowerCentric."""
    from repro_torch.core.algorithm1 import POWER_BOUND, cap_power_centric
    f = cap_power_centric(neighbor, POWER_BOUND, quantile)
    pred = getattr(neighbor.scaling[nearest_freq(neighbor, f)], quantile)
    obs = getattr(target.scaling[nearest_freq(target, f)], quantile)
    return abs(obs - pred), f, obs


def degradation(profile, f: float) -> float:
    base = profile.scaling[max(profile.scaling)].exec_time
    return profile.scaling[nearest_freq(profile, f)].exec_time / base - 1.0


def holdout_perf_error(target, neighbor):
    from repro_torch.core.algorithm1 import cap_perf_centric
    f = cap_perf_centric(neighbor)
    pred = degradation(neighbor, f)
    obs = degradation(target, f)
    return abs(obs - pred), f, obs


def holdout_table(lib) -> dict:
    """``bench_holdout.py`` on the port (paper §7.2, Figs. 9-11)."""
    uniq_lib = unique_library(lib)
    uniq = uniq_lib.profiles
    clf = uniq_lib.classifier()
    rows = []
    for target, (nn_pwr, d_pwr), (nn_perf, d_perf) in zip(
            uniq, clf.power_neighbors(uniq), clf.util_neighbors(uniq)):
        rec = {"target": target.name, "power_neighbor": nn_pwr.name,
               "cos_distance": round(d_pwr, 4),
               "perf_neighbor": nn_perf.name,
               "eucl_distance": round(d_perf, 4)}
        for q in ("p90", "p95", "p99"):
            err, f, _ = holdout_power_error(target, nn_pwr, q)
            rec[f"{q}_err"] = round(err, 4)
            rec[f"{q}_cap"] = f
        perr, pf, _ = holdout_perf_error(target, nn_perf)
        rec["perf_err"] = round(perr, 4)
        rec["perf_cap"] = pf
        rows.append(rec)
    mean = {q: float(np.mean([r[f"{q}_err"] for r in rows]))
            for q in ("p90", "p95", "p99")}
    mean["perf"] = float(np.mean([r["perf_err"] for r in rows]))
    perfect = sum(1 for r in rows if r["perf_err"] < 0.005)

    def binify(dist_key, err_key, edges):
        out = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            sel = [r[err_key] for r in rows if lo <= r[dist_key] < hi]
            out.append({"bin": f"[{lo},{hi})", "n": len(sel),
                        "mean_err": round(float(np.mean(sel)), 4)
                        if sel else None})
        return out

    return {"rows": rows,
            "mean_errors": {k: round(v, 4) for k, v in mean.items()},
            "perfect_perf_predictions": f"{perfect}/{len(rows)}",
            "err_by_cos_distance": binify("cos_distance", "p90_err",
                                          [0, 0.02, 0.05, 0.1, 0.25, 1.01]),
            "err_by_eucl_distance": binify("eucl_distance", "perf_err",
                                           [0, 0.05, 0.1, 0.2, 0.5, 10.0])}


def baseline_table(lib) -> dict:
    """``bench_baseline_cmp.py`` on the port: Minos against the Guerreiro
    et al. mean-power classifier and a utilization-only one (paper §7.3)."""
    from repro_torch.core.baselines import (mean_power_neighbor,
                                            util_only_neighbor)
    uniq_lib = unique_library(lib)
    uniq = uniq_lib.profiles
    clf = uniq_lib.classifier()
    rows = []
    for target in uniq:
        nn_minos, _ = clf.power_neighbor(target)
        nn_mean, _ = mean_power_neighbor(target, uniq)
        nn_util, _ = util_only_neighbor(target, uniq)
        rec = {"target": target.name}
        for tag, nn in (("minos", nn_minos), ("guerreiro", nn_mean),
                        ("util_only", nn_util)):
            for q in ("p90", "p95", "p99"):
                err, _, _ = holdout_power_error(target, nn, q)
                rec[f"{tag}_{q}"] = round(err, 4)
            rec[f"{tag}_nn"] = nn.name
        rows.append(rec)
    means = {f"{tag}_{q}": round(float(np.mean(
        [r[f"{tag}_{q}"] for r in rows])), 4)
        for tag in ("minos", "guerreiro", "util_only")
        for q in ("p90", "p95", "p99")}
    return {"rows": rows, "means": means}


# the paper's remaining tables (phase 16), each ``run()`` of its bench on
# the port; numbers are rounded on the host, as the benches round them
def savings_table(lib) -> dict:
    """``bench_savings.py``: one profile against a full sweep (§7.1.3)."""
    from repro_torch.analysis.hardware import FREQ_SWEEP
    from repro_torch.core.algorithm1 import profiling_savings
    rows = {r.name: round(profiling_savings(r, list(FREQ_SWEEP)), 4)
            for r in lib.profiles}
    mean = float(np.mean(list(rows.values())))
    return {"per_workload": rows, "mean": round(mean, 4),
            "paper_claim": "89-90% for FAISS/Qwen1.5-MoE"}


def freq_scaling_table(lib) -> dict:
    """``bench_freq_scaling.py``: slowdown under each cap (Fig. 7)."""
    rows = {}
    for r in lib.profiles:
        base = r.scaling[max(r.scaling)].exec_time
        rows[r.name] = {str(f): round(r.scaling[f].exec_time / base - 1.0, 4)
                        for f in sorted(r.scaling)}
    return rows


BIN_STUDY = (0.05, 0.1, 0.15, 0.2, 0.25, 0.5, 0.75)   # bench_binsize.py's


def binsize_table(lib) -> dict:
    """``bench_binsize.py``: p90 error of the power neighbour per bin size,
    normalised to 0.1 (§7.4, Fig. 12)."""
    uniq_lib = unique_library(lib)
    uniq = uniq_lib.profiles
    clf = uniq_lib.classifier()
    p90 = {r.name: r.p_quantile(90) for r in uniq}
    errs = {}
    for c in BIN_STUDY:
        neighbors = clf.power_neighbors(uniq, bin_size=c)
        errs[c] = float(np.mean([abs(p90[t.name] - p90[nn.name])
                                 for t, (nn, _) in zip(uniq, neighbors)]))
    base = errs[0.1] or 1e-9
    return {"raw": {str(c): round(v, 4) for c, v in errs.items()},
            "normalized_to_0.1": {str(c): round(errs[c] / base, 3)
                                  for c in BIN_STUDY}}


def case_study_table(lib, device) -> list:
    """``bench_case_study.py``: Algorithm 1 on the held-out workloads, one
    uncapped profile each built on ``device``, judged against their
    ground-truth sweeps (Fig. 8, Table 2)."""
    from repro_torch.analysis.hardware import FREQ_SWEEP
    from repro_torch.core.algorithm1 import (PERF_BOUND, POWER_BOUND,
                                             profiling_savings,
                                             select_optimal_freq)
    from repro_torch.telemetry import build_holdout_profiles
    clf = lib.classifier()
    observed, truth = build_holdout_profiles(with_truth=True, device=device)
    truth_by_name = {t.name: t for t in truth}
    rows = []
    for obs in observed:
        tru = truth_by_name[obs.name]
        sel = select_optimal_freq(obs, clf)
        obs_p90 = tru.scaling[nearest_freq(tru, sel.f_pwr)].p90
        obs_degr = degradation(tru, sel.f_perf)
        rows.append({
            "target": obs.name,
            "power_neighbor": sel.power_neighbor,
            "cos_distance": round(sel.power_distance, 4),
            "perf_neighbor": sel.util_neighbor,
            "eucl_distance": round(sel.util_distance, 4),
            "bin_size": sel.bin_size,
            "f_pwr": sel.f_pwr, "f_perf": sel.f_perf,
            "observed_p90_at_cap": round(obs_p90, 4),
            "power_bound_violation": round(max(obs_p90 - POWER_BOUND, 0.0),
                                           4),
            "observed_degr_at_cap": round(obs_degr, 4),
            "perf_bound_violation": round(max(obs_degr - PERF_BOUND, 0.0),
                                          4),
            "profiling_savings": round(profiling_savings(
                tru, list(FREQ_SWEEP)), 4),
        })
    return rows


CDF_CAPS = (1.0, 0.8, 0.6)                           # bench_cdf.py's
CDF_WORKLOADS = ("sgemm-25k", "pagerank-pannotia", "lsms-like",
                 "command-r-35b:train_4k", "command-r-35b:decode_32k",
                 "deepseek-v2-236b:train_4k")


def cdf_table(device) -> dict:
    """``bench_cdf.py``: per-class power CDFs and their shift under caps
    (Figs. 5-6).  The traces are the host simulator's (seed 11, 2 s); the
    CDF and the p90 run on ``device``."""
    from repro_torch.analysis.hardware import V5E
    from repro_torch.core import spikes
    from repro_torch.telemetry import TPUPowerModel, simulate
    from repro_torch.telemetry.workloads import reference_streams
    model = TPUPowerModel()
    tdp = V5E.tdp_w
    grid = np.linspace(0.0, 2.0, 101)
    streams = {s.name: s for s in reference_streams()}
    out = {"grid": grid.tolist(), "cdfs": {}}
    shift = {}
    for name in CDF_WORKLOADS:
        out["cdfs"][name] = {}
        p90s = {}
        for f in CDF_CAPS:
            tr = simulate(streams[name], f, model, seed=11,
                          target_duration=2.0)
            power = torch.from_numpy(tr.power_filtered).to(device)
            _, cdf = spikes.spike_cdf(power, tdp, grid)
            out["cdfs"][name][str(f)] = np.round(cdf.cpu().numpy(),
                                                 4).tolist()
            p90s[f] = spikes.p_quantile(power, tdp, 90)
        shift[name] = p90s[1.0] - p90s[0.6]
    return {"shift": shift, **out}


TABLES = ("savings.json", "freq_scaling.json", "binsize.json",
          "case_study.json", "cdfs.json")


def tables_phase(dev, card: str, lib) -> dict:
    """Phase 16: the paper's remaining tables on phase 5's library, each
    held to its json exactly; the held-out profiles are built on the card,
    where ``spike_hist`` and ``ema_scan`` must launch."""
    t_phase = time.perf_counter()
    take_launches()
    got = {"savings.json": savings_table(lib),
           "freq_scaling.json": freq_scaling_table(lib),
           "binsize.json": binsize_table(lib)}
    sync(dev)
    t0 = time.perf_counter()
    got["case_study.json"] = case_study_table(lib, dev)
    sync(dev)
    case_s = time.perf_counter() - t0
    launches = take_launches()
    check_launches("case study (held-out profiles)", launches)
    cdfs = cdf_table(dev)
    for name in TABLES:
        check_json(name, {k: v for k, v in cdfs.items() if k != "shift"}
                   if name == "cdfs.json" else got[name])
    rows = got["case_study.json"]
    out = {"savings_mean": got["savings.json"]["mean"],
           "binsize_normalized": got["binsize.json"]["normalized_to_0.1"],
           "case_study": [{k: r[k] for k in (
               "target", "power_neighbor", "f_pwr", "f_perf",
               "power_bound_violation", "perf_bound_violation",
               "profiling_savings")} for r in rows],
           "p90_shift": cdfs["shift"], "case_study_s": case_s,
           "launches": launches}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"savings.json (mean {out['savings_mean']}), freq_scaling.json, "
        f"binsize.json, case_study.json, cdfs.json exactly on the port "
        f"[{card}]: held-out profiles on the card in {case_s:.3f} s, "
        f"launches {json.dumps(launches)}; p90 shift "
        f"{json.dumps(cdfs['shift'])}")
    log(f"phase 16 (the paper's tables): {out['seconds']:.3f} s [{card}]")
    return out


def kmeans_card_vs_host(lib, dev) -> int:
    """Every (k, restart) of Fig. 4's silhouette sweep on the library's
    utilization points (k = 3..17, four kmeans++ starts each): the float32
    Lloyd's centres, labels and inertia on the card bitwise equal to the
    host's.  Returns the number of pairs held."""
    from repro_torch.core.clustering import _lloyd, kmeanspp_init
    X = lib.classifier().util_matrix().cpu().numpy()
    pairs = 0
    for k in range(3, 18):
        rng = np.random.default_rng(0)
        inits = torch.from_numpy(np.stack(
            [kmeanspp_init(X, k, rng) for _ in range(4)])).float()
        Xf = torch.from_numpy(X).float()
        card = _lloyd(Xf.to(dev), inits.to(dev), k, 50)
        host = _lloyd(Xf, inits, k, 50)
        for r in range(4):
            if not all(torch.equal(c[r].cpu(), h[r])
                       for c, h in zip(card, host)):
                raise AssertionError(f"K-Means k={k} restart {r}: the card's "
                                     f"Lloyd differs from the host's")
            pairs += 1
    return pairs


def check_json(name: str, got: dict, keys=None) -> None:
    """``results/<name>`` exactly, key by key (a list as a whole)."""
    with open(os.path.join(ROOT, "results", name)) as f:
        want = json.load(f)
    if isinstance(want, list):
        if got != want:
            raise AssertionError(f"{name} differs from the reference's "
                                 f"results: {got!r} != {want!r}")
        return
    for key in keys or want:
        if got[key] != want[key]:
            raise AssertionError(f"{name}: {key} differs from the reference's "
                                 f"results: {got[key]!r} != {want[key]!r}")


def discovery_phase(dev, card: str, lib, want_scale: dict, workdir: str,
                    plain_state: dict | None = None) -> dict:
    """Phase 13: ``discovery.json`` (smoke) and the bench's full
    configuration through the port's discovery on the card; phase 12's
    10,000-job session with quarantine on, against the plain session; and
    ``classification.json``, ``holdout.json`` and ``baseline_cmp.json`` on
    phase 5's library."""
    t_phase = time.perf_counter()
    results = {}
    with open(os.path.join(ROOT, "results", "discovery.json")) as f:
        want = json.load(f)
    smoke = discovery_bench(dev, True, workdir)
    check_discovery_json(smoke["result"], want)
    for part in DISCOVERY_PARTS:
        check_launches(f"discovery (smoke) {part}", smoke["launches"][part])
    results["smoke"] = smoke
    log(f"discovery.json smoke [{card}]: {json.dumps(smoke['result'])}; "
        f"launches {json.dumps(smoke['launches'])} (the resume alone "
        f"{json.dumps(smoke['resume_only'])}, then {smoke['continued']} "
        f"arrivals)")
    full = discovery_bench(dev, False, workdir)
    for part in DISCOVERY_PARTS:
        check_launches(f"discovery (full) {part}", full["launches"][part])
    results["full"] = full
    log(f"discovery full configuration [{card}]: "
        f"{json.dumps(full['result'])}; launches "
        f"{json.dumps(full['launches'])}")

    if plain_state is None:             # --discovery-only: no phase 12
        plain_state = session_scale(lib, dev, None)["state"]
    got = session_scale(lib, dev, None, discovery=True)
    check_counts("fleet_scale.json (quarantine on)", got, want_scale,
                 ("decisions", "early_decisions", "chunks_dropped", "placed",
                  "deferred"))
    check_launches("10,000-job session (quarantine on)", got["launches"])
    if got.pop("state") != plain_state:
        raise AssertionError("the 10,000-job session with discovery on "
                             "decided or planned differently from the "
                             "plain one")
    results["scale_quarantine"] = got
    log(f"session 10,000 jobs (quarantine on) [{card}]: "
        f"{got['jobs_per_s']:.1f} jobs/s ({got['seconds']:.3f} s), "
        f"{got['quarantined']} quarantined ({got['pool']} in the pool), "
        f"every decision and plan equal to the plain session's")

    t0 = time.perf_counter()
    results["kmeans_pairs_bitwise"] = kmeans_card_vs_host(lib, dev)
    cls = classification_tables(lib)
    check_json("classification.json", cls)
    hold = holdout_table(lib)
    check_json("holdout.json", hold)
    base = baseline_table(lib)
    check_json("baseline_cmp.json", base)
    results["tables_s"] = time.perf_counter() - t0
    results["classification"] = {k: cls[k] for k in ("k_best",
                                                     "silhouette_by_k")}
    results["holdout"] = {k: hold[k] for k in ("mean_errors",
                                               "perfect_perf_predictions")}
    results["baseline_cmp"] = base["means"]
    log(f"classification.json, holdout.json, baseline_cmp.json on the port "
        f"[{card}]: K-Means card = host bitwise for "
        f"{results['kmeans_pairs_bitwise']} (k, restart) pairs, "
        f"k_best {cls['k_best']}, holdout "
        f"{hold['perfect_perf_predictions']} {json.dumps(hold['mean_errors'])}"
        f", baselines {json.dumps(base['means'])} "
        f"({results['tables_s']:.3f} s)")
    results["launches"] = {
        f"{cfg}_{part}": results[cfg]["launches"][part]
        for cfg in ("smoke", "full") for part in DISCOVERY_PARTS}
    results["launches"]["scale_quarantine"] = got["launches"]
    results["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 (discovery and core/): {results['seconds']:.3f} s "
        f"[{card}]")
    return results


# ---------------------------------------------------------------------------
# phases 19 and 20: training
# ---------------------------------------------------------------------------
# the backward kernels' checks: (b, sq, skv, heads, causal, timed); glm4-9b's
# heads unless given, each in bfloat16 and float32, the timed ones timed in
# both: glm4-9b's two training shapes, granite-moe's heads at 4 x 1024, the
# vlm's cross-attention (4 x 1024 queries against 1,600 image embeddings)
# and whisper's encoder and cross-attention (4 x 1024 frames and tokens;
# SyntheticTokens' frames are as long as its tokens), the last two the
# float32 backward's main paths; then train_lm_torch's ~100M model (16 x
# 128)
TRAIN_FLASH = (
    (4, 1024, 1024, None, True, True), (1, 4096, 4096, None, True, True),
    (4, 1024, 1024, GRANITE_HEADS, True, True),
    (4, 1024, 1600, VLM_HEADS, False, True),
    (4, 1024, 1024, WHISPER_HEADS, False, True),
    (16, 128, 128, LM_TRAIN_HEADS, True, False),
    (2, 512, 512, dict(H=16, KV=4, dh=64), True, False),
    (2, 512, 512, dict(H=8, KV=2, dh=32), True, False),
    (2, 300, 700, None, False, False),          # non-causal, sq != skv
    (2, 300, 700, WHISPER_HEADS, False, False),
    (1, 333, 333, dict(H=16, KV=4, dh=64), True, False),   # ragged causal
)
# the norm backward's checked shapes: glm4-9b's rows (both training shapes
# give 4096 rows), granite-moe's width, deepseek's MLA latent norm,
# train_lm_torch's ~100M model (16 x 128 rows of 640); each in every pair
# of x and scale dtypes, timed in bf16 and, at glm4-9b's, in float32 too
TRAIN_NORMS = ((4096, 4096), (4096, 1536), (4096, 512), (2048, 640))
TRAIN_NORM_F32_TIMED = (4096, 4096)
BWD_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float32: dict(rtol=1e-4, atol=1e-4)}
TRAIN_LAYERS = 8               # of glm4-9b's 40: 2.873 B parameters
RESUME_LAYERS = 2              # of 40 for the resume: 1.649 B, 16.5 GB a
                               # checkpoint, two of them in a run
TRAIN_SHAPES = ((4, 1024), (1, 4096))      # (batch, tokens); 1 x 4096 is
TRAIN_STEPS = 6                            # the train_4k sequence length
TRAIN_RESUME_AT = 3
# phase 20's vlm and whisper cells: llama-3.2-vision-11b at full width on 10
# of its 40 layers (2 periods of 5, so 2 gated cross sublayers; 3.316 B
# parameters, 39.8 GB of train state) and whisper-medium whole (24 + 24
# layers, 0.81 B), each 6 steps at 4 x 1024 without checkpoints
VLM_TRAIN_LAYERS = 10
CROSS_TRAIN_SHAPE = (4, 1024)
# phase 20's ssm cell: falcon-mamba-7b at full width on 8 of its 64 layers
# (1.375 B parameters, 16.5 GB of train state; all 64 are 87.3 GB), 6 steps
# at 4 x 1024 without checkpoints.  jamba trains reduced only: one 8-layer
# period is 90 GB in bf16.
MAMBA_TRAIN_LAYERS = 8
# phase 19's ssm_scan_bwd checks: (b, s, di, ds, x dtype, dt dtype, with
# D, h0 and dh_last, timed): falcon-mamba-7b's training shape (bf16 x as
# its activations, float32 dt; and float32, the reduced models' card vs
# host), batch 1 at an odd s (bf16 timed: four states a thread), the
# optional inputs, a ragged shape, and ds = 37 (16 threads a channel)
TRAIN_SCANS = (
    (4, 1024, 8192, 16, torch.bfloat16, torch.float32, False, True),
    (4, 1024, 8192, 16, torch.float32, torch.float32, False, True),
    (1, 1000, 8192, 16, torch.bfloat16, torch.float32, False, True),
    (1, 1000, 8192, 16, torch.float32, torch.float32, True, False),
    (2, 100, 1024, 16, torch.float32, torch.float32, True, False),
    (2, 100, 1024, 16, torch.bfloat16, torch.bfloat16, True, False),
    (3, 77, 1000, 16, torch.bfloat16, torch.float32, True, False),
    (1, 33, 64, 37, torch.float32, torch.float32, True, False),
)
# the reference's launcher prints this cap for --arch glm4-9b --smoke
# --steps 6 --minos-cap powercentric:  PYTHONPATH=src JAX_PLATFORMS=cpu
# python -m repro.launch.train --arch glm4-9b --smoke --steps 6
# --minos-cap powercentric
MINOS_CAP = 0.95


def sublayer_launches(attn: int, norms: int, rms: bool,
                      scans: int = 0) -> dict:
    """Launches of one train step with remat and one microbatch over
    ``attn`` attention sublayers (self or cross), ``scans`` Mamba
    sublayers and ``norms`` sublayer norms: each layer's forward runs
    twice (the step, the recomputation), so 2 flash forwards and one
    backward an attention sublayer, 2 scans and one scan backward a Mamba
    sublayer; with RMSNorm 2 forwards and one backward a sublayer norm,
    plus the final norm's one of each (outside the recomputed layers)."""
    n = (2 * norms + 1, norms + 1) if rms else (0, 0)
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "rmsnorm": n[0], "rmsnorm_bwd": n[1],
            "ssm_scan": 2 * scans, "ssm_scan_bwd": scans, "spike_hist": 0,
            "ema_scan": 0}


def train_launches(num_layers: int) -> dict:
    """A dense LM: one attention sublayer and two norms a layer (2L flash,
    L backward, 4L + 1 rmsnorm, 2L + 1 rmsnorm_bwd)."""
    return sublayer_launches(num_layers, 2 * num_layers, True)


def train_launches_of(cfg) -> dict:
    """The rule for ``cfg``'s family: the dense rule; the vlm's adds a
    gated cross sublayer (attention and its norm) at the end of each period
    of ``cross_attn_period`` layers (2L + 2P flash, L + P backward, 2(2L +
    P) + 1 rmsnorm, 2L + P + 1 rmsnorm_bwd for P periods); whisper's
    encoder layers have one attention, its decoder layers two (E + 2D
    backward, 2(E + 2D) flash) and LayerNorm throughout, so no rmsnorm.
    The ssm and hybrid families count their sublayers from the model's own
    period (``transformer.build_period`` on the meta device): a Mamba
    sublayer 2 scans and one scan backward, an attention sublayer 2 flash
    and one backward, every sublayer one RMSNorm (falcon-mamba-7b: 2L
    ``ssm_scan``, L ``ssm_scan_bwd``, 2L + 1 rmsnorm, L + 1
    ``rmsnorm_bwd``)."""
    L = cfg.num_layers
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.common import ONE_DEVICE
        from repro_torch.models.transformer import build_period
        period, n = build_period(cfg, ONE_DEVICE, "train", device="meta")
        kinds = [sub.kind for sub in period]
        return sublayer_launches(n * kinds.count("attn"), n * len(kinds),
                                 cfg.norm_type == "rmsnorm",
                                 scans=n * kinds.count("mamba"))
    if cfg.family == "vlm":
        p = L // cfg.cross_attn_period
        return sublayer_launches(L + p, 2 * L + p, True)
    if cfg.is_encoder_decoder:
        return sublayer_launches(cfg.num_encoder_layers + 2 * L, 0, False)
    return train_launches(L)


def check_train_launches(what: str, got: dict, num_layers: int,
                         steps: int, cfg=None) -> None:
    rule = train_launches(num_layers) if cfg is None \
        else train_launches_of(cfg)
    want = {k: v * steps for k, v in rule.items()}
    if got != want:
        raise AssertionError(f"{what}: {steps} train steps launched {got}; "
                             f"{num_layers} layers with remat dictate {want}")


def flash_bwd_check(dev, flush, card: str, b, sq, skv, heads, causal,
                    dtype, timed: bool) -> dict:
    """The backward kernel against its plain twin (and the forward's lse
    against the plain one) at one shape, two launches bitwise equal; with
    ``timed``, its time beside the plain twin, the bound (10 dh flops a
    visible pair) and SDPA's forward + backward through autograd."""
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention_bshd,
                                     flash_attention_bwd,
                                     flash_attention_bwd_plain,
                                     flash_attention_plain, ops)
    from repro_torch.kernels.flash_attention import attn_bwd_work, bwd_plan
    heads = heads or dict(H=32, KV=2, dh=128)
    q, k, v = attn_inputs(dev, b, sq, skv, dtype, 31 + sq + skv, **heads)
    g = torch.Generator(device=dev).manual_seed(7)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    o, lse = flash_attention_bshd(q, k, v, causal, with_lse=True)
    _, want_lse = flash_attention_plain(q, k, v, causal, with_lse=True)
    err_lse = close(lse, want_lse, KERNEL_TOL[dtype], "flash lse")
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    err = max(close(a, w, BWD_TOL[dtype], f"flash_attention_bwd d{n}")
              for n, a, w in zip("qkv", got, want))
    del want
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    if not all(torch.equal(a, x) for a, x in zip(got, again)):
        raise AssertionError("flash_attention_bwd: two launches differ")
    r = dict(b=b, s=sq, skv=skv, **heads, causal=causal,
             dtype=str(dtype).split(".")[1], err=err, lse_err=err_lse)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 132          # an H100's, on the host
    bf16 = dtype == torch.bfloat16
    plan = bwd_plan(b, sq, skv, heads["H"], heads["KV"], heads["dh"], sms,
                    causal, simt=not bf16)
    r.update(kernel="wgmma" if bf16 else "simt", split=plan.split,
             dkdv_ctas=plan.dkdv_ctas, scratch_mib=plan.scratch_bytes / 2**20)
    if bf16:
        r["dq_ctas"] = plan.dq_ctas
        dq = f"dQ {plan.dq_ctas} CTAs of 128 rows in 64-key steps"
    else:
        # float32: 32-row steps at dh 128, else 64; dQ as key tiles'
        # partials summed by a reduction
        step = 64 if heads["dh"] <= 64 else 32
        dq = f"{step}-row steps; dQ from {plan.key_tiles} key tiles' partials"
    what = (f"{r['kernel']} kernels: dK/dV {plan.dkdv_ctas} CTAs of 128 keys, "
            f"split {plan.split}; {dq}; scratch {r['scratch_mib']:.2f} MiB")
    log(f"flash_attention_bwd {r['dtype']} b={b} s={sq} skv={skv} "
        f"H={heads['H']} KV={heads['KV']} dh={heads['dh']} causal={causal} "
        f"[{card}]: {what}; max err {err:.3e}, lse {err_lse:.3e}, two "
        f"launches bitwise equal")
    if timed:
        flops, nbytes = attn_bwd_work(b, sq, skv, heads["H"], heads["KV"],
                                      heads["dh"], q.element_size(), causal)
        peak = PEAK_OPS["bf16_tensor" if dtype == torch.bfloat16 else "f32"]
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        rep = heads["H"] // heads["KV"]

        def sdpa_fwd_bwd():
            qt, kt, vt = (x.transpose(1, 2) for x in leaves)
            y = F.scaled_dot_product_attention(
                qt, kt.repeat_interleave(rep, 1),
                vt.repeat_interleave(rep, 1), is_causal=causal)
            y.backward(do.transpose(1, 2))

        def ours_fwd_bwd():
            ops.flash_attention(*leaves, causal=causal).backward(do)

        r.update(
            flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes",
            ms=cuda_time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                        causal), 20, flush),
            fwd_lse_ms=cuda_time_ms(lambda: flash_attention_bshd(
                q, k, v, causal, with_lse=True), 10, flush),
            fwd_ms=cuda_time_ms(lambda: flash_attention_bshd(
                q, k, v, causal), 10, flush),
            fwd_bwd_ms=cuda_time_ms(ours_fwd_bwd, 10, flush),
            library_ms=cuda_time_ms(sdpa_fwd_bwd, 10, flush),
            plain_ms=cuda_time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal), 3, flush))
        r["tflops"] = flops / r["ms"] * 1e-9
        log(f"flash_attention_bwd {r['dtype']} b={b} s={sq} H={heads['H']} "
            f"KV={heads['KV']} dh={heads['dh']} [{card}]: kernel "
            f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); forward + backward through autograd: ours "
            f"{r['fwd_bwd_ms']:.4f} ms, scaled_dot_product_attention "
            f"{r['library_ms']:.4f} ms; forward with lse "
            f"{r['fwd_lse_ms']:.4f} ms, without {r['fwd_ms']:.4f} ms")
    return r


def rmsnorm_bwd_check(dev, flush, card: str, n, d, xdtype, sdtype,
                      timed: bool) -> dict:
    """The backward kernel against its plain twin, two launches bitwise
    equal; with ``timed``, its time beside the plain twin, the bound (x and
    dy read, dx written) and ``F.rms_norm``'s forward + backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import (build, ops, rmsnorm_bwd,
                                     rmsnorm_bwd_plain)
    from repro_torch.kernels.rmsnorm import bwd_plan, norm_bwd_work
    g = torch.Generator(device=dev).manual_seed(n + d)
    x, dy = (torch.randn((n, d), generator=g, device=dev).to(xdtype)
             for _ in range(2))
    sc = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(sdtype)
    plan = bwd_plan(n, d, x.element_size(), sc.element_size(), True,
                    build.sm_count(dev.index or 0) if dev.type == "cuda"
                    else 132)             # an H100's, on the host
    dx, ds = rmsnorm_bwd(x, sc, dy, 1e-5)
    wx, ws = rmsnorm_bwd_plain(x, sc, dy, 1e-5)
    tol_s = BWD_TOL[torch.bfloat16 if torch.bfloat16 in (xdtype, sdtype)
                    else torch.float32]
    err = max(close(dx, wx, BWD_TOL[xdtype], "rmsnorm_bwd dx"),
              close(ds, ws, tol_s, "rmsnorm_bwd dscale"))
    dx2, ds2 = rmsnorm_bwd(x, sc, dy, 1e-5)
    if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
        raise AssertionError("rmsnorm_bwd: two launches differ")
    r = dict(n=n, d=d, dtype=str(xdtype).split(".")[1],
             scale_dtype=str(sdtype).split(".")[1], err=err,
             plan={k: getattr(plan, k) for k in (
                 "warps", "rows_per_step", "chunks", "stages", "stage_bytes",
                 "smem_bytes", "ctas_per_sm", "ctas", "per", "cols",
                 "col_width", "col_chunks", "per_chunk")})
    log(f"rmsnorm_bwd {r['dtype']} x, {r['scale_dtype']} scale ({n}, {d}) "
        f"[{card}]: {plan.ctas} CTAs ({plan.ctas_per_sm} an SM) of "
        f"{plan.per} rows, {plan.rows_per_step} a step ({plan.warps} warps "
        f"a row), {plan.stages} stages of {plan.stage_bytes} B; dscale "
        f"{plan.cols} columns a CTA over {plan.col_chunks} runs of "
        f"{plan.per_chunk} partials; max err {err:.3e}, two launches "
        f"bitwise equal")
    if timed:
        work = norm_bwd_work(n, d, x.element_size(), sc.element_size())
        nbytes = work["bytes"]
        out = torch.empty_like(x)
        xl = x.detach().clone().requires_grad_()
        sl = sc.detach().clone().requires_grad_()

        def lib_fwd_bwd():
            F.rms_norm(xl, (d,), weight=sl, eps=1e-5).backward(dy)

        def ours_fwd_bwd():
            ops.rmsnorm(xl, sl, 1e-5).backward(dy)

        r.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 bound_by="bytes", flops=work["flops"],
                 ms=cuda_time_ms(lambda: rmsnorm_bwd(x, sc, dy, 1e-5), 20,
                                 flush),
                 fwd_bwd_ms=cuda_time_ms(ours_fwd_bwd, 20, flush),
                 library_ms=cuda_time_ms(lib_fwd_bwd, 20, flush),
                 add_ms=cuda_time_ms(lambda: torch.add(x, dy, out=out), 20,
                                     flush),
                 plain_ms=cuda_time_ms(
                     lambda: rmsnorm_bwd_plain(x, sc, dy, 1e-5), 10, flush))
        log(f"rmsnorm_bwd {r['dtype']} x, {r['scale_dtype']} scale "
            f"({n}, {d}) [{card}]: kernel {r['ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of the bound), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes), "
            f"torch.add(x, dy, out=dx) {r['add_ms']:.4f} ms; forward + "
            f"backward through autograd: ours {r['fwd_bwd_ms']:.4f} ms, "
            f"F.rms_norm {r['library_ms']:.4f} ms")
    return r


SCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def ssm_bwd_check(dev, flush, card: str, b, s, di, ds, xdtype, dtdtype,
                  full: bool, timed: bool) -> dict:
    """The scan's backward kernel against its plain twin at one shape
    (``scan_inputs``' distributions, unit-scale dy; with ``full`` also D,
    h0 and dh_last): every output within ``SSM_TOL`` of its dtype with the
    absolute part scaled by max(1, max |plain|) (dA, dB, dC and dD sum over
    thousands of steps or channels), two launches bitwise equal; with
    ``timed``, its time beside the plain twin's (few calls: the twin loops
    over time twice) and the bound (``kernels.scan_bwd_work``)."""
    from repro_torch.kernels import (scan_bwd_work, ssm_scan_bwd,
                                     ssm_scan_bwd_plain)
    args, h0 = scan_inputs(dev, b, s, di, ds, xdtype, dtdtype,
                           60 + s + di + ds, full)
    x, dt, A, B, C, D = args
    D = D if full else None
    g = torch.Generator(device=dev).manual_seed(s + ds)
    dy = torch.randn((b, s, di), generator=g, device=dev).to(xdtype)
    dh = torch.randn((b, di, ds), generator=g, device=dev) if full else None

    def kernel():
        return ssm_scan_bwd(x, dt, A, B, C, D, h0, dy, dh)

    def plain():
        return ssm_scan_bwd_plain(x, dt, A, B, C, D, h0, dy, dh)
    got = kernel()
    sync(dev)
    want = plain()
    what = (f"ssm_scan_bwd ({b}, {s}, {di}, {ds}) x "
            f"{str(xdtype).split('.')[1]} dt {str(dtdtype).split('.')[1]}"
            + (" with D, h0, dh_last" if full else ""))
    err = err_scaled = 0.0
    for name, a, w in zip(SCAN_GRADS, got, want):
        if w is None:
            if a is not None:
                raise AssertionError(f"{what}: {name} given, none wanted")
            continue
        tol = SSM_TOL[torch.bfloat16 if a.dtype == torch.bfloat16
                      else torch.float32]
        scale = max(1.0, float(w.float().abs().max()))
        e = close(a, w, dict(rtol=tol["rtol"], atol=tol["atol"] * scale),
                  f"{what}: {name}")
        err, err_scaled = max(err, e), max(err_scaled, e / scale)
    del want
    again = kernel()
    if not all(torch.equal(a, c) for a, c in zip(got, again)
               if a is not None):
        raise AssertionError(f"{what}: two launches differ")
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import bwd_plan
    lanes = bwd_plan(b, s, di, ds, build.sm_count(dev.index or 0)).lanes \
        if dev.type == "cuda" else None
    r = dict(b=b, s=s, di=di, ds=ds, dtype=str(xdtype).split(".")[1],
             dt_dtype=str(dtdtype).split(".")[1], full=full, err=err,
             err_scaled=err_scaled, lanes=lanes)
    log(f"{what} [{card}]: max err {err:.3e} ({err_scaled:.3e} of the "
        f"scale), two launches bitwise equal, {lanes} lanes a channel")
    if timed:
        r.update(scan_bound(scan_bwd_work(b, s, di, ds, x.element_size(),
                                          dt.element_size(), skip=full,
                                          h0=full, dh_last=full)))
        r.update(ms=cuda_time_ms(kernel, 20, flush),
                 plain_ms=cuda_time_ms(plain, 2, flush))
        log(f"ssm_scan_bwd ({b}, {s}, {di}, {ds}) x {r['dtype']} dt "
            f"{r['dt_dtype']} [{card}]: kernel {r['ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of the bound), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes']:.4e} B, {r['exps']:.4e} exp, "
            f"{r['flops']:.4e} flop); no library call")
    return r


# the ssm_scan_bwd library's kernels: the scan for each of the four (x, dt)
# dtype pairs in each of its three layouts (eight, four and wide), and the
# sum over partials
SSM_BWD_KERNELS = 4 * 3 + 1


def ssm_bwd_report() -> dict:
    """ptxas's registers, stack and spill bytes and the SASS mix
    (``SASS_OPS`` and the selects) for every kernel of the ``ssm_scan_bwd``
    library; fails if one spills or ptxas reports fewer than its
    ``SSM_BWD_KERNELS``."""
    full = build_report("ssm_scan_bwd", SASS_OPS + ("SEL", "FSEL"))
    kernels = {}
    for name, r in full["ptxas_by_kernel"].items():
        m = re.search(r"ssm_scan_bwd\w*?_kernel(?:<[^>]*>|\w*)", name)
        if m is not None:
            kernels[m.group(0)] = dict(r)
    for name, counts in full["sass"].items():
        m = re.search(r"ssm_scan_bwd\w*?_kernel(?:<[^>]*>|\w*)", name)
        if m is not None and m.group(0) in kernels:
            kernels[m.group(0)]["sass"] = counts
    for name, r in sorted(kernels.items()):
        log(f"  {name}: {r.get('registers')} registers, {r.get('stack')} "
            f"bytes stack, {r.get('spill_stores')} / {r.get('spill_loads')} "
            f"bytes spill stores / loads; SASS {json.dumps(r.get('sass'))}")
    if len(kernels) < SSM_BWD_KERNELS or any(
            r.get("spill_stores", 1) or r.get("spill_loads", 1)
            for r in kernels.values()):
        raise AssertionError(f"ssm_scan_bwd: a kernel spills (or ptxas "
                             f"reported fewer than its {SSM_BWD_KERNELS}): "
                             f"{kernels}")
    return kernels


def seed_checkpoint(cfg, dtype, directory: str, seed: int = 0) -> None:
    """A train state of ``cfg`` at step 0, drawn on the host from ``seed``
    (the port's init, zero moments; a vlm's gates drawn away from 0 by
    ``seed_gates``, as phase 17 draws them), as a checkpoint in
    ``directory``."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import init_state, state_tree
    model = build_model(cfg, kind="train", device="cpu", dtype=dtype)
    state = init_state(model, RunConfig(),
                       torch.Generator().manual_seed(seed))
    if cfg.family == "vlm":
        seed_gates(model)
    ckpt.save(state_tree(state), directory, 0)


def train_run(cfg, shape, run_cfg, dev, dtype=None, steps=None):
    """``Trainer.run`` with every launch count reset just before and read
    just after, the metrics of each step and its peak device memory."""
    from repro_torch.kernels import build
    from repro_torch.train import Trainer
    metrics = []
    trainer = Trainer(cfg, shape, run_cfg, device=dev, dtype=dtype,
                      telemetry_hook=lambda s, dt, m: metrics.append(m))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    res = trainer.run(num_steps=steps)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30 \
        if dev.type == "cuda" else None
    return trainer, res, metrics, launches, peak


def train_card_vs_host_arch(dev, arch: str, workdir: str) -> dict:
    """One reduced model (2 layers; whisper 2 + 2) in float32, 3
    ``Trainer`` steps on the card and on the host from one seeded
    checkpoint: losses within 1e-5 relative, grad norms and the parameters
    after the last step within 1e-4; the launches of the card's steps
    exactly as the model dictates.  A key bias (whisper's ``bk``) is held
    to AdamW's reach instead, 2 lr a step: softmax is invariant to a shift
    of a row's scores, so its gradient is zero up to rounding on both
    sides, and AdamW turns each side's rounding into steps of up to about
    lr."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    cfg = ARCHS[arch].reduced(num_layers=2)
    shape = ShapeConfig("smoke", 128, 4, "train")
    seed = os.path.join(workdir, "seed")
    seed_checkpoint(cfg, torch.float32, seed)
    lr, steps = 3e-3, 3
    out = {}
    for where, device in (("host", torch.device("cpu")), ("card", dev)):
        d = os.path.join(workdir, where)
        shutil.copytree(seed, d)
        run_cfg = RunConfig(total_steps=steps, warmup_steps=1,
                            checkpoint_every=steps, checkpoint_dir=d,
                            learning_rate=lr)
        out[where] = train_run(cfg, shape, run_cfg, device, torch.float32)
    (th, rh, mh, _, _), (tc, rc, mc, launches, _) = out["host"], out["card"]
    for i, (a, w) in enumerate(zip(rc.losses, rh.losses)):
        if abs(a - w) > 1e-5 * abs(w):
            raise AssertionError(f"{arch} train step {i + 1}: card loss "
                                 f"{a!r}, host {w!r}")
    err_norm = max(abs(a["grad_norm"] - w["grad_norm"]) for a, w in
                   zip(mc, mh))
    if err_norm > 1e-4 * max(1.0, max(w["grad_norm"] for w in mh)):
        raise AssertionError(f"{arch} grad_norm card vs host: "
                             f"{err_norm:.3e}")
    err_p = err_bk = 0.0
    for name, p in tc._state["params"].items():
        want = th._state["params"][name].detach()
        if name.endswith(".bk"):
            err_bk = max(err_bk, float((p.detach().cpu() - want).abs()
                                       .max()))
            continue
        err_p = max(err_p, close(p.detach(), want,
                                 dict(rtol=1e-4, atol=1e-4),
                                 f"{arch} param {name} after step {steps}"))
    if err_bk > 2 * lr * steps:
        raise AssertionError(f"{arch} key biases card vs host: {err_bk:.3e}"
                             f" beyond AdamW's reach {2 * lr * steps}")
    if dev.type == "cuda":
        check_train_launches(f"reduced {arch} on the card", launches,
                             cfg.num_layers, steps, cfg)
    r = dict(losses_card=rc.losses, losses_host=rh.losses,
             grad_norm_err=err_norm, param_err=err_p, key_bias_err=err_bk,
             launches_per_step={k: v // steps for k, v in launches.items()})
    log(f"reduced {arch} float32, {steps} steps card vs host: losses "
        f"{rc.losses} vs {rh.losses}, grad_norm within {err_norm:.2e}, "
        f"parameters within {err_p:.2e}"
        + (f" (key biases {err_bk:.2e})" if err_bk else "")
        + f"; launches per step {r['launches_per_step']}")
    return r


def train_card_vs_host(dev, workdir: str) -> dict:
    """``train_card_vs_host_arch`` for the reduced glm4-9b, vlm (its gates
    in [0.5, 1.5]: its cross sublayers and their float32 flash backward
    count), whisper (its float32 encoder and cross-attention),
    falcon-mamba-7b and jamba (the scan's backward; jamba's attention,
    MoE and mlp sublayers beside its Mamba ones)."""
    return {arch: train_card_vs_host_arch(dev, arch,
                                          os.path.join(workdir, arch))
            for arch in (GLM, VLM, WHISPER, MAMBA, JAMBA)}


def train_launcher_cap(workdir: str) -> dict:
    """``python -m repro_torch.launch.train --arch glm4-9b --smoke --steps 6
    --minos-cap powercentric`` on the card (the library's profiling runs
    the fleet kernels there): its cap must be the reference's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", GLM,
         "--smoke", "--steps", "6", "--minos-cap", "powercentric",
         "--ckpt-dir", os.path.join(workdir, "launcher_ckpt"),
         "--minos-store", os.path.join(workdir, "launcher_store")],
        capture_output=True, text=True, env=env, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launch.train failed:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    minos = [ln for ln in proc.stdout.splitlines() if "-> cap=" in ln]
    m = re.search(r"-> cap=([0-9.]+)", minos[0]) if minos else None
    if m is None or float(m.group(1)) != MINOS_CAP or \
            "ran 6 steps" not in proc.stdout:
        raise AssertionError(f"launch.train printed no cap of {MINOS_CAP} "
                             f"and 6 steps:\n{proc.stdout}")
    log(f"launch.train --minos-cap on the card ({seconds:.1f} s): "
        f"{minos[0].strip()}")
    return dict(cap=float(m.group(1)), line=minos[0].strip(),
                seconds=seconds)


def train_launcher_smoke(workdir: str) -> dict:
    """``python -m repro_torch.launch.train --arch <vlm | whisper |
    falcon-mamba-7b | jamba> --smoke --steps 2`` on the card: each trains
    its reduced configuration."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = {}
    for arch in (VLM, WHISPER, MAMBA, JAMBA):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--smoke", "--steps", "2", "--ckpt-dir",
             os.path.join(workdir, f"launcher_{arch}")],
            capture_output=True, text=True, env=env, timeout=600)
        seconds = time.perf_counter() - t0
        line = proc.stdout.strip().splitlines()[-1:] or [""]
        if proc.returncode != 0 or "ran 2 steps" not in line[0]:
            raise AssertionError(f"launch.train --arch {arch} --smoke "
                                 f"failed:\n{proc.stdout}\n{proc.stderr}")
        log(f"launch.train --arch {arch} --smoke on the card ({seconds:.1f} "
            f"s): {line[0]}")
        out[arch] = dict(line=line[0], seconds=seconds)
    return out


def train_kernel_checks(dev, flush, card: str) -> dict:
    """Phase 19's kernel part: the flash backward library's ptxas and
    HGMMA report and the norm and scan backwards' ptxas reports, every
    backward shape in both dtypes (the timed ones timed in both), rmsnorm's
    backward at ``TRAIN_NORMS`` in every pair of dtypes (bf16 timed, and
    float32 at ``TRAIN_NORM_F32_TIMED``), the scan's backward at
    ``TRAIN_SCANS``."""
    from repro_torch.kernels import build
    report = flash_bwd_report()
    norm_report = rmsnorm_bwd_report()
    scan_report = ssm_bwd_report()
    before = dict(build.LAUNCHES)
    flash = [flash_bwd_check(dev, flush, card, b, sq, skv, heads, causal,
                             dtype, timed=timed)
             for b, sq, skv, heads, causal, timed in TRAIN_FLASH
             for dtype in (torch.bfloat16, torch.float32)]
    norms = [rmsnorm_bwd_check(
        dev, flush, card, *shape, x, s,
        timed=x == s and (x == torch.bfloat16
                          or shape == TRAIN_NORM_F32_TIMED))
        for shape in TRAIN_NORMS
        for x in (torch.bfloat16, torch.float32)
        for s in (torch.bfloat16, torch.float32)]
    scans = [ssm_bwd_check(dev, flush, card, *case) for case in TRAIN_SCANS]
    build.LAUNCHES.update(before)          # check/timing launches do not count
    log(f"backward kernels vs plain [{card}]: flash max err "
        f"{max(r['err'] for r in flash):.3e} over {len(flash)} cases, lse "
        f"{max(r['lse_err'] for r in flash):.3e}; rmsnorm "
        f"{max(r['err'] for r in norms):.3e} over {len(norms)}; ssm_scan_bwd "
        f"{max(r['err_scaled'] for r in scans):.3e} of the scale over "
        f"{len(scans)}")
    return dict(flash=flash, rmsnorm=norms, ssm_scan=scans,
                flash_build=report, rmsnorm_bwd_build=norm_report,
                ssm_scan_bwd_build=scan_report)


def rmsnorm_bwd_report() -> dict:
    """ptxas's registers, stack and spill bytes for every instantiation of
    the rmsnorm library's backward kernel; fails if one spills."""
    report = build_report("rmsnorm", ())["ptxas_by_kernel"]
    kernels = {}
    for name, r in report.items():
        m = re.search(r"rmsnorm_bwd_kernel(?:<[^>]*>|\w*)", name)
        if m is not None:
            kernels[m.group(0).replace("(int)", "")] = r
    for name, r in sorted(kernels.items()):
        log(f"  {name}: {r.get('registers')} registers, {r.get('stack')} "
            f"bytes stack, {r.get('spill_stores')} / {r.get('spill_loads')} "
            f"bytes spill stores / loads")
    if not kernels or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                          for r in kernels.values()):
        raise AssertionError(f"rmsnorm_bwd: an instantiation spills (or "
                             f"ptxas reported none): {kernels}")
    return kernels


def flash_bwd_report() -> dict:
    """The backward library's kernels: ptxas's registers (at entry: the
    warp-specialised ones hand registers to their consumers with
    setmaxnreg), stack and spill bytes for every instantiation, and the
    HGMMA (wgmma) instructions of each; fails if a bf16 product kernel has
    none or a float32 kernel spills."""
    report = build_report("flash_attention_bwd", ("HGMMA",))

    def short(name: str) -> str:           # fa_bwd_dq_bf16_kernel<(int)128>
        m = re.search(r"fa_bwd_\w+(?:<[^>]*>)?", name)
        return m.group(0).replace("(int)", "") if m else name
    hgmma = {short(k): c["HGMMA"] for k, c in report.pop("sass").items()}
    kernels = {}
    for name, r in report["ptxas_by_kernel"].items():
        kernels[short(name)] = dict(r, hgmma=hgmma.get(short(name), 0))
    for name, r in sorted(kernels.items()):
        log(f"  {name}: {r.get('registers')} registers, {r.get('stack')} "
            f"bytes stack, {r.get('spill_stores')} / {r.get('spill_loads')} "
            f"bytes spill stores / loads, {r['hgmma']} HGMMA")
    wgmma = [k for k in kernels if "_bf16_kernel" in k
             and ("dkdv" in k or "dq" in k)]
    if not wgmma or any(kernels[k]["hgmma"] == 0 for k in wgmma):
        raise AssertionError(f"flash_attention_bwd: a bf16 product kernel "
                             f"has no HGMMA: {kernels}")
    simt = [k for k in kernels if "_f32_kernel" in k]
    spilled = [k for k in simt if kernels[k].get("spill_stores", 1)
               or kernels[k].get("spill_loads", 1)]
    if len(simt) < 6 or spilled:   # dK/dV and the dQ reduction, 3 dh each
        raise AssertionError(f"flash_attention_bwd: a float32 "
                             f"instantiation spills (or ptxas reported "
                             f"none): {spilled or simt}")
    return kernels


def train_check_phase(dev, flush, card: str, workdir: str) -> dict:
    """Phase 19: the backward kernels against their plain twins, the
    reduced models card vs host, the launcher's Minos cap and its vlm and
    whisper smoke runs."""
    t0 = time.perf_counter()
    r = dict(kernels=train_kernel_checks(dev, flush, card),
             card_vs_host=train_card_vs_host(dev, os.path.join(workdir,
                                                               "cvh")),
             launcher=train_launcher_cap(workdir),
             launcher_cross=train_launcher_smoke(workdir))
    r["seconds"] = time.perf_counter() - t0
    return r


# the flash backward's launches by kernel, within its group
FLASH_BWD_PARTS = (("dK/dV", "dkdv"), ("dQ reduction", "dq_reduce"),
                   ("dQ", "_dq_"), ("reduction", "reduce"), ("prep", "prep"))
GEMM_KEYS = ("gemm", "xmma", "cutlass", "gemv", "splitk", "nvjet")
TRAIN_GROUPS = (("flash_attention_bwd", ("fa_bwd",)),
                ("flash_attention", ("fa_bf16", "fa_f32")),
                ("rmsnorm_bwd", ("rmsnorm_bwd",)),
                ("rmsnorm", ("rmsnorm",)),
                ("gemm", GEMM_KEYS))
# whisper's step: the float32 kernels (encoder, cross-attention) apart from
# the bf16 ones (the decoder's self-attention); "other" is elementwise work
CROSS_TRAIN_GROUPS = (
    ("flash_attention_bwd f32", ("fa_bwd_prep_f32", "fa_bwd_dkdv_f32",
                                 "fa_bwd_dq_reduce_f32", "fa_bwd_reduce_f32")),
    ("flash_attention f32", ("fa_f32",)),
    ("flash_attention_bwd bf16", ("fa_bwd",)),
    ("flash_attention bf16", ("fa_bf16",)),
    ("rmsnorm_bwd", ("rmsnorm_bwd",)),
    ("rmsnorm", ("rmsnorm",)),
    ("gemm", GEMM_KEYS))
# falcon-mamba-7b's step: the scan's backward (its scan and sum kernels)
# apart from the forward scan (matched after it: both names hold ssm_scan)
MAMBA_TRAIN_GROUPS = (("ssm_scan_bwd", ("ssm_scan_bwd",)),
                      ("ssm_scan", ("ssm_scan",)),
                      ("rmsnorm_bwd", ("rmsnorm_bwd",)),
                      ("rmsnorm", ("rmsnorm",)),
                      ("gemm", GEMM_KEYS))


def trace_train(dev, card: str, out: str | None, arch: str = GLM) -> dict:
    """One train step at 4 x 1024 under ``torch.profiler`` after a warm-up
    step, of glm4-9b on 8 layers or (``arch``) whisper-medium whole or
    falcon-mamba-7b on 8 layers: device busy share and device time by
    kernel group (the table in ``out/trace_train[_<arch>].txt``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.train import Trainer, init_state
    if arch == GLM:
        cfg = dataclasses.replace(ARCHS[GLM], num_layers=TRAIN_LAYERS)
        groups, what = TRAIN_GROUPS, f"glm4-9b {TRAIN_LAYERS}/40 layers"
    elif arch == MAMBA:
        cfg = dataclasses.replace(ARCHS[MAMBA], num_layers=MAMBA_TRAIN_LAYERS)
        groups = MAMBA_TRAIN_GROUPS
        what = f"{MAMBA} {MAMBA_TRAIN_LAYERS}/64 layers"
    else:
        cfg, groups, what = ARCHS[arch], CROSS_TRAIN_GROUPS, arch
    (b, s), = TRAIN_SHAPES[:1]
    run_cfg = RunConfig(total_steps=TRAIN_STEPS, warmup_steps=2,
                        checkpoint_dir=None)
    trainer = Trainer(cfg, ShapeConfig("trace", s, b, "train"), run_cfg,
                      device=dev)
    state = init_state(trainer.model, run_cfg,
                       torch.Generator(device=dev).manual_seed(0))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                trainer.data.batch_at(i).items()} for i in range(2)]
    state, m = trainer.step_fn(state, batches[0])
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = trainer.step_fn(state, batches[1])
        float(m["loss"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    del trainer, state
    torch.cuda.empty_cache()
    ka = prof.key_averages()
    kernels = [e for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    shares, counts, bwd = {}, {}, {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in groups
                      if any(k in name for k in keys)), "other")
        shares[group] = shares.get(group, 0.0) + e.self_device_time_total
        counts[group] = counts.get(group, 0) + e.count
        if group.startswith("flash_attention_bwd"):
            part = next((p for p, key in FLASH_BWD_PARTS if key in name),
                        name)
            if arch != GLM:                 # both dtypes run
                part += " f32" if "_f32" in name else " bf16"
            ms, n = bwd.get(part, (0.0, 0))
            bwd[part] = (ms + e.self_device_time_total / 1e3, n + e.count)
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / device_us:.1%}, "
                      f"{counts[k]} launches)"
                      for k, v in sorted(shares.items(), key=lambda x: -x[1]))
    bwd_parts = ", ".join(f"{k} {ms:.3f} ms ({n} launches)"
                          for k, (ms, n) in bwd.items())
    log(f"trace train {what} {b} x {s} [{card}]: "
        f"one step in {elapsed:.3f} s under the profiler, device busy "
        f"{device_us / 1e6:.3f} s = {device_us / 1e6 / elapsed:.2%}; by "
        f"kernel: {parts}"
        + (f"; the flash backward by kernel: {bwd_parts}" if bwd else ""))
    if out is not None:
        name = "trace_train" + ("" if arch == GLM else f"_{arch}")
        with open(os.path.join(out, f"{name}.txt"), "w") as f:
            f.write(f"{card}\n{elapsed:.3f} s traced, device busy "
                    f"{device_us / 1e6:.3f} s\n{parts}\n\n"
                    f"{ka.table(sort_by='self_device_time_total', row_limit=30)}"
                    f"\n")
    return dict(elapsed_s=elapsed, device_busy_s=device_us / 1e6,
                by_kernel_ms={k: v / 1e3 for k, v in shares.items()},
                launches_by_kernel=counts,
                flash_bwd_ms={k: ms for k, (ms, _) in bwd.items()})


def train_full_phase(dev, card: str, workdir: str) -> dict:
    """Phase 20: glm4-9b at full width on 8 of its 40 layers (bf16
    parameters, float32 moments), 6 ``Trainer`` steps at 4 x 1024 and at
    1 x 4096 without checkpoints: finite losses, launches, step ms,
    tokens/s, peak GiB; then, the same way at 4 x 1024, whisper-medium
    whole and llama-3.2-vision-11b on 10 of its 40 layers (the float32
    flash backward's main paths), and falcon-mamba-7b on 8 of its 64
    layers (the scan's backward).  Then the resume at full width on 2 layers: 6
    uninterrupted steps, 3 steps with a checkpoint at step 3, and a fresh
    ``Trainer`` resumed from it (steps 4-6 within rtol 1e-5 of the
    uninterrupted run).  A checkpoint of the 8-layer state is 28.7 GB, so
    the run's disk writes are held to the 2-layer state's two checkpoints,
    33 GB, which fits a host that caps a run's writes at 45 GiB."""
    import gc
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import RunConfig, ShapeConfig
    out = dict(layers=TRAIN_LAYERS, resume_layers=RESUME_LAYERS, runs=[],
               cross=[], ssm=[])

    def run(layers, b, s, steps, directory, every=TRAIN_RESUME_AT,
            arch=GLM, into="runs"):
        cfg = ARCHS[arch] if layers is None else \
            dataclasses.replace(ARCHS[arch], num_layers=layers)
        run_cfg = RunConfig(total_steps=TRAIN_STEPS, warmup_steps=2,
                            checkpoint_every=every, checkpoint_dir=directory)
        shape = ShapeConfig(f"train_{b}x{s}", s, b, "train")
        t0 = time.perf_counter()
        trainer, res, metrics, launches, peak = train_run(
            cfg, shape, run_cfg, dev, steps=steps)
        seconds = time.perf_counter() - t0
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        if not all(np.isfinite(res.losses)):
            raise AssertionError(f"{arch} {b} x {s}: losses {res.losses}")
        check_train_launches(f"{arch} ({cfg.num_layers} layers) {b} x {s}",
                             launches, cfg.num_layers, res.steps_run, cfg)
        durations = res.step_durations
        step_ms = float(np.median(durations[1:] if len(durations) > 1
                                  else durations)) * 1e3
        r = dict(arch=arch, layers=cfg.num_layers,
                 encoder_layers=cfg.num_encoder_layers,
                 params=cfg.param_count(), batch=b, tokens=s,
                 steps=res.steps_run, restored_from=res.restored_from,
                 checkpoints=directory is not None, losses=res.losses,
                 grad_norms=[m["grad_norm"] for m in metrics],
                 step_ms=step_ms, step_ms_all=[d * 1e3 for d in durations],
                 tokens_per_s=b * s / step_ms * 1e3, peak_gib=peak,
                 launches=launches,
                 launches_per_step={k: v // max(res.steps_run, 1)
                                    for k, v in launches.items()},
                 seconds=seconds)
        depth = (f"{cfg.num_encoder_layers} + {cfg.num_layers}"
                 if cfg.is_encoder_decoder else f"{cfg.num_layers}/"
                 f"{ARCHS[arch].num_layers}")
        log(f"{arch} {depth} layers ({cfg.param_count() / 1e9:.3f} B) "
            f"train {b} x {s}, steps {res.final_step - res.steps_run + 1}-"
            f"{res.final_step}{'' if directory else ', no checkpoints'} "
            f"[{card}]: losses {[round(x, 4) for x in res.losses]}, step "
            f"{step_ms:.1f} ms (median of steps 2-), "
            f"{r['tokens_per_s']:.0f} tokens/s, peak "
            f"{'not measured' if peak is None else f'{peak:.2f} GiB'}, "
            f"{seconds:.1f} s in all; launches a step "
            f"{r['launches_per_step']}")
        out[into].append(r)
        return r

    for b, s in TRAIN_SHAPES:
        run(TRAIN_LAYERS, b, s, TRAIN_STEPS, None)
    b, s = TRAIN_SHAPES[0]
    whole = run(RESUME_LAYERS, b, s, TRAIN_STEPS, None)
    directory = os.path.join(workdir, "glm_resume")
    first = run(RESUME_LAYERS, b, s, TRAIN_RESUME_AT, directory)
    resumed = run(RESUME_LAYERS, b, s, TRAIN_STEPS, directory)
    shutil.rmtree(directory)
    if resumed["restored_from"] != TRAIN_RESUME_AT:
        raise AssertionError(f"resumed from {resumed['restored_from']}")
    for what, got, want in (
            ("steps 1-3", first["losses"], whole["losses"][:TRAIN_RESUME_AT]),
            ("resumed steps 4-6", resumed["losses"],
             whole["losses"][TRAIN_RESUME_AT:])):
        if not np.allclose(got, want, rtol=1e-5, atol=0):
            raise AssertionError(f"{what} {got} vs uninterrupted {want}")
    out["resume_bitwise"] = \
        first["losses"] + resumed["losses"] == whole["losses"]
    log(f"resume from step {TRAIN_RESUME_AT} in a fresh Trainer [{card}]: "
        f"steps 4-6 within rtol 1e-5 of the uninterrupted run, "
        f"{'bit for bit' if out['resume_bitwise'] else 'not bit for bit'}")
    # the float32 flash backward's main paths: whisper's encoder and
    # cross-attention, the vlm's cross sublayers (their float32 memory
    # promotes them); no checkpoints (the glm4-9b resume holds the write
    # budget, and the CPU tests hold these models' checkpoints)
    b, s = CROSS_TRAIN_SHAPE
    run(None, b, s, TRAIN_STEPS, None, arch=WHISPER, into="cross")
    run(VLM_TRAIN_LAYERS, b, s, TRAIN_STEPS, None, arch=VLM, into="cross")
    # the scan's backward: falcon-mamba-7b at full width, 8 of 64 layers
    run(MAMBA_TRAIN_LAYERS, b, s, TRAIN_STEPS, None, arch=MAMBA, into="ssm")
    return out


# ---------------------------------------------------------------------------
# phase 21: the dry run's count held against the card
# ---------------------------------------------------------------------------
# (arch, layers, kind, batch, tokens): glm4-9b's prefill, one decode step
# at that cache and one train step, and falcon-mamba-7b's train step, on
# phase 20's cut depths and shape
DRYRUN_CELLS = ((GLM, TRAIN_LAYERS, "prefill", 4, 1024),
                (GLM, TRAIN_LAYERS, "decode", 4, 1024),
                (GLM, TRAIN_LAYERS, "train", 4, 1024),
                (MAMBA, MAMBA_TRAIN_LAYERS, "train", 4, 1024))
DRYRUN_TIMED = 5              # steps timed after one warm-up
DRYRUN_PEAK_TOL = 0.05        # meta peak against max_memory_allocated


def dryrun_phase(dev, card: str) -> dict:
    """Phase 21: each of ``DRYRUN_CELLS`` counted on meta by
    ``launch.dryrun.run_cell``, then run once on the card under the same
    counter, the launch counts set to 0 just before, and once more under
    ``FlopCounterMode``: (a) the two ``Cost``s equal field by field and
    the kernel calls equal to ``build.LAUNCHES``; (b) the counted product
    flops equal ``FlopCounterMode``'s (the ctypes kernels are invisible to
    both); (c)
    the meta peak within ``DRYRUN_PEAK_TOL`` of ``max_memory_allocated``
    less what was allocated before the cell's tensors were made;
    (d) then, outside the counter, the step's median ms over
    ``DRYRUN_TIMED`` synchronised steps (after the ``FlopCounterMode``
    step) beside the roofline's terms,
    ``bound_time / ms`` and ``mfu`` (model flops over the bf16 peak)."""
    import gc
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.cost import CostCounter
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    cells = []
    for arch, layers, kind, b, s in DRYRUN_CELLS:
        cfg = dataclasses.replace(ARCHS[arch], num_layers=layers)
        shape = ShapeConfig(f"{kind}_{b}x{s}", s, b, kind)
        what = f"{arch} {layers}/{ARCHS[arch].num_layers} layers {kind} " \
            f"{b} x {s}"
        rec = dryrun.run_cell(arch, shape.name, "card", cfg=cfg, shape=shape)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        # what earlier phases left allocated (the flush buffer, caches) is
        # no part of this cell: the card's peak is counted above it
        before = torch.cuda.memory_allocated()
        cell = dryrun.make_cell(cfg, shape, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter = CostCounter()
        counter.track(cell.args)
        build.reset_launches()
        with counter:
            out = cell.run()
        torch.cuda.synchronize()
        peak_all = torch.cuda.max_memory_allocated()
        peak = peak_all - before
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        del out
        # FlopCounterMode keeps tensors of the step alive (1.1 GiB more at
        # glm4-9b's train peak, tools/peak_probe.py): it counts a step of
        # its own, which is also the timing's warm-up
        with FlopCounterMode(display=False) as flops:
            cell.run()
        torch.cuda.synchronize()
        card_cost = dataclasses.asdict(counter.cost)
        diff = {k: (rec["cost"][k], card_cost[k]) for k in card_cost
                if rec["cost"][k] != card_cost[k]}
        if diff:
            raise AssertionError(f"{what}: meta and card costs differ "
                                 f"(meta, card): {diff}")
        if not (rec["calls"] == counter.calls == launches):
            raise AssertionError(f"{what}: kernel calls on meta "
                                 f"{rec['calls']}, on the card "
                                 f"{counter.calls}, launched {launches}")
        if counter.matmul_flops != flops.get_total_flops():
            raise AssertionError(f"{what}: products {counter.matmul_flops} "
                                 f"counted, FlopCounterMode "
                                 f"{flops.get_total_flops()}")
        est = rec["memory"]["peak_bytes"]
        if abs(est - peak) > DRYRUN_PEAK_TOL * peak:
            raise AssertionError(f"{what}: meta peak {est} B, card "
                                 f"max_memory_allocated {peak_all} B less "
                                 f"{before} B allocated before the cell")
        times = []
        for _ in range(DRYRUN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cell.run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        roof = rec["roofline"]
        ms = float(np.median(times))
        r = dict(arch=arch, layers=layers, kind=kind, batch=b, tokens=s,
                 cost=rec["cost"], calls=rec["calls"], launches=launches,
                 matmul_flops=counter.matmul_flops,
                 meta_peak_bytes=est, card_peak_bytes=peak,
                 card_max_allocated=peak_all, card_before_bytes=before,
                 peak_rel=(est - peak) / peak,
                 memory=rec["memory"], fits=rec["fits"], ms=ms,
                 ms_all=times, t_compute_ms=roof["t_compute"] * 1e3,
                 t_memory_ms=roof["t_memory"] * 1e3,
                 bound_ms=roof["bound_time"] * 1e3,
                 dominant=roof["dominant"],
                 bound_share=roof["bound_time"] * 1e3 / ms,
                 model_flops=roof["model_flops"],
                 mfu=roof["model_flops"] / (ms / 1e3 * H100.peak_flops_bf16),
                 useful_ratio=roof["useful_ratio"],
                 meta_count_s=rec["timings"]["count_s"])
        log(f"dry run {what} [{card}]: meta and card costs equal "
            f"({rec['cost']['flops']:.4e} flop, "
            f"{rec['cost']['tensor_flops']:.4e} on the tensor cores, "
            f"{rec['cost']['hbm_bytes_min']:.4e} B), calls = launches "
            f"{launches}, products = FlopCounterMode's "
            f"{counter.matmul_flops:.4e}; peak meta {est / 2**30:.3f} GiB, "
            f"card {peak / 2**30:.3f} GiB ({r['peak_rel']:+.2%}; "
            f"max_memory_allocated {peak_all / 2**30:.3f} GiB, of it "
            f"{before / 2**30:.3f} from before the cell); step "
            f"{ms:.2f} ms (median of {DRYRUN_TIMED}), t_compute "
            f"{r['t_compute_ms']:.2f} ms, t_memory {r['t_memory_ms']:.2f} "
            f"ms, bound_time {r['bound_ms']:.2f} ms ({r['dominant']}), "
            f"bound/step {r['bound_share']:.1%}, mfu {r['mfu']:.2%}")
        cells.append(r)
    out = dict(cells=cells, seconds=time.perf_counter() - t_phase)
    log(f"phase 21 (dry run vs card): {out['seconds']:.3f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 22: the tail of the reference — the port's contract checker over
# the tree, the two facade examples on the card and on the host, and the
# frozen seed loops against the profiling kernels
# ---------------------------------------------------------------------------
TAIL_EXAMPLES = ("quickstart_torch.py", "fleet_power_planner_torch.py")
# lines whose numbers may differ between two runs that decide alike: the
# planner's library build time, and the byte count of the quickstart's
# session report (its floats print with as many digits as they need)
TAIL_MASKS = (re.compile(r"(# built reference library: \d+ profiles in )"
                         r"[\d.]+(s)$"),
              re.compile(r"(session report: .*, )\d+( bytes as JSON)$"))
# tests/test_profiling_engine.py's inputs and tolerances: 3,000 samples of
# seed 3; the float32 kernel within rtol 2e-4 + atol 2e-3 of the loop, the
# float64 engine within 1e-9; the partial-block trace lengths
TAIL_EMA_N, TAIL_EMA_SEED = 3000, 3
TAIL_EMA_F32_TOL = dict(rtol=2e-4, atol=2e-3)
TAIL_EMA_F64_TOL = dict(rtol=1e-9, atol=1e-9)
TAIL_HIST_N = (96 * 128, 1280, 130, 125 * 128, 250 * 128)


def tail_lint() -> dict:
    """The port's contract checker over its default scan, in-process: no
    active finding may remain."""
    from pathlib import Path

    from repro_torch.lint import load_context, run
    ctx = load_context(Path(ROOT))
    findings = run(ctx)
    active = [f for f in findings if not f.suppressed]
    by_rule: dict[str, int] = {}
    for f in findings:
        if f.suppressed:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    out = dict(files=len(ctx.files), findings=len(active),
               suppressed=len(findings) - len(active),
               suppressed_by_rule=by_rule)
    log(f"phase 22 lint: {out['files']} files, {out['findings']} "
        f"finding(s), {out['suppressed']} suppressed "
        f"{json.dumps(by_rule, sort_keys=True)}")
    if active:
        raise AssertionError("repro_torch.lint: " + "; ".join(
            f.render() for f in active))
    return out


def mask_numbers(line: str) -> str:
    for pattern in TAIL_MASKS:
        line = pattern.sub(r"\1N\2", line)
    return line


@contextlib.contextmanager
def host_threads(where: str):
    """One thread for a host run, as the CPU tests run the examples; the
    card's runs keep the process's threads."""
    threads = torch.get_num_threads()
    if where == "host":
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def printed(fn, *args) -> list[str]:
    """The lines ``fn(*args)`` prints."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def example_globals(name: str) -> dict:
    """The module globals of ``examples/<name>`` (what its ``main`` reads,
    so an entry replaced there is what ``main`` calls)."""
    import runpy
    return runpy.run_path(os.path.join(ROOT, "examples", name),
                          run_name="example")["main"].__globals__


def run_example(name: str, *args) -> list[str]:
    """``examples/<name>``'s ``main(*args)`` in this process; its lines."""
    return printed(example_globals(name)["main"], *args)


def run_cli(g: dict, *argv: str) -> list[str]:
    """``g``'s ``main()`` under ``sys.argv = [file, *argv]``; its lines."""
    before = sys.argv
    sys.argv = [g["__file__"], *argv]
    try:
        return printed(g["main"])
    finally:
        sys.argv = before


def tail_examples(dev, card: str, workdir: str) -> dict:
    """Both ``_torch`` examples on the card, then on the host (one thread,
    as the CPU tests run them), each planner with a store of its own:
    every line equal but the masked numbers; ``spike_hist`` and
    ``ema_scan`` launched in each card run."""
    out = {}
    for name in TAIL_EXAMPLES:
        planner = name.startswith("fleet")
        runs = {}
        for where, device in (("card", str(dev)), ("host", "cpu")):
            args = (device, os.path.join(workdir, f"tail_store_{where}")) \
                if planner else (device,)
            take_launches()
            t0 = time.perf_counter()
            with host_threads(where):
                lines = run_example(name, *args)
            sync(dev)
            runs[where] = dict(seconds=time.perf_counter() - t0,
                               launches=take_launches(), lines=lines)
        card_lines, host_lines = runs["card"]["lines"], runs["host"]["lines"]
        if [mask_numbers(x) for x in card_lines] != \
                [mask_numbers(x) for x in host_lines] or not card_lines:
            diff = [f"card {a!r} / host {b!r}" for a, b in
                    zip(card_lines, host_lines) if a != b]
            raise AssertionError(f"{name}: the card's lines differ from the "
                                 f"host's: {diff or (card_lines, host_lines)}")
        launched = runs["card"]["launches"]
        if min(launched.values()) == 0:
            raise AssertionError(f"{name} on the card launched {launched}")
        if any(runs["host"]["launches"].values()):
            raise AssertionError(f"{name} on the host launched "
                                 f"{runs['host']['launches']}")
        out[name] = dict(card_s=runs["card"]["seconds"],
                         host_s=runs["host"]["seconds"], launches=launched,
                         lines=card_lines,
                         identical=card_lines == host_lines)
        same = "identical" if card_lines == host_lines \
            else "but masked numbers"
        log(f"phase 22 {name} [{card}]: {len(card_lines)} lines, card = host "
            f"({same}), card {runs['card']['seconds']:.3f} s, host "
            f"{runs['host']['seconds']:.3f} s, launches {json.dumps(launched)}")
    return out


def tail_golden(dev, card: str) -> dict:
    """The seed loops of ``repro_torch.legacy`` against the kernels on the
    card, at the reference's tolerances (these launches are checks, not a
    main path)."""
    from repro_torch import legacy
    from repro_torch.kernels.ema_scan import ema_scan_blocks
    from repro_torch.kernels.ops import ema_scan
    from repro_torch.kernels.spike_hist import (spike_hist_batch,
                                                spike_hist_batch_plain)
    take_launches()
    x = np.random.default_rng(TAIL_EMA_SEED).uniform(40.0, 600.0, TAIL_EMA_N)
    want = legacy.ema_filter_loop(x, 0.5)
    xt = torch.from_numpy(x).to(dev)
    f32 = ema_scan(xt, 0.5).to(torch.float64).cpu().numpy()
    f64 = ema_scan_blocks(xt, alpha=0.5).cpu().numpy()
    np.testing.assert_allclose(f32, want, **TAIL_EMA_F32_TOL)
    np.testing.assert_allclose(f64, want, **TAIL_EMA_F64_TOL)
    out = dict(ema_f32_err=float(np.max(np.abs(f32 - want))),
               ema_f64_err=float(np.max(np.abs(f64 - want))), hist=[])
    for n in TAIL_HIST_N:
        p = np.random.default_rng(n).uniform(0.4, 2.2, n)
        for dtype in (torch.float32, torch.float64):
            r = torch.from_numpy(p).to(dtype)
            counts = spike_hist_batch(r.to(dev)[None, :], (0.1,), (15,))
            plain = spike_hist_batch_plain(r[None, :], (0.1,), (15,))
            above = int((r >= 0.5).sum())
            if int(counts.sum()) != above or \
                    not torch.equal(counts.cpu(), plain):
                raise AssertionError(
                    f"spike_hist over {n} samples ({dtype}): "
                    f"{int(counts.sum())} counted, {above} at or above 0.5")
            out["hist"].append(dict(n=n, dtype=str(dtype), counted=above))
    out["launches"] = take_launches()
    if min(out["launches"].values()) == 0:
        raise AssertionError(f"phase 22's checks launched {out['launches']}")
    log(f"phase 22 seed loops vs kernels [{card}]: ema_scan f32 max err "
        f"{out['ema_f32_err']:.3e} (rtol 2e-4, atol 2e-3), f64 blocks "
        f"{out['ema_f64_err']:.3e} (1e-9); spike_hist counted every sample "
        f">= 0.5 once at n = {', '.join(map(str, TAIL_HIST_N))} (float32 and "
        f"float64, equal to the plain twin)")
    return out


# the two LM examples (serve_lm_torch.py, train_lm_torch.py), run through
# their CLI as a user runs them: every arch served at the example's
# defaults, on the card (the default device) and on the host, the card's
# request replayed on the host with its weights; the ~100M model trained
# on the card at the reference example's defaults (its kernels are held
# to their plain versions at its shapes in phases 6 and 19)
LM_SERVE_TOKENS, LM_SERVE_BATCH, LM_SERVE_PROMPT = 24, 4, 32
LM_SERVE_IDS = "sampled ids (first request): "
LM_SERVE_STATS = re.compile(r"(prefill tokens: \d+  decode steps: \d+  )"
                            r"wall: ([\d.]+)s \(([\d.]+) tok/s incl\. "
                            r"compile\)$")
LM_TRAIN_STEPS, LM_TRAIN_SHAPE = 300, (16, 128)   # (batch, tokens)
LM_TRAIN_SAVES = 3               # checkpoint_every 100 over 300 steps


def serve_example_launches(cfg, tokens: int) -> dict:
    """What ``serve_lm_torch``'s one request of a reduced arch dictates:
    flash per prefill, rmsnorm and ssm_scan per forward (the prefill and
    ``tokens`` decode steps), as phases 14, 17 and the serving phases
    count them."""
    if cfg.is_encoder_decoder:
        return encdec_launches(cfg, 1, tokens)
    if cfg.family == "vlm":
        return vlm_launches(cfg, 1, tokens)
    L = cfg.num_layers
    per = MOE_REDUCED_LAUNCHES.get(cfg.name) or (
        {"flash_attention": 0, "rmsnorm": L + 1, "ssm_scan": L}
        if cfg.family == "ssm" else
        {"flash_attention": L, "rmsnorm": 2 * L + 1, "ssm_scan": 0})
    forwards = 1 + tokens
    return {"flash_attention": per["flash_attention"],
            "rmsnorm": per["rmsnorm"] * forwards,
            "ssm_scan": per["ssm_scan"] * forwards}


def serve_example_lines(lines: list[str], cfg, what: str) -> tuple:
    """The request line and the counts line of one ``serve_lm_torch`` run
    (the wall time and rate masked), and its ids, which must be
    ``--tokens`` of the arch's vocabulary."""
    import ast
    stats = LM_SERVE_STATS.match(lines[2]) if len(lines) == 3 else None
    if stats is None or not lines[1].startswith(LM_SERVE_IDS):
        raise AssertionError(f"{what}: printed {lines}")
    ids = ast.literal_eval(lines[1][len(LM_SERVE_IDS):])
    if len(ids) != LM_SERVE_TOKENS or \
            not all(0 <= i < cfg.vocab_size for i in ids):
        raise AssertionError(f"{what}: sampled {ids}, not {LM_SERVE_TOKENS} "
                             f"ids in [0, {cfg.vocab_size})")
    return (lines[0], stats.group(1)), ids


def recording_engine(engine_cls, rec: dict):
    """``engine_cls`` whose ``generate`` keeps, in ``rec``, the engine, the
    request, the ids it returns and the logits of every forward (the
    prefill's, then each decode step's, as float32 host copies)."""
    class RecordingEngine(engine_cls):
        def generate(self, batch, num_tokens, greedy=True, generator=None):
            model, logits = self.model, []

            def recorded(fn):
                def call(*args):
                    out = fn(*args)
                    logits.append(out[0].float().cpu())
                    return out
                return call
            model.prefill = recorded(model.prefill)
            model.decode_step = recorded(model.decode_step)
            try:
                ids = super().generate(batch, num_tokens, greedy, generator)
            finally:
                del model.prefill, model.decode_step
            rec.update(engine=self, batch=batch, ids=ids, logits=logits)
            return ids
    return RecordingEngine


def serve_replay(dev, rec: dict, arch: str) -> dict:
    """The card's ``serve_lm_torch`` request replayed on the host with the
    card engine's weights, each decode step fed the token the card sampled.
    Without an MoE block, the logits of every forward the card ran (the
    prefill and each decode step) are held to the host's at
    ``LM_TOL[bf16]``; with one, where a near-tie routing flip between the
    devices moves a token's output by O(1), every sublayer of the prefill
    and each decode step is held on the host's input instead
    (``moe_sublayers_vs_host``, near ties only left out).  Launches made
    here do not count."""
    from repro_torch.kernels import build
    from repro_torch.serve import ServeEngine
    card, batch, ids = rec["engine"], rec["batch"], rec["ids"]
    before = dict(build.LAUNCHES)
    host = ServeEngine(card.cfg, max_len=card.max_len, device="cpu")
    host.model.load_state_dict(card.model.state_dict())
    fed = [torch.from_numpy(ids[:, i]).long() for i in range(ids.shape[1])]
    bf16 = LM_TOL[torch.bfloat16]
    kinds = {kind for _, kind in getattr(card.model, "period_kinds", ())}
    with host_threads("host"), torch.no_grad():
        if "moe" in kinds:
            sub = moe_sublayers_vs_host(host, card.model, dev,
                                        batch["tokens"], fed, torch.bfloat16,
                                        arch)
            out = dict(how="sublayers", err=sub["err"],
                       of_tolerance=sub["of_tolerance"],
                       flips=len(sub["flips"]))
        else:
            logits, caches = host.model.prefill(batch)
            mem = batch["frames"].shape[1] if "frames" in batch else None
            caches = host._pad_caches(caches, ids.shape[0], memory_len=mem)
            errs = []
            s = batch["tokens"].shape[1]
            for i, got in enumerate(rec["logits"]):
                errs.append(close(got, logits, bf16, f"phase 22 serve_lm_"
                                  f"torch --arch {arch} logits of forward "
                                  f"{i} (0 = prefill), card vs host"))
                if i < len(fed):
                    logits, caches = host.model.decode_step(caches, fed[i],
                                                            s + i)
            out = dict(how="logits", forwards=len(errs), err=max(errs))
    build.LAUNCHES.update(before)
    return out


def lm_serve_examples(dev, card: str) -> dict:
    """``serve_lm_torch.py --arch A`` for every arch of ``ARCHS`` on the
    card (its default device), then with ``--device cpu`` on the host: the
    request line and the counts equal, the ids in range on both, the
    card's launches exactly what the reduced model dictates, none on the
    host; then the card's request replayed on the host with the card's
    weights (``serve_replay``)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    out, totals = {}, dict.fromkeys(build.LAUNCHES, 0)
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced()
        runs, rec = {}, {}
        for where, extra in (("card", ()), ("host", ("--device", "cpu"))):
            g = example_globals("serve_lm_torch.py")
            if where == "card":
                g["ServeEngine"] = recording_engine(g["ServeEngine"], rec)
            build.reset_launches()
            t0 = time.perf_counter()
            with host_threads(where):
                lines = run_cli(g, "--arch", arch, *extra)
            sync(dev)
            runs[where] = dict(seconds=time.perf_counter() - t0,
                               launches=dict(build.LAUNCHES), lines=lines)
        what = f"phase 22 serve_lm_torch --arch {arch}"
        card_k, card_ids = serve_example_lines(runs["card"]["lines"], cfg,
                                               f"{what} [card]")
        host_k, _ = serve_example_lines(runs["host"]["lines"], cfg,
                                        f"{what} [host]")
        if card_k != host_k:
            raise AssertionError(f"{what}: card {card_k} / host {host_k}")
        want = serve_example_launches(cfg, LM_SERVE_TOKENS)
        want = {k: want.get(k, 0) for k in build.LAUNCHES}
        if runs["card"]["launches"] != want:
            raise AssertionError(f"{what}: the card launched "
                                 f"{runs['card']['launches']}, the reduced "
                                 f"model dictates {want}")
        if any(runs["host"]["launches"].values()):
            raise AssertionError(f"{what}: the host launched "
                                 f"{runs['host']['launches']}")
        for k, v in runs["card"]["launches"].items():
            totals[k] += v
        if rec["ids"][0].tolist() != card_ids:
            raise AssertionError(f"{what}: printed {card_ids}, generate "
                                 f"returned {rec['ids'][0].tolist()}")
        t0 = time.perf_counter()
        replay = serve_replay(dev, rec, arch)
        replay["seconds"] = time.perf_counter() - t0
        wall, rate = LM_SERVE_STATS.match(runs["card"]["lines"][2]).groups(
        )[1:]
        out[arch] = dict(lines=runs["card"]["lines"],
                         host_lines=runs["host"]["lines"],
                         card_s=runs["card"]["seconds"],
                         host_s=runs["host"]["seconds"],
                         wall_s=float(wall), tokens_per_s=float(rate),
                         launches={k: v for k, v in
                                   runs["card"]["launches"].items() if v},
                         replay=replay)
        held = (f"logits of all {replay['forwards']} forwards, max|err| "
                f"{replay['err']:.3e}" if replay["how"] == "logits" else
                "every sublayer, " + ", ".join(
                    f"{k} {v:.3e} ({replay['of_tolerance'][k]:.2f} of the "
                    f"tolerance)" for k, v in replay["err"].items())
                + f", {replay['flips']} near-tie flip(s)")
        log(f"phase 22 serve_lm_torch --arch {arch} [{card}]: lines card = "
            f"host (ids masked), wall {wall} s ({rate} tok/s incl. the first "
            f"call), host {runs['host']['seconds']:.3f} s; launches "
            f"{json.dumps(out[arch]['launches'])}; replayed on the host with "
            f"the card's weights and ids ({replay['seconds']:.3f} s): {held}")
    return dict(archs=out, launches=totals)


def lm_train_example(dev, card: str, workdir: str) -> dict:
    """``train_lm_torch.py`` at the reference example's defaults (300 steps
    of 16 x 128 on the ~100M glm4 reduction, checkpoints every 100 steps
    into a ``tempfile.mkdtemp`` directory, here in ``workdir``, removed
    after) on the card, its ``Trainer`` and ``classify_job`` wrapped to
    read the launches, times and peak memory of each part: every loss
    finite and the last below the first; the training's launches exactly
    ``train_launches(L)`` a step; ``spike_hist`` and ``ema_scan`` launched
    by the Minos part; its line equal to the host's (``classify_job`` on
    the CPU, no training)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import build
    from repro_torch.train import Trainer
    g = example_globals("train_lm_torch.py")
    classify, rec = g["classify_job"], dict(saves=[])

    class RecordingTrainer(Trainer):
        def _save(self, state, step, collect=False):
            sync(self.device)
            t0 = time.perf_counter()
            super()._save(state, step, collect)
            rec["saves"].append(time.perf_counter() - t0)
            rec["last_saved"] = ckpt.latest_step(
                self.run_cfg.checkpoint_dir)

        def run(self, num_steps=None, generator=None):
            sync(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            build.reset_launches()
            t0 = time.perf_counter()
            res = super().run(num_steps, generator)
            sync(self.device)
            rec.update(seconds=time.perf_counter() - t0, result=res,
                       launches=dict(build.LAUNCHES), cfg=self.cfg,
                       peak_gib=torch.cuda.max_memory_allocated(self.device)
                       / 2**30)
            return res

    def recording_classify(cfg, shape, device="cuda"):
        build.reset_launches()
        t0 = time.perf_counter()
        sel = classify(cfg, shape, device)
        sync(dev)
        rec.update(minos_s=time.perf_counter() - t0, shape=shape,
                   minos_launches=dict(build.LAUNCHES))
        return sel

    g["Trainer"], g["classify_job"] = RecordingTrainer, recording_classify
    before = tempfile.tempdir
    tempfile.tempdir = workdir
    try:
        lines = run_cli(g)
    finally:
        tempfile.tempdir = before
        for d in os.listdir(workdir):
            if d.startswith("repro_100m_"):
                shutil.rmtree(os.path.join(workdir, d), ignore_errors=True)
    res, cfg = rec["result"], rec["cfg"]
    losses = res.losses
    if len(losses) != LM_TRAIN_STEPS or \
            not all(np.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm_torch: {len(losses)} losses, first "
                             f"{losses[:3]}, last {losses[-3:]}")
    if len(rec["saves"]) != LM_TRAIN_SAVES or \
            rec["last_saved"] != LM_TRAIN_STEPS:
        raise AssertionError(f"train_lm_torch wrote {len(rec['saves'])} "
                             f"checkpoints, the last at step "
                             f"{rec['last_saved']}")
    check_train_launches("train_lm_torch on the card",
                         {k: rec["launches"][k] for k in
                          train_launches(cfg.num_layers)},
                         cfg.num_layers, LM_TRAIN_STEPS)
    minos = rec["minos_launches"]
    if not (minos["spike_hist"] and minos["ema_scan"]) or any(
            v for k, v in minos.items() if k not in ("spike_hist",
                                                     "ema_scan")):
        raise AssertionError(f"train_lm_torch's Minos part launched {minos}")
    with host_threads("host"):
        host = printed(classify, cfg, rec["shape"], "cpu")
    if lines[-2:] != host or not lines[-1].startswith(
            "Minos classification of this job: power-neighbor="):
        raise AssertionError(f"train_lm_torch's Minos line: card "
                             f"{lines[-2:]}, host {host}")
    steps_ms = np.asarray(res.step_durations) * 1e3
    b, s = LM_TRAIN_SHAPE
    out = dict(lines=lines, losses=losses, num_layers=cfg.num_layers,
               n_params=cfg.param_count(), seconds=rec["seconds"],
               step_ms=dict(first=float(steps_ms[0]),
                            median=float(np.median(steps_ms)),
                            p10=float(np.percentile(steps_ms, 10)),
                            p90=float(np.percentile(steps_ms, 90)),
                            min=float(steps_ms.min()),
                            max=float(steps_ms.max())),
               tokens_per_s=b * s / float(np.median(steps_ms)) * 1e3,
               checkpoint_s=rec["saves"], peak_gib=rec["peak_gib"],
               launches=rec["launches"], minos_s=rec["minos_s"],
               minos_launches=minos)
    sm = out["step_ms"]
    log(f"phase 22 train_lm_torch [{card}]: {cfg.param_count()} parameters "
        f"({cfg.num_layers} layers), {LM_TRAIN_STEPS} steps of {b} x {s}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step median "
        f"{sm['median']:.3f} ms (p10 {sm['p10']:.3f}, p90 {sm['p90']:.3f}, "
        f"min {sm['min']:.3f}, max {sm['max']:.3f}, the first "
        f"{sm['first']:.3f}), {out['tokens_per_s']:.1f} tokens/s; "
        f"checkpoints {', '.join(f'{x:.3f}' for x in rec['saves'])} s; "
        f"peak {rec['peak_gib']:.3f} GiB; run {rec['seconds']:.3f} s; "
        f"launches {json.dumps({k: v for k, v in rec['launches'].items() if v})}")
    log(f"phase 22 train_lm_torch Minos part [{card}]: {lines[-1]!r} = the "
        f"host's; {rec['minos_s']:.3f} s, launches "
        f"{json.dumps({k: v for k, v in minos.items() if v})}")
    return out


def tail_phase(dev, card: str, workdir: str) -> dict:
    """Phase 22: the port's lint over the tree, both facade examples on the
    card and the host, the seed loops against the kernels, both LM
    examples (every arch served card vs host, the ~100M model trained)."""
    t_phase = time.perf_counter()
    out = dict(lint=tail_lint(), examples=tail_examples(dev, card, workdir),
               golden=tail_golden(dev, card))
    t0 = time.perf_counter()
    out["serve_lm"] = lm_serve_examples(dev, card)
    out["serve_lm"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train_lm"] = lm_train_example(dev, card, workdir)
    out["train_lm"]["phase_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 22 (lint, examples, seed loops, LM examples): "
        f"{out['seconds']:.3f} s (serve_lm_torch {out['serve_lm']['seconds']:.3f}"
        f" s, train_lm_torch {out['train_lm']['phase_s']:.3f} s) [{card}]")
    return out


# ---------------------------------------------------------------------------
# phases 23-26: tensor-parallel serving over a (1, 4) mesh
# ---------------------------------------------------------------------------
TP = 4
TP_ARCH = "command-r-35b"
TP_CHECK_LAYERS = 8        # the comparison with one card: 8 of 40 layers
TP_REQUEST = (4, 1000)     # (batch, prompt tokens)
TP_STEPS = 8               # teacher-forced decode steps held to one card
# phase 24: jamba-1.5-large-398b at full width.  One card holds the check
# model, 2 of 72 layers at the reduction's interleave (layer 0 Mamba + MLP,
# layer 1 attention + MoE: 11.91 B parameters); four cards serve one whole
# published period (8 layers: 7 Mamba + 1 attention, 4 MoE + 4 MLP, 45.24
# B parameters, 90.5 GB in bfloat16)
TP_HYBRID_ARCH = JAMBA
TP_HYBRID_CHECK = dict(num_layers=2, attn_period=2)
TP_HYBRID_SERVE_LAYERS = 8
# phase 25: deepseek-v2-236b at full width (MLA, 160 experts top 6, 2
# shared).  One card holds the check model, 2 of 60 layers with the MoE
# last, as DeepSeek-V2 starts (layer 0 MLA + dense MLP, layer 1 MLA + MoE:
# 5.35 B parameters, 10.7 GB in bfloat16): a token rerouted at a near tie
# in an earlier MoE layer would carry an O(1) change into every later
# layer's input (phase 24 cuts jamba's interleave for the same reason);
# four cards serve 8 layers, every one MoE (33.47 B parameters, 66.9 GB;
# 32.8 GB a rank with both layouts' blocks, by
# ``launch.serve.rank_weight_bytes``)
TP_MLA_CHECK = dict(num_layers=2, moe_layer_period=2, layers_per_period=2)
TP_MLA_SERVE_LAYERS = 8
# phase 26: llama-3.2-vision-11b's check model is one period (5 layers, its
# gated cross layer last) over 1,600 image embeddings, four cards serve all
# 40 layers; whisper-medium (24 + 24 layers) whole either way, 4 x 64
# prompts over a 1,500-frame window
TP_WHISPER_REQUEST = (4, 64)
# whisper's threads serve 8 new tokens, not NEW_TOKENS: each decode step of
# its 24 decoder layers takes ~1.65 s over four threads on one card, and
# phase 27 needs the time (the NCCL processes serve NEW_TOKENS)
TP_WHISPER_THREAD_TOKENS = 8


def tp_launches(cfg, prefills: int, forwards: int) -> dict:
    """What a rank of ``cfg`` dictates: one flash launch per attention
    layer and prefill (on the rank's heads; a vlm's cross layers too, the
    enc-dec model's encoder and its decoder's self and cross layers; none
    for MLA, whose prefill attention is plain), one ``ssm_scan`` per Mamba
    layer and forward (on the rank's channels), one rmsnorm per norm (one a
    sublayer, MLA's latent norm, and the final one; none under LayerNorm)
    and forward (on the rank's rows)."""
    if cfg.is_encoder_decoder:
        return {"flash_attention": (cfg.num_encoder_layers
                                    + 2 * cfg.num_layers) * prefills,
                "rmsnorm": 0, "ssm_scan": 0}
    layers = range(cfg.num_layers)
    attn = sum(cfg.is_attn_layer(j) for j in layers)
    cross = cfg.num_layers // cfg.cross_attn_period \
        if cfg.family == "vlm" else 0
    norms = sum(1 + bool(cfg.is_moe_layer(j) or cfg.d_ff) for j in layers)
    norms += cross + (cfg.num_layers if cfg.use_mla else 0)
    return {"flash_attention": 0 if cfg.use_mla else (attn + cross)
            * prefills,
            "rmsnorm": (norms + 1) * forwards,
            "ssm_scan": (cfg.num_layers - attn) * forwards}


def seed_cross(model, seed: int = 22) -> None:
    """A vlm's gates (``seed_gates``) and every attention bias (zero at
    init, where a bias added once a rank would not show) drawn away from
    0, in parameter order: normal * 0.1 from ``seed``.  Gates and biases
    are whole on every rank, so one card and each rank set the same
    values; a model without them is left as it is."""
    seed_gates(model)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "bo"):
                p.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32) * 0.1))


def seed_experts(engine, seed: int = 25) -> None:
    """Every MoE block's routed experts redrawn at their own fan-in,
    normal / sqrt(d_model) for ``w_gate`` / ``w_up`` and / sqrt(d_ff) for
    ``w_down``, as the CPU tests draw them
    (``tests/test_torch_moe_models.moe_tree``): the seeded init draws a
    stacked expert at 1/sqrt(E), its def's first dim, so the MoE output
    dwarfs the residual (deepseek-v2's expert rows reach ~200) and a
    comparison of the logits reads little but the bfloat16 rounding of
    its rows.  Each tensor is drawn whole on the engine's device from
    ``seed`` (one at a time among the ranks of a process), and each of the
    engine's models keeps its block: one card and every rank hold blocks
    of the same tensors."""
    from repro_torch.models.common import ParamDef, init_param_
    from repro_torch.models.transformer import _WHOLE_DRAWS
    models = list({id(m): m for m in (engine.model,
                                      engine.decode_model)}.values())
    held = [(dict(m.named_parameters()), m.blocks()) for m in models]
    defs = engine.model.param_defs().defs
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    with torch.no_grad():
        for name in sorted(defs):
            d = defs[name]
            if name.rsplit(".", 1)[-1] not in ("w_gate", "w_up", "w_down") \
                    or len(d.shape) != 3:
                continue
            with _WHOLE_DRAWS:
                whole = init_param_(torch.empty(
                    d.shape, dtype=held[0][0][name].dtype,
                    device=engine.device), ParamDef(
                    d.shape, d.axes, scale=d.shape[1] ** -0.5), gen)
                for params, blocks in held:
                    params[name].copy_(whole[blocks[name]])
                del whole


def tp_step_kw(engine, batch: dict) -> dict:
    """A rank's decode arguments: the caches' length, and an enc-dec
    request's memory length; one card's: none."""
    if engine.group is None:
        return {}
    kw = {"cache_len": engine.max_len}
    if memory_len(batch) is not None:
        kw["memory_len"] = memory_len(batch)
    return kw


def memory_len(batch: dict) -> int | None:
    """An enc-dec request's frames, which size its cross caches."""
    return batch["frames"].shape[1] if "frames" in batch else None


def memory_note(batch: dict) -> str:
    """The request's memory, for the log: image tokens or frames."""
    for key, what in (("image_embeds", "image tokens"), ("frames", "frames")):
        if key in batch:
            return f", {batch[key].shape[1]} {what}"
    return ""


@contextlib.contextmanager
def routes_of(models):
    """Every MoE routing the blocks of ``models`` make while open, in call
    order, on the host: each token's input (T, d), its experts (T, k),
    whether each choice reached its expert, its router probabilities
    (T, E) and the group size."""
    from repro_torch.models.moe import MoE
    got, patched = [], {}
    for model in models:
        for m in model.modules():
            if isinstance(m, MoE) and id(m) not in patched:
                def route(xg, _m=m, _orig=m._route):
                    r = _orig(xg)
                    k, E = r.topi.shape[-1], _m.num_experts
                    got.append(dict(
                        S=xg.shape[1], x=xg.reshape(-1, xg.shape[-1]).cpu(),
                        topi=r.topi.reshape(-1, k).cpu(),
                        dispatched=r.dispatched.reshape(-1, k).cpu(),
                        probs=_m._probs(xg).reshape(-1, E).cpu()))
                    return r
                m._route = route
                patched[id(m)] = m
    try:
        yield got
    finally:
        for m in patched.values():
            del m._route


def route_digest(routes: list) -> list:
    """The routings as bytes, to show that the ranks route alike."""
    return [r["topi"].numpy().tobytes() + r["dispatched"].numpy().tobytes()
            for r in routes]


def tp_routes_part(one: list, ranks: list, forwards: int) -> list:
    """Per forward (prefill, then each decode step), the tokens whose MoE
    routing on the ranks parted from one card's: a (T,) host mask over the
    forward's tokens (row-major), the flips, the largest share of
    ``LM_TOL[bf16]`` by which the MoE inputs differ, which must be at most
    1, and the router's noise: the largest change, over a call's tokens,
    of the difference of two experts' probabilities, which the inputs'
    differences within that tolerance cause.  A token whose experts differ
    must be a near tie: one card's margin (the least gap between
    neighbouring router probabilities among its first k + 1) within the
    noise of its call; a token whose experts are the same but whose
    choices reached their experts differently must share its group with
    such a flip (a capacity slot moved).  The model's MoE blocks run in
    the same order on both, ``len(one) // forwards`` a forward."""
    if len(one) != len(ranks) or len(one) % forwards:
        raise AssertionError(f"{len(one)} MoE routings on one card, "
                             f"{len(ranks)} on the ranks, {forwards} "
                             f"forwards")
    tol = LM_TOL[torch.bfloat16]
    per = len(one) // forwards
    out = []
    for f in range(forwards):
        mask, flips, share, noise = None, [], 0.0, 0.0
        for i in range(f * per, (f + 1) * per):
            a, w = ranks[i], one[i]
            xa, xw = a["x"].float(), w["x"].float()
            share = max(share, float(((xa - xw).abs() / (
                tol["atol"] + tol["rtol"] * xw.abs())).max()))
            if share > 1.0:
                raise AssertionError(
                    f"MoE call {i} (forward {f}): the ranks' input parts "
                    f"from one card's by {share:.3f} of LM_TOL[bf16]")
            d = a["probs"] - w["probs"]
            reach = float((d.amax(-1) - d.amin(-1)).max())
            noise = max(noise, reach)
            v = torch.sort(w["probs"], dim=-1, descending=True).values
            k = w["topi"].shape[-1]
            margin = (v[:, :k] - v[:, 1:k + 1]).min(-1).values
            flip = (a["topi"] != w["topi"]).any(-1)
            moved = (a["dispatched"] != w["dispatched"]).any(-1)
            S = w["S"]
            for t in torch.nonzero(flip)[:, 0].tolist():
                flips.append(dict(forward=f, call=i, token=t,
                                  one_card_margin=float(margin[t]),
                                  noise=reach))
                if margin[t] > reach:
                    raise AssertionError(
                        f"MoE token {t} of forward {f} routes differently on "
                        f"the ranks, one card's margin {margin[t]:.3e} "
                        f"beyond the router's noise {reach:.3e}")
            groups = set((torch.nonzero(flip)[:, 0] // S).tolist())
            for t in torch.nonzero(moved & ~flip)[:, 0].tolist():
                if t // S not in groups:
                    raise AssertionError(
                        f"MoE token {t} of forward {f}: its slots differ on "
                        f"the ranks with no flip in its group")
            hit = flip | moved
            mask = hit if mask is None else mask | hit
        out.append(dict(mask=mask, flips=flips, input_share=share,
                        noise=noise))
    return out


def tp_teacher_forced(engine, batch: dict, ids: np.ndarray) -> dict:
    """Prefill logits and ``len(ids[0])`` decode steps fed ``ids``, as
    float32 host tensors over the vocabulary."""
    dev, vocab = engine.device, engine.cfg.vocab_size
    b, s = batch["tokens"].shape
    logits, caches = engine.model.prefill(batch)
    out = [logits[:, :vocab].float().cpu()]
    caches = engine._pad_caches(caches, b, memory_len=memory_len(batch))
    for i in range(ids.shape[1]):
        logits, caches = engine.decode_model.decode_step(
            caches, torch.from_numpy(ids[:, i]).to(dev), s + i,
            **tp_step_kw(engine, batch))
        out.append(logits[:, :vocab].float().cpu())
    return {"logits": out}


def tp_one_card(dev, cfg, batch: dict, fan_in_experts: bool) -> dict:
    """The unsharded model on one card with the seeded init (gates and
    biases away from 0, ``seed_cross``; with ``fan_in_experts`` the routed
    experts at their fan-in, ``seed_experts``): its greedy ids
    (``TP_STEPS``),
    then the prefill and those ids fed back, with its MoE routings and
    their margins."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, max_len=batch["tokens"].shape[1] + NEW_TOKENS + 4,
                      device=dev)
    eng.init_params(0)
    seed_cross(eng.model)
    if fan_in_experts:
        seed_experts(eng)
    ids = eng.generate(batch, TP_STEPS)
    with routes_of([eng.model]) as routes:
        out = dict(tp_teacher_forced(eng, batch, ids), ids=ids)
    out["routes"] = routes
    del eng
    torch.cuda.empty_cache()
    return out


def tp_greedy_flips(ids: np.ndarray, want: np.ndarray, logits: list,
                    want_logits: list, rerouted: set = frozenset()) -> list:
    """The ranks' greedy ids against one card's, row by row up to the
    first that differs (the sequences part there): at that step the
    ranks' own logits must prefer the ranks' token, and one card's
    preference for its token must be no more than the two logit rows'
    difference at those two tokens (the rounding of another order decides
    such a tie either way), unless the row's token was routed to other MoE
    experts at a proven near tie there (``rerouted``: (row, step) pairs,
    ``tp_routes_part``); every other id equal.  ``logits[k]`` are the
    ranks' logits that chose token k, ``want_logits[k]`` one card's, on
    one card's ids in both.  Returns the flips."""
    flips = []
    for row in range(want.shape[0]):
        diff = np.nonzero(ids[row] != want[row])[0]
        if not len(diff):
            continue
        k = int(diff[0])
        mine, theirs = int(ids[row, k]), int(want[row, k])
        a, w = logits[k][row], want_logits[k][row]
        gap = float(w[theirs] - w[mine])
        d = a - w
        reach = abs(float(d[theirs] - d[mine]))
        flip = dict(row=row, step=k, one_card=theirs, ranks=mine, gap=gap,
                    logit_diff=reach,
                    ranks_prefer=float(a[mine] - a[theirs]),
                    rerouted=(row, k) in rerouted)
        if not flip["rerouted"] and (gap > reach or a[mine] < a[theirs]):
            raise AssertionError(f"greedy ids part at a token that is not a"
                                 f" near tie: {json.dumps(flip)}")
        flips.append(flip)
    return flips


def tp_rank(group, cfg_check, cfg_serve, batch: dict, ids: np.ndarray,
            new_tokens: int, fan_in_experts: bool) -> dict:
    """One rank of phases 23-26 (a thread of a ``LocalGroup`` or a process
    of an NCCL group): ``cfg_check`` with the seeded init (the rank's
    blocks of the tensors one card draws; gates and biases by
    ``seed_cross``, experts by ``seed_experts`` with ``fan_in_experts``),
    its prefill of
    ``batch`` and ``ids`` fed back (its MoE routings kept: whole on rank
    0, as a digest on the others), then ``generate``'s greedy ids; then
    one request of ``batch``'s shapes (new tokens, the same stub input)
    and ``new_tokens`` through ``generate`` on ``cfg_serve`` (``None``:
    the check model again), timed step by step, with the launches of each
    part counted on this rank alone, and the calls and bytes of each
    collective in its prefill and in one decode step."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import tp_mesh
    from repro_torch.models.common import Topo
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import ServeStats
    dev = group.device
    topo = Topo(tp_mesh(group.size))
    b, s = batch["tokens"].shape
    max_len = s + new_tokens + 4
    out = {"rank": group.rank}

    def engine(cfg):
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, max_len=max_len, device=dev, topo=topo,
                          group=group)
        eng.init_params(0)
        seed_cross(eng.model)
        if fan_in_experts:
            seed_experts(eng)
        sync(dev)
        return eng, time.perf_counter() - t0

    eng, init_s = engine(cfg_check)
    with build.rank_counts() as launches:
        with routes_of([eng.model, eng.decode_model]) as routes:
            check = tp_teacher_forced(eng, batch, ids)
        check["ids"] = eng.generate(batch, ids.shape[1])
    check.update(launches=dict(launches), init_s=init_s,
                 route_digest=route_digest(routes))
    if group.rank == 0:          # rank 0 brings the logits and routings
        check["routes"] = routes
    else:                        # the rest agree with them
        check["digest"] = [float(x.double().sum()) for x in
                           check.pop("logits")]
    out["check"] = check
    if cfg_serve is not None:
        del eng
        torch.cuda.empty_cache()
        eng, init_s = engine(cfg_serve)
    cfg = eng.cfg
    serve_batch = dict(batch, tokens=np.random.default_rng(24).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    eng.stats = ServeStats()
    card = dev.type == "cuda"       # a rehearsal on the host measures none
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    with build.rank_counts() as launches:
        t0 = time.perf_counter()
        got = eng.generate(serve_batch, new_tokens)
        sync(dev)
        wall = time.perf_counter() - t0
    steps_ms = sorted(x * 1e3 for x in eng.stats.step_s)
    serve = dict(
        num_layers=cfg.num_layers, init_s=init_s, wall_s=wall,
        launches=dict(launches), ids_in_range=bool(
            got.min() >= 0 and got.max() < cfg.vocab_size),
        ids=got, first_token_ms=eng.stats.first_token_s * 1e3,
        decode_ms_median=steps_ms[len(steps_ms) // 2],
        decode_ms_min=steps_ms[0], decode_ms_max=steps_ms[-1],
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if card
        else float("nan"),
        weights_gib=sum(p.numel() * p.element_size() for p in {
            id(p): p for m in (eng.model, eng.decode_model)
            for p in m.parameters()}.values()) / 2**30)
    group.reset_counts()          # the collectives of one prefill ...
    logits, caches = eng.model.prefill(serve_batch)
    serve["prefill_collectives"] = {k: dict(v) for k, v in
                                    group.counts.items()}
    caches = eng._pad_caches(caches, b, memory_len=memory_len(batch))
    group.reset_counts()          # ... and of one decode step
    eng.decode_model.decode_step(caches, logits.argmax(-1), s,
                                 **tp_step_kw(eng, batch))
    serve["step_collectives"] = {k: dict(v) for k, v in
                                 group.counts.items()}
    out["serve"] = serve
    return out


def tp_serving(dev, card: str, phase: int, cfg, cfg_check, cfg_serve,
               request: tuple = TP_REQUEST, memory: int | None = None,
               fan_in_experts: bool = False,
               thread_tokens: int = NEW_TOKENS) -> dict:
    """Phases 23-26: ``cfg`` served over a (1, 4) mesh, ``request`` (batch,
    prompt tokens) with the family's stub input (a vlm's image embeddings,
    an enc-dec model's ``memory`` frames).  With 4 cards or more, 4 NCCL
    processes (one a card) serve ``cfg_serve``; with fewer, the 4 ranks
    are ``LocalGroup`` threads on the cards there are and serve
    ``cfg_check`` again.  Either way the 4 ranks on ``cfg_check`` are held
    to the unsharded model on one card with the same seeded weights:
    prefill logits and ``TP_STEPS`` teacher-forced steps within
    ``LM_TOL[bf16]`` (a row whose token the ranks routed to other MoE
    experts than one card at a proven near tie excepted,
    ``tp_routes_part``), greedy ids equal but at near ties
    (``tp_greedy_flips``), every rank's MoE routings the same; and every
    rank's launches are pinned.  The threads serve ``thread_tokens`` new
    tokens (``NEW_TOKENS`` on the NCCL processes)."""
    from repro_torch.models.parallel import run_local, spawn
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    nccl = n >= TP
    group = "nccl, one process a card" if nccl else \
        f"local, {TP} threads on {n} card(s)"
    log(f"phase {phase} (tensor-parallel serving, tp = {TP}, {cfg.name}): "
        f"torch.cuda.device_count() = {n}; group: {group}")
    if not nccl:
        log(f"fewer than {TP} cards: {cfg.name} at full width on "
            f"{cfg_check.num_layers} of its {cfg.num_layers} layers, the "
            f"{TP} ranks as LocalGroup threads on the {n} card(s) there are")
    batch = {"tokens": np.random.default_rng(23).integers(
        0, cfg.vocab_size, request).astype(np.int32)}
    if cfg.family in ("vlm", "audio"):
        batch.update(stub_inputs(cfg, request[0], memory=memory))
    t0 = time.perf_counter()
    one = tp_one_card(dev, cfg_check, batch, fan_in_experts)
    one_s = time.perf_counter() - t0
    new_tokens = NEW_TOKENS if nccl else thread_tokens
    args = (cfg_check, cfg_serve if nccl else None, batch, one["ids"],
            new_tokens, fan_in_experts)
    t0 = time.perf_counter()
    if nccl:
        ranks = spawn(tp_rank, TP, "nccl", timeout=900.0, args=args)
    else:
        ranks = run_local(lambda g: tp_rank(g, *args), TP,
                          [torch.device("cuda", i) for i in range(n)]
                          if dev.type == "cuda" else [dev])
    ranks_s = time.perf_counter() - t0
    got = ranks[0]["check"]
    for r in ranks:
        if r["check"]["route_digest"] != got["route_digest"]:
            raise AssertionError(f"rank {r['rank']}'s MoE routings differ "
                                 f"from rank 0's")
    parts = tp_routes_part(one["routes"], got["routes"], 1 + TP_STEPS)
    b, s = request
    rerouted = set()             # (row, forward) whose token was rerouted
    for f, part in enumerate(parts):
        if part["mask"] is None:
            continue
        for row in range(b):
            if part["mask"][row * s + s - 1 if f == 0 else row]:
                rerouted.add((row, f))
    tol = LM_TOL[torch.bfloat16]
    errs = []
    for i, (a, w) in enumerate(zip(got["logits"], one["logits"])):
        share_rows = ((a - w).abs() / (tol["atol"] + tol["rtol"]
                                       * w.abs())).amax(-1)
        keep = [row for row in range(b) if (row, i) not in rerouted]
        err = float((a - w)[keep].abs().max()) if keep else 0.0
        share = float(share_rows[keep].max()) if keep else 0.0
        errs.append(dict(step=i, max_abs_err=err, share_of_tol=share,
                         rerouted_rows=[row for row in range(b)
                                        if (row, i) in rerouted],
                         rerouted_share=[float(share_rows[row])
                                         for row in range(b)
                                         if (row, i) in rerouted]))
        if share > 1.0:
            raise AssertionError(f"tp = {TP} vs one card, "
                                 f"{'prefill' if i == 0 else f'step {i}'}:"
                                 f" logits {err} apart, {share:.3f} of "
                                 f"LM_TOL[bf16]")
    digest = [float(x.double().sum()) for x in got["logits"]]
    for r in ranks:
        if r["rank"] and (r["check"]["digest"] != digest or not
                          np.array_equal(r["check"]["ids"], got["ids"])):
            raise AssertionError(f"rank {r['rank']}'s logits or ids differ "
                                 f"from rank 0's")
    flips = tp_greedy_flips(got["ids"], one["ids"], got["logits"],
                            one["logits"], rerouted)
    want_check = tp_launches(cfg_check, 2, 2 + 2 * TP_STEPS)
    served = cfg_serve if nccl else cfg_check
    want_serve = tp_launches(served, 1, 1 + new_tokens)
    for r in ranks:
        for part, want in (("check", want_check), ("serve", want_serve)):
            got_l = {k: r[part]["launches"][k] for k in want}
            if got_l != want:
                raise AssertionError(f"rank {r['rank']} {part}: launches "
                                     f"{got_l}, the model dictates {want}")
        if not r["serve"]["ids_in_range"] or not np.array_equal(
                r["serve"]["ids"], ranks[0]["serve"]["ids"]):
            raise AssertionError(f"rank {r['rank']}: served ids out of "
                                 f"range or unlike rank 0's")
    worst = max(errs, key=lambda e: e["share_of_tol"])
    route_flips = [fl for part in parts for fl in part["flips"]]
    log(f"tp = {TP} vs one card [{card}]: {cfg.name} on "
        f"{cfg_check.num_layers} of {cfg.num_layers} layers at "
        f"{b} x {s}{memory_note(batch)}, prefill and {TP_STEPS} "
        f"teacher-forced steps within LM_TOL[bf16] (largest "
        f"{worst['max_abs_err']:.4g}, {worst['share_of_tol']:.3f} of it, "
        f"{'prefill' if worst['step'] == 0 else 'step %d' % worst['step']}"
        f"), greedy ids equal on every rank and to one card's "
        f"{'up to near ties ' + json.dumps(flips) if flips else 'at every step'}"
        f"; launches a rank {json.dumps(want_check)} (one card {one_s:.1f} s)")
    if one["routes"]:
        log(f"  MoE routings [{card}]: {len(one['routes'])} a model, equal "
            f"on the 4 ranks; their inputs within "
            f"{max(p['input_share'] for p in parts):.3f} of LM_TOL[bf16] of"
            f" one card's, router probabilities' noise up to "
            f"{max(p['noise'] for p in parts):.3e}; {len(route_flips)} "
            f"token(s) routed otherwise than on one card, each a near tie "
            f"(one card's margins "
            f"{sorted(round(fl['one_card_margin'], 6) for fl in route_flips)}"
            f" within their call's noise); rows excepted from the tolerance "
            f"(row, forward): {sorted(rerouted)}")
    per_step = {}
    for r in ranks:
        sv = r["serve"]
        per_step = {k: sv["step_collectives"][k]
                    for k in sv["step_collectives"]}
        log(f"  rank {r['rank']} [{card}]: {cfg.name} {sv['num_layers']} "
            f"layers, {b} x {s} -> {new_tokens} "
            f"tokens: first token {sv['first_token_ms']:.3f} ms, decode "
            f"{sv['decode_ms_median']:.3f} ms/step (median; "
            f"{sv['decode_ms_min']:.3f}-{sv['decode_ms_max']:.3f}), "
            f"weights {sv['weights_gib']:.3f} GiB, peak "
            f"{sv['peak_gib']:.3f} GiB"
            f"{'' if nccl else ' (the card, shared by its ranks)'}, init "
            f"{sv['init_s']:.3f} s; launches "
            f"{json.dumps({k: v for k, v in sv['launches'].items() if v})}")
    sv = ranks[0]["serve"]
    log(f"  collectives a rank hands in [{card}] (calls, bytes): prefill "
        f"{json.dumps({k: [v['calls'], v['bytes']] for k, v in sv['prefill_collectives'].items()})}"
        f", a decode step "
        f"{json.dumps({k: [v['calls'], v['bytes']] for k, v in per_step.items()})}")
    out = dict(device_count=n, group=group, tp=TP, arch=cfg.name,
               check_layers=cfg_check.num_layers, request=list(request),
               memory=memory_note(batch)[2:] or None,
               errors=errs, flips=flips, route_flips=route_flips,
               route_noise=[p["noise"] for p in parts],
               route_input_share=[p["input_share"] for p in parts],
               rerouted=sorted(rerouted), one_card_s=one_s,
               ranks_s=ranks_s, launches_check=want_check,
               launches_serve=want_serve,
               ranks=[{part: {k: v for k, v in r[part].items()
                              if k not in ("logits", "ids", "digest",
                                           "routes", "route_digest")}
                       for part in ("check", "serve")} for r in ranks])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase {phase} (tensor-parallel serving, {cfg.name}): "
        f"{out['seconds']:.3f} s [{card}]")
    return out


def tp_phase(dev, card: str) -> dict:
    """Phase 23: command-r-35b (dense) over a (1, 4) mesh: all 40 layers
    on 4 cards, the 4 ranks on 8 of 40 held to one card."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[TP_ARCH]
    return tp_serving(dev, card, 23, cfg, dataclasses.replace(
        cfg, num_layers=TP_CHECK_LAYERS), cfg)


def tp_hybrid_phase(dev, card: str) -> dict:
    """Phase 24: jamba-1.5-large-398b (Mamba, attention, MoE and MLP
    layers) over a (1, 4) mesh: one whole 8-layer period on 4 cards, the 4
    ranks on 2 of 72 layers (``TP_HYBRID_CHECK``) held to one card."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[TP_HYBRID_ARCH]
    return tp_serving(dev, card, 24, cfg,
                      dataclasses.replace(cfg, **TP_HYBRID_CHECK),
                      dataclasses.replace(
                          cfg, num_layers=TP_HYBRID_SERVE_LAYERS))


def tp_mla_phase(dev, card: str) -> dict:
    """Phase 25: deepseek-v2-236b (MLA and MoE) over a (1, 4) mesh: 8 of
    60 layers on 4 cards, the 4 ranks on 2 layers (``TP_MLA_CHECK``) held
    to one card."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[DEEPSEEK]
    return tp_serving(dev, card, 25, cfg,
                      dataclasses.replace(cfg, **TP_MLA_CHECK),
                      dataclasses.replace(cfg,
                                          num_layers=TP_MLA_SERVE_LAYERS),
                      fan_in_experts=True)


def tp_cross_phase(dev, card: str) -> dict:
    """Phase 26: cross-attention over a (1, 4) mesh.  llama-3.2-vision-11b
    over 1,600 image embeddings (all 40 layers on 4 cards, the 4 ranks on
    one 5-layer period with its gated cross layer held to one card), then
    whisper-medium whole over a 1,500-frame window; gates and biases
    drawn away from 0 (``seed_cross``)."""
    from repro_torch.configs import ARCHS
    vlm = ARCHS[VLM]
    out = {VLM: tp_serving(dev, card, 26, vlm, dataclasses.replace(
        vlm, num_layers=vlm.cross_attn_period), vlm)}
    torch.cuda.empty_cache()
    whisper = ARCHS[WHISPER]
    out[WHISPER] = tp_serving(dev, card, 26, whisper, whisper, whisper,
                              request=TP_WHISPER_REQUEST,
                              memory=WHISPER_FRAMES,
                              thread_tokens=TP_WHISPER_THREAD_TOKENS)
    return out


def tp_phases(dev, card: str) -> dict:
    """Phases 23-26, each after the card's cache of the last is
    released."""
    out = {}
    for key, phase in (("tp", tp_phase), ("tp_hybrid", tp_hybrid_phase),
                       ("tp_mla", tp_mla_phase),
                       ("tp_cross", tp_cross_phase)):
        out[key] = phase(dev, card)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 27: tensor-parallel training
# ---------------------------------------------------------------------------
# glm4-9b (dense) and falcon-mamba-7b (ssm) at full width over a (1, 4) mesh
# at 4 x 1024 (the residual cut over the sequence): the check models, 2 of
# 40 and 2 of 64 layers, held to one card for 3 steps; the resume on
# falcon-mamba-7b's check model (4 steps, 2 with a checkpoint at step 2, a
# fresh spawn resumed, 4.75 GB a checkpoint, two written); with 4 cards
# both whole (9.40 B and 7.27 B parameters: 112.8 GB and 87.3 GB of train
# state, ~28 GB and ~22 GB a rank), 3 steps
TP_TRAIN_ARCHS = (GLM, MAMBA)
TP_TRAIN_CHECK_LAYERS = 2
TP_TRAIN_SHAPE = (4, 1024)
TP_TRAIN_STEPS = 3
TP_RESUME_STEPS = 4
TP_RESUME_AT = 2


def tp_train_run_cfg(steps: int, directory: str | None = None):
    from repro_torch.configs.base import RunConfig
    return RunConfig(total_steps=steps, warmup_steps=1,
                     checkpoint_every=TP_RESUME_AT, checkpoint_dir=directory)


def tp_train_shape(b: int, s: int):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"train_{b}x{s}", s, b, "train")


def tp_train_batches(cfg, steps: int) -> list[dict]:
    """The batches a ``Trainer`` of ``cfg`` feeds its first ``steps``
    steps (``SyntheticTokens`` at the run's seed), as numpy arrays."""
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(cfg, tp_train_shape(*TP_TRAIN_SHAPE),
                           seed=tp_train_run_cfg(steps).seed)
    return [data.batch_at(i) for i in range(steps)]


def tp_train_counts(cfg, tp: int = TP) -> dict:
    """Rank 0's collectives (calls, bytes) in one train step of ``cfg``
    over a (1, tp) mesh at ``TP_TRAIN_SHAPE``, counted on meta with tp
    ``LocalGroup`` threads (the forward, its recomputation and the
    backward, the gradient shares' sum and the norm's)."""
    from repro_torch.launch.mesh import tp_mesh
    from repro_torch.models.common import Topo
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.parallel import run_local
    from repro_torch.train.step import make_state, make_train_step
    meta = torch.device("meta")
    batch = {k: torch.zeros(TP_TRAIN_SHAPE, dtype=torch.int64, device=meta)
             for k in ("tokens", "labels")}
    run_cfg = tp_train_run_cfg(1)

    def rank(g) -> dict:
        model = build_model(cfg, Topo(tp_mesh(tp)), "train", device=meta,
                            group=g)
        state = make_state(dict(model.named_parameters()), run_cfg)
        step = make_train_step(model, run_cfg)
        g.reset_counts()
        step(state, batch)
        return collective_counts(g)

    return run_local(rank, tp, [meta])[0]


def collective_counts(group) -> dict:
    return {k: [v["calls"], v["bytes"]] for k, v in group.counts.items()
            if v["calls"]}


def tp_train_one_card(dev, cfg, batches: list) -> dict:
    """The unsharded ``cfg`` on one card, seeded as a ``Trainer`` seeds
    it, stepped over ``batches``: its losses and grad norms, and the final
    parameters and moments, kept on the card for the ranks to read."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.step import init_state, make_train_step
    run_cfg = tp_train_run_cfg(len(batches))
    model = build_model(cfg, kind="train", device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(run_cfg.seed)
    state = init_state(model, run_cfg, gen)
    step = make_train_step(model, run_cfg)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = {n: (p.detach(), state["opt"]["m"][n], state["opt"]["v"][n])
             for n, p in state["params"].items()}
    return dict(losses=losses, norms=norms, final=final)


def tp_whole_leaves_equal(group, tensors: list) -> bool:
    """The tensors every rank holds whole carry the same bits on every
    rank: their bytes gathered in one collective and compared."""
    flat = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in tensors])
    parts = group.all_gather(flat[None], 0)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def tp_train_check(group, cfg, batches: list, ref: dict) -> dict:
    """A rank of phase 27's check: the seeded blocks of ``cfg`` stepped
    over ``batches``; each step's metrics, milliseconds, launches and
    collectives (counted from 0 just before the step), the leaves held
    whole compared across the ranks after it, and, after the last, the
    largest share of ``LM_TOL[bf16]`` between this rank's parameter and
    moment blocks and one card's (``ref``, read where one card keeps
    them)."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import tp_mesh
    from repro_torch.models.common import Topo
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.step import init_state, make_train_step
    dev = group.device
    run_cfg = tp_train_run_cfg(len(batches))
    model = build_model(cfg, Topo(tp_mesh(group.size)), "train", device=dev,
                        group=group)
    gen = torch.Generator(device=dev)
    gen.manual_seed(run_cfg.seed)
    state = init_state(model, run_cfg, gen)
    step = make_train_step(model, run_cfg)
    cut = set(model.cut_params())
    whole = [n for n in state["params"] if n not in cut]
    out = dict(rank=group.rank, losses=[], norms=[], ms=[], launches=[],
               collectives=[], whole_equal=[])
    for b in batches:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        sync(dev)
        group.reset_counts()
        build.reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(dict(build.LAUNCHES))
        out["collectives"].append(collective_counts(group))
        out["losses"].append(loss)
        out["norms"].append(float(m["grad_norm"]))
        out["whole_equal"].append(tp_whole_leaves_equal(
            group, [t for n in whole for t in (
                state["params"][n], state["opt"]["m"][n],
                state["opt"]["v"][n])]))
    blocks, tol = model.blocks(), LM_TOL[torch.bfloat16]
    share = {"params": 0.0, "moments": 0.0}
    for n, p in state["params"].items():
        for key, got, want in zip(("params", "moments", "moments"),
                                  (p, state["opt"]["m"][n],
                                   state["opt"]["v"][n]), ref[n]):
            w = want[blocks[n]].to(dev, torch.float32)
            s = float(((got.detach().float() - w).abs()
                       / (tol["atol"] + tol["rtol"] * w.abs())).max())
            share[key] = max(share[key], s)
    out["share_of_tol"] = share
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 \
        if dev.type == "cuda" else None
    return out


def tp_train_resume(group, cfg, shape: tuple, steps: int,
                    directory: str | None) -> dict:
    """A rank of phase 27's resume: a ``Trainer`` over the (1, tp) mesh
    from ``directory``'s latest checkpoint (or the seeded init) to
    ``steps``, checkpointing every ``TP_RESUME_AT`` steps."""
    from repro_torch.launch.mesh import tp_mesh
    from repro_torch.models.common import Topo
    from repro_torch.train import Trainer
    trainer = Trainer(cfg, tp_train_shape(*shape),
                      tp_train_run_cfg(steps, directory),
                      Topo(tp_mesh(group.size)), device=group.device,
                      group=group)
    t0 = time.perf_counter()
    res = trainer.run(num_steps=steps)
    return dict(losses=res.losses, restored_from=res.restored_from,
                final_step=res.final_step, seconds=time.perf_counter() - t0)


def tp_train_whole(group, cfg, shape: tuple, steps: int) -> dict:
    """A rank of phase 27's whole models: ``launch.train``'s rank
    (``train_rank``: a ``Trainer`` over the (1, tp) mesh, no checkpoints),
    its launches counted from 0 just before and its peak memory."""
    from repro_torch.kernels import build
    from repro_torch.launch.train import train_rank
    dev = group.device
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    res = train_rank(group, cfg, tp_train_shape(*shape),
                     tp_train_run_cfg(steps), steps)
    res.update(launches=dict(build.LAUNCHES),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return res


def tp_train_rank(group, jobs: list) -> list:
    """Phase 27's jobs on one rank, in order (every rank runs the same),
    the card's cache released after each."""
    import gc
    out = []
    for kind, *args in jobs:
        fn = {"check": tp_train_check, "resume": tp_train_resume,
              "whole": tp_train_whole}[kind]
        out.append(fn(group, *args))
        gc.collect()
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def tp_train_phase(dev, card: str, workdir: str) -> dict:
    """Phase 27: glm4-9b and falcon-mamba-7b trained over a (1, 4) mesh.
    With 4 cards or more, 4 NCCL processes (one a card); with fewer, 4
    gloo processes sharing the cards there are (threads cannot run
    backward passes on one card together), the whole models skipped.
    (a) The check models (2 layers each, seeded as one card seeds them)
    held to the unsharded model on one card for 3 steps at 4 x 1024: each
    step's loss within rtol 2e-3 and grad norm within rtol 2e-2, every
    rank's parameter and moment blocks after the last step within
    ``LM_TOL[bf16]``, the leaves held whole bitwise equal on all ranks
    after every step, each rank's launches a step those of one card
    (``train_launches_of``) and its collectives a step the meta count
    (``tp_train_counts``).  (b) With 4 cards, both whole, 3 steps through
    ``launch.train.train_rank``: finite losses, launches, step ms, tokens/s
    and each rank's peak.  (c) falcon-mamba-7b's check model: 4 steps, 2
    with a checkpoint at step 2, and a fresh spawn resumed from it (steps
    3-4 within rtol 1e-5 of the uninterrupted run); the directory removed
    after."""
    import gc
    from repro_torch.configs import ARCHS
    from repro_torch.models.parallel import spawn
    t_phase = time.perf_counter()
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    nccl = n >= TP
    backend = "nccl" if nccl else "gloo"
    devices = None if nccl else [str(dev)]
    group = "nccl, one process a card" if nccl else \
        f"gloo, {TP} processes on {max(n, 1)} {dev.type} device(s)"
    log(f"phase 27 (tensor-parallel training, tp = {TP}): "
        f"torch.cuda.device_count() = {n}; group: {group}")
    b, s = TP_TRAIN_SHAPE
    jobs, checks = [], {}
    for arch in TP_TRAIN_ARCHS:
        cfg = dataclasses.replace(ARCHS[arch],
                                  num_layers=TP_TRAIN_CHECK_LAYERS)
        batches = tp_train_batches(cfg, TP_TRAIN_STEPS)
        t0 = time.perf_counter()
        counts = tp_train_counts(cfg)
        count_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = tp_train_one_card(dev, cfg, batches)
        gc.collect()                    # keep one card's final state only
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks[arch] = dict(cfg=cfg, counts=counts, one=one,
                            count_s=count_s,
                            one_card_s=time.perf_counter() - t0)
        jobs.append(("check", cfg, batches, one["final"]))
    mamba = dataclasses.replace(ARCHS[MAMBA],
                                num_layers=TP_TRAIN_CHECK_LAYERS)
    directory = os.path.join(workdir, "tp_resume")
    jobs += [("resume", mamba, TP_TRAIN_SHAPE, TP_RESUME_STEPS, None),
             ("resume", mamba, TP_TRAIN_SHAPE, TP_RESUME_AT, directory)]
    # the second spawn: the resume, then (4 cards) the whole models, after
    # one card's final states are released
    second = [("resume", mamba, TP_TRAIN_SHAPE, TP_RESUME_STEPS, directory)]
    if nccl:
        second += [("whole", ARCHS[arch], TP_TRAIN_SHAPE, TP_TRAIN_STEPS)
                  for arch in TP_TRAIN_ARCHS]
    else:
        log(f"fewer than {TP} cards: the whole glm4-9b and falcon-mamba-7b "
            f"(~28 GB and ~22 GB of train state a rank) are not trained; "
            f"the check models and the resume run on {TP} gloo processes "
            f"sharing the card(s)")
    t0 = time.perf_counter()
    ranks = spawn(tp_train_rank, TP, backend, timeout=900.0, args=(jobs,),
                  devices=devices)
    ranks_s = time.perf_counter() - t0
    for arch in TP_TRAIN_ARCHS:          # release one card's final states
        checks[arch]["one"].pop("final")
    jobs.clear()
    gc.collect()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed = spawn(tp_train_rank, TP, backend, timeout=900.0,
                    args=(second,), devices=devices)
    resume_s = time.perf_counter() - t0
    shutil.rmtree(directory, ignore_errors=True)
    out = dict(device_count=n, group=group, tp=TP, shape=list(TP_TRAIN_SHAPE),
               ranks_s=ranks_s, second_spawn_s=resume_s, check={},
               whole={})
    for i, arch in enumerate(TP_TRAIN_ARCHS):
        c = checks[arch]
        cfg, one = c["cfg"], c["one"]
        got = [r[i] for r in ranks]
        want_launches = train_launches_of(cfg)
        for r in got:
            for step, (loss, norm) in enumerate(zip(r["losses"],
                                                    r["norms"])):
                if not np.isclose(loss, one["losses"][step], rtol=2e-3,
                                  atol=0):
                    raise AssertionError(
                        f"{arch} rank {r['rank']} step {step + 1}: loss "
                        f"{loss} vs one card {one['losses'][step]}")
                if not np.isclose(norm, one["norms"][step], rtol=2e-2,
                                  atol=0):
                    raise AssertionError(
                        f"{arch} rank {r['rank']} step {step + 1}: grad "
                        f"norm {norm} vs one card {one['norms'][step]}")
            for step, launches in enumerate(r["launches"]):
                if dev.type == "cuda" and launches != want_launches:
                    raise AssertionError(
                        f"{arch} rank {r['rank']} step {step + 1}: launches"
                        f" {launches}, the model dictates {want_launches}")
            for step, counts in enumerate(r["collectives"]):
                if counts != c["counts"]:
                    raise AssertionError(
                        f"{arch} rank {r['rank']} step {step + 1}: "
                        f"collectives {counts}, meta counts {c['counts']}")
            if not all(r["whole_equal"]):
                raise AssertionError(f"{arch} rank {r['rank']}: the leaves "
                                     f"held whole differ across the ranks "
                                     f"after steps {r['whole_equal']}")
            worst = max(r["share_of_tol"].values())
            if worst > 1.0:
                raise AssertionError(
                    f"{arch} rank {r['rank']}: blocks after step "
                    f"{TP_TRAIN_STEPS} at {r['share_of_tol']} of "
                    f"LM_TOL[bf16]")
        if any(r["losses"] != got[0]["losses"] for r in got):
            raise AssertionError(f"{arch}: the ranks' losses differ")
        ms = [x for r in got for x in r["ms"][1:]]
        out["check"][arch] = dict(
            layers=cfg.num_layers, params=cfg.param_count(),
            one_card=one, losses=got[0]["losses"], norms=got[0]["norms"],
            share_of_tol=[r["share_of_tol"] for r in got],
            launches_per_step=got[0]["launches"][0],
            collectives_per_step=got[0]["collectives"][0],
            step_ms=[r["ms"] for r in got],
            peak_gib=[r["peak_gib"] for r in got],
            meta_count_s=c["count_s"], one_card_s=c["one_card_s"])
        log(f"tp = {TP} vs one card [{card}]: {arch} on {cfg.num_layers} of "
            f"{ARCHS[arch].num_layers} layers ({cfg.param_count() / 1e9:.3f}"
            f" B), {b} x {s}, {TP_TRAIN_STEPS} steps: losses "
            f"{[round(x, 5) for x in got[0]['losses']]} (one card "
            f"{[round(x, 5) for x in one['losses']]}), grad norms "
            f"{[round(x, 4) for x in got[0]['norms']]} (one card "
            f"{[round(x, 4) for x in one['norms']]}); blocks after the last "
            f"step within {max(max(r['share_of_tol'].values()) for r in got):.3f}"
            f" of LM_TOL[bf16]; leaves held whole bitwise equal on the "
            f"{TP} ranks after every step; launches a step and rank "
            f"{json.dumps({k: v for k, v in want_launches.items() if v})}")
        log(f"  collectives a step and rank [{card}] (calls, bytes), equal "
            f"to the meta count: {json.dumps(c['counts'])}; step "
            f"{float(np.median(ms)) if ms else float('nan'):.1f} ms "
            f"(median of steps 2-, {min(ms, default=0):.1f}-"
            f"{max(ms, default=0):.1f}; {group}), peak "
            f"{[None if r['peak_gib'] is None else round(r['peak_gib'], 3) for r in got]}"
            f" GiB a rank")
    k = len(TP_TRAIN_ARCHS)
    whole_run = ranks[0][k]
    first = ranks[0][k + 1]
    again = resumed[0][0]
    if again["restored_from"] != TP_RESUME_AT:
        raise AssertionError(f"resumed from {again['restored_from']}")
    for what, a, w in (
            ("steps 1-2", first["losses"], whole_run["losses"][:TP_RESUME_AT]),
            ("resumed steps 3-4", again["losses"],
             whole_run["losses"][TP_RESUME_AT:])):
        if not np.allclose(a, w, rtol=1e-5, atol=0):
            raise AssertionError(f"tp = {TP} {what} {a} vs uninterrupted {w}")
    out["resume"] = dict(
        arch=MAMBA, layers=TP_TRAIN_CHECK_LAYERS, losses=whole_run["losses"],
        first=first["losses"], resumed=again["losses"],
        bitwise=first["losses"] + again["losses"] == whole_run["losses"],
        seconds=[whole_run["seconds"], first["seconds"], again["seconds"]])
    log(f"resume over {TP} ranks from step {TP_RESUME_AT} in a fresh spawn "
        f"[{card}]: {MAMBA} on {TP_TRAIN_CHECK_LAYERS} layers, steps 3-4 "
        f"within rtol 1e-5 of the uninterrupted run, "
        f"{'bit for bit' if out['resume']['bitwise'] else 'not bit for bit'}")
    if nccl:
        for i, arch in enumerate(TP_TRAIN_ARCHS):
            got = [r[1 + i] for r in resumed]
            cfg = ARCHS[arch]
            for r in got:
                if not all(np.isfinite(r["losses"])):
                    raise AssertionError(f"{arch} whole: losses "
                                         f"{r['losses']}")
                want = {key: v * r["steps_run"] for key, v in
                        train_launches_of(cfg).items()}
                if r["launches"] != want:
                    raise AssertionError(f"{arch} whole on {r['device']}: "
                                         f"launches {r['launches']}, the "
                                         f"model dictates {want}")
            durations = [d * 1e3 for d in got[0]["step_durations"][1:]]
            step_ms = float(np.median(durations))
            out["whole"][arch] = dict(
                layers=cfg.num_layers, params=cfg.param_count(),
                losses=got[0]["losses"],
                step_ms_all=[[d * 1e3 for d in r["step_durations"]]
                             for r in got],
                step_ms=step_ms, tokens_per_s=b * s / step_ms * 1e3,
                peak_gib=[r["peak_gib"] for r in got],
                launches_per_step={key: v // got[0]["steps_run"] for key, v
                                   in got[0]["launches"].items()})
            log(f"{arch} whole ({cfg.num_layers} layers, "
                f"{cfg.param_count() / 1e9:.3f} B) over {TP} NCCL cards "
                f"[{card}], {b} x {s}, {TP_TRAIN_STEPS} steps: losses "
                f"{[round(x, 4) for x in got[0]['losses']]}, step "
                f"{step_ms:.1f} ms (median of steps 2-; "
                f"{min(durations):.1f}-{max(durations):.1f}), "
                f"{b * s / step_ms * 1e3:.0f} tokens/s, peak "
                f"{[round(r['peak_gib'], 3) for r in got]} GiB a rank; "
                f"launches a step and rank "
                f"{json.dumps({key: v for key, v in out['whole'][arch]['launches_per_step'].items() if v})}")
    else:
        log(f"phase 27 (b) skipped: {n} card(s), the whole models need "
            f"{TP}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 27 (tensor-parallel training): {out['seconds']:.3f} s "
        f"[{card}]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="one more fleet drive, one more request of each "
                         "served model and one train step under "
                         "torch.profiler")
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json / trace_summary.txt")
    ap.add_argument("--ssm-kernel-only", action="store_true",
                    help="build the kernels and run phase 9 alone (checks, "
                         "timings, ssm_scan's ptxas and SASS report); "
                         "prints no result line")
    ap.add_argument("--fleet-kernels-only", action="store_true",
                    help="build the kernels and run phase 3 alone (checks, "
                         "timings, the builder commit and its device ops, "
                         "the divide diagnostic); prints no result line")
    ap.add_argument("--lm-kernels-only", action="store_true",
                    help="build the kernels and run phase 6 alone (checks, "
                         "timings, the flash library's ptxas and SASS "
                         "report); prints no result line")
    ap.add_argument("--session-only", action="store_true",
                    help="build the kernels and the 28-workload library and "
                         "run phase 12 alone (the session path); prints no "
                         "result line")
    ap.add_argument("--discovery-only", action="store_true",
                    help="build the kernels and the 28-workload library and "
                         "run phases 13 and 16 alone (discovery, K-Means, "
                         "holdout, baselines; the paper's remaining "
                         "tables); prints no result line")
    ap.add_argument("--moe-only", action="store_true",
                    help="build the kernels and run phases 14 and 15 alone "
                         "(MoE, MLA and hybrid models card vs host; "
                         "granite-moe and 4-layer deepseek-v2 serving); "
                         "prints no result line")
    ap.add_argument("--cross-only", action="store_true",
                    help="build the kernels and run phases 17 and 18 alone "
                         "(vlm and enc-dec card vs host; full-width "
                         "llama-3.2-vision-11b and whisper-medium "
                         "serving); prints no result line")
    ap.add_argument("--train-only", action="store_true",
                    help="build the kernels and run phases 19 and 20 alone "
                         "(the backward kernels, the reduced models' "
                         "training card vs host, the launcher's Minos cap "
                         "and vlm / whisper / falcon-mamba / jamba smoke "
                         "runs; glm4-9b on 8 layers training and resuming, "
                         "whisper-medium, the vlm on 10 layers and "
                         "falcon-mamba-7b on 8 layers training); prints no "
                         "result line")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="build the kernels and run phase 21 alone (the "
                         "dry run's meta count of glm4-9b's prefill, decode "
                         "and train steps and falcon-mamba-7b's train step "
                         "held against the card's, and their roofline); "
                         "prints no result line")
    ap.add_argument("--tail-only", action="store_true",
                    help="build the kernels and run phase 22 alone (the "
                         "port's lint over the tree, the four _torch "
                         "examples on the card and the host, the seed "
                         "loops against the kernels); prints no result "
                         "line")
    ap.add_argument("--tp-only", action="store_true",
                    help="build the kernels and run phases 23-26 alone "
                         "(command-r-35b, jamba-1.5-large-398b, "
                         "deepseek-v2-236b, llama-3.2-vision-11b and "
                         "whisper-medium served over 4 ranks: NCCL "
                         "processes with 4 cards or more, else LocalGroup "
                         "threads; held to one card); prints no result "
                         "line")
    ap.add_argument("--tp-train-only", action="store_true",
                    help="build the kernels and run phase 27 alone "
                         "(glm4-9b and falcon-mamba-7b trained over 4 "
                         "ranks: NCCL processes with 4 cards or more, else "
                         "gloo processes sharing the cards; held to one "
                         "card, resumed from a checkpoint over ranks, the "
                         "whole models on 4 cards); prints no result line")
    ap.add_argument("--recovery-child", metavar="STORE",
                    help=argparse.SUPPRESS)   # phase 12's crash target
    ap.add_argument("--child-device", default="cuda",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.recovery_child:
        recovery_child(args.recovery_child, resolve_device(args.child_device))
        return 1                              # unreachable: SIGKILL
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from repro_torch.kernels import build
    shutil.rmtree(build.build_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"(every source in parallel, nvcc sm_90a) [{card}]")
    for key, report in build.BUILD_INFO.items():
        if key.endswith("_ptxas"):      # registers / smem / spills per kernel
            for line in str(report).splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  {key[:-6]}: {line.strip()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False

    if args.fleet_kernels_only:
        kp = kernel_phase(dev, flush)
        kp["builder_commit_ops"] = builder_commit_ops(dev, card)
        kp["ema_call_ops"] = ema_call_ops(dev, card)
        if args.out is not None:
            with open(os.path.join(args.out, "fleet_kernels.json"), "w") as f:
                json.dump({"card": card, "fleet_kernels": kp}, f, indent=1)
        log("phase 3 alone (--fleet-kernels-only): no result line")
        return 0
    if args.lm_kernels_only:
        lp = lm_kernel_phase(dev, flush, card)
        if args.out is not None:
            with open(os.path.join(args.out, "lm_kernels.json"), "w") as f:
                json.dump({"card": card, "lm_kernels": lp}, f, indent=1)
        log("phase 6 alone (--lm-kernels-only): no result line")
        return 0
    if args.ssm_kernel_only:
        ssp = ssm_kernel_phase(dev, flush, card)
        if args.out is not None:
            with open(os.path.join(args.out, "ssm_kernel.json"), "w") as f:
                json.dump({"card": card, "ssm_kernel": ssp}, f, indent=1)
        log("phase 9 alone (--ssm-kernel-only): no result line")
        return 0
    if args.moe_only:
        moe = dict(card_vs_host=moe_card_vs_host_phase(dev, card),
                   serve=moe_serve_phase(dev, card, args.out, args.trace))
        if args.out is not None:
            with open(os.path.join(args.out, "moe.json"), "w") as f:
                json.dump({"card": card, "moe": moe}, f, indent=1)
        log("phases 14 and 15 alone (--moe-only): no result line")
        return 0
    if args.cross_only:
        cross = dict(card_vs_host=cross_card_vs_host_phase(dev, card),
                     serve=cross_serve_phase(dev, card, args.out,
                                             args.trace))
        if args.out is not None:
            with open(os.path.join(args.out, "cross.json"), "w") as f:
                json.dump({"card": card, "cross": cross}, f, indent=1)
        log("phases 17 and 18 alone (--cross-only): no result line")
        return 0
    if args.tp_only:
        tp = tp_phases(dev, card)
        if args.out is not None:
            with open(os.path.join(args.out, "tp.json"), "w") as f:
                json.dump(dict(card=card, **tp), f, indent=1)
        log("phases 23-26 alone (--tp-only): no result line")
        return 0
    if args.dryrun_only:
        dry = dryrun_phase(dev, card)
        if args.out is not None:
            with open(os.path.join(args.out, "dryrun.json"), "w") as f:
                json.dump({"card": card, "dryrun": dry}, f, indent=1)
        log("phase 21 alone (--dryrun-only): no result line")
        return 0
    workdir = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        if args.train_only:
            train = dict(check=train_check_phase(dev, flush, card, workdir),
                         full=train_full_phase(dev, card, workdir))
            if args.trace:
                train["trace"] = trace_train(dev, card, args.out)
                train["trace_whisper"] = trace_train(dev, card, args.out,
                                                     WHISPER)
                train["trace_mamba"] = trace_train(dev, card, args.out,
                                                   MAMBA)
            if args.out is not None:
                with open(os.path.join(args.out, "train.json"), "w") as f:
                    json.dump({"card": card, "train": train}, f, indent=1)
            log("phases 19 and 20 alone (--train-only): no result line")
            return 0
        if args.tp_train_only:
            tpt = tp_train_phase(dev, card, workdir)
            if args.out is not None:
                with open(os.path.join(args.out, "tp_train.json"), "w") as f:
                    json.dump({"card": card, "tp_train": tpt}, f, indent=1)
            log("phase 27 alone (--tp-train-only): no result line")
            return 0
        if args.tail_only:
            tail = tail_phase(dev, card, workdir)
            if args.out is not None:
                with open(os.path.join(args.out, "tail.json"), "w") as f:
                    json.dump({"card": card, "tail": tail}, f, indent=1)
            log("phase 22 alone (--tail-only): no result line")
            return 0
        return run_phases(args, dev, card, kind, flush, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_phases(args, dev, card: str, kind: str, flush: torch.Tensor,
               workdir: str) -> int:
    """Phases 3-27 (the whole run, or phase 12 alone or phases 13 and 16
    with ``--session-only`` / ``--discovery-only``); prints the result
    lines."""
    from repro_torch.configs import ARCHS
    with open(os.path.join(ROOT, "results", "fleet_scale.json")) as f:
        want = json.load(f)
    if args.session_only or args.discovery_only:
        from repro_torch.pipeline import build_reference_library
        from repro_torch.telemetry import TPUPowerModel
        lib = build_reference_library(TPUPowerModel(), target_duration=3.0,
                                      device=dev)
        if args.session_only:
            name, phase = "session", session_phase(dev, card, lib, want,
                                                   workdir)
            phase.pop("plain_state")
        else:
            name, phase = "discovery", discovery_phase(dev, card, lib, want,
                                                       workdir)
            phase["tables"] = tables_phase(dev, card, lib)
        if args.out is not None:
            with open(os.path.join(args.out, f"{name}.json"), "w") as f:
                json.dump({"card": card, name: phase}, f, indent=1)
        log(f"phase {12 if args.session_only else '13 and 16'} alone "
            f"(--{name}-only): no result line")
        return 0
    kp = kernel_phase(dev, flush)
    # the first profiler session of the process: a later one (after the
    # serving traces) recorded no device activity for these small launches
    commit_ops = builder_commit_ops(dev, card) if args.trace else None
    ema_ops = ema_call_ops(dev, card) if args.trace else None
    lp = lm_kernel_phase(dev, flush, card)
    ssp = ssm_kernel_phase(dev, flush, card)
    card_vs_host_phase(dev)
    lm_card_vs_host_phase(dev)
    mamba_card_vs_host_phase(dev)
    lib, mp = main_path(dev, want)
    log(f"fleet timings [{card}]: library {mp['library_s']:.3f} s, admit "
        f"{mp['admit_s']:.3f} s, run {mp['run_s']:.3f} s (of it: engine "
        f"per-row loop {mp['row_loop_s']:.3f} s, packing "
        f"{mp['repack_s']:.3f} s), {mp['jobs_per_s']:.1f} jobs/s, ground "
        f"truth {mp['truth_s']:.3f} s")
    ses = session_phase(dev, card, lib, want, workdir)
    log(f"session vs direct controller [{card}]: 10,000 jobs at "
        f"{ses['scale']['plain']['jobs_per_s']:.1f} jobs/s (no journal), "
        f"{ses['scale']['journal']['jobs_per_s']:.1f} jobs/s (journal), "
        f"phase 5's controller {mp['jobs_per_s']:.1f} jobs/s")
    dis = discovery_phase(dev, card, lib, want, workdir,
                          ses.pop("plain_state"))
    log(f"quarantine on vs off [{card}]: 10,000 jobs at "
        f"{dis['scale_quarantine']['jobs_per_s']:.1f} jobs/s with "
        f"discovery=True, {ses['scale']['plain']['jobs_per_s']:.1f} without")
    tab = tables_phase(dev, card, lib)
    sp = serve_phase(dev, card, ARCHS[GLM], REQUESTS, attn_launches,
                     args.out, args.trace)
    torch.cuda.empty_cache()        # the glm4-9b engine is gone: release it
    msp = serve_phase(dev, card, ARCHS[MAMBA], MAMBA_REQUESTS,
                      mamba_launches, args.out, args.trace)
    torch.cuda.empty_cache()        # the falcon-mamba-7b engine is gone too
    moe_host = moe_card_vs_host_phase(dev, card)
    moe_sp = moe_serve_phase(dev, card, args.out, args.trace)
    cross_host = cross_card_vs_host_phase(dev, card)
    cross_sp = cross_serve_phase(dev, card, args.out, args.trace)
    torch.cuda.empty_cache()        # the vlm and whisper engines are gone
    train = dict(check=train_check_phase(dev, flush, card, workdir),
                 full=train_full_phase(dev, card, workdir))
    if args.trace:
        train["trace"] = trace_train(dev, card, args.out)
        train["trace_whisper"] = trace_train(dev, card, args.out, WHISPER)
        train["trace_mamba"] = trace_train(dev, card, args.out, MAMBA)
    dry = dryrun_phase(dev, card)
    tail = tail_phase(dev, card, workdir)
    torch.cuda.empty_cache()
    tps = tp_phases(dev, card)
    tpt = tp_train_phase(dev, card, workdir)

    # kernel records: bounds from this run's inputs
    sh = kp["spike_hist"]
    rows, cols = sh["shape"]
    hist = hist_work(rows, cols, 8, len(BINS),
                     sum(int(round(1.5 / c)) for c in BINS), sh["n_spike"])
    hist_bytes = hist["bytes"]
    hist_bound = max(hist_bytes / HBM_BYTES_PER_S,
                     hist["flops"] / PEAK_OPS["f64"]) * 1e3
    ema_n = mp["ema_n"]               # the main path's median trace length
    t_ema, t_ema_plain, err_ema = time_ema(dev, flush, ema_n)
    ema = ema_rows_work(1, ema_n)
    ema_bound = max(ema["bytes"] / HBM_BYTES_PER_S,
                    ema["flops"] / PEAK_OPS["f32"]) * 1e3
    eb = kp["ema_blocks"]             # the engine's group advance leads
    kernels = [
        {"name": "spike_hist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spike_hist.cu",
         "replaces": "src/repro/kernels/spike_hist.py:92",
         "launches": mp["launches"]["spike_hist"], "max_abs_err": sh["err"],
         "ms": sh["ms"], "plain_ms": sh["plain_ms"], "bound_ms": hist_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "ema_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ema_scan.cu",
         "replaces": "src/repro/kernels/ema_scan.py:49",
         "launches": mp["launches"]["ema_scan"],
         "max_abs_err": max(kp["ema_scan"]["err"], err_ema),
         "ms": eb["group"]["ms"], "plain_ms": eb["group"]["plain_ms"],
         "bound_ms": eb["group"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": eb["group"]["shape"],
         "launches_by_stage": mp["ema_launches"],
         "shapes": [dict(form=k, **{f: eb[k][f] for f in
                                    ("shape", "ms", "composed_ms", "plain_ms",
                                     "bound_ms")})
                    for k in ("group", "snapshot", "ingest")],
         "f32": {"n": ema_n, "ms": t_ema, "plain_ms": t_ema_plain,
                 "bound_ms": ema_bound}},
    ]
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:68"),
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:18")):
        r = lp[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": sp["launches"][name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for rec in kernels[:2]:      # phases 12 and 13's parts, counted apart
        rec["launches_session"] = {part: n[rec["name"]] for part, n in
                                   ses["launches"].items()}
        rec["launches_session"].update(
            {f"discovery_{part}": n[rec["name"]]
             for part, n in dis["launches"].items()})
        rec["launches_tables"] = tab["launches"][rec["name"]]
    kernels[2]["shapes"] = [            # flash at every timed prefill shape
        {k: r[k] for k in ("b", "s", "skv", "H", "KV", "dh", "causal",
                           "dtype", "ms", "library_ms", "bound_ms",
                           "bound_by", "plain_ms") if k in r}
        for r in lp["flash_attention"]["shapes"]]
    pre = ssp["prefill"]              # the first request's prefill scan
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:51",
        "launches": msp["launches"]["ssm_scan"],
        "max_abs_err": max(ssp["err"], lp["ssm_scan_tp"]["err"]),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None})
    for rec in kernels[2:]:      # phase 15's two models, and phase 14's
        rec["launches_moe_serving"] = {
            f"{arch} ({moe_sp[arch]['num_layers']} layers)":
            moe_sp[arch]["launches"][rec["name"]]
            for arch in (GRANITE, DEEPSEEK)}
        rec["launches_moe_card_vs_host"] = {
            k: v["launches"][rec["name"]] for k, v in moe_host.items()
            if k != "seconds"}
        rec["launches_cross_serving"] = {
            arch: cross_sp[arch]["launches"][rec["name"]]
            for arch in (VLM, WHISPER)}
        rec["launches_cross_card_vs_host"] = {
            k: v["launches"][rec["name"]] for k, v in cross_host.items()
            if k != "seconds"}
    # the training path (phase 20's uninterrupted 4 x 1024 run is its main
    # path; the backward kernels replace no TPU kernel: "replaces" names
    # the Pallas forward whose gradient each computes)
    main_train = train["full"]["runs"][0]       # 8 layers, 4 x 1024
    cross_train = {r["arch"]: r for r in train["full"]["cross"]}
    ssm_train = train["full"]["ssm"][0]         # falcon-mamba-7b, 8 layers
    for rec in kernels[2:4]:
        rec["launches_training"] = main_train["launches"][rec["name"]]
        rec["launches_cross_training"] = {
            arch: r["launches"][rec["name"]] for arch, r in
            cross_train.items()}
    for rec in kernels[3:5]:          # rmsnorm and ssm_scan on its path
        rec["launches_ssm_training"] = ssm_train["launches"][rec["name"]]
    tk = train["check"]["kernels"]
    kernels[2]["lse"] = {k: tk["flash"][0][k] for k in
                         ("fwd_lse_ms", "fwd_ms", "lse_err")}
    fb = tk["flash"][0]
    nb = next(r for r in tk["rmsnorm"] if "ms" in r)
    for name, replaces, r, errs in (
            ("flash_attention_bwd", "src/repro/kernels/flash_attention.py:68",
             fb, tk["flash"]),
            ("rmsnorm_bwd", "src/repro/kernels/rmsnorm.py:18", nb,
             tk["rmsnorm"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      + ("flash_attention_bwd.cu" if name.startswith("flash")
                         else "rmsnorm.cu"),
            "replaces": replaces, "gradient_of": replaces,
            "launches": main_train["launches"][name],
            "max_abs_err": max(r2["err"] for r2 in errs), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_call": "forward + backward through autograd",
            "fwd_bwd_ms": r["fwd_bwd_ms"],
            "launches_cross_training": {
                arch: rc["launches"][name]
                for arch, rc in cross_train.items()}})
    kernels[-2]["shapes"] = [
        {k: r[k] for k in ("b", "s", "skv", "H", "KV", "dh", "causal",
                           "dtype", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms",
                           "fwd_bwd_ms", "fwd_lse_ms", "fwd_ms", "kernel",
                           "split", "dkdv_ctas", "dq_ctas") if k in r}
        for r in tk["flash"] if "ms" in r]
    kernels[-1]["shapes"] = [
        {k: r[k] for k in ("n", "d", "dtype", "scale_dtype", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms",
                           "fwd_bwd_ms", "add_ms", "plan")}
        for r in tk["rmsnorm"] if "ms" in r]
    kernels[-1]["launches_ssm_training"] = \
        ssm_train["launches"]["rmsnorm_bwd"]
    # the scan's backward: its main path is phase 20's falcon-mamba-7b run;
    # timed at that path's shape (bf16 x, float32 dt, no D, h0 or dh_last)
    sb = tk["ssm_scan"][0]
    kernels.append({
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:51",
        "gradient_of": "src/repro/kernels/ssm_scan.py:51",
        "launches": ssm_train["launches"]["ssm_scan_bwd"],
        "max_abs_err": max(r["err"] for r in tk["ssm_scan"]),
        "max_err_of_scale": max(r["err_scaled"] for r in tk["ssm_scan"]),
        "ms": sb["ms"], "plain_ms": sb["plain_ms"],
        "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"],
        "library_ms": None,
        "shapes": [{k: r[k] for k in ("b", "s", "di", "ds", "lanes",
                                      "dtype", "dt_dtype", "ms",
                                      "plain_ms", "bound_ms", "bound_by")}
                   for r in tk["ssm_scan"] if "ms" in r]})
    for rec in kernels:               # phase 22's LM examples
        rec["launches_lm_examples"] = {
            "serve_lm_torch, 10 reduced archs":
            tail["serve_lm"]["launches"][rec["name"]],
            f"train_lm_torch, {LM_TRAIN_STEPS} steps":
            tail["train_lm"]["launches"][rec["name"]],
            "train_lm_torch, Minos part":
            tail["train_lm"]["minos_launches"][rec["name"]]}
    for rec in kernels[2:5]:     # phases 23-26's ranks, counted apart
        for key, phs in (("launches_tp_serving", [tps["tp"]]),
                         ("launches_tp_hybrid_serving", [tps["tp_hybrid"]]),
                         ("launches_tp_mla_serving", [tps["tp_mla"]]),
                         ("launches_tp_cross_serving",
                          list(tps["tp_cross"].values()))):
            rec[key] = {
                f"{ph['arch']} rank {r} "
                f"({ph['ranks'][r]['serve']['num_layers']} layers)":
                ph["ranks"][r]["serve"]["launches"][rec["name"]]
                for ph in phs for r in range(len(ph["ranks"]))}
    for rec in kernels[2:]:      # phase 27's check models, a rank's step
        rec["launches_tp_training"] = {
            f"{arch} rank ({c['layers']} layers), a step":
            c["launches_per_step"][rec["name"]]
            for arch, c in tpt["check"].items()}
        rec["launches_tp_training"].update({
            f"{arch} rank ({c['layers']} layers, 4 NCCL cards), a step":
            c["launches_per_step"][rec["name"]]
            for arch, c in tpt["whole"].items()})
    for rec in kernels:               # phase 21's card steps
        rec["launches_dryrun"] = {
            f"{c['arch']} {c['kind']}": c["launches"].get(rec["name"], 0)
            for c in dry["cells"]}
    log(f"spike_hist f64 {rows}x{cols}, 6 bin sizes [{card}]: kernel "
        f"{sh['ms']:.4f} ms (L2 flushed; {sh['warm_ms']:.4f} ms warm), plain "
        f"{sh['plain_ms']:.4f} ms, bound {hist_bound:.4f} ms "
        f"({hist_bytes} B)")
    log(f"ema_scan f32 n={ema_n} [{card}]: kernel {t_ema:.4f} ms, plain "
        f"{t_ema_plain:.4f} ms, bound {ema_bound:.6f} ms")
    for k in ("group", "snapshot", "ingest"):
        log(f"ema_scan f64 blocks, {k} {eb[k]['shape']} [{card}]: kernel "
            f"{eb[k]['ms']:.4f} ms, old composition {eb[k]['composed_ms']:.4f}"
            f" ms, bound {eb[k]['bound_ms']:.6f} ms")
    fleet_trace = dict(trace_phase(lib, dev, card, args.out),
                       builder_commit=commit_ops,
                       ema_call_ops=ema_ops) if args.trace else None
    if args.out is not None:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "kernels": kernels, "main_path": mp,
                       "session": ses, "discovery": dis, "tables": tab,
                       "fleet_trace": fleet_trace,
                       "lm_kernels": lp, "serve": sp, "ssm_kernel": ssp,
                       "serve_mamba": msp, "moe_card_vs_host": moe_host,
                       "serve_moe": moe_sp, "cross_card_vs_host": cross_host,
                       "serve_cross": cross_sp, "train": train,
                       "dryrun": dry, "tail": tail, **tps,
                       "tp_train": tpt}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
