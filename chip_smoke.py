"""Chip smoke test of the PyTorch/CUDA port: builds the kernels, holds
each against its plain PyTorch version on the card, serves the kernel
ladder end to end at full width, and checks the served students.

  python3 chip_smoke.py            (from the repository root; one GPU)

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and
     print ptxas's registers, static shared memory and spills for each;
  3. each kernel against its plain version on the card — at the serving
     shapes (batch 64 and the smallest bucket, 8, and for the SSD scan
     also 16; inputs captured from the students' own forwards) and at
     the edge cases (flash: window, non-causal, GQA, bf16, head dim 120,
     ragged length; decode: garbage in empty ring slots, a (W,) pos,
     GQA, bf16; SSD: O(1) random inputs at the path shape at buckets 64,
     32, 16 and 8, its tolerance scaled to the plain output's magnitude
     where that is below 1) — with the kernel's, the plain version's
     and, where one PyTorch call computes the same function, that call's
     time, beside the analytic bound.  Every fp32 flash row at head dim
     32 must take the register-tiled ("tiled") variant, the bf16 hd 32
     and fp32 hd 120 rows the scalar ("simt") one, the bf16 hd 120 row
     (h2o-danube-3-4b's head dim) the tensor-core ("tc") one, and one row
     at the path shape forces "simt" so that each variant stays checked; every decode row takes
     the variant ``decode_attention.kernel.select_variant`` names
     ("single" on the cascade's 128 slots, "split" on the zoo's 2048),
     and every SSD row the whole-chunk one ("whole", chunk 64);
  4. ``serve_stream_batched`` on the ``kernel`` ladder (lr ->
     tinytf_flash -> ssm at the default widths), imdb, batch 64, 2048
     items, simulated expert: every kernel's launch count over this run
     must be > 0 and equal the layers x forwards the engine counted, and
     every (fp32) flash launch must have taken the "tiled" variant; the
     flash calls are also counted by padded batch (the engine's bucket);
  5. the served levels' final params: kernel path vs plain path logits
     at batch 64 — same argmax on every row, logits within tolerance;
  5b. default-serve: the paper's own ladder, ``default_cascade_config``
     (lr -> tinytf at ``TinyTFSpec()``: d_model 128, 4 heads, 2 layers,
     d_ff 256, L 128, vocab 4096) on imdb, 2048 items, batch 64: (1)
     ``serve_stream_batched(ladder="default", expert_kind="model")``,
     which trains the d_model-256, 4-layer expert on the card first —
     the expert's training seconds and its accuracy on the stream,
     items/s, accuracy, expert calls, level fractions; every kernel's
     count, set to 0 before, must still be 0 after (the dense students
     run no kernel of the port); (2) Table 1's configuration (mu 2e-7,
     simulated expert) under ``hard_budget=106`` (imdb N = 1300 of
     25 000 scaled to 2048): at most 106 calls and the budget reached;
     (3) 48 items at batch 8 on the card and on the CPU from the same
     seed: identical routing, else the first tick and lane that differ;
  8. engine-matrix: ``BatchedCascadeEngine``'s serving options on imdb,
     2048 items, batch 64, seed 0, mu 3e-7, each run printing items/s,
     wall s, accuracy, expert calls, level fractions, pipeline / commit
     (mean age, age_max) / fault stats: (a) the default ladder with the
     model expert (trained once, reused) at max_delay 2 — every commit
     within 2 ticks, every annotated lane committed exactly once — and
     profiled at max_delay 0 and 2; (b) per-lane commits at max_delay 2,
     simulated expert, W=1 against W=4 under an adversarial latency, on
     an imdb stream of 2560 items (seed 0), resumed from one warm run's
     checkpoint: the default ladder at W=1, saved after every tick until
     the first tick at which students answer some lanes and the expert
     the rest, is restored at the tick T before it (printed) into all
     four engines of (b) and (b'), whose level state must be
     ``torch.equal``; each serves 8 ticks (512 items, as phases 9 (a')
     and 10 (b) take) and fails if no student answered on them
     (``student_routed``, the gate that phase 9 (a') and phase 10's
     served runs also pass): identical predictions, routing, expert calls, commit
     log, every parameter ``torch.equal``; (b') the same pair with the
     model expert, its per-item labels compared on the batches the
     engine sent (failing if none was compared, or none at a shard size
     other than 64 / W) and its pool threads' streams checked, then the
     process backend
     (labels against the thread backend, device memory per child, its
     children killed and the pool rebuilt); (c) the kernel ladder at
     depth 2 against 0, at max_delay 0 (profiled) and 2: identical runs
     and every kernel launched as often as the layer-forwards counted
     (at max_delay 0 as often as in phase 4); (d) hard budget 0 (the
     converged regime) on both ladders, and the default ladder's
     learning regime, depth 2 against 0, profiled (ms per tick, device
     idle share): identical predictions, 32 ticks submitted and
     resolved, and no refetch or fence where converged; (e)
     ``FlakyExpert`` (seeded) over the simulated expert with
     ``expert_timeout``, ``max_requeues=2``, ``autoscale=(1, 8)``:
     every injected timeout or death requeued or counted as dropped, and
     the fleet log equal to the CPU's on the same stream; (f) 48 items
     at batch 8, max_delay 2, per-lane commits, depth 2: routing on the
     card equal to the CPU's;
  9. checkpoint-admission: live-state checkpoints and the admission
     front-end on the kernel ladder at full width (imdb, seed 0, mu 3e-7,
     64 lanes, simulated expert), each run printing items/s, wall s,
     accuracy, expert calls and level fractions, and each of (a), (c) and
     (e) checking every kernel's launches against the layer forwards the
     engine counted: (a) 2048 items uninterrupted, the same with
     ``run(checkpoint_every=16)``, and a fresh engine restored from that
     checkpoint: bitwise the uninterrupted run from tick 16 on
     (predictions, expert calls, every parameter, optimizer leaf and
     ring), at max_delay 0 and at max_delay 2 with depth 2, with the
     checkpoint's bytes (beside those reckoned from the state's shapes)
     and the save and restore ms; (a') per-lane commits at max_delay 2
     with ``SimulatedExpert(workers=4)`` under an adversarial latency,
     512 items cut at tick 4 with a per-lane record caught
     mid-consumption: bitwise; (b) ``lockstep_requests(2048, 64)``
     through ``CascadeFrontEnd``: bitwise the classic run; (c)
     ``poisson_requests(2048, rate=8, mean_len=8, seed=0)`` (about 64
     items offered a tick against 64 lanes): ticks, idle ticks,
     occupancy, time-to-answer p50 / p99, queue delay, goodput, flash
     calls by bucket, and depth 2 identical to depth 0 (admission log,
     records, predictions, parameters); (d) ``burst_requests(2048,
     burst=96, every=8)`` under ``admission="shed", queue_limit=16``: at
     least one request shed, every request answered or shed; (e) (c)'s
     schedule served 16 ticks, the front-end saved, a fresh engine and
     front-end restored and finished: equal to (c); (f) 96 items, 8
     lanes, ``poisson_requests(96, rate=1, mean_len=5, seed=3)`` on the
     card and on the CPU: identical routing and records, else the first
     tick and lane that differ; then the launches over the phase, the
     flash calls by batch and the phase's seconds;
  10. sanitize-distill: the runtime sanitizers
     (``repro_torch.analysis.sanitize``) on the kernel ladder at full
     width (imdb, seed 0, mu 3e-7, 64 lanes, simulated expert), each
     served run's kernel launches counted from zero against its layer
     forwards: (a) determinism traces of 2048 items at depth 0 and depth
     2, ``diff_traces`` None with the state digests; (b) per-lane commits
     at max_delay 2, W=1 against W=4 under an adversarial latency, 512
     items: None; (c) 16 ticks, ``save_state``, a fresh engine restored
     and run to the end: the two segments' ``concat_traces`` equal to
     (a)'s uninterrupted trace; (d) 48 items at batch 8, card against
     CPU: None on every field but the state digests, the per-lane RNG
     digests equal (else the ``Divergence.describe()`` line); (f) under
     ``retrace``, (a)'s depth-0 run: the signatures of each staged
     function beside the launches and the forwards by bucket, at most 4
     per ``route_pass[i]`` and ``retrace_check(limit=16)`` empty; (g)
     items/s with the determinism trace off / on / on / off, and the ms
     and bytes of one tick's state digests; (e) a ``ModelExpert``
     (d_model 256, 4 layers, seeded weights) with a W=4 thread pool under
     ``locks``, per-lane max_delay 2, 512 items: no raise, 0 order
     violations; a bare ``ExpertTicket._shards`` read must raise
     ``LockSanitizerError``; (h) ``distill_students`` on the card at
     ``TinyTFSpec()`` widths, imdb, 2048 items, simulated expert, 3
     epochs, budgets 106 and 1024: lr and tinytf accuracy and recall,
     seconds, beside the cascade's accuracy from (a) on the same test
     half; then 48 items on the card and the CPU: accuracies within one
     test item;
  6. zoo-kernels: Mixtral-8x22B at full width (d_model 6144, 48/8 heads
     of 128, 8 experts of d_ff 16384, bf16), depth cut to 2 layers,
     weights from a seeded CUDA generator; prompts from
     ``lm_batches(seed=0)``, 2 x 2048 tokens.  The inputs each kernel
     gets in layer 0 (prefill and the first decode step) are captured,
     and each kernel is held against its plain version on them and on
     O(1) random inputs at the same shapes — moe_gmm at C=640 (prefill,
     both projections) and C=4 (decode) on the tensor-core ("tc")
     variant, fp32 rows and the ragged rows whose D or F row is not a
     multiple of 16 bytes (D 777, F 1029 / 1031) on the scalar one, and
     bf16 rows TMA can read on both tc tiles and their boundary (E3 C130
     D1000 F1040, E2 C5 D1000 F1040, E2 C9 D512 F1024, and an odd F 1029
     read through a slice of F 1040); flash at the zoo
     shape and, on the tc variant, bf16 hd 128 at a ragged S = 1000, at
     S = 2048 with a window of 1024, non-causal GQA 6 at S = 512, and hd
     64 at S = 2048; decode attention at the zoo shape, also with 300
     empty slots and with every slot empty ("split") — with tolerances
     scaled by max|plain|, beside their times, the library call's
     (``torch.bmm``, SDPA) and the bf16 bound.  Every row asserts the
     variant it took;
  7. zoo-serve: one prefill of the 2 x 2048 prompts and 16 greedy
     ``decode_step``s through ``repro_torch.models.transformer``: prefill
     ms, decode ms/step, tokens/s, peak device memory, and every zoo
     kernel's launches (counted from zero over this run, equal to what
     the layers, MoE groups and steps imply) and launches by variant
     (every moe_gmm and flash launch must take "tc": 12 / 2 in the
     prefill, 96 / 0 over the 16 decode steps; every decode-attention
     launch "split"); then one more prefill and
     4 decode steps under torch.profiler (device busy time, idle share,
     device time by kernel group).  Then (a) prefill/decode
     consistency at full width (S=256, a capacity that drops no token)
     and (b) card (kernels) vs CPU (plain twins) at the smoke config in
     fp32, from the same weights;
  11. zoo-archs: the zoo's nine other architectures, one at a time, each
     at full width with weights from a seeded CUDA generator and freed
     before the next: internlm2-1.8b (24 layers), h2o-danube-3-4b (24)
     and seamless-m4t-medium (12 encoder + 12 CROSS decoder layers) at
     full depth; mamba2-370m cut to 16 of 48 layers, qwen3-8b to 12 of
     36, llama-3.2-vision-11b to 20 of 40 (4 of them CROSS), llama3-405b
     and dbrx-132b to 2 layers (the script's time limit), and
     jamba-1.5-large-398b cut to the first half of
     its period (MAMBA, MAMBA, MAMBA, ATTN; MoE at 1 and 3; 4 layers: a
     whole period needs about 90 GB).  The CROSS models' memory is the
     reference's modality stub, drawn from a seeded CUDA generator:
     seamless' 2 x 2048 frame embeddings under 2 x 256 decoder tokens
     (the reference's speech-to-text ratio), the vision model's 2 x 1600
     image embeddings beside 2 x 2048 prompts.  Each: a warm-up prefill
     and decode step that captures the SSD / flash / decode-attention
     inputs of each role's first call (flash: causal self-attention,
     the encoder's, cross-attention prefill; decode attention: the
     ring, cross-attention over the memory); one prefill of
     ``lm_batches(seed=0)``'s 2 x 2048 prompts (seamless: 2 x 256) and 16
     greedy decode steps (prefill ms, decode ms/step, peak GB; every
     kernel's launches and variants counted from zero and equal to what
     the layers imply: one SSD scan per MAMBA layer in the prefill, all
     "parallel" (the four chunk-parallel passes), none in decode; one
     flash call per ATTN and encoder layer and two per CROSS layer, all
     "tc" (Danube's head dim 120 too); decode attention (ATTN + 2 CROSS
     layers) x steps, "split"; moe_gmm 3 per group and MoE layer, "tc");
     one more prefill and 2 decode steps under torch.profiler (device
     busy ms, idle share, device time by kernel group); the captured
     inputs held against the plain versions (the SSD scan's
     y and final state, also on O(1) random inputs at the shape, there
     held to the recurrence in float64 per element within 2e-3 x (1 +
     |f64|); and each of its four passes alone against its plain pass on
     the captured inputs, fed the plain outputs of the passes before
     it), with mamba2-370m's and Jamba's SSD, Llama-3-405B's decode
     attention (16 query heads a kv head; also on O(1) random inputs
     with 300 empty slots), Danube's flash prefill, seamless' encoder
     flash and the vision model's cross-attention prefill (flash, Skv
     1600) and decode (every memory slot valid) timed beside the library
     call and the bound; (a) prefill(S) against prefill(S - 1) +
     ``decode_step`` at S = 256 with the same memory, and with MAMBA
     blocks also S = 300 (a chunk and a padded tail), MoE at a no-drop
     capacity; (b) the smoke config in fp32 (the vision model's 16 image
     tokens under 64 decoder tokens: its cross prefill runs "tiled" with
     Skv below one tile), card against CPU from the same weights and
     memory, every kernel the model runs launched; then the phase's
     seconds;
  12. zoo-train: the zoo's training path (``repro_torch.launch.train``)
     on the card, bf16 at published widths, seeded weights, batches from
     ``lm_batches(seed=0)``, one model at a time: internlm2-1.8b (8 of
     24 ATTN layers) and mamba2-370m (8 of 48 MAMBA layers; the script's
     time limit), batch 4 x seq 2048, and mixtral-8x22b cut to 1 of 56
     layers, batch 1 x seq 2048 (one MoE group).  Each: one ``train_loss`` step without and
     one with remat (ms, tokens/s), (a) every parameter leaf's gradient
     finite and present, non-zero upstream of each kernel (``wq`` /
     ``wk`` / ``wv``, ``in_proj``, ``w_in`` / ``w_gate`` / ``w_out``);
     (c) remat on against off: the loss within 1e-6 relative, each leaf
     within 2e-2 in relative l2 norm; (d) each step's launches and
     variants (flash once per ATTN layer a forward, the remat recompute
     again: 24 / 48 "tc"; the SSD 48 / 96 "parallel"; Mixtral flash 1 /
     2 and moe_gmm 3 / 6 "tc"; no decode launch); (b) the remat step with
     the plain twins patched into ``attention.py`` / ``moe.py`` /
     ``ssm.py`` (no kernel launched): in bf16 the loss within 2e-3
     relative, and each leaf of the kernels' gradient no farther from the
     same step's in fp32 (twins) than 1.25 x the bf16 twins' is, + 1e-3
     (relative l2 norms); in fp32 (the kernels' fp32 variants) the loss
     within 1e-5 relative and each leaf within 1e-4; each
     kernel against its plain version on the step's layer-0 inputs,
     timed beside the library call and the bound, and its backward (the
     twin's, through ``kernels.autograd``) timed beside a backward's
     bound; one step (forward, backward, AdamW) under torch.profiler
     (device busy, idle share, device time by group); then
     ``train(steps=8, remat=True)`` with a checkpoint: its launches
     counted from zero over the run (8 x a remat step's), peak GB, ms a
     step, tokens/s; (e) its first loss the remat step's and its last
     below its first; (f) the checkpoint read back bit-exact against the
     parameters ``train`` wrote (recorded by wrapping its
     ``save_checkpoint``);
  13. dryrun: ``repro_torch.launch.dryrun.dryrun_one`` on the card for
     internlm2-1.8b x all four shapes, mamba2-370m x prefill_32k /
     train_4k / decode_32k, mixtral-8x22b x prefill_32k / decode_32k,
     seamless-m4t-medium x prefill_32k and llama-3.2-vision-11b x
     decode_32k (all four kernels launch): each step counted on
     ``meta`` at full width at the probes (2 and 3 periods x batch 1
     and 2) and extended along the bilinear law; each probe run on the
     card with seeded weights (warm-up, a run under the counter, 3 timed
     runs) and held to its ``meta`` count (``dryrun.AGREE``): (a) FLOPs
     by dtype and launches by variant equal, bytes within 1%; (b)
     ``max_memory_allocated`` within 5% + 256 MiB of the counted peak;
     (c) the bound's share of the measured time at most 1.05; the
     launchers' counts over the pair equal the probes' counted launches
     x runs; (d) the record read by ``benchmarks/roofline_report.py``
     ``fmt_table``.  Then the bounds of what phases 11 and 12 measured
     (each model's prefill of 2 x 2048, its decode step over that
     cache, each training step), counted on ``meta``, printed beside
     the times measured in this run as the share;
  14. mesh: lane sharding of the batched engine
     (``BatchedCascadeEngine(mesh=)``, ``repro_torch.launch.mesh``):
     (a) flash, decode attention and the SSD scan against their plain
     versions at the rows one shard of a data=2 mesh gives them (4, 8,
     16 and 32: buckets 8 to 64 halved; inputs captured from the
     students' forwards), each timed beside its bound
     (``metrics/roofline.py``) and the library call, and on the variant
     the path takes ("tiled", ``select_variant``'s decode variant,
     "whole"); (b) phase 4's stream (imdb, 2048 items, batch 64, seed
     0, mu 3e-7, simulated expert) served with
     ``make_mesh((2,), ("data",), ["cuda:0", "cuda:0"])`` and profiled
     (items/s, ms a tick, device idle share), held to phase 8 (c)'s
     profiled unmeshed run at max_delay 0 and depth 0, which is not
     served again ((c) and (d) are served unprofiled, items/s only): the
     unmeshed run equal to phase 4 (accuracy, expert calls, launches by
     variant), the meshed one routing identically (every tick and lane; predictions,
     expert calls, level counts), its params / dparams within rtol 1e-4
     / atol 1e-6 of the unmeshed run's, every shard's replica equal to
     the canonical state, forwards by bucket equal, and each kernel's
     launches by variant exactly twice the unmeshed run's (once a shard,
     at half the rows); (c) the same at max_delay 2 and pipeline depth
     2, against phase 8 (c)'s unmeshed run with those options; (d) where more than one card is visible (and divides the
     64 lanes), the same over every card, launches N times; else a line
     says it did not run; then the phase's seconds;
  15. model-sharding (run inside the zoo block, on the Mixtral weights
     and prompts of phases 6 and 7 before they are freed): the zoo's tensor and
     expert parallelism (``sharding.place`` by ``param_pspecs``, the
     mesh installed, ``models.sharded``) over a (data 1, model 2) mesh
     on cuda:0 twice: (a) Mixtral prefill + 4 decode steps fed the
     unsharded greedy tokens, in tensor mode against zoo-serve's logits
     and in expert mode against the unsharded run with the prompt in
     one dispatch group (expert mode's dispatch over a data slice is
     ungrouped, as the reference's), at the bf16 rule (atol = rtol =
     6e-2), every greedy pick equal but for ties within that rule;
     launches by variant = 2 x the unsharded ones (expert mode's
     prefill: 3 products a MoE layer and rank), in the unsharded
     variants ("tc", "split"); each kernel at its shard's shape held
     against its plain version and timed beside its bound and the
     library call, and beside the unsharded row; tensor mode profiled;
     (b) mamba2-370m at 16 of 48 layers the same way, the SSD "parallel" at
     16 heads a rank, its logits no farther from the fp32 run than 1.25
     x the unsharded bf16 run's + 1e-3 (relative l2; phase 12's rule);
     (c) one fp32 ``train_loss`` + backward of Mixtral at 1 layer, 1 x
     2048 (layer 0 of the zoo's weights), the loss within 1e-5 and each
     gathered gradient leaf within 1e-4 (relative l2) of the unsharded
     step's; (d) (a) over two distinct cards where they exist, else a
     line says it did not run; (e') qwen3-8b at full width, 2 layers,
     bf16, 2 x 2048 + 4 decode steps over (data 1, model 16) on cuda:0,
     whose 8 kv heads do not divide 16, so the cache length splits into
     128 slots a rank, and (e'') the zoo's Mixtral at batch 1 over (data
     2, model 2), the length over 'data' and the kv heads over 'model'
     (the reference's ``cache_pspecs``), each against its unsharded run
     on the card (the MoE in dispatch groups of a data rank's tokens):
     logits at the bf16 rule and greedy picks equal but for ties, the
     gathered cache within the same rule (a MoE model's later periods
     may hold MS_MOE_SLOT_SHARE of their rows apart: a token whose
     routing tips the other way), each rank's k of the spec's shape,
     "partial" launches = ranks x layers x steps, one more decode step
     counted: rank 0's all-gather bytes = the activations the layout
     gathers (no weight), and the "partial" kernel at a rank's shape
     against its twin, timed beside its bound and memory-efficient SDPA
     with its log-sum-exp; a [clock] line gives the part's seconds (alone:
     python3 -c "import chip_smoke as c; c.phase_build(); cfg, p, t =
     c.zoo_model(); r, runs = {}, {}; [c._ms_split_part(x, cfg, p, t,
     r, runs) for x in c.MS_SPLIT]"); (e''') the Mamba half of the
     layout (in_proj / conv as contiguous column shards, the conv cache
     by ``cache_pspecs``): mamba2-370m at published widths and 16
     layers over (data 1, model 16) and Jamba-1.5-Large at published
     widths cut to its first two blocks (MAMBA, then MAMBA with the MoE
     FFN) over (data 1, model 4), bf16, 2 x 2048 + 4 decode steps on
     cuda:0, each against its unsharded run by (b)'s rule (the logits
     and every gathered conv / ssm leaf against the fp32 run; greedy
     picks equal but for ties), each rank's cache of ``shard_cache``'s
     shapes, launches = ranks x unsharded, one decode step's all-gather
     bytes on rank 0 = rows x (d_proj + d_xbc) a layer = the ``meta``
     count at the same shapes (every gathered part one token's), decode
     ms a step meshed vs unsharded, the SSD "parallel" and moe_gmm "tc"
     rows at a rank's shape; a [clock] line gives its seconds (alone:
     python3 -c "import chip_smoke as c; c.phase_build(); _, _, t =
     c.zoo_model(); [c._ms_mamba_part(x, t, {}, {}) for x in
     c.MS_MAMBA_SPLIT]"); then the phase's seconds;
  16. mesh-train-dryrun (last): (a) fp32 ``train()`` of internlm2-1.8b
     at full width, 2 layers, 4 x 2048, 3 steps with remat, unmeshed and
     over (data 2, model 2) on cuda:0 four times from the same seed: the
     losses within 1e-5 relative, the final gathered weights within 0.1
     lr a step (tests/test_torch_train.py's AdamW rule), launches 4 x by
     variant, flash at a rank's shape held and timed; (b) bf16 Mixtral
     at 1 layer, 1 x 2048, 3 AdamW steps unmeshed and over (data 1,
     model 2) in tensor mode (warm-up, timed, profiled): ms a step, idle
     share, the loss within 2e-3, launches 2 x, flash and moe_gmm at a
     rank's shape; (c) an internlm2-1.8b train_4k dry-run probe (2
     periods, batch 2) over (data 1, model 2) counted on meta and run on
     cuda:0 twice under the counter: FLOPs by dtype, launches by variant
     and collective bytes by kind equal, and the counted run's launches
     over both ranks twice rank 0's; (d) after every timed run, the
     16x16 meta records of qwen3-8b and Mixtral (zero) train_4k, counted
     by ``launch.dryrun`` in two processes (no card), printed
     with their count seconds and collective term (files under
     chiprun_out/dryrun_mesh); then the phase's seconds (alone:
     python3 -c "import chip_smoke as c; c.phase_build();
     c.phase_mesh_train_dryrun()").
The line before the last is the per-kernel JSON record (all four
kernels; ``launches`` is the total over the cascade, Mixtral and
zoo-archs serving runs, each counted from zero, ``launches_by_variant``
its split by variant (decode attention: "single" / "split" /
"partial"; the SSD
scan: "whole" / "parallel"), and ``paths`` has each path's own count,
times, ``variant`` (the one its timed row took) and
``launches_by_variant``, ``cascade_pipelined`` the launches of phase 8
(c)'s depth-2 run, ``cascade_admission`` those of phase 9 (c)'s Poisson
run at depth 0, ``cascade_sanitized`` those of phase 10 (a)'s depth-0
run, ``zoo_<model>_prefill`` / ``zoo_<model>_decode`` phase 11's runs
(with times where the model's row is timed: ``zoo_mamba2_prefill`` and
``zoo_jamba_prefill`` for the SSD scan, ``zoo_llama3_decode`` and
``zoo_vision_decode`` (cross) for decode attention,
``zoo_danube_prefill``, ``zoo_seamless_prefill`` (encoder) and
``zoo_vision_prefill`` (cross) for flash attention), and
``zoo_<model>_train`` phase 12's ``train()`` runs (8 steps with remat:
the launches, the timed row at the step's shapes, the step's ms,
tokens/s, profiled busy and idle share, peak GB, and the twin
backward's ms beside its bound), and ``dryrun_<model>_<shape>`` phase
13's runs of each pair (the launches over its probes, by variant);
for the three cascade kernels, ``cascade_mesh`` phase 14 (b)'s meshed
run (both shards' launches, by variant, its items/s and idle share) and
``cascade_shard_b4`` the timed row at one shard's 4 rows;
``model_sharding_<run>_<stage>`` phase 15's shard rows (Mixtral in
tensor and expert mode, mamba2) with the launches of both ranks, and
(e') / (e'')'s "partial" rows (``model_sharding_qwen3_model16_decode``,
``model_sharding_mixtral_data2_decode``) and (e''')'s SSD and moe_gmm
rows (``model_sharding_mamba2_model16_prefill``,
``model_sharding_jamba_model4_prefill`` / ``_decode``) with every
rank's launches;
``mesh_train_internlm2`` / ``mesh_train_mixtral`` phase 16 (a) / (b)'s
meshed runs (every rank's launches) with the timed rank row, and
``mesh_dryrun_internlm2_train`` (c)'s counted card run (both ranks);
flash attention's ``variants`` names its three, and its
``cascade_forced_simt`` path times "simt" at the path shape, off every
served path, so its ``launches`` is null);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# SSD: 1e-3 scaled by the plain output's largest magnitude when that is
# below 1 (the served students' SSD outputs are ~1e-4; an absolute 1e-3
# would pass a kernel that returned zeros)
TOL = {"flash_attention": 2e-5, "decode_attention": 2e-5, "ssd_scan": 1e-3,
       "bf16": 2e-2}
LOGIT_TOL = {"tinytf_flash": 1e-4, "ssm": 2e-3}
# zoo rows: tolerance x max|plain| (bf16 outputs differ by at most an ulp
# or two where two fp32 sums of another order round apart; fp32 gmm sums
# 6144-16384 products); zoo logits: (a) the tolerance the reference gives
# its own prefill/decode paths in bf16 (tests/test_archs_smoke.py), (b)
# fp32 on the card vs the CPU
ZOO_TOL = {"bf16": 1e-2, "fp32": 1e-5}
# the zoo's SSD rows (chunk 256, N 128): x min(1, max|plain|), fp32 sums
# over a 256-token chunk and 128 states in another order
ZOO_SSD_TOL = 2e-3
# the zoo's SSD rows on O(1) random inputs, held to a float64 evaluation
# per element, |kernel - f64| <= tol (1 + |f64|) (atol = rtol, as the
# tests hold the twin): with A = -(1 .. H), |cum A dt| reaches ~1e3
# (mamba2) to ~8e3 (Jamba) in a chunk, so exp(cum_i - cum_j) carries
# their fp32 rounding and the fp32 twin itself is ~5e-3 from float64 at
# |y| ~ 150: an absolute 2e-3 would hold the kernel to the twin's
# rounding, not to the function
ZOO_SSD_F64_TOL = 2e-3
ZOO_LOGIT_TOL = {"consistency": 6e-2, "card_vs_cpu": 1e-4}
# default-serve: the stream length, and Table 1's imdb budget (N = 1300
# of 25 000 items, benchmarks/table1.py) scaled to it
DEFAULT_ITEMS = 2048
TABLE1_BUDGET = 106
ZOO_ARCH = "mixtral-8x22b"
ZOO_LAYERS = 2
ZOO_BATCH, ZOO_PROMPT, ZOO_DECODE = 2, 2048, 16
MS_DECODE = 4             # phase 15's greedy decode steps
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:29",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:27",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:24",
    "moe_gmm": "src/repro/kernels/moe_gmm/kernel.py:22",
}
SOURCE = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def _fail(msg: str) -> None:
    raise SmokeFailure(msg)


def _setup():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no src/repro_torch under {ROOT})", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a GPU",
              file=sys.stderr)
        sys.exit(3)
    return torch


torch = _setup()
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda, select_variant as decode_variant)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_partial_ref, decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_cuda  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import (  # noqa: E402
    ssd_passes_cuda, ssd_scan_cuda, ssd_scratch)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_cb_ref, ssd_chunk_scan_ref, ssd_chunk_state_ref, ssd_scan_chunked_ref,
    ssd_state_pass_ref)
from repro_torch.metrics import roofline  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

LAUNCHERS = {"flash_attention": flash_attention_cuda,
             "decode_attention": decode_attention_cuda,
             "ssd_scan": ssd_scan_cuda}
ZOO_LAUNCHERS = {"moe_gmm": moe_gmm_cuda,
                 "flash_attention": flash_attention_cuda,
                 "decode_attention": decode_attention_cuda}
# the kernels with variants, each counting its launches by variant:
# moe_gmm and flash "tc" (bf16 wgmma fed by TMA) and "simt" (the scalar
# kernel), flash also "tiled" (fp32 register tiles); decode attention
# "single" (one block per (b, kv head), one launch) and "split" (the
# cache split across blocks, then a combine); the SSD scan "whole" (a
# chunk of up to 64 tokens held whole) and "parallel" (the zoo's chunk
# 256 in four chunk-parallel passes, one launch of the op)
VARIANT_LAUNCHERS = {"moe_gmm": moe_gmm_cuda,
                     "flash_attention": flash_attention_cuda,
                     "decode_attention": decode_attention_cuda,
                     "ssd_scan": ssd_scan_cuda}
TC_LAUNCHERS = ("moe_gmm", "flash_attention")


# ---------------------------------------------------------------------------
# plain versions (same inputs, model layout) and library yardsticks
# ---------------------------------------------------------------------------
def flash_plain(q, k, v, causal=True, window=None):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         sm_scale=q.shape[-1] ** -0.5).transpose(1, 2)


def flash_library(q, k, v, causal=True, window=None):
    # one SDPA call computes the function only when no window cuts in
    assert window is None or window >= q.shape[1]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def decode_plain(q, k, v, pos):
    B, _, H, hd = q.shape
    K = k.shape[2]
    if pos.ndim == 1:
        pos = pos[None].expand(B, pos.shape[0])
    return decode_attention_ref(q[:, 0].reshape(B, K, H // K, hd), k, v,
                                pos, sm_scale=hd ** -0.5).reshape(B, 1, H, hd)


def decode_library(q, k, v, pos):
    B, _, H, hd = q.shape
    if pos.ndim == 1:
        pos = pos[None].expand(B, pos.shape[0])
    mask = (pos >= 0)[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=H != k.shape[2]).transpose(1, 2)


# ---------------------------------------------------------------------------
# analytic bounds: max(bytes / HBM rate, FLOPs / peak rate of the dtype:
# fp32 outside the tensor cores, bf16 dense tensor cores), from the cost
# functions the kernel ops report to the dry-run's counter
# (``repro_torch.metrics.roofline``, the H100 SXM data sheet's rates)
# ---------------------------------------------------------------------------
def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes, flops, dtype=torch.float32):
    """max(bytes / HBM rate, FLOPs / the peak rate of ``dtype``), in ms."""
    return roofline.kernel_bound(nbytes, flops, dtype)


def flash_flops(q, k, causal=True, window=None):
    return roofline.flash_flops(q.shape, k.shape[1], causal, window)


def flash_bound(q, k, v, causal=True, window=None):
    return roofline.flash_cost(q.shape, k.shape, q.dtype, causal,
                               window).bound_ms()


def decode_bound(q, k, v, pos):
    """K / V of the slots this data needs (valid positions) only."""
    B, W = q.shape[0], k.shape[1]
    if pos.ndim == 1:
        pos = pos[None].expand(B, W)
    return roofline.decode_cost(q.shape, k.shape, q.dtype,
                                int((pos >= 0).sum())).bound_ms()


def ssd_bound(x, adt, dt, B, C, chunk):
    return roofline.ssd_cost(x.shape, B.shape[-1], chunk).bound_ms()


def gmm_bound(x, w):
    return roofline.gmm_cost(x.shape, w.shape, x.dtype).bound_ms()


# ---------------------------------------------------------------------------
# timing with CUDA events
# ---------------------------------------------------------------------------
def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def ssd_float64(x, adt, dt, B, C):
    """The SSD recurrence token by token in float64 (``ssd_scan_ref``'s
    semantics): (y, the final state), the ground truth of the zoo's
    random SSD rows."""
    Bsz, S, H, hp = x.shape
    x, adt, dt, B, C = (t.double() for t in (x, adt, dt, B, C))
    h = torch.zeros((Bsz, H, hp, B.shape[-1]), dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(adt[:, t])[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], h))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build():
    """Build the kernels and print ptxas's registers, static shared memory
    and spills per kernel (the tensor-core kernels' shared memory is
    dynamic: their ring of stages, set at launch)."""
    path, secs, log = _build.build()
    print(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s", flush=True)
    # ptxas names each kernel mangled; the toolkit's cu++filt (where it
    # ships) gives the readable names, without parameter types
    mangled = re.findall(r"Compiling entry function '([^']+)'", log)
    names = dict(zip(mangled, mangled))
    filt = Path(_build.find_nvcc()).with_name("cu++filt")
    if mangled and filt.is_file():
        out = subprocess.run([str(filt), "-p", *mangled], capture_output=True,
                             text=True, check=True, timeout=60).stdout
        names = {m: n.replace("<unnamed>::", "")
                 for m, n in zip(mangled, out.splitlines())}
    kernel = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            kernel = names[m.group(1)]
        elif ln.startswith("=="):
            print(f"[build] {ln.strip()}")
        elif "Used" in ln or "spill" in ln:
            print(f"[build]   {kernel}: {ln.split(':', 1)[-1].strip()}")
    _build.library()


def capture_path_inputs(batch, tf_spec, ssm_spec, tokens, gen):
    """Run one kernel-path forward of each upper student at full width
    and record the inputs each op gets there (the shapes and values the
    main path gives the kernels)."""
    from repro_torch.models import kernel_students as ks
    got = {}
    real = {n: getattr(ks, n) for n in
            ("flash_attention", "decode_attention", "ssd_scan")}

    def rec(name):
        def f(*args, **kw):
            got.setdefault(name, (args, kw))
            return real[name](*args, **kw)
        return f

    dev = torch.device("cuda")
    tf_params = ks.tinytf_flash_init(gen, tf_spec, dev)
    ssm_params = ks.ssm_student_init(gen, ssm_spec, dev)
    try:
        for name in real:
            setattr(ks, name, rec(name))
        with torch.no_grad():
            ks.tinytf_flash_logits(tf_params, tokens[:batch], tf_spec)
            ks.ssm_student_logits(ssm_params, tokens[:batch], ssm_spec)
    finally:
        for name, fn in real.items():
            setattr(ks, name, fn)
    return got


def _variant_counts():
    return {n: dict(fn.launches_by_variant)
            for n, fn in VARIANT_LAUNCHERS.items()}


def _zero_variant_counts():
    for fn in VARIANT_LAUNCHERS.values():
        fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


def _layer_forwards(eng):
    """Kernel launches a kernel-ladder engine's layer forwards imply, and
    the flash calls by padded batch (the engine's bucket)."""
    lv = {lvl.spec.kind: lvl for lvl in eng.levels}
    tf, ssm = lv["tinytf_flash"], lv["ssm"]
    return ({"flash_attention": tf.sspec.n_layers * tf.forwards,
             "decode_attention": tf.forwards,
             "ssd_scan": ssm.sspec.n_layers * ssm.forwards},
            {b: tf.sspec.n_layers * n
             for b, n in sorted(tf.forwards_by_batch.items())})


def check(name, label, kernel_fn, plain_fn, tol, results, library_fn=None,
          bound=None, timed=False, scaled=False, relative=False, reps=20,
          variant=None, per_element=False):
    """Kernel vs plain on the same inputs.  ``scaled``: tol x min(1,
    max|plain|); ``relative``: tol x max|plain|; ``per_element``: every
    element within tol x (1 + |plain|).  For a kernel with two
    variants the row records the one its call took and, when ``variant``
    is given, fails unless it is that one."""
    torch.cuda.synchronize()
    before = _variant_counts().get(name)
    out = kernel_fn()
    torch.cuda.synchronize()
    took = None
    if before is not None:
        after = VARIANT_LAUNCHERS[name].launches_by_variant
        took = "+".join(v for v in after if after[v] > before[v])
    if variant is not None and took != variant:
        _fail(f"{name} [{label}]: took variant {took!r}, expected "
              f"{variant!r}")
    ref = plain_fn()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        _fail(f"{name} [{label}]: {out.dtype}{tuple(out.shape)} != plain "
              f"{ref.dtype}{tuple(ref.shape)}")
    err = max_err(out, ref)
    if not math.isfinite(err) or not bool(torch.isfinite(out).all()):
        _fail(f"{name} [{label}]: non-finite output")
    ref_max = float(ref.float().abs().max())
    if scaled:
        tol = tol * min(1.0, ref_max)
    if relative:
        tol = tol * ref_max
    row = {"max_abs_err": err, "tol": tol, "max_abs_ref": ref_max}
    if per_element:
        row["max_err_over_1_plus_ref"] = float(
            ((out - ref).abs() / (1 + ref.abs())).max())
    if took is not None:
        row["variant"] = took
    if timed:
        row["kernel_ms"] = time_ms(kernel_fn, reps)
        row["plain_ms"] = time_ms(plain_fn, reps)
        row["library_ms"] = time_ms(library_fn, reps) if library_fn else None
        row["bound_ms"], row["bound_by"] = bound
    print(f"[check] {name:16s} {label:28s} " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    if per_element and row["max_err_over_1_plus_ref"] > tol:
        _fail(f"{name} [{label}]: max |out - plain| / (1 + |plain|) "
              f"{row['max_err_over_1_plus_ref']} > tol {tol}")
    if not per_element and err > tol:
        _fail(f"{name} [{label}]: max_abs_err {err} > tol {tol}")
    results.setdefault(name, []).append((label, row))
    return row


def phase_kernels(tokens):
    from repro_torch.models.kernel_students import (SSMStudentSpec,
                                                    TinyTFFlashSpec)
    results = {}
    gen = torch.Generator().manual_seed(1234)
    # the engine pads each level's lanes to buckets 8/16/32/64: batch 64
    # and the smallest bucket for every kernel, and bucket 16 for the SSD
    # scan; the readout's 128 slots are one split at every bucket
    for batch in (64, 8, 16):
        got = capture_path_inputs(batch, TinyTFFlashSpec(), SSMStudentSpec(),
                                  tokens, gen)
        (x, adt, dt, B, C), kw = got["ssd_scan"]
        check("ssd_scan", f"path B={batch} chunk {kw['chunk']}",
              lambda: ssd_ops.ssd_scan(x, adt, dt, B, C, **kw),
              lambda: ssd_scan_chunked_ref(x, adt, dt, B, C, kw["chunk"]),
              TOL["ssd_scan"], results, None,
              ssd_bound(x, adt, dt, B, C, kw["chunk"]), True, scaled=True,
              variant="whole")
        if batch == 16:
            continue
        (q, k, v), kw = got["flash_attention"]
        check("flash_attention", f"path B={batch} causal fp32",
              lambda: fl_ops.flash_attention(q, k, v, **kw),
              lambda: flash_plain(q, k, v), TOL["flash_attention"], results,
              lambda: flash_library(q, k, v), flash_bound(q, k, v), True,
              variant="tiled")
        if batch == 64:
            # the scalar kernel at the path shape, so that it stays held
            # to the plain version (and timed beside "tiled")
            check("flash_attention", "forced simt B=64 causal fp32",
                  lambda: flash_attention_cuda(
                      q, k, v, sm_scale=q.shape[-1] ** -0.5,
                      variant="simt"),
                  lambda: flash_plain(q, k, v), TOL["flash_attention"],
                  results, lambda: flash_library(q, k, v),
                  flash_bound(q, k, v), True, variant="simt")
        (q, k, v, pos), kw = got["decode_attention"]
        check("decode_attention", f"path B={batch} pads fp32",
              lambda: dec_ops.decode_attention(q, k, v, pos, **kw),
              lambda: decode_plain(q, k, v, pos), TOL["decode_attention"],
              results, lambda: decode_library(q, k, v, pos),
              decode_bound(q, k, v, pos), True, variant="single")

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to("cuda", dtype)

    # flash edge cases: fp32 with hd 32 takes "tiled", bf16 hd 32 and fp32
    # hd 120 take "simt", bf16 hd 120 takes "tc"
    for label, (B, S, H, K, hd, causal, window, dtype, fv) in {
            "window 48": (4, 128, 4, 4, 32, True, 48, torch.float32,
                          "tiled"),
            "non-causal": (4, 128, 4, 4, 32, False, None, torch.float32,
                           "tiled"),
            "GQA H8/K2": (4, 128, 8, 2, 32, True, None, torch.float32,
                          "tiled"),
            "bf16": (4, 128, 4, 4, 32, True, None, torch.bfloat16, "simt"),
            "hd 120": (2, 128, 4, 2, 120, True, None, torch.float32,
                       "simt"),
            "hd 120 bf16": (2, 128, 4, 2, 120, True, None, torch.bfloat16,
                            "tc"),
            "ragged S=100": (2, 100, 4, 4, 32, True, None, torch.float32,
                             "tiled"),
    }.items():
        q, k, v = rnd(B, S, H, hd, dtype=dtype), rnd(B, S, K, hd,
                                                       dtype=dtype), \
            rnd(B, S, K, hd, dtype=dtype)
        tol = TOL["bf16"] if dtype == torch.bfloat16 else \
            TOL["flash_attention"]
        check("flash_attention", label,
              lambda: fl_ops.flash_attention(q, k, v, causal=causal,
                                             window=window),
              lambda: flash_plain(q, k, v, causal, window), tol, results,
              variant=fv)

    # SSD on O(1) inputs at the path shape, where a wrong decay or state
    # update cannot hide under the small outputs of the served students;
    # timed at every bucket of the engine
    (x, _, _, Bp, _), kw = got["ssd_scan"]
    _, S, H, hp = x.shape
    N, chunk = Bp.shape[-1], kw["chunk"]
    for Bsz in (64, 32, 16, 8):
        xr, Br, Cr = rnd(Bsz, S, H, hp), rnd(Bsz, S, N), rnd(Bsz, S, N)
        dtr = F.softplus(rnd(Bsz, S, H) - 2.0)
        adtr = -torch.arange(1, H + 1, device="cuda").float() * dtr
        check("ssd_scan", f"random O(1) B={Bsz}",
              lambda: ssd_ops.ssd_scan(xr, adtr, dtr, Br, Cr, chunk=chunk),
              lambda: ssd_scan_chunked_ref(xr, adtr, dtr, Br, Cr, chunk),
              TOL["ssd_scan"], results, None,
              ssd_bound(xr, adtr, dtr, Br, Cr, chunk), True, scaled=True,
              variant="whole")

    # decode edge cases
    B, W, H, hd = 8, 128, 4, 32
    q, k, v = rnd(B, 1, H, hd), rnd(B, W, H, hd), rnd(B, W, H, hd)
    lens = torch.randint(1, W + 1, (B,), generator=gen)
    ar = torch.arange(W)
    pos = torch.where(ar[None] < lens[:, None], ar[None],
                      torch.full_like(ar, -1)[None]).to("cuda", torch.int32)
    kg, vg = k.clone(), v.clone()
    inval = (pos < 0)[:, :, None, None].expand_as(kg)
    kg[inval] = 1e4 * rnd(B, W, H, hd)[inval]
    vg[inval] = 1e4 * rnd(B, W, H, hd)[inval]
    dv = decode_variant(B, H, W)
    check("decode_attention", "garbage in empty slots",
          lambda: dec_ops.decode_attention(q, kg, vg, pos),
          lambda: dec_ops.decode_attention(q, k, v, pos),
          TOL["decode_attention"], results, variant=dv)
    pos1 = torch.where(ar < 77, ar, torch.full_like(ar, -1))
    pos1 = pos1.to("cuda", torch.int32)
    check("decode_attention", "(W,) pos",
          lambda: dec_ops.decode_attention(q, k, v, pos1),
          lambda: decode_plain(q, k, v, pos1), TOL["decode_attention"],
          results, variant=dv)
    qg, kk, vv = rnd(B, 1, 8, hd), rnd(B, W, 2, hd), rnd(B, W, 2, hd)
    check("decode_attention", "GQA H8/K2",
          lambda: dec_ops.decode_attention(qg, kk, vv, pos),
          lambda: decode_plain(qg, kk, vv, pos), TOL["decode_attention"],
          results, variant=decode_variant(B, 2, W))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    check("decode_attention", "bf16",
          lambda: dec_ops.decode_attention(qb, kb, vb, pos),
          lambda: decode_plain(qb, kb, vb, pos), TOL["bf16"], results,
          variant=dv)
    return results


def phase_serve():
    from repro_torch.launch.serve import serve_stream_batched
    for fn in LAUNCHERS.values():
        fn.launches = 0
    _zero_variant_counts()
    t0 = time.time()
    m = serve_stream_batched("imdb", 2048, 3e-7, batch=64, seed=0,
                             log_every=0, ladder="kernel",
                             expert_kind="simulated", device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {n: fn.launches for n, fn in LAUNCHERS.items()}
    by_variant = {n: c for n, c in _variant_counts().items()
                  if n in LAUNCHERS}
    eng = m["engine"]
    # flash calls by padded batch (the engine's bucket), from its counts
    expect, flash_batches = _layer_forwards(eng)
    print(f"[serve] items_per_sec={m['items_per_sec']:.1f} "
          f"wall_s={wall:.2f} accuracy={m['accuracy']:.4f} "
          f"expert_calls={m['expert_calls']} level_fractions="
          f"{[round(f, 4) for f in m['level_fractions']]}")
    print(f"[serve] forwards per level: "
          f"{ {lvl.spec.kind: lvl.forwards for lvl in eng.levels} } "
          f"launches: {launches} expected: {expect}; by variant: "
          f"{by_variant}; flash calls by batch: {flash_batches}",
          flush=True)
    if by_variant["flash_attention"] != {
            "tc": 0, "simt": 0, "tiled": launches["flash_attention"]}:
        _fail(f"the cascade's fp32 flash launches must all take the "
              f"register-tiled variant: {by_variant['flash_attention']}")
    if by_variant["ssd_scan"] != {"whole": launches["ssd_scan"],
                                  "parallel": 0}:
        _fail(f"the cascade's SSD launches (chunk 64) must all take the "
              f"whole-chunk variant: {by_variant['ssd_scan']}")
    for n in LAUNCHERS:
        if launches[n] <= 0:
            _fail(f"{n} was never launched on the serving path")
        if launches[n] != expect[n]:
            _fail(f"{n}: {launches[n]} launches != {expect[n]} "
                  "layer-forwards the engine counted")
    if not (0.0 <= m["accuracy"] <= 1.0) or m["expert_calls"] <= 0:
        _fail(f"implausible serving metrics {m['accuracy']}, "
              f"{m['expert_calls']}")
    return eng, launches, by_variant, m


def phase_students(eng, tokens):
    from repro_torch.models.kernel_students import (ssm_student_logits,
                                                    tinytf_flash_logits)
    lv = {lvl.spec.kind: lvl for lvl in eng.levels}
    for kind, fn in (("tinytf_flash", tinytf_flash_logits),
                     ("ssm", ssm_student_logits)):
        lvl = lv[kind]
        with torch.no_grad():
            a = fn(lvl.params, tokens[:64], lvl.sspec, use_kernels=True)
            b = fn(lvl.params, tokens[:64], lvl.sspec, use_kernels=False)
        torch.cuda.synchronize()
        err = max_err(a, b)
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        print(f"[students] {kind}: max |kernel - plain| logits={err:.3g} "
              f"(tol {LOGIT_TOL[kind]}) argmax equal on all 64 rows: "
              f"{same}", flush=True)
        if not same or err > LOGIT_TOL[kind] or not math.isfinite(err):
            _fail(f"{kind} kernel vs plain path disagree")


# ---------------------------------------------------------------------------
# default-serve: the paper's own cascade, lr -> tinytf, at full width
# ---------------------------------------------------------------------------
def _routing_records(eng):
    """Per-tick (level, expert called, prediction) rows of an engine's
    history, one array of S lanes each."""
    h = eng.history
    return [{"level": np.asarray(lv), "called": np.asarray(c),
             "pred": np.asarray(p)}
            for lv, c, p in zip(h["level"], h["expert_called"], h["pred"])]


def _first_divergence(a, b):
    """The first (tick, lane, field) at which two routing records part,
    or None (ticks count from 1)."""
    if len(a) != len(b):
        return (min(len(a), len(b)) + 1, None, "tick count")
    for t, (ra, rb) in enumerate(zip(a, b), 1):
        for name in ("level", "called", "pred"):
            diff = np.flatnonzero(ra[name] != rb[name])
            if diff.size:
                return (t, int(diff[0]), name)
    return None


def phase_default_serve():
    """The paper's default ladder (``default_cascade_config``: lr ->
    tinytf at ``TinyTFSpec()`` widths) on imdb: (1) served with the model
    expert trained on the card first; (2) the Table 1 configuration under
    its hard budget; (3) card against CPU routing on a short stream.  No
    kernel of the port lies on this path: every count must stay 0."""
    from repro_torch.core import (BatchedCascadeEngine, SimulatedExpert,
                                  default_cascade_config)
    from repro_torch.data import make_stream
    from repro_torch.launch.serve import serve_stream_batched
    launchers = {**LAUNCHERS, **ZOO_LAUNCHERS}
    for fn in launchers.values():
        fn.launches = 0
    t0 = time.time()
    m = serve_stream_batched("imdb", DEFAULT_ITEMS, 3e-7, batch=64, seed=0,
                             log_every=0, ladder="default",
                             expert_kind="model", device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {n: fn.launches for n, fn in launchers.items()}
    eng = m["engine"]
    stream = make_stream("imdb", seed=0, n_samples=DEFAULT_ITEMS)
    expert_acc = float(np.mean(eng.expert.label_batch(
        range(len(stream)), stream.docs) == stream.labels))
    fr = [round(f, 4) for f in m["level_fractions"]]
    print(f"[default-serve] model expert (d_model 256, 4 layers) trained "
          f"on the card in {m['expert_train_s']:.2f} s; its accuracy on "
          f"the stream {expert_acc:.4f}", flush=True)
    print(f"[default-serve] items_per_sec={m['items_per_sec']:.1f} "
          f"wall_s={wall:.2f} accuracy={m['accuracy']:.4f} "
          f"expert_calls={m['expert_calls']} level_fractions={fr} "
          f"forwards per level: "
          f"{ {lvl.spec.kind: lvl.forwards for lvl in eng.levels} } "
          f"kernel launches: {launches}", flush=True)
    if any(launches.values()):
        _fail(f"the dense default ladder launched a kernel: {launches}")
    vals = [m["items_per_sec"], m["accuracy"], expert_acc] + fr
    if not all(map(math.isfinite, vals)) or not 0 <= m["accuracy"] <= 1:
        _fail(f"non-finite or implausible default-serve metrics {vals}")
    if not 0 < m["expert_calls"] <= DEFAULT_ITEMS:
        _fail(f"expert_calls {m['expert_calls']} not in (0, "
              f"{DEFAULT_ITEMS}]")
    del eng, m

    # (2) Table 1: imdb N = 1300 of 25 000 items, scaled to this stream
    cfg = dataclasses.replace(
        default_cascade_config(stream.spec.n_classes, mu=2e-7, seed=0),
        hard_budget=TABLE1_BUDGET)
    eng = BatchedCascadeEngine(cfg, SimulatedExpert(stream), n_streams=64,
                               history_limit=0, device="cuda")
    t0 = time.time()
    mb = eng.run(stream)
    torch.cuda.synchronize()
    wall = time.time() - t0
    overflow = eng.levels[-1].forwards_by_batch.get(1, 0)
    print(f"[default-serve] table1 hard_budget={TABLE1_BUDGET} mu=2e-7 "
          f"simulated expert: items_per_sec={mb['items_per_sec']:.1f} "
          f"wall_s={wall:.2f} accuracy={mb['accuracy']:.4f} "
          f"expert_calls={eng.expert_calls_total} overflow_lanes="
          f"{overflow} level_fractions="
          f"{[round(f, 4) for f in mb['level_fractions']]}", flush=True)
    if eng.expert_calls_total > TABLE1_BUDGET:
        _fail(f"{eng.expert_calls_total} expert calls over the budget of "
              f"{TABLE1_BUDGET}")
    if not eng._budget_exhausted():
        _fail(f"the budget of {TABLE1_BUDGET} was never reached "
              f"({eng.expert_calls_total} calls)")
    del eng

    # (3) card against CPU: the same seeded weights, stream and draws
    small = make_stream("imdb", seed=0, n_samples=48)
    cfg = default_cascade_config(small.spec.n_classes, mu=3e-7, seed=0)
    recs = {}
    for dev in ("cuda", "cpu"):
        eng = BatchedCascadeEngine(cfg, SimulatedExpert(small), n_streams=8,
                                   device=dev)
        eng.run(small)
        recs[dev] = _routing_records(eng)
    div = _first_divergence(recs["cuda"], recs["cpu"])
    calls = int(sum(r["called"].sum() for r in recs["cuda"]))
    print(f"[default-serve] card vs CPU, 48 items at batch 8: routing "
          f"{'identical' if div is None else 'DIFFERS'} over "
          f"{len(recs['cuda'])} ticks ({calls} expert calls)", flush=True)
    if div is not None:
        _fail(f"card and CPU routing part at tick {div[0]}, lane {div[1]} "
              f"({div[2]})")


# ---------------------------------------------------------------------------
# engine-matrix: the serving options of BatchedCascadeEngine at full width
# ---------------------------------------------------------------------------
MATRIX_ITEMS, MATRIX_BATCH, MATRIX_MU = 2048, 64, 3e-7
# (b) / (b'): a fresh engine sends every item of its first ticks to the
# expert, so the W=1 / W=4 pairs resume from one checkpoint of a warm run
# on a stream of MATRIX_LANE_STREAM items, taken T ticks in, where tick
# T + 1 is the first at which students answer some lanes and the pool
# labels the rest; they serve MATRIX_LANE_TICKS more.  Per-lane commits
# serve 14-54 items/s on the card, so the served stream stays at 8 ticks
# (2048 items took 225 s of a 1148 s script on a slow host)
MATRIX_LANE_STREAM, MATRIX_LANE_TICKS = 2560, 8
MATRIX_DEVICE = "cuda"
# (e): the seeded fault schedule and the requeue deadline (s)
MATRIX_FAULTS = {"timeout_rate": 0.1, "death_rate": 0.05, "slow_rate": 0.2,
                 "seed": 0}
MATRIX_TIMEOUT = 1.0


def _pool_latency(seq, j):
    """(b): an adversarial per-shard latency, in non-blocking probes."""
    return (seq * 2654435761 + j * 40503) % 9


def _sync():
    if MATRIX_DEVICE == "cuda":
        torch.cuda.synchronize()


def _matrix_engine(ladder, expert, hard_budget=None, device=None,
                   n_streams=None, **opts):
    """An engine on ``ladder`` (imdb's 2 classes, mu 3e-7, seed 0) with
    the unbounded history (and so the commit log) on."""
    from repro_torch.core import BatchedCascadeEngine
    from repro_torch.launch.serve import _ladder_config
    cfg = dataclasses.replace(
        _ladder_config(ladder, 2, MATRIX_MU, 0, expert.cost),
        hard_budget=hard_budget)
    return BatchedCascadeEngine(cfg, expert,
                                n_streams=n_streams or MATRIX_BATCH,
                                device=device or MATRIX_DEVICE, **opts)


def _matrix_report(tag, eng, m, wall):
    cs = eng.commit_stats
    age = cs["age_sum"] / cs["lanes"] if cs["lanes"] else 0.0
    print(f"[engine-matrix] {tag}: items_per_sec={m['items_per_sec']:.1f} "
          f"wall_s={wall:.2f} accuracy={m['accuracy']:.4f} "
          f"expert_calls={m['expert_calls']} level_fractions="
          f"{[round(f, 4) for f in m['level_fractions']]} "
          f"pipeline_stats={eng.pipeline_stats} commit_stats: lanes="
          f"{cs['lanes']} mean_age={age:.3f} age_max={cs['age_max']} "
          f"fault_stats={eng.fault_stats}", flush=True)


def _student_routed(tag, fractions):
    """Print the share of items a student answered (the last level is
    the expert) and fail at 0: a pair of runs held to each other (W=1 vs
    W=4, resumed vs uninterrupted) is checked on ticks where students
    answer some lanes and the expert the rest, or on nothing."""
    share = 1.0 - float(fractions[-1])
    print(f"{tag}: student_routed={share:.4f}", flush=True)
    if share <= 0:
        _fail(f"{tag}: no item was routed to a student")


def _matrix_run(tag, eng, stream):
    t0 = time.time()
    m = eng.run(stream)
    _sync()
    _matrix_report(tag, eng, m, time.time() - t0)
    return m


def _profiled(tag, eng, stream):
    """Serve through ``profile_serve.profiled_run`` (4 warm-up ticks, then
    a profiled window); items/s and wall are the window's, beside its ms
    per tick and the device's idle share."""
    from repro_torch.launch.profile_serve import profiled_run
    rep, preds = profiled_run(eng, stream, warmup_ticks=4)
    m = {"items_per_sec": rep["items_per_sec"], "accuracy": rep["accuracy"],
         "expert_calls": rep["expert_calls"],
         "level_fractions": rep["level_fractions"], "predictions": preds}
    _matrix_report(f"{tag} (profiled window of {rep['window_ticks']} "
                   "ticks)", eng, m,
                   rep["wall_ms_per_tick"] * rep["window_ticks"] / 1e3)
    idle = rep["device_idle_share"]
    print(f"[engine-matrix] {tag}: wall_ms_per_tick="
          f"{rep['wall_ms_per_tick']:.3f} device_busy_ms_per_tick="
          f"{rep['device_busy_ms_per_tick']:.3f} device_idle_share="
          f"{'not measured' if idle is None else f'{idle:.4f}'} "
          f"host_commit_share={rep['host_commit_share']:.4f}", flush=True)
    return m, rep


def _states_equal(a, b):
    from repro_torch.core import STATE_ATTRS
    return all(torch.equal(x, y) for la, lb in zip(a.levels, b.levels)
               for attr in STATE_ATTRS
               for x, y in zip(tree_leaves(getattr(la, attr)),
                               tree_leaves(getattr(lb, attr))))


def _same_run(tag, a, ma, b, mb, state=True):
    """Two runs of one stream: identical predictions, routing, expert
    calls and (``state``) bitwise learned state, else fail."""
    div = _first_divergence(_routing_records(a), _routing_records(b))
    same_pred = bool(np.array_equal(ma["predictions"], mb["predictions"]))
    same_state = _states_equal(a, b) if state else None
    print(f"[engine-matrix] {tag}: predictions identical {same_pred}, "
          f"routing {'identical' if div is None else f'differs {div}'}, "
          f"expert calls {ma['expert_calls']} / {mb['expert_calls']}"
          + ("" if state is False else
             f", every parameter torch.equal {same_state}"), flush=True)
    if not same_pred or div is not None \
            or ma["expert_calls"] != mb["expert_calls"] \
            or same_state is False:
        _fail(f"{tag}: the two runs differ")


def _commit_log_checks(tag, eng, bound, t0=0):
    """Every annotated (tick, lane) committed exactly once, within
    ``bound`` ticks (fault-free runs: nothing dropped).  ``t0``: the tick
    the engine was restored at; the ticks up to it are not checked."""
    called = {(t, int(s)) for t, c in
              enumerate(eng.history["expert_called"], t0 + 1)
              for s in np.flatnonzero(c)}
    log = [e for e in eng.commit_log if e[0] > t0]
    keys = [(t, s) for t, s, _ in log]
    ages = [c - t for t, _, c in log]
    if len(eng._pending) or len(set(keys)) != len(keys) \
            or set(keys) != called:
        _fail(f"{tag}: annotated lanes not committed exactly once "
              f"({len(keys)} commits, {len(set(keys))} distinct, "
              f"{len(called)} annotated, {len(eng._pending)} pending)")
    if max(ages) > bound or eng.commit_stats["age_max"] > bound:
        _fail(f"{tag}: a commit age {max(ages)} exceeds {bound}")
    print(f"[engine-matrix] {tag}: {len(keys)} annotated lanes committed "
          f"exactly once, ages {min(ages)}..{max(ages)} (bound {bound})",
          flush=True)


def _matrix_async(stream):
    """(a) the default ladder with the model expert at max_delay 2; the
    model expert is trained once and reused by (b')."""
    from repro_torch.core import train_model_expert
    t0 = time.time()
    expert = train_model_expert(stream, 2, epochs=2,
                                max_samples=MATRIX_ITEMS, seed=0,
                                device=MATRIX_DEVICE)
    _sync()
    print(f"[engine-matrix] model expert trained in {time.time() - t0:.2f}"
          " s", flush=True)
    eng = _matrix_engine("default", expert, max_delay=2)
    _matrix_run("(a) default ladder, model expert, max_delay=2", eng, stream)
    _commit_log_checks("(a)", eng, 2)
    for D in (0, 2):
        _profiled(f"(a) profile, model expert, max_delay={D}",
                  _matrix_engine("default", expert, max_delay=D,
                                 history_limit=0), stream)
    return expert


def _students_a_tick(eng):
    """Items a student answered, tick by tick of the engine's history."""
    return [int((np.asarray(lv) < len(eng.levels)).sum())
            for lv in eng.history["level"]]


def _matrix_warm(stream, tmp):
    """(b) / (b')'s warm start: the default ladder, per-lane commits at
    max_delay 2, simulated expert, W=1, saved after every tick until the
    first tick at which students answer some lanes and the expert is
    called on the rest.  Returns T (the ticks before that one), the
    checkpoint taken after T ticks, and the run's seconds, saves
    included."""
    from repro_torch.core import SimulatedExpert
    S = MATRIX_BATCH
    t0 = time.time()
    eng = _matrix_engine("default", SimulatedExpert(stream), per_lane=True,
                         max_delay=2)
    nlev = len(eng.levels)
    for T in range(len(stream) // S - MATRIX_LANE_TICKS + 1):
        path = str(Path(tmp) / f"warm{T % 2}")
        eng.save_state(path)
        idxs = list(range(T * S, (T + 1) * S))
        out = eng.process_tick(idxs, [stream.docs[i] for i in idxs])
        if 0 < int((np.asarray(out["levels"]) < nlev).sum()) < S:
            break
    else:
        _fail(f"(b) no tick of the first {T + 1} had students answer some "
              "lanes and the expert the rest")
    eng.close()
    _sync()
    warm_s = time.time() - t0
    print(f"[engine-matrix] (b) warm run: first tick with students on "
          f"some lanes {T + 1}, so T={T} ({T * S} items), students a tick "
          f"{_students_a_tick(eng)}, expert calls {eng.expert_calls_total} "
          f"by then, {warm_s:.2f} s with a save a tick", flush=True)
    return T, path, warm_s


def _matrix_served(tag, eng, stream, counts0):
    """Serve a restored engine to the end of ``stream``; the students'
    share is gated over the ticks this run served (``counts0``: the level
    counts at the restore)."""
    m = _matrix_run(tag, eng, stream)
    served = eng.level_counts.sum(axis=0) - counts0
    print(f"[engine-matrix] {tag}: students a tick "
          f"{_students_a_tick(eng)}", flush=True)
    first = eng.t - MATRIX_LANE_TICKS + 1
    _student_routed(f"[engine-matrix] {tag}, ticks {first}..{eng.t}",
                    served / served.sum())
    return m


def _matrix_pool(expert):
    """(b) per-lane commits at max_delay 2, W=1 against W=4 (simulated
    expert, adversarial latency at W=4); (b') the same pair with the
    model expert, its per-item labels compared; all four resumed from one
    warm run's checkpoint.  Then the process backend.  Returns the warm
    run's seconds."""
    import tempfile
    from repro_torch.core import ModelExpert, SimulatedExpert
    from repro_torch.data import make_stream
    S = MATRIX_BATCH
    full = make_stream("imdb", seed=0, n_samples=MATRIX_LANE_STREAM)
    experts = {w: ModelExpert(params=expert.params, spec=expert.spec,
                              workers=w, device=MATRIX_DEVICE)
               for w in (1, 4)}
    sides = {("(b)", w): SimulatedExpert(
        full, workers=w, latency=_pool_latency if w > 1 else None)
        for w in (1, 4)}
    sides.update({("(b')", w): ex for w, ex in experts.items()})
    engines = {}
    with tempfile.TemporaryDirectory() as tmp:
        T, path, warm_s = _matrix_warm(full, tmp)
        for key, ex in sides.items():
            eng = _matrix_engine("default", ex, per_lane=True, max_delay=2)
            eng.restore_state(path)
            engines[key] = eng
    # the served ticks: T + 1 .. T + MATRIX_LANE_TICKS
    n = (T + MATRIX_LANE_TICKS) * S
    stream = dataclasses.replace(
        full, docs=full.docs[:n], labels=full.labels[:n],
        categories=full.categories[:n], lengths=full.lengths[:n],
        _expert_cache={})
    first = engines["(b)", 1]
    same = all(_states_equal(first, e) for e in engines.values())
    counts0 = first.level_counts.sum(axis=0)
    print(f"[engine-matrix] (b) / (b') {len(engines)} engines restored at "
          f"tick {first.t}: level state torch.equal {same}", flush=True)
    if not same or any(e.t != T for e in engines.values()):
        _fail("(b) / (b') the restored engines' level state differs")

    runs = {}
    for w in (1, 4):
        eng = engines["(b)", w]
        runs[w] = (eng, _matrix_served(f"(b) per-lane, simulated, W={w}",
                                       eng, stream, counts0))
    _same_run("(b) W=1 vs W=4", *runs[1], *runs[4])
    if runs[1][0].commit_log != runs[4][0].commit_log:
        _fail("(b) the commit logs of W=1 and W=4 differ")
    _commit_log_checks("(b) W=4", runs[4][0], 2, t0=T)
    del runs

    runs = {}
    for w in (1, 4):
        eng = engines["(b')", w]
        runs[w] = (eng, _matrix_served(
            f"(b') per-lane, model expert, W={w}", eng, stream, counts0))
    _same_run("(b') W=1 vs W=4", *runs[1], *runs[4])
    if runs[1][0].commit_log != runs[4][0].commit_log:
        _fail("(b') the commit logs of W=1 and W=4 differ")
    # per-item labels, on the batches the engine sent (tick by tick), and
    # the shard sizes M they ran at (64 / W when every lane calls)
    from repro_torch.core.experts import shard_bounds
    n_cmp = n_diff = ragged = 0
    for t, called in enumerate(runs[1][0].history["expert_called"], T):
        idxs = [t * S + int(s) for s in np.flatnonzero(called)]
        if not idxs:
            continue
        docs = [stream.docs[i] for i in idxs]
        a = experts[1].poll(experts[1].submit_many(idxs, docs))
        b = experts[4].poll(experts[4].submit_many(idxs, docs))
        n_cmp += len(idxs)
        n_diff += int((a != b).sum())
        ragged += sum(hi - lo != S // w for w in (1, 4)
                      for lo, hi in shard_bounds(len(idxs), w))
    streams_ok = [s != torch.cuda.default_stream()
                  for s in experts[4].worker_streams()]
    # are the shard forwards' bits independent of the shard's batch?
    from repro_torch.data import hash_ids
    from repro_torch.models.students import tinytf_predict
    spec = expert.spec
    ids = torch.from_numpy(np.stack([hash_ids(d, spec.vocab, spec.max_len)
                                     for d in stream.docs[:64]])).cuda()
    with torch.no_grad():
        full = tinytf_predict(expert.params, ids, spec)
        part = tinytf_predict(expert.params, ids[:16], spec)
    bits = bool(torch.equal(full[:16], part))
    print(f"[engine-matrix] (b') per-item expert labels W=1 vs W=4: "
          f"{n_cmp} compared, {n_diff} differ, {ragged} shards at an M "
          f"other than {S} / W; shard probs bitwise equal "
          f"at M=16 vs inside M=64: {bits}; pool streams "
          f"{len(streams_ok)}, none the default stream: {all(streams_ok)}",
          flush=True)
    if n_cmp == 0 or ragged == 0:
        _fail("(b') the per-item label comparison saw no item at a "
              "ragged shard size")
    if n_diff or not streams_ok or not all(streams_ok):
        _fail("(b') the model expert's labels depend on W, or a pool "
              "worker ran on the default stream")
    for ex in experts.values():
        ex.close()
    del runs, engines

    # the process backend: children on the card, one CUDA context each
    import os
    import signal
    from repro_torch.core import ExpertWorkerDied
    idxs = list(range(MATRIX_BATCH))
    docs = [stream.docs[i] for i in idxs]
    want = expert.label_batch(idxs, docs)
    _sync()
    free0 = torch.cuda.mem_get_info()[0]
    px = ModelExpert(params=expert.params, spec=expert.spec, workers=2,
                     backend="process", device=MATRIX_DEVICE)
    try:
        t0 = time.time()
        got = px.poll(px.submit_many(idxs, docs))
        spawn_s = time.time() - t0
        old = px._executor
        n_children = len(old._processes)
        per_child = (free0 - torch.cuda.mem_get_info()[0]) / n_children
        for pid in list(old._processes):
            os.kill(pid, signal.SIGKILL)
        died = False
        try:
            px.poll(px.submit_many(idxs, docs))
        except ExpertWorkerDied:
            died = True
        t0 = time.time()
        again = px.poll(px.submit_many(idxs, docs))
        rebuild_s = time.time() - t0
        rebuilt = px._executor is not old
    finally:
        px.close()
    print(f"[engine-matrix] (b') process backend, "
          f"{n_children} children on the card: "
          f"labels equal the thread backend's "
          f"{bool(np.array_equal(got, want))} (first batch in "
          f"{spawn_s:.2f} s, spawn included); device memory per child "
          f"{per_child / 2**20:.1f} MiB (its CUDA context, its copy of "
          f"the expert, its allocator); children killed: next "
          f"ticket raised ExpertWorkerDied {died}, pool rebuilt {rebuilt}, "
          f"labels after the rebuild equal "
          f"{bool(np.array_equal(again, want))} ({rebuild_s:.2f} s)",
          flush=True)
    if not (np.array_equal(got, want) and np.array_equal(again, want)
            and rebuilt):
        _fail("(b') the process backend mislabels or was not rebuilt")
    return warm_s


def _unprofiled_rep(m):
    """A run served by ``run``: its items/s and ms a tick, no idle share."""
    return {"items_per_sec": m["items_per_sec"],
            "wall_ms_per_tick": 1e3 * MATRIX_BATCH / m["items_per_sec"],
            "device_idle_share": "not measured"}


def _unmeshed_side(eng, m, rep, by_variant):
    """What phase 14 holds a meshed run to, kept from an unmeshed run so
    that phase 14 need not serve it again: routing, predictions, expert
    calls, level counts, forwards by bucket, the route state (params,
    dparams) copied to the host, launches by variant, items/s, ms a tick
    and the idle share."""
    return {"routing": _routing_records(eng),
            "m": {k: m[k] for k in ("accuracy", "expert_calls",
                                    "predictions")},
            "level_counts": np.array(eng.level_counts),
            "forwards_by_batch": [dict(lvl.forwards_by_batch)
                                  for lvl in eng.levels],
            "state": [[x.detach().cpu() for x in
                       tree_leaves((lvl.params, lvl.dparams))]
                      for lvl in eng.levels],
            "by_variant": {n: dict(c) for n, c in by_variant.items()},
            "rep": rep}


def _matrix_pipeline(stream, phase4_launches):
    """(c) the kernel ladder in the learning regime, depth 2 against 0, at
    max_delay 0 and 2: identical runs, launches = layer-forwards.  Returns
    the depth-2 run's launches at max_delay 0, and the (max_delay 0,
    depth 0) and (max_delay 2, depth 2) runs as unmeshed sides."""
    from repro_torch.core import SimulatedExpert
    pipelined = None
    unmeshed = {}
    for D in (0, 2):
        runs = {}
        for P in (0, 2):
            for fn in LAUNCHERS.values():
                fn.launches = 0
            _zero_variant_counts()
            gmm0 = moe_gmm_cuda.launches
            eng = _matrix_engine("kernel", SimulatedExpert(stream),
                                 max_delay=D, pipeline_depth=P)
            tag = f"(c) kernel ladder, max_delay={D}, pipeline_depth={P}"
            if D == 0:
                m, rep = _profiled(tag, eng, stream)
            else:
                m = _matrix_run(tag, eng, stream)
                rep = _unprofiled_rep(m)
            launches = {n: fn.launches for n, fn in LAUNCHERS.items()}
            expect = _layer_forwards(eng)[0]
            by_variant = {n: c for n, c in _variant_counts().items()
                          if n in LAUNCHERS}
            print(f"[engine-matrix] {tag}: launches {launches} expected "
                  f"{expect}; by variant {by_variant}; moe_gmm "
                  f"{moe_gmm_cuda.launches - gmm0}", flush=True)
            if launches != expect or min(launches.values()) <= 0:
                _fail(f"{tag}: launches {launches} != layer-forwards "
                      f"{expect}")
            if by_variant["flash_attention"]["tiled"] != \
                    launches["flash_attention"]:
                _fail(f"{tag}: a flash launch left the tiled variant")
            if by_variant["ssd_scan"]["whole"] != launches["ssd_scan"]:
                _fail(f"{tag}: an SSD launch left the whole-chunk variant")
            runs[P] = (eng, m, launches, by_variant)
            if D == P:
                unmeshed[D, P] = _unmeshed_side(eng, m, rep, by_variant)
        _same_run(f"(c) max_delay={D}: depth 0 vs 2", runs[0][0], runs[0][1],
                  runs[2][0], runs[2][1])
        if runs[0][2] != runs[2][2]:
            _fail(f"(c) max_delay={D}: launches differ with depth")
        if D == 0:
            if runs[0][2] != phase4_launches:
                _fail(f"(c) depth 0 launches {runs[0][2]} != phase 4's "
                      f"{phase4_launches}")
            if runs[2][0].pipeline_stats["refetches"] <= 0:
                _fail("(c) the learning regime refetched nothing")
            pipelined = runs[2][2:]
    return pipelined, unmeshed


def _matrix_converged(stream):
    """(d) both ladders with hard_budget=0 (no expert traffic), depth 2
    against 0, profiled; the default ladder's learning regime too."""
    from repro_torch.core import SimulatedExpert
    for ladder, hb in (("default", 0), ("kernel", 0), ("default", None)):
        regime = "converged" if hb == 0 else "learning"
        runs = {}
        for P in (0, 2):
            eng = _matrix_engine(ladder, SimulatedExpert(stream),
                                 hard_budget=hb, pipeline_depth=P)
            runs[P] = (eng, _profiled(
                f"(d) {ladder} ladder, {regime}, pipeline_depth={P}", eng,
                stream)[0])
        _same_run(f"(d) {ladder} {regime}: depth 0 vs 2", *runs[0],
                  *runs[2])
        st = runs[2][0].pipeline_stats
        n_ticks = MATRIX_ITEMS // MATRIX_BATCH
        if st["submitted"] != n_ticks or st["resolved"] != n_ticks:
            _fail(f"(d) {ladder}: submitted/resolved {st}")
        if hb == 0 and (st["refetches"] or st["update_fences"]
                        or st["budget_fences"]):
            _fail(f"(d) {ladder} converged: speculation fenced {st}")


def _matrix_faults(stream):
    """(e) faults and the fleet: FlakyExpert (seeded) over the simulated
    expert, requeues, drops and autoscale; the fleet log against the
    CPU's on the same stream."""
    from repro_torch.core import FlakyExpert, SimulatedExpert
    logs = {}
    for dev in (MATRIX_DEVICE, "cpu"):
        ex = FlakyExpert(SimulatedExpert(stream, workers="auto"),
                         **MATRIX_FAULTS)
        eng = _matrix_engine("default", ex, device=dev, max_delay=2,
                             expert_timeout=MATRIX_TIMEOUT, max_requeues=2,
                             autoscale=(1, 8))
        _matrix_run(f"(e) faults + autoscale on {dev}", eng, stream)
        inj, fs = ex.injected, eng.fault_stats
        events = inj["timeout"] + inj["die"]
        print(f"[engine-matrix] (e) {dev}: injected {inj}; fleet_log "
              f"{eng.fleet_log}", flush=True)
        if (fs["timeouts"], fs["worker_deaths"]) != (inj["timeout"],
                                                     inj["die"]) \
                or events == 0 or fs["requeues"] > events \
                or (fs["requeues"] < events) != (
                    fs["dropped_annotations"] > 0) \
                or len(eng._pending):
            _fail(f"(e) {dev}: a fault was neither requeued nor counted "
                  f"as dropped: injected {inj}, stats {fs}")
        logs[dev] = (list(eng.fleet_log), dict(fs))
    same = logs[MATRIX_DEVICE] == logs["cpu"]
    print(f"[engine-matrix] (e) card vs CPU: fleet_log and fault_stats "
          f"identical {same}", flush=True)
    if logs[MATRIX_DEVICE][0] != logs["cpu"][0]:
        _fail("(e) the card's fleet log differs from the CPU's")


def _matrix_card_vs_cpu():
    """(f) 48 items at batch 8, max_delay 2, per-lane commits, depth 2:
    routing on the card equal to the CPU's."""
    from repro_torch.core import SimulatedExpert
    from repro_torch.data import make_stream
    small = make_stream("imdb", seed=0, n_samples=48)
    recs = {}
    for dev in (MATRIX_DEVICE, "cpu"):
        eng = _matrix_engine("default", SimulatedExpert(small), device=dev,
                             n_streams=8, max_delay=2, per_lane=True,
                             pipeline_depth=2)
        _matrix_run(f"(f) 48 items at batch 8 on {dev}", eng, small)
        recs[dev] = _routing_records(eng)
    div = _first_divergence(recs[MATRIX_DEVICE], recs["cpu"])
    print(f"[engine-matrix] (f) card vs CPU, 48 items at batch 8, "
          f"max_delay=2 per-lane depth 2: routing "
          f"{'identical' if div is None else 'DIFFERS'} over "
          f"{len(recs['cpu'])} ticks", flush=True)
    if div is not None:
        _fail(f"(f) card and CPU routing part at tick {div[0]}, lane "
              f"{div[1]} ({div[2]})")


def phase_engine_matrix(phase4_launches):
    """Phase 8: the engine matrix at full width (imdb, 2048 items, batch
    64, seed 0, mu 3e-7).  Returns the pipelined kernel-ladder run's
    launches and launches by variant ((c), max_delay 0, depth 2), and
    (c)'s depth-0 / max_delay-0 and depth-2 / max_delay-2 runs as phase
    14's unmeshed sides (``_unmeshed_side``), and (b)'s warm run's
    seconds."""
    from repro_torch.data import make_stream
    stream = make_stream("imdb", seed=0, n_samples=MATRIX_ITEMS)
    expert = _matrix_async(stream)
    warm_s = _matrix_pool(expert)
    expert.close()
    pipelined, unmeshed = _matrix_pipeline(stream, phase4_launches)
    _matrix_converged(stream)
    _matrix_faults(stream)
    _matrix_card_vs_cpu()
    return pipelined, unmeshed, warm_s


# ---------------------------------------------------------------------------
# checkpoint-admission: live-state checkpoints and the admission front-end
# on the kernel ladder at full width (imdb, seed 0, mu 3e-7, 64 lanes)
# ---------------------------------------------------------------------------
ADMIT_CUT = 16            # (a): save every 16 ticks, resume at tick 16
ADMIT_LANE_ITEMS, ADMIT_LANE_CUT = 512, 4     # (a'): 8 ticks, cut at 4
ADMIT_FE_TICKS = 16       # (e): serve 16 ticks, save, resume


class _PhaseCounts:
    """Kernel launches over a phase (9 or 10, named ``phase``), summed
    from runs each counted from zero, and the flash calls by padded batch
    over the same runs."""

    def __init__(self, phase):
        self.phase = phase
        self.launches = dict.fromkeys(LAUNCHERS, 0)
        self.flash_by_batch = {}

    def run(self, tag, engines, fn):
        """Zero every count, run ``fn``, read the counts: each kernel must
        have launched as often as the layer forwards ``engines`` counted
        (their forwards start at 0: fresh engines)."""
        for lf in LAUNCHERS.values():
            lf.launches = 0
        _zero_variant_counts()
        out = fn()
        _sync()
        got = {n: lf.launches for n, lf in LAUNCHERS.items()}
        by_variant = {n: c for n, c in _variant_counts().items()
                      if n in LAUNCHERS}
        expect = dict.fromkeys(LAUNCHERS, 0)
        flash_b = {}
        for eng in engines():
            e, fb = _layer_forwards(eng)
            for n in expect:
                expect[n] += e[n]
            for b, c in fb.items():
                flash_b[b] = flash_b.get(b, 0) + c
        print(f"[{self.phase}] {tag}: launches {got} expected "
              f"{expect}; flash calls by batch {dict(sorted(flash_b.items()))}",
              flush=True)
        if got != expect or min(got.values()) <= 0:
            _fail(f"{tag}: launches {got} != the layer forwards {expect}")
        if by_variant["flash_attention"]["tiled"] != got["flash_attention"]:
            _fail(f"{tag}: a flash launch left the tiled variant")
        if by_variant["ssd_scan"]["whole"] != got["ssd_scan"]:
            _fail(f"{tag}: an SSD launch left the whole-chunk variant")
        for n in got:
            self.launches[n] += got[n]
        for b, c in flash_b.items():
            self.flash_by_batch[b] = self.flash_by_batch.get(b, 0) + c
        return out, got, by_variant


def _admit_engine(expert, device=None, n_streams=None, **opts):
    """The kernel ladder at full width, history (and commit log) on."""
    return _matrix_engine("kernel", expert, device=device,
                          n_streams=n_streams, **opts)


def _run_report(tag, m, wall, n):
    print(f"[checkpoint-admission] {tag}: items_per_sec={n / wall:.1f} "
          f"wall_s={wall:.2f} accuracy={m['accuracy']:.4f} "
          f"expert_calls={m['expert_calls']} level_fractions="
          f"{[round(float(f), 4) for f in m['level_fractions']]}",
          flush=True)


def _ckpt_bytes(path):
    return sum(p.stat().st_size for p in Path(path).iterdir())


def _reckoned_bytes(eng):
    """The checkpoint's array bytes from the engine's shapes: each level's
    params, optimizer moments and deferral state, the rings, and the
    pending records' host arrays."""
    from repro_torch.core import STATE_ATTRS
    state = sum(x.numel() * x.element_size() for lvl in eng.levels
                for attr in STATE_ATTRS
                for x in tree_leaves(getattr(lvl, attr)))
    rings = sum(x.numel() * x.element_size()
                for x in eng._cache_x + eng._cache_y)
    pend = sum(a.nbytes for r in eng._pending
               for a in [r.called, r.sel_c, r.probs, r.dprob] + r.feats)
    return state, rings, pend


def _rings_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(a._cache_x + a._cache_y, b._cache_x + b._cache_y))


def _admit_resume(stream, counts, tmp):
    """(a) 32 ticks uninterrupted; the same with run(checkpoint_every=16);
    a fresh engine restored from that checkpoint finishes the stream:
    bitwise the uninterrupted run from tick 16 on.  At max_delay 0 and at
    max_delay 2, pipeline_depth 2.  Returns the max_delay-0 run 1."""
    from repro_torch.core import SimulatedExpert
    S = MATRIX_BATCH
    classic = None
    for D, P in ((0, 0), (2, 2)):
        opts = {"max_delay": D, "pipeline_depth": P}
        tag = f"(a) max_delay={D} pipeline_depth={P}"
        path = str(Path(tmp) / f"a{D}")
        e1 = _admit_engine(SimulatedExpert(stream), **opts)
        t0 = time.time()
        m1, _, _ = counts.run(f"{tag} run 1", lambda: [e1],
                              lambda: e1.run(stream))
        _run_report(f"{tag} run 1 (uninterrupted)", m1, time.time() - t0,
                    len(stream))
        e2 = _admit_engine(SimulatedExpert(stream), **opts)
        save_ms = []
        save = e2.save_state

        def timed_save(p):
            _sync()
            t = time.perf_counter()
            save(p)
            save_ms.append((time.perf_counter() - t) * 1e3)
        e2.save_state = timed_save
        t0 = time.time()
        m2, _, _ = counts.run(
            f"{tag} run 2", lambda: [e2],
            lambda: e2.run(stream, checkpoint_every=ADMIT_CUT,
                           checkpoint_path=path))
        _run_report(f"{tag} run 2 (checkpoint every {ADMIT_CUT})", m2,
                    time.time() - t0, len(stream))
        e3 = _admit_engine(SimulatedExpert(stream), **opts)
        _sync()
        t = time.perf_counter()
        e3.restore_state(path)
        _sync()
        restore_ms = (time.perf_counter() - t) * 1e3
        reck = _reckoned_bytes(e3)
        nbytes = _ckpt_bytes(path)
        first = e3.t * S
        t0 = time.time()
        m3, _, _ = counts.run(f"{tag} run 3", lambda: [e3],
                              lambda: e3.run(stream))
        _run_report(f"{tag} run 3 (restored at tick {first // S})", m3,
                    time.time() - t0, len(stream) - first)
        same_pred = bool(np.array_equal(m1["predictions"][first:],
                                        m3["predictions"][first:]))
        same_state = _states_equal(e1, e3) and _rings_equal(e1, e3)
        same_run2 = _states_equal(e1, e2) and bool(np.array_equal(
            m1["predictions"], m2["predictions"]))
        print(f"[checkpoint-admission] {tag}: checkpoint {nbytes} bytes "
              f"(reckoned: state {reck[0]}, rings {reck[1]}, pending "
              f"{reck[2]} at restore), save ms {save_ms}, restore ms "
              f"{restore_ms:.3f}; resumed at item {first}: predictions "
              f"identical {same_pred}, expert calls {m1['expert_calls']} / "
              f"{m3['expert_calls']}, every parameter and optimizer leaf "
              f"and ring torch.equal {same_state}; run 2 = run 1 "
              f"{same_run2}", flush=True)
        if (first != ADMIT_CUT * S or not same_pred or not same_state
                or m1["expert_calls"] != m3["expert_calls"]
                or not same_run2 or len(save_ms) != 1):
            _fail(f"{tag}: the resumed run is not bitwise the "
                  "uninterrupted one")
        if D == 0:
            classic = (e1, m1)
    return classic


def _admit_lane_resume(tmp):
    """(a') per-lane commits at max_delay 2, SimulatedExpert(workers=4,
    adversarial latency), 512 items (8 ticks), cut at tick 4 with
    per-lane records caught mid-consumption: bitwise the uninterrupted
    run."""
    from repro_torch.core import SimulatedExpert
    from repro_torch.data import make_stream
    S = MATRIX_BATCH
    small = make_stream("imdb", seed=0, n_samples=ADMIT_LANE_ITEMS)
    opts = {"max_delay": 2, "per_lane": True}

    def build():
        return _admit_engine(SimulatedExpert(small, workers=4,
                                             latency=_pool_latency), **opts)
    full = build()
    t0 = time.time()
    mf = full.run(small)
    _sync()
    _run_report("(a') per-lane, W=4, uninterrupted", mf, time.time() - t0,
                len(small))
    _student_routed("[checkpoint-admission] (a') uninterrupted",
                    mf["level_fractions"])
    part = build()
    for t in range(ADMIT_LANE_CUT):
        idxs = list(range(t * S, (t + 1) * S))
        part.process_tick(idxs, [small.docs[i] for i in idxs])
    mid = [(r.t, r.committed, int(r.sel_c.size)) for r in part._pending]
    path = str(Path(tmp) / "lane")
    part.save_state(path)
    part.close()
    res = build()
    res.restore_state(path)
    t0 = time.time()
    mr = res.run(small)
    _sync()
    first = ADMIT_LANE_CUT * S
    _run_report(f"(a') per-lane, restored at tick {ADMIT_LANE_CUT}", mr,
                time.time() - t0, len(small) - first)
    _student_routed(f"[checkpoint-admission] (a') restored at tick "
                    f"{ADMIT_LANE_CUT}", mr["level_fractions"])
    same = (bool(np.array_equal(mf["predictions"][first:],
                                mr["predictions"][first:]))
            and mf["expert_calls"] == mr["expert_calls"]
            and full.commit_log == res.commit_log
            and _states_equal(full, res) and _rings_equal(full, res))
    print(f"[checkpoint-admission] (a') pending at the cut (tick, "
          f"committed, k): {mid}; resumed bitwise {same}", flush=True)
    if not any(0 < c < k for _, c, k in mid):
        _fail("(a') no per-lane record was caught mid-consumption")
    if not same:
        _fail("(a') the per-lane resume is not bitwise the uninterrupted "
              "run")


def _frontend_report(tag, fe, eng, stream, wall):
    m = fe.metrics()
    served = m["predictions"] >= 0
    acc = float(np.mean(m["predictions"][served]
                        == stream.labels[served])) if served.any() else 0.0
    print(f"[checkpoint-admission] {tag}: ticks={m['ticks']} "
          f"idle_ticks={m['idle_ticks']} occupancy_mean="
          f"{m['occupancy_mean']:.3f}/{eng.n_streams} tta_p50="
          f"{m['tta_p50']} tta_p99={m['tta_p99']} queue_delay_mean="
          f"{m['queue_delay_mean']:.3f} requests={m['requests']} "
          f"answered={m['answered']} shed={m['shed']} goodput_items_per_"
          f"sec={m['items_done'] / wall:.1f} wall_s={wall:.2f} "
          f"accuracy={acc:.4f} expert_calls={eng.expert_calls_total} "
          f"level_fractions={[round(float(f), 4) for f in eng.level_counts.sum(axis=0) / max(m['items_done'], 1)]}",
          flush=True)
    return m


def _record_fields(fe):
    return {rid: (r.arrival, r.admit, r.lane, r.done, r.retired, r.shed,
                  r.items_done, r.expert_calls, r.predictions, r.levels,
                  r.commit_ticks)
            for rid, r in fe.records.items()}


def _frontend_run(tag, counts, stream, requests, *, device=None,
                    n_streams=None, admission="queue", queue_limit=0,
                    count=True, **opts):
    from repro_torch.core import CascadeFrontEnd, SimulatedExpert
    eng = _admit_engine(SimulatedExpert(stream), device=device,
                        n_streams=n_streams, **opts)
    fe = CascadeFrontEnd(eng, stream, admission=admission,
                         queue_limit=queue_limit)
    t0 = time.time()
    if count:
        _, got, by_variant = counts.run(tag, lambda: [eng],
                                        lambda: fe.serve(requests))
    else:
        fe.serve(requests)
        got = by_variant = None
    _sync()
    m = _frontend_report(tag, fe, eng, stream, time.time() - t0)
    return eng, fe, m, (got, by_variant)


def _same_frontend(tag, a, fa, b, fb):
    same = (fa.admission_log == fb.admission_log
            and _record_fields(fa) == _record_fields(fb)
            and bool(np.array_equal(fa.metrics()["predictions"],
                                    fb.metrics()["predictions"]))
            and _states_equal(a, b))
    print(f"[checkpoint-admission] {tag}: admission log, every record, "
          f"the predictions and every parameter identical {same}",
          flush=True)
    if not same:
        _fail(f"{tag}: the two front-end runs differ")


def phase_checkpoint_admission():
    """Phase 9: live-state checkpoints and the admission front-end on the
    kernel ladder at full width.  Returns (c)'s launches and launches by
    variant (depth 0) for the kernel record."""
    import tempfile
    from repro_torch.core import CascadeFrontEnd, SimulatedExpert
    from repro_torch.data import (burst_requests, lockstep_requests,
                                  make_stream, poisson_requests)
    t_phase = time.time()
    stream = make_stream("imdb", seed=0, n_samples=MATRIX_ITEMS)
    counts = _PhaseCounts("checkpoint-admission")
    with tempfile.TemporaryDirectory() as tmp:
        e_classic, m_classic = _admit_resume(stream, counts, tmp)
        _admit_lane_resume(tmp)

        # (b) lockstep through the front-end == the classic run
        e_b, fe_b, _, _ = _frontend_run(
            "(b) lockstep_requests(2048, 64)", counts, stream,
            lockstep_requests(MATRIX_ITEMS, MATRIX_BATCH))
        levels = [np.concatenate(e.history["level"])
                  for e in (e_classic, e_b)]
        same = (bool(np.array_equal(m_classic["predictions"],
                                    fe_b.metrics()["predictions"]))
                and bool(np.array_equal(*levels))
                and m_classic["expert_calls"] == e_b.expert_calls_total
                and _states_equal(e_classic, e_b))
        print(f"[checkpoint-admission] (b) lockstep front-end vs the "
              f"classic run: predictions, levels, expert calls and every "
              f"parameter identical {same}", flush=True)
        if not same:
            _fail("(b) the lockstep schedule is not bitwise the classic run")
        del e_classic, e_b, fe_b

        # (c) Poisson arrivals near capacity, depth 0 and depth 2
        reqs = poisson_requests(MATRIX_ITEMS, rate=8, mean_len=8, seed=0)
        e_c, fe_c, _, admission = _frontend_run(
            "(c) poisson rate 8, pipeline_depth=0", counts, stream, reqs)
        e_c2, fe_c2, _, _ = _frontend_run(
            "(c) poisson rate 8, pipeline_depth=2", counts, stream, reqs,
            pipeline_depth=2)
        _same_frontend("(c) depth 0 vs depth 2", e_c, fe_c, e_c2, fe_c2)
        del e_c2, fe_c2

        # (d) bursts beyond the lanes with shedding
        breqs = burst_requests(MATRIX_ITEMS, burst=96, every=8, mean_len=8,
                               seed=0)
        _, fe_d, m_d, _ = _frontend_run(
            "(d) burst 96 every 8, shed, queue_limit 16", counts, stream,
            breqs, admission="shed", queue_limit=16)
        accounted = all(r.shed != r.answered for r in fe_d.records.values())
        print(f"[checkpoint-admission] (d) {m_d['requests']} offered: "
              f"{m_d['answered']} answered, {m_d['shed']} shed, each one "
              f"or the other {accounted}; tta p50 {m_d['tta_p50']} p99 "
              f"{m_d['tta_p99']} ticks, mean queue delay "
              f"{m_d['queue_delay_mean']:.3f}", flush=True)
        if m_d["shed"] < 1 or not accounted or \
                m_d["answered"] + m_d["shed"] != len(breqs):
            _fail("(d) shedding did not account for every request")

        # (e) the front-end's checkpoint, resumed in a fresh engine
        path = str(Path(tmp) / "fe")
        e_p = _admit_engine(SimulatedExpert(stream))
        fe_p = CascadeFrontEnd(e_p, stream)
        fe_p.serve(reqs, max_ticks=ADMIT_FE_TICKS, finalize=False)
        fe_p.save_state(path)
        e_r = _admit_engine(SimulatedExpert(stream))
        fe_r = CascadeFrontEnd(e_r, stream)
        t0 = time.time()
        fe_r.restore_state(path, reqs)
        _sync()
        restore_ms = (time.time() - t0) * 1e3
        print(f"[checkpoint-admission] (e) saved after tick {e_p.t}, "
              f"{_ckpt_bytes(path)} bytes + .frontend.json "
              f"{Path(path + '.frontend.json').stat().st_size} bytes, "
              f"restored in {restore_ms:.3f} ms", flush=True)
        t0 = time.time()
        counts.run("(e) resumed front-end", lambda: [e_r],
                   lambda: fe_r.serve(reqs))
        _frontend_report("(e) resumed front-end", fe_r, e_r, stream,
                         time.time() - t0)
        _same_frontend("(e) resumed vs (c) uninterrupted", e_c, fe_c, e_r,
                       fe_r)
        del e_p, fe_p, e_r, fe_r, e_c, fe_c

    # (f) card against CPU on a short staggered schedule
    small = make_stream("imdb", seed=0, n_samples=96)
    sreqs = poisson_requests(96, rate=1, mean_len=5, seed=3)
    runs = {}
    for dev in (MATRIX_DEVICE, "cpu"):
        eng, fe, _, _ = _frontend_run(
            f"(f) 96 items, 8 lanes on {dev}", counts, small, sreqs,
            device=dev, n_streams=8, count=False)
        runs[dev] = (_routing_records(eng), _record_fields(fe))
    div = _first_divergence(runs[MATRIX_DEVICE][0], runs["cpu"][0])
    same_rec = runs[MATRIX_DEVICE][1] == runs["cpu"][1]
    print(f"[checkpoint-admission] (f) card vs CPU: routing "
          f"{'identical' if div is None else f'differs {div}'}, records "
          f"identical {same_rec}", flush=True)
    if div is not None:
        _fail(f"(f) card and CPU routing part at tick {div[0]}, lane "
              f"{div[1]} ({div[2]})")
    if not same_rec:
        _fail("(f) card and CPU records differ")
    print(f"[checkpoint-admission] launches over the phase "
          f"{counts.launches}; flash calls by batch "
          f"{dict(sorted(counts.flash_by_batch.items()))}; phase seconds "
          f"{time.time() - t_phase:.1f}", flush=True)
    return admission


# ---------------------------------------------------------------------------
# sanitize-distill: the runtime sanitizers on the kernel ladder at full
# width (imdb, seed 0, mu 3e-7, 64 lanes) and the distillation baseline
# ---------------------------------------------------------------------------
SAN_LANE_ITEMS = 512      # (b) per-lane W=1 vs W=4, (e) the locked pool
SAN_CUT = 16              # (c) checkpoint at tick 16, resume
SAN_SMALL, SAN_SMALL_BATCH = 48, 8      # (d) card vs CPU; (h) CPU twin
SAN_RETRACE_BUCKETS = 4   # buckets 8 / 16 / 32 / 64 at 64 lanes
SAN_RETRACE_LIMIT = 16    # serve.py's retrace_check limit
DISTILL_BUDGETS = (TABLE1_BUDGET, MATRIX_ITEMS // 2)
DISTILL_EPOCHS = 3        # as benchmarks/common.py runs the reference


def _san_run(counts, tag, eng, stream):
    """Serve ``stream`` on ``eng`` with every kernel's launches counted
    from zero against its layer forwards; prints items/s, wall s, the
    level fractions and the share of items a student answered
    (``_student_routed``, failing at 0)."""
    t0 = time.time()
    m, got, by_variant = counts.run(tag, lambda: [eng],
                                    lambda: eng.run(stream))
    wall = time.time() - t0
    fr = [float(f) for f in m["level_fractions"]]
    print(f"[sanitize-distill] {tag}: items_per_sec="
          f"{m['items_per_sec']:.1f} wall_s={wall:.2f} accuracy="
          f"{m['accuracy']:.4f} expert_calls={m['expert_calls']} "
          f"level_fractions={[round(f, 4) for f in fr]}", flush=True)
    _student_routed(f"[sanitize-distill] {tag}", fr)
    return m, got, by_variant


def _san_same(tag, a, b, state=True):
    """Two determinism traces: ``diff_traces`` must be None (``state``
    False strips the state digests first)."""
    from repro_torch.analysis import sanitize as san
    if not state:
        a, b = ([{k: v for k, v in r.items() if k != "state"}
                 for r in tr.ticks] for tr in (a, b))
    d = san.diff_traces(a, b)
    print(f"[sanitize-distill] {tag}: {len(a)} / {len(b)} tick records, "
          f"state digests {'compared' if state else 'stripped'}: "
          f"{'identical' if d is None else d.describe()}", flush=True)
    if d is not None:
        _fail(f"{tag}: {d.describe()}")


def _san_retrace(eng, got):
    """(f) the distinct signatures of each staged function over the
    depth-0 run, beside the kernel launches and the flash calls by
    bucket: every route pass at most one signature per bucket."""
    from repro_torch.analysis import sanitize as san
    rep = san.retrace_report()
    _, flash_b = _layer_forwards(eng)
    print(f"[sanitize-distill] (f) retrace signatures "
          f"{dict(sorted(rep.items()))}; launches {got}; forwards by "
          f"bucket {[dict(sorted(lv.forwards_by_batch.items())) for lv in eng.levels]}; "
          f"flash calls by batch {flash_b}", flush=True)
    routes = {k: v for k, v in rep.items() if k.startswith("route_pass")}
    flagged = san.retrace_check(limit=SAN_RETRACE_LIMIT)
    if len(routes) != len(eng.levels) \
            or max(routes.values()) > SAN_RETRACE_BUCKETS or flagged:
        _fail(f"(f) route-pass signatures {routes} (at most "
              f"{SAN_RETRACE_BUCKETS} each) or past the limit {flagged}")


def _san_cost(stream):
    """(g) items/s with the determinism trace off and on, A B B A, and
    the host ms of one tick's state digests."""
    from repro_torch.analysis import sanitize as san
    from repro_torch.core import SimulatedExpert
    rates = {False: [], True: []}
    for on in (False, True, True, False):
        (san.enable if on else san.disable)({"determinism"})
        eng = _admit_engine(SimulatedExpert(stream), history_limit=0)
        t0 = time.time()
        eng.run(stream)
        _sync()
        rates[on].append(len(stream) / (time.time() - t0))
    nbytes = sum(x.numel() * x.element_size() for lvl in eng.levels
                 for attr in ("params", "opt_state", "dparams", "dopt_state")
                 for x in tree_leaves(getattr(lvl, attr)))
    t0 = time.time()
    for _ in range(10):
        san.state_digests(eng.levels)
    dig_ms = (time.time() - t0) / 10 * 1e3
    off, on = (sum(rates[k]) / 2 for k in (False, True))
    print(f"[sanitize-distill] (g) items_per_sec determinism off / on / on "
          f"/ off: {rates[False][0]:.1f} / {rates[True][0]:.1f} / "
          f"{rates[True][1]:.1f} / {rates[False][1]:.1f} (on / off "
          f"{on / off:.4f}); state digests of one tick: {nbytes} bytes in "
          f"{dig_ms:.3f} ms (host, one device-to-host copy)", flush=True)


def _san_locks(stream):
    """(e) the model expert's W=4 thread pool (one CUDA stream a thread)
    under the lock sanitizer: clean, no order violation; then one
    deliberate unguarded ticket read must raise."""
    from repro_torch.analysis import sanitize as san
    from repro_torch.core import ExpertTicket, ModelExpert
    from repro_torch.models.students import TinyTFSpec, tinytf_init
    spec = TinyTFSpec(d_model=256, n_layers=4, d_ff=1024, n_classes=2)
    san.enable({"locks"})
    try:
        ex = ModelExpert(params=tinytf_init(torch.Generator().manual_seed(0),
                                            spec, torch.device(MATRIX_DEVICE)),
                         spec=spec, workers=4, device=MATRIX_DEVICE)
        eng = _admit_engine(ex, max_delay=2, per_lane=True)
        t0 = time.time()
        try:
            m = eng.run(stream)
            _sync()
            n_streams = len(ex.worker_streams())
        finally:
            eng.close()
        violations = san.lock_order_violations()
        ticket = ExpertTicket(labels=np.array([1, 0, 1]))
        raised = False
        try:
            ticket._shards
        except san.LockSanitizerError as e:
            raised = True
            msg = str(e)
        print(f"[sanitize-distill] (e) W=4 thread pool under locks, "
              f"{len(stream)} items, per-lane max_delay 2: "
              f"{m['expert_calls']} expert calls in "
              f"{time.time() - t0:.2f} s, {n_streams} pool "
              f"streams, {len(violations)} order violations; a bare "
              f"ExpertTicket._shards read raised LockSanitizerError "
              f"{raised}" + (f" ({msg})" if raised else ""), flush=True)
        if violations or not raised or not n_streams:
            _fail("(e) the lock sanitizer saw an order violation or did "
                  "not catch an unguarded read, or no pool stream ran")
    finally:
        san.disable({"locks"})


def _san_distill(stream, cascade_preds):
    """(h) distill_students on the card at TinyTFSpec() widths: the lr
    and tinytf accuracy and recall at each budget, the seconds, the
    cascade's accuracy on the same test half; then 48 items on the CPU
    against the card (accuracies within one test item)."""
    from repro_torch.core import SimulatedExpert, distill_students
    from repro_torch.data import make_stream
    half = len(stream) // 2
    casc = float(np.mean(cascade_preds[half:] == stream.labels[half:]))
    for budget in DISTILL_BUDGETS:
        t0 = time.time()
        r = distill_students(stream, SimulatedExpert(stream), budget,
                             epochs=DISTILL_EPOCHS, seed=0,
                             device=MATRIX_DEVICE)
        _sync()
        print(f"[sanitize-distill] (h) distill budget {budget}: lr "
              f"{r['lr']}, tinytf {r['tinytf']} in {time.time() - t0:.2f} "
              f"s; the cascade (a) on the same {len(stream) - half} test "
              f"items: accuracy {casc:.4f}", flush=True)
        for st in ("lr", "tinytf"):
            if not 0.0 <= r[st]["accuracy"] <= 1.0:
                _fail(f"(h) {st} accuracy {r[st]['accuracy']}")
    small = make_stream("imdb", seed=0, n_samples=SAN_SMALL)
    res = {dev: distill_students(small, SimulatedExpert(small),
                                 SAN_SMALL // 2, epochs=DISTILL_EPOCHS,
                                 seed=0, device=dev)
           for dev in (MATRIX_DEVICE, "cpu")}
    one = 1.0 / (SAN_SMALL - SAN_SMALL // 2)
    gaps = {st: abs(res[MATRIX_DEVICE][st]["accuracy"]
                    - res["cpu"][st]["accuracy"]) for st in ("lr", "tinytf")}
    print(f"[sanitize-distill] (h) {SAN_SMALL} items, card vs CPU: "
          f"{ {st: (res[MATRIX_DEVICE][st], res['cpu'][st]) for st in gaps} }",
          flush=True)
    if max(gaps.values()) > one + 1e-12:
        _fail(f"(h) card and CPU distill accuracies differ by more than "
              f"one test item: {gaps}")


def phase_sanitize_distill():
    """Phase 10: the runtime sanitizers on the kernel ladder at full
    width, then the distillation baseline.  Returns (a)'s depth-0 run's
    launches and launches by variant for the kernel record."""
    import tempfile
    from repro_torch.analysis import sanitize as san
    from repro_torch.core import SimulatedExpert
    from repro_torch.data import make_stream
    t_phase = time.time()
    stream = make_stream("imdb", seed=0, n_samples=MATRIX_ITEMS)
    counts = _PhaseCounts("sanitize-distill")
    try:
        # (a) + (f): depth 0 and depth 2 under determinism and retrace
        san.enable({"determinism", "retrace"})
        traces = {}
        for depth in (0, 2):
            san.reset_retrace()
            eng = _admit_engine(SimulatedExpert(stream),
                                pipeline_depth=depth)
            m, got, by_variant = _san_run(
                counts, f"(a) determinism + retrace, pipeline_depth="
                f"{depth}", eng, stream)
            traces[depth] = san.trace_of(eng)
            if depth == 0:
                _san_retrace(eng, got)
                sanitized, preds0 = (got, by_variant), m["predictions"]
            del eng
        san.disable({"retrace"})
        _san_same("(a) depth 0 vs depth 2", traces[0], traces[2])

        # (b) per-lane commits at max_delay 2, W=1 vs W=4
        lane = make_stream("imdb", seed=0, n_samples=SAN_LANE_ITEMS)
        lane_tr = {}
        for w in (1, 4):
            eng = _admit_engine(
                SimulatedExpert(lane, workers=w,
                                latency=_pool_latency if w > 1 else None),
                per_lane=True, max_delay=2)
            _san_run(counts, f"(b) per-lane max_delay 2, W={w}", eng, lane)
            lane_tr[w] = san.trace_of(eng)
            del eng
        _san_same("(b) W=1 vs W=4", lane_tr[1], lane_tr[4])

        # (c) checkpoint at tick 16, resumed in a fresh engine
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "live")
            e_a = _admit_engine(SimulatedExpert(stream))
            S = e_a.n_streams
            for t in range(SAN_CUT):
                idxs = list(range(t * S, (t + 1) * S))
                e_a.process_tick(idxs, [stream.docs[i] for i in idxs])
            e_a.save_state(path)
            e_b = _admit_engine(SimulatedExpert(stream))
            e_b.restore_state(path)
            _san_run(counts, f"(c) resumed at tick {SAN_CUT}", e_b, stream)
            joined = san.concat_traces(san.trace_of(e_a), san.trace_of(e_b))
            del e_a, e_b
        _san_same(f"(c) checkpoint at tick {SAN_CUT} + resume vs "
                  "uninterrupted", joined, traces[0])
        del traces, lane_tr

        # (d) card against CPU, 48 items at batch 8
        small = make_stream("imdb", seed=0, n_samples=SAN_SMALL)
        small_tr = {}
        for dev in (MATRIX_DEVICE, "cpu"):
            eng = _admit_engine(SimulatedExpert(small), device=dev,
                                n_streams=SAN_SMALL_BATCH)
            eng.run(small)
            small_tr[dev] = san.trace_of(eng)
        rng_same = [r["rng"] for r in small_tr[MATRIX_DEVICE].ticks] == \
            [r["rng"] for r in small_tr["cpu"].ticks]
        print(f"[sanitize-distill] (d) card vs CPU: per-lane RNG digests "
              f"equal {rng_same}", flush=True)
        _san_same("(d) card vs CPU", small_tr[MATRIX_DEVICE],
                  small_tr["cpu"], state=False)
        if not rng_same:
            _fail("(d) card and CPU RNG digests differ")

        # (g) the trace's cost, A B B A
        _san_cost(stream)
    finally:
        san.disable()
    # (e) the lock sanitizer on the model expert's thread pool
    _san_locks(lane)
    # (h) the distillation baseline
    _san_distill(stream, preds0)
    print(f"[sanitize-distill] launches over the phase {counts.launches}; "
          f"flash calls by batch "
          f"{dict(sorted(counts.flash_by_batch.items()))}; phase seconds "
          f"{time.time() - t_phase:.1f}", flush=True)
    return sanitized


# ---------------------------------------------------------------------------
# the zoo: Mixtral-8x22B at full width, depth cut to ZOO_LAYERS
# ---------------------------------------------------------------------------
def zoo_model():
    """Full-width Mixtral-8x22B cut to ZOO_LAYERS layers, weights drawn
    on the card from a seeded generator, and the prompts."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config(ZOO_ARCH), n_layers=ZOO_LAYERS)
    t0 = time.time()
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    torch.cuda.synchronize()
    batch = next(lm_batches(cfg.vocab, ZOO_BATCH, ZOO_PROMPT, 1, seed=0))
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"[zoo] {cfg.name} at full width, {cfg.n_layers} of 56 layers: "
          f"{n / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"built in {time.time() - t0:.2f} s; prompts "
          f"{tuple(tokens.shape)} from lm_batches(seed=0)", flush=True)
    return cfg, params, tokens


def capture_zoo_inputs(cfg, params, tokens):
    """Run one prefill and one decode step and record the inputs each
    kernel op gets in layer 0 (the first call of each kind; for moe_gmm
    the up and down projections of the first MoE group)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    got = {}
    real = {"moe_gmm": moe_mod.moe_gmm,
            "flash_attention": attn_mod.flash_attention,
            "decode_attention": attn_mod.decode_attention}
    stage = {"now": "prefill", "gmm_calls": 0}

    def rec_gmm(x, w):
        stage["gmm_calls"] += 1
        k = stage["gmm_calls"]
        if k in (1, 3):
            got.setdefault((stage["now"], "up" if k == 1 else "down"),
                           (x, w))
        return real["moe_gmm"](x, w)

    def rec(name):
        def f(*args, **kw):
            got.setdefault(name, (args, kw))
            return real[name](*args, **kw)
        return f

    try:
        moe_mod.moe_gmm = rec_gmm
        attn_mod.flash_attention = rec("flash_attention")
        attn_mod.decode_attention = rec("decode_attention")
        with torch.no_grad():
            last, cache = tfm.prefill(params, {"tokens": tokens}, cfg)
            stage.update(now="decode", gmm_calls=0)
            tfm.decode_step(params, cache, last.argmax(-1)[:, None],
                            tokens.shape[1], cfg)
    finally:
        moe_mod.moe_gmm = real["moe_gmm"]
        attn_mod.flash_attention = real["flash_attention"]
        attn_mod.decode_attention = real["decode_attention"]
    torch.cuda.synchronize()
    return got


def phase_zoo_kernels(cfg, params, tokens):
    got = capture_zoo_inputs(cfg, params, tokens)
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def gmm_row(label, x, w, variant, timed=True, reps=10):
        tol = ZOO_TOL["bf16" if x.dtype == torch.bfloat16 else "fp32"]
        check("moe_gmm", label, lambda: gmm_ops.moe_gmm(x, w),
              lambda: gmm_ref(x, w), tol, results,
              lambda: torch.bmm(x, w), gmm_bound(x, w), timed,
              relative=True, reps=reps, variant=variant)

    # captured layer-0 inputs: prefill C=640 up/down, decode C=4 up/down
    for stage in ("prefill", "decode"):
        for proj in ("up", "down"):
            x, w = got[(stage, proj)]
            _, C, D = x.shape
            gmm_row(f"path {stage} {proj} C={C} D={D} F={w.shape[2]}",
                    x, w, "tc")
    # O(1) random at the path shapes, fp32, ragged
    for stage in ("prefill", "decode"):
        x, w = got[(stage, "up")]
        gmm_row(f"random O(1) {stage} C={x.shape[1]}", rnd(*x.shape),
                rnd(*w.shape), "tc", timed=False)
    x, w = got[("prefill", "up")]
    gmm_row(f"fp32 prefill C={x.shape[1]}", x.float(), w.float(), "simt",
            reps=5)
    xd, wd = got[("decode", "up")]
    gmm_row(f"fp32 decode C={xd.shape[1]}", xd.float(), wd.float(), "simt",
            timed=False)
    # rows TMA cannot read (F or D rows not a multiple of 16 bytes) stay on
    # the scalar kernel; ragged but readable ones take both tc tiles and
    # their boundary (C = 9 is the prefill tile's first C)
    for E, C, D, F_ in ((3, 130, 1000, 1031), (2, 5, 777, 1029)):
        for dt in (torch.bfloat16, torch.float32):
            gmm_row(f"ragged E{E} C{C} D{D} F{F_} "
                    f"{str(dt).split('.')[-1]}", rnd(E, C, D, dtype=dt),
                    rnd(E, D, F_, dtype=dt), "simt", timed=False)
    for E, C, D, F_ in ((3, 130, 1000, 1040), (2, 5, 1000, 1040),
                        (2, 9, 512, 1024)):
        gmm_row(f"ragged E{E} C{C} D{D} F{F_} bf16", rnd(E, C, D),
                rnd(E, D, F_), "tc", timed=False)
    # an odd F read through a slice of a wider w (rows of 2080 bytes)
    gmm_row("ragged E3 C130 D1000 F1029 of F1040 bf16", rnd(3, 130, 1000),
            rnd(3, 1000, 1040)[..., :1029], "tc", timed=False)

    (q, k, v), kw = got["flash_attention"]
    check("flash_attention", f"path zoo prefill S={q.shape[1]} "
          f"H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]}",
          lambda: fl_ops.flash_attention(q, k, v, **kw),
          lambda: flash_plain(q, k, v, **kw), ZOO_TOL["bf16"], results,
          lambda: flash_library(q, k, v, **kw), flash_bound(q, k, v, **kw),
          True, relative=True, reps=10, variant="tc")
    qr, kr, vr = rnd(*q.shape), rnd(*k.shape), rnd(*v.shape)
    check("flash_attention", "random O(1) zoo prefill",
          lambda: fl_ops.flash_attention(qr, kr, vr, **kw),
          lambda: flash_plain(qr, kr, vr, **kw), ZOO_TOL["bf16"], results,
          relative=True, variant="tc")
    # the tensor-core variant off the path's shape: a ragged S, a window
    # that cuts inside the sequence, non-causal GQA 6, head dim 64
    for label, (B, S, H, K, hd, causal, window) in {
            "bf16 ragged S=1000 causal": (1, 1000, 48, 8, 128, True, None),
            "bf16 S=2048 window 1024": (1, 2048, 8, 2, 128, True, 1024),
            "bf16 non-causal GQA 6 S=512": (2, 512, 12, 2, 128, False,
                                             None),
            "bf16 hd 64 S=2048": (1, 2048, 16, 4, 64, True, None),
    }.items():
        qe, ke, ve = rnd(B, S, H, hd), rnd(B, S, K, hd), rnd(B, S, K, hd)
        check("flash_attention", label,
              lambda: fl_ops.flash_attention(qe, ke, ve, causal=causal,
                                             window=window),
              lambda: flash_plain(qe, ke, ve, causal, window),
              ZOO_TOL["bf16"], results, relative=True, variant="tc")
    (q, k, v, pos), kw = got["decode_attention"]
    check("decode_attention", f"path zoo decode W={k.shape[1]} "
          f"H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]}",
          lambda: dec_ops.decode_attention(q, k, v, pos, **kw),
          lambda: decode_plain(q, k, v, pos), ZOO_TOL["bf16"], results,
          lambda: decode_library(q, k, v, pos),
          decode_bound(q, k, v, pos), True, relative=True, variant="split")
    qr, kr, vr = rnd(*q.shape), rnd(*k.shape), rnd(*v.shape)
    W = k.shape[1]
    posr = torch.where(torch.arange(W) < W - 300, torch.arange(W),
                       torch.full((W,), -1)).to("cuda", torch.int32)
    check("decode_attention", "random O(1) zoo decode, 300 empty slots",
          lambda: dec_ops.decode_attention(qr, kr, vr, posr),
          lambda: decode_plain(qr, kr, vr, posr), ZOO_TOL["bf16"], results,
          relative=True, variant="split")
    # no valid slot: every split averages its values, the combine weighs
    # them alike, as the reference's softmax over -1e30 does
    pos0 = torch.full((W,), -1, device="cuda", dtype=torch.int32)
    check("decode_attention", "random O(1) zoo decode, every slot empty",
          lambda: dec_ops.decode_attention(qr, kr, vr, pos0),
          lambda: decode_plain(qr, kr, vr, pos0), ZOO_TOL["bf16"], results,
          relative=True, variant="split")
    return results


def _zoo_expected(cfg, n_tokens, n_decode):
    """Launches each zoo phase implies: the prefill runs 3 grouped
    products per MoE group and MoE layer, one flash call per ATTN and
    encoder layer and two per CROSS layer (causal self-attention, then
    cross-attention over the memory), and one SSD scan per MAMBA layer;
    each decode step 3 grouped products per MoE layer and one
    decode-attention call per ATTN layer and two per CROSS layer (a
    MAMBA layer's step is plain PyTorch)."""
    from repro_torch.configs import ATTN, CROSS, MAMBA
    from repro_torch.models.moe import MOE_GROUP
    P = cfg.n_periods
    n_attn, n_mamba = P * cfg.period.count(ATTN), P * cfg.period.count(MAMBA)
    n_cross = P * cfg.period.count(CROSS)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    n_moe = P * len(cfg.moe_period_idx) if cfg.moe is not None else 0
    groups = n_tokens // MOE_GROUP if n_tokens % MOE_GROUP == 0 else 1
    return {"prefill": {"moe_gmm": 3 * groups * n_moe,
                        "flash_attention": n_attn + 2 * n_cross + n_enc,
                        "decode_attention": 0, "ssd_scan": n_mamba},
            "decode": {"moe_gmm": 3 * n_moe * n_decode, "flash_attention": 0,
                       "decode_attention": (n_attn + 2 * n_cross) * n_decode,
                       "ssd_scan": 0}}


def _zero_zoo_counts():
    for fn in ZOO_LAUNCHERS.values():
        fn.launches = 0
    _zero_variant_counts()


def phase_zoo_serve(cfg, params, tokens):
    """The zoo's serving path: prefill + ZOO_DECODE greedy steps.  Every
    kernel's count is set to zero just before each phase and read just
    after it, so each phase's launches are its own.  Also returns the
    prefill's and the first MS_DECODE steps' logits and the greedy tokens
    fed, which phase 15 holds its meshed runs to."""
    from repro_torch.models import transformer as tfm
    B, S = tokens.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out_tokens = []
    launches, by_variant = {}, {}
    with torch.no_grad():
        _zero_zoo_counts()
        t0 = time.perf_counter()
        last, cache = tfm.prefill(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches["prefill"] = {n: fn.launches
                               for n, fn in ZOO_LAUNCHERS.items()}
        by_variant["prefill"] = _variant_counts()
        _zero_zoo_counts()
        tok = last.argmax(-1)
        outputs = {"logits": [last], "tokens": []}
        for step in range(ZOO_DECODE):
            out_tokens.append(tok)
            logits, cache = tfm.decode_step(params, cache, tok[:, None],
                                            S + step, cfg)
            tok = logits.argmax(-1)
            if step < MS_DECODE:
                outputs["logits"].append(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches["decode"] = {n: fn.launches
                              for n, fn in ZOO_LAUNCHERS.items()}
        by_variant["decode"] = _variant_counts()
    outputs["tokens"] = out_tokens[:MS_DECODE + 1]
    expect = _zoo_expected(cfg, B * S, ZOO_DECODE)
    m = {"prefill_ms": (t1 - t0) * 1e3,
         "decode_ms_per_step": (t2 - t1) * 1e3 / ZOO_DECODE,
         "decode_tokens_per_s": B * ZOO_DECODE / (t2 - t1),
         "prefill_tokens_per_s": B * S / (t1 - t0),
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    gen = torch.stack(out_tokens, 1)
    print("[zoo-serve] " + " ".join(f"{k}={v:.6g}" for k, v in m.items()))
    print(f"[zoo-serve] launches {launches} expected {expect}; greedy "
          f"tokens row 0: {gen[0].tolist()}", flush=True)
    print(f"[zoo-serve] launches by variant {by_variant}", flush=True)
    for n in ZOO_LAUNCHERS:
        if launches["prefill"][n] + launches["decode"][n] <= 0:
            _fail(f"{n} was never launched on the zoo serving path")
        for phase in ("prefill", "decode"):
            if launches[phase][n] != expect[phase][n]:
                _fail(f"{n}: {launches[phase][n]} launches in the zoo "
                      f"{phase} != {expect[phase][n]} implied by its "
                      f"layers, groups and steps")
    for phase in ("prefill", "decode"):
        for n in TC_LAUNCHERS:
            want = {**dict.fromkeys(by_variant[phase][n], 0),
                    "tc": expect[phase][n]}
            if by_variant[phase][n] != want:
                _fail(f"{n}: zoo {phase} launches by variant "
                      f"{by_variant[phase][n]}; every one must take the "
                      f"tensor-core variant")
    # the zoo's ring (B=2, 8 kv heads, W=2048) is split across blocks
    want = {**dict.fromkeys(by_variant["decode"]["decode_attention"], 0),
            "split": expect["decode"]["decode_attention"]}
    if by_variant["decode"]["decode_attention"] != want:
        _fail(f"decode_attention: zoo decode launches by variant "
              f"{by_variant['decode']['decode_attention']} != {want}")
    if not bool(torch.isfinite(logits).all()) or \
            logits.shape != (B, cfg.vocab):
        _fail(f"zoo decode logits {tuple(logits.shape)} not finite or not "
              f"(B, vocab)")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        _fail("zoo greedy tokens outside the vocabulary")
    return launches, by_variant, m, outputs


def phase_zoo_profile(cfg, params, batch, n_decode=4, tag="zoo-profile",
                      whole=lambda t: t):
    """Device time of one zoo prefill of ``batch`` (its tokens and a
    CROSS model's memory) and of ``n_decode`` decode steps under
    torch.profiler: the union of kernel intervals against the wall clock
    (idle share) and device time by kernel group.  ``whole`` turns a
    step's logits into one tensor (over a mesh: ``unshard``)."""
    from repro_torch.launch.profile_serve import _group, _union_us
    from repro_torch.models import transformer as tfm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    S = batch["tokens"].shape[1]
    state = {}

    def prefill():
        state["last"], state["cache"] = tfm.prefill(params, batch, cfg)

    def decode():
        tok = whole(state["last"]).argmax(-1)
        cache = state["cache"]
        for step in range(n_decode):
            logits, cache = tfm.decode_step(params, cache, tok[:, None],
                                            S + step, cfg)
            tok = whole(logits).argmax(-1)

    for label, fn in (("prefill", prefill),
                      (f"decode x{n_decode}", decode)):
        torch.cuda.synchronize()
        with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if not dev:
            _fail(f"{tag} [{label}]: no device events recorded")
        busy = _union_us((e.time_range.start, e.time_range.end) for e in dev)
        groups = {}
        for e in dev:
            g = _group(e.name)
            n, tot = groups.get(g, (0, 0.0))
            groups[g] = (n + 1, tot + e.time_range.end - e.time_range.start)
        print(f"[{tag}] {label}: wall_ms={wall_us / 1e3:.6g} "
              f"device_busy_ms={busy / 1e3:.6g} idle_share="
              f"{1 - busy / wall_us:.4f} by_group(launches, ms)=" + str({
                  g: (n, round(t / 1e3, 4))
                  for g, (n, t) in sorted(groups.items(),
                                          key=lambda kv: -kv[1][1])}),
              flush=True)


def phase_zoo_checks(cfg, params, tokens):
    """(a) prefill/decode consistency at full width; (b) card vs CPU at
    the smoke config in fp32 from the same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_batches
    from repro_torch.models import transformer as tfm
    # (a) a capacity of T per expert (factor E / top_k) drops no token
    m = cfg.moe
    cfg_a = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    S = 256
    tok = tokens[:, :S]
    with torch.no_grad():
        full, _ = tfm.prefill(params, {"tokens": tok}, cfg_a)
        _, cache = tfm.prefill(params, {"tokens": tok[:, :S - 1]}, cfg_a,
                               cache_len=S)
        dec, _ = tfm.decode_step(params, cache, tok[:, S - 1:], S - 1, cfg_a)
    torch.cuda.synchronize()
    tol = ZOO_LOGIT_TOL["consistency"]
    err = max_err(dec, full)
    bad = float(((dec - full).abs() - tol * (1 + full.abs())).max())
    print(f"[zoo-check] (a) prefill(S={S}) vs prefill(S-1)+decode_step at "
          f"full width: max|diff| {err:.4g}, max|logit| "
          f"{float(full.abs().max()):.4g} (atol=rtol={tol}); argmax equal: "
          f"{bool((dec.argmax(-1) == full.argmax(-1)).all())}", flush=True)
    if not math.isfinite(err) or bad > 0:
        _fail(f"zoo prefill/decode disagree: max|diff| {err}")
    # (b) smoke config in fp32: kernels on the card vs twins on the CPU
    cfg_b = dataclasses.replace(get_smoke_config(ZOO_ARCH), dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg_b)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.from_numpy(next(lm_batches(cfg_b.vocab, 2, 64, 1,
                                            seed=0))["tokens"])
    tol = ZOO_LOGIT_TOL["card_vs_cpu"]
    n0 = {n: fn.launches for n, fn in ZOO_LAUNCHERS.items()}
    with torch.no_grad():
        lc, cc = tfm.prefill(p_cpu, {"tokens": toks}, cfg_b)
        lg, cg = tfm.prefill(p_gpu, {"tokens": toks.cuda()}, cfg_b)
        errs = [max_err(lg.cpu(), lc)]
        same = [bool((lg.argmax(-1).cpu() == lc.argmax(-1)).all())]
        for step in range(4):
            nxt = lc.argmax(-1)[:, None]
            lc, cc = tfm.decode_step(p_cpu, cc, nxt, 64 + step, cfg_b)
            lg, cg = tfm.decode_step(p_gpu, cg, nxt.cuda(), 64 + step, cfg_b)
            errs.append(max_err(lg.cpu(), lc))
            same.append(bool((lg.argmax(-1).cpu() == lc.argmax(-1)).all()))
    torch.cuda.synchronize()
    moved = {n: fn.launches - n0[n] for n, fn in ZOO_LAUNCHERS.items()}
    print(f"[zoo-check] (b) {cfg_b.name} fp32, card vs CPU: max|diff| per "
          f"step {[f'{e:.3g}' for e in errs]} (tol {tol}); greedy equal "
          f"{same}; card launches {moved}", flush=True)
    if not all(same) or max(errs) > tol or not all(map(math.isfinite, errs)):
        _fail("zoo card and CPU disagree at the smoke config")
    if min(moved.values()) <= 0:
        _fail(f"the card run of (b) skipped a kernel: {moved}")


# ---------------------------------------------------------------------------
# zoo-archs: the zoo's other decoder-only architectures at full width
# ---------------------------------------------------------------------------
ARCH_LAUNCHERS = {**ZOO_LAUNCHERS, "ssd_scan": ssd_scan_cuda}
# (name, short name for the record's paths, depth: None = full, "half" =
# the first half of Jamba's 8-block period)
ZOO_ARCHS = (
    ("mamba2-370m", "mamba2", 16),
    ("internlm2-1.8b", "internlm2", None),
    ("h2o-danube-3-4b", "danube", None),
    ("qwen3-8b", "qwen3", 12),
    ("llama3-405b", "llama3", 2),
    ("dbrx-132b", "dbrx", 2),
    ("jamba-1.5-large-398b", "jamba", "half"),
    ("seamless-m4t-medium", "seamless", None),
    ("llama-3.2-vision-11b", "vision", 20),
)
# a kernel call's role on a zoo path, from the function of
# ``models/attention.py`` it came through (an SSD scan's is "prefill")
ROLES = {("flash_attention", "prefill_attention"): "self prefill",
         ("flash_attention", "encoder_attention"): "encoder",
         ("flash_attention", "cross_attention"): "cross prefill",
         ("decode_attention", "ring_decode_attention"): "self decode",
         ("decode_attention", "cross_attention"): "cross decode"}
# the (kernel, role) rows each architecture times
ARCH_TIMED = {"mamba2": [("ssd_scan", "prefill")],
              "jamba": [("ssd_scan", "prefill")],
              "llama3": [("decode_attention", "self decode")],
              "danube": [("flash_attention", "self prefill")],
              "seamless": [("flash_attention", "encoder")],
              "vision": [("flash_attention", "cross prefill"),
                         ("decode_attention", "cross decode")]}
# seamless' decoder prompt under its 2048 frames: the reference's
# speech-to-text ratio, dec_len = max(S // 8, 128) (launch/shapes.py)
ENCDEC_PROMPT = max(ZOO_PROMPT // 8, 128)


def _arch_config(name, depth):
    """The full config, its depth cut (widths never change), and the cut
    in words."""
    from repro_torch.configs import get_config
    full = get_config(name)
    if depth is None:
        enc = (f" + {full.encoder.n_layers} encoder layers"
               if full.encoder is not None else "")
        return full, f"full depth, {full.n_layers} layers{enc}"
    if depth == "half":
        half = len(full.period) // 2
        cfg = dataclasses.replace(
            full, n_layers=half, period=full.period[:half],
            moe_period_idx=tuple(i for i in full.moe_period_idx if i < half))
        return cfg, (f"CUT to the first half of its period {cfg.period} "
                     f"(MoE at {cfg.moe_period_idx}), {half} of "
                     f"{full.n_layers} layers: a whole period needs about "
                     f"90 GB")
    return (dataclasses.replace(full, n_layers=depth),
            f"depth cut to {depth} of {full.n_layers} layers")


def _arch_variants(cfg):
    """The variant every launch of each kernel must take on this model's
    serving path: moe_gmm and flash bf16 on the tensor cores (flash at a
    head dim outside ``TC_HEAD_DIMS``, none of the zoo's, on the scalar
    kernel), decode attention split across its cache (the 2048-slot
    ring, seamless' 256-slot one, the 1600 or 2048 memory slots of a
    CROSS layer), the SSD scan in its four chunk-parallel passes (chunk
    256)."""
    from repro_torch.kernels.flash_attention.kernel import TC_HEAD_DIMS
    hd = cfg.attn.head_dim if cfg.attn is not None else None
    return {"moe_gmm": "tc",
            "flash_attention": "tc" if hd in TC_HEAD_DIMS else "simt",
            "decode_attention": "split", "ssd_scan": "parallel"}


def _arch_batch(cfg, prompt_len):
    """``lm_batches(seed=0)``'s prompts on the card and, for a CROSS
    model, the memory its modality stub would hand over, drawn in fp32
    from a seeded CUDA generator (the model casts it to its dtype):
    seamless' ZOO_PROMPT frame embeddings, the vision model's
    ``n_image_tokens`` image embeddings."""
    from repro_torch.data import lm_batches
    b = next(lm_batches(cfg.vocab, ZOO_BATCH, prompt_len, 1, seed=0))
    batch = {"tokens": torch.from_numpy(b["tokens"]).cuda()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.encoder is not None:
        batch["frames"] = torch.randn((ZOO_BATCH, ZOO_PROMPT, cfg.d_model),
                                      generator=gen, device="cuda")
    if cfg.vision_stub:
        batch["image_embeds"] = torch.randn(
            (ZOO_BATCH, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device="cuda")
    return batch


def _capture_arch_inputs(cfg, params, batch):
    """One prefill and one decode step (also the warm-up): the inputs of
    each role's first call (``ROLES``) of the SSD scan, flash and decode
    attention."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tfm
    got = {}
    real = {"ssd_scan": (ssm_mod, ssm_mod.ssd_scan),
            "flash_attention": (attn_mod, attn_mod.flash_attention),
            "decode_attention": (attn_mod, attn_mod.decode_attention)}

    def rec(name, fn):
        def f(*args, **kw):
            caller = sys._getframe(1).f_code.co_name
            role = "prefill" if name == "ssd_scan" else ROLES[name, caller]
            got.setdefault((name, role), (args, kw))
            return fn(*args, **kw)
        return f

    try:
        for name, (mod, fn) in real.items():
            setattr(mod, name, rec(name, fn))
        with torch.no_grad():
            last, cache = tfm.prefill(params, batch, cfg)
            tfm.decode_step(params, cache, last.argmax(-1)[:, None],
                            batch["tokens"].shape[1], cfg)
    finally:
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    return got


def _ssd_pass_rows(short, x, adt, dt, B, C, L, results):
    """Each pass of the SSD scan's "parallel" variant alone
    (``ssd_passes_cuda``, uncounted) against its plain pass on the same
    inputs, fed the plain outputs of the passes before it: C·Bᵀ's lower
    triangle, the chunk states and their cumsum of A·dt, the states
    entering the chunks and the final one, y; each within ZOO_SSD_TOL x
    min(1, max|plain|), the rule of the captured-input rows.  The cumsum,
    which the kernel keeps in fp64, is held to the cumsum in float64: the
    twin's fp32 cumsum is itself ~8 ulps (0.004) off at Jamba's |cum| ~
    7e3."""
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    cb = ssd_cb_ref(B, C, L)
    st, cum = ssd_chunk_state_ref(x, adt, dt, B, L)
    ent, hf = ssd_state_pass_ref(st, cum)
    y = ssd_chunk_scan_ref(x, dt, C, cb, cum, ent, L)
    cum64 = torch.cumsum(adt.double().reshape(Bsz, S // L, L, H),
                         dim=2).transpose(2, 3)
    hout = torch.empty_like(hf)
    yk = torch.empty(x.shape, dtype=torch.float32, device=x.device)

    def run(passes, entering=False, **kw):
        s = ssd_scratch(Bsz, S, H, hp, N, L, x.device)
        s["cb"].zero_()
        s["cb"][..., :L, :L] = cb
        s["cum"][..., :L] = cum
        s["cum"][..., L:] = cum[..., -1:]
        s["st"].copy_(ent if entering else st)
        ssd_passes_cuda(x, adt, dt, B, C, chunk=L, passes=passes,
                        scratch=s, **kw)
        return s

    for what, kernel_fn, plain in (
            ("cb", lambda: run(["cb"])["cb"][..., :L, :L].tril(), cb),
            ("chunk_state", lambda: run(["chunk_state"])["st"], st),
            ("chunk_state cum",
             lambda: run(["chunk_state"])["cum"][..., :L], cum64),
            ("state_pass", lambda: run(["state_pass"], h_final=hout)["st"],
             ent),
            ("state_pass h_final",
             lambda: (run(["state_pass"], h_final=hout), hout)[1], hf),
            ("chunk_scan",
             lambda: (run(["chunk_scan"], entering=True, y=yk), yk)[1], y)):
        check("ssd_scan", f"pass zoo {short} {what}", kernel_fn,
              lambda: plain, ZOO_SSD_TOL, results, scaled=True)


def _arch_kernel_rows(short, cfg, got, results):
    """Each kernel held against its plain version on the inputs captured
    for each of its roles and on O(1) random inputs at the same shapes;
    the architecture's own path rows (ARCH_TIMED) timed beside the
    library call and the bound.  Every row asserts its variant."""
    want = _arch_variants(cfg)
    timed = ARCH_TIMED.get(short, [])
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if ("ssd_scan", "prefill") in got:
        (x, adt, dt, B, C), kw = got["ssd_scan", "prefill"]
        L = kw["chunk"]
        label = f"path zoo {short} prefill chunk {L} N{B.shape[-1]}"
        check("ssd_scan", label,
              lambda: ssd_ops.ssd_scan(x, adt, dt, B, C, chunk=L),
              lambda: ssd_scan_chunked_ref(x, adt, dt, B, C, L),
              ZOO_SSD_TOL, results, None, ssd_bound(x, adt, dt, B, C, L),
              ("ssd_scan", "prefill") in timed, scaled=True, reps=5,
              variant=want["ssd_scan"])
        check("ssd_scan", f"path zoo {short} prefill h_final",
              lambda: ssd_ops.ssd_scan(x, adt, dt, B, C, chunk=L,
                                       return_state=True)[1],
              lambda: ssd_scan_chunked_ref(x, adt, dt, B, C, L,
                                           return_state=True)[1],
              ZOO_SSD_TOL, results, scaled=True, variant=want["ssd_scan"])
        _ssd_pass_rows(short, x, adt, dt, B, C, L, results)
        # O(1) inputs with the model's A = -(1 .. H), held to the
        # recurrence in float64 per element (ZOO_SSD_F64_TOL)
        H = x.shape[2]
        xr, Br, Cr = rnd(*x.shape), rnd(*B.shape), rnd(*C.shape)
        dtr = F.softplus(rnd(*dt.shape) - 2.0)
        adtr = -torch.arange(1, H + 1, device="cuda").float() * dtr
        f64 = ssd_float64(xr, adtr, dtr, Br, Cr)
        twin = ssd_scan_chunked_ref(xr, adtr, dtr, Br, Cr, L,
                                    return_state=True)
        for i, what in ((0, "y"), (1, "h_final")):
            check("ssd_scan", f"random O(1) zoo {short} {what} vs float64",
                  lambda: ssd_ops.ssd_scan(xr, adtr, dtr, Br, Cr, chunk=L,
                                           return_state=True)[i],
                  lambda: f64[i].float(), ZOO_SSD_F64_TOL, results,
                  variant=want["ssd_scan"], per_element=True)
            print(f"[zoo-archs] ssd_scan random O(1) {short} {what}: the "
                  f"fp32 twin is {max_err(twin[i], f64[i]):.4g} from "
                  f"float64 (max {float(f64[i].abs().max()):.4g})",
                  flush=True)
        del twin, f64
    for role in ("self prefill", "encoder", "cross prefill"):
        if ("flash_attention", role) not in got:
            continue
        (q, k, v), kw = got["flash_attention", role]
        what = "prefill" if role == "self prefill" else role
        what += f" Sq{q.shape[1]}"
        check("flash_attention", f"path zoo {short} {what} "
              f"Skv{k.shape[1]} H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]} "
              f"causal={kw['causal']}",
              lambda: fl_ops.flash_attention(q, k, v, **kw),
              lambda: flash_plain(q, k, v, **kw), ZOO_TOL["bf16"], results,
              lambda: flash_library(q, k, v, **kw),
              flash_bound(q, k, v, **kw), ("flash_attention", role) in timed,
              relative=True, reps=5, variant=want["flash_attention"])
    for role in ("self decode", "cross decode"):
        if ("decode_attention", role) not in got:
            continue
        (q, k, v, pos), kw = got["decode_attention", role]
        what = "decode" if role == "self decode" else role
        check("decode_attention", f"path zoo {short} {what} "
              f"W={k.shape[1]} H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]} "
              f"valid={int((pos >= 0).sum())}",
              lambda: dec_ops.decode_attention(q, k, v, pos, **kw),
              lambda: decode_plain(q, k, v, pos), ZOO_TOL["bf16"], results,
              lambda: decode_library(q, k, v, pos),
              decode_bound(q, k, v, pos), ("decode_attention", role) in timed,
              relative=True, reps=20, variant=want["decode_attention"])
        if ("decode_attention", role) in timed and role == "self decode":
            bf = q.dtype
            qr, kr, vr = (rnd(*t.shape, dtype=bf) for t in (q, k, v))
            W = k.shape[1]
            posr = torch.where(torch.arange(W) < W - 300, torch.arange(W),
                               torch.full((W,), -1)).to("cuda", torch.int32)
            check("decode_attention",
                  f"random O(1) zoo {short} decode, 300 empty slots",
                  lambda: dec_ops.decode_attention(qr, kr, vr, posr),
                  lambda: decode_plain(qr, kr, vr, posr), ZOO_TOL["bf16"],
                  results, relative=True, variant=want["decode_attention"])


def _arch_serve(cfg, params, batch):
    """prefill + ZOO_DECODE greedy steps, each phase's launches and
    variants counted from zero; they must equal what the layers imply and
    take the model's variants."""
    from repro_torch.models import transformer as tfm
    B, S = batch["tokens"].shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out_tokens, launches, by_variant = [], {}, {}

    def zero():
        for fn in ARCH_LAUNCHERS.values():
            fn.launches = 0
        _zero_variant_counts()

    def read(phase):
        launches[phase] = {n: fn.launches for n, fn in ARCH_LAUNCHERS.items()}
        by_variant[phase] = {n: c for n, c in _variant_counts().items()
                             if n in ARCH_LAUNCHERS}

    with torch.no_grad():
        zero()
        t0 = time.perf_counter()
        last, cache = tfm.prefill(params, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        read("prefill")
        zero()
        tok = last.argmax(-1)
        for step in range(ZOO_DECODE):
            out_tokens.append(tok)
            logits, cache = tfm.decode_step(params, cache, tok[:, None],
                                            S + step, cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        read("decode")
    expect = _zoo_expected(cfg, B * S, ZOO_DECODE)
    m = {"prefill_ms": (t1 - t0) * 1e3,
         "decode_ms_per_step": (t2 - t1) * 1e3 / ZOO_DECODE,
         "decode_tokens_per_s": B * ZOO_DECODE / (t2 - t1),
         "prefill_tokens_per_s": B * S / (t1 - t0),
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    gen = torch.stack(out_tokens, 1)
    print(f"[zoo-archs] {cfg.name} serve: " + " ".join(
        f"{k}={v:.6g}" for k, v in m.items()))
    print(f"[zoo-archs] {cfg.name} launches {launches} expected {expect}; "
          f"by variant {by_variant}; greedy tokens row 0: "
          f"{gen[0].tolist()}", flush=True)
    want = _arch_variants(cfg)
    for phase in ("prefill", "decode"):
        for n in ARCH_LAUNCHERS:
            if launches[phase][n] != expect[phase][n]:
                _fail(f"{cfg.name} {n}: {launches[phase][n]} launches in "
                      f"the {phase} != {expect[phase][n]} implied by its "
                      f"layers, groups and steps")
            v_want = {v: expect[phase][n] if v == want[n] else 0
                      for v in by_variant[phase][n]}
            if by_variant[phase][n] != v_want:
                _fail(f"{cfg.name} {n}: {phase} launches by variant "
                      f"{by_variant[phase][n]} != {v_want}")
    from repro_torch.models.layers import padded_vocab
    if not bool(torch.isfinite(logits).all()) or \
            logits.shape != (B, padded_vocab(cfg)):
        _fail(f"{cfg.name} decode logits {tuple(logits.shape)} not finite "
              f"or not (B, padded vocab)")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        _fail(f"{cfg.name} greedy tokens outside the vocabulary")
    return launches, by_variant, m


def _arch_consistency(cfg, params, batch):
    """(a) prefill(S) against prefill(S - 1) + decode_step at full width,
    the same memory in both (a CROSS model's): S = 256 (one chunk of 255
    before the step, not a multiple of the 64-token sub-tile) and, with
    MAMBA blocks, S = 300 (a chunk of 256 and a 44-token tail the adapter
    pads); MoE at a capacity that drops no token."""
    from repro_torch.configs import MAMBA
    from repro_torch.models import transformer as tfm
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    tol = ZOO_LOGIT_TOL["consistency"]
    tokens = batch["tokens"]
    memory = {k: v for k, v in batch.items() if k != "tokens"}
    for S in (256, 300) if MAMBA in cfg.period else (256,):
        tok = tokens[:, :S]
        with torch.no_grad():
            full, _ = tfm.prefill(params, {"tokens": tok, **memory}, cfg)
            _, cache = tfm.prefill(params,
                                   {"tokens": tok[:, :S - 1], **memory}, cfg,
                                   cache_len=S)
            dec, _ = tfm.decode_step(params, cache, tok[:, S - 1:], S - 1,
                                     cfg)
        torch.cuda.synchronize()
        # the vocabulary's columns (the padding's are masked at -1e9)
        dec, full = dec[:, :cfg.vocab], full[:, :cfg.vocab]
        err = max_err(dec, full)
        bad = float(((dec - full).abs() - tol * (1 + full.abs())).max())
        print(f"[zoo-archs] {cfg.name} (a) prefill(S={S}) vs "
              f"prefill(S-1)+decode_step: max|diff| {err:.4g}, max|logit| "
              f"{float(full.abs().max()):.4g} (atol=rtol={tol}); argmax "
              f"equal: {bool((dec.argmax(-1) == full.argmax(-1)).all())}",
              flush=True)
        if not math.isfinite(err) or bad > 0:
            _fail(f"{cfg.name} prefill/decode disagree at S={S}: "
                  f"max|diff| {err}")


def _arch_card_vs_cpu(name):
    """(b) the smoke config in fp32: kernels on the card against twins on
    the CPU from the same weights and, for a CROSS model, the same memory
    (seamless: 80 frames; the vision model: its 16 image tokens); every
    kernel the model runs launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_batches
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = next(lm_batches(cfg.vocab, 2, 64, 1, seed=0))["tokens"]
    b_cpu = {"tokens": torch.from_numpy(toks)}
    gen = torch.Generator().manual_seed(1)
    if cfg.encoder is not None:
        b_cpu["frames"] = torch.randn((2, 80, cfg.d_model), generator=gen)
    if cfg.vision_stub:
        b_cpu["image_embeds"] = torch.randn(
            (2, cfg.n_image_tokens, cfg.d_model), generator=gen)
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    tol = ZOO_LOGIT_TOL["card_vs_cpu"]
    n0 = {n: fn.launches for n, fn in ARCH_LAUNCHERS.items()}
    with torch.no_grad():
        lc, cc = tfm.prefill(p_cpu, b_cpu, cfg)
        lg, cg = tfm.prefill(p_gpu, b_gpu, cfg)
        errs = [max_err(lg.cpu(), lc)]
        same = [bool((lg.argmax(-1).cpu() == lc.argmax(-1)).all())]
        for step in range(4):
            nxt = lc.argmax(-1)[:, None]
            lc, cc = tfm.decode_step(p_cpu, cc, nxt, 64 + step, cfg)
            lg, cg = tfm.decode_step(p_gpu, cg, nxt.cuda(), 64 + step, cfg)
            errs.append(max_err(lg.cpu(), lc))
            same.append(bool((lg.argmax(-1).cpu() == lc.argmax(-1)).all()))
    torch.cuda.synchronize()
    moved = {n: fn.launches - n0[n] for n, fn in ARCH_LAUNCHERS.items()}
    expect = _zoo_expected(cfg, 2 * 64, 4)
    runs = [n for n in ARCH_LAUNCHERS
            if expect["prefill"][n] + expect["decode"][n] > 0]
    print(f"[zoo-archs] {cfg.name} (b) fp32, card vs CPU: max|diff| per "
          f"step {[f'{e:.3g}' for e in errs]} (tol {tol}); greedy equal "
          f"{same}; card launches {moved}", flush=True)
    if not all(same) or max(errs) > tol or not all(map(math.isfinite, errs)):
        _fail(f"{cfg.name}: card and CPU disagree at the smoke config")
    if any(moved[n] <= 0 for n in runs):
        _fail(f"{cfg.name}: the card run of (b) skipped a kernel: {moved}")


def phase_zoo_archs():
    """The zoo's nine other architectures, one at a time at full width
    (each freed before the next): serve, kernel rows, consistency (a) and
    card vs CPU (b).  Returns each kernel's rows and the record's
    ``paths`` entries of every model."""
    import gc
    from repro_torch.models import transformer as tfm
    t_phase = time.time()
    results, paths, measured = {}, {}, {}
    for name, short, depth in ZOO_ARCHS:
        t_arch = time.time()
        cfg, cut = _arch_config(name, depth)
        params = tfm.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        batch = _arch_batch(cfg, ENCDEC_PROMPT if cfg.encoder is not None
                            else ZOO_PROMPT)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        print(f"[zoo-archs] {name} at full width (d_model {cfg.d_model}), "
              f"{cut}: {n / 1e9:.3f} B parameters, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
              f"built in {time.time() - t_arch:.2f} s", flush=True)
        got = _capture_arch_inputs(cfg, params, batch)
        launches, by_variant, m = _arch_serve(cfg, params, batch)
        measured[name] = (cfg, batch["tokens"].shape[1], m)
        phase_zoo_profile(cfg, params, batch, n_decode=2,
                          tag=f"zoo-archs {short}")
        rows = {}
        _arch_kernel_rows(short, cfg, got, rows)
        del got
        _arch_consistency(cfg, params, batch)
        _arch_card_vs_cpu(name)
        # one role a (kernel, phase) is timed: decode attention in decode,
        # the others in the prefill
        timed = {(k, "decode" if k == "decode_attention" else "prefill")
                 for k, _ in ARCH_TIMED.get(short, [])}
        for phase in ("prefill", "decode"):
            for k in ARCH_LAUNCHERS:
                if launches[phase][k] == 0:
                    continue
                rec = {"launches": launches[phase][k],
                       "launches_by_variant": by_variant[phase][k]}
                if (k, phase) in timed:
                    rec = _record_row(
                        [x for x in rows[k] if x[0].startswith("path")],
                        launches[phase][k], by_variant[phase][k])
                paths.setdefault(k, {})[f"zoo_{short}_{phase}"] = rec
        for k, r in rows.items():
            results.setdefault(k, []).extend(r)
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[zoo-archs] {name}: {time.time() - t_arch:.1f} s",
              flush=True)
    print(f"[zoo-archs] phase seconds {time.time() - t_phase:.1f}",
          flush=True)
    return results, paths, measured


# ---------------------------------------------------------------------------
# zoo-train: the zoo's training path at published widths (phase 12)
# ---------------------------------------------------------------------------
# (name, short name, depth cut (None = full), batch); seq TRAIN_SEQ
ZOO_TRAIN = (("internlm2-1.8b", "internlm2", 8, 4),
             ("mamba2-370m", "mamba2", 8, 4),
             ("mixtral-8x22b", "mixtral", 1, 1))
TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2048, 8, 1e-3
# (b) kernels against twins, one remat step each.  In fp32 (the
# kernels' fp32 variants: flash "tiled", moe_gmm "simt", the SSD
# "parallel") the two compute one function in another order: the loss
# within 1e-5 relative, each gradient leaf within 1e-4 in relative l2
# norm.  In bf16 (the training path's "tc" kernels) a step's gradient is
# itself far from the same step in fp32 (0.5-2% at internlm2's leaves,
# 2-8% at mamba2's, 6-9% at Mixtral's, where bf16 rounding also re-routes
# a few tokens), so the kernels' bf16 gradient is held to the fp32 twin
# step no farther than 1.25 x the bf16 twins' own gradient is, plus
# 1e-3, leaf by leaf; their losses within 2e-3 relative of each other.
# (c) remat on against off: the loss within 1e-6 relative (the same
# forward recomputed), each leaf within 2e-2 (the embedding's gradient
# accumulates bf16 rows with atomics, and GQA's repeat_interleave
# backward sums 2-6 fp32 terms in a varying order).
TRAIN_TOL = {"loss": 2e-3, "fp32_loss": 1e-5, "fp32_grad": 1e-4,
             "bf16_ratio": 1.25, "bf16_slack": 1e-3,
             "remat_loss": 1e-6, "remat_grad": 2e-2}
# (a) the leaves upstream of a kernel, whose gradient must be non-zero
TRAIN_UPSTREAM = ("wq", "wk", "wv", "in_proj", "w_in", "w_gate", "w_out")


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaf_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _train_expected(cfg, n_tokens, remat):
    """Launches one training step implies: its forward's (the prefill's,
    ``_zoo_expected``), and with ``remat`` each checkpointed period's
    again in the backward's recompute; the backward itself runs the
    twins, and no step decodes."""
    per = _zoo_expected(cfg, n_tokens, 0)["prefill"]
    return {k: (2 if remat else 1) * v for k, v in per.items()}


def _train_step(cfg, params, batch, remat):
    """One step's loss, metrics and gradients (``launch.train``'s
    ``loss_and_grads``), its launches and variants counted from zero, and
    its synchronised wall ms."""
    from repro_torch.launch.train import loss_and_grads
    for fn in ARCH_LAUNCHERS.values():
        fn.launches = 0
    _zero_variant_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, metrics, grads = loss_and_grads(params, batch, cfg, remat)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {n: fn.launches for n, fn in ARCH_LAUNCHERS.items()}
    by_variant = {n: c for n, c in _variant_counts().items()
                  if n in ARCH_LAUNCHERS}
    return loss, metrics, grads, ms, launches, by_variant


def _check_train_launches(tag, cfg, n_tokens, remat, launches, by_variant,
                          steps=1):
    """(d) the launches and variants a step implies, x ``steps``."""
    expect = {k: steps * v for k, v in
              _train_expected(cfg, n_tokens, remat).items()}
    want = _arch_variants(cfg)
    print(f"[zoo-train] {tag}: launches {launches} expected {expect}; by "
          f"variant {by_variant}", flush=True)
    for n in ARCH_LAUNCHERS:
        if launches[n] != expect[n]:
            _fail(f"{tag} {n}: {launches[n]} launches != {expect[n]}")
        v_want = {v: expect[n] if v == want[n] else 0
                  for v in by_variant[n]}
        if by_variant[n] != v_want:
            _fail(f"{tag} {n}: launches by variant {by_variant[n]} != "
                  f"{v_want}")


def _check_grads_present(tag, grads):
    """(a) every leaf has a finite gradient, non-zero upstream of each
    kernel (a kernel output cut off from the graph leaves them None)."""
    zero, seen = [], set()
    for path, g in _leaf_paths(grads).items():
        if g is None:
            _fail(f"{tag}: no gradient reached {path}")
        if not bool(torch.isfinite(g).all()):
            _fail(f"{tag}: non-finite gradient at {path}")
        name = path.rsplit("/", 1)[-1]
        if name in TRAIN_UPSTREAM:
            seen.add(name)
            if not bool((g != 0).any()):
                zero.append(path)
    if zero:
        _fail(f"{tag}: zero gradient upstream of a kernel at {zero}")
    print(f"[zoo-train] {tag} (a): {len(_leaf_paths(grads))} leaves, every "
          f"gradient finite; non-zero at {sorted(seen)}", flush=True)


def _rel_l2(a, b):
    """||a - b|| / ||b|| in fp32 (0 when both are 0)."""
    num = float(torch.linalg.vector_norm((a.float() - b.float())))
    den = float(torch.linalg.vector_norm(b.float()))
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _compare_grads(tag, got, want, tol):
    """Each leaf within ``tol`` in relative l2 norm; prints the largest
    and the count of bitwise-equal leaves."""
    worst, equal = 0.0, 0
    wp = _leaf_paths(want)
    for path, g in _leaf_paths(got).items():
        r = _rel_l2(g, wp[path])
        equal += bool(torch.equal(g, wp[path]))
        worst = max(worst, r)
        if not r <= tol:
            _fail(f"{tag}: gradient at {path} off by {r:.4g} (relative l2) "
                  f"> {tol}")
    print(f"[zoo-train] {tag}: largest relative l2 {worst:.4g} (tol {tol}); "
          f"{equal} of {len(wp)} leaves bitwise equal", flush=True)


def _compare_to_fp32(tag, kernel, twin, fp32):
    """(b) in bf16: each leaf of the kernels' gradient no farther from
    the fp32 step's than TRAIN_TOL["bf16_ratio"] x the twins' bf16
    gradient is, plus TRAIN_TOL["bf16_slack"] (relative l2 norms)."""
    ratio, slack = TRAIN_TOL["bf16_ratio"], TRAIN_TOL["bf16_slack"]
    tp, fp = _leaf_paths(twin), _leaf_paths(fp32)
    rows = []
    for path, g in _leaf_paths(kernel).items():
        rk, rt = _rel_l2(g, fp[path]), _rel_l2(tp[path], fp[path])
        rows.append((rk / rt if rt > 0 else math.inf, rk, rt, path))
        if not rk <= ratio * rt + slack:
            _fail(f"{tag}: the kernels' gradient at {path} is {rk:.4g} from "
                  f"the fp32 step's, the twins' {rt:.4g} (relative l2; "
                  f"allowed {ratio} x + {slack})")
    q, rk, rt, path = max(rows)
    print(f"[zoo-train] {tag}: kernels' / twins' distance to the fp32 step "
          f"at most {q:.4g} ({path}: {rk:.4g} / {rt:.4g}); the kernels' "
          f"{min(r[1] for r in rows):.4g}-{max(r[1] for r in rows):.4g}, "
          f"the twins' {min(r[2] for r in rows):.4g}-"
          f"{max(r[2] for r in rows):.4g} (allowed {ratio} x + {slack})",
          flush=True)


def _twin_ssd(x, adt, dt, B, C, *, chunk, init_state=None,
              return_state=False):
    return ssd_scan_chunked_ref(x, adt, dt, B, C, min(chunk, x.shape[1]),
                                init_state=init_state,
                                return_state=return_state)


def _twins_patched(fn):
    """``fn()`` with the plain twins in the ``attention.py`` / ``moe.py``
    / ``ssm.py`` module globals the zoo calls its kernels through."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    real = [(attn_mod, "flash_attention", flash_plain),
            (moe_mod, "moe_gmm", gmm_ref), (ssm_mod, "ssd_scan", _twin_ssd)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in real]
    try:
        for mod, name, twin in real:
            setattr(mod, name, twin)
        return fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def _capture_train_inputs(fn):
    """``fn()`` recording the (detached) inputs of the first flash and SSD
    call and of the first group's up and down ``moe_gmm`` products."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    got, gmm_calls = {}, [0]
    real = {"flash_attention": (attn_mod, attn_mod.flash_attention),
            "moe_gmm": (moe_mod, moe_mod.moe_gmm),
            "ssd_scan": (ssm_mod, ssm_mod.ssd_scan)}

    def rec(name, f):
        def g(*args, **kw):
            key = name
            if name == "moe_gmm":
                gmm_calls[0] += 1
                key = {1: ("moe_gmm", "up"), 3: ("moe_gmm", "down")}.get(
                    gmm_calls[0])
            if key is not None and key not in got:
                got[key] = (tuple(a.detach() for a in args), kw)
            return f(*args, **kw)
        return g

    try:
        for name, (mod, f) in real.items():
            setattr(mod, name, rec(name, f))
        return fn(), got
    finally:
        for name, (mod, f) in real.items():
            setattr(mod, name, f)


def _backward_ms(op_fn, ins, upstream, reps=3):
    """Device ms of one backward through the op's ``TwinGrad`` (the twin
    recomputed and differentiated) on leaf copies of ``ins``."""
    xs = [t.detach().requires_grad_(t.is_floating_point()) for t in ins]
    out = op_fn(*xs)
    out = out[0] if isinstance(out, tuple) else out
    wants = [x for x in xs if x.requires_grad]
    return time_ms(lambda: torch.autograd.grad(out, wants, upstream,
                                               retain_graph=True), reps, 1)


def _train_kernel_rows(short, cfg, got, results):
    """Each kernel against its plain version on the step's captured
    layer-0 inputs, timed beside the library call and the bound, and the
    time of its backward (the twin's) beside a backward's bound: for
    attention 2.5x the forward's operations (FlashAttention-2's five
    products against two) over q, k, v, dO in and dq, dk, dv out; for the
    grouped product dx and dw (twice the forward's operations) over x, w,
    dy in and dx, dw out; for the SSD scan twice its forward's bound."""
    want = _arch_variants(cfg)
    bwd = {}
    if "flash_attention" in got:
        (q, k, v), kw = got["flash_attention"]
        label = (f"path zoo {short} train S{q.shape[1]} B{q.shape[0]} "
                 f"H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]}")
        row = check("flash_attention", label,
                    lambda: fl_ops.flash_attention(q, k, v, **kw),
                    lambda: flash_plain(q, k, v, **kw), ZOO_TOL["bf16"],
                    results, lambda: flash_library(q, k, v, **kw),
                    flash_bound(q, k, v, **kw), True, relative=True, reps=5,
                    variant=want["flash_attention"])
        bwd["flash_attention"] = (
            _backward_ms(lambda *a: fl_ops.flash_attention(*a, **kw),
                         (q, k, v), torch.randn_like(q)),
            _bound(2 * _nbytes(q, k, v, q), 2.5 * flash_flops(q, k, **kw),
                   q.dtype)[0], row["kernel_ms"])
    for proj in ("up", "down"):
        if ("moe_gmm", proj) not in got:
            continue
        (x, w), _ = got["moe_gmm", proj]
        row = check("moe_gmm", f"path zoo {short} train {proj} "
                    f"C={x.shape[1]} D={x.shape[2]} F={w.shape[2]}",
                    lambda: gmm_ops.moe_gmm(x, w), lambda: gmm_ref(x, w),
                    ZOO_TOL["bf16"], results, lambda: torch.bmm(x, w),
                    gmm_bound(x, w), True, relative=True, reps=5,
                    variant=want["moe_gmm"])
        if proj == "up":
            y = torch.randn((x.shape[0], x.shape[1], w.shape[2]),
                            device="cuda").to(x.dtype)
            bwd["moe_gmm"] = (
                _backward_ms(gmm_ops.moe_gmm, (x, w), y),
                _bound(2 * _nbytes(x, w) + _nbytes(y),
                       4 * x.shape[0] * x.shape[1] * x.shape[2] * y.shape[2],
                       x.dtype)[0], row["kernel_ms"])
    if "ssd_scan" in got:
        (x, adt, dt, B, C), kw = got["ssd_scan"]
        L = kw["chunk"]
        row = check("ssd_scan", f"path zoo {short} train B{x.shape[0]} "
                    f"chunk {L} N{B.shape[-1]}",
                    lambda: ssd_ops.ssd_scan(x, adt, dt, B, C, chunk=L),
                    lambda: ssd_scan_chunked_ref(x, adt, dt, B, C, L),
                    ZOO_SSD_TOL, results, None,
                    ssd_bound(x, adt, dt, B, C, L), True, scaled=True,
                    reps=5, variant=want["ssd_scan"])
        bwd["ssd_scan"] = (
            _backward_ms(lambda *a: ssd_ops.ssd_scan(*a, chunk=L),
                         (x, adt, dt, B, C), torch.randn_like(x)),
            2 * ssd_bound(x, adt, dt, B, C, L)[0], row["kernel_ms"])
    for name, (ms, bound, fwd) in bwd.items():
        print(f"[zoo-train] {short} {name} backward (the twin's): "
              f"ms={ms:.6g} bound_ms={bound:.6g} (forward kernel "
              f"{fwd:.6g} ms)", flush=True)
    return bwd


def _timed_train_steps(short, cfg, params, batch, n_timed=2):
    """Whole steps with remat (forward, backward, the AdamW update), each
    from the same parameters and optimizer state: one to warm up, then
    ``n_timed`` timed (synchronised wall ms a step, tokens/s), then one
    under torch.profiler, phase_zoo_profile's method (device busy ms,
    idle share, device time by kernel group)."""
    from repro_torch.launch.profile_serve import _group, _union_us
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.optim import adamw
    opt = adamw(TRAIN_LR)
    state = opt.init(params)

    def step():
        _, _, grads = loss_and_grads(params, batch, cfg, True)
        with torch.no_grad():
            opt.step(params, grads, state)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del state
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        _fail(f"zoo-train {short}: no device events recorded")
    busy = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    groups = {}
    for e in dev:
        g = _group(e.name)
        n, tot = groups.get(g, (0, 0.0))
        groups[g] = (n + 1, tot + e.time_range.end - e.time_range.start)
    n_tok = batch["tokens"].numel()
    m = {"step_ms": step_ms, "tokens_per_s": n_tok / step_ms * 1e3,
         "profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
         "idle_share": 1 - busy / wall_us}
    print(f"[zoo-train] {short} whole steps (AdamW included, remat on, "
          f"mean of {n_timed} after one to warm up): " + " ".join(
              f"{k}={v:.6g}" for k, v in m.items())
          + " by_group(launches, ms)="
          + str({g: (n, round(t / 1e3, 4)) for g, (n, t) in
                 sorted(groups.items(), key=lambda kv: -kv[1][1])}),
          flush=True)
    return m


def _train_run(name, short, cfg, depth, batch_size):
    """(e) ``launch.train.train`` for TRAIN_STEPS steps with remat on the
    card, its launches counted from zero over the run; (f) the
    checkpoint it writes read back bit-exact against the parameters it
    was handed (recorded by wrapping the module's ``save_checkpoint``)."""
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train as train_mod
    saved = {}
    real_save = train_mod.save_checkpoint

    def recording_save(path, tree, metadata=None):
        saved["tree"], saved["metadata"] = tree, metadata
        return real_save(path, tree, metadata)

    with tempfile.TemporaryDirectory() as tmp:
        for fn in ARCH_LAUNCHERS.values():
            fn.launches = 0
        _zero_variant_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_mod.save_checkpoint = recording_save
        t0 = time.perf_counter()
        try:
            losses = train_mod.train(
                name, smoke=False, steps=TRAIN_STEPS, batch=batch_size,
                seq=TRAIN_SEQ, lr=TRAIN_LR, seed=0, ckpt=tmp,
                log_every=TRAIN_STEPS, remat=True, device="cuda",
                layers=depth)
        finally:
            train_mod.save_checkpoint = real_save
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in ARCH_LAUNCHERS.items()}
        by_variant = {n: c for n, c in _variant_counts().items()
                      if n in ARCH_LAUNCHERS}
        peak = torch.cuda.max_memory_allocated() / 1e9
        t1 = time.perf_counter()
        tree, meta = restore_checkpoint(tmp, bf16="torch")
        read_s = time.perf_counter() - t1
        ckpt_gb = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 1e9
    mine = _leaf_paths(saved.pop("tree")["params"])
    back = _leaf_paths(tree["params"])
    if set(mine) != set(back):
        _fail(f"zoo-train {short} (f): checkpoint paths differ")
    for path, t in mine.items():
        r = back[path]
        r = r if isinstance(r, torch.Tensor) else torch.from_numpy(r)
        if r.dtype != t.dtype or not torch.equal(r, t.cpu()):
            _fail(f"zoo-train {short} (f): {path} did not reload bit-exact")
    if meta.get("final_loss") != losses[-1] or meta.get("arch") != name:
        _fail(f"zoo-train {short} (f): metadata {meta}")
    n_tok = batch_size * TRAIN_SEQ
    print(f"[zoo-train] {short} train(): {TRAIN_STEPS} steps in {wall:.3f} "
          f"s ({1e3 * wall / TRAIN_STEPS:.6g} ms a step with the host's "
          f"batches, {n_tok * TRAIN_STEPS / wall:.6g} tokens/s), peak "
          f"{peak:.4g} GB; losses {[round(x, 4) for x in losses]}; (f) "
          f"{len(mine)} leaves ({ckpt_gb:.4g} GB) reloaded bit-exact in "
          f"{read_s:.3f} s", flush=True)
    _check_train_launches(f"{short} train() x{TRAIN_STEPS}", cfg, n_tok,
                          True, launches, by_variant, steps=TRAIN_STEPS)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        _fail(f"zoo-train {short} (e): the loss did not fall: {losses}")
    return losses, launches, by_variant, {"wall_s": wall, "peak_gb": peak}


def phase_zoo_train():
    """Phase 12: each ZOO_TRAIN model trained on the card at its published
    widths, bf16, one at a time (freed before the next): one step without
    and one with remat, (a) gradients present, (c) the two against each
    other, (d) their launches; (b) the remat step with the plain twins
    patched in, in bf16 and (against the same step in fp32) in fp32; the
    kernels against their plain versions at the step's
    shapes, and their backwards timed; one profiled step; (e) and (f)
    through ``launch.train.train``.  Returns the record's
    ``zoo_<model>_train`` paths and each model's (config, batch, ms a
    whole step)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.train import model_config
    from repro_torch.models import transformer as tfm
    t_phase = time.time()
    paths, measured = {}, {}
    for name, short, depth, batch_size in ZOO_TRAIN:
        t_arch = time.time()
        cfg = model_config(name, smoke=False, layers=depth)
        params = tfm.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        b = next(lm_batches(cfg.vocab, batch_size, TRAIN_SEQ, 1, seed=0))
        batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        torch.cuda.synchronize()
        n = sum(t.numel() for t in tree_leaves(params))
        cut = ("full depth" if depth is None else
               f"depth cut to {depth} of {get_config(name).n_layers} "
               f"layers")
        print(f"[zoo-train] {name} at full width (d_model {cfg.d_model}), "
              f"{cut}, {cfg.n_layers} layers: {n / 1e9:.4g} B parameters; "
              f"batch {batch_size} x seq {TRAIN_SEQ}", flush=True)
        n_tok = batch_size * TRAIN_SEQ
        (la, ma, ga, ms_a, launch_a, var_a), got = _capture_train_inputs(
            lambda: _train_step(cfg, params, batch, remat=False))
        _check_grads_present(f"{short} remat off", ga)
        _check_train_launches(f"{short} step, remat off", cfg, n_tok, False,
                              launch_a, var_a)
        lb, mb, gb, ms_b, launch_b, var_b = _train_step(cfg, params, batch,
                                                        remat=True)
        _check_grads_present(f"{short} remat on", gb)
        _check_train_launches(f"{short} step, remat on", cfg, n_tok, True,
                              launch_b, var_b)
        print(f"[zoo-train] {short} first steps (the allocator's growth "
              f"and warm-up included): remat off {ms_a:.6g} ms, on "
              f"{ms_b:.6g} ms; loss {float(lb):.6g} (xent "
              f"{float(mb['xent']):.6g}, aux {float(mb['aux']):.4g})",
              flush=True)
        rel = abs(float(la) - float(lb)) / abs(float(lb))
        print(f"[zoo-train] {short} (c) remat on vs off: loss "
              f"{float(lb)!r} vs {float(la)!r} (relative {rel:.3g}, tol "
              f"{TRAIN_TOL['remat_loss']})", flush=True)
        if not rel <= TRAIN_TOL["remat_loss"]:
            _fail(f"zoo-train {short} (c): remat changed the loss")
        _compare_grads(f"{short} (c) remat on vs off", gb, ga,
                       TRAIN_TOL["remat_grad"])
        del ga
        lt, _, gt, ms_t, launch_t, _ = _twins_patched(
            lambda: _train_step(cfg, params, batch, remat=True))
        if any(launch_t.values()):
            _fail(f"zoo-train {short} (b): a kernel ran with the twins "
                  f"patched in: {launch_t}")
        rel = abs(float(lb) - float(lt)) / abs(float(lt))
        print(f"[zoo-train] {short} (b) bf16 kernels vs twins, remat on: "
              f"loss {float(lb):.6g} vs {float(lt):.6g} (relative "
              f"{rel:.3g}, tol {TRAIN_TOL['loss']}); the twins' step "
              f"{ms_t:.6g} ms", flush=True)
        if not rel <= TRAIN_TOL["loss"]:
            _fail(f"zoo-train {short} (b): kernel and twin losses differ")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        l32, _, g32, ms_32, _, _ = _twins_patched(
            lambda: _train_step(cfg32, p32, batch, remat=True))
        _compare_to_fp32(f"{short} (b) bf16", gb, gt, g32)
        del gb, gt
        lk32, _, gk32, ms_k32, launch_k32, _ = _train_step(cfg32, p32,
                                                           batch, True)
        rel = abs(float(lk32) - float(l32)) / abs(float(l32))
        print(f"[zoo-train] {short} (b) fp32 kernels vs twins, remat on: "
              f"loss {float(lk32)!r} vs {float(l32)!r} (relative {rel:.3g}, "
              f"tol {TRAIN_TOL['fp32_loss']}); steps {ms_k32:.6g} / "
              f"{ms_32:.6g} ms; launches {launch_k32}", flush=True)
        if launch_k32 != _train_expected(cfg, n_tok, True):
            _fail(f"zoo-train {short} (b): fp32 launches {launch_k32}")
        if not rel <= TRAIN_TOL["fp32_loss"]:
            _fail(f"zoo-train {short} (b): fp32 kernel and twin losses "
                  f"differ")
        _compare_grads(f"{short} (b) fp32 kernels vs twins", gk32, g32,
                       TRAIN_TOL["fp32_grad"])
        del gk32, g32, p32
        rows = {}
        bwd = _train_kernel_rows(short, cfg, got, rows)
        del got
        prof = _timed_train_steps(short, cfg, params, batch)
        measured[name] = (cfg, batch_size, prof["step_ms"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        losses, launches, by_variant, run = _train_run(
            name, short, cfg, depth, batch_size)
        if abs(losses[0] - float(lb)) > TRAIN_TOL["remat_loss"] * abs(
                float(lb)):
            _fail(f"zoo-train {short} (e): train()'s first loss "
                  f"{losses[0]!r} is not the remat step's {float(lb)!r}")
        for k in ARCH_LAUNCHERS:
            if launches[k] == 0:
                continue
            timed = [x for x in rows.get(k, []) if "kernel_ms" in x[1]]
            rec = _record_row(timed, launches[k], by_variant[k])
            rec.update(**prof, train_wall_s=run["wall_s"],
                       peak_gb=run["peak_gb"],
                       backward_ms=bwd[k][0], backward_bound_ms=bwd[k][1])
            paths.setdefault(k, {})[f"zoo_{short}_train"] = rec
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[zoo-train] {name}: {time.time() - t_arch:.1f} s",
              flush=True)
    print(f"[zoo-train] phase seconds {time.time() - t_phase:.1f}",
          flush=True)
    return paths, measured


# ---------------------------------------------------------------------------
# dryrun: the one-card dry-run's probes on the card (phase 13)
# ---------------------------------------------------------------------------
# (arch, short name, shape): between them all four kernels launch
DRYRUN_PAIRS = (
    ("internlm2-1.8b", "internlm2", "train_4k"),
    ("internlm2-1.8b", "internlm2", "prefill_32k"),
    ("internlm2-1.8b", "internlm2", "decode_32k"),
    ("internlm2-1.8b", "internlm2", "long_500k"),
    ("mamba2-370m", "mamba2", "prefill_32k"),
    ("mamba2-370m", "mamba2", "train_4k"),
    ("mamba2-370m", "mamba2", "decode_32k"),
    ("mixtral-8x22b", "mixtral", "prefill_32k"),
    ("mixtral-8x22b", "mixtral", "decode_32k"),
    ("seamless-m4t-medium", "seamless", "prefill_32k"),
    ("llama-3.2-vision-11b", "vision", "decode_32k"),
)
DRYRUN_REPS = 3           # timed runs a probe (their median), after a
#                           warm-up and the counted run: 2 + DRYRUN_REPS


def _roofline_report():
    """``benchmarks/roofline_report.py`` (stdlib only), loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "roofline_report", ROOT / "benchmarks" / "roofline_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dryrun_pair(dryrun, report, arch, short, shape):
    """One (arch, shape) through ``dryrun_one`` on the card, its launches
    counted from zero: checks (a)-(c) on each probe that ran
    (``dryrun.probe_problems``, tolerances ``dryrun.AGREE``), the
    launchers' counts against the probes' counted launches x runs, and
    (d) the record through ``roofline_report.fmt_table``."""
    t0 = time.time()
    for fn in ARCH_LAUNCHERS.values():
        fn.launches = 0
    _zero_variant_counts()
    rec = dryrun.dryrun_one(arch, shape, device="cuda", reps=DRYRUN_REPS,
                            verbose=False)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in ARCH_LAUNCHERS.items()}
    by_variant = {n: c for n, c in _variant_counts().items()
                  if n in ARCH_LAUNCHERS}
    want = {n: 0 for n in ARCH_LAUNCHERS}
    for row in rec["probes"]:
        tag = f"{short} {shape} P={row['periods']} B={row['batch']}"
        if "ms" not in row:
            print(f"[dryrun] {tag}: {row.get('skipped', 'not run')}",
                  flush=True)
            continue
        print(f"[dryrun] {tag}: {row['ms']:.6g} ms, bound "
              f"{1e3 * row['bound_s']:.6g} ms (share {row['share']:.4g}); "
              f"peak {row['peak_bytes'] / 1e9:.6g} GB measured / "
              f"{row['counted_peak_bytes'] / 1e9:.6g} counted; bytes "
              f"{row['bytes_accessed']:.6g} / "
              f"{row['counted_bytes_accessed']:.6g}; FLOPs and launches "
              f"equal: {row['count_equal']}",
              flush=True)
        bad = dryrun.probe_problems(row)
        if bad:
            _fail(f"dryrun {tag}: {bad}")
        for k, n in row["card_count"].items():
            if k.startswith("launches:"):
                want[k.split(":")[1]] += (2 + DRYRUN_REPS) * n
    if launches != want:
        _fail(f"dryrun {short} {shape}: the launchers counted {launches}, "
              f"the probes' counts x runs imply {want}")
    table = report.fmt_table([rec])
    m = rec.get("measured") or {}
    print(f"[dryrun] {short} {shape} ({rec['extrapolated']}): bound "
          f"{rec['roofline']['bound_s']:.6g} s ({rec['roofline']['dominant']}"
          f"), floor {rec['roofline']['memory_floor_s']:.6g} s, hbm "
          f"{rec['hbm_per_device_gb']:.6g} GB, fits {rec['fits_hbm']}; "
          f"extended from the probes: {m.get('ms')} ms, share "
          f"{m.get('share')}, peak {m.get('peak_bytes')} measured / "
          f"{m.get('counted_peak_bytes')} counted"
          f"{'; ' + m['note'] if m.get('note') else ''}; launches "
          f"{by_variant}; {time.time() - t0:.1f} s\n{table}", flush=True)
    return rec, launches, by_variant


def _zoo_bounds(dryrun, arch_measured, train_measured):
    """The bounds of what phases 11 and 12 measured, counted on ``meta``
    at the same configs and shapes: each model's prefill of 2 prompts
    (2048 tokens; seamless 256 under 2048 frames, the vision model's
    1600 image embeddings), one decode step over the prompt's cache,
    and each training step (remat, AdamW); each beside the time phase 11
    or 12 measured in this run, as the share bound / measured."""
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import transformer as tfm
    rows = []

    def decode_build(S, mem):
        def build(c):
            tokens = torch.empty((ZOO_BATCH, 1), dtype=torch.int32,
                                 device="meta")
            return dryrun.make_decode_step(c), (
                tfm.init_params(None, c),
                tfm.cache_struct(c, ZOO_BATCH, S, memory_len=mem), tokens, S)
        return build

    for name, (cfg, S, m) in arch_measured.items():
        pre = InputShape("prefill", "prefill", ZOO_PROMPT, ZOO_BATCH)
        mem = ZOO_PROMPT if cfg.encoder is not None else (
            cfg.n_image_tokens if cfg.vision_stub else 0)
        for what, build, ms in (
                ("prefill", lambda c: dryrun.build_step(c, pre, "meta"),
                 m["prefill_ms"]),
                ("decode step", decode_build(S, mem),
                 m["decode_ms_per_step"])):
            b = dryrun.bound_s(dryrun.count_extended(cfg, build))
            rows.append((name, what, b * 1e3, ms))
    for name, (cfg, batch, ms) in train_measured.items():
        sh = InputShape("train", "train", TRAIN_SEQ, batch)
        b = dryrun.bound_s(dryrun.count_extended(
            cfg, lambda c: dryrun.build_step(c, sh, "meta")))
        rows.append((name, f"train step {batch}x{TRAIN_SEQ}", b * 1e3, ms))
    for name, what, b, ms in rows:
        print(f"[dryrun] zoo bound: {name} {what}: bound {b:.6g} ms, "
              f"measured {ms:.6g} ms, share {b / ms:.4g}", flush=True)
    return rows


def phase_dryrun(arch_measured, train_measured):
    """Phase 13: ``launch/dryrun.py``'s probes on the card for
    DRYRUN_PAIRS, each checked (a)-(d), and the end-to-end bounds of
    phases 11 and 12.  Returns the record's ``dryrun_<model>_<shape>``
    paths."""
    from repro_torch.launch import dryrun
    t_phase = time.time()
    report = _roofline_report()
    paths, recs = {}, []
    for arch, short, shape in DRYRUN_PAIRS:
        rec, launches, by_variant = _dryrun_pair(dryrun, report, arch,
                                                 short, shape)
        recs.append(rec)
        for k, n in launches.items():
            if n:
                paths.setdefault(k, {})[f"dryrun_{short}_{shape}"] = {
                    "launches": n, "launches_by_variant": by_variant[k]}
        _free_card()
    print(report.fmt_table(recs), flush=True)
    missing = [k for k in ARCH_LAUNCHERS if k not in paths]
    if missing:
        _fail(f"dryrun: no probe launched {missing}")
    _zoo_bounds(dryrun, arch_measured, train_measured)
    print(f"[dryrun] phase seconds {time.time() - t_phase:.1f}", flush=True)
    return paths


# ---------------------------------------------------------------------------
# mesh: lane sharding of the batched engine (phase 14)
# ---------------------------------------------------------------------------
# the per-shard rows a data=2 mesh gives the kernels at buckets 8..64,
# and the mesh tolerance of the reference (tests/harness.py)
MESH_SHARD_ROWS = (4, 8, 16, 32)
MESH_RTOL, MESH_ATOL = 1e-4, 1e-6


def _mesh_kernel_rows(tokens, results):
    """(a) each cascade kernel against its twin at the rows one shard of
    a data=2 mesh gives it, timed beside its bound and the library
    call."""
    from repro_torch.models.kernel_students import (SSMStudentSpec,
                                                    TinyTFFlashSpec)
    gen = torch.Generator().manual_seed(2468)
    for rows in MESH_SHARD_ROWS:
        got = capture_path_inputs(rows, TinyTFFlashSpec(), SSMStudentSpec(),
                                  tokens, gen)
        (q, k, v), kw = got["flash_attention"]
        check("flash_attention", f"shard B={rows} causal fp32",
              lambda: fl_ops.flash_attention(q, k, v, **kw),
              lambda: flash_plain(q, k, v), TOL["flash_attention"], results,
              lambda: flash_library(q, k, v), flash_bound(q, k, v), True,
              variant="tiled")
        (q, k, v, pos), kw = got["decode_attention"]
        check("decode_attention", f"shard B={rows} pads fp32",
              lambda: dec_ops.decode_attention(q, k, v, pos, **kw),
              lambda: decode_plain(q, k, v, pos), TOL["decode_attention"],
              results, lambda: decode_library(q, k, v, pos),
              decode_bound(q, k, v, pos), True,
              variant=decode_variant(rows, k.shape[2], k.shape[1]))
        (x, adt, dt, B, C), kw = got["ssd_scan"]
        check("ssd_scan", f"shard B={rows} chunk {kw['chunk']}",
              lambda: ssd_ops.ssd_scan(x, adt, dt, B, C, **kw),
              lambda: ssd_scan_chunked_ref(x, adt, dt, B, C, kw["chunk"]),
              TOL["ssd_scan"], results, None,
              ssd_bound(x, adt, dt, B, C, kw["chunk"]), True, scaled=True,
              variant="whole")


def _mesh_run(tag, stream, mesh, opts, profiled):
    """The kernel ladder on ``stream`` (imdb, 64 lanes, mu 3e-7, seed 0,
    simulated expert) over ``mesh``, ``profiled`` or served by ``run``
    (idle share not measured); the engine, its metrics and report, and
    its launches by variant counted from zero over the run."""
    from repro_torch.core import SimulatedExpert
    for fn in LAUNCHERS.values():
        fn.launches = 0
    _zero_variant_counts()
    eng = _matrix_engine("kernel", SimulatedExpert(stream), mesh=mesh,
                         **opts)
    if profiled:
        m, rep = _profiled(tag, eng, stream)
    else:
        m = _matrix_run(tag, eng, stream)
        rep = _unprofiled_rep(m)
    by_variant = {n: c for n, c in _variant_counts().items()
                  if n in LAUNCHERS}
    return eng, m, rep, by_variant


def _mesh_pair(label, stream, mesh, opts, a, phase4=None, profiled=False):
    """One cell: the meshed run held to ``a``, phase 8 (c)'s unmeshed run
    with the same options (``_unmeshed_side``): routing, predictions,
    expert calls, level counts identical; params / dparams at the mesh
    tolerance; every shard's replica the canonical state; forwards by
    bucket equal; launches by variant = shards x the unmeshed run's; and,
    with ``phase4``, the unmeshed run equal to phase 4's."""
    from repro_torch.sharding import lane_count
    n = lane_count(mesh)
    ma, ra, va = a["m"], a["rep"], a["by_variant"]
    b, mb, rb, vb = _mesh_run(f"{label} mesh={mesh.shape} over "
                              f"{[str(d) for d in mesh.devices.flat]}",
                              stream, mesh, opts, profiled)
    div = _first_divergence(a["routing"], _routing_records(b))
    worst = 0.0
    for xs, lb in zip(a["state"], b.levels):
        for x, y in zip(xs, tree_leaves((lb.params, lb.dparams))):
            excess = (y.cpu() - x).abs() - MESH_RTOL * x.abs()
            worst = max(worst, float(excess.max()))
    replicas_ok = all(
        torch.equal(p, q)
        for i, lvl in enumerate(b.levels) for rep in b._replicas[i]
        for p, q in zip(tree_leaves(rep),
                        tree_leaves((lvl.params, lvl.dparams))))
    doubled = {k: {v: n * c for v, c in cs.items()} for k, cs in va.items()}
    print(f"[mesh] {label}: items_per_sec unmeshed (phase 8 (c)) "
          f"{ra['items_per_sec']:.1f} / meshed {rb['items_per_sec']:.1f}; "
          f"wall_ms_per_tick {ra['wall_ms_per_tick']:.3f} / "
          f"{rb['wall_ms_per_tick']:.3f}; device_idle_share "
          f"{ra['device_idle_share']} / {rb['device_idle_share']}; "
          f"accuracy {ma['accuracy']:.4f} / {mb['accuracy']:.4f}; "
          f"expert_calls {ma['expert_calls']} / {mb['expert_calls']}; "
          f"routing {'identical' if div is None else f'differs {div}'}; "
          f"max(|meshed - unmeshed| - rtol|unmeshed|) over params / "
          f"dparams {worst:.3g} (atol {MESH_ATOL}); replicas == canonical "
          f"{replicas_ok}; launches by variant unmeshed {va} meshed {vb}",
          flush=True)
    if div is not None or not np.array_equal(ma["predictions"],
                                             mb["predictions"]) \
            or ma["expert_calls"] != mb["expert_calls"] \
            or not np.array_equal(a["level_counts"], b.level_counts):
        _fail(f"mesh {label}: the meshed run routes otherwise ({div})")
    if not math.isfinite(worst) or worst > MESH_ATOL:
        _fail(f"mesh {label}: state {worst} past the mesh tolerance")
    if not replicas_ok:
        _fail(f"mesh {label}: a shard's replica is not the canonical state")
    if a["forwards_by_batch"] != [lvl.forwards_by_batch for lvl in b.levels]:
        _fail(f"mesh {label}: forwards by bucket differ")
    if vb != doubled or min(sum(c.values()) for c in va.values()) <= 0:
        _fail(f"mesh {label}: launches by variant {vb} != {n} x {va}")
    if phase4 is not None:
        if (ma["accuracy"], ma["expert_calls"]) != \
                (phase4["accuracy"], phase4["expert_calls"]) \
                or va != phase4["by_variant"]:
            _fail(f"mesh {label}: the unmeshed run is not phase 4's "
                  f"({ma['accuracy']} / {ma['expert_calls']} / {va} vs "
                  f"{phase4['accuracy']} / {phase4['expert_calls']} / "
                  f"{phase4['by_variant']})")
    return {"launches": {k: sum(c.values()) for k, c in vb.items()},
            "by_variant": vb, "items_per_sec": rb["items_per_sec"],
            "unmeshed_items_per_sec": ra["items_per_sec"],
            "idle": rb["device_idle_share"],
            "unmeshed_idle": ra["device_idle_share"]}


def phase_mesh(tokens, phase4, unmeshed):
    """14. mesh: (a) the three cascade kernels at a data=2 shard's rows;
    (b) the kernel ladder served over two shards on card 0 against phase
    8 (c)'s unmeshed run (``unmeshed``) and phase 4's; (c) the same at
    max_delay 2 with pipeline depth 2; (d) over every card, where there
    is more than one.  Returns the kernel rows and (b)'s numbers."""
    from repro_torch.data import make_stream
    from repro_torch.launch.mesh import make_mesh
    t_phase = time.time()
    results = {}
    _mesh_kernel_rows(tokens, results)
    stream = make_stream("imdb", seed=0, n_samples=MATRIX_ITEMS)
    mesh = make_mesh((2,), ("data",), ["cuda:0", "cuda:0"])
    meshed = _mesh_pair("(b) kernel ladder", stream, mesh, {},
                        unmeshed[0, 0], phase4, profiled=True)
    _mesh_pair("(c) max_delay=2 pipeline_depth=2", stream, mesh,
               {"max_delay": 2, "pipeline_depth": 2}, unmeshed[2, 2])
    n = torch.cuda.device_count()
    if n > 1 and MATRIX_BATCH % n == 0:
        _mesh_pair(f"(d) data={n} over distinct cards", stream,
                   make_mesh((n,), ("data",)), {}, unmeshed[0, 0])
    else:
        print(f"[mesh] (d) did not run: {n} CUDA device(s) visible "
              f"(it needs more than one, dividing {MATRIX_BATCH} lanes)",
              flush=True)
    print(f"[mesh] phase seconds {time.time() - t_phase:.1f}", flush=True)
    return results, meshed


# ---------------------------------------------------------------------------
# phase 15: the zoo's model sharding (tensor / expert parallel over a
# mesh's 'model' axis, both ranks on card 0 unless there are more cards)
# ---------------------------------------------------------------------------
MS_MAMBA, MS_MAMBA_LAYERS = "mamba2-370m", 16
# (c): the step in fp32 computes the unsharded step's function in
# another order, phase 12's fp32 rule (TRAIN_TOL)
MS_TRAIN_SEQ = 2048


def _ms_mesh(devices):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((1, 2), ("data", "model"), devices)


def _ms_expected(cfg, n_tokens, mode, ranks=2):
    """Launches a meshed prefill and MS_DECODE steps imply: every rank
    runs the unsharded layers' kernels at its shard's shape, so
    ``ranks`` x the unsharded count, except the MoE in expert mode, whose
    dispatch over the data slice is ungrouped (one (E/m, C, D) product
    per projection and layer however many tokens)."""
    exp = _zoo_expected(cfg, n_tokens, MS_DECODE)
    out = {ph: {k: ranks * v for k, v in d.items()} for ph, d in exp.items()}
    if mode == "expert" and cfg.moe is not None:
        n_moe = cfg.n_periods * len(cfg.moe_period_idx)
        out["prefill"]["moe_gmm"] = ranks * 3 * n_moe
    return out


def _ms_capture(fn):
    """Run ``fn(stage)`` recording the inputs of the first call of each
    kernel op by stage (layer 0 of rank 0; moe_gmm's up and down
    projections of the first MoE group that got tokens), as
    ``capture_zoo_inputs`` does."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    got, stage = {}, {"now": "prefill", "gmm": 0}
    real = {(moe_mod, "moe_gmm"): moe_mod.moe_gmm,
            (attn_mod, "flash_attention"): attn_mod.flash_attention,
            (attn_mod, "decode_attention"): attn_mod.decode_attention,
            (attn_mod, "decode_attention_partial"):
                attn_mod.decode_attention_partial,
            (ssm_mod, "ssd_scan"): ssm_mod.ssd_scan}

    def rec(name, f):
        def g(*args, **kw):
            if name == "moe_gmm":
                # a rank's products come in threes (w_in, w_gate, w_out);
                # keep the first up / down whose tokens are not all
                # dropped (an expert-mode rank may get none in a step)
                stage["gmm"] += 1
                k = stage["gmm"] % 3
                key = (stage["now"], "up" if k == 1 else "down")
                if k != 2 and (key not in got
                               or not bool(got[key][0][0].any())):
                    got[key] = (args, kw)
            else:
                got.setdefault(name, (args, kw))
            return f(*args, **kw)
        return g

    try:
        for (mod, name), f in real.items():
            setattr(mod, name, rec(name, f))
        fn(stage)
    finally:
        for (mod, name), f in real.items():
            setattr(mod, name, f)
    torch.cuda.synchronize()
    return got


def _ms_serve(tag, cfg, placed, mesh, tokens, want, fp32=None):
    """Prefill + MS_DECODE decode steps of ``placed`` over ``mesh`` fed
    the unsharded run's greedy tokens (``want``), launches and variants
    counted from zero around each phase; the logits held to ``want``'s
    at the bf16 rule (with ``fp32``, the same run's logits in fp32:
    no farther from them than phase 12's ratio x the unsharded bf16
    run is), and each step's greedy pick equal to the unsharded one
    unless the two are tied within the bf16 rule; the kernels' inputs
    captured."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding import specs as shd
    B, S = tokens.shape
    launches, by_variant, res = {}, {}, {}

    def read(phase):
        launches[phase] = {n: fn.launches for n, fn in ARCH_LAUNCHERS.items()}
        by_variant[phase] = {n: c for n, c in _variant_counts().items()
                             if n in ARCH_LAUNCHERS}

    def run(stage):
        for fn in ARCH_LAUNCHERS.values():
            fn.launches = 0
        _zero_variant_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = tfm.prefill(placed, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        read("prefill")
        for fn in ARCH_LAUNCHERS.values():
            fn.launches = 0
        _zero_variant_counts()
        stage.update(now="decode", gmm=0)
        res["logits"] = [col.unshard(last)]
        for step in range(MS_DECODE):
            logits, cache = tfm.decode_step(
                placed, cache, want["tokens"][step][:, None], S + step, cfg)
            res["logits"].append(col.unshard(logits))
        res["tokens"] = [lg.argmax(-1) for lg in res["logits"]]
        res["cache"] = cache
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        read("decode")
        res["prefill_ms"] = (t1 - t0) * 1e3
        res["decode_ms_per_step"] = (t2 - t1) * 1e3 / MS_DECODE

    shd.set_mesh(mesh)
    try:
        with torch.no_grad():
            got = _ms_capture(run)
    finally:
        shd.set_mesh(None)
    tol = ZOO_LOGIT_TOL["consistency"]
    errs = [max_err(a, b) for a, b in zip(res["logits"], want["logits"])]
    if fp32 is None:
        bad = max(float(((a.float() - b.float()).abs()
                         - tol * (1 + b.float().abs())).max())
                  for a, b in zip(res["logits"], want["logits"]))
    else:
        ratio, slack = TRAIN_TOL["bf16_ratio"], TRAIN_TOL["bf16_slack"]
        V = cfg.vocab               # the padded columns are -1e9
        dist = [(_rel_l2(a[:, :V], f[:, :V]), _rel_l2(b[:, :V], f[:, :V]))
                for a, b, f in zip(res["logits"], want["logits"], fp32)]
        bad = max(dm - (ratio * du + slack) for dm, du in dist)
        print(f"[model-sharding] {tag}: logits' relative l2 to the fp32 "
              f"run, meshed / unsharded bf16, per step "
              f"{[f'{dm:.4g} / {du:.4g}' for dm, du in dist]} (allowed "
              f"{ratio} x + {slack})", flush=True)
    same, ties = [], []
    for mine, ref, lg in zip(res["tokens"], want["tokens"], want["logits"]):
        same.append(bool(torch.equal(mine, ref)))
        # a pick that differs must be a tie within the rule: its
        # unsharded logit within tol (1 + |max|) of the unsharded max
        top = lg.float().max(-1).values
        at = lg.float().gather(-1, mine[:, None])[:, 0]
        tied = (mine != ref) & (at >= top - tol * (1 + top.abs()))
        ties.append(int(tied.sum()))
        if bool(((mine != ref) & ~tied).any()):
            _fail(f"{tag}: a meshed greedy token differs from the "
                  f"unsharded one beyond a tie: gap "
                  f"{(top - at)[mine != ref].tolist()}")
    print(f"[model-sharding] {tag}: prefill_ms={res['prefill_ms']:.6g} "
          f"decode_ms_per_step={res['decode_ms_per_step']:.6g}; logits vs "
          f"unsharded max|diff| per step {[f'{e:.4g}' for e in errs]} "
          f"(atol=rtol={tol}); greedy tokens equal {same}; picks that "
          f"differ within a tie of the rule {ties}", flush=True)
    if bad > 0 or not all(map(math.isfinite, errs)):
        _fail(f"{tag}: meshed logits disagree with the unsharded run")
    return launches, by_variant, res, got


def _ms_one_group(cfg, params, tokens, group=None):
    """The unsharded prefill + MS_DECODE greedy steps with the prompt's
    tokens in MoE dispatch groups of ``group`` (all of them by default);
    ``cache`` is the cache after the last step.  Expert mode over a data
    slice routes its T/dp tokens ungrouped at ``capacity_for(T/dp)``
    (the reference's ``shard_map`` body), not in groups of MOE_GROUP at
    a group's capacity as the local path does, so at (data 1) its
    function is this one with one group, not zoo-serve's; a batch of 1
    over (data 2) splits its sequence, so each data rank dispatches its
    own S/2 tokens: groups of S/2.  A decode step's tokens are one group
    either way."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    B, S = tokens.shape
    real = moe_mod.MOE_GROUP
    out = {"logits": [], "tokens": []}
    try:
        moe_mod.MOE_GROUP = group or B * S
        with torch.no_grad():
            last, cache = tfm.prefill(params, {"tokens": tokens}, cfg)
            out["logits"].append(last)
            out["tokens"].append(last.argmax(-1))
            for step in range(MS_DECODE):
                logits, cache = tfm.decode_step(
                    params, cache, out["tokens"][-1][:, None], S + step, cfg)
                out["logits"].append(logits)
                out["tokens"].append(logits.argmax(-1))
        out["cache"] = cache
    finally:
        moe_mod.MOE_GROUP = real
    return out


def _ms_check_launches(tag, cfg, n_tokens, mode, launches, by_variant,
                       unsharded, ranks=2):
    """Launches equal what the layers imply over ``ranks`` ranks, every
    one in the model's unsharded variant; printed beside the unsharded
    counts."""
    expect = _ms_expected(cfg, n_tokens, mode, ranks)
    want = _arch_variants(cfg)
    print(f"[model-sharding] {tag}: launches {launches} expected {expect}; "
          f"by variant {by_variant}; unsharded {unsharded}", flush=True)
    for phase in ("prefill", "decode"):
        for n in ARCH_LAUNCHERS:
            if launches[phase][n] != expect[phase][n]:
                _fail(f"{tag} {n}: {launches[phase][n]} {phase} launches != "
                      f"{expect[phase][n]}")
            v_want = {v: expect[phase][n] if v == want[n] else 0
                      for v in by_variant[phase][n]}
            if by_variant[phase][n] != v_want:
                _fail(f"{tag} {n}: {phase} launches by variant "
                      f"{by_variant[phase][n]} != {v_want}")


def _ms_rows(tag, got, results, attention=True, prefix="shard"):
    """Each kernel at its shard's shape against its plain version, timed
    with events beside its bound and the library call (labels start with
    ``<prefix> <tag>``); ``attention=False`` leaves out the attention rows
    (expert mode's attention is tensor mode's)."""
    if attention and "flash_attention" in got:
        (q, k, v), kw = got["flash_attention"]
        check("flash_attention", f"{prefix} {tag} prefill S={q.shape[1]} "
              f"H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]}",
              lambda: fl_ops.flash_attention(q, k, v, **kw),
              lambda: flash_plain(q, k, v, **kw), ZOO_TOL["bf16"], results,
              lambda: flash_library(q, k, v, **kw),
              flash_bound(q, k, v, **kw), True, relative=True, reps=10,
              variant="tc")
    if attention and "decode_attention" in got:
        (q, k, v, pos), kw = got["decode_attention"]
        check("decode_attention", f"{prefix} {tag} decode W={k.shape[1]} "
              f"H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]}",
              lambda: dec_ops.decode_attention(q, k, v, pos, **kw),
              lambda: decode_plain(q, k, v, pos), ZOO_TOL["bf16"], results,
              lambda: decode_library(q, k, v, pos),
              decode_bound(q, k, v, pos), True, relative=True,
              variant="split")
    for stage in ("prefill", "decode"):
        for proj in ("up", "down"):
            if (stage, proj) not in got:
                continue
            (x, w), _ = got[(stage, proj)]
            E, C, D = x.shape
            check("moe_gmm", f"{prefix} {tag} {stage} {proj} E{E} C={C} "
                  f"D={D} F={w.shape[2]}", lambda: gmm_ops.moe_gmm(x, w),
                  lambda: gmm_ref(x, w), ZOO_TOL["bf16"], results,
                  lambda: torch.bmm(x, w), gmm_bound(x, w), True,
                  relative=True, reps=10, variant="tc")
    if "ssd_scan" in got:
        (x, adt, dt, B, C), kw = got["ssd_scan"]
        L = kw["chunk"]
        check("ssd_scan", f"{prefix} {tag} prefill H{x.shape[2]} chunk {L} "
              f"N{B.shape[-1]}",
              lambda: ssd_ops.ssd_scan(x, adt, dt, B, C, chunk=L),
              lambda: ssd_scan_chunked_ref(x, adt, dt, B, C, L),
              ZOO_SSD_TOL, results, None, ssd_bound(x, adt, dt, B, C, L),
              True, scaled=True, reps=5, variant="parallel")


def _ms_train(cfg, params, tokens):
    """(c) One ``train_loss`` + backward of Mixtral at 1 layer, 1 x
    MS_TRAIN_SEQ, in fp32 (layer 0 of the zoo's weights, upcast): (data
    1, model 2) in tensor mode against the unsharded step, the loss and
    each gathered gradient leaf (the ranks' copies summed) at phase 12's
    fp32 rule."""
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import specs as shd
    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype="float32")
    p1 = {k: (tree_map(lambda t: t[:1].float(), v) if k == "blocks"
              else tree_map(lambda t: t.float(), v))
          for k, v in params.items()}
    batch = {"tokens": tokens[:1, :MS_TRAIN_SEQ],
             "targets": torch.roll(tokens[:1, :MS_TRAIN_SEQ], -1, 1)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0, m0, g0 = loss_and_grads(p1, batch, cfg1, remat=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mesh = _ms_mesh(["cuda:0", "cuda:0"])
    spec = shd.param_pspecs(p1, "tensor")
    placed = [tree_map(lambda t: t.detach().requires_grad_(True), r)
              for r in shd.place(p1, spec, mesh)]
    del p1
    for fn in ARCH_LAUNCHERS.values():
        fn.launches = 0
    shd.set_mesh(mesh)
    try:
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss, m = tfm.train_loss(placed, batch, cfg1, remat=False)
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        shd.set_mesh(None)
    launches = {n: fn.launches for n, fn in ARCH_LAUNCHERS.items()}
    grads = shd.gather_tree([tree_map(lambda t: t.grad, r) for r in placed],
                            spec, mesh, sum_replicas=True)
    del placed
    rel = abs(float(loss.detach()) - float(loss0)) / abs(float(loss0))
    print(f"[model-sharding] (c) {cfg1.name} 1 layer fp32, 1 x "
          f"{MS_TRAIN_SEQ}, model=2 tensor mode: loss "
          f"{float(loss.detach()):.8g} vs "
          f"unsharded {float(loss0):.8g} (rel {rel:.3g}, tol "
          f"{TRAIN_TOL['fp32_loss']}); aux "
          f"{float(m['aux'].detach()):.6g} vs "
          f"{float(m0['aux']):.6g}; step ms meshed {(t3 - t2) * 1e3:.6g} "
          f"unsharded {(t1 - t0) * 1e3:.6g}; launches {launches}",
          flush=True)
    if not rel <= TRAIN_TOL["fp32_loss"]:
        _fail(f"model-sharding (c): loss off by {rel} relative")
    _compare_grads("model-sharding (c) gathered gradients", grads, g0,
                   TRAIN_TOL["fp32_grad"])
    if min(launches.values()) < 0 or launches["flash_attention"] != 2 \
            or launches["moe_gmm"] != 2 * 3:
        _fail(f"model-sharding (c): launches {launches}; the forward runs "
              f"one flash and one MoE layer's 3 grouped products a rank")


def _ms_profile(tag, cfg, placed, mesh, tokens):
    """zoo-profile's prefill and 4 decode steps of the placed model over
    ``mesh``: device busy / idle and ms by kernel group."""
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding import specs as shd
    shd.set_mesh(mesh)
    try:
        phase_zoo_profile(cfg, placed, {"tokens": tokens},
                          tag=f"model-sharding {tag} profile",
                          whole=col.unshard)
    finally:
        shd.set_mesh(None)


def _ms_beside(results, *unsharded):
    """Each shard row's events ms beside the unsharded row of the same
    kernel, stage and projection (zoo-kernels' rows; (b)'s own unsharded
    SSD row)."""
    plain = [(n, lab, r) for res in unsharded for n, rows in res.items()
             for lab, r in rows if "kernel_ms" in r]
    for name, rows in results.items():
        for lab, r in rows:
            words = lab.split()
            stage = next(w for w in ("prefill", "decode") if w in words)
            proj = next((w for w in ("up", "down") if w in words), "")
            model = "mamba2" if "mamba2" in words else "zoo"
            twin = [(pl, pr) for n, pl, pr in plain if n == name
                    and stage in pl.split() and (not proj or proj in
                                                 pl.split())
                    and ((model == "mamba2") == ("mamba2" in pl.split()))]
            if twin:
                pl, pr = twin[0]
                print(f"[model-sharding] {name} [{lab}] {r['kernel_ms']:.6g}"
                      f" ms beside [{pl}] {pr['kernel_ms']:.6g} ms "
                      f"(x{r['kernel_ms'] / pr['kernel_ms']:.3f})",
                      flush=True)


# (e') / (e''): (tag, the run's key, arch (None: the zoo's Mixtral),
# layers, batch, mesh (data, model) on cuda:0, the axes the cache length
# splits over, whether a decode step gathers the queries and the new
# token's k / v over 'model')
MS_SPLIT = (
    ("(e') qwen3 model16", "qwen3_model16", "qwen3-8b", 2, 2, (1, 16),
     ("model",), True, True),
    ("(e'') mixtral data2", "mixtral_data2", None, ZOO_LAYERS, 1, (2, 2),
     ("data",), False, False),
)
# the "partial" row: an fp32 state from the same bf16 inputs, its sums in
# another order; each element within this x (1 + |plain|)
PARTIAL_TOL = 1e-4
# the gathered cache against the unsharded one: every slot within the
# bf16 rule in the first period (its k / v come from the embeddings
# alone) and in a dense model; after a MoE layer, a token whose bf16
# routing tips the other way between the two runs (the row-parallel
# sums round differently) takes another expert, so its later k / v
# differ by O(1): at most this share of (row, slot) pairs there (0.0088
# measured on Mixtral's second layer at (data 2, model 2), PERF.md §6)
MS_MOE_SLOT_SHARE = 0.03


def partial_plain(q, k, v, pos):
    """The partial twin's (M, L, acc) packed as the kernel stores them."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    if pos.ndim == 1:
        pos = pos[None].expand(B, pos.shape[0])
    m, l, acc = decode_attention_partial_ref(
        q[:, 0].reshape(B, K, H // K, hd), k, v, pos, sm_scale=hd ** -0.5)
    return torch.cat([m.flatten(), l.flatten(), acc.flatten()])


def partial_library(q, k, v, pos):
    """One PyTorch call that returns the same state in another form
    (out = acc / L and lse = M + log L): memory-efficient SDPA with its
    log-sum-exp, on k / v repeated to the query heads before it is timed
    (the call has no GQA), empty slots as an additive bias."""
    B, _, H, hd = q.shape
    G = H // k.shape[2]
    if pos.ndim == 1:
        pos = pos[None].expand(B, pos.shape[0])
    qt = q.transpose(1, 2).contiguous()
    kr = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vr = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    bias = None
    if not bool((pos >= 0).all()):
        bias = torch.zeros((B, H, 1, pos.shape[1]), dtype=q.dtype,
                           device=q.device).masked_fill(
            (pos < 0)[:, None, None, :], float("-inf"))

    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kr, vr, bias, True)[0]


def _ms_partial_row(tag, got, results):
    """The "partial" kernel at a rank's decode shape (layer 0 of rank 0)
    against its plain twin, timed beside its bound and the library
    call."""
    (q, k, v, pos), _ = got["decode_attention_partial"]
    B, _, H, hd = q.shape
    posb = pos[None].expand(B, pos.shape[0]) if pos.ndim == 1 else pos
    bound = roofline.decode_cost(q.shape, k.shape, q.dtype,
                                 int((posb >= 0).sum()),
                                 partial=True).bound_ms()
    check("decode_attention", f"shard {tag} decode partial W={k.shape[1]} "
          f"H{H}/K{k.shape[2]} hd{hd}",
          lambda: dec_ops.decode_attention_partial(q, k, v, pos)[0]._base,
          lambda: partial_plain(q, k, v, pos), PARTIAL_TOL, results,
          partial_library(q, k, v, pos), bound, True, variant="partial",
          per_element=True)


def _ms_split_part(part, zoo_cfg, zoo_params, prompts, results, runs):
    """(e') / (e''): a model served over a mesh whose cache length is
    split (``cache_pspecs``), against its unsharded run on the card (the
    MoE in dispatch groups of a data rank's tokens, as the meshed prefill
    dispatches them): logits at the bf16 rule and greedy picks equal but
    for ties (``_ms_serve``); the gathered cache within the same rule of
    the unsharded one (positions equal), each rank's k of the spec's
    shape; "partial" launches = ranks x layers x steps and no other
    decode-attention variant; one more decode step counted (``launch.
    dryrun.count_mesh_step``): rank 0's all-gather bytes equal the
    activations the layout gathers, and no weight; the partial kernel's
    row.  The gathered cache is held per period (``MS_MOE_SLOT_SHARE``
    says why a MoE model's later periods may hold a few rows apart)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharded
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import specs as shd
    (tag, run, arch, layers, batch, mesh_shape, length, gather_q,
     gather_kv) = part
    t0 = time.time()
    if arch is None:
        cfg, params = zoo_cfg, zoo_params
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params = tfm.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = prompts[:batch] % cfg.vocab
    B, S = tokens.shape
    dp, m = mesh_shape
    n = dp * m
    want = _ms_one_group(cfg, params, tokens, group=B * S // dp)
    mesh = make_mesh(mesh_shape, ("data", "model"), ["cuda:0"] * n)
    placed = shd.place(params, shd.param_pspecs(params), mesh)
    launches, by_variant, res, got = _ms_serve(
        f"{tag} {cfg.name} {layers} layers B={B}", cfg, placed, mesh,
        tokens, want)
    a, L = cfg.attn, cfg.n_layers
    dv = by_variant["decode"]["decode_attention"]
    expect = {**dict.fromkeys(dv, 0), "partial": n * L * MS_DECODE}
    print(f"[model-sharding] {tag}: launches {launches}; decode attention "
          f"by variant {dv}, expected {expect}", flush=True)
    if dv != expect or launches["prefill"]["flash_attention"] != n * L:
        _fail(f"{tag}: decode attention by variant {dv} != {expect}, or "
              f"{launches['prefill']['flash_attention']} prefill flash "
              f"launches != {n * L}")
    cache = res["cache"]
    split = {"data": dp, "model": m}
    rows = B // dp if B % dp == 0 else B
    heads = a.n_kv_heads // m if a.n_kv_heads % m == 0 else a.n_kv_heads
    k_shape = (cfg.n_periods, rows, S // math.prod(split[x] for x in length),
               heads, a.head_dim)
    shd.set_mesh(mesh)
    try:
        whole = sharded.gather_cache(cache, cfg)
        shapes = {tuple(c["b0"]["k"].shape) for c in cache.parts}
        flat = dry.count_mesh_step(
            lambda p, c: tfm.decode_step(p, c, res["tokens"][-1][:, None],
                                         S + MS_DECODE, cfg),
            (placed, cache), 0.0)
    finally:
        shd.set_mesh(None)
    if shapes != {k_shape}:
        _fail(f"{tag}: the ranks' k {shapes} != {k_shape}, the spec's")
    tol = ZOO_LOGIT_TOL["consistency"]
    worst, share = {}, {}
    for b, leaves in want["cache"].items():
        for name, t in leaves.items():
            g = whole[b][name]
            if name == "pos":
                if not torch.equal(g, t):
                    _fail(f"{tag}: gathered {b}/pos != the unsharded one")
                continue
            over = ((g.float() - t.float()).abs()
                    - tol * (1 + t.float().abs()))      # (P, B, W, K, hd)
            for i in range(over.shape[0]):
                worst[f"{b}/{name}[{i}]"] = float(over[i].max())
                share[f"{b}/{name}[{i}]"] = float(
                    (over[i].amax((-2, -1)) > 0).float().mean())
    print(f"[model-sharding] {tag}: share of (row, slot) pairs beyond the "
          f"rule by leaf and period {share}", flush=True)
    el = torch.finfo(cfg.torch_dtype).bits // 8
    ag = L * el * rows * a.head_dim * (a.n_heads * gather_q
                                       + 2 * a.n_kv_heads * gather_kv)
    print(f"[model-sharding] {tag}: ranks' k {k_shape}; gathered cache "
          f"vs unsharded, max |diff| - {tol} (1 + |ref|) by leaf {worst}; "
          f"one decode step counted on rank 0: all-gather "
          f"{flat.get('collective:all-gather', 0.0):.0f} B (activations "
          f"{ag} B expected), all-reduce "
          f"{flat.get('collective:all-reduce', 0.0):.0f} B", flush=True)
    for key, w in worst.items():
        later = not key.endswith("[0]") and cfg.moe is not None
        if w > 0 and not (later and share[key] <= MS_MOE_SLOT_SHARE):
            _fail(f"{tag}: the gathered cache's {key} disagrees with the "
                  f"unsharded one ({share[key]} of its rows beyond the "
                  f"rule)")
    if flat.get("collective:all-gather", 0.0) != ag:
        _fail(f"{tag}: a decode step all-gathers "
              f"{flat.get('collective:all-gather', 0.0)} B, not the "
              f"{ag} B of its activations")
    _ms_partial_row(tag.split(" ", 1)[1], got, results)
    runs[run] = (launches, by_variant)
    print(f"[model-sharding] {tag}: part seconds {time.time() - t0:.1f}",
          flush=True)


# (e'''): the Mamba half of the reference's layout: (tag, the run's key,
# arch, depth (layers; fewer than the period's blocks: its first ones),
# mesh (data, model) on cuda:0).  mamba2's 32 heads give 2 a rank over
# 16, and a rank's 274 in_proj columns do not line up with heads;
# Jamba's first two blocks (MAMBA, then MAMBA with the MoE FFN) hold its
# unsharded bf16 weights and their shards near 46 GB (the fp32 copy the
# rule needs, 47 GB, is made and freed before the shards are placed)
MS_MAMBA_SPLIT = (
    ("(e''') mamba2 model16", "mamba2_model16", "mamba2-370m",
     MS_MAMBA_LAYERS, (1, 16)),
    ("(e''') jamba model4", "jamba_model4", "jamba-1.5-large-398b", 2,
     (1, 4)),
)


def _ms_cut(arch, depth):
    """``arch`` at published widths, ``depth`` layers: the first
    ``depth`` blocks of its period where that is longer."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    if depth >= len(full.period):
        return dataclasses.replace(full, n_layers=depth)
    return dataclasses.replace(
        full, n_layers=depth, period=full.period[:depth],
        moe_period_idx=tuple(i for i in full.moe_period_idx if i < depth))


def _cast_leaves(tree, dtypes):
    """Cast ``tree``'s leaves in place to ``dtypes`` (a dtype, or a tree
    of them), one leaf at a time, so that each old leaf is freed as soon
    as its copy exists."""
    for k, v in tree.items():
        d = dtypes[k] if isinstance(dtypes, dict) else dtypes
        if isinstance(v, dict):
            _cast_leaves(v, d)
        else:
            tree[k] = v.to(d)


def _ms_unsharded(cfg, params, tokens, fed=None):
    """The unsharded prefill + MS_DECODE decode steps on the card, greedy
    or fed ``fed``'s tokens: logits, greedy tokens, the cache after the
    last step, decode ms a step and the launches by variant of the
    whole run."""
    from repro_torch.models import transformer as tfm
    S = tokens.shape[1]
    for fn in ARCH_LAUNCHERS.values():
        fn.launches = 0
    _zero_variant_counts()
    out = {"logits": [], "tokens": []}
    with torch.no_grad():
        last, cache = tfm.prefill(params, {"tokens": tokens}, cfg)
        out["logits"].append(last)
        out["tokens"].append(last.argmax(-1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(MS_DECODE):
            tok = (fed or out["tokens"])[step]
            logits, cache = tfm.decode_step(params, cache, tok[:, None],
                                            S + step, cfg)
            out["logits"].append(logits)
            out["tokens"].append(logits.argmax(-1))
        torch.cuda.synchronize()
    out["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / MS_DECODE
    out["cache"] = cache
    out["by_variant"] = {n: c for n, c in _variant_counts().items()
                         if n in ARCH_LAUNCHERS}
    return out


def _ms_mamba_part(part, prompts, results, runs):
    """(e'''): a Mamba model served over a mesh whose in_proj / conv are
    contiguous column shards and whose conv cache follows
    ``cache_pspecs``, against its unsharded run on the card by (b)'s
    rule (the logits and each gathered conv / ssm leaf no farther from
    the fp32 run than TRAIN_TOL's ratio x the unsharded bf16 run's plus
    its slack, relative l2; greedy picks equal but for ties); each
    rank's cache leaves of ``shard_cache``'s shapes; launches = ranks x
    unsharded, in its variants; one more decode step counted on the
    card: rank 0's all-gather bytes = the activations (rows x (d_proj +
    d_xbc) a layer) = the ``meta`` count at the same shapes, and every
    gathered part one token's; ms a decode step meshed vs unsharded;
    the SSD and moe_gmm shard rows."""
    from repro_torch.launch import dryrun as dry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models import sharded
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding import specs as shd
    tag, run, arch, depth, mesh_shape = part
    t0 = time.time()
    cfg = _ms_cut(arch, depth)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    tokens = prompts % cfg.vocab
    B, S = tokens.shape
    dp, m = mesh_shape
    n = dp * m
    want = _ms_unsharded(cfg, params, tokens)
    torch.cuda.empty_cache()
    dtypes = tree_map(lambda t: t.dtype, params)
    _cast_leaves(params, torch.float32)
    ref32 = _ms_unsharded(dataclasses.replace(cfg, dtype="float32"), params,
                          tokens, fed=want["tokens"])
    _cast_leaves(params, dtypes)
    torch.cuda.empty_cache()
    mesh = make_mesh(mesh_shape, ("data", "model"), ["cuda:0"] * n)
    placed = shd.place(params, shd.param_pspecs(params), mesh)
    del params
    torch.cuda.empty_cache()
    label = f"{tag} {cfg.name} {cfg.n_layers} layers {cfg.period} B={B}"
    launches, by_variant, res, got = _ms_serve(
        label, cfg, placed, mesh, tokens, want, ref32["logits"])
    _ms_check_launches(tag, cfg, B * S, "tensor", launches, by_variant,
                       want["by_variant"], ranks=n)
    parts = []
    real = col.all_gather

    def gather(ps, *args, **kw):
        parts.extend(tuple(p.shape) for p in ps)
        return real(ps, *args, **kw)

    shd.set_mesh(mesh)
    try:
        whole = sharded.gather_cache(res["cache"], cfg)
        split = sharded.shard_cache(want["cache"], cfg).parts
        col.all_gather = gather
        try:
            flat = dry.count_mesh_step(
                lambda p, c: tfm.decode_step(p, c, res["tokens"][-1][:, None],
                                             S + MS_DECODE, cfg),
                (placed, res["cache"]), 0.0)
        finally:
            col.all_gather = real
    finally:
        shd.set_mesh(None)
    bad = [(r, b, name) for r, (mine, spec) in enumerate(zip(
        res["cache"].parts, split)) for b in spec for name in spec[b]
        if mine[b][name].shape != spec[b][name].shape]
    if bad:
        _fail(f"{tag}: rank, block, leaf {bad[:4]} not of cache_pspecs' "
              f"shape")
    ratio, slack = TRAIN_TOL["bf16_ratio"], TRAIN_TOL["bf16_slack"]
    dist = {f"{b}/{name}": (_rel_l2(whole[b][name], f),
                            _rel_l2(want["cache"][b][name], f))
            for b, leaves in ref32["cache"].items()
            for name, f in leaves.items()}
    print(f"[model-sharding] {tag}: a rank's conv "
          f"{tuple(split[0]['b0']['conv'].shape)}, ssm "
          f"{tuple(split[0]['b0']['ssm'].shape)} (cache_pspecs); the "
          f"gathered cache's relative l2 to the fp32 run, meshed / "
          f"unsharded bf16, by leaf "
          f"{ {k: f'{dm:.4g} / {du:.4g}' for k, (dm, du) in dist.items()} } "
          f"(allowed {ratio} x + {slack})", flush=True)
    over = {k: dm - (ratio * du + slack) for k, (dm, du) in dist.items()}
    if max(over.values()) > 0:
        _fail(f"{tag}: gathered cache leaves beyond (b)'s rule: "
              f"{ {k: v for k, v in over.items() if v > 0} }")
    mm = make_mesh(mesh_shape, ("data", "model"), "meta")
    step, args, args_b = dry.build_mesh_step(
        cfg, InputShape("decode_mesh", "decode", S + MS_DECODE, B), mm,
        "meta")
    try:
        meta = dry.count_mesh_step(step, args, args_b)
    finally:
        shd.set_mesh(None)
    d_in, n_heads, d_xbc = ssm_mod.dims(cfg)
    d_proj = 2 * d_in + 2 * cfg.ssm.d_state + n_heads
    rows = B // dp if B % dp == 0 else B
    el = torch.finfo(cfg.torch_dtype).bits // 8
    n_mamba = cfg.n_periods * cfg.period.count("mamba")
    ag = n_mamba * rows * (d_proj + d_xbc) * el
    got_ag = flat.get("collective:all-gather", 0.0)
    meta_ag = meta.get("collective:all-gather", 0.0)
    print(f"[model-sharding] {tag}: one decode step on rank 0: all-gather "
          f"{got_ag:.0f} B on the card, {meta_ag:.0f} B counted on meta, "
          f"{ag} B expected ({n_mamba} layers x {rows} rows x "
          f"(d_proj {d_proj} + d_xbc {d_xbc}) x {el} B), all-reduce "
          f"{flat.get('collective:all-reduce', 0.0):.0f} / "
          f"{meta.get('collective:all-reduce', 0.0):.0f} B; gathered part "
          f"shapes {sorted(set(parts))}; decode ms a step meshed "
          f"{res['decode_ms_per_step']:.6g} vs unsharded "
          f"{want['decode_ms_per_step']:.6g}", flush=True)
    if not got_ag == meta_ag == ag:
        _fail(f"{tag}: a decode step all-gathers {got_ag} B on the card, "
              f"{meta_ag} B on meta, not the {ag} B of its activations")
    if not parts or any(p[:2] != (rows, 1) for p in parts):
        _fail(f"{tag}: an all-gather of a decode step carries more than "
              f"one token's activations: {sorted(set(parts))}")
    _ms_rows(tag.split(" ", 1)[1], got, results)
    runs[run] = (launches, by_variant)
    del placed, res, got, want, ref32, whole, split
    torch.cuda.empty_cache()
    print(f"[model-sharding] {tag}: part seconds {time.time() - t0:.1f}",
          flush=True)


def phase_model_sharding(cfg, params, prompts, zoo_out, zoo_by_variant,
                         zoo_results):
    """15. model-sharding: (a) the zoo's Mixtral (zoo-serve's weights and
    prompts) over a (data 1, model 2) mesh on card 0 twice, tensor mode
    against zoo-serve's unsharded outputs, expert mode against the
    unsharded run with the prompt in one dispatch group
    (``_ms_one_group``); (b) mamba2-370m
    at MS_MAMBA_LAYERS the same way against its own unsharded run; (c) one
    training step at 1 layer in fp32; (d) (a) over distinct cards where
    there are more than one; (e') / (e'') length-split attention caches
    (``_ms_split_part``); (e''') the Mamba half of the layout
    (``_ms_mamba_part``).  Returns the kernel rows and each run's
    launches for the record."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import specs as shd
    t_phase = time.time()
    results, runs = {}, {}
    B, S = prompts.shape
    mesh = _ms_mesh(["cuda:0", "cuda:0"])
    unsharded = {ph: {n: zoo_by_variant[ph][n] for n in ZOO_LAUNCHERS}
                 for ph in ("prefill", "decode")}
    for mode in ("tensor", "expert"):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, sharding_mode=mode))
        want = zoo_out if mode == "tensor" else _ms_one_group(cfg, params,
                                                               prompts)
        placed = shd.place(params, shd.param_pspecs(params, mode), mesh)
        tag = f"(a) {cfg.name} {mode} mode"
        launches, by_variant, res, got = _ms_serve(
            tag, c, placed, mesh, prompts, want)
        _ms_check_launches(tag, c, B * S, mode, launches, by_variant,
                           unsharded)
        _ms_rows(f"mixtral {mode}", got, results, mode == "tensor")
        _ms_profile(f"(a) {mode}", c, placed, mesh, prompts)
        runs[f"mixtral_{mode}"] = (launches, by_variant)
        del placed, got, res
        torch.cuda.empty_cache()
    # (b) mamba2-370m, depth cut to MS_MAMBA_LAYERS
    from repro_torch.configs import get_config
    mcfg = dataclasses.replace(get_config(MS_MAMBA),
                               n_layers=MS_MAMBA_LAYERS)
    mparams = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                              mcfg)
    mtok = prompts[:, :S] % mcfg.vocab
    with torch.no_grad():
        state = {}
        plain_got = _ms_capture(lambda stage: state.update(zip(
            ("last", "cache"), tfm.prefill(mparams, {"tokens": mtok},
                                           mcfg))))
        last, cache = state["last"], state["cache"]
        want = {"logits": [last], "tokens": [last.argmax(-1)]}
        for step in range(MS_DECODE):
            logits, cache = tfm.decode_step(
                mparams, cache, want["tokens"][-1][:, None], S + step, mcfg)
            want["logits"].append(logits)
            want["tokens"].append(logits.argmax(-1))
        # the same steps in fp32: 48 bf16 layers carry a rounding that
        # the row-parallel partial sums change, so (b) is held to the
        # fp32 run (phase 12's rule) rather than to one bf16 run
        m32 = dataclasses.replace(mcfg, dtype="float32")
        p32 = tree_map(lambda t: t.float(), mparams)
        last, cache = tfm.prefill(p32, {"tokens": mtok}, m32)
        fp32 = [last]
        for step in range(MS_DECODE):
            logits, cache = tfm.decode_step(
                p32, cache, want["tokens"][step][:, None], S + step, m32)
            fp32.append(logits)
    del cache, p32
    placed = shd.place(mparams, shd.param_pspecs(mparams), mesh)
    tag = f"(b) {mcfg.name} {MS_MAMBA_LAYERS} layers"
    launches, by_variant, _, got = _ms_serve(tag, mcfg, placed, mesh, mtok,
                                             want, fp32)
    _ms_check_launches(tag, mcfg, B * S, "tensor", launches, by_variant,
                       f"{MS_MAMBA_LAYERS} SSD scans at 32 heads")
    _ms_profile("(b)", mcfg, placed, mesh, mtok)
    _ms_rows("mamba2", got, results)
    unsharded_rows = {}
    _ms_rows("mamba2", plain_got, unsharded_rows, prefix="unsharded")
    _ms_beside(results, zoo_results, unsharded_rows)
    runs["mamba2"] = (launches, by_variant)
    del placed, mparams, got, want, plain_got
    torch.cuda.empty_cache()
    # (c) training
    _ms_train(cfg, params, prompts)
    torch.cuda.empty_cache()
    # (d) over distinct cards
    n = torch.cuda.device_count()
    if n > 1:
        mesh_d = _ms_mesh(["cuda:0", "cuda:1"])
        placed = shd.place(params, shd.param_pspecs(params), mesh_d)
        launches, by_variant, _, _ = _ms_serve(
            "(d) model=2 over cuda:0 and cuda:1", cfg, placed, mesh_d,
            prompts, zoo_out)
        _ms_check_launches("(d)", cfg, B * S, "tensor", launches,
                           by_variant, unsharded)
        del placed
    else:
        print(f"[model-sharding] (d) did not run: {n} CUDA device(s) "
              f"visible (it needs two cards)", flush=True)
    # (e') / (e''): the reference's length-split cache layout
    t_e = time.time()
    for part in MS_SPLIT:
        _ms_split_part(part, cfg, params, prompts, results, runs)
        torch.cuda.empty_cache()
    print(f"[clock] model-sharding (e') / (e'') took "
          f"{time.time() - t_e:.1f} s, ended at {time.time() - _T0:.1f} s",
          flush=True)
    # (e'''): the Mamba half of the reference's layout
    t_e = time.time()
    for part in MS_MAMBA_SPLIT:
        _ms_mamba_part(part, prompts, results, runs)
    print(f"[clock] model-sharding (e''') took {time.time() - t_e:.1f} s, "
          f"ended at {time.time() - _T0:.1f} s", flush=True)
    print(f"[model-sharding] phase seconds {time.time() - t_phase:.1f}",
          flush=True)
    return results, runs


def model_sharding_paths(results, runs):
    """The record's paths of phase 15: each kernel's timed shard row with
    the launches (both ranks') of the run it was captured in."""
    paths = {}
    for name, rows in results.items():
        for run, tag in (("mixtral_tensor", "mixtral tensor"),
                         ("mixtral_expert", "mixtral expert"),
                         ("mamba2", "mamba2"),
                         ("qwen3_model16", "qwen3 model16"),
                         ("mixtral_data2", "mixtral data2"),
                         ("mamba2_model16", "mamba2 model16"),
                         ("jamba_model4", "jamba model4")):
            launches, by_variant = runs[run]
            for phase in ("prefill", "decode"):
                mine = [(lab, r) for lab, r in rows
                        if lab.startswith(f"shard {tag} {phase}")]
                if not mine:
                    continue
                n = launches[phase][name]
                paths.setdefault(name, {})[
                    f"model_sharding_{run}_{phase}"] = _record_row(
                        mine, n, by_variant[phase][name])
    return paths


# ---------------------------------------------------------------------------
# phase 16: training and the dry-run over a mesh (ranks on card 0)
# ---------------------------------------------------------------------------
MT_ARCH, MT_LAYERS = "internlm2-1.8b", 2
MT_BATCH, MT_SEQ, MT_STEPS = 4, 2048, 3
MT_MOE = "mixtral-8x22b"
# (a): tests/test_torch_train.py's AdamW rule, 0.1 lr a weight a step
# (where |g| is within rounding of zero an Adam step's sign can tilt),
# and phase 12's fp32 loss rule TRAIN_TOL["fp32_loss"]
MT_STEP_TOL = 0.1
# (c): the probe counted on meta and on the card
MT_PROBE = ("internlm2-1.8b", 2, 2)          # arch, periods, batch
# (d): 16x16 records counted on meta in processes of their own after
# (a)-(c) (``launch.dryrun`` counts each one's probes at once)
MT_RECORDS = (("qwen3-8b", "train_4k", ()),
              ("mixtral-8x22b", "train_4k", ("--zero",)))
MT_RECORD_S = 600


def _mt_records_start():
    """(d) Start one ``launch.dryrun --mesh 16x16 --device meta`` process
    a record (no card: CUDA_VISIBLE_DEVICES is empty)."""
    import os
    out = ROOT / "chiprun_out" / "dryrun_mesh"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, extra in MT_RECORDS:
        tag = "".join(e.strip("-").replace("-", "_") for e in extra)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "16x16", "--device",
               "meta", "--out", str(out), "--tag",
               f"_16x16{'_' + tag if tag else ''}", *extra]
        procs.append((arch, shape, extra, out / f"{arch}__{shape}_16x16"
                      f"{'_' + tag if tag else ''}.json",
                      subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      time.time()))
    return procs


def _mt_records_finish(procs):
    """(d) Each record's count seconds, per-device counts and collective
    term; a process that fails or outlives MT_RECORD_S fails the
    phase."""
    try:
        for arch, shape, extra, path, proc, t0 in procs:
            try:
                out, _ = proc.communicate(timeout=max(
                    1.0, MT_RECORD_S - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                _fail(f"mesh-train-dryrun (d): {arch} x {shape} not counted "
                      f"in {MT_RECORD_S} s")
            if proc.returncode != 0:
                _fail(f"mesh-train-dryrun (d): {arch} x {shape} exited "
                      f"{proc.returncode}: {out[-2000:]}")
            rec = json.loads(path.read_text())
            if not rec["collective_bytes_per_device"] > 0:
                _fail(f"mesh-train-dryrun (d): {arch} x {shape}: no "
                      f"collective bytes")
            t = rec["roofline"]
            print(f"[mesh-train-dryrun] (d) {arch} x {shape} on "
                  f"{rec['mesh']} ({rec['n_devices']} devices, "
                  f"{rec['counted_ranks']} ranks counted) options "
                  f"{rec['options']}: count {rec['lower_s']} s "
                  f"(collected {time.time() - t0:.1f} s after its "
                  f"start); per device "
                  f"flops {rec['flops_by_dtype']} bytes "
                  f"{rec['bytes_per_device']:.6g} collectives "
                  f"{rec['collectives']} (collective term "
                  f"{t['collective_s']:.6g} s at "
                  f"{roofline.H100.link_bw:.3g} B/s; compute "
                  f"{t['compute_s']:.6g} s, memory {t['memory_s']:.6g} s, "
                  f"dominant {t['dominant']}); hbm/device "
                  f"{rec['hbm_per_device_gb']:.6g} GB fits "
                  f"{rec['fits_hbm']}; launches {rec['launches']}; notes "
                  f"{rec['notes']}", flush=True)
    finally:
        _mt_records_stop(procs)


def _mt_records_stop(procs):
    """Stop any of (d)'s processes still running."""
    for *_, proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _mt_zero():
    for fn in ARCH_LAUNCHERS.values():
        fn.launches = 0
    _zero_variant_counts()


def _mt_counts():
    return ({n: fn.launches for n, fn in ARCH_LAUNCHERS.items()},
            _variant_counts())


def _mt_check_doubled(tag, ranks, plain, meshed):
    """Every rank runs the unmeshed layers' kernels at its shard's shape:
    ``ranks`` x the unmeshed launches, kernel by kernel and variant by
    variant."""
    for name in ARCH_LAUNCHERS:
        if meshed[0][name] != ranks * plain[0][name]:
            _fail(f"mesh-train-dryrun {tag}: {name} launched "
                  f"{meshed[0][name]} times, {ranks} x {plain[0][name]} "
                  f"unmeshed")
        for v, n in plain[1].get(name, {}).items():
            if meshed[1][name].get(v, 0) != ranks * n:
                _fail(f"mesh-train-dryrun {tag}: {name} {v} "
                      f"{meshed[1][name]} against {ranks} x {plain[1][name]}")


def _mt_capture(cfg, placed, batch, mesh):
    """The kernel ops' inputs of rank 0's layer 0 in one meshed training
    forward (``_ms_capture``)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import specs as shd
    shd.set_mesh(mesh)
    try:
        with torch.no_grad():
            return _ms_capture(lambda stage: tfm.train_loss(
                placed, batch, cfg, remat=False))
    finally:
        shd.set_mesh(None)


def _mt_fp32_train(results):
    """(a) fp32 ``train()`` of internlm2-1.8b at full width, 2 layers,
    MT_BATCH x MT_SEQ, MT_STEPS steps with remat: unmeshed, then over
    (data 2, model 2) on card 0 four times from the same seed; the
    losses, the final gathered parameters, and the launches (4 x the
    unmeshed, by variant)."""
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import model_config, train
    from repro_torch.sharding import specs as shd
    kw = dict(smoke=False, steps=MT_STEPS, batch=MT_BATCH, seq=MT_SEQ,
              lr=TRAIN_LR, seed=0, layers=MT_LAYERS, dtype="float32",
              log_every=0, remat=True, return_params=True)
    # one step first, so that neither timed run pays the card's warm-up
    train(MT_ARCH, device="cuda:0", **dict(kw, steps=1))
    _mt_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l0, p0 = train(MT_ARCH, device="cuda:0", **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = _mt_counts()
    _mt_zero()
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    l1, p1 = train(MT_ARCH, device="cuda:0", mesh=mesh, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    meshed = _mt_counts()
    rel = [abs(a - b) / abs(b) for a, b in zip(l1, l0)]
    print(f"[mesh-train-dryrun] (a) {MT_ARCH} fp32, {MT_LAYERS} layers, "
          f"{MT_BATCH} x {MT_SEQ}, {MT_STEPS} steps: losses meshed {l1} vs "
          f"unmeshed {l0} (rel {max(rel):.3g}, tol "
          f"{TRAIN_TOL['fp32_loss']}); train() wall s (init, placement "
          f"and steps) meshed {t2 - t1:.6g} unmeshed {t1 - t0:.6g}; "
          f"launches meshed {meshed[0]} unmeshed {plain[0]}", flush=True)
    if not max(rel) <= TRAIN_TOL["fp32_loss"]:
        _fail(f"mesh-train-dryrun (a): loss off by {max(rel)} relative")
    tol = MT_STEP_TOL * TRAIN_LR * MT_STEPS
    worst, worst_l2 = (0.0, ""), 0.0
    pp = _leaf_paths(p0)
    for path, t in _leaf_paths(p1).items():
        err = float((t - pp[path]).abs().max())
        worst, worst_l2 = max(worst, (err, path)), max(
            worst_l2, _rel_l2(t, pp[path]))
        if not err <= tol:
            _fail(f"mesh-train-dryrun (a): {path} off by {err} > {tol}")
    print(f"[mesh-train-dryrun] (a) final gathered parameters: largest "
          f"|meshed - unmeshed| {worst[0]:.4g} at {worst[1]} (tol "
          f"{tol:.3g}), largest relative l2 {worst_l2:.4g}", flush=True)
    _mt_check_doubled("(a)", 4, plain, meshed)
    cfg = model_config(MT_ARCH, False, MT_LAYERS)
    cfg = dataclasses.replace(cfg, dtype="float32")
    pspecs = shd.param_pspecs(p1)
    placed = shd.place(p1, pspecs, mesh)
    b = next(lm_batches(cfg.vocab, MT_BATCH, MT_SEQ, 1, 0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    got = _mt_capture(cfg, placed, batch, mesh)
    del p0, p1, placed
    (q, k, v), fkw = got["flash_attention"]
    label = (f"mesh-train internlm2 fp32 S={q.shape[1]} B{q.shape[0]} "
             f"H{q.shape[2]}/K{k.shape[2]} hd{q.shape[3]}")
    check("flash_attention", label,
          lambda: fl_ops.flash_attention(q, k, v, **fkw),
          lambda: flash_plain(q, k, v, **fkw), ZOO_TOL["fp32"], results,
          lambda: flash_library(q, k, v, **fkw), flash_bound(q, k, v, **fkw),
          True, relative=True, reps=10)
    return {"flash_attention": {"mesh_train_internlm2": _record_row(
        [(label, results["flash_attention"][-1][1])],
        meshed[0]["flash_attention"], meshed[1]["flash_attention"])}}


def _mt_profiled(step):
    """(ms a step, idle share): one warm-up step that returns the loss,
    one timed, one under torch.profiler (phase 12's method)."""
    from repro_torch.launch.profile_serve import _union_us
    loss = step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        _fail("mesh-train-dryrun (b): no device events recorded")
    busy = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    return float(loss), ms, wall_us / 1e3, busy / 1e3, 1 - busy / wall_us


def _mt_moe_train(results):
    """(b) bf16 Mixtral at 1 layer, 1 x MT_SEQ, AdamW with remat: 3
    steps unmeshed, then 3 over (data 1, model 2) in tensor mode on card
    0 twice, each run from the same parameters and state (the first
    step warms up and gives the loss, the second is timed, the third
    profiled); launches 2 x the unmeshed ones."""
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (loss_and_grads, mesh_init,
                                          mesh_step, model_config)
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.sharding import specs as shd
    cfg = model_config(MT_MOE, False, 1)
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg)
    b = next(lm_batches(cfg.vocab, 1, MT_SEQ, 1, 0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    opt = adamw(TRAIN_LR)
    state = opt.init(params)

    def plain_step():
        loss, _, grads = loss_and_grads(params, batch, cfg, True)
        with torch.no_grad():
            opt.step(params, grads, state)
        return loss

    _mt_zero()
    plain_run = _mt_profiled(plain_step)
    plain = _mt_counts()
    del state
    _free_card()
    mesh = make_mesh((1, 2), ("data", "model"), ["cuda:0"] * 2)
    pspecs = shd.param_pspecs(params, "tensor")
    placed = shd.place(params, pspecs, mesh)
    del params
    _free_card()
    shd.set_mesh(mesh)
    try:
        mstate = mesh_init(opt, placed, pspecs)

        def mesh_train_step():
            loss, _, grads = loss_and_grads(placed, batch, cfg, True)
            with torch.no_grad():
                mesh_step(opt, placed, grads, mstate, pspecs)
            return loss

        _mt_zero()
        mesh_run = _mt_profiled(mesh_train_step)
        meshed = _mt_counts()
    finally:
        shd.set_mesh(None)
    del mstate
    _free_card()
    rel = abs(mesh_run[0] - plain_run[0]) / abs(plain_run[0])
    for tag, r in (("unmeshed", plain_run), ("(data 1, model 2)", mesh_run)):
        print(f"[mesh-train-dryrun] (b) {MT_MOE} bf16 1 layer 1 x {MT_SEQ} "
              f"{tag}: loss {r[0]:.6g} step_ms={r[1]:.6g} "
              f"profiled_wall_ms={r[2]:.6g} device_busy_ms={r[3]:.6g} "
              f"idle_share={r[4]:.4f}", flush=True)
    print(f"[mesh-train-dryrun] (b) meshed / unmeshed ms a step "
          f"{mesh_run[1] / plain_run[1]:.4g}; loss rel {rel:.3g} (tol "
          f"{TRAIN_TOL['loss']}); launches meshed {meshed[0]} unmeshed "
          f"{plain[0]}", flush=True)
    if not rel <= TRAIN_TOL["loss"]:
        _fail(f"mesh-train-dryrun (b): loss off by {rel} relative")
    _mt_check_doubled("(b)", 2, plain, meshed)
    got = _mt_capture(cfg, placed, batch, mesh)
    _ms_rows("mixtral", got, results, prefix="mesh-train")
    del placed, got
    _free_card()
    paths = {}
    for name in ("flash_attention", "moe_gmm"):
        rows = [(lab, r) for lab, r in results[name]
                if lab.startswith("mesh-train mixtral")]
        paths[name] = {"mesh_train_mixtral": _record_row(
            rows, meshed[0][name], meshed[1][name])}
    return paths


def _mt_dryrun_probe():
    """(c) One dry-run probe over (data 1, model 2): counted on meta,
    then run with both ranks on card 0 under the counter; FLOPs by
    dtype, launches by variant and collective bytes by kind must be
    equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.shapes import INPUT_SHAPES
    arch, periods, batch = MT_PROBE
    cfg = dr._with_periods(get_config(arch), periods)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], batch=batch)
    opts = dict(opt_dtype="float32", remat=True, loss_chunk=0, zero=False,
                shard_params_data=False)
    t0 = time.time()
    meta = dr._count_on_mesh(cfg, shape, dr.make_count_mesh(
        (1, 2), "meta", False), "meta", False, opts)
    t1 = time.time()
    card = dr._card_mesh_probe(cfg, shape, (1, 2), False, opts, meta,
                               DRYRUN_REPS)
    keys = sorted(k for k in set(meta) | set(card["card_count"])
                  if k.startswith(("flops:", "launches:", "collective:")))
    print(f"[mesh-train-dryrun] (c) {arch} train_4k probe P={periods} "
          f"B={batch} over (data 1, model 2): meta count {t1 - t0:.1f} s; "
          f"card {card['ms']:.6g} ms (both ranks on card 0, median of "
          f"{DRYRUN_REPS}); " + " ".join(
              f"{k}={meta.get(k, 0):.6g}/{card['card_count'].get(k, 0):.6g}"
              for k in keys) + f"; bytes {card['counted_bytes_accessed']:.6g}"
          f"/{card['bytes_accessed']:.6g} (meta/card); count equal "
          f"{card['count_equal']}", flush=True)
    if not card["count_equal"]:
        _fail("mesh-train-dryrun (c): the card's FLOPs, launches or "
              "collective bytes differ from the meta count")
    # the record's launches: the counted card run's, over both ranks
    every = card["launches_every_rank"]
    print(f"[mesh-train-dryrun] (c) launches of the counted card run, both "
          f"ranks: {every}", flush=True)
    out = {}
    for name, by_var in every.items():
        for variant, n in by_var.items():
            if n != 2 * card["card_count"].get(
                    f"launches:{name}:{variant}", 0):
                _fail(f"mesh-train-dryrun (c): {name} {variant} launched "
                      f"{n} times over both ranks, rank 0 "
                      f"{card['card_count'].get(f'launches:{name}:{variant}')}")
        out[name] = {"mesh_dryrun_internlm2_train": {
            "launches": int(sum(by_var.values())),
            "launches_by_variant": {v: int(n) for v, n in by_var.items()}}}
    return out


def phase_mesh_train_dryrun():
    """16. mesh-train-dryrun: (a) fp32 training over (data 2, model 2),
    (b) bf16 Mixtral training over (data 1, model 2), (c) a dry-run probe
    counted on meta and on the card, then (d) two 16x16 records counted
    on meta in processes of their own, after every timed run of the
    script.  Returns the record's paths."""
    t_phase = time.time()
    results, paths = {}, {}
    for part in (_mt_fp32_train, _mt_moe_train):
        for name, p in part(results).items():
            paths.setdefault(name, {}).update(p)
        _free_card()
    for name, p in _mt_dryrun_probe().items():
        paths.setdefault(name, {}).update(p)
    _free_card()
    _mt_records_finish(_mt_records_start())
    print(f"[mesh-train-dryrun] phase seconds {time.time() - t_phase:.1f}",
          flush=True)
    return paths


def _free_card():
    import gc
    gc.collect()
    torch.cuda.empty_cache()

def _record_row(rows, launches, by_variant):
    """A path's numbers; ``variant`` is the one its timed row took."""
    timed = [r for _, r in rows if "kernel_ms" in r][0]
    return {"launches": launches,
            "max_abs_err": max(r["max_abs_err"] for _, r in rows),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "variant": timed["variant"],
            "launches_by_variant": by_variant}


def kernel_record(results, launches, by_variant, zoo_results, zoo_launches,
                  zoo_by_variant, pipelined, admission, sanitized,
                  arch_paths, mesh_results, meshed):
    """One entry per kernel: the top-level numbers are those of the path
    each kernel was first ported for (cascade at batch 64; moe_gmm: zoo
    prefill), ``launches`` and ``launches_by_variant`` the totals over the
    cascade run and the zoo's prefill and decode, ``paths`` each phase's
    own count, split by variant, and numbers.  ``cascade_b8`` /
    ``cascade_b16`` hold the timed rows at the engine's smaller buckets
    (their launch counts are the cascade run's, over all buckets);
    ``cascade_forced_simt`` the scalar flash kernel forced at the path
    shape, which no served path takes (``launches`` null);
    ``cascade_pipelined`` the launches of phase 8 (c)'s pipelined run
    (kernel ladder, depth 2, counted from zero over that run);
    ``cascade_admission`` those of phase 9 (c)'s Poisson run through the
    admission front-end (depth 0, counted from zero over that run);
    ``cascade_sanitized`` those of phase 10 (a)'s depth-0 run under the
    determinism and retrace sanitizers (counted from zero over that
    run); ``zoo_<model>_prefill`` / ``zoo_<model>_decode`` the zoo-archs
    phase's serving runs of each other architecture and
    ``zoo_<model>_train`` the zoo-train phase's ``train()`` runs and
    ``dryrun_<model>_<shape>`` the dryrun phase's probes of each pair
    (``arch_paths``, counted from zero over each; the timed ones with
    their numbers), whose launches the totals include."""
    def split(counts, name, n):
        return counts[name]

    record = []
    for name in REPLACES:
        paths = {}
        if name in LAUNCHERS:
            for path, prefix in (("cascade", "path B=64"),
                                 ("cascade_b8", "path B=8"),
                                 ("cascade_b16", "path B=16"),
                                 ("cascade_forced_simt", "forced simt")):
                rows = [(lab, r) for lab, r in results[name]
                        if lab.startswith(prefix)]
                if any("kernel_ms" in r for _, r in rows):
                    # a forced variant's row is on no served path
                    n = None if path.endswith("simt") else launches[name]
                    paths[path] = _record_row(
                        rows, n, split(by_variant, name, launches[name]))
        if name in ZOO_LAUNCHERS:
            zrows = [(lab, r) for lab, r in zoo_results[name]
                     if lab.startswith("path")]
            for phase in ("prefill", "decode"):
                rows = [x for x in zrows if phase in x[0]]
                if rows:
                    n = zoo_launches[phase][name]
                    paths[f"zoo_{phase}"] = _record_row(
                        rows, n, split(zoo_by_variant[phase], name, n))
        paths.update(arch_paths.get(name, {}))
        top = dict(next(iter(paths.values())))
        runs = [paths[p] for p in ("cascade", "zoo_prefill", "zoo_decode")
                if p in paths]
        runs += [r for p, r in arch_paths.get(name, {}).items()]
        top["launches"] = sum(r["launches"] for r in runs)
        top["launches_by_variant"] = {
            v: sum(r["launches_by_variant"].get(v, 0) for r in runs)
            for v in VARIANT_LAUNCHERS[name].launches_by_variant}
        if name in VARIANT_LAUNCHERS:
            top["variants"] = list(VARIANT_LAUNCHERS[name]
                                   .launches_by_variant)
        if name in LAUNCHERS:
            for path, (counts, variants) in (("cascade_pipelined", pipelined),
                                             ("cascade_admission",
                                              admission),
                                             ("cascade_sanitized",
                                              sanitized)):
                n = counts[name]
                paths[path] = {"launches": n, "launches_by_variant":
                               split(variants, name, n)}
            # phase 14: the data=2 run (both shards' launches) and the
            # timed row at one shard's 4 rows (bucket 8)
            n = meshed["launches"][name]
            paths["cascade_mesh"] = {
                "launches": n, "launches_by_variant":
                split(meshed["by_variant"], name, n),
                "items_per_sec": meshed["items_per_sec"],
                "device_idle_share": meshed["idle"]}
            rows = [(lab, r) for lab, r in mesh_results[name]
                    if lab.startswith("shard B=4 ")]
            paths["cascade_shard_b4"] = _record_row(
                rows, n, split(meshed["by_variant"], name, n))
        record.append({"name": name, "route": "cuda",
                       "source": SOURCE[name], "replaces": REPLACES[name],
                       **top, "paths": paths})
    return record


_T0 = time.time()


def _clock(phase, note=""):
    """The script's seconds so far, at the end of ``phase``."""
    print(f"[clock] {phase} ended at {time.time() - _T0:.1f} s"
          + (f" ({note})" if note else ""), flush=True)


def main():
    from repro_torch.data import hash_ids, make_stream
    phase_card()
    phase_build()
    _clock("build")
    stream = make_stream("imdb", seed=0, n_samples=128)
    tokens = torch.from_numpy(np.stack(
        [hash_ids(d, 4096, 128) for d in stream.docs[:64]])).cuda()
    results = phase_kernels(tokens)
    _clock("kernels")
    eng, launches, by_variant, m4 = phase_serve()
    phase4 = {"accuracy": m4["accuracy"],
              "expert_calls": m4["expert_calls"], "by_variant": by_variant}
    phase_students(eng, tokens)
    _clock("serve+students")
    del eng
    phase_default_serve()
    _clock("default-serve")
    pipelined, unmeshed, warm_s = phase_engine_matrix(launches)
    _clock("engine-matrix", f"the warm run of (b) / (b') {warm_s:.1f} s of "
           "it")
    admission = phase_checkpoint_admission()
    _clock("checkpoint-admission")
    sanitized = phase_sanitize_distill()
    _clock("sanitize-distill")
    cfg, params, prompts = zoo_model()
    zoo_results = phase_zoo_kernels(cfg, params, prompts)
    zoo_launches, zoo_by_variant, _, zoo_out = phase_zoo_serve(
        cfg, params, prompts)
    phase_zoo_profile(cfg, params, {"tokens": prompts})
    phase_zoo_checks(cfg, params, prompts)
    _clock("zoo")
    ms_results, ms_runs = phase_model_sharding(
        cfg, params, prompts, zoo_out, zoo_by_variant, zoo_results)
    _clock("model-sharding")
    del params, prompts, zoo_out
    torch.cuda.empty_cache()
    _, arch_paths, arch_measured = phase_zoo_archs()
    _clock("zoo-archs")
    train_paths, train_measured = phase_zoo_train()
    _clock("zoo-train")
    for name, p in train_paths.items():
        arch_paths.setdefault(name, {}).update(p)
    for name, p in phase_dryrun(arch_measured, train_measured).items():
        arch_paths.setdefault(name, {}).update(p)
    for name, p in model_sharding_paths(ms_results, ms_runs).items():
        arch_paths.setdefault(name, {}).update(p)
    _free_card()
    _clock("dryrun")
    mesh_results, meshed = phase_mesh(tokens, phase4, unmeshed)
    _clock("mesh")
    _free_card()
    for name, p in phase_mesh_train_dryrun().items():
        arch_paths.setdefault(name, {}).update(p)
    _clock("mesh-train-dryrun")
    print(json.dumps({"kernels": kernel_record(
        results, launches, by_variant, zoo_results, zoo_launches,
        zoo_by_variant, pipelined, admission, sanitized, arch_paths,
        mesh_results, meshed)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
