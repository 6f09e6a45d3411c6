"""Drive the PyTorch/CUDA port on one card and check it, phase by phase.

    python3 chip_smoke.py

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels (flash attention with its ring step; matmul
   with its grouped twin ``gmm``) from the sources in this checkout, one
   nvcc per source, all started together, with nvcc's ``-Xptxas -v``
   report (registers, shared memory, spills) and a summary of the wgmma
   and ffma kernels' registers, spills and dynamic shared memory (every
   one of them, the forward's wgmma and ffma kernels at head dim 256
   included, with 0 spill bytes);
3. kernel parity: the forward kernel against its plain torch version on
   the card, at the reference kernel tests' shapes and tolerances (float32
   2e-5, bfloat16 2e-2), ragged lengths, GQA, windows, cross attention,
   q offsets and the serving path's shape, each case with the design that
   served it (the wgmma design for bf16 and the ffma design for float32,
   each at head dim 64, 128 and 256; the template for the rest), a
   float32 (b, s, h, d) view (ffma) and a float32 base 4 bytes off 16
   (the template), and rows that see no key against the TPU kernel's tile
   convention (``ref.attention_tiled``) in all three designs;
4. kernel timing at the serving path's shape (CUDA events, and the
   kernel's device time from torch.profiler): the kernel, the template
   design at the same inputs (its C entry called directly), its plain
   version, one library call for the same function, the bound; then in
   float32 at the same shape (the executor call's: the ffma design, the
   template's device time beside it, SDPA in float32 by device time);
5. serve llama-7b at full width and depth (bf16, batch 4, prompt 512, 16
   new tokens) through ``repro_torch.launch.serve.serve``, planned through
   a plan-cache file (the serve call's plan is a cache hit), with launch
   counters set to 0 just before and read just after, every launch of the
   wgmma design, its decode steps one CUDA graph replayed per step (the
   first step eager, its warm-up); then ``serve()``'s decode loop from two
   copies of one prefill's caches, 15 steps graphed and 15 eager (tokens
   equal, launches by design equal, the largest logit difference printed);
   then one prefill, one eager decode step and one replay of the decode
   graph, each counted (the replay's launches by design) and under
   torch.profiler (device busy time, idle share, device time by kernel
   kind; the replay's and the eager step's traces hold the counted
   launches of this port's kernels); then the prefill as one CUDA graph
   (``serve()``'s own prefill runs eagerly: one call a serve never
   reaches a capture), its replay's logits bit-equal to the eager
   prefill's, its launches counted and read from its trace, profiled
   beside the eager prefill;
6. slice parity: full width, 2 layers, float32, the same weights on the
   card (kernel path) and on the CPU (plain path);
7. matmul parity: the kernel against its plain version at the reference
   tests' shapes, ragged shapes, strided views (both majors of each
   operand) and every product shape of llama-7b's prefill graph (b=4,
   s=512), float32 (1e-4) and bf16 (3e-2, atol x8), each case with its
   design (float32 takes the ffma design where the rule allows, else the
   template; both are held to the plain version);
8. ring-step parity: the step kernel chained over r = 2 and 4 kv blocks
   from every ring position, causal, windowed and GQA (float32 2e-5,
   bf16 2e-2), each carry against the plain step and the finalised chain
   against the forward kernel, at the serving shape cut 4 ways too in
   bf16 and in float32, each case with its design (head dim 64 and 128:
   bf16 wgmma, float32 ffma; d = 16 and 32 the template; the step's wgmma
   design stops at 128);
9. timing (CUDA events; device time from torch.profiler where the host
   would bound a short kernel): matmul at every distinct product shape of
   llama-7b's prefill graph in float32 (the ffma design, the template
   beside it) and in bf16 (the wgmma design, the template beside it), the
   ring step at the serving shape cut 4 ways in bf16 (the wgmma design)
   and in float32 (the ffma design), each with the template beside it,
   each beside its plain version, its library call (none for the step)
   and its bound;
10. executor path: llama-7b's prefill graph at full width (embed, one
   block period, lm_head) planned through a plan-cache file on a 1x1 mesh
   (cold, then a hit), run with ``executor="shard_map"`` in float32 and in
   bf16 with the launch counters set to 0 just before each call and read
   just after (every clean contraction through the matmul kernel, one
   flash-attention launch; in bf16 every launch of the wgmma design, in
   float32 every launch of the ffma design), its logits held
   against the dense ``executor="gspmd"`` run on the card, then profiled;
11. ring path: the same graph on 4 gloo ranks that share the card (blocks
   staged through the host), sequence-parallel (every ``s`` label on the
   ``seq`` axis), in float32 and then in bf16: attention rides the ring
   through the step kernel (float32: every step and every matmul of the
   ffma design; bf16: every step launch of the wgmma design); counters per rank,
   logits against the one-card dense run of the same dtype;
12. gmm parity: the grouped-matmul kernel against ``ref.gmm`` at the
   reference tests' shapes, ragged shapes, expert-strided views, and
   qwen2-moe's prefill and decode and mixtral's expert shapes (its w1 and
   w2 at b=4, s=512, capacity 640, and its w1 in a decode step, capacity
   128: phase 36 serves it), float32 (1e-4, atol x8) and bf16 (3e-2, atol
   x8), each case with its design;
13. gmm timing (CUDA events) in bf16 at qwen2-moe's w1 and w2 prefill
   shapes, its decode shape and mixtral's three, and in float32 at
   qwen2-moe's w1: kernel, template design, plain version, ``torch.bmm``
   and the bound;
14. serve qwen2-moe-a2.7b at full width and depth (bf16, batch 4, prompt
   512, 16 new tokens, 60 experts padded to 64, top-4, shared expert),
   planned through a plan-cache file, counters set to 0 just before the
   serve call and read just after (24 flash launches, 72 gmm launches per
   prefill and per decode step, all of the wgmma design, the decode steps'
   counted from their graph's replays), then graphed against eager and
   profiled as phase 5 (one replay of the decode graph: 72 gmm launches,
   all wgmma, counted and read from the replay's trace);
15. MoE slice parity: qwen2-moe width, 2 layers, float32, the same
   weights on the card (gmm kernel, its launches by design) and on the
   CPU (plain path);
16. a2a path: qwen2-moe's prefill graph (one block period) with the MoE
   stubs on 4 gloo ranks sharing the card, the expert label on a 4-way
   axis, so dispatch and combine run the ``a2a`` rule's all_to_all
   program; the collectives each rank issued against the static trace,
   the logits against the one-card dense run (its ranks are phase 11's:
   one spawn runs both, for the run's time limit);
17. train parity: llama-7b at full width, 2 layers, float32, batch 1,
   seq 128, the same weights and batch on the card (the flash kernel's
   ffma design inside its autograd Function, whose backward is the
   plain version's) and on the CPU (the plain path): the loss and every
   gradient leaf of ``loss_fn`` (1e-4 relative; 1e-4 x max|g| a leaf),
   then one ``make_train_step`` on each side (loss and grad norm, 1e-4
   relative), 2 layers x 2 flash launches each (forward and remat
   recompute); then three steps on the card through
   ``launch.train.compiled_train_step`` as a CUDA graph and twice eagerly,
   the graph's losses and parameters within the eager runs' spread;
18. train llama-7b at full width (bf16) with 8 of its 32 layers (the
   parameters, gradients and f32 AdamW moments of all 32 would fill the
   card), batch 4, seq 512, cosine schedule, 8 steps through
   ``repro_torch.launch.train.train`` with a plan-cache file and a
   checkpoint directory under ``chiprun_out/``: per-step loss, grad norm
   and wall time, peak memory, flash launches per step (all wgmma), a
   finite and falling loss, the checkpoint restored through
   ``CheckpointManager.restore_latest`` bit-equal to the state in memory;
   the step a CUDA graph (7 replays of 8 steps, the AdamW step counter 8);
   then one warmed step under torch.profiler (device busy time, idle
   share, device time by kind, inside the plain attention backward and
   inside the optimizer), eagerly and as a replay (its trace's flash
   launches equal to the counted 16); then the same run twice eagerly
   (``graph=False``): the graphed run's losses and final parameters within
   the two eager runs' spread, the peaks beside each other;
19. the paper's Experiment 2 at AmazonCat-14K sizes (597,540 features,
   8,192 hidden, 14,588 labels, batch 512, float32): the FFNN graph built
   here with the port's ``EinGraph``, ``Program.grad(wrt=["W1", "W2"])``
   compiled with ``executor="shard_map"`` on the 1x1 mesh through a
   plan-cache file (cold, then a hit), 3 SGD steps with every matmul
   launch of the ffma design, the first step's gradients against
   ``torch.autograd`` of the plain FFNN on the card (1e-4 x max|g|), the
   step's wall and device time against its FLOP bound;
20. the serving tier: llama-7b at full width and depth (bf16, seed-0
   weights) through ``repro_torch.serving.ServingEngine``: 4 slots,
   blocks of 16, max_seq 528, 8 requests with prompt lengths from seed 0
   in 192..512 (both pow2 buckets, 256 and 512), 16 new tokens each; a
   first engine, eager (``graph=False``), over a new plan-cache file, a
   second, graphed, over the same file (hits only; its run gives the
   timings; its generations equal the eager run's, its peak memory within
   one prefill of the eager run's; each bucket's prefill with its
   admission a CUDA graph from the bucket's second use, in one shared
   pool, the replays counted a bucket); launch counters set to 0 just
   before each run and read just after (32 flash launches a prefill, all
   wgmma); registry compiles = buckets + 1; a third run copies out the
   logits behind every token, and each request is held against the serve
   loop's run of it alone, teacher-forced on the engine's tokens: logits
   within 5e-2 of max|logit| at every position, the engine's token the
   sequential argmax except where the top-2 gap is under twice the two
   runs' measured logit difference (near ties under 2e-2 of max|logit|
   and flips printed), the 5e-2 limit shown to tell another request's
   context apart; TTFT per request, tok/s, occupancy, peak memory and
   pool bytes; the decode step one CUDA graph (replays = decode steps - 1
   a run); one engine decode step with every slot live counted and
   profiled, a replay and the same step eager (each trace's launches of
   this port's kernels equal to the counted ones), beside phase 5's
   graphed and eager steps;
21. the same for qwen2-moe-a2.7b: 2 slots, exact-length buckets 384, 448
   and 512, 8 new tokens; 72 gmm launches per prefill and per decode step,
   all wgmma; each request compared up to the first position where a MoE
   layer sent its token to other experts than the run alone did (a bf16
   routing near tie, printed with the layer); profiled beside phase 14's
   decode step;
22. engine parity: llama-7b width and qwen2-moe width, 2 layers, float32,
   3 requests through 2 slots on the card and on the CPU (every flash and
   gmm launch of the ffma design); tokens equal, every decode step's
   logits within 1e-4 of max|logit|;
23. the model zoo's flash shapes: hymba-1.5b's prefill (4, 25, 2048, 64)
   with GQA 5:1 and a window of 1024 that binds and paligemma-3b's (4, 8,
   512, 256) with MQA 8:1, both bf16 (the wgmma design; at head dim 256
   its 64-key tiles), paligemma's float32 slice (1, 8, 320, 256) of
   phase 27 and its prefill shape (4, 8, 512, 256) in float32 (the ffma
   design, 32-row q tiles at head dim 256), each against its plain
   version, its device time beside SDPA's on the same function in the
   same type (``enable_gqa``; hymba's window as a mask; SDPA's kernels
   printed to name its backend), the template's and the bound;
24-26. serve hymba-1.5b (prompt 2048, so the window binds in prefill and
   decode runs on the ring buffer), xlstm-125m (prompt 512; no flash kernel
   runs) and paligemma-3b (prompt 512 from tokens, as the reference serves
   it; then one ``make_prefill_step`` call on 256 seeded prefix embeddings
   and 256 tokens) at full width and depth, bf16, batch 4, 16 new tokens,
   as phase 5 serves llama-7b (every flash launch wgmma), each decode loop
   graphed against eager, each prefill and decode step (eager and a
   replay of its graph) profiled;
27. zoo slice parity, float32, full width, 2 layers (xlstm: one mLSTM and
   one sLSTM block), batch 1, the same weights on the card and the CPU:
   logits (1e-4 x max|logit|), ``loss_fn`` (1e-4 relative) and every
   gradient leaf (1e-3 x its max|g|: at hymba's s = 1280 the card's plain
   path, run beside it without the kernel and printed, already differs
   from the CPU by a few 1e-4 of max|g|), all finite; for hymba, the CPU's gradients
   without the window must move every attention leaf by more than that
   limit; hymba at s = 1280 (the window binds; the ffma flash), xlstm at
   s = 512, paligemma with 256 prefix embeddings and 64 tokens (the ffma
   flash at d = 256); then one
   block period of hymba's (b=4, s=2048) and paligemma's (b=4, s=512)
   prefill EinGraph in bf16 through ``executor="shard_map"`` on the
   one-rank mesh against the dense run (the wgmma matmul at d_model 1600,
   kv 320, d_ff 5504 and d_ff 16384, vocab 257,280);
28. the engine on hymba-1.5b at full size (2 slots, 3 requests with prompts
   from seed 28 in 1100..1500, exact buckets, 8 new tokens), held against
   ``serve()`` of each request alone as phase 20, its logit limit twice
   what serving each request in a batch of two does to ``serve()``'s own
   bf16 logits in the same run (hymba amplifies bf16 rounding through its
   32 layers; the limit must still tell another context apart); the same
   engine in float32 at full width and depth, held against ``serve()`` at
   1e-4 x max|logit| with no unexplained token flip; and the engine parity
   of phase 22 for xlstm-125m width.  The kernels line gives every kernel's
   zoo launches by design (``ops.design_counts()`` over phases 24-28 and
   36);
29. the pipelined path: llama-7b's prefill graph of phase 10 (b=4, s=512)
   compiled with ``pipeline=PipelineSpec(stages=p, microbatches=m)`` on a
   ``{"pp": p}`` mesh of p gloo ranks sharing the card (handoffs staged
   through the host), (p, m) = (1, 1) on one rank, then (2, 1), (2, 4) and
   (4, 2) (p = 2 and p = 4 in two spawns side by side), each in float32
   and bf16: the static schedules against the
   reference's (stages, handoff elems, bubble); on every rank the logits
   bit for bit equal to the unpipelined compile of the stitched plan on the
   same mesh, m x (8 matmul, 1 flash) launches, all ffma in float32 and all
   wgmma in bf16, the collectives issued equal to the static trace
   (ppermute over ``pp`` only, none at p = 1); rank 0's logits against the
   dense one-card run to phase 10's limits; the rank walls are host-staged
   gloo, not a speed path;
30. the static verifier on the card: (a) ``python -m repro_torch.analysis``
   over the reduced zoo in a subprocess, clean, with CUDA never initialised
   and no jax in it; (b) the memory pass's per-device peak
   (``analyze_compiled(run).memory["peak_bytes"]``) against the
   allocator's peak of one warmed call (``max_memory_allocated`` less what
   was allocated before the call and is not its feeds), within 10%, for
   phase 10's one-rank llama-7b prefill graph in float32 and in bf16 (its
   float nodes typed bfloat16) and phase 19's FFNN gradient program;
   (c) ``BucketRegistry.analyze()`` of phase 20's engine registry, every
   bucket clean.  The kernels line gives the matmul and flash rows'
   launches on the pipelined path by design (``pipeline_launches``,
   ``pipeline_design``);
31. the DTensor path, on gloo ranks sharing the card (DTensor's
   all-gathers staged through the host): (a) phase 10's llama-7b prefill
   graph (b=4, s=512, one block period) through ``executor="gspmd"`` on 4
   ranks, meshes (2, 2) (llama-7b's plan: f and v on both axes) and
   (1, 4), float32 and bf16: every rank's logits against the one-card
   dense run and the shard_map run on the same mesh (phase 10's limits),
   8 matmul + 1 flash launches a rank (ffma in float32, wgmma in bf16),
   the collectives DTensor issued by kind and bytes (``CommLog``) beside
   shard_map's static trace, the rank walls; (b) a train step at
   llama-7b width, 1 layer, float32, b=2, s=128, on 2 ranks: data
   parallel on {"data": 2} (reduced llama's plan at that cell: the batch
   on data, the weights stored on it, Partial gradients reduce-scattered
   into their shards) and tensor parallel on {"model": 2} (llama-7b's
   plan): loss, grad norm (the clip active) and
   every gradient against the one-rank step on the card (1e-4), the
   parameters after AdamW (within 1e-4 x lr and one float32 ulp where the
   gradient clears 30 x its tolerance, within 2 x lr, one step either way,
   below that); (c) llama-7b at full width, 2 of its 32 layers (bf16; cut
   from 32 to 8, then to 4, then to 2, for the run's time limit)
   served on 4 ranks, mesh (1, 4), b=4, prompt 512, 16 new, after the
   one-rank reference ran alone: each rank's weight bytes, peak memory;
   the serve loop fed the one-rank tokens, every step's logits against the
   one-rank run (the first within 2e-2 of max|logit|, each later one
   within the larger of that and twice the noise floor: the one-rank bf16
   run against the same weights in float32, printed per step); a 2-layer
   float32 slice fed its one-rank tokens the same way, every step within
   1e-4 of max|logit|; ``serve(mesh=)``'s generations token for token (a
   divergence must sit on a top-2 margin under 2e-2 of max|logit|, and is
   printed), the prefill and decode walls.  The
   kernels line gives the flash and matmul launches a rank on the gspmd
   path (``gspmd_launches_per_rank``).  Since PR 25 (b) and (c) run side
   by side, for the run's time limit.  (b)'s step is timed alone; a
   second, untimed step on the same weights made again runs under a
   ``launch.hlo_analysis.CollectiveRecorder``, which phase 32(c) reads;
32. the dry run (``repro_torch.launch.dryrun``): (a) the CLI in a
   subprocess per cell, all started together after the build (they need
   no card; at the lowest CPU priority, so they take the cores phases
   3-28 leave idle, not the gloo ranks' of phases 29-35), with
   ``CUDA_VISIBLE_DEVICES``
   empty, for llama-7b train_4k, prefill_32k and decode_32k on (16, 16)
   and decode_32k on (2, 16, 16): each record's memory a card,
   ``t_compute_s``, ``t_memory_s``, ``t_collective_s``, bottleneck, fit in
   80 GB, kernel calls a rank by design, its wall, and CUDA never
   initialised; the card's ``total_memory`` against ``dryrun.HBM_BYTES``;
   (b) abstract against real on one rank: llama-7b at full width on a 1x1
   mesh, phase 5's prefill (bf16, b=4, s=512) and phase 18's train step
   (8 of 32 layers), ``build_cell`` on meta blocks under ``StepCosts``
   against the same step from seeded weights on the card under
   ``FlopCounterMode``: FLOPs equal, flash calls by design equal to
   ``ops.design_counts()``, the abstract peak within 5% of
   ``max_memory_allocated`` less what was allocated before the arguments;
   (c) phase 31(b)'s train step on a fake 2-rank group against its 2 gloo
   ranks on the card, on {data: 2} and {model: 2}: each collective kind's
   count and bytes equal to what the ranks issued, the abstract peak within
   5% of each rank's allocator peak of the step.  The kernels line gives the
   dry run's flash calls a rank by design (``dryrun_calls_per_rank``);
33. the MoE, hymba and xLSTM blocks on meshes of gloo ranks sharing the
   card: (a) qwen2-moe-a2.7b at full width (bf16, 60 experts padded to
   64), 3 of its 24 layers (cut from 24 to 6, then to 3, for the run's
   time limit), served on 4 ranks, mesh (1, 4),
   the experts on ``model``, b=4, prompt
   512, 16 new, as 31(c) serves llama-7b (the one-rank run first, alone;
   its float32 witness upcast leaf by leaf; each rank's weight bytes read
   off ``param_specs`` before placing, and the weights made in turns with
   each rank's blocks held on the host meanwhile): the generations and
   every step's logits against one rank, where bf16 at full depth is
   chaotic (BLOCK_SERVES: the bf16 run on the mesh no farther from the
   float32 run, over all steps, than twice the one-rank bf16 run), a
   4-layer float32 slice against one rank within 1e-4 at every step, 18
   gmm launches a rank a step on (16, C, ·) blocks (wgmma); then
   ``serve(mesh=)`` under its own plan, at that depth where its blocks fit;
   (b) hymba-1.5b at full width, 8 of its 32 layers, on (2, 2), prompt
   2048, and (c)
   xlstm-125m on {data: 2}, prompt 512, the same checks; (d) 2-layer
   float32 train steps at full width on 2 ranks (b=2, s=128; qwen2-moe's
   1 layer, for the run's time limit): qwen2-moe
   on {data: 2} with its batch and its experts on ``data`` (expert
   parallel: each rank's kept token rows go to the other rank's experts by
   ``all_to_all`` and their outputs come back the same way; each rank's
   all-to-all count and bytes, its gmm blocks (32 experts a rank) and its
   peak printed; then, in the same spawn, its forward and backward alone
   under {b: data}, the experts whole and each rank's own tokens through
   them, held to the one-rank step, its gmm blocks (64 experts) printed)
   and on {model: 2} with the experts on
   ``model``, hymba and xlstm on {data: 2}, each held as 31(b) holds
   llama's, gmm launches a rank (ffma); (e) qwen2-moe's prefill graph
   (one block period, b=4, s=512) through ``executor="gspmd"`` on (1, 4)
   with the experts on ``model`` in its expert half, the ``a2a`` nodes
   lowered through their rule, float32 and bf16: logits against the dense
   and shard_map runs (phase 10's limits), the rule's collectives equal
   to the static trace's node by node, DTensor's all-gathers ring-priced
   equal to the rest of it, matmul launches a rank; (f) the dry run's CLI
   for qwen2-moe decode_32k, hymba prefill_32k and xlstm train_4k (trip
   counted) on (16, 16) with no card visible, started after the build
   (as 32(a)'s) and read here, and (d)'s MoE steps on {data: 2}
   and {model: 2} on a fake 2-rank group against their gloo ranks, as
   32(c) (but the all-to-alls' bytes, summed over the two ranks: the
   abstract run routes every expert an even share, the card's its own).
   (d)'s hymba and xlstm cells run in one spawn beside (a) and (e), its
   qwen2-moe cells in another beside (b) and (c), for the run's time
   limit.  The kernels line gives
   phase 33's launches a rank by design (``mesh_blocks_launches_per_rank``);
34. the serving engine's paged decode on a mesh, and buffer donation:
   (a) llama-7b's ``ServingEngine`` at full width, 4 of its 32 layers
   (bf16, as 31(c); cut from 8 for the run's time limit), 4 slots, KV
   block 16, on 4 gloo ranks
   sharing the card, mesh (1, 4): 6 requests of 96-320 tokens drawn from
   the seed, 8 new each (two queue behind the first four); the one-rank
   engine first (beside phase 35's ranks, not alone), then
   the same weights upcast to float32 fed its tokens, then a
   4-layer float32 slice; on the ranks the bf16 engine teacher-forced on
   the one-rank engine's tokens (every admission and decode step hands it
   those tokens; its own argmax is kept), then the slice free.  Printed:
   weight and pool bytes a rank, flash launches a rank by design (4 a
   request, all wgmma), each decode step's wall (host-staged gloo, not a
   speed path), TTFT per request, the tokens the mesh would take that equal
   the one-rank engine's.  Held: every rank the same logits and tokens;
   the bf16 mesh no farther from the float32 run, over every prefill and
   decode step, than twice the one-rank bf16 run, a token it would take
   otherwise only on a top-2 margin under the larger of 2e-2 of max|logit|
   and that; the slice's tokens equal to one rank's and its first decode
   step within 1e-4 of max|logit|.  (b) phase 30(b)'s program (llama-7b's
   prefill graph, b=4, s=512, one rank) compiled with ``donate=True``, in
   float32 and bf16: one warmed donated call's allocator peak
   (``max_memory_allocated`` less what was allocated before the call and
   is not its feeds) against the memory pass's per-device peak with that
   donation set, within 1e-3; its logits bit for bit the undonated call's;
   every feed raising afterwards.  The kernels line gives phase 34's
   launches a rank by design (``mesh_engine_launches_per_rank``,
   ``donated_executor``);
35. checkpoints of a run on a mesh, and the gspmd executor's repairs:
   Its ranks start before phase 34 and run beside it, for the run's time
   limit; what this process runs of it follows phase 34.
   (a) phase 31(b)'s cell (llama-7b at full width, 1 layer, float32, b=2,
   s=128) through ``launch.train.train(mesh=, ckpt_dir=)`` on 2 gloo ranks
   sharing the card: 3 steps on {data: 2} under ``train``'s own plan with
   a checkpoint at step 2 (rank 0 writes, from leaves gathered one at a
   time), then the run restarted from step 2 onto {data: 2}, onto {model:
   2} (whose ranks first run (b)'s slice below) and onto one rank (the
   run's rank 0, with no mesh).  Printed: the checkpoint's bytes
   on disk, each save's gather wall a rank and rank 0's write wall, each
   rank's peak during save, each restore's wall, flash launches a rank by
   design (ffma), each restarted step's loss and grad norm beside the
   uninterrupted run's (the restarts start beside the uninterrupted run
   and wait for its step-2 checkpoint, for the run's time limit).  Held: every restored leaf's block on every rank
   bit-equal to the block of its file that the port's placement rule cuts
   (``gspmd.local_block``; so its ``full_tensor()`` equals the file); the
   restart on {data: 2} within 1e-6 relative
   (bit-equal expected), the others within 1e-4; the manifest's keys
   ``{step, extra, leaves}``; only rank 0 wrote.  The checkpoints go under
   ``ckpt_mesh`` beside the run's log and are deleted.  (b) on 4 gloo ranks, mesh
   (pod, data, model) = (2, 2, 1), under hand-written plans: a ``prod``
   aggregation over a split label, an opaque node of a rule registered
   here with no local lowering (run whole, the ``replicate`` rule), and
   entries out of mesh order (``("data", "pod")``) on a kept and on a
   contracted label, each against the dense one-card run (phase 10's
   limit); on 2 ranks, llama-7b's width, 4 layers, float32,
   under ``{d: model}`` on (1, 2): a prefill (b=2, prompt 128) and 8
   decode steps fed fixed tokens through the dense cache and through a
   paged pool (KV block 16), every step within 1e-4 of max|logit| of one
   rank's.  The kernels line gives phase 35's launches a rank
   (``ckpt_mesh_launches_per_rank``, ``gspmd_repairs_launches_per_rank``).

36. (run after 28, before the mesh phases) the six zoo configs that had
   never run on the card: minicpm-2b (tied embeddings, 36 heads of 64),
   musicgen-large (GELU FFN, not gated), nemotron-4-15b (squared-ReLU FFN,
   not gated; GQA 6:1), yi-9b (GQA 8:1) at full depth, mixtral-8x7b (top-2
   of 8 experts, window 4096) and qwen1.5-110b (GQA 8:1, q/k/v biases) at
   8 layers (``DENSE_SERVES``: whole they do not fit one card), each at
   full width.  (d) the forward kernel at each one's prefill attention
   (b=4, s=512, causal) in bf16 (wgmma) and float32 (ffma) against its
   plain version (2e-2, 2e-5), then the bf16 layouts timed as phase 23
   times the zoo's, beside SDPA (``enable_gqa``); (a) each one served as
   phase 5 serves llama-7b (bf16, b=4, prompt 512, 16 new, seed-0
   weights), one at a time: flash launches a prefill one a layer (40, 48,
   32, 48, 8, 8), mixtral's gmm 24 a prefill and a decode step and 384 a
   request, every launch wgmma, the prefill and the decode step each a
   CUDA graph replayed beside eager with bit-equal logits and traces equal
   to the counters, each profiled; (b) each one at full width, 2 layers,
   float32, b=1, s=128, weights from seed 36 made on the card and copied
   to the host, the card against the CPU as phase 27 (logits and loss
   1e-4, every gradient leaf 1e-3 x its max|g|); (c) one block period of
   nemotron-4-15b's and minicpm-2b's prefill EinGraph (b=4, s=512) in
   bf16 through ``executor="shard_map"`` on the one-rank mesh against the
   dense run, as phase 27 runs hymba's and paligemma's;

Phase 4 also times the forward kernel at one engine prefill, (1, 32, 512,
128) causal, in bf16 (wgmma) and in float32 (ffma), each with the
template's device time beside it, beside SDPA's device time in the same
type.  Phases 4 and 9 give one call's host time through the forward's
and matmul's operators (``repro_torch::flash_attention``, ``::matmul``)
beside a direct call of the implementation behind each (``launch``: the
wrapper as it was before the op), in turns.

Every kernel has a design picked by the shape rule in its wrapper before
launch (``"wgmma"`` for bf16 and ``"ffma"`` for float32 operands the rule
takes, ``"template"`` for the rest), and the wrapper counts launches per
design (``ops.design_counts()``); the template is timed beside the other
design by calling its C entry directly, which moves no counter.  Any
failure raises and exits non-zero before the last line.  The last
three lines are the ``nvidia-smi`` name and power limit, a JSON line of
kernel numbers and ``{"ok": true, "device": {...}}``.  All numbers also go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate and
# the bf16 tensor-core rate; float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (b, hq, hkv, sq, sk, d, causal, window, dtype)
ATT_CASES = [  # tests/test_kernels.py
    (1, 4, 2, 128, 128, 64, True, 0, torch.float32),
    (2, 2, 1, 256, 256, 32, True, 64, torch.float32),
    (1, 2, 2, 128, 256, 64, False, 0, torch.float32),
    (1, 8, 1, 128, 128, 128, True, 0, torch.float32),
    (1, 4, 4, 128, 128, 64, True, 0, torch.bfloat16),
    (2, 4, 2, 64, 64, 16, True, 32, torch.float32),
]
EXTRA_CASES = [
    (1, 4, 4, 200, 200, 128, True, 0, torch.float32),     # ragged
    (1, 4, 4, 200, 200, 128, True, 0, torch.bfloat16),    # ragged, bf16
    (2, 16, 4, 300, 300, 128, True, 0, torch.bfloat16),   # GQA 4:1, ragged
    (1, 8, 2, 77, 333, 256, False, 0, torch.float32),     # d = 256, GQA
    (1, 4, 1, 90, 90, 64, True, 40, torch.float32),       # window, GQA
    (2, 16, 4, 300, 300, 128, True, 64, torch.float32),   # window, GQA 4:1, ragged
    (1, 4, 4, 77, 333, 64, True, 0, torch.float32),       # ragged, q_offset 256
    (1, 8, 2, 160, 96, 128, False, 0, torch.float32),     # cross, sk < sq
]
SLICE = (4, 32, 32, 512, 512, 128, True, 0, torch.bfloat16)  # llama-7b prefill
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# rows 0..99 see no key (keys start at position 100); the pair of their q
# block with key block 0 is visited, so they get the mean of v there
MASKED_CASES = [
    (1, 4, 2, 256, 256, 128, True, 0, torch.bfloat16),    # wgmma design
    (1, 4, 2, 256, 256, 64, True, 0, torch.float32),      # ffma design
    (1, 4, 2, 256, 256, 128, True, 16, torch.float32),    # ffma, window
    (1, 4, 2, 256, 256, 32, True, 0, torch.float32),      # template (f32, d = 32)
    (1, 4, 2, 256, 256, 256, True, 0, torch.bfloat16),    # wgmma, 64-key tiles (d = 256)
    (1, 4, 2, 256, 256, 256, True, 0, torch.float32),     # ffma, 32-row q tiles (d = 256)
]
MASKED_OFFSETS = {"q_offset": 0, "kv_offset": 100}
# float32 at d = 128 reached through views: a (b, s, h, d) projection
# transposed (the ffma design reads its strides) and a base 4 bytes past a
# 16-byte boundary (the template)
VIEW_CASE = (2, 8, 2, 333, 333, 128, True, 0, torch.float32)


def _expected_flash_design(case, step: bool = False) -> str:
    """The shape rule at the contiguous inputs of ``_inputs``: bf16 wgmma
    and float32 ffma at head dim 64, 128 and 256 (the ring step 64 and
    128), else the template."""
    d, dt = case[5], case[-1]
    if d not in ((64, 128) if step else (64, 128, 256)):
        return "template"
    return {torch.bfloat16: "wgmma", torch.float32: "ffma"}.get(dt, "template")


def _served_by(ops, kernel: str, fn):
    """Run ``fn`` once; its result and the design whose count moved."""
    before = ops.design_counts()[kernel]
    out = fn()
    torch.cuda.synchronize()
    after = ops.design_counts()[kernel]
    moved = [d for d in after if after[d] != before[d]]
    assert len(moved) == 1 and after[moved[0]] == before[moved[0]] + 1, (before, after)
    return out, moved[0]


def _sum_counts(per_rank: list[dict], kernel: str) -> dict:
    """One kernel's ``design_counts()`` entry summed over ranks."""
    return {d: sum(r[kernel][d] for r in per_rank) for d in per_rank[0][kernel]}


def _path_design(counts: dict) -> str:
    """The design of every launch counted in ``counts`` (one kernel's
    ``design_counts()`` entry), or ``"mixed"``."""
    used = [d for d, n in counts.items() if n]
    return used[0] if len(used) == 1 else "mixed" if used else "none"


def _ptxas_kernels(log: str) -> list[dict]:
    """Per compiled kernel in an ``nvcc -Xptxas -v`` log: registers, spill
    stores and loads, static shared memory; the kernel named by its
    template arguments (mangled ``Li128E`` / ``Lb1E`` read as 128 / 1)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = re.search(r"\d([a-z][a-z_]*_kernel)I(.*?)EEv", m.group(1))
            args = re.findall(r"L[ib](\d+)E", name.group(2)) if name else []
            cur = {"kernel": f"{name.group(1)}<{','.join(args)}>" if name else m.group(1),
                   "registers": None, "spill_stores": None, "spill_loads": None, "smem": 0}
            out.append(cur)
        elif cur is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
                cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
            if m := re.search(r"Used (\d+) registers", ln):
                cur["registers"] = int(m[1])
            if m := re.search(r"(\d+) bytes smem", ln):
                cur["smem"] = int(m[1])
    return out


def _flash_template(fa, q, k, v, causal: bool, window: int = 0, q_offset: int = 0,
                    kv_offset: int = 0):
    """(launch, output): one launch of the template design's C entry at
    these inputs, for timing it beside the wgmma design in the same run.
    The wrapper picks a design by its shape rule alone; this calls the
    other entry directly and moves no counter."""
    lib, (b, hq, sq, d), (hkv, sk) = fa._lib(), q.shape, k.shape[1:3]
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), fa._DTYPES[q.dtype],
            b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], d ** -0.5, int(causal), window, q_offset, kv_offset,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = lib.flash_attention_fwd(*args)
        if err:
            raise RuntimeError(f"template flash_attention_fwd: cudaError {err}")
    return launch, o


def _mm_template(mm, x, w):
    """(launch, output) of the template design's ``matmul_fwd`` or
    ``gmm_fwd`` entry, as ``_flash_template``."""
    lib = mm._lib()
    out = torch.empty((*x.shape[:-1], w.shape[-1]), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), mm._DTYPES[x.dtype])
    strides = (*x.stride(), *w.stride(), *out.stride())
    if x.dim() == 3:
        (e, c, k), n = x.shape, w.shape[2]
        fn, args = lib.gmm_fwd, (*ptrs, e, c, n, k, *strides, stream)
    else:
        (m, k), n = x.shape, w.shape[1]
        fn, args = lib.matmul_fwd, (*ptrs, m, n, k, *strides, stream)

    def launch():
        err = fn(*args)
        if err:
            raise RuntimeError(f"template {fn.__name__}: cudaError {err}")
    return launch, out


T0 = time.perf_counter()
LOG = ROOT / "chiprun_out" / "chip_smoke.log"


def log(phase: str, msg: str) -> None:
    """A line of the run, with the seconds since it started; also appended
    to ``chiprun_out/chip_smoke.log``, which keeps what the end of the
    output drops."""
    line = f"[{phase} +{time.perf_counter() - T0:.0f}s] {msg}"
    print(line, flush=True)
    LOG.parent.mkdir(exist_ok=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def _inputs(case, seed=0, device="cuda"):
    b, hq, hkv, sq, sk, d, causal, window, dt = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(device=device, dtype=dt)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    kw = dict(causal=causal, window=window, q_offset=sk - sq if causal else 0)
    return q, k, v, kw


def _flash_view_parity(fa, ops, ref) -> list[dict]:
    """float32 at d = 128 through views: the (b, s, h, d) layout transposed
    (ffma), and a base 4 bytes off 16 (template), against ``ref.attention``
    at the float32 tolerance."""
    b, hq, hkv, s, _, d, causal, window, dt = VIEW_CASE
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to("cuda").transpose(1, 2)
               for h in (hq, hkv, hkv))
    flat = torch.zeros(q.numel() + 4, device="cuda")
    q_off = flat[1:q.numel() + 1].view(b, hq, s, d)
    q_off.copy_(q)
    out = []
    for name, qq, want_design in (("bshd_views", q, "ffma"), ("misaligned_base", q_off,
                                                              "template")):
        assert fa.design(qq, k, v) == want_design, name
        got, design = _served_by(ops, "flash_attention", lambda: ops.flash_attention(
            qq, k, v, causal=causal, window=window, impl="kernel"))
        assert design == want_design, (name, design)
        err = _max_err(got, ref.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                          causal=causal, window=window), TOL[dt],
                       f"flash {name} {VIEW_CASE}")
        out.append({"case": f"{VIEW_CASE} {name}", "offsets": None, "design": design,
                    "max_abs_err": err, "ok": True})
        log("parity", f"{VIEW_CASE} {name} [{design}]: max|kernel - attention| = {err:.3e} "
                      f"(tol {TOL[dt]}) ok")
    return out


def _host_us(fn, iters: int = 200) -> float:
    """Host microseconds a call: back-to-back calls on the host clock with
    no synchronize between them (the launches queue on the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _op_host_us(op_call, direct_call) -> dict:
    """One call's host time through a kernel's operator and through its
    implementation called directly (the wrapper as it was before the op),
    in turns (op, direct, direct, op), the least of each."""
    times = {"op": [], "direct": []}
    for which in ("op", "direct", "direct", "op"):
        times[which].append(_host_us(op_call if which == "op" else direct_call))
    return {"op_us": min(times["op"]), "direct_us": min(times["direct"])}


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_bound_ms(case, ref_mod) -> tuple[float, str, int, int]:
    """Least time for the function on this card: bytes (each input read
    once, the output written once) over the memory rate vs the operations
    these inputs need (two products over the unmasked (q, k) pairs) over
    the peak rate of their type."""
    b, hq, hkv, sq, sk, d, causal, window, dt = case
    item = torch.tensor([], dtype=dt).element_size()
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * item
    pairs = int(ref_mod._mask(sq, sk, sk - sq if causal else 0, 0, causal,
                              window).sum())
    ops = 4 * b * hq * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    LOG.unlink(missing_ok=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gmm, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    results: dict = {}

    # 1. device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", f"{kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__}, "
                  f"cuda {torch.version.cuda}")
    results["device"] = {"kind": kind, "count": count, "nvidia_smi": smi}

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    names = ["flash_attention", "matmul"]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:  # one nvcc each
        builds = dict(zip(names, pool.map(_build.build, names)))
    t_build = time.perf_counter() - t0
    fa.build_info(), mm.build_info(), moe_gmm.build_info()  # bind the entry points
    results["build"] = {"wall_s": t_build}
    for name, built in builds.items():
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "ptxas info" in ln or "spill" in ln]
        log("build", f"{name}.cu in {built.build_s:.1f} s -> {built.path.name}")
        for ln in ptxas:
            log("build", ln)
        results["build"][f"{name}_s"] = built.build_s
        results["build"][f"{name}_ptxas"] = ptxas
    log("build", f"both sources built side by side in {t_build:.1f} s "
                 "(matmul.cu holds matmul_fwd and gmm_fwd)")
    def dynamic_smem(kernel: str) -> int:  # set at launch; ptxas reports static only
        if kernel.startswith("flash_wgmma_kernel<"):  # <D, STEP>
            d = int(kernel[len("flash_wgmma_kernel<"):].split(",")[0])
            return fa._lib().flash_attention_wgmma_smem_bytes(d)
        if kernel.startswith("flash_ffma_kernel<"):  # <D, STEP>
            d = int(kernel[len("flash_ffma_kernel<"):].split(",")[0])
            return fa._lib().flash_attention_ffma_smem_bytes(d)
        if kernel.startswith("mm_ffma_kernel<"):
            return mm._lib().matmul_ffma_smem_bytes()
        return mm._lib().matmul_wgmma_smem_bytes()
    wg_kernels = [dict(k, dynamic_smem=dynamic_smem(k["kernel"]))
                  for built in builds.values() for k in _ptxas_kernels(built.log)
                  if "wgmma_kernel" in k["kernel"] or "ffma_kernel" in k["kernel"]]
    for k in wg_kernels:
        log("build", f"{k['kernel']}: {k['registers']} registers, spill stores "
                     f"{k['spill_stores']} B, spill loads {k['spill_loads']} B, static smem "
                     f"{k['smem']} B, dynamic smem {k['dynamic_smem']} B")
    # flash wgmma and ffma <64|128, forward|step> and <256, forward>,
    # matmul/gmm wgmma and ffma <grouped, a_mn, b_mn>
    assert len(wg_kernels) == 5 + 5 + 8 + 8, [k["kernel"] for k in wg_kernels]
    for name in ("flash_wgmma_kernel<256,0>", "flash_ffma_kernel<256,0>"):
        assert name in [k["kernel"] for k in wg_kernels], (name, wg_kernels)
        assert dynamic_smem(name) > 0, name
    spilled = [k["kernel"] for k in wg_kernels if k["spill_stores"] or k["spill_loads"]]
    assert not spilled, f"ptxas spills registers in {spilled}"
    results["build"]["wgmma_kernels"] = wg_kernels
    # the dry run's CLI cells (32(a), 33(f)) need no card: they run beside
    # phases 3-28, whose host work is one process, and are read in 32 and 33
    dry_llama = _dryrun_start(DRYRUN_CELLS)
    dry_blocks = _dryrun_start(DRYRUN_BLOCK_CELLS)
    # 3. kernel parity ----------------------------------------------------------
    parity = []
    masked = [(case, offsets) for case in MASKED_CASES for offsets in [MASKED_OFFSETS]]
    for case, offsets in [(c, None) for c in ATT_CASES + EXTRA_CASES + [SLICE]] + masked:
        q, k, v, kw = _inputs(case)
        plain = ref.attention
        if offsets is not None:  # rows that see no key: the TPU kernel's tiles decide
            kw.update(offsets)
            plain = ref.attention_tiled
        want_design = fa.design(q, k, v)
        got, design = _served_by(ops, "flash_attention",
                                 lambda: ops.flash_attention(q, k, v, impl="kernel", **kw))
        assert design == want_design == _expected_flash_design(case), (case, design)
        want = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = TOL[case[-1]]
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        parity.append({"case": str(case), "offsets": offsets, "design": design,
                       "max_abs_err": float(err.max()), "ok": ok})
        log("parity", f"{case}{' ' + str(offsets) if offsets else ''} [{design}]: "
                      f"max|kernel - {plain.__name__}| = {float(err.max()):.3e} "
                      f"(tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees at {case} {offsets}")
    slice_err = parity[len(ATT_CASES + EXTRA_CASES)]["max_abs_err"]
    parity += _flash_view_parity(fa, ops, ref)
    assert {p["design"] for p in parity} == {"wgmma", "ffma", "template"}
    assert {p["design"] for p in parity if "float32" in p["case"]} == {"ffma", "template"}
    results["parity"] = parity

    # 4. kernel timing at the serving path's shape ----------------------------------
    q, k, v, kw = _inputs(SLICE, seed=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    assert fa.design(q, k, v) == "wgmma"
    template, o_template = _flash_template(fa, q, k, v, causal=True)
    template()
    _max_err(o_template, ref.attention(q, k, v, **kw), TOL[torch.bfloat16],
             "template flash at the serving shape")
    t_kernel = _time_ms(lambda: ops.flash_attention(q, k, v, impl="kernel", **kw), 50)
    t_device = _device_ms(lambda: ops.flash_attention(q, k, v, impl="kernel", **kw), 20,
                          "flash_wgmma_kernel")
    t_template = _time_ms(template, 10)
    t_plain = _time_ms(lambda: ref.attention(q, k, v, **kw), 5)
    t_lib = _time_ms(lambda: sdpa(q, k, v, is_causal=True), 50)
    t_lib_device = _device_ms(lambda: sdpa(q, k, v, is_causal=True), 20, None)
    t_bwd_plain = _attention_backward_ms(ref, q, k, v, kw)
    host = _op_host_us(lambda: ops.flash_attention(q, k, v, impl="kernel", **kw),
                       lambda: fa.launch(q, k, v, True, 0, None, 0, 0))
    bound_ms, bound_by, nbytes, nops = _attention_bound_ms(SLICE, ref)
    log("timing", f"flash_attention {SLICE[:6]} bf16 causal: kernel (wgmma) {t_kernel:.4f} "
                  f"ms ({t_device:.4f} ms device time), template {t_template:.4f} ms "
                  f"({t_template / t_kernel:.1f}x), plain "
                  f"{t_plain:.4f} ms, sdpa {t_lib:.4f} ms ({t_lib_device:.4f} ms device "
                  f"time), bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {nops} ops); "
                  f"the backward (the plain version's VJP, from saved q, k, v) "
                  f"{t_bwd_plain:.4f} ms; one call's host time through its operator "
                  f"{host['op_us']:.1f} us, its implementation called directly "
                  f"{host['direct_us']:.1f} us")
    results["timing"] = {"kernel_ms": t_kernel, "device_ms": t_device, "host": host,
                         "template_ms": t_template,
                         "plain_ms": t_plain, "library_ms": t_lib,
                         "library_device_ms": t_lib_device,
                         "backward_plain_ms": t_bwd_plain,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": nbytes, "ops": nops}
    del q, k, v, o_template
    results["timing_engine"] = _engine_flash_timing(fa, ops, ref)
    # float32 at the executor call's shape (the ffma design)
    results["timing_f32"] = _flash_timing(fa, ops, ref, SLICE[:-1] + (torch.float32,),
                                          "the executor's prefill", seed=1, iters=10)
    torch.cuda.empty_cache()

    # 5. serve llama-7b, full width and depth --------------------------------------
    cfg = get_config("llama-7b")
    results["serve"] = _serve_phase(cfg, ops)
    launches = results["serve"]["launches"]

    # 6. slice parity: the card (kernel) against the CPU (plain path) ------------
    results["slice_parity"] = _slice_parity(cfg, ops)

    # 7-8. matmul and ring-step parity --------------------------------------------
    results["matmul_parity"] = _matmul_parity(cfg, ops, ref)
    mm_err = results["matmul_parity"]["qproj_bf16_max_abs_err"]
    results["step_parity"] = _step_parity(ops, ref)
    step_err = results["step_parity"]["serving_bf16_max_abs_err"]

    # 9. timing of the matmul and ring-step kernels ---------------------------------
    results["matmul_timing"] = _matmul_timing(cfg, ops, ref)
    results["step_timing"] = _step_timing(ops, ref)
    results["step_timing_f32"] = _step_timing(ops, ref, torch.float32)

    # 10. the executor path on one card -------------------------------------------
    results["executor"] = _executor_path(cfg, ops)

    # 11. the ring path: 4 gloo ranks on the card ---------------------------------------
    results["ring"], a2a_ranks = _ring_path()

    # 12-13. gmm parity and timing -------------------------------------------------------
    moe_cfg = get_config("qwen2-moe-a2.7b")
    results["gmm_parity"] = _gmm_parity(moe_cfg, get_config("mixtral-8x7b"), ops, ref)
    results["gmm_timing"] = _gmm_timing(moe_cfg, get_config("mixtral-8x7b"), ops, ref)

    # 14. serve qwen2-moe-a2.7b, full width and depth --------------------------------------
    results["serve_moe"] = _serve_phase(moe_cfg, ops)

    # 15. MoE slice parity: the card (gmm kernel) against the CPU -------------------------
    results["moe_slice_parity"] = _slice_parity(moe_cfg, ops)

    # 16. the a2a path: 4 gloo ranks on the card, experts sharded 4 ways ---------------------
    results["a2a"] = _a2a_path(*a2a_ranks)

    # 17. train parity: the card (kernel forward, plain backward) against the CPU -----------
    results["train_parity"] = _train_parity(cfg, ops)

    # 18. train llama-7b at full width, 8 layers, bf16 --------------------------------------
    results["train"] = _train_phase(cfg, ops, fa)

    # 19. the paper's Experiment 2: the FFNN's gradient program at AmazonCat-14K sizes -------
    results["ffnn"] = _ffnn_phase(ops)

    # 20. the continuous-batching engine: llama-7b at full width and depth, bf16 -----------
    lens = np.random.default_rng(0).integers(192, 513, size=8).tolist()
    results["engine"] = _engine_phase(cfg, ops, results["serve"]["profile"],
                                      slots=4, block=16, max_seq=528, lens=lens, max_new=16)

    # 21. the engine on qwen2-moe-a2.7b at full width and depth, bf16 ---------------------
    results["engine_moe"] = _engine_phase(
        moe_cfg, ops, results["serve_moe"]["profile"], slots=2, block=16,
        max_seq=520, lens=[384, 448, 512], max_new=8)

    # 22. engine parity: the card against the CPU, llama-7b and qwen2-moe width, 2 layers, f32
    results["engine_parity"] = _engine_parity(cfg, ops)
    results["engine_parity_moe"] = _engine_parity(moe_cfg, ops)

    # 23. the zoo's flash shapes: hymba's (wgmma, GQA 5:1, window 1024), paligemma's (d = 256)
    results["zoo_timing"] = _zoo_flash_timing(fa, ops, ref)

    # 24-26. serve hymba-1.5b, xlstm-125m and paligemma-3b at full width and depth, bf16
    results["zoo_serve"] = _zoo_serve(ops)

    # 27. zoo slice parity (f32, card against CPU) and the zoo's executor path (bf16)
    results["zoo_parity"] = _zoo_slice_parity(ops)
    results["zoo_executor"] = _zoo_executor(ops)

    # 28. the engine on hymba-1.5b at full size, and the xlstm engine parity (f32)
    hymba = get_config("hymba-1.5b")
    hymba_lens = np.random.default_rng(28).integers(1100, 1501, 3).tolist()
    results["engine_hymba"] = _engine_phase(
        hymba, ops, results["zoo_serve"]["hymba-1.5b"]["profile"], slots=2,
        block=16, max_seq=1520, lens=hymba_lens, max_new=8, baseline=True)
    results["engine_hymba_f32"] = _engine_f32_full(hymba, ops, slots=2, block=16,
                                                   max_seq=1520, lens=hymba_lens, max_new=8)
    results["engine_parity_xlstm"] = _engine_parity(get_config("xlstm-125m"), ops)

    # 36. minicpm-2b, musicgen-large, nemotron-4-15b, yi-9b whole, mixtral-8x7b and
    # qwen1.5-110b at 8 layers: served, held against the CPU, the executor, the layouts
    results["dense_zoo"] = _dense_zoo_phase(fa, ops, ref)
    dz = results["dense_zoo"]
    zoo_designs = _zoo_design_counts(results)
    # every flash launch of the zoo takes wgmma (bf16) or ffma (float32), none the template
    assert zoo_designs["flash_attention"]["template"] == 0, zoo_designs["flash_attention"]

    # 29. the pipelined path: llama-7b's prefill graph on 1, 2 and 4 gloo ranks of a pp axis
    results["pipeline"] = _pipeline_path(cfg)

    # 30. the static verifier: the CLI, the memory pass against the allocator, the registry
    results["analysis"] = _analysis_phase(cfg, results)
    pipe_designs = results["pipeline"]["designs_total"]

    # 31. gspmd on DTensor; llama-7b trained and served on a mesh (gloo ranks on the card)
    results["mesh"] = _mesh_phase(ops)
    gx = results["mesh"]["gspmd"]

    # 32. the dry run: the production mesh with no card; abstract against real
    results["dryrun"] = _dryrun_phase(ops, results, dry_llama)
    dry = results["dryrun"]

    # 33. the MoE, hymba and xLSTM blocks on meshes of gloo ranks sharing the card
    results["blocks"] = _block_mesh_phase(ops)
    results["blocks"]["dryrun"] = _dryrun_blocks(dry_blocks, results["blocks"]["train"])
    mb = _mesh_blocks_launches(results["blocks"])

    # 35's ranks start here and run beside phase 34 (the run's time limit)
    ckpt_started = _mesh_ckpt_start()

    # 34. the engine's paged decode on (1, 4) gloo ranks sharing the card; compile(donate=)
    results["engine_mesh"] = _engine_mesh_phase(cfg, ops)
    em = results["engine_mesh"]

    # 35. checkpoints of a run on a mesh; the gspmd executor's repairs (gloo ranks on the card)
    results["mesh_ckpt"] = _mesh_ckpt_phase(ckpt_started)
    mc = results["mesh_ckpt"]

    mt, st = results["matmul_timing"]["bfloat16"], results["step_timing"]
    m32 = results["matmul_timing"]["float32"]
    gt, g32 = results["gmm_timing"]["w1_prefill"], results["gmm_timing"]["w1_prefill_f32"]
    gdec = results["gmm_timing"]["w1_decode"]
    mx = dz["serve"]["mixtral-8x7b"]
    e16, e32 = results["timing_engine"]["bfloat16"], results["timing_engine"]["float32"]
    f32b4, st32 = results["timing_f32"], results["step_timing_f32"]
    ring32 = results["ring"]["float32"]
    serve_designs = results["serve"]["designs"]
    ring16 = results["ring"]["bfloat16"]
    ex32 = results["executor"]["float32"]
    kernels = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:134",
         "design": _path_design(serve_designs["flash_attention"]),
         "launches": launches["flash_attention"], "max_abs_err": slice_err,
         "ms": t_kernel, "template_ms": results["timing"]["template_ms"],
         "plain_ms": t_plain, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": t_lib,
         "library_device_ms": results["timing"]["library_device_ms"],
         "device_ms": results["timing"]["device_ms"],
         "backward_plain_ms": results["timing"]["backward_plain_ms"],
         "train_launches_per_step": results["train"]["flash_launches_per_step"],
         "engine_launches": results["engine"]["launches"]["flash_attention"],
         "engine_design": _path_design(results["engine"]["designs"]["flash_attention"]),
         "engine_moe_launches": results["engine_moe"]["launches"]["flash_attention"],
         "engine_shape_device_ms": e16["device_ms"], "engine_shape_bound_ms": e16["bound_ms"],
         "engine_shape_library_device_ms": e16["library_device_ms"],
         "f32_design": e32["design"], "f32_ms": e32["kernel_ms"],
         "f32_device_ms": e32["device_ms"], "f32_template_ms": e32["template_device_ms"],
         "f32_plain_ms": e32["plain_ms"],
         "f32_bound_ms": e32["bound_ms"], "f32_bound_by": e32["bound_by"],
         "f32_library_ms": e32["library_ms"],
         "f32_library_device_ms": e32["library_device_ms"],
         "f32_b4_design": f32b4["design"], "f32_b4_ms": f32b4["kernel_ms"],
         "f32_b4_device_ms": f32b4["device_ms"],
         "f32_b4_template_ms": f32b4["template_device_ms"],
         "f32_b4_plain_ms": f32b4["plain_ms"], "f32_b4_bound_ms": f32b4["bound_ms"],
         "f32_b4_bound_by": f32b4["bound_by"], "f32_b4_library_ms": f32b4["library_ms"],
         "f32_b4_library_device_ms": f32b4["library_device_ms"],
         "f32_executor_launches": ex32["launches"]["flash_attention"],
         "f32_executor_design": _path_design(ex32["designs"]["flash_attention"]),
         "f32_train_parity_launches": sum(results["train_parity"]["launches"]),
         "f32_train_parity_design": _path_design(results["train_parity"]["designs"]),
         "f32_engine_parity_launches": results["engine_parity"]["launches"]["flash_attention"],
         "f32_engine_parity_design": _path_design(
             results["engine_parity"]["designs"]["flash_attention"]),
         "zoo": {name: {k: z[k] for k in ("design", "device_ms", "template_device_ms",
                                          "plain_ms", "library_device_ms", "library_kernels",
                                          "bound_ms", "bound_by", "max_abs_err")}
                 for name, z in results["zoo_timing"].items()},
         "zoo_serve_launches": {a: r["launches"]["flash_attention"]
                                for a, r in results["zoo_serve"].items()},
         "zoo_serve_designs": {a: _path_design(r["designs"]["flash_attention"])
                               for a, r in results["zoo_serve"].items()},
         "dense_zoo": {name: {k: z[k] for k in ("design", "device_ms", "template_device_ms",
                                                "plain_ms", "library_device_ms",
                                                "library_kernels", "bound_ms", "bound_by",
                                                "max_abs_err")}
                       for name, z in dz["flash"]["timing"].items()},
         "dense_serve_launches": {a: r["launches"]["flash_attention"]
                                  for a, r in dz["serve"].items()},
         "dense_serve_per_prefill": {a: r["launches_per_prefill"]["flash_attention"]
                                     for a, r in dz["serve"].items()},
         "dense_serve_designs": {a: _path_design(r["designs"]["flash_attention"])
                                 for a, r in dz["serve"].items()},
         "dense_parity_launches": {a: r["launches"]["flash_attention"]
                                   for a, r in dz["parity"].items()},
         "zoo_launches_by_design": zoo_designs["flash_attention"],
         "pipeline_launches": sum(pipe_designs["flash_attention"].values()),
         "pipeline_design": pipe_designs["flash_attention"],
         "gspmd_launches_per_rank": {f"{m}/{dt}": gx[m][dt]["launches_per_rank"][0][
             "flash_attention"] for m in gx for dt in RING_DTYPES},
         "mesh_serve_launches_per_rank": results["mesh"]["serve"]["flash_launches"],
         "op_host_us": results["timing"]["host"]["op_us"],
         "direct_host_us": results["timing"]["host"]["direct_us"],
         "dryrun_calls_per_rank": {cell: r["kernel_calls"]["flash_attention"]
                                   for cell, r in dry["cli"].items() if cell != "hbm_bytes"},
         "dryrun_one_rank_designs": {c: r["flash_designs"]
                                     for c, r in dry["one_rank"].items()},
         "mesh_blocks_launches_per_rank": mb["flash_attention"],
         "mesh_engine_launches_per_rank": {"launches": em["engine"]["flash_launches"],
                                           "design": em["engine"]["flash_designs"]},
         "donated_executor": {dt: {"launches": r["launches"]["flash_attention"],
                                   "design": r["designs"]["flash_attention"]}
                              for dt, r in em["donate"].items()},
         "ckpt_mesh_launches_per_rank": {
             "run": mc["ckpt"]["launches_per_rank"], "design": mc["ckpt"]["design"],
             **{name: row["launches"] for name, row in mc["ckpt"]["restarts"].items()}},
         "gspmd_repairs_launches_per_rank": {
             "dsplit": mc["repairs"]["dsplit"]["launches_per_rank"][0],
             "design": mc["repairs"]["dsplit"]["design"]}},
        {"name": "flash_attention_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:274",
         "design": _path_design(_sum_counts(ring16["designs_per_rank"],
                                            "flash_attention_step")),
         "launches": ring16["launches_total"]["flash_attention_step"],
         "max_abs_err": step_err, "ms": st["kernel_ms"], "template_ms": st["template_ms"],
         "wrapper_ms": st["wrapper_ms"], "plain_ms": st["plain_ms"],
         "bound_ms": st["bound_ms"], "bound_by": st["bound_by"], "library_ms": None,
         "f32_design": _path_design(_sum_counts(ring32["designs_per_rank"],
                                                "flash_attention_step")),
         "f32_launches": ring32["launches_total"]["flash_attention_step"],
         "f32_max_abs_err": results["step_parity"]["serving_f32_max_abs_err"],
         "f32_ms": st32["kernel_ms"], "f32_template_ms": st32["template_ms"],
         "f32_wrapper_ms": st32["wrapper_ms"], "f32_plain_ms": st32["plain_ms"],
         "f32_bound_ms": st32["bound_ms"], "f32_bound_by": st32["bound_by"]},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:57",
         "design": _path_design(results["executor"]["bfloat16"]["designs"]["matmul"]),
         "launches": results["executor"]["bfloat16"]["launches"]["matmul"],
         "max_abs_err": mm_err, "ms": mt["kernel_ms"], "template_ms": mt["template_ms"],
         "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"], "bound_by": mt["bound_by"],
         "library_ms": mt["library_ms"],
         "f32_design": _path_design(ex32["designs"]["matmul"]),
         "f32_launches": ex32["launches"]["matmul"],
         "f32_max_abs_err": results["matmul_parity"]["qproj_f32_max_abs_err"],
         "f32_ms": m32["kernel_ms"], "f32_template_ms": m32["template_ms"],
         "f32_plain_ms": m32["plain_ms"], "f32_library_ms": m32["library_ms"],
         "f32_bound_ms": m32["bound_ms"], "f32_bound_by": m32["bound_by"],
         "ffnn_launches_per_step": results["ffnn"]["matmul_launches_per_step"],
         "ffnn_design": _path_design(results["ffnn"]["designs"]["matmul"]),
         "zoo_executor_launches": {a: r["launches"]["matmul"]
                                   for a, r in (results["zoo_executor"]
                                                | dz["executor"]).items()},
         "zoo_launches_by_design": zoo_designs["matmul"],
         "pipeline_launches": sum(pipe_designs["matmul"].values()),
         "pipeline_design": pipe_designs["matmul"],
         "gspmd_launches_per_rank": {f"{m}/{dt}": gx[m][dt]["launches_per_rank"][0][
             "matmul"] for m in gx for dt in RING_DTYPES},
         "mesh_blocks_launches_per_rank": mb["matmul"],
         "donated_executor": {dt: {"launches": r["launches"]["matmul"],
                                   "design": r["designs"]["matmul"]}
                              for dt, r in em["donate"].items()},
         "gspmd_repairs_launches_per_rank": {
             name: {"launches": g["launches"]["matmul"], "design": g["designs"]["matmul"]}
             for name, g in mc["repairs"]["graphs"].items()},
         "op_host_us": mt["host"]["op_us"], "direct_host_us": mt["host"]["direct_us"]},
        {"name": "gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/moe_gmm.py:58",
         "design": _path_design(results["serve_moe"]["designs"]["gmm"]),
         "launches": results["serve_moe"]["launches"]["gmm"],
         "max_abs_err": results["gmm_parity"]["qwen2_prefill_bf16_max_abs_err"],
         "ms": gt["kernel_ms"], "template_ms": gt["template_ms"], "plain_ms": gt["plain_ms"],
         "bound_ms": gt["bound_ms"], "bound_by": gt["bound_by"],
         "library_ms": gt["library_ms"],
         "f32_design": _path_design(results["moe_slice_parity"]["designs"]["gmm"]),
         "f32_launches": results["moe_slice_parity"]["launches"]["gmm"],
         "f32_ms": g32["kernel_ms"], "f32_template_ms": g32["template_ms"],
         "f32_plain_ms": g32["plain_ms"], "f32_library_ms": g32["library_ms"],
         "f32_bound_ms": g32["bound_ms"], "f32_bound_by": g32["bound_by"],
         "decode_ms": gdec["kernel_ms"], "decode_plain_ms": gdec["plain_ms"],
         "decode_bound_ms": gdec["bound_ms"], "decode_bound_by": gdec["bound_by"],
         "decode_library_ms": gdec["library_ms"],
         "engine_launches": results["engine_moe"]["launches"]["gmm"],
         "engine_design": _path_design(results["engine_moe"]["designs"]["gmm"]),
         # the decode steps replay one CUDA graph: one replay's launches
         # counted (counters set to 0 around it) and read from its trace;
         # ``launches`` and ``engine_launches`` count the serve call's and
         # the engine run's replays with their eager steps
         "decode_graph_launches_per_replay":
             results["serve_moe"]["launches_per_graph_replay"]["gmm"],
         "decode_graph_traced_per_replay":
             results["serve_moe"]["traced_launches_per_graph_replay"]["gmm"],
         "decode_graph_design": _path_design(
             results["serve_moe"]["designs_per_graph_replay"]["gmm"]),
         "engine_graph_traced_per_replay":
             results["engine_moe"]["traced_decode_step_launches"]["gmm"],
         "engine_graph_replays": results["engine_moe"]["replays"],
         "zoo_launches_by_design": zoo_designs["gmm"],
         "mixtral_serve": {
             "layers": mx["layers"], "launches": mx["launches"]["gmm"],
             "per_prefill": mx["launches_per_prefill"]["gmm"],
             "per_decode_step": mx["launches_per_decode_step"]["gmm"],
             "per_graph_replay": mx["launches_per_graph_replay"]["gmm"],
             "traced_per_graph_replay": mx["traced_launches_per_graph_replay"]["gmm"],
             "design": _path_design(mx["designs"]["gmm"])},
         "mixtral": {name: {k: results["gmm_timing"][name][k]
                            for k in ("shape", "kernel_ms", "template_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
                     for name in ("mixtral_w1", "mixtral_w2", "mixtral_w1_decode")},
         "mixtral_parity_launches": dz["parity"]["mixtral-8x7b"]["launches"]["gmm"],
         "mesh_blocks_launches_per_rank": mb["gmm"]},
    ]}
    kernels["kernels"][1]["zoo_launches_by_design"] = zoo_designs["flash_attention_step"]
    results.update(kernels)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    log("done", f"every phase in {time.perf_counter() - T0:.0f} s (limit 1,200 s)")

    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


def _zoo_design_counts(results: dict) -> dict:
    """Every kernel's launches by design over the zoo's counted runs
    (phases 24-28 and 36): the serve calls, the prefix prefill excluded (it
    ran with the counters of its own check), the slice parities, the
    executor calls and both engines' second runs."""
    dense = results["dense_zoo"]
    runs = [r["designs"] for r in results["zoo_serve"].values()]
    runs += [r["designs"] for r in dense["serve"].values()]
    runs += [{"flash_attention": r["designs"]} for r in results["zoo_parity"].values()]
    runs += [r["designs"] for r in dense["parity"].values()]
    runs += [r["designs"] for r in results["zoo_executor"].values()]
    runs += [r["designs"] for r in dense["executor"].values()]
    runs += [results["engine_hymba"]["designs"], results["engine_hymba_f32"]["designs"],
             results["engine_parity_xlstm"]["designs"]]
    out = {k: dict.fromkeys(DESIGNS_ALL, 0) for k in ("flash_attention", "flash_attention_step",
                                                      "matmul", "gmm")}
    for run in runs:
        for kernel, by_design in run.items():
            for d, n in by_design.items():
                out[kernel][d] += n
    return out


DESIGNS_ALL = ("wgmma", "ffma", "template")
ENGINE_PREFILL = (1, 32, 32, 512, 512, 128, True, 0)  # one llama-7b request, 512 bucket


def _engine_flash_timing(fa, ops, ref) -> dict:
    """The forward kernel at one bucketed prefill of the engine (batch 1,
    the 512 bucket, causal) in bf16 (the wgmma design) and in float32 (the
    ffma design, which the float32 paths take): held against its plain
    version, then its time by CUDA events and its device time
    (torch.profiler), the template design's device time at the same inputs
    (its C entry), the plain version, SDPA on the same inputs (events and
    device time) and the bound."""
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        case = ENGINE_PREFILL + (dt,)
        res[str(dt).split(".")[1]] = _flash_timing(fa, ops, ref, case, "an engine prefill",
                                                  seed=3, iters=20)
    torch.cuda.empty_cache()
    return res


FLASH_DEVICE_KERNEL = {"wgmma": "flash_wgmma_kernel", "ffma": "flash_ffma_kernel",
                       "template": "flash_fwd_kernel"}


def _flash_timing(fa, ops, ref, case, what: str, seed: int, iters: int) -> dict:
    """The forward kernel at ``case`` (causal) against its plain version,
    then by CUDA events and device time, the template design's device time
    (its C entry, on the same inputs), the plain version, SDPA (events and
    device time) and the bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt = case[-1]
    q, k, v, kw = _inputs(case, seed=seed)
    design = fa.design(q, k, v)
    assert design == _expected_flash_design(case), design
    kernel = lambda: ops.flash_attention(q, k, v, impl="kernel", **kw)  # noqa: E731
    err = _max_err(kernel(), ref.attention(q, k, v, **kw), TOL[dt], f"flash at {what}, {dt}")
    template, o_template = _flash_template(fa, q, k, v, causal=True)
    template()
    _max_err(o_template, ref.attention(q, k, v, **kw), TOL[dt], f"template flash at {what}")
    t_kernel = _time_ms(kernel, iters)
    t_device = _device_ms(kernel, iters // 2, FLASH_DEVICE_KERNEL[design])
    t_template = _device_ms(template, 5, "flash_fwd_kernel")
    t_plain = _time_ms(lambda: ref.attention(q, k, v, **kw), 3)
    t_lib = _time_ms(lambda: sdpa(q, k, v, is_causal=True), iters)
    t_lib_device = _device_ms(lambda: sdpa(q, k, v, is_causal=True), iters // 2, None)
    bound_ms, bound_by, nbytes, nops = _attention_bound_ms(case, ref)
    log("timing", f"flash_attention {case[:6]} {dt} causal ({what}): kernel ({design}) "
                  f"{t_kernel:.4f} ms ({t_device:.4f} ms device time), template "
                  f"{t_template:.4f} ms device time ({t_template / t_device:.2f}x), plain "
                  f"{t_plain:.4f} ms, sdpa {t_lib:.4f} ms ({t_lib_device:.4f} ms device "
                  f"time), bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {nops} ops); "
                  f"max|kernel - plain| {err:.3e}")
    del q, k, v, o_template
    return {"case": str(case), "design": design, "max_abs_err": err, "kernel_ms": t_kernel,
            "device_ms": t_device, "template_device_ms": t_template, "plain_ms": t_plain,
            "library_ms": t_lib, "library_device_ms": t_lib_device, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "ops": nops}


def _attn_layers(cfg) -> int:
    """Layers that run attention (attn and hymba blocks): one flash launch
    each a prefill."""
    return sum(1 for blk in cfg.blocks() if blk in ("attn", "hymba"))


def _serve_phase(cfg, ops, b: int = 4, prompt_len: int = 512, max_new: int = 16,
                 flash_design: str = "wgmma") -> dict:
    """Serve ``cfg`` at full width and depth on the card (bf16, random
    weights from seed 0) through ``launch.serve.serve``: planned through a
    plan-cache file (cold here, a hit in the serve call), a short warm-up
    request, then the counted request with the launch counters set to 0
    just before it and read just after.  Then one prefill and one decode
    step, each counted and profiled.  Every flash launch takes
    ``flash_design``, every matmul and gmm launch wgmma.  Where the config
    has a prefix (paligemma), one more prefill through ``make_prefill_step``
    on ``prefix_len`` seeded prefix embeddings and ``prompt_len -
    prefix_len`` tokens, counted and profiled the same way."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.eingraphs import program_for

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(b, prompt_len)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        cold = PlanCache.open(store)
        t0 = time.perf_counter()
        program_for(cfg, ShapeConfig("serve", "prefill", prompt_len, b)).compile(
            mesh_axes=dict(serve_mod.ONE_DEVICE_MESH), cache=cold)
        t_cold = time.perf_counter() - t0
        assert cold.stats["misses"] == 1 and cold.stats["hits"] == 0, cold.stats
        t0 = time.perf_counter()
        params = tf.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree.leaves(params))
        log("serve", f"{cfg.name}: planned cold in {t_cold:.4f} s; {n_params} params "
                     f"made on the card in {t_init:.1f} s")
        # a short warm-up request, then the counted run
        serve_mod.serve(cfg, prompts, max_new=2, params=params,
                        plan_cache=PlanCache.open(store), device="cuda")
        warm = PlanCache.open(store)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        gen, stats = serve_mod.serve(cfg, prompts, max_new=max_new, params=params,
                                     plan_cache=warm, device="cuda")
        launches = ops.launch_counts()
        designs = ops.design_counts()
        peak = torch.cuda.max_memory_allocated()
    assert warm.stats["hits"] == 1 and warm.stats["misses"] == 0, warm.stats
    assert stats["graph"] is True, stats  # the decode step replays a CUDA graph
    # gmm: w1 (w3) and w2 per MoE layer, in prefill and in every decode step
    per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    per_prefill = {"flash_attention": _attn_layers(cfg), "flash_attention_step": 0,
                   "matmul": 0, "gmm": per_layer * cfg.n_layers}
    per_decode = dict(per_prefill, flash_attention=0)
    want = dict(per_prefill, gmm=per_layer * cfg.n_layers * (1 + stats["decode_steps"]))
    assert launches == want, (launches, want)
    # bf16 with tensors TMA can address: every flash and gmm launch of the
    # serve call took the wgmma design
    for kernel in ("flash_attention", "matmul", "gmm"):
        want_design = flash_design if kernel == "flash_attention" else "wgmma"
        assert designs[kernel][want_design] == launches[kernel] == sum(
            designs[kernel].values()), designs
    assert gen.shape == (b, max_new), gen.shape
    assert ((gen >= 0) & (gen < cfg.vocab_padded)).all()
    # where the time goes: one prefill and one decode step, counted, then
    # profiled; the decode step eagerly and as the graph serve() replays
    prefill, decode = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device="cuda")
        ops.reset_launch_counts()
        logits, caches = prefill(params, {"tokens": tokens})
        got_prefill = ops.launch_counts()
        assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
        caches = serve_mod.prepare_decode_caches(cfg, caches, prompt_len,
                                                 prompt_len + max_new)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        against = _graph_against_eager(cfg, params, caches, tok, prompt_len, max_new, ops)
        ops.reset_launch_counts()
        decode(params, tok, caches, prompt_len)
        got_decode = ops.launch_counts()
        assert (got_prefill, got_decode) == (per_prefill, per_decode), (got_prefill,
                                                                         got_decode)
        graphed = _graphed_step(cfg, params, caches, tok, prompt_len)
        ops.reset_launch_counts()
        graphed()
        got_replay, replay_designs = ops.launch_counts(), ops.design_counts()
        assert got_replay == per_decode and graphed.replays == 2, (got_replay, per_decode)
        assert replay_designs["gmm"]["wgmma"] == per_decode["gmm"], replay_designs
        breakdown = {
            "prefill": _profile(lambda: prefill(params, {"tokens": tokens})),
            "decode_step": _profile(lambda: decode(params, tok, caches, prompt_len)),
            "decode_step_graph": _profile(graphed),
        }
        del graphed
        # the prefill as one CUDA graph, beside the eager call (serve()'s
        # own runs eagerly: one call a serve never reaches a capture): the
        # replay's logits bit-equal to the eager call's, its launches
        # counted (the capture's) and read from its trace
        prefill_graph = steps.GraphedStep(
            lambda _, tokens: prefill(params, {"tokens": tokens})[0], None,
            {"tokens": tokens}, graph=True)
        prefill_graph()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (replayed,) = prefill_graph()  # the capture, then its first replay
        torch.cuda.synchronize()
        t_prefill_capture = time.perf_counter() - t0
        got_prefill_replay = ops.launch_counts()
        assert got_prefill_replay == per_prefill, (got_prefill_replay, per_prefill)
        assert torch.equal(replayed, logits), f"{cfg.name}: prefill graph != eager"
        breakdown["prefill_graph"] = _profile(prefill_graph)
        traced_prefill = _traced_launches(breakdown["prefill_graph"])
        assert traced_prefill == _traced_launches(breakdown["prefill"]) == per_prefill, (
            traced_prefill, per_prefill)
        del prefill_graph, replayed
        # what the card ran in one replay, read from its trace (a graph's
        # kernels show one by one), against the counters' per-replay
        # launches (the capture's, added a replay) and the eager step's trace
        traced = _traced_launches(breakdown["decode_step_graph"])
        assert traced == _traced_launches(breakdown["decode_step"]) == got_replay, (
            traced, got_replay)
        if cfg.prefix_len:  # the stubbed vision tower's patch embeddings, then tokens
            pe = torch.as_tensor(np.random.default_rng(1).normal(
                size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32), device="cuda")
            pbatch = {"tokens": tokens[:, :prompt_len - cfg.prefix_len], "prefix_embeds": pe}
            ops.reset_launch_counts()
            logits_pe, _ = prefill(params, pbatch)
            got_prefix = ops.launch_counts()
            assert got_prefix == per_prefill, got_prefix
            assert ops.design_counts()["flash_attention"][flash_design] == _attn_layers(cfg)
            assert logits_pe.shape == (b, 1, cfg.vocab_padded)
            assert bool(torch.isfinite(logits_pe).all()), "non-finite prefix prefill logits"
            breakdown["prefix_prefill"] = _profile(lambda: prefill(params, pbatch))
            del pe, pbatch, logits_pe
    for name, br in breakdown.items():
        log("profile", f"{cfg.name} {name}: wall {br['wall_ms']:.3f} ms, device busy "
                       f"{br['device_ms']:.3f} ms (idle share {br['idle_share']:.3f}), "
                       f"{br['kernels']} kernels; device ms by kind {br['by_kind_ms']}; "
                       f"top {br['top_kernels_ms'][:3]}")
    log("serve", f"{cfg.name} bf16 b={b} prompt={prompt_len} new={max_new}: "
                 f"t_plan_s={stats['t_plan_s']:.4f} (cache hit) "
                 f"t_prefill_s={stats['t_prefill_s']:.4f} "
                 f"t_decode_s={stats['t_decode_s']:.4f} tok_per_s={stats['tok_per_s']:.2f} "
                 f"max_memory_allocated={peak} launches={launches} by design {designs}; "
                 f"per prefill {got_prefill}, per decode step {got_decode}")
    log("serve", f"generations[0] = {gen[0].tolist()}")
    log("serve", f"{cfg.name}: the prefill as a CUDA graph: its capture and first replay "
                 f"{t_prefill_capture:.4f} s, logits bit-equal to the eager prefill's; one "
                 f"replay launched {got_prefill_replay} (counted), {traced_prefill} (its "
                 f"trace)")
    log("serve", f"{cfg.name}: one replay of the decode graph launched {got_replay} by "
                 f"design {replay_designs} (counted), {traced} (its trace); graphed against eager from one prefill's caches, "
                 f"{against['steps']} steps: tokens equal, max|logit diff| "
                 f"{against['max_abs_logit_diff']:.3e}; loop walls {against['graph_wall_s']:.4f}"
                 f" s (graph, its first step eager and the capture included) and "
                 f"{against['eager_wall_s']:.4f} s (eager)")
    res = {k: v for k, v in stats.items() if k != "policy"}
    res.update({"t_plan_cold_s": t_cold, "max_memory_allocated": peak,
                "launches": launches, "designs": designs,
                "launches_per_prefill": got_prefill,
                "launches_per_decode_step": got_decode,
                "launches_per_graph_replay": got_replay,
                "designs_per_graph_replay": replay_designs,
                "traced_launches_per_graph_replay": traced,
                "prefill_graph_capture_s": t_prefill_capture,
                "launches_per_prefill_replay": got_prefill_replay,
                "traced_launches_per_prefill_replay": traced_prefill,
                "graph_against_eager": against, "n_params": n_params,
                "flash_design": flash_design,
                "batch": b, "prompt_len": prompt_len, "max_new": max_new,
                "profile": breakdown})
    del params, logits, caches, tokens, tok
    torch.cuda.empty_cache()
    return res


def _graphed_step(cfg, params, caches, tok, pos: int):
    """``serve()``'s compiled decode step (``launch.serve.greedy_step``) at
    ``pos``, called twice: its eager warm-up, then its capture and first
    replay."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps

    run = serve_mod.greedy_step(steps.make_serve_step(cfg), params, caches, tok, pos,
                                graph=True)
    run()
    run()
    return run


def _logit_tap(decode, logs, prompt_len: int):
    """``decode`` that also writes each step's last-position logits into
    row ``pos - prompt_len`` of ``logs`` (steps, b, v) float32 on the card,
    indexed by the position tensor: a replayed graph writes every step's
    row, as the eager step does."""
    from repro_torch.core.gspmd import full

    def tapped(params, tokens, caches, pos):
        logits, caches = decode(params, tokens, caches, pos)
        logs.index_copy_(0, (pos - prompt_len).view(1), full(logits)[:, -1].float()[None])
        return logits, caches

    return tapped


def _graph_against_eager(cfg, params, caches, tok, prompt_len: int, max_new: int,
                         ops) -> dict:
    """``serve()``'s decode loop from two copies of one prefill's caches:
    ``max_new - 1`` steps as one CUDA graph (its first step eager, then
    captured and replayed) and as many eager.  The tokens must be equal,
    and so must the launches by design; the logits' largest difference is
    returned with each loop's wall (ending in the generations' host fetch)."""
    from repro_torch.core import tree
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps

    copy = tree.map(torch.clone, caches)
    out = {}
    for graph, cs in ((True, caches), (False, copy)):
        logs = torch.full((max_new - 1, tok.shape[0], cfg.vocab_padded), float("nan"),
                          device="cuda")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, _, n = serve_mod.decode_loop(_logit_tap(steps.make_serve_step(cfg), logs,
                                                     prompt_len),
                                          params, cs, tok, prompt_len, max_new, graph=graph)
        out[graph] = (gen, logs, ops.design_counts(), time.perf_counter() - t0)
    del copy
    (g_gen, g_log, g_designs, g_wall), (e_gen, e_log, e_designs, e_wall) = out[True], out[False]
    assert np.array_equal(g_gen, e_gen), (cfg.name, g_gen, e_gen)
    assert g_designs == e_designs, (g_designs, e_designs)
    return {"steps": n, "tokens_equal": True,
            "max_abs_logit_diff": float((g_log - e_log).abs().max()),
            "max_abs_logit": float(e_log.abs().max()), "graph_wall_s": g_wall,
            "eager_wall_s": e_wall, "designs": g_designs}


def _slice_parity(cfg, ops) -> dict:
    """``cfg`` at full width, 2 layers, float32: the same weights on the
    card (the kernels) and on the CPU (the plain path); prefill logits and
    greedy tokens."""
    from repro_torch.core import tree
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = tf.init_params(cfg2, seed=1, device="cpu")
    gpu_params = tree.map(lambda t: t.to("cuda"), cpu_params)
    p2 = np.random.default_rng(1).integers(0, cfg2.vocab, size=(2, 64)).astype(np.int32)
    prefill = steps.make_prefill_step(cfg2)
    ops.reset_launch_counts()
    with torch.inference_mode():
        lg_gpu, _ = prefill(gpu_params, {"tokens": torch.as_tensor(p2, device="cuda")})
        launches = ops.launch_counts()
        designs = ops.design_counts()
        lg_cpu, _ = prefill(cpu_params, {"tokens": torch.as_tensor(p2)})
    per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    assert launches["flash_attention"] == 2 and launches["gmm"] == 2 * per_layer, launches
    lg_gpu, lg_cpu = lg_gpu.float().cpu(), lg_cpu.float()
    scale = float(lg_cpu.abs().max())
    diff = float((lg_gpu - lg_cpu).abs().max())
    # float32 end to end with TF32 off: the card and the CPU differ only in
    # the order of their sums (d_model- and d_ff-wide contractions)
    torch.testing.assert_close(lg_gpu, lg_cpu, rtol=1e-4, atol=1e-4 * scale)
    g_gpu, _ = serve_mod.serve(cfg2, p2, max_new=4, params=gpu_params, device="cuda")
    g_cpu, _ = serve_mod.serve(cfg2, p2, max_new=4, params=cpu_params, device="cpu")
    assert np.array_equal(g_gpu, g_cpu), (g_gpu, g_cpu)
    log("slice-parity", f"{cfg.name} width, 2 layers, f32: max|logit diff| = {diff:.3e} "
                        f"(max|logit| {scale:.3f}); launches {launches}; gmm launches by "
                        f"design {designs['gmm']}; greedy tokens equal: {g_gpu.tolist()}")
    del cpu_params, gpu_params
    torch.cuda.empty_cache()
    return {"max_abs_logit_diff": diff, "max_abs_logit": scale, "launches": launches,
            "designs": designs, "tokens": g_gpu.tolist()}


def _profile(fn, ranges: tuple[str, ...] = ()) -> dict:
    """``fn`` warmed up, timed once on the host clock (ending in a
    synchronize), then run twice more under torch.profiler, of which the
    second call is read: the device time of its kernels, by kind (this
    port's flash-attention, ring-step, matmul and gmm kernels of every
    design, cuBLAS matrix products, everything else), and the idle share
    of the unprofiled wall time (tracing itself slows the host down).
    A trace started late in a process can lose its first device events, so
    ``_fill_trace_start`` and the first call only fill that window, and a
    spin kernel between the calls marks where the read call starts.  A
    trace can also come back short of an event or of all of a call's: the
    kernels counted by kind are the more of the two traced calls'
    (``by_kind_count``, which ``_traced_launches`` reads), and a trace
    that lost its marker, or whose read call holds no kernel or fewer than
    the first call, is taken again (at most twice more).
    ``ranges`` names ``record_function`` ranges whose kernels' device time
    is reported too (``range_ms``, the read call's half of the ranges;
    those kernels also count in their kinds), for which the host's ops are
    traced as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    for attempt in range(3):
        with profile(activities=activities) as prof:
            _fill_trace_start()
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1 << 16)  # the marker
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        device = _device_kernels(prof)
        marks = [e for e in device if "spin_kernel" in e.name]
        if not marks:
            log("trace", f"trace {attempt + 1} lost its marker kernel; tracing again")
            continue
        start, first_start = marks[-1].end, marks[-2].end if len(marks) > 1 else None
        kernels = [e.start for e in device if not _not_a_kernel(e.name, ranges)]
        n_read = sum(t >= start for t in kernels)
        n_first = sum(first_start is not None and first_start <= t < start for t in kernels)
        if n_read and n_read >= n_first:
            break
        log("trace", f"trace {attempt + 1} holds {n_read} kernels after its marker, "
                     f"{n_first} in the call before; tracing again")
    assert marks, "three traces lost the marker kernel"
    by_kind = {"flash_attention": 0.0, "flash_step": 0.0, "matmul": 0.0, "gmm": 0.0,
               "gemm": 0.0, "other": 0.0}
    count = dict.fromkeys(by_kind, 0)
    first_count = dict.fromkeys(by_kind, 0)  # the first traced call's, by kind
    by_name: dict[str, float] = {}
    n = 0
    for e in device:
        if _not_a_kernel(e.name, ranges):
            continue
        if e.start < start:
            if first_start is not None and e.start >= first_start:
                first_count[_kernel_kind(e.name)] += 1
            continue
        n += 1
        ms = e.ms
        kind = _kernel_kind(e.name)
        by_kind[kind] += ms
        count[kind] += 1
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms
    device_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    range_ms = {}
    for r in ranges:
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CPU
                      and e.name == r), key=lambda e: e.time_range.start)
        range_ms[r] = sum(e.device_time_total for e in evs[len(evs) // 2:]) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kernels": n, "range_ms": range_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "by_kind_ms": {k: round(v, 4) for k, v in by_kind.items()},
            "by_kind_count": {k: max(v, first_count[k]) for k, v in count.items()},
            "top_kernels_ms": [(k, round(v, 4)) for k, v in top]}


def _not_a_kernel(name: str, ranges: tuple[str, ...]) -> bool:
    """A device event of a ``_profile`` trace that is no kernel of the
    traced call: a memory event, the marker spin, or a range's span on the
    device timeline."""
    return "Loading" in name or "Buffer" in name or "spin_kernel" in name or name in ranges


def _kernel_kind(name: str) -> str:
    """What a device kernel of a trace is: this port's flash forward or
    ring step, matmul or gmm (any design), a cuBLAS or CUTLASS product,
    or other."""
    name = name.lower()
    step = "true>" in name or "lb1e" in name  # flash_*_kernel<..., STEP>
    flash = any(k in name for k in ("flash_fwd_kernel", "flash_wgmma_kernel",
                                    "flash_ffma_kernel"))
    ours = any(k in name for k in ("mm_f32_kernel", "mm_bf16_kernel", "mm_wgmma_kernel",
                                   "mm_ffma_kernel"))
    grouped = "kernel<true" in name or "kernelilb1e" in name  # <GROUPED, ...>
    return ("flash_step" if flash and step else
            "flash_attention" if flash else
            "gmm" if ours and grouped else
            "matmul" if ours else
            "gemm" if any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet"))
            else "other")


def _traced_launches(prof: dict) -> dict[str, int]:
    """A ``_profile`` trace's launches of this port's kernels, named as
    ``ops.launch_counts`` names them."""
    c = prof["by_kind_count"]
    return {"flash_attention": c["flash_attention"], "flash_attention_step": c["flash_step"],
            "matmul": c["matmul"], "gmm": c["gmm"]}


def _bound(nbytes: int, nops: int, dtype) -> tuple[float, str]:
    """(least ms on this card, what bounds it): bytes over the memory rate
    against operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, want, tol: float, what: str, atol: float | None = None) -> float:
    """max |got - want|; raises where |got - want| > atol + tol * |want|
    (``atol`` defaults to ``tol``)."""
    atol = tol if atol is None else atol
    err = (got.float() - want.float()).abs()
    if not bool((err <= atol + tol * want.float().abs()).all()):
        raise AssertionError(f"{what}: max|kernel - plain| = {float(err.max()):.3e} "
                             f"beyond tol {tol} (atol {atol})")
    return float(err.max())


MM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # tests/test_kernels.py


def _mm_shapes(cfg, m: int = 4 * 512) -> dict[str, tuple[int, int, int]]:
    """(m, k, n) of every product of llama-7b's prefill graph at b=4, s=512."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    return {"qkvo_proj": (m, d, cfg.n_heads * cfg.head_dim), "up_gate": (m, d, f),
            "down": (m, f, d), "lm_head": (m, d, v)}


def _mm_inputs(m, k, n, dt, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").to(dt)
    w = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).to(dt)
    return x, w


def _matmul_parity(cfg, ops, ref) -> dict:
    """The matmul kernel against ``ref.matmul`` on the card."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((128, 128, 128), f32), ((256, 384, 128), f32), ((128, 256, 512), bf16),
             ((64, 64, 64), f32),                                # tests/test_kernels.py
             ((200, 300, 77), f32), ((200, 300, 77), bf16),      # ragged
             ((1, 5, 3), f32), ((130, 17, 129), bf16),           # (f32: the template)
             ((200, 300, 76), f32), ((130, 20, 132), f32)]       # ragged, f32 ffma
    cases += [(shape, dt) for shape in _mm_shapes(cfg).values() for dt in (f32, bf16)]
    from repro_torch.kernels import matmul as mm

    out, qproj_err = [], None
    for (m, k, n), dt in cases:
        x, w = _mm_inputs(m, k, n, dt)
        want_design = mm.design(x, w)
        got, design = _served_by(ops, "matmul", lambda: ops.matmul(x, w, impl="kernel"))
        assert design == want_design, (m, k, n, dt, design)
        err = _max_err(got, ref.matmul(x, w), MM_TOL[dt], f"matmul {(m, k, n)} {dt}")
        out.append({"shape": [m, k, n], "dtype": str(dt), "design": design,
                    "max_abs_err": err})
        log("mm-parity", f"{(m, k, n)} {dt} [{design}]: max|kernel - plain| = {err:.3e} ok")
        if (m, k, n) in _mm_shapes(cfg).values():  # the path's: f32 ffma, bf16 wgmma
            assert design == ("wgmma" if dt == bf16 else "ffma"), design
        if (m, k, n) == _mm_shapes(cfg)["qkvo_proj"] and dt == bf16:
            qproj_err = err
    # strided views: each major of x and w, and a w at column stride 2
    x32, w32 = _mm_inputs(328, 200, 264, f32, seed=1)
    views = {"x_col_major": lambda x, w: (x.t().contiguous().t(), w),
             "w_col_major": lambda x, w: (x, w.t().contiguous().t()),
             "both_col_major": lambda x, w: (x.t().contiguous().t(), w.t().contiguous().t()),
             "w_col_stride_2": lambda x, w: (x, torch.stack([w, -w], dim=2).flatten(1)[:, ::2])}
    for dt in (f32, bf16):
        x, w = x32.to(dt), w32.to(dt)
        for name, view in views.items():
            xv, wv = view(x, w)
            got, design = _served_by(ops, "matmul", lambda: ops.matmul(xv, wv, impl="kernel"))
            ruled = "wgmma" if dt == bf16 else "ffma"
            want_design = ruled if name != "w_col_stride_2" else "template"
            assert design == want_design, (name, dt, design)
            err = _max_err(got, ref.matmul(x, w), MM_TOL[dt], f"matmul {name} {dt}")
            out.append({"shape": [328, 200, 264], "dtype": str(dt), "view": name,
                        "design": design, "max_abs_err": err})
            log("mm-parity", f"{name} (328, 200, 264) {dt} [{design}]: max|kernel - plain| "
                             f"= {err:.3e} ok")
    assert {c["design"] for c in out} == {"wgmma", "ffma", "template"}
    f32_designs = {c["design"] for c in out if c["dtype"] == str(f32)}
    assert f32_designs == {"ffma", "template"}, f32_designs
    return {"cases": out, "qproj_bf16_max_abs_err": qproj_err,
            "qproj_f32_max_abs_err": next(c["max_abs_err"] for c in out if c["dtype"] == str(f32)
                                          and c["shape"] == list(_mm_shapes(cfg)["qkvo_proj"]))}


STEP_CASES = [  # (b, hq, hkv, s, d, causal, window, dtype)
    (2, 4, 4, 64, 32, True, 0, torch.float32),
    (2, 4, 2, 64, 32, True, 0, torch.float32),     # GQA
    (1, 4, 1, 96, 64, True, 24, torch.float32),    # window, MQA
    (1, 4, 2, 64, 16, False, 0, torch.float32),
    (2, 4, 2, 128, 64, True, 0, torch.bfloat16),
    (1, 8, 2, 200, 128, True, 40, torch.bfloat16),  # blocks that divide no tile
    (2, 4, 2, 128, 64, True, 0, torch.float32),
    (1, 8, 2, 200, 128, True, 40, torch.float32),   # blocks that divide no tile
    (1, 4, 4, 512, 128, False, 0, torch.float32),   # no mask, several tiles a block
]
STEP_SERVING = (4, 32, 32, 512, 128, True, 0, torch.bfloat16)  # r = 4: blocks of 128
STEP_SERVING_F32 = STEP_SERVING[:-1] + (torch.float32,)  # the f32 ring's blocks


def _step_parity(ops, ref) -> dict:
    """The ring as each rank runs it: q block i at i*blk, the kv blocks in
    ring order (i, i-1, ...), fully masked blocks included.  Every carry
    against the plain step; the finalised chain against the forward
    kernel over the whole kv."""
    out, serving_err = [], {}
    for case, r in ([(c, r) for c in STEP_CASES for r in (2, 4)]
                    + [(STEP_SERVING, 4), (STEP_SERVING_F32, 4)]):
        b, hq, hkv, s, d, causal, window, dt = case
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = (torch.randn(sh, generator=g, device="cuda").to(dt)
                   for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        blk, tol, worst = s // r, TOL[dt], 0.0
        kw = dict(causal=causal, window=window)
        for i in range(r):
            qi = q[:, :, i * blk:(i + 1) * blk]
            carry = plain = None
            for t in range(r):
                j = (i - t) % r
                kj, vj = k[:, :, j * blk:(j + 1) * blk], v[:, :, j * blk:(j + 1) * blk]
                off = dict(q_offset=i * blk, kv_offset=j * blk, **kw)
                carry, design = _served_by(ops, "flash_attention_step",
                                           lambda: ops.flash_attention_step(
                                               qi, kj, vj, carry, impl="kernel", **off))
                # head dim 64 / 128 (blocks the rule addresses): bf16 wgmma, f32 ffma
                assert design == _expected_flash_design((0,) * 5 + (d, dt), step=True), design
                plain = ref.attention_step(qi, kj, vj, plain, **off)
                for part, got, want in zip("mla", carry, plain):
                    worst = max(worst, _max_err(got, want, tol,
                                                f"step {case} r={r} i={i} t={t} {part}"))
            fin = ops.attention_finalize(carry, dt)
            fwd = ops.flash_attention(qi, k, v, q_offset=i * blk, impl="kernel", **kw)
            worst = max(worst, _max_err(fin, fwd, tol, f"step chain {case} r={r} i={i}"))
        out.append({"case": str(case), "r": r, "design": design, "max_abs_err": worst})
        log("step-parity", f"{case} r={r} [{design}]: max|kernel - plain| = {worst:.3e} "
                           f"(tol {tol}) ok")
        if case in (STEP_SERVING, STEP_SERVING_F32):
            serving_err[str(dt).split(".")[1]] = worst
    assert {c["design"] for c in out} == {"wgmma", "ffma", "template"}
    return {"cases": out, "serving_bf16_max_abs_err": serving_err["bfloat16"],
            "serving_f32_max_abs_err": serving_err["float32"]}


def _matmul_timing(cfg, ops, ref) -> dict:
    """The kernel, the template design at the same inputs (its C entry),
    its plain version and ``torch.matmul`` (TF32 off) at every distinct
    product shape of llama-7b's prefill graph (m = 2048), in float32 (the
    ffma design) and in bf16 (the wgmma design); fewer iterations for the
    larger products.  ``res["float32"]`` and ``res["bfloat16"]`` are the
    q_proj shape (2048 x 4096 x 4096)."""
    from repro_torch.kernels import matmul as mm

    res = {"float32_shapes": {}, "bfloat16_shapes": {}}
    for dt in (torch.float32, torch.bfloat16):
        for name, (m, k, n) in _mm_shapes(cfg).items():
            x, w = _mm_inputs(m, k, n, dt, seed=3)
            item = x.element_size()
            nbytes, nops = (m * k + k * n + m * n) * item, 2 * m * k * n
            bound_ms, bound_by = _bound(nbytes, nops, dt)
            scale = max(1, round(nops / 68.7e9))  # fewer iterations for the larger products
            iters = (10 if dt == torch.float32 else 50) // scale or 1
            design = mm.design(x, w)
            assert design == ("wgmma" if dt == torch.bfloat16 else "ffma"), design
            template, _ = _mm_template(mm, x, w)
            t_kernel = _time_ms(lambda: ops.matmul(x, w, impl="kernel"), iters)
            t_template = _time_ms(template, max(1, 5 // scale), warmup=1)
            t_plain = _time_ms(lambda: ref.matmul(x, w), max(1, 10 // scale))
            t_lib = _time_ms(lambda: torch.matmul(x, w), iters)
            host = _op_host_us(lambda: ops.matmul(x, w, impl="kernel"),
                               lambda: mm.launch(x, w))
            row = {"shape": [m, k, n], "design": design, "kernel_ms": t_kernel, "host": host,
                   "template_ms": t_template, "plain_ms": t_plain, "library_ms": t_lib,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": nops,
                   "kernel_tflops": nops / t_kernel / 1e9,
                   "library_tflops": nops / t_lib / 1e9}
            log("timing", f"matmul {name} {(m, k, n)} {dt}: kernel ({design}) {t_kernel:.4f} ms "
                          f"({nops / t_kernel / 1e9:.1f} TFLOP/s), template {t_template:.4f} ms "
                          f"({t_template / t_kernel:.2f}x), plain {t_plain:.4f} ms, "
                          f"torch.matmul {t_lib:.4f} ms ({t_kernel / t_lib:.2f}x of it), "
                          f"bound {bound_ms:.4f} ms ({bound_by}); one call's host time "
                          f"through its operator {host['op_us']:.1f} us, directly "
                          f"{host['direct_us']:.1f} us")
            res[f"{str(dt).split('.')[1]}_shapes"][name] = row
            del x, w
    res["float32"] = res["float32_shapes"]["qkvo_proj"]
    res["bfloat16"] = res["bfloat16_shapes"]["qkvo_proj"]
    torch.cuda.empty_cache()
    return res


def _device_ms(fn, iters: int, match: str | None) -> float:
    """Device time of one launch: ``fn`` (one kernel launch whose name
    holds ``match``) run ``iters`` times under torch.profiler, the matching
    kernels' device time averaged.  For kernels short enough that the
    host's launch path, not the card, would set an events time.  With
    ``match=None``, the device time of every kernel ``fn`` launches, per
    call (a library call or a composite of several kernels).  A trace
    started late in a process can lose its first device events, so
    ``_fill_trace_start`` fills that window first, and only the kernels
    after it are read."""
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            fn()

    times = [e.ms for e in _traced_after_spin(body, match)
             if match is None or match in e.name]
    if match is None:
        return sum(times) / iters
    # the trace may drop an event at its edge; never more than one a call
    assert 0 < len(times) <= iters, (match, len(times), iters)
    return sum(times) / len(times)


def _fill_trace_start() -> None:
    """What a trace started late in a process may lose first: a spin kernel
    of about 0.2 s (at the H100's ~1.8 GHz) and 8192 short ones; then a
    spin whose end marks where the read events start."""
    torch.cuda._sleep(360_000_000)
    for _ in range(8192):
        torch.cuda._sleep(64)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 16)
    torch.cuda.synchronize()


class _Kernel(NamedTuple):
    """One device event of a trace: its name, start and end (ns)."""
    name: str
    start: int
    end: int

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6


def _device_kernels(prof) -> list:
    """The device events of a finished torch.profiler trace, in time order,
    read from its raw kineto events: ``prof.events()`` builds the
    profiler's Python event tree first, which for a trace of 10^5 launches
    (xlstm's prefill) takes tens of seconds."""
    from torch.autograd import DeviceType

    return sorted((_Kernel(e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and not getattr(e, "is_hidden_event", lambda: False)()),
                  key=lambda e: e.start)


def _traced_after_spin(body, match: str | None = None) -> list:
    """``body`` run under torch.profiler after ``_fill_trace_start``: the
    device kernels that start after its last spin kernel, in time order.
    A trace has come back without its last events, and without the spin
    kernel: one that holds no kernel after the spin (none whose name holds
    ``match``, if given) is taken again, at most twice more."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _fill_trace_start()
            body()
            torch.cuda.synchronize()
        device = _device_kernels(prof)
        marks = [e for e in device if "spin_kernel" in e.name]
        after = [e for e in device if marks and e.start >= marks[-1].end]
        if any(match is None or match in e.name for e in after):
            return after
        log("trace", f"trace {attempt + 1} holds {len(marks)} spin kernels and "
                     f"{len(after)} kernels after them ({match}); tracing again")
    raise AssertionError(f"three traces without a kernel after the spin ({match})")


def _attention_backward_ms(ref, q, k, v, kw) -> float:
    """Device time of the flash kernel's backward at (q, k, v): the plain
    version recomputed from the saved inputs and pulled back
    (``ref.vjp``, what ``FlashAttention.backward`` runs)."""
    do = torch.randn_like(q)
    return _device_ms(lambda: ref.vjp(lambda q, k, v: ref.attention(q, k, v, **kw),
                                      (q, k, v), (True, True, True), do), 5, None)


def _step_timing(ops, ref, dt=torch.bfloat16) -> dict:
    """One ring step at the serving shape cut 4 ways: q, k, v (4, 32, 128,
    128) in ``dt`` and the f32 carry, which the kernel updates in place.
    The kernel (bf16: the wgmma design; float32: the ffma design, the f32
    ring's) and the template design at the same inputs (its C entry, on a
    copy of the carry) by their device time (torch.profiler): a launch
    through the Python wrapper costs more host time than the kernel's
    device time, so CUDA events around wrapper calls time the host; that
    time is reported too.  No tile is skipped, so every (q, k) pair is
    computed; no single PyTorch call computes one step, so there is no
    library time."""
    from repro_torch.kernels import flash_attention as fa

    b, h, blk, d = 4, 32, 128, 128
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(b, h, blk, d, generator=g, device="cuda").to(dt)
               for _ in range(3))
    off = dict(q_offset=3 * blk, kv_offset=blk)
    carry = ops.flash_attention_step(q, k, v, None, impl="kernel", **off)
    design = fa.design(q, k, v, step=True)
    assert design == ("wgmma" if dt == torch.bfloat16 else "ffma"), design
    plain_carry = tuple(t.clone() for t in carry)
    t_carry = tuple(t.clone() for t in carry)
    lib = fa._lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in t_carry), 0,
            fa._DTYPES[q.dtype], b, h, h, blk, blk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], d ** -0.5, 1, 0, off["q_offset"], off["kv_offset"],
            torch.cuda.current_stream().cuda_stream)

    def template():
        err = lib.flash_attention_step(*args)
        if err:
            raise RuntimeError(f"template flash_attention_step: cudaError {err}")
    want = ref.attention_step(q, k, v, plain_carry, **off)
    template()
    for part, got, w in zip("mla", t_carry, want):
        _max_err(got, w, TOL[dt], f"template step {dt} {part}")
    step = lambda: ops.flash_attention_step(q, k, v, carry, impl="kernel", **off)  # noqa: E731
    t_kernel = _device_ms(step, 50, FLASH_DEVICE_KERNEL[design])
    t_template = _device_ms(template, 20, "flash_fwd_kernel")
    t_wrapper = _time_ms(step, 100)
    t_plain = _time_ms(lambda: ref.attention_step(q, k, v, plain_carry, **off), 20)
    nbytes = 3 * q.numel() * q.element_size() + 2 * (2 * b * h * blk + b * h * blk * d) * 4
    nops = 4 * b * h * blk * blk * d
    bound_ms, bound_by = _bound(nbytes, nops, dt)
    log("timing", f"flash_attention_step {(b, h, blk, d)} {dt}: kernel ({design}) "
                  f"{t_kernel:.4f} ms device time, template {t_template:.4f} ms "
                  f"({t_template / t_kernel:.1f}x), one wrapper call {t_wrapper:.4f} ms "
                  f"(host-bound), plain {t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{nbytes} B, {nops} ops); library: none")
    return {"shape": [b, h, blk, d], "dtype": str(dt), "design": design, "kernel_ms": t_kernel,
            "template_ms": t_template, "wrapper_ms": t_wrapper, "plain_ms": t_plain,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": nops}


def _graph_feeds(g, cfg, dtype, seed: int, device="cuda") -> dict:
    """Seeded feeds for a model's prefill graph, made on the card: token
    ids, and weights scaled by their fan-in (the embedding table at 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fan_in = {"embed": 1, "w2": cfg.shared_expert_ff or cfg.d_ff, "we2": cfg.d_ff}
    feeds = {}
    for n in g.nodes:
        if n.kind != "input":
            continue
        if str(np.dtype(n.dtype)) == "int32":
            feeds[n.name] = torch.randint(0, cfg.vocab, n.shape, generator=gen,
                                          device=device, dtype=torch.int32)
        else:
            scale = fan_in.get(n.name, cfg.d_model) ** -0.5
            feeds[n.name] = (torch.randn(n.shape, generator=gen, device=device)
                             * scale).to(dtype)
    return feeds


def _executor_path(cfg, ops) -> dict:
    """llama-7b's prefill graph through ``executor="shard_map"`` on a 1x1
    mesh on the card, in float32 and bf16, against the dense run."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    n_mm = sum(1 for n in g.nodes if n.kind == "einsum" and spmd._as_matmul(n.spec))
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        cold = PlanCache.open(store)
        t0 = time.perf_counter()
        prog.compile(mesh=mesh, executor="shard_map", cache=cold)
        t_cold = time.perf_counter() - t0
        warm = PlanCache.open(store)
        t0 = time.perf_counter()
        run = prog.compile(mesh=mesh, executor="shard_map", cache=warm)
        t_warm = time.perf_counter() - t0
    assert cold.stats["misses"] == 1 and warm.stats["hits"] == 1, (cold.stats, warm.stats)
    dense = prog.compile(mesh_axes=dict(mesh.sizes), device="cuda")
    log("executor", f"llama-7b prefill graph: {len(g.nodes)} nodes, {n_mm} clean "
                    f"contractions; planned cold {t_cold:.4f} s, hit {t_warm:.4f} s; "
                    f"schedule: {run.collectives.summary()}")
    res = {"nodes": len(g.nodes), "n_matmul_nodes": n_mm, "t_plan_cold_s": t_cold,
           "t_plan_hit_s": t_warm}
    # both runs round every product to bf16 after an f32 sum; they may sum
    # in other orders, so allow a few bf16 ulps (2^-8 ≈ 3.9e-3 of the
    # scale) of the largest logit; float32 differs only in its sum order
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    for dt in (torch.float32, torch.bfloat16):
        feeds = _graph_feeds(g, cfg, dt, seed=7)
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            designs = ops.design_counts()
            want = dense(feeds)["logits"]
            torch.cuda.synchronize()
            # the yardstick's products are torch.einsum (cuBLAS), not the kernel
            assert ops.launch_counts()["matmul"] == n_mm, ops.launch_counts()
            prof = _profile(lambda: run(feeds))
        assert launches == {"flash_attention": 1, "flash_attention_step": 0,
                            "matmul": n_mm, "gmm": 0}, launches
        # bf16: every launch of the wgmma design; float32: of the ffma design
        served = dict.fromkeys(("flash_attention", "matmul"),
                               "wgmma" if dt == torch.bfloat16 else "ffma")
        for kernel, design in served.items():
            assert designs[kernel][design] == launches[kernel], designs
        assert got.shape == (4, 512, cfg.vocab_padded) and got.dtype == dt
        assert bool(torch.isfinite(got).all()), "non-finite logits"
        scale = float(want.float().abs().max())
        diff = float((got.float() - want.float()).abs().max())
        if not diff <= tol[dt] * scale:
            raise AssertionError(f"executor {dt}: max|shard_map - dense| = {diff:.3e} "
                                 f"> {tol[dt]} x max|logit| {scale:.3f}")
        name = str(dt).split(".")[1]
        log("executor", f"{name}: launches {launches} by design {designs}; "
                        f"max|shard_map - gspmd| = {diff:.3e} "
                        f"(max|logit| {scale:.3f}, tol {tol[dt]} x that); wall "
                        f"{1e3 * wall:.3f} ms; profiled wall {prof['wall_ms']:.3f} ms, "
                        f"device busy {prof['device_ms']:.3f} ms (idle share "
                        f"{prof['idle_share']:.3f}); device ms by kind {prof['by_kind_ms']}; "
                        f"top {prof['top_kernels_ms'][:4]}")
        res[name] = {"launches": launches, "designs": designs, "max_abs_logit_diff": diff,
                     "max_abs_logit": scale, "tol_rel": tol[dt], "wall_ms": 1e3 * wall,
                     "profile": prof}
        del feeds, got, want
        torch.cuda.empty_cache()
    return res


RING_RANKS = 4


def _sequence_parallel_plan(g, axis: str, r: int):
    """A mesh-mode plan that shards every ``s`` label on ``axis``: no
    product moves anything, and attention rides the ring."""
    from repro_torch.core.decomp import Plan

    plan = Plan(p=r, mode="mesh")
    for n in g.nodes:
        labels = n.spec.all_labels if n.kind == "einsum" else n.labels
        plan.d_by_node[n.nid] = {l: (r if l == "s" else 1) for l in labels}
        plan.axes_by_node[n.nid] = {"s": (axis,)} if "s" in labels else {}
    return plan


RING_DTYPES = ("float32", "bfloat16")
# the ring's logits against the dense run, relative to max|logit|: float32
# differs only in the order of its sums; bf16 as the executor path's bf16
RING_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def ring_rank(rank: int, world: int) -> dict:
    """One gloo rank of the ring path (run by ``launch.mesh.spawn``): the
    plan compiled once, then run in each of ``RING_DTYPES``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    mesh = Mesh({"seq": world}, device="cuda:0")
    run = prog.compile(mesh=mesh, executor="shard_map",
                       plan=_sequence_parallel_plan(prog.graph, "seq", world))
    res = {}
    for name in RING_DTYPES:
        feeds = _graph_feeds(prog.graph, cfg, getattr(torch, name), seed=7)
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out = {"launches": ops.launch_counts(), "designs": ops.design_counts(),
                   "wall_s": wall, "issued": sorted({e[1] for e in run._fn.issued}),
                   "schedule": run.collectives.summary()}
            if rank == 0:  # against the dense run of the same feeds on the card
                want = prog.compile(device="cuda:0")(feeds)["logits"].float()
                out["max_abs_logit"] = float(want.abs().max())
                out["max_abs_logit_diff"] = float((got.float() - want).abs().max())
                out["finite"] = bool(torch.isfinite(got).all())
        res[name] = out
        del feeds, got
        torch.cuda.empty_cache()
    return res


def ring_a2a_rank(rank: int, world: int) -> dict:
    """One gloo rank of phases 11 and 16, one spawn for both (for the run's
    time limit): the ring path, then the a2a path."""
    return {"ring": ring_rank(rank, world), "a2a": a2a_rank(rank, world)}


def _ring_path() -> tuple[dict, tuple]:
    """Phase 11, and phase 16's ranks: ``(ring results, (a2a ranks, the
    spawn's wall))``; ``_a2a_path`` checks the a2a ranks."""
    from repro_torch.launch.mesh import spawn

    assert RING_RANKS == A2A_RANKS
    torch.cuda.empty_cache()  # the ranks share this card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        both = spawn(RING_RANKS, ring_a2a_rank, tmpdir=tmp, backend="gloo", timeout=600)
        t_spawn = time.perf_counter() - t0
    ranks = [r["ring"] for r in both]
    res = {"ranks": RING_RANKS, "spawn_s": t_spawn}
    for name in RING_DTYPES:
        per_rank = [r[name] for r in ranks]
        r0 = per_rank[0]
        total = {k: sum(r["launches"][k] for r in per_rank) for k in r0["launches"]}
        for r in per_rank:
            assert r["launches"] == {"flash_attention": 0, "flash_attention_step": RING_RANKS,
                                     "matmul": 8, "gmm": 0}, r["launches"]
            dz = r["designs"]
            if name == "float32":  # every product and every step ffma
                assert dz["matmul"]["ffma"] == 8, dz
                assert dz["flash_attention_step"]["ffma"] == RING_RANKS, dz
            else:  # every step of the wgmma design
                assert dz["flash_attention_step"]["wgmma"] == RING_RANKS, dz
        scale, diff = r0["max_abs_logit"], r0["max_abs_logit_diff"]
        assert r0["finite"], f"non-finite logits on the {name} ring path"
        if not diff <= RING_TOL[name] * scale:
            raise AssertionError(f"ring path {name}: max|ring - dense| = {diff:.3e} > "
                                 f"{RING_TOL[name]} x max|logit| {scale:.3f}")
        log("ring", f"{RING_RANKS} gloo ranks on one card, sequence-parallel llama-7b "
                    f"prefill {name}: launches per rank {r0['launches']} by design "
                    f"{r0['designs']}; collectives issued {r0['issued']}; max|ring - dense| = "
                    f"{diff:.3e} (max|logit| {scale:.3f}, tol {RING_TOL[name]} x that); rank "
                    f"walls {[round(r['wall_s'], 3) for r in per_rank]} s (host-staged gloo, "
                    f"not a speed path)")
        res[name] = {"launches_per_rank": [r["launches"] for r in per_rank],
                     "designs_per_rank": [r["designs"] for r in per_rank],
                     "launches_total": total, "max_abs_logit_diff": diff,
                     "max_abs_logit": scale, "tol_rel": RING_TOL[name],
                     "wall_s": [r["wall_s"] for r in per_rank], "issued": r0["issued"]}
    log("ring", f"both dtypes, all ranks (the ring's and phase 16's a2a work) in "
                f"{t_spawn:.1f} s; schedule: {ranks[0]['float32']['schedule']}")
    return res, ([r["a2a"] for r in both], t_spawn)


def _gmm_shapes(qcfg, mcfg) -> dict[str, tuple[int, int, int, int]]:
    """(e, c, k, n) of the expert products on the MoE path: qwen2-moe's w1
    and w2 at b=4, s=512 (T = 2048 tokens) and in a decode step (T = 4),
    and mixtral's w1 and w2 at b=4, s=512 and its w1 in a decode step (the
    shapes of phase 36's mixtral serve, 8 of its 32 layers).  c is the
    dispatch capacity of ``models/moe.py``."""
    from repro_torch.models.moe import _capacity

    e, d, f = qcfg.n_e, qcfg.d_model, qcfg.d_ff
    cp, cd = _capacity(2048, qcfg), _capacity(4, qcfg)
    me, md, mf = mcfg.n_e, mcfg.d_model, mcfg.d_ff
    mp, mdec = _capacity(2048, mcfg), _capacity(4, mcfg)
    return {"w1_prefill": (e, cp, d, f), "w2_prefill": (e, cp, f, d),
            "w1_decode": (e, cd, d, f), "w2_decode": (e, cd, f, d),
            "mixtral_w1": (me, mp, md, mf), "mixtral_w2": (me, mp, mf, md),
            "mixtral_w1_decode": (me, mdec, md, mf)}


def _gmm_inputs(e, c, k, n, dt, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(e, c, k, generator=g, device="cuda").to(dt)
    w = (torch.randn(e, k, n, generator=g, device="cuda") * k ** -0.5).to(dt)
    return x, w


def _gmm_parity(qcfg, mcfg, ops, ref) -> dict:
    """The gmm kernel against ``ref.gmm`` on the card, float32 (1e-4) and
    bf16 (3e-2), atol x8 (tests/test_kernels.py)."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(4, 128, 256, 128), (8, 128, 128, 384), (2, 256, 128, 128),  # reference
              (3, 200, 77, 130), (2, 1, 5, 3)]                          # ragged
    path = _gmm_shapes(qcfg, mcfg)
    shapes += list(path.values())
    from repro_torch.kernels import matmul as mm

    out, q_err = [], None
    for shape in shapes:
        for dt in (f32, bf16):
            x, w = _gmm_inputs(*shape, dt)
            want_design = mm.design(x, w)
            got, design = _served_by(ops, "gmm", lambda: ops.gmm(x, w, impl="kernel"))
            assert design == want_design, (shape, dt, design)
            if shape in path.values():  # the path's: f32 ffma, bf16 wgmma
                assert design == ("wgmma" if dt == bf16 else "ffma"), design
            err = _max_err(got, ref.gmm(x, w), MM_TOL[dt], f"gmm {shape} {dt}",
                           atol=8 * MM_TOL[dt])
            out.append({"shape": list(shape), "dtype": str(dt), "design": design,
                        "max_abs_err": err})
            log("gmm-parity", f"{shape} {dt} [{design}]: max|kernel - plain| = {err:.3e} ok")
            if shape == path["w1_prefill"] and dt == bf16:
                q_err = err
    # a weight view out of a stacked (e, units, k, n) tensor (expert stride
    # 2*k*n) and a transposed x (strides (k*c, 1, c)): at c = 150 the x
    # rows are 300 (bf16) or 600 (f32) bytes, which the rule cannot step
    # (the template serves it); at c = 152, 304 or 608 bytes (the wgmma or
    # ffma design reads x M-major)
    for (e, c, k, n), dt in [((5, 150, 96, 70), f32), ((5, 150, 96, 70), bf16),
                             ((5, 152, 96, 72), bf16), ((5, 152, 96, 72), f32)]:
        x, w = _gmm_inputs(e, c, k, n, dt, seed=1)
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        stacked = torch.stack([-w, w], dim=1)
        got, design = _served_by(ops, "gmm", lambda: ops.gmm(xt, stacked[:, 1], impl="kernel"))
        ruled = "wgmma" if dt == bf16 else "ffma"
        assert design == (ruled if c == 152 else "template"), design
        err = _max_err(got, ref.gmm(x, w), MM_TOL[dt], f"gmm strided {dt}",
                       atol=8 * MM_TOL[dt])
        out.append({"shape": [e, c, k, n], "dtype": str(dt), "strided": True,
                    "design": design, "max_abs_err": err})
        log("gmm-parity", f"strided {(e, c, k, n)} {dt} [{design}]: max|kernel - plain| = "
                          f"{err:.3e} ok")
    assert {c["design"] for c in out} == {"wgmma", "ffma", "template"}
    return {"cases": out, "qwen2_prefill_bf16_max_abs_err": q_err}


def _gmm_timing(qcfg, mcfg, ops, ref) -> dict:
    """bf16 at the path's shapes (the wgmma design) and float32 at
    qwen2-moe's w1 (the ffma design, the f32 slice parity's product): the
    kernel, the template design at the same inputs, its plain version, one
    ``torch.bmm`` (TF32 off) and the bound (each input read once, the
    output written once, against 2*e*c*k*n operations)."""
    from repro_torch.kernels import matmul as mm

    res = {}
    shapes = [(name, shape, torch.bfloat16) for name, shape in _gmm_shapes(qcfg, mcfg).items()
              if name != "w2_decode"]  # the same bytes as w1_decode
    shapes.append(("w1_prefill_f32", _gmm_shapes(qcfg, mcfg)["w1_prefill"], torch.float32))
    for name, (e, c, k, n), dt in shapes:
        x, w = _gmm_inputs(e, c, k, n, dt, seed=5)
        item = x.element_size()
        nbytes, nops = (e * c * k + e * k * n + e * c * n) * item, 2 * e * c * k * n
        bound_ms, bound_by = _bound(nbytes, nops, dt)
        slow = name.startswith("mixtral") or dt == torch.float32
        iters = 10 if slow else 50
        design = mm.design(x, w)
        assert design == ("wgmma" if dt == torch.bfloat16 else "ffma"), design
        template, _ = _mm_template(mm, x, w)
        t_kernel = _time_ms(lambda: ops.gmm(x, w, impl="kernel"), iters)
        t_template = _time_ms(template, 3 if slow else 10)
        t_plain = _time_ms(lambda: ref.gmm(x, w), 5)
        t_lib = _time_ms(lambda: torch.bmm(x, w), iters)
        res[name] = {"shape": [e, c, k, n], "dtype": str(dt), "design": design,
                     "kernel_ms": t_kernel, "template_ms": t_template, "plain_ms": t_plain,
                     "library_ms": t_lib, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "ops": nops,
                     "kernel_tflops": nops / t_kernel / 1e9}
        log("timing", f"gmm {name} {(e, c, k, n)} {dt}: kernel ({design}) {t_kernel:.4f} ms "
                      f"({nops / t_kernel / 1e9:.1f} TFLOP/s), template {t_template:.4f} ms "
                      f"({t_template / t_kernel:.1f}x), plain {t_plain:.4f} ms, "
                      f"torch.bmm {t_lib:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                      f"{nbytes} B, {nops} ops)")
        del x, w
    torch.cuda.empty_cache()
    return res


A2A_RANKS = 4


def _expert_parallel_plan(g, axis: str, r: int):
    """A mesh-mode plan that shards the expert label ``e`` on ``axis`` in
    the expert half of the MoE layer (dispatch, the expert products,
    combine); every other node is replicated."""
    from repro_torch.core.decomp import Plan

    plan = Plan(p=r, mode="mesh")
    for n in g.nodes:
        labels = n.spec.all_labels if n.kind == "einsum" else n.labels
        ep = n.kind != "input" and (
            n.op == "moe_combine" or ("e" in labels and "c" in labels))
        plan.d_by_node[n.nid] = {l: (r if ep and l == "e" else 1) for l in labels}
        plan.axes_by_node[n.nid] = {"e": (axis,)} if ep else {}
    return plan


def a2a_rank(rank: int, world: int) -> dict:
    """One gloo rank of the a2a path (run by ``launch.mesh.spawn``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.opaque_stubs import capacity_of, make_stub_opaques

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-moe-a2.7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    make_stub_opaques(capacity_of(g))
    mesh = Mesh({"ep": world}, device="cuda:0")
    run = prog.compile(mesh=mesh, executor="shard_map",
                       plan=_expert_parallel_plan(g, "ep", world))
    feeds = _graph_feeds(g, cfg, torch.float32, seed=8)
    with torch.inference_mode():
        run(feeds)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = run(feeds)["logits"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        designs = ops.design_counts()
        trace = run._fn.schedule.trace
        issued = sorted(run._fn.issued)
        static = sorted((e.nid, e.kind, e.axes, e.elems) for e in trace.events)
        out = {"launches": launches, "designs": designs, "wall_s": wall, "issued": issued,
               "n_matmul_nodes": sum(1 for n in g.nodes if n.kind == "einsum"
                                     and spmd._as_matmul(n.spec)),
               "issued_equals_static": issued == static,
               "rules": sorted(set(trace.rule_by_node.values())),
               "a2a_bytes": {k: v["bytes"] for k, v in trace.by_rule()["a2a"].items()},
               "schedule": run.collectives.summary()}
        if rank == 0:  # against the dense run of the same feeds on the card
            want = prog.compile(device="cuda:0")(feeds)["logits"]
            out["max_abs_logit"] = float(want.abs().max())
            out["max_abs_logit_diff"] = float((got - want).abs().max())
            out["finite"] = bool(torch.isfinite(got).all())
    return out


def _a2a_path(ranks: list, t_spawn: float) -> dict:
    """Phase 16's checks of its ranks, run in phase 11's spawn
    (``ring_a2a_rank``; ``t_spawn`` is that spawn's wall)."""
    r0 = ranks[0]
    for r in ranks:
        assert r["issued_equals_static"], "issued collectives differ from the static trace"
        assert "a2a" in r["rules"], r["rules"]
        assert r["launches"] == {"flash_attention": 1, "flash_attention_step": 0,
                                 "matmul": r["n_matmul_nodes"], "gmm": 0}, r["launches"]
        a2a_kinds = [e[1] for e in r["issued"] if e[1] == "all_to_all"]
        assert len(a2a_kinds) >= 4, r["issued"]  # slots + payload, dispatch + combine
        assert r["a2a_bytes"]["all_gather"] < r["a2a_bytes"]["all_to_all"]
    scale, diff = r0["max_abs_logit"], r0["max_abs_logit_diff"]
    assert r0["finite"], "non-finite logits on the a2a path"
    if not diff <= 1e-4 * scale:  # float32: the sums run in other orders
        raise AssertionError(f"a2a path: max|a2a - dense| = {diff:.3e} > 1e-4 x "
                             f"max|logit| {scale:.3f}")
    kinds = sorted({e[1] for e in r0["issued"]})
    log("a2a", f"{A2A_RANKS} gloo ranks on one card, qwen2-moe prefill graph, experts "
               f"on a {A2A_RANKS}-way axis, f32: rules {r0['rules']}; launches per rank "
               f"{r0['launches']} (matmul by design {r0['designs']['matmul']}); each rank "
               f"issued {len(r0['issued'])} collectives "
               f"({kinds}), equal to the static trace; a2a rule bytes {r0['a2a_bytes']}; "
               f"max|a2a - dense| = {diff:.3e} (max|logit| {scale:.3f}); rank walls "
               f"{[round(r['wall_s'], 3) for r in ranks]} s (host-staged gloo, not a "
               f"speed path); spawned with phase 11's ranks, {t_spawn:.1f} s for both")
    log("a2a", f"schedule: {r0['schedule']}")
    return {"ranks": A2A_RANKS, "launches_per_rank": [r["launches"] for r in ranks],
            "designs_per_rank": [r["designs"] for r in ranks],
            "issued_per_rank": [len(r["issued"]) for r in ranks],
            "issued_kinds": kinds, "a2a_bytes": r0["a2a_bytes"],
            "max_abs_logit_diff": diff, "max_abs_logit": scale,
            "wall_s": [r["wall_s"] for r in ranks], "spawn_s": t_spawn}


# ---------------------------------------------------------------------------
# 17-19. training: the model stack's train step, and the paper's FFNN
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-4  # float32, the card against the CPU: sums in other orders


def _train_parity(cfg, ops) -> dict:
    """``cfg`` at full width, 2 layers, float32, batch 1, seq 128: the same
    weights and batch on the card (the flash kernel inside its autograd
    Function) and on the CPU (the plain path).  The loss and every
    gradient of ``loss_fn``, then one ``make_train_step`` on each side."""
    from repro_torch.core import tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = tf.init_params(cfg2, seed=2, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg2.vocab, size=(1, 128)).astype(np.int32)
    res: dict = {}
    side: dict = {}
    for dev in ("cuda", "cpu"):
        params = tree.map(lambda t: t.to(dev, copy=True), cpu_params)
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(toks, device=dev)}
        leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
        ops.reset_launch_counts()
        loss, _ = tf.loss_fn(params, batch, cfg2)  # remat on: the reference's default
        grads = torch.autograd.grad(loss, leaves)
        grad_launches = ops.launch_counts()["flash_attention"]
        designs = ops.design_counts()["flash_attention"]
        for p in leaves:
            p.requires_grad_(False)
        step = steps.make_train_step(cfg2)
        ops.reset_launch_counts()
        _, _, met = step(params, adamw_init(params), batch)
        step_launches = ops.launch_counts()["flash_attention"]
        step_designs = ops.design_counts()["flash_attention"]
        side[dev] = {"loss": float(loss.detach()), "grads": [g.float().cpu() for g in grads],
                     "step_loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                     "launches": (grad_launches, step_launches),
                     "designs": {d: designs[d] + step_designs[d] for d in designs}}
        del params, grads, leaves, loss
        torch.cuda.empty_cache()
    gpu, cpu = side["cuda"], side["cpu"]
    # 2 layers x (forward + the remat recompute in the backward); none on the CPU
    assert gpu["launches"] == (4, 4) and cpu["launches"] == (0, 0), (gpu["launches"],
                                                                      cpu["launches"])
    assert gpu["designs"]["ffma"] == 8, gpu["designs"]  # float32 at head dim 128: ffma
    errs = {}
    for what in ("loss", "step_loss", "grad_norm"):
        err = abs(gpu[what] - cpu[what]) / abs(cpu[what])
        log("train-parity", f"{what}: card {gpu[what]:.7f}, CPU {cpu[what]:.7f}, "
                            f"relative error {err:.3e} (limit {TRAIN_TOL})")
        assert err <= TRAIN_TOL, (what, gpu[what], cpu[what])
        errs[what] = err
    leaf_errs = []
    for i, (g, c) in enumerate(zip(gpu["grads"], cpu["grads"])):
        scale = float(c.abs().max())
        err = float((g - c).abs().max())
        leaf_errs.append({"leaf": i, "shape": list(c.shape), "max_abs_err": err,
                          "max_abs_grad": scale, "limit": TRAIN_TOL * scale})
        assert err <= TRAIN_TOL * scale, leaf_errs[-1]
    worst = max(leaf_errs, key=lambda e: e["max_abs_err"] / max(e["max_abs_grad"], 1e-30))
    for e in leaf_errs:
        log("train-parity", f"grad leaf {e['leaf']} {tuple(e['shape'])}: max|card - CPU| "
                            f"{e['max_abs_err']:.3e} (limit {e['limit']:.3e} = "
                            f"{TRAIN_TOL} x max|g| {e['max_abs_grad']:.3e})")
    log("train-parity", f"{cfg.name} width, 2 layers, f32, b=1, s=128: flash launches "
                        f"(value-and-grad, train step) {gpu['launches']}, by design "
                        f"{gpu['designs']}; worst leaf {worst['leaf']} at "
                        f"{worst['max_abs_err'] / worst['max_abs_grad']:.3e} of its max|g|")
    res.update({"rel_err": errs, "grad_leaves": leaf_errs, "launches": gpu["launches"],
                "designs": gpu["designs"], "loss": gpu["loss"], "grad_norm": gpu["grad_norm"]})
    res["graph_against_eager"] = _train_graph_against_eager(cfg2, cpu_params, toks, ops)
    return res


def _max_dist(a: list, b: list) -> float:
    """max |a_i - b_i| over two lists of tensors (or floats) alike."""
    return max(float((torch.as_tensor(x).float() - torch.as_tensor(y).float()).abs().max())
               for x, y in zip(a, b))


def _train_graph_against_eager(cfg, cpu_params, toks, ops, n_steps: int = 3) -> dict:
    """Phase 17 (cont.): ``steps.make_train_step`` of ``cfg`` from
    ``cpu_params`` on the card, ``n_steps`` steps on ``toks`` (tokens and
    labels), through ``launch.train.compiled_train_step``: twice eagerly
    (``graph=False``) and once as a CUDA graph (its first step eager, the
    second captured, the rest replays).  The graph's losses and final
    parameters are held to the spread of the two eager runs (max|graph -
    eager| <= max|eager - eager again|: bit-equal where the eager runs
    are), and its launches by design (the replays' counted from the
    capture) to an eager run's."""
    from repro_torch.core import tree
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw_init

    batch = {k: torch.as_tensor(toks, device="cuda") for k in ("tokens", "labels")}
    runs = {}
    for name, graph in (("eager", False), ("eager_again", False), ("graph", True)):
        params = tree.map(lambda t: t.to("cuda", copy=True), cpu_params)
        step = train_mod.compiled_train_step(steps.make_train_step(cfg), params,
                                             adamw_init(params), batch, graph=graph)
        ops.reset_launch_counts()
        losses = [float(step()[0]) for _ in range(n_steps)]
        runs[name] = (losses, tree.leaves(params), ops.design_counts(), step.replays)
        del step, params
    (g_loss, g_par, g_designs, g_replays) = runs["graph"]
    (e_loss, e_par, e_designs, _), (a_loss, a_par, _, _) = runs["eager"], runs["eager_again"]
    out = {"steps": n_steps, "losses": {k: v[0] for k, v in runs.items()},
           "loss_spread": _max_dist(e_loss, a_loss), "loss_diff": _max_dist(g_loss, e_loss),
           "param_spread": _max_dist(e_par, a_par), "param_diff": _max_dist(g_par, e_par),
           "replays": g_replays, "designs": g_designs["flash_attention"]}
    del runs, g_par, e_par, a_par
    torch.cuda.empty_cache()
    assert g_replays == n_steps - 1, g_replays
    assert g_designs == e_designs, (g_designs, e_designs)
    assert out["loss_diff"] <= out["loss_spread"], out
    assert out["param_diff"] <= out["param_spread"], out
    log("train-parity", f"the compiled train step, {n_steps} steps as a CUDA graph ({g_replays} "
                        f"replays) against eager: losses {g_loss} / {e_loss}; max|graph - "
                        f"eager| {out['loss_diff']:.3e} (loss), {out['param_diff']:.3e} "
                        f"(parameters); two eager runs apart by {out['loss_spread']:.3e}, "
                        f"{out['param_spread']:.3e}; flash by design {out['designs']}")
    return out


TRAIN_LAYERS = 8  # of llama-7b's 32: all 32 with grads and f32 moments would fill the card
TRAIN_STEPS = 8
ATT_BWD_RANGE = "flash_attention.backward (plain)"
OPT_RANGE = "adamw_update"


def _train_phase(cfg, ops, fa) -> dict:
    """Train ``cfg`` at full width with ``TRAIN_LAYERS`` layers, bf16, batch
    4, seq 512 through ``launch.train.train`` (cosine schedule, a plan-cache
    file and a checkpoint directory under chiprun_out/), its step a CUDA
    graph (the first step eager, the second captured, the rest replays);
    restore the checkpoint; profile one more warmed step, eagerly and as a
    replay of the compiled step; then train twice more with
    ``graph=False``: the graphed run's losses and final parameters held
    to the two eager runs' spread, its peak memory beside theirs."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models.eingraphs import program_for
    from repro_torch.optim.schedules import cosine_schedule

    cfg8 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("chip_smoke", "train", 512, 4)
    out = ROOT / "chiprun_out"
    ckpt, store = out / "train_ckpt", out / "train_plans.json"
    shutil.rmtree(ckpt, ignore_errors=True)
    store.unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # before the run: what its peak is net of
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = train_mod.train(cfg8, shape, steps_total=TRAIN_STEPS, ckpt_dir=str(ckpt),
                          plan_cache=str(store), device="cuda", log_every=1)
    wall = time.perf_counter() - t0
    launches, designs = ops.launch_counts(), ops.design_counts()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    params, opt_state = run["params"], run["opt_state"]
    # the step replayed its graph from the second step on
    assert run["replays"] == TRAIN_STEPS - 1, run["replays"]
    assert int(opt_state.step) == TRAIN_STEPS, int(opt_state.step)
    n_params = sum(t.numel() for t in tree.leaves(params))
    per_step = launches["flash_attention"] / TRAIN_STEPS
    # every layer: its forward, and its recompute in the backward (remat)
    assert launches["flash_attention"] == 2 * TRAIN_LAYERS * TRAIN_STEPS, launches
    assert designs["flash_attention"]["wgmma"] == launches["flash_attention"], designs
    assert launches["matmul"] == launches["gmm"] == launches["flash_attention_step"] == 0
    losses = [st["loss"] for st in run["steps"]]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    assert all(np.isfinite([st["grad_norm"] for st in run["steps"]]))
    assert losses[-1] < losses[0], losses
    for st in run["steps"]:
        log("train", f"step {st['step']}: loss {st['loss']:.4f} (ce {st['ce']:.4f}), grad norm "
                     f"{st['grad_norm']:.4f}, lr {st['lr']:.3e}, wall {st['wall_s']:.4f} s")
    # train() planned through the store: the same cell now plans as a hit
    warm = PlanCache.open(str(store))
    program_for(cfg8, shape).compile(mesh_axes={"data": 1, "model": 1}, cache=warm)
    assert warm.stats["hits"] == 1 and warm.stats["misses"] == 0, warm.stats
    # the checkpoint train() wrote at its last step restores bit-equal
    t0 = time.perf_counter()
    restored = CheckpointManager(str(ckpt)).restore_latest((params, opt_state))
    t_restore = time.perf_counter() - t0
    step, (rp, rs), _ = restored
    assert step == TRAIN_STEPS, step
    n_leaves = 0
    for a, b in zip(tree.leaves((rp, rs)), tree.leaves((params, opt_state))):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        n_leaves += 1
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    del restored, rp, rs
    shutil.rmtree(ckpt, ignore_errors=True)  # 4 bytes a parameter, three times over
    torch.cuda.empty_cache()
    log("train", f"{cfg.name} width, {TRAIN_LAYERS} layers, bf16, b=4, s=512: {n_params} "
                 f"params; {TRAIN_STEPS} steps in {wall:.1f} s with the final checkpoint; "
                 f"max_memory_allocated {peak}; flash launches {launches['flash_attention']} "
                 f"({per_step:g} a step) by design {designs['flash_attention']}; checkpoint "
                 f"step {step}, {n_leaves} leaves, {ckpt_bytes} bytes on disk, restored "
                 f"bit-equal in {t_restore:.1f} s")
    graphed_params = [t.clone() for t in tree.leaves(params)]  # the profile trains on
    # where the time goes: one more step, warmed, timed, profiled; eagerly,
    # then as a replay of the compiled step
    lr_fn = lambda s: cosine_schedule(s, peak_lr=3e-4, warmup=1, total=TRAIN_STEPS)  # noqa: E731
    step_fn = steps.make_train_step(cfg8, lr_fn=lr_fn)
    hb = train_mod.SyntheticLM(cfg8.vocab, 512, 4, seed=0).global_batch_at(TRAIN_STEPS)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in hb.items()}
    backward, update = fa.FlashAttention.backward, steps.adamw_update

    def tagged(ctx, do):  # the plain backward's kernels, as one profiler range
        with torch.profiler.record_function(ATT_BWD_RANGE):
            return backward(ctx, do)

    def tagged_update(*args, **kw):  # the optimizer's (clip included), as another
        with torch.profiler.record_function(OPT_RANGE):
            return update(*args, **kw)

    fa.FlashAttention.backward = staticmethod(tagged)
    steps.adamw_update = tagged_update
    try:
        prof = _profile(lambda: step_fn(params, opt_state, batch),
                        ranges=(ATT_BWD_RANGE, OPT_RANGE))
    finally:
        fa.FlashAttention.backward = staticmethod(backward)
        steps.adamw_update = update
    graph_step = train_mod.compiled_train_step(step_fn, params, opt_state, batch, graph=True)
    graph_step()
    ops.reset_launch_counts()
    graph_step()  # the capture, then its first replay
    replay_launches = ops.launch_counts()
    prof_graph = _profile(graph_step)
    traced = _traced_launches(prof_graph)
    assert replay_launches == traced == _traced_launches(prof), (replay_launches, traced)
    assert replay_launches["flash_attention"] == 2 * TRAIN_LAYERS, replay_launches
    del graph_step
    bwd_ms, opt_ms = prof["range_ms"][ATT_BWD_RANGE], prof["range_ms"][OPT_RANGE]
    log("profile", f"{cfg.name} {TRAIN_LAYERS}-layer train step: wall {prof['wall_ms']:.3f} ms, "
                   f"device busy {prof['device_ms']:.3f} ms (idle share "
                   f"{prof['idle_share']:.3f}), {prof['kernels']} kernels; device ms by kind "
                   f"{prof['by_kind_ms']}; the plain attention backward {bwd_ms:.3f} ms "
                   f"({bwd_ms / prof['device_ms']:.3f} of device time); AdamW with its clip "
                   f"{opt_ms:.3f} ms ({opt_ms / prof['device_ms']:.3f}); top "
                   f"{prof['top_kernels_ms'][:4]}")
    log("profile", f"{cfg.name} {TRAIN_LAYERS}-layer train step as a CUDA graph replay: wall "
                   f"{prof_graph['wall_ms']:.3f} ms, device busy {prof_graph['device_ms']:.3f} "
                   f"ms (idle share {prof_graph['idle_share']:.3f}), {prof_graph['kernels']} "
                   f"kernels; device ms by kind {prof_graph['by_kind_ms']}; launches "
                   f"{replay_launches} (counted), {traced} (its trace)")
    res = {"layers": TRAIN_LAYERS, "n_params": n_params, "steps": run["steps"],
           "wall_s": wall, "max_memory_allocated": peak, "launches": launches,
           "designs": designs, "flash_launches_per_step": per_step,
           "checkpoint": {"step": step, "leaves": n_leaves, "bytes": ckpt_bytes,
                          "restore_s": t_restore, "bit_equal": True},
           "profile": prof, "attention_backward_ms": bwd_ms,
           "attention_backward_share": bwd_ms / prof["device_ms"],
           "optimizer_ms": opt_ms, "optimizer_share": opt_ms / prof["device_ms"],
           "profile_graph": prof_graph, "launches_per_replay": replay_launches,
           "traced_launches_per_replay": traced, "replays": run["replays"],
           "max_memory_reserved": reserved, "peak_over_held": peak - held}
    del params, opt_state, run, batch
    gc.collect()
    torch.cuda.empty_cache()
    # the same run twice more, eagerly: the graphed run within their spread
    eager = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        er = train_mod.train(cfg8, shape, steps_total=TRAIN_STEPS, plan_cache=str(store),
                             device="cuda", log_every=TRAIN_STEPS, graph=False)
        assert er["replays"] == 0
        eager.append({"losses": [st["loss"] for st in er["steps"]],
                      "walls": [st["wall_s"] for st in er["steps"]],
                      "params": tree.leaves(er["params"]),
                      "peak": torch.cuda.max_memory_allocated() - before,
                      "reserved": torch.cuda.max_memory_reserved()})
        del er
        gc.collect()
        torch.cuda.empty_cache()
    (e1, e2) = eager
    spread = {"loss": _max_dist(e1["losses"], e2["losses"]),
              "params": _max_dist(e1["params"], e2["params"])}
    diff = {"loss": _max_dist(losses, e1["losses"]),
            "params": _max_dist(graphed_params, e1["params"])}
    del graphed_params, e1["params"], e2["params"]
    torch.cuda.empty_cache()
    walls = [st["wall_s"] for st in res["steps"]]
    log("train", f"graphed against eager, {TRAIN_STEPS} steps: max|graph - eager| {diff} "
                 f"(losses, parameters), two eager runs apart by {spread}; step walls from "
                 f"the third step graphed {[round(w, 4) for w in walls[2:]]} s, eager "
                 f"{[round(w, 4) for w in e1['walls'][2:]]} s; peak memory over what was "
                 f"allocated before the run graphed {peak - held} B (reserved {reserved} B), "
                 f"eager {e1['peak']} / {e2['peak']} B (reserved {e1['reserved']} / "
                 f"{e2['reserved']} B)")
    assert diff["loss"] <= spread["loss"] and diff["params"] <= spread["params"], (diff, spread)
    res.update({"graph_against_eager": {"diff": diff, "spread": spread,
                                        "eager_losses": [e1["losses"], e2["losses"]],
                                        "eager_walls": [e1["walls"], e2["walls"]],
                                        "eager_peaks": [e1["peak"], e2["peak"]],
                                        "eager_reserved": [e1["reserved"], e2["reserved"]]}})
    res["memory_allocated_after"] = torch.cuda.memory_allocated()
    log("train", f"device memory left allocated after the phase: "
                 f"{res['memory_allocated_after']} bytes")
    return res


FFNN = {"batch": 512, "feats": 597_540, "hidden": 8_192, "labels": 14_588}  # AmazonCat-14K
FFNN_STEPS = 3
FFNN_LR = 2e-7
FFNN_TOL = 1e-4


def _ffnn_graph():
    """benchmarks/bench_ffnn.py's network and loss, built with the port's
    EinGraph: X@W1 -> relu -> @W2 -> - Y -> square -> sum."""
    from repro_torch.core.einsum import EinGraph
    from repro_torch.frontend import Program

    b, f, h, c = (FFNN[k] for k in ("batch", "feats", "hidden", "labels"))
    g = EinGraph("ffnn")
    X = g.input("X", "bf", (b, f))
    W1 = g.input("W1", "fh", (f, h))
    W2 = g.input("W2", "hc", (h, c))
    Y = g.input("Y", "bc", (b, c))
    a1 = g.map("relu", g.einsum("bf,fh->bh", X, W1))
    diff = g.einsum("bc,bc->bc", g.einsum("bh,hc->bc", a1, W2), Y, combine="sub", agg="")
    loss = g.einsum("bc->", g.map("square", diff), combine="id", agg="sum")
    return Program.from_graph(g, {"loss": loss})


def _ffnn_feeds(seed: int = 19) -> dict:
    """Seeded feeds on the card.  X is a binary bag of words (about 600 of
    597,540 features a row) and W1 holds multiples of 2^-10 in [-1/16,
    1/16): every sum in X @ W1 is then exact in float32, whatever its
    order, so the kernel and cuBLAS agree on the sign of every hidden unit.
    (The relu's derivative jumps at 0: one unit whose sign two summation
    orders disagree on would move a row of dW1 by far more than the
    tolerance.)  W2 is Gaussian at 1/sqrt(hidden); Y is multi-hot, about 5
    labels a row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, f, h, c = (FFNN[k] for k in ("batch", "feats", "hidden", "labels"))
    X = (torch.rand((b, f), generator=gen, device="cuda") < 1e-3).to(torch.float32)
    W1 = torch.rand((f, h), generator=gen, device="cuda")
    W1.mul_(128).floor_().sub_(64).mul_(2.0 ** -10)
    W2 = torch.randn((h, c), generator=gen, device="cuda").mul_(h ** -0.5)
    Y = (torch.rand((b, c), generator=gen, device="cuda") < 5 / c).to(torch.float32)
    return {"X": X, "W1": W1, "W2": W2, "Y": Y}


def _ffnn_plain_grads(feeds) -> tuple[float, torch.Tensor, torch.Tensor]:
    """(loss, dW1, dW2) of the plain FFNN through torch.autograd (cuBLAS,
    TF32 off)."""
    W1 = feeds["W1"].detach().requires_grad_()
    W2 = feeds["W2"].detach().requires_grad_()
    loss = torch.sum(torch.square(torch.relu(feeds["X"] @ W1) @ W2 - feeds["Y"]))
    g1, g2 = torch.autograd.grad(loss, [W1, W2])
    return float(loss.detach()), g1, g2


def _ffnn_phase(ops) -> dict:
    """The paper's Experiment 2 at AmazonCat-14K sizes on one card: the
    FFNN's gradient program through ``executor="shard_map"`` on the 1x1
    mesh (planned through a plan-cache file), 3 SGD steps."""
    from repro_torch.analysis import analyze_compiled
    from repro_torch.core import spmd
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch.mesh import Mesh

    prog = _ffnn_graph().grad(wrt=["W1", "W2"])
    g = prog.graph
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        cold = PlanCache.open(store)
        t0 = time.perf_counter()
        prog.compile(mesh=mesh, executor="shard_map", cache=cold)
        t_cold = time.perf_counter() - t0
        warm = PlanCache.open(store)
        t0 = time.perf_counter()
        run = prog.compile(mesh=mesh, executor="shard_map", cache=warm)
        t_warm = time.perf_counter() - t0
    assert cold.stats["misses"] == 1 and warm.stats["hits"] == 1, (cold.stats, warm.stats)
    from repro_torch.core.engine import live_nodes

    live = live_nodes(g, [prog._out[k] for k in prog.output_names])
    n_mm = sum(1 for n in g.nodes
               if n.nid in live and n.kind == "einsum" and spmd._as_matmul(n.spec))
    b, f, h, c = (FFNN[k] for k in ("batch", "feats", "hidden", "labels"))
    flops = 2 * 2 * b * f * h + 3 * 2 * b * h * c  # X@W1 and dW1; p, dW2 and da1
    nbytes = 4 * (b * f + 2 * f * h + 2 * h * c + b * c)  # X, W1 and dW1, W2 and dW2, Y
    bound_ms, bound_by = _bound(nbytes, flops, torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    feeds = _ffnn_feeds()
    log("ffnn", f"device memory: {mem0} bytes allocated before the feeds, "
                f"{torch.cuda.memory_allocated()} with them")
    log("ffnn", f"gradient graph: {len(g.nodes)} nodes, {len(live)} live, {n_mm} clean "
                f"contractions; planned cold {t_cold:.4f} s, hit {t_warm:.4f} s; plan cost "
                f"{run.plan.cost}; {flops:.4g} FLOP a step, bound {bound_ms:.1f} ms ({bound_by})")
    losses, walls = [], []
    want = None
    for i in range(FFNN_STEPS):
        if i == 0:  # the yardstick first, while nothing else holds a dW1
            want = _ffnn_plain_grads(feeds)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run(feeds)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches, designs = ops.launch_counts(), ops.design_counts()
        assert launches == {"flash_attention": 0, "flash_attention_step": 0,
                            "matmul": n_mm, "gmm": 0}, launches
        assert designs["matmul"]["ffma"] == n_mm, designs
        losses.append(float(out["loss"]))
        if i == 0:
            loss_plain, g1, g2 = want
            log("ffnn", f"device memory with the plain and the executor's gradients: "
                        f"{torch.cuda.memory_allocated()} bytes allocated")
            errs = {}
            for name, got, ref_g in (("W1", out["grad_W1"], g1), ("W2", out["grad_W2"], g2)):
                scale = float(ref_g.abs().max())
                err = max(float((a - b).abs().max())  # in row blocks: no full-size temporary
                          for a, b in zip(got.split(1 << 14), ref_g.split(1 << 14)))
                errs[name] = {"max_abs_err": err, "max_abs_grad": scale,
                              "limit": FFNN_TOL * scale}
                log("ffnn", f"step 0 grad_{name}: max|executor - autograd| {err:.3e} (limit "
                            f"{FFNN_TOL * scale:.3e} = {FFNN_TOL} x max|g| {scale:.3e})")
                assert err <= FFNN_TOL * scale, (name, errs[name])
            loss_err = abs(losses[0] - loss_plain) / loss_plain
            assert loss_err <= FFNN_TOL, (losses[0], loss_plain)
            del want, g1, g2
        with torch.no_grad():  # plain SGD, in place
            feeds["W1"].add_(out["grad_W1"], alpha=-FFNN_LR)
            feeds["W2"].add_(out["grad_W2"], alpha=-FFNN_LR)
        del out
        log("ffnn", f"step {i}: loss {losses[-1]:.6e}, wall {walls[-1]:.4f} s, matmul "
                    f"launches {launches['matmul']} by design {designs['matmul']}")
    assert all(np.isfinite(losses)), losses
    torch.cuda.empty_cache()
    prof = _profile(lambda: run(feeds))
    # every launch is in the trace, or its device time would be short
    assert prof["by_kind_count"]["matmul"] == n_mm, prof["by_kind_count"]
    events_ms = _time_ms(lambda: run(feeds), 2, warmup=0)
    final = float(run(feeds)["loss"])
    assert final < losses[0], (final, losses)
    log("profile", f"FFNN gradient step: wall {prof['wall_ms']:.3f} ms, device busy "
                   f"{prof['device_ms']:.3f} ms (idle share {prof['idle_share']:.3f}, "
                   f"{flops / prof['device_ms'] / 1e9:.2f} TFLOP/s, "
                   f"{prof['device_ms'] / bound_ms:.2f}x the bound; CUDA events "
                   f"{events_ms:.3f} ms), {prof['kernels']} "
                   f"kernels; device ms by kind {prof['by_kind_ms']}; top "
                   f"{prof['top_kernels_ms'][:4]}; loss after {FFNN_STEPS} steps {final:.6e}")
    res = {**FFNN, "nodes": len(g.nodes), "live_nodes": len(live), "t_plan_cold_s": t_cold,
           "t_plan_hit_s": t_warm, "plan_cost": run.plan.cost, "losses": losses + [final],
           "loss_rel_err": loss_err, "grad_errs": errs, "wall_s": walls,
           "matmul_launches_per_step": n_mm, "designs": designs, "flops": flops,
           "bound_ms": bound_ms, "bound_by": bound_by, "profile": prof, "events_ms": events_ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    # one more warmed call, untimed, held against the memory pass in phase 30
    gc.collect()
    torch.cuda.empty_cache()
    out, measured = _allocator_peak(lambda: run(feeds), feeds)
    del out
    res["memory"] = {"static": analyze_compiled(run).memory, "measured": measured}
    del feeds
    torch.cuda.empty_cache()
    return res




# ---------------------------------------------------------------------------
# 20-22. the serving tier: the continuous-batching engine
# ---------------------------------------------------------------------------

# a top-2 logit gap under this share of max|logit| is a near tie (printed)
NEAR_TIE = 2e-2
# the engine's bf16 logits against serve()'s on the same prefix, as a share
# of max|logit|: the two runs round differently (other batch sizes, padded
# and exact prefills) and, with MoE, a near tie in top-k routing can send a
# token to another expert; a request served from another request's context
# differs at the scale of the logits themselves (measured in the same run)
LOGIT_TOL = 5e-2


class _RouteLog:
    """While ``calls`` is a list, every MoE routing of the model stack
    (``models.moe._route``) appends the experts it picked, (tokens, top_k)
    on the device: no host read, so a captured decode step keeps them in
    tensors that every replay refills.  ``close`` puts the routing function
    back."""

    def __init__(self):
        from repro_torch.models import moe

        self.calls: list | None = None
        self._moe, self._route = moe, moe._route

        def route(p, xt, cfg):
            topw, tope, aux = self._route(p, xt, cfg)
            if self.calls is not None:
                self.calls.append(tope.detach())
            return topw, tope, aux

        moe._route = route

    def close(self):
        self._moe._route = self._route


def _sequential(cfg, params, prompt: np.ndarray, max_new: int, kv_len: int, device="cuda",
                force: np.ndarray | None = None, routes: _RouteLog | None = None,
                companion: np.ndarray | None = None):
    """One request alone through ``launch.serve``'s steps (the exact-length
    prefill, ``prepare_decode_caches``, the compiled decode step
    ``greedy_step``, as ``serve`` runs them): the argmax at each position
    and the logits behind it (float32, on the CPU).  Greedy without
    ``force``; with ``force`` every step is fed ``force[i]`` instead
    (teacher forcing), so position i's logits condition on that prefix.
    With ``routes``, also the experts each decode step picked for the
    token, (layers, top_k) per position (None at position 0, the
    prefill's), kept on the device by the step and read after it.  With
    ``companion`` (a prompt of the same length) the request runs as row 0
    of a batch of two, the companion decoding greedily beside it: what
    serving it in a batch does to its rounding."""
    from repro_torch.core.gspmd import full
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps

    prefill, decode = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    held: dict = {}

    def tapped(params, tokens, caches, pos):
        if routes is not None:
            routes.calls = []
        out = decode(params, tokens, caches, pos)
        held["last"] = full(out[0])[:, -1]  # a graph's replay refills it
        if routes is not None:
            held["experts"], routes.calls = routes.calls, None
        return out

    toks, logs, experts = [], [], [None]
    rows = prompt[None] if companion is None else np.stack([prompt, companion])
    with torch.inference_mode():
        logits, caches = prefill(params, {"tokens": torch.as_tensor(rows, device=device)})
        caches = serve_mod.prepare_decode_caches(cfg, caches, len(prompt), kv_len)
        last, run = logits[:, -1], None
        for i in range(max_new):
            logs.append(last[0].to("cpu", torch.float32, copy=True))  # ``last`` is refilled
            tok = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
            toks.append(int(tok[0, 0]))
            if force is not None:
                tok[0, 0] = int(force[i])
            if i + 1 < max_new:
                if run is None:
                    run = serve_mod.greedy_step(tapped, params, caches, tok, len(prompt))
                else:
                    run.inputs["tokens"].copy_(tok)
                    run.inputs["pos"].fill_(len(prompt) + i)
                run()
                last = held["last"]
                if routes is not None:
                    experts.append(torch.stack([c[0] for c in held["experts"]]).cpu())
    return np.asarray(toks, np.int32), logs, experts


def _record_logits(eng, routes: _RouteLog | None = None) -> tuple[dict, dict]:
    """Make ``eng`` copy out, per request, the logits behind each of its
    tokens (float32, on the CPU): its bucketed prefill's at the last real
    token, then its row of every decode step; with ``routes``, also the
    experts each decode step picked for its token, as ``_sequential``.  The
    steps are the engine's own (the registry's prefill entry,
    ``make_paged_serve_step`` and the greedy argmax on the device).  Both
    taps do device work only, so the engine captures and replays its
    bucket prefills and its decode step as graphs: the prefill tap copies
    its logits into a buffer made here, which each admission reads after
    the step, and the decode step keeps its logits and routings in tensors
    (the graph's, refilled by every replay), which each decode phase reads
    after the step.  The wrappers hold the engine: delete
    ``eng._prefill_into`` and ``eng._decode_phase`` before dropping it."""
    from repro_torch.core.gspmd import full
    from repro_torch.launch import steps

    rec: dict[int, list] = {}
    rec_experts: dict[int, list] = {}
    reg, decode_base = eng.registry, steps.make_paged_serve_step(eng.cfg)
    get_prefill, prefill_into = reg.prefill, eng._prefill_into
    first = torch.empty((eng.cfg.vocab_padded,), dtype=torch.float32, device=eng.device)

    def prefill(prompt_len, batch=1):
        ent = get_prefill(prompt_len, batch)
        base = getattr(ent, "unrecorded_step", ent.step)
        ent.unrecorded_step = base

        def step(params, batch, last_index):
            logits, caches = base(params, batch, last_index)
            first.copy_(full(logits)[0, -1].float())  # a replay refills it
            return logits, caches

        ent.step = step
        return ent

    def admitted(req, slot, blocks):
        prefill_into(req, slot, blocks)
        rec[req.rid], rec_experts[req.rid] = [first.to("cpu", copy=True)], [None]

    held: dict = {}

    def decode(params, tokens, caches, tables, pos):
        if routes is not None:
            routes.calls = []
        logits, caches = decode_base(params, tokens, caches, tables, pos)
        held["logits"] = logits[:, -1].float()
        if routes is not None:
            held["experts"], routes.calls = routes.calls, None
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32), caches

    phase = eng._decode_phase

    def decode_phase():
        live = [(i, req.rid) for i, req in enumerate(eng.slots) if req is not None]
        phase()
        logits = held["logits"].to("cpu", copy=True)  # the graph refills it
        calls = [c.to("cpu", copy=True) for c in held["experts"]] if routes is not None else None
        for i, rid in live:
            rec[rid].append(logits[i])
            if calls is not None:
                rec_experts[rid].append(torch.stack([c[i] for c in calls]))

    reg.prefill, eng._decode, eng._decode_phase = prefill, decode, decode_phase
    eng._prefill_into = admitted
    return rec, rec_experts


def _hold_against_sequential(what: str, got: np.ndarray, got_logits: list,
                             seq_logits: list, other_logits: list, got_experts=None,
                             seq_experts=None, limit: float = LOGIT_TOL) -> dict:
    """The engine's tokens and logits against the sequential run's logits
    on the same prefix (teacher-forced on the engine's tokens), and against
    another request's (``other_logits``: what serving the wrong context
    would look like).  Returns the measured differences and the failures:
    a position where the two runs' logits differ by more than ``limit`` x
    max|logit| (LOGIT_TOL unless a measured rounding baseline sets more), or where the engine's token is not the sequential argmax
    and the top-2 gap is not under twice the measured difference (a flip
    the rounding of the two runs does not explain).  With the experts each
    run's MoE layers picked, the comparison stops at the first position
    where the token went to other experts in some layer (a routing near
    tie: from there on the two runs compute different functions).  Near
    ties, flips and the routing stop are printed."""
    rel, other, flips, failures = [], [], [], []
    stop = len(got)
    for i in range(1, len(got)) if got_experts is not None else ():
        same = (got_experts[i].sort(-1).values == seq_experts[i].sort(-1).values).all(-1)
        if not bool(same.all()):
            layer = int((~same).nonzero()[0, 0])
            log("engine", f"{what}: position {i}: routing differs at layer {layer} (experts "
                          f"{got_experts[i][layer].tolist()} in the engine, "
                          f"{seq_experts[i][layer].tolist()} alone); compared {i} positions")
            stop = i
            break
    for i, (e, q, o) in enumerate(zip(got_logits[:stop], seq_logits, other_logits)):
        scale = float(q.abs().max())
        delta = float((e - q).abs().max())
        top2 = torch.topk(q, 2).values
        gap = float(top2[0] - top2[1])
        rel.append(delta / scale)
        other.append(float((e - o).abs().max()) / scale)
        want = int(torch.argmax(q))
        if gap < NEAR_TIE * scale or int(got[i]) != want:
            log("engine", f"{what}: position {i}: top-2 gap {gap:.4e} ({gap / scale:.2e} of "
                          f"max|logit|), the runs' logits differ by {delta:.4e} "
                          f"({delta / scale:.2e}); token {int(got[i])} "
                          f"{'=' if int(got[i]) == want else '!='} {want}")
        if delta > limit * scale:
            failures.append(f"{what}: position {i}: logits differ by {delta:.4e}, beyond "
                            f"{limit:.3e} x max|logit| {scale:.3f}")
        if int(got[i]) != want:
            flips.append(i)
            if gap >= 2 * delta:
                failures.append(f"{what}: token {i} is {int(got[i])}, the sequential run "
                                f"gives {want} at a top-2 gap {gap:.4e} that the runs' "
                                f"logit difference {delta:.4e} does not explain")
    return {"max_rel_logit_diff": max(rel), "min_rel_diff_to_other_request": min(other),
            "flips": flips, "routing_stop": stop, "held": flips[0] if flips else stop,
            "failures": failures}


def _engine_run(cfg, params, prompts, max_new, *, batch: int, block: int, max_seq: int,
                store: str, ops, device="cuda", graph: bool | None = None):
    """A ``ServingEngine`` on ``device`` over a plan-cache file (``graph``
    as the engine takes it): every request submitted, the launch counters
    set to 0 just before ``run`` and read just after, the peak memory of
    the run (allocated, and reserved from an emptied cache).  With graphs,
    the decode step and every bucket's prefill with its admission replay
    them: a step's first call eager, its second captured, every call after
    the first a replay; the bucket graphs share one memory pool."""
    from collections import Counter

    from repro_torch.core.plancache import PlanCache
    from repro_torch.serving import ServingEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # before the requests' clocks start
    eng = ServingEngine(cfg, batch=batch, max_seq=max_seq, block=block, params=params,
                        plan_cache=PlanCache.open(store), device=device, graph=graph)
    for p, n in zip(prompts, max_new):
        eng.submit(p, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, metrics = eng.run()
    launches, designs = ops.launch_counts(), ops.design_counts()
    graphed = graph is None
    assert eng.graph is graphed, (eng.graph, graph)
    assert eng._step.replays == (metrics.decode_steps - 1 if graphed else 0), (
        eng._step.replays, metrics.decode_steps)
    uses = Counter(eng.registry.bucket_len(len(p)) for p in prompts)
    prefills = {key[2]: run for key, run in eng._prefills.items()}
    assert sorted(prefills) == sorted(uses), (sorted(prefills), uses)
    for n, run in prefills.items():
        assert run.replays == (uses[n] - 1 if graphed else 0), (n, run.replays, uses[n])
        assert (run._graph is not None) == (graphed and uses[n] > 1), n
        assert run.pool is eng._pool and (eng._pool is not None) == graphed
    return eng, res, metrics, {"launches": launches, "designs": designs,
                               "replays": eng._step.replays,
                               "prefill_uses": dict(uses),
                               "prefill_replays": {n: r.replays for n, r in prefills.items()},
                               "max_memory_allocated": torch.cuda.max_memory_allocated(),
                               "max_memory_reserved": torch.cuda.max_memory_reserved()}


def _prefill_footprint(eng, n: int) -> int:
    """Bytes one eager bucketed prefill of ``n`` tokens allocates beyond
    what is allocated before it (its caches, logits and intermediates),
    through the engine's registry entry."""
    ent = eng.registry.prefill(n)
    tokens = torch.zeros((1, ent.key[2]), dtype=torch.int32, device=eng.device)
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = ent.step(eng.params, {"tokens": tokens}, n - 1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    del out
    return peak - before


def _engine_phase(cfg, ops, dense: dict, *, slots: int, block: int, max_seq: int,
                  lens: list[int], max_new: int, seed: int = 0, device="cuda",
                  baseline: bool = False) -> dict:
    """``cfg`` at full width and depth (bf16, random weights from ``seed``)
    served by the continuous-batching engine on the card: a first engine,
    eager (``graph=False``), over a new plan-cache file, then a second,
    graphed, over the same file (plans with hits only, its run read for
    the timings).  Checks: each request's
    generation against the sequential serve of that request alone (the
    near-tie rule), flash launches = layers x prefills, gmm launches =
    MoE products x layers x (prefills + decode steps), every bf16 launch of
    the wgmma design, registry compiles = distinct buckets + 1 decode cell.
    The graphed run's decode step replays its graph (``eng._step.replays``
    = decode steps - 1), and so does each bucket's prefill with its
    admission from the bucket's second use (``_engine_run``); its
    generations equal the eager run's, and its peak memory is within one
    prefill of the longest prompt of the eager run's.  Then one engine
    decode step with every slot live, counted
    and profiled as a replay and eagerly (the same step function), beside
    the dense serve loop's decode step, graphed and eager (``dense``: phase
    5's, 14's or 24's profile).  With ``baseline``, the
    logit limit is measured first: each request served alone against the
    same request served as one row of a batch of two (a seeded companion
    prompt of its length beside it), teacher-forced alike; the engine is
    then held to twice the largest such difference where that exceeds
    LOGIT_TOL, and the limit must still tell another context apart."""
    from repro_torch.core import tree
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    dense_decode, dense_graph = dense["decode_step"], dense["decode_step_graph"]
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    news = [max_new] * len(prompts)
    kw = dict(batch=slots, block=block, max_seq=max_seq, ops=ops, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "plans.json")
        # the first run eager (graph=False): the baseline of the graphed second
        eng, first, m1, run1 = _engine_run(cfg, params, prompts, news, store=store,
                                           graph=False, **kw)
        buckets = sorted({eng.registry.bucket_len(n) for n in lens})
        stats1 = eng.registry.stats
        assert stats1.compiles == len(buckets) + 1, (stats1, buckets)
        assert stats1.plan_cache_hits == 0, stats1
        footprint = _prefill_footprint(eng, max(lens))
        del eng
        eng, res, m, run2 = _engine_run(cfg, params, prompts, news, store=store, **kw)
        summary, ttft = m.summary(), [m.ttft_s[r] for r in sorted(m.ttft_s)]
        stats2 = dataclasses.replace(eng.registry.stats)
        assert stats2.compiles == stats2.plan_cache_hits == len(buckets) + 1, stats2
        assert eng.registry.plan_cache.misses == 0, eng.registry.plan_cache.stats
    # the counted runs: what every launch did
    moe_per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    for run, met in ((run1, m1), (run2, m)):
        want = {"flash_attention": _attn_layers(cfg) * met.prefills, "flash_attention_step": 0,
                "matmul": 0,
                "gmm": moe_per_layer * cfg.n_layers * (met.prefills + met.decode_steps)}
        assert run["launches"] == want, (run["launches"], want)
        for kernel in ("flash_attention", "gmm"):
            assert run["designs"][kernel]["wgmma"] == run["launches"][kernel], run["designs"]
    assert m.prefills == m1.prefills == len(lens), (m.prefills, m1.prefills)
    assert m.tokens_generated == len(lens) * max_new, m.tokens_generated
    # graphed (the bucket prefills with their admission, the decode step)
    # against eager: the same kernels in the same order, so the same tokens
    same = all(np.array_equal(first[r], res[r]) for r in res)
    assert same and sorted(first) == sorted(res), (first, res)
    # the bucket graphs share one pool: the graphed run's peak within one
    # bucket's prefill of the eager run's
    assert run2["max_memory_allocated"] <= run1["max_memory_allocated"] + footprint, (
        run2["max_memory_allocated"], run1["max_memory_allocated"], footprint)
    # the KV pools, and the per-slot recurrent states where the arch has them
    pool_bytes = sum(t.nbytes for t in tree.leaves(eng.caches))
    # a third run that copies out the logits behind every token, and each
    # request against the serve loop's run of it alone on the same prefix
    routes = _RouteLog() if cfg.moe else None
    try:
        rec_eng = ServingEngine(cfg, batch=slots, max_seq=max_seq, block=block, params=params,
                                device=device)
        rec, rec_experts = _record_logits(rec_eng, routes)
        for p in prompts:
            rec_eng.submit(p, max_new)
        rec_res, _ = rec_eng.run()
        # the taps' wrappers hold the engine: a cycle
        del rec_eng._decode_phase, rec_eng._prefill_into, rec_eng
        seq = []
        for rid, p in enumerate(prompts):
            assert ((rec_res[rid] >= 0) & (rec_res[rid] < cfg.vocab_padded)).all()
            assert len(rec[rid]) == max_new, (rid, len(rec[rid]))
            seq.append(_sequential(cfg, params, p, max_new, eng.seq, device,
                                   force=rec_res[rid], routes=routes))
    finally:
        if routes is not None:
            routes.close()
    same_rec = all(np.array_equal(rec_res[r], res[r]) for r in res)
    base_rel, limit = [], LOGIT_TOL
    if baseline:  # what batching alone does to serve()'s logits, in this run
        comp_rng = np.random.default_rng(seed + 1)
        for rid, p in enumerate(prompts):
            comp = comp_rng.integers(0, cfg.vocab, size=p.shape).astype(np.int32)
            _, logs2, _ = _sequential(cfg, params, p, max_new, eng.seq, device,
                                      force=rec_res[rid], companion=comp)
            base_rel.append(max(float((a - b).abs().max() / b.abs().max())
                                for a, b in zip(logs2, seq[rid][1])))
        limit = max(LOGIT_TOL, 2 * max(base_rel))
        log("engine", f"{cfg.name}: serve() of each request in a batch of two against serve() "
                      f"alone, teacher-forced alike: max|logit diff| / max|logit| "
                      f"{[format(x, '.2e') for x in base_rel]}; the engine is held to "
                      f"{limit:.3e} of max|logit|")
    gen, _ = serve_mod.serve(cfg, prompts[0][None], max_new=max_new, params=params,
                             kv_len=eng.seq, device=device)
    free = _sequential(cfg, params, prompts[0], max_new, eng.seq, device)[0]
    assert np.array_equal(gen[0], free), (gen[0], free)  # the helper is serve()'s loop
    held = [_hold_against_sequential(f"{cfg.name} request {rid} (prompt {len(p)})",
                                     rec_res[rid], rec[rid], seq[rid][1],
                                     seq[(rid + 1) % len(prompts)][1],
                                     rec_experts[rid] if routes else None,
                                     seq[rid][2] if routes else None, limit=limit)
            for rid, p in enumerate(prompts)]
    # one engine decode step, every slot live, counted and profiled: a
    # replay of its graph, then the same step eager (the engine's own step
    # function, ``graph=False``) on the same caches
    from repro_torch.launch import steps

    for p in prompts[:slots]:  # live through the 10 decode phases below
        eng.submit(p, max(max_new, 11))
    with torch.inference_mode():
        eng._admit_phase()
        assert all(s is not None for s in eng.slots)
        graphed = eng._step
        ops.reset_launch_counts()
        eng._decode_phase()
        step_launches, step_designs = ops.launch_counts(), ops.design_counts()
        prof = _profile(eng._decode_phase)
        eng._step = steps.GraphedStep(graphed.fn, graphed.state, graphed.inputs, graph=False)
        ops.reset_launch_counts()
        eng._decode_phase()
        eager_launches, eager_designs = ops.launch_counts(), ops.design_counts()
        prof_eager = _profile(eng._decode_phase)
        eng._step = graphed
    assert step_launches["gmm"] == moe_per_layer * cfg.n_layers, step_launches
    assert step_launches["flash_attention"] == 0, step_launches
    assert (step_launches, step_designs) == (eager_launches, eager_designs), (
        step_designs, eager_designs)
    assert step_designs["gmm"]["wgmma"] == step_launches["gmm"], step_designs
    traced = _traced_launches(prof)  # one replay's trace, against the counters
    assert traced == _traced_launches(prof_eager) == step_launches, (traced, step_launches)
    log("engine", f"{cfg.name} bf16, {slots} slots, block {block}, max_seq {max_seq}, "
                  f"{len(lens)} requests (prompts {lens}, buckets {buckets}), {max_new} new "
                  f"each; params made in {t_init:.1f} s")
    ttft1 = [m1.ttft_s[r] for r in sorted(m1.ttft_s)]
    log("engine", f"first run (eager, cold plan-cache file): {m1.summary()}; registry {stats1}")
    log("engine", f"second run (graphed, the same file): {summary}; registry {stats2}; "
                  f"generations equal to the eager run's: {same}, to the logit-recording "
                  f"run's: {same_rec}")
    log("engine", f"TTFT per request (s), graphed: {[round(t, 4) for t in ttft]}; eager: "
                  f"{[round(t, 4) for t in ttft1]}")
    log("engine", f"bucket prefills with their admission, graphed run: uses "
                  f"{run2['prefill_uses']}, replays {run2['prefill_replays']} (captured at "
                  f"each bucket's second use), one shared pool")
    log("engine", f"launches {run2['launches']}, by design {run2['designs']}; peak memory "
                  f"graphed {run2['max_memory_allocated']} B (reserved "
                  f"{run2['max_memory_reserved']} B), eager {run1['max_memory_allocated']} B "
                  f"(reserved {run1['max_memory_reserved']} B), one prefill of {max(lens)} "
                  f"tokens {footprint} B; pool {pool_bytes} B")
    log("engine", f"against serve() of each request alone, teacher-forced on the engine's "
                  f"tokens: positions compared before the first routing difference "
                  f"{[h['routing_stop'] for h in held]}, tokens before the first flip "
                  f"{[h['held'] for h in held]} of {max_new}; max|logit diff| / max|logit| per request "
                  f"{[format(h['max_rel_logit_diff'], '.2e') for h in held]} (limit "
                  f"{limit:.3e}); against the next request's logits (another context) at "
                  f"least {[format(h['min_rel_diff_to_other_request'], '.2e') for h in held]}")
    failures = [f for h in held for f in h["failures"]]
    assert not failures, failures
    # the limit tells a request served from another context apart
    assert min(h["min_rel_diff_to_other_request"] for h in held) > limit, held
    log("engine", f"{cfg.name}: {run2['replays']} graph replays of {summary['decode_steps']} "
                  f"decode steps in the second run; one replay launched {step_launches} by design "
                  f"{step_designs} (counted), {traced} (its trace), the eager step the same")
    for name, br in (("engine decode step (graph)", prof),
                     ("engine decode step (eager)", prof_eager),
                     ("dense decode step (graph)", dense_graph),
                     ("dense decode step (eager)", dense_decode)):
        log("profile", f"{cfg.name} {name}: wall {br['wall_ms']:.3f} ms, device busy "
                       f"{br['device_ms']:.3f} ms (idle share {br['idle_share']:.3f}), "
                       f"{br['kernels']} kernels; device ms by kind {br['by_kind_ms']}")
    out = {"slots": slots, "block": block, "max_seq": max_seq, "prompt_lens": lens,
           "max_new": max_new, "buckets": buckets, "t_init_s": t_init,
           "first_run": m1.summary(), "summary": summary, "ttft_s": ttft,
           "ttft_s_eager": ttft1, "prefill_uses": run2["prefill_uses"],
           "prefill_replays": run2["prefill_replays"],
           "max_memory_allocated_eager": run1["max_memory_allocated"],
           "max_memory_reserved": run2["max_memory_reserved"],
           "max_memory_reserved_eager": run1["max_memory_reserved"],
           "prefill_footprint": footprint,
           "registry_first": dataclasses.asdict(stats1),
           "registry_second": dataclasses.asdict(stats2), "same_as_first_run": same,
           "same_as_recording_run": same_rec,
           "launches": run2["launches"], "designs": run2["designs"],
           "max_memory_allocated": run2["max_memory_allocated"], "pool_bytes": pool_bytes,
           "against_sequential": held, "generations": {r: res[r].tolist() for r in res},
           "batch_baseline_rel": base_rel, "logit_limit_rel": limit,
           "decode_step_launches": step_launches, "decode_step_designs": step_designs,
           "traced_decode_step_launches": traced,
           "replays": run2["replays"], "profile_decode_step": prof,
           "profile_decode_step_eager": prof_eager,
           "dense_decode_step": dense_decode, "dense_decode_step_graph": dense_graph,
           # the static verifier over every live bucket (phase 30 reads it)
           "registry_analysis": {
               "/".join(str(k) for k in key): {
                   "findings": [f.format() for f in rep.findings],
                   "peak_bytes": rep.memory["peak_bytes"]}
               for key, rep in eng.registry.analyze().items()}}
    del eng, params
    torch.cuda.empty_cache()
    return out


def _engine_parity(cfg, ops, device="cuda") -> dict:
    """``cfg`` at full width, 2 layers, float32: the engine on the card
    (the flash kernel's ffma design in each bucketed prefill, the gmm
    kernel's ffma design in each MoE product; xlstm launches neither) and
    on the CPU (the plain path), the same weights and requests; tokens
    equal, the logits behind every token (each prefill's and each decode
    step's) within 1e-4 x max|logit|."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = tf.init_params(cfg2, seed=22, device="cpu")
    rng = np.random.default_rng(22)
    lens = rng.integers(32, 129, size=3).tolist()
    prompts = [rng.integers(0, cfg2.vocab, size=(n,)).astype(np.int32) for n in lens]
    max_new = 6
    out = {}
    for dev in (device, "cpu"):
        eng = ServingEngine(cfg2, batch=2, max_seq=144, block=16, params=params, device=dev)
        rec, _ = _record_logits(eng)
        for p in prompts:
            eng.submit(p, max_new)
        ops.reset_launch_counts()
        res, m = eng.run()
        out[dev] = (res, rec, m, ops.launch_counts(), ops.design_counts())
        del eng
    (got, grec, m, launches, designs), (want, wrec, _, cpu_launches, _) = (
        out[device], out["cpu"])
    moe_per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
    assert launches == {"flash_attention": _attn_layers(cfg2) * m.prefills,
                        "flash_attention_step": 0,
                        "matmul": 0, "gmm": 2 * moe_per_layer * (m.prefills + m.decode_steps)
                        }, launches
    assert m.prefills == 3 and not any(cpu_launches.values()), cpu_launches
    # float32 at head dim 128: every prefill's flash launch ffma, every MoE product ffma
    assert designs["flash_attention"]["ffma"] == launches["flash_attention"], designs
    assert designs["gmm"]["ffma"] == launches["gmm"], designs
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), (rid, got[rid], want[rid])
        assert len(grec[rid]) == len(wrec[rid]) == max_new, rid
    pairs = [(g, w) for rid in want for g, w in zip(grec[rid], wrec[rid])]
    scale = max(float(w.abs().max()) for _, w in pairs)
    diff = max(float((g - w).abs().max()) for g, w in pairs)
    assert diff <= 1e-4 * scale, (diff, scale)
    log("engine-parity", f"{cfg.name} width, 2 layers, f32, prompts {lens}, {max_new} new, 2 "
                         f"slots: tokens equal on the card and the CPU "
                         f"{[got[r].tolist() for r in sorted(got)]}; max|logit diff| "
                         f"{diff:.3e} (max|logit| {scale:.3f}, limit 1e-4 of it); launches "
                         f"{launches}, flash by design {designs['flash_attention']}, gmm "
                         f"{designs['gmm']}")
    del params
    torch.cuda.empty_cache()
    return {"prompt_lens": lens, "max_new": max_new, "max_abs_logit_diff": diff,
            "max_abs_logit": scale, "launches": launches, "designs": designs,
            "tokens": {r: got[r].tolist() for r in got}}



# ---------------------------------------------------------------------------
# 23-27. the rest of the model zoo: hymba, xlstm, paligemma
# ---------------------------------------------------------------------------

# hymba-1.5b's prefill at b=4, prompt 2048 (GQA 5:1, head dim 64, the
# window of 1024 binds) and paligemma-3b's at b=4, 512 (MQA 8:1, head dim
# 256); paligemma's float32 slice of phase 27 (256 prefix + 64 tokens), and
# its prefill shape in float32 (on no path: a grid of several waves)
HYMBA_PREFILL = (4, 25, 5, 2048, 2048, 64, True, 1024, torch.bfloat16)
PALIGEMMA_PREFILL = (4, 8, 1, 512, 512, 256, True, 0, torch.bfloat16)
PALIGEMMA_F32_SLICE = (1, 8, 1, 320, 320, 256, True, 0, torch.float32)
PALIGEMMA_PREFILL_F32 = PALIGEMMA_PREFILL[:-1] + (torch.float32,)


def _sdpa_call(case, q, k, v):
    """SDPA on the same function as the kernel at ``case``: GQA by
    ``enable_gqa``; a binding window as a boolean mask (causal within the
    window), else ``is_causal``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq, sk, window = case[3], case[4], case[7]
    if window:
        i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        j = torch.arange(sk, device=q.device)[None, :]
        mask = (j <= i) & (j > i - window)
        return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    return lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)


def _kernel_names(fn) -> list[str]:
    """The device kernels one warmed call of ``fn`` launches (names cut to
    90 characters): which backend a library call took."""
    fn()
    torch.cuda.synchronize()
    return sorted({e.name[:90] for e in _traced_after_spin(fn)})


ZOO_FLASH_CASES = {"hymba": HYMBA_PREFILL, "paligemma": PALIGEMMA_PREFILL,
                   "paligemma_f32": PALIGEMMA_F32_SLICE,
                   "paligemma_f32_b4": PALIGEMMA_PREFILL_F32}


def _zoo_flash_timing(fa, ops, ref, cases: dict = ZOO_FLASH_CASES) -> dict:
    """Phase 23 (and 36(d)): the forward kernel at each of ``cases``: by
    default hymba's and paligemma's prefill shapes (bf16, the wgmma
    design), paligemma's float32 slice and its prefill shape in float32
    (the ffma design): held against its plain version, then its device
    time, SDPA's device time on the same function in the same type (its
    backend named by its kernels), the template's device time (its C
    entry), the plain version's time by events and the bound."""
    res = {}
    for name, case in cases.items():
        q, k, v, kw = _inputs(case, seed=23)
        design = fa.design(q, k, v)
        assert design == _expected_flash_design(case), (name, design)
        kernel = lambda: ops.flash_attention(q, k, v, impl="kernel", **kw)  # noqa: E731
        got, served = _served_by(ops, "flash_attention", kernel)
        assert served == design, (name, served)
        want = ref.attention(q, k, v, **kw)
        err = _max_err(got, want, TOL[case[-1]], f"flash at {name}'s prefill {case[:8]}")
        lib = _sdpa_call(case, q, k, v)
        lib_err = float((lib().float() - want.float()).abs().max())
        del got, want
        template, _ = _flash_template(fa, q, k, v, causal=True, window=case[7])
        t_kernel = _time_ms(kernel, 10)
        t_device = _device_ms(kernel, 10, FLASH_DEVICE_KERNEL[design])
        t_template = _device_ms(template, 5, "flash_fwd_kernel")
        t_plain = _time_ms(lambda: ref.attention(q, k, v, **kw), 3)
        t_lib = _time_ms(lib, 10)
        t_lib_device = _device_ms(lib, 10, None)
        backend = _kernel_names(lib)
        bound_ms, bound_by, nbytes, nops = _attention_bound_ms(case, ref)
        log("zoo-timing", f"flash_attention {name} {case[:8]} {case[-1]}: kernel ({design}) "
                          f"{t_kernel:.4f} ms ({t_device:.4f} ms device time; "
                          f"{t_device / bound_ms:.2f}x the bound, {t_device / t_lib_device:.2f}x "
                          f"sdpa), template {t_template:.4f} ms device time "
                          f"({t_template / t_device:.2f}x the kernel), plain {t_plain:.4f} ms, "
                          f"sdpa {t_lib:.4f} ms "
                          f"({t_lib_device:.4f} ms device time; kernels {backend}; "
                          f"max|sdpa - plain| {lib_err:.3e}), bound {bound_ms:.4f} ms "
                          f"({bound_by}: {nbytes} B, {nops} ops); max|kernel - plain| {err:.3e}")
        res[name] = {"case": str(case), "design": design, "max_abs_err": err,
                     "kernel_ms": t_kernel, "device_ms": t_device,
                     "template_device_ms": t_template, "plain_ms": t_plain,
                     "library_ms": t_lib, "library_device_ms": t_lib_device,
                     "library_kernels": backend, "library_max_abs_err": lib_err,
                     "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": nops}
        del q, k, v
        torch.cuda.empty_cache()
    return res


def _zoo_serve(ops) -> dict:
    """Phases 24-26: hymba-1.5b (prompt 2048, so the window binds in prefill
    and decode runs on the ring buffer), xlstm-125m (prompt 512; no flash
    kernel runs) and paligemma-3b (prompt 512 from tokens, as the
    reference serves it, then one prefill of 256 prefix embeddings and
    256 tokens) at full width and depth, bf16, batch 4, 16 new tokens."""
    from repro_torch.configs import get_config

    out = {}
    for arch, prompt_len, design in (("hymba-1.5b", 2048, "wgmma"),
                                     ("xlstm-125m", 512, "wgmma"),
                                     ("paligemma-3b", 512, "wgmma")):
        cfg = get_config(arch)
        res = _serve_phase(cfg, ops, prompt_len=prompt_len, flash_design=design)
        if not _attn_layers(cfg):
            assert res["launches"]["flash_attention"] == 0, res["launches"]
            log("serve", f"{arch}: no attention layer, so no flash kernel runs; the mLSTM "
                         f"and sLSTM recurrences are plain torch, as in the reference")
        out[arch] = res
    return out


ZOO_SLICE = {"hymba-1.5b": 1280, "xlstm-125m": 512, "paligemma-3b": 64}
ZOO_TOL = 1e-4       # logits (x max|logit|) and the loss (relative), as phase 17
# every gradient leaf, x its max|g|: the attention backward over rows of
# up to 1024 keys subtracts nearly equal f32 sums, so the card's plain path
# alone differs from the CPU by a few 1e-4 at hymba's s = 1280
ZOO_GRAD_TOL = 1e-3


class _PlainAttention:
    """Stands in for ``kernels.ops`` inside ``models.attention`` while it is
    set there: flash attention through its plain version on any device,
    so the card's plain path can be held against the CPU's."""

    def __init__(self, ops):
        self._ops = ops

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def flash_attention(self, *args, **kw):
        return self._ops.flash_attention(*args, impl="ref", **kw)


def _value_and_grads(cfg, cpu_params, batch_np: dict, dev: str, ops, plain: bool = False):
    """``_logits_loss_grads`` on a copy of ``cpu_params`` on ``dev``
    (``plain``: the card without the flash kernel), the gradients on the
    host, with the flash launches and designs alone."""
    from repro_torch.core import tree
    from repro_torch.models import attention as attn_mod

    params = tree.map(lambda t: t.to(dev, copy=True), cpu_params)
    if plain:
        attn_mod.ops = _PlainAttention(ops)
    try:
        out = _logits_loss_grads(cfg, params, batch_np, ops)
    finally:
        attn_mod.ops = ops
    out.update(grads=[g.float().cpu() for g in out["grads"]],
               launches=out["launches"]["flash_attention"],
               designs=out["designs"]["flash_attention"])
    del params
    torch.cuda.empty_cache()
    return out


def _rel_errs(got: dict, want: dict) -> tuple[float, list[float]]:
    """max|logit diff| / max|logit|, and per gradient leaf max|diff| / max|g|."""
    scale = float(want["logits"].abs().max())
    lg = float((got["logits"] - want["logits"]).abs().max()) / scale
    return lg, [float((g - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                for g, c in zip(got["grads"], want["grads"])]


def _zoo_slice_parity(ops) -> dict:
    """Phase 27: hymba (s = 1280: the window binds; head dim 64, the ffma
    flash), xlstm (one mLSTM and one sLSTM block, s = 512) and paligemma
    (256 prefix embeddings and 64 tokens; head dim 256, the ffma flash)
    at full width, 2 layers, float32, batch 1: the same weights and inputs
    on the card and on the CPU.  The logits of ``forward`` (ZOO_TOL x
    max|logit|), ``loss_fn`` (ZOO_TOL relative) and every gradient leaf
    (ZOO_GRAD_TOL x its max|g|), all finite.  Beside them, the card's plain
    path (no flash kernel) against the CPU, the rounding the card shows
    without the kernel; and for hymba, the CPU's gradients of the same
    model without its window, against which every attention leaf must
    differ by more than the limit (the limit sees a wrong mask)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    out = {}
    for arch, s in ZOO_SLICE.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
        cpu_params = tf.init_params(cfg, seed=27, device="cpu")
        rng = np.random.default_rng(27)
        toks = rng.integers(0, cfg.vocab, size=(1, s)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.prefix_len:
            batch["prefix_embeds"] = rng.normal(
                size=(1, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        gpu = _value_and_grads(cfg, cpu_params, batch, "cuda", ops)
        plain = _value_and_grads(cfg, cpu_params, batch, "cuda", ops, plain=True)
        cpu = _value_and_grads(cfg, cpu_params, batch, "cpu", ops)
        n_att = _attn_layers(cfg)
        # the forward, then the loss's forward and its remat recompute
        assert gpu["launches"] == (n_att, 2 * n_att), gpu["launches"]
        assert plain["launches"] == cpu["launches"] == (0, 0), (plain["launches"],
                                                                cpu["launches"])
        design = _expected_flash_design((0,) * 5 + (cfg.hd, torch.float32))
        assert gpu["designs"][design] == 3 * n_att, gpu["designs"]
        assert gpu["logits"].shape == (1, s + cfg.prefix_len, cfg.vocab_padded)
        assert bool(torch.isfinite(gpu["logits"]).all())
        lg_err, g_errs = _rel_errs(gpu, cpu)
        lg_plain, g_plain = _rel_errs(plain, cpu)
        loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
        names = [f"leaf {i} {tuple(c.shape)}" for i, c in enumerate(cpu["grads"])]
        for name, e, ep in zip(names, g_errs, g_plain):
            log("zoo-parity", f"{arch} grad {name}: max|card - CPU| / max|g| {e:.3e} "
                              f"(card without the kernel {ep:.3e}; limit {ZOO_GRAD_TOL})")
        contrast = None
        if cfg.window:  # the same model without its window: a wrong mask
            nowin = _value_and_grads(dataclasses.replace(cfg, window=0), cpu_params, batch,
                                     "cpu", ops)
            _, c_errs = _rel_errs(nowin, cpu)
            att = [i for i, n in enumerate(names) if len(cpu["grads"][i].shape) == 4]
            contrast = min(c_errs[i] for i in att)
            log("zoo-parity", f"{arch}: without its window, the CPU's attention gradient "
                              f"leaves move by at least {contrast:.3e} of their max|g| "
                              f"(limit {ZOO_GRAD_TOL})")
            assert contrast > ZOO_GRAD_TOL, contrast
        assert all(bool(torch.isfinite(g).all()) for g in gpu["grads"]), arch
        assert lg_err <= ZOO_TOL and loss_err <= ZOO_TOL, (arch, lg_err, loss_err)
        worst = max(range(len(g_errs)), key=lambda i: g_errs[i])
        assert g_errs[worst] <= ZOO_GRAD_TOL, (arch, names[worst], g_errs[worst])
        log("zoo-parity", f"{arch} width, 2 layers ({'+'.join(cfg.block_pattern)}), f32, b=1, "
                          f"s={s}{f' + {cfg.prefix_len} prefix' if cfg.prefix_len else ''}: "
                          f"max|logit diff| / max|logit| {lg_err:.3e} (without the kernel "
                          f"{lg_plain:.3e}; limit {ZOO_TOL}); loss card {gpu['loss']:.7f} CPU "
                          f"{cpu['loss']:.7f} (relative {loss_err:.3e}); {len(g_errs)} gradient "
                          f"leaves, worst {names[worst]} at {g_errs[worst]:.3e} of its max|g| "
                          f"(without the kernel {max(g_plain):.3e} at worst); flash launches "
                          f"(forward, loss and grad) {gpu['launches']}, by design "
                          f"{gpu['designs']}")
        out[arch] = {"seq": s, "prefix_len": cfg.prefix_len, "logit_rel_err": lg_err,
                     "logit_rel_err_plain": lg_plain, "loss": gpu["loss"],
                     "loss_rel_err": loss_err, "grad_rel_errs": g_errs,
                     "grad_rel_errs_plain": g_plain, "window_contrast": contrast,
                     "launches": gpu["launches"], "designs": gpu["designs"],
                     "design": design}
        del cpu_params, gpu, plain, cpu
    return out


ZOO_EXECUTOR_CASES = (("hymba-1.5b", 2048), ("paligemma-3b", 512))


def _zoo_executor(ops, cases=ZOO_EXECUTOR_CASES) -> dict:
    """Phase 27 (cont.; and 36(c)): one block period of each case's prefill
    EinGraph at b=4 and its sequence length, by default hymba's (s=2048)
    and paligemma's (s=512), in bf16 through ``executor="shard_map"`` on
    the one-rank mesh, against the dense run: every clean contraction
    through the matmul kernel (wgmma), one flash launch (wgmma: hymba at
    head dim 64, paligemma at 256); the scans and the MoE stubs are
    ``models.opaque_stubs``' deterministic stand-ins."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.opaque_stubs import make_stub_opaques

    make_stub_opaques()
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    out = {}
    for arch, seq in cases:
        cfg = get_config(arch)
        prog = program_for(cfg, ShapeConfig("serve", "prefill", seq, 4))
        g = prog.graph
        n_mm = sum(1 for n in g.nodes if n.kind == "einsum" and spmd._as_matmul(n.spec))
        run = prog.compile(mesh=mesh, executor="shard_map")
        dense = prog.compile(mesh_axes=dict(mesh.sizes), device="cuda")
        feeds = _graph_feeds(g, cfg, torch.bfloat16, seed=27)
        mm_shapes = sorted({tuple(g.nodes[n.inputs[1]].shape) for n in g.nodes
                            if n.kind == "einsum" and spmd._as_matmul(n.spec)})
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            launches, designs = ops.launch_counts(), ops.design_counts()
            want = dense(feeds)["logits"]
            torch.cuda.synchronize()
            # the yardstick's products are torch.einsum (cuBLAS), not the kernel
            assert ops.launch_counts()["matmul"] == n_mm, ops.launch_counts()
            prof = _profile(lambda: run(feeds))
        flash_design = _expected_flash_design((0,) * 5 + (cfg.hd, torch.bfloat16))
        assert launches == {"flash_attention": 1, "flash_attention_step": 0, "matmul": n_mm,
                            "gmm": 0}, launches
        assert designs["matmul"]["wgmma"] == n_mm, designs
        assert designs["flash_attention"][flash_design] == 1, designs
        assert got.shape == (4, seq, cfg.vocab_padded) and bool(torch.isfinite(got).all())
        scale = float(want.float().abs().max())
        diff = float((got.float() - want.float()).abs().max())
        if not diff <= 1e-2 * scale:  # as the llama-7b executor path's bf16
            raise AssertionError(f"{arch} executor bf16: max|shard_map - dense| = {diff:.3e} "
                                 f"> 1e-2 x max|logit| {scale:.3f}")
        log("zoo-executor", f"{arch} prefill graph (b=4, s={seq}), bf16: {len(g.nodes)} nodes, "
                            f"launches {launches} by design {designs}; weights of the products "
                            f"{mm_shapes}; max|shard_map - dense| {diff:.3e} (max|logit| "
                            f"{scale:.3f}, tol 1e-2 x that); profiled wall {prof['wall_ms']:.3f} "
                            f"ms, device busy {prof['device_ms']:.3f} ms (idle share "
                            f"{prof['idle_share']:.3f}); device ms by kind {prof['by_kind_ms']}")
        out[arch] = {"seq": seq, "launches": launches, "designs": designs,
                     "max_abs_logit_diff": diff, "max_abs_logit": scale,
                     "product_weights": [list(t) for t in mm_shapes], "profile": prof}
        del feeds, got, want, run, dense
        torch.cuda.empty_cache()
    return out


ENGINE_F32_TOL = 1e-4  # x max|logit|: float32 sums in another order (phase 22's)


def _engine_f32_full(cfg, ops, *, slots: int, block: int, max_seq: int, lens: list[int],
                     max_new: int, seed: int = 28) -> dict:
    """Phase 28 (cont.): ``cfg`` at full width and depth in float32 through
    the engine on the card (each bucketed prefill's flash launch of the
    ffma design at head dim 64), every request held against ``serve()`` of
    it alone on the card, teacher-forced on the engine's tokens: logits
    within ENGINE_F32_TOL x max|logit| at every position, no token flip the
    two runs' difference does not explain.  Where bf16 rounding is
    amplified through the layers, this pins the engine's function."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tf.init_params(cfg32, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    eng = ServingEngine(cfg32, batch=slots, max_seq=max_seq, block=block, params=params,
                        device="cuda")
    rec, _ = _record_logits(eng)
    for p in prompts:
        eng.submit(p, max_new)
    ops.reset_launch_counts()
    res, m = eng.run()
    launches, designs = ops.launch_counts(), ops.design_counts()
    assert launches["flash_attention"] == _attn_layers(cfg) * m.prefills, launches
    assert designs["flash_attention"]["ffma"] == launches["flash_attention"], designs
    seq = [_sequential(cfg32, params, p, max_new, eng.seq, "cuda", force=res[rid])
           for rid, p in enumerate(prompts)]
    held = [_hold_against_sequential(f"{cfg.name} f32 request {rid} (prompt {len(p)})",
                                     res[rid], rec[rid], seq[rid][1],
                                     seq[(rid + 1) % len(prompts)][1], limit=ENGINE_F32_TOL)
            for rid, p in enumerate(prompts)]
    failures = [f for h in held for f in h["failures"]]
    assert not failures, failures
    assert min(h["min_rel_diff_to_other_request"] for h in held) > ENGINE_F32_TOL, held
    log("engine", f"{cfg.name} float32, full width and depth, {slots} slots, prompts {lens}, "
                  f"{max_new} new: against serve() of each request alone, max|logit diff| / "
                  f"max|logit| {[format(h['max_rel_logit_diff'], '.2e') for h in held]} (limit "
                  f"{ENGINE_F32_TOL}), token flips {[h['flips'] for h in held]}; launches "
                  f"{launches}, flash by design {designs['flash_attention']}")
    del eng, params
    torch.cuda.empty_cache()
    return {"prompt_lens": lens, "max_new": max_new, "against_sequential": held,
            "launches": launches, "designs": designs,
            "generations": {r: res[r].tolist() for r in res}}


# ---------------------------------------------------------------------------
# 36. the six zoo configs that had never run on the card (run after 28)
# ---------------------------------------------------------------------------

# the layers each config is served with at full width, None for all of
# them: mixtral-8x7b (93.41 GB in bf16) and qwen1.5-110b (222.42 GB) do not
# fit one card whole; at 8 layers they take 23.74 and 26.73 GB
DENSE_SERVES = {"minicpm-2b": None, "musicgen-large": None, "nemotron-4-15b": None,
                "yi-9b": None, "mixtral-8x7b": 8, "qwen1.5-110b": 8}
# 36(b): b=1 and a short sequence, so that the float32 vocabulary heads (up
# to 256,000 x 6,144) stay cheap on the host
DENSE_SLICE_SEQ = 128
# 36(c): the non-gated squared-ReLU FFN at 6144 x 24576, and the tied head
DENSE_EXECUTOR_CASES = (("nemotron-4-15b", 512), ("minicpm-2b", 512))


def _prefill_case(cfg, dt=torch.bfloat16) -> tuple:
    """The attention of ``cfg``'s prefill at b=4, s=512, causal: (b, hq,
    hkv, sq, sk, d, causal, window, dtype); a window no shorter than the
    prompt does not bind (mixtral's 4096), so the case is plain causal."""
    window = cfg.window if 0 < cfg.window < 512 else 0
    return (4, cfg.n_heads, cfg.n_kv_heads, 512, 512, cfg.hd, True, window, dt)


def _dense_flash(fa, ops, ref) -> dict:
    """36(d): the forward kernel at each config's prefill attention (b=4,
    s=512), bf16 (the wgmma design) and float32 (the ffma design), against
    its plain version; then the bf16 layouts timed beside SDPA as phase 23
    times the zoo's."""
    from repro_torch.configs import get_config

    parity = []
    for arch in DENSE_SERVES:
        for dt in (torch.bfloat16, torch.float32):
            case = _prefill_case(get_config(arch), dt=dt)
            q, k, v, kw = _inputs(case, seed=36)
            got, design = _served_by(ops, "flash_attention", lambda: ops.flash_attention(
                q, k, v, impl="kernel", **kw))
            assert design == fa.design(q, k, v) == _expected_flash_design(case), (arch, design)
            err = _max_err(got, ref.attention(q, k, v, **kw), TOL[dt],
                           f"flash at {arch}'s prefill {case[:8]} {dt}")
            parity.append({"arch": arch, "case": str(case), "design": design,
                           "max_abs_err": err})
            log("dense-flash", f"{arch} {case[:8]} {dt} (GQA {case[1] // case[2]}:1) "
                               f"[{design}]: max|kernel - plain| = {err:.3e} (tol {TOL[dt]}) ok")
            del q, k, v, got
    torch.cuda.empty_cache()
    timing = _zoo_flash_timing(fa, ops, ref, {arch: _prefill_case(get_config(arch))
                                              for arch in DENSE_SERVES})
    return {"parity": parity, "timing": timing}


def _dense_serve(ops) -> dict:
    """36(a): each config served as phase 5 serves llama-7b (bf16, b=4,
    prompt 512, 16 new, seed-0 weights), one at a time."""
    from repro_torch.configs import get_config

    out = {}
    for arch, layers in DENSE_SERVES.items():
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        depth = (f"all {full.n_layers} layers" if cfg.n_layers == full.n_layers else
                 f"{cfg.n_layers} of its {full.n_layers} layers, cut for one card (whole "
                 f"{2 * full.param_count() / 1e9:.2f} GB in bf16, cut "
                 f"{2 * cfg.param_count() / 1e9:.2f} GB)")
        log("dense-serve", f"{arch}: full width, {depth}; {cfg.n_heads} query heads over "
                           f"{cfg.n_kv_heads} KV heads of {cfg.hd}, {cfg.act} FFN "
                           f"{'gated' if cfg.gated_ffn else 'not gated'} {cfg.d_model} x "
                           f"{cfg.d_ff}, tied embeddings {cfg.tie_embeddings}, qkv bias "
                           f"{cfg.qkv_bias}, vocabulary {cfg.vocab} padded to "
                           f"{cfg.vocab_padded}")
        if cfg.window:
            log("dense-serve", f"{arch}: its window of {cfg.window} does not bind at prompt "
                               f"512 + 16 new (phase 24's hymba is where a window binds)")
        t0 = time.perf_counter()
        res = _serve_phase(cfg, ops)
        per_layer = (3 if cfg.gated_ffn else 2) if cfg.moe else 0
        assert res["launches_per_prefill"]["flash_attention"] == cfg.n_layers, res
        assert res["launches_per_prefill"]["gmm"] == per_layer * cfg.n_layers, res
        assert res["launches_per_decode_step"]["gmm"] == per_layer * cfg.n_layers, res
        # the decode graph's logits bit-equal to the eager step's, every step
        assert res["graph_against_eager"]["max_abs_logit_diff"] == 0.0, res["graph_against_eager"]
        res.update({"layers": cfg.n_layers, "layers_whole": full.n_layers,
                    "phase_s": time.perf_counter() - t0})
        log("dense-serve", f"{arch} in {res['phase_s']:.1f} s")
        out[arch] = res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _logits_loss_grads(cfg, params, batch_np: dict, ops) -> dict:
    """``forward``'s logits (with the batch's prefix embeddings, if any),
    ``loss_fn`` and its gradient leaves (left on the parameters' device) at
    ``params`` as they lie, with the kernels' launches of the forward and
    of the loss with its backward."""
    from repro_torch.core import tree
    from repro_torch.models import transformer as tf

    leaves = tree.leaves(params)
    batch = {k: torch.as_tensor(v, device=leaves[0].device) for k, v in batch_np.items()}
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _, _ = tf.forward(params, batch["tokens"], cfg,
                                  prefix_embeds=batch.get("prefix_embeds"))
    fwd = ops.launch_counts()
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tf.loss_fn(params, batch, cfg)  # remat on: the reference's default
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    total = ops.launch_counts()
    return {"logits": logits.float().cpu(), "loss": float(loss.detach()), "grads": grads,
            "launches": {k: (fwd[k], total[k] - fwd[k]) for k in ("flash_attention", "gmm")},
            "designs": ops.design_counts()}


def _dense_slice_parity(ops) -> dict:
    """36(b): each config at full width, 2 layers, float32, b=1, s =
    DENSE_SLICE_SEQ, weights from seed 36 made on the card and copied to
    the host: the card (the kernels) against the CPU (the plain path), as
    phase 27: the logits (ZOO_TOL x max|logit|), the loss (ZOO_TOL
    relative) and every gradient leaf (ZOO_GRAD_TOL x its max|g|), all
    finite."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree
    from repro_torch.models import transformer as tf

    cfgs = {arch: dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
            for arch in DENSE_SERVES}
    # one page-locked buffer as large as the largest slice takes each copy
    # to the host: a pageable copy into fresh pages ran at 2.4 GB/s
    flat = torch.empty(max(sum(t.numel() for t in tree.leaves(tf.init_params(c, device="meta")))
                           for c in cfgs.values()), pin_memory=True)
    out = {}
    for arch, cfg in cfgs.items():
        t0 = time.perf_counter()
        params = tf.init_params(cfg, seed=36, device="cuda")
        toks = np.random.default_rng(36).integers(0, cfg.vocab, size=(1, DENSE_SLICE_SEQ))
        batch = {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
        card = _logits_loss_grads(cfg, params, batch, ops)
        torch.cuda.synchronize()
        walls = {"card": time.perf_counter() - t0}
        t0 = time.perf_counter()
        host = _host_views(flat, params)  # the same weights on the host
        del params
        walls["copy"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = _logits_loss_grads(cfg, host, batch, ops)
        walls["cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the forward, then the loss's forward and its remat recompute
        gmm_fwd = ((3 if cfg.gated_ffn else 2) * cfg.n_layers) if cfg.moe else 0
        assert card["launches"] == {"flash_attention": (2, 4), "gmm": (gmm_fwd, 2 * gmm_fwd)}, (
            arch, card["launches"])
        assert cpu["launches"] == {"flash_attention": (0, 0), "gmm": (0, 0)}, cpu["launches"]
        for kernel, n in (("flash_attention", 6), ("gmm", 3 * gmm_fwd)):
            assert card["designs"][kernel]["ffma"] == n, (arch, card["designs"])
        assert card["logits"].shape == (1, DENSE_SLICE_SEQ, cfg.vocab_padded)
        assert bool(torch.isfinite(card["logits"]).all()), arch
        scale = float(cpu["logits"].abs().max())
        lg_err = float((card["logits"] - cpu["logits"]).abs().max()) / scale
        loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        g_errs = []
        for g, c in zip(card["grads"], cpu["grads"]):  # leaf by leaf, on the card
            c = c.to("cuda")
            assert bool(torch.isfinite(g).all()), arch
            g_errs.append(float((g - c).abs().max()) / max(float(c.abs().max()), 1e-30))
            del c
        walls["compare"] = time.perf_counter() - t0
        names = [f"leaf {i} {tuple(c.shape)}" for i, c in enumerate(cpu["grads"])]
        worst = max(range(len(g_errs)), key=lambda i: g_errs[i])
        log("dense-parity", f"{arch} width, 2 layers, f32, b=1, s={DENSE_SLICE_SEQ}: max|logit "
                            f"diff| / max|logit| {lg_err:.3e} (limit {ZOO_TOL}); loss card "
                            f"{card['loss']:.7f} CPU {cpu['loss']:.7f} (relative "
                            f"{loss_err:.3e}); {len(g_errs)} gradient leaves, worst "
                            f"{names[worst]} at {g_errs[worst]:.3e} of its max|g| (limit "
                            f"{ZOO_GRAD_TOL}); launches (forward, loss and grad) "
                            f"{card['launches']}, flash by design "
                            f"{card['designs']['flash_attention']}; walls (weights made and the "
                            f"card's half, their copy to the host, the host's half, the "
                            f"gradients compared on the card) "
                            f"{ {k: round(v, 1) for k, v in walls.items()} } s")
        assert lg_err <= ZOO_TOL and loss_err <= ZOO_TOL, (arch, lg_err, loss_err)
        assert g_errs[worst] <= ZOO_GRAD_TOL, (arch, names[worst], g_errs[worst])
        out[arch] = {"seq": DENSE_SLICE_SEQ, "logit_rel_err": lg_err, "loss": card["loss"],
                     "loss_rel_err": loss_err, "grad_rel_errs": g_errs,
                     "launches": card["launches"],
                     "designs": {k: card["designs"][k] for k in ("flash_attention", "gmm")},
                     "walls_s": walls}
        del card, cpu, host
        gc.collect()
        torch.cuda.empty_cache()
    del flat
    return out


def _host_views(flat, params) -> dict:
    """``params`` copied into views of the page-locked float32 ``flat``,
    leaf after leaf: a tree of host tensors of their shapes."""
    from repro_torch.core import tree

    off = 0

    def one(t):
        nonlocal off
        view = flat[off:off + t.numel()].view(t.shape).detach()
        off += t.numel()
        return view.copy_(t, non_blocking=True)

    host = tree.map(one, params)
    torch.cuda.synchronize()
    return host


def _dense_zoo_phase(fa, ops, ref) -> dict:
    """Phase 36: (d) the flash layouts, (a) the serves, (b) the 2-layer
    float32 slices card against CPU, (c) two prefill graphs through the
    shard_map executor (see the module doc)."""
    res, walls = {}, {}
    for part, run in (("flash", lambda: _dense_flash(fa, ops, ref)),
                      ("serve", lambda: _dense_serve(ops)),
                      ("parity", lambda: _dense_slice_parity(ops)),
                      ("executor", lambda: _zoo_executor(ops, DENSE_EXECUTOR_CASES))):
        t0 = time.perf_counter()
        res[part] = run()
        walls[part] = time.perf_counter() - t0
    res["walls_s"] = walls
    log("dense", f"phase 36's parts' walls {({k: round(v, 1) for k, v in walls.items()})} s")
    return res


# ---------------------------------------------------------------------------
# 29. the pipelined path
# ---------------------------------------------------------------------------

# (stages, microbatches) -> the reference's static schedule of llama-7b's
# prefill graph (24 nodes, 14 computed; the JAX package, on the CPU): nodes
# a stage, handoff elems, static bubble
PIPE_CASES = {(1, 1): ([14], 0, 0.0), (2, 1): ([7, 7], 16_777_216, 0.5),
              (2, 4): ([7, 7], 16_777_216, 0.2),
              (4, 2): ([1, 6, 6, 1], 100_663_296, 0.6)}
PIPE_DTYPES = ("float32", "bfloat16")
# rank 0's logits against the dense one-card run, of max|logit|: phase 10's
PIPE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def pipeline_rank(rank: int, world: int, cases: list) -> dict:
    """One gloo rank of the pipelined path (run by ``launch.mesh.spawn``,
    or called as rank 0 of 1): each (p, m) of ``cases`` (p = world)
    compiled with ``pipeline=`` and as its baseline, the unpipelined
    compile of the stitched plan on the same mesh; then in each of
    ``PIPE_DTYPES`` the pipelined call with the launch counters set to 0
    just before and read just after, the baseline, and on rank 0 the dense
    run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for
    from repro_torch.pipeline import PipelineSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    mesh = Mesh({"pp": world}, device="cuda:0")
    res = {}
    for p, m in cases:
        run = prog.compile(mesh=mesh, executor="shard_map",
                           pipeline=PipelineSpec(stages=p, microbatches=m))
        base = prog.compile(mesh=mesh, executor="shard_map",
                            plan=run.pipeline_schedule.stitched)
        trace = sorted((e.nid, e.kind, e.axes, e.elems) for e in run.collectives.events)
        for name in PIPE_DTYPES:
            feeds = _graph_feeds(prog.graph, cfg, getattr(torch, name), seed=7)
            with torch.inference_mode():
                run(feeds)  # warm-up
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                got = run(feeds)["logits"]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches, designs = ops.launch_counts(), ops.design_counts()
                issued = sorted(run._fn.issued)
                want = base(feeds)["logits"]
                out = {"launches": launches, "designs": designs, "wall_s": wall,
                       "bit_equal": bool(torch.equal(got, want)),
                       "max_abs_diff_stitched": float((got.float() - want.float()).abs().max()),
                       "issued_is_trace": issued == trace,
                       "issued": sorted({(e[1], e[2]) for e in issued}),
                       "handoff_bytes": sum(e[3] for e in issued if e[2] == ("pp",))
                       * got.element_size(),
                       "shape": tuple(got.shape), "finite": bool(torch.isfinite(got).all())}
                del want
                if rank == 0:  # against the dense run of the same feeds on the card
                    dense = prog.compile(device="cuda:0")(feeds)["logits"].float()
                    out["max_abs_logit"] = float(dense.abs().max())
                    out["max_abs_logit_diff"] = float((got.float() - dense).abs().max())
                    del dense
            res[(p, m, name)] = out
            del feeds, got
            torch.cuda.empty_cache()
    return res


def _pipeline_path(cfg) -> dict:
    """llama-7b's prefill graph through ``compile(pipeline=)`` on 1, 2 and
    4 gloo ranks sharing the card (see the module doc, phase 29)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.eingraphs import program_for
    from repro_torch.pipeline import PipelineSpec, build_pipeline_schedule

    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    assert (len(g.nodes), sum(n.kind != "input" for n in g.nodes)) == (24, 14)
    static = {}
    for (p, m), want in PIPE_CASES.items():
        ps = build_pipeline_schedule(g, PipelineSpec(stages=p, microbatches=m), {"pp": p},
                                     [prog._out["logits"]])
        got = ([len(st.nids) for st in ps.stages], ps.handoff_elems, round(ps.bubble, 12))
        assert got == want, ((p, m), got, want)
        static[f"p{p}m{m}"] = {"stage_nodes": got[0], "handoff_elems": got[1], "bubble": got[2],
                               "bubble_weighted": ps.bubble_weighted}
    torch.cuda.empty_cache()  # the ranks share this card
    t0 = time.perf_counter()
    ranks = {1: [pipeline_rank(0, 1, [(1, 1)])]}  # one rank: no process group

    def run(p, tmp):
        return spawn(p, pipeline_rank, [c for c in PIPE_CASES if c[0] == p], tmpdir=tmp,
                     backend="gloo", timeout=400)

    # p = 2 and p = 4 side by side since phase 36 came (the run's time
    # limit): 37.4 s one after the other, 18.2 s side by side (one H100)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        started = {p: pool.submit(run, p, Path(tmp) / f"p{p}") for p in (2, 4)}
        ranks.update({p: f.result() for p, f in started.items()})
    t_all = time.perf_counter() - t0
    designs_total = {k: dict.fromkeys(DESIGNS_ALL, 0) for k in ("flash_attention", "matmul")}
    res = {"static": static, "wall_s": t_all}
    for (p, m), (sizes, elems, bubble) in PIPE_CASES.items():
        for name in PIPE_DTYPES:
            per_rank = [r[(p, m, name)] for r in ranks[p]]
            design = "wgmma" if name == "bfloat16" else "ffma"
            for r in per_rank:
                assert r["bit_equal"], ((p, m, name), r["max_abs_diff_stitched"])
                assert r["launches"] == {"flash_attention": m, "flash_attention_step": 0,
                                         "matmul": 8 * m, "gmm": 0}, r["launches"]
                for k, total in designs_total.items():
                    assert r["designs"][k][design] == r["launches"][k], r["designs"]
                    for d, n in r["designs"][k].items():
                        total[d] += n
                assert r["issued_is_trace"], ((p, m, name), r["issued"])
                assert r["issued"] == ([] if p == 1 else [("ppermute", ("pp",))]), r["issued"]
                assert r["finite"] and r["shape"] == (4, 512, cfg.vocab_padded), r["shape"]
            r0 = per_rank[0]
            scale, diff = r0["max_abs_logit"], r0["max_abs_logit_diff"]
            if not diff <= PIPE_TOL[name] * scale:
                raise AssertionError(f"pipelined p={p} m={m} {name}: max|pipelined - dense| = "
                                     f"{diff:.3e} > {PIPE_TOL[name]} x max|logit| {scale:.3f}")
            log("pipeline", f"p={p} m={m} {name}: stages of {sizes} nodes, bubble {bubble}, "
                            f"handoff {elems} elems, {r0['handoff_bytes']} B a call; every rank's "
                            f"logits bit-equal to the stitched plan's compile; launches per rank "
                            f"{r0['launches']} by design {r0['designs']}; collectives issued "
                            f"{r0['issued']} (the static trace); max|pipelined - dense| = "
                            f"{diff:.3e} (max|logit| {scale:.3f}, tol {PIPE_TOL[name]} x that); "
                            f"rank walls {[round(r['wall_s'], 4) for r in per_rank]} s "
                            f"(host-staged gloo, not a speed path)")
            res[f"p{p}m{m}_{name}"] = {
                "launches_per_rank": [r["launches"] for r in per_rank],
                "designs_per_rank": [r["designs"] for r in per_rank],
                "bit_equal_per_rank": [r["bit_equal"] for r in per_rank],
                "issued": r0["issued"], "handoff_bytes": r0["handoff_bytes"],
                "max_abs_logit_diff": diff, "max_abs_logit": scale, "tol_rel": PIPE_TOL[name],
                "wall_s": [r["wall_s"] for r in per_rank]}
    for k, total in designs_total.items():
        assert total["template"] == 0, designs_total
    res["designs_total"] = designs_total
    log("pipeline", f"every case, every rank in {t_all:.1f} s; launches by design {designs_total}")
    return res


# ---------------------------------------------------------------------------
# 30. the static verifier on the card
# ---------------------------------------------------------------------------

# the memory pass's peak against the allocator's: the reference's own band
# against XLA (tests/test_analysis.py)
MEM_BAND = 0.10


def _retyped(g, dtype):
    """A copy of EinGraph ``g`` whose float nodes are typed ``dtype``."""
    from repro_torch.core.einsum import EinGraph

    out = EinGraph(g.name)
    out.nodes = [dataclasses.replace(n, dtype=dtype) if np.dtype(n.dtype).kind == "f" else n
                 for n in g.nodes]
    return out


def _allocator_peak(call, feeds) -> tuple:
    """``call()``'s result, and the allocator's peak over it less what was
    allocated before it and is not one of ``feeds``: what the call adds to
    its arguments, plus the arguments, as the memory pass counts."""
    feed_bytes = sum(t.nbytes for t in feeds.values() if torch.is_tensor(t) and t.is_cuda)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, {"measured_bytes": peak - (before - feed_bytes), "feed_bytes": feed_bytes,
                 "allocated_before": before, "max_memory_allocated": peak}


def _memory_check(what: str, static: dict, measured: dict) -> dict:
    ratio = static["peak_bytes"] / measured["measured_bytes"]
    log("analysis", f"{what}: memory pass peak {static['peak_bytes']} B (args "
                    f"{static['args_bytes']}, outputs {static['out_bytes']}, at node "
                    f"{static['peak_pos']}); allocator {measured['measured_bytes']} B "
                    f"(max_memory_allocated {measured['max_memory_allocated']} less "
                    f"{measured['allocated_before'] - measured['feed_bytes']} B held before the "
                    f"call that are not its feeds); static / measured {ratio:.4f}")
    assert abs(ratio - 1.0) <= MEM_BAND, (what, ratio, static["peak_bytes"], measured)
    return {"static_peak_bytes": static["peak_bytes"], "static_args_bytes": static["args_bytes"],
            "static_out_bytes": static["out_bytes"], "static_peak_pos": static["peak_pos"],
            **measured, "ratio": ratio}


def _analysis_phase(cfg, results: dict) -> dict:
    """(a) the analysis CLI over the zoo in a subprocess; (b) the memory
    pass against the allocator; (c) phase 20's registry (see the module
    doc, phase 30)."""
    import os

    from repro_torch.analysis import analyze_compiled
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.frontend import Program
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = out_dir / "analysis_zoo.json"
    snippet = ("import sys, torch\n"
               "from repro_torch.analysis.__main__ import main\n"
               f"rc = main(['--json', {str(report)!r}])\n"
               "print('cuda initialised:', torch.cuda.is_initialized(), '; jax imported:',\n"
               "      'jax' in sys.modules)\n"
               "assert not torch.cuda.is_initialized() and 'jax' not in sys.modules\n"
               "sys.exit(rc)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", snippet], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
                          cwd=str(ROOT))
    t_cli = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(report.read_text())
    assert payload["n_errors"] == payload["n_warnings"] == 0 and len(payload["cells"]) == 11
    tail = proc.stdout.strip().splitlines()[-3:]
    log("analysis", f"python -m repro_torch.analysis over the reduced zoo: exit 0 in {t_cli:.1f} s, "
                    f"{len(payload['cells'])} cells, 0 findings; {tail}")
    res = {"cli": {"exit": proc.returncode, "cells": len(payload["cells"]), "wall_s": t_cli,
                   "tail": tail}}

    # (b) phase 10's one-rank compile of llama-7b's prefill graph, f32 and bf16
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    memory = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        p = prog if dt == torch.float32 else Program.from_graph(_retyped(prog.graph, dt),
                                                                prog._out)
        run = p.compile(mesh=mesh, executor="shard_map")
        feeds = _graph_feeds(prog.graph, cfg, dt, seed=7)
        with torch.inference_mode():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            gc.collect()
            logits, measured = _allocator_peak(lambda: run(feeds), feeds)
        del logits
        memory[f"executor_{name}"] = _memory_check(
            f"llama-7b prefill graph, one rank, {name}", analyze_compiled(run).memory, measured)
        del feeds, run
        torch.cuda.empty_cache()
    memory["ffnn"] = _memory_check("FFNN gradient program at AmazonCat-14K sizes, float32",
                                   results["ffnn"]["memory"]["static"],
                                   results["ffnn"]["memory"]["measured"])
    res["memory"] = memory

    # (c) the engine's bucket registry of phase 20 (analysed there, before it went)
    for phase in ("engine", "engine_moe", "engine_hymba"):
        cells = results[phase]["registry_analysis"]
        assert cells and all(c["findings"] == [] for c in cells.values()), (phase, cells)
        log("analysis", f"{phase}'s BucketRegistry.analyze(): {len(cells)} live buckets, all "
                        f"clean; peak bytes a bucket "
                        f"{ {k: c['peak_bytes'] for k, c in cells.items()} }")
    res["registry"] = {phase: results[phase]["registry_analysis"]
                       for phase in ("engine", "engine_moe", "engine_hymba")}
    return res


# ---------------------------------------------------------------------------
# 31. the gspmd executor on DTensor, and llama-7b trained and served on a mesh
# ---------------------------------------------------------------------------

GSPMD_MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}
# every rank's logits against the one-card dense run and the shard_map run
# on the same mesh, relative to max|logit|: phase 10's limits
GSPMD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def gspmd_rank(rank: int, world: int, sizes: dict) -> dict:
    """One gloo rank of phase 31(a): phase 10's llama-7b prefill graph
    through ``executor="gspmd"`` on ``sizes``, in both dtypes, counted and
    held against the shard_map run on the same mesh and the dense run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.core.engine import spec_for_node
    from repro_torch.core.gspmd import comm_summary
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    mesh = Mesh(sizes, device="cuda:0")
    run = prog.compile(mesh=mesh, executor="gspmd")
    sm = prog.compile(mesh=mesh, executor="shard_map")
    dense = prog.compile(device="cuda:0")
    specs = [spec_for_node(n, run.plan.axes_by_node.get(n.nid, {})) for n in g.nodes]
    res = {"n_mm": sum(1 for n in g.nodes if n.kind == "einsum" and spmd._as_matmul(n.spec)),
           "policy": {l: list(a) for l, a in run.policy().label_axes.items()},
           "two_axis_nodes": sum(1 for sp in specs if any(isinstance(e, tuple) for e in sp)),
           "collectives": run.collectives,
           "static": {"counts": sm.collectives.counts,
                      "bytes": sm.collectives.bytes_by_kind}}
    for name in RING_DTYPES:
        feeds = _graph_feeds(g, cfg, getattr(torch, name), seed=7)
        with torch.no_grad():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            run._fn.log_comms = True
            t0 = time.perf_counter()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run._fn.log_comms = False
            out = {"launches": ops.launch_counts(), "designs": ops.design_counts(),
                   "wall_s": wall, "comms": comm_summary(run._fn.comms),
                   "shape": list(got.shape), "dtype": str(got.dtype),
                   "finite": bool(torch.isfinite(got).all())}
            got = got.float()
            want = dense(feeds)["logits"].float()
            out["max_abs_logit"] = float(want.abs().max())
            out["diff_dense"] = float((got - want).abs().max())
            del want
            out["diff_shard_map"] = float((got - sm(feeds)["logits"].float()).abs().max())
        res[name] = out
        del feeds, got
        torch.cuda.empty_cache()
    return res


def _gspmd_executor(ops) -> dict:
    """Phase 31(a): both meshes' spawns side by side (for the
    run's time limit), so their rank walls are taken beside each other's."""
    from repro_torch.launch.mesh import spawn

    def run(sizes, tmp):
        t0 = time.perf_counter()
        ranks = spawn(4, gspmd_rank, sizes, tmpdir=tmp, backend="gloo", timeout=600)
        return ranks, time.perf_counter() - t0

    res = {}
    torch.cuda.empty_cache()  # the ranks share this card
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(GSPMD_MESHES)) as pool:
        started = {m: pool.submit(run, sizes, Path(tmp) / m) for m, sizes in GSPMD_MESHES.items()}
        spawned = {m: f.result() for m, f in started.items()}
    for mesh_id, (ranks, t_spawn) in spawned.items():
        r0 = ranks[0]
        assert r0["collectives"] is None  # the reference's gspmd has no static trace
        if mesh_id == "2x2":  # llama-7b's plan: f and v on both axes
            assert r0["policy"]["f"] == r0["policy"]["v"] == ["data", "model"], r0["policy"]
            assert r0["two_axis_nodes"] > 0
        out = {"spawn_s": t_spawn, "policy": r0["policy"],
               "two_axis_nodes": r0["two_axis_nodes"], "static": r0["static"]}
        for name in RING_DTYPES:
            design = "wgmma" if name == "bfloat16" else "ffma"
            per_rank = [r[name] for r in ranks]
            for rank, r in enumerate(per_rank):
                assert r["launches"] == {"flash_attention": 1, "flash_attention_step": 0,
                                         "matmul": r0["n_mm"], "gmm": 0}, (rank, r["launches"])
                for kernel in ("flash_attention", "matmul"):
                    assert r["designs"][kernel][design] == r["launches"][kernel], r["designs"]
                assert r["finite"] and r["shape"][:2] == [4, 512], r
                tol = GSPMD_TOL[name] * r["max_abs_logit"]
                for what in ("diff_dense", "diff_shard_map"):
                    if not r[what] <= tol:
                        raise AssertionError(f"gspmd {mesh_id} {name} rank {rank}: {what} "
                                             f"{r[what]:.3e} > {GSPMD_TOL[name]} x max|logit| "
                                             f"{r['max_abs_logit']:.3f}")
                assert r["comms"] == per_rank[0]["comms"], (rank, r["comms"])
            r = per_rank[0]
            log("gspmd", f"{mesh_id} {name}: llama-7b prefill graph (b=4, s=512, one block "
                         f"period) on 4 gloo ranks sharing the card; policy {r0['policy']}, "
                         f"{r0['two_axis_nodes']} nodes with a label on two axes; launches "
                         f"per rank {r['launches']} by design {r['designs']}; max|gspmd - "
                         f"dense| {max(x['diff_dense'] for x in per_rank):.3e}, max|gspmd - "
                         f"shard_map| {max(x['diff_shard_map'] for x in per_rank):.3e} "
                         f"(max|logit| {r['max_abs_logit']:.3f}, tol {GSPMD_TOL[name]} x "
                         f"that); DTensor issued a rank {r['comms']}; shard_map's static "
                         f"trace {r0['static']}; rank walls "
                         f"{[round(x['wall_s'], 3) for x in per_rank]} s (host-staged gloo, "
                         f"not a speed path)")
            out[name] = {"launches_per_rank": [x["launches"] for x in per_rank],
                         "designs_per_rank": [x["designs"] for x in per_rank],
                         "comms_per_rank": r["comms"],
                         "max_abs_logit": r["max_abs_logit"],
                         "max_diff_dense": max(x["diff_dense"] for x in per_rank),
                         "max_diff_shard_map": max(x["diff_shard_map"] for x in per_rank),
                         "tol_rel": GSPMD_TOL[name],
                         "wall_s": [x["wall_s"] for x in per_rank]}
        res[mesh_id] = out
    return res


# each cell: (arch, mesh, the plan its policy comes from); the llama cells
# of phase 31(b): data2 under reduced llama's plan at the same cell (the
# batch on "data": data parallel, the weights' feature dims stored on it,
# Partial gradients reduce-scattered into their shards), model2 under
# llama-7b's own (heads, d_model, ffn and vocab split)
MESH_TRAIN_CELLS = {"data2": ("llama-7b", {"data": 2}, "reduced"),
                    "model2": ("llama-7b", {"model": 2}, "own")}
# phase 33(d): the MoE, hymba and xLSTM blocks' steps; a dict is a manual
# policy: qwen2-moe expert parallel, its batch and its experts on "data"
# (tokens to the experts' rank by all-to-all), and its experts on "model".  The
# qwen2-moe cells (44 and 58 GB of the card for their two ranks) run in a
# spawn of their own beside hymba's and xlstm's serves, the others in one
# beside qwen2-moe's serve (``_block_mesh_phase``)
BLOCK_TRAIN_CELLS = {"hymba/data2": ("hymba-1.5b", {"data": 2}, "own"),
                     "xlstm/data2": ("xlstm-125m", {"data": 2}, "own"),
                     "qwen2-moe/data2": ("qwen2-moe-a2.7b", {"data": 2},
                                         {"b": "data", "e": "data"}),
                     "qwen2-moe/model2": ("qwen2-moe-a2.7b", {"model": 2}, {"e": "model"})}
# the cells whose collectives a CollectiveRecorder reads, for the dry run's
# comparison (phase 32(c), 33(f)): phase 31(b)'s in a second, untimed step
# on the same weights made again ("spare"); 33(d)'s MoE cells in their one
# step, whose wall no phase compares (a second step's weights and moments
# do not fit beside its neighbours on the card)
RECORDED_CELLS = {"data2": "spare", "model2": "spare", "qwen2-moe/data2": "step",
                  "qwen2-moe/model2": "step"}
# a 33(d) cell's second layout, run in the same spawn after its step: the
# forward and backward alone under {b: data} with the weights whole (each
# rank's own tokens through every expert), held to the one-rank step
EXPERTS_WHOLE = {"qwen2-moe/data2": {"b": "data"}}
MESH_TRAIN_LR = 1e-3
# a weight's AdamW step is held tight where its gradient clears this many
# times the gradients' tolerance (see mesh_train_rank)
ADAM_CLEAR = 30


def mesh_train_rank(rank: int, world: int, cells: dict) -> dict:
    """One gloo rank of phase 31(b) or 33(d): each cell's architecture at
    full width, ``TRAIN_CELL_LAYERS`` layers, float32, b=2, s=128.  Rank 0 first runs each
    architecture's one-rank step on the card alone (the others wait at a
    barrier), then every rank runs the sharded step of every cell; rank 0
    holds the loss, every gradient and every parameter after AdamW against
    the one-rank step."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.hlo_analysis import CollectiveRecorder
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.eingraphs import program_for
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False

    def value_grads_step(cfg, mesh, policy, record):
        """The loss, its gradients and the parameters after one step, all
        whole on the host (the card then holds one step's state at a
        time), the metrics, wall, peaks, collectives and launches."""
        params, batch, loss, grads = _loss_and_grads(cfg, mesh, policy)
        step = steps.make_train_step(cfg, policy=policy, mesh=mesh,
                                     lr_fn=lambda s: MESH_TRAIN_LR)
        # the step's own peak, as the dry run counts it: the arguments and
        # what the step allocates, less what else lies on the card
        args_bytes = sum(_block_bytes(t) for t in tree.leaves(params) + list(batch.values()))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - args_bytes
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rec = CollectiveRecorder()  # what the step issues: phase 32(c) reads it
        t0 = time.perf_counter()
        with _gmm_blocks() as blocks:
            with rec if record == "step" else contextlib.nullcontext():
                params, _, met = step(params, adamw_init(params), batch)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"launches": ops.launch_counts(), "designs": ops.design_counts(),
                    "gmm_blocks": sorted(blocks)}
        step_peak = torch.cuda.max_memory_allocated() - held
        peak = max(peak, torch.cuda.max_memory_allocated())
        after = [_rank0_host(p) for p in tree.leaves(params)]
        del params
        torch.cuda.empty_cache()
        if record == "spare":
            # a second step, untimed (the recorder's dispatch costs time), on
            # the same weights made again: the first updated its own in place
            spare = tf.init_placed_params(cfg, policy, mesh, seed=2)
            with rec:
                step(spare, adamw_init(spare), batch)
            del spare
            torch.cuda.empty_cache()
        return (loss, grads, after, met, wall, (peak, step_peak), rec.log.summary(),
                launches)

    refs = {}
    if rank == 0:
        one = Mesh({"data": 1}, device="cuda:0")
        for arch in sorted({arch for arch, _, _ in cells.values()}):
            cfg = _mesh_train_cfg(arch)
            pol1 = program_for(cfg, ShapeConfig("t", "train", 128, 2)).compile(
                mesh_axes={"data": 1}, device="cuda:0").policy()
            loss, grads, params, met, _, _, _, _ = value_grads_step(cfg, one, pol1, None)
            refs[arch] = {"loss": loss, "grads": grads, "params": params,
                          "grad_norm": float(met["grad_norm"])}
    dist.barrier()
    out = {}
    for cell, (arch, sizes, plan_of) in cells.items():
        mesh = Mesh(sizes, device="cuda:0")
        out[cell] = _sharded_step(rank, mesh, plan_of, _mesh_train_cfg(arch), refs.get(arch),
                                  lambda *a: value_grads_step(*a, RECORDED_CELLS.get(cell)))
        if cell in EXPERTS_WHOLE:
            out[cell]["experts_whole"] = _experts_whole_pass(
                rank, mesh, _mesh_train_cfg(arch), EXPERTS_WHOLE[cell], refs.get(arch))
    return out


@contextlib.contextmanager
def _gmm_blocks():
    """The set of (x, w) block shapes every ``ops.gmm`` call took meanwhile:
    the (E/r, C, .) blocks the MoE layer runs."""
    from repro_torch.kernels import ops

    gmm, blocks = ops.gmm, set()

    def tapped(x, w, **kw):
        blocks.add((tuple(x.shape), tuple(w.shape)))
        return gmm(x, w, **kw)

    ops.gmm = tapped
    try:
        yield blocks
    finally:
        ops.gmm = gmm


def _loss_and_grads(cfg, mesh, policy):
    """A train cell's weights (seed 2) and batch (b=2, s=128) placed by
    ``policy``, its loss and the loss's gradients, whole on rank 0's host:
    (params, batch, loss, grads)."""
    from repro_torch.core import tree
    from repro_torch.core.gspmd import full
    from repro_torch.data.synthetic import place_batch
    from repro_torch.models import transformer as tf

    toks = np.random.default_rng(31).integers(0, cfg.vocab, size=(2, 128)).astype(np.int32)
    params = tf.init_placed_params(cfg, policy, mesh, seed=2)
    batch = place_batch({"tokens": toks, "labels": toks}, policy, mesh)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = tf.loss_fn(params, batch, cfg, policy=policy, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    if mesh.world_size > 1:
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
    grads = [_rank0_host(g) for g in grads]
    for p in leaves:
        p.requires_grad_(False)
    return params, batch, float(full(loss).detach()), grads


def _experts_whole_pass(rank, mesh, cfg, manual, ref) -> dict:
    """Phase 33(d)'s qwen2-moe/data2 cell once more, the forward and
    backward alone, under ``manual`` with the weights whole on every rank
    (stored on ``data``, the expert width would be split there and the
    tokens gathered along it): each rank runs its own tokens through every
    expert, in capacity buffers as deep as its own kept entries.  The
    loss, the gmm blocks and, on rank 0, each gradient leaf against the
    one-rank step's."""
    from repro_torch.models.policy import manual_policy

    policy = manual_policy(manual)
    torch.cuda.synchronize()
    with _gmm_blocks() as blocks:
        params, batch, loss, grads = _loss_and_grads(cfg, mesh, policy)
        torch.cuda.synchronize()
    del params, batch
    torch.cuda.empty_cache()
    res = {"policy": {l: list(a) for l, a in policy.label_axes.items()}, "loss": loss,
           "gmm_blocks": sorted(blocks)}
    if rank == 0:
        res["grad_errs"] = [(float((g - w).abs().max()), float(w.abs().max()))
                            for g, w in zip(grads, ref["grads"])]
    return res


def _rank0_host(t):
    """``t`` whole on rank 0's host, None on the other ranks: a DTensor's
    blocks gathered to rank 0 as a checkpoint save gathers them (a copy to
    the host and ``dist.gather``; no rank holds the whole on its card), a
    tensor copied."""
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import _gather_leaf

    if hasattr(t, "device_mesh"):
        return _gather_leaf(t.detach(), dist.get_rank() == 0)
    return t.detach().cpu()


def _block_bytes(t) -> int:
    """Bytes of this rank's block of ``t`` (a DTensor or a tensor)."""
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.numel() * t.element_size()


# layers of a train cell (phase 31(b), 33(d), 35(a)): 2 (xlstm: one mLSTM
# and one sLSTM block); qwen2-moe 1, for the run's time limit
# (its cells were the longest part of phase 33); llama-7b 1, for the run's
# time limit once phase 36 came (35(a)'s spawns, which run beside phase
# 34, were the last phase's longest part: 102-116 s of them)
TRAIN_CELL_LAYERS = {"qwen2-moe-a2.7b": 1, "llama-7b": 1}


def _mesh_train_cfg(arch: str = "llama-7b"):
    """Phase 31(b)'s, 33(d)'s and 35(a)'s cell: full width,
    ``TRAIN_CELL_LAYERS`` layers (2 where it names none), float32 (b=2,
    s=128)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=TRAIN_CELL_LAYERS.get(arch, 2),
                               dtype="float32")


def _mesh_train_policy(cfg, axes: dict, plan_of):
    """The policy a train cell runs under on ``axes``: the plan of the
    reduced config (``"reduced"``) or of the cell's own (``"own"``), or a
    manual one (a dict); the weights stored on the data axes."""
    from repro_torch.configs import reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.eingraphs import fsdp_axes_for, program_for
    from repro_torch.models.policy import manual_policy

    if isinstance(plan_of, dict):
        return manual_policy(plan_of, fsdp_axes=fsdp_axes_for(axes))
    planned = reduced(cfg) if plan_of == "reduced" else cfg
    return program_for(planned, ShapeConfig("t", "train", 128, 2)).compile(
        mesh_axes=axes).policy(fsdp_axes=fsdp_axes_for(axes))


def _sharded_step(rank, mesh, plan_of, cfg, ref, value_grads_step) -> dict:
    policy = _mesh_train_policy(cfg, dict(mesh.sizes), plan_of)
    torch.cuda.reset_peak_memory_stats()
    loss, grads, params, met, wall, (peak, step_peak), issued, launches = \
        value_grads_step(cfg, mesh, policy)
    res = {"policy": {l: list(a) for l, a in policy.label_axes.items()},
           "fsdp": list(policy.fsdp_axes), "collectives": issued,
           "loss": loss, "grad_norm": float(met["grad_norm"]),
           "step_loss": float(met["loss"]), "step_wall_s": wall, "peak_bytes": peak,
           "step_peak_bytes": step_peak, **launches}
    if rank == 0:  # leaf by leaf on the card: a rank has one CPU thread
        dev = mesh.device
        grad_errs = []
        for g, w in zip(grads, ref["grads"]):
            g, w = g.to(dev), w.to(dev)
            grad_errs.append((float((g - w).abs().max()), float(w.abs().max())))
        param_errs = []
        clip = min(1.0, 1.0 / ref["grad_norm"])  # the step clips the norm to 1
        for p, w, g in zip(params, ref["params"], ref["grads"]):
            p, w, g = p.to(dev), w.to(dev), g.to(dev)
            # Adam's first step moves a weight by lr g/(|g| + 1e-8), g the
            # clipped gradient; a gradient error dg moves that by lr 1e-8 dg
            # / g^2, so where |g| clears 30 x the gradients' tolerance and
            # that move, dg the tolerance, stays under 1e-5 lr (not so for
            # small gradients: qwen2-moe's shared expert, PR 25), the step
            # agrees within 1e-4 lr; elsewhere its size and sign are
            # rounding (beyond one float32 ulp of the weight itself)
            gmax = float(g.abs().max())
            sure = ((g.abs() >= ADAM_CLEAR * TRAIN_TOL * gmax)
                    & (1e-8 * TRAIN_TOL * gmax <= 1e-5 * clip * g * g))
            d = (p - w).abs() - torch.finfo(torch.float32).eps * w.abs()
            param_errs.append((float(d[sure].max()) if bool(sure.any()) else 0.0,
                               float(d.max()), float(sure.float().mean())))
        res.update({"ref_loss": ref["loss"], "ref_grad_norm": ref["grad_norm"],
                    "grad_errs": grad_errs, "param_errs": param_errs})
    return res


def _mesh_train(cells: dict = MESH_TRAIN_CELLS) -> dict:
    from repro_torch.launch.mesh import spawn

    res = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:  # one spawn: every cell
        t0 = time.perf_counter()
        every = spawn(2, mesh_train_rank, cells, tmpdir=tmp, backend="gloo", timeout=900)
        t_spawn = time.perf_counter() - t0
    if cells is MESH_TRAIN_CELLS:  # two layouts: the batch split on data2, whole on model2
        assert every[0]["data2"]["policy"]["b"] == ["data"], every[0]["data2"]["policy"]
        assert every[0]["data2"]["fsdp"] == ["data"], every[0]["data2"]
        assert "b" not in every[0]["model2"]["policy"], every[0]["model2"]["policy"]
    for cell, (arch, sizes, plan_of) in cells.items():
        ranks = [r[cell] for r in every]
        r0 = ranks[0]
        if arch == "llama-7b":
            assert r0["ref_grad_norm"] > 1.0  # the clip (max norm 1) is active
        if isinstance(plan_of, dict):
            assert all(r0["policy"][l] == [a] for l, a in plan_of.items()), r0["policy"]
        for what, ref in (("loss", "ref_loss"), ("grad_norm", "ref_grad_norm"),
                          ("step_loss", "ref_loss")):
            err = abs(r0[what] - r0[ref]) / abs(r0[ref])
            assert err <= TRAIN_TOL, (cell, what, r0[what], r0[ref])
        assert ranks[1]["loss"] == r0["loss"], (ranks[1]["loss"], r0["loss"])
        worst_g = max(e / max(s, 1e-30) for e, s in r0["grad_errs"])
        assert worst_g <= TRAIN_TOL, (cell, r0["grad_errs"])
        worst_sure = max(e[0] for e in r0["param_errs"])
        worst_p = max(e[1] for e in r0["param_errs"])
        worst_frac = min(e[2] for e in r0["param_errs"])
        assert worst_sure <= 1e-4 * MESH_TRAIN_LR and worst_p <= 2 * MESH_TRAIN_LR, \
            r0["param_errs"]
        for r in ranks:  # float32: every gmm launch of the ffma design
            assert r["designs"]["gmm"]["ffma"] == r["launches"]["gmm"], (cell, r["designs"])
        kernels = {k: n for k, n in r0["launches"].items() if n}
        if _mesh_train_cfg(arch).moe:
            _moe_train_blocks(cell, arch, r0["policy"], ranks)
        if cell in EXPERTS_WHOLE:
            _experts_whole_check(cell, arch, [r["experts_whole"] for r in ranks],
                                 r0["ref_loss"])
        log("mesh-train", f"{cell}: {arch} width, {_mesh_train_cfg(arch).n_layers} "
                          f"layer(s), f32, b=2, s=128 on 2 gloo "
                          f"ranks sharing the card; policy {r0['policy']} ({plan_of} plan's "
                          f"if a word), fsdp {r0['fsdp']}; loss "
                          f"{r0['loss']:.7f} vs one rank {r0['ref_loss']:.7f}, grad norm "
                          f"{r0['grad_norm']:.6f} vs {r0['ref_grad_norm']:.6f} (clip at 1); "
                          f"worst gradient leaf {worst_g:.3e} of its max|g| (limit "
                          f"{TRAIN_TOL}); parameters after AdamW (lr {MESH_TRAIN_LR}): max "
                          f"|diff| beyond an ulp {worst_sure:.3e} where |g| clears {ADAM_CLEAR} x "
                          f"{TRAIN_TOL} x max|g| (limit 1e-4 x lr; at least {worst_frac:.4f} "
                          f"of each leaf), {worst_p:.3e} over all (limit 2 x lr); launches a "
                          f"rank a step {kernels} by design {r0['designs']}; step walls "
                          f"{[round(r['step_wall_s'], 2) for r in ranks]} s (collectives "
                          f"recorded: {RECORDED_CELLS.get(cell, 'no')}), peak "
                          f"{[r['peak_bytes'] for r in ranks]} B a rank, the step's own "
                          f"{[r['step_peak_bytes'] for r in ranks]} B; every cell in one spawn "
                          f"of {t_spawn:.1f} s")
        res[cell] = {"arch": arch, "policy": r0["policy"], "fsdp": r0["fsdp"],
                     "plan_of": plan_of,
                     "loss": r0["loss"], "ref_loss": r0["ref_loss"],
                     "grad_norm": r0["grad_norm"], "ref_grad_norm": r0["ref_grad_norm"],
                     "worst_grad_rel": worst_g, "worst_param_abs": worst_p,
                     "worst_param_abs_clear": worst_sure,
                     "min_share_clear": worst_frac,
                     "launches_per_rank": [r["launches"] for r in ranks],
                     "designs_per_rank": [r["designs"] for r in ranks],
                     "step_wall_s": [r["step_wall_s"] for r in ranks],
                     "peak_bytes": [r["peak_bytes"] for r in ranks],
                     "step_peak_bytes": [r["step_peak_bytes"] for r in ranks],
                     "spawn_s": t_spawn,
                     "collectives": r0["collectives"],
                     "collectives_per_rank": [r["collectives"] for r in ranks],
                     "gmm_blocks_per_rank": [r["gmm_blocks"] for r in ranks]}
    return res


def _moe_train_blocks(cell: str, arch: str, policy: dict, ranks: list) -> None:
    """Phase 33(d)'s MoE cells: every gmm a rank ran took its block of the
    experts, (E/2, C, .) where the experts are split; where the batch and
    the experts share an axis, the tokens moved by all-to-all on every
    rank.  Prints each rank's all-to-alls, gmm blocks and peak."""
    E = _mesh_train_cfg(arch).n_e
    e_blk = E // 2 if policy.get("e") else E
    a2a = [r["collectives"].get("all-to-all", {"count": 0, "bytes": 0}) for r in ranks]
    for r in ranks:
        assert r["gmm_blocks"] and all(x[0] == w[0] == e_blk for x, w in r["gmm_blocks"]), \
            (cell, r["gmm_blocks"])
    if set(policy.get("b", ())) & set(policy.get("e", ())):
        assert all(a["count"] >= 4 for a in a2a), (cell, a2a)  # forward and backward
    log("mesh-train", f"{cell}: all-to-alls a rank {[a['count'] for a in a2a]}, their "
                      f"result bytes {[a['bytes'] for a in a2a]}; gmm blocks a rank "
                      f"(x, w) {[r['gmm_blocks'] for r in ranks]}; the step's peak a rank "
                      f"{[r['step_peak_bytes'] for r in ranks]} B")


def _experts_whole_check(cell: str, arch: str, ranks: list, ref_loss: float) -> None:
    """The checks of ``_experts_whole_pass``: the loss and every gradient
    leaf of rank 0 against the one-rank step within ``TRAIN_TOL``, the
    ranks' losses equal, every gmm on all E experts at their whole width."""
    cfg = _mesh_train_cfg(arch)
    E, F = cfg.n_e, cfg.d_ff
    r0 = ranks[0]
    assert r0["policy"] == {"b": ["data"]}, r0["policy"]
    err = abs(r0["loss"] - ref_loss) / abs(ref_loss)
    assert err <= TRAIN_TOL, (cell, r0["loss"], ref_loss)
    assert ranks[1]["loss"] == r0["loss"], (ranks[1]["loss"], r0["loss"])
    worst_g = max(e / max(s, 1e-30) for e, s in r0["grad_errs"])
    assert worst_g <= TRAIN_TOL, (cell, r0["grad_errs"])
    for r in ranks:
        assert r["gmm_blocks"] and all(x[0] == w[0] == E and F in w[1:]
                                       for x, w in r["gmm_blocks"]), (cell, r["gmm_blocks"])
    log("mesh-train", f"{cell} under {r0['policy']}, weights whole (experts whole, forward "
                      f"and backward alone): loss {r0['loss']:.7f} vs one rank {ref_loss:.7f}, worst "
                      f"gradient leaf {worst_g:.3e} of its max|g| (limit {TRAIN_TOL}); gmm "
                      f"blocks a rank (x, w) {[r['gmm_blocks'] for r in ranks]}")


# what a serve cell runs: the architecture at full size (bf16) on a mesh
# of gloo ranks sharing the card, under the plan's policy (None) or a
# manual one; a float32 slice of its first layers on the same mesh
# llama-7b at 2 of its 32 layers, cut from 32 to 8, then to 4 (the run's
# time limit: phase 33 serves three more models this way, phase 35 came),
# then to 2 with its float32 slice (phase 36 came: 31(c) runs after 31(a)
# beside 31(b); its spawn took 81.1 s at 4 layers, 30.9 s at 2, one H100)
MESH_SERVE = {"arch": "llama-7b", "layers": 2, "mesh": {"data": 1, "model": 4},
              "policy": None, "b": 4, "prompt_len": 512, "max_new": 16,
              "slice_layers": 2, "max_share": 0.3, "floor_first": False}
# phase 33(a)-(c): qwen2-moe's experts on "model" (then serve(mesh=)'s own
# plan too), hymba at phase 24's prompt, xlstm data parallel
# At full depth in bf16 these three are chaotic: the one-rank bf16 run's
# logits differ from the same weights in float32 by 0.07 (xlstm) to 1.0
# (qwen2-moe, its top-4 routing flipping) of max|logit| from the first
# step on, and two bf16 runs as far apart as that at one step can be three
# times farther at another (chip_smoke, PR 25).  So these cells hold the
# bf16 run on the mesh to the float32 run: over all steps, no farther from
# it than twice the one-rank bf16 run is (``floor_first``), and a token
# flip to a top-2 margin under twice that; their float32 slices hold the
# blocks to 1e-4 at every step.
# qwen2-moe at 3 of its 24 layers, for the run's time limit: on one H100
# at 700 W the whole run took 1,276 s of its 1,200 at 24 layers, and up
# to 1,111 s at 12; at 6 with phase 35 added, 1,238-1,268 s (PERF.md).
# hymba at 8 of its 32 layers (phase 36 came): its serve and xlstm's run
# beside (d)'s qwen2-moe cells (44 and 58 GB of the card for their two
# ranks), which start once (a) and (e) are done; at 32 layers hymba's
# ranks held the host for 59 s of them (chip_smoke on one H100).  Each float32
# slice keeps 4 pattern units.
BLOCK_SERVES = {
    "qwen2-moe": dict(MESH_SERVE, arch="qwen2-moe-a2.7b", layers=3, slice_layers=4,
                      policy={"e": "model"}, own_policy=True, floor_first=True),
    "hymba": dict(MESH_SERVE, arch="hymba-1.5b", layers=8, slice_layers=4,
                  mesh={"data": 2, "model": 2}, prompt_len=2048, max_share=None,
                  floor_first=True),
    "xlstm": dict(MESH_SERVE, arch="xlstm-125m", layers=None, slice_layers=4,
                  mesh={"data": 2}, max_share=None, floor_first=True),
}
# a float32 slice held at every step to phase 10's float32 limit: at
# float32 a misplaced block shows where bf16's rounding would hide it
MESH_F32_TOL = 1e-4
# the card's memory the ranks' blocks of the weights may take (of 80 GB):
# the rest is for their activations (``init_placed_params`` holds each
# rank's blocks on the host while another makes the whole tree)
MESH_BUDGET_BYTES = 60e9


def _greedy(cfg, params, toks, max_new: int):
    """The one-rank greedy serve loop on the card, as ``serve()`` runs it
    (its decode step one CUDA graph): (generations, every step's
    last-position logits (b, max_new, v) float32 on the host)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps

    plen = toks.shape[1]
    prefill, decode = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    with torch.inference_mode():
        logits, caches = prefill(params, {"tokens": toks})
        caches = serve_mod.prepare_decode_caches(cfg, caches, plen, plen + max_new)
        logs = torch.full((max_new, toks.shape[0], logits.shape[-1]), float("nan"),
                          device=logits.device)
        logs[0] = logits[:, -1].float()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        gen, _, _ = serve_mod.decode_loop(_logit_tap(decode, logs, plen - 1), params,
                                          caches, tok, plen, max_new)
    return gen, logs.transpose(0, 1).cpu()


def _forced(cfg, params, toks, gen: np.ndarray, *, policy=None, mesh=None):
    """The serve loop fed ``gen`` (teacher-forced: step i reads ``gen[:,
    i]``), on one rank or under ``policy`` on ``mesh``: every step's
    last-position logits (b, steps, v), float32 on the host."""
    from repro_torch.core.gspmd import full
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps

    plen = toks.shape[1]
    prefill = steps.make_prefill_step(cfg, policy=policy, mesh=mesh)
    decode = steps.make_serve_step(cfg, policy=policy, mesh=mesh)
    # DTensor views cannot be made of inference tensors: no_grad on a mesh
    with torch.no_grad() if mesh is not None else torch.inference_mode():
        logits, caches = prefill(params, {"tokens": toks})
        caches = serve_mod.prepare_decode_caches(cfg, caches, plen, plen + gen.shape[1],
                                                 policy=policy, mesh=mesh)
        kept = [full(logits)[:, -1].float().cpu()]
        for i in range(gen.shape[1] - 1):
            tok = torch.as_tensor(gen[:, i:i + 1], device=toks.device)
            logits, caches = decode(params, tok, caches, plen + i)
            kept.append(full(logits)[:, -1].float().cpu())
    return torch.stack(kept, 1)


def _upcast_(tree):
    """``tree``'s leaves in float32, each replaced in its container as it is
    made, so the card holds one bf16 leaf beside the float32 tree at most
    (qwen2-moe: 30.3 GB in bf16 and 60.6 GB in float32 do not fit
    together)."""
    if isinstance(tree, dict):
        for k in tree:
            tree[k] = _upcast_(tree[k])
        return tree
    if isinstance(tree, list):
        for i, t in enumerate(tree):
            tree[i] = _upcast_(t)
        return tree
    return tree.float()


def _one_rank_serve(cfg, prompts, max_new: int, slice_layers: int) -> dict:
    """The one-rank serve on the card (seed-0 weights) in bf16: the
    generations, every step's logits and top-2 margins; the same weights
    upcast to float32 and fed the bf16 generations — the witness of how far
    bf16's own rounding moves the logits; and the float32 slice's greedy
    generations and logits."""
    from repro_torch.models import transformer as tf

    toks = torch.as_tensor(prompts, device="cuda")
    params = tf.init_params(cfg, seed=0, device="cuda")
    out = {}
    out["gen"], out["bfloat16"] = _greedy(cfg, params, toks, max_new)
    params = _upcast_(params)
    torch.cuda.empty_cache()
    out["float32"] = _forced(dataclasses.replace(cfg, dtype="float32"), params, toks,
                             out["gen"])
    del params
    torch.cuda.empty_cache()
    sl = _f32_slice(cfg, slice_layers)
    out["slice_gen"], out["slice"] = _greedy(sl, tf.init_params(sl, seed=0, device="cuda"),
                                             toks, max_new)
    torch.cuda.empty_cache()
    top2 = torch.topk(out["bfloat16"], 2, dim=-1).values
    out["margins"] = (top2[..., 0] - top2[..., 1]).numpy()
    return out


def _f32_slice(cfg, layers: int):
    return dataclasses.replace(cfg, n_layers=layers * len(cfg.block_pattern), dtype="float32")


def _serve_cfg(spec: dict):
    """The cell's config: its architecture, at ``layers`` where given."""
    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    return cfg if spec["layers"] is None else dataclasses.replace(cfg, n_layers=spec["layers"])


def _serve_policy(cfg, spec: dict, mesh):
    """The cell's policy on ``mesh``: manual where the cell says, else the
    plan of its prefill (what ``serve(mesh=)`` plans)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.policy import manual_policy

    if spec["policy"] is not None:
        return manual_policy(spec["policy"])
    return program_for(cfg, ShapeConfig("serve", "prefill", spec["prompt_len"], spec["b"])
                       ).compile(mesh_axes=dict(mesh.sizes), device=str(mesh.device)).policy()


def _rank_bytes(cfg, policy, mesh) -> int:
    """Bytes of one rank's blocks of the weights under ``policy``, from
    ``param_specs`` alone (nothing allocated)."""
    from repro_torch.core import tree
    from repro_torch.models import transformer as tf

    sizes = dict(mesh.sizes)
    total = 0
    for t, spec in zip(tree.leaves(tf.init_params(cfg, device="meta")),
                       _spec_leaves(tf.param_specs(cfg, policy, mesh))):
        n = t.numel() * t.element_size()
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[a]
        total += n
    return total


def _spec_leaves(tree) -> list:
    """The leaves of a tree whose leaves are spec tuples, in ``tree.leaves``
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list) or (isinstance(tree, tuple) and hasattr(tree, "_fields")):
        return [x for t in tree for x in _spec_leaves(t)]
    return [tree]


def mesh_serve_rank(rank: int, world: int, spec: dict, one: dict) -> dict:
    """One gloo rank of a serve cell (phase 31(c), 33(a)-(c)): the cell's
    architecture at full size (bf16) on its mesh: the weights placed by
    ``param_shardings`` (the ranks take turns making them, after the
    per-rank bytes were read off ``param_specs``); the serve loop fed the
    one-rank generations, every step's logits held against the one-rank
    bf16 and float32 runs (``one``, from ``_one_rank_serve``);
    ``serve(mesh=)``; then the float32 slice fed its one-rank generations;
    with ``own_policy``, ``serve(mesh=)`` under its own plan too."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tf

    cfg = _serve_cfg(spec)
    b, plen, new = spec["b"], spec["prompt_len"], spec["max_new"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(b, plen)).astype(np.int32)
    toks = torch.as_tensor(prompts, device="cuda:0")
    mesh = Mesh(spec["mesh"], device="cuda:0")
    policy = _serve_policy(cfg, spec, mesh)
    rank_bytes = _rank_bytes(cfg, policy, mesh)
    assert world * rank_bytes <= MESH_BUDGET_BYTES, (spec["arch"], rank_bytes)
    params = tf.init_placed_params(cfg, policy, mesh, seed=0)
    torch.cuda.reset_peak_memory_stats()
    gmm_shapes = set()
    kernel_gmm = ops.gmm

    def gmm(x, w, **kw):  # the blocks each expert product runs on
        gmm_shapes.add((tuple(x.shape), tuple(w.shape)))
        return kernel_gmm(x, w, **kw)

    ops.gmm = gmm
    ops.reset_launch_counts()
    try:
        got = _forced(cfg, params, toks, one["gen"], policy=policy, mesh=mesh)
    finally:
        ops.gmm = kernel_gmm
    forced_launches, forced_designs = ops.launch_counts(), ops.design_counts()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    free, stats = serve_mod.serve(cfg, prompts, max_new=new, mesh=mesh, params=params)
    res = {"gen": free, "param_bytes": stats["param_bytes"], "rank_bytes_static": rank_bytes,
           "t_prefill_s": stats["t_prefill_s"], "t_decode_s": stats["t_decode_s"],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "forced_launches": forced_launches, "forced_designs": forced_designs,
           "gmm_shapes": sorted(gmm_shapes), "serve_launches": ops.launch_counts(),
           "designs": ops.design_counts(),
           "policy": {l: list(a) for l, a in policy.label_axes.items()},
           "serve_policy": dict(stats["policy"])}
    del params
    torch.cuda.empty_cache()
    sl = _f32_slice(cfg, spec["slice_layers"])
    got_sl = _forced(sl, tf.init_placed_params(sl, policy, mesh, seed=0), toks,
                     one["slice_gen"], policy=policy, mesh=mesh)
    torch.cuda.empty_cache()
    if spec.get("own_policy"):
        # serve(mesh=)'s own plan: at the cell's depth where its blocks fit
        own = _serve_policy(cfg, dict(spec, policy=None), mesh)
        own_bytes = _rank_bytes(cfg, own, mesh)
        layers = cfg.n_layers
        while layers > 1 and world * own_bytes * layers / cfg.n_layers > MESH_BUDGET_BYTES:
            layers -= 1
        ocfg = dataclasses.replace(cfg, n_layers=layers)
        ops.reset_launch_counts()
        own_gen, own_stats = serve_mod.serve(ocfg, prompts, max_new=new, mesh=mesh)
        res["own"] = {"gen": own_gen, "layers": layers, "rank_bytes_static": own_bytes,
                      "param_bytes": own_stats["param_bytes"],
                      "policy": {l: list(a) for l, a in own.label_axes.items()},
                      "launches": ops.launch_counts(),
                      "t_prefill_s": own_stats["t_prefill_s"],
                      "t_decode_s": own_stats["t_decode_s"]}
        torch.cuda.empty_cache()

    def per_step(got, want):
        return (got - want).abs().amax(dim=(0, 2)).tolist()

    res.update(diff_bf16=per_step(got, one["bfloat16"]), diff_f32=per_step(got, one["float32"]),
               diff_slice=per_step(got_sl, one["slice"]))
    return res


# the first step's logits on the mesh against the one-rank serve's,
# relative to max|logit|: the bf16 tolerance
MESH_SERVE_TOL = 2e-2


def _diverged(gen, want, margins) -> list:
    """Each row's first token that differs from the one-rank run, with the
    one-rank top-2 margin behind it (its step is that margin's column)."""
    out = []
    for row in range(gen.shape[0]):
        cols = np.nonzero(gen[row] != want[row])[0]
        if len(cols):
            c = int(cols[0])
            out.append({"row": row, "step": c, "margin": float(margins[row, c]),
                        "got": int(gen[row, c]), "want": int(want[row, c])})
    return out


def _mesh_serve(spec: dict = MESH_SERVE) -> dict:
    from repro_torch.launch.mesh import spawn

    cfg = _serve_cfg(spec)
    b, plen, new = spec["b"], spec["prompt_len"], spec["max_new"]
    world = math.prod(spec["mesh"].values())
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(b, plen)).astype(np.int32)
    # the one-rank reference first, so it and the ranks never hold the card at once
    t0 = time.perf_counter()
    one = _one_rank_serve(cfg, prompts, new, spec["slice_layers"])
    t_one = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn(world, mesh_serve_rank, spec, {k: one[k] for k in (
            "gen", "bfloat16", "float32", "slice_gen", "slice")},
            tmpdir=tmp, backend="gloo", timeout=900)
        t_spawn = time.perf_counter() - t0

    def rel(xs, ref):  # each step's max|diff| over that step's max|logit|
        return [x / s for x, s in zip(xs, ref.abs().amax(dim=(0, 2)).tolist())]

    floor = rel((one["bfloat16"] - one["float32"]).abs().amax(dim=(0, 2)).tolist(),
                one["float32"])
    r0 = ranks[0]
    total = sum(r["param_bytes"] for r in ranks)
    gen, want = r0["gen"], one["gen"]
    diverged = _diverged(gen, want, one["margins"])
    mesh_bf16 = rel(r0["diff_bf16"], one["bfloat16"])
    mesh_f32 = rel(r0["diff_f32"], one["float32"])
    mesh_slice = rel(r0["diff_slice"], one["slice"])
    scale = float(one["bfloat16"][:, 0].abs().max())
    attn = sum(1 for blk in cfg.blocks() if blk in ("attn", "hymba"))
    gmm_step = 3 * cfg.n_layers if cfg.moe else 0
    flash = r0["forced_designs"]["flash_attention"]
    fmt = lambda xs: "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"  # noqa: E731
    log("mesh-serve", f"{spec['arch']} bf16, {cfg.n_layers} layers, b={b}, prompt {plen}, "
                      f"{new} new on {world} gloo ranks sharing the card, mesh "
                      f"{spec['mesh']}, policy {r0['policy']}: weight bytes a rank "
                      f"{[r['param_bytes'] for r in ranks]} (total {total}; "
                      f"{r0['rank_bytes_static']} a rank from param_specs before placing); "
                      f"peak {[r['peak_bytes'] for r in ranks]} B a rank; fed the one-rank "
                      f"tokens, each of the {new} steps' max|diff| / max|logit|: mesh - one "
                      f"rank {fmt(mesh_bf16)} (first step limit {MESH_SERVE_TOL}); the noise "
                      f"floor, one rank bf16 - the same weights in f32 {fmt(floor)}; mesh - "
                      f"f32 {fmt(mesh_f32)}; the f32 slice ({spec['slice_layers']} pattern "
                      f"periods), mesh - one rank {fmt(mesh_slice)} (limit {MESH_F32_TOL}); "
                      f"serve(mesh=) tokens equal {int((gen == want).sum())} of {gen.size}, "
                      f"first divergences {diverged or 'none'}; prefill walls "
                      f"{[round(r['t_prefill_s'], 2) for r in ranks]} s, decode walls "
                      f"{[round(r['t_decode_s'], 2) for r in ranks]} s ({new - 1} steps; "
                      f"host-staged gloo, not a speed path); the forced run's launches a "
                      f"rank {r0['forced_launches']} (flash by design {flash}; gmm blocks "
                      f"{r0['gmm_shapes']}); one-rank runs {t_one:.1f} s, ranks "
                      f"{t_spawn:.1f} s")
    for rank, r in enumerate(ranks):
        for what in ("diff_bf16", "diff_f32", "diff_slice"):  # every rank the same logits
            assert r[what] == r0[what], (rank, what)
        assert (r["gen"] == r0["gen"]).all(), rank  # every rank the same tokens
        fl = r["forced_launches"]
        assert fl["flash_attention"] == attn, fl  # one a layer, in the prefill
        assert fl["gmm"] == gmm_step * new, fl  # the prefill and every decode step
        for kernel in ("flash_attention", "gmm"):  # bf16: all of the wgmma design
            assert r["forced_designs"][kernel]["wgmma"] == fl[kernel], r["forced_designs"]
        assert r["param_bytes"] == r["rank_bytes_static"], (rank, r["param_bytes"])
        if spec["max_share"] is not None:  # each rank holds a share of the weights
            assert r["param_bytes"] < spec["max_share"] * total, (rank, r["param_bytes"], total)
    if cfg.moe:  # each rank's expert block: E/r experts
        e_axes = ([r0["policy"]["e"]] if isinstance(r0["policy"].get("e"), str)
                  else r0["policy"].get("e", []))
        r_e = math.prod(spec["mesh"][a] for a in e_axes)
        assert r0["gmm_shapes"] and all(x[0] == w[0] == cfg.n_e // r_e
                                        for x, w in r0["gmm_shapes"]), r0["gmm_shapes"]
    floor_abs = (one["bfloat16"] - one["float32"]).abs().amax(dim=(0, 2)).tolist()
    scales = one["bfloat16"].abs().amax(dim=(0, 2)).tolist()
    if spec["floor_first"]:  # against the float32 run, over all steps
        flip = max(MESH_SERVE_TOL * scale, 2 * max(floor_abs))
        if not max(r0["diff_f32"]) <= 2 * max(floor_abs):
            raise AssertionError(f"mesh serve: max|mesh - f32| {max(r0['diff_f32']):.3e} over "
                                 f"twice the one-rank bf16 run's {max(floor_abs):.3e}")
    else:
        flip = MESH_SERVE_TOL * scale
        if not r0["diff_bf16"][0] <= MESH_SERVE_TOL * scale:
            raise AssertionError(f"mesh serve: first-step logits differ by "
                                 f"{r0['diff_bf16'][0]:.3e} > {MESH_SERVE_TOL} x max|logit| "
                                 f"{scale:.3f}")
        # later steps: the mesh may differ from the one-rank bf16 run by as
        # much as two bf16 runs each as far from the float32 run as the
        # one-rank is
        for i, (d, f, sc) in enumerate(zip(r0["diff_bf16"], floor_abs, scales)):
            if not d <= max(MESH_SERVE_TOL * sc, 2 * f):
                raise AssertionError(f"mesh serve: step {i}'s logits differ by {d:.3e}, "
                                     f"over {MESH_SERVE_TOL} x max|logit| {sc:.3f} and "
                                     f"twice the bf16 noise floor {f:.3e}")
    if not max(mesh_slice) <= MESH_F32_TOL:
        raise AssertionError(f"mesh serve: the f32 slice's logits differ by {fmt(mesh_slice)} "
                             f"x max|logit| > {MESH_F32_TOL}")
    for d in diverged:  # a flip is a bf16 near tie, or a fault
        assert d["margin"] <= flip, (d, flip)
    out = {"arch": spec["arch"], "mesh": spec["mesh"], "policy": r0["policy"],
           "param_bytes": [r["param_bytes"] for r in ranks], "param_bytes_total": total,
           "rank_bytes_static": r0["rank_bytes_static"],
           "peak_bytes": [r["peak_bytes"] for r in ranks], "max_abs_logit": scale,
           "rel_mesh_one_rank": mesh_bf16, "rel_mesh_f32": mesh_f32,
           "rel_noise_floor": floor, "rel_slice": mesh_slice, "tol_rel": MESH_SERVE_TOL,
           "tol_slice": MESH_F32_TOL,
           "tokens_equal": int((gen == want).sum()), "tokens": int(gen.size),
           "diverged": diverged, "t_prefill_s": [r["t_prefill_s"] for r in ranks],
           "t_decode_s": [r["t_decode_s"] for r in ranks],
           "flash_launches": r0["serve_launches"]["flash_attention"],
           "flash_designs": r0["designs"]["flash_attention"],
           "forced_launches": r0["forced_launches"], "forced_designs": r0["forced_designs"],
           "gmm_shapes": r0["gmm_shapes"],
           "t_one_rank_s": t_one, "spawn_s": t_spawn}
    if "own" in r0:
        own = r0["own"]
        assert all((r["own"]["gen"] == own["gen"]).all() for r in ranks)
        out["own"] = {k: v for k, v in own.items() if k != "gen"}
        msg = f"{own['layers']} of {cfg.n_layers} layers"
        if own["layers"] == cfg.n_layers:  # the same model: held as above
            own_div = _diverged(own["gen"], want, one["margins"])
            for d in own_div:
                assert d["margin"] <= flip, (d, flip)
            out["own"].update(tokens_equal=int((own["gen"] == want).sum()), diverged=own_div)
            msg += (f"; tokens equal {out['own']['tokens_equal']} of {gen.size}, first "
                    f"divergences {own_div or 'none'}")
        else:
            msg += (f" (cut: {cfg.n_layers} would need "
                    f"{world * own['rank_bytes_static']} B of blocks, over "
                    f"{MESH_BUDGET_BYTES:.0f}); finite generations only")
        log("mesh-serve", f"{spec['arch']} under serve(mesh=)'s own plan {own['policy']}: "
                          f"{msg}; weight bytes a rank {own['param_bytes']} "
                          f"({own['rank_bytes_static']} from param_specs); launches a rank "
                          f"{own['launches']}; prefill {own['t_prefill_s']:.2f} s, decode "
                          f"{own['t_decode_s']:.2f} s")
    return out


# ---------------------------------------------------------------------------
# 33. the MoE, hymba and xLSTM blocks on a mesh
# ---------------------------------------------------------------------------


def gspmd_a2a_rank(rank: int, world: int) -> dict:
    """One gloo rank of phase 33(e): qwen2-moe's prefill graph (one block
    period, b=4, s=512) with the MoE stubs, the experts on the 4-way
    ``model`` axis in the expert half (phase 16's plan), through
    ``executor="gspmd"`` — the a2a nodes lowered through their rule — in
    both dtypes, against the shard_map run of the same plan and the dense
    run; the collectives DTensor and the rule issued beside shard_map's
    static trace."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import spmd
    from repro_torch.core.gspmd import comm_summary
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for
    from repro_torch.models.opaque_stubs import capacity_of, make_stub_opaques

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-moe-a2.7b")
    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    g = prog.graph
    make_stub_opaques(capacity_of(g))
    mesh = Mesh({"data": 1, "model": world}, device="cuda:0")
    plan = _expert_parallel_plan(g, "model", world)
    run = prog.compile(mesh=mesh, executor="gspmd", plan=plan)
    sm = prog.compile(mesh=mesh, executor="shard_map", plan=plan)
    dense = prog.compile(device="cuda:0")
    a2a = {n.nid for n in g.nodes if n.kind == "opaque"
           and n.op in ("moe_dispatch", "moe_combine")}
    events = sm._fn.schedule.trace.events
    res = {"n_mm": sum(1 for n in g.nodes if n.kind == "einsum" and spmd._as_matmul(n.spec)),
           "a2a_nodes": sorted(a2a),
           "static_rule": sorted((e.nid, e.kind, e.elems) for e in events
                                 if e.nid in a2a and e.rule == "a2a"),
           "static_other": sorted((e.kind, e.elems) for e in events
                                  if not (e.nid in a2a and e.rule == "a2a"))}
    for name in RING_DTYPES:
        feeds = _graph_feeds(g, cfg, getattr(torch, name), seed=7)
        with torch.no_grad():
            run(feeds)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            run._fn.log_comms = True
            t0 = time.perf_counter()
            got = run(feeds)["logits"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run._fn.log_comms = False
            out = {"launches": ops.launch_counts(), "designs": ops.design_counts(),
                   "wall_s": wall, "comms": comm_summary(run._fn.comms),
                   "issued": sorted((e[0], e[1], e[3]) for e in run._fn.issued),
                   "shape": list(got.shape), "finite": bool(torch.isfinite(got).all())}
            got = got.float()
            want = dense(feeds)["logits"].float()
            out["max_abs_logit"] = float(want.abs().max())
            out["diff_dense"] = float((got - want).abs().max())
            del want
            out["diff_shard_map"] = float((got - sm(feeds)["logits"].float()).abs().max())
        res[name] = out
        del feeds, got
        torch.cuda.empty_cache()
    return res


def _gspmd_a2a() -> dict:
    """Phase 33(e): the a2a rule under the DTensor executor on 4 ranks."""
    from repro_torch.launch.mesh import spawn

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn(A2A_RANKS, gspmd_a2a_rank, tmpdir=tmp, backend="gloo", timeout=600)
        t_spawn = time.perf_counter() - t0
    r0, out = ranks[0], {"spawn_s": t_spawn}
    for name in RING_DTYPES:
        design = "wgmma" if name == "bfloat16" else "ffma"
        per_rank = [r[name] for r in ranks]
        for rank, r in enumerate(per_rank):
            assert r["launches"] == {"flash_attention": 1, "flash_attention_step": 0,
                                     "matmul": r0["n_mm"], "gmm": 0}, (rank, r["launches"])
            for kernel in ("flash_attention", "matmul"):
                assert r["designs"][kernel][design] == r["launches"][kernel], r["designs"]
            assert r["finite"] and r["shape"][:2] == [4, 512], r
            tol = GSPMD_TOL[name] * r["max_abs_logit"]
            for what in ("diff_dense", "diff_shard_map"):
                if not r[what] <= tol:
                    raise AssertionError(f"gspmd a2a {name} rank {rank}: {what} {r[what]:.3e} "
                                         f"> {GSPMD_TOL[name]} x max|logit| "
                                         f"{r['max_abs_logit']:.3f}")
            # the rule's collectives: the static trace's, node by node
            assert r["issued"] == ranks[rank]["static_rule"], (rank, r["issued"])
            for nid in r0["a2a_nodes"]:
                kinds = [k for n, k, _ in r["issued"] if n == nid]
                assert kinds == ["all_gather", "all_to_all", "all_to_all"], (nid, kinds)
            # DTensor's: all-gathers whose blocks, ring-priced over the 4-way
            # axis (n_dev x (k - 1) x a block), are the static trace's elements
            # (the trace prices the graph's float32 nodes; bf16 runs half the bytes)
            ag = r["comms"].get("all_gather", {"count": 0, "bytes": 0})
            item = torch.finfo(getattr(torch, name)).bits // 8
            assert set(r["comms"]) <= {"all_gather"}, r["comms"]
            assert {k for k, _ in r0["static_other"]} <= {"all_gather"}, r0["static_other"]
            assert ag["count"] == len(r0["static_other"]), (ag, r0["static_other"])
            assert ag["bytes"] // item * A2A_RANKS * (A2A_RANKS - 1) == sum(
                n for _, n in r0["static_other"]), (ag, r0["static_other"])
        r = per_rank[0]
        log("gspmd-a2a", f"{name}: qwen2-moe prefill graph (b=4, s=512, one block period, "
                         f"MoE stubs) on {A2A_RANKS} gloo ranks sharing the card, the "
                         f"experts on the 4-way model axis (phase 16's plan), "
                         f"executor='gspmd': launches per rank {r['launches']} by design "
                         f"{r['designs']['matmul']} (matmul); max|gspmd - dense| "
                         f"{max(x['diff_dense'] for x in per_rank):.3e}, max|gspmd - "
                         f"shard_map| {max(x['diff_shard_map'] for x in per_rank):.3e} "
                         f"(max|logit| {r['max_abs_logit']:.3f}, tol {GSPMD_TOL[name]} x "
                         f"that); the a2a rule issued {len(r['issued'])} collectives on "
                         f"{len(r0['a2a_nodes'])} nodes, equal to the static trace's "
                         f"{r0['static_rule']}; DTensor issued {r['comms']} (ring-priced "
                         f"equal to the static trace's elements {r0['static_other']}); rank "
                         f"walls "
                         f"{[round(x['wall_s'], 3) for x in per_rank]} s (host-staged gloo, "
                         f"not a speed path)")
        out[name] = {"launches_per_rank": [x["launches"] for x in per_rank],
                     "designs_per_rank": [x["designs"] for x in per_rank],
                     "comms_per_rank": r["comms"], "issued": r["issued"],
                     "static_rule": r0["static_rule"], "static_other": r0["static_other"],
                     "max_abs_logit": r["max_abs_logit"],
                     "max_diff_dense": max(x["diff_dense"] for x in per_rank),
                     "max_diff_shard_map": max(x["diff_shard_map"] for x in per_rank),
                     "tol_rel": GSPMD_TOL[name], "wall_s": [x["wall_s"] for x in per_rank]}
    return out


def _mesh_blocks_launches(blocks: dict) -> dict:
    """Per kernel, phase 33's launches a rank by design: each serve cell's
    forced run (the prefill and every decode step), each train cell's step,
    the gspmd a2a call in each dtype."""
    out = {k: {} for k in ("flash_attention", "matmul", "gmm")}
    for name, r in blocks["serve"].items():
        for k in ("flash_attention", "gmm"):
            if r["forced_launches"][k]:
                out[k][f"serve/{name}"] = {"launches": r["forced_launches"][k],
                                           "design": r["forced_designs"][k]}
    for cell, r in blocks["train"].items():
        for k in out:
            if r["launches_per_rank"][0][k]:
                out[k][f"train/{cell}"] = {"launches": r["launches_per_rank"][0][k],
                                           "design": r["designs_per_rank"][0][k]}
    for dt in RING_DTYPES:
        r = blocks["gspmd_a2a"][dt]
        out["matmul"][f"gspmd_a2a/{dt}"] = {"launches": r["launches_per_rank"][0]["matmul"],
                                            "design": r["designs_per_rank"][0]["matmul"]}
    return out


def _block_mesh_phase(ops) -> dict:
    """Phase 33 (a)-(e): qwen2-moe, hymba and xlstm served at full width on
    meshes of gloo ranks sharing the card, their float32 train steps on 2
    ranks (``TRAIN_CELL_LAYERS``), and the a2a rule under the gspmd
    executor.  qwen2-moe is served beside the executor's ranks and the
    hymba and xlstm train cells' (at 24 layers its float32 witness alone
    took 61 GB of the card); the qwen2-moe train cells' ranks then run
    beside hymba's and xlstm's serves (for the run's time limit: two train
    spawns, the first beside (a) and (e) since phase 36 came: 211 s with
    one spawn after (a), 167 s so, one H100)."""
    small = {c: v for c, v in BLOCK_TRAIN_CELLS.items() if not _mesh_train_cfg(v[0]).moe}
    moe = {c: v for c, v in BLOCK_TRAIN_CELLS.items() if c not in small}
    out = {"serve": {}}
    with ThreadPoolExecutor(max_workers=3) as pool:
        # (e)'s ranks and the small cells' beside qwen2-moe's serve (at 3
        # layers it holds under 20 GB of the card); (e) done before the
        # qwen2-moe cells start: beside them it does not fit
        a2a = pool.submit(_gspmd_a2a)
        train_small = pool.submit(_mesh_train, small)
        train_moe = None
        for name, spec in BLOCK_SERVES.items():
            t0 = time.perf_counter()
            out["serve"][name] = _mesh_serve(spec)
            out["serve"][name]["phase_s"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            if train_moe is None:
                out["gspmd_a2a"] = a2a.result()
                train_moe = pool.submit(_mesh_train, moe)
        trained = {**train_small.result(), **train_moe.result()}
        out["train"] = {c: trained[c] for c in BLOCK_TRAIN_CELLS}
    return out


def _mesh_phase(ops) -> dict:
    """Phase 31: (a) the gspmd executor, (b) the sharded train step, (c)
    llama-7b served on a mesh — gloo ranks sharing the card; (b) beside
    (a), then beside (c) (for the run's time limit; 50 GB at most between
    (b) and (c)), so their walls are taken beside each other's."""
    out = {}
    with ThreadPoolExecutor(max_workers=1) as pool:
        # (b) beside (a) since phase 36 came, and (c) at 2 layers: 144 s
        # with (b) beside (c) alone, 76 s so (one H100)
        train = pool.submit(_mesh_train)
        out["gspmd"] = _gspmd_executor(ops)
        out["serve"] = _mesh_serve()
        out["train"] = train.result()
    return out


# ---------------------------------------------------------------------------
# 32. the dry run
# ---------------------------------------------------------------------------

# llama-7b's cells run by the CLI with no card visible: (shape, multi_pod)
DRYRUN_CELLS = [("llama-7b", "train_4k", False), ("llama-7b", "prefill_32k", False),
                ("llama-7b", "decode_32k", False), ("llama-7b", "decode_32k", True)]
DRYRUN_PEAK_TOL = 0.05  # abstract peak against the allocator's, relative


def _dryrun_cli(started: list) -> dict:
    """Phase 32(a): ``python -m repro_torch.launch.dryrun`` for llama-7b's
    cells, one subprocess each, all started together after the build (they
    need no card), with ``CUDA_VISIBLE_DEVICES`` empty; every record says
    CUDA was never initialised."""
    from repro_torch.launch import dryrun

    res = _dryrun_collect(started)
    total = torch.cuda.get_device_properties(0).total_memory
    log("dryrun", f"the card's memory: {total} B (dryrun.HBM_BYTES {dryrun.HBM_BYTES})")
    assert total == dryrun.HBM_BYTES, (total, dryrun.HBM_BYTES)
    res["hbm_bytes"] = total
    return res


def _dryrun_against_real(ops) -> dict:
    """Phase 32(b): llama-7b at full width on a 1x1 mesh, phase 5's prefill
    (bf16, b=4, s=512) and phase 18's train step (8 of 32 layers): the
    step built abstractly (``build_cell``, meta blocks) and run under
    ``StepCosts``, then the same step on the card from seeded weights under
    ``FlopCounterMode``: FLOPs equal, the flash calls by design equal to
    ``ops.design_counts()``, the abstract peak within DRYRUN_PEAK_TOL of
    ``max_memory_allocated`` less what was allocated before the
    arguments."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    llama = get_config("llama-7b")
    cells = {"prefill": (llama, ShapeConfig("p", "prefill", 512, 4)),
             "train": (dataclasses.replace(llama, n_layers=8),
                       ShapeConfig("t", "train", 512, 4))}
    res = {}
    for name, (cfg, shape) in cells.items():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        step, args, _, _, policy = dryrun.build_cell(cfg, shape, dryrun.abstract_mesh((1, 1)))
        abstract = dryrun.measure_step(step, args)
        t_abstract = time.perf_counter() - t0
        del step, args
        assert all(n == 0 for n in ops.launch_counts().values())

        mesh = Mesh({"data": 1, "model": 1}, device="cuda:0")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params = tf.init_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(32)
        toks = torch.randint(0, cfg.vocab, (shape.batch, shape.seq), generator=g,
                             device="cuda", dtype=torch.int32)
        if name == "train":
            step = steps.make_train_step(cfg, policy=policy, mesh=mesh)
            args = (params, adamw_init(params), {"tokens": toks, "labels": toks})
        else:
            step = steps.make_prefill_step(cfg, policy=policy, mesh=mesh)
            args = (params, {"tokens": toks})
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            out = step(*args)
        torch.cuda.synchronize()
        t_real = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        designs = ops.design_counts()
        del out, args, step
        gc.collect()
        torch.cuda.empty_cache()
        flops = fc.get_total_flops()
        ratio = abstract["memory"]["peak"] / peak
        log("dryrun", f"{name}: llama-7b {cfg.n_layers} layers, {shape.kind} b={shape.batch} "
                      f"s={shape.seq}, bf16, 1x1: FLOPs abstract {abstract['flops']} real "
                      f"{flops} (FlopCounterMode); flash calls by design abstract "
                      f"{abstract['kernel_calls']['flash_attention']} real "
                      f"{designs['flash_attention']}; peak abstract "
                      f"{abstract['memory']['peak']} B, allocator {peak} B (ratio "
                      f"{ratio:.5f}, limit {DRYRUN_PEAK_TOL}); abstract {abstract['memory']}; "
                      f"abstract run {t_abstract:.2f} s, real step {t_real:.2f} s")
        assert abstract["flops"] == flops > 0, (name, abstract["flops"], flops)
        for kernel in ("flash_attention", "matmul", "gmm"):
            assert abstract["kernel_calls"][kernel] == designs[kernel], (name, kernel)
        assert sum(designs["flash_attention"].values()) > 0
        assert abs(ratio - 1) <= DRYRUN_PEAK_TOL, (name, abstract["memory"], peak)
        res[name] = {"flops": flops, "abstract_flops": abstract["flops"],
                     "flash_designs": designs["flash_attention"],
                     "abstract_peak": abstract["memory"]["peak"], "allocator_peak": peak,
                     "ratio": ratio, "abstract_memory": abstract["memory"],
                     "abstract_s": t_abstract, "real_s": t_real}
    return res


def _dryrun_collectives(mesh_train: dict, cells: dict = MESH_TRAIN_CELLS) -> dict:
    """Phase 32(c) (and 33(f)): a train cell of phase 31(b) (33(d)) on a
    fake 2-rank group (meta blocks) against its 2 gloo ranks on the card:
    each collective kind's count and bytes equal to what the ranks issued,
    and the abstract peak within DRYRUN_PEAK_TOL of each rank's allocator
    peak of the step."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    res = {}
    try:
        for cell, (arch, sizes, plan_of) in cells.items():
            cfg = _mesh_train_cfg(arch)
            mesh = dryrun.abstract_mesh(tuple(sizes.values()), tuple(sizes))
            policy = _mesh_train_policy(cfg, dict(sizes), plan_of)
            costs, _, _ = dryrun.run_abstract(cfg, ShapeConfig("t", "train", 128, 2), mesh,
                                              policy_override=policy)
            got = costs["collectives"].summary()
            want = mesh_train[cell]["collectives"]
            peak, real = costs["memory"]["peak"], mesh_train[cell]["step_peak_bytes"]
            ratios = [peak / r for r in real]
            log("dryrun", f"{cell}: the {arch} train step of phase 31(b)/33(d) on a fake "
                          f"2-rank group issues {got}; its gloo ranks on the card issued "
                          f"{want}; peak abstract {peak} B, the ranks' allocator {real} B "
                          f"(ratios {[round(x, 5) for x in ratios]}, limit {DRYRUN_PEAK_TOL})")
            for kind in set(got) | set(want):
                for key in ("count", "bytes"):
                    if kind == "all-to-all" and key == "bytes":
                        # each row a rank sends another receives: with no token
                        # dropped (no expert fills its 128 slots at b=2, s=128)
                        # the two ranks' rows sum to the even routing's twice
                        moved = sum(r[kind][key] for r in mesh_train[cell]["collectives_per_rank"])
                        assert moved == 2 * got[kind][key], (cell, moved, got[kind])
                        continue
                    assert got[kind][key] == want[kind][key], (cell, kind, got, want)
            assert got, cell
            assert all(abs(x - 1) <= DRYRUN_PEAK_TOL for x in ratios), (cell, peak, real)
            res[cell] = {"abstract": got, "real": want, "abstract_peak": peak,
                         "allocator_peak": real, "ratios": ratios}
    finally:
        dryrun._MESHES.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
    return res


# phase 33(f): the new blocks' cells run by the CLI with no card visible,
# started with phase 32(a)'s after the build and read in phase 33
DRYRUN_BLOCK_CELLS = [("qwen2-moe-a2.7b", "decode_32k", False),
                      ("hymba-1.5b", "prefill_32k", False), ("xlstm-125m", "train_4k", False)]


def _dryrun_env() -> dict:
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def _dryrun_record(arch: str, shape: str, mesh: str, stdout: str, wall: float) -> dict:
    """Phase 32(a)'s checks and line for one CLI run's record."""
    out = ROOT / "chiprun_out" / "dryrun_torch"
    rec = json.loads((out / f"{arch}__{shape}__{mesh}.json").read_text())
    assert stdout.startswith("OK") and rec["ok"], stdout
    assert rec["cuda_initialized"] is False, rec
    r = rec["roofline"]
    calls = {k: {d: n for d, n in v.items() if n} for k, v in rec["kernel_calls"].items()
             if sum(v.values())}
    trips = (f"; trip counted at lengths {rec['trip_counted']['lengths']}"
             if "trip_counted" in rec else "")
    log("dryrun", f"{arch} {shape} on {mesh} ({rec['chips']} fake ranks, no card "
                  f"visible, CUDA never initialised): {rec['memory']['per_device_gb']:.3f} "
                  f"GB a card (fits 80 GB: {rec['fits_80gb']}), t_compute "
                  f"{r['t_compute_s']:.4e} s, t_memory {r['t_memory_s']:.4e} s, "
                  f"t_collective {r['t_collective_s']:.4e} s, bottleneck "
                  f"{rec['bottleneck']}; kernel calls a rank by design {calls}{trips}; the "
                  f"run {rec['total_s']} s, the subprocess {wall:.1f} s")
    return {"per_device_gb": rec["memory"]["per_device_gb"], "fits_80gb": rec["fits_80gb"],
            "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
            "t_collective_s": r["t_collective_s"], "bottleneck": rec["bottleneck"],
            "kernel_calls": rec["kernel_calls"], "run_s": rec["total_s"], "wall_s": wall,
            "collective_counts": r["collective_counts"],
            "trip_counted": rec.get("trip_counted")}


def _dryrun_start(cells: list) -> list:
    """Start ``python -m repro_torch.launch.dryrun`` for each (arch, shape,
    multi_pod), with no card visible and at the lowest CPU priority (the
    phases running meanwhile come first): [(cell, process, start, log
    path)]."""
    out = ROOT / "chiprun_out" / "dryrun_torch"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape, multi_pod in cells:
        mesh = "2x16x16" if multi_pod else "16x16"
        path = out / f"{arch}__{shape}__{mesh}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", str(out)] + (["--multi-pod"] if multi_pod else [])
        with open(path, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    env=_dryrun_env(), cwd=ROOT,
                                    preexec_fn=lambda: os.nice(19))
        atexit.register(lambda p=proc: p.poll() is None and (p.kill(), p.wait()))
        procs.append(((arch, shape, mesh), proc, time.time(), path))
    return procs


def _dryrun_collect(started: list) -> dict:
    """Wait for each started cell, check and log its record (32(a)):
    {"arch/shape/mesh": summary}, with the subprocess's wall from its start
    to its log's last write.  A cell still running 900 s after its start,
    or any left when one fails, is killed."""
    res = {}
    try:
        for (arch, shape, mesh), proc, t0, path in started:
            rc = proc.wait(timeout=max(1.0, 900 - (time.time() - t0)))
            text = path.read_text()
            if rc != 0:
                raise AssertionError(f"dryrun {arch} {shape} {mesh}: exit {rc}\n{text[-4000:]}")
            line = [ln for ln in text.splitlines() if ln.startswith("OK")][-1]
            res[f"{arch}/{shape}/{mesh}"] = _dryrun_record(arch, shape, mesh, line,
                                                           path.stat().st_mtime - t0)
    finally:
        for _, proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return res


def _dryrun_blocks(started: list, mesh_train: dict) -> dict:
    """Phase 33(f): the new blocks' CLI cells (started after the build),
    and 33(d)'s MoE steps on {data: 2} and {model: 2} on a fake 2-rank
    group against their gloo ranks."""
    res = _dryrun_collect(started)
    moe = {c: BLOCK_TRAIN_CELLS[c] for c in ("qwen2-moe/data2", "qwen2-moe/model2")}
    res["collectives"] = _dryrun_collectives(mesh_train, moe)
    return res


def _dryrun_phase(ops, results: dict, started: list) -> dict:
    """Phase 32: (a) the CLI on the production mesh with no card visible
    (``started`` after the build), (b) abstract against real on one rank,
    (c) the collectives against phase 31(b)'s gloo ranks."""
    return {"cli": _dryrun_cli(started), "one_rank": _dryrun_against_real(ops),
            "collectives": _dryrun_collectives(results["mesh"]["train"])}



# ---------------------------------------------------------------------------
# 34. the serving engine's paged decode on a mesh; compile(donate=)
# ---------------------------------------------------------------------------

# llama-7b's engine at full width, 4 of its 32 layers (cut from 8
# for the run's time limit; as phase 31(c)), on (1, 4) gloo ranks sharing
# the card; 6 requests of 96-320 tokens drawn from the seed, 8 new each,
# through 4 slots (two queue behind the first four); a 4-layer float32
# slice beside it
MESH_ENGINE = {"arch": "llama-7b", "layers": 4, "mesh": {"data": 1, "model": 4},
               "slots": 4, "block": 16, "requests": 6, "lens": (96, 320), "max_new": 8,
               "slice_layers": 4}
# the float32 slice's first decode step on the mesh against one rank's,
# relative to max|logit|: phase 10's float32 limit
MESH_ENGINE_F32_TOL = 1e-4
# the donated call's allocator peak against the memory pass's
DONATE_BAND = 1e-3


def _mesh_engine_prompts(cfg, spec: dict) -> list:
    rng = np.random.default_rng(34)
    lens = rng.integers(spec["lens"][0], spec["lens"][1] + 1, size=spec["requests"])
    return [rng.integers(0, cfg.vocab, size=(int(n),)).astype(np.int32) for n in lens]


def _tapped_engine(cfg, spec: dict, *, mesh=None, params=None,
                   force: dict | None = None) -> dict:
    """A ``ServingEngine`` on the card (on ``mesh`` where given; weights
    from seed 0 unless ``params``) over the cell's requests, tapped: the
    whole last-position logits of every prefill and decode step (float32,
    on the host) per request and generation index, the tokens the engine
    took itself
    (its prefill argmax, then its decode steps'), each decode step's wall,
    its launches by design (counts set to 0 just before ``run``).  With
    ``force`` ({rid: tokens}) every admission and decode step hands the
    engine those tokens instead of its own (teacher forcing), so its
    logits condition on the same prefixes as the run that made them.  The
    taps read the host, so the step runs eagerly (``graph=False``, as every
    step on a mesh does)."""
    from repro_torch.core import tree
    from repro_torch.core.gspmd import full
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import _local_bytes
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    prompts = _mesh_engine_prompts(cfg, spec)
    max_seq = spec["lens"][1] + spec["max_new"]
    eng = ServingEngine(cfg, batch=spec["slots"], max_seq=max_seq, block=spec["block"],
                        params=params, mesh=mesh, device="cuda", graph=False)
    for p in prompts:
        eng.submit(p, spec["max_new"])
    rec: dict = {}
    own: dict = {}
    walls: list = []
    pending: list = []
    order = iter(range(len(prompts)))  # admissions come in request order
    admit, decode, paged = eng._admit, eng._decode, tf.decode_step_paged
    get_prefill = eng.registry.prefill

    def prefill_tapped(prompt_len, batch=1):
        ent = get_prefill(prompt_len, batch)
        base = getattr(ent, "untapped_step", ent.step)
        ent.untapped_step = base

        def step(params, batch, last_index):
            logits, caches = base(params, batch, last_index)
            pending.append(full(logits)[0, -1].float().cpu())
            return logits, caches

        ent.step = step
        return ent

    def admit_tapped(caches, pre, blocks, slot, tok0, tokens):
        rid = next(order)
        own[rid] = [int(tok0[0])]
        rec[rid] = {0: pending.pop()}
        if force is not None:
            tok0 = torch.full_like(tok0, int(force[rid][0]))
        return admit(caches, pre, blocks, slot, tok0, tokens)

    def paged_tapped(*a, **kw):
        logits, caches = paged(*a, **kw)
        whole = full(logits)[:, -1].float().cpu()
        for i, req in enumerate(eng.slots):
            if req is not None:
                rec[req.rid][1 + req.n_dec] = whole[i]
        return logits, caches

    def decode_tapped(params, tokens, caches, tables, pos):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = decode(params, tokens, caches, tables, pos)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mine = tok[:, 0].tolist()
        live = [(i, req) for i, req in enumerate(eng.slots) if req is not None]
        for i, req in live:
            own[req.rid].append(mine[i])
        if force is None:
            return tok, caches
        tok = tok.clone()
        for i, req in live:
            tok[i, 0] = int(force[req.rid][1 + req.n_dec])
        return tok, caches

    eng._admit, eng._decode, tf.decode_step_paged = admit_tapped, decode_tapped, paged_tapped
    eng.registry.prefill = prefill_tapped
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        _, metrics = eng.run()
    finally:
        tf.decode_step_paged = paged
    launches, designs = ops.launch_counts(), ops.design_counts()
    pools = [t for c in eng.caches for t in tree.leaves(c)]
    return {"own": {rid: np.asarray(t, np.int32) for rid, t in own.items()},
            "logits": rec, "walls": walls, "ttft_s": dict(metrics.ttft_s),
            "decode_steps": metrics.decode_steps, "prefills": metrics.prefills,
            "launches": launches, "designs": designs,
            "weight_bytes": _local_bytes(eng.params), "pool_bytes": _local_bytes(pools),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "policy": {l: list(a) for l, a in eng.policy.label_axes.items()}}


def mesh_engine_rank(rank: int, world: int, spec: dict, forced: dict) -> dict:
    """One gloo rank of phase 34(a): the bf16 engine teacher-forced on the
    one-rank engine's tokens, then the float32 slice's engine free.  Rank 0
    returns the logits; every rank a digest of them (the sum of |logits|
    per request and position), which must be rank 0's."""
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(spec["mesh"], device="cuda:0")
    cfg = _serve_cfg(spec)
    out = {}
    for name, c, force in (("bf16", cfg, forced),
                           ("slice", _f32_slice(cfg, spec["slice_layers"]), None)):
        r = _tapped_engine(c, spec, mesh=mesh, force=force)
        r["digest"] = {rid: {i: float(t.abs().sum()) for i, t in rows.items()}
                       for rid, rows in r["logits"].items()}
        if rank:
            r["logits"] = None
        out[name] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _max_rel(got: dict, want: dict, first_only: bool = False) -> tuple[float, float]:
    """max|got - want| over every (request, position) of ``want``'s decode
    logits (or the first decode step's), and that over max|want|."""
    diff = scale = 0.0
    for rid, rows in want.items():
        for i, w in rows.items():
            if first_only and i != 1:
                continue
            diff = max(diff, float((got[rid][i] - w).abs().max()))
            scale = max(scale, float(w.abs().max()))
    return diff, diff / scale


def _mesh_engine() -> dict:
    """Phase 34(a) (see the module doc): the one-rank runs first (beside
    phase 35's ranks, none of this phase's), then the ranks."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import transformer as tf

    spec = MESH_ENGINE
    cfg = _serve_cfg(spec)
    world = math.prod(spec["mesh"].values())
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device="cuda")
    one = _tapped_engine(cfg, spec, params=params)
    forced = {rid: t.tolist() for rid, t in one["own"].items()}
    params = _upcast_(params)
    torch.cuda.empty_cache()
    f32 = _tapped_engine(dataclasses.replace(cfg, dtype="float32"), spec, params=params,
                         force=forced)
    del params
    torch.cuda.empty_cache()
    one_slice = _tapped_engine(_f32_slice(cfg, spec["slice_layers"]), spec)
    t_one = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn(world, mesh_engine_rank, spec, forced, tmpdir=tmp, backend="gloo",
                      timeout=600)
        t_spawn = time.perf_counter() - t0
    r0, s0 = ranks[0]["bf16"], ranks[0]["slice"]
    for rank, r in enumerate(ranks):  # every rank the same logits and tokens
        for name in ("bf16", "slice"):
            assert r[name]["digest"] == ranks[0][name]["digest"], (rank, name)
            assert all((r[name]["own"][k] == ranks[0][name]["own"][k]).all()
                       for k in ranks[0][name]["own"]), (rank, name)
    attn = sum(1 for blk in cfg.blocks() if blk in ("attn", "hymba"))
    fl = r0["launches"]["flash_attention"]
    assert fl == attn * spec["requests"], r0["launches"]  # one a layer, each prefill
    assert r0["designs"]["flash_attention"]["wgmma"] == fl, r0["designs"]
    assert r0["launches"]["gmm"] == r0["launches"]["matmul"] == 0, r0["launches"]
    assert r0["prefills"] == spec["requests"] and r0["decode_steps"] == one["decode_steps"]
    # the float32 slice: the one-rank engine's tokens, its first decode step's logits
    for rid, want in one_slice["own"].items():
        np.testing.assert_array_equal(s0["own"][rid], want, err_msg=f"slice request {rid}")
    sl_first, sl_first_rel = _max_rel(s0["logits"], one_slice["logits"], first_only=True)
    sl_all, sl_all_rel = _max_rel(s0["logits"], one_slice["logits"])
    if not sl_first_rel <= MESH_ENGINE_F32_TOL:
        raise AssertionError(f"mesh engine: the f32 slice's first decode step differs by "
                             f"{sl_first_rel:.3e} x max|logit| > {MESH_ENGINE_F32_TOL}")
    # bf16: no farther from the float32 run, over every step, than twice the one rank
    floor, floor_rel = _max_rel(one["logits"], f32["logits"])
    mesh_f32, mesh_f32_rel = _max_rel(r0["logits"], f32["logits"])
    mesh_one, mesh_one_rel = _max_rel(r0["logits"], one["logits"])
    first, first_rel = _max_rel(r0["logits"], one["logits"], first_only=True)
    if not mesh_f32 <= 2 * floor:
        raise AssertionError(f"mesh engine: max|mesh - f32| {mesh_f32:.3e} over twice the "
                             f"one-rank bf16 run's {floor:.3e}")
    equal = sum(int((r0["own"][k] == one["own"][k]).sum()) for k in one["own"])
    total = sum(len(t) for t in one["own"].values())
    scale = max(float(w.abs().max()) for rows in one["logits"].values() for w in rows.values())
    flip = max(MESH_SERVE_TOL * scale, 2 * floor)
    flips = []
    for rid, want in one["own"].items():  # a token the mesh would take otherwise
        for i in np.nonzero(r0["own"][rid] != want)[0].tolist():
            top2 = torch.topk(one["logits"][rid][i], 2).values
            margin = float(top2[0] - top2[1])
            flips.append({"request": rid, "position": i, "margin": margin})
            assert margin <= flip, (rid, i, margin, flip)
    walls = r0["walls"]
    log("mesh-engine", f"llama-7b bf16, {cfg.n_layers} layers, engine of {spec['slots']} "
                       f"slots, KV block {spec['block']}, {spec['requests']} requests of "
                       f"{[len(p) for p in _mesh_engine_prompts(cfg, spec)]} tokens, "
                       f"{spec['max_new']} new each, on {world} gloo ranks sharing the card, "
                       f"mesh {spec['mesh']}, decode policy {r0['policy']}: weight bytes a "
                       f"rank {[r['bf16']['weight_bytes'] for r in ranks]}, pool bytes a rank "
                       f"{[r['bf16']['pool_bytes'] for r in ranks]} (one rank "
                       f"{one['weight_bytes']} and {one['pool_bytes']}); peak a rank "
                       f"{[r['bf16']['peak_bytes'] for r in ranks]} B; flash launches a rank "
                       f"by design {r0['designs']['flash_attention']} ({fl} = {attn} layers x "
                       f"{spec['requests']} prefills); {r0['decode_steps']} decode steps, their "
                       f"walls {min(walls):.3f}-{max(walls):.3f} s (median "
                       f"{float(np.median(walls)):.3f} s; host-staged gloo, not a speed path), "
                       f"one rank's {float(np.median(one['walls'])):.4f} s; TTFT per request "
                       f"{ {k: round(v, 3) for k, v in r0['ttft_s'].items()} } s (one rank "
                       f"{ {k: round(v, 3) for k, v in one['ttft_s'].items()} }); teacher-forced "
                       f"on the one-rank engine's tokens, the mesh's own tokens equal "
                       f"{equal} of {total}, flips {flips or 'none'} (limit {flip:.3e}); "
                       f"max|mesh - one rank| {mesh_one:.3e} ({mesh_one_rel:.2e} of max|logit|, "
                       f"the first step {first_rel:.2e}), max|mesh - f32| {mesh_f32:.3e} "
                       f"against the one-rank bf16 run's {floor:.3e} ({floor_rel:.2e}; limit "
                       f"twice that); the f32 slice ({spec['slice_layers']} layers): tokens "
                       f"equal to one rank's, its first decode step {sl_first_rel:.2e} of "
                       f"max|logit| (limit {MESH_ENGINE_F32_TOL}), every step {sl_all_rel:.2e}, "
                       f"flash by design {s0['designs']['flash_attention']}; one-rank runs "
                       f"{t_one:.1f} s, ranks {t_spawn:.1f} s")
    return {"mesh": spec["mesh"], "layers": cfg.n_layers, "policy": r0["policy"],
            "weight_bytes": [r["bf16"]["weight_bytes"] for r in ranks],
            "pool_bytes": [r["bf16"]["pool_bytes"] for r in ranks],
            "one_rank_bytes": {"weights": one["weight_bytes"], "pool": one["pool_bytes"]},
            "peak_bytes": [r["bf16"]["peak_bytes"] for r in ranks],
            "flash_launches": fl, "flash_designs": r0["designs"]["flash_attention"],
            "slice_flash_designs": s0["designs"]["flash_attention"],
            "decode_walls_s": walls, "one_rank_decode_walls_s": one["walls"],
            "ttft_s": r0["ttft_s"], "one_rank_ttft_s": one["ttft_s"],
            "tokens_equal": equal, "tokens": total, "flips": flips,
            "max_abs_mesh_one_rank": mesh_one, "rel_mesh_one_rank": mesh_one_rel,
            "rel_first_step": first_rel, "max_abs_mesh_f32": mesh_f32,
            "max_abs_noise_floor": floor, "rel_noise_floor": floor_rel,
            "slice_rel_first_step": sl_first_rel, "slice_rel_every_step": sl_all_rel,
            "t_one_rank_s": t_one, "spawn_s": t_spawn}


def _donation(cfg, ops) -> dict:
    """Phase 34(b): phase 30(b)'s program compiled with ``donate=True``, in
    float32 and bf16: one warmed donated call (fresh feeds; the warm-up's
    were freed) against the memory pass's per-device peak with that
    donation set, its logits bit for bit the undonated call's, every feed
    raising afterwards."""
    from repro_torch.analysis import analyze_compiled
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.engine import DonatedTensor
    from repro_torch.frontend import Program
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.eingraphs import program_for

    prog = program_for(cfg, ShapeConfig("serve", "prefill", 512, 4))
    mesh = Mesh({"data": 1, "model": 1}, device="cuda")
    res = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        p = prog if dt == torch.float32 else Program.from_graph(_retyped(prog.graph, dt),
                                                                prog._out)
        plain = p.compile(mesh=mesh, executor="shard_map")
        run = p.compile(mesh=mesh, executor="shard_map", donate=True)
        static = analyze_compiled(run).memory
        kept = analyze_compiled(plain).memory
        with torch.inference_mode():
            want = plain(_graph_feeds(prog.graph, cfg, dt, seed=7))["logits"]
            run(_graph_feeds(prog.graph, cfg, dt, seed=7))  # warm-up
            torch.cuda.synchronize()
            gc.collect()
            feeds = _graph_feeds(prog.graph, cfg, dt, seed=7)
            ops.reset_launch_counts()
            out, measured = _allocator_peak(lambda: run(feeds), feeds)
            launches, designs = ops.launch_counts(), ops.design_counts()
        assert torch.equal(out["logits"], want), name
        assert all(type(t) is DonatedTensor for t in feeds.values()), name
        ratio = static["peak_bytes"] / measured["measured_bytes"]
        log("donate", f"llama-7b prefill graph, one rank, {name}, donate=True: memory pass "
                      f"peak {static['peak_bytes']} B at node {static['peak_pos']} (undonated "
                      f"{kept['peak_bytes']} B); allocator {measured['measured_bytes']} B "
                      f"(max_memory_allocated {measured['max_memory_allocated']} less "
                      f"{measured['allocated_before'] - measured['feed_bytes']} B held before "
                      f"the call that are not its feeds); static / measured {ratio:.6f}; "
                      f"logits bit for bit the undonated call's; all {len(feeds)} feeds "
                      f"raise afterwards; launches {launches} by design "
                      f"{ {k: designs[k] for k in ('matmul', 'flash_attention')} }")
        assert abs(ratio - 1.0) <= DONATE_BAND, (name, ratio, static["peak_bytes"], measured)
        res[name] = {"static_peak_bytes": static["peak_bytes"],
                     "static_peak_pos": static["peak_pos"],
                     "undonated_static_peak_bytes": kept["peak_bytes"], **measured,
                     "ratio": ratio, "launches": launches,
                     "designs": {k: designs[k] for k in ("matmul", "flash_attention")}}
        del feeds, out, want, run, plain
        torch.cuda.empty_cache()
    return res


def _engine_mesh_phase(cfg, ops) -> dict:
    """Phase 34: (a) the engine on a mesh, (b) donation."""
    t0 = time.perf_counter()
    out = {"engine": _mesh_engine()}
    gc.collect()
    torch.cuda.empty_cache()
    out["donate"] = _donation(cfg, ops)
    out["phase_s"] = time.perf_counter() - t0
    log("mesh-engine", f"phase 34 in {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 35: checkpoints of a run on a mesh; the gspmd executor's repairs
# ---------------------------------------------------------------------------

# 35(a): phase 31(b)'s cell (llama-7b at full width, 1 layer, float32,
# b=2, s=128) through train(mesh=, ckpt_dir=): 3 steps on {data: 2} with a
# checkpoint at step 2, then the run restarted from step 2 on each mesh
# here (ranks of their own) and on one rank (the main process)
CKPT_MESH = {"steps": 3, "every": 2, "b": 2, "s": 128, "run": {"data": 2},
             "restarts": {"data2": {"data": 2}, "model2": {"model": 2}}}
CKPT_STEP = "step_00000002"
CKPT_SAME_TOL = 1e-6   # the restart on the mesh that saved (bit-equal expected)
CKPT_OTHER_TOL = 1e-4  # onto another mesh: 31(b)'s limit for the card
# 35(b): graphs the gspmd executor once refused, on (pod, data, model) =
# (2, 2, 1), each planned over its split label: a prod aggregation, an
# opaque node of a rule registered here with no local lowering, and plan
# entries out of mesh order on a kept and on a contracted label
REPAIR_MESH = {"pod": 2, "data": 2, "model": 1}
REPAIR_PLANS = {"prod": {"i": ("data",), "j": ("pod",)},
                "custom": {"i": ("data",), "j": ("pod",)},
                "order": {"b": ("data", "pod")},
                "order-contracted": {"a": ("data", "pod")}}
REPAIR_OP, REPAIR_RULE = "chip_smoke_affine", "chip_smoke_nolocal"
# ... and llama-7b's width, 4 layers, float32, with the head dim split on
# "model" of (1, 2): one prefill (b=2, prompt 128) and 8 decode steps fed
# fixed tokens, through the dense cache and through a paged pool (KV block
# 16, admission by make_admit_fn), every step within 1e-4 of max|logit| of
# one rank's
DSPLIT = {"layers": 4, "mesh": {"data": 1, "model": 2}, "policy": {"d": "model"},
          "b": 2, "prompt": 128, "steps": 8, "block": 16}
DSPLIT_TOL = 1e-4


def _file_block(path: Path, i: int, t) -> np.ndarray:
    """This rank's block of leaf ``i``'s file, for ``t`` (a DTensor, or a
    whole tensor): the file memory-mapped and cut by the port's own
    placement rule (``gspmd.local_block``: each spec entry's axes split
    its dim in mesh order), not by the offsets restore read it with."""
    import types

    from repro_torch.core import gspmd

    arr = np.load(path / f"leaf{i:05d}.npy", mmap_mode="r")
    if not isinstance(t, gspmd.DTensor):
        return np.array(arr)
    dm = t.device_mesh
    names = dm.mesh_dim_names
    mesh = types.SimpleNamespace(axis_names=names, sizes=dict(zip(names, dm.shape)),
                                 coord=dict(zip(names, dm.get_coordinate())))
    spec = gspmd.spec_of_placements(t.placements, t.ndim, mesh)
    with warnings.catch_warnings():  # a read-only map: only the block is copied
        warnings.simplefilter("ignore", UserWarning)
        whole = torch.from_numpy(arr)
    return np.array(gspmd.local_block(whole, spec, mesh).numpy())


def _ckpt_taps() -> tuple[dict, Callable]:
    """Wrap the checkpoint module's gather, write and load in this process:
    each gather's wall and the card's peak during it (a save's share on this
    rank; ``held`` is what lay on the card before it), each write's wall and
    bytes (rank 0's background thread), each load's wall, and after each
    load every restored leaf's block on this rank against the same block of
    its file, bit for bit (every rank's block equal: the leaf's
    ``full_tensor()`` equals the file).  Returns the record and a function
    that undoes the wrapping."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import tree

    rec = {"gather": [], "write": [], "load": [], "restored": []}
    gather, write, load = ckpt._gather, ckpt._write, ckpt.load_checkpoint

    def gather_t(t):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = gather(t)
        torch.cuda.synchronize()
        rec["gather"].append({"wall_s": time.perf_counter() - t0, "held_bytes": held,
                              "peak_bytes": torch.cuda.max_memory_allocated()})
        return out

    def write_t(path, step, host, extra):
        t0 = time.perf_counter()
        write(path, step, host, extra)
        rec["write"].append({"step": step, "wall_s": time.perf_counter() - t0,
                             "bytes": sum(f.stat().st_size for f in Path(path).iterdir())})

    def load_t(path, like, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = load(path, like, **kw)
        torch.cuda.synchronize()
        rec["load"].append({"wall_s": time.perf_counter() - t0})
        equal = []
        for i, leaf in enumerate(tree.leaves(out[1])):
            mine = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            want = torch.from_numpy(_file_block(Path(path), i, leaf)).to(mine.device)
            equal.append(bool(mine.dtype == want.dtype and torch.equal(mine, want)))
            del want
        rec["restored"].append({"leaves": len(tree.leaves(out[1])),
                                "equal": sum(equal), "checked": len(equal)})
        return out

    ckpt._gather, ckpt._write, ckpt.load_checkpoint = gather_t, write_t, load_t

    def undo():
        ckpt._gather, ckpt._write, ckpt.load_checkpoint = gather, write, load

    return rec, undo


def _ckpt_train(mesh, ckpt_dir, device=None) -> dict:
    """train() of 35(a)'s cell: per step (step, loss, grad norm, wall), the
    launches by design (counts set to 0 just before)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    spec = CKPT_MESH
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train(_mesh_train_cfg(), ShapeConfig("ckpt", "train", spec["s"], spec["b"]),
                steps_total=spec["steps"], mesh=mesh, ckpt_dir=str(ckpt_dir),
                ckpt_every=spec["every"], log_every=1, device=device)
    wall = time.perf_counter() - t0
    launches = {"launches": ops.launch_counts(), "designs": ops.design_counts()}
    steps = [(s["step"], s["loss"], s["grad_norm"], s["wall_s"]) for s in out["steps"]]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "wall_s": wall, **launches}


def _dsplit_cfg():
    from repro_torch.configs import get_config

    return _f32_slice(get_config("llama-7b"), DSPLIT["layers"])


def _dsplit_tokens(cfg):
    rng = np.random.default_rng(35)
    return (rng.integers(0, cfg.vocab, size=(DSPLIT["b"], DSPLIT["prompt"])).astype(np.int32),
            rng.integers(0, cfg.vocab, size=(DSPLIT["steps"], DSPLIT["b"], 1)).astype(np.int32))


def _dsplit_run(policy=None, mesh=None) -> dict:
    """35(b)'s slice under ``policy`` on ``mesh`` (None: one rank, on the
    card alone): the dense cache's prefill and decode logits, then the
    paged pool's (two admissions, then the decode steps), all whole on the
    host in float32, the caches' specs, and the flash launches by design
    (counts set to 0 just before)."""
    from repro_torch.core import gspmd, tree
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.serve import prepare_decode_caches
    from repro_torch.models import transformer as tf
    from repro_torch.serving.paged_kv import make_admit_fn

    cfg, spec = _dsplit_cfg(), DSPLIT
    placed = mesh is not None
    params = (tf.init_placed_params(cfg, policy, mesh, seed=35) if placed
              else tf.init_params(cfg, seed=35, device="cuda"))
    prompts, fed = _dsplit_tokens(cfg)
    b, n = prompts.shape
    out = {"dense": [], "paged": []}

    def spec_of(t):
        return gspmd.spec_of_placements(t.placements, t.ndim, mesh) if placed else None

    def whole(logits):
        return gspmd.full(logits)[:, -1].float().cpu()

    ops.reset_launch_counts()
    with torch.no_grad():
        logits, caches = steps.make_prefill_step(cfg, policy=policy, mesh=mesh)(
            params, {"tokens": torch.as_tensor(prompts, device="cuda")})
        out["dense"].append(whole(logits))
        caches = prepare_decode_caches(cfg, caches, n, n + spec["steps"], policy=policy,
                                       mesh=mesh)
        out["dense_cache_spec"] = spec_of(caches[0].k)
        for i in range(spec["steps"]):
            logits, caches = tf.decode_step(params, torch.as_tensor(fed[i], device="cuda"),
                                            caches, n + i, cfg, policy=policy, mesh=mesh)
            out["dense"].append(whole(logits))
        del caches
        width = -(-(n + spec["steps"]) // spec["block"])  # blocks a slot
        tables = torch.arange(1, 1 + b * width, device="cuda", dtype=torch.int32).reshape(b, width)
        pool = tf.init_paged_caches(cfg, b, 1 + b * width, spec["block"], device="cuda")
        pool = tf.place_paged_caches(pool, cfg, b, 1 + b * width, spec["block"], policy, mesh)
        out["paged_pool_spec"] = spec_of(pool[0].k)
        admit = make_admit_fn(cfg)
        tokens = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
        for slot in range(b):
            logits, pre, _ = tf.forward(params, torch.as_tensor(prompts[slot:slot + 1],
                                                                device="cuda"),
                                        cfg, policy=policy, mesh=mesh, collect_cache=True,
                                        last_logit_only=True)
            out["paged"].append(whole(logits))
            tok0 = torch.argmax(gspmd.full(logits)[:, -1], dim=-1).to(torch.int32)
            pool, tokens = admit(pool, pre, tables[slot], slot, tok0, tokens)
        pos = torch.full((b,), n, dtype=torch.int32, device="cuda")
        for i in range(spec["steps"]):
            logits, pool = tf.decode_step_paged(
                params, torch.as_tensor(fed[i], device="cuda"), pool, tables, pos + i, cfg,
                policy=policy, mesh=mesh)
            out["paged"].append(whole(logits))
    torch.cuda.synchronize()
    out.update({"launches": ops.launch_counts(), "designs": ops.design_counts(),
                "weight_bytes": sum(_block_bytes(t) for t in tree.leaves(params))})
    del params, pool
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _link_step(root: Path, name: str, timeout: float = 600.0) -> None:
    """Once the uninterrupted run's step-2 checkpoint is complete (its
    directory appears by a rename), hard-link its files alone into
    ``root/name``, the directory of one restart."""
    src, dst = root / "run" / CKPT_STEP, root / name / CKPT_STEP
    deadline = time.monotonic() + timeout
    while not src.is_dir():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {src} after {timeout} s")
        time.sleep(0.5)
    dst.mkdir(parents=True)
    for f in src.iterdir():
        os.link(f, dst / f.name)


def ckpt_run_rank(rank: int, world: int, root: str) -> dict:
    """One gloo rank of 35(a)'s uninterrupted run on ``CKPT_MESH["run"]``;
    rank 0 then restarts it from step 2 on one rank (``train`` with no
    mesh), the other rank waiting at a barrier."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    root = Path(root)
    rec, undo = _ckpt_taps()
    out = {"run": dict(_ckpt_train(Mesh(CKPT_MESH["run"], device="cuda:0"), root / "run"),
                       taps=rec)}
    undo()
    if rank == 0:
        _link_step(root, "one")
        rec, undo = _ckpt_taps()
        out["one"] = dict(_ckpt_train(None, root / "one", device="cuda:0"), taps=rec)
        undo()
    dist.barrier()
    return out


def ckpt_restart_rank(rank: int, world: int, root: str, name: str) -> dict:
    """One gloo rank of 35(a)'s restart from step 2 onto the mesh ``name``
    of ``CKPT_MESH["restarts"]``; it starts beside the uninterrupted run
    and waits for its step-2 checkpoint (rank 0 links it).  The {model: 2}
    restart's ranks first run (b)'s head-dim-split slice on
    ``DSPLIT["mesh"]`` meanwhile (rank 0 returns its logits)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.policy import manual_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if name == "model2":
        out["dsplit"] = _dsplit_run(manual_policy(DSPLIT["policy"]),
                                    Mesh(DSPLIT["mesh"], device="cuda:0"))
        if rank:
            out["dsplit"]["dense"] = out["dsplit"]["paged"] = None
    mesh = Mesh(CKPT_MESH["restarts"][name], device="cuda:0")
    if rank == 0:
        _link_step(Path(root), name)
    dist.barrier()
    rec, undo = _ckpt_taps()
    out[name] = dict(_ckpt_train(mesh, Path(root) / name), taps=rec)
    undo()
    return out


class _NoLocalRule:
    """A shard rule with no lowering the DTensor executor may call."""

    name = REPAIR_RULE

    def lower(self, g, node, ax_n, sizes):
        raise AssertionError("the gspmd executor lowers this rule's nodes as replicated")


def _repair_graph(name: str):
    """(graph, {output: node id}, feeds) of a 35(b) graph."""
    from repro_torch.core import opaque_rules, opdef
    from repro_torch.core.einsum import EinGraph

    g = EinGraph(name)
    rng = np.random.default_rng(len(name))
    if name in ("prod", "custom"):
        x = g.input("x", "i j", (512, 64))
        if name == "custom":
            if REPAIR_RULE not in opaque_rules.RULES:
                opaque_rules.register_rule(_NoLocalRule())
                opdef.defop(REPAIR_OP, "i j -> i j", fn=lambda x: torch.as_tensor(x) * 2 + 1,
                            shard_rule=REPAIR_RULE)
            x = g.opaque(REPAIR_OP, [x], "i j", (512, 64), in_labels=[("i", "j")])
        agg = "prod" if name == "prod" else "sum"
        outs = {"y": g.einsum("i j -> i", x, combine="id", agg=agg)}
        feeds = {"x": (1 + 0.01 * rng.normal(size=(512, 64))).astype(np.float32)}
        return g, outs, feeds
    x = g.input("x", "b a", (512, 1024))
    w = g.input("w", "a f", (1024, 512))
    feeds = {"x": rng.normal(size=(512, 1024)).astype(np.float32),
             "w": (rng.normal(size=(1024, 512)) * 0.03).astype(np.float32)}
    return g, {"y": g.einsum("b a, a f -> b f", x, w)}, feeds


def repair_rank(rank: int, world: int) -> dict:
    """One gloo rank of 35(b)'s graphs through ``executor="gspmd"`` on
    ``REPAIR_MESH``: each output (whole; rank 0 returns it, every rank its
    sum of |y|), the opaque nodes' rules, the partial placements, and the
    launches a graph (counts set to 0 just before its call)."""
    from repro_torch.core.decomp import Plan
    from repro_torch.frontend import Program
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh(REPAIR_MESH, device="cuda:0")
    out = {}
    for name, axes in REPAIR_PLANS.items():
        g, outs, feeds = _repair_graph(name)
        plan = Plan(p=world, mode="mesh")
        plan.axes_by_node = {n.nid: dict(axes) for n in g.nodes}
        comp = Program.from_graph(g, outs).compile(mesh=mesh, executor="gspmd", plan=plan)
        ops.reset_launch_counts()
        y = comp(feeds)["y"].float().cpu()
        out[name] = {"y": y if rank == 0 else None, "digest": float(y.abs().sum()),
                     "rules": [st.rule for st in comp._fn.program if st.rule],
                     "partial": [st.partial for st in comp._fn.program if st.partial],
                     "launches": ops.launch_counts(), "designs": ops.design_counts()}
    return out


def _ckpt_walls(taps: dict) -> dict:
    return {"gather_s": [round(x["wall_s"], 3) for x in taps["gather"]],
            "write_s": [round(x["wall_s"], 3) for x in taps["write"]],
            "load_s": [round(x["wall_s"], 3) for x in taps["load"]]}


def _mesh_ckpt_start() -> dict:
    """Phase 35's spawns, started before phase 34 so that they run beside
    it (for the run's time limit; phase 34's ranks and its one-rank engine
    hold under 15 GB of the card): (a)'s uninterrupted run,
    its restarts onto {data: 2} and {model: 2}, which wait for the run's
    step-2 checkpoint (the latter's ranks run (b)'s head-dim-split slice
    meanwhile); (b)'s graphs.  Returns what ``_mesh_ckpt_phase``
    finishes."""
    from repro_torch.launch.mesh import spawn

    root = LOG.parent / "ckpt_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tmp = Path(tempfile.mkdtemp())
    pool = ThreadPoolExecutor(4)
    walls: dict = {}

    def cleanup():  # also where phase 34 fails: no 5.6 GB step left behind
        pool.shutdown(wait=True)
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)

    atexit.register(cleanup)

    def start(name, world, fn, *args):
        def run():
            t0 = time.perf_counter()
            out = spawn(world, fn, *args, tmpdir=tmp / name, backend="gloo", timeout=900)
            walls[name] = time.perf_counter() - t0
            return out
        return pool.submit(run)

    return {"t0": time.perf_counter(), "root": root, "cleanup": cleanup, "walls": walls,
            "run": start("run", 2, ckpt_run_rank, str(root)),
            "restarts": {name: start(name, 2, ckpt_restart_rank, str(root), name)
                         for name in CKPT_MESH["restarts"]},
            "graphs": start("graphs", 4, repair_rank)}


def _mesh_ckpt_phase(started: dict) -> dict:
    """Phase 35 (see the module doc), after phase 34: (b)'s one-card
    references here, then every check once the spawns are done.  The
    checkpoints are deleted at the end."""
    from repro_torch.frontend import Program

    t_phase = time.perf_counter()
    res: dict = {}
    root, walls = started["root"], started["walls"]
    try:
        dense = {}
        for name in REPAIR_PLANS:
            g, outs, feeds = _repair_graph(name)
            dense[name] = Program.from_graph(g, outs).compile(p=1)(feeds)["y"].float().cpu()
        one = _dsplit_run()
        gc.collect()
        torch.cuda.empty_cache()
        run_ranks = started["run"].result()
        restart_ranks = {name: f.result() for name, f in started["restarts"].items()}
        graph_ranks = started["graphs"].result()
        step_dir = root / "run" / CKPT_STEP
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        manifest = json.loads((step_dir / "manifest.json").read_text())
    finally:
        started["cleanup"]()  # 5.6 GB a step: 4 bytes a parameter, 3 times
    dsplit_ranks = [r["dsplit"] for r in restart_ranks["model2"]]
    restarts = {name: [r[name] for r in ranks] for name, ranks in restart_ranks.items()}
    one_restart = run_ranks[0]["one"]
    run_ranks = [r["run"] for r in run_ranks]

    # (a) held
    r0 = run_ranks[0]
    full = r0["steps"]
    assert [s[0] for s in full] == [0, 1, 2], full
    assert set(manifest) == {"step", "extra", "leaves"} and manifest["step"] == 2, manifest.keys()
    n_leaves = len(manifest["leaves"])
    rows = {}
    for name in list(CKPT_MESH["restarts"]) + ["one"]:
        ranks = [one_restart] if name == "one" else restarts[name]
        got, taps = ranks[0], ranks[0]["taps"]
        assert all([x[:3] for x in r["steps"]] == [x[:3] for x in got["steps"]]
                   for r in ranks), name  # every rank the same losses
        assert [s[0] for s in got["steps"]] == [2], (name, got["steps"])
        (_, loss, gnorm, wall), (_, want_loss, want_gnorm, _) = got["steps"][0], full[2]
        tol = CKPT_SAME_TOL if name == "data2" else CKPT_OTHER_TOL
        rel = (abs(loss - want_loss) / abs(want_loss), abs(gnorm - want_gnorm) / abs(want_gnorm))
        if not max(rel) <= tol:
            raise AssertionError(f"checkpoint restart {name}: step 2 loss {loss!r} grad norm "
                                 f"{gnorm!r} against the uninterrupted run's {want_loss!r} "
                                 f"{want_gnorm!r}: {rel} > {tol}")
        for r in ranks:  # every leaf's block on every rank
            (restored,) = r["taps"]["restored"]
            assert restored == {"leaves": n_leaves, "equal": n_leaves, "checked": n_leaves}, \
                (name, restored)
        assert [len(r["taps"]["write"]) for r in ranks] == [1] + [0] * (len(ranks) - 1), name
        rows[name] = {"loss": loss, "grad_norm": gnorm, "rel": rel, "step_wall_s": wall,
                      "train_wall_s": [r["wall_s"] for r in ranks],
                      "restore_s": [r["taps"]["load"][0]["wall_s"] for r in ranks],
                      "save_gather_s": [r["taps"]["gather"][0]["wall_s"] for r in ranks],
                      "save_write_s": taps["write"][0]["wall_s"],
                      "bit_equal": rel == (0.0, 0.0),
                      "launches": got["launches"]["flash_attention"],
                      "design": got["designs"]["flash_attention"]}
    for rank, r in enumerate(run_ranks):  # every rank the same losses
        assert [s[:3] for s in r["steps"]] == [s[:3] for s in full], rank
    run_taps = [r["taps"] for r in run_ranks]
    writes = [len(t["write"]) for t in run_taps]
    assert writes == [2, 0], writes  # rank 0 alone wrote steps 2 and 3
    fl = r0["launches"]["flash_attention"]
    assert r0["designs"]["flash_attention"]["ffma"] == fl > 0, r0["designs"]
    save_peaks = [max(x["peak_bytes"] for x in t["gather"]) for t in run_taps]
    log("mesh-ckpt", f"35(a) llama-7b width, {_mesh_train_cfg().n_layers} layer(s), f32, b=2, "
                     f"s=128 through train(mesh=, "
                     f"ckpt_dir=) on 2 gloo ranks sharing the card: uninterrupted on "
                     f"{CKPT_MESH['run']}, steps {[(s[0], s[1], s[2]) for s in full]} "
                     f"(walls {[round(s[3], 3) for s in full]} s); checkpoint of step 2: "
                     f"{n_leaves} leaves, {ckpt_bytes} bytes on disk, manifest keys "
                     f"{sorted(manifest)}; saves: gather walls a rank "
                     f"{[_ckpt_walls(t)['gather_s'] for t in run_taps]} s, rank 0's writes "
                     f"{_ckpt_walls(run_taps[0])['write_s']} s (background); peak a rank "
                     f"during save {save_peaks} B (held before it "
                     f"{[t['gather'][0]['held_bytes'] for t in run_taps]} B); train() "
                     f"{[round(r['wall_s'], 1) for r in run_ranks]} s; flash launches a rank "
                     f"{fl} by design {r0['designs']['flash_attention']}")
    for name, row in rows.items():
        log("mesh-ckpt", f"35(a) restart from step 2 onto {name}: step 2 loss "
                         f"{row['loss']!r} grad norm {row['grad_norm']!r} against "
                         f"{full[2][1]!r} {full[2][2]!r} (relative {row['rel'][0]:.3e}, "
                         f"{row['rel'][1]:.3e}; bit-equal {row['bit_equal']}; limit "
                         f"{CKPT_SAME_TOL if name == 'data2' else CKPT_OTHER_TOL}); every "
                         f"restored leaf's block on every rank bit-equal to its file's; "
                         f"restore walls {[round(x, 2) for x in row['restore_s']]} s, its "
                         f"save's gathers {[round(x, 2) for x in row['save_gather_s']]} s and "
                         f"write {row['save_write_s']:.2f} s, train() "
                         f"{[round(x, 1) for x in row['train_wall_s']]} s; flash launches "
                         f"{row['launches']} by design {row['design']}")
    res["ckpt"] = {"steps": full, "bytes": ckpt_bytes, "leaves": n_leaves,
                   "manifest_keys": sorted(manifest), "restarts": rows,
                   "save": {"gather_s": [_ckpt_walls(t)["gather_s"] for t in run_taps],
                            "write_s": _ckpt_walls(run_taps[0])["write_s"],
                            "write_bytes": [x["bytes"] for x in run_taps[0]["write"]],
                            "peak_bytes": save_peaks,
                            "held_bytes": [t["gather"][0]["held_bytes"] for t in run_taps]},
                   "train_wall_s": [r["wall_s"] for r in run_ranks],
                   "launches_per_rank": fl,
                   "design": r0["designs"]["flash_attention"]}

    # (b) the graphs
    g0 = graph_ranks[0]
    graphs_out = {}
    for name in REPAIR_PLANS:
        want = dense[name]
        for rank, r in enumerate(graph_ranks):
            assert r[name]["digest"] == g0[name]["digest"], (name, rank)
        err = float((g0[name]["y"] - want).abs().max())
        scale = float(want.abs().max())
        if not err <= GSPMD_TOL["float32"] * scale:
            raise AssertionError(f"gspmd {name}: max|mesh - one card| {err:.3e} over "
                                 f"{GSPMD_TOL['float32']} x {scale:.3e}")
        graphs_out[name] = {"max_abs_err": err, "scale": scale, "rules": g0[name]["rules"],
                            "partial": [list(map(list, p)) for p in g0[name]["partial"]],
                            "launches": g0[name]["launches"], "designs": g0[name]["designs"]}
        log("mesh-repairs", f"35(b) {name} on {REPAIR_MESH} (4 gloo ranks sharing the card) "
                            f"under {REPAIR_PLANS[name]}: max|mesh - one card| {err:.3e} of "
                            f"max {scale:.3e} (limit {GSPMD_TOL['float32']} relative); rules "
                            f"{g0[name]['rules']}, partials {g0[name]['partial']}; launches "
                            f"a rank {g0[name]['launches']}")
    assert graphs_out["custom"]["rules"] == ["replicate"], graphs_out["custom"]
    assert graphs_out["prod"]["partial"] == [[["pod", "product"]]], graphs_out["prod"]
    # (b) the head dim split
    d0 = dsplit_ranks[0]
    assert d0["dense_cache_spec"][-1] == "model" and d0["paged_pool_spec"][-1] == "model", \
        (d0["dense_cache_spec"], d0["paged_pool_spec"])
    worst = {}
    for kind in ("dense", "paged"):
        rels = []
        for i, (g, w) in enumerate(zip(d0[kind], one[kind])):
            rels.append(float((g - w).abs().max()) / float(w.abs().max()))
        assert len(rels) == len(one[kind]) > DSPLIT["steps"], (kind, len(rels))
        if not max(rels) <= DSPLIT_TOL:
            raise AssertionError(f"head dim split, {kind}: steps {rels} over {DSPLIT_TOL}")
        worst[kind] = rels
    dl = [r["launches"]["flash_attention"] for r in dsplit_ranks]
    n_flash = DSPLIT["layers"] * (1 + DSPLIT["b"])  # the dense prefill and one a slot
    assert dl == [n_flash] * 2 == [one["launches"]["flash_attention"]] * 2, (dl, one["launches"])
    assert d0["designs"]["flash_attention"]["ffma"] == n_flash, d0["designs"]
    log("mesh-repairs", f"35(b) llama-7b width, {DSPLIT['layers']} layers, f32, policy "
                        f"{DSPLIT['policy']} on {DSPLIT['mesh']}: dense cache "
                        f"{d0['dense_cache_spec']}, paged pool {d0['paged_pool_spec']} (KV "
                        f"block {DSPLIT['block']}); prefill and {DSPLIT['steps']} decode steps, "
                        f"max|mesh - one rank| / max|logit| per step: dense "
                        f"{[f'{x:.2e}' for x in worst['dense']]}, paged "
                        f"{[f'{x:.2e}' for x in worst['paged']]} (limit {DSPLIT_TOL}); weight "
                        f"bytes a rank {[r['weight_bytes'] for r in dsplit_ranks]} (one "
                        f"rank {one['weight_bytes']}); flash launches a rank {dl} by design "
                        f"{d0['designs']['flash_attention']}")
    res["repairs"] = {"graphs": graphs_out, "dsplit": {
        "rel": worst, "launches_per_rank": dl, "design": d0["designs"]["flash_attention"],
        "dense_cache_spec": d0["dense_cache_spec"], "paged_pool_spec": d0["paged_pool_spec"],
        "weight_bytes": [r["weight_bytes"] for r in dsplit_ranks]}}
    res["spawn_s"] = walls
    res["phase_s"] = time.perf_counter() - t_phase
    res["since_start_s"] = time.perf_counter() - started["t0"]
    log("mesh-ckpt", f"phase 35 in {res['phase_s']:.1f} s after phase 34, "
                     f"{res['since_start_s']:.1f} s since its spawns started beside phase 34 "
                     f"(each spawn's wall: {({k: round(v, 1) for k, v in walls.items()})} s)")
    return res


if __name__ == "__main__":
    sys.exit(main())
