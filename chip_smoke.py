#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits 1 and
prints no result line):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit; turns TF32 off for matmuls and cuDNN.
2. build: compiles every CUDA source of the port with nvcc (one process
   per source, started together) and prints the build time.
3. kernels: holds K7 (paged decode attention, split-KV) against its
   plain PyTorch version on the card (ragged tables, null-block entries,
   an inactive row, rows of 2048 keys down to 5: 16 splits of 128 keys,
   one split and none; rows whose causal end falls on a split boundary,
   at a split's last key and at the next one's first; subdivided pool
   blocks, paged_block_kv = 8, GQA at two widths, a sliding window),
   checks that a batched launch equals the batch-1 launches bitwise and
   that malformed operands raise, and times the kernel (split pass and
   merge), its plain version and one PyTorch library call at the serving
   path's shapes, with one call's device time by launch, beside its bound
   and its design's (the live bytes plus the partials written and read);
   then once more at pixtral-12b's serving shape (H=32, G=8, D=128) and
   at hymba-1.5b's (H=25, G=5: five query heads a KV head, padded to 8 in
   the kernel; D=64, window 1024 on a local layer, also checked on a
   global one in bf16 and f32).
4. soft-moe kernels: holds K1 (routing), K2 (combine from K1's stats)
   and K3 (online combine) against their plain PyTorch versions on the
   card at the Soft-MoE B/16 layer's shapes and at ragged ones (a token
   count that is not a multiple of the token block, the S/14-256E shape
   over several slot blocks and two of K2's 128-slot tiles, a single
   row, f32 inputs, a ragged d = 264, L/16's d = 1024, the granite LM
   layer's m = 2048, d = 1024, S = 32 over 32 of K1's token chunks),
   checks batched == batch-1 bitwise, that K2 on K1's stats agrees with
   K3 and K3's stats with K1's, and that malformed operands raise; then
   times each kernel, its plain version,
   one ``scaled_dot_product_attention`` call that computes its main
   output (the library yardstick) and the port's unfused einsum path of
   the same function, and reads each one's peak device memory above its
   inputs; K1, K2 and K3 are also timed at the granite layer's shapes
   beside the same SDPA call and einsum path, and at both layers beside
   the bound of the work their tensor-core design runs, with one call's
   device time by launch (pre-pass, main kernel, merge).
5. soft-moe backward kernels: holds K4 (dispatch backward) and K5
   (combine backward) against their plain PyTorch versions on the card at
   the B/16 layer in bf16 and f32, a ragged case (m = 45, d = 264, S = 40,
   also at 16 x 8 blocks), L/16's d = 1024, a case over several token
   chunks (``tuning.BWD_TILES`` token blocks, 64 tokens by default) with
   a ragged last one and over two 128-slot tiles (m = 300, d = 264, S =
   150) and the granite layer (m = 2048, d = 1024, S = 32), with the
   forward residuals from K1 and K2; checks that dX and dYs of a batched
   call equal batch-1 calls bitwise, that dPhi_n equals the row-order
   sum of the batch-1 dPhi_n's and is bitwise the same over two runs,
   and that malformed operands raise; then, at the B/16 and the granite
   layer, times each kernel beside its bound at the f32 rate and the
   bound of the work its tensor-core design runs, its plain version, the
   backward of the ``scaled_dot_product_attention`` call of phase 4 (the
   library yardstick) and the einsum path's backward, and profiles one
   call's device time by launch. The build prints each body's
   registers, shared memory and spills (ptxas).
6. routing health: holds K6 (the Fig. 9 routing-health reductions from
   K1's saved stats) against its plain PyTorch version and against the
   chunked oracle ``core.inspection.routing_health_from_stats`` on the
   card at the granite-moe-1b-a400m+soft layer (b = 8, m = 2048, d = 1024,
   S = 32) and the B/16 layer, in bf16 and f32, at a ragged case over
   several slot blocks and at rows of three of the kernel's token chunks
   with a ragged last one over two of its 128-slot tiles; checks the sum
   identities (per row the importance sums to m and the token
   contributions to S), batched == batch-1 and run-to-run bitwise, and
   that malformed operands raise; then, at the granite and the B/16
   layer, times the kernel beside its bound and its tensor-core design's
   bound, its plain version and the einsum path of the same reductions
   (no single PyTorch call computes them), with the device time of each
   launch of a call (norm pre-pass, main kernel, merge).
6b. invariant contraction: the fixed-order f32 product
   (``kernels/invariant_matmul.py``, ``csrc/invariant_matmul.cu``; no
   Pallas counterpart) that makes sparse MoE and MLA serving batch
   invariant: ``router_logits`` at granite-moe-1b-a400m's router (d
   1024, e 32) and deepseek-v2-lite's (d 2048, e 64) and
   ``batched_contract`` at MLA decode's two attention products (the
   probe's 64 keys and the served 2048), rows M in {1, 4, 8, 256, 2048}
   (at 2048 keys {1, 4, 8}): each within 1e-6 of max|ref| of its plain
   einsum, row 0 of every launch bitwise the 1-row launch (the plain
   einsum's own row 0 against its 1-row call logged beside it); every
   row (matrix) bitwise its 1-row (1-matrix) launch at counts across the
   launch plan's tile and split boundaries (deepseek's router to 8385
   rows, MLA prefill's products to 4096, MLA decode's values at 17
   matrices), with the plan logged; malformed operands raise; then its
   time (L2 flushed, median of 30)
   beside the plain einsum, one cuBLAS call (``torch.matmul`` /
   ``torch.bmm``) and its bound, from decode rows to training's 16384,
   and MLA prefill's products against the 2048-key view (a 32-token
   chunk, a 256-token chunk and a 2048-token forward: 512, 4096 and 32768
   rows), each held within 1e-6 of max|ref| of the f64 product with its
   row 0 bitwise the 1-row launch; and the back-to-back cost of a call
   at granite's decode router beside the einsum's and ``torch.matmul``'s.
The serving phases 7, 12-14, 17, 19 and 22 are host bound, so they serve
their models at full width with the depth cut (``SERVE_DEPTH``: the first
8 of qwen2-0.5b's and granite's 24 layers, 9 of deepseek's 27, 10 of
pixtral's 40, 12 of mamba2's 48, 16 of hymba's 32); phase 24 serves
qwen2-0.5b at full depth.

7. serve: full-width qwen2-0.5b (8 of 24 layers, random weights from a
   seeded generator, bf16 compute) answers 16 greedy requests through
   ``ServeEngine(backend="paged")``; the kernel's launch count must equal
   decode steps x 8. A second kernel engine then runs the same requests,
   and a burst of 8 short ones that keeps every slot decoding, tick by
   tick beside a gather-path engine (``use_kernel=False``), both
   prefilling in chunks of 256, teacher forced: the logits of every
   decoding row at every tick are held against the gather engine's.
8. vit: full-width, full-depth soft-moe-b/16-128e (random f32 weights from
   a seeded generator, bf16 compute) classifies a batch of 64 images
   through ``vit_apply`` / ``vit_features`` on the kernel path and on the
   einsum path under ``torch.inference_mode()``: K1 and K2 must launch 6
   times a forward and K3 never; the kernel path's pre-head features and
   one MoE layer's output are held against the einsum path's in bf16 and
   in f32 (the layer's input is captured from the model's own forward);
   then images/s, forward p50 and peak memory for each path, and a
   profiled window.
   K3 runs on the ops-level path that combines without saved stats
   (``kernels.ops.soft_moe_combine(..., c_stats=None)``), driven on one
   MoE layer and held against the layer's kernel path.
8b. sparse vit: the paper's sparse baselines at B/16 with 128 experts
   (``soft_moe_vit("b", 16, 128, variant=...)`` for ``tokens_choice`` and
   ``experts_choice``, random f32 weights, bf16 compute) run 10 batch-64
   forwards each beside soft-moe-b/16-128e on its kernel and einsum
   paths: forward p50, images/s and peak memory per path; K1 and K2
   launch once a MoE layer a forward on the Soft-MoE kernel path and
   never on the others.
9. train: full-width, full-depth soft-moe-b/16-128e training steps through
   ``train.make_train_step`` (batch 64 of ``data.SyntheticImages``, bf16
   compute, f32 params and AdamW moments, remat as the config sets it,
   the optimizer of ``examples/train_vit_softmoe.py``): the step-0 loss
   is ln 1000 (the head starts at zero); K1 and K2 launch 12 times a step
   and K4 and K5 6 times; at step 1 the kernel path's gradients of every
   MoE layer's phi and scale and of one expert leaf are held against the
   einsum path's in bf16 and in f32, and one MoE layer's whole gradient
   in f32; then the step time p50 over 7 steps, images/s, peak device
   memory, a profiled step, and a checkpoint round trip of one MoE
   layer's train state through ``checkpoint.CheckpointManager``, restored
   bitwise.
10. lm train: full-width, full-depth granite-moe-1b-a400m+soft (24 Soft-MoE
   layers of 32 one-slot experts, random f32 weights from a seeded
   generator, bf16 compute, f32 AdamW moments, remat and scan_layers as
   the config sets them) trains on batch 8 x 2048 tokens of
   ``data.SyntheticLM`` through ``lm_loss(use_kernel=True,
   telemetry=True)``, ``make_train_step`` and the ``Trainer``, which logs
   the flattened telemetry every step: at step 0 the kernel path's loss
   and every layer's telemetry are held against the einsum path's in
   bf16, and one MoE layer's telemetry in f32; the launches a step must
   be K1 48, K2 48, K4 24, K5 24, K6 24 (one a MoE layer: the remat
   recompute takes no telemetry) and K3 0; then step p50, tokens/s and
   peak memory over 7 Trainer steps (which end in a save of the whole
   train state), step p50 with telemetry on and off in turns, and a
   profiled step with K6's share of device time.
11. sparse lm train: full-width, full-depth granite-moe-1b-a400m as
   configured (24 Tokens Choice layers, top-8 of 32 experts, capacity
   factor 1.0, no BPR, groups of one sequence; random f32 weights, bf16
   compute) on batch 8 x 2048 of ``SyntheticLM`` through
   ``lm_loss(telemetry=True)`` and the ``Trainer`` (6 steps, the closing
   save skipped: phase 10 times one of this size). At step 0 the first
   MoE layer in f32, on the input the model feeds it, on the card
   against the host CPU: the share of (token, choice) pairs whose expert
   differs must be 0, and y, the aux loss and the dropped fraction agree
   within 1e-4; every layer's dropped fraction and expert load spread;
   K1-K6 must launch 0 times; step p50, tokens/s, peak memory and a
   profiled step by kernel group, beside phase 10's +soft numbers.
12. moe serve: the paged engine (K7, ``telemetry=True``, batch 8,
   max_len 2048, block 16) serves full-width granite-moe-1b-a400m and
   granite-moe-1b-a400m+soft (random weights, bf16 serving weights with
   the routing weights in f32) over 8 requests of 16-256 prompt tokens,
   16 new tokens each: every request finishes, K7 launches decode steps
   x layers times and K1-K6 never (serving runs the MoE einsum path), every
   MoE layer's routing keys are present and finite in
   ``telemetry_snapshot()``, the sparse ``dropped_fraction`` is 0
   (dropless), and greedy tokens with telemetry on equal those with it
   off; decode step p50 and tok/s on and off; ``router_logits`` launches
   once a sparse MoE layer a model call (never on +soft);
   ``batch_variance_probe`` (batch 4) on both granite configs and
   qwen2-0.5b, each below 1e-5 (the reference's contract), and on the
   sparse config through the ``batch_coupled`` hatch, which must read
   more than the default sparse config; and its bisection on the sparse
   config (``batch_variance_bisect``): the target row alone and
   co-batched at its first decode step, every layer's intermediates
   compared in call order, the greedy tokens of both runs, and the ops
   alone at the step's shapes (the products the fixed-order kernel took
   over, as the kernel and as the einsum it replaced).
13. mla serve: full-width deepseek-v2-lite-16b (MLA, layer 0 dense, the
   next 8 of its 26 Tokens Choice layers of top-6 of 64 experts + 2 shared;
   random weights drawn layer by layer and cast to the serving dtypes as
   drawn, ``serving_weights``, checked bitwise against
   ``serving_params(lm_init(...))`` at reduced size): one MLA layer in f32
   on the input the model feeds it, card against host CPU within 1e-5
   (no cache, a paged chunked prefill, decode steps, the latent pool);
   then the paged engine (``telemetry=True``, phase 12's geometry and
   trace): every request finishes, K7 and K1-K6 launch 0 times (MLA
   decode gathers, as in the reference), dropped 0 in every MoE layer,
   tokens with telemetry on == off; ``router_logits`` once a MoE layer
   and ``batched_contract`` 3 times an MLA layer a model call; decode
   p50, TTFT p50, prefill-chunk p50, tok/s and peak memory;
   ``batch_variance_probe`` (batch 4) below
   1e-5 and its bisection, which also runs every product of
   ``mla_apply`` alone (the bf16 projections, ``w_uk``, the scores, the
   weighted latent, ``w_uv``) and the dense layer 0's MLP.
14. vlm: full-width pixtral-12b, 10 of 40 layers (weights as in phase 13):
   ``lm_apply(embeds=)`` on 2 rows of 256 N(0, 1) patch embeddings + 256
   tokens under ``torch.inference_mode()``: finite logits of shape (2,
   512, 131072), forward p50 and peak memory; then text-only serving over
   phase 12's trace, K7 launches = decode steps x 10, and the kernel
   engine teacher forced against a gather-path engine (bound 5e-2).
15. long lm train: deepseek-v2-lite-16b at full width with the depth cut
   to 4 layers (layer 0 dense, 1-3 Tokens Choice as published; random
   f32 weights, bf16 compute, f32 AdamW moments) on batch 2 x 4096 of
   ``SyntheticLM``, where every MLA layer takes the chunked attention
   path: at step 0 the loss on the chunked path against the dense path
   (``layers.attention._CHUNKED_THRESHOLD`` raised in this script) within
   1e-3; then 5 Trainer steps through ``lm_loss(telemetry=True)`` (no
   closing save): step p50, tokens/s, peak memory, and the chunked
   attends counted (4 layers x 2 a step: the forward and the remat
   recompute).
16. ssm: one Mamba-2 (SSD) layer in f32 at mamba2-370m's width (d 1024,
   32 heads of 64, state 128) and hymba-1.5b's (d 1600, 50 heads, state
   16), card against the host CPU within 1e-5 of max|ref|: no cache at S
   = 2048; a cached chunked prefill (200 tokens, one row left-padded)
   continued over 100 more with the carried state and conv ring; 4
   decode steps; an inactive row whose ring and state stay bitwise as
   they were on the card.
17. ssm serve: full-width mamba2-370m (12 of 48 attention-free layers)
   and hymba-1.5b (16 of 32 layers of attention and Mamba-2 in parallel,
   window 1024 on 15, the 16th global) with bf16 serving weights (the SSM's
   A_log, D and dt_bias f32) through the paged engine over phase 12's
   geometry and trace (hymba's with one more prompt of 1200 tokens, past
   the window): every request finishes, the prefix cache is off, K7
   launches 0 for mamba2 and decode steps x 16 for hymba; every SSM
   layer's served outputs (chunked prefill, decode) against its no-cache
   chunked form on the inputs the engine fed it (5e-2 of max|ref| per
   layer), and every K7 call of hymba's kernel engine against the gather
   path on the same operands (one bf16 step); end to end, recorded beside
   each model's gain (its f32 logits' move under a 1e-6 nudge of the
   embedding, over 1e-6): mamba2's served logits teacher forced against a
   no-cache forward, hymba's kernel engine against its gather engine;
   decode p50, tok/s, peak memory, the SSM rows' bytes, a profiled window
   and ``batch_variance_probe`` (batch 4, recorded).
18. ssm train: full-width, full-depth mamba2-370m (random f32 weights,
   bf16 compute, f32 AdamW moments, remat) trained 5 Trainer steps on
   batch 8 x 2048 of ``SyntheticLM`` (no closing save): a finite loss,
   step p50, tokens/s, peak memory and a profiled step.
19. contiguous serve: ``ServeEngine(backend="contiguous")`` (the
   default: one 2048-slot ring row a slot, attention gathers the ring,
   no kernel) serves full-width qwen2-0.5b (8 layers) over phase 7's trace
   (prefill chunks of 256) beside the paged gather engine
   (``use_kernel=False``): every request
   finishes, K7 launches 0 times, decode p50, tok/s, peak_cache_bytes
   (8 x 2048 positions reserved) and peak memory of both; the two
   engines teacher forced within 5e-2 of max|ref| with the share of
   equal greedy tokens; a profiled window and ``batch_variance_probe``
   (batch 4) on the contiguous backend, below 1e-5. Then full-width
   hymba-1.5b (16 layers) in f32 on the contiguous engine (prefill
   chunks of 32), teacher forced
   within 1e-4 of max|ref|: phase 17's 8 short prompts against the paged
   gather engine, and its 1200-token prompt, which wraps the local
   layers' 1024-slot rings, against the same engine on the host CPU (the
   reference's ring truncates the window of a chunk's first queries once
   the ring wraps, the paged pool does not: that distance is recorded,
   beside the model's gain). Last, one MLA layer of deepseek-v2-lite at
   full width on a ring in f32, card vs host CPU within 1e-5: a prefill
   of 256, 4 decode steps, the inactive row's ring bitwise unchanged.
20. seamless serve: full-width, full-depth seamless-m4t-large-v2 (24
   encoder and 24 decoder layers, d 1024, vocab 256206; random weights,
   bf16 but the f32 embedding tables): encoder layer 0 and decoder
   block 0 in f32 card vs host CPU within 1e-5 (the decoder's
   self-attention on a ring and its cross-attention on cached K/V); then
   4 rows of 512 x 1024 frames encoded, a 16-token decoder prompt
   prefilled whole and 32 greedy decode steps through
   ``init_encdec_cache``: the decoded logits within 5e-2 of max|ref| of
   a teacher-forced full forward, encode ms, decode-step p50, tok/s,
   peak memory and one profiled decode step; K1-K7 launch 0 times.
21. seamless train: the same model (f32 weights and AdamW moments, bf16
   compute, the encoder under remat) trained 5 Trainer steps on batch 4
   x 512 tokens and 512 frames of 1024 of ``SyntheticSeq2Seq`` (no
   closing save): a finite loss within 1 of ln 256206, step p50,
   tokens/s, peak memory and a profiled step.
22. serving stack: full-width qwen2-0.5b (8 layers, phase 7's geometry
   and 16-request trace, prefill chunks of 256, random weights, bf16) served
   through
   ``AsyncServer`` over a paged kernel engine with span tracing and a
   256-tick flight recorder, 8 requests by ``generate`` and 8 by
   ``submit`` + ``stream``, concurrent: every request finishes, streams
   equal the final tokens, tokens bitwise equal to the same engine
   driven directly with tracing off, K7 = decode model calls x 8, every
   span timeline valid, ``/metrics`` fetched over the server's socket
   parses strictly, ``/healthz`` ok, a recorder dump with the
   reference's record keys; the decode tick p50 of one direct drive with
   span tracing off and on in turns (off, on, on, off).
   Speculative decoding (k = 4) on both backends in bf16 and f32 over 8
   prompts of repeated motifs: the verify lanes teacher forced on the
   plain stream (an oracle drafter) against the plain engine's decode
   logits (bf16: within 5e-2 of max|ref|; f32: greedy tokens of the
   n-gram engine equal up to the first step whose top-2 margin is below
   that distance), K7 0 on the speculative engines, leak-free pools,
   acceptance, calls per token, step p50 and tok/s beside the plain
   engine's. ``run_chaos`` at full width on the paged kernel engine
   (traced, leak-free), with an injected kernel failure (it surfaces from
   one tick, once, the rows of the failed call end in "error", every
   request terminal, the engine keeps launching K7), on the contiguous
   backend and on the speculative engine with a garbage drafter. A
   two-turn continuation with ``cache_generated`` gets prefix hits past
   its first prompt; a row forked with ``fork_slot`` shares its blocks
   at refcount 2 until its first write copies one, and decodes its
   source's greedy tokens.
23. distributed: on a world-1 NCCL ``DeviceMesh`` (data=1, model=1) from
   ``launch.mesh.make_host_mesh`` (no CPU fallback: a group that fails
   to start raises), full-width granite-moe-1b-a400m+soft, its first 12
   of 24 layers (``DIST_DEPTH``: the state's disk round trips
   paced the phase), trained 3 steps on batch 8 x 2048 (bf16 compute, telemetry off) from
   a ZeRO-1 state (``init_train_state(zero1=True)``: bf16 compute
   params, f32 master and moments) placed by ``state_shardings`` through
   the sharded step (``jit_train_step``), beside 3 steps of the plain f32
   state from the same seed: step p50, peak memory and state bytes of
   each, every loss and their differences; each ZeRO-1 loss bitwise equal
   to ``loss_fn`` at the bf16 cast of the master it started from, the
   compute params bitwise the master's cast after every step, and K1,
   K2, K4 and K5 launched 24, 24, 12 and 12 times a step (these go into
   the kernels line). Then ``pod_allreduce_compressed`` over the model's
   gradient tree on a (pod=1, data=1, model=1) mesh: within scale/2 of
   the input element by element (plus f32 rounding), the new residual
   bitwise corrected - out, ``pod_allreduce_mean`` its input bitwise;
   time and payload bytes. The elastic restore: the ZeRO-1 state saved
   after step 3 restored onto a 1-D data mesh and with no mesh, bitwise;
   save and restore GB/s. Last, ``make_a2a_moe`` at granite's expert
   width (E 32, top-8, d 1024, ff 512, SwiGLU; one layer of the
   as-configured model's router and experts, 16384 f32 tokens) against
   the dense dropless top-k within 1e-3 of max|ref|, and its time; its
   router launches ``router_logits`` once a call (these join the kernels
   line).
24. wave and roofline: the dry-runs of qwen2-0.5b (``train_4k`` on 256
   fake ranks, again on 512 with ``--multi-pod``, and ``decode_32k``)
   start as host-only subprocesses (no card, 180 s limit, each must
   print ``"status": "ok"``); meanwhile one f32 ``WaveEngine`` prefill of
   phase 7's first 8 prompts, right-aligned with pads at position -1,
   is held within 1e-4 of max|ref| of batch-1 unpadded prefills. Then
   full-width qwen2-0.5b in bf16 serves phase 7's 16 requests through
   ``WaveEngine`` (batch 8, max_len 2048), the contiguous and the paged
   ``ServeEngine`` (prefill chunks of 256), each warmed first: every
   request finishes, K7 launches paged decode calls x 24 and 0 on the
   other two, the wave's cache equals the ring's; tok/s, makespan,
   decode calls, decode p50, TTFT p50 and peak_cache_bytes of each, the
   share of greedy tokens the wave and the contiguous engine agree on;
   the analytic roofline of one wave decode step beside its p50, and
   phase 10's granite+soft step as a share of the bf16 peak in model
   FLOPs and in analytic FLOPs; last, the dry-runs' terms.
25. analysis and examples: the contract linter (``repro_torch.analysis``)
   on the card with the real kernels. The Soft-MoE grad program at
   soft-moe-b/16-128e's layer (b 64, m 196, d 768, S 128, d_ff 3072,
   bf16) is recorded once: no (m x S) plane forward or backward, K1, K2,
   K4 and K5 launched once each, each held against its plain version on
   the arguments the path gave it (f32 outputs within 1e-5 of max|ref|,
   bf16 within one bf16 step + 1e-5 of max|ref|); its einsum twin is
   flagged for the (64, 196, 128, 1) weights; its ops outside the
   kernels equal, as a multiset, the CPU recording of the same program
   (the kernels' plain versions, each wrapper one op), which a host-only
   subprocess makes. Every serving program of full-width
   qwen2-0.5b (batch 8, max_len 2048, block 16, K7 on) through the four
   program passes: clean but the allowlisted findings (paged verify and
   prefill_chunk gather the row view, the sampler's buffer, the block
   list's length), K7 once a layer. The five ``examples/torch/`` twins
   in process on ``cuda``: ``train_vit_softmoe --steps 3 --use-kernel``
   (finite losses, K1/K2/K4/K5 18 each), ``quickstart``, ``serve_lm
   --paged`` (every request finishes, K7 = decode calls x layers),
   ``serve_async --paged --trace --metrics-port 0`` (8 streams, /metrics
   scraped), ``contrastive_lit --steps 25`` (its loss falls). Last,
   ``python -m repro_torch.analysis --all --device cpu``, a host-only
   subprocess started with the CPU recording before phase 23 (so both
   run beside phases 23-25; 180 s from phase 25's end of card work),
   must print ``analysis: PASS``. These launches go into the kernels
   line.

Each phase logs its wall time. The lines before the last carry the
numbers: the card line as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
it, and one JSON object ``{"kernels": [...]}``. The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the
# float32 rate outside the tensor cores (the TPU kernels' arithmetic),
# and the dense tensor-core rates of TF32 and bf16.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# the reference's bound on batch_variance_probe for every served arch
# (src/repro/serve/telemetry.py, enforced by its serve benchmark)
PROBE_LIMIT = 1e-5

KERNEL_SOURCES = {
    "paged_decode_attend": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_attention_kernels.py:118",
    },
    "routing_fwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_routing.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:183",
    },
    "combine_apply": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_combine.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:456",
    },
    "combine_online": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_combine.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:462",
    },
    "dispatch_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_dispatch_bwd.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:529",
    },
    "combine_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_combine_bwd.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:658",
    },
    "routing_health": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_routing_health.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:294",
    },
    # no Pallas counterpart: the reference's XLA einsums these replace
    "router_logits": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/invariant_matmul.cu",
        "replaces": "src/repro/core/sparse_moe.py:53",
    },
    "batched_contract": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/invariant_matmul.cu",
        "replaces": "src/repro/layers/attention.py:121",
    },
}


def log(msg=""):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    res = build.build()
    log(f"[build] {len(res)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s wall")
    for name, r in res.items():
        log(f"[build] {name}: {r['seconds']:.2f} s -> {r['path']}")
        fn = ""
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                fn = kernel_label(line)
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {fn}: {line.strip()}")


def kernel_label(line):
    """'name<bf16|f32, tile>' from ptxas's 'Compiling entry function'
    line (a mangled name: its nested identifiers, each prefixed by its
    length, then its template arguments: the element type and, for the
    Soft-MoE kernels, K1's chunk rows in 32-token units or the slot tile's
    32-slot count (K2-K6); for the invariant contraction its output tile
    and B's staged layout)."""
    import re

    mangled = line.split("'")[1] if "'" in line else line
    names, pos = [], 2 + (mangled[2:3] == "N")  # after _Z or _ZN
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        n = int(digits)
        names.append(mangled[pos + len(digits):pos + len(digits) + n])
        pos += len(digits) + n
    label = next((x for x in names if x.endswith("_kernel")), mangled[:48])
    rest = mangled[pos:]
    args = []
    if "__nv_bfloat16" in rest:
        args.append("bf16")
    elif rest.startswith("If"):
        args.append("f32")
    nv = re.search(r"Li(\d+)E", rest)
    if nv and (label.endswith("bwd_kernel") or label in (
            "combine_apply_kernel", "combine_online_kernel",
            "health_kernel")):  # K2-K6
        args.append(f"slot tile {32 * int(nv.group(1))}")
    elif nv and label == "routing_kernel":  # K1: the chunk's token rows
        args.append(f"chunk <= {32 * int(nv.group(1))} tokens")
    elif label == "contract_kernel":  # <WM, WN, MT, NT, B k-fast>
        wm, wn, mt, nt = (int(v) for v in re.findall(r"Li(\d+)E", rest)[:4])
        kf = re.search(r"Lb(\d)E", rest)
        args.append(f"tile {16 * wm * mt} x {8 * wn * nt}, B "
                    f"{'[q][k]' if kf and kf.group(1) == '1' else '[k][q]'}")
    return label + (f"<{', '.join(args)}>" if args else "")


# ---------------------------------------------------------------------------
# phase 3: paged decode attention against its plain version
# ---------------------------------------------------------------------------


def make_paged_case(torch, seed, B, H, G, D, block_size, max_tokens, dtype,
                    lens):
    """Random pool with ragged per-row tables: physical blocks handed out
    top-down (not in logical order), a null-block hole in row 1's table,
    null entries past each row's end, and rows with len < 0 inactive."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nb = max_tokens // block_size
    nblk = B * nb + 1
    k = torch.randn(nblk, block_size, G, D, generator=gen, device="cuda")
    v = torch.randn(nblk, block_size, G, D, generator=gen, device="cuda")
    q = torch.randn(B, H, D, generator=gen, device="cuda")
    pos = torch.full((nblk, block_size), -1, dtype=torch.int32)
    tables = torch.zeros((B, nb), dtype=torch.int32)
    nxt = nblk - 1
    for r, ln in enumerate(lens):
        for lb in range(-(-ln // block_size) if ln > 0 else 0):
            if r == 1 and lb == 1:
                continue  # null-block hole: those positions were never written
            tables[r, lb] = nxt
            n = min(block_size, ln - lb * block_size)
            pos[nxt, :n] = torch.arange(lb * block_size, lb * block_size + n,
                                        dtype=torch.int32)
            nxt -= 1
    qpos = torch.tensor([ln - 1 if ln > 0 else -1 for ln in lens],
                        dtype=torch.int32)
    return (q.to(dtype), k.to(dtype), v.to(dtype), pos.cuda(), tables.cuda(),
            qpos.cuda())


def paged_bound_ms(q, k, tables, qpos, block_size, extra_bytes=0,
                   window=None):
    """Least time on the card: bytes each input/output must move (live
    keys only, those inside ``window`` of the query on a local layer;
    plus ``extra_bytes``) over HBM bandwidth vs flops over the f32
    rate."""
    B, H, D = q.shape
    G = k.shape[2]
    el = k.element_size()
    spans = [(max(0, p + 1 - window) if window else 0, p)
             for p in qpos.tolist() if p >= 0]
    keys = sum(p - lo + 1 for lo, p in spans)
    blocks = sum(p // block_size - lo // block_size + 1 for lo, p in spans)
    nbytes = (q.numel() * q.element_size()          # q
              + keys * (2 * G * D * el + 4)         # K, V, pos of live keys
              + blocks * 4 + B * 4                  # live table entries, q_pos
              + B * H * D * q.element_size()        # output
              + extra_bytes)
    flops = keys * H * 4 * D                        # q.k and p.v per head
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def paged_splits(tables, block_size, cfg=None):
    """(split_tiles, n_split) of K7 for these tables: the split policy of
    kernels/tuning.py."""
    from repro_torch.kernels.tuning import paged_config, paged_split_tiles

    bkv = paged_config(block_size, cfg).paged_block_kv
    st = paged_split_tiles(bkv)
    return st, -(-tables.shape[1] * (block_size // bkv) // st), bkv


def time_ms(torch, fn, reps=30, flush=None):
    """Median device time of fn() (CUDA events), with L2 flushed before
    every call when ``flush`` (a large tensor) is given: the serving path
    reads a different layer's pool at every call. Each call is queued
    behind a 2 ms device sleep, so the host has enqueued it before the
    start event fires and the events read device time only (for a
    host-bound ``fn`` its host time still shows)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)  # ~2 ms at the H100's clock
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase_kernels(torch):
    from repro_torch.kernels.paged_attention import (
        paged_decode_attend,
        paged_decode_attend_ref,
    )
    from repro_torch.kernels.tuning import KernelConfig

    # (atol, rtol) of |out - ref| <= atol + rtol |ref|, elementwise. In
    # bf16 both sides agree in f32 and then round to bf16, so they differ
    # by at most one bf16 step of the output, 2^-7 |ref|.
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0**-7)}
    # 128-key splits at block 16: 16 splits for 2048 keys, one for 17 and
    # 5, none for the inactive row 6
    lens8 = [2048, 1500, 1024, 700, 300, 17, -1, 5]
    # causal ends on split boundaries: a split's last key (256, 128), the
    # next split's first (129), a single key, one short of the table's
    # 2048, three whole splits, one short of a split
    edges = [256, 128, 129, 1, 2047, 384, -1, 127]
    bkv8 = KernelConfig(paged_block_kv=8)
    cases = [
        # (label, B, H, G, D, block_size, dtype, window, is_global, cfg,
        #  row lengths)
        ("slice bf16", 8, 14, 2, 64, 16, torch.bfloat16, None, True, None,
         lens8),
        ("slice f32", 8, 14, 2, 64, 16, torch.float32, None, True, None,
         lens8),
        ("slice f32 bkv=8", 8, 14, 2, 64, 16, torch.float32, None, True,
         bkv8, lens8),
        ("split edges bf16", 8, 14, 2, 64, 16, torch.bfloat16, None, True,
         None, edges),
        ("split edges f32 bkv=8", 8, 14, 2, 64, 16, torch.float32, None,
         True, bkv8, edges),
        ("block 192 f32", 8, 14, 2, 64, 192, torch.float32, None, True,
         None, lens8),
        ("H32 G8 D128 bf16", 8, 32, 8, 128, 16, torch.bfloat16, None, True,
         None, lens8),
        ("H32 G8 D128 f32", 8, 32, 8, 128, 16, torch.float32, None, True,
         None, lens8),
        ("window local bf16", 8, 14, 2, 64, 16, torch.bfloat16, 1024, False,
         None, lens8),
        ("window local f32", 8, 14, 2, 64, 16, torch.float32, 1024, False,
         None, lens8),
        ("window global f32", 8, 14, 2, 64, 16, torch.float32, 1024, True,
         None, lens8),
        # hymba-1.5b: 5 query heads a KV head (padded to HB = 8), window
        # 1024 on 30 of its 32 layers
        ("hymba local bf16", 8, 25, 5, 64, 16, torch.bfloat16, 1024, False,
         None, lens8),
        ("hymba local f32", 8, 25, 5, 64, 16, torch.float32, 1024, False,
         None, lens8),
        ("hymba global bf16", 8, 25, 5, 64, 16, torch.bfloat16, 1024, True,
         None, lens8),
        ("hymba global f32", 8, 25, 5, 64, 16, torch.float32, 1024, True,
         None, lens8),
    ]
    main = pixtral = hymba = {}
    for i, (label, B, H, G, D, bs, dt, window, is_global, kcfg, lens) in \
            enumerate(cases):
        max_tokens = 2112 if bs == 192 else 2048
        args = make_paged_case(torch, i, B, H, G, D, bs, max_tokens, dt,
                               lens)
        long_rows = [r for r, n in enumerate(lens) if n >= 1024]
        st, n_split, bkv = paged_splits(args[4], bs, kcfg)
        live = [math.ceil(math.ceil(max(n, 0) / bkv) / st) for n in lens]
        kw = dict(window=window, is_global=is_global, cfg=kcfg)
        out = paged_decode_attend(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_decode_attend_ref(*args, **kw)
        atol, rtol = tol[dt]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        within = bool((diff <= atol + rtol * ref.float().abs()).all())
        long_err = diff[long_rows].max().item()
        long_mag = ref[long_rows].float().abs().mean().item()
        finite = bool(torch.isfinite(out).all())
        inactive_zero = bool((out[6] == 0).all())
        rows = torch.cat([
            paged_decode_attend(*(a[r:r + 1] if j in (0, 4, 5) else a
                                  for j, a in enumerate(args)), **kw)
            for r in range(B)
        ])
        bitwise = torch.equal(rows, out)
        ok = within and finite and inactive_zero and bitwise
        log(f"[kernel] paged_decode_attend {label}: B={B} H={H} G={G} D={D} "
            f"block={bs} window={window} is_global={is_global} "
            f"{n_split} splits of {st * bkv} keys, live per row {live} "
            f"max_abs_err={err:.3e} (tol {atol:.0e} + {rtol:.4g}|ref|: "
            f"{within}) rows of >=1024 tokens: max_abs_err={long_err:.3e}, "
            f"mean |out| {long_mag:.3e}; finite={finite} "
            f"inactive_row_zero={inactive_zero} "
            f"batched==batch1_bitwise={bitwise}")
        if not ok:
            raise AssertionError(f"paged_decode_attend {label} failed")
        if label == "slice bf16":
            main = {"args": args, "err": err}
        elif label == "H32 G8 D128 bf16":
            pixtral = {"args": args}
        elif label == "hymba local bf16":
            hymba = {"args": args}

    # No fallback: malformed operands raise and launch nothing.
    q, k, v, pos, tables, qpos = main["args"]
    before = paged_decode_attend.launches
    for bad, why in (
        ((q, k.half(), v.half(), pos, tables, qpos), "float16 pool"),
        ((q, k.transpose(1, 2).contiguous().transpose(1, 2), v, pos,
          tables, qpos), "non-contiguous pool"),
        ((q, k, v, pos.long(), tables, qpos), "int64 positions"),
        ((*(t[..., :60].contiguous() for t in (q, k, v)), pos, tables, qpos),
         "head dim 60: 120 bytes, not whole 16-byte loads"),
        ((q, torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")[1:]
          .view(k.shape).copy_(k), v, pos, tables, qpos),
         "pool 2 bytes past a 16-byte boundary"),
    ):
        try:
            paged_decode_attend(*bad)
        except (TypeError, ValueError) as e:
            log(f"[kernel] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if paged_decode_attend.launches != before:
        raise AssertionError("a malformed call launched the kernel")

    # Times at the serving path's shapes (B=8, H=14, G=2, D=64, block 16),
    # then at pixtral-12b's (H=32, G=8, D=128), which phase 13 serves.
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    row = paged_times(torch, main["args"], flush,
                      "B=8 H=14 G=2 D=64 block 16, bf16")
    launch_times(torch, lambda: paged_decode_attend(*main["args"]),
                 "B=8 H=14 G=2 D=64 block 16 bf16", "paged_decode_attend",
                 tag="kernel")
    paged_times(torch, pixtral["args"], flush,
                "pixtral-12b's serving shape B=8 H=32 G=8 D=128 block 16, "
                "bf16")
    # hymba-1.5b's local layers (30 of 32): window 1024 over rows of up to
    # 2048 keys; the kernel masks the keys outside the window, and the
    # bound counts only those inside it
    paged_times(torch, hymba["args"], flush,
                "hymba-1.5b's serving shape B=8 H=25 G=5 D=64 block 16, "
                "window 1024 (local layer), bf16", window=1024)
    return {"paged_decode_attend": {"max_abs_err": main["err"], **row}}


def paged_times(torch, args, flush, shape, window=None):
    """K7 on ``args`` timed beside its plain version, one SDPA call over
    the gathered view (the library yardstick), its bound and its split
    design's bound; logs them and returns the kernels-line numbers.
    ``window`` times a local layer's call (keys more than ``window``
    before the query masked)."""
    from repro_torch.kernels.paged_attention import (
        paged_decode_attend,
        paged_decode_attend_ref,
    )

    q, k, v, pos, tables, qpos = args
    kw = dict(window=window, is_global=window is None)
    kernel_ms = time_ms(torch, lambda: paged_decode_attend(*args, **kw),
                        flush=flush)
    plain_ms = time_ms(torch, lambda: paged_decode_attend_ref(*args, **kw),
                       reps=5, flush=flush)
    B, H, D = q.shape
    G = k.shape[2]
    nb, bs = tables.shape[1], k.shape[1]
    idx = tables.long()
    kv_view = [t[idx].reshape(B, nb * bs, G, D) for t in (k, v)]
    kpos = pos[idx].reshape(B, nb * bs)
    qp = qpos[:, None].long()
    mask = (kpos >= 0) & (kpos <= qp)
    if window is not None:
        mask = mask & (kpos > qp - window)
    mask = mask[:, None, None, :]
    # G key/value heads, as the kernel reads them; SDPA groups the queries
    kg, vg = (t.transpose(1, 2).contiguous() for t in kv_view)
    qh = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(
        torch, lambda: sdpa(qh, kg, vg, attn_mask=mask, enable_gqa=True),
        flush=flush)
    bound_ms, bound_by = paged_bound_ms(q, k, tables, qpos, bs,
                                        window=window)
    # the split-KV design also writes and reads its partials
    _, n_split, _ = paged_splits(tables, bs)
    part_bytes = B * n_split * H * (D + 2) * 4
    design_ms, design_by = paged_bound_ms(q, k, tables, qpos, bs,
                                          2 * part_bytes, window=window)
    log(f"[kernel] paged_decode_attend timing ({shape}, L2 flushed): "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms(sdpa with enable_gqa over the gathered view)="
        f"{library_ms:.4f} bound={bound_ms * 1e3:.3f} us ({bound_by}); "
        f"design bound={design_ms * 1e3:.3f} us ({design_by}: with "
        f"{n_split} splits' partials, {part_bytes / 1e6:.3f} MB, written "
        f"and read)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 4: Soft-MoE routing and combine kernels against their plain versions
# ---------------------------------------------------------------------------


def soft_moe_case(torch, seed, b, m, d, s, dtype):
    """x (b, m, d), ys (b, S, d) in ``dtype``; phi_n (d, S) f32
    normalized with scale 1 (the ViT's init), all on the card."""
    from repro_torch.kernels.ref import normalized_phi

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, m, d, generator=gen, device="cuda").to(dtype)
    phi = torch.randn(d, s, generator=gen, device="cuda")
    ys = torch.randn(b, s, d, generator=gen, device="cuda").to(dtype)
    return x, normalized_phi(phi, 1.0), ys


def within(torch, got, want, atol, rtol):
    """(max |got - want|, all |got - want| <= atol + rtol |want|)."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.float().abs())
                                   .all())


def soft_moe_bounds(x, s, kind):
    """Least time on the card for one call: the bytes each input and output
    must move over HBM bandwidth vs the f32 flops (the logits 2 m S d, the
    mix 2 m S d, the norms 2 m d per row) over the f32 rate."""
    b, m, d = x.shape
    el = x.element_size()
    tokens = b * m * d * el                        # x in (and y out for K2/K3)
    slots = b * s * d * el                         # slots out / ys in
    phi = d * s * 4
    if kind == "routing":
        nbytes = tokens + phi + slots + 2 * b * s * 4 + 2 * b * m * 4
    else:  # combine: x, phi, ys, stats in or out, y
        nbytes = 2 * tokens + phi + slots + 2 * b * m * 4
    flops = b * (4 * m * s * d + 2 * m * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def soft_moe_fwd_design_bound(x, s, kind):
    """Least time on the card for the work the tensor-core design of K1,
    K2 and K3 runs (csrc/soft_moe_routing.cu, csrc/soft_moe_combine.cu):
    its two products of 2 m S d flops a row (the logits and the mix), as
    passes on the tensor cores at the dense TF32 peak (bf16 x: two passes
    each, the f32 operand split; f32 x: three), against the bytes of
    soft_moe_bounds plus, for K1 at the default tiling, the partials
    written once and read once: the chunks' slots (b, n_chunks, S, d) f32
    and their (max, denom) where a row has several token chunks, and the
    slot blocks' combine (max, denom) (b, n_slot_blocks, m) where it has
    several slot blocks. K2 and K3 write none at S <= 128 (the shapes
    timed here)."""
    from repro_torch.kernels.tuning import default_config, routing_chunk

    b, m, d = x.shape
    passes = 2 if x.element_size() == 2 else 3
    t_ops = 2 * passes * 2.0 * b * m * s * d / TF32_FLOPS
    nbytes = soft_moe_bounds(x, s, kind)[2]
    if kind == "routing":
        cfg = default_config(m, d, s)
        nch = -(-m // routing_chunk(m, s, cfg.block_tokens))
        nsb = -(-s // cfg.block_slots)
        if nch > 1:
            nbytes += 2 * b * nch * s * (d + 2) * 4
        if nsb > 1:
            nbytes += 2 * b * nsb * m * 2 * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, t_ops)


def launch_times(torch, kern, shape, name, tag="softmoe"):
    """Log the device time by launch of 5 profiled calls: for each kernel
    (the norm pre-pass, the main kernel, the merge or partial sums) the
    mean time of a launch, the launches the trace caught (it can miss one
    of the window's first launches, so a mean per launch, not a sum over
    5) and those launches per call; a launch's mean times its launches
    per call is the kernel's time in one call."""
    _, prof = profile_ticks(torch, types.SimpleNamespace(step=kern), 5)
    log(f"[{tag}] {name} device time by kernel, 5 calls ({shape}): "
        + "; ".join(f"{kname[:60]} {us / n:.1f} us a launch, {n} launches "
                    f"({n / 5:g} a call)" for kname, us, n in prof))


def softmoe_yardsticks(torch, x, phi_n, ys, flush, shape):
    """The yardsticks of K1-K3 on these operands: ({kind: sdpa_options(...)},
    {kind: the einsum path's call}) for kind "routing" and "combine"; logs
    each backend's time, why the others refused, and the l2norm pre-pass.

    The library yardstick: one scaled_dot_product_attention call computes
    each kernel's main output. Dispatch (K1's slots) is SDPA(q = Phi_n^T,
    k = l2norm(x), v = x), a softmax over tokens per slot; combine (K2/K3's
    y) is SDPA(q = l2norm(x), k = Phi_n^T, v = Ys), a softmax over slots
    per token; scale 1. SDPA takes one dtype, so Phi_n is cast to x's. The
    operands are made before the timed call; l2norm(x) is the O(b m d)
    pre-pass the kernels also run, timed on its own. Each backend is tried
    on Phi_n^T broadcast over the rows and copied per row, and the fastest
    call that runs is the yardstick. The einsum path is the port's unfused
    path of the same functions (use_kernel=False in core/soft_moe.py): the
    (b, m, S) weights, then the dispatch or the combine einsum."""
    from repro_torch.core.soft_moe import soft_moe_weights

    b, m, d = x.shape
    s = phi_n.shape[1]

    def l2norm():
        xf = x.float()
        return (xf / (xf.norm(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)

    xn4, x4, ys4 = l2norm()[:, None], x[:, None], ys[:, None]
    phi_b = phi_n.t().contiguous().to(x.dtype)[None, None].expand(b, 1, s,
                                                                  d)
    layouts = {"broadcast": phi_b, "copied": phi_b.contiguous()}
    library = {
        "routing": sdpa_options(torch, {k: (ph, xn4, x4)
                                        for k, ph in layouts.items()}, flush),
        "combine": sdpa_options(torch, {k: (xn4, ph, ys4)
                                        for k, ph in layouts.items()}, flush),
    }
    norm_ms = time_ms(torch, l2norm, flush=flush)
    for kind, (default, runs, refused) in library.items():
        log(f"[softmoe] sdpa for {kind} ({shape}): "
            f"default pick {default}; runs: "
            + "; ".join(f"{k} {ms:.4f} ms" for k, (ms, _) in runs.items())
            + f"; l2norm pre-pass {norm_ms:.4f} ms; refused: "
            + "; ".join(f"{k}: {why}" for k, why in refused.items()))

    phi3 = phi_n.reshape(d, s, 1)
    one = torch.ones((), device="cuda")

    def einsum_routing():
        d_w, _ = soft_moe_weights(x, phi3, one)
        return torch.einsum("bmd,bmnp->bnpd", x.float(), d_w).to(x.dtype)

    def einsum_combine():
        _, c_w = soft_moe_weights(x, phi3, one)
        return torch.einsum("bnpd,bmnp->bmd", ys.float().reshape(b, s, 1, d),
                            c_w).to(x.dtype)

    return library, {"routing": einsum_routing, "combine": einsum_combine}


def phase_soft_moe_kernels(torch):
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_apply_ref,
        combine_online,
        combine_online_ref,
        routing_fwd,
        routing_fwd_ref,
    )
    from repro_torch.kernels.tuning import (
        KernelConfig,
        combine_chunk,
        default_config,
        routing_chunk,
    )

    # Elementwise |out - ref| <= atol + rtol |ref|. Outputs: f32 within
    # 1e-5 relative; bf16 within one bf16 step, 2^-7 |ref| (both sides
    # agree in f32 and then round). Softmax stats are f32 on both sides.
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0**-7)}
    stat_tol = (1e-5, 1e-5)
    cases = [
        # (label, b, m, d, S, dtype, cfg); m = 196 is not a multiple of
        # the 32-token block; S = 256 is two of K2's and K3's 128-slot
        # tiles (K3 rescales between them)
        ("B/16 layer bf16", 64, 196, 768, 128, torch.bfloat16, None),
        ("B/16 layer f32", 64, 196, 768, 128, torch.float32, None),
        ("S/14-256E bf16", 8, 256, 384, 256, torch.bfloat16, None),
        ("S/14-256E f32 bt16 bs8", 8, 256, 384, 256, torch.float32,
         KernelConfig(block_tokens=16, block_slots=8)),
        ("single row bf16", 1, 196, 768, 128, torch.bfloat16, None),
        # d = 264: the last 64-column tile of the mix is ragged
        ("ragged m45 d264 S40 f32", 3, 45, 264, 40, torch.float32, None),
        # L/16's width: the logits once over all of d = 1024
        ("L/16 layer d1024 bf16", 8, 196, 1024, 128, torch.bfloat16, None),
        # granite-moe-1b-a400m+soft's layer at seq 2048: 32 of K1's
        # 64-token chunks, one slot block
        ("granite layer bf16", 8, 2048, 1024, 32, torch.bfloat16, None),
    ]
    main, granite = {}, None
    for i, (label, b, m, d, s, dt, kcfg) in enumerate(cases):
        x, phi_n, ys = soft_moe_case(torch, 100 + i, b, m, d, s, dt)
        atol, rtol = tol[dt]
        slots, d_stats, c_stats = routing_fwd(x, phi_n, kcfg)
        y2 = combine_apply(x, phi_n, ys, c_stats, kcfg)
        y3, st3 = combine_online(x, phi_n, ys, kcfg)
        torch.cuda.synchronize()
        r_slots, r_d, r_c = routing_fwd_ref(x, phi_n, kcfg)
        r_y2 = combine_apply_ref(x, phi_n, ys, c_stats, kcfg)
        r_y3, r_st3 = combine_online_ref(x, phi_n, ys, kcfg)
        errs, oks = {}, []
        for name, got, want, (a, r) in (
                ("K1 slots", slots, r_slots, (atol, rtol)),
                ("K1 d_mx", d_stats[0], r_d[0], stat_tol),
                ("K1 d_den", d_stats[1], r_d[1], stat_tol),
                ("K1 c_mx", c_stats[0], r_c[0], stat_tol),
                ("K1 c_den", c_stats[1], r_c[1], stat_tol),
                ("K2 y", y2, r_y2, (atol, rtol)),
                ("K3 y", y3, r_y3, (atol, rtol)),
                ("K3 c_mx", st3[0], r_st3[0], stat_tol),
                ("K3 c_den", st3[1], r_st3[1], stat_tol),
                # K2 on K1's stats vs K3; K3's stats vs K1's
                ("K2 vs K3 y", y2, y3, (atol, rtol)),
                ("K3 vs K1 c_mx", st3[0], c_stats[0], stat_tol),
                ("K3 vs K1 c_den", st3[1], c_stats[1], stat_tol)):
            errs[name], ok = within(torch, got, want, a, r)
            oks.append(ok)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (slots, y2, y3, *d_stats, *c_stats, *st3))
        # batched == batch-1, bitwise, on the first, second and last rows
        bitwise = True
        for r in sorted({0, min(1, b - 1), b - 1}):
            xr, yr = x[r:r + 1], ys[r:r + 1]
            sr, dr, cr = routing_fwd(xr, phi_n, kcfg)
            bitwise &= torch.equal(sr[0], slots[r])
            bitwise &= all(torch.equal(g[0], w[r])
                           for g, w in zip(dr + cr, d_stats + c_stats))
            cr_r = tuple(t[r:r + 1] for t in c_stats)
            bitwise &= torch.equal(combine_apply(xr, phi_n, yr, cr_r,
                                                 kcfg)[0], y2[r])
            y3r, st3r = combine_online(xr, phi_n, yr, kcfg)
            bitwise &= torch.equal(y3r[0], y3[r])
            bitwise &= all(torch.equal(g[0], w[r])
                           for g, w in zip(st3r, st3))
        cfg = kcfg or default_config(m, d, s)
        ct = routing_chunk(m, s, cfg.block_tokens)
        log(f"[softmoe] {label}: b={b} m={m} d={d} S={s} "
            f"{str(dt).replace('torch.', '')} K1 chunks={-(-m // ct)} of "
            f"{ct} tokens, slot blocks={-(-s // cfg.block_slots)}; K2/K3 "
            f"chunks of {combine_chunk(cfg.block_tokens)} tokens, "
            f"{-(-s // 128)} slot tile(s) "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f" (tol outputs {atol:.0e} + {rtol:.4g}|ref|, stats "
            f"{stat_tol[0]:.0e} + {stat_tol[1]:.0e}|ref|: {all(oks)}); "
            f"finite={finite} batched==batch1_bitwise={bitwise}")
        if not (all(oks) and finite and bitwise):
            raise AssertionError(f"soft-moe kernels {label} failed")
        if label.startswith("granite"):
            granite = (x, phi_n, ys, c_stats)
        if i == 0:
            main = {"args": (x, phi_n, ys), "c_stats": c_stats,
                    "err": {"routing_fwd": max(errs[k] for k in errs
                                               if k.startswith("K1")),
                            "combine_apply": errs["K2 y"],
                            "combine_online": max(errs["K3 y"],
                                                  errs["K3 c_mx"],
                                                  errs["K3 c_den"])}}

    # No fallback: malformed operands raise and launch nothing.
    x, phi_n, ys = main["args"]
    counts = lambda: (routing_fwd.launches, combine_apply.launches,  # noqa: E731
                      combine_online.launches)
    before = counts()
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    for call, exc, why in (
            (lambda: routing_fwd(x.half(), phi_n), TypeError, "float16 x"),
            (lambda: routing_fwd(x, phi_n.double()), TypeError,
             "float64 phi_n"),
            (lambda: combine_online(x, phi_n, ys.float()), TypeError,
             "ys dtype != x dtype"),
            (lambda: routing_fwd(x.transpose(1, 2).contiguous()
                                 .transpose(1, 2), phi_n), ValueError,
             "non-contiguous x"),
            (lambda: routing_fwd(x[..., :764].contiguous(),
                                 phi_n[:764].contiguous()), ValueError,
             "d=764, not a multiple of 8"),
            (lambda: routing_fwd(shifted, phi_n), ValueError,
             "x 2 bytes past a 16-byte boundary"),
            (lambda: routing_fwd(x, phi_n, KernelConfig(block_tokens=64)),
             ValueError, "block_tokens=64 > 32"),
            (lambda: combine_apply(x, phi_n, ys, (main["c_stats"][0][:, :5],
                                                  main["c_stats"][1])),
             ValueError, "stats of the wrong shape"),
            (lambda: routing_fwd(x, phi_n.clone().requires_grad_()),
             NotImplementedError, "phi_n requires grad (a raw kernel has no "
             "backward)")):
        try:
            call()
        except exc as e:
            log(f"[softmoe] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if counts() != before:
        raise AssertionError("a malformed call launched a kernel")

    # Times at the B/16 layer's shapes (b=64, m=196, d=768, S=128, bf16).
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    c_stats = main["c_stats"]
    calls = {
        "routing_fwd": (lambda: routing_fwd(x, phi_n),
                        lambda: routing_fwd_ref(x, phi_n), "routing"),
        "combine_apply": (lambda: combine_apply(x, phi_n, ys, c_stats),
                          lambda: combine_apply_ref(x, phi_n, ys, c_stats),
                          "combine"),
        "combine_online": (lambda: combine_online(x, phi_n, ys),
                           lambda: combine_online_ref(x, phi_n, ys),
                           "combine"),
    }
    b, m, d = x.shape
    s = phi_n.shape[1]
    library, einsum = softmoe_yardsticks(torch, x, phi_n, ys, flush,
                                         "b=64 m=196 d=768 S=128 bf16")

    def peak_above(fn):
        """Peak device bytes fn() allocates above what is live before."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    out = {}
    for name, (kern, plain, kind) in calls.items():
        want = kern()[0] if name != "combine_apply" else kern()
        label, (library_ms, lib_call) = min(library[kind][1].items(),
                                            key=lambda r: r[1][0])
        lib_err = (lib_call()[:, 0].float() - want.float()).abs().max().item()
        if lib_err > 2e-2:  # the yardstick must compute the same function
            raise AssertionError(f"sdpa ({label}) differs from {name} by "
                                 f"{lib_err:.3e}")
        kernel_ms = time_ms(torch, kern, flush=flush)
        plain_ms = time_ms(torch, plain, reps=3, flush=flush)
        einsum_ms = time_ms(torch, einsum[kind], flush=flush)
        mem = {k: peak_above(f) / 2**20 for k, f in (
            ("kernel", kern), ("sdpa", lib_call), ("einsum", einsum[kind]))}
        bound_ms, bound_by, nbytes, flops = soft_moe_bounds(x, s, kind)
        design_ms, design_by, d_bytes, d_ops = soft_moe_fwd_design_bound(
            x, s, kind)
        design = (f"; design bound={design_ms * 1e3:.2f} us ({design_by}"
                  f": {d_bytes / 1e6:.1f} MB with the partials, "
                  f"{d_ops * 1e6:.2f} us of tensor-core passes)")
        log(f"[softmoe] {name} timing (b=64 m=196 d=768 S=128 bf16, L2 "
            f"flushed): kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (scaled_dot_product_attention, "
            f"{label}; max|sdpa - kernel| {lib_err:.3e}) "
            f"einsum_path_ms={einsum_ms:.4f} (the port's unfused path) "
            f"bound={bound_ms * 1e3:.2f} us ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) -> "
            f"{flops / kernel_ms / 1e9:.2f} TFLOP/s{design}; peak MiB above "
            f"the inputs: kernel {mem['kernel']:.1f}, sdpa {mem['sdpa']:.1f}"
            f", einsum path {mem['einsum']:.1f}")
        launch_times(torch, kern, "b=64 m=196 d=768 S=128 bf16", name)
        out[name] = {"max_abs_err": main["err"][name], "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "einsum_path_ms": einsum_ms}

    # K1 and K2 at the granite layer's shapes, as the LM training phase
    # runs them (b=8, m=2048, d=1024, S=32, bf16): 32 token chunks a row
    # for each; K3 beside them; the same yardsticks as at B/16
    gx, gphi, gys, gstats = granite
    shape = "b=8 m=2048 d=1024 S=32 bf16"
    library, einsum = softmoe_yardsticks(torch, gx, gphi, gys, flush, shape)
    for name, kern, kind in (
            ("routing_fwd", lambda: routing_fwd(gx, gphi), "routing"),
            ("combine_apply", lambda: combine_apply(gx, gphi, gys, gstats),
             "combine"),
            ("combine_online", lambda: combine_online(gx, gphi, gys),
             "combine")):
        want = kern() if name == "combine_apply" else kern()[0]
        label, (library_ms, lib_call) = min(library[kind][1].items(),
                                            key=lambda r: r[1][0])
        lib_err = (lib_call()[:, 0].float() - want.float()).abs().max().item()
        if lib_err > 2e-2:
            raise AssertionError(f"sdpa ({label}) differs from {name} at "
                                 f"the granite layer by {lib_err:.3e}")
        bound_ms, bound_by, nbytes, flops = soft_moe_bounds(
            gx, gphi.shape[1], kind)
        design_ms, design_by, d_bytes, d_ops = soft_moe_fwd_design_bound(
            gx, gphi.shape[1], kind)
        ms = time_ms(torch, kern, flush=flush)
        einsum_ms = time_ms(torch, einsum[kind], flush=flush)
        log(f"[softmoe] {name} timing at the granite layer ({shape}, L2 "
            f"flushed): kernel_ms={ms:.4f} library_ms={library_ms:.4f} "
            f"(scaled_dot_product_attention, {label}; max|sdpa - kernel| "
            f"{lib_err:.3e}) einsum_path_ms={einsum_ms:.4f} "
            f"bound={bound_ms * 1e3:.2f} us ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) -> "
            f"{flops / ms / 1e9:.2f} TFLOP/s; design bound="
            f"{design_ms * 1e3:.2f} us ({design_by}: {d_bytes / 1e6:.1f} MB "
            f"with the partials, {d_ops * 1e6:.2f} us of tensor-core "
            f"passes)")
        launch_times(torch, kern, shape, name)
        out[name]["granite"] = {"ms": ms, "bound_ms": bound_ms,
                                "library_ms": library_ms,
                                "einsum_path_ms": einsum_ms}
    return out


def sdpa_options(torch, operands, flush):
    """Time one scaled_dot_product_attention call (scale 1) on each
    operand layout in ``operands`` ({layout: (q, k, v)}) under each
    backend that takes it. Returns (the backend PyTorch picks by default
    for the first layout, {"BACKEND, layout": (ms, call)}, {"BACKEND,
    layout": why it refused})."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    default = sdp_backend(torch, *next(iter(operands.values())))
    runs, refused = {}, {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for layout, qkv in operands.items():
            def call(qkv=qkv, be=be):
                with sdpa_kernel([be]):
                    return sdpa(*qkv, scale=1.0)

            key = f"{be.name}, {layout}"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    call()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    why = [str(w.message).split(" (Triggered internally")[0]
                           for w in caught]
                    why = [w for w in why if not w.endswith("because:")]
                    refused[key] = " | ".join(why or [str(e)])[:400]
                    continue
            runs[key] = (time_ms(torch, call, flush=flush), call)
    return default, runs, refused


def sdp_backend(torch, q, k, v):
    """Name of the backend scaled_dot_product_attention picks for these
    operands (a private query of PyTorch's; "unknown" where it is not
    there)."""
    try:
        idx = torch._fused_sdp_choice(q, k, v, None, 0.0, False, scale=1.0)
        from torch.nn.attention import SDPBackend
        return next(n for n, e in SDPBackend.__members__.items()
                    if int(e.value) == int(idx))
    except (AttributeError, ImportError, RuntimeError, StopIteration,
            TypeError):
        return "unknown"


# ---------------------------------------------------------------------------
# phase 5: the Soft-MoE backward kernels (K4, K5) against their plain versions
# ---------------------------------------------------------------------------


def soft_moe_bwd_bounds(x, s, kind):
    """Least time on the card for one backward call: the bytes the kernel's
    own operands must move (x, Phi_n, the gradient, the stats and the
    sigma / rho row terms in; dX, dPhi_n and, for K5, Ys in and dYs out)
    over HBM bandwidth vs the least f32 flops, 10 m S d a row (the logits,
    x . g or g . Ys, and three products), over the f32 rate."""
    b, m, d = x.shape
    el = x.element_size()
    tokens, slots, phi = b * m * d * el, b * s * d * el, d * s * 4
    if kind == "dispatch":  # x, g_slots in; dx out; stats and sigma (b, S)
        nbytes = 2 * tokens + slots + 2 * phi + 3 * b * s * 4
    else:  # x, g, ys in; dx, dys out; stats and rho (b, m)
        nbytes = 3 * tokens + 2 * slots + 2 * phi + 3 * b * m * 4
    flops = b * 10 * m * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def soft_moe_bwd_design_bound(x, s, kind):
    """Least time on the card for the work the tensor-core design of K4
    and K5 runs (csrc/soft_moe_bwd.cuh): its five products of 2 m S d
    flops a row each, as passes on the tensor cores at their dense peaks
    (bf16 x: the bf16 x . g or g . Ys product one bf16 pass, the other
    four 9 TF32 passes; f32 x: 14 TF32 passes), against the bytes of
    soft_moe_bwd_bounds plus the chunk partials (b, n_chunks, S, d) f32,
    written once and read once (K4: dPhi_n's; K5: dPhi_n's and dYs')."""
    from repro_torch.kernels.tuning import BWD_TILES, default_config

    b, m, d = x.shape
    unit = 2.0 * b * m * s * d
    if x.element_size() == 2:
        t_ops = 9 * unit / TF32_FLOPS + unit / BF16_FLOPS
    else:
        t_ops = 14 * unit / TF32_FLOPS
    ct = BWD_TILES * default_config(m, d, s).block_tokens
    part = b * -(-m // ct) * s * d * 4
    nbytes = (soft_moe_bwd_bounds(x, s, kind)[2]
              + 2 * part * (1 if kind == "dispatch" else 2))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, t_ops)


def bwd_case(torch, seed, b, m, d, s, dtype, cfg):
    """The backward kernels' operands on the card: the forward's residuals
    from K1 and K2 (slots, both stats pairs, y) and random gradients."""
    from repro_torch.kernels.soft_moe_kernels import combine_apply, routing_fwd

    x, phi_n, ys = soft_moe_case(torch, seed, b, m, d, s, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    g_slots = torch.randn(b, s, d, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, m, d, generator=gen, device="cuda").to(dtype)
    with torch.no_grad():
        slots, d_stats, c_stats = routing_fwd(x, phi_n, cfg)
        y = combine_apply(x, phi_n, ys, c_stats, cfg)
    return dict(x=x, phi_n=phi_n, ys=ys, g_slots=g_slots, g=g, slots=slots,
                d_stats=d_stats, c_stats=c_stats, y=y)


def phase_soft_moe_bwd_kernels(torch):
    from repro_torch.kernels.soft_moe_kernels import (
        combine_bwd,
        combine_bwd_ref,
        dispatch_bwd,
        dispatch_bwd_ref,
    )
    from repro_torch.kernels.tuning import (
        BWD_TILES,
        KernelConfig,
        default_config,
    )

    # Tolerances, on max |got - want| / max |want| per output: f32 within
    # 1e-5 (the two sides sum in other orders); bf16 outputs elementwise
    # within one bf16 step of the plain version's, 2^-7 |want|, plus the
    # f32 tolerance 1e-5 max |want| (both sides agree in f32, then round;
    # an element that cancels to near 0 keeps only the f32 agreement).
    # dPhi_n is f32 in every case.
    cases = [
        # (label, b, m, d, S, dtype, cfg); m = 196 is not a multiple of
        # the 32-token block
        ("B/16 layer bf16", 64, 196, 768, 128, torch.bfloat16, None),
        ("B/16 layer f32", 64, 196, 768, 128, torch.float32, None),
        # 264 of a 384-column chunk's columns lie inside d; a ragged
        # last slot block (40 = 32 + 8) and token block (45 = 32 + 13)
        ("ragged m45 d264 S40 f32", 3, 45, 264, 40, torch.float32, None),
        ("ragged m45 d264 S40 bf16 bt16 bs8", 3, 45, 264, 40,
         torch.bfloat16, KernelConfig(block_tokens=16, block_slots=8)),
        # L/16's width: two 768-column chunks
        ("L/16 layer d1024 bf16", 8, 196, 1024, 128, torch.bfloat16, None),
        # several token chunks with a ragged last one (300 = 4 x 64 + 44),
        # two slot tiles with a ragged last one (150 = 128 + 22), a ragged
        # last d-tile (264 = 8 x 32 + 8)
        ("chunks m300 d264 S150 f32", 2, 300, 264, 150, torch.float32,
         None),
        # granite-moe-1b-a400m+soft's layer at seq 2048
        ("granite layer bf16", 8, 2048, 1024, 32, torch.bfloat16, None),
    ]

    def check(got, want, dt):
        diff = (got.float() - want.float()).abs()
        top = want.float().abs().max()
        rel = (diff.max() / top).item()
        if got.dtype == torch.float32 or dt == torch.float32:
            return diff.max().item(), rel, rel <= 1e-5
        ok = bool((diff <= 2.0**-7 * want.float().abs() + 1e-5 * top).all())
        return diff.max().item(), rel, ok

    # the main kernels' dynamic shared memory a CTA (ptxas prints their
    # registers and spills in the build phase)
    import ctypes

    from repro_torch.kernels.build import load
    for lib in ("soft_moe_dispatch_bwd", "soft_moe_combine_bwd"):
        fn = getattr(load(lib), f"{lib}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        log(f"[softmoe-bwd] {lib} shared memory a CTA: " + ", ".join(
            f"{dn} S={s}: {fn(code, s)} B" for dn, code in (("bf16", 1),
                                                           ("f32", 0))
            for s in (32, 64, 128)))

    main, granite = {}, None
    for i, (label, b, m, d, s, dt, kcfg) in enumerate(cases):
        c = bwd_case(torch, 300 + i, b, m, d, s, dt, kcfg)
        if label.startswith("granite"):
            granite = c
        args4 = (c["x"], c["phi_n"], c["g_slots"], c["d_stats"], c["slots"])
        args5 = (c["x"], c["phi_n"], c["ys"], c["g"], c["c_stats"], c["y"])
        dx4, dphi4 = dispatch_bwd(*args4, kcfg)
        dx5, dphi5, dys5 = combine_bwd(*args5, kcfg)
        torch.cuda.synchronize()
        r4 = dispatch_bwd_ref(*args4, kcfg)
        r5 = combine_bwd_ref(*args5, kcfg)
        errs, oks = {}, []
        for name, got, want in (("K4 dx", dx4, r4[0]), ("K4 dphi", dphi4, r4[1]),
                                ("K5 dx", dx5, r5[0]), ("K5 dphi", dphi5, r5[1]),
                                ("K5 dys", dys5, r5[2])):
            abs_err, errs[name], ok = check(got, want, dt)
            errs[name + " abs"] = abs_err
            oks.append(ok)
        outs = (dx4, dphi4, dx5, dphi5, dys5)
        finite = all(bool(torch.isfinite(t).all()) for t in outs)
        # row independence: dx and dys of each row equal a batch-1 call
        # bitwise; dPhi_n equals the row-order sum of the batch-1 dPhi_n's
        bitwise, acc4, acc5 = True, None, None
        for r in range(b):
            sl = slice(r, r + 1)
            one4 = (c["x"][sl], c["phi_n"], c["g_slots"][sl],
                    tuple(t[sl] for t in c["d_stats"]), c["slots"][sl])
            one5 = (c["x"][sl], c["phi_n"], c["ys"][sl], c["g"][sl],
                    tuple(t[sl] for t in c["c_stats"]), c["y"][sl])
            rx4, rp4 = dispatch_bwd(*one4, kcfg)
            rx5, rp5, ry5 = combine_bwd(*one5, kcfg)
            bitwise &= (torch.equal(rx4[0], dx4[r]) and torch.equal(rx5[0], dx5[r])
                        and torch.equal(ry5[0], dys5[r]))
            acc4 = rp4 if acc4 is None else acc4 + rp4
            acc5 = rp5 if acc5 is None else acc5 + rp5
        row_sum = torch.equal(acc4, dphi4) and torch.equal(acc5, dphi5)
        again4 = dispatch_bwd(*args4, kcfg)
        again5 = combine_bwd(*args5, kcfg)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(again4 + again5, outs))
        ct = BWD_TILES * (kcfg or default_config(m, d, s)).block_tokens
        log(f"[softmoe-bwd] {label}: b={b} m={m} d={d} S={s} "
            f"{str(dt).replace('torch.', '')} chunks={-(-m // ct)} of "
            f"{ct} tokens "
            "max|diff|/max|ref|: "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items()
                       if not k.endswith("abs"))
            + f" (tol f32 1e-5 of max|ref|; bf16 one bf16 step + 1e-5 of "
            f"max|ref|: {all(oks)}); finite={finite} "
            f"batched==batch1_bitwise={bitwise} "
            f"dphi==row_order_sum_of_batch1={row_sum} "
            f"second_run_bitwise={same}")
        if not (all(oks) and finite and bitwise and row_sum and same):
            raise AssertionError(f"soft-moe backward kernels {label} failed")
        if i == 0:
            main = {"case": c,
                    "err": {"dispatch_bwd": max(errs["K4 dx abs"],
                                                errs["K4 dphi abs"]),
                            "combine_bwd": max(errs["K5 dx abs"],
                                               errs["K5 dphi abs"],
                                               errs["K5 dys abs"])}}

    # No fallback: malformed operands raise and launch nothing.
    c = main["case"]
    x, phi_n, g_slots, g = c["x"], c["phi_n"], c["g_slots"], c["g"]
    counts = lambda: (dispatch_bwd.launches, combine_bwd.launches)  # noqa: E731
    before = counts()
    for call, exc, why in (
            (lambda: dispatch_bwd(x.half(), phi_n, g_slots.half(),
                                  c["d_stats"], c["slots"]), TypeError,
             "float16 x"),
            (lambda: dispatch_bwd(x, phi_n, g_slots.float(), c["d_stats"],
                                  c["slots"]), TypeError,
             "g_slots dtype != x dtype"),
            (lambda: combine_bwd(x, phi_n, c["ys"],
                                 g.transpose(1, 2).contiguous()
                                 .transpose(1, 2), c["c_stats"], c["y"]),
             ValueError, "non-contiguous g"),
            (lambda: combine_bwd(x, phi_n, c["ys"], g,
                                 (c["c_stats"][0][:, :5], c["c_stats"][1]),
                                 c["y"]), ValueError,
             "stats of the wrong shape"),
            (lambda: dispatch_bwd(x, phi_n, g_slots, c["d_stats"], c["slots"],
                                  KernelConfig(block_slots=64)), ValueError,
             "block_slots=64 > 32"),
            (lambda: combine_bwd(x, phi_n, c["ys"], g.clone()
                                 .requires_grad_(), c["c_stats"], c["y"]),
             NotImplementedError, "g requires grad (a raw kernel has no "
             "backward)")):
        try:
            call()
        except exc as e:
            log(f"[softmoe-bwd] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if counts() != before:
        raise AssertionError("a malformed call launched a kernel")

    # Times at the B/16 layer's shapes (b=64, m=196, d=768, S=128, bf16),
    # then at the granite layer's (b=8, m=2048, d=1024, S=32, bf16), each
    # beside its bound, its plain version, the SDPA backward and the
    # einsum path's backward.
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {}
    for c, shape in ((c, "b=64 m=196 d=768 S=128 bf16"),
                     (granite, "b=8 m=2048 d=1024 S=32 bf16")):
        args4 = (c["x"], c["phi_n"], c["g_slots"], c["d_stats"], c["slots"])
        args5 = (c["x"], c["phi_n"], c["ys"], c["g"], c["c_stats"], c["y"])
        calls = {
            "dispatch_bwd": (lambda a=args4: dispatch_bwd(*a),
                             lambda a=args4: dispatch_bwd_ref(*a), "dispatch"),
            "combine_bwd": (lambda a=args5: combine_bwd(*a),
                            lambda a=args5: combine_bwd_ref(*a), "combine"),
        }
        library, einsum = softmoe_bwd_yardsticks(torch, c, flush, shape)
        for name, (kern, plain, kind) in calls.items():
            kernel_ms = time_ms(torch, kern, flush=flush)
            plain_ms = time_ms(torch, plain, reps=3, flush=flush)
            einsum_ms = time_ms(torch, einsum[kind], flush=flush)
            label, library_ms = min(library[kind][0].items(),
                                    key=lambda r: r[1])
            bound_ms, bound_by, nbytes, flops = soft_moe_bwd_bounds(
                c["x"], c["phi_n"].shape[1], kind)
            design_ms, design_by, d_bytes, d_ops = soft_moe_bwd_design_bound(
                c["x"], c["phi_n"].shape[1], kind)
            log(f"[softmoe-bwd] {name} timing ({shape}, L2 flushed): "
                f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} (scaled_dot_product_attention "
                f"backward, {label}) einsum_path_bwd_ms={einsum_ms:.4f} "
                f"bound={bound_ms * 1e3:.2f} us ({bound_by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the f32 "
                f"rate) -> {flops / kernel_ms / 1e9:.2f} TFLOP/s of the "
                f"least work; design bound={design_ms * 1e3:.2f} us "
                f"({design_by}: {d_bytes / 1e6:.1f} MB with the chunk "
                f"partials, {d_ops * 1e6:.2f} us of tensor-core passes)")
            launch_times(torch, kern, shape, name, "softmoe-bwd")
            row = {"ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "einsum_path_ms": einsum_ms}
            if c is granite:
                out[name]["granite"] = row
            else:
                out[name] = {"max_abs_err": main["err"][name], **row}
    return out


def softmoe_bwd_yardsticks(torch, c, flush, shape):
    """The yardsticks of K4 and K5 on the operands of case ``c``:
    ({kind: sdpa_bwd_options(...)}, {kind: the einsum path's backward}) for
    kind "dispatch" and "combine"; logs each backend's time and why the
    others refused.

    The library yardstick: the backward alone of the
    scaled_dot_product_attention call that computes each forward
    (dispatch: q = Phi_n^T, k = l2norm(x), v = x; combine: q = l2norm(x),
    k = Phi_n^T, v = Ys; scale 1; Phi_n in x's dtype), as
    torch.autograd.grad over a retained graph given the same output
    gradient; the forward runs outside the timed window. The einsum path
    is the port's unfused path of the same functions (use_kernel=False in
    core/soft_moe.py), its backward alone over a retained graph."""
    from repro_torch.core.soft_moe import soft_moe_weights

    x, phi_n, g_slots, g, ys = (c[k] for k in ("x", "phi_n", "g_slots", "g",
                                               "ys"))
    b, m, d = x.shape
    s = phi_n.shape[1]
    xf = x.float()
    xn = (xf / (xf.norm(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
    phi_t = phi_n.t().contiguous().to(x.dtype)[None, None]
    layouts = {"broadcast": lambda t: t.expand(b, 1, s, d),
               "copied": lambda t: t.expand(b, 1, s, d).contiguous()}
    library = {
        "dispatch": sdpa_bwd_options(
            torch, {k: (f(phi_t), xn[:, None], x[:, None])
                    for k, f in layouts.items()}, g_slots[:, None], flush),
        "combine": sdpa_bwd_options(
            torch, {k: (xn[:, None], f(phi_t), ys[:, None])
                    for k, f in layouts.items()}, g[:, None], flush),
    }
    for kind, (runs, refused) in library.items():
        log(f"[softmoe-bwd] sdpa backward for {kind} ({shape}): runs: "
            + "; ".join(f"{k} {ms:.4f} ms" for k, ms in runs.items())
            + "; refused: "
            + "; ".join(f"{k}: {why}" for k, why in refused.items()))

    def einsum_bwd(kind):
        xe = x.detach().requires_grad_()
        phie = phi_n.reshape(d, s, 1).detach().requires_grad_()
        one = torch.ones((), device="cuda")
        if kind == "dispatch":
            d_w, _ = soft_moe_weights(xe, phie, one)
            out = torch.einsum("bmd,bmnp->bnpd", xe.float(), d_w).to(x.dtype)
            grad, wrt = g_slots.reshape(b, s, 1, d), (xe, phie)
        else:
            yse = ys.detach().requires_grad_()
            _, c_w = soft_moe_weights(xe, phie, one)
            out = torch.einsum("bnpd,bmnp->bmd",
                               yse.float().reshape(b, s, 1, d),
                               c_w).to(x.dtype)
            grad, wrt = g, (xe, phie, yse)
        return lambda: torch.autograd.grad(out, wrt, grad, retain_graph=True)

    return library, {k: einsum_bwd(k) for k in ("dispatch", "combine")}


def sdpa_bwd_options(torch, operands, grad_out, flush):
    """Time the backward of one scaled_dot_product_attention call (scale
    1) on each operand layout in ``operands`` ({layout: (q, k, v)}) under
    each backend that takes it: the forward builds a graph from leaf
    copies of the operands, and the timed call is ``torch.autograd.grad``
    of its output given ``grad_out``, over the retained graph. Returns
    ({"BACKEND, layout": ms}, {"BACKEND, layout": why it refused})."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    runs, refused = {}, {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for layout, qkv in operands.items():
            key = f"{be.name}, {layout}"
            leaves = [t.detach().requires_grad_() for t in qkv]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    with sdpa_kernel([be]):
                        out = sdpa(*leaves, scale=1.0)

                    def bwd(out=out, leaves=leaves):
                        return torch.autograd.grad(out, leaves, grad_out,
                                                   retain_graph=True)

                    bwd()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    why = [str(w.message).split(" (Triggered internally")[0]
                           for w in caught]
                    why = [w for w in why if not w.endswith("because:")]
                    refused[key] = " | ".join(why or [str(e)])[:400]
                    continue
            runs[key] = time_ms(torch, bwd, flush=flush)
            del out
    return runs, refused


# ---------------------------------------------------------------------------
# phase 6: the routing-health kernel K6 against its plain version
# ---------------------------------------------------------------------------


def health_bounds(x, s):
    """Least time on the card for one K6 call: the bytes of x, Phi_n, the
    four stats in and the four outputs over HBM bandwidth vs the f32 flops
    of the logits (2 m S d a row) and the norms (2 m d) over the f32 rate;
    the O(m S) weights and their sums are not counted."""
    b, m, d = x.shape
    nbytes = (b * m * d * x.element_size() + d * s * 4
              + 2 * (2 * b * s * 4 + 2 * b * m * 4))
    flops = b * (2 * m * s * d + 2 * m * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def health_design_bound(x, s, x_reads=2):
    """Least time on the card for the work K6's tensor-core design runs
    (csrc/soft_moe_routing_health.cu): the logits, 2 m S d flops a row, as
    passes on the tensor cores at the dense TF32 peak (bf16 x: two passes,
    Phi_n split; f32 x: three), against the bytes of health_bounds plus
    what the design adds: x read ``x_reads`` times (twice: the norm
    pre-pass and the main kernel; once: a design that folds the norm into
    the main kernel), the norms written and read, and the chunks' two
    per-slot partials (b, n_chunks, S) f32 written and read."""
    from repro_torch.kernels.tuning import combine_chunk, default_config

    b, m, d = x.shape
    passes = 2 if x.element_size() == 2 else 3
    t_ops = passes * 2.0 * b * m * s * d / TF32_FLOPS
    nch = -(-m // combine_chunk(default_config(m, d, s).block_tokens))
    nbytes = (health_bounds(x, s)[2]
              + (x_reads - 1) * b * m * d * x.element_size()
              + 2 * b * m * 4 + 2 * 2 * b * nch * s * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, t_ops)


# the layers K6 is timed at: (label, seed, b, m, d, S), bf16 x
HEALTH_SHAPES = (("granite", 600, 8, 2048, 1024, 32),
                 ("B/16", 602, 64, 196, 768, 128))


def health_times(torch):
    """Time K6 at the granite and B/16 layers in bf16 (phase 6's first
    and third cases), beside its bound, its design's bound, its plain
    version and the einsum path of the same reductions (no single PyTorch
    call computes them), with the device time of each launch of a call.
    Returns {label: numbers}."""
    from repro_torch.core.soft_moe import (
        _dense_routing_health,
        soft_moe_weights,
    )
    from repro_torch.kernels.soft_moe_kernels import (
        routing_fwd,
        routing_health,
        routing_health_ref,
    )

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {}
    for label, seed, b, m, d, s in HEALTH_SHAPES:
        x, phi_n, _ = soft_moe_case(torch, seed, b, m, d, s, torch.bfloat16)
        with torch.no_grad():
            _, d_stats, c_stats = routing_fwd(x, phi_n)
        phi3, one = phi_n.reshape(d, s, 1), torch.ones((), device="cuda")

        def kern():
            return routing_health(x, phi_n, d_stats, c_stats)

        def einsum_path():
            return _dense_routing_health(*soft_moe_weights(x, phi3, one))

        kernel_ms = time_ms(torch, kern, flush=flush)
        plain_ms = time_ms(torch, lambda: routing_health_ref(
            x, phi_n, d_stats, c_stats), reps=3, flush=flush)
        einsum_ms = time_ms(torch, einsum_path, flush=flush)
        bound_ms, bound_by, nbytes, flops = health_bounds(x, s)
        design_ms, design_by, d_bytes, d_ops = health_design_bound(x, s)
        once_ms, once_by, once_bytes, _ = health_design_bound(x, s, 1)
        shape = f"b={b} m={m} d={d} S={s} bf16"
        log(f"[health] routing_health timing at the {label} layer ({shape}, "
            f"L2 flushed): kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms=null (no single library call) "
            f"einsum_path_ms={einsum_ms:.4f} (soft_moe_weights + "
            f"_dense_routing_health) bound={bound_ms * 1e3:.2f} us "
            f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
            f"-> {flops / kernel_ms / 1e9:.2f} TFLOP/s; design bound="
            f"{design_ms * 1e3:.2f} us ({design_by}: {d_bytes / 1e6:.1f} MB "
            f"with the second x read, the norms and the partials, "
            f"{d_ops * 1e6:.2f} us of tensor-core passes); with x read "
            f"once {once_ms * 1e3:.2f} us ({once_by}: "
            f"{once_bytes / 1e6:.1f} MB)")
        launch_times(torch, kern, shape, "routing_health", tag="health")
        out[label] = {"ms": kernel_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "einsum_path_ms": einsum_ms}
    return out


def phase_routing_health(torch):
    from repro_torch.core.inspection import routing_health_from_stats
    from repro_torch.kernels.soft_moe_kernels import (
        routing_fwd,
        routing_health,
        routing_health_ref,
    )
    from repro_torch.kernels.tuning import KernelConfig, combine_chunk

    # Elementwise |out - ref| <= atol + rtol |ref|, all f32: against the
    # plain version 1e-5 + 1e-4 |ref| (sums of up to 2048 terms taken in
    # other orders, logits dotted over d in another order); against the
    # chunked oracle, which normalizes x before the dot, 1e-4 + 1e-4 |ref|.
    # The sum identities (each token's combine weights sum to 1 over the
    # slots, each slot's dispatch weights to 1 over the tokens): per row
    # the importance sums to m and the token contributions to S, within
    # 1e-4 relative.
    tol, oracle_tol, ident_rtol = (1e-5, 1e-4), (1e-4, 1e-4), 1e-4
    names = ("disp_entropy", "importance", "comb_entropy", "token_contrib")
    cases = [
        # (label, b, m, d, S, dtype, cfg)
        ("granite layer bf16", 8, 2048, 1024, 32, torch.bfloat16, None),
        ("granite layer f32", 8, 2048, 1024, 32, torch.float32, None),
        ("B/16 layer bf16", 64, 196, 768, 128, torch.bfloat16, None),
        ("B/16 layer f32", 64, 196, 768, 128, torch.float32, None),
        # a ragged last token block (45 = 32 + 13) and slot block
        # (40 = 32 + 8), several slot blocks
        ("ragged m45 d264 S40 f32", 3, 45, 264, 40, torch.float32, None),
        ("ragged m45 d264 S40 bf16 bt16 bs8", 3, 45, 264, 40,
         torch.bfloat16, KernelConfig(block_tokens=16, block_slots=8)),
        # three of the kernel's 64-token chunks with a ragged last one (150
        # = 64 + 64 + 22) over two of its 128-slot tiles (160 = 128 + 32)
        ("chunks m150 d264 S160 f32", 3, 150, 264, 160, torch.float32, None),
        ("chunks m150 d264 S160 bf16", 3, 150, 264, 160, torch.bfloat16,
         None),
        # chunks of 32 tokens (70 = 32 + 32 + 6), slot tiles 128 + 8
        ("chunks m70 d64 S136 bf16 bt16 bs8", 2, 70, 64, 136, torch.bfloat16,
         KernelConfig(block_tokens=16, block_slots=8)),
    ]
    main = {}
    for i, (label, b, m, d, s, dt, kcfg) in enumerate(cases):
        x, phi_n, _ = soft_moe_case(torch, 600 + i, b, m, d, s, dt)
        with torch.no_grad():
            _, d_stats, c_stats = routing_fwd(x, phi_n, kcfg)
        got = routing_health(x, phi_n, d_stats, c_stats, kcfg)
        torch.cuda.synchronize()
        want = routing_health_ref(x, phi_n, d_stats, c_stats, kcfg)
        # the oracle normalizes x in its dtype: hand it the same values in
        # f32, as the kernel normalizes them
        oracle = routing_health_from_stats(x.float(), phi_n, d_stats,
                                           c_stats)
        errs, oks = {}, []
        for n, g, w, o in zip(names, got, want, oracle):
            errs[n], ok = within(torch, g, w, *tol)
            errs[n + " vs oracle"], ok2 = within(torch, g, o, *oracle_tol)
            oks += [ok, ok2]
        for n, g, total in (("sum importance", got[1], m),
                            ("sum token_contrib", got[3], s)):
            errs[n + " rel"] = ((g.double().sum(1) - total).abs().max()
                                .item() / total)
            oks.append(errs[n + " rel"] <= ident_rtol)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        bitwise = True
        for r in sorted({0, min(1, b - 1), b - 1}):
            one = routing_health(x[r:r + 1], phi_n,
                                 tuple(t[r:r + 1] for t in d_stats),
                                 tuple(t[r:r + 1] for t in c_stats), kcfg)
            bitwise &= all(torch.equal(a[0], g[r]) for a, g in zip(one, got))
        again = routing_health(x, phi_n, d_stats, c_stats, kcfg)
        torch.cuda.synchronize()
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        ct = combine_chunk((kcfg or KernelConfig()).block_tokens)
        log(f"[health] {label}: b={b} m={m} d={d} S={s} "
            f"{str(dt).replace('torch.', '')} chunks={-(-m // ct)} of {ct} "
            f"tokens, {-(-s // 128)} slot tile(s); max_abs_err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f" (tol plain {tol[0]:.0e} + {tol[1]:.0e}|ref|, oracle "
            f"{oracle_tol[0]:.0e} + {oracle_tol[1]:.0e}|ref|, identities "
            f"{ident_rtol:.0e} relative: {all(oks)}); "
            f"finite={finite} batched==batch1_bitwise={bitwise} "
            f"second_run_bitwise={same}")
        if not (all(oks) and finite and bitwise and same):
            raise AssertionError(f"routing_health {label} failed")
        if i == 0:
            main = {"args": (x, phi_n, d_stats, c_stats),
                    "err": max(errs[n] for n in names)}

    # No fallback: malformed operands raise and launch nothing.
    x, phi_n, d_stats, c_stats = main["args"]
    before = routing_health.launches
    for call, exc, why in (
            (lambda: routing_health(x.half(), phi_n, d_stats, c_stats),
             TypeError, "float16 x"),
            (lambda: routing_health(x, phi_n, (d_stats[0].double(),
                                               d_stats[1]), c_stats),
             TypeError, "float64 d_mx"),
            (lambda: routing_health(x.transpose(1, 2).contiguous()
                                    .transpose(1, 2), phi_n, d_stats,
                                    c_stats), ValueError, "non-contiguous x"),
            (lambda: routing_health(x, phi_n, d_stats,
                                    (c_stats[0][:, :5], c_stats[1])),
             ValueError, "stats of the wrong shape"),
            (lambda: routing_health(x, phi_n, d_stats, c_stats,
                                    KernelConfig(block_slots=64)),
             ValueError, "block_slots=64 > 32"),
            (lambda: routing_health(x.clone().requires_grad_(), phi_n,
                                    d_stats, c_stats),
             NotImplementedError, "x requires grad (telemetry has no "
             "backward)")):
        try:
            call()
        except exc as e:
            log(f"[health] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if routing_health.launches != before:
        raise AssertionError("a malformed call launched the kernel")

    # Times at the granite layer's shapes (the kernels line) and the B/16
    # layer's
    times = health_times(torch)
    gran = times["granite"]
    return {"routing_health": {
        "max_abs_err": main["err"], "ms": gran["ms"],
        "plain_ms": gran["plain_ms"], "bound_ms": gran["bound_ms"],
        "bound_by": gran["bound_by"], "library_ms": None,
        "einsum_path_ms": gran["einsum_path_ms"],
        "b16": {k: times["B/16"][k] for k in (
            "ms", "plain_ms", "bound_ms", "einsum_path_ms")}}}


# ---------------------------------------------------------------------------
# phase 6b: the fixed-order f32 contraction (batch-invariant serving)
# ---------------------------------------------------------------------------


# (arch, d_model, experts) of the two sparse routers that phases 12-13
# serve, and the row counts the kernel is held and timed at: decode
# batches, a prefill chunk, a long prompt (and training's 8 x 2048 rows)
INVARIANT_ROUTERS = (("granite-moe-1b-a400m", 1024, 32),
                     ("deepseek-v2-lite-16b", 2048, 64))
INVARIANT_ROWS = (1, 4, 8, 256, 2048)


def contract_bound(n, p, k, q, b_shared=False):
    """(ms, "bytes" | "operations") of an (n, p, k) x (n | 1, k, q) f32
    product: each input read once and the output written once at the
    HBM rate, against 2 n p k q operations at the f32 rate."""
    nbytes = 4 * (n * p * k + (1 if b_shared else n) * k * q + n * p * q)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * n * p * k * q / F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def mla_attend_operands(torch, gen, n, t, h=16, dk=576, dv=512):
    """MLA's two products over the latent view as ``layers.attention.
    _attend`` (one KV group) hands them to the kernel: the scores (n, h,
    dk) x keys (n, dk, t) (a transposed view of the (n, t, dk) latent +
    rope keys) and the weights (n, h, t) x values (n, t, dv) (the
    latent), for h rows a matrix (the heads of a decode step, or the
    heads x tokens of a prefill chunk); the inputs are bf16 values
    widened to f32, as served."""
    q = torch.randn(n, h, dk, generator=gen, device="cuda").bfloat16().float()
    k = torch.randn(n, t, dk, generator=gen, device="cuda").bfloat16().float()
    v = k[..., :dv].contiguous()
    w = torch.softmax(torch.randn(n, h, t, generator=gen, device="cuda"), -1)
    return (q, k.transpose(1, 2)), (w, v)


def invariance_case(torch, fn, ref, many, one, label):
    """``fn`` on the M-row (or n-matrix) operands ``many`` against its
    plain version ``ref`` and against f64, and its row 0 against the
    1-row launch ``one``, bitwise; cuBLAS's plain einsum's row 0 against
    its own 1-row call beside it. Returns (max abs err, max|ref|)."""
    out = fn(*many)
    torch.cuda.synchronize()
    want = ref(*many)
    exact = ref(*(t.double() for t in many))
    err = (out - want).abs().max().item()
    err64 = (out.double() - exact).abs().max().item()
    mag = want.abs().max().item()
    solo = fn(*one)
    bitwise = torch.equal(out[:1], solo)
    plain_moved = int((want[:1] != ref(*one)).sum())
    ok = err <= 1e-6 * mag and bitwise and bool(torch.isfinite(out).all())
    log(f"[invariant] {label}: max_abs_err vs plain {err:.3e} (vs f64 "
        f"{err64:.3e}; max|ref| {mag:.3e}; tol 1e-6 max|ref|) row 0 == "
        f"1-row launch bitwise: {bitwise}; the plain einsum's row 0 vs its "
        f"1-row call: {plain_moved} of {solo.numel()} elements differ")
    if not ok:
        raise AssertionError(f"invariant_matmul {label} failed")
    return err, mag


def plan_note(a, b):
    """The launch plan ``kernels.invariant_matmul._plan`` makes for
    ``batched_contract(a, b)``: tile, B's layout, copies, split."""
    from repro_torch.kernels import invariant_matmul as im

    a, b = im._unit_strided(a, b)
    n, p, k = a.shape
    pl = im._plan(n, p, k, b.shape[2], a.stride(), b.stride(),
                  a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)
    bm, bn = im.TILES[pl.tile]
    return (f"plan: tile {bm} x {bn}, B {'k' if pl.b_k_fast else 'q'}-fast, "
            f"{16 if pl.vec_a else 4}/{16 if pl.vec_b else 4}-byte copies, "
            f"{pl.n_chunks} chunk(s) over {pl.n_split} CTA(s), grid "
            f"{pl.grid}")


def every_row_cases(torch, gen):
    """Every row of an M-row launch (every matrix of an n-matrix launch)
    against its 1-row (1-matrix) launch, bitwise, at counts that cross
    the plan's tile boundaries (16-row tiles up to 256 rows, 64-row ones
    after, 128-row ones from 4096 rows of at least 128 columns) and its
    split boundary (a grid of 132 tiles): deepseek's router at 8385 rows,
    MLA prefill's products at 4096 rows (256 tokens x 16 heads) and MLA
    decode's values at 17 matrices of 2048 keys."""
    from repro_torch.kernels.invariant_matmul import (
        batched_contract,
        router_logits,
    )

    def check(fn, counts, label, note):
        """fn(lo, hi): the launch of rows [lo, hi)."""
        t0 = time.perf_counter()
        solo = torch.cat([fn(i, i + 1) for i in range(max(counts))])
        moved = {}
        for m in counts:
            out = fn(0, m)
            torch.cuda.synchronize()
            moved[m] = int((out != solo[:m]).sum())
        log(f"[invariant] every row bitwise: {label}, counts {counts}: "
            f"elements differing from the 1-row launches {moved} "
            f"({time.perf_counter() - t0:.2f} s; at the largest count "
            f"{note})")
        if any(moved.values()):
            raise AssertionError(f"invariant_matmul {label}: a row moved "
                                 f"with the launch's row count")

    w = torch.randn(2048, 64, generator=gen, device="cuda") / 2048 ** 0.5
    x = torch.randn(8385, 1, 2048, generator=gen, device="cuda")
    check(lambda lo, hi: router_logits(x[lo:hi], w),
          (1, 9, 256, 257, 2048, 8384, 8385),
          "router_logits deepseek (M, 1, 2048) x (2048, 64)",
          plan_note(x.reshape(1, -1, 2048), w[None]))
    (q, kt), (wt, v) = mla_attend_operands(torch, gen, 1, 2048, h=4096)
    for kind, a, b in (("scores", q, kt), ("values", wt, v)):
        check(lambda lo, hi: batched_contract(a[:, lo:hi], b)[0],
              (1, 16, 17, 128, 129, 256, 257, 4095, 4096),
              f"batched_contract MLA prefill {kind} (1, M, {a.shape[2]}) x "
              f"{tuple(b.shape)}", plan_note(a, b))
    (q, kt), (wt, v) = mla_attend_operands(torch, gen, 17, 2048)
    check(lambda lo, hi: batched_contract(wt[lo:hi], v[lo:hi]),
          (1, 8, 16, 17), "batched_contract MLA decode values (n, 16, "
          "2048) x (n, 2048, 512)", plan_note(wt, v))


def phase_invariant_kernels(torch):
    """The fixed-order f32 contraction (``kernels/invariant_matmul.py``,
    ``csrc/invariant_matmul.cu``) at the sparse routers' and MLA decode's
    shapes: against its plain version, row 0 of every launch bitwise the
    1-row launch, malformed operands refused, and its time beside cuBLAS
    and its bound."""
    from repro_torch.kernels.invariant_matmul import (
        batched_contract,
        batched_contract_ref,
        router_logits,
        router_logits_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {"router_logits": 0.0, "batched_contract": 0.0}
    for arch, d, e in INVARIANT_ROUTERS:
        w = torch.randn(d, e, generator=gen, device="cuda") / d ** 0.5
        x = torch.randn(max(INVARIANT_ROWS), 1, d, generator=gen,
                        device="cuda")
        for m in INVARIANT_ROWS:
            err, _ = invariance_case(
                torch, router_logits, router_logits_ref, (x[:m], w),
                (x[:1], w), f"router_logits {arch} (M={m}, 1, d={d}) x "
                f"({d}, {e})")
            errs["router_logits"] = max(errs["router_logits"], err)
    # MLA decode: the probe's 64 keys up to 2048 rows, the served 2048
    # keys at decode batches
    for t, ns in ((64, INVARIANT_ROWS), (2048, (1, 4, 8))):
        for n in ns:
            scores, values = mla_attend_operands(torch, gen, n, t)
            for kind, ops in (("scores", scores), ("values", values)):
                err, _ = invariance_case(
                    torch, batched_contract, batched_contract_ref, ops,
                    tuple(o[:1] for o in ops), f"batched_contract MLA "
                    f"{kind} {tuple(ops[0].shape)} x {tuple(ops[1].shape)}")
                errs["batched_contract"] = max(errs["batched_contract"], err)

    # Every row (matrix) bitwise its 1-row (1-matrix) launch, at counts on
    # both sides of the plan's tile and split boundaries
    every_row_cases(torch, gen)

    # No fallback: malformed operands raise and launch nothing.
    x, w = x[:4], torch.randn(1024, 32, generator=gen, device="cuda")
    (qa, kb), _ = mla_attend_operands(torch, gen, 2, 64)
    before = (router_logits.launches, batched_contract.launches)
    for call, exc, why in (
            (lambda: router_logits(x.bfloat16(), w.bfloat16()), TypeError,
             "bf16 router operands"),
            (lambda: router_logits(x[..., :1000], w), ValueError,
             "router d 1000 against a (1024, 32) weight"),
            (lambda: batched_contract(qa.double(), kb.double()), TypeError,
             "f64 operands"),
            (lambda: batched_contract(qa, kb[:, :500]), ValueError,
             "k 576 against 500"),
            (lambda: batched_contract(qa[0], kb[0]), ValueError, "2-D"),
            (lambda: batched_contract(qa.clone().requires_grad_(), kb),
             ValueError, "an operand that needs a gradient")):
        try:
            call()
        except exc as err:
            log(f"[invariant] malformed operands ({why}) raise "
                f"{type(err).__name__}: {err}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if (router_logits.launches, batched_contract.launches) != before:
        raise AssertionError("a malformed call launched the kernel")

    # Times (L2 flushed, median of 30) beside the plain einsum, one
    # cuBLAS call (torch.matmul / torch.bmm) and the bound
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = {}
    for arch, d, e in INVARIANT_ROUTERS:
        w = torch.randn(d, e, generator=gen, device="cuda") / d ** 0.5
        for m in (8, 256, 2048, 16384):
            x = torch.randn(m, 1, d, generator=gen, device="cuda")
            x2 = x.reshape(m, d)
            ms = time_ms(torch, lambda: router_logits(x, w), flush=flush)
            plain = time_ms(torch, lambda: router_logits_ref(x, w),
                            flush=flush)
            lib = time_ms(torch, lambda: torch.matmul(x2, w), flush=flush)
            bound, by = contract_bound(1, m, d, e, b_shared=True)
            rows[("router", arch, m)] = dict(ms=ms, plain_ms=plain,
                                             library_ms=lib, bound_ms=bound,
                                             bound_by=by)
            log(f"[invariant] router_logits {arch} timing (M={m}, "
                f"d={d}, e={e}, L2 flushed): kernel_ms={ms:.4f} "
                f"plain_ms(einsum)={plain:.4f} library_ms(torch.matmul)="
                f"{lib:.4f} bound={bound * 1e3:.3f} us ({by}); kernel/"
                f"bound {ms / bound:.1f}x, kernel/library {ms / lib:.2f}x; "
                f"{plan_note(x2[None], w[None])}")
    for t, n in ((2048, 8), (2048, 1), (64, 4)):
        for kind, ops in zip(("scores", "values"),
                             mla_attend_operands(torch, gen, n, t)):
            a, b = ops
            ms = time_ms(torch, lambda: batched_contract(a, b), flush=flush)
            plain = time_ms(torch, lambda: batched_contract_ref(a, b),
                            flush=flush)
            lib = time_ms(torch, lambda: torch.bmm(a, b), flush=flush)
            bound, by = contract_bound(n, a.shape[1], a.shape[2], b.shape[2])
            rows[("contract", kind, n, t)] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                bound_by=by)
            log(f"[invariant] batched_contract MLA decode {kind} timing "
                f"({tuple(a.shape)} x {tuple(b.shape)}, {t} keys, L2 "
                f"flushed): kernel_ms={ms:.4f} plain_ms(einsum)={plain:.4f} "
                f"library_ms(torch.bmm)={lib:.4f} bound={bound * 1e3:.3f} us "
                f"({by}); kernel/bound {ms / bound:.1f}x, kernel/library "
                f"{ms / lib:.2f}x; {plan_note(a, b)}")
    # MLA prefill, one request against the 2048-key gathered view: the
    # engine's 32-token chunk, a 256-token chunk, and a 2048-token
    # forward that needs no gradient (its 32768 rows stay on the dense
    # path below _CHUNKED_THRESHOLD): the kernel within 1e-6 of max|ref|
    # of the f64 product (over millions of outputs two f32 orders, the
    # kernel's and cuBLAS's, drift further apart than either from the
    # exact sums: both are logged), its row 0 bitwise the 1-row launch,
    # and its time
    for s_q in (32, 256, 2048):
        for kind, ops in zip(("scores", "values"), mla_attend_operands(
                torch, gen, 1, 2048, h=16 * s_q)):
            a, b = ops
            out = batched_contract(a, b)
            want = batched_contract_ref(a, b)
            exact = batched_contract_ref(a.double(), b.double())
            err = (out - want).abs().max().item()
            err64 = (out.double() - exact).abs().max().item()
            plain64 = (want.double() - exact).abs().max().item()
            mag = exact.abs().max().item()
            bitwise = torch.equal(out[:, :1], batched_contract(a[:, :1], b))
            del out, want, exact
            ms = time_ms(torch, lambda: batched_contract(a, b), flush=flush)
            plain = time_ms(torch, lambda: batched_contract_ref(a, b),
                            flush=flush)
            lib = time_ms(torch, lambda: torch.bmm(a, b), flush=flush)
            bound, by = contract_bound(1, a.shape[1], a.shape[2], b.shape[2])
            log(f"[invariant] batched_contract MLA prefill {kind} "
                f"({s_q} tokens x 16 heads: {tuple(a.shape)} x "
                f"{tuple(b.shape)}, L2 flushed): max_abs_err vs f64 "
                f"{err64:.3e} (the plain einsum's {plain64:.3e}; kernel vs "
                f"plain {err:.3e}; max|ref| {mag:.3e}; tol 1e-6 max|ref| "
                f"vs f64), row 0 == 1-row launch bitwise: {bitwise}; "
                f"kernel_ms={ms:.4f} plain_ms(einsum)={plain:.4f} "
                f"library_ms(torch.bmm)={lib:.4f} bound={bound * 1e3:.3f} "
                f"us ({by}); kernel/bound {ms / bound:.1f}x, kernel/library "
                f"{ms / lib:.2f}x, "
                f"{2 * a.shape[1] * a.shape[2] * b.shape[2] / ms / 1e9:.2f} "
                f"TFLOP/s (cuBLAS "
                f"{2 * a.shape[1] * a.shape[2] * b.shape[2] / lib / 1e9:.2f});"
                f" {plan_note(a, b)}")
            if not (err64 <= 1e-6 * mag and bitwise):
                raise AssertionError(f"batched_contract MLA prefill {kind} "
                                     f"{tuple(a.shape)} failed")
            errs["batched_contract"] = max(errs["batched_contract"], err)
            del a, b, ops
    # MLA's w_uv expansion at a decode step of 8 rows: one matrix a head
    # over the rows, read through the views _latent_up hands the kernel
    lat = torch.randn(8, 16, 512, generator=gen, device="cuda")
    w_uv = torch.randn(512, 16, 128, generator=gen, device="cuda")
    a, b = lat.transpose(0, 1), w_uv.permute(1, 0, 2)
    ms = time_ms(torch, lambda: batched_contract(a, b), flush=flush)
    plain = time_ms(torch, lambda: batched_contract_ref(a, b), flush=flush)
    lib = time_ms(torch, lambda: torch.bmm(a, b), flush=flush)
    bound, by = contract_bound(16, 8, 512, 128)
    log(f"[invariant] batched_contract MLA decode w_uv timing ((16, 8, 512) "
        f"x (16, 512, 128) strided views, L2 flushed): kernel_ms={ms:.4f} "
        f"plain_ms(einsum)={plain:.4f} library_ms(torch.bmm)={lib:.4f} "
        f"bound={bound * 1e3:.3f} us ({by}); kernel/bound "
        f"{ms / bound:.1f}x, kernel/library {ms / lib:.2f}x; "
        f"{plan_note(a, b)}")
    # what a call costs a host-bound decode step: 200 calls back to back
    # at granite's decode router (8 rows), synchronised once, so each
    # reads the larger of its host cost and its device time
    x8 = torch.randn(8, 1, 1024, generator=gen, device="cuda")
    w8 = torch.randn(1024, 32, generator=gen, device="cuda")

    def per_call_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    cost = {name: per_call_us(fn) for name, fn in (
        ("router_logits", lambda: router_logits(x8, w8)),
        ("einsum", lambda: router_logits_ref(x8, w8)),
        ("torch.matmul", lambda: torch.matmul(x8, w8)))}
    log("[invariant] back-to-back cost a call at granite's decode router "
        "((8, 1, 1024) x (1024, 32), 200 calls, host clock): " + ", ".join(
            f"{k} {v:.1f} us" for k, v in cost.items()))
    # the kernels line: phase 12's decode (granite, 8 rows) and phase
    # 13's (the scores over deepseek's 2048-key latent view, 8 rows)
    return {
        "router_logits": {"max_abs_err": errs["router_logits"],
                          **rows[("router", "granite-moe-1b-a400m", 8)]},
        "batched_contract": {"max_abs_err": errs["batched_contract"],
                             **rows[("contract", "scores", 8, 2048)]},
    }


# ---------------------------------------------------------------------------
# phase 7: serve full-width qwen2-0.5b
# ---------------------------------------------------------------------------


# The serving phases before phase 24 are host bound: the host launches
# every layer's kernels each tick while the card idles 87-94% of it (their
# profiled windows), so their wall time follows the depth, and the 1200 s
# limit is shared by every phase. They serve at full width with the depth
# cut to these layer counts; phase 24 serves qwen2-0.5b at full depth.
SERVE_DEPTH = {
    "qwen2-0.5b": 8,
    "granite-moe-1b-a400m": 8,
    "granite-moe-1b-a400m+soft": 8,
    "deepseek-v2-lite-16b": 9,
    "pixtral-12b": 10,
    "mamba2-370m": 12,
    "hymba-1.5b": 16,  # one period: 15 local layers, one global
}


def serving_config(name):
    """``get_config(name)`` at full width with its depth cut to
    ``SERVE_DEPTH[name]``: the first layers of the published stack, with a
    numbered MoE layer list kept below the cut ("all" keeps its meaning)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(name)
    n = SERVE_DEPTH[name]
    moe = full.moe_layers
    if moe and moe not in ("all", "second_half"):
        moe = ",".join(str(i) for i in full.moe_layer_indices() if i < n)
    return dataclasses.replace(full, num_layers=n, moe_layers=moe)


def depth_note(cfg):
    """``"8 of 24 layers"``: the served depth beside the published one."""
    from repro_torch.configs import get_config

    return f"{cfg.num_layers} of {get_config(cfg.name).num_layers} layers"


def make_requests(np, vocab, seed=0):
    """16 prompts of 16..1024 tokens; requests 0 and 12 share a 256-token
    prefix (12 is admitted long after 0 has published it)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(16, 1025, size=16)
    lens[0], lens[12] = max(lens[0], 300), max(lens[12], 300)
    prefix = rng.randint(1, vocab, size=256).tolist()
    prompts = []
    for i, n in enumerate(lens):
        tail = rng.randint(1, vocab, size=int(n)).tolist()
        prompts.append(prefix + tail[: n - 256] if i in (0, 12) else tail)
    return prompts


def timed_method(torch, obj, name):
    """Wrap ``obj.<name>`` so each call's synchronised host time lands in
    the returned list."""
    times = []
    inner = getattr(obj, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, call)
    return times


def run_engine(torch, eng, prompts, max_new):
    """Drive ``eng`` over ``prompts``; returns the requests, the wall
    seconds and the decode-step times."""
    from repro_torch.serve import Request

    decode_s = timed_method(torch, eng.backend, "decode")
    reqs = [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, decode_s


def teacher_forced(torch, eng, oracle, prompts, max_new):
    """Run ``eng`` (kernel) and ``oracle`` (gather) tick by tick over the
    same requests. Before each sampling pass the oracle's logits of every
    decoding row are held against the engine's, then replaced by them, so
    both engines sample the same tokens and keep the same schedule: every
    live row is compared at every tick, late in each request too. The
    oracle may live on another device (the host CPU).

    Returns per-tick (slots, max abs diff, greedy tokens that agree, max
    abs logit of the gather engine's rows)."""
    from repro_torch.serve import Request

    snap = {}
    ticks = []
    eng_decode, oracle_decode = eng._do_decode, oracle._do_decode

    def eng_sample():
        snap["slots"] = sorted(e.slot for e in eng.sched.decode_entries())
        snap["logits"] = eng._logits.clone()
        return eng_decode()

    def oracle_sample():
        slots = sorted(e.slot for e in oracle.sched.decode_entries())
        if slots != snap["slots"]:
            raise AssertionError(f"schedules diverged: kernel engine decodes "
                                 f"{snap['slots']}, gather engine {slots}")
        if slots:
            mine = snap["logits"][slots]
            ref = oracle._logits[slots].to(mine.device)
            agree = int((mine.argmax(-1) == ref.argmax(-1)).sum())
            ticks.append((slots, (mine - ref).abs().max().item(), agree,
                          ref.abs().max().item()))
        oracle._logits = snap["logits"].to(oracle._logits.device)
        return oracle_decode()

    eng._do_decode, oracle._do_decode = eng_sample, oracle_sample
    for e in (eng, oracle):
        for p in prompts:
            e.submit(Request(prompt=list(p), max_new_tokens=max_new))
    while eng.sched.pending() or oracle.sched.pending():
        snap.clear()
        eng.step()
        oracle.step()
    return ticks


def profile_ticks(torch, eng, n):
    """Trace ``n`` engine ticks with torch.profiler; returns the window's
    wall seconds and (kernel name, device us, launches) rows, largest
    first. Kernels run on one stream, so their summed time over the wall
    time is the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, cnt = per.get(ev.name, (0.0, 0))
            per[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((k, us, c) for k, (us, c) in per.items()),
                  key=lambda r: -r[1])
    return wall, rows


def tick_profile(torch, eng, n, label):
    """Trace ``n`` ticks of ``eng`` and log the window's wall time, the
    device's busy share, the device time by kernel group and the top
    kernels; returns the busy share."""
    pwall, prows = profile_ticks(torch, eng, n)
    busy = sum(us for _, us, _ in prows) / 1e6
    log(f"[profile] {label} in {pwall * 1e3:.1f} ms wall under the "
        f"profiler; device busy {busy * 1e3:.1f} ms = {busy / pwall:.3f} of "
        f"wall")
    kinds = {}
    for name, us, cnt in prows:
        k = kernel_kind(name)
        kinds[k] = (kinds.get(k, (0.0, 0))[0] + us,
                    kinds.get(k, (0.0, 0))[1] + cnt)
    for k, (us, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        log(f"[profile]   {k}: {us / 1e3:.2f} ms in {cnt} launches "
            f"({us / 1e6 / pwall:.3f} of wall)")
    for name, us, cnt in prows[:8]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{cnt} {name[:90]}")
    return busy / pwall


def kernel_kind(name):
    """The profile's kernel groups: the port's kernels, cuBLAS matmuls
    (``nvjet`` is cuBLAS's own kernel family), copies and dtype casts,
    and everything else."""
    low = name.lower()
    if "health_kernel" in name or "health_merge_kernel" in name:
        return "K6 routing health"
    if "paged_decode_kernel" in name or "paged_merge_kernel" in name:
        return "K7 paged decode attention"
    if "dispatch_bwd" in name:
        return "K4 dispatch backward"
    if "combine_bwd" in name:
        return "K5 combine backward"
    if any(k in name for k in ("prepass_kernel", "dphi_reduce_kernel",
                               "chunk_sum_kernel")):
        return "K4/K5 pre-pass and partial sums"
    if "routing_kernel" in name or "routing_merge_kernel" in name:
        return "K1 routing"
    if "combine_online_kernel" in name:
        return "K3 online combine"
    if "combine_apply_kernel" in name:
        return "K2 combine"
    if "inv_norm_kernel" in name:
        return "K1/K2/K3/K6 norm pre-pass"
    if "contract_kernel" in name:
        return "invariant contraction"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "matmul"
    if "copy_kernel" in low:
        return "copies and dtype casts"
    return "other"


def profile_step(torch, step, state, b, label):
    """One train step under the profiler; logs its wall time, the
    device's busy share and the device time by kernel group and by
    kernel, and returns (state, wall s, device busy s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, b)
        float(m["total_loss"])
        pwall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, cnt = per.get(ev.name, (0.0, 0))
            per[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((k, us, c) for k, (us, c) in per.items()),
                  key=lambda r: -r[1])
    busy = sum(us for _, us, _ in rows) / 1e6
    log(f"[profile] {label}: one step in {pwall * 1e3:.1f} ms wall under "
        f"the profiler; device busy {busy * 1e3:.1f} ms = "
        f"{busy / pwall:.3f} of wall")
    kinds = {}
    for name, us, cnt in rows:
        k = kernel_kind(name)
        kinds[k] = (kinds.get(k, (0.0, 0))[0] + us,
                    kinds.get(k, (0.0, 0))[1] + cnt)
    for k, (us, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        log(f"[profile]   {k}: {us / 1e3:.2f} ms in {cnt} launches "
            f"({us / 1e6 / busy:.3f} of device time)")
    for name, us, cnt in rows[:12]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{cnt} {name[:90]}")
    return state, pwall, busy


def phase_serve(torch, card):
    import numpy as np

    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.models import lm_init
    from repro_torch.optim import tree_leaves
    from repro_torch.serve import Request, ServeEngine

    cfg = serving_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] {cfg.name}: {depth_note(cfg)} d={cfg.d_model} "
        f"ff={cfg.d_ff} heads {cfg.attention.num_heads}/"
        f"{cfg.attention.num_kv_heads} vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f} M params (init "
        f"{time.perf_counter() - t0:.1f} s)")
    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend="paged")
    prompts = make_requests(np, cfg.vocab_size)
    max_new = 32

    # warm-up on a throwaway engine: allocator, cuBLAS handles
    warm = ServeEngine(cfg, params, **geo)
    run_engine(torch, warm, prompts[1:3], 4)
    del warm

    eng = ServeEngine(cfg, params, **geo)
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attend.launches = 0
    reqs, wall, decode_s = run_engine(torch, eng, prompts, max_new)
    launches = paged_decode_attend.launches
    done = all(r.done and r.finish_reason == "length" for r in reqs)
    hits = eng.backend.prefix.hits
    log(f"[serve] kernel engine: {len(reqs)} requests done={done}, "
        f"{eng.decode_steps} decode steps, {eng.ticks} ticks, "
        f"{eng.preemptions} preemptions, radix block hits={hits}, "
        f"kernel launches={launches} (decode_steps x {cfg.num_layers} = "
        f"{eng.decode_steps * cfg.num_layers})")
    if not done:
        raise AssertionError("not every request finished with 'length'")
    if hits < 1:
        raise AssertionError("the radix prefix cache recorded no block hit")
    if launches != eng.decode_steps * cfg.num_layers or launches == 0:
        raise AssertionError("kernel launches != decode_steps x layers")
    for r in reqs:
        out = np.asarray(r.out)
        if len(out) != max_new or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError("a request produced out-of-range tokens")
    n_tok = sum(len(r.out) for r in reqs)
    ttft = statistics.median(r.t_first_token - r.t_submit for r in reqs)
    step_ms = statistics.median(decode_s) * 1e3
    peak_alloc = torch.cuda.max_memory_allocated()
    log(f"[serve] {card}: {n_tok / wall:.1f} tok/s ({n_tok} tokens in "
        f"{wall:.2f} s), p50 TTFT {ttft * 1e3:.1f} ms, decode step "
        f"p50 {step_ms:.2f} ms (mean {1e3 * sum(decode_s) / len(decode_s):.2f}"
        f" ms), peak cache bytes {eng.peak_cache_bytes()} "
        f"(pool {eng.backend.bytes_per_block() * eng.backend.num_blocks}), "
        f"peak device memory {peak_alloc / 2**30:.2f} GiB")

    # Where the time goes: trace 10 ticks in the middle of the same trace
    # (prefill chunk + decode step each) on a fresh kernel engine.
    prof_eng = ServeEngine(cfg, params, **geo)
    for p in prompts:
        prof_eng.submit(Request(prompt=list(p), max_new_tokens=max_new))
    for _ in range(60):
        prof_eng.step()
    tick_profile(torch, prof_eng, 10, f"{card}: 10 ticks (ticks 61-70 of "
                 f"the trace)")
    del prof_eng

    # Kernel engine against the gather engine (use_kernel=False), teacher
    # forced: the serving trace above, then a burst of 8 short prompts
    # that keeps all 8 slots decoding at once. Prompts prefill in chunks
    # of 256 here: the comparison is about the decode logits.
    rng = np.random.RandomState(1)
    burst = [rng.randint(1, cfg.vocab_size, size=n).tolist()
             for n in range(16, 48, 4)]
    ticks = []
    odecode_s = []
    tf_geo = dict(geo, prefill_chunk=256)
    for trace, n_new in ((prompts, max_new), (burst, 48)):
        oracle = ServeEngine(cfg, params, use_kernel=False, **tf_geo)
        times = timed_method(torch, oracle.backend, "decode")
        ticks += teacher_forced(torch, ServeEngine(cfg, params, **tf_geo),
                                oracle, trace, n_new)
        odecode_s += times
        del oracle
    diffs = [t[1] for t in ticks]
    rows = sum(len(t[0]) for t in ticks)
    agree = sum(t[2] for t in ticks)
    full = sum(len(t[0]) == geo["batch_size"] for t in ticks)
    slots_seen = sorted({x for t in ticks for x in t[0]})
    worst = max(range(len(ticks)), key=lambda i: diffs[i])
    rel = max(d / r for _, d, _, r in ticks)
    log(f"[serve] gather engine (use_kernel=False): decode step p50 "
        f"{statistics.median(odecode_s) * 1e3:.2f} ms")
    log(f"[serve] kernel vs gather engine, teacher forced: {len(ticks)} "
        f"sampling passes, {rows} row logits compared (slots {slots_seen}; "
        f"{full} passes with all {geo['batch_size']} slots decoding); "
        f"first passes max_abs_diff "
        f"{', '.join(f'{d:.3e}' for d in diffs[:3])}; "
        f"all passes max_abs_diff={diffs[worst]:.3e} at pass {worst} "
        f"(rows {ticks[worst][0]}), median of the passes' max "
        f"{statistics.median(diffs):.3e} (tol 5e-2); max|diff| / max|ref| "
        f"of a pass at most {rel:.3e}; identical greedy "
        f"tokens {agree}/{rows} = {agree / rows:.4f}")
    if not all(math.isfinite(d) for d in diffs) or max(diffs) > 5e-2:
        raise AssertionError("kernel engine logits disagree with the gather "
                             "engine")
    if full == 0 or len(slots_seen) != geo["batch_size"]:
        raise AssertionError("the comparison never had every slot decoding")
    return {"paged_decode_attend": launches}


# ---------------------------------------------------------------------------
# phase 8: Soft-MoE ViT-B/16 inference at full width and depth
# ---------------------------------------------------------------------------


def rel_err(torch, got, want):
    """max |got - want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_vit(torch, card):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import soft_moe_apply
    from repro_torch.kernels import ops
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_online,
        routing_fwd,
    )
    from repro_torch.kernels.tuning import config_from_moe
    from repro_torch.layers.mlp import experts_apply
    from repro_torch.models import lm, vit_apply, vit_features, vit_init
    from repro_torch.optim import tree_leaves

    cfg = get_config("soft-moe-b/16-128e")
    n_moe = len(cfg.moe_layer_indices())
    t0 = time.perf_counter()
    params = vit_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[vit] {cfg.name}: {cfg.num_layers} layers ({n_moe} Soft-MoE, "
        f"{cfg.moe.num_experts} experts x {cfg.moe.slots_per_expert} slot) "
        f"d={cfg.d_model} ff={cfg.d_ff} heads {cfg.attention.num_heads}, "
        f"{n_params / 1e9:.3f} B params in f32 (init "
        f"{time.perf_counter() - t0:.1f} s), compute {cfg.dtype}")
    batch, tokens, patch_dim = 64, cfg.frontend.num_embeds, \
        cfg.frontend.embed_dim
    # N(0, 1) patches, as data/pipeline.py::SyntheticImages draws them
    patches = torch.randn(batch, tokens, patch_dim, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
    counts = lambda: (routing_fwd.launches, combine_apply.launches,  # noqa: E731
                      combine_online.launches)
    with torch.inference_mode():
        for k in (True, False):  # warm-up: allocator, cuBLAS, kernels built
            vit_features(params, cfg, patches, use_kernel=k)
        torch.cuda.synchronize()

        # the main path: counts from 0, then n forwards on the kernel path
        n_fwd = 10
        routing_fwd.launches = combine_apply.launches = 0
        combine_online.launches = 0
        times = {True: [], False: []}
        peak = {}
        for k in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(n_fwd):
                t0 = time.perf_counter()
                logits, aux = vit_apply(params, cfg, patches, use_kernel=k)
                torch.cuda.synchronize()
                times[k].append(time.perf_counter() - t0)
            peak[k] = torch.cuda.max_memory_allocated()
            if k:
                launches = counts()
        log(f"[vit] launches over {n_fwd} kernel-path forwards: K1 "
            f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]} (expected "
            f"{n_moe * n_fwd}, {n_moe * n_fwd}, 0); the einsum-path "
            f"forwards added {counts()[0] - launches[0]} K1 launches")
        if launches != (n_moe * n_fwd, n_moe * n_fwd, 0) or \
                counts() != launches:
            raise AssertionError("ViT kernel launches do not match 6 x "
                                 "forwards for K1 and K2, 0 for K3")
        if logits.shape != (batch, 1000) or not bool(
                torch.isfinite(logits).all()) or float(aux) != 0.0:
            raise AssertionError("ViT logits are not finite (64, 1000)")
        p50 = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        log(f"[vit] {card}: batch {batch} x {tokens} patches: kernel path "
            f"forward p50 {p50[True]:.2f} ms = {batch / p50[True] * 1e3:.1f}"
            f" images/s; einsum path p50 {p50[False]:.2f} ms = "
            f"{batch / p50[False] * 1e3:.1f} images/s; peak device memory "
            f"kernel path {peak[True] / 2**30:.3f} GiB, einsum path "
            f"{peak[False] / 2**30:.3f} GiB (params "
            f"{n_params * 4 / 2**30:.2f} GiB)")

        # kernel path vs einsum path: pre-head features (bf16 and f32);
        # the kernel-path forward also hands over every MoE layer's input
        # (block_apply's call of moe_apply), so the layer check below runs
        # on what the model feeds the first MoE layer
        seen = []
        inner = lm.moe_apply

        def capture(p, moe_cfg, xn, *a, **kw):
            seen.append((p, moe_cfg, xn))
            return inner(p, moe_cfg, xn, *a, **kw)

        lm.moe_apply = capture
        try:
            f1 = vit_features(params, cfg, patches, use_kernel=True)
        finally:
            lm.moe_apply = inner
        if len(seen) != n_moe:
            raise AssertionError(f"{len(seen)} MoE calls in a forward, "
                                 f"expected {n_moe}")
        f0 = vit_features(params, cfg, patches, use_kernel=False)
        bf16_err = rel_err(torch, f1, f0)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        f1_32 = vit_features(params, cfg32, patches, use_kernel=True)
        f0_32 = vit_features(params, cfg32, patches, use_kernel=False)
        f32_err = rel_err(torch, f1_32, f0_32)

        # one MoE layer (the first) on the input the forward gave it
        first = cfg.moe_layer_indices()[0]
        moe_params, moe_cfg, xn = seen[0]
        seen.clear()
        y1, m1 = soft_moe_apply(moe_params, moe_cfg, xn, cfg.act,
                                use_kernel=True)
        y0, m0 = soft_moe_apply(moe_params, moe_cfg, xn, cfg.act,
                                use_kernel=False)
        layer_err = rel_err(torch, y1, y0)
        xn32 = xn.float()
        y1_32, _ = soft_moe_apply(moe_params, moe_cfg, xn32, cfg.act,
                                  use_kernel=True)
        y0_32, _ = soft_moe_apply(moe_params, moe_cfg, xn32, cfg.act,
                                  use_kernel=False)
        layer_err32 = rel_err(torch, y1_32, y0_32)

        # K3's path: the ops-level combine without saved stats, on the
        # same layer; counts from 0
        routing_fwd.launches = combine_apply.launches = 0
        combine_online.launches = 0
        kcfg = config_from_moe(moe_cfg, xn.shape[1], xn.shape[2])
        phi_n = ops.normalized_phi(moe_params["phi"], moe_params["scale"])
        slots, _ = ops.soft_moe_routing(xn, phi_n, kcfg)
        n, d = moe_cfg.num_experts, cfg.d_model
        ys = experts_apply(moe_params["experts"],
                           slots.transpose(0, 1).contiguous(), cfg.act)
        y3 = ops.soft_moe_combine(xn, phi_n, ys.transpose(0, 1).contiguous(),
                                  c_stats=None, config=kcfg)
        k3_launches = counts()
        torch.cuda.synchronize()
        k3_err, k3_ok = within(torch, y3, y1, 1e-5, 2.0**-7)
    log(f"[vit] kernel vs einsum path, max|diff|/max|ref|: features bf16 "
        f"{bf16_err:.3e} (tol 5e-2), features f32 {f32_err:.3e} (tol "
        f"1e-4); first MoE layer (layer {first}) bf16 {layer_err:.3e} (tol "
        f"2e-2), f32 {layer_err32:.3e} (tol 1e-4); max_combine kernel "
        f"{float(m1['max_combine']):.6f} einsum "
        f"{float(m0['max_combine']):.6f}")
    log(f"[vit] K3 path (ops.soft_moe_combine without stats) on layer "
        f"{first}: launches K1 {k3_launches[0]} K2 {k3_launches[1]} K3 "
        f"{k3_launches[2]}; vs the layer's K2 path max_abs_err "
        f"{k3_err:.3e} (one bf16 step: {k3_ok})")
    if not (bf16_err <= 5e-2 and f32_err <= 1e-4 and layer_err <= 2e-2
            and layer_err32 <= 1e-4):
        raise AssertionError("the ViT kernel path disagrees with the einsum "
                             "path")
    if k3_launches != (1, 0, 1) or not k3_ok:
        raise AssertionError("the K3 combine path failed")

    # Where the time goes: 3 kernel-path forwards under the profiler
    with torch.inference_mode():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                vit_apply(params, cfg, patches, use_kernel=True)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, cnt = per.get(ev.name, (0.0, 0))
            per[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((k, us, c) for k, (us, c) in per.items()),
                  key=lambda r: -r[1])
    busy = sum(us for _, us, _ in rows) / 1e6
    log(f"[profile] vit {card}: 3 kernel-path forwards in "
        f"{pwall * 1e3:.1f} ms wall under the profiler; device busy "
        f"{busy * 1e3:.1f} ms = {busy / pwall:.3f} of wall")
    kinds = {}
    for name, us, cnt in rows:
        k = kernel_kind(name)
        kinds[k] = (kinds.get(k, (0.0, 0))[0] + us,
                    kinds.get(k, (0.0, 0))[1] + cnt)
    for k, (us, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        log(f"[profile]   {k}: {us / 1e3:.2f} ms in {cnt} launches "
            f"({us / 1e6 / busy:.3f} of device time)")
    for name, us, cnt in rows[:10]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{cnt} {name[:90]}")
    return {"routing_fwd": launches[0], "combine_apply": launches[1],
            "combine_online": k3_launches[2]}


# ---------------------------------------------------------------------------
# phase 8b: the sparse B/16 ViTs beside the Soft-MoE one (forwards)
# ---------------------------------------------------------------------------


def phase_sparse_vit(torch, card):
    """Tokens Choice and Experts Choice B/16 (128 experts, the paper's
    sparse baselines) as batch-64 forwards beside soft-moe-b/16-128e on
    its kernel and einsum paths: images/s, forward p50, peak memory."""
    from repro_torch.configs import soft_moe_vit
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_online,
        routing_fwd,
    )
    from repro_torch.models import vit_apply, vit_init

    kernels = (routing_fwd, combine_apply, combine_online)
    batch, n_fwd = 64, 10
    res = {}
    for variant in ("soft", "tokens_choice", "experts_choice"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = soft_moe_vit("b", 16, 128, variant=variant)
        params = vit_init(torch.Generator(device="cuda").manual_seed(0), cfg)
        patches = torch.randn(batch, cfg.frontend.num_embeds,
                              cfg.frontend.embed_dim, device="cuda",
                              generator=torch.Generator(device="cuda")
                              .manual_seed(1))
        for use_kernel in ((True, False) if variant == "soft" else (False,)):
            with torch.inference_mode():
                vit_apply(params, cfg, patches, use_kernel=use_kernel)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for k in kernels:
                    k.launches = 0
                times = []
                for _ in range(n_fwd):
                    t0 = time.perf_counter()
                    logits, aux = vit_apply(params, cfg, patches,
                                            use_kernel=use_kernel)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            launches = tuple(k.launches for k in kernels)
            if logits.shape != (batch, 1000) or not bool(
                    torch.isfinite(logits).all()) or not math.isfinite(
                    float(aux)):
                raise AssertionError(f"{cfg.name}: non-finite forward")
            n_moe = len(cfg.moe_layer_indices())
            want = ((n_moe * n_fwd, n_moe * n_fwd, 0) if use_kernel
                    else (0, 0, 0))
            if launches != want:
                raise AssertionError(f"{cfg.name}: K1/K2/K3 launches "
                                     f"{launches}, expected {want}")
            path = f"{variant}{' kernel' if use_kernel else ''}"
            res[path] = (statistics.median(times) * 1e3,
                         torch.cuda.max_memory_allocated(), float(aux))
        del params, patches, logits
    log(f"[vit-sparse] {card}: B/16, 128 experts, batch {batch} x "
        f"{cfg.frontend.num_embeds} patches, {n_fwd} forwards each "
        f"(K1/K2/K3 launches checked: one a MoE layer a forward on the "
        f"Soft-MoE kernel path, 0 elsewhere): "
        + "; ".join(f"{p}: forward p50 {ms:.2f} ms = {batch / ms * 1e3:.1f} "
                    f"images/s, peak {peak / 2**30:.3f} GiB, aux {aux:.4g}"
                    for p, (ms, peak, aux) in res.items()))


# ---------------------------------------------------------------------------
# phase 9: Soft-MoE ViT-B/16 training steps at full width and depth
# ---------------------------------------------------------------------------


def phase_train(torch, card):
    import dataclasses
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import soft_moe_apply
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
    )
    from repro_torch.models import lm, vit_init, vit_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves, tree_map
    from repro_torch.train import init_train_state, make_train_step

    kernels = (routing_fwd, combine_apply, combine_online, dispatch_bwd,
               combine_bwd)

    def counts():
        return tuple(k.launches for k in kernels)

    def zero_counts():
        for k in kernels:
            k.launches = 0

    # earlier phases leave reference cycles (engines whose methods the
    # teacher-forced check patched) that hold device memory until collected
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("soft-moe-b/16-128e")
    n_moe = len(cfg.moe_layer_indices())
    batch = 64
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: vit_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    data = SyntheticImages(num_patches=cfg.frontend.num_embeds,
                           patch_dim=cfg.frontend.embed_dim,
                           batch_size=batch, num_classes=1000, device="cuda")
    # examples/train_vit_softmoe.py's optimizer, at its default 300 steps
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=20, schedule="rsqrt",
                           timescale=100.0, total_steps=300,
                           cooldown_steps=30)
    step_fn = make_train_step(
        lambda p, b: vit_loss(p, cfg, b, use_kernel=True), ocfg)
    log(f"[train] {cfg.name}: {cfg.num_layers} layers ({n_moe} Soft-MoE), "
        f"remat={cfg.remat}, {n_params / 1e9:.3f} B params; f32 params, "
        f"AdamW mu and nu (init {time.perf_counter() - t0:.1f} s), "
        f"compute {cfg.dtype}, batch {batch}")

    # step 0: the head starts at zero, so the loss is ln(1000)
    zero_counts()
    state, m0 = step_fn(state, data.batch(0))
    loss0 = float(m0["total_loss"])
    per_step = counts()
    want = (2 * n_moe, 2 * n_moe, 0, n_moe, n_moe)
    log(f"[train] step 0: loss {loss0:.6f} (ln 1000 = {math.log(1000):.6f}, "
        f"tol 1e-3); grad_norm {float(m0['grad_norm']):.4f} lr "
        f"{float(m0['lr']):.3e}; launches K1 {per_step[0]} K2 {per_step[1]} "
        f"K3 {per_step[2]} K4 {per_step[3]} K5 {per_step[4]} (expected "
        f"{want}: remat runs each MoE layer's forward twice)")
    if abs(loss0 - math.log(1000)) > 1e-3 or per_step != want:
        raise AssertionError("train step 0 failed")

    # step 1: kernel-path vs einsum-path gradients of the MoE layers' phi
    # and scale and of one expert leaf, with the head trained one step, in
    # the config's bf16 compute and in f32. Bound: 5e-2 of the leaf's
    # largest value in bf16 (PR 12's feature bound: the einsum path
    # normalizes x in bf16, the kernels in f32, so a logit moves by ~2^-9,
    # and each of the up to 12 blocks the gradient crosses adds bf16
    # roundings of up to 2^-8), 1e-4 in f32 (sums in other orders). A scale
    # gradient is one number, sum_{d,s} dPhi_n * Phi_n / scale over d S
    # terms of both signs: its error is bounded against the terms, so its
    # bound is the leaf bound times kappa = sum |terms| / |sum terms|,
    # measured from the kernel path's dPhi_n.
    from repro_torch.kernels import ops as kops

    first = cfg.moe_layer_indices()[0]
    b1 = data.batch(1)
    picks = [(f"layers[{i}].moe.{k}", ("layers", i, "moe", k))
             for i in cfg.moe_layer_indices() for k in ("phi", "scale")]
    picks.append((f"layers[{first}].moe.experts.w_up",
                  ("layers", first, "moe", "experts", "w_up")))

    def pick_grads(cfg_, use_kernel):
        wrt = tree_map(torch.Tensor.detach, state["params"])
        leaves = [_get(wrt, path) for _, path in picks]
        for t in leaves:
            t.requires_grad_()
        kappa, real = {}, kops.normalized_phi

        def spy(phi, scale):  # dPhi_n of each layer, kernel path
            out = real(phi, scale)
            if out.requires_grad:
                def hook(g, key=phi.data_ptr(), o=out.detach()):
                    t = (g.float() * o.float()).double()
                    kappa.setdefault(key, (t.abs().sum()
                                           / t.sum().abs()).item())
                out.register_hook(hook)
            return out

        kops.normalized_phi = spy
        try:
            loss, _ = vit_loss(wrt, cfg_, b1, use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            kops.normalized_phi = real
        return grads, kappa

    phi_key = {i: state["params"]["layers"][i]["moe"]["phi"].data_ptr()
               for i in cfg.moe_layer_indices()}
    grad_check = {}
    for label, cfg_, tol in (("bf16", cfg, 5e-2),
                             ("f32", dataclasses.replace(cfg,
                                                         dtype="float32"),
                              1e-4)):
        (gk, kappa), (ge, _) = pick_grads(cfg_, True), pick_grads(cfg_, False)
        rows = []
        for (name, path), a, b_ in zip(picks, gk, ge):
            err = rel_err(torch, a, b_)
            k = kappa[phi_key[path[1]]] if path[-1] == "scale" else 1.0
            rows.append((name, err, tol * k))
        del gk, ge
        grad_check[label] = rows
        log(f"[train] step 1, kernel vs einsum path gradients in {label}, "
            f"max|diff| / max|ref| (bound): "
            + " ".join(f"{n}={e:.3e} ({b_:.1e})" for n, e, b_ in rows))
    bad = [(lab, n) for lab, rows in grad_check.items()
           for n, e, b_ in rows if not e <= b_]

    # one MoE layer in f32, its input captured from the model's forward
    seen = []
    inner = lm.moe_apply

    def capture(p, moe_cfg, xn, *a, **kw):
        seen.append((p, moe_cfg, xn))
        return inner(p, moe_cfg, xn, *a, **kw)

    lm.moe_apply = capture
    try:
        with torch.no_grad():
            vit_loss(state["params"], cfg, b1, use_kernel=True)
    finally:
        lm.moe_apply = inner
    moe_params, moe_cfg, xn = seen[0]
    seen.clear()
    w = torch.randn(xn.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))

    def layer_grads(use_kernel):
        p = tree_map(torch.Tensor.detach, moe_params)
        leaves = list(tree_leaves(p))
        xin = xn.float().requires_grad_()
        for t in leaves:
            t.requires_grad_()
        y, _ = soft_moe_apply(p, moe_cfg, xin, cfg.act,
                              use_kernel=use_kernel)
        return torch.autograd.grad((y * w).sum(), leaves + [xin])

    lk, le = layer_grads(True), layer_grads(False)
    layer_err = max(rel_err(torch, a, b_) for a, b_ in zip(lk, le))
    del lk, le
    log(f"[train] step 1, layer {first} alone in f32 on its captured "
        f"input, every param and the input: kernel vs einsum path "
        f"max|diff| / max|ref| {layer_err:.3e} (tol 1e-4)")
    if bad or layer_err > 1e-4:
        raise AssertionError(f"kernel-path gradients disagree with the "
                             f"einsum path: {bad}")

    # the main path: counts from 0, then timed steps
    n_steps = 7
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for step in range(1, 1 + n_steps):
        b = data.batch(step)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["total_loss"]))  # host sync on the step
        times.append(time.perf_counter() - t0)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(times)
    log(f"[train] {card}: steps 1-{n_steps}: step p50 {p50 * 1e3:.2f} ms "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{batch / p50:.1f} images/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; peak device memory {peak / 2**30:.3f} GiB "
        f"(params + AdamW moments {3 * n_params * 4 / 2**30:.2f} GiB); "
        f"launches K1 {launches[0]} K2 {launches[1]} K3 {launches[2]} K4 "
        f"{launches[3]} K5 {launches[4]} (= {n_steps} x {want})")
    if launches != tuple(n_steps * c for c in want):
        raise AssertionError("train-step launches do not match 12 K1, 12 "
                             "K2, 6 K4 and 6 K5 a step")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss")

    # Where the time goes: one profiled step
    state, _, _ = profile_step(torch, step_fn, state, data.batch(1 + n_steps),
                               f"train {card}")

    # The closing save: the train state of the first MoE layer (params,
    # AdamW moments, step), through CheckpointManager, restored bitwise
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    part = {"params": state["params"]["layers"][first],
            "opt": {"mu": state["opt"]["mu"]["layers"][first],
                    "nu": state["opt"]["nu"]["layers"][first],
                    "step": state["opt"]["step"]}}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(part))
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    step = int(state["opt"]["step"])
    t0 = time.perf_counter()
    mgr.save(step, part, blocking=True)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = mgr.restore(mgr.latest_step(), part)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    same = all(a.dtype == b_.dtype and a.device == b_.device
               and torch.equal(a, b_)
               for a, b_ in zip(tree_leaves(back), tree_leaves(part)))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[train] checkpoint of layer {first}'s train state at step {step}: "
        f"{nbytes / 1e9:.3f} GB saved in {t_save:.2f} s "
        f"({nbytes / 1e9 / t_save:.2f} GB/s), restored in {t_restore:.2f} s "
        f"({nbytes / 1e9 / t_restore:.2f} GB/s); bitwise equal: {same}; the "
        f"whole state, {3 * n_params * 4 / 1e9:.1f} GB, would take "
        f"~{3 * n_params * 4 / (nbytes / t_save):.0f} s to save at this rate")
    if not same:
        raise AssertionError("checkpoint round trip is not bitwise")
    del state, back, part
    torch.cuda.empty_cache()
    return {"dispatch_bwd": launches[3], "combine_bwd": launches[4]}


# ---------------------------------------------------------------------------
# phase 10: Soft-MoE LM training with routing-health telemetry, granite at
# full width and depth
# ---------------------------------------------------------------------------


def phase_lm_train(torch, card):
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import soft_moe_apply
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
        routing_health,
    )
    from repro_torch.models import lm, lm_init, lm_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves, tree_map
    from repro_torch.serve.telemetry import flatten_telemetry
    from repro_torch.train import (
        Trainer,
        TrainerConfig,
        init_train_state,
        make_train_step,
    )

    kernels = (routing_fwd, combine_apply, combine_online, dispatch_bwd,
               combine_bwd, routing_health)
    names = ("K1", "K2", "K3", "K4", "K5", "K6")

    def counts():
        return tuple(k.launches for k in kernels)

    def zero_counts():
        for k in kernels:
            k.launches = 0

    def show(c):
        return " ".join(f"{n} {v}" for n, v in zip(names, c))

    gc.collect()  # the earlier phases' objects, before the state
    torch.cuda.empty_cache()
    cfg = get_config("granite-moe-1b-a400m+soft")
    n_moe = len(cfg.moe_layer_indices())
    batch, seq = 8, 2048
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: lm_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       batch_size=batch, seed=0, device="cuda")
    ocfg = OptimizerConfig()  # the repo's train cells' (launch/specs.py)

    def loss_on(p, b):
        return lm_loss(p, cfg, b, use_kernel=True, telemetry=True)

    def loss_off(p, b):
        return lm_loss(p, cfg, b, use_kernel=True)

    log(f"[lm] {cfg.name}: {cfg.num_layers} layers ({n_moe} Soft-MoE, "
        f"{cfg.moe.num_experts} experts x {cfg.moe.slots_per_expert} slot, "
        f"d_ff {cfg.moe.expert_d_ff}), d {cfg.d_model}, "
        f"{cfg.attention.num_heads} heads / {cfg.attention.num_kv_heads} KV "
        f"x {cfg.attention.head_dim}, vocab {cfg.vocab_size}, tied "
        f"{cfg.tie_embeddings}; scan_layers={cfg.scan_layers} "
        f"remat={cfg.remat}; {n_params} params ({n_params / 1e9:.4f} B); "
        f"train state (f32 params, AdamW mu and nu, step) {state_bytes} "
        f"bytes = {state_bytes / 2**30:.3f} GiB (init "
        f"{time.perf_counter() - t0:.1f} s); compute {cfg.dtype}, batch "
        f"{batch} x {seq} tokens of SyntheticLM")

    # Step 0, the same params and batch: the kernel path's loss and every
    # layer's telemetry against the einsum path's, in bf16. Bounds: the
    # loss within 1e-3 of itself; each telemetry leaf (24 layers stacked,
    # rows included) within 2e-2 of its largest value. The einsum path
    # normalizes x in bf16, the kernels in f32 (a logit moves by ~2^-9),
    # and every later bf16 rounding of the residual stream adds up to 2^-8
    # over 24 layers.
    b0 = data.batch(0)
    with torch.no_grad():
        lk, mk = lm_loss(state["params"], cfg, b0, use_kernel=True,
                         telemetry=True)
        le, me = lm_loss(state["params"], cfg, b0, use_kernel=False,
                         telemetry=True)
    loss_err = abs(float(lk) - float(le)) / abs(float(le))
    rows, worst = [], 0.0

    def walk(a, b_, path):
        nonlocal worst
        if isinstance(b_, dict):
            for k in b_:
                walk(a[k], b_[k], f"{path}.{k}" if path else str(k))
            return
        diff = (a.float() - b_.float()).abs().max()
        top = b_.float().abs().max()  # a count of 0 is held exactly
        err = (diff / top if top > 0 else diff).item()
        worst = max(worst, err)
        rows.append((path, err, tuple(a.shape)))

    walk(mk["telemetry"], me["telemetry"], "")
    flat_k, flat_e = (flatten_telemetry(m["telemetry"]) for m in (mk, me))
    log(f"[lm] step 0 in bf16, kernel vs einsum path: loss {float(lk):.6f} "
        f"vs {float(le):.6f} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.6f}), rel diff {loss_err:.3e} (tol "
        f"1e-3); telemetry max|diff| / max|ref| per leaf (tol 2e-2): "
        + " ".join(f"{p}{list(sh)}={e:.3e}" for p, e, sh in rows))
    log(f"[lm] step 0 flat telemetry, kernel path: "
        + " ".join(f"{k}={v:.6g}" for k, v in flat_k.items()))
    if loss_err > 1e-3 or worst > 2e-2 or set(flat_k) != set(flat_e):
        raise AssertionError("kernel-path loss or telemetry disagrees with "
                             "the einsum path")
    del mk, me

    # one MoE layer in f32 on the input the model feeds it (captured from
    # its own forward): every telemetry leaf within 1e-4 of its largest
    # value (sums in other orders)
    seen, inner = [], lm.moe_apply

    def capture(p, moe_cfg, xn, *a, **kw):
        seen.append((p, moe_cfg, xn))
        return inner(p, moe_cfg, xn, *a, **kw)

    lm.moe_apply = capture
    try:
        with torch.no_grad():
            lm_loss(state["params"], cfg, b0, use_kernel=True)
    finally:
        lm.moe_apply = inner
    p_moe, moe_cfg, xn = seen[0]
    seen.clear()
    with torch.no_grad():
        tk = soft_moe_apply(p_moe, moe_cfg, xn.float(), cfg.act,
                            use_kernel=True, telemetry=True)[1]["telemetry"]
        te = soft_moe_apply(p_moe, moe_cfg, xn.float(), cfg.act,
                            telemetry=True)[1]["telemetry"]
    rows, worst = [], 0.0
    walk(tk, te, "")
    log(f"[lm] layer {cfg.moe_layer_indices()[0]} alone in f32 on its "
        f"captured input, telemetry "
        f"kernel vs einsum path, max|diff| / max|ref| (tol 1e-4): "
        + " ".join(f"{p}={e:.3e}" for p, e, _ in rows))
    if worst > 1e-4:
        raise AssertionError("f32 layer telemetry disagrees")
    del p_moe, xn, tk, te

    # The main path: the Trainer drives make_train_step on the telemetry
    # loss and logs the flattened telemetry every step; counts from 0.
    ckpt_dir = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = 7
    trainer = Trainer(
        TrainerConfig(total_steps=n_steps, checkpoint_every=10**9,
                      checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
                      log_every=1),
        loss_on, None, ocfg, data)
    save = trainer.ckpt.save
    saved = {}

    def timed_save(*a, **kw):  # the Trainer's closing save of the state
        t = time.perf_counter()
        save(*a, **kw)
        saved["s"] = time.perf_counter() - t

    trainer.ckpt.save = timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state = trainer.run(torch.Generator(device="cuda").manual_seed(0),
                        start_state=state)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = trainer.metrics_history
    times = [m["step_time"] for m in hist]
    p50 = statistics.median(times)
    want = (2 * n_moe, 2 * n_moe, 0, n_moe, n_moe, n_moe)
    tkeys = sorted(k for k in hist[-1] if k.startswith("telemetry_"))
    log(f"[lm] {card}: Trainer steps 0-{n_steps - 1} (telemetry on): step "
        f"p50 {p50 * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}) = {batch * seq / p50:.1f} tokens/s; loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; peak device "
        f"memory {peak / 2**30:.3f} GiB (state {state_bytes / 2**30:.2f} "
        f"GiB); launches {show(launches)} (= {n_steps} x {show(want)}: "
        f"remat runs each MoE layer's forward twice, K6 only in the "
        f"first); closing save of the whole state {state_bytes / 1e9:.2f} GB "
        f"in {saved.get('s', float('nan')):.2f} s; {len(tkeys)} telemetry "
        f"keys logged, e.g. "
        + " ".join(f"{k}={hist[-1][k]:.5g}" for k in tkeys[:8]))
    if launches != tuple(n_steps * c for c in want):
        raise AssertionError(f"LM train-step launches {launches} do not "
                             f"match {n_steps} x {want}")
    if not all(math.isfinite(m["loss"]) for m in hist) or not tkeys or \
            not all(math.isfinite(m[k]) for m in hist for k in tkeys):
        raise AssertionError("non-finite loss or telemetry, or none logged")

    # telemetry off beside on, in turns (off, on, on, off) x 2, the same
    # clock (the step's call to a host sync on its loss)
    step_on = make_train_step(loss_on, ocfg)
    step_off = make_train_step(loss_off, ocfg)
    turns = {"on": [], "off": []}
    zero_counts()
    for i, key in enumerate(["off", "on", "on", "off"] * 2):
        b = data.batch(n_steps + i)
        t0 = time.perf_counter()
        state, m = (step_on if key == "on" else step_off)(state, b)
        float(m["total_loss"])
        turns[key].append(time.perf_counter() - t0)
    k6 = routing_health.launches
    on50, off50 = (statistics.median(turns[k]) for k in ("on", "off"))
    log(f"[lm] {card}: telemetry on vs off in turns: step p50 "
        f"{on50 * 1e3:.2f} ms vs {off50 * 1e3:.2f} ms "
        f"({batch * seq / on50:.1f} vs {batch * seq / off50:.1f} tokens/s; "
        f"on/off "
        f"{on50 / off50:.4f}); K6 launches {k6} (= 4 x {n_moe}: none with "
        f"telemetry off)")
    if k6 != 4 * n_moe:
        raise AssertionError("K6 ran with telemetry off")

    # Where the time goes: one profiled step with telemetry on
    state, pwall, busy = profile_step(torch, step_on, state,
                                      data.batch(n_steps + 8),
                                      f"lm train {card}")
    del state, trainer, step_on, step_off
    torch.cuda.empty_cache()
    summary = {"p50": p50, "peak": peak, "busy": busy / pwall,
               "n_params": n_params}
    return {"routing_health": launches[5]}, summary


# ---------------------------------------------------------------------------
# phase 11: the paper's sparse baseline LM, trained at full width and depth
# ---------------------------------------------------------------------------


def phase_sparse_lm_train(torch, card, soft):
    """granite-moe-1b-a400m as configured (Tokens Choice, top-8 of 32,
    capacity factor 1.0, no BPR, groups of one sequence): a full-width
    layer on the card against the CPU in f32, then Trainer steps beside
    the +soft run of phase 10 (``soft``: its summary)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import sparse_moe
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
        routing_health,
    )
    from repro_torch.models import lm, lm_init, lm_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves, tree_map
    from repro_torch.train import Trainer, TrainerConfig, init_train_state

    kernels = (routing_fwd, combine_apply, combine_online, dispatch_bwd,
               combine_bwd, routing_health)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("granite-moe-1b-a400m")
    moe = cfg.moe
    n_moe = len(cfg.moe_layer_indices())
    batch, seq = 8, 2048
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: lm_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       batch_size=batch, seed=0, device="cuda")
    log(f"[sparse-lm] {cfg.name} as configured: {cfg.num_layers} layers "
        f"({n_moe} {moe.variant}, top-{moe.top_k} of {moe.num_experts} "
        f"experts, d_ff {moe.expert_d_ff}, capacity_factor "
        f"{moe.capacity_factor}, bpr {moe.bpr}, group_size "
        f"{moe.group_size}), d {cfg.d_model}, vocab {cfg.vocab_size}; "
        f"scan_layers={cfg.scan_layers} remat={cfg.remat}; {n_params} params "
        f"({n_params / 1e9:.4f} B); train state {state_bytes / 2**30:.3f} "
        f"GiB (init {time.perf_counter() - t0:.1f} s); compute {cfg.dtype}, "
        f"batch {batch} x {seq} tokens of SyntheticLM")

    # Step 0: the first MoE layer, on the input the model feeds it
    # (captured from its own forward), in f32 on the card and on the host
    # CPU: the routes, then y, the aux loss and the dropped fraction.
    b0 = data.batch(0)
    seen, inner = [], lm.moe_apply

    def capture(p, moe_cfg, xn, *a, **kw):
        seen.append((p, moe_cfg, xn))
        return inner(p, moe_cfg, xn, *a, **kw)

    lm.moe_apply = capture
    try:
        with torch.no_grad():
            _, m0 = lm_loss(state["params"], cfg, b0, telemetry=True)
    finally:
        lm.moe_apply = inner
    p_moe, moe_cfg, xn = seen[0]
    seen.clear()
    telem0 = tree_map(lambda t: t.float().cpu(), m0["telemetry"])
    loss0 = float(m0["loss"])
    del m0
    outs = {}
    t_cpu = 0.0
    b, m, d = xn.shape
    coupled, gs = sparse_moe._routing_scope(moe_cfg, "train", b, m)
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), p_moe)
        x = xn.float().to(dev)
        t1 = time.perf_counter()
        with torch.no_grad():
            probs = torch.softmax(sparse_moe._router_logits(
                p, x.reshape(b // gs, gs * m, d)), dim=-1)
            _, eidx, _, keep, cap = sparse_moe._tokens_choice_route(
                probs, moe_cfg, coupled)
            y, met = sparse_moe.tokens_choice_apply(p, moe_cfg, x, cfg.act)
        if dev == "cpu":
            t_cpu = time.perf_counter() - t1
        outs[dev] = [t.cpu() for t in (eidx, keep, y, met["moe_aux_loss"],
                                       met["dropped_fraction"])]
    (ei_g, kp_g, y_g, aux_g, dr_g), (ei_c, kp_c, y_c, aux_c, dr_c) = (
        outs["cuda"], outs["cpu"])
    differ = float((ei_g != ei_c).float().mean())
    agree = ((ei_g == ei_c) & (kp_g == kp_c)).all(-1).reshape(-1)
    y_err = ((y_g.reshape(-1, d)[agree] - y_c.reshape(-1, d)[agree])
             .abs().max() / y_c.abs().max()).item()
    aux_err = abs(float(aux_g) - float(aux_c)) / abs(float(aux_c))
    dr_err = abs(float(dr_g) - float(dr_c)) / max(abs(float(dr_c)), 1e-30)
    log(f"[sparse-lm] step 0, layer {cfg.moe_layer_indices()[0]} alone in "
        f"f32 on its captured input, card vs host CPU ({t_cpu:.1f} s on "
        f"the CPU): (token, choice) pairs whose expert differs "
        f"{differ:.3e} (expected 0); tokens whose choices and drops agree "
        f"{int(agree.sum())}/{agree.numel()}; on them y max|diff|/max|ref| "
        f"{y_err:.3e} (tol 1e-4); moe_aux_loss {float(aux_g):.6f} vs "
        f"{float(aux_c):.6f} rel {aux_err:.3e}; dropped_fraction "
        f"{float(dr_g):.6f} vs {float(dr_c):.6f} rel {dr_err:.3e} (tol "
        f"1e-4); capacity {cap} a group of {gs} sequence(s)")
    if differ != 0.0 or y_err > 1e-4 or aux_err > 1e-4 or dr_err > 1e-4:
        raise AssertionError("the sparse layer on the card disagrees with "
                             "the CPU")
    # per MoE layer, in layer order (a scanned segment's leaves are
    # stacked (count,))
    per_layer = {k: torch.cat([t["moe"][k].reshape(-1) for _, t in
                               sorted(telem0["layers"].items())
                               if "moe" in t]).tolist()
                 for k in ("dropped_fraction", "expert_load_spread")}
    log(f"[sparse-lm] step 0 loss {loss0:.6f} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.6f}); per layer dropped_fraction "
        + " ".join(f"{v:.4f}" for v in per_layer["dropped_fraction"])
        + "; expert_load_spread "
        + " ".join(f"{v:.3f}" for v in per_layer["expert_load_spread"]))
    if len(per_layer["dropped_fraction"]) != n_moe:
        raise AssertionError("a MoE layer logged no telemetry")
    if not all(math.isfinite(v) for leaf in tree_leaves(telem0)
               for v in leaf.reshape(-1).tolist()):
        raise AssertionError("non-finite sparse telemetry")
    del p_moe, xn, outs, y_g, y_c

    # The main path: the Trainer on the telemetry loss; counts from 0.
    ckpt_dir = ROOT / "build" / "chip_smoke_sparse_lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = 6
    trainer = Trainer(
        TrainerConfig(total_steps=n_steps, checkpoint_every=10**9,
                      checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
                      log_every=1),
        lambda p, b: lm_loss(p, cfg, b, telemetry=True), None,
        OptimizerConfig(), data)
    # phase 10 times the closing save of a state of this size; skip it
    trainer.ckpt.save = lambda *a, **kw: None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    state = trainer.run(torch.Generator(device="cuda").manual_seed(0),
                        start_state=state)
    launches = tuple(k.launches for k in kernels)
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = trainer.metrics_history
    times = [m["step_time"] for m in hist]
    p50 = statistics.median(times)
    tkeys = sorted(k for k in hist[-1] if k.startswith("telemetry_moe_"))
    log(f"[sparse-lm] {card}: Trainer steps 0-{n_steps - 1} (telemetry "
        f"on, no closing save): step p50 {p50 * 1e3:.2f} ms (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{batch * seq / p50:.1f} tokens/s; loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f}, aux {hist[-1]['aux_loss']:.5f}; peak "
        f"device memory {peak / 2**30:.3f} GiB; K1-K6 launches "
        f"{launches} (must be 0); last step's MoE telemetry (means over "
        f"the {n_moe} layers) "
        + " ".join(f"{k[len('telemetry_moe_l0_'):]}={hist[-1][k]:.5g}"
                   for k in tkeys))
    if any(launches):
        raise AssertionError(f"a Soft-MoE kernel ran in the sparse LM step: "
                             f"{launches}")
    if not all(math.isfinite(m["loss"]) for m in hist) or not tkeys or \
            not all(math.isfinite(m[k]) for m in hist for k in tkeys):
        raise AssertionError("non-finite loss or telemetry, or none logged")

    # Where the time goes: one profiled step with telemetry on
    from repro_torch.train import make_train_step

    step = make_train_step(lambda p, b: lm_loss(p, cfg, b, telemetry=True),
                           OptimizerConfig())
    state, pwall, busy = profile_step(torch, step, state,
                                      data.batch(n_steps),
                                      f"sparse lm train {card}")
    log(f"[sparse-lm] {card}: sparse vs soft at one width (batch {batch} x "
        f"{seq}, telemetry on): step p50 {p50 * 1e3:.2f} ms vs "
        f"{soft['p50'] * 1e3:.2f} ms (+soft, phase 10), "
        f"{batch * seq / p50:.1f} vs {batch * seq / soft['p50']:.1f} "
        f"tokens/s, peak {peak / 2**30:.3f} vs {soft['peak'] / 2**30:.3f} "
        f"GiB, device busy {busy / pwall:.3f} vs {soft['busy']:.3f} of a "
        f"profiled step's wall; params {n_params} vs {soft['n_params']}")
    del state, trainer, step
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: MoE LMs served with per-row routing and serving telemetry
# ---------------------------------------------------------------------------


def moe_serve_requests(np, vocab, seed=2):
    """Phase 7's request set cut to fit the phase: 8 prompts of 16..256
    tokens (one per slot), 16 new tokens each."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=int(n)).tolist()
            for n in rng.randint(16, 257, size=8)]


def phase_moe_serve(torch, card):
    """The paged engine serves granite-moe-1b-a400m (Tokens Choice) and
    its +soft twin at full width (depth cut, ``SERVE_DEPTH``) with
    telemetry on: K7 on every decode step, per-row dropless routing, the
    batch-variance probe."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels.invariant_matmul import (
        batched_contract,
        router_logits,
    )
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_online,
        routing_fwd,
        routing_health,
    )
    from repro_torch.models import lm_init
    from repro_torch.serve import ServeEngine, batch_variance_probe

    soft_kernels = (routing_fwd, combine_apply, combine_online,
                    routing_health)
    invariant = (router_logits, batched_contract)
    path_launches = {"router_logits": 0, "batched_contract": 0}
    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend="paged")
    max_new = 16
    probes = {}
    for name in ("granite-moe-1b-a400m", "granite-moe-1b-a400m+soft"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = serving_config(name)
        params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
        prompts = moe_serve_requests(np, cfg.vocab_size)
        warm = ServeEngine(cfg, params, telemetry=True, **geo)
        run_engine(torch, warm, prompts[1:3], 4)
        del warm
        runs = {}
        for telemetry in (True, False):
            eng = ServeEngine(cfg, params, telemetry=telemetry, **geo)
            paged_decode_attend.launches = 0
            for k in soft_kernels + invariant:
                k.launches = 0
            reqs, wall, decode_s = run_engine(torch, eng, prompts, max_new)
            runs[telemetry] = (eng, reqs, wall, decode_s,
                               paged_decode_attend.launches,
                               tuple(k.launches for k in soft_kernels),
                               tuple(k.launches for k in invariant))
        eng, reqs, wall, decode_s, k7, soft_l, inv_l = runs[True]
        inv_both = [a + b for a, b in zip(inv_l, runs[False][6])]
        for k, n in zip(invariant, inv_both):
            path_launches[k.__name__] += n
        n_moe = len(cfg.moe_layer_indices())
        sparse = cfg.moe.variant in ("tokens_choice", "experts_choice")
        done = all(r.done and r.finish_reason == "length"
                   for r in reqs)
        snap = eng.telemetry_snapshot()
        flat = snap.get("decode", {})
        key = ("router_entropy" if cfg.moe.variant == "tokens_choice"
               else "dispatch_entropy")
        missing = [i for i in cfg.moe_layer_indices()
                   if f"moe_l{i}_{key}" not in flat]
        finite = all(math.isfinite(v) for ph in snap.values()
                     for v in ph.values())
        dropped = [flat.get(f"moe_l{i}_dropped_fraction", 0.0)
                   for i in cfg.moe_layer_indices()]
        same = [r.out for r in reqs] == [r.out for r in runs[False][1]]
        n_tok = sum(len(r.out) for r in reqs)
        on50 = statistics.median(decode_s) * 1e3
        off50 = statistics.median(runs[False][3]) * 1e3
        log(f"[moe-serve] {name} ({cfg.moe.variant}, {depth_note(cfg)}): "
            f"{len(reqs)} requests "
            f"done={done}, {eng.decode_steps} decode steps; K7 launches {k7} "
            f"(decode_steps x "
            f"{cfg.num_layers} = {eng.decode_steps * cfg.num_layers}), "
            f"K1/K2/K3/K6 {soft_l} (0: serving runs the MoE einsum path); "
            f"router_logits, batched_contract {tuple(inv_both)} over the "
            f"telemetry on and off runs (the router once a sparse MoE layer "
            f"a model call, {n_moe} layers; MLA's products 0: GQA); "
            f"telemetry keys {len(flat)} per decode call, finite {finite}, "
            f"MoE layers missing {key}: {missing}; decode "
            f"dropped_fraction max {max(dropped):.3g}; greedy tokens with "
            f"telemetry on == off: {same}")
        log(f"[moe-serve] {card}: {name}: telemetry on {n_tok / wall:.1f} "
            f"tok/s, decode step p50 {on50:.2f} ms; off "
            f"{n_tok / runs[False][2]:.1f} tok/s, p50 {off50:.2f} ms "
            f"(on/off {on50 / off50:.4f}); first MoE layer's decode stats "
            + " ".join(f"{k}={v:.5g}" for k, v in sorted(flat.items())
                       if k.startswith(f"moe_l{cfg.moe_layer_indices()[0]}_")))
        if not done or k7 != eng.decode_steps * cfg.num_layers or k7 == 0:
            raise AssertionError("MoE serving: unfinished requests or K7 "
                                 "launches != decode_steps x layers")
        if any(soft_l) or missing or not finite or not same or \
                any(v != 0.0 for v in dropped):
            raise AssertionError("MoE serving telemetry or parity failed")
        if inv_both[1] or (inv_both[0] == 0) == sparse or \
                inv_both[0] % n_moe:
            raise AssertionError("router_logits must launch once a sparse "
                                 "MoE layer a model call, and never on the "
                                 "+soft config; batched_contract never")
        del runs, eng, reqs
        probes[name] = batch_variance_probe(cfg, params, [1, 2, 3, 4],
                                            batch_size=4, max_new_tokens=8,
                                            max_len=64, backend="paged")
        if cfg.moe.variant == "tokens_choice":
            hatch = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, group_size=4, capacity_factor=0.5, bpr=True,
                batch_coupled=True))
            probes["hatch"] = batch_variance_probe(
                hatch, params, [1, 2, 3, 4], batch_size=4, max_new_tokens=8,
                max_len=64, backend="paged")
            batch_variance_bisect(torch, cfg, params, card)
        del params
    gc.collect()
    torch.cuda.empty_cache()
    qcfg = serving_config("qwen2-0.5b")
    qparams = lm_init(torch.Generator(device="cuda").manual_seed(0), qcfg)
    probes["qwen2-0.5b"] = batch_variance_probe(
        qcfg, qparams, [1, 2, 3, 4], batch_size=4, max_new_tokens=8,
        max_len=64, backend="paged")
    del qparams
    for name, res in probes.items():
        top = sorted(res["per_stat"].items(), key=lambda kv: -kv[1])[:3]
        log(f"[moe-serve] {card}: batch_variance_probe {name} (batch 4): "
            f"divergence {res['divergence']:.3e} over "
            f"{res['steps_compared']} steps; largest "
            + " ".join(f"{k}={v:.3e}" for k, v in top))
    if any(r["steps_compared"] == 0 for r in probes.values()):
        raise AssertionError("a probe compared no decode step")
    if not probes["hatch"]["divergence"] > \
            probes["granite-moe-1b-a400m"]["divergence"]:
        raise AssertionError("the escape hatch reads no more than the "
                             "default sparse config")
    # the reference's contract (serve/telemetry.py): < 1e-5 on every
    # served arch; the hatch is the one sanctioned finite reading
    high = {k: r["divergence"] for k, r in probes.items()
            if k != "hatch" and not r["divergence"] < PROBE_LIMIT}
    if high:
        raise AssertionError(f"batch_variance_probe >= {PROBE_LIMIT:g}: "
                             f"{high}")
    return path_launches


# ---------------------------------------------------------------------------
# the serving probe's bisection, and weights for the full-width models
# ---------------------------------------------------------------------------


def batch_variance_bisect(torch, cfg, params, card, prompt=(1, 2, 3, 4),
                          batch=4, max_new=8):
    """Where ``batch_variance_probe``'s reading comes from: the target row
    served alone (batch 1) and beside the probe's fillers (batch
    ``batch``), at the target's first decode step, which has the same
    inputs in both runs. Every layer's intermediates of the target row
    are recorded in call order (attention and dense MLP outputs, the
    router logits, the routed and shared experts' outputs, the MoE
    layer's output) and compared; then both runs go on to the end and
    their greedy tokens are compared. Last, the ops that differ are run
    alone at the step's shapes, row 0 of M rows against M = 1: the
    products the port runs through the fixed-order kernel both as the
    kernel and as the einsum they replace (so a log line names the op
    the kernel fixed), and on MLA every product of ``mla_apply``."""
    from repro_torch.core import sparse_moe
    from repro_torch.kernels.invariant_matmul import (
        batched_contract,
        router_logits,
    )
    from repro_torch.layers import attention
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeEngine

    hooks = ((lm, "attention_apply", "attn", lambda o: o[0]),
             (attention, "_attend", "attend", lambda o: o),
             (attention, "_latent_up", "w_uv", lambda o: o),
             (lm, "mlp_apply", "mlp", lambda o: o),
             (lm, "moe_apply", "moe", lambda o: o[0]),
             (sparse_moe, "_router_logits", "router", lambda o: o),
             (sparse_moe, "experts_apply", "experts", lambda o: o))

    def run(fillers):
        eng = ServeEngine(cfg, params, batch_size=1 + len(fillers),
                          max_len=64, device="cuda", backend="paged")
        tgt = Request(prompt=list(prompt), max_new_tokens=max_new)
        rec, first = [], {}
        inner = eng.backend.decode

        def decode(p, toks, pos):
            if first:
                return inner(p, toks, pos)
            first["slot"] = eng.sched.entry_for(tgt).slot
            first["rows"] = int((pos >= 0).sum())
            saved = [(mod, name, getattr(mod, name))
                     for mod, name, _, _ in hooks]
            for (mod, name, kind, pick), (_, _, fn) in zip(hooks, saved):
                def wrapped(*a, _fn=fn, _kind=kind, _pick=pick, **kw):
                    out = _fn(*a, **kw)
                    rec.append((_kind, _pick(out).detach().float().cpu()))
                    return out
                setattr(mod, name, wrapped)
            try:
                return inner(p, toks, pos)
            finally:
                for mod, name, fn in saved:
                    setattr(mod, name, fn)

        eng.backend.decode = decode
        for r in [tgt] + [Request(prompt=list(f), max_new_tokens=max_new)
                          for f in fillers]:
            eng.submit(r)
        eng.run()
        return rec, first, tgt.out

    fillers = [[(t * (i + 2) + 1) % cfg.vocab_size for t in prompt]
               for i in range(batch - 1)]
    solo, s1, solo_out = run([])
    cob, c1, cob_out = run(fillers)

    def target(kind, t, slot):
        # (B, 1, d) outputs and (B, 1, e) router logits are indexed by
        # row; expert outputs (e | 1, B x capacity 1, d) by buffer row
        return t[:, slot] if kind == "experts" else t[slot]

    layer, rows, first_diff, prev = -1, [], None, None
    for (kind, a), (kind2, b) in zip(solo, cob):
        assert kind == kind2
        # a layer opens with its attention: MLA's inner attend, then the
        # attention output
        layer += kind == "attend" or (kind == "attn"
                                      and prev not in ("attend", "w_uv"))
        prev = kind
        diff = (target(kind, a, s1["slot"])
                - target(kind, b, c1["slot"])).abs().max().item()
        rows.append(f"l{layer}:{kind}={diff:.3e}")
        if diff > 0 and first_diff is None:
            first_diff = (layer, kind)
    log(f"[bisect] {card}: {cfg.name}, target row at its first decode "
        f"step alone (slot {s1['slot']}, {s1['rows']} active row) vs "
        f"co-batched (slot {c1['slot']}, {c1['rows']} active rows of "
        f"{batch}): {len(solo)} intermediates; first that differs: "
        f"{first_diff}; max|diff| by layer and op: " + " ".join(rows))
    same = solo_out == cob_out
    n_same = sum(a == b for a, b in zip(solo_out, cob_out))
    log(f"[bisect] {card}: {cfg.name}: greedy tokens alone == co-batched: "
        f"{same} ({n_same}/{len(solo_out)} agree; alone {solo_out}, "
        f"co-batched {cob_out})")

    # the ops alone at the step's shapes, on this model's weights: the
    # routed experts' batched matmul (e, M, d) x (e, d, f) and a dense
    # (M, d) x (d, h k) projection; row 0 at M = batch against M = 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    layer_p = params["layers"][cfg.moe_layer_indices()[0]]
    w_up = layer_p["moe"]["experts"]["w_up"].to(torch.bfloat16)
    wq = layer_p["attn"]["wq"].to(torch.bfloat16)
    e, d = w_up.shape[:2]
    xs = torch.randn(e, batch, d, generator=gen, device="cuda").bfloat16()
    x2 = torch.randn(batch, 1, d, generator=gen, device="cuda").bfloat16()
    router = layer_p["moe"]["router"].float()
    xf = x2.float()

    def rows01(fn, *ops, batched=1):
        """fn at M = batch (row 0) and at M = 1; the first ``batched``
        ops have the rows, the rest (weights) are shared."""
        return fn(*ops)[:1], fn(*(o[:1] if i < batched else o
                                  for i, o in enumerate(ops)))

    def ein(spec):
        return lambda *ops: torch.einsum(spec, *ops)

    iso = {
        f"bmm ({e}, M, {d}) x {tuple(w_up.shape)} in bf16": (
            torch.matmul(xs, w_up)[:, :1], torch.matmul(xs[:, :1], w_up)),
        f"einsum bsd,dhk (M, 1, {d}) x {tuple(wq.shape)} in bf16": rows01(
            ein("bsd,dhk->bshk"), x2, wq),
        f"router einsum gtd,de (M, 1, {d}) x {tuple(router.shape)} in f32 "
        f"(replaced)": rows01(ein("gtd,de->gte"), xf, router),
        f"router_logits kernel (M, 1, {d}) x {tuple(router.shape)} in f32 "
        f"(as served)": rows01(router_logits, xf, router),
    }
    if "w_uk" in layer_p["attn"]:  # every product of mla_apply
        a, ap = cfg.attention, layer_p["attn"]
        h, nope = a.num_heads, a.qk_nope_head_dim
        r, rope, dv = a.kv_lora_rank, a.qk_rope_head_dim, a.v_head_dim
        t = 64  # the probe's max_len: 4 blocks of 16 keys a row
        bf = torch.bfloat16

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        qn, lat = rnd(batch, 1, h, nope), rnd(batch, 1, h, r)
        qcat = rnd(batch, 1, h, r + rope).to(bf).float()
        kcat = rnd(batch, t, 1, r + rope).to(bf).float()
        wts = torch.softmax(rnd(batch, 1, h, 1, t), -1)
        vlat = kcat[..., :r]
        o = rnd(batch, 1, h, dv).to(bf)
        mla = {
            f"wq einsum bsd,dhk {tuple(ap['wq'].shape)} in bf16": rows01(
                ein("bsd,dhk->bshk"), x2, ap["wq"].to(bf)),
            f"w_dkv einsum bsd,dr {tuple(ap['w_dkv'].shape)} in bf16":
                rows01(ein("bsd,dr->bsr"), x2, ap["w_dkv"].to(bf)),
            f"w_krope einsum bsd,dk {tuple(ap['w_krope'].shape)} in bf16":
                rows01(ein("bsd,dk->bsk"), x2, ap["w_krope"].to(bf)),
            f"w_uk einsum bshk,rhk (M, 1, {h}, {nope}) x "
            f"{tuple(ap['w_uk'].shape)} in f32": rows01(
                ein("bshk,rhk->bshr"), qn, ap["w_uk"].float()),
            f"_attend scores einsum bsgrd,btgd (M, 1, 1, {h}, {r + rope}) "
            f"x (M, {t}, 1, {r + rope}) in f32 (replaced)": rows01(
                ein("bsgrd,btgd->bgrst"), qcat[:, :, None], kcat,
                batched=2),
            f"_attend scores batched_contract (M, {h}, {r + rope}) x (M, "
            f"{r + rope}, {t}) in f32 (as served)": rows01(
                batched_contract, qcat.reshape(batch, h, r + rope),
                kcat[:, :, 0].transpose(1, 2), batched=2),
            f"_attend values einsum bgrst,btgd (M, 1, {h}, 1, {t}) x (M, "
            f"{t}, 1, {r}) in f32 (replaced)": rows01(
                ein("bgrst,btgd->bsgrd"), wts, vlat, batched=2),
            f"_attend values batched_contract (M, {h}, {t}) x (M, {t}, "
            f"{r}) in f32 (as served)": rows01(
                batched_contract, wts.reshape(batch, h, t), vlat[:, :, 0],
                batched=2),
            f"w_uv einsum bshr,rhv (M, 1, {h}, {r}) x "
            f"{tuple(ap['w_uv'].shape)} in f32 (replaced)": rows01(
                ein("bshr,rhv->bshv"), lat, ap["w_uv"].float()),
            f"w_uv batched_contract ({h}, M, {r}) x ({h}, {r}, {dv}) in "
            f"f32 (as served)": rows01(
                attention._latent_up, lat, ap["w_uv"].float()),
            f"wo einsum bshv,hvd (M, 1, {h}, {dv}) x "
            f"{tuple(ap['wo'].shape)} in bf16": rows01(
                ein("bshv,hvd->bsd"), o, ap["wo"].to(bf)),
        }
        iso.update({f"MLA {k}": v for k, v in mla.items()})
    # the first layer's dense MLP, where the model has one (deepseek's
    # layer 0), each product in bf16 on (M, 1, its input width) rows
    for name, w in params["layers"][0].get("mlp", {}).items():
        if w.ndim == 2:
            xm = torch.randn(batch, 1, w.shape[0], generator=gen,
                             device="cuda").bfloat16()
            iso[f"layer 0 mlp {name} einsum bsd,df {tuple(w.shape)} in "
                f"bf16"] = rows01(ein("bsd,df->bsf"), xm, w.bfloat16())
    for name, (many, one) in iso.items():
        diff = (many.float() - one.float()).abs()
        log(f"[bisect] {card}: alone, {name}, row 0 at M={batch} "
            f"vs M=1: max|diff| {diff.max().item():.3e} "
            f"({int((diff > 0).sum())} of {diff.numel()} elements differ; "
            f"max|out| {one.float().abs().max().item():.3e})")
    return first_diff, same


def serving_weights(torch, cfg, seed=0):
    """``serving_params(lm_init(gen, cfg))`` for ``gen`` the card's
    generator seeded with ``seed``, without holding the f32 model: the
    same draws in ``lm_init``'s order (embedding, frontend, layers,
    unembed), each layer cast as ``serving_params`` casts it as soon as
    it is drawn, so no more than one layer's f32 weights live at a time
    (deepseek-v2-lite's 15.7 B params are 63 GB in f32)."""
    from repro_torch.layers.common import lecun_init, norm_init
    from repro_torch.layers.embedding import embedding_init
    from repro_torch.models.lm import block_init, check_supported
    from repro_torch.serve.engine import serving_params

    check_supported(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    moe_idx = set(cfg.moe_layer_indices())
    params = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model)}
    if cfg.frontend.kind != "none":
        fe = cfg.frontend.embed_dim
        params["frontend"] = {"w": lecun_init(gen, (fe, cfg.d_model),
                                              fan_in=fe)}
    layers = []
    for i in range(cfg.num_layers):
        one = {"layers": [block_init(gen, cfg, i in moe_idx)],
               "final_norm": {}}
        layers.append(serving_params(one, cfg)["layers"][0])
        del one
    params["layers"] = layers
    params["final_norm"] = serving_params(
        {"layers": [], "final_norm": norm_init(cfg, cfg.d_model, "cuda")},
        cfg)["final_norm"]
    if not cfg.tie_embeddings and cfg.vocab_size:
        params["unembed"] = embedding_init(gen, cfg.vocab_size, cfg.d_model)
    return params


def check_serving_weights(torch, names=("deepseek-v2-lite-16b",
                                        "pixtral-12b")):
    """``serving_weights`` equals ``serving_params(lm_init(...))`` bitwise
    on the reduced configs of ``names``, leaf for leaf."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm_init
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.engine import serving_params

    for name in names:
        cfg = reduced(get_config(name))
        want = serving_params(lm_init(
            torch.Generator(device="cuda").manual_seed(0), cfg), cfg)
        got = serving_weights(torch, cfg)
        same = set(got) == set(want) and all(
            len(tree_leaves(got[k])) == len(tree_leaves(want[k])) and all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                    tree_leaves(got[k]), tree_leaves(want[k])))
            for k in want)
        if not same:
            raise AssertionError(f"serving_weights differs from "
                                 f"serving_params(lm_init) on reduced {name}")
    log(f"[weights] serving_weights == serving_params(lm_init(...)) bitwise "
        f"on reduced {' and '.join(names)}")


def count_params(params):
    from repro_torch.optim import tree_leaves

    leaves = tree_leaves(params)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


# ---------------------------------------------------------------------------
# phase 13: deepseek-v2-lite-16b (MLA) served at full width, depth cut
# ---------------------------------------------------------------------------


def mla_layer_check(torch, cfg, params, card):
    """One MLA layer (layer 1) in f32 on the input the model feeds it
    (captured from a 256-token forward), on the card against the host
    CPU: no cache, then a paged chunked prefill (chunks of 32, the last
    ragged) and three decode steps; each call's output within 1e-5 of its
    largest value, and the latent pool's valid entries too. Returns the
    worst error."""
    from repro_torch.layers.attention import init_paged_kv_cache, mla_apply
    from repro_torch.models import lm, lm_apply

    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (1, 256), generator=gen,
                           device="cuda")
    seen, inner = [], lm.attention_apply

    def capture(p, c, x, **kw):
        seen.append((p, x))
        return inner(p, c, x, **kw)

    lm.attention_apply = capture
    try:
        with torch.no_grad():
            lm_apply(params, cfg, tokens, mode="prefill", last_only=True)
    finally:
        lm.attention_apply = inner
    p_attn, x = seen[1]
    seen.clear()
    n, bs, n_dec = x.shape[1], 16, 3
    calls = [(c, min(c + 32, n - n_dec)) for c in range(0, n - n_dec, 32)]
    calls += [(i, i + 1) for i in range(n - n_dec, n)]
    outs = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.float().to(dev) for k, v in p_attn.items()}
        xd = x.float().to(dev)
        nblk = n // bs + 2
        pool = init_paged_kv_cache(cfg, nblk, bs, torch.float32, device=dev)
        tables = torch.arange(1, nblk, dtype=torch.int32,
                              device=dev)[None]
        with torch.no_grad():
            res = [mla_apply(p, cfg, xd)[0]]
            for a, b in calls:
                pos = torch.arange(a, b, dtype=torch.int32, device=dev)[None]
                res.append(mla_apply(p, cfg, xd[:, a:b], positions=pos,
                                     cache=pool, mode="decode",
                                     block_tables=tables)[0])
        outs[dev] = [t.cpu() for t in res] + [pool[k].cpu() for k in
                                              ("ckv", "krope", "pos")]
    g, c = outs["cuda"], outs["cpu"]
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(g[:-1], c[:-1])]
    pos_equal = torch.equal(g[-1], c[-1])
    # the paged calls against the no-cache output, on the card
    paged = torch.cat(g[1:1 + len(calls)], dim=1)
    self_err = ((paged - g[0]).abs().max() / g[0].abs().max()).item()
    worst = max(errs)
    log(f"[mla] {card}: layer 1 alone in f32 on its captured input ({n} "
        f"tokens), card vs host CPU, max|diff| / max|ref| (tol 1e-5): no "
        f"cache {errs[0]:.3e}; paged prefill chunks "
        + " ".join(f"{e:.3e}" for e in errs[1:1 + len(calls) - n_dec])
        + "; decode steps "
        + " ".join(f"{e:.3e}" for e in errs[len(calls) - n_dec + 1:
                                             len(calls) + 1])
        + f"; pool ckv {errs[-2]:.3e} krope {errs[-1]:.3e}, pos equal "
        f"{pos_equal}; paged calls vs no cache on the card {self_err:.3e}")
    if worst > 1e-5 or not pos_equal or self_err > 1e-5:
        raise AssertionError("the MLA layer on the card disagrees with the "
                             "CPU")
    return worst


def phase_mla_serve(torch, card):
    """The paged engine serves deepseek-v2-lite-16b at full width, depth
    cut (``SERVE_DEPTH``: layer 0 dense, the next 8 Tokens Choice), MLA
    attention over the latent pool: K7 never runs (MLA decode gathers, as
    in the reference), nor K1-K6."""
    import numpy as np

    from repro_torch.kernels.invariant_matmul import (
        batched_contract,
        router_logits,
    )
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
        routing_health,
    )
    from repro_torch.serve import Request, ServeEngine, batch_variance_probe

    kernels = (paged_decode_attend, routing_fwd, combine_apply,
               combine_online, dispatch_bwd, combine_bwd, routing_health)
    invariant = (router_logits, batched_contract)
    gc.collect()
    torch.cuda.empty_cache()
    check_serving_weights(torch)
    cfg = serving_config("deepseek-v2-lite-16b")
    a, moe = cfg.attention, cfg.moe
    t0 = time.perf_counter()
    params = serving_weights(torch, cfg)
    torch.cuda.synchronize()
    n_params, n_bytes = count_params(params)
    log(f"[mla] {cfg.name}: {depth_note(cfg)} (layer 0 dense, "
        f"{len(cfg.moe_layer_indices())} {moe.variant}, top-{moe.top_k} of "
        f"{moe.num_experts} experts + {moe.num_shared_experts} shared, d_ff "
        f"{moe.expert_d_ff}), d {cfg.d_model}, MLA {a.num_heads} heads, "
        f"kv_lora_rank {a.kv_lora_rank}, rope {a.qk_rope_head_dim}, nope "
        f"{a.qk_nope_head_dim}, v {a.v_head_dim}, vocab {cfg.vocab_size}; "
        f"{n_params} params ({n_params / 1e9:.4f} B) as served: "
        f"{n_bytes / 2**30:.3f} GiB (bf16 layers; embeddings, w_uk, w_uv "
        f"and routers f32; built layer by layer in "
        f"{time.perf_counter() - t0:.1f} s)")
    mla_layer_check(torch, cfg, params, card)

    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend="paged")
    max_new = 16
    prompts = moe_serve_requests(np, cfg.vocab_size)
    warm = ServeEngine(cfg, params, telemetry=True, **geo)
    run_engine(torch, warm, prompts[1:3], 4)
    del warm
    runs, prefill = {}, {}
    for telemetry in (True, False):
        eng = ServeEngine(cfg, params, telemetry=telemetry, **geo)
        for k in kernels + invariant:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        chunk_s = timed_method(torch, eng.backend, "prefill_chunk")
        reqs, wall, decode_s = run_engine(torch, eng, prompts, max_new)
        ttft = statistics.median(r.t_first_token - r.t_submit for r in reqs)
        prefill[telemetry] = (ttft * 1e3, statistics.median(chunk_s) * 1e3,
                              len(chunk_s))
        runs[telemetry] = (eng, reqs, wall, decode_s,
                           tuple(k.launches for k in kernels),
                           torch.cuda.max_memory_allocated(),
                           tuple(k.launches for k in invariant))
    eng, reqs, wall, decode_s, launches, peak, inv_l = runs[True]
    inv_both = [a + b for a, b in zip(inv_l, runs[False][6])]
    n_moe = len(cfg.moe_layer_indices())
    done = all(r.done and r.finish_reason == "length" for r in reqs)
    flat = eng.telemetry_snapshot().get("decode", {})
    missing = [i for i in cfg.moe_layer_indices()
               if f"moe_l{i}_router_entropy" not in flat]
    finite = all(math.isfinite(v) for ph in
                 eng.telemetry_snapshot().values() for v in ph.values())
    dropped = [flat.get(f"moe_l{i}_dropped_fraction", 1.0)
               for i in cfg.moe_layer_indices()]
    same = [r.out for r in reqs] == [r.out for r in runs[False][1]]
    n_tok = sum(len(r.out) for r in reqs)
    on50 = statistics.median(decode_s) * 1e3
    off50 = statistics.median(runs[False][3]) * 1e3
    log(f"[mla] {cfg.name}: {len(reqs)} requests done={done}, "
        f"{eng.decode_steps} decode steps; launches K7 {launches[0]} "
        f"(0: MLA decode gathers), K1-K6 {launches[1:]} (0: serving runs "
        f"the MoE einsum path); router_logits {inv_both[0]} (once a MoE "
        f"layer a model call, {n_moe} layers), batched_contract "
        f"{inv_both[1]} (MLA's scores, weighted latent and w_uv expansion: "
        f"3 a layer a model call, {cfg.num_layers} layers) over the "
        f"telemetry on and off runs; {len(flat)} telemetry keys a decode "
        f"call, "
        f"finite {finite}, MoE layers missing router_entropy {missing}; "
        f"decode dropped_fraction max {max(dropped):.3g} over "
        f"{len(dropped)} layers; greedy tokens with telemetry on == off: "
        f"{same}")
    log(f"[mla] {card}: {cfg.name} served (batch 8, max_len 2048, block 16, "
        f"8 requests of 16-256 prompt tokens, 16 new): telemetry on "
        f"{n_tok / wall:.1f} tok/s, decode step p50 {on50:.2f} ms; off "
        f"{n_tok / runs[False][2]:.1f} tok/s, p50 {off50:.2f} ms (on/off "
        f"{on50 / off50:.4f}); TTFT p50 {prefill[True][0]:.1f} ms (off "
        f"{prefill[False][0]:.1f}), prefill chunk p50 {prefill[True][1]:.2f}"
        f" ms over {prefill[True][2]} chunks (off {prefill[False][1]:.2f}); "
        f"peak device memory {peak / 2**30:.3f} GiB "
        f"(off {runs[False][5] / 2**30:.3f}); latent pool "
        f"{eng.backend.bytes_per_block() * eng.backend.num_blocks / 2**30:.3f}"
        f" GiB")
    if not done or any(launches) or missing or not finite or not same or \
            any(v != 0.0 for v in dropped):
        raise AssertionError("deepseek serving failed: unfinished requests, "
                             "a kernel launch, telemetry or token parity")
    if not inv_both[0] or inv_both[0] % n_moe or not inv_both[1] or \
            inv_both[1] % (3 * cfg.num_layers) or \
            inv_both[0] // n_moe != inv_both[1] // (3 * cfg.num_layers):
        raise AssertionError("router_logits must launch once a MoE layer "
                             "and batched_contract 3 times an MLA layer, "
                             "every model call")
    del runs, eng, reqs
    # where the time goes: 5 ticks in the middle of the same trace (a
    # short window: reading a profile back costs seconds a tick)
    prof_eng = ServeEngine(cfg, params, **geo)
    for pr in prompts:
        prof_eng.submit(Request(prompt=list(pr), max_new_tokens=max_new))
    for _ in range(30):
        prof_eng.step()
    tick_profile(torch, prof_eng, 5, f"mla serve {card}: 5 ticks (ticks "
                 f"31-35 of the trace, telemetry off)")
    del prof_eng
    res = batch_variance_probe(cfg, params, [1, 2, 3, 4], batch_size=4,
                               max_new_tokens=8, max_len=64,
                               backend="paged")
    top = sorted(res["per_stat"].items(), key=lambda kv: -kv[1])[:3]
    log(f"[mla] {card}: batch_variance_probe {cfg.name} (batch 4): "
        f"divergence {res['divergence']:.3e} over {res['steps_compared']} "
        f"steps; largest " + " ".join(f"{k}={v:.3e}" for k, v in top))
    if res["steps_compared"] == 0:
        raise AssertionError("the probe compared no decode step")
    batch_variance_bisect(torch, cfg, params, card)
    if not res["divergence"] < PROBE_LIMIT:
        raise AssertionError(f"batch_variance_probe {cfg.name} reads "
                             f"{res['divergence']:.3e} >= {PROBE_LIMIT:g}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"router_logits": inv_both[0], "batched_contract": inv_both[1]}


# ---------------------------------------------------------------------------
# phase 14: pixtral-12b, the vision frontend stub, at full width, depth cut
# ---------------------------------------------------------------------------


def phase_vlm(torch, card):
    """pixtral-12b at full width, depth cut (``SERVE_DEPTH``): a forward
    with patch embeddings, then text-only serving with K7 on every decode
    step, teacher forced against the gather path."""
    import numpy as np

    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.models import lm_apply
    from repro_torch.serve import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = serving_config("pixtral-12b")
    fe = cfg.frontend
    t0 = time.perf_counter()
    params = serving_weights(torch, cfg)
    torch.cuda.synchronize()
    n_params, n_bytes = count_params(params)
    log(f"[vlm] {cfg.name}: {depth_note(cfg)}, d {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, {cfg.attention.num_heads} heads / "
        f"{cfg.attention.num_kv_heads} KV x {cfg.attention.head_dim}, vocab "
        f"{cfg.vocab_size}, frontend {fe.kind} ({fe.embed_dim} -> "
        f"{cfg.d_model}); {n_params} params ({n_params / 1e9:.4f} B) as "
        f"served: {n_bytes / 2**30:.3f} GiB (built layer by layer in "
        f"{time.perf_counter() - t0:.1f} s)")

    # the frontend stub: 2 rows of 256 N(0, 1) patch embeddings + 256 text
    # tokens, under inference_mode
    gen = torch.Generator(device="cuda").manual_seed(4)
    embeds = torch.randn(2, fe.num_embeds, fe.embed_dim, generator=gen,
                         device="cuda")
    tokens = torch.randint(1, cfg.vocab_size, (2, 256), generator=gen,
                           device="cuda")
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = lm_apply(params, cfg, tokens, embeds=embeds)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        text = lm_apply(params, cfg, tokens)[0]
        finite = bool(torch.isfinite(logits).all())
        moved = (logits[:, fe.num_embeds:] - text).abs().max().item()
    shape = tuple(logits.shape)
    fwd50 = statistics.median(times[1:]) * 1e3
    log(f"[vlm] {card}: lm_apply(embeds=) on 2 rows of {fe.num_embeds} "
        f"patch embeddings + 256 tokens: logits {shape} finite {finite}; "
        f"forward p50 {fwd50:.2f} ms over 5 (first {times[0] * 1e3:.2f} "
        f"ms), {2 * (fe.num_embeds + 256) / fwd50 * 1e3:.1f} positions/s; "
        f"peak device memory {peak / 2**30:.3f} GiB; the text logits move "
        f"by {moved:.3e} against a text-only forward (the patches are "
        f"attended)")
    if shape != (2, fe.num_embeds + 256, cfg.vocab_size) or not finite or \
            not moved > 0:
        raise AssertionError("the vlm forward with embeds failed")
    del logits, text, embeds

    # text-only serving, phase 12's trace; counts from 0
    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend="paged")
    max_new = 16
    prompts = moe_serve_requests(np, cfg.vocab_size)
    warm = ServeEngine(cfg, params, **geo)
    run_engine(torch, warm, prompts[1:3], 4)
    del warm
    eng = ServeEngine(cfg, params, **geo)
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attend.launches = 0
    reqs, wall, decode_s = run_engine(torch, eng, prompts, max_new)
    launches = paged_decode_attend.launches
    peak = torch.cuda.max_memory_allocated()
    done = all(r.done and r.finish_reason == "length" for r in reqs)
    n_tok = sum(len(r.out) for r in reqs)
    log(f"[vlm] {cfg.name} served text only: {len(reqs)} requests "
        f"done={done}, {eng.decode_steps} decode steps; K7 launches "
        f"{launches} (decode_steps x {cfg.num_layers} = "
        f"{eng.decode_steps * cfg.num_layers})")
    log(f"[vlm] {card}: {cfg.name} served (batch 8, max_len 2048, block "
        f"16, 8 requests of 16-256 prompt tokens, 16 new): "
        f"{n_tok / wall:.1f} tok/s, decode step p50 "
        f"{statistics.median(decode_s) * 1e3:.2f} ms; peak device memory "
        f"{peak / 2**30:.3f} GiB")
    if not done or launches != eng.decode_steps * cfg.num_layers or \
            launches == 0:
        raise AssertionError("pixtral serving: unfinished requests or K7 "
                             "launches != decode_steps x layers")
    del eng, reqs
    prof_eng = ServeEngine(cfg, params, **geo)
    for pr in prompts:
        prof_eng.submit(Request(prompt=list(pr), max_new_tokens=max_new))
    for _ in range(30):
        prof_eng.step()
    tick_profile(torch, prof_eng, 10, f"vlm serve {card}: 10 ticks (ticks "
                 f"31-40 of the trace)")
    del prof_eng

    # the kernel engine against the gather engine, teacher forced
    oracle = ServeEngine(cfg, params, use_kernel=False, **geo)
    ticks = teacher_forced(torch, ServeEngine(cfg, params, **geo), oracle,
                           prompts, max_new)
    # PERF.md section 2's serving bound: a pass's max|diff| over the
    # gather engine's max|logit| (pixtral's logits are ~2.4x qwen2-0.5b's:
    # an untied 5120-wide unembedding)
    rels = [d / r for _, d, _, r in ticks]
    rows = sum(len(t[0]) for t in ticks)
    agree = sum(t[2] for t in ticks)
    log(f"[vlm] {card}: kernel vs gather engine, teacher forced: "
        f"{len(ticks)} sampling passes, {rows} row logits compared; "
        f"max|diff| / max|ref| of a pass at most {max(rels):.3e} (tol "
        f"5e-2), median {statistics.median(rels):.3e}; max_abs_diff "
        f"{max(t[1] for t in ticks):.3e}, max|ref| "
        f"{min(t[3] for t in ticks):.3e}-{max(t[3] for t in ticks):.3e}; "
        f"identical greedy tokens {agree}/{rows} = {agree / rows:.4f}")
    if not all(math.isfinite(r) for r in rels) or max(rels) > 5e-2:
        raise AssertionError("pixtral kernel engine logits disagree with "
                             "the gather engine")
    del oracle, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_decode_attend": launches}


# ---------------------------------------------------------------------------
# phase 15: deepseek-v2-lite trained at 4096 tokens on the chunked path
# ---------------------------------------------------------------------------


def phase_long_lm_train(torch, card):
    """deepseek-v2-lite-16b at full width, depth cut to 4 layers (layer 0
    dense, 1-3 Tokens Choice as published), trained on batch 2 x 4096:
    every MLA layer attends through the chunked path; at step 0 its loss
    against the dense path's."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.layers import attention
    from repro_torch.models import lm_init, lm_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves
    from repro_torch.train import (
        Trainer,
        TrainerConfig,
        init_train_state,
        make_train_step,
    )

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(full, num_layers=4, moe_layers="1,2,3")
    cut = (f"depth cut from {full.num_layers} to {cfg.num_layers} layers "
           f"(layer 0 dense, 1-3 {cfg.moe.variant})")
    batch, seq = 2, 4096
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: lm_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       batch_size=batch, seed=0, device="cuda")
    log(f"[long-lm] {cfg.name}, {cut}: d {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; scan_layers={cfg.scan_layers} remat={cfg.remat}; "
        f"{n_params} params ({n_params / 1e9:.4f} B); train state "
        f"{state_bytes / 2**30:.3f} GiB (init {time.perf_counter() - t0:.1f} "
        f"s); compute {cfg.dtype}, batch {batch} x {seq} tokens of "
        f"SyntheticLM; Sq x Sk = {seq * seq} > _CHUNKED_THRESHOLD "
        f"{attention._CHUNKED_THRESHOLD}")

    calls = []
    inner = attention._attend_chunked

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    attention._attend_chunked = counted
    try:
        # step 0, no grad: the chunked path's loss against the dense
        # path's (the threshold raised past every product)
        b0 = data.batch(0)
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            lc = float(lm_loss(state["params"], cfg, b0)[1]["loss"])
            peak_c = torch.cuda.max_memory_allocated()
            n_chunked = len(calls)
            threshold = attention._CHUNKED_THRESHOLD
            attention._CHUNKED_THRESHOLD = 1 << 62
            try:
                torch.cuda.reset_peak_memory_stats()
                ld = float(lm_loss(state["params"], cfg, b0)[1]["loss"])
                peak_d = torch.cuda.max_memory_allocated()
            finally:
                attention._CHUNKED_THRESHOLD = threshold
        rel = abs(lc - ld) / abs(ld)
        log(f"[long-lm] {card}: step 0 forward, no grad: loss chunked "
            f"{lc:.6f} ({n_chunked} chunked attends) vs dense {ld:.6f} "
            f"(ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.6f}), rel "
            f"diff {rel:.3e} (tol 1e-3); peak device memory chunked "
            f"{peak_c / 2**30:.3f} vs dense {peak_d / 2**30:.3f} GiB")
        if rel > 1e-3 or n_chunked != cfg.num_layers or \
                not math.isfinite(lc):
            raise AssertionError("the chunked path's loss disagrees with "
                                 "the dense path's")

        # the main path: the Trainer on the telemetry loss; counts from 0
        ckpt_dir = ROOT / "build" / "chip_smoke_long_lm_ckpt"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        n_steps = 5
        trainer = Trainer(
            TrainerConfig(total_steps=n_steps, checkpoint_every=10**9,
                          checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
                          log_every=1),
            lambda p, b: lm_loss(p, cfg, b, telemetry=True), None,
            OptimizerConfig(), data)
        trainer.ckpt.save = lambda *a, **kw: None  # no closing save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls.clear()
        state = trainer.run(torch.Generator(device="cuda").manual_seed(0),
                            start_state=state)
        n_chunked = len(calls)
    finally:
        attention._attend_chunked = inner
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = trainer.metrics_history
    times = [m["step_time"] for m in hist]
    p50 = statistics.median(times)
    dropped = {k[len("telemetry_"):]: v for k, v in hist[-1].items()
               if k.endswith("dropped_fraction")}
    # remat runs each block's forward again in the backward
    per_step = cfg.num_layers * (2 if cfg.scan_layers and cfg.remat else 1)
    log(f"[long-lm] {card}: {cfg.name}, {cut}: Trainer steps 0-"
        f"{n_steps - 1} (telemetry on, no closing save): step p50 "
        f"{p50 * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}) = {batch * seq / p50:.1f} tokens/s; loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; peak device "
        f"memory {peak / 2**30:.3f} GiB; chunked attends {n_chunked} (= "
        f"{n_steps} steps x {per_step}: each layer's forward and remat "
        f"recompute); last step's dropped fractions {dropped}")
    if n_chunked != n_steps * per_step or \
            not all(math.isfinite(m["loss"]) for m in hist):
        raise AssertionError("the long LM steps did not run the chunked "
                             "path, or the loss is not finite")
    # where the time goes: one profiled step with telemetry on
    step = make_train_step(lambda p, b: lm_loss(p, cfg, b, telemetry=True),
                           OptimizerConfig())
    state, pwall, busy = profile_step(torch, step, state,
                                      data.batch(n_steps),
                                      f"long lm train {card} ({cut})")
    del state, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"p50": p50, "peak": peak, "busy": busy / pwall}


# ---------------------------------------------------------------------------
# phase 16: the Mamba-2 (SSD) layer, card against the host CPU in f32
# ---------------------------------------------------------------------------


def ssm_layer_params(torch, cfg, seed):
    """``ssm_init`` params on the host, with the constant leaves (conv_b,
    D, norm_scale, dt_bias) perturbed so that every leaf reaches the
    output."""
    from repro_torch.layers.ssm import ssm_init

    gen = torch.Generator().manual_seed(seed)
    p = ssm_init(gen, cfg)
    for k in ("conv_b", "D", "norm_scale", "dt_bias"):
        p[k] = p[k] + 0.3 * torch.randn(p[k].shape, generator=gen)
    return p


def phase_ssm(torch, card):
    """One f32 Mamba-2 layer at mamba2-370m's and hymba-1.5b's widths, on
    the card against the host CPU (same params, same inputs): no cache at
    S = 2048; a cached chunked prefill continued over a second chunk, row
    1 left-padded and row 2 inactive; 4 decode steps with row 2 inactive.
    Each within 1e-5 of max|ref| (outputs, conv ring, state), and the
    inactive row's ring and state bitwise unchanged on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.layers.ssm import init_ssm_cache, ssm_apply

    tol = 1e-5
    for seed, name in enumerate(("mamba2-370m", "hymba-1.5b")):
        cfg = dataclasses.replace(get_config(name), dtype="float32")
        s = cfg.ssm
        host = ssm_layer_params(torch, cfg, seed)
        dev = {k: v.cuda() for k, v in host.items()}
        gen = torch.Generator().manual_seed(10 + seed)
        errs = {}

        def check(label, got, want):
            rel = ((got.cpu() - want).abs().max() /
                   want.abs().max()).item()
            errs[label] = rel
            if not rel <= tol:
                raise AssertionError(f"ssm {name} {label}: card vs CPU "
                                     f"{rel:.3e} of max|ref| > {tol}")

        # no cache, S = 2048
        x = torch.randn(2, 2048, cfg.d_model, generator=gen)
        t0 = time.perf_counter()
        want = ssm_apply(host, cfg, x)[0]
        cpu_s = time.perf_counter() - t0
        got = ssm_apply(dev, cfg, x.cuda())[0]
        torch.cuda.synchronize()
        check("no cache S=2048", got, want)

        # cached: two prefill chunks (200 then 100 tokens), 4 decode steps
        caches = [init_ssm_cache(cfg, 3, torch.float32, device=d)
                  for d in ("cpu", "cuda")]
        ring = torch.randn(caches[0]["conv"][2].shape, generator=gen)
        state = torch.randn(caches[0]["state"][2].shape, generator=gen)
        for c in caches:
            c["conv"][2] = ring.to(c["conv"].device)
            c["state"][2] = state.to(c["state"].device)
        frozen = {k: v[2].clone() for k, v in caches[1].items()}
        start = 0
        for label, n in (("prefill chunk 1", 200), ("prefill chunk 2", 100),
                         *((f"decode step {i}", 1) for i in range(4))):
            pos = torch.arange(start, start + n, dtype=torch.int32)
            pos = pos.expand(3, n).clone()
            if start == 0:
                pos[1, :37] = -1  # row 1's left pad
            pos[2] = -1
            x = torch.randn(3, n, cfg.d_model, generator=gen)
            outs = [ssm_apply(p, cfg, x.to(c["conv"].device), cache=c,
                              mode="decode", positions=pos.to(
                                  c["conv"].device))[0]
                    for p, c in ((host, caches[0]), (dev, caches[1]))]
            torch.cuda.synchronize()
            check(label, outs[1][:2], outs[0][:2])
            for k in ("conv", "state"):
                check(f"{label} {k}", caches[1][k][:2], caches[0][k][:2])
                if not torch.equal(caches[1][k][2], frozen[k]):
                    raise AssertionError(f"ssm {name}: the inactive row's "
                                         f"{k} moved at {label}")
            start += n
        log(f"[ssm] {card}: {name} layer (d {cfg.d_model}, {s.num_heads(cfg.d_model)} "
            f"heads of {s.head_dim}, state {s.state_dim}, chunk "
            f"{s.chunk_size}) in f32, card vs host CPU, max|diff| / max|ref| "
            f"(tol {tol:.0e}): "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f"; the inactive row's ring and state bitwise unchanged; CPU "
            f"no-cache pass {cpu_s:.2f} s")


# ---------------------------------------------------------------------------
# phase 17: mamba2-370m and hymba-1.5b served at full width, depth cut
# ---------------------------------------------------------------------------


def engine_logits(torch, eng):
    """Wrap ``eng``'s sampling pass so that each decoding row's logits
    (the distribution its next token is drawn from) are kept by request:
    ``{id(req): [logits, ...]}`` in generation order."""
    kept = {}
    inner = eng._do_decode

    def sample():
        for e in eng.sched.decode_entries():
            kept.setdefault(id(e.req), []).append(eng._logits[e.slot].clone())
        return inner()

    eng._do_decode = sample
    return kept


def model_gain(torch, cfg, prompt):
    """How far the model amplifies rounding: the move of its f32 logits
    over ``prompt`` (max|diff| / max|ref|) under a 1e-6 relative
    perturbation of the embedding table, over 1e-6."""
    import dataclasses

    from repro_torch.models import lm_apply

    f32 = dataclasses.replace(cfg, dtype="float32")
    params = serving_weights(torch, f32)
    seq = torch.tensor([prompt], device="cuda")
    with torch.inference_mode():
        ref = lm_apply(params, f32, seq)[0][0]
        table = params["embed"]["table"]
        noise = torch.randn(table.shape, device="cuda", generator=torch.
                            Generator(device="cuda").manual_seed(5))
        params["embed"] = {"table": table * (1 + 1e-6 * noise)}
        moved = lm_apply(params, f32, seq)[0][0]
    return ((moved - ref).abs().max() / ref.abs().max()).item() / 1e-6


def ssm_served_logits(torch, card, cfg, params, reqs, kept, gain):
    """Each request's served logits against a no-cache forward over its
    prompt and the tokens it generated (the chunked training form),
    recorded beside the model's gain (``model_gain``): the random-weight
    Mamba-2 layers amplify rounding, so ``ssm_layers_teacher_forced``
    holds the served path layer by layer instead."""
    from repro_torch.models import lm_apply

    rels, rows, agree = [], 0, 0
    with torch.inference_mode():
        for r in reqs:
            seq = torch.tensor([r.prompt + r.out[:-1]], device="cuda")
            ref = lm_apply(params, cfg, seq)[0][0, len(r.prompt) - 1:]
            mine = torch.stack(kept[id(r)])
            rels.append((mine - ref).abs().max().item() /
                        ref.abs().max().item())
            rows += len(mine)
            agree += int((mine.argmax(-1) == ref.argmax(-1)).sum())
    log(f"[ssm-serve] {card}: {cfg.name}, served logits vs a no-cache "
        f"forward over each whole sequence, teacher forced (recorded): "
        f"{rows} row logits; max|diff| / max|ref| at most {max(rels):.3e}, "
        f"median {statistics.median(rels):.3e}; identical greedy tokens "
        f"{agree}/{rows} = {agree / rows:.4f}; the f32 model moves "
        f"{gain:.1f}x a 1e-6 relative perturbation of its embedding")
    if not all(math.isfinite(r) for r in rels):
        raise AssertionError(f"{cfg.name}: non-finite served logits")


class K7InSitu:
    """Context in which every K7 call of the attention layers is also run
    on the gather path (``use_kernel=False``'s route) on the same
    operands; the list it yields collects, per call, the live rows'
    worst |kernel - gather| - 2^-7 |gather| (device scalars: no sync)."""

    def __init__(self, torch):
        from repro_torch.layers import attention

        self.torch, self.attn = torch, attention
        self.inner = attention.paged_decode_attend
        self.calls = []

    def __enter__(self):
        attn, inner, calls = self.attn, self.inner, self.calls

        def checked(q, k, v, pos, tables, qpos, *, causal, window,
                    is_global, **kw):
            out = inner(q, k, v, pos, tables, qpos, causal=causal,
                        window=window, is_global=is_global, **kw)
            view, kpos = attn._paged_view({"k": k, "v": v, "pos": pos},
                                          tables)
            ref = attn._attend_any(q[:, None], view["k"], view["v"],
                                   qpos[:, None], kpos, causal, window,
                                   is_global=is_global)[:, 0]
            live = qpos >= 0
            o, r = out[live].float(), ref[live].float()
            calls.append(((o - r).abs() - 2.0**-7 * r.abs()).max())
            return out

        attn.paged_decode_attend = checked
        return calls

    def __exit__(self, *exc):
        self.attn.paged_decode_attend = self.inner
        return False


def k7_in_situ_check(torch, card, name, calls):
    """Every checked K7 call within one bf16 step (2^-7 |gather|, plus
    1e-5) of the gather path, as phase 3 holds K7 to its plain version."""
    worst = torch.stack(calls).max().item()
    log(f"[ssm-serve] {card}: {name}, every K7 call of the kernel engine's "
        f"teacher-forced run against the gather path on the same operands "
        f"({len(calls)} calls, all layers and decode steps): worst "
        f"|kernel - gather| - 2^-7 |gather| = {worst:.3e} (tol 1e-5)")
    if not calls or not worst <= 1e-5:
        raise AssertionError(f"{name}: a K7 call left one bf16 step of the "
                             f"gather path")


def ssm_layers_teacher_forced(torch, card, cfg, params, prompt, max_new):
    """Serve ``prompt`` alone (batch 2: its decode steps carry an inactive
    row) with every SSM layer's input and output rows captured at each
    call (chunked prefill, then decode), then hold each layer's outputs
    over the request's tokens against that layer's no-cache chunked form
    on the captured inputs: the layer is fed the engine's own stream, so
    no error is carried from layer to layer. Bound 5e-2 of max|ref| per
    layer (bf16)."""
    import repro_torch.models.lm as lm_mod
    from repro_torch.serve import Request, ServeEngine

    calls = []
    inner = lm_mod.ssm_apply

    def capture(p, c, x, **kw):
        out = inner(p, c, x, **kw)
        calls.append((x, out[0], kw["positions"]))
        return out

    lm_mod.ssm_apply = capture
    try:
        eng = ServeEngine(cfg, params, batch_size=2, max_len=2048,
                          block_size=16, device="cuda", backend="paged")
        req = Request(prompt=list(prompt), max_new_tokens=max_new)
        eng.submit(req)
        eng.run()
    finally:
        lm_mod.ssm_apply = inner
    xs = [[] for _ in range(cfg.num_layers)]
    ys = [[] for _ in range(cfg.num_layers)]
    for i, (x, y, pos) in enumerate(calls):
        live = (pos if pos.ndim == 2 else pos[None].expand(x.shape[:2])) >= 0
        xs[i % cfg.num_layers].append(x[live])
        ys[i % cfg.num_layers].append(y[live])
    rels = []
    with torch.inference_mode():
        for i in range(cfg.num_layers):
            x, y = torch.cat(xs[i]), torch.cat(ys[i])
            ref = inner(params["layers"][i]["ssm"], cfg, x[None])[0][0]
            rels.append(((y - ref).abs().max() / ref.abs().max()).item())
    n_tok = len(prompt) + max_new - 1
    worst = max(range(len(rels)), key=rels.__getitem__)
    log(f"[ssm-serve] {card}: {cfg.name}, each SSM layer's served outputs "
        f"(chunked prefill of {len(prompt)} tokens in chunks of 32, "
        f"{max_new - 1} decode steps) vs its no-cache chunked form on the "
        f"same inputs, {n_tok} tokens, {len(calls) // cfg.num_layers} calls "
        f"a layer: max|diff| / max|ref| at most {rels[worst]:.3e} (layer "
        f"{worst}; tol 5e-2), median {statistics.median(rels):.3e}")
    if len(calls) != cfg.num_layers * (len(calls) // cfg.num_layers) or \
            any(torch.cat(x).shape[0] != n_tok for x in xs) or \
            not all(math.isfinite(r) for r in rels) or max(rels) > 5e-2:
        raise AssertionError(f"{cfg.name}: served SSM layers disagree with "
                             f"their chunked form")


def phase_ssm_serve(torch, card):
    """The paged engine serves mamba2-370m (attention-free: K7 never runs)
    and hymba-1.5b (K7 on every layer, window 1024 on all but the last)
    at full width, depth cut (``SERVE_DEPTH``), bf16 weights with the SSM's A_log, D and dt_bias in f32;
    the prefix cache is off for both. Every SSM layer teacher forced
    against its chunked training form (``ssm_layers_teacher_forced``),
    and every K7 call of hymba's kernel engine against the gather path on
    the same operands (``K7InSitu``); end to end, hymba's kernel engine
    against its gather engine and mamba2's served logits against a
    no-cache forward are recorded beside each model's gain
    (``model_gain``): the random-weight models amplify rounding past the
    5e-2 serving bound."""
    import numpy as np

    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.serve import Request, ServeEngine, batch_variance_probe

    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend="paged")
    max_new = 16
    launches = 0
    check_serving_weights(torch, ("mamba2-370m", "hymba-1.5b"))
    for name in ("mamba2-370m", "hymba-1.5b"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = serving_config(name)
        t0 = time.perf_counter()
        params = serving_weights(torch, cfg)
        torch.cuda.synchronize()
        n_params, n_bytes = count_params(params)
        prompts = moe_serve_requests(np, cfg.vocab_size)
        if cfg.has_attention():
            # one prompt past the window: the local layers mask its head
            prompts.append(np.random.RandomState(3).randint(
                1, cfg.vocab_size, size=1200).tolist())
        s = cfg.ssm
        a = cfg.attention
        shape = (f"{depth_note(cfg)}, d {cfg.d_model}, SSM "
                 f"{s.num_heads(cfg.d_model)} heads of {s.head_dim}, state "
                 f"{s.state_dim}")
        if a is not None:
            shape += (f"; attention {a.num_heads} heads / {a.num_kv_heads} "
                      f"KV x {a.head_dim}, window {a.sliding_window}, "
                      f"global every {a.global_every}; d_ff {cfg.d_ff}")
        log(f"[ssm-serve] {name}: {shape}; vocab {cfg.vocab_size}; "
            f"{n_params} params ({n_params / 1e9:.4f} B) as served: "
            f"{n_bytes / 2**30:.3f} GiB (built layer by layer in "
            f"{time.perf_counter() - t0:.1f} s); trace "
            f"{[len(p) for p in prompts]} prompt tokens, {max_new} new")
        warm = ServeEngine(cfg, params, **geo)
        run_engine(torch, warm, prompts[1:2], 2)
        del warm
        eng = ServeEngine(cfg, params, **geo)
        kept = engine_logits(torch, eng)
        t_run = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        paged_decode_attend.launches = 0
        reqs, wall, decode_s = run_engine(torch, eng, prompts, max_new)
        k7 = paged_decode_attend.launches
        peak = torch.cuda.max_memory_allocated()
        done = all(r.done and r.finish_reason == "length" for r in reqs)
        want = eng.decode_steps * cfg.num_layers if cfg.has_attention() \
            else 0
        n_tok = sum(len(r.out) for r in reqs)
        be = eng.backend
        log(f"[ssm-serve] {name}: {len(reqs)} requests done={done}, "
            f"{eng.decode_steps} decode steps, {eng.preemptions} "
            f"preemptions; prefix cache {be.prefix} (off: SSM state is not "
            f"in the blocks); K7 launches {k7} (want {want})")
        log(f"[ssm-serve] {card}: {name} served (batch 8, max_len 2048, "
            f"block 16): {n_tok / wall:.1f} tok/s, decode step p50 "
            f"{statistics.median(decode_s) * 1e3:.2f} ms; peak device memory "
            f"{peak / 2**30:.3f} GiB; SSM rows {be.ssm_bytes() / 2**20:.3f} "
            f"MiB ({be.ssm_bytes()} bytes, {cfg.num_layers} layers x 8 "
            f"slots), KV {be.bytes_per_block()} bytes a block, "
            f"peak_cache_bytes {eng.peak_cache_bytes()}")
        if not done or be.prefix is not None or k7 != want or \
                (cfg.has_attention() and k7 == 0):
            raise AssertionError(f"{name} serving: unfinished requests, a "
                                 f"prefix cache, or K7 launches {k7} != "
                                 f"{want}")
        launches += k7
        t_checks = time.perf_counter()
        gain = model_gain(torch, cfg, prompts[0])
        if cfg.has_attention():
            # prefill in chunks of 256 here: fewer ticks, the same decode
            oracle = ServeEngine(cfg, params, use_kernel=False,
                                 prefill_chunk=256, **geo)
            with K7InSitu(torch) as calls:
                ticks = teacher_forced(
                    torch, ServeEngine(cfg, params, prefill_chunk=256, **geo),
                    oracle, prompts, max_new)
            rels = [d / r for _, d, _, r in ticks]
            rows = sum(len(t[0]) for t in ticks)
            agree = sum(t[2] for t in ticks)
            log(f"[ssm-serve] {card}: {name}, kernel vs gather engine, "
                f"teacher forced (recorded): {rows} row logits; max|diff| / "
                f"max|ref| at most {max(rels):.3e}, median "
                f"{statistics.median(rels):.3e}; identical greedy tokens "
                f"{agree}/{rows} = {agree / rows:.4f}; the f32 model moves "
                f"{gain:.1f}x a 1e-6 relative perturbation of its embedding")
            k7_in_situ_check(torch, card, name, calls)
            if not all(math.isfinite(r) for r in rels):
                raise AssertionError(f"{name}: non-finite served logits")
            del oracle
        else:
            ssm_served_logits(torch, card, cfg, params, reqs, kept, gain)
        ssm_layers_teacher_forced(torch, card, cfg, params, prompts[0],
                                  max_new)
        del eng, reqs, kept
        t_prof = time.perf_counter()
        prof_eng = ServeEngine(cfg, params, **geo)
        for pr in prompts:
            prof_eng.submit(Request(prompt=list(pr), max_new_tokens=max_new))
        for _ in range(5):
            prof_eng.step()
        # 3 ticks: reading back the profiler's events costs seconds a tick
        tick_profile(torch, prof_eng, 3, f"ssm serve {card}: {name}, 3 "
                     f"ticks (ticks 6-8 of the trace)")
        del prof_eng
        t_probe = time.perf_counter()
        res = batch_variance_probe(cfg, params, [1, 2, 3, 4], batch_size=4,
                                   max_new_tokens=8, max_len=64,
                                   backend="paged")
        top = sorted(res["per_stat"].items(), key=lambda kv: -kv[1])[:3]
        log(f"[ssm-serve] {card}: batch_variance_probe {name} (batch 4): "
            f"divergence {res['divergence']:.3e} over "
            f"{res['steps_compared']} steps; largest "
            + " ".join(f"{k}={v:.3e}" for k, v in top))
        if res["steps_compared"] == 0:
            raise AssertionError("the probe compared no decode step")
        log(f"[ssm-serve] {name}: wall seconds: served trace "
            f"{t_checks - t_run:.1f}, checks {t_prof - t_checks:.1f}, "
            f"profiled window {t_probe - t_prof:.1f}, probe "
            f"{time.perf_counter() - t_probe:.1f}")
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_decode_attend": launches}


# ---------------------------------------------------------------------------
# phase 18: mamba2-370m trained at full width and depth
# ---------------------------------------------------------------------------


def phase_ssm_train(torch, card):
    """mamba2-370m at full width and depth trained on batch 8 x 2048 of
    SyntheticLM through the remat path: 5 Trainer steps, no closing save,
    then one profiled step."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm_init, lm_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves
    from repro_torch.train import (
        Trainer,
        TrainerConfig,
        init_train_state,
        make_train_step,
    )

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("mamba2-370m")
    batch, seq = 8, 2048
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: lm_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       batch_size=batch, seed=0, device="cuda")
    log(f"[ssm-train] {cfg.name}: {cfg.num_layers} Mamba-2 layers, d "
        f"{cfg.d_model}, state {cfg.ssm.state_dim}, chunk "
        f"{cfg.ssm.chunk_size}, vocab {cfg.vocab_size}; scan_layers="
        f"{cfg.scan_layers} remat={cfg.remat}; {n_params} params "
        f"({n_params / 1e9:.4f} B); train state {state_bytes / 2**30:.3f} "
        f"GiB (init {time.perf_counter() - t0:.1f} s); compute {cfg.dtype}, "
        f"batch {batch} x {seq} tokens of SyntheticLM")
    ckpt_dir = ROOT / "build" / "chip_smoke_ssm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = 5
    trainer = Trainer(
        TrainerConfig(total_steps=n_steps, checkpoint_every=10**9,
                      checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
                      log_every=1),
        lambda p, b: lm_loss(p, cfg, b, telemetry=True), None,
        OptimizerConfig(), data)
    trainer.ckpt.save = lambda *a, **kw: None  # no closing save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.run(torch.Generator(device="cuda").manual_seed(0),
                        start_state=state)
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = trainer.metrics_history
    times = [m["step_time"] for m in hist]
    p50 = statistics.median(times)
    log(f"[ssm-train] {card}: {cfg.name} Trainer steps 0-{n_steps - 1} "
        f"(telemetry on, no closing save): step p50 {p50 * 1e3:.2f} ms (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{batch * seq / p50:.1f} tokens/s; loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f}); peak device memory "
        f"{peak / 2**30:.3f} GiB")
    if not all(math.isfinite(m["loss"]) for m in hist):
        raise AssertionError("the mamba2 loss is not finite")
    # where the time goes: one profiled step
    step = make_train_step(lambda p, b: lm_loss(p, cfg, b, telemetry=True),
                           OptimizerConfig())
    state, _, _ = profile_step(torch, step, state, data.batch(n_steps),
                               f"ssm train {card} ({cfg.name})")
    del state, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"p50": p50, "peak": peak}


# ---------------------------------------------------------------------------
# phase 19: the contiguous ring backend
# ---------------------------------------------------------------------------


def rel_errs(torch, got, want):
    """``rel_err`` of each pair: the card's tensors against the CPU's."""
    return [rel_err(torch, g.cpu(), w) for g, w in zip(got, want)]


def mla_ring_check(torch, card):
    """One MLA layer of deepseek-v2-lite at full width (random f32 weights)
    on a 512-slot ring, card against the host CPU: a whole-prompt prefill
    of 256 tokens on 2 rows, then 4 decode steps with row 1 inactive
    (position -1). Every call's live output and the ring within 1e-5 of
    max|ref|, ``pos`` equal, and the inactive row's ring bitwise as it was
    after the prefill on the card."""
    from repro_torch.configs import get_config
    from repro_torch.layers.attention import init_kv_cache, mla_apply, mla_init

    cfg = get_config("deepseek-v2-lite-16b")
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = mla_init(gen, cfg)
    n, n_dec = 256, 4
    x = torch.randn(2, n + n_dec, cfg.d_model, generator=gen, device="cuda")
    outs, rings, frozen = {}, {}, {}
    for dev in ("cuda", "cpu"):
        pd = {k: v.to(dev) for k, v in p.items()}
        xd = x.to(dev)
        ring = init_kv_cache(cfg, 2, 512, True, torch.float32, device=dev)
        with torch.no_grad():
            res = [mla_apply(pd, cfg, xd[:, :n],
                             positions=torch.arange(n, device=dev),
                             cache=ring, mode="prefill")[0]]
            kept = {k: v[1].clone() for k, v in ring.items()}
            for t in range(n, n + n_dec):
                pos = torch.tensor([[t], [-1]], dtype=torch.int32,
                                   device=dev)
                res.append(mla_apply(pd, cfg, xd[:, t:t + 1], positions=pos,
                                     cache=ring, mode="decode")[0][:1])
        frozen[dev] = all(torch.equal(ring[k][1], kept[k]) for k in ring)
        outs[dev] = [r.cpu() for r in res]
        rings[dev] = {k: v.cpu() for k, v in ring.items()}
    errs = rel_errs(torch, outs["cuda"], outs["cpu"])
    ring_errs = rel_errs(torch, [rings["cuda"][k] for k in ("ckv", "krope")],
                          [rings["cpu"][k] for k in ("ckv", "krope")])
    pos_equal = torch.equal(rings["cuda"]["pos"], rings["cpu"]["pos"])
    log(f"[contig] {card}: one MLA layer of {cfg.name} (d {cfg.d_model}, "
        f"{cfg.attention.num_heads} heads, rank "
        f"{cfg.attention.kv_lora_rank}) on a 512-slot ring in f32, card vs "
        f"host CPU, max|diff| / max|ref| (tol 1e-5): prefill of {n} "
        f"{errs[0]:.3e}; decode steps "
        + " ".join(f"{e:.3e}" for e in errs[1:])
        + f"; ring ckv {ring_errs[0]:.3e} krope {ring_errs[1]:.3e}, pos "
        f"equal {pos_equal}; inactive row bitwise unchanged on the card "
        f"{frozen['cuda']}")
    if max(errs + ring_errs) > 1e-5 or not pos_equal or not frozen["cuda"]:
        raise AssertionError("the MLA ring layer on the card disagrees with "
                             "the CPU")


def phase_contiguous_serve(torch, card):
    """The contiguous ring backend (``ServeEngine``'s default) at full width,
    depth cut (``SERVE_DEPTH``): qwen2-0.5b over phase 7's trace beside the paged gather
    engine (K7 never launches on the ring: attention gathers it, as in the
    reference), teacher forced within 5e-2 of max|ref|; hymba-1.5b in f32
    over phase 17's trace, teacher forced within 1e-4: its 8 short prompts
    against the paged gather engine, the 1200-token prompt that wraps the
    local layers' 1024-slot rings against the host CPU (its distance from
    the paged engine recorded); one MLA layer on the ring, card vs CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.models import lm_init
    from repro_torch.optim import tree_map
    from repro_torch.serve import (
        ContiguousBackend,
        Request,
        ServeEngine,
        batch_variance_probe,
    )

    gc.collect()
    torch.cuda.empty_cache()
    cfg = serving_config("qwen2-0.5b")
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    geo = dict(batch_size=8, max_len=2048, device="cuda")
    paged = dict(backend="paged", use_kernel=False, block_size=16)
    prompts = make_requests(np, cfg.vocab_size)
    max_new = 32
    warm = ServeEngine(cfg, params, **geo)
    run_engine(torch, warm, prompts[1:3], 4)
    del warm
    runs = {}
    for name, kw in (("contiguous", {}), ("paged gather", paged)):
        eng = ServeEngine(cfg, params, prefill_chunk=256, **kw, **geo)
        torch.cuda.reset_peak_memory_stats()
        paged_decode_attend.launches = 0
        reqs, wall, decode_s = run_engine(torch, eng, prompts, max_new)
        runs[name] = (eng, reqs, wall, decode_s, paged_decode_attend.launches,
                      torch.cuda.max_memory_allocated())
    eng, reqs = runs["contiguous"][:2]
    done = all(r.done and r.finish_reason == "length"
               for run in runs.values() for r in run[1])
    k7 = runs["contiguous"][4]
    log(f"[contig] {cfg.name} ({depth_note(cfg)}): backend "
        f"{type(eng.backend).__name__}, "
        f"{len(reqs)} requests done={done}, {eng.decode_steps} decode "
        f"steps, {eng.ticks} ticks; K7 launches {k7} (want 0); ring "
        f"{eng.backend.max_chunk} slots a layer")
    for name, (e, rs, wall, decode_s, _, peak) in runs.items():
        n_tok = sum(len(r.out) for r in rs)
        log(f"[contig] {card}: {cfg.name} {name} engine (batch 8, max_len "
            f"2048): {n_tok / wall:.1f} tok/s, decode step p50 "
            f"{statistics.median(decode_s) * 1e3:.2f} ms, peak_cache_bytes "
            f"{e.peak_cache_bytes()}, peak device memory "
            f"{peak / 2**30:.3f} GiB")
    if not done or k7 != 0 or not isinstance(eng.backend, ContiguousBackend):
        raise AssertionError("contiguous serving: unfinished requests or a "
                             "K7 launch")
    if eng.peak_cache_bytes() != 8 * 2048 * cfg.num_layers * (
            2 * cfg.attention.num_kv_heads * cfg.attention.head_dim * 2 + 4):
        raise AssertionError("the contiguous pool is not 8 x 2048 positions")
    del runs, eng, reqs
    # teacher forced against the paged gather engine (no prefix cache: the
    # same chunks, so the same schedule), prefill in chunks of 256
    ticks = teacher_forced(
        torch, ServeEngine(cfg, params, prefill_chunk=256, **geo),
        ServeEngine(cfg, params, prefill_chunk=256, prefix_cache=False,
                    **paged, **geo), prompts, max_new)
    rels = [d / r for _, d, _, r in ticks]
    rows = sum(len(t[0]) for t in ticks)
    agree = sum(t[2] for t in ticks)
    log(f"[contig] {card}: {cfg.name} contiguous vs paged gather engine, "
        f"teacher forced: {rows} row logits; max|diff| / max|ref| at most "
        f"{max(rels):.3e} (tol 5e-2), median {statistics.median(rels):.3e}; "
        f"identical greedy tokens {agree}/{rows} = {agree / rows:.4f}")
    if not all(math.isfinite(r) for r in rels) or max(rels) > 5e-2:
        raise AssertionError("the contiguous engine's logits disagree with "
                             "the paged engine's")
    prof_eng = ServeEngine(cfg, params, **geo)
    for pr in prompts:
        prof_eng.submit(Request(prompt=list(pr), max_new_tokens=max_new))
    for _ in range(20):
        prof_eng.step()
    tick_profile(torch, prof_eng, 3, f"contiguous serve {card}: "
                 f"{cfg.name}, 3 ticks (ticks 21-23 of the trace)")
    del prof_eng
    res = batch_variance_probe(cfg, params, [1, 2, 3, 4], batch_size=4,
                               max_new_tokens=8, max_len=64)
    top = sorted(res["per_stat"].items(), key=lambda kv: -kv[1])[:3]
    log(f"[contig] {card}: batch_variance_probe {cfg.name} on the "
        f"contiguous backend (batch 4): divergence {res['divergence']:.3e} "
        f"over {res['steps_compared']} steps; largest "
        + " ".join(f"{k}={v:.3e}" for k, v in top))
    if res["steps_compared"] == 0:
        raise AssertionError("the probe compared no decode step")
    if not res["divergence"] < PROBE_LIMIT:
        raise AssertionError(f"batch_variance_probe {cfg.name} on the "
                             f"contiguous backend reads "
                             f"{res['divergence']:.3e} >= {PROBE_LIMIT:g}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # hymba-1.5b in f32. Its local layers' rings hold 1024 slots (the
    # window); the 1200-token prompt wraps them, in chunks of 32. A chunk
    # written over a full ring overwrites keys that its first queries'
    # windows still cover, so those queries attend fewer keys than the
    # window: the reference's ring semantics, which the paged pool (every
    # position kept) does not share. So the 8 prompts of 16-256 tokens are
    # held against the paged gather engine, the wrapping one against the
    # same contiguous engine on the host CPU, and its distance from the
    # paged engine is recorded.
    hcfg = dataclasses.replace(serving_config("hymba-1.5b"), dtype="float32")
    hparams = serving_weights(torch, hcfg)
    short = moe_serve_requests(np, hcfg.vocab_size)
    long_prompt = [np.random.RandomState(3).randint(
        1, hcfg.vocab_size, size=1200).tolist()]
    geo32 = dict(geo, cache_dtype=torch.float32)
    gather = dict(paged, prefix_cache=False)
    results = {}
    paged_decode_attend.launches = 0
    for label, prompts_h, other, odev in (
            ("short prompts vs paged gather", short, gather, "cuda"),
            ("1200-token prompt vs host CPU", long_prompt, {}, "cpu"),
            ("1200-token prompt vs paged gather", long_prompt, gather,
             "cuda")):
        cont = ServeEngine(hcfg, hparams, **geo32)
        chunk = cont.sched.prefill_chunk  # the default, min(32, ring)
        oparams = hparams if odev == "cuda" else tree_map(
            lambda t: t.cpu(), hparams)
        oracle = ServeEngine(hcfg, oparams, prefill_chunk=chunk, **other,
                             **dict(geo32, device=odev))
        t0 = time.perf_counter()
        ticks = teacher_forced(torch, cont, oracle, prompts_h, 16)
        rels = [d / r for _, d, _, r in ticks]
        rows = sum(len(t[0]) for t in ticks)
        agree = sum(t[2] for t in ticks)
        results[label] = max(rels)
        ring_lens = sorted({layer["attn"]["pos"].shape[1]
                            for layer in cont.backend.pool.cache})
        log(f"[contig] {card}: {hcfg.name} in f32, contiguous engine (rings "
            f"{ring_lens} slots, prefill chunks of {chunk}), {label}, "
            f"teacher forced (prompts {[len(p) for p in prompts_h]}): "
            f"{rows} row logits; max|diff| / max|ref| at most "
            f"{max(rels):.3e}, median {statistics.median(rels):.3e}; "
            f"identical greedy tokens {agree}/{rows} = {agree / rows:.4f} "
            f"({time.perf_counter() - t0:.1f} s, {depth_note(hcfg)})")
        del cont, oracle, oparams
    k7 = paged_decode_attend.launches
    del hparams
    gc.collect()
    torch.cuda.empty_cache()
    gain = model_gain(torch, hcfg, short[0])
    log(f"[contig] {card}: {hcfg.name}: K7 launches {k7} (want 0); the f32 "
        f"model moves {gain:.1f}x a 1e-6 relative perturbation of its "
        f"embedding; held within 1e-4: "
        f"{results['short prompts vs paged gather']:.3e} (short prompts vs "
        f"paged), {results['1200-token prompt vs host CPU']:.3e} (wrapping "
        f"prompt, card vs CPU); recorded: "
        f"{results['1200-token prompt vs paged gather']:.3e} (wrapping "
        f"prompt vs paged)")
    held = ("short prompts vs paged gather", "1200-token prompt vs host CPU")
    if k7 != 0 or chunk != 32 or ring_lens[0] != 1024 or \
            not all(results[k] <= 1e-4 for k in held) or \
            not all(math.isfinite(v) for v in results.values()):
        raise AssertionError("hymba on the contiguous engine disagrees with "
                             "its oracles")
    mla_ring_check(torch, card)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 20-21: seamless-m4t-large-v2, the encoder-decoder
# ---------------------------------------------------------------------------


def encdec_serving_weights(torch, params):
    """Every weight cast to bf16 once, but the embedding tables, which the
    unembed reads in f32 (as ``serve.engine.serving_params`` keeps
    them)."""
    def cast(tree, key=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree if key == "table" else tree.to(torch.bfloat16)

    return cast(params)


def seamless_layers_check(torch, card, cfg, enc_p, dec_p):
    """Encoder layer 0 and decoder block 0 in f32 on the card against the
    host CPU, within 1e-5 of max|ref|: the encoder block (non-causal) over
    512 frames; the decoder block (self-attention on a 32-slot ring plus
    cross-attention on K/V cached from a 512-frame encoder output): a
    whole-prompt prefill of 16 tokens, then 4 decode steps."""
    import dataclasses

    from repro_torch.layers.attention import init_kv_cache
    from repro_torch.layers.common import norm_apply
    from repro_torch.models.encdec import _enc_cfg, cross_attn_apply, cross_kv
    from repro_torch.models.lm import block_apply
    from repro_torch.optim import tree_map

    f32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(6)
    x_enc = torch.randn(1, 512, cfg.d_model, generator=gen, device="cuda")
    enc_out = torch.randn(1, 512, cfg.d_model, generator=gen, device="cuda")
    x_dec = torch.randn(1, 20, cfg.d_model, generator=gen, device="cuda")
    outs, rings = {}, {}
    for dev in ("cuda", "cpu"):
        ep = tree_map(lambda t: t.to(dev), enc_p)
        dp = tree_map(lambda t: t.to(dev), dec_p)
        cache = {"attn": init_kv_cache(f32, 1, 32, True, torch.float32,
                                       device=dev)}
        with torch.no_grad():
            res = [block_apply(ep, _enc_cfg(f32), x_enc.to(dev),
                               mode="train")[0]]
            kv = cross_kv(dp["cross"], f32, enc_out.to(dev))
            calls = [(0, 16, "prefill")] + [(t, t + 1, "decode")
                                              for t in range(16, 20)]
            for a, b, mode in calls:
                y = block_apply(dp["self"], f32, x_dec[:, a:b].to(dev),
                                positions=torch.arange(a, b, device=dev),
                                cache=cache, mode=mode)[0]
                xn = norm_apply(dp["cross_norm"], f32, y)
                res.append(y + cross_attn_apply(dp["cross"], f32, xn, kv))
        outs[dev] = [r.cpu() for r in res]
        rings[dev] = {k: v.cpu() for k, v in cache["attn"].items()}
    errs = rel_errs(torch, outs["cuda"], outs["cpu"])
    ring_errs = rel_errs(torch, [rings["cuda"]["k"], rings["cuda"]["v"]],
                          [rings["cpu"]["k"], rings["cpu"]["v"]])
    pos_equal = torch.equal(rings["cuda"]["pos"], rings["cpu"]["pos"])
    log(f"[seamless] {card}: f32 layers card vs host CPU, max|diff| / "
        f"max|ref| (tol 1e-5): encoder layer 0 over 512 frames "
        f"{errs[0]:.3e}; decoder block 0 (ring self-attention + cached "
        f"cross K/V): prefill of 16 {errs[1]:.3e}, decode steps "
        + " ".join(f"{e:.3e}" for e in errs[2:])
        + f"; ring k {ring_errs[0]:.3e} v {ring_errs[1]:.3e}, pos equal "
        f"{pos_equal}")
    if max(errs + ring_errs) > 1e-5 or not pos_equal:
        raise AssertionError("a seamless layer on the card disagrees with "
                             "the CPU")


def phase_seamless_serve(torch, card):
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers), bf16 serving weights: encode 4 rows of 512 x 1024
    frames, prefill a 16-token decoder prompt whole, then 32 greedy decode
    steps through ``init_encdec_cache``; the decoded logits against a
    teacher-forced full forward within 5e-2 of max|ref|; one encoder and
    one decoder layer card vs CPU in f32; none of K1-K7 launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
        routing_health,
    )
    from repro_torch.models import encdec_apply, encdec_init
    from repro_torch.models import init_encdec_cache
    from repro_torch.models.encdec import encode
    from repro_torch.optim import tree_map

    kernels = (paged_decode_attend, routing_fwd, combine_apply,
               combine_online, dispatch_bwd, combine_bwd, routing_health)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("seamless-m4t-large-v2")
    a, fe = cfg.attention, cfg.frontend
    t0 = time.perf_counter()
    full = encdec_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params, _ = count_params(full)
    enc_p = tree_map(lambda t: t.clone(), full["enc_layers"][0])
    dec_p = tree_map(lambda t: t.clone(), full["dec_blocks"][0])
    params = encdec_serving_weights(torch, full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _, n_bytes = count_params(params)
    log(f"[seamless] {cfg.name}: {cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, {a.num_heads} heads of {a.head_dim}, {cfg.norm}, "
        f"{cfg.act}, vocab {cfg.vocab_size}, audio frontend {fe.embed_dim} "
        f"-> {cfg.d_model}; {n_params} params ({n_params / 1e9:.4f} B), "
        f"{n_bytes / 2**30:.3f} GiB as served (bf16 but the f32 embedding "
        f"tables; init and cast {time.perf_counter() - t0:.1f} s)")
    seamless_layers_check(torch, card, cfg, enc_p, dec_p)
    del enc_p, dec_p

    b, t_frames, p_len, n_new = 4, 512, 16, 32
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn(b, t_frames, fe.embed_dim, generator=gen,
                         device="cuda")
    prompt = torch.randint(1, cfg.vocab_size, (b, p_len), generator=gen,
                           device="cuda")
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        enc_s = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc_out, _ = encode(params, cfg, frames)
            torch.cuda.synchronize()
            enc_s.append(time.perf_counter() - t0)
        cache = init_encdec_cache(cfg, b, p_len + n_new + 1, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, (_, cache), _ = encdec_apply(
            params, cfg, prompt, None,
            positions=torch.arange(p_len, device="cuda"), cache=cache,
            enc_out=enc_out, mode="prefill")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        logits, toks, step_s = [lp[:, -1]], [lp[:, -1].argmax(-1)], []
        for t in range(p_len, p_len + n_new):
            t0 = time.perf_counter()
            lt, (_, cache), _ = encdec_apply(
                params, cfg, toks[-1][:, None], None,
                positions=torch.arange(t, t + 1, device="cuda"),
                cache=cache, enc_out=enc_out, mode="decode")
            toks.append(lt[:, 0].argmax(-1))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            logits.append(lt[:, 0])
        peak = torch.cuda.max_memory_allocated()
        launches = [k.launches for k in kernels]
        # one more decode step under the profiler
        t = p_len + n_new
        last = toks[-1][:, None]
        prof = types.SimpleNamespace(step=lambda: encdec_apply(
            params, cfg, last, None,
            positions=torch.arange(t, t + 1, device="cuda"), cache=cache,
            enc_out=enc_out, mode="decode"))
        busy = tick_profile(torch, prof, 1, f"seamless serve {card}: one "
                            f"decode step (batch {b})")
        # teacher forced: the full forward over the prompt and the tokens
        # the decode fed itself
        seq = torch.cat([prompt, torch.stack(toks[:n_new], 1)], 1)
        ref = encdec_apply(params, cfg, seq, frames)[0][:, p_len - 1:]
        dec = torch.stack(logits, 1)
        rel = ((dec - ref).abs().max() / ref.abs().max()).item()
        agree = (dec.argmax(-1) == ref.argmax(-1)).float().mean().item()
    n_tok = b * n_new
    log(f"[seamless] {card}: encode of {b} x {t_frames} frames p50 "
        f"{statistics.median(enc_s[1:]) * 1e3:.2f} ms (first "
        f"{enc_s[0] * 1e3:.2f}); whole-prompt prefill of {p_len} tokens "
        f"{prefill_s * 1e3:.2f} ms; {n_new} greedy decode steps: p50 "
        f"{statistics.median(step_s) * 1e3:.2f} ms, {n_tok / sum(step_s):.1f} "
        f"tok/s; peak device memory {peak / 2**30:.3f} GiB; profiled step "
        f"busy {busy:.3f}; launches K7, K1-K6 {launches} (want all 0)")
    log(f"[seamless] {card}: decoded logits vs the teacher-forced full "
        f"forward ({b} rows x {n_new + 1} positions): max|diff| / max|ref| "
        f"{rel:.3e} (tol 5e-2); identical greedy tokens {agree:.4f}; "
        f"logits shape {tuple(dec.shape)}, finite "
        f"{bool(torch.isfinite(dec).all())}")
    if any(launches) or not rel <= 5e-2 or \
            dec.shape != (b, n_new + 1, cfg.vocab_size) or \
            not torch.isfinite(dec).all():
        raise AssertionError("seamless serving failed: a kernel launch, or "
                             "decoded logits off the full forward")
    del params, cache, enc_out, ref, dec
    gc.collect()
    torch.cuda.empty_cache()


def phase_seamless_train(torch, card):
    """seamless-m4t-large-v2 at full width and depth trained 5 Trainer steps
    on ``SyntheticSeq2Seq`` (batch 4 x 512 tokens, 512 frames of 1024;
    f32 weights and AdamW moments, bf16 compute, the encoder under remat
    as configured; no closing save), then one profiled step."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticSeq2Seq
    from repro_torch.models import encdec_init, encdec_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves
    from repro_torch.train import (
        Trainer,
        TrainerConfig,
        init_train_state,
        make_train_step,
    )

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("seamless-m4t-large-v2")
    batch, seq, n_frames = 4, 512, 512
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: encdec_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    data = SyntheticSeq2Seq(vocab_size=cfg.vocab_size, seq_len=seq,
                            num_frames=n_frames,
                            frame_dim=cfg.frontend.embed_dim,
                            batch_size=batch, seed=0, device="cuda")
    log(f"[seamless-train] {cfg.name}: {n_params} params "
        f"({n_params / 1e9:.4f} B); train state {state_bytes / 2**30:.3f} "
        f"GiB (init {time.perf_counter() - t0:.1f} s); remat={cfg.remat}; "
        f"compute {cfg.dtype}; batch {batch} x {seq} tokens, {n_frames} "
        f"frames of {cfg.frontend.embed_dim} (SyntheticSeq2Seq)")
    ckpt_dir = ROOT / "build" / "chip_smoke_seamless_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = 5
    trainer = Trainer(
        TrainerConfig(total_steps=n_steps, checkpoint_every=10**9,
                      checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
                      log_every=1),
        lambda p, b: encdec_loss(p, cfg, b), None, OptimizerConfig(), data)
    trainer.ckpt.save = lambda *a, **kw: None  # no closing save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.run(torch.Generator(device="cuda").manual_seed(0),
                        start_state=state)
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = trainer.metrics_history
    times = [m["step_time"] for m in hist]
    p50 = statistics.median(times)
    ln_v = math.log(cfg.vocab_size)
    log(f"[seamless-train] {card}: Trainer steps 0-{n_steps - 1} (no "
        f"closing save): step p50 {p50 * 1e3:.2f} ms (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{batch * seq / p50:.1f} tokens/s; loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f} (ln {cfg.vocab_size} = {ln_v:.4f}); peak "
        f"device memory {peak / 2**30:.3f} GiB")
    if not all(math.isfinite(m["loss"]) for m in hist) or \
            abs(hist[0]["loss"] - ln_v) > 1.0:
        raise AssertionError("the seamless loss is not finite near ln V")
    step = make_train_step(lambda p, b: encdec_loss(p, cfg, b),
                           OptimizerConfig())
    state, _, _ = profile_step(torch, step, state, data.batch(n_steps),
                               f"seamless train {card} ({cfg.name})")
    del state, trainer, step
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 22: the serving stack (server, speculative decoding, chaos)
# ---------------------------------------------------------------------------

# The keys of the reference engine's tick record
# (src/repro/serve/engine.py, ServeEngine.step) on the paged backend.
RECORD_KEYS = {"tick", "t", "wall_s", "queued", "live", "decode_rows",
               "admitted", "prefilled", "emitted", "kernel_fallbacks",
               "jit_cache_sizes", "programs", "blocks_free", "blocks_used",
               "blocks_live", "slots_free", "slots_total"}

def spec_prompts(np, vocab, seed=3):
    """8 prompts of a random 12..24-token motif repeated 3..6 times (the
    n-gram drafter's home ground), then a few random tokens."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(8):
        motif = rng.randint(1, vocab, size=rng.randint(12, 25)).tolist()
        out.append(motif * rng.randint(3, 7)
                   + rng.randint(1, vocab, size=3).tolist())
    return out


class LogitTap:
    """Record an engine's decode logits (the plain engine) or hold its
    verify logits against them (the speculative engine), keyed by
    (request, position of the token consumed). The verify engine drafts
    the plain stream (``OracleDrafter``); a verify lane is compared only
    where its whole context is the plain stream (the committed tokens and
    the lanes up to it), so each compared lane is teacher forced on it.
    Once the speculative engine commits a token the plain engine did not,
    that row's later lanes are not compared."""

    def __init__(self, torch):
        self.torch = torch
        self.ref = {}  # (req index, pos) -> plain logits row
        self.margin = {}  # (req index, pos) -> top-2 margin of that row
        self.diffs = []  # (max |verify - decode|, max |decode|) per lane
        self.streams = None  # the plain engine's prompt + output per req

    def wrap(self, eng, phase, index):
        inner = getattr(eng.backend, phase)

        def call(params, toks, pos):
            out = inner(params, toks, pos)
            rows = {s: (index[id(e.req)], e.req.prompt + e.req.out)
                    for s, e in eng.sched.live.items()}
            p = pos.reshape(pos.shape[0], -1).cpu().numpy()
            t = toks.reshape(toks.shape[0], -1).cpu().numpy()
            for slot, (r, ctx) in rows.items():
                forced = phase == "decode" or (
                    self.streams[r][:len(ctx)] == ctx)
                for j in range(p.shape[1]):
                    if p[slot, j] < 0:
                        continue
                    q = int(p[slot, j])
                    if phase == "verify":
                        forced = forced and (
                            q < len(self.streams[r])
                            and int(t[slot, j]) == self.streams[r][q])
                        if not forced:
                            break
                    key = (r, q)
                    row = out[slot, j].float()
                    if phase == "decode":
                        self.ref[key] = row
                        top = self.torch.topk(row, 2).values.cpu()
                        self.margin[key] = float(top[0] - top[1])
                    elif key in self.ref:
                        want = self.ref[key]
                        self.diffs.append((
                            (row - want).abs().max().item(),
                            want.abs().max().item()))
            return out

        setattr(eng.backend, phase, call)


class OracleDrafter:
    """Drafts the plain engine's own continuation where the context is a
    prefix of a plain stream (teacher forcing for the verify lanes)."""

    def __init__(self, streams):
        self.streams = streams

    def propose(self, context, k):
        for s in self.streams:
            if s[:len(context)] == list(context):
                return s[len(context):len(context) + k]
        return []


def spec_compare(torch, np, cfg, params, card, backend, dtype):
    """One backend, one dtype: the plain engine, the speculative engine
    teacher forced on the plain stream, and the speculative engine with
    the n-gram drafter, over ``spec_prompts``. Returns the summary."""
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.serve import (
        Request,
        ServeEngine,
        SpecConfig,
        assert_leak_free,
    )

    # whole prompts in one chunk: the comparison is about decode
    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend=backend, cache_dtype=dtype, prefill_chunk=256)
    prompts = spec_prompts(np, cfg.vocab_size)
    max_new = 32
    tap = LogitTap(torch)

    def drive(eng, phase=None):
        """Serve the prompts; the timing wrapper goes on first, so the tap
        (outside it) is not timed."""
        reqs = [Request(prompt=list(p), max_new_tokens=max_new)
                for p in prompts]
        step_s = timed_method(torch, eng.backend,
                              "verify" if eng._spec else "decode")
        if phase:
            tap.wrap(eng, phase, {id(r): i for i, r in enumerate(reqs)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(r.done and r.finish_reason == "length" for r in reqs):
            raise AssertionError("a request did not finish with 'length'")
        return [r.out for r in reqs], wall, step_s

    plain = ServeEngine(cfg, params, **geo)
    l0 = paged_decode_attend.launches
    want, pwall, pstep = drive(plain, "decode")
    if backend == "paged" and (paged_decode_attend.launches - l0
                               != plain.decode_steps * cfg.num_layers):
        raise AssertionError("K7 launches != decode model calls x layers")
    streams = [list(p) + o for p, o in zip(prompts, want)]
    tap.streams = streams
    oracle = ServeEngine(cfg, params, spec=SpecConfig(
        k=4, drafter=OracleDrafter(streams), disable_after_rejects=0), **geo)
    drive(oracle, "verify")
    spec = ServeEngine(cfg, params, spec=SpecConfig(k=4), **geo)
    l0 = paged_decode_attend.launches
    out, swall, sstep = drive(spec)
    if paged_decode_attend.launches != l0:
        raise AssertionError("the speculative engine launched K7")
    assert_leak_free(spec)
    n_tok = sum(len(o) for o in want)
    equal = sum(a == b for o, w in zip(out, want) for a, b in zip(o, w))
    dist = max(d for d, _ in tap.diffs)
    rel = max(d / r for d, r in tap.diffs)
    st = spec.spec_stats()
    res = {"equal": equal / n_tok, "dist": dist, "rel": rel,
           "lanes": len(tap.diffs), "accept": st["acceptance_rate"],
           "calls_per_token": st["calls_per_token"],
           "plain_p50": statistics.median(pstep) * 1e3,
           "spec_p50": statistics.median(sstep) * 1e3,
           "plain_tok_s": n_tok / pwall, "spec_tok_s": n_tok / swall,
           "plain_calls": plain.decode_steps, "spec_calls": spec.decode_steps}
    first = None
    if dtype == torch.float32:
        # greedy tokens must agree up to the first step whose top-2
        # margin is below the measured verify-vs-decode distance
        for r, (o, w) in enumerate(zip(out, want)):
            p = len(prompts[r])
            for s in range(1, max_new):
                m = tap.margin.get((r, p + s - 1))
                if m is not None and m < dist:
                    first = min(first or s, s)
                    break
                if o[s] != w[s] or o[0] != w[0]:
                    raise AssertionError(
                        f"f32 speculative token differs at request {r} "
                        f"step {s}, margin {m} >= distance {dist}")
        res["first_close_step"] = first
    elif rel > 5e-2:
        raise AssertionError(f"verify logits {rel:.3e} of max|ref| from the "
                             "decode logits (tol 5e-2)")
    log(f"[stack] spec {backend} {str(dtype)[6:]} ({card}): {res['lanes']} "
        f"verify lanes teacher forced on the plain stream, max_abs_diff "
        f"{dist:.3e}, max|diff|/max|ref| {rel:.3e}; greedy tokens equal "
        f"{equal}/{n_tok} = {res['equal']:.4f}"
        + (f"; first step with top-2 margin < distance: {first}"
           if dtype == torch.float32 else "")
        + f"; acceptance {st['acceptance_rate']:.4f}, {st['verify_calls']} "
        f"verify calls for {st['tokens_emitted']} tokens (calls/token "
        f"{st['calls_per_token']:.4f} batched), plain {plain.decode_steps} "
        f"decode calls; step p50 verify {res['spec_p50']:.2f} ms vs decode "
        f"{res['plain_p50']:.2f} ms; {res['spec_tok_s']:.1f} vs "
        f"{res['plain_tok_s']:.1f} tok/s; K7 0 on the speculative engine, "
        f"pool leak-free")
    return res


async def http_get(host, port, path):
    import asyncio

    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: _\r\n\r\n".encode("ascii"))
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode("utf-8")


def serve_through_server(torch, eng, prompts, max_new):
    """Serve ``prompts`` through an ``AsyncServer`` over ``eng``: even
    requests by ``generate``, odd ones by ``submit`` + ``stream``, all
    concurrent; then scrape /metrics and /healthz over the server's HTTP
    socket. Returns (requests in prompt order, streamed tokens, wall s,
    /metrics text, /healthz status and body)."""
    import asyncio

    from repro_torch.serve import AsyncServer, ServerConfig

    seen = []
    submit = eng.submit

    def record(req):
        seen.append(req)
        submit(req)

    eng.submit = record

    async def one(srv, i, p):
        toks = []
        if i % 2 == 0:
            async for t in srv.generate(p, max_new_tokens=max_new):
                toks.append(t)
        else:
            req = await srv.submit(p, max_new_tokens=max_new)
            async for t in srv.stream(req):
                toks.append(t)
        return toks

    async def go():
        scfg = ServerConfig(metrics_port=0, max_queue=len(prompts))
        async with AsyncServer(eng, scfg) as srv:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streamed = await asyncio.gather(
                *[one(srv, i, list(p)) for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            host, port = srv.metrics_addr
            metrics = await http_get(host, port, "/metrics")
            health = await http_get(host, port, "/healthz")
        return streamed, wall, metrics, health

    streamed, wall, metrics, health = asyncio.run(go())
    eng.submit = submit
    by_prompt = {tuple(r.prompt): r for r in seen}
    return ([by_prompt[tuple(p)] for p in prompts], streamed, wall,
            metrics, health)


def tracing_cost(torch, eng, prompts, max_new):
    """The tracer's cost: the same direct drive of ``eng`` with span
    tracing off and on in turns (off, on, on, off). The spans are host
    work in the tick, so each whole tick is timed (synchronised), and only
    decode ticks (every live row decoding, none queued) are kept. Returns
    the tick p50 off and on, in seconds, and the ticks kept of each."""
    from repro_torch.serve import Request
    from repro_torch.serve.tracing import Tracer

    ticks = {False: [], True: []}
    for on in (False, True, True, False):
        eng.tracer = Tracer() if on else None
        reqs = [Request(prompt=list(p), max_new_tokens=max_new)
                for p in prompts]
        for r in reqs:
            eng.submit(r)
        while eng.sched.pending():
            decode = not eng.sched.queue and all(
                e.state == "decode" for e in eng.sched.live.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if decode:
                ticks[on].append(time.perf_counter() - t0)
    eng.tracer = None
    return (statistics.median(ticks[False]), statistics.median(ticks[True]),
            len(ticks[False]), len(ticks[True]))


def phase_serving_stack(torch, card):
    import dataclasses

    import numpy as np

    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.models import lm_init
    from repro_torch.serve import (
        GarbageDrafter,
        Request,
        ServeEngine,
        SpecConfig,
        parse_prometheus,
        run_chaos,
        validate_timeline,
    )

    cfg = serving_config("qwen2-0.5b")
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    L = cfg.num_layers
    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda",
               backend="paged")
    prompts = make_requests(np, cfg.vocab_size)
    max_new = 32
    # the server's trace prefills in chunks of 256: the checks are about
    # the stack around the engine, and the time limit is shared
    sgeo = dict(geo, prefill_chunk=256)
    paged_decode_attend.launches = 0
    k7 = 0  # launches counted against each kernel engine's model calls

    def count(eng, l0):
        n = paged_decode_attend.launches - l0
        if n != eng.decode_steps * L or n == 0:
            raise AssertionError(f"K7 launches {n} != decode model calls "
                                 f"{eng.decode_steps} x {L}")
        return n

    warm = ServeEngine(cfg, params, **geo)
    run_engine(torch, warm, prompts[1:3], 4)
    k7 += count(warm, 0)
    del warm

    # a. the server over the traced kernel engine, against the same engine
    # driven directly with tracing off
    direct = ServeEngine(cfg, params, **sgeo)
    l0 = paged_decode_attend.launches
    dreqs, dwall, ddec = run_engine(torch, direct, prompts, max_new)
    k7 += count(direct, l0)
    eng = ServeEngine(cfg, params, trace=True, flight_recorder=256, **sgeo)
    l0 = paged_decode_attend.launches
    reqs, streamed, wall, metrics, health = serve_through_server(
        torch, eng, prompts, max_new)
    k7 += count(eng, l0)
    if not all(r.done and r.finish_reason == "length" for r in reqs):
        raise AssertionError("a served request did not finish")
    if [r.out for r in reqs] != streamed:
        raise AssertionError("streamed tokens differ from the final tokens")
    if [r.out for r in reqs] != [r.out for r in dreqs]:
        raise AssertionError("the server's tokens differ from the engine "
                             "driven directly with tracing off")
    for r in reqs:
        validate_timeline(r)
    status, body = metrics
    parsed = parse_prometheus(body)
    c = parsed["counters"]
    if status != 200 or c["repro_serve_completed_total"] != len(prompts):
        raise AssertionError(f"/metrics: status {status}, counters {c}")
    hstatus, hbody = health
    if hstatus != 200 or json.loads(hbody)["status"] != "ok":
        raise AssertionError(f"/healthz: {hstatus} {hbody}")
    dump = eng.recorder.dump("chip_smoke")
    keys = set(dump["records"][-1])
    if keys != RECORD_KEYS:
        raise AssertionError(f"tick record keys {sorted(keys)}")
    n_tok = sum(len(r.out) for r in reqs)
    spans = sum(len(r.spans) for r in reqs)
    l0 = paged_decode_attend.launches
    steps0 = direct.decode_steps
    off, on, n_off, n_on = tracing_cost(torch, direct, prompts[:8], 24)
    n = paged_decode_attend.launches - l0
    if n != (direct.decode_steps - steps0) * L:
        raise AssertionError("K7 launches != decode model calls x layers")
    k7 += n
    log(f"[stack] server ({card}): {len(reqs)} requests (8 by generate, 8 "
        f"by submit + stream, concurrent) bitwise equal to the engine "
        f"driven directly with tracing off, streams equal to the final "
        f"tokens, {spans} spans, every timeline valid; {n_tok / wall:.1f} "
        f"tok/s through the server vs {n_tok / dwall:.1f} direct; decode "
        f"p50 {statistics.median(ddec) * 1e3:.2f} ms direct; span tracing "
        f"on the same direct drive in turns (off, on, on, off; 8 requests "
        f"x 24 tokens): decode tick p50 {on * 1e3:.2f} ms on vs "
        f"{off * 1e3:.2f} ms off over {n_on} / {n_off} ticks, on/off "
        f"{on / off:.4f}; K7 launches {eng.decode_steps} x {L} "
        f"({depth_note(cfg)}); "
        f"/metrics {len(body.splitlines())} lines parse "
        f"({len(c)} counters, {len(parsed['histograms'])} histograms, "
        f"{len(parsed['gauges'])} gauges), /healthz ok; the recorder dump "
        f"holds {len(dump['records'])} of {dump['ticks_seen']} ticks with "
        f"the reference's {len(RECORD_KEYS)} keys")
    del direct, eng

    # b. speculative decoding on both backends, bf16 and f32
    spec = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for dtype, c_ in ((torch.bfloat16, cfg), (torch.float32, cfg32)):
        for backend in ("paged", "contiguous"):
            l0 = paged_decode_attend.launches
            spec[backend, dtype] = spec_compare(
                torch, np, c_, params, card, backend, dtype)
            k7 += paged_decode_attend.launches - l0

    # c. run_chaos at full width
    chaos = {}
    for label, kw, kfail in (
            ("paged kernel", dict(trace=True, flight_recorder=64), False),
            ("paged kernel, injected kernel failure", {}, True),
            ("contiguous", dict(backend="contiguous"), False),
            ("speculative, garbage drafter",
             dict(prefix_cache=False, spec=SpecConfig(
                 drafter=GarbageDrafter(cfg.vocab_size, seed=0),
                 disable_after_rejects=2)), False)):
        eng = ServeEngine(cfg, params, max_queue=8, **{**geo, **kw})
        l0 = paged_decode_attend.launches
        stats = run_chaos(eng, n_requests=24, seed=0, kernel_failure=kfail)
        n = paged_decode_attend.launches - l0
        if kfail and (stats["kernel_failures_surfaced"] != 1
                      or stats["finish_error"] < 1
                      or not eng.backend.use_kernel):
            raise AssertionError(f"the injected kernel failure: {stats}")
        if label.startswith("paged kernel"):
            k7 += count(eng, l0)
        elif n != 0:
            raise AssertionError(f"{label}: K7 launched {n} times")
        chaos[label] = stats
        log(f"[stack] run_chaos {label}: leak-free; "
            + ", ".join(f"{k}={v}" for k, v in sorted(stats.items())))

    # d. cache_generated and fork_slot
    rng = np.random.RandomState(4)
    first = rng.randint(1, cfg.vocab_size, size=64).tolist()
    eng = ServeEngine(cfg, params, cache_generated=True, **geo)
    l0 = paged_decode_attend.launches
    r1 = Request(prompt=first, max_new_tokens=40)
    eng.submit(r1)
    eng.run()
    follow = first + r1.out + rng.randint(1, cfg.vocab_size, 8).tolist()
    r2 = Request(prompt=follow, max_new_tokens=16)
    eng.submit(r2)
    eng._admit()
    start = next(iter(eng.sched.live.values())).start_pos
    eng.run()
    k7 += count(eng, l0)
    if start <= len(first):
        raise AssertionError(f"no prefix hit past the first prompt "
                             f"({start} <= {len(first)})")
    hits = eng.backend.prefix.hits
    cold = ServeEngine(cfg, params, **geo)
    l0 = paged_decode_attend.launches
    (rc,), _, _ = run_engine(torch, cold, [follow], 16)
    k7 += count(cold, l0)
    cold_eq = sum(a == b for a, b in zip(r2.out, rc.out))
    eng = ServeEngine(cfg, params, prefix_cache=False, **geo)
    be = eng.backend
    l0 = paged_decode_attend.launches
    eng.submit(Request(prompt=first, max_new_tokens=24))
    while not eng.sched.decode_entries():
        eng.step()
    (e,) = eng.sched.live.values()
    src = e.slot
    shared = [int(b) for b in be.tables[src] if b]
    clone = be.fork_slot(src)
    if (clone is None or not all(be.mgr.ref[b] == 2 for b in shared)
            or not np.array_equal(be.tables[src], be.tables[clone])):
        raise AssertionError("fork_slot did not share every block")
    used = be.mgr.num_used
    rows = [src, clone]
    logits = eng._logits[[src, src]]
    pos = e.pos
    outs = [list(e.req.out), list(e.req.out)]
    calls = 0
    for step in range(16):
        toks = logits.argmax(-1)
        for i in range(2):
            outs[i].append(int(toks[i]))
        for slot in rows:
            if not be.ensure_decode_block(slot, pos):
                raise AssertionError("the pool ran out of blocks")
        if step == 0 and (be.mgr.num_used != used + 1 or be.tables[src][
                pos // 16] == be.tables[clone][pos // 16]):
            raise AssertionError("the first write did not copy the shared "
                                 "block")
        in_toks = torch.zeros(8, 1, dtype=torch.long, device="cuda")
        in_pos = torch.full((8,), -1, dtype=torch.int32, device="cuda")
        in_toks[rows, 0] = toks
        in_pos[rows] = pos
        logits = be.decode(eng.params, in_toks, in_pos)[rows, 0]
        calls += 1
        pos += 1
    n = paged_decode_attend.launches - l0
    if n != (eng.decode_steps + calls) * L:
        raise AssertionError("K7 launches != decode model calls x layers")
    k7 += n
    if outs[0] != outs[1]:
        raise AssertionError("the forked row's tokens differ from its "
                             "source's")
    log(f"[stack] cache_generated: the follow-up prompt ({len(follow)} "
        f"tokens) admitted at {start} > {len(first)} (hits past the first "
        f"prompt), radix block hits {hits}; its tokens "
        f"vs a cold engine's {cold_eq}/{len(rc.out)} equal (bf16: the hit "
        f"reuses K/V written by decode steps); fork_slot: {len(shared)} "
        f"blocks shared at refcount 2, the first write copied one, "
        f"{len(outs[0])} greedy tokens of the fork equal its source's")
    if paged_decode_attend.launches != k7:
        raise AssertionError(f"K7 launches {paged_decode_attend.launches} "
                             f"not all accounted ({k7})")
    log(f"[stack] K7 launches in the phase: {k7}, each = decode model "
        f"calls x {L} of a kernel engine")
    return {"paged_decode_attend": k7}


# ---------------------------------------------------------------------------
# phase 23: distributed training on a world-1 NCCL mesh
# ---------------------------------------------------------------------------


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# phase 23 trains granite-moe-1b-a400m+soft's first 12 of 24 layers
DIST_DEPTH = 12


def phase_distributed(torch, card):
    """ZeRO-1 training of granite-moe-1b-a400m+soft at full width, depth
    cut to ``DIST_DEPTH``, through the sharded step on a (data=1, model=1) NCCL mesh
    beside the plain f32 step, the all-to-all MoE layer at granite's
    expert width, the int8 compressed pod reduce over the model's
    gradients and the elastic restore of the ZeRO-1 state. Returns the
    K1, K2, K4 and K5 launches of the ZeRO-1 steps."""
    import dataclasses
    import shutil

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import moe_init, resolve_moe_cfg
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import (
        distribute_tree,
        tree_shardings,
        use_mesh,
    )
    from repro_torch.distributed.a2a_routing import make_a2a_moe
    from repro_torch.kernels.invariant_matmul import router_logits
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
        routing_health,
    )
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import lm_init, lm_loss
    from repro_torch.optim import (
        OptimizerConfig,
        ef_state_init,
        pod_allreduce_compressed,
        pod_allreduce_mean,
        tree_leaves,
        tree_map,
    )
    from repro_torch.train import (
        init_train_state,
        jit_train_step,
        make_train_step,
        state_shardings,
    )
    from repro_torch.train.step import _grads_of

    kernels = (routing_fwd, combine_apply, combine_online, dispatch_bwd,
               combine_bwd, routing_health)
    gc.collect()
    torch.cuda.empty_cache()
    # depth cut (DIST_DEPTH): the checkpoint round trips' disk time
    # follows the state's size
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m+soft"),
                              num_layers=DIST_DEPTH)
    n_moe = len(cfg.moe_layer_indices())
    batch, seq, n_steps = 8, 2048, 3
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       batch_size=batch, seed=0, device="cuda")
    ocfg = OptimizerConfig()  # phase 10's

    def loss_fn(p, b):
        return lm_loss(p, cfg, b, use_kernel=True)

    def init(g):
        return lm_init(g, cfg)

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    mesh = make_host_mesh()  # NCCL, (data=1, model=1); raises if it fails
    log(f"[dist] {card}: process group {dist.get_backend()} world "
        f"{dist.get_world_size()}, mesh {mesh.mesh_dim_names} "
        f"{tuple(mesh.shape)}; {cfg.name} ({depth_note(cfg)}), batch "
        f"{batch} x {seq}, telemetry off, {n_steps} steps each")

    def run(step, state):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            state, m = step(state, data.batch(i))
            losses.append(float(m["total_loss"]))
            times.append(time.perf_counter() - t0)
        return state, losses, times, torch.cuda.max_memory_allocated()

    # the plain f32 state and step, from the same seed
    state = init_train_state(gen(), init)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    plain_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    state, plain_losses, plain_times, plain_peak = run(
        make_train_step(loss_fn, ocfg), state)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # ZeRO-1: bf16 compute params beside the f32 master, placed by
    # state_shardings on the mesh, through the step under the mesh
    state = init_train_state(gen(), init, zero1=True)
    with use_mesh(mesh):
        sh = state_shardings(mesh, state)
    state = distribute_tree(mesh, state, sh)
    zero_bytes = sum(t.to_local().numel() * t.element_size()
                     for t in tree_leaves(state))
    step = jit_train_step(make_train_step(loss_fn, ocfg), mesh, sh)
    starts, cast_ok = [], True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    losses, times = [], []
    for i in range(n_steps):
        # the compute params this step starts from: the master's cast
        starts.append(tree_map(lambda m: _whole(m).to(torch.bfloat16),
                               state["master"]))
        t0 = time.perf_counter()
        state, m = step(state, data.batch(i))
        losses.append(float(m["total_loss"]))
        times.append(time.perf_counter() - t0)
        cast_ok &= all(torch.equal(_whole(p), _whole(mm).to(p.dtype))
                       for p, mm in zip(tree_leaves(state["params"]),
                                        tree_leaves(state["master"])))
    launches = tuple(k.launches for k in kernels)
    zero_peak = torch.cuda.max_memory_allocated()
    want = tuple(n_steps * c for c in (2 * n_moe, 2 * n_moe, 0, n_moe,
                                       n_moe, 0))
    # each loss against loss_fn at the bf16 cast of the master it started
    # from, in the step's autograd mode
    checks = []
    for i, p in enumerate(starts):
        wrt = tree_map(lambda t: t.detach().requires_grad_(
            t.is_floating_point()), p)
        with torch.enable_grad():
            checks.append(float(loss_fn(wrt, data.batch(i))[0].detach()))
        del wrt
    del starts
    p50, plain_p50 = (statistics.median(t) for t in (times, plain_times))
    log(f"[dist] {card}: ZeRO-1 state {zero_bytes} bytes = "
        f"{zero_bytes / 1e9:.2f} GB ({zero_bytes / n_params:.2f} B/param) vs "
        f"plain {plain_bytes} = {plain_bytes / 1e9:.2f} GB "
        f"({plain_bytes / n_params:.2f} B/param), {n_params} params; step "
        f"p50 {p50 * 1e3:.2f} ms vs {plain_p50 * 1e3:.2f} ms plain "
        f"(ZeRO-1 / plain {p50 / plain_p50:.4f}; ZeRO-1 steps "
        + " ".join(f"{t * 1e3:.1f}" for t in times) + ", plain "
        + " ".join(f"{t * 1e3:.1f}" for t in plain_times) + " ms); peak "
        f"{zero_peak / 2**30:.3f} GiB vs {plain_peak / 2**30:.3f} GiB")
    log(f"[dist] losses ZeRO-1 " + " ".join(f"{v:.6f}" for v in losses)
        + " | plain " + " ".join(f"{v:.6f}" for v in plain_losses)
        + " | |diff| " + " ".join(f"{abs(a - b):.3e}"
                                  for a, b in zip(losses, plain_losses))
        + f"; loss_fn at the master's bf16 cast "
        + " ".join(f"{v:.6f}" for v in checks)
        + f" (bitwise equal: {checks == losses}); compute params == master "
        f"cast after every step: {cast_ok}; launches K1-K6 {launches} "
        f"(= {n_steps} x remat's 2 forwards: {want})")
    if checks != losses or not cast_ok:
        raise AssertionError("ZeRO-1 loss or compute params differ from "
                             "the master's bf16 cast")
    if launches != want:
        raise AssertionError(f"ZeRO-1 launches {launches} != {want}")
    if not all(math.isfinite(v) for v in losses + plain_losses):
        raise AssertionError("non-finite loss")

    # the compressed pod reduce over the model's gradient tree on a
    # (pod=1, data=1, model=1) mesh
    pmesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    compute = tree_map(_whole, state["params"])
    grads = _grads_of(loss_fn, compute, data.batch(n_steps))[2]
    del compute
    with use_mesh(pmesh):
        specs = tree_shardings(pmesh, grads)
    err = ef_state_init(grads)
    numel = sum(g.numel() for g in tree_leaves(grads))
    res = {}
    for name in ("compressed", "mean", "compressed", "mean"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "compressed":
            out, new_err = pod_allreduce_compressed(grads, err, pmesh, specs)
        else:
            mean = pod_allreduce_mean(grads, pmesh, specs)
        torch.cuda.synchronize()
        res.setdefault(name, []).append(time.perf_counter() - t0)
    worst, err_ok, mean_ok = 0.0, True, True
    for g, e, o, ne, mn in zip(*(tree_leaves(t) for t in (
            grads, err, out, new_err, mean))):
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        worst = max(worst, float((o - g).abs().max() / scale))
        err_ok &= torch.equal(ne, (g.float() + e) - o.float())
        mean_ok &= torch.equal(mn, g)
    log(f"[dist] {card}: pod reduce of {len(tree_leaves(grads))} gradient "
        f"leaves, {numel} elements: compressed "
        f"{min(res['compressed']) * 1e3:.2f} ms, exact mean "
        f"{min(res['mean']) * 1e3:.2f} ms (best of 2); payload int8 {numel} "
        f"bytes, summed as int32 {4 * numel} bytes (f32 mean {4 * numel}); "
        f"max |out - g| / scale {worst:.6f} (bound 0.5 + 2^-15 of f32 "
        f"rounding); new_err == corrected - out bitwise: {err_ok}; mean "
        f"== input bitwise: {mean_ok}")
    if worst > 0.5 + 2**-15 or not err_ok or not mean_ok:
        raise AssertionError("compressed pod reduce out of bounds")
    del grads, err, out, new_err, mean

    # the elastic restore of the ZeRO-1 state after step 3: onto a 1-D
    # data mesh (axis 0 over data) and with no mesh, bitwise
    ckpt_dir = ROOT / "build" / "chip_smoke_dist_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(n_steps, state)
    save_s = time.perf_counter() - t0
    dmesh = make_mesh((1,), ("data",))
    data_sh = tree_map(lambda t: (Shard(0),) if t.ndim else (Replicate(),),
                       state)
    loads = {}
    for label in ("1-D data mesh", "no mesh"):
        t0 = time.perf_counter()
        if label == "no mesh":
            got = mgr.restore(n_steps, state, device="cuda")
        else:
            with use_mesh(dmesh):
                got = mgr.restore(n_steps, state, shardings=data_sh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        same = all(torch.equal(_whole(a), _whole(b)) and a.dtype == b.dtype
                   for a, b in zip(tree_leaves(got), tree_leaves(state)))
        loads[label] = (dt, same)
        del got
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[dist] {card}: checkpoint of the ZeRO-1 state {zero_bytes / 1e9:.2f} "
        f"GB: save {save_s:.2f} s = {zero_bytes / 1e9 / save_s:.3f} GB/s; "
        + "; ".join(f"restore onto {k} {dt:.2f} s = "
                    f"{zero_bytes / 1e9 / dt:.3f} GB/s, bitwise {same}"
                    for k, (dt, same) in loads.items()))
    if not all(same for _, same in loads.values()):
        raise AssertionError("elastic restore differs from the saved state")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # the all-to-all MoE layer at granite's expert width: one layer of the
    # as-configured model's router and experts, 16384 f32 tokens, on a
    # model=1 mesh (capacity factor 1.0: cap = tokens x top-k, dropless),
    # against the dense dropless top-k on the same inputs
    sparse = get_config("granite-moe-1b-a400m")
    mcfg = resolve_moe_cfg(sparse.moe, sparse.d_ff)
    layer = moe_init(torch.Generator(device="cuda").manual_seed(1),
                     sparse.d_model, mcfg, sparse.mlp_style)
    ex = layer["experts"]
    e_n, k_n, d = mcfg.num_experts, mcfg.top_k, sparse.d_model
    x = torch.randn(16384, d, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    amesh = make_mesh((1,), ("model",))
    moe = make_a2a_moe(amesh, e_n, k_n, d, capacity_factor=1.0)
    a2a_times, before = [], router_logits.launches
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = moe(x, layer["router"], ex["w_gate"], ex["w_up"], ex["w_down"])
        torch.cuda.synchronize()
        a2a_times.append(time.perf_counter() - t0)
    a2a_router = router_logits.launches - before
    # the reference routes on the layer's own logits (the kernel is held
    # against its plain version in phase 6b): this check is of the
    # exchange and the experts, which a 1-ulp tie flip would mask
    probs = torch.softmax(router_logits(x, layer["router"].float()), -1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = order.values[:, :k_n], order.indices[:, :k_n]
    gate_n = gate / gate.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for e in range(e_n):
        rows, kk = (idx == e).nonzero(as_tuple=True)
        xe = x[rows]
        h = torch.nn.functional.silu(xe @ ex["w_gate"][e]) * (xe @ ex["w_up"][e])
        ref.index_add_(0, rows, (h @ ex["w_down"][e]) * gate_n[rows, kk, None])
    a2a_err = float((y - ref).abs().max() / ref.abs().max())
    log(f"[dist] {card}: all-to-all MoE layer ({e_n} experts, top-{k_n}, d "
        f"{d}, expert ff {mcfg.expert_d_ff}, SwiGLU; 16384 f32 tokens, cap "
        f"{16384 * k_n}): {a2a_times[-1] * 1e3:.2f} ms (first call "
        f"{a2a_times[0] * 1e3:.2f}); vs the dense dropless top-k max|diff| / "
        f"max|ref| {a2a_err:.3e} (tol 1e-3); router_logits launches "
        f"{a2a_router} (once a call)")
    if not a2a_err <= 1e-3:
        raise AssertionError("all-to-all MoE layer disagrees")
    if a2a_router != len(a2a_times):
        raise AssertionError("the all-to-all layer's router must launch "
                             "router_logits once a call")
    del layer, ex, x, y, ref
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"routing_fwd": launches[0], "combine_apply": launches[1],
            "dispatch_bwd": launches[3], "combine_bwd": launches[4],
            "router_logits": a2a_router}


# ---------------------------------------------------------------------------
# phase 24: the wave baseline, the analytic roofline and the dry-run
# ---------------------------------------------------------------------------

DRYRUNS = (("train_4k",), ("decode_32k",), ("train_4k", "--multi-pod"))


def start_dryruns():
    """Start the dry-runs of qwen2-0.5b (``DRYRUNS``) as host-only
    subprocesses, all at once: they see no card and share nothing with
    this process (which holds phase 23's process group)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return [(run, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", *run], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for run in DRYRUNS]


def finish_dryruns(procs, timeout=180):
    """Each dry-run's JSON line, waiting at most ``timeout`` seconds (from
    this call) for all of them; a run that fails or prints no line
    raises."""
    deadline = time.perf_counter() + timeout
    out = []
    for run, p in procs:
        try:
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"dry-run {run} ran past {timeout} s")
        line = next((ln for ln in stdout.splitlines()
                     if ln.startswith('{"cell"')), None)
        if p.returncode != 0 or line is None:
            raise AssertionError(f"dry-run {run} failed (rc {p.returncode}):"
                                 f" {stderr[-2000:]}")
        out.append((run, json.loads(line)))
    return out


def stop_dryruns(procs):
    """Kill and reap every dry-run still running."""
    for _, p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def wave_prefill_check(torch, cfg, params, prompts):
    """f32: each row of one padded wave prefill (right-aligned, pads at
    position -1) against a batch-1 unpadded prefill of its prompt; returns
    the largest max|diff| / max|ref| over the rows."""
    from repro_torch.models import lm_apply
    from repro_torch.serve import Request, WaveEngine

    eng = WaveEngine(cfg, params, batch_size=len(prompts), max_len=2048,
                     device="cuda")
    got = {}
    inner = eng._prefill

    def prefill(*a):
        logits, cache = inner(*a)
        got["logits"] = logits[:, -1].clone()
        return logits, cache

    eng._prefill = prefill
    for p in prompts:
        eng.submit(Request(prompt=list(p), max_new_tokens=1))
    eng.run()  # budget 1: the prefill alone
    worst = 0.0
    for i, p in enumerate(prompts):
        ref = lm_apply(eng.params, cfg, torch.tensor([p], device="cuda"),
                       mode="prefill", last_only=True)[0][0, -1]
        worst = max(worst, rel_err(torch, got["logits"][i], ref))
    return worst


def run_wave(torch, eng, prompts, max_new):
    """Drive a ``WaveEngine`` over ``prompts`` as ``run_engine`` drives a
    ``ServeEngine``: the requests, the wall seconds and the decode-step
    times (each call synchronised)."""
    from repro_torch.serve import Request

    decode_s = []
    inner = eng._decode

    def decode(*a):
        t0 = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        return out

    eng._decode = decode
    reqs = [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, decode_s


def phase_wave_roofline(torch, card, soft):
    """The wave-synchronous baseline beside the contiguous and the paged
    engine at full qwen2-0.5b width and depth, the analytic roofline of a
    wave decode step and of phase 10's granite+soft step (``soft``: its
    summary), and the dry-run of qwen2-0.5b on 256 and 512 fake ranks.
    Returns K7's launches of the paged run."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.models import lm_init
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS_BF16, model_flops
    from repro_torch.roofline.flops import _cache_bytes, fwd_flops
    from repro_torch.serve import ServeEngine, WaveEngine

    procs = start_dryruns()
    try:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config("qwen2-0.5b")
        params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
        prompts = make_requests(np, cfg.vocab_size)
        max_new, batch, max_len = 32, 8, 2048

        # held: the padded wave prefill in f32 against batch-1 prefills
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        rel = wave_prefill_check(torch, cfg32, params, prompts[:batch])
        log(f"[wave] {card}: {cfg.name} f32 wave prefill (batch {batch}, "
            f"prompts of {min(map(len, prompts[:batch]))}-"
            f"{max(map(len, prompts[:batch]))} tokens right-aligned) vs "
            f"batch-1 unpadded prefills: first-token logits max|diff| / "
            f"max|ref| at most {rel:.3e} (tol 1e-4)")
        if not math.isfinite(rel) or rel > 1e-4:
            raise AssertionError("the padded wave prefill disagrees with "
                                 "the unpadded one")

        engines = {
            "wave": lambda: WaveEngine(cfg, params, batch_size=batch,
                                       max_len=max_len, device="cuda"),
            "contiguous": lambda: ServeEngine(
                cfg, params, batch_size=batch, max_len=max_len,
                prefill_chunk=256, device="cuda"),
            "paged": lambda: ServeEngine(
                cfg, params, batch_size=batch, max_len=max_len,
                prefill_chunk=256, backend="paged", block_size=16,
                device="cuda"),
        }
        drive = {"wave": run_wave}
        for name, make in engines.items():  # warm-up: allocator, cuBLAS
            drive.get(name, run_engine)(torch, make(), prompts[1:3], 4)
        dry = finish_dryruns(procs)
    finally:
        stop_dryruns(procs)

    # the timed runs, in bf16, over phase 7's trace
    runs = {}
    for name, make in engines.items():
        eng = make()
        paged_decode_attend.launches = 0
        reqs, wall, decode_s = drive.get(name, run_engine)(
            torch, eng, prompts, max_new)
        runs[name] = (eng, reqs, wall, decode_s, paged_decode_attend.launches)
    k7 = runs["paged"][4]
    for name, (eng, reqs, wall, decode_s, launches) in runs.items():
        n_tok = sum(len(r.out) for r in reqs)
        ttft = statistics.median(r.t_first_token - r.t_submit for r in reqs)
        log(f"[wave] {card}: {cfg.name} {name} engine (batch {batch}, "
            f"max_len {max_len}): {n_tok / wall:.1f} tok/s ({n_tok} tokens, "
            f"makespan {wall:.3f} s), {eng.decode_steps} decode calls, "
            f"decode p50 {statistics.median(decode_s) * 1e3:.2f} ms, TTFT "
            f"p50 {ttft * 1e3:.1f} ms, peak_cache_bytes "
            f"{eng.peak_cache_bytes()}, K7 launches {launches}")
    done = all(r.done and r.finish_reason == "length"
               for run in runs.values() for r in run[1])
    tok_s = {n: sum(len(r.out) for r in run[1]) / run[2]
             for n, run in runs.items()}
    wave_out = [t for r in runs["wave"][1] for t in r.out]
    cont_out = [t for r in runs["contiguous"][1] for t in r.out]
    agree = sum(a == b for a, b in zip(wave_out, cont_out))
    cache_b = {n: run[0].peak_cache_bytes() for n, run in runs.items()}
    log(f"[wave] {card}: continuous/wave tok/s "
        f"{tok_s['contiguous'] / tok_s['wave']:.4f} (contiguous), "
        f"{tok_s['paged'] / tok_s['wave']:.4f} (paged); paged/contiguous "
        f"peak cache {cache_b['paged'] / cache_b['contiguous']:.4f}; wave "
        f"vs contiguous greedy tokens equal {agree}/{len(wave_out)} = "
        f"{agree / len(wave_out):.4f}")
    if not done or k7 != runs["paged"][0].decode_steps * cfg.num_layers \
            or k7 == 0 or runs["wave"][4] or runs["contiguous"][4]:
        raise AssertionError("wave phase: an unfinished request, or K7 "
                             "launches other than decode calls x layers "
                             "on the paged engine alone")
    if cache_b["wave"] != cache_b["contiguous"]:
        raise AssertionError("the wave's cache is not one contiguous ring "
                             "row a slot")

    # the analytic roofline of one wave decode step (batch 8 over the
    # 2048-slot rings, which the contiguous decode attends in full)
    wave_p50 = statistics.median(runs["wave"][3])
    f_dec = fwd_flops(cfg, batch, 1, "decode", cache_len=max_len)
    b_dec = (cfg.param_count() * 2 + _cache_bytes(cfg, batch, max_len)
             + batch * cfg.vocab_size * 4)
    t_ops, t_bytes = f_dec / PEAK_FLOPS_BF16, b_dec / HBM_BW
    bound = max(t_ops, t_bytes)
    log(f"[roofline] {card}: {cfg.name} wave decode step: fwd_flops "
        f"{f_dec:.6e}, analytic bytes {b_dec:.6e}, bound "
        f"{bound * 1e3:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
        f"vs measured p50 {wave_p50 * 1e3:.2f} ms = {bound / wave_p50:.4f} "
        f"of the bound")
    gcfg = get_config("granite-moe-1b-a400m+soft")
    shape = ShapeConfig("phase 10", 2048, 8, "train")
    mf = model_flops(gcfg, shape, "train")
    af = fwd_flops(gcfg, 8, 2048, "train") * (3.0 + (1.0 if gcfg.remat
                                                      else 0.0))
    p50 = soft["p50"]
    log(f"[roofline] {card}: {gcfg.name} train step 8 x 2048 (phase 10 "
        f"p50 {p50 * 1e3:.2f} ms): model_flops (6 N_active D) {mf:.6e} = "
        f"{mf / p50 / PEAK_FLOPS_BF16:.4f} of PEAK_FLOPS_BF16; fwd_flops x "
        f"(3 + remat) {af:.6e} = {af / p50 / PEAK_FLOPS_BF16:.4f}")

    # the dry-runs (256 and 512 fake ranks, meta tensors, host only)
    for _, r in dry:
        rf, mem = r["roofline"], r["memory"]
        log(f"[dryrun] {r['cell']} {r['mesh']}: "
            f"status {r['status']}, run {r['run_s']} s; compute "
            f"{rf['t_compute_s']:.6e} s, memory {rf['t_memory_s']:.6e} s, "
            f"collective {rf['t_collective_s']:.6e} s -> {rf['bottleneck']}"
            f", roofline_fraction {rf['roofline_fraction']:.4f}, "
            f"useful_flops_fraction {rf['useful_flops_fraction']:.4f}; args "
            f"{mem['args_bytes_per_dev']} B/dev; collectives "
            f"{r['collectives']['counts']}, NVLink-weighted "
            f"{r['collectives']['ici_weighted_bytes']:.6e} B, inter-node "
            f"{r['collectives']['pod_weighted_bytes']:.6e} B")
        if r["status"] != "ok":
            raise AssertionError(f"dry-run {r['cell']}: {r['status']}")
    del runs, params
    torch.cuda.empty_cache()
    return {"paged_decode_attend": k7}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# phase 25: the contract linter and the example twins
# ---------------------------------------------------------------------------

# soft-moe-b/16-128e's Soft-MoE layer at the ViT phases' batch
B16_LAYER = dict(b=64, m=196, d=768, n=128, d_ff=3072, style="classic",
                 act="gelu")
TWINS = ("train_vit_softmoe", "quickstart", "serve_lm", "serve_async",
         "contrastive_lit")


def op_key(op):
    """A recorded op as JSON-able data: name, input and output
    (shape, dtype)."""
    def sig(ts):
        return [[list(shape), str(dt)] for shape, dt in ts]

    return [op.name, sig(op.inputs), sig(op.outputs)]


def print_b16_recording():
    """Host-only: record the kernel-path Soft-MoE grad program at B/16's
    layer on the CPU (the kernels' plain versions, each wrapper one op)
    and print its ops as one JSON line."""
    import torch

    from repro_torch.analysis import kernel_program_specs

    t0 = time.perf_counter()
    spec = kernel_program_specs(device="cpu", dtype=torch.bfloat16,
                                **B16_LAYER)[0]
    ops = [op_key(op) for op in spec.ops()]
    print(json.dumps({"ops": ops, "seconds": time.perf_counter() - t0}),
          flush=True)


def start_host_analysis():
    """Start the host-only halves of phase 25 as subprocesses that see no
    card: the CPU linter over the whole grid and the CPU recording of the
    B/16 grad program."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = {
        "cli": ([sys.executable, "-m", "repro_torch.analysis", "--all",
                 "--device", "cpu"], "2"),
        "b16": ([sys.executable, "-c",
                 "import chip_smoke as c; c.print_b16_recording()"], "4"),
    }
    return {name: subprocess.Popen(
        cmd, cwd=ROOT, env=dict(env, OMP_NUM_THREADS=threads),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (cmd, threads) in runs.items()}


def finish_host_analysis(procs, timeout=180):
    """Each subprocess's stdout, waiting at most ``timeout`` seconds (from
    this call) for all of them; a run that fails raises."""
    deadline = time.perf_counter() + timeout
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"host analysis {name} ran past {timeout} s")
        if p.returncode != 0:
            raise AssertionError(f"host analysis {name} failed (rc "
                                 f"{p.returncode}): {stdout[-2000:]} "
                                 f"{stderr[-2000:]}")
        out[name] = stdout
    return out


def stop_host_analysis(procs):
    """Kill and reap every host analysis still running."""
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()


def load_twin(name):
    """One ``examples/torch/`` twin as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"twin_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hold_path_kernels(torch, spec):
    """Run ``spec``'s program once more, keeping a copy of each kernel
    call's arguments, and hold each kernel against its plain version on
    those arguments: f32 outputs within 1e-5 of max|ref|, bf16 outputs
    within one bf16 step (2^-7 |ref|) + 1e-5 max|ref|, elementwise.
    Returns {kernel: max abs error}; these launches are not counted."""
    from repro_torch.analysis.framework import OpRecorder, _copy_args
    from repro_torch.kernels import soft_moe_kernels as sk

    calls = []

    class Keep(OpRecorder):
        def kernel_call(self, name, fn, args, kwargs):
            calls.append((name, fn, _copy_args(args), kwargs))
            return super().kernel_call(name, fn, args, kwargs)

    with Keep():
        spec.fn(*spec.args)
    errs = {}
    for name, fn, args, kwargs in calls:
        kept = getattr(sk, name).launches
        with torch.no_grad():  # the backward's saved tensors need grad
            got = fn(*args, **kwargs)
            want = getattr(sk, f"{name}_ref")(*args, **kwargs)
        getattr(sk, name).launches = kept
        flat = torch.utils._pytree.tree_leaves
        for g, w in zip(flat(got), flat(want)):
            diff = (g.float() - w.float()).abs()
            top = w.float().abs().max()
            if g.dtype == torch.float32:
                ok = bool(diff.max() <= 1e-5 * top)
            else:
                ok = bool((diff <= 2.0**-7 * w.float().abs()
                           + 1e-5 * top).all())
            errs[name] = max(errs.get(name, 0.0), diff.max().item())
            if not ok or not torch.isfinite(g).all():
                raise AssertionError(f"{name} at the path's inputs "
                                     f"disagrees with its plain version: "
                                     f"{diff.max().item():.3e}")
    return errs


def phase_analysis_examples(torch, card, procs=None):
    """The contract linter on the card with the real kernels and the five
    example twins on ``cuda``; the CPU linter and the CPU recording of the
    B/16 program run meanwhile as host-only subprocesses (``procs``:
    ``start_host_analysis()``'s, started earlier by the caller so that
    they overlap earlier phases too; None starts them here). Returns the
    kernels' launches of the linted programs and of the twins."""
    import math
    import tempfile

    from repro_torch.analysis import (
        DEFAULT_ALLOWLIST,
        kernel_program_specs,
        run_passes,
        serving_program_specs,
    )
    from repro_torch.analysis.passes import materialization_pass
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import soft_moe_kernels as sk
    from repro_torch.kernels.paged_attention import paged_decode_attend

    kernels = {name: getattr(sk, name) for name in (
        "routing_fwd", "combine_apply", "combine_online", "dispatch_bwd",
        "combine_bwd", "routing_health")}
    kernels["paged_decode_attend"] = paged_decode_attend

    def zero():
        for f in kernels.values():
            f.launches = 0

    def counts():
        return {n: f.launches for n, f in kernels.items()}

    secs = {}
    t_phase = time.perf_counter()
    procs = procs or start_host_analysis()
    try:
        # (a) the Soft-MoE layer at B/16's shape, bf16: the kernel path's
        # gradient forms no (m x S) plane; the einsum path's does
        gc.collect()
        torch.cuda.empty_cache()
        zero()
        spec = kernel_program_specs(device="cuda", dtype=torch.bfloat16,
                                    **B16_LAYER)[0]
        t0 = time.perf_counter()
        findings, n = materialization_pass([spec])
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        a_counts = counts()
        interior = sorted({tuple(s) for op in spec.ops() if op.within
                           for s in op.shapes()})
        log(f"[analysis] {card}: kernels/soft_moe_grad at B/16's layer "
            f"(b 64, m 196, d 768, S 128, d_ff 3072, bf16): "
            f"{len(spec.ops())} ops recorded in {rec_s:.2f} s, "
            f"{spec.forbid[0].label}: {'clean' if not findings else findings}"
            f"; launches {a_counts}; kernel allocations {interior}")
        want = {n_: 0 for n_ in kernels}
        want.update(routing_fwd=1, combine_apply=1, dispatch_bwd=1,
                    combine_bwd=1)
        if n != 1 or findings or a_counts != want:
            raise AssertionError("the kernel-path grad formed the (m x S) "
                                 "plane or skipped a kernel")
        errs = hold_path_kernels(torch, spec)
        log(f"[analysis] {card}: K1/K2/K4/K5 at the path's inputs vs their "
            f"plain versions (f32 1e-5 of max|ref|, bf16 one bf16 step + "
            f"1e-5 of max|ref|): max abs err {errs}")
        einsum = kernel_program_specs(device="cuda", dtype=torch.bfloat16,
                                      use_kernel=False, **B16_LAYER)[0]
        flagged, _ = materialization_pass([einsum])
        log(f"[analysis] {card}: the einsum path at the same shape: "
            f"{[f.message for f in flagged]}")
        if len(flagged) != 1 or "(64, 196, 128, 1)" not in \
                flagged[0].message:
            raise AssertionError("the einsum path's (m x S) plane went "
                                 "unflagged")
        card_ops = [op_key(op) for op in spec.ops() if op.within is None]
        del spec, einsum
        gc.collect()
        torch.cuda.empty_cache()
        secs["B/16 grad"] = time.perf_counter() - t_phase

        # (b) qwen2-0.5b at full width: batch 8, max_len 2048, block 16
        zero()
        specs = serving_program_specs("qwen2-0.5b", batch=8, max_len=2048,
                                      block_size=16, device="cuda",
                                      full_width=True)
        t0 = time.perf_counter()
        report = run_passes(specs, ["materialization", "retrace",
                                    "donation", "dtype"], DEFAULT_ALLOWLIST)
        torch.cuda.synchronize()
        b_k7 = paged_decode_attend.launches
        layers = get_config("qwen2-0.5b").num_layers
        log(f"[analysis] {card}: qwen2-0.5b full width, {len(specs)} "
            f"programs in {time.perf_counter() - t0:.2f} s, K7 launches "
            f"{b_k7}:")
        for line in report.render().splitlines():
            log(f"[analysis]   {line}")
        where = {(f.pass_name, f.where) for f in report.findings}
        allowed = {(f.pass_name, f.where) for f in report.allowed}
        if (not report.ok() or b_k7 != layers
                or ("materialization", "paged/decode@qwen2-0.5b") in where
                or allowed != {
                    ("materialization", "paged/verify@qwen2-0.5b"),
                    ("materialization", "paged/prefill_chunk@qwen2-0.5b"),
                    ("donation", "engine/sample@qwen2-0.5b"),
                    ("retrace", "paged/clear_blocks@qwen2-0.5b")}):
            raise AssertionError("qwen2-0.5b's programs: a failure, the row "
                                 "view in paged/decode, or K7 not once a "
                                 "layer")
        del specs, report
        gc.collect()
        torch.cuda.empty_cache()
        secs["qwen2 programs"] = time.perf_counter() - t_phase - sum(
            secs.values())

        # (c) the five twins, in process, on the card
        twins = {name: load_twin(name) for name in TWINS}
        zero()
        with tempfile.TemporaryDirectory() as d:
            out = twins["train_vit_softmoe"].main(
                ["--steps", "3", "--use-kernel", "--ckpt-dir", d,
                 "--device", "cuda"])
        vit_counts = counts()
        log(f"[examples] {card}: train_vit_softmoe --steps 3 --use-kernel: "
            f"{out['model']}, losses {out['losses']}, launches {vit_counts}")
        if (not out["losses"] or not all(map(math.isfinite, out["losses"]))
                or any(vit_counts[k] != 18 for k in (
                    "routing_fwd", "combine_apply", "dispatch_bwd",
                    "combine_bwd"))):
            raise AssertionError("the ViT twin: a non-finite loss or not "
                                 "K1/K2/K4/K5 once a MoE layer a step")
        out = twins["quickstart"].main(["--device", "cuda"])
        log(f"[examples] {card}: quickstart: {out}")
        if out["out_shape"] != (1, 196, 256) or not out["max_combine"] < 1:
            raise AssertionError("quickstart")
        zero()
        out = twins["serve_lm"].main(["--paged", "--device", "cuda"])
        lm_k7 = paged_decode_attend.launches
        n_layers = reduced(get_config("qwen2-0.5b")).num_layers
        log(f"[examples] {card}: serve_lm --paged: {out['finish_reasons']},"
            f" {out['steps']} decode calls, {out['tokens']} tokens, K7 "
            f"{lm_k7}")
        if not all(out["done"]) or lm_k7 != out["steps"] * n_layers:
            raise AssertionError("serve_lm: an unfinished request or K7 not "
                                 "once a layer a decode call")
        zero()
        out = twins["serve_async"].main(["--paged", "--trace",
                                         "--metrics-port", "0",
                                         "--device", "cuda"])
        async_k7 = paged_decode_attend.launches
        streamed = [v for v in out["streams"].values() if v[0] == "streamed"]
        log(f"[examples] {card}: serve_async --paged --trace --metrics-port "
            f"0: {len(streamed)}/{len(out['streams'])} streamed, K7 "
            f"{async_k7}, /metrics {len(out['metrics_text'])} B")
        if (len(streamed) != 8 or async_k7 == 0
                or "repro_serve_completed_total 8" not in
                out["metrics_text"]):
            raise AssertionError("serve_async: a request did not stream or "
                                 "/metrics was not scraped")
        out = twins["contrastive_lit"].main(["--steps", "25",
                                             "--device", "cuda"])
        log(f"[examples] {card}: contrastive_lit --steps 25: InfoNCE "
            f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")

        secs["twins"] = time.perf_counter() - t_phase - sum(secs.values())
        # (d) the host-only halves
        host = finish_host_analysis(procs)
        secs["waiting for the host"] = (time.perf_counter() - t_phase
                                        - sum(secs.values()))
    finally:
        stop_host_analysis(procs)
    cli = host["cli"].splitlines()
    log(f"[analysis] host CPU: python -m repro_torch.analysis --all "
        f"--device cpu:")
    for line in cli:
        if not line.startswith(("[ALLOWED]", "          reason", "[")):
            log(f"[analysis]   {line}")
    if "analysis: PASS" not in cli:
        raise AssertionError("the CPU linter did not pass")
    b16 = json.loads(host["b16"].splitlines()[-1])
    cpu_ops = b16["ops"]
    same = sorted(map(json.dumps, cpu_ops)) == sorted(map(json.dumps,
                                                          card_ops))
    log(f"[analysis] {card}: the B/16 grad program's recorded ops on the "
        f"card (kernel allocations left out) vs on the CPU: {len(card_ops)}"
        f" vs {len(cpu_ops)} (the CPU's in {b16['seconds']:.1f} s), equal "
        f"as multisets: {same}")
    log(f"[analysis] phase 25 wall seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    if not same:
        diff = set(map(json.dumps, card_ops)) ^ set(map(json.dumps, cpu_ops))
        raise AssertionError(f"card and CPU recordings differ: "
                             f"{sorted(diff)[:10]}")
    launches = {k: a_counts[k] + vit_counts[k] for k in (
        "routing_fwd", "combine_apply", "dispatch_bwd", "combine_bwd")}
    launches["paged_decode_attend"] = b_k7 + lm_k7 + async_k7
    return launches


def timed(fn, *args):
    """Run one phase and log its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s wall")
    return out


def main():
    try:
        import torch

        t0 = time.perf_counter()
        card = timed(phase_device, torch)
        timed(phase_build)
        kern = timed(phase_kernels, torch)
        kern.update(timed(phase_soft_moe_kernels, torch))
        kern.update(timed(phase_soft_moe_bwd_kernels, torch))
        kern.update(timed(phase_routing_health, torch))
        kern.update(timed(phase_invariant_kernels, torch))
        launches = timed(phase_serve, torch, card)
        launches.update(timed(phase_vit, torch, card))
        timed(phase_sparse_vit, torch, card)
        launches.update(timed(phase_train, torch, card))
        lm_launches, soft_summary = timed(phase_lm_train, torch, card)
        launches.update(lm_launches)
        timed(phase_sparse_lm_train, torch, card, soft_summary)
        launches.update(timed(phase_moe_serve, torch, card))
        for name, n in timed(phase_mla_serve, torch, card).items():
            launches[name] += n
        launches["paged_decode_attend"] += timed(
            phase_vlm, torch, card)["paged_decode_attend"]
        timed(phase_long_lm_train, torch, card)
        timed(phase_ssm, torch, card)
        launches["paged_decode_attend"] += timed(
            phase_ssm_serve, torch, card)["paged_decode_attend"]
        timed(phase_ssm_train, torch, card)
        timed(phase_contiguous_serve, torch, card)
        timed(phase_seamless_serve, torch, card)
        timed(phase_seamless_train, torch, card)
        launches["paged_decode_attend"] += timed(
            phase_serving_stack, torch, card)["paged_decode_attend"]
        # phase 25's host-only halves run beside phases 23 and 24
        host = start_host_analysis()
        try:
            for name, n in timed(phase_distributed, torch, card).items():
                launches[name] += n
            launches["paged_decode_attend"] += timed(
                phase_wave_roofline, torch, card, soft_summary)[
                    "paged_decode_attend"]
            for name, n in timed(phase_analysis_examples, torch, card,
                                 host).items():
                launches[name] += n
        finally:
            stop_host_analysis(host)
        log(f"[phase] all phases: {time.perf_counter() - t0:.1f} s wall")
    except Exception as e:  # noqa: BLE001 — report which phase failed
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        raise SystemExit(1)
    rows = []
    for name, meta in KERNEL_SOURCES.items():
        rows.append({"name": name, **meta, "launches": launches[name],
                     **kern[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
