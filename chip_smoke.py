#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``paddle_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # the full run; needs one CUDA card
    python3 chip_smoke.py --profile  # and traces decode (3, 7, 10, 19, 27)
    python3 chip_smoke.py --decode-profile-only   # phase 3's trace alone
    python3 chip_smoke.py --decode-tail-only      # phase 2's tail rows alone
    python3 chip_smoke.py --mla-only              # phase 2's MLA rows alone
    python3 chip_smoke.py --optimizer-only        # phase 2's update rows
    python3 chip_smoke.py --moe-only              # MoE rows, phases 18-21
    python3 chip_smoke.py --engine-only           # phase 22 alone
    python3 chip_smoke.py --autotune-only         # phase 23 alone
    python3 chip_smoke.py --http-only             # phase 24 alone
    python3 chip_smoke.py --engine-step-only      # the engine's step wall
    python3 chip_smoke.py --gemma-only            # width-256 rows, phase 25
    python3 chip_smoke.py --gemma-train-only      # their training, phase 26
    python3 chip_smoke.py --families-only         # widths 64 / 96, phase 27
    python3 chip_smoke.py --deepseek-v3-only      # 128 MLA heads, phase 28
    python3 chip_smoke.py --hf-bridge-only        # the HF bridge, phase 29

Phases (any failure raises, so the script exits non-zero):

1. Device and build: the card's name and power limit, then every kernel
   of ``paddle_tpu_torch/csrc`` compiled by nvcc from the checkout, with
   each kernel's registers and spills (ptxas), and the tensor-core
   instructions of the attention, paged, MLA and decode-tail kernels'
   SASS (``cuobjdump``; a library without any fails the full run).
2. Each kernel against its plain PyTorch version on the card, in bf16 at
   the serving and training paths' shapes, with its time (CUDA events,
   median of 20 after warm-up; 5 for the sequence-4096 attention rows),
   its back-to-back time (CUDA events around 10 calls in a row, divided
   by 10: the host's pace where the wrapper's host time exceeds the
   kernel's), its profiled time (the device kernels' own durations over
   10 calls from ``torch.profiler``, divided by 10), the plain version's
   time, the least time the card could take (bound), and one PyTorch
   library call computing the same function, timed the same three ways,
   as a yardstick only (the port never calls it). Paged decode attention
   runs at 14 shapes (the main one B 8, max_len 2048, page size 16, sum
   of lengths 5594; the decode profile's 8 x 512; B 1 and 32; 1, 2, 8
   and 16 query heads per KV head; page sizes 8 and 32; f32; ragged
   lengths with a dead row, which must be exactly 0; ERNIE-4.5-21B-A3B's
   20 | 4 heads, a group of 5, at the main lengths), timed cold: kernel
   and yardstick rotate over copies of the pool and of the gathered pages
   that touch more than 100 MB, as each layer's own pool is cold in a
   decode step; the warm figure is printed beside it. Append attention
   also runs at ``generate``'s dense decode shape (S 1, B 4, 32 | 8 heads,
   pos 1040 of T 1056, with and without run c's column mask), timed cold
   over copies of K / V touching more than 100 MB (warm beside), SDPA with
   the mask as its yardstick. ``rms_norm`` runs at
   8 and 4096 rows of 4096 (and at widths 512, 2048, 4096 by 1, 8 and 4096
   rows in bf16 and f32 untimed). The attention backward is held per
   element against its plain version on the same inputs (delta from the
   forward's out, as the kernel and splash take it). The fused decode-tail
   kernels run at 8 and 32 rows of Llama-3-8B's widths, timed cold (kernel
   and yardsticks rotate over copies of Wq | Wk | Wv and of Wo touching
   more than 100 MB; the warm figure beside it), beside two yardsticks timed
   by the same three measures: ``torch.matmul`` of the product alone and
   the port's discrete sequence they replace; then each wrapper's host µs a
   call, and edge shapes (1 and 33 rows, uneven slices of the contraction,
   hidden 384 and 1408) in bf16 and f32. The
   sliding-window (LocalMask) flash forward and backward run at Mistral-7B's
   training shape (sequence 8192, window 4096; the plain version one KV head
   at a time), beside SDPA with the band as its mask and the causal kernel
   at the same sequence, which the local one must beat; and at edge shapes
   in f32 and bf16. DeepSeek-V2-Lite's kernels: the MLA decode (B 8, H 16,
   r 512, dr 64, T 4096, bf16 buffers: ragged pos; with an allowed mask
   whose fully masked row must come out 0; phase 10's serving lengths)
   beside SDPA as MQA, both timed cold (rotating over copies of c_kv |
   k_pe touching more than 100 MB, as each layer's latent cache is cold in
   a decode step; warm beside), two launches holding the same bits, and
   untimed edge rows (8 heads, lengths at tile boundaries, B 1, a buffer
   of no whole number of tiles, small and unaligned widths, f32 buffers);
   the causal flash
   forward at q/k width 192, v width 128, beside SDPA, and rms_norm at
   width 512; the width-192 flash backward at phase 12's shape (sequence
   4096, 16 heads, V2-Lite's softmax scale) beside SDPA's backward, and at
   edge shapes (a sequence of 1000, a rectangular s_kv > s_q, an f32
   case) through the autograd Function. The FullMask (the functional API's
   ``causal=False``): forward with lse and backward at [1, 4096, 32 | 8,
   128] beside SDPA non-causal and its backward, and at edge shapes (1024 x
   4096 and 4096 x 1024, a sequence of 1000, f32). ``splash_hop`` at
   [1, 32 | 8, 4096, 128] for each kind of the ring's hops (full, causal at
   offset 0, local at offset 4096 with window 4096, whose dead row must be
   out 0 and lse -inf) beside SDPA on the hop's mask, and a local hop with
   dead rows 95-127 in f32. The training update's two kernels, which
   replace no TPU kernel (the XLA fusion of the JAX train step's update
   and clip): ``adam_update`` over one Llama-3-8B layer's tensors and a
   64 Mi-element slice of the embedding in three variants (phase 5's
   recipe: bf16 parameters, f32 masters, bf16 moments, decoupled decay;
   f32 amsgrad with L2 decay; the recipe clipped), each bit for bit
   against the plain version on the CPU from the same state (the clipped
   row given the plain scale), the plain version on the card logged
   against the CPU's bits, ``_fused_adamw_`` / ``_fused_adam_`` over f32
   copies as the yardstick; ``grad_norm`` over the depth-4 set's
   gradients (about 1.4e9 bf16 terms): the norm within 1e-5 relative of
   the plain one, two calls bit-identical, ``_foreach_norm`` and the sum
   as the yardstick.
3. The serving path at full width: Llama-3-8B (bf16, all 32 layers, random
   weights from a seeded generator on the card) behind
   ``ContinuousBatchEngine(max_batch=8, max_len=2048)``, ten greedy
   requests, served with ``FLAGS_use_fused_decode_tail`` off, on, and off
   again; then speculative decoding (k = 4, fused tail on) of eight greedy
   requests whose prompts repeat a seeded 16-token pattern. Kernel launch
   counts are zeroed just before and read just after each run; the fused
   run must launch each fused kernel 32 times per decode step and the
   norm kernels 32 times per step fewer each.
4. Wiring: two layers at full width in f32, the same weights on the card
   (kernels) and on the CPU (plain versions); greedy tokens must be
   identical card vs CPU, fused vs discrete, and speculative vs one-token,
   and the prefill logits must agree.
5. The training path at full width: the Llama-3-8B training recipe of the
   JAX package's ``bench.py`` (``_bench_config("8b")``: tied embeddings,
   chunked fused lm-head + CE, bf16 parameters, AdamW with f32 masters and
   bf16 moments, sequence 4096, batch 1) at depth 4, random weights from a
   seeded generator, one fixed random batch; ``train_step`` once to warm
   up, then 5 timed steps; one more step under ``torch.profiler`` for the
   kernels' share of the step. Launch counts are zeroed just before the
   first step and read just after the last timed one; ``adam_update``
   must run once a step (the bf16 set is one group). Step ms, peak memory
   and the profile's "other" group are logged beside the earlier figures
   (phases 8 and 12 too). Then the same run with ``recompute=True``: the
   same losses and parameters after it, bit for bit, a lower peak, and
   ``rms_norm``, ``add_rms_norm``, ``fused_rope`` and
   ``flash_attention_bshd`` launched once more per layer and step (one
   forward's count), every other kernel as often.
6. Training wiring: two layers at full width in f32, sequence 128, the
   same weights on the card and on the CPU; one ``train_step`` each; the
   losses, every gradient and every parameter after the step must agree.
7. Mistral-7B serving (after the Llama models are freed): all 32 layers,
   bf16, random weights, ``ContinuousBatchEngine(max_batch=4,
   max_len=12288)``, greedy prompts of 8192 and 2048 tokens (exact buckets:
   the LocalMask flash kernel) and 4700 and 300 (padded: the f32 einsum, as
   the JAX package), 32 new tokens each, decode through the band gather;
   fused tail off, then on. Counts zeroed before and read after each run.
8. Mistral-7B training: its widths at depth 4, sequence 8192 (above the
   window), phase 5's recipe with untied embeddings; the local kernels
   must run once per layer and step, ``adam_update`` once a step.
9. Windowed wiring, f32, card against CPU: two Mistral layers at full
   width, window 256, a 512-token prompt and 16 greedy tokens at max_len
   1024 (tokens identical, prefill logits within 1e-3); one training step
   at sequence 512, window 128, held as phase 6.
10. DeepSeek-V2-Lite serving (after the Mistral models are freed): the
   published configuration (27 layers, hidden 2048, MLA with
   kv_lora_rank 512, 64 routed experts top-6 and 2 shared, yarn RoPE),
   bf16, random weights, ``ContinuousBatchEngine(max_batch=8,
   max_len=4096)`` in latent mode; eight greedy prompts, exact buckets
   (1024, 2048: the expanded flash kernel at width 192) and padded ones
   (the absorbed einsum, as the JAX package), 64 new tokens each. The MLA
   decode kernel must run 27 times per decode step, the width-192 flash
   kernel 27 times per exact prefill, and no paged, append or width-128
   flash kernel. ``--profile`` traces 10 decode steps at 8 slots.
11. DeepSeek wiring, f32, card against CPU: two V2-Lite layers at full
   width (one dense, one MoE), an exact and a padded prompt, 8 greedy
   tokens each: tokens identical, prefill logits within 1e-3.
12. DeepSeek-V2-Lite training: its published widths at depth 4 (layer 0
   dense, three MoE layers; untied, vocab 102400), sequence 4096 (its
   pretraining length), batch 1, chunked fused lm-head + CE, bf16
   parameters; phase 5's AdamW with DeepSeek-V2's beta2 0.95 and
   global-norm clip 1.0, and a linear warm-up to 3e-4 cut to 2 steps so
   the loss can fall within the run. The width-192 flash forward and
   backward kernels must run once per layer and step, ``adam_update``
   and ``grad_norm`` once a step; every parameter
   gets a gradient, the first loss is within 5% of ln V + std^2 / 2 and
   the loss falls. One more step is profiled.
13. DeepSeek training wiring, f32, card against the card's own plain
   route: two V2-Lite layers at full width, sequence 128, three steps of
   phase 12's recipe (clip and schedule included, the warm-up starting at
   1e-4 so that every step updates, a fresh batch each step), the plain
   side (every kernel, the update and the clip's norm as their plain
   versions, launching nothing) taking the kernels' side's weights and
   optimizer state before each step; each step's loss, gradients and
   parameters held as phase 6 holds them.
14. The Paddle flash-attention functional API at Llama-3-8B's attention
   width, bf16: ``nn.functional.flash_attention(causal=False)`` forward and
   backward at sequence 4096, ``flash_attn_unpadded`` over segments 2048,
   1024, 512, 384 and 200 (the last one the plain composite, as in JAX),
   ``memory_efficient_attention`` at 32 heads; each held against its plain
   version. ``flash_attention_full`` must run once per supported call or
   segment and ``flash_attention_full_bwd`` once per backward.
15. Ring attention on one card: degree 4, local sequence 4096 (global
   16384), 32 | 8 heads, bf16, ``ring_attention(impl="auto")`` causal,
   non-causal and with window 4096; ``splash_hop`` must run once per live
   hop (4, 4, 2; the ranks folded into the batch) and each result agree
   per element with the whole-sequence flash kernel at 16384. The hops
   alone are timed beside the ring. Then the ring's gradients at local 1024
   (global 4096) in f32 against the plain whole-sequence gradients.
16. ``generate`` at full width, bf16, greedy, no eos, on the models phases
   3 and 10 built (run before each is freed), each run's launch counts
   required exactly: Llama-3-8B (a) B 4 x 512, 32 new tokens, (b) paged,
   page 16, (c) right-padded to 1024 (lengths 1024, 700, 257, 33), (d) B 4
   x 1024 in chunks of 256 (chunk 0 on the flash kernel, then append
   attention), (e) B 2 x 512, 4 beams, 16 new tokens, (f) run a with the
   fused decode tail; DeepSeek-V2-Lite (g) B 4 x 512, 16 new tokens
   (``mla_decode`` over the dense latent buffer), ``paged=True`` refused
   before any launch. Each logs prefill ms, decode ms per forward,
   tokens/s and peak memory; the token agreement of runs a-d and f with
   ``ContinuousBatchEngine`` on the same prompts is reported. Then (after
   phase 15) the f32 wiring check, ``allow_tf32`` off: two layers at full
   width of Llama-3-8B, Mistral-7B (window cut to 32, narrower than the
   run) and DeepSeek-V2-Lite, greedy tokens of the card's dense, ragged,
   paged, chunked, no-cache and 4-beam runs = the CPU's (its dense, ragged,
   chunked and 4-beam runs; paged and no-cache against its dense), and the
   engine's tokens = solo ``generate`` on the card; and ``entry.py``'s forward on the card
   (the flash kernel at width 64 once per layer, logits against the CPU's).
17. Graphs (run inside phases 3 and 10, before each model is freed).
   Every step unit the main paths call is a CUDA graph: captured at its
   first call per input signature, replayed at every call
   (``paddle_tpu_torch/jit/cuda_graph.py``), so phases 3, 4, 7, 9, 10,
   11 and 16 run graphed, and the f32 wiring checks hold the card's
   graphs against the CPU's eager bodies. Phase 17 holds the graphs
   against the same runs through the eager bodies (``unit.eager``):
   phase 3's engine runs (tail off and on, tokens and launch counts;
   speculative k = 4), phase 10's latent engine, phase 16's runs a, b, d,
   e, f and g, a penalised ``generate`` (the forward-only unit) and a
   seeded sampled engine (engine-wide settings, then per-row overrides)
   must give identical tokens. It logs each unit's captures, replays and
   capture seconds and the model's graph pool, the decode ms a forward of
   runs a, f and g graph against eager in turns, and the wall ms of a
   decode step graph against eager in turns (3 pairs of 10 steps) beside
   each one's busy ms from ``torch.profiler`` (a trace of 5 steps) and
   the busy share: Llama-3-8B
   at 8 x 512, tail off and on, and DeepSeek-V2-Lite at 8 x 1024. Each
   traced run holds the launches the wrappers counted against the kernels
   the trace shows, by kernel name (``traced_run``), exactly for the
   graphs: inside replays the counts are the capture's, added at each
   replay (an eager difference is logged). Run a's
   batch at a second prompt length with the same max_len must capture no
   second decode graph, and the graph pool must grow by less than one
   set of its dense caches (the prefill writes kept buffers in place).
   Phase 7 logs Mistral-7B's units and its graph pool after both engine
   runs, beside the memory reserved and the engine's KV pool.
   Phase 2 also holds the paged kernel untimed at the groups that are not
   powers of two (3, 5, 6, 7; f32 and bf16, the edge lengths), the splash
   forward at [1, 4096, 20 | 4, 128] causal and append attention at one
   query a row (B 4, pos 1040 of 1056), both at group 5 beside SDPA, and
   ``rms_norm`` at width 128 over 8 x 1024 x 32 rows (Qwen3-MoE's
   per-head q norm at a 1024-token prefill) beside ``F.rms_norm``.
18. ``MoELayer`` at d_model 4096, 64 experts of hidden 1536: for each gate
   (naive, GShard, Switch) and grouped expert kind (swiglu, gelu), the
   card against the CPU in f32 at 512 tokens (output and every gradient
   within 1e-4 of its tensor's largest, the gate's and experts' non-zero),
   then 8192 tokens on the card in f32 and bf16 with the gates' random
   draws on, forward and backward timed; a list of 4 expert modules
   (d_model 1024, hidden 2048, 2048 tokens) the same way;
   ``forward_ragged`` against ``forward_expert_batch`` on the card;
   ``global_gather`` of ``global_scatter`` the identity.
19. ERNIE-4.5-21B-A3B at the published shape, no cut (bf16, random seeded
   weights, the selection bias drawn too): phase 3's ten requests through
   the paged engine (8 slots, max_len 2048) with exact launch counts
   (``paged_attention`` once a layer and decode step, at group 5), the
   same run on the eager bodies (tokens and counts equal), ``generate``
   dense and paged (B 4 x 512, 32 new, counts exact), the engine against
   solo ``generate`` (the first token of each exact-bucket prompt equal,
   the rest reported), the units and the peak memory.
20. Qwen3-30B-A3B (depth cut 48 -> 16), Qwen1.5-MoE-A2.7B (whole) and
   Mixtral-8x7B (depth cut 32 -> 4) at full width, bf16: three requests
   through the paged engine and ``generate`` dense and paged (B 4 x 512,
   16 new), counts exact, the engine against solo ``generate`` as in 19.
21. Two layers of each of the four families at full width in f32, the
   same weights on the card and the CPU, a 64-token prompt through the
   one-slot engine: tokens identical, the prefill and first decode step's
   logits within 1e-3; the engine's tokens equal solo ``generate``'s.
22. The engine's scheduler, bundles and OOM degrade (runs inside phases 3
   and 10 on their models, before each is freed; its wiring after phase
   16's): on Llama-3-8B (bf16, 32 layers) the prefix cache (8 slots,
   ``max_len`` 2048: a 1024-token prefix + 200 decoding while the same
   prefix + 150, 300 and 600 arrive; each hit copies 64 pages and
   prefills its suffix on append attention at pos 1024; admission ms
   against the cache off), chunked prefill (seven live 512-token requests,
   then 1792 tokens in chunks of 256; the worst step wall while the chunks
   land against the step that admits it whole), preemption (4 slots of
   priority-2 requests of 1000 tokens, a priority-0 arrival evicts one to
   the host after 30 steps: 256 MiB bundles; preempt and restore ms, the
   CRC apart), migration and handoff between two engines on the model
   (bundle MiB, ms, decode captures and the graph pool), and a real OOM
   (a ballast from ``torch.cuda.mem_get_info()`` leaves 64 MiB, so a
   2048-bucket admission raises ``torch.cuda.OutOfMemoryError``: the
   request is shed with ``where="oom"``, ``max_active_slots`` 4 -> 3, the
   others finish with the tokens of a run without the OOM); on
   DeepSeek-V2-Lite (latent mode, 8 slots, ``max_len`` 4096) the prefix
   cache with chunks of 512. Launch counts exact: append attention L a
   suffix chunk or padded prefill, the flash kernel L an exact one,
   ``paged_attention`` / ``mla_decode`` L a decode step. Then the f32
   wiring at two layers of Llama-3-8B and DeepSeek-V2-Lite, on the card
   token for token: prefix-cached = uncached, chunked = monolithic (both
   layouts), preempted and restored = never preempted, migrated = stayed,
   handed off = prefilled locally (paged), each = the CPU's run without
   the feature. Phase 2 holds
   append attention at the suffix shape (S 256, pos 1024, T 1280, 1224
   columns allowed) against its plain version, SDPA with the mask beside.
23. The autotune search and ``speculative_generate`` (last, on a fresh
   Llama-3-8B, bf16, 32 layers), ``FLAGS_use_autotune`` on and the cache
   at a fresh file in a temporary directory: (a) each hooked kernel swept
   eagerly before any unit is built (``rms_norm`` at 8 rows of 4096 and
   262,144 of 128, the decode tail at 8 rows, the MLA decode at B 8, H
   16, r 512, T 4096): its cost table, every measured candidate against
   the plain version at its row's tolerance, the default's and the
   winner's profiled ms; (b) an engine with ``speculative_k="auto"`` (8
   slots): the measured k table, the chosen k (the best ms over expected
   retired tokens), eight prompts that repeat a pattern, tokens against
   ``generate`` reported (bf16); (c) the decode tail swept at the verify
   chunk's rows, then a second engine (fused tail on) and a second sweep
   at (a)'s shapes: every search ends at the cache (the stage counts) and
   the captured verify launches the winning split; (d)
   ``speculative_generate`` (prompt 128, 64 new, k 4) with a
   Llama-3.2-1B-shaped draft (published config, random weights) and
   with the target as its own draft: ms and tokens a round against
   ``generate``'s ms a token, append attention exactly L_target + k x
   L_draft a round; (e) f32 at two layers (the draft at one): card = CPU
   = ``generate`` tokens, the engine's ``"auto"`` = solo ``generate``.
   Phase 2 also holds the flash backward at the entry's heads ([1, 4096,
   8 | 4, 64]), and phase 16 trains the entry config on the card (one
   bf16 step, the (64, 64) backward once a layer; an f32 step card =
   CPU).
24. The HTTP front-end and the engine's observability (after phase 23's
   sweeps and ``speculative_generate``, on its Llama-3-8B, bf16, 32 layers,
   ``FLAGS_use_autotune`` off; its f32 wiring before phase 23's): a
   ``CompletionServer`` over the engine (8 slots, ``max_len`` 2048, page
   16) on 127.0.0.1, which turns on the tracer, the flight recorder, the
   step profiler, the KV atlas and the sentinel. (a) Eight concurrent
   clients, 512-token prompts, 32 new greedy tokens, fused tail off and
   then on: tokens = the same engine driven directly, launch counts exact
   (the flash kernel L a prefill, ``paged_attention`` L a decode step, the
   fused tail's two kernels L a step with the flag on); (b) one SSE
   stream: its tokens in order, ``[DONE]`` last; (c) ``n`` 2 with logprobs,
   a stop id, priority + ``slo_ms`` + ``X-Request-Deadline``, and a client
   that resets its connection mid stream (the engine's ``cancelled``); (d)
   ``X-Audit: 1`` on a request whose reference replay runs on the audit
   worker while the engine thread captures a cold bucket (1000 tokens,
   bucket 1024; both intervals logged, the bf16 verdict and drift
   reported); (f) two padded prompts (append attention L a prefill,
   counts exact); (e) /metrics' admitted counter = the requests sent,
   /health, /v1/models, /profile's phases, /kvstate's capacity = the
   pool's bytes, a ``traceparent`` echoed with its trace id and its spans
   on /trace; (g) time to first token over HTTP (SSE) against the
   engine's own admission, and the graphed decode step's wall at 8 slots
   with the tracer and recorder off and on, in turns. Then the f32 wiring
   (two layers of Llama-3-8B): HTTP tokens = the CPU port's ``generate``
   = the card's ``generate``; an ``X-Audit: 1`` request passes; with
   ``FLAGS_perturb_decode_token`` on an audited request diverges, its
   bundle is sealed, and ``replay_bundle`` blames the drill.
25. Gemma and Gemma2 (last, after phase 24's model is freed; the memory
   still allocated is printed first): Gemma-7B at its published shape,
   no cut (28 layers, hidden 3072, 16 | 16 heads x 256, GeGLU 24576,
   vocab 256000, tied head, (1 + w) norms with w drawn N(0, 0.1)), bf16:
   phase 3's ten requests through the engine (8 slots, ``max_len`` 2048,
   graphed) with the fused tail off, on and off again, launch counts
   exact (a forward: ``rms_norm`` L + 1, ``add_rms_norm`` L; an exact
   prefill ``flash_attention_256`` L, a padded one
   ``append_attention_256`` L, a decode step ``paged_attention_256`` L,
   with the tail ``fused_qkv_rope`` / ``fused_epilogue`` L each and the
   norms L fewer), each prefill's ms (the time to first token) and the
   decode ms a step; ``generate`` dense and paged (B 4 x 512, 32 new;
   dense decode on ``append_attention_256``), counts exact; the engine
   against solo ``generate``. Gemma2-9B at full width, depth 42 -> 8 (16
   | 8 heads x 256, hidden 3584, caps 50 and 30, window 4096 on even
   layers): three requests and ``generate`` dense and paged with no
   attention kernel (the capped routes: the dense einsum, the paged
   gather reference) and ``rms_norm`` 4 L + 1 a forward. Then the f32
   wiring at two layers of each: ``generate`` card = CPU = paged, the
   engine = solo ``generate``. Phase 2 holds the kernels at Gemma's
   widths (``check_width256_rows``): the causal flash forward at [1,
   4096, 16 | 16, 256] beside SDPA, append attention at the engine's
   padded prefill (S = T = 1024, 700 valid columns) and at one query a
   row (B 4, pos 1040 of 1056, 16 | 16 x 256, cold, with no column mask
   and with the padded prompts' mask), paged decode at D 256,
   groups 1 and 8 (and the edge lengths, f32; cold), the decode tail at 8
   and 32 rows of hidden 3072, 16 | 16 x 256, and ``rms_norm`` /
   ``add_rms_norm`` at 3072 and 3584; phase 1 prints each width-256
   instance's registers, spills and HMMA count.
26. Gemma training at head width 256 (last, after phase 25's models are
   freed): (a) Gemma-2B at its published shape, no cut (google/gemma-2b:
   18 layers, hidden 2048, 8 | 1 heads x 256, GeGLU 16384, vocab 256000,
   tied head; 2.51B parameters), bf16 with phase 5's recipe (f32 masters,
   bf16 moments through ``adam_update``, the chunked fused lm-head + CE),
   one sequence of 4096 tokens: 3 steps of ``train_step``, launch counts
   exact (a step: ``rms_norm`` L + 1, ``add_rms_norm`` L, ``fused_rope``
   2 L, ``flash_attention_256`` and ``flash_attention_bwd_256`` L,
   ``adam_update`` 1), losses finite and falling from the first, step
   ms, tokens/s, peak memory and one profiled step's busy share; (b) the
   f32 wiring at two layers: Gemma-7B's widths card = CPU, one step (the
   (256, 256) kernels; gradients within 3e-4 of each tensor's largest,
   and within 1e-4 of the card's own plain route, ``gemma_train_wiring``
   says why), and Gemma2-9B's widths, two steps against the card's own
   plain route (``train_plain_check``: the capped scores' plain backward,
   the sandwich norms, the soft-capped loss, and the second step's update
   from non-zero moments; a CPU side would take about 35 s a step, so
   the full run keeps to its time); (c) ``FLAGS_check_nan_inf`` at
   Gemma-2B's widths, depth 4: a step with a NaN weight, and one with an Inf in a moment,
   raises and leaves every parameter and optimizer state bit alone, a
   clean step passes, and a step's wall with the flag off and on in
   turns. Phase 2 holds the (256, 256) backward
   (``check_width256_training_rows``): causal at [1, 4096, 16 | 16, 256]
   and [1, 4096, 8 | 1, 256] (the kernels line's row), local at W 1024
   and full at 16 | 16, each beside SDPA's backward, with its bound; its
   edge shapes in bf16 and f32 (S 1000, s_q 200 < s_kv 700, [1, 130 |
   300, 4]); the local and full forward and ``splash_hop`` at 256;
   ``fused_rope`` at [1, 4096, 8, 256]. Phase 1 prints the backward's
   width-256 instances' registers, spills and HMMA count.
27. The dense Llama-trunk families and GPT-2 (last, after phase 26's
   models are freed; ``--families-only`` runs phase 1, the phase 2 rows
   below and this phase), bf16, random seeded weights, each sub-phase
   timed and its model freed, launch counts worked out from the code and
   required exactly (``dense_counts_want``): (a) Phi-3-mini-128k at its
   published shape, no cut (32 layers, hidden 3072, 32 | 32 heads x 96,
   SwiGLU 8192, vocab 32064, untied; longrope over 4096 of 131072
   positions, its 48 + 48 factors drawn from a seed: the published lists
   are not in the repository): phase 3's ten requests through the engine
   (8 slots, ``max_len`` 2048: the short factors), graphed, a forward
   ``rms_norm`` L + 1 and ``add_rms_norm`` L, no attention kernel in a
   prefill (width 96 takes the plain route, as JAX's gates), a decode step
   ``paged_attention_96`` L; each prefill's ms (the time to first token)
   and the decode ms a step; ``generate_paged`` at B 1 over 4200 prompt
   tokens (the long factors; the tables checked against their factor
   lists); ``generate`` dense (no attention kernel) and paged, B 4 x 512;
   the engine against solo ``generate``. (b) GPT-2 XL whole (48 layers,
   hidden 1600, 25 heads x 64, vocab 50257, 1024 positions): the engine at
   ``max_len`` 1024 on phase 3's requests that fit it (``paged_attention_64``
   L a step, the (64, 64) flash forward L an exact prefill, append
   attention L a padded one; no norm kernel: LayerNorm is plain PyTorch),
   ``generate`` dense (the (64, 64) append attention at S 1) and paged,
   the engine against solo ``generate``. (c) Qwen2.5-0.5B whole (24
   layers, hidden 896, 14 | 2 heads x 64, tied): the same on phase 3's
   requests, ``paged_attention_64`` at group 7. (d) Qwen2.5-7B, Qwen3-8B,
   GLM-4-9B on the GLM trunk and on the GLM-4 trunk (sandwich norms) and
   OLMo2-7B at full width, depth cut to 4: phase 20's three requests,
   ``generate`` dense and paged, the engine against solo ``generate``.
   (e) The f32 wiring at two layers of each of the eight: ``generate``
   card = paged and the engine (2 slots) = solo ``generate`` on the card;
   for six of them also card = CPU, with the prefill logits card vs CPU
   within 1e-3 (the two GLM trunks run the same kernels at the same
   widths as Qwen2.5-7B and OLMo2-7B, so their CPU sides are left out for
   time, ``DENSE_CARD_ONLY``). With ``--profile``, (b) and (c) trace 10
   decode steps at 8 slots of 512-token prompts (``profile_decode``). Phase 2 holds paged decode at
   D 96 (32 | 32; the kernels line's row) and D 64 (25 | 25, the kernels
   line's row, and 14 | 2) at the main lengths, cold, with the edge shapes
   at both widths (f32, the edge lengths with a dead row, page sizes 8
   and 32, B 1), and append attention at (64, 64), one query a row (B 4,
   25 | 25, pos 1040 of 1056, cold), each beside SDPA with its bound;
   phase 1 prints the D 64 and D 96 instances' registers, spills and HMMA
   count (their own source, ``paged_attention_narrow.cu``).
28. DeepSeek-V3 (last, after phase 27's models are freed;
   ``--deepseek-v3-only`` runs phase 1, phase 2's MLA rows at 128 and 24
   heads and this phase) at its published widths (deepseek-ai/DeepSeek-V3
   config.json, ``deepseek_v3_config``: vocab 129280, hidden 7168, 128
   heads, q LoRA 1536 with ``q_a_layernorm``, kv LoRA 512, qk 128 + 64, v
   128, 256 routed experts of 2048 and 1 shared, 8 a token in 8 groups of
   which 4, sigmoid scores with the correction bias, scaling 2.5, yarn
   factor 40 with mscale and mscale_all_dim 1.0, untied, one MTP depth),
   bf16, random weights drawn on the card. Cuts, logged: depth 61 -> 4
   (the three dense layers and one MoE layer) plus the MTP depth (an MoE
   block), 26.7 B parameters, the count worked out from the code and
   checked (``v3_parameters``); ``moe_capacity_factor`` 256 / 8 = 32, the
   capacity the token count (the published model drops no route; at 2.0
   one decode row gets capacity 1 and MTP's 2-token verify would drop
   routes one-token decode keeps). (a) The latent engine, 8 slots of
   ``max_len`` 1024, eight prompts of 64-512 tokens (five exact buckets),
   32 new tokens each, graphed: a forward ``rms_norm`` 3 L + 1 and
   ``add_rms_norm`` L, ``flash_attention_mla`` L an exact prefill (128
   heads at (192, 128)), ``mla_decode`` L a decode step (128 heads), no
   other attention kernel, all exact (``v3_counts_want``); each prefill's
   ms, decode ms a step, the time to first token at 64 and 512 tokens
   with the bucket warm and at its first admission; the engine against
   solo ``generate`` (each exact bucket's first token equal). (b)
   ``mtp_speculative_generate``, batch 1, a 512-token prompt, 64 new
   tokens: rounds, hits, acceptance (random weights: no measure of a
   trained draft), ms a round beside the prefill's, peak memory, launches
   exact (``mtp_run``: ``mla_decode`` once for each round that starts from
   one pair, none in the 2-token verify); its tokens against greedy
   ``generate``'s on the card, the first divergent position and the top-2
   logit gap there reported (bf16: the verify's einsums against the decode
   kernel). (c) The f32 wiring at V3's widths, experts cut to 32 (n_group
   8 kept) and depth to one dense layer, one MoE layer and the MTP depth:
   the kernel route against the card's own plain route (``plain_kernels``
   with the units eager, launching nothing): logits within 1e-3, and
   ``generate`` and ``mtp_speculative_generate`` greedy tokens identical
   on both routes. Phase 2 holds the MLA decode at 128 heads
   (``check_mla_head_rows``: B 8, r 512, dr 64, T 4096, the main row's
   lengths, bf16 and f32, cold and warm, the dead-row rule, SDPA as MQA
   beside; the bound by the bytes against the products with q and P as
   hi + lo terms) and at 24 heads (a half-full head tile) in bf16 the
   same way and among its edges in bf16 and f32,
   and the width-192 flash forward at 128 heads (``check_flash_mla_128_row``:
   q [1, 512, 128, 192], v 128, causal, V3's softmax scale, SDPA beside).
29. The HuggingFace checkpoint bridge (last, after phase 28's models are
   freed; ``--hf-bridge-only`` runs phase 1 and this phase), bf16, random
   weights drawn on the card, each HF-layout state dict moved to the host
   as a checkpoint arrives there, each config a dict of the published
   ``config.json`` fields written here; the source model's engine tokens
   on phase 20's three requests (512, 300 and 1024 tokens, 16 new each;
   graphed, launch counts exact), then the converted model's: tokens
   identical, counts exact, every parameter bit-equal. (a) Llama-3-8B
   whole (meta-llama/Meta-Llama-3-8B's fields): ``llama_to_hf`` to the
   host, the source freed, ``llama_from_hf(state, LLAMA3_8B_JSON)`` onto
   the card (its config = ``LlamaConfig.llama3_8b``), each parameter
   against its checkpoint tensor moved to the card one at a time; a
   forward ``rms_norm`` L + 1 and ``add_rms_norm`` L, the flash kernel L
   an exact prefill, append attention L a padded one, ``paged_attention``
   L a decode step (``serving_counts_want``). (b) Phi-3-mini-128k whole
   (phase 27's shape; microsoft/Phi-3-mini-128k-instruct's fields with
   phase 27's seeded longrope lists): its fused layout built here (q | k
   | v rows into ``qkv_proj``, gate | up into ``gate_up_proj``),
   ``phi3_from_hf``; no attention kernel in a prefill,
   ``paged_attention_96`` L a decode step. (c) DeepSeek-V2-Lite at its
   published widths, depth cut 27 -> 4 (the dense layer and three MoE
   layers; logged): its layout built here (q_pe rows and the k_pe tail
   interleaved again, the experts split per expert),
   ``deepseek_from_hf(FakeHF(state, V2_LITE_JSON), config=<the bf16
   config>)`` (the config ``V2_LITE_JSON`` maps to checked equal), the
   latent engine; a forward ``rms_norm`` 2 L + 1 and ``add_rms_norm`` L,
   ``flash_attention_mla`` L an exact prefill, ``mla_decode`` L a decode
   step. Each load logs its seconds, the host -> device GB/s over the
   model's bytes, the peak device memory against the model's bytes and
   the host's peak resident set against its value before (sampled every
   2 ms); (a) also ``llama_to_hf``'s seconds and device -> host GB/s.
30. The kernels line, then the card line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package. It exits with
code 2 and prints no result when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
# dense tensor-core bf16; float32 on the CUDA cores (the MLA decode's f32
# body; its bf16 body multiplies on the tensor cores)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas/fused_norm.py:99",
    "add_rms_norm": "paddle_tpu/ops/pallas/fused_norm.py:193",
    "append_attention": "paddle_tpu/ops/pallas/append_attention.py:135",
    "flash_attention_bshd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "paged_attention": "paddle_tpu/generation.py:289",
    # Gemma's heads of 256: the same kernels' (256, 256) / D 256 instances
    "append_attention_256": "paddle_tpu/ops/pallas/append_attention.py:135",
    "flash_attention_256": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "paged_attention_256": "paddle_tpu/generation.py:289",
    # GPT-2's and Qwen2.5-0.5B's heads of 64, Phi-3's of 96: the paged
    # kernel's D 64 and D 96 instances
    "paged_attention_64": "paddle_tpu/generation.py:289",
    "paged_attention_96": "paddle_tpu/generation.py:289",
    "fused_rope": "paddle_tpu/ops/pallas/fused_norm.py:289",
    "flash_attention_bwd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    # the entry's heads of 64: the same splash backward (JAX trains them
    # through its einsum reference, llama.py:692-709)
    "flash_attention_bwd_64": "paddle_tpu/ops/pallas/flash_attention.py:122",
    # Gemma's heads of 256: the splash backward's (256, 256) instance
    "flash_attention_bwd_256": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "fused_qkv_rope": "paddle_tpu/ops/pallas/decode_tail.py:260",
    "fused_epilogue": "paddle_tpu/ops/pallas/decode_tail.py:347",
    "flash_attention_local": "paddle_tpu/ops/pallas/flash_attention.py:97",
    "flash_attention_local_bwd": "paddle_tpu/ops/pallas/flash_attention.py:97",
    "mla_decode": "paddle_tpu/ops/pallas/mla_decode.py:147",
    "flash_attention_mla": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "flash_attention_mla_bwd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "flash_attention_full": "paddle_tpu/ops/pallas/flash_attention.py:106",
    "flash_attention_full_bwd": "paddle_tpu/ops/pallas/flash_attention.py:122",
    "splash_hop": "paddle_tpu/ops/pallas/flash_attention.py:171",
    # not TPU kernels: the hand-written counterparts of the XLA fusion of
    # the JAX train step's update and clip (Adam.update, functional_clip)
    "adam_update": "paddle_tpu/optimizer/optimizer.py:245",
    "grad_norm": "paddle_tpu/optimizer/clip.py:62",
}
SOURCES = {
    "rms_norm": "paddle_tpu_torch/csrc/fused_norm.cu",
    "add_rms_norm": "paddle_tpu_torch/csrc/fused_norm.cu",
    "append_attention": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_bshd": "paddle_tpu_torch/csrc/append_attention.cu",
    "paged_attention": "paddle_tpu_torch/csrc/paged_attention.cu",
    "append_attention_256": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_256": "paddle_tpu_torch/csrc/append_attention.cu",
    "paged_attention_256": "paddle_tpu_torch/csrc/paged_attention.cu",
    "paged_attention_64": "paddle_tpu_torch/csrc/paged_attention_narrow.cu",
    "paged_attention_96": "paddle_tpu_torch/csrc/paged_attention_narrow.cu",
    "fused_rope": "paddle_tpu_torch/csrc/fused_norm.cu",
    "flash_attention_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_64": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_256": "paddle_tpu_torch/csrc/flash_attention.cu",
    "fused_qkv_rope": "paddle_tpu_torch/csrc/decode_tail.cu",
    "fused_epilogue": "paddle_tpu_torch/csrc/decode_tail.cu",
    "flash_attention_local": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_local_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "mla_decode": "paddle_tpu_torch/csrc/mla_decode.cu",
    "flash_attention_mla": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_mla_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_full": "paddle_tpu_torch/csrc/append_attention.cu",
    "flash_attention_full_bwd": "paddle_tpu_torch/csrc/flash_attention.cu",
    "splash_hop": "paddle_tpu_torch/csrc/append_attention.cu",
    "adam_update": "paddle_tpu_torch/csrc/adam_update.cu",
    "grad_norm": "paddle_tpu_torch/csrc/grad_norm.cu",
}
# the kernels each main path must launch
SERVING_KERNELS = ("rms_norm", "add_rms_norm", "append_attention",
                   "flash_attention_bshd", "paged_attention")
TRAINING_KERNELS = ("rms_norm", "add_rms_norm", "fused_rope",
                    "flash_attention_bshd", "flash_attention_bwd",
                    "adam_update")
FUSED_KERNELS = ("fused_qkv_rope", "fused_epilogue", "paged_attention")
MISTRAL_TRAINING_KERNELS = ("rms_norm", "add_rms_norm", "fused_rope",
                            "flash_attention_local",
                            "flash_attention_local_bwd", "adam_update")
DEEPSEEK_TRAINING_KERNELS = ("rms_norm", "add_rms_norm", "flash_attention_mla",
                             "flash_attention_mla_bwd", "adam_update",
                             "grad_norm")
SPEC_K = 4
TRAIN_SEQ, TRAIN_DEPTH, TRAIN_STEPS = 4096, 4, 5
# Mistral-7B: sliding window 4096; training at 8192, above the window
LOCAL_SEQ, WINDOW = 8192, 4096
MISTRAL_LENS, MISTRAL_NEW = (8192, 2048, 4700, 300), 32
# DeepSeek-V2-Lite serving: exact buckets 2048 and 1024 (twice each), padded
# 1500, 700, 300 and 100; 64 new tokens each
DEEPSEEK_LENS, DEEPSEEK_NEW = (2048, 1024, 1500, 700, 300, 2048, 1024, 100), 64
# deepseek-ai/DeepSeek-V2-Lite config.json rope_scaling
V2_LITE_YARN = {"type": "yarn", "factor": 40, "beta_fast": 32,
                "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                "original_max_position_embeddings": 4096}


# each log line starts with the seconds since the import, so a run's log
# shows where its time went (the CPU-bound phases vary most between hosts)
_START = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - _START:6.1f}s]", *a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3):
    """Median ms of ``reps`` calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


HOST_CALLS = 2000


def host_us(fn, calls=HOST_CALLS):
    """Host µs of one call: ``calls`` calls in a row on the host clock,
    the device kept ahead of them (a host-paced row's own cost)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


# device cycles of the spin kernels around a profiled window (about 10 ms)
SPIN_CYCLES = 20_000_000


def profiled_ms(fn, calls=10):
    """Device ms of one call: the durations of every device kernel (and
    memset or copy) that ``torch.profiler`` records over ``calls`` calls,
    summed and divided by ``calls``. The kernels' own time: neither the
    host's time nor the gaps between launches count. The profiler can drop
    a session's records (a session has come back empty), which only
    lowers the sum: two sessions that each record at least one kernel a
    call are taken, up to five tried, and the larger figure stands. A
    spin kernel of about 10 ms (``torch.cuda._sleep``, not counted) runs
    before the timed calls and another after them, so that none of them
    sits at an edge of the trace's window. Late in a run, sessions have
    still come back with 9 of 10 launches each, five in a row, the same
    kernel timed in full in a fresh process: where no session recorded a
    kernel a call, a session's mean record stands for one launch a call,
    the larger of those sessions' (logged). Where no session recorded
    anything, CUDA events around ``calls`` calls in a row give the figure
    (logged)."""
    import torch

    totals, seen, partial = profile_sessions(fn, calls)
    if totals:
        return max(totals) / 1e3 / calls
    if partial:
        log(f"  profiler: no session recorded a kernel a call (device "
            f"records a session: {seen}); a session's mean record stands "
            f"for one launch a call, the larger of {len(partial)}")
        return max(total / count for total, count in partial) / 1e3
    log(f"  profiler: no device records in {len(seen)} sessions; CUDA "
        f"events around {calls} calls in a row instead")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def profile_sessions(fn, calls=10):
    """``profiled_ms``'s sessions: (the device µs of each session that
    recorded at least one kernel a call, at most two; the device records
    of each session tried; (µs, records) of each session that recorded
    fewer, but some)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    totals, seen, partial = [], [], []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "spin" not in e.key]
        seen.append(sum(e.count for e in kernels))
        total = sum(e.device_time_total for e in kernels)
        if seen[-1] >= calls:
            totals.append(total)
            if len(totals) == 2:
                break
        elif seen[-1] > 0:
            partial.append((total, seen[-1]))
    return totals, seen, partial


def kernel_times(fn, reps=20, warmup=3):
    """(median ms of one call, as ``time_ms``; back-to-back ms of one call:
    CUDA events around 10 calls in a row, divided by 10; profiled ms of
    one call, as ``profiled_ms``). Back to back, a launch queues behind the
    last one's device work only while that work outlasts the host's time
    for the next call: where the wrapper's host time exceeds the kernel's
    (rows of a few µs), the back-to-back figure is the host's pace, not
    the kernel's. The profiled figure is the kernel's own."""
    import torch

    median = time_ms(fn, reps, warmup)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(10):
        fn()
    b.record()
    b.synchronize()
    return median, a.elapsed_time(b) / 10, profiled_ms(fn)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_gqa(q, k, v, mask=None, causal=False, scale=None):
    """One library call: q [B,H,S,D], k [B,hk,T,D], v [B,hk,T,Dv] (GQA)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          is_causal=causal, scale=scale,
                                          enable_gqa=True)


# ---------------------------------------------------------------- phase 2 --

def close_bf16(out, ref, atol=2e-3, rtol=2.0 ** -7):
    """(max abs err, every |out - ref| <= atol + rtol |ref|)."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok


def make_record(results):
    """``record(...)``: logs one phase-2 row and keeps the main shape's
    figures in ``results`` by kernel name."""

    def record(name, shape, err, tol_ok, times, plain_ms, lib, bnd, main,
               warm=None):
        """``times`` and ``lib`` (None where no single PyTorch call
        computes the function) from ``kernel_times``; ``warm``: the
        profiled ms of the kernel and of the library call with their
        inputs in L2, for a row whose ``times`` and ``lib`` rotate over
        copies of them (cold)."""
        ms, dev_ms, prof_ms = times
        lib_ms, lib_dev, lib_prof = lib if lib is not None else (None,) * 3
        b_ms, b_by = bnd

        def f4(v):
            return "null" if v is None else f"{v:.4f}"

        log(f"  {name:22s} {shape:38s} max_abs_err={err:.3e} ok={tol_ok} "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} profiled_ms={prof_ms:.4f} "
            f"host_ms={ms - prof_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={f4(lib_ms)} library_device_ms={f4(lib_dev)} "
            f"library_profiled_ms={f4(lib_prof)} "
            + ("" if warm is None else
               f"warm_profiled_ms={warm[0]:.4f} warm_library_profiled_ms="
               f"{f4(warm[1])} ")
            + f"bound_ms={b_ms:.5f} ({b_by}) share={b_ms / ms:.3f} "
            f"device_share={b_ms / dev_ms:.3f} "
            f"profiled_share={b_ms / prof_ms:.3f}")
        if not tol_ok:
            raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms, device_ms=dev_ms, profiled_ms=prof_ms,
                     plain_ms=plain_ms, library_ms=lib_ms,
                     library_device_ms=lib_dev, library_profiled_ms=lib_prof,
                     l2="warm" if warm is None else "cold",
                     warm_profiled_ms=prof_ms if warm is None else warm[0],
                     bound_ms=b_ms, bound_by=b_by, shape=shape)

    return record


def check_append_prefill_rows(record, randn, cases, H=32, hk=8, D=128,
                              name="append_attention", main=None):
    """``append_attention`` at prefill shapes, ``cases`` of (S, T, pos,
    valid prompt length or None; a length gives the column mask
    ``allowed`` over its first columns), ``H`` | ``hk`` heads of ``D``,
    each held against its plain version at the attention tolerance and
    recorded as ``name`` (the case (S, T, length) ``main`` as the kernels
    line's row), with its bound and SDPA's time beside it."""
    import torch

    from paddle_tpu_torch.ops.hopper import append_attention

    dev = torch.device("cuda")
    group = "" if (H, hk, D) == (32, 8, 128) else f" {H} | {hk} x {D}"
    for S, T, pos, n_valid in cases:
        q, k, v = randn(1, S, H, D), randn(1, T, hk, D), randn(1, T, hk, D)
        allowed = None
        if n_valid is not None:
            allowed = torch.zeros(1, T, dtype=torch.bool, device=dev)
            allowed[0, :n_valid] = True
        out = append_attention.append_attention(q, k, v, pos, allowed)
        ref = append_attention.append_attention_plain(q, k, v, pos, allowed)
        err, ok = close_bf16(out, ref)
        check_device_pos(q, k, v, pos, allowed, out,
                         f"S={S} T={T} pos={pos} allowed={n_valid}{group}")
        cols = torch.arange(T, device=dev)
        vis = cols[None, :] <= (pos + torch.arange(S, device=dev))[:, None]
        if allowed is not None:
            vis = vis & allowed[0][None, :]
        # only the K/V columns some query sees must be read (the kernel
        # skips the tiles past pos + S); the mask over the reachable ones
        pairs = int(vis.sum()) * H
        n_cols = int(vis.any(0).sum())
        reach = min(T, pos + S)
        nbytes = 2 * S * H * D * 2 + 2 * n_cols * hk * D * 2 + (
            reach if allowed is not None else 0)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = vis[None, None]
        record(name, f"S={S} T={T} pos={pos} allowed={n_valid}{group}", err,
               ok, kernel_times(lambda: append_attention.append_attention(
                   q, k, v, pos, allowed)),
               time_ms(lambda: append_attention.append_attention_plain(
                   q, k, v, pos, allowed)),
               kernel_times(lambda: sdpa_gqa(qt, kt, vt, mask=mask)),
               bound(nbytes, 4 * D * pairs, "bfloat16"),
               (S, T, n_valid) == main)
        del q, k, v, qt, kt, vt, out, ref


def check_kernels(results):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.hopper import flash_attention, fused_norm

    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    record = make_record(results)

    # attention: one bf16 rounding of an f32 result whose sums ran in
    # another order; norms: two bf16 roundings (normalised value, then the
    # weight product) after an f32 value that may differ in its last bit
    log("phase 2: kernels vs plain versions (bf16; tolerance "
        "|k - p| <= 2e-3 + 2^-7 |p|, norms 1e-6 + 2^-6 |p|, rope 2^-7 |p|, "
        "lse 1e-3; attention gradients as attention, against the plain "
        "backward on the same out)")
    d = 4096
    # rows 8: a decode step at 8 slots (the kernels line's row); 4096: a
    # training step's sequence
    for rows in (8, 4096):
        x, r, w = randn(rows, d), randn(rows, d), randn(d, scale=0.5) + 1
        out = fused_norm.rms_norm(x, w, 1e-5)
        ref = fused_norm.rms_norm_plain(x, w, 1e-5)
        err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
        nbytes = 2 * rows * d * 2 + d * 2
        # a call here is host-paced: 100 single calls after 20 to warm up
        record("rms_norm", f"rows={rows} d={d}", err, ok,
               kernel_times(lambda: fused_norm.rms_norm(x, w, 1e-5), 100, 20),
               time_ms(lambda: fused_norm.rms_norm_plain(x, w, 1e-5)),
               kernel_times(lambda: F.rms_norm(x, (d,), w, 1e-5), 100, 20),
               bound(nbytes, 4 * rows * d, "bfloat16"), rows == 8)
        if rows == 8:
            log(f"  rms_norm rows={rows} d={d}: host us a call, {HOST_CALLS} "
                f"calls in a row on the host clock: the wrapper "
                f"{host_us(lambda: fused_norm.rms_norm(x, w, 1e-5)):.2f}, "
                f"F.rms_norm "
                f"{host_us(lambda: F.rms_norm(x, (d,), w, 1e-5)):.2f}")
        o, h = fused_norm.add_rms_norm(x, r, w, 1e-5)
        ro, rh = fused_norm.add_rms_norm_plain(x, r, w, 1e-5)
        err, ok = close_bf16(o, ro, atol=1e-6, rtol=2.0 ** -6)
        ok = ok and torch.equal(h, rh)
        nbytes = 4 * rows * d * 2 + d * 2
        record("add_rms_norm", f"rows={rows} d={d}", err, ok,
               kernel_times(lambda: fused_norm.add_rms_norm(x, r, w, 1e-5),
                            100, 20),
               time_ms(lambda: fused_norm.add_rms_norm_plain(x, r, w, 1e-5)),
               None, bound(nbytes, 5 * rows * d, "bfloat16"), rows == 8)

    # (S, T, pos, valid prompt length or None): prefill buckets of the
    # serving path (padded ones carry `allowed`) and one chunk at pos > 0
    check_append_prefill_rows(record, randn, [
        (128, 128, 0, 100), (512, 512, 0, 300), (1024, 1024, 0, 700),
        (128, 1024, 500, None),
        # the engine's prefix-cached suffix prefill (phase 22): a 200-token
        # suffix in its 256 bucket at pos 1024, the column mask over 1224
        # of the 1280 columns
        (256, 1280, 1024, 1224)], main=(1024, 1024, 700))
    check_append_decode_rows(record)

    H, hk, D, S = 32, 8, 128, 512
    q, k, v = randn(1, S, H, D), randn(1, S, hk, D), randn(1, S, hk, D)
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True)
    err, ok = close_bf16(out, ref)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    record("flash_attention_bshd", f"S={S} causal", err, ok,
           kernel_times(lambda: flash_attention.flash_attention_bshd(
               q, k, v, causal=True)),
           time_ms(lambda: flash_attention.flash_attention_plain(
               q, k, v, causal=True)),
           kernel_times(lambda: sdpa_gqa(qt, kt, vt, causal=True)),
           bound(2 * S * (H + hk) * D * 2, 4 * D * H * S * (S + 1) // 2,
                 "bfloat16"), True)

    check_norm_edges()
    check_paged_rows(record)
    check_paged_groups()
    check_group5_rows(record, randn)
    torch.cuda.empty_cache()
    check_width256_rows(record, randn)
    check_width256_training_rows(record, randn)
    torch.cuda.empty_cache()
    check_dense_family_rows(record)
    torch.cuda.empty_cache()
    check_decode_tail_kernels(record)
    check_training_kernels(record, randn)
    torch.cuda.empty_cache()
    # the sliding-window kernels: edge shapes, then Mistral-7B's training
    # shape
    check_local_edges()
    check_flash_rows(record, randn, LOCAL_SEQ, WINDOW)
    torch.cuda.empty_cache()
    check_deepseek_kernels(record, randn)
    torch.cuda.empty_cache()
    # the full mask (the functional API) and the ring hop
    t0 = time.perf_counter()
    check_full_edges()
    check_flash_rows(record, randn, TRAIN_SEQ, None, full=True)
    torch.cuda.empty_cache()
    check_hop_rows(record, randn)
    torch.cuda.empty_cache()
    log(f"  the full-mask and splash_hop rows took "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    check_update_rows(record)
    log(f"  the update rows took {time.perf_counter() - t0:.1f}s")


# generate's dense decode: B 4 rows at pos 1040 of a T 1056 buffer (the
# right-padded run's prompts of 1024, 700, 257 and 33 tokens, 16 tokens in)
DECODE_B, DECODE_POS, DECODE_T = 4, 1040, 1056
DECODE_PROMPTS = (1024, 700, 257, 33)
# bytes each timed call of a decode row's rotation must touch in all, so
# that no call finds its buffer in the 50 MB L2
DECODE_COLD_BYTES = 120e6


def check_device_pos(q, k, v, pos, allowed, out, label):
    """``append_attention`` with ``pos`` as a device int32 (the dense
    caches' ``pos``, read by the kernel at entry through ``pos_dev``):
    against its plain version at the attention tolerance, and the same
    bits as the launch with the host int ``pos`` (``out``)."""
    import torch

    from paddle_tpu_torch.ops.hopper import append_attention

    pos_t = torch.tensor(pos, dtype=torch.int32, device=q.device)
    got = append_attention.append_attention(q, k, v, pos_t, allowed)
    err, ok = close_bf16(got, append_attention.append_attention_plain(
        q, k, v, pos_t, allowed))
    same = bool(torch.equal(got, out))
    log(f"  append_attention {label}, device pos: max_abs_err={err:.3e} "
        f"ok={ok}; the host int's bits: {same}")
    if not (ok and same):
        raise AssertionError(f"append_attention {label}: the device pos "
                             "disagrees")


def check_append_decode_rows(record, H=32, hk=8, masked=True, D=128,
                             name="append_attention", main=False):
    """``append_attention`` at the dense decode shape of ``generate`` (S 1,
    B 4, ``H`` | ``hk`` heads of ``D``, pos 1040 of T 1056), with no column
    mask and, where ``masked``, with run c's ``allowed`` (each row's
    prompt, then the decode columns from 1024), held against its plain
    version at the attention tolerance; recorded as ``name`` (the
    unmasked row as the kernels line's where ``main``).
    Timed cold, as on the main path, where each of 32 layers has its own
    buffer and a decode step finds it out of L2: the kernel and its
    yardstick (SDPA with the visibility as a boolean mask, over K / V laid
    out [B, hk, T, D] beforehand) rotate over copies of the buffers
    touching more than ``DECODE_COLD_BYTES``; the warm figure (one copy)
    beside it."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import append_attention

    dev = torch.device("cuda")
    bf = torch.bfloat16
    B, T, pos = DECODE_B, DECODE_T, DECODE_POS
    group = "" if (H, hk) == (32, 8) else f" G={H // hk} ({H} | {hk})"
    if D != 128:
        group += f" D={D}"
    gen = torch.Generator(dev).manual_seed(4242)
    cols = torch.arange(T, device=dev)
    padded = torch.stack([(cols < n) | (cols >= 1024)
                          for n in DECODE_PROMPTS])
    for allowed in (None, padded) if masked else (None,):
        vis = (cols <= pos)[None, :].expand(B, T)
        if allowed is not None:
            vis = vis & allowed
        n_vis = int(vis.sum())
        copies = max(4, math.ceil(DECODE_COLD_BYTES / (B * T * hk * D * 4)))
        q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(bf)
        bufs = [tuple(torch.randn(B, T, hk, D, generator=gen,
                                  device=dev).to(bf) for _ in range(2))
                for _ in range(copies)]
        k, v = bufs[0]
        out = append_attention.append_attention(q, k, v, pos, allowed)
        ref = append_attention.append_attention_plain(q, k, v, pos, allowed)
        err, ok = close_bf16(out, ref)
        check_device_pos(q, k, v, pos, allowed, out, f"decode B={B} pos={pos}"
                         + (" allowed" if allowed is not None else ""))
        qt = q.transpose(1, 2).contiguous()
        lib_bufs = [tuple(t.transpose(1, 2).contiguous() for t in kv)
                    for kv in bufs]
        mask = vis[:, None, None, :]
        turn = iter(range(1 << 62))

        def kernel(i=None):
            kk, vv = bufs[next(turn) % copies if i is None else i]
            return append_attention.append_attention(q, kk, vv, pos, allowed)

        def library(i=None):
            kk, vv = lib_bufs[next(turn) % copies if i is None else i]
            return sdpa_gqa(qt, kk, vv, mask=mask)

        # every visible K and V column of each row read once, q read and
        # out written once, the mask up to pos
        nbytes = (n_vis * hk * D * 2 * 2 + 2 * B * H * D * 2
                  + (B * (pos + 1) if allowed is not None else 0))
        warm = (profiled_ms(lambda: kernel(0)), profiled_ms(
            lambda: library(0)))
        label = f"decode S=1 B={B} T={T} pos={pos} allowed=" + (
            "None" if allowed is None
            else "prompts " + "/".join(map(str, DECODE_PROMPTS)))
        log(f"  append_attention {label}: {copies} copies, {n_vis} visible "
            "columns")
        record(name, label + group + " cold", err, ok,
               kernel_times(kernel),
               time_ms(lambda: append_attention.append_attention_plain(
                   q, k, v, pos, allowed)),
               kernel_times(library), bound(nbytes, 4 * D * H * n_vis,
                                            "bfloat16"),
               main and allowed is None, warm=warm)
        del q, bufs, lib_bufs, k, v, out, ref
    torch.cuda.empty_cache()


def check_norm_edges():
    """``rms_norm`` off its timed rows: widths 512, 2048 and 4096 at 1, 8
    and 4096 rows, in bf16 and f32, each against its plain version at the
    norms' tolerance."""
    import torch

    from paddle_tpu_torch.ops.hopper import fused_norm

    gen = torch.Generator("cuda").manual_seed(99)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (512, 2048, 4096):
            for rows in (1, 8, 4096):
                x = torch.randn(rows, d, generator=gen, device="cuda").to(
                    dtype)
                w = (torch.randn(d, generator=gen, device="cuda") * 0.5
                     + 1).to(dtype)
                out = fused_norm.rms_norm(x, w, 1e-5)
                ref = fused_norm.rms_norm_plain(x, w, 1e-5)
                err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"rms_norm {dtype} rows={rows} d={d}: kernel "
                        f"disagrees with its plain version (max abs err "
                        f"{err})")
    log(f"  rms_norm edges (d 512 / 2048 / 4096, rows 1 / 8 / 4096, bf16 "
        f"and f32): max abs err {worst:.3e}, all within tolerance")


# (label, B, max_len, page size, KV heads, dtype, lengths): H 32, D 128;
# lengths None are drawn as the main row's (seed 7, sum 5594)
PAGED_CASES = (
    ("main", 8, 2048, 16, 8, "bfloat16", None),
    ("decode profile", 8, 2048, 16, 8, "bfloat16", [512] * 8),
    ("B=1 full", 1, 2048, 16, 8, "bfloat16", [2048]),
    ("B=1 one short", 1, 2048, 16, 8, "bfloat16", [2047]),
    ("B=32", 32, 2048, 16, 8, "bfloat16", "random"),
    ("G=1", 8, 2048, 16, 32, "bfloat16", None),
    ("G=2", 8, 2048, 16, 16, "bfloat16", None),
    ("G=8", 8, 2048, 16, 4, "bfloat16", None),
    ("G=16", 8, 2048, 16, 2, "bfloat16", None),
    ("ps=8", 8, 2048, 8, 8, "bfloat16", None),
    ("ps=32", 8, 2048, 32, 8, "bfloat16", None),
    ("f32", 8, 2048, 16, 8, "float32", None),
    # 1, ps - 1, ps, ps + 1, a dead row, a full row and one past the pages
    ("edges", 7, 2048, 16, 8, "bfloat16", [1, 15, 16, 17, 0, 2048, 2100]),
    # ERNIE-4.5-21B-A3B: 20 query heads over 4 KV heads, a group of 5
    ("ERNIE-4.5 G=5", 8, 2048, 16, 4, "bfloat16", None, 20),
)
# the groups that are not powers of two, held untimed (H = 2 G over 2 KV
# heads) at the edge lengths
ODD_GROUPS = (3, 5, 6, 7)
# bytes each timed call of a paged row's rotation must touch in all, so
# that no call finds its pages in the 50 MB L2
PAGED_COLD_BYTES = 120e6


def check_paged_rows(record, cases=PAGED_CASES, D=128,
                     name="paged_attention", main="main"):
    """Paged decode attention at ``PAGED_CASES`` (H 32 unless the case
    names another; head width ``D``, recorded as ``name``, the case
    labelled ``main`` as the kernels line's row), each held
    against its plain version at the attention tolerance (a dead row must
    be exactly 0 and finite; the plain version, whose dead row is NaN, is
    compared on the live rows). Timed cold, as on the main path, where
    each of 32 layers has its own pool and a decode step finds it out of
    L2: the kernel and the SDPA yardstick (over pages gathered beforehand,
    with the length mask) rotate over at least 4 copies of the pool and of
    the gathered pages, together touching more than ``PAGED_COLD_BYTES``.
    The warm figure (one copy, back in L2 from the last call) is printed
    beside it. The pool holds B * max_len / ps pages in a seeded random
    order."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import paged_attention

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(77)
    rng = np.random.RandomState(7)
    rng.permutation(8 * 2048 // 16)
    main_lens = rng.randint(1, 2048 + 1, size=8)     # sum 5594
    for label, B, max_len, ps, hk, dt, lens, *heads in cases:
        H = heads[0] if heads else 32
        dtype = getattr(torch, dt)
        es = 2 if dtype == torch.bfloat16 else 4
        pps = max_len // ps
        n_pages = B * pps
        perm = np.random.RandomState(7).permutation(n_pages).astype(
            np.int32)
        if lens is None:
            lens = main_lens
        elif lens == "random":
            lens = np.random.RandomState(8).randint(1, max_len + 1, size=B)
        page_indices = torch.from_numpy(perm.reshape(B, pps)).to(dev)
        lengths = torch.tensor(np.asarray(lens), dtype=torch.int32,
                               device=dev)
        vis = lengths.clamp(max=pps * ps)
        n_tok = int(vis.sum())
        n_idx = int(((vis + ps - 1) // ps).sum())
        # each visible K and V row read once, q read and out written once,
        # the lengths and the visible pages' indices
        nbytes = (n_tok * hk * D * 2 * es + 2 * B * H * D * es + B * 4
                  + n_idx * 4)
        copies = max(4, math.ceil(PAGED_COLD_BYTES / max(
            n_tok * hk * D * 2 * es, 1)))

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)

        q = rnd(B, H, D)
        kps = [rnd(hk, n_pages, ps, D) for _ in range(copies)]
        vps = [rnd(hk, n_pages, ps, D) for _ in range(copies)]
        out = paged_attention.paged_attention(q, kps[0], vps[0], lengths,
                                              page_indices)
        ref = paged_attention.paged_attention_plain(q, kps[0], vps[0],
                                                    lengths, page_indices)
        live = lengths > 0
        err, ok = close_bf16(out[live], ref[live])
        dead = ~live
        if bool(dead.any()):
            dead_ok = (bool((out[dead] == 0).all())
                       and bool(torch.isfinite(out).all()))
            log(f"  paged_attention {label}: {int(dead.sum())} dead row(s) "
                f"exactly 0 and finite: {dead_ok}")
            ok = ok and dead_ok
        kgs = [paged_attention.gather_pages(kp, page_indices) for kp in kps]
        vgs = [paged_attention.gather_pages(vp, page_indices) for vp in vps]
        pmask = (torch.arange(pps * ps, device=dev)[None, :]
                 < lengths[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]
        turn = iter(range(1 << 62))

        def kernel(i=None):
            c = next(turn) % copies if i is None else i
            return paged_attention.paged_attention(q, kps[c], vps[c],
                                                   lengths, page_indices)

        def library(i=None):
            c = next(turn) % copies if i is None else i
            return sdpa_gqa(q4, kgs[c], vgs[c], mask=pmask)

        warm = (profiled_ms(lambda: kernel(0)), profiled_ms(
            lambda: library(0)))
        shape = (f"B={B} max_len={max_len} ps={ps} G={H // hk} {dt} "
                 f"sum_len={n_tok}" + ("" if D == 128 else f" D={D}"))
        record(name, f"{label}: {shape} cold", err, ok,
               kernel_times(kernel),
               time_ms(lambda: paged_attention.paged_attention_plain(
                   q, kps[0], vps[0], lengths, page_indices)),
               kernel_times(library),
               bound(nbytes, 4 * H * D * n_tok, dt), label == main,
               warm=warm)
        del q, kps, vps, kgs, vgs, out, ref
    torch.cuda.empty_cache()


def check_paged_groups():
    """Paged decode attention at each group of ``ODD_GROUPS`` (H = 2 G over
    2 KV heads, B 7 at the edge lengths of ``PAGED_CASES``: 1, ps - 1, ps,
    ps + 1, a dead row, a full row and one past the pages), f32 and bf16,
    each against its plain version at the attention tolerance; the dead
    row exactly 0. Untimed."""
    import torch

    from paddle_tpu_torch.ops.hopper import paged_attention

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(78)
    B, ps, pps, hk, D = 7, 16, 128, 2, 128
    lengths = torch.tensor([1, 15, 16, 17, 0, 2048, 2100], dtype=torch.int32,
                           device=dev)
    page_indices = torch.from_numpy(np.random.RandomState(9).permutation(
        B * pps).astype(np.int32).reshape(B, pps)).to(dev)
    live = lengths > 0
    worst = 0.0
    for G in ODD_GROUPS:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, hk * G, D, generator=gen, device=dev).to(dtype)
            kp, vp = (torch.randn(hk, B * pps, ps, D, generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            out = paged_attention.paged_attention(q, kp, vp, lengths,
                                                  page_indices)
            ref = paged_attention.paged_attention_plain(q, kp, vp, lengths,
                                                        page_indices)
            err, ok = close_bf16(out[live], ref[live])
            dead_ok = bool((out[~live] == 0).all()) and bool(
                torch.isfinite(out).all())
            worst = max(worst, err)
            if not (ok and dead_ok):
                raise AssertionError(
                    f"paged_attention G={G} {dtype}: kernel disagrees with "
                    f"its plain version (max abs err {err}, dead row 0 and "
                    f"finite: {dead_ok})")
    log(f"  paged_attention groups {'/'.join(map(str, ODD_GROUPS))} (H 2G "
        f"over 2 KV heads, B {B}, edge lengths, f32 and bf16): max abs err "
        f"{worst:.3e}, all within tolerance, the dead row exactly 0")


def check_group5_rows(record, randn):
    """The attention kernels at ERNIE-4.5-21B-A3B's group of 5 (20 query
    heads over 4 KV heads), each against its plain version at the
    attention tolerance: the splash forward at [1, 4096, 20 | 4, 128]
    causal beside SDPA; append attention at one query a row
    (``check_append_decode_rows`` with no mask, cold). Then ``rms_norm``
    at width 128 over 8 x 1024 x 32 rows, Qwen3-MoE's per-head q norm at
    a 1024-token prefill, beside ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.hopper import flash_attention, fused_norm

    H, hk, D, S = 20, 4, 128, 4096
    q, k, v = randn(1, S, H, D), randn(1, S, hk, D), randn(1, S, hk, D)
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True)
    err, ok = close_bf16(out, ref)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    record("flash_attention_bshd", f"S={S} causal G=5 ({H} | {hk})", err,
           ok, kernel_times(lambda: flash_attention.flash_attention_bshd(
               q, k, v, causal=True), 5, 2),
           time_ms(lambda: flash_attention.flash_attention_plain(
               q, k, v, causal=True), 3, 1),
           kernel_times(lambda: sdpa_gqa(qt, kt, vt, causal=True), 5, 2),
           bound(2 * S * (H + hk) * D * 2, 4 * D * H * S * (S + 1) // 2,
                 "bfloat16"), False)
    del q, k, v, qt, kt, vt, out, ref

    check_append_decode_rows(record, H=H, hk=hk, masked=False)

    rows, d = 8 * 1024 * 32, 128
    x = randn(rows, d)
    w = randn(d, scale=0.5) + 1
    out = fused_norm.rms_norm(x, w, 1e-6)
    ref = fused_norm.rms_norm_plain(x, w, 1e-6)
    err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
    record("rms_norm", f"rows={rows} d={d} (Qwen3-MoE q norm)", err, ok,
           kernel_times(lambda: fused_norm.rms_norm(x, w, 1e-6), 100, 20),
           time_ms(lambda: fused_norm.rms_norm_plain(x, w, 1e-6)),
           kernel_times(lambda: F.rms_norm(x, (d,), w, 1e-6), 100, 20),
           bound(2 * rows * d * 2 + d * 2, 4 * rows * d, "bfloat16"), False)
    torch.cuda.empty_cache()


# paged decode at Gemma's head width 256 (label, B, max_len, page size, KV
# heads, dtype, lengths, H): Gemma-7B's 16 | 16 (group 1) and Gemma-2B's
# 8 | 1 (group 8) at the main row's lengths, the edge lengths at group 1
GEMMA_PAGED_CASES = (
    ("Gemma-7B G=1", 8, 2048, 16, 16, "bfloat16", None, 16),
    ("Gemma-2B G=8", 8, 2048, 16, 1, "bfloat16", None, 8),
    ("Gemma edges", 7, 2048, 16, 16, "bfloat16",
     [1, 15, 16, 17, 0, 2048, 2100], 16),
    ("Gemma f32", 8, 2048, 16, 16, "float32", None, 16),
)


def check_width256_rows(record, randn):
    """The kernels at Gemma's widths, each against its plain version at the
    tolerances of the width-128 rows: the causal flash forward at [1, 4096,
    16 | 16, 256] beside SDPA causal (``flash_attention_256``); append
    attention at the engine's padded prefill (S = T = 1024 with a column
    mask over 700 valid columns) and at one query a row (S 1, B 4, pos 1040
    of T 1056, 16 | 16 x 256, cold, unmasked and with the padded prompts'
    mask; ``append_attention_256``); paged decode at D 256, groups 1
    and 8 at the main lengths, the edge lengths and f32 (cold;
    ``paged_attention_256``); the fused decode tail at 8 and 32 rows of
    Gemma-7B's widths (hidden 3072, 16 | 16 x 256, cold); ``rms_norm`` and
    ``add_rms_norm`` at Gemma-7B's hidden 3072 and Gemma2-9B's 3584 by 8
    and 4096 rows."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.hopper import flash_attention, fused_norm

    t0 = time.perf_counter()
    H, hk, D, S = 16, 16, 256, 4096
    q, k, v = randn(1, S, H, D), randn(1, S, hk, D), randn(1, S, hk, D)
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True)
    err, ok = close_bf16(out, ref)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    record("flash_attention_256", f"S={S} causal {H} | {hk} x {D}", err, ok,
           kernel_times(lambda: flash_attention.flash_attention_bshd(
               q, k, v, causal=True), 5, 2),
           time_ms(lambda: flash_attention.flash_attention_plain(
               q, k, v, causal=True), 3, 1),
           kernel_times(lambda: sdpa_gqa(qt, kt, vt, causal=True), 5, 2),
           bound(2 * S * (H + hk) * D * 2, 4 * D * H * S * (S + 1) // 2,
                 "bfloat16"), True)
    del q, k, v, qt, kt, vt, out, ref
    torch.cuda.empty_cache()
    # the engine's padded prefill: a 700-token prompt in its 1024 bucket
    check_append_prefill_rows(record, randn, [(1024, 1024, 0, 700)], H=H,
                              hk=hk, D=D, name="append_attention_256")
    check_append_decode_rows(record, H=H, hk=hk, D=D,
                             name="append_attention_256", main=True)
    check_paged_rows(record, GEMMA_PAGED_CASES, D=D,
                     name="paged_attention_256", main="Gemma-7B G=1")
    check_decode_tail_kernels(record, hidden=3072, H=H, hk=hk, d=D,
                              main=False, edges=False)
    for d in (3072, 3584):
        for rows in (8, 4096):
            x, r = randn(rows, d), randn(rows, d)
            w = randn(d, scale=0.5) + 1
            out = fused_norm.rms_norm(x, w, 1e-6)
            ref = fused_norm.rms_norm_plain(x, w, 1e-6)
            err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
            record("rms_norm", f"rows={rows} d={d}", err, ok,
                   kernel_times(lambda: fused_norm.rms_norm(x, w, 1e-6),
                                100, 20),
                   time_ms(lambda: fused_norm.rms_norm_plain(x, w, 1e-6)),
                   kernel_times(lambda: F.rms_norm(x, (d,), w, 1e-6), 100,
                                20),
                   bound(2 * rows * d * 2 + d * 2, 4 * rows * d, "bfloat16"),
                   False)
            o, h = fused_norm.add_rms_norm(x, r, w, 1e-6)
            ro, rh = fused_norm.add_rms_norm_plain(x, r, w, 1e-6)
            err, ok = close_bf16(o, ro, atol=1e-6, rtol=2.0 ** -6)
            record("add_rms_norm", f"rows={rows} d={d}", err,
                   ok and torch.equal(h, rh),
                   kernel_times(lambda: fused_norm.add_rms_norm(
                       x, r, w, 1e-6), 100, 20),
                   time_ms(lambda: fused_norm.add_rms_norm_plain(
                       x, r, w, 1e-6)),
                   None, bound(4 * rows * d * 2 + d * 2, 5 * rows * d,
                               "bfloat16"), False)
    torch.cuda.empty_cache()
    log(f"  the width-256 rows took {time.perf_counter() - t0:.1f}s")


# paged decode at the dense families' head widths (label, B, max_len, page
# size, KV heads, dtype, lengths, H): Phi-3-mini's 32 | 32 x 96, GPT-2 XL's
# 25 | 25 x 64 and Qwen2.5-0.5B's 14 | 2 x 64 (group 7) at the main row's
# lengths, then the edge shapes at each width: f32, the edge lengths with
# a dead row, page sizes 8 and 32, B 1
DENSE_PAGED_CASES = {
    96: (("Phi-3-mini G=1", 8, 2048, 16, 32, "bfloat16", None, 32),
         ("D=96 edges", 7, 2048, 16, 32, "bfloat16",
          [1, 15, 16, 17, 0, 2048, 2100], 32),
         ("D=96 f32", 8, 2048, 16, 32, "float32", None, 32),
         ("D=96 ps=8", 8, 2048, 8, 32, "bfloat16", None, 32),
         ("D=96 ps=32", 8, 2048, 32, 32, "bfloat16", None, 32),
         ("D=96 B=1", 1, 2048, 16, 32, "bfloat16", [2047], 32)),
    64: (("GPT-2 XL G=1", 8, 2048, 16, 25, "bfloat16", None, 25),
         ("Qwen2.5-0.5B G=7", 8, 2048, 16, 2, "bfloat16", None, 14),
         ("D=64 edges", 7, 2048, 16, 25, "bfloat16",
          [1, 15, 16, 17, 0, 2048, 2100], 25),
         ("D=64 f32 G=7", 8, 2048, 16, 2, "float32", None, 14),
         ("D=64 ps=8", 8, 2048, 8, 25, "bfloat16", None, 25),
         ("D=64 ps=32", 8, 2048, 32, 25, "bfloat16", None, 25),
         ("D=64 B=1", 1, 2048, 16, 25, "bfloat16", [2047], 25)),
}


def check_dense_family_rows(record):
    """The kernels at the dense families' head widths, each against its
    plain version at the attention tolerance, with its bound (bytes) and
    SDPA over the gathered pages beside it: paged decode at D 96 and D 64
    (``DENSE_PAGED_CASES``, cold, warm beside; ``paged_attention_96`` and
    ``paged_attention_64``, Phi-3-mini's and GPT-2 XL's rows the kernels
    line's), and append attention at (64, 64), one query a row (S 1, B 4,
    GPT-2 XL's 25 | 25 heads, pos 1040 of 1056, cold; the path of GPT-2's
    and Qwen2.5-0.5B's dense decode)."""
    t0 = time.perf_counter()
    check_paged_rows(record, DENSE_PAGED_CASES[96], D=96,
                     name="paged_attention_96", main="Phi-3-mini G=1")
    check_paged_rows(record, DENSE_PAGED_CASES[64], D=64,
                     name="paged_attention_64", main="GPT-2 XL G=1")
    check_append_decode_rows(record, H=25, hk=25, D=64, masked=False)
    log(f"  the dense families' rows took {time.perf_counter() - t0:.1f}s")


def check_width256_training_rows(record, randn):
    """The kernels Gemma's training step adds at head width 256, each
    against its plain version at the tolerances of the width-128 rows:
    the flash backward at (256, 256) (``flash_attention_bwd_256``, held
    per element against ``flash_attention_bwd_plain`` on the same out
    through ``close_grads``) causal at [1, 4096, 16 | 16, 256] (Gemma-7B)
    and at [1, 4096, 8 | 1, 256] (Gemma-2B, phase 26's shape: the kernels
    line's row), beside SDPA's backward; then the LocalMask (W 1024) and
    the FullMask, forward with lse and backward, at [1, 4096, 16 | 16,
    256] (their kind's counters); the backward's edge shapes
    (``check_width256_edges``); ``splash_hop`` at [1, 16 | 16, 4096, 256]
    for each kind; and ``fused_rope`` at Gemma-2B's q, [1, 4096, 8, 256]."""
    import torch

    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.hopper import fused_norm

    t0 = time.perf_counter()
    D, S = 256, TRAIN_SEQ
    check_flash_rows(record, randn, S, None, H=16, hk=16, D=D,
                     fwd_main=False, bwd_main=False)
    torch.cuda.empty_cache()
    check_flash_rows(record, randn, S, None, H=8, hk=1, D=D, fwd_main=False)
    torch.cuda.empty_cache()
    check_flash_rows(record, randn, S, GEMMA_TRAIN_WINDOW, H=16, hk=16, D=D,
                     fwd_main=False, bwd_main=False)
    torch.cuda.empty_cache()
    check_flash_rows(record, randn, S, None, full=True, H=16, hk=16, D=D,
                     fwd_main=False, bwd_main=False)
    torch.cuda.empty_cache()
    check_width256_edges()
    check_hop_rows(record, randn, H=16, hk=16, D=D, main=False)
    torch.cuda.empty_cache()
    cos, sin = _rope_tables(S, D, 10000.0, device="cuda")
    x = randn(1, S, 8, D)
    out = fused_norm.fused_rope(x, cos, sin)
    ref = fused_norm._rope_ref_full(x, cos, sin)
    err, ok = close_bf16(out, ref, atol=0.0, rtol=2.0 ** -7)
    record("fused_rope", f"x=[1,{S},8,{D}]", err, ok,
           kernel_times(lambda: fused_norm.fused_rope(x, cos, sin)),
           time_ms(lambda: fused_norm._rope_ref_full(x, cos, sin)),
           None, bound(2 * x.numel() * 2 + 2 * S * D * 4, 3 * x.numel(),
                       "bfloat16"), False)
    log(f"  the width-256 training rows took {time.perf_counter() - t0:.1f}s")


# the (256, 256) backward's edge shapes (s_q, s_kv, H, hk, dtype, kind,
# window): a sequence of 1000 (a partial last q tile and key tile) at
# Gemma-2B's 8 | 1 heads, causal and local; a rectangular s_q 200 < s_kv
# 700 at 16 | 16, causal (pos 500) and full; f32 (the CUDA-core body, tiles
# of 32 rows) at [1, 130 | 300, 4], causal and full, and local at 300
WIDE_EDGE_CASES = (
    (1000, 1000, 8, 1, "bfloat16", "causal", None),
    (1000, 1000, 8, 1, "bfloat16", "local", 300),
    (200, 700, 16, 16, "bfloat16", "causal", None),
    (200, 700, 16, 16, "bfloat16", "full", None),
    (130, 300, 4, 4, "float32", "causal", None),
    (130, 300, 4, 4, "float32", "full", None),
    (300, 300, 4, 2, "float32", "local", 100),
)


def check_width256_edges():
    """The (256, 256) flash backward at ``WIDE_EDGE_CASES`` through the
    autograd Function (``flash_attention_bshd`` on inputs that need a
    gradient), as ``check_mla_backward``'s edges: the out against the
    plain forward and the gradients per element against
    ``flash_attention_bwd_plain`` on the same q, k, v, out and dout; bf16
    as ``close_grads`` (the out as the forward rows), f32 out within 2e-5
    and each gradient within 1e-5 of max(1, its largest entry)."""
    import torch

    from paddle_tpu_torch.ops.hopper import flash_attention

    D = 256
    gen = torch.Generator("cuda").manual_seed(256)
    for s_q, s_kv, H, hk, dtype, kind, window in WIDE_EDGE_CASES:
        dtype = getattr(torch, dtype)
        q, k, v, dout = (torch.randn(1, n, h, D, generator=gen,
                                     device="cuda").to(dtype)
                         for n, h in ((s_q, H), (s_kv, hk), (s_kv, hk),
                                      (s_q, H)))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        causal = kind != "full"
        out = flash_attention.flash_attention_bshd(*leaves, causal=causal,
                                                   window=window)
        grads = torch.autograd.grad(out, leaves, dout)
        out = out.detach()
        ref = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                    window=window)
        ref_grads = flash_attention.flash_attention_bwd_plain(
            q, k, v, out, dout, 1.0 / math.sqrt(D), window=window,
            full=not causal)
        edge = (f"flash_attention_bwd (256, 256) edge {str(dtype)[6:]} "
                f"{kind}{'' if window is None else f' W={window}'} "
                f"s_q={s_q} s_kv={s_kv} {H} | {hk}")
        if dtype == torch.float32:
            errs = [float((a - b).abs().max())
                    for a, b in zip((out,) + tuple(grads),
                                    (ref,) + tuple(ref_grads))]
            ok = errs[0] <= 2e-5 and all(
                e <= 1e-5 * max(float(b.abs().max()), 1.0)
                for e, b in zip(errs[1:], ref_grads))
            log(f"  {edge}: max abs err out {errs[0]:.2e} dq/dk/dv "
                f"{errs[1]:.2e}/{errs[2]:.2e}/{errs[3]:.2e} ok={ok}")
        else:
            e_out, ok = close_bf16(out, ref)
            log(f"  {edge}: max abs err out {e_out:.2e} ok={ok}")
            ok = close_grads(edge, grads, ref_grads)[1] and ok
        if not ok:
            raise AssertionError(f"the (256, 256) flash backward disagrees "
                                 f"with its plain version: {edge}")
    del q, k, v, dout, leaves, out, ref, grads, ref_grads


def check_full_edges():
    """The full-mask kernels off the main path's shape, forward with lse and
    backward against the plain versions (the backward's on the kernel
    forward's out): rectangular each way (1024 x 4096, 4096 x 1024), a
    sequence that ends in a short tile (1000) and MHA in f32; then a local
    hop with dead rows (block 128, offset 128, window 96: rows 95-127 see
    no column) in f32. Tolerances as ``check_local_edges``; a dead row must
    come out 0 with lse -inf in the kernel and the plain version."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    gen = torch.Generator("cuda").manual_seed(77)
    scale = 1.0 / math.sqrt(128)
    for s_q, s_kv, H, hk, dtype in (
            (1024, 4096, 32, 8, torch.bfloat16),
            (4096, 1024, 32, 8, torch.bfloat16),
            (1000, 1000, 8, 2, torch.bfloat16),
            (333, 200, 4, 4, torch.float32)):
        q, k, v, dout = (torch.randn(1, n, h, 128, generator=gen,
                                     device="cuda").to(dtype)
                         for n, h in ((s_q, H), (s_kv, hk), (s_kv, hk),
                                      (s_q, H)))
        out, lse = append_attention.launch(q, k, v, 0, None, scale,
                                           "flash_attention_full",
                                           with_lse=True, kind="full")
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    scale, full=True)
        ref = flash_attention.flash_attention_plain(q, k, v, causal=False)
        ref_grads = flash_attention.flash_attention_bwd_plain(
            q, k, v, out, dout, scale, full=True)
        sc = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(1, s_q, hk, H // hk, 128).float(),
                          k.float()) * scale
        ref_lse = torch.logsumexp(sc, dim=-1).reshape(1, H, s_q)
        del sc
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip((out, lse) + tuple(grads),
                                (ref, ref_lse) + tuple(ref_grads))]
        edge = (f"full edges {str(dtype)[6:]} s_q={s_q} s_kv={s_kv} H={H} "
                f"hk={hk}")
        log(f"  {edge}: max abs err out {errs[0]:.2e} lse {errs[1]:.2e} "
            f"dq/dk/dv {errs[2]:.2e}/{errs[3]:.2e}/{errs[4]:.2e}")
        if dtype == torch.float32:
            tops = [float(b.abs().max()) for b in ref_grads]
            ok = (errs[0] <= 2e-5 and errs[1] <= 2e-5
                  and all(e <= 1e-5 * max(t, 1.0)
                          for e, t in zip(errs[2:], tops)))
        else:
            ok = (close_bf16(out, ref)[1] and errs[1] <= 1e-3
                  and close_grads(edge, grads, ref_grads)[1])
        if not ok:
            raise AssertionError(f"full-mask flash kernels disagree with "
                                 f"their plain version at s_q={s_q} "
                                 f"s_kv={s_kv} {dtype}")
        del q, k, v, dout, out, lse, grads, ref, ref_grads
    q, k, v = (torch.randn(2, h, 128, 128, generator=gen, device="cuda")
               for h in (8, 2, 2))
    out, lse = flash_attention.splash_hop(q * scale, k, v, "local",
                                          offset=128, window=96)
    ref, ref_lse = flash_attention.splash_hop_plain(q * scale, k, v, "local",
                                                    offset=128, window=96)
    dead = torch.arange(128, device="cuda") >= 95
    ok = (bool((out[:, :, dead] == 0).all())
          and bool(torch.isneginf(lse[:, :, dead]).all())
          and bool(torch.isneginf(ref_lse[:, :, dead]).all())
          and not bool(torch.isnan(out).any() or torch.isnan(lse).any()))
    err = float((out - ref).abs().max())
    lse_err = float((lse[:, :, ~dead] - ref_lse[:, :, ~dead]).abs().max())
    log(f"  hop edge f32 local offset 128 W 96, dead rows 95-127: max abs "
        f"err out {err:.2e} lse (live rows) {lse_err:.2e}; dead rows out 0, "
        f"lse -inf: {ok}")
    if not (ok and err <= 2e-5 and lse_err <= 2e-5):
        raise AssertionError("splash_hop disagrees with its plain version, "
                             "or its dead rows are not as documented")


def hop_cells(kind, S, T, offset, window):
    """Visible (query, key) cells of one head of a hop."""
    rows = np.arange(S)[:, None] + offset
    cols = np.arange(T)[None, :]
    if kind == "full":
        return S * T
    seen = cols <= rows
    if kind == "local":
        seen &= cols > rows - window
    return int(seen.sum())


def check_hop_rows(record, randn, H=32, hk=8, D=128, main=True):
    """``splash_hop`` at [1, 32 | 8, 4096, 128] (JAX's [B, H, S, D], q
    pre-scaled; or at ``H`` | ``hk``, ``D``: Gemma's 16 | 16 x 256), bf16,
    for each kind of the ring's hops: full, causal at
    offset 0, and local at offset 4096 with window 4096 (a Mistral ring's
    hop 1 at local 4096, whose row 4095 sees no column). ``main``: the
    full hop's row is the kernels line's. Each against
    ``splash_hop_plain`` per element on the live rows (out as the
    attention rows, lse within 1e-3); a dead row must be out 0, lse -inf.
    Kernel ms is the launch on the ring's [B, S, H, D] layout
    (``hop_bshd``); the public call's transposes are timed beside it. The
    yardstick is SDPA on the hop's mask."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import flash_attention

    S = TRAIN_SEQ
    q = randn(1, H, S, D, scale=1.0 / math.sqrt(D))
    k, v = randn(1, hk, S, D), randn(1, hk, S, D)
    qb, kb, vb = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    for kind, offset, window in (("full", 0, None), ("causal", 0, None),
                                 ("local", S, WINDOW)):
        out, lse = flash_attention.splash_hop(q, k, v, kind, offset=offset,
                                              window=window)
        with torch.no_grad():
            ref, ref_lse = flash_attention.splash_hop_plain(
                q, k, v, kind, offset=offset, window=window)
        live = ~torch.isneginf(ref_lse[0, 0])
        err, ok = close_bf16(out[:, :, live], ref[:, :, live])
        lse_err = float((lse[:, :, live] - ref_lse[:, :, live]).abs().max())
        dead_ok = (bool((out[:, :, ~live] == 0).all())
                   and bool(torch.isneginf(lse[:, :, ~live]).all()))
        ok = ok and lse_err <= 1e-3 and dead_ok and not bool(
            torch.isnan(out).any() or torch.isnan(lse).any())
        n_dead = int((~live).sum())
        log(f"  splash_hop {kind} offset={offset}: lse max abs err "
            f"{lse_err:.3e}, dead rows {n_dead} (out 0, lse -inf: "
            f"{dead_ok})")
        del ref, ref_lse
        mask = causal = None
        if kind == "local":
            rows = torch.arange(S, device=q.device)[:, None] + offset
            cols = torch.arange(S, device=q.device)[None, :]
            mask = ((cols <= rows) & (cols > rows - window))[None, None]
        causal = kind == "causal"
        cells = hop_cells(kind, S, S, offset, window)
        public_ms = time_ms(lambda: flash_attention.splash_hop(
            q, k, v, kind, offset=offset, window=window), reps=5, warmup=1)
        kernel_ms = kernel_times(lambda: flash_attention.hop_bshd(
            qb, kb, vb, kind, offset=offset, window=window), reps=5,
            warmup=1)
        log(f"  splash_hop {kind}: [B, H, S, D] call with its transposes "
            f"{public_ms:.4f} ms, launch on [B, S, H, D] {kernel_ms[0]:.4f} "
            "ms")
        record("splash_hop", f"[1,{H}|{hk},{S},{D}] {kind} offset={offset}"
               + (f" W={window}" if window else ""), err, ok, kernel_ms,
               time_ms(lambda: flash_attention.splash_hop_plain(
                   q, k, v, kind, offset=offset, window=window), reps=3,
                   warmup=1),
               kernel_times(lambda: sdpa_gqa(q, k, v, mask=mask,
                                             causal=causal, scale=1.0),
                            reps=5, warmup=1),
               bound(2 * S * (H + hk) * D * 2 + H * S * 4,
                     4 * D * H * cells, "bfloat16"), main and kind == "full")
    del q, k, v, qb, kb, vb


# weights the decode-tail rows rotate over, as on the main path, where each
# of 32 layers streams its own weights cold from device memory
TAIL_COLD_BYTES = 100e6


def one_ulp_of_max(out, ref):
    """(max abs err, within one bf16 ulp of the largest entry): both sides
    sum exact f32 products in f32, in another order; an entry may round to
    its other bf16 neighbour, and RoPE of such a pair stays within one ulp
    of the largest entry."""
    err = max(float((o.float() - r.float()).abs().max())
              for o, r in zip(out, ref))
    top = max(float(r.float().abs().max()) for r in ref)
    return err, err <= 2.0 ** (np.floor(np.log2(top)) - 7)


def within_f32(out, ref):
    """(max abs err, within 1e-5 of the largest entry): f32 sums in another
    order."""
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    return err, err <= 1e-5 * max(float(r.abs().max()) for r in ref)


def tail_inputs(R, hidden, H, hk, d, dtype, seed, copies=1):
    """Seeded inputs of both tail kernels: x, w_norm, ``copies`` sets of
    (wq, wk, wv) and of wo, per-row cos / sin at random positions, attn and
    the residual."""
    import torch

    from paddle_tpu_torch.models.llama import _rope_tables

    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(dtype)

    cos, sin = _rope_tables(2048, d, 500000.0, device="cuda")
    pos = torch.randint(0, 2048, (R,), generator=g, device="cuda")
    wqkv = [tuple(rnd(hidden, n * d, scale=0.02) for n in (H, hk, hk))
            for _ in range(copies)]
    wo = [rnd(H * d, hidden, scale=0.02) for _ in range(copies)]
    return dict(x=rnd(R, hidden), wn=rnd(hidden, scale=0.1) + 1, wqkv=wqkv,
                wo=wo, cos=cos[pos], sin=sin[pos], pos=pos, tables=(cos, sin),
                attn=rnd(R, H * d), res=rnd(R, hidden))


def check_decode_tail_kernels(record, hidden=4096, H=32, hk=8, d=128,
                              main=True, edges=True):
    """The fused decode tail at Llama-3-8B widths (or the given ones, with
    ``main`` False off the kernels line's row and ``edges`` False without
    the edge shapes), bf16: R = 8 rows (a decode
    step at 8 slots) and R = 32 (a verify chunk of 8 slots x k = 4), timed
    cold: the kernel and both yardsticks rotate over copies of the weights
    (Wq | Wk | Wv, and Wo) that touch more than ``TAIL_COLD_BYTES``, as each
    layer's weights are cold in a decode step; the warm figure (one copy)
    beside it. The yardsticks, never used by the port's kernels, timed by
    the same three measures: one ``torch.matmul`` of the product alone
    (x @ Wq|Wk|Wv, attn @ Wo) and the port's discrete sequence the kernel
    replaces. Then each wrapper's host µs a call, and the edge shapes:
    R 1 and 33 (two row tiles) at those widths, uneven slices of the
    contraction, hidden 384 and 1152, in bf16 and f32."""
    import math

    import torch

    from paddle_tpu_torch.generation import _rope_rows
    from paddle_tpu_torch.ops.hopper import decode_tail, fused_norm

    eps = 1e-5
    bf = torch.bfloat16
    log(f"  decode tail at hidden {hidden}, {H} | {hk} x {d}: tolerance one bf16 ulp of the largest entry (f32: "
        "1e-5 of it); two launches on the same inputs must give the same "
        "bits; timed cold over weight copies touching more than "
        f"{TAIL_COLD_BYTES / 1e6:.0f} MB, warm beside")
    wbytes_qkv = hidden * (H + 2 * hk) * d * 2
    wbytes_o = H * d * hidden * 2
    n_qkv = max(3, math.floor(TAIL_COLD_BYTES / wbytes_qkv) + 1)
    n_o = max(3, math.floor(TAIL_COLD_BYTES / wbytes_o) + 1)
    base = tail_inputs(32, hidden, H, hk, d, bf, 11, copies=max(n_qkv, n_o))
    wqkv, wo = base["wqkv"][:n_qkv], base["wo"][:n_o]
    cat = [torch.cat(w, dim=1) for w in wqkv]   # the product's yardstick
    cos, sin = base["tables"]
    turn = iter(range(1 << 62))

    def cold(n):
        return next(turn) % n

    for R in (8, 32):
        x, attn, res = base["x"][:R], base["attn"][:R], base["res"][:R]
        c, s, pos = base["cos"][:R], base["sin"][:R], base["pos"][:R]
        wn = base["wn"]

        def qkv(i=None):
            wq, wk, wv = wqkv[cold(n_qkv) if i is None else i]
            return decode_tail.fused_qkv_rope(x, wn, wq, wk, wv, c, s, eps,
                                              H, hk, d)

        def qkv_matmul(i=None):
            return x @ cat[cold(n_qkv) if i is None else i]

        def qkv_discrete(i=None):
            wq, wk, wv = wqkv[cold(n_qkv) if i is None else i]
            n = fused_norm.rms_norm(x, wn, eps)
            q, k, v = n @ wq, n @ wk, n @ wv
            return (_rope_rows(q.reshape(R, 1, H, d), cos, sin, pos),
                    _rope_rows(k.reshape(R, 1, hk, d), cos, sin, pos), v)

        wq, wk, wv = wqkv[0]
        args = (x, wn, wq, wk, wv, c, s, eps, H, hk, d)
        out = decode_tail.fused_qkv_rope(*args)
        ref = decode_tail.fused_qkv_rope_plain(*args)
        err, ok = one_ulp_of_max(out, ref)
        ok = ok and all(torch.equal(a, b) for a, b in
                        zip(out, decode_tail.fused_qkv_rope(*args)))
        cost = decode_tail._qkv_cost({"batch": R, "hidden": hidden,
                                      "wtot": (H + 2 * hk) * d,
                                      "dtype": "bfloat16"})
        split = tail_split(getattr(decode_tail, "qkv_scratch", None), R,
                           hidden, H, hk, d)
        tail_yardsticks(f"fused_qkv_rope R={R}", (
            (f"torch.matmul x[{R},{hidden}] @ Wq|Wk|Wv[{hidden},"
             f"{(H + 2 * hk) * d}]", qkv_matmul),
            ("discrete rms_norm + 3 matmuls + 2 ropes", qkv_discrete)))
        record("fused_qkv_rope",
               f"R={R} hidden={hidden} H={H} hk={hk} d={d} split={split} "
               "cold", err, ok, kernel_times(qkv),
               time_ms(lambda: decode_tail.fused_qkv_rope_plain(*args)),
               None, bound(cost["bytes"], cost["flops"], "bfloat16"),
               main and R == 8, warm=(profiled_ms(lambda: qkv(0)), None))

        def epilogue(i=None):
            return decode_tail.fused_epilogue(
                attn, wo[cold(n_o) if i is None else i], res, wn, eps)

        def epi_matmul(i=None):
            return attn @ wo[cold(n_o) if i is None else i]

        def epi_discrete(i=None):
            return fused_norm.add_rms_norm(
                attn @ wo[cold(n_o) if i is None else i], res, wn, eps)

        eargs = (attn, wo[0], res, wn, eps)
        out = decode_tail.fused_epilogue(*eargs)
        ref = decode_tail.fused_epilogue_plain(*eargs)
        err, ok = one_ulp_of_max(out, ref)
        ok = ok and all(torch.equal(a, b) for a, b in
                        zip(out, decode_tail.fused_epilogue(*eargs)))
        cost = decode_tail._epilogue_cost({"batch": R, "width": H * d,
                                           "hidden": hidden,
                                           "dtype": "bfloat16"})
        split = tail_split(getattr(decode_tail, "epilogue_scratch", None), R,
                           H * d, hidden)
        tail_yardsticks(f"fused_epilogue R={R}", (
            (f"torch.matmul attn[{R},{H * d}] @ Wo", epi_matmul),
            ("discrete matmul + add_rms_norm", epi_discrete)))
        record("fused_epilogue",
               f"R={R} width={H * d} hidden={hidden} split={split} cold",
               err, ok, kernel_times(epilogue),
               time_ms(lambda: decode_tail.fused_epilogue_plain(*eargs)),
               None, bound(cost["bytes"], cost["flops"], "bfloat16"),
               main and R == 8, warm=(profiled_ms(lambda: epilogue(0)), None))
        if R == 8:
            log(f"  decode tail R={R}: host us a call, {HOST_CALLS} calls in "
                f"a row on the host clock: fused_qkv_rope "
                f"{host_us(lambda: qkv(0)):.2f}, fused_epilogue "
                f"{host_us(lambda: epilogue(0)):.2f}")
    del base, wqkv, wo, cat
    torch.cuda.empty_cache()
    if edges:
        check_tail_edges()


def tail_split(scratch, *shape):
    """The bf16 body's slice count of a tail kernel at ``shape``, as its
    wrapper picks it (``scratch``: ``qkv_scratch`` or ``epilogue_scratch``;
    None, and "-" returned, for a checkout whose kernels take no split)."""
    import torch

    if scratch is None:
        return "-"
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return scratch(*shape, n_sm, 1)[0]


def tail_yardsticks(what, sticks):
    """Logs each yardstick's three measures cold (rotating over the weight
    copies, as the row's kernel) and its warm profiled ms (copy 0)."""
    for name, fn in sticks:
        ms, dev_ms, prof_ms = kernel_times(fn)
        log(f"  yardstick {what}: {name}: ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"profiled_ms={prof_ms:.4f} (cold) warm_profiled_ms="
            f"{profiled_ms(lambda: fn(0)):.4f}")


# (R, hidden, H, hk): one row and two row tiles at Llama-3-8B widths; a
# contraction in uneven slices; the hidden-384 case of three heads
TAIL_EDGES = ((1, 4096, 32, 8), (33, 4096, 32, 8), (17, 1408, 4, 2),
              (40, 384, 3, 1))


def check_tail_edges():
    """Both tail kernels off the timed rows, against their plain versions
    (bf16: one ulp of the largest entry and the same bits over two launches;
    f32: 1e-5 of the largest entry), with the bf16 bodies' slice count and
    whether the last slice is shorter."""
    import torch

    from paddle_tpu_torch.ops.hopper import decode_tail

    d, eps = 128, 1e-5
    for dtype in (torch.bfloat16, torch.float32):
        for R, hid, h, hk in TAIL_EDGES:
            t = tail_inputs(R, hid, h, hk, d, dtype, R + hid)
            wq, wk, wv = t["wqkv"][0]
            args = (t["x"], t["wn"], wq, wk, wv, t["cos"], t["sin"], eps, h,
                    hk, d)
            eargs = (t["attn"], t["wo"][0], t["res"], t["wn"], eps)
            code = int(dtype == torch.bfloat16)
            qkv_split = getattr(decode_tail, "qkv_scratch", None)
            epi_split = getattr(decode_tail, "epilogue_scratch", None)
            for name, fn, plain, a, split, k in (
                    ("fused_qkv_rope", decode_tail.fused_qkv_rope,
                     decode_tail.fused_qkv_rope_plain, args,
                     tail_split(qkv_split, R, hid, h, hk, d), hid),
                    ("fused_epilogue", decode_tail.fused_epilogue,
                     decode_tail.fused_epilogue_plain, eargs,
                     tail_split(epi_split, R, h * d, hid), h * d)):
                out = fn(*a)
                same = all(torch.equal(o, p) for o, p in zip(out, fn(*a)))
                ref = plain(*a)
                err, ok = (one_ulp_of_max if code else within_f32)(out, ref)
                slices = ""
                if code and split != "-":
                    chunks = k // decode_tail.CHUNK
                    per = -(-chunks // split)
                    slices = (f" (slices of {per} chunks, the last "
                              f"{chunks - per * (split - 1)})")
                log(f"  {name} {str(dtype)[6:]} R={R} hidden={hid} H={h} "
                    f"hk={hk}: split {split if code else '-'}{slices} max "
                    f"abs err {err:.3e} ok={ok} same bits={same}")
                if not (ok and same):
                    raise AssertionError(
                        f"{name} {dtype} R={R} hidden={hid}: kernel disagrees "
                        "with its plain version or with itself")


def check_training_kernels(record, randn):
    """The training path's kernels at Llama-3-8B widths, sequence 4096."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.hopper import fused_norm

    S, H, hk, D = TRAIN_SEQ, 32, 8, 128
    cos, sin = _rope_tables(S, D, 500000.0, device="cuda")
    for heads in (H, hk):
        x = randn(1, S, heads, D)
        out = fused_norm.fused_rope(x, cos, sin)
        ref = fused_norm._rope_ref_full(x, cos, sin)
        # the kernel rounds as the plain version does: bit-identical expected
        err, ok = close_bf16(out, ref, atol=0.0, rtol=2.0 ** -7)
        record("fused_rope", f"x=[1,{S},{heads},{D}]", err, ok,
               kernel_times(lambda: fused_norm.fused_rope(x, cos, sin)),
               time_ms(lambda: fused_norm._rope_ref_full(x, cos, sin)),
               None, bound(2 * x.numel() * 2 + 2 * S * D * 4, 3 * x.numel(),
                           "bfloat16"), heads == H)

    check_flash_rows(record, randn, S, None)
    # the entry model's heads (8 | 4 of 64): the backward the entry trains
    # through
    check_flash_rows(record, randn, S, None, H=8, hk=4, D=64, fwd_main=False)


def band_cells(s, window):
    """Visible (query, key) cells of one head under the LocalMask of
    ``window`` at S = T = ``s``: query i sees min(i + 1, window) keys."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def check_local_edges():
    """The local kernels off the main path's shape, forward with lse and
    backward against the plain versions (the backward's on the kernel
    forward's out): sequences that end in a short tile, a rectangular
    s_q < s_kv (pos > 0), windows of 1 and wider than the sequence, several
    groupings, f32 and bf16. f32: out and lse within 2e-5, each gradient
    within 1e-5 of its largest entry (sums in another order); bf16: out as
    the main rows, lse within 1e-3, gradients per element as
    ``close_grads``."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    gen = torch.Generator("cuda").manual_seed(99)
    for s_q, s_kv, H, hk, W, dtype in (
            (200, 200, 8, 2, 37, torch.float32),
            (64, 300, 4, 1, 100, torch.float32),
            (130, 130, 4, 4, 1, torch.float32),
            (333, 333, 8, 2, 1000, torch.bfloat16),
            (256, 512, 8, 1, 70, torch.bfloat16)):
        q, k, v, dout = (torch.randn(1, n, h, 128, generator=gen,
                                     device="cuda").to(dtype)
                         for n, h in ((s_q, H), (s_kv, hk), (s_kv, hk),
                                      (s_q, H)))
        scale = 1.0 / math.sqrt(128)
        pos = s_kv - s_q
        out, lse = append_attention.launch(q, k, v, pos, None, scale,
                                           "flash_attention_local",
                                           with_lse=True, window=W)
        grads = flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    scale, window=W)
        ref = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                    window=W)
        ref_grads = flash_attention.flash_attention_bwd_plain(
            q, k, v, out, dout, scale, window=W)
        rows = torch.arange(s_q, device="cuda")[:, None] + pos
        cols = torch.arange(s_kv, device="cuda")[None]
        band = (cols <= rows) & (cols > rows - W)
        g = H // hk
        sc = torch.einsum("bskgd,btkd->bkgst",
                          q.reshape(1, s_q, hk, g, 128).float(),
                          k.float()) * scale
        ref_lse = torch.logsumexp(sc.masked_fill(~band, float("-inf")),
                                  dim=-1).reshape(1, H, s_q)
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip((out, lse) + tuple(grads),
                                (ref, ref_lse) + tuple(ref_grads))]
        edge = (f"local edges {str(dtype)[6:]} s_q={s_q} s_kv={s_kv} H={H} "
                f"hk={hk} W={W}")
        log(f"  {edge}: max abs err out {errs[0]:.2e} lse {errs[1]:.2e} "
            f"dq/dk/dv {errs[2]:.2e}/{errs[3]:.2e}/{errs[4]:.2e}")
        if dtype == torch.float32:
            tops = [float(b.abs().max()) for b in ref_grads]
            ok = (errs[0] <= 2e-5 and errs[1] <= 2e-5
                  and all(e <= 1e-5 * max(t, 1.0)
                          for e, t in zip(errs[2:], tops)))
        else:
            ok = (close_bf16(out, ref)[1] and errs[1] <= 1e-3
                  and close_grads(edge, grads, ref_grads)[1])
        if not ok:
            raise AssertionError(f"local flash kernels disagree with their "
                                 f"plain version at s_q={s_q} s_kv={s_kv} "
                                 f"W={W} {dtype}")


def check_flash_rows(record, randn, S, window, full=False, H=32, hk=8, D=128,
                     fwd_main=True, bwd_main=True):
    """The flash forward with lse and its backward at [1, S, H | hk, D]
    (32 | 8, 128 by default; the entry's 8 | 4, 64 and Gemma's widths of
    256 too), bf16, causal (``window`` None), under the LocalMask of
    ``window``, or under the FullMask (``full``); ``fwd_main`` /
    ``bwd_main``: the forward's / backward's row is its kernel's main one:
    each against its plain version, which runs one KV head (its g query
    heads) at a time, the same function in 1/8 of the memory (its f32
    scores take 1.1 GB per KV head at S = 8192); the backward against
    ``flash_attention_bwd_plain`` on the same out, per element
    (``close_grads``). Yardsticks: SDPA, causal, with the band as its
    mask, or without a mask. With a window also the prefill's call (no
    lse) and the causal kernel at the same S, which the local one must
    beat, or the kernel did not skip the tiles below the band."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    g = H // hk
    scale = 1.0 / math.sqrt(D)
    fwd_name, bwd_name = flash_attention._counters(window, D, full=full)
    label = (f"S={S} full" if full else f"S={S} causal" if window is None
             else f"S={S} W={window} local")
    if (H, hk, D) != (32, 8, 128):
        label += f" [{H} | {hk}, {D}]"
    q, k, v = randn(1, S, H, D), randn(1, S, hk, D), randn(1, S, hk, D)
    dout = randn(1, S, H, D)
    cells = S * S if full else band_cells(S, window or S)
    heads = [(slice(j * g, (j + 1) * g), slice(j, j + 1)) for j in range(hk)]

    def plain_fwd():
        return torch.cat([flash_attention.flash_attention_plain(
            q[:, :, hq], k[:, :, hkv], v[:, :, hkv], causal=not full,
            window=window) for hq, hkv in heads], dim=2)

    rows = torch.arange(S, device=q.device)
    band = (rows[None, :] <= rows[:, None]) | full
    if window is not None:
        band = band & (rows[None, :] > rows[:, None] - window)
    with torch.no_grad():
        ref = plain_fwd()
        lses = []
        for hq, hkv in heads:
            sc = torch.einsum("bshd,btd->bhst", q[:, :, hq].float(),
                              k[:, :, hkv.start].float()) * scale
            lses.append(torch.logsumexp(sc.masked_fill(~band, float("-inf")),
                                        dim=-1))
            del sc
        ref_lse = torch.cat(lses, dim=1)
        del lses

    def fwd(name=fwd_name, win=window, kind="full" if full else None):
        return append_attention.launch(q, k, v, 0, None, scale, name,
                                       with_lse=True, window=win, kind=kind)

    out, lse = fwd()
    err, ok = close_bf16(out, ref)
    lse_err = float((lse - ref_lse).abs().max())
    ok = ok and lse_err <= 1e-3        # f32, sums in another order
    log(f"  {fwd_name} lse vs plain: max abs err {lse_err:.3e} (tolerance "
        f"1e-3)")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = None if window is None else band[None, None]
    causal = window is None and not full

    def sdpa():
        return sdpa_gqa(qt, kt, vt, mask=mask, causal=causal)

    plain_ms = time_ms(plain_fwd, reps=3, warmup=1)
    sdpa_t = kernel_times(sdpa, reps=5, warmup=1)
    kernel_ms = kernel_times(fwd, reps=5, warmup=1)
    nbytes = 2 * S * (H + hk) * D * 2
    record(fwd_name, f"{label}, lse", err, ok, kernel_ms, plain_ms, sdpa_t,
           bound(nbytes + H * S * 4, 4 * D * H * cells, "bfloat16"),
           fwd_main)
    if window is not None:
        causal_ms = time_ms(lambda: fwd(flash_attention._counters(None, D)[0],
                                        None, None), reps=5, warmup=1)
        log(f"  causal kernel at S={S} (with lse) {causal_ms:.4f} ms, local "
            f"kernel W={window} {kernel_ms[0]:.4f} ms: ratio "
            f"{kernel_ms[0] / causal_ms:.3f} (visible cells {cells} vs "
            f"{S * (S + 1) // 2}, ratio {cells / (S * (S + 1) / 2):.3f})")
        if not kernel_ms[0] < causal_ms:
            raise AssertionError("the local flash forward is not faster than "
                                 "the causal one: the kernel did not skip "
                                 "the tiles below the band")

        def prefill():
            return flash_attention.flash_attention_bshd(q, k, v, causal=True,
                                                        window=window)

        out2 = prefill()
        err2, ok2 = close_bf16(out2, ref)
        record(fwd_name, f"{label} (prefill)", err2,
               ok2 and torch.equal(out2, out), kernel_times(prefill, reps=5,
                                                       warmup=1),
               plain_ms, sdpa_t, bound(nbytes, 4 * D * H * cells,
                                        "bfloat16"), False)
        del out2
    del ref, ref_lse

    def bwd():
        return flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   scale, window=window,
                                                   full=full)

    # the plain backward one KV head (its g query heads) at a time; its
    # time is the sum of the heads' times
    ref_grads = [[], [], []]
    plain_ms = 0.0
    for hq, hkv in heads:
        args = (q[:, :, hq], k[:, :, hkv], v[:, :, hkv], out[:, :, hq],
                dout[:, :, hq])

        def plain_bwd():
            return flash_attention.flash_attention_bwd_plain(
                *args, scale, window=window, full=full)

        for acc, gr in zip(ref_grads, plain_bwd()):
            acc.append(gr)
        plain_ms += time_ms(plain_bwd, reps=3, warmup=1)
    ref_grads = [torch.cat(parts, dim=2) for parts in ref_grads]
    err, ok = close_grads(bwd_name, bwd(), ref_grads)
    del ref_grads
    lib_leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    lib_out = sdpa_gqa(*lib_leaves, mask=mask, causal=causal)
    dout_t = dout.transpose(1, 2).contiguous()
    lib_ms = kernel_times(lambda: torch.autograd.grad(
        lib_out, lib_leaves, dout_t, retain_graph=True), reps=5, warmup=1)
    del lib_out, lib_leaves
    nbytes = (3 * S * H * D + 2 * S * hk * D) * 2 + H * S * 4 + (
        S * H * D + 2 * S * hk * D) * 2
    # S, dP, dV, dK and dQ: five products of 2 * D operations per pair
    record(bwd_name, label, err, ok, kernel_times(bwd, reps=5, warmup=1),
           plain_ms, lib_ms, bound(nbytes, 10 * D * H * cells, "bfloat16"),
           bwd_main)


# bytes each timed call of an MLA row's rotation must touch in all, so that
# no call finds its latent cache in the 50 MB L2
MLA_COLD_BYTES = 120e6
MLA_TOL = (1e-4, 1e-4)     # f32 on both sides, sums in another order
# untimed MLA rows (label, B, H, r, dr, T, dtype, pos): 8 heads (the JAX
# gate's smallest, a padded head tile), 24 heads (two head tiles, the last
# half full) in bf16 and f32, lengths 31 / 32 / 33 / 127 / 128 / 129 / 257
# (tile and split edges) and T, B 1 at T and at one column, a buffer of no
# whole number of tiles, small widths (tiny_mla's at 8 heads, the fewest
# the gate takes), widths of no whole k-step, f32 buffers (the CUDA-core
# body)
MLA_EDGE_CASES = (
    ("H=8", 8, 8, 512, 64, 4096, "bfloat16", None),
    ("H=24", 8, 24, 512, 64, 4096, "bfloat16", None),
    ("H=24 f32", 8, 24, 512, 64, 4096, "float32", None),
    ("tile edges", 8, 16, 512, 64, 4096, "bfloat16",
     [30, 31, 32, 126, 127, 128, 256, 4095]),
    ("B=1 full", 1, 16, 512, 64, 4096, "bfloat16", [4095]),
    ("B=1 one column", 1, 16, 512, 64, 4096, "bfloat16", [0]),
    ("T=1000", 3, 16, 512, 64, 1000, "bfloat16", [999, 500, 31]),
    ("tiny widths", 2, 8, 32, 16, 256, "bfloat16", [255, 40]),
    ("r=136 dr=24", 4, 16, 136, 24, 300, "bfloat16", [299, 0, 150, 64]),
    ("f32", 8, 16, 512, 64, 4096, "float32", None),
)
# DeepSeek-V2 / V3's heads, phase 2's rows at 128 (``check_mla_head_rows``)
MLA_V3_HEADS = 128
# those rows' (heads, buffer dtype): V3's in bf16 and f32, and 24 heads (a
# half-full last head tile) in bf16
MLA_HEAD_ROWS = ((MLA_V3_HEADS, "bfloat16"), (MLA_V3_HEADS, "float32"),
                 (24, "bfloat16"))


def mla_inputs(B, H, r, dr, T, dtype, gen, copies=1):
    """Pre-scaled f32 queries (scores of spread 2) and ``copies`` unit
    (c_kv, k_pe) buffers of ``dtype``, seeded."""
    import torch

    qs = 2.0 / (r + dr) ** 0.5
    q_lat = torch.randn(B, H, r, generator=gen, device="cuda") * qs
    q_pe = torch.randn(B, H, dr, generator=gen, device="cuda") * qs
    bufs = [(torch.randn(B, T, r, generator=gen, device="cuda").to(dtype),
             torch.randn(B, T, dr, generator=gen, device="cuda").to(dtype))
            for _ in range(copies)]
    return q_lat, q_pe, bufs


def mla_close(out, ref):
    """(max abs err, every |out - ref| <= 1e-4 + 1e-4 |ref|)."""
    diff = (out - ref).abs()
    return (float(diff.max()),
            bool((diff <= MLA_TOL[0] + MLA_TOL[1] * ref.abs()).all()))


def check_mla_rows(record):
    """The MLA decode at DeepSeek-V2-Lite's serving widths (B 8, H 16, r
    512, dr 64, T 4096, bf16 buffers, f32 pre-scaled queries): ragged
    per-row pos including 0 and T - 1; once more with an allowed mask
    holding an interior hole and one fully masked row, which must come out
    exactly 0; once more at the decode lengths of phase 10's profile. Each
    held against its plain version at 1e-4 + 1e-4 |p|, and two launches on
    the same inputs must give the same bits. Timed cold, as on the main
    path, where each of 27 layers has its own latent cache and a decode
    step finds it out of L2: the kernel and its yardstick (SDPA as MQA over
    [c_kv | k_pe] with the length mask) rotate over at least 4 copies of
    the buffers, together touching more than ``MLA_COLD_BYTES``; the warm
    figure (one copy, back in L2) beside it. The bound counts the bytes
    against the operations at the bf16 tensor rate; the f32 rate's bound
    is printed beside it. Then ``MLA_EDGE_CASES``, untimed."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import mla_decode

    dev = torch.device("cuda")
    bf = torch.bfloat16
    B, H, r, dr, T = 8, 16, 512, 64, 4096
    gen = torch.Generator(dev).manual_seed(4321)
    pos = torch.tensor([0, T - 1, 1000, 2047, 3071, 17, 4000, 2500],
                       dtype=torch.int32, device=dev)
    holed = torch.ones(B, T, dtype=torch.bool, device=dev)
    holed[2, 100:300] = False      # an interior hole
    holed[5] = False               # a row that sees no column
    # the ragged rows (the kernels line's row), with the mask, and the
    # lengths of phase 10's profiled decode (8 slots of 1024-token prompts
    # some steps in), where each row sees a quarter of the buffer
    serving = torch.arange(1040, 1040 + B, dtype=torch.int32, device=dev)
    log("  mla_decode: f32 on both sides, sums in another order: tolerance "
        "|k - p| <= 1e-4 + 1e-4 |p|; a fully masked row exactly 0; two "
        "launches the same bits; timed cold over copies of c_kv | k_pe "
        f"touching more than {MLA_COLD_BYTES / 1e6:.0f} MB, warm beside")
    for rows, allowed in ((pos, None), (pos, holed), (serving, None)):
        n_cols = int((rows.long() + 1).sum())
        copies = max(4, math.ceil(MLA_COLD_BYTES / (n_cols * (r + dr) * 2)))
        q_lat, q_pe, bufs = mla_inputs(B, H, r, dr, T, bf, gen, copies)
        ckv, kpe = bufs[0]
        out = mla_decode.mla_decode(q_lat, q_pe, ckv, kpe, rows, allowed)
        ref = mla_decode.mla_decode_plain(q_lat, q_pe, ckv, kpe, rows,
                                          allowed)
        err, ok = mla_close(out, ref)
        same = torch.equal(out, mla_decode.mla_decode(q_lat, q_pe, ckv, kpe,
                                                      rows, allowed))
        vis = torch.arange(T, device=dev)[None, :] <= rows[:, None].long()
        label = f"B={B} H={H} r={r} dr={dr} T={T} ragged pos"
        if rows is serving:
            label = f"B={B} H={H} r={r} dr={dr} T={T} pos 1040-{1039 + B}"
        if allowed is not None:
            vis = vis & allowed
            dead = bool((out[5] == 0).all())
            log(f"  mla_decode with allowed: the fully masked row is exactly "
                f"0: {dead}")
            ok = ok and dead
            label += ", allowed"
        log(f"  mla_decode {label}: two launches give the same bits: {same}")
        ok = ok and same
        mask = vis[:, None, None, :]
        q_sdpa = torch.cat([q_lat, q_pe], -1).to(bf)[:, :, None]
        k_sdpa = [torch.cat([c, k], -1)[:, None] for c, k in bufs]  # MQA
        turn = iter(range(1 << 62))

        def kernel(i=None):
            c, k = bufs[next(turn) % copies if i is None else i]
            return mla_decode.mla_decode(q_lat, q_pe, c, k, rows, allowed)

        def library(i=None):
            j = next(turn) % copies if i is None else i
            return sdpa_gqa(q_sdpa, k_sdpa[j], bufs[j][0][:, None],
                            mask=mask, scale=1.0)

        # every visible column's latent and rope key read once, the queries,
        # row limits (and the mask up to each limit), the output written once
        nbytes = (n_cols * (r + dr) * 2 + B * H * (r + dr) * 4 + B * 4
                  + B * H * r * 4 + (n_cols if allowed is not None else 0))
        ops = n_cols * H * (4 * r + 2 * dr)
        f32_bound = bound(nbytes, ops, "float32")
        warm = (profiled_ms(lambda: kernel(0)), profiled_ms(
            lambda: library(0)))
        times = kernel_times(kernel)
        log(f"  mla_decode {label}: {copies} copies; bound at the f32 rate "
            f"{f32_bound[0]:.5f} ({f32_bound[1]}), profiled_share "
            f"{f32_bound[0] / times[2]:.3f}")
        record("mla_decode", label + " cold", err, ok, times,
               time_ms(lambda: mla_decode.mla_decode_plain(
                   q_lat, q_pe, ckv, kpe, rows, allowed)),
               kernel_times(library), bound(nbytes, ops, "bfloat16"),
               rows is pos and allowed is None, warm=warm)
        del q_lat, q_pe, bufs, ckv, kpe, k_sdpa, out, ref
        torch.cuda.empty_cache()
    check_mla_edges()


def check_mla_edges():
    """``MLA_EDGE_CASES`` (pos None: the main rows' ragged pos), each held
    against the plain version at the MLA tolerance, two launches the same
    bits, no row NaN."""
    import torch

    from paddle_tpu_torch.ops.hopper import mla_decode

    gen = torch.Generator("cuda").manual_seed(77)
    worst = 0.0
    for label, B, H, r, dr, T, dt, lens in MLA_EDGE_CASES:
        if lens is None:
            lens = [0, T - 1, 1000, 2047, 3071, 17, 4000, 2500]
        rows = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q_lat, q_pe, bufs = mla_inputs(B, H, r, dr, T, getattr(torch, dt),
                                       gen)
        ckv, kpe = bufs[0]
        out = mla_decode.mla_decode(q_lat, q_pe, ckv, kpe, rows)
        ref = mla_decode.mla_decode_plain(q_lat, q_pe, ckv, kpe, rows)
        err, ok = mla_close(out, ref)
        ok = ok and torch.equal(out, mla_decode.mla_decode(
            q_lat, q_pe, ckv, kpe, rows))
        worst = max(worst, err)
        if not ok:
            raise AssertionError(
                f"mla_decode edge {label} (B={B} H={H} r={r} dr={dr} T={T} "
                f"{dt} pos {lens}): kernel disagrees with its plain version "
                f"or with itself (max abs err {err})")
    log(f"  mla_decode edges ({', '.join(c[0] for c in MLA_EDGE_CASES)}): "
        f"max abs err {worst:.3e}, all within tolerance, two launches the "
        "same bits each")


def check_mla_head_rows(record):
    """The MLA decode at ``MLA_HEAD_ROWS``: DeepSeek-V2 / V3's 128 heads in
    bf16 and f32 buffers, and 24 heads (a half-full last head tile) in
    bf16, at B 8, r 512, dr 64, T 4096 and the ragged lengths of the main
    row (pos 0, T - 1, 1000, 2047, 3071, 17, 4000, 2500, Σ(pos + 1)
    16,738), each held against its plain version at the MLA tolerance, two
    launches the same bits, and once more with an allowed mask holding an
    interior hole and a row that sees no column, which must come out
    exactly 0. Timed
    cold, as a decode step finds each layer's latent cache (kernel and SDPA
    as MQA rotate over copies touching more than ``MLA_COLD_BYTES``), the
    warm figure beside. The bound: the bytes (each visible column's latent
    and rope key, the queries, the limits and the output once) against the
    products, at 128 heads no longer small beside them: with q and P as
    hi + lo bf16 terms, 2 (4 r + 2 dr) operations a head and visible column
    at the bf16 tensor rate; the f32 body's 4 r + 2 dr at the f32 rate.
    The larger stands, and both are logged."""
    import math

    import torch

    from paddle_tpu_torch.ops.hopper import mla_decode

    dev = torch.device("cuda")
    B, r, dr, T = 8, 512, 64, 4096
    gen = torch.Generator(dev).manual_seed(4128)
    rows = torch.tensor([0, T - 1, 1000, 2047, 3071, 17, 4000, 2500],
                        dtype=torch.int32, device=dev)
    holed = torch.ones(B, T, dtype=torch.bool, device=dev)
    holed[2, 100:300] = False
    holed[5] = False
    n_cols = int((rows.long() + 1).sum())
    vis = torch.arange(T, device=dev)[None, :] <= rows[:, None].long()
    mask = vis[:, None, None, :]
    for H, name in MLA_HEAD_ROWS:
        dt = getattr(torch, name)
        es = dt.itemsize
        copies = max(4, math.ceil(MLA_COLD_BYTES / (n_cols * (r + dr) * es)))
        q_lat, q_pe, bufs = mla_inputs(B, H, r, dr, T, dt, gen, copies)
        ckv, kpe = bufs[0]
        out = mla_decode.mla_decode(q_lat, q_pe, ckv, kpe, rows)
        ref = mla_decode.mla_decode_plain(q_lat, q_pe, ckv, kpe, rows)
        err, ok = mla_close(out, ref)
        same = torch.equal(out, mla_decode.mla_decode(q_lat, q_pe, ckv, kpe,
                                                      rows))
        out_h = mla_decode.mla_decode(q_lat, q_pe, ckv, kpe, rows, holed)
        err_h, ok_h = mla_close(out_h, mla_decode.mla_decode_plain(
            q_lat, q_pe, ckv, kpe, rows, holed))
        dead = bool((out_h[5] == 0).all())
        label = f"B={B} H={H} r={r} dr={dr} T={T} ragged pos {name}"
        log(f"  mla_decode {label}: two launches the same bits {same}; with "
            f"allowed max abs err {err_h:.3e} ok={ok_h}, the fully masked "
            f"row exactly 0: {dead}")
        ok = ok and same and ok_h and dead
        q_sdpa = torch.cat([q_lat, q_pe], -1).to(dt)[:, :, None]
        k_sdpa = [torch.cat([c, k], -1)[:, None] for c, k in bufs]  # MQA
        turn = iter(range(1 << 62))

        def kernel(i=None):
            c, k = bufs[next(turn) % copies if i is None else i]
            return mla_decode.mla_decode(q_lat, q_pe, c, k, rows)

        def library(i=None):
            j = next(turn) % copies if i is None else i
            return sdpa_gqa(q_sdpa, k_sdpa[j], bufs[j][0][:, None],
                            mask=mask, scale=1.0)

        nbytes = (n_cols * (r + dr) * es + B * H * (r + dr) * 4 + B * 4
                  + B * H * r * 4)
        flops = n_cols * H * (4 * r + 2 * dr)
        rate = "bfloat16" if dt == torch.bfloat16 else "float32"
        ops = 2 * flops if dt == torch.bfloat16 else flops
        bnd = bound(nbytes, ops, rate)
        how = ("hi + lo terms at the bf16 tensor rate"
               if dt == torch.bfloat16 else "at the f32 rate")
        warm = (profiled_ms(lambda: kernel(0)),
                profiled_ms(lambda: library(0)))
        times = kernel_times(kernel)
        log(f"  mla_decode {label}: {copies} copies; bound by the bytes "
            f"{nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms, by the products "
            f"{ops / PEAK_OPS_PER_S[rate] * 1e3:.5f} ms ({how}): the "
            f"{bnd[1]} bound it")
        # SDPA takes over 20 ms a call here: 5 timed calls
        record("mla_decode", label + " cold", max(err, err_h), ok, times,
               time_ms(lambda: mla_decode.mla_decode_plain(
                   q_lat, q_pe, ckv, kpe, rows)),
               kernel_times(library, reps=5, warmup=1), bnd, False,
               warm=warm)
        del q_lat, q_pe, bufs, ckv, kpe, k_sdpa, out, ref, out_h
        torch.cuda.empty_cache()


def check_flash_mla_128_row(record):
    """The width-192 flash forward at DeepSeek-V3's 128 heads and its
    longest exact bucket in phase 28 (q [1, 512, 128, 192], v width 128,
    causal, V3's yarn softmax scale), bf16, against its plain version at
    the attention tolerance, SDPA causal beside, with its bound (the
    products of the visible cells)."""
    import torch

    from paddle_tpu_torch.models.deepseek import mla_softmax_scale
    from paddle_tpu_torch.ops.hopper import flash_attention

    gen = torch.Generator("cuda").manual_seed(4129)
    S, H, dqk, dv = V3_MTP_PROMPT, MLA_V3_HEADS, 192, 128
    scale = mla_softmax_scale(deepseek_v3_config())
    q, k = (torch.randn(1, S, H, dqk, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn(1, S, H, dv, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True,
                                               sm_scale=scale)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                sm_scale=scale)
    err, ok = close_bf16(out, ref)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    cells = S * (S + 1) // 2
    record("flash_attention_mla", f"[1,{S},{H},{dqk}|{dv}] causal "
           f"scale={scale:.4f}", err, ok,
           kernel_times(lambda: flash_attention.flash_attention_bshd(
               q, k, v, causal=True, sm_scale=scale)),
           time_ms(lambda: flash_attention.flash_attention_plain(
               q, k, v, causal=True, sm_scale=scale), reps=3, warmup=1),
           kernel_times(lambda: sdpa_gqa(qt, kt, vt, causal=True,
                                         scale=scale)),
           bound(2 * S * H * (2 * dqk + 2 * dv), 2 * (dqk + dv) * H * cells,
                 "bfloat16"), False)


def check_deepseek_kernels(record, randn):
    """DeepSeek-V2-Lite's kernels at its serving shapes: the MLA decode
    (``check_mla_rows``), the causal flash forward at q/k width 192, v
    width 128 (q [1, 2048, 16, 192], V2-Lite's yarn softmax scale), and
    rms_norm at the latent width 512. Yardsticks: SDPA causal at the same
    widths, F.rms_norm."""
    import torch.nn.functional as F

    from paddle_tpu_torch.models.deepseek import (DeepseekV2Config,
                                                  mla_softmax_scale)
    from paddle_tpu_torch.ops.hopper import flash_attention, fused_norm

    check_mla_rows(record)
    check_mla_head_rows(record)
    check_flash_mla_128_row(record)
    H = 16
    scale = mla_softmax_scale(DeepseekV2Config(rope_scaling=V2_LITE_YARN))
    S, dqk, dv = 2048, 192, 128
    q, k, v = randn(1, S, H, dqk), randn(1, S, H, dqk), randn(1, S, H, dv)
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True,
                                               sm_scale=scale)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                sm_scale=scale)
    err, ok = close_bf16(out, ref)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    cells = S * (S + 1) // 2
    record("flash_attention_mla", f"[1,{S},{H},{dqk}|{dv}] causal "
           f"scale={scale:.4f}", err, ok,
           kernel_times(lambda: flash_attention.flash_attention_bshd(
               q, k, v, causal=True, sm_scale=scale), reps=10),
           time_ms(lambda: flash_attention.flash_attention_plain(
               q, k, v, causal=True, sm_scale=scale), reps=3, warmup=1),
           kernel_times(lambda: sdpa_gqa(qt, kt, vt, causal=True,
                                         scale=scale), reps=10),
           bound(2 * S * H * (2 * dqk + 2 * dv), 2 * (dqk + dv) * H * cells,
                 "bfloat16"), True)
    del q, k, v, qt, kt, vt, out, ref
    check_mla_backward(record, randn, scale)

    d = 512
    for rows in (8, 2048):
        x, w = randn(rows, d), randn(d, scale=0.5) + 1
        out = fused_norm.rms_norm(x, w, 1e-6)
        ref = fused_norm.rms_norm_plain(x, w, 1e-6)
        err, ok = close_bf16(out, ref, atol=1e-6, rtol=2.0 ** -6)
        record("rms_norm", f"rows={rows} d={d}", err, ok,
               kernel_times(lambda: fused_norm.rms_norm(x, w, 1e-6)),
               time_ms(lambda: fused_norm.rms_norm_plain(x, w, 1e-6)),
               kernel_times(lambda: F.rms_norm(x, (d,), w, 1e-6)),
               bound(2 * rows * d * 2 + d * 2, 4 * rows * d, "bfloat16"),
               False)


def close_grads(name, grads, refs):
    """bf16 (dq, dk, dv) each held per element against the plain
    backward's: one rounding of f32 sums run in another order,
    |k - p| <= 2e-3 + 2^-7 |p|, with the median |p| logged beside the
    limit. Returns (max abs err, ok)."""
    err, ok = 0.0, True
    for g_name, gr, rg in zip(("dq", "dk", "dv"), grads, refs):
        e, o = close_bf16(gr, rg)
        med = float(rg.float().abs().median())
        log(f"  {name} {g_name}: max abs err {e:.3e}, median |plain| "
            f"{med:.3e} (tolerance 2e-3 + 2^-7 |plain|: "
            f"{2e-3 + 2.0 ** -7 * med:.3e} at the median) ok={o}")
        err, ok = max(err, e), ok and o
    return err, ok


def check_mla_backward(record, randn, scale):
    """The width-192 flash backward (``flash_attention_mla_bwd``): first at
    edge shapes through the autograd Function (``flash_attention_bshd`` on
    inputs that need a gradient): a sequence of 1000 (a partial last
    tile), a rectangular s_q 200 < s_kv 700 (pos 500), both bf16 at 16
    heads, and f32 at [1, 130 | 300, 4]; then at phase 12's shape
    [1, 4096, 16, 192 | 128], causal, bf16, from the forward's out and lse,
    beside SDPA's backward. The out is held against the plain forward and
    the gradients per element against ``flash_attention_bwd_plain`` on
    the same q, k, v, out and dout (delta from the kernel forward's out,
    as the kernel takes it): bf16 as ``close_grads`` (the out as the
    forward rows), f32 out within 2e-5 and each gradient within 1e-5 of
    max(1, its largest entry)."""
    import torch

    from paddle_tpu_torch.ops.hopper import append_attention, flash_attention

    H, dqk, dv = 16, 192, 128
    gen = torch.Generator("cuda").manual_seed(192)
    for s_q, s_kv, heads, dtype in ((1000, 1000, H, torch.bfloat16),
                                    (200, 700, H, torch.bfloat16),
                                    (130, 300, 4, torch.float32)):
        q, k, v, dout = (torch.randn(1, n, heads, d, generator=gen,
                                     device="cuda").to(dtype)
                         for n, d in ((s_q, dqk), (s_kv, dqk), (s_kv, dv),
                                      (s_q, dv)))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention.flash_attention_bshd(*leaves, causal=True,
                                                   sm_scale=scale)
        grads = torch.autograd.grad(out, leaves, dout)
        out = out.detach()
        ref = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                    sm_scale=scale)
        ref_grads = flash_attention.flash_attention_bwd_plain(q, k, v, out,
                                                              dout, scale)
        edge = (f"flash_attention_mla_bwd edge {str(dtype)[6:]} s_q={s_q} "
                f"s_kv={s_kv} H={heads}")
        if dtype == torch.float32:
            errs = [float((a - b).abs().max())
                    for a, b in zip((out,) + tuple(grads),
                                    (ref,) + tuple(ref_grads))]
            ok = errs[0] <= 2e-5 and all(
                e <= 1e-5 * max(float(b.abs().max()), 1.0)
                for e, b in zip(errs[1:], ref_grads))
            log(f"  {edge}: max abs err out {errs[0]:.2e} dq/dk/dv "
                f"{errs[1]:.2e}/{errs[2]:.2e}/{errs[3]:.2e} ok={ok}")
        else:
            e_out, ok = close_bf16(out, ref)
            log(f"  {edge}: max abs err out {e_out:.2e} ok={ok}")
            ok = close_grads(edge, grads, ref_grads)[1] and ok
        if not ok:
            raise AssertionError(f"the width-192 flash backward disagrees "
                                 f"with its plain version at s_q={s_q} "
                                 f"s_kv={s_kv} {dtype}")
    del q, k, v, dout, leaves, out, ref, grads, ref_grads

    S = TRAIN_SEQ
    q, k = randn(1, S, H, dqk), randn(1, S, H, dqk)
    v, dout = randn(1, S, H, dv), randn(1, S, H, dv)
    out, lse = append_attention.launch(q, k, v, 0, None, scale,
                                       "flash_attention_mla", with_lse=True)

    def bwd():
        return flash_attention.flash_attention_bwd(q, k, v, out, lse, dout,
                                                   scale)

    def plain_bwd():
        return flash_attention.flash_attention_bwd_plain(q, k, v, out, dout,
                                                         scale)

    err, ok = close_grads("flash_attention_mla_bwd", bwd(), plain_bwd())
    plain_ms = time_ms(plain_bwd, reps=3, warmup=1)
    lib_leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
    lib_out = sdpa_gqa(*lib_leaves, causal=True, scale=scale)
    dout_t = dout.transpose(1, 2).contiguous()
    lib_ms = kernel_times(lambda: torch.autograd.grad(
        lib_out, lib_leaves, dout_t, retain_graph=True), reps=5, warmup=1)
    del lib_out, lib_leaves
    cells = S * (S + 1) // 2
    # inputs q, k, v, out, dout, lse read once; dq, dk, dv written once
    nbytes = (S * H * (2 * dqk + 3 * dv) * 2 + H * S * 4
              + S * H * (2 * dqk + dv) * 2)
    # S (2 dqk), dP (2 dv), dV (2 dv), dK and dQ (2 dqk each) per pair
    record("flash_attention_mla_bwd", f"[1,{S},{H},{dqk}|{dv}] causal "
           f"scale={scale:.4f}", err, ok, kernel_times(bwd, reps=5, warmup=1),
           plain_ms, lib_ms,
           bound(nbytes, (6 * dqk + 4 * dv) * H * cells, "bfloat16"), True)


# ------------------------------------------------- phase 2: the update --

# one Llama-3-8B layer's tensors (q, k, v, o, gate, up, down, two norms)
# and a 64 Mi-element slice of the embedding: the update's shapes (the
# depth-4 set is the 128256 x 4096 embedding and four such layers)
LAYER_SHAPES = ((4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                (4096, 14336), (4096, 14336), (14336, 4096), (4096,),
                (4096,))
EMBED_SLICE = (16384, 4096)
# (label, parameter dtype, master, moment dtype, amsgrad, decoupled, clip)
UPDATE_ROWS = (
    ("recipe", "bfloat16", True, "bfloat16", False, True, False),
    ("amsgrad", "float32", False, "float32", True, False, False),
    ("clipped", "bfloat16", True, "bfloat16", False, True, True),
)


def update_row_state(row, shapes, gen):
    """(items on the card, hyper, clip norm or None) of one update row:
    random state as a few steps in (masters N(0, 0.02), m N(0, 1e-3), v
    (1e-3 N(0, 1))^2, gradients N(0, 1e-3)), the 1-D tensors excluded
    from decay, the hyper at step 3 (rate 3e-4, betas 0.9 / 0.95, decay
    0.1)."""
    import torch

    from paddle_tpu_torch.ops.hopper.adam_update import AdamHyper

    _, pdt, master, mdt, ams, decoupled, clip = row
    pdt, mdt = getattr(torch, pdt), getattr(torch, mdt)

    def rnd(shape, std):
        return torch.randn(shape, generator=gen, device="cuda").mul_(std)

    items = []
    for shape in shapes:
        w = rnd(shape, 0.02)
        state = {"moment1": rnd(shape, 1e-3).to(mdt),
                 "moment2": rnd(shape, 1e-3).square_().to(mdt)}
        if master:
            state["master"] = w
        if ams:
            state["moment2_max"] = (state["moment2"].float() * 1.5).to(mdt)
        items.append((w.to(pdt), rnd(shape, 1e-3).to(pdt), state,
                      len(shape) > 1))
    hp = AdamHyper(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8,
                   weight_decay=0.1, decoupled=decoupled, amsgrad=ams,
                   step=3)
    return items, hp, (1.0 if clip else None)


def copy_items(items, device):
    return [(p.to(device, copy=True), g.to(device, copy=True),
             {k: t.to(device, copy=True) for k, t in state.items()}, decay)
            for p, g, state, decay in items]


def item_outputs(items):
    """The tensors an update writes, in one order."""
    out = []
    for p, _, state, _ in items:
        out.append(p)
        out.extend(state[k] for k in sorted(state))
    return out


def bits_differ(a, b) -> int:
    """Elements of ``a`` and ``b`` (one shape and dtype, on the card) whose
    bits differ."""
    import torch

    view = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(view) != b.view(view)).sum())


def update_bytes(items) -> int:
    """Bytes the update must move: each gradient, moment and master (or
    parameter, without one) read once, each moment, master and parameter
    written once."""
    n = 0
    for p, g, state, _ in items:
        n += g.numel() * g.element_size() + p.numel() * p.element_size()
        for key, t in state.items():
            n += 2 * t.numel() * t.element_size()
        if "master" not in state:
            n += p.numel() * p.element_size()
    return n


def update_yardstick(items, hp, scale):
    """One PyTorch call computing the nearest function: ``_fused_adamw_``
    (decoupled) or ``_fused_adam_`` (L2), over f32 copies of the values,
    gradients and moments (the kernel's bf16 moments and masters are not
    its function); the clip scale as its gradient scale (it divides by
    it)."""
    import torch

    vals = [(st.get("master", p)).float().clone() for p, _, st, _ in items]
    grads = [g.float() for _, g, _, _ in items]
    ms = [st["moment1"].float() for _, _, st, _ in items]
    vs = [st["moment2"].float() for _, _, st, _ in items]
    vmax = ([st["moment2_max"].float() for _, _, st, _ in items]
            if hp.amsgrad else [])
    steps = [torch.full((), float(hp.step), device="cuda") for _ in items]
    inv = None if scale is None else (1.0 / scale).reshape(())
    fn = torch._fused_adamw_ if hp.decoupled else torch._fused_adam_

    def call():
        fn(vals, grads, ms, vs, vmax, steps, lr=hp.lr, beta1=hp.beta1,
           beta2=hp.beta2, weight_decay=hp.weight_decay, eps=hp.eps,
           amsgrad=hp.amsgrad, maximize=False, grad_scale=inv)

    return call


def check_update_rows(record):
    """Phase 2's ``adam_update`` rows: each variant over one Llama-3-8B
    layer plus a 64 Mi-element slice of the embedding, bit for bit against
    the plain version on the CPU from the same state (the clipped row given
    the plain version's scale, computed on the CPU); the plain version on
    the card logged against the CPU's bits (PyTorch on CUDA divides by a
    scalar through its reciprocal), not required."""
    import torch

    from paddle_tpu_torch.ops.hopper import adam_update as au
    from paddle_tpu_torch.ops.hopper import grad_norm as gn

    gen = torch.Generator("cuda").manual_seed(77)
    shapes = LAYER_SHAPES + (EMBED_SLICE,)
    n = sum(int(np.prod(s)) for s in shapes)
    log(f"phase 2: adam_update over one Llama-3-8B layer and a 64 Mi-element "
        f"slice of the embedding ({len(shapes)} tensors, {n} elements), step "
        f"3, rate 3e-4; each row against the plain version on the CPU, bit "
        f"for bit")
    for row in UPDATE_ROWS:
        t0 = time.perf_counter()
        items, hp, clip = update_row_state(row, shapes, gen)
        cpu = copy_items(items, "cpu")
        scale = cpu_scale = None
        if clip is not None:
            cpu_scale = gn.grad_norm_plain([g for _, g, _, _ in cpu],
                                           clip)[1]
            scale = cpu_scale.to("cuda")
        on_card = copy_items(items, "cuda")
        au.adam_update(items, hp, scale, au.Tables())
        au.adam_update_plain(cpu, hp, cpu_scale)
        au.adam_update_plain(on_card, hp, scale)
        torch.cuda.synchronize()
        differ, card_differ, err = 0, 0, 0.0
        for got, want, plain_card in zip(item_outputs(items),
                                         item_outputs(cpu),
                                         item_outputs(on_card)):
            want = want.to("cuda")
            differ += bits_differ(got, want)
            card_differ += bits_differ(plain_card, want)
            err = max(err, float((got.float() - want.float()).abs().max()))
        del cpu
        ok = differ == 0
        log(f"  adam_update {row[0]}: {differ} of the outputs' elements "
            f"differ from the plain version on the CPU (required 0); the "
            f"plain version on the card differs from the CPU's in "
            f"{card_differ} (logged only)"
            + ("" if scale is None else f"; clip scale {float(scale):.6g}")
            + f"; checked in {time.perf_counter() - t0:.1f}s")
        label = (f"{row[0]}: {len(shapes)} tensors, {n} elements, "
                 f"{row[1]} params{' + f32 master' if row[2] else ''}, "
                 f"{row[3]} moments")
        tables = au.Tables()
        record("adam_update", label, err, ok,
               kernel_times(lambda: au.adam_update(items, hp, scale, tables)),
               time_ms(lambda: au.adam_update_plain(on_card, hp, scale),
                       reps=5, warmup=1),
               kernel_times(update_yardstick(items, hp, scale), reps=10),
               bound(update_bytes(items), 16 * n, "float32"),
               row[0] == "recipe")
        del items, on_card
        torch.cuda.empty_cache()
    check_grad_norm_row(record, gen)


def check_grad_norm_row(record, gen):
    """``grad_norm`` over the gradients of the Llama-3-8B depth-4 set (the
    embedding, four layers, the final norm; bf16, N(0, 1e-3)): the norm
    within 1e-5 relative of the plain version's on the card (f32 sums of
    about 1.4e9 terms in another order), two calls bit-identical."""
    import torch

    from paddle_tpu_torch.ops.hopper import grad_norm as gn

    shapes = ((128256, 4096),) + LAYER_SHAPES * TRAIN_DEPTH + ((4096,),)
    grads = [torch.randn(s, generator=gen, device="cuda").mul_(1e-3).to(
        torch.bfloat16) for s in shapes]
    n = sum(g.numel() for g in grads)
    first = gn.grad_norm(grads, 1.0)
    second = gn.grad_norm(grads, 1.0)
    plain = gn.grad_norm_plain(grads, 1.0)
    torch.cuda.synchronize()
    rel = float((first[0] - plain[0]).abs() / plain[0])
    same = torch.equal(first, second)
    ok = rel <= 1e-5 and same
    log(f"  grad_norm over {len(grads)} bf16 gradients, {n} elements: norm "
        f"{float(first[0]):.7g} (plain on the card {float(plain[0]):.7g}, "
        f"rel err {rel:.2e}, required <= 1e-5), scale {float(first[1]):.7g} "
        f"(plain {float(plain[1]):.7g}); two calls bit-identical: {same}")

    def library():
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        return torch.stack(norms).square().sum().sqrt()

    record("grad_norm", f"{len(grads)} bf16 gradients, {n} elements",
           float((first[0] - plain[0]).abs()), ok,
           kernel_times(lambda: gn.grad_norm(grads, 1.0)),
           time_ms(lambda: gn.grad_norm_plain(grads, 1.0), reps=5, warmup=1),
           kernel_times(library), bound(2 * n + 8, 2 * n, "float32"), True)
    del grads
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 3 --

class _Timed:
    """Mix-in for ``ContinuousBatchEngine``: synchronises around each
    prefill and step to time them, and keeps the logits after the first
    decode step."""

    def _prefill_into(self, slot, req):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super()._prefill_into(slot, req)
        torch.cuda.synchronize()
        self.prefill_ms.append((int(req.ids.size),
                                (time.perf_counter() - t0) * 1e3))

    def step(self):
        import torch

        n_pre = len(self.prefill_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().step()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        pre = sum(ms for _, ms in self.prefill_ms[n_pre:])
        self.step_ms.append(total - pre)
        if self.first_logits is None:
            self.first_logits = self._last.float().clone()
        return out


def timed_engine(model, **kw):
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    class TimedEngine(_Timed, ContinuousBatchEngine):
        pass

    eng = TimedEngine(model, **kw)
    eng.prefill_ms, eng.step_ms, eng.first_logits = [], [], None
    return eng


def serve_run(model, card, label, prompts, news, fused, log_prefills=False,
              **engine_kw):
    """One serving run of the main path: launch counts zeroed just before
    and read just after. Returns (counts, stats, decode step ms list, the
    first decode step's logits, outputs); the engine and its pool go."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.utils.flags import flag_overrides

    cfg = model.config
    eng = timed_engine(model, **{**dict(max_batch=8, max_len=2048,
                                        page_size=16), **engine_kw})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with flag_overrides({"use_fused_decode_tail": fused}):
        reset_launches()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=m)
                for p, m in zip(prompts, news)]
        out = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    stats = eng.stats()
    for rid, m in zip(rids, news):
        toks = out[rid]
        if len(toks) != m or eng.finish_reason(rid) != "length":
            raise AssertionError(f"{label} request {rid}: {len(toks)} "
                                 f"tokens, reason {eng.finish_reason(rid)}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{label} request {rid}: token out of range")
    if not torch.isfinite(eng._last).all():
        raise AssertionError(f"{label}: non-finite logits")
    steps = stats["decode_steps"]
    dec_tokens = stats["tokens_generated"]
    dec_ms = sum(eng.step_ms)
    log(f"  [{card}] {label}: {len(rids)} requests, {dec_tokens} tokens, "
        f"{steps} decode steps, wall {wall:.2f}s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if log_prefills:
        for n, ms in eng.prefill_ms:
            log(f"  [{card}] {label}: prefill prompt={n} "
                f"bucket={eng._bucket(n)} ms={ms:.2f}")
    log(f"  [{card}] {label}: decode ms/step median="
        f"{statistics.median(eng.step_ms):.3f} mean={dec_ms / steps:.3f}; "
        f"decode tokens/s={dec_tokens / (dec_ms / 1e3):.1f}")
    log(f"  launches ({label}): {json.dumps(counts)}")
    outputs = [out[r] for r in rids]
    return counts, stats, eng.step_ms, eng.first_logits, outputs


def serve_full_width(profile=False):
    """Phase 3: the discrete path, the fused decode tail and the discrete
    path again (the two flag-off runs bracket the noise), then speculative
    decoding with the fused tail. Returns the launch counts of the counted
    runs, summed."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 3: Llama-3-8B, {n_layers} layers, bf16, "
        f"{n_params / 1e9:.2f}B parameters drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    card = card_line()
    lens = [100, 128, 256, 300, 512, 700, 1000, 1024, 64, 33]
    news = [16 if i % 2 == 0 else 64 for i in range(len(lens))]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in lens]
    runs = {}
    for label, fused in (("flag off", False), ("flag on", True),
                         ("flag off again", False)):
        runs[label] = serve_run(model, card, label, prompts, news, fused,
                                log_prefills=label == "flag off")
    off, on = runs["flag off"], runs["flag on"]
    require_launched(off[0], SERVING_KERNELS, "serving")
    require_launched(on[0], FUSED_KERNELS, "fused serving")
    steps = off[1]["decode_steps"]
    if on[1]["decode_steps"] != steps:
        raise AssertionError("flag-on and flag-off runs took different "
                             "numbers of decode steps")
    for counts, label in ((off[0], "flag off"), (on[0], "flag on")):
        if counts["paged_attention"] != n_layers * steps:
            raise AssertionError(f"{label}: paged_attention launched "
                                 f"{counts['paged_attention']} times for "
                                 f"{steps} steps of {n_layers} layers")
    fused_n = n_layers * steps
    if not (on[0]["fused_qkv_rope"] == on[0]["fused_epilogue"] == fused_n):
        raise AssertionError(f"fused kernels launched "
                             f"{on[0]['fused_qkv_rope']} / "
                             f"{on[0]['fused_epilogue']} times, expected "
                             f"{fused_n}")
    for name in ("rms_norm", "add_rms_norm"):
        fewer = off[0][name] - on[0].get(name, 0)
        if fewer != fused_n:
            raise AssertionError(f"{name}: {fewer} fewer launches with the "
                                 f"flag on, expected {fused_n}")
    same = sum(int(np.sum(a == b)) for a, b in zip(off[4], on[4]))
    n_tok = sum(len(a) for a in off[4])
    dlog = float((on[3] - off[3]).abs().max())
    log(f"  [{card}] fused vs discrete (bf16, reported only): "
        f"{same}/{n_tok} tokens identical ({same / n_tok:.3f}); first "
        f"decode step's logits max abs diff {dlog:.4f} (|logits| <= "
        f"{float(off[3].abs().max()):.3f}); per decode step "
        f"2 x {n_layers} fused launches for {2 * n_layers} fewer norm "
        f"launches")
    del runs

    spec_counts, spec_out = serve_speculative(model, card)
    gen_counts, gen_runs, gen_toks = generate_full_width(model, card)
    graphs_llama(model, card, prompts, news, off, on, spec_out, gen_runs,
                 gen_toks)
    if profile:
        profile_decode(model, card)
    engine_counts = engine_llama(model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    total = Counter(off[0])
    total.update(on[0])
    total.update(spec_counts)
    total.update(gen_counts)
    total.update(engine_counts)
    return total


def serve_speculative(model, card):
    """Speculative serving, fused tail on, k = SPEC_K: eight greedy requests
    whose prompts repeat a seeded 16-token pattern. The fused kernels'
    row counts are recorded by wrapping the two module functions the model
    calls (the launch counts stay the wrappers' own). Returns (counts,
    outputs)."""
    from paddle_tpu_torch.ops.hopper import decode_tail

    rows = {"fused_qkv_rope": Counter(), "fused_epilogue": Counter()}
    real = {name: getattr(decode_tail, name) for name in rows}

    def spy(name):
        def call(first, *a, **kw):
            rows[name][first.shape[0]] += 1
            return real[name](first, *a, **kw)
        return call

    prompts, news = spec_prompts(model.config.vocab_size)
    try:
        for name in rows:
            setattr(decode_tail, name, spy(name))
        counts, stats, step_ms, _, outputs = serve_run(
            model, card, f"speculative k={SPEC_K}, flag on", prompts, news,
            True, speculative_k=SPEC_K)
    finally:
        for name, fn in real.items():
            setattr(decode_tail, name, fn)
    n = stats["spec_dispatches"]
    rounds = stats["spec_emitted_tokens"] - stats["spec_accepted_tokens"]
    rate = stats["spec_accepted_tokens"] / max(rounds * (SPEC_K - 1), 1)
    spec_ms = sum(step_ms)
    log(f"  [{card}] speculative: {n} dispatches, acceptance rate {rate:.3f}"
        f", emitted tokens per slot per dispatch "
        f"{stats['accepted_tokens_per_dispatch']:.3f}, tokens per dispatch "
        f"{stats['spec_emitted_tokens'] / n:.2f}, ms per dispatch median "
        f"{statistics.median(step_ms):.3f} mean {spec_ms / n:.3f}, "
        f"tokens/s {stats['spec_emitted_tokens'] / (spec_ms / 1e3):.1f}; "
        f"fused kernel calls by rows "
        f"{json.dumps({k: dict(v) for k, v in rows.items()})}")
    # the verify chunk attends in PyTorch (chunk-causal mask), as the JAX
    # package does in XLA on every backend: no paged kernel on this path
    require_launched(counts, FUSED_KERNELS[:2], "speculative serving")
    for name, by_rows in rows.items():
        if by_rows[8 * SPEC_K] <= 0:
            raise AssertionError(f"{name} never ran with {8 * SPEC_K} rows "
                                 "on the speculative path")
    if stats["spec_dispatches"] != stats["decode_steps"]:
        raise AssertionError("a greedy speculative run took one-token steps")
    return counts, outputs


def spec_prompts(vocab):
    """Eight prompts that repeat a seeded 16-token pattern, 64 new tokens
    each: speculation's main path."""
    rng = np.random.RandomState(7)
    return ([np.tile(rng.randint(0, vocab, size=16), 16) for _ in range(8)],
            [64] * 8)


def require_launched(counts, names, path):
    for name in names:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")


# the fused-tail kernels' names in a trace: the bf16 bodies and the f32
# ones (and an earlier checkout's, which --decode-profile-only may run)
TAIL_KERNEL_NAMES = ("qkv_tc_kernel", "epilogue_tc_kernel",
                     "fused_qkv_rope_kernel", "fused_epilogue_kernel")


def profile_decode(model, card, n_steps=10, slots=8, max_len=2048,
                   prompt=512):
    """Where a decode step's time goes at full occupancy, with the fused
    tail off and on where the model's layers take it (the MLA family has
    none, so it is traced once): ``slots`` requests of ``prompt`` tokens;
    ``n_steps`` steps timed on the host clock, then ``n_steps`` more under
    ``torch.profiler`` for the device time and count of each kernel, and
    the host time of each PyTorch op. One stream, so kernel times do not
    overlap: their sum over the unprofiled wall time is the device's busy
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models.llama import fused_decode_structural
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.utils.flags import flag_overrides

    trunk = model.llama
    # GPT-2's blocks are ``h``; they take no fused tail
    layer = (trunk.layers if hasattr(trunk, "layers") else trunk.h)[0]
    tail = fused_decode_structural(layer, next(layer.parameters()).dtype)
    for fused in (False, True) if tail else (False,):
        with flag_overrides({"use_fused_decode_tail": fused}):
            eng = ContinuousBatchEngine(model, max_batch=slots,
                                        max_len=max_len)
            rng = np.random.RandomState(5)
            for _ in range(slots):
                eng.add_request(rng.randint(0, model.config.vocab_size,
                                            size=prompt),
                                max_new_tokens=2 * n_steps + 4)
            for _ in range(2):
                eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n_steps):
                    eng.step()
                torch.cuda.synchronize()
            rows, host = [], []
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:   # kernels, not host ops
                    rows.append((e.device_time_total / 1e3 / n_steps,
                                 e.count / n_steps, e.key))
                elif e.key.startswith("aten::"):
                    host.append((e.self_cpu_time_total / 1e3 / n_steps,
                                 e.count / n_steps, e.key))
            rows.sort(reverse=True)
            host.sort(reverse=True)
            busy_ms = sum(r[0] for r in rows)
            n_kern = sum(r[1] for r in rows)
            paged_ms = sum(r[0] for r in rows if "paged_" in r[2])
            tail_ms = sum(r[0] for r in rows
                          if any(k in r[2] for k in TAIL_KERNEL_NAMES))
            mla_ms = sum(r[0] for r in rows if "mla_decode" in r[2])
            log(f"profile: [{card}] {model.config.__class__.__name__} decode "
                f"at {slots} active slots, prompts {prompt}, max_len "
                f"{max_len}, fused tail {'on' if fused else 'off'}: "
                f"{wall_ms:.3f} ms/step wall (unprofiled), device busy "
                f"{busy_ms:.3f} ms/step (share {busy_ms / wall_ms:.3f}), "
                f"{n_kern:.0f} CUDA kernels launched per step; paged "
                f"attention kernels {paged_ms:.3f} ms/step (share of busy "
                f"{paged_ms / busy_ms:.3f}); fused-tail kernels "
                f"{tail_ms:.3f} ms/step (share of busy "
                f"{tail_ms / busy_ms:.3f}); MLA decode kernels "
                f"{mla_ms:.3f} ms/step (share of busy "
                f"{mla_ms / busy_ms:.3f})")
            for ms, count, key in rows[:12]:
                log(f"  {ms:8.3f} ms/step {count:7.1f}/step  {key[:80]}")
            log("  host time by op (self, profiled): " + "; ".join(
                f"{key} {ms:.2f} ms x{count:.0f}"
                for ms, count, key in host[:8]))
            eng.run_until_done()
            del eng


# ---------------------------------------------------------------- phase 4 --

def wiring_check():
    """Two layers at full width in f32, the same weights on the card and the
    CPU. Greedy tokens must be identical: card vs CPU (discrete path),
    fused vs discrete on the card, fused card vs CPU, and speculative
    (k = SPEC_K, fused) card vs the one-token CPU run."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.utils.flags import flag_overrides

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2, dtype="float32")
    gen = torch.Generator("cuda").manual_seed(1)
    m_gpu = LlamaForCausalLM(cfg, device="cuda", generator=gen)
    m_cpu = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    m_cpu.load_state_dict(m_gpu.state_dict())
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, size=37)

    def run(model, fused=False, k=None):
        with flag_overrides({"use_fused_decode_tail": fused}):
            eng = ContinuousBatchEngine(model, max_batch=1, max_len=64,
                                        speculative_k=k)
            rid = eng.add_request(prompt, max_new_tokens=8)
            first = eng._last[0].cpu()
            eng.step()
            step1 = eng._last[0].cpu()
            return eng.run_until_done()[rid], first, step1

    card, card_first, card_step1 = run(m_gpu)
    cpu, cpu_first, _ = run(m_cpu)
    fused, _, fused_step1 = run(m_gpu, fused=True)
    spec, _, _ = run(m_gpu, fused=True, k=SPEC_K)
    err = float((card_first - cpu_first).abs().max())
    ferr = float((fused_step1 - card_step1).abs().max())
    tol = 1e-3   # f32 on both sides, sums in another order on the card
    log(f"phase 4: 2 layers at full width, f32: card tokens {card.tolist()}"
        f" cpu tokens {cpu.tolist()} fused card tokens {fused.tolist()} "
        f"speculative (k={SPEC_K}, fused) card tokens {spec.tolist()}; "
        f"prefill logits card vs cpu max abs err {err:.3e} (tolerance "
        f"{tol}, |logits| <= {float(cpu_first.abs().max()):.3f}); first "
        f"decode step's logits fused vs discrete on the card max abs err "
        f"{ferr:.3e} (tolerance {tol})")
    for name, toks in (("card", card), ("fused card", fused),
                       ("speculative card", spec)):
        if not np.array_equal(toks, cpu):
            raise AssertionError(f"{name} and CPU greedy tokens differ")
    if not (err <= tol and ferr <= tol):
        raise AssertionError("logits differ beyond the tolerance")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5 --

def train_config(**kw):
    """The JAX package's 8B training recipe (bench.py ``_bench_config``)."""
    from paddle_tpu_torch.models.llama import LlamaConfig

    base = dict(max_position_embeddings=TRAIN_SEQ, tie_word_embeddings=True,
                fuse_linear_cross_entropy=True, dtype="bfloat16")
    base.update(kw)
    return LlamaConfig.llama3_8b(**base)


def make_train_step(model, learning_rate=3e-4, **opt_kw):
    """(``train_step``, its optimizer) of phase 5's AdamW (weight decay 0.1,
    bf16 moments, f32 masters); ``learning_rate`` a rate or a schedule,
    which the caller steps, and more AdamW keywords in ``opt_kw``."""
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate, parameters=model.parameters(),
                weight_decay=0.1, moment_dtype="bfloat16", **opt_kw)
    return train_step(model, lambda m, x, y: m(x, labels=y)[0], opt), opt


def recipe_text(opt_kw) -> str:
    """The log's description of ``make_train_step``'s AdamW with a recipe's
    keywords ``opt_kw``."""
    rate = opt_kw.get("learning_rate", 3e-4)
    parts = [f"{rate:g}" if isinstance(rate, float) else
             f"LinearWarmup {rate.start_lr:g} -> {rate.end_lr:g} over "
             f"{rate.warmup_steps} steps"]
    if "beta2" in opt_kw:
        parts.append(f"beta2 {opt_kw['beta2']:g}")
    clip = opt_kw.get("grad_clip")
    if clip is not None:
        parts.append(f"{type(clip).__name__}({clip.clip_norm:g})")
    return f"AdamW({', '.join(parts)}, wd 0.1, bf16 moments, f32 masters)"


def step_schedule(opt_kw):
    """Advance the recipe's learning-rate schedule, if it has one (the
    caller's job, as in the JAX package); return the rate just used."""
    sched = opt_kw.get("learning_rate", 3e-4)
    if not hasattr(sched, "step"):
        return sched
    used = sched.get_lr()
    sched.step()
    return used


def deepseek_recipe(start_lr=0.0) -> dict:
    """DeepSeek-V2's optimizer settings (the paper: AdamW, beta2 0.95,
    weight decay 0.1, gradient clipping at norm 1.0, a linear warm-up from
    0) with the warm-up cut to 2 steps from ``start_lr`` to a peak of 3e-4:
    fresh AdamW keywords, since a schedule is stateful."""
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, lr

    return dict(learning_rate=lr.LinearWarmup(3e-4, 2, start_lr, 3e-4),
                beta2=0.95, grad_clip=ClipGradByGlobalNorm(1.0))


def token_batch(vocab, seq, seed, device):
    """(inputs, labels) [1, seq] of one random token row."""
    import torch

    ids = np.random.RandomState(seed).randint(0, vocab, size=(1, seq + 1))
    ids = torch.from_numpy(ids).to(device)
    return ids[:, :-1], ids[:, 1:]


# the training figures of the eager update, which each run logs beside its
# own (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md names their runs): step
# ms, peak GiB and the profile's "other" ms
EARLIER_TRAINING = {"phase 5": (189.4, 25.47, 120.87),
                    "phase 8": (225.7, 17.26, 109.93),
                    "phase 12": (262.0, 36.38, 221.12)}
# launches of one decoder layer's forward that recompute repeats in the
# backward (Llama, Mistral's causal kernels)
RECOMPUTED = {"rms_norm": 1, "add_rms_norm": 1, "fused_rope": 2,
              "flash_attention_bshd": 1}


def train_run(phase, cfg, seq, kernels, seed, recipe=dict, keep=False,
              steps=TRAIN_STEPS):
    """The training main path of one configuration: ``train_step`` once to
    warm up, then ``steps`` timed steps on one fixed random batch, launch
    counts zeroed just before the first step and read just after the last;
    then one profiled step. ``recipe()`` gives the AdamW keywords beyond
    phase 5's (a schedule is stepped after each step). The update runs one
    ``adam_update`` launch a step (the bf16 set is one group) and, with a
    global-norm clip, one ``grad_norm``. Returns {"counts", "losses",
    "peak", "step_ms", "other_ms"} and, with ``keep``, "params": a copy of
    the parameters after the profiled step."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.weights import model_class

    model = model_class(cfg)(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(
                                 seed))
    n_params = sum(p.numel() for p in model.parameters())
    opt_kw = recipe()
    step, opt = make_train_step(model, **opt_kw)
    x, y = token_batch(cfg.vocab_size, seq, 0, "cuda")
    card = card_line()
    log(f"{phase}: {cfg.num_hidden_layers} layers, {n_params / 1e9:.3f}B "
        f"parameters, bf16, seq {seq}, batch 1, window "
        f"{cfg.sliding_window}, recompute {cfg.recompute}, "
        f"{recipe_text(opt_kw)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts zeroed just before, read just after
    reset_launches()
    losses, step_ms = [], []
    for _ in range(1 + steps):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_schedule(opt_kw)
    counts = dict(launches)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[1:])
    log(f"  [{card}] losses {[round(v, 4) for v in losses]}")
    log(f"  [{card}] step ms: warm-up {step_ms[0]:.1f}, then "
        f"{[round(v, 1) for v in step_ms[1:]]}; median {med:.1f} ms, "
        f"{seq / (med / 1e3):.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches ({1 + steps} steps): {json.dumps(counts)}")
    require_launched(counts, kernels, "training")
    groups = {(p.dtype, "master" in opt._state[name],
               opt._state[name]["moment1"].dtype)
              for name, p in model.named_parameters()}
    want_norm = 1 + steps if opt_kw.get("grad_clip") else 0
    log(f"  the update: {len(groups)} group(s) of tensors "
        f"{sorted(str(g) for g in groups)}; adam_update "
        f"{counts.get('adam_update', 0)} launches (required "
        f"{1 + steps}), grad_norm {counts.get('grad_norm', 0)} "
        f"(required {want_norm})")
    if (counts.get("adam_update", 0) != 1 + steps
            or counts.get("grad_norm", 0) != want_norm):
        raise AssertionError("the update's launches are not one a step")
    # logits at init: normed hidden (rms 1) times the output embedding
    # (std 0.02) have std 0.02 * sqrt(hidden); for V such logits the
    # expected loss is ln V + std^2 / 2
    sigma = cfg.initializer_range * np.sqrt(cfg.hidden_size)
    expect = np.log(cfg.vocab_size) + sigma ** 2 / 2
    log(f"  first loss {losses[0]:.4f}: expected {expect:.4f} (ln V = "
        f"{np.log(cfg.vocab_size):.4f}, + std^2/2 with std {sigma:.3f}); "
        f"ratio {losses[0] / expect:.4f}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if abs(losses[0] / expect - 1) > 0.05:
        raise AssertionError("first loss is not within 5% of its expectation")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
    for name, p in model.named_parameters():
        if p.grad is None or not float(p.grad.abs().max()) > 0:
            raise AssertionError(f"{name} got no gradient")
    by_group = profile_train_step(step, x, y, card, med)
    earlier = EARLIER_TRAINING.get(phase.split(":")[0])
    if earlier is not None:
        log(f"  [{card}] {phase.split(':')[0]} beside the earlier figures: "
            f"step {med:.1f} ms (eager update {earlier[0]}), peak "
            f"{peak / 2**30:.2f} GiB ({earlier[1]}), other "
            f"{by_group['other']:.2f} ms ({earlier[2]})")
    out = dict(counts=counts, losses=losses, peak=peak, step_ms=med,
               other_ms=by_group["other"])
    if keep:
        out["params"] = {name: p.detach().clone()
                         for name, p in model.named_parameters()}
    del step, model, opt
    torch.cuda.empty_cache()
    return out


def train_full_width():
    """Phase 5: the Llama-3-8B recipe at depth 4, sequence 4096; then the
    same run with ``recompute=True``: the same losses and parameters after
    the profiled step, bit for bit, a lower peak, and each recomputed
    kernel launched once more per layer and step (``RECOMPUTED``), every
    other kernel as often."""
    import torch

    base = train_run("phase 5: training, Llama-3-8B widths",
                     train_config(num_hidden_layers=TRAIN_DEPTH), TRAIN_SEQ,
                     TRAINING_KERNELS, 2, keep=True)
    rc = train_run("phase 5 with recompute: training, Llama-3-8B widths",
                   train_config(num_hidden_layers=TRAIN_DEPTH,
                                recompute=True), TRAIN_SEQ,
                   TRAINING_KERNELS, 2, keep=True)
    steps = 1 + TRAIN_STEPS
    want = {k: v + RECOMPUTED.get(k, 0) * TRAIN_DEPTH * steps
            for k, v in base["counts"].items()}
    differ = [name for name, t in base["params"].items()
              if not torch.equal(t, rc["params"][recompute_name(name)])]
    same_losses = base["losses"] == rc["losses"]
    log(f"  [{card_line()}] phase 5 recompute against without: losses equal "
        f"{same_losses}; parameters after the run bit-identical: "
        f"{len(base['params']) - len(differ)} of {len(base['params'])}"
        + (f" (differ: {differ[:6]})" if differ else "")
        + f"; peak {rc['peak'] / 2**30:.2f} GiB against "
        f"{base['peak'] / 2**30:.2f}; step {rc['step_ms']:.1f} ms against "
        f"{base['step_ms']:.1f}; launches {json.dumps(rc['counts'])} "
        f"(required {json.dumps(want)})")
    if not same_losses or differ:
        raise AssertionError("recompute changed the losses or the "
                             "parameters")
    if not rc["peak"] < base["peak"]:
        raise AssertionError("recompute did not lower the peak memory")
    if rc["counts"] != want:
        raise AssertionError("recompute's launches are not one more forward "
                             "per layer and step")
    return Counter(base["counts"]) + Counter(rc["counts"])


def recompute_name(name: str) -> str:
    """``llama.layers.N.x`` -> ``llama.layers.N.inner.x`` (the state name
    of the same parameter in a recompute model)."""
    parts = name.split(".")
    if parts[:2] == ["llama", "layers"]:
        parts.insert(3, "inner")
    return ".".join(parts)


def profile_train_step(step, x, y, card, step_ms):
    """Device time of one more step by kernel, from ``torch.profiler``; one
    stream, so kernel times add up, and their sum over the unprofiled step
    time ``step_ms`` is the device's busy share. The port's kernels are
    named ``*_kernel`` in csrc. Returns the device ms by group."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    ours, groups = {}, {"port kernels": 0.0, "GEMMs": 0.0, "other": 0.0}
    for ms, _, key in rows:
        tag = next((t for t in ("append_attention_kernel",
                                "append_attention_tc_kernel",
                                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                                "flash_bwd_dkdv_tc_kernel",
                                "flash_bwd_dq_tc_kernel",
                                "flash_bwd_delta_kernel", "rope_kernel",
                                "add_rms_norm_kernel", "rms_norm_kernel",
                                "adam_update_kernel", "sumsq_kernel",
                                "finish_kernel")
                    if t in key), None)
        if tag is not None:
            ours[tag] = ours.get(tag, 0.0) + ms
            groups["port kernels"] += ms
        elif any(t in key for t in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["GEMMs"] += ms
        else:
            groups["other"] += ms
    log(f"profile: [{card}] one training step: {step_ms:.1f} ms wall "
        f"(unprofiled median), device busy {busy:.1f} ms (share "
        f"{busy / step_ms:.3f}); by group (ms): "
        f"{json.dumps({k: round(v, 2) for k, v in groups.items()})}; the "
        f"port's kernels (ms): "
        f"{json.dumps({k: round(v, 2) for k, v in ours.items()})}")
    for ms, count, key in rows[:16]:
        log(f"  {ms:9.3f} ms {count:5d}x  {key[:80]}")
    return groups


# ---------------------------------------------------------------- phase 6 --

def train_wiring_check(phase="phase 6: training wiring", cfg=None, seq=128,
                       seed=3, recipe=dict, steps=1, grad_tol=1e-4):
    """``steps`` train steps of f32 weights on the card and on the CPU,
    AdamW keywords from ``recipe()`` (its schedule stepped after each
    step), a fresh random batch each step, as training takes one. Before
    each step the CPU model and optimizer take the card's weights and
    optimizer state, so both sides start every step from the same state:
    each step's loss, every gradient and every parameter after it must
    agree (the gradients within ``grad_tol`` of each tensor's largest).
    A ``grad_tol`` above 1e-4 is held up by the card's own plain route:
    the card's gradients at the first step's state and batch are also
    taken with every port kernel replaced by its plain version on the
    card (``plain_kernels``, no update), the kernels' gradients must agree
    with those within 1e-4 of each tensor's largest, and the plain route's
    distance from the CPU's (PyTorch's own ops on the two devices) is
    logged beside. Returns the card steps' launch counts.

    On one repeated batch two updates take a V2-Lite pair's loss from
    11.87 to 0.0064, and at that loss softmax cross-entropy's p - 1 is
    f32 rounding on both sides (losses 3.5e-05 apart from equal state):
    fresh batches keep each step at a loss near ln V."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.weights import model_class

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg is None:
        cfg = train_config(num_hidden_layers=2, dtype="float32")
    cls = model_class(cfg)
    m_gpu = cls(cfg, device="cuda",
                generator=torch.Generator("cuda").manual_seed(seed))
    # a copy of the card's model, which takes the card's weights again
    # before each step (drawing its own on the CPU took 11 s at Gemma-7B's
    # widths)
    m_cpu = cpu_copy(m_gpu)
    sides = []
    for model in (m_gpu, m_cpu):
        opt_kw = recipe()
        step, opt = make_train_step(model, **opt_kw)
        sides.append((model, opt_kw, step, opt))
    log(f"{phase}, {cfg.num_hidden_layers} layers at full width, f32, seq "
        f"{seq}, window {cfg.sliding_window}, {steps} step(s) of "
        f"{recipe_text(sides[0][1])}, a fresh batch each; the CPU side takes "
        f"the card's weights and optimizer state before each step. "
        f"Tolerances: loss 1e-5 "
        f"relative, gradients {grad_tol:g} of each tensor's largest, "
        f"parameters "
        f"2 x the step's rate, share of a tensor off by > 1e-6 1e-3")
    ok = True
    plain = None
    if grad_tol > 1e-4:
        with plain_kernels():
            m_gpu(*token_batch(cfg.vocab_size, seq, 4, "cuda"))[0].backward()
        plain = {name: p.grad.detach().clone()
                 for name, p in m_gpu.named_parameters()}
        m_gpu.zero_grad(set_to_none=True)
    reset_launches()
    for i in range(steps):
        m_cpu.load_state_dict(m_gpu.state_dict())
        sd = sides[0][3].state_dict()
        sd["state"] = {name: {k: t.to("cpu", copy=True)
                              for k, t in st.items()}
                       for name, st in sd["state"].items()}
        sides[1][3].set_state_dict(sd)
        losses, rates = [], []
        for model, opt_kw, step, opt in sides:
            losses.append(float(step(*token_batch(cfg.vocab_size, seq, 4 + i,
                                                  model.device))))
            rates.append(step_schedule(opt_kw))
        # f32 on both sides, sums in another order on the card. An Adam
        # step moves a weight by about lr * g / (|g| + eps), so where |g|
        # is at the rounding noise the step may differ: the bulk must
        # agree within 1e-6, at most 0.1% of a tensor may differ, and by
        # no more than 2 x the step's rate
        p_tol = 2 * rates[0]
        loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
        # the CPU side's gradients and parameters are compared on the card
        # (a copy each; the same differences, in a fraction of the time)
        g_err, g_name, p_err, p_share = 0.0, "", 0.0, 0.0
        cpu_grads = {}
        cpu_params = dict(m_cpu.named_parameters())
        for name, p in m_gpu.named_parameters():
            q = cpu_params[name]
            q_grad = q.grad.to(p.device)
            if plain is not None:
                cpu_grads[name] = q_grad
            e = float((p.grad - q_grad).abs().max() / q_grad.abs().max())
            if e > g_err:
                g_err, g_name = e, name
            d = (p.detach() - q.detach().to(p.device)).abs()
            p_err = max(p_err, float(d.max()))
            p_share = max(p_share, float((d > 1e-6).float().mean()))
        step_ok = (loss_err <= 1e-5 and g_err <= grad_tol and p_err <= p_tol
                   and p_share <= 1e-3 and rates[0] == rates[1])
        if plain is not None and i == 0:
            k_err, k_name, c_err, c_name = 0.0, "", 0.0, ""
            for name, p in m_gpu.named_parameters():
                ref = plain[name]
                e = float((p.grad - ref).abs().max() / ref.abs().max())
                if e > k_err:
                    k_err, k_name = e, name
                q = cpu_grads[name]
                e = float((ref - q).abs().max() / q.abs().max())
                if e > c_err:
                    c_err, c_name = e, name
            log(f"  step 1 on the card with every port kernel replaced by "
                f"its plain version: the kernels' gradients against it, max "
                f"rel err {k_err:.2e} ({k_name}; tolerance 1e-4); it "
                f"against the CPU's {c_err:.2e} ({c_name}: PyTorch's own "
                f"ops on the two devices)")
            step_ok = step_ok and k_err <= 1e-4
            plain = None
        del cpu_grads
        log(f"  step {i + 1} at rate {rates[0]:g}: loss card {losses[0]} cpu "
            f"{losses[1]} (rel err {loss_err:.2e}); gradients max rel err "
            f"{g_err:.2e} ({g_name}); parameters after it max abs err "
            f"{p_err:.2e} (tolerance {p_tol:.1e}), largest share off by > "
            f"1e-6 {p_share:.2e}; ok={step_ok}")
        ok = ok and step_ok
    counts = dict(launches)
    log(f"  card launches {json.dumps(counts)}")
    if not ok:
        raise AssertionError("card and CPU training steps differ")
    del m_gpu, m_cpu, sides
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 7 --

def mistral_config(**kw):
    from paddle_tpu_torch.models import MistralConfig

    return MistralConfig.mistral_7b(**{"dtype": "bfloat16", **kw})


def serve_mistral(profile=False):
    """Phase 7: Mistral-7B (all 32 layers, bf16, random weights) behind
    ``ContinuousBatchEngine(max_batch=4, max_len=12288)``: prompts of 8192
    and 2048 tokens (exact buckets: the LocalMask flash kernel, the band
    biting at 8192 only), 4700 (padded to 8192) and 300 (padded to 512),
    both padded ones through the f32 einsum as in the JAX package; decode
    over a cache wider than the window through the band gather. Served with
    the fused decode tail off, then on. Returns the summed launch counts."""
    import torch

    from paddle_tpu_torch.models import MistralForCausalLM
    from paddle_tpu_torch.models.llama import head_dim_of

    cfg = mistral_config()
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = MistralForCausalLM(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(
                                   5))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 7: Mistral-7B, {n_layers} layers, bf16, window "
        f"{cfg.sliding_window}, {n_params / 1e9:.2f}B parameters drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    card = card_line()
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in MISTRAL_LENS]
    news = [MISTRAL_NEW] * len(prompts)
    # exact buckets: page size (16) times a power of two
    n_exact = sum(1 for n in MISTRAL_LENS if n >= 16 and n & (n - 1) == 0)
    total = Counter()
    for label, fused in (("Mistral flag off", False),
                         ("Mistral flag on", True)):
        counts, stats, _, _, _ = serve_run(
            model, card, label, prompts, news, fused, log_prefills=True,
            max_batch=4, max_len=12288)
        steps = stats["decode_steps"]
        want = {"flash_attention_local": n_layers * n_exact,
                "flash_attention_bshd": 0, "append_attention": 0,
                "paged_attention": 0}
        if fused:
            want.update(fused_qkv_rope=n_layers * steps,
                        fused_epilogue=n_layers * steps)
        for name, n in want.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"{label}: {name} launched "
                                     f"{counts.get(name, 0)} times, expected "
                                     f"{n} ({steps} decode steps)")
        require_launched(counts, ("rms_norm", "add_rms_norm"), label)
        total.update(counts)
    log_units(model, card, "Mistral-7B", ("_prefill_steps",
                                          "_select_decode_steps"))
    kv = (2 * n_layers * 4 * 12288 * cfg.num_key_value_heads
          * head_dim_of(cfg) * 2)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  [{card}] phase 7 Mistral-7B after both engine runs: memory "
        f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"(weights {weights / 2**30:.2f} GiB); an engine's paged KV pool at "
        f"4 x 12288 takes {kv / 2**30:.2f} GiB")
    if profile:
        profile_decode(model, card, slots=4, max_len=12288, prompt=8192)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- phase 8 --

def train_mistral():
    """Phase 8: Mistral-7B widths at depth 4, sequence 8192 (above the
    4096 window), the training recipe of phase 5 with untied embeddings."""
    counts = train_run("phase 8: training, Mistral-7B widths",
                       mistral_config(num_hidden_layers=TRAIN_DEPTH,
                                      fuse_linear_cross_entropy=True),
                       LOCAL_SEQ, MISTRAL_TRAINING_KERNELS, 6)["counts"]
    per_run = TRAIN_DEPTH * (1 + TRAIN_STEPS)
    for name in ("flash_attention_local", "flash_attention_local_bwd"):
        if counts.get(name, 0) != per_run:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} "
                                 f"times in {1 + TRAIN_STEPS} steps, "
                                 f"expected {per_run}")
    if counts.get("flash_attention_bshd", 0) or counts.get(
            "flash_attention_bwd", 0):
        raise AssertionError("windowed training launched the causal kernels")
    return counts


# ---------------------------------------------------------------- phase 9 --

def window_wiring_check():
    """Two Mistral layers at full width in f32 with the window cut to 256
    (so the CPU's plain einsum stays small), the same weights on the card
    and the CPU: a 512-token exact-bucket prompt and 16 greedy tokens at
    max_len 1024 (the LocalMask flash kernel with the band biting, then
    decode through the band gather), greedy tokens identical and prefill
    logits within 1e-3; then one training step at sequence 512 with window
    128 held as phase 6 holds it."""
    import torch

    from paddle_tpu_torch.models import MistralForCausalLM
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mistral_config(num_hidden_layers=2, sliding_window=256,
                         dtype="float32")
    m_gpu = MistralForCausalLM(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(
                                   7))
    m_cpu = MistralForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    m_cpu.load_state_dict(m_gpu.state_dict())
    prompt = np.random.RandomState(9).randint(0, cfg.vocab_size, size=512)

    def run(model):
        eng = ContinuousBatchEngine(model, max_batch=1, max_len=1024)
        rid = eng.add_request(prompt, max_new_tokens=16)
        first = eng._last[0].cpu()
        return eng.run_until_done()[rid], first

    reset_launches()
    card, card_first = run(m_gpu)
    counts = dict(launches)
    cpu, cpu_first = run(m_cpu)
    err = float((card_first - cpu_first).abs().max())
    tol = 1e-3   # f32 on both sides, sums in another order on the card
    log(f"phase 9: windowed wiring, 2 Mistral layers at full width, f32, "
        f"window 256, prompt 512: card tokens {card.tolist()} cpu tokens "
        f"{cpu.tolist()}; prefill logits card vs cpu max abs err {err:.3e} "
        f"(tolerance {tol}, |logits| <= {float(cpu_first.abs().max()):.3f});"
        f" card launches {json.dumps(counts)}")
    if counts.get("flash_attention_local", 0) != cfg.num_hidden_layers:
        raise AssertionError("the windowed prefill did not launch the local "
                             "flash kernel once per layer")
    if counts.get("paged_attention", 0) != 0:
        raise AssertionError("windowed decode over a wider cache launched "
                             "the paged kernel instead of the band gather")
    if not np.array_equal(card, cpu):
        raise AssertionError("card and CPU greedy tokens differ (window)")
    if not err <= tol:
        raise AssertionError("windowed prefill logits differ beyond the "
                             "tolerance")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()
    counts = train_wiring_check(
        "phase 9: windowed training wiring",
        mistral_config(num_hidden_layers=2, sliding_window=128,
                       fuse_linear_cross_entropy=True, dtype="float32"),
        512, seed=8)
    for name in ("flash_attention_local", "flash_attention_local_bwd"):
        if counts.get(name, 0) != cfg.num_hidden_layers:
            raise AssertionError(f"windowed training step: {name} launched "
                                 f"{counts.get(name, 0)} times")


# --------------------------------------------------------------- phase 10 --

def deepseek_config(**kw):
    """DeepSeek-V2-Lite as published (deepseek-ai/DeepSeek-V2-Lite
    config.json): no preset in the JAX package, so built from its fields."""
    from paddle_tpu_torch.models import DeepseekV2Config

    base = dict(vocab_size=102400, hidden_size=2048, intermediate_size=10944,
                num_hidden_layers=27, num_attention_heads=16,
                num_key_value_heads=16, max_position_embeddings=163840,
                rms_norm_eps=1e-6, rope_theta=10000.0,
                rope_scaling=V2_LITE_YARN, tie_word_embeddings=False,
                n_routed_experts=64, n_shared_experts=2,
                num_experts_per_tok=6, moe_intermediate_size=1408,
                first_k_dense_replace=1, norm_topk_prob=False,
                routed_scaling_factor=1.0, moe_scoring_func="softmax",
                n_group=1, topk_group=1, router_aux_loss_coef=0.001,
                q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128, dtype="bfloat16")
    base.update(kw)
    return DeepseekV2Config(**base)


def serve_deepseek(profile=False):
    """Phase 10: DeepSeek-V2-Lite (all 27 layers, bf16, random weights)
    behind ``ContinuousBatchEngine(max_batch=8, max_len=4096)`` in latent
    mode, eight greedy prompts (exact buckets through the width-192 flash
    kernel, padded ones through the absorbed einsum), 64 new tokens each.
    Returns the launch counts."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM

    cfg = deepseek_config()
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = DeepseekV2ForCausalLM(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(11))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 10: DeepSeek-V2-Lite, {n_layers} layers, bf16, "
        f"{n_params / 1e9:.2f}B parameters drawn in "
        f"{time.perf_counter() - t0:.1f}s; MLA r={cfg.kv_lora_rank} "
        f"dr={cfg.qk_rope_head_dim}, {cfg.n_routed_experts} experts top-"
        f"{cfg.num_experts_per_tok} + {cfg.n_shared_experts} shared, "
        f"capacity factor {cfg.moe_capacity_factor}")
    card = card_line()
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in DEEPSEEK_LENS]
    news = [DEEPSEEK_NEW] * len(prompts)
    n_exact = sum(1 for n in DEEPSEEK_LENS if n >= 16 and n & (n - 1) == 0)
    counts, stats, _, _, outputs = serve_run(
        model, card, "DeepSeek-V2-Lite", prompts, news, False,
        log_prefills=True, max_batch=8, max_len=4096)
    steps = stats["decode_steps"]
    want = {"flash_attention_mla": n_layers * n_exact,
            "mla_decode": n_layers * steps, "flash_attention_bshd": 0,
            "flash_attention_local": 0, "append_attention": 0,
            "paged_attention": 0, "fused_qkv_rope": 0, "fused_epilogue": 0}
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"DeepSeek-V2-Lite: {name} launched "
                                 f"{counts.get(name, 0)} times, expected {n} "
                                 f"({steps} decode steps, {n_exact} exact "
                                 "prefills)")
    require_launched(counts, ("rms_norm", "add_rms_norm"), "DeepSeek serving")
    counts = Counter(counts)
    gen_counts, gen_runs, gen_toks = generate_deepseek(model, card)
    counts.update(gen_counts)
    graphs_deepseek(model, card, prompts, news, outputs, gen_runs, gen_toks)
    if profile:
        profile_decode(model, card, slots=8, max_len=4096, prompt=1024)
    counts.update(engine_latent(model, card))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- phase 11 --

def deepseek_wiring_check():
    """Two DeepSeek-V2-Lite layers at full width in f32 (one dense, one
    MoE), the same weights on the card and the CPU: a 64-token prompt (the
    exact bucket: the expanded flash kernel) and a 40-token one (padded to
    64: the absorbed einsum), 8 greedy tokens each through the MLA decode;
    tokens identical, prefill logits within 1e-3."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = deepseek_config(num_hidden_layers=2, dtype="float32")
    m_gpu = DeepseekV2ForCausalLM(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(13))
    m_cpu = DeepseekV2ForCausalLM(cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    m_cpu.load_state_dict(m_gpu.state_dict())
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in (64, 40)]

    def run(model):
        eng = ContinuousBatchEngine(model, max_batch=2, max_len=256)
        rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        first = eng._last.cpu().clone()
        out = eng.run_until_done()
        return [out[r] for r in rids], first, eng.stats()["decode_steps"]

    reset_launches()
    card, card_first, steps = run(m_gpu)
    counts = dict(launches)
    cpu, cpu_first, _ = run(m_cpu)
    err = float((card_first - cpu_first).abs().max())
    tol = 1e-3   # f32 on both sides, sums in another order on the card
    log(f"phase 11: DeepSeek wiring, 2 V2-Lite layers at full width, f32, "
        f"prompts 64 (exact) and 40 (padded): card tokens "
        f"{[t.tolist() for t in card]} cpu tokens {[t.tolist() for t in cpu]};"
        f" prefill logits card vs cpu max abs err {err:.3e} (tolerance {tol}, "
        f"|logits| <= {float(cpu_first.abs().max()):.3f}); card launches "
        f"{json.dumps(counts)}")
    if counts.get("flash_attention_mla", 0) != cfg.num_hidden_layers:
        raise AssertionError("the exact prefill did not launch the width-192 "
                             "flash kernel once per layer")
    if counts.get("mla_decode", 0) != cfg.num_hidden_layers * steps:
        raise AssertionError(f"mla_decode launched {counts.get('mla_decode')}"
                             f" times for {steps} steps")
    if not all(np.array_equal(a, b) for a, b in zip(card, cpu)):
        raise AssertionError("card and CPU greedy tokens differ (DeepSeek)")
    if not err <= tol:
        raise AssertionError("DeepSeek prefill logits differ beyond the "
                             "tolerance")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 12 --

def train_deepseek():
    """Phase 12: DeepSeek-V2-Lite at depth 4 (layer 0 dense, three MoE
    layers), full width, sequence 4096, DeepSeek-V2's optimizer settings
    (``deepseek_recipe``). The width-192 flash forward and backward run
    once per layer and step, no width-128 attention kernel."""
    counts = train_run("phase 12: training, DeepSeek-V2-Lite widths (cut: "
                       "the paper's warm-up of 2000 steps to 2)",
                       deepseek_config(num_hidden_layers=TRAIN_DEPTH,
                                       fuse_linear_cross_entropy=True),
                       TRAIN_SEQ, DEEPSEEK_TRAINING_KERNELS, 12,
                       recipe=deepseek_recipe)["counts"]
    per_run = TRAIN_DEPTH * (1 + TRAIN_STEPS)
    for name in ("flash_attention_mla", "flash_attention_mla_bwd"):
        if counts.get(name, 0) != per_run:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} "
                                 f"times in {1 + TRAIN_STEPS} steps, "
                                 f"expected {per_run}")
    for name in ("flash_attention_bshd", "flash_attention_bwd",
                 "flash_attention_local", "fused_rope"):
        if counts.get(name, 0):
            raise AssertionError(f"DeepSeek training launched {name}")
    return counts


# --------------------------------------------------------------- phase 13 --

def deepseek_train_wiring_check():
    """Phase 13: two V2-Lite layers (one dense, one MoE) at full width in
    f32, sequence 128, three steps of phase 12's recipe with the warm-up
    starting at 1e-4 (rates 1e-4, 2e-4, 3e-4: three real updates, clipped,
    each on a fresh batch), held to the card's own plain route
    (``train_plain_check``: the width-192 flash forward and backward, the
    norms, the Adam update and the clip's norm as their plain versions,
    each step from the same state). Its CPU side took about 60 s of the
    full run, which phase 28 needs; phase 11 holds V2-Lite's layers card
    against CPU. The kernels' side runs the f32 instantiation of the
    width-192 kernels at the weights of each step, once a layer and step,
    and ``grad_norm`` once a step."""
    cfg = deepseek_config(num_hidden_layers=2, dtype="float32",
                          fuse_linear_cross_entropy=True)
    steps = 3
    counts = train_plain_check("phase 13: DeepSeek training wiring", cfg,
                               seed=14, steps=steps,
                               recipe=lambda: deepseek_recipe(1e-4))
    want = {"flash_attention_mla": steps * cfg.num_hidden_layers,
            "flash_attention_mla_bwd": steps * cfg.num_hidden_layers,
            "grad_norm": steps, "adam_update": steps}
    require_counts("phase 13: DeepSeek training steps", counts, want)


# --------------------------------------------------------------- phase 14 --

def functional_api():
    """Phase 14: the Paddle flash-attention functional API at Llama-3-8B's
    attention width (32 | 8 heads, 128), bf16: ``flash_attention(causal=
    False)`` forward and backward at sequence 4096; ``flash_attn_unpadded``
    over a packed batch of segments 2048, 1024, 512, 384 and 200 (the last
    one not a multiple of 128: the plain composite, as in JAX);
    ``memory_efficient_attention`` at 32 heads with a custom scale. Each
    output is held per element against the plain version on the same
    inputs (the backward against the plain backward on the kernel's out).
    Counts are zeroed before and read after: ``flash_attention_full`` once
    per supported call or segment, ``flash_attention_full_bwd`` once per
    backward, nothing else."""
    import math

    import torch

    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.hopper import _build, flash_attention

    gen = torch.Generator("cuda").manual_seed(4242)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    S, H, hk, D = TRAIN_SEQ, 32, 8, 128
    scale = 1.0 / math.sqrt(D)
    q, k, v = (randn(1, S, h, D).requires_grad_() for h in (H, hk, hk))
    dout = randn(1, S, H, D)
    segs = (2048, 1024, 512, 384, 200)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(segs)]),
                      dtype=torch.int32, device="cuda")
    pq, pk, pv = (randn(int(cu[-1]), h, D) for h in (H, hk, hk))
    mq, mk, mv = (randn(1, S, H, D) for _ in range(3))
    m_scale = 0.05

    _build.reset_launches()
    t0 = time.perf_counter()
    out, sm = F.flash_attention(q, k, v, causal=False)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    packed = F.flash_attn_unpadded(pq, pk, pv, cu, cu, max(segs), max(segs))
    mea = IF.memory_efficient_attention(mq, mk, mv, scale=m_scale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = Counter(_build.launches)
    log(f"phase 14: functional API at Llama-3-8B attention width, bf16, "
        f"{wall:.3f}s (first calls): launches {dict(counts)}")
    n_kernel = 1 + sum(n % 128 == 0 for n in segs) + 1
    if counts != Counter(flash_attention_full=n_kernel,
                         flash_attention_full_bwd=1):
        raise AssertionError(f"phase 14: launches {dict(counts)}, want "
                             f"flash_attention_full {n_kernel} and "
                             f"flash_attention_full_bwd 1")
    if sm is not None:
        raise AssertionError("flash_attention must return (out, None)")
    with torch.no_grad():
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        ref = flash_attention.flash_attention_plain(qd, kd, vd, causal=False)
        err, ok = close_bf16(out, ref)
        del ref
        ref_grads = flash_attention.flash_attention_bwd_plain(
            qd, kd, vd, out.detach(), dout, scale, full=True)
    g_err, g_ok = close_grads("phase 14 flash_attention backward", grads,
                              ref_grads)
    del ref_grads
    log(f"  flash_attention(causal=False) [1, {S}, {H} | {hk}, {D}]: out "
        f"max abs err {err:.3e} ok={ok}; grads max abs err {g_err:.3e} "
        f"ok={g_ok}")
    ok = ok and g_ok
    with torch.no_grad():
        for i, n in enumerate(segs):
            a, b = int(cu[i]), int(cu[i + 1])
            ref = flash_attention.flash_attention_plain(
                pq[None, a:b], pk[None, a:b], pv[None, a:b], causal=False)
            e, o = close_bf16(packed[None, a:b], ref)
            log(f"  flash_attn_unpadded segment {n} "
                f"({'kernel' if n % 128 == 0 else 'plain composite'}): max "
                f"abs err {e:.3e} ok={o}")
            ok = ok and o
        qf = mq * (m_scale * math.sqrt(D))
        ref = flash_attention.flash_attention_plain(qf, mk, mv, causal=False)
        e, o = close_bf16(mea, ref)
        log(f"  memory_efficient_attention [1, {S}, {H}, {D}] scale "
            f"{m_scale}: max abs err {e:.3e} ok={o}")
        ok = ok and o

    def fwd_bwd():
        o, _ = F.flash_attention(q, k, v, causal=False)
        return torch.autograd.grad(o, (q, k, v), dout)

    def unpadded():
        return F.flash_attn_unpadded(pq, pk, pv, cu, cu, max(segs), max(segs))

    log(f"  flash_attention forward + backward {time_ms(fwd_bwd, 3, 1):.4f} "
        f"ms; flash_attn_unpadded ({len(segs)} segments) "
        f"{time_ms(unpadded, 3, 1):.4f} ms")
    if not ok:
        raise AssertionError("phase 14: a functional-API output disagrees "
                             "with its plain version")
    return counts


# --------------------------------------------------------------- phase 15 --

RING_DEGREE = 4


def ring_on_one_card():
    """Phase 15: ring attention at degree 4 on one card, Llama-3-8B's
    attention width (32 | 8 heads, 128), local sequence 4096 (global
    16384), bf16, through ``ring_attention(impl="auto")``: causal,
    non-causal, and causal with Mistral's window 4096. Counts are zeroed
    before and read after each: ``splash_hop`` once per live hop (the live
    ranks folded into the batch), 4, 4 and 2, and nothing else. Each result
    is held per element against the whole-sequence flash kernel at 16384
    (causal, full, local), which phase 2 holds against its plain version.
    The hops alone (the same launches, no combine) are timed beside the
    ring, so the combine's and the rolls' cost shows. Then the ring's
    gradients at local 1024 (global 4096) in f32 against the plain
    whole-sequence attention's, by autograd."""
    import math

    import torch

    from paddle_tpu_torch.distributed import context_parallel as cp
    from paddle_tpu_torch.ops.hopper import _build, flash_attention

    gen = torch.Generator("cuda").manual_seed(5151)
    n, s_loc, H, hk, D = RING_DEGREE, TRAIN_SEQ, 32, 8, 128
    ring = cp.LocalRing(n)
    scale = 1.0 / math.sqrt(D)
    q, k, v = (torch.randn(1, n * s_loc, h, D, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for h in (H, hk, hk))
    qs, ks, vs = (cp.shard(t, n) for t in (q, k, v))
    counts = Counter()
    log(f"phase 15: ring attention, degree {n}, local {s_loc} (global "
        f"{n * s_loc}), [{H} | {hk}, {D}], bf16, impl auto")
    for causal, window, hops in ((True, None, 4), (False, None, 4),
                                 (True, WINDOW, 2)):
        label = ("causal" if causal and window is None else "full"
                 if not causal else f"local W={window}")

        def run(causal=causal, window=window):
            return cp.ring_attention(qs, ks, vs, ring, causal=causal,
                                     window=window)

        _build.reset_launches()
        out = run()
        torch.cuda.synchronize()
        got = Counter(_build.launches)
        counts.update(got)
        if got != Counter(splash_hop=hops):
            raise AssertionError(f"phase 15 {label}: launches {dict(got)}, "
                                 f"want splash_hop {hops}")
        whole = flash_attention.flash_attention_bshd(q, k, v, causal=causal,
                                                     window=window)
        err, ok = close_bf16(cp.unshard(out), whole)
        ok = ok and not bool(torch.isnan(out).any())

        def hop(t, causal=causal, window=window):
            kind, offset = cp._hop_kind(t, s_loc, causal, window)
            lo, hi = cp._live_entries(ring, t, causal)
            r = hi - lo
            return flash_attention.hop_bshd(
                qs[lo:hi].reshape(r, s_loc, H, D),
                ks[lo:hi].reshape(r, s_loc, hk, D),
                vs[lo:hi].reshape(r, s_loc, hk, D), kind, offset=offset,
                window=window, scale=scale)

        live = range(cp._live_hops(n, s_loc, causal, window))
        ring_ms = time_ms(run, reps=3, warmup=1)
        hop_ms = time_ms(lambda: [hop(t) for t in live], reps=3, warmup=1)
        per_hop = [time_ms(lambda t=t: hop(t), reps=3, warmup=1)
                   for t in live]
        log(f"  ring {label}: per hop (kind, ranks, ms) " + ", ".join(
            f"({cp._hop_kind(t, s_loc, causal, window)[0]}, "
            f"{n - t if causal else n}, {ms:.3f})"
            for t, ms in zip(live, per_hop)))
        whole_ms = time_ms(lambda: flash_attention.flash_attention_bshd(
            q, k, v, causal=causal, window=window), reps=3, warmup=1)
        log(f"  ring {label}: splash_hop launches {got['splash_hop']}, max "
            f"abs err vs the whole-sequence kernel {err:.3e} ok={ok}; ring "
            f"{ring_ms:.3f} ms, its hop launches alone {hop_ms:.3f} ms "
            f"(combine and rolls {ring_ms - hop_ms:.3f} ms), whole-sequence "
            f"kernel {whole_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"phase 15 {label}: the ring disagrees with "
                                 f"the whole-sequence kernel")
        del out, whole
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()

    s_loc = 1024
    q, k, v = (torch.randn(1, n * s_loc, h, D, generator=gen, device="cuda")
               for h in (H, hk, hk))
    dout = torch.randn(1, n * s_loc, H, D, generator=gen, device="cuda")
    leaves = [cp.shard(t, n).requires_grad_() for t in (q, k, v)]
    _build.reset_launches()
    out = cp.ring_attention(*leaves, ring, causal=True)
    grads = torch.autograd.grad(cp.unshard(out), leaves, dout)
    torch.cuda.synchronize()
    if dict(_build.launches) != {"splash_hop": n}:
        raise AssertionError(f"phase 15 gradients: launches "
                             f"{dict(_build.launches)}")
    counts.update(_build.launches)
    grads = [cp.unshard(g) for g in grads]
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = flash_attention.flash_attention_plain(*ref_leaves, causal=True)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
    errs = [float((cp.unshard(out) - ref).detach().abs().max())] + [
        float((a - b).abs().max()) for a, b in zip(grads, ref_grads)]
    tops = [float(b.abs().max()) for b in ref_grads]
    ok = errs[0] <= 2e-5 and all(e <= 1e-5 * max(t, 1.0)
                                 for e, t in zip(errs[1:], tops))
    log(f"  ring gradients, local {s_loc} (global {n * s_loc}), f32, causal: "
        f"out max abs err {errs[0]:.2e}, dq/dk/dv {errs[1]:.2e}/"
        f"{errs[2]:.2e}/{errs[3]:.2e} (largest {tops[0]:.2e}/{tops[1]:.2e}/"
        f"{tops[2]:.2e}; tolerance 1e-5 of each) ok={ok}")
    if not ok:
        raise AssertionError("phase 15: the ring's gradients disagree with "
                             "the plain whole-sequence gradients")
    return counts


# --------------------------------------------------------------- phase 16 --

# generate at full width: B 4 x 512 unpadded (runs a, b, f), right-padded to
# 1024 (run c), 4 x 1024 in chunks of 256 (run d), 32 new tokens; beams (run
# e) B 2 x 512, 4 beams, 16 new; DeepSeek-V2-Lite (run g) B 4 x 512, 16 new
GEN_B, GEN_PROMPT, GEN_NEW = 4, 512, 32
GEN_CHUNK, GEN_BEAMS, GEN_BEAM_NEW, GEN_MLA_NEW = 256, 4, 16, 16


class _PrefillClock:
    """Times every call of ``generate``'s prefill units on the host clock,
    the card synchronised before and after (``.ms``, one entry a call)."""

    def __enter__(self):
        import torch

        from paddle_tpu_torch import generation

        self.ms, self._real = [], {}
        for cls in (generation._PrefillStep, generation._ChunkedPrefillStep):
            real = cls.__call__
            self._real[cls] = real if "__call__" in cls.__dict__ else None

            def timed(unit, *a, _real=real, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(unit, *a, **k)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out

            cls.__call__ = timed
        return self

    def __exit__(self, *exc):
        for cls, real in self._real.items():
            if real is None:    # inherited (a graphed unit's __call__)
                del cls.__call__
            else:
                cls.__call__ = real


def generate_run(model, card, label, ids, want, fused=False,
                 phase="phase 16", **kw):
    """One ``model.generate`` run of the main path: launch counts zeroed
    just before and read just after, ``want`` ({kernel: launches}) required
    exactly and the norm kernels launched; tokens in range and of the
    asked length. Logs the prefill ms, decode ms per forward (host clock
    around synchronised calls), tokens/s and peak memory. Returns (tokens
    [B, N] numpy, counts, decode ms per forward)."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.utils.flags import flag_overrides

    B, n_new = ids.shape[0], kw["max_new_tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with flag_overrides({"use_fused_decode_tail": fused}), \
            _PrefillClock() as clock:
        reset_launches()
        t0 = time.perf_counter()
        out = model.generate(ids, **kw)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        counts = dict(launches)
    toks = out.cpu().numpy()
    if toks.shape != (B, n_new):
        raise AssertionError(f"{phase} {label}: tokens {toks.shape}, want "
                             f"{(B, n_new)}")
    if toks.min() < 0 or toks.max() >= model.config.vocab_size:
        raise AssertionError(f"{phase} {label}: token out of range")
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"{phase} {label}: {name} launched "
                                 f"{counts.get(name, 0)} times, expected {n}")
    require_launched(counts, [n for n in ("rms_norm", "add_rms_norm")
                              if want.get(n, 1)], f"generate {label}")
    pre = sum(clock.ms)
    dec = total - pre
    log(f"  [{card}] {phase} {label}: B {B}, {n_new} new tokens: prefill "
        f"{pre:.2f} ms; decode {dec / (n_new - 1):.3f} ms per forward "
        f"({n_new - 1} forwards), {B * (n_new - 1) / (dec / 1e3):.1f} "
        f"tokens/s; whole call {total:.1f} ms, "
        f"{B * n_new / (total / 1e3):.1f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches ({phase} {label}): {json.dumps(counts)}")
    return toks, counts, dec / (n_new - 1)


def engine_tokens(model, prompts, n_new, max_len=2048):
    """Each prompt's greedy tokens from ``ContinuousBatchEngine`` (one slot
    a prompt)."""
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    eng = ContinuousBatchEngine(model, max_batch=len(prompts),
                                max_len=max_len)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    out = eng.run_until_done()
    return np.stack([out[r] for r in rids])


def generate_full_width(model, card):
    """Phase 16, runs a-f, on phase 3's Llama-3-8B (32 layers, bf16),
    greedy, ``eos_token_id=None`` so every run has its length; then the
    token agreement of each run with ``ContinuousBatchEngine`` on the same
    prompts (bf16: reported, not required). Returns (the summed counts,
    the runs {label: (ids, counts wanted, keywords)}, their tokens)."""
    import torch

    L = model.config.num_hidden_layers
    V = model.config.vocab_size
    n, nb = GEN_NEW - 1, GEN_BEAM_NEW - 1
    rng = np.random.RandomState(16)
    dev = model.device
    ids_a = torch.from_numpy(rng.randint(0, V, (GEN_B, GEN_PROMPT))).to(dev)
    ids_c = torch.from_numpy(rng.randint(0, V, (GEN_B, 1024))).to(dev)
    mask_c = (torch.arange(1024, device=dev)[None, :]
              < torch.tensor(DECODE_PROMPTS, device=dev)[:, None]).int()
    ids_d = torch.from_numpy(rng.randint(0, V, (GEN_B, 1024))).to(dev)
    log(f"phase 16: generate at full width, Llama-3-8B ({L} layers, bf16, "
        f"phase 3's model), greedy, no eos")
    runs = {
        "a dense": (ids_a, {"flash_attention_bshd": L,
                            "append_attention": L * n,
                            "paged_attention": 0}, {}),
        "b paged": (ids_a, {"flash_attention_bshd": L,
                            "paged_attention": L * n,
                            "append_attention": 0},
                    {"paged": True, "page_size": 16}),
        "c right-padded": (ids_c, {"append_attention": L + L * n,
                                   "flash_attention_bshd": 0,
                                   "paged_attention": 0},
                           {"attention_mask": mask_c}),
        # chunk 0 (pos 0, no column mask) takes the flash kernel, chunks
        # 1-3 append attention
        "d chunked": (ids_d, {"flash_attention_bshd": L,
                              "append_attention": 3 * L + L * n,
                              "paged_attention": 0},
                      {"prefill_chunk_size": GEN_CHUNK}),
        "e beams": (ids_a[:2], {"flash_attention_bshd": L,
                                "append_attention": L * nb,
                                "paged_attention": 0},
                    {"num_beams": GEN_BEAMS,
                     "max_new_tokens": GEN_BEAM_NEW}),
        "f fused tail": (ids_a, {"flash_attention_bshd": L,
                                 "append_attention": L * n,
                                 "fused_qkv_rope": L * n,
                                 "fused_epilogue": L * n,
                                 "paged_attention": 0}, {"fused": True}),
    }
    total, toks = Counter(), {}
    for label, (ids, want, kw) in runs.items():
        kw = dict({"max_new_tokens": GEN_NEW}, **kw)
        toks[label], counts, _ = generate_run(model, card, label, ids, want,
                                              **kw)
        total.update(counts)
    engine = {
        "a": engine_tokens(model, list(ids_a.cpu().numpy()), GEN_NEW),
        "c": engine_tokens(model, [r[:m] for r, m in zip(
            ids_c.cpu().numpy(), DECODE_PROMPTS)], GEN_NEW),
        "d": engine_tokens(model, list(ids_d.cpu().numpy()), GEN_NEW)}
    parts = []
    for label in ("a dense", "b paged", "c right-padded", "d chunked",
                  "f fused tail"):
        ref = engine[{"c": "c", "d": "d"}.get(label[0], "a")]
        same = int((toks[label] == ref).sum())
        parts.append(f"{label} {same}/{ref.size}")
    log(f"  [{card}] phase 16 token agreement with the engine on the same "
        f"prompts (bf16, reported only): {', '.join(parts)}")
    return total, runs, toks


def generate_deepseek(model, card):
    """Phase 16, run g, on phase 10's DeepSeek-V2-Lite (27 layers, bf16):
    the expanded flash prefill at width 192, then ``mla_decode`` over the
    dense latent buffer every step; ``paged=True`` raises before any
    launch. Returns (counts, the run, its tokens) as
    ``generate_full_width``."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches

    L = model.config.num_hidden_layers
    ids = torch.from_numpy(np.random.RandomState(17).randint(
        0, model.config.vocab_size, (GEN_B, GEN_PROMPT))).to(model.device)
    reset_launches()
    try:
        model.generate(ids, max_new_tokens=GEN_MLA_NEW, paged=True)
    except NotImplementedError as e:
        log(f"  phase 16 g: paged=True refused before any launch "
            f"({dict(launches)}): {e}")
    else:
        raise AssertionError("phase 16 g: paged generate on MLA ran")
    if launches:
        raise AssertionError(f"phase 16 g: the refused call launched "
                             f"{dict(launches)}")
    want = {"flash_attention_mla": L, "mla_decode": L * (GEN_MLA_NEW - 1),
            "flash_attention_bshd": 0, "append_attention": 0,
            "paged_attention": 0}
    toks, counts, _ = generate_run(model, card, "g DeepSeek-V2-Lite", ids,
                                   want, max_new_tokens=GEN_MLA_NEW)
    return counts, {"g DeepSeek-V2-Lite": (
        ids, want, {"max_new_tokens": GEN_MLA_NEW})}, {
        "g DeepSeek-V2-Lite": toks}


def cpu_copy(model):
    """The model with the same weights on the CPU (its rope tables, kept
    by length, are made again there)."""
    m = copy.deepcopy(model).cpu()
    m.llama._rope_cache.clear()
    return m


# (label, generate keywords) of the f32 wiring check; prompts of 40 tokens,
# the ragged ones 40 and 23, 6 new tokens
WIRING_PROMPT, WIRING_SHORT, WIRING_NEW = 40, 23, 6
WIRING_ROUTES = (
    ("dense", {}),
    ("ragged", {"attention_mask": "ragged"}),
    ("paged", {"paged": True, "page_size": 16}),
    ("chunked", {"prefill_chunk_size": 16}),
    ("no cache", {"use_cache": False}),
    ("beam 4", {"num_beams": 4}),
)
# the routes whose tokens the CPU computes: those that may differ from the
# dense route's (a ragged row, beams, and chunks, where an MoE's expert
# capacity is counted per chunk); the card's paged and uncached routes
# must give the CPU's dense tokens, which the CPU's own paged and
# uncached runs gave in every full run before they were left out for time
WIRING_CPU_ROUTES = ("dense", "ragged", "chunked", "beam 4")


def generate_wiring_check():
    """Phase 16 wiring, f32, ``allow_tf32`` off: two layers at full width of
    Llama-3-8B, Mistral-7B (window cut to 32, narrower than the 40 + 6
    tokens) and DeepSeek-V2-Lite, the same weights on the card and the CPU.
    Greedy tokens of each route on the card must equal the CPU's (those of
    the same route for ``WIRING_CPU_ROUTES``, the dense ones for the rest;
    DeepSeek's paged route raises); and on the card
    ``ContinuousBatchEngine`` (latent mode for DeepSeek) must give each
    request the tokens of solo ``generate``."""
    import torch

    from paddle_tpu_torch.models import (DeepseekV2ForCausalLM,
                                         LlamaForCausalLM,
                                         MistralForCausalLM)
    from paddle_tpu_torch.models.llama import LlamaConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    families = (
        ("Llama-3-8B", LlamaForCausalLM,
         LlamaConfig.llama3_8b(num_hidden_layers=2, dtype="float32")),
        ("Mistral-7B, window 32", MistralForCausalLM,
         mistral_config(num_hidden_layers=2, sliding_window=32,
                        dtype="float32")),
        ("DeepSeek-V2-Lite", DeepseekV2ForCausalLM,
         deepseek_config(num_hidden_layers=2, dtype="float32")),
    )
    for i, (name, cls, cfg) in enumerate(families):
        m_gpu = cls(cfg, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(20 + i))
        m_cpu = cpu_copy(m_gpu)
        rng = np.random.RandomState(20 + i)
        ids = rng.randint(0, cfg.vocab_size, (2, WIRING_PROMPT))
        ragged = np.ones((2, WIRING_PROMPT), np.int32)
        ragged[1, WIRING_SHORT:] = 0
        mla = cls is DeepseekV2ForCausalLM
        got, cpu = {}, {}
        for label, kw in WIRING_ROUTES:
            kw = dict(kw, max_new_tokens=WIRING_NEW)
            if "attention_mask" in kw:
                kw["attention_mask"] = ragged
            t = torch.from_numpy(ids)
            if mla and kw.get("paged"):
                try:
                    m_gpu.generate(t.cuda(), **kw)
                except NotImplementedError:
                    got[label] = "refused"
                    continue
                raise AssertionError(f"phase 16 wiring {name}: paged "
                                     "generate on MLA ran")
            card = m_gpu.generate(t.cuda(), **kw).cpu().numpy()
            if label in WIRING_CPU_ROUTES:
                cpu[label] = m_cpu.generate(t, **kw).numpy()
            ref = cpu[label if label in WIRING_CPU_ROUTES else "dense"]
            if not np.array_equal(card, ref):
                raise AssertionError(f"phase 16 wiring {name} {label}: card "
                                     f"tokens {card.tolist()} != CPU "
                                     f"{ref.tolist()}")
            got[label] = card.tolist()
        prompts = [ids[0], ids[1, :WIRING_SHORT]]
        eng = engine_tokens(m_gpu, prompts, WIRING_NEW, max_len=128)
        for b, p in enumerate(prompts):
            solo = m_gpu.generate(torch.from_numpy(p[None]).cuda(),
                                  max_new_tokens=WIRING_NEW).cpu().numpy()
            if not np.array_equal(eng[b], solo[0]):
                raise AssertionError(f"phase 16 wiring {name}: engine tokens "
                                     f"{eng[b].tolist()} != solo generate "
                                     f"{solo[0].tolist()} (request {b})")
        log(f"phase 16 wiring, {name}, 2 layers at full width, f32: card "
            f"tokens of every route = the CPU's (its "
            f"{', '.join(WIRING_CPU_ROUTES)}) {json.dumps(got)}; engine = solo "
            f"generate for both requests {eng.tolist()}")
        del m_gpu, m_cpu
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 16 wiring took {time.perf_counter() - t0:.1f}s")


def entry_on_card():
    """``paddle_tpu_torch.entry.entry()`` on the card: one forward of the
    entry model (4 layers, heads of 64), the flash kernel once per layer at
    its (64, 64) instantiation; its logits against the same state's on the
    CPU (plain versions) within 0.03 + 2^-7 |logit|; then the flash kernel
    alone at the entry's attention shape against its plain version at the
    attention tolerance; then the entry trains on the card (``entry_train``).
    Returns the launch counts of the forward and of the training step."""
    import torch

    from paddle_tpu_torch.entry import entry
    from paddle_tpu_torch.ops.hopper import (flash_attention, launches,
                                             reset_launches)

    fwd, (state, ids) = entry()
    reset_launches()
    logits = fwd(state, ids)
    torch.cuda.synchronize()
    counts = dict(launches)
    gen = torch.Generator("cuda").manual_seed(64)
    q, k, v = (torch.randn(2, 128, h, 64, generator=gen, device="cuda").to(
        torch.bfloat16) for h in (8, 4, 4))
    err, kernel_ok = close_bf16(
        flash_attention.flash_attention_bshd(q, k, v, causal=True),
        flash_attention.flash_attention_plain(q, k, v, causal=True))
    log(f"  flash_attention_bshd [2, 128, 8 | 4, 64] causal bf16: max abs "
        f"err {err:.3e}, within |k - p| <= 2e-3 + 2^-7 |p|: {kernel_ok}")
    if not kernel_ok:
        raise AssertionError("flash_attention_bshd at width 64 disagrees "
                             "with its plain version")
    cpu_fwd, _ = entry("cpu")
    ref = cpu_fwd({k: v.cpu() for k, v in state.items()}, ids.cpu())
    diff = (logits.float().cpu() - ref.float()).abs()
    ok = bool((diff <= 0.03 + 2.0 ** -7 * ref.float().abs()).all())
    log(f"phase 16 entry: logits {tuple(logits.shape)} {logits.dtype}, card "
        f"vs CPU max abs err {float(diff.max()):.4f} (tolerance 0.03 + 2^-7 "
        f"|p|, |logits| <= {float(ref.float().abs().max()):.3f}); launches "
        f"{json.dumps(counts)}")
    if counts.get("flash_attention_bshd", 0) != 4:
        raise AssertionError("entry: the flash kernel did not run once per "
                             "layer")
    if not (ok and bool(torch.isfinite(logits).all())):
        raise AssertionError("entry: card logits disagree with the CPU's")
    counts = Counter(counts)
    counts.update(entry_train())
    return counts


def entry_train():
    """The entry model trains on the card, as the JAX package trains it: one
    bf16 ``train_step`` (AdamW, ids [1, 128]), the (64, 64) flash backward
    once per layer; then the f32 training wiring of the same config, card
    = CPU (``train_wiring_check``). Returns the bf16 step's launch
    counts."""
    import dataclasses

    import torch

    from paddle_tpu_torch.entry import entry_config
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops.hopper import launches, reset_launches

    cfg = entry_config()
    n = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(64))
    step, _ = make_train_step(model)
    x, y = token_batch(cfg.vocab_size, 128, 64, "cuda")
    reset_launches()
    loss = float(step(x, y))
    torch.cuda.synchronize()
    counts = dict(launches)
    log(f"phase 16 entry training: one bf16 step of the entry model "
        f"({n} layers, heads 8 | 4 of 64, ids [1, 128]), loss {loss:.4f} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}); launches "
        f"{json.dumps(counts)}")
    if not math.isfinite(loss):
        raise AssertionError("entry training: non-finite loss")
    if counts.get("flash_attention_bwd_64", 0) != n or counts.get(
            "adam_update", 0) != 1:
        raise AssertionError("entry training: the (64, 64) backward did not "
                             "run once per layer, or the update not once")
    del model, step
    wired = train_wiring_check("phase 16 entry training wiring",
                               cfg=dataclasses.replace(cfg, dtype="float32"),
                               seq=128)
    if wired.get("flash_attention_bwd_64", 0) != n:
        raise AssertionError("entry training wiring: the (64, 64) backward "
                             "did not run once per layer")
    return counts


# --------------------------------------------------------------- phase 17 --

@contextlib.contextmanager
def eager_units():
    """Every graphed step unit runs its eager body (``unit.eager``) inside
    the block: phase 17's comparison runs, on the same entry points."""
    from paddle_tpu_torch.jit.cuda_graph import GraphedStep

    real = GraphedStep.__call__
    GraphedStep.__call__ = lambda unit, *a: unit.eager(*a)
    try:
        yield
    finally:
        GraphedStep.__call__ = real


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the trunks run every port kernel they reach as its
    plain version, on whatever device the tensors lie: the flash attention
    (and so its backward; DeepSeek's at width 192 too), the MLA decode,
    RoPE and both norms. Phase 26 (b) takes a card's gradients through it
    to tell the kernels' share of a card-to-CPU difference from PyTorch's
    own ops' share. The optimizers' Adam update runs as
    ``adam_update_plain`` and the global-norm clip's norm as
    ``grad_norm_plain`` too, so ``train_plain_check`` holds a whole step,
    update included, to its plain route on the card; phase 28 (c) holds
    serving to it (the units eager, ``eager_units``)."""
    from paddle_tpu_torch.models import deepseek, llama
    from paddle_tpu_torch.ops.hopper import (flash_attention, fused_norm,
                                             mla_decode)
    from paddle_tpu_torch.ops.hopper.adam_update import adam_update_plain
    from paddle_tpu_torch.ops.hopper.grad_norm import grad_norm_plain
    from paddle_tpu_torch.optimizer import clip, optimizer

    real = (llama.flash_attention_bshd, deepseek.flash_attention_bshd,
            deepseek.mla_decode, fused_norm.apply_rope, fused_norm.rms_norm,
            fused_norm.add_rms_norm, optimizer.adam_update, clip.grad_norm)
    llama.flash_attention_bshd = flash_attention.flash_attention_plain
    deepseek.flash_attention_bshd = flash_attention.flash_attention_plain
    deepseek.mla_decode = mla_decode.mla_decode_plain
    fused_norm.apply_rope = fused_norm.rope_ref
    fused_norm.rms_norm = fused_norm.rms_norm_plain
    fused_norm.add_rms_norm = fused_norm.add_rms_norm_plain
    optimizer.adam_update = (
        lambda items, hp, scale, tables: adam_update_plain(items, hp, scale))
    clip.grad_norm = grad_norm_plain
    try:
        yield
    finally:
        (llama.flash_attention_bshd, deepseek.flash_attention_bshd,
         deepseek.mla_decode, fused_norm.apply_rope, fused_norm.rms_norm,
         fused_norm.add_rms_norm, optimizer.adam_update,
         clip.grad_norm) = real


def log_units(model, card, label, want):
    """Phase 17.3: each graphed unit of ``model`` with its captures,
    replays and capture seconds, and the model's graph pool; every getter
    attribute of ``want`` must have a unit that replayed."""
    from paddle_tpu_torch.jit.cuda_graph import GraphedStep, pool_bytes

    replayed = Counter()
    for attr, units in sorted(model.__dict__.items()):
        if not attr.endswith("_steps"):
            continue
        for key, u in units.items():
            if not isinstance(u, GraphedStep):
                continue
            replayed[attr] += u.replays
            log(f"  [{card}] phase 17 {label}: {attr}{key}: captures "
                f"{u.captures}, replays {u.replays}, capture "
                f"{u.capture_s:.3f}s")
    log(f"  [{card}] phase 17 {label}: graph pool "
        f"{pool_bytes(model) / 2**20:.1f} MiB")
    for attr in want:
        if replayed[attr] <= 0:
            raise AssertionError(f"phase 17 {label}: no {attr} unit was "
                                 "replayed")


def require_same(label, got, want, got_counts=None, want_counts=None):
    """Phase 17.1: greedy (or seeded) tokens from the graphs and from the
    eager bodies identical; launch counts too where given."""
    same = len(got) == len(want) and all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(got, want))
    counts_same = got_counts is None or dict(got_counts) == dict(want_counts)
    log(f"  phase 17 {label}: graph tokens = eager tokens {same}"
        + ("" if got_counts is None else
           f"; launch counts equal {counts_same}"))
    if not same:
        raise AssertionError(f"phase 17 {label}: the graphs' tokens differ "
                             "from the eager bodies'")
    if not counts_same:
        raise AssertionError(f"phase 17 {label}: launches {dict(got_counts)}"
                             f" graphed, {dict(want_counts)} eager")


def sampled_engine(model, prompts, n_new, rows):
    """A seeded sampled engine run (the engine-wide settings, or with
    ``rows`` every other request overriding them: the per-row unit).
    Returns each request's tokens."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    seed(17)
    eng = ContinuousBatchEngine(model, max_batch=len(prompts), max_len=2048,
                                do_sample=True, temperature=0.8, top_k=50,
                                top_p=0.9)
    over = {"temperature": 0.6, "top_k": 20}
    rids = [eng.add_request(p, max_new_tokens=n_new,
                            **(over if rows and i % 2 else {}))
            for i, p in enumerate(prompts)]
    out = eng.run_until_done()
    return [out[r] for r in rids]


# each wrapper's launch counters by the kernels it launches once a call (a
# split kernel's combine pass runs besides, uncounted; the flash and append
# wrappers launch one family)
TRACED_KERNELS = (
    (("rms_norm",), ("rms_norm_kernel",)),
    (("add_rms_norm",), ("add_rms_norm_kernel",)),
    (("append_attention", "flash_attention_bshd", "flash_attention_local",
      "flash_attention_mla", "flash_attention_full"),
     ("append_attention_kernel", "append_attention_tc_kernel")),
    (("paged_attention",), ("paged_split_tc_kernel",
                            "paged_split_f32_kernel")),
    (("mla_decode",), ("mla_decode_tc_kernel", "mla_decode_split_kernel")),
    (("fused_qkv_rope",), ("qkv_tc_kernel", "fused_qkv_rope_kernel")),
    (("fused_epilogue",), ("epilogue_tc_kernel", "fused_epilogue_kernel")),
)


def traced_run(label, fn, tries=3, exact=True):
    """Run ``fn`` under ``torch.profiler`` (the device alone) and hold the
    launches the wrappers counted during it against the kernels the trace
    shows, by kernel name (``TRACED_KERNELS``): inside a replay the counts
    are the capture's, so this is what shows that the graph ran the
    kernels it counts. A counter with no known kernel fails. With
    ``exact`` the two must agree: the profiler can drop a session's
    records, so up to ``tries`` sessions are taken, and none that agrees
    fails. Without it (eager runs, whose counts are taken at the launch
    sites) one session is taken and a difference is logged: the profiler
    missed 2 ``rms_norm`` records in every eager DeepSeek-V2-Lite window
    of 5 or 10 steps. Returns (device busy ms: the kernels' summed
    durations, kernels launched) of the last session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.hopper import _build

    pats = [[re.compile(rf"(?<![A-Za-z_]){n}") for n in names]
            for _, names in TRACED_KERNELS]
    for attempt in range(tries if exact else 1):
        before = Counter(_build.launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counted = Counter(_build.launches)
        counted.subtract(before)
        counted = +counted
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        want, seen = {}, {}
        for (counters, names), pat in zip(TRACED_KERNELS, pats):
            want[names[0]] = sum(counted.pop(c, 0) for c in counters)
            seen[names[0]] = sum(e.count for e in kern
                                 if any(p.search(e.key) for p in pat))
        if counted:
            raise AssertionError(f"{label}: no kernel name known for the "
                                 f"counters {dict(counted)}")
        busy = (sum(e.device_time_total for e in kern) / 1e3,
                sum(e.count for e in kern))
        if want == seen:
            log(f"  phase 17 {label}: traced kernels = counted launches "
                f"{json.dumps({k: v for k, v in want.items() if v})}")
            return busy
        log(f"  phase 17 {label}: session {attempt + 1}: counted {want}, "
            f"traced {seen}")
    if not exact:
        return busy
    raise AssertionError(f"{label}: the trace's kernels never matched the "
                         f"counted launches in {tries} sessions")


def decode_walls(model, card, label, slots, max_len, prompt, fused=False,
                 n_steps=10, pairs=3, traced_steps=5):
    """Phase 17.4: wall ms of a decode step, graphs against eager bodies,
    in turns (graph, eager, eager, graph, ...; ``pairs`` pairs of
    ``n_steps`` steps each, host clock around synchronised steps) at
    ``slots`` active slots of ``prompt``-token prompts; then the device's
    busy ms a step of each from ``torch.profiler`` (the kernels' summed
    durations over ``traced_steps`` steps, ``traced_run``: the traced kernels
    must equal the counted launches) and the busy share (busy over
    wall); then the host µs of the weight check, of one graphed call of
    the decode unit and of its graph's launch alone. Returns {mode:
    (median wall ms, busy ms)}."""
    import torch

    from paddle_tpu_torch.generation import _get_select_decode
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.utils.flags import flag_overrides

    modes = {"graph": contextlib.nullcontext, "eager": eager_units}
    with flag_overrides({"use_fused_decode_tail": fused}):
        eng = ContinuousBatchEngine(model, max_batch=slots, max_len=max_len)
        rng = np.random.RandomState(5)
        for _ in range(slots):
            eng.add_request(rng.randint(0, model.config.vocab_size,
                                        size=prompt),
                            max_new_tokens=(2 * pairs + 6) * n_steps + 8)
        for mode in modes:
            with modes[mode]():
                eng.step()
        walls = {m: [] for m in modes}
        for p in range(pairs):
            for mode in ("graph", "eager") if p % 2 == 0 else ("eager",
                                                               "graph"):
                with modes[mode]():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n_steps):
                        eng.step()
                    torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3
                                   / n_steps)
        busy = {}
        for mode in modes:
            with modes[mode]():
                ms, n = traced_run(f"{label} tail {'on' if fused else 'off'}"
                                   f", {mode}", lambda: [
                                       eng.step()
                                       for _ in range(traced_steps)],
                                   exact=mode == "graph")
            busy[mode] = (ms / traced_steps, n / traced_steps)
        # the graph layer's host cost: the weight check of a memoized hit,
        # and a whole unit call (signature, input copies, replay enqueued,
        # outputs rebuilt), the host clock alone (the replays queue)
        unit = _get_select_decode(model, max_len, False, 1.0, 0, 1.0)
        check_us = host_us(unit.refresh_weights, 1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            unit(eng._last, eng._generator, eng._caches)
        call_us = (time.perf_counter() - t0) / n_steps * 1e6
        torch.cuda.synchronize()
        graph = next(iter(unit._graphs.values())).graph
        t0 = time.perf_counter()
        for _ in range(n_steps):
            graph.replay()
        replay_us = (time.perf_counter() - t0) / n_steps * 1e6
        torch.cuda.synchronize()
        del eng, graph
    log(f"  [{card}] phase 17 {label}: host us a call: weight check "
        f"{check_us:.1f}, graphed decode unit call {call_us:.1f}, of which "
        f"the graph's launch (CUDAGraph.replay) {replay_us:.1f}")
    out = {}
    for mode in modes:
        wall = statistics.median(walls[mode])
        out[mode] = (wall, busy[mode][0])
        log(f"  [{card}] phase 17 {label} decode at {slots} slots x "
            f"{prompt}, fused tail {'on' if fused else 'off'}, {mode}: wall "
            f"ms/step {' '.join(f'{w:.3f}' for w in walls[mode])} (median "
            f"{wall:.3f}); busy {busy[mode][0]:.3f} ms/step, "
            f"{busy[mode][1]:.0f} kernels/step, busy share "
            f"{busy[mode][0] / wall:.3f}")
    return out


def two_prompt_lengths(model, card, ids):
    """Phase 17.6: ``generate`` of run a's batch at a second prompt length
    with the same max_len (12 tokens shorter, 12 more new ones). The
    prefill writes the dense buffers kept for (batch, max_len) in place,
    so the decode unit captures no second graph, and the graph pool grows
    by less than one set of those buffers (the second prompt shape's
    prefill graph holds its intermediates, no cache). A repeat of the
    call runs replays alone and is traced (``traced_run``)."""
    from paddle_tpu_torch.jit.cuda_graph import pool_bytes

    B, S0 = ids.shape
    max_len = S0 + GEN_NEW
    model.generate(ids, max_new_tokens=GEN_NEW)     # run a's shape, kept
    decode = model.__dict__["_select_decode_steps"].values()
    captures = sum(u.captures for u in decode)
    pool = pool_bytes(model)
    short, n_new = ids[:, :S0 - 12], GEN_NEW + 12
    toks = model.generate(short, max_new_tokens=n_new).cpu().numpy()
    traced_run("generate a at a second prompt length (replays)",
               lambda: model.generate(short, max_new_tokens=n_new))
    layers, _ = model.__dict__["_cache_sets"][(B, max_len)]
    set_bytes = sum(t.numel() * t.element_size() for c in layers
                    for t in c.values())
    grown = pool_bytes(model) - pool
    again = sum(u.captures for u in decode)
    log(f"  [{card}] phase 17 generate a at prompts {S0} and {S0 - 12}, "
        f"max_len {max_len}: decode captures {captures} -> {again}; graph "
        f"pool grew {grown / 2**20:.1f} MiB (one set of dense caches "
        f"{set_bytes / 2**20:.1f} MiB); tokens {toks.shape}")
    if again != captures:
        raise AssertionError("phase 17: a second prompt length captured "
                             "another decode graph")
    if grown >= set_bytes:
        raise AssertionError("phase 17: the graph pool grew by a set of "
                             "dense caches at a second prompt length")


def generate_turns(model, card, label, run, graph_toks, pairs=2):
    """Phase 17.1 and 17.5 for one ``generate`` run of phase 16: its
    tokens and launch counts from the eager bodies against the graphs',
    then decode ms a forward in turns (eager, graph, graph, eager, ...).
    Returns {mode: [decode ms per forward]}."""
    ids, want, kw = run
    kw = dict({"max_new_tokens": GEN_NEW}, **kw)
    modes = {"graph": contextlib.nullcontext, "eager": eager_units}
    ms = {m: [] for m in modes}
    for p in range(pairs):
        for mode in ("eager", "graph") if p % 2 == 0 else ("graph",
                                                           "eager"):
            with modes[mode]():
                toks, counts, dec = generate_run(
                    model, card, f"{label} ({mode})", ids, want, **kw)
            ms[mode].append(dec)
            require_same(f"generate {label} ({mode})", toks, graph_toks)
    log(f"  [{card}] phase 17 generate {label}: decode ms a forward, graph "
        f"{' '.join(f'{x:.3f}' for x in ms['graph'])}, eager "
        f"{' '.join(f'{x:.3f}' for x in ms['eager'])}")
    return ms


def graphs_llama(model, card, prompts, news, off, on, spec_out, gen_runs,
                 gen_toks):
    """Phase 17 on phase 3's Llama-3-8B: the engine runs of phase 3 (tail
    off, on, speculative k = 4) and phase 16's ``generate`` runs a, b, d,
    e, f against the same runs through the eager bodies, tokens and
    launch counts identical; a seeded sampled engine (engine-wide
    settings, then per-row overrides) and a penalised ``generate`` graph
    against eager; decode ms a forward of runs a and f in turns; wall ms a
    decode step in turns with busy ms, tail off and on; every unit's
    captures, replays and capture seconds, and the pool."""
    import torch

    t0 = time.perf_counter()
    log("phase 17: graphs, Llama-3-8B (32 layers, bf16, phase 3's model)")
    with eager_units():
        for label, fused, graph in (("flag off", False, off),
                                    ("flag on", True, on)):
            counts, _, _, _, outputs = serve_run(
                model, card, f"{label}, eager", prompts, news, fused)
            require_same(f"engine {label}", graph[4], outputs, graph[0],
                         counts)
        sp, sn = spec_prompts(model.config.vocab_size)
        counts, _, _, _, outputs = serve_run(
            model, card, f"speculative k={SPEC_K}, flag on, eager", sp, sn,
            True, speculative_k=SPEC_K)
    require_same(f"engine speculative k={SPEC_K}", spec_out, outputs)
    for rows in (False, True):
        label = "per-row" if rows else "engine-wide"
        graph = sampled_engine(model, prompts[:8], 16, rows)
        with eager_units():
            eager = sampled_engine(model, prompts[:8], 16, rows)
        require_same(f"sampled engine ({label} settings, seed 17)", graph,
                     eager)
    for label in ("a dense", "b paged", "d chunked", "e beams",
                  "f fused tail"):
        if label[0] in "af":
            generate_turns(model, card, label, gen_runs[label],
                           gen_toks[label])
            continue
        ids, want, kw = gen_runs[label]
        with eager_units():
            toks, _, _ = generate_run(model, card, f"{label} (eager)", ids,
                                      want, **dict({"max_new_tokens": GEN_NEW},
                                                   **kw))
        require_same(f"generate {label}", toks, gen_toks[label])
    ids = gen_runs["a dense"][0]
    pen = dict(max_new_tokens=8, repetition_penalty=1.2, eos_token_id=0)
    graph = model.generate(ids, **pen).cpu().numpy()
    with eager_units():
        eager = model.generate(ids, **pen).cpu().numpy()
    require_same("generate with a repetition penalty and eos (the "
                 "penalised decode unit)", graph, eager)
    two_prompt_lengths(model, card, gen_runs["a dense"][0])
    for fused in (False, True):
        decode_walls(model, card, "Llama-3-8B", 8, 2048, 512, fused)
    log_units(model, card, "Llama-3-8B", (
        "_prefill_steps", "_select_decode_steps", "_select_decode_rows_steps",
        "_spec_decode_steps", "_decode_steps", "_beam_steps"))
    torch.cuda.synchronize()
    log(f"phase 17 on Llama-3-8B took {time.perf_counter() - t0:.1f}s")


def graphs_deepseek(model, card, prompts, news, outputs, gen_runs, gen_toks):
    """Phase 17 on phase 10's DeepSeek-V2-Lite: the latent engine's run of
    phase 10 and ``generate`` run g against the eager bodies (tokens and
    launch counts), run g's decode ms in turns, wall ms a decode step at
    8 slots of 1024-token prompts in turns with busy ms, and the units."""
    t0 = time.perf_counter()
    log("phase 17: graphs, DeepSeek-V2-Lite (27 layers, bf16, phase 10's "
        "model)")
    with eager_units():
        counts, _, _, _, eager = serve_run(
            model, card, "DeepSeek-V2-Lite, eager", prompts, news, False,
            max_batch=8, max_len=4096)
    require_same("DeepSeek latent engine", outputs, eager)
    label = "g DeepSeek-V2-Lite"
    ids, want, kw = gen_runs[label]
    ms = {m: [] for m in ("graph", "eager")}
    for p in range(2):
        for mode in ("eager", "graph") if p % 2 == 0 else ("graph",
                                                           "eager"):
            with (eager_units() if mode == "eager"
                  else contextlib.nullcontext()):
                toks, _, dec = generate_run(model, card, f"{label} ({mode})",
                                            ids, want, **kw)
            ms[mode].append(dec)
            require_same(f"generate {label} ({mode})", toks,
                         gen_toks[label])
    log(f"  [{card}] phase 17 generate {label}: decode ms a forward, graph "
        f"{' '.join(f'{x:.3f}' for x in ms['graph'])}, eager "
        f"{' '.join(f'{x:.3f}' for x in ms['eager'])}")
    decode_walls(model, card, "DeepSeek-V2-Lite", 8, 4096, 1024)
    log_units(model, card, "DeepSeek-V2-Lite", (
        "_prefill_steps", "_select_decode_steps"))
    log(f"phase 17 on DeepSeek-V2-Lite took {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------- phase 18 --

# the MoE layer at full width: d_model 4096, 64 experts of hidden 1536,
# 8192 tokens; the card-vs-CPU f32 check at the same widths over 512 tokens
# (the CPU's f32 products at 8192 tokens would take minutes); the list of
# expert modules at d_model 1024, hidden 2048, 4 experts, 2048 tokens
MOE_D, MOE_E, MOE_H, MOE_TOKENS, MOE_CPU_TOKENS = 4096, 64, 1536, 8192, 512
MOE_LIST = (1024, 2048, 4, 2048)
# (label, gate keywords): training mode; the card-vs-CPU runs take no draw
# (GShard's random routing off, the Switch jitter 0), the full-size runs
# draw from the gate's generator
MOE_GATES = (("naive", {"type": "naive"}),
             ("gshard", {"type": "gshard", "random_routing": False}),
             ("switch", {"type": "switch", "switch_eps": 0.0}))


def moe_card_vs_cpu(label, layer, cpu_layer, x_np):
    """One MoE layer's forward and backward on the card and on the CPU in
    f32 from the same weights and tokens: out within 1e-4 of its largest
    entry, every gradient (tokens, gate, experts) within 1e-4 of its
    tensor's largest, and the gate's and experts' gradients non-zero.
    Returns the worst relative error."""
    import torch

    worst = 0.0
    outs, grads = [], []
    for lyr, dev in ((layer, "cuda"), (cpu_layer, "cpu")):
        lyr.zero_grad(set_to_none=True)
        x = torch.from_numpy(x_np).to(dev).requires_grad_(True)
        out = lyr(x)
        (out.pow(2).sum() + lyr.gate.get_loss()).backward()
        outs.append(out.detach().cpu())
        grads.append({"x": x.grad.cpu()})
        grads[-1].update({n: None if p.grad is None else p.grad.cpu()
                          for n, p in lyr.named_parameters()})
    top = float(outs[1].abs().max())
    worst = float((outs[0] - outs[1]).abs().max()) / top
    for name, ref in grads[1].items():
        got = grads[0][name]
        if got is None or ref is None:
            raise AssertionError(f"phase 18 {label}: no gradient for {name}")
        scale = float(ref.abs().max())
        if scale == 0.0 and (name.startswith("gate.gate_weight")
                             or name.endswith(("w1", "w2", "weight"))):
            raise AssertionError(f"phase 18 {label}: {name}'s gradient is 0")
        worst = max(worst, float((got - ref).abs().max()) / max(scale,
                                                                1e-30))
    if not worst <= 1e-4:
        raise AssertionError(f"phase 18 {label}: card and CPU differ, worst "
                             f"relative error {worst:.3e}")
    return worst


def moe_full_size(label, layer, x):
    """Forward and backward of the layer at full size on the card (one
    warm-up, then one timed of each on the host clock around synchronised
    calls): finite outputs of x's shape, the gate's and experts' gradients
    non-zero. Returns (forward ms, backward ms)."""
    import torch

    times = []
    for _ in range(2):
        layer.zero_grad(set_to_none=True)
        xx = x.detach().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = layer(xx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (out.float().pow(2).mean() + layer.gate.get_loss()).backward()
        torch.cuda.synchronize()
        times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"phase 18 {label}: output {tuple(out.shape)} "
                             "not finite or of the wrong shape")
    for name, p in layer.named_parameters():
        if name.endswith(("gate_weight", "w1", "w2")) and not bool(
                p.grad.detach().any()):
            raise AssertionError(f"phase 18 {label}: {name}'s gradient is 0")
    return times[-1]


def list_expert(d, h, device, gen):
    """One expert of the list: d -> h (gelu) -> d, biased, N(0, 0.02)."""
    import torch

    from paddle_tpu_torch import nn as pnn

    class Expert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = pnn.Linear(d, h, device=device, bias=True)
            self.fc2 = pnn.Linear(h, d, device=device, bias=True)
            with torch.no_grad():
                for p in self.parameters():
                    p.normal_(0.0, 0.02, generator=gen)

        def forward(self, x):
            return self.fc2(torch.nn.functional.gelu(self.fc1(x)))

    return Expert()


def moe_layer_on_card():
    """Phase 18: ``MoELayer`` at d_model 4096, 64 experts of hidden 1536,
    for each gate (naive, GShard, Switch) and each grouped expert kind
    (swiglu, gelu): f32 card against CPU at 512 tokens, forward and
    backward; then 8192 tokens on the card in f32 and bf16, timed, the
    gates drawing from their generators; a list of 4 expert modules the
    same way at a smaller size; ``forward_ragged`` against
    ``forward_expert_batch`` on the card; ``global_scatter`` then
    ``global_gather`` the identity."""

    import torch

    from paddle_tpu_torch.distributed import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"phase 18: MoELayer, d_model {MOE_D}, {MOE_E} experts of hidden "
        f"{MOE_H}; card vs CPU in f32 at {MOE_CPU_TOKENS} tokens (tolerance "
        f"1e-4 of each tensor's largest), then {MOE_TOKENS} tokens on the "
        f"card in f32 and bf16 (training mode, random draws on)")
    rng = np.random.RandomState(18)
    x_cpu = rng.randn(MOE_CPU_TOKENS, MOE_D).astype(np.float32)
    gen = torch.Generator("cuda").manual_seed(18)
    x_full = torch.randn(MOE_TOKENS, MOE_D, generator=gen, device="cuda")
    for act in ("swiglu", "gelu"):
        experts = moe.GroupedMLP(MOE_E, MOE_D, MOE_H, activation=act,
                                 device="cuda", generator=gen)
        with torch.no_grad():   # non-zero biases, so their terms count
            experts.b1.normal_(0.0, 0.02, generator=gen)
            experts.b2.normal_(0.0, 0.02, generator=gen)
        cpu_experts = copy.deepcopy(experts).cpu()
        for label, kw in MOE_GATES:
            layer = moe.MoELayer(MOE_D, experts, gate=dict(kw)).train()
            cpu_layer = moe.MoELayer(MOE_D, cpu_experts,
                                     gate=dict(kw)).train()
            cpu_layer.gate.load_state_dict(
                {k: v.cpu() for k, v in layer.gate.state_dict().items()})
            err = moe_card_vs_cpu(f"{label} {act}", layer, cpu_layer, x_cpu)
            full = dict(kw, generator=torch.Generator("cuda").manual_seed(5))
            full.pop("random_routing", None)
            full.pop("switch_eps", None)
            fl = moe.MoELayer(MOE_D, experts, gate=full).train()
            fl.gate.load_state_dict(layer.gate.state_dict())
            f_ms = moe_full_size(f"{label} {act} f32", fl, x_full)
            bf_experts = copy.deepcopy(experts).to(torch.bfloat16)
            bl = moe.MoELayer(MOE_D, bf_experts, gate=dict(full)).train()
            bl.gate.load_state_dict(layer.gate.state_dict())
            b_ms = moe_full_size(f"{label} {act} bf16", bl,
                                 x_full.to(torch.bfloat16))
            cap = bl.gate._capacity(MOE_TOKENS, True)
            log(f"  [{card}] phase 18 {label} gate, GroupedMLP {act}: card "
                f"= CPU (f32, {MOE_CPU_TOKENS} tokens; out and every "
                f"gradient, worst {err:.2e} of the tensor's largest); "
                f"{MOE_TOKENS} tokens, C {cap}: f32 forward {f_ms[0]:.2f} "
                f"ms, backward {f_ms[1]:.2f} ms; bf16 forward {b_ms[0]:.2f} "
                f"ms, backward {b_ms[1]:.2f} ms")
            del layer, cpu_layer, fl, bl, bf_experts
            torch.cuda.empty_cache()
        if act == "swiglu":
            check_ragged(card, experts, gen)
        del experts, cpu_experts
        gc.collect()
        torch.cuda.empty_cache()

    d, h, n_exp, tokens = MOE_LIST
    lgen = torch.Generator("cuda").manual_seed(19)
    experts = [list_expert(d, h, "cuda", lgen) for _ in range(n_exp)]
    cpu_experts = [copy.deepcopy(e).cpu() for e in experts]
    x_list = rng.randn(tokens, d).astype(np.float32)
    parts = []
    for label, kw in MOE_GATES:
        layer = moe.MoELayer(d, experts, gate=dict(kw)).train()
        cpu_layer = moe.MoELayer(d, cpu_experts, gate=dict(kw)).train()
        cpu_layer.gate.load_state_dict(
            {k: v.cpu() for k, v in layer.gate.state_dict().items()})
        err = moe_card_vs_cpu(f"{label} list", layer, cpu_layer, x_list)
        bl = copy.deepcopy(layer).to(torch.bfloat16)
        bl.gate.float()
        b_ms = moe_full_size(f"{label} list bf16", bl, torch.from_numpy(
            x_list).cuda().to(torch.bfloat16))
        parts.append(f"{label} worst {err:.2e}, bf16 forward {b_ms[0]:.2f} "
                     f"ms, backward {b_ms[1]:.2f} ms")
    log(f"  [{card}] phase 18 a list of {n_exp} expert modules (d_model {d}"
        f", hidden {h}, gelu, {tokens} tokens): card = CPU in f32 for each "
        f"gate; {'; '.join(parts)}")
    del experts, cpu_experts, layer, cpu_layer, bl
    check_global_exchange(card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18 took {time.perf_counter() - t_start:.1f}s")


def check_ragged(card, experts, gen):
    """``forward_ragged`` on tokens sorted by expert (group sizes of a
    seeded multinomial over 8192 tokens, one expert empty) against
    ``forward_expert_batch`` on the same rows laid out [E, C, M], f32
    within 1e-4 of the largest entry, bf16 within 2^-6 of it; both timed
    (host clock around synchronised calls, median of 3)."""

    import torch

    sizes = np.random.RandomState(20).multinomial(
        MOE_TOKENS, np.full(MOE_E, 1.0 / MOE_E))
    sizes[3] += sizes[7]
    sizes[7] = 0
    x = torch.randn(MOE_TOKENS, MOE_D, generator=gen, device="cuda")
    cap = int(sizes.max())
    slot = np.concatenate([np.arange(n) for n in sizes])
    expert = np.repeat(np.arange(MOE_E), sizes)
    e_idx = torch.from_numpy(expert).cuda()
    s_idx = torch.from_numpy(slot).cuda()
    res = []
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)):
        g = experts if dtype == torch.float32 else copy.deepcopy(
            experts).to(dtype)
        xx = x.to(dtype)
        sz = torch.from_numpy(sizes).cuda()

        def ragged():
            return g.forward_ragged(xx, sz)

        def batch():
            xe = xx.new_zeros(MOE_E, cap, MOE_D)
            xe[e_idx, s_idx] = xx
            return g.forward_expert_batch(xe)[e_idx, s_idx]

        with torch.no_grad():
            a, b = ragged(), batch()
            top = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max()) / top
            ms = []
            for fn in (ragged, batch):
                t = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    t.append((time.perf_counter() - t0) * 1e3)
                ms.append(statistics.median(t))
        if not err <= tol:
            raise AssertionError(f"phase 18 forward_ragged {dtype}: differs "
                                 f"from forward_expert_batch ({err:.3e} of "
                                 f"the largest entry)")
        res.append(f"{str(dtype)[6:]} {err:.2e} of the largest entry, ragged "
                   f"{ms[0]:.2f} ms, expert batch (C {cap}) {ms[1]:.2f} ms")
    log(f"  [{card}] phase 18 forward_ragged = forward_expert_batch on the "
        f"card ({MOE_TOKENS} tokens sorted by expert, one group empty): "
        f"{'; '.join(res)}")


def check_global_exchange(card):
    """``global_scatter`` then ``global_gather`` on the card (4 ranks of 16
    experts, seeded uneven counts, width 4096): each rank's buffer comes
    back bit for bit, and the scattered one is laid out expert-major then
    source rank."""
    import torch

    from paddle_tpu_torch.distributed import moe

    world, n_expert, M = 4, 16, MOE_D
    rng = np.random.RandomState(21)
    lc = rng.randint(0, 9, size=(world, world * n_expert)).astype(np.int64)
    gcnt = np.zeros_like(lc)
    for dst in range(world):
        for src in range(world):
            for e in range(n_expert):
                gcnt[dst, src * n_expert + e] = lc[src, dst * n_expert + e]
    x = torch.zeros(world, int(lc.sum(1).max()), M, device="cuda")
    for r in range(world):
        n = int(lc[r].sum())
        x[r, :n] = torch.randn(n, M, device="cuda")
    lct, gct = torch.from_numpy(lc).cuda(), torch.from_numpy(gcnt).cuda()
    xs = moe.global_scatter(x, lct, gct)
    first = xs[0, :int(lc[0, 0])]
    back = moe.global_gather(xs, lct, gct)
    ok = torch.equal(back, x) and torch.equal(first, x[0, :int(lc[0, 0])])
    log(f"  [{card}] phase 18 global_gather(global_scatter(x)) = x on the "
        f"card ({world} ranks, {n_expert} experts, width {M}, "
        f"{int(lc.sum())} rows, receive buffers {tuple(xs.shape)}): {ok}")
    if not ok:
        raise AssertionError("phase 18: global_gather(global_scatter(x)) "
                             "is not x")


# --------------------------------------------------------- phases 19-21 --

# phase 3's ten requests (prompt lengths, new tokens)
SERVE_LENS = (100, 128, 256, 300, 512, 700, 1000, 1024, 64, 33)
SERVE_NEWS = tuple(16 if i % 2 == 0 else 64 for i in range(len(SERVE_LENS)))
# phase 20's three requests a family, 16 new tokens each
FAMILY_LENS, FAMILY_NEW = (512, 300, 1024), 16


def family_config(name, **kw):
    """The published shape of each family (bf16), ``kw`` on top: the depth
    cuts of phases 20 and 21 come in through it."""
    from paddle_tpu_torch import models

    kw = dict(dict(dtype="bfloat16"), **kw)
    if name == "ERNIE-4.5-21B-A3B":
        return models.Ernie45Config.a3b(**kw)
    cls = {"Qwen3-30B-A3B": models.Qwen3MoeConfig,
           "Qwen1.5-MoE-A2.7B": models.Qwen2MoeConfig,
           "Mixtral-8x7B": models.MixtralConfig}[name]
    return cls(**kw)


def family_model(name, seed, **kw):
    """The family's model on the card, weights drawn from ``seed``, then
    the terms a fresh model leaves at 0 drawn too: the q/k/v biases
    N(0, 0.02) and ERNIE's selection bias N(0, 0.005) (the router's
    probabilities are about 1/64), so that every path of the family
    runs with a real value."""
    import torch

    from paddle_tpu_torch.weights import model_class

    cfg = family_config(name, **kw)
    gen = torch.Generator("cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = model_class(cfg)(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("_proj.bias"):
                p.normal_(0.0, 0.02, generator=gen)
            elif pname.endswith("e_score_correction_bias"):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 0.005)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def serving_counts_want(cfg, steps, prefills_exact, prefills_padded):
    """Exact launches of an engine run: per forward (prefill or decode
    step) one ``rms_norm`` a layer's input norm, two more a layer for
    per-head or full q/k norms, one for the final norm, one
    ``add_rms_norm`` a layer; per decode step ``paged_attention`` a layer;
    per exact prefill the flash kernel a layer, per padded one append
    attention a layer; no fused tail."""
    L = cfg.num_hidden_layers
    forwards = steps + prefills_exact + prefills_padded
    norms = L * (1 + (2 if cfg.qk_norm else 0)) + 1
    return {"rms_norm": norms * forwards, "add_rms_norm": L * forwards,
            "paged_attention": L * steps,
            "flash_attention_bshd": L * prefills_exact,
            "append_attention": L * prefills_padded,
            "fused_qkv_rope": 0, "fused_epilogue": 0, "mla_decode": 0,
            "flash_attention_mla": 0}


def require_counts(label, counts, want):
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{counts.get(name, 0)} times, expected {n}")


def exact_bucket(n, page=16):
    b = page
    while b < n:
        b *= 2
    return b == n


class _GroupSpy:
    """Records the (query heads, KV heads) group of every call of the paged
    wrapper the model makes (in a graph, the calls of its capture)."""

    def __enter__(self):
        from paddle_tpu_torch import generation as pa

        self.groups, self._mod = Counter(), pa
        self._real = pa.paged_attention

        def spy(q, k_pages, *a, **k):
            self.groups[q.shape[1] // k_pages.shape[0]] += 1
            return self._real(q, k_pages, *a, **k)

        pa.paged_attention = spy
        return self

    def __exit__(self, *exc):
        self._mod.paged_attention = self._real


def engine_vs_solo(model, card, label, prompts, n_new, engine_out):
    """The engine's tokens against ``generate`` on each prompt alone. The
    first token of a prompt that fills its bucket comes from the same
    prefill on both sides and must be equal; the rest is reported: at full
    width the dense dispatch's capacity, ceil(S k f / E) slots an expert,
    depends on how many rows decode together (S = the engine's slots,
    1 alone), so a route dropped in the batch is kept alone, as in the JAX
    package, and bf16 products at other shapes round differently."""
    import torch

    same, total, first = 0, 0, []
    for p, toks in zip(prompts, engine_out):
        solo = model.generate(torch.from_numpy(np.asarray(p)[None]).to(
            model.device), max_new_tokens=n_new).cpu().numpy()[0]
        same += int((solo == toks).sum())
        total += n_new
        run = int(np.argmin(np.append(solo == toks, False)))
        first.append(run)
        if exact_bucket(len(p)) and solo[0] != toks[0]:
            raise AssertionError(f"{label}: the engine's first token "
                                 f"{toks[0]} != solo generate's {solo[0]} "
                                 f"for an exact {len(p)}-token prompt")
    log(f"  [{card}] {label}: engine against solo generate (bf16): first "
        f"tokens equal on every exact-bucket prompt; {same}/{total} tokens "
        f"equal, leading run equal {first}")


def serve_family(model, card, label, lens, news, seed, max_batch=8):
    """An engine run of the family (paged, ``max_batch`` slots, max_len
    2048) with its exact launch counts and the paged kernel's group.
    Returns (counts, outputs, prompts, stats)."""
    cfg = model.config
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in lens]
    with _GroupSpy() as spy:
        counts, stats, _, _, outputs = serve_run(
            model, card, label, prompts, news, False, max_batch=max_batch)
    n_exact = sum(exact_bucket(n) for n in lens)
    want = serving_counts_want(cfg, stats["decode_steps"], n_exact,
                               len(lens) - n_exact)
    require_counts(label, counts, want)
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    if set(spy.groups) != {group}:
        raise AssertionError(f"{label}: paged_attention ran at groups "
                             f"{dict(spy.groups)}, expected {group}")
    L = cfg.num_hidden_layers
    log(f"  [{card}] {label}: launch counts exact for "
        f"{stats['decode_steps']} decode steps, {n_exact} exact and "
        f"{len(lens) - n_exact} padded prefills; a decode step: "
        f"paged_attention {L} at group {group}, rms_norm "
        f"{want['rms_norm'] // (stats['decode_steps'] + len(lens))}, "
        f"add_rms_norm {L}")
    return counts, outputs, prompts, stats


def generate_family(model, card, phase, label, n_new, seed):
    """``generate`` dense and paged on B 4 x 512 prompts, launch counts
    exact. Returns (counts, ids, dense tokens)."""
    import torch

    cfg = model.config
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT))).to(model.device)
    n = n_new - 1
    norms = L * (1 + (2 if cfg.qk_norm else 0)) + 1
    total = Counter()
    toks = {}
    for run, kw, want in (
            ("dense", {}, {"flash_attention_bshd": L,
                           "append_attention": L * n, "paged_attention": 0}),
            ("paged", {"paged": True, "page_size": 16},
             {"flash_attention_bshd": L, "paged_attention": L * n,
              "append_attention": 0})):
        want = dict(want, rms_norm=norms * n_new, add_rms_norm=L * n_new)
        toks[run], counts, _ = generate_run(
            model, card, f"{label} {run}", ids, want, phase=phase,
            max_new_tokens=n_new, **kw)
        total.update(counts)
    same = int((toks["dense"] == toks["paged"]).sum())
    log(f"  [{card}] {phase} {label}: generate dense and paged, {same}/"
        f"{toks['dense'].size} tokens equal (bf16, reported)")
    return total, ids, toks["dense"]


def serve_ernie(profile=False):
    """Phase 19: ERNIE-4.5-21B-A3B at its published shape, no cut (28
    layers, 64 experts top-6 + 2 shared, 20 | 4 heads: the paged kernel at
    group 5), bf16, random seeded weights: phase 3's ten requests through
    the paged engine (8 slots, max_len 2048), the same run on the eager
    bodies (graph = eager tokens and counts), ``generate`` dense and paged
    (B 4 x 512, 32 new), the engine against solo ``generate``; peak memory;
    with ``profile`` the decode trace of 8 slots of 512-token prompts.
    Returns the launch counts."""
    import torch

    label = "ERNIE-4.5-21B-A3B"
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, secs = family_model(label, 19)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    card = card_line()
    log(f"phase 19: {label}, {cfg.num_hidden_layers} layers (no cut), bf16, "
        f"{n_params / 1e9:.2f}B parameters drawn in {secs:.1f}s; "
        f"{cfg.n_routed_experts} experts top-{cfg.num_experts_per_tok} + "
        f"{cfg.n_shared_experts} shared, {cfg.num_attention_heads} | "
        f"{cfg.num_key_value_heads} heads, capacity factor "
        f"{cfg.moe_capacity_factor}; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    counts, outputs, prompts, _ = serve_family(
        model, card, f"phase 19 {label}", SERVE_LENS, SERVE_NEWS, 3)
    total = Counter(counts)
    with eager_units():
        e_counts, _, _, _, eager = serve_run(
            model, card, f"phase 19 {label}, eager", prompts, SERVE_NEWS,
            False)
    require_same(f"{label} engine", outputs, eager, counts, e_counts)
    g_counts, ids, dense = generate_family(model, card, "phase 19", label,
                                           GEN_NEW, 17)
    total.update(g_counts)
    eng = engine_tokens(model, list(ids.cpu().numpy()), GEN_NEW)
    engine_vs_solo(model, card, f"phase 19 {label}", list(ids.cpu().numpy()),
                   GEN_NEW, eng)
    log_units(model, card, label, ("_prefill_steps", "_select_decode_steps"))
    log(f"  [{card}] phase 19 {label}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_decode(model, card)
    log(f"phase 19 took {time.perf_counter() - t0:.1f}s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return total


# (family, depth cut or None): the three other families at full width
OTHER_FAMILIES = (("Qwen3-30B-A3B", 16), ("Qwen1.5-MoE-A2.7B", None),
                  ("Mixtral-8x7B", 4))


def serve_families():
    """Phase 20: Qwen3-30B-A3B (depth 48 -> 16), Qwen1.5-MoE-A2.7B (whole)
    and Mixtral-8x7B (depth 32 -> 4) at full width, bf16, random seeded
    weights: three requests through the paged engine and ``generate`` dense
    and paged (B 4 x 512, 16 new), launch counts exact, the engine against
    solo ``generate``. Returns the launch counts."""
    import torch

    total = Counter()
    t0 = time.perf_counter()
    for i, (label, depth) in enumerate(OTHER_FAMILIES):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kw = {} if depth is None else {"num_hidden_layers": depth}
        model, secs = family_model(label, 30 + i, **kw)
        cfg = model.config
        card = card_line()
        n_params = sum(p.numel() for p in model.parameters())
        cut = "whole" if depth is None else f"depth cut to {depth}"
        log(f"phase 20: {label}, {cfg.num_hidden_layers} layers ({cut}), "
            f"bf16, {n_params / 1e9:.2f}B parameters drawn in {secs:.1f}s; "
            f"{cfg.n_routed_experts} experts top-{cfg.num_experts_per_tok}"
            f" + {cfg.n_shared_experts} shared, {cfg.num_attention_heads} | "
            f"{cfg.num_key_value_heads} heads, qk_norm {cfg.qk_norm}, "
            f"attention_bias {cfg.attention_bias}")
        counts, outputs, prompts, _ = serve_family(
            model, card, f"phase 20 {label}", FAMILY_LENS,
            (FAMILY_NEW,) * len(FAMILY_LENS), 40 + i)
        total.update(counts)
        g_counts, _, _ = generate_family(model, card, "phase 20", label,
                                         FAMILY_NEW, 50 + i)
        total.update(g_counts)
        engine_vs_solo(model, card, f"phase 20 {label}", prompts, FAMILY_NEW,
                       outputs)
        log(f"  [{card}] phase 20 {label}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 20 took {time.perf_counter() - t0:.1f}s")
    return total


def families_wiring_check():
    """Phase 21: two layers of each family at full width in f32 (ERNIE one
    dense and one MoE), the same weights on the card and the CPU, a
    64-token prompt, 6 greedy tokens through the one-slot engine: the
    tokens identical card vs CPU, the prefill logits within 1e-3 (f32 on
    both sides, sums in another order), the first decode step's too; on
    the card the engine's tokens equal solo ``generate``'s (one slot: the
    dispatch's capacity is the same as alone)."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    tol = 1e-3
    for i, name in enumerate(("ERNIE-4.5-21B-A3B",) + tuple(
            n for n, _ in OTHER_FAMILIES)):
        m_gpu, _ = family_model(name, 60 + i, num_hidden_layers=2,
                                dtype="float32")
        m_cpu = cpu_copy(m_gpu)
        prompt = np.random.RandomState(60 + i).randint(
            0, m_gpu.config.vocab_size, size=64)

        def run(model):
            eng = ContinuousBatchEngine(model, max_batch=1, max_len=128)
            rid = eng.add_request(prompt, max_new_tokens=6)
            first = eng._last[0].cpu().clone()
            eng.step()
            step1 = eng._last[0].cpu().clone()
            return eng.run_until_done()[rid], first, step1

        reset_launches()
        card, card_first, card_step1 = run(m_gpu)
        counts = dict(launches)
        cpu, cpu_first, cpu_step1 = run(m_cpu)
        solo = m_gpu.generate(torch.from_numpy(prompt[None]).cuda(),
                              max_new_tokens=6).cpu().numpy()[0]
        err = float((card_first - cpu_first).abs().max())
        err1 = float((card_step1 - cpu_step1).abs().max())
        log(f"phase 21: {name} wiring, 2 layers at full width, f32, prompt "
            f"64: card tokens {card.tolist()} cpu tokens {cpu.tolist()} solo "
            f"generate {solo.tolist()}; prefill logits card vs cpu max abs "
            f"err {err:.3e}, first decode step's {err1:.3e} (tolerance {tol},"
            f" |logits| <= {float(cpu_first.abs().max()):.3f}); card "
            f"launches {json.dumps(counts)}")
        if not np.array_equal(card, cpu):
            raise AssertionError(f"phase 21 {name}: card and CPU greedy "
                                 "tokens differ")
        if not np.array_equal(card, solo):
            raise AssertionError(f"phase 21 {name}: engine tokens differ "
                                 "from solo generate")
        if not (err <= tol and err1 <= tol):
            raise AssertionError(f"phase 21 {name}: logits differ beyond the "
                                 "tolerance")
        require_launched(counts, ("rms_norm", "add_rms_norm",
                                  "flash_attention_bshd", "paged_attention"),
                         f"phase 21 {name}")
        del m_gpu, m_cpu
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 21 took {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------- phase 22 --

# the prefix-cache traffic: a 1024-token prefix, suffixes of 200 (the first
# request) and 150, 300, 600 (arriving while it decodes)
ENGINE_PREFIX, ENGINE_SUFFIXES = 1024, (200, 150, 300, 600)
# chunked prefill: seven live 512-token requests, then a 1792-token prompt
# in chunks of 256
ENGINE_CHUNK, ENGINE_LIVE, ENGINE_LONG = 256, 512, 1792
# device bytes left free beside the ballast of the real OOM: less than the
# 256 MiB of dense buffers a 2048-token prefill allocates
OOM_MARGIN = 64 * 2**20


def synced_ms(fn):
    """(result of ``fn()``, its ms between two card synchronisations)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _timed(real, name, times):
    """``real`` wrapped to time each call (synchronised) into
    ``times[name]``."""
    def call(*a, **kw):
        out, ms = synced_ms(lambda: real(*a, **kw))
        times.setdefault(name, []).append(ms)
        return out

    return call


def timed_method(eng, name, times):
    """Time each call of ``eng.<name>`` into ``times[name]``."""
    setattr(eng, name, _timed(getattr(eng, name), name, times))


@contextlib.contextmanager
def timed_functions(mod, names, times):
    """Time each call of the module functions ``mod.<name>`` into
    ``times[name]`` while the block runs (the engine calls them by their
    module-level names, so the calls inside its methods are timed)."""
    real = {n: getattr(mod, n) for n in names}
    for n, f in real.items():
        setattr(mod, n, _timed(f, n, times))
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(mod, n, f)


def crc_ms(times):
    """(total ms, calls) of the seals and checks timed in ``times``."""
    ms = [t for n in ("seal_bundle", "verify_bundle")
          for t in times.get(n, [])]
    return sum(ms), len(ms)


def run_engine(eng, prompts, news, **kw):
    """Every prompt queued (``add_request`` keywords ``kw``), then the
    engine run out; returns the outputs by rid and the rids."""
    rids = [eng.add_request(p, max_new_tokens=n, **kw)
            for p, n in zip(prompts, news)]
    return eng.run_until_done(), rids


def same_share(a, b):
    """'k/n' tokens equal between two runs' outputs."""
    same = sum(int(np.sum(np.asarray(x) == np.asarray(y)))
               for x, y in zip(a, b) if len(x) == len(y))
    return f"{same}/{sum(len(x) for x in a)}"


def bundle_mib(bundle) -> float:
    return sum(k.nbytes + v.nbytes for k, v in bundle["layers"]) / 2**20


def engine_prefix(model, card):
    """Phase 22 prefix cache: ``max_batch`` 8, ``max_len`` 2048. A request
    of the 1024-token prefix + 200 decodes while three more with the same
    prefix and suffixes of 150, 300 and 600 arrive: each copies 64 pages
    and prefills its suffix through append attention at pos 1024. Each
    engine runs the traffic twice (the first run captures its graphs);
    the second is timed and counted. Returns the counts."""
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    cfg = model.config
    rng = np.random.RandomState(22)
    prefix = rng.randint(0, cfg.vocab_size, ENGINE_PREFIX)
    prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, n)])
               for n in ENGINE_SUFFIXES]
    news = [48, 16, 16, 16]
    res = {}
    for cache in (False, True):
        eng = ContinuousBatchEngine(model, max_batch=8, max_len=2048,
                                    enable_prefix_cache=cache)
        for rep in range(2):
            reused0 = eng.prefix_pages_reused
            steps0 = eng.stats()["decode_steps"]
            reset_launches()
            out, ms, rids = {}, [], []
            for i, (p, n) in enumerate(zip(prompts, news)):
                rid, t = synced_ms(lambda: eng.add_request(
                    p, max_new_tokens=n))
                rids.append(rid)
                ms.append(t)
                if i == 0:
                    for _ in range(2):    # it decodes while the rest arrive
                        out.update(eng.step())
            out.update(eng.run_until_done())
            counts = Counter(launches)
        steps = eng.stats()["decode_steps"] - steps0
        reused = eng.prefix_pages_reused - reused0
        want = serving_counts_want(cfg, steps, 0, len(prompts))
        require_counts(f"phase 22 prefix cache {'on' if cache else 'off'}",
                       counts, want)
        if reused != (3 * ENGINE_PREFIX // 16 if cache else 0):
            raise AssertionError(f"phase 22 prefix cache: {reused} pages "
                                 "reused")
        res[cache] = (ms, [out[r] for r in rids], counts, reused)
        if [len(out[r]) for r in rids] != news:
            raise AssertionError("phase 22 prefix cache: a request fell "
                                 "short")
    (off_ms, off_out, _, _), (on_ms, on_out, counts, reused) = (res[False],
                                                                res[True])
    lines = ", ".join(
        f"suffix {s}: {a:.2f} (off {b:.2f})"
        for s, a, b in zip(ENGINE_SUFFIXES[1:], on_ms[1:], off_ms[1:]))
    log(f"  [{card}] phase 22 prefix cache: admission ms with the cache "
        f"(the first request's 1224-token prefill {on_ms[0]:.2f}, off "
        f"{off_ms[0]:.2f}); {lines}; prefix_pages_reused {reused} (64 a "
        f"hit); append_attention {counts['append_attention']} (L x 4: one "
        f"padded prefill, three suffixes), paged_attention "
        f"{counts['paged_attention']}; tokens cache on = off (bf16, "
        f"reported) {same_share(on_out, off_out)}")
    return counts


def engine_chunked(model, card):
    """Phase 22 chunked prefill: seven live 512-token requests decode (with
    chunks of 256 they land in two chunks each), then a 1792-token prompt
    lands in chunks of 256 (the first an exact prefill, six suffix chunks),
    one a step with a decode between; against the same traffic admitted
    whole. Each engine runs the traffic twice; the second
    is timed and counted. Returns the chunked run's counts."""
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    cfg = model.config
    rng = np.random.RandomState(23)
    live = [rng.randint(0, cfg.vocab_size, ENGINE_LIVE) for _ in range(7)]
    long_p = rng.randint(0, cfg.vocab_size, ENGINE_LONG)
    res = {}
    for chunk in (None, ENGINE_CHUNK):
        eng = ContinuousBatchEngine(model, max_batch=8, max_len=2048,
                                    prefill_chunk_tokens=chunk)
        for rep in range(2):
            steps0 = eng.stats()["decode_steps"]
            reset_launches()
            out = {}
            rids = [eng.add_request(p, max_new_tokens=48) for p in live]
            while eng._chunking:      # chunked, the live prompts land too
                out.update(eng.step())
            steady = []
            for _ in range(3):
                o, t = synced_ms(eng.step)
                out.update(o)
                steady.append(t)
            rid, t_add = synced_ms(lambda: eng.add_request(
                long_p, max_new_tokens=16))
            walls = []
            while True:
                o, t = synced_ms(eng.step)
                out.update(o)
                walls.append(t)
                if not eng._chunking:
                    break
            out.update(eng.run_until_done())
            counts = Counter(launches)
        steps = eng.stats()["decode_steps"] - steps0
        n_chunks = -(-ENGINE_LONG // ENGINE_CHUNK)
        # chunked: each live prompt an exact first chunk and one suffix,
        # the long one an exact first chunk and n - 1 suffixes
        want = (serving_counts_want(cfg, steps, 7 + 1, 7 + n_chunks - 1)
                if chunk else serving_counts_want(cfg, steps, 7, 1))
        require_counts(f"phase 22 chunked prefill (chunk {chunk})", counts,
                       want)
        if chunk and len(walls) != n_chunks:
            raise AssertionError(f"phase 22 chunked prefill: {len(walls)} "
                                 f"steps landed {n_chunks} chunks")
        res[chunk] = (t_add, walls, statistics.median(steady), out[rid],
                      counts)
    t_add, walls, steady, mono_tok, _ = res[None]
    c_add, c_walls, c_steady, chunk_tok, counts = res[ENGINE_CHUNK]
    log(f"  [{card}] phase 22 chunked prefill: 7 live x {ENGINE_LIVE} + "
        f"{ENGINE_LONG} in chunks of {ENGINE_CHUNK}: worst step while the "
        f"chunks land {max(c_walls):.2f} ms (steps "
        f"{', '.join(f'{w:.2f}' for w in c_walls)}; add_request "
        f"{c_add:.2f}; a plain decode step {c_steady:.2f}) against "
        f"{t_add + walls[0]:.2f} ms for the step that admits it whole "
        f"(admission {t_add:.2f} + step {walls[0]:.2f}; a plain decode step "
        f"{steady:.2f}); flash_attention_bshd "
        f"{counts['flash_attention_bshd']}, append_attention "
        f"{counts['append_attention']}; the long prompt's tokens chunked = "
        f"whole (bf16, reported) {same_share([chunk_tok], [mono_tok])}")
    return counts


def engine_preempt(model, card):
    """Phase 22 priorities and preemption: ``max_batch`` 4 filled with
    priority-2 requests of 1000 tokens; after 30 steps (2048-position
    bundles) a priority-0 request of 512 evicts the most recently admitted
    one to the host; it restores when a slot frees. Against the same
    traffic without preemption. Returns the preempting run's counts."""
    import paddle_tpu_torch.serving as serving
    from paddle_tpu_torch.ops.hopper import launches, reset_launches

    cfg = model.config
    rng = np.random.RandomState(24)
    low = [rng.randint(0, cfg.vocab_size, 1000) for _ in range(4)]
    hi = rng.randint(0, cfg.vocab_size, 512)
    res = {}
    for preempt in (False, True):
        eng = serving.ContinuousBatchEngine(
            model, max_batch=4, max_len=2048, enable_preemption=preempt)
        times, seal, check = {}, {}, {}
        timed_method(eng, "_preempt_slot", times)
        timed_method(eng, "_restore_into", times)
        reset_launches()
        out = {}
        rids = [eng.add_request(p, max_new_tokens=48, priority=2)
                for p in low]
        for _ in range(30):
            out.update(eng.step())
        # the seal runs inside the preemption, the check inside the
        # restore: each is timed where the engine calls it
        with timed_functions(serving, ["seal_bundle"], seal):
            r_hi = eng.add_request(hi, max_new_tokens=16, priority=0)
        mib = None
        if preempt:
            victim = next(r for r in eng._queue if r.resume is not None)
            mib = bundle_mib(victim.resume)
        with timed_functions(serving, ["verify_bundle"], check):
            out.update(eng.run_until_done())
        counts = Counter(launches)
        want = serving_counts_want(cfg, eng.stats()["decode_steps"], 1, 4)
        require_counts(f"phase 22 preemption ({preempt})", counts, want)
        if eng.stats()["requests_preempted"] != int(preempt):
            raise AssertionError("phase 22: the preemption did not happen")
        res[preempt] = ([out[r] for r in rids + [r_hi]], times, seal, check,
                        mib, counts)
    ref = res[False][0]
    got, times, seal, check, mib, counts = res[True]
    pre, rest = times["_preempt_slot"][0], times["_restore_into"][0]
    if len(seal.get("seal_bundle", [])) != 1 or len(
            check.get("verify_bundle", [])) != 1:
        raise AssertionError(f"phase 22: one seal and one check expected, "
                             f"got {seal} and {check}")
    seal_ms, check_ms = seal["seal_bundle"][0], check["verify_bundle"][0]
    log(f"  [{card}] phase 22 preemption: bundle {mib:.1f} MiB (2048 "
        f"positions x 128 KiB), preempt {pre:.2f} ms (the seal's CRC "
        f"{seal_ms:.2f}, timed inside it; the rest, the copies to the host "
        f"and the bookkeeping, {pre - seal_ms:.2f}), restore {rest:.2f} ms "
        f"(the check's CRC {check_ms:.2f}, timed inside it; the rest, the "
        f"copies back and the page write, {rest - check_ms:.2f}); tokens "
        f"preempted and restored = never "
        f"preempted (bf16, reported) {same_share(got, ref)}, the victim's "
        f"{same_share(got[3:4], ref[3:4])}")
    return counts


def engine_migrate(model, card):
    """Phase 22 migration and handoff on one model and two engines:
    ``export_slot`` mid-decode (30 steps into a 1000-token prompt), then
    ``admit_migrated`` on the second engine; ``export_prefill`` of a
    900-token prompt, then ``admit_prefilled``. Against the same requests
    served where they started. Returns the counts."""
    import paddle_tpu_torch.serving as serving
    from paddle_tpu_torch.jit.cuda_graph import pool_bytes
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    cfg = model.config
    rng = np.random.RandomState(25)
    p_mig = rng.randint(0, cfg.vocab_size, 1000)
    p_hand = rng.randint(0, cfg.vocab_size, 900)
    pool0 = pool_bytes(model)
    src = ContinuousBatchEngine(model, max_batch=4, max_len=2048)
    dst = ContinuousBatchEngine(model, max_batch=4, max_len=2048)
    reset_launches()
    rid = src.add_request(p_mig, max_new_tokens=48)
    for _ in range(30):
        src.step()
    crc = ("seal_bundle", "verify_bundle")
    t_exp, t_adm = {}, {}
    with timed_functions(serving, crc, t_exp):
        mig, export_ms = synced_ms(lambda: src.export_slot(rid))
    with timed_functions(serving, crc, t_adm):
        rid2, admit_ms = synced_ms(lambda: dst.admit_migrated(mig))
    migrated = dst.run_until_done()[rid2]
    hand, hexport_ms = synced_ms(lambda: src.export_prefill(
        p_hand, max_new_tokens=16))
    rid3, hadmit_ms = synced_ms(lambda: dst.admit_prefilled(
        hand, max_new_tokens=16))
    handed = dst.run_until_done()[rid3]
    steps = src.stats()["decode_steps"] + dst.stats()["decode_steps"]
    counts = Counter(launches)
    require_counts("phase 22 migration and handoff", counts,
                   serving_counts_want(cfg, steps, 0, 2))
    stay = ContinuousBatchEngine(model, max_batch=4, max_len=2048)
    out, (r_m, r_h) = run_engine(stay, [p_mig, p_hand], [48, 16])
    unit = model.__dict__["_select_decode_steps"]
    caps = sum(u.captures for u in unit.values())
    exp_crc, n_exp = crc_ms(t_exp)
    adm_crc, n_adm = crc_ms(t_adm)
    log(f"  [{card}] phase 22 migration: bundle {bundle_mib(mig):.1f} MiB, "
        f"export_slot {export_ms:.2f} ms (its {n_exp} seals' CRCs "
        f"{exp_crc:.2f}, timed inside it), admit_migrated {admit_ms:.2f} ms "
        f"with the restore at admission (its {n_adm} seals' and checks' "
        f"CRCs {adm_crc:.2f}, timed inside it); "
        f"handoff: bundle {bundle_mib(hand):.1f} MiB, export_prefill "
        f"{hexport_ms:.2f} ms, admit_prefilled {hadmit_ms:.2f} ms; the "
        f"one-token decode unit {caps} captures so far (one an engine "
        f"pool), graph pool {pool0 / 2**20:.1f} -> "
        f"{pool_bytes(model) / 2**20:.1f} MiB; migrated = stayed "
        f"{same_share([migrated], [out[r_m]])}, handed off = prefilled "
        f"locally {same_share([handed], [out[r_h]])} (bf16, reported)")
    return counts


def oom_ballast():
    """Device memory held so that only ``OOM_MARGIN`` stays free: a block of
    ``torch.cuda.mem_get_info()``'s free bytes less the margin, then blocks
    of 16, 4 and 1 MiB until none fits (that figure misses the free
    parts of segments the allocator keeps, which earlier runs left), then
    the margin's worth of the 16 MiB ones freed into the allocator's cache.
    Returns (blocks, the free bytes read, the bytes of the top-up)."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    blocks = [torch.empty(free - OOM_MARGIN, dtype=torch.uint8,
                          device="cuda")]
    tops = {}
    for step in (16 * 2**20, 4 * 2**20, 2**20):
        top = tops[step] = []
        try:
            while True:
                top.append(torch.empty(step, dtype=torch.uint8,
                                       device="cuda"))
        except torch.cuda.OutOfMemoryError:
            pass
    topped = sum(len(v) * k for k, v in tops.items())
    del tops[16 * 2**20][:OOM_MARGIN // 2**24]
    return blocks + [t for v in tops.values() for t in v], free, topped


def engine_oom(model, card):
    """Phase 22 real OOM: three requests decode on a 4-slot engine; a
    ballast takes all but ``OOM_MARGIN`` of the card's free memory, so
    admitting a 1500-token prompt (a 2048 bucket this engine has not used:
    256 MiB of dense buffers) raises ``torch.cuda.OutOfMemoryError``. The
    request is shed (``where="oom"``), ``max_active_slots`` shrinks to 3;
    the ballast goes and the three finish with the tokens of a run without
    the OOM. Returns the counts."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    cfg = model.config
    rng = np.random.RandomState(26)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (100, 200, 300)]
    big = rng.randint(0, cfg.vocab_size, 1500)
    res = {}
    for oom in (False, True):
        eng = ContinuousBatchEngine(model, max_batch=4, max_len=2048)
        reset_launches()
        out = {}
        rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
        for _ in range(4):
            out.update(eng.step())
        info = None
        if oom:
            ballast, free, topped = oom_ballast()
            shed = []
            r_big, ms = synced_ms(lambda: eng.add_request(
                big, max_new_tokens=8,
                on_shed=lambda r, i: shed.append(i)))
            st = eng.stats()
            info = (eng.finish_reason(r_big), shed, st["max_active_slots"],
                    st["requests_degraded"], ms,
                    sum(t.numel() for t in ballast), free, topped)
            del ballast
            torch.cuda.empty_cache()
        out.update(eng.run_until_done())
        counts = Counter(launches)
        res[oom] = ([out[r] for r in rids], info, counts,
                    eng.stats()["decode_steps"])
    ref = res[False][0]
    got, (reason, shed, budget, degraded, ms, ballast_b, free,
          topped), counts, steps = res[True]
    log(f"  [{card}] phase 22 real OOM: the admission's finish reason "
        f"{reason}, on_shed {[i['where'] for i in shed]}, max_active_slots "
        f"{budget}, degraded {degraded}, {steps} decode steps, launches "
        f"{json.dumps(dict(counts))}")
    for oom in (False, True):
        require_counts(f"phase 22 OOM ({oom})", res[oom][2],
                       serving_counts_want(cfg, res[oom][3], 0, 3))
    if not (reason == "shed" and len(shed) == 1 and shed[0]["where"] == "oom"
            and budget == 3 and degraded == 1):
        raise AssertionError(f"phase 22 OOM: reason {reason}, shed {shed}, "
                             f"max_active_slots {budget}, degraded "
                             f"{degraded}")
    same = all(np.array_equal(a, b) for a, b in zip(got, ref))
    log(f"  [{card}] phase 22 real OOM: ballast {ballast_b / 2**30:.2f} GiB "
        f"(mem_get_info's free {free / 2**30:.2f} GiB less "
        f"{OOM_MARGIN / 2**20:.0f} MiB, then {topped / 2**20:.0f} MiB more "
        f"in blocks of 16, 4 and 1 MiB until none fit, "
        f"{OOM_MARGIN / 2**20:.0f} MiB of them given back), "
        f"the 2048-bucket admission shed in {ms:.2f} ms (where "
        f"{shed[0]['where']!r}: {shed[0]['error'][:160]}...), "
        f"max_active_slots 4 -> {budget}; the survivors' tokens = the run "
        f"without the OOM: {same}")
    if not same:
        raise AssertionError("phase 22 OOM: the survivors' tokens differ "
                             "from the run without the OOM")
    return counts


def engine_llama(model, card):
    """Phase 22 on phase 3's Llama-3-8B. Returns the counts."""
    t0 = time.perf_counter()
    log(f"phase 22: the engine's scheduler, bundles and OOM degrade on "
        f"Llama-3-8B ({model.config.num_hidden_layers} layers, bf16)")
    counts = Counter()
    for part in (engine_prefix, engine_chunked, engine_preempt,
                 engine_migrate, engine_oom):
        counts.update(part(model, card))
    log(f"phase 22 on Llama-3-8B took {time.perf_counter() - t0:.1f}s")
    return counts


def engine_latent(model, card):
    """Phase 22 latent mode on phase 10's DeepSeek-V2-Lite (``max_batch`` 8,
    ``max_len`` 4096) with the prefix cache and chunks of 512: A = a
    1024-token prefix + 100 (three chunks: an exact 512 on the width-192
    flash kernel, then two suffixes), B = the prefix + 300 (a 64-page hit,
    one suffix chunk), C = 700 new tokens (an exact 512, one suffix).
    ``flash_attention_mla`` 27 a first chunk, ``mla_decode`` 27 a step,
    nothing else of attention. Against the same prompts without either.
    Returns the counts."""
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    t0 = time.perf_counter()
    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(27)
    prefix = rng.randint(0, cfg.vocab_size, 1024)
    prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, n)])
               for n in (100, 300)] + [rng.randint(0, cfg.vocab_size, 700)]
    news = [32, 16, 16]
    eng = ContinuousBatchEngine(model, max_batch=8, max_len=4096,
                                enable_prefix_cache=True,
                                prefill_chunk_tokens=512)
    times = {}
    timed_method(eng, "_run_suffix_chunk", times)
    reset_launches()
    out = {}
    r_a = eng.add_request(prompts[0], max_new_tokens=news[0])
    while eng._chunking or eng.stats()["decode_steps"] < 2:
        out.update(eng.step())
    r_b = eng.add_request(prompts[1], max_new_tokens=news[1])
    r_c = eng.add_request(prompts[2], max_new_tokens=news[2])
    out.update(eng.run_until_done())
    counts = Counter(launches)
    steps = eng.stats()["decode_steps"]
    want = {"flash_attention_mla": 2 * L, "mla_decode": L * steps,
            "flash_attention_bshd": 0, "append_attention": 0,
            "paged_attention": 0, "fused_qkv_rope": 0, "fused_epilogue": 0}
    require_counts("phase 22 DeepSeek-V2-Lite latent", counts, want)
    if eng.prefix_pages_reused != 64:
        raise AssertionError(f"phase 22 latent: {eng.prefix_pages_reused} "
                             "pages reused")
    plain = ContinuousBatchEngine(model, max_batch=8, max_len=4096)
    ref, rids = run_engine(plain, prompts, news)
    got = [out[r] for r in (r_a, r_b, r_c)]
    log(f"  [{card}] phase 22 DeepSeek-V2-Lite latent: prefix cache + "
        f"chunks of 512: suffix prefills ms "
        f"{', '.join(f'{t:.2f}' for t in times['_run_suffix_chunk'])}; "
        f"prefix_pages_reused 64; flash_attention_mla "
        f"{counts['flash_attention_mla']}, mla_decode {counts['mla_decode']}"
        f" ({steps} steps); tokens = no cache, no chunks (bf16, reported) "
        f"{same_share(got, [ref[r] for r in rids])}; "
        f"{time.perf_counter() - t0:.1f}s")
    return counts


def engine_wiring_check():
    """Phase 22 wiring, f32, ``allow_tf32`` off: two layers at full width of
    Llama-3-8B and DeepSeek-V2-Lite, the same weights on the card and the
    CPU. On the card, token for token: prefix-cached = uncached and
    chunked = monolithic (both layouts); preempted and restored = never
    preempted, migrated = stayed, handed off = prefilled locally (paged:
    the JAX engine refuses them in latent mode); and each = the CPU's run
    without the feature (uncached, monolithic, never preempted, stayed,
    prefilled locally). The CPU's runs with each feature are left out:
    they equal its runs without it in the CPU tests, and doubled the CPU
    side's time."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM, LlamaForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.serving import ContinuousBatchEngine as Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kw = dict(max_len=128, page_size=16)
    new = 6

    def prefix(m, ps, cache):
        eng = Engine(m, max_batch=2, enable_prefix_cache=cache, **kw)
        a = eng.add_request(ps[0], max_new_tokens=new)
        eng.step()
        b = eng.add_request(ps[1], max_new_tokens=new)
        out = eng.run_until_done()
        if cache and eng.prefix_pages_reused != 2:
            raise AssertionError("phase 22 wiring: no prefix hit")
        return [out[a], out[b]]

    def chunked(m, ps, chunk):
        eng = Engine(m, max_batch=2, prefill_chunk_tokens=chunk, **kw)
        a = eng.add_request(ps[2], max_new_tokens=new + 4)
        eng.step()
        eng.step()
        b = eng.add_request(ps[3], max_new_tokens=new)
        out = eng.run_until_done()
        return [out[a], out[b]]

    def preempt(m, ps, on):
        eng = Engine(m, max_batch=1, enable_preemption=on, **kw)
        out = {}
        a = eng.add_request(ps[2], max_new_tokens=new + 4, priority=2)
        for _ in range(3):
            out.update(eng.step())
        b = eng.add_request(ps[3], max_new_tokens=new, priority=0)
        out.update(eng.run_until_done())
        if eng.stats()["requests_preempted"] != int(on):
            raise AssertionError("phase 22 wiring: preemption count")
        return [out[a], out[b]]

    def migrate(m, ps, move):
        src = Engine(m, max_batch=1, **kw)
        a = src.add_request(ps[3], max_new_tokens=new + 4)
        for _ in range(3):
            src.step()
        if not move:
            return [src.run_until_done()[a]]
        dst = Engine(m, max_batch=1, **kw)
        b = dst.admit_migrated(src.export_slot(a))
        return [dst.run_until_done()[b]]

    def handoff(m, ps, hand):
        eng = Engine(m, max_batch=1, **kw)
        if hand:
            bundle = Engine(m, max_batch=1, **kw).export_prefill(
                ps[3], max_new_tokens=new)
            r = eng.admit_prefilled(bundle, max_new_tokens=new)
        else:
            r = eng.add_request(ps[3], max_new_tokens=new)
        return [eng.run_until_done()[r]]

    # (label, run, paged layout only)
    checks = (("prefix-cached = uncached", prefix, False),
              ("chunked = monolithic", chunked, False),
              ("preempted and restored = never preempted", preempt, True),
              ("migrated = stayed", migrate, True),
              ("handed off = prefilled locally", handoff, True))
    families = (
        ("Llama-3-8B", LlamaForCausalLM,
         LlamaConfig.llama3_8b(num_hidden_layers=2, dtype="float32"), False),
        ("DeepSeek-V2-Lite", DeepseekV2ForCausalLM,
         deepseek_config(num_hidden_layers=2, dtype="float32"), True),
    )
    for i, (name, cls, cfg, latent) in enumerate(families):
        m_gpu = cls(cfg, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(40 + i))
        m_cpu = cpu_copy(m_gpu)
        rng = np.random.RandomState(40 + i)
        shared = rng.randint(0, cfg.vocab_size, 32)
        ps = [np.concatenate([shared, rng.randint(0, cfg.vocab_size, n)])
              for n in (10, 20)]
        ps += [rng.randint(0, cfg.vocab_size, n) for n in (5, 45)]
        got = {}
        for label, fn, paged_only in checks:
            if latent and paged_only:
                continue
            off = None if label == "chunked = monolithic" else False
            a = fn(m_gpu, ps, {"chunked = monolithic": 16}.get(label, True))
            b = fn(m_gpu, ps, off)
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(
                    f"phase 22 wiring {name} on the card: {label} fails: "
                    f"{[x.tolist() for x in a]} against "
                    f"{[y.tolist() for y in b]}")
            c = fn(m_cpu, ps, off)
            if not all(np.array_equal(x, y) for x, y in zip(a, c)):
                raise AssertionError(f"phase 22 wiring {name}: {label}: "
                                     "card tokens differ from the CPU's")
            got[label] = [x.tolist() for x in a]
        log(f"phase 22 wiring, {name}, 2 layers at full width, f32: on the "
            f"card {'; '.join(got)}, each = the CPU's run without it, token "
            f"for token: {json.dumps(got)}")
        del m_gpu, m_cpu
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 22 wiring took {time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------- phase 23 --

# the published meta-llama/Llama-3.2-1B config.json: phase 23's draft model
LLAMA32_1B = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                  num_hidden_layers=16, num_attention_heads=32,
                  num_key_value_heads=8, head_dim=64,
                  max_position_embeddings=131072, rms_norm_eps=1e-5,
                  rope_theta=500000.0, tie_word_embeddings=True,
                  rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192})
# speculative_generate's prompt, new tokens and draft width (one max_len,
# P + new + k + 2, so each model captures one set of graphs)
SPECGEN_PROMPT, SPECGEN_NEW, SPECGEN_K = 128, 64, 4


@contextlib.contextmanager
def autotune_on():
    """``FLAGS_use_autotune`` on and ``PD_AUTOTUNE_CACHE`` at a fresh file
    in a temporary directory for the block; both restored after. Yields
    the file's path."""
    import tempfile

    from paddle_tpu_torch.ops.hopper import autotune
    from paddle_tpu_torch.utils.flags import flag, set_flags

    prev_flag, prev_env = flag("FLAGS_use_autotune"), os.environ.get(
        "PD_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        os.environ["PD_AUTOTUNE_CACHE"] = path
        set_flags({"FLAGS_use_autotune": True})
        try:
            yield path
        finally:
            autotune.flush_cache()
            set_flags({"FLAGS_use_autotune": prev_flag})
            if prev_env is None:
                os.environ.pop("PD_AUTOTUNE_CACHE", None)
            else:
                os.environ["PD_AUTOTUNE_CACHE"] = prev_env


def stages_seen():
    from paddle_tpu_torch.ops.hopper import autotune

    return dict(sorted(autotune.stages.items()))


def tuned_row(card, kernel, sig, call, launch, plain, close, default,
              tolerance):
    """One hooked kernel's sweep at a main-path shape: ``call()`` (the
    wrapper, flag on, before any unit is built) must measure; its cost
    table printed; every measured candidate's output (``launch(choice)``)
    held against ``plain()`` by ``close``; the default's and the winner's
    device ms by the sweep's own measure (``autotune._device_ms``: CUDA
    events around back-to-back launches behind a spin kernel) and
    profiled (``profile_sessions``; "not measured" where the profiler
    records no device time, which it has done late in a full run).
    Returns (winner, (default events ms, profiled ms or None), (the
    winner's))."""
    import torch

    from paddle_tpu_torch.ops.hopper import autotune

    autotune.stages.clear()
    call()
    torch.cuda.synchronize()
    if autotune.stages.get(f"{kernel} measured") != 1:
        raise AssertionError(f"{kernel} {sig}: the sweep did not measure "
                             f"({stages_seen()})")
    ent = autotune.get_cache().entry(kernel, autotune.full_key(sig))
    winner = tuple(ent["choice"])
    ref = plain()
    errs = {}
    for ck, rec in ent["table"].items():
        if rec.get("status") != "ok":
            continue
        err, ok = close(launch(tuple(int(p) for p in ck.split(","))), ref)
        errs[ck] = err
        if not ok:
            raise AssertionError(f"{kernel} {sig} at {ck}: the kernel "
                                 f"disagrees with its plain version (max "
                                 f"abs err {err})")
    torch.cuda.synchronize()
    ms = {}
    for what, choice in (("default", default), ("winner", winner)):
        totals, _, _ = profile_sessions(lambda: launch(choice))
        ms[what] = (autotune._device_ms(lambda: launch(choice)),
                    max(totals) / 1e3 / 10 if totals else None)
    log(f"  [{card}] {kernel} {sig}: cost table "
        f"{json.dumps(ent['table'], sort_keys=True)}; est "
        f"{json.dumps(ent.get('est'))}; every measured candidate within "
        f"{tolerance} (max abs err by candidate {json.dumps(errs)}); "
        + ", ".join(
            f"{what} {list(c)} events_ms={ms[what][0]:.4f} profiled_ms="
            + ("not measured (the profiler recorded no device time)"
               if ms[what][1] is None else f"{ms[what][1]:.4f}")
            for what, c in (("default", default), ("winner", winner))))
    return winner, ms["default"], ms["winner"]


def sweep_specs(spec_rows=()):
    """Phase 23's sweep shapes, as (row name, kernel, signature, the
    wrapper's call, a launch at a given choice, the plain version, its
    closeness test, the default choice, the tolerance's text): ``rms_norm``
    at 8 rows of 4096 (a decode step at 8 slots) and 262,144 rows of 128
    (bf16); the decode tail at 8 rows of Llama-3-8B's widths; the MLA
    decode at B 8, H 16, r 512, dr 64, T 4096 (DeepSeek-V2-Lite, bf16
    buffers, ragged pos). With ``spec_rows``: the decode tail alone at
    those rows (a verify chunk)."""
    import torch

    from paddle_tpu_torch.ops.hopper import (autotune, decode_tail,
                                             fused_norm, mla_decode)

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bf = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(23)
    specs = []
    if not spec_rows:
        for rows, d in ((8, 4096), (262144, 128)):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(bf)
            w = (torch.randn(d, generator=gen, device="cuda") * 0.5 + 1).to(bf)
            specs.append((
                f"rms_norm rows={rows} d={d}", "rms_norm",
                f"rows{rows} d{d} bfloat16",
                functools.partial(fused_norm.rms_norm, x, w, 1e-5),
                functools.partial(_rms_at, x, w, rows, d),
                functools.partial(fused_norm.rms_norm_plain, x, w, 1e-5),
                functools.partial(close_bf16, atol=1e-6, rtol=2.0 ** -6),
                (fused_norm.rms_layout(d, 2)[1],), "1e-6 + 2^-6 |p|"))
    hidden, H, hk, hd, eps = 4096, 32, 8, 128, 1e-5
    for R in (spec_rows or (8,)):
        t = tail_inputs(R, hidden, H, hk, hd, bf, 23 + R)
        wq, wk, wv = t["wqkv"][0]
        qkv = (t["x"], t["wn"], wq, wk, wv, t["cos"], t["sin"], eps, H, hk,
               hd)
        specs.append((
            f"fused_qkv_rope R={R}", "fused_qkv_rope", autotune.signature(
                {"batch": R, "hidden": hidden, "wtot": (H + 2 * hk) * hd,
                 "dtype": "bfloat16"}),
            functools.partial(decode_tail.fused_qkv_rope, *qkv),
            lambda c, qkv=qkv: decode_tail._launch_qkv(*qkv, 1, n_sm, c[0]),
            functools.partial(decode_tail.fused_qkv_rope_plain, *qkv),
            one_ulp_of_max,
            (decode_tail.split_count((H + 2 * hk) * hd // 128, R, hidden,
                                     n_sm),),
            "one bf16 ulp of the largest entry"))
        epi = (t["attn"], t["wo"][0], t["res"], t["wn"], eps)
        specs.append((
            f"fused_epilogue R={R}", "fused_epilogue", autotune.signature(
                {"batch": R, "width": H * hd, "hidden": hidden,
                 "dtype": "bfloat16"}),
            functools.partial(decode_tail.fused_epilogue, *epi),
            lambda c, epi=epi: decode_tail._launch_epilogue(*epi, 1, n_sm,
                                                            c[0]),
            functools.partial(decode_tail.fused_epilogue_plain, *epi),
            one_ulp_of_max,
            (decode_tail.split_count(hidden // 128, R, H * hd, n_sm),),
            "one bf16 ulp of the largest entry"))
    if spec_rows:
        return specs
    B, Hm, r, dr, T = 8, 16, 512, 64, 4096
    q_lat, q_pe, ((ckv, kpe),) = mla_inputs(B, Hm, r, dr, T, bf, gen)
    pos = torch.tensor([4095, 3000, 2048, 1500, 1024, 700, 100, 0],
                       dtype=torch.int32, device="cuda")
    mla = (q_lat, q_pe, ckv, kpe, pos)
    specs.append((
        "mla_decode", "mla_decode", f"B{B}xH{Hm}xr{r}xT{T} bfloat16",
        functools.partial(mla_decode.mla_decode, *mla),
        lambda c: mla_decode._launch(*mla, None, 1, n_sm, c[0]),
        functools.partial(mla_decode.mla_decode_plain, *mla), mla_close,
        (mla_decode.grid_blocks(B, Hm, n_sm),), "1e-4 + 1e-4 |p|"))
    return specs


def _rms_at(x, w, rows, d, choice):
    from paddle_tpu_torch.ops.hopper import fused_norm

    return fused_norm._launch_rms(x, w, 1e-5, 1, rows, d, choice[0])


def autotune_sweeps(card, spec_rows=()):
    """Phase 23 (a): every ``sweep_specs`` row through ``tuned_row``.
    Returns {row name: (winner, default ms, winner ms)}."""
    return {name: tuned_row(card, *rest)
            for name, *rest in sweep_specs(spec_rows)}


def repeat_sweeps():
    """Phase 23 (c)'s second sweep: each wrapper of (a)'s rows called once
    more on fresh inputs; returns the stages its searches ended in."""
    import torch

    from paddle_tpu_torch.ops.hopper import autotune

    specs = sweep_specs()
    autotune.stages.clear()
    for spec in specs:
        spec[3]()
    torch.cuda.synchronize()
    return stages_seen()


def spec_k_table(model, max_batch):
    """{k: verify ms} of the persisted ``spec_verify`` table of ``model``
    at ``max_batch`` slots, and each k's ms over its expected retired
    tokens at acceptance 0.7 (what ``_resolve_spec_k`` ranks by)."""
    from paddle_tpu_torch.ops.hopper import autotune
    from paddle_tpu_torch.serving import spec_verify_params

    sig = autotune.signature(spec_verify_params(model.config, max_batch))
    ent = autotune.get_cache().entry("spec_verify", autotune.full_key(sig))
    table = {int(k): rec.get("ms", rec.get("status"))
             for k, rec in sorted((ent or {}).get("table", {}).items(),
                                  key=lambda kv: int(kv[0]))}
    scores = {k: round(ms / sum(0.7 ** i for i in range(k)), 4)
              for k, ms in table.items() if isinstance(ms, float)}
    return table, scores


def auto_engine_run(model, card, label, prompts, news, fused,
                    speculative_k="auto"):
    """One engine run at 8 slots, max_len 2048, ``speculative_k="auto"``
    (or the given one): the stage counter and the launch counts zeroed
    just before the engine is made and read after its requests. Returns
    (k, outputs, counts, stages, the splits the decode tail's launches took
    by (rows, split))."""
    import torch

    from paddle_tpu_torch.ops.hopper import (autotune, decode_tail, launches,
                                             reset_launches)
    from paddle_tpu_torch.utils.flags import flag_overrides

    splits = Counter()
    real = decode_tail._launch_qkv

    def spy(*a):
        splits[(a[0].shape[0], a[-1])] += 1
        return real(*a)

    decode_tail._launch_qkv = spy
    try:
        with flag_overrides({"use_fused_decode_tail": fused}):
            autotune.stages.clear()
            reset_launches()
            t0 = time.perf_counter()
            eng = timed_engine(model, max_batch=8, max_len=2048,
                               page_size=16, speculative_k=speculative_k)
            resolve_s = time.perf_counter() - t0
            rids = [eng.add_request(p, max_new_tokens=m)
                    for p, m in zip(prompts, news)]
            out = eng.run_until_done()
            torch.cuda.synchronize()
            counts = dict(launches)
    finally:
        decode_tail._launch_qkv = real
    st = eng.stats()
    outputs = [out[r] for r in rids]
    for toks, m in zip(outputs, news):
        if len(toks) != m:
            raise AssertionError(f"{label}: {len(toks)} tokens of {m}")
    log(f"  [{card}] {label}: speculative_k={speculative_k!r} resolved to "
        f"k={eng.speculative_k} in {resolve_s:.2f}s; {st['decode_steps']} "
        f"dispatches ({st['spec_dispatches']} speculative), "
        f"{st['tokens_generated']} tokens, accepted drafts "
        f"{st['spec_accepted_tokens']}, decode ms/dispatch median "
        f"{statistics.median(eng.step_ms):.3f}; search stages "
        f"{json.dumps(stages_seen())}; decode-tail launches by (rows, "
        f"split) {json.dumps({str(k): v for k, v in splits.items()})}; "
        f"launches {json.dumps(counts)}")
    return eng.speculative_k, outputs, counts, stages_seen(), splits


def specgen_runs(target, card):
    """Phase 23 (d): ``speculative_generate`` at full depth, target
    Llama-3-8B (bf16): a Llama-3.2-1B-shaped random draft (rejections) and
    the target as its own draft (the m == k catch-up). Each run twice (the
    first captures the graphs), the second timed, launch counts zeroed
    just before it: append attention exactly L_target a verify plus
    L_draft x k a proposal round, the flash kernel once a layer of each
    model's prefill. The target's ``generate`` ms a token beside. Returns
    the launch counts of the timed runs."""
    import torch

    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.speculative import speculative_generate

    draft = LlamaForCausalLM(LlamaConfig(**LLAMA32_1B, dtype="bfloat16"),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(
                                 32))
    ids = torch.from_numpy(np.random.RandomState(23).randint(
        0, target.config.vocab_size, size=(1, SPECGEN_PROMPT))).to("cuda")
    k, new = SPECGEN_K, SPECGEN_NEW
    generate(target, ids, max_new_tokens=new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_toks = generate(target, ids, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    log(f"  [{card}] phase 23 (d): target generate, prompt "
        f"{SPECGEN_PROMPT}, {new} new tokens: {gen_ms:.2f} ms, "
        f"{gen_ms / new:.3f} ms a token (prefill included)")
    total = Counter()
    for label, d in (("Llama-3.2-1B-shaped draft (16 layers, random)",
                      draft), ("the target as its own draft", target)):
        l_t, l_d = (target.config.num_hidden_layers,
                    d.config.num_hidden_layers)
        first, _ = speculative_generate(target, d, ids, new, draft_k=k,
                                        return_stats=True)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        toks, st = speculative_generate(target, d, ids, new, draft_k=k,
                                        return_stats=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(launches)
        want = {"append_attention": st["rounds"] * (l_t + k * l_d),
                "flash_attention_bshd": l_t + l_d}
        same = int((toks.cpu() == gen_toks.cpu()).sum())
        log(f"  [{card}] phase 23 (d) speculative_generate, {label}, k={k}: "
            f"{st['rounds']} rounds, hits {st['hits']}, acceptance "
            f"{st['acceptance']:.3f}, {new / st['rounds']:.2f} tokens a "
            f"round, {ms:.2f} ms, {ms / st['rounds']:.3f} ms a round, "
            f"{ms / new:.3f} ms a token (prefills included) against "
            f"generate's {gen_ms / new:.3f}; tokens = generate's "
            f"{same}/{new} (bf16, reported only); append_attention "
            f"{counts.get('append_attention', 0)} = {st['rounds']} rounds x "
            f"({l_t} + {k} x {l_d}); launches {json.dumps(counts)}")
        if not torch.equal(toks, first):
            raise AssertionError(f"{label}: two runs gave other tokens")
        for name, n in want.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"speculative_generate {label}: {name} "
                                     f"launched {counts.get(name, 0)} "
                                     f"times, expected {n}")
        if d is target and st["acceptance"] != 1.0:
            raise AssertionError("the target as its own draft had a draft "
                                 "rejected")
        total.update(counts)
    del draft
    return total


def autotune_wiring_check():
    """Phase 23 (e): Llama-3-8B widths at 2 layers in f32 (as phase 4), a
    Llama-3.2-1B-shaped draft at 1 layer, the same weights on the card and
    the CPU: ``speculative_generate``'s tokens on the card = the CPU
    port's = the card's ``generate``; and the card's engine with
    ``speculative_k="auto"`` (its verify measured at this model's
    signature) gives each request solo ``generate``'s tokens."""
    import torch

    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.speculative import speculative_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_gpu = LlamaForCausalLM(
        LlamaConfig.llama3_8b(num_hidden_layers=2, dtype="float32"),
        device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    d_gpu = LlamaForCausalLM(
        LlamaConfig(**dict(LLAMA32_1B, num_hidden_layers=1),
                    dtype="float32"),
        device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    t_cpu, d_cpu = cpu_copy(t_gpu), cpu_copy(d_gpu)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, t_gpu.config.vocab_size, size=(1, 37))
    card, cst = speculative_generate(t_gpu, d_gpu, ids, 16, draft_k=3,
                                     return_stats=True)
    cpu, pst = speculative_generate(t_cpu, d_cpu, ids, 16, draft_k=3,
                                    return_stats=True)
    solo = generate(t_gpu, torch.from_numpy(ids).to("cuda"),
                    max_new_tokens=16)
    self_draft = speculative_generate(t_gpu, t_gpu, ids, 16, draft_k=3)
    prompts = [rng.randint(0, t_gpu.config.vocab_size, size=n)
               for n in (40, 23)]
    eng = ContinuousBatchEngine(t_gpu, max_batch=2, max_len=64,
                                speculative_k="auto")
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    got = eng.run_until_done()
    eng_ok = all(np.array_equal(got[r], generate(
        t_gpu, torch.from_numpy(p[None]).to("cuda"),
        max_new_tokens=8)[0].cpu().numpy()) for r, p in zip(rids, prompts))
    log(f"phase 23 (e) wiring, 2 layers of Llama-3-8B and 1 of the "
        f"Llama-3.2-1B shape, f32: speculative_generate (k=3) card "
        f"{card[0].tolist()} stats {cst}, cpu {cpu[0].tolist()} stats {pst}, "
        f"card generate {solo[0].tolist()}, the target as its own draft "
        f"{self_draft[0].tolist()}; engine speculative_k='auto' resolved to "
        f"k={eng.speculative_k}, engine = solo generate: {eng_ok}")
    if not (torch.equal(card.cpu(), cpu) and torch.equal(card, solo)
            and torch.equal(self_draft, solo) and cst == pst):
        raise AssertionError("speculative_generate: card, CPU and generate "
                             "tokens differ")
    if not eng_ok:
        raise AssertionError("the 'auto' engine's tokens differ from solo "
                             "generate")
    del t_gpu, d_gpu, t_cpu, d_cpu, eng
    torch.cuda.empty_cache()


def autotune_phase(then=None):
    """Phase 23: the autotune search and ``speculative_generate`` at full
    width, ``FLAGS_use_autotune`` on and the cache at a fresh file in a
    temporary directory (``autotune_on``); a fresh Llama-3-8B (bf16, 32
    layers), swept before any of its units is built. (a) the sweeps; (b)
    an engine with ``speculative_k="auto"`` (fused tail off): the measured
    k table, the chosen k, 8 prompts that repeat a pattern, tokens against
    solo ``generate`` (bf16, reported only, as phase 16); (c) the decode
    tail swept at the verify chunk's rows, then a second engine (fused
    tail on) and a second sweep at (a)'s shapes, which must measure
    nothing: every search ends at the cache, and the captured verify
    launches the winning split; (d) ``specgen_runs``; then ``then(model,
    card)`` (phase 24, with the flag off), the model freed, and (e)
    ``autotune_wiring_check`` under a fresh cache. Returns the launch
    counts of the engines', ``speculative_generate``'s and ``then``'s runs
    (the sweeps' are taken out of the counts)."""
    import torch

    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    t_phase = time.perf_counter()
    total = Counter()
    with autotune_on() as path:
        card = card_line()
        model = LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                                 device="cuda",
                                 generator=torch.Generator(
                                     "cuda").manual_seed(0))
        log(f"phase 23: the autotune search (FLAGS_use_autotune on, cache "
            f"{path}) and speculative_generate on Llama-3-8B (32 layers, "
            f"bf16)")
        first = autotune_sweeps(card)
        prompts, news = spec_prompts(model.config.vocab_size)
        k, outs, counts, _, _ = auto_engine_run(
            model, card, "phase 23 (b) engine, fused tail off", prompts, news,
            False)
        table, scores = spec_k_table(model, 8)
        log(f"  [{card}] phase 23 (b) spec_verify table, verify ms a "
            f"dispatch by k: {json.dumps(table)}; ms over the expected "
            f"retired tokens at acceptance 0.7: {json.dumps(scores)}; "
            f"chosen k={k}")
        if not scores or k not in scores or k != min(scores,
                                                     key=scores.get):
            raise AssertionError("speculative_k='auto' did not take the "
                                 "best-ranked measured k")
        total.update(counts)
        solo = generate(model, torch.from_numpy(np.stack(prompts)).to(
            "cuda"), max_new_tokens=news[0]).cpu().numpy()
        same = sum(int((o == s).sum()) for o, s in zip(outs, solo))
        log(f"  [{card}] phase 23 (b) engine vs generate on the same "
            f"prompts (bf16, reported only): {same}/{solo.size} tokens "
            f"identical")
        spec_rows = autotune_sweeps(card, spec_rows=(8 * k,))
        _, outs2, counts, stages, splits = auto_engine_run(
            model, card, "phase 23 (c) second engine, fused tail on",
            prompts, news, True)
        total.update(counts)
        # the one-token graphed decode at 8 slots, fused tail on: the
        # winning split of (a)'s 8-row sweep
        _, _, counts, stages1, splits1 = auto_engine_run(
            model, card, "phase 23 (c) one-token engine, fused tail on",
            prompts[:2], [8, 8], True, speculative_k=None)
        total.update(counts)
        for name, n in stages1.items():
            stages[name] = stages.get(name, 0) + n
        qkv_winner = spec_rows[f"fused_qkv_rope R={8 * k}"][0][0]
        qkv_winner8 = first["fused_qkv_rope R=8"][0][0]
        again = repeat_sweeps()
        log(f"  [{card}] phase 23 (c) the second sweep at (a)'s shapes: "
            f"stages {json.dumps(again)}")
        bad = [s for s in list(stages) + list(again)
               if s.endswith(" measured") or s.endswith(" failed")]
        need = ("spec_verify cache", "fused_qkv_rope cache",
                "fused_epilogue cache")
        if bad or any(stages.get(s, 0) < 1 for s in need):
            raise AssertionError(f"the second engine measured or missed the "
                                 f"cache: {stages}")
        if any(again.get(s, 0) != n for s, n in (
                ("rms_norm cache", 2), ("fused_qkv_rope cache", 1),
                ("fused_epilogue cache", 1), ("mla_decode cache", 1))):
            raise AssertionError(f"the second sweep missed the cache: "
                                 f"{again}")
        if not splits.get((8 * k, qkv_winner)) or set(splits1) != {
                (8, qkv_winner8)}:
            raise AssertionError(f"the captured units did not launch the "
                                 f"winning splits {qkv_winner} (verify) and "
                                 f"{qkv_winner8} (decode): {splits}, "
                                 f"{splits1}")
        same = sum(int((a == b).sum()) for a, b in zip(outs, outs2))
        log(f"  [{card}] phase 23 (c) fused vs discrete engine tokens (bf16, "
            f"reported only): {same}/{sum(len(o) for o in outs)}")
        total.update(specgen_runs(model, card))
    t_then = time.perf_counter()
    if then is not None:
        # phase 24 on this model, outside FLAGS_use_autotune
        total.update(then(model, card))
    t_then = time.perf_counter() - t_then
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with autotune_on():
        autotune_wiring_check()
    log(f"phase 23 took {time.perf_counter() - t_phase - t_then:.1f}s; "
        f"defaults and winners (events ms, profiled ms): " + "; ".join(
            f"{name} {list(w)} {d} -> {wm}" for name, (w, d, wm) in
            {**first, **spec_rows}.items()))
    return total


# ---- phase 24: the HTTP front-end and the engine's observability ----------

HTTP_SLOTS, HTTP_MAX_LEN, HTTP_PROMPT, HTTP_NEW = 8, 2048, 512, 32
# (d)'s cold bucket and (f)'s padded prompts: bucket 1024
HTTP_PADDED = (1000, 900)


class _Http:
    """A stdlib client of one ``CompletionServer``: JSON posts, SSE streams
    and GETs, each on a connection of its own."""

    def __init__(self, srv):
        self.host, self.port = srv.address

    def _conn(self):
        import http.client

        return http.client.HTTPConnection(self.host, self.port, timeout=600)

    def post(self, body, headers=None):
        """(status, JSON body, response headers)."""
        conn = self._conn()
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, json.loads(data), dict(resp.getheaders())

    def stream(self, body):
        """(status, the data lines in order, seconds to the first one)."""
        t0 = time.perf_counter()
        conn = self._conn()
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        events, t_first = [], None
        while True:
            line = resp.fp.readline()
            if not line:
                break
            line = line.decode().strip()
            if line.startswith("data: "):
                if t_first is None:
                    t_first = time.perf_counter() - t0
                events.append(line[len("data: "):])
            elif line == "0":         # the chunked body's last chunk
                resp.fp.readline()
                break
        conn.close()
        return resp.status, events, t_first

    def get(self, path, raw=False):
        conn = self._conn()
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, (data.decode() if raw else json.loads(data))


def metric_values(text, name):
    """{label string: value} of one family in a Prometheus text body."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, _, val = line.rpartition(" ")
            out[key[len(name):]] = float(val)
    return out


def stream_tokens(events):
    return [json.loads(e)["choices"][0]["token_ids"][0]
            for e in events if e != "[DONE]"]


def direct_run(eng, prompts, n_new, fused):
    """The engine driven from this thread: {prompt index: tokens} and the
    launch counts and decode steps of the run."""
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.utils.flags import flag_overrides

    with flag_overrides({"use_fused_decode_tail": fused}):
        steps0 = eng.stats()["decode_steps"]
        reset_launches()
        rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
        out = eng.run_until_done()
        counts = dict(launches)
    return ([out[r].tolist() for r in rids], counts,
            eng.stats()["decode_steps"] - steps0)


def concurrent_posts(client, prompts, n_new, extra=None):
    """One client thread a prompt, all at once; {index: response}."""
    import threading

    got = {}

    def one(i):
        got[i] = client.post(dict({"prompt_token_ids": prompts[i].tolist(),
                                   "max_tokens": n_new}, **(extra or {})))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return got


def fused_counts_want(cfg, steps, prefills_exact):
    """``serving_counts_want`` with the fused decode tail on: per decode
    step ``fused_qkv_rope`` and ``fused_epilogue`` a layer, each for one
    ``rms_norm`` or ``add_rms_norm`` a layer."""
    want = serving_counts_want(cfg, steps, prefills_exact, 0)
    L = cfg.num_hidden_layers
    want["rms_norm"] -= L * steps
    want["add_rms_norm"] -= L * steps
    want["fused_qkv_rope"] = want["fused_epilogue"] = L * steps
    return want


class _Intervals:
    """Records the host interval and thread of every graph capture and of
    every reference replay of the sentinel, for the block."""

    def __enter__(self):
        import threading

        from paddle_tpu_torch.jit import cuda_graph
        from paddle_tpu_torch.observability import sentinel

        self.captures, self.audits = [], []
        self._cg, self._sn = cuda_graph, sentinel
        self._cap = cuda_graph.GraphedStep._capture
        self._ref = sentinel.reference_decode
        cap, ref, me = self._cap, self._ref, self

        def capture(unit, *a, **k):
            t0 = time.perf_counter()
            try:
                return cap(unit, *a, **k)
            finally:
                me.captures.append((threading.current_thread().name,
                                    type(unit).__name__, t0,
                                    time.perf_counter()))

        def reference(*a, **k):
            t0 = time.perf_counter()
            try:
                return ref(*a, **k)
            finally:
                me.audits.append((t0, time.perf_counter()))

        cuda_graph.GraphedStep._capture = capture
        sentinel.reference_decode = reference
        return self

    def __exit__(self, *exc):
        self._cg.GraphedStep._capture = self._cap
        self._sn.reference_decode = self._ref


def http_phase(model, card):
    """Phase 24: ``CompletionServer`` over the engine (8 slots, ``max_len``
    2048, page 16) at full width on 127.0.0.1, the observability stack on
    (the server enables the tracer, the flight recorder, the step profiler,
    the KV atlas and the sentinel). (a) eight concurrent 512-token greedy
    clients, 32 new tokens, fused tail off and then on: tokens = the same
    engine driven directly, launch counts exact; (b) one SSE stream; (c)
    ``n`` 2 with logprobs, a stop id, priority + SLO + deadline header, a
    client that disconnects mid stream (the engine's ``cancelled``); (d)
    ``X-Audit: 1`` on a request whose audit runs while the engine thread
    captures a cold bucket (1000 tokens, bucket 1024): both intervals and
    the verdict and drift logged, the verdict waited for; (e) /metrics
    counters = the requests sent, /health, /v1/models, /profile's phases,
    /kvstate's capacity = the pool's bytes, a ``traceparent`` echoed with
    its trace id; (g) time to first token over HTTP against the engine's
    own, and the graphed decode step's wall with the tracer and recorder
    on and off in turns. Returns (a)'s launch counts."""
    import threading

    import torch

    from paddle_tpu_torch.observability import flightrecorder, tracing
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.serving_http import CompletionServer
    from paddle_tpu_torch.utils.flags import set_flags

    t_phase = time.perf_counter()
    cfg = model.config
    L = cfg.num_hidden_layers
    log(f"phase 24: the HTTP front-end over the engine ({HTTP_SLOTS} slots, "
        f"max_len {HTTP_MAX_LEN}, page 16) on Llama-3-8B ({L} layers, bf16)")
    rng = np.random.RandomState(24)
    prompts = [rng.randint(0, cfg.vocab_size, size=HTTP_PROMPT)
               for _ in range(HTTP_SLOTS)]
    eng = ContinuousBatchEngine(model, max_batch=HTTP_SLOTS,
                                max_len=HTTP_MAX_LEN, page_size=16)
    ref = {}
    for fused in (False, True):
        ref[fused], counts, steps = direct_run(eng, prompts, HTTP_NEW, fused)
        log(f"  [{card}] phase 24 (a) the engine driven directly, fused "
            f"tail {'on' if fused else 'off'}: {steps} decode steps, "
            f"launches {json.dumps(counts)}")
    total = Counter()
    srv = CompletionServer(eng, model_name="llama-3-8b").start()
    client = _Http(srv)
    try:
        text0 = client.get("/metrics", raw=True)[1]
        sent = 0
        from paddle_tpu_torch.ops.hopper import launches, reset_launches

        # (a) the eight concurrent clients, tail off then on
        for fused in (False, True):
            set_flags({"use_fused_decode_tail": fused})
            try:
                steps0 = eng.stats()["decode_steps"]
                reset_launches()
                got = concurrent_posts(client, prompts, HTTP_NEW)
                counts = dict(launches)
            finally:
                set_flags({"use_fused_decode_tail": False})
            sent += len(prompts)
            steps = eng.stats()["decode_steps"] - steps0
            toks = [got[i][1]["choices"][0]["token_ids"]
                    for i in range(len(prompts))]
            if any(got[i][0] != 200 for i in got) or toks != ref[fused]:
                raise AssertionError(f"phase 24 (a) fused={fused}: HTTP "
                                     "tokens differ from the engine driven "
                                     "directly")
            want = (fused_counts_want(cfg, steps, len(prompts)) if fused
                    else serving_counts_want(cfg, steps, len(prompts), 0))
            require_counts(f"phase 24 (a) fused={fused}", counts, want)
            require_launched(counts, FUSED_KERNELS + (
                "rms_norm", "add_rms_norm", "flash_attention_bshd")
                if fused else ("rms_norm", "add_rms_norm",
                               "flash_attention_bshd", "paged_attention"),
                "HTTP serving")
            total.update(counts)
            usage = got[0][1]["usage"]
            log(f"  [{card}] phase 24 (a) 8 concurrent HTTP clients, fused "
                f"tail {'on' if fused else 'off'}: tokens = the engine "
                f"driven directly: True; {steps} decode steps; launches "
                f"exact {json.dumps(counts)}; usage of client 0 "
                f"{json.dumps(usage)}")
        # (b) one SSE stream
        status, events, _ = client.stream({
            "prompt_token_ids": prompts[0].tolist(), "max_tokens": HTTP_NEW,
            "stream": True})
        sent += 1
        if (status != 200 or events[-1] != "[DONE]"
                or stream_tokens(events) != ref[False][0]):
            raise AssertionError("phase 24 (b): the SSE stream's tokens, "
                                 "order or [DONE] are wrong")
        log(f"  [{card}] phase 24 (b) SSE: {len(events) - 1} token chunks "
            f"in order, [DONE] last")
        # (c) n, logprobs, a stop id, priority + SLO + deadline, disconnect
        status, body, _ = client.post({
            "prompt_token_ids": prompts[1].tolist(), "max_tokens": 16,
            "n": 2, "temperature": 0.8, "logprobs": 1})
        sent += 2
        lps = [c["logprobs"]["token_logprobs"] for c in body["choices"]]
        if (status != 200 or len(body["choices"]) != 2
                or any(len(x) != 16 or max(x) > 0 for x in lps)):
            raise AssertionError(f"phase 24 (c) n=2: {status} {body}")
        stop = ref[False][2][HTTP_NEW // 4]
        status, body, _ = client.post({
            "prompt_token_ids": prompts[2].tolist(), "max_tokens": HTTP_NEW,
            "stop_token_ids": [stop]})
        sent += 1
        cut = ref[False][2][:ref[False][2].index(stop) + 1]
        ch = body["choices"][0]
        if ch["token_ids"] != cut or ch["finish_reason"] != "stop":
            raise AssertionError(f"phase 24 (c) stop id: {ch}")
        status, body, _ = client.post({
            "prompt_token_ids": prompts[3].tolist(), "max_tokens": HTTP_NEW,
            "priority": 0, "slo_ms": 600000.0},
            {"X-Request-Deadline": "600000"})
        sent += 1
        if status != 200 or body["choices"][0]["token_ids"] != ref[False][3]:
            raise AssertionError(f"phase 24 (c) priority + SLO: {status}")
        cancelled0 = eng.stats()["requests_cancelled"]
        cancel_rid = eng._next_rid
        http_disconnect(client, prompts[4])
        sent += 1
        for _ in range(400):
            if eng.stats()["requests_cancelled"] > cancelled0:
                break
            time.sleep(0.025)
        reasons = [eng.finish_reason(r) for r in
                   range(cancel_rid, eng._next_rid)]
        if "cancelled" not in reasons:
            raise AssertionError(f"phase 24 (c) disconnect: reasons "
                                 f"{reasons}")
        log(f"  [{card}] phase 24 (c) n=2 with logprobs (max "
            f"{max(max(x) for x in lps):.4f}), stop id {stop} after "
            f"{len(cut)} tokens (reason stop), priority 0 + slo_ms + "
            f"X-Request-Deadline = direct tokens, a client that left mid "
            f"stream: reason cancelled")
        # (d) an audit in flight while a cold bucket is captured
        with _Intervals() as iv:
            fin0 = eng.stats()["requests_finished"]
            out = {}
            a = threading.Thread(target=lambda: out.update(a=client.post(
                {"prompt_token_ids": prompts[5].tolist(),
                 "max_tokens": HTTP_NEW}, {"X-Audit": "1"})))
            a.start()
            while eng.stats()["requests_finished"] == fin0:
                time.sleep(0.001)
            long_prompt = rng.randint(0, cfg.vocab_size,
                                      size=HTTP_PADDED[0])
            out["b"] = client.post({"prompt_token_ids": long_prompt.tolist(),
                                    "max_tokens": 8})
            a.join(600)
            sent += 2
        status, body, _ = out["a"]
        audit = body.get("audit", {})
        if status != 200 or body["choices"][0]["token_ids"] != ref[False][5]:
            raise AssertionError(f"phase 24 (d): the audited request: "
                                 f"{status}")
        if out["b"][0] != 200 or audit.get("verdict") not in ("pass",
                                                              "diverged"):
            raise AssertionError(f"phase 24 (d): {out['b'][0]}, audit "
                                 f"{audit}")
        (a0, a1), = iv.audits
        during = [c for c in iv.captures
                  if c[0] == "engine-loop" and a0 <= c[2] <= a1]
        worker = [c for c in iv.captures if c[0].startswith("audit-worker")]
        log(f"  [{card}] phase 24 (d) X-Audit: 1 (bf16, reported): verdict "
            f"{audit.get('verdict')}, first divergence "
            f"{audit.get('first_divergence')}, logprob drift "
            f"{audit.get('logprob_drift')}; the reference replay ran "
            f"{a1 - a0:.2f}s on the audit worker (its captures "
            f"{[(c[1], round(c[3] - c[2], 2)) for c in worker]}), the engine "
            f"thread captured {[(c[1], round(c[3] - c[2], 2)) for c in during]}"
            f" inside it")
        if not during:
            engine = [(c[1], round(c[2] - a0, 3), round(c[3] - a0, 3))
                      for c in iv.captures if c[0] == "engine-loop"]
            raise AssertionError(f"phase 24 (d): no engine-thread capture "
                                 f"while the audit ran ({a1 - a0:.3f}s; the "
                                 f"engine thread's captures, s from the "
                                 f"audit's start: {engine})")
        # (f) padded prompts over HTTP: append attention in their prefill
        padded = [rng.randint(0, cfg.vocab_size, size=n)
                  for n in HTTP_PADDED]
        steps0 = eng.stats()["decode_steps"]
        reset_launches()
        got = concurrent_posts(client, padded, 8)
        counts = dict(launches)
        sent += len(padded)
        steps = eng.stats()["decode_steps"] - steps0
        want = serving_counts_want(cfg, steps, 0, len(padded))
        if any(got[i][0] != 200 for i in got):
            raise AssertionError("phase 24 (f): a padded request failed")
        require_counts("phase 24 (f) padded prompts", counts, want)
        require_launched(counts, ("append_attention", "paged_attention"),
                         "HTTP serving, padded prompts")
        total.update(counts)
        log(f"  [{card}] phase 24 (f) 2 concurrent padded prompts "
            f"{HTTP_PADDED} (bucket {eng._bucket(HTTP_PADDED[0])}): {steps} "
            f"decode steps, launches exact {json.dumps(counts)}")
        # (e) the observability routes
        tid = "0af7651916cd43dd8448eb211c80319c"
        status, body, hdrs = client.post(
            {"prompt_token_ids": prompts[6].tolist(), "max_tokens": 4},
            {"traceparent": f"00-{tid}-b7ad6b7169203331-01"})
        sent += 1
        echoed = tracing.parse_traceparent(hdrs.get("traceparent"))
        if status != 200 or echoed is None or echoed[0] != tid:
            raise AssertionError(f"phase 24 (e) traceparent: "
                                 f"{hdrs.get('traceparent')}")
        _, spans = client.get(f"/trace?trace_id={tid}")
        names = sorted({s["name"] for s in spans["spans"]})
        text1 = client.get("/metrics", raw=True)[1]
        adm = (metric_values(text1, "serving_requests_total")
               ['{engine="decoder",event="admitted"}']
               - metric_values(text0, "serving_requests_total")
               ['{engine="decoder",event="admitted"}'])
        if adm != sent:
            raise AssertionError(f"phase 24 (e) /metrics: {adm} admitted, "
                                 f"{sent} sent")
        _, health = client.get("/health")
        _, models = client.get("/v1/models")
        _, prof = client.get("/profile")
        _, kv = client.get("/kvstate")
        _, aud = client.get("/audit")
        phases = prof["engines"]["decoder"]["phases"]
        pool = sum(c[k].numel() * c[k].element_size()
                   for c in eng._caches for k in ("k_pages", "v_pages"))
        kvd = kv["engines"]["decoder"]
        if (health["status"] != "ok" or health["max_batch"] != HTTP_SLOTS
                or models["data"][0]["id"] != "llama-3-8b"
                or not {"admit", "prefill", "dispatch", "sync",
                        "retire"} <= set(phases)
                or kvd["capacity_bytes"] != pool):
            raise AssertionError(f"phase 24 (e): health {health['status']}, "
                                 f"phases {sorted(phases)}, kvstate "
                                 f"{kvd['capacity_bytes']} B against the "
                                 f"pool's {pool} B")
        log(f"  [{card}] phase 24 (e) /metrics admitted {adm:.0f} = sent "
            f"{sent}; /health ok; /v1/models {models['data'][0]['id']}; "
            f"/profile phases " + ", ".join(
                f"{k} p50 {v['p50_ms']:.3f} ms" for k, v in phases.items())
            + f"; roofline {json.dumps(prof['engines']['decoder']['roofline'])}"
            f"; /kvstate capacity {kvd['capacity_bytes']} B = the pool, "
            f"peak {kvd['pages_peak']} pages; /audit "
            f"{aud['engines']['decoder']['verdicts']}; traceparent trace id "
            f"echoed, spans {names}")
        # (g) time to first token: over HTTP, then the engine's own
        ttft_http = []
        for i in range(3):
            _, _, t_first = client.stream({
                "prompt_token_ids": prompts[7].tolist(), "max_tokens": 2,
                "stream": True})
            ttft_http.append(t_first * 1e3)
    finally:
        srv.close()
    ttft_eng = []
    for i in range(3):
        first = []
        t0 = time.perf_counter()
        eng.add_request(prompts[7], max_new_tokens=2,
                        on_token=lambda r, t, d: first.append(
                            time.perf_counter()) if not first else None)
        eng.run_until_done()
        ttft_eng.append((first[0] - t0) * 1e3)
    log(f"  [{card}] phase 24 (g) time to first token, prompt "
        f"{HTTP_PROMPT} on an idle engine: over HTTP (SSE) "
        f"{[round(x, 2) for x in ttft_http]} ms, the engine's own admission "
        f"{[round(x, 2) for x in ttft_eng]} ms")
    walls = decode_walls_observed(eng, prompts)
    med = {label: statistics.median([x for lb, w in walls if lb == label
                                     for x in w])
           for label in ("tracer+recorder off", "tracer+recorder on")}
    log(f"  [{card}] phase 24 (g) graphed decode step wall at 8 slots, "
        f"median ms of each turn's {len(walls[0][1])} steps: " + ", ".join(
            f"{label} {statistics.median(w):.3f}" for label, w in walls)
        + "; over all turns " + ", ".join(
            f"{label} {ms:.3f}" for label, ms in med.items()))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    http_wiring_check()
    log(f"phase 24 took {time.perf_counter() - t_phase:.1f}s")
    return total


def http_disconnect(client, prompt):
    """A streaming client that reads its first chunk and resets the
    connection."""
    import socket
    import struct

    conn = client._conn()
    conn.request("POST", "/v1/completions", json.dumps({
        "prompt_token_ids": prompt.tolist(),
        "max_tokens": min(400, HTTP_MAX_LEN - prompt.size), "stream": True}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"phase 24 (c) disconnect: {resp.status} "
                             f"{resp.read()}")
    resp.fp.readline()
    conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
    conn.sock.close()
    conn.close()


def decode_walls_observed(eng, prompts, turns=4, steps=32):
    """The graphed one-token decode step's wall at 8 slots (the step
    already waits for its tokens), with the tracer and the flight
    recorder off and on, in turns; each turn's steps after a refill."""
    from paddle_tpu_torch.observability import flightrecorder, tracing

    tracer, rec = tracing.get_tracer(), flightrecorder.get_recorder()
    walls = []
    for _ in range(turns):
        for label, on in (("off", False), ("on", True)):
            (tracer.enable if on else tracer.disable)()
            (rec.enable if on else rec.disable)()
            for p in prompts:
                eng.add_request(p, max_new_tokens=steps + 1)
            eng.step()          # the first step after the admissions
            w = []
            for _ in range(steps):
                t0 = time.perf_counter()
                eng.step()
                w.append((time.perf_counter() - t0) * 1e3)
            eng.run_until_done()
            walls.append((f"tracer+recorder {label}", w))
    tracer.enable()
    rec.enable()
    return walls


def http_wiring_check(device="cuda", cfg=None):
    """Phase 24 wiring, f32, ``allow_tf32`` off: two layers of Llama-3-8B
    on the card and the same weights on the CPU. Served over HTTP on the
    card, each greedy completion = the CPU port's ``generate`` = the card's
    solo ``generate``; an ``X-Audit: 1`` request passes; with
    ``FLAGS_perturb_decode_token`` on, an audited request diverges, its
    bundle is sealed, and ``replay_bundle`` reproduces it and blames the
    drill. (``device`` and ``cfg`` let the check run off the card.)"""
    import torch

    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import sentinel
    from paddle_tpu_torch.serving import ContinuousBatchEngine
    from paddle_tpu_torch.serving_http import CompletionServer
    from paddle_tpu_torch.utils.flags import set_flags

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = LlamaForCausalLM(
        cfg or LlamaConfig.llama3_8b(num_hidden_layers=2, dtype="float32"),
        device=device, generator=torch.Generator(device).manual_seed(2))
    cpu = cpu_copy(gpu)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, gpu.config.vocab_size, size=n)
               for n in (40, 23)]
    want = [generate(cpu, torch.from_numpy(p[None]),
                     max_new_tokens=8)[0].tolist() for p in prompts]
    solo = [generate(gpu, torch.from_numpy(p[None]).to(device),
                     max_new_tokens=8)[0].tolist() for p in prompts]
    eng = ContinuousBatchEngine(gpu, max_batch=2, max_len=128, page_size=16)
    srv = CompletionServer(eng).start()
    client = _Http(srv)
    try:
        got = concurrent_posts(client, prompts, 8)
        toks = [got[i][1]["choices"][0]["token_ids"] for i in range(2)]
        status, body, _ = client.post(
            {"prompt_token_ids": prompts[0].tolist(), "max_tokens": 8},
            {"X-Audit": "1"})
        audit = body["audit"]
        set_flags({"perturb_decode_token": True})
        try:
            _, bad, _ = client.post(
                {"prompt_token_ids": prompts[1].tolist(), "max_tokens": 8},
                {"X-Audit": "1"})
        finally:
            set_flags({"perturb_decode_token": False})
    finally:
        srv.close()
    bundle = eng.sentinel.divergence_bundles()[-1]
    report = sentinel.replay_bundle(bundle, gpu)
    log(f"phase 24 wiring, 2 layers of Llama-3-8B, f32: HTTP {toks}, CPU "
        f"{want}, card generate {solo}; X-Audit: {audit['verdict']} (drift "
        f"{audit['logprob_drift']}); with FLAGS_perturb_decode_token: "
        f"{bad['audit']['verdict']} at {bad['audit']['first_divergence']}, "
        f"replay blames {report['blame']} (reference reproduced "
        f"{report['ref_reproduced']}, divergence reproduced "
        f"{report['diverged_reproduced']})")
    if toks != want or toks != solo:
        raise AssertionError("phase 24 wiring: HTTP, CPU and generate tokens "
                             "differ")
    if audit["verdict"] != "pass":
        raise AssertionError(f"phase 24 wiring: the f32 audit {audit}")
    if (bad["audit"]["verdict"] != "diverged"
            or report["blame"] != ["perturb_token"]
            or not report["ref_reproduced"]
            or not report["diverged_reproduced"]):
        raise AssertionError(f"phase 24 wiring: the drill {bad['audit']}, "
                             f"replay {report['blame']}")
    del gpu, cpu, eng
    torch.cuda.empty_cache()


def engine_step_walls(card, steps=64, eager_steps=16):
    """``--engine-step-only``: the engine's one-token decode step wall on a
    Llama-3-8B (bf16, 32 layers, seed 0), 8 slots of 512-token prompts,
    ``max_len`` 2048, observability off (the engine's default): the
    graphed step (median and quartiles of ``steps``) and the eager one
    (``eager_steps``). It uses only the engine's public API, so an earlier
    checkout runs it too (this script copied to its root): the parent
    against the change in turns, on one card."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    model = LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    rng = np.random.RandomState(24)
    prompts = [rng.randint(0, model.config.vocab_size, size=HTTP_PROMPT)
               for _ in range(HTTP_SLOTS)]
    eng = ContinuousBatchEngine(model, max_batch=HTTP_SLOTS,
                                max_len=HTTP_MAX_LEN, page_size=16)

    def walls(n):
        for p in prompts:
            eng.add_request(p, max_new_tokens=n + 2)
        eng.step()
        w = []
        for _ in range(n):
            t0 = time.perf_counter()
            eng.step()
            w.append((time.perf_counter() - t0) * 1e3)
        eng.run_until_done()
        return w

    walls(8)                    # the captures
    graph = walls(steps)
    with eager_units():
        walls(2)
        eager = walls(eager_steps)
    q = {k: [round(x, 3) for x in statistics.quantiles(w, n=4)]
         for k, w in (("graphed", graph), ("eager", eager))}
    log(f"engine step [{card}] at {HTTP_SLOTS} slots x {HTTP_PROMPT}, "
        f"observability off: graphed ms (quartiles) {q['graphed']}, eager "
        f"ms {q['eager']}")


def http_only():
    """``--http-only``: phase 24 on a Llama-3-8B built as phase 23 builds
    it (same seed)."""
    import torch

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    return http_phase(model, card_line())


def engine_only():
    """``--engine-only``: phase 22 on models built here, as phases 3 and 10
    build them (same seeds), then its f32 wiring."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    card = card_line()
    model = LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    engine_llama(model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = DeepseekV2ForCausalLM(
        deepseek_config(), device="cuda",
        generator=torch.Generator("cuda").manual_seed(11))
    engine_latent(model, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    engine_wiring_check()


# --------------------------------------------------------------- phase 25 --

# Gemma2-9B's depth in phase 25 (42 published): the capped attention takes
# no kernel, so depth only repeats the trunk's kernels and the plain routes
GEMMA2_DEPTH = 8
# the counters of every attention kernel the Gemma families could reach
ATTENTION_COUNTERS = ("append_attention", "flash_attention_bshd",
                      "paged_attention", "append_attention_256",
                      "flash_attention_256", "paged_attention_256")


def gemma_model(name, seed, **kw):
    """``name``'s model on the card (Gemma-7B: ``GemmaConfig``, Gemma2-9B:
    ``Gemma2Config``; bf16, ``kw`` on top: depth and dtype cuts), weights
    drawn from ``seed``, then the norms' w drawn N(0, 0.1) (a fresh model's
    is 0), so that the (1 + w) add has a value to add. Returns (model,
    seconds)."""
    import torch

    from paddle_tpu_torch import models

    cls = {"Gemma-7B": models.GemmaConfig,
           "Gemma2-9B": models.Gemma2Config}[name]
    cfg = cls(**dict(dict(dtype="bfloat16"), **kw))
    gen = torch.Generator("cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = (models.Gemma2ForCausalLM if name == "Gemma2-9B"
             else models.GemmaForCausalLM)(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("norm.weight"):
                p.normal_(0.0, 0.1, generator=gen)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def gemma_counts_want(cfg, steps, prefills_exact, prefills_padded,
                      fused=False):
    """Exact launches of ``steps`` decode steps and the prefills, from the
    code: Gemma (the Llama trunk at head width 256), a forward: ``rms_norm``
    L + 1 (each layer's input norm, the final norm), ``add_rms_norm`` L;
    a decode step ``paged_attention_256`` L (the engine) or
    ``append_attention_256`` L (dense), an exact prefill
    ``flash_attention_256`` L, a padded one ``append_attention_256`` L;
    with the fused tail a decode step ``fused_qkv_rope`` and
    ``fused_epilogue`` L each, ``rms_norm`` and ``add_rms_norm`` L fewer.
    Gemma2 (four (1 + w) norms a layer, capped attention): ``rms_norm``
    4 L + 1 a forward and no other kernel. ``steps`` counts decode steps
    of the engine (``paged``) or of ``generate`` (``dense``)."""
    L = cfg.num_hidden_layers
    forwards = steps + prefills_exact + prefills_padded
    want = dict.fromkeys(ATTENTION_COUNTERS + (
        "fused_qkv_rope", "fused_epilogue", "add_rms_norm"), 0)
    if cfg.attn_logit_softcapping:
        want["rms_norm"] = (4 * L + 1) * forwards
        return want
    tail = L * steps if fused else 0
    want.update(rms_norm=(L + 1) * forwards - tail,
                add_rms_norm=L * forwards - tail,
                flash_attention_256=L * prefills_exact,
                append_attention_256=L * prefills_padded,
                fused_qkv_rope=tail, fused_epilogue=tail)
    return want


def gemma_engine_run(model, card, label, prompts, news, fused):
    """An engine run (8 slots, max_len 2048, page 16) with its exact
    launch counts and the paged kernel's group (none for Gemma2's capped
    attention); the prefills' ms (each returns the request's first token:
    the time to first token on an idle engine) logged. Returns (counts,
    stats, outputs)."""
    cfg = model.config
    with _GroupSpy() as spy:
        counts, stats, _, _, outputs = serve_run(
            model, card, label, prompts, news, fused, log_prefills=True)
    steps = stats["decode_steps"]
    n_exact = sum(exact_bucket(len(p)) for p in prompts)
    want = gemma_counts_want(cfg, steps, n_exact, len(prompts) - n_exact,
                             fused)
    if not cfg.attn_logit_softcapping:
        want["paged_attention_256"] = cfg.num_hidden_layers * steps
    require_counts(label, counts, want)
    # (a replayed graph makes no wrapper call: the spy sees the captures)
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    groups = set() if cfg.attn_logit_softcapping else {group}
    if set(spy.groups) - groups:
        raise AssertionError(f"{label}: paged_attention ran at groups "
                             f"{dict(spy.groups)}, expected {groups}")
    log(f"  [{card}] {label}: launch counts exact for {steps} decode steps, "
        f"{n_exact} exact and {len(prompts) - n_exact} padded prefills: "
        f"{json.dumps({k: v for k, v in want.items() if v})}")
    return counts, stats, outputs


# phase 25's time to first token: prompt lengths (exact and padded buckets)
TTFT_LENS = (64, 512, 1000, 1024)


def warm_ttft(model, card, label, lens=TTFT_LENS, max_len=2048):
    """The engine's time to first token with its bucket's graph and dense
    buffers warm: each length of ``lens`` admitted twice into one idle
    engine (8 slots, ``max_len``), one new token each; the first admission
    of a bucket captures its prefill graph for the engine's buffers (two
    eager warm-ups and the capture), the second replays it. Both logged,
    the second the figure."""
    eng = timed_engine(model, max_batch=8, max_len=max_len, page_size=16)
    rng = np.random.RandomState(29)
    out = []
    for n in lens:
        for _ in range(2):
            eng.add_request(rng.randint(0, model.config.vocab_size, size=n),
                            max_new_tokens=1)
            eng.run_until_done()
        (_, cold), (_, warm) = eng.prefill_ms[-2:]
        out.append(f"{n} (bucket {eng._bucket(n)}): {warm:.2f} ms (first "
                   f"{cold:.2f})")
    log(f"  [{card}] {label}: time to first token, an idle engine's "
        f"admission with its bucket warm: " + "; ".join(out))


def gemma_generate_runs(model, card, label, n_new, seed):
    """``generate`` dense and paged on B 4 x 512 prompts, launch counts
    exact. Returns (counts, ids)."""
    import torch

    cfg = model.config
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT))).to(model.device)
    n = n_new - 1
    total = Counter()
    toks = {}
    for run, kw in (("dense", {}), ("paged", {"paged": True,
                                              "page_size": 16})):
        want = gemma_counts_want(cfg, n, 1, 0)
        if not cfg.attn_logit_softcapping:
            want["paged_attention_256" if kw else "append_attention_256"] = \
                L * n
        toks[run], counts, _ = generate_run(
            model, card, f"{label} {run}", ids, want, phase="phase 25",
            max_new_tokens=n_new, **kw)
        total.update(counts)
    same = int((toks["dense"] == toks["paged"]).sum())
    log(f"  [{card}] phase 25 {label}: generate dense and paged, {same}/"
        f"{toks['dense'].size} tokens equal (bf16, reported)")
    return total, ids


def serve_gemma():
    """Phase 25: Gemma-7B at its published shape, no cut (28 layers, hidden
    3072, 16 | 16 heads x 256, GeGLU 24576, vocab 256000, tied), bf16,
    random seeded weights: phase 3's ten requests through the paged engine
    (8 slots, max_len 2048) with the fused tail off, on, off, launch counts
    exact (the kernels at head width 256: ``flash_attention_256`` an exact
    prefill, ``append_attention_256`` a padded one, ``paged_attention_256``
    a decode step, L each); ``generate`` dense and paged (B 4 x 512, 32
    new), counts exact; the engine against solo ``generate``. Then
    Gemma2-9B at full width, depth 42 -> 8 (16 | 8 heads x 256, hidden
    3584, caps 50 and 30, windows of 4096 on alternate layers): three
    requests and ``generate`` dense and paged, no attention kernel (capped
    attention takes the plain routes, as in JAX), ``rms_norm`` 4 L + 1 a
    forward. Then the f32 wiring. Returns the launch counts."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    log(f"phase 25: memory allocated after releasing the earlier phases "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    total = Counter()
    model, secs = gemma_model("Gemma-7B", 25)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 25: Gemma-7B, {cfg.num_hidden_layers} layers (no cut), "
        f"bf16, {n_params / 1e9:.2f}B parameters drawn in {secs:.1f}s; "
        f"hidden {cfg.hidden_size}, {cfg.num_attention_heads} | "
        f"{cfg.num_key_value_heads} heads x {cfg.head_dim}, GeGLU "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, tied; memory "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.RandomState(25)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in SERVE_LENS]
    runs = {}
    for label, fused in (("tail off", False), ("tail on", True),
                         ("tail off again", False)):
        runs[label] = gemma_engine_run(
            model, card, f"phase 25 Gemma-7B engine, {label}", prompts,
            SERVE_NEWS, fused)
        total.update(runs[label][0])
    if len({r[1]["decode_steps"] for r in runs.values()}) != 1:
        raise AssertionError("phase 25: the engine runs took different "
                             "numbers of decode steps")
    for label in ("tail on", "tail off again"):
        same = sum(int((a == b).sum()) for a, b in
                   zip(runs["tail off"][2], runs[label][2]))
        log(f"  [{card}] phase 25 Gemma-7B: {label} against tail off, "
            f"{same}/{sum(SERVE_NEWS)} tokens equal (bf16, reported)")
    warm_ttft(model, card, "phase 25 Gemma-7B")
    g_counts, ids = gemma_generate_runs(model, card, "Gemma-7B", GEN_NEW,
                                        26)
    total.update(g_counts)
    prompts4 = list(ids.cpu().numpy())
    engine_vs_solo(model, card, "phase 25 Gemma-7B", prompts4, GEN_NEW,
                   engine_tokens(model, prompts4, GEN_NEW))
    log_units(model, card, "Gemma-7B", ("_prefill_steps",
                                        "_select_decode_steps"))
    log(f"  [{card}] phase 25 Gemma-7B: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model, secs = gemma_model("Gemma2-9B", 27, num_hidden_layers=GEMMA2_DEPTH)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 25: Gemma2-9B, depth cut 42 -> {cfg.num_hidden_layers}, "
        f"bf16, {n_params / 1e9:.2f}B parameters drawn in {secs:.1f}s; "
        f"hidden {cfg.hidden_size}, {cfg.num_attention_heads} | "
        f"{cfg.num_key_value_heads} heads x {cfg.head_dim}, soft caps "
        f"{cfg.attn_logit_softcapping} / {cfg.final_logit_softcapping}, "
        f"window {cfg.sliding_window} on layers "
        f"{[i for i, t in enumerate(cfg.layer_types) if t.startswith('sl')]}")
    rng = np.random.RandomState(27)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in FAMILY_LENS]
    counts, _, outputs = gemma_engine_run(
        model, card, "phase 25 Gemma2-9B engine", prompts,
        (FAMILY_NEW,) * len(FAMILY_LENS), False)
    total.update(counts)
    g_counts, _ = gemma_generate_runs(model, card, "Gemma2-9B", FAMILY_NEW,
                                      28)
    total.update(g_counts)
    engine_vs_solo(model, card, "phase 25 Gemma2-9B", prompts, FAMILY_NEW,
                   outputs)
    log(f"  [{card}] phase 25 Gemma2-9B: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gemma_wiring_check()
    log(f"phase 25 took {time.perf_counter() - t0:.1f}s")
    return total


def gemma_wiring_check():
    """Phase 25's f32 wiring, ``allow_tf32`` off: two layers of each family
    at full width, the same weights on the card (kernels; Gemma2 the
    plain capped routes) and on the CPU (plain versions). A 64-token
    prompt (exact: the flash route) and a 40-token one (padded) with 6
    greedy tokens: ``generate`` card = CPU (dense), paged = dense on the
    card, and the engine's tokens (2 slots) = solo ``generate``'s on the
    card; the exact prompt's prefill logits card vs CPU within 1e-3 (one
    slot); the attention kernels Gemma reaches launched, none for
    Gemma2."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, name in enumerate(("Gemma-7B", "Gemma2-9B")):
        m_gpu, _ = gemma_model(name, 70 + i, num_hidden_layers=2,
                               dtype="float32")
        m_cpu = cpu_copy(m_gpu)
        rng = np.random.RandomState(70 + i)
        prompts = [rng.randint(0, m_gpu.config.vocab_size, size=n)
                   for n in (64, 40)]
        reset_launches()
        got = {}
        for p in prompts:
            ids = torch.from_numpy(p[None])
            card = m_gpu.generate(ids.cuda(), max_new_tokens=6).cpu().numpy()
            paged = m_gpu.generate(ids.cuda(), max_new_tokens=6, paged=True,
                                   page_size=16).cpu().numpy()
            cpu = m_cpu.generate(ids, max_new_tokens=6).numpy()
            got[len(p)] = card[0].tolist()
            if not (np.array_equal(card, cpu) and np.array_equal(card,
                                                                 paged)):
                raise AssertionError(
                    f"phase 25 {name} wiring, prompt {len(p)}: card "
                    f"{card.tolist()}, paged {paged.tolist()}, CPU "
                    f"{cpu.tolist()}")
        eng = engine_tokens(m_gpu, prompts, 6, max_len=128)
        counts = dict(launches)
        # the prefill's logits of the exact prompt, one slot, card vs CPU
        # (f32 on both sides, sums in another order)
        first = []
        for m in (m_gpu, m_cpu):
            one = ContinuousBatchEngine(m, max_batch=1, max_len=128)
            one.add_request(prompts[0], max_new_tokens=1)
            first.append(one._last[0].cpu().clone())
        err = float((first[0] - first[1]).abs().max())
        if not err <= 1e-3:
            raise AssertionError(f"phase 25 {name} wiring: prefill logits "
                                 f"card vs CPU differ by {err}")
        for p, toks in zip(prompts, eng):
            if toks.tolist() != got[len(p)]:
                raise AssertionError(f"phase 25 {name} wiring: engine "
                                     f"{toks.tolist()} != solo generate "
                                     f"{got[len(p)]}")
        if m_gpu.config.attn_logit_softcapping:
            ran = {k: counts.get(k, 0) for k in ATTENTION_COUNTERS}
            if any(ran.values()):
                raise AssertionError(f"phase 25 {name} wiring: attention "
                                     f"kernels launched {ran}")
        else:
            require_launched(counts, ("flash_attention_256",
                                      "append_attention_256",
                                      "paged_attention_256"),
                             f"phase 25 {name} wiring")
        log(f"phase 25: {name} wiring, 2 layers at full width, f32: tokens "
            f"card = CPU = paged = engine {json.dumps(got)}; prefill logits "
            f"card vs CPU max abs err {err:.3e} (tolerance 1e-3, |logits| <= "
            f"{float(first[1].abs().max()):.3f}); card launches "
            f"{json.dumps(counts)}")
        del m_gpu, m_cpu
        gc.collect()
        torch.cuda.empty_cache()


def gemma_only():
    """``--gemma-only``: phase 2's rows at Gemma's widths, then phase 25."""
    import torch

    gen = torch.Generator("cuda").manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    check_width256_rows(make_record({}), randn)
    return serve_gemma()

# --------------------------------------------------------------- phase 26 --

# Gemma-2B's training run: a warm-up step and 2 timed ones (3 steps in
# all); the LocalMask row's window at 256 in phase 2; the depth of the
# FLAGS_check_nan_inf run (which keeps a copy of the parameters and the
# optimizer state a step); the weight it poisons
GEMMA_TRAIN_STEPS = 2
GEMMA_TRAIN_WINDOW = 1024
GEMMA_NAN_DEPTH = 4
GEMMA_POISONED = "llama.layers.0.mlp.up_proj.weight"
GEMMA_TRAINING_KERNELS = ("rms_norm", "add_rms_norm", "fused_rope",
                          "flash_attention_256", "flash_attention_bwd_256",
                          "adam_update")


def gemma_train_config(**kw):
    """Gemma-2B's published config (google/gemma-2b: 18 layers, hidden 2048,
    8 | 1 heads x 256, GeGLU 16384, vocab 256000, tied) with phase 5's
    recipe: bf16, the chunked fused lm-head + CE; ``kw`` on top."""
    from paddle_tpu_torch.models import GemmaConfig

    return GemmaConfig.gemma_2b(**dict(dict(
        dtype="bfloat16", fuse_linear_cross_entropy=True), **kw))


def gemma_train_counts_want(L, steps):
    """Exact launches of ``steps`` Gemma training steps at depth ``L``, from
    the code: a forward ``rms_norm`` L + 1, ``add_rms_norm`` L,
    ``fused_rope`` 2 L (q and k), ``flash_attention_256`` L; the backward
    ``flash_attention_bwd_256`` L (the norms' and RoPE's backward are the
    plain versions under autograd, as in phase 5); ``adam_update`` once (one
    group of tensors)."""
    return {"rms_norm": (L + 1) * steps, "add_rms_norm": L * steps,
            "fused_rope": 2 * L * steps, "flash_attention_256": L * steps,
            "flash_attention_bwd_256": L * steps, "adam_update": steps}


def train_gemma():
    """Phase 26: Gemma training at head width 256. (a) Gemma-2B whole (18
    layers, bf16, phase 5's recipe, sequence 4096, batch 1): 3 steps of
    ``train_step`` with exact launch counts, finite losses that fall from
    the first, step ms, tokens/s, peak memory and a profiled step's busy
    share; (b) the f32 wiring, card = CPU, at two layers of Gemma-7B's
    published widths (``gemma_train_wiring``); (c)
    ``FLAGS_check_nan_inf`` on the card (``nan_check_on_card``). Returns
    the launch counts of (a) and (b)."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 26: memory allocated after releasing the earlier phases "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cfg = gemma_train_config()
    run = train_run("phase 26 (a): training, Gemma-2B whole", cfg, TRAIN_SEQ,
                    GEMMA_TRAINING_KERNELS, 26, steps=GEMMA_TRAIN_STEPS)
    steps = 1 + GEMMA_TRAIN_STEPS
    want = gemma_train_counts_want(cfg.num_hidden_layers, steps)
    got = {k: v for k, v in run["counts"].items() if v}
    losses = run["losses"]
    log(f"  [{card_line()}] phase 26 (a): Gemma-2B, {steps} steps: losses "
        f"{losses}, {TRAIN_SEQ / (run['step_ms'] / 1e3):.1f} tokens/s; "
        f"launches {json.dumps(got)} (required exactly {json.dumps(want)})")
    if got != want:
        raise AssertionError("phase 26 (a): Gemma-2B's training launches "
                             "are not the ones the code makes")
    if not all(v < losses[0] for v in losses[1:]):
        raise AssertionError(f"phase 26 (a): the loss did not fall from the "
                             f"first: {losses}")
    counts = Counter(run["counts"])
    t1 = time.perf_counter()
    counts.update(gemma_train_wiring())
    t2 = time.perf_counter()
    nan_check_on_card()
    log(f"phase 26 took {time.perf_counter() - t0:.1f}s: (a) {t1 - t0:.1f}, "
        f"(b) {t2 - t1:.1f}, (c) {time.perf_counter() - t2:.1f}")
    return counts


def gemma_train_wiring():
    """Phase 26 (b): the f32 training wiring at two layers of Gemma-7B's and
    Gemma2-9B's published widths. Returns the card's launch counts.

    Gemma-7B: one ``train_step`` on the card and on the CPU
    (``train_wiring_check``: the CPU side takes the card's weights and
    optimizer state; loss, every gradient and every parameter held), the
    fused loss through the tied head and the (256, 256) kernels, the
    causal forward and backward L a step. One CPU step: each syncs and
    updates a 256000-row vocabulary on the host (about 15 s on the card's
    host). Its gradients are held to the CPU's within 3e-4 of each
    tensor's largest, not phase 6's 1e-4, and to the card's own plain
    route within 1e-4 (the kernels' share). At two layers its residual is
    the input embedding times sqrt(3072), so the tied head gives each
    token's own logit about 61 and the softmax sits on it; an f32 logit of
    61 summed in another order moves by about 2e-4, and the off-peak
    probabilities with it. So PyTorch's own ops part this pair's card and
    CPU gradients by about 1e-4 with no port kernel in the way, which the
    run logs. The loss and parameter tolerances are phase 6's.

    Gemma2-9B: two steps held to the card's own plain route
    (``train_plain_check``), so the second step's update from non-zero
    moments is compared too: the capped scores' plain backward (no
    attention kernel, as in JAX), the sandwich norms (4 L + 1
    ``rms_norm`` a step), ``fused_rope`` 2 L and ``adam_update`` once a
    step, and the soft-capped loss. Its CPU side (about 35 s a step on
    the card's host, for the same 256000-row vocabulary at 3584) is
    replaced by the plain route on the card; its train step is held to
    JAX's on the CPU (``tests/test_torch_gemma_train.py``)."""
    from paddle_tpu_torch import models

    L = 2
    cfg = models.GemmaConfig(num_hidden_layers=L, dtype="float32",
                             fuse_linear_cross_entropy=True)
    want = {"flash_attention_256": L, "flash_attention_bwd_256": L}
    counts = train_wiring_check("phase 26 (b): Gemma-7B training wiring",
                                cfg=cfg, seed=26, steps=1, grad_tol=3e-4)
    attention = {k: v for k, v in counts.items()
                 if v and ("attention" in k or k == "splash_hop")}
    log(f"  phase 26 (b) Gemma-7B: attention launches "
        f"{json.dumps(attention)} (required {json.dumps(want)})")
    if attention != want:
        raise AssertionError("phase 26 (b): Gemma-7B's attention launches "
                             "are not the ones the code makes")
    total = Counter(counts)
    steps = 2
    cfg = models.Gemma2Config(num_hidden_layers=L, dtype="float32")
    want = {"rms_norm": (4 * L + 1) * steps, "fused_rope": 2 * L * steps,
            "adam_update": steps}
    counts = train_plain_check("phase 26 (b): Gemma2-9B training against "
                               "the card's plain route", cfg, seed=26,
                               steps=steps)
    got = {k: v for k, v in counts.items() if v}
    log(f"  phase 26 (b) Gemma2-9B: launches {json.dumps(got)} (required "
        f"exactly {json.dumps(want)})")
    if got != want:
        raise AssertionError("phase 26 (b): Gemma2-9B's training launches "
                             "are not the ones the code makes")
    total.update(counts)
    return total


def train_plain_check(phase, cfg, seed, steps=2, seq=128, recipe=dict):
    """``steps`` train steps of f32 weights on the card, twice: with the
    port's kernels, and on a copy with every kernel the step reaches
    replaced by its plain version (``plain_kernels``, the Adam update and
    the clip's norm included), which must launch nothing. AdamW keywords
    from ``recipe()``, one call a side (a schedule is stateful; both are
    stepped after each step). Before each step the copy takes the kernels'
    side's weights and optimizer state; both take the same fresh batch.
    Each step's loss, every gradient and every parameter after it must
    agree, with phase 6's tolerances (loss 1e-5 relative, gradients 1e-4
    of each tensor's largest, parameters 2 x the step's rate with at most
    0.1% of a tensor off by > 1e-6). From the second step on the update
    starts from non-zero moments. Returns the kernels' launch counts."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.weights import model_class

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m_k = model_class(cfg)(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(
                               seed))
    m_p = copy.deepcopy(m_k)
    kw_k, kw_p = recipe(), recipe()
    (step_k, opt_k), (step_p, opt_p) = (make_train_step(m, **kw)
                                        for m, kw in ((m_k, kw_k),
                                                      (m_p, kw_p)))
    log(f"{phase}, {cfg.num_hidden_layers} layers at full width, f32, seq "
        f"{seq}, {steps} step(s) of {recipe_text(kw_k)}, a fresh batch "
        f"each; the plain side takes the kernels' side's weights and "
        f"optimizer state before each step. Tolerances: loss 1e-5 relative, "
        f"gradients 1e-4 of each tensor's largest, parameters 2 x the "
        f"step's rate, share of a tensor off by > 1e-6 1e-3")
    total = Counter()
    ok = True
    for i in range(steps):
        m_p.load_state_dict(m_k.state_dict())
        sd = opt_k.state_dict()
        sd["state"] = {name: {k: t.clone() for k, t in st.items()}
                       for name, st in sd["state"].items()}
        opt_p.set_state_dict(sd)
        batch = token_batch(cfg.vocab_size, seq, 4 + i, "cuda")
        reset_launches()
        loss_k = float(step_k(*batch))
        total.update(launches)
        reset_launches()
        with plain_kernels():
            loss_p = float(step_p(*batch))
        rate = step_schedule(kw_k)
        step_schedule(kw_p)
        stray = {k: v for k, v in launches.items() if v}
        if stray:
            raise AssertionError(f"{phase}: the plain route launched "
                                 f"{json.dumps(stray)}")
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        g_err, g_name, p_err, p_share = 0.0, "", 0.0, 0.0
        plain = dict(m_p.named_parameters())
        for name, p in m_k.named_parameters():
            q = plain[name]
            e = float((p.grad - q.grad).abs().max() / q.grad.abs().max())
            if e > g_err:
                g_err, g_name = e, name
            d = (p.detach() - q.detach()).abs()
            p_err = max(p_err, float(d.max()))
            p_share = max(p_share, float((d > 1e-6).float().mean()))
        step_ok = (loss_err <= 1e-5 and g_err <= 1e-4 and p_err <= 2 * rate
                   and p_share <= 1e-3)
        log(f"  step {i + 1}: loss kernels {loss_k} plain {loss_p} (rel err "
            f"{loss_err:.2e}); gradients max rel err {g_err:.2e} "
            f"({g_name}); parameters after it max abs err {p_err:.2e}, "
            f"largest share off by > 1e-6 {p_share:.2e}; ok={step_ok}")
        ok = ok and step_ok
    log(f"  kernels' launches {json.dumps(dict(total))}")
    if not ok:
        raise AssertionError(f"{phase}: the kernels' and the plain route's "
                             "training steps differ")
    del m_k, m_p, step_k, step_p, opt_k, opt_p
    release()
    return total


def nan_check_on_card():
    """Phase 26 (c): ``FLAGS_check_nan_inf`` on the card, Gemma-2B's widths
    at depth ``GEMMA_NAN_DEPTH``, bf16, phase 5's recipe, sequence 4096: a
    clean step under the flag passes; with one weight poisoned (NaN), and
    then with an Inf in one entry of its first moment (the loss and the
    gradients finite, the update's output not), the step raises
    ``FloatingPointError`` and every parameter and every tensor of the
    optimizer state keeps its bits, and the step count its value; with
    the weight cleaned the next step passes. Then one step's wall ms with
    the flag off and on, in turns (3 pairs), on one model and one
    optimizer."""
    import torch

    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.utils.flags import flag_overrides
    from paddle_tpu_torch.weights import model_class

    card = card_line()
    cfg = gemma_train_config(num_hidden_layers=GEMMA_NAN_DEPTH)
    model = model_class(cfg)(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(
                                 27))
    x, y = token_batch(cfg.vocab_size, TRAIN_SEQ, 1, "cuda")
    with flag_overrides({"check_nan_inf": True}):
        step_on, opt = make_train_step(model)
    step_off = train_step(model, lambda m, a, b: m(a, labels=b)[0], opt)
    log(f"phase 26 (c): FLAGS_check_nan_inf, Gemma-2B widths at depth "
        f"{cfg.num_hidden_layers}, bf16, seq {TRAIN_SEQ}; "
        f"{recipe_text({})}")
    first = float(step_on(x, y))
    w = dict(model.named_parameters())[GEMMA_POISONED]
    moment = opt._state[GEMMA_POISONED]["moment1"]
    for what, poisoned in (("a NaN weight", w),
                           ("an Inf in its first moment", moment)):
        clean = poisoned.detach().clone()
        with torch.no_grad():
            poisoned[0, 0] = float("nan" if poisoned is w else "inf")
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = {n: {k: t.clone() for k, t in st.items()}
                 for n, st in opt._state.items()}
        n_step = opt._step
        try:
            step_on(x, y)
        except FloatingPointError as e:
            log(f"  [{card}] the step with {what} raised FloatingPointError: "
                f"{e}")
        else:
            raise AssertionError(f"phase 26 (c): the step with {what} did "
                                 "not raise")
        p_differ = sum(bits_differ(p.detach(), params[n])
                       for n, p in model.named_parameters())
        s_differ = sum(bits_differ(opt._state[n][k], t)
                       for n, st in state.items() for k, t in st.items())
        same_keys = (set(opt._state) == set(state)
                     and all(set(opt._state[n]) == set(st)
                             for n, st in state.items()))
        log(f"  [{card}] after it: parameter elements whose bits differ "
            f"{p_differ}, optimizer-state elements {s_differ} (of "
            f"{sum(t.numel() for st in state.values() for t in st.values())}"
            f"), state keys the same {same_keys}, step count {opt._step} "
            f"(before {n_step})")
        if p_differ or s_differ or not same_keys or opt._step != n_step:
            raise AssertionError("phase 26 (c): the raised step committed "
                                 "something")
        del params, state
        with torch.no_grad():
            poisoned.copy_(clean)
    after = float(step_on(x, y))
    log(f"  [{card}] clean steps under the flag: loss {first:.4f} before the "
        f"poisoned one, {after:.4f} after it")
    if not (np.isfinite(first) and np.isfinite(after)):
        raise AssertionError("phase 26 (c): a clean step's loss is not "
                             "finite")
    walls = {"off": [], "on": []}
    for _ in range(3):
        for label, step in (("off", step_off), ("on", step_on)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"  [{card}] one step's wall ms, flag off / on in turns: off "
        f"{[round(v, 2) for v in walls['off']]}, on "
        f"{[round(v, 2) for v in walls['on']]}; median {med['off']:.2f} / "
        f"{med['on']:.2f} ms (the check's cost {med['on'] - med['off']:.2f} "
        f"ms: the copy, the check and one host sync)")
    del model, opt, step_on, step_off
    gc.collect()
    torch.cuda.empty_cache()


def gemma_train_only():
    """``--gemma-train-only``: phase 2's width-256 training rows, then phase
    26."""
    import torch

    gen = torch.Generator("cuda").manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    check_width256_training_rows(make_record({}), randn)
    return train_gemma()


# --------------------------------------------------------------- phase 27 --

# Phi-3-mini-128k (microsoft/Phi-3-mini-128k-instruct's config.json):
# original_max_position_embeddings 4096, max_position_embeddings 131072,
# longrope. Its 48 short and 48 long factors are not in the repository: they
# are drawn from PHI3_FACTOR_SEED, sorted, short in [1, 3) and long in
# [1, 64), the published lists' shape
PHI3_ORIG, PHI3_MAX_POS, PHI3_FACTOR_SEED = 4096, 131072, 2722
# its long-context run: generate_paged, B 1, 4200 prompt tokens (past
# original_max_position_embeddings: the long factors), 16 new
PHI3_LONG_PROMPT, PHI3_LONG_NEW = 4200, 16
# GPT-2 XL (openai-community/gpt2-xl's config.json: n_layer 48, n_embd 1600,
# n_head 25, n_positions 1024, vocab 50257); its engine serves phase 3's
# prompts that fit 1024 positions with their new tokens
GPT2_XL = dict(vocab_size=50257, hidden_size=1600, num_hidden_layers=48,
               num_attention_heads=25, max_position_embeddings=1024)
GPT2_LENS = (100, 128, 256, 300, 512, 700, 64, 33)
GPT2_MAX_LEN = 1024
# the 7-9B families of phase 27 (d), at full width, depth cut to
# DENSE_DEPTH; the two GLM-4-9B trunks share glm-4-9b's widths
DENSE_DEPTH = 4
DENSE_CUT = ("Qwen2.5-7B", "Qwen3-8B", "GLM-4-9B (GLM trunk)",
             "GLM-4-9B-0414 (GLM-4 trunk)", "OLMo2-7B")
DENSE_WIRING = ("Phi-3-mini-128k", "GPT-2 XL", "Qwen2.5-0.5B") + DENSE_CUT
# phase 27 (e) families with no CPU side: their kernels, widths and layer
# routes are Qwen2.5-7B's (Llama layers with biases, 128) and OLMo2-7B's
# (norms after attention and MLP only, 128), which keep theirs
DENSE_CARD_ONLY = ("GLM-4-9B (GLM trunk)", "GLM-4-9B-0414 (GLM-4 trunk)")
# every attention and decode-tail counter a dense family's run must account
# for (the ones it does not launch held at 0)
DENSE_COUNTERS = ATTENTION_COUNTERS + (
    "paged_attention_64", "paged_attention_96", "fused_qkv_rope",
    "fused_epilogue", "mla_decode", "flash_attention_mla",
    "flash_attention_local")
# head width -> the (exact prefill, padded prefill or dense decode, paged
# decode) counters; None where the width takes the plain route
# (``append_attention.plain_width``: Phi-3's 96, as JAX's gates)
DENSE_ROUTES = {128: ("flash_attention_bshd", "append_attention",
                      "paged_attention"),
                64: ("flash_attention_bshd", "append_attention",
                     "paged_attention_64"),
                96: (None, None, "paged_attention_96")}


def dense_config(name, **kw):
    """The published shape of each dense family (bf16), ``kw`` on top: the
    depth and dtype cuts."""
    from paddle_tpu_torch import models

    kw = dict(dict(dtype="bfloat16"), **kw)
    if name == "Phi-3-mini-128k":
        rng = np.random.RandomState(PHI3_FACTOR_SEED)
        half = 96 // 2
        scaling = {"rope_type": "longrope",
                   "short_factor": np.sort(1 + 2 * rng.rand(half)).tolist(),
                   "long_factor": np.sort(1 + 63 * rng.rand(half)).tolist(),
                   "original_max_position_embeddings": PHI3_ORIG}
        return models.Phi3Config(**dict(dict(
            rope_scaling=scaling, max_position_embeddings=PHI3_MAX_POS),
            **kw))
    if name == "GPT-2 XL":
        return models.GPT2Config(**dict(GPT2_XL, **kw))
    return {"Qwen2.5-0.5B": models.Qwen2Config.qwen25_0_5b,
            "Qwen2.5-7B": models.Qwen2Config.qwen25_7b,
            "Qwen3-8B": models.Qwen3Config.qwen3_8b,
            "GLM-4-9B (GLM trunk)": models.GlmConfig,
            "GLM-4-9B-0414 (GLM-4 trunk)": models.Glm4Config,
            "OLMo2-7B": models.Olmo2Config}[name](**kw)


def dense_model(name, seed, **kw):
    """The family's model on the card, weights drawn from ``seed``, then the
    biases a fresh model leaves at 0 drawn N(0, 0.02) (q/k/v; GPT-2's
    projections and LayerNorms), so that every path runs with a value.
    Returns (model, seconds)."""
    import torch

    from paddle_tpu_torch.weights import model_class

    cfg = dense_config(name, **kw)
    gen = torch.Generator("cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = model_class(cfg)(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("bias"):
                p.normal_(0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def dense_layers(model):
    return model.llama.h if hasattr(model.llama, "h") else model.llama.layers


def dense_counts_want(model, steps, exact, padded, paged):
    """Exact launches of ``steps`` decode steps (over the paged pool where
    ``paged``, else the dense buffer), ``exact`` unpadded prefills and
    ``padded`` ones, worked out from the code. A forward's ``rms_norm``: a
    layer's own norms (the Llama block's input norm; OLMo2's two post
    norms; GLM-4's four sandwich norms; none in GPT-2's LayerNorm block),
    two more a layer with q/k norms (Qwen3 per head, OLMo2 over the
    width), and the final norm (none in GPT-2); ``add_rms_norm`` one a
    layer in the Llama block only. Attention by head width
    (``DENSE_ROUTES``): at 128 and 64 the flash forward a layer an exact
    prefill, append attention a padded prefill or dense decode step, the
    paged kernel of the width a paged step; at 96 only the paged kernel
    (``paged_attention_96``): its prefills and dense decode take the plain
    route, as JAX. No fused tail (each family fails its gate)."""
    from paddle_tpu_torch.models.gemma2 import Gemma2DecoderLayer
    from paddle_tpu_torch.models.gpt2 import GPT2Block
    from paddle_tpu_torch.models.llama import head_dim_of
    from paddle_tpu_torch.models.olmo2 import Olmo2DecoderLayer

    cfg = model.config
    L = cfg.num_hidden_layers
    norms, adds = {Gemma2DecoderLayer: (4, 0), Olmo2DecoderLayer: (2, 0),
                   GPT2Block: (0, 0)}.get(type(dense_layers(model)[0]),
                                          (1, 1))
    if getattr(cfg, "qk_norm", False):
        norms += 2
    final = 0 if isinstance(dense_layers(model)[0], GPT2Block) else 1
    forwards = steps + exact + padded
    want = dict.fromkeys(DENSE_COUNTERS, 0)
    want.update(rms_norm=(norms * L + final) * forwards,
                add_rms_norm=adds * L * forwards)
    flash, append, paged_c = DENSE_ROUTES[head_dim_of(cfg)]
    decode = paged_c if paged else append
    for name, n in ((flash, exact), (append, padded), (decode, steps)):
        if name is not None:
            want[name] += L * n
    return want


def dense_engine_run(model, card, label, lens, news, seed, max_len=2048,
                     log_prefills=False):
    """An engine run (8 slots, page 16) with its exact launch counts and the
    paged kernel's group. Returns (counts, outputs, prompts, stats)."""
    cfg = model.config
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in lens]
    with _GroupSpy() as spy:
        counts, stats, _, _, outputs = serve_run(
            model, card, label, prompts, news, False, max_len=max_len,
            log_prefills=log_prefills)
    steps = stats["decode_steps"]
    n_exact = sum(exact_bucket(n) for n in lens)
    want = dense_counts_want(model, steps, n_exact, len(lens) - n_exact,
                             True)
    require_counts(label, counts, want)
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    if set(spy.groups) != {group}:
        raise AssertionError(f"{label}: paged_attention ran at groups "
                             f"{dict(spy.groups)}, expected {group}")
    log(f"  [{card}] {label}: launch counts exact for {steps} decode steps, "
        f"{n_exact} exact and {len(lens) - n_exact} padded prefills, the "
        f"paged kernel at group {group}: "
        f"{json.dumps({k: v for k, v in want.items() if v})}")
    return counts, outputs, prompts, stats


def dense_generate_runs(model, card, label, n_new, seed):
    """``generate`` dense and paged on B 4 x 512 prompts, launch counts
    exact. Returns (counts, prompts)."""
    import torch

    cfg = model.config
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT))).to(model.device)
    total = Counter()
    toks = {}
    for run, kw in (("dense", {}), ("paged", {"paged": True,
                                              "page_size": 16})):
        want = dense_counts_want(model, n_new - 1, 1, 0, bool(kw))
        toks[run], counts, _ = generate_run(
            model, card, f"{label} {run}", ids, want, phase="phase 27",
            max_new_tokens=n_new, **kw)
        total.update(counts)
    same = int((toks["dense"] == toks["paged"]).sum())
    log(f"  [{card}] phase 27 {label}: generate dense and paged, {same}/"
        f"{toks['dense'].size} tokens equal (bf16, reported)")
    return total, list(ids.cpu().numpy())


def dense_family_header(label, model, secs, cut):
    import torch

    from paddle_tpu_torch.models.llama import head_dim_of

    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 27: {label}, {cfg.num_hidden_layers} layers ({cut}), bf16, "
        f"{n_params / 1e9:.3f}B parameters drawn in {secs:.1f}s; hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} | "
        f"{cfg.num_key_value_heads} heads x {head_dim_of(cfg)}, vocab "
        f"{cfg.vocab_size}, layer {type(dense_layers(model)[0]).__name__}; "
        f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def release():
    """Collects what the caller let go and returns the card's cached
    blocks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def dense_phi3(card):
    """Phase 27 (a): Phi-3-mini-128k at its published shape, no cut (32
    layers, hidden 3072, 32 | 32 heads x 96, SwiGLU 8192, vocab 32064,
    untied; longrope over 4096 of 131072 positions, the factors drawn):
    phase 3's ten requests through the engine (8 slots, max_len 2048: the
    short factors), graphed, launch counts exact (a forward ``rms_norm``
    L + 1 and ``add_rms_norm`` L, no attention kernel in a prefill, a
    decode step ``paged_attention_96`` L), each prefill's ms (a bucket's
    first admission) and the decode ms a step; the time to first token
    with the bucket warm (``warm_ttft``); ``generate_paged`` at B 1 over
    a 4200-token prompt (the long factors), its table's factor list
    checked; ``generate`` dense (no attention kernel) and paged, B 4 x
    512; the engine against solo ``generate``. Returns the counts."""
    import torch

    from paddle_tpu_torch.models.llama import _longrope_params

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    label = "Phi-3-mini-128k"
    model, secs = dense_model(label, 271)
    cfg = model.config
    dense_family_header(label, model, secs, "no cut")
    total = Counter()
    counts, _, _, _ = dense_engine_run(
        model, card, f"phase 27 (a) {label} engine", SERVE_LENS, SERVE_NEWS,
        272, log_prefills=True)
    total.update(counts)
    warm_ttft(model, card, f"phase 27 (a) {label}")
    ids = torch.from_numpy(np.random.RandomState(273).randint(
        0, cfg.vocab_size, (1, PHI3_LONG_PROMPT))).cuda()
    want = dense_counts_want(model, PHI3_LONG_NEW - 1, 1, 0, True)
    _, counts, _ = generate_run(
        model, card, f"{label} generate_paged B 1, prompt "
        f"{PHI3_LONG_PROMPT}", ids, want, phase="phase 27 (a)",
        max_new_tokens=PHI3_LONG_NEW, paged=True, page_size=16)
    total.update(counts)
    # the tables each run built: the engine's at its max_len (short
    # factors), generate_paged's past 4096 (long), with the magnitude
    tables = sorted(model.llama._rope_cache)
    long_len = max(tables)
    scaling = cfg.rope_scaling
    for n in (2048, long_len):
        inv, att = _longrope_params(scaling, 96, cfg.rope_theta, n,
                                    max_position=cfg.max_position_embeddings,
                                    device="cuda")
        want_cos = torch.cos(torch.cat([inv, inv])) * att
        got = model.llama._rope_cache[n][0][1]
        if not torch.allclose(got, want_cos, rtol=0, atol=1e-6):
            raise AssertionError(f"phase 27 (a): the table at {n} is not "
                                 "built from its factor list")
    if not long_len > PHI3_ORIG:
        raise AssertionError(f"phase 27 (a): no table past {PHI3_ORIG}")
    log(f"  [{card}] phase 27 (a) {label}: rope tables built at {tables} "
        f"(short factors up to {PHI3_ORIG}, long past it), magnitude "
        f"{att:.6f}")
    g_counts, prompts4 = dense_generate_runs(model, card, label, GEN_NEW, 274)
    total.update(g_counts)
    engine_vs_solo(model, card, f"phase 27 (a) {label}", prompts4, GEN_NEW,
                   engine_tokens(model, prompts4, GEN_NEW))
    log_units(model, card, label, ("_prefill_steps", "_select_decode_steps"))
    log(f"  [{card}] phase 27 (a) {label}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; took "
        f"{time.perf_counter() - t0:.1f}s")
    del model
    release()
    return total


def dense_whole(card, label, seed, lens, news, max_len, profile=False):
    """Phase 27 (b) and (c): ``label`` whole, the engine (8 slots,
    ``max_len``) on ``lens`` with exact counts and its prefills' ms, the
    time to first token with the bucket warm, then ``generate`` dense and
    paged and the engine against solo ``generate``; with ``profile``, a
    traced decode at 8 slots of 512-token prompts (``profile_decode``).
    Returns the counts."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, secs = dense_model(label, seed)
    dense_family_header(label, model, secs, "no cut")
    total = Counter()
    counts, _, _, _ = dense_engine_run(
        model, card, f"phase 27 {label} engine", lens, news, seed + 1,
        max_len=max_len, log_prefills=True)
    total.update(counts)
    warm_ttft(model, card, f"phase 27 {label}",
              tuple(n for n in TTFT_LENS if n < max_len), max_len)
    g_counts, prompts4 = dense_generate_runs(model, card, label, GEN_NEW,
                                             seed + 2)
    total.update(g_counts)
    engine_vs_solo(model, card, f"phase 27 {label}", prompts4, GEN_NEW,
                   engine_tokens(model, prompts4, GEN_NEW, max_len=max_len))
    if profile:
        profile_decode(model, card, max_len=max_len)
    log(f"  [{card}] phase 27 {label}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; took "
        f"{time.perf_counter() - t0:.1f}s")
    del model
    release()
    return total


def dense_cut(card):
    """Phase 27 (d): ``DENSE_CUT`` at full width, depth cut to
    ``DENSE_DEPTH``: phase 20's three requests through the engine,
    ``generate`` dense and paged, counts exact, the engine against solo
    ``generate``. Returns the counts."""
    import torch

    total = Counter()
    for i, label in enumerate(DENSE_CUT):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model, secs = dense_model(label, 280 + i,
                                  num_hidden_layers=DENSE_DEPTH)
        dense_family_header(label, model, secs,
                            f"depth cut to {DENSE_DEPTH}")
        counts, outputs, prompts, _ = dense_engine_run(
            model, card, f"phase 27 (d) {label} engine", FAMILY_LENS,
            (FAMILY_NEW,) * len(FAMILY_LENS), 290 + i)
        total.update(counts)
        g_counts, _ = dense_generate_runs(model, card, label, FAMILY_NEW,
                                          300 + i)
        total.update(g_counts)
        engine_vs_solo(model, card, f"phase 27 (d) {label}", prompts,
                       FAMILY_NEW, outputs)
        log(f"  [{card}] phase 27 (d) {label}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; took "
            f"{time.perf_counter() - t0:.1f}s")
        del model
        release()
    return total


def dense_wiring():
    """Phase 27 (e), ``allow_tf32`` off: two layers of each family of
    ``DENSE_WIRING`` at full width in f32, the same weights on the card
    (kernels) and, but for ``DENSE_CARD_ONLY``, the CPU (plain versions).
    A 64-token prompt (exact) and a 40-token one (padded), 6 greedy
    tokens: ``generate`` card = CPU (dense), paged = dense on the card,
    the engine's tokens (2 slots) = solo ``generate``'s on the card; the
    exact prompt's prefill logits card vs CPU within 1e-3 (one slot); the
    family's attention kernels launched (``DENSE_ROUTES``)."""
    import torch

    from paddle_tpu_torch.models.llama import head_dim_of
    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.serving import ContinuousBatchEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for i, name in enumerate(DENSE_WIRING):
        m_gpu, _ = dense_model(name, 310 + i, num_hidden_layers=2,
                               dtype="float32")
        m_cpu = None if name in DENSE_CARD_ONLY else cpu_copy(m_gpu)
        rng = np.random.RandomState(310 + i)
        prompts = [rng.randint(0, m_gpu.config.vocab_size, size=n)
                   for n in (64, 40)]
        reset_launches()
        got = {}
        for p in prompts:
            ids = torch.from_numpy(p[None])
            card = m_gpu.generate(ids.cuda(), max_new_tokens=6).cpu().numpy()
            paged = m_gpu.generate(ids.cuda(), max_new_tokens=6, paged=True,
                                   page_size=16).cpu().numpy()
            cpu = (card if m_cpu is None else
                   m_cpu.generate(ids, max_new_tokens=6).numpy())
            got[len(p)] = card[0].tolist()
            if not (np.array_equal(card, cpu) and np.array_equal(card,
                                                                 paged)):
                raise AssertionError(
                    f"phase 27 (e) {name} wiring, prompt {len(p)}: card "
                    f"{card.tolist()}, paged {paged.tolist()}, CPU "
                    f"{cpu.tolist()}")
        eng = engine_tokens(m_gpu, prompts, 6, max_len=128)
        counts = dict(launches)
        checked = "tokens card = paged = engine, no CPU side"
        if m_cpu is not None:
            first = []
            for m in (m_gpu, m_cpu):
                one = ContinuousBatchEngine(m, max_batch=1, max_len=128)
                one.add_request(prompts[0], max_new_tokens=1)
                first.append(one._last[0].cpu().clone())
            err = float((first[0] - first[1]).abs().max())
            if not err <= 1e-3:
                raise AssertionError(f"phase 27 (e) {name} wiring: prefill "
                                     f"logits card vs CPU differ by {err}")
            checked = (f"tokens card = CPU = paged = engine; prefill logits "
                       f"card vs CPU max abs err {err:.3e} (tolerance 1e-3, "
                       f"|logits| <= {float(first[1].abs().max()):.3f})")
        for p, toks in zip(prompts, eng):
            if toks.tolist() != got[len(p)]:
                raise AssertionError(f"phase 27 (e) {name} wiring: engine "
                                     f"{toks.tolist()} != solo generate "
                                     f"{got[len(p)]}")
        require_launched(counts, [k for k in DENSE_ROUTES[head_dim_of(
            m_gpu.config)] if k], f"phase 27 (e) {name} wiring")
        log(f"phase 27 (e): {name} wiring, 2 layers at full width, f32: "
            f"{checked}; tokens {json.dumps(got)}; card launches "
            f"{json.dumps(counts)}")
        del m_gpu, m_cpu
        release()
    log(f"  phase 27 (e) took {time.perf_counter() - t0:.1f}s")


def serve_dense_families(profile=False):
    """Phase 27: the dense Llama-trunk families and GPT-2 on the card,
    (a)-(e), each sub-phase timed and its model freed; with ``profile``,
    (b) and (c) trace their decode. Returns the launch counts."""
    import torch

    t0 = time.perf_counter()
    release()
    card = card_line()
    log(f"phase 27: memory allocated after releasing the earlier phases "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    total = Counter(dense_phi3(card))
    news = tuple(16 if i % 2 == 0 else 64 for i in range(len(GPT2_LENS)))
    total.update(dense_whole(card, "GPT-2 XL", 275, GPT2_LENS, news,
                             GPT2_MAX_LEN, profile))
    total.update(dense_whole(card, "Qwen2.5-0.5B", 278, SERVE_LENS,
                             SERVE_NEWS, 2048, profile))
    total.update(dense_cut(card))
    dense_wiring()
    log(f"phase 27 took {time.perf_counter() - t0:.1f}s")
    return total


def families_only(profile=False):
    """``--families-only``: phase 2's rows at the dense families' widths,
    then phase 27."""
    check_dense_family_rows(make_record({}))
    return serve_dense_families(profile)


# --------------------------------------------------------------- phase 28 --

# deepseek-ai/DeepSeek-V3 config.json rope_scaling
V3_YARN = {"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
           "mscale": 1.0, "mscale_all_dim": 1.0,
           "original_max_position_embeddings": 4096}
# the cut: the three published dense layers and one MoE layer of 61, and
# the published MTP depth (an MoE block)
V3_DEPTH = 4
# (a): eight prompts of up to 512 tokens (exact buckets 512, 256, 128, 512
# and 64 through the width-192 flash kernel, the rest padded: the absorbed
# einsums), 32 new tokens each, 8 slots of max_len 1024
V3_LENS, V3_NEW, V3_MAX_LEN = (512, 256, 300, 128, 512, 64, 100, 448), 32, 1024
# (b): mtp_speculative_generate, batch 1
V3_MTP_PROMPT, V3_MTP_NEW = 512, 64
# (c): the f32 wiring, experts cut to 32 (n_group 8 kept), one dense and
# one MoE layer and the MTP depth; the logits' tolerance, f32 on both
# routes, sums in another order
V3_WIRING_EXPERTS, V3_WIRING_PROMPT, V3_WIRING_NEW = 32, 64, 16
V3_WIRING_TOL = 1e-3
# the draft-friendly weights of (b) and (c)'s second runs: every residual
# write (``o_proj``, the MLPs' and experts' down projections) and
# ``eh_proj``'s hidden half scaled by this, its embedding half the identity
V3_DRAFT_SCALE = 1e-3
RESIDUAL_WRITES = ("o_proj.weight", "down_proj.weight", "experts.w2",
                   "experts.b2")


def deepseek_v3_config(**kw):
    """DeepSeek-V3 as published (deepseek-ai/DeepSeek-V3 config.json): no
    preset in the JAX package, so built from its fields. The router's
    capacity factor is the experts over the experts a token (256 / 8 =
    32), where the capacity is the token count: the published model drops
    no route, and at the JAX default of 2.0 the capacity at one decode row
    is 1, so MTP's 2-token verify would drop routes that one-token decode
    keeps."""
    from paddle_tpu_torch.models import DeepseekV2Config

    base = dict(vocab_size=129280, hidden_size=7168, intermediate_size=18432,
                num_hidden_layers=61, num_attention_heads=128,
                num_key_value_heads=128, max_position_embeddings=163840,
                rms_norm_eps=1e-6, rope_theta=10000.0, rope_scaling=V3_YARN,
                tie_word_embeddings=False, n_routed_experts=256,
                n_shared_experts=1, num_experts_per_tok=8,
                moe_intermediate_size=2048, first_k_dense_replace=3,
                norm_topk_prob=True, routed_scaling_factor=2.5,
                moe_scoring_func="sigmoid", moe_correction_bias=True,
                n_group=8, topk_group=4, router_aux_loss_coef=0.001,
                q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128,
                num_nextn_predict_layers=1, dtype="bfloat16")
    base.update(kw)
    base.setdefault("moe_capacity_factor",
                    base["n_routed_experts"] / base["num_experts_per_tok"])
    return DeepseekV2Config(**base)


def v3_parameters(cfg) -> dict:
    """The parameter count of a V3 config, by part, from the modules' code
    (``DeepseekV2Attention``, ``LlamaMLP``, ``MoEMLP`` with its grouped
    experts' biases and the correction bias, ``DeepseekMTPLayer``)."""
    h, H, V = cfg.hidden_size, cfg.num_attention_heads, cfg.vocab_size
    ql, r = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    E, Im = cfg.n_routed_experts, cfg.moe_intermediate_size
    attn = (h * ql + ql + ql * H * (dn + dr) + h * (r + dr) + r
            + r * H * (dn + dv) + H * dv * h + 2 * h)
    dense = attn + 3 * h * cfg.intermediate_size
    moe = (attn + h * E + E + E * (h * 2 * Im + 2 * Im + Im * h + h)
           + 3 * h * Im * cfg.n_shared_experts)
    L, k = cfg.num_hidden_layers, cfg.first_k_dense_replace
    D = cfg.num_nextn_predict_layers
    return {"embedding and head": 2 * V * h + h,
            "dense layers": min(k, L) * dense,
            "MoE layers": max(L - k, 0) * moe,
            "MTP depths": D * (moe + 2 * h * h + 3 * h)}


def v3_model(cfg, seed, phase):
    """The V3 model of ``cfg`` on the card, its weights drawn there from
    ``seed``; its parameter count must equal ``v3_parameters``' (logged by
    part, with the time and the memory)."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM

    parts = v3_parameters(cfg)
    t0 = time.perf_counter()
    model = DeepseekV2ForCausalLM(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(
            seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"{phase}: {n / 1e9:.3f}B parameters ({cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.1f}s, worked out from the code before "
        f"the run: " + ", ".join(f"{k} {v / 1e9:.3f}B"
                                 for k, v in parts.items())
        + f"; memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB")
    if n != sum(parts.values()):
        raise AssertionError(f"{phase}: {n} parameters, the code gives "
                             f"{sum(parts.values())}")
    return model


def v3_counts_want(L, forwards, exact, steps, norms=3):
    """A V3 trunk's launches, from the code: a forward's ``rms_norm`` 3 L + 1
    (each layer's input norm, ``q_a_layernorm`` at 1536, ``kv_a_layernorm``
    at 512, then the final norm; ``norms`` 2 for V2-Lite's full-rank q) and
    ``add_rms_norm`` L (each post-attention norm); ``flash_attention_mla`` L
    an exact prefill, ``mla_decode`` L a decode step; no other attention
    kernel."""
    return {"rms_norm": (norms * L + 1) * forwards, "add_rms_norm": L * forwards,
            "flash_attention_mla": L * exact, "mla_decode": L * steps,
            "flash_attention_bshd": 0, "append_attention": 0,
            "paged_attention": 0, "fused_qkv_rope": 0, "fused_epilogue": 0}


def v3_engine(model, card):
    """Phase 28 (a): the latent engine (8 slots, ``max_len`` 1024) on
    ``V3_LENS`` x ``V3_NEW``, graphed, launches exact; each prefill's ms
    and the decode ms a step; the time to first token with a bucket warm
    and at its first admission; the engine against solo ``generate``
    (the first token of every exact-bucket prompt equal). Returns the
    counts."""
    import torch

    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(28)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in V3_LENS]
    news = [V3_NEW] * len(prompts)
    label = "phase 28 (a) DeepSeek-V3"
    counts, stats, _, _, outputs = serve_run(
        model, card, label, prompts, news, False, log_prefills=True,
        max_batch=8, max_len=V3_MAX_LEN)
    steps = stats["decode_steps"]
    n_exact = sum(1 for n in V3_LENS if exact_bucket(n))
    require_counts(label, counts,
                   v3_counts_want(L, len(prompts) + steps, n_exact, steps))
    log(f"  [{card}] {label}: launches exact ({steps} decode steps, "
        f"{len(prompts)} prefills, {n_exact} of them exact)")
    warm_ttft(model, card, label, lens=(64, 512), max_len=V3_MAX_LEN)
    engine_vs_solo(model, card, label, prompts, V3_NEW, outputs)
    log(f"  [{card}] {label}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return Counter(counts)


def mtp_rounds(model, n):
    """Replays so far of ``model``'s MTP round units of ``n`` pairs."""
    return sum(u.replays for key, u in model.__dict__.get(
        "_mtp_round_steps", {}).items() if key[0][1] == n)


def mtp_run(model, ids, n_new, want_counts=True):
    """One ``mtp_speculative_generate`` call of the main path: launches
    zeroed just before and read just after, each round's units counted.
    With ``want_counts`` its launches must be, from the code: the main
    prefill ``flash_attention_mla`` L, the MTP seed 1 more; ``mla_decode``
    1 for each round that starts from one pair (the MTP block at S = 1)
    and none in the 2-token verify or a round of two pairs (the absorbed
    einsums); ``rms_norm`` 3 L + 1 + 5 for the prefill (the seed: ``hnorm``,
    ``enorm`` and the block's three) and 3 L + 1 + 6 a round (and
    ``norm``); ``add_rms_norm`` L + 1 each. Returns (tokens [1, n] numpy,
    stats, counts, wall ms, rounds of one pair)."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.speculative import mtp_speculative_generate

    L = model.config.num_hidden_layers
    one = mtp_rounds(model, 1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, stats = mtp_speculative_generate(model, ids, max_new_tokens=n_new,
                                          return_stats=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = dict(launches)
    one = mtp_rounds(model, 1) - one
    R = stats["rounds"]
    want = {"flash_attention_mla": L + 1, "mla_decode": one,
            "rms_norm": 3 * L + 6 + (3 * L + 7) * R,
            "add_rms_norm": (L + 1) * (R + 1), "flash_attention_bshd": 0,
            "append_attention": 0, "paged_attention": 0}
    if want_counts:
        require_counts("mtp_speculative_generate", counts, want)
    return out.cpu().numpy(), stats, counts, wall, one


def draft_friendly_(model):
    """Rewrite ``model``'s weights in place so that its MTP draft names the
    main model's next token: every residual write scaled by
    ``V3_DRAFT_SCALE`` (each hidden state stays near its token's
    embedding), ``eh_proj``'s hidden half scaled alike and its embedding
    half the identity (the draft reads the next embedding). Random weights
    give a draft that almost never hits, so a round of two pairs (a hit's
    successor: the MTP block's absorbed einsums at S = 2) would not run;
    these weights make hits the rule, misses still possible."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(RESIDUAL_WRITES):
                p.mul_(V3_DRAFT_SCALE)
        for layer in model.mtp_layers:
            w = layer.eh_proj.weight
            h = w.shape[1]
            w[:h].mul_(V3_DRAFT_SCALE)
            w[h:].copy_(torch.eye(h, dtype=w.dtype, device=w.device))


def v3_mtp(model, card):
    """Phase 28 (b): ``mtp_speculative_generate`` at batch 1 on a
    ``V3_MTP_PROMPT``-token prompt, ``V3_MTP_NEW`` new tokens: a first call
    captures its units, the second is timed and counted (``mtp_run``);
    its ms a round beside the prefill's (a call of one new token, no
    round); its tokens against greedy ``generate``'s on the card. In bf16
    the 2-token verify runs the absorbed einsums where one-token decode
    runs the kernel, so the first divergent position and the top-2 logit
    gap there are reported, not required; (c) holds the identity in f32.
    Returns the timed call's counts."""
    import torch

    label = "phase 28 (b) DeepSeek-V3 mtp_speculative_generate"
    ids = torch.from_numpy(np.random.RandomState(281).randint(
        0, model.config.vocab_size, (1, V3_MTP_PROMPT))).to(model.device)
    mtp_run(model, ids, 1)                  # the prefill's unit, captured
    _, _, _, pre_ms, _ = mtp_run(model, ids, 1)
    mtp_run(model, ids, V3_MTP_NEW)         # the rounds' units, captured
    torch.cuda.reset_peak_memory_stats()
    got, stats, counts, wall, one = mtp_run(model, ids, V3_MTP_NEW)
    R = stats["rounds"]
    log(f"  [{card}] {label}: {V3_MTP_NEW} new tokens in {R} rounds, "
        f"{stats['hits']} hits, acceptance {stats['acceptance']:.4f} (random "
        f"weights: this says nothing of a trained draft's quality); the call "
        f"{wall:.2f} ms, its prefill {pre_ms:.2f} ms, "
        f"{(wall - pre_ms) / R:.3f} ms a round; mla_decode {one} (= the "
        f"rounds from one pair); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches ({label}): {json.dumps(counts)}")
    want = model.generate(ids, max_new_tokens=V3_MTP_NEW).cpu().numpy()
    diff = np.nonzero(got[0] != want[0])[0]
    if diff.size == 0:
        log(f"  [{card}] {label}: tokens = greedy generate's, all "
            f"{V3_MTP_NEW}")
    else:
        k = int(diff[0])
        ctx = torch.cat([ids, torch.from_numpy(want[:, :k]).to(ids)], 1)
        with torch.no_grad():
            top = torch.topk(model(ctx)[0, -1].float(), 2).values
        log(f"  [{card}] {label}: tokens = greedy generate's up to position "
            f"{k} of {V3_MTP_NEW} (bf16: the verify's einsums against the "
            f"decode kernel); there the top-2 logits of generate's context "
            f"are {float(top[0]):.4f} and {float(top[1]):.4f}, gap "
            f"{float(top[0] - top[1]):.4f}")
    # the draft-friendly weights (``draft_friendly_``): hit rounds, and the
    # rounds of two pairs after them, at full width
    draft_friendly_(model)
    mtp_run(model, ids, V3_MTP_NEW)         # a new path's units, captured
    got, stats, counts_h, wall, one = mtp_run(model, ids, V3_MTP_NEW)
    R = stats["rounds"]
    same = np.array_equal(got, model.generate(
        ids, max_new_tokens=V3_MTP_NEW).cpu().numpy())
    log(f"  [{card}] {label}, draft-friendly weights: {R} rounds, "
        f"{stats['hits']} hits, acceptance {stats['acceptance']:.4f}; the "
        f"call {wall:.2f} ms, {(wall - pre_ms) / R:.3f} ms a round (the "
        f"prefill's {pre_ms:.2f} ms taken off); {R - one} rounds of two "
        f"pairs, mla_decode {one}; tokens = greedy generate's: {same}")
    log(f"  launches ({label}, draft-friendly): {json.dumps(counts_h)}")
    if stats["hits"] == 0:
        raise AssertionError(f"{label}: no draft hit with the draft-friendly "
                             "weights")
    counts = Counter(counts)
    counts.update(counts_h)
    return counts


def v3_wiring():
    """Phase 28 (c): the f32 wiring at V3's widths with the experts cut to
    ``V3_WIRING_EXPERTS`` (n_group 8 kept: 4 experts a group, top-4 groups,
    8 experts a token) and the depth to one dense layer, one MoE layer and
    the MTP depth. The card's kernel route against its own plain route
    (``plain_kernels``, the units eager, no launch): the logits of a
    ``V3_WIRING_PROMPT``-token forward within ``V3_WIRING_TOL``, and the
    greedy tokens of ``generate`` and ``mtp_speculative_generate`` all
    identical; the kernel route's ``mtp_speculative_generate`` launches
    exact (``mtp_run``)."""
    import torch

    from paddle_tpu_torch.ops.hopper import launches, reset_launches
    from paddle_tpu_torch.speculative import mtp_speculative_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "phase 28 (c) DeepSeek-V3 f32 wiring"
    cfg = deepseek_v3_config(num_hidden_layers=2, first_k_dense_replace=1,
                             n_routed_experts=V3_WIRING_EXPERTS,
                             dtype="float32")
    model = v3_model(cfg, 283, phase)
    ids = torch.from_numpy(np.random.RandomState(282).randint(
        0, cfg.vocab_size, (1, V3_WIRING_PROMPT))).to(model.device)
    with torch.no_grad():
        logits = model(ids)
    gen = model.generate(ids, max_new_tokens=V3_WIRING_NEW).cpu().numpy()
    mtp, stats, counts, _, one = mtp_run(model, ids, V3_WIRING_NEW)
    reset_launches()
    with eager_units(), plain_kernels(), torch.no_grad():
        logits_p = model(ids)
        gen_p = model.generate(ids, max_new_tokens=V3_WIRING_NEW)
        mtp_p = mtp_speculative_generate(model, ids,
                                         max_new_tokens=V3_WIRING_NEW)
    stray = {k: v for k, v in launches.items() if v}
    err = float((logits - logits_p).abs().max())
    same = [np.array_equal(a, b) for a, b in (
        (mtp, gen), (gen_p.cpu().numpy(), gen), (mtp_p.cpu().numpy(), gen))]
    log(f"  {phase}: logits kernels vs plain max abs err {err:.3e} "
        f"(tolerance {V3_WIRING_TOL}, |logits| <= "
        f"{float(logits_p.abs().max()):.3f}); tokens {gen[0].tolist()}; "
        f"mtp = generate {same[0]}, plain generate = generate {same[1]}, "
        f"plain mtp = generate {same[2]}; mtp {stats}, mla_decode {one} "
        f"(= its rounds from one pair); the plain route launched "
        f"{json.dumps(stray)}")
    if stray:
        raise AssertionError(f"{phase}: the plain route launched {stray}")
    if not err <= V3_WIRING_TOL:
        raise AssertionError(f"{phase}: logits differ beyond the tolerance")
    if not all(same):
        raise AssertionError(f"{phase}: greedy tokens differ")
    # the draft-friendly weights: hit rounds and rounds of two pairs
    draft_friendly_(model)
    gen = model.generate(ids, max_new_tokens=V3_WIRING_NEW).cpu().numpy()
    mtp, stats, _, _, one = mtp_run(model, ids, V3_WIRING_NEW)
    with eager_units(), plain_kernels(), torch.no_grad():
        mtp_p = mtp_speculative_generate(model, ids,
                                         max_new_tokens=V3_WIRING_NEW)
    same = [np.array_equal(mtp, gen),
            np.array_equal(mtp_p.cpu().numpy(), gen)]
    log(f"  {phase}, draft-friendly weights: mtp {stats}, "
        f"{stats['rounds'] - one} rounds of two pairs; mtp = generate "
        f"{same[0]}, plain mtp = generate {same[1]}")
    if stats["hits"] == 0 or not all(same):
        raise AssertionError(f"{phase}: the draft-friendly run had no hit "
                             "or its tokens differ")
    del model, logits, logits_p
    release()


def serve_deepseek_v3():
    """Phase 28: DeepSeek-V3 at its published widths, depth cut to
    ``V3_DEPTH`` plus the MTP depth, bf16, random weights drawn on the card
    (``v3_model``): (a) the latent engine, (b) ``mtp_speculative_generate``,
    then the model is freed and (c) the f32 wiring runs. Returns the launch
    counts of (a) and (b)."""
    import torch

    t0 = time.perf_counter()
    card = card_line()
    cfg = deepseek_v3_config(num_hidden_layers=V3_DEPTH)
    log(f"phase 28: DeepSeek-V3 (deepseek-ai/DeepSeek-V3 config.json): "
        f"hidden {cfg.hidden_size}, {cfg.num_attention_heads} heads, q LoRA "
        f"{cfg.q_lora_rank}, kv LoRA {cfg.kv_lora_rank}, qk "
        f"{cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, v "
        f"{cfg.v_head_dim}, {cfg.n_routed_experts} experts of "
        f"{cfg.moe_intermediate_size} top-{cfg.num_experts_per_tok} in "
        f"{cfg.n_group} groups (top-{cfg.topk_group}), sigmoid scores, "
        f"the correction bias, scaling {cfg.routed_scaling_factor}, yarn "
        f"factor 40; cuts: depth 61 -> {V3_DEPTH} (the 3 dense layers and 1 "
        f"MoE layer) + {cfg.num_nextn_predict_layers} MTP depth; "
        f"moe_capacity_factor {cfg.moe_capacity_factor:g} (the capacity is "
        f"the token count; the published model drops no route)")
    model = v3_model(cfg, 28, "phase 28")
    counts = v3_engine(model, card)
    counts.update(v3_mtp(model, card))
    del model
    release()
    v3_wiring()
    log(f"phase 28 took {time.perf_counter() - t0:.1f}s")
    return counts


def deepseek_v3_only():
    """``--deepseek-v3-only``: phase 2's MLA rows at 128 and 24 heads and
    the width-192 flash forward at 128 heads, then phase 28."""
    record = make_record({})
    check_mla_head_rows(record)
    check_mla_edges()
    check_flash_mla_128_row(record)
    serve_deepseek_v3()



# --------------------------------------------------------------- phase 29 --

# the fields of meta-llama/Meta-Llama-3-8B's config.json
LLAMA3_8B_JSON = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 8192, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "pretraining_tp": 1, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 500000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 128256}
# the fields of microsoft/Phi-3-mini-128k-instruct's config.json, but its
# 48 + 48 longrope factors: the published lists are not in the repository,
# so they are phase 27's, drawn from PHI3_FACTOR_SEED (phi3_json)
PHI3_128K_JSON = {
    "architectures": ["Phi3ForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "embd_pdrop": 0.0, "eos_token_id": 32000,
    "hidden_act": "silu", "hidden_size": 3072, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 131072,
    "model_type": "phi3", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 32,
    "original_max_position_embeddings": 4096, "pad_token_id": 32000,
    "resid_pdrop": 0.0, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "sliding_window": 262144, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32064}
# the fields of deepseek-ai/DeepSeek-V2-Lite's config.json
V2_LITE_JSON = {
    "architectures": ["DeepseekV2ForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "aux_loss_alpha": 0.001,
    "bos_token_id": 100000, "eos_token_id": 100001,
    "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16,
    "pretraining_tp": 1, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": dict(V2_LITE_YARN), "rope_theta": 10000,
    "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
    "topk_method": "greedy", "torch_dtype": "bfloat16", "use_cache": True,
    "v_head_dim": 128, "vocab_size": 102400}
# (c): DeepSeek-V2-Lite's depth cut 27 -> 4 (its dense layer, three MoE)
HF_V2_LITE_DEPTH = 4


def phi3_json(scaling):
    """PHI3_128K_JSON with the longrope lists of ``scaling`` under the
    published keys ("type", the lists; the original length top-level)."""
    return dict(PHI3_128K_JSON, rope_scaling={
        "type": "longrope", "short_factor": list(scaling["short_factor"]),
        "long_factor": list(scaling["long_factor"])})


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class _RssPeak:
    """The process's resident set read every 2 ms (``/proc/self/statm``,
    read only) by a thread over a ``with`` block: ``start`` and ``peak``."""

    def __enter__(self):
        import threading

        self.start = self.peak = rss_bytes()
        self._stop = threading.Event()

        def watch():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, rss_bytes())

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def to_host(state) -> dict:
    """Each tensor of an HF-layout state made contiguous on the card, then
    copied to the host, as a checkpoint would arrive there."""
    return {k: v.contiguous().cpu() for k, v in state.items()}


class FakeHF:
    """A state dict with its ``config.json`` dict, as
    ``deepseek_from_hf`` takes a transformers model."""

    def __init__(self, state, config):
        self._state, self.config = state, config

    def state_dict(self):
        return self._state


def bridge_load(label, card, load):
    """``load()`` (a ``*_from_hf`` onto the card) with the device's peak
    and the host's resident set watched: the seconds, the model's bytes
    over them (host -> device GB/s; the model's construction included),
    the peak device memory above what was allocated before (collected
    first), against the model's bytes, and the host's peak RSS against
    its value before.
    Returns the model."""
    import torch

    release()   # what an earlier run left for the collector goes first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        model = load()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    n = param_bytes(model)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  [{card}] {label}: loaded in {secs:.3f}s, {n / 1e9:.3f} GB "
        f"({n / 1e9 / secs:.2f} GB/s host -> device); peak device memory "
        f"{peak / 2**30:.3f} GiB for the model's {n / 2**30:.3f} GiB "
        f"(x{peak / n:.4f}); host RSS {rss.start / 2**30:.2f} GiB before, "
        f"peak {rss.peak / 2**30:.2f} GiB (+{(rss.peak - rss.start) / 2**30:.3f})")
    return model


def same_bits(a, b) -> bool:
    """Bit equality of two tensors on one device, strides aside."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(torch.equal(a.view(view), b.view(view)))


def require_params_equal(label, model, want):
    """Every parameter of ``model`` bit-equal to ``want(name)`` (a tensor on
    the card), one tensor at a time."""
    n = 0
    for name, p in model.named_parameters():
        if not same_bits(p.detach(), want(name)):
            raise AssertionError(f"{label}: {name} differs from its source")
        n += p.numel()
    return n


def require_tokens_equal(label, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: request {i} tokens {list(a)} != "
                                 f"the source model's {list(b)}")


def hf_bridge_llama(card):
    """Phase 29 (a): Llama-3-8B whole, bf16, weights drawn on the card: the
    source's engine tokens on phase 20's three requests (graphed, counts
    exact), ``llama_to_hf`` to the host, the source freed,
    ``llama_from_hf(state, LLAMA3_8B_JSON)`` onto the card (its config =
    ``LlamaConfig.llama3_8b``), every parameter bit-equal to the state's
    tensor (moved to the card one at a time), the same requests with the
    same tokens and exact counts. Returns the counts."""
    import torch

    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               llama_from_hf, llama_to_hf)

    label = "phase 29 (a) Llama-3-8B"
    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    src = LlamaForCausalLM(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(290))
    news = (FAMILY_NEW,) * len(FAMILY_LENS)
    total = Counter()
    counts, want, _, _ = serve_family(src, card, f"{label} source",
                                      FAMILY_LENS, news, 291)
    total.update(counts)
    torch.cuda.synchronize()
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        state = llama_to_hf(src)
        secs = time.perf_counter() - t0
    n = param_bytes(src)
    log(f"  [{card}] {label}: llama_to_hf to the host in {secs:.3f}s, "
        f"{len(state)} tensors, {n / 1e9:.3f} GB ({n / 1e9 / secs:.2f} GB/s "
        f"device -> host); host RSS +{(rss.peak - rss.start) / 2**30:.2f} "
        "GiB")
    del src
    release()
    model = bridge_load(f"{label} llama_from_hf", card,
                        lambda: llama_from_hf(state, LLAMA3_8B_JSON))
    if dataclasses.asdict(model.config) != dataclasses.asdict(cfg):
        raise AssertionError(f"{label}: the converted config differs from "
                             "LlamaConfig.llama3_8b")
    t0 = time.perf_counter()

    def hf_tensor(name):
        key = name if name == "lm_head.weight" else name.replace(
            "llama.", "model.", 1)
        t = state[key].cuda()
        return t.t() if t.ndim == 2 and "embed_tokens" not in key else t

    n = require_params_equal(label, model, hf_tensor)
    log(f"  [{card}] {label}: every parameter ({n / 1e9:.3f}B) bit-equal to "
        f"its checkpoint tensor, checked on the card in "
        f"{time.perf_counter() - t0:.2f}s; the converted config = "
        "LlamaConfig.llama3_8b")
    del state
    counts, got, _, _ = serve_family(model, card, f"{label} loaded",
                                     FAMILY_LENS, news, 291)
    require_tokens_equal(label, got, want)
    total.update(counts)
    log(f"  [{card}] {label}: tokens of the converted model = the "
        f"source's on all {len(got)} requests")
    del model
    release()
    return total


def phi3_checkpoint(model) -> dict:
    """Phi-3's HF layout of ``model``, as test code (the inverse of
    ``split_phi3_fused``): q | k | v rows into ``qkv_proj``, gate | up
    into ``gate_up_proj``, every projection in torch's [out, in]; on the
    host."""
    import torch

    with torch.no_grad():
        return to_host(_phi3_layout(model))


def _phi3_layout(model) -> dict:
    import torch

    m = model.llama
    state = {"model.embed_tokens.weight": m.embed_tokens.weight,
             "model.norm.weight": m.norm.weight,
             "lm_head.weight": model.lm_head.weight.t()}
    for i, layer in enumerate(m.layers):
        a, mlp, p = layer.self_attn, layer.mlp, f"model.layers.{i}"
        state[f"{p}.self_attn.qkv_proj.weight"] = torch.cat(
            [a.q_proj.weight.t(), a.k_proj.weight.t(), a.v_proj.weight.t()])
        state[f"{p}.self_attn.o_proj.weight"] = a.o_proj.weight.t()
        state[f"{p}.mlp.gate_up_proj.weight"] = torch.cat(
            [mlp.gate_proj.weight.t(), mlp.up_proj.weight.t()])
        state[f"{p}.mlp.down_proj.weight"] = mlp.down_proj.weight.t()
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{p}.{norm}.weight"] = getattr(layer, norm).weight
    return state


def hf_bridge_phi3(card):
    """Phase 29 (b): Phi-3-mini-128k whole (phase 27's shape and factors):
    the source's engine tokens on phase 20's three requests, its fused HF
    layout built here and moved to the host, ``phi3_from_hf`` onto the
    card, every parameter bit-equal to the source's, the same tokens,
    ``paged_attention_96`` L a decode step and no attention kernel in a
    prefill. Returns the counts."""
    from paddle_tpu_torch.models.phi3 import phi3_from_hf

    label = "phase 29 (b) Phi-3-mini-128k"
    src, _ = dense_model("Phi-3-mini-128k", 292)
    news = (FAMILY_NEW,) * len(FAMILY_LENS)
    total = Counter()
    counts, want, _, _ = dense_engine_run(src, card, f"{label} source",
                                          FAMILY_LENS, news, 293)
    total.update(counts)
    state = phi3_checkpoint(src)
    model = bridge_load(
        f"{label} phi3_from_hf", card,
        lambda: phi3_from_hf(state, phi3_json(src.config.rope_scaling)))
    cfg = model.config
    if (cfg.rope_scaling["long_factor"]
            != src.config.rope_scaling["long_factor"]
            or cfg.rope_scaling["original_max_position_embeddings"]
            != PHI3_ORIG or cfg.max_position_embeddings != PHI3_MAX_POS):
        raise AssertionError(f"{label}: the longrope scaling did not map")
    src_params = dict(src.named_parameters())
    n = require_params_equal(label, model, lambda k: src_params[k].detach())
    log(f"  [{card}] {label}: every parameter ({n / 1e9:.3f}B) bit-equal to "
        f"the source's; sliding_window {cfg.sliding_window} (the published "
        "field, wider than every cache here: the routes of the source)")
    del src, src_params, state
    release()
    counts, got, _, _ = dense_engine_run(model, card, f"{label} loaded",
                                         FAMILY_LENS, news, 293)
    require_tokens_equal(label, got, want)
    total.update(counts)
    log(f"  [{card}] {label}: tokens of the converted model = the "
        f"source's on all {len(got)} requests")
    del model
    release()
    return total


def interleave_rows(w, dim):
    """The inverse of ``deinterleave_rows``: the trailing ``dim`` rows from
    the half-split layout back to interleaved pairs."""
    import torch

    head, tail = w[:-dim], w[-dim:]
    pairs = torch.stack([tail[:dim // 2], tail[dim // 2:]], dim=1)
    return torch.cat([head, pairs.reshape(dim, -1)])


def interleave_q(w, n_heads, nope_dim, rope_dim):
    """The inverse of ``deinterleave_q``, head by head."""
    import torch

    w = w.reshape(n_heads, nope_dim + rope_dim, -1)
    half = nope_dim + rope_dim // 2
    pe = torch.stack([w[:, nope_dim:half], w[:, half:]], dim=2)
    return torch.cat([w[:, :nope_dim], pe.reshape(n_heads, rope_dim, -1)],
                     dim=1).reshape(n_heads * (nope_dim + rope_dim), -1)


def deepseek_checkpoint(model) -> dict:
    """DeepSeek-V2's HF layout of ``model``, as test code: q_pe rows and
    the k_pe tail interleaved again, the grouped experts split back into
    per-expert gate / up / down, every projection in [out, in]; on the
    host."""
    import torch

    with torch.no_grad():
        return to_host(_deepseek_layout(model))


def _deepseek_layout(model) -> dict:
    cfg = model.config
    H, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                 cfg.qk_rope_head_dim)
    m = model.llama
    state = {"model.embed_tokens.weight": m.embed_tokens.weight,
             "model.norm.weight": m.norm.weight,
             "lm_head.weight": model.lm_head.weight.t()}
    for i, layer in enumerate(m.layers):
        a, p = layer.self_attn, f"model.layers.{i}"
        state[f"{p}.self_attn.q_proj.weight"] = interleave_q(
            a.q_proj.weight.t(), H, dn, dr)
        state[f"{p}.self_attn.kv_a_proj_with_mqa.weight"] = interleave_rows(
            a.kv_a_proj_with_mqa.weight.t(), dr)
        state[f"{p}.self_attn.kv_a_layernorm.weight"] = a.kv_a_layernorm.weight
        state[f"{p}.self_attn.kv_b_proj.weight"] = a.kv_b_proj.weight.t()
        state[f"{p}.self_attn.o_proj.weight"] = a.o_proj.weight.t()
        for norm in ("input_layernorm", "post_attention_layernorm"):
            state[f"{p}.{norm}.weight"] = getattr(layer, norm).weight
        mlp = layer.mlp
        if not layer.is_moe:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                state[f"{p}.mlp.{proj}.weight"] = getattr(
                    mlp, proj).weight.t()
            continue
        state[f"{p}.mlp.gate.weight"] = mlp.gate_weight.t()
        M = mlp.experts.d_hidden
        for e in range(cfg.n_routed_experts):
            q = f"{p}.mlp.experts.{e}"
            state[f"{q}.gate_proj.weight"] = mlp.experts.w1[e, :, :M].t()
            state[f"{q}.up_proj.weight"] = mlp.experts.w1[e, :, M:].t()
            state[f"{q}.down_proj.weight"] = mlp.experts.w2[e].t()
        for proj in ("gate_proj", "up_proj", "down_proj"):
            state[f"{p}.mlp.shared_experts.{proj}.weight"] = getattr(
                mlp.shared_expert, proj).weight.t()
    return state


def hf_bridge_deepseek(card):
    """Phase 29 (c): DeepSeek-V2-Lite at its published widths, depth 27 ->
    4, bf16: the source's latent-engine tokens on phase 20's three
    requests (counts exact), its HF layout built here (RoPE rows
    interleaved, experts split) and moved to the host,
    ``deepseek_from_hf(FakeHF(state, V2_LITE_JSON), config=<the bf16
    config>)`` onto the card, every parameter bit-equal to the source's,
    the same tokens, ``flash_attention_mla`` L an exact prefill and
    ``mla_decode`` L a decode step. Returns the counts."""
    import torch

    from paddle_tpu_torch.models import DeepseekV2ForCausalLM
    from paddle_tpu_torch.models.deepseek import (_hf_config_to_deepseek,
                                                  deepseek_from_hf)

    label = "phase 29 (c) DeepSeek-V2-Lite"
    cfg = deepseek_config(num_hidden_layers=HF_V2_LITE_DEPTH)
    src = DeepseekV2ForCausalLM(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(294))
    log(f"phase 29 (c): DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite "
        f"config.json), cut: depth 27 -> {HF_V2_LITE_DEPTH} (the dense layer "
        f"and three MoE layers), {param_bytes(src) / 1e9:.3f} GB bf16")
    rng = np.random.RandomState(295)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in FAMILY_LENS]
    news = [FAMILY_NEW] * len(prompts)
    n_exact = sum(exact_bucket(n) for n in FAMILY_LENS)
    L = cfg.num_hidden_layers
    total, outs = Counter(), {}
    model = None
    for run in ("source", "loaded"):
        if run == "loaded":
            state = deepseek_checkpoint(src)
            model = bridge_load(
                f"{label} deepseek_from_hf", card,
                lambda: deepseek_from_hf(FakeHF(state, V2_LITE_JSON),
                                         config=cfg))
            mapped = dataclasses.replace(
                _hf_config_to_deepseek(V2_LITE_JSON), dtype=cfg.dtype,
                num_hidden_layers=HF_V2_LITE_DEPTH)
            if dataclasses.asdict(mapped) != dataclasses.asdict(cfg):
                raise AssertionError(f"{label}: the config mapped from "
                                     "V2_LITE_JSON differs from the phase's")
            src_params = dict(src.named_parameters())
            n = require_params_equal(label, model,
                                     lambda k: src_params[k].detach())
            log(f"  [{card}] {label}: every parameter ({n / 1e9:.3f}B) "
                "bit-equal to the source's; the config mapped from "
                "V2_LITE_JSON = the phase's (f32 -> bf16, depth aside)")
            del src, src_params, state
            release()
        counts, stats, _, _, outs[run] = serve_run(
            src if run == "source" else model, card, f"{label} {run}",
            prompts, news, False, max_batch=8, max_len=2048)
        steps = stats["decode_steps"]
        require_counts(f"{label} {run}", counts, v3_counts_want(
            L, steps + len(prompts), n_exact, steps, norms=2))
        total.update(counts)
    require_tokens_equal(label, outs["loaded"], outs["source"])
    log(f"  [{card}] {label}: launch counts exact for {steps} decode steps "
        f"and {n_exact} exact prefills (flash_attention_mla {L} each, "
        f"mla_decode {L} a step); tokens of the converted model = the "
        f"source's on all {len(prompts)} requests")
    del model
    release()
    return total


def serve_hf_bridge():
    """Phase 29: the HF checkpoint bridge on the card, (a) Llama-3-8B,
    (b) Phi-3-mini-128k, (c) DeepSeek-V2-Lite at depth 4. Returns the
    launch counts."""
    t0 = time.perf_counter()
    card = card_line()
    total = Counter()
    times = []
    for part in (hf_bridge_llama, hf_bridge_phi3, hf_bridge_deepseek):
        t = time.perf_counter()
        total.update(part(card))
        times.append(time.perf_counter() - t)
    log(f"phase 29 took {time.perf_counter() - t0:.1f}s: (a) {times[0]:.1f}, "
        f"(b) {times[1]:.1f}, (c) {times[2]:.1f}")
    return total

def tensor_core_sass(lib) -> dict:
    """{kernel name: [HMMA, HGMMA]} of a built library, from one
    ``cuobjdump -sass`` (one section a function): mma.sync and wgmma
    products on the tensor cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :", 1)[1].strip())
            out.setdefault(name, [0, 0])
        elif name is not None and "HGMMA" in line:
            out[name][1] += 1
        elif name is not None and "HMMA" in line:
            out[name][0] += 1
    return out


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name, for the ptxas lines:
    ``append_attention_tc_kernel<192,128>``, ``..._kernel<f,128,128>`` for
    an instance on float, ``<bf16,128>`` on bfloat16. The name is the last
    ``<length><identifier>`` of the nested name (after the anonymous
    namespace's)."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    i, name = m.end(), None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if name is None or not name.endswith("_kernel"):
        return mangled
    targs = re.match(r"I(.*?)EEv", mangled[i:])
    if targs is None:
        return name
    args = re.findall(r"Li(\d+)E", targs.group(1))
    if targs.group(1).startswith("f"):
        args = ["f"] + args
    elif targs.group(1).startswith("13__nv_bfloat16"):
        args = ["bf16"] + args
    return f"{name}<{','.join(args)}>"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3, 7, 10, 19 and 27 (b)-(c), trace "
                         "10 decode steps with torch.profiler, fused tail "
                         "off and on "
                         "(Llama-3-8B at 8 slots, Mistral-7B at 4 slots of "
                         "8192-token prompts; DeepSeek-V2-Lite at 8 slots of "
                         "1024-token prompts, no fused tail; "
                         "ERNIE-4.5-21B-A3B at 8 slots of 512-token "
                         "prompts, its MoE layers discrete; GPT-2 XL and "
                         "Qwen2.5-0.5B at 8 slots of 512-token prompts); "
                         "with --families-only, phase 27's alone")
    ap.add_argument("--decode-tail-only", action="store_true",
                    help="phase 1, then phase 2's decode-tail rows alone "
                         "(cold and warm, yardsticks, host us, edges); prints "
                         "no result line. Run from another checkout's root, "
                         "it measures that checkout's kernels")
    ap.add_argument("--mla-only", action="store_true",
                    help="phase 1, then phase 2's MLA decode rows alone "
                         "(cold and warm, SDPA yardstick, bit identity, "
                         "edges); prints no result line. Run from another "
                         "checkout's root, it measures that checkout's "
                         "kernel")
    ap.add_argument("--optimizer-only", action="store_true",
                    help="phase 1, then phase 2's adam_update and grad_norm "
                         "rows alone (bits against the CPU, timings, "
                         "yardsticks); prints no result line")
    ap.add_argument("--moe-only", action="store_true",
                    help="phase 1, phase 2's rows at the MoE families' "
                         "shapes (paged decode at ERNIE-4.5's group of 5 "
                         "and at groups 3, 5, 6, 7; splash and append at "
                         "group 5; rms_norm at width 128), then phases "
                         "18-21; prints no result line")
    ap.add_argument("--engine-only", action="store_true",
                    help="phase 1, then phase 22 alone: the scheduler, "
                         "bundles and OOM degrade on Llama-3-8B and "
                         "DeepSeek-V2-Lite (built here), then the f32 "
                         "wiring; prints no result line")
    ap.add_argument("--autotune-only", action="store_true",
                    help="phase 1, then phase 23 alone: the autotune "
                         "sweeps, speculative_k='auto', the cache stage, "
                         "speculative_generate at full depth and its f32 "
                         "wiring; prints no result line")
    ap.add_argument("--http-only", action="store_true",
                    help="phase 1, then phase 24 alone: the HTTP front-end "
                         "and the engine's observability at full width on "
                         "a Llama-3-8B built here, then its f32 wiring; "
                         "prints no result line")
    ap.add_argument("--engine-step-only", action="store_true",
                    help="phase 1, then the engine's one-token decode step "
                         "wall, graphed and eager, on a Llama-3-8B built "
                         "here (8 slots of 512-token prompts); prints no "
                         "result line. Run from another checkout's root, "
                         "it measures that checkout's engine")
    ap.add_argument("--gemma-only", action="store_true",
                    help="phase 1, phase 2's rows at Gemma's widths (the "
                         "attention kernels at head width 256, the decode "
                         "tail at Gemma-7B's widths, the norms at 3072 and "
                         "3584), then phase 25: Gemma-7B whole and "
                         "Gemma2-9B at depth 8 served on the card, then "
                         "their f32 wiring; prints no result line")
    ap.add_argument("--gemma-train-only", action="store_true",
                    help="phase 1, phase 2's rows of Gemma training at "
                         "head width 256 (the flash backward at (256, 256) "
                         "causal, local and full, its edge shapes, the "
                         "local and full forward, splash_hop, fused_rope "
                         "at 256), then phase 26: Gemma-2B trained whole, "
                         "the f32 wiring of Gemma-7B's training, "
                         "FLAGS_check_nan_inf on the card; prints no "
                         "result line")
    ap.add_argument("--families-only", action="store_true",
                    help="phase 1, phase 2's rows at the dense families' "
                         "head widths (paged decode at D 96 and D 64, "
                         "their edge shapes, append attention at (64, 64) "
                         "one query a row), then phase 27: Phi-3-mini-128k, "
                         "GPT-2 XL and Qwen2.5-0.5B whole, Qwen2.5-7B, "
                         "Qwen3-8B, GLM-4-9B (both trunks) and OLMo2-7B at "
                         "depth 4, then their f32 wiring; prints no result "
                         "line")
    ap.add_argument("--deepseek-v3-only", action="store_true",
                    help="phase 1, phase 2's MLA decode rows at 128 heads "
                         "(bf16 and f32, cold and warm), its edges (24 heads "
                         "among them) and the width-192 flash forward at 128 "
                         "heads, then phase 28: DeepSeek-V3 at "
                         "its published widths, depth 4 and the MTP depth, "
                         "through the latent engine and "
                         "mtp_speculative_generate, then its f32 wiring; "
                         "prints no result line")
    ap.add_argument("--hf-bridge-only", action="store_true",
                    help="phase 1, then phase 29 alone: the HF checkpoint "
                         "bridge on the card (Llama-3-8B through "
                         "llama_to_hf / llama_from_hf, Phi-3-mini-128k's "
                         "fused layout through phi3_from_hf, "
                         "DeepSeek-V2-Lite at depth 4 through "
                         "deepseek_from_hf); prints no result line")
    ap.add_argument("--decode-profile-only", action="store_true",
                    help="phase 1, then phase 3's Llama-3-8B decode "
                         "profile alone (8 slots of 512-token prompts, "
                         "fused tail off and on); prints no result line. "
                         "Run from another checkout's root, it profiles "
                         "that checkout's package")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.hopper import _build

    t_start = time.perf_counter()
    log(f"phase 1: {card_line()} | python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    _build.build()
    log(f"  built {len(_build.sources())} kernel sources in "
        f"{_build.build_info.get('seconds', 0.0):.1f}s into "
        f"{_build.build_dir()}")
    for stem, text in sorted(_build.build_info.get("ptxas", {}).items()):
        kernel = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                kernel = kernel_name(line.rsplit(" ", 1)[-1])
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {stem} {kernel}: {line.strip()}")
    # the attention, paged, MLA and decode-tail kernels' bf16 bodies
    # multiply on the tensor cores (the partial runs may measure an earlier
    # checkout)
    partial = (args.decode_tail_only or args.decode_profile_only
               or args.mla_only or args.optimizer_only or args.moe_only
               or args.engine_only or args.autotune_only or args.http_only
               or args.engine_step_only or args.gemma_only
               or args.gemma_train_only or args.families_only
               or args.deepseek_v3_only or args.hf_bridge_only)
    sass = {}
    for stem in ("append_attention", "flash_attention", "paged_attention",
                 "paged_attention_narrow", "mla_decode", "decode_tail"):
        sass[stem] = tensor_core_sass(_build.build()[stem])
        hmma, hgmma = (sum(c[i] for c in sass[stem].values())
                       for i in (0, 1))
        log(f"  sass {stem}: {hmma} HMMA (mma.sync), {hgmma} HGMMA (wgmma)")
        if hmma + hgmma == 0 and not partial:
            raise AssertionError(f"{stem}: no tensor-core instruction in its "
                                 "SASS")
    # the bf16 bodies' instances at Gemma's width 256, and the paged
    # kernel's at 64 and 96 (the dense families), one by one
    if (not partial or args.gemma_only or args.gemma_train_only
            or args.families_only):
        for stem in ("append_attention", "paged_attention",
                     "paged_attention_narrow", "flash_attention"):
            widths = ("64>", "96>") if stem.endswith("narrow") else ("256",)
            for name, (n, _) in sass[stem].items():
                if not any(f"_tc_kernel<{w}" in name for w in widths):
                    continue
                log(f"  sass {stem} {name}: {n} HMMA (mma.sync)")
                if n == 0:
                    raise AssertionError(f"{name}: no tensor-core "
                                         "instruction in its SASS")

    if args.decode_tail_only:
        check_decode_tail_kernels(make_record({}))
        return 0
    if args.mla_only:
        check_mla_rows(make_record({}))
        return 0
    if args.optimizer_only:
        check_update_rows(make_record({}))
        return 0
    if args.moe_only:
        gen = torch.Generator("cuda").manual_seed(1234)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda")
                    * scale).to(torch.bfloat16)

        record = make_record({})
        check_paged_rows(record, [c for c in PAGED_CASES
                                  if c[0].startswith("ERNIE")])
        check_paged_groups()
        check_group5_rows(record, randn)
        moe_layer_on_card()
        serve_ernie(args.profile)
        serve_families()
        families_wiring_check()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.engine_only:
        engine_only()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.autotune_only:
        autotune_phase()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.http_only:
        http_only()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.engine_step_only:
        engine_step_walls(card_line())
        return 0
    if args.gemma_only:
        gemma_only()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.gemma_train_only:
        gemma_train_only()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.families_only:
        families_only(args.profile)
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.deepseek_v3_only:
        deepseek_v3_only()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.hf_bridge_only:
        serve_hf_bridge()
        log(f"total {time.perf_counter() - t_start:.1f}s")
        return 0
    if args.decode_profile_only:
        from paddle_tpu_torch.models.llama import (LlamaConfig,
                                                   LlamaForCausalLM)

        model = LlamaForCausalLM(
            LlamaConfig.llama3_8b(dtype="bfloat16"), device="cuda",
            generator=torch.Generator("cuda").manual_seed(0))
        profile_decode(model, card_line())
        return 0
    results: dict = {}
    check_kernels(results)
    counts = Counter(serve_full_width(args.profile))
    wiring_check()
    counts.update(train_full_width())
    train_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(serve_mistral(args.profile))
    counts.update(train_mistral())
    window_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(serve_deepseek(args.profile))
    deepseek_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(train_deepseek())
    deepseek_train_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts.update(functional_api())
    counts.update(ring_on_one_card())
    log(f"phases 14-15 took {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    generate_wiring_check()
    engine_wiring_check()
    counts.update(entry_on_card())
    gc.collect()
    torch.cuda.empty_cache()
    moe_layer_on_card()
    counts.update(serve_ernie(args.profile))
    counts.update(serve_families())
    families_wiring_check()
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(autotune_phase(then=http_phase))
    counts.update(serve_gemma())
    counts.update(train_gemma())
    counts.update(serve_dense_families(args.profile))
    counts.update(serve_deepseek_v3())
    counts.update(serve_hf_bridge())

    kernels = []
    for name in SOURCES:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "profiled_ms": r["profiled_ms"],
            "library_device_ms": r["library_device_ms"],
            "library_profiled_ms": r["library_profiled_ms"], "l2": r["l2"],
            "warm_profiled_ms": r["warm_profiled_ms"], "shape": r["shape"]})
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
