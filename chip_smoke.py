#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (one line each, with its seconds; any failure exits nonzero):

1. build    — compile the hand-written CUDA kernels from ``kernels/csrc``
              (one nvcc per source, all started together); report ptxas's
              registers, shared memory and spills, and fail unless the SASS
              (``cuobjdump -sass``) of DMM holds wgmma (HGMMA, M > 32) and
              mma.sync (HMMA, M <= 32), that of SMM wgmma (M > 32), that
              of the mixed kernel mma.sync instructions, and that of the
              AFU the softmax's cluster exchange (``CLUSTER_SASS``: the
              cluster barrier, st.async into peers' shared memory, the
              mbarrier waits).
2. kernels  — each kernel against its plain PyTorch version on the card.
              TDA (phase ``kernels``): the ``kernels/tda/ref.py`` oracle
              (over gathered lanes for the paged kernels; with the LUT exp,
              the blockwise LUT recurrence ``decode_attention_lut`` /
              ``mixed_attention_lut``), on the CPU tests' edge cases at small
              width (f32 and bf16; contiguous lanes of ragged widths 37, 48,
              130 with LUT blocks of 16 and 128 positions; pages of 8 and 16;
              hi <= lo rows, windows, FREE block-table entries; int8 codes
              with f32 scales for all three kernels), the decode kernels'
              split edges (``SPLIT_EDGES``: G 1, 2, 5, 8, and 10, 12, 16 in
              two group tiles; D 20, 64, 128; one slot over lanes of up to
              64 splits, 64 slots over lanes of one or two; hi and lo on split and page edges, windows across
              a split; pages of 128 and 16; f32 and bf16) and the full-width
              shapes of phase 4 (bf16, and int8 K/V with bf16 queries; exact
              and LUT exp, contiguous LUT blocks at the reference's block_k
              128), and the tile edges of the tensor-core mixed body
              (``kernels_tile_edges``: G 1, 2, 5, 8; D 16, 20, 72, 128;
              pages of 8, 16, 128; S G no multiple of 64; n_new 0, 1, S;
              windows, short rings; bf16 and int8, exact and LUT), and
              block tables as prefix sharing leaves them
              (``kernels_aliased_pages``: three slots mapping the same
              physical prefix pages, one with a copy-on-write private tail
              page, decode bounds past, inside and on the shared pages, the
              mixed step's first chunks starting at the shared length; paged
              decode fp and int8, mixed fp; f32 and bf16 at d_head 16 and
              8-token pages, bf16 at full width); max abs
              diff on the f32 outputs of attended decode rows
              and live mixed columns <= 1e-3 with the exact exp and <= 1e-5
              with the LUT exp, exact zeros from the kernel everywhere else.
              Negative controls at full width, which must miss the LUT plain
              version by more than 1e-5: the exact-exp kernel's output, and
              LUT blocks of 64 positions (the contiguous kernel at block_k 64
              over the same codes; the mixed step's plain version on 64-key
              blocks). AFU (phase ``afu``): softmax_lut at (256, 512) (the
              kernel table's), (320, 544) (decode scores of 8 slots x 40
              heads), (8, 152064), (1, 152064) and (8, 256000) (LM heads'
              rows, over a thread block cluster), (2, 600001) (past the
              cluster's shared memory), ragged edges and both sides of
              each regime boundary (``SOFTMAX_SHAPES``), one launch a
              call in the regime the library reports, within 1e-5 x
              |plain| per element (the exact-exp softmax must miss it);
              layernorm_residual at
              (40, 64), (8, 5120), (2048, 5120) and a ragged edge, within
              1e-5 x max(1, max |plain|); f32 and bf16 inputs. DMM and SMM
              (phase ``linear_kernels``): the CPU tests' edge cases (f32 and
              bf16 x), the tensor-core DMM body's tile edges (bf16 x; M 33,
              64, 130, 2048; N 200, 640, 3200; odd K, K no multiple of 64,
              split K), the small-M DMM body's edges (``DMM_SMALL_EDGES``:
              M 1, 7, 8, 16, 31, 32; odd K, K 27648; N 48, 200, 640, 3200),
              the edges of SMM's small-M and tensor-core bodies
              (``SMM_TILE_EDGES``: M 1, 7, 8, 31, 32, 33, 130, 2048; N
              1000, 1024, 5120, 27648; r 640, 650, 3200; nnz 1, 2, 80, 400;
              uint8 deltas with repeated indices, int16 deltas with negative
              ones) — each edge launched twice, which must give the same
              bits, its launches counted by body — and every linear family
              of qwen2.5-32b at full width at M = 8 (a decode step) and
              M = 2048 (a mixed step); max abs diff <= 1e-3 x max(1, max
              |plain|) (f32 sums in another order over K up to 27648; the
              tensor-core bodies' bf16 parts stay within 2^-16 of each
              term). Times each kernel (L2 flushed before every
              launch), its plain version, one PyTorch call computing the same
              function (``library_ms``: SDPA over the (gathered) lanes — for
              int8 lanes over lanes dequantized to bf16 beforehand, the
              dequantization untimed; exact exp beside the LUT rows —,
              ``torch.softmax`` (exact exp: the same traffic, not the same
              function), add + ``F.layer_norm``, or ``torch.matmul`` against
              the densified matrix in f32 (TF32 off; DMM and SMM also time
              the bf16 product on the bf16-rounded matrix,
              ``library_bf16_ms``, a single-pass, lower-precision product);
              a yardstick the port never calls) and its bound; every row
              (the TDA, DMM, SMM and AFU kernels) and its yardstick also by
              the kernels' device time alone (``device_ms``,
              ``library_device_ms``: CUDA events around the call with the
              stream held by a GPU sleep while the host enqueues it, so
              the host dispatch that the events of ``ms`` include is
              hidden). Phase 2 also holds both decode kernels and the mixed
              kernel at the ring serve's shapes (``ring_rows``: 48 q / 4 kv
              heads of 128, G = 12 in two group tiles of 6, and G = 10;
              rings of 4096 positions in 32 pages of 128, lanes that
              wrapped; the mixed step's chunks past the ring with a window
              of 4096) against their plain versions, timed beside SDPA, and
              the mixed kernel's all-columns mode (``moe_rows``: the mode
              of routed MoE stacks, every column computed as the reference
              computes it) on the small and tile-edge cases above, against
              its plain version on every column that has a key and exact
              zeros on those with none (line ``kernels_all_columns``); then
              paged decode and the all-columns mixed step at the MoE
              serve's shapes (48 q / 8 kv heads of 128, G = 6; rows
              ``.g6``, the mixed row with its skip mode's time at the same
              shape), timed beside SDPA. Last, both decode kernels at head
              dims past 128 (``d256_rows``, line ``kernels_d256``: D 136,
              192, 256 at G 1, 5, 10 over one kv head; rings of 2048 in
              pages of 128 and 16 and contiguous, lanes that wrapped,
              windows, hi <= lo rows; fp and int8, exact and LUT exp, f32
              and bf16; the limits above), then rows ``.d256`` at the
              recurrentgemma serve's decode shape (8 slots, 10 q / 1 kv
              heads of 256, lanes of 544 positions), timed beside SDPA.
   kernel_table — the slice's entry point, ``python -m repro_torch.launch.
              kernel_table``: the reference's ``kernels`` and ``decode_attn``
              tables in-process on the card (DMM, SMM, LUT softmax, int8
              contiguous decode). Every row must carry the reference's name
              and a finite time, each kernel's output in the tables must
              match its plain version on the same inputs (the limits above),
              and the LUT softmax must stay within 5e-3 of the exact one (the
              reference test's bound).
3. tokens   — float32 qwen2.5 smoke: the mixed Engine on the TDA kernels
              gives the plain path's tokens (``decode_attn="dense"``); the
              phase-serialized Engine over contiguous and over paged lanes
              gives the plain path's tokens and the mixed Engine's; with
              int8 ``kv_quant`` lanes, contiguous and paged give the same
              tokens as each other and as the plain path; and the compressed
              smoke Engine on the DMM/SMM kernels gives the tokens of the
              same Engine over the explicitly decompressed factors (plain
              ``(x @ ws) @ wd``). Prefix sharing: system-prompt traffic
              (8 requests behind one 17-token prefix, 8-token pages) with
              ``prefix_share=True`` gives the tokens of ``False`` on the
              mixed engine (prefill budgets None and 4) and the serialized
              paged engine, with hits; preemption: a pool of 7 pages that
              preempts gives the tokens of an uncut pool (mixed and
              serialized paged). The serving surface, card against the
              port's CPU run of the same workload on the same params
              (``surface_checks``; tokens, statuses and host counters
              equal): a sampled engine (temperature 0.8, top-k 12, seed 7)
              mixed and serialized; a greedy batch with per-request
              ``SamplingParams`` (its greedy requests keep the greedy
              run's tokens); the sampled engine over a 7-page pool that
              preempts (also equal to the uncut pool's tokens); a chaos
              ``FaultPlan`` (allocation failures, forced preemptions, NaN
              logits, stalls) with audits on; ``audit=True`` against the
              same run without it; a ``Frontend`` against ``Engine.run``;
              a two-replica ``Dispatcher`` with a fleet index against one
              engine, pages restored from the fleet.
              starcoder2 smoke at float32 (window 32: ring lanes; prompts
              up to 45 tokens decoding past the window, two sharing a
              prefix whose page a wrapping ring copies): the mixed and the
              serialized paged and contiguous engines give the same tokens
              through the kernels and the plain path on the card and on
              the CPU, with the CPU's host counters.
   moe_tokens — dbrx and arctic smoke at float32 with the published
              capacity factor 1.25 (the smoke configs' 2.0 and 8.0 never
              drop a claim), dense and compressed weights: the mixed and
              serialized paged engines on the card through the kernels
              (the mixed kernel in its all-columns mode) and the plain
              path, and on the CPU in both modes, give the same tokens and
              host counters and, mode by mode, the CPU's drops; the kernel
              runs drop claims. One mixed step carrying a decode row while
              capacity binds gives the CPU's logits on every column, the
              decode row's five columns past ``n_new`` included (1e-4).
   recurrent_tokens — mamba2 and recurrentgemma smoke at float32
              (``REC_SMOKE``: prompts past the SSD chunk and past the window
              of 32, two arriving mid-decode) through the default engine
              (serialized; recurrentgemma paged, and again contiguous): on
              the card through the decode kernels and through the plain
              path, and on the CPU, the same tokens; the card's host
              counters and prefill sweeps (one row per request) equal the
              CPU's; recurrentgemma's contiguous tokens equal its paged
              ones; the kernel runs launch the decode kernel of their lanes
              (mamba2, no attention layer, none).
   bf16_logits — bf16 logits of qwen2.5 smoke and starcoder2 smoke
              (``apply`` over 40 tokens, ``decode_step`` and ``mixed_step``
              over a page pool; the kernels on the card, the plain path on
              the CPU): the card's largest gap to the CPU's float32 logits
              within ``BF16_FACTOR`` (2) times the CPU's own bf16 gap.
   sampler  — the sampler at the full-width vocabulary: (8, 152064) f32
              logits from a seed, five (seed, position, temperature,
              top-k) sets; the card's threefry bits equal to the CPU's as
              integers, its uniforms bit-identical, its tokens equal but
              for rows whose top two perturbed scores lie within 4 ulp
              (counted; expected none); launches and device ms per call
              of the sampler and of the greedy argmax.
4. serve    — the main path at full width: qwen2.5-32b (d_model 5120, 40/8
              heads, d_head 128, d_ff 27648, vocab 152064; depth cut to 8
              of 64 layers), random weights from torch.Generator seed 0,
              16 greedy requests (8 up front, 8 arriving mid-run) through
              ``Engine.run`` of the mixed-step engine; then, on the same
              params, through three phase-serialized engines: contiguous
              bf16 lanes, contiguous int8 lanes, and the default ``kv_quant``
              engine (paged int8 lanes). Every request must end ``ok`` with
              ``max_new_tokens`` valid tokens, and each TDA kernel must
              launch exactly once per layer per step of its kind (zero times
              in engines that do not run it).
   shared_serve — system-prompt traffic at full width on the same
              params (``profile_serve.shared_workload``: 16 requests, one
              256-token system prompt — two full 128-token pages — plus a
              suffix uniform in [16, 240]; 8 up front, 8 at ticks 4, 7, ...,
              25; token ids below the smoke vocabulary, 256) in three runs
              of the mixed engine: the default ``EngineConfig`` (sharing
              on), sharing over a pool cut to ``SHARED_POOL_FRAC`` (it
              preempts), and sharing off. Each must end 16/16 ``ok`` with
              the pool's invariants and the launch counts above; both
              sharing runs must hit, the cut run preempt, and every run's
              host counters (``HOST_COUNTERS``) must equal the port's on the
              CPU for the same workload on the 2-layer float32 smoke config.
              Reports tok/s, TTFT, K/V token writes against the cold run and
              the requests whose bf16 tokens equal the cold run's.
   sampled_serve — phase 4's workload on its params with seeded sampling
              (temperature 0.8, top-k 50): 16/16 ``ok`` with the launch
              checks of phase 4, two runs of seed 0 token-identical, seed
              1 changing more than half the requests; tok/s, TTFT and step
              times beside the greedy serve's, and a short profiled window
              (8 requests) of a greedy and a sampled engine: launches and
              device ms per decode and mixed step, and of the token choice
              alone.
   fleet_serve — two replicas over the same prepared weights behind a
              ``Dispatcher`` and a ``FleetPrefixIndex`` serve
              ``profile_serve.shared_workload`` (request 0 first, the
              other up-front requests at tick 3): 16/16 ``ok``, pages
              restored from the fleet, host counters (routing, hit ratios,
              pages shared and restored, the fleet's counters, steps)
              equal to the CPU smoke run's; then a ``Frontend`` over one
              full-width engine gives ``Engine.run``'s tokens on a Poisson
              trace with per-request sampling.
5. compressed — the same model factorized (T-REX defaults: rank 0.625,
              nnz 0.125 of the rank), its f32 weights drawn on the card,
              W_D projected and the whole tree compressed on the card, then
              the same 16 requests through ``Engine.run`` on the streams.
              Every request must end ``ok``, DMM and SMM must each launch 7
              x 8 times per step (every linear of every layer): decode steps
              through their small-M bodies, mixed steps through their
              tensor-core bodies, none through the CUDA-core fallbacks
              (``BODY_LAUNCHES``), and the TDA counts keep phase 4's
              invariants.
6. ring_serve — starcoder2-15b at its published widths (d_model 6144, 48 q
              / 4 kv heads of 128, d_ff 24576, vocab 49152, window 4096,
              all 40 layers, ``RING_LAYERS``), bf16 weights from seed 0,
              through the default ``EngineConfig`` (mixed, paged, sharing
              on; 8 slots, 128-token pages, chunks of 2048, 32 new tokens):
              ``profile_serve.ring_workload``, 12 requests of long-context
              completion (short prompts, prompts crossing the window while
              decoding, two of them sharing a 2048-token prefix, prompts
              wrapping inside their chunks). 12/12 ``ok``, one ring class
              of 4096 positions (at most 32 pages a slot), pages shared and
              copied on write, and every host counter equal to the port's
              CPU run of the same workload on starcoder2 smoke with a window
              of 4096; tok/s, TTFT and decode-step ms with the card's name
              and power limit.
7. moe_serve — dbrx-132b at its published widths (d_model 6144, 48 q / 8
              kv heads of 128, 16 experts of 10752, top-4, capacity factor
              1.25, vocab 100352; depth cut to ``MOE_LAYERS`` = 8 of 40,
              ``reduced``), bf16 weights from seed 0 (~53 GB), through the
              mixed engine with phase 4's ``ENGINE_KW`` and workload:
              16/16 ``ok`` with phase 4's launch checks, every mixed launch
              in the all-columns mode, claims dropped, and the host
              counters equal to the port's CPU run of the same prompt
              lengths and arrivals on dbrx smoke at float32; tok/s, TTFT
              and step ms with the card's name and power limit. It runs
              after phase 6 has freed its weights.
8. recurrent_serve — recurrentgemma-2b (26 layers: rglru, rglru, local;
              d_model 2560, 10 q / 1 kv heads of 256, window 2048, vocab
              256000; ~5.8 GB) and mamba2-370m (48 SSD layers, d_model
              1024, state 128; ~0.74 GB) at their published widths and full
              depth, bf16 weights from seed 0, each serving phase 4's
              workload through the default ``EngineConfig`` (serialized,
              one request per prefill row; paged for recurrentgemma's
              local layers, unpaged state lanes for mamba2), recurrentgemma
              once more with contiguous lanes: 16/16 ``ok`` with phase 4's
              launch checks (the decode kernel once per attention layer
              per decode step), every host counter and prefill sweep equal
              to the port's CPU run of the same traffic on the smoke config,
              and a short profiled window (launches and device ms per decode
              step and prefill sweep); tok/s, TTFT, step ms and rows per
              sweep with the card's name and power limit.
9. embeds   — llava-next-mistral-7b (32 layers, ~14 GB) and then
              musicgen-large (48 layers, ~4.9 GB, 4 codebooks) at their
              published widths, bf16 weights from seed 0: seeded (2, 512,
              d) embeds through ``Model.prefill``, then 8 ``decode_step``s
              on the contiguous decode kernel; at float32 compute (the
              bf16 weights), every decode position's logits (and the
              prefill's last) within 0.02 of the full forward's, relative
              to its largest magnitude (the reference test's bound); at
              bf16 compute the kernel path's drift within ``BF16_FACTOR``
              (2) times the plain path's; musicgen's logits (2, 1, 4,
              2048).
   paper_models — the paper's four evaluation models
              (``models/paper_models.py``: bert, vit, mt, s2t) at their
              published widths and full depth (12, 12, 6 + 6, 12 + 6
              layers), seed-0 weights drawn on the CPU, f32 compute: (a)
              dense, factorized (W_D projected) and compressed
              (``compress_model_params``), the card against the CPU on the
              same trees: logits (bert 2 x 128 tokens, vit 2 x 197 patch
              embeddings), logits and loss (mt 2 x 64 source ids, s2t 2 x
              256 fbank frames, one source row padded; 2 x 48 targets),
              within ``PAPER_CPU_REL`` (dense, factorized) and
              ``PAPER_KERNEL_REL`` (compressed) of the largest logit (the
              loss relative to itself); DMM and SMM launched once per
              compressed linear per forward, never for the other formats;
              (b) the compressed forward through DMM / SMM against the same
              forward on the decompressed tree, within ``PAPER_KERNEL_REL``;
              (c) the paper's dynamic batching on bert: 64 requests of
              ``request_lengths(64, 128, "bert")`` packed by
              ``pack_requests(PackingPolicy(128, 4))`` against one request
              a row: utilization, each request's packed f32 logits against
              its own forward, and the encoder forward's tokens/s, dense
              and compressed, f32 and bf16, with the card's name and power
              limit; (d) DMM's and SMM's launches in the bf16 compressed
              packed forward (72 each, tensor-core bodies), which the rows
              ``dmm_matmul.bert`` and ``smm_matmul.bert`` carry, timed at
              that forward's shapes (M = the packed tokens; ffn_down's
              dictionary, layer 0's ffn_up W_D).
10. tp_serve — tensor-parallel serving on a (1, N) mesh of rank processes
              (``launch.mesh.run_ranks`` running ``launch.tp_serve.
              serve_rank``) that share the one card through gloo (NCCL
              refuses two ranks on one GPU; the times are of ranks sharing
              a card through host-staged collectives, not a tensor-parallel
              speed): (a) qwen2.5-32b at its published widths, depth 64 ->
              ``TP_LAYERS`` = 4, float32 weights and compute, TF32 off,
              phase 4's workload through ``ENGINE_KW`` and the default
              ``EngineConfig``, served unsharded and then at N = 2 and 4
              (20 / 4 and 10 / 2 heads a rank, G = 5): tokens, statuses and
              host counters (``TP_COUNTERS``) equal to the unsharded run's
              (on a difference: the first differing step and the unsharded
              top-2 logit gap there, then failure); (b) the same widths at
              depth 8 in bf16, N = 2: 16/16 ``ok``, host counters equal to
              the unsharded bf16 run's, tok/s and step ms; (c) dbrx-132b at
              its published widths, depth 40 -> 1, float32, N = 2, the first
              ``TP_MOE_REQUESTS`` = 8 requests: tokens equal. The parent
              draws the weights on the card from seed 0, serves them, saves
              them to a temporary directory, and each rank loads them
              memory-mapped and moves only its slice to the card; every
              rank's outputs must equal every other rank's, and every rank
              must launch the paged decode and mixed kernels on its heads.
              Each rank's weight bytes on the card and peak host RSS are
              printed.
11. train   — the trainer (``train/loop.py``, ``launch/steps.py``,
              ``optim/adamw.py``, ``Model.loss`` with ``chunked_xent``,
              ``checkpoint/``), TF32 off. (a) qwen2.5 smoke at float32,
              ``train`` on the card against the CPU from the same params
              and ``lm_batches`` stream: 12 dense steps with ids >= V at
              step 7 (a NaN loss: the step must be skipped, the state's
              step one behind the loop's), then 12 factorized steps
              (``min_dim`` 32, sparse from step 4, a projection every 4):
              the same steps recorded, losses within ``TRAIN_LOSS_TOL``,
              final params within ``TRAIN_PARAM_TOL`` / ``_FRAC``; every
              W_D column with exactly ``nnz_for(r)`` non-zeros in the
              step-8 checkpoint and at the end; a restart from the step-8
              checkpoint alone gives steps 8-11 the uninterrupted run's
              losses (1e-6); ``launch/serve.py --ckpt`` serves the dense
              run's checkpoint on the card (the paged decode and mixed TDA
              kernels must launch) with the CPU serve's tokens and host
              counters. (b) qwen2.5-32b at its published widths, depth 64
              -> ``TRAIN_FULL_LAYERS`` = 2, f32 masters, bf16 compute,
              AdamW with f32 state, ``lm_batches`` at 8 x 64, the config's
              remat: 6 dense steps, then the factorized model (``min_dim``
              256) for 6, sparse from step 2, a projection every 3; no
              step bad, every loss and grad norm finite, the step-0 loss
              within ``TRAIN_BF16_LOSS_TOL`` of an f32 forward of the same
              params and batch, exact nnz per W_D column after each
              projection; per step loss, ms (synchronized wall) and grad
              norm, one more step split into forward, backward and update
              (CUDA events), and the peak ``max_memory_allocated`` against
              the bytes predicted from the shapes (params, grads, m and v
              in f32, two update temporaries of the largest leaf, one
              logits chunk and its gradient), with the card's name and
              power limit. The training path adds no kernel: its attention
              is the plain flash attention of a forward without caches.
12. sharded_train — training on a (2, 2) ``(data, model)`` mesh of four
              rank processes sharing the card over gloo
              (``launch/sharded_train.py::train_rank``, through
              ``train/loop.py::train(mesh=)``: FSDP over ``data``, TP over
              ``model``, experts over ``data``), TF32 off. (a) smoke
              width, float32, 2 steps from ``Model.init(0)``: qwen2.5 dense
              (AdamW) and factorized (``sparse_train``, Adafactor, a
              projection after step 1) against the unsharded run on the
              card, and dbrx smoke factorized (``sparse_train``, AdamW)
              against the same (2, 2) mesh of ranks on the CPU (expert
              capacity is per data shard): every step's loss and grad norm
              and every param leaf after the run within ``SHARDED_RTOL`` x
              max(1, max |ref|). (b) qwen2.5-32b at its published widths,
              depth 64 -> ``TRAIN_FULL_LAYERS`` = 2, f32 masters, bf16
              compute, AdamW with f32 state, 3 dense steps of
              ``lm_batches`` at 8 x 64 (4 x 64 a rank): the step-0 loss
              within ``TRAIN_BF16_LOSS_TOL`` of phase 11's unsharded
              step-0 loss on the same seed and batch; per step and rank
              the ms and the gloo calls, seconds and bytes
              (``Mesh.stats``); each rank's peak ``max_memory_allocated``
              beside its prediction (``predict_rank_bytes``: its slices'
              params, grads and moments, one layer's gathered weights and
              the gathered table and head with their f32 gradients,
              AdamW's temporaries, the activations of 4 x 64 tokens); the
              four peaks must fit the card.
13. examples — the five examples of ``repro_torch.examples`` in-process on
              the card at their default sizes (quickstart, compress_and_eval
              at 80 steps, train_factorized_lm at 150 steps dense and
              factorized, serve_dynamic_batching at bf16,
              serve_async_frontend at float32), each example's own checks
              raising on a miss (the async outputs equal ``Engine.run``'s,
              a cancel frees its pages); each example's seconds, and
              tokens and tok/s for the serve examples, whose runs must
              launch the paged decode and mixed TDA kernels
              (``tda.LAUNCHES``); then both serve examples at float32
              against the same examples' CPU run (a subprocess started with
              the dry run's cells): every request's tokens equal. It runs
              after phase 14, when those subprocesses have ended.
14. dryrun  — (a) ``python -m repro_torch.launch.dryrun --arch
              qwen2.5-32b --shape <cell> --mesh single`` for ``train_4k``,
              ``decode_32k`` and ``prefill_32k`` (``DRYRUN_CELLS``), each a
              CPU subprocess started after phase 12, the last phase whose
              host times are kept (one thread, niced;
              placeholder ranks of a fake process group, fake tensors):
              ``train_4k`` and ``prefill_32k`` must write their records
              (the roofline keys and the rates' source), ``decode_32k``
              must be refused with the reference's message
              (``DRYRUN_REFUSAL``); each record's roofline terms, counts
              and seconds. (b) The counters against the card: train (b)'s
              step (qwen2.5-32b at its widths, depth 2, 8 x 64 tokens, f32
              masters, bf16 compute, AdamW) and a bf16 prefill of 1 x 8192
              tokens at depth 8, each counted on fake CUDA tensors
              (``dryrun.count_step``) and then run on the card: the FLOPs
              of ``FlopCounterMode`` on the real step must equal the fake
              count, the fake peak must lie within ``CALIB_PEAK_RANGE`` of
              ``max_memory_allocated``; the step's ms against the record's
              ``step_time_bound_s`` (its largest term, the memory term an
              unfused upper estimate) and ``lower_bound_s`` (its compute
              term) at H100 rates, with the card's name and power limit. Neither step reaches a ctypes kernel.

Each kernels-line row takes its launches from the run that drives it, and
names that run in ``launches_from``: the TDA rows from the phase-4 serves
(``serve:<engine>``; int8 rows from the int8 serves), the G = 12 paged
decode and mixed rows from phase 6 (``serve:ring``), the G = 6 ones from
phase 7 (``serve:moe``), the ``.tp2`` rows (paged decode and mixed at
a rank's shapes of phase 10's bf16 run: 20 q / 4 kv heads) from rank 0 of
that run (``serve:tp:bf16:rank0``), the ``.d256`` rows from phase 8
(``serve:recurrent:recurrentgemma-2b``, paged; ``...contiguous``, the
contiguous run), DMM and SMM from phase
5 (``compressed_serve``), the ``.bert`` DMM and SMM rows from the bf16
compressed packed forward of phase ``paper_models``
(``paper_models:bert_packed_bf16_compressed``), softmax_lut from the
kernel_table phase (``kernel_table``); layernorm_residual, the TDA LUT
and int8-mixed variants and the other ring-shape rows (contiguous decode at G = 12, every
G = 10 row), which no serve runs, from their check at the row's full-width
shape in phase 2 (``check``: the one launch at that shape, two for
LayerNorm's f32 and bf16 inputs; counted before they are timed). Then the
card's name and power limit, the kernels' JSON line, and last the device
JSON line. Exits nonzero with no result without a CUDA device or outside a
checkout of the repository.
"""
import atexit
import dataclasses
import gc
import json
import math
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-3          # max abs diff, exact-exp TDA kernels vs plain version
# The LUT-exp and AFU kernels compute their plain versions' f32 formulas,
# summed in another order (on the card: <= 5.4e-7 for the LUT TDA rows,
# 3.0e-7 for softmax, 2.9e-6 for LayerNorm at outputs of up to ~20), so
# their limits sit far below the differences that a wrong kernel makes:
# the negative controls below must fail these limits on the same inputs.
LUT_TOL = 1e-5      # max abs diff, LUT TDA kernels vs blockwise LUT plain
SOFTMAX_RTOL = 1e-5  # max |diff| / |plain| per element (entries ~1e-12..1)
LN_TOL = 1e-5       # max abs diff / max(1, max |plain|), LayerNorm
LUT_CONTROL_BLOCK = 64  # a partition other than the reference's (128)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12      # H100 SXM f32 (no tensor cores)


def card_name():
    """``nvidia-smi``'s name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def line(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=20):
    """Median per-call device time with a cold L2 (a 64 MB buffer is
    written before each call, outside the timed events)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _queue_ahead(torch, fn):
    """A GPU sleep long enough to hide ``fn``'s host dispatch: ``fn`` is
    enqueued behind it, so its kernels then run back to back. Returns a
    callable that enqueues the sleep (``torch.cuda._sleep``, in cycles
    calibrated here against CUDA events)."""
    probe = 1 << 20
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(probe)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = probe / max(a.elapsed_time(b), 1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3  # enqueue, plus any sync
    torch.cuda.synchronize()
    cycles = int(cycles_per_ms * (2 * host_ms + 1.0))
    return lambda: torch.cuda._sleep(cycles)


def device_ms(torch, fn, reps=20):
    """Median device time of one call, without the host's dispatch, which
    dominates calls of tens of microseconds in :func:`time_ms`: CUDA events
    around the call with the stream held by a GPU sleep while the host
    enqueues it (:func:`_queue_ahead`), so the events time the call's
    kernels back to back (and the device's gaps between them), with a cold
    L2 as in :func:`time_ms`. No profiler trace is read: the profiler's
    device tracing now and then returns no device events at all."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    ahead = _queue_ahead(torch, fn)
    times = []
    for _ in range(reps):
        flush.zero_()
        ahead()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def range_profile(torch, fn, reps=20):
    """(median device ms, median kernel launches) of one call: the time by
    :func:`device_ms`, the launches from the kernels that the profiler's op
    tree puts inside each call's host range (``profile_serve.
    range_kernels``). A trace whose calls hold no kernels is taken again,
    up to three times; then the row fails with what the traces held."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.profile_serve import range_kernels
    ms = device_ms(torch, fn, reps)
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                with record_function("smoke.call"):
                    fn()
            torch.cuda.synchronize()
        events = prof.events()
        calls = [range_kernels(e)[0] for e in events
                 if e.device_type == DeviceType.CPU
                 and e.name == "smoke.call"]
        if len(calls) == reps and all(calls):
            return ms, sorted(calls)[reps // 2]
        seen.append({"calls": len(calls), "with_kernels": sum(
            1 for n in calls if n), "device_events": sum(
            1 for e in events if e.device_type == DeviceType.CUDA)})
    fail(f"range_profile: no kernels in the calls of three traces {seen}")


def rel_err(got, plain):
    """max |got - plain| / |plain| per element (LUT softmax: every entry
    is positive, down to table[0] / row sum)."""
    return ((got - plain).abs() / plain.abs()).max().item()


def bound(nbytes, flops, itemsize):
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 2 inputs
# ---------------------------------------------------------------------------

def pool_case(np, rng, B, Hkv, D, ps, n, P, needed):
    """Shuffled pool pages behind a block table whose entries past each
    row's ``needed`` pages carry the FREE sentinel (== P)."""
    bt = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    for b in range(B):
        bt[b, needed[b]:] = P
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    return k, v, bt


# Split edges of the decode kernels (split-K over the key axis), as
# tests/test_torch_tda.py::SPLIT_EDGES: (G, D, B), with one slot over a
# long lane (many splits) and 64 slots over short lanes (one or few); D 20
# stages bf16 and int8 rows by element copies.
SPLIT_EDGES = [(1, 64, 1), (2, 128, 64), (5, 128, 1), (8, 64, 64),
               (5, 128, 8), (2, 20, 8), (12, 128, 8), (10, 64, 1),
               (16, 20, 64)]


def split_edge_rows(np, rng, W, L, B):
    """[lo, hi) rows at a lane of W positions cut into splits of L: many
    splits, hi <= lo, one token, hi and lo on split edges, a window across
    a split edge, the whole lane, the last position; then random rows."""
    rows = [(5, W - 7), (L + 2, L), (0, 1), (0, L), (L, 2 * L),
            (L - 3, 2 * L + 5), (0, W), (W - 1, W), (L - 1, L + 1), (0, 0)]
    rows = [(min(a, W), min(b, W)) for a, b in rows]
    while len(rows) < B:
        lo = int(rng.integers(0, W))
        rows.append((lo, int(rng.integers(lo, W + 1))))
    return np.array(rows[:B], np.int32)


def small_decode_cases(np):
    """hi <= lo rows, FREE-sentinel entries, a window; G = 2 and 5; then
    the split edges (SPLIT_EDGES)."""
    for Hq, Hkv in ((4, 2), (10, 2)):
        for ps in (8, 16):
            for window in (None, 5):
                rng = np.random.default_rng(ps + Hq)
                n, B = 4, 6
                lengths = np.array([0, 1, ps + 3, n * ps, 2 * ps, 3 * ps - 1])
                k, v, bt = pool_case(np, rng, B, Hkv, 16, ps, n, B * n + 3,
                                     [-(-int(x) // ps) for x in lengths])
                lo = np.zeros_like(lengths) if window is None \
                    else np.maximum(lengths - window, 0)
                bounds = np.stack([lo, lengths], 1).astype(np.int32)
                bounds[4] = [ps + 2, ps]  # hi <= lo
                q = rng.standard_normal((B, Hq, 16)).astype(np.float32)
                yield q, k, v, bounds, bt
    # split edges: 128-token pages (half a page a split) and 16-token
    # pages (four pages a split); one slot over a long lane, 64 slots over
    # short ones
    from repro_torch.kernels.tda.tda import decode_split_plan
    for i, (G, D, B) in enumerate(SPLIT_EDGES):
        rng = np.random.default_rng(60 + i)
        for ps, n in ((128, 32 if B == 1 else 2), (16, 64 if B == 1 else 4)):
            W = n * ps
            bounds = split_edge_rows(np, rng, W, decode_split_plan(W, ps), B)
            k, v, bt = pool_case(np, rng, B, 2, D, ps, n, B * n + 3,
                                 [-(-int(x) // ps) for x in bounds[:, 1]])
            q = rng.standard_normal((B, 2 * G, D)).astype(np.float32)
            yield q, k, v, bounds, bt


def small_contig_cases(np):
    """Contiguous lanes of ragged widths (no multiple of 32 or 128): an
    empty lane, one token, a partial and a full lane, a hi <= lo row, a
    window; G = 2 and 5; then the split edges (SPLIT_EDGES)."""
    for Hq, Hkv in ((4, 2), (10, 2)):
        for S in (37, 48, 130):
            for window in (None, 5):
                rng = np.random.default_rng(S + Hq)
                B = 6
                lengths = np.array([0, 1, S // 2 + 3, S, 7, S - 2])
                lo = np.zeros_like(lengths) if window is None \
                    else np.maximum(lengths - window, 0)
                bounds = np.stack([lo, lengths], 1).astype(np.int32)
                bounds[4] = [9, 7]  # hi <= lo
                q = rng.standard_normal((B, Hq, 16)).astype(np.float32)
                k = rng.standard_normal((B, S, Hkv, 16)).astype(np.float32)
                v = rng.standard_normal((B, S, Hkv, 16)).astype(np.float32)
                yield q, k, v, bounds
    # split edges: one slot over a long lane (63 splits), 64 slots over
    # lanes of one or two splits
    from repro_torch.kernels.tda.tda import decode_split_plan
    for i, (G, D, B) in enumerate(SPLIT_EDGES):
        rng = np.random.default_rng(70 + i)
        for S in ((4000, 544) if B == 1 else (64, 100)):
            bounds = split_edge_rows(np, rng, S, decode_split_plan(S), B)
            q = rng.standard_normal((B, 2 * G, D)).astype(np.float32)
            k = rng.standard_normal((B, S, 2, D)).astype(np.float32)
            v = rng.standard_normal((B, S, 2, D)).astype(np.float32)
            yield q, k, v, bounds


def small_mixed_cases(np):
    """ci = 0 rows, n_new = 0 rows, a dead row, a window, and a ring
    narrower than the lane that wraps; G = 2 and 5."""
    for Hq, Hkv in ((4, 2), (10, 2)):
        for ps in (8, 16):
            for ring_short in (False, True):
                for window in (None, 6):
                    rng = np.random.default_rng(ps + Hq + 1)
                    n, S, B = 3, 8, 7
                    W = n * ps
                    ring = W - ps + 3 if ring_short else W
                    k, v, bt = pool_case(np, rng, B, Hkv, 16, ps, n,
                                         B * n + 2, [1] + [n] * (B - 1))
                    rows = [(0, 0), (0, 5), (7, 1), (9, 0), (ps + 2, 6),
                            (ps, S), (ring + 4, 3)]
                    q = rng.standard_normal((B, S, Hq, 16)).astype(np.float32)
                    kr = rng.standard_normal((B, S, Hkv, 16)).astype(
                        np.float32)
                    vr = rng.standard_normal((B, S, Hkv, 16)).astype(
                        np.float32)
                    yield ((q, k, v, kr, vr, np.array(rows, np.int32), bt),
                           dict(ring=ring, window=window))


# Tile edges of the tensor-core mixed kernel (bf16 q, 64 packed query rows
# a block), as tests/test_torch_tda.py::MIXED_TILE_EDGES: (G, D, page_size)
# with S = 20 columns (S G no multiple of 64); D 16, 72 (int8 rows in
# 8-byte copies), 128 and 20 (element copies); pages of 8, 16 and 128.
MIXED_TILE_EDGES = [(1, 16, 8), (2, 72, 16), (5, 128, 128), (8, 16, 128),
                    (8, 72, 8), (5, 16, 16), (1, 128, 16), (2, 20, 16)]


def mixed_tile_cases(np):
    """Rows (ci, n_new): dead, a fresh full chunk, a decode row, an inert
    row, a full chunk over a resident lane, a lane past its ring (wraps
    when the ring is short) and a mid-lane chunk; windows None and 7."""
    for i, (G, D, ps) in enumerate(MIXED_TILE_EDGES):
        for ring_short in (False, True):
            rng = np.random.default_rng(20 + i)
            n = 2 if ps == 128 else 3
            S, B, Hkv = 20, 7, 2
            W = n * ps
            ring = W - ps + 3 if ring_short else W
            P = B * n + 3
            bt = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
            k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
            v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
            rows = np.array([(0, 0), (0, S), (W // 2, 1), (W // 3, 0),
                             (W - S, S), (ring + 5, 3), (ps + 2, S // 2 + 3)],
                            np.int32)
            q = rng.standard_normal((B, S, G * Hkv, D)).astype(np.float32)
            kr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            vr = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for window in (None, 7):
                yield ((q, k, v, kr, vr, rows, bt),
                       dict(ring=ring, window=window))


def aliased_cases(np, Hq, Hkv, D, ps, S):
    """Block tables as prefix sharing leaves them: slots 0, 1 and 2 map the
    same two physical prefix pages; slot 2's second page is a
    copy-on-write private copy (the shared page's first half, its own
    tokens after it); slot 3 maps the shared pages alone (a duplicate
    prompt over its prefix). Decode bounds end past, inside and on the
    shared pages; the mixed rows start their first chunk at the shared
    length (``ci = n_shared > 0``): a full chunk, a short chunk, a chunk
    from the middle of the copied page, and a decode row."""
    rng = np.random.default_rng(90 + ps)
    n, P = 4, 12
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    shared, cow = [7, 2], 9
    half = ps // 2
    k[cow, :half], v[cow, :half] = k[2, :half], v[2, :half]
    bt = np.full((4, n), P, np.int32)
    bt[0, :3] = shared + [5]
    bt[1, :3] = shared + [0]
    bt[2, :3] = [7, cow, 11]
    bt[3, :2] = shared
    his = [2 * ps + 3, 2 * ps + 5, ps + half + 2, 2 * ps - 1]
    bounds = np.stack([np.zeros(4, np.int32), np.array(his, np.int32)], 1)
    q1 = rng.standard_normal((4, Hq, D)).astype(np.float32)
    rows = np.array([(2 * ps, S), (2 * ps, 5), (ps + half, S),
                     (2 * ps - 1, 1)], np.int32)
    q = rng.standard_normal((4, S, Hq, D)).astype(np.float32)
    kr = rng.standard_normal((4, S, Hkv, D)).astype(np.float32)
    vr = rng.standard_normal((4, S, Hkv, D)).astype(np.float32)
    return (q1, k, v, bounds, bt), (q, k, v, kr, vr, rows, bt)


def full_cases(np, cfg, num_slots, cache_len, page_size, chunk):
    """Phase 4's attention shapes: 8 slots over a pool of 8 lanes of
    ceil(cache_len / page_size) pages, G = 5, d_head 128."""
    rng = np.random.default_rng(1)
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    n = -(-cache_len // page_size)
    P = num_slots * n
    lengths = rng.integers(33, cache_len, size=num_slots)
    needed = [-(-int(x) // page_size) for x in lengths]
    k, v, bt = pool_case(np, rng, num_slots, Hkv, D, page_size, n, P, needed)
    q1 = rng.standard_normal((num_slots, Hq, D)).astype(np.float32)
    dec = (q1, k, v, np.stack([np.zeros_like(lengths), lengths],
                              1).astype(np.int32), bt)
    # mixed: three chunk rows, four decode rows and one inert row
    rows = [(0, chunk), (chunk, chunk), (200, 144), (300, 1), (150, 1),
            (520, 1), (64, 1), (90, 0)]
    rows = np.array(rows, np.int32)
    needed = [-(-int(ci + nn) // page_size) for ci, nn in rows]
    k2, v2, bt2 = pool_case(np, rng, num_slots, Hkv, D, page_size, n, P,
                            needed)
    q = rng.standard_normal((num_slots, chunk, Hq, D)).astype(np.float32)
    kr = rng.standard_normal((num_slots, chunk, Hkv, D)).astype(np.float32)
    vr = rng.standard_normal((num_slots, chunk, Hkv, D)).astype(np.float32)
    mix = (q, k2, v2, kr, vr, rows, bt2)
    return dec, mix


# DMM / SMM edge cases of tests/test_torch_dmm_smm.py: (M, K, N) and
# (M, r, N, nnz, value_bits); odd K, ragged tiles, nnz = 2, int16 deltas
# (r = 1024, nnz = 2), value widths 4/5/7.
DMM_SMALL = [(32, 64, 48), (64, 128, 96), (100, 60, 36), (32, 33, 16),
             (16, 256, 128), (128, 128, 128), (8, 64, 40)]
# Tile edges of the tensor-core DMM body (bf16 x, M > 32; 128 x 128 outputs,
# K steps of 64), as tests/test_torch_dmm_smm.py::DMM_TILE_EDGES: ragged M
# and N (200: element copies), odd K, K no multiple of 64, split K.
DMM_TILE_EDGES = [(33, 127, 200), (64, 4000, 640), (130, 513, 3200),
                  (2048, 5120, 640), (2048, 2088, 200), (130, 1000, 200),
                  (2048, 1000, 3200)]
SMM_SMALL = [(32, 64, 48, 8, 6), (64, 128, 100, 16, 6), (16, 32, 32, 2, 6),
             (48, 96, 64, 24, 6), (8, 1024, 40, 2, 6), (32, 64, 48, 8, 4),
             (32, 64, 48, 8, 5), (32, 64, 48, 8, 7)]
# Edges of SMM's two redesigned bodies, as tests/test_torch_dmm_smm.py::
# SMM_TILE_EDGES: (M, r, N, nnz, kind). M 1-32 runs the small-M gather
# body, M > 32 the tensor-core body (uint8) or the first version's (int16);
# N 1000 ragged, r 650 no multiple of the 64-row K tile, nnz 1, 2, 80,
# 400; "dup": uint8 deltas with zeros, "neg": int16 deltas, some negative.
SMM_TILE_EDGES = [(1, 640, 1024, 80, "sorted"), (7, 3200, 5120, 400, "sorted"),
                  (8, 3200, 27648, 400, "sorted"), (31, 650, 1000, 2, "sorted"),
                  (32, 3200, 1024, 1, "sorted"), (8, 640, 1024, 80, "dup"),
                  (8, 640, 1000, 80, "neg"), (33, 640, 5120, 80, "sorted"),
                  (130, 3200, 1000, 400, "sorted"), (130, 640, 1024, 80, "dup"),
                  (130, 640, 1024, 80, "neg"),
                  (2048, 650, 1024, 2, "sorted"),
                  (2048, 3200, 5120, 400, "sorted")]
# Edges of DMM's small-M body (bf16 x, M <= 32), as tests/test_torch_dmm_
# smm.py::DMM_SMALL_EDGES: (M, K, N); odd K, K 27648, N 640, 3200, ragged.
DMM_SMALL_EDGES = [(1, 27648, 3200), (7, 5121, 640), (8, 27648, 640),
                   (31, 333, 3200), (32, 27648, 3200), (8, 4000, 200),
                   (16, 127, 48)]


def smm_edge_streams(np, rng, r, N, nnz, kind):
    """(first, deltas, vq) numpy streams, as tests/test_torch_dmm_smm.py::
    smm_edge_streams: uint8 deltas ("dup": a third of them 0) from a first
    index of -2 up, running past r; "neg": int16 deltas, a tenth negative."""
    first = rng.integers(-2, max(1, r // 4), size=N).astype(np.int32)
    hi = max(1, min(255, 2 * r // max(nnz, 1)))
    d = rng.integers(0, hi + 1, size=(max(nnz - 1, 0), N))
    if kind == "dup":
        d[rng.random(d.shape) < 1 / 3] = 0
    if kind == "neg":
        d[rng.random(d.shape) < 0.1] -= 20
    vq = rng.integers(0, 64, size=(nnz, N)).astype(np.uint8)
    return first, d.astype(np.int16 if kind == "neg" else np.uint8), vq


def wd_streams(torch, wd, nnz, bits=6):
    """(first, deltas, vq, scale, offset, bits) of a W_D compressed by the
    port, deltas uint8 or int16 as ``compress_model_params`` stores them."""
    from repro_torch.core import compression as comp
    c = comp.compress_wd(wd, nnz, value_bits=bits)
    ddt = torch.uint8 if c.achieved_delta_bits <= 8 else torch.int16
    return (c.deltas[0], c.deltas[1:].to(ddt), c.values_q, c.scale, c.offset,
            bits)


def small_linear_cases(torch, np, dev):
    """(kind, args) for the plain-vs-kernel check: "dmm" (args once with
    f32 and once with bf16 x), "dmm_tile_edge" and "dmm_small_edge" (bf16
    x), "smm" and "smm_edge"."""
    from repro_torch.core import compression as comp
    from repro_torch.core.factorized import pack_nibbles

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for M, K, N in DMM_SMALL:
        rng = np.random.default_rng(M + K + N)
        cws = comp.compress_ws(T((rng.normal(size=(K, N)) * 0.1).astype(
            np.float32)))
        x = T(rng.normal(size=(M, K)).astype(np.float32))
        for xx in (x, x.to(torch.bfloat16)):
            yield "dmm", (xx, pack_nibbles(cws.codes), cws.lut)
    for M, K, N in DMM_TILE_EDGES:
        rng = np.random.default_rng(M + K + N)
        codes = T(rng.integers(0, 16, size=(K, N)).astype(np.uint8))
        lut = T((np.sort(rng.standard_normal(16)) / np.sqrt(K)).astype(
            np.float32))
        x = T(rng.standard_normal((M, K)).astype(np.float32))
        yield "dmm_tile_edge", (x.to(torch.bfloat16), pack_nibbles(codes),
                                lut)
    for M, K, N in DMM_SMALL_EDGES:
        rng = np.random.default_rng(M + K + N)
        codes = T(rng.integers(0, 16, size=(K, N)).astype(np.uint8))
        lut = T((np.sort(rng.standard_normal(16)) / np.sqrt(K)).astype(
            np.float32))
        x = T(rng.standard_normal((M, K)).astype(np.float32))
        yield "dmm_small_edge", (x.to(torch.bfloat16), pack_nibbles(codes),
                                 lut)
    for M, r, N, nnz, kind in SMM_TILE_EDGES:
        rng = np.random.default_rng(M + r + N + nnz)
        st = [T(a) for a in smm_edge_streams(np, rng, r, N, nnz, kind)]
        y = T(rng.standard_normal((M, r)).astype(np.float32))
        yield "smm_edge", (y, *st, 1.3, -0.6, 6)
    for M, r, N, nnz, bits in SMM_SMALL:
        rng = np.random.default_rng(M + r + bits)
        wd = T(rng.normal(size=(r, N)).astype(np.float32))
        y = T(rng.normal(size=(M, r)).astype(np.float32))
        yield "smm", (y,) + wd_streams(torch, wd, nnz, bits)
    # indices past r, below 0 (negative int16 delta) and repeated
    first = T(np.array([0, 3, 15, 2, 5], np.int32))
    deltas = T(np.array([[1, 20, 0, -5, 0], [2, 1, 3, 4, 0]], np.int16))
    vq = T(np.random.default_rng(0).integers(0, 64, size=(3, 5)).astype(
        np.uint8))
    y = T(np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32))
    yield "smm", (y, first, deltas, vq, 1.5, -0.25, 6)


def linear_shapes(cfg):
    """{(d_in, d_out, r, nnz): [families]} of the factorized qwen2.5-32b
    linears at full width."""
    fc, d, hd = cfg.factorization, cfg.d_model, cfg.head_dim
    dims = {"attn_q": (d, cfg.n_heads * hd), "attn_k": (d, cfg.kv_heads * hd),
            "attn_v": (d, cfg.kv_heads * hd), "attn_o": (cfg.n_heads * hd, d),
            "ffn_up": (d, cfg.d_ff), "ffn_gate": (d, cfg.d_ff),
            "ffn_down": (cfg.d_ff, d)}
    out = {}
    for fam, (di, do) in dims.items():
        r = fc.rank_for(di, do)
        out.setdefault((di, do, r, fc.nnz_for(r)), []).append(fam)
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# Tensor-core instructions each library's SASS must hold: the DMM body for
# bf16 x at M > 32 issues wgmma (HGMMA) and its small-M body mma.sync
# (HMMA), SMM's body for M > 32 wgmma, the mixed kernel's bf16 body
# mma.sync.
TENSOR_CORE_SASS = {"dmm": ("HGMMA", "HMMA"), "smm": ("HGMMA",),
                    "tda_mixed": ("HMMA",)}
# The softmax's cluster regime: the cluster barrier (UCGABAR_ARV), the
# partials stored into the peers' shared memory (STAS: st.async) and the
# mbarrier waits that count them in (SYNCS.PHASECHK).
CLUSTER_SASS = {"afu": ("UCGABAR_ARV", "STAS", "SYNCS.PHASECHK")}


def phase_build():
    """Build every kernel library, report ptxas's registers, shared memory
    and spills, and count the tensor-core and cluster instructions in the
    SASS of the libraries that must have them (``cuobjdump -sass``)."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = {}
    for name, ops in (*TENSOR_CORE_SASS.items(), *CLUSTER_SASS.items()):
        dump = subprocess.run([str(cuobjdump), "-sass",
                               str(build._lib_path(name))],
                              capture_output=True, text=True,
                              timeout=120).stdout
        sass[name] = {op: sum(
            any(tok.startswith(op) for tok in ln.split()[1:3])
            for ln in dump.splitlines() if ln.strip().startswith("/*"))
            for op in ops}
        for op in ops:
            if not sass[name][op]:
                fail(f"{name}: no {op} instruction in its SASS")
    line("build", seconds=round(time.perf_counter() - t0, 3),
         kernels=sorted(build.SOURCES),
         tensor_core_sass={n: sass[n] for n in TENSOR_CORE_SASS},
         cluster_sass={n: sass[n] for n in CLUSTER_SASS},
         ptxas={n: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for n, v in log.items()})


def phase_kernels(torch, np, full_cfg, engine_kw):
    import torch.nn.functional as F
    from repro_torch.kernels.afu.ref import exp_lut_table
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ops import gather_paged_lanes as gather
    from repro_torch.kernels.tda.ref import (decode_attention_lut,
                                             decode_attention_reference,
                                             mixed_attention_lut,
                                             mixed_attention_reference)
    from repro_torch.models.layers import kv_dequantize, kv_quantize
    dev = torch.device("cuda")
    table = exp_lut_table(dev)

    def T(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return x if dt is None or x.dtype == torch.int32 else x.to(dt)

    def opt_gather(t, bt):
        return None if t is None else gather(t, bt)

    # Plain versions: the ref.py oracle (LUT: the blockwise LUT recurrence,
    # one page a block for paged lanes) over gathered lanes. Each kernel is
    # compared on what it must compute (attended decode rows, live mixed
    # columns) and must write exact zeros elsewhere.
    def plain_decode(q, k, v, bounds, bt, ks=None, vs=None, lut=False):
        if lut:
            return decode_attention_lut(q, gather(k, bt), gather(v, bt),
                                        bounds, table, k.shape[1],
                                        opt_gather(ks, bt), opt_gather(vs, bt))
        return plain_contig(q, gather(k, bt), gather(v, bt), bounds,
                            opt_gather(ks, bt), opt_gather(vs, bt))

    def plain_contig(q, k, v, bounds, ks=None, vs=None, block_k=None):
        if block_k:
            return decode_attention_lut(q, k, v, bounds, table,
                                        min(block_k, k.shape[1]), ks, vs)
        hi, lo = bounds[:, 1:].long(), bounds[:, :1].long()
        return decode_attention_reference(q, k, v, hi, k_scale=ks,
                                          v_scale=vs, window=hi - lo)

    def plain_mixed(q, k, v, kr, vr, bounds, bt, ks=None, vs=None, lut=False,
                    block=None, **kw):
        lanes = (q, gather(k, bt), gather(v, bt), kr, vr, bounds[:, 0],
                 bounds[:, 1])
        sc = dict(k_scale=opt_gather(ks, bt), v_scale=opt_gather(vs, bt))
        if lut:  # LUT blocks: one page each (``block`` for a control)
            return mixed_attention_lut(*lanes, page_size=block or k.shape[1],
                                       table=table, **sc, **kw)
        return mixed_attention_reference(*lanes, **sc, **kw)

    def diff(got, plain, live):
        return (got - plain)[live].abs().max().item() if live.any() else 0.0

    def check(name, got, plain, live):
        e, lim = diff(got, plain, live), LUT_TOL if ".lut" in name else TOL
        err[name] = max(err[name], e)
        if not e <= lim or got[~live].any().item():
            fail(f"{name} vs plain: max abs diff {e} (limit {lim}); zeros "
                 f"outside the live part: {not got[~live].any().item()}")

    # Negative controls at full width: outputs a wrong kernel would give
    # (exact exp; LUT blocks of LUT_CONTROL_BLOCK positions) must miss the
    # LUT plain version by more than LUT_TOL on the same inputs.
    controls = {}

    def control(name, what, wrong, plain, live):
        e = diff(wrong, plain, live)
        controls.setdefault(name, {})[what] = e
        if not e > LUT_TOL:
            fail(f"{name}: the {what} control is within {LUT_TOL} of the "
                 f"LUT plain version ({e}): the check cannot tell them apart")

    # Rows no serve runs (the LUT and int8-mixed variants) take the launches
    # of their full-width check below.
    check_only = ("tda_decode_attention.lut", "tda_decode_attention.int8.lut",
                  "tda_paged_decode_attention.lut",
                  "tda_paged_decode_attention.int8.lut",
                  "tda_mixed_attention.lut", "tda_mixed_attention.int8",
                  "tda_mixed_attention.int8.lut")
    err = dict.fromkeys(
        ("tda_paged_decode_attention", "tda_mixed_attention",
         "tda_decode_attention", "tda_decode_attention.int8",
         "tda_paged_decode_attention.int8") + check_only, 0.0)
    tda.reset_launch_counts()
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for case in small_decode_cases(np):
            args = [T(a, dt) for a in case]
            live = args[3][:, 1] > args[3][:, 0]
            # fp pools, then int8 pools (codes of the same values) through
            # the same table; exact and LUT exp
            q, k, v, bounds, bt = args
            kq, ks = kv_quantize(T(case[1]))
            vq, vs = kv_quantize(T(case[2]))
            for suffix, pool in (("", (k, v)), (".int8", (kq, vq, ks, vs))):
                for lut in (False, True):
                    tab = table if lut else None
                    sc = pool[2:] or (None, None)
                    check("tda_paged_decode_attention" + suffix
                          + (".lut" if lut else ""),
                          tda.tda_paged_decode_attention(
                              q, *pool[:2], bounds, bt, *sc, tab),
                          plain_decode(q, *pool[:2], bounds, bt, *sc, lut),
                          live)
                    n_cases += 1
        for case in small_contig_cases(np):
            q, k, v, bounds = [T(a, dt) for a in case]
            live = bounds[:, 1] > bounds[:, 0]
            kq, ks = kv_quantize(T(case[1]))
            vq, vs = kv_quantize(T(case[2]))
            for suffix, lanes in (("", (k, v)), (".int8", (kq, vq, ks, vs))):
                sc = lanes[2:] or (None, None)
                check("tda_decode_attention" + suffix,
                      tda.tda_decode_attention(q, *lanes[:2], bounds, *sc),
                      plain_contig(q, *lanes[:2], bounds, *sc), live)
                for bk in (16, 128):  # LUT blocks: several, or one lane
                    check("tda_decode_attention" + suffix + ".lut",
                          tda.tda_decode_attention(q, *lanes[:2], bounds,
                                                   *sc, table, block_k=bk),
                          plain_contig(q, *lanes[:2], bounds, *sc, bk), live)
                n_cases += 3
        for case, kw in small_mixed_cases(np):
            q, k, v, kr, vr, bnd, bt = [T(a, dt) for a in case]
            live = torch.arange(q.shape[1], device=dev)[None] < bnd[:, 1:]
            kq, ks = kv_quantize(T(case[1]))
            vq, vs = kv_quantize(T(case[2]))
            for name, pool, lut in (
                    ("tda_mixed_attention", (k, v, None, None), False),
                    ("tda_mixed_attention.lut", (k, v, None, None), True),
                    ("tda_mixed_attention.int8", (kq, vq, ks, vs), False),
                    ("tda_mixed_attention.int8.lut", (kq, vq, ks, vs), True)):
                check(name, tda.tda_mixed_attention(
                    q, *pool[:2], kr, vr, bnd, bt, *pool[2:],
                    table if lut else None, **kw),
                    plain_mixed(q, *pool[:2], kr, vr, bnd, bt, *pool[2:],
                                lut, **kw), live)
                n_cases += 1
    torch.cuda.synchronize()
    line("kernels_small", cases=n_cases, max_abs_err=err)

    # Tile edges of the tensor-core mixed body (bf16 q), every variant.
    edge_err, n_edge = {}, 0
    for case, kw in mixed_tile_cases(np):
        q, k, v, kr, vr, bnd, bt = [T(a, torch.bfloat16) for a in case]
        live = torch.arange(q.shape[1], device=dev)[None] < bnd[:, 1:]
        kq, ks = kv_quantize(T(case[1]))
        vq, vs = kv_quantize(T(case[2]))
        for name, pool, lut in (
                ("tda_mixed_attention", (k, v, None, None), False),
                ("tda_mixed_attention.lut", (k, v, None, None), True),
                ("tda_mixed_attention.int8", (kq, vq, ks, vs), False),
                ("tda_mixed_attention.int8.lut", (kq, vq, ks, vs), True)):
            got = tda.tda_mixed_attention(q, *pool[:2], kr, vr, bnd, bt,
                                          *pool[2:], table if lut else None,
                                          **kw)
            plain = plain_mixed(q, *pool[:2], kr, vr, bnd, bt, *pool[2:],
                                lut, **kw)
            edge_err[name] = max(edge_err.get(name, 0.0),
                                 diff(got, plain, live))
            check(name, got, plain, live)
            n_edge += 1
    torch.cuda.synchronize()
    line("kernels_tile_edges", cases=n_edge, max_abs_err=edge_err,
         limits={"exact": TOL, "lut": LUT_TOL})

    # Aliased pages (prefix sharing): slots mapping the same physical
    # pages, a copy-on-write private tail, chunks starting at n_shared.
    alias_err, n_alias = {}, 0
    Hq, Hkv, D = full_cfg.n_heads, full_cfg.kv_heads, full_cfg.head_dim
    for (hq, hkv, d, ps, S), dts in (((4, 2, 16, 8, 8),
                                      (torch.float32, torch.bfloat16)),
                                     ((Hq, Hkv, D, 128, engine_kw["max_len"]),
                                      (torch.bfloat16,))):
        dec, mix = aliased_cases(np, hq, hkv, d, ps, S)
        for dt in dts:
            q1, k, v, bounds, bt = [T(a, dt) for a in dec]
            live = bounds[:, 1] > bounds[:, 0]
            kq, ks = kv_quantize(T(dec[1]))
            vq, vs = kv_quantize(T(dec[2]))
            for name, pool in (("tda_paged_decode_attention", (k, v)),
                               ("tda_paged_decode_attention.int8",
                                (kq, vq, ks, vs))):
                sc = pool[2:] or (None, None)
                got = tda.tda_paged_decode_attention(q1, *pool[:2], bounds,
                                                     bt, *sc)
                plain = plain_decode(q1, *pool[:2], bounds, bt, *sc)
                alias_err[name] = max(alias_err.get(name, 0.0),
                                      diff(got, plain, live))
                check(name, got, plain, live)
                n_alias += 1
            q, k, v, kr, vr, bnd, bt = [T(a, dt) for a in mix]
            mlive = torch.arange(q.shape[1], device=dev)[None] < bnd[:, 1:]
            ring = bt.shape[1] * ps
            got = tda.tda_mixed_attention(q, k, v, kr, vr, bnd, bt,
                                          ring=ring)
            plain = plain_mixed(q, k, v, kr, vr, bnd, bt, ring=ring)
            alias_err["tda_mixed_attention"] = max(
                alias_err.get("tda_mixed_attention", 0.0),
                diff(got, plain, mlive))
            check("tda_mixed_attention", got, plain, mlive)
            n_alias += 1
    torch.cuda.synchronize()
    line("kernels_aliased_pages", cases=n_alias, max_abs_err=alias_err,
         limit=TOL)

    # Full-width shapes of phase 4, bf16 as the main path runs them.
    bf = torch.bfloat16
    cache_len = engine_kw["max_len"] * 2 + engine_kw["max_new_tokens"]
    dec, mix = full_cases(np, full_cfg, engine_kw["num_slots"],
                          cache_len, 128, engine_kw["max_len"])
    Hq, Hkv, D = full_cfg.n_heads, full_cfg.kv_heads, full_cfg.head_dim
    rows = []

    def checked(name, fn, plain, live):
        """Check one full-width call; returns the launches it made."""
        n0 = tda.VARIANT_LAUNCHES[name]
        got = fn()
        n = tda.VARIANT_LAUNCHES[name] - n0
        check(name, got, plain(), live)
        return n

    def add_row(name, src, repl, fn, plain, library, lib_label, nbytes,
                flops, shape, launches, plain_reps=20, device=False):
        """Time a checked kernel and its yardsticks (``device``: also the
        kernel's and the library call's device time alone); rows no serve
        runs take the launches of their full-width check."""
        bms, by = bound(nbytes, flops, 2)
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": repl}
        if name in check_only:
            row.update(launches=launches, launches_from="check")
        row.update({
            "ms": time_ms(torch, fn),
            "plain_ms": time_ms(torch, plain, plain_reps),
            "library_ms": time_ms(torch, library), "library": lib_label,
            "bound_ms": bms, "bound_by": by, "shape": shape})
        if device:
            row.update(device_ms=device_ms(torch, fn),
                       library_device_ms=device_ms(torch, library))
        rows.append(row)
        return row

    # --- decode: every slot attends [0, length); all rows live. Paged
    # (128-token pages) and contiguous lanes of cache_len (544) positions,
    # the engine's layouts; bf16, then int8 codes of the same values with
    # q in bf16; exact exp, then the LUT exp (contiguous: the reference's
    # block_k 128).
    q, k, v, bounds, bt = [T(a, bf) for a in dec]
    lens = dec[3][:, 1] - dec[3][:, 0]
    tokens = int(lens.sum())
    B = int(q.shape[0])
    live = bounds[:, 1] > bounds[:, 0]
    qo_bytes = q.numel() * 2 + B * Hq * D * 4 + bounds.numel() * 4
    kl = gather(k, bt)[:, :cache_len].contiguous()
    vl = gather(v, bt)[:, :cache_len].contiguous()
    pos = torch.arange(cache_len, device=dev)
    lmask = ((pos[None] >= bounds[:, :1]) & (pos[None] < bounds[:, 1:]))[
        :, None, None, :]
    kq, ks = kv_quantize(kl)
    vq, vs = kv_quantize(vl)
    kpq, kps = kv_quantize(k)
    vpq, vps = kv_quantize(v)
    # SDPA yardsticks (exact exp) over bf16 lanes; the int8 ones over lanes
    # dequantized beforehand (untimed)
    sdpa_in = {"fp": (kl, vl), "int8": (kv_dequantize(kq, ks, bf),
                                        kv_dequantize(vq, vs, bf)),
               "paged_int8": (kv_dequantize(gather(kpq, bt), gather(kps, bt),
                                            bf)[:, :cache_len],
                              kv_dequantize(gather(vpq, bt), gather(vps, bt),
                                            bf)[:, :cache_len])}

    def sdpa(which):
        kk, vv = (t.permute(0, 2, 1, 3) for t in sdpa_in[which])
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=lmask, enable_gqa=True)

    paged = {"page_size": int(k.shape[1]), "pool_pages": int(k.shape[0])}
    fp_b, q8_b = Hkv * D * 2 * 2, Hkv * (D + 4) * 2
    # contiguous lanes of each variant's values (by its SDPA key), for the
    # block-partition control
    contig = {"fp": (kl, vl), "int8": (kq, vq, ks, vs),
              "paged_int8": (kq, vq, ks, vs)}
    variants = (  # name, lanes (k, v[, ks, vs]), paged, LUT, SDPA
        ("tda_paged_decode_attention", (k, v), True, False, "fp"),
        ("tda_decode_attention", (kl, vl), False, False, "fp"),
        ("tda_decode_attention.int8", (kq, vq, ks, vs), False, False, "int8"),
        ("tda_paged_decode_attention.int8", (kpq, vpq, kps, vps), True, False,
         "paged_int8"),
        ("tda_decode_attention.lut", (kl, vl), False, True, "fp"),
        ("tda_decode_attention.int8.lut", (kq, vq, ks, vs), False, True,
         "int8"),
        ("tda_paged_decode_attention.lut", (k, v), True, True, "fp"),
        ("tda_paged_decode_attention.int8.lut", (kpq, vpq, kps, vps), True,
         True, "paged_int8"))
    for name, lanes, is_paged, lut, lib in variants:
        sc = lanes[2:] or (None, None)
        tab = table if lut else None
        if is_paged:
            fn = (lambda lanes=lanes, sc=sc, tab=tab:
                  tda.tda_paged_decode_attention(q, *lanes[:2], bounds, bt,
                                                 *sc, tab))
            plain = (lambda lanes=lanes, sc=sc, lut=lut: plain_decode(
                q, *lanes[:2], bounds, bt, *sc, lut))
        else:
            fn = (lambda lanes=lanes, sc=sc, tab=tab:
                  tda.tda_decode_attention(q, *lanes[:2], bounds, *sc, tab,
                                           block_k=128))
            plain = (lambda lanes=lanes, sc=sc, lut=lut: plain_contig(
                q, *lanes[:2], bounds, *sc, 128 if lut else None))
        launches = checked(name, fn, plain, live)
        if lut:
            want = plain()
            exact = (tda.tda_paged_decode_attention(q, *lanes[:2], bounds, bt,
                                                    *sc) if is_paged else
                     tda.tda_decode_attention(q, *lanes[:2], bounds, *sc))
            control(name, "exact_exp", exact, want, live)
            cl = contig[lib]
            control(name, f"block_{LUT_CONTROL_BLOCK}",
                    tda.tda_decode_attention(
                        q, *cl[:2], bounds, *(cl[2:] or (None, None)),
                        table, block_k=LUT_CONTROL_BLOCK), want, live)
        quant = len(lanes) == 4
        dtype = ("int8 k/v + f32 scales, bf16 q" if quant else "bfloat16") \
            + (", LUT exp" if lut else "")
        add_row(name, "tda_paged_decode.cu" if is_paged else "tda_decode.cu",
                "src/repro/kernels/tda/tda.py:" + ("220" if is_paged
                                                   else "168"),
                fn, plain, sdpa(lib),
                "SDPA over " + ("bf16 lanes" if lib == "fp" else
                                "lanes dequantized to bf16 beforehand "
                                "(untimed)") + (" (exact exp)" if lut else ""),
                tokens * (q8_b if quant else fp_b) + qo_bytes
                + (bt.numel() * 4 if is_paged else 0),
                4 * tokens * Hq * D,
                {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D,
                 "lane": paged if is_paged else int(cache_len),
                 "tokens_attended": tokens, "dtype": dtype}, launches,
                device=True)
    del kl, vl, kq, vq, kpq, vpq, sdpa_in, contig

    # --- mixed step: the bf16 pool, then int8 codes of the same values
    # (the chunk stays bf16); exact and LUT exp.
    q, k, v, kr, vr, bnd, bt = [T(a, bf) for a in mix]
    ring = cache_len
    S = q.shape[1]
    cols = torch.arange(S, device=dev)
    mlive = cols[None] < bnd[:, 1:]
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    # The bound counts the live work only: a row's cache keys are read only
    # when it has a live column (n_new > 0), and only live columns' queries
    # and outputs count; an int8 pool moves 1-byte codes plus a 4-byte
    # scale per head row. The kernel's zero-writes of unread columns are its
    # own cost, not the function's.
    ci, nn = mix[5][:, 0].astype(np.int64), mix[5][:, 1].astype(np.int64)
    cache_keys = np.where(nn > 0, np.minimum(ci, ring), 0)
    keys = int((nn * cache_keys + nn * (nn + 1) // 2).sum())  # per live column
    live_cols = int(nn.sum())
    r = torch.arange(bt.shape[1] * k.shape[1], device=dev)
    cit, nnt = bnd[:, :1].long(), bnd[:, 1:].long()
    cmask = (r[None] < torch.clamp(cit, max=ring))[:, None, :].expand(-1, S,
                                                                      -1)
    rmask = (cols[None, :, None] >= cols[None, None, :]) & \
        (cols[None, None, :] < nnt[:, :, None])
    fmask = torch.cat([cmask, rmask], -1)
    fmask = fmask | ~fmask.any(-1, keepdim=True)  # no all-masked rows
    sq = q.permute(0, 2, 1, 3)
    for name, pool, lut in (
            ("tda_mixed_attention", (k, v, None, None), False),
            ("tda_mixed_attention.lut", (k, v, None, None), True),
            ("tda_mixed_attention.int8", (kq, vq, ks, vs), False),
            ("tda_mixed_attention.int8.lut", (kq, vq, ks, vs), True)):
        tab = table if lut else None
        fn = (lambda pool=pool, tab=tab: tda.tda_mixed_attention(
            q, *pool[:2], kr, vr, bnd, bt, *pool[2:], tab, ring=ring))
        plain = (lambda pool=pool, lut=lut: plain_mixed(
            q, *pool[:2], kr, vr, bnd, bt, *pool[2:], lut, ring=ring))
        launches = checked(name, fn, plain, mlive)
        if lut:
            want = plain()
            control(name, "exact_exp", tda.tda_mixed_attention(
                q, *pool[:2], kr, vr, bnd, bt, *pool[2:], ring=ring), want,
                mlive)
            control(name, f"block_{LUT_CONTROL_BLOCK}", plain_mixed(
                q, *pool[:2], kr, vr, bnd, bt, *pool[2:], True,
                LUT_CONTROL_BLOCK, ring=ring), want, mlive)
        quant = pool[2] is not None
        kl, vl = (gather(t, bt) if not quant else
                  kv_dequantize(gather(t, bt), gather(s, bt), bf)
                  for t, s in ((pool[0], pool[2]), (pool[1], pool[3])))
        keys_all = torch.cat([kl, kr], 1).permute(0, 2, 1, 3)
        vals_all = torch.cat([vl, vr], 1).permute(0, 2, 1, 3)
        nbytes = int(cache_keys.sum()) * (q8_b if quant else fp_b) \
            + live_cols * fp_b + live_cols * Hq * D * (2 + 4) \
            + bnd.numel() * 4 + bt.numel() * 4
        add_row(name, "tda_mixed.cu", "src/repro/kernels/tda/tda.py:391", fn,
                plain, lambda ka=keys_all, va=vals_all:
                F.scaled_dot_product_attention(
                    sq, ka, va, attn_mask=fmask[:, None], enable_gqa=True),
                "SDPA over " + ("lanes dequantized to bf16 beforehand "
                                "(untimed)" if quant else "bf16 lanes")
                + " and the chunk" + (" (exact exp)" if lut else ""),
                nbytes, 4 * keys * Hq * D,
                {"B": B, "S": int(S), "Hq": Hq, "Hkv": Hkv, "D": D,
                 "rows_ci_nnew": mix[5].tolist(), "live_columns": live_cols,
                 "bound_bytes": nbytes, "live_query_key_pairs_per_head": keys,
                 "dtype": ("int8 pool + f32 scales, bf16 q and chunk"
                           if quant else "bfloat16")
                 + (", LUT exp" if lut else "")}, launches, plain_reps=5,
                device=True)
        del kl, vl, keys_all, vals_all
    del q, k, v, kr, vr, kq, vq, ks, vs, sq, fmask
    ring_rows(torch, np, err, check, add_row, gather)
    moe_rows(torch, np, err, check, add_row, gather, T, plain_mixed, table)
    d256_rows(torch, np, err, check, add_row, gather, T, table,
              plain_decode, plain_contig)
    tp_rows(torch, np, err, check, add_row, gather, T, plain_mixed)
    for row in rows:
        row["max_abs_err"] = err[row["name"]]
    torch.cuda.synchronize()
    line("kernels_full", controls=controls, limits={"exact": TOL,
                                                    "lut": LUT_TOL},
         **{r["name"]: {k: r[k] for k in (
             "ms", "device_ms", "plain_ms", "library_ms",
             "library_device_ms", "library", "bound_ms", "bound_by",
             "max_abs_err", "shape", "skip_mode_ms", "skip_mode_device_ms")
             if k in r} for r in rows})
    return rows


# The ring serve's attention at G = 12 (starcoder2-15b: 48 q / 4 kv heads
# of 128) and at G = 10 (40 over 4): 8 slots, rings of 4096 positions (32
# pages of 128). Decode: lanes that wrapped attend their whole ring (hi =
# min(len + 1, ring) = 4096), beside partial ones. Mixed (window 4096):
# a fresh chunk, a second chunk up to the ring's end, a chunk that wraps
# (positions 4096..6143 onto lane positions 0..2047), a short chunk past
# the ring, decode rows before and after the wrap, an inert row.
RING_DECODE_HI = (4096, 4096, 4096, 4096, 1000, 4096, 300, 2500)
RING_MIXED_ROWS = ((0, 2048), (2048, 2048), (4096, 2048), (4500, 500),
                   (4100, 1), (5000, 1), (300, 1), (90, 0))
RING_GROUPS = ((48, "g12"), (40, "g10"))  # (Hq over 4 kv heads, suffix)


def ring_rows(torch, np, err, check, add_row, gather):
    """Kernels-line rows of the decode kernels (paged and contiguous) and
    the mixed kernel at the ring serve's shapes, G = 12 and G = 10, bf16,
    each checked against its plain version (the limits of phase 2, exact
    zeros off the live part) and timed beside SDPA over the same lanes and
    masks. Each row carries the launches of its check here; main gives
    the G = 12 paged-decode and mixed rows the ring serve's instead."""
    import torch.nn.functional as F
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ref import (_mixed_masks,
                                             decode_attention_reference,
                                             mixed_attention_reference)
    from repro_torch.launch.profile_serve import RING_ENGINE_KW, ring_config
    rcfg = ring_config()
    Hkv, D = rcfg.kv_heads, rcfg.head_dim
    ps, B = RING_ENGINE_KW["page_size"], RING_ENGINE_KW["num_slots"]
    ring, S = rcfg.sliding_window, RING_ENGINE_KW["prefill_budget"]
    n = ring // ps
    P = B * n + 5
    bf = torch.bfloat16
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    bt = torch.from_numpy(rng.permutation(P)[:B * n].reshape(B, n).astype(
        np.int32)).to(dev)
    k = torch.randn((P, ps, Hkv, D), device=dev).to(bf)
    v = torch.randn((P, ps, Hkv, D), device=dev).to(bf)
    kl, vl = gather(k, bt).contiguous(), gather(v, bt).contiguous()
    hi = torch.tensor(RING_DECODE_HI, dtype=torch.int32, device=dev)
    bounds = torch.stack([torch.zeros_like(hi), hi], 1).contiguous()
    tokens = int(hi.sum())
    pos = torch.arange(ring, device=dev)
    lmask = (pos[None] < hi[:, None].long())[:, None, None, :]
    fp_b = Hkv * D * 2 * 2
    mrows = torch.tensor(RING_MIXED_ROWS, dtype=torch.int32, device=dev)
    ci, nn = mrows[:, :1].long(), mrows[:, 1:].long()
    cols = torch.arange(S, device=dev)
    mlive = cols[None] < nn
    cache_valid, row_valid = _mixed_masks(ci, nn, S, ring, ring, ring)
    pairs = int((cache_valid & mlive[:, :, None]).sum()
                + (row_valid & mlive[:, :, None]).sum())
    fmask = torch.cat([cache_valid, row_valid], -1)
    fmask = fmask | ~fmask.any(-1, keepdim=True)  # no all-masked rows
    live_cols = int(nn.sum())
    read_keys = int(torch.where(nn > 0, torch.clamp(ci, max=ring), 0).sum())
    kr = torch.randn((B, S, Hkv, D), device=dev).to(bf)
    vr = torch.randn((B, S, Hkv, D), device=dev).to(bf)
    keys_all = torch.cat([kl, kr], 1).permute(0, 2, 1, 3)
    vals_all = torch.cat([vl, vr], 1).permute(0, 2, 1, 3)
    repl = {"paged": "src/repro/kernels/tda/tda.py:220",
            "contig": "src/repro/kernels/tda/tda.py:168",
            "mixed": "src/repro/kernels/tda/tda.py:391"}
    for Hq, suffix in RING_GROUPS:
        q1 = torch.randn((B, Hq, D), device=dev).to(bf)
        qo = q1.numel() * 2 + B * Hq * D * 4 + bounds.numel() * 4
        shape = {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "G": Hq // Hkv,
                 "group_tiles": tda.group_tiles(Hq, Hkv), "ring": ring,
                 "tokens_attended": tokens, "hi": list(RING_DECODE_HI),
                 "dtype": "bfloat16"}
        kk, vv = kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3)

        def plain(q1=q1):  # the oracle over the (gathered) lanes
            return decode_attention_reference(q1, kl, vl, hi.long()[:, None])

        for kind, name in (("paged", "tda_paged_decode_attention"),
                           ("contig", "tda_decode_attention")):
            row = f"{name}.{suffix}"
            if kind == "paged":
                fn = (lambda q1=q1: tda.tda_paged_decode_attention(
                    q1, k, v, bounds, bt))
            else:
                fn = (lambda q1=q1: tda.tda_decode_attention(
                    q1, kl, vl, bounds))
            n0 = tda.VARIANT_LAUNCHES[name]
            err[row] = 0.0
            check(row, fn(), plain(), hi > 0)
            launches = tda.VARIANT_LAUNCHES[name] - n0
            r = add_row(row, "tda_paged_decode.cu" if kind == "paged"
                    else "tda_decode.cu", repl[kind], fn, plain,
                    lambda q1=q1, kk=kk, vv=vv:
                    F.scaled_dot_product_attention(
                        q1[:, :, None], kk, vv, attn_mask=lmask,
                        enable_gqa=True),
                    "SDPA over bf16 ring lanes",
                    tokens * fp_b + qo + (bt.numel() * 4
                                          if kind == "paged" else 0),
                    4 * tokens * Hq * D,
                    dict(shape, lane={"page_size": ps, "pages": n}
                         if kind == "paged" else ring),
                    launches, device=True)
            r.update(launches=launches, launches_from="check")
        q = torch.randn((B, S, Hq, D), device=dev).to(bf)
        row = f"tda_mixed_attention.{suffix}"
        fn = (lambda q=q: tda.tda_mixed_attention(
            q, k, v, kr, vr, mrows, bt, ring=ring, window=ring))
        plain = (lambda q=q: mixed_attention_reference(
            q, kl, vl, kr, vr, mrows[:, 0], mrows[:, 1], ring=ring,
            window=ring))
        n0 = tda.VARIANT_LAUNCHES["tda_mixed_attention"]
        err[row] = 0.0
        check(row, fn(), plain(), mlive)
        launches = tda.VARIANT_LAUNCHES["tda_mixed_attention"] - n0
        sq = q.permute(0, 2, 1, 3)
        nbytes = read_keys * fp_b + live_cols * fp_b \
            + live_cols * Hq * D * (2 + 4) + mrows.numel() * 4 \
            + bt.numel() * 4
        r = add_row(row, "tda_mixed.cu", repl["mixed"], fn, plain,
                lambda sq=sq: F.scaled_dot_product_attention(
                    sq, keys_all, vals_all, attn_mask=fmask[:, None],
                    enable_gqa=True),
                "SDPA over bf16 ring lanes and the chunk", nbytes,
                4 * pairs * Hq * D,
                {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                 "G": Hq // Hkv, "ring": ring, "window": ring,
                 "rows_ci_nnew": [list(r) for r in RING_MIXED_ROWS],
                 "live_columns": live_cols, "bound_bytes": nbytes,
                 "live_query_key_pairs_per_head": pairs,
                 "dtype": "bfloat16"}, launches, plain_reps=3, device=True)
        r.update(launches=launches, launches_from="check")
        del q, sq
    torch.cuda.synchronize()


# recurrentgemma-2b's local attention at head dim 256 (10 q heads over one
# kv head: G = 10, two group tiles of 5), the decode kernels' kMaxD = 256
# instance. Checks: D 136, 192 and 256 at G 1, 5 and 10 over one kv head,
# rings of D256_RING positions in pages of 128 and 16 and contiguous, the
# split-edge rows (lanes that wrapped attend their whole ring, windows, hi
# <= lo), fp and int8 K/V, exact and LUT exp (the LUT on 128-token pages
# and contiguous blocks of 128), f32 and bf16.
D256_CASES = ((136, 1), (192, 5), (256, 10))
D256_RING = 2048


def d256_rows(torch, np, err, check, add_row, gather, T, table,
              plain_decode, plain_contig):
    """Both decode kernels at head dims past 128 against their plain
    versions (the limits of phase 2; line ``kernels_d256``), then rows
    ``.d256`` at the recurrentgemma serve's decode shape (8 slots, 10 q / 1
    kv heads of 256, lanes of 544 positions: the engine's cache_len under
    ENGINE_KW, within the 2048 window; 128-token pages), bf16, timed beside
    SDPA. main gives the rows the recurrent serves' launches."""
    import torch.nn.functional as F
    from repro_torch.kernels.tda import tda
    from repro_torch.launch.profile_serve import ENGINE_KW, recurrent_config
    from repro_torch.models.layers import kv_quantize
    dev = torch.device("cuda")
    n_cases, B = 0, 8
    names = {"paged": "tda_paged_decode_attention",
             "contig": "tda_decode_attention"}
    for dt in (torch.float32, torch.bfloat16):
        for i, (D, G) in enumerate(D256_CASES):
            rng = np.random.default_rng(70 + i)
            q = T(rng.standard_normal((B, G, D)).astype(np.float32), dt)
            for ps in (128, 16, None):  # None: contiguous lanes
                W = D256_RING
                L = tda.decode_split_plan(W, ps)
                bounds = T(split_edge_rows(np, rng, W, L, B))
                live = bounds[:, 1] > bounds[:, 0]
                if ps is None:
                    shape = (B, W, 1, D)
                else:
                    n = W // ps
                    P = B * n + 3
                    bt = T(rng.permutation(P)[:B * n].reshape(B, n).astype(
                        np.int32))
                    shape = (P, ps, 1, D)
                k = T(rng.standard_normal(shape).astype(np.float32), dt)
                v = T(rng.standard_normal(shape).astype(np.float32), dt)
                (kq, ks), (vq, vs) = kv_quantize(k.float()), \
                    kv_quantize(v.float())
                for suffix, lanes in (("", (k, v, None, None)),
                                      (".int8", (kq, vq, ks, vs))):
                    for lut in ((False, True) if ps in (128, None)
                                else (False,)):
                        tab = table if lut else None
                        kind = "contig" if ps is None else "paged"
                        name = names[kind] + ".d256" + suffix \
                            + (".lut" if lut else "")
                        err.setdefault(name, 0.0)
                        if ps is None:
                            got = tda.tda_decode_attention(
                                q, *lanes[:2], bounds, *lanes[2:], tab,
                                block_k=128)
                            want = plain_contig(q, *lanes[:2], bounds,
                                                *lanes[2:],
                                                128 if lut else None)
                        else:
                            got = tda.tda_paged_decode_attention(
                                q, *lanes[:2], bounds, bt, *lanes[2:], tab)
                            want = plain_decode(q, *lanes[:2], bounds, bt,
                                                *lanes[2:], lut)
                        check(name, got, want, live)
                        n_cases += 1
    torch.cuda.synchronize()
    line("kernels_d256", cases=n_cases, head_dims_groups=D256_CASES,
         ring=D256_RING, max_abs_err={k: v for k, v in err.items()
                                      if ".d256" in k},
         limits={"exact": TOL, "lut": LUT_TOL})
    # The timed rows: the recurrentgemma serve's decode shape.
    rcfg = recurrent_config("recurrentgemma-2b")
    Hq, Hkv, D = rcfg.n_heads, rcfg.kv_heads, rcfg.head_dim
    cache_len = 2 * ENGINE_KW["max_len"] + ENGINE_KW["max_new_tokens"]
    lane = min(rcfg.local_window, cache_len)
    bf = torch.bfloat16
    dec, _ = full_cases(np, rcfg, ENGINE_KW["num_slots"], lane, 128,
                        ENGINE_KW["max_len"])
    q, k, v, bounds, bt = [T(a, bf) for a in dec]
    live = bounds[:, 1] > bounds[:, 0]
    tokens = int((dec[3][:, 1] - dec[3][:, 0]).sum())
    kl = gather(k, bt)[:, :lane].contiguous()
    vl = gather(v, bt)[:, :lane].contiguous()
    pos = torch.arange(lane, device=dev)
    lmask = (pos[None] < bounds[:, 1:])[:, None, None, :]
    kk, vv = kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3)
    qo = q.numel() * 2 + q.shape[0] * Hq * D * 4 + bounds.numel() * 4
    fp_b = Hkv * D * 2 * 2
    shape = {"B": int(q.shape[0]), "Hq": Hq, "Hkv": Hkv, "D": D,
             "G": Hq // Hkv, "group_tiles": tda.group_tiles(Hq, Hkv),
             "tokens_attended": tokens, "dtype": "bfloat16"}

    def plain():
        return plain_contig(q, kl, vl, bounds)

    for kind, fn in (
            ("paged", lambda: tda.tda_paged_decode_attention(q, k, v, bounds,
                                                             bt)),
            ("contig", lambda: tda.tda_decode_attention(q, kl, vl, bounds))):
        row = names[kind] + ".d256"
        n0 = tda.VARIANT_LAUNCHES[names[kind]]
        check(row, fn(), plain(), live)
        launches = tda.VARIANT_LAUNCHES[names[kind]] - n0
        r = add_row(row, "tda_paged_decode.cu" if kind == "paged"
                    else "tda_decode.cu",
                    "src/repro/kernels/tda/tda.py:"
                    + ("220" if kind == "paged" else "168"), fn, plain,
                    lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kk, vv, attn_mask=lmask,
                        enable_gqa=True),
                    "SDPA over bf16 lanes", tokens * fp_b + qo
                    + (bt.numel() * 4 if kind == "paged" else 0),
                    4 * tokens * Hq * D,
                    dict(shape, lane={"page_size": 128,
                                      "pages": int(bt.shape[1])}
                         if kind == "paged" else lane), launches,
                    device=True)
        r.update(launches=launches, launches_from="check")
    del q, k, v, kl, vl, kk, vv
    torch.cuda.synchronize()


def moe_rows(torch, np, err, check, add_row, gather, T, plain_mixed, table):
    """The mixed kernel's all-columns mode (routed MoE stacks compute every
    column of the step) against its plain version on every column that has
    a key, exact zeros on those with none: the small and tile-edge cases
    of phase 2 (f32 and bf16; fp and int8 pools; exact and LUT exp;
    windows, short rings, dead and inert rows; line
    ``kernels_all_columns``). Then the kernels-line rows at the MoE
    serve's shapes (``profile_serve.moe_config``: 48 q / 8 kv heads of 128,
    G = 6 in one group tile; ENGINE_KW's 8 slots, 128-token pages, chunks
    of 256): paged decode (``tda_paged_decode_attention.g6``) and the
    mixed step in the all-columns mode (``tda_mixed_attention.g6``, checked
    on every column, with the skip mode's time at the same shape beside
    it), each timed beside SDPA. main gives both rows the MoE serve's
    launches."""
    import torch.nn.functional as F
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ref import (_mixed_masks,
                                             decode_attention_reference)
    from repro_torch.launch.profile_serve import ENGINE_KW, moe_config
    from repro_torch.models.layers import kv_quantize
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def keyed(bnd, S, W, ring, window):
        cv, rv = _mixed_masks(bnd[:, :1].long(), bnd[:, 1:].long(), S, W,
                              ring, window)
        return cv.any(-1) | rv.any(-1), cv, rv

    n_cases, allc = 0, {}
    cases = [(c, kw, dt) for dt in (torch.float32, bf)
             for c, kw in small_mixed_cases(np)]
    cases += [(c, kw, bf) for c, kw in mixed_tile_cases(np)]
    for case, kw, dt in cases:
        q, k, v, kr, vr, bnd, bt = [T(a, dt) for a in case]
        live, _, _ = keyed(bnd, q.shape[1], bt.shape[1] * k.shape[1],
                           kw["ring"], kw["window"])
        kq, ks = kv_quantize(T(case[1]))
        vq, vs = kv_quantize(T(case[2]))
        for suffix, pool, lut in (
                ("", (k, v, None, None), False),
                (".lut", (k, v, None, None), True),
                (".int8", (kq, vq, ks, vs), False),
                (".int8.lut", (kq, vq, ks, vs), True)):
            name = "tda_mixed_attention.all_columns" + suffix
            err.setdefault(name, 0.0)
            check(name, tda.tda_mixed_attention(
                q, *pool[:2], kr, vr, bnd, bt, *pool[2:],
                table if lut else None, all_columns=True, **kw),
                plain_mixed(q, *pool[:2], kr, vr, bnd, bt, *pool[2:], lut,
                            **kw), live)
            allc[name] = err[name]
            n_cases += 1
    torch.cuda.synchronize()
    line("kernels_all_columns", cases=n_cases, max_abs_err=allc,
         limits={"exact": TOL, "lut": LUT_TOL},
         launches=tda.MODE_LAUNCHES["tda_mixed_attention.all_columns"])

    cfg, kw = moe_config(), ENGINE_KW
    cache_len = kw["max_len"] * 2 + kw["max_new_tokens"]
    dec, mix = full_cases(np, cfg, kw["num_slots"], cache_len, 128,
                          kw["max_len"])
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    fp_b = Hkv * D * 2 * 2
    repl = "src/repro/kernels/tda/tda.py:"
    # --- paged decode at G = 6
    q1, k, v, bounds, bt = [T(a, bf) for a in dec]
    B = int(q1.shape[0])
    hi = bounds[:, 1:].long()
    tokens = int(hi.sum())
    kl, vl = gather(k, bt)[:, :cache_len], gather(v, bt)[:, :cache_len]
    pos = torch.arange(cache_len, device=dev)
    lmask = (pos[None] < hi)[:, None, None, :]
    kk, vv = kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3)
    name = "tda_paged_decode_attention.g6"
    err[name] = 0.0
    n0 = tda.VARIANT_LAUNCHES["tda_paged_decode_attention"]

    def fn():
        return tda.tda_paged_decode_attention(q1, k, v, bounds, bt)

    def plain():
        return decode_attention_reference(q1, kl, vl, hi)

    check(name, fn(), plain(), hi[:, 0] > 0)
    r = add_row(name, "tda_paged_decode.cu", repl + "220", fn, plain,
                lambda: F.scaled_dot_product_attention(
                    q1[:, :, None], kk, vv, attn_mask=lmask,
                    enable_gqa=True),
                "SDPA over bf16 lanes",
                tokens * fp_b + q1.numel() * 2 + B * Hq * D * 4
                + bounds.numel() * 4 + bt.numel() * 4,
                4 * tokens * Hq * D,
                {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "G": Hq // Hkv,
                 "group_tiles": tda.group_tiles(Hq, Hkv),
                 "lane": {"page_size": int(k.shape[1]),
                          "pool_pages": int(k.shape[0])},
                 "tokens_attended": tokens, "dtype": "bfloat16"},
                tda.VARIANT_LAUNCHES["tda_paged_decode_attention"] - n0,
                device=True)
    r.update(launches_from="check")
    del kl, vl, kk, vv
    # --- mixed step at G = 6, every column computed
    q, k, v, kr, vr, bnd, bt = [T(a, bf) for a in mix]
    S, W = int(q.shape[1]), bt.shape[1] * k.shape[1]
    ring = cache_len
    live, cv, rv = keyed(bnd, S, W, ring, None)
    name = "tda_mixed_attention.g6"
    err[name] = 0.0
    n0 = tda.VARIANT_LAUNCHES["tda_mixed_attention"]

    def mfn(all_columns=True):
        return tda.tda_mixed_attention(q, k, v, kr, vr, bnd, bt, ring=ring,
                                       all_columns=all_columns)

    def mplain():
        return plain_mixed(q, k, v, kr, vr, bnd, bt, ring=ring)

    check(name, mfn(), mplain(), live)
    launches = tda.VARIANT_LAUNCHES["tda_mixed_attention"] - n0
    ci, nn = mix[5][:, 0].astype(np.int64), mix[5][:, 1].astype(np.int64)
    keyed_rows = (ci > 0) | (nn > 0)
    cols = int(live.sum())  # computed columns: every column of a keyed row
    nbytes = int(np.where(keyed_rows, np.minimum(ci, ring), 0).sum()) \
        * fp_b + int(nn.sum()) * fp_b + cols * Hq * D * (2 + 4) \
        + bnd.numel() * 4 + bt.numel() * 4
    pairs = int((cv & live[:, :, None]).sum() + rv.sum())
    kl, vl = gather(k, bt), gather(v, bt)
    keys_all = torch.cat([kl, kr], 1).permute(0, 2, 1, 3)
    vals_all = torch.cat([vl, vr], 1).permute(0, 2, 1, 3)
    fmask = torch.cat([cv, rv], -1)
    fmask = fmask | ~fmask.any(-1, keepdim=True)  # no all-masked rows
    sq = q.permute(0, 2, 1, 3)
    r = add_row(name, "tda_mixed.cu", repl + "391", mfn, mplain,
                lambda: F.scaled_dot_product_attention(
                    sq, keys_all, vals_all, attn_mask=fmask[:, None],
                    enable_gqa=True),
                "SDPA over bf16 lanes and the chunk (every column)", nbytes,
                4 * pairs * Hq * D,
                {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                 "G": Hq // Hkv, "mode": "all_columns",
                 "rows_ci_nnew": mix[5].tolist(), "computed_columns": cols,
                 "live_columns": int(nn.sum()), "bound_bytes": nbytes,
                 "query_key_pairs_per_head": pairs, "dtype": "bfloat16"},
                launches, plain_reps=3, device=True)
    r.update(launches_from="check",
             skip_mode_ms=time_ms(torch, lambda: mfn(False)),
             skip_mode_device_ms=device_ms(torch, lambda: mfn(False)))
    del q, k, v, kr, vr, kl, vl, keys_all, vals_all, fmask, sq
    torch.cuda.synchronize()


def tp_rows(torch, np, err, check, add_row, gather, T, plain_mixed):
    """The kernels-line rows at a rank's shapes in the tp_serve phase's
    bf16 run (b): qwen2.5-32b's 40 q / 8 kv heads of 128 cut over
    TP_BF16_RANKS ranks, 20 q / 4 kv heads a rank (G = 5), ENGINE_KW's 8
    slots, 128-token pages and chunks of 256: paged decode
    (``tda_paged_decode_attention.tp2``) and the mixed step
    (``tda_mixed_attention.tp2``), each checked against its plain version
    (attended rows, live columns) and timed beside SDPA. main gives both
    rows the launches of rank 0 of that run (``serve:tp``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.tda import tda
    from repro_torch.kernels.tda.ref import decode_attention_reference
    from repro_torch.launch.profile_serve import ENGINE_KW, serve_config
    dev = torch.device("cuda")
    bf = torch.bfloat16
    full, kw, n = serve_config(), ENGINE_KW, TP_BF16_RANKS
    cfg = dataclasses.replace(full, n_heads=full.n_heads // n,
                              n_kv_heads=full.kv_heads // n)
    cache_len = kw["max_len"] * 2 + kw["max_new_tokens"]
    dec, mix = full_cases(np, cfg, kw["num_slots"], cache_len, 128,
                          kw["max_len"])
    Hq, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    fp_b = Hkv * D * 2 * 2
    repl = "src/repro/kernels/tda/tda.py:"
    suffix = f".tp{n}"
    # --- paged decode on a rank's heads
    q1, k, v, bounds, bt = [T(a, bf) for a in dec]
    B = int(q1.shape[0])
    hi = bounds[:, 1:].long()
    tokens = int(hi.sum())
    kl, vl = gather(k, bt)[:, :cache_len], gather(v, bt)[:, :cache_len]
    pos = torch.arange(cache_len, device=dev)
    lmask = (pos[None] < hi)[:, None, None, :]
    kk, vv = kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3)
    name = "tda_paged_decode_attention" + suffix
    err[name] = 0.0

    def fn():
        return tda.tda_paged_decode_attention(q1, k, v, bounds, bt)

    def plain():
        return decode_attention_reference(q1, kl, vl, hi)

    check(name, fn(), plain(), hi[:, 0] > 0)
    add_row(name, "tda_paged_decode.cu", repl + "220", fn, plain,
            lambda: F.scaled_dot_product_attention(
                q1[:, :, None], kk, vv, attn_mask=lmask, enable_gqa=True),
            "SDPA over bf16 lanes",
            tokens * fp_b + q1.numel() * 2 + B * Hq * D * 4
            + bounds.numel() * 4 + bt.numel() * 4,
            4 * tokens * Hq * D,
            {"B": B, "Hq": Hq, "Hkv": Hkv, "D": D, "G": Hq // Hkv,
             "ranks": n, "lane": {"page_size": int(k.shape[1]),
                                  "pool_pages": int(k.shape[0])},
             "tokens_attended": tokens, "dtype": "bfloat16"}, 0,
            device=True)
    del kl, vl, kk, vv
    # --- the mixed step on a rank's heads (live columns j < n_new)
    q, k, v, kr, vr, bnd, bt = [T(a, bf) for a in mix]
    S = int(q.shape[1])
    ring = cache_len
    cols = torch.arange(S, device=dev)
    mlive = cols[None] < bnd[:, 1:]
    name = "tda_mixed_attention" + suffix
    err[name] = 0.0

    def mfn():
        return tda.tda_mixed_attention(q, k, v, kr, vr, bnd, bt, ring=ring)

    def mplain():
        return plain_mixed(q, k, v, kr, vr, bnd, bt, ring=ring)

    check(name, mfn(), mplain(), mlive)
    ci, nn = mix[5][:, 0].astype(np.int64), mix[5][:, 1].astype(np.int64)
    cache_keys = np.where(nn > 0, np.minimum(ci, ring), 0)
    keys = int((nn * cache_keys + nn * (nn + 1) // 2).sum())
    live_cols = int(nn.sum())
    r = torch.arange(bt.shape[1] * k.shape[1], device=dev)
    cit, nnt = bnd[:, :1].long(), bnd[:, 1:].long()
    cmask = (r[None] < torch.clamp(cit, max=ring))[:, None, :].expand(
        -1, S, -1)
    rmask = (cols[None, :, None] >= cols[None, None, :]) & \
        (cols[None, None, :] < nnt[:, :, None])
    fmask = torch.cat([cmask, rmask], -1)
    fmask = fmask | ~fmask.any(-1, keepdim=True)  # no all-masked rows
    kl, vl = gather(k, bt), gather(v, bt)
    keys_all = torch.cat([kl, kr], 1).permute(0, 2, 1, 3)
    vals_all = torch.cat([vl, vr], 1).permute(0, 2, 1, 3)
    sq = q.permute(0, 2, 1, 3)
    nbytes = int(cache_keys.sum()) * fp_b + live_cols * fp_b \
        + live_cols * Hq * D * (2 + 4) + bnd.numel() * 4 + bt.numel() * 4
    add_row(name, "tda_mixed.cu", repl + "391", mfn, mplain,
            lambda: F.scaled_dot_product_attention(
                sq, keys_all, vals_all, attn_mask=fmask[:, None],
                enable_gqa=True),
            "SDPA over bf16 lanes and the chunk", nbytes, 4 * keys * Hq * D,
            {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "G": Hq // Hkv,
             "ranks": n, "rows_ci_nnew": mix[5].tolist(),
             "live_columns": live_cols, "bound_bytes": nbytes,
             "live_query_key_pairs_per_head": keys, "dtype": "bfloat16"},
            0, plain_reps=5, device=True)
    del q, k, v, kr, vr, kl, vl, keys_all, vals_all, fmask, sq
    torch.cuda.synchronize()


# AFU shapes: the kernel table's softmax (256, 512); decode scores of 8
# slots x 40 heads over a 544-token lane; the LM head's rows of a decode
# step, qwen2.5's 152 064 entries (8 rows and one) and recurrentgemma's
# 256 000; the reference test's ragged edges; a row past the cluster's
# shared memory (600 001 entries, re-read); then each boundary between the
# softmax's regimes (``afu.softmax_regime``: the warp's last C and the
# block's first, the block's last and the cluster's first, the cluster's
# last staged C and the first re-read; ``phase_afu`` fails if one is
# missing). LayerNorm: the reference test's (40, 64), a decode step's 8 and
# a mixed step's 2048 tokens of d_model 5120, and a ragged edge.
SOFTMAX_SHAPES = [(256, 512), (320, 544), (8, 152064), (8, 256000),
                  (1, 152064), (7, 999), (33, 50), (2, 600001),
                  (5, 1024), (5, 1025), (3, 24576), (3, 24577),
                  (2, 393216), (2, 393217)]
LN_SHAPES = [(40, 64), (8, 5120), (2048, 5120), (7, 999)]
LN_ROW = (2048, 5120)  # the kernels-line row's shape


def phase_afu(torch):
    """The AFU kernels against their plain versions at SOFTMAX_SHAPES and
    LN_SHAPES, f32 and bf16 inputs (softmax within SOFTMAX_RTOL per
    element, LayerNorm within LN_TOL), then timed at each shape (f32
    softmax, bf16 LayerNorm as the serve's hidden states; the softmax and
    ``torch.softmax`` also by device time alone at every shape). Each
    softmax call is one launch, in the regime that the library reports for
    its C (``softmax_lut_regime``, mirrored by ``afu.softmax_regime``), and
    SOFTMAX_SHAPES holds both sides of each regime boundary. Negative
    control: the exact-exp softmax (``torch.softmax``) must miss the LUT
    plain version by more than SOFTMAX_RTOL at every shape. Returns the two
    rows: softmax at the kernel table's shape, its launches from the
    ``kernel_table`` phase; LayerNorm at LN_ROW, its launches from the
    checks at that shape (f32 and bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.afu.ref import (exp_lut_table,
                                             layernorm_residual_reference,
                                             softmax_lut_reference)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(4)
    table = exp_lut_table(dev)
    err = {"softmax_lut": 0.0, "layernorm_residual": 0.0}
    rel = {"softmax_lut": 0.0, "layernorm_residual": 0.0}  # vs the limits
    controls = {}

    def check(name, got, plain):
        e = (got - plain).abs().max().item()
        if name == "softmax_lut":
            r, lim = rel_err(got, plain), SOFTMAX_RTOL
        else:
            r, lim = e / max(1.0, plain.abs().max().item()), LN_TOL
        err[name], rel[name] = max(err[name], e), max(rel[name], r)
        if not r <= lim:
            fail(f"{name} vs plain: {r} (limit {lim}; max abs diff {e}) at "
                 f"{tuple(got.shape)}")

    cap = afu.CLUSTER * afu.SLICE_MAX
    cs = {C for _, C in SOFTMAX_SHAPES}
    for edge in (afu.WARP_MAX_C, afu.BLOCK_MAX_C, cap):
        if not {edge, edge + 1} <= cs:
            fail(f"softmax_lut: SOFTMAX_SHAPES lacks C = {edge} or "
                 f"{edge + 1}, the edge of a regime")
    afu.reset_launch_counts()
    inputs, regimes = {}, {}
    for R, C in SOFTMAX_SHAPES:
        regime = afu.softmax_regime(C)
        if afu.kernel_regime(C) != regime:
            fail(f"softmax_lut: the library's regime for C = {C} is "
                 f"{afu.kernel_regime(C)}, afu.softmax_regime's {regime}")
        regimes[f"{R}x{C}"] = regime
        x = torch.randn(R, C, generator=g, device=dev) * 4
        for xx in (x, x.to(torch.bfloat16)):
            n0 = afu.LAUNCHES["softmax_lut"]
            r0 = afu.REGIME_LAUNCHES[f"softmax_lut.{regime}"]
            got = afu.softmax_lut(xx, table)
            if (afu.LAUNCHES["softmax_lut"] - n0,
                    afu.REGIME_LAUNCHES[f"softmax_lut.{regime}"] - r0) \
                    != (1, 1):
                fail(f"softmax_lut: a call at {R}x{C} made "
                     f"{afu.LAUNCHES['softmax_lut'] - n0} launches, not one "
                     f"in regime {regime}")
            check("softmax_lut", got, softmax_lut_reference(xx, table))
        c = rel_err(torch.softmax(x, -1), softmax_lut_reference(x, table))
        controls[f"exact_exp {R}x{C}"] = c
        if not c > SOFTMAX_RTOL:
            fail(f"softmax_lut: the exact-exp control is within "
                 f"{SOFTMAX_RTOL} of the LUT plain version ({c}) at {R}x{C}")
        inputs["softmax", R, C] = x
    regime_checks = dict(afu.REGIME_LAUNCHES)  # the checks' launches
    for R, C in LN_SHAPES:
        x, res = (torch.randn(R, C, generator=g, device=dev) for _ in "xr")
        sc, bi = (torch.randn(C, generator=g, device=dev) for _ in "sb")
        n0 = afu.LAUNCHES["layernorm_residual"]
        for dt in (torch.float32, torch.bfloat16):
            args = (x.to(dt), res.to(dt), sc, bi)
            check("layernorm_residual", afu.layernorm_residual(*args),
                  layernorm_residual_reference(*args))
        if (R, C) == LN_ROW:
            ln_launches = afu.LAUNCHES["layernorm_residual"] - n0
        inputs["ln", R, C] = (x.to(torch.bfloat16), res.to(torch.bfloat16),
                              sc, bi)
    torch.cuda.synchronize()
    times = {}
    for (kind, R, C), a in inputs.items():
        if kind == "softmax":
            nbytes, ops = R * C * (4 + 4) + 256, 14 * R * C
            fn = (lambda x=a: afu.softmax_lut(x, table))
            plain = (lambda x=a: softmax_lut_reference(x, table))
            lib = (lambda x=a: torch.softmax(x.float(), -1))
        else:
            nbytes, ops = R * C * (2 * 2 + 4) + 8 * C, 8 * R * C
            fn = (lambda a=a: afu.layernorm_residual(*a))
            plain = (lambda a=a: layernorm_residual_reference(*a))
            lib = (lambda a=a: F.layer_norm(
                a[0].float() + a[1].float(), (a[0].shape[1],), a[2], a[3],
                1e-6))
        bms, by = bound(nbytes, ops, 4)
        key = f"{kind} {R}x{C}"
        times[key] = {
            "ms": time_ms(torch, fn), "plain_ms": time_ms(torch, plain, 5),
            "library_ms": time_ms(torch, lib), "bound_ms": bms,
            "bound_by": by,
            "dtype": "float32" if kind == "softmax" else "bfloat16"}
        if kind == "softmax" or key == "ln %dx%d" % LN_ROW:
            times[key].update(device_ms=device_ms(torch, fn),
                              library_device_ms=device_ms(torch, lib))
    line("afu", seconds=round(time.perf_counter() - t0, 3),
         max_abs_err=err, err_vs_limit=rel,
         limits={"softmax_rtol": SOFTMAX_RTOL, "layernorm": LN_TOL},
         controls=controls, softmax_regimes=regimes,
         regime_launches=regime_checks, **times)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    out = []
    for name, repl, key, lib in (
            ("softmax_lut", "src/repro/kernels/afu/afu.py:35",
             "softmax 256x512", "torch.softmax (exact exp: the same "
             "traffic, not the same function)"),
            ("layernorm_residual", "src/repro/kernels/afu/afu.py:61",
             "ln %dx%d" % LN_ROW, "add + F.layer_norm, timed together")):
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/afu.cu",
                    "replaces": repl, "max_abs_err": err[name],
                    **{k: times[key][k] for k in keys + (
                        "device_ms", "library_device_ms")},
                    "library": lib,
                    "shape": key.split()[1],
                    "other_shapes": {k: {kk: v[kk] for kk in keys + (
                        "device_ms", "library_device_ms") if kk in v}
                                     for k, v in times.items()
                                     if k.startswith(key.split()[0])
                                     and k != key}})
    out[1].update(launches=ln_launches, launches_from="check")
    return out


def phase_kernel_table(torch):
    """The slice's entry point: the launcher's ``kernels`` and
    ``decode_attn`` tables in-process on the card, every launch counter
    set to 0 just before and read just after. Every row must carry the
    reference's name and a finite time, the LUT softmax's error against
    the exact one must stay below 5e-3 (the reference test's bound), and
    each kernel's output in the tables is held against its plain version
    on the same inputs (``Table.outputs``): DMM and SMM within TOL x
    max(1, max |plain|) as in ``linear_kernels``, the LUT softmax within
    SOFTMAX_RTOL per element, the int8 decode kernel within TOL of the
    dense oracle. Returns the launches."""
    from repro_torch.kernels.afu import afu
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.tda import tda
    from repro_torch.launch import kernel_table
    t0 = time.perf_counter()
    mods = (afu, dmm, smm, tda)
    for mod in mods:
        mod.reset_launch_counts()
    results = kernel_table.run(kernel_table.TABLES, torch.device("cuda"))
    torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    rows = [r for t in results.values() for r in t.rows]
    want = ["kernels/dmm_lut_matmul", "kernels/smm_compressed_matmul",
            "kernels/afu_softmax_lut", "decode_attn/fused",
            "decode_attn/dense", "decode_attn/blocks"]
    errs = {}
    for name, (got, plain) in (kv for t in results.values()
                               for kv in t.outputs.items()):
        e = (got - plain).abs().max().item()
        if name == "kernels/afu_softmax_lut":
            e, lim = rel_err(got, plain), SOFTMAX_RTOL
        elif name == "decode_attn/fused":
            lim = TOL
        else:
            lim = TOL * max(1.0, plain.abs().max().item())
        errs[name] = e
        if not e <= lim:
            fail(f"kernel table {name} vs plain: {e} (limit {lim})")
    if sorted(errs) != sorted(want[:4]):
        fail(f"kernel table: outputs of {sorted(errs)}, want {want[:4]}")
    if [r[0] for r in rows] != want:
        fail(f"kernel table rows {[r[0] for r in rows]} != {want}")
    if not all(math.isfinite(us) for _, us, _ in rows):
        fail(f"kernel table: a non-finite time in {rows}")
    lut_err = results["kernels"].metrics["max_err_vs_exact"]
    if not lut_err < 5e-3:
        fail(f"kernels/afu_softmax_lut: max_err_vs_exact {lut_err} >= 5e-3")
    for name in ("dmm_matmul", "smm_matmul", "softmax_lut",
                 "tda_decode_attention"):
        if not launches[name]:
            fail(f"kernel table: {name} was not launched ({launches})")
    line("kernel_table", seconds=round(time.perf_counter() - t0, 3),
         csv=[f"{n},{us:.1f},{d}" for n, us, d in rows],
         max_err_vs_exact=lut_err, err_vs_plain=errs,
         decode_attn=results["decode_attn"].metrics, launches=launches)
    return launches


# The linear rows' yardsticks (``library_ms``): the same function as one
# PyTorch call on the densified matrix in f32; ``library_bf16_ms`` the bf16
# product on the bf16-rounded matrix (SMM: of bf16-rounded y), a
# single-pass, lower-precision product.
LINEAR_LIBRARY = {
    "dmm": "torch.matmul, f32 x on the f32 densified W (TF32 off); "
           "library_bf16_ms: bf16 x on the bf16-rounded W, a single-pass, "
           "lower-precision product",
    "smm": "torch.matmul on the f32 densified W_D (TF32 off); "
           "library_bf16_ms: bf16 y on the bf16-rounded W_D, a single-pass, "
           "lower-precision product"}


def phase_linear_kernels(torch, np, ccfg):
    """DMM and SMM against their plain versions: the CPU tests' edge cases
    and the redesigned bodies' edges (each edge launched twice, which must
    give the same bits, and counted against the body its shapes select),
    then every family's full-width shapes at M = 8 and 2048, timed by
    events (``ms``) and by the kernels' device time alone (``device_ms``)."""
    from repro_torch.core.factorized import pack_nibbles
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.dmm.ops import lut_matmul
    from repro_torch.kernels.dmm.ref import unpack_nibbles
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.smm.ops import compressed_matmul
    from repro_torch.kernels.smm.ref import densify
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    err = {"dmm_matmul": 0.0, "smm_matmul": 0.0}
    smm_op = ("smm_matmul", lambda *a, **kw: compressed_matmul(
        *a[:6], value_bits=a[6], **kw))
    ops = {"dmm": ("dmm_matmul", lut_matmul),
           "dmm_tile_edge": ("dmm_matmul", lut_matmul),
           "dmm_small_edge": ("dmm_matmul", lut_matmul),
           "smm": smm_op, "smm_edge": smm_op}
    bodies = {"dmm_matmul": dmm.BODY_LAUNCHES, "smm_matmul": smm.BODY_LAUNCHES}

    def check(kind, args):
        name, op = ops[kind]
        before = dict(bodies[name])
        got = op(*args)
        if kind.endswith("edge"):
            again = op(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{name}: a second launch on the same inputs gave other "
                     f"bits at {[tuple(a.shape) for a in args[:2]]}")
        ran = [k for k in before if bodies[name][k] != before[k]]
        plain = op(*args, use_kernel=False)
        torch.cuda.synchronize()
        e = (got - plain).abs().max().item() if got.numel() else 0.0
        lim = TOL * max(1.0, plain.abs().max().item() if got.numel() else 0)
        err[name] = max(err[name], e)
        if kind.endswith("edge"):
            key = "x".join(str(d) for d in (*args[0].shape, args[1].shape[-1]))
            if kind == "smm_edge":
                key += f"/nnz{args[3].shape[0]}/{args[2].dtype}".replace(
                    "torch.", "")
            edges.setdefault(kind, {})[key] = {
                "max_abs_err": e, "limit": lim, "body": ran}
        if not e <= lim:
            fail(f"{name} vs plain: max abs diff {e} (limit {lim}) at "
                 f"{[tuple(a.shape) for a in args if hasattr(a, 'shape')]}")
        return {"max_abs_err": e, "limit": lim, "body": ran}

    n_cases, edges = 0, {}
    for kind, args in small_linear_cases(torch, np, dev):
        check(kind, args)
        n_cases += 1
    line("linear_kernels_small", cases=n_cases, max_abs_err=dict(err),
         edges=edges)

    g = torch.Generator(device=dev).manual_seed(3)
    shapes, rows = [], {}
    for (d_in, d_out, r, nnz), fams in linear_shapes(ccfg).items():
        codes = torch.randint(0, 256, ((d_in + 1) // 2, r), generator=g,
                              device=dev, dtype=torch.uint8)
        lut = torch.sort(torch.randn(16, generator=g, device=dev)).values \
            / d_in ** 0.5
        ws_f32 = lut[unpack_nibbles(codes).long()][:d_in]
        ws_bf16 = ws_f32.to(torch.bfloat16)
        st = wd_streams(torch, torch.randn(r, d_out, generator=g,
                                           device=dev), nnz)
        # the layer's scalars as the serve passes them: 0-d device tensors
        st = st[:3] + tuple(torch.as_tensor(v, dtype=dt, device=dev).reshape(
            ()) for v, dt in zip(st[3:], (torch.float32, torch.float32,
                                          torch.int32)))
        wd_dense = densify(*st[:5], r, st[5])
        wd_bf16 = wd_dense.to(torch.bfloat16)
        rec = {"families": fams, "d_in": d_in, "d_out": d_out, "r": r,
               "nnz": nnz, "delta_dtype": str(st[1].dtype).split(".")[1]}
        for M in (8, 2048):
            x = torch.randn(M, d_in, generator=g, device=dev).to(
                torch.bfloat16)
            x32 = x.float()  # the f32 yardstick's input, made untimed
            y = torch.randn(M, r, generator=g, device=dev)
            y16 = y.to(torch.bfloat16)
            checked = {"dmm": check("dmm", (x, codes, lut)),
                       "smm": check("smm", (y,) + st)}
            dmm_b, dmm_by = bound(x.numel() * 2 + codes.numel() + 64
                                  + M * r * 4, 2 * M * d_in * r, 2)
            smm_b, smm_by = bound(
                y.numel() * 4 + d_out * 4
                + st[1].numel() * st[1].element_size() + st[2].numel()
                + M * d_out * 4, 2 * M * nnz * d_out, 4)
            calls = {
                "dmm": (lambda: lut_matmul(x, codes, lut),
                        lambda: lut_matmul(x, codes, lut, use_kernel=False),
                        lambda: torch.matmul(x32, ws_f32),
                        lambda: torch.matmul(x, ws_bf16), dmm_b, dmm_by),
                "smm": (lambda: compressed_matmul(
                            y, *st[:5], value_bits=st[5]),
                        lambda: compressed_matmul(
                            y, *st[:5], value_bits=st[5], use_kernel=False),
                        lambda: torch.matmul(y, wd_dense),
                        lambda: torch.matmul(y16, wd_bf16), smm_b, smm_by)}
            for kern, (fn, plain, lib, lib16, b, by) in calls.items():
                rec[f"{kern}_M{M}"] = {
                    "ms": time_ms(torch, fn, 10),
                    "device_ms": device_ms(torch, fn, 10),
                    "plain_ms": time_ms(torch, plain, 5),
                    "library_ms": time_ms(torch, lib, 10),
                    "library_device_ms": device_ms(torch, lib, 10),
                    "library_bf16_ms": time_ms(torch, lib16, 10),
                    "bound_ms": b, "bound_by": by, **checked[kern]}
        shapes.append(rec)
        for kern, fam in (("dmm", "ffn_down"), ("smm", "ffn_up")):
            if fam in fams:
                rows[kern] = rec
        del codes, ws_f32, ws_bf16, wd_dense, wd_bf16, st, x32, y16
    torch.cuda.synchronize()
    line("linear_kernels_full", seconds=round(time.perf_counter() - t0, 3),
         max_abs_err=dict(err), shapes=shapes)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "library_bf16_ms", "bound_ms", "bound_by")
    out = []
    for kern, name, src, repl in (
            ("dmm", "dmm_matmul", "dmm.cu",
             "src/repro/kernels/dmm/dmm.py:51"),
            ("smm", "smm_matmul", "smm.cu",
             "src/repro/kernels/smm/smm.py:63")):
        rec = rows[kern]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": repl, "max_abs_err": err[name],
               **{k: rec[f"{kern}_M2048"][k] for k in keys},
               "M8": {k: rec[f"{kern}_M8"][k] for k in keys},
               "library": LINEAR_LIBRARY[kern],
               "shape": {k: rec[k] for k in ("families", "d_in", "d_out", "r",
                                             "nnz")} | {"M": 2048}}
        out.append(row)
    return out


def decompressed(torch, cparams, params):
    """The compressed tree with every stream group replaced by its dense
    ``wd`` (``decompress_wd_leaf`` per layer) and every dictionary by its
    dense W_S (``decompress_ws_entry``): served through the plain
    factorized ``(x @ ws) @ wd``."""
    from repro_torch.core.factorized import (decompress_wd_leaf,
                                             decompress_ws_entry)

    def walk(c, p):
        if isinstance(c, dict) and "wd_vq" in c:
            r = p["wd"].shape[-2]
            out = {k: v for k, v in c.items() if not k.startswith("wd_")}
            if c["wd_vq"].dim() == 2:  # one layer's own leaf (no L axis)
                out["wd"] = decompress_wd_leaf(c, r)
                return out
            layers = [decompress_wd_leaf({k: v[i] for k, v in c.items()}, r)
                      for i in range(c["wd_vq"].shape[0])]
            out["wd"] = torch.stack(layers)
            return out
        if isinstance(c, dict):
            return {k: walk(v, p[k]) for k, v in c.items()}
        return c

    tree = {k: walk(v, params[k]) for k, v in cparams.items() if k != "dicts"}
    tree["dicts"] = {f: decompress_ws_entry(e, params["dicts"][f].shape[0])
                     for f, e in cparams["dicts"].items()}
    return tree


def phase_tokens(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import (FactorizationConfig,
                                             project_wd_leaves)
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.tda import tda
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    import numpy as np
    t0 = time.perf_counter()
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    rng = np.random.default_rng(1)
    lengths, budgets, ticks = [5, 25, 12, 18], [6, 5, 4, 6], [1, 1, 3, 6]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]

    def run(model, params, budget, **kw):
        eng = Engine(model, params, config=EngineConfig(
            max_len=16, max_new_tokens=8, num_slots=3, max_prompt_len=40,
            prefix_share=False, prefill_budget=budget, **kw))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        done = eng.run(arrivals=list(zip(ticks, reqs)))
        if sorted(r.rid for r in done) != [0, 1, 2, 3] or \
                any(r.status != "ok" for r in done):
            fail("a smoke run did not finish all requests ok")
        return {r.rid: list(r.output) for r in done}, eng.decode_stats

    model = Model(cfg)
    params = model.init(seed=0)
    checked = []
    for budget in (4, 16, None):
        outs = {}
        for mode in ("tda", "dense"):
            tda.reset_launch_counts()
            outs[mode], _ = run(model, params, budget, decode_attn=mode)
            if mode == "tda" and not (
                    tda.LAUNCHES["tda_paged_decode_attention"]
                    and tda.LAUNCHES["tda_mixed_attention"]):
                fail(f"tda engine did not launch both kernels: {tda.LAUNCHES}")
        if outs["tda"] != outs["dense"]:
            fail(f"tokens differ, kernels vs plain path (budget {budget}): "
                 f"{outs}")
        checked.append(budget)
    n_tok = sum(len(v) for v in outs["tda"].values())

    # Phase-serialized engine: contiguous and paged lanes, on the kernels
    # and on the plain path, fp (against the mixed engine's tokens), then
    # int8 kv_quant lanes (against each other and the plain path).
    kernel_of = {False: "tda_decode_attention",
                 True: "tda_paged_decode_attention"}
    for quant in (False, True):
        m = Model(dataclasses.replace(cfg, kv_quant=True)) if quant \
            else model
        want = None if quant else outs["tda"]
        for paged in (False, True):
            for mode in ("tda", "dense"):
                tda.reset_launch_counts()
                got_s, _ = run(m, params, None, decode_attn=mode, paged=paged,
                               mixed=False)
                if mode == "tda" and (not tda.LAUNCHES[kernel_of[paged]]
                                      or tda.LAUNCHES["tda_mixed_attention"]
                                      or tda.LAUNCHES[kernel_of[not paged]]):
                    fail(f"serialized engine (paged={paged}, kv_quant="
                         f"{quant}) launched {tda.LAUNCHES}")
                want = got_s if want is None else want
                if got_s != want:
                    fail(f"serialized tokens differ (paged={paged}, "
                         f"kv_quant={quant}, {mode}): {got_s} vs {want}")
    ser_tok = sum(len(v) for v in want.values())

    # Compressed: the DMM/SMM kernels vs the same factors decompressed.
    fcfg = FactorizationConfig(enabled=True, min_dim=32, rank=32, nnz=8)
    fmodel = Model(get_config("qwen2.5-32b", "smoke", dtype="float32",
                              factorization=fcfg))
    fparams = project_wd_leaves(fmodel.init(seed=0), fcfg)
    mc, cparams, _ = fmodel.compress_params(fparams)
    recon = decompressed(torch, cparams, fparams)
    for budget in (16, None):
        dmm.reset_launch_counts()
        smm.reset_launch_counts()
        got, st = run(mc, cparams, budget)
        n_lin = 7 * cfg.n_layers * st["steps"]
        if not dmm.LAUNCHES["dmm_matmul"] == smm.LAUNCHES["smm_matmul"] \
                == n_lin:
            fail(f"compressed smoke: dmm/smm launches {dmm.LAUNCHES} "
                 f"{smm.LAUNCHES} != {n_lin}")
        want, _ = run(fmodel, recon, budget)
        if got != want:
            fail(f"compressed tokens differ, DMM/SMM kernels vs decompressed "
                 f"factors (budget {budget}): {got} vs {want}")

    # Prefix sharing and preemption on the kernels: system-prompt traffic
    # (8 requests behind one 17-token prefix, 3 slots, 8-token pages) with
    # sharing on gives the tokens of sharing off and hits; a pool cut to 7
    # pages that preempts gives the tokens of an uncut pool.
    def serve_smoke(prompts, budgets, ticks, **kw):
        eng = Engine(model, params, config=EngineConfig(
            max_len=16, max_prompt_len=40, page_size=8, **kw))
        reqs = [Request(rid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        done = eng.run(arrivals=list(zip(ticks, reqs)))
        if sorted(r.rid for r in done) != list(range(len(reqs))) or \
                any(r.status != "ok" for r in done):
            fail(f"a sharing/preemption smoke run failed requests ({kw})")
        eng.slots.pool.check_invariants()
        return {r.rid: list(r.output) for r in done}, eng.decode_stats

    srng = np.random.default_rng(6)
    pre = srng.integers(0, cfg.vocab_size, size=17).astype(np.int32)
    sys_prompts = [np.concatenate([pre, srng.integers(
        0, cfg.vocab_size, size=n)]).astype(np.int32)
        for n in (3, 9, 1, 14, 6, 2, 11, 5)]
    sys_args = (sys_prompts, [4 + i % 3 for i in range(8)],
                [1, 1, 1, 1, 2, 4, 6, 9])
    sharing = {}
    for label, kw in (("mixed", dict(mixed=True)),
                      ("mixed_budget_4", dict(mixed=True, prefill_budget=4)),
                      ("serialized_paged", dict(mixed=False))):
        tda.reset_launch_counts()
        on, st_on = serve_smoke(*sys_args, num_slots=3, max_new_tokens=6,
                                **kw)
        used = [k for k in ("tda_paged_decode_attention",
                            "tda_mixed_attention") if tda.LAUNCHES[k]]
        if used != (["tda_paged_decode_attention", "tda_mixed_attention"]
                    if kw["mixed"] else ["tda_paged_decode_attention"]):
            fail(f"sharing run {label} launched {tda.LAUNCHES}")
        off, _ = serve_smoke(*sys_args, num_slots=3, max_new_tokens=6,
                             prefix_share=False, **kw)
        if on != off or not st_on["prefix_hit_ratio"] > 0:
            fail(f"sharing {label}: tokens differ from sharing off ({on} vs "
                 f"{off}) or no hit ({st_on['prefix_hit_ratio']})")
        sharing[label] = {"prefix_hit_ratio": st_on["prefix_hit_ratio"],
                          "pages_shared": st_on["pages_shared"]}
    prng = np.random.default_rng(5)
    tight = [prng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
             for n in (30, 30, 30, 12)]
    preempt = {}
    for label, kw in (("mixed", dict(mixed=True)),
                      ("serialized_paged", dict(mixed=False))):
        runs_ = [serve_smoke(tight, [8] * 4, [1] * 4, num_slots=3,
                             max_new_tokens=8, pool_frac=frac, **kw)
                 for frac in (0.34, 1.0)]
        n_pre = runs_[0][1]["preemptions"]
        if runs_[0][0] != runs_[1][0] or not n_pre > 0 \
                or runs_[1][1]["preemptions"]:
            fail(f"preemption {label}: {n_pre} preemptions, tokens "
                 f"{runs_[0][0]} vs uncut {runs_[1][0]}")
        preempt[label] = n_pre
    surface = surface_checks(torch, np, model, params)
    ring = starcoder2_tokens(torch, np)
    line("tokens", seconds=round(time.perf_counter() - t0, 3),
         float32_smoke_identical=True, prefill_budgets=checked, tokens=n_tok,
         card_vs_cpu_identical=surface,
         sharing_identical_to_cold=sharing,
         preemption_identical_to_uncut_pool={"preemptions": preempt},
         serialized_identical={
             "contiguous_and_paged_vs_mixed_and_plain": True,
             "int8_contiguous_vs_paged_vs_plain": True},
         serialized_int8_tokens=ser_tok,
         compressed_identical=True, compressed_prefill_budgets=[16, None],
         compressed_tokens=sum(len(v) for v in got.values()),
         starcoder2_ring=ring)


# starcoder2 smoke at float32 (window 32: ring lanes of 32 positions):
# prompts shorter than, at and past the window, decoding to 54 tokens; the
# last two share the first 16 tokens of the 25-token prompt and arrive at
# tick 3, after it has published and while it decodes, so its ring wraps
# into a page they share and copies it.
SC2_LENGTHS = (3, 11, 25, 7, 40, 45, 33, 20, 22)
SC2_BUDGETS = (4, 2, 12, 3, 6, 9, 5, 12, 12)
SC2_TICKS = (1, 1, 1, 2, 4, 5, 7, 3, 3)
SC2_ENGINES = {"mixed": {}, "serialized_paged": {"mixed": False},
               "serialized_contiguous": {"mixed": False, "paged": False}}


def starcoder2_tokens(torch, np):
    """starcoder2 smoke at float32 with ring lanes past the window, through
    the mixed engine (pages of 8, sharing on) and the serialized engines
    over paged and contiguous lanes: on the card through the kernels
    (``decode_attn="tda"``; each engine's kernels launched) and through
    the plain path (``"dense"``), and on the CPU; every run's tokens equal,
    and every paged run's host counters equal to the CPU's. Returns the
    line's summary."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.tda import tda
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg = get_config("starcoder2-15b", "smoke", dtype="float32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in SC2_LENGTHS]
    for i in (7, 8):  # share the first 16 tokens of the 25-token prompt
        prompts[i][:16] = prompts[2][:16]
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    model = Model(cfg)
    params = tree_to(cpu_params, "cuda")
    launched = {"mixed": ("tda_mixed_attention",
                          "tda_paged_decode_attention"),
                "serialized_paged": ("tda_paged_decode_attention",),
                "serialized_contiguous": ("tda_decode_attention",)}
    keys = ("steps", "mixed_steps", "decoded_tokens", "kv_blocks_visited",
            "prefix_hit_ratio", "pages_shared", "preemptions")
    out = {}
    for label, kw in SC2_ENGINES.items():
        runs = {}
        for where, m, prm, mode in (("card_tda", model, params, "tda"),
                                    ("card_dense", model, params, "dense"),
                                    ("cpu", cpu_model, cpu_params, "dense")):
            eng = Engine(m, prm, config=EngineConfig(
                max_len=16, max_new_tokens=12, num_slots=3,
                max_prompt_len=48, page_size=8, decode_attn=mode, **kw))
            reqs = [Request(rid=i, prompt=pr, max_new_tokens=b)
                    for i, (pr, b) in enumerate(zip(prompts, SC2_BUDGETS))]
            tda.reset_launch_counts()
            done = eng.run(arrivals=list(zip(SC2_TICKS, reqs)))
            if len(done) != len(reqs) or any(r.status != "ok"
                                             for r in done):
                fail(f"starcoder2 {label} {where}: not every request ok")
            if where == "card_tda" and (
                    sorted(k for k, n in tda.LAUNCHES.items() if n)
                    != sorted(launched[label])):
                fail(f"starcoder2 {label}: launched {tda.LAUNCHES}")
            runs[where] = ({r.rid: list(r.output) for r in done},
                           {k: eng.decode_stats[k] for k in keys},
                           eng.slots.pages_copied)
        toks = {w: r[0] for w, r in runs.items()}
        if not toks["card_tda"] == toks["card_dense"] == toks["cpu"]:
            fail(f"starcoder2 {label}: tokens differ (kernels, plain path, "
                 f"CPU): {toks}")
        if runs["card_tda"][1:] != runs["cpu"][1:]:
            fail(f"starcoder2 {label}: host counters {runs['card_tda'][1:]}"
                 f" != the CPU run's {runs['cpu'][1:]}")
        out[label] = dict(runs["cpu"][1], pages_copied=runs["cpu"][2])
    if not (out["mixed"]["prefix_hit_ratio"] > 0
            and out["mixed"]["pages_copied"] > 0):
        fail(f"starcoder2 mixed: no ring copy-on-write of a shared page "
             f"({out['mixed']})")
    return {"window": cfg.sliding_window, "prompt_lengths": SC2_LENGTHS,
            "tokens_identical_kernels_plain_cpu": True, "engines": out}


def tree_to(tree, dev):
    """A params tree (nested dicts of tensors) copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# Engine-wide sampling of the float32 smoke comparisons (the reference's
# test_pages.py settings).
SMOKE_SAMPLED = dict(temperature=0.8, top_k=12, seed=7)
CHAOS = dict(seed=5, p_alloc_fail=0.05, p_forced_preempt=0.2,
             p_nan_logits=0.04, p_stall=0.1, max_faults=10)
SURFACE_COUNTERS = ("status_counts", "preemptions", "preemptions_recovered",
                    "faults_injected", "steps", "mixed_steps",
                    "decoded_tokens", "prefix_hit_ratio", "pages_shared",
                    "fleet_restored_pages", "clock_ticks")


def surface_checks(torch, np, model, params):
    """The serving surface of the float32 smoke config on the card against
    the port's CPU run of the same workload on the same params: tokens,
    statuses and host counters (SURFACE_COUNTERS) must be equal for a
    sampled engine (mixed and serialized), a greedy batch with per-request
    ``SamplingParams``, the sampled engine over a cut pool that preempts
    (which must also equal the uncut pool's tokens), a chaos ``FaultPlan``
    with audits on (statuses, outputs, ``faults_injected``,
    ``preemptions``), ``audit=True`` against the run without it, a
    ``Frontend`` against ``Engine.run``, and a two-replica ``Dispatcher``
    with a fleet index against one engine (same tokens; routing and
    ``fleet_restored_pages`` equal the CPU's). Returns a summary."""
    import asyncio
    from repro_torch.models.transformer import Model
    from repro_torch.serve import (Dispatcher, Engine, EngineConfig,
                                   FaultPlan, Frontend, Request,
                                   SamplingParams)
    cfg = model.cfg
    models = {"cuda": (model, params),
              "cpu": (Model(cfg, device="cpu"), tree_to(params, "cpu"))}
    V = cfg.vocab_size
    rng = np.random.default_rng(1)
    base = ([rng.integers(0, V, size=n).astype(np.int32)
             for n in (5, 25, 12, 18)], [6, 5, 4, 6], [1, 1, 3, 6])
    prng = np.random.default_rng(5)
    tight = ([prng.integers(0, V, size=n).astype(np.int32)
              for n in (30, 30, 30, 12)], [8] * 4, [1] * 4)
    srng = np.random.default_rng(6)
    pre = srng.integers(0, V, size=17).astype(np.int32)
    system = ([np.concatenate([pre, srng.integers(0, V, size=n)])
               .astype(np.int32) for n in (3, 9, 1, 14, 6, 2, 11, 5)],
              [4 + i % 3 for i in range(8)], [1, 1, 1, 1, 2, 4, 6, 9])
    # one request first, the rest once its prompt is published: the
    # second replica's first probe restores the prefix from the fleet
    fleet_work = system[:2] + ([1, 4, 4, 5, 5, 6, 8, 9],)
    per_req = [{"sampling": SamplingParams(temperature=0.9, top_k=4,
                                           seed=7 + i)} if i % 2 else {}
               for i in range(4)]
    kw0 = dict(max_len=16, max_new_tokens=8, num_slots=3, max_prompt_len=40,
               page_size=8)

    def arrivals(work, req_kw=None):
        prompts, budgets, ticks = work
        return [(t, Request(rid=i, prompt=p, max_new_tokens=b,
                            **(req_kw[i] if req_kw else {})))
                for i, (p, b, t) in enumerate(zip(prompts, budgets, ticks))]

    def result(done, st):
        if sorted(r.rid for r in done) != sorted(set(r.rid for r in done)):
            fail("a request came back twice")
        return ({r.rid: (r.status, list(r.output)) for r in done},
                {k: st.get(k) for k in SURFACE_COUNTERS})

    def engine(dev, faults=None, **kw):
        m, p = models[dev]
        return Engine(m, p, config=EngineConfig(**{**kw0, **kw}),
                      faults=faults)

    def serve(dev, work, req_kw=None, faults=None, **kw):
        eng = engine(dev, faults, **kw)
        done = eng.run(arrivals=arrivals(work, req_kw))
        if eng.paged:
            eng.slots.pool.check_invariants()
        return result(done, eng.decode_stats)

    def frontend(dev, work, req_kw=None, **kw):
        eng = engine(dev, **kw)

        async def main():
            async with Frontend(eng) as fe:
                hs = [fe.submit(r, tick=t) for t, r in arrivals(work,
                                                                req_kw)]
                streams = await asyncio.gather(*(_collect(h) for h in hs))
            return fe, streams

        fe, streams = asyncio.run(main())
        out = result(fe.results, fe.stats)
        if {h: s for h, s in streams} != {r: o for r, (_, o)
                                           in out[0].items()}:
            fail("frontend: streamed tokens differ from the outputs")
        return out

    def dispatch(dev, work, **kw):
        disp = Dispatcher([engine(dev, **kw) for _ in range(2)])
        done = disp.run(arrivals=arrivals(work))
        st = disp.decode_stats
        out = result(done, st)
        out[1].update(routed_counts=st["routed_counts"],
                      fleet=st.get("fleet"), prefix_hit_ratio=[
                          r["prefix_hit_ratio"] for r in st["replicas"]])
        return out

    scenarios = {
        "sampled_mixed": lambda d: serve(d, base, mixed=True,
                                         **SMOKE_SAMPLED),
        "sampled_serialized": lambda d: serve(d, base, mixed=False,
                                              **SMOKE_SAMPLED),
        "per_request_sampling": lambda d: serve(d, base, per_req),
        "sampled_cut_pool": lambda d: serve(d, tight, pool_frac=0.34,
                                            **SMOKE_SAMPLED),
        "chaos": lambda d: serve(d, base, faults=FaultPlan(**CHAOS),
                                 audit=True, num_slots=4, max_new_tokens=16),
        "frontend": lambda d: frontend(d, base, per_req),
        "dispatcher_fleet": lambda d: dispatch(d, fleet_work,
                                               max_new_tokens=6),
    }
    summary = {}
    got = {}
    for name, fn in scenarios.items():
        got[name] = card = fn("cuda")
        cpu = fn("cpu")
        if card != cpu:
            fail(f"tokens: {name} on the card {card} differs from the CPU "
                 f"run {cpu}")
        summary[name] = {k: v for k, v in card[1].items()
                         if k in ("preemptions", "faults_injected",
                                  "fleet_restored_pages", "routed_counts")
                         and v}
        summary[name]["statuses"] = {k: v for k, v in
                                     card[1]["status_counts"].items() if v}
    # the card's runs against each other
    uncut = serve("cuda", tight, **SMOKE_SAMPLED)
    if got["sampled_cut_pool"][0] != uncut[0] \
            or not got["sampled_cut_pool"][1]["preemptions"] > 0:
        fail(f"tokens: the sampled cut pool {got['sampled_cut_pool']} "
             f"against the uncut pool {uncut}")
    audited = serve("cuda", base, audit=True, **SMOKE_SAMPLED)
    if audited != got["sampled_mixed"]:
        fail("tokens: audit=True changed the sampled run")
    if got["frontend"][0] != got["per_request_sampling"][0]:
        fail("tokens: the Frontend's tokens differ from Engine.run's")
    one = serve("cuda", fleet_work, max_new_tokens=6)
    if got["dispatcher_fleet"][0] != one[0] or \
            not got["dispatcher_fleet"][1]["fleet_restored_pages"] > 0:
        fail(f"tokens: the two-replica fleet {got['dispatcher_fleet']} "
             f"against one engine {one}")
    chaos = got["chaos"][1]
    if not sum(chaos["faults_injected"].values()) > 0:
        fail("tokens: the chaos plan injected nothing")
    greedy = serve("cuda", base)
    for rid in (0, 2):
        if got["per_request_sampling"][0][rid] != greedy[0][rid]:
            fail("tokens: a greedy request of the per-request batch moved")
    return summary


async def _collect(handle):
    return handle.request.rid, [tok async for tok in handle]


# The sampler phase's (base seed, base position, temperature, top_k) sets:
# row b draws with seed + b and position + b (32-bit words).
SAMPLER_SETS = ((7, 1, 0.8, 50), (0, 513, 1.0, 0),
                (2**32 - 1, 2**31 - 1, 0.5, 1),
                (123456789, 40000, 1.3, 152064), (42, 7, 0.8, 12))
TIE_ULP = 4  # rows whose top two perturbed scores lie this close


def phase_sampler(torch, np):
    """The sampler at the full-width vocabulary on the card against the
    CPU: (8, 152064) float32 logits from a seed, for each SAMPLER_SETS
    entry the raw threefry bits must be equal as integers, the uniforms
    bit-identical and the tokens equal, except rows whose top two
    perturbed scores (Gumbel noise plus the truncated scaled logits, on
    the CPU) lie within TIE_ULP ulp, which are counted (expected: none).
    Records the sampler's launches and device ms per call
    (``torch.profiler``) beside the greedy argmax's."""
    from repro_torch.serve import sampling as S
    t0 = time.perf_counter()
    B, V = 8, 152064
    logits_cpu = 4 * torch.randn(B, V, generator=torch.Generator()
                                 .manual_seed(11))
    logits = logits_cpu.cuda()
    ties, checked = 0, []
    for seed, pos, temp, topk in SAMPLER_SETS:
        seeds = ((seed + np.arange(B)) & 0xFFFFFFFF).astype(np.uint32)
        positions = (pos + np.arange(B)) & 0xFFFFFFFF
        temps = np.full(B, temp, np.float32)
        topks = np.full(B, topk, np.int32)
        kc = S.row_keys(seeds, positions, "cuda")
        kh = S.row_keys(seeds, positions, "cpu")
        if not torch.equal(S.random_bits(kc, V).cpu(), S.random_bits(kh, V)):
            fail(f"sampler {seed, pos}: threefry bits differ from the CPU's")
        if not torch.equal(S.uniform(kc, V).cpu().view(torch.int32),
                           S.uniform(kh, V).view(torch.int32)):
            fail(f"sampler {seed, pos}: uniforms differ from the CPU's")
        got = S.sample_tokens_batch(logits, seeds, positions, temps,
                                    topks).cpu()
        want = S.sample_tokens_batch(logits_cpu, seeds, positions, temps,
                                     topks)
        score = S.gumbel(kh, V) + S.truncate_batch(logits_cpu, temps, topks)
        top2 = torch.topk(score, 2).values
        ulp = torch.nextafter(top2[:, 0], torch.tensor(float("inf"))) \
            - top2[:, 0]
        tie = (top2[:, 0] - top2[:, 1]) <= TIE_ULP * ulp
        bad = (got != want) & ~tie
        if bad.any():
            fail(f"sampler {seed, pos, temp, topk}: tokens {got.tolist()} "
                 f"against the CPU's {want.tolist()}")
        ties += int(tie.sum())
        checked.append([seed, pos, temp, topk])
    temps = np.array([0.8, 0.0] * 4, np.float32)
    sampling = (torch.tensor(np.arange(B), device="cuda"),
                torch.full((B,), 300, device="cuda"),
                torch.tensor(temps, device="cuda"),
                torch.full((B,), 50, dtype=torch.int32, device="cuda"))
    s_ms, s_n = range_profile(torch, lambda: S.sample_or_greedy(logits,
                                                               sampling),
                              reps=10)
    g_ms, g_n = range_profile(torch, lambda: S.greedy_tokens(logits),
                              reps=10)
    line("sampler", seconds=round(time.perf_counter() - t0, 3),
         shape=[B, V], sets=checked, bits_equal=True, uniforms_equal=True,
         tokens_equal_except_near_ties=True, near_tie_rows=ties,
         tie_ulp=TIE_ULP, sampler_launches=s_n, sampler_device_ms=s_ms,
         greedy_launches=g_n, greedy_device_ms=g_ms)


def twin_engine(eng, **over):
    """Another engine over ``eng``'s prepared weights (the same tensors, no
    second copy), priced at the same weight stream."""
    from repro_torch.serve import Engine
    return Engine(eng.model, eng.params, config=dataclasses.replace(
        eng.config, weight_stream_bits=eng._weight_stream_bits, **over))


def short_profile(torch, eng, engine_kw, kinds=("decode", "mixed")):
    """profile_serve's per-step breakdown of a short window on ``eng``:
    the first 8 requests of ``profile_serve.workload`` at 8 new tokens
    each, served once to warm up, once plainly and once profiled; the
    steps of ``kinds``."""
    import numpy as np
    from repro_torch.launch.profile_serve import profile_run, workload
    vocab = eng.model.cfg.vocab_size
    for _ in range(2):
        _, up_front, _, _ = workload(vocab, 8)
        for r in up_front:
            eng.submit(r)
        eng.run()
    plain = {k: float(np.mean(v)) if v else 0.0
             for k, v in eng.decode_stats["step_ms"].items()}
    _, up_front, _, _ = workload(vocab, 8)
    prof = profile_run(eng, up_front, [], plain)
    return {kind: {k: prof[kind][k] for k in (
        "steps", "host_ms_per_step_unprofiled", "device_busy_ms_per_step",
        "launches_per_step", "choose_launches_per_step",
        "choose_device_ms_per_step")} for kind in kinds}


def phase_sampled_serve(torch, np, model, params, engine_kw, greedy):
    """The serve phase's workload at full width with seeded sampling
    (``profile_serve.SAMPLED``): 16/16 ``ok`` with serve_run's launch
    checks, two runs of the same seed token-identical, another seed
    changing most requests. Reports tok/s, TTFT and step times beside the
    greedy serve's, and a short profiled window of each engine: launches
    and device ms per decode step, and of the token choice alone."""
    from repro_torch.launch.profile_serve import SAMPLED
    from repro_torch.serve import Engine, EngineConfig
    t0 = time.perf_counter()
    runs = {}
    for label, seed in (("seed0", 0), ("seed0_again", 0), ("seed1", 1)):
        gc.collect()
        torch.cuda.empty_cache()
        runs[label] = serve_run(torch, np, model, params, engine_kw,
                                seed=seed, **SAMPLED)
    if runs["seed0"][2] != runs["seed0_again"][2]:
        fail("sampled_serve: the same seed gave other tokens")
    moved = sum(runs["seed0"][2][r] != runs["seed1"][2][r]
                for r in runs["seed0"][2])
    if moved <= len(runs["seed0"][2]) // 2:
        fail(f"sampled_serve: another seed changed {moved} of 16 requests")
    eng = Engine(model, params, config=EngineConfig(prefix_share=False,
                                                    **engine_kw))
    prof = {"greedy": short_profile(torch, eng, engine_kw),
            "sampled": short_profile(torch, twin_engine(eng, **SAMPLED),
                                     engine_kw)}
    del eng
    keys = ("output_tok_s", "ttft_p50_s", "ttft_p99_s",
            "decode_step_ms_median", "mixed_step_ms_median", "steps",
            "mixed_steps")
    line("sampled_serve", seconds=round(time.perf_counter() - t0, 3),
         sampling=SAMPLED, requests=16, ok=16, same_seed_identical=True,
         other_seed_moved=f"{moved}/16",
         **{k: runs["seed0"][0][k] for k in keys},
         again={k: runs["seed0_again"][0][k] for k in keys[:4]},
         greedy={k: greedy[k] for k in keys},
         short_window_profile=prof)


FLEET_TICK = 3


def phase_fleet_serve(torch, np, model, params, engine_kw):
    """Two replicas over the same prepared weights behind a ``Dispatcher``
    with a ``FleetPrefixIndex`` serve ``profile_serve.shared_workload``
    (request 0 at tick 1, the other 7 up-front requests at FLEET_TICK,
    after request 0's prompt is published): 16/16 ``ok``, at least one
    page restored from the fleet, and the host
    counters (routing, per-replica hit ratio, pages shared, fleet
    restored pages, the fleet's own counters, steps) equal to the port's
    CPU run of the same workload on the 2-layer float32 smoke config.
    Then a ``Frontend`` over one full-width engine must give ``Engine.
    run``'s tokens on a ``traces.poisson_trace`` (half of it with
    per-request sampling)."""
    import asyncio
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import shared_workload
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Dispatcher, Engine, EngineConfig, Frontend
    from repro_torch.serve.traces import build_arrivals, poisson_trace
    t0 = time.perf_counter()
    n_new = engine_kw["max_new_tokens"]

    def fleet(m, p):
        a = Engine(m, p, config=EngineConfig(page_size=128, **engine_kw))
        disp = Dispatcher([a, twin_engine(a)])
        warm, up_front, arr, lengths = shared_workload(256, n_new)
        disp.run(arrivals=[(1, warm)])
        t1 = time.perf_counter()
        # request 0 first; the other up-front requests once its prompt
        # is published, so the second replica's first probe restores the
        # system prompt's pages from the fleet
        done = disp.run(arrivals=[(1, up_front[0])] + [
            (FLEET_TICK, r) for r in up_front[1:]] + arr)
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if len(done) != 16 or any(r.status != "ok" for r in done):
            fail(f"fleet_serve on {m.device}: not 16/16 ok")
        st = disp.decode_stats
        counters = dict(
            routed_counts=st["routed_counts"], steps=st["steps"],
            pages_shared=st["pages_shared"],
            fleet_restored_pages=st["fleet_restored_pages"],
            preemptions=st["preemptions"], fleet=st["fleet"],
            prefix_hit_ratio=[r["prefix_hit_ratio"] for r in st["replicas"]])
        for e in disp.replicas:
            e.slots.pool.check_invariants()
        toks = sum(len(r.output) for r in done)
        return counters, toks / wall, disp

    scfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    smodel = Model(scfg, device="cpu")
    cpu, _, _ = fleet(smodel, smodel.init(seed=0))
    card, tok_s, disp = fleet(model, params)
    if card != cpu:
        fail(f"fleet_serve: host counters {card} != the CPU run's {cpu}")
    if not card["fleet_restored_pages"] > 0:
        fail("fleet_serve: no page was restored from the fleet")
    eng = twin_engine(disp.replicas[0], prefix_share=False)
    del disp
    specs = poisson_trace(16, seed=0)

    def trace():
        return build_arrivals(specs, model.cfg.vocab_size, seed=1)

    want = {r.rid: (r.status, list(r.output))
            for r in eng.run(arrivals=trace())}

    async def drive():
        async with Frontend(eng) as fe:
            hs = [fe.submit(r, tick=t) for t, r in trace()]
            await asyncio.gather(*(h.result() for h in hs))
        return fe

    fe = asyncio.run(drive())
    got = {r.rid: (r.status, list(r.output)) for r in fe.results}
    if got != want or any(s != "ok" for s, _ in got.values()):
        fail("fleet_serve: the Frontend's tokens differ from Engine.run's")
    line("fleet_serve", seconds=round(time.perf_counter() - t0, 3),
         replicas=2, requests=16, ok=16, output_tok_s=tok_s,
         host_counters_equal_cpu_smoke=True, **card,
         frontend_vs_run_identical=True,
         frontend_trace={"requests": len(specs),
                         "sampled": sum(s.sampled for s in specs)})


def serve_run(torch, np, model, params, engine_kw, traffic=None,
              reduced=None, **cfg_kw):
    """Serve ``traffic(max_new_tokens)`` (default: ``profile_serve.
    workload``) through ``Engine.run`` after one warm-up request, with
    every launch counter set to 0 just before the run and read just after
    (``prefix_share=False`` unless ``cfg_kw`` says otherwise). Checks every
    request ends ``ok`` with ``max_new_tokens`` valid tokens, the page
    pool's invariants, and that each TDA kernel launches once per layer per
    step of its kind: the mixed engine's paged decode and mixed kernels,
    the serialized engine's contiguous or paged decode kernel (every one
    of its steps is a decode step), and no other. ``reduced`` names the
    configuration's cuts (default: qwen2.5-32b's depth). Returns (summary
    dict, launches, {rid: output tokens}, engine)."""
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.kernels.tda import tda
    from repro_torch.launch.profile_serve import workload
    from repro_torch.serve import Engine, EngineConfig, spans
    cfg = model.cfg
    t0 = time.perf_counter()
    eng = Engine(model, params, config=EngineConfig(
        **{"prefix_share": False, **cfg_kw}, **engine_kw))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if traffic is None:
        def traffic(n):
            return workload(cfg.vocab_size, n)
    warm, up_front, arrivals, lengths = traffic(engine_kw["max_new_tokens"])
    n_req = len(up_front) + len(arrivals)
    eng.submit(warm)  # library initialisation, first launches
    eng.run()
    for r in up_front:
        eng.submit(r)
    n_sweeps0 = len(eng.stats)
    torch.cuda.synchronize()
    for mod in (tda, dmm, smm):
        mod.reset_launch_counts()
    copied0 = eng.slots.pages_copied
    t0, ns0 = time.perf_counter(), time.time_ns()
    done = eng.run(arrivals=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # The columns each mixed step's linears ran over (its dispatch span).
    got = spans.records(ns0, time.time_ns())
    if not got.complete:
        fail("the span ring overwrote spans of the run")
    mixed_cols = [s.attrs["cols"] for s in got.spans
                  if s.name == "dispatch" and s.start_ns >= ns0
                  and s.attrs["kind"] == "mixed"]
    launches = {**tda.LAUNCHES, **dmm.LAUNCHES, **smm.LAUNCHES,
                **dmm.BODY_LAUNCHES, **smm.BODY_LAUNCHES}
    st = eng.decode_stats
    if sorted(r.rid for r in done) != list(range(n_req)):
        fail("not every request came back")
    bad = [(r.rid, r.status, r.status_reason) for r in done
           if r.status != "ok"]
    if bad:
        fail(f"requests not ok: {bad}")
    if any(len(r.output) != engine_kw["max_new_tokens"]
           or not all(0 <= t < cfg.vocab_size for t in r.output)
           for r in done):
        fail("a request's output has the wrong length or an invalid token")
    if eng.paged:
        eng.slots.pool.check_invariants()
    L = cfg.n_layers
    # Attention layers launch the kernels: every layer of an attention
    # stack, recurrentgemma's local layers, none of mamba2's.
    La = sum(1 for i in range(L) if cfg.block_kind(i) in ("attn", "local"))
    n_dec = st["steps"] - st["mixed_steps"]
    want = {"tda_decode_attention": 0, "tda_paged_decode_attention": 0,
            "tda_mixed_attention": La * st["mixed_steps"]}
    want["tda_paged_decode_attention" if eng.paged
         else "tda_decode_attention"] = La * n_dec
    n_used = sum(1 for n in want.values() if n)
    if any(launches[k] != n for k, n in want.items()) or \
            n_used != ((2 if eng.mixed else 1) if La else 0):
        fail(f"launch counts {launches}, want {want}: {La} attention "
             f"layers x ({n_dec} decode, {st['mixed_steps']} mixed) steps")
    ttft = sorted(v["wall_s"] for v in st["ttft"].values())
    toks = sum(len(r.output) for r in done)
    sweeps = eng.stats[n_sweeps0:]

    def median(v):
        return float(np.median(v)) if v else None

    summary = dict(
        model=cfg.name, weight_format=cfg.weight_format,
        engine="mixed" if eng.mixed else "serialized",
        lanes="paged" if eng.paged else "contiguous",
        kv="int8" if cfg.kv_quant else str(cfg.compute_dtype).split(".")[1],
        d_model=cfg.d_model, n_layers=L, attention_layers=La,
        reduced=({"n_layers": "64 -> 8 (depth only)"} if reduced is None
                 else reduced),
        requests=len(done), ok=len(done), output_tokens=toks,
        prompt_tokens=int(lengths.sum()), wall_s=wall, setup_s=setup_s,
        output_tok_s=toks / wall,
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p99_s=float(np.percentile(ttft, 99)),
        decode_step_ms_median=median(st["step_ms"]["decode"]),
        mixed_step_ms_median=median(st["step_ms"]["mixed"]),
        prefill_sweep_ms_median=median(st["step_ms"]["prefill"]),
        prefill_sweeps=len(st["step_ms"]["prefill"]),
        prefill_utilization_mean=(float(np.mean(
            [w["utilization"] for w in sweeps])) if not eng.mixed else None),
        prefill_rows_mean=(float(np.mean([w["rows"] for w in sweeps]))
                           if not eng.mixed else None),
        steps=st["steps"], mixed_steps=st["mixed_steps"],
        mixed_columns_mean=(float(np.mean(mixed_cols)) if mixed_cols
                            else None),
        # mixed steps in the DMM / SMM small-M bodies' range (M <= 32)
        mixed_steps_m32=sum(c <= 32 for c in mixed_cols),
        slot_utilization=st["slot_utilization"],
        kv_memory_ratio=st["kv_memory_ratio"],
        kv_pages_total=st["kv_pages_total"],
        prefix_share=eng.prefix_share,
        prefix_hit_ratio=st["prefix_hit_ratio"],
        pages_shared=st["pages_shared"], preemptions=st["preemptions"],
        # K/V token writes into the pool: the prompt tokens computed (the
        # mixed engine's chunk tokens; shared prefixes are not), one per
        # decoded token, and a page per copy-on-write copy
        kv_token_writes=(st["prefill_chunk_tokens"] + st["decoded_tokens"]
                         + (eng.page_size or 0)
                         * (eng.slots.pages_copied - copied0)),
        pages_copied=eng.slots.pages_copied - copied0,
        kv_blocks_visited=st["kv_blocks_visited"],
        kv_blocks_dense=st["kv_blocks_dense"],
        kv_bytes_per_token=st["kv_bytes_per_token"],
        weight_bytes_per_step=st["weight_bytes_per_step"],
        bytes_per_token=st["bytes_per_token"], launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return summary, launches, {r.rid: list(r.output) for r in done}, eng


def phase_serve(torch, np, full_cfg, engine_kw):
    """The mixed-step serve, then the three phase-serialized serves on the
    same params (contiguous bf16, contiguous int8, the default kv_quant
    engine: paged int8). Returns (mixed summary, launches per serve)."""
    from repro_torch.models.transformer import Model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(full_cfg)
    params = model.init(seed=0)
    init_s = time.perf_counter() - t0
    summary, launches, _, _ = serve_run(torch, np, model, params, engine_kw)
    line("serve", seconds=round(time.perf_counter() - t0, 3),
         init_s=init_s, **summary)
    runs = {"mixed": launches}
    qmodel = Model(dataclasses.replace(full_cfg, kv_quant=True))
    kv_bytes = {}
    for label, m, kw in (("contiguous_bf16", model,
                          dict(paged=False, mixed=False)),
                         ("contiguous_int8", qmodel, dict(paged=False)),
                         ("paged_int8", qmodel, {})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        ser, runs[label], _, _ = serve_run(torch, np, m, params, engine_kw,
                                           **kw)
        if ser["engine"] != "serialized":
            fail(f"{label}: the {ser['engine']} engine served it")
        kv_bytes[label] = (ser["kv_bytes_per_token"],
                           ser["kv_blocks_visited"])
        line("serve_serialized", label=label,
             seconds=round(time.perf_counter() - t1, 3), **ser)
    # int8 lanes move (D + 4) / (2 D) of the bf16 lanes' K/V bytes at equal
    # visited blocks
    D = full_cfg.head_dim
    ratios = {}
    for label in ("contiguous_int8", "paged_int8"):
        if kv_bytes[label][1] != kv_bytes["contiguous_bf16"][1]:
            fail(f"{label}: visited blocks differ from the bf16 serve's "
                 f"{kv_bytes}")
        ratios[label] = kv_bytes[label][0] / kv_bytes["contiguous_bf16"][0]
        if abs(ratios[label] - (D + 4) / (2 * D)) > 1e-9:
            fail(f"{label}: kv bytes/token ratio {ratios[label]} != "
                 f"{(D + 4) / (2 * D)}")
    line("serve_serialized_kv_bytes", ratio_vs_contiguous_bf16=ratios,
         expected=(D + 4) / (2 * D))
    return summary, runs, model, params


# The shared_serve phase's three runs (``profile_serve.shared_workload``):
# the default EngineConfig, sharing over a pool cut to SHARED_POOL_FRAC of
# the lanes (16 of 40 pages: it preempts), and sharing off.
SHARED_POOL_FRAC = 0.4
SHARED_RUNS = {"default": {}, "cut_pool": {"pool_frac": SHARED_POOL_FRAC},
               "cold": {"prefix_share": False}}
HOST_COUNTERS = ("prefix_hit_ratio", "pages_shared", "preemptions", "steps",
                 "mixed_steps")


def phase_shared_serve(torch, np, model, params, engine_kw):
    """System-prompt traffic at full width on the serve phase's dense
    params (``profile_serve.shared_workload``: 16 requests behind one
    256-token system prompt, token ids below the smoke vocabulary), in the
    three SHARED_RUNS through the mixed engine. Each run must end 16/16
    ``ok`` with the pool's invariants and the launch counts of
    ``serve_run``; both sharing runs must hit (``prefix_hit_ratio`` and
    ``pages_shared`` > 0), the cut pool must preempt, and the host
    counters (HOST_COUNTERS) of every run must equal those of the same
    workload served by the port on the CPU with the 2-layer float32 smoke
    config: they follow lengths and prompt tokens only. Reports tok/s,
    TTFT, K/V token writes against the cold run, and how many requests'
    bf16 tokens equal the cold run's (not a gate: bf16 near-ties)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import shared_workload
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    t0 = time.perf_counter()
    n_new = engine_kw["max_new_tokens"]
    vocab = 256  # the smoke vocabulary: the CPU run serves the same prompts

    def traffic(n):
        return shared_workload(vocab, n)

    scfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    if scfg.vocab_size != vocab:
        fail(f"smoke vocabulary {scfg.vocab_size} != {vocab}")
    smodel = Model(scfg, device="cpu")
    sparams = smodel.init(seed=0)
    cpu = {}
    for label, kw in SHARED_RUNS.items():
        eng = Engine(smodel, sparams, config=EngineConfig(
            page_size=128, **kw, **engine_kw))
        warm, up_front, arrivals, _ = traffic(n_new)
        eng.submit(warm)
        eng.run()
        for r in up_front:
            eng.submit(r)
        done = eng.run(arrivals=arrivals)
        if len(done) != 16 or any(r.status != "ok" for r in done):
            fail(f"shared_serve {label} on the CPU: not 16/16 ok")
        eng.slots.pool.check_invariants()
        cpu[label] = {k: eng.decode_stats[k] for k in HOST_COUNTERS}
    cpu_s = time.perf_counter() - t0
    out, outputs = {}, {}
    for label, kw in SHARED_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        summ, _, outputs[label], _ = serve_run(
            torch, np, model, params, engine_kw, traffic=traffic,
            page_size=128, **{"prefix_share": True, **kw})
        got = {k: summ[k] for k in HOST_COUNTERS}
        if got != cpu[label]:
            fail(f"shared_serve {label}: host counters {got} != the CPU "
                 f"smoke run's {cpu[label]}")
        if label != "cold" and not (summ["prefix_hit_ratio"] > 0
                                    and summ["pages_shared"] > 0):
            fail(f"shared_serve {label}: no prefix hit ({got})")
        if label == "cut_pool" and not summ["preemptions"] > 0:
            fail(f"shared_serve {label}: the cut pool did not preempt")
        out[label] = summ
    for label, summ in out.items():
        same = sum(outputs[label][rid] == outputs["cold"][rid]
                   for rid in outputs["cold"])
        line("shared_serve", label=label, engine_config=SHARED_RUNS[label],
             bf16_tokens_equal_cold=f"{same}/16",
             kv_token_writes_vs_cold=summ["kv_token_writes"]
             / out["cold"]["kv_token_writes"],
             host_counters_equal_cpu_smoke=True,
             **{k: v for k, v in summ.items() if k != "launches"})
    line("shared_serve_summary", seconds=round(time.perf_counter() - t0, 3),
         cpu_smoke_s=cpu_s, cpu_smoke_counters=cpu,
         pool_frac_cut=SHARED_POOL_FRAC)


def phase_compressed_serve(torch, np, ccfg, engine_kw, dense):
    """The main path on compressed weights: factorized f32 weights drawn
    on the card, projected and compressed there, the f32 tree freed, then
    the phase-4 workload."""
    from repro_torch.core.factorized import project_wd_leaves
    from repro_torch.models.transformer import Model
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(ccfg)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    params = project_wd_leaves(params, ccfg.factorization)
    torch.cuda.synchronize()
    project_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    mc, cparams, stats = model.compress_params(params)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t1
    del params  # the f32 factors; cparams shares only embeddings and head
    gc.collect()
    summary, launches, _, _ = serve_run(
        torch, np, mc, cparams, engine_kw,
        weight_stream_bits=stats["weight_stream_bits"])
    del cparams
    n_lin = 7 * ccfg.n_layers * summary["steps"]
    if not launches["dmm_matmul"] == launches["smm_matmul"] == n_lin:
        fail(f"dmm/smm launches {launches} != 7 linears x "
             f"{ccfg.n_layers} layers x {summary['steps']} steps")
    # Decode steps (M = num_slots <= 32) and mixed steps of at most 32 live
    # columns run the small-M bodies, the other mixed steps (M = their live
    # columns) the tensor-core bodies, and nothing else.
    n_mixed = 7 * ccfg.n_layers * (summary["mixed_steps"]
                                   - summary["mixed_steps_m32"])
    want = {f"{k}.{b}": n for k in ("dmm_matmul", "smm_matmul")
            for b, n in (("small", n_lin - n_mixed), ("tc", n_mixed),
                         ("fma", 0))}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"dmm/smm launches by body "
             f"{ {k: launches[k] for k in want} }, want {want}")
    line("compressed_serve", seconds=round(time.perf_counter() - t0, 3),
         init_s=init_s, project_s=project_s, compress_s=compress_s,
         weight_stream_bits=stats["weight_stream_bits"],
         weight_stream_bits_dense=stats["weight_stream_bits_dense"],
         weight_compression_ratio=stats["weight_compression_ratio"],
         dense_weight_bytes_per_step=dense["weight_bytes_per_step"],
         dense_bytes_per_token=dense["bytes_per_token"],
         dense_output_tok_s=dense["output_tok_s"], **summary)
    return launches


# bf16 logits, card against CPU: the same bound as tests/test_torch_bf16_
# parity.py (there: the port's bf16 against the reference's, as a multiple
# of the reference's own bf16-vs-f32 gap; here: the card's bf16 against the
# CPU's f32, as a multiple of the port's own bf16-vs-f32 gap on the CPU).
BF16_FACTOR = 2.0
BF16_ARCHS = ("qwen2.5-32b", "starcoder2-15b")


def phase_bf16_logits(torch, np):
    """bf16 logits on the card against the CPU, for qwen2.5 smoke and
    starcoder2 smoke (2 layers; float32 params from ``Model.init`` seed 0,
    made bf16 by ``Model.prepare``): ``apply`` over 40 tokens (past
    starcoder2's window of 32), ``decode_step`` and ``mixed_step`` over a
    shuffled page pool of bf16 values (the TDA kernels on the card, the
    plain path on the CPU). For each, the card's largest gap to the CPU's
    float32 logits over live positions, divided by the CPU's own bf16 gap
    to them, must stay within BF16_FACTOR, and the logits be finite."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    PS, NPG, B, S = 8, 3, 4, 6
    W = PS * NPG
    P = B * NPG + 2
    bt = rng.permutation(P)[:B * NPG].reshape(B, NPG).astype(np.int32)
    active = np.array([True, True, False, True])
    ci_d = np.array([3, 15, 0, 20], np.int32)
    ci_m = np.array([5, 14, 9, 0], np.int32)
    nn = np.array([4, 1, 3, S], np.int32)
    live = {"apply": None, "decode": active,
            "mixed": (np.arange(S)[None, :] < nn[:, None]) & active[:, None]}
    out = {}
    for arch in BF16_ARCHS:
        c32 = get_config(arch, "smoke", dtype="float32")
        toks = rng.integers(0, c32.vocab_size, size=(2, 40)).astype(np.int32)
        dtoks = rng.integers(0, c32.vocab_size, size=(B, 1)).astype(np.int32)
        mtoks = rng.integers(0, c32.vocab_size, size=(B, S)).astype(np.int32)
        shape = (c32.n_layers, P, PS, c32.kv_heads, c32.head_dim)
        pools = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16().float() for _ in range(2)]
        params = Model(c32, device="cpu").init(seed=0)

        def logits(dtype, dev, mode):
            m = Model(get_config(arch, "smoke", dtype=dtype), device=dev) \
                .with_decode_attn(mode)
            prm = m.prepare(tree_to(params, dev))

            def T(a):
                return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

            def caches():
                return {"k": pools[0].to(dev, m.cfg.compute_dtype),
                        "v": pools[1].to(dev, m.cfg.compute_dtype)}

            pages = {"bt": T(bt), "width": W, "page_size": PS}
            res = {"apply": m.apply(prm, {"inputs": T(toks)})[0],
                   "decode": m.decode_step(
                       prm, {"inputs": T(dtoks)}, caches(), T(ci_d),
                       slot_mask=T(active), pages=pages)[0][:, 0],
                   "mixed": m.mixed_step(
                       prm, {"inputs": T(mtoks)}, caches(), T(ci_m), T(nn),
                       slot_mask=T(active), pages=pages)[0]}
            return {k: v.float().cpu().numpy() for k, v in res.items()}

        ref32 = logits("float32", "cpu", "dense")
        cpu16 = logits("bfloat16", "cpu", "dense")
        card16 = logits("bfloat16", "cuda", "tda")
        for step, mask in live.items():
            def sel(a):
                return a if mask is None else a[mask]
            gap_cpu = float(np.abs(sel(cpu16[step]) - sel(ref32[step])).max())
            gap_card = float(np.abs(sel(card16[step])
                                    - sel(ref32[step])).max())
            ratio = gap_card / gap_cpu if gap_cpu > 0 else float("inf")
            out[f"{arch}:{step}"] = {
                "card_bf16_vs_cpu_f32": gap_card,
                "cpu_bf16_vs_cpu_f32": gap_cpu, "ratio": ratio,
                "card_bf16_vs_cpu_bf16": float(np.abs(
                    sel(card16[step]) - sel(cpu16[step])).max())}
            if not (np.isfinite(card16[step]).all()
                    and ratio <= BF16_FACTOR):
                fail(f"bf16 logits {arch} {step}: card gap {gap_card} over "
                     f"the CPU's bf16 gap {gap_cpu} = {ratio} (limit "
                     f"{BF16_FACTOR})")
    line("bf16_logits", seconds=round(time.perf_counter() - t0, 3),
         limit_ratio=BF16_FACTOR, **out)


# The ring serve: starcoder2-15b at its published widths (profile_serve.
# ring_config, RING_ENGINE_KW, ring_workload); RING_LAYERS cuts its depth
# when the script's time limit forces it (None: all 40 layers).
RING_LAYERS = None
RING_COUNTERS = ("steps", "mixed_steps", "decoded_tokens",
                 "kv_blocks_visited", "kv_blocks_dense", "prefix_hit_ratio",
                 "pages_shared", "preemptions")


def ring_counters(eng, summ):
    """The ring serve's host counters: RING_COUNTERS, the K/V tokens read
    per attention layer by ring (the K/V bytes the engine prices, over its
    bytes per token and its layers), the K/V token writes and the pages
    copied on write."""
    st = eng.decode_stats
    per_layer = st["kv_bytes_per_token"] * max(st["decoded_tokens"], 1) \
        / (eng._kv_token_bytes * eng.model.cfg.n_layers)
    return dict({k: st[k] for k in RING_COUNTERS},
                kv_tokens_read_per_layer={str(eng.slots.width): round(
                    per_layer)},
                kv_token_writes=summ["kv_token_writes"],
                pages_copied=summ["pages_copied"])


def phase_ring_serve(torch, np):
    """starcoder2-15b at its published widths (RING_LAYERS: the depth),
    bf16 weights from seed 0, served through the default EngineConfig
    (mixed, paged, sharing on) over sliding-window ring lanes of 4096
    tokens: ``profile_serve.ring_workload`` (12 greedy requests, short
    prompts, prompts that cross the window while decoding, two of them
    sharing a 2048-token prefix, prompts that wrap inside their chunks;
    token ids below 256). 12/12 ``ok`` with serve_run's launch checks,
    one ring class of 4096 positions holding at most 32 pages per slot,
    pages shared and at least one ring copy-on-write, and every host
    counter (``ring_counters``) equal to the port's CPU run of the same
    workload on starcoder2 smoke with a window of 4096, float32. Reports
    tok/s, TTFT p50/p99 and decode-step ms with the card's name and power
    limit. Returns the serve's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import (RING_ENGINE_KW,
                                                  ring_config, ring_workload)
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig
    t0 = time.perf_counter()
    kw = RING_ENGINE_KW

    def traffic(n):
        return ring_workload(256, n)

    scfg = get_config("starcoder2-15b", "smoke", dtype="float32",
                      sliding_window=4096)
    smodel = Model(scfg, device="cpu")
    eng = Engine(smodel, smodel.init(seed=0), config=EngineConfig(**kw))
    warm, up_front, arrivals, lengths = traffic(kw["max_new_tokens"])
    eng.submit(warm)
    eng.run()
    for r in up_front:
        eng.submit(r)
    copied0 = eng.slots.pages_copied
    done = eng.run(arrivals=arrivals)
    if len(done) != len(up_front) + len(arrivals) or any(
            r.status != "ok" for r in done):
        fail("ring_serve on the CPU: not every request ok")
    eng.slots.pool.check_invariants()
    st = eng.decode_stats
    cpu = ring_counters(eng, {
        "kv_token_writes": st["prefill_chunk_tokens"] + st["decoded_tokens"]
        + eng.page_size * (eng.slots.pages_copied - copied0),
        "pages_copied": eng.slots.pages_copied - copied0})
    cpu_s = time.perf_counter() - t0
    del eng, smodel
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    cfg = ring_config(RING_LAYERS)
    model = Model(cfg)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    reduced = {"n_layers": f"40 -> {cfg.n_layers} (depth only)"} \
        if cfg.n_layers != 40 else {}
    summ, launches, _, eng = serve_run(
        torch, np, model, params, kw, traffic=traffic, reduced=reduced,
        prefix_share=True)
    pool = eng.slots.pool
    classes = {w: tuple(c.table.shape) for w, c in pool.classes.items()}
    if list(classes) != [cfg.sliding_window] or \
            classes[cfg.sliding_window][1] != cfg.sliding_window \
            // kw["page_size"]:
        fail(f"ring_serve: page classes {classes}, want one ring of "
             f"{cfg.sliding_window} positions in 32 pages")
    got = ring_counters(eng, summ)
    if got != cpu:
        fail(f"ring_serve: host counters {got} != the CPU smoke run's {cpu}")
    if not (got["pages_shared"] > 0 and got["pages_copied"] > 0):
        fail(f"ring_serve: no shared prefix or no ring copy-on-write ({got})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    line("ring_serve", seconds=round(time.perf_counter() - t0, 3),
         cpu_smoke_s=cpu_s, init_s=init_s, card=smi,
         page_classes=classes, host_counters_equal_cpu_smoke=True,
         host_counters=got, prompt_lengths=lengths.tolist(),
         **{k: v for k, v in summ.items() if k != "launches"},
         launches={k: v for k, v in launches.items() if v})
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The MoE smoke comparisons (phase moe_tokens): dbrx and arctic smoke at
# float32 with the published capacity factor (the smoke configs' 2.0 and
# 8.0 never drop a claim), dense and compressed weights, the CPU tests'
# traffic (tests/test_torch_moe.py) through the mixed and the serialized
# paged engines.
MOE_CF = 1.25
MOE_ARCHS = ("dbrx-132b", "arctic-480b")
MOE_FCFG = dict(enabled=True, min_dim=32, rank=32, nnz=8)
MOE_LENGTHS = [3, 11, 25, 7, 40, 45, 33]
MOE_BUDGETS = [4, 2, 12, 3, 6, 9, 5]
MOE_SMOKE_KW = dict(max_len=16, max_new_tokens=12, num_slots=3,
                    max_prompt_len=48)
MOE_ENGINES = {"mixed": {}, "serialized_paged": {"mixed": False}}
MOE_LOGIT_TOL = 1e-4  # f32 logits, card kernels vs the CPU's plain path


def moe_smoke(arch, fmt):
    """(CPU model, CPU params, card model, card params): ``arch`` smoke at
    float32 with capacity factor MOE_CF, weights from seed 0 drawn on the
    CPU; ``compressed``: factorized (MOE_FCFG), W_D projected and the tree
    compressed on the CPU, then copied."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import (FactorizationConfig,
                                             project_wd_leaves)
    from repro_torch.models.transformer import Model
    over = {}
    if fmt == "compressed":
        over["factorization"] = FactorizationConfig(**MOE_FCFG)
    cfg = get_config(arch, "smoke", dtype="float32", **over)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CF))
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(seed=0)
    if fmt == "compressed":
        cpu_model, params, _ = cpu_model.compress_params(
            project_wd_leaves(params, cfg.factorization))
    return cpu_model, params, Model(cpu_model.cfg), tree_to(params, "cuda")


def moe_mixed_step(torch, np, model, params, dev):
    """One mixed step over paged lanes (4 rows of 6 columns: a chunk row, a
    decode row with five columns past ``n_new``, an inert row, a row whose
    chunk was deferred) on ``dev``; returns (all-column logits on the
    host, the router's counts of the step)."""
    from repro_torch.models import moe
    cfg = model.cfg
    rng = np.random.default_rng(31)
    B, S, ps, n = 4, 6, 8, 3
    P = B * n + 2
    bt = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    shape = (cfg.n_layers, P, ps, cfg.kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    moe.reset_router_counts()
    logits, _ = model.mixed_step(
        params, {"inputs": T(toks)}, {"k": T(k), "v": T(v)},
        T(np.array([5, 14, 9, 11], np.int32)),
        T(np.array([4, 1, 3, 0], np.int32)),
        slot_mask=T(np.array([True, True, False, True])),
        pages={"bt": T(bt), "width": n * ps, "page_size": ps})
    return logits.float().cpu(), moe.router_counts()


def phase_moe_tokens(torch, np):
    """dbrx and arctic smoke at float32 with capacity factor 1.25, dense and
    compressed weights: the mixed and serialized paged engines on the card
    through the kernels (``decode_attn="tda"``: the mixed kernel in its
    all-columns mode) and through the plain path (``"dense"``), and on the
    CPU in both modes, give the same tokens, host counters and (mode by
    mode) drops, and the kernel run drops claims; one mixed step carrying
    a decode row while capacity binds (drops counted by the port's router)
    gives the CPU's logits on every column, the five past the decode row's
    ``n_new`` included, within MOE_LOGIT_TOL, with the CPU's drops.
    Returns the line's summary."""
    from repro_torch.kernels.tda import tda
    from repro_torch.models import moe
    from repro_torch.serve import Engine, EngineConfig, Request
    keys = ("steps", "mixed_steps", "decoded_tokens", "kv_blocks_visited",
            "weight_bytes_per_step", "prefix_hit_ratio", "preemptions")
    out = {}
    for arch in MOE_ARCHS:
        for fmt in ("dense", "compressed"):
            cpu_model, cpu_params, model, params = moe_smoke(arch, fmt)
            rng = np.random.default_rng(1)
            prompts = [rng.integers(0, 256, size=n).astype(np.int32)
                       for n in MOE_LENGTHS]
            label = f"{arch}:{fmt}"
            for eng_label, kw in MOE_ENGINES.items():
                runs = {}
                for where, m, prm, mode in (
                        ("card_tda", model, params, "tda"),
                        ("card_dense", model, params, "dense"),
                        ("cpu_tda", cpu_model, cpu_params, "tda"),
                        ("cpu_dense", cpu_model, cpu_params, "dense")):
                    eng = Engine(m, prm, config=EngineConfig(
                        decode_attn=mode, **MOE_SMOKE_KW, **kw))
                    for i, (pr, b) in enumerate(zip(prompts, MOE_BUDGETS)):
                        eng.submit(Request(rid=i, prompt=pr,
                                           max_new_tokens=b))
                    tda.reset_launch_counts()
                    moe.reset_router_counts()
                    done = eng.run()
                    if len(done) != len(prompts) or any(
                            r.status != "ok" for r in done):
                        fail(f"moe_tokens {label} {eng_label} {where}: "
                             "not every request ok")
                    drops = moe.router_counts()
                    if where == "card_tda":
                        mixed = tda.LAUNCHES["tda_mixed_attention"]
                        allc = tda.MODE_LAUNCHES[
                            "tda_mixed_attention.all_columns"]
                        if not tda.LAUNCHES["tda_paged_decode_attention"] \
                                or mixed != allc \
                                or bool(mixed) != (eng_label == "mixed"):
                            fail(f"moe_tokens {label} {eng_label}: launched "
                                 f"{tda.LAUNCHES}, all-columns {allc}")
                        if not drops["dropped"]:
                            fail(f"moe_tokens {label} {eng_label}: no claim "
                                 f"dropped ({drops})")
                    runs[where] = ({r.rid: list(r.output) for r in done},
                                   {k: eng.decode_stats[k] for k in keys},
                                   drops)
                toks = [r[0] for r in runs.values()]
                if any(t != toks[0] for t in toks):
                    fail(f"moe_tokens {label} {eng_label}: tokens differ "
                         f"(card kernels, card plain path, CPU): {runs}")
                # the same counters everywhere; the same drops as the CPU's
                # in each mode (idle decode rows attend nothing: zeros on
                # the kernel path, the uniform average on the dense one)
                for mode in ("tda", "dense"):
                    if runs[f"card_{mode}"][1:] != runs[f"cpu_{mode}"][1:]:
                        fail(f"moe_tokens {label} {eng_label} {mode}: host "
                             f"counters and drops {runs[f'card_{mode}'][1:]}"
                             f" != the CPU's {runs[f'cpu_{mode}'][1:]}")
                out[f"{label}:{eng_label}"] = dict(
                    runs["cpu_tda"][1], drops_tda=runs["cpu_tda"][2],
                    drops_dense=runs["cpu_dense"][2])
            got, drops = moe_mixed_step(torch, np, model.with_decode_attn(
                "tda"), params, "cuda")
            want, cpu_drops = moe_mixed_step(torch, np, cpu_model, cpu_params,
                                             "cpu")
            err = (got - want).abs().max().item()
            if not (err <= MOE_LOGIT_TOL and drops["dropped"] > 0
                    and drops == cpu_drops):
                fail(f"moe_tokens {label}: mixed-step logits on all columns "
                     f"{err} from the CPU's (limit {MOE_LOGIT_TOL}); drops "
                     f"{drops}, CPU {cpu_drops}")
            out[f"{label}:mixed_step"] = {"max_abs_err_all_columns": err,
                                          **drops}
            del model, params, cpu_model, cpu_params
    return {"capacity_factor": MOE_CF, "prompt_lengths": MOE_LENGTHS,
            "tokens_identical_kernels_plain_cpu": True, "runs": out}


MOE_COUNTERS = ("steps", "mixed_steps", "decoded_tokens", "kv_blocks_visited",
                "kv_blocks_dense", "prefix_hit_ratio", "preemptions")


def phase_moe_serve(torch, np):
    """dbrx-132b at its published widths (``profile_serve.moe_config``: 16
    experts of 10752, top-4, capacity factor 1.25, 48 q / 8 kv heads of
    128, vocab 100352; depth cut to MOE_LAYERS), bf16 weights from seed 0,
    through the mixed engine with ENGINE_KW on ``profile_serve.workload``:
    16/16 ``ok`` with serve_run's launch checks, every mixed launch in the
    all-columns mode, claims dropped, and the host counters
    (``MOE_COUNTERS``) equal to the port's CPU run of the same prompt
    lengths and arrivals on dbrx smoke at float32 with capacity factor
    1.25 (token ids taken modulo 256). Reports tok/s, TTFT p50/p99 and
    decode- and mixed-step ms with the card's name and power limit.
    Returns the serve's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import params_stream_bits
    from repro_torch.kernels.tda import tda
    from repro_torch.launch.profile_serve import (ENGINE_KW, MOE_LAYERS,
                                                  moe_config, workload)
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    t0 = time.perf_counter()
    cfg = moe_config(MOE_LAYERS)
    kw = ENGINE_KW

    def traffic(n):
        return workload(cfg.vocab_size, n)

    # The CPU half: the same lengths, budgets and arrival ticks.
    scfg = get_config("dbrx-132b", "smoke", dtype="float32")
    scfg = dataclasses.replace(scfg, moe=dataclasses.replace(
        scfg.moe, capacity_factor=cfg.moe.capacity_factor))
    smodel = Model(scfg, device="cpu")
    eng = Engine(smodel, smodel.init(seed=0), config=EngineConfig(
        prefix_share=False, **kw))

    def small(r):
        return Request(rid=r.rid, prompt=r.prompt % 256,
                       max_new_tokens=r.max_new_tokens)

    warm, up_front, arrivals, lengths = traffic(kw["max_new_tokens"])
    eng.submit(small(warm))
    eng.run()
    for r in up_front:
        eng.submit(small(r))
    done = eng.run(arrivals=[(t, small(r)) for t, r in arrivals])
    if len(done) != len(up_front) + len(arrivals) or any(
            r.status != "ok" for r in done):
        fail("moe_serve on the CPU: not every request ok")
    cpu = {k: eng.decode_stats[k] for k in MOE_COUNTERS}
    cpu_s = time.perf_counter() - t0
    del eng, smodel
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model = Model(cfg)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    weights_gb = params_stream_bits(params) / 8e9
    moe.reset_router_counts()
    summ, launches, _, eng = serve_run(
        torch, np, model, params, kw, traffic=traffic,
        reduced={"n_layers": f"40 -> {cfg.n_layers} (depth only)"})
    drops = moe.router_counts()  # warm-up request included
    st = eng.decode_stats
    allc = tda.MODE_LAUNCHES["tda_mixed_attention.all_columns"]
    if allc != launches["tda_mixed_attention"] or not allc:
        fail(f"moe_serve: {allc} all-columns mixed launches of "
             f"{launches['tda_mixed_attention']}")
    if not drops["dropped"]:
        fail(f"moe_serve: no claim dropped at capacity factor "
             f"{cfg.moe.capacity_factor} ({drops})")
    got = {k: st[k] for k in MOE_COUNTERS}
    if got != cpu:
        fail(f"moe_serve: host counters {got} != the CPU smoke run's {cpu}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    line("moe_serve", seconds=round(time.perf_counter() - t0, 3),
         cpu_smoke_s=cpu_s, init_s=init_s, card=smi, weights_gb=weights_gb,
         experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
         capacity_factor=cfg.moe.capacity_factor,
         host_counters_equal_cpu_smoke=True, host_counters=got,
         router=drops, mixed_all_columns_launches=allc,
         **{k: v for k, v in summ.items() if k != "launches"},
         launches={k: v for k, v in launches.items() if v})
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The recurrent smoke comparisons (phase recurrent_tokens): mamba2 and
# recurrentgemma smoke at float32, the CPU tests' traffic
# (tests/test_torch_recurrent_engine.py: prompts past the SSD chunk and past
# the window of 32, two arriving mid-decode), recurrentgemma paged and
# contiguous.
REC_SMOKE = {"mamba2-370m": ([3, 7, 5, 8, 4, 20, 33], [4, 3, 2, 4, 3, 5, 4]),
             "recurrentgemma-2b": ([3, 11, 7, 5, 9, 40, 37],
                                   [4, 2, 5, 3, 4, 5, 6])}
REC_TICKS = [0, 0, 0, 0, 0, 2, 5]
REC_SMOKE_KW = dict(max_len=16, max_new_tokens=8, num_slots=2,
                    max_prompt_len=48)
REC_COUNTERS = ("steps", "decoded_tokens", "slot_utilization",
                "kv_blocks_visited", "kv_blocks_dense", "preemptions",
                "kv_pages_total", "kv_memory_ratio", "prefix_hit_ratio",
                "pages_shared", "device_time")


def rec_engine_runs(torch, np, arch, engines):
    """``arch`` smoke at float32 (weights from seed 0 drawn on the CPU)
    through each of ``engines`` ({label: EngineConfig overrides}) on the
    card with the kernels (``decode_attn="tda"``), on the card through the
    plain path (``"dense"``) and on the CPU: {label: {where: (tokens,
    counters, sweeps, launches)}}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.tda import tda
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    cfg = get_config(arch, "smoke", dtype="float32")
    lengths, budgets = REC_SMOKE[arch]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    model = Model(cfg)
    params = tree_to(cpu_params, "cuda")
    out = {}
    for label, kw in engines.items():
        out[label] = {}
        for where, m, prm, mode in (("card_tda", model, params, "tda"),
                                    ("card_dense", model, params, "dense"),
                                    ("cpu", cpu_model, cpu_params, "dense")):
            eng = Engine(m, prm, config=EngineConfig(
                decode_attn=mode, **REC_SMOKE_KW, **kw))
            reqs = [Request(rid=i, prompt=p, max_new_tokens=b)
                    for i, (p, b) in enumerate(zip(prompts, budgets))]
            for t, r in zip(REC_TICKS, reqs):
                if not t:
                    eng.submit(r)
            tda.reset_launch_counts()
            done = eng.run(arrivals=[(t, r) for t, r in zip(REC_TICKS, reqs)
                                     if t])
            if len(done) != len(reqs) or any(r.status != "ok"
                                             for r in done):
                fail(f"{arch} {label} {where}: not every request ok")
            out[label][where] = (
                {r.rid: list(r.output) for r in done},
                {k: eng.decode_stats[k] for k in REC_COUNTERS},
                [(w["rows"], w["n_requests"]) for w in eng.stats],
                {k: n for k, n in tda.LAUNCHES.items() if n})
    return out


def phase_recurrent_tokens(torch, np):
    """mamba2 and recurrentgemma smoke at float32 (REC_SMOKE): the
    Engine's tokens through the decode kernels equal its tokens through
    the plain path (``decode_attn="dense"``) and the CPU's; its host
    counters and prefill sweeps (one row per request) equal the CPU run's;
    recurrentgemma's contiguous and paged runs give the same tokens; the
    kernel runs launch the decode kernel of their lanes (recurrentgemma's
    local layers) and mamba2 none. Returns the line's summary."""
    want = {("recurrentgemma-2b", "paged"): ["tda_paged_decode_attention"],
            ("recurrentgemma-2b", "contiguous"): ["tda_decode_attention"],
            ("mamba2-370m", "default"): []}
    out = {}
    for arch, engines in (("mamba2-370m", {"default": {}}),
                          ("recurrentgemma-2b",
                           {"paged": {}, "contiguous": {"paged": False}})):
        runs = rec_engine_runs(torch, np, arch, engines)
        for label, r in runs.items():
            toks = {w: x[0] for w, x in r.items()}
            if not toks["card_tda"] == toks["card_dense"] == toks["cpu"]:
                fail(f"recurrent_tokens {arch} {label}: tokens differ "
                     f"(kernels, plain path, CPU): {toks}")
            if r["card_tda"][1:3] != r["cpu"][1:3]:
                fail(f"recurrent_tokens {arch} {label}: host counters "
                     f"{r['card_tda'][1:3]} != the CPU run's "
                     f"{r['cpu'][1:3]}")
            if sorted(r["card_tda"][3]) != want[arch, label]:
                fail(f"recurrent_tokens {arch} {label}: launched "
                     f"{r['card_tda'][3]}, want {want[arch, label]}")
            out[f"{arch}:{label}"] = dict(r["cpu"][1], sweeps=r["cpu"][2],
                                          launches=r["card_tda"][3])
        if arch == "recurrentgemma-2b" and \
                runs["paged"]["cpu"][0] != runs["contiguous"]["cpu"][0]:
            fail("recurrent_tokens: recurrentgemma's paged and contiguous "
                 "runs give other tokens")
    return {"tokens_identical_kernels_plain_cpu": True,
            "recurrentgemma_paged_equals_contiguous": True, "runs": out}


# The recurrent serves (phase recurrent_serve): each config at its
# published widths and full depth, bf16 weights from seed 0
# (profile_serve.recurrent_config), through the default EngineConfig with
# ENGINE_KW on profile_serve.workload; recurrentgemma then again with
# contiguous lanes on the same params.
REC_SERVE_COUNTERS = ("steps", "mixed_steps", "decoded_tokens",
                      "kv_blocks_visited", "kv_blocks_dense", "preemptions",
                      "kv_pages_total", "kv_memory_ratio", "slot_utilization",
                      "device_time")


def phase_recurrent_serve(torch, np):
    """recurrentgemma-2b (26 layers, ~5.8 GB) and mamba2-370m (48 layers,
    ~0.74 GB) at their published widths and full depth, bf16 weights, each
    serving ``profile_serve.workload`` (16 greedy requests, prompts in [32,
    512]) through the default EngineConfig (serialized; paged for
    recurrentgemma, whose local layers' lanes are 544 positions of the
    2048 window; unpaged state lanes for mamba2): 16/16 ``ok`` with
    serve_run's launch checks (the decode kernel once per attention layer
    per decode step), every host counter and prefill sweep equal to the
    port's CPU run of the same prompt lengths and arrivals on the smoke
    config at float32 (token ids modulo 256; recurrentgemma at window
    2048 and attention chunks of 512, mamba2 at SSD chunk 128), and a
    short profiled window (launches
    and device ms per decode step and prefill sweep). recurrentgemma is
    served once more with contiguous lanes. Reports tok/s, TTFT p50/p99,
    decode-step and prefill-sweep ms and rows per sweep with the card's
    name and power limit. Returns {arch (or "recurrentgemma-2b.contiguous"):
    launches}."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import params_stream_bits
    from repro_torch.launch.profile_serve import (ENGINE_KW,
                                                  recurrent_config, workload)
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Engine, EngineConfig, Request
    kw = ENGINE_KW
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {}
    for arch in ("recurrentgemma-2b", "mamba2-370m"):
        t0 = time.perf_counter()
        cfg = recurrent_config(arch)
        runs = {"default": {}}
        if arch == "recurrentgemma-2b":
            runs["contiguous"] = {"paged": False}

        def traffic(n, cfg=cfg):
            return workload(cfg.vocab_size, n)

        def small(r):
            return Request(rid=r.rid, prompt=r.prompt % 256,
                           max_new_tokens=r.max_new_tokens)

        scfg = get_config(arch, "smoke", dtype="float32")
        if arch == "recurrentgemma-2b":  # the full config's window and
            # attention chunks (the smoke config's 16 would walk the window
            # in 129 chunk sums per padded row)
            scfg = dataclasses.replace(scfg, local_window=cfg.local_window,
                                       attn_chunk=cfg.attn_chunk)
        else:
            scfg = dataclasses.replace(scfg, ssm=dataclasses.replace(
                scfg.ssm, chunk=cfg.ssm.chunk))
        smodel = Model(scfg, device="cpu")
        sparams = smodel.init(seed=0)
        cpu = {}
        for label, over in runs.items():
            eng = Engine(smodel, sparams, config=EngineConfig(**over, **kw))
            warm, up_front, arrivals, _ = traffic(kw["max_new_tokens"])
            eng.submit(small(warm))
            eng.run()
            n0 = len(eng.stats)
            for r in up_front:
                eng.submit(small(r))
            done = eng.run(arrivals=[(t, small(r)) for t, r in arrivals])
            if len(done) != len(up_front) + len(arrivals) or any(
                    r.status != "ok" for r in done):
                fail(f"recurrent_serve {arch} on the CPU: not every "
                     "request ok")
            cpu[label] = ({k: eng.decode_stats[k]
                           for k in REC_SERVE_COUNTERS},
                          [(w["rows"], w["n_requests"])
                           for w in eng.stats[n0:]])
            del eng
        cpu_s = time.perf_counter() - t0
        del smodel, sparams
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        model = Model(cfg)
        params = model.init(seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        weights_gb = params_stream_bits(params) / 8e9
        for label, over in runs.items():
            gc.collect()
            torch.cuda.empty_cache()
            t2 = time.perf_counter()
            summ, launches, _, eng = serve_run(
                torch, np, model, params, kw, traffic=traffic, reduced={},
                prefix_share=True, **over)
            st = eng.decode_stats
            sweeps = [(w["rows"], w["n_requests"])
                      for w in eng.stats[len(eng.stats)
                                         - summ["prefill_sweeps"]:]]
            got = ({k: st[k] for k in REC_SERVE_COUNTERS}, sweeps)
            if got != cpu[label]:
                fail(f"recurrent_serve {arch} {label}: host counters "
                     f"{got} != the CPU smoke run's {cpu[label]}")
            if summ["engine"] != "serialized" or eng.prefix_share or \
                    eng.paged != (arch == "recurrentgemma-2b"
                                  and label == "default"):
                fail(f"recurrent_serve {arch} {label}: engine "
                     f"{summ['engine']}, paged {eng.paged}, sharing "
                     f"{eng.prefix_share}")
            prof = short_profile(torch, eng, kw, kinds=("decode",
                                                        "prefill"))
            out[arch if label == "default" else f"{arch}.{label}"] = \
                launches
            line("recurrent_serve", arch=arch, lanes_run=label,
                 seconds=round(time.perf_counter() - t2, 3),
                 cpu_smoke_s=cpu_s, init_s=init_s, card=smi,
                 weights_gb=weights_gb, host_counters_equal_cpu_smoke=True,
                 host_counters=got[0], sweeps_rows_requests=got[1],
                 short_window_profile=prof,
                 **{k: v for k, v in summ.items() if k != "launches"},
                 launches={k: v for k, v in launches.items() if v})
            del eng
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


# The external-embeddings phase (embeds): llava-next-mistral-7b (32
# layers, ~14 GB in bf16) and musicgen-large (48 layers, ~4.9 GB) at their
# published widths, full depth, bf16 weights, one after the other. The
# check runs at float32 compute over those weights: at bf16 compute the
# 32 layers' roundings alone move llava's decode logits ~0.02 off the full
# forward on an H100 (PERF.md), the bound itself, whichever attention path
# decodes; so bf16 compute is reported beside the plain path's and held to
# BF16_FACTOR times its drift.
EMBEDS_ARCHS = ("llava-next-mistral-7b", "musicgen-large")
EMBEDS_PREFILL = 512
EMBEDS_DECODE = 8
EMBEDS_REL = 0.02  # tests/test_models_smoke.py's bound, relative to max |full|


def embeds_run(torch, model, params, x):
    """``Model.prefill`` of ``x[:, :EMBEDS_PREFILL]`` then EMBEDS_DECODE
    ``decode_step``s: (the logits of each position from the prefill's last
    on, host ms per decode step, TDA launches)."""
    from repro_torch.kernels.tda import tda
    P, n = EMBEDS_PREFILL, EMBEDS_DECODE
    tda.reset_launch_counts()
    lg, caches = model.prefill(params, {"embeds": x[:, :P]}, max_len=P + n)
    steps, ms = [lg], []
    for i in range(P, P + n):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, caches = model.decode_step(
            params, {"embeds": x[:, i:i + 1]}, caches,
            torch.full((2,), i, dtype=torch.int64, device="cuda"))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        steps.append(lg)
    return steps, ms, dict(tda.LAUNCHES)


def phase_embeds(torch, np):
    """Seeded (2, EMBEDS_PREFILL, d) embeds through ``Model.prefill``, then
    EMBEDS_DECODE ``decode_step``s on the contiguous decode kernel (llava
    G = 4, D = 128; musicgen G = 1, D = 64), bf16 weights from seed 0. At
    float32 compute, each decode position's logits (and the prefill's
    last) within EMBEDS_REL of the full forward's, relative to its largest
    magnitude (the reference test's bound); at bf16 compute the kernel
    path's largest such drift within BF16_FACTOR times the plain path's
    (``decode_attn="dense"``). musicgen's logits (2, 1, 4, 2048); every
    kernel run launches the contiguous decode kernel once per layer and
    step. Memory freed between the models. Returns {arch: decode
    launches}."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import params_stream_bits
    from repro_torch.models.transformer import Model
    out = {}
    P, n = EMBEDS_PREFILL, EMBEDS_DECODE
    for arch in EMBEDS_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch, "full", param_dtype="bfloat16")
        params = Model(cfg).init(seed=0)
        weights_gb = params_stream_bits(params) / 8e9
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((2, P + n, cfg.d_model), generator=g,
                        device="cuda")
        want_shape = (2, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1
                               else ()) + (cfg.vocab_size,)
        L = cfg.n_layers
        res = {}
        full = {}
        for label, dt, mode in (("float32", "float32", "tda"),
                                ("bfloat16", "bfloat16", "tda"),
                                ("bfloat16_plain", "bfloat16", "dense")):
            model = Model(dataclasses.replace(cfg, dtype=dt)) \
                .with_decode_attn(mode)
            with torch.inference_mode():
                steps, ms, launches = embeds_run(torch, model, params, x)
                if dt not in full:
                    full[dt] = model.apply(params, {"embeds": x})[0]
            if tuple(steps[-1].shape) != want_shape:
                fail(f"embeds {arch} {label}: decode logits "
                     f"{tuple(steps[-1].shape)}, want {want_shape}")
            rel = []
            for j, lg in enumerate(steps):  # position P - 1 + j
                a, b = full[dt][:, P - 1 + j].float(), lg[:, 0].float()
                if not torch.isfinite(b).all():
                    fail(f"embeds {arch} {label}: non-finite logits at "
                         f"{P - 1 + j}")
                rel.append((a - b).abs().max().item()
                           / a.abs().max().item())
            want = {"tda_decode_attention": L * n if mode == "tda" else 0,
                    "tda_paged_decode_attention": 0,
                    "tda_mixed_attention": 0}
            if launches != want:
                fail(f"embeds {arch} {label}: launches {launches}, want "
                     f"{want}")
            res[label] = {"rel_err_vs_full": rel, "decode_step_ms": ms,
                          "tda_decode_launches":
                              launches["tda_decode_attention"]}
            del model, steps
        if max(res["float32"]["rel_err_vs_full"]) >= EMBEDS_REL:
            fail(f"embeds {arch}: float32 decode vs full forward "
                 f"{res['float32']['rel_err_vs_full']} (limit {EMBEDS_REL})")
        kern = max(res["bfloat16"]["rel_err_vs_full"])
        plain = max(res["bfloat16_plain"]["rel_err_vs_full"])
        if kern > BF16_FACTOR * plain:
            fail(f"embeds {arch}: bf16 drift through the kernel {kern} > "
                 f"{BF16_FACTOR} x the plain path's {plain}")
        out[arch] = res["float32"]["tda_decode_launches"] \
            + res["bfloat16"]["tda_decode_launches"]
        line("embeds", arch=arch, seconds=round(time.perf_counter() - t0, 3),
             weights_gb=weights_gb, n_layers=L, d_model=cfg.d_model,
             heads=[cfg.n_heads, cfg.kv_heads, cfg.head_dim],
             n_codebooks=cfg.n_codebooks, prefill=P, decode_steps=n,
             logits_shape=list(want_shape), limit=EMBEDS_REL,
             bf16_factor=BF16_FACTOR, bf16_drift_kernel_over_plain=(
                 kern / plain if plain else None), runs=res,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
        del params, full, x
        gc.collect()
        torch.cuda.empty_cache()
    return out


# The paper's evaluation models (phase paper_models): bert, vit, mt and s2t
# at their published widths and full depth, f32 compute, TF32 off.
PAPER_INPUTS = {"bert": (128, None), "vit": (197, None), "mt": (64, 48),
                "s2t": (256, 48)}  # (source positions, target positions)
PAPER_PAD = {"mt": 50, "s2t": 200}  # row 1's source is padded from here
# Card against CPU: f32 sums in other orders through 12-18 layers and the
# f32 head (the CPU tests measure 8.5e-7 of the largest logit at 2 narrow
# layers), relative to the largest CPU logit; losses relative to the loss.
PAPER_CPU_REL = 1e-4
# The compressed forward through DMM / SMM against its decompressed plain
# version on the card (and the card's compressed forward against the CPU's
# plain one): each linear within phase 5's TOL of its largest output, the
# SMM tensor-core body's bf16 parts within 2^-16 of each term; relative to
# the largest logit.
PAPER_KERNEL_REL = 1e-3
PAPER_REQUESTS = 64  # bert requests of request_lengths(64, 128, "bert")
PAPER_REPS = 5       # timed forwards per (format, dtype, layout)


def paper_batch(torch, np, name, cfg):
    """Seeded numpy inputs at ``PAPER_INPUTS``' lengths, two rows: bert
    token ids, vit patch embeddings, mt source ids and s2t fbank frames
    (row 1's source padded from ``PAPER_PAD``), targets and labels."""
    rng = np.random.default_rng(0)
    S, St = PAPER_INPUTS[name]
    V = cfg.vocab_size
    if name == "bert":
        return {"inputs": rng.integers(0, V, (2, S)).astype(np.int32)}
    if name == "vit":
        return {"embeds": rng.standard_normal((2, S, cfg.d_model)).astype(
            np.float32)}
    seg = np.ones((2, S), np.int32)
    seg[1, PAPER_PAD[name]:] = 0
    b = {"src_seg": seg, "tgt": rng.integers(0, V, (2, St)).astype(np.int32),
         "labels": rng.integers(0, V, (2, St)).astype(np.int32)}
    if name == "s2t":
        b["src_feats"] = rng.standard_normal((2, S, 80)).astype(np.float32)
    else:
        b["src"] = rng.integers(0, V, (2, S)).astype(np.int32)
    return b


def paper_forward(model, params, batch):
    """(logits, loss or None) of one forward."""
    if hasattr(model, "encode"):
        logits = model.decode(params, model.encode(params, batch), batch)
        return logits, model.loss(params, batch)[0]
    return model.apply(params, batch)[0], None


def paper_compare(torch, got, want, loss_got, loss_want, lim, what):
    """Largest gap relative to the largest reference logit (and the loss
    gap relative to the loss); fails past ``lim``."""
    if not torch.isfinite(got).all():
        fail(f"paper_models {what}: non-finite logits")
    g, w = got.float().cpu(), want.float().cpu()
    rel = ((g - w).abs().max() / w.abs().max()).item()
    out = {"logits_rel": rel}
    if loss_want is not None:
        out["loss_rel"] = abs(float(loss_got) - float(loss_want)) \
            / abs(float(loss_want))
    if max(out.values()) > lim:
        fail(f"paper_models {what}: {out} past {lim}")
    return out


def paper_bert_batching(torch, np, cfg, trees):
    """(c) and (d): the paper's dynamic batching on bert. Requests of
    ``request_lengths(PAPER_REQUESTS, 128, "bert")`` packed by
    ``pack_requests(PackingPolicy(128, 4))`` (segment ids, within-request
    positions) against one request a row (``max_len`` slots each, the
    unpacked baseline). At f32: each request's logits in the packed forward
    against a forward of that request alone (dense within PAPER_CPU_REL,
    compressed within PAPER_KERNEL_REL). The encoder forward's
    (``Model.hidden``) tokens/s over the live tokens (the median
    synchronized host wall, ``host_ms``), packed and unpacked, dense and
    compressed, at f32 and at the config's bf16, beside the forward's
    device time alone (``device_ms``: its kernels back to back, the host's
    dispatch hidden; far below ``host_ms``, the forward is host-bound).
    The bf16
    compressed packed forward is the phase's main path: its DMM and SMM
    launches are counted alone. Returns (summary, launches, packed
    tokens)."""
    from repro_torch.core.packing import (PackingPolicy, pack_requests,
                                          packing_utilization)
    from repro_torch.data import request_lengths
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.models.transformer import Model
    rng = np.random.default_rng(0)
    lens = request_lengths(PAPER_REQUESTS, 128, "bert")
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]
    pk = pack_requests(reqs, PackingPolicy(128, 4))
    unp = {"inputs": np.zeros((len(reqs), 128), np.int32),
           "positions": np.zeros((len(reqs), 128), np.int32),
           "seg_ids": np.zeros((len(reqs), 128), np.int32)}
    for i, req in enumerate(reqs):
        unp["inputs"][i, :len(req)] = req
        unp["positions"][i, :len(req)] = np.arange(len(req))
        unp["seg_ids"][i, :len(req)] = 1
    layouts = {"packed": {"inputs": pk.tokens, "positions": pk.positions,
                          "seg_ids": pk.segment_ids}, "unpacked": unp}
    layouts = {k: {n: torch.from_numpy(a).cuda() for n, a in b.items()}
               for k, b in layouts.items()}
    n_tok = int(sum(lens))
    out = {"requests": len(reqs), "tokens": n_tok, "packed_rows": pk.rows,
           "packing_utilization": packing_utilization(pk),
           "unpacked_utilization": n_tok / (len(reqs) * 128),
           "alone_rel": {}, "tok_s": {}, "host_ms": {}, "device_ms": {}}
    launches = None
    for fmt in ("dense", "compressed"):
        model = Model(dataclasses.replace(cfg, dtype="float32"), "cuda")
        params = trees[fmt]
        with torch.inference_mode():
            packed = model.apply(params, layouts["packed"])[0]
            lim = PAPER_KERNEL_REL if fmt == "compressed" else PAPER_CPU_REL
            worst = 0.0
            for req, (row, start, n) in zip(reqs, pk.request_slots):
                alone = model.apply(params, {"inputs": torch.from_numpy(
                    req[None]).cuda()})[0][0]
                got = packed[row, start:start + n]
                worst = max(worst, ((got - alone).abs().max()
                                    / alone.abs().max()).item())
            if worst > lim:
                fail(f"paper_models bert {fmt}: a packed request's logits "
                     f"{worst} from its own forward (limit {lim})")
            out["alone_rel"][fmt] = worst
            del packed
            for dt in ("float32", "bfloat16"):
                m = Model(dataclasses.replace(cfg, dtype=dt), "cuda")
                p = m.prepare(params)
                if fmt == "compressed" and dt == "bfloat16":
                    dmm.reset_launch_counts()
                    smm.reset_launch_counts()
                    m.hidden(p, layouts["packed"])
                    torch.cuda.synchronize()
                    launches = {**dmm.LAUNCHES, **smm.LAUNCHES,
                                **dmm.BODY_LAUNCHES, **smm.BODY_LAUNCHES}
                for lay, batch in layouts.items():
                    m.hidden(p, batch)
                    torch.cuda.synchronize()
                    ts = []
                    for _ in range(PAPER_REPS):
                        t1 = time.perf_counter()
                        m.hidden(p, batch)
                        torch.cuda.synchronize()
                        ts.append(time.perf_counter() - t1)
                    ts.sort()
                    key = f"{fmt}/{dt}/{lay}"
                    out["tok_s"][key] = n_tok / ts[len(ts) // 2]
                    out["host_ms"][key] = ts[len(ts) // 2] * 1e3
                    out["device_ms"][key] = device_ms(
                        torch, lambda: m.hidden(p, batch), PAPER_REPS)
                del p
    want = cfg.n_layers * 6  # q, k, v, o, up, down in every layer
    if launches["dmm_matmul"] != want or launches["smm_matmul"] != want:
        fail(f"paper_models bert: DMM / SMM launches {launches} in the bf16 "
             f"compressed packed forward, want {want} each")
    out["launches"] = launches
    return out, launches, pk.rows * 128


def paper_rows(torch, np, cparams, M, launches):
    """(d) The kernels-line rows ``dmm_matmul.bert`` (ffn_down's dictionary:
    K 3072, N = r 512, bf16 x) and ``smm_matmul.bert`` (layer 0's ffn_up
    W_D: r 512, nnz 64, N 3072, f32 y) at M = the packed tokens of the bf16
    compressed forward, with that forward's launches: against their plain
    versions (phase 5's TOL), timed beside the f32 product on the
    densified matrix, and their bounds."""
    from repro_torch.core.factorized import decompress_wd_leaf
    from repro_torch.kernels.dmm.ops import lut_matmul
    from repro_torch.kernels.dmm.ref import unpack_nibbles
    from repro_torch.kernels.smm.ops import compressed_matmul
    g = torch.Generator(device="cuda").manual_seed(5)
    d = cparams["dicts"]["ffn_down"]
    codes, lut = d["codes_packed"], d["lut"]
    K, N = codes.shape[0] * 2, codes.shape[1]
    ws32 = lut[unpack_nibbles(codes).long()][:K]
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    x32 = x.float()
    up = {k: v[0] for k, v in cparams["layers"]["ffn"]["w_up"].items()
          if k.startswith("wd_")}
    r = ws32.shape[1]
    st = (up["wd_first"], up["wd_deltas"], up["wd_vq"], up["wd_scale"],
          up["wd_offset"])
    wd32 = decompress_wd_leaf(up, r)
    nnz, N2 = up["wd_vq"].shape
    y = torch.randn(M, r, generator=g, device="cuda")
    calls = {
        "dmm_matmul": (lambda: lut_matmul(x, codes, lut),
                       lambda: lut_matmul(x, codes, lut, use_kernel=False),
                       lambda: torch.matmul(x32, ws32),
                       bound(x.numel() * 2 + codes.numel() + 64 + M * N * 4,
                             2 * M * K * N, 2), "dmm.cu",
                       "src/repro/kernels/dmm/dmm.py:51",
                       {"family": "ffn_down", "M": M, "K": K, "N": N}),
        "smm_matmul": (lambda: compressed_matmul(y, *st,
                                                 value_bits=up["wd_bits"]),
                       lambda: compressed_matmul(y, *st,
                                                 value_bits=up["wd_bits"],
                                                 use_kernel=False),
                       lambda: torch.matmul(y, wd32),
                       bound(y.numel() * 4 + N2 * 4
                             + st[1].numel() * st[1].element_size()
                             + st[2].numel() + M * N2 * 4,
                             2 * M * nnz * N2, 4), "smm.cu",
                       "src/repro/kernels/smm/smm.py:63",
                       {"family": "ffn_up", "M": M, "r": r, "nnz": nnz,
                        "N": N2, "delta_dtype": str(st[1].dtype)})}
    rows = []
    for name, (fn, plain, lib, (b, by), src, repl, shape) in calls.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        lim = TOL * max(1.0, want.abs().max().item())
        if not err <= lim:
            fail(f"{name}.bert vs plain: {err} (limit {lim}) at {shape}")
        rows.append({
            "name": f"{name}.bert", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": repl, "max_abs_err": err,
            "ms": time_ms(torch, fn, 10),
            "device_ms": device_ms(torch, fn, 10),
            "plain_ms": time_ms(torch, plain, 5),
            "library_ms": time_ms(torch, lib, 10),
            "library_device_ms": device_ms(torch, lib, 10),
            "bound_ms": b, "bound_by": by,
            "launches": launches[name],
            "launches_from": "paper_models:bert_packed_bf16_compressed",
            "body_launches": {k: v for k, v in launches.items()
                              if k.startswith(name + ".")},
            "library": LINEAR_LIBRARY[name[:3]], "shape": shape})
    return rows


def phase_paper_models(torch, np):
    """The paper's four evaluation models (``models/paper_models.py``) at
    their published widths and full depth, weights from seed 0 drawn on
    the CPU (factorized ones projected to nnz per column), f32 compute, TF32
    off. (a) dense, factorized and compressed (``compress_model_params``),
    the card against the CPU on the same trees and ``paper_batch`` inputs:
    logits (bert, vit), logits and loss (mt, s2t); the compressed forward
    launches DMM and SMM once per linear per forward, the others never.
    (b) the compressed forward on the card through DMM / SMM against the
    same forward on the decompressed tree (``decompressed``:
    ``use_kernel=False``'s arithmetic). (c) and (d):
    :func:`paper_bert_batching` and :func:`paper_rows`. Returns the two
    kernel rows."""
    from repro_torch.core.factorized import (compress_model_params,
                                             project_wd_leaves)
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.dmm import dmm
    from repro_torch.kernels.smm import smm
    from repro_torch.models.paper_models import (PAPER_MODELS, EncDecModel,
                                                 paper_model_config)
    from repro_torch.models.transformer import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rows = []
    for name in PAPER_MODELS:
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        cfgs, trees = {}, {}
        for fmt in ("dense", "factorized"):
            cfg = dataclasses.replace(paper_model_config(
                name, fmt == "factorized"), dtype="float32")
            cls = EncDecModel if cfg.n_encoder_layers else Model
            params = cls(cfg, device="cpu").init(seed=0)
            if fmt == "factorized":
                params = project_wd_leaves(params, cfg.factorization)
                trees["compressed"], stats = compress_model_params(
                    params, cfg.factorization)
                cfgs["compressed"] = cfg
            cfgs[fmt], trees[fmt] = cfg, params
        n_params = {f: sum(t.numel() for _, t in tree_leaves(trees[f]))
                    for f in ("dense", "factorized")}
        n_lin = sum(v.numel() // (v.shape[-2] * v.shape[-1])
                    for path, v in tree_leaves(trees["compressed"])
                    if path[-1] == "wd_vq")
        passes = 2 if cfg.n_encoder_layers else 1  # loss: a second forward
        batch = paper_batch(torch, np, name, cfg)
        cpu_b = {k: torch.from_numpy(v) for k, v in batch.items()}
        gpu_b = {k: v.cuda() for k, v in cpu_b.items()}
        res, card = {}, {}
        for fmt, tree in trees.items():
            m_cpu, m_gpu = cls(cfgs[fmt], device="cpu"), \
                cls(cfgs[fmt], device="cuda")
            gtree = tree_map(lambda t: t.cuda(), tree)
            lim = PAPER_KERNEL_REL if fmt == "compressed" else PAPER_CPU_REL
            with torch.inference_mode():
                want, want_loss = paper_forward(m_cpu, tree, cpu_b)
                dmm.reset_launch_counts()
                smm.reset_launch_counts()
                got, got_loss = paper_forward(m_gpu, gtree, gpu_b)
                torch.cuda.synchronize()
                res[fmt] = paper_compare(torch, got, want, got_loss,
                                         want_loss, lim, f"{name} {fmt}")
                n = [dmm.LAUNCHES["dmm_matmul"], smm.LAUNCHES["smm_matmul"]]
                if n != [n_lin * passes if fmt == "compressed" else 0] * 2:
                    fail(f"paper_models {name} {fmt}: DMM / SMM launches {n}"
                         f" ({n_lin} compressed linears, {passes} forwards)")
                res[fmt]["dmm_smm_launches"] = n
                if fmt == "compressed":
                    plain = decompressed(torch, gtree, tree_map(
                        lambda t: t.cuda(), trees["factorized"]))
                    p_logits, p_loss = paper_forward(m_gpu, plain, gpu_b)
                    res["kernel_vs_plain"] = paper_compare(
                        torch, got, p_logits, got_loss, p_loss,
                        PAPER_KERNEL_REL, f"{name} kernels vs plain")
                    del plain, p_logits
            card[fmt] = gtree
            del got, want
        extra = {}
        if name == "bert":
            extra, launches, M = paper_bert_batching(torch, np, cfg, card)
            rows = paper_rows(torch, np, card["compressed"], M, launches)
        line("paper_models", model=name,
             seconds=round(time.perf_counter() - t0, 3),
             layers=[cfg.n_encoder_layers, cfg.n_layers], d_model=cfg.d_model,
             d_ff=cfg.d_ff, heads=cfg.n_heads, vocab=cfg.vocab_size,
             inputs=list(PAPER_INPUTS[name]), n_params=n_params,
             compressed_linears=n_lin,
             weight_stream_bits=stats["weight_stream_bits"],
             weight_stream_bits_dense=stats["weight_stream_bits_dense"],
             limits={"cpu": PAPER_CPU_REL, "kernel": PAPER_KERNEL_REL},
             results=res, card=smi, **extra)
        del trees, card
    return rows


# The tensor-parallel serves (phase tp_serve): ranks of a (1, N) mesh, each
# its own process, sharing the one card through gloo (NCCL refuses two ranks
# on one GPU). (a) qwen2.5-32b at its published widths, depth 64 -> 4, f32
# weights and compute, at N = 2 and 4 (40 q / 8 kv heads: G = 5 on 20 / 4
# and 10 / 2 heads a rank); (b) the same widths, depth 8, bf16, N = 2, the
# default EngineConfig; (c) dbrx-132b at its published widths, depth 40 ->
# 1, f32, N = 2, TP_MOE_REQUESTS of the dense traffic.
TP_LAYERS = 4
TP_RANKS = (2, 4)
TP_BF16_LAYERS = 8
TP_BF16_RANKS = 2
TP_MOE_LAYERS = 1
TP_MOE_REQUESTS = 8
TP_COUNTERS = ("prefix_hit_ratio", "pages_shared", "preemptions", "steps",
               "mixed_steps", "decoded_tokens")


def tp_rounds(traffic, n_requests=None):
    """``profile_serve.workload``'s requests as ``launch.tp_serve`` rounds:
    the warm-up request alone, then the up-front requests and the
    arrivals (the first ``n_requests`` of them, in rid order)."""
    warm, up_front, arrivals, _ = traffic
    rest = [(0, r) for r in up_front] + list(arrivals)
    if n_requests is not None:
        rest = [(t, r) for t, r in rest if r.rid < n_requests]
    return [[(0, warm.rid, warm.prompt, warm.max_new_tokens)],
            [(t, r.rid, r.prompt, r.max_new_tokens) for t, r in rest]]


def tp_first_diff(torch, cfg, path, rounds, want, got):
    """The first request whose tokens differ: its rid, the first differing
    step, and the unsharded model's top-2 logit gap there (a forward of the
    prompt and the tokens before it, from the saved weights)."""
    from repro_torch.models.transformer import Model
    prompts = {rid: p for rnd in rounds for _, rid, p, _ in rnd}
    rid = min(r for r in want if want[r][0] != got[r][0])
    a, b = want[rid][0], got[rid][0]
    step = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
    model = Model(cfg, device="cuda")
    params = model.prepare(torch.load(path, mmap=True, map_location="cpu",
                                      weights_only=True))
    seq = torch.tensor(list(prompts[rid]) + a[:step], device="cuda")[None]
    with torch.inference_mode():
        logits, _ = model.apply(params, {"inputs": seq})
    top = torch.topk(logits[0, -1].float(), 2).values
    return {"rid": rid, "step": step, "unsharded_top2_gap":
            float(top[0] - top[1]), "unsharded": a[step], "sharded": b[step]}


def tp_launch_check(label, n, rank, launches):
    """A rank of the mixed engine launched the paged decode and mixed
    kernels on its heads."""
    if not (launches["tda_paged_decode_attention"]
            and launches["tda_mixed_attention"]):
        fail(f"tp_serve {label} N={n}: rank {rank} launched {launches}")


def tp_case(torch, np, label, cfg, rounds, engine_kw, ranks, tmp, exact):
    """Serve ``rounds`` unsharded on the card, then on ``(1, N)`` meshes of
    gloo ranks sharing it for each N in ``ranks``, the ranks loading the
    weights the parent saved memory-mapped and moving only their slices to
    the card. Fails unless every request of every run ends ``ok``, every
    rank's outputs equal the others', the host counters (TP_COUNTERS) equal
    the unsharded run's, each rank launched the paged decode and mixed
    kernels, and, with ``exact``, every token equals the unsharded run's
    (else the first differing step is printed with its top-2 gap). Returns
    (the unsharded result, {N: every rank's result})."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.tp_serve import serve_rank, serve_scenario
    from repro_torch.models.transformer import Model
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    base = serve_scenario(dict(cfg=cfg, params=params, engine=engine_kw,
                               rounds=rounds, device="cuda"), None)
    path = tmp / f"{label}.pt"
    torch.save(params, path)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    want = base["out"]
    if any(s != "ok" for _, s in want.values()):
        fail(f"tp_serve {label}: the unsharded run is not all ok")
    runs = {}
    for n in ranks:
        t0 = time.perf_counter()
        res = [r[0] for r in run_ranks(n, serve_rank, (1, n), [dict(
            cfg=cfg, params=str(path), engine=engine_kw, rounds=rounds)],
            device="cuda", backend="gloo")]
        spawn_s = time.perf_counter() - t0
        for rank, r in enumerate(res):
            if r["out"] != res[0]["out"]:
                fail(f"tp_serve {label} N={n}: rank {rank}'s outputs differ "
                     "from rank 0's")
            if any(s != "ok" for _, s in r["out"].values()):
                fail(f"tp_serve {label} N={n}: not every request ok")
            tp_launch_check(label, n, rank, r["launches"])
            bad = {k: (r["stats"][k], base["stats"][k]) for k in TP_COUNTERS
                   if r["stats"][k] != base["stats"][k]}
            if bad:
                fail(f"tp_serve {label} N={n}: host counters (sharded, "
                     f"unsharded) {bad}")
        got = res[0]["out"]
        statuses = {rid: s for rid, (_, s) in got.items()} == \
            {rid: s for rid, (_, s) in want.items()}
        if exact and (got != want or not statuses):
            diff = tp_first_diff(torch, cfg, path, rounds, want, got)
            print(json.dumps({"phase": "tp_serve", "case": label, "ranks": n,
                              "first_diff": diff}), flush=True)
            fail(f"tp_serve {label} N={n}: tokens differ from the "
                 f"unsharded run's: {diff}")
        runs[n] = (res, spawn_s)
    path.unlink()
    return base, runs


def tp_summary(r, spawn_s=None):
    """One run's tok/s, step ms, weight bytes on the card, peak host RSS,
    K/V bytes per token (in all and per rank) and launches."""
    import numpy as np
    st = r["stats"]

    def median(v):
        return float(np.median(v)) if v else None

    out = {"output_tok_s": r["output_tokens"] / r["wall_s"],
           "wall_s": r["wall_s"],
           "decode_step_ms_median": median(st["step_ms"]["decode"]),
           "mixed_step_ms_median": median(st["step_ms"]["mixed"]),
           "steps": st["steps"], "mixed_steps": st["mixed_steps"],
           "weight_gb_on_card": r["weight_bytes"] / 1e9,
           "peak_host_rss_gb": r["peak_rss_gb"],
           "kv_bytes_per_token": st["kv_bytes_per_token"],
           "kv_bytes_per_token_per_rank": st["kv_bytes_per_token_per_rank"],
           "tp_ranks": st["tp_ranks"],
           "launches": {k: v for k, v in r["launches"].items() if v}}
    col = r.get("collectives")
    if col and col["calls"]:
        out["collectives_per_step"] = col["calls"] / st["steps"]
        out["collective_host_ms_per_step"] = col["seconds"] * 1e3 / st["steps"]
        out["collective_mb_per_step"] = col["bytes"] / 1e6 / st["steps"]
    if spawn_s is not None:
        out["spawn_and_serve_s"] = spawn_s
    return out


def phase_tp_serve(torch, np):
    """Tensor-parallel serving on the one card: (a) qwen2.5-32b at its
    published widths, TP_LAYERS layers, float32 weights and compute (TF32
    off), ``profile_serve.workload`` through ``ENGINE_KW`` and the default
    ``EngineConfig``, unsharded and then on (1, N) gloo meshes for N in
    TP_RANKS: tokens, statuses and host counters equal to the unsharded
    run's; (b) the same widths at TP_BF16_LAYERS layers in bf16 at N =
    TP_BF16_RANKS: 16/16 ``ok``, host counters equal to the unsharded bf16
    run's, tok/s and step ms; (c) dbrx-132b at its published widths,
    TP_MOE_LAYERS layer, float32, N = 2, TP_MOE_REQUESTS requests: tokens
    equal. Each rank loads the parent's saved weights memory-mapped and
    moves only its slice to the card. The times are of ranks sharing one
    card through gloo's host-staged collectives, not a tensor-parallel
    speed. Returns rank 0's launches of (b) for the ``.tp2`` rows."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import ENGINE_KW, workload
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    label = "ranks share one card via gloo"
    with tempfile.TemporaryDirectory(prefix="tp_serve_") as tmp:
        tmp = Path(tmp)
        cfg = get_config("qwen2.5-32b", "full", n_layers=TP_LAYERS,
                         dtype="float32", param_dtype="float32")
        rounds = tp_rounds(workload(cfg.vocab_size,
                                    ENGINE_KW["max_new_tokens"]))
        base, runs = tp_case(torch, np, "f32", cfg, rounds, ENGINE_KW,
                             TP_RANKS, tmp, exact=True)
        line("tp_serve", case="a", card=smi, timing=label,
             model=cfg.name, n_layers=cfg.n_layers, dtype="float32",
             reduced={"n_layers": f"64 -> {cfg.n_layers} (depth only)"},
             tokens_equal_unsharded=True, host_counters_equal=True,
             requests=len(base["out"]) - 1,
             unsharded=tp_summary(base),
             ranks={n: [tp_summary(r, s if i == 0 else None)
                        for i, r in enumerate(res)]
                    for n, (res, s) in runs.items()})
        cfg = get_config("qwen2.5-32b", "full", n_layers=TP_BF16_LAYERS,
                         param_dtype="bfloat16")
        base, runs = tp_case(torch, np, "bf16", cfg, rounds, ENGINE_KW,
                             (TP_BF16_RANKS,), tmp, exact=False)
        res, s = runs[TP_BF16_RANKS]
        same = sum(res[0]["out"][rid] == base["out"][rid]
                   for rid in base["out"])
        line("tp_serve", case="b", card=smi, timing=label,
             model=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
             reduced={"n_layers": f"64 -> {cfg.n_layers} (depth only)"},
             ok=len(res[0]["out"]) - 1, host_counters_equal=True,
             requests_token_equal_unsharded=int(same) - 1,
             unsharded=tp_summary(base),
             ranks=[tp_summary(r, s if i == 0 else None)
                    for i, r in enumerate(res)])
        tp2 = dict(res[0]["launches"])
        cfg = get_config("dbrx-132b", "full", n_layers=TP_MOE_LAYERS,
                         dtype="float32", param_dtype="float32")
        rounds = tp_rounds(workload(cfg.vocab_size,
                                    ENGINE_KW["max_new_tokens"]),
                           TP_MOE_REQUESTS)
        base, runs = tp_case(torch, np, "moe", cfg, rounds, ENGINE_KW,
                             (2,), tmp, exact=True)
        line("tp_serve", case="c", card=smi, timing=label,
             model=cfg.name, n_layers=cfg.n_layers, dtype="float32",
             reduced={"n_layers": f"40 -> {cfg.n_layers} (depth only)",
                      "requests": f"16 -> {TP_MOE_REQUESTS}"},
             tokens_equal_unsharded=True, host_counters_equal=True,
             requests=len(base["out"]) - 1,
             unsharded=tp_summary(base),
             ranks=[tp_summary(r, runs[2][1] if i == 0 else None)
                    for i, r in enumerate(runs[2][0])])
    line("tp_serve", seconds=round(time.perf_counter() - t0, 3))
    return tp2


# ---------------------------------------------------------------------------
# phase 11: the trainer
# ---------------------------------------------------------------------------

# Part (a): qwen2.5 smoke at float32, the card against the CPU.
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant")
TRAIN_SMOKE = dict(batch=2, seq=16)
TRAIN_STEPS = 12
TRAIN_POISON = 7        # ids >= V at this step: a NaN loss, skipped
TRAIN_RESTART = 8       # the checkpoint the factorized run restarts from
# Card against CPU at f32 (TF32 off): cuBLAS and the CPU's BLAS sum in
# other orders, ~1e-7 relative, and the trajectory amplifies it: on the
# CPU alone, initial params perturbed by 1e-7 relative move step 9's loss
# of this run by up to 8.3e-5 (Adam moves entries whose gradient is at
# the noise level by up to lr a step, and RoPE makes the k bias such a
# direction only nearly). So losses of ~6 within 1e-3; parameters: at
# most TRAIN_PARAM_FRAC of the entries more than TRAIN_PARAM_TOL apart and
# none more than 2 lr a step.
TRAIN_LOSS_TOL = 1e-3
TRAIN_PARAM_TOL = 1e-5
TRAIN_PARAM_FRAC = 1e-3
TRAIN_SERVE = ["--arch", "qwen2.5-32b", "--dtype", "float32", "--requests",
               "8", "--max-len", "64", "--max-new", "8"]
TRAIN_SERVE_COUNTERS = ("steps", "mixed_steps", "decoded_tokens",
                        "prefix_hit_ratio", "pages_shared", "preemptions",
                        "kv_blocks_visited", "status_counts")
# Part (b): qwen2.5-32b at its published widths, depth 64 -> 2.
TRAIN_FULL_LAYERS = 2
TRAIN_FULL_STEPS = 6
TRAIN_FULL_BATCH = (8, 64)  # launch/train.py's defaults
# bf16 compute against an f32 forward of the same params and batch: bf16
# keeps 8 mantissa bits (2^-9 relative rounding) on every product input;
# through 2 layers the hidden state moves by ~1e-2 relative, O(1) logits
# by ~1e-2 each and their mean NLL (~12 at init) by less: 0.05 absolute.
TRAIN_BF16_LOSS_TOL = 0.05


def _flat(tree):
    from repro_torch.core.tree import tree_leaves
    return {"/".join(p): v for p, v in tree_leaves(tree)}


def _poison(np, steps, vocab):
    def hook(step, batch):
        if step in steps:
            batch = dict(batch)
            batch["inputs"] = np.full_like(batch["inputs"], vocab + 7)
        return batch
    return hook


def _wd_nnz_exact(torch, params, fcfg, label):
    """Every W_D column of ``params`` holds exactly ``nnz_for(r)``
    non-zeros. Returns the number of W_D matrices checked."""
    n = 0
    for k, v in _flat(params).items():
        if k.endswith("/wd"):
            want = fcfg.nnz_for(v.shape[-2])
            nz = (v != 0).sum(-2)
            if not bool((nz == want).all()):
                fail(f"train: {label}: {k} has columns with "
                     f"{sorted(set(nz.flatten().tolist()))} non-zeros, "
                     f"want {want}")
            n += v.reshape(-1, *v.shape[-2:]).shape[0]
    if not n:
        fail(f"train: {label}: no W_D leaf")
    return n


def train_card_cpu(torch, np, cfg, tmp, hook=None, **loop_kw):
    """The port's ``train`` on the card and on the CPU from the same host
    params (``Model.init`` seed 0) and the same ``lm_batches`` stream.
    Returns ``{"card" | "cpu": train's result}``, each run's checkpoints
    under ``tmp / "card"`` and ``tmp / "cpu"``."""
    from repro_torch.core.tree import tree_map
    from repro_torch.data import lm_batches
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    host = Model(cfg, device="cpu").init(seed=0)
    out = {}
    for run, dev in (("card", "cuda"), ("cpu", "cpu")):
        out[run] = train(
            Model(cfg, device=dev),
            lm_batches(cfg.vocab_size, seed=0, **TRAIN_SMOKE),
            OptConfig(**TRAIN_OPT), TrainLoopConfig(
                total_steps=TRAIN_STEPS, ckpt_dir=str(tmp / run),
                ckpt_every=4, log_every=1, **loop_kw),
            hooks={"inject_fault": hook} if hook else None,
            params=tree_map(lambda t: t.to(dev, copy=True), host))
    return out


def train_compare(np, out, label):
    """Card against CPU: the same steps recorded, losses within
    TRAIN_LOSS_TOL, final params within TRAIN_PARAM_TOL / _FRAC."""
    hg, hc = out["card"]["history"], out["cpu"]["history"]
    steps = [h["step"] for h in hg]
    if steps != [h["step"] for h in hc]:
        fail(f"train: {label}: card steps {steps}, CPU "
             f"{[h['step'] for h in hc]}")
    dl = max(abs(a["loss"] - b["loss"]) for a, b in zip(hg, hc))
    if not dl <= TRAIN_LOSS_TOL:
        fail(f"train: {label}: card losses {dl} from the CPU's")
    g = _flat(out["card"]["state"]["params"])
    c = _flat(out["cpu"]["state"]["params"])
    diff = np.concatenate([(g[k].cpu() - c[k]).abs().numpy().ravel()
                           for k in c])
    frac = float((diff > TRAIN_PARAM_TOL).mean())
    cap = 2 * TRAIN_OPT["lr"] * TRAIN_STEPS
    if not (frac <= TRAIN_PARAM_FRAC and float(diff.max()) <= cap):
        fail(f"train: {label}: final params: {frac} of entries beyond "
             f"{TRAIN_PARAM_TOL} (limit {TRAIN_PARAM_FRAC}), max "
             f"{float(diff.max())} (limit {cap})")
    return {"steps": steps, "max_loss_diff": dl,
            "max_grad_norm_rel_diff": max(
                abs(a["grad_norm"] - b["grad_norm"]) / max(b["grad_norm"],
                                                           1e-9)
                for a, b in zip(hg, hc)),
            "params_share_beyond_tol": frac,
            "params_max_diff": float(diff.max()),
            "losses": [round(h["loss"], 6) for h in hg],
            "step_ms_card": [round(h["dt"] * 1e3, 3) for h in hg]}


def train_smoke(torch, np, smi, tmp):
    """Part (a): qwen2.5 smoke at float32 (TF32 off), the port's ``train``
    on the card against the CPU: 12 dense steps with a NaN batch at step
    7, then 12 factorized steps (``min_dim`` 32, sparse from step 4, a
    projection every 4) with a restart from the step-8 checkpoint; then
    ``launch/serve.py --ckpt`` serves the dense run's checkpoint on the
    card (the mixed engine's TDA kernels) and on the CPU."""
    import shutil
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.data import lm_batches
    from repro_torch.kernels.tda import tda
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    cfg = get_config("qwen2.5-32b", "smoke", dtype="float32")
    V = cfg.vocab_size
    dense = train_card_cpu(torch, np, cfg, tmp / "dense",
                           hook=_poison(np, {TRAIN_POISON}, V))
    dres = train_compare(np, dense, "dense")
    if TRAIN_POISON in dres["steps"] or len(dres["steps"]) != TRAIN_STEPS - 1:
        fail(f"train: the NaN batch at step {TRAIN_POISON} was not skipped: "
             f"{dres['steps']}")
    if int(dense["card"]["state"]["step"]) != TRAIN_STEPS - 1:
        fail("train: the skipped step changed the state's step")
    line("train", case="a", part="dense", card=smi, model=cfg.name,
         dtype="float32", skipped=[TRAIN_POISON], **dres)

    fcfg = FactorizationConfig(enabled=True, min_dim=32)
    fc = dataclasses.replace(cfg, factorization=fcfg)
    sparse_kw = dict(sparse_from_step=4, project_every=4)
    fact = train_card_cpu(torch, np, fc, tmp / "fact", **sparse_kw)
    fres = train_compare(np, fact, "factorized")
    # after each projection (steps 7 and 11): the step-8 checkpoint and
    # the final params
    model = Model(fc, device="cuda")
    like = fact["card"]["state"]
    ck, _ = restore_checkpoint(tmp / "fact" / "card", like,
                               step=TRAIN_RESTART)
    n_wd = _wd_nnz_exact(torch, ck["params"], fcfg, "step-8 checkpoint")
    _wd_nnz_exact(torch, like["params"], fcfg, "final params")
    # restart from the step-8 checkpoint alone, the stream at batch 8
    rdir = tmp / "restart"
    rdir.mkdir()
    name = f"step_{TRAIN_RESTART:08d}"
    shutil.copytree(tmp / "fact" / "card" / name, rdir / name)
    data = lm_batches(V, seed=0, **TRAIN_SMOKE)
    for _ in range(TRAIN_RESTART):
        next(data)
    rest = train(model, data, OptConfig(**TRAIN_OPT), TrainLoopConfig(
        total_steps=TRAIN_STEPS, ckpt_dir=str(rdir), ckpt_every=4,
        log_every=1, **sparse_kw))["history"]
    ref = [h for h in fact["card"]["history"] if h["step"] >= TRAIN_RESTART]
    if [h["step"] for h in rest] != [h["step"] for h in ref]:
        fail(f"train: restart recorded {[h['step'] for h in rest]}")
    dr = max(abs(a["loss"] - b["loss"]) for a, b in zip(rest, ref))
    if not dr <= 1e-6:
        fail(f"train: the restart's losses {dr} from the run's")
    line("train", case="a", part="factorized", card=smi, model=cfg.name,
         dtype="float32", fcfg={"min_dim": 32, **sparse_kw},
         wd_matrices_exact_nnz=n_wd, restart_from=TRAIN_RESTART,
         restart_max_loss_diff=dr, **fres)

    # serve the dense run's checkpoint: card (TDA kernels) against CPU
    runs = {}
    for run, dev in (("card", "cuda"), ("cpu", "cpu")):
        tda.reset_launch_counts()
        eng, done = serve.main(TRAIN_SERVE + [
            "--ckpt", str(tmp / "dense" / run), "--device", dev])
        torch.cuda.synchronize()
        runs[run] = ({r.rid: (list(map(int, r.output)), r.status)
                      for r in done},
                     {k: eng.decode_stats[k] for k in TRAIN_SERVE_COUNTERS},
                     dict(tda.LAUNCHES))
    (tok_g, st_g, la), (tok_c, st_c, _) = runs["card"], runs["cpu"]
    if tok_g != tok_c:
        fail(f"train: the card's serve of the checkpoint differs from the "
             f"CPU's: {[r for r in tok_c if tok_g.get(r) != tok_c[r]]}")
    if st_g != st_c:
        fail(f"train: serve host counters {st_g} vs the CPU's {st_c}")
    if not (la["tda_paged_decode_attention"] and la["tda_mixed_attention"]):
        fail(f"train: the card's serve did not run the TDA kernels: {la}")
    if any(s != "ok" for _, s in tok_g.values()):
        fail("train: a served request is not ok")
    line("train", case="a", part="serve", card=smi, requests=len(tok_g),
         tokens_equal_cpu=True, host_counters_equal=True, counters=st_g,
         launches={k: v for k, v in la.items() if v})


def train_step_parts(torch, model, state, batch, opt_cfg, sparse):
    """One more train step at the state ``train`` left, timed with CUDA
    events in two parts by the step's own guard (``launch/steps.py``:
    called between the backward pass and the update), after a forward
    alone (``Model.loss``) on the same batch: ``forward``, ``backward``
    (the guard's time less the forward's) and ``update``
    (``apply_updates`` in place). Returns ms each."""
    from repro_torch.launch.steps import make_train_step
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    model.loss(state["params"], batch, sparse_train=sparse)
    ev[1].record()
    step = make_train_step(model, opt_cfg, sparse_train=sparse)
    ev[2].record()
    step(state, batch, guard=lambda m: ev[3].record() is None)
    ev[4].record()
    torch.cuda.synchronize()
    fwd = ev[0].elapsed_time(ev[1])
    return {"forward": round(fwd, 3),
            "backward": round(ev[2].elapsed_time(ev[3]) - fwd, 3),
            "update": round(ev[3].elapsed_time(ev[4]), 3)}


def train_full(torch, np, smi, tmp):
    """Part (b): qwen2.5-32b at its published widths, depth 64 ->
    TRAIN_FULL_LAYERS, f32 masters and bf16 compute, AdamW with f32
    state, ``lm_batches`` at 8 x 64, the config's remat: 6 dense steps,
    then the factorized model (``min_dim`` 256) for 6 steps, sparse from
    step 2, a projection every 3. No checkpoint (``ckpt_every`` past the
    run: the state is ~40 GB)."""
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.data import lm_batches
    from repro_torch.data.loader import to_device
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainLoopConfig, train
    base = get_config("qwen2.5-32b", "full", n_layers=TRAIN_FULL_LAYERS)
    B, S = TRAIN_FULL_BATCH
    fcfg = FactorizationConfig(enabled=True, min_dim=256)
    for part, cfg in (("dense", base), ("factorized", dataclasses.replace(
            base, factorization=fcfg))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device="cuda")
        params = model.init(seed=0)
        leaves = list(_flat(params).values())
        n = sum(t.numel() for t in leaves)
        # params, grads, m, v in f32; the update's two leaf-sized
        # temporaries at its largest leaf; one (B, S, V) f32 logits chunk
        # and its gradient
        predicted = 16 * n + 2 * max(t.numel() * 4 for t in leaves) \
            + 2 * B * S * cfg.vocab_size * 4
        first = next(lm_batches(cfg.vocab_size, B, S))
        ref = None
        if part == "dense":
            b0 = to_device(first, model.device)
            m32 = Model(dataclasses.replace(cfg, dtype="float32"),
                        device="cuda")
            with torch.no_grad():
                ref = float(m32.loss(params, b0)[1]["loss"])
            del m32, b0
        checks = {}

        def hook(step, batch, params=params, checks=checks, cfg=cfg):
            # after the projection at step 2 (the W_D tensors are updated
            # in place, so ``params`` is the live tree)
            if cfg.factorization.enabled and step == 3:
                checks["after_step_2"] = _wd_nnz_exact(
                    torch, params, cfg.factorization, "full width, step 2")
            return batch

        opt_cfg = OptConfig(lr=3e-3, warmup_steps=10,
                            total_steps=TRAIN_FULL_STEPS)
        out = train(model, lm_batches(cfg.vocab_size, B, S), opt_cfg,
                    TrainLoopConfig(
                        total_steps=TRAIN_FULL_STEPS, ckpt_every=10**9,
                        ckpt_dir=str(tmp / f"full_{part}"), log_every=1,
                        sparse_from_step=2 if cfg.factorization.enabled
                        else 10**9, project_every=3),
                    hooks={"inject_fault": hook}, params=params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        hist = out["history"]
        if [h["step"] for h in hist] != list(range(TRAIN_FULL_STEPS)):
            fail(f"train: full width {part}: bad steps "
                 f"{[h['step'] for h in hist]}")
        if not all(math.isfinite(h["loss"]) and math.isfinite(
                h["grad_norm"]) for h in hist):
            fail(f"train: full width {part}: non-finite loss or grad norm")
        extra = {}
        if ref is not None:
            gap = abs(hist[0]["loss"] - ref)
            if not gap <= TRAIN_BF16_LOSS_TOL:
                fail(f"train: full width: step-0 bf16 loss {hist[0]['loss']}"
                     f" vs f32 {ref} (limit {TRAIN_BF16_LOSS_TOL})")
            extra = {"step0_loss_f32": ref, "step0_bf16_gap": gap}
        else:
            checks["after_step_5"] = _wd_nnz_exact(
                torch, out["state"]["params"], fcfg, "full width, end")
            extra = {"wd_matrices_exact_nnz": checks}
        extra["step_parts_ms"] = train_step_parts(
            torch, model, out["state"], to_device(first, model.device),
            opt_cfg, cfg.factorization.enabled)
        line("train", case="b", part=part, card=smi, model=cfg.name,
             d_model=cfg.d_model, n_layers=cfg.n_layers,
             reduced={"n_layers": f"64 -> {cfg.n_layers} (depth only)"},
             dtype="bfloat16 compute, float32 params and AdamW state",
             batch=[B, S], remat=cfg.remat, params=n,
             steps=[{"step": h["step"], "loss": h["loss"],
                     "ms": round(h["dt"] * 1e3, 3),
                     "grad_norm": h["grad_norm"], "sparse": h["sparse"]}
                    for h in hist],
             peak_mem_gb=peak / 1e9, predicted_gb=predicted / 1e9,
             peak_over_predicted=peak / predicted, **extra)
        if part == "dense":
            step0 = hist[0]["loss"]
        del model, params, out, leaves, hook
    gc.collect()
    torch.cuda.empty_cache()
    return step0


def phase_train(torch, np):
    """The trainer (``train/loop.py``, ``optim/adamw.py``,
    ``launch/steps.py``, ``checkpoint/``): part (a), the card against the
    CPU at smoke width, then part (b), full width. TF32 off. Returns
    part (b)'s dense step-0 loss (phase ``sharded_train`` holds its own
    to it)."""
    import tempfile
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="train_") as tmp:
        train_smoke(torch, np, smi, Path(tmp))
        step0 = train_full(torch, np, smi, Path(tmp))
    line("train", seconds=round(time.perf_counter() - t0, 3))
    return step0


# ---------------------------------------------------------------------------
# phase 12: sharded training on a (2, 2) mesh of ranks sharing the card
# ---------------------------------------------------------------------------

SHARDED_MESH = (2, 2)
SHARDED_RANKS = 4
# The sharded step is the unsharded step's arithmetic with the products
# and the batch summed in another order (partial sums over ``model``,
# blocks over ``data``): ~1e-7 relative on losses, grad norms and
# gradients (the CPU tests' measurement). Adam and Adafactor divide each
# gradient entry by its own RMS, so an entry whose gradient is at that
# noise level moves by up to lr in a direction the noise decides: the
# steps here run at the warmup's first rates (lr / 100, 2 lr / 100 = 1e-5,
# 2e-5), which keeps such a flip inside the limit.
SHARDED_RTOL = 1e-5
SHARDED_OPT = dict(lr=1e-3, warmup_steps=100, total_steps=1000)
SHARDED_STEPS = 2
SHARDED_FULL_STEPS = 3


def _leaf_gap(np, got, want):
    """max over leaves of max |got - want| / max(1, max |want|)."""
    gap = 0.0
    for k, w in _flat(want).items():
        g = _flat(got)[k]
        gap = max(gap, float(np.abs(g - w).max()) / max(
            1.0, float(np.abs(w).max())))
    return gap


def phase_sharded_train(torch, np, step0_loss):
    """Sharded training (``train(mesh=)``) on four gloo ranks sharing the
    card: part (a) at smoke width against the unsharded card run (dbrx:
    against the same mesh on the CPU), part (b) qwen2.5-32b at full width
    on (2, 2), its step-0 loss against phase ``train``'s unsharded one
    (``step0_loss``)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.factorized import FactorizationConfig
    from repro_torch.data import lm_batches
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.sharded_train import train_rank
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    fcfg = FactorizationConfig(enabled=True, min_dim=32)

    def batches(cfg, n, B, S):
        it = lm_batches(cfg.vocab_size, B, S)
        return [next(it) for _ in range(n)]

    tmp = tempfile.mkdtemp(prefix="sharded_train_")
    loop = dict(total_steps=SHARDED_STEPS, ckpt_dir=tmp,
                ckpt_every=10**9, log_every=1)
    qwen = get_config("qwen2.5-32b", "smoke", dtype="float32")
    qfact = dataclasses.replace(qwen, factorization=fcfg)
    dbrx = get_config("dbrx-132b", "smoke", dtype="float32",
                      factorization=fcfg)
    sparse = dict(loop, sparse_from_step=0, project_every=SHARDED_STEPS)
    smoke = {
        "qwen_dense": dict(cfg=qwen, opt=dict(SHARDED_OPT, name="adamw"),
                           loop=loop, batches=batches(qwen, 2, 8, 32)),
        "qwen_factorized": dict(
            cfg=qfact, opt=dict(SHARDED_OPT, name="adafactor",
                                factored_min_dim=16),
            loop=sparse, batches=batches(qwen, 2, 8, 32)),
        "dbrx_factorized": dict(cfg=dbrx, opt=dict(SHARDED_OPT,
                                                   name="adamw"),
                                loop=sparse, batches=batches(dbrx, 2, 8, 32)),
    }
    full_cfg = get_config("qwen2.5-32b", "full", n_layers=TRAIN_FULL_LAYERS)
    B, S = TRAIN_FULL_BATCH
    full = dict(cfg=full_cfg, mesh=SHARDED_MESH,
                opt=dict(lr=3e-3, warmup_steps=10,
                         total_steps=TRAIN_FULL_STEPS),
                loop=dict(total_steps=SHARDED_FULL_STEPS, ckpt_dir=tmp,
                          ckpt_every=10**9, log_every=1),
                batches=batches(full_cfg, SHARDED_FULL_STEPS, B, S))
    for j in smoke.values():  # the CPU ranks' params: the CPU's draw
        j["init_device"] = "cpu"
    jobs = [dict(j, mesh=SHARDED_MESH, gather=True) for j in smoke.values()]
    jobs.append(dict(smoke["dbrx_factorized"], mesh=SHARDED_MESH,
                     gather=True, device="cpu"))
    jobs.append(full)
    # The unsharded card runs of part (a), in this process.
    plain = train_rank([dict(smoke[k], gather=True)
                        for k in ("qwen_dense", "qwen_factorized")])
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = run_ranks(SHARDED_RANKS, train_rank, jobs, backend="gloo")
    spawn_s = time.perf_counter() - t1
    r0 = ranks[0]
    refs = {"qwen_dense": plain[0], "qwen_factorized": plain[1],
            "dbrx_factorized": r0[3]}
    for i, name in enumerate(smoke):
        got, want = r0[i], refs[name]
        gaps = {}
        for key in ("loss", "grad_norm"):
            gaps[key] = max(abs(a[key] - b[key]) / max(1.0, abs(b[key]))
                            for a, b in zip(got["history"],
                                            want["history"]))
        gaps["params"] = _leaf_gap(np, got["params"], want["params"])
        against = "cpu ranks (2, 2)" if name.startswith("dbrx") \
            else "unsharded card"
        if len(got["history"]) != SHARDED_STEPS \
                or not all(v <= SHARDED_RTOL for v in gaps.values()):
            fail(f"sharded_train (a) {name}: the (2, 2) card run against "
                 f"the {against} run: {gaps} (limit {SHARDED_RTOL})")
        line("sharded_train", case="a", part=name, card=smi,
             mesh=list(SHARDED_MESH), dtype="float32", against=against,
             steps=SHARDED_STEPS,
             losses=[h["loss"] for h in got["history"]], rel_gaps=gaps)

    # (b): qwen2.5-32b at full width.
    hist = r0[4]["history"]
    if [h["step"] for h in hist] != list(range(SHARDED_FULL_STEPS)) \
            or not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"sharded_train (b): bad steps {hist}")
    gap = abs(hist[0]["loss"] - step0_loss)
    if not gap <= TRAIN_BF16_LOSS_TOL:
        fail(f"sharded_train (b): step-0 loss {hist[0]['loss']} vs the "
             f"unsharded {step0_loss} (limit {TRAIN_BF16_LOSS_TOL})")
    peaks = [r[4]["peak_bytes"] for r in ranks]
    card = torch.cuda.get_device_properties(0).total_memory
    if sum(peaks) > card:
        fail(f"sharded_train (b): the ranks' peaks {peaks} exceed the "
             f"card's {card} bytes")
    per_rank = []
    for r in ranks:
        rec = r[4]
        per_rank.append({
            "coords": rec["coords"], "peak_gb": rec["peak_bytes"] / 1e9,
            "predicted_gb": rec["predicted"]["total"] / 1e9,
            "predicted_parts_gb": {k: v / 1e9 for k, v in
                                   rec["predicted"].items()},
            "peak_over_predicted": rec["peak_bytes"]
            / rec["predicted"]["total"],
            "steps": [{"step": h["step"], "loss": h["loss"],
                       "ms": round(h["dt"] * 1e3, 3),
                       "grad_norm": h["grad_norm"],
                       "gloo_calls": st["calls"],
                       "gloo_s": round(st["seconds"], 3),
                       "gloo_gb": st["bytes"] / 1e9}
                      for h, st in zip(rec["history"], rec["steps"])],
            "seconds": round(rec["seconds"], 3)})
    line("sharded_train", case="b", card=smi, model=full_cfg.name,
         d_model=full_cfg.d_model, n_layers=full_cfg.n_layers,
         mesh=list(SHARDED_MESH), backend="gloo (4 ranks, one card)",
         reduced={"n_layers": f"64 -> {full_cfg.n_layers} (depth only)"},
         dtype="bfloat16 compute, float32 params and AdamW state",
         batch=[B, S], rank_batch=[B // SHARDED_MESH[0], S],
         remat=full_cfg.remat, step0_loss=hist[0]["loss"],
         step0_unsharded=step0_loss, step0_gap=gap,
         peak_sum_gb=sum(peaks) / 1e9, ranks=per_rank)
    line("sharded_train", spawn_seconds=round(spawn_s, 3),
         seconds=round(time.perf_counter() - t0, 3))



# ---------------------------------------------------------------------------
# phases 13-14: the examples, and the dry run with its calibration
# ---------------------------------------------------------------------------

# The dry run's cells, each a CPU subprocess started after the sharded
# training phase (``start_dryrun``: one thread and a lower priority each)
# and read by ``phase_dryrun``.
DRYRUN_CELLS = ("train_4k", "decode_32k", "prefill_32k")
DRYRUN_ARCH = "qwen2.5-32b"
DRYRUN_WAIT_S = 600     # the longest wait for a cell still running
# The reference's refusal of decode_32k on the (16, 16) mesh.
DRYRUN_REFUSAL = ("kv_heads=8 / n_heads=40 not divisible by the 16-way "
                  "'model' mesh axis")
ROOFLINE_KEYS = ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "step_time_bound_s")
# The serve examples' float32 runs on the CPU, in a subprocess started
# with the dry run's cells: their tokens against the card's.
EXAMPLES_CPU = """
import json, sys
from repro_torch.examples import serve_async_frontend, serve_dynamic_batching
sd = serve_dynamic_batching.main(["--device", "cpu", "--dtype", "float32"])
sa = serve_async_frontend.main(["--device", "cpu", "--dtype", "float32"])
json.dump({"dynamic": sd, "async": sa}, open(sys.argv[1], "w"), default=str)
"""
# Calibration: qwen2.5-32b at its published widths, train (b)'s step (depth
# 2, 8 x 64 tokens, f32 masters, bf16 compute, AdamW), and a bf16 prefill
# of 1 x 8192 tokens at depth 8; the fake count's peak within
# CALIB_PEAK_RANGE of max_memory_allocated.
CALIB_TRAIN_LAYERS = 2
CALIB_PREFILL_LAYERS = 8
CALIB_PREFILL = (1, 8192)
CALIB_PEAK_RANGE = (0.5, 2.0)
CALIB_REPS = 3


def start_dryrun(tmp):
    """Start the dry run's cells and the examples' CPU run as
    subprocesses (one thread each, niced); returns ``{name: (Popen, log
    path)}``. Every one is waited for or killed before the script exits."""
    import atexit
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = {}

    def spawn(name, cmd):
        log = Path(tmp) / f"{name}.log"
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(
                cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True, preexec_fn=lambda: os.nice(10)), log)

    for cell in DRYRUN_CELLS:
        spawn(cell, [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", DRYRUN_ARCH, "--shape", cell, "--mesh",
                     "single", "--out", str(Path(tmp) / "dryrun")])
    spawn("examples_cpu", [sys.executable, "-c", EXAMPLES_CPU,
                           str(Path(tmp) / "examples_cpu.json")])

    def stop():  # each cell's process group: the dry run spawns its own
        for p, _ in procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()

    atexit.register(stop)
    return procs


def _wait(procs, name, timeout):
    p, log = procs[name]
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"{name}: still running after {timeout} s more; its log ends "
             f"{log.read_text()[-2000:]}")
    return p.returncode, log.read_text()


def _json_outputs(x):
    """Outputs as JSON gives them back (int keys as strings)."""
    return json.loads(json.dumps(x, default=str))


def phase_examples(torch, procs, tmp):
    """The five examples in-process on the card at their default sizes
    (``repro_torch.examples``), their own checks raising on a miss; the
    serve examples at float32 once more, from the params the CPU run draws
    (``Model.init`` on the CPU: a CUDA generator draws other numbers),
    their tokens against the CPU subprocess's; the paged decode and mixed
    kernels launched by the serve examples."""
    import importlib
    from repro_torch.configs import get_config
    from repro_torch.kernels.tda import tda
    from repro_torch.models.transformer import Model
    out = {}
    for name in ("quickstart", "compress_and_eval", "train_factorized_lm"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        res = mod.main([])
        torch.cuda.synchronize()
        out[name] = {"seconds": round(time.perf_counter() - t0, 3)}
        if name == "train_factorized_lm":
            out[name]["final"] = res["final"]
            if not all(math.isfinite(v) for v in res["final"].values()):
                fail(f"train_factorized_lm: a final loss is not finite "
                     f"{res['final']}")
        elif name == "compress_and_eval":
            out[name]["ratio"] = round(res["ratio"], 3)
        else:
            out[name]["loss"] = res["loss"]
    f32 = {}
    for name in ("serve_dynamic_batching", "serve_async_frontend"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        tda.reset_launch_counts()
        t0 = time.perf_counter()
        res = mod.main([])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(tda.LAUNCHES)
        for k in ("tda_paged_decode_attention", "tda_mixed_attention"):
            if not launches[k]:
                fail(f"{name}: {k} was not launched on the card")
        toks = _serve_tokens(name, res)
        out[name] = {"seconds": round(secs, 3), "tokens": toks,
                     "tok_s": round(toks / secs, 2), "launches": launches}
        cpu_init = {"params": Model(get_config(
            "qwen2.5-32b", "smoke", dtype="float32"), "cpu").init(0)}
        if name == "serve_dynamic_batching":
            cpu_init["rparams"] = Model(get_config(
                "recurrentgemma-2b", "smoke", dtype="float32"), "cpu").init(1)
        f32[name] = mod.main(["--dtype", "float32"], **cpu_init)
    code, log = _wait(procs, "examples_cpu", DRYRUN_WAIT_S)
    if code:
        fail(f"examples on the CPU exited {code}: {log[-2000:]}")
    cpu = json.loads((Path(tmp) / "examples_cpu.json").read_text())
    for name, key in (("serve_dynamic_batching", "dynamic"),
                      ("serve_async_frontend", "async")):
        got, want = _outputs_of(f32[name]), _outputs_of(cpu[key])
        if _json_outputs(got) != want:
            fail(f"{name}: float32 tokens on the card differ from the CPU's")
        out[name]["f32_outputs_equal_cpu"] = True
    return out


def _serve_tokens(name, res):
    """Tokens the example's engines emitted."""
    return sum(len(v) for v in _outputs_of(res).values())


def _outputs_of(res):
    """Every section's request outputs, keyed by section and rid."""
    found = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("outputs", "streamed") and isinstance(v, dict):
                    for rid, toks in v.items():
                        found[f"{path}/{k}/{rid}"] = toks
                else:
                    walk(v, f"{path}/{k}")

    walk(res, "")
    return found


def _count_fake(torch, build):
    """``dryrun.count_step`` of ``build()``'s ``(fn, args)`` under a new
    fake mode (CUDA fake tensors: the card's branches)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import count_step
    with FakeTensorMode():
        fn, args = build(fake=True)
        return count_step(fn, args)


def calibrate(torch, np, name, build):
    """One step counted on fake CUDA tensors, then run for real on the
    card: FLOPs equal (a gate), the fake peak against
    ``max_memory_allocated`` (within ``CALIB_PEAK_RANGE``), the measured
    ms against the step's roofline terms at H100 rates."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import roofline
    fake = _count_fake(torch, build)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn, args = build(fake=False)
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    del out
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    real_flops = float(fc.get_total_flops())
    if real_flops != fake["flops"]:
        fail(f"calibration {name}: FLOPs on the card {real_flops} != the "
             f"fake count {fake['flops']}")
    ratio = fake["peak_bytes"] / peak
    if not CALIB_PEAK_RANGE[0] <= ratio <= CALIB_PEAK_RANGE[1]:
        fail(f"calibration {name}: predicted peak {fake['peak_bytes']} is "
             f"{ratio:.3f}x max_memory_allocated {peak}")
    times = []
    for _ in range(CALIB_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        del out
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rl = roofline(fake["flops"], fake["bytes"], 0.0)
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    return {"flops": real_flops, "flops_equal": True,
            "bytes_counted": fake["bytes"],
            "peak_predicted_bytes": fake["peak_bytes"],
            "max_memory_allocated": peak, "peak_ratio": round(ratio, 4),
            "step_ms": sorted(times), "roofline": rl,
            "ms_over_bound": round(min(times) / 1e3
                                   / rl["step_time_bound_s"], 3),
            "ms_over_lower_bound": round(min(times) / 1e3
                                         / rl["lower_bound_s"], 3),
            "count_seconds": round(fake["seconds"], 3)}


def _train_build(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = get_config("qwen2.5-32b", "full", n_layers=CALIB_TRAIN_LAYERS)
    B, S = TRAIN_FULL_BATCH
    opt = OptConfig()

    def build(fake):
        if fake:
            params = tree_map(lambda t: t.to("cuda"),
                              Model(cfg, "cpu").param_shapes())
            batch = {k: torch.empty((B, S), dtype=torch.int32,
                                    device="cuda")
                     for k in ("inputs", "labels")}
        else:
            params = Model(cfg, "cuda").init(0)
            batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                     next(lm_batches(cfg.vocab_size, B, S)).items()}
        state = {"params": params, "opt": init_opt_state(params, opt),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        return make_train_step(Model(cfg, "cuda"), opt), (state, batch)

    return build


def _prefill_build(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen2.5-32b", "full", n_layers=CALIB_PREFILL_LAYERS,
                     param_dtype="bfloat16")
    B, S = CALIB_PREFILL

    def build(fake):
        if fake:
            params = tree_map(lambda t: t.to("cuda"),
                              Model(cfg, "cpu").param_shapes())
            batch = {"inputs": torch.empty((B, S), dtype=torch.int32,
                                           device="cuda")}
        else:
            params = Model(cfg, "cuda").init(0)
            g = torch.Generator(device="cuda").manual_seed(1)
            batch = {"inputs": torch.randint(0, cfg.vocab_size, (B, S),
                                             generator=g, device="cuda",
                                             dtype=torch.int32)}
        step = make_prefill_step(Model(cfg, "cuda"))

        def fn(params, batch):
            with torch.no_grad():
                return step(params, batch)

        return fn, (params, batch)

    return build


def phase_dryrun(torch, np, procs, tmp, smi):
    """(a) The dry run's records of ``DRYRUN_ARCH`` on the (16, 16) mesh
    (``launch/dryrun.py`` in subprocesses on the CPU): ``train_4k`` and
    ``prefill_32k`` written with the roofline keys and their rates'
    source, ``decode_32k`` refused with the reference's message. (b) The
    counters against the card (:func:`calibrate`): train (b)'s step and a
    bf16 prefill."""
    recs = {}
    for cell in DRYRUN_CELLS:
        code, log = _wait(procs, cell, DRYRUN_WAIT_S)
        stem = f"{DRYRUN_ARCH}__{cell}__single"
        path = Path(tmp) / "dryrun" / f"{stem}.json"
        failed = Path(tmp) / "dryrun" / f"{stem}.FAILED"
        if cell == "decode_32k":
            if code != 1 or not failed.exists() \
                    or DRYRUN_REFUSAL not in failed.read_text():
                fail(f"dryrun {cell}: not refused as the reference refuses "
                     f"it (exit {code}): {log[-2000:]}")
            recs[cell] = {"refused": DRYRUN_REFUSAL}
            continue
        if code or not path.exists():
            fail(f"dryrun {cell}: exit {code}: {log[-2000:]}")
        rec = json.loads(path.read_text())
        missing = [k for k in ROOFLINE_KEYS if k not in rec["roofline"]]
        if missing or not rec["rates"].get("source"):
            fail(f"dryrun {cell}: record lacks {missing or 'rates.source'}")
        recs[cell] = {
            "roofline": rec["roofline"], "seconds": rec["seconds"],
            "flops_per_chip": rec["counts"]["flops_per_chip"],
            "bytes_per_chip": rec["counts"]["bytes_per_chip"],
            "peak_per_chip_gb": rec["memory"]["peak_per_chip_gb"],
            "collective_link_bytes": rec["collectives"]["link_bytes"],
            "model_flops_6nd": rec["model_flops_6nd"],
            "useful_flops_ratio": rec["useful_flops_ratio"],
            "roofline_fraction": rec["roofline_fraction"]}
    line("dryrun", part="a", arch=DRYRUN_ARCH, mesh="single", cells=recs)
    calib = {"train": calibrate(torch, np, "train", _train_build(torch)),
             "prefill": calibrate(torch, np, "prefill",
                                  _prefill_build(torch))}
    line("dryrun", part="b", card=smi, **calib)
    return recs, calib


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.profile_serve import (ENGINE_KW,
                                                  compressed_config,
                                                  serve_config)
    full_cfg, ccfg, engine_kw = serve_config(), compressed_config(), ENGINE_KW

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, torch, np, full_cfg, engine_kw)
    rows += timed("afu", phase_afu, torch)
    rows += timed("linear_kernels", phase_linear_kernels, torch, np, ccfg)
    table_launches = timed("kernel_table", phase_kernel_table, torch)
    timed("tokens", phase_tokens, torch)
    moe_tok = timed("moe_tokens", phase_moe_tokens, torch, np)
    line("moe_tokens", seconds=seconds["moe_tokens"], **moe_tok)
    rec_tok = timed("recurrent_tokens", phase_recurrent_tokens, torch, np)
    line("recurrent_tokens", seconds=seconds["recurrent_tokens"], **rec_tok)
    timed("bf16_logits", phase_bf16_logits, torch, np)
    timed("sampler", phase_sampler, torch, np)
    dense, runs, model, params = timed("serve", phase_serve, torch, np,
                                       full_cfg, engine_kw)
    timed("shared_serve", phase_shared_serve, torch, np, model, params,
          engine_kw)
    timed("sampled_serve", phase_sampled_serve, torch, np, model, params,
          engine_kw, dense)
    timed("fleet_serve", phase_fleet_serve, torch, np, model, params,
          engine_kw)
    del model, params
    claunches = timed("compressed_serve", phase_compressed_serve, torch, np,
                      ccfg, engine_kw, dense)
    rlaunches = timed("ring_serve", phase_ring_serve, torch, np)
    mlaunches = timed("moe_serve", phase_moe_serve, torch, np)
    reclaunches = timed("recurrent_serve", phase_recurrent_serve, torch, np)
    timed("embeds", phase_embeds, torch, np)
    rows += timed("paper_models", phase_paper_models, torch, np)
    tplaunches = timed("tp_serve", phase_tp_serve, torch, np)
    step0 = timed("train", phase_train, torch, np)
    timed("sharded_train", phase_sharded_train, torch, np, step0)
    # The CPU subprocesses start after the last phase whose host times are
    # kept, so that none of those phases shares the host with them.
    procs = start_dryrun(tmp)
    timed("dryrun", phase_dryrun, torch, np, procs, tmp, card_name())
    ex = timed("examples", phase_examples, torch, procs, tmp)
    line("examples", seconds=seconds["examples"], **ex)
    # Each kernel's launches come from the run that drives it, named in the
    # row's ``launches_from``: the TDA kernels' from the phase-4 serves (the
    # int8 rows from the int8 serves), DMM's and SMM's from phase 5, the LUT
    # softmax's from the kernel_table phase; the rows of no serve's path
    # (LayerNorm, the LUT and int8-mixed TDA variants) carry the launches of
    # their check at the row's full-width shape ("check").
    source = {"tda_paged_decode_attention": ("mixed", None),
              "tda_mixed_attention": ("mixed", None),
              "tda_decode_attention": ("contiguous_bf16", None),
              "tda_decode_attention.int8": ("contiguous_int8",
                                            "tda_decode_attention"),
              "tda_paged_decode_attention.int8": (
                  "paged_int8", "tda_paged_decode_attention")}
    for r in rows:
        if r["name"] in ("tda_paged_decode_attention.g12",
                         "tda_mixed_attention.g12"):
            r.update(launches=rlaunches[r["name"].split(".")[0]],
                     launches_from="serve:ring")
        elif r["name"] in ("tda_paged_decode_attention.g6",
                           "tda_mixed_attention.g6"):
            r.update(launches=mlaunches[r["name"].split(".")[0]],
                     launches_from="serve:moe")
        elif r["name"] in ("tda_paged_decode_attention.d256",
                           "tda_decode_attention.d256"):
            run = "recurrentgemma-2b" + (
                "" if r["name"].startswith("tda_paged") else ".contiguous")
            r.update(launches=reclaunches[run][r["name"].split(".")[0]],
                     launches_from=f"serve:recurrent:{run}")
        elif r["name"].endswith(f".tp{TP_BF16_RANKS}"):
            r.update(launches=tplaunches[r["name"].split(".")[0]],
                     launches_from="serve:tp:bf16:rank0")
        elif r["name"] in ("dmm_matmul", "smm_matmul"):
            r.update(launches=claunches[r["name"]],
                     launches_from="compressed_serve",
                     body_launches={k: v for k, v in claunches.items()
                                    if k.startswith(r["name"] + ".")})
        elif r["name"] == "softmax_lut":
            r.update(launches=table_launches["softmax_lut"],
                     launches_from="kernel_table")
        elif r["name"] in source:
            run, key = source[r["name"]]
            r.update(launches=runs[run][key or r["name"]],
                     launches_from=f"serve:{run}")
        if not r.get("launches"):
            fail(f"{r['name']} was not launched by the run that drives it")
    line("seconds", total=round(sum(seconds.values()), 3), **seconds)
    print(card_name())
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_from", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + (
        "device_ms", "library_device_ms", "library_bf16_ms", "M8",
        "body_launches", "other_shapes", "skip_mode_ms",
        "skip_mode_device_ms", "shape") if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
