#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the repository root: ``python3 chip_smoke.py`` (``--layers N``
cuts qwen3-14b's depth, never its width). Phases:

1. The card's name and power limit, torch/CUDA versions, and the
   ``nvcc`` build of every kernel from ``src/repro_torch/kernels/csrc``
   (always rebuilt): the registers and spill bytes ``ptxas`` reports for
   each instantiation of the kernels on the tile engine of
   ``flash_common.cuh`` (B2/B6 and B4/B8 per head dim and layout, B10,
   B11) and on the integer filter engine of ``filter_engine.cuh`` (B3/B7
   per head dim, product path and layout, B9 per head dim and product
   path, B1/B5 per head dim and layout), and a failure on any spill at
   d 128.
2. Each kernel of the serving path (B1–B4) at the path's shapes on
   random inputs, held against its plain PyTorch version on the card:
   filter scores (B1, B3) and the selection made from them must be
   bit-equal; the bf16 gathers (B2, B4) must agree within
   |Δ| ≤ 1e-3 + 1.6e-2·|ref| (two bf16 ulps: both sides compute in f32
   from the same bf16 inputs and round the output once, so they differ
   by one ulp at most; ``repro_torch.kernels.gather_within_tolerance``),
   B4 also on the rows of a sequence's first chunk (positions < 32)
   alone; B1 also at round bits (1, 8) and (0, 8), whose q and hi
   planes are 8 bits wide (``[wide:…]``). Then each kernel, its plain
   version and one PyTorch call computing the same function where one
   exists (SDPA over the gathered survivors, timed only) are timed with
   CUDA events; the kernels redesigned since the first port (the gathers
   B2, B4, B6, B8 on the tile engine, the filters B1, B3, B5, B7, B9 on
   the filter engine) print their previous design's time and their
   device time beside (the event span of calls queued behind a spin on
   the device), and a profiler trace's device items of the same calls
   (``[trace:…]``).
3. A small reference check: the serve-smoke model in bf16, prefill and
   decode logits with the kernels against the same model with the
   plain versions swapped in, on the same card (only layer 2 is sparse
   there, and its selection is bit-exact, so the logits differ by the
   gathers' rounding alone, amplified by the bf16 layers above it):
   ‖Δ‖/‖ref‖ ≤ 2.5e-3. ``tests/test_torch_smoke.py`` runs this check on
   the CPU: every gather output one ulp off passes, a softmax scale off
   by 10 % or a mask admitting one more key fails. Faults smaller than
   that are phase 2's to catch.
4. Serving qwen3-14b at full width (random weights from a seed) through
   ``ServeLoop``: 8 requests of 2048-token prompts sharing a 256-token
   system prompt, 32 greedy tokens each, 8 slots, max_len 4096,
   prefill chunk 128. Every serving engine of this script replays its
   decode step and prefill wave from CUDA graphs (the default on CUDA),
   captured before its clock starts (``[graph]``: seconds and device
   memory of the captures). Launch counts are zeroed just before this
   run and read just after; every kernel must have launched and every
   request drained, none quarantined for non-finite logits; the streams'
   sha1 is
   printed, to compare two trees' runs. The same requests are served
   again (now hitting the prefix cache) and must give the same streams.
5. The kernels again, compared and timed on the live pool of a sparse
   layer after serving.
6. One more drain of fresh prompts on the same engine under
   ``torch.profiler``: the share of the wall time the device was busy,
   the largest device items and each of the port's kernels' device
   time and calls (``[profile] the port's kernels``: B1–B4, B3 among
   them), beside the launches the wrappers counted in that drain (a
   trace that misses some says so); then decode ticks alone under the
   profiler (``[profile-decode]``): wall and device time per tick, idle
   share, device kernels per tick and the largest items.
6b. ``[op-costs]``: one eager decode step and one eager prefill wave of
   the same engine (8 slots at position 2048; 8 × 128 rows) walked by
   ``repro_torch.analysis.op_costs`` on the card and on the meta device
   at the same shapes: FLOPs, traffic bytes and B1–B4's launches equal
   exactly on both (the kernels priced from their shapes by
   ``analysis.kernel_traffic``), the card walk's launches those the
   wrappers counted, no collective; each step's roofline bound
   (``analysis.roofline``, the H100's data-sheet rates) and the graphed
   tick's device ms of ``[profile-decode]`` over it (printed, not
   gated).

Then the contiguous (unpaged) cache, on the same model object and
weights, once the paged engine is released:

7. B5–B8 on random inputs at the unpaged path's shapes (bh = 64 rows of
   8 slots × 8 KV heads, n_k 4096, G = 5, chunk 128, key blocks of 64,
   an idle slot's ``max_len + 1`` length and sentinel rows): B5 / B7
   scores and the survivor tables selected from them bit-equal to the
   plain versions (B5 also at round bits (1, 8) and (0, 8)), B6 / B8
   within the gather tolerance (B8 also on its first-chunk rows alone);
   the same rows
   laid out as shuffled pages give B1 = B5, B2 = B6, B3 = B7, B4 = B8
   bit for bit; B7 once more at key block 128 over 64-row scale groups.
   Each kernel, its plain version and (B6, B8) SDPA over the gathered
   survivors timed.
8. ``ServeLoop(paged=False)`` serving phase 4's 8 requests (launch
   counts zeroed just before, read just after): B5 / B6 launch once per
   sparse layer (2–39) per decode step, B7 / B8 once per sparse layer
   per prefill wave, B1–B4 and B9–B11 never; every request drains (none
   quarantined) with the greedy stream of the paged run 1. Prefill and
   decode tok/s, TTFT and ITL p50 and peak device memory are printed.
9. Phase 7's checks and times on layer 2's queries of the last prefill
   wave and decode step, over its live contiguous cache; then the same
   requests through a fresh paged engine and a fresh unpaged one, warm,
   so the two layouts' tok/s are taken in turns in one call
   (``[in-turns]``; each must give phase 4's streams).
9b. The same requests drained by fresh eager (``cuda_graphs=False``) and
   graphed engines in turns — eager, graphed, eager, graphed — paged,
   then unpaged (``[eager-graphed]``): every drain must give phase 4's
   streams (sha1), each graphed drain the per-kernel launch counts of
   its eager twin, with B1–B4 (paged) or B5–B8 (unpaged) launched;
   prefill and decode tok/s, TTFT and ITL p50/p95 of the four drains
   side by side, and a ``[graph]`` line per graphed engine.
9c. The same requests through fresh paged graphed engines with
   ``Observability(device_telemetry=True)`` and without, in turns
   (observed, plain, observed, plain; ``[telemetry]``): every drain gives
   phase 4's streams (sha1) and B1–B4's launches of phase 4's run 1, each
   observed engine replays its own telemetry variants and records every
   dispatch's selection counts; ρ_eff of decode and prefill (and of
   layers 2, 3, 20, 39), ITL beside the decode-attributed ITL, decode
   tok/s and the graphs' memory of each drain.
9d. The same requests under a seeded fault schedule (``[chaos]``: step
   faults retried, allocation denials, a preempt storm, decode and
   prefill NaN poison, step delays), one request cancelled mid-prefill
   and the allocator audited every tick, on a fresh observed engine:
   every survivor streams phase 4's tokens for its uid (one of them
   evicted by the storm after 22 decode steps, restored by replaying
   them), each poisoned
   request ends ``failed`` and the cancelled one ``cancelled``, every
   fault site fired and every step fault was retried, the pool ends with
   every page free or cached, the exported Chrome trace validates and
   the metrics JSON parses.

Then full-sequence scoring (``LMModel.apply`` / ``loss``, impl
"pallas": B9 → Eq. 3 + top-B → B10 in the sparse layers) on the same
model object and weights, once the serving engines are released:

10. B9–B11 on random bf16 q/k/v at the scoring path's shapes ([160,
    2048, 128]: 4 sequences × 40 heads; query block 128, key block 64,
    budget 8; B11 in 128 × 128 tiles), and once more with the queries'
    second half at q_offset 1024: B9's scores and the survivor table
    bit-equal to the plain versions', B10 and B11 within the gather
    tolerance, overall and on their first 32 query rows on their own
    (where P rounded once to bf16 would fail), B10 with every causal
    block a survivor against B11. Each
    kernel, its plain version and its library call (SDPA over the
    gathered survivors for B10, causal SDPA for B11) timed.
11. The serve-smoke model in bf16: ``apply`` logits through B9 + B10 vs
    the plain versions swapped in, ‖Δ‖/‖ref‖ ≤ 2.5e-3.
12. ``LMModel.loss`` over 4 sequences of 2048 tokens at full width,
    launch counts zeroed just before and read just after: B9 and B10
    once per sparse layer (layers 2–39), B11 and B1–B8 never; the loss
    (printed exactly, so that two trees' runs compare) and every logit
    of a following ``apply`` finite. Wall time, tokens/s and peak device
    memory are printed; one more ``loss`` call under ``torch.profiler``
    gives its device time by kernel (B9's and B10's among them) and idle
    share.
13. Phase 10's checks and times again on the q/k/v that layer 2 handed
    the kernels in phase 12, and the sparse pair (B9 + selection + B10)
    timed against B11 on them (a measurement, not a claimed speedup).
13b. ``[dryrun-peak]``: phase 12's ``loss`` walked on the meta device
    (the dry run's machinery): its arguments' bytes plus the walk's peak
    of live bytes against ``torch.cuda.max_memory_allocated()`` over the
    same call on the card (after ``reset_peak_memory_stats``, less what
    was allocated before, plus the arguments): the ratio within
    ``PEAK_RATIO``. The same, before phase 27, for its train step
    (``launch/dryrun.py::lower_cell`` at ``TRAIN_LAYERS`` layers, 4 ×
    2048 tokens in 2 microbatches, against one ``make_train_step`` step
    on the card).
14. ``ops.energon_block_attention`` forward and backward at a small size:
    the forward equals its composition, the gradients autograd through
    the plain block-sparse attention.

The rest of the attention dispatch, on the same model object and
weights:

9e. (after 9d) ``[xla-serve]``: phase 4's requests through a fresh
    graphed paged ``ServeLoop`` built with the reference's default
    ``impl="mpmrf_block"`` (the XLA selection and gather paths, resident
    planes): every request drains, none quarantined, no kernel launched;
    the streams' sha1 and how many tokens equal phase 4's (recorded, not
    gated: P rounds to bf16 on this path); prefill / decode tok/s, ITL
    p50 and the graphs' memory (``[graph] xla paged engine``); then, on
    layer 2's live operands of the last prefill wave and decode step,
    the XLA prefill and decode selections against the fused kernels'
    (B3's, B1's) survivor tables, bit for bit.
9f. (after 9e) ``[tp-serve]``: phase 4's requests through a lone
    graphed paged engine (prefix sharing on) on a ``(1, 4)`` mesh of the
    one card (``cuda:0`` × 4, the serve CLI's ``--mesh 1x4
    --simulate-devices 4``): the pools are four head shards of 2 KV
    heads, B1–B4 launch four times a fused layer and dispatch (bh = 16 a
    launch), the streams' sha1 must be phase 4's; prefill / decode
    tok/s, ITL p50/p95 and the bytes of a shard; then B1–B4 against their
    plain versions, and timed, on shard 0's live pool of layer 2
    (``tp-shard0-layer2``); decode ticks under the profiler
    (``[profile-decode-tp]``).
9g. ``[mesh-serve]``: a ``ReplicatedServeLoop`` on a ``(2, 2)`` mesh of
    the one card (two replicas of 8 slots, TP 2 each): phase 4's
    requests give phase 4's streams; the placement, merged tokens (the
    replicas' sum), merged peak pages (their max) and each replica's
    tok/s; B1–B4 launched once a fused layer, dispatch and shard. Then a
    mixed-temperature trace (8 × 512-token prompts on a 64-token system
    prompt, temperatures 0 / 0.8 / 1.0 in turn, 16 tokens each) through
    the replicas and through a single eager engine: the sampled streams
    must be equal.
15. ``[score-long]``: ``LMModel.loss`` over 2 × 8192 tokens with impl
    "pallas": n_q·n_k is 16× ``chunk_threshold``, so every layer takes
    the chunked path's kernel route — B11 on layers 0–1 (2 launches), B9
    → selection → B10 on layers 2–39 (38 each), B1–B8 never (launch
    counts zeroed just before, read just after); the loss printed
    exactly, every logit of a following ``apply`` finite, wall time,
    tok/s, peak memory, and one profiled call (``[profile-score-long]``).
    Then on layer 2's q/k/v ([80, 8192, 128]) phase 10's checks and times
    (``[full-seq:long-layer2]``, ``[time:long-layer2]``: B9, B10 and B11
    at n 8192, n_kb 128, budget 32), and the kernel route against the
    torch scan (``energon_block_attention_chunked``): survivor tables
    bit-equal, outputs within the gather tolerance, both timed.
16. ``[xla-full]``: ``LMModel.loss`` over 2 × 2048 tokens with impl
    "mpmrf_block" (the direct XLA block path): no kernel launched; on
    layer 2's q/k, ``mpmrf_block_select``'s survivor table against
    ``ops.mpmrf_select_blocks``' (B9) bit for bit; the loss beside phase
    12's.

The other dense configs, at published widths (random bf16 weights from
seed 0), once qwen3-14b is released, each model released before the
next:

17. ``[starcoder2-serve]``: starcoder2-7b (LayerNorm, GELU, G = 9)
    served as phase 4 (8 × 2048-token prompts, 256 shared, 32 greedy
    tokens, chunk 128, graphed) but at max_len 3584: its dense prefix
    layers mask ``[G·chunk, max_len]`` = ``[1152, max_len]``, within
    ``chunk_threshold`` only up to 3640 rows. B1–B4 launch once per
    layer 2–31 and dispatch; the streams' sha1; B1–B4 held against
    their plain versions on layer 2's live pool (1152 folded rows a
    chunk); decode ticks under the profiler
    (``[profile-decode-starcoder2]``). ``[starcoder2-score]``: ``loss`` over 4 × 2048 tokens (B9 /
    B10 on layers 2–31, 36 heads), then B9–B11 on layer 2's q/k/v.
18. ``[gemma3-serve]``: gemma3-27b (GeGLU, the tied head, 5 windowed : 1
    global layer, G = 2) with 4 slots, max_len 2048, 4 × 1536-token
    prompts (past the window of 1024): B1–B4 on the 10 global layers
    (5, 11, …, 59), the XLA paths on the 50 windowed layers past the
    prefix; B1–B4 held against their plain versions on layer 5's live
    pool; ``[profile-decode-gemma3]``. ``[gemma3-score]``: ``loss`` over 1 × 2048 (B9 / B10 on the
    global layers, the direct XLA block path on the windowed ones),
    then B9–B11 on layer 5's q/k/v.
19. ``[phi3-…]``: phi3-mini-3.8b (head dim 96, G = 1, 32 layers) on
    the fused kernels, which run d 96 on their d-128 instantiation with
    zero-filled columns: phase 4's requests served paged
    (``[phi3-serve]``: B1–B4, 30 launches a step or wave), B1–B4 against
    their plain versions on layer 2's live pool and timed at d 96, the
    decode ticks profiled; the same requests unpaged
    (``[phi3-unpaged]``: B5–B8, streams equal to the paged run's), B5–B8
    against their plain versions and B1–B4 on layer 2's captured rows;
    the same requests on the shipped ``mpmrf_block`` (``[phi3-xla]``,
    the A/B partner: prefill tok/s and ITL beside the fused run's);
    ``loss`` over 2 × 2048 (``[phi3-score]``: B9 / B10, 30 each) and
    B9–B11 against their plain versions on layer 2's q/k/v, timed at
    d 96; ``loss`` over 1 × 4096, past ``chunk_threshold``
    (``[phi3-score-long]``: B11 on layers 0–1, B9 → selection → B10 on
    2–31), the kernel route's survivor tables equal to the scan's; last,
    ``ServeLoop``s at head dims 8 and 192 refused at construction,
    naming the head dim, before any launch.

The MoE family, once the dense configs are released:

20. ``[olmoe-…]``: olmoe-1b-7b at published widths and full depth (16
    layers, d 2048, 16 / 16 heads of 128, 64 experts top-8, d_ff 1024
    an expert, vocab 50304; random bf16 weights from seed 0, the router
    f32: 6.92 B parameters) on the fused kernels. ``[olmoe-serve]``:
    phase 4's requests through a graphed paged engine, B1–B4 launched 14
    times a step or wave (layers 2–15), B1–B4 against their plain
    versions on layer 2's live pool (bh 128, G 1),
    ``[profile-decode-olmoe]``, then ``[olmoe-eager]``: an eager engine
    must give the graphed streams (sha1). ``[olmoe-unpaged]``: B5–B8,
    streams equal to the paged run's (paged ≡ unpaged holds for the
    reference's MoE, whose capacity couples a step's slots); B5–B8
    against their plain versions on layer 2's captured rows.
    ``[olmoe-score]``: ``loss`` over 4 × 2048 tokens (B9 / B10, 14 each),
    loss finite, aux > 0, then B9–B11 on layer 2's q/k/v.
    ``[olmoe-moe-layer]``: layer 2's MoE on its captured bf16 inputs of
    the last prefill wave (T = 1024) and decode step (T = 8), on the card
    and on the CPU in f32: experts, positions and keep equal on the rows
    clear of near-ties, the output within 2^-7 on the rows routed alike;
    the drop fraction, the layer's time beside its bound, its device
    items, and its share of a decode tick.
21. ``[moe-ep-…]``: expert parallelism on phase 20's model, weights and
    requests, on meshes of the one card. ``[moe-ep-serve-1x2]`` /
    ``[moe-ep-serve-1x4]``: a lone graphed engine, its experts split
    over the model axis (views) and its pool by KV head; B1–B4 launched
    14 × M times a step or wave; the streams' sha1 beside phase 20's,
    with the share of tokens equal (the expert-parallel layer rounds
    each shard's partial to bf16 before the cross-shard sum: these bits
    differ by design); on ``(1, 4)`` B1–B4 against their plain versions
    on shard 0's live pool (bh 32) and decode ticks under the profiler,
    their device ms beside phase 20's. ``[moe-ep-eager]``: an eager
    ``(1, 4)`` engine gives the graphed streams. ``[moe-ep-layer]``:
    layer 2's MoE on phase 20's captured inputs on ``(1, 2)`` and ``(1,
    4)``, within 2^-7 of the single-device layer, its cross-shard sum
    the f32 sum of the partials rounded once, bit for bit, its time.
    ``[moe-ep-replicas]``: ``(2, 2)`` replicas serve every request.
22. ``[qwen3moe-…]``: qwen3-moe-235b-a22b at published widths (d 4096,
    64 / 4 heads of 128: G 16, 128 experts top-8 of d_ff 1536, vocab
    151936), cut to ``QWEN3MOE_LAYERS`` layers (random bf16 weights from
    seed 0): phase 4's requests in chunks of 64 (1024 folded rows at G
    16) through a graphed paged engine, B1–B4 against their plain
    versions on layer 2's live pool (bh 32) and timed beside their
    bounds, an eager engine ≡ graphed; ``[qwen3moe-unpaged]`` (B5–B8,
    streams = paged); ``[qwen3moe-score]`` (``loss`` over 2 × 2048:
    B9 / B10, aux > 0; B9–B11 on layer 2's q/k/v); ``[qwen3moe-moe-
    layer]`` (drop fractions, card vs CPU f32); ``[qwen3moe-ep-1x4]``
    (32 experts and 1 KV head a shard, B1–B4 at bh 8). Every phase's
    device-memory peak must stay within 70 GB.

The vlm / audio and the recurrent families, once qwen3-moe is released,
each model released before the next, every phase's device-memory peak
within 70 GB and the card's name and power limit on a line of its own:

23. ``[musicgen-…]``: musicgen-medium at published widths and full depth
    (48 layers, d 1536, 24 / 24 heads of 64: G 1 on the d-64 kernels,
    LayerNorm, GELU, vocab 2048; random bf16 weights from seed 0) on the
    fused kernels: 8 × 1024-token prompts (256 shared), 32 greedy tokens,
    max_len 2048, through a graphed paged engine (``[musicgen-serve]``:
    B1/B2 46 launches a step, B3/B4 46 a wave), B1–B4 against their
    plain versions on layer 2's live pool, an eager engine with the
    graphed streams (``[musicgen-eager]``), the same requests unpaged
    (``[musicgen-unpaged]``: B5–B8, the paged streams; B5–B8 on layer
    2's captured rows), ``loss`` over 4 × 2048 of the frontend stub's
    embeddings (``[musicgen-score]``: B9 / B10 46 each) and B9–B11 on
    layer 2's q/k/v.
24. ``[llava-…]``: llava-next-34b at published widths (d 7168, 56 / 8
    heads of 128: G 7, d_ff 20480, vocab 64000) cut to ``LLAVA_LAYERS``
    layers: 4 × 2048-token prompts served paged (896 folded rows a chunk
    of 128) and unpaged, B1–B4 on layer 2's live pool at G 7, B5–B8 on
    its captured rows, ``loss`` over 2 × 2048 stub embeddings, B9–B11.
25. ``[zamba2-…]``: zamba2-7b at published widths and full depth (81
    Mamba2 layers — 13 groups of 5 + 1, 3 tail layers —, d 3584, SSM
    state 64 with heads of 64, one shared block of 32 / 32 heads of 112)
    from the contiguous cache: 4 prompts of 512 tokens admitted by one
    sequential wave (511 whole-batch decode steps under an ``active``
    mask), 32 greedy tokens, max_len 1024 (the shared block's planes
    resident), graphed: B5 / B6 13 launches a decode step, waves
    included, no other kernel; decode ticks under the profiler
    (``[profile-decode-zamba2]``); B5–B8 against their plain versions on
    group 0's shared cache (d 112); the prompts' first 64 tokens through
    a graphed and an eager engine (``[zamba2-eager]``: equal streams);
    ``loss`` over 2 × 2048 (B9 / B10 13 each) and B9–B11 on the first
    shared block's q/k/v.
26. ``[xlstm-…]``: xlstm-1.3b at published widths cut to 16 of its 48
    layers (2 of its 6 groups of 7 mLSTM + 1 sLSTM, d 2048, 4 heads:
    mLSTM heads of 1024; impl dense): the same traffic and eager pair,
    ``loss`` over 1 × 2048 (not profiled); no kernel launched at all (an
    attention path taken by mistake would launch one);
    ``[profile-decode-xlstm]``.

Training, once the last family is released (no kernel has a backward,
as no Pallas kernel of the reference has one, so these phases launch
none of B1–B11):

27. ``[train]``: qwen3-14b at published widths (d 5120, 40 / 8 heads of
    128, d_ff 17408, vocab 151936, the untied head) cut to
    ``TRAIN_LAYERS`` layers, its shipped training config (bf16, remat
    full, mpmrf_block ρ 4 from layer 2), through launch/train.py's loop
    (``make_loop``): 4 steps of 4 × 2048 tokens in 2 microbatches,
    AdamW with warmup-cosine. Every loss and grad norm finite; median
    step ms, tokens/s, 6·N·tokens/s as a share of the bf16 dense peak,
    the device-memory peak (within 70 GB) and the loss of every step.
    Then a run preempted after step 2, which saves its step-2 checkpoint
    into a temporary directory as it stops, and a fresh loop that
    resumes from it (and saves no checkpoint of its own: the card's
    machine takes 45 GiB of disk writes a call): the restored state's
    every leaf equal to the saved state's bit for bit (an exact digest
    of the bits on the device), the data state at step 2, and the
    resumed steps 3–4's losses within
    ``TRAIN_LOSS_RTOL`` of the uninterrupted run's.
28. ``[train-lm]``: the 100M ``repro_torch.train_lm`` config at its full
    size (12L, d 768, f32, remat dots, mpmrf_row from layer 2): 60 steps
    of 8 × 512, warmup_cosine(3e-4, 6, 60), first on a 200k-token corpus
    (``[train-lm-200k]``, printed, not gated: its tokens are seen ≈ 1.2
    times, too few to learn from, so the loss only falls toward the
    uniform ln 32768), then on 50k (``[train-lm-50k]``,
    ``TRAIN_LM_CORPUS``): the last logged loss at least 0.25 below the
    first (the reference's ``test_training_learns`` margin); median step
    ms, tokens/s, peak.
29. A ``pallas`` model's ``loss`` under grad refused, on the card as on
    the CPU, before any kernel launch; without grad it scores on B9.
30. ``[mesh-train]``: qwen3-14b at published widths cut to
    ``MESH_TRAIN_LAYERS``, through launch/train.py's loop: 2 steps of 4 ×
    2048 tokens in 2 microbatches on one device, then the same on a
    ``(2, 2)`` mesh of ``cuda:0`` × 4 (ZeRO over 'data', heads / MLP /
    vocabulary over 'model', the rows one after another): the first
    step's losses within ``MESH_LOSS_RTOL``, the updated parameters
    within 2·steps·lr and the share off by more than 2e-5 within
    ``MESH_PARAM_SHARE``, each device's shard bytes equal to
    ``param_shardings``' reckoning, both runs' peaks within 70 GB, the
    step ms side by side with the card's name and power limit.
31. ``[mesh-train-moe]``: olmoe-1b-7b at published widths cut to
    ``MESH_MOE_LAYERS`` on the ``(2, 2)`` mesh (ZeRO + 64 experts over
    'model', each data row's own capacity): one train step with exact
    and one with int8 expert gathers, each loss against the one-device
    loss of the same per-row capacity, layer 0's drop fraction.
32. ``[mesh-train-resume]``: a checkpoint written on ``(2, 2)`` (the
    logical arrays, fingerprint ``data=2xmodel=2``) restored on ``(1,
    1)`` and ``(4, 1)``: every logical leaf bit-equal (exact digest), and
    a further step each (qwen3-14b's smoke widths in bf16).

33. ``[mesh-uneven]``: qwen3-14b's serve config at published widths cut
    to ``MESH_UNEVEN_LAYERS`` on a ``(1, 16)`` mesh of the card, its 40
    query heads split over 'model' as GSPMD splits them (3 a shard:
    shards 0–13 hold heads, 14–15 none): ``apply`` within
    ``MESH_DECODE_GATE`` of one device's logits, ``loss`` within
    ``MESH_LOSS_RTOL``, B9 / B10 launched sparse layers × 14 (and no
    other kernel); then one train step's loss and gradients (f32,
    ρ 1) on the same mesh and on an even ``(1, 8)`` one against one
    device's: the loss at ``tests/test_torch_mesh_train.py``'s rtol,
    every gradient leaf within ``MESH_UNEVEN_GRAD_NORM`` in norm.
34. ``[serve-decode]``: ``repro_torch.serve_decode.main()`` on the card
    (the reference's ``examples/serve_decode.py``): 24 of 24 drained,
    the peak within 20 pages, ρ_eff in (0, 1], a preemption and prefix
    hits; its counters and the Chrome trace's event count.

The line before last is a JSON object listing each kernel's launches
(B1–B4 in phase 4, B5–B8 in phase 8, B9–B11 in phase 15; those of
phases 17–19 beside them), error and
times (those of the live pool, the captured layer or, B9–B11, the long
score's layer 2; ``random`` holds phase 2's, 7's or 10's; ``d96`` phase
19's at head dim 96, bounded by the d-96 work; ``tp_shard``, B1–B4 only,
phase 9f's shard; ``g16`` phase 22's at G 16; ``launches_mesh`` the
launches of phases 9f and 9g; ``launches_moe`` phase 20's,
``launches_moe_ep`` phase 21's, ``launches_qwen3moe`` phase 22's,
``launches_families`` phases 23–26, ``launches_mesh_uneven`` phase 33)
and each time over its bound (``ms_over_bound``); the mesh phases, the
eager/graphed drains, the
scoring results (with the ptxas report), the unpaged serve and the paged
serve, the telemetry and chaos phases, the long-score / XLA phases and
the dense configs', the MoE and the expert-parallel / qwen3-moe phases
and the vlm / audio and recurrent families' (``{"families": …}``), the
training phases' (``{"training": …}``) and the analysis tools'
(``{"analysis": …}``: ``[op-costs]``, ``[dryrun-peak]``) are on the lines
before it; each kernel's bytes and operations come from
``repro_torch.analysis.kernel_traffic`` on the case's data; the last
line is ``{"ok": true, "device": ...}``.
Any failure exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

SMALL_REL_TOL = 2.5e-3
#: query rows where two or three keys carry the softmax: B10/B11 (the
#: first 32 rows) and B4/B8 (the rows at positions < 32) are held to the
#: gather tolerance there on their own (P rounded once to bf16 fails it;
#: tests/test_torch_full_sequence.py)
EARLY_ROWS = 32
SYSTEM_LEN = 256                  # shared system prompt of the serve phase
#: the card the script drives (a CPU rehearsal of its logic may swap it)
DEV = "cuda"

KERNELS = {
    "mpmrf_paged_filter_scores": dict(
        id="B1", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:209"),
    "paged_decode_gather_attention": dict(
        id="B2", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:466"),
    "mpmrf_paged_prefill_filter_scores": dict(
        id="B3", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:224"),
    "paged_prefill_gather_attention": dict(
        id="B4", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:502"),
    "mpmrf_decode_filter_scores": dict(
        id="B5", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:90"),
    "decode_gather_attention": dict(
        id="B6", source="src/repro_torch/kernels/csrc/mpmrf_decode.cu",
        replaces="src/repro/kernels/mpmrf_decode.py:337"),
    "mpmrf_prefill_filter_scores": dict(
        id="B7", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:100"),
    "prefill_gather_attention": dict(
        id="B8", source="src/repro_torch/kernels/csrc/mpmrf_prefill.cu",
        replaces="src/repro/kernels/mpmrf_prefill.py:360"),
    "mpmrf_filter_scores": dict(
        id="B9", source="src/repro_torch/kernels/csrc/mpmrf_filter.cu",
        replaces="src/repro/kernels/mpmrf_filter.py:74"),
    "block_sparse_attention": dict(
        id="B10",
        source="src/repro_torch/kernels/csrc/block_sparse_attention.cu",
        replaces="src/repro/kernels/block_sparse_attention.py:92"),
    "flash_attention": dict(
        id="B11", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:82"),
}
#: the times (ms) of the redesigned kernels' previous design (PERF.md §6,
#: NVIDIA H100 80GB HBM3, 700 W) on the same kinds of operands: phase 2's
#: / 7's / 10's random case, the live pool (B2–B4) or the captured layer
#: (B6–B9): the gathers' one block per bh row or query block on CUDA
#: cores, the filters' one block per tile with __dp4a on CUDA cores.
#: They are quoted, not measured, so only the ``[time:…]`` text carries
#: them.
EARLIER_MS = {
    "mpmrf_paged_filter_scores": dict(random=0.0370, live=0.0480),
    "mpmrf_decode_filter_scores": dict(random=0.0479, captured=0.0384),
    "paged_decode_gather_attention": dict(random=0.2269, live=0.1247),
    "mpmrf_paged_prefill_filter_scores": dict(random=0.4783, live=0.7026),
    "paged_prefill_gather_attention": dict(random=0.7455, live=0.3974),
    "decode_gather_attention": dict(random=0.2386, captured=0.1377),
    "mpmrf_prefill_filter_scores": dict(random=0.6904, captured=0.7043),
    "prefill_gather_attention": dict(random=1.2027, captured=1.1732),
    "mpmrf_filter_scores": dict(random=1.9638, captured=1.9612),
}
#: the kernels' device-side names: body → (paged, contiguous) wrapper, or
#: its one wrapper
DEVICE_NAMES = {
    "decode_filter_kernel": ("mpmrf_paged_filter_scores",
                             "mpmrf_decode_filter_scores"),
    "decode_split_kernel": ("paged_decode_gather_attention",
                            "decode_gather_attention"),
    "prefill_filter_kernel": ("mpmrf_paged_prefill_filter_scores",
                              "mpmrf_prefill_filter_scores"),
    "prefill_gather_kernel": ("paged_prefill_gather_attention",
                              "prefill_gather_attention"),
    "filter_scores_kernel": ("mpmrf_filter_scores",),
    "block_sparse_attention_kernel": ("block_sparse_attention",),
    "flash_attention_kernel": ("flash_attention",),
}
SERVE_KERNELS = tuple(KERNELS)[:4]        # B1–B4: the paged serving path
UNPAGED_KERNELS = tuple(KERNELS)[4:8]     # B5–B8: the contiguous cache
SCORE_KERNELS = tuple(KERNELS)[8:]        # B9–B11: full-sequence scoring
#: the decode filters' widest planes: msb 1 bit / hi 8, and lo = 0 (the
#: msb plane the code's sign), where the q plane is 8 bits too
WIDE_ROUND_BITS = ((1, 8), (0, 8))


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def mem_gb(fn) -> str:
    return f"{fn() / 1e9:.1f}" if DEV == "cuda" else "n/a"


def sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    sync()
    if DEV != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# kernel operands at the serving path's shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelCase:
    """Operands of B1–B4 for one decode step and one prefill chunk of a
    sparse layer: ``bh = B·KV`` rows over a pool of ``KV·P`` pages."""

    q_dec: object       # [bh, G, d] bf16
    cl: object          # [bh] int32
    q_pre: object       # [bh, n_q, d] bf16
    qpos: object        # [bh, n_q] int32
    k_pages: object     # [KV·P, bk, d] bf16
    v_pages: object
    codes: object       # [KV·P, bk, d] int16
    scale: object       # [KV·P, 1] f32
    bt: object          # [bh, mb] int32 (head-offset)
    batch: int
    heads: int
    bk: int
    bq: int
    ratio: float


def random_case(gen, *, batch=8, heads=8, g=5, d=128, bk=64, mb=64, chunk=128,
                bq=128, ratio=4.0, seed=0):
    import torch

    from repro_torch.core import quantization as qlib

    dev = DEV
    num_pages = batch * mb
    rows = num_pages * bk
    k = torch.randn((heads, rows, d), generator=gen, device=dev)
    v = torch.randn((heads, rows, d), generator=gen, device=dev)
    codes, scales = qlib.quantize_int16_blocks(k.to(torch.bfloat16), bk)
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    table = perm[: batch * mb].reshape(batch, mb).to(torch.int32)
    cl = torch.randint(1, mb * bk + 1, (batch,), generator=gen, device=dev)
    # one prefill chunk per slot at a random chunk-aligned offset
    off = torch.randint(0, mb * bk // chunk, (batch,), generator=gen,
                        device=dev) * chunk
    off[0] = 0                  # a first chunk: rows where few keys count
    pos = off[:, None] + torch.arange(chunk, device=dev)[None, :]
    qpos = pos.repeat(1, g).to(torch.int32)                  # [B, G·C]
    return make_case(
        torch.randn((batch, heads, g, d), generator=gen, device=dev),
        cl.to(torch.int32),
        torch.randn((batch, heads, g * chunk, d), generator=gen, device=dev),
        qpos, k, v, codes, scales, table, bk=bk, bq=bq, ratio=ratio,
    )


def make_case(q_dec, cl, q_pre, qpos, k_pool, v_pool, codes, scales, table,
              *, bk, bq, ratio):
    import torch

    from repro_torch.kernels.ops import _head_offset_table

    batch, heads, g, d = q_dec.shape
    num_pages = k_pool.shape[1] // bk
    return KernelCase(
        q_dec=q_dec.to(torch.bfloat16).reshape(batch * heads, g, d),
        cl=cl.repeat_interleave(heads).to(torch.int32),
        q_pre=q_pre.to(torch.bfloat16).reshape(batch * heads, -1, d),
        qpos=qpos.repeat_interleave(heads, dim=0).to(torch.int32),
        k_pages=k_pool.to(torch.bfloat16).reshape(heads * num_pages, bk, d),
        v_pages=v_pool.to(torch.bfloat16).reshape(heads * num_pages, bk, d),
        codes=codes.reshape(heads * num_pages, bk, d).contiguous(),
        scale=scales.reshape(heads * num_pages, 1).float().contiguous(),
        bt=_head_offset_table(table, heads, num_pages),
        batch=batch, heads=heads, bk=bk, bq=bq, ratio=ratio,
    )


def device_ms(fn, iters=20):
    """Device time of one call of ``fn`` (ms): the CUDA-event span of
    ``iters`` calls enqueued behind a spin on the device
    (``torch.cuda._sleep``), over ``iters``. The device then runs the
    calls back to back whatever the host's pace; the spin grows until
    the host has enqueued every call before it ends. Beside
    ``time_ms``, whose span of back-to-back calls is the host's enqueue
    time where that exceeds the device's. None off the card."""
    if DEV != "cuda":
        return None
    import torch

    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24                     # ~9 ms at the H100's clock
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()        # the spin still runs
        sync()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise SmokeFailure("the host did not enqueue the calls within the "
                       "device's spin")


def trace_items(fn, iters=20):
    """The device items of a ``torch.profiler`` trace of ``iters`` calls
    of ``fn`` (warm): {name: (count, total µs)}, to show what the
    profiler records beside ``device_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(iters):
            fn()
        sync()
    items = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = items.get(e.name, (0, 0.0))
            items[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return items


def time_kernels(label, entries, rows, *, iters=20, plain_iters=5):
    """Time each kernel of ``rows`` (name, kernel, plain version, library
    call or None, and its ``repro_torch.analysis.kernel_traffic`` price:
    bytes, operations, peak rate), its plain version and its library
    call with CUDA events, bound it, and write the numbers into
    ``entries[name]``."""
    from repro_torch.analysis.kernel_traffic import bound_ms

    for name, fn, plain, lib, traffic in rows:
        r = entries[name]
        r["ms"] = time_ms(fn, iters=iters)
        r["plain_ms"] = time_ms(plain, iters=plain_iters, warmup=1)
        r["library_ms"] = (time_ms(lib, iters=iters) if lib is not None
                           else None)
        r["bound_ms"], r["bound_by"] = bound_ms(*traffic)
        lib_txt = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
        was = EARLIER_MS.get(name, {}).get(label.split("-")[0])
        was_txt = ""
        if was is not None and DEV == "cuda":   # a redesigned kernel
            r["device_ms"] = device_ms(fn)
            was_txt = (f", before the redesign {was:.4f}; device "
                       f"{r['device_ms']:.4f}")
            calls = 20
            items = trace_items(fn, calls)
            log(f"[trace:{label}] {KERNELS[name]['id']}: a profiler trace "
                f"of {calls} calls holds " + ", ".join(
                    f"{k[:48]} x{n} ({us / n:.1f} us each)"
                    for k, (n, us) in items.items())
                + f"; its device time over {calls} calls "
                f"{sum(us for _, us in items.values()) / calls / 1e3:.4f} ms")
            if lib is not None:
                r["library_device_ms"] = device_ms(lib)
                was_txt += f", library device {r['library_device_ms']:.4f}"
        log(f"[time:{label}] {KERNELS[name]['id']} {name}: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{lib_txt}, bound {r['bound_ms']:.4f} by {r['bound_by']}"
            f"{was_txt})")


def sdpa_decode(q, k_blocks, v_blocks, idx, val, cl, bk):
    """SDPA of the G folded rows over each row's gathered survivor blocks
    ``[bh, S, bk, d]`` under the decode kernels' mask (a yardstick)."""
    import torch
    import torch.nn.functional as F

    bh, g, d = q.shape
    kg = k_blocks.reshape(bh, 1, -1, d)
    vg = v_blocks.reshape(bh, 1, -1, d)
    kpos = (idx.long()[:, :, None] * bk
            + torch.arange(bk, device=q.device)).reshape(bh, -1)
    ok = ((val[:, :, None] > 0).expand(-1, -1, bk).reshape(bh, -1)
          & (kpos < cl.long()[:, None]))
    mask = ok[:, None, None, :].expand(bh, 1, g, ok.shape[-1])
    qd = q.reshape(bh, 1, g, d)
    return lambda: F.scaled_dot_product_attention(qd, kg, vg, attn_mask=mask)


def sdpa_prefill(q, qpos, k_blocks, v_blocks, idx, val, bq, bk, n_k):
    """SDPA of each query block over its gathered survivor blocks
    ``[bh, n_qb, S, bk, d]`` under the prefill kernels' per-row mask."""
    import torch
    import torch.nn.functional as F

    bh, n_q, d = q.shape
    n_qb = n_q // bq
    kg = k_blocks.reshape(bh * n_qb, 1, -1, d)
    vg = v_blocks.reshape(bh * n_qb, 1, -1, d)
    kpos = (idx.long()[..., None] * bk
            + torch.arange(bk, device=q.device)).reshape(bh, n_qb, 1, -1)
    slot_ok = (val[..., None] > 0).expand(-1, -1, -1, bk).reshape(
        bh, n_qb, 1, -1)
    qposr = qpos.long().reshape(bh, n_qb, bq, 1)
    mask = (slot_ok & (kpos <= qposr) & (qposr < n_k)).reshape(
        bh * n_qb, 1, bq, -1)
    qr = q.reshape(bh * n_qb, 1, bq, d)
    return lambda: F.scaled_dot_product_attention(qr, kg, vg, attn_mask=mask)


def early_rows_err(out, ref, qpos, label, kid):
    """Hold a prefill gather's rows at positions < EARLY_ROWS (a
    sequence's first chunk, where two or three keys carry a row) to the
    gather tolerance on their own; their max |err|, or None when the case
    has no such row."""
    from repro_torch.kernels import gather_within_tolerance

    early = qpos < EARLY_ROWS
    if not bool(early.any()):
        return None
    o, r = out[early], ref[early]
    err = (o - r).abs().max().item()
    need(gather_within_tolerance(o, r),
         f"{label} {kid} off by {err:.3e} on its rows at positions < "
         f"{EARLY_ROWS}")
    return err


def fmt_err(err):
    return "n/a" if err is None else f"{err:.3e}"


def quantized_q(q, bits=4):
    from repro_torch.core import quantization as qlib

    q16 = qlib.quantize_int16(q, axis=-1)
    return q16.bit_plane(bits).contiguous(), q16.scale.contiguous()


def check_wide_planes(kernel, plain, q, label, kid):
    """Hold a decode filter (B1 or B5: ``kernel(q_plane, q_scale,
    round_bits)`` and its plain version) to its plain version, bit for
    bit, at WIDE_ROUND_BITS, the q plane quantized to their 8 bits."""
    import torch

    for rb in WIDE_ROUND_BITS:
        qp, qs = quantized_q(q, rb[1])
        out, ref = kernel(qp, qs, rb), plain(qp, qs, rb)
        sync()
        need(all(torch.equal(a, b) for a, b in zip(out, ref)),
             f"{label} {kid} scores at round bits {rb} differ from the "
             f"plain version")
    log(f"[wide:{label}] {kid} bit-equal to its plain version at round "
        f"bits " + " and ".join(map(str, WIDE_ROUND_BITS)))


def check_case(case, label, results):
    """Hold B1–B4 against their plain versions on ``case``; time them."""
    import torch

    from repro_torch.analysis import kernel_traffic as kt
    from repro_torch.core.energon_attention import (
        _prefill_diag_blocks, decode_live_budget,
    )
    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk
    from repro_torch.kernels import ops

    c = case
    _, g, d = c.q_dec.shape
    mb = c.bt.shape[-1]
    n_k = mb * c.bk
    n_q = c.q_pre.shape[1]
    n_qb = n_q // c.bq
    budget = max(1, math.ceil(mb / c.ratio))

    # --- B1 + decode selection ------------------------------------------
    qp, qs = quantized_q(c.q_dec)
    b1 = lambda: dk.paged_filter_scores(
        qp, qs, c.codes, c.scale, c.bt, c.cl, key_block=c.bk)
    b1p = lambda: dk.paged_filter_scores_plain(
        qp, qs, c.codes, c.scale, c.bt, c.cl, key_block=c.bk)
    s0, s1 = b1()
    r0, r1 = b1p()
    sync()
    need(torch.equal(s0, r0) and torch.equal(s1, r1),
         f"{label} B1 scores differ from the plain version")
    lb = decode_live_budget(c.cl, c.bk, c.ratio)
    sel = dict(alphas=(0.0, 0.0), key_block=c.bk, block_budget=budget,
               keep_all=False, keep_first=True, keep_diagonal=True,
               live_budget=lb, heads=1)
    idx, val, _ = ops._fused_decode_select(s0, s1, c.cl, **sel)
    ridx, rval, _ = ops._fused_decode_select(r0, r1, c.cl, **sel)
    need(torch.equal(idx, ridx) and torch.equal(val, rval),
         f"{label} B1 selection differs")
    results["mpmrf_paged_filter_scores"].append(dict(err=0.0))
    if label == "random":
        check_wide_planes(
            lambda p, s, rb: dk.paged_filter_scores(
                p, s, c.codes, c.scale, c.bt, c.cl, round_bits=rb,
                key_block=c.bk),
            lambda p, s, rb: dk.paged_filter_scores_plain(
                p, s, c.codes, c.scale, c.bt, c.cl, round_bits=rb,
                key_block=c.bk), c.q_dec, label, "B1")

    # --- B2 ---------------------------------------------------------------
    b2 = lambda: dk.paged_decode_gather_attention(
        c.q_dec, c.k_pages, c.v_pages, idx, val, c.bt, c.cl, key_block=c.bk)
    b2p = lambda: dk.paged_decode_gather_attention_plain(
        c.q_dec, c.k_pages, c.v_pages, idx, val, c.bt, c.cl, key_block=c.bk)
    out, ref = b2().float(), b2p().float()
    err = (out - ref).abs().max().item()
    need(gather_within_tolerance(out, ref), f"{label} B2 off by {err:.3e}")
    results["paged_decode_gather_attention"].append(
        dict(err=err, ref_rms=ref.pow(2).mean().sqrt().item()))

    # --- B3 + prefill selection -------------------------------------------
    qpp, qps = quantized_q(c.q_pre)
    b3 = lambda: pk.paged_prefill_filter_scores(
        qpp, qps, c.qpos, c.codes, c.scale, c.bt, query_block=c.bq,
        key_block=c.bk)
    b3p = lambda: pk.paged_prefill_filter_scores_plain(
        qpp, qps, c.qpos, c.codes, c.scale, c.bt, query_block=c.bq,
        key_block=c.bk)
    p0, p1 = b3()
    q0, q1 = b3p()
    sync()
    need(torch.equal(p0, q0) and torch.equal(p1, q1),
         f"{label} B3 scores differ from the plain version")
    diag = _prefill_diag_blocks(c.qpos, c.bq, c.bk, n_k)
    psel = dict(round_bits=(2, 4), alphas=(0.0, 0.0), query_block=c.bq,
                key_block=c.bk, block_budget=budget, keep_all=False,
                keep_first=True, keep_diagonal=True, diag_blocks=diag,
                heads=1)
    pidx, pval, _ = ops._fused_prefill_select(p0, p1, **psel)
    ridx2, rval2, _ = ops._fused_prefill_select(q0, q1, **psel)
    need(torch.equal(pidx, ridx2) and torch.equal(pval, rval2),
         f"{label} B3 selection differs")
    results["mpmrf_paged_prefill_filter_scores"].append(dict(err=0.0))

    # --- B4 ---------------------------------------------------------------
    b4 = lambda: pk.paged_prefill_gather_attention(
        c.q_pre, c.qpos, c.k_pages, c.v_pages, pidx, pval, c.bt,
        query_block=c.bq, key_block=c.bk)
    b4p = lambda: pk.paged_prefill_gather_attention_plain(
        c.q_pre, c.qpos, c.k_pages, c.v_pages, pidx, pval, c.bt,
        query_block=c.bq, key_block=c.bk)
    out, ref = b4().float(), b4p().float()
    err = (out - ref).abs().max().item()
    need(gather_within_tolerance(out, ref), f"{label} B4 off by {err:.3e}")
    results["paged_prefill_gather_attention"].append(
        dict(err=err, ref_rms=ref.pow(2).mean().sqrt().item(),
             err_first_rows=early_rows_err(out, ref, c.qpos, label, "B4")))
    r2 = results["paged_decode_gather_attention"][-1]
    r4 = results["paged_prefill_gather_attention"][-1]
    log(f"[kernels:{label}] B1/B3 bit-equal (scores and selection); "
        f"B2 max |err| {r2['err']:.3e} (rms |ref| {r2['ref_rms']:.3e}), "
        f"B4 max |err| {r4['err']:.3e} (rms |ref| {r4['ref_rms']:.3e}; "
        f"rows at positions < {EARLY_ROWS} "
        f"{fmt_err(r4['err_first_rows'])})")

    # --- yardsticks: SDPA over the gathered survivors (timed only) -------
    pages = torch.gather(c.bt.long(), 1, idx.long())
    sdpa_dec = sdpa_decode(c.q_dec, c.k_pages[pages], c.v_pages[pages], idx,
                           val, c.cl, c.bk)
    ppages = torch.gather(c.bt.long()[:, None, :].expand(-1, n_qb, -1), 2,
                          pidx.long())
    sdpa_pre = sdpa_prefill(c.q_pre, c.qpos, c.k_pages[ppages],
                            c.v_pages[ppages], pidx, pval, c.bq, c.bk, n_k)

    # --- bounds from this case's data ------------------------------------
    bh, n_valid, n_pvalid = c.q_dec.shape[0], int(val.sum()), int(pval.sum())
    t1 = kt.decode_filter(bh, g, d, c.bk, mb, paged=True,
                          live_blocks=kt.live_block_count(c.cl, c.bk))
    t2 = kt.decode_gather(bh, g, d, c.bk, idx.shape[-1], paged=True,
                          valid_slots=n_valid)
    t3 = kt.prefill_filter(
        bh, n_q, d, c.bq, c.bk, mb, paged=True,
        seen_blocks=kt.seen_block_count(c.qpos, c.bk, n_k),
        pairs=kt.row_pair_count(c.qpos, n_k))
    t4 = kt.prefill_gather(
        bh, n_q, d, c.bq, c.bk, pidx.shape[-1],
        distinct_blocks=kt.distinct_block_count(ppages, pval),
        valid_slots=n_pvalid)

    time_kernels(label, {name: results[name][-1] for name in SERVE_KERNELS}, (
        ("mpmrf_paged_filter_scores", b1, b1p, None, t1),
        ("paged_decode_gather_attention", b2, b2p, sdpa_dec, t2),
        ("mpmrf_paged_prefill_filter_scores", b3, b3p, None, t3),
        ("paged_prefill_gather_attention", b4, b4p, sdpa_pre, t4),
    ))


# ---------------------------------------------------------------------------
# the full-sequence kernels (B9–B11) on one layer's [B·H, n, d] operands
# ---------------------------------------------------------------------------


def check_full_sequence(q, k, v, label, results, *, bq, bk, ratio,
                        q_offset=0, timed=True):
    """Hold B9–B11 against their plain versions on q ``[bh, n_q, d]``,
    k/v ``[bh, n_k, d]`` (bf16): B9's scores and the survivor table made
    from them bit-equal; B10 and B11 within the gather tolerance; B10
    with every causal block a survivor (ρ ≤ 1) against B11. With
    ``timed``, each kernel, its plain version and its library call are
    timed and bounded from this case's data."""
    import torch
    import torch.nn.functional as F

    from repro_torch.analysis import kernel_traffic as kt
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import mpmrf_filter as fk
    from repro_torch.kernels import ops

    bh, n_q, d = q.shape
    n_k = k.shape[1]
    n_qb, n_kb = n_q // bq, n_k // bk
    budget = max(1, math.ceil(n_kb / ratio))
    fa_block = 128                        # B11's tile (the reference's default)

    # --- B9 + selection ---------------------------------------------------
    qp, kmsb, krem, qs, ks = ops.full_sequence_planes(q, k)
    fkw = dict(shift=2, query_block=bq, key_block=bk, causal=True,
               q_offset=q_offset)
    b9 = lambda: fk.mpmrf_filter_scores(qp, kmsb, krem, qs, **fkw)
    b9p = lambda: fk.mpmrf_filter_scores_plain(qp, kmsb, krem, qs, **fkw)
    s0, s1 = b9()
    r0, r1 = b9p()
    sync()
    need(torch.equal(s0, r0) and torch.equal(s1, r1),
         f"{label} B9 scores differ from the plain version")
    skw = dict(block_budget=budget, query_block=bq, key_block=bk)
    idx, val = ops.select_from_scores(s0, s1, ks, **skw)
    ridx, rval = ops.select_from_scores(r0, r1, ks, **skw)
    need(torch.equal(idx, ridx) and torch.equal(val, rval),
         f"{label} B9 selection differs")
    entry = {"mpmrf_filter_scores": dict(label=label, err=0.0)}

    # --- B10, B11, and B10 over every causal block --------------------------
    akw = dict(query_block=bq, key_block=bk, causal=True, q_offset=q_offset)
    b10 = lambda: bsa.block_sparse_attention(q, k, v, idx, val, **akw)
    b10p = lambda: bsa.block_sparse_attention_plain(q, k, v, idx, val, **akw)
    b11 = lambda: fa.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                     block_q=fa_block, block_k=fa_block)
    b11p = lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                            q_offset=q_offset)
    dense = b11().float()
    first = EARLY_ROWS
    for name, fn, plain in (("block_sparse_attention", b10, b10p),
                            ("flash_attention", None, b11p)):
        out = dense if fn is None else fn().float()
        ref = plain().float()
        err = (out - ref).abs().max().item()
        err_first = (out[:, :first] - ref[:, :first]).abs().max().item()
        need(gather_within_tolerance(out, ref),
             f"{label} {KERNELS[name]['id']} off by {err:.3e}")
        need(gather_within_tolerance(out[:, :first], ref[:, :first]),
             f"{label} {KERNELS[name]['id']} off by {err_first:.3e} on "
             f"its first {first} query rows")
        entry[name] = dict(label=label, err=err, err_first_rows=err_first,
                           ref_rms=ref.pow(2).mean().sqrt().item())
    all_idx = torch.arange(n_kb, device=DEV, dtype=torch.int32).expand(
        bh, n_qb, n_kb).contiguous()
    every = bsa.block_sparse_attention(q, k, v, all_idx,
                                       torch.ones_like(all_idx), **akw)
    keep_all_err = (every.float() - dense).abs().max().item()
    need(gather_within_tolerance(every.float(), dense),
         f"{label} B10 over every causal block differs from B11 by "
         f"{keep_all_err:.3e}")
    kept = int(val.sum())
    causal_tiles = bh * sum(
        1 for i in range(n_qb) for j in range(n_kb)
        if j * bk <= q_offset + i * bq + bq - 1)
    log(f"[full-seq:{label}] bh {bh}, n_q {n_q}, n_k {n_k}, d {d}, "
        f"q_offset {q_offset}: B9 bit-equal (scores and selection; "
        f"{kept} survivor tiles of {causal_tiles} causal, budget "
        f"{budget}); B10 max |err| "
        f"{entry['block_sparse_attention']['err']:.3e} (first {first} rows "
        f"{entry['block_sparse_attention']['err_first_rows']:.3e}; rms "
        f"|ref| {entry['block_sparse_attention']['ref_rms']:.3e}), B11 max "
        f"|err| {entry['flash_attention']['err']:.3e} (first {first} rows "
        f"{entry['flash_attention']['err_first_rows']:.3e}); B10 over every "
        f"causal block vs B11 max |err| {keep_all_err:.3e}")
    for name, e in entry.items():
        results[name].append(e)
    if not timed:
        return None

    # --- yardsticks (timed only) ---------------------------------------------
    rows = torch.arange(bh, device=DEV)[:, None, None]
    kg = k.view(bh, n_kb, bk, d)[rows, idx.long()].reshape(bh * n_qb, 1, -1, d)
    vg = v.view(bh, n_kb, bk, d)[rows, idx.long()].reshape(bh * n_qb, 1, -1, d)
    qpos = (q_offset + torch.arange(n_qb, device=DEV)[:, None] * bq
            + torch.arange(bq, device=DEV))                  # [n_qb, bq]
    kpos = (idx.long()[..., None] * bk
            + torch.arange(bk, device=DEV)).reshape(bh, n_qb, 1, -1)
    slot_ok = (val[..., None] > 0).expand(-1, -1, -1, bk).reshape(
        bh, n_qb, 1, -1)
    mask = (slot_ok & (kpos <= qpos[None, :, :, None])).reshape(
        bh * n_qb, 1, bq, -1)
    qr = q.reshape(bh * n_qb, 1, bq, d)
    sdpa_sparse = lambda: F.scaled_dot_product_attention(qr, kg, vg,
                                                         attn_mask=mask)
    sdpa_dense = None
    if q_offset == 0 and n_q == n_k:
        sdpa_dense = lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True)

    # --- bounds from this case's data ----------------------------------------
    t9 = kt.sequence_filter(bh, n_q, n_k, d, bq, bk, q_offset=q_offset)
    t10 = kt.block_sparse(
        bh, n_q, d, bq, bk, idx.shape[-1],
        distinct_blocks=kt.distinct_block_count(kt.row_blocks(idx, n_kb),
                                                val),
        survivor_pairs=kt.survivor_pair_count(idx, val, bq, bk, q_offset))
    t11 = kt.flash(bh, n_q, n_k, d, q_offset=q_offset)

    time_kernels(label, entry, (
        ("mpmrf_filter_scores", b9, b9p, None, t9),
        ("block_sparse_attention", b10, b10p, sdpa_sparse, t10),
        ("flash_attention", b11, b11p, sdpa_dense, t11),
    ), iters=10, plain_iters=3)
    timing = {name: r["ms"] for name, r in entry.items()}
    return dict(survivor_tiles=kept, causal_tiles=causal_tiles,
                budget=budget, ms=timing)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def small_reference_check():
    """Serve-smoke model in bf16 on the card: logits through the kernels
    vs the same model with the plain versions swapped in."""
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(get_serve_config("qwen3-14b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=1)
    bsz, chunk, max_len = 2, 8, 64
    gen = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(1, cfg.vocab_size - 1, (bsz, 5 * chunk),
                         generator=gen, device=DEV)
    table = torch.arange(bsz * (max_len // 16), dtype=torch.int32,
                         device=DEV).reshape(bsz, -1)

    def run():
        cache = model.init_paged_cache(bsz * max_len // 16, max_len=max_len)
        outs = []
        for c in range(5):
            pos = (c * chunk + torch.arange(chunk, device=DEV))[None].expand(bsz, -1)
            logits, cache = model.prefill(
                params, cache, {"tokens": toks[:, c * chunk:(c + 1) * chunk],
                                "positions": pos, "block_table": table},
                torch.zeros(bsz, dtype=torch.int32, device=DEV))
            outs.append(logits)
        nxt = outs[-1][:, -1].argmax(-1)
        idx = torch.full((bsz,), 5 * chunk, dtype=torch.int32, device=DEV)
        for _ in range(2):
            logits, cache = model.decode_step(
                params, cache, {"tokens": nxt[:, None], "block_table": table},
                idx)
            outs.append(logits)
            nxt = logits[:, -1].argmax(-1)
            idx = idx + 1
        return torch.cat([o.reshape(-1, o.shape[-1]) for o in outs])

    fast = run()
    swaps = [(dk, "paged_filter_scores"), (dk, "paged_decode_gather_attention"),
             (pk, "paged_prefill_filter_scores"),
             (pk, "paged_prefill_gather_attention")]
    saved = [(m, n, getattr(m, n)) for m, n in swaps]
    try:
        for m, n in swaps:
            setattr(m, n, getattr(m, n + "_plain"))
        plain = run()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    need(bool(torch.isfinite(fast).all()), "small model: non-finite logits")
    diff = fast - plain
    err = diff.abs().max().item()
    rel = (diff.norm() / plain.norm()).item()
    log(f"[small] serve-smoke bf16 logits, kernels vs plain versions: "
        f"max |err| {err:.3e}, ‖err‖/‖ref‖ {rel:.3e} (max |logit| "
        f"{plain.abs().max().item():.3e}, rms "
        f"{plain.pow(2).mean().sqrt().item():.3e})")
    need(rel <= SMALL_REL_TOL,
         f"small model logits differ by {rel:.3e} of their norm")


def layer_paths(model):
    """How a model's layers split over the attention dispatch: (the dense
    prefix, the layers on the fused kernels, the sparse layers off them).
    The fused kernels take global layers past the prefix with impl
    "pallas"; windowed layers take the XLA paths. A hybrid model's
    attention is its shared block, once a group at layer index 10**9
    (sparse); an ssm model has none."""
    cfg = model.cfg
    if cfg.family in ("ssm", "hybrid"):
        sites = (cfg.num_layers // cfg.hybrid_attn_every
                 if cfg.family == "hybrid" else 0)
        fused = sites if cfg.energon.impl == "pallas" else 0
        return 0, fused, sites - fused
    prefix = cfg.energon.min_prune_layer
    windows = model.layer_windows() or [0] * cfg.num_layers
    fused = (sum(1 for w in windows[prefix:] if w == 0)
             if cfg.energon.impl == "pallas" else 0)
    return prefix, fused, cfg.num_layers - prefix - fused


def serve_full_width(cfg, *, seed=0, n_req=8, prompt_len=2048,
                     system_len=SYSTEM_LEN, new_tokens=32, max_len=4096,
                     chunk=128, label="serve", run2_must_equal=True):
    """Serve ``n_req`` prompts through a graphed paged ``ServeLoop`` on a
    model at ``cfg``'s widths (launch counts zeroed just before run 1,
    read just after: B1–B4 once per fused layer and dispatch, the rest
    never), then the same prompts again off the prefix cache, which must
    give run 1's streams — unless ``run2_must_equal`` is False (an MoE
    model, whose slots prefilling one shared prefix in one wave are kept
    by capacity differently, so the pages a request attaches need not be
    the ones it wrote: the streams are compared and recorded)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.runtime import Request, ServeLoop

    t0 = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=seed)
    sync()
    init_peak = (float(mem_gb(torch.cuda.max_memory_allocated))
                 if DEV == "cuda" else None)
    log(f"[{label}] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}H/{cfg.num_kv_heads}KV, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype} weights "
        f"{mem_gb(torch.cuda.memory_allocated)} GB, init "
        f"{time.perf_counter() - t0:.1f} s (peak {init_peak} GB)")
    engine = ServeLoop(
        model, params, batch_slots=n_req, max_len=max_len, eos_token=-1,
        seed=seed, prefill_chunk=chunk, prefix_sharing=True, device=DEV,
    )
    need(engine.cuda_graphs, "the engine does not replay CUDA graphs")
    engine.capture_graphs()
    graph = log_graphs("[graph] paged engine" if label == "serve"
                       else f"[graph] {label} engine", engine)
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size - 1, size=system_len).tolist()
    prompts = [system + rng.integers(1, cfg.vocab_size - 1,
                                     size=prompt_len - system_len).tolist()
               for _ in range(n_req)]

    def drive(uid0):
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=uid0 + i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        t = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        return [r for r in done if r.uid >= uid0], time.perf_counter() - t

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    done, wall = drive(0)
    launches = dict(_build.launch_counts)
    m = engine.metrics
    lat = m.latency_stats()
    log(f"[{label}] run 1: {len(done)} requests drained in {wall:.2f} s; "
        f"prefill {m.prefill_tokens} tok in {m.prefill_time:.3f} s "
        f"({m.prefill_tokens_per_sec:.1f} tok/s), decode {m.decode_tokens} "
        f"tok in {m.decode_time:.3f} s ({m.decode_tokens_per_sec:.1f} tok/s); "
        f"ttft p50/p95 {lat['ttft_p50'] * 1e3:.1f}/{lat['ttft_p95'] * 1e3:.1f}"
        f" ms, itl p50/p95 {lat['itl_p50'] * 1e3:.2f}/"
        f"{lat['itl_p95'] * 1e3:.2f} ms; peak {m.peak_pages_in_use} pages, "
        f"peak device memory {mem_gb(torch.cuda.max_memory_allocated)} GB")
    log(f"[{label}] run 1 kernel launches: {json.dumps(launches)}")
    run1 = dict(
        prefill_tok_s=m.prefill_tokens_per_sec,
        decode_tok_s=m.decode_tokens_per_sec, wall_s=wall,
        ttft_p50_ms=lat["ttft_p50"] * 1e3, ttft_p95_ms=lat["ttft_p95"] * 1e3,
        itl_p50_ms=lat["itl_p50"] * 1e3, itl_p95_ms=lat["itl_p95"] * 1e3,
        peak_memory_gb=float(mem_gb(torch.cuda.max_memory_allocated))
        if DEV == "cuda" else None, init_peak_gb=init_peak,
    )
    need(len(done) == n_req and all(r.done for r in done),
         "not every request drained")
    need(all(len(r.tokens_out) == new_tokens for r in done),
         f"a request stopped short of {new_tokens} tokens")
    need(m.failed_requests == 0,
         f"{m.failed_requests} requests quarantined (non-finite logits)")
    prefix, fused, off = layer_paths(model)
    per = {"mpmrf_paged_filter_scores": m.decode_dispatches,
           "paged_decode_gather_attention": m.decode_dispatches,
           "mpmrf_paged_prefill_filter_scores": m.prefill_dispatches,
           "paged_prefill_gather_attention": m.prefill_dispatches}
    for name, n_calls in per.items():
        need(n_calls > 0 and launches[name] == fused * n_calls,
             f"{name} launched {launches[name]} times, not {fused} fused "
             f"layers × {n_calls} dispatches")
    for name in UNPAGED_KERNELS + SCORE_KERNELS:
        need(launches[name] == 0, f"{name} launched on the paged path")
    log(f"[{label}] run 1 paths: {prefix} dense prefix layers, {fused} "
        f"layers on the fused kernels (B1/B2 {fused} × "
        f"{m.decode_dispatches} decode steps, B3/B4 {fused} × "
        f"{m.prefill_dispatches} prefill waves), {off} sparse layers on "
        f"the XLA paths")
    run1.update(graph=graph, dense_layers=prefix, fused_layers=fused,
                xla_layers=off,
                decode_dispatches=m.decode_dispatches,
                prefill_dispatches=m.prefill_dispatches)
    streams1 = {r.uid: list(r.tokens_out) for r in done}
    log(f"[{label}] run 1 greedy streams, sha1 (to compare two trees' "
        f"runs): {streams_digest(streams1)}")

    pf_tok, pf_time = m.prefill_tokens, m.prefill_time
    done2, wall2 = drive(100)
    streams2 = {r.uid - 100: list(r.tokens_out) for r in done2}
    log(f"[{label}] run 2 (same prompts, prefix cache warm): {len(done2)} "
        f"requests in {wall2:.2f} s; prefix hit-rate "
        f"{m.prefix_hit_rate:.2f}, {m.prefill_tokens_skipped} prefill tok "
        f"skipped, {m.prefill_tokens - pf_tok} recomputed in "
        f"{m.prefill_time - pf_time:.3f} s")
    run1["run2_uids_differing"] = sum(
        streams1[u] != streams2.get(u) for u in streams1)
    if run2_must_equal:
        need(streams1 == streams2, "run 2 streams differ from run 1")
    else:
        log(f"[{label}] run 2 streams equal run 1's for "
            f"{n_req - run1['run2_uids_differing']} of {n_req} requests "
            f"(recorded, not gated: see the docstring)")
    need(m.prefix_hits > 0, "run 2 never hit the prefix cache")
    return engine, prompts, run1, launches, streams1


def log_graphs(label, engine):
    """One ``[graph]`` line: each graphed step's captures, warm-up and
    capture seconds and the device memory its graphs reserved."""
    steps = engine.graphs
    log(f"{label}: " + "; ".join(
        f"{s.method} {s.captures} graph(s), captured in "
        f"{s.capture_seconds:.2f} s, {s.graph_bytes / 2**30:.2f} GiB"
        for s in steps) + " (one capture stream and memory pool)")
    return dict(capture_s=sum(s.capture_seconds for s in steps),
                graph_gib=sum(s.graph_bytes for s in steps) / 2**30)


def streams_digest(streams):
    """sha1 of a run's greedy streams ({uid: tokens})."""
    import hashlib

    text = json.dumps({str(k): v for k, v in sorted(streams.items())})
    return hashlib.sha1(text.encode()).hexdigest()


def live_pool_case(engine, prompts, layer, shard=None):
    """Kernel operands on the live pool of ``layer`` after serving: each
    finished request's registered pages form its block table. With
    ``shard``, that head shard of a sharded pool (bh = B·KV/M rows)."""
    import torch

    model = engine.model
    cfg = model.cfg
    bk = engine.layout.page_size
    mb = engine.layout.max_blocks
    tables, lens = [], []
    for p in prompts:
        pages = engine.allocator.match_prefix(p)
        tables.append(pages + [0] * (mb - len(pages)))
        lens.append(len(pages) * bk)
    need(all(n > 0 for n in lens), "no registered pages after serving")
    table = torch.tensor(tables, dtype=torch.int32, device=DEV)
    cl = torch.tensor(lens, dtype=torch.int32, device=DEV)
    heads, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    chunk = engine.prefill_chunk
    gen = torch.Generator(device=DEV).manual_seed(7)
    pool = engine.cache
    if shard is not None:
        pool = {name: leaf[shard] for name, leaf in pool.items()}
    # the last prompt chunk of each request, tiled over the G groups
    pos = (cl.long()[:, None] - chunk
           + torch.arange(chunk, device=DEV)[None, :])
    # queries: the pool's own keys at those positions, so scores are live
    kq = pool["k"][layer][:, (table.long()[:, :, None] * bk
                              + torch.arange(bk, device=DEV)).reshape(
                                  len(prompts), -1)]      # [KV, B, rows, d]
    kq = kq.movedim(1, 0)
    q_pre = torch.stack([kq[b, :, pos[b]] for b in range(len(prompts))])
    q_pre = q_pre.repeat(1, 1, g, 1) + 0.1 * torch.randn(
        q_pre.shape[:2] + (g * chunk, q_pre.shape[-1]), generator=gen,
        device=DEV, dtype=q_pre.dtype)
    q_dec = q_pre[:, :, -g:].contiguous()
    return make_case(
        q_dec, cl, q_pre, pos.repeat(1, g).to(torch.int32),
        pool["k"][layer], pool["v"][layer], pool["k_codes"][layer],
        pool["k_scale"][layer], table, bk=bk, bq=cfg.energon.query_block,
        ratio=cfg.energon.pruning_ratio,
    )


def profile_drain(engine, system, *, seed=1, n_req=8, prompt_len=2048,
                  new_tokens=16):
    """Serve fresh prompts (the same system prompt, new bodies) on
    ``engine`` under ``torch.profiler``: device time by kernel, and the
    share of the drain's wall time the device was busy."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import Request

    from repro_torch.kernels import _build

    vocab = engine.model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    m = engine.metrics
    pf0, dec0 = m.prefill_time, m.decode_time
    _build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for i in range(n_req):
            body = rng.integers(1, vocab - 1, size=prompt_len - len(system))
            engine.submit(Request(uid=1000 + i, prompt=system + body.tolist(),
                                  max_new_tokens=new_tokens))
        t0 = time.perf_counter()
        engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
    launched = {KERNELS[name]["id"]: _build.launch_counts[name]
                for name in SERVE_KERNELS}
    split = device_split(prof, wall)
    out = dict(wall_s=wall, prefill_s=m.prefill_time - pf0,
               decode_s=m.decode_time - dec0, launched=launched, **split)
    graphed = "replayed from CUDA graphs" if engine.cuda_graphs else "eager"
    log(f"[profile] {n_req} fresh prompts of {prompt_len} tokens, "
        f"{new_tokens} new each, {graphed}: wall {wall:.3f} s (prefill "
        f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s), "
        f"device busy {out['device_busy_s']:.3f} s, idle "
        f"{out['idle_share']:.1%} (under the profiler)")
    for r in out["top"]:
        log(f"[profile] {r['device_ms']:10.2f} ms  x{r['calls']:<6d} "
            f"{r['name']}")
    seen = {k: out["port"].get(k, {"calls": 0, "device_ms": 0.0})
            for k in launched}
    log("[profile] the port's kernels: " + ", ".join(
        f"{k} {r['device_ms']:.2f} ms over {r['calls']} calls (of "
        f"{launched[k]} launched" + (
            f"; the profiler missed {launched[k] - r['calls']}"
            if r["calls"] < launched[k] else "") + ")"
        for k, r in seen.items()))
    return out


def profile_decode(engine, system, *, seed=2, n_req=8, prompt_len=2048,
                   ticks=8, label="profile-decode"):
    """Decode ticks alone under ``torch.profiler``: fresh prompts are
    prefilled first, unprofiled, then ``ticks`` ticks in which every slot
    decodes are traced. Per tick: wall and device busy time, the device's
    idle share, the kernels the device ran, and the largest items."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import Request

    vocab = engine.model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    for i in range(n_req):
        body = rng.integers(1, vocab - 1, size=prompt_len - len(system))
        engine.submit(Request(uid=2000 + i, prompt=system + body.tolist(),
                              max_new_tokens=ticks + 4))
    while engine.pending or not all(r is not None and r.state == "decode"
                                    for r in engine.slots):
        engine.tick()
    engine.tick()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        sync()
        wall = time.perf_counter() - t0
    engine.run_until_drained()
    split = device_split(prof, wall, top=8)
    out = dict(ticks=ticks, tick_ms=wall / ticks * 1e3,
               device_ms=split["device_busy_s"] / ticks * 1e3,
               idle_share=split["idle_share"],
               kernels_per_tick=split["kernels"] / ticks, top=split["top"])
    log(f"[{label}] {ticks} decode ticks of {n_req} slots "
        f"({'graphed' if engine.cuda_graphs else 'eager'}): "
        f"{out['tick_ms']:.2f} ms a tick, device busy "
        f"{out['device_ms']:.2f} ms a tick, idle {out['idle_share']:.1%}, "
        f"{out['kernels_per_tick']:.0f} device kernels and copies a tick "
        f"(under the profiler)")
    for r in out["top"]:
        log(f"[{label}] {r['device_ms'] / ticks:8.3f} ms a tick  "
            f"x{r['calls'] / ticks:<7.1f} {r['name']}")
    return out


def device_split(prof, wall, top=12):
    """Device time by kernel from a ``torch.profiler`` run: the kernels'
    and copies' own intervals (op rows of key_averages() also carry the
    device time of what they launch), their sum, and the share of
    ``wall`` seconds the device sat idle."""
    from torch.autograd import DeviceType

    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in per_kernel.values())
    need(busy_us > 0, "the profiler saw no device time")
    items = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    port = {}
    for name, (calls, us) in per_kernel.items():
        m = re.match(r"void (\w+)<\d+(?:, \d+)?(, (true|false))?>", name)
        if m and m.group(1) in DEVICE_NAMES:
            wrappers = DEVICE_NAMES[m.group(1)]
            wrapper = wrappers[0 if m.group(3) != "false" else 1]
            kid = KERNELS[wrapper]["id"]
            c0, us0 = port.get(kid, (0, 0.0))
            port[kid] = (c0 + calls, us0 + us)
    return dict(device_busy_s=busy_us / 1e6,
                idle_share=1 - busy_us / 1e6 / wall,
                kernels=sum(c for c, _ in per_kernel.values()),
                top=[dict(name=k[:90], calls=c, device_ms=us / 1e3)
                     for k, (c, us) in items],
                port={k: dict(calls=c, device_ms=us / 1e3)
                      for k, (c, us) in sorted(port.items())})


# ---------------------------------------------------------------------------
# the contiguous-cache serving path (B5–B8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ContiguousCase:
    """Operands of B5–B8 for one decode step and one prefill chunk of a
    sparse layer over the contiguous cache: ``bh = B·KV`` rows of
    ``n_k`` keys, planes scaled per ``bk``-row block."""

    q_dec: object       # [bh, G, d] bf16
    cl: object          # [bh] int32
    q_pre: object       # [bh, n_q, d] bf16
    qpos: object        # [bh, n_q] int32
    k: object           # [bh, n_k, d] bf16
    v: object
    codes: object       # [bh, n_k, d] int16
    scale: object       # [bh, n_k // bk] f32
    bk: int             # decode key block = the planes' scale block
    pk: int             # prefill key block (B7 / B8)
    bq: int
    ratio: float


def random_contiguous_case(gen, *, bh=64, g=5, d=128, n_k=4096, bk=64,
                           pk=64, chunk=128, bq=128, ratio=4.0):
    """Random operands at the unpaged path's shapes, with an idle slot's
    ``max_len + 1`` length and a ragged tail of sentinel rows."""
    import torch

    from repro_torch.core import quantization as qlib

    dev = DEV
    k = torch.randn((bh, n_k, d), generator=gen, device=dev).to(
        torch.bfloat16)
    codes, scales = qlib.quantize_int16_blocks(k, bk)
    cl = torch.randint(1, n_k + 1, (bh,), generator=gen, device=dev)
    cl[0] = n_k + 1
    off = torch.randint(0, n_k // chunk, (bh,), generator=gen,
                        device=dev) * chunk
    off[2] = 0                  # a first chunk: rows where few keys count
    pos = off[:, None] + torch.arange(chunk, device=dev)[None, :]
    pos[1, -9:] = n_k
    return ContiguousCase(
        q_dec=torch.randn((bh, g, d), generator=gen, device=dev).to(
            torch.bfloat16),
        cl=cl.to(torch.int32),
        q_pre=torch.randn((bh, g * chunk, d), generator=gen, device=dev).to(
            torch.bfloat16),
        qpos=pos.repeat(1, g).to(torch.int32), k=k,
        v=torch.randn((bh, n_k, d), generator=gen, device=dev).to(
            torch.bfloat16),
        codes=codes, scale=scales, bk=bk, pk=pk, bq=bq, ratio=ratio,
    )


def contiguous_selection(c, s0, s1, p0, p1):
    """The survivor tables the path selects from B5's and B7's scores."""
    from repro_torch.core.energon_attention import (
        _prefill_diag_blocks, decode_live_budget,
    )
    from repro_torch.kernels import ops

    n_k = c.k.shape[1]
    lb = decode_live_budget(c.cl, c.bk, c.ratio)
    idx, val, _ = ops._fused_decode_select(
        s0, s1, c.cl, alphas=(0.0, 0.0), key_block=c.bk,
        block_budget=max(1, math.ceil(n_k // c.bk / c.ratio)),
        keep_all=False, keep_first=True, keep_diagonal=True,
        live_budget=lb, heads=1)
    pidx, pval, _ = ops._fused_prefill_select(
        p0, p1, round_bits=(2, 4), alphas=(0.0, 0.0), query_block=c.bq,
        key_block=c.pk, block_budget=max(1, math.ceil(n_k // c.pk / c.ratio)),
        keep_all=False, keep_first=True, keep_diagonal=True,
        diag_blocks=_prefill_diag_blocks(c.qpos, c.bq, c.pk, n_k), heads=1)
    return idx, val, pidx, pval


def check_contiguous(c, label, results, *, timed=True, gather=True):
    """Hold B5–B8 against their plain versions on ``c``: B5 / B7 scores
    and the survivor tables selected from them bit-equal, B6 / B8 within
    the gather tolerance. With ``timed``, each kernel, its plain version
    and (B6, B8) SDPA over the gathered survivors are timed and bounded
    from this case's data. Returns the operands for
    :func:`check_same_rows`."""
    import torch

    from repro_torch.analysis import kernel_traffic as kt
    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk

    bh, g, d = c.q_dec.shape
    n_k = c.k.shape[1]
    n_q = c.q_pre.shape[1]
    qp, qs = quantized_q(c.q_dec)
    qpp, qps = quantized_q(c.q_pre)
    row_scale = c.scale.repeat_interleave(c.bk, dim=-1).contiguous()
    fkw = dict(key_block=c.bk)
    pkw = dict(query_block=c.bq, key_block=c.pk)
    b5 = lambda: dk.mpmrf_decode_filter_scores(qp, qs, c.codes, c.scale,
                                               c.cl, **fkw)
    b5p = lambda: dk.mpmrf_decode_filter_scores_plain(qp, qs, c.codes,
                                                      c.scale, c.cl, **fkw)
    b7 = lambda: pk.mpmrf_prefill_filter_scores(qpp, qps, c.qpos, c.codes,
                                                row_scale, **pkw)
    b7p = lambda: pk.mpmrf_prefill_filter_scores_plain(
        qpp, qps, c.qpos, c.codes, row_scale, **pkw)
    s0, s1 = b5()
    r0, r1 = b5p()
    p0, p1 = b7()
    q0, q1 = b7p()
    sync()
    need(torch.equal(s0, r0) and torch.equal(s1, r1),
         f"{label} B5 scores differ from the plain version")
    need(torch.equal(p0, q0) and torch.equal(p1, q1),
         f"{label} B7 scores differ from the plain version")
    idx, val, pidx, pval = contiguous_selection(c, s0, s1, p0, p1)
    ref_sel = contiguous_selection(c, r0, r1, q0, q1)
    need(all(torch.equal(a, b) for a, b in zip(
        (idx, val, pidx, pval), ref_sel)),
        f"{label} B5/B7 survivor tables differ")
    results["mpmrf_decode_filter_scores"].append(dict(err=0.0))
    results["mpmrf_prefill_filter_scores"].append(dict(err=0.0))
    if label == "random":
        check_wide_planes(
            lambda p, s, rb: dk.mpmrf_decode_filter_scores(
                p, s, c.codes, c.scale, c.cl, round_bits=rb, **fkw),
            lambda p, s, rb: dk.mpmrf_decode_filter_scores_plain(
                p, s, c.codes, c.scale, c.cl, round_bits=rb, **fkw),
            c.q_dec, label, "B5")
    line = (f"[contiguous:{label}] bh {bh}, n_k {n_k}, d {d}, key blocks "
            f"{c.bk}/{c.pk}: B5/B7 bit-equal (scores and survivor tables)")
    if not gather:
        log(line)
        return None

    b6 = lambda: dk.decode_gather_attention(c.q_dec, c.k, c.v, idx, val,
                                            c.cl, **fkw)
    b6p = lambda: dk.decode_gather_attention_plain(c.q_dec, c.k, c.v, idx,
                                                   val, c.cl, **fkw)
    b8 = lambda: pk.prefill_gather_attention(c.q_pre, c.qpos, c.k, c.v,
                                             pidx, pval, **pkw)
    b8p = lambda: pk.prefill_gather_attention_plain(
        c.q_pre, c.qpos, c.k, c.v, pidx, pval, **pkw)
    for name, fn, plain in (("decode_gather_attention", b6, b6p),
                            ("prefill_gather_attention", b8, b8p)):
        out, ref = fn().float(), plain().float()
        err = (out - ref).abs().max().item()
        need(gather_within_tolerance(out, ref),
             f"{label} {KERNELS[name]['id']} off by {err:.3e}")
        results[name].append(dict(err=err,
                                  ref_rms=ref.pow(2).mean().sqrt().item()))
    r6 = results["decode_gather_attention"][-1]
    r8 = results["prefill_gather_attention"][-1]
    # out, ref: B8's (the loop's last)
    r8["err_first_rows"] = early_rows_err(out, ref, c.qpos, label, "B8")
    log(f"{line}; B6 max |err| {r6['err']:.3e} (rms |ref| "
        f"{r6['ref_rms']:.3e}), B8 max |err| {r8['err']:.3e} (rms |ref| "
        f"{r8['ref_rms']:.3e}; rows at positions < {EARLY_ROWS} "
        f"{fmt_err(r8['err_first_rows'])})")
    ops_in = dict(qp=qp, qs=qs, qpp=qpp, qps=qps, s=(s0, s1), p=(p0, p1),
                  idx=idx, val=val, pidx=pidx, pval=pval)
    if not timed:
        return ops_in

    # --- yardsticks: SDPA over the gathered survivors (timed only) -------
    rows = torch.arange(bh, device=DEV)[:, None]
    sdpa_dec = sdpa_decode(
        c.q_dec, c.k.view(bh, -1, c.bk, d)[rows, idx.long()],
        c.v.view(bh, -1, c.bk, d)[rows, idx.long()], idx, val, c.cl, c.bk)
    rows = rows[..., None]
    sdpa_pre = sdpa_prefill(
        c.q_pre, c.qpos, c.k.view(bh, -1, c.pk, d)[rows, pidx.long()],
        c.v.view(bh, -1, c.pk, d)[rows, pidx.long()], pidx, pval, c.bq,
        c.pk, n_k)

    # --- bounds from this case's data ------------------------------------
    n_kb, n_pkb = n_k // c.bk, n_k // c.pk
    t5 = kt.decode_filter(
        bh, g, d, c.bk, n_kb, paged=False,
        live_blocks=kt.live_block_count(c.cl, c.bk, n_kb))
    t6 = kt.decode_gather(bh, g, d, c.bk, idx.shape[-1], paged=False,
                          valid_slots=int(val.sum()))
    t7 = kt.prefill_filter(
        bh, n_q, d, c.bq, c.pk, n_pkb, paged=False,
        seen_blocks=kt.seen_block_count(c.qpos, c.pk, n_k),
        pairs=kt.row_pair_count(c.qpos, n_k))
    t8 = kt.prefill_gather(
        bh, n_q, d, c.bq, c.pk, pidx.shape[-1],
        distinct_blocks=kt.distinct_block_count(
            kt.row_blocks(pidx, n_pkb), pval),
        valid_slots=int(pval.sum()))

    time_kernels(label, {n: results[n][-1] for n in UNPAGED_KERNELS}, (
        ("mpmrf_decode_filter_scores", b5, b5p, None, t5),
        ("decode_gather_attention", b6, b6p, sdpa_dec, t6),
        ("mpmrf_prefill_filter_scores", b7, b7p, None, t7),
        ("prefill_gather_attention", b8, b8p, sdpa_pre, t8),
    ))
    return ops_in


def check_same_rows(c, o, label, gen):
    """Lay ``c``'s contiguous rows out as pages under a shuffled block
    table: B1 must equal B5, B2 equal B6, B3 equal B7 and B4 equal B8,
    bit for bit (the twins share their kernel bodies). Each pair is then
    timed in turns on those rows, by events and on the device; returns
    the times."""
    import torch

    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk

    need(c.pk == c.bk, "the paged kernels take one page per key tile")
    bh, n_k, d = c.k.shape
    n_kb = n_k // c.bk
    table = torch.randperm(bh * n_kb, generator=gen, device=DEV)
    inv = torch.empty_like(table)
    inv[table] = torch.arange(bh * n_kb, device=DEV)
    table = table.reshape(bh, n_kb).to(torch.int32)

    def pages(x):
        return x.reshape(bh * n_kb, c.bk, d)[inv].contiguous()

    codes, k, v = pages(c.codes), pages(c.k), pages(c.v)
    scale = c.scale.reshape(-1)[inv].reshape(-1, 1).contiguous()
    row_scale = c.scale.repeat_interleave(c.bk, dim=-1).contiguous()
    pairs = {
        "B5/B1": (
            lambda: dk.mpmrf_decode_filter_scores(
                o["qp"], o["qs"], c.codes, c.scale, c.cl, key_block=c.bk),
            lambda: dk.paged_filter_scores(
                o["qp"], o["qs"], codes, scale, table, c.cl,
                key_block=c.bk)),
        "B6/B2": (
            lambda: dk.decode_gather_attention(
                c.q_dec, c.k, c.v, o["idx"], o["val"], c.cl, key_block=c.bk),
            lambda: dk.paged_decode_gather_attention(
                c.q_dec, k, v, o["idx"], o["val"], table, c.cl,
                key_block=c.bk)),
        "B7/B3": (
            lambda: pk.mpmrf_prefill_filter_scores(
                o["qpp"], o["qps"], c.qpos, c.codes, row_scale,
                query_block=c.bq, key_block=c.bk),
            lambda: pk.paged_prefill_filter_scores(
                o["qpp"], o["qps"], c.qpos, codes, scale, table,
                query_block=c.bq, key_block=c.bk)),
        "B8/B4": (
            lambda: pk.prefill_gather_attention(
                c.q_pre, c.qpos, c.k, c.v, o["pidx"], o["pval"],
                query_block=c.bq, key_block=c.bk),
            lambda: pk.paged_prefill_gather_attention(
                c.q_pre, c.qpos, k, v, o["pidx"], o["pval"], table,
                query_block=c.bq, key_block=c.bk)),
    }
    for name, (contiguous, paged) in pairs.items():
        a, b = contiguous(), paged()
        sync()
        same = (all(torch.equal(x, y) for x, y in zip(a, b))
                if isinstance(a, tuple) else torch.equal(a, b))
        need(same, f"{label} {name}: the twins differ on the same rows")
    # both twins timed in turns (paged, contiguous, contiguous, paged),
    # by events and on the device (events behind a spin)
    times = {}
    for name, (contiguous, paged) in pairs.items():
        t = {}
        for unit, timer in (("ms", time_ms), ("device_ms", device_ms)):
            tp0, tc0 = timer(paged), timer(contiguous)
            tc1, tp1 = timer(contiguous), timer(paged)
            if tp0 is not None:
                t[f"contiguous_{unit}"] = (tc0 + tc1) / 2
                t[f"paged_{unit}"] = (tp0 + tp1) / 2
        times[name] = t
    log(f"[same-rows:{label}] the contiguous rows as {bh * n_kb} shuffled "
        f"pages: B5 = B1, B6 = B2, B7 = B3, B8 = B4 bit for bit; ms "
        f"contiguous/paged " + ", ".join(
            f"{n} {t['contiguous_ms']:.4f}/{t['paged_ms']:.4f}"
            + (f" (device {t['contiguous_device_ms']:.4f}/"
               f"{t['paged_device_ms']:.4f})" if "paged_device_ms" in t
               else "")
            for n, t in times.items()))
    return times


def serve_unpaged(model, params, prompts, paged_streams, *, seed=0,
                  new_tokens=32, max_len=4096, chunk=128, label="unpaged"):
    """The same requests through ``ServeLoop(paged=False)`` on the same
    model: launch counts zeroed just before and read just after; every
    request drains, none quarantined, with the paged run's greedy stream.
    Layer 2's queries of the last prefill wave and the last decode step
    are kept for the captured kernel case."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.runtime import Request, ServeLoop

    cfg = model.cfg
    sparse = cfg.num_layers - cfg.energon.min_prune_layer
    engine = ServeLoop(
        model, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, seed=seed, prefill_chunk=chunk, paged=False,
        device=DEV,
    )
    captured, calls = {}, {"prefill": 0, "decode": 0}
    real = {"prefill": ops.fused_prefill_attention,
            "decode": ops.fused_decode_attention}

    def capturing(kind):
        def fn(q, *args, **kw):
            if calls[kind] % sparse == 0:       # the first sparse layer
                pos = args[4]                   # q_positions / cache_length
                captured[kind] = (q.clone(), pos.clone())
            calls[kind] += 1
            return real[kind](q, *args, **kw)
        return fn

    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.fused_prefill_attention = capturing("prefill")
    ops.fused_decode_attention = capturing("decode")
    try:
        # captured with the patches in place: the graphs' copies of layer
        # 2's queries are refreshed by every replay
        engine.capture_graphs()
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        ops.fused_prefill_attention = real["prefill"]
        ops.fused_decode_attention = real["decode"]
    m = engine.metrics
    lat = m.latency_stats()
    peak = mem_gb(torch.cuda.max_memory_allocated)
    log(f"[{label}] {len(done)} requests drained in {wall:.2f} s; prefill "
        f"{m.prefill_tokens} tok in {m.prefill_time:.3f} s "
        f"({m.prefill_tokens_per_sec:.1f} tok/s), decode {m.decode_tokens} "
        f"tok in {m.decode_time:.3f} s ({m.decode_tokens_per_sec:.1f} "
        f"tok/s); ttft p50 {lat['ttft_p50'] * 1e3:.1f} ms, itl p50 "
        f"{lat['itl_p50'] * 1e3:.2f} ms; contiguous cache "
        f"{engine.batch_slots} × {engine.max_len} rows; peak device memory "
        f"{peak} GB")
    log(f"[{label}] kernel launches: {json.dumps(launches)}")
    need(len(done) == len(prompts) and all(r.done for r in done),
         "unpaged: not every request drained")
    need(m.failed_requests == 0,
         f"unpaged: {m.failed_requests} requests quarantined (non-finite "
         f"logits)")
    streams = {r.uid: list(r.tokens_out) for r in done}
    need(streams == paged_streams,
         "unpaged greedy streams differ from the paged run's")
    per = {"mpmrf_decode_filter_scores": m.decode_dispatches,
           "decode_gather_attention": m.decode_dispatches,
           "mpmrf_prefill_filter_scores": m.prefill_dispatches,
           "prefill_gather_attention": m.prefill_dispatches}
    for name, n_calls in per.items():
        need(n_calls > 0 and launches[name] == sparse * n_calls,
             f"{name} launched {launches[name]} times, not {sparse} × "
             f"{n_calls} (layers {cfg.energon.min_prune_layer}–"
             f"{cfg.num_layers - 1} of every dispatch)")
    for name in SERVE_KERNELS + SCORE_KERNELS:
        need(launches[name] == 0, f"{name} launched on the unpaged path")
    log(f"[{label}] streams equal the paged run's, token for token; B5/B6 "
        f"{sparse} × {m.decode_dispatches} decode steps, B7/B8 {sparse} × "
        f"{m.prefill_dispatches} prefill waves; B1–B4, B9–B11 never")
    out = dict(
        prefill_tok_s=m.prefill_tokens_per_sec,
        decode_tok_s=m.decode_tokens_per_sec, wall_s=wall,
        ttft_p50_ms=lat["ttft_p50"] * 1e3, itl_p50_ms=lat["itl_p50"] * 1e3,
        peak_memory_gb=peak, prefill_dispatches=m.prefill_dispatches,
        decode_dispatches=m.decode_dispatches,
    )
    return engine, out, launches, captured


def serve_in_turns(model, params, prompts, streams, *, seed=0,
                   new_tokens=32, max_len=4096, chunk=128):
    """The same requests through a fresh paged engine (prefix sharing
    off) and then a fresh unpaged one, both warm: with phase 8's unpaged
    drain before them, the two layouts are timed in turns in one call
    (unpaged, paged, unpaged). Each must give ``streams``."""
    import torch

    from repro_torch.runtime import Request, ServeLoop

    out = {}
    for layout in ("paged", "unpaged"):
        engine = ServeLoop(
            model, params, batch_slots=len(prompts), max_len=max_len,
            eos_token=-1, seed=seed, prefill_chunk=chunk,
            paged=layout == "paged", prefix_sharing=False, device=DEV,
        )
        engine.capture_graphs()
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
        need({r.uid: list(r.tokens_out) for r in done} == streams,
             f"in turns: the {layout} streams differ from the paged run's")
        m = engine.metrics
        lat = m.latency_stats()
        out[layout] = dict(
            prefill_tok_s=m.prefill_tokens_per_sec,
            decode_tok_s=m.decode_tokens_per_sec, wall_s=wall,
            ttft_p50_ms=lat["ttft_p50"] * 1e3,
            itl_p50_ms=lat["itl_p50"] * 1e3)
        del engine, done
        gc.collect()
        torch.cuda.empty_cache()
    log("[in-turns] warm drains of the same requests, streams equal: "
        + "; ".join(f"{k} prefill {v['prefill_tok_s']:.1f} tok/s, decode "
                    f"{v['decode_tok_s']:.1f} tok/s, ttft p50 "
                    f"{v['ttft_p50_ms']:.1f} ms, itl p50 "
                    f"{v['itl_p50_ms']:.2f} ms" for k, v in out.items()))
    return out


def eager_graphed_in_turns(model, params, prompts, streams, *, seed=0,
                           new_tokens=32, max_len=4096, chunk=128):
    """The same requests drained by eager and graphed engines in turns
    (eager, graphed, eager, graphed), paged and then unpaged, each on a
    fresh engine (graphs captured before the clock starts). Every drain
    must give ``streams`` (the paged run 1's), and each graphed drain the
    per-kernel launch counts of the eager drain before it."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.runtime import Request, ServeLoop

    digest = streams_digest(streams)
    out = {}
    for layout in ("paged", "unpaged"):
        runs = []
        for graphs in (False, True, False, True):
            mode = "graphed" if graphs else "eager"
            before = torch.cuda.memory_allocated()
            engine = ServeLoop(
                model, params, batch_slots=len(prompts), max_len=max_len,
                eos_token=-1, seed=seed, prefill_chunk=chunk,
                paged=layout == "paged", device=DEV, cuda_graphs=graphs,
            )
            graph = {}
            if graphs:
                engine.capture_graphs()
                graph = log_graphs(f"[graph] {layout} engine, turn "
                                   f"{len(runs) + 1}", engine)
            for i, p in enumerate(prompts):
                engine.submit(Request(uid=i, prompt=list(p),
                                      max_new_tokens=new_tokens))
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            done = engine.run_until_drained()
            sync()
            wall = time.perf_counter() - t0
            launches = dict(_build.launch_counts)
            need(streams_digest({r.uid: list(r.tokens_out) for r in done})
                 == digest, f"[eager-graphed] {layout} {mode} drain "
                 f"{len(runs) + 1}: streams differ from the paged run 1's")
            if graphs:
                need(launches == runs[-1]["launches"],
                     f"[eager-graphed] {layout} graphed launches "
                     f"{launches} differ from the eager drain's "
                     f"{runs[-1]['launches']}")
            m = engine.metrics
            lat = m.latency_stats()
            runs.append(dict(
                mode=mode, wall_s=wall,
                prefill_tok_s=m.prefill_tokens_per_sec,
                decode_tok_s=m.decode_tokens_per_sec,
                ttft_p50_ms=lat["ttft_p50"] * 1e3,
                ttft_p95_ms=lat["ttft_p95"] * 1e3,
                itl_p50_ms=lat["itl_p50"] * 1e3,
                itl_p95_ms=lat["itl_p95"] * 1e3,
                launches=launches, **graph))
            del engine, done
            gc.collect()
            torch.cuda.empty_cache()
            # the engine's cache and graphs go with it
            left = torch.cuda.memory_allocated() - before
            runs[-1]["left_mib"] = left / 2**20
            need(left < 256 * 2**20,
                 f"[eager-graphed] {layout} {mode} engine left "
                 f"{left / 2**20:.1f} MiB allocated after its release")
        kernels = SERVE_KERNELS if layout == "paged" else UNPAGED_KERNELS
        for name in kernels:
            need(runs[1]["launches"][name] > 0,
                 f"[eager-graphed] {name} never launched in the graphed "
                 f"{layout} drain")
        log(f"[eager-graphed] {layout}: streams of all four drains equal "
            f"the paged run 1's (sha1 {digest}); each graphed drain's "
            f"launches equal its eager twin's: " + ", ".join(
                f"{KERNELS[k]['id']} {runs[1]['launches'][k]}"
                for k in kernels))
        for r in runs:
            log(f"[eager-graphed] {layout} {r['mode']:7s}: prefill "
                f"{r['prefill_tok_s']:.1f} tok/s, decode "
                f"{r['decode_tok_s']:.1f} tok/s, ttft p50/p95 "
                f"{r['ttft_p50_ms']:.1f}/{r['ttft_p95_ms']:.1f} ms, itl "
                f"p50/p95 {r['itl_p50_ms']:.2f}/{r['itl_p95_ms']:.2f} ms, "
                f"wall {r['wall_s']:.2f} s; {r['left_mib']:.1f} MiB left "
                f"allocated once released")
        out[layout] = [{k: v for k, v in r.items() if k != "launches"}
                       for r in runs]
    return out


def _release(engine):
    """Drop an engine's cache and graphs before the next one."""
    import torch

    del engine
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()


#: layers whose ρ_eff the ``[telemetry]`` lines print (0–1 are dense)
RHO_LAYERS = (2, 3, 20, 39)


def telemetry_in_turns(model, params, prompts, streams, launches, *,
                       seed=0, new_tokens=32, max_len=4096, chunk=128):
    """Phase 4's requests through fresh paged graphed engines with
    ``Observability(device_telemetry=True)`` and without it, in turns
    (observed, plain, observed, plain): each drain must give phase 4's
    streams, each observed drain B1–B4's launches of phase 4's run 1.
    ρ_eff of decode and prefill, a few layers' ratios, ITL beside the
    decode-attributed ITL, decode tok/s and the graphs' memory of each."""
    from repro_torch.kernels import _build
    from repro_torch.observability import Observability
    from repro_torch.runtime import Request, ServeLoop

    digest = streams_digest(streams)
    runs = []
    for observed in (True, False, True, False):
        obs = Observability() if observed else None
        engine = ServeLoop(
            model, params, batch_slots=len(prompts), max_len=max_len,
            eos_token=-1, seed=seed, prefill_chunk=chunk,
            prefix_sharing=True, observability=obs, device=DEV,
        )
        label = "observed" if observed else "plain"
        need(all(s.telemetry == observed for s in engine.graphs),
             f"[telemetry] the {label} engine's graphed steps are not "
             f"its own variants")
        engine.capture_graphs()
        graph = log_graphs(f"[graph] {label} engine, turn {len(runs) + 1}",
                           engine)
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
        got = dict(_build.launch_counts)
        m = engine.metrics
        need(len(done) == len(prompts) and m.failed_requests == 0,
             f"[telemetry] {label}: not every request drained")
        need(streams_digest({r.uid: list(r.tokens_out) for r in done})
             == digest, f"[telemetry] {label} drain {len(runs) + 1}: "
             f"streams differ from phase 4's")
        for name in SERVE_KERNELS:
            need(got[name] == launches[name],
                 f"[telemetry] {label}: {KERNELS[name]['id']} launched "
                 f"{got[name]} times, phase 4's run 1 {launches[name]}")
        lat = m.latency_stats()
        run = dict(
            mode=label, wall_s=wall, decode_tok_s=m.decode_tokens_per_sec,
            prefill_tok_s=m.prefill_tokens_per_sec,
            itl_p50_ms=lat["itl_p50"] * 1e3, itl_p95_ms=lat["itl_p95"] * 1e3,
            itl_decode_p50_ms=lat["itl_decode_p50"] * 1e3,
            itl_decode_p95_ms=lat["itl_decode_p95"] * 1e3, **graph)
        if observed:
            sp = obs.sparsity.snapshot()
            need(sp["decode"]["dispatches"] == m.decode_dispatches
                 and sp["prefill"]["dispatches"] == m.prefill_dispatches,
                 "[telemetry] not every dispatch recorded its stats")
            for phase in ("decode", "prefill"):
                rho = sp[phase]["rho_eff"]
                need(rho is not None and 0.0 < rho <= 1.0,
                     f"[telemetry] {phase} rho_eff {rho}")
                layers = sp[phase]["rho_eff_per_layer"]
                run[f"rho_eff_{phase}"] = rho
                run[f"rho_eff_{phase}_layers"] = {
                    i: layers[i] for i in RHO_LAYERS if i < len(layers)}
                run[f"{phase}_blocks"] = sp[phase]["blocks"]
            run["pinned_fraction_decode"] = sp["decode"]["pinned_fraction"]
            run["fill_fraction_decode"] = sp["decode"]["fill_fraction"]
        runs.append(run)
        _release(engine)
    for r in runs:
        rho = (f"; rho_eff decode {r['rho_eff_decode']:.4f} (layers "
               + ", ".join(f"{i}: {v:.4f}" for i, v in
                           r["rho_eff_decode_layers"].items())
               + f"), prefill {r['rho_eff_prefill']:.4f} (layers "
               + ", ".join(f"{i}: {v:.4f}" for i, v in
                           r["rho_eff_prefill_layers"].items())
               + f"), decode pinned {r['pinned_fraction_decode']:.4f} / "
               f"fill {r['fill_fraction_decode']:.4f}"
               if r["mode"] == "observed" else "")
        log(f"[telemetry] {r['mode']:8s}: decode {r['decode_tok_s']:.1f} "
            f"tok/s, prefill {r['prefill_tok_s']:.1f} tok/s, itl p50/p95 "
            f"{r['itl_p50_ms']:.2f}/{r['itl_p95_ms']:.2f} ms, itl_decode "
            f"p50/p95 {r['itl_decode_p50_ms']:.2f}/"
            f"{r['itl_decode_p95_ms']:.2f} ms, graphs "
            f"{r['graph_gib']:.2f} GiB{rho}")
    log(f"[telemetry] streams of all four drains equal phase 4's (sha1 "
        f"{digest}); B1–B4 launches of each equal phase 4's run 1: "
        + ", ".join(f"{KERNELS[k]['id']} {launches[k]}"
                    for k in SERVE_KERNELS))
    return runs


#: the ``[chaos]`` phase's schedule: every fault site fires under this
#: seed at phase 4's shapes, and the storm evicts two decoding requests,
#: one of which survives by replaying its decode steps (the engine's
#: decisions there depend only on the shapes and the injector, never on
#: the tokens, since no token is an EOS: a CPU rehearsal with a one-layer
#: model draws the same schedule)
CHAOS_SEED = 11
CHAOS_SPEC = dict(
    alloc_failure=0.1, step_exception=0.05, step_exception_burst=2,
    nan_logits=0.006, nan_prefill=0.2, delay=0.05, delay_seconds=0.005,
    preempt_storm=0.03, preempt_storm_size=2,
)
#: the request cancelled mid-prefill, and the tick it is cancelled at
CHAOS_CANCEL = (3, 4)


def chaos_drain(model, params, prompts, streams, *, seed=0, new_tokens=32,
                max_len=4096, chunk=128):
    """Phase 4's requests under a seeded fault schedule (step faults,
    allocation denials, preempt storms, decode and prefill poison, step
    delays), one request cancelled mid-prefill, the allocator audited
    every tick, on a fresh paged graphed engine with observability:
    every survivor streams phase 4's tokens for its uid, the poisoned
    requests end ``failed``, the cancelled one ``cancelled``; retries
    happened, the pool ends with every page free or cached, the Chrome
    trace validates and the metrics JSON parses."""
    import tempfile

    from repro_torch.observability import Observability, validate_chrome_trace
    from repro_torch.runtime import FaultInjector, FaultSpec, Request, ServeLoop

    inj = FaultInjector(seed=CHAOS_SEED, spec=FaultSpec(**CHAOS_SPEC))
    obs = Observability()
    engine = ServeLoop(
        model, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, seed=seed, prefill_chunk=chunk, prefix_sharing=True,
        fault_injector=inj, audit=True, observability=obs, device=DEV,
    )
    engine.capture_graphs()
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=list(p),
                              max_new_tokens=new_tokens))
    uid, at = CHAOS_CANCEL
    t0 = time.perf_counter()
    while engine.metrics.ticks < at:
        engine.tick()
    victim = next((r for r in engine.slots if r is not None and r.uid == uid),
                  None)
    need(victim is not None and victim.state == "prefill",
         f"[chaos] uid {uid} is not mid-prefill at tick {at}")
    need(engine.cancel(uid), f"[chaos] cancel({uid}) refused")
    done = engine.run_until_drained()
    sync()
    wall = time.perf_counter() - t0
    m = engine.metrics
    states = {r.uid: r.state for r in done + engine.terminated}
    need(sorted(states) == list(range(len(prompts))),
         f"[chaos] lost requests: {sorted(states)}")
    need(states[uid] == "cancelled", f"[chaos] uid {uid} ended "
         f"{states[uid]}, not cancelled")
    failed = sorted(r.uid for r in engine.terminated if r.state == "failed")
    need(all(r.error == "non-finite logits" for r in engine.terminated
             if r.state == "failed"), "[chaos] a failure not from poison")
    need(len(failed) == m.failed_requests
         == inj.counts["nan_logits"] + inj.counts["nan_prefill"],
         f"[chaos] failed {failed} against poison {inj.counts}")
    need(set(states.values()) <= {"done", "failed", "cancelled"},
         f"[chaos] terminal states {states}")
    for r in done:
        need(list(r.tokens_out) == streams[r.uid],
             f"[chaos] survivor uid {r.uid} diverged from phase 4's stream")
    for site in ("alloc_failure", "step_exception", "nan_logits",
                 "nan_prefill", "delay", "preempt_storm"):
        need(inj.counts[site] > 0, f"[chaos] site {site} never fired")
    need(m.retries == inj.counts["step_exception"] > 0,
         f"[chaos] {m.retries} retries for {inj.counts['step_exception']} "
         f"step faults")
    alloc = engine.allocator
    need(alloc.pages_in_use == 0
         and alloc.free_pages == engine.layout.num_pages,
         f"[chaos] pool not home: {alloc.pages_in_use} pages in use, "
         f"{alloc.free_pages} of {engine.layout.num_pages} free or cached")
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        metrics_path = os.path.join(tmp, "metrics.json")
        obs.export_chrome_trace(trace_path)
        obs.registry.write_json(metrics_path)
        with open(trace_path) as f:
            doc = json.load(f)
        validate_chrome_trace(doc)
        with open(metrics_path) as f:
            snap = json.load(f)
    need(snap["serve_retries"]["value"] == m.retries
         and snap["serve_ticks"]["value"] == m.ticks,
         "[chaos] the metrics JSON disagrees with the engine")
    out = dict(
        wall_s=wall, ticks=m.ticks, survivors=len(done), failed=failed,
        cancelled=[uid], counts=dict(inj.counts), retries=m.retries,
        preemptions=m.preemptions, stragglers=m.stragglers,
        trace_events=len(doc["traceEvents"]),
        rho_eff_decode=obs.sparsity.rho_eff_decode,
    )
    log(f"[chaos] seed {CHAOS_SEED}: {len(done)} survivors stream phase "
        f"4's tokens, failed (poisoned) {failed}, cancelled mid-prefill "
        f"[{uid}]; injected {json.dumps(out['counts'])}; {m.retries} "
        f"retries, {m.preemptions} preemptions, {m.stragglers} stragglers, "
        f"{m.ticks} ticks audited, wall {wall:.2f} s; pool home "
        f"({alloc.cached_pages} cached); trace of {out['trace_events']} "
        f"events validates, metrics JSON parses")
    log(f"[chaos] {m.summary()}")
    _release(engine)
    return out


def captured_contiguous_case(engine, captured, layer):
    """Layer ``layer``'s queries of the last prefill wave and decode step
    over its live contiguous cache after the drain (rows the decode
    steps appended lie past every captured query's position)."""
    import torch

    e = engine.model.cfg.energon
    cache = {k: v[layer] for k, v in engine.cache.items()}
    batch, heads, n_k, d = cache["k"].shape
    bh = batch * heads
    q_pre, qpos = captured["prefill"]
    q_dec, cl = captured["decode"]
    dt = cache["k"].dtype
    return ContiguousCase(
        q_dec=q_dec.reshape(bh, -1, d).to(dt).contiguous(),
        cl=cl.to(torch.int32).repeat_interleave(heads),
        q_pre=q_pre.reshape(bh, -1, d).to(dt).contiguous(),
        qpos=qpos.to(torch.int32).repeat_interleave(heads, dim=0),
        k=cache["k"].reshape(bh, n_k, d), v=cache["v"].reshape(bh, n_k, d),
        codes=cache["k_codes"].reshape(bh, n_k, d),
        scale=cache["k_scale"].reshape(bh, -1), bk=e.decode_key_block,
        pk=e.key_block, bq=e.query_block, ratio=e.pruning_ratio,
    )


def random_full_sequence(gen, *, bh=160, n=2048, d=128):
    """bf16 q/k/v ``[bh, n, d]`` at the scoring path's shapes (4
    sequences × 40 heads of 2048 tokens)."""
    import torch

    return [torch.randn((bh, n, d), generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(3)]


def small_scoring_check():
    """Serve-smoke model in bf16 with impl="pallas" on the card:
    ``LMModel.apply`` logits through B9 + B10 vs the same model with the
    plain versions swapped in (layer 2, the one sparse layer, selects
    bit-exactly, so the logits differ by B10's rounding alone)."""
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import mpmrf_filter as fk
    from repro_torch.models import LMModel

    cfg = dataclasses.replace(get_serve_config("qwen3-14b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=2)
    gen = torch.Generator(device=DEV).manual_seed(4)
    batch = {"inputs": torch.randint(1, cfg.vocab_size - 1, (2, 128),
                                     generator=gen, device=DEV)}
    fast = model.apply(params, batch)[0]
    swaps = [(fk, "mpmrf_filter_scores"), (bsa, "block_sparse_attention")]
    saved = [(m, n, getattr(m, n)) for m, n in swaps]
    try:
        for m, n in swaps:
            setattr(m, n, getattr(m, n + "_plain"))
        plain = model.apply(params, batch)[0]
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    need(bool(torch.isfinite(fast).all()), "small scoring: non-finite logits")
    diff = fast - plain
    rel = (diff.norm() / plain.norm()).item()
    log(f"[small-score] serve-smoke bf16 apply logits [2, 128, "
        f"{cfg.vocab_size}], kernels vs plain versions: max |err| "
        f"{diff.abs().max().item():.3e}, ‖err‖/‖ref‖ {rel:.3e} (rms "
        f"{plain.pow(2).mean().sqrt().item():.3e})")
    need(rel <= SMALL_REL_TOL,
         f"small scoring logits differ by {rel:.3e} of their norm")


def score_full_width(model, params, *, n_seq=4, seq_len=2048, seed=5,
                     label="score", profile=True):
    """``LMModel.loss`` over ``n_seq`` random sequences at full width, the
    launch counts zeroed just before and read just after (B9 and B10 once
    per layer on the fused kernels, the rest never); then ``apply`` for
    the logits. Returns the results and the q/k/v (``[B·H, n, d]``) that
    the first such layer handed to the kernels (None if none did)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1,
                                        size=(n_seq, seq_len + 1)),
                           device=DEV)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.uses_embeddings_input:
        # a vlm / audio model scores its frontend stub's embeddings
        from repro_torch.models.multimodal import frontend_embeddings

        batch["embeddings"] = frontend_embeddings(
            cfg.frontend, n_seq, seq_len, cfg.d_model, model.dtype,
            device=DEV)
    captured = {}
    real_bsa = ops.block_sparse_attention

    def capture(q, k, v, *args, **kw):
        captured.setdefault("qkv", (q, k, v))
        return real_bsa(q, k, v, *args, **kw)

    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.block_sparse_attention = capture
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, batch)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        ops.block_sparse_attention = real_bsa
    peak = mem_gb(torch.cuda.max_memory_allocated)
    _, sparse_layers, _ = layer_paths(model)
    tokens = n_seq * seq_len
    what = "stub embeddings" if "embeddings" in batch else "tokens"
    log(f"[{label}] {cfg.name} LMModel.loss over {n_seq} × {seq_len} "
        f"{what} ({cfg.num_layers} layers, impl {cfg.energon.impl!r}): loss "
        f"{float(loss):.4f} (exactly {float(loss)!r}; ce "
        f"{float(metrics['ce'])!r}, aux {float(metrics['aux'])!r}) in "
        f"{wall:.3f} s ({tokens / wall:.1f} tok/s), "
        f"peak device memory {peak} GB")
    log(f"[{label}] kernel launches: {json.dumps(launches)}")
    need(bool(torch.isfinite(loss)), f"non-finite loss {float(loss)}")
    for name in ("mpmrf_filter_scores", "block_sparse_attention"):
        need(launches[name] == sparse_layers,
             f"{name} launched {launches[name]} times in scoring, not "
             f"{sparse_layers} (the layers on the fused kernels)")
    for name in SERVE_KERNELS + UNPAGED_KERNELS + ("flash_attention",):
        need(launches[name] == 0, f"{name} launched in scoring")
    need(float(metrics["tokens"]) == tokens, "loss counted the wrong tokens")

    t0 = time.perf_counter()
    logits, _ = model.apply(params, batch)
    sync()
    apply_wall = time.perf_counter() - t0
    need(tuple(logits.shape) == (n_seq, seq_len, cfg.vocab_size),
         f"logits shape {tuple(logits.shape)}")
    need(bool(torch.isfinite(logits).all()), "non-finite logits")
    log(f"[{label}] LMModel.apply: logits {tuple(logits.shape)} f32, all "
        f"finite, in {apply_wall:.3f} s (rms "
        f"{logits.pow(2).mean().sqrt().item():.3f})")
    del logits
    out = dict(loss=float(loss), ce=float(metrics["ce"]),
               aux=float(metrics["aux"]), wall_s=wall, tok_s=tokens / wall,
               apply_wall_s=apply_wall, tokens=tokens, peak_memory_gb=peak,
               launches=launches)
    if DEV == "cuda" and profile:
        out["profile"] = profile_scoring(
            model, params, batch,
            "profile-score" if label == "score" else f"profile-{label}")
    return out, captured.get("qkv")


def profile_scoring(model, params, batch, label="profile-score"):
    """One more ``LMModel.loss`` under ``torch.profiler``: device time by
    kernel and the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        model.loss(params, batch)
        sync()
        wall = time.perf_counter() - t0
    out = dict(wall_s=wall, **device_split(prof, wall, top=15))
    log(f"[{label}] LMModel.loss: wall {wall:.3f} s, device busy "
        f"{out['device_busy_s']:.3f} s, idle {out['idle_share']:.1%} "
        f"(under the profiler)")
    for r in out["top"]:
        log(f"[{label}] {r['device_ms']:10.2f} ms  x{r['calls']:<6d} "
            f"{r['name']}")
    log(f"[{label}] the port's kernels: " + ", ".join(
        f"{k} {r['device_ms']:.2f} ms over {r['calls']} calls"
        for k, r in out["port"].items()))
    return out


def time_sparse_pair(q, k, v, *, bq, bk, ratio, layer):
    """The sparse pair (B9 + selection + B10) against B11 on the same
    operands: a measurement to write down, not a claimed speedup."""
    from repro_torch.kernels import ops

    budget = max(1, math.ceil(k.shape[1] // bk / ratio))
    pair = lambda: ops.block_sparse_attention(
        q, k, v, *ops.mpmrf_select_blocks(
            q, k, block_budget=budget, query_block=bq, key_block=bk),
        query_block=bq, key_block=bk)
    dense = lambda: ops.flash_attention(q, k, v)
    out = dict(sparse_pair_ms=time_ms(pair, iters=10),
               flash_ms=time_ms(dense, iters=10))
    log(f"[pair:captured] B9 + selection + B10 {out['sparse_pair_ms']:.4f} "
        f"ms vs B11 {out['flash_ms']:.4f} ms on layer {layer}'s operands")
    return out


def grad_check(*, bh=8, n=512, d=128, bq=128, bk=64, budget=2):
    """``ops.energon_block_attention`` forward and backward on the card:
    the forward equals the mpmrf_select_blocks + block_sparse_attention
    composition, and the gradients equal autograd through the plain
    block-sparse attention with that selection (the backward's own
    recipe, run a second time: its index backward sums with atomics, so
    bf16 grads are held to torch's bf16 tolerance)."""
    import torch

    from repro_torch.kernels import block_sparse_attention as bsa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEV).manual_seed(6)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=DEV).to(
        torch.bfloat16).requires_grad_() for _ in range(3))
    out = ops.energon_block_attention(q, k, v, budget, bq, bk, True)
    kw = dict(query_block=bq, key_block=bk)
    idx, val = ops.mpmrf_select_blocks(q.detach(), k.detach(),
                                       block_budget=budget, **kw)
    want = ops.block_sparse_attention(q.detach(), k.detach(), v.detach(),
                                      idx, val, **kw)
    need(torch.equal(out.detach(), want),
         "energon_block_attention forward differs from its composition")
    g = torch.randn(out.shape, generator=gen, device=DEV).to(out.dtype)
    grads = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(
        bsa.block_sparse_attention_plain(q, k, v, idx, val, **kw),
        (q, k, v), g)
    errs = []
    for name, a, b in zip("qkv", grads, ref):
        need(bool(torch.isfinite(a).all()), f"non-finite d{name}")
        try:
            torch.testing.assert_close(a, b)
        except AssertionError as exc:
            raise SmokeFailure(f"d{name} differs: {exc}") from None
        errs.append((a.float() - b.float()).abs().max().item())
    log(f"[grad] energon_block_attention [{bh}, {n}, {d}] bf16, budget "
        f"{budget}: forward equal to its composition; dq/dk/dv vs autograd "
        f"through the plain version max |err| "
        + " / ".join(f"{e:.3e}" for e in errs))


# ---------------------------------------------------------------------------
# the rest of the attention dispatch: long scoring, the XLA paths
# ---------------------------------------------------------------------------


def _with_impl(model, impl):
    """The same model object's weights under another ``impl`` (an
    ``LMModel`` holds only its config and device)."""
    from repro_torch.models import LMModel

    cfg = model.cfg
    return LMModel(dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, impl=impl)), device=DEV)


def score_long(model, params, *, n_seq=2, seq_len=8192, seed=8,
               label="score-long"):
    """``[score-long]``: ``LMModel.loss`` over ``n_seq`` × ``seq_len``
    random tokens with impl "pallas", past ``chunk_threshold``, so every
    layer takes the chunked path's kernel route: B11 on the dense prefix,
    B9 → selection → B10 on the sparse layers. Launch counts zeroed just
    before and read just after. Returns the results and the q/k/v that
    layer 2 handed the kernels."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    cfg = model.cfg
    e = cfg.energon
    need(seq_len * seq_len > e.chunk_threshold,
         f"{seq_len} tokens do not pass chunk_threshold {e.chunk_threshold}")
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1,
                                        size=(n_seq, seq_len + 1)),
                           device=DEV)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    captured = {}
    real = ops.chunked_block_attention

    def capture(q, k, v, **kw):
        captured.setdefault("qkv", (q, k, v))
        return real(q, k, v, **kw)

    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync()
    ops.chunked_block_attention = capture
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, batch)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        ops.chunked_block_attention = real
    peak = mem_gb(torch.cuda.max_memory_allocated)
    tokens = n_seq * seq_len
    prefix, sparse = e.min_prune_layer, cfg.num_layers - e.min_prune_layer
    log(f"[{label}] {cfg.name} LMModel.loss over {n_seq} × {seq_len} "
        f"tokens (n_q·n_k {seq_len * seq_len} > chunk_threshold "
        f"{e.chunk_threshold}: the chunked path; impl {e.impl!r}): loss "
        f"{float(loss):.4f} (exactly {float(loss)!r}) in {wall:.3f} s "
        f"({tokens / wall:.1f} tok/s), peak device memory {peak} GB")
    log(f"[{label}] kernel launches: {json.dumps(launches)}")
    need(bool(torch.isfinite(loss)), f"non-finite long loss {float(loss)}")
    need(float(metrics["tokens"]) == tokens, "loss counted the wrong tokens")
    want = {"flash_attention": prefix, "mpmrf_filter_scores": sparse,
            "block_sparse_attention": sparse}
    for name in KERNELS:
        need(launches[name] == want.get(name, 0),
             f"{name} launched {launches[name]} times in the long score, "
             f"not {want.get(name, 0)}")
    t0 = time.perf_counter()
    logits, _ = model.apply(params, batch)
    sync()
    apply_wall = time.perf_counter() - t0
    need(tuple(logits.shape) == (n_seq, seq_len, cfg.vocab_size),
         f"long logits shape {tuple(logits.shape)}")
    need(bool(torch.isfinite(logits).all()), "non-finite long logits")
    log(f"[{label}] LMModel.apply: logits {tuple(logits.shape)} f32, all "
        f"finite, in {apply_wall:.3f} s")
    del logits
    out = dict(loss=float(loss), wall_s=wall, tok_s=tokens / wall,
               apply_wall_s=apply_wall, tokens=tokens, peak_memory_gb=peak,
               launches=launches)
    if DEV == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        out["profile"] = profile_scoring(model, params, batch,
                                         label=f"profile-{label}")
    return out, captured["qkv"]


def long_route_vs_scan(q, k, v, *, bq, bk, ratio, layer,
                       label="score-long"):
    """On layer ``layer``'s operands of the long score: the kernel route
    (``ops.chunked_block_attention``) against the torch scan
    (``energon_block_attention_chunked``): survivor tables bit-equal,
    outputs within the gather tolerance, both timed."""
    import torch

    from repro_torch.core import chunked_attention as chk
    from repro_torch.kernels import gather_within_tolerance
    from repro_torch.kernels import ops

    kw = dict(pruning_ratio=ratio, query_block=bq, key_block=bk)
    out = ops.chunked_block_attention(q, k, v, **kw)
    ref = chk.energon_block_attention_chunked(q[None], k[None], v[None],
                                              **kw)[0]
    # the two routes' survivor tables: B9's selection (keep_all at
    # ρ ≤ 1) and the scan's
    sel = dict(block_budget=max(1, math.ceil(k.shape[1] // bk / ratio)),
               query_block=bq, key_block=bk, keep_all=ratio <= 1.0)
    idx, val = ops.mpmrf_select_blocks(q, k, **sel)
    ridx, rval = chk.select_blocks_from_scores(
        *chk.mpmrf_block_scores_chunked(q[None], k[None], (2, 4),
                                        query_block=bq, key_block=bk),
        alphas=(0.0, 0.0), **sel)
    sync()
    need(torch.equal(idx, ridx[0]) and torch.equal(val, rval[0]),
         f"[{label}] layer {layer}: the kernel route's survivor table "
         f"differs from the torch scan's")
    err = (out.float() - ref.float()).abs().max().item()
    need(gather_within_tolerance(out.float(), ref.float()),
         f"[{label}] layer {layer}: kernel route off the scan by "
         f"{err:.3e}")
    route_ms = time_ms(lambda: ops.chunked_block_attention(q, k, v, **kw),
                       iters=5)
    scan_ms = time_ms(lambda: chk.energon_block_attention_chunked(
        q[None], k[None], v[None], **kw), iters=2, warmup=1)
    log(f"[{label}] layer {layer} operands {tuple(q.shape)}: kernel route "
        f"(B9 + selection + B10) ≡ torch scan — survivor tables bit-equal "
        f"({int(val.sum())} survivor tiles), outputs max |err| {err:.3e} "
        f"within the gather tolerance; kernel route {route_ms:.3f} ms, "
        f"scan {scan_ms:.3f} ms")
    return dict(err=err, route_ms=route_ms, scan_ms=scan_ms,
                survivor_tiles=int(val.sum()))


def xla_full(model, params, score_loss, *, n_seq=2, seq_len=2048, seed=9):
    """``[xla-full]``: ``LMModel.loss`` over ``n_seq`` × ``seq_len`` tokens
    with impl "mpmrf_block" (the direct XLA block path, no kernel); on
    layer 2's q/k ``mpmrf_block_select``'s survivor table against
    ``ops.mpmrf_select_blocks``' (B9) bit for bit."""
    import numpy as np
    import torch

    from repro_torch.core import filtering as flt
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    xmodel = _with_impl(model, "mpmrf_block")
    cfg = xmodel.cfg
    e = cfg.energon
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1,
                                        size=(n_seq, seq_len + 1)),
                           device=DEV)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    captured = {}
    real = flt.mpmrf_block_select

    def capture(q, k, *a, **kw):
        res = real(q, k, *a, **kw)
        captured.setdefault("sel", (q, k, res))
        return res

    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    flt.mpmrf_block_select = capture
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = xmodel.loss(params, batch)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        flt.mpmrf_block_select = real
    peak = mem_gb(torch.cuda.max_memory_allocated)
    tokens = n_seq * seq_len
    log(f"[xla-full] {cfg.name} LMModel.loss over {n_seq} × {seq_len} "
        f"tokens, impl 'mpmrf_block' (the XLA block path): loss "
        f"{float(loss):.4f} (exactly {float(loss)!r}) in {wall:.3f} s "
        f"({tokens / wall:.1f} tok/s), peak device memory {peak} GB; "
        f"phase 12's pallas loss over 4 × 2048 tokens {score_loss!r}")
    need(bool(torch.isfinite(loss)), f"non-finite XLA loss {float(loss)}")
    need(sum(launches.values()) == 0,
         f"[xla-full] kernels launched on the XLA path: {launches}")
    q, k, res = captured["sel"]
    batch_, heads, n, d = q.shape
    n_kb = n // e.key_block
    idx, val = ops.mpmrf_select_blocks(
        q.reshape(-1, n, d), k.reshape(-1, n, d),
        round_bits=e.round_bits, alphas=e.alphas,
        block_budget=max(1, math.ceil(n_kb / e.pruning_ratio)),
        query_block=e.query_block, key_block=e.key_block,
        keep_first=e.keep_first, keep_diagonal=e.keep_diagonal)
    sync()
    xi = res.block_indices.reshape(idx.shape)
    xv = res.block_valid.reshape(val.shape)
    same = torch.equal(idx, xi) and torch.equal(val, xv)
    diff = int((idx != xi).sum()) + int((val != xv).sum())
    log(f"[xla-full] layer {e.min_prune_layer}: mpmrf_block_select's survivor "
        f"table {tuple(xi.shape)} vs ops.mpmrf_select_blocks (B9): "
        f"{'bit-equal' if same else f'{diff} entries differ'}; kernel "
        f"launches 0")
    need(same, "[xla-full] the XLA selection differs from B9's")
    return dict(loss=float(loss), wall_s=wall, tok_s=tokens / wall,
                peak_memory_gb=peak, tables_equal=same)


def _fused_and_xla_tables(layer_cache, *, q_pre, t_pre, qpos, q_dec, t_dec,
                          cl, energon):
    """Survivor tables of the fused kernels (impl "pallas") and of the XLA
    paths (impl "mpmrf_block") on one layer's live pool: the decode and
    prefill tables each handed to its gather."""
    import importlib

    from repro_torch.core import sparse_attention as spa
    from repro_torch.kernels import mpmrf_decode as dk
    from repro_torch.kernels import mpmrf_prefill as pk

    ea = importlib.import_module("repro_torch.core.energon_attention")
    seen = {}
    hooks = [(dk, "paged_decode_gather_attention", "dec-fused", 3, 4),
             (spa, "paged_decode_block_gather_attention", "dec-xla", 3, 4),
             (pk, "paged_prefill_gather_attention", "pre-fused", 4, 5),
             (spa, "block_gather_attention", "pre-xla", 3, "block_valid")]
    saved = [(m, name, getattr(m, name)) for m, name, *_ in hooks]

    def hooked(real, key, i, j):
        def fn(*a, **kw):
            seen[key] = (a[i], kw[j] if isinstance(j, str) else a[j])
            return real(*a, **kw)
        return fn

    try:
        for m, name, key, i, j in hooks:
            setattr(m, name, hooked(getattr(m, name), key, i, j))
        for impl in ("pallas", "mpmrf_block"):
            cfg = dataclasses.replace(energon, impl=impl)
            ea.energon_paged_decode_attention(q_dec, layer_cache, t_dec, cl,
                                              cfg)
            ea.energon_paged_prefill_attention(q_pre, layer_cache, t_pre,
                                               qpos, cfg)
    finally:
        for m, name, real in saved:
            setattr(m, name, real)
    return seen


def profile_prefill_wave(engine, system, *, seed=3, n_req=8,
                         prompt_len=512):
    """The first tick after ``n_req`` fresh prompts arrive — their first
    prefill wave, no slot decoding — under ``torch.profiler``: wall and
    device time, idle share and the largest items
    (``[profile-prefill-xla]``); then the drain, unprofiled."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import Request

    vocab = engine.model.cfg.vocab_size
    rng = np.random.default_rng(seed)
    for i in range(n_req):
        body = rng.integers(1, vocab - 1, size=prompt_len - len(system))
        engine.submit(Request(uid=3000 + i, prompt=system + body.tolist(),
                              max_new_tokens=1))
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        engine.tick()
        sync()
        wall = time.perf_counter() - t0
    engine.run_until_drained()
    split = device_split(prof, wall, top=8)
    out = dict(wall_ms=wall * 1e3, device_ms=split["device_busy_s"] * 1e3,
               idle_share=split["idle_share"], kernels=split["kernels"],
               top=split["top"])
    log(f"[profile-prefill-xla] one prefill wave of {n_req} slots × "
        f"{engine.prefill_chunk} tokens: {out['wall_ms']:.1f} ms, device "
        f"busy {out['device_ms']:.1f} ms, idle {out['idle_share']:.1%}, "
        f"{out['kernels']} device kernels and copies (under the profiler)")
    for r in out["top"]:
        log(f"[profile-prefill-xla] {r['device_ms']:9.2f} ms  "
            f"x{r['calls']:<6d} {r['name']}")
    return out


def xla_serve(model, params, prompts, streams, *, seed=0, new_tokens=32,
              max_len=4096, chunk=128):
    """``[xla-serve]``: phase 4's requests through a fresh graphed paged
    ``ServeLoop`` built with the reference's default impl "mpmrf_block":
    every request drains, none quarantined, no kernel launched; streams
    recorded beside phase 4's (P rounds to bf16 on this path, so they may
    part); then on layer 2's live operands of the last prefill wave and
    decode step the XLA selections against the fused kernels' tables."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import attention as attn
    from repro_torch.runtime import Request, ServeLoop

    xmodel = _with_impl(model, "mpmrf_block")
    cfg = xmodel.cfg
    layer = cfg.energon.min_prune_layer
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    engine = ServeLoop(
        xmodel, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, seed=seed, prefill_chunk=chunk, prefix_sharing=True,
        device=DEV,
    )
    captured = {}
    real = {"prefill": attn.energon_paged_prefill_attention,
            "decode": attn.energon_paged_decode_attention}

    def capturing(kind):
        def fn(q, cache, table, pos, cfg, **kw):
            if kw.get("layer_index") == layer:
                captured[kind] = (q.clone(), table.clone(), pos.clone())
            return real[kind](q, cache, table, pos, cfg, **kw)
        return fn

    attn.energon_paged_prefill_attention = capturing("prefill")
    attn.energon_paged_decode_attention = capturing("decode")
    try:
        # captured with the patches in place: the graphs' copies of layer
        # 2's operands are refreshed by every replay
        engine.capture_graphs()
        graph = log_graphs("[graph] xla paged engine (impl mpmrf_block)",
                           engine)
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
    finally:
        attn.energon_paged_prefill_attention = real["prefill"]
        attn.energon_paged_decode_attention = real["decode"]
    m = engine.metrics
    lat = m.latency_stats()
    need(len(done) == len(prompts) and all(r.done for r in done)
         and all(len(r.tokens_out) == new_tokens for r in done),
         "[xla-serve] not every request drained")
    need(m.failed_requests == 0,
         f"[xla-serve] {m.failed_requests} requests quarantined")
    need(sum(launches.values()) == 0,
         f"[xla-serve] kernels launched on the XLA path: {launches}")
    got = {r.uid: list(r.tokens_out) for r in done}
    same = sum(a == b for u in streams for a, b in zip(got[u], streams[u]))
    total = sum(len(s) for s in streams.values())
    log(f"[xla-serve] {len(done)} requests drained in {wall:.2f} s; prefill "
        f"{m.prefill_tokens_per_sec:.1f} tok/s, decode "
        f"{m.decode_tokens_per_sec:.1f} tok/s, ttft p50 "
        f"{lat['ttft_p50'] * 1e3:.1f} ms, itl p50 "
        f"{lat['itl_p50'] * 1e3:.2f} ms; no kernel launched, none "
        f"quarantined; streams sha1 {streams_digest(got)}, {same} of "
        f"{total} tokens equal phase 4's (recorded: P rounds to bf16 on "
        f"this path)")
    # the live operands: the pool after the drain, layer 2's last inputs
    q_pre, t_pre, qpos = captured["prefill"]
    q_dec, t_dec, cl = captured["decode"]
    layer_cache = {k: v[layer] for k, v in engine.cache.items()}
    seen = _fused_and_xla_tables(layer_cache, q_pre=q_pre, t_pre=t_pre,
                                 qpos=qpos, q_dec=q_dec, t_dec=t_dec, cl=cl,
                                 energon=cfg.energon)
    sync()
    eq = {}
    for kind in ("dec", "pre"):
        (fi, fv), (xi, xv) = seen[f"{kind}-fused"], seen[f"{kind}-xla"]
        eq[kind] = (torch.equal(fi, xi.reshape(fi.shape))
                    and torch.equal(fv, xv.reshape(fv.shape)))
    prof = None
    if DEV == "cuda":
        system = prompts[0][:SYSTEM_LEN]
        prof = dict(prefill=profile_prefill_wave(engine, system),
                    decode=profile_decode(engine, system, prompt_len=512,
                                          ticks=4,
                                          label="profile-decode-xla"))
    log(f"[xla-serve] layer {layer}, live pool: XLA decode selection vs "
        f"B1's table {'bit-equal' if eq['dec'] else 'DIFFERENT'}; XLA "
        f"prefill selection vs B3's table "
        f"{'bit-equal' if eq['pre'] else 'DIFFERENT'}")
    need(all(eq.values()), f"[xla-serve] XLA ≠ fused survivor tables: {eq}")
    out = dict(wall_s=wall, prefill_tok_s=m.prefill_tokens_per_sec,
               decode_tok_s=m.decode_tokens_per_sec,
               ttft_p50_ms=lat["ttft_p50"] * 1e3,
               itl_p50_ms=lat["itl_p50"] * 1e3,
               streams_sha1=streams_digest(got), tokens_equal=same,
               tokens=total, profile=prof, **graph)
    del engine, done, layer_cache
    gc.collect()
    torch.cuda.empty_cache()
    out["left_mib"] = (torch.cuda.memory_allocated() - before) / 2**20
    return out


MESH_TP = 4              # [tp-serve]: a (1, 4) mesh of the one card
MESH_GRID = (2, 2)       # [mesh-serve]: two replicas, TP 2 each


def _sim_mesh(shape, axes=None):
    """A ``shape`` mesh whose every entry is the one card (the serve
    CLI's ``--simulate-devices``): ``(data, model)`` for two sizes,
    ``(pod, data, model)`` for three, else over ``axes``."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, [DEV] * math.prod(shape))


def _submit_all(engine, prompts, new_tokens, uid0=0, temps=None):
    from repro_torch.runtime import Request

    for i, p in enumerate(prompts):
        engine.submit(Request(uid=uid0 + i, prompt=list(p),
                              max_new_tokens=new_tokens,
                              temperature=0.0 if temps is None
                              else temps[i]))


def _mesh_launches(label, launches, model, decode_dispatches,
                   prefill_dispatches, shards):
    """B1–B4 launched once per fused layer, dispatch and head shard; the
    other kernels never."""
    _, fused, _ = layer_paths(model)
    per = {"mpmrf_paged_filter_scores": decode_dispatches,
           "paged_decode_gather_attention": decode_dispatches,
           "mpmrf_paged_prefill_filter_scores": prefill_dispatches,
           "paged_prefill_gather_attention": prefill_dispatches}
    for name, n_calls in per.items():
        need(n_calls > 0 and launches[name] == fused * n_calls * shards,
             f"[{label}] {name} launched {launches[name]} times, not "
             f"{fused} fused layers × {n_calls} dispatches × {shards} "
             f"shards")
    for name in UNPAGED_KERNELS + SCORE_KERNELS:
        need(launches[name] == 0, f"[{label}] {name} launched")


def tp_serve(model, params, prompts, streams, results, *, seed=0,
             new_tokens=32, max_len=4096, chunk=128):
    """``[tp-serve]``: phase 4's requests through a lone graphed paged
    ``ServeLoop`` (prefix sharing on) on a ``(1, 4)`` mesh of the one
    card: the pools are four head shards (2 KV heads each), B1–B4 launch
    four times a fused layer and dispatch at bh = B·KV/4, and the
    streams must be phase 4's. Then B1–B4 against their plain versions
    on shard 0's live pool of layer 2 (``[kernels:tp-shard0-…]``), and
    decode ticks under the profiler (``[profile-decode-tp]``)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.runtime import ServeLoop
    from repro_torch.runtime.paged_cache import attention_cache_shard_bytes

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    mesh = _sim_mesh((1, MESH_TP))
    engine = ServeLoop(
        model, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, seed=seed, prefill_chunk=chunk, prefix_sharing=True,
        device=DEV, mesh=mesh,
    )
    need(engine.cuda_graphs or DEV != "cuda",
         "[tp-serve] the engine does not replay graphs")
    need(isinstance(engine.cache["k"], tuple)
         and len(engine.cache["k"]) == MESH_TP,
         "[tp-serve] the pool is not split into head shards")
    shard_bytes = attention_cache_shard_bytes(engine.cache)
    engine.capture_graphs()
    graph = log_graphs(f"[graph] tp engine ({mesh}; "
                       f"{engine.graph_mode})", engine)
    _submit_all(engine, prompts, new_tokens)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    m = engine.metrics
    lat = m.latency_stats()
    got = {r.uid: list(r.tokens_out) for r in done}
    need(len(done) == len(prompts) and m.failed_requests == 0,
         "[tp-serve] not every request drained")
    need(got == streams, f"[tp-serve] streams sha1 {streams_digest(got)} "
         f"differ from phase 4's {streams_digest(streams)}")
    _mesh_launches("tp-serve", launches, model, m.decode_dispatches,
                   m.prefill_dispatches, MESH_TP)
    bh = len(prompts) * model.cfg.num_kv_heads // MESH_TP
    log(f"[tp-serve] {len(done)} requests on a (1, {MESH_TP}) mesh of "
        f"{DEV} in {wall:.2f} s; streams sha1 {streams_digest(got)} (= "
        f"phase 4's); prefill {m.prefill_tokens_per_sec:.1f} tok/s, decode "
        f"{m.decode_tokens_per_sec:.1f} tok/s, ttft p50 "
        f"{lat['ttft_p50'] * 1e3:.1f} ms, itl p50/p95 "
        f"{lat['itl_p50'] * 1e3:.2f}/{lat['itl_p95'] * 1e3:.2f} ms; pool "
        f"{MESH_TP} shards of {shard_bytes[0] / 2**30:.3f} GiB; peak device "
        f"memory {mem_gb(torch.cuda.max_memory_allocated)} GB")
    log(f"[tp-serve] launches (bh {bh} a shard): " + ", ".join(
        f"{KERNELS[k]['id']} {launches[k]}" for k in SERVE_KERNELS)
        + f" = fused layers × dispatches × {MESH_TP} shards")
    layer = model.cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer, shard=0),
               f"tp-shard0-layer{layer}", results)
    prof = None
    if DEV == "cuda":
        prof = profile_decode(engine, prompts[0][:SYSTEM_LEN],
                              label="profile-decode-tp")
    out = dict(profile_decode=prof,wall_s=wall, prefill_tok_s=m.prefill_tokens_per_sec,
               decode_tok_s=m.decode_tokens_per_sec,
               ttft_p50_ms=lat["ttft_p50"] * 1e3,
               itl_p50_ms=lat["itl_p50"] * 1e3,
               itl_p95_ms=lat["itl_p95"] * 1e3,
               shard_bytes=shard_bytes, bh_per_shard=bh,
               graph_mode=engine.graph_mode,
               launches={k: launches[k] for k in SERVE_KERNELS},
               streams_sha1=streams_digest(got), **graph)
    del engine, done
    gc.collect()
    torch.cuda.empty_cache()
    out["left_mib"] = (torch.cuda.memory_allocated() - before) / 2**20
    return out


def mixed_trace(vocab, *, seed=12, n_req=8, prompt_len=512, system_len=64):
    """The ``[mesh-serve]`` sampled trace: prompts on one shared system
    prompt, temperatures 0 / 0.8 / 1.0 in turn."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab - 1, size=system_len).tolist()
    prompts = [system + rng.integers(1, vocab - 1,
                                     size=prompt_len - system_len).tolist()
               for _ in range(n_req)]
    return prompts, [(0.0, 0.8, 1.0)[i % 3] for i in range(n_req)]


def mesh_serve(model, params, prompts, streams, *, seed=0, new_tokens=32,
               max_len=4096, chunk=128, mixed_len=512, mixed_tokens=16):
    """``[mesh-serve]``: a ``ReplicatedServeLoop`` on a ``(2, 2)`` mesh of
    the one card (two replicas of 8 slots, each TP 2): phase 4's requests
    give phase 4's streams; placement, merged tokens (the replicas' sum),
    merged peak pages (their max) and each replica's tok/s. Then a short
    mixed-temperature trace through the same replicas and through a
    single (eager) engine: the sampled streams must be equal."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.runtime import ReplicatedServeLoop, ServeLoop

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    kw = dict(batch_slots=len(prompts), max_len=max_len, eos_token=-1,
              prefill_chunk=chunk, prefix_sharing=True, device=DEV)
    loop = ReplicatedServeLoop(model, params, mesh=_sim_mesh(MESH_GRID),
                               seed=seed, **kw)
    loop.capture_graphs()
    graphs = [log_graphs(f"[graph] mesh replica {e.replica_id} "
                         f"({e.graph_mode})", e) for e in loop.engines]
    _submit_all(loop, prompts, new_tokens)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    done = loop.run_until_drained()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    got = {r.uid: list(r.tokens_out) for r in done}
    need(len(done) == len(prompts), "[mesh-serve] not every request drained")
    need(got == streams, f"[mesh-serve] streams sha1 {streams_digest(got)} "
         f"differ from phase 4's {streams_digest(streams)}")
    merged = loop.merged_metrics()
    per = [e.metrics for e in loop.engines]
    need(merged.decode_tokens == sum(p.decode_tokens for p in per)
         == len(prompts) * (new_tokens - 1),
         "[mesh-serve] merged decode tokens are not the replicas' sum")
    need(merged.peak_pages_in_use == max(p.peak_pages_in_use for p in per),
         "[mesh-serve] merged peak pages are not the replicas' max")
    _mesh_launches("mesh-serve", launches, model,
                   sum(p.decode_dispatches for p in per),
                   sum(p.prefill_dispatches for p in per), MESH_GRID[1])
    placement = [loop.placement[u] for u in sorted(loop.placement)]
    log(f"[mesh-serve] {len(done)} requests on a {MESH_GRID[0]}x"
        f"{MESH_GRID[1]} mesh of {DEV} in {wall:.2f} s; streams sha1 "
        f"{streams_digest(got)} (= phase 4's); placement (uid 0…"
        f"{len(prompts) - 1} → replica) {placement}; merged "
        f"{merged.prefill_tokens} prefill + {merged.decode_tokens} decode "
        f"tok, peak {merged.peak_pages_in_use} pages (max of "
        f"{[p.peak_pages_in_use for p in per]}); " + "; ".join(
            f"replica {r}: prefill {p.prefill_tokens_per_sec:.1f} tok/s, "
            f"decode {p.decode_tokens_per_sec:.1f} tok/s"
            for r, p in enumerate(per)))
    log("[mesh-serve] launches: " + ", ".join(
        f"{KERNELS[k]['id']} {launches[k]}" for k in SERVE_KERNELS)
        + f" = fused layers × dispatches × {MESH_GRID[1]} shards")
    out = dict(
        wall_s=wall, placement=placement,
        merged_prefill_tokens=merged.prefill_tokens,
        merged_decode_tokens=merged.decode_tokens,
        merged_peak_pages=merged.peak_pages_in_use,
        replica_peak_pages=[p.peak_pages_in_use for p in per],
        replica_prefill_tok_s=[p.prefill_tokens_per_sec for p in per],
        replica_decode_tok_s=[p.decode_tokens_per_sec for p in per],
        merged_prefill_tok_s=merged.prefill_tokens_per_sec,
        merged_decode_tok_s=merged.decode_tokens_per_sec,
        peak_memory_gb=mem_gb(torch.cuda.max_memory_allocated),
        launches={k: launches[k] for k in SERVE_KERNELS},
        graph_gib=sum(g["graph_gib"] for g in graphs),
        streams_sha1=streams_digest(got))
    mixed, temps = mixed_trace(model.cfg.vocab_size, prompt_len=mixed_len)
    _submit_all(loop, mixed, mixed_tokens, uid0=1000, temps=temps)
    loop.run_until_drained()
    sampled = {r.uid: list(r.tokens_out) for r in loop.completed
               if r.uid >= 1000}
    mixed_place = [loop.placement[1000 + i] for i in range(len(mixed))]
    out["mixed_placement"] = mixed_place
    del loop, done
    gc.collect()
    torch.cuda.empty_cache()
    single = ServeLoop(model, params, seed=seed, cuda_graphs=False, **kw)
    _submit_all(single, mixed, mixed_tokens, uid0=1000, temps=temps)
    ref = {r.uid: list(r.tokens_out) for r in single.run_until_drained()}
    need(sampled == ref and len(ref) == len(mixed),
         "[mesh-serve] the mixed-temperature streams of the (2, 2) mesh "
         "differ from the single engine's")
    log(f"[mesh-serve] mixed trace ({len(mixed)} × {len(mixed[0])} tokens, "
        f"temperatures {temps}, {mixed_tokens} tokens each): placement "
        f"{mixed_place}; sampled streams sha1 {streams_digest(sampled)} = "
        f"the single engine's")
    out["mixed_sha1"] = streams_digest(sampled)
    del single
    gc.collect()
    torch.cuda.empty_cache()
    out["left_mib"] = (torch.cuda.memory_allocated() - before) / 2**20
    return out


#: the sources of the tile-engine and filter-engine kernels, always
#: rebuilt so that nvcc's -Xptxas -v report covers every instantiation
#: the dense configs beside qwen3-14b: (arch, serve phase shapes, scoring
#: sequences). starcoder2-7b's max_len is 3584, not 4096: its dense
#: prefix layers mask [G·chunk, max_len] = [1152, max_len], within
#: chunk_threshold (2048²) only up to 3640 rows; gemma3-27b's prompts
#: outrun its window of 1024
DENSE_PHASES = (
    ("starcoder2-7b", dict(max_len=3584), dict(n_seq=4)),
    ("gemma3-27b", dict(n_req=4, prompt_len=1536, max_len=2048),
     dict(n_seq=1)),
)


def _free_device():
    gc.collect()
    if DEV == "cuda":
        import torch

        torch.cuda.empty_cache()


def dense_config_phases(results, blocks):
    """``[starcoder2-serve]`` / ``[starcoder2-score]`` and ``[gemma3-serve]``
    / ``[gemma3-score]``: each config at published widths (random bf16
    weights from seed 0) served through a graphed paged ``ServeLoop``
    (B1–B4 on its layers on the fused kernels, the windowed layers on the
    XLA paths), B1–B4 held against their plain versions on the live pool
    of its first layer on the fused kernels, decode ticks under the
    profiler (``[profile-decode-…]``), ``LMModel.loss`` (B9 / B10 on
    those layers) and B9–B11 held against their plain versions on the
    q/k/v that layer handed the kernels. Each model is released before
    the next is built. Returns each phase's results and launches."""
    from repro_torch.configs.registry import get_serve_config

    out = {}
    for arch, serve_kw, score_kw in DENSE_PHASES:
        short = arch.split("-")[0]
        engine, prompts, run1, launches, streams = serve_full_width(
            get_serve_config(arch), label=f"{short}-serve", **serve_kw)
        model, params = engine.model, engine.params
        prefix, fused, _ = layer_paths(model)
        windows = model.layer_windows() or [0] * model.cfg.num_layers
        layer = next(i for i in range(prefix, len(windows))
                     if windows[i] == 0)
        check_case(live_pool_case(engine, prompts, layer),
                   f"{short}-live-layer{layer}", results)
        run1.update(launches=launches, streams_sha1=streams_digest(streams))
        if DEV == "cuda":
            run1["profile_decode"] = profile_decode(
                engine, prompts[0][:SYSTEM_LEN],
                n_req=serve_kw.get("n_req", 8),
                prompt_len=serve_kw.get("prompt_len", 2048),
                label=f"profile-decode-{short}")
        del engine, prompts
        _free_device()
        scoring, (q, k, v) = score_full_width(
            model, params, label=f"{short}-score", **score_kw)
        scoring["captured"] = check_full_sequence(
            q, k, v, f"{short}-captured-layer{layer}", results, **blocks)
        out[f"{short}-serve"], out[f"{short}-score"] = run1, scoring
        del model, params, q, k, v
        _free_device()
    return out


#: head dims the phi3 phase's refusal check builds engines at: the
#: reference's test models' 8 and 192 (past 128)
REFUSED_HEAD_DIMS = (8, 192)


def phi3_phase(results, blocks):
    """``[phi3-…]``: phi3-mini-3.8b (head dim 96, MHA: G = 1, 32 layers)
    at published widths (random bf16 weights from seed 0) on the fused
    kernels, which run d 96 on their d-128 instantiation:

    * ``[phi3-serve]``: phase 4's requests (8 × 2048 tokens, 256 shared,
      32 greedy tokens, max_len 4096, chunk 128) through a graphed paged
      ``ServeLoop``: B1/B2 launched 30 times a decode step and B3/B4 30
      times a prefill wave (layers 2–31); B1–B4 held against their plain
      versions on layer 2's live pool and timed at d 96
      (``[kernels:phi3-live-layer2]``, ``[time:phi3-live-layer2]``);
      decode ticks under the profiler (``[profile-decode-phi3]``);
    * ``[phi3-unpaged]``: the same requests through
      ``ServeLoop(paged=False)`` (B5–B8), streams equal to the paged
      run's; B5–B8 held against their plain versions on layer 2's
      captured queries and live contiguous cache, timed, and against
      B1–B4 on the same rows laid out as pages (``[same-rows:…]``);
    * ``[phi3-xla]``: the same requests on the shipped ``mpmrf_block``
      (the XLA paths, no kernel), the fused runs' A/B partner: prefill
      tok/s and ITL side by side;
    * ``[phi3-score]``: ``LMModel.loss`` over 2 × 2048 tokens (B9 / B10,
      30 launches each), then B9–B11 on layer 2's q/k/v against their
      plain versions, timed at d 96 (``[full-seq:phi3-captured-layer2]``);
    * ``[phi3-score-long]``: ``loss`` over 1 × 4096 tokens, phi3-mini-4k's
      context, past ``chunk_threshold``: B11 on layers 0–1, B9 →
      selection → B10 on layers 2–31; on layer 2's operands the kernel
      route's survivor tables equal the torch scan's;
    * a ``ServeLoop`` at each of REFUSED_HEAD_DIMS refused at
      construction, naming the head dim, before any launch.

    Returns each run's results (with its launches) by phase name."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.runtime import ServeLoop

    cfg = registry.get_serve_config("phi3-mini-3.8b")
    need(cfg.energon.impl == "pallas" and cfg.head_dim == 96,
         "phi3-mini's serving config is not the fused path at head dim 96")
    out = {}
    engine, prompts, run1, launches, streams = serve_full_width(
        cfg, label="phi3-serve")
    model, params = engine.model, engine.params
    layer = cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer),
               f"phi3-live-layer{layer}", results)
    run1.update(launches=launches, streams_sha1=streams_digest(streams))
    if DEV == "cuda":
        run1["profile_decode"] = profile_decode(
            engine, prompts[0][:SYSTEM_LEN], label="profile-decode-phi3")
    out["phi3-serve"] = run1
    del engine
    _free_device()

    uengine, unpaged, ulaunches, captured = serve_unpaged(
        model, params, prompts, streams, label="phi3-unpaged")
    case = captured_contiguous_case(uengine, captured, layer)
    del uengine, captured
    _free_device()
    gen = torch.Generator(device=DEV).manual_seed(96)
    label = f"phi3-captured-layer{layer}"
    unpaged["same_rows"] = check_same_rows(
        case, check_contiguous(case, label, results), label, gen)
    out["phi3-unpaged"] = dict(unpaged, launches=ulaunches)
    del case
    _free_device()

    xla = dataclasses.replace(cfg, energon=dataclasses.replace(
        cfg.energon, impl="mpmrf_block"))
    xengine, _, xrun, xlaunches, _ = serve_full_width(xla, label="phi3-xla")
    need(sum(xlaunches.values()) == 0, "a kernel launched on mpmrf_block")
    del xengine
    _free_device()
    log(f"[phi3-xla] fused (pallas) / XLA (mpmrf_block) on the same "
        f"requests: prefill {run1['prefill_tok_s']:.1f} / "
        f"{xrun['prefill_tok_s']:.1f} tok/s, decode "
        f"{run1['decode_tok_s']:.1f} / {xrun['decode_tok_s']:.1f} tok/s, "
        f"ITL p50 {run1['itl_p50_ms']:.2f} / {xrun['itl_p50_ms']:.2f} ms")
    out["phi3-xla"] = dict(xrun, launches=xlaunches)

    scoring, (q, k, v) = score_full_width(model, params, n_seq=2,
                                          label="phi3-score")
    scoring["captured"] = check_full_sequence(
        q, k, v, f"phi3-captured-layer{layer}", results, **blocks)
    out["phi3-score"] = scoring
    del q, k, v
    _free_device()
    long, (q, k, v) = score_long(model, params, n_seq=1, seq_len=4096,
                                 label="phi3-score-long")
    long["route_vs_scan"] = long_route_vs_scan(
        q, k, v, layer=layer, label="phi3-score-long", **blocks)
    out["phi3-score-long"] = long
    del model, params, q, k, v
    _free_device()

    refused = {}
    for d in REFUSED_HEAD_DIMS:
        model = LMModel(dataclasses.replace(cfg, num_layers=2, head_dim=d),
                        device=DEV)
        params = model.init(seed=0)
        _build.reset_launch_counts()
        try:
            ServeLoop(model, params, batch_slots=8, max_len=4096,
                      prefill_chunk=128, eos_token=-1, device=DEV)
            refused[d] = None
        except ValueError as exc:
            refused[d] = str(exc)
        need(refused[d] is not None and f"head_dim {d} " in refused[d],
             f"a pallas engine at head dim {d} was not refused for it: "
             f"{refused[d]}")
        need(sum(_build.launch_counts.values()) == 0,
             "a kernel launched before the refusal")
        log(f"[phi3] a pallas ServeLoop at head dim {d} (2 layers) refused "
            f"at construction, no kernel launched: {refused[d]}")
        del model, params
        _free_device()
    out["phi3-refused"] = refused
    return out


#: the MoE phases' arch, and the probability gap below which a routed
#: row counts as a near-tie ([olmoe-moe-layer])
MOE_ARCH = "olmoe-1b-7b"
MOE_GAP = 1e-6


def olmoe_eager(model, params, prompts, streams, layer, *, seed=0,
                new_tokens=32, max_len=4096, chunk=128,
                label="olmoe-eager", mesh=None):
    """Phase 4's requests through an eager (``cuda_graphs=False``) paged
    engine on the MoE model (on ``mesh``, if given): the streams must be
    the graphed engine's. Layer ``layer``'s MoE inputs of the last
    prefill wave (every slot's last chunk: 8 × ``chunk`` distinct rows)
    and the last decode step are kept (bf16, ``[8, chunk, d]`` / ``[8, 1,
    d]``)."""
    import torch

    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime import Request, ServeLoop

    engine = ServeLoop(
        model, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, seed=seed, prefill_chunk=chunk, prefix_sharing=True,
        device=DEV, cuda_graphs=False, mesh=mesh,
    )
    router = params["blocks"]["moe"]["router"][layer]
    router0 = params["blocks"]["moe"]["router"][0]
    captured = {}
    real = moe_lib.apply_moe

    def spy(p, x, cfg, **kw):
        if p["router"].data_ptr() == router.data_ptr():
            captured["decode" if x.shape[1] == 1 else "prefill"] = x.clone()
        if (p["router"].data_ptr() == router0.data_ptr()
                and "first-wave-layer0" not in captured):
            captured["first-wave-layer0"] = x.clone()
        return real(p, x, cfg, **kw)

    moe_lib.apply_moe = spy
    try:
        for i, p in enumerate(prompts):
            engine.submit(Request(uid=i, prompt=list(p),
                                  max_new_tokens=new_tokens))
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        sync()
        wall = time.perf_counter() - t0
    finally:
        moe_lib.apply_moe = real
    m = engine.metrics
    lat = m.latency_stats()
    eager = {r.uid: list(r.tokens_out) for r in done}
    log(f"[{label}] eager engine: {len(done)} requests in {wall:.2f} s; "
        f"prefill {m.prefill_tokens_per_sec:.1f} tok/s, decode "
        f"{m.decode_tokens_per_sec:.1f} tok/s, itl p50/p95 "
        f"{lat['itl_p50'] * 1e3:.2f}/{lat['itl_p95'] * 1e3:.2f} ms; greedy "
        f"streams sha1 {streams_digest(eager)} (graphed "
        f"{streams_digest(streams)})")
    need(eager == streams, "the eager MoE engine's streams differ from the "
         "graphed engine's")
    need({"prefill", "decode"} <= set(captured),
         f"layer {layer}'s MoE inputs not captured: {sorted(captured)}")
    out = dict(prefill_tok_s=m.prefill_tokens_per_sec,
               decode_tok_s=m.decode_tokens_per_sec, wall_s=wall,
               itl_p50_ms=lat["itl_p50"] * 1e3,
               itl_p95_ms=lat["itl_p95"] * 1e3,
               streams_sha1=streams_digest(eager))
    del engine
    _free_device()
    return out, captured


def moe_layer_check(model, params, inputs, layer, label="olmoe-moe-layer"):
    """Layer ``layer``'s MoE (``models/moe.py::apply_moe``) on the
    captured bf16 inputs of a prefill wave (T = 1024) and a decode step
    (T = 8), on the card and on the CPU in f32 from the same bf16
    tensors: the top-k experts, positions and keep must be equal on
    every row whose consecutive top-(k+1) probabilities are ≥ MOE_GAP
    apart (up to the first row whose experts differ, past which the
    positions of a flipped expert shift), the output within 2^-7 on the
    rows routed alike; the drop fraction, and the layer's time beside its
    bound (every expert's weights read once: the capacity buffers feed
    all E experts), and its device items, are printed."""
    import torch

    from repro_torch.analysis import kernel_traffic as kt
    from repro_torch.core.performance_model import H100_PEAK_FLOPS_BF16
    from repro_torch.models import moe as moe_lib

    mcfg = model._moe_cfg()
    e, k, d = mcfg.num_experts, mcfg.experts_per_token, mcfg.d_model
    p = {name: w[layer] for name, w in params["blocks"]["moe"].items()}
    p_cpu = {name: w.float().cpu() for name, w in p.items()}
    out = {}
    for kind in ("prefill", "decode"):
        x = inputs[kind]
        t = x.shape[0] * x.shape[1]
        xt = x.reshape(t, d)
        probs, _, top_e, pos, keep, cap = moe_lib.route(p, xt, mcfg)
        y, met = moe_lib.apply_moe(p, x, mcfg)
        _, _, c_top_e, c_pos, c_keep, c_cap = moe_lib.route(
            p_cpu, xt.float().cpu(), mcfg)
        c_y, c_met = moe_lib.apply_moe(p_cpu, x.float().cpu(), mcfg)
        need(cap == c_cap == moe_lib.capacity(t, mcfg),
             f"{kind}: capacity {cap} / {c_cap}")
        top = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
        clear = ((top[:, :-1] - top[:, 1:]) >= MOE_GAP).all(-1).cpu()
        top_e, pos, keep = top_e.cpu(), pos.view(t, k).cpu(), keep.view(
            t, k).cpu()
        same_e = (top_e == c_top_e).all(-1)
        need(bool((same_e | ~clear).all()),
             f"{kind}: top-k experts differ on "
             f"{int((~same_e & clear).sum())} rows clear of ties")
        flipped = (~same_e).nonzero().reshape(-1)
        upto = int(flipped[0]) if flipped.numel() else t
        rows = clear.clone()
        rows[upto:] = False
        c_pos, c_keep = c_pos.view(t, k), c_keep.view(t, k)
        need(torch.equal(pos[rows], c_pos[rows])
             and torch.equal(keep[rows], c_keep[rows]),
             f"{kind}: positions or keep differ on rows clear of ties")
        alike = same_e & (keep == c_keep).all(-1) & (pos == c_pos).all(-1)
        yf, c_yf = y.float().cpu().reshape(t, d), c_y.reshape(t, d)
        err = float((yf[alike] - c_yf[alike]).abs().max())
        ok = torch.allclose(yf[alike], c_yf[alike], atol=2.0 ** -7,
                            rtol=2.0 ** -7)
        need(ok and bool(torch.isfinite(yf).all()),
             f"{kind}: the card's MoE output differs from the CPU's f32 "
             f"by {err} on rows routed alike")
        drop = float(met["moe_drop_fraction"])
        need(drop == float(c_met["moe_drop_fraction"]) or flipped.numel(),
             f"{kind}: drop fraction {drop} / "
             f"{float(c_met['moe_drop_fraction'])}")
        ms = time_ms(lambda: moe_lib.apply_moe(p, x, mcfg))
        # a few calls: ≈ 70 launches each, and the host's launch queue
        # must not fill behind the spin
        dev = device_ms(lambda: moe_lib.apply_moe(p, x, mcfg), iters=4)
        n_w = len([w for w in p if w != "router"])
        nbytes = (n_w * e * d * mcfg.d_ff * 2 + d * e * 4
                  + 2 * t * d * 2)
        ops = 2 * n_w * e * cap * d * mcfg.d_ff
        bms, by = kt.bound_ms(nbytes, ops, H100_PEAK_FLOPS_BF16)
        items = trace_items(lambda: moe_lib.apply_moe(p, x, mcfg), iters=1)
        out[kind] = dict(
            all_items={name[:90]: us / 1e3
                       for name, (_, us) in items.items()},
            tokens=t, capacity=cap, drop_fraction=drop,
            rows_near_tie=int((~clear).sum()),
            rows_flipped=int(flipped.numel()),
            rows_routed_alike=int(alike.sum()), max_abs_err=err, ms=ms,
            device_ms=dev, bound_ms=bms, bound_by=by,
            items={name[:90]: dict(calls=c, device_ms=us / 1e3)
                   for name, (c, us) in sorted(
                       items.items(), key=lambda kv: -kv[1][1])[:8]})
        log(f"[{label}] {kind} (T = {t}, capacity {cap}): drop fraction "
            f"{drop:.4f}; {int((~clear).sum())} rows with a top-{k + 1} "
            f"gap < {MOE_GAP}, {int(flipped.numel())} rows whose experts "
            f"differ from the CPU's f32 route; top-k / positions / keep "
            f"equal on the rows clear of ties; output within 2^-7 on "
            f"{int(alike.sum())} rows routed alike (max |Δ| {err:.3g})")
        log(f"[{label}] {kind}: {ms:.3f} ms a call (device "
            f"{dev if dev is None else round(dev, 3)} ms), bound "
            f"{bms:.3f} ms by {by} (the {e} experts' weights read once)")
        for name, r in out[kind]["items"].items():
            log(f"[{label}] {kind} item {r['device_ms']:8.3f} ms "
                f"x{r['calls']:<3} {name}")
    return out


def shared_prefix_keep(model, params, x, label="olmoe-serve"):
    """Layer 0's MoE on the first prefill wave, whose slots all hold the
    shared system prompt's first chunk: equal rows, equal routing, but
    capacity ranks assignments slot-major, so later slots keep fewer.
    Their K/V rows above layer 0 then differ, and a request that
    attaches another slot's pages of the prefix (run 2) reads rows it did
    not write. Returns the rows' equality and the kept assignments per
    slot."""
    import torch

    from repro_torch.models import moe as moe_lib

    mcfg = model._moe_cfg()
    p = {name: w[0] for name, w in params["blocks"]["moe"].items()}
    b, n, d = x.shape
    equal = all(torch.equal(x[0], x[i]) for i in range(1, b))
    _, _, _, _, keep, cap = moe_lib.route(p, x.reshape(b * n, d), mcfg)
    kept = keep.view(b, -1).sum(-1).tolist()
    log(f"[{label}] first prefill wave, layer 0's MoE: the {b} slots' rows "
        f"{'are' if equal else 'are not'} equal (the shared system prompt); "
        f"capacity {cap}; assignments kept per slot (of "
        f"{n * mcfg.experts_per_token}): {kept}")
    return dict(rows_equal=equal, capacity=cap, kept_per_slot=kept)


def tag_moe_items(profile, moe_items, layers, label):
    """Re-log a decode profile's largest items a tick beside the MoE's
    share of each: ``layers`` × the device ms that item's kernel took in
    one call of the MoE layer alone at the decode shape (``moe_items``,
    by kernel name; a name the MoE shares with other ops, such as an
    index kernel, gets only the MoE's part). Returns the MoE's ms a
    tick among those items."""
    ticks, total = profile["ticks"], 0.0
    for r in profile["top"]:
        moe_ms = min(layers * moe_items.get(r["name"], 0.0),
                     r["device_ms"] / ticks)
        r["moe_ms_per_tick"] = moe_ms
        total += moe_ms
        log(f"[{label}] {r['device_ms'] / ticks:8.3f} ms a tick, of which "
            f"the MoE ≈ {moe_ms:7.3f}  x{r['calls'] / ticks:<7.1f} "
            f"{r['name']}")
    return total


def olmoe_phase(results, blocks, ep_results):
    """``[olmoe-…]``: olmoe-1b-7b (MoE: 64 experts top-8, d_ff 1024 an
    expert; MHA, G = 1, 16 layers) at published widths and full depth
    (random bf16 weights from seed 0, the router f32) on the fused
    kernels:

    * ``[olmoe-serve]``: phase 4's requests (8 × 2048 tokens, 256
      shared, 32 greedy tokens, max_len 4096, chunk 128) through a
      graphed paged ``ServeLoop``: B1/B2 launched 14 times a decode step
      and B3/B4 14 times a prefill wave (layers 2–15); run 2 off the
      prefix cache recorded, not gated (:func:`shared_prefix_keep`);
      B1–B4 held against their plain versions on layer 2's live pool;
      decode ticks under the profiler (``[profile-decode-olmoe]``); then
      an eager engine on the same requests (``[olmoe-eager]``) must give
      the graphed streams (sha1), keeping layer 2's MoE inputs and layer
      0's of the first wave;
    * ``[olmoe-unpaged]``: the same requests through
      ``ServeLoop(paged=False)`` (B5–B8, 14 a step or wave): the streams
      must equal the paged run's (paged ≡ unpaged holds for the
      reference's MoE); B5–B8 held against their plain versions on layer
      2's captured rows;
    * ``[olmoe-score]``: ``LMModel.loss`` over 4 × 2048 tokens (B9 / B10,
      14 each): loss finite, aux > 0; B9–B11 on layer 2's q/k/v;
    * ``[olmoe-moe-layer]``: layer 2's MoE on its captured prefill (T =
      1024) and decode (T = 8) inputs, card against CPU
      (:func:`moe_layer_check`).

    Then phase 21 on the same model (:func:`moe_ep_phase`, B1–B4 of its
    ``(1, 4)`` shard into ``ep_results``). Returns each run's results
    (with its launches) by phase name, phase 20's and phase 21's."""
    import torch

    from repro_torch.configs import registry

    cfg = registry.get_serve_config(MOE_ARCH)
    need(cfg.family == "moe" and cfg.energon.impl == "pallas",
         "olmoe's serving config is not the MoE family on the fused path")
    out = {}
    engine, prompts, run1, launches, streams = serve_full_width(
        cfg, label="olmoe-serve", run2_must_equal=False)
    model, params = engine.model, engine.params
    router = params["blocks"]["moe"]["router"]
    need(router.dtype == torch.float32
         and params["blocks"]["moe"]["w_up"].dtype == torch.bfloat16,
         "olmoe's router is not f32 beside bf16 experts")
    n_params = sum(w.numel() for w in _leaves(params))
    n_bytes = sum(w.numel() * w.element_size() for w in _leaves(params))
    log(f"[olmoe-serve] {n_params / 1e9:.3f} B parameters "
        f"({n_bytes / 1e9:.2f} GB), router {router.dtype}")
    layer = cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer),
               f"olmoe-live-layer{layer}", results)
    run1.update(launches=launches, streams_sha1=streams_digest(streams),
                parameters=n_params)
    if DEV == "cuda":
        run1["profile_decode"] = profile_decode(
            engine, prompts[0][:SYSTEM_LEN], label="profile-decode-olmoe")
    del engine
    _free_device()
    run1["eager"], moe_inputs = olmoe_eager(model, params, prompts, streams,
                                            layer)
    run1["shared_prefix"] = shared_prefix_keep(
        model, params, moe_inputs.pop("first-wave-layer0"))
    out["olmoe-serve"] = run1

    uengine, unpaged, ulaunches, captured = serve_unpaged(
        model, params, prompts, streams, label="olmoe-unpaged")
    case = captured_contiguous_case(uengine, captured, layer)
    del uengine, captured
    _free_device()
    check_contiguous(case, f"olmoe-captured-layer{layer}", results)
    out["olmoe-unpaged"] = dict(unpaged, launches=ulaunches)
    del case
    _free_device()

    scoring, (q, k, v) = score_full_width(model, params, n_seq=4,
                                          label="olmoe-score")
    need(scoring["aux"] > 0 and math.isfinite(scoring["aux"]),
         f"olmoe's aux loss {scoring['aux']} is not > 0")
    scoring["captured"] = check_full_sequence(
        q, k, v, f"olmoe-captured-layer{layer}", results, **blocks)
    out["olmoe-score"] = scoring
    del q, k, v
    _free_device()

    layer_out = moe_layer_check(model, params, moe_inputs, layer)
    if "profile_decode" in run1:
        moe_ms = tag_moe_items(run1["profile_decode"],
                               layer_out["decode"].pop("all_items"),
                               cfg.num_layers, "profile-decode-olmoe")
        per_tick = layer_out["decode"]["device_ms"] * cfg.num_layers
        log(f"[olmoe-moe-layer] the MoE's part of the decode tick's largest "
            f"items: {moe_ms:.3f} ms a tick; {cfg.num_layers} MoE layers at "
            f"the decode shape, timed alone: {per_tick:.3f} ms of the "
            f"tick's {run1['profile_decode']['device_ms']:.3f} ms device "
            f"time")
        layer_out["decode_tick_share"] = (
            per_tick / run1["profile_decode"]["device_ms"])
    layer_out["prefill"].pop("all_items", None)
    layer_out["decode"].pop("all_items", None)
    out["olmoe-moe-layer"] = layer_out
    # phase 21 on the same model, weights, requests and captured inputs
    ep = moe_ep_phase(model, params, prompts, streams, moe_inputs, layer,
                      run1.get("profile_decode"), ep_results)
    del model, params, moe_inputs
    _free_device()
    return out, ep


#: [moe-ep-…]: the model axes of the one-card meshes olmoe is served on
MOE_EP_MESHES = (2, 4)
#: a phase's device-memory peak may not pass this (GB, of the card's 80)
PEAK_LIMIT_GB = 70.0


def _peak_gb():
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else 0.0


def ep_serve(model, params, prompts, streams, m, *, label, results=None,
             profile=False, seed=0, new_tokens=32, max_len=4096, chunk=128):
    """Phase 20's requests (or phase 22's) through a lone graphed paged
    ``ServeLoop`` on a ``(1, m)`` mesh of the one card: the pool split by
    KV head and the experts by the model axis (views of the stacked
    leaves), every MoE layer on the expert-parallel path. Launch counts
    zeroed just before the drain and read just after: B1–B4 once per
    fused layer, dispatch and shard. The streams' sha1 is printed beside
    the single-device engine's, with the share of tokens equal (the
    expert-parallel layer rounds each shard's partial to bf16 before the
    cross-shard sum, so these bits differ by design). With ``results``,
    B1–B4 against their plain versions on shard 0's live pool of layer
    2; with ``profile``, decode ticks under the profiler."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.runtime import ServeLoop

    _free_device()
    mesh = _sim_mesh((1, m))
    engine = ServeLoop(
        model, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, seed=seed, prefill_chunk=chunk, prefix_sharing=True,
        device=DEV, mesh=mesh,
    )
    need(engine.cuda_graphs or DEV != "cuda",
         f"[{label}] the engine does not replay graphs")
    experts = engine.params["blocks"]["moe"]["w_up"]
    need(isinstance(experts, tuple) and len(experts) == m
         and experts[0].untyped_storage().data_ptr()
         == params["blocks"]["moe"]["w_up"].untyped_storage().data_ptr(),
         f"[{label}] the experts are not {m} views of the stacked leaves")
    kv_shards = len(engine.cache["k"]) if isinstance(
        engine.cache["k"], tuple) else 1
    engine.capture_graphs()
    graph = log_graphs(f"[graph] {label} engine ({mesh}; "
                       f"{engine.graph_mode})", engine)
    _submit_all(engine, prompts, new_tokens)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    mt = engine.metrics
    lat = mt.latency_stats()
    got = {r.uid: list(r.tokens_out) for r in done}
    need(len(done) == len(prompts) and mt.failed_requests == 0
         and all(len(v) == new_tokens for v in got.values()),
         f"[{label}] not every request drained to {new_tokens} tokens")
    _mesh_launches(label, launches, model, mt.decode_dispatches,
                   mt.prefill_dispatches, kv_shards)
    equal = sum(a == b for u in streams for a, b in zip(streams[u], got[u]))
    total = sum(len(v) for v in streams.values())
    cfg = model.cfg
    bh = len(prompts) * cfg.num_kv_heads // kv_shards
    peak = _peak_gb()
    log(f"[{label}] {len(done)} requests on a (1, {m}) mesh of {DEV} "
        f"({cfg.num_experts // m} experts and {cfg.num_kv_heads // kv_shards}"
        f" KV heads a shard) in {wall:.2f} s; prefill "
        f"{mt.prefill_tokens_per_sec:.1f} tok/s, decode "
        f"{mt.decode_tokens_per_sec:.1f} tok/s, ttft p50 "
        f"{lat['ttft_p50'] * 1e3:.1f} ms, itl p50/p95 "
        f"{lat['itl_p50'] * 1e3:.2f}/{lat['itl_p95'] * 1e3:.2f} ms; peak "
        f"device memory {peak!r} GB")
    log(f"[{label}] greedy streams sha1 {streams_digest(got)}, the "
        f"single-device engine's {streams_digest(streams)}: {equal} of "
        f"{total} tokens equal (the layer's bits differ by design; a "
        f"greedy token flips only where they cross a near-tie)")
    log(f"[{label}] launches (bh {bh} a shard): " + ", ".join(
        f"{KERNELS[k]['id']} {launches[k]}" for k in SERVE_KERNELS)
        + f" = fused layers × dispatches × {kv_shards} shards")
    out = dict(wall_s=wall, prefill_tok_s=mt.prefill_tokens_per_sec,
               decode_tok_s=mt.decode_tokens_per_sec,
               ttft_p50_ms=lat["ttft_p50"] * 1e3,
               itl_p50_ms=lat["itl_p50"] * 1e3,
               itl_p95_ms=lat["itl_p95"] * 1e3, peak_memory_gb=peak,
               bh_per_shard=bh, graph_mode=engine.graph_mode,
               tokens_equal_single=equal, tokens=total,
               streams_sha1=streams_digest(got),
               launches={k: launches[k] for k in SERVE_KERNELS}, **graph)
    layer = cfg.energon.min_prune_layer
    if results is not None:
        check_case(live_pool_case(engine, prompts, layer, shard=0),
                   f"{label}-shard0-layer{layer}", results)
    if profile and DEV == "cuda":
        out["profile_decode"] = profile_decode(
            engine, prompts[0][:SYSTEM_LEN], label=f"profile-decode-{label}")
    del engine, done
    _free_device()
    return out, got


def ep_layer_check(model, params, inputs, layer, meshes=MOE_EP_MESHES,
                   label="moe-ep-layer"):
    """Layer ``layer``'s MoE on its captured bf16 inputs (the prefill
    wave's and the decode step's) on ``(1, M)`` meshes of the card
    against the single-device layer on the same inputs: the routing is
    one and the same call, so every row is routed alike, and the output
    must come within 2^-7; the cross-shard sum must equal, bit for bit,
    the shards' partials added in f32 in shard order and rounded once
    (recomputed on the host in numpy); the drop fraction the
    single-device one to 1e-6. Each layer timed beside the single one."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as moe_lib

    mcfg = model._moe_cfg()
    p = {name: w[layer] for name, w in params["blocks"]["moe"].items()}
    out = {}
    real = moe_lib.cross_shard_sum
    for m in meshes:
        mesh = _sim_mesh((1, m))
        for kind in ("prefill", "decode"):
            x = inputs[kind]
            single, smet = moe_lib.apply_moe(p, x, mcfg)
            seen = {}

            def spy(partials, dtype, device, share=None):
                seen["partials"] = [q.clone() for q in partials]
                seen["out"] = real(partials, dtype, device, share)
                return seen["out"]

            moe_lib.cross_shard_sum = spy
            try:
                with shd.active_mesh(mesh):
                    y, met = moe_lib.apply_moe(p, x, mcfg)
            finally:
                moe_lib.cross_shard_sum = real
            parts = [q.float().cpu().numpy() for q in seen["partials"]]
            acc = parts[0].copy()
            for q in parts[1:]:
                acc += q
            rule = torch.from_numpy(acc).to(y.dtype)
            need(len(parts) == m and torch.equal(
                rule, y.cpu().reshape(rule.shape)),
                f"[{label}] 1x{m} {kind}: the cross-shard sum is not the "
                f"f32 sum of the partials rounded once")
            chain = seen["partials"][0]
            for q in seen["partials"][1:]:
                chain = chain + q
            chain_diff = int((chain != seen["out"]).sum())
            err = float((y.float() - single.float()).abs().max())
            differ = int((y != single).sum())
            need(bool(torch.isfinite(y).all()) and torch.allclose(
                y.float(), single.float(), atol=2.0 ** -7, rtol=2.0 ** -7),
                f"[{label}] 1x{m} {kind}: the expert-parallel layer is "
                f"{err} from the single-device one")
            drop, sdrop = (float(met["moe_drop_fraction"]),
                           float(smet["moe_drop_fraction"]))
            need(abs(drop - sdrop) <= 1e-6,
                 f"[{label}] 1x{m} {kind}: drop fraction {drop} / {sdrop}")

            def ep_call():
                with shd.active_mesh(mesh):
                    return moe_lib.apply_moe(p, x, mcfg, metrics=False)

            ms = time_ms(ep_call)
            single_ms = time_ms(lambda: moe_lib.apply_moe(p, x, mcfg,
                                                          metrics=False))
            out[f"1x{m}-{kind}"] = dict(
                tokens=x.shape[0] * x.shape[1], max_abs_err=err,
                elements_differing=differ, elements=y.numel(),
                chain_of_bf16_adds_differs=chain_diff, drop_fraction=drop,
                ms=ms, single_ms=single_ms)
            log(f"[{label}] 1x{m} {kind} (T = {x.shape[0] * x.shape[1]}): "
                f"within 2^-7 of the single-device layer (max |Δ| {err:.3g}, "
                f"{differ} of {y.numel()} elements differ); cross-shard sum "
                f"= the f32 sum rounded once, bit for bit (a chain of bf16 "
                f"adds differs on {chain_diff}); drop fraction {drop:.4f}; "
                f"{ms:.3f} ms a call (single device {single_ms:.3f} ms)")
    return out


def ep_replicas(model, params, prompts, *, seed=0, new_tokens=32,
                max_len=4096, chunk=128, label="moe-ep-replicas"):
    """A ``ReplicatedServeLoop`` on a ``(2, 2)`` mesh of the one card: two
    replicas of 8 slots, each expert-parallel and tensor-parallel over
    its ``(1, 2)`` row; every request drains to its tokens. (Its streams
    need not be the lone engine's: a replica's MoE couples its own
    slots through capacity.)"""
    from repro_torch.kernels import _build
    from repro_torch.runtime import ReplicatedServeLoop

    _free_device()
    loop = ReplicatedServeLoop(
        model, params, mesh=_sim_mesh((2, 2)), seed=seed,
        batch_slots=len(prompts), max_len=max_len, eos_token=-1,
        prefill_chunk=chunk, prefix_sharing=True, device=DEV)
    need(all(isinstance(e.params["blocks"]["moe"]["w_up"], tuple)
             and len(e.params["blocks"]["moe"]["w_up"]) == 2
             for e in loop.engines),
         f"[{label}] a replica's experts are not split over its row")
    loop.capture_graphs()
    _submit_all(loop, prompts, new_tokens)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    done = loop.run_until_drained()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    got = {r.uid: list(r.tokens_out) for r in done}
    need(len(done) == len(prompts)
         and all(len(v) == new_tokens for v in got.values()),
         f"[{label}] not every request drained")
    per = [e.metrics for e in loop.engines]
    _mesh_launches(label, launches, model,
                   sum(p.decode_dispatches for p in per),
                   sum(p.prefill_dispatches for p in per), 2)
    merged = loop.merged_metrics()
    placement = [loop.placement[u] for u in sorted(loop.placement)]
    log(f"[{label}] {len(done)} requests on a 2x2 mesh of {DEV} in "
        f"{wall:.2f} s; placement {placement}; streams sha1 "
        f"{streams_digest(got)}; merged prefill "
        f"{merged.prefill_tokens_per_sec:.1f} tok/s, decode "
        f"{merged.decode_tokens_per_sec:.1f} tok/s")
    out = dict(wall_s=wall, placement=placement,
               streams_sha1=streams_digest(got),
               merged_prefill_tok_s=merged.prefill_tokens_per_sec,
               merged_decode_tok_s=merged.decode_tokens_per_sec,
               launches={k: launches[k] for k in SERVE_KERNELS})
    del loop, done
    _free_device()
    return out


def moe_ep_phase(model, params, prompts, streams, moe_inputs, layer,
                 tick, results):
    """``[moe-ep-…]``: olmoe-1b-7b (phase 20's model, 64 experts, 16 KV
    heads) on meshes of the one card, graphed, with phase 20's requests:
    ``[moe-ep-serve-1x2]`` / ``[moe-ep-serve-1x4]`` (B1–B4 14 × M a step
    or wave; on ``(1, 4)`` B1–B4 against their plain versions on shard
    0's live pool, bh 32, and decode ticks under the profiler beside
    phase 20's ``tick``), ``[moe-ep-eager]`` (an eager ``(1, 4)`` engine
    gives the graphed streams), ``[moe-ep-layer]`` (layer 2's
    expert-parallel MoE on phase 20's captured inputs:
    :func:`ep_layer_check`) and ``[moe-ep-replicas]`` (``(2, 2)``)."""
    out, graphed = {}, {}
    for m in MOE_EP_MESHES:
        label = f"moe-ep-serve-1x{m}"
        out[label], graphed[m] = ep_serve(
            model, params, prompts, streams, m, label=label,
            results=results if m == MOE_EP_MESHES[-1] else None,
            profile=m == MOE_EP_MESHES[-1])
    prof = out[f"moe-ep-serve-1x{MOE_EP_MESHES[-1]}"].get("profile_decode")
    if prof is not None and tick is not None:
        log(f"[moe-ep-serve] a graphed decode tick on the (1, "
            f"{MOE_EP_MESHES[-1]}) mesh: {prof['device_ms']:.3f} ms of device "
            f"time over {prof['kernels_per_tick']:.0f} kernels, idle "
            f"{prof['idle_share']:.1%}; phase 20's single-device tick "
            f"{tick['device_ms']:.3f} ms over {tick['kernels_per_tick']:.0f}"
            f", idle {tick['idle_share']:.1%}")
    m = MOE_EP_MESHES[-1]
    out["moe-ep-eager"], _ = olmoe_eager(
        model, params, prompts, graphed[m], layer, label="moe-ep-eager",
        mesh=_sim_mesh((1, m)))
    _free_device()
    out["moe-ep-layer"] = ep_layer_check(model, params, moe_inputs, layer)
    out["moe-ep-replicas"] = ep_replicas(model, params, prompts)
    out["serve-2d"] = serve_2d_serve(model, params, prompts, streams,
                                     out[f"moe-ep-serve-1x{m}"])
    out["serve-2d-layer"] = serve_2d_layer_check(model, params, moe_inputs,
                                                 layer)
    return out


#: ``[serve-2d]``: the graphed engine's mesh, and the 2-D layer's mesh
SERVE_2D_MESH, SERVE_2D_GRID = (1, 4), (2, 2)
#: the 2-D layer in f32 against the single-device layer (the CPU test's
#: tolerance, tests/test_torch_distributed.py): the same routing, each
#: output element's down-projection split over D d_ff slices and summed
#: in another order
SERVE_2D_F32_ATOL = 1e-5


def serve_2d_serve(model, params, prompts, streams, ep):
    """``[serve-2d]``: phase 20's requests through one graphed paged
    ``ServeLoop`` on a ``(1, 4)`` mesh of the card under the ``"serve"``
    rules profile: every MoE layer through ``apply_moe_serve_2d`` (the
    capture's calls counted; ``apply_moe_sharded`` never), B1–B4 on
    every shard (:func:`ep_serve`'s checks), decode ticks under the
    profiler, beside ``ep``, the same mesh's expert-parallel run. The
    2-D path sums the partials in f32 and rounds once, where EP rounds
    each to bf16: the streams are compared, not gated."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as moe_lib

    calls = {"serve_2d": 0, "sharded": 0}
    real_2d, real_ep = moe_lib.apply_moe_serve_2d, moe_lib.apply_moe_sharded

    def spy_2d(*a, **kw):
        calls["serve_2d"] += 1
        return real_2d(*a, **kw)

    def spy_ep(*a, **kw):
        calls["sharded"] += 1
        return real_ep(*a, **kw)

    shd.set_rules_profile("serve")
    moe_lib.apply_moe_serve_2d, moe_lib.apply_moe_sharded = spy_2d, spy_ep
    try:
        out, _ = ep_serve(model, params, prompts, streams, SERVE_2D_MESH[1],
                          label="serve-2d", profile=DEV == "cuda")
    finally:
        moe_lib.apply_moe_serve_2d, moe_lib.apply_moe_sharded = (real_2d,
                                                                 real_ep)
        shd.set_rules_profile("train")
    need(calls["serve_2d"] > 0 and calls["sharded"] == 0,
         f"[serve-2d] the MoE layers took {calls}, not the 2-D path alone")
    tick = out.get("profile_decode", {}).get("device_ms", float("nan"))
    ep_tick = ep.get("profile_decode", {}).get("device_ms", float("nan"))
    log(f"[serve-2d] 2-D experts on (1, {SERVE_2D_MESH[1]}) (apply_moe_"
        f"serve_2d traced {calls['serve_2d']} times by the captures and "
        f"eager steps): prefill {out['prefill_tok_s']:.1f} tok/s, decode "
        f"{out['decode_tok_s']:.1f} tok/s, decode tick {tick:.3f} ms of "
        f"device time; expert parallelism on the same mesh: prefill "
        f"{ep['prefill_tok_s']:.1f} tok/s, decode {ep['decode_tok_s']:.1f} "
        f"tok/s, tick {ep_tick:.3f} ms")
    out.update(calls=calls, ep_prefill_tok_s=ep["prefill_tok_s"],
               ep_decode_tok_s=ep["decode_tok_s"], ep_tick_ms=ep_tick)
    return out


def serve_2d_layer_check(model, params, inputs, layer,
                         label="serve-2d-layer"):
    """Layer ``layer``'s MoE in f32 on its captured inputs (the prefill
    wave's and the decode step's, widened) through ``apply_moe_serve_2d``
    on a ``(2, 2)`` mesh of the card (experts over 'model' × d_ff over
    'data') against the single-device layer: within
    ``SERVE_2D_F32_ATOL``, the drop fraction within 1e-6; each timed
    beside the single-device layer (bf16, metrics off)."""
    import torch

    from repro_torch.models import moe as moe_lib

    mcfg = model._moe_cfg()
    p = {name: w[layer] for name, w in params["blocks"]["moe"].items()}
    p32 = {name: w.float() for name, w in p.items()}
    mesh = _sim_mesh(SERVE_2D_GRID)
    out = {}
    for kind in ("prefill", "decode"):
        x = inputs[kind]
        single, smet = moe_lib.apply_moe(p32, x.float(), mcfg)
        y, met = moe_lib.apply_moe_serve_2d(p32, x.float(), mcfg, mesh)
        err = float((y - single).abs().max())
        drop, sdrop = (float(met["moe_drop_fraction"]),
                       float(smet["moe_drop_fraction"]))
        ms = time_ms(lambda: moe_lib.apply_moe_serve_2d(p, x, mcfg, mesh,
                                                        metrics=False))
        single_ms = time_ms(lambda: moe_lib.apply_moe(p, x, mcfg,
                                                      metrics=False))
        t = x.shape[0] * x.shape[1]
        log(f"[{label}] {SERVE_2D_GRID[0]}x{SERVE_2D_GRID[1]} {kind} (T = "
            f"{t}) in f32: max |Δ| {err:.3g} from the single-device layer "
            f"(tolerance {SERVE_2D_F32_ATOL}), drop fraction {drop:.4f} / "
            f"{sdrop:.4f}; bf16 {ms:.3f} ms a call (single device "
            f"{single_ms:.3f} ms)")
        need(bool(torch.isfinite(y).all()) and err <= SERVE_2D_F32_ATOL,
             f"[{label}] {kind}: the 2-D layer is {err} from one device")
        need(abs(drop - sdrop) <= 1e-6,
             f"[{label}] {kind}: drop fraction {drop} / {sdrop}")
        out[kind] = dict(tokens=t, max_abs_err=err, drop_fraction=drop,
                         ms=ms, single_ms=single_ms)
    return out


#: [qwen3moe-…]: the depth served at qwen3-moe-235b-a22b's full width
#: (of 94 layers): the deepest whose phase peaks stay within PEAK_LIMIT_GB
QWEN3MOE_LAYERS = 11
#: its prefill chunk: G·chunk = 16 × 64 = 1024 folded rows keep the dense
#: prefix's [G·chunk, max_len] masks within chunk_threshold at max_len 4096
QWEN3MOE_CHUNK = 64


def qwen3moe_phase(results, blocks, layers=QWEN3MOE_LAYERS):
    """``[qwen3moe-…]``: qwen3-moe-235b-a22b at published widths (d 4096,
    64 / 4 heads of 128: G 16, 128 experts top-8 of d_ff 1536, vocab
    151936; random bf16 weights from seed 0, the router f32), cut to
    ``layers`` layers, on the fused kernels:

    * ``[qwen3moe-serve]``: phase 4's requests (8 × 2048 tokens, 256
      shared, 32 greedy tokens, max_len 4096) in chunks of 64 through a
      graphed paged engine: B1/B2 and B3/B4 launched ``layers`` − 2 times a
      step / wave; B1–B4 against their plain versions on layer 2's live
      pool (bh 32, G 16, 1024 folded prefill rows), timed beside their
      bounds; decode ticks under the profiler; ``[qwen3moe-eager]`` (an
      eager engine gives the graphed streams, keeping layer 2's MoE
      inputs);
    * ``[qwen3moe-unpaged]``: B5–B8, streams equal to the paged run's;
      B5–B8 against their plain versions on layer 2's captured rows;
    * ``[qwen3moe-score]``: ``loss`` over 2 × 2048 tokens (B9 / B10),
      loss finite, aux > 0; B9–B11 on layer 2's q/k/v;
    * ``[qwen3moe-moe-layer]``: layer 2's MoE on its captured inputs
      (T = 512 / 8), card against CPU f32: drop fractions, time vs bound;
    * ``[qwen3moe-ep-1x4]``: the requests on a ``(1, 4)`` mesh of the
      card: 32 experts and 1 KV head a shard, B1–B4 at bh 8 a shard.

    Every phase's device-memory peak must stay within PEAK_LIMIT_GB.
    Returns each run's results (with its launches) by phase name."""
    from repro_torch.configs.registry import get_serve_config

    cfg = get_serve_config("qwen3-moe-235b-a22b")
    full = cfg.num_layers
    need((cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
          cfg.num_experts, cfg.experts_per_token, cfg.d_ff, cfg.vocab_size)
         == (4096, 64, 4, 128, 128, 8, 1536, 151936)
         and cfg.energon.impl == "pallas",
         "qwen3-moe's serving config is not the published widths on the "
         "fused path")
    cfg = dataclasses.replace(cfg, num_layers=layers)
    log(f"[qwen3moe] depth cut to {layers} of {full} layers (widths "
        f"unchanged); prefill chunk {QWEN3MOE_CHUNK}")
    out, peaks = {}, {}
    engine, prompts, run1, launches, streams = serve_full_width(
        cfg, label="qwen3moe-serve", chunk=QWEN3MOE_CHUNK,
        run2_must_equal=False)
    peaks["init"], peaks["serve"] = run1["init_peak_gb"], _peak_gb()
    model, params = engine.model, engine.params
    n_params = sum(w.numel() for w in _leaves(params))
    n_bytes = sum(w.numel() * w.element_size() for w in _leaves(params))
    log(f"[qwen3moe-serve] {n_params / 1e9:.3f} B parameters "
        f"({n_bytes / 1e9:.2f} GB) at {layers} layers")
    layer = cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer),
               f"qwen3moe-live-layer{layer}", results)
    run1.update(launches=launches, streams_sha1=streams_digest(streams),
                parameters=n_params, layers=layers)
    if DEV == "cuda":
        run1["profile_decode"] = profile_decode(
            engine, prompts[0][:SYSTEM_LEN], label="profile-decode-qwen3moe")
    del engine
    _free_device()
    run1["eager"], moe_inputs = olmoe_eager(
        model, params, prompts, streams, layer, chunk=QWEN3MOE_CHUNK,
        label="qwen3moe-eager")
    moe_inputs.pop("first-wave-layer0", None)
    out["qwen3moe-serve"] = run1
    _free_device()

    if DEV == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    uengine, unpaged, ulaunches, captured = serve_unpaged(
        model, params, prompts, streams, chunk=QWEN3MOE_CHUNK,
        label="qwen3moe-unpaged")
    peaks["unpaged"] = _peak_gb()
    case = captured_contiguous_case(uengine, captured, layer)
    del uengine, captured
    _free_device()
    check_contiguous(case, f"qwen3moe-captured-layer{layer}", results)
    out["qwen3moe-unpaged"] = dict(unpaged, launches=ulaunches)
    del case
    _free_device()

    scoring, (q, k, v) = score_full_width(model, params, n_seq=2,
                                          label="qwen3moe-score")
    peaks["score"] = _peak_gb()
    need(scoring["aux"] > 0 and math.isfinite(scoring["aux"]),
         f"qwen3-moe's aux loss {scoring['aux']} is not > 0")
    scoring["captured"] = check_full_sequence(
        q, k, v, f"qwen3moe-captured-layer{layer}", results, **blocks)
    out["qwen3moe-score"] = scoring
    del q, k, v
    _free_device()

    layer_out = moe_layer_check(model, params, moe_inputs, layer,
                                label="qwen3moe-moe-layer")
    for kind in ("prefill", "decode"):
        layer_out[kind].pop("all_items", None)
    out["qwen3moe-moe-layer"] = layer_out
    _free_device()

    if DEV == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    ep, _ = ep_serve(model, params, prompts, streams, 4,
                     label="qwen3moe-ep-1x4", chunk=QWEN3MOE_CHUNK)
    peaks["ep"] = ep["peak_memory_gb"]
    ep["drop_fraction"] = {kind: layer_out[kind]["drop_fraction"]
                           for kind in ("prefill", "decode")}
    out["qwen3moe-ep-1x4"] = ep
    peaks = {k: float(v) for k, v in peaks.items() if v is not None}
    log(f"[qwen3moe] {layers} layers: device-memory peaks (GB) "
        f"{json.dumps(peaks)}; drop fractions prefill "
        f"{layer_out['prefill']['drop_fraction']:.4f} / decode "
        f"{layer_out['decode']['drop_fraction']:.4f}")
    need(DEV != "cuda" or max(peaks.values()) <= PEAK_LIMIT_GB,
         f"[qwen3moe] a phase peaked past {PEAK_LIMIT_GB} GB: {peaks}")
    out["qwen3moe-serve"]["peaks_gb"] = peaks
    del model, params, moe_inputs
    _free_device()
    return out


# ---------------------------------------------------------------------------
# the vlm / audio and the recurrent families
# ---------------------------------------------------------------------------

#: llava-next-34b's depth on the card (of 60 layers): the deepest cut
#: whose phases peak within PEAK_LIMIT_GB (1.12 GB of bf16 weights a
#: layer, 1.84 GB for the embedding and the head; on an H100 80GB at 50
#: layers the unpaged serve peaked at 64.7 GB, each layer adding ≈ 1.22)
LLAVA_LAYERS = 54
#: [musicgen-…] / [llava-…]: (serve, score) traffic
FAMILY_PHASES = (
    ("musicgen-medium", None,
     dict(n_req=8, prompt_len=1024, max_len=2048), dict(n_seq=4)),
    ("llava-next-34b", LLAVA_LAYERS,
     dict(n_req=4, prompt_len=2048, max_len=4096), dict(n_seq=2)),
)
#: [zamba2-…] / [xlstm-…]: (arch, scored sequences, depth or None for
#: the full depth); the requests admitted together by one sequential
#: wave and their prompt length (max_len 1024: the shared block's planes
#: resident); the profiled drain's prompt length and the eager-vs-graphed
#: pair's traffic (an eager step launches each of its 4000–9000 kernels
#: from the host: on an H100 a wave of 511 eager zamba2 steps took ≈ 2
#: min). xlstm-1.3b (no kernel) runs 2 of its 6 groups of 7 mLSTM + 1
#: sLSTM layers, to keep the whole script near 900 s
RECURRENT_PHASES = (("zamba2-7b", 2, None), ("xlstm-1.3b", 1, 16))
RECURRENT_REQUESTS, RECURRENT_PROMPT, RECURRENT_MAX_LEN = 4, 512, 1024
RECURRENT_PROFILE_PROMPT = 128
RECURRENT_EAGER = dict(prompt_len=64, new_tokens=16)


def card_name():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]


def card_line(label):
    """The card's name and power limit on a line of the phase's own."""
    if DEV != "cuda":
        return None
    smi = card_name()
    log(f"[{label}] card: {smi}")
    return smi


def drain_stats(engine, done, wall):
    """A drained engine's tok/s, TTFT and ITL percentiles."""
    m = engine.metrics
    lat = m.latency_stats()
    return dict(
        requests=len(done), wall_s=wall,
        prefill_tok_s=m.prefill_tokens_per_sec,
        decode_tok_s=m.decode_tokens_per_sec,
        ttft_p50_ms=lat["ttft_p50"] * 1e3, ttft_p95_ms=lat["ttft_p95"] * 1e3,
        itl_p50_ms=lat["itl_p50"] * 1e3, itl_p95_ms=lat["itl_p95"] * 1e3,
        prefill_dispatches=m.prefill_dispatches,
        decode_dispatches=m.decode_dispatches,
        prefill_tokens=m.prefill_tokens, decode_tokens=m.decode_tokens)


def log_drain(label, what, st):
    log(f"[{label}] {what}: {st['requests']} requests in {st['wall_s']:.2f} "
        f"s; prefill {st['prefill_tokens']} tok in "
        f"{st['prefill_dispatches']} dispatches ({st['prefill_tok_s']:.1f} "
        f"tok/s), decode {st['decode_tokens']} tok in "
        f"{st['decode_dispatches']} dispatches ({st['decode_tok_s']:.1f} "
        f"tok/s); ttft p50/p95 {st['ttft_p50_ms']:.1f}/"
        f"{st['ttft_p95_ms']:.1f} ms, itl p50/p95 {st['itl_p50_ms']:.2f}/"
        f"{st['itl_p95_ms']:.2f} ms")


def drain(engine, prompts, new_tokens):
    """Submit ``prompts`` and drain: the finished requests and the wall
    seconds."""
    _submit_all(engine, prompts, new_tokens)
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    sync()
    need(len(done) == len(prompts) and all(r.done for r in done),
         "not every request drained")
    need(engine.metrics.failed_requests == 0,
         f"{engine.metrics.failed_requests} requests quarantined "
         f"(non-finite logits)")
    return done, time.perf_counter() - t0


def eager_drain(model, params, prompts, streams, *, label, paged,
                new_tokens=32, max_len=4096, chunk=128):
    """The requests through a fresh eager (``cuda_graphs=False``) engine:
    its streams must be the graphed engine's (sha1); with ``streams``
    None, a fresh graphed engine's on the same requests first."""
    from repro_torch.runtime import ServeLoop

    if streams is None:
        graphed = ServeLoop(
            model, params, batch_slots=len(prompts), max_len=max_len,
            eos_token=-1, prefill_chunk=chunk, paged=paged, device=DEV)
        need(graphed.cuda_graphs, "the engine does not replay CUDA graphs")
        done, _ = drain(graphed, prompts, new_tokens)
        streams = {r.uid: list(r.tokens_out) for r in done}
        del graphed
        _free_device()

    engine = ServeLoop(
        model, params, batch_slots=len(prompts), max_len=max_len,
        eos_token=-1, prefill_chunk=chunk, paged=paged, device=DEV,
        cuda_graphs=False)
    done, wall = drain(engine, prompts, new_tokens)
    st = drain_stats(engine, done, wall)
    eager = {r.uid: list(r.tokens_out) for r in done}
    st["streams_sha1"] = streams_digest(eager)
    log_drain(label, "eager engine", st)
    log(f"[{label}] eager streams sha1 {st['streams_sha1']} (graphed "
        f"{streams_digest(streams)})")
    need(eager == streams,
         f"[{label}] the eager engine's streams differ from the graphed "
         f"engine's")
    del engine
    _free_device()
    return st


def family_phase(arch, layers, serve_kw, score_kw, results, blocks):
    """``[musicgen-…]`` / ``[llava-…]``: a vlm or audio model at published
    widths (random bf16 weights from seed 0; llava cut to ``layers``
    layers, depth only) on the fused kernels, the dense stack with the
    ``embeddings`` input: served through a graphed paged engine (B1/B2
    and B3/B4 once per layer past the prefix and dispatch), B1–B4 held
    against their plain versions on layer 2's live pool, an eager engine
    (musicgen) with the graphed streams, the same requests unpaged (B5–B8,
    the paged streams) with B5–B8 on layer 2's captured rows, and
    ``loss`` over the frontend stub's embeddings (B9 / B10 once per such
    layer) with B9–B11 on layer 2's q/k/v. Every device-memory peak
    within PEAK_LIMIT_GB. Returns each run's results by phase name."""
    import torch

    from repro_torch.configs.registry import get_serve_config

    short = arch.split("-")[0]
    cfg = get_serve_config(arch)
    full = cfg.num_layers
    need(cfg.family in ("vlm", "audio") and cfg.energon.impl == "pallas",
         f"{arch}'s serving config is not a vlm / audio model on the fused "
         f"path")
    if layers is not None and layers != full:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        log(f"[{short}] depth cut to {layers} of {full} layers (widths "
            f"unchanged)")
    card = card_line(short)
    out, peaks = {}, {}
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    engine, prompts, run1, launches, streams = serve_full_width(
        cfg, label=f"{short}-serve", **serve_kw)
    peaks["init"], peaks["serve"] = run1["init_peak_gb"], _peak_gb()
    model, params = engine.model, engine.params
    n_params = sum(w.numel() for w in _leaves(params))
    _, fused, _ = layer_paths(model)
    log(f"[{short}-serve] {n_params / 1e9:.3f} B parameters at "
        f"{cfg.num_layers} layers; launches a decode step: B1/B2 {fused} "
        f"each, a prefill wave: B3/B4 {fused} each")
    layer = cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer),
               f"{short}-live-layer{layer}", results)
    run1.update(launches=launches, streams_sha1=streams_digest(streams),
                parameters=n_params, layers=cfg.num_layers, card=card,
                launches_per_step=fused)
    del engine
    _free_device()
    max_len, chunk = serve_kw.get("max_len", 4096), 128
    if arch == "musicgen-medium":
        run1["eager"] = eager_drain(model, params, prompts, streams,
                                    label=f"{short}-eager", paged=True,
                                    max_len=max_len)
    out[f"{short}-serve"] = run1

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    uengine, unpaged, ulaunches, captured = serve_unpaged(
        model, params, prompts, streams, max_len=max_len, chunk=chunk,
        label=f"{short}-unpaged")
    peaks["unpaged"] = _peak_gb()
    case = captured_contiguous_case(uengine, captured, layer)
    del uengine, captured
    _free_device()
    check_contiguous(case, f"{short}-captured-layer{layer}", results)
    out[f"{short}-unpaged"] = dict(unpaged, launches=ulaunches)
    del case
    _free_device()

    scoring, (q, k, v) = score_full_width(model, params,
                                          label=f"{short}-score", **score_kw)
    peaks["score"] = _peak_gb()
    scoring["captured"] = check_full_sequence(
        q, k, v, f"{short}-captured-layer{layer}", results, **blocks)
    out[f"{short}-score"] = scoring
    del q, k, v, model, params
    _free_device()
    peaks = {k: float(v) for k, v in peaks.items() if v is not None}
    log(f"[{short}] {cfg.num_layers} layers: device-memory peaks (GB) "
        f"{json.dumps(peaks)}")
    need(DEV != "cuda" or max(peaks.values()) <= PEAK_LIMIT_GB,
         f"[{short}] a phase peaked past {PEAK_LIMIT_GB} GB: {peaks}")
    out[f"{short}-serve"]["peaks_gb"] = peaks
    return out


def shared_block_case(engine, captured, chunk=128):
    """The hybrid's shared block, group 0, after a drain: the last decode
    step's queries over its live contiguous cache (B5 / B6's operands),
    and for B7 / B8 a chunk of the cache's own keys at each row's last
    written positions (so that their scores are live)."""
    import torch

    e = engine.model.cfg.energon
    cache = {k: v[0] for k, v in engine.cache["shared_attn"].items()}
    batch, heads, n_k, d = cache["k"].shape
    bh = batch * heads
    q_dec, cl = captured
    cl = cl.to(torch.int32).repeat_interleave(heads)
    k = cache["k"].reshape(bh, n_k, d)
    end = cl.long().clamp(min=chunk, max=n_k)
    pos = end[:, None] - chunk + torch.arange(chunk, device=DEV)[None, :]
    gen = torch.Generator(device=DEV).manual_seed(8)
    q_pre = k[torch.arange(bh, device=DEV)[:, None], pos]
    q_pre = q_pre + 0.1 * torch.randn(q_pre.shape, generator=gen,
                                      device=DEV, dtype=q_pre.dtype)
    return ContiguousCase(
        q_dec=q_dec.reshape(bh, -1, d).to(k.dtype).contiguous(), cl=cl,
        q_pre=q_pre.contiguous(), qpos=pos.to(torch.int32), k=k,
        v=cache["v"].reshape(bh, n_k, d),
        codes=cache["k_codes"].reshape(bh, n_k, d),
        scale=cache["k_scale"].reshape(bh, -1), bk=e.decode_key_block,
        pk=e.key_block, bq=e.query_block, ratio=e.pruning_ratio)


def recurrent_phase(arch, n_seq, results, blocks, layers=None):
    """``[zamba2-…]`` / ``[xlstm-…]``: a recurrent model at published
    widths and full depth, or ``layers`` deep (random bf16 weights from
    seed 0; the Mamba2
    ``a_log`` / ``dt_bias`` / ``d_skip`` f32), served from the contiguous
    cache through sequential admission waves: RECURRENT_REQUESTS prompts
    of RECURRENT_PROMPT tokens admitted together (one wave of
    RECURRENT_PROMPT − 1 whole-batch decode steps under an ``active``
    mask), 32 greedy tokens each, max_len RECURRENT_MAX_LEN, graphed;
    the prompts' first 64 tokens through a graphed and an eager engine
    with equal streams. zamba2's shared block decodes
    through B5 / B6 (13 launches each a decode step, waves included; head
    dim 112 on the d-128 kernels, G 1), no other kernel; B5–B8 held
    against their plain versions on group 0's shared cache after the
    drain; ``loss`` over ``n_seq`` × 2048 tokens (B9 / B10 13 each) and
    B9–B11 on the first shared block's q/k/v. xlstm runs no kernel at
    all (every count 0). Decode ticks under the profiler. Returns each
    run's results by phase name."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.models import LMModel
    from repro_torch.runtime import ServeLoop

    short = arch.split("-")[0]
    label = f"{short}-serve"
    cfg = get_serve_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    card = card_line(short)
    peaks = {}
    t0 = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=0)
    sync()
    peaks["init"] = _peak_gb()
    n_params = sum(w.numel() for w in _leaves(params))
    n_bytes = sum(w.numel() * w.element_size() for w in _leaves(params))
    need(not model.supports_prefill and not model.supports_paged,
         f"{arch} is not served by sequential waves")
    _, fused, _ = layer_paths(model)
    depth = "" if layers is None else (
        f" of {get_serve_config(arch).num_layers}")
    log(f"[{label}] {cfg.name} ({cfg.family}): {cfg.num_layers}{depth} "
        f"layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads, vocab "
        f"{cfg.vocab_size}, impl {cfg.energon.impl!r}; {n_params / 1e9:.3f} "
        f"B parameters ({n_bytes / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s; attention sites {fused}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size - 1,
                            size=RECURRENT_PROMPT).tolist()
               for _ in range(RECURRENT_REQUESTS)]
    kw = dict(batch_slots=RECURRENT_REQUESTS, max_len=RECURRENT_MAX_LEN,
              eos_token=-1, seed=0, device=DEV)
    engine = ServeLoop(model, params, **kw)
    need(engine.cuda_graphs and not engine.paged and len(engine.graphs) == 1,
         "the recurrent engine is not one graphed contiguous decode step")
    captured, calls = {}, [0]
    real = ops.fused_decode_attention

    def capturing(q, *args, **kwargs):
        if calls[0] % max(fused, 1) == 0:       # group 0's shared block
            captured["decode"] = (q.clone(), args[4].clone())
        calls[0] += 1
        return real(q, *args, **kwargs)

    ops.fused_decode_attention = capturing
    try:
        engine.capture_graphs()
        graph = log_graphs(f"[graph] {short} engine", engine)
        _build.reset_launch_counts()
        done, wall = drain(engine, prompts, 32)
        launches = dict(_build.launch_counts)
    finally:
        ops.fused_decode_attention = real
    peaks["serve"] = _peak_gb()
    run1 = drain_stats(engine, done, wall)
    log_drain(label, "graphed engine, sequential waves", run1)
    streams = {r.uid: list(r.tokens_out) for r in done}
    steps = run1["decode_dispatches"] + run1["prefill_dispatches"]
    log(f"[{label}] kernel launches: {json.dumps(launches)}")
    need(run1["prefill_dispatches"] == RECURRENT_PROMPT - 1,
         f"one wave of {RECURRENT_PROMPT}-token prompts took "
         f"{run1['prefill_dispatches']} dispatches, not "
         f"{RECURRENT_PROMPT - 1}")
    for name in KERNELS:
        want = (fused * steps if name in ("mpmrf_decode_filter_scores",
                                          "decode_gather_attention") else 0)
        need(launches[name] == want,
             f"[{label}] {name} launched {launches[name]} times, not {want}"
             f" ({fused} attention sites × {steps} decode steps)")
    log(f"[{label}] launches a decode step (waves included): B5/B6 "
        f"{fused} each, every other kernel 0; greedy streams sha1 "
        f"{streams_digest(streams)}; peak device memory "
        f"{peaks['serve']:.2f} GB")
    run1.update(graph=graph, launches=launches, launches_per_step=fused,
                streams_sha1=streams_digest(streams), parameters=n_params,
                card=card)
    if DEV == "cuda":
        run1["profile_decode"] = profile_decode(
            engine, [], n_req=RECURRENT_REQUESTS,
            prompt_len=RECURRENT_PROFILE_PROMPT,
            label=f"profile-decode-{short}")
    if fused:
        case = shared_block_case(engine, captured["decode"])
        del engine
        _free_device()
        check_contiguous(case, f"{short}-captured-shared0", results)
        del case
    else:
        del engine
    _free_device()
    short_prompts = [p[:RECURRENT_EAGER["prompt_len"]] for p in prompts]
    run1["eager"] = eager_drain(
        model, params, short_prompts, None, label=f"{short}-eager",
        paged=None, max_len=RECURRENT_MAX_LEN,
        new_tokens=RECURRENT_EAGER["new_tokens"])
    peaks["eager"] = _peak_gb()
    out = {label: run1}

    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # xLSTM's sLSTM runs 2048 cell steps a layer from the host: not
    # profiled (the profiler's cost per event would dominate)
    scoring, qkv = score_full_width(model, params, n_seq=n_seq,
                                    label=f"{short}-score",
                                    profile=bool(fused))
    peaks["score"] = _peak_gb()
    if fused:
        scoring["captured"] = check_full_sequence(
            *qkv, f"{short}-captured-shared0", results, **blocks)
    out[f"{short}-score"] = scoring
    del model, params, qkv
    _free_device()
    peaks = {k: float(v) for k, v in peaks.items()}
    log(f"[{short}] device-memory peaks (GB) {json.dumps(peaks)}")
    need(DEV != "cuda" or max(peaks.values()) <= PEAK_LIMIT_GB,
         f"[{short}] a phase peaked past {PEAK_LIMIT_GB} GB: {peaks}")
    run1["peaks_gb"] = peaks
    return out


def new_family_phases(results, blocks):
    """Phases 23–26: musicgen-medium, llava-next-34b, zamba2-7b and
    xlstm-1.3b, each model released before the next."""
    out = {}
    for arch, layers, serve_kw, score_kw in FAMILY_PHASES:
        out.update(family_phase(arch, layers, serve_kw, score_kw, results,
                                blocks))
    for arch, n_seq, layers in RECURRENT_PHASES:
        out.update(recurrent_phase(arch, n_seq, results, blocks, layers))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


#: qwen3-14b's depth in ``[train]``: the deepest whose phase peak stays
#: within ``PEAK_LIMIT_GB`` (width never cut)
TRAIN_LAYERS = 6
#: the ``[train]`` traffic: launch/train.py's arguments
TRAIN_RUN = dict(steps=4, seq_len=2048, global_batch=4, microbatches=2,
                 lr=3e-4)
#: the ``[train]`` corpus (zipf tokens): one ``default_rng`` a token on
#: the host, so kept small; 4 steps of 4 × 2049-token windows
TRAIN_CORPUS = 50_000
#: the resumed steps' losses against the uninterrupted run's: the
#: backward's scatter-adds (the embedding's, the gathers') sum in bf16
#: in an order the atomics choose, so two runs part in the last bits
TRAIN_LOSS_RTOL = 5e-3
#: the dense bf16 peak of one H100 SXM (NVIDIA's data sheet, without
#: sparsity, at 700 W), for 6·N·tokens/s as a share of it
#: ``[train-lm]``: 60 steps of 8 × 512 tokens on a 50k-token zipf
#: corpus, and the reference's test_training_learns margin. Over a
#: 32768-token vocabulary no (prev, cur) context of the order-2 chain
#: recurs inside the corpus (199973 distinct of 199999 at 200k tokens:
#: tests/test_torch_data.py), so the model learns only from seeing the
#: same windows again: ≈ 5 visits a token at 50k, ≈ 1.2 at 200k, where
#: the loss only falls toward the uniform ln 32768 = 10.397, within
#: noise of the margin: that run is printed, not gated
TRAIN_LM_STEPS, TRAIN_LM_CORPUS, TRAIN_LM_MARGIN = 60, 50_000, 0.25


def state_digest(params, opt_state) -> dict:
    """An exact 64-bit digest of each leaf's bits of a train state
    (params and AdamW state): Σ bitsᵢ · wᵢ mod 2^64 with odd weights wᵢ
    of the position, on the device in slices. A change of any one
    element changes it (an odd weight times a nonzero difference below
    2^32 is nonzero mod 2^64)."""
    import torch

    from repro_torch.optim.adamw import tree_leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    tree = {"params": params, "step": opt_state.step, "mu": opt_state.mu,
            "nu": opt_state.nu}
    out = {}
    for name, leaf in tree_leaves(tree):
        flat = leaf.detach().reshape(-1).view(ints[leaf.element_size()])
        acc = torch.zeros((), dtype=torch.int64, device=leaf.device)
        for start in range(0, flat.numel(), 1 << 26):
            part = flat[start:start + (1 << 26)].to(torch.int64)
            pos = torch.arange(start, start + part.numel(),
                               dtype=torch.int64, device=leaf.device)
            acc += (part * (pos * 0x1E3779B97F4A7C15 + 0x632BE5AB | 1)).sum()
        out[name] = int(acc)
    return out


def _record_steps(loop, stop_after=None):
    """Wrap ``loop.step_fn`` to keep each step's loss, grad norm and lr
    (and request a preemption after ``stop_after`` steps)."""
    seen = []
    real = loop.step_fn

    def step(*args):
        out = real(*args)
        seen.append({k: float(out[2][k]) for k in ("loss", "grad_norm",
                                                    "lr")})
        if stop_after is not None and len(seen) == stop_after:
            loop.preemption.request_stop()
        return out

    loop.step_fn = step
    return seen


def _param_count(cfg) -> int:
    from repro_torch.models import LMModel

    return sum(math.prod(s) for s in _leaves(
        LMModel(cfg, device="meta").param_shapes()))


def train_phase(layers=TRAIN_LAYERS):
    """``[train]``: qwen3-14b at full width cut to ``layers``, through
    launch/train.py's loop (bf16, remat full, mpmrf_block ρ 4 from layer
    2; 4 steps of 4 × 2048 tokens in 2 microbatches): the uninterrupted
    run, then a run preempted after step 2 (its checkpoint at step 2 in
    a temporary directory) and a fresh loop that resumes from it and
    writes no checkpoint of its own (one of ≈ 35 GB fits the machine's
    45 GiB of disk writes a call; two do not)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import list_checkpoints, step_dir
    from repro_torch.core.performance_model import H100_PEAK_FLOPS_BF16
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train

    full = get_config("qwen3-14b")
    cfg = dataclasses.replace(full, num_layers=layers)
    smi = card_line("train")
    n_params = _param_count(cfg)
    tokens = TRAIN_RUN["global_batch"] * TRAIN_RUN["seq_len"]
    log(f"[train] {cfg.name} at full width (d {cfg.d_model}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), depth cut to {layers} "
        f"of {full.num_layers} layers: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.dtype}, remat {cfg.remat}, {cfg.energon.impl} ρ "
        f"{cfg.energon.pruning_ratio} from layer "
        f"{cfg.energon.min_prune_layer}; {TRAIN_RUN}")
    kw = dict(TRAIN_RUN, device=DEV, corpus=TRAIN_CORPUS, log_every=1)
    out = dict(layers=layers, of=full.num_layers, params=n_params, card=smi)

    # the uninterrupted run
    _free_device()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    loop = launch_train.make_loop(cfg, **kw)
    whole = _record_steps(loop)
    t0 = time.perf_counter()
    res = loop.run()
    wall = time.perf_counter() - t0
    peak = _peak_gb()
    need(res["final_step"] == TRAIN_RUN["steps"] and len(whole) == 4,
         f"[train] ran {res['final_step']} steps")
    need(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
             for s in whole), f"[train] non-finite loss or grad norm: {whole}")
    step_s = res["median_step_time"]
    tok_s = tokens / step_s
    share = 6 * n_params * tok_s / H100_PEAK_FLOPS_BF16
    for i, s in enumerate(whole, 1):
        log(f"[train] step {i}: loss {s['loss']!r} grad_norm "
            f"{s['grad_norm']!r} lr {s['lr']:.3e} "
            f"({res['history'][i - 1]['sec'] * 1e3:.1f} ms)")
    log(f"[train] median step {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, "
        f"6·N·tokens/s = {share * 100:.2f} % of the bf16 dense peak "
        f"({H100_PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s), peak {peak:.1f} GB, "
        f"wall {wall:.1f} s (4 steps, the first with the allocator's "
        f"growth) [{smi}]")
    need(peak <= PEAK_LIMIT_GB,
         f"[train] peak {peak:.1f} GB over {PEAK_LIMIT_GB} GB")
    out.update(steps=whole, step_ms=step_s * 1e3, tok_s=tok_s,
               flops_share=share, peak_gb=peak, wall_s=wall,
               step_ms_each=[h["sec"] * 1e3 for h in res["history"]])
    out["profile"] = profile_train_step(loop, res["params"],
                                        res["opt_state"])
    del loop, res
    _free_device()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # preempted after step 2: the loop saves step 2 as it stops
        loop = launch_train.make_loop(cfg, checkpoint_dir=tmp,
                                      checkpoint_every=10**9, **kw)
        first = _record_steps(loop, stop_after=2)
        t0 = time.perf_counter()
        res = loop.run()
        saved_s = time.perf_counter() - t0
        need(res["final_step"] == 2
             and [s for s, _ in list_checkpoints(tmp)] == [2],
             f"[train] the preempted run stopped at {res['final_step']}, "
             f"checkpoints {list_checkpoints(tmp)}")
        digest = state_digest(res["params"], res["opt_state"])
        del loop, res
        _free_device()
        size = sum(os.path.getsize(os.path.join(step_dir(tmp, 2), f))
                   for f in ("arrays.npz", "manifest.json"))

        # a fresh loop resumes from the step-2 checkpoint
        loop = launch_train.make_loop(cfg, checkpoint_dir=tmp,
                                      checkpoint_every=10**9, **kw)
        real_init = loop._init_state
        restored = {}

        def init_and_check():
            t0 = time.perf_counter()
            params, opt, start = real_init()
            restored.update(start=start, data=dict(loop.dataset.state),
                            seconds=time.perf_counter() - t0,
                            equal=state_digest(params, opt) == digest)
            # the card's machine takes 45 GiB of disk writes a call: the
            # phase writes the one checkpoint, so the resumed run (which
            # would save again as it ends) saves none of its own
            loop.checkpointer = None
            return params, opt, start

        loop._init_state = init_and_check
        resumed = _record_steps(loop)
        res = loop.run()
        need(restored.get("start") == 2 and restored["data"] == {"step": 2},
             f"[train] resumed at {restored}")
        need(restored["equal"], "[train] the restored state differs from "
             "the saved one")
        need(res["final_step"] == 4 and len(resumed) == 2,
             f"[train] the resumed run ended at {res['final_step']}")
        del loop, res
        _free_device()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = [s["loss"] for s in whole[2:]]
    got = [s["loss"] for s in resumed]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    log(f"[train] preempted after step 2 (losses {[s['loss'] for s in first]!r}"
        f"; the uninterrupted run's {[s['loss'] for s in whole[:2]]!r}), "
        f"checkpoint {size / 1e9:.2f} GB in {saved_s:.1f} s of that run's "
        f"wall; a fresh loop restored step 2 in {restored['seconds']:.1f} s, "
        f"every leaf's bits equal to the saved state's (exact digest)")
    log(f"[train] resumed steps 3–4: losses {got!r} vs uninterrupted "
        f"{ref!r}, |Δ|/|ref| {max(rel):.2e} (tolerance {TRAIN_LOSS_RTOL})")
    need(max(rel) <= TRAIN_LOSS_RTOL,
         f"[train] resumed losses {got} vs {ref}")
    need(all(math.isfinite(s["grad_norm"]) for s in first + resumed),
         "[train] non-finite grad norm after the resume")
    out.update(preempted=first, resumed=resumed, resume_rel=max(rel),
               checkpoint_gb=size / 1e9, preempted_wall_s=saved_s,
               restore_s=restored["seconds"])
    return out


# --------------------------------------------------------------------------
# training over a (data, model) mesh of the one card (ROADMAP A5)
# --------------------------------------------------------------------------

#: the ``(data, model)`` mesh the mesh phases train on: ``cuda:0`` × 4
MESH_TRAIN_GRID = (2, 2)
#: qwen3-14b's depth in ``[mesh-train]``: the deepest whose phase peak
#: (the one-device run's and the mesh run's) stays within PEAK_LIMIT_GB:
#: at 6 the one-device run peaks 65.66 GB, the mesh run 62.91, and a 7th
#: layer adds ≈ 5.3 GB (``[train]``)
MESH_TRAIN_LAYERS = 6
#: ``[mesh-train]``'s traffic: two steps of launch/train.py's loop, each
#: microbatch's 2 sequences one a data row
MESH_TRAIN_RUN = dict(steps=2, seq_len=2048, global_batch=4, microbatches=2,
                      lr=3e-4)
#: the first step's mesh loss against the one-device loss: the model is
#: bf16, and a row-parallel partial (``wo``, ``w_down``) rounds to bf16
#: per shard before the f32 sum over 'model', where one device rounds the
#: whole product once (CPU rehearsal at smoke widths in bf16: 4e-5)
MESH_LOSS_RTOL = 2e-3
#: the updated parameters against the one-device run's: every element
#: within 2·steps·lr (tests/test_torch_train_loop.py's bound: a step
#: moves a weight by ≈ lr·sign(g), and a gradient within a rounding of 0
#: may flip); the share off by more than 2e-5 is that test's 0.1 % in
#: f32, but a bf16 weight's ulp is above 2e-5 from |w| ≥ 2^-9, so a
#: flipped or re-rounded update counts: gated at 5 % (CPU rehearsal at
#: smoke widths in bf16: 0.42 %; the card at 6 layers: 1.83 %, every
#: element within the bound)
MESH_PARAM_ATOL, MESH_PARAM_SHARE = 2e-5, 0.05
#: ``[mesh-train-moe]``: olmoe-1b-7b's depth (peak 28.96 GB at 4), its
#: batch (4 × 1024: one data row holds 2 sequences) and the loss
#: tolerance with the int8 expert gathers against the one-device run
#: (weights within 1/254 of each row's max)
MESH_MOE_LAYERS = 4
MESH_MOE_BATCH, MESH_MOE_SEQ = 4, 1024
MESH_MOE_QUANT_RTOL = 2e-2


def _host_leaves(params):
    """``path → CPU tensor`` of a (logical) parameter tree."""
    from repro_torch.optim.adamw import tree_leaves

    return {k: v.detach().to("cpu") for k, v in tree_leaves(params)}


def mesh_train_phase(layers=MESH_TRAIN_LAYERS, grid=MESH_TRAIN_GRID,
                     run=MESH_TRAIN_RUN, label="mesh-train"):
    """``[mesh-train]``: qwen3-14b at full width cut to ``layers`` through
    launch/train.py's loop (bf16, remat full, mpmrf_block ρ 4 from layer
    2): the ``run``'s steps on one device, then the same steps on a
    ``grid`` mesh of ``cuda:0`` (``(2, 2)``: ZeRO over 'data', heads /
    MLP / vocabulary over 'model'; with three sizes ``(pod, data,
    model)``, the batch over the pod × data rows, pod major, ZeRO over
    'data' alone; the rows run one after another). The first step's
    losses agree within ``MESH_LOSS_RTOL``, the updated parameters as
    ``MESH_PARAM_*`` say, each device addresses the bytes
    ``param_shardings`` gives it, and both runs peak within
    ``PEAK_LIMIT_GB``. No CUDA kernel runs (no kernel has a backward)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LMModel

    full = get_config("qwen3-14b")
    cfg = dataclasses.replace(full, num_layers=layers)
    smi = card_line(label)
    mesh = _sim_mesh(grid)
    kw = dict(run, device=DEV, corpus=TRAIN_CORPUS, log_every=1)
    n_params = _param_count(cfg)
    log(f"[{label}] {cfg.name} at full width (d {cfg.d_model}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), depth cut to {layers} of {full.num_layers}: "
        f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}; {run}; mesh "
        f"{mesh}, {len(mesh.rows)} data rows")
    out = dict(layers=layers, of=full.num_layers, params=n_params,
               grid=list(grid), card=smi)
    runs = {}
    launches = {}
    for name, m in (("one-device", None), ("mesh", mesh)):
        _free_device()
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        loop = launch_train.make_loop(cfg, mesh=m, **kw)
        seen = _record_steps(loop)
        t0 = time.perf_counter()
        res = loop.run()
        wall = time.perf_counter() - t0
        peak = _peak_gb()
        launches[name] = sum(_build.launch_counts.values())
        need(res["final_step"] == run["steps"] and len(seen) == run["steps"],
             f"[{label}] {name} ran {res['final_step']} steps")
        need(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                 for s in seen), f"[{label}] {name}: non-finite {seen}")
        step_ms = [h["sec"] * 1e3 for h in res["history"]]
        runs[name] = dict(steps=seen, step_ms=step_ms, peak_gb=peak,
                          wall_s=wall)
        log(f"[{label}] {name}: losses "
            f"{[s['loss'] for s in seen]!r}, grad norms "
            f"{[s['grad_norm'] for s in seen]!r}, steps "
            f"{', '.join(f'{x:.1f}' for x in step_ms)} ms (the first with "
            f"the allocator's growth), peak {peak:.2f} GB [{smi}]")
        need(peak <= PEAK_LIMIT_GB,
             f"[{label}] {name} peak {peak:.1f} GB over {PEAK_LIMIT_GB}")
        if m is None:
            ref = _host_leaves(res["params"])
        else:
            got = shd.device_bytes(res["params"], mesh)
            flat = [(c, b) for c, b in zip(mesh.coords(), _leaves_of(got))]
            model = LMModel(cfg, device="meta")
            want = shd.reckoned_bytes(model.param_shapes(),
                                      model.param_dtypes(), mesh)
            held = sum(t.numel() * t.element_size()
                       for _, leaf in shd.sharded_leaves(res["params"])
                       for t in leaf.shards.values())
            log(f"[{label}] shard bytes by device "
                f"({', '.join(mesh.axis_names)}): "
                + ", ".join(f"{c} {b / 1e9:.4f} GB" for c, b in flat)
                + f"; param_shardings' reckoning {want / 1e9:.4f} GB each; "
                f"held once on the card {held / 1e9:.4f} GB (a replicated "
                f"shard once)")
            need(all(b == want for _, b in flat),
                 f"[{label}] shard bytes {got} vs reckoning {want}")
            out.update(device_bytes=got, reckoned_bytes=want, held_bytes=held)
            new = _host_leaves(shd.gather_tree(res["params"], "cpu"))
        del loop, res
        _free_device()
    one, many = runs["one-device"], runs["mesh"]
    l1, l2 = one["steps"][0]["loss"], many["steps"][0]["loss"]
    rel = abs(l2 - l1) / abs(l1)
    bound = 2 * run["steps"] * run["lr"]
    off = total = 0
    worst = 0.0
    for key, a in ref.items():
        d = (new[key].float() - a.float()).abs()
        off += int((d > MESH_PARAM_ATOL).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
    share = off / total
    log(f"[{label}] first step's loss: mesh {l2!r} vs one device {l1!r}, "
        f"|Δ|/|ref| {rel:.2e} (tolerance {MESH_LOSS_RTOL})")
    log(f"[{label}] params after {run['steps']} steps: {share:.4%} of "
        f"{total} elements off by > {MESH_PARAM_ATOL} (gate "
        f"{MESH_PARAM_SHARE:.0%}), max |Δ| {worst:.3e} (bound 2·steps·lr = "
        f"{bound:.1e})")
    log(f"[{label}] step ms: mesh {many['step_ms'][1]:.1f} vs one device "
        f"{one['step_ms'][1]:.1f} (second steps; x"
        f"{many['step_ms'][1] / one['step_ms'][1]:.2f}); peaks "
        f"{many['peak_gb']:.2f} / {one['peak_gb']:.2f} GB; CUDA kernel "
        f"launches {launches} [{smi}]")
    need(rel <= MESH_LOSS_RTOL, f"[{label}] loss {l2} vs {l1}")
    need(share <= MESH_PARAM_SHARE and worst <= bound,
         f"[{label}] params: {share:.4%} off, max {worst}")
    need(not any(launches.values()),
         f"[{label}] a kernel of the port ran: {launches}")
    out.update(runs, loss_rel=rel, param_share_off=share,
               param_max_abs=worst, launches=launches)
    return out


def _leaves_of(nested):
    """A nested list's leaves, row-major."""
    if isinstance(nested, list):
        return [x for part in nested for x in _leaves_of(part)]
    return [nested]


def _row_split_loss(model, params, batch, rows):
    """The one-device loss with the mesh's per-row capacity: each data
    row's tokens through the single-device model on their own (an MoE
    call's capacity from its rows), the token losses summed over the
    rows over the batch's count, plus the rows' mean aux loss."""
    import torch

    per = batch["inputs"].shape[0] // rows
    nll = aux = 0.0
    for r in range(rows):
        part = {k: torch.as_tensor(v[r * per:(r + 1) * per]).to(DEV)
                for k, v in batch.items()}
        with torch.no_grad():
            _, m = model.loss(params, part)
        nll += float(m["ce"]) * float(m["tokens"])
        aux += float(m["aux"]) / rows
    return nll / batch["targets"].size + aux


def mesh_train_moe_phase(layers=MESH_MOE_LAYERS):
    """``[mesh-train-moe]``: olmoe-1b-7b at full width cut to ``layers``
    on the ``(2, 2)`` mesh: ZeRO over 'data' and its 64 experts over
    'model' (EP), each data row with its own capacity; one train step
    with exact and with int8 expert gathers (``quantized_weight_gather``),
    each step's loss against the one-device loss of the same per-row
    capacity (``_row_split_loss``), and layer 0's drop fraction."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.runtime import make_train_step

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=layers)
    smi = card_line("mesh-train-moe")
    mesh = _sim_mesh(MESH_TRAIN_GRID)
    rows = MESH_TRAIN_GRID[0]
    ds = TokenDataset(cfg.vocab_size, seq_len=MESH_MOE_SEQ,
                      global_batch=MESH_MOE_BATCH, source="zipf",
                      corpus_tokens=TRAIN_CORPUS)
    batch = next(ds)
    _free_device()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=0)
    ref = _row_split_loss(model, params, batch, rows)
    with torch.no_grad():           # layer 0's MoE on the batch, per row
        x = model._embed(params, torch.as_tensor(batch["inputs"]).to(DEV))
        blk = {k: v[0] for k, v in params["blocks"]["norm_mlp"].items()}
        moe0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
        _, met = moe_lib.apply_moe_sharded(
            moe0, L.apply_norm(cfg.norm, blk, x), model._moe_cfg(), mesh)
    drop = float(met["moe_drop_fraction"])
    log(f"[mesh-train-moe] {cfg.name} at full width (d {cfg.d_model}, "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token} of d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}), depth cut to {layers} of "
        f"{full.num_layers}, {cfg.dtype}; {MESH_MOE_BATCH} × {MESH_MOE_SEQ} "
        f"tokens on {mesh}; one-device loss at the rows' capacity {ref!r}; "
        f"layer 0's drop fraction {drop:.4f} (capacity factor "
        f"{cfg.capacity_factor}, {MESH_MOE_BATCH // rows} sequences a row)")
    out = dict(layers=layers, of=full.num_layers, one_device_loss=ref,
               drop_fraction_layer0=drop, card=smi)
    specs = shd.param_shardings(params, mesh)
    for quantized in (False, True):
        qcfg = dataclasses.replace(cfg, moe_quantized_gather=quantized)
        qmodel = LMModel(qcfg, device=DEV)
        placed = shd.shard_tree(params, specs, mesh)
        opt = AdamWConfig(learning_rate=3e-4)
        state = adamw.init(placed, opt)
        step = make_train_step(qmodel, opt, mesh=mesh)
        _build.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        placed, state, m = step(placed, state, batch)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(m["loss"])
        rel = abs(loss - ref) / abs(ref)
        tol = MESH_MOE_QUANT_RTOL if quantized else MESH_LOSS_RTOL
        name = "int8 gathers" if quantized else "exact gathers"
        launches = sum(_build.launch_counts.values())
        log(f"[mesh-train-moe] {name}: loss {loss!r} (aux {float(m['aux'])!r})"
            f" vs one device {ref!r}, |Δ|/|ref| {rel:.2e} (tolerance {tol}), "
            f"grad norm {float(m['grad_norm'])!r}, step {ms:.1f} ms (its "
            f"first: allocations included), CUDA kernel launches {launches} "
            f"[{smi}]")
        need(math.isfinite(float(m["grad_norm"])) and rel <= tol,
             f"[mesh-train-moe] {name}: loss {loss} vs {ref}")
        need(launches == 0, f"[mesh-train-moe] a kernel ran: {launches}")
        out["int8" if quantized else "exact"] = dict(
            loss=loss, rel=rel, grad_norm=float(m["grad_norm"]), step_ms=ms)
        del placed, state, step
        _free_device()
    peak = _peak_gb()
    log(f"[mesh-train-moe] peak {peak:.2f} GB")
    need(peak <= PEAK_LIMIT_GB, f"[mesh-train-moe] peak {peak:.1f} GB")
    out["peak_gb"] = peak
    del model, params
    _free_device()
    return out


def mesh_train_resume_phase(written=MESH_TRAIN_GRID,
                            restored=((1, 1), (4, 1)),
                            label="mesh-train-resume"):
    """``[mesh-train-resume]``: qwen3-14b's smoke widths in bf16 train two
    steps on the ``written`` mesh (``(2, 2)``, or a ``(pod, data,
    model)`` mesh) and checkpoint (the logical arrays and the mesh's
    fingerprint); loops on each ``restored`` mesh restore it, their
    gathered state bit-equal to the saved one (exact digest), and each
    trains one more step. Small widths: ``[train]`` writes the call's one
    large checkpoint."""
    import json as _json
    import shutil
    import tempfile

    from repro_torch.checkpoint import step_dir
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.elastic import mesh_fingerprint
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.train_loop import gather_state

    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"),
                              dtype="bfloat16")
    kw = dict(seq_len=256, global_batch=4, lr=3e-4, device=DEV,
              corpus=20_000, log_every=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out = {}
    try:
        mesh = _sim_mesh(written)
        loop = launch_train.make_loop(cfg, steps=2, checkpoint_dir=tmp,
                                      checkpoint_every=2, mesh=mesh, **kw)
        res = loop.run()
        saved = state_digest(*gather_state(res["params"], res["opt_state"],
                                           DEV))
        with open(os.path.join(step_dir(tmp, 2), "manifest.json")) as f:
            fingerprint = _json.load(f)["mesh"]
        need(fingerprint == mesh_fingerprint(mesh),
             f"[{label}] manifest mesh {fingerprint}")
        for shape in restored:
            loop = launch_train.make_loop(cfg, steps=3, checkpoint_dir=tmp,
                                          mesh=_sim_mesh(shape), **kw)
            params, opt, start = loop._init_state()
            equal = state_digest(*gather_state(params, opt, DEV)) == saved
            _, _, m = loop.step_fn(params, opt, next(loop.dataset))
            loss = float(m["loss"])
            log(f"[{label}] written on {tuple(written)} ({fingerprint}), "
                f"restored on {shape}: step {start}, every logical leaf's "
                f"bits equal {equal}; its next step's loss {loss!r}")
            need(start == 2 and equal,
                 f"[{label}] {shape}: start {start}, equal {equal}")
            need(math.isfinite(loss), f"[{label}] loss {loss}")
            out["x".join(map(str, shape))] = dict(equal=equal,
                                                  next_loss=loss)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free_device()
    return out


# --------------------------------------------------------------------------
# the three-axis mesh (ROADMAP A5b): pod data parallelism, the GPipe
# pipeline over 'pod'
# --------------------------------------------------------------------------

#: the ``(pod, data, model)`` mesh ``[pod-train]`` trains on: cuda:0 × 4
POD_TRAIN_GRID = (2, 2, 1)
#: qwen3-14b's depth in ``[pod-train]``: its one 4-sequence microbatch
#: (a sequence a row) peaks 57.73 GB on one device and 52.13 on the mesh
#: at 4 layers, 61.11 / 55.52 at 5 (an H100 80GB HBM3 at 700 W); 4 keeps
#: the phase short
POD_TRAIN_LAYERS = 4
#: ``[pod-train]``'s traffic: two steps of one 4-sequence microbatch, a
#: sequence a pod × data row; the one-device run takes the same step
POD_TRAIN_RUN = dict(steps=2, seq_len=2048, global_batch=4, microbatches=1,
                     lr=3e-4)


#: ``[pipeline]``: qwen3-14b's depth at full width, its stages (the
#: ``pod`` axis of cuda:0 × 4) and microbatches of [1, 2048] hidden states
PIPELINE_LAYERS, PIPELINE_STAGES, PIPELINE_MICRO = 8, 4, 6
PIPELINE_SEQ = 2048
SCORE_PAIR = ("mpmrf_filter_scores", "block_sparse_attention")


def pipeline_phase(layers=PIPELINE_LAYERS, stages=PIPELINE_STAGES,
                   micro=PIPELINE_MICRO):
    """``[pipeline]``: qwen3-14b at full width, ``layers`` of 40, every
    layer sparse (``impl="pallas"``, ``min_prune_layer`` 0: B9 then B10
    in each), as ``stages`` GPipe stages over a ``("pod",)`` mesh of
    ``cuda:0`` × ``stages`` (``distributed/pipeline.py``): each stage
    ``transformer.apply_stack`` over its slab of the stacked blocks,
    ``micro`` microbatches of ``[1, 2048, d]`` bf16 hidden states. The
    outputs equal, bit for bit, ``apply_stack`` of the ``layers`` layers
    on each microbatch; B9 and B10 launch layers × microbatches times in
    the pipeline's run (counts zeroed just before it, read just after),
    and no other kernel."""
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.distributed.pipeline import (
        pipeline_forward, split_layers_to_stages)
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.models import transformer as tfm

    base = get_serve_config("qwen3-14b")
    cfg = dataclasses.replace(base, num_layers=layers,
                              energon=dataclasses.replace(
                                  base.energon, impl="pallas",
                                  min_prune_layer=0))
    smi = card_line("pipeline")
    _free_device()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=0)
    block_fn = model._tfm_block_fn()

    def stage_fn(slab, x):
        return tfm.apply_stack(slab, x, None, block_fn)[0]

    gen = torch.Generator(device=DEV).manual_seed(21)
    mb = torch.randn((micro, 1, PIPELINE_SEQ, cfg.d_model), generator=gen,
                     device=DEV).to(model.dtype)
    mesh = _sim_mesh((stages,), ("pod",))
    slabs = split_layers_to_stages(params["blocks"], stages)
    with torch.no_grad():
        stage_fn(params["blocks"], mb[0])          # warm-up, uncounted
        sync()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipeline_forward(stage_fn, slabs, mb, mesh, axis="pod")
        sync()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.launch_counts)
        t0 = time.perf_counter()
        want = torch.stack([stage_fn(params["blocks"], x) for x in mb])
        sync()
        seq_ms = (time.perf_counter() - t0) * 1e3
    peak = _peak_gb()
    equal = torch.equal(out, want)
    n = layers * micro
    log(f"[pipeline] {cfg.name} at full width, {layers} of "
        f"{base.num_layers} layers as {stages} stages of "
        f"{layers // stages} over {mesh}; {micro} microbatches of [1, "
        f"{PIPELINE_SEQ}, {cfg.d_model}] {cfg.dtype}: outputs equal to "
        f"apply_stack's on each microbatch, bit for bit: {equal}; "
        f"{pipe_ms:.1f} ms (sequential apply_stack {seq_ms:.1f} ms; the "
        f"stages share one card); peak {peak:.2f} GB [{smi}]")
    log(f"[pipeline] launches: " + ", ".join(
        f"{KERNELS[k]['id']} {launches[k]}" for k in KERNELS)
        + f" (B9 / B10: {layers} layers × {micro} microbatches = {n})")
    need(equal and bool(torch.isfinite(out).all()),
         "[pipeline] the pipeline's outputs differ from apply_stack's")
    need(all(launches[k] == n for k in SCORE_PAIR),
         f"[pipeline] B9 / B10 launched {[launches[k] for k in SCORE_PAIR]}"
         f", not {n}")
    need(all(launches[k] == 0 for k in KERNELS if k not in SCORE_PAIR),
         f"[pipeline] another kernel launched: {launches}")
    need(peak <= PEAK_LIMIT_GB, f"[pipeline] peak {peak:.1f} GB")
    del model, params, slabs, mb, out, want
    _free_device()
    return dict(layers=layers, of=base.num_layers, stages=stages,
                microbatches=micro, equal=equal, ms=pipe_ms,
                sequential_ms=seq_ms, peak_gb=peak, launches=launches,
                card=smi)


def profile_train_step(loop, params, opt_state, label="profile-train"):
    """One more train step of ``loop``'s model and optimizer, on its next
    batch, under ``torch.profiler``: device time by kernel and the
    device's idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import make_train_step

    step = make_train_step(loop.model, loop.cfg.optimizer,
                           num_microbatches=loop.cfg.num_microbatches)
    batch = next(loop.dataset)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        sync()
        wall = time.perf_counter() - t0
    out = dict(wall_s=wall, **device_split(prof, wall, top=15))
    log(f"[{label}] one train step: wall {wall:.3f} s, device busy "
        f"{out['device_busy_s']:.3f} s over {out['kernels']} kernels, "
        f"idle {out['idle_share']:.1%} (under the profiler)")
    for r in out["top"]:
        log(f"[{label}] {r['device_ms']:10.2f} ms  x{r['calls']:<6d} "
            f"{r['name']}")
    need(not out["port"], f"[{label}] a kernel of the port ran: "
         f"{out['port']}")
    return out


def train_lm_phase(corpus=TRAIN_LM_CORPUS, gated=True):
    """``[train-lm]``: the 100M train_lm config at its full size (12L, d
    768, f32, remat dots, mpmrf_row from layer 2), 60 steps of 8 × 512
    on a ``corpus``-token corpus, warmup_cosine(3e-4, 6, 60); the loss
    must fall by ``TRAIN_LM_MARGIN`` where ``gated``."""
    import torch

    from repro_torch import train_lm

    label = f"train-lm-{corpus // 1000}k"
    smi = card_line(label)
    _free_device()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res = train_lm.run(steps=TRAIN_LM_STEPS, device=DEV,
                       corpus_tokens=corpus)
    peak = _peak_gb()
    hist = res["history"]
    losses = [(h["step"], h["loss"]) for h in hist]
    fell = hist[0]["loss"] - hist[-1]["loss"]
    step_s = res["median_step_time"]
    tok_s = res["batch"] * res["seq"] / step_s
    log(f"[{label}] {res['n_params'] / 1e6:.1f} M parameters, "
        f"{TRAIN_LM_STEPS} steps of {res['batch']} × {res['seq']} on "
        f"{corpus} corpus tokens: logged losses {losses!r}, fell by "
        f"{fell:.3f}{'' if gated else ' (recorded, not gated)'}; median "
        f"step {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, peak "
        f"{peak:.2f} GB, wall {res['seconds']:.1f} s [{smi}]")
    need(all(math.isfinite(l) for _, l in losses), f"[{label}] non-finite")
    need(not gated or fell >= TRAIN_LM_MARGIN,
         f"[{label}] loss {hist[0]['loss']} -> {hist[-1]['loss']}: fell "
         f"by less than {TRAIN_LM_MARGIN}")
    need(peak <= PEAK_LIMIT_GB, f"[{label}] peak {peak:.1f} GB")
    out = dict(params=res["n_params"], corpus=corpus, losses=losses,
               fell=fell, gated=gated, step_ms=step_s * 1e3, tok_s=tok_s,
               peak_gb=peak, wall_s=res["seconds"], card=smi)
    del res
    _free_device()
    return out


def pallas_grad_refused():
    """A ``pallas`` model's ``loss`` under grad raises on the card, as on
    the CPU, before any full-sequence kernel launches; without grad it
    scores through B9 / B10."""
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_serve_config("qwen3-14b", smoke=True),
                              dtype="bfloat16")
    model = LMModel(cfg, device=DEV)
    params = model.init(seed=0)
    gen = torch.Generator(device=DEV).manual_seed(3)
    toks = torch.randint(1, cfg.vocab_size, (2, 256), generator=gen,
                         device=DEV, dtype=torch.int32)
    batch = {"inputs": toks, "targets": toks}
    _build.reset_launch_counts()
    with torch.no_grad():
        loss, _ = model.loss(params, batch)
    scored = dict(_build.launch_counts)
    _build.reset_launch_counts()
    try:
        adamw.accumulate_gradients(model.loss, params, batch, 1)
    except NotImplementedError as exc:
        message = str(exc)
    else:
        raise SmokeFailure("[train] a pallas loss under grad was not refused")
    launched = {k: v for k, v in _build.launch_counts.items() if v}
    need("mpmrf_block" in message and not launched,
         f"[train] refusal {message!r}, launches {launched}")
    need(bool(torch.isfinite(loss)) and scored[SCORE_KERNELS[0]] > 0,
         f"[train] the pallas score without grad: {float(loss)}, {scored}")
    log(f"[train] pallas loss under grad refused before any launch "
        f"({message[:60]}…); without grad it scores through B9 "
        f"({scored[SCORE_KERNELS[0]]} launches)")
    return dict(refused=True, score_launches=scored)


# ---------------------------------------------------------------------------
# the analysis tools held against the card: [op-costs], [dryrun-peak]
# ---------------------------------------------------------------------------

#: predicted / measured peak device memory of a [dryrun-peak] cell
PEAK_RATIO = (0.9, 1.1)


def _ops_that_differ(a, b):
    """The ATen ops (and kernels) whose traffic or FLOPs differ between
    two walks: {name: (traffic a, traffic b, flops a, flops b)}."""
    out = {}
    for name in sorted(set(a.traffic_by_op) | set(b.traffic_by_op)):
        row = (a.traffic_by_op.get(name, 0.0), b.traffic_by_op.get(name, 0.0),
               a.flops_by_op.get(name, 0.0), b.flops_by_op.get(name, 0.0))
        if row[0] != row[1] or row[2] != row[3]:
            out[name] = row
    return out


def op_costs_phase(engine, decode_profile):
    """``[op-costs]``: one eager decode step and one eager prefill wave of
    phase 4's paged engine (its model, weights, pool and shapes: B slots,
    every slot 2048 tokens in, a chunk of ``prefill_chunk`` rows) walked
    by ``repro_torch.analysis.op_costs`` on the card, then on the meta
    device at the same shapes (the meta model's own pool). FLOPs, traffic
    and B1–B4's launches must be equal exactly on both (one program, its
    kernels priced from shapes), the card walk's launches those that
    ``_build.launch_counts`` counted in it, and no collective. Then each
    step's roofline bound (``analysis.roofline``, H100 data-sheet rates)
    beside the graphed tick's device ms of ``[profile-decode]``, and their
    ratio: printed, not gated."""
    import torch

    from repro_torch.analysis import build_report, compute_costs, param_counts
    from repro_torch.analysis.op_costs import meta_like
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel

    model, params = engine.model, engine.params
    cfg = model.cfg
    b, c, max_len = engine.batch_slots, engine.prefill_chunk, engine.max_len
    num_pages, mb = engine.layout.num_pages, engine.layout.max_blocks
    _, sparse_layers, _ = layer_paths(model)
    gen = torch.Generator(device=DEV).manual_seed(13)
    at = max_len // 2
    table = (torch.arange(b * mb, device=DEV).reshape(b, mb)
             % num_pages).to(torch.int32)
    index = torch.full((b,), at, dtype=torch.int32, device=DEV)

    def tokens(n):
        return torch.randint(1, cfg.vocab_size - 1, (b, n), generator=gen,
                             device=DEV, dtype=torch.int32)

    steps = (
        ("decode", "decode_step", SERVE_KERNELS[:2], b,
         {"tokens": tokens(1), "block_table": table,
          "active": torch.ones((b,), dtype=torch.bool, device=DEV)}),
        ("prefill", "prefill", SERVE_KERNELS[2:], b * c,
         {"tokens": tokens(c), "block_table": table,
          "positions": (at + torch.arange(c, device=DEV, dtype=torch.int32)
                        ).expand(b, c).contiguous()}),
    )
    meta = LMModel(cfg, device="meta")
    mcache = meta.init_paged_cache(num_pages, max_len=max_len)
    mparams = meta_like(params)
    n_active = param_counts(cfg)["active_non_embedding"]
    smi = card_line("op-costs")
    out = dict(card=smi)
    for kind, method, kernels, n_tok, inputs in steps:
        sync()
        _build.reset_launch_counts()
        card = compute_costs(getattr(model, method), params, engine.cache,
                             inputs, index)
        sync()
        counted = {k: v for k, v in _build.launch_counts.items() if v}
        on_meta = compute_costs(getattr(meta, method), mparams, mcache,
                                meta_like(inputs), meta_like(index))
        need(card.launches == counted,
             f"[op-costs] {kind}: the walk's launches {card.launches} are "
             f"not the wrappers' count {counted}")
        need(counted == {k: sparse_layers for k in kernels},
             f"[op-costs] {kind}: launches {counted}, not {sparse_layers} "
             f"of each of {kernels}")
        need(card.flops == on_meta.flops
             and card.traffic_bytes == on_meta.traffic_bytes
             and card.launches == on_meta.launches,
             f"[op-costs] {kind}: card FLOPs {card.flops!r} / bytes "
             f"{card.traffic_bytes!r} / launches {card.launches}, meta "
             f"{on_meta.flops!r} / {on_meta.traffic_bytes!r} / "
             f"{on_meta.launches}; ops that differ "
             f"{_ops_that_differ(card, on_meta)}")
        need(card.total_collective_bytes == 0,
             f"[op-costs] {kind}: collective bytes {card.collective_bytes}")
        report = build_report(
            arch=cfg.name, shape=f"{kind}-step", mesh_name="1x1", chips=1,
            parsed_flops=card.flops, parsed_traffic_bytes=card.traffic_bytes,
            parsed_collective_bytes=card.collective_bytes,
            model_flops=2.0 * n_active * n_tok)
        bound = report.bound_time_s * 1e3
        kernel_ms = sum(k.bound_ms for k in card.kernels.values())
        out[kind] = dict(
            flops=card.flops, traffic_bytes=card.traffic_bytes,
            launches=card.launches, ops=card.num_ops,
            peak_live_gb=card.peak_live_bytes / 1e9,
            meta_peak_live_gb=on_meta.peak_live_bytes / 1e9,
            walk_s=card.seconds, meta_walk_s=on_meta.seconds,
            bound_ms=bound, dominant=report.dominant,
            compute_ms=report.compute_s * 1e3,
            memory_ms=report.memory_s * 1e3, kernels_bound_ms=kernel_ms,
            top_traffic={k: v for k, v in sorted(
                card.traffic_by_op.items(), key=lambda kv: -kv[1])[:6]})
        log(f"[op-costs] {cfg.name} eager {kind} ({b} slots"
            f"{'' if kind == 'decode' else f' × {c} rows'}, at {at}): "
            f"{card.num_ops} ops + {sum(counted.values())} kernel launches; "
            f"FLOPs {card.flops:.6e}, traffic {card.traffic_bytes / 1e9:.4f} "
            f"GB, launches {counted} — equal exactly on the card and on the "
            f"meta device (walks {card.seconds:.1f} s / "
            f"{on_meta.seconds:.1f} s); peak live {card.peak_live_bytes / 1e9:.3f}"
            f" GB (meta {on_meta.peak_live_bytes / 1e9:.3f}); roofline bound "
            f"{bound:.3f} ms ({report.dominant}: compute "
            f"{report.compute_s * 1e3:.3f}, memory "
            f"{report.memory_s * 1e3:.3f}; B1–B4's own {kernel_ms:.4f} ms)")
        log(f"[op-costs] {kind} traffic by op, GB: " + ", ".join(
            f"{k} {v / 1e9:.3f}" for k, v in out[kind]["top_traffic"].items()))
    tick = decode_profile["device_ms"]
    out["decode"]["tick_device_ms"] = tick
    out["decode"]["tick_over_bound"] = tick / out["decode"]["bound_ms"]
    log(f"[op-costs] the graphed decode tick's device time "
        f"{tick:.2f} ms ([profile-decode]) is "
        f"{out['decode']['tick_over_bound']:.2f}× the eager step's roofline "
        f"bound {out['decode']['bound_ms']:.3f} ms [{smi}]")
    return out


def measure_peak(fn, arg_bytes):
    """``fn()``'s device-memory peak on the card with its arguments
    counted: ``max_memory_allocated`` after ``reset_peak_memory_stats``,
    less what was allocated before the call, plus the arguments' bytes
    (so that other tensors alive on the card do not count)."""
    import torch

    gc.collect()
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    del out
    peak = torch.cuda.max_memory_allocated()
    return dict(base_gb=base / 1e9, peak_gb=peak / 1e9, wall_s=wall,
                measured_gb=(peak - base + arg_bytes) / 1e9)


def _peak_verdict(label, predicted, args, measured, out):
    ratio = predicted / (measured["measured_gb"] * 1e9)
    out.update(measured, predicted_gb=predicted / 1e9, args_gb=args / 1e9,
               ratio=ratio)
    log(f"[dryrun-peak] {label}: predicted {predicted / 1e9:.3f} GB "
        f"(arguments {args / 1e9:.3f} + the walk's temp "
        f"{(predicted - args) / 1e9:.3f}), measured "
        f"{measured['measured_gb']:.3f} GB (max_memory_allocated "
        f"{measured['peak_gb']:.3f} − {measured['base_gb']:.3f} allocated "
        f"before + the arguments), ratio {ratio:.4f} (gate "
        f"{PEAK_RATIO[0]}–{PEAK_RATIO[1]})")
    need(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
         f"[dryrun-peak] {label}: predicted / measured {ratio:.4f}")
    return out


def dryrun_peak_score(model, params, *, n_seq=4, seq_len=2048, seed=5):
    """``[dryrun-peak]`` on phase 12's call: ``LMModel.loss`` over
    ``n_seq`` × ``seq_len`` tokens at full width, walked on the meta
    device (``analysis.op_costs``, the dry run's machinery: parameters
    from the meta model's init, the batch's shapes and dtypes), its
    arguments + peak live bytes against the card's peak over the same
    call."""
    import numpy as np
    import torch

    from repro_torch.analysis import compute_costs
    from repro_torch.analysis.op_costs import meta_like
    from repro_torch.launch.dryrun import leaf_bytes
    from repro_torch.models import LMModel

    cfg = model.cfg
    smi = card_line("dryrun-peak")
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size - 1,
                                        size=(n_seq, seq_len + 1)),
                           device=DEV)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    meta = LMModel(cfg, device="meta")
    walk = compute_costs(meta.loss, meta.init(), meta_like(batch))
    args = leaf_bytes((params, batch))
    measured = measure_peak(lambda: model.loss(params, batch), args)
    out = dict(cell=f"{cfg.name} loss {n_seq} x {seq_len}, "
               f"{cfg.num_layers} layers, impl {cfg.energon.impl}",
               walk_s=walk.seconds, launches=walk.launches, card=smi)
    return _peak_verdict(out["cell"], args + walk.peak_live_bytes, args,
                         measured, out)


def dryrun_peak_train(layers=TRAIN_LAYERS):
    """``[dryrun-peak]`` on phase 27's step: ``launch/dryrun.lower_cell``
    of qwen3-14b at full width cut to ``layers``, 4 × 2048 tokens in 2
    microbatches (its shipped training config, AdamW without the >20B
    diet), against one step of ``make_train_step`` on the card from the
    same constructors (random tokens)."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import LMModel
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step

    cfg = dataclasses.replace(get_config("qwen3-14b"), num_layers=layers)
    shape = ShapeConfig("train_4x2048", TRAIN_RUN["seq_len"],
                        TRAIN_RUN["global_batch"], "train")
    num_mb = TRAIN_RUN["microbatches"]
    smi = card_line("dryrun-peak")
    art = dryrun.lower_cell(cfg.name, shape, cfg=cfg, microbatches=num_mb)
    mem = art["memory_analysis"]
    _free_device()
    model = LMModel(cfg, device=DEV)
    params = model.init()
    opt_cfg = dryrun.optimizer_config(cfg)
    opt_state = adamw.init(params, opt_cfg)
    gen = torch.Generator(device=DEV).manual_seed(14)
    batch = {k: torch.randint(1, cfg.vocab_size - 1, v.shape, generator=gen,
                              dtype=v.dtype, device=DEV)
             for k, v in dryrun.input_specs(cfg, shape, DEV).items()}
    step = make_train_step(model, opt_cfg, num_microbatches=num_mb)
    args = dryrun.leaf_bytes((params, opt_state, batch))
    need(args == mem["argument_size_in_bytes"],
         f"[dryrun-peak] train arguments {args} on the card, "
         f"{mem['argument_size_in_bytes']} in the dry run")
    measured = measure_peak(lambda: step(params, opt_state, batch), args)
    del model, params, opt_state, batch, step
    _free_device()
    out = dict(cell=f"{cfg.name} train step at {layers} of 40 layers, "
               f"{shape.global_batch} x {shape.seq_len} tokens in {num_mb} "
               f"microbatches", walk_s=art["compile_seconds"],
               num_ops=art["num_ops"], card=smi)
    return _peak_verdict(out["cell"], args + mem["temp_size_in_bytes"],
                         args, measured, out)


ENGINE_SOURCES = ("mpmrf_decode", "mpmrf_prefill", "mpmrf_filter",
                  "block_sparse_attention", "flash_attention")
#: the engines' kernels and their instantiation counts: head dims ×
#: (tile engine) layouts, or (filter engine) product paths — wgmma or
#: mma.sync at d 128, mma.sync below — × layouts (B1/B5: head dims ×
#: layouts)
ENGINE_KERNELS = {
    "decode_split_kernel": ("B2/B6", 4 * 2),
    "prefill_gather_kernel": ("B4/B8", 4 * 2),
    "block_sparse_attention_kernel": ("B10", 4),
    "flash_attention_kernel": ("B11", 4),
    "prefill_filter_kernel": ("B3/B7", (3 + 2) * 2),
    "filter_scores_kernel": ("B9", 3 + 2),
    "decode_filter_kernel": ("B1/B5", 4 * 2),
}


#: [mesh-decode] / [dryrun-mesh]: qwen3-14b's serve config at published
#: widths cut to this depth (layers 0–1 dense, 2–3 sparse)
MESH_DECODE_LAYERS = 4
MESH_DECODE_SLOTS = 8
MESH_DECODE_PROMPT = 2048
#: cache rows: the prompt and the steps, whole decode key blocks in each
#: of the 16 sequence parts of (1, 16) (3072 / 16 = 3 blocks of 64)
MESH_DECODE_ROWS = 3072
MESH_DECODE_STEPS = 4
#: max |Δ logit| / max |logit| of the mesh's decode against one device's
#: (bf16: the row-parallel partials are summed in f32 in shard order and
#: rounded once, the split cache's partials merged by log-sum-exp)
MESH_DECODE_GATE = 2e-2
#: (label, mesh, impl): heads over 'model' with B5/B6 on each shard's
#: heads; KV 8 over a model axis of 16 splits the sequence (the fused
#: route gathers the parts); the same split on the block path
MESH_DECODE_RUNS = (("2x2", (2, 2), "pallas"), ("1x16", (1, 16), "pallas"),
                    ("1x16-block", (1, 16), "mpmrf_block"))


def _decode_on(model, params, cache, tokens, ci, mesh=None):
    """``MESH_DECODE_STEPS`` decode steps of ``tokens [steps, B, 1]`` from
    ``ci``: the logits of each step (a mesh's assembled), the cache
    updated in place."""
    out = []
    for step in range(tokens.shape[0]):
        logits, _ = model.decode_step(params, cache, {"tokens": tokens[step]},
                                      ci + step, mesh=mesh)
        out.append(model.mesh_logits(logits) if mesh is not None
                   else logits)
    return out


def mesh_decode_phase():
    """``[mesh-decode]``: ``LMModel.decode_step(mesh=)`` on qwen3-14b's
    serve config (``impl="pallas"``, the contiguous cache) at published
    widths, ``MESH_DECODE_LAYERS`` deep: ``MESH_DECODE_SLOTS`` × 2048
    tokens prefilled on one device, the cache laid out by
    ``cache_shardings`` on each of ``MESH_DECODE_RUNS``' meshes of the
    card, and ``MESH_DECODE_STEPS`` steps decoded on the mesh and on one
    device from the same cache. Gates: the logits within
    ``MESH_DECODE_GATE`` of max |logit|; on (2, 2) B5 / B6 launched rows ×
    model shards × sparse layers a step; the split selection's block
    tables, and the split row path's token keep mask, equal the
    single-device selection's on the same (bf16) q — equal q codes —
    over a layer of the prefilled cache cut into 16 parts. Returns ``(out, keep)``: ``keep`` the (2, 2) run's trees for
    ``[dryrun-mesh]``."""
    import torch

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.core import filtering as flt
    from repro_torch.core.energon_attention import (
        _decode_block_plan, _decode_valid_mask, _row_keep_over_parts,
        decode_block_table_parts,
    )
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel

    label = "mesh-decode"
    smi = card_line(label)
    t0 = time.perf_counter()
    full = get_serve_config("qwen3-14b")
    cfg = dataclasses.replace(full, num_layers=MESH_DECODE_LAYERS)
    model = LMModel(cfg, device=DEV)
    params = model.init(7)
    gen = torch.Generator(device=DEV).manual_seed(31)
    b = MESH_DECODE_SLOTS
    prompt = torch.randint(1, cfg.vocab_size - 1, (b, MESH_DECODE_PROMPT),
                           generator=gen, device=DEV)
    tokens = torch.randint(1, cfg.vocab_size - 1, (MESH_DECODE_STEPS, b, 1),
                           generator=gen, device=DEV).to(torch.int32)
    base = model.init_cache(b, MESH_DECODE_ROWS)
    ci = torch.full((b,), 0, dtype=torch.int32, device=DEV)
    # chunks of 256: G·C × rows within the contiguous prefill's
    # chunk_threshold
    for c in range(0, MESH_DECODE_PROMPT, 256):
        model.prefill(params, base, {"tokens": prompt[:, c:c + 256]}, ci)
        ci = ci + prompt[:, c:c + 256].shape[1]
    sparse = cfg.num_layers - cfg.energon.min_prune_layer
    log(f"[{label}] {cfg.name} serve config (impl {cfg.energon.impl}, "
        f"contiguous cache) at published widths, {cfg.num_layers} of "
        f"{full.num_layers} layers ({sparse} sparse): {b} slots × "
        f"{MESH_DECODE_PROMPT} tokens prefilled on one device, "
        f"{MESH_DECODE_ROWS} cache rows, {MESH_DECODE_STEPS} decode steps")
    out = dict(layers=cfg.num_layers, of=full.num_layers, slots=b,
               prompt=MESH_DECODE_PROMPT, steps=MESH_DECODE_STEPS,
               card=smi, runs={})
    keep = None
    for name, grid, impl in MESH_DECODE_RUNS:
        m = LMModel(dataclasses.replace(cfg, energon=dataclasses.replace(
            cfg.energon, impl=impl)), device=DEV)
        mesh = _sim_mesh(grid)
        single = m.init_cache(b, MESH_DECODE_ROWS)
        for k in single:
            single[k].copy_(base[k])
        sp = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
        sc = m.shard_cache(base, mesh)
        lay = shd.CacheLayout(sc["k"])
        want = _decode_on(m, params, single, tokens, ci)
        _build.reset_launch_counts()
        got = _decode_on(m, sp, sc, tokens, ci, mesh)
        sync()
        launches = {k: v for k, v in _build.launch_counts.items() if v}
        errs = [float((g.float() - w.float()).abs().max()
                      / w.float().abs().max()) for g, w in zip(got, want)]
        run = dict(mesh=list(grid), impl=impl, errs=errs,
                   launches=launches, heads=lay.heads, parts=lay.parts,
                   seq_axes=list(lay.seq_axes))
        log(f"[{label}] {name} ({impl}): cache KV heads in {lay.heads} "
            f"shard(s), sequence in {lay.parts} part(s) over "
            f"{lay.seq_axes or '-'}; max|Δ logit| / max|logit| by step "
            f"{', '.join(f'{e:.3e}' for e in errs)} (gate "
            f"{MESH_DECODE_GATE}); kernel launches {launches} [{smi}]")
        need(all(e <= MESH_DECODE_GATE for e in errs),
             f"[{label}] {name}: logits off by {errs}")
        need(all(math.isfinite(e) for e in errs), f"[{label}] {name}: {errs}")
        if name == "2x2":
            each = (len(mesh.rows) * mesh.shape["model"] * sparse
                    * MESH_DECODE_STEPS)
            for kern in ("mpmrf_decode_filter_scores",
                         "decode_gather_attention"):
                need(launches.get(kern) == each,
                     f"[{label}] {name}: {kern} launched "
                     f"{launches.get(kern)} times, want rows × shards × "
                     f"sparse layers × steps = {each}")
            keep = dict(model=m, params=params, sp=sp, sc=sc, mesh=mesh,
                        tokens=tokens, ci=ci + MESH_DECODE_STEPS)
        else:
            del sp, sc
        out["runs"][name] = run
        del single
        _free_device()
    # the split selection against one device's, over layer 2 of the
    # prefilled cache in 16 parts, on the same q (bf16: equal codes)
    layer = cfg.energon.min_prune_layer
    k = base["k"][layer]
    q = torch.randn((b, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                     cfg.head_dim), generator=gen, device=DEV).to(k.dtype)
    bcfg = dataclasses.replace(cfg.energon, impl="mpmrf_block")
    _, _, live, mcfg = _decode_block_plan(bcfg, k.shape[-2], ci)
    valid = _decode_valid_mask(q, k.shape[-2], ci, None)
    one = flt.mpmrf_decode_block_select(q, k, mcfg, valid, ci,
                                        live_budget=live)
    split = decode_block_table_parts(
        q, {s: {"k": p} for s, p in enumerate(k.chunk(16, dim=-2))}, 16,
        ci, bcfg, axes=("model",))
    same = bool(torch.equal(split[0], one.block_indices)
                and torch.equal(split[1], one.block_valid))
    log(f"[{label}] layer {layer}'s survivor tables, 16 sequence parts vs "
        f"one device, the same q (q codes equal on every row): "
        f"{'equal' if same else 'DIFFERENT'} ({tuple(one.block_indices.shape)})")
    need(same, f"[{label}] the split selection's tables differ")
    rcfg = dataclasses.replace(cfg.energon, impl="mpmrf_row")
    one_keep = flt.mpmrf_row_select(q, k, rcfg.mpmrf("row"), valid).keep_mask
    split_keep = _row_keep_over_parts(
        q, {s: {"k": p} for s, p in enumerate(k.chunk(16, dim=-2))}, 16,
        ci, rcfg, ("model",))
    row_same = bool(torch.equal(split_keep, one_keep))
    log(f"[{label}] layer {layer}'s row-path keep mask, 16 sequence parts "
        f"vs one device, the same q: "
        f"{'equal' if row_same else 'DIFFERENT'} "
        f"({int(one_keep.sum())} of {one_keep.numel()} kept)")
    need(row_same, f"[{label}] the split row path's keep mask differs")
    out.update(tables_equal=same, row_keep_equal=row_same,
               seconds=time.perf_counter() - t0)
    del base, k, q
    return out, keep


def _arg_bytes_at(trees, mesh, coord) -> int:
    """The bytes mesh device ``coord`` holds of sharded ``trees``
    (``device_bytes`` at that coordinate)."""
    from repro_torch.distributed import sharding as shd

    total = 0
    for tree in trees:
        grid = shd.device_bytes(tree, mesh)
        for i in coord:
            grid = grid[i]
        total += grid
    return total


def dryrun_mesh_phase(keep):
    """``[dryrun-mesh]``: the dry run's share walks (``launch/dryrun.py
    --mesh``) held against the card. On ``[mesh-decode]``'s (2, 2) decode
    and on ``[pod-train]``'s (2, 2, 1) train step (4 layers, one 4 × 2048
    microbatch): the four shares walked on meta add up exactly to the
    card's one-controller walk of the whole step in FLOPs and kernel
    launches, and each share's argument bytes equal ``device_bytes`` of
    the card's sharded trees at its coordinate (and the batch's slice).
    The share of coordinate 0 run on the card under the walk equals its
    meta walk exactly (FLOPs, traffic, launches, peak live bytes), and
    its measured peak (``max_memory_allocated`` less what was allocated
    before) is within ``PEAK_RATIO`` of the walk's temp. Then qwen3-14b's
    decode_32k on the 16×16 and 2×16×16 production meshes, walked on
    the host: per-chip args, temp, ``fits`` and the roofline's dominant
    term (predicted from the data sheet)."""
    import torch

    from repro_torch.analysis import compute_costs
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.base import DECODE_32K
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models import LMModel
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import make_train_step, shard_state

    label = "dryrun-mesh"
    smi = card_line(label)
    t0 = time.perf_counter()
    out = dict(card=smi)

    def meta_mesh(grid):
        from repro_torch.launch.mesh import make_mesh

        return make_mesh(grid, devices=["meta"] * math.prod(grid))

    def held(name, cfg, shape, grid, whole, trees, batch, extra=0):
        mesh = meta_mesh(grid)
        shares = [dryrun.lower_cell(cfg.name, shape, mesh=mesh, coord=c,
                                    cfg=cfg, microbatches=1)
                  for c in mesh.coords()]
        flops = sum(a["parsed"]["flops_per_chip"] for a in shares)
        launches = {}
        for a in shares:
            for k, v in a["kernel_launches"].items():
                launches[k] = launches.get(k, 0) + v
        card_mesh = _sim_mesh(grid)
        args = [a["memory_analysis"]["argument_size_in_bytes"]
                for a in shares]
        want = []
        for c in card_mesh.coords():
            share = card_mesh.share(c)
            want.append(_arg_bytes_at(trees, card_mesh, c) + extra
                        + shd.share_bytes(shd.share_batch(batch, share)))
        log(f"[{label}] {name}: Σ of the {len(shares)} shares' FLOPs "
            f"{flops:.6e} vs the card's whole walk {whole.flops:.6e}; "
            f"launches {launches} vs {whole.launches}; share args "
            f"{args} vs device_bytes {want}; each share walk "
            f"{shares[0]['compile_seconds']:.2f} s [{smi}]")
        need(flops == whole.flops, f"[{label}] {name}: FLOPs {flops} vs "
             f"{whole.flops}")
        need(launches == {k: v for k, v in whole.launches.items() if v},
             f"[{label}] {name}: launches {launches} vs {whole.launches}")
        need(args == want, f"[{label}] {name}: args {args} vs {want}")
        return dict(share_flops=flops, whole_flops=whole.flops,
                    launches=launches, args=args,
                    share_walk_s=shares[0]["compile_seconds"]), shares[0]

    # the (2, 2) decode of [mesh-decode]
    m, mesh = keep["model"], keep["mesh"]
    cfg = m.cfg
    b = MESH_DECODE_SLOTS
    inputs = {"tokens": keep["tokens"][0]}
    ci = keep["ci"]
    shape = ShapeConfig("decode_mesh", MESH_DECODE_ROWS, b, "decode")
    whole = compute_costs(lambda: m.decode_step(keep["sp"], keep["sc"],
                                                inputs, ci, mesh=mesh))
    out["decode"], meta0 = held(
        "decode (2, 2)", cfg, shape, (2, 2), whole, [keep["sp"], keep["sc"]],
        {"tokens": inputs["tokens"], "cache_index": ci})
    share = mesh.share((0, 0))
    s_sp, s_sc = shd.share_of(keep["sp"], share), shd.share_of(keep["sc"],
                                                              share)

    def share_step():
        return m.decode_step(s_sp, s_sc, inputs, ci, mesh=share)

    card0 = compute_costs(share_step)
    same = dict(
        flops=card0.flops == meta0["parsed"]["flops_per_chip"],
        traffic=card0.traffic_bytes == meta0["parsed"]["traffic_bytes_per_chip"],
        launches=card0.launches == meta0["kernel_launches"],
        peak=card0.peak_live_bytes
        == meta0["memory_analysis"]["temp_size_in_bytes"])
    measured = measure_peak(share_step, 0)
    temp = meta0["memory_analysis"]["temp_size_in_bytes"]
    ratio = temp / max(measured["measured_gb"] * 1e9, 1.0)
    log(f"[{label}] share (0, 0) on the card under the walk vs on meta: "
        f"{same} (FLOPs {card0.flops:.6e}, traffic "
        f"{card0.traffic_bytes:.6e} B, launches {card0.launches}, peak "
        f"{card0.peak_live_bytes} B); measured peak "
        f"{measured['measured_gb']:.4f} GB (max_memory_allocated − "
        f"allocated before) vs the walk's temp {temp / 1e9:.4f} GB: ratio "
        f"{ratio:.4f} (gate {PEAK_RATIO[0]}–{PEAK_RATIO[1]}) [{smi}]")
    need(all(same.values()), f"[{label}] share (0, 0): card vs meta {same}")
    need(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
         f"[{label}] share (0, 0): temp / measured {ratio:.4f}")
    out["share0"] = dict(same, measured=measured, temp=temp, ratio=ratio)
    del s_sp, s_sc, whole
    keep.clear()
    _free_device()

    # [pod-train]'s (2, 2, 1) train step
    full = get_config("qwen3-14b")
    tcfg = dataclasses.replace(full, num_layers=POD_TRAIN_LAYERS)
    tshape = ShapeConfig("train_pod", POD_TRAIN_RUN["seq_len"],
                         POD_TRAIN_RUN["global_batch"], "train")
    tm = LMModel(tcfg, device=DEV)
    opt_cfg = dryrun.optimizer_config(tcfg)
    pmesh = _sim_mesh(POD_TRAIN_GRID)
    params = tm.init(3)
    sp, so = shard_state(params, adamw.init(params, opt_cfg), pmesh)
    del params
    _free_device()
    gen = torch.Generator(device=DEV).manual_seed(5)
    toks = torch.randint(1, tcfg.vocab_size - 1,
                         (tshape.global_batch, tshape.seq_len + 1),
                         generator=gen, device=DEV)
    batch = {"inputs": toks[:, :-1].to(torch.int32),
             "targets": toks[:, 1:].to(torch.int32)}
    step = make_train_step(tm, opt_cfg, mesh=pmesh, num_microbatches=1)
    # the rows of the one-controller step share each layer's checkpoint,
    # so its early stop would spare only the last row's tail of the
    # recompute: both walks recompute whole layers here
    from torch.utils.checkpoint import set_checkpoint_early_stop

    with set_checkpoint_early_stop(False):
        twhole = compute_costs(step, sp, so, batch)
        out["train"], _ = held(
            "train (2, 2, 1)", tcfg, tshape, POD_TRAIN_GRID, twhole,
            [sp, {"mu": so.mu, "nu": so.nu}],
            {"inputs": batch["inputs"], "targets": batch["targets"]},
            extra=so.step.numel() * so.step.element_size())  # replicated
    del sp, so, step, twhole
    _free_device()

    # the production meshes, walked on the host
    for name in ("single", "multi"):
        art = dryrun.lower_cell("qwen3-14b", DECODE_32K,
                                mesh=dryrun.production_mesh(name),
                                mesh_name=name)
        mem, roof = art["memory_analysis"], art["roofline"]
        log(f"[{label}] qwen3-14b decode_32k on {name} ({art['chips']} "
            f"chips, predicted from the H100 data sheet): args "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB per chip, fits "
            f"{art['fits']['fits']}, {roof['dominant']}-bound "
            f"{roof['bound_time_s'] * 1e3:.3f} ms (compute "
            f"{roof['compute_s'] * 1e3:.3f}, memory "
            f"{roof['memory_s'] * 1e3:.3f}, collective "
            f"{roof['collective_s'] * 1e3:.3f} ms), collectives "
            f"{art['parsed']['collective_bytes_per_chip']}, walk "
            f"{art['compile_seconds']:.1f} s")
        out[name] = dict(args=mem["argument_size_in_bytes"],
                         temp=mem["temp_size_in_bytes"],
                         fits=art["fits"]["fits"],
                         dominant=roof["dominant"],
                         bound_ms=roof["bound_time_s"] * 1e3,
                         collective_bytes=art["parsed"][
                             "collective_bytes_per_chip"],
                         walk_s=art["compile_seconds"])
    out["seconds"] = time.perf_counter() - t0
    return out


#: [mesh-uneven]: qwen3-14b's serve config at published widths cut to this
#: depth (layers 0–1 dense, 2–3 sparse) on a (1, 16) mesh of the card: 40
#: query heads over 16 split as GSPMD splits them, ⌈40/16⌉ = 3 a shard,
#: so shards 0–13 hold heads (the last of them one) and 14–15 none
MESH_UNEVEN_LAYERS = 4
MESH_UNEVEN_GRID = (1, 16)
MESH_UNEVEN_BATCH, MESH_UNEVEN_SEQ = 2, 2048
#: the train step's loss and gradients: qwen3-14b's training config at
#: published widths in f32 at ρ 1 (no kernel runs under grad), this deep
#: (layer 2 on the block path), 1 × 256 tokens. The loss at
#: tests/test_torch_mesh_train.py's rtol 1e-5. Its elementwise gradient
#: tolerance (rtol 1e-4, atol 1e-6 × the leaf's largest) is set for the
#: smoke widths' short sums: at published widths (sums of 5120–17408
#: terms) the same f32 graph summed in other orders passes it by up to
#: ≈ 2× on a few hundred of 10^8 elements, on an even split as on the
#: uneven one, so the count is printed and each leaf is gated on
#: ‖Δ‖ / ‖ref‖ (≈ 2e-6 measured; a head or shard misplaced is O(0.1))
MESH_UNEVEN_GRAD_LAYERS = 3
MESH_UNEVEN_GRAD_SEQ = 256
MESH_UNEVEN_LOSS_RTOL = 1e-5
MESH_UNEVEN_GRAD_TOL = (1e-4, 1e-6)
MESH_UNEVEN_GRAD_NORM = 1e-5


def xla_decode_ticks(impls=("mpmrf_block", "mpmrf_row"), ticks=4):
    """``[xla-ticks:<impl>]``: device kernels and ms a decode tick on the
    XLA selection paths (no CUDA kernel of the port runs there), for a
    one-off over two trees' ``src`` (``PYTHONPATH``): qwen3-14b's serve
    config at published widths and depth, random weights (seed 0), a
    graphed paged engine per impl in turn, ``profile_decode``'s 8 slots
    of 512-token prompts (a 256-token system prompt) and ``ticks``
    greedy ticks under the profiler."""
    import numpy as np

    from repro_torch.configs.registry import get_serve_config
    from repro_torch.models import LMModel
    from repro_torch.runtime import ServeLoop

    model = LMModel(get_serve_config("qwen3-14b"), device=DEV)
    params = model.init(0)
    system = np.random.default_rng(0).integers(
        1, model.cfg.vocab_size - 1, size=SYSTEM_LEN).tolist()
    out = {}
    for impl in impls:
        engine = ServeLoop(_with_impl(model, impl), params, batch_slots=8,
                           max_len=1024, eos_token=-1, prefill_chunk=128,
                           device=DEV)
        engine.capture_graphs()
        out[impl] = profile_decode(engine, system, prompt_len=512,
                                   ticks=ticks, label=f"xla-ticks:{impl}")
        _release(engine)
        del engine
    return out


def mesh_uneven_phase():
    """``[mesh-uneven]``: ``LMModel.apply`` / ``loss`` on a ``(1, 16)``
    mesh of the card with qwen3-14b's 40 heads, which do not divide 16:
    ``wq`` / ``wo`` stay replicated (``param_pspec``) and shard j takes
    heads ``[3j, min(3j + 3, 40))``. Gates: the logits within
    ``MESH_DECODE_GATE`` of max |logit| of one device's and the loss
    within ``MESH_LOSS_RTOL``; B9 / B10 launched once per sparse layer
    per shard that holds heads (2 × 14), B11 once per dense layer per
    such shard; then one train step's loss and gradients (f32, ρ 1) on
    the same mesh against one device's at the CPU test's tolerances."""
    import torch

    from repro_torch.configs.registry import get_config, get_serve_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import _build
    from repro_torch.models import LMModel
    from repro_torch.optim import adamw

    label = "mesh-uneven"
    smi = card_line(label)
    t0 = time.perf_counter()
    full = get_serve_config("qwen3-14b")
    cfg = dataclasses.replace(full, num_layers=MESH_UNEVEN_LAYERS)
    mesh = _sim_mesh(MESH_UNEVEN_GRID)
    m = mesh.shape["model"]
    per = -(-cfg.num_heads // m)
    holding = -(-cfg.num_heads // per)
    sparse = cfg.num_layers - cfg.energon.min_prune_layer
    model = LMModel(cfg, device=DEV)
    params = model.init(9)
    gen = torch.Generator(device=DEV).manual_seed(41)
    b, n = MESH_UNEVEN_BATCH, MESH_UNEVEN_SEQ
    tok = torch.randint(1, cfg.vocab_size - 1, (b, n + 1), generator=gen,
                        device=DEV)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    sp = shd.shard_tree(params, shd.param_shardings(params, mesh), mesh)
    need(sp["blocks"]["attn"]["wq"].model_dim() is None,
         f"[{label}] wq is not replicated over 'model'")
    log(f"[{label}] {cfg.name} serve config (impl {cfg.energon.impl}, "
        f"{cfg.dtype}) at published widths, {cfg.num_layers} of "
        f"{full.num_layers} layers ({sparse} sparse), {b} × {n} tokens; "
        f"{cfg.num_heads} heads over a model axis of {m}: {per} a shard, "
        f"{holding} shards hold heads")
    with torch.no_grad():
        want = model.apply(params, {"inputs": batch["inputs"]})[0]
        got = model.apply(sp, {"inputs": batch["inputs"]}, mesh)[0]
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        del got, want
        one, _ = model.loss(params, batch)
        _build.reset_launch_counts()
        many, _ = model.loss(sp, batch, mesh=mesh)
        sync()
        launches = {k: v for k, v in _build.launch_counts.items() if v}
    rel = abs(float(many) - float(one)) / abs(float(one))
    log(f"[{label}] max|Δ logit| / max|logit| {err:.3e} (gate "
        f"{MESH_DECODE_GATE}); loss mesh {float(many)!r} vs one device "
        f"{float(one)!r}, |Δ|/|ref| {rel:.2e} (gate {MESH_LOSS_RTOL}); "
        f"the mesh loss's kernel launches {launches} [{smi}]")
    need(math.isfinite(err) and err <= MESH_DECODE_GATE,
         f"[{label}] logits off by {err}")
    need(rel <= MESH_LOSS_RTOL, f"[{label}] loss {many} vs {one}")
    for kern in ("mpmrf_filter_scores", "block_sparse_attention"):
        need(launches.get(kern) == sparse * holding,
             f"[{label}] {kern} launched {launches.get(kern)} times, want "
             f"{sparse} sparse layers × {holding} shards")
    need(set(launches) == {"mpmrf_filter_scores", "block_sparse_attention"},
         f"[{label}] other kernels launched: {launches}")
    out = dict(layers=cfg.num_layers, of=full.num_layers, grid=list(
        MESH_UNEVEN_GRID), heads_per_shard=per, shards_with_heads=holding,
        logit_err=err, loss_rel=rel, launches=launches, card=smi)
    del sp, params, model
    _free_device()

    # one train step's loss and gradients, f32 at ρ 1
    train = get_config("qwen3-14b")
    gcfg = dataclasses.replace(
        train, num_layers=MESH_UNEVEN_GRAD_LAYERS, dtype="float32",
        remat="none", energon=dataclasses.replace(train.energon,
                                                  pruning_ratio=1.0))
    model = LMModel(gcfg, device=DEV)
    params = model.init(10)
    tok = torch.randint(1, gcfg.vocab_size - 1,
                        (1, MESH_UNEVEN_GRAD_SEQ + 1), generator=gen,
                        device=DEV)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}

    def grads(p, mesh=None):
        loss, g, _ = adamw.accumulate_gradients(
            lambda q, bb: model.loss(q, bb, mesh=mesh), p, batch, 1)
        return float(loss), g

    l1, g1 = grads(params)
    rtol, share = MESH_UNEVEN_GRAD_TOL
    steps = {}
    # the uneven split, then an even one (40 heads over 8) for scale: the
    # same f32 graph summed in other orders either way
    for name, grid in (("1x16", MESH_UNEVEN_GRID), ("1x8", (1, 8))):
        on = _sim_mesh(grid)
        sp = shd.shard_tree(params, shd.param_shardings(params, on), on)
        l2, g2 = grads(sp, on)
        got = dict(adamw.tree_leaves(shd.gather_tree(g2, DEV)))
        del g2, sp
        leaves = {}
        for path, w in adamw.tree_leaves(g1):
            d = (got[path] - w).abs()
            bound = rtol * w.abs() + share * float(w.abs().max()) + 1e-30
            leaves[path] = dict(norm=float(d.norm() / w.norm()),
                                of_bound=float((d / bound).max()),
                                past=int((d > bound).sum()), n=d.numel())
        del got
        norm = max(v["norm"] for v in leaves.values())
        past = sum(v["past"] for v in leaves.values())
        total = sum(v["n"] for v in leaves.values())
        lrel = abs(l2 - l1) / abs(l1)
        log(f"[{label}] one train step on {name} ({gcfg.dtype}, "
            f"{gcfg.energon.impl} at ρ {gcfg.energon.pruning_ratio}, "
            f"{gcfg.num_layers} layers, 1 × {MESH_UNEVEN_GRAD_SEQ} tokens): "
            f"loss {l2!r} vs one device {l1!r}, |Δ|/|ref| {lrel:.2e} (gate "
            f"{MESH_UNEVEN_LOSS_RTOL}); gradients ‖Δ‖ / ‖ref‖ ≤ {norm:.3e} "
            f"on every leaf (gate {MESH_UNEVEN_GRAD_NORM}); {past} of "
            f"{total} elements past the CPU test's rtol {rtol} + atol "
            f"{share} × max, at most "
            f"{max(v['of_bound'] for v in leaves.values()):.3f} of it "
            f"[{smi}]")
        for path, v in leaves.items():
            log(f"[{label}]   {name} {path}: ‖Δ‖/‖ref‖ {v['norm']:.3e}, "
                f"max of bound {v['of_bound']:.3f}, {v['past']} of {v['n']} "
                f"past")
        need(lrel <= MESH_UNEVEN_LOSS_RTOL,
             f"[{label}] {name} step loss {l2} vs {l1}")
        need(norm <= MESH_UNEVEN_GRAD_NORM,
             f"[{label}] {name} gradients off: {leaves}")
        steps[name] = dict(loss_rel=lrel, grad_norm_rel=norm,
                           past=past, elements=total)
    out.update(steps=steps, seconds=time.perf_counter() - t0)
    del g1, params, model
    _free_device()
    return out


def serve_decode_phase():
    """``[serve-decode]``: ``repro_torch.serve_decode.main()`` on the card
    — the reference example's oversubscribed paged pool (8 slots, 20
    pages), prefix cache, mixed greedy / stochastic traffic, ρ_eff
    telemetry and Chrome trace — gated on the example's own asserts: 24
    of 24 drained, the peak within 20 pages, ρ_eff in (0, 1], at least
    one preemption and a prefix hit-rate above 0."""
    from repro_torch import serve_decode

    label = "serve-decode"
    smi = card_line(label)
    t0 = time.perf_counter()
    res = serve_decode.main(device=DEV,
                            log=lambda line: log(f"[{label}] {line}"))
    m, obs = res["engine"].metrics, res["obs"]
    rho = obs.sparsity.snapshot()["decode"]["rho_eff"]
    with open("serve_trace.json") as f:
        events = len(json.load(f)["traceEvents"])
    out = dict(requests=len(res["done"]),
               tokens=sum(len(r.tokens_out) for r in res["done"]),
               preemptions=m.preemptions, peak_pages=m.peak_pages_in_use,
               ticks=m.ticks, prefill_calls=m.prefill_dispatches,
               decode_calls=m.decode_dispatches,
               prefix_hit_rate=m.prefix_hit_rate,
               pages_shared=m.pages_shared,
               prefill_tokens_skipped=m.prefill_tokens_skipped,
               cow_clones=m.cow_clones, rho_eff_decode=rho,
               trace_events=len(obs.trace), chrome_events=events,
               decode_tok_s=m.decode_tokens_per_sec,
               seconds=time.perf_counter() - t0, card=smi)
    log(f"[{label}] {json.dumps(out)}")
    need(out["requests"] == serve_decode.N_REQUESTS,
         f"[{label}] {out['requests']} drained")
    need(m.peak_pages_in_use <= 20, f"[{label}] peak {m.peak_pages_in_use}")
    need(rho is not None and 0.0 < rho <= 1.0, f"[{label}] rho_eff {rho}")
    need(m.preemptions >= 1, f"[{label}] no preemption")
    need(m.prefix_hit_rate > 0.0, f"[{label}] no prefix hit")
    return out


def engine_ptxas():
    """Registers and spill bytes of each instantiation of the tile engine
    (B2/B6, B4/B8 per head dim and layout, B10, B11 per head dim) and of
    the filter engine (B3/B7 per head dim, product path and layout, B9
    per head dim and product path, B1/B5 per head dim and layout) from
    nvcc's ``-Xptxas -v`` report; fails on any spill at d 128, the model
    paths' instantiation (phi3-mini's head dim 96 runs it too)."""
    from repro_torch.kernels import _build

    pat = re.compile(r"Compiling entry function "
                     r"'_Z\d+(\w+?)ILi(\d+)E(?:Li(\d+)E)?(Lb([01])E)?")
    out = {}
    for name in ENGINE_SOURCES:
        report = _build.build_info["ptxas"].get(name, "")
        kernel = None
        for line in report.splitlines():
            m = pat.search(line)
            if m and m.group(1) in ENGINE_KERNELS:
                mt = "" if m.group(3) is None else f", {m.group(3)}"
                layout = {None: "", "1": ", paged", "0": ", contiguous"}[
                    m.group(5)]
                kernel = f"{m.group(1)}<{m.group(2)}{mt}{layout}>"
                out[kernel] = dict(d=int(m.group(2)),
                                   kernel=ENGINE_KERNELS[m.group(1)][0])
            elif "Compiling entry function" in line:
                kernel = None
            elif kernel and "spill stores" in line:
                st, ld = re.findall(r"(\d+) bytes spill", line)
                out[kernel].update(spill_stores=int(st), spill_loads=int(ld))
            elif kernel and "Used" in line and "registers" in line:
                out[kernel]["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
    want = sum(count for _, count in ENGINE_KERNELS.values())
    need(len(out) == want,
         f"ptxas reported {sorted(out)}, not the {want} instantiations of "
         f"B2/B6, B4/B8, B3/B7, B1/B5 (paged and contiguous), B9, B10 and "
         f"B11 at d 16, 32, 64 and 128")
    for kernel, r in sorted(out.items()):
        log(f"[ptxas] {r['kernel']} {kernel}: {r.get('registers')} "
            f"registers, spill stores {r.get('spill_stores')} B, loads "
            f"{r.get('spill_loads')} B")
        if r["d"] == 128:
            need(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                 f"{kernel} spills at d 128")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=40,
                    help="qwen3-14b depth to serve (width is never cut)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    start = time.perf_counter()

    def clock(what):
        log(f"[clock] {time.perf_counter() - start:.1f} s: {what}")

    smi = card_name()
    log(smi)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}")
    for name in ENGINE_SOURCES:   # rebuilt, so that ptxas reports them
        _build._lib_path(name).unlink(missing_ok=True)
    secs = _build.build()
    log(f"[build] nvcc built {', '.join(_build.SOURCES)} in {secs:.1f} s "
        f"(parallel, sm_90a)")
    for name, report in _build.build_info["ptxas"].items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas:{name}] {line.strip()}")
    ptxas = engine_ptxas()
    clock("build")

    results = {name: [] for name in KERNELS}
    gen = torch.Generator(device=DEV).manual_seed(0)
    check_case(random_case(gen), "random", results)
    small_reference_check()
    from repro_torch.configs.registry import get_serve_config

    cfg = get_serve_config("qwen3-14b")
    if args.layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        log(f"[serve] depth cut to {args.layers} of {get_serve_config('qwen3-14b').num_layers} layers (width unchanged)")
    engine, prompts, run1, launches, streams1 = serve_full_width(cfg)
    layer = engine.model.cfg.energon.min_prune_layer
    check_case(live_pool_case(engine, prompts, layer), f"live-layer{layer}",
               results)
    prof = profile_drain(engine, prompts[0][:SYSTEM_LEN])
    prof["decode"] = profile_decode(engine, prompts[0][:SYSTEM_LEN])
    analysis = dict(op_costs=op_costs_phase(engine, prof["decode"]))

    # the contiguous cache on the same model object and weights; the
    # paged engine (and its page pool) goes first
    model, params = engine.model, engine.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    case = random_contiguous_case(gen)
    same_rows = {"random": check_same_rows(
        case, check_contiguous(case, "random", results), "random", gen)}
    check_contiguous(random_contiguous_case(gen, pk=128), "random-kb128",
                     results, timed=False, gather=False)
    del case
    uengine, unpaged, ulaunches, captured = serve_unpaged(
        model, params, prompts, streams1)
    case = captured_contiguous_case(uengine, captured, layer)
    same_rows["captured"] = check_same_rows(
        case, check_contiguous(case, f"captured-layer{layer}", results),
        f"captured-layer{layer}", gen)
    del uengine, case, captured
    gc.collect()
    torch.cuda.empty_cache()
    in_turns = serve_in_turns(model, params, prompts, streams1)
    eager_graphed = eager_graphed_in_turns(model, params, prompts, streams1)
    telemetry = telemetry_in_turns(model, params, prompts, streams1,
                                   launches)
    chaos = chaos_drain(model, params, prompts, streams1)
    xla_srv = xla_serve(model, params, prompts, streams1)
    # serving over a mesh of the one card: a lone TP engine, then replicas
    tp_results = {name: [] for name in SERVE_KERNELS}
    mesh = dict(tp_serve=tp_serve(model, params, prompts, streams1,
                                  tp_results),
                mesh_serve=mesh_serve(model, params, prompts, streams1))
    clock("qwen3-14b serving phases")

    # full-sequence scoring on the same model object and weights
    e = model.cfg.energon
    blocks = dict(bq=e.query_block, bk=e.key_block, ratio=e.pruning_ratio)
    q, k, v = random_full_sequence(gen)
    random_fs = check_full_sequence(q, k, v, "random", results, **blocks)
    half = q.shape[1] // 2
    check_full_sequence(q[:, half:].contiguous(), k, v, "random-offset",
                        results, q_offset=half, timed=False, **blocks)
    del q, k, v
    small_scoring_check()
    scoring, (q, k, v) = score_full_width(model, params)
    captured_fs = check_full_sequence(q, k, v, f"captured-layer{layer}",
                                      results, **blocks)
    pair = time_sparse_pair(q, k, v, layer=layer, **blocks)
    del q, k, v
    analysis["dryrun_peak"] = dict(score=dryrun_peak_score(model, params))
    grad_check()

    # the rest of the attention dispatch: past chunk_threshold, and the
    # reference's default impl
    long, (q, k, v) = score_long(model, params)
    long_fs = check_full_sequence(q, k, v, f"long-layer{layer}", results,
                                  **blocks)
    long_route = long_route_vs_scan(q, k, v, layer=layer, **blocks)
    del q, k, v
    xla_fs = xla_full(model, params, scoring["loss"])
    clock("qwen3-14b scoring phases")

    # the other dense configs, once qwen3-14b is released
    del model, params
    _free_device()
    log(f"[dense] qwen3-14b released: "
        f"{mem_gb(torch.cuda.memory_allocated)} GB still allocated")
    dense_results = {name: [] for name in KERNELS}
    dense = dense_config_phases(dense_results, blocks)
    d96 = {name: [] for name in KERNELS}
    dense.update(phi3_phase(d96, blocks))
    clock("the other dense configs")

    # the MoE family, once the dense configs are released; expert
    # parallelism on the olmoe model; then qwen3-moe at G 16
    moe_results = {name: [] for name in KERNELS}
    ep_results = {name: [] for name in SERVE_KERNELS}
    moe, moe_ep = olmoe_phase(moe_results, blocks, ep_results)
    clock("olmoe, expert parallelism, serve-2d")
    g16 = {name: [] for name in KERNELS}
    qwen3moe = qwen3moe_phase(g16, blocks)
    clock("qwen3-moe")

    # the vlm / audio and recurrent families, once qwen3-moe is released
    family_results = {name: [] for name in KERNELS}
    families = new_family_phases(family_results, blocks)
    clock("the vlm / audio and recurrent families")

    # training, once the last family's model is released: no kernel has
    # a backward, so these phases launch none of B1–B11
    analysis["dryrun_peak"]["train"] = dryrun_peak_train()
    training = dict(train=train_phase(),
                    train_lm_200k=train_lm_phase(200_000, gated=False),
                    train_lm=train_lm_phase(),
                    pallas_refused=pallas_grad_refused())
    clock("training")
    # training over a (2, 2) mesh of the card: no kernel runs either
    training.update(mesh_train=mesh_train_phase(),
                    mesh_train_moe=mesh_train_moe_phase(),
                    mesh_train_resume=mesh_train_resume_phase())
    clock("training over (data, model) meshes")
    # the three-axis mesh: pod data parallelism, then the GPipe pipeline
    # over 'pod' (B9 / B10 in every stage)
    training.update(
        pod_train=mesh_train_phase(POD_TRAIN_LAYERS, POD_TRAIN_GRID,
                                   POD_TRAIN_RUN, "pod-train"),
        pod_train_resume=mesh_train_resume_phase(
            (2, 2, 2), ((1, 1),), "pod-train-resume"))
    pipeline = pipeline_phase()
    clock("the pod mesh and the pipeline")
    # decode over meshes of the card (B5 / B6 on each head shard), then
    # the dry run's share walks held against the card
    mesh_decode, keep = mesh_decode_phase()
    dryrun_mesh = dryrun_mesh_phase(keep)
    clock("the mesh decode and the dry run over meshes")
    # heads that do not divide 'model' (B9–B11 per head shard), then the
    # reference's serving example
    mesh_uneven = mesh_uneven_phase()
    serve_decode = serve_decode_phase()
    clock("uneven heads over 'model' and the serving example")

    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, meta in KERNELS.items():
        entries = results[name]
        main_run, rand = entries[-1], entries[0]
        run = (launches if name in SERVE_KERNELS else ulaunches
               if name in UNPAGED_KERNELS else long["launches"])
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=run[name],
            launches_dense_configs={
                phase: r["launches"][name] for phase, r in dense.items()
                if "launches" in r},
            launches_mesh={phase: r["launches"].get(name, 0)
                           for phase, r in mesh.items()},
            launches_moe={phase: r["launches"][name]
                          for phase, r in moe.items() if "launches" in r},
            launches_moe_ep={phase: r["launches"].get(name, 0)
                             for phase, r in moe_ep.items()
                             if "launches" in r},
            launches_qwen3moe={phase: r["launches"].get(name, 0)
                               for phase, r in qwen3moe.items()
                               if "launches" in r},
            launches_families={phase: r["launches"].get(name, 0)
                               for phase, r in families.items()
                               if "launches" in r},
            launches_pipeline=pipeline["launches"][name],
            launches_mesh_decode={
                run: r["launches"].get(name, 0)
                for run, r in mesh_decode["runs"].items()},
            launches_mesh_uneven=mesh_uneven["launches"].get(name, 0),
            max_abs_err=max(r["err"] for r in entries + dense_results[name]
                            + d96[name] + tp_results.get(name, [])
                            + moe_results[name] + ep_results.get(name, [])
                            + g16[name] + family_results[name]),
            **{k: main_run[k] for k in timed_keys},
            **{k: main_run[k] for k in ("device_ms", "library_device_ms")
               if k in main_run},
            ms_over_bound=main_run["ms"] / main_run["bound_ms"],
            random=dict({k: rand[k] for k in ("err",) + timed_keys},
                        ms_over_bound=rand["ms"] / rand["bound_ms"]),
            # phi3-mini's live / captured layer 2 at head dim 96, its
            # bound from the d-96 work
            d96=dict({k: d96[name][-1][k] for k in ("err",) + timed_keys},
                     ms_over_bound=d96[name][-1]["ms"]
                     / d96[name][-1]["bound_ms"]),
            # qwen3-moe's live / captured layer 2 at G 16 (bh 32 a decode,
            # 1024 folded prefill rows; B9–B11 at bh 128)
            g16=dict({k: g16[name][-1][k] for k in ("err",) + timed_keys},
                     ms_over_bound=g16[name][-1]["ms"]
                     / g16[name][-1]["bound_ms"]),
            # [tp-serve]'s shard 0 of layer 2's live pool (bh = B·KV/4)
            **({"tp_shard": dict(
                {k: tp_results[name][-1][k] for k in ("err",) + timed_keys},
                ms_over_bound=tp_results[name][-1]["ms"]
                / tp_results[name][-1]["bound_ms"])}
               if name in tp_results else {}),
        ))
    log(json.dumps({"serve": run1, "profile": prof, "card": smi}))
    log(json.dumps({"unpaged": dict(unpaged, same_rows=same_rows,
                                     in_turns=in_turns), "card": smi}))
    log(json.dumps({"scoring": dict(scoring, random=random_fs,
                                    captured=captured_fs, **pair),
                    "ptxas": ptxas, "card": smi}))
    log(json.dumps({"eager_graphed": eager_graphed, "card": smi}))
    log(json.dumps({"telemetry": telemetry, "chaos": chaos, "card": smi}))
    log(json.dumps({"score_long": dict(long, captured=long_fs,
                                       route_vs_scan=long_route),
                    "xla_full": xla_fs, "xla_serve": xla_srv,
                    "card": smi}))
    log(json.dumps({"dense_configs": dense, "card": smi}))
    log(json.dumps({"mesh": mesh, "card": smi}))
    log(json.dumps({"moe": moe, "card": smi}))
    log(json.dumps({"moe_ep": moe_ep, "qwen3moe": qwen3moe, "card": smi}))
    log(json.dumps({"families": families, "card": smi}))
    log(json.dumps({"training": training, "pipeline": pipeline,
                    "card": smi}))
    log(json.dumps({"analysis": analysis, "card": smi}))
    log(json.dumps({"mesh_decode": mesh_decode, "dryrun_mesh": dryrun_mesh,
                    "card": smi}))
    log(json.dumps({"mesh_uneven": mesh_uneven,
                    "serve_decode": serve_decode, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
