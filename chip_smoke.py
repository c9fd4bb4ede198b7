#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--n 3300000] [--shards 8] [--seed 0]
                          [--points 382000000]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a, into ``build/kernels/``), then runs the paper's three benchmark
algorithms and connected components at the paper's sizes (§6 "Data"):

* the DBPedia-shaped graph (3.3 M vertices, average degree 14.5, Zipf
  exponent 2.1), 8 shards, capacity ladder of 4 rungs, edge capacity 4n,
  source capacity one block (the settings of ``bench_pagerank.py`` and
  ``bench_sssp.py``):
  - PageRank (threshold 1e-3, at most 60 strata): ``delta_auto``
    (scatter_route + delta_scatter, add), ``delta_sort`` (delta_route +
    delta_scatter) and ``nodelta`` (edge_propagate), each checked against
    a float64 power iteration on the card (bound 1e-2), delta_sort against
    delta_auto (1e-2), and delta against nodelta at threshold 1e-5
    (5e-3);
  - SSSP from vertex 0 (at most 80 strata): ``sssp_auto`` (scatter_route +
    delta_scatter, min), ``sssp_sort`` (delta_route + delta_scatter) and
    ``sssp_nodelta`` (edge_propagate, min), each exactly equal to a
    level-synchronous BFS on the card (``sssp.reference_sssp``);
  - connected components: ``cc_auto`` and ``cc_nodelta``, each exactly
    equal to a dense min-label iteration on the card
    (``connected_components.reference_components``);
  - the compiled rule programs of ``repro_torch.frontend`` at the same
    settings (route ``auto``): ``rules_pagerank`` and
    ``rules_pagerank_nodelta`` (within 1e-2 of the float64 power
    iteration; the nodelta run exactly ``nodelta``'s answer, the delta
    run within PAGERANK_TWIN_BOUND of ``delta_auto``'s), ``rules_sssp``
    and ``rules_cc`` (exactly ``sssp_auto``'s and ``cc_auto``'s answers
    and their oracles), and rules-only
    reachability, ``rules_reach`` and ``rules_reach_nodelta`` (its reached
    set exactly the BFS oracle's), each wall printed beside its
    handwritten twin's with the overhead (``bench_frontend.py``'s 5 %
    budget, printed only); reachability runs the max variants of
    scatter_route, delta_scatter and edge_propagate, whose rows are built
    at its widest stratum;
  - the shard_map backend (``core/engine.py`` over ``torch.distributed``)
    on a world of one rank, NCCL on ``cuda:0``, the group initialised
    through a ``file://`` store under ``build/`` (no port) and destroyed
    after: ``dist_pagerank``, ``dist_pagerank_nodelta``, ``dist_sssp``,
    ``dist_sssp_sort``, ``dist_cc`` and ``dist_rules_sssp``, each held to
    its simulated twin of this run (DIST_PHASES): SSSP, CC and nodelta
    PageRank exactly, values and every stats column; delta PageRank within
    PAGERANK_TWIN_BOUND (float atomics); each wall printed beside its
    twin's, with its peak memory, the NCCL version and the world size;
    their launches go to the twins' groups; then ``run_resilient`` on
    that backend, shard 3 lost at half the strata:
    ``dist_sssp_resilient`` (exactly ``dist_sssp``'s state and stats) and
    ``dist_pagerank_resilient`` (within PAGERANK_TWIN_BOUND of
    ``dist_pagerank``), the replica chain under the group's directory;
  - adsorption with 4 labels (a seed on every 100th vertex; threshold
    1e-3, at most 60 strata): ``adsorption_auto`` (scatter_route +
    delta_scatter, add at W = 4), ``adsorption_sort`` (delta_route +
    delta_scatter) and ``adsorption_nodelta`` (its own scatter, no
    kernel), each within a per-vertex bound derived from its threshold
    (ADS_F32) of a float64 fixpoint on the card, delta against nodelta
    within 5e-2;
  - observability: ``delta_auto_traced`` and ``sssp_auto_traced`` (a
    Tracer on the executor; SSSP bit-identical to ``sssp_auto``, PageRank
    within 1e-2 of the float64 oracle), printing each stratum's host wall
    against its device time (CUDA events), the device span share, the
    busy share (torch.profiler, two more untimed runs) and a Chrome trace
    under ``build/``; ``delta_measured`` (a route table calibrated on the
    card, printed, then ``route_strategy="measured"``, 1e-2);
  - Fig 12's recovery (``bench_recovery.py``'s setting) through
    ``run_resilient``: ``sssp_resilient`` (state and stats equal to
    ``sssp_auto``), ``sssp_recover_{25,50,75}`` (shard 1 lost at that
    share of the strata), ``sssp_restart_{50,75}`` and ``sssp_chaos`` (the
    acceptance schedule, then a rescale to 4 shards), every final state
    exactly the failure-free one, incremental recovery at 75 % doing less
    work than restart there; checkpoints in a directory under ``build/``,
    removed after;
  - the multi-process launch (``launch/distributed.py``), worker
    channels and replica chains under ``build/launch_*``, removed after:
    ``launch_selftest`` (a worker process forms a world of one NCCL rank
    on cuda:0 and reports its rank, device, shards and one all_gather),
    ``sssp_real_kill`` (4 workers whose acks compute on the card; worker 1
    SIGKILLed at stratum 2, found by its lease, recovered from replicas
    and replaced by a new process; state and stats exactly
    ``sssp_auto``'s) and ``sssp_chaos_real`` (``sssp_chaos``'s schedule
    as real signals against one protocol worker a shard; the final state
    exactly the failure-free one), each with its detection latency,
    respawn wall, acks and ack timeouts, its wall beside its simulated
    twin's (``sssp_recover_25``, ``sssp_chaos``);
* incremental views (``repro_torch.incremental``, ``bench_incremental.py``'s
  setting) over a ``GraphStore`` of that graph, each view on its own copy:
  ``ViewManager(fallback_threshold=2.0)`` (every batch repairs), the cold
  executor at the capacities above, the rule's own resume capacities, a
  stream of batches that insert and delete 1 % of |E| each (about 241 k
  of each, from ``--seed``), one warm-up batch and two measured ones.
  Each measured repair runs as a phase (its kernels must launch; a dense
  stratum must have launched edge_propagate), prints its report, the host
  seconds of its parts (``apply_batch``, ``build_sharded``, ``repair``,
  ``fixpoint``) and a cold recompute's wall on the same store:
  - ``view_pagerank`` (threshold 1e-4, at most 100 strata; scatter_route
    + delta_scatter, add): warm and cold within 1e-2 of a float64 power
    iteration of the mutated graph;
  - ``view_sssp`` (source 0, 100 strata) and ``view_cc`` (100 strata;
    min): warm exactly equal to the cold recompute and to the BFS or
    dense min-label oracle of the mutated graph;
  - ``view_sssp_resilient``: ``view_sssp`` with a replica chain under
    ``build/``, shard 1 lost at stratum 1 of the first measured repair;
    answers exactly ``view_sssp``'s, the failure in ``last_recovery``;
  - ``view_journal``: ``view_sssp`` under a journal under ``build/``;
    ``ViewManager.restore`` gives a view whose answer equals the live
    one; the directories are removed after;
* k-means on 382 M geo points (47.75 M a shard, 8 shards), k = 32, at most
  60 strata (``bench_kmeans.py``'s settings at the paper's largest size):
  ``kmeans_delta`` and ``kmeans_nodelta`` (kmeans_assign), each within
  3e-3 (coordinates; cloud spread 3.0) of a float64 Lloyd iteration of the
  same shape on the card, and of each other; then ``view_kmeans``, a
  k-means view on ``make_geo_points(points // 10, 32, seed)`` (38.2 M
  points by default, a tenth of the paper's; 76.4 M slots in a host store
  that goes to the card every batch), k = 32, 60 strata, batches of
  1,000 inserts and 1,000 removals: each measured repair (kmeans_assign)
  within 3e-3 of a float64 Lloyd run from the repaired state on the
  mutated store, its counts equal to the store's and its sums within
  1e-4 of their |x| mass;
* the dense LM serving path at Llama-3-8B's full width and depth (32
  layers, d 4096, GQA 32/8 heads of 128, d_ff 14,336, vocab 128,256, bf16
  weights from the port's seeded init), tokens from ``TokenPipeline``:
  - ``lm_forward``: the full-sequence forward at 2 x 4096 tokens
    (``train_4k``'s sequence, its batch of 256 cut to 2), 32 launches of
    the bf16 flash_attention kernel and none of the float32 one, its
    logits against the plain attention path (``use_kernel=False``)
    within 5e-2 of the largest logit; and at full width, 4 layers,
    float32 (TF32 off; 4 launches of the float32 kernel) within 1e-4, as
    are 8 teacher-forced decode steps after a prefill against that
    forward;
  - ``lm_serve``: ``launch/serve.py``'s ``serve`` on 8 requests of 2048
    prompt tokens and 64 greedy new tokens (32 bf16 flash_attention
    launches, all in the prefill, no float32 ones), the prefill's
    last-position logits against the forward's (within one bf16 ulp of
    the largest logit) and against the prefill's plain attention path
    (``use_kernel=False``, 5e-2), and 8 teacher-forced decode steps
    against a forward over the extended sequence (5e-2); each bound's
    reason is stated beside it below;
* training at OLMo-1B's full width and depth (16 layers, d 2048, 16 heads
  of 128, d_ff 8192, vocab 50,304, tied embeddings, bf16, remat) through
  ``launch/train.py``'s ``train``: 32,768 tokens a step (16 x 2048 in 4
  microbatches), warm-up 10, lr TRAIN_LR:
  - ``lm_train``: 6 steps, compression none; each step 128 launches of the
    bf16 flash kernel (forward and remat recompute), each writing the
    rows' log-sum-exp, and 64 calls of flash_attention_bwd's bf16
    tensor-core kernel (192 launches), which reads it; every loss finite,
    the last below the first; step walls, tokens/s and peak memory
    printed; then the bf16 check below, on the trained weights;
  - ``lm_train_delta``: 2 steps with REX-delta gradient compression, its
    wire bytes equal to 8 * sum(max(1, floor(0.01 * size))) over the
    reference's stacked leaves, counted on the host;
  - one microbatch's loss and gradients through the kernels against the
    plain attention path (``use_flash_kernel=False``): float32 at 2
    layers (TF32 off) and bf16 at full depth (at init and after
    ``lm_train``), within the bounds stated at TRAIN_TIGHT_BOUND and
    TRAIN_BF16_GRAD_BOUND;
  - ``lm_train_resume``: 2 layers, 4 steps straight against 2 steps, a
    checkpoint under ``build/`` (removed after), a restore equal to the
    saved state bit for bit and 2 more steps, the losses within
    TRAIN_RESUME_BOUND;
  - ``shard_train``: the sharded LM (``launch/sharding.py``: parameters,
    mu and nu stored as DTensors by the reference's specs) on a (1, 1)
    ("data", "model") mesh over a one-rank NCCL group (``one_rank_mesh``,
    its store under ``build/``, destroyed after): ``train(mesh="1x1")``,
    3 steps at lm_train's shapes, then one ``make_train_step`` step with
    the ZeRO-3 hook (``make_gather_fn``) from a fresh state; each loss
    within SHARD_LOSS_RTOL of lm_train's at the same step and equal to it
    bit for bit (and to the plain path's 3 steps run just after), the bf16
    forward and backward kernels launched as in lm_train; step walls
    beside lm_train's and the plain 3 steps', peak memory and the
    model-FLOP share of a step (``roofline.step_flops`` over the card's
    datasheet bf16 peak), printed;
* ``moe_train``: mixtral-8x22b at full width, 1 of its 56 layers,
  trained 3 steps through ``train(mesh="1x1")`` on that mesh (4 x 1024
  tokens a step in 2 microbatches; no kernel: the window's path), every
  loss finite, peak memory beside the trained state's arithmetic; one
  microbatch's gradients through the sharded step against the plain path
  (``use_flash_kernel=False``, the routes replayed) within
  TRAIN_BF16_GRAD_BOUND;
* ``shard_decode`` (in the LM section, on its Llama-3-8B): 8
  teacher-forced steps of flash decoding (``flash_decode=True``, the cache
  shared out by ``shard_cache``) on a (1, 1) ambient mesh against the
  plain decode from the same prefill, within LM_DECODE_BOUND; and
  ``shard_decode_a2a`` (in the mixtral serving section): the a2a dispatch
  on that mesh against the sort dispatch on layer 0's MoE input over 2 x
  2048 tokens, both at capacity factor E / k, within MOE_DISPATCH_BOUND
  of max |y|;
* MoE serving through ``launch/serve.py``'s ``serve`` (bf16 weights from
  the port's seeded init, drawn an expert at a time):
  - ``moe_serve``: arctic-480b at full width (d 7168, GQA 56/8 heads of
    128, 128 experts top-2 of d_ff 4864 beside a dense SwiGLU residual,
    vocab 32,000), 2 layers, 8 prompts of 2048 tokens and 64 new tokens
    (capacity 320 copies an expert at the prefill); 2 launches of the bf16
    flash kernel (group 7), none of the float32 one or the backward; the
    kernel path against the plain path on 2 prompts (the plain run
    replaying the kernel run's routes, so the two part by the attention
    alone) within 5e-2, the prefill's last logits against the forward's
    within one bf16 ulp, 8 teacher-forced decode steps against a forward
    that drops no copy (5e-2, on the tokens whose routes agree); the
    dispatch on layer 0's input: each expert keeps min(count, capacity)
    copies, its highest-probability ones, ties to the earlier copy, and
    the expert output of 256 tokens within MOE_DISPATCH_BOUND of a float64
    evaluation of their kept copies; the flash row at B=8, H=56/8,
    T=S=2048;
  - ``moe_window_serve``: mixtral-8x22b at full width (d 6144, 48/8
    heads, 8 experts top-2 of d_ff 16,384, window 4096, vocab 32,768), 4
    layers, 2 prompts of 6144 tokens and 64 new tokens: no kernel launch;
    the prefill through ``blocked_attention`` in every layer, its cache the
    last 4096 positions in ring order, every decode step on a wrapped
    ring; the prefill's last logits against the forward's
    (``_windowed_attention``, the prefill's routes replayed) within 5e-2,
    8 teacher-forced decode steps against the forward (5e-2), and
    ``blocked_attention`` against ``_windowed_attention`` on layer 0's
    q, k, v in float32 within 1e-5 of max |out|; a bf16 flash row at
    mixtral's heads (group 6, full causal, off the path: 0 launches).
* multi-head latent attention at minicpm3-4b's full width and depth (62
  layers, d 2560, 40 heads, q·k 64 + 32 rope, v 64, q rank 768, kv rank
  256, d_ff 6400, vocab 73,448, untied; bf16 weights from the port's
  seeded init):
  - ``mla_serve``: ``launch/serve.py``'s ``serve`` on 8 prompts of 2048
    tokens and 64 new tokens: no kernel launch (MLA's q·k width is not its
    v width, which the flash kernels do not take, in either package: the
    forward and prefill run ``attention_ref`` in float32); the latent
    cache's bytes (kv rank + rope values a token a layer) printed beside a
    40-head K/V cache's; the prefill's last logits against the forward's
    (one bf16 ulp), 8 teacher-forced absorbed decode steps against the
    forward (5e-2), and the same at full width, 4 layers, float32 (1e-4);
* M-RoPE and the vision stub at qwen2-vl-2b's full width and depth (28
  layers, d 1536, GQA 12/2 heads of 128, d_ff 8960, vocab 151,936, tied):
  - ``vlm_forward``: the forward at 2 x 4096 from ``embeds`` (text rows of
    the embedding, a 32 x 32 grid of drawn patch rows at 1024) at Qwen2-VL's
    [3, B, T] positions, the script's own input; 28 launches of the bf16
    flash kernel (group 6), against the plain path (5e-2);
  - ``vlm_serve``: ``serve`` on 8 prompts of 2048 tokens and 64 new tokens,
    text only (three equal position rows); prefill against forward (one
    ulp), 8 teacher-forced decode steps (5e-2); a prefill from the prompt's
    own embedding rows equal to serve's bit for bit, and one from embeds
    with a patch grid against the forward from them (one ulp);
  - ``vlm_grad``: one microbatch of 4 x 2048 from embeds at [3, B, T]
    positions (the patches' labels masked) through ``train_step``'s loss:
    56 bf16 forward launches (forward and remat, each writing its
    log-sum-exp) and 28 calls of the bf16 backward (84 launches), the loss
    and gradients against the plain path (TRAIN_BF16_LOSS_BOUND,
    TRAIN_BF16_GRAD_BOUND); flash rows at 12/2 heads: the forward at
    ``vlm_forward``'s layer 0, the prefill at ``vlm_serve``'s, the
    backward at ``vlm_grad``'s.
* the Whisper encoder-decoder at whisper-large-v3's full width and depth
  (32 encoder and 32 decoder layers, d 1280, 20/20 heads of 64, d_ff 5120,
  vocab 51,866, sinusoid positions, LayerNorm, untied; 2,020,628,480 bf16
  parameters), frames drawn in bf16 (the audio stub's output, the config
  dtype), tokens from ``TokenPipeline``:
  - ``whisper_forward``: 8 clips of 1500 frames through ``encode`` and 8 x
    448 tokens (Whisper's text context) through the forward; 64 launches
    of the bf16 flash kernel at D = 64 (32 encoder, non-causal; 32 decoder,
    causal), none of the float32 one; against the plain path (5e-2);
  - ``whisper_serve``: ``serve`` with the frames on 8 prompts of 384
    tokens and 64 new ones; encode, prefill and decode walls, the
    cross-attention K/V cache's bytes beside the self-attention cache's;
    prefill against forward (one ulp), 8 teacher-forced decode steps
    (5e-2), and both in float32 at 4 + 4 layers (1e-4);
  - ``whisper_grad``: one microbatch of 4 clips and 4 x 448 tokens through
    ``train_step``'s loss: 96 bf16 forward launches (the encoder once, the
    decoder twice: remat) and 64 calls of the bf16 backward at D = 64 (192
    launches), against the plain path (TRAIN_BF16_LOSS_BOUND,
    TRAIN_BF16_GRAD_BOUND); flash rows at D = 64: the forward at the
    encoder's layer 0 (and the float32 kernel there, off the path), the
    prefill at the decoder's, the backward at ``whisper_grad``'s encoder;
* after ``moe_serve``, ``moe_prefill_full``: arctic's prefill at a capacity
  factor of E / k, which keeps every routed copy, beside serve's prefill;
  the kept and dropped copies of both, and of mixtral's prefill.
* the recurrent block kinds at full width and depth, no kernel (the
  recurrences run plain torch in both packages; the local window takes the
  window paths at head dim 256), bf16 weights from the port's seeded init,
  tokens from ``TokenPipeline``: recurrentgemma-2b (26 layers: 8 units of
  ("rec", "rec", "attn_local") and a ("rec", "rec") tail; d 2560, RG-LRU
  width 2560, conv 4, 10/1 heads of 256 in a window of 2048, d_ff 7680,
  vocab 256,000; 3,549,795,840 parameters) and xlstm-350m (24 layers of
  ("mlstm", "slstm"); d 1024, 4 heads of 256, chunk 64, no MLP, sinusoid
  positions, LayerNorm):
  - ``recgemma_forward`` / ``xlstm_forward``: the forward at 2 x 4096,
    wall, tok/s and peak memory;
  - ``recgemma_serve`` / ``xlstm_serve``: ``serve`` on 8 prompts of 2048
    tokens and 64 new ones; the cache's bytes against their formula
    (``state_bytes``) beside a full K/V cache's; the sLSTM loops timed
    alone beside xlstm's prefill; the prefill's last logits against the
    forward (one bf16 ulp); 8 teacher-forced decode steps against the
    forward (LM_DECODE_BOUND, recurrentgemma only) and, for both, their
    distance from the same weights evaluated in float32 against the bf16
    forward's own (RECURRENT_DECODE_FACTOR); both in float32 at full width
    with a 2000-token prompt at 5 layers (one unit and the tail) / 4
    layers (a padded last chunk) within 1e-4;
  - ``rglru_scan``: layer 0's (a, b) on the serve prompt, the log-depth
    scan against the sequential recurrence in float64 (RGLRU_SCAN_BOUND
    and the rounding bound derived there);
  - ``mlstm_chunks``: layer 0 on 2 x 1024 tokens, the chunked forward in
    float32 against 1024 float64 steps of ``mlstm_decode``
    (MLSTM_CHUNK_BOUND).
* the dry run (``launch/dryrun.py``):
  - ``dryrun_check``: one ``make_train_step`` step of olmo-1b at
    lm_train's shapes on a (1, 1) mesh, traced on fake CUDA tensors in a
    fake world of one rank (the flash kernels' custom ops traced, none
    launched), then run on the card over a one-rank NCCL group under the
    same counting mode: FLOPs, bytes accessed, collective bytes (0) and
    argument bytes equal exactly, the flash kernels launched by the real
    step only; the predicted peak beside ``max_memory_allocated`` and the
    model-FLOP share printed;
  - ``dryrun_cells``: the CLI on DRYRUN_CELLS at 16 x 16 (256 fake ranks),
    and olmo-1b's train_4k also at 16 x 1, a process each, all started
    together: each record, its tensor-parallel plan (``"tp"``), its
    collective bytes by kind and its roofline row on this card's constants
    (``roofline.chip_constants``) printed, each exiting 0 with its
    devices and FLOPs above 0; olmo-1b train_4k's useful ratio at 16 x 16
    within 2 % of its 16 x 1 one and at least TP_USEFUL_MIN.
* ``tp_layer`` (after the LM section): tensor-parallel compute over
  "model" (``models/tp.py``), Llama-3-8B's layer 0 at full width (32/8
  heads of 128, d_ff 14,336, bf16) on ``lm_forward``'s 2 x 4096 tokens,
  for a model axis of M in TP_SIZES: each rank r's blocks (contiguous
  copies of its slices) through ``tp.split_layer``, the code the ranks
  run, in one process, the flash kernels on each rank's local heads (2/1
  heads at M = 16), the partials summed in rank order; the sum held to the
  unsplit layer within TP_FWD_BOUND's bf16 rounding of the partials and
  of the output, one backward (each rank's gradients of its blocks and of
  the input) within TRAIN_BF16_GRAD_BOUND (relative L2 over all of them,
  the bf16 training checks' bound) of the whole bf16 layer's, each
  gradient's distance from a float32 evaluation printed beside the whole
  bf16 layer's; rank 0's block timed, forward and
  forward + backward, against the whole layer's ms / M; flash_attention
  and its backward held and timed at M = 16's local shape (rows
  ``*/tp16``).

Each kernel is held against its plain torch version on the card at the
inputs the main path gives it: integer outputs and min results exactly,
added floats within 1e-5 relative (atomics reorder float adds), and
kmeans_assign's assignment exactly except at near-ties of the plain
version (best two d² within 4 ulp of |p|² + |c|²), counted and printed,
the bf16 flash_attention kernel within 2^-8 max|v| + 2^-8 |ref| of the
float32 plain version on the same bf16 values (the reason is stated at
FLASH_BF16_TOL) at the forward's and the prefill's shapes (layer 0's
inputs), and the float32 kernel within 2e-4 abs + 2e-4 rel (the
reference's kernel-vs-oracle bound) at the forward's shape (layer 0's
inputs in float32, a shape no LM phase runs it at); each also at a
ragged causal shape and a non-causal one.  The bf16 forward kernel is
also held at ``lm_train``'s layer-0 shape, and flash_attention_bwd there
(bf16, from the forward kernel's log-sum-exp) against attention_bwd_ref
on the float32 values (the reason for its bound is stated at
FLASH_BWD_TOL; two calls bitwise equal), in float32 at the same shape
and at D = 16 (off the path).  ``lm_forward`` and ``lm_serve`` launch no
backward and write no log-sum-exp.  Bounds count float32 operations at
67 TFLOP/s, bf16 ones at 989 TFLOP/s.
edge_propagate's row bins (light rows, heavy rows of more than 32 edges,
and the heavy rows' edges) are printed beside its checks.
scatter_route and delta_scatter are also held at W = 4, at the first
stratum of ``adsorption_auto`` on its widest rung, and with max at
``rules_reach``'s busiest stratum on its widest rung (edge_propagate max
over shard 0's CSC at that stratum's values); the compiled programs'
launches are kept in groups of their own (``rules_add``, ``rules_min``,
``max``, the last feeding the max rows).  delta_scatter's rows
take a shard's incoming buffer as the algorithms pass it (global keys,
``key_base`` = the shard's first key); a line beside each times
``to_local_keys`` followed by the kernel on the local keys against that
single launch.
The views' repairs run the graph kernels at the resume executor's smaller
capacities and kmeans_assign at the view's store, so their launches are
kept apart (groups ``view_add``, ``view_min``, ``view_kmeans``) and
reported by rows of their own: scatter_route, delta_route, delta_scatter
and edge_propagate at the inputs of ``view_pagerank``'s and
``view_sssp``'s last measured repair (replayed from its repaired state),
kmeans_assign at ``view_kmeans``'s last one.
The kernel, its plain version and, where one torch call computes the same
function, that call are timed (CUDA events around at least 5 calls, or 2
for the slowest plain versions, and at least 20 ms).  Each phase runs
with every kernel's launch count set to 0 and fails if a kernel of its
path was not launched.

Prints the card, the kernels as one JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero on any failed check,
and without a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
TIME_MIN_MS = 20.0          # least event-timed span of a kernel row
FLOAT_RTOL = 1e-5
ACCURACY_BOUND = 5e-3       # delta vs nodelta / vs oracle at threshold 1e-5
PHASE_BOUND = 1e-2          # ten times the phases' threshold of 1e-3
KMEANS_BOUND = 3e-3         # centroid coordinates, cloud spread 3.0
KMEANS_K = 32               # centroids, and clusters of the generated cloud
KMEANS_STRATA = 60          # cap on Lloyd strata (bench_kmeans.py's)
KMEANS_CHUNK = 1 << 23      # points per chunk of the plain and f64 passes
FLASH_TOL = 2e-4            # abs and rel, tests/test_kernels.py's bound
# The bf16 kernel against the float32 plain version on the same bf16
# values: |got - ref| <= 2^-8 max|v| + 2^-8 |ref|.  bf16 keeps 8
# significant bits, so rounding P moves each weight by at most 2^-8
# relative (2^-8 max|v| on o, a bound the random signs of the errors keep
# far from) and rounding the output costs at most 2^-8 |o|; the bound is
# their sum, and the float32 sum order is far below either.
FLASH_BF16_TOL = 2 ** -8
LM_ARCH = "llama3-8b"
# The LM phases' shapes: the forward at train_4k's sequence with its batch
# cut to 2; serving 8 prompts of 2048 tokens, 64 new tokens; the float32
# check at 4 layers; 8 teacher-forced decode steps.
LM_SHAPES = dict(fwd_batch=2, fwd_seq=4096, serve_batch=8, prompt=2048,
                 new=64, tight_layers=4, decode_steps=8)
# Logit errors as max |diff| / max |logit|.  Float32: the kernel and the
# plain version differ by ~1e-6, which 4 layers carry to ~4e-6.  Bf16 at
# full depth: a last-bit difference in an attention output flips a bf16
# rounding of the residual stream, and 32 layers carry it; two readings of
# the kernel path against the plain path, 1.531e-2 and 1.653e-2, and of
# teacher-forced decode against the forward, 1.534e-2 and 1.581e-2, set
# these bounds at about 3x the worst.  The prefill's last-position logits
# equal the forward's (two readings of 0); the bound is one bf16 ulp of
# the largest logit, the most that rounding the head product for one row
# in another order than for all rows could move them.
LM_TIGHT_BOUND = 1e-4       # float32, 4 layers
LM_BF16_BOUND = 5e-2        # bf16, kernel vs plain path, full depth
LM_DECODE_BOUND = 5e-2      # bf16, teacher-forced decode vs the forward
LM_PREFILL_BOUND = 2 ** -8  # bf16, prefill vs the forward (one ulp)
OFF_PATH = "off_path"       # flash rows at shapes no LM phase runs
TRAIN_ARCH = "olmo-1b"
# The training phases' shapes: launch/train.py's train at olmo-1b's full
# width and depth, sequence 2048, global batch 16 in 4 microbatches (32,768
# tokens a step), 6 steps (2 with delta compression); the float32 gradient
# check and the resume at 2 layers, the resume over 4 steps.
TRAIN_SHAPES = dict(seq=2048, batch=16, microbatches=4, steps=6,
                    delta_steps=2, tight_layers=2, resume_layers=2,
                    resume_steps=4)
# OLMo-1B's published peak learning rate (arXiv:2402.00838), under
# launch/train.py's warm-up of 10 steps.  launch/train.py's default of
# 3e-3, sized for the reduced configs, makes the loss rise from the second
# step at this width on the H100 (11.16, 10.04, 13.94, 14.75, 20.31, 11.93
# over 6 steps) through the bf16 kernels, the plain attention path and the
# float32 kernels alike (tools/train_lr_witness.py): Adam's first steps
# move every weight by about the learning rate, 8-16 % of these init
# scales at 1.8e-3, and overshoot.
TRAIN_LR = 4e-4
# Gradients of one microbatch, kernel path against plain path.  Float32 at
# full width, 2 layers, TF32 off: each leaf within 1e-4 of its largest |g|
# (tests/test_torch_train.py's bound against the reference).  Bf16 at full
# depth: the kernel path rounds P to bf16 in each forward and each
# attention output and gradient to bf16, 2^-8 relative apiece, of random
# sign; 16 layers add them in quadrature to about 4 * 2^-8 = 1.6e-2 of the
# gradients' L2 norm, hence 2e-2.  The loss is a mean over the 8,192
# tokens of a microbatch, whose log-likelihoods move by such errors of
# random sign; 1e-3 of it leaves room for 4 * 2^-8 on the logits.  One
# reading at init: 3.341e-3 (gradients) and 1.668e-5 (loss); after
# lm_train's 6 steps: 6.225e-4 and 9.499e-6.
TRAIN_TIGHT_BOUND = 1e-4
TRAIN_BF16_LOSS_BOUND = 1e-3   # |loss_kernel - loss_plain| / loss_plain
TRAIN_BF16_GRAD_BOUND = 2e-2   # relative L2 error over all gradients
# A resumed run against the straight one, final losses: the same data and
# weights, so only reordered float adds (the embedding gradient's
# scatter-add) part them, and Adam's sqrt(nu) turns a near-zero gradient
# rounded apart into a full step; the CPU tests' bound for 3 steps.
TRAIN_RESUME_BOUND = 1e-3
# The backward kernels against attention_bwd_ref on the same values (for
# bf16 their float32 copies).  Float32: both compute in float32 and sum the
# same products in other orders, so each gradient is within 1e-4 of its
# largest |g|.  Bf16 adds one term a rounding of the tensor-core kernel: a
# gradient is rounded to bf16 at the end, by at most 2^-8 of itself, and P
# and dS are rounded to bf16 before their products, each operand by at
# most 2^-9 of itself, so a product moves by at most 2^-9 of the product
# of magnitudes: dV by 2^-8 sum_heads |P|^T |do|, dK by 2^-8 scale
# sum_heads |dS|^T |q|, dQ by 2^-8 scale |dS| |k| (scale = 1/sqrt(D),
# computed in float32 by the plain version, bf16_rounding_terms; 2^-8
# leaves a factor 2).  tests/test_torch_flash_grad.py holds the plain
# emulation of those roundings within this bound on the CPU.
FLASH_BWD_TOL = 1e-4
# The MoE serving phases: arctic-480b at full width, 2 layers, lm_serve's
# traffic (8 prompts of 2048 tokens, 64 new tokens; capacity 320 copies an
# expert at the prefill); mixtral-8x22b at full width, 4 layers, 2 prompts
# of 6144 tokens (past its window of 4096, and 6144^2 above
# BLOCKED_THRESHOLD), 64 new tokens; 8 teacher-forced decode steps each;
# the dispatch checked on 256 tokens of arctic's layer 0.
MOE_ARCH = "arctic-480b"
MOE_WINDOW_ARCH = "mixtral-8x22b"
MOE_SHAPES = dict(layers=2, serve_batch=8, prompt=2048, new=64,
                  decode_steps=8, dispatch_tokens=256)
MOE_WINDOW_SHAPES = dict(layers=4, serve_batch=2, prompt=6144, new=64,
                         decode_steps=8, a2a_tokens=2048)
# The dispatch's expert output (float32 products of bf16-exact inputs,
# sums of 7168 and 4864 terms) against a float64 evaluation of the kept
# copies: float32's sums err by about 1e-6 of their terms' magnitudes, so
# 1e-3 of max |y| is loose for a right dispatch and far below a wrong
# copy's contribution (a whole expert's output, the size of max |y|).
MOE_DISPATCH_BOUND = 1e-3
# The sharded LM (launch/sharding.py, DTensor) on a (1, 1) mesh over a
# one-rank NCCL group.  shard_train: launch/train.py's train(mesh="1x1")
# at lm_train's shapes, 3 steps, then one make_train_step step with the
# ZeRO-3 hook; each loss within SHARD_LOSS_RTOL of lm_train's at the same
# step (the same seed and batches; the warm-up's learning rates do not
# depend on the run's length): on one rank the sharded step computes the
# plain step's values, so the bound only leaves room for a reordered sum.
# moe_train: mixtral-8x22b at full width, 1 of its 56 layers (the
# embedding, one attention and expert layer and the head: 2.9 G bf16
# parameters, 46 GB of trained state with float32 moments and gradient
# accumulators), 4 x 1024 tokens a step in 2 microbatches (the window's
# path materialises [B, H, T, T] float32 scores; 1024 keeps them at 0.4 GB
# a microbatch beside the state), 3 steps; one microbatch's gradients
# through the sharded step against the plain path's with the routes
# replayed, within TRAIN_BF16_GRAD_BOUND.
SHARD_TRAIN_STEPS = 3
SHARD_LOSS_RTOL = 1e-5
MOE_TRAIN_ARCH = "mixtral-8x22b"
MOE_TRAIN_SHAPES = dict(layers=1, seq=1024, batch=4, microbatches=2,
                        steps=3)
# The MLA and VLM phases, each model at full width and depth.
# minicpm3-4b: lm_serve's traffic (8 prompts of 2048 tokens, 64 new
# tokens), 8 teacher-forced decode steps, the float32 check at 4 layers.
# qwen2-vl-2b: the forward at 2 x 4096 from the vision stub's embeds
# (1024 text tokens, a 32 x 32 patch grid, then text); lm_serve's traffic,
# text only, and one prefill from the stub's embeds (512 text tokens, the
# grid, then text); one microbatch of 4 x 2048 (the same layout) through
# train_step's loss.
# tp_layer: Llama-3-8B's layer 0 split over a model axis of each size.
TP_SIZES = (2, 8, 16)
TP_SHAPES = dict(batch=2, seq=4096)
# The split layer's sum against the unsplit one, elementwise: each
# partial's bf16 rounding (2^-8 of its largest value, summed over the ranks
# and the two row-parallel parts) and the result's (2^-8 max|y|).
TP_FWD_BOUND = 2 ** -8
MLA_ARCH = "minicpm3-4b"
VLM_ARCH = "qwen2-vl-2b"
MLA_SHAPES = dict(serve_batch=8, prompt=2048, new=64, decode_steps=8,
                  tight_layers=4)
VLM_SHAPES = dict(fwd_batch=2, fwd_seq=4096, fwd_text0=1024, grid=32,
                  serve_batch=8, prompt=2048, new=64, decode_steps=8,
                  text0=512, grad_batch=4, grad_seq=2048)
# The Whisper phases, whisper-large-v3 at full width and depth: 8 clips of
# 1500 frames and 8 x 448 tokens (448 is Whisper's text context,
# max_target_positions of openai/whisper-large-v3's config); serving 8
# prompts of 384 tokens and 64 new ones (448 positions in all), 8
# teacher-forced decode steps, the float32 check at 4 encoder and 4 decoder
# layers; one microbatch of 4 clips and 4 x 448 tokens through
# train_step's loss.
WHISPER_ARCH = "whisper-large-v3"
WHISPER_SHAPES = dict(fwd_batch=8, text=448, prompt=384, new=64,
                      decode_steps=8, tight_layers=4, grad_batch=4)
# The recurrent phases, each model at full width and depth: the forward at
# 2 x 4096 (train_4k's sequence, its batch cut to 2); lm_serve's traffic
# (8 prompts of 2048 tokens, 64 new tokens) and 8 teacher-forced decode
# steps; the float32 check at full width with a prompt of 2000 tokens, at
# RECURRENT_TIGHT_LAYERS (recurrentgemma: one unit and the ("rec", "rec")
# tail, so the tail runs on the card; xlstm: two units, 2000 not a
# multiple of the 64-token chunk, so the padded prefill state is
# exercised); the mLSTM chunk check at layer 0 over 2 x 1024.
RECGEMMA_ARCH = "recurrentgemma-2b"
XLSTM_ARCH = "xlstm-350m"
RECURRENT_SHAPES = dict(fwd_batch=2, fwd_seq=4096, serve_batch=8,
                        prompt=2048, new=64, decode_steps=8,
                        tight_prompt=2000, mlstm_batch=2, mlstm_seq=1024)
RECURRENT_TIGHT_LAYERS = {RECGEMMA_ARCH: 5, XLSTM_ARCH: 4}
# rglru_scan: the log-depth scan (float32) against the sequential
# recurrence h_t = a_t h_{t-1} + b_t in float64 on the same (a, b).  h_t =
# sum_s P_st b_s, P_st = a_{s+1} ... a_t.  However a scan brackets it, the
# term of b_s reaches h_t through t - s multiplications (each merges one
# more factor) and, on its path, at most 2 ceil(log2 T) additions (one a
# combine), each rounded to float32 (u = 2^-24), so
#   |h32_t - h64_t| <= u sum_s (t - s + 2 ceil(log2 T)) P_st |b_s|,
# which the check computes in float64 beside the recurrence (two more
# recurrences: on |b|, and on the lags).  The gates make P decay fast at
# this init: a = exp(-8 softplus(lam) r) with lam in [0.9, 4] and r =
# sigmoid of an N(0, 1) product, so a <= exp(-9.9 sigmoid(-4)) = 0.84 but
# for odds of 3e-5 a channel, a mean lag a / (1 - a) of 5 at most; with 22
# additions at T = 2048 that is about 27 u = 1.6e-6 of sum |terms|, and
# 1e-5 of max |h| leaves sum |terms| up to 6 times max |h|.
RGLRU_SCAN_BOUND = 1e-5
# Teacher-forced decode against the forward for the recurrent models, bf16
# at full depth.  recurrentgemma-2b is held to LM_DECODE_BOUND, as the
# dense models are.  xlstm-350m is not: its bf16 forward itself lies 0.20
# of the largest logit from the same weights evaluated in float32 at this
# prompt, so any two bf16 evaluations of it part by that much (PERF.md).
# For both, decode's own distance from the float32 evaluation is held to
# RECURRENT_DECODE_FACTOR times the bf16 forward's at the same positions.
# Decode and forward round the same quantities to bf16 at the same points
# (each bf16 product's output, each block's output, the residual stream),
# so each is one bf16 evaluation of the same function and lies about as far
# from the float32 one; a decode-only fault adds its own error on top.  The
# factor leaves room for the spread of two such draws, a fixed one, not
# read from the run it judges.  The float32 checks (LM_TIGHT_BOUND) hold
# the decode path to the forward, and tests/test_torch_recurrent.py holds
# the bf16 forward, prefill and decode to the reference's at reduced size,
# decode to the same factor there, and the port's bf16 prefill and decode
# to two bf16 ulps of its own bf16 forward.
RECURRENT_DECODE_FACTOR = 1.5
RECURRENT_DECODE_HELD = (RECGEMMA_ARCH,)   # also within LM_DECODE_BOUND
# mlstm_chunks: the chunked forward (float32) against T steps of
# mlstm_decode in float64 on the same float32 weights and inputs, the
# relative L2 error over all outputs.  A float32 sum of n terms errs by at
# most n u of its terms' magnitudes.  An output's longest sums are the
# output projection (H hd = 1024 products), a q . k, C0^T q or n0 . q
# product (hd = 256), a chunk's keys (64) and the carry's chunk updates
# (16 at T = 1024): (1024 + 256 + 64 + 16) u = 8.1e-5 of the magnitudes
# where every rounding falls the same way, and errors of random sign add
# as sqrt(n) u, 40 times less.  1e-4 bounds the worst case where the
# terms' magnitudes are the outputs' size in L2, as a forward whose
# contributions do not cancel on average has them.
MLSTM_CHUNK_BOUND = 1e-4
# blocked_attention against _windowed_attention, both float32 with the
# same masked scores: only the order of the online softmax's sums parts
# them.
WINDOW_BLOCKED_BOUND = 1e-5
# flash_attention_bwd's device launches a call (float32: the row
# statistics, dK and dV, dQ; bf16: Delta, dK and dV, dQ); its counter
# counts launches.
BWD_LAUNCHES = 3
# The flash rows at shapes no LM phase runs: label -> ((B, H, H_kv, T, S,
# D), causal, dtype), float32 for the float32 kernel, bfloat16 for the bf16
# one.
FLASH_OFF_PATH = {
    "ragged": ((2, 32, 8, 1000, 1000, 128), True, "float32"),
    "noncausal": ((2, 16, 16, 512, 768, 64), False, "float32"),
    "ragged_bf16": ((2, 32, 8, 1000, 1000, 128), True, "bfloat16"),
    "noncausal_bf16": ((2, 16, 16, 512, 768, 128), False, "bfloat16")}
# flash_attention_bwd's float32 row at a head dim no model here trains at:
# ((B, H, H_kv, T, S, D), causal, dtype).
FLASH_BWD_OFF_PATH = {
    "d16_f32": ((2, 8, 2, 1000, 1000, 16), True, "float32")}
# The graph phases: name -> (algorithm module, mode, route, combiner,
# kernels its path must launch), run at RUN_SETTINGS (bench_pagerank.py's
# and bench_sssp.py's).
GRAPH_PHASES = {
    "delta_auto": ("pagerank", "delta", "auto", "add",
                   ("scatter_route", "delta_scatter")),
    "delta_sort": ("pagerank", "delta", "sort", "add",
                   ("delta_route", "delta_scatter")),
    "nodelta": ("pagerank", "nodelta", "sort", "add", ("edge_propagate",)),
    "sssp_auto": ("sssp", "delta", "auto", "min",
                  ("scatter_route", "delta_scatter")),
    "sssp_sort": ("sssp", "delta", "sort", "min",
                  ("delta_route", "delta_scatter")),
    "sssp_nodelta": ("sssp", "nodelta", "sort", "min", ("edge_propagate",)),
    "cc_auto": ("connected_components", "delta", "auto", "min",
                ("scatter_route", "delta_scatter")),
    "cc_nodelta": ("connected_components", "nodelta", "sort", "min",
                   ("edge_propagate",)),
}
RUN_SETTINGS = {"pagerank": dict(threshold=1e-3, max_iters=60),
                "sssp": dict(source=0, max_iters=80),
                "connected_components": dict(max_iters=80),
                "adsorption": dict(threshold=1e-3, max_iters=60)}
# The compiled rule programs (``repro_torch.frontend``) on the same graph:
# phase -> (program, mode, launch group, the handwritten phase it is
# printed beside, kernels its path must launch).  Their launches go to
# groups of their own, so the handwritten rows' counts stay comparable
# with earlier runs; reachability's feed the max rows.
RULES_PHASES = {
    "rules_pagerank": ("pagerank", "delta", "rules_add", "delta_auto",
                       ("scatter_route", "delta_scatter")),
    "rules_pagerank_nodelta": ("pagerank", "nodelta", "rules_add",
                               "nodelta", ("edge_propagate",)),
    "rules_sssp": ("sssp", "delta", "rules_min", "sssp_auto",
                   ("scatter_route", "delta_scatter")),
    "rules_cc": ("cc", "delta", "rules_min", "cc_auto",
                 ("scatter_route", "delta_scatter")),
    "rules_reach": ("reachability", "delta", "max", None,
                    ("scatter_route", "delta_scatter")),
    "rules_reach_nodelta": ("reachability", "nodelta", "max", None,
                            ("edge_propagate",)),
}
RULES_ITERS = {"pagerank": 60, "sssp": 80, "cc": 80, "reachability": 80}
# benchmarks/bench_frontend.py's budget for a compiled program's wall over
# the handwritten one's; printed only (the walls are single readings on a
# shared host).
RULES_OVERHEAD_BUDGET = 0.05
# Compiled delta PageRank against ``delta_auto``'s answer, relative to
# max(1, |value|).  Both fold their Δs with float atomics, whose order
# differs from run to run and can tip a vertex across the 1e-3 threshold
# in one run and not in the other: two runs of ``delta_auto`` itself came
# 1.263e-3, 1.450e-3 and 1.593e-3 apart (absolute), the compiled run
# 5.208e-4 (relative) from its twin, so the bound is about 3x the worst.
# nodelta's dense strata have no atomics: ``rules_pagerank_nodelta`` must
# equal ``nodelta`` exactly.
PAGERANK_TWIN_BOUND = 5e-3
# The shard_map backend on one rank: phase -> (its simulated twin, launch
# group).  Every phase runs at its twin's settings through an executor of
# backend "shard_map"; dist_sssp_sort takes the sort route, so delta_route
# runs on the new path too.
DIST_PHASES = {
    "dist_pagerank": ("delta_auto", "add"),
    "dist_pagerank_nodelta": ("nodelta", "add"),
    "dist_sssp": ("sssp_auto", "min"),
    "dist_sssp_sort": ("sssp_sort", "min"),
    "dist_cc": ("cc_auto", "min"),
    "dist_rules_sssp": ("rules_sssp", "rules_min"),
}
# Adsorption: 4 labels, a seed on every 100th vertex v with label
# (v / 100) mod 4 (v mod 4 would give every seed label 0).  Phase ->
# (mode, route, kernels its path must launch); the dense body is the
# algorithm's own scatter, so nodelta launches no kernel.
ADS_LABELS = 4
ADS_SEED_EVERY = 100
ADSORPTION_PHASES = {
    "adsorption_auto": ("delta", "auto", ("scatter_route", "delta_scatter")),
    "adsorption_sort": ("delta", "sort", ("delta_route", "delta_scatter")),
    "adsorption_nodelta": ("nodelta", "sort", ()),
}
ADS_GROUP = "adsorption"    # its phases' launches feed the W = 4 rows
W1_GROUPS = ("add", "min")  # the W = 1 graph phases, for delta_route
ADS_DELTA_BOUND = 5e-2      # delta vs nodelta, tests/test_algorithms.py's
# Against the float64 fixpoint x = 0.25 s + 0.75 A x (A: u -> v weighted
# 1/deg(u)): a run stops when every vertex's unsent change r = vec - sent
# is within the threshold t, and its state keeps acc = A sent, so
# vec - x = -(I - 0.75 A)^-1 0.75 A r, at most t * beta with
# beta = sum_k>=1 (0.75 A)^k 1 (the same holds for nodelta, whose r is
# its last step).  Per vertex: |vec - x| <= t * beta + ADS_F32 |x|, the
# last term for float32 sums of positive terms.
ADS_F32 = 1e-3
# Fig 12's setting (bench_recovery.py): SSSP, one shard (1) lost at these
# fractions of the failure-free strata.
RECOVER_AT = (0.25, 0.5, 0.75)
FAILED_SHARD = 1
# The multi-process launch (launch/distributed.py): sssp_real_kill's
# cluster of LAUNCH_WORKERS local-mode workers (each acks with a sum
# computed on cuda:0), worker KILLED_WORKER SIGKILLed at the barrier of
# stratum KILL_AT (sssp_recover_25's failure stratum, on the worker that
# leases its shard 1 and shard 5), found by its lease alone; sssp_chaos_real
# runs sssp_chaos's schedule as signals against one protocol worker a
# shard.  Leases and acks: tests/test_distributed.py's settings.
LAUNCH_WORKERS = 4
KILLED_WORKER = 1
KILL_AT = 2
LAUNCH_HEALTH = dict(lease_ttl=1.0, straggle_after=0.3,
                     heartbeat_interval=0.05, ack_timeout=0.5,
                     ready_timeout=180.0)
# The shard_map backend's resilient runs: phase -> (its failure-free
# shard_map run, its simulated twin, launch group); shard 3 lost at half
# the failure-free strata (tests/test_resilient.py's shard_map case).
DIST_RESILIENT = {
    "dist_sssp_resilient": ("dist_sssp", "sssp_recover_50", "min"),
    "dist_pagerank_resilient": ("dist_pagerank", "delta_auto", "add"),
}
DIST_FAILED_SHARD = 3

# Incremental views (bench_incremental.py's setting): one warm-up batch,
# then VIEW_BATCHES measured ones, each inserting and deleting VIEW_FRAC / 2
# of |E|; fallback_threshold 2.0, so every batch takes the repair path.
# Phase -> (algorithm, params, launch group, kernels its repairs must
# launch).  The views' launches go to groups of their own: their repairs
# run at the resume executor's smaller capacities, so they feed the rows
# that VIEW_ROWS builds from a view's own repair, not the cold phases'.
VIEW_FRAC = 0.01
VIEW_BATCHES = 2
VIEW_FALLBACK = 2.0
VIEW_NEEDS = ("scatter_route", "delta_scatter")
VIEW_PHASES = {
    "view_pagerank": ("pagerank", dict(threshold=1e-4, max_iters=100),
                      "view_add", VIEW_NEEDS),
    "view_sssp": ("sssp", dict(source=0, max_iters=100), "view_min",
                  VIEW_NEEDS),
    "view_cc": ("connected_components", dict(max_iters=100), "view_min",
                VIEW_NEEDS),
    "view_sssp_resilient": ("sssp", dict(source=0, max_iters=100),
                            "view_min", VIEW_NEEDS),
    "view_journal": ("sssp", dict(source=0, max_iters=100), "view_min",
                     VIEW_NEEDS),
}
# Phase -> combiner: the phases whose last measured repair gives the
# kernel rows of their launch group.
VIEW_ROWS = {"view_pagerank": "add", "view_sssp": "min"}
# The k-means view: --points / KMEANS_VIEW_CUT points (a tenth of the
# paper's 382 M by default), k = 32, KMEANS_STRATA strata; each batch
# removes KMEANS_VIEW_BATCH points and inserts as many, each a valid point
# moved by the generator's jitter.  At this size no centroid's count
# reaches 2^24, so float32 counts stay exact integers.
KMEANS_VIEW_CUT = 10
KMEANS_VIEW_BATCH = 1000
KMEANS_JITTER = 0.15
# The view's (sums, counts) against a float64 sum over the store's valid
# points, per centroid: counts exactly (see KMEANS_VIEW_CUT),
# sums within this share of the centroid's sum of |coordinates|; float32
# cells of at most 16,384 points and the strata's adjustments round far
# below it.
KMEANS_SUM_RTOL = 1e-4

KERNELS = {  # name: (source, TPU kernel it replaces)
    "scatter_route": ("src/repro_torch/kernels/csrc/scatter_route.cu",
                      "src/repro/kernels/scatter_route/scatter_route.py:112"),
    "delta_route": ("src/repro_torch/kernels/csrc/delta_route.cu",
                    "src/repro/kernels/delta_route/delta_route.py:100"),
    "delta_scatter": ("src/repro_torch/kernels/csrc/delta_scatter.cu",
                      "src/repro/kernels/delta_scatter/delta_scatter.py:73"),
    "edge_propagate": ("src/repro_torch/kernels/csrc/edge_propagate.cu",
                       "src/repro/kernels/edge_propagate/"
                       "edge_propagate.py:71"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kmeans_assign.py:40"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:80"),
    "flash_attention_bf16": ("src/repro_torch/kernels/csrc/"
                             "flash_attention_bf16.cu",
                             "src/repro/kernels/flash_attention/"
                             "flash_attention.py:80"),
    # No Pallas backward exists: the reference trains through attention_ref
    # and XLA differentiates it.  Two files: bf16 (tensor cores, the main
    # path) here, float32 (CUDA cores) at BWD_F32_SOURCE; a row names the
    # file of its dtype.
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                            "flash_attention_bwd_bf16.cu",
                            "src/repro/kernels/flash_attention/ref.py:8"),
}
BWD_F32_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch
    torch.cuda.synchronize()


@contextlib.contextmanager
def one_rank_mesh(dev):
    """A (1, 1) ("data", "model") mesh over a one-rank group (NCCL on the
    card, gloo on the CPU), its store in a directory under ``build/``;
    the group is destroyed and the directory removed after."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_shard_group, make_mesh
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="mesh_pg_") as td:
        init_shard_group("nccl" if dev.type == "cuda" else "gloo",
                         f"file://{td}/store", world_size=1, rank=0)
        try:
            yield make_mesh((1, 1), ("data", "model"), device=dev.type)
        finally:
            dist.destroy_process_group()


def time_ms(fn, reps: int = 5) -> float:
    """Milliseconds a call: CUDA events around ``reps`` calls after one
    warm-up, and again around enough calls to fill TIME_MIN_MS when the
    first ``reps`` took less (a kernel of microseconds timed over a few
    calls reads the card's clocks still rising)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(n):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    ms = timed(reps)
    if ms < TIME_MIN_MS:
        reps = math.ceil(reps * TIME_MIN_MS / max(ms, 1e-3))
        ms = timed(reps)
    return ms / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least milliseconds: bytes over HBM_BYTES_PER_S or ``ops`` at
    ``ops_per_s``, the larger, and which of the two it is."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def compare(name: str, got, ref, float_idx=(), scale=None) -> float:
    """Outputs in ``float_idx`` within FLOAT_RTOL of ``scale``, all others
    exactly; returns the max absolute difference over the float outputs.
    ``scale`` (parallel to the outputs) is the plain version run on the
    magnitudes of its inputs, each float slot's sum of |terms|, the
    measure of a reordered float sum's error; where it is None, |ref|,
    which is the same where no terms cancel."""
    import torch
    err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"{name}: output {i} is {g.dtype}{tuple(g.shape)}, plain "
              f"version {r.dtype}{tuple(r.shape)}")
        if not g.dtype.is_floating_point:
            check(torch.equal(g, r), f"{name}: output {i} differs")
            continue
        diff = torch.where(g == r, 0.0, (g - r).abs())   # inf == inf
        if diff.numel():
            err = max(err, float(diff.max()))
        if i in float_idx:
            mag = r.abs() if scale is None else scale[i].abs()
            ok = bool(torch.all(diff <= FLOAT_RTOL * mag + 1e-30))
            check(ok, f"{name}: float output {i} off by up to {err:.3e} "
                      f"(rtol {FLOAT_RTOL})")
        else:
            check(torch.equal(g, r), f"{name}: output {i} differs")
    return err


def row(name, combiner, err, ms, plain_ms, b, library_ms, shape,
        label=None, source=None):
    """One kernel check.  ``combiner`` groups the phases whose launches
    the row reports: a combiner, an LM phase's name or a tuple of them
    (None: every phase); ``label`` names the row when it is not the
    kernel's name with its combiner; ``source`` its file when it is not
    the kernel's in KERNELS.  ``seq_ms``, set by a row function, is printed on
    a line beside the row."""
    return dict(name=name, combiner=combiner, err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=library_ms, shape=shape, label=label,
                seq_ms=None, source=source)


def row_name(r) -> str:
    """The row's name in the kernels JSON line."""
    if r["label"]:
        return r["label"]
    if r["combiner"] in (None, "add"):
        return r["name"]
    return f"{r['name']}/{r['combiner']}"


def print_rows(rows) -> None:
    for r in rows:
        lib = (f"{r['library_ms']:.3f} ms" if r["library_ms"] is not None
               else "none")
        name = r["label"] or f"{r['name']} [{r['combiner']}]"
        print(f"kernel {name}: {r['shape']} ok "
              f"max_abs_err {r['err']:.3e} kernel {r['ms']:.3f} ms plain "
              f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) library {lib}", flush=True)
        if r["seq_ms"] is not None:
            print(f"kernel {name}: to_local_keys + kernel on local keys "
                  f"{r['seq_ms']:.3f} ms, single launch on global keys "
                  f"{r['ms']:.3f} ms", flush=True)


def scatter_route_row(out, snap, seg, combiner, group=None, label=None):
    """scatter_route on one shard's outgoing deltas ``out`` at rung
    capacity ``seg``; ``group`` (default: the combiner) names the phases
    whose launches the row reports."""
    import torch
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.kernels import scatter_route as sr
    S, B = snap.num_shards, snap.block_size
    keys = out.keys
    owners = torch.where(keys != PAD_KEY, snap.owner_of(keys), S)
    args = (keys, out.payload, snap.local_index(keys), owners, S, B, seg,
            combiner)
    got = sr.scatter_route(*args)
    ref = sr.scatter_route_ref(*args)
    scale = (sr.scatter_route_ref(keys, out.payload.abs(), *args[2:])
             if combiner == "add" else None)
    err = compare(f"scatter_route/{combiner}", got, ref,
                  float_idx=(1,) if combiner == "add" else (), scale=scale)
    # Every key is read; local, owner and payload only for live keys.
    live = int((keys != PAD_KEY).sum())
    W = out.payload.shape[1]
    b = bound(keys.numel() * 4 + live * (8 + 4 * W) + nbytes(*got), live * W)
    return row("scatter_route", group or combiner, err,
               time_ms(lambda: sr.scatter_route(*args)),
               time_ms(lambda: sr.scatter_route_ref(*args)), b, None,
               f"C={keys.numel()} live={live} S={S} B={B} cap={seg} W={W}",
               label=label)


def delta_route_row(out, snap, seg, group, label, combiner="add"):
    """delta_route on one shard's outgoing deltas ``out``, pre-aggregated
    by ``combiner`` as the sort strategy does, at rung capacity ``seg``."""
    import torch
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.handlers import pre_aggregate
    from repro_torch.kernels import delta_route as dr
    S = snap.num_shards
    agg = pre_aggregate(out, combiner)
    owners = torch.where(agg.keys != PAD_KEY, snap.owner_of(agg.keys), S)
    args = (agg.keys, agg.payload, agg.ann, owners, S, seg)
    got = dr.delta_route(*args)
    ref = dr.delta_route_ref(*args)
    err = compare("delta_route", got, ref)
    # Every key is read; owner, payload and ann only for live keys.
    live = int((agg.keys != PAD_KEY).sum())
    W = agg.payload.shape[1]
    b = bound(agg.keys.numel() * 4 + live * (5 + 4 * W) + nbytes(*got), 0)
    return row("delta_route", group, err,
               time_ms(lambda: dr.delta_route(*args)),
               time_ms(lambda: dr.delta_route_ref(*args)), b, None,
               f"C={agg.keys.numel()} live={live} S={S} cap={seg} W={W}",
               label=label)


def delta_scatter_row(state, db, shard, combiner, group=None, label=None):
    """delta_scatter of shard ``shard``'s incoming buffer ``db`` into
    ``state``, as the path calls it: the buffer's global keys and
    ``key_base = shard * N``; ``group`` as in :func:`scatter_route_row`.
    Also times ``to_local_keys`` followed by the kernel on the local keys
    (``seq_ms``): what the single launch saves."""
    import torch
    from repro_torch.algorithms import emission
    from repro_torch.kernels import delta_scatter as ds
    B, W = state.shape
    keys, pay = db.keys.contiguous(), db.payload.contiguous()
    base = shard * B
    got = ds.delta_scatter(state, keys, pay, combiner, base)
    ref = ds.delta_scatter_ref(state, keys, pay, combiner, base)
    scale = ([ds.delta_scatter_ref(state.abs(), keys, pay.abs(), "add",
                                   base)] if combiner == "add" else None)
    err = compare(f"delta_scatter/{combiner}", [got], [ref],
                  float_idx=(0,) if combiner == "add" else (), scale=scale)
    # Every key is read; the payload only where its row is in range; the
    # state is read and written once.
    local = emission.to_local_keys(db, shard, B)
    in_range = (local >= 0) & (local < B)
    live = int(in_range.sum())
    b = bound(nbytes(keys) + live * 4 * W + 2 * nbytes(state), live * W)
    lib_idx = torch.where(in_range, local, B).long()
    if combiner == "add":
        lib = lambda: torch.zeros((B + 1, W), device=state.device).index_add_(
            0, lib_idx, pay)
    else:
        fill = float("inf") if combiner == "min" else float("-inf")
        lib = lambda: torch.full((B + 1, W), fill, device=state.device
                                 ).scatter_reduce_(
            0, lib_idx[:, None].expand(-1, W), pay, "a" + combiner)
    seq = lambda: ds.delta_scatter(
        state, emission.to_local_keys(db, shard, B).contiguous(), pay,
        combiner)
    r = row("delta_scatter", group or combiner, err,
            time_ms(lambda: ds.delta_scatter(state, keys, pay, combiner,
                                             base)),
            time_ms(lambda: ds.delta_scatter_ref(state, keys, pay, combiner,
                                                 base)),
            b, time_ms(lib), f"N={B} C={keys.numel()} live={live} W={W} "
                             f"key_base={base}", label=label)
    r["seq_ms"] = time_ms(seq)
    return r


def edge_propagate_bins(csc, label) -> None:
    """Prints the CSC's row bins: light rows, heavy rows, heavy edges."""
    from repro_torch.kernels import edge_propagate as ep
    heavy = csc.heavy.long()
    n_dst = csc.indptr.numel() - 1
    heavy_edges = int((csc.indptr[heavy + 1] - csc.indptr[heavy]).sum())
    print(f"{label} bins: light rows {n_dst - heavy.numel()}, heavy rows "
          f"{heavy.numel()} (> {ep.HEAVY_EDGES} edges), heavy edges "
          f"{heavy_edges} of {csc.src.numel()}", flush=True)


def edge_propagate_row(payload, csc, combiner, also=(), group=None,
                       label=None):
    """edge_propagate of one shard's dense stratum over ``csc``, timed at
    ``payload`` and held to its plain version at ``payload`` and each of
    ``also``; ``group`` as in :func:`scatter_route_row`."""
    import torch
    from repro_torch.kernels import edge_propagate as ep
    plain_csc = (csc.indptr, csc.src, csc.weight)
    n_pad = csc.indptr.numel() - 1
    err = 0.0
    for x in (payload, *also):
        got = ep.edge_propagate(x, csc, combiner)
        ref = ep.edge_propagate_ref(x, *plain_csc, combiner)
        scale = ([ep.edge_propagate_ref(x.abs(), csc.indptr, csc.src,
                                        csc.weight.abs(), "add")]
                 if combiner == "add" else None)
        err = max(err, compare(f"edge_propagate/{combiner}", [got], [ref],
                               float_idx=(0,) if combiner == "add" else (),
                               scale=scale))
    n_edges = csc.src.numel()
    # The function's bytes: the heavy list is the layout's, not the work's.
    b = bound(nbytes(payload, *plain_csc, got), 2 * n_edges)
    dst = torch.repeat_interleave(
        torch.arange(n_pad, device=payload.device),
        (csc.indptr[1:] - csc.indptr[:-1]).long(), output_size=n_edges)
    if combiner == "add":
        lib = lambda: torch.zeros(n_pad, device=payload.device).index_add_(
            0, dst, payload[csc.src] * csc.weight)
    else:
        lib = lambda: torch.full(
            (n_pad,), float("inf") if combiner == "min" else float("-inf"),
            device=payload.device).scatter_reduce_(
            0, dst, payload[csc.src] * csc.weight, "a" + combiner)
    return row("edge_propagate", group or combiner, err,
               time_ms(lambda: ep.edge_propagate(payload, csc, combiner)),
               time_ms(lambda: ep.edge_propagate_ref(payload, *plain_csc,
                                                     combiner)),
               b, time_ms(lib), f"n_dst={n_pad} E={n_edges} "
                                f"N_src={payload.numel()}", label=label)


def pagerank_edge_row(graph, snap, csc):
    """edge_propagate (add) over shard 0's ``csc`` at the first dense
    stratum from PageRank's initial state."""
    import torch
    from repro_torch.algorithms import pagerank
    from repro_torch.core.engine import _take
    g0 = _take(graph, 0)
    pr = pagerank.current_pr(_take(pagerank.initial_state(snap,
                                                          graph.device), 0))
    payload = pr / torch.clamp(g0.out_degree, min=1).to(pr.dtype)
    return edge_propagate_row(payload, csc, "add")


def sssp_edge_row(graph, snap, csc, also=()):
    """edge_propagate (min) over shard 0's ``csc`` at ``sssp_nodelta``'s
    first stratum, where every payload but the source's is inf; held also
    at the payloads of the distances ``also``."""
    import torch
    from repro_torch.algorithms import sssp

    def payload_of(d):
        return torch.where(d < float("inf"), d + 1.0, float("inf"))

    d0 = sssp.initial_state(snap, 0, graph.device).dist[0]
    return edge_propagate_row(payload_of(d0), csc, "min",
                              also=tuple(payload_of(d) for d in also))


def shard0_csc(graph, snap):
    """Shard 0's ragged CSC over every padded destination, as the nodelta
    phases build it."""
    from repro_torch.core.engine import _take
    from repro_torch.kernels import edge_propagate as ep
    return ep.build_csc(_take(graph, 0), snap.padded_keys)


def pagerank_kernel_checks(graph, snap, ex, algo):
    """Each PageRank kernel against its plain version at the first
    stratum's inputs (the first dense stratum for edge_propagate)."""
    import torch
    from repro_torch.algorithms import pagerank
    from repro_torch.core.engine import _stack, _take

    S, B = snap.num_shards, snap.block_size
    top = ex.capacity_tiers(algo)[-1]
    state = pagerank.initial_state(snap, graph.device)
    parts = []
    for s in range(S):
        st, g = _take(state, s), _take(graph, s)
        active, _ = algo.active_fn(st, g)
        parts.append(algo.sparse_emit(st, g, active, 0, s)[1])
    out0 = parts[0]
    rows = [scatter_route_row(out0, snap, top.seg, "add"),
            delta_route_row(out0, snap, top.seg, W1_GROUPS, "delta_route")]

    # delta_scatter: shard 0's incoming deltas after the segment swap.
    incoming, _ = ex.rehash_sparse(_stack(parts), top.seg, "add",
                                   "scatter")
    del parts, out0
    in0 = _take(incoming, 0)
    del incoming
    rows.append(delta_scatter_row(
        torch.zeros((B, 1), device=graph.device), in0, 0, "add"))
    del in0

    # edge_propagate: shard 0's dense stratum from the initial state.
    csc = shard0_csc(graph, snap)
    edge_propagate_bins(csc, "edge_propagate/add")
    rows.append(pagerank_edge_row(graph, snap, csc))
    torch.cuda.empty_cache()
    return rows


def widest_stratum(ex, algo, graph, state, stats, what, busiest=False,
                   route=None):
    """Replays a run from ``state`` to the first stratum on the widest
    rung it routed at (``busiest``: the one of those that emitted most;
    ``route``: of the strata that took that route) and emits it at that
    rung: (state there, each shard's outgoing deltas, the stratum, the
    shard that emits most)."""
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _take
    it = int(stats.iterations)
    routes = stats.routes[:it].tolist()
    tier_of = [t if route is None or r == route else -1
               for t, r in zip(stats.tiers[:it].tolist(), routes)]
    emitted = stats.delta_counts[:it].tolist()
    widest = max(tier_of)
    check(widest >= 0, f"{what}: no sparse stratum")
    on_it = [i for i in range(it) if tier_of[i] == widest]
    at = max(on_it, key=lambda i: emitted[i]) if busiest else on_it[0]
    step = ex.make_stratum_fn(algo, graph)
    for i in range(at):
        state, _ = step(state, i)
    tiers = ex.capacity_tiers(algo)
    tier = tiers[widest]
    emit_fn = ex._emit_fn(algo, tier)
    parts = []
    for s in range(ex.snapshot.num_shards):
        st, g = _take(state, s), _take(graph, s)
        active, _ = algo.active_fn(st, g)
        parts.append(emit_fn(st, g, active, at, s)[1])
    src = max(range(len(parts)),
              key=lambda s: int((parts[s].keys != PAD_KEY).sum()))
    print(f"{what} checks at stratum {at} (rung {widest} of "
          f"{len(tiers) - 1}: {tier.src} src, {tier.edge} edge, {tier.seg} "
          f"seg), source shard {src}", flush=True)
    return state, parts, at, src


def sssp_kernel_checks(graph, snap, ex, algo, stats):
    """The min kernels: scatter_route and delta_scatter at the widest
    sparse stratum of ``sssp_auto`` that routed at the top rung (the
    widest sparse one if none did), edge_propagate at ``sssp_nodelta``'s
    first stratum, where every payload but the source's is inf, and held
    also at that widest stratum's, where most are finite."""
    import torch
    from repro_torch.algorithms import sssp
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _stack, _take

    S = snap.num_shards
    state, parts, at, src = widest_stratum(
        ex, algo, graph, sssp.initial_state(snap, 0, graph.device), stats,
        "sssp min", busiest=True)
    tier = ex.capacity_tiers(algo)[int(stats.tiers[at])]
    rows = [scatter_route_row(parts[src], snap, tier.seg, "min")]

    incoming, _ = ex.rehash_sparse(_stack(parts), tier.seg, "min",
                                   "scatter")
    del parts
    dst = max(range(S), key=lambda s: int((incoming.keys[s] != PAD_KEY)
                                          .sum()))
    in_s = _take(incoming, dst)
    dist = state.dist[dst][:, None].contiguous()
    mid = state.dist[0]
    del incoming, state
    rows.append(delta_scatter_row(dist, in_s, dst, "min"))
    del in_s, dist

    d0 = sssp.initial_state(snap, 0, graph.device).dist[0]
    print(f"edge_propagate min: finite payloads {int(torch.isfinite(d0).sum())}"
          f" at stratum 0, {int(torch.isfinite(mid).sum())} at stratum {at} "
          f"of {mid.numel()}", flush=True)
    csc = shard0_csc(graph, snap)
    edge_propagate_bins(csc, "edge_propagate/min")
    rows.append(sssp_edge_row(graph, snap, csc, also=(mid,)))
    torch.cuda.empty_cache()
    return rows


def kmeans_kernel_check(points, cents, group="kmeans",
                        label="kmeans_assign"):
    """kmeans_assign at the full shape, against its plain version run in
    chunks (the plain [N, K] matrix would not fit); ``group`` as in
    :func:`scatter_route_row`."""
    import torch
    from repro_torch.kernels import kmeans_assign as ka
    N, D = points.shape
    K = cents.shape[0]
    got_a, got_d = ka.assign(points, cents)
    eps = torch.finfo(torch.float32).eps
    c2 = (cents ** 2).sum(-1)
    n_near = n_differ = 0
    err = 0.0
    for lo in range(0, N, KMEANS_CHUNK):
        p = points[lo:lo + KMEANS_CHUNK]
        d2 = ka.kmeans_d2(p, cents)
        top2, arg2 = d2.topk(2, largest=False)
        ref_a = arg2[:, 0].to(torch.int32)
        # topk and argmin agree except at exact ties; argmin takes the
        # first index, which is the contract.
        ref_a = torch.where(top2[:, 0] == top2[:, 1],
                            torch.argmin(d2, -1).to(torch.int32), ref_a)
        a, d = got_a[lo:lo + KMEANS_CHUNK], got_d[lo:lo + KMEANS_CHUNK]
        scale = (p ** 2).sum(-1) + torch.maximum(c2[a.long()],
                                                 c2[ref_a.long()])
        tol = 4 * eps * scale
        near = (top2[:, 1] - top2[:, 0]) <= tol
        differ = a != ref_a
        check(bool((~differ | near).all()),
              "kmeans_assign: an assignment differs away from a near-tie")
        n_near += int(near.sum())
        n_differ += int(differ.sum())
        derr = (d - top2[:, 0]).abs()
        check(bool((derr <= tol).all()), "kmeans_assign: d2 off by more "
                                         "than 4 ulp of |p|^2 + |c|^2")
        err = max(err, float(derr.max()))
        del d2, top2, arg2
    print(f"kmeans_assign: {n_differ} assignments differ from the plain "
          f"version, all at near-ties; {n_near} points are near-ties "
          f"(best two d2 within 4 ulp)", flush=True)

    def plain():
        for lo in range(0, N, KMEANS_CHUNK):
            ka.kmeans_assign_ref(points[lo:lo + KMEANS_CHUNK], cents)

    b = bound(N * (4 * D + 8) + K * D * 4, N * K * (2 * D + 3))
    out = row("kmeans_assign", group, err,
              time_ms(lambda: ka.assign(points, cents)),
              time_ms(plain, reps=2), b, None, f"N={N} D={D} K={K}",
              label=label)
    torch.cuda.empty_cache()
    return out


def lloyd_f64(points, init, max_iters):
    """Float64 Lloyd iteration shaped like the engine's: assign from
    ``init``, then up to ``max_iters`` rounds of centroids -> assignment,
    stopping after a round where no point switched.  Returns (centroids,
    rounds)."""
    import torch
    N = points.shape[0]
    K = init.shape[0]
    assign = torch.empty(N, dtype=torch.int64, device=points.device)

    def step(cents):
        """New assignment in place; returns (switched, sums, counts)."""
        m2 = -2.0 * cents.T
        c2 = (cents ** 2).sum(-1)
        sums = torch.zeros_like(cents)
        counts = torch.zeros(K, dtype=torch.float64, device=cents.device)
        switched = torch.zeros((), dtype=torch.int64, device=cents.device)
        for lo in range(0, N, KMEANS_CHUNK):
            p = points[lo:lo + KMEANS_CHUNK].double()
            a = torch.addmm(c2[None, :], p, m2).argmin(1)
            switched += (a != assign[lo:lo + KMEANS_CHUNK]).sum()
            assign[lo:lo + KMEANS_CHUNK] = a
            for j in range(p.shape[1]):
                sums[:, j] += torch.bincount(a, weights=p[:, j], minlength=K)
            counts += torch.bincount(a, minlength=K).double()
        return int(switched), sums, counts

    assign.fill_(-1)
    _, sums, counts = step(init.double())
    rounds = 0
    while rounds < max_iters:
        switched, sums, counts = step(sums / counts.clamp(min=1)[:, None])
        rounds += 1
        if switched == 0:
            break
    return sums / counts.clamp(min=1)[:, None], rounds


class Phases:
    """Runs phases with launch counts reset, checks their kernels, and
    keeps each phase's launches for the kernel rows.  ``counters`` maps a
    kernel to (its ops module, the name of its launch counter there)."""

    def __init__(self, counters):
        self.counters = counters
        self.launches = []   # (combiner or LM phase, {kernel: launches})
        self.walls = {}      # phase name -> wall of its measured call (s)
        self.stats = {}      # phase name -> StratumStats of that call

    def counts(self) -> dict:
        return {k: getattr(mod, attr)
                for k, (mod, attr) in self.counters.items()}

    def run(self, name, combiner, needs, fn, warm_up=True):
        import torch
        if warm_up:
            fn()
            sync()
        torch.cuda.reset_peak_memory_stats()
        for mod, attr in self.counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        self.walls[name] = wall
        if isinstance(out, tuple) and hasattr(out[-1], "stats"):
            self.stats[name] = out[-1].stats
        counts = self.counts()
        self.launches.append((combiner, counts))
        for k in needs:
            check(counts[k] > 0, f"{name}: kernel {k} was never launched")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return out, wall, counts, peak

    def of(self, kernel, group) -> int:
        """Launches of ``kernel`` over the phases of ``group``: a combiner
        or LM phase, a tuple of them, or None for every phase."""
        groups = group if isinstance(group, tuple) else (group,)
        return sum(c[kernel] for comb, c in self.launches
                   if group is None or comb in groups)


def stats_line(st) -> str:
    it = int(st.iterations)
    return (f"iterations {it} tiers "
            f"{dict(collections.Counter(st.tiers[:it].tolist()))} routes "
            f"{dict(collections.Counter(st.routes[:it].tolist()))}")


def make_graph(n, shards, seed, dev):
    """The DBPedia-shaped graph of ``n`` vertices (average degree 14.5,
    Zipf exponent 2.1) in ``shards`` shards: (indptr, indices, graph,
    snap)."""
    from repro_torch.core.partition import PartitionSnapshot
    from repro_torch.data.graphs import make_powerlaw_graph, shard_csr
    indptr, indices = make_powerlaw_graph(n, 14.5, 2.1, seed=seed)
    graph = shard_csr(indptr, indices, shards, device=dev)
    return indptr, indices, graph, PartitionSnapshot(n_keys=n,
                                                     num_shards=shards)


def capacities(snap) -> dict:
    """The engine's capacities: a ladder of 4 rungs, edge capacity 4n,
    source capacity one block."""
    return dict(edge_capacity=4 * snap.n_keys, src_capacity=snap.block_size,
                ladder_tiers=4)


def graph_phase(name, graph, snap, dev):
    """Phase ``name`` of GRAPH_PHASES at RUN_SETTINGS: (combiner, kernels
    its path must launch, a function that runs it)."""
    import importlib
    algo, mode, route, combiner, needs = GRAPH_PHASES[name]
    mod = importlib.import_module(f"repro_torch.algorithms.{algo}")
    kw = dict(RUN_SETTINGS[algo], device=dev, **capacities(snap))
    return combiner, needs, lambda: mod.run(graph, snap, mode=mode,
                                            route_strategy=route, **kw)


def graph_section(args, dev, phases, rows):
    """PageRank, SSSP and CC on the DBPedia-shaped graph."""
    import torch
    from repro_torch.algorithms import connected_components as cc
    from repro_torch.algorithms import pagerank, sssp
    from repro_torch.core.engine import ShardedExecutor

    n, S = args.n, args.shards
    t0 = time.perf_counter()
    indptr, indices, graph, snap = make_graph(n, S, args.seed, dev)
    per_shard = graph.out_degree.sum(1).tolist()
    print(f"graph: n={n} edges={len(indices)} shards={S} block="
          f"{snap.block_size} edges/shard {min(per_shard)}..{max(per_shard)}"
          f" max out-degree {int(graph.out_degree.max())} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cap = capacities(snap)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto")

    # PageRank.
    algo = pagerank.make_algorithm(
        snap, RUN_SETTINGS["pagerank"]["threshold"], cap["src_capacity"],
        cap["edge_capacity"])
    print("rungs: " + " ".join(
        f"({t.src} src, {t.edge} edge, {t.seg} seg -> "
        f"{ex.pick_route_strategy(t.edge, 'add')})"
        for t in ex.capacity_tiers(algo)))
    rows += pagerank_kernel_checks(graph, snap, ex, algo)
    ref = pagerank.reference_pagerank(indptr, indices, n, iters=300,
                                      device=dev)
    values = {}
    for name in ("delta_auto", "delta_sort", "nodelta"):
        (pr, res), wall, counts, peak = phases.run(
            name, *graph_phase(name, graph, snap, dev))
        check(pr.shape == (snap.padded_keys,), f"{name}: pr shape {pr.shape}")
        check(bool(torch.isfinite(pr).all()), f"{name}: non-finite pr")
        rel = float(((pr[:n] - ref).abs() / ref.abs().clamp(min=1)).max())
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s "
              f"launches {counts} peak_mem {peak:.2f} GiB rel_err_vs_f64 "
              f"{rel:.3e}", flush=True)
        check(rel < PHASE_BOUND, f"{name}: rel_err_vs_f64 {rel:.3e} over "
                                 f"{PHASE_BOUND}")
        values[name] = pr
        del res
        torch.cuda.empty_cache()
    pagerank_obs_phases(graph, snap, dev, phases, ref, values)
    sort_vs_auto = float((values["delta_sort"] - values["delta_auto"])
                         .abs().max())
    print(f"max|delta_sort - delta_auto| {sort_vs_auto:.3e} (bound "
          f"{PHASE_BOUND})", flush=True)
    check(sort_vs_auto < PHASE_BOUND, "delta_sort and delta_auto disagree")
    # the handwritten answers the rules phases must equal
    kept = {name: values[name] for name in ("delta_auto", "nodelta")}
    del values

    # Delta against nodelta, and both against the oracle, at 1e-5.
    tight = dict(RUN_SETTINGS["pagerank"], threshold=1e-5, max_iters=120,
                 device=dev, **cap)
    pr_d, res_d = pagerank.run(graph, snap, mode="delta",
                               route_strategy="auto", **tight)
    pr_n, res_n = pagerank.run(graph, snap, mode="nodelta", **tight)
    agree = float((pr_d - pr_n).abs().max())
    rel_d = float(((pr_d[:n] - ref).abs() / ref.abs().clamp(min=1)).max())
    rel_n = float(((pr_n[:n] - ref).abs() / ref.abs().clamp(min=1)).max())
    print(f"accuracy at threshold 1e-5: delta {int(res_d.stats.iterations)} "
          f"strata, nodelta {int(res_n.stats.iterations)}; max|delta - "
          f"nodelta| {agree:.3e}; rel_err_vs_f64 delta {rel_d:.3e} nodelta "
          f"{rel_n:.3e} (bound {ACCURACY_BOUND})", flush=True)
    check(agree < ACCURACY_BOUND, "delta and nodelta disagree")
    check(max(rel_d, rel_n) < ACCURACY_BOUND, "values off the oracle")
    del pr_d, res_d, pr_n, res_n
    torch.cuda.empty_cache()

    # SSSP from vertex 0, exactly equal to a BFS on the card.
    t0 = time.perf_counter()
    bfs = sssp.reference_sssp(indptr, indices, n,
                              RUN_SETTINGS["sssp"]["source"], device=dev)
    sync()
    print(f"sssp oracle: BFS reaches {int(torch.isfinite(bfs).sum())} of {n}"
          f" vertices, depth {int(bfs[torch.isfinite(bfs)].max())} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    auto_res = None
    for name in ("sssp_auto", "sssp_sort", "sssp_nodelta"):
        (dist, res), wall, counts, peak = phases.run(
            name, *graph_phase(name, graph, snap, dev))
        exact = bool(torch.equal(dist[:n], bfs)) and bool(
            torch.isinf(dist[n:]).all())
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s "
              f"launches {counts} peak_mem {peak:.2f} GiB equal_to_bfs "
              f"{exact}", flush=True)
        check(exact, f"{name}: distances differ from the BFS oracle")
        if name == "sssp_auto":
            auto_res = res
            kept[name] = dist
        del dist, res
        torch.cuda.empty_cache()
    algo = sssp.make_algorithm(snap, cap["src_capacity"],
                               cap["edge_capacity"])
    rows += sssp_kernel_checks(graph, snap, ex, algo, auto_res.stats)
    sssp_obs_and_recovery(graph, snap, dev, phases, auto_res, indptr,
                          indices)
    launch_section(graph, snap, dev, phases, auto_res, indptr, indices)
    del auto_res

    # Connected components, exactly equal to a dense min-label iteration.
    t0 = time.perf_counter()
    labels = cc.reference_components(indptr, indices, n, device=dev)
    sync()
    print(f"cc oracle: {int(torch.unique(labels).numel())} distinct labels "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    for name in ("cc_auto", "cc_nodelta"):
        (lab, res), wall, counts, peak = phases.run(
            name, *graph_phase(name, graph, snap, dev))
        exact = bool(torch.equal(lab[:n], labels))
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s "
              f"launches {counts} peak_mem {peak:.2f} GiB "
              f"equal_to_oracle {exact}", flush=True)
        check(exact, f"{name}: labels differ from the oracle")
        if name == "cc_auto":
            kept[name] = lab
        del lab, res
        torch.cuda.empty_cache()
    rules_section(graph, snap, dev, phases, rows,
                  dict(pagerank=ref, bfs=bfs, labels=labels, **kept))
    dist_section(graph, snap, dev, phases, kept)
    del ref, bfs, labels, kept
    adsorption_section(graph, snap, dev, phases, rows, indptr, indices)
    del graph
    torch.cuda.empty_cache()
    graph_views_section(args, dev, phases, rows, indptr, indices)


def dist_phase(name, graph, snap, dev, ex):
    """A function that runs phase ``name`` of DIST_PHASES once, at its
    twin's settings, through the executor ``ex``."""
    import importlib
    twin = DIST_PHASES[name][0]
    kw = dict(device=dev, executor=ex, **capacities(snap))
    if twin in RULES_PHASES:
        prog, mode = RULES_PHASES[twin][:2]
        cp = compiled_programs()[prog]
        return lambda: cp.run(graph, snap, mode=mode,
                              max_iters=RULES_ITERS[prog], **kw)
    algo, mode = GRAPH_PHASES[twin][:2]
    mod = importlib.import_module(f"repro_torch.algorithms.{algo}")
    return lambda: mod.run(graph, snap, mode=mode, **RUN_SETTINGS[algo],
                           **kw)


def dist_section(graph, snap, dev, phases, answers, backend="nccl"):
    """The shard_map backend on a world of one rank over NCCL: each phase
    of DIST_PHASES against its simulated twin of this run (``answers``
    holds the twins' answers by phase, ``sssp_auto``'s standing for every
    SSSP twin; ``phases`` their walls and stats), then the resilient
    phases of DIST_RESILIENT against ``dist_sssp``'s and
    ``dist_pagerank``'s answers, which go into ``answers``."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.core.fixpoint import StratumStats
    from repro_torch.launch.mesh import (flat_mesh, init_shard_group,
                                         local_shards)

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    cap = capacities(snap)
    with tempfile.TemporaryDirectory(dir=build, prefix="dist_pg_") as td:
        init_shard_group(backend, f"file://{td}/store", world_size=1,
                         rank=0)
        try:
            mesh = flat_mesh(snap.num_shards, device=dev)
            nccl = (".".join(map(str, torch.cuda.nccl.version()))
                    if backend == "nccl" else "none")
            print(f"dist: world {mesh.world} rank {mesh.rank} device "
                  f"{mesh.device} backend {dist.get_backend()} nccl {nccl} "
                  f"shards {list(local_shards(mesh))}", flush=True)
            for name, (twin, group) in DIST_PHASES.items():
                route = ("sort" if twin == "sssp_sort" else "auto")
                ex = ShardedExecutor(
                    snapshot=snap, seg_capacity=cap["edge_capacity"],
                    edge_capacity=cap["edge_capacity"],
                    src_capacity=cap["src_capacity"], ladder_tiers=4,
                    route_strategy=route, backend="shard_map", mesh=mesh)
                (vals, res), wall, counts, peak = phases.run(
                    name, group, (), dist_phase(name, graph, snap, dev, ex))
                path = path_kernels(res.stats)
                for k in path:
                    check(counts[k] > 0, f"{name}: kernel {k} of its strata "
                                         "was never launched")
                want = answers["sssp_auto" if twin.startswith(("sssp",
                               "rules_sssp")) else twin]
                check(vals.shape == want.shape and bool(
                    torch.isfinite(vals[:snap.n_keys]).any()),
                    f"{name}: values of shape {tuple(vals.shape)}")
                if twin == "delta_auto":
                    diff = (vals - want).abs()
                    err = float((diff / want.abs().clamp(min=1)).max())
                    verdict = (f"vs {twin}: rel {err:.3e} (bound "
                               f"{PAGERANK_TWIN_BOUND}), "
                               f"{int((diff > 0).sum())} values differ")
                    check(err <= PAGERANK_TWIN_BOUND,
                          f"{name}: {err:.3e} off {twin}")
                else:
                    same = bool(torch.equal(vals, want))
                    twin_stats = phases.stats[twin]
                    stats_same = all(torch.equal(getattr(res.stats, f),
                                                 getattr(twin_stats, f))
                                     for f in StratumStats._fields)
                    verdict = (f"equal_to_{twin} {same} stats_equal "
                               f"{stats_same}")
                    check(same and stats_same,
                          f"{name}: differs from {twin}")
                hand = phases.walls[twin]
                print(f"phase {name}: {stats_line(res.stats)} wall "
                      f"{wall:.3f} s ({twin} {hand:.3f} s, "
                      f"{(wall - hand) / hand:+.1%}) launches {counts} "
                      f"peak_mem {peak:.2f} GiB world {mesh.world} "
                      f"{verdict}", flush=True)
                if name in ("dist_sssp", "dist_pagerank"):
                    answers[name] = vals
                del vals, res
                torch.cuda.empty_cache()
            dist_resilient_phases(graph, snap, dev, phases, answers, mesh,
                                  f"{td}/ckpt")
            if dev.type == "cuda":
                exchange_timing(mesh, snap.num_shards, cap["edge_capacity"])
        finally:
            dist.destroy_process_group()


def dist_resilient_phases(graph, snap, dev, phases, answers, mesh, ckpt):
    """``run_resilient`` on the shard_map backend (DIST_RESILIENT): shard
    DIST_FAILED_SHARD lost at half the failure-free strata, the replica
    chain under ``ckpt``/rank0.  SSSP must equal ``dist_sssp`` exactly,
    state and stats; PageRank lie within PAGERANK_TWIN_BOUND of
    ``dist_pagerank`` (float atomics)."""
    import shutil
    import torch
    from repro_torch.algorithms import pagerank, sssp
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.runtime import FaultPlan

    cap = capacities(snap)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto", backend="shard_map",
                         mesh=mesh)
    runs = {
        "dist_sssp_resilient": (
            sssp.make_algorithm(snap, cap["src_capacity"],
                                cap["edge_capacity"]),
            sssp.initial_state(snap, RUN_SETTINGS["sssp"]["source"], dev),
            1, RUN_SETTINGS["sssp"]["max_iters"],
            lambda st: st.dist.reshape(-1)),
        "dist_pagerank_resilient": (
            pagerank.make_algorithm(snap,
                                    RUN_SETTINGS["pagerank"]["threshold"],
                                    cap["src_capacity"],
                                    cap["edge_capacity"]),
            pagerank.initial_state(snap, dev), snap.padded_keys,
            RUN_SETTINGS["pagerank"]["max_iters"],
            lambda st: (pagerank.BASE + pagerank.DAMPING * st.acc)
            .reshape(-1)),
    }
    needs = ("scatter_route", "delta_scatter")
    for name, (run, twin, group) in DIST_RESILIENT.items():
        algo, state0, live0, max_iters, values = runs[name]
        plan = FaultPlan(fail_at=max(int(phases.stats[run].iterations) // 2,
                                     1), failed_shard=DIST_FAILED_SHARD)
        rr, wall, counts, peak = phases.run(
            name, group, needs, lambda: ex.run_resilient(
                algo, state0, live0, graph, max_iters,
                ckpt_root=f"{ckpt}/{name}", fault_plan=plan),
            warm_up=False)
        m = rr.metrics
        vals, want = values(rr.result.state), answers[run]
        check(m["recoveries"] == 1, f"{name}: {m['recoveries']} recoveries")
        if run == "dist_sssp":
            stats_same = all(torch.equal(getattr(rr.result.stats, f),
                                         getattr(phases.stats[run], f))
                             for f in rr.result.stats._fields)
            same = bool(torch.equal(vals, want))
            verdict = f"equal_to_{run} {same} stats_equal {stats_same}"
            check(same and stats_same, f"{name}: differs from {run}")
        else:
            diff = (vals - want).abs()
            err = float((diff / want.abs().clamp(min=1)).max())
            verdict = (f"vs {run}: rel {err:.3e} (bound "
                       f"{PAGERANK_TWIN_BOUND}), "
                       f"{int((diff > 0).sum())} values differ")
            check(err <= PAGERANK_TWIN_BOUND, f"{name}: {err:.3e} off {run}")
        print(f"phase {name}: {stats_line(rr.result.stats)} lost shard "
              f"{DIST_FAILED_SHARD} at stratum {plan.fail_at} recoveries "
              f"{m['recoveries']} recovery_wall {m['recovery_wall_s']:.3f} s "
              f"bytes_replicated {m['bytes_replicated']} wall {wall:.3f} s "
              f"({run} {phases.walls[run]:.3f} s, {twin} "
              f"{phases.walls[twin]:.3f} s) launches {counts} peak_mem "
              f"{peak:.2f} GiB world {mesh.world} {verdict}", flush=True)
        shutil.rmtree(f"{ckpt}/{name}", ignore_errors=True)
        del rr, vals
        torch.cuda.empty_cache()


def exchange_timing(mesh, S, cap) -> None:
    """One top-rung exchange of the sparse rehash (keys int32, payload
    float32, ann int8, each [world, L, L, cap]) as the engine makes it
    (``ShardMesh.all_to_all``: ``all_to_all_single`` into a fresh receive
    buffer) against a ``copy_`` of the same tensors, timed with CUDA
    events: the cost the shard_map strata add at world 1."""
    import torch
    L = mesh.shards_per_rank
    bufs = [torch.ones((mesh.world, L, L, cap), dtype=dt, device=mesh.device)
            for dt in (torch.int32, torch.float32, torch.int8)]
    outs = [torch.empty_like(b) for b in bufs]
    moved = nbytes(*bufs)

    def exchange():
        outs[:] = [mesh.all_to_all(b) for b in bufs]

    a2a = time_ms(exchange, reps=3)
    check(all(torch.equal(o, b) for o, b in zip(outs, bufs)),
          "all_to_all_single at world 1 did not return its input")
    cp = time_ms(lambda: [o.copy_(b) for o, b in zip(outs, bufs)], reps=3)
    print(f"dist exchange: {moved / 1e9:.2f} GB a top-rung stratum (S={S}, "
          f"cap={cap}): all_to_all_single {a2a:.3f} ms "
          f"({2 * moved / a2a / 1e6:.0f} GB/s read+write), copy_ "
          f"{cp:.3f} ms ({2 * moved / cp / 1e6:.0f} GB/s); read+write "
          f"bound {2 * moved / HBM_BYTES_PER_S * 1e3:.3f} ms", flush=True)
    del bufs, outs
    torch.cuda.empty_cache()


def compiled_programs() -> dict:
    """The four canned rule programs compiled at RUN_SETTINGS, keyed as
    RULES_PHASES names them (reachability from its rule text)."""
    from repro_torch import frontend
    return {
        "pagerank": frontend.compile_program(frontend.pagerank_program(
            RUN_SETTINGS["pagerank"]["threshold"])),
        "sssp": frontend.compile_program(frontend.sssp_program(
            RUN_SETTINGS["sssp"]["source"])),
        "cc": frontend.compile_program(frontend.cc_program()),
        "reachability": frontend.compile_program(
            frontend.parse_program(frontend.REACHABILITY_TEXT)),
    }


def rules_phase(name, compiled, graph, snap, dev):
    """A function that runs phase ``name`` of RULES_PHASES once."""
    prog, mode = RULES_PHASES[name][:2]
    cp = compiled[prog]
    return lambda: cp.run(graph, snap, mode=mode,
                          max_iters=RULES_ITERS[prog], route_strategy="auto",
                          device=dev, **capacities(snap))


def rules_kernel_checks(graph, snap, ex, cp, stats):
    """The max kernels at reachability's widest stratum (``rules_reach``'s
    busiest on its widest rung): scatter_route on the shard that emits
    most, delta_scatter into the shard that receives most, edge_propagate
    over shard 0's CSC at that stratum's values, held also at the initial
    ones (only the source is not -inf)."""
    import torch
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _stack, _take

    cap = capacities(snap)
    algo = cp.make_algorithm(snap, cap["src_capacity"], cap["edge_capacity"])
    state0 = cp.initial_state(snap, graph.device)
    state, parts, at, src = widest_stratum(ex, algo, graph, state0, stats,
                                           "reach max", busiest=True)
    tier = ex.capacity_tiers(algo)[int(stats.tiers[at])]
    rows = [scatter_route_row(parts[src], snap, tier.seg, "max")]
    incoming, _ = ex.rehash_sparse(_stack(parts), tier.seg, "max",
                                   "scatter")
    del parts
    dst = max(range(snap.num_shards),
              key=lambda s: int((incoming.keys[s] != PAD_KEY).sum()))
    store = state[0]
    rows.append(delta_scatter_row(store[dst][:, None].contiguous(),
                                  _take(incoming, dst), dst, "max"))
    del incoming
    csc = shard0_csc(graph, snap)
    edge_propagate_bins(csc, "edge_propagate/max")
    print(f"edge_propagate max: reached payloads "
          f"{int(torch.isfinite(state0[0][0]).sum())} at stratum 0, "
          f"{int(torch.isfinite(store[0]).sum())} at stratum {at} of "
          f"{store[0].numel()}", flush=True)
    rows.append(edge_propagate_row(store[0].contiguous(), csc, "max",
                                   also=(state0[0][0],)))
    del state, store, csc
    torch.cuda.empty_cache()
    return rows


def rules_section(graph, snap, dev, phases, rows, oracles):
    """The compiled rule programs of ``repro_torch.frontend`` on the
    DBPedia-shaped graph, each phase of RULES_PHASES at the handwritten
    phases' settings: PageRank within PHASE_BOUND of the float64 oracle
    and held to its handwritten twin (nodelta exactly, delta within
    PAGERANK_TWIN_BOUND), SSSP and CC exactly equal to ``sssp_auto``'s and
    ``cc_auto``'s answers and to their oracles, reachability (no
    handwritten counterpart) exactly the BFS oracle's reached set.
    ``oracles`` holds the float64 PageRank (``pagerank``), the BFS
    distances (``bfs``), the min-label oracle (``labels``) and the four
    handwritten answers, keyed by their phases.  Prints each phase's
    strata and wall beside its handwritten twin's; then the max rows."""
    import torch
    from repro_torch.core.engine import ShardedExecutor

    n = snap.n_keys
    reached = torch.isfinite(oracles["bfs"])
    compiled = compiled_programs()
    reach_stats = None
    for name, (prog, mode, group, twin, needs) in RULES_PHASES.items():
        (vals, res), wall, counts, peak = phases.run(
            name, group, needs,
            rules_phase(name, compiled, graph, snap, dev))
        check(vals.shape == (snap.padded_keys,),
              f"{name}: values shape {tuple(vals.shape)}")
        path = path_kernels(res.stats)
        check(set(needs) <= path, f"{name}: its strata ran {sorted(path)}, "
                                  f"not all of {list(needs)}")
        for k in path:
            check(counts[k] > 0, f"{name}: kernel {k} of its strata was "
                                 "never launched")
        if prog == "pagerank":
            ref, hand = oracles["pagerank"], oracles[twin]
            check(bool(torch.isfinite(vals).all()), f"{name}: non-finite")
            err = float(((vals[:n] - ref).abs() / ref.abs().clamp(min=1))
                        .max())
            diff = (vals - hand).abs()
            twin_err = float((diff / hand.abs().clamp(min=1)).max())
            verdict = (f"rel_err_vs_f64 {err:.3e}; vs {twin}: max abs "
                       f"{float(diff.max()):.3e}, rel {twin_err:.3e}, "
                       f"{int((diff > 0).sum())} values differ")
            check(err < PHASE_BOUND,
                  f"{name}: rel_err_vs_f64 {err:.3e} over {PHASE_BOUND}")
            if mode == "nodelta":
                check(bool(torch.equal(vals, hand)),
                      f"{name}: answer differs from {twin}")
            else:
                check(twin_err <= PAGERANK_TWIN_BOUND,
                      f"{name}: {twin_err:.3e} off {twin} (relative), "
                      f"over {PAGERANK_TWIN_BOUND}")
        elif prog == "reachability":
            exact = (bool(torch.equal(vals[:n] == 1.0, reached))
                     and bool(((vals == 1.0) | (vals == float("-inf")))
                              .all()))
            verdict = f"equal_to_bfs_reach {exact}"
            check(exact, f"{name}: reached set differs from the BFS oracle")
            if mode == "delta":
                reach_stats = res.stats
        else:
            oracle = oracles["bfs" if prog == "sssp" else "labels"]
            exact = (bool(torch.equal(vals, oracles[twin]))
                     and bool(torch.equal(vals[:n], oracle)))
            verdict = f"equal_to_{twin}_and_oracle {exact}"
            check(exact,
                  f"{name}: answer differs from {twin} or its oracle")
        beside = ""
        if twin is not None:
            hand = phases.walls[twin]
            beside = (f" ({twin} {hand:.3f} s, overhead "
                      f"{(wall - hand) / hand:+.1%}, budget "
                      f"{RULES_OVERHEAD_BUDGET:.0%})")
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s"
              f"{beside} launches {counts} peak_mem {peak:.2f} GiB "
              f"{verdict}", flush=True)
        del vals, res
        torch.cuda.empty_cache()
    cap = capacities(snap)
    ex = ShardedExecutor(snapshot=snap, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto")
    rows += rules_kernel_checks(graph, snap, ex, compiled["reachability"],
                                reach_stats)


def stratum_spans(name, tracer) -> None:
    """Prints a traced phase's per-stratum host wall against device time
    (ms, from CUDA events at each stratum's start and end) and writes its
    Chrome trace under build/."""
    from repro_torch.obs import to_chrome_trace, write_chrome_trace
    spans = [e for e in tracer.events if e["name"].startswith("stratum")]
    print(f"{name} strata (host ms / device ms, tier): " + ", ".join(
        f"{e['args']['stratum']}: {e['dur'] * 1e3:.1f}/"
        f"{e['args'].get('device_s', 0.0) * 1e3:.1f} t{e['args']['tier']}"
        for e in spans), flush=True)
    path = ROOT / "build" / f"{name}.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_chrome_trace(tracer, str(path))
    print(f"{name}: {len(spans)} stratum spans; Chrome trace "
          f"{path.relative_to(ROOT)} with "
          f"{to_chrome_trace(tracer)['otherData']['events']} events",
          flush=True)


def busy_share(name, window, wall, top=6) -> float:
    """One more run of ``window`` (a few strata of the phase) under
    torch.profiler: its kernels' summed device time over ``wall``, the
    same strata's host wall in the measured run, is the busy share
    (kernel times are the device's, so the profiler's host cost stays
    out); also the ``top`` operators by the device time of the kernels
    they launch, and the share of the port's kernels, which ctypes
    launches outside any operator.  Returns the busy share."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    # Kernels, memsets and copies, from the Chrome trace the profiler
    # writes in C++.
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    busy = sum(e.get("dur", 0.0) for e in events
               if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
               ) / 1e6
    averages = prof.key_averages()
    total = sum(e.self_device_time_total for e in averages
                if e.device_type.name == "CUDA"
                and e.key != "Command Buffer Full")
    ops = [e for e in averages if e.device_type.name == "CPU"
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    rest = total - sum(e.self_device_time_total for e in ops)
    print(f"{name}: a window's kernels {busy:.3f} s (trace; averages "
          f"{total / 1e6:.3f} s) in its {wall:.3f} s wall, busy share "
          f"{busy / wall:.3f}; its device time: the port's CUDA kernels "
          f"{rest / total:.1%}, "
          + "; ".join(f"{e.key} {e.self_device_time_total / total:.1%}"
                      for e in ops[:top])
          + f" (profiling took {time.perf_counter() - t0:.1f} s)",
          flush=True)
    return busy / wall


def traced_phase(name, combiner, needs, phases, run, window_iters):
    """Phase ``name`` with a fresh Tracer each call: ``run(tracer,
    max_iters)`` runs it (None: the phase's own cap), with no warm-up (its
    untraced twin just ran).  Returns (result, wall, counts, peak, tracer
    of the measured call); prints the busy share of its first
    ``window_iters`` strata (None: all of them)."""
    from repro_torch.obs import Tracer
    box = {}

    def fn(max_iters=None):
        box["tracer"] = Tracer(name)
        return run(box["tracer"], max_iters)

    out, wall, counts, peak = phases.run(name, combiner, needs, fn,
                                         warm_up=False)
    tracer = box["tracer"]
    spans = [e for e in tracer.events if e["name"].startswith("stratum")]
    busy_share(name, lambda: fn(window_iters),
               sum(e["dur"] for e in spans[:window_iters]))
    return out, wall, counts, peak, tracer


def pagerank_obs_phases(graph, snap, dev, phases, ref, values):
    """delta_auto_traced (a Tracer on delta_auto's executor) and
    delta_measured (route_strategy="measured" from a route table
    calibrated here), each held to PHASE_BOUND against the float64
    oracle ``ref``."""
    import dataclasses
    import torch
    from repro_torch.algorithms import pagerank
    from repro_torch.core.engine import ShardedExecutor
    from repro_torch.core.fixpoint import ROUTE_SCATTER, ROUTE_SORT
    from repro_torch.obs import calibrate_executor_table
    n = snap.n_keys
    cap = capacities(snap)
    # The algorithm's capacities must be the executor's.
    kw = dict(RUN_SETTINGS["pagerank"], device=dev,
              edge_capacity=cap["edge_capacity"],
              src_capacity=cap["src_capacity"])

    def executor(**extra):
        return ShardedExecutor(snapshot=snap,
                               seg_capacity=cap["edge_capacity"],
                               edge_capacity=cap["edge_capacity"],
                               src_capacity=cap["src_capacity"],
                               ladder_tiers=4, route_strategy="auto",
                               **extra)

    def rel_vs_ref(pr):
        return float(((pr[:n] - ref).abs() / ref.abs().clamp(min=1)).max())

    def traced(tracer, max_iters):
        return pagerank.run(graph, snap, executor=executor(tracer=tracer),
                            **dict(kw, max_iters=max_iters or
                                   kw["max_iters"]))

    # The window: the first 4 strata, at the top rung.
    (pr, res), wall, counts, peak, tr = traced_phase(
        "delta_auto_traced", "add", ("scatter_route", "delta_scatter"),
        phases, traced, 4)
    rel = rel_vs_ref(pr)
    vs = float((pr - values["delta_auto"]).abs().max())
    print(f"phase delta_auto_traced: {stats_line(res.stats)} wall "
          f"{wall:.3f} s launches {counts} peak_mem {peak:.2f} GiB "
          f"rel_err_vs_f64 {rel:.3e}; max|traced - delta_auto| {vs:.3e}",
          flush=True)
    check(rel < PHASE_BOUND, f"delta_auto_traced: rel_err_vs_f64 {rel:.3e}"
                             f" over {PHASE_BOUND}")
    stratum_spans("delta_auto_traced", tr)
    del pr, res, tr

    algo = pagerank.make_algorithm(snap, RUN_SETTINGS["pagerank"][
        "threshold"], cap["src_capacity"], cap["edge_capacity"])
    auto = executor()
    t0 = time.perf_counter()
    table = calibrate_executor_table(auto, algo, device=dev)
    print(f"route table ({table.backend}, {time.perf_counter() - t0:.1f} s"
          f" to calibrate): " + "; ".join(
              f"edge {c}: sort {so * 1e3:.3f} ms scatter {sc * 1e3:.3f} ms"
              f" -> {table.pick(c, device=dev)} (auto: "
              f"{auto.pick_route_strategy(c, 'add')})"
              for c, (so, sc) in sorted(table.entries.items())),
          flush=True)
    measured = dataclasses.replace(auto, route_strategy="measured",
                                   route_table=table)
    (pr, res), wall, counts, peak = phases.run(
        "delta_measured", "add", ("delta_scatter",),
        lambda: pagerank.run(graph, snap, executor=measured, **kw),
        warm_up=False)
    it = int(res.stats.iterations)
    routes = set(res.stats.routes[:it].tolist())
    for code, kernel in ((ROUTE_SORT, "delta_route"),
                         (ROUTE_SCATTER, "scatter_route")):
        check(code not in routes or counts[kernel] > 0,
              f"delta_measured: kernel {kernel} was never launched")
    rel = rel_vs_ref(pr)
    print(f"phase delta_measured: {stats_line(res.stats)} wall {wall:.3f} "
          f"s launches {counts} peak_mem {peak:.2f} GiB rel_err_vs_f64 "
          f"{rel:.3e}", flush=True)
    check(rel < PHASE_BOUND, f"delta_measured: rel_err_vs_f64 {rel:.3e} "
                             f"over {PHASE_BOUND}")
    del pr, res
    torch.cuda.empty_cache()


def sssp_setup(sn, **extra):
    """SSSP's executor (route ``auto``, ``extra`` added) and algorithm at
    the phases' capacities for the snapshot ``sn``."""
    from repro_torch.algorithms import sssp
    from repro_torch.core.engine import ShardedExecutor
    cap = capacities(sn)
    ex = ShardedExecutor(snapshot=sn, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto", **extra)
    return ex, sssp.make_algorithm(sn, cap["src_capacity"],
                                   cap["edge_capacity"])


def sssp_remaker(indptr, indices, dev):
    """The ``remake`` of a resilient SSSP run: a new snapshot's executor,
    algorithm and re-sharded graph."""
    from repro_torch.data.graphs import shard_csr

    def remake(new_snap):
        return (*sssp_setup(new_snap), shard_csr(
            indptr, indices, new_snap.num_shards, device=dev))
    return remake


def sssp_chaos_schedule(num_shards):
    """``sssp_chaos``'s schedule: the acceptance schedule (a failure, a
    correlated replica loss, a failure during that recovery), then an
    elastic rescale to 4 shards."""
    from repro_torch.runtime import FaultEvent, FaultSchedule
    from repro_torch.runtime.chaos import acceptance_schedule
    return FaultSchedule(events=acceptance_schedule(num_shards).events
                         + (FaultEvent(kind="rescale", at=3,
                                       new_num_shards=4),))


def sssp_obs_and_recovery(graph, snap, dev, phases, auto_res, indptr,
                          indices):
    """sssp_auto_traced, bit-identical to sssp_auto (``auto_res``); then
    Fig 12's recovery phases through ``run_resilient``, each final state
    exactly equal to the failure-free run."""
    import shutil
    import tempfile
    import torch
    from repro_torch.algorithms import sssp
    from repro_torch.core.partition import unshard_dense_state
    from repro_torch.runtime import FaultPlan

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    needs = ("scatter_route", "delta_scatter")
    def traced(tracer, max_iters):
        return sssp.run(graph, snap,
                        executor=sssp_setup(snap, tracer=tracer)[0],
                        source=RUN_SETTINGS["sssp"]["source"],
                        max_iters=max_iters or RUN_SETTINGS["sssp"][
                            "max_iters"], device=dev,
                        edge_capacity=capacities(snap)["edge_capacity"],
                        src_capacity=capacities(snap)["src_capacity"])

    # The window: the whole run (10 strata).
    (dist, res), wall, counts, peak, tr = traced_phase(
        "sssp_auto_traced", "min", needs, phases, traced, None)
    exact = same(res.state, auto_res.state) and all(
        torch.equal(getattr(res.stats, f), getattr(auto_res.stats, f))
        for f in res.stats._fields)
    print(f"phase sssp_auto_traced: {stats_line(res.stats)} wall "
          f"{wall:.3f} s launches {counts} peak_mem {peak:.2f} GiB "
          f"equal_to_sssp_auto {exact}", flush=True)
    check(exact, "sssp_auto_traced: state or stats differ from sssp_auto")
    stratum_spans("sssp_auto_traced", tr)
    del dist, res, tr

    ex, algo = sssp_setup(snap)
    state0 = sssp.initial_state(snap, 0, dev)
    iters = int(auto_res.stats.iterations)
    at = {f: max(int(iters * f), 1) for f in RECOVER_AT}

    remake = sssp_remaker(indptr, indices, dev)
    chaos = sssp_chaos_schedule(snap.num_shards)
    cases = {"sssp_resilient": None}
    for f in RECOVER_AT:
        cases[f"sssp_recover_{int(f * 100)}"] = FaultPlan(
            fail_at=at[f], failed_shard=FAILED_SHARD)
    for f in (0.5, 0.75):
        cases[f"sssp_restart_{int(f * 100)}"] = FaultPlan(
            fail_at=at[f], failed_shard=FAILED_SHARD, strategy="restart")
    cases["sssp_chaos"] = chaos
    ref_flat = unshard_dense_state(snap, torch.stack(auto_res.state, -1))
    work = {}
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    try:
        for name, plan in cases.items():
            rr, wall, counts, peak = phases.run(
                name, "min", needs, lambda: ex.run_resilient(
                    algo, state0, 1, graph, RUN_SETTINGS["sssp"][
                        "max_iters"], ckpt_root=f"{tmp}/{name}",
                    fault_plan=plan, remake=remake), warm_up=False)
            m = rr.metrics
            shards = m["final_num_shards"]
            got = unshard_dense_state(snap.resnapshot(shards),
                                      torch.stack(rr.result.state, -1))
            exact = m["converged"] and torch.equal(got, ref_flat)
            if plan is None:
                exact = exact and all(
                    torch.equal(getattr(rr.result.stats, f),
                                getattr(auto_res.stats, f))
                    for f in auto_res.stats._fields)
            work[name] = m["total_work_units"]
            print(f"phase {name}: strata {m['strata_executed']} work_units "
                  f"{m['total_work_units']} bytes_replicated "
                  f"{m['bytes_replicated']} recoveries {m['recoveries']} "
                  f"restarts {m['restarts']} recovery_wall "
                  f"{m['recovery_wall_s']:.3f} s shards {shards} wall "
                  f"{wall:.3f} s launches {counts} peak_mem {peak:.2f} GiB "
                  f"equal_to_failure_free {exact}", flush=True)
            check(exact, f"{name}: final state differs from the "
                         f"failure-free run")
            shutil.rmtree(f"{tmp}/{name}", ignore_errors=True)
            del rr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"work units: incremental at 75 % {work['sssp_recover_75']}, "
          f"restart at 75 % {work['sssp_restart_75']}, at 50 % "
          f"{work['sssp_restart_50']}, failure-free "
          f"{work['sssp_resilient']}", flush=True)
    check(work["sssp_recover_75"] < work["sssp_restart_75"],
          "incremental recovery at 75 % did not do less work than restart")
    torch.cuda.empty_cache()


def launch_section(graph, snap, dev, phases, auto_res, indptr, indices):
    """The multi-process launch on the card: ``launch_selftest`` (a world
    of one NCCL rank on cuda:0, spawned as a worker process), then
    ``sssp_real_kill`` and ``sssp_chaos_real`` through
    ``DistributedResilientDriver``, each final state exactly the
    failure-free one (``auto_res``).  Worker channels and replica chains
    live under ``build/launch_*``, removed after; every cluster is shut
    down in a ``finally``."""
    import shutil
    import tempfile
    import torch
    from repro_torch.algorithms import sssp
    from repro_torch.core.partition import unshard_dense_state
    from repro_torch.launch.distributed import (Cluster,
                                                DistributedResilientDriver,
                                                selftest)
    from repro_torch.runtime.chaos import RealChaosInjector
    from repro_torch.runtime.health import HealthConfig

    S = snap.num_shards
    t0 = time.perf_counter()
    rep = selftest(1, S, backend="nccl")
    wall = time.perf_counter() - t0
    check(rep["backend"] == "nccl" and rep["devices"] == {"0": "cuda:0"}
          and rep["ownership"] == {"0": list(range(S))}
          and rep["collective_ok"],
          f"launch_selftest: {rep}")
    print(f"phase launch_selftest: world 1 backend {rep['backend']} device "
          f"{rep['devices']['0']} shards {rep['ownership']['0']} "
          f"all_gather ok wall {wall:.3f} s (spawn, torch import, CUDA and "
          f"NCCL init, one all_gather)", flush=True)

    needs = ("scatter_route", "delta_scatter")
    remake = sssp_remaker(indptr, indices, dev)
    state0 = sssp.initial_state(snap, 0, dev)
    max_iters = RUN_SETTINGS["sssp"]["max_iters"]
    ref_flat = unshard_dense_state(snap, torch.stack(auto_res.state, -1))
    cfg = HealthConfig(**LAUNCH_HEALTH)
    root = tempfile.mkdtemp(prefix="launch_", dir=ROOT / "build")
    clusters = []

    def start(name, workers, torch_mode):
        cluster = Cluster(f"{root}/{name}/cluster", workers, num_shards=S,
                          config=cfg, torch_mode=torch_mode, detect="lease")
        clusters.append(cluster)
        t = time.perf_counter()
        cluster.start()
        return cluster, time.perf_counter() - t

    def line(m):
        dets = ", ".join(f"worker {d['worker']} at stratum {d['stratum']} "
                         f"after {d['detection_s']:.3f} s"
                         for d in m["worker_detections"])
        respawn = [round(e["respawn_s"], 3) for e in m["events"]
                   if e["event"] == "worker_replaced"]
        return (f"strata {m['strata_executed']} detections [{dets}] "
                f"recoveries {m['recoveries']} restarts {m['restarts']} "
                f"respawn_s {respawn} acks {m['acks_collected']} "
                f"ack_timeouts {m['ack_timeouts']} recovery_wall "
                f"{m['recovery_wall_s']:.3f} s shards "
                f"{m['final_num_shards']}")

    try:
        cluster, up = start("kill", LAUNCH_WORKERS, "local")
        killed = []

        def hook(drv):
            if not killed and drv.stratum >= KILL_AT:
                killed.append(drv.stratum)
                cluster.kill(KILLED_WORKER)

        rr, wall, counts, peak = phases.run(
            "sssp_real_kill", "min", needs,
            lambda: DistributedResilientDriver(
                *sssp_setup(snap), state0, 1, graph, max_iters,
                ckpt_root=f"{root}/kill/chain", cluster=cluster,
                remake=remake, chaos_hook=hook).run(), warm_up=False)
        cluster.shutdown()
        m = rr.metrics
        exact = (m["converged"] and all(
            torch.equal(a, b) for a, b in zip(rr.result.state,
                                              auto_res.state))
            and all(torch.equal(getattr(rr.result.stats, f),
                                getattr(auto_res.stats, f))
                    for f in auto_res.stats._fields))
        names = {e["event"] for e in m["events"]}
        twin = phases.walls["sssp_recover_25"]
        print(f"phase sssp_real_kill: workers {LAUNCH_WORKERS} (local, acks "
              f"on cuda; started in {up:.3f} s) killed worker "
              f"{KILLED_WORKER} at stratum {killed} {line(m)} wall "
              f"{wall:.3f} s (sssp_recover_25 {twin:.3f} s) launches "
              f"{counts} peak_mem {peak:.2f} GiB equal_to_sssp_auto "
              f"{exact}", flush=True)
        dets = m["worker_detections"]
        check(killed == [KILL_AT], f"sssp_real_kill: killed at {killed}")
        check([d["worker"] for d in dets] == [KILLED_WORKER]
              and dets[0]["detection_s"] > 0,
              f"sssp_real_kill: detections {dets}")
        check({"worker_dead", "failure", "worker_replaced",
               "recovery"} <= names and m["recoveries"] >= 1,
              f"sssp_real_kill: events {sorted(names)}")
        check(m["acks_collected"] > 0, "sssp_real_kill: no acks")
        check(exact, "sssp_real_kill: state or stats differ from sssp_auto")
        del rr

        schedule = sssp_chaos_schedule(S)
        cluster, up = start("chaos", S, "off")
        injector = RealChaosInjector(schedule, cluster)
        rr, wall, counts, peak = phases.run(
            "sssp_chaos_real", "min", needs,
            lambda: DistributedResilientDriver(
                *sssp_setup(snap), state0, 1, graph, max_iters,
                ckpt_root=f"{root}/chaos/chain", cluster=cluster,
                strategy=schedule.strategy, remake=remake,
                chaos_hook=injector).run(), warm_up=False)
        cluster.shutdown()
        m = rr.metrics
        got = unshard_dense_state(snap.resnapshot(m["final_num_shards"]),
                                  torch.stack(rr.result.state, -1))
        exact = m["converged"] and torch.equal(got, ref_flat)
        fired = [(f["kind"], f["at"], f.get("workers"))
                 for f in injector.fired]
        twin = phases.walls["sssp_chaos"]
        print(f"phase sssp_chaos_real: workers {S} (protocol only; started "
              f"in {up:.3f} s) signals {fired} skipped "
              f"{len(injector.skipped)} {line(m)} wall {wall:.3f} s "
              f"(sssp_chaos {twin:.3f} s) launches {counts} peak_mem "
              f"{peak:.2f} GiB equal_to_failure_free {exact}", flush=True)
        check(bool(injector.fired), "sssp_chaos_real: no signal fired")
        check(exact, "sssp_chaos_real: final state differs from the "
                     "failure-free run")
        del rr, got
    finally:
        for cluster in clusters:
            cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def make_seeds(snap, dev):
    """Adsorption's injections: one-hot f32[padded_keys, ADS_LABELS] on
    every ADS_SEED_EVERY-th vertex v, label (v / ADS_SEED_EVERY) mod
    ADS_LABELS."""
    import torch
    seeds = torch.zeros((snap.padded_keys, ADS_LABELS), device=dev)
    v = torch.arange(0, snap.n_keys, ADS_SEED_EVERY, device=dev)
    seeds[v, (v // ADS_SEED_EVERY) % ADS_LABELS] = 1.0
    return seeds


def adsorption_f64(indptr, indices, seeds, dev, tol=1e-12, max_iters=400):
    """Float64 dense iteration of adsorption's equation, vec = 0.25 seed +
    0.75 A vec, from vec = 0.25 seed, and of beta = 0.75 A (1 + beta)
    (see ADS_F32), each until no entry moves by ``tol``: (f64[n, L],
    f64[n, 1], rounds of the first)."""
    import numpy as np
    import torch
    from repro_torch.algorithms.adsorption import INJECTION
    n = len(indptr) - 1
    counts = torch.from_numpy(np.diff(indptr)).to(dev)
    src = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    dst = torch.from_numpy(indices[:src.numel()]).to(dev).long()
    w = (1.0 / counts.clamp(min=1).double())[src][:, None]

    def fixpoint(base, step):
        x = base
        for rounds in range(1, max_iters + 1):
            new = base + (1.0 - INJECTION) * torch.zeros_like(x).index_add_(
                0, dst, step(x)[src] * w)
            moved = float((new - x).abs().max())
            x = new
            if moved < tol:
                break
        return x, rounds

    vec, rounds = fixpoint(INJECTION * seeds[:n].double(), lambda x: x)
    zero = torch.zeros((n, 1), dtype=torch.float64, device=dev)
    beta, _ = fixpoint(zero, lambda b: 1.0 + b)
    return vec, beta, rounds


def adsorption_kernel_checks(graph, snap, ex, algo, seeds, stats):
    """scatter_route and delta_scatter (add, W = ADS_LABELS) at
    adsorption_auto's first stratum on its widest rung (the top one when
    it reached it), delta_route at adsorption_sort's; ``stats`` maps each
    phase to its run's stats."""
    import dataclasses
    import torch
    from repro_torch.algorithms import adsorption
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _stack, _take

    S, B = snap.num_shards, snap.block_size
    state0 = adsorption.initial_state(snap, seeds, graph.device)
    state, parts, at, src = widest_stratum(
        ex, algo, graph, state0, stats["adsorption_auto"],
        f"adsorption_auto W={ADS_LABELS}")
    tier = ex.capacity_tiers(algo)[int(stats["adsorption_auto"].tiers[at])]
    rows = [scatter_route_row(parts[src], snap, tier.seg, "add", ADS_GROUP,
                              f"scatter_route/add_w{ADS_LABELS}")]
    incoming, _ = ex.rehash_sparse(_stack(parts), tier.seg, "add",
                                   "scatter")
    del parts, state
    dst = max(range(S), key=lambda s: int((incoming.keys[s] != PAD_KEY)
                                          .sum()))
    in_s = _take(incoming, dst)
    del incoming
    rows.append(delta_scatter_row(
        torch.zeros((B, ADS_LABELS), device=graph.device), in_s, dst, "add",
        ADS_GROUP, f"delta_scatter/add_w{ADS_LABELS}"))
    del in_s

    # delta_route on adsorption_sort's own run.
    sort = dataclasses.replace(ex, route_strategy="sort")
    _, parts, at, src = widest_stratum(
        sort, algo, graph, state0, stats["adsorption_sort"],
        f"adsorption_sort W={ADS_LABELS}")
    tier = ex.capacity_tiers(algo)[int(stats["adsorption_sort"].tiers[at])]
    rows.append(delta_route_row(parts[src], snap, tier.seg, ADS_GROUP,
                                f"delta_route/add_w{ADS_LABELS}"))
    torch.cuda.empty_cache()
    return rows


def adsorption_section(graph, snap, dev, phases, rows, indptr, indices):
    """Adsorption (L = ADS_LABELS) on the graph: three phases, each against
    a float64 dense iteration, delta against nodelta, and the W = 4 rows
    of scatter_route, delta_scatter and delta_route."""
    import torch
    from repro_torch.algorithms import adsorption
    from repro_torch.core.engine import ShardedExecutor

    n, S = snap.n_keys, snap.num_shards
    cap = capacities(snap)
    L = ADS_LABELS
    seeds = make_seeds(snap, dev)
    # The top rung's routed buffer: S*S*seg slots of a key, an ann and L
    # payload floats.
    top = S * S * cap["edge_capacity"] * (5 + 4 * L) / 2 ** 30
    t0 = time.perf_counter()
    ref, beta, rounds = adsorption_f64(indptr, indices, seeds, dev)
    tol = RUN_SETTINGS["adsorption"]["threshold"] * beta + ADS_F32 * ref.abs()
    sync()
    print(f"adsorption: L={L}, {int((seeds.sum(1) > 0).sum())} seeds, top "
          f"rung's routed buffer {top:.2f} GiB; oracle: float64 dense "
          f"iteration, {rounds} rounds ({time.perf_counter() - t0:.1f} s); "
          f"bound t*beta + {ADS_F32}|x| from {float(tol.min()):.3e} to "
          f"{float(tol.max()):.3e}", flush=True)
    vecs, stats = {}, {}
    for name, (mode, route, needs) in ADSORPTION_PHASES.items():
        (vec, res), wall, counts, peak = phases.run(
            name, ADS_GROUP, needs, lambda: adsorption.run(
                graph, snap, seeds, mode=mode, route_strategy=route,
                device=dev, **RUN_SETTINGS["adsorption"], **cap))
        check(vec.shape == (snap.padded_keys, L) and
              bool(torch.isfinite(vec).all()),
              f"{name}: vectors {tuple(vec.shape)} not finite")
        it = int(res.stats.iterations)
        check(it < RUN_SETTINGS["adsorption"]["max_iters"],
              f"{name}: not converged in {it} strata")
        err = (vec[:n].double() - ref).abs()
        worst = float(torch.where(err == 0, 0.0, err / tol).max())
        print(f"phase {name}: {stats_line(res.stats)} wall {wall:.3f} s "
              f"launches {counts} peak_mem {peak:.2f} GiB max|vec - x| "
              f"{float(err.max()):.3e} (at |x| "
              f"{float(ref.abs().flatten()[err.argmax()]):.3e}), at "
              f"{worst:.3f} of its bound", flush=True)
        check(worst <= 1.0, f"{name}: off the float64 fixpoint by "
                            f"{worst:.3f} of its bound")
        vecs[name] = vec
        stats[name] = res.stats
        del res
        torch.cuda.empty_cache()
    for name in ("adsorption_auto", "adsorption_sort"):
        d = float((vecs[name] - vecs["adsorption_nodelta"]).abs().max())
        print(f"max|{name} - adsorption_nodelta| {d:.3e} (bound "
              f"{ADS_DELTA_BOUND})", flush=True)
        check(d < ADS_DELTA_BOUND, f"{name} and adsorption_nodelta "
                                   f"disagree")
    del vecs, ref, beta, tol
    torch.cuda.empty_cache()
    ex = ShardedExecutor(snapshot=snap, seg_capacity=cap["edge_capacity"],
                         edge_capacity=cap["edge_capacity"],
                         src_capacity=cap["src_capacity"], ladder_tiers=4,
                         route_strategy="auto")
    algo = adsorption.make_algorithm(snap, L, RUN_SETTINGS["adsorption"][
        "threshold"], cap["src_capacity"], cap["edge_capacity"])
    rows += adsorption_kernel_checks(graph, snap, ex, algo, seeds, stats)


def mutation_stream(store, rng, frac):
    """One batch: frac·|E| mixed inserts (uniform) and deletes (existing
    edges), ``bench_incremental.py``'s stream."""
    from repro_torch.incremental import EdgeDelete, EdgeInsert
    half = max(int(store.n_edges * frac / 2), 1)
    muts = [EdgeInsert(int(rng.integers(store.n)), int(rng.integers(store.n)))
            for _ in range(half)]
    src, dst = store.edges()
    for i in rng.choice(len(src), half, replace=False):
        muts.append(EdgeDelete(int(src[i]), int(dst[i])))
    return muts


def path_kernels(stats) -> set:
    """The kernels a run's strata launch by its stats: the route kernel of
    each sparse stratum's route, delta_scatter for a sparse stratum,
    edge_propagate for a dense one."""
    from repro_torch.core.fixpoint import ROUTE_SCATTER, ROUTE_SORT
    it = int(stats.iterations)
    dense = stats.used_dense[:it].tolist()
    routes = set(stats.routes[:it].tolist())
    return ({k for code, k in ((ROUTE_SCATTER, "scatter_route"),
                               (ROUTE_SORT, "delta_route")) if code in routes}
            | ({"delta_scatter"} if not all(dense) else set())
            | ({"edge_propagate"} if any(dense) else set()))


def refresh_line(view) -> str:
    """A refresh's report and the host seconds of its parts."""
    r = view.history[-1]
    st = view.last_result.stats
    it = int(st.iterations)
    split = " ".join(f"{k} {v:.3f}" for k, v in view.last_split.items())
    return (f"mode {r.mode} mutations {r.mutations} touched {r.touched_keys} "
            f"strata {r.strata} rehash_bytes {r.rehash_bytes:.6g} "
            f"dense_strata {int(st.used_dense[:it].sum())} wall "
            f"{r.wall_s:.3f} s (host s: {split})")


def view_kernel_checks(view, group, combiner):
    """Each graph kernel of the view's last repair against its plain
    version at that repair's own inputs (the resume executor's
    capacities, the repaired graph), as rows of launch group ``group``:
    each route kernel at the busiest stratum on the widest rung that took
    its route, delta_scatter at the busiest shard's incoming buffer of
    scatter_route's stratum, edge_propagate over shard 0's CSC at the
    first dense stratum's payload."""
    import torch
    from repro_torch.algorithms import pagerank
    from repro_torch.core.delta import PAD_KEY
    from repro_torch.core.engine import _stack, _take
    from repro_torch.core.fixpoint import ROUTE_SCATTER, ROUTE_SORT
    from repro_torch.kernels import edge_propagate as ep
    ex, algo = view.rule.resume_executor, view.rule.resume_algo
    graph, snap, start = view.immutable, ex.snapshot, view.last_plan.state
    stats = view.last_result.stats
    it = int(stats.iterations)
    tiers = ex.capacity_tiers(algo)
    routes = set(stats.routes[:it].tolist())
    field = {"pagerank": None, "sssp": "dist",
             "connected_components": "label"}[view.algorithm]
    rows = []
    for code in (ROUTE_SCATTER, ROUTE_SORT):
        if code not in routes:
            continue
        kernel = "scatter_route" if code == ROUTE_SCATTER else "delta_route"
        state, parts, at, src = widest_stratum(
            ex, algo, graph, start, stats, f"{group} {kernel}",
            busiest=True, route=code)
        seg = tiers[int(stats.tiers[at])].seg
        if code == ROUTE_SORT:
            rows.append(delta_route_row(parts[src], snap, seg, group,
                                        f"delta_route/{group}", combiner))
            continue
        rows.append(scatter_route_row(parts[src], snap, seg, combiner, group,
                                      f"scatter_route/{group}"))
        incoming, _ = ex.rehash_sparse(_stack(parts), seg,
                                       combiner, "scatter")
        del parts
        dst = max(range(snap.num_shards),
                  key=lambda s: int((incoming.keys[s] != PAD_KEY).sum()))
        into = (torch.zeros((snap.block_size, 1), device=graph.device)
                if field is None else
                getattr(state, field)[dst][:, None].contiguous())
        rows.append(delta_scatter_row(into, _take(incoming, dst), dst,
                                      combiner, group,
                                      f"delta_scatter/{group}"))
        del incoming, state
    dense = stats.used_dense[:it].tolist()
    if any(dense):
        at = dense.index(True)
        step = ex.make_stratum_fn(algo, graph)
        state = start
        for i in range(at):
            state, _ = step(state, i)
        st, g0 = _take(state, 0), _take(graph, 0)
        if field is None:
            payload = pagerank.current_pr(st) / torch.clamp(
                g0.out_degree, min=1).to(torch.float32)
        elif field == "dist":
            payload = torch.where(st.dist < float("inf"), st.dist + 1.0,
                                  float("inf"))
        else:
            payload = st.label
        print(f"{group} edge_propagate at stratum {at} (dense), shard 0",
              flush=True)
        csc = ep.build_csc(g0, snap.padded_keys)
        edge_propagate_bins(csc, f"edge_propagate/{group}")
        rows.append(edge_propagate_row(payload, csc, combiner, group=group,
                                       label=f"edge_propagate/{group}"))
        del state, csc
    torch.cuda.empty_cache()
    return rows


class GraphViewOracles:
    """What every graph view's measured batch is held to, made once a
    batch: the views' stores start equal and take the same stream, so
    they stay equal."""

    def __init__(self, n, dev):
        self.n, self.dev = n, dev
        self.csr, self.made = {}, {}

    def graph(self, j, store):
        from repro_torch.data.graphs import edges_to_csr
        if j not in self.csr:
            self.csr[j] = edges_to_csr(*store.edges(), self.n)
        return self.csr[j]

    def of(self, kind, j, store, **kw):
        import torch
        from repro_torch.algorithms import connected_components as cc
        from repro_torch.algorithms import pagerank, sssp
        if (kind, j) not in self.made:
            ip, ix = self.graph(j, store)
            t0 = time.perf_counter()
            if kind == "pagerank":
                out = pagerank.reference_pagerank(ip, ix, self.n, iters=300,
                                                  device=self.dev)
            elif kind == "sssp":
                out = sssp.reference_sssp(ip, ix, self.n, kw["source"],
                                          device=self.dev)
            else:
                out = cc.reference_components(ip, ix, self.n,
                                              device=self.dev)
            sync()
            print(f"view oracle {kind} batch {j}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            self.made[(kind, j)] = out
        return self.made[(kind, j)]


def graph_view_phase(name, base, snap, dev, phases, rows, batches, rng,
                     oracles, answers):
    """One graph view (VIEW_PHASES[name]) over a copy of ``base``: the
    warm-up batch, then each measured batch's repair through
    ``Phases.run``, held to a cold recompute on the same store and to the
    oracle of the mutated graph.  ``batches`` (the stream, made on first
    use) and ``answers`` (view_sssp's answers) are shared by the
    phases."""
    import copy
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.incremental import ViewManager
    from repro_torch.runtime import FaultPlan
    algo, params, group, needs = VIEW_PHASES[name]
    cap = capacities(snap)
    params = dict(params, **cap, route_strategy="auto")
    tmp = []
    if name == "view_sssp_resilient":
        tmp.append(tempfile.mkdtemp(prefix="view_chain_", dir=ROOT / "build"))
        params["resilient_root"] = tmp[-1]
    journal = None
    if name == "view_journal":
        journal = tempfile.mkdtemp(prefix="view_journal_", dir=ROOT / "build")
        tmp.append(journal)
    try:
        mgr = ViewManager(journal_root=journal,
                          fallback_threshold=VIEW_FALLBACK)
        t0 = time.perf_counter()
        view = mgr.create_view("v", algo, copy.deepcopy(base), device=dev,
                               **params)
        sync()
        print(f"phase {name} cold start: {refresh_line(view)}; view made "
              f"in {time.perf_counter() - t0:.3f} s", flush=True)
        for j in range(1 + VIEW_BATCHES):
            if j == len(batches):
                t0 = time.perf_counter()
                batches.append(mutation_stream(view.store, rng, VIEW_FRAC))
                print(f"view batch {j}: {len(batches[j])} mutations made in "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
            mgr.mutate("v", *batches[j])
            if j == 0:                       # the warm-up batch
                mgr.refresh("v")
                sync()
                print(f"phase {name} warm-up: {refresh_line(view)}",
                      flush=True)
                continue
            if name == "view_sssp_resilient" and j == 1:
                view.fault_plan = FaultPlan(fail_at=1, failed_shard=1)
            _, wall, counts, peak = phases.run(
                name, group, needs, lambda: mgr.refresh("v"),
                warm_up=False)
            report = view.history[-1]
            check(report.mode == "repair" and view.degraded is None,
                  f"{name} batch {j}: {report.mode}, not a repair")
            st = view.last_result.stats
            dense = bool(st.used_dense[:int(st.iterations)].any())
            for kernel in path_kernels(st):
                check(counts[kernel] > 0, f"{name} batch {j}: its strata "
                                          f"ran {kernel} no time")
            warm = view.query()
            t0 = time.perf_counter()
            state, res = view.rule.cold(view)
            sync()
            cold_wall = time.perf_counter() - t0
            cold = view.rule.extract(view, state)
            cold_it = int(res.stats.iterations)
            cold_bytes = float(res.stats.rehash_bytes[:cold_it].sum())
            del state, res
            check(warm.shape == (snap.n_keys,) and cold.shape == warm.shape,
                  f"{name}: answer shape {warm.shape}")
            what = ""
            if algo == "pagerank":
                ref = oracles.of("pagerank", j, view.store).cpu().numpy()
                scale = np.maximum(np.abs(ref), 1.0)
                rel_w = float((np.abs(warm - ref) / scale).max())
                rel_c = float((np.abs(cold - ref) / scale).max())
                what = (f"rel_err_vs_f64 warm {rel_w:.3e} cold {rel_c:.3e} "
                        f"(bound {PHASE_BOUND})")
                check(bool(np.isfinite(warm).all()) and max(rel_w, rel_c)
                      < PHASE_BOUND, f"{name} batch {j}: {what}")
            else:
                kind = "sssp" if algo == "sssp" else "cc"
                ref = oracles.of(kind, j, view.store,
                                 source=params.get("source", 0)).cpu().numpy()
                exact = np.array_equal(warm, cold) and np.array_equal(warm,
                                                                      ref)
                what = f"warm == cold == oracle {exact}"
                check(exact, f"{name} batch {j}: {what}")
                if name == "view_sssp":
                    answers[j] = warm
                elif algo == "sssp":
                    same = np.array_equal(warm, answers[j])
                    what += f"; equal to view_sssp {same}"
                    check(same, f"{name} batch {j}: differs from view_sssp")
            if name == "view_sssp_resilient" and j == 1:
                events = [e["event"] for e in
                          (view.last_recovery or {}).get("events", [])]
                what += f"; recovery events {events}"
                check("failure" in events, f"{name}: no failure recorded")
            print(f"phase {name} batch {j}: {refresh_line(view)} launches "
                  f"{counts} dense_body {dense} peak_mem {peak:.2f} GiB; "
                  f"cold {cold_wall:.3f} s {cold_it} strata rehash_bytes "
                  f"{cold_bytes:.6g}; {what}", flush=True)
        if name in VIEW_ROWS:
            rows += view_kernel_checks(view, group, VIEW_ROWS[name])
        if journal is not None:
            t0 = time.perf_counter()
            restored = ViewManager.restore(journal, device=dev)
            sync()
            same = np.array_equal(restored.query("v"), view.query())
            print(f"phase {name} restore: version "
                  f"{restored['v'].version} of {view.version}, "
                  f"{time.perf_counter() - t0:.3f} s, query equal to the "
                  f"live view {same}", flush=True)
            check(same and restored["v"].version == view.version,
                  f"{name}: the restored view differs from the live one")
            del restored
        del view, mgr
    finally:
        for d in tmp:
            shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()


def graph_views_section(args, dev, phases, rows, indptr, indices):
    """The incremental graph views of VIEW_PHASES on the DBPedia-shaped
    graph, each view over its own copy of one store."""
    import numpy as np
    from repro_torch.core.partition import PartitionSnapshot
    from repro_torch.incremental import GraphStore
    n, S = args.n, args.shards
    t0 = time.perf_counter()
    base = GraphStore(indptr, indices, n, S)
    snap = PartitionSnapshot(n_keys=n, num_shards=S)
    print(f"views: store of {base.n_edges} edges, nnz capacity "
          f"{base.nnz_capacity} a shard ({time.perf_counter() - t0:.1f} s); "
          f"batches of {VIEW_FRAC:.0%} of |E|, one warm-up and "
          f"{VIEW_BATCHES} measured, fallback_threshold {VIEW_FALLBACK}",
          flush=True)
    batches, answers = [], {}
    oracles = GraphViewOracles(n, dev)
    rng = np.random.default_rng(args.seed)
    for name in VIEW_PHASES:
        graph_view_phase(name, base, snap, dev, phases, rows, batches, rng,
                         oracles, answers)


def kmeans_view_section(args, dev, phases, rows):
    """The k-means view on --points / KMEANS_VIEW_CUT geo points: the
    warm-up batch, then each measured batch's repair, held to a float64
    Lloyd run from the repaired state on the mutated store, with (sums,
    counts) against the store's valid points; then the kmeans_assign row
    at the last repair's points and centroids."""
    import numpy as np
    import torch
    from repro_torch.algorithms import kmeans
    from repro_torch.data.points import make_geo_points
    from repro_torch.incremental import PointInsert, PointRemove, ViewManager
    S, k, n = args.shards, KMEANS_K, args.points // KMEANS_VIEW_CUT
    t0 = time.perf_counter()
    pts = make_geo_points(n, KMEANS_K, seed=args.seed, device="cpu").numpy()
    mgr = ViewManager(fallback_threshold=VIEW_FALLBACK)
    view = mgr.create_kmeans_view("km", pts, k=k, num_shards=S, device=dev,
                                  max_iters=KMEANS_STRATA, seed=args.seed)
    sync()
    print(f"phase view_kmeans cold start: n={n} capacity "
          f"{view.store.capacity} k={k}: {refresh_line(view)}; view made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del pts
    rng = np.random.default_rng(args.seed)
    for j in range(1 + VIEW_BATCHES):
        valid = np.flatnonzero(view.store.to_arrays()["valid"])
        near = view.store.to_arrays()["points"][
            rng.choice(valid, KMEANS_VIEW_BATCH)]
        new = near + rng.normal(0.0, KMEANS_JITTER, near.shape)
        mgr.mutate("km", *[PointInsert(float(x), float(y)) for x, y in new],
                   *[PointRemove(int(s)) for s in rng.choice(
                       valid, KMEANS_VIEW_BATCH, replace=False)])
        if j == 0:
            mgr.refresh("km")
            sync()
            print(f"phase view_kmeans warm-up: {refresh_line(view)}",
                  flush=True)
            continue
        _, wall, counts, peak = phases.run(
            "view_kmeans", "view_kmeans", ("kmeans_assign",),
            lambda: mgr.refresh("km"), warm_up=False)
        check(view.history[-1].mode == "repair" and view.degraded is None,
              f"view_kmeans batch {j}: not a repair")
        got = torch.from_numpy(view.query()).to(dev).double()
        check(bool(torch.isfinite(got).all()) and got.shape == (k, 2),
              f"view_kmeans: centroids {tuple(got.shape)} not finite")
        arrays = view.store.to_arrays()
        keep = torch.from_numpy(arrays["valid"]).to(dev)
        points = torch.from_numpy(arrays["points"]).to(dev)[keep]
        assign = view.state.assign.reshape(-1)[keep].long()
        # A resume starts from the repaired assignment, so its first
        # stratum is the assignment lloyd_f64 makes from its init: one
        # round fewer lands on the same step of the same trajectory.
        t0 = time.perf_counter()
        ref, rounds = lloyd_f64(points, kmeans.centroids_of(
            view.last_plan.state), KMEANS_STRATA - 1)
        lloyd_s = time.perf_counter() - t0
        err = float((got - ref).abs().max())
        counts_ref = torch.bincount(assign, minlength=k).double()
        sums_ref = torch.stack([torch.bincount(
            assign, weights=points[:, d].double(), minlength=k)
            for d in range(2)], 1)
        mass = torch.stack([torch.bincount(
            assign, weights=points[:, d].double().abs(), minlength=k)
            for d in range(2)], 1)
        sums_err = float(((view.state.sums.double() - sums_ref).abs()
                          / mass.clamp(min=1.0)).max())
        counts_ok = torch.equal(view.state.counts.double(), counts_ref)
        t0 = time.perf_counter()
        _, cold = view.rule.cold(view)
        sync()
        cold_wall = time.perf_counter() - t0
        print(f"phase view_kmeans batch {j}: {refresh_line(view)} launches "
              f"{counts} peak_mem {peak:.2f} GiB; cold {cold_wall:.3f} s "
              f"{int(cold.stats.iterations)} strata; max|c - c_f64| "
              f"{err:.3e} (bound {KMEANS_BOUND}; Lloyd from the repaired "
              f"state, {rounds} rounds, {lloyd_s:.1f} s); sums off by "
              f"{sums_err:.3e} of their |x| mass (bound {KMEANS_SUM_RTOL}), "
              f"counts equal {counts_ok}", flush=True)
        del cold, points, assign, keep
        check(err < KMEANS_BOUND, f"view_kmeans batch {j}: centroids off "
                                  f"the float64 Lloyd by {err:.3e}")
        check(counts_ok and sums_err < KMEANS_SUM_RTOL,
              f"view_kmeans batch {j}: sums or counts off the store")
    # The path assigns every slot of the store, valid or not.
    rows.append(kmeans_kernel_check(
        view.immutable[0].reshape(-1, 2), kmeans.centroids_of(view.state),
        "view_kmeans", "kmeans_assign/view"))
    del view, mgr
    torch.cuda.empty_cache()


def make_points(n, dev):
    """``n`` geo points in KMEANS_K clouds and KMEANS_K initial centroids
    (``bench_kmeans.py``'s data): (points, init)."""
    from repro_torch.data.points import (make_geo_points,
                                         sample_initial_centroids)
    points = make_geo_points(n, n_true_clusters=KMEANS_K, seed=0,
                             device=dev)
    return points, sample_initial_centroids(points, KMEANS_K, seed=1)


def kmeans_phase(mode, sharded, init, dev):
    """A function that runs k-means in ``mode`` for up to KMEANS_STRATA
    strata."""
    from repro_torch.algorithms import kmeans
    return lambda: kmeans.run(sharded, init, mode=mode,
                              max_iters=KMEANS_STRATA, device=dev)


def kmeans_section(args, dev, phases, rows):
    """k-means at the paper's largest point set."""
    import torch
    from repro_torch.algorithms import kmeans
    from repro_torch.kernels import kmeans_assign as ka

    S, k, n = args.shards, KMEANS_K, args.points
    check(n % S == 0, f"--points {n} is not a multiple of {S} shards")
    t0 = time.perf_counter()
    points, init = make_points(n, dev)
    sync()
    print(f"points: n={n} ({n // S} a shard, {S} shards) k={k} "
          f"({time.perf_counter() - t0:.1f} s to make on the host and move)"
          f"; kmeans_assign runs its "
          f"{'constant-table' if ka.uses_table(k, 2) else 'shared-memory'}"
          f" kernel", flush=True)
    sharded = points.view(S, n // S, 2)
    # Warm-up at a small size (cuBLAS, allocator, kernel load).
    kmeans.run(sharded[:, :1 << 20].contiguous(), init, max_iters=3,
               device=dev)
    sync()
    rows.append(kmeans_kernel_check(points, init))

    t0 = time.perf_counter()
    ref, rounds = lloyd_f64(points, init, KMEANS_STRATA)
    sync()
    print(f"kmeans oracle: float64 Lloyd, {rounds} rounds "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cents = {}
    for name, mode in [("kmeans_delta", "delta"),
                       ("kmeans_nodelta", "nodelta")]:
        (c, res), wall, counts, peak = phases.run(
            name, "kmeans", ("kmeans_assign",),
            kmeans_phase(mode, sharded, init, dev), warm_up=False)
        it = int(res.stats.iterations)
        check(c.shape == (k, 2) and bool(torch.isfinite(c).all()),
              f"{name}: centroids {tuple(c.shape)} not finite")
        check(counts["kmeans_assign"] == it + 1,
              f"{name}: {counts['kmeans_assign']} kmeans_assign launches "
              f"for {it} strata")
        err = float((c.double() - ref).abs().max())
        sw = res.stats.delta_counts[:it].tolist()
        print(f"phase {name}: iterations {it} switched first {sw[:3]} last "
              f"{sw[-3:]} wall {wall:.3f} s launches {counts} peak_mem "
              f"{peak:.2f} GiB max|c - c_f64| {err:.3e} (bound "
              f"{KMEANS_BOUND})", flush=True)
        check(err < KMEANS_BOUND, f"{name}: centroids off the float64 "
                                  f"oracle by {err:.3e}")
        cents[name] = c
        del res
        torch.cuda.empty_cache()
    agree = float((cents["kmeans_delta"] - cents["kmeans_nodelta"])
                  .abs().max())
    print(f"max|kmeans_delta - kmeans_nodelta| {agree:.3e} (bound "
          f"{KMEANS_BOUND})", flush=True)
    check(agree < KMEANS_BOUND, "kmeans delta and nodelta disagree")


def sdpa_call(q, k, v, causal):
    """The one torch call that computes the same attention, for the
    library column: ``scaled_dot_product_attention`` with ``enable_gqa``
    where H != H_kv, PyTorch choosing the backend."""
    import torch
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])


def sdpa_backends(q, k, v, causal) -> str:
    """:func:`sdpa_call` timed under each fused backend alone (cuDNN,
    flash), to name the one PyTorch chose; "refused" where a backend does
    not take the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    call = sdpa_call(q, k, v, causal)

    def under(backend):
        def fn():
            with sdpa_kernel([backend]):
                return call()
        return fn

    out = []
    for name, backend in (("cuDNN", SDPBackend.CUDNN_ATTENTION),
                          ("flash", SDPBackend.FLASH_ATTENTION)):
        try:
            out.append(f"{name} {time_ms(under(backend)):.3f} ms")
        except RuntimeError:
            out.append(f"{name} refused")
    return ", ".join(out)


def flash_row(label, phase, q, k, v, causal):
    """The flash_attention kernel of q's dtype at q [B, H, T, D], k/v
    [B, H_kv, S, D] against its plain version (for bf16 the float32 plain
    version on the same values, rounded to bf16), timed beside it and
    beside :func:`sdpa_call`.  The row reports the launches of the LM
    phase ``phase`` runs at this shape (OFF_PATH: a check at a shape the
    path does not run, 0 launches)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_bf16" if bf16 else "flash_attention"
    got = fa.attention(q, k, v, causal=causal)
    if bf16:
        ref = fa.attention_ref(q.float(), k.float(), v.float(),
                               causal=causal)
        tol = FLASH_BF16_TOL * (float(v.float().abs().max()) + ref.abs())
        what = "2^-8 max|v| + 2^-8 |ref|"
        plain = lambda: fa.attention_ref(q.float(), k.float(), v.float(),
                                         causal=causal).to(torch.bfloat16)
    else:
        ref = fa.attention_ref(q, k, v, causal=causal)
        tol = FLASH_TOL + FLASH_TOL * ref.abs()
        what = f"{FLASH_TOL} abs + rel"
        plain = lambda: fa.attention_ref(q, k, v, causal=causal)
    diff = (got.float() - ref).abs()
    err = float(diff.max())
    worst = float((diff / tol).max()) if diff.numel() else 0.0
    check(bool((diff <= tol).all()) and bool(torch.isfinite(got).all()),
          f"{name}/{label}: off its plain version by up to {err:.3e} "
          f"(tolerance {what})")
    del got, ref, diff, tol
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    # Score pairs the function needs: s <= t when causal (T == S).
    pairs = t * (t + 1) // 2 if causal else t * s
    bnd = bound(2 * nbytes(q) + nbytes(k, v), 4 * d * b * h * pairs,
                BF16_TC_OPS_PER_S if bf16 else FP32_OPS_PER_S)
    lib = f"{'bf16' if bf16 else 'float32'} SDPA"
    if bf16 and phase != OFF_PATH:
        lib += f" ({sdpa_backends(q, k, v, causal)})"
    return row(name, phase, err,
               time_ms(lambda: fa.attention(q, k, v, causal=causal)),
               time_ms(plain, reps=2), bnd, time_ms(sdpa_call(q, k, v,
                                                              causal)),
               f"B={b} H={h} H_kv={h_kv} T={t} S={s} D={d} {q.dtype} "
               f"{'causal' if causal else 'non-causal'}"
               f"{' (off the path)' if phase == OFF_PATH else ''}; error "
               f"at {worst:.3f} of its tolerance; library: {lib}",
               label=f"{name}/{label}")


def random_qkv(shape, generator, dtype="float32"):
    """Standard normal q [B, H, T, D], k and v [B, H_kv, S, D] in
    ``dtype`` on ``generator``'s device."""
    import torch
    b, h, h_kv, t, s, d = shape
    dev = generator.device
    return tuple(torch.randn(*sh, generator=generator, device=dev).to(
        getattr(torch, dtype)) for sh in ((b, h, t, d), (b, h_kv, s, d),
                                          (b, h_kv, s, d)))


def layer0_qkv(cfg, params, tokens, embeds=None, positions=None):
    """Layer 0's attention inputs on ``tokens`` (or ``embeds``) at
    ``positions`` (default 0..T-1), as the forward gives them to the
    kernel: in the model's dtype, contiguous, q and k rotated (or, for
    sinusoid positions, the sinusoid added to the input)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.models.layers import apply_norm
    layer = params.layers[0]
    x = params.embed[tokens.long()] if embeds is None else embeds
    b, t = x.shape[:2]
    pos = (torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
           if positions is None else positions)
    x = apply_norm(cfg.norm_kind, layer.ln1,
                   transformer._add_positions(cfg, x, pos))
    return [a.contiguous() for a in attn.gqa_qkv(cfg, layer.attn, x, pos)]


def encoder0_qkv(cfg, params, frames):
    """The encoder's layer 0 attention inputs on ``frames`` [B, S, D], as
    ``transformer.encode`` gives them to the kernel."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.models.layers import apply_norm
    layer = params.encoder[0]
    b, s = frames.shape[:2]
    pos = torch.arange(s, dtype=torch.int32,
                       device=frames.device).expand(b, s)
    x = frames + transformer._sinusoid(pos, frames.shape[-1]).to(
        frames.dtype)
    x = apply_norm(cfg.norm_kind, layer.ln1, x)
    return [a.contiguous() for a in attn.gqa_qkv(cfg, layer.attn, x, pos)]


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|: the error against the logits'
    scale."""
    return float((got - ref).abs().max() / ref.abs().max())


def teacher_forced(cfg, params, tokens, start, steps, enc_out=None):
    """Prefill ``tokens[:, :start]`` into a cache of ``start + steps``
    slots (an encoder-decoder's with ``enc_out``), then decode ``tokens[:,
    start + i]`` at position ``start + i``; returns the decode logits
    f32[B, steps, V]."""
    from repro_torch.models import transformer
    _, cache = transformer.prefill_forward(cfg, params,
                                           tokens[:, :start].contiguous(),
                                           start + steps, enc_out=enc_out)
    return decode_steps(cfg, params, cache, tokens, start, steps)


def decode_steps(cfg, params, cache, tokens, start, steps, flash=False):
    """Decode ``tokens[:, start + i]`` at position ``start + i`` for i <
    ``steps`` from ``cache`` (changed in place; ``flash``: flash decoding,
    under an ambient mesh); the logits f32[B, steps, V]."""
    import torch
    from repro_torch.models import transformer
    out = []
    for i in range(steps):
        logits, cache = transformer.decode_step(
            cfg, params, tokens[:, start + i:start + i + 1], cache,
            torch.tensor(start + i, dtype=torch.int32, device=tokens.device),
            flash_decode=flash)
        out.append(logits)
    return torch.cat(out, dim=1)


def shard_decode_phase(cfg, params, ext, start, steps, dev, phases):
    """shard_decode: teacher-forced flash decoding on a (1, 1) ambient mesh
    (``attention.gqa_decode(flash=True)``: the rank's partial (m, l, acc)
    over its block of the slots, combined over the model axis) against
    the plain decode from the same prefill, within LM_DECODE_BOUND."""
    import torch
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.launch.sharding import shard_cache
    from repro_torch.models import transformer
    _, cache = transformer.prefill_forward(cfg, params,
                                           ext[:, :start].contiguous(),
                                           start + steps)
    with one_rank_mesh(dev) as mesh:
        flash_cache = shard_cache(cache, mesh, cfg)
        sync()
        t0 = time.perf_counter()
        plain = decode_steps(cfg, params, cache, ext, start, steps)
        sync()
        plain_wall = time.perf_counter() - t0

        def flash():
            with set_mesh(mesh):
                return decode_steps(cfg, params, flash_cache, ext, start,
                                    steps, flash=True)
        out, wall, counts, peak = phases.run(
            "shard_decode", "shard_decode", (), flash, warm_up=False)
    err = rel_err(out, plain)
    check(bool(torch.isfinite(out).all()) and out.shape == plain.shape,
          f"shard_decode: logits {tuple(out.shape)} not finite")
    print(f"phase shard_decode: {cfg.name} [{ext.shape[0]} x {start} + "
          f"{steps}] flash decoding on a (1, 1) mesh, {steps} teacher-forced "
          f"steps: wall {wall:.3f} s (plain decode {plain_wall:.3f} s), "
          f"max|flash - plain| / max|logit| {err:.3e} (bound "
          f"{LM_DECODE_BOUND}) launches {counts} peak_mem {peak:.2f} GiB; "
          f"card {card_line()}", flush=True)
    check(err <= LM_DECODE_BOUND, "shard_decode: flash decoding off the "
                                  "plain decode")
    del cache, flash_cache, out, plain
    torch.cuda.empty_cache()


def shard_a2a_phase(cfg, params, prompt, dev, phases):
    """shard_decode_a2a: MoE's a2a dispatch on a (1, 1) ambient mesh
    against the sort dispatch on layer 0's MoE input over ``prompt``,
    both at a capacity factor of E / k (neither drops a copy), on the same
    routes.  With float32 payloads the two compute the same products:
    within MOE_DISPATCH_BOUND of max |y|.  With the model's bf16 payloads
    (the path as it runs) the a2a rounds each copy's expert output and the
    data row's sum to bf16, each by at most u = 2^-8 of itself (bf16's
    unit roundoff): every element within 2^-8 (sum_k p_k |out_k| + |y|)
    of sort's, the worst case of the two roundings, plus
    MOE_DISPATCH_BOUND of max |y|."""
    import dataclasses
    import torch
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_norm
    full = dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)
    layer = params.layers[0]
    B, T = prompt.shape
    with torch.no_grad():
        x = params.embed[prompt.long()]
        pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        x = x + attn.gqa_train(cfg, layer.attn,
                               apply_norm(cfg.norm_kind, layer.ln1, x), pos)
        xf = apply_norm(cfg.norm_kind, layer.ln2, x).reshape(B * T, -1)
        del x
        top_e, top_p, _ = moe._route(full, layer.ffn, xf)
        cap = moe._capacity(full, B * T)
        sync()
        t0 = time.perf_counter()
        want = moe._dispatch_sort(full, layer.ffn, xf, top_e, top_p, cap)
        sync()
        sort_wall = time.perf_counter() - t0
        # sum_k p_k |out_k|, each element's scale before the sum.
        flat_e, flat_p = top_e.reshape(-1).long(), top_p.reshape(-1)
        token_of = torch.arange(B * T, device=dev).repeat_interleave(
            full.top_k)
        kept, rows = moe._sorted_kept(flat_e, flat_p, full.n_experts, cap)
        scale = torch.zeros_like(want).index_add(
            0, token_of[kept], moe._expert_ffn(
                layer.ffn, xf[token_of[kept]].float(), rows).abs()
            * flat_p[kept][:, None])
        with one_rank_mesh(dev) as mesh:
            def a2a(payload):
                with set_mesh(mesh):
                    return moe._dispatch_a2a(full, layer.ffn, payload,
                                             top_e, top_p)
            got32 = a2a(xf.float())
            got, wall, counts, peak = phases.run(
                "shard_decode_a2a", "shard_decode_a2a", (), lambda: a2a(xf))
    ymax = float(want.abs().max())
    err32 = float((got32 - want).abs().max()) / ymax
    room = 2 ** -8 * (scale + want.abs()) + MOE_DISPATCH_BOUND * ymax
    over = float(((got - want).abs() - room).max())
    err = float((got - want).abs().max()) / ymax
    print(f"phase shard_decode_a2a: {cfg.name} layer 0's MoE input over "
          f"{B} x {T} tokens, capacity factor E / k = "
          f"{full.capacity_factor:g} ({cap} copies an expert, none "
          f"dropped): a2a on a (1, 1) mesh {wall:.3f} s, sort "
          f"{sort_wall:.3f} s; float32 payloads: max|a2a - sort| / max|y| "
          f"{err32:.3e} (bound {MOE_DISPATCH_BOUND}); {xf.dtype} payloads: "
          f"{err:.3e} of max |y|, every element within its rounding bound: "
          f"{over <= 0} (largest excess {over:.3e}) peak_mem {peak:.2f} "
          f"GiB; card {card_line()}", flush=True)
    check(bool(torch.isfinite(got).all()), "shard_decode_a2a: not finite")
    check(err32 <= MOE_DISPATCH_BOUND and over <= 0,
          "shard_decode_a2a: a2a off the sort dispatch")
    del got, got32, want, xf, scale, room
    torch.cuda.empty_cache()


def lm_section(args, dev, phases, rows, cfg=None, shapes=LM_SHAPES):
    """The dense LM serving path at Llama-3-8B's full width and depth
    (``cfg`` and ``shapes`` shrink it for a rehearsal on the CPU)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or get_arch(LM_ARCH)

    def no_training_work(name, counts, stats_before):
        # Serving needs no gradient: no backward launch, no statistic.
        check(counts["flash_attention_bwd"] == 0 and
              fa_ops.lse_written == stats_before,
              f"{name}: {counts['flash_attention_bwd']} backward launches, "
              f"{fa_ops.lse_written - stats_before} forward launches that "
              f"wrote the log-sum-exp")

    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    sync()
    print(f"lm: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype}: "
          f"{transformer.param_count(params)} parameters "
          f"({time.perf_counter() - t0:.1f} s to init on the card)",
          flush=True)

    # lm_forward: the full-sequence forward through the kernel.
    B, T = sh["fwd_batch"], sh["fwd_seq"]
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed,
                           device=dev).batch_at(0)["tokens"]
    stats_before = fa_ops.lse_written
    (logits, _), wall, counts, peak = phases.run(
        "lm_forward", "lm_forward", ("flash_attention_bf16",),
        lambda: transformer.forward(cfg, params, tokens))
    no_training_work("lm_forward", counts, stats_before)
    check(counts["flash_attention_bf16"] == cfg.n_layers and
          counts["flash_attention"] == 0,
          f"lm_forward: {counts['flash_attention_bf16']} bf16 and "
          f"{counts['flash_attention']} float32 flash_attention launches "
          f"for {cfg.n_layers} layers")
    check(logits.shape == (B, T, cfg.vocab) and logits.dtype ==
          torch.float32 and bool(torch.isfinite(logits).all()),
          f"lm_forward: logits {logits.dtype}{tuple(logits.shape)} not "
          f"finite")
    plain, _ = transformer.forward(cfg, params, tokens, use_kernel=False)
    err = rel_err(logits, plain)
    same = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    del plain, logits
    print(f"phase lm_forward: [{B}x{T}] wall {wall:.3f} s "
          f"{B * T / wall:.0f} tok/s launches {counts} peak_mem "
          f"{peak:.2f} GiB max|kernel - plain| / max|logit| {err:.3e} "
          f"(bound {LM_BF16_BOUND}), argmax agreement {same:.5f}",
          flush=True)
    check(err <= LM_BF16_BOUND, f"lm_forward: kernel path off the plain "
                                f"path by {err:.3e} of the logits' scale")
    qkv = layer0_qkv(cfg, params, tokens)
    rows.append(flash_row("forward", "lm_forward", *qkv, True))
    # The float32 kernel at the same shape; no LM phase runs it.
    rows.append(flash_row("forward", OFF_PATH, *(a.float() for a in qkv),
                          True))
    del qkv
    torch.cuda.empty_cache()

    # Full width, 4 layers, float32: the kernel path against the plain
    # path, and teacher-forced decode against that forward.
    cfg32 = dataclasses.replace(cfg, n_layers=sh["tight_layers"],
                                dtype="float32")
    p32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(args.seed + 1), dev)
    before = phases.counts()
    f32, _ = transformer.forward(cfg32, p32, tokens)
    after = phases.counts()
    check(after["flash_attention"] - before["flash_attention"] ==
          cfg32.n_layers and after["flash_attention_bf16"] ==
          before["flash_attention_bf16"],
          "lm float32: the forward did not go through the float32 kernel "
          "alone")
    plain32, _ = transformer.forward(cfg32, p32, tokens, use_kernel=False)
    err32 = rel_err(f32, plain32)
    del plain32
    n = sh["decode_steps"]
    dec32 = teacher_forced(cfg32, p32, tokens, T - n, n)
    err_dec32 = rel_err(dec32, f32[:, T - n:])
    del p32, f32, dec32
    print(f"lm float32 at {cfg32.n_layers} layers, full width: "
          f"max|kernel - plain| / max|logit| {err32:.3e}, teacher-forced "
          f"decode ({n} steps) vs forward {err_dec32:.3e} (bound "
          f"{LM_TIGHT_BOUND})", flush=True)
    check(err32 <= LM_TIGHT_BOUND, "lm float32: kernel path off the plain "
                                   "path")
    check(err_dec32 <= LM_TIGHT_BOUND, "lm float32: decode off the forward")
    del tokens
    torch.cuda.empty_cache()

    # lm_serve: launch/serve.py's prefill + greedy decode.
    B, P, new = sh["serve_batch"], sh["prompt"], sh["new"]
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 1,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    stats_before = fa_ops.lse_written
    res, wall, counts, peak = phases.run(
        "lm_serve", "lm_serve", ("flash_attention_bf16",),
        lambda: serve(cfg, params, prompt, new))
    no_training_work("lm_serve", counts, stats_before)
    check(counts["flash_attention_bf16"] == cfg.n_layers and
          counts["flash_attention"] == 0,
          f"lm_serve: {counts['flash_attention_bf16']} bf16 and "
          f"{counts['flash_attention']} float32 flash_attention launches "
          f"for a prefill of {cfg.n_layers} layers")
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"lm_serve: tokens {toks.dtype}{tuple(toks.shape)} out of range")
    full, _ = transformer.forward(cfg, params, prompt)
    last = full[:, -1:].clone()
    del full
    err_prefill = rel_err(res.prefill_logits, last)
    plain, _ = transformer.prefill_forward(cfg, params, prompt, P + new,
                                           use_kernel=False)
    err_prefill_plain = rel_err(res.prefill_logits, plain)
    del plain
    full, _ = transformer.forward(cfg, params, ext)
    tail = full[:, P:].clone()
    del full
    err_dec = rel_err(teacher_forced(cfg, params, ext, P, n), tail)
    del tail, last
    print(f"phase lm_serve: [{B}x{P} + {new}] wall {wall:.3f} s prefill "
          f"{res.prefill_s:.3f} s ({B * P / res.prefill_s:.0f} tok/s) "
          f"decode {res.decode_steps} steps {res.decode_s:.3f} s "
          f"({B * res.decode_steps / res.decode_s:.1f} tok/s) launches "
          f"{counts} peak_mem {peak:.2f} GiB; prefill last logits vs "
          f"forward {err_prefill:.3e} (bound {LM_PREFILL_BOUND:.3e}), vs "
          f"the plain prefill {err_prefill_plain:.3e} (bound "
          f"{LM_BF16_BOUND}), "
          f"teacher-forced decode ({n} steps) vs forward {err_dec:.3e} "
          f"(bound {LM_DECODE_BOUND}); sample {toks[0, :8].tolist()}",
          flush=True)
    check(err_prefill <= LM_PREFILL_BOUND, "lm_serve: prefill logits off "
                                           "the forward")
    check(err_prefill_plain <= LM_BF16_BOUND, "lm_serve: prefill off the "
                                              "plain prefill")
    check(err_dec <= LM_DECODE_BOUND, "lm_serve: decode off the forward")
    torch.cuda.empty_cache()
    shard_decode_phase(cfg, params, ext, P, n, dev, phases)
    rows.append(flash_row("prefill", "lm_serve",
                          *layer0_qkv(cfg, params, prompt), True))
    del params, res, ext, prompt
    torch.cuda.empty_cache()

    # Each kernel at a ragged causal shape and a non-causal one.
    g = torch.Generator(device=dev).manual_seed(args.seed)
    for label, (shape, causal, dtype) in FLASH_OFF_PATH.items():
        rows.append(flash_row(label, OFF_PATH, *random_qkv(shape, g, dtype),
                              causal))
    torch.cuda.empty_cache()


def tp_section(args, dev, phases, rows, cfg=None, shapes=TP_SHAPES,
               sizes=TP_SIZES):
    """tp_layer: Llama-3-8B's layer 0 at full width split over a model axis
    of each of ``sizes`` in one process (module docstring); ``cfg``,
    ``shapes`` and ``sizes`` shrink it for a rehearsal on the CPU."""
    import dataclasses
    from types import SimpleNamespace
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.sharding import tp_plan
    from repro_torch.models import attention as attn
    from repro_torch.models import tp as tpm
    from repro_torch.models import transformer
    from repro_torch.models.layers import apply_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cfg or get_arch(LM_ARCH), n_layers=1)
    B, T = shapes["batch"], shapes["seq"]
    g = torch.Generator(device=dev).manual_seed(args.seed)
    params = transformer.init_params(cfg, g, dev)
    block = params.layers[0]
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed,
                           device=dev).batch_at(0)["tokens"]
    x = params.embed[tokens.long()].detach()
    del params, tokens
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    w = torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
    print(f"tp_layer: {cfg.name} layer 0, d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"{cfg.dtype}, {B}x{T} tokens, model axes {list(sizes)}",
          flush=True)

    def layer(p, xx, tp=None):
        return transformer.apply_block("dense", cfg, p, xx, pos, tp=tp)[0]

    def grads(y, inputs):
        return torch.autograd.grad(torch.sum(y.float() * w.float()), inputs)

    def whole_grads(dtype):
        ps = {n: t.detach().to(dtype).requires_grad_()
              for n, t in block.named_parameters()}
        xw = x.to(dtype).requires_grad_()
        y = tpm.call_with(block, ps, layer, xw)
        return ps, y.detach(), dict(zip(["x"] + list(ps), grads(
            y, [xw] + list(ps.values()))))

    _, _, g32 = whole_grads(torch.float32)
    whole, y_whole, g_whole = whole_grads(x.dtype)

    def dist32(g, name):
        """max |g - g32| over max |g32| of ``name``'s gradient."""
        return float((g.float() - g32[name]).abs().max()
                     / g32[name].abs().max())

    def whole_step():
        xw = x.clone().requires_grad_()
        return grads(tpm.call_with(block, whole, layer, xw),
                     [xw] + list(whole.values()))
    with torch.no_grad():
        whole_ms = time_ms(lambda: tpm.call_with(block, whole, layer, x))
    whole_step_ms = time_ms(whole_step)

    plans = {m: tp_plan(cfg, m) for m in sizes}
    out = {}

    def run(m):
        ranks = [tpm.rank_params("dense", block, plans[m], r, leaves=True)
                 for r in range(m)]
        record = []
        with torch.no_grad():
            y = tpm.split_layer("dense", cfg, block, x, pos, plans[m], ranks,
                                record=record)
        xs = x.clone().requires_grad_()
        split = [(r, n, t) for r in range(m) for n, t in ranks[r].items()
                 if tpm.param_block("dense", n, plans[m], r) is not None]
        got = grads(tpm.split_layer("dense", cfg, block, xs, pos, plans[m],
                                    ranks),
                    [xs] + [t for *_, t in split])
        out[m] = (y, record, ranks, split, got)

    needs = ("flash_attention_bf16", "flash_attention_bwd")
    _, wall, counts, peak = phases.run(
        "tp_layer", "tp_layer", needs, lambda: [run(m) for m in sizes],
        warm_up=False)
    fwd = sum(2 * m for m in sizes)
    check(counts["flash_attention_bf16"] == fwd and
          counts["flash_attention_bwd"] == BWD_LAUNCHES * sum(sizes) and
          counts["flash_attention"] == 0,
          f"tp_layer: launches {counts} (want {fwd} bf16 forward and "
          f"{BWD_LAUNCHES * sum(sizes)} backward: each rank's local heads "
          f"once without grad, once with, and its backward)")
    print(f"phase tp_layer: {len(sizes)} splits, forward and one backward "
          f"each, wall {wall:.3f} s launches {counts} peak_mem {peak:.2f} "
          f"GiB; the whole layer: forward {whole_ms:.3f} ms, forward + "
          f"backward {whole_step_ms:.3f} ms; card {card_line()}", flush=True)
    for m in sizes:
        y, record, ranks, split, got = out.pop(m)
        plan = plans[m]
        tol = TP_FWD_BOUND * (float(sum(record)) + float(
            y_whole.float().abs().max()))
        err = float((y.float() - y_whole.float()).abs().max())
        check(err <= tol and bool(torch.isfinite(y).all()),
              f"tp_layer M={m}: the split layer off the whole one by "
              f"{err:.3e} (bound {tol:.3e})")
        # The ranks' gradients of their blocks put in place (KV heads that
        # several ranks compute: summed), each weight's and the input's
        # against the float32 evaluation beside the whole bf16 layer's.
        summed = {}
        for (r, n, _), gr in zip(split, got[1:]):
            summed.setdefault(n, torch.zeros_like(
                g32[n], dtype=torch.float32)).narrow(
                *tpm.param_block("dense", n, plan, r)).add_(gr.float())
        names = ["x"] + list(summed)
        pairs = [(dist32(got[0], "x"), dist32(g_whole["x"], "x"))] + [
            (dist32(acc, n), dist32(g_whole[n], n))
            for n, acc in summed.items()]

        def rel_l2(gs, ref):
            """The relative L2 distance of gradients {name: g} from
            ``ref``'s, over all of them."""
            num = sum(float((gr.float() - ref[n].float()).square().sum())
                      for n, gr in gs.items())
            return math.sqrt(num / sum(float(ref[n].float().square().sum())
                                       for n in gs))
        split = {"x": got[0], **summed}
        split_l2 = rel_l2(split, g_whole)
        print(f"  M={m} gradients' distance from float32, split / whole: "
              + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, (a, b) in
                          zip(names, pairs))
              + f"; relative L2 over all {rel_l2(split, g32):.3e} / "
              f"{rel_l2({n: g_whole[n] for n in names}, g32):.3e}; split "
              f"against whole {split_l2:.3e} (bound "
              f"{TRAIN_BF16_GRAD_BOUND})", flush=True)
        check(split_l2 <= TRAIN_BF16_GRAD_BOUND and all(
            bool(torch.isfinite(gr).all()) for gr in got),
              f"tp_layer M={m}: the split layer's gradients' relative L2 "
              f"distance from the whole bf16 layer's {split_l2:.3e} "
              f"(bound {TRAIN_BF16_GRAD_BOUND})")

        # Rank 0's block alone: its forward, and forward + backward.
        p0 = ranks[0]
        tp0 = tpm.TP(plan, 0)
        leaves0 = [t for n, t in p0.items()
                   if tpm.param_block("dense", n, plan, 0) is not None]

        def rank0_step():
            xr = x.clone().requires_grad_()
            return grads(tpm.call_with(block, p0, layer, xr, tp0),
                         [xr] + leaves0)
        with torch.no_grad():
            r0_ms = time_ms(lambda: tpm.call_with(block, p0, layer, x, tp0))
        r0_step_ms = time_ms(rank0_step)
        print(f"  M={m}: plan {plan.record()} (KV heads {plan.kv}; rank 0: "
              f"query heads {plan.q_heads(0)}, KV heads {plan.kv_heads(0)}, "
              f"d_ff block {plan.block(cfg.d_ff, 0)}); the sum of the "
              f"partials off the whole layer by {err:.3e} (bound "
              f"{tol:.3e}: 2^-8 x (sum of {len(record)} partials' max "
              f"{float(sum(record)):.3e} + max|y| "
              f"{float(y_whole.float().abs().max()):.3e})); gradients "
              f"{max(a for a, _ in pairs):.3e} from float32 (the whole bf16 "
              f"layer's {max(b for _, b in pairs):.3e}); rank 0's block "
              f"forward "
              f"{r0_ms:.3f} ms against the whole layer's / M "
              f"{whole_ms / m:.3f} ms ({r0_ms * m / whole_ms:.2f}x), "
              f"forward + backward {r0_step_ms:.3f} ms against "
              f"{whole_step_ms / m:.3f} ms "
              f"({r0_step_ms * m / whole_step_ms:.2f}x)",
              flush=True)
        if m == max(sizes):
            # The flash kernels at rank 0's local heads.
            a = SimpleNamespace(**{k: p0[f"attn.{k}"].detach() for k in
                                   ("wq", "wk", "wv", "wo")})
            with torch.no_grad():
                h = apply_norm(cfg.norm_kind, block.ln1, x)
                qkv = [t.contiguous() for t in attn.gqa_qkv(
                    cfg, a, h, pos, tp0)]
            rows.append(flash_row(f"tp{m}", "tp_layer", *qkv, True))
            rows.append(flash_bwd_row(f"tp{m}", "tp_layer", *qkv, True, g))
            del qkv, h
        del y, record, ranks, split, got, p0, leaves0
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def flash_bwd_row(label, phase, q, k, v, causal, generator):
    """The flash_attention_bwd kernel of q's dtype at q [B, H, T, D], k/v
    [B, H_kv, S, D] (o, and for bf16 the log-sum-exp, the forward kernel's;
    do drawn from ``generator``) against attention_bwd_ref on the float32
    values (the bound stated at FLASH_BWD_TOL), two calls bitwise equal,
    timed beside it and beside ``torch.autograd.grad`` through
    ``scaled_dot_product_attention``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    bf16 = q.dtype == torch.bfloat16
    o, lse = (fa.attention_with_lse(q, k, v, causal=causal) if bf16 else
              (fa.attention(q, k, v, causal=causal), None))
    do = torch.randn(o.shape, generator=generator, device=o.device).to(
        q.dtype)

    def run():
        return fa.attention_bwd(q, k, v, o, do, causal=causal, lse=lse)

    got = run()
    check(all(torch.equal(a, b) for a, b in zip(got, run())),
          f"flash_attention_bwd/{label}: two calls differ")
    f32 = [x.float() for x in (q, k, v, o, do)]
    ref = fa.attention_bwd_ref(*f32, causal=causal)
    terms = (fa.bf16_rounding_terms(*f32, causal=causal) if bf16 else
             (0.0, 0.0, 0.0))
    err = worst = 0.0
    for name, a, r, term in zip(("dq", "dk", "dv"), got, ref, terms):
        tol = FLASH_BWD_TOL * float(r.abs().max()) + (
            FLASH_BF16_TOL * r.abs() + term if bf16 else 0.0)
        diff = (a.float() - r).abs()
        err = max(err, float(diff.max()))
        worst = max(worst, float((diff / tol).max()))
        check(bool((diff <= tol).all()) and bool(torch.isfinite(a).all()),
              f"flash_attention_bwd/{label}: {name} off its plain version "
              f"by up to {float(diff.max()):.3e}")
    del got, ref, terms, diff, tol
    b, h, t, d = q.shape
    h_kv, s = k.shape[1], k.shape[2]
    pairs = t * (t + 1) // 2 if causal else t * s
    # q k^T, do v^T, P^T do, dS k and dS^T q: 10 D operations a pair.
    bnd = bound(nbytes(q, k, v, o, do) + nbytes(q, k, v),
                10 * d * b * h * pairs,
                BF16_TC_OPS_PER_S if bf16 else FP32_OPS_PER_S)
    plain = (lambda: [g.to(q.dtype) for g in fa.attention_bwd_ref(
        *f32, causal=causal)])
    plain_ms = time_ms(plain, reps=2)
    del f32
    leaf = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaf, is_causal=causal, enable_gqa=h != h_kv)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, leaf, do,
                                                 retain_graph=True))
    del out, leaf
    ms = time_ms(run)
    # The bf16 design computes q k^T and do v^T in both passes: 7 products
    # of the 5 the bound counts.
    floor = (f"; the design's 7 products {bnd[0] * 7 / 5:.3f} ms" if bf16
             else "")
    return row("flash_attention_bwd", phase, err, ms, plain_ms, bnd, lib_ms,
               f"B={b} H={h} H_kv={h_kv} T={t} S={s} D={d} {q.dtype} "
               f"{'causal' if causal else 'non-causal'}"
               f"{' (off the path)' if phase == OFF_PATH else ''}; error "
               f"at {worst:.3f} of its tolerance{floor}; library: "
               f"autograd.grad through SDPA",
               label=f"flash_attention_bwd/{label}",
               source=None if bf16 else BWD_F32_SOURCE)


def tree_leaves(tree) -> list:
    """The tensors of a TrainState tree (NamedTuples and dicts, keys
    sorted), in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def leaf_grads(params, total) -> dict:
    """{reference leaf: [its parameters' gradients]} of ``total``."""
    import torch
    from repro_torch.models.transformer import stacked_leaves
    leaves = stacked_leaves(params)
    got = iter(torch.autograd.grad(total, [p for ps in leaves.values()
                                           for p in ps]))
    return {name: [next(got) for _ in ps] for name, ps in leaves.items()}


def kernel_and_plain(cfg, params, mbatch) -> dict:
    """{use_flash_kernel: (loss, leaf_grads)} of one microbatch."""
    from repro_torch.train.train_step import TrainConfig, make_loss_fn
    out = {}
    for kernel in (True, False):
        loss_fn = make_loss_fn(cfg, TrainConfig(use_flash_kernel=kernel))
        total, (loss, _) = loss_fn(params, mbatch)
        out[kernel] = (float(loss.detach()), leaf_grads(params, total))
        del total, loss
    return out


def bf16_grad_check(cfg, params, mbatch, label, phase="lm_train") -> None:
    """The bf16 kernel path's loss and gradients against the plain path's
    at ``params``, within TRAIN_BF16_LOSS_BOUND and TRAIN_BF16_GRAD_BOUND
    (``phase`` names the phase in the printed line)."""
    import torch
    out = kernel_and_plain(cfg, params, mbatch)
    num = den = 0.0
    worst_leaf = ("", 0.0)
    for name, gk in out[True][1].items():
        gp = out[False][1][name]
        n = sum(float((a.float() - b.float()).square().sum())
                for a, b in zip(gk, gp))
        m = sum(float(b.float().square().sum()) for b in gp)
        num, den = num + n, den + m
        if m > 0 and math.sqrt(n / m) > worst_leaf[1]:
            worst_leaf = (name, math.sqrt(n / m))
    rel = math.sqrt(num / den)
    loss_rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    finite = all(bool(torch.isfinite(g).all()) for gs in
                 out[True][1].values() for g in gs)
    print(f"{phase} bf16 gradients at full depth ({cfg.n_layers} layers), "
          f"{label}, one microbatch: loss kernel {out[True][0]:.6f} plain "
          f"{out[False][0]:.6f} (relative {loss_rel:.3e}, bound "
          f"{TRAIN_BF16_LOSS_BOUND}); gradients' relative L2 error "
          f"{rel:.3e} (bound {TRAIN_BF16_GRAD_BOUND}), worst leaf "
          f"{worst_leaf[0]} {worst_leaf[1]:.3e}", flush=True)
    check(finite, f"{phase} bf16 gradients {label}: not finite")
    check(loss_rel <= TRAIN_BF16_LOSS_BOUND, f"{phase} bf16 {label}: "
                                             f"kernel-path loss off the "
                                             f"plain path")
    check(rel <= TRAIN_BF16_GRAD_BOUND, f"{phase} bf16 {label}: "
                                        f"kernel-path gradients off the "
                                        f"plain path")


def train_grad_checks(cfg, dev, seed, mbatch, sh):
    """One microbatch's loss and gradients through the kernels against the
    plain attention path: full width, ``tight_layers``, float32; and full
    depth in the config's bf16.  Returns the bf16 model (for the kernel
    rows at its layer 0)."""
    import dataclasses
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer

    cfg32 = dataclasses.replace(cfg, n_layers=sh["tight_layers"],
                                dtype="float32")
    p32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(seed + 2), dev)
    p32.requires_grad_(True)
    before = (fa_ops.launches, fa_ops.launches_bwd, fa_ops.launches_bf16)
    out = kernel_and_plain(cfg32, p32, mbatch)
    after = (fa_ops.launches, fa_ops.launches_bwd, fa_ops.launches_bf16)
    runs = 2 if cfg32.remat else 1
    check(after[0] - before[0] == runs * cfg32.n_layers and
          after[1] - before[1] == BWD_LAUNCHES * cfg32.n_layers and
          after[2] == before[2],
          f"lm_train float32 gradients: {after[0] - before[0]} float32 "
          f"forward and {after[1] - before[1]} backward launches for "
          f"{cfg32.n_layers} layers")
    worst = 0.0
    for name, gk in out[True][1].items():
        gp = out[False][1][name]
        scale = max(float(g.abs().max()) for g in gp)
        diff = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
        worst = max(worst, diff / scale)
    loss32 = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    print(f"lm_train float32 gradients at {cfg32.n_layers} layers, full "
          f"width, one microbatch {tuple(mbatch['tokens'].shape)}: worst "
          f"leaf max|kernel - plain| / max|g| {worst:.3e} (bound "
          f"{TRAIN_TIGHT_BOUND}), loss {loss32:.3e}", flush=True)
    check(worst <= TRAIN_TIGHT_BOUND and loss32 <= TRAIN_TIGHT_BOUND,
          "lm_train float32 gradients: kernel path off the plain path")
    del p32, out
    torch.cuda.empty_cache()

    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed + 3), dev)
    params.requires_grad_(True)
    bf16_grad_check(cfg, params, mbatch, "at init")
    params.requires_grad_(False)
    return params


def train_section(args, dev, phases, rows, cfg=None, shapes=TRAIN_SHAPES):
    """Training at olmo-1b's full width and depth through
    ``launch/train.py``'s ``train`` (``cfg`` and ``shapes`` shrink it for
    a rehearsal on the CPU)."""
    import dataclasses
    import os
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import WARMUP_STEPS, train
    from repro_torch.models import transformer
    from repro_torch.models.transformer import stacked_leaves
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import leaf_shape
    from repro_torch.train.train_step import checkpoint_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or get_arch(TRAIN_ARCH)
    T, B, mb = sh["seq"], sh["batch"], sh["microbatches"]
    quiet = lambda *_: None
    needs = ("flash_attention_bf16", "flash_attention_bwd")
    print(f"lm_train: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype} remat={cfg.remat}: "
          f"{T}x{B} tokens a step in {mb} microbatches, lr {TRAIN_LR}, "
          f"warm-up {WARMUP_STEPS}", flush=True)

    def launches_per_step(c):
        fwd = c.n_layers * mb * (2 if c.remat else 1)
        return fwd, c.n_layers * mb * BWD_LAUNCHES

    def train_phase(name, steps, compression):
        stats_before = fa_ops.lse_written
        res, wall, counts, peak = phases.run(
            name, name, needs, lambda: train(
                cfg, steps, seq_len=T, global_batch=B, lr=TRAIN_LR,
                microbatches=mb, compression=compression, ckpt_every=0,
                seed=args.seed, device=dev, log=quiet), warm_up=False)
        fwd, bwd = launches_per_step(cfg)
        check(counts["flash_attention_bf16"] == steps * fwd and
              counts["flash_attention_bwd"] == steps * bwd and
              counts["flash_attention"] == 0,
              f"{name}: {counts['flash_attention_bf16']} bf16 forward, "
              f"{counts['flash_attention_bwd']} backward and "
              f"{counts['flash_attention']} float32 flash launches in "
              f"{steps} steps (want {fwd} and {bwd} a step)")
        # The bf16 backward reads the forward's log-sum-exp: every forward
        # launch of a step (remat's recompute too) writes it.
        check(fa_ops.lse_written - stats_before ==
              counts["flash_attention_bf16"],
              f"{name}: {fa_ops.lse_written - stats_before} of "
              f"{counts['flash_attention_bf16']} bf16 forward launches "
              f"wrote the log-sum-exp")
        losses = res.losses
        check(all(math.isfinite(x) for x in losses), f"{name}: a loss is "
                                                     f"not finite")
        warm = res.walls[1:] or res.walls
        print(f"phase {name}: [{B}x{T}, {mb} microbatches] {steps} steps "
              f"wall {wall:.3f} s step walls "
              f"{[round(w, 3) for w in res.walls]} s, "
              f"{T * B * len(warm) / sum(warm):.0f} tok/s after the first "
              f"step; losses {[round(x, 4) for x in losses]} grad_norm "
              f"{[round(m['grad_norm'], 3) for m in res.metrics]} lr "
              f"{[m['lr'] for m in res.metrics]} wire_bytes "
              f"{[m['wire_bytes'] for m in res.metrics]} launches {counts} "
              f"peak_mem {peak:.2f} GiB", flush=True)
        return res

    # lm_train's first microbatch; the kernel path is held to the plain
    # path on it after the steps here and at init in train_grad_checks.
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed,
                           device=dev).batch_at(0)
    mbatch = {k: v[:B // mb] for k, v in tokens.items()}
    res = train_phase("lm_train", sh["steps"], "none")
    check(res.losses[-1] < res.losses[0], "lm_train: the loss did not fall")
    bf16_grad_check(cfg, res.state.params, mbatch,
                    f"after lm_train's {sh['steps']} steps")
    lm_train = (res.losses, res.walls)
    del res
    torch.cuda.empty_cache()

    res = train_phase("lm_train_delta", sh["delta_steps"], "delta")
    want = 8 * sum(max(1, int(math.prod(leaf_shape(name, ps)) * 0.01))
                   for name, ps in stacked_leaves(res.state.params).items())
    got = [m["wire_bytes"] for m in res.metrics]
    print(f"lm_train_delta: wire_bytes {got} a step, host count "
          f"8 * sum(max(1, floor(0.01 * size))) = {want}", flush=True)
    check(all(g == want for g in got), "lm_train_delta: wire_bytes off the "
                                       "stacked leaves' count")
    del res
    torch.cuda.empty_cache()

    params = train_grad_checks(cfg, dev, args.seed, mbatch, sh)

    # Kernel rows at lm_train's layer-0 shape (the bf16 model above).
    g = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.no_grad():
        qkv = layer0_qkv(cfg, params, mbatch["tokens"])
    del params
    torch.cuda.empty_cache()
    groups = ("lm_train", "lm_train_delta", "lm_train_resume", "shard_train")
    rows.append(flash_row("train", groups, *qkv, True))
    rows.append(flash_bwd_row("train", groups, *qkv, True, g))
    rows.append(flash_bwd_row("train_f32", OFF_PATH,
                              *(a.float() for a in qkv), True, g))
    del qkv
    for label, (shape, causal, dtype) in FLASH_BWD_OFF_PATH.items():
        rows.append(flash_bwd_row(label, OFF_PATH,
                                  *random_qkv(shape, g, dtype), causal, g))
    torch.cuda.empty_cache()

    # lm_train_resume: 4 steps straight, and 2 steps, a checkpoint, a
    # restore and 2 more, at full width and 2 layers.
    # Each run's schedule ends at its own last step; the lr of steps 0-3
    # is the same in all of them (the cosine starts after the warm-up).
    cfg2 = dataclasses.replace(cfg, n_layers=sh["resume_layers"])
    n = sh["resume_steps"]
    assert n <= WARMUP_STEPS
    ckdir = str(ROOT / "build" / f"ckpt_train_{os.getpid()}")
    kw = dict(seq_len=T, global_batch=B, lr=TRAIN_LR, microbatches=mb,
              seed=args.seed, device=dev, log=quiet)

    def resume_runs():
        straight = train(cfg2, n, ckpt_every=0, **kw)
        half = train(cfg2, n // 2, ckpt_dir=ckdir, ckpt_every=n // 2, **kw)
        saved = checkpoint_tree(half.state)
        tree, step = CheckpointManager(ckdir).load_full(0, saved)
        same = step == n // 2 and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(tree_leaves(saved), tree_leaves(tree)))
        del saved, tree
        resumed = train(cfg2, n, ckpt_dir=ckdir, ckpt_every=0, resume=True,
                        **kw)
        return straight, half, resumed, same

    try:
        (straight, half, resumed, same), wall, counts, peak = phases.run(
            "lm_train_resume", "lm_train_resume", needs, resume_runs,
            warm_up=False)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    fwd, bwd = launches_per_step(cfg2)
    check(counts["flash_attention_bwd"] == 2 * n * bwd and
          counts["flash_attention_bf16"] == 2 * n * fwd,
          f"lm_train_resume: launches {counts}")
    check(same, "lm_train_resume: the restored state is not the saved one")
    check(resumed.start_step == n // 2, "lm_train_resume: did not resume")
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        half.losses + resumed.losses, straight.losses))
    print(f"phase lm_train_resume: [{cfg2.n_layers} layers, {B}x{T}] wall "
          f"{wall:.3f} s straight losses "
          f"{[round(x, 6) for x in straight.losses]}, cut at {n // 2} and "
          f"resumed {[round(x, 6) for x in half.losses + resumed.losses]}; "
          f"restored state equal to the saved one bit for bit; max "
          f"relative loss difference {rel:.3e} (bound "
          f"{TRAIN_RESUME_BOUND}) launches {counts} peak_mem {peak:.2f} GiB",
          flush=True)
    check(rel <= TRAIN_RESUME_BOUND, "lm_train_resume: the resumed losses "
                                     "are off the straight run's")
    del straight, half, resumed
    torch.cuda.empty_cache()
    shard_train_phases(args, dev, phases, cfg, sh, *lm_train)


def flop_share(cfg, kind, batch, seq, wall) -> str:
    """The step's model FLOPs (``roofline.step_flops``) over the card's
    dense bf16 peak for ``wall`` seconds, as text."""
    from repro_torch.launch import roofline
    try:
        chip = roofline.chip_constants()
    except (ValueError, RuntimeError) as e:   # no datasheet, no card
        return f"not known ({e})"
    share = roofline.step_flops(cfg, kind, batch, seq) / (
        wall * chip.peak_flops)
    return f"{share:.4f} of {chip.name}'s {chip.peak_flops / 1e12:.1f} TFLOP/s"


def shard_train_phases(args, dev, phases, cfg, sh, lm_losses, lm_walls):
    """shard_train: launch/train.py's train on the DTensor path over a
    (1, 1) mesh (SHARD_TRAIN_STEPS steps at lm_train's shapes; its step
    gathers through ``make_gather_fn`` by default), then one
    make_train_step step given the ZeRO-3 hook explicitly from a fresh
    state, each loss held to lm_train's at the same step."""
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.sharding import make_gather_fn, param_mesh
    from repro_torch.launch.train import WARMUP_STEPS, train
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step,
                                              shard_train_state)
    T, B, mb = sh["seq"], sh["batch"], sh["microbatches"]
    n = SHARD_TRAIN_STEPS
    needs = ("flash_attention_bf16", "flash_attention_bwd")
    fwd = cfg.n_layers * mb * (2 if cfg.remat else 1)
    bwd = cfg.n_layers * mb * BWD_LAUNCHES
    with one_rank_mesh(dev) as mesh:
        stats_before = fa_ops.lse_written
        res, wall, counts, peak = phases.run(
            "shard_train", "shard_train", needs, lambda: train(
                cfg, n, seq_len=T, global_batch=B, lr=TRAIN_LR,
                microbatches=mb, ckpt_every=0, mesh="1x1", seed=args.seed,
                device=dev, log=lambda *_: None), warm_up=False)
        check(param_mesh(res.state.params) is not None,
              "shard_train: the state is not stored on the mesh")
        check(counts["flash_attention_bf16"] == n * fwd and
              counts["flash_attention_bwd"] == n * bwd and
              counts["flash_attention"] == 0 and
              fa_ops.lse_written - stats_before == n * fwd,
              f"shard_train: launches {counts} in {n} steps (want {fwd} "
              f"bf16 forward and {bwd} backward a step)")
        losses, walls = res.losses, res.walls
        del res
        torch.cuda.empty_cache()
        tcfg = TrainConfig(
            adamw=AdamWConfig(lr=TRAIN_LR, warmup_steps=WARMUP_STEPS,
                              total_steps=n),
            microbatches=mb, gather_fn=make_gather_fn(mesh))
        state = shard_train_state(init_train_state(
            cfg, tcfg, torch.Generator(device=dev).manual_seed(args.seed),
            dev), mesh)
        batch = TokenPipeline(cfg.vocab, T, B, seed=args.seed,
                              device=dev).batch_at(0)
        step = make_train_step(cfg, tcfg)
        (_, met), g_wall, g_counts, g_peak = phases.run(
            "shard_train_gather", "shard_train", needs,
            lambda: step(state, batch), warm_up=False)
        g_loss = float(met["loss"])
        del state, met
        torch.cuda.empty_cache()
    # The plain path's steps just after, on the same host minutes: the
    # DTensor path's cost without lm_train's distance in time.
    plain = train(cfg, n, seq_len=T, global_batch=B, lr=TRAIN_LR,
                  microbatches=mb, ckpt_every=0, seed=args.seed, device=dev,
                  log=lambda *_: None)
    p_losses, p_walls = plain.losses, plain.walls
    del plain
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, lm_losses))
    g_rel = abs(g_loss - lm_losses[0]) / abs(lm_losses[0])
    same = losses == lm_losses[:n] == p_losses and g_loss == lm_losses[0]

    def mean_warm(ws):
        return sum(ws[1:] or ws) / len(ws[1:] or ws)
    w, lm_w, p_w = mean_warm(walls), mean_warm(lm_walls), mean_warm(p_walls)
    print(f"phase shard_train: {cfg.name} [{B}x{T}, {mb} microbatches] on a "
          f"(1, 1) mesh, {n} steps: losses {losses} (lm_train's "
          f"{lm_losses[:n]}), max relative difference {rel:.3e}; one step "
          f"with the ZeRO-3 hook: loss {g_loss} (lm_train's step 0 "
          f"{lm_losses[0]}, {g_rel:.3e}); bit-identical to lm_train: "
          f"{same} (bound {SHARD_LOSS_RTOL}); step walls "
          f"{[round(x, 3) for x in walls]} s, mean after the first {w:.3f} "
          f"s against lm_train's {lm_w:.3f} s ({(w - lm_w) / lm_w:+.1%}, "
          f"the DTensor path's cost) and the plain path's {n} steps run just "
          f"after {p_w:.3f} s ({(w - p_w) / p_w:+.1%}; walls "
          f"{[round(x, 3) for x in p_walls]}); the hooked step "
          f"{g_wall:.3f} s; "
          f"model-FLOP share of a step: sharded {flop_share(cfg, 'train', B, T, w)}, "
          f"lm_train {flop_share(cfg, 'train', B, T, lm_w)}, hooked "
          f"{flop_share(cfg, 'train', B, T, g_wall)}; launches {counts} "
          f"(hooked step {g_counts}) peak_mem {peak:.2f} GiB (hooked "
          f"{g_peak:.2f} GiB); card {card_line()}", flush=True)
    check(all(math.isfinite(x) for x in losses), "shard_train: a loss is "
                                                 "not finite")
    check(rel <= SHARD_LOSS_RTOL and g_rel <= SHARD_LOSS_RTOL,
          "shard_train: losses off lm_train's")
    # A model axis of 1 splits nothing (models/tp.py): the step is
    # lm_train's, bit for bit.
    check(same, "shard_train: losses not bit-identical to lm_train's")


def moe_train_section(args, dev, phases, rows, cfg=None,
                      shapes=MOE_TRAIN_SHAPES):
    """moe_train: mixtral-8x22b at full width, depth cut to
    MOE_TRAIN_SHAPES["layers"], trained through launch/train.py's train
    on the DTensor path over a (1, 1) mesh; then one microbatch's
    gradients through the sharded step against the plain path's, the
    routes replayed (``cfg`` and ``shapes`` shrink it for a rehearsal on
    the CPU).  It adds no kernel row to ``rows``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.sharding import local, shard_params
    from repro_torch.launch.train import train
    from repro_torch.models import transformer
    from repro_torch.train.train_step import (TrainConfig, make_loss_fn,
                                              make_rank_loss_fn)

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or dataclasses.replace(get_arch(MOE_TRAIN_ARCH),
                                     n_layers=sh["layers"])
    T, B, mb, n = sh["seq"], sh["batch"], sh["microbatches"], sh["steps"]
    n_params = transformer.param_count(transformer.LM(cfg, device="meta"))
    state_gb = n_params * (2 + 4 + 4 + 4 + 2) / 1e9
    print(f"moe_train: {cfg.name} {cfg.n_layers} layer(s) d={cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} experts "
          f"{cfg.n_experts} top-{cfg.top_k} d_ff={cfg.d_ff} window "
          f"{cfg.window} vocab={cfg.vocab} {cfg.dtype}: {n_params} "
          f"parameters, trained state {state_gb:.1f} GB (16 bytes a "
          f"parameter: bf16 parameters, float32 mu, nu and gradient "
          f"accumulators, a microbatch's bf16 gradient); {B}x{T} tokens a "
          f"step in {mb} microbatches, lr "
          f"{TRAIN_LR}", flush=True)
    with one_rank_mesh(dev) as mesh:
        res, wall, counts, peak = phases.run(
            "moe_train", "moe_train", (), lambda: train(
                cfg, n, seq_len=T, global_batch=B, lr=TRAIN_LR,
                microbatches=mb, ckpt_every=0, mesh="1x1", seed=args.seed,
                device=dev, log=lambda *_: None), warm_up=False)
        losses, walls = res.losses, res.walls
        del res
        torch.cuda.empty_cache()
        warm = walls[1:] or walls
        print(f"phase moe_train: [{B}x{T}, {mb} microbatches] {n} steps "
              f"wall {wall:.3f} s step walls {[round(x, 3) for x in walls]} "
              f"s, {T * B * len(warm) / sum(warm):.0f} tok/s after the "
              f"first step; losses {losses}; model-FLOP share "
              f"{flop_share(cfg, 'train', B, T, sum(warm) / len(warm))}; "
              f"launches {counts} peak_mem {peak:.2f} GiB (trained state "
              f"{state_gb / 1.073741824:.1f} GiB by the arithmetic); card "
              f"{card_line()}", flush=True)
        check(all(math.isfinite(x) for x in losses), "moe_train: a loss is "
                                                     "not finite")

        # One microbatch's gradients: the sharded step's loss on stored
        # DTensors against the plain path's, which replays its routes.
        mbatch = {k: v[:B // mb] for k, v in TokenPipeline(
            cfg.vocab, T, B, seed=args.seed, device=dev).batch_at(0).items()}
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed + 5), dev)
        params.requires_grad_(True)
        with RouteLog() as k_log:
            shard_params(params, mesh)
            total, (loss_k, _) = make_rank_loss_fn(cfg, TrainConfig(),
                                                   mesh)(params, mbatch,
                                                         False)
            g_k = [local(g) for g in torch.autograd.grad(
                total, list(params.parameters()))]
        loss_k = float(loss_k.detach())
        del total, params
        torch.cuda.empty_cache()
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed + 5), dev)
        params.requires_grad_(True)
        with RouteLog(replay=k_log.calls, keep_grad=True) as p_log:
            total, (loss_p, _) = make_loss_fn(cfg, TrainConfig(
                use_flash_kernel=False))(params, mbatch)
            g_p = torch.autograd.grad(total, list(params.parameters()))
        loss_p = float(loss_p.detach())
        del total, params
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(g_k, g_p))
    den = sum(float(b.float().square().sum()) for b in g_p)
    rel = math.sqrt(num / den)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    print(f"moe_train gradients, one microbatch {tuple(mbatch['tokens'].shape)}"
          f": loss sharded {loss_k:.6f} plain {loss_p:.6f} (relative "
          f"{loss_rel:.3e}, bound {TRAIN_BF16_LOSS_BOUND}); gradients' "
          f"relative L2 error {rel:.3e} (bound {TRAIN_BF16_GRAD_BOUND}); "
          f"{p_log.flips} of {B // mb * T * cfg.n_layers} token-layers "
          f"would have chosen other experts", flush=True)
    check(finite, "moe_train gradients: not finite")
    check(loss_rel <= TRAIN_BF16_LOSS_BOUND and rel <= TRAIN_BF16_GRAD_BOUND,
          "moe_train gradients: the sharded step off the plain path")
    del g_k, g_p
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Mixture-of-Experts serving: arctic-480b and mixtral-8x22b.
# ---------------------------------------------------------------------------

class RouteLog:
    """While active, records each ``moe._route`` call's expert choices and
    probabilities (a wrapper around the port's router function; the path
    computes the same values with it or without).  With ``replay`` (an
    earlier log's calls), each call returns the replayed choices and
    probabilities instead, and the log records its own; ``flips`` then
    counts the tokens whose own choices differed from the replayed ones.
    With ``keep_grad`` a replay takes a token's own choices and
    probabilities (which carry the router's gradient) where its experts
    agree with the replayed ones, and the replayed ones only where they
    do not."""

    def __init__(self, replay=None, keep_grad=False):
        self.calls = []    # (top_e int32[n, k], top_p f32[n, k]), in order
        self.replay = replay
        self.keep_grad = keep_grad
        self.flips = 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._route = route = moe._route

        def logged(cfg, params, xf):
            top_e, top_p, aux = route(cfg, params, xf)
            self.calls.append((top_e.clone(), top_p.detach().clone()))
            if self.replay is None:
                return top_e, top_p, aux
            old_e, old_p = self.replay[len(self.calls) - 1]
            differ = (torch.sort(top_e, -1).values !=
                      torch.sort(old_e, -1).values).any(-1)
            self.flips += int(differ.sum())
            if self.keep_grad:
                return (torch.where(differ[:, None], old_e, top_e),
                        torch.where(differ[:, None], old_p, top_p), aux)
            return old_e, old_p, aux
        moe._route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self._route


class CallCount:
    """While active, counts the calls of ``module.name``."""

    def __init__(self, module, name):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.fn = fn = getattr(self.module, self.name)

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def kept_copies(top_e, top_p, cap):
    """Which routed copies a capacity-``cap`` dispatch keeps, computed on
    the host apart from the port's code: numpy's lexsort by expert, then
    descending probability, then copy index (ties to the earlier copy);
    each expert's first ``cap``.  bool [n, k]."""
    import numpy as np
    e = top_e.reshape(-1).cpu().numpy()
    p = top_p.reshape(-1).float().cpu().numpy()
    idx = np.arange(e.size)
    order = np.lexsort((idx, -p, e))
    se = e[order]
    rank = np.arange(e.size) - np.searchsorted(se, se, side="left")
    keep = np.empty(e.size, bool)
    keep[order] = rank < cap
    return keep.reshape(tuple(top_e.shape))


def routes(cfg, calls):
    """Per call: (each token's experts, sorted [n, k]; whether each of
    those copies was kept [n, k]) at the capacity of that call's token
    count."""
    import numpy as np
    from repro_torch.models import moe
    out = []
    for top_e, top_p in calls:
        cap = moe._capacity(cfg, top_e.shape[0])
        e = top_e.cpu().numpy()
        by_expert = np.argsort(e, axis=-1, kind="stable")
        out.append((np.take_along_axis(e, by_expert, -1), np.take_along_axis(
            kept_copies(top_e, top_p, cap), by_expert, -1)))
    return out


def copies(cfg, calls) -> tuple[int, int]:
    """(kept, dropped) routed copies over ``calls`` (a :class:`RouteLog`'s),
    each call at the capacity of its token count under ``cfg``."""
    kept = total = 0
    for _, keep in routes(cfg, calls):
        kept += int(keep.sum())
        total += keep.size
    return kept, total - kept


def route_agreement(a, b, rows_a, rows_b):
    """Tokens whose routes agree in every layer: ``a`` and ``b`` lists of
    :func:`routes` items a layer, ``rows_a`` / ``rows_b`` the compared
    tokens' rows in each (the same shape).  Routing is discrete: two
    paths whose activations part by rounding can send a token whose k-th
    and (k+1)-th probabilities nearly tie to different experts, or drop a
    different copy at a full expert, and that token's outputs then part by
    a whole expert's contribution.  A bound on continuous error holds on
    the tokens whose experts and kept copies agree, and whose context
    (the other tokens they attend to) did not part by a whole expert: a
    check between two full-sequence runs replays one run's routes in the
    other instead (:class:`RouteLog`)."""
    import numpy as np
    ok = np.ones(rows_a.shape, bool)
    for (ea, ka), (eb, kb) in zip(a, b):
        ok &= ((ea[rows_a] == eb[rows_b]).all(-1) &
               (ka[rows_a] == kb[rows_b]).all(-1))
    return ok


def moe_decode_check(name, cfg, params, ext, start, steps):
    """Teacher-forced decode of ``ext[:, start:start + steps]`` against a
    forward over ``ext``, on the tokens whose routes agree.  A decode step
    of B <= 8 tokens never drops a copy (an expert gets at most B of them
    and its capacity is 8), while the forward drops them past capacity,
    and the Zipf tokens of TokenPipeline overfill the experts that their
    frequent tokens choose; so the forward and the prefill before the
    decode run at a capacity factor of E / k, which makes the capacity the
    token count: both compute the function decode does.  Returns (error,
    tokens compared, tokens)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import moe, transformer
    B, L = ext.shape
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    check(moe._capacity(cfg, B * L) >= B * L,
          f"{name}: a capacity below the token count")
    with RouteLog() as fwd_log:
        full, _ = transformer.forward(cfg, params, ext)
    tail = full[:, start:start + steps].clone()
    del full
    with RouteLog() as dec_log:
        dec = teacher_forced(cfg, params, ext, start, steps)
    fwd = routes(cfg, fwd_log.calls)
    dec_calls = dec_log.calls[cfg.n_layers:]       # after the prefill's
    b_idx = np.arange(B)[:, None]
    ok = np.ones((B, steps), bool)
    for i in range(steps):
        step = routes(cfg, dec_calls[i * cfg.n_layers:
                                     (i + 1) * cfg.n_layers])
        ok[:, i] = route_agreement(fwd, step, (b_idx * L + start + i)[:, 0],
                                   np.arange(B))
    n_ok = int(ok.sum())
    print(f"{name}: decode vs forward: routes agree on {n_ok} of {ok.size} "
          f"tokens", flush=True)
    check(n_ok >= ok.size / 2, f"{name}: routes agree on {n_ok} of "
                               f"{ok.size} decode tokens, fewer than half")
    m = torch.as_tensor(ok, device=dec.device)
    return float((dec - tail)[m].abs().max() / tail.abs().max()), n_ok, \
        ok.size


def dispatch_check(name, cfg, params, prompt, n_sample):
    """The sort dispatch at full width on layer 0's MoE input over the
    prompt: every expert keeps min(count, capacity) copies, its
    highest-probability ones, ties to the earlier copy (:func:
    `kept_copies`, against the port's own ranks); the expert output of
    ``n_sample`` tokens (those with a dropped copy first) against a
    float64 evaluation of their kept copies, each the expert's SwiGLU
    times its renormalised probability; and ``moe_ffn``'s output equal to
    that expert output plus arctic's dense residual, rounded to bf16."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models.layers import apply_mlp, apply_norm
    layer = params.layers[0]
    ffn = layer.ffn
    B, T = prompt.shape
    x = params.embed[prompt.long()]
    pos = torch.arange(T, dtype=torch.int32, device=x.device).expand(B, T)
    x = x + attn.gqa_train(cfg, layer.attn,
                           apply_norm(cfg.norm_kind, layer.ln1, x), pos)
    h2 = apply_norm(cfg.norm_kind, layer.ln2, x)
    del x
    n, d, E, k = B * T, cfg.d_model, cfg.n_experts, cfg.top_k
    xf = h2.reshape(n, d)
    cap = moe._capacity(cfg, n)
    top_e, top_p, _ = moe._route(cfg, ffn, xf)
    keep = kept_copies(top_e, top_p, cap)
    e_np = top_e.cpu().numpy()
    counts = np.bincount(e_np.ravel(), minlength=E)
    kept = np.bincount(e_np[keep], minlength=E)
    check(bool((kept == np.minimum(counts, cap)).all()),
          f"{name}: an expert keeps other than min(count, capacity)")
    port_kept, port_rows = moe._sorted_kept(top_e.reshape(-1).long(),
                                            top_p.reshape(-1), E, cap)
    port_keep = np.zeros(n * k, bool)
    port_keep[port_kept.cpu().numpy()] = True
    check(bool((port_keep.reshape(n, k) == keep).all()) and
          port_rows == np.minimum(counts, cap).tolist(),
          f"{name}: the dispatch keeps other copies than the "
          f"highest-probability ones")
    y32 = moe._dispatch_sort(cfg, ffn, xf, top_e, top_p, cap)
    y, _ = moe.moe_ffn(cfg, ffn, h2)
    dense = apply_mlp(ffn.dense, xf) if cfg.moe_dense_residual else 0.0
    check(torch.equal(y.reshape(n, d), (y32 + dense).to(y.dtype)),
          f"{name}: moe_ffn's output is not its dispatch's plus the dense "
          f"residual")
    # Sampled tokens: those with a dropped copy first, then random ones.
    g = np.random.default_rng(0)
    dropped = np.flatnonzero(~keep.all(-1))
    rest = np.setdiff1d(np.arange(n), dropped)
    take = np.concatenate([dropped[:n_sample // 2], g.choice(
        rest, n_sample - min(len(dropped), n_sample // 2), replace=False)])
    y64 = torch.zeros((len(take), d), dtype=torch.float64, device=xf.device)
    x64 = xf[torch.as_tensor(take, device=xf.device)].double()
    p_np = top_p.double().cpu().numpy()
    for e in map(int, np.unique(e_np[take][keep[take]])):
        sel = [(i, j) for i, t in enumerate(take) for j in range(k)
               if e_np[t, j] == e and keep[t, j]]
        rows = torch.as_tensor([i for i, _ in sel], device=xf.device)
        xs = x64[rows]
        hidden = F.silu(xs @ ffn.w_gate[e].double()) * (
            xs @ ffn.w_up[e].double())
        out = hidden @ ffn.w_down[e].double()
        w = torch.as_tensor([p_np[take[i], j] for i, j in sel],
                            device=xf.device)
        y64.index_add_(0, rows, out * w[:, None])
    got = y32[torch.as_tensor(take, device=xf.device)].double()
    err = float((got - y64).abs().max() / y64.abs().max())
    print(f"{name}: dispatch at {n} tokens, capacity {cap}: copies an "
          f"expert min {counts.min()} max {counts.max()}, "
          f"{int((~keep).sum())} copies dropped over "
          f"{int((counts > cap).sum())} experts; kept copies = min(count, "
          f"capacity), the highest-probability ones; expert output of "
          f"{len(take)} tokens ({min(len(dropped), n_sample // 2)} with a "
          f"dropped copy) vs float64 {err:.3e} of max |y| (bound "
          f"{MOE_DISPATCH_BOUND})", flush=True)
    check(err <= MOE_DISPATCH_BOUND, f"{name}: dispatch output off the "
                                     f"float64 evaluation by {err:.3e}")


def serve_line(name, B, P, new, res, wall, counts, peak) -> str:
    return (f"phase {name}: [{B}x{P} + {new}] wall {wall:.3f} s prefill "
            f"{res.prefill_s:.3f} s ({B * P / res.prefill_s:.0f} tok/s) "
            f"decode {res.decode_steps} steps {res.decode_s:.3f} s "
            f"({B * res.decode_steps / res.decode_s:.1f} tok/s) launches "
            f"{counts} peak_mem {peak:.2f} GiB; card {card_line()}")


def moe_init(cfg, dev, seed, label):
    import torch
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    sync()
    print(f"{label}: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} experts "
          f"{cfg.n_experts} top-{cfg.top_k} d_ff={cfg.d_ff} "
          f"dense residual {cfg.moe_dense_residual} window {cfg.window} "
          f"vocab={cfg.vocab} {cfg.dtype}: "
          f"{transformer.param_count(params)} parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({time.perf_counter() - t0:.1f} s to init on the card)",
          flush=True)
    return params


def moe_section(args, dev, phases, rows, cfg=None, shapes=MOE_SHAPES):
    """MoE serving at arctic-480b's full width, depth cut to
    MOE_SHAPES["layers"] (``cfg`` and ``shapes`` shrink it for a rehearsal
    on the CPU)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or dataclasses.replace(get_arch(MOE_ARCH),
                                     n_layers=sh["layers"])
    params = moe_init(cfg, dev, args.seed, "moe")
    B, P, new, n = sh["serve_batch"], sh["prompt"], sh["new"], \
        sh["decode_steps"]
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 2,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    stats_before = fa_ops.lse_written
    res, wall, counts, peak = phases.run(
        "moe_serve", "moe_serve", ("flash_attention_bf16",),
        lambda: serve(cfg, params, prompt, new))
    check(counts["flash_attention_bf16"] == cfg.n_layers and
          counts["flash_attention"] == 0 and
          counts["flash_attention_bwd"] == 0 and
          fa_ops.lse_written == stats_before,
          f"moe_serve: {counts} launches for a prefill of {cfg.n_layers} "
          f"layers, {fa_ops.lse_written - stats_before} statistics written")
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()) and
          bool(torch.isfinite(res.prefill_logits).all()),
          f"moe_serve: tokens {toks.dtype}{tuple(toks.shape)} out of range")
    print(serve_line("moe_serve", B, P, new, res, wall, counts, peak),
          flush=True)

    # The kernel path against the plain attention path, on the first two
    # prompts (the plain scores of all eight, 7.5 GB, would not fit beside
    # the weights), the plain run taking the kernel run's routes: the two
    # then part by the attention alone (:func:`route_agreement`).
    two = prompt[:2].contiguous()
    with RouteLog() as k_log:
        kern, _ = transformer.forward(cfg, params, two)
    with RouteLog(replay=k_log.calls) as p_log:
        plain, _ = transformer.forward(cfg, params, two, use_kernel=False)
    err_plain = rel_err(kern, plain)
    del kern, plain
    # The prefill's last logits against the forward's: the same
    # computation but for the head's product shape.
    full, _ = transformer.forward(cfg, params, prompt)
    last = full[:, -1:].clone()
    del full
    err_prefill = rel_err(res.prefill_logits, last)
    err_dec, n_ok, n_dec = moe_decode_check("moe_serve", cfg, params, ext,
                                            P, n)
    print(f"moe_serve: max|kernel - plain| / max|logit| {err_plain:.3e} "
          f"over 2 x {P} tokens, the kernel run's routes replayed "
          f"({p_log.flips} of {2 * P * cfg.n_layers} token-layers would "
          f"have chosen other experts) (bound {LM_BF16_BOUND}); prefill last logits vs forward "
          f"{err_prefill:.3e} (bound {LM_PREFILL_BOUND:.3e}); "
          f"teacher-forced decode ({n} steps) vs forward {err_dec:.3e} "
          f"over {n_ok} of {n_dec} tokens (bound {LM_DECODE_BOUND}); "
          f"sample {toks[0, :8].tolist()}", flush=True)
    check(err_plain <= LM_BF16_BOUND, "moe_serve: kernel path off the "
                                      "plain path")
    check(err_prefill <= LM_PREFILL_BOUND, "moe_serve: prefill logits off "
                                           "the forward")
    check(err_dec <= LM_DECODE_BOUND, "moe_serve: decode off the forward")
    del last
    torch.cuda.empty_cache()

    # The prefill at full load: a capacity factor of E / k keeps every
    # copy (the setting moe_decode_check compares decode at), so the expert
    # products run on all of them; beside serve's prefill, whose Zipf
    # tokens overfill a few experts.
    with RouteLog() as cap_log:
        transformer.prefill_forward(cfg, params, prompt, P + new)
    kept_cap, dropped_cap = copies(cfg, cap_log.calls)
    del cap_log
    full_cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    with RouteLog() as full_log:
        (logits, _), wall, counts, peak = phases.run(
            "moe_prefill_full", "moe_prefill_full", ("flash_attention_bf16",),
            lambda: transformer.prefill_forward(full_cfg, params, prompt,
                                                P + new))
    kept_full, dropped_full = copies(full_cfg,
                                     full_log.calls[-cfg.n_layers:])
    del full_log
    check(dropped_full == 0 and bool(torch.isfinite(logits).all()),
          f"moe_prefill_full: {dropped_full} copies dropped at capacity "
          f"factor {full_cfg.capacity_factor}")
    del logits
    print(f"phase moe_prefill_full: [{B}x{P}] prefill at capacity factor "
          f"E / k = {full_cfg.capacity_factor:g}: wall {wall:.3f} s "
          f"({B * P / wall:.0f} tok/s), copies kept {kept_full} dropped "
          f"{dropped_full} (packed float32 inputs of the kept copies "
          f"{kept_full // cfg.n_layers * cfg.d_model * 4 / 1e9:.3f} GB a "
          f"layer) launches {counts} peak_mem {peak:.2f} GiB; serve's "
          f"prefill at capacity factor {cfg.capacity_factor:g}: "
          f"{res.prefill_s:.3f} s, copies kept {kept_cap} dropped "
          f"{dropped_cap}; card {card_line()}", flush=True)
    torch.cuda.empty_cache()

    dispatch_check("moe_serve", cfg, params, prompt, sh["dispatch_tokens"])
    qkv = layer0_qkv(cfg, params, prompt)
    del params, res, ext, prompt, two
    torch.cuda.empty_cache()
    rows.append(flash_row(f"prefill_{cfg.n_heads}_{cfg.n_kv_heads}",
                          "moe_serve", *qkv, True))
    del qkv
    torch.cuda.empty_cache()


def moe_window_section(args, dev, phases, rows, cfg=None,
                       shapes=MOE_WINDOW_SHAPES):
    """MoE serving with a sliding window at mixtral-8x22b's full width,
    depth cut to MOE_WINDOW_SHAPES["layers"] (``cfg`` and ``shapes``
    shrink it for a rehearsal on the CPU)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or dataclasses.replace(get_arch(MOE_WINDOW_ARCH),
                                     n_layers=sh["layers"])
    params = moe_init(cfg, dev, args.seed, "moe_window")
    B, P, new, n = sh["serve_batch"], sh["prompt"], sh["new"], \
        sh["decode_steps"]
    W = cfg.window
    check(P > W and P * P > attn.BLOCKED_THRESHOLD,
          f"moe_window_serve: a prompt of {P} neither wraps the window "
          f"{W} nor takes blocked_attention")
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 3,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    res, wall, counts, peak = phases.run(
        "moe_window_serve", "moe_window_serve", (),
        lambda: serve(cfg, params, prompt, new))
    check(not any(counts.values()),
          f"moe_window_serve: launched {counts}; the window's paths run no "
          f"kernel")
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()) and
          bool(torch.isfinite(res.prefill_logits).all()),
          f"moe_window_serve: tokens {toks.dtype}{tuple(toks.shape)} out "
          f"of range")
    print(serve_line("moe_window_serve", B, P, new, res, wall, counts,
                     peak), flush=True)

    # The prefill's cache: the last W positions in ring order, through
    # blocked_attention in every layer.
    with CallCount(attn, "blocked_attention") as blocked, \
            CallCount(attn, "_windowed_attention") as windowed, \
            RouteLog() as pre_log:
        logits, cache = transformer.prefill_forward(cfg, params, prompt,
                                                    P + new)
    check(blocked.n == cfg.n_layers and windowed.n == 0,
          f"moe_window_serve: the prefill took blocked_attention "
          f"{blocked.n} and _windowed_attention {windowed.n} times")
    want = torch.empty(W, dtype=torch.int32, device=dev)
    kept = torch.arange(P - W, P, dtype=torch.int32, device=dev)
    want[kept.long() % W] = kept
    for c in cache["layers"]:
        check(c["attn"]["k"].shape[2] == W and
              bool((c["attn"]["pos"] == want).all()),
              "moe_window_serve: the prefill's ring is not the last window "
              "in ring order")
    check(torch.equal(logits, res.prefill_logits),
          "moe_window_serve: prefill logits differ from serve's")
    del cache
    # The prefill (blocked) against the forward (_windowed_attention), the
    # forward taking the prefill's routes.
    with RouteLog(replay=pre_log.calls) as f_log:
        full, _ = transformer.forward(cfg, params, prompt)
    last = full[:, -1:].clone()
    del full
    err_prefill = rel_err(logits, last)
    flips = f_log.flips
    kept, dropped = copies(cfg, pre_log.calls)
    del last, logits, pre_log, f_log
    torch.cuda.empty_cache()
    err_dec, n_ok, n_dec = moe_decode_check("moe_window_serve", cfg, params,
                                            ext, P, n)
    print(f"moe_window_serve: ring of {W} slots, positions {P - W}..{P - 1}; "
          f"decode positions {P}..{P + n - 1} read a wrapped ring; prefill "
          f"(blocked_attention) last logits vs forward (_windowed_attention) "
          f"with the prefill's routes ({flips} of {B * P * cfg.n_layers} "
          f"token-layers would have chosen other experts; copies kept "
          f"{kept} dropped {dropped} at capacity factor "
          f"{cfg.capacity_factor:g}) "
          f"{err_prefill:.3e} (bound {LM_BF16_BOUND}); teacher-forced "
          f"decode ({n} steps) vs forward {err_dec:.3e} over {n_ok} of "
          f"{n_dec} tokens (bound {LM_DECODE_BOUND}); sample "
          f"{toks[0, :8].tolist()}", flush=True)
    check(err_prefill <= LM_BF16_BOUND, "moe_window_serve: prefill off the "
                                        "forward")
    check(err_dec <= LM_DECODE_BOUND, "moe_window_serve: decode off the "
                                      "forward")

    torch.cuda.empty_cache()
    shard_a2a_phase(cfg, params, prompt[:, :sh["a2a_tokens"]].contiguous(),
                    dev, phases)

    # blocked_attention against _windowed_attention on layer 0's q, k, v.
    q, k, v = (a.float() for a in layer0_qkv(cfg, params, prompt))
    del params, res, ext, prompt
    torch.cuda.empty_cache()
    blk = attn.blocked_attention(q, k, v, causal=True, window=W)
    win = attn._windowed_attention(q, k, v, W)
    err_blk = float((blk - win).abs().max() / win.abs().max())
    print(f"moe_window_serve: blocked_attention vs _windowed_attention on "
          f"layer 0's q, k, v [{B}x{cfg.n_heads}/{cfg.n_kv_heads}x{P}x"
          f"{cfg.hd}] float32: {err_blk:.3e} of max |out| (bound "
          f"{WINDOW_BLOCKED_BOUND})", flush=True)
    check(err_blk <= WINDOW_BLOCKED_BOUND, "moe_window_serve: blocked "
                                           "attention off the windowed")
    del blk, win
    torch.cuda.empty_cache()
    # The bf16 kernel at mixtral's heads (group 6), full causal attention:
    # a function the window's path does not compute, so it reports this
    # phase's launches, 0.
    g = torch.Generator(device=dev).manual_seed(args.seed)
    r = flash_row(f"heads_{cfg.n_heads}_{cfg.n_kv_heads}",
                  "moe_window_serve", *random_qkv(
        (B, cfg.n_heads, cfg.n_kv_heads, W, W, cfg.hd), g, cfg.dtype), True)
    r["shape"] += " (off the path: the window takes blocked/windowed " \
                  "attention, no kernel)"
    rows.append(r)
    del q, k, v
    torch.cuda.empty_cache()


def mla_section(args, dev, phases, rows, cfg=None, shapes=MLA_SHAPES):
    """Multi-head latent attention at minicpm3-4b's full width and depth,
    served through ``launch/serve.py``'s ``serve`` (``cfg`` and ``shapes``
    shrink it for a rehearsal on the CPU).  MLA runs no kernel: its q·k
    width (64 + 32) is not its v width (64), which the flash kernels do not
    take, in either package."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or get_arch(MLA_ARCH)
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    sync()
    print(f"mla: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} heads "
          f"{cfg.n_heads} q.k {cfg.hd}+{cfg.mla_rope_dim} v {cfg.hd} q rank "
          f"{cfg.mla_q_rank} kv rank {cfg.mla_kv_rank} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype}: "
          f"{transformer.param_count(params)} parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({time.perf_counter() - t0:.1f} s to init on the card)",
          flush=True)
    B, P, new, n = sh["serve_batch"], sh["prompt"], sh["new"], \
        sh["decode_steps"]
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 4,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    res, wall, counts, peak = phases.run(
        "mla_serve", "mla_serve", (), lambda: serve(cfg, params, prompt, new))
    check(not any(counts.values()),
          f"mla_serve: launched {counts}; MLA runs no kernel")
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()) and
          bool(torch.isfinite(res.prefill_logits).all()),
          f"mla_serve: tokens {toks.dtype}{tuple(toks.shape)} out of range")
    print(serve_line("mla_serve", B, P, new, res, wall, counts, peak),
          flush=True)

    # The latent cache: c and the rope key, (kv rank + rope) values a
    # token, against the K/V a GQA cache of H heads of v's width holds.
    logits, cache = transformer.prefill_forward(cfg, params, prompt, P + new)
    check(torch.equal(logits, res.prefill_logits),
          "mla_serve: prefill logits differ from serve's")
    got = sum(nbytes(c["attn"]["c"], c["attn"]["kr"])
              for c in cache["layers"])
    per_token = cfg.mla_kv_rank + cfg.mla_rope_dim
    want = cfg.n_layers * B * (P + new) * per_token * 2
    kv = cfg.n_layers * B * (P + new) * 2 * cfg.n_heads * cfg.hd * 2
    print(f"mla_serve: latent cache {got} bytes ({per_token} values a "
          f"token a layer, {got / 1e9:.3f} GB) against {kv / 1e9:.3f} GB "
          f"for K/V of {cfg.n_heads} heads of {cfg.hd}", flush=True)
    check(got == want, f"mla_serve: the latent cache holds {got} bytes, "
                       f"not {want}")
    del logits, cache
    full, _ = transformer.forward(cfg, params, prompt)
    last = full[:, -1:].clone()
    del full
    err_prefill = rel_err(res.prefill_logits, last)
    full, _ = transformer.forward(cfg, params, ext)
    tail = full[:, P:].clone()
    del full
    err_dec = rel_err(teacher_forced(cfg, params, ext, P, n), tail)
    del tail, last
    torch.cuda.empty_cache()

    # Full width, 4 layers, float32: teacher-forced absorbed decode
    # against the forward.
    cfg32 = dataclasses.replace(cfg, n_layers=sh["tight_layers"],
                                dtype="float32")
    p32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(args.seed + 1), dev)
    f32, _ = transformer.forward(cfg32, p32, ext)
    err_dec32 = rel_err(teacher_forced(cfg32, p32, ext, P, n), f32[:, P:])
    del p32, f32
    print(f"mla_serve: prefill last logits vs forward {err_prefill:.3e} "
          f"(bound {LM_PREFILL_BOUND:.3e}); teacher-forced absorbed decode "
          f"({n} steps) vs forward {err_dec:.3e} (bound {LM_DECODE_BOUND}); "
          f"float32 at {cfg32.n_layers} layers, full width: decode vs "
          f"forward {err_dec32:.3e} (bound {LM_TIGHT_BOUND}); sample "
          f"{toks[0, :8].tolist()}", flush=True)
    check(err_prefill <= LM_PREFILL_BOUND, "mla_serve: prefill logits off "
                                           "the forward")
    check(err_dec <= LM_DECODE_BOUND, "mla_serve: decode off the forward")
    check(err_dec32 <= LM_TIGHT_BOUND, "mla_serve float32: decode off the "
                                       "forward")
    del params, res, ext, prompt
    torch.cuda.empty_cache()


def vision_input(params, tokens, text0, grid, generator):
    """The vision stub's input over ``tokens`` int32[B, T]: embeds [B, T,
    D], the tokens' embedding rows with ``grid`` x ``grid`` patch
    embeddings from position ``text0`` on (drawn from ``generator`` at the
    embedding's init scale, D^-0.5), and Qwen2-VL's positions int32[3, B,
    T]: the text before the patches on three equal rows, the patches at
    temporal ``text0``, height ``text0`` + row and width ``text0`` +
    column, the text after them from ``text0 + grid`` on, rows equal."""
    import torch
    b, t = tokens.shape
    n = grid * grid
    d = params.embed.shape[1]
    embeds = params.embed[tokens.long()].detach().clone()
    embeds[:, text0:text0 + n] = (torch.randn(
        (b, n, d), generator=generator, device=embeds.device) *
        d ** -0.5).to(embeds.dtype)
    idx = torch.arange(t, dtype=torch.int32, device=embeds.device)
    pos = idx.expand(3, t).clone()
    r = torch.arange(n, dtype=torch.int32, device=embeds.device)
    pos[0, text0:text0 + n] = text0
    pos[1, text0:text0 + n] = text0 + r // grid
    pos[2, text0:text0 + n] = text0 + r % grid
    pos[:, text0 + n:] = idx[text0 + n:] - n + grid
    return embeds, pos[:, None].expand(3, b, t).contiguous()


def vlm_section(args, dev, phases, rows, cfg=None, shapes=VLM_SHAPES):
    """M-RoPE and the vision stub at qwen2-vl-2b's full width and depth:
    the forward from embeds at [3, B, T] positions, text-only serving
    through ``launch/serve.py``'s ``serve``, and one microbatch's loss and
    gradients through ``train_step``'s loss (``cfg`` and ``shapes`` shrink
    it for a rehearsal on the CPU).  GQA at 12/2 heads of 128: the bf16
    flash kernels at group 6, forward and backward."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.train.train_step import TrainConfig, make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or get_arch(VLM_ARCH)
    heads = f"{cfg.n_heads}_{cfg.n_kv_heads}"
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    sync()
    print(f"vlm: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} rope {cfg.rope_kind} tied "
          f"{cfg.tie_embeddings} {cfg.dtype}: "
          f"{transformer.param_count(params)} parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({time.perf_counter() - t0:.1f} s to init on the card)",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(args.seed + 5)
    grid = sh["grid"]

    def serving_only(name, counts, stats_before):
        check(counts["flash_attention_bf16"] == cfg.n_layers and
              counts["flash_attention"] == 0 and
              counts["flash_attention_bwd"] == 0 and
              fa_ops.lse_written == stats_before,
              f"{name}: {counts} launches for {cfg.n_layers} layers, "
              f"{fa_ops.lse_written - stats_before} statistics written")

    # vlm_forward: 2 x 4096 from embeds, a patch grid at [3, B, T].
    B, T = sh["fwd_batch"], sh["fwd_seq"]
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed + 5,
                           device=dev).batch_at(0)["tokens"]
    embeds, pos3 = vision_input(params, tokens, sh["fwd_text0"], grid, g)
    stats_before = fa_ops.lse_written
    (logits, _), wall, counts, peak = phases.run(
        "vlm_forward", "vlm_forward", ("flash_attention_bf16",),
        lambda: transformer.forward(cfg, params, None, positions=pos3,
                                    embeds=embeds))
    serving_only("vlm_forward", counts, stats_before)
    check(logits.shape == (B, T, cfg.vocab) and
          bool(torch.isfinite(logits).all()),
          f"vlm_forward: logits {tuple(logits.shape)} not finite")
    plain, _ = transformer.forward(cfg, params, None, positions=pos3,
                                   embeds=embeds, use_kernel=False)
    err = rel_err(logits, plain)
    same = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    del plain, logits
    print(f"phase vlm_forward: [{B}x{T}] from embeds ({grid}x{grid} "
          f"patches at {sh['fwd_text0']}, positions [3, B, T]) wall "
          f"{wall:.3f} s {B * T / wall:.0f} tok/s launches {counts} "
          f"peak_mem {peak:.2f} GiB max|kernel - plain| / max|logit| "
          f"{err:.3e} (bound {LM_BF16_BOUND}), argmax agreement "
          f"{same:.5f}; card {card_line()}", flush=True)
    check(err <= LM_BF16_BOUND, "vlm_forward: kernel path off the plain "
                                "path")
    qkv = layer0_qkv(cfg, params, tokens, embeds, pos3)
    del tokens, embeds, pos3
    torch.cuda.empty_cache()
    rows.append(flash_row(f"forward_{heads}", "vlm_forward", *qkv, True))
    del qkv
    torch.cuda.empty_cache()

    # vlm_serve: text-only serving (M-RoPE's three equal rows).
    B, P, new, n = sh["serve_batch"], sh["prompt"], sh["new"], \
        sh["decode_steps"]
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 6,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    stats_before = fa_ops.lse_written
    res, wall, counts, peak = phases.run(
        "vlm_serve", "vlm_serve", ("flash_attention_bf16",),
        lambda: serve(cfg, params, prompt, new))
    serving_only("vlm_serve", counts, stats_before)
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()) and
          bool(torch.isfinite(res.prefill_logits).all()),
          f"vlm_serve: tokens {toks.dtype}{tuple(toks.shape)} out of range")
    print(serve_line("vlm_serve", B, P, new, res, wall, counts, peak),
          flush=True)
    full, _ = transformer.forward(cfg, params, prompt)
    err_prefill = rel_err(res.prefill_logits, full[:, -1:])
    del full
    full, _ = transformer.forward(cfg, params, ext)
    tail = full[:, P:].clone()
    del full
    err_dec = rel_err(teacher_forced(cfg, params, ext, P, n), tail)
    del tail
    # The prefill from embeds: the prompt's own rows give serve's logits
    # bit for bit; a patch grid's against the forward from those embeds
    # (both at positions 0..T-1, as the reference's prefill keeps them).
    text_rows, _ = transformer.prefill_forward(
        cfg, params, None, P + new, embeds=params.embed[prompt.long()])
    check(torch.equal(text_rows, res.prefill_logits),
          "vlm_serve: the prefill from the prompt's embedding rows differs "
          "from the prefill from its tokens")
    embeds, _ = vision_input(params, prompt, sh["text0"], grid, g)
    with_grid, _ = transformer.prefill_forward(cfg, params, None, P + new,
                                               embeds=embeds)
    full, _ = transformer.forward(cfg, params, None, embeds=embeds)
    err_embeds = rel_err(with_grid, full[:, -1:])
    del full, embeds, with_grid, text_rows
    print(f"vlm_serve: prefill last logits vs forward {err_prefill:.3e} "
          f"(bound {LM_PREFILL_BOUND:.3e}); teacher-forced decode ({n} "
          f"steps) vs forward {err_dec:.3e} (bound {LM_DECODE_BOUND}); "
          f"prefill from embeds ({grid}x{grid} patches at {sh['text0']}) vs "
          f"forward {err_embeds:.3e} (bound {LM_PREFILL_BOUND:.3e}); sample "
          f"{toks[0, :8].tolist()}", flush=True)
    check(err_prefill <= LM_PREFILL_BOUND, "vlm_serve: prefill logits off "
                                           "the forward")
    check(err_dec <= LM_DECODE_BOUND, "vlm_serve: decode off the forward")
    check(err_embeds <= LM_PREFILL_BOUND, "vlm_serve: prefill from embeds "
                                          "off the forward")
    rows.append(flash_row(f"prefill_{heads}", "vlm_serve",
                          *layer0_qkv(cfg, params, prompt), True))
    del res, ext, prompt
    torch.cuda.empty_cache()

    # vlm_grad: one microbatch from embeds at [3, B, T] positions through
    # train_step's loss; the patches' labels masked (-1).
    B, T = sh["grad_batch"], sh["grad_seq"]
    batch = TokenPipeline(cfg.vocab, T, B, seed=args.seed + 7,
                          device=dev).batch_at(0)
    embeds, pos3 = vision_input(params, batch["tokens"], sh["text0"], grid,
                                g)
    labels = batch["labels"].clone()
    labels[:, sh["text0"]:sh["text0"] + grid * grid] = -1
    mbatch = {"tokens": batch["tokens"], "labels": labels, "embeds": embeds,
              "positions": pos3}
    params.requires_grad_(True)
    loss_fn = make_loss_fn(cfg, TrainConfig())

    written = []       # forward launches that wrote the statistic, a call

    def grads():
        before = fa_ops.lse_written
        total, (loss, _) = loss_fn(params, mbatch)
        out = float(loss.detach()), leaf_grads(params, total)
        written.append(fa_ops.lse_written - before)
        return out

    (loss, gk), wall, counts, peak = phases.run(
        "vlm_grad", "vlm_grad",
        ("flash_attention_bf16", "flash_attention_bwd"), grads)
    runs = 2 if cfg.remat else 1
    check(counts["flash_attention_bf16"] == runs * cfg.n_layers and
          counts["flash_attention_bwd"] == BWD_LAUNCHES * cfg.n_layers and
          counts["flash_attention"] == 0 and
          written[-1] == runs * cfg.n_layers,
          f"vlm_grad: {counts} launches and {written[-1]} statistics "
          f"written for {cfg.n_layers} layers")
    check(math.isfinite(loss), f"vlm_grad: loss {loss}")
    del gk
    print(f"phase vlm_grad: [{B}x{T}] from embeds ({grid}x{grid} patches, "
          f"labels masked), loss and gradients, wall {wall:.3f} s "
          f"{B * T / wall:.0f} tok/s launches {counts} peak_mem {peak:.2f} "
          f"GiB loss {loss:.6f}; card {card_line()}", flush=True)
    bf16_grad_check(cfg, params, mbatch, "from embeds at [3, B, T] "
                    "positions", phase="vlm_grad")
    params.requires_grad_(False)
    q, k, v = layer0_qkv(cfg, params, batch["tokens"], embeds, pos3)
    del params, batch, embeds, pos3, labels, mbatch
    torch.cuda.empty_cache()
    rows.append(flash_bwd_row(f"train_{heads}", "vlm_grad", q, k, v, True,
                              g))
    del q, k, v
    torch.cuda.empty_cache()


def whisper_frames(cfg, b, generator, dtype):
    """The audio stub's output: standard normal frames [b, encoder_seq,
    d_model] in ``dtype`` (the reference's ``launch/serve.py`` draws its
    frames so), on ``generator``'s device."""
    import torch
    return torch.randn((b, cfg.encoder_seq, cfg.d_model),
                       generator=generator,
                       device=generator.device).to(dtype)


def cache_bytes(cache) -> tuple[int, int]:
    """(self-attention K/V bytes, cross-attention K/V bytes) of a cache."""
    self_b = sum(nbytes(c["attn"]["k"], c["attn"]["v"])
                 for c in cache["layers"])
    cross_b = sum(nbytes(*c["cross_kv"]) for c in cache["layers"])
    return self_b, cross_b


def whisper_section(args, dev, phases, rows, cfg=None, shapes=WHISPER_SHAPES):
    """The Whisper encoder-decoder at whisper-large-v3's full width and
    depth (32 encoder and 32 decoder layers, d 1280, 20/20 heads of 64):
    the encoder and the forward over a batch's frames and tokens, serving
    through ``launch/serve.py``'s ``serve`` with frames, and one
    microbatch's loss and gradients through ``train_step``'s loss with
    ``frames`` (``cfg`` and ``shapes`` shrink it for a rehearsal on the
    CPU).  The bf16 flash kernels at D = 64, forward and backward; the
    cross-attention runs ``attention_ref`` in float32, as the reference's
    does."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.models.layers import dtype_of
    from repro_torch.train.train_step import TrainConfig, make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    sh = shapes
    cfg = cfg or get_arch(WHISPER_ARCH)
    dt = dtype_of(cfg.dtype)
    layers = cfg.encoder_layers + cfg.n_layers
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    sync()
    print(f"whisper: {cfg.name} {cfg.encoder_layers} encoder and "
          f"{cfg.n_layers} decoder layers d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} frames {cfg.encoder_seq} rope "
          f"{cfg.rope_kind} {cfg.norm_kind} {cfg.dtype}: param_count "
          f"{transformer.param_count(params)}, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({time.perf_counter() - t0:.1f} s to init on the card)",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(args.seed + 8)

    def serving_only(name, counts, stats_before):
        check(counts["flash_attention_bf16"] == layers and
              counts["flash_attention"] == 0 and
              counts["flash_attention_bwd"] == 0 and
              fa_ops.lse_written == stats_before,
              f"{name}: {counts} launches for {cfg.encoder_layers} encoder "
              f"and {cfg.n_layers} decoder layers, "
              f"{fa_ops.lse_written - stats_before} statistics written")

    # whisper_forward: a batch's frames through the encoder, and its tokens
    # (Whisper's text context) through the decoder.
    B, T = sh["fwd_batch"], sh["text"]
    frames = whisper_frames(cfg, B, g, dt)
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed + 8,
                           device=dev).batch_at(0)["tokens"]

    def fwd(use_kernel=True):
        enc = transformer.encode(cfg, params, frames, use_kernel=use_kernel)
        return transformer.forward(cfg, params, tokens, enc_out=enc,
                                   use_kernel=use_kernel)[0]

    stats_before = fa_ops.lse_written
    logits, wall, counts, peak = phases.run(
        "whisper_forward", "whisper_forward", ("flash_attention_bf16",), fwd)
    serving_only("whisper_forward", counts, stats_before)
    check(logits.shape == (B, T, cfg.vocab) and
          bool(torch.isfinite(logits).all()),
          f"whisper_forward: logits {tuple(logits.shape)} not finite")
    plain = fwd(use_kernel=False)
    err = rel_err(logits, plain)
    same = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    del plain, logits
    print(f"phase whisper_forward: [{B}x{cfg.encoder_seq} frames + {B}x{T} "
          f"tokens] wall {wall:.3f} s "
          f"{B * (cfg.encoder_seq + T) / wall:.0f} positions/s launches "
          f"{counts} peak_mem {peak:.2f} GiB max|kernel - plain| / "
          f"max|logit| {err:.3e} (bound {LM_BF16_BOUND}), argmax agreement "
          f"{same:.5f}; card {card_line()}", flush=True)
    check(err <= LM_BF16_BOUND, "whisper_forward: kernel path off the plain "
                                "path")
    qkv = encoder0_qkv(cfg, params, frames)
    torch.cuda.empty_cache()
    rows.append(flash_row("encoder_d64", "whisper_forward", *qkv, False))
    # The float32 kernel at the encoder's shape: the path the reference's
    # float32 frames would take; no phase here runs it.
    rows.append(flash_row("encoder_d64", OFF_PATH, *(a.float() for a in qkv),
                          False))
    del qkv, tokens
    torch.cuda.empty_cache()

    # whisper_serve: serve with the frames; prompt + new tokens fill the
    # text context.
    P, new, n = sh["prompt"], sh["new"], sh["decode_steps"]
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 9,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    stats_before = fa_ops.lse_written
    res, wall, counts, peak = phases.run(
        "whisper_serve", "whisper_serve", ("flash_attention_bf16",),
        lambda: serve(cfg, params, prompt, new, frames=frames))
    serving_only("whisper_serve", counts, stats_before)
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()) and
          bool(torch.isfinite(res.prefill_logits).all()),
          f"whisper_serve: tokens {toks.dtype}{tuple(toks.shape)} out of "
          f"range")
    print(f"phase whisper_serve: [{B}x{cfg.encoder_seq} frames, {B}x{P} + "
          f"{new}] wall {wall:.3f} s encode {res.encode_s:.3f} s prefill "
          f"{res.prefill_s:.3f} s ({B * P / res.prefill_s:.0f} tok/s) decode "
          f"{res.decode_steps} steps {res.decode_s:.3f} s "
          f"({B * res.decode_steps / res.decode_s:.1f} tok/s) launches "
          f"{counts} peak_mem {peak:.2f} GiB; card {card_line()}",
          flush=True)
    enc = transformer.encode(cfg, params, frames)
    logits, cache = transformer.prefill_forward(cfg, params, prompt,
                                                P + new, enc_out=enc)
    self_b, cross_b = cache_bytes(cache)
    check(torch.equal(logits, res.prefill_logits),
          "whisper_serve: the prefill's logits differ from serve's")
    del cache, logits
    full, _ = transformer.forward(cfg, params, prompt, enc_out=enc)
    err_prefill = rel_err(res.prefill_logits, full[:, -1:])
    del full
    full, _ = transformer.forward(cfg, params, ext, enc_out=enc)
    tail = full[:, P:].clone()
    del full
    err_dec = rel_err(teacher_forced(cfg, params, ext, P, n, enc), tail)
    del tail, enc
    torch.cuda.empty_cache()

    # The same comparisons in float32 at full width, tight depth.
    cfg32 = dataclasses.replace(cfg, n_layers=sh["tight_layers"],
                                encoder_layers=sh["tight_layers"],
                                dtype="float32")
    p32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(args.seed + 1), dev)
    f32 = frames.float()
    before = phases.counts()
    enc32 = transformer.encode(cfg32, p32, f32)
    full32, _ = transformer.forward(cfg32, p32, ext, enc_out=enc32)
    after = phases.counts()
    check(after["flash_attention"] - before["flash_attention"] ==
          2 * sh["tight_layers"] and after["flash_attention_bf16"] ==
          before["flash_attention_bf16"],
          "whisper float32: the forward did not go through the float32 "
          "kernel alone")
    plain32, _ = transformer.forward(
        cfg32, p32, ext, use_kernel=False,
        enc_out=transformer.encode(cfg32, p32, f32, use_kernel=False))
    err32 = rel_err(full32, plain32)
    del plain32
    pre32, _ = transformer.prefill_forward(cfg32, p32, prompt, P + new,
                                           enc_out=enc32)
    err_pre32 = rel_err(pre32, full32[:, P - 1:P])
    err_dec32 = rel_err(teacher_forced(cfg32, p32, ext, P, n, enc32),
                        full32[:, P:])
    del p32, full32, enc32, pre32, f32
    torch.cuda.empty_cache()
    print(f"whisper_serve: cross-attention K/V cache {cross_b / 1e9:.3f} GB "
          f"({cfg.n_layers} layers x 2 x {B} x {cfg.n_kv_heads} x "
          f"{cfg.encoder_seq} x {cfg.hd} x 2 B) beside the self-attention "
          f"cache {self_b / 1e9:.3f} GB ({P + new} slots); prefill last "
          f"logits vs forward {err_prefill:.3e} (bound "
          f"{LM_PREFILL_BOUND:.3e}); teacher-forced decode ({n} steps) vs "
          f"forward {err_dec:.3e} (bound {LM_DECODE_BOUND}); float32 at "
          f"{cfg32.encoder_layers} + {cfg32.n_layers} layers, full width: "
          f"kernel vs plain {err32:.3e}, prefill vs forward {err_pre32:.3e}, "
          f"decode vs forward {err_dec32:.3e} (bound {LM_TIGHT_BOUND}); "
          f"sample {toks[0, :8].tolist()}", flush=True)
    check(err_prefill <= LM_PREFILL_BOUND, "whisper_serve: prefill logits "
                                           "off the forward")
    check(err_dec <= LM_DECODE_BOUND, "whisper_serve: decode off the "
                                      "forward")
    check(max(err32, err_pre32, err_dec32) <= LM_TIGHT_BOUND,
          "whisper float32: kernel, prefill or decode off the forward")
    rows.append(flash_row("prefill_d64", "whisper_serve",
                          *layer0_qkv(cfg, params, prompt), True))
    del res, ext, prompt, frames
    torch.cuda.empty_cache()

    # whisper_grad: one microbatch of frames and tokens through
    # train_step's loss.
    B = sh["grad_batch"]
    batch = TokenPipeline(cfg.vocab, T, B, seed=args.seed + 10,
                          device=dev).batch_at(0)
    mbatch = {"tokens": batch["tokens"], "labels": batch["labels"],
              "frames": whisper_frames(cfg, B, g, dt)}
    params.requires_grad_(True)
    loss_fn = make_loss_fn(cfg, TrainConfig())
    written = []       # forward launches that wrote the statistic, a call

    def grads():
        before = fa_ops.lse_written
        total, (loss, _) = loss_fn(params, mbatch)
        out = float(loss.detach()), leaf_grads(params, total)
        written.append(fa_ops.lse_written - before)
        return out

    (loss, gk), wall, counts, peak = phases.run(
        "whisper_grad", "whisper_grad",
        ("flash_attention_bf16", "flash_attention_bwd"), grads)
    # The decoder recomputes each block in the backward (remat); the
    # encoder, as the reference's, keeps its activations.
    fwd_launches = cfg.encoder_layers + (2 if cfg.remat else 1) * \
        cfg.n_layers
    check(counts["flash_attention_bf16"] == fwd_launches and
          counts["flash_attention_bwd"] == BWD_LAUNCHES * layers and
          counts["flash_attention"] == 0 and written[-1] == fwd_launches,
          f"whisper_grad: {counts} launches and {written[-1]} statistics "
          f"written for {cfg.encoder_layers} + {cfg.n_layers} layers")
    check(math.isfinite(loss), f"whisper_grad: loss {loss}")
    del gk
    print(f"phase whisper_grad: [{B}x{cfg.encoder_seq} frames + {B}x{T} "
          f"tokens] loss and gradients, wall {wall:.3f} s "
          f"{B * (cfg.encoder_seq + T) / wall:.0f} positions/s launches "
          f"{counts} (bf16 forward {counts['flash_attention_bf16']}, "
          f"backward {counts['flash_attention_bwd']}) peak_mem {peak:.2f} "
          f"GiB loss {loss:.6f}; card {card_line()}", flush=True)
    bf16_grad_check(cfg, params, mbatch, "from frames",
                    phase="whisper_grad")
    params.requires_grad_(False)
    q, k, v = encoder0_qkv(cfg, params, mbatch["frames"])
    del params, batch, mbatch
    torch.cuda.empty_cache()
    rows.append(flash_bwd_row("encoder_d64", "whisper_grad", q, k, v, False,
                              g))
    del q, k, v
    torch.cuda.empty_cache()


def state_bytes(cfg, batch, slots) -> int:
    """The bytes of a recurrent model's serving cache by formula: per
    ``"rec"`` layer h [B, R] and conv [B, W - 1, R] in float32; per
    ``"mlstm"`` layer C [B, H, hd, hd], n [B, H, hd] and m [B, H] in float32;
    per ``"slstm"`` layer c, n, h, m [B, H, hd] in float32; per
    ``"attn_local"`` layer a ring of ``slots`` = min(window, max_len): k and
    v [B, H_kv, slots, hd] in the config dtype and pos int32 [B, slots]."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import dtype_of
    r, w, h, hd = cfg.rnn_dim, cfg.conv_width, cfg.n_heads, cfg.hd
    itemsize = dtype_of(cfg.dtype).itemsize
    per = {"rec": 4 * batch * r * w,
           "mlstm": 4 * batch * h * (hd * hd + hd + 1),
           "slstm": 4 * batch * h * hd * 4,
           "attn_local": (2 * batch * cfg.n_kv_heads * slots * hd * itemsize
                          + 4 * batch * slots)}
    return sum(per[k] for k in transformer.layer_kinds(cfg))


def layer0_cell_input(cfg, params, tokens):
    """Layer 0's cell input on ``tokens``, as the forward gives it: the
    embedding rows (plus the sinusoid for ``rope_kind="none"``) through
    ``ln1``, in the model's dtype."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers import apply_norm
    b, t = tokens.shape
    pos = torch.arange(t, dtype=torch.int32, device=tokens.device).expand(
        b, t)
    x = transformer._add_positions(cfg, params.embed[tokens.long()], pos)
    return apply_norm(cfg.norm_kind, params.layers[0].ln1, x)


def rglru_scan_check(cfg, params, prompt) -> None:
    """rglru_scan: layer 0's (a, b) on the serve prompt at full width, the
    log-depth scan against the sequential float64 recurrence
    (RGLRU_SCAN_BOUND)."""
    import torch
    from repro_torch.models import rglru
    from repro_torch.models.layers import mm, widen
    cell = params.layers[0].cell
    x = layer0_cell_input(cfg, params, prompt)
    u = rglru._causal_conv(widen(mm(x, cell.w_in)), cell.conv_w)
    a, b = rglru._gates(cell, u)
    del x, u
    _, h32 = rglru.associative_scan(a, b)
    a64, b64 = a.double(), b.double()
    del a, b
    t = b64.shape[1]
    adds = 2 * math.ceil(math.log2(t))
    h64, bound64 = torch.empty_like(b64), torch.empty_like(b64)
    hh = torch.zeros_like(b64[:, 0])
    mag, lag = torch.zeros_like(hh), torch.zeros_like(hh)
    for i in range(t):
        ai = a64[:, i]
        hh = ai * hh + b64[:, i]
        lag = ai * (lag + mag)          # sum_s (t - s) P_st |b_s|
        mag = ai * mag + b64[:, i].abs()  # sum_s P_st |b_s|
        h64[:, i] = hh
        bound64[:, i] = 2.0 ** -24 * (lag + adds * mag)
    diff = (h32.double() - h64).abs()
    hmax = float(h64.abs().max())
    err = float(diff.max()) / hmax
    derived = bool((diff <= 1.001 * bound64 + 1e-300).all())
    print(f"rglru_scan: layer 0, [{b64.shape[0]}x{t}x{b64.shape[2]}] a in "
          f"[{float(a64.min()):.3e}, {float(a64.max()):.3e}]: log-depth scan "
          f"(float32, {math.ceil(math.log2(t))} levels) vs sequential "
          f"float64 {err:.3e} of max|h| (bound {RGLRU_SCAN_BOUND}); the "
          f"rounding bound u (lag + {adds} adds) sum|terms| reaches "
          f"{float(bound64.max()) / hmax:.3e} of max|h| and holds "
          f"everywhere: {derived}", flush=True)
    check(err <= RGLRU_SCAN_BOUND and derived,
          f"rglru_scan: the scan is off the float64 recurrence by {err:.3e}")


def mlstm_chunk_check(cfg, params, tokens) -> None:
    """mlstm_chunks: layer 0's cell on ``tokens`` [B, T], the chunked
    forward in float32 against T steps of mlstm_decode in float64
    (MLSTM_CHUNK_BOUND, relative L2)."""
    import copy
    import torch
    from repro_torch.models import ssm
    cell = params.layers[0].cell
    x = layer0_cell_input(cfg, params, tokens)
    y32 = ssm.mlstm_forward(cfg, copy.deepcopy(cell).float(), x.float())
    cell64 = copy.deepcopy(cell).double()
    x64 = x.double()
    state = {k: v.double() for k, v in ssm.init_mlstm_state(
        cfg, x.shape[0], x.device).items()}
    ys = []
    for i in range(x.shape[1]):
        y, state = ssm.mlstm_decode(cfg, cell64, x64[:, i:i + 1], state)
        ys.append(y)
    y64 = torch.cat(ys, dim=1)
    err = float(torch.linalg.vector_norm(y32.double() - y64)
                / torch.linalg.vector_norm(y64))
    print(f"mlstm_chunks: layer 0, [{x.shape[0]}x{x.shape[1]}], chunk "
          f"{cfg.mlstm_chunk}: chunked forward (float32) vs {x.shape[1]} "
          f"float64 decode steps, relative L2 {err:.3e} (bound "
          f"{MLSTM_CHUNK_BOUND})", flush=True)
    check(err <= MLSTM_CHUNK_BOUND, f"mlstm_chunks: the chunked forward is "
                                    f"off the recurrence by {err:.3e}")


def slstm_loops(cfg, params, prompt) -> float:
    """Seconds that the sLSTM layers' time loops take alone: each sLSTM
    layer's cell run on layer 0's cell input for ``prompt`` (the loop's
    cost does not depend on the values), between device syncs."""
    from repro_torch.models import ssm, transformer
    x = layer0_cell_input(cfg, params, prompt)
    sync()
    t0 = time.perf_counter()
    for kind, block in zip(transformer.layer_kinds(cfg), params.layers):
        if kind == "slstm":
            ssm.slstm_forward(cfg, block.cell, x)
    sync()
    return time.perf_counter() - t0


def recurrent_model(args, dev, phases, cfg, sh, label) -> None:
    """One recurrent model at full width and depth: ``{label}_forward``,
    ``{label}_serve`` (through ``launch/serve.py``'s ``serve``) and their
    checks; no kernel launches."""
    import copy
    import dataclasses
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    sync()
    kinds = transformer.layer_kinds(cfg)
    counted = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
    print(f"{label}: {cfg.name} {cfg.n_layers} layers ({counted}; unit "
          f"{cfg.unit} x {cfg.n_units}, tail {cfg.tail}) "
          f"d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} "
          f"rnn {cfg.rnn_dim} conv {cfg.conv_width} window {cfg.window} "
          f"chunk {cfg.mlstm_chunk} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"rope {cfg.rope_kind} {cfg.norm_kind} {cfg.dtype}: "
          f"{transformer.param_count(params)} parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({time.perf_counter() - t0:.1f} s to init on the card)",
          flush=True)

    def no_kernel(name, counts):
        check(not any(counts.values()),
              f"{name}: launched {counts}; the recurrent kinds and the "
              f"local window run no kernel")

    B, T = sh["fwd_batch"], sh["fwd_seq"]
    tokens = TokenPipeline(cfg.vocab, T, B, seed=args.seed + 11,
                           device=dev).batch_at(0)["tokens"]
    name = f"{label}_forward"
    # The sLSTM loops are bound by the host: a warm-up call would only
    # double xlstm's time.
    warm = "slstm" not in kinds
    logits, wall, counts, peak = phases.run(
        name, name, (), lambda: transformer.forward(cfg, params, tokens)[0],
        warm_up=warm)
    no_kernel(name, counts)
    check(logits.shape == (B, T, cfg.vocab) and
          bool(torch.isfinite(logits).all()),
          f"{name}: logits {tuple(logits.shape)} not finite")
    print(f"phase {name}: [{B}x{T}] wall {wall:.3f} s {B * T / wall:.0f} "
          f"tok/s launches {counts} peak_mem {peak:.2f} GiB; card "
          f"{card_line()}", flush=True)
    del logits, tokens
    torch.cuda.empty_cache()

    B, P, new, n = sh["serve_batch"], sh["prompt"], sh["new"], \
        sh["decode_steps"]
    ext = TokenPipeline(cfg.vocab, P + n, B, seed=args.seed + 12,
                        device=dev).batch_at(0)["tokens"]
    prompt = ext[:, :P].contiguous()
    name = f"{label}_serve"
    res, wall, counts, peak = phases.run(
        name, name, (), lambda: serve(cfg, params, prompt, new),
        warm_up=warm)
    no_kernel(name, counts)
    toks = res.tokens
    check(toks.shape == (B, new) and toks.dtype == torch.int32 and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()) and
          bool(torch.isfinite(res.prefill_logits).all()),
          f"{name}: tokens {toks.dtype}{tuple(toks.shape)} out of range")
    print(serve_line(name, B, P, new, res, wall, counts, peak), flush=True)
    # One more prefill: serve's logits, the state's bytes against the
    # formula beside a full K/V cache's, and the cache the teacher-forced
    # decode below starts from.
    sync()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill_forward(cfg, params, prompt, P + new)
    sync()
    pre_wall = time.perf_counter() - t0
    check(torch.equal(logits, res.prefill_logits),
          f"{name}: prefill logits differ from serve's")
    if "slstm" in kinds:
        spent = slstm_loops(cfg, params, prompt)
        print(f"{name}: the sLSTM time loops ({kinds.count('slstm')} layers "
              f"x {P} steps) take {spent:.3f} s alone (each layer's cell on "
              f"layer 0's input), beside a {pre_wall:.3f} s prefill "
              f"({spent / pre_wall:.1%})", flush=True)
    got = sum(nbytes(*leaves.values()) for c in cache["layers"]
              for leaves in c.values())
    slots = min(cfg.window, P + new) if cfg.window else P + new
    want = state_bytes(cfg, B, slots)
    kv = cfg.n_layers * B * (P + new) * 2 * cfg.n_kv_heads * cfg.hd * 2
    ring = f"; a ring of {slots} slots" if "attn_local" in kinds else ""
    print(f"{name}: cache {got} bytes ({got / 1e9:.4f} GB: "
          f"{', '.join(sorted(set(kinds)))}{ring}) against "
          f"{kv / 1e9:.3f} GB for a full K/V cache of {P + new} positions "
          f"in {cfg.n_layers} layers of {cfg.n_kv_heads} KV heads of "
          f"{cfg.hd}", flush=True)
    check(got == want, f"{name}: the cache holds {got} bytes, not {want}")
    dec = decode_steps(cfg, params, cache, ext, P, n)
    del logits, cache
    torch.cuda.empty_cache()
    if "rec" in kinds:
        rglru_scan_check(cfg, params, prompt)
    if "mlstm" in kinds:
        mlstm_chunk_check(cfg, params,
                          ext[:sh["mlstm_batch"], :sh["mlstm_seq"]])
    torch.cuda.empty_cache()

    full, _ = transformer.forward(cfg, params, prompt)
    last = full[:, -1:].clone()
    del full
    err_prefill = rel_err(res.prefill_logits, last)
    full, _ = transformer.forward(cfg, params, ext)
    tail = full[:, P:].clone()
    del full
    err_dec = rel_err(dec, tail)
    # Decode's and the bf16 forward's distances from the same weights
    # evaluated in float32 (RECURRENT_DECODE_FACTOR).
    cfg_up = dataclasses.replace(cfg, dtype="float32")
    full, _ = transformer.forward(cfg_up, copy.deepcopy(params).float(), ext)
    fwd32 = rel_err(tail, full[:, P:])
    dec32 = rel_err(dec, full[:, P:])
    held = cfg.name in RECURRENT_DECODE_HELD
    del full, tail, last, params, dec
    torch.cuda.empty_cache()

    # Full width, float32, tight depth, a prompt of tight_prompt tokens.
    cfg32 = dataclasses.replace(cfg, n_layers=RECURRENT_TIGHT_LAYERS[cfg.name],
                                dtype="float32")
    p32 = transformer.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(args.seed + 1), dev)
    P32 = sh["tight_prompt"]
    ext32 = ext[:, :P32 + n].contiguous()
    before = phases.counts()
    f32, _ = transformer.forward(cfg32, p32, ext32)
    pre32, cache32 = transformer.prefill_forward(
        cfg32, p32, ext32[:, :P32].contiguous(), P32 + n)
    err_pre32 = rel_err(pre32, f32[:, P32 - 1:P32])
    err_dec32 = rel_err(decode_steps(cfg32, p32, cache32, ext32, P32, n),
                        f32[:, P32:])
    check(phases.counts() == before, f"{name} float32: a kernel launched")
    del p32, f32, pre32, cache32
    torch.cuda.empty_cache()
    print(f"{name}: prefill last logits vs forward {err_prefill:.3e} (bound "
          f"{LM_PREFILL_BOUND:.3e}); teacher-forced decode ({n} steps) vs "
          f"forward {err_dec:.3e} (bound "
          f"{LM_DECODE_BOUND if held else 'none: see RECURRENT_DECODE_HELD'}"
          f"); vs the float32 evaluation: decode {dec32:.3e}, the bf16 "
          f"forward {fwd32:.3e} (decode's bound {RECURRENT_DECODE_FACTOR} x "
          f"the forward's = {RECURRENT_DECODE_FACTOR * fwd32:.3e}); "
          f"float32 at "
          f"{cfg32.n_layers} layers "
          f"({', '.join(transformer.layer_kinds(cfg32))}), full width, "
          f"prompt {P32}: prefill vs forward {err_pre32:.3e}, "
          f"decode vs forward {err_dec32:.3e} (bound {LM_TIGHT_BOUND}); "
          f"sample {toks[0, :8].tolist()}", flush=True)
    check(err_prefill <= LM_PREFILL_BOUND, f"{name}: prefill logits off the "
                                           f"forward")
    check(not held or err_dec <= LM_DECODE_BOUND,
          f"{name}: decode off the forward")
    check(dec32 <= RECURRENT_DECODE_FACTOR * fwd32,
          f"{name}: decode farther from the float32 evaluation than the "
          f"bf16 forward allows")
    check(max(err_pre32, err_dec32) <= LM_TIGHT_BOUND,
          f"{name} float32: prefill or decode off the forward")
    del res, ext, prompt
    torch.cuda.empty_cache()


def recurrent_section(args, dev, phases, rows, cfgs=None,
                      shapes=RECURRENT_SHAPES):
    """The recurrent block kinds at full width and depth, served through
    ``launch/serve.py``'s ``serve``: recurrentgemma-2b (RG-LRU and local
    attention, 26 layers with a ("rec", "rec") tail) and xlstm-350m
    (mLSTM and sLSTM, 24 layers).  No kernel: the recurrences are plain
    torch in both packages, and the local window takes the window paths
    at a head dim of 256, which no flash kernel takes (``cfgs``, a pair of
    configs, and ``shapes`` shrink it for a rehearsal on the CPU)."""
    import torch
    from repro_torch.configs import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    rg, xl = cfgs or (get_arch(RECGEMMA_ARCH), get_arch(XLSTM_ARCH))
    recurrent_model(args, dev, phases, rg, shapes, "recgemma")
    torch.cuda.empty_cache()
    recurrent_model(args, dev, phases, xl, shapes, "xlstm")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The dry run (launch/dryrun.py).
# ---------------------------------------------------------------------------

# dryrun_cells: production cells traced at 16 x 16 on fake CUDA tensors, each
# by the CLI in a process of its own (all started together).
DRYRUN_CELLS = (("olmo-1b", "train_4k", 0), ("llama3-8b", "decode_32k", 2),
                ("mixtral-8x22b", "prefill_32k", 3),
                ("whisper-large-v3", "train_4k", 0),
                ("xlstm-350m", "decode_32k", 0),
                ("olmo-1b", "train_4k", 0, "16x1"))
# olmo-1b train_4k's useful ratio at 16 x 16, heads, d_ff and vocab split
# over "model": its 16 x 1 value (0.7723 on the card's program) less the 2 %
# the cells may part by.
TP_USEFUL_MIN = 0.75
DRYRUN_TIMEOUT = 300        # seconds a cell's process may take


def dryrun_check(args, dev, phases, cfg=None, sh=TRAIN_SHAPES):
    """dryrun_check: one ``make_train_step`` step of olmo-1b at lm_train's
    shapes on a (1, 1) mesh, traced by the dry run on fake tensors in a
    fake world of one rank, then run for real on the card over a one-rank
    group (``one_rank_mesh``), both under the dry run's counting mode
    (``dryrun.trace``) on the same program (state stored by
    ``shard_train_state``, batch by ``batch_spec``).  Held exactly: FLOPs,
    bytes accessed, collective bytes and argument bytes equal; the flash
    kernels launched by the real step only.  Printed: the predicted peak
    (arguments + temp) beside ``max_memory_allocated``, and the model-FLOP
    share of an uncounted step."""
    import torch
    from repro_torch.configs import Shape, get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import dryrun
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step,
                                              shard_train_state)
    cfg = cfg or get_arch(TRAIN_ARCH)
    T, B, mb = sh["seq"], sh["batch"], sh["microbatches"]
    flash = ("flash_attention", "flash_attention_bf16", "flash_attention_bwd")

    def launched(before):
        now = phases.counts()
        return {k: now[k] - before[k] for k in flash}

    before = phases.counts()
    t0 = time.perf_counter()
    with dryrun.fake_world((1, 1), ("data", "model"), dev.type) as (mesh, _):
        cell = dryrun.build_cell(cfg, Shape("dryrun_check", T, B, "train"),
                                 mesh, 0, dev.type, microbatches=mb)
        fake = dryrun.trace(cell.fn, cell.args)
        del cell, fake["out"]
    fake_wall = time.perf_counter() - t0
    fake_launches = launched(before)

    tcfg = TrainConfig(microbatches=mb)
    with one_rank_mesh(dev) as mesh:
        state = shard_train_state(init_train_state(
            cfg, tcfg, torch.Generator(device=dev).manual_seed(args.seed),
            dev), mesh)
        data = TokenPipeline(cfg.vocab, T, B, seed=args.seed,
                             device=dev).batch_at(0)
        batch = dryrun.store_batch({k: data[k] for k in ("tokens",
                                                         "labels")}, mesh)
        step = make_train_step(cfg, tcfg)
        sync()
        torch.cuda.reset_peak_memory_stats()
        before = phases.counts()
        t0 = time.perf_counter()
        real = dryrun.trace(step, (state, batch))
        sync()
        counted_wall = time.perf_counter() - t0
        real_launches = launched(before)
        peak = torch.cuda.max_memory_allocated()
        loss = float(real.pop("out")[1]["loss"])
        t0 = time.perf_counter()
        step(state, batch)
        sync()
        wall = time.perf_counter() - t0
        del state, batch, data, step
    torch.cuda.empty_cache()

    print(f"phase dryrun_check: {cfg.name} {T}x{B} in {mb} microbatches on "
          f"(1, 1): trace {fake_wall:.2f} s, counted real step "
          f"{counted_wall:.2f} s (loss {loss:.4f}), uncounted step "
          f"{wall:.3f} s; card {card_line()}", flush=True)
    for key in ("flops", "bytes_accessed"):
        print(f"  {key}: dry run {fake[key]:.6e} real {real[key]:.6e}")
    print(f"  collective bytes: dry run {fake['collective_bytes']} real "
          f"{real['collective_bytes']}")
    print(f"  memory: dry run {fake['memory']} real {real['memory']}")
    predicted = (fake["memory"]["argument_size_in_bytes"]
                 + fake["memory"]["temp_size_in_bytes"])
    print(f"  peak: predicted (arguments + temp) {predicted / 2 ** 30:.3f} "
          f"GiB, max_memory_allocated {peak / 2 ** 30:.3f} GiB, ratio "
          f"{peak / predicted:.4f}")
    print(f"  flash launches: dry run {fake_launches}, real step "
          f"{real_launches}")
    print(f"  model-FLOP share of the uncounted step: "
          f"{flop_share(cfg, 'train', B, T, wall)}; counted FLOPs over its "
          f"wall: {real['flops'] / wall / 1e12:.1f} TFLOP/s", flush=True)
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        check(fake[key] == real[key], f"dryrun_check: {key} of the dry run "
                                      f"{fake[key]} is not the real step's "
                                      f"{real[key]}")
    check(fake["memory"]["argument_size_in_bytes"] ==
          real["memory"]["argument_size_in_bytes"],
          "dryrun_check: argument bytes differ")
    check(fake["collective_bytes"]["total"] == 0,
          "dryrun_check: collectives on axes of size 1")
    check(not any(fake_launches.values()),
          f"dryrun_check: the trace launched kernels {fake_launches}")
    check(real_launches["flash_attention_bf16"] > 0 and
          real_launches["flash_attention_bwd"] > 0,
          f"dryrun_check: the real step launched {real_launches}")
    check(math.isfinite(loss), "dryrun_check: the loss is not finite")


def dryrun_cells(dev, cells=DRYRUN_CELLS):
    """dryrun_cells: ``python -m repro_torch.launch.dryrun`` on each cell at
    16 x 16, or the mesh a cell names (``--device cuda``: fake CUDA
    tensors, attention through the flash ops' fakes), each in a process of
    its own, all started together; each record, its tensor-parallel plan,
    its collective bytes by kind, its roofline row on this card's
    constants and its trace seconds printed; each must exit 0 with its
    mesh's devices and FLOPs > 0; olmo-1b train_4k's useful ratio at 16 x
    16 within 2 % of 16 x 1's and at least TP_USEFUL_MIN.  On the CPU (a
    rehearsal) the cells trace the CPU's program and read the H100 SXM5's
    constants."""
    import os
    import torch
    from repro_torch.launch import roofline
    chip = roofline.chip_constants(torch.cuda.get_device_name(0)
                                   if dev.type == "cuda" else "h100-sxm5")
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t_all = time.perf_counter()
    procs, useful = [], {}
    try:
        for arch, shape, level, *mesh in cells:
            mesh = mesh[0] if mesh else "16x16"
            out = out_dir / f"{arch}_{shape}_{level}_{mesh}.json"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--opt-level",
                   str(level), "--device", dev.type, "--mesh", mesh,
                   "--out", str(out)]
            procs.append(((arch, shape, level, mesh), subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for (arch, shape, level, mesh), p in procs:
            left = DRYRUN_TIMEOUT - (time.perf_counter() - t_all)
            try:
                out, err = p.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                check(False, f"dryrun_cells: {arch} {shape} took more than "
                             f"{DRYRUN_TIMEOUT} s")
            check(p.returncode == 0, f"dryrun_cells: {arch} {shape} level "
                                     f"{level} exited {p.returncode}: "
                                     f"{err[-1500:]}")
            rec = json.loads(out.splitlines()[-1])
            check(rec["devices"] == math.prod(map(int, mesh.split("x")))
                  and rec["flops"] > 0,
                  f"dryrun_cells: {arch} {shape}: {rec}")
            r = roofline.analyse(rec, chip)
            useful[arch, shape, mesh] = r["useful_ratio"]
            print(f"phase dryrun_cells: {arch} {shape} level {level} on "
                  f"{mesh}: trace {rec['main_compile_s']} s (process "
                  f"{rec['compile_s']} s in the cell); record "
                  f"{json.dumps(rec)}")
            print(f"  tensor-parallel plan {rec['tp']}; collective bytes "
                  f"by kind {rec['collective_bytes']}")
            print(f"  roofline on {chip.name} ({card_line()}): compute "
                  f"{r['compute_s']:.6f} s, memory {r['memory_s']:.6f} s, "
                  f"collective {r['collective_s']:.6f} s, dominant "
                  f"{r['dominant']}, model/counted FLOPs "
                  f"{r['useful_ratio']:.4f}, roofline MFU "
                  f"{r['roofline_mfu']:.4f}", flush=True)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    print(f"dryrun_cells: {len(cells)} cells in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    split, one = (useful.get(("olmo-1b", "train_4k", m)) for m in
                  ("16x16", "16x1"))
    if split is not None and one is not None:
        print(f"dryrun_cells: olmo-1b train_4k useful ratio {split:.4f} at "
              f"16 x 16, {one:.4f} at 16 x 1", flush=True)
        check(abs(split - one) <= 0.02 * one and split >= TP_USEFUL_MIN,
              f"dryrun_cells: olmo-1b train_4k's useful ratio {split:.4f} "
              f"at 16 x 16 against {one:.4f} at 16 x 1 (at least "
              f"{TP_USEFUL_MIN})")


def dryrun_section(args, dev, phases, rows, cfg=None, shapes=TRAIN_SHAPES,
                   cells=DRYRUN_CELLS):
    """The dry run against the card (``dryrun_check``) and on production
    cells (``dryrun_cells``)."""
    dryrun_check(args, dev, phases, cfg, shapes)
    dryrun_cells(dev, cells)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3_300_000,
                    help="vertices (default: the paper's DBPedia 3.3 M)")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--points", type=int, default=382_000_000,
                    help="k-means points (default: the paper's 382 M)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_route import ops as dr_ops
    from repro_torch.kernels.delta_scatter import ops as ds_ops
    from repro_torch.kernels.edge_propagate import ops as ep_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.kernels.scatter_route import ops as sr_ops

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)

    dev = torch.device("cuda")
    phases = Phases({name: (mod, "launches") for name, mod in (
        ("scatter_route", sr_ops), ("delta_route", dr_ops),
        ("delta_scatter", ds_ops), ("edge_propagate", ep_ops),
        ("kmeans_assign", ka_ops), ("flash_attention", fa_ops))})
    phases.counters["flash_attention_bf16"] = (fa_ops, "launches_bf16")
    phases.counters["flash_attention_bwd"] = (fa_ops, "launches_bwd")
    rows: list = []
    for section in (graph_section, kmeans_section, kmeans_view_section,
                    lm_section, tp_section, train_section,
                    moe_train_section,
                    moe_section, moe_window_section, mla_section,
                    vlm_section, whisper_section, recurrent_section,
                    dryrun_section):
        t0 = time.perf_counter()
        section(args, dev, phases, rows)
        torch.cuda.empty_cache()
        print(f"section {section.__name__}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print_rows(rows)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [dict(
        name=row_name(r), route="cuda",
        source=r["source"] or KERNELS[r["name"]][0],
        replaces=KERNELS[r["name"]][1],
        launches=phases.of(r["name"], r["combiner"]),
        max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"]) for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
