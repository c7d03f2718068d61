#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``ray_tpu_torch``) end to end on one CUDA
card and check it.

    python3 chip_smoke.py              # phases 1-22, the smoke
    python3 chip_smoke.py --spec-ab    # phases 1-2, then speculation off
                                       # against on (bf16), no result line
    python3 chip_smoke.py --flash [DIR]     # phases 1-2, the flash kernels
                                            # and phase 8, no result line
    python3 chip_smoke.py --flash-ab DIR    # --flash on the checkout at DIR
                                            # and on this one, in turns
    python3 chip_smoke.py --decode [DIR]    # phases 1-2, the decode and
                                            # RoPE kernels, no result line
    python3 chip_smoke.py --decode-ab DIR   # --decode for DIR and this one
    python3 chip_smoke.py --engine [DIR]    # phases 1-2, then phase 5
                                            # three times, no result line
    python3 chip_smoke.py --engine-ab DIR   # --engine for DIR and this one
    python3 chip_smoke.py --rllib           # phases 1 and 11 (11d on a
                                            # cluster of its own), no
                                            # result line
    python3 chip_smoke.py --serve           # phases 1-2 and 12, no result
                                            # line
    python3 chip_smoke.py --cluster         # phases 1-2, 13 (with 18)
                                            # and 14, no result line
    python3 chip_smoke.py --disagg          # phases 1-2 and 14, no result
                                            # line
    python3 chip_smoke.py --train           # phases 1-2, 8 and 15, no
                                            # result line
    python3 chip_smoke.py --parallel        # phases 1-2, 8 and 16, no
                                            # result line
    python3 chip_smoke.py --data            # phases 1-2 and 17, no result
                                            # line
    python3 chip_smoke.py --tune            # phases 1-2 and 19, no result
                                            # line
    python3 chip_smoke.py --witness         # phases 1-2 and 22, no
                                            # result line
    python3 chip_smoke.py --client          # phases 1-2, 20 and 21 (on
                                            # a cluster of their own), no
                                            # result line

``--flash`` runs against the package of the checkout at DIR (default:
this one): the flash kernels against their plain versions at phase 3's
flash shapes, their times at phase 8's shape (phase 6's L2-flushed
medians and 20 back-to-back calls with L2 warm, SDPA's beside them), the
backward's device time by kernel, then phase 8. ``--flash-ab DIR`` runs
it for DIR, this checkout, this checkout and DIR, one process each, so
two versions of the kernels are compared on one card in one call.
``--decode [DIR]`` and ``--decode-ab DIR`` do the same for the decode
kernels (contiguous and paged) and RoPE: their checks at phase 3's shapes,
the launch floor, and their times at the shapes of ``decode_rope_times``.
``--engine [DIR]`` and ``--engine-ab DIR`` do it for phase 5's serving
engine, three runs an arm: its launches, dispatches and prefix hits, to
hold a runtime change's launch counts to its parent's.

Phases, in the order ``main()`` runs them; any failure raises and the
script exits non-zero without printing its last line:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: compile every kernel from ``ray_tpu_torch/csrc`` with nvcc; for
   every kernel instantiation, by name and template arguments, ptxas'
   registers and spills and (decode, flash) the dynamic shared memory of
   its launch.
3. Kernels against their plain PyTorch versions on the card, at the
   slice's shapes, in bf16 and f32 (tolerances below); the paged decode
   kernel also bit-equal to the contiguous one through the identity
   table, through a scattered table, over NaN-poisoned tails; the flash
   attention forward and backward at the training shape, at S=384, and
   at ragged S with B > 1.
4. Model: a 2-layer model at Llama-3-8B widths in f32, prefill + 8
   decode steps through the kernels, against the same model on the plain
   versions; then in f32 and bf16 with ``paged_decode=True``, logits
   bit-equal to the contiguous decode kernel's; then the loss and every
   gradient through the flash and fused kernels under remat against the
   plain route.
5. Engine: ``LLMEngine`` on full-depth Llama-3-8B in bf16 (random weights
   from a seed), 16 requests from 8 client threads; checks every request's
   token count, prefix-cache hits, and that every kernel of its path was
   launched; a profiled decode chunk shows one decode launch a layer and
   step and no merge kernel.
7. Engines with the slice-2 knobs, full-depth Llama-3-8B bf16: (a) phase
   5's configuration and traffic with ``paged_decode=True`` — the paged
   kernel runs, the contiguous one does not; (b) paged decode,
   speculation, chunked prefill and int8 weights all on, with repetitive,
   long and short prompts — speculation and chunked prefill both run.
9. The engine tier, Llama-3-8B (9a and 9b at its widths cut to 8 of its
   32 layers, ``SERVE_LAYERS``; 9c at full depth): (a) bf16, one params tree
   shared by every engine: a prefill-role and a decode-role engine take
   phase 5's warm-up and 16 prompts one at a time through
   ``prefill_remote`` -> ``install_remote``, greedy tokens identical to a
   colocated engine's, the chain hashes checked, the prefill side
   launching no decode kernel and the decode side one a layer and step,
   one ``kv_export`` sync a handoff; the handoff's pages, bytes and
   milliseconds (client-side, and export / host / install re-run at each
   request's page count); the 16 requests again from 8 threads (token
   counts); the sequential pass again with ``paged_decode=True`` on both
   sides. (b) bf16: two fleet engines sharing a ``LocalKVPageStore``, the
   first spilling evicted prefix blocks, the second pulling them, tokens
   identical to a fleet-off engine's that reuses the same prefix from its
   own cache; spilled and pulled blocks, no rejects, pull ms a page. (c)
   f32: a one-slot engine where a priority-1 arrival parks a long
   priority-0 request; both finish with their solo runs' tokens.
12. The serve deployment, Llama-3-8B bf16 cut to ``SERVE_LAYERS``, one
    params tree
    from a seed passed by reference to every engine:
    ``ray_tpu_torch.init(local_mode=True)`` -> ``serve.run(
    build_llm_deployment(use_gpu=True, engine_kwargs=...))`` ->
    ``handle.remote({"prompt_ids": ...})`` -> router -> replica actor ->
    ``LLMServer`` -> ``LLMEngine``, phase 5's engine configuration. First a
    direct ``LLMEngine`` takes phase 5's warm-up and 16 prompts one at a
    time (the tokens and ms each later pass is held to), then the 16 from
    8 threads, streamed; then two direct engines in this one process take
    the 16, alternating (two replicas without serve). (a) One replica: the
    same sequence through the handle, tokens identical, the ms each
    request adds against the direct engine and an echo deployment's round
    trip (the hop alone); the closed loop. Two replicas: the sequence,
    then three fresh prompts each sent
    as reply, stream, reply (the stream equal to the second reply), then
    four prompts sharing a 48-token prefix (the three after the first
    report ``cached_prefix_len`` >= 48); which replica served each
    request is read off the replicas' own ``stats()``, and every reply is
    held to a direct engine fed that replica's requests in order; the
    closed loop, both replicas serving. The decode kernel and the four
    fused kernels launch, the paged and flash kernels do not. (b) One
    replica with ``paged_decode=True``: the sequence's tokens identical
    to the direct engine's; the paged kernel launches, the contiguous one
    does not. Requests/s, tokens/s, TTFT and TPOT (client-side, streamed)
    and the process's CPU cores through the handle, one replica against
    two, beside the direct engines'.
13. The cluster runtime, after phase 12: ``ray_tpu_torch.init()`` (a head,
    a node manager, worker processes over the port's shm object store,
    whose library phase 2 builds with g++ beside the kernels). (a) The
    card counted as ``GPU`` 1.0; a GPU task sees it, a CPU task's
    ``resolve_device(None)`` raises; a CUDA bf16 tensor bit-equal through
    put/get and a GPU task's argument and return. (b) One replica in a
    worker process, ``build_llm_deployment(use_gpu=True, engine_kwargs=
    dict(ENGINE_KW, cfg=...))`` (the replica draws the weights from the
    seed on its card; the class swapped for ``counting_server()``'s
    subclass of ``LLMServer``, which reads the replica process's kernel
    counters): phase 5's warm-up and 16 prompts one at a time, tokens
    identical to a direct engine here fed the same sequence (the first of
    its two passes; phase 14 holds to both); the closed loop; an echo
    deployment's round trip across processes. (c) Two
    replicas of ``{"GPU": 0.5}`` in two worker processes on the one card:
    both hold the tree (their own ``memory_allocated``, and nvidia-smi's
    compute apps and card memory), the sequence one request at a time
    (each request's replica read off the replicas' ``stats()``), the
    closed loop, every reply held to a direct engine fed its replica's
    requests. Each replica process launches the decode and the four fused
    kernels, no paged or flash kernel. Teardown leaves no process the
    cluster started alive and no compute app beyond those before it.
    Decode tokens/s, TTFT, TPOT and the driver's and replicas' CPU cores,
    beside phase 12's in the same call. Phases 13 and 14 serve
    Llama-3-8B's widths cut to ``SERVE_LAYERS``, one tree in this process.
18. The front door, inside 13(b), on its one replica after 13(b)'s own
    launches are read: ``serve.start_http_per_node()`` starts one HTTP
    proxy actor on the one node (its ``/-/healthz`` and ``/-/routes``
    list the deployment); the replica's engine is rebuilt fresh from the
    seed (``counting_server()``'s ``fresh_engine``), so its cache history
    is the direct engine's; phase 5's warm-up and 16 prompts go one at a
    time over ``http.client`` as ``POST /llm13`` replies, then as
    ``?stream=1`` streams: tokens identical to the direct engine's first
    and second pass; an 8-client streamed closed loop over HTTP (decode
    tokens/s, p50 TTFT and TPOT, the ms a request adds over 13(b)'s
    handle median, the proxy process's CPU cores, beside 13(b)'s; 8 of
    13(b)'s 16 prompts, one a client, to keep the script's length); the
    replica's ``rtpu_llm_requests_total`` and
    ``rtpu_llm_tokens_generated_total`` for the fresh engine, read from
    the registry the replica publishes to the head's KV (published at
    once through the replica's ``publish_metrics``), count phase 18's
    requests and tokens exactly; the replica launches the decode and the
    four fused kernels over phase 18 (``launches_phase18``), no paged or
    flash kernel. Tracing stays off. The proxy's process is in 13's
    no-survivor check.
14. Disaggregated serving and the cluster fleet tier, on phase 13's
    cluster, Llama-3-8B bf16 cut to ``SERVE_LAYERS``, phase 5's engine
    configuration, held to the direct engine here that took phase 5's
    sequence twice.
    (a) ``build_llm_deployment(disaggregated=True, use_gpu=True)`` with
    each pool's replicas asking ``{"GPU": 0.5}``: one prefill and one
    decode replica in two worker processes on the one card, each drawing
    the weights from the seed. Phase 5's warm-up and 16 prompts one at a
    time as replies, then again as streams, tokens identical to the
    direct engine's over the same two passes; every edge a ring; the
    prefill replica launches no decode kernel, the decode replica one a
    layer and step; the handoff's ms a page from the replicas' own
    timestamps (the prefill replica's channel write to the decode
    replica's synchronized install, split at the engine's
    ``install_async``), beside phase 9a's in-process handoff and 13a's
    store round trip; the 8-client closed loop beside 13b's one replica.
    Then the same with ``paged_decode=True`` on both sides: tokens
    identical, the paged kernel launches and the contiguous one does not.
    (b) Two colocated ``{"GPU": 0.5}`` replicas with the fleet tier on,
    both on ``ClusterKVPageStore``: phase 9b's traffic sent to each
    replica directly (the first spills a shared prefix's blocks under
    eviction, the second pulls them), tokens identical to a fleet-off
    direct engine's, spilled and pulled blocks, no rejects; pull ms a
    page in the pulling replica (a hit in the node's shm arena across
    processes) beside phase 9b's. Teardown is phase 13's check over both
    phases' processes.
8. Training, after the engines are gone: full-depth Llama-3-8B in bf16
   (random weights from a seed), ``spmd.init_train_state`` ->
   ``make_train_step(default_optimizer(lr=1e-4, warmup=1))``, 5 steps on
   one batch of B=1, S=2048 from a numpy seed; finite losses and gradient
   norms, a falling loss, the kernels' launch counts per step, step time,
   tokens/s, MFU, peak memory and the device time by group.
15. The trainer, after phase 8 (``ray_tpu_torch.train`` on the cluster
    runtime, ``ray_tpu_torch.init()``, each run one worker process leased
    ``{"GPU": 1}``, which sees the card alone): (a) phase 8's training
    (Llama-3-8B bf16, ``_gen(11)``, ``RandomState(8)`` tokens, 5 steps)
    as the loop of ``DataParallelTrainer(..., ScalingConfig(num_workers=1,
    use_gpu=True))``: the worker is another process, its kernel launches
    equal phase 8's and its losses are within 2e-3 of phase 8's; its step
    ms beside phase 8's direct step, a round's overhead (the driver's time
    between rounds less the worker's step), tokens/s, MFU, peak memory,
    the last step profiled (its device idle share, the step left out of
    the median). (b) Llama-3.2-1B at its published widths and depth, bf16, 4 steps,
    the whole state (``spmd.train_state_tree``, ~9 GB) saved every 2 steps
    by ``train.save_pytree`` and loaded straight back bit-equal; the first
    attempt fails at step 3 and ``FailureConfig(max_failures=1)`` restarts
    it from the checkpoint (``load_pytree(device="cuda")`` ->
    ``train_state_from_tree``), its losses at steps 2-3 within 2e-3 of an
    uninterrupted run in this process; the checkpoint's bytes, save and
    load ms and GB/s, the free disk. (c) ``TorchTrainer`` on the GPU
    worker: backend NCCL, a world of one, an ``all_reduce`` of a CUDA
    tensor, one DDP step of a small module on the card equal to the same
    step without DDP. Prints the phase's time.
16. The mesh (``ray_tpu_torch.parallel``), after phase 15; the driver
    joins a NCCL process group of one. (a) Phase 8's training exactly
    (weights, tokens, optimizer, 5 steps) through ``make_train_step(cfg,
    tx, mesh=mesh_2d(1))`` over ``shard_params``: the placements checked
    before and after, every kernel's launches equal to phase 8's, each
    loss within 2e-3 relative of phase 8's (and whether bit-equal), the
    loss falls; the step ms beside phase 8's, one profiled step's wall,
    host enqueue, device busy and idle share, MFU, peak memory. (b) The
    GPipe pipeline at Llama-3-8B widths cut to 4 layers, bf16, B=4 S=512,
    2 stages x 4 microbatches on one card: its hidden within 2e-2 of the
    dense forward on the same weights, its step's loss within 2e-3 of the
    dense step's. (c) Two ranks (processes, each its own CUDA context on
    card 0) over gloo, 2 layers at Llama-3-8B widths, bf16, B=2 S=1024, 3
    steps on ``MeshSpec(tp=2)`` and on ``MeshSpec(fsdp=2)``: losses and
    grad norms within 2e-3 of the world-of-one step, the flash kernels at
    the local head counts; step ms (gloo through the host).
17. Data (``ray_tpu_torch.data``). (b) runs at the end of phase 12, on
    its params tree before it is freed: batch inference through
    ``build_llm_processor`` on ``init(local_mode=True)``, phase 12's
    Llama-3-8B bf16, phase 5's engine in one pool actor
    (``concurrency=1``, ``batch_size=8``), ``from_items`` over phase 5's 16
    prompts (``parallelism=2``), 32 new tokens each: every row's tokens
    identical to a direct engine's with the same prefix-cache history
    (each request's ``cached_prefix_len`` recorded), every kernel of phase
    5's path launched; rows/s and tokens/s (the pool actor's engine build
    timed apart) beside phase 5's closed loop. (a) and (c) after phase 15,
    on its ``init()`` cluster: (a) phase 15a's loop in a GPU worker with
    its tokens from a Dataset of 5 rows
    (each phase 8's ``RandomState(8)`` row, made by a map stage) handed to
    ``DataParallelTrainer(datasets=...)`` -> ``streaming_split(1)`` ->
    ``train.iter_device_batches``: losses bit-equal to 15a's, every batch
    on the worker's card, launches a step equal to phase 8's; the step ms
    (the batch's fetch included) beside 15a's and phase 8's, the profiled
    step's device idle share beside 15a's, the consumer's wait for each
    batch, a standalone pinned copy of one batch's size; (c) ``bench.py``'s
    data suite at its sizes: the channel against the task exchange of a
    96,000 x 17 float64 ``random_shuffle`` in GB/s, best of 2 (bench.py
    takes 3), with at least one channel exchange that returned counted,
    and ``iter_batches(device_put="cuda")`` over 65,536 x 256 f32 in
    batches of 4096 through three matmuls, buffered against inline
    ``.to("cuda")`` and a pre-staged batch (the arms' sums equal).
    ``--data`` runs 17b on params of its own, then 17a (15a's loop run
    first as its pre-staged arm) and 17c on a cluster of their own.
19. Tune (``ray_tpu_torch.tune``), after phase 16, on
    ``init(address="local")``: ``Tuner.fit`` over Llama-3.2-1B training
    steps (bf16, fused ops, full published widths and depth, 15b's state
    from ``_gen(12)`` and token row, B=1, S=2048), four trials of
    ``grid_search`` over the learning rate, two at a time, ASHA (max_t 6,
    grace 2, factor 2), one ``tune.report`` a step: every trial's first
    loss bit-equal to a direct step taken first, ASHA stopping at least
    one trial at step 2 or 4, the best result the lowest final loss of
    the trials that ran 6 steps, every trial's thread gone and the card
    back within 64 MiB of its allocation before the phase (the trial
    threads' cuBLAS workspaces dropped), the peak under 80 GB, the
    training kernels launched and the decode ones not. The trials' ms a
    step (two share the card) beside the direct step's.
20. Client mode and jobs, on phase 15's ``init()`` cluster after 11d:
    (a) this process's gateway (``client/server.py``) and a child driver
    at ``client://``: one ``{"GPU": 0.5}`` task that draws Llama-3.2-1B
    from seed 0 on its card and returns the argmax tokens and f32 logit
    sum of a forward over a seeded 256-token prompt (the flash gate takes
    S >= 256), held to this process's own forward (argmax equal, sum
    within 1e-3 relative); then an actor the child owns and leaves alive
    at its exit, gone within 30 s; (b) ``python -m
    ray_tpu_torch.scripts.cli submit`` of a job whose driver joins the
    cluster and runs the same task: ``SUCCEEDED``, its logs' result equal
    to the driver's forward, and whether its task reused (a)'s GPU
    worker. Each task reports its worker's launches.
21. Workflows, state and the dashboard, right after phase 20 on its
    cluster and its warm ``{"GPU": 0.5}`` worker (no new cluster, node or
    GPU worker): (a) a durable ``ray_tpu_torch.workflow`` of three steps
    under a scratch storage root: ``p21_prompt`` (CPU) makes phase 20's
    prompt, ``p21_check`` (CPU) checks it and raises
    ``ConnectionResetError`` on its first attempt under
    ``retry_exceptions=(ConnectionError,)``, ``p21_forward`` (``{"GPU":
    0.5}``) runs phase 20's Llama-3.2-1B forward (full published widths
    and depth, ``fused_ops=True``) and also returns the last position's
    logits as a bf16 tensor on the card (a CPU step cannot take a CUDA
    tensor, so the check comes first). The argmax tokens and f32 logit
    sum are bit-equal to phase 20a's; the forward's launches (RMSNorm,
    RMSNorm+residual, RoPE, SwiGLU, flash forward) equal 20a's exactly
    and its side-effect marker counts 1; the check ran twice;
    ``workflow.resume`` of the finished id returns the same result and
    launches nothing; the bf16 tensor loaded back from storage is
    bit-equal and on the card. (b) ``util.state.list_nodes()`` shows the
    card's node with ``GPU`` and the model label the GPU accelerator
    manager read without a CUDA context (the short form of nvidia-smi's
    name); ``list_tasks()`` and the timeline hold the three steps; the
    dashboard, on an ephemeral port, answers ``/api`` with the label.
    (c) The phase prints its seconds and fails past 15 s.
    Every cluster the script starts prints how many CPU workers forked
    from the zygote and how many cold-spawned, and why. The clusters of
    phases 13-14 and 15 first start the worker processes their phases
    lease one after another together (``warm_workers``: GPU workers that
    import the port, open a CUDA context and serve two tokens of a
    one-layer model through the kernels, then zero the launch counters;
    CPU workers that import it), so each later lease finds an idle one.
22. The witnesses on the engine, inside phase 9 on its 8-layer tree
    before the tree is freed (no new draw, no new process): for spec off
    and ``spec_draft_len=SPEC_DRAFT_LEN``, an engine with every flag off
    and one with ``RTPU_DEBUG_RES=1``, ``RTPU_DEBUG_CUDA=1`` and
    ``RTPU_DEBUG_CUDA_SYNC=error`` serve 8 of phase 5's prompts one at a
    time. The witnessed engine's ticks run under
    ``torch.cuda.set_sync_debug_mode("error")`` with only the counted
    fetch let through: no sync may raise, the counted decode syncs equal
    the fetched chunks and the prefill syncs the admissions, the
    programs stay within ``ray_tpu``'s budgets (one decode chunk, one
    verify with spec, at most one prefill a bucket), every resource of
    the resource witness is balanced at ``close``, and the tokens equal
    the flags-off engine's. The flags are restored in a ``finally``;
    the phase prints its seconds and launches (rows 1, 3-6) and fails
    past 30 s.
Before its last two lines the script prints ``phase seconds {...}``:
every phase group's seconds and the total.
10. The model zoo, after phase 8: (a) Mixtral, 2 layers at
    MIXTRAL_8X7B's widths in f32, B=1, S=256: the loss and every gradient
    through the flash kernels against the plain route, and every token's
    top-2 experts identical on both; (b) Mixtral's training step, the
    8x7B widths cut to 4 layers (6.07B parameters: bf16 weights,
    gradients and AdamW's moments take 48.5 GB), bf16, B=1, S=2048, 5
    steps through the generalised ``spmd`` optimizer, launches a step
    checked exactly (8 flash forwards, 4 backwards), step time, MFU by
    active parameters, peak memory and the device time by group (expert
    FFN, the f32 dispatch/combine, flash, optimizer); (c) ViT-B/16 bf16,
    B=32; (d) T5-base bf16, B=8, 512 + 128 tokens with a padded encoder
    mask, then greedy generation twice, tokens identical; (e) the UNet
    at ``DiffusionConfig()``, f32, B=64, then a 1000-step sample. Each
    trains 5 steps with a falling loss; (c)-(e) launch no port kernel.
11. RLlib (``ray_tpu_torch.rllib``), after phase 10, f32 with TF32 off:
    (a) one update of each learner (PPO, DQN with prioritised weights,
    SAC, IMPALA, BC, CQL) on the card and on the CPU from the same seed's
    weights, numpy batches and draws, every parameter and stat within
    1e-4 of its largest value (a stat: of max(|stat|, 1)); a 16 x 256
    CartPole rollout of ``EnvRunner`` under a policy whose logits differ
    by 50 or more, actions, flags, rewards and returns identical to the
    CPU's; (b) the learning gates of ``ray_tpu``'s tests at their
    configs, budgets and thresholds (PPO, DQN, IMPALA, multi-agent PPO,
    SAC, BC with action accuracy > 0.7, CQL), each stopping at its
    threshold, iterations to it; (c) PPO at the gate's config: ms an
    iteration split into env steps, policy forwards with host copies, and
    the update; host syncs an iteration (PyTorch's sync debug mode); env
    steps/s; one profiled update's device busy time and idle share; the
    same iteration on the CPU; one DQN and one SAC iteration. (d) The
    remote modes, on phase 15's ``init()`` cluster after 17c (``--rllib``:
    on a cluster of its own, after 11c): (i) the actor collectives among 8
    CPU rank actors, checked as ``ray_tpu``'s test checks them; (ii) the
    DQN learner gang of (iii), 2 in GPU workers on ``{"GPU": 0.5}`` each,
    before it trains, against one DQN learner on the card in this process,
    one update of the same seeded 128-row batch: every weight within rtol
    1e-4, atol 1e-5, ``td_errors`` in batch order; after (iii), the ms of
    a gang update and of a local one; (iii) that DQN, with 2 remote
    runners (CPU workers), trained on from there to ``ray_tpu``'s gate
    (best return >= 40 within 45 iterations), the iteration that reached
    it and the ms of an iteration; (iv) IMPALA with
    2 asynchronous runners, 4 training steps, two rollouts in flight
    throughout, 512 env steps; (v) one iteration each of PPO and
    multi-agent PPO with 2 remote runners, finite losses. Launches no
    port kernel.
6. Timing, last: an empty kernel (the launch floor), then each kernel,
   its plain version and (where one exists) the one PyTorch call that
   computes the same function, with CUDA events, at the decode shapes of
   phase 3 (the flash kernels at phase 8's training shape, with their
   TFLOP/s, share of the bound and, for the backward, each of its three
   kernels' device time); the decode kernels also at S=4096 and at phase
   5's slot lengths; RMSNorm, RMSNorm+residual, RoPE and SwiGLU also at
   phase 8's shapes, beside their plain versions and launches a step;
   then the host cost of the fused ops' autograd
   ``Function``. The ``kernels`` JSON line (phase 7a's launches for the
   paged kernel, phase 8's for the flash kernels, each kernel's
   launches over phase 9 as ``launches_phase9``, over phase 12's
   deployments as ``launches_phase12``, summed over phase 13's replica
   processes as ``launches_phase13`` and over phase 14's as
   ``launches_phase14``, the replica process's over phase 18 as
   ``launches_phase18``, phase 15a's trainer worker's over its 5 steps as
   ``launches_phase15``, phase 16a's as ``launches_phase16``, phase 17a's
   worker's and 17b's processor's summed as ``launches_phase17``, phase
   19's ``fit`` as ``launches_phase19``, phase 20's two tasks summed as
   ``launches_phase20``, phase 21's forward step as ``launches_phase21``,
   and the flash rows' launches a step of phase 10b as
   ``launches_phase10``) is printed just before the last line.

The last line is ``{"ok": true, "device": {...}}``. Needs one card; exits
non-zero at once without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

# Tolerances (rtol = atol), those of ray_tpu's own kernel tests:
TOL = {
    # tests/test_decode_attention.py:52 (f32), :120 (bf16)
    "decode_attention": {torch.float32: 2e-3, torch.bfloat16: 2e-2},
    # tests/test_paged_decode.py:83-84 (f32), :152-154 (bf16)
    "paged_decode_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    # tests/test_fused_ops.py:33-83 (f32); bf16 as test_fused_ops.py:92-94
    "rms_norm": {torch.float32: 1e-6, torch.bfloat16: 2e-2},
    "rms_norm_residual": {torch.float32: 1e-6, torch.bfloat16: 2e-2},
    "swiglu": {torch.float32: 1e-6, torch.bfloat16: 2e-2},
    # attention kernels: test_decode_attention.py:52 (f32), :120 (bf16)
    "flash_attention": {torch.float32: 2e-3, torch.bfloat16: 2e-2},
}
# fused_qk_rope f32: rtol 1e-5, atol 1e-6 (test_fused_ops.py:53-58).
ROPE_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2e-2, 2e-2)}
# Phase 4 logits: test_decode_attention.py:84-86 (kernel vs plain model);
# phase 4's loss and gradients: the same, of each tensor's largest value.
MODEL_TOL = 2e-3

# The engines of phases 5 and 7: Llama-3-8B, 8 slots of 512 rows, 16-row
# prefix blocks (= pages). Phase 7b's cache adds the speculative scratch
# strip (draft_len + 1 rows) and pads to a page: 528 rows, the paged
# kernel's S in phases 3 and 6 (checked against the engine's own cache).
ENGINE_KW = dict(max_batch=8, max_len=512, prompt_buckets=[32, 64],
                 decode_chunk=8, prefix_block=16, seed=0)
SPEC_DRAFT_LEN = 4
# Phases 9a-9b, 12 (with 17b), 13 and 14 serve Llama-3-8B's widths cut to
# this many of its 32 layers; phases 5, 7 and 9c serve all 32. Those
# phases send phase 5's sequence one request at a time again and again,
# and a request's decode is host-bound, its time in proportion to the
# depth: at 32 layers the script ran past its 1200 s limit, and at 16 it
# kept too little of it on a slow host.
SERVE_LAYERS = 8
PAGE = ENGINE_KW["prefix_block"]
PAGED_S = -(-(ENGINE_KW["max_len"] + SPEC_DRAFT_LEN + 1) // PAGE) * PAGE
# Phase 8, the training cell (bench.py's 8B training shape at batch 1),
# and its kernels' launches a step.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 2048, 5
TRAIN_PER_STEP = {"flash_attention": 64, "flash_attention_bwd": 32,
                  "qk_rope": 96, "rms_norm": 65, "rms_norm_residual": 64,
                  "swiglu": 64, "decode_attention": 0,
                  "paged_decode_attention": 0}

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores, bf16 inputs
F32_SIMT_FLOPS = 67e12   # elementwise f32 math outside the tensor cores

KERNEL_META = {
    "decode_attention": ("ray_tpu_torch/csrc/decode_attention.cu",
                         "ray_tpu/ops/decode_attention.py:108"),
    "paged_decode_attention": ("ray_tpu_torch/csrc/decode_attention.cu",
                               "ray_tpu/ops/paged_decode.py:130"),
    "rms_norm": ("ray_tpu_torch/csrc/fused.cu", "ray_tpu/ops/fused.py:183"),
    "rms_norm_residual": ("ray_tpu_torch/csrc/fused.cu",
                          "ray_tpu/ops/fused.py:191"),
    "qk_rope": ("ray_tpu_torch/csrc/fused.cu", "ray_tpu/ops/fused.py:266"),
    "swiglu": ("ray_tpu_torch/csrc/fused.cu", "ray_tpu/ops/fused.py:337"),
    "flash_attention": ("ray_tpu_torch/csrc/flash_attention.cu",
                        "ray_tpu/ops/attention.py:162"),
    "flash_attention_bwd": ("ray_tpu_torch/csrc/flash_attention.cu",
                            "ray_tpu/ops/attention.py:162"),
}


# Numbers a later phase reports beside its own, in the same call: phase
# 9a's handoff ms a page, 9b's pull ms a page, 13a's put/get round trip.
MEASURED = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def close_enough(got, want, rtol, atol, what):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of "
                             f"tolerance, max abs err {err.max().item()}")
    return err.max().item()


# ----------------------------------------------------------- phase 1, 2

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {name}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    # f32 references must be full f32 (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def phase_build():
    from ray_tpu_torch import ops
    from ray_tpu_torch.core import shm_store
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    # The object store's library (g++) builds beside the kernels (nvcc),
    # before phase 13's cluster starts any process.
    store = []
    gxx = threading.Thread(target=lambda: store.append(shm_store.build_lib()))
    gxx.start()
    ops.build_kernels()
    gxx.join()
    if not store:
        raise AssertionError("phase 2: the shm store library did not build")
    log(f"phase 2 build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(_build.SOURCES)}; {store[0].name})")
    for name in _build.SOURCES:
        if name == "flash_attention":
            flash_ptxas_report()
        else:
            kernel_ptxas_report(name)


def template_args(mangled):
    """A mangled kernel name's template arguments, readable:
    ``...decode_kernelI13__nv_bfloat16Li128ELi4ELb0EE...`` -> ('bf16',
    '128', '4', '0')."""
    m = re.search(r"\d+\w+?_kernelI", mangled)
    if not m:
        return ()
    args, rest = [], mangled[m.end():]
    while True:
        t = re.match(r"13__nv_bfloat16|f|L[ib](-?\d+)E", rest)
        if not t:
            return tuple(args)
        args.append(t.group(1) or ("f32" if t.group(0) == "f" else "bf16"))
        rest = rest[t.end():]


def kernel_ptxas_report(lib):
    """One line per kernel instantiation of ``csrc/<lib>.cu``: its name and
    template arguments, ptxas' registers and spills, and (decode) the
    dynamic shared memory a CTA asks for."""
    import ctypes

    from ray_tpu_torch.ops import _build

    smem = getattr(_build.load(lib), "rtt_decode_attention_smem", None)
    if smem is not None:
        smem.argtypes = [ctypes.c_int] * 3
    entry = spill = None
    for line in _build.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            kind = re.search(r"\d+([a-z]\w*?_kernel)", entry)
            args = template_args(entry)
            dyn = ""
            if smem is not None and kind and kind.group(1) == "decode_kernel":
                dt, d, g, paged = args
                dyn = (f"; dynamic smem {smem(int(dt == 'bf16'), int(d), int(g))}"
                       f" bytes{' + 4 a page' if paged == '1' else ''}")
            log(f"  ptxas {lib} {kind.group(1) if kind else entry}"
                f"<{', '.join(args)}>: {line.split(':', 1)[-1].strip()}; "
                f"{spill}{dyn}")
            entry = None
    clusters = getattr(_build.load(lib), "rtt_decode_attention_clusters",
                       None)
    if clusters is not None:
        # What split_plan's one-wave rule rests on, at the engine's B=8,
        # H=32, KH=8, D=128, bf16.
        clusters.argtypes = [ctypes.c_int] * 9
        fit = {n: clusters(8, 32, 8, 4096, 128, 4096 // n, n, 16, 1)
               for n in (1, 2, 4, 8)}
        log(f"  decode_kernel clusters resident at once by cluster size "
            f"(cudaOccupancyMaxActiveClusters): {fit}")


# A flash kernel in ptxas' report: (name, dtype, head_dim) from the
# mangled name.
FLASH_ENTRY = re.compile(r"(fwd_sm90|dkdv_sm90|dq_sm90|fwd_kernel|"
                         r"dkdv_kernel|dq_kernel|delta_kernel)"
                         r"I(13__nv_bfloat16|f)?Li(\d+)E")


def flash_ptxas_report():
    """One line per flash kernel: ptxas' registers and spills and the
    dynamic shared memory a CTA of it asks for (the TMA + wgmma kernels
    then move registers with setmaxnreg: 24 for the producer, 240 for
    each consumer warpgroup)."""
    import ctypes

    from ray_tpu_torch.ops import _build

    smem = getattr(_build.load("flash_attention"),
                   "rtt_flash_attention_smem", None)  # older checkouts lack it
    if smem is not None:
        smem.argtypes = [ctypes.c_int] * 3
    which = {"fwd": 0, "dkdv": 1, "dq": 2}
    entry = spill = None
    for line in _build.build_log("flash_attention").splitlines():
        m = FLASH_ENTRY.search(line)
        if "Compiling entry" in line and m:
            entry, spill = m.groups(), ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            kind, dt, d = entry
            dtype = 1 if kind.endswith("sm90") or dt == "13__nv_bfloat16" \
                else 0
            base = kind.split("_")[0]
            dyn = (f"{smem(which[base], int(d), dtype)} bytes"
                   if base in which and smem is not None else "none")
            log(f"  ptxas flash_attention {kind}<{('f32', 'bf16')[dtype]}, "
                f"D={d}>: {line.split(':', 1)[-1].strip()}; {spill}; "
                f"dynamic smem {dyn}")
            entry = None


# ---------------------------------------------------------------- phase 3

def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, dtype, seed, scale=1.0):
    return (torch.randn(shape, generator=_gen(seed), device="cuda")
            * scale).to(dtype)


def decode_inputs(b, h, kh, d, s, dtype, seed, lengths):
    q = _randn((b, h, d), dtype, seed)
    k = _randn((b, kh, s, d), dtype, seed + 1)
    v = _randn((b, kh, s, d), dtype, seed + 2)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def check_decode(dtype, s, d=128, seed=0):
    from ray_tpu_torch.ops import decode_attention, decode_attention_reference

    b, h, kh = 8, 32, 8
    lengths = [0, 1, s, s // 2 + 3, 17, s - 1, 100, 257]
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dtype, seed, lengths)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths):     # poison every row past the length
        kp[i, :, n:] = 1e4
        vp[i, :, n:] = float("nan")
    got = decode_attention(q, kp, vp, lens, layout="bksd")
    want = decode_attention_reference(q, k, v, lens)
    tol = TOL["decode_attention"][dtype]
    err = close_enough(got, want, tol, tol,
                       f"decode_attention {dtype} S={s} D={d}")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("decode_attention: length-0 slot is not 0")
    log(f"  decode_attention {str(dtype)[6:]} B=8 H=32 KH=8 D={d} S={s} "
        f"ragged+poisoned: max abs err {err} (tol {tol})")
    return err


def identity_table(b, s, page=PAGE):
    return torch.arange(b * (s // page), dtype=torch.int32,
                        device="cuda").reshape(b, s // page)


def scatter_pages(k, v, page, seed):
    """Every (slot, page) of k/v moved to a random page of an equally
    sized pool; returns (pool_k, pool_v, table)."""
    b, kh, s, d = k.shape
    np_row = s // page
    perm = torch.randperm(b * np_row, generator=_gen(seed), device="cuda")
    pools = []
    for src in (k, v):
        pages = src.reshape(b, kh, np_row, page, d).transpose(1, 2).reshape(
            b * np_row, kh, page, d)
        flat = torch.empty_like(pages)
        flat[perm] = pages
        pools.append(flat.reshape(b, np_row, kh, page, d).transpose(1, 2)
                     .reshape(b, kh, s, d).contiguous())
    return pools[0], pools[1], perm.reshape(b, np_row).to(torch.int32)


def check_paged(dtype, s, d=128, seed=50):
    """(a) identity table bit-equal to decode_attention; (b) a scattered
    table within tolerance of the contiguous plain version; (c) every row
    at or past each length (whole pages included) NaN-poisoned, lengths
    0, 1, a partial page and S among them."""
    from ray_tpu_torch.ops import (decode_attention,
                                   decode_attention_reference,
                                   paged_decode_attention)

    b, h, kh = 8, 32, 8
    lengths = [0, 1, s, s // 2 + 3, 17, s - 1, 100, 257]
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dtype, seed, lengths)
    want = decode_attention_reference(q, k, v, lens)
    kp, vp = k.clone(), v.clone()
    for i, n in enumerate(lengths):
        kp[i, :, n:] = float("nan")
        vp[i, :, n:] = float("nan")
    got = paged_decode_attention(q, kp, vp, identity_table(b, s), lens,
                                 page_size=PAGE)
    if not torch.equal(got, decode_attention(q, kp, vp, lens,
                                             layout="bksd")):
        raise AssertionError(f"paged_decode_attention {dtype} S={s}: "
                             "identity table not bit-equal to "
                             "decode_attention")
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("paged_decode_attention: length-0 slot is "
                             "not 0")
    tol = TOL["paged_decode_attention"][dtype]
    err = close_enough(got, want, tol, tol,
                       f"paged_decode_attention identity {dtype} S={s}")
    pool_k, pool_v, table = scatter_pages(kp, vp, PAGE, seed + 3)
    got = paged_decode_attention(q, pool_k, pool_v, table, lens,
                                 page_size=PAGE)
    err = max(err, close_enough(
        got, want, tol, tol, f"paged_decode_attention scattered {dtype} "
        f"S={s}"))
    log(f"  paged_decode_attention {str(dtype)[6:]} B=8 H=32 KH=8 D={d} "
        f"S={s} page {PAGE}: identity table bit-equal to decode_attention;"
        f" identity and scattered tables, ragged+NaN-poisoned: max abs err "
        f"{err} (tol {tol})")
    return err


def check_paged_refuses():
    from ray_tpu_torch.ops import paged_decode_attention

    q, k, v, lens = decode_inputs(1, 32, 8, 128, PAGED_S - 8,
                                  torch.bfloat16, 60, [5])
    try:
        paged_decode_attention(q, k, v, identity_table(1, PAGED_S), lens,
                               page_size=PAGE)
    except ValueError as e:
        if "multiple" not in str(e):
            raise
        log(f"  paged_decode_attention S={PAGED_S - 8} page {PAGE}: "
            f"refused ({e})")
        return
    raise AssertionError("paged_decode_attention took S % page != 0")


def check_fused(dtype, rows_shape, seed=10):
    from ray_tpu_torch.ops import (fused_qk_rope, fused_rms_norm,
                                   fused_rms_norm_residual, fused_swiglu,
                                   rms_norm, apply_rope, swiglu_reference)

    errs = {}
    tag = f"{str(dtype)[6:]} {list(rows_shape)}"
    d, f, b, s = 4096, 14336, rows_shape[0], rows_shape[1]
    x = _randn((b, s, d), dtype, seed)
    r = _randn((b, s, d), dtype, seed + 1)
    sc = _randn((d,), dtype, seed + 2, scale=0.2)
    tol = TOL["rms_norm"][dtype]
    errs["rms_norm"] = close_enough(fused_rms_norm(x, sc, 1e-5),
                                    rms_norm(x, sc, 1e-5), tol, tol,
                                    f"rms_norm {tag}")
    y, u = fused_rms_norm_residual(x, r, sc, 1e-5)
    u_want = x + r
    errs["rms_norm_residual"] = max(
        close_enough(u, u_want, tol, tol, f"rms_norm_residual sum {tag}"),
        close_enough(y, rms_norm(u_want, sc, 1e-5), tol, tol,
                     f"rms_norm_residual norm {tag}"))
    q = _randn((b, s, 32, 128), dtype, seed + 3)
    k = _randn((b, s, 8, 128), dtype, seed + 4)
    pos = (torch.randint(0, 512, (b, 1), generator=_gen(seed + 5),
                         device="cuda")
           + torch.arange(s, device="cuda")).to(torch.int32)
    rtol, atol = ROPE_TOL[dtype]
    qr, kr = fused_qk_rope(q, k, pos, 500000.0)
    errs["qk_rope"] = max(
        close_enough(qr, apply_rope(q, pos, 500000.0), rtol, atol,
                     f"qk_rope q {tag}"),
        close_enough(kr, apply_rope(k, pos, 500000.0), rtol, atol,
                     f"qk_rope k {tag}"))
    g = _randn((b, s, f), dtype, seed + 6)
    up = _randn((b, s, f), dtype, seed + 7)
    tol = TOL["swiglu"][dtype]
    errs["swiglu"] = close_enough(fused_swiglu(g, up),
                                  swiglu_reference(g, up), tol, tol,
                                  f"swiglu {tag}")
    log(f"  fused {tag}: " + ", ".join(f"{k_} {v_}" for k_, v_ in
                                       errs.items()))
    return errs


def check_rope_bwd(dtype, seed=20):
    """The RoPE backward as the training path runs it: the kernel at the
    negated positions 0..-(S-1), reached through the autograd Function,
    against ``apply_rope`` of the cotangents at the same positions, at
    phase 8's q and k shapes."""
    from ray_tpu_torch.ops import apply_rope, fused_qk_rope

    b, s = TRAIN_B, TRAIN_S
    tag = f"{str(dtype)[6:]} q [{b},{s},32,128] k [{b},{s},8,128]"
    q = _randn((b, s, 32, 128), dtype, seed).requires_grad_()
    k = _randn((b, s, 8, 128), dtype, seed + 1).requires_grad_()
    gq, gk = _randn(q.shape, dtype, seed + 2), _randn(k.shape, dtype, seed + 3)
    pos = torch.arange(s, device="cuda", dtype=torch.int32).expand(b, s)
    dq, dk = torch.autograd.grad(fused_qk_rope(q, k, pos, 500000.0), (q, k),
                                 (gq, gk))
    rtol, atol = ROPE_TOL[dtype]
    err = max(close_enough(dq, apply_rope(gq, -pos, 500000.0), rtol, atol,
                           f"qk_rope backward dq {tag}"),
              close_enough(dk, apply_rope(gk, -pos, 500000.0), rtol, atol,
                           f"qk_rope backward dk {tag}"))
    log(f"  qk_rope backward {tag}, the kernel at positions 0..-{s - 1}: "
        f"max abs err {err} (rtol {rtol}, atol {atol})")


def flash_inputs(b, s, h, kh, d, dtype, seed):
    return (_randn((b, s, h, d), dtype, seed),
            _randn((b, s, kh, d), dtype, seed + 1),
            _randn((b, s, kh, d), dtype, seed + 2),
            _randn((b, s, h, d), dtype, seed + 3))


# (B, S, H, KH, D) of phase 3's flash checks: phase 8's shape, S=384 (three
# 128-row tiles), ragged S with B > 1 and GQA groups of 8 and 1.
FLASH_SHAPES = ((TRAIN_B, TRAIN_S, 32, 8, 128), (2, 384, 4, 2, 64),
                (3, 200, 16, 2, 128), (2, 320, 8, 8, 64))


def check_flash(dtype, b, s, h, kh, d, seed=70):
    """Forward (out, lse) and backward (dq, dk, dv from the kernel's own
    out and lse) against the plain versions."""
    from ray_tpu_torch.ops import (flash_attention, flash_attention_bwd,
                                   flash_attention_bwd_reference,
                                   flash_attention_reference)

    q, k, v, dout = flash_inputs(b, s, h, kh, d, dtype, seed)
    tol = TOL["flash_attention"][dtype]
    tag = f"{str(dtype)[6:]} B={b} S={s} H={h} KH={kh} D={d}"
    out, lse = flash_attention(q, k, v)
    want_out, want_lse = flash_attention_reference(q, k, v)
    err = max(close_enough(out, want_out, tol, tol, f"flash out {tag}"),
              close_enough(lse, want_lse, tol, tol, f"flash lse {tag}"))
    grads = flash_attention_bwd(q, k, v, out, lse, dout)
    want = flash_attention_bwd_reference(q, k, v, out, lse, dout)
    err_b = max(close_enough(g, w, tol, tol, f"flash {n} {tag}")
                for n, g, w in zip(("dq", "dk", "dv"), grads, want))
    log(f"  flash_attention {tag}: forward max abs err {err}, backward "
        f"{err_b} (tol {tol})")


def phase_kernels():
    log("phase 3 kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        for s in (512, 4096):
            check_decode(dtype, s)
        check_decode(dtype, 512, d=64)        # LLAMA3_1B head_dim
        for s in (PAGED_S, 4096):
            check_paged(dtype, s)
        for shape in ((8, 1), (1, 64), (TRAIN_B, TRAIN_S)):
            check_fused(dtype, shape)
        check_rope_bwd(dtype)
        for shape in FLASH_SHAPES:
            check_flash(dtype, *shape)
    check_paged_refuses()
    torch.cuda.synchronize()


# ---------------------------------------------------------------- phase 4

def phase_model():
    from ray_tpu_torch.models import llama

    base = dataclasses.replace(llama.LLAMA3_8B, n_layers=2,
                               dtype=torch.float32, max_seq_len=128)
    cfg_k = dataclasses.replace(base, fused_ops=True, use_decode_kernel=True)
    cfg_p = dataclasses.replace(base, fused_ops=False,
                                use_decode_kernel=False)
    params = llama.init_params(cfg_k, _gen(4), device="cuda")
    b, t, steps = 4, 16, 8
    cache_k = llama.init_kv_cache(cfg_k, b, 128, device="cuda")
    cache_p = llama.init_kv_cache(cfg_p, b, 128, device="cuda")
    prompt = torch.randint(0, cfg_k.vocab_size, (b, t), generator=_gen(5),
                           device="cuda", dtype=torch.int32)
    worst = 0.0
    with torch.no_grad():
        lk, _ = llama.forward_with_cache(params, prompt, cache_k, 0, cfg_k)
        lp, _ = llama.forward_with_cache(params, prompt, cache_p, 0, cfg_p)
        worst = max(worst, close_enough(lk, lp, MODEL_TOL, MODEL_TOL,
                                        "model prefill logits"))
        tok = lk[:, -1].argmax(-1).to(torch.int32)[:, None]
        for i in range(steps):
            idx = torch.full((b,), t + i, dtype=torch.int32, device="cuda")
            lk, _ = llama.forward_with_cache(params, tok, cache_k, idx, cfg_k)
            lp, _ = llama.forward_with_cache(params, tok, cache_p, idx, cfg_p)
            worst = max(worst, close_enough(lk, lp, MODEL_TOL, MODEL_TOL,
                                            f"model decode step {i}"))
            tok = lk[:, -1].argmax(-1).to(torch.int32)[:, None]
    log(f"phase 4 model: 2 layers at 8B widths f32, prefill {t} + {steps} "
        f"decode steps, kernels vs plain max abs logit err {worst} "
        f"(tol {MODEL_TOL})")
    del params, cache_k, cache_p
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        phase_model_paged(base, dtype)
    phase_model_train(base)


def phase_model_paged(base, dtype, b=4, t=16, steps=8):
    """The same 2-layer model with paged_decode=True: logits bit-equal to
    the contiguous decode kernel's at every decode step."""
    from ray_tpu_torch.models import llama

    cfg_c = dataclasses.replace(base, dtype=dtype, fused_ops=True,
                                use_decode_kernel=True)
    cfg_p = dataclasses.replace(cfg_c, paged_decode=True, decode_page=PAGE)
    params = llama.init_params(cfg_c, _gen(6), device="cuda")
    caches = [llama.init_kv_cache(c, b, 128, device="cuda")
              for c in (cfg_c, cfg_p)]
    prompt = torch.randint(0, cfg_c.vocab_size, (b, t), generator=_gen(7),
                           device="cuda", dtype=torch.int32)
    with torch.no_grad():
        outs = [llama.forward_with_cache(params, prompt, c, 0, cfg)[0]
                for c, cfg in zip(caches, (cfg_c, cfg_p))]
        for i in range(steps):
            tok = outs[0][:, -1].argmax(-1).to(torch.int32)[:, None]
            idx = torch.full((b,), t + i, dtype=torch.int32, device="cuda")
            outs = [llama.forward_with_cache(params, tok, c, idx, cfg)[0]
                    for c, cfg in zip(caches, (cfg_c, cfg_p))]
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"paged model {dtype} decode step {i}: "
                                     "logits differ from the contiguous "
                                     "kernel's")
            if not torch.isfinite(outs[1].float()).all():
                raise AssertionError("paged model: non-finite logits")
    log(f"phase 4 model: 2 layers at 8B widths {str(dtype)[6:]}, prefill "
        f"{t} + {steps} decode steps with paged_decode=True: logits "
        f"bit-equal to the contiguous decode kernel's")
    del params, caches
    torch.cuda.empty_cache()


def phase_model_train(base, b=2, s=256, chunk=128):
    """The 2-layer model's loss and every gradient through the flash and
    fused kernels under remat (``loss_fn``), against the plain route
    (``fused_ops`` off, no remat, and explicit positions, which keep
    attention position-masked and off the flash gate), f32; S=256 is the
    flash gate's smallest length, the CE in chunks of 128."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama

    cfg_k = dataclasses.replace(base, fused_ops=True, remat=True)
    cfg_p = dataclasses.replace(base, fused_ops=False, remat=False)
    positions = torch.arange(s, device="cuda").expand(b, s)
    params = llama.init_params(cfg_k, _gen(9), device="cuda")
    tokens = torch.randint(0, base.vocab_size, (b, s), generator=_gen(10),
                           device="cuda")
    runs = []
    for cfg in (cfg_k, cfg_p):
        p = {n: (v.clone().requires_grad_() if n != "blocks" else
                 {k_: w.clone().requires_grad_() for k_, w in v.items()})
             for n, v in params.items()}
        for fn in ops.KERNELS.values():
            fn.launches = 0
        if cfg is cfg_k:
            loss, _ = llama.loss_fn(p, tokens, cfg, logits_chunk=chunk)
        else:
            x = llama.forward_hidden(p, tokens, cfg, positions=positions)
            loss, _ = llama.loss_from_hidden(p, x, tokens, cfg,
                                             logits_chunk=chunk)
        loss.backward()
        runs.append((loss.detach(), p,
                     {n: fn.launches for n, fn in ops.KERNELS.items()}))
        del loss
    (lk, pk, nk), (lp, pp, n_plain) = runs
    if (nk["flash_attention"], nk["flash_attention_bwd"], nk["qk_rope"]) \
            != (4, 2, 6) or n_plain["flash_attention"] != 0:
        raise AssertionError(f"phase 4 train launches: kernels {nk}, plain "
                             f"{n_plain}")
    worst = close_enough(lk, lp, MODEL_TOL, MODEL_TOL, "model loss")
    pairs = [(n, pk[n], pp[n]) for n in ("embed", "ln_out", "lm_head")] + [
        (n, pk["blocks"][n], pp["blocks"][n]) for n in pk["blocks"]]
    for name, got, want in pairs:
        top = want.grad.abs().max().item()
        err = close_enough(got.grad, want.grad, MODEL_TOL, MODEL_TOL * top,
                           f"model grad {name}")
        worst = max(worst, err / max(top, 1e-30))
    log(f"phase 4 model: 2 layers at 8B widths f32, B={b} S={s}, loss "
        f"{lk.item()} (plain {lp.item()}) and every gradient through the "
        f"flash and fused kernels under remat vs the plain route: worst "
        f"error {worst} of the tensor's largest value (tol {MODEL_TOL}); "
        f"launches {nk}")
    del params, runs, pk, pp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5

def make_engine(label, smi, **knobs):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True,
                              use_decode_kernel=True)
    assert cfg.dtype == torch.bfloat16 and cfg.n_layers == 32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, **ENGINE_KW, **knobs)
    torch.cuda.synchronize()
    log(f"{label} engine: Llama-3-8B bf16, 32 layers, "
        f"{cfg.param_count() / 1e9:.2f}B params, knobs {knobs or 'none'}, "
        f"built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return eng


def closed_loop(stream, prompts, new_tokens, threads=8):
    """``threads`` client threads (8: 2 of the 16 prompts each), every
    reply streamed by ``stream(prompt, new_tokens)``. Returns ([(tokens,
    ttft s, first to last token s)], wall s, process CPU s)."""
    results = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            for j in range(i, len(prompts), threads):
                t_start = time.perf_counter()
                toks, ttft = [], None
                for tok in stream(prompts[j], new_tokens):
                    if ttft is None:
                        ttft = time.perf_counter() - t_start
                    toks.append(tok)
                results[j] = (toks, ttft,
                              time.perf_counter() - t_start - ttft)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0, cpu0 = time.perf_counter(), time.process_time()
    workers = [threading.Thread(target=client, args=(i,))
               for i in range(threads)]
    for th in workers:
        th.start()
    for th in workers:
        th.join(timeout=900)
    wall, cpu = time.perf_counter() - t0, time.process_time() - cpu0
    if errors:
        raise errors[0]
    return results, wall, cpu


def check_replies(label, results, new_tokens, vocab):
    for j, res in enumerate(results):
        if res is None or len(res[0]) != new_tokens:
            raise AssertionError(f"{label} request {j}: "
                                 f"{res and len(res[0])} tokens, expected "
                                 f"{new_tokens}")
        if not all(0 <= t_ < vocab for t_ in res[0]):
            raise AssertionError(f"{label} request {j}: token out of vocab")


def serve(label, eng, prompts, warmup, smi, new_tokens=32):
    """8 client threads, 2 requests each, streamed; after one warm-up
    request. Every kernel count is set to 0 just before the 16 requests
    and read just after. Returns (launches, stats)."""
    from ray_tpu_torch import ops

    def stream(prompt, n):
        return eng.generate_stream(prompt, max_new_tokens=n, timeout=600)

    try:
        # Warm-up request (cuBLAS handles, first launches), then the run.
        eng.generate(warmup, max_new_tokens=8, timeout=600)
        for fn in ops.KERNELS.values():
            fn.launches = 0
        results, wall, _ = closed_loop(stream, prompts, new_tokens)
        launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
        stats = eng.stats()
    finally:
        eng.close()
    check_replies(label, results, new_tokens, eng.cfg.vocab_size)
    admissions = len(prompts) + 1
    if stats["host_syncs"]["prefill"] != admissions:
        raise AssertionError(f"{label}: prefill syncs {stats['host_syncs']}"
                             f" != {admissions} admissions")
    ttfts = sorted(r[1] for r in results)
    decode_tokens = sum(len(r[0]) - 1 for r in results)
    n = len(prompts)
    log(f"  {label} run: {n} requests x {new_tokens} tokens in {wall} s; "
        f"decode tokens/s {decode_tokens / wall} (all tokens/s "
        f"{n * new_tokens / wall}); p50 TTFT {ttfts[n // 2] * 1e3} ms "
        f"(client-side, streamed, upper median of {n}); engine ttft_ms_p50 "
        f"{stats['ttft_ms_p50']}, tpot_ms_p50 {stats['tpot_ms_p50']}; spec "
        f"drafted {stats['spec_drafted']}, accepted {stats['spec_accepted']}"
        f" in {stats['spec_chunks']} verify chunks; on {smi}")
    log(f"  {label} stats: prefix_hits {stats['prefix_hits']}, "
        f"prefix_tokens_reused {stats['prefix_tokens_reused']}, "
        f"host_syncs {stats['host_syncs']}, dispatches "
        f"{stats['dispatches']}, decode_utilization "
        f"{stats['decode_utilization']}")
    log(f"  {label} kernel launches: {launches}")
    stats["decode_tokens_s"] = decode_tokens / wall
    return launches, stats


def phase5_prompts(vocab):
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, vocab, 32).tolist()
    prompts = []
    for i in range(16):
        if i in (0, 1, 8, 9):       # same 32-token prefix, threads 0 and 1
            prompts.append(prefix + rng.randint(0, vocab,
                                                rng.randint(1, 17)).tolist())
        else:
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(16, 49)).tolist())
    # The warm-up leaves the shared prefix resident in the slot that is
    # last in LRU order, so one of the wave's prefix requests must hit it.
    return prompts, prefix + prompts[2][:8]


# Kernels of the training path only: a serving phase launches them 0 times.
TRAIN_ONLY = ("flash_attention", "flash_attention_bwd")


def require_launches(label, launches, expect_zero, may_be_zero=()):
    """Every kernel launched at least once, except those expected not to
    run at all and those the traffic may or may not reach."""
    for name, n in launches.items():
        if name in expect_zero:
            if n != 0:
                raise AssertionError(f"{label}: {name} launched {n} times, "
                                     "expected 0")
        elif n <= 0 and name not in may_be_zero:
            raise AssertionError(f"{label}: kernel {name} was not launched")
    log(f"  {label} launch check passed (expected 0: "
        f"{', '.join(expect_zero) or 'none'}; may be 0: "
        f"{', '.join(may_be_zero) or 'none'})")


def phase_engine(smi):
    eng = make_engine("phase 5", smi)
    prompts, warmup = phase5_prompts(eng.cfg.vocab_size)
    launches, stats = serve("phase 5", eng, prompts, warmup, smi)
    MEASURED["phase5_decode_tokens_s"] = stats["decode_tokens_s"]
    if stats["prefix_hits"] < 1:
        raise AssertionError(f"no prefix-cache hit: {stats}")
    require_launches("phase 5", launches,
                     ("paged_decode_attention",) + TRAIN_ONLY)
    decode_breakdown(eng, smi)
    return launches


def phase_paged_engine(smi):
    eng = make_engine("phase 7a", smi, paged_decode=True)
    prompts, warmup = phase5_prompts(eng.cfg.vocab_size)
    launches, _ = serve("phase 7a", eng, prompts, warmup, smi)
    require_launches("phase 7a", launches, ("decode_attention",) + TRAIN_ONLY)
    decode_breakdown(eng, smi)
    return launches


def phase7b_prompts(vocab):
    """Phase 7b's traffic: (16 prompts, warm-up prompt)."""
    rng = np.random.RandomState(1)
    prompts = []
    for i in range(16):
        kind = i % 8
        if kind < 3:      # 6 repetitive: an 8-token pattern x 6
            prompts.append(rng.randint(0, vocab, 8).tolist() * 6)
        elif kind < 5:    # 4 long: 130-200 tokens, 5-7 prefill chunks
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(130, 201)).tolist())
        else:             # 6 short: 16-48 tokens
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(16, 49)).tolist())
    return prompts, rng.randint(0, vocab, 40).tolist()


def phase_all_knobs(smi):
    eng = make_engine("phase 7b", smi, paged_decode=True,
                      spec_draft_len=SPEC_DRAFT_LEN, prefill_chunk=32,
                      quantize="int8")
    if eng.cache["k"].shape[3] != PAGED_S:
        raise AssertionError(f"phase 7b cache rows {eng.cache['k'].shape} "
                             f"!= {PAGED_S}")
    prompts, warmup = phase7b_prompts(eng.cfg.vocab_size)
    launches, stats = serve("phase 7b", eng, prompts, warmup, smi)
    # The paged kernel runs on the plain ticks only; a tick that drafts
    # verifies through causal attention, so it may launch 0 times here.
    require_launches("phase 7b", launches, ("decode_attention",) + TRAIN_ONLY,
                     may_be_zero=("paged_decode_attention",))
    if stats["spec_chunks"] <= 0:
        raise AssertionError(f"phase 7b: no verify chunk ran: {stats}")
    admissions = len(prompts) + 1
    if stats["dispatches"]["prefill"] <= admissions:
        raise AssertionError(f"phase 7b: {stats['dispatches']} prefill "
                             f"dispatches for {admissions} admissions: "
                             "chunked prefill did not run")
    ratio = stats["weight_bytes"] / (stats["weight_bytes_f32"] / 2)
    if not 0.45 <= ratio <= 0.6:
        raise AssertionError(f"phase 7b: int8 weight bytes are {ratio} of "
                             "bf16's")
    log(f"  phase 7b int8 weights: {stats['weight_bytes']} bytes, {ratio} "
        f"of the same tree in bf16 ({stats['weight_bytes_f32'] // 2})")
    decode_breakdown(eng, smi)
    return launches


def spec_ab(smi):
    """Speculation's own share of tokens/s: phase 7b's traffic and knobs
    without int8, ``spec_draft_len`` 0 and SPEC_DRAFT_LEN in turns (off,
    on, on, off), one engine each, in one call."""
    rates = {"off": [], "on": []}
    accept = []
    for arm in ("off", "on", "on", "off"):
        label = f"spec A/B, spec {arm}"
        eng = make_engine(label, smi, paged_decode=True, prefill_chunk=32,
                          spec_draft_len=SPEC_DRAFT_LEN if arm == "on" else 0)
        prompts, warmup = phase7b_prompts(eng.cfg.vocab_size)
        _, stats = serve(label, eng, prompts, warmup, smi)
        del eng     # free its weights and cache before the next engine
        if arm == "on":
            if stats["spec_chunks"] <= 0:
                raise AssertionError(f"{label}: no verify chunk ran")
            accept.append(stats["spec_accept_rate"])
        rates[arm].append(stats["decode_tokens_s"])
    mean = {a: sum(r) / len(r) for a, r in rates.items()}
    log(f"spec A/B, bf16: decode tokens/s off {rates['off']}, on "
        f"{rates['on']}; on/off {mean['on'] / mean['off']} (means); accept "
        f"rate {accept}; on {smi}")


def decode_breakdown(eng, smi, chunks=3):
    """Where a steady decode chunk's time goes, with all 8 slots live: the
    host's time to enqueue it, its wall time (to a synchronize), and the
    card's busy time from torch.profiler's kernel records, in a separate
    profiled chunk (the profiler slows the host, not the kernels). Runs on
    the closed engine's loop and cache: nothing else touches them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loop, b, k = eng.loop, eng.max_batch, eng.loop.chunk
    gen = _gen(40)
    state = [torch.randint(0, eng.cfg.vocab_size, (b, 1), generator=gen,
                           device="cuda", dtype=torch.int32),
             (64 + 8 * torch.arange(b, device="cuda")).to(torch.int32),
             torch.full((b,), 10_000, dtype=torch.int32, device="cuda"),
             torch.full((b,), -1, dtype=torch.int32, device="cuda"),
             torch.zeros(b, dtype=torch.bool, device="cuda")]

    def chunk():
        out = loop.decode_chunk(eng.cache, *state)
        state[:3] = out[2], out[3], out[4]
        return out

    with torch.no_grad():
        chunk()
        torch.cuda.synchronize()
        host, wall = [], []
        for _ in range(chunks):
            t0 = time.perf_counter()
            chunk()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        # The wrappers' own counts say how many decode kernels the chunk
        # launched; the profiler's records say which kernels ran. CUPTI
        # may drop a record now and then (one decode kernel of 256 in a
        # chunk, one RMSNorm of 65 in a training step), so a trace that
        # holds fewer decode records than launches is taken again.
        for attempt in range(1, 4):
            before = read_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                chunk()
                torch.cuda.synchronize()
            after = read_counts()
            launched = sum(after[n] - before[n] for n in
                           ("decode_attention", "paged_decode_attention"))
            recorded = sum(ev.device_type == DeviceType.CUDA
                           and "decode_kernel" in ev.name.lower()
                           for ev in prof.events())
            if recorded >= launched or recorded == 0:
                break
            log(f"  decode breakdown trace {attempt}: {recorded} decode "
                f"kernel records for {launched} launches; tracing again")
    groups = {"port kernels": 0.0, "matmul": 0.0, "other": 0.0}
    others = {}
    ours = ("decode_kernel", "rms_kernel", "rope_kernel", "swiglu_kernel")
    counts = dict.fromkeys(ours, 0)
    merges = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        name = ev.name.lower()
        merges += "merge" in name
        mine = next((o for o in ours if o in name), None)
        if mine:
            groups["port kernels"] += us
            counts[mine] += 1
        elif any(g in name for g in ("nvjet", "gemm", "gemv", "cutlass",
                                     "xmma", "cublas")):
            groups["matmul"] += us
        else:
            groups["other"] += us
            others[ev.name[:60]] = others.get(ev.name[:60], 0.0) + us
    step_wall = sorted(wall)[len(wall) // 2] / k * 1e3
    step_host = sorted(host)[len(host) // 2] / k * 1e3
    busy = sum(groups.values()) / k / 1e3
    busy_txt = (f"device busy {busy} ms/step (idle share "
                f"{1 - busy / step_wall}); by group ms/step: " + ", ".join(
                    f"{g} {v / k / 1e3}" for g, v in groups.items())
                if busy > 0 else "device busy not measured (the profiler "
                "recorded no kernel)")
    log(f"  decode chunk breakdown, {b} live slots, K={k}, paged "
        f"{eng.paged_decode}, weights {eng.quantize or 'bf16'}: wall "
        f"{step_wall} ms/step, host enqueue {step_host} ms/step, "
        f"{busy_txt}; on {smi}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    log("  largest 'other' kernels, ms/step: " + "; ".join(
        f"{n} {v / k / 1e3}" for n, v in top))
    per_step = {n: c / k for n, c in counts.items()}
    log(f"  port kernel launches per step (profiler): {per_step}; decode "
        f"wrapper launches per step: {launched / k}; kernels named *merge*: "
        f"{merges}")
    # One decode launch a layer, by the wrappers' counts; the profiler's
    # records of the same chunk hold one decode kernel per launch (the
    # splits merge inside it) and no merge kernel. A profiler that
    # recorded nothing proves nothing about the kernels either way.
    if launched != eng.cfg.n_layers * k:
        raise AssertionError(f"decode step: {launched / k} decode launches "
                             f"a step for {eng.cfg.n_layers} layers")
    if busy > 0 and (counts["decode_kernel"] != launched or merges):
        raise AssertionError(f"decode step: {counts['decode_kernel']} decode "
                             f"kernel records for {launched} launches in the "
                             f"last of {attempt} traces, {merges} merge "
                             "kernels")


# ---------------------------------------------------------------- phase 9

def serve_cfg():
    """Llama-3-8B bf16 with the port's kernels, cut to ``SERVE_LAYERS``."""
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LLAMA3_8B, fused_ops=True,
                               use_decode_kernel=True, n_layers=SERVE_LAYERS)


def phase9_engine(cfg, params, label, smi, **knobs):
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, **dict(ENGINE_KW, **knobs))
    log(f"{label} engine: {cfg.n_layers} layers, knobs {knobs or 'none'}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; on "
        f"{smi}")
    return eng


def zero_counts():
    from ray_tpu_torch import ops

    for fn in ops.KERNELS.values():
        fn.launches = 0


def read_counts():
    from ray_tpu_torch import ops

    return {name: fn.launches for name, fn in ops.KERNELS.items()}


def add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def median(xs):
    return sorted(xs)[len(xs) // 2]


def handoff_split(pre, dec, n_pages, page=PAGE):
    """One handoff's transfer re-run on the closed engines' loops and
    caches at ``n_pages`` pages: ms of the export programs (to a stacked
    tensor on the card), of the host fetch, and of the installs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages = [torch.stack(pre.loop.export_page(pre.cache, 0, i * page))
             for i in range(n_pages)]
    stacked = torch.stack(pages)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = stacked.cpu()
    t2 = time.perf_counter()
    for i in range(n_pages):
        dec.loop.install_page(dec.cache, host[i, 0], host[i, 1], 0, i * page)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def phase9a(cfg, params, smi, paged, want=None):
    """9a, disaggregation: a prefill-role and a decode-role engine take
    phase 5's warm-up and 16 prompts one at a time, in order, each through
    prefill_remote -> install_remote; their greedy tokens must equal the
    colocated engine's (``want``, made here when None). Launches are read
    per side. Returns (colocated tokens, launches of the pair)."""
    from ray_tpu_torch.serve.engine.kv_manager import chain_hashes

    tag = "9a paged" if paged else "9a"
    prompts, warmup = phase5_prompts(cfg.vocab_size)
    n_new = 32
    if want is None:
        colo = phase9_engine(cfg, params, f"phase {tag} colocated", smi)
        try:
            want = [colo.generate(p, max_new_tokens=n_new,
                                  timeout=600)["token_ids"]
                    for p in [warmup] + prompts]
        finally:
            colo.close()
    pre = phase9_engine(cfg, params, f"phase {tag} prefill", smi,
                        role="prefill", paged_decode=paged)
    dec = phase9_engine(cfg, params, f"phase {tag} decode", smi,
                        role="decode", paged_decode=paged)
    pair = {}
    try:
        zero_counts()
        handoffs, pre_ms = [], []
        for p in [warmup] + prompts:
            t0 = time.perf_counter()
            h = pre.prefill_remote(p, max_new_tokens=n_new, timeout=600)
            pre_ms.append((time.perf_counter() - t0) * 1e3)
            if not h.get("kv_handoff"):
                raise AssertionError(f"phase {tag}: no handoff for a "
                                     f"{len(p)}-token prompt")
            if h["chain"] != chain_hashes(p, PAGE):
                raise AssertionError(f"phase {tag}: handoff chain differs "
                                     "from the prompt's")
            handoffs.append(h)
        pre_counts = read_counts()
        add_counts(pair, pre_counts)
        zero_counts()
        got, inst_ms = [], []
        for h in handoffs:
            t0 = time.perf_counter()
            got.append(dec.install_remote(h, timeout=600)["token_ids"])
            inst_ms.append((time.perf_counter() - t0) * 1e3)
        dec_counts = read_counts()
        add_counts(pair, dec_counts)
        pre_st, dec_st = pre.stats(), dec.stats()
        if not paged:
            # The same 16 requests from 8 client threads; token counts.
            errors, lens = [], [None] * len(prompts)

            def client(i):
                try:
                    for j in (i, i + 8):
                        h = pre.prefill_remote(prompts[j],
                                               max_new_tokens=n_new,
                                               timeout=600)
                        lens[j] = len(dec.install_remote(
                            h, timeout=600)["token_ids"])
                except BaseException as e:  # noqa: BLE001 — raised below
                    errors.append(e)

            zero_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            wall = time.perf_counter() - t0
            add_counts(pair, read_counts())
            if errors:
                raise errors[0]
            if lens != [n_new] * len(prompts):
                raise AssertionError(f"phase 9a concurrent: token counts "
                                     f"{lens}")
            log(f"  phase 9a concurrent pass: 16 requests x {n_new} tokens "
                f"from 8 threads in {wall} s ({16 * n_new / wall} tokens/s "
                f"through the pair); on {smi}")
    finally:
        pre.close()
        dec.close()
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            raise AssertionError(f"phase {tag} request {i}: tokens differ "
                                 f"from the colocated engine's: {b} vs {a}")
    kernel = "paged_decode_attention" if paged else "decode_attention"
    other = "decode_attention" if paged else "paged_decode_attention"
    require_launches(f"phase {tag} prefill side", pre_counts,
                     ("decode_attention", "paged_decode_attention")
                     + TRAIN_ONLY)
    require_launches(f"phase {tag} decode side", dec_counts,
                     (other,) + TRAIN_ONLY)
    steps = dec_st["dispatches"]["decode"] * dec.loop.chunk
    if dec_counts[kernel] != cfg.n_layers * steps:
        raise AssertionError(f"phase {tag}: {dec_counts[kernel]} {kernel} "
                             f"launches for {steps} decode steps of "
                             f"{cfg.n_layers} layers")
    n_pages = [-(-len(p) // PAGE) for p in [warmup] + prompts]
    page_bytes = (cfg.n_layers * cfg.n_kv_heads * PAGE * cfg.head_dim
                  * cfg.dtype.itemsize * 2)
    if (pre_st["dispatches"]["export_page"] != sum(n_pages)
            or dec_st["dispatches"]["install_page"] != sum(n_pages)
            or pre_st["host_syncs"]["kv_export"] != len(n_pages)):
        raise AssertionError(f"phase {tag}: pages {sum(n_pages)}, exports "
                             f"{pre_st['dispatches']}, installs "
                             f"{dec_st['dispatches']}, syncs "
                             f"{pre_st['host_syncs']}")
    log(f"  phase {tag}: {len(n_pages)} handoffs token-identical to the "
        f"colocated engine; export_page {pre_st['dispatches']['export_page']}"
        f", install_page {dec_st['dispatches']['install_page']}, kv_export "
        f"syncs {pre_st['host_syncs']['kv_export']} (one a handoff); pages "
        f"a handoff {min(n_pages)}-{max(n_pages)} of {page_bytes} bytes (K "
        f"and V), median {median(n_pages) * page_bytes} bytes; decode "
        f"launches {dec_counts[kernel]} = {cfg.n_layers} layers x {steps} "
        f"steps; on {smi}")
    log(f"  phase {tag} client ms per request, median: prefill_remote "
        f"{median(pre_ms)}, install_remote (install + {n_new - 1} decoded "
        f"tokens) {median(inst_ms)}; on {smi}")
    if not paged:
        split = [handoff_split(pre, dec, n) for n in n_pages]
        MEASURED["9a_ms_page"] = median([sum(x) / n
                                         for x, n in zip(split, n_pages)])
        log(f"  phase 9a handoff transfer at each request's page count, "
            f"median ms: export {median([x[0] for x in split])}, host "
            f"{median([x[1] for x in split])}, install "
            f"{median([x[2] for x in split])} (max pages {max(n_pages)}: "
            f"{[round(v, 4) for v in handoff_split(pre, dec, max(n_pages))]})"
            f"; on {smi}")
    return want, pair


def phase9b(cfg, params, smi):
    """9b, the fleet tier: engine F1 serves A_i (a 32-token prefix X_i and
    its own tail) then two disjoint prompts that evict and spill A_i's
    blocks; a fresh engine F2 serves B_i (X_i and another tail), pulling
    X_i's two blocks from the shared store. The fleet-off engine C serves
    A_i then B_i, a local prefix hit at the same depth: B_i's suffix
    prefill reads bitwise the same rows either way, so the tokens must be
    identical. Returns the launches of F1 and F2."""
    from ray_tpu_torch.serve.engine import kv_fleet
    from ray_tpu_torch.serve.engine.kv_manager import chain_hashes

    rng = np.random.RandomState(9)
    v = cfg.vocab_size
    sets = []
    for _ in range(3):
        x = rng.randint(0, v, 32).tolist()
        sets.append((x + rng.randint(0, v, 8).tolist(),
                     x + rng.randint(0, v, 12).tolist(),
                     [rng.randint(0, v, 40).tolist() for _ in range(2)]))
    n_new = 24
    knobs = dict(max_batch=2)
    store = kv_fleet.LocalKVPageStore()
    c = phase9_engine(cfg, params, "phase 9b fleet-off", smi, **knobs)
    try:
        want = [(c.generate(a, max_new_tokens=n_new,
                            timeout=600)["token_ids"],
                 c.generate(b, max_new_tokens=n_new,
                            timeout=600)["token_ids"])
                for a, b, _ in sets]
        c_hits = c.stats()["prefix_hits"]
    finally:
        c.close()
    fleet = dict(knobs, kv_fleet_min_prefix_blocks=0, kv_fleet_store=store)
    f1 = phase9_engine(cfg, params, "phase 9b fleet F1", smi, **fleet)
    f2 = phase9_engine(cfg, params, "phase 9b fleet F2", smi, **fleet)
    counts = {}
    try:
        zero_counts()
        for i, (a, b, evictors) in enumerate(sets):
            got_a = f1.generate(a, max_new_tokens=n_new,
                                timeout=600)["token_ids"]
            for e in evictors:
                f1.generate(e, max_new_tokens=8, timeout=600)
            oid = kv_fleet.page_object_id(f1._fleet_ns,
                                          chain_hashes(a, PAGE)[1])
            deadline = time.monotonic() + 60
            while not store.contains(oid):
                if time.monotonic() > deadline:
                    raise AssertionError("phase 9b: A's blocks never "
                                         f"spilled: {store.stats()}")
                time.sleep(0.01)
            got_b = f2.generate(b, max_new_tokens=n_new,
                                timeout=600)["token_ids"]
            if (got_a, got_b) != want[i]:
                raise AssertionError(f"phase 9b set {i}: fleet tokens "
                                     f"{got_a} / {got_b} vs fleet-off "
                                     f"{want[i]}")
        add_counts(counts, read_counts())
        st1, st2 = f1.stats(), f2.stats()
    finally:
        f1.close()
        f2.close()
    if not (st1["kv_fleet_spilled_blocks"] > 0
            and st2["kv_fleet_pulled_blocks"] > 0
            and st1["kv_fleet_rejects"] == st2["kv_fleet_rejects"] == 0):
        raise AssertionError(f"phase 9b: spilled "
                             f"{st1['kv_fleet_spilled_blocks']}, pulled "
                             f"{st2['kv_fleet_pulled_blocks']}, rejects "
                             f"{st1['kv_fleet_rejects']}/"
                             f"{st2['kv_fleet_rejects']}")
    require_launches("phase 9b", counts,
                     ("paged_decode_attention",) + TRAIN_ONLY)
    # The pull re-run on the closed F2: store get + unpack a page (host),
    # then the install of a two-page run (to the card, synchronized).
    chain = chain_hashes(sets[0][1], PAGE)[:2]
    get_ms, inst_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        pages = [kv_fleet.unpack_page(store.get(
            kv_fleet.page_object_id(f2._fleet_ns, h))) for h in chain]
        t1 = time.perf_counter()
        f2.loop.install_page(
            f2.cache, torch.cat([p_["k_page"] for p_ in pages], dim=2),
            torch.cat([p_["v_page"] for p_ in pages], dim=2), 0, 0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        get_ms.append((t1 - t0) * 1e3 / 2)
        inst_ms.append((t2 - t1) * 1e3 / 2)
    MEASURED["9b_ms_page"] = (median(get_ms), median(inst_ms))
    log(f"  phase 9b: {len(sets)} pulls token-identical to the fleet-off "
        f"engine (its local prefix hits {c_hits}); spilled "
        f"{st1['kv_fleet_spilled_blocks']} blocks (kv_spill syncs "
        f"{st1['host_syncs']['kv_spill']}), pulled "
        f"{st2['kv_fleet_pulled_blocks']} in {st2['kv_fleet_hits']} hits, "
        f"rejects 0; store {store.stats()}; on {smi}")
    log(f"  phase 9b pull ms per page, median of 5: store get + unpack "
        f"{median(get_ms)} (host), install {median(inst_ms)} (to the card, "
        f"in a two-page run); the engine's probe "
        f"kv_fleet_pull_ms_per_page {st2['kv_fleet_pull_ms_per_page']} "
        f"(put + get + unpack), prefill ms per block "
        f"{st2['kv_fleet_prefill_ms_per_block']}, crossover "
        f"{st2['kv_pull_vs_recompute_crossover_blocks']} blocks; on {smi}")
    return counts


def phase9c(smi):
    """9c, preemption, in f32: a one-slot engine runs a long priority-0
    request, a priority-1 arrival parks it; both finish with the tokens
    each gives alone. f32 because the resume re-prefills rows the solo
    run decoded: bf16 rounding of that other path can flip a greedy token
    of random weights, f32's does not in practice (ray_tpu's own test
    holds the identity in f32). Returns the launches of the run."""
    import gc

    from ray_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True,
                              use_decode_kernel=True, dtype=torch.float32)
    params = llama.init_params(cfg, _gen(12))
    eng = phase9_engine(cfg, params, "phase 9c f32", smi, max_batch=1)
    rng = np.random.RandomState(10)
    lo_p = rng.randint(0, cfg.vocab_size, 40).tolist()
    hi_p = rng.randint(0, cfg.vocab_size, 24).tolist()
    try:
        solo_lo = eng.generate(lo_p, max_new_tokens=160,
                               timeout=600)["token_ids"]
        solo_hi = eng.generate(hi_p, max_new_tokens=16,
                               timeout=600)["token_ids"]
        zero_counts()
        t0 = time.perf_counter()
        lo = eng._make_request(lo_p, 160, None, priority=0)
        eng._queue.put(lo)
        deadline = time.monotonic() + 600
        while not any(r is lo for r in eng.scheduler.active):
            if time.monotonic() > deadline:
                raise AssertionError("phase 9c: lo never activated")
            time.sleep(0.001)
        hi = eng._make_request(hi_p, 16, None, priority=1)
        eng._queue.put(hi)
        out_hi = hi.future.result(timeout=600)
        out_lo = lo.future.result(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        st = eng.stats()
    finally:
        eng.close()
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    if out_lo["token_ids"] != solo_lo or out_hi["token_ids"] != solo_hi:
        raise AssertionError(f"phase 9c: preempted tokens differ from the "
                             f"solo runs: {out_lo['token_ids']} vs "
                             f"{solo_lo}; {out_hi['token_ids']} vs {solo_hi}")
    if st["preempts"] < 1 or st["resumes"] < 1 or st["parked"]:
        raise AssertionError(f"phase 9c: preempts {st['preempts']}, resumes "
                             f"{st['resumes']}, parked {st['parked']}")
    require_launches("phase 9c", counts,
                     ("paged_decode_attention",) + TRAIN_ONLY)
    log(f"  phase 9c: Llama-3-8B f32, one slot: preempts {st['preempts']}, "
        f"resumes {st['resumes']}, the parked request's {len(solo_lo)} "
        f"tokens and the preemptor's {len(solo_hi)} identical to their solo "
        f"runs (resumed result 'preempted' {out_lo.get('preempted')}); the "
        f"pair took {wall} s; on {smi}")
    return counts


# Phase 22: the witnesses' flags, restored after the phase.
P22_FLAGS = {"RTPU_DEBUG_RES": "1", "RTPU_DEBUG_CUDA": "1",
             "RTPU_DEBUG_CUDA_SYNC": "error"}
P22_PROMPTS, P22_NEW, P22_BUDGET_S = 8, 16, 30.0
# Kernel rows the witnessed engines must launch (rows 1 and 3-6).
P22_ROWS = ("decode_attention", "rms_norm", "rms_norm_residual", "qk_rope",
            "swiglu")


def phase22(cfg, params, smi):
    """Phase 22: the port's witnesses on the engine's hot path, on phase
    9's tree. For spec off and ``spec_draft_len=SPEC_DRAFT_LEN``: an engine
    with every flag off, then one with ``RTPU_DEBUG_RES``,
    ``RTPU_DEBUG_CUDA`` and ``RTPU_DEBUG_CUDA_SYNC=error`` (every tick
    under ``torch.cuda.set_sync_debug_mode("error")``, which only the
    counted fetch passes), each serving 8 of phase 5's prompts one at a
    time. Holds: one counted sync per fetched decode chunk and per
    admission, signatures within ``ray_tpu``'s budgets, no sync raised in a
    tick (a raise fails the tick's requests), every resource balanced at
    close, tokens identical to the flags-off engine's. The mode is
    process-wide: nothing else uses the card meanwhile. Returns the
    witnessed engines' kernel launches."""
    from ray_tpu_torch.devtools import cuda_debug, res_debug

    t0 = time.perf_counter()
    prompts = phase5_prompts(cfg.vocab_size)[0][:P22_PROMPTS]
    saved = {k: os.environ.get(k) for k in P22_FLAGS}
    launches, parts = {}, []
    try:
        for label, knobs in (("spec off", {}),
                             ("spec on", {"spec_draft_len": SPEC_DRAFT_LEN})):
            for k in P22_FLAGS:
                os.environ.pop(k, None)
            eng = phase9_engine(cfg, params, f"phase 22 {label}, flags off",
                                smi, **knobs)
            try:
                want = [eng.generate(p, max_new_tokens=P22_NEW,
                                     timeout=600)["token_ids"]
                        for p in prompts]
            finally:
                eng.close()
            os.environ.update(P22_FLAGS)
            res_debug.reset()
            cuda_debug.reset()
            eng = phase9_engine(cfg, params, f"phase 22 {label}, witnessed",
                                smi, **knobs)
            zero_counts()
            try:
                got = [eng.generate(p, max_new_tokens=P22_NEW,
                                    timeout=600)["token_ids"]
                       for p in prompts]
                stats = eng.stats()
                programs = eng.loop.program_counts()
            finally:
                eng.close()
            counts = read_counts()
            add_counts(launches, counts)
            syncs = cuda_debug.host_sync_counts()
            over = cuda_debug.over_budget_reports()
            leaks = {k: n for k, n in res_debug.outstanding().items()
                     if k in res_debug.LEAK_KINDS or k == "thread"}
            bad = res_debug.violations()
            same_tokens(f"phase 22 {label}", got, want)
            if syncs.get("engine.decode") != stats["decode_host_syncs"] \
                    or not stats["decode_host_syncs"]:
                raise AssertionError(
                    f"phase 22 {label}: counted decode syncs "
                    f"{syncs.get('engine.decode')} != fetched chunks "
                    f"{stats['decode_host_syncs']}")
            if syncs.get("engine.prefill") != len(prompts) or stats[
                    "host_syncs"]["prefill"] != len(prompts):
                raise AssertionError(
                    f"phase 22 {label}: prefill syncs {syncs}, "
                    f"{stats['host_syncs']} != {len(prompts)} admissions")
            spec = bool(knobs)
            if (programs.get("decode_chunk") != 1
                    or programs.get("prefill", 0) > len(
                        ENGINE_KW["prompt_buckets"])
                    or ("verify_chunk" in programs) != spec
                    or (spec and programs["verify_chunk"] != 1) or over):
                raise AssertionError(f"phase 22 {label}: programs "
                                     f"{programs} over budget: {over}")
            if leaks or bad:
                raise AssertionError(f"phase 22 {label}: resources "
                                     f"unbalanced at close: {leaks}, "
                                     f"violations {bad}")
            require_launches(f"phase 22 {label}", counts,
                             ("paged_decode_attention",) + TRAIN_ONLY)
            if spec and not stats["spec_chunks"]:
                raise AssertionError("phase 22 spec on: no verify chunk ran")
            parts.append(f"{label}: {len(prompts)} requests x {P22_NEW} "
                         f"tokens identical to the flags-off engine's; "
                         f"counted syncs {syncs} for "
                         f"{stats['decode_host_syncs']} fetched chunks; "
                         f"programs {programs}; res_debug counts "
                         f"{res_debug.counts()}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        res_debug.reset()
        cuda_debug.reset()
    wall = time.perf_counter() - t0
    rows = {k: launches[k] for k in P22_ROWS}
    log(f"phase 22 witnesses on the engine ({cfg.n_layers} of Llama-3-8B's "
        f"32 layers), every tick under the sync guard, none raised: "
        + "; ".join(parts) + f"; launches (rows 1, 3-6) {rows}; "
        f"{wall:.1f} s (budget {P22_BUDGET_S} s); on {smi}")
    if wall > P22_BUDGET_S:
        raise AssertionError(f"phase 22 took {wall:.1f} s, over its "
                             f"{P22_BUDGET_S} s budget")
    return launches


def phase_witness(smi):
    """``--witness``: phase 22 alone, on its own 8-layer tree."""
    from ray_tpu_torch.models import llama

    cfg = serve_cfg()
    params = llama.init_params(cfg, _gen(ENGINE_KW["seed"]))
    phase22(cfg, params, smi)


def phase_engine_tier(smi):
    """Phase 9: the engine tier on Llama-3-8B (9a, 9b: bf16 at
    ``SERVE_LAYERS``, one params tree shared by every engine; 9c: f32 at
    full depth). Returns the kernels' launches over the phase's engines."""
    import gc

    from ray_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    cfg = serve_cfg()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, _gen(ENGINE_KW["seed"]))
    launches = {}
    want, pair = phase9a(cfg, params, smi, paged=False)
    add_counts(launches, pair)
    _, pair = phase9a(cfg, params, smi, paged=True, want=want)
    add_counts(launches, pair)
    add_counts(launches, phase9b(cfg, params, smi))
    MEASURED["phase22"] = phase22(cfg, params, smi)
    del params
    add_counts(launches, phase9c(smi))
    require_launches("phase 9", launches, TRAIN_ONLY)
    log(f"phase 9 engine tier: {time.perf_counter() - t0:.1f} s, kernel "
        f"launches {launches}; on {smi}")
    return launches


# --------------------------------------------------------------- phase 12

SERVE_NAME = "llm"
SERVE_NEW = 32


def serve_deploy(cfg, params, n_replicas, smi, **knobs):
    """``serve.run(build_llm_deployment(...))`` on a fresh local runtime:
    Llama-3-8B over ``params`` (one tree, passed by reference to every
    replica), phase 5's engine configuration plus ``knobs``. Returns the
    handle."""
    import ray_tpu_torch
    from ray_tpu_torch import serve as rserve
    from ray_tpu_torch.serve.llm import build_llm_deployment

    ray_tpu_torch.init(local_mode=True)
    t0 = time.perf_counter()
    h = rserve.run(build_llm_deployment(
        SERVE_NAME, num_replicas=n_replicas, use_gpu=True,
        engine_kwargs=dict(ENGINE_KW, cfg=cfg, params=params, **knobs)))
    log(f"  deployment '{SERVE_NAME}': {n_replicas} replica(s), knobs "
        f"{knobs or 'none'}, up in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; on "
        f"{smi}")
    return h


def serve_teardown():
    """serve.shutdown() (replicas drained and killed, their engines
    closed), then the runtime; the engines' caches are freed with it."""
    import gc

    import ray_tpu_torch
    from ray_tpu_torch import serve as rserve

    try:
        rserve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def replica_stats():
    """Each replica's own ``engine.stats()``, in the controller's order."""
    import ray_tpu_torch

    controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
    replicas = ray_tpu_torch.get(
        controller.get_replicas.remote(SERVE_NAME), timeout=60)
    return ray_tpu_torch.get(
        [r.handle_request.remote("stats", (), {}) for r in replicas],
        timeout=60)


def handle_request(h, prompt, stream=False):
    """One request through the handle. Returns (tokens, reply or None,
    wall ms)."""
    req = {"prompt_ids": prompt, "max_new_tokens": SERVE_NEW}
    t0 = time.perf_counter()
    if stream:
        toks = list(h.options("stream", stream=True).remote(req))
        return toks, None, (time.perf_counter() - t0) * 1e3
    out = h.remote(req).result(timeout=600)
    return out["token_ids"], out, (time.perf_counter() - t0) * 1e3


def wait_resident(h, prompt, timeout=60.0):
    """Until the router's pushed snapshots show ``prompt``'s complete
    prefix blocks resident on some replica (the controller sweeps the
    replicas once per reconcile period)."""
    from ray_tpu_torch.serve.engine.kv_manager import chain_hashes

    chain = set(chain_hashes(prompt, PAGE))
    router, deadline = h._router, time.monotonic() + timeout
    while time.monotonic() < deadline:
        with router._lock:
            fresh = router._fresh_loads()
            if fresh and any(chain <= s.get("prefix_hashes", frozenset())
                             for s in fresh.values()):
                return
        time.sleep(0.02)
    raise AssertionError(f"phase 12: {len(prompt)}-token prompt never "
                         "reported resident by a replica")


def handle_closed_loop(label, h, prompts, smi, vocab):
    """Phase 5's 16 prompts from 8 client threads through the handle,
    streamed. Returns the numbers of the run."""
    def stream(prompt, n):
        return h.options("stream", stream=True).remote(
            {"prompt_ids": prompt, "max_new_tokens": n})

    results, wall, cpu = closed_loop(stream, prompts, SERVE_NEW)
    return closed_loop_numbers(label, results, wall, cpu, replica_stats(),
                               smi, vocab)


def closed_loop_numbers(label, results, wall, cpu, stats, smi, vocab,
                        threads=8):
    """The closed loop's numbers. TPOT is client-side: a request's first
    to last streamed token over its 31 gaps (the engines' own
    ``tpot_ms_p50`` mixes in the one-at-a-time requests they served
    before). ``cpu_cores`` is the process's CPU seconds over the wall:
    near 1.0, the Python threads take turns on one core."""
    check_replies(label, results, SERVE_NEW, vocab)
    n = len(results)
    ttfts = sorted(r[1] for r in results)
    tpots = sorted(r[2] / (SERVE_NEW - 1) for r in results)
    decode_tokens = sum(len(r[0]) - 1 for r in results)
    out = {"requests_s": n / wall, "decode_tokens_s": decode_tokens / wall,
           "tokens_s": n * SERVE_NEW / wall,
           "ttft_ms_p50": ttfts[n // 2] * 1e3,
           "tpot_ms_p50": tpots[n // 2] * 1e3, "cpu_cores": cpu / wall,
           "engine_tpot_ms_p50": [s["tpot_ms_p50"] for s in stats],
           "requests": [s["requests"] for s in stats], "wall_s": wall}
    log(f"  {label}: {n} requests x {SERVE_NEW} tokens from {threads} "
        f"threads in "
        f"{wall} s: {out['requests_s']} requests/s, decode tokens/s "
        f"{out['decode_tokens_s']} (all tokens/s {out['tokens_s']}), p50 "
        f"TTFT {out['ttft_ms_p50']} ms, p50 TPOT {out['tpot_ms_p50']} ms "
        f"(client-side, streamed, upper medians of {n}); process CPU "
        f"{out['cpu_cores']} cores; engine tpot_ms_p50 (lifetime) "
        f"{out['engine_tpot_ms_p50']}, requests by engine (warm-up "
        f"included) {out['requests']}; on {smi}")
    return out


def direct_sequence(cfg, params, seq, label, smi, **knobs):
    """A direct ``LLMEngine`` on the same params fed ``seq`` in order, one
    request at a time. Returns (tokens per request, ms per request)."""
    eng = phase9_engine(cfg, params, label, smi, **knobs)
    toks, ms = [], []
    try:
        for p in seq:
            t0 = time.perf_counter()
            toks.append(eng.generate(p, max_new_tokens=SERVE_NEW,
                                     timeout=600)["token_ids"])
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        eng.close()
    return toks, ms


def same_tokens(label, got, want):
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            raise AssertionError(f"{label} request {i}: tokens differ from "
                                 f"the direct engine's: {b} vs {a}")
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} replies for "
                             f"{len(want)} requests")


def echo_hop(calls=200, keep=False):
    """The serve hop alone, in the running runtime: an echo deployment's
    round trip through the handle, router and replica actor, no engine.
    Returns (median, p90) ms; ``keep`` leaves the deployment up."""
    from ray_tpu_torch import serve as rserve

    @rserve.deployment(name="echo")
    class Echo:
        def __call__(self, x):
            return x

    h = rserve.run(Echo.bind())
    ms = []
    for i in range(calls):
        t0 = time.perf_counter()
        h.remote(i).result(timeout=60)
        ms.append((time.perf_counter() - t0) * 1e3)
    if not keep:
        rserve.delete("echo")
    return median(ms), sorted(ms)[calls * 9 // 10]


def phase12a_one(cfg, params, smi, seq, want, direct_ms, prompts):
    """One replica: the sequence's tokens equal the direct engine's, the
    serve hop's ms a request (paired with the direct engine's times on the
    same requests), then the closed loop. Returns (launches, numbers)."""
    h = serve_deploy(cfg, params, 1, smi)
    try:
        zero_counts()
        got, ms = [], []
        for p in seq:
            toks, _, t = handle_request(h, p)
            got.append(toks)
            ms.append(t)
        launches = read_counts()
        same_tokens("phase 12a, one replica", got, want)
        hop = sorted(a - b for a, b in zip(ms, direct_ms))
        echo = echo_hop()
        log(f"  phase 12a one replica: {len(seq)} requests one at a time, "
            f"tokens identical to the direct engine's; ms a request, "
            f"median: handle {median(ms)}, direct {median(direct_ms)}; "
            f"handle - direct, paired by request: median {median(hop)}, "
            f"quartiles {hop[len(hop) // 4]} / {hop[3 * len(hop) // 4]}; an "
            f"echo deployment's round trip (the hop alone, engine idle): "
            f"median {echo[0]} ms, p90 {echo[1]} ms; on {smi}")
        zero_counts()
        numbers = handle_closed_loop("phase 12a one replica, closed loop",
                                     h, prompts, smi, cfg.vocab_size)
        add_counts(launches, read_counts())
        numbers["hop_ms"] = median(hop)
        numbers["echo_ms"] = echo[0]
    finally:
        serve_teardown()
    return launches, numbers


def phase12a_two(cfg, params, smi, seq, prompts):
    """Two replicas: the sequence one request at a time, then streams
    against replies, then four prompts sharing a 48-token prefix, each
    request's serving replica read off the replicas' own stats; every
    reply is then checked against a direct engine fed that replica's
    requests in the same order. Then the closed loop. Returns (launches,
    numbers)."""
    rng = np.random.RandomState(12)
    shared = rng.randint(0, cfg.vocab_size, 48).tolist()
    h = serve_deploy(cfg, params, 2, smi)
    log_ = []  # (prompt, tokens, replica, kind)
    try:
        zero_counts()
        before = [s["requests"] for s in replica_stats()]

        def send(p, kind):
            toks, out, _ = handle_request(h, p, stream=kind == "stream")
            nonlocal before
            after = [s["requests"] for s in replica_stats()]
            moved = [i for i in range(2) if after[i] != before[i]]
            if len(moved) != 1 or after[moved[0]] != before[moved[0]] + 1:
                raise AssertionError(f"phase 12a: requests by replica "
                                     f"{before} -> {after}")
            before = after
            log_.append((p, toks, moved[0], kind))
            return toks, out

        for p in seq:
            send(p, "reply")
        # Streams against replies: fresh prompts, so after the first
        # reply one replica alone holds each, and the router sends the
        # stream and the second reply there (the same cached prefix, the
        # same computation).
        for n in (20, 29, 40):
            p = rng.randint(0, cfg.vocab_size, n).tolist()
            send(p, "reply")
            wait_resident(h, p)
            streamed, _ = send(p, "stream")
            again, _ = send(p, "reply")
            if streamed != again:
                raise AssertionError(f"phase 12a: streamed {streamed} vs "
                                     f"reply {again}")
        cached = []
        for i in range(4):
            _, out = send(shared + rng.randint(0, cfg.vocab_size,
                                               5).tolist(), "reply")
            cached.append(out["cached_prefix_len"])
            if i == 0:
                wait_resident(h, shared)
        if cached[0] != 0 or min(cached[1:]) < 48:
            raise AssertionError(f"phase 12a: cached_prefix_len {cached}; "
                                 "the three after the first must reuse the "
                                 "48-token prefix")
        routes = h._router.stats()
        launches = read_counts()
        log(f"  phase 12a two replicas: {len(log_)} requests one at a time "
            f"(replies {sum(k == 'reply' for *_, k in log_)}, streams "
            f"{sum(k == 'stream' for *_, k in log_)}), by replica "
            f"{[sum(r == i for _, _, r, _ in log_) for i in range(2)]}; "
            f"streams equal their replies; shared 48-token prefix: "
            f"cached_prefix_len {cached}; router {routes}; on {smi}")
        zero_counts()
        numbers = handle_closed_loop("phase 12a two replicas, closed loop",
                                     h, prompts, smi, cfg.vocab_size)
        add_counts(launches, read_counts())
        if min(numbers["requests"]) < 1:
            raise AssertionError(f"phase 12a: a replica served nothing: "
                                 f"{numbers['requests']}")
    finally:
        serve_teardown()
    for r in range(2):
        mine = [e for e in log_ if e[2] == r]
        want, _ = direct_sequence(cfg, params, [e[0] for e in mine],
                                  f"phase 12a replay of replica {r}", smi)
        same_tokens(f"phase 12a replica {r}", [e[1] for e in mine], want)
    log(f"  phase 12a two replicas: every reply and stream identical to a "
        f"direct engine fed its replica's requests in order; on {smi}")
    return launches, numbers


def phase12b(cfg, params, smi, seq, want):
    """One replica with paged_decode: the sequence's tokens equal the
    direct (contiguous) engine's; the paged kernel runs, the contiguous one
    does not."""
    h = serve_deploy(cfg, params, 1, smi, paged_decode=True)
    try:
        zero_counts()
        got = [handle_request(h, p)[0] for p in seq]
        launches = read_counts()
    finally:
        serve_teardown()
    same_tokens("phase 12b", got, want)
    require_launches("phase 12b", launches, ("decode_attention",)
                     + TRAIN_ONLY)
    log(f"  phase 12b paged: {len(seq)} requests, tokens identical to the "
        f"direct contiguous engine's; on {smi}")
    return launches


def phase_serve(smi, then=None):
    """Phase 12: the engine served through its deployment,
    ``ray_tpu_torch.init(local_mode=True)`` -> ``serve.run(
    build_llm_deployment(...))`` -> ``handle.remote``, Llama-3-8B bf16
    at ``SERVE_LAYERS``. Returns the kernels' launches over the deployments'
    traffic (the direct engines' comparison runs not counted) and the
    closed loops' numbers (``direct``, ``pair``, ``one``, ``two``), with
    ``then(cfg, params)``'s result under ``then``: a later phase run on
    phase 12's tree before it is freed."""
    import gc

    from ray_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = serve_cfg()
    params = llama.init_params(cfg, _gen(ENGINE_KW["seed"]))
    prompts, warmup = phase5_prompts(cfg.vocab_size)
    seq = [warmup] + prompts
    want, direct_ms = direct_sequence(cfg, params, seq,
                                      "phase 12 direct", smi)
    eng = phase9_engine(cfg, params, "phase 12 direct, closed loop", smi)
    try:
        eng.generate(warmup, max_new_tokens=8, timeout=600)

        def stream(prompt, n):
            return eng.generate_stream(prompt, max_new_tokens=n,
                                       timeout=600)

        results, wall, cpu = closed_loop(stream, prompts, SERVE_NEW)
        direct = closed_loop_numbers("phase 12 direct engine, closed loop",
                                     results, wall, cpu, [eng.stats()], smi,
                                     cfg.vocab_size)
    finally:
        eng.close()
    # Two engines in this one process and no serve: the closed loop's
    # requests alternate between them, as two replicas would take them.
    engines = [phase9_engine(cfg, params, f"phase 12 direct pair, engine "
                             f"{i}", smi) for i in range(2)]
    try:
        owner = {tuple(p): engines[j % 2] for j, p in enumerate(prompts)}
        for e in engines:
            e.generate(warmup, max_new_tokens=8, timeout=600)

        def pair_stream(prompt, n):
            return owner[tuple(prompt)].generate_stream(
                prompt, max_new_tokens=n, timeout=600)

        results, wall, cpu = closed_loop(pair_stream, prompts, SERVE_NEW)
        pair = closed_loop_numbers(
            "phase 12 two direct engines, closed loop", results, wall, cpu,
            [e.stats() for e in engines], smi, cfg.vocab_size)
    finally:
        for e in engines:
            e.close()
    launches = {}
    a1, one = phase12a_one(cfg, params, smi, seq, want, direct_ms, prompts)
    a2, two = phase12a_two(cfg, params, smi, seq, prompts)
    add_counts(launches, a1)
    add_counts(launches, a2)
    require_launches("phase 12a", launches,
                     ("paged_decode_attention",) + TRAIN_ONLY)
    add_counts(launches, phase12b(cfg, params, smi, seq, want))
    t12 = time.perf_counter() - t0
    after = then(cfg, params) if then else None
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12 serve: decode tokens/s direct {direct['decode_tokens_s']}"
        f" (two direct engines {pair['decode_tokens_s']}), one replica "
        f"{one['decode_tokens_s']}, two replicas {two['decode_tokens_s']} "
        f"(two/one {two['decode_tokens_s'] / one['decode_tokens_s']}); "
        "requests/s "
        f"{direct['requests_s']}, {one['requests_s']}, {two['requests_s']}; "
        f"p50 TTFT ms {direct['ttft_ms_p50']}, {one['ttft_ms_p50']}, "
        f"{two['ttft_ms_p50']}; p50 TPOT ms {direct['tpot_ms_p50']}, "
        f"{one['tpot_ms_p50']}, {two['tpot_ms_p50']}; process CPU cores "
        f"{direct['cpu_cores']}, {one['cpu_cores']}, {two['cpu_cores']}; "
        f"handle - direct {one['hop_ms']} ms a request (median), echo hop "
        f"{one['echo_ms']} ms; "
        f"{t12:.1f} s; kernel launches {launches}; on {smi}")
    return launches, {"direct": direct, "pair": pair, "one": one,
                      "two": two, "then": after}


# --------------------------------------------------------------- phase 13

CLUSTER_NAME = "llm13"


def counting_server():
    """``LLMServer`` with three methods of the script's own, reached
    through the replica actor's ``handle_request``: the kernel counters,
    and the pid, card bytes allocated and CPU seconds of the replica's
    process. Defined in a
    function, so the cluster ships the class by value to the replica's
    worker process."""
    from ray_tpu_torch.serve.llm import LLMServer

    class CountingLLMServer(LLMServer):
        def __init__(self, **kw):
            self._kw = kw
            super().__init__(**kw)

        def fresh_engine(self):
            """Close the engine and build it again from the same kwargs
            (weights drawn again from the seed): a cache history that
            starts empty, as a direct engine's does."""
            import gc

            from ray_tpu_torch.serve.llm import LLMEngine

            self.engine.close()
            self.engine = None
            gc.collect()
            torch.cuda.empty_cache()
            self.engine = LLMEngine(**self._kw)
            return self.engine.stats()["engine"]

        def publish_metrics(self):
            """Publish this process's metric registry to the head's KV
            now (the report loop's own step)."""
            from ray_tpu_torch.core.runtime_context import require_runtime

            require_runtime().publish_metrics()

        def zero_launches(self):
            from ray_tpu_torch import ops

            for fn in ops.KERNELS.values():
                fn.launches = 0

        def launches(self):
            from ray_tpu_torch import ops

            return {name: fn.launches for name, fn in ops.KERNELS.items()}

        def process(self):
            return (os.getpid(), torch.cuda.memory_allocated(),
                    time.process_time())

    return CountingLLMServer


def cluster_deploy(cfg, n_replicas, smi, gpu):
    """``build_llm_deployment(use_gpu=True, engine_kwargs=dict(ENGINE_KW,
    cfg=cfg, seed=...))`` on the running cluster, its replicas asking
    ``{"GPU": gpu}`` each and built on ``counting_server()`` in place of
    ``LLMServer``: each replica's process draws its own weights on the
    card from the seed, so no tree travels. Returns (handle, replicas)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve as rserve
    from ray_tpu_torch.serve.llm import build_llm_deployment

    dep = build_llm_deployment(
        CLUSTER_NAME, num_replicas=n_replicas, use_gpu=True,
        engine_kwargs=dict(ENGINE_KW, cfg=cfg))
    dep = dep.options(ray_actor_options={"resources": {"GPU": gpu}})
    dep._cls = counting_server()
    t0 = time.perf_counter()
    h = rserve.run(dep)
    controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
    replicas = ray_tpu_torch.get(
        controller.get_replicas.remote(CLUSTER_NAME), timeout=120)
    procs = [p[:2] for p in replica_call(replicas, "process")]
    log(f"  cluster deployment '{CLUSTER_NAME}': {n_replicas} replica(s) "
        f"of {{'GPU': {gpu}}} each, up in {time.perf_counter() - t0:.1f} s;"
        f" replica processes (pid, card bytes allocated): {procs}; driver "
        f"pid {os.getpid()}; on {smi}")
    tree = cfg.param_count() * 2
    if any(pid == os.getpid() or mem < tree for pid, mem in procs) or len(
            {pid for pid, _ in procs}) != n_replicas:
        raise AssertionError(f"phase 13: each replica must hold its "
                             f"{tree}-byte tree in a worker process of its "
                             f"own: {procs}")
    return h, replicas, procs


def replica_call(replicas, method, *args):
    import ray_tpu_torch

    return ray_tpu_torch.get(
        [r.handle_request.remote(method, args, {}) for r in replicas],
        timeout=120)


def compute_apps():
    """``nvidia-smi``'s compute apps as [(pid, used MiB)], and the card's
    used MiB. In a container the pids may be another namespace's (the
    chip machine lists every process as pid 1), so callers match pids
    only when they are ours."""
    def query(*args):
        return subprocess.run(
            ["nvidia-smi", *args, "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()

    apps = []
    for line in query("--query-compute-apps=pid,used_memory"):
        pid, mib = (x.strip() for x in line.split(","))
        apps.append((int(pid), float(mib)))
    return apps, float(query("--query-gpu=memory.used")[0])


def alive(pid):
    """True while ``pid`` runs (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def cluster_closed_loop(label, h, replicas, prompts, smi, vocab,
                        threads=8):
    """The closed loop through the handle; ``cpu_cores`` is the driver's,
    ``replica_cpu_cores`` each replica process's CPU seconds over the
    loop's wall time. With 8 threads the 16 requests keep one engine's 8
    slots full; with 16, two engines' 16."""
    def stream(prompt, n):
        return h.options("stream", stream=True).remote(
            {"prompt_ids": prompt, "max_new_tokens": n})

    cpu0 = [p[2] for p in replica_call(replicas, "process")]
    results, wall, cpu = closed_loop(stream, prompts, SERVE_NEW, threads)
    cpu1 = [p[2] for p in replica_call(replicas, "process")]
    numbers = closed_loop_numbers(label, results, wall, cpu,
                                  replica_call(replicas, "stats"), smi,
                                  vocab, threads)
    numbers["replica_cpu_cores"] = [(b - a) / wall
                                    for a, b in zip(cpu0, cpu1)]
    log(f"  {label}: replica processes' CPU cores over the loop "
        f"{numbers['replica_cpu_cores']}")
    return numbers


def phase13a(smi, name):
    """The runtime on the card: ``init()`` counts the card, a GPU task
    sees it, a CPU task's ``resolve_device(None)`` raises, a CUDA bf16
    tensor round-trips bit-equal through put/get and a GPU task."""
    import ray_tpu_torch

    res = ray_tpu_torch.cluster_resources()
    if res.get("GPU") != 1.0:
        raise AssertionError(f"phase 13a: cluster_resources() {res}")

    @ray_tpu_torch.remote(num_gpus=1)
    def card_name(x):
        return torch.cuda.get_device_name(0), os.getpid(), x.device.type, x

    @ray_tpu_torch.remote
    def cpu_resolve():
        try:
            ray_tpu_torch.resolve_device(None)
        except RuntimeError as e:
            return os.getpid(), str(e)
        return os.getpid(), None

    t = _randn((1024, 4096), torch.bfloat16, 130)
    t0 = time.perf_counter()
    back = ray_tpu_torch.get(ray_tpu_torch.put(t), timeout=120)
    put_ms = (time.perf_counter() - t0) * 1e3
    got_name, gpu_pid, where, echoed = ray_tpu_torch.get(
        card_name.remote(t), timeout=300)
    cpu_pid, refused = ray_tpu_torch.get(cpu_resolve.remote(), timeout=300)
    bits = t.view(torch.int16)
    if not (back.is_cuda and torch.equal(back.view(torch.int16), bits)):
        raise AssertionError("phase 13a: put/get changed a CUDA tensor")
    if not (where == "cuda" and echoed.is_cuda
            and torch.equal(echoed.view(torch.int16), bits)):
        raise AssertionError("phase 13a: a GPU task's argument or return "
                             "changed a CUDA tensor")
    if got_name != name or refused is None:
        raise AssertionError(f"phase 13a: GPU task saw {got_name!r}; CPU "
                             f"task's resolve_device: {refused!r}")
    MEASURED["13a_put_get_ms"] = put_ms
    log(f"phase 13a runtime: cluster_resources {res}; a GPU task (pid "
        f"{gpu_pid}) sees {got_name}; a CPU task (pid {cpu_pid}) "
        f"resolve_device(None) raises ({refused!r}); a [1024, 4096] bf16 "
        f"CUDA tensor bit-equal through put/get ({put_ms:.1f} ms) and a "
        f"GPU task's argument and return; on {smi}")
    return [gpu_pid, cpu_pid]


def phase13b(cfg, smi, seq, prompts, want, direct_ms):
    """One replica in a worker process: the sequence's tokens equal a
    direct engine's in this process fed the same sequence (the first pass
    of ``want``, in ``direct_ms``), the closed loop, an echo deployment's
    round trip across processes; then phase 18 on the same replica.
    Returns (launches, numbers, pids, phase 18's launches)."""
    from ray_tpu_torch import serve as rserve

    h, replicas, procs = cluster_deploy(cfg, 1, smi, 1.0)
    n = len(seq)
    try:
        replica_call(replicas, "zero_launches")
        got, ms = [], []
        for p in seq:
            toks, _, t = handle_request(h, p)
            got.append(toks)
            ms.append(t)
        same_tokens("phase 13b, one replica", got, want[:n])
        numbers = cluster_closed_loop("phase 13b one replica in a worker "
                                      "process, closed loop", h, replicas,
                                      prompts, smi, cfg.vocab_size)
        numbers["saturated"] = cluster_closed_loop(
            "phase 13b one replica, 16 threads", h, replicas, prompts, smi,
            cfg.vocab_size, threads=16)
        (launches,) = replica_call(replicas, "launches")
        echo = echo_hop()
        numbers["echo_ms"] = echo[0]
        log(f"  phase 13b one replica: {len(seq)} requests one at a time, "
            f"tokens identical to the direct engine's; ms a request, "
            f"median: handle {median(ms)}, direct {median(direct_ms[:n])}; "
            f"an echo deployment's round trip across processes: median "
            f"{echo[0]} ms, p90 {echo[1]} ms; replica launches {launches}; "
            f"on {smi}")
        launches18, proxy_pid = phase18(cfg, smi, replicas, procs[0][0],
                                        seq, prompts, want, ms, numbers)
    finally:
        rserve.delete(CLUSTER_NAME)
    return (launches, numbers, [pid for pid, _ in procs] + [proxy_pid],
            launches18)


def phase13c(cfg, params, smi, seq, prompts):
    """Two replicas of ``{"GPU": 0.5}`` in two worker processes on the one
    card: both hold the 8B tree at once (``nvidia-smi``), the sequence one
    request at a time (each request's replica read off the replicas'
    ``stats()``), the closed loop, each replica's launches; every reply
    then held to a direct engine fed that replica's requests in order.
    Returns (launches by replica, numbers, pids)."""
    from ray_tpu_torch import serve as rserve

    h, replicas, procs = cluster_deploy(cfg, 2, smi, 0.5)
    log_ = []
    try:
        apps, used = compute_apps()
        tree_mib = cfg.param_count() * 2 / 2**20
        here_mib = torch.cuda.memory_allocated() / 2**20
        listed = {pid for pid, _ in apps}
        ours = [pid for pid, _ in procs if pid in listed]
        log(f"  phase 13c nvidia-smi: compute apps (pid, MiB) {apps}, card "
            f"memory used {used} MiB; the replicas' pids {procs} "
            f"({'listed' if ours else 'not in this pid namespace'}); the 8B "
            f"tree is {tree_mib:.0f} MiB, this process holds "
            f"{here_mib:.0f} MiB; on {smi}")
        # Three processes at least hold the card (this one and the two
        # replicas), and the card holds two trees beyond this process's.
        if (len(apps) < 3 or used < here_mib + 2 * tree_mib
                or (ours and len(ours) != 2)):
            raise AssertionError(f"phase 13c: nvidia-smi must show both "
                                 f"replica processes holding the tree: "
                                 f"{apps}, {used} MiB used, vs {procs}")
        replica_call(replicas, "zero_launches")
        before = [s["requests"] for s in replica_call(replicas, "stats")]
        for p in seq:
            toks, _, _ = handle_request(h, p)
            after = [s["requests"] for s in replica_call(replicas, "stats")]
            moved = [i for i in range(2) if after[i] != before[i]]
            if len(moved) != 1 or after[moved[0]] != before[moved[0]] + 1:
                raise AssertionError(f"phase 13c: requests by replica "
                                     f"{before} -> {after}")
            before = after
            log_.append((p, toks, moved[0]))
        numbers = cluster_closed_loop("phase 13c two replicas in two worker "
                                      "processes, closed loop", h, replicas,
                                      prompts, smi, cfg.vocab_size)
        numbers["saturated"] = cluster_closed_loop(
            "phase 13c two replicas, 16 threads", h, replicas, prompts, smi,
            cfg.vocab_size, threads=16)
        if min(numbers["requests"]) < 1:
            raise AssertionError(f"phase 13c: a replica served nothing: "
                                 f"{numbers['requests']}")
        launches = replica_call(replicas, "launches")
        log(f"  phase 13c: {len(seq)} requests one at a time, by replica "
            f"{[sum(r == i for *_, r in log_) for i in range(2)]}; launches "
            f"by replica process {launches}; on {smi}")
    finally:
        rserve.delete(CLUSTER_NAME)
    for r in range(2):
        mine_seq = [e for e in log_ if e[2] == r]
        want, _ = direct_sequence(cfg, params, [e[0] for e in mine_seq],
                                  f"phase 13c replay of replica {r}", smi)
        same_tokens(f"phase 13c replica {r}", [e[1] for e in mine_seq],
                    want)
    log(f"  phase 13c: every reply identical to a direct engine fed its "
        f"replica's requests in order; on {smi}")
    return launches, numbers, [pid for pid, _ in procs]


def phase_cluster(smi, name, phase12=None, only14=False):
    """Phases 13 and 14 on one cluster runtime on the card.
    ``ray_tpu_torch.init()`` (a head, a node manager, worker processes over
    the shm store), then Llama-3-8B replicas served from worker processes:
    phase 13's colocated replicas, then phase 14's disaggregated pair and
    fleet pair (``only14``: phase 14 alone, its direct engine run here).
    Returns the kernels' launches over each phase's deployments' traffic,
    summed over the replica processes (the direct engines' comparison runs
    not counted): (phase 13's or None, phase 14's, phase 18's or None)."""
    import gc

    import ray_tpu_torch
    from ray_tpu_torch import serve as rserve
    from ray_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = serve_cfg()
    prompts, warmup = phase5_prompts(cfg.vocab_size)
    seq = [warmup] + prompts
    apps_before = len(compute_apps()[0])
    with warm_flags():
        rt = ray_tpu_torch.init(object_store_memory=2 << 30)
    # The replicas draw the same tree from ENGINE_KW's seed on their card;
    # the driver's direct engines read one drawn here. One direct engine
    # takes the sequence twice: 13b holds its replica to the first pass,
    # 14a its replies and streams to both.
    pids, one, params = [], None, None
    try:
        pids += warm_workers("phase 13-14",
                             2 * 3 if only14 else WARM_GPU_13)
        params = llama.init_params(cfg, _gen(ENGINE_KW["seed"]))
        want, direct_ms = direct_sequence(cfg, params, seq + seq,
                                          "phase 13-14 direct", smi)
        if not only14:
            pids += phase13a(smi, name)
            b_launches, one, b_pids, launches18 = phase13b(
                cfg, smi, seq, prompts, want, direct_ms)
            c_launches, two, c_pids = phase13c(cfg, params, smi, seq,
                                               prompts)
            pids += b_pids + c_pids
        t14 = time.perf_counter()
        total14, d_pids = phase14(cfg, params, smi, seq, prompts, want, one)
        t14 = time.perf_counter() - t14
        pids += d_pids
        spawn_line("phase 13-14", rt)
    finally:
        procs = list(rt._procs)
        try:
            rserve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    pids += [p.pid for p in procs]
    deadline = time.monotonic() + 30
    while any(alive(pid) for pid in pids):
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 13: cluster processes outlived "
                                 f"shutdown: {[p for p in pids if alive(p)]}")
        time.sleep(0.1)
    apps, _ = compute_apps()
    if len(apps) > apps_before or any(pid in pids for pid, _ in apps):
        raise AssertionError(f"phase 13: the card still holds memory of "
                             f"cluster processes: {apps} (before the "
                             f"cluster: {apps_before} app(s))")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phases 13-14 teardown left no process of {len(set(pids))} and no "
        f"compute app of theirs; phase 14 took {t14:.1f} s of "
        f"{time.perf_counter() - t0:.1f} s; on {smi}")
    if only14:
        return None, total14, None
    for launches in [b_launches] + c_launches:
        require_launches("phase 13 replica process", launches,
                         ("paged_decode_attention",) + TRAIN_ONLY)
    total = {}
    for launches in [b_launches] + c_launches:
        add_counts(total, launches)
    beside = ""
    if phase12 is not None:
        beside = (f"; phase 12 in this call (one process, local runtime): "
                  f"one replica {phase12['one']['decode_tokens_s']} decode "
                  f"tokens/s, TTFT {phase12['one']['ttft_ms_p50']} ms, TPOT "
                  f"{phase12['one']['tpot_ms_p50']} ms, CPU cores "
                  f"{phase12['one']['cpu_cores']}; two replicas "
                  f"{phase12['two']['decode_tokens_s']}, "
                  f"{phase12['two']['ttft_ms_p50']}, "
                  f"{phase12['two']['tpot_ms_p50']}, "
                  f"{phase12['two']['cpu_cores']}; two direct engines "
                  f"{phase12['pair']['decode_tokens_s']}, "
                  f"{phase12['pair']['ttft_ms_p50']}, "
                  f"{phase12['pair']['tpot_ms_p50']}, "
                  f"{phase12['pair']['cpu_cores']}; echo hop in one process "
                  f"{phase12['one']['echo_ms']} ms")
    log(f"phase 13 cluster ({SERVE_LAYERS} of Llama-3-8B's 32 layers): "
        f"decode tokens/s one replica (worker process) "
        f"{one['decode_tokens_s']}, two replicas (two processes) "
        f"{two['decode_tokens_s']} (two/one "
        f"{two['decode_tokens_s'] / one['decode_tokens_s']}); from 16 "
        f"threads {one['saturated']['decode_tokens_s']} and "
        f"{two['saturated']['decode_tokens_s']} (two/one "
        f"{two['saturated']['decode_tokens_s'] / one['saturated']['decode_tokens_s']}"
        f", p50 TPOT ms {one['saturated']['tpot_ms_p50']} and "
        f"{two['saturated']['tpot_ms_p50']}); p50 TTFT ms "
        f"{one['ttft_ms_p50']}, {two['ttft_ms_p50']}; p50 TPOT ms "
        f"{one['tpot_ms_p50']}, {two['tpot_ms_p50']}; driver process CPU "
        f"cores {one['cpu_cores']}, {two['cpu_cores']}; echo hop across "
        f"processes {one['echo_ms']} ms{beside}; kernel launches {total}; "
        f"on {smi}")
    return total, total14, launches18


# --------------------------------------------------------------- phase 18


def http_call(conn, method, path, payload=None):
    """One request on a kept-alive ``http.client`` connection. Returns
    (status, content type, body bytes)."""
    body = None if payload is None else json.dumps(payload).encode()
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type") or "", r.read()


def http_stream(conn, path, payload):
    """A ``?stream=1`` POST: yields the items of its
    ``application/jsonlines`` reply as they arrive; an ``{"error": ...}``
    line raises."""
    conn.request("POST", path, body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    if r.status != 200 or not (r.getheader("Content-Type") or "").startswith(
            "application/jsonlines"):
        raise AssertionError(f"phase 18 stream: {r.status} "
                             f"{r.getheader('Content-Type')} {r.read()!r}")
    while True:
        line = r.readline()
        if not line:
            return
        rec = json.loads(line)
        if "error" in rec:
            raise AssertionError(f"phase 18 stream: {rec['error']}")
        yield rec["item"]


def pid_listening_on(port):
    """The pid of the process (in this pid namespace) listening on TCP
    ``port``: the socket's inode from /proc/net/tcp, then the process
    holding it."""
    inodes = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            col = row.split()
            if col[3] == "0A" and int(col[1].rsplit(":", 1)[1], 16) == port:
                inodes.add(f"socket:[{col[9]}]")
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                if os.readlink(f"/proc/{pid}/fd/{fd}") in inodes:
                    return int(pid)
        except OSError:
            continue
    raise AssertionError(f"phase 18: no process listens on port {port}")


def cpu_seconds(pid):
    """User + system CPU seconds of ``pid`` (/proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def published_counts(pid, engine, names):
    """``names``' samples labelled ``engine`` in the registry the process
    ``pid`` published to the head's KV (``metrics/<node>/<pid>``)."""
    from ray_tpu_torch.core.runtime_context import require_runtime

    head = require_runtime().head
    keys = [k for k in head.retrying_call("kv_keys", "default", b"metrics/",
                                          timeout=30)
            if k.decode().endswith(f"/{pid}")]
    out = dict.fromkeys(names, 0.0)
    for key in keys:
        text = head.retrying_call("kv_get", "default", key, timeout=30)
        for line in (text or b"").decode().splitlines():
            metric, _, value = line.rpartition(" ")
            name = metric.split("{", 1)[0]
            if name in out and f'engine="{engine}"' in metric:
                out[name] += float(value)
    return out


def phase18(cfg, smi, replicas, replica_pid, seq, prompts, want, handle_ms,
            b_numbers):
    """The front door on 13b's replica: HTTP replies and streams held to
    the direct engine's two passes, the closed loop over HTTP, the
    replica's registry counts from the head's KV, the launches over the
    phase. Returns (launches, the proxy's pid)."""
    import http.client

    import ray_tpu_torch
    from ray_tpu_torch import serve as rserve

    t0 = time.perf_counter()
    n = len(seq)
    addrs = rserve.start_http_per_node()
    alive_nodes = [x for x in ray_tpu_torch.nodes() if x.get("alive", True)]
    if len(addrs) != 1 or len(alive_nodes) != 1:
        raise AssertionError(f"phase 18: proxies {addrs} on nodes "
                             f"{[x['node_id'] for x in alive_nodes]}")
    host, port = next(iter(addrs.values())).rsplit(":", 1)
    port = int(port)
    proxy_pid = pid_listening_on(port)
    t_up = time.perf_counter() - t0
    conn = http.client.HTTPConnection(host, port, timeout=600)
    st, ctype, body = http_call(conn, "GET", "/-/healthz")
    if (st, json.loads(body)) != (200, {"status": "ok"}):
        raise AssertionError(f"phase 18 /-/healthz: {st} {body!r}")
    st, ctype, body = http_call(conn, "GET", "/-/routes")
    if st != 200 or CLUSTER_NAME not in json.loads(body):
        raise AssertionError(f"phase 18 /-/routes: {st} {body!r}")
    (engine,) = replica_call(replicas, "fresh_engine")
    replica_call(replicas, "zero_launches")
    path = f"/{CLUSTER_NAME}"
    replies, ms = [], []
    for p in seq:
        t1 = time.perf_counter()
        st, ctype, body = http_call(conn, "POST", path, {
            "prompt_ids": p, "max_new_tokens": SERVE_NEW})
        ms.append((time.perf_counter() - t1) * 1e3)
        if st != 200 or not ctype.startswith("application/json"):
            raise AssertionError(f"phase 18 reply: {st} {ctype} {body!r}")
        replies.append(json.loads(body)["result"]["token_ids"])
    same_tokens("phase 18, replies over HTTP", replies, want[:n])
    streams = [list(http_stream(conn, f"{path}/stream?stream=1", {
        "prompt_ids": p, "max_new_tokens": SERVE_NEW})) for p in seq]
    same_tokens("phase 18, streams over HTTP", streams, want[n:])
    conn.close()
    local = threading.local()

    def stream(prompt, new_tokens):
        c = getattr(local, "conn", None)
        if c is None:
            c = local.conn = http.client.HTTPConnection(host, port,
                                                         timeout=600)
        return http_stream(c, f"{path}/stream?stream=1", {
            "prompt_ids": prompt, "max_new_tokens": new_tokens})

    # Half of 13b's closed loop (8 of its 16 prompts, one a client), to
    # keep the script inside its limit on a slow host.
    loop_prompts = prompts[:8]
    proxy_cpu0 = cpu_seconds(proxy_pid)
    replica_cpu0 = cpu_seconds(replica_pid)
    results, wall, cpu = closed_loop(stream, loop_prompts, SERVE_NEW)
    numbers = closed_loop_numbers(
        "phase 18 closed loop over HTTP", results, wall, cpu,
        replica_call(replicas, "stats"), smi, cfg.vocab_size)
    numbers["proxy_cpu_cores"] = (cpu_seconds(proxy_pid) - proxy_cpu0) / wall
    numbers["replica_cpu_cores"] = (cpu_seconds(replica_pid)
                                    - replica_cpu0) / wall
    (launches,) = replica_call(replicas, "launches")
    require_launches("phase 18 replica process", launches,
                     ("paged_decode_attention",) + TRAIN_ONLY)
    sent = 2 * n + len(loop_prompts)
    tokens = (sum(map(len, replies)) + sum(map(len, streams))
              + sum(len(r[0]) for r in results))
    want_counts = {"rtpu_llm_requests_total": float(sent),
                   "rtpu_llm_tokens_generated_total": float(tokens)}
    replica_call(replicas, "publish_metrics")
    deadline = time.monotonic() + 30
    while True:
        counts = published_counts(replica_pid, engine, list(want_counts))
        if counts == want_counts or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    if counts != want_counts:
        raise AssertionError(f"phase 18: the replica's published registry "
                             f"counts {counts}, phase 18 sent {want_counts}")
    numbers["hop_ms"] = median(ms) - median(handle_ms)
    numbers["seconds"] = time.perf_counter() - t0
    MEASURED["phase18"] = numbers
    log(f"phase 18 the front door ({SERVE_LAYERS} of Llama-3-8B's 32 "
        f"layers): one HTTP proxy (pid {proxy_pid}) up in {t_up:.1f} s; "
        f"{n} requests one at a time over HTTP, replies then streams, "
        f"tokens identical to the direct engine's two passes; ms a request, "
        f"median: HTTP {median(ms)}, 13b's handle {median(handle_ms)}, the "
        f"HTTP hop adds {numbers['hop_ms']} ms; closed loop over HTTP: "
        f"decode tokens/s {numbers['decode_tokens_s']} (13b through the "
        f"handle, 16 prompts {b_numbers['decode_tokens_s']}), p50 TTFT "
        f"{numbers['ttft_ms_p50']} ms ({b_numbers['ttft_ms_p50']}), p50 "
        f"TPOT {numbers['tpot_ms_p50']} ms ({b_numbers['tpot_ms_p50']}), "
        f"CPU cores: proxy {numbers['proxy_cpu_cores']}, replica "
        f"{numbers['replica_cpu_cores']} ({b_numbers['replica_cpu_cores']}),"
        f" driver {numbers['cpu_cores']} ({b_numbers['cpu_cores']}); the "
        f"replica's published registry for engine {engine}: {counts} "
        f"(exact); launches {launches}; {numbers['seconds']:.1f} s; on {smi}")
    return launches, proxy_pid


# --------------------------------------------------------------- phase 14

DISAGG_NAME = "llm14"
FLEET_NAME = "llm14b"
HALF_CARD = {"resources": {"GPU": 0.5}}


def _replica_launches(self):
    from ray_tpu_torch import ops

    return {name: fn.launches for name, fn in ops.KERNELS.items()}


def _replica_zero_launches(self):
    from ray_tpu_torch import ops

    for fn in ops.KERNELS.values():
        fn.launches = 0


def _replica_process(self):
    return os.getpid(), torch.cuda.memory_allocated(), time.process_time()


def disagg_servers():
    """The disaggregated pools' classes with methods of the script's own,
    reached through the replica actor's ``handle_request``: the kernel
    counters, the process, each edge's transport, and the handoff's
    timestamps on the host's one clock — the prefill replica's just
    before and just after each channel write (with the handoff's page
    count), the decode replica's when the install loop hands the received
    handoff to the engine, and just after the engine installed it,
    synchronized (only while ``set_timing(True)``: the closed loop runs
    without the sync).
    Defined in a function, so the cluster ships the classes by value to
    the replicas' worker processes."""
    from ray_tpu_torch.serve.llm import DecodeLLMServer, PrefillLLMServer

    class TimedPrefill(PrefillLLMServer):
        launches = _replica_launches
        zero_launches = _replica_zero_launches
        process = _replica_process

        def __init__(self, decode_handle, **kw):
            super().__init__(decode_handle, **kw)
            self.writes = []

        def _negotiate_edge(self, replica, epoch):
            edge = super()._negotiate_edge(replica, epoch)
            send, writes = edge["writer"].send, self.writes

            def timed_send(value, timeout=None):
                t0 = time.time()
                seq = send(value, timeout=timeout)
                writes.append((t0, len(value[1]["pages_k"]), time.time()))
                return seq

            edge["writer"].send = timed_send
            return edge

        def transports(self):
            with self._lock:
                edges = list(self._edges.values())
            return [(e["writer"].channel.transport,
                     e["reader"].channel.transport) for e in edges]

        def take_writes(self):
            out, self.writes = self.writes, []
            return out

    class TimedDecode(DecodeLLMServer):
        launches = _replica_launches
        zero_launches = _replica_zero_launches
        process = _replica_process

        def __init__(self, **kw):
            super().__init__(**kw)
            self.recvs, self.installs, self.timing = [], [], False
            install_async = self.engine.install_async
            install = self.engine._install_one

            def timed_install_async(payload):
                if self.timing:
                    self.recvs.append(time.time())
                return install_async(payload)

            def timed_install(req, payload):
                install(req, payload)
                if self.timing:
                    torch.cuda.synchronize()
                    self.installs.append(time.time())

            self.engine.install_async = timed_install_async
            self.engine._install_one = timed_install

        def set_timing(self, on):
            self.timing, self.recvs, self.installs = on, [], []

        def take_installs(self):
            out = (self.recvs, self.installs)
            self.recvs, self.installs = [], []
            return out

        def transports(self):
            with self._lock:
                return [e["info"]["transport"] for e in self._edges.values()]

    return TimedPrefill, TimedDecode


def disagg_deploy(cfg, smi, **knobs):
    """``build_llm_deployment(disaggregated=True, use_gpu=True,
    engine_kwargs=dict(ENGINE_KW, cfg=cfg, **knobs))`` on the running
    cluster, each pool's replicas asking ``{"GPU": 0.5}`` (one prefill and
    one decode replica on the one card) and built on
    ``disagg_servers()``' classes. Each replica draws the weights from the
    seed on its card. Returns (handle, prefill replicas, decode replicas,
    pids)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve as rserve
    from ray_tpu_torch.serve.llm import build_llm_deployment

    dep = build_llm_deployment(
        DISAGG_NAME, disaggregated=True, use_gpu=True,
        engine_kwargs=dict(ENGINE_KW, cfg=cfg, **knobs))
    prefill_cls, decode_cls = disagg_servers()
    decode = dep._init_args[0].options(ray_actor_options=HALF_CARD)
    decode._cls = decode_cls
    dep = dep.options(ray_actor_options=HALF_CARD)
    dep._cls, dep._init_args = prefill_cls, (decode,)
    t0 = time.perf_counter()
    h = rserve.run(dep)
    controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
    pre, dec = (ray_tpu_torch.get(controller.get_replicas.remote(name),
                                  timeout=120)
                for name in (DISAGG_NAME, f"{DISAGG_NAME}-decode"))
    procs = [p[:2] for p in replica_call(pre + dec, "process")]
    log(f"  disaggregated deployment '{DISAGG_NAME}', knobs {knobs or 'none'}"
        f": {len(pre)} prefill and {len(dec)} decode replica(s) of "
        f"{HALF_CARD['resources']} each, up in "
        f"{time.perf_counter() - t0:.1f} s; replica processes (pid, card "
        f"bytes allocated): {procs}; on {smi}")
    tree = cfg.param_count() * 2
    if (len(pre), len(dec)) != (1, 1) or any(
            pid == os.getpid() or mem < tree for pid, mem in procs) or len(
            {pid for pid, _ in procs}) != 2:
        raise AssertionError(f"phase 14: each replica must hold its "
                             f"{tree}-byte tree in a worker process of its "
                             f"own: {procs}")
    return h, pre, dec, [pid for pid, _ in procs]


def handoff_ms_page(writes, recvs, installs):
    """ms a page of each sequential handoff: from the prefill replica's
    write to the decode replica's synchronized install, and its three
    parts: the write (pickling and the ring or spill-file copy), the
    delivery (the reader's wake, the copy out and the unpickling, up to
    the engine's ``install_async``) and the engine (the install queue's
    wait and the install itself)."""
    if not len(writes) == len(recvs) == len(installs):
        raise AssertionError(f"phase 14a: {len(writes)} channel writes, "
                             f"{len(recvs)} receipts, {len(installs)} "
                             "installs")
    return [tuple((b - a) * 1e3 / n for a, b in
                  ((t0, t3), (t0, t1), (t1, t2), (t2, t3)))
            for (t0, n, t1), t2, t3 in zip(writes, recvs, installs)]


def phase14a(cfg, smi, seq, prompts, want, paged):
    """One prefill and one decode replica on the card: the sequence one
    request at a time as replies, then as streams, tokens identical to the
    direct engine's over the same two passes; ring edges; the prefill
    replica launches no decode kernel, the decode replica one a layer and
    step (the paged one with ``paged_decode``); the handoff's ms a page;
    the closed loop (the first pass only). Returns (launches, numbers,
    pids)."""
    from ray_tpu_torch import serve as rserve

    tag = "14a paged" if paged else "14a"
    kernel = "paged_decode_attention" if paged else "decode_attention"
    other = "decode_attention" if paged else "paged_decode_attention"
    h, pre, dec, pids = disagg_deploy(cfg, smi, paged_decode=paged)
    numbers = {}
    try:
        replica_call(pre + dec, "zero_launches")
        replica_call(dec, "set_timing", True)
        replica_call(pre, "take_writes")
        steps0 = replica_call(dec, "stats")[0]["dispatches"]["decode"]
        replies = [handle_request(h, p)[0] for p in seq]
        (writes,) = replica_call(pre, "take_writes")
        ((recvs, installs),) = replica_call(dec, "take_installs")
        replica_call(dec, "set_timing", False)
        (pre_counts,), (dec_counts,) = (replica_call(pre, "launches"),
                                        replica_call(dec, "launches"))
        dec_st = replica_call(dec, "stats")[0]
        streams = [handle_request(h, p, stream=True)[0] for p in seq]
        transports = (replica_call(pre, "transports")[0],
                      replica_call(dec, "transports")[0])
        if not paged:
            numbers = cluster_closed_loop(
                f"phase {tag} disaggregated, closed loop", h, dec, prompts,
                smi, cfg.vocab_size)
    finally:
        rserve.delete(DISAGG_NAME)
        rserve.delete(f"{DISAGG_NAME}-decode")
    same_tokens(f"phase {tag} replies", replies, want[:len(seq)])
    same_tokens(f"phase {tag} streams", streams, want[len(seq):])
    if transports != ([("ring", "ring")], ["ring"]):
        raise AssertionError(f"phase {tag}: edge transports {transports}")
    require_launches(f"phase {tag} prefill replica", pre_counts,
                     ("decode_attention", "paged_decode_attention")
                     + TRAIN_ONLY)
    require_launches(f"phase {tag} decode replica", dec_counts,
                     (other,) + TRAIN_ONLY)
    steps = (dec_st["dispatches"]["decode"] - steps0) * ENGINE_KW[
        "decode_chunk"]
    if dec_counts[kernel] != cfg.n_layers * steps:
        raise AssertionError(f"phase {tag}: {dec_counts[kernel]} {kernel} "
                             f"launches for {steps} decode steps of "
                             f"{cfg.n_layers} layers")
    split = handoff_ms_page(writes, recvs, installs)
    per_page = [x[0] for x in split]
    pages = [w[1] for w in writes]
    numbers["handoff_ms_page"] = median(per_page)
    numbers["handoff_split_ms_page"] = tuple(
        median([x[i] for x in split]) for i in (1, 2, 3))
    log(f"  phase {tag}: {len(seq)} requests as replies, then as streams, "
        f"tokens identical to the direct engine's; edges (prefill kv, "
        f"result; decode) {transports}; prefill replica launches "
        f"{pre_counts}; decode replica launches {dec_counts} "
        f"({dec_counts[kernel]} {kernel} = {cfg.n_layers} layers x {steps} "
        f"steps); on {smi}")
    log(f"  phase {tag} handoff, the prefill replica's channel write to the "
        f"decode replica's synchronized install, ms a page: median "
        f"{median(per_page)}, min {min(per_page)}, max {max(per_page)} over "
        f"{len(pages)} handoffs of {min(pages)}-{max(pages)} pages of "
        f"{page_bytes(cfg)} bytes; of it, medians: the write (pickling, the "
        f"ring or spill-file copy) {numbers['handoff_split_ms_page'][0]}, "
        f"the delivery (the reader's wake, the copy out, unpickling) "
        f"{numbers['handoff_split_ms_page'][1]}, the engine (install queue "
        f"wait and install) {numbers['handoff_split_ms_page'][2]}; on "
        f"{smi}")
    return {"pre": pre_counts, "dec": dec_counts}, numbers, pids


def page_bytes(cfg):
    """Bytes of one K+V page: every layer's rows of one prefix block."""
    return (cfg.n_layers * cfg.n_kv_heads * PAGE * cfg.head_dim
            * cfg.dtype.itemsize * 2)


def fleet_server():
    """``LLMServer`` with the kernel counters, the process, its page
    store's class and a pull probe (store get + unpack, then the install,
    a page at a time), reached through ``handle_request``."""
    from ray_tpu_torch.serve.llm import LLMServer

    class FleetServer(LLMServer):
        launches = _replica_launches
        zero_launches = _replica_zero_launches
        process = _replica_process

        def store_kind(self):
            return type(self.engine._fleet).__name__

        def fleet_ns(self):
            return self.engine._fleet_ns

        def pull_ms(self, chain, calls=5):
            """Median ms a page of the store get + unpack (host) and of
            the install (to the card) of ``chain``'s pages, run into slot
            0 once this replica serves no more requests."""
            from ray_tpu_torch.serve.engine import kv_fleet

            eng, get_ms, inst_ms = self.engine, [], []
            for _ in range(calls):
                t0 = time.perf_counter()
                pages = [kv_fleet.unpack_page(eng._fleet.get(
                    kv_fleet.page_object_id(eng._fleet_ns, hh)))
                    for hh in chain]
                t1 = time.perf_counter()
                eng.loop.install_page(
                    eng.cache, torch.cat([p["k_page"] for p in pages], 2),
                    torch.cat([p["v_page"] for p in pages], 2), 0, 0)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                get_ms.append((t1 - t0) * 1e3 / len(chain))
                inst_ms.append((t2 - t1) * 1e3 / len(chain))
            return median(get_ms), median(inst_ms)

    return FleetServer


def phase14b(cfg, params, smi):
    """Two colocated ``{"GPU": 0.5}`` replicas with the fleet tier on
    (``kv_fleet_min_prefix_blocks=0``), both on ``ClusterKVPageStore``:
    phase 9b's traffic sent to each replica directly — the first serves
    A_i (a 32-token prefix X_i and a tail), then two disjoint prompts that
    evict and spill X_i's blocks into the node's shm store; the second
    serves B_i (X_i and another tail), pulling them. Tokens identical to
    a fleet-off direct engine that serves A_i then B_i (a local prefix hit
    at the same depth); spilled and pulled blocks, no rejects; pull ms a
    page. Returns (launches, pids)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve as rserve
    from ray_tpu_torch.core.runtime_context import get_runtime
    from ray_tpu_torch.serve.engine import kv_fleet
    from ray_tpu_torch.serve.engine.kv_manager import chain_hashes
    from ray_tpu_torch.serve.llm import build_llm_deployment

    rng = np.random.RandomState(9)
    v, n_new = cfg.vocab_size, 24
    sets = []
    for _ in range(3):
        x = rng.randint(0, v, 32).tolist()
        sets.append((x + rng.randint(0, v, 8).tolist(),
                     x + rng.randint(0, v, 12).tolist(),
                     [rng.randint(0, v, 40).tolist() for _ in range(2)]))
    c = phase9_engine(cfg, params, "phase 14b fleet-off", smi, max_batch=2)
    try:
        want = [(c.generate(a, max_new_tokens=n_new,
                            timeout=600)["token_ids"],
                 c.generate(b, max_new_tokens=n_new,
                            timeout=600)["token_ids"])
                for a, b, _ in sets]
    finally:
        c.close()
    dep = build_llm_deployment(
        FLEET_NAME, num_replicas=2, use_gpu=True,
        engine_kwargs=dict(ENGINE_KW, cfg=cfg, max_batch=2,
                           kv_fleet_min_prefix_blocks=0))
    dep = dep.options(ray_actor_options=HALF_CARD)
    dep._cls = fleet_server()
    rserve.run(dep)
    controller = ray_tpu_torch.get_actor("rtpu-serve-controller")
    f1, f2 = ray_tpu_torch.get(controller.get_replicas.remote(FLEET_NAME),
                               timeout=120)
    store = kv_fleet.ClusterKVPageStore(get_runtime())
    try:
        pids = [p[0] for p in replica_call([f1, f2], "process")]
        kinds = replica_call([f1, f2], "store_kind")
        replica_call([f1, f2], "zero_launches")

        def call(r, prompt, n):
            return ray_tpu_torch.get(r.handle_request.remote(
                "__call__", ({"prompt_ids": prompt, "max_new_tokens": n},),
                {}), timeout=600)["token_ids"]

        ns = replica_call([f1], "fleet_ns")[0]
        for i, (a, b, evictors) in enumerate(sets):
            got_a = call(f1, a, n_new)
            for e in evictors:
                call(f1, e, 8)
            oid = kv_fleet.page_object_id(ns, chain_hashes(a, PAGE)[1])
            deadline = time.monotonic() + 60
            while not store.contains(oid):
                if time.monotonic() > deadline:
                    raise AssertionError("phase 14b: A's blocks never "
                                         f"spilled: {store.stats()}")
                time.sleep(0.01)
            got_b = call(f2, b, n_new)
            if (got_a, got_b) != want[i]:
                raise AssertionError(f"phase 14b set {i}: fleet tokens "
                                     f"{got_a} / {got_b} vs fleet-off "
                                     f"{want[i]}")
        l1, l2 = replica_call([f1, f2], "launches")
        st1, st2 = replica_call([f1, f2], "stats")
        get_ms, inst_ms = replica_call(
            [f2], "pull_ms", chain_hashes(sets[0][1], PAGE)[:2])[0]
    finally:
        rserve.delete(FLEET_NAME)
    if kinds != ["ClusterKVPageStore"] * 2:
        raise AssertionError(f"phase 14b: the replicas' page stores {kinds}")
    if not (st1["kv_fleet_spilled_blocks"] > 0
            and st2["kv_fleet_pulled_blocks"] > 0
            and st1["kv_fleet_rejects"] == st2["kv_fleet_rejects"] == 0):
        raise AssertionError(f"phase 14b: spilled "
                             f"{st1['kv_fleet_spilled_blocks']}, pulled "
                             f"{st2['kv_fleet_pulled_blocks']}, rejects "
                             f"{st1['kv_fleet_rejects']}/"
                             f"{st2['kv_fleet_rejects']}")
    counts = {}
    for launches in (l1, l2):
        require_launches("phase 14b replica", launches,
                         ("paged_decode_attention",) + TRAIN_ONLY)
        add_counts(counts, launches)
    log(f"  phase 14b: {len(sets)} pulls across two replica processes "
        f"token-identical to the fleet-off engine; page stores {kinds}; "
        f"spilled {st1['kv_fleet_spilled_blocks']} blocks, pulled "
        f"{st2['kv_fleet_pulled_blocks']} in {st2['kv_fleet_hits']} hits, "
        f"rejects 0; store {store.stats()}; launches {l1}, {l2}; on {smi}")
    log(f"  phase 14b pull ms per page, median of 5 in the pulling replica "
        f"(the get is a hit in the node's own shm arena, across processes, "
        f"not a pull from another node): store get + unpack {get_ms} "
        f"(host), install {inst_ms} (to the card, in a two-page run); the "
        f"engine's probe kv_fleet_pull_ms_per_page "
        f"{st2['kv_fleet_pull_ms_per_page']}, prefill ms per block "
        f"{st2['kv_fleet_prefill_ms_per_block']}; on {smi}")
    return counts, pids, (get_ms, inst_ms)


def phase14(cfg, params, smi, seq, prompts, want, one=None):
    """Phase 14, on the running cluster: 14a the disaggregated deployment,
    plain then ``paged_decode=True``; 14b the cluster fleet tier. Returns
    (the kernels' launches over its replica processes, pids)."""
    t0 = time.perf_counter()
    total, pids = {}, []
    launches, numbers, p = phase14a(cfg, smi, seq, prompts, want, False)
    pids += p
    for counts in launches.values():
        add_counts(total, counts)
    launches, paged, p = phase14a(cfg, smi, seq, prompts, want, True)
    pids += p
    for counts in launches.values():
        add_counts(total, counts)
    counts, p, pull = phase14b(cfg, params, smi)
    pids += p
    add_counts(total, counts)

    def earlier(key, fmt):
        return fmt(MEASURED[key]) if key in MEASURED else "not run"

    beside = ""
    if one is not None:
        beside = (f"; 13b's one colocated replica in this call: "
                  f"{one['decode_tokens_s']} decode tokens/s, TTFT "
                  f"{one['ttft_ms_p50']} ms, TPOT {one['tpot_ms_p50']} ms")
    log(f"phase 14 disaggregated serving and the cluster fleet tier: "
        f"handoff ms a page {numbers['handoff_ms_page']} (write, delivery, "
        f"engine {numbers['handoff_split_ms_page']}; paged "
        f"{paged['handoff_ms_page']}; a page is {page_bytes(cfg)} bytes); "
        f"in this call phase 9a's in-process handoff ms a page "
        f"{earlier('9a_ms_page', str)} and 13a's store put/get of an "
        f"8388608-byte CUDA tensor "
        f"{earlier('13a_put_get_ms', str)} ms; closed loop "
        f"{numbers['decode_tokens_s']} decode tokens/s, TTFT "
        f"{numbers['ttft_ms_p50']} ms, TPOT {numbers['tpot_ms_p50']} ms"
        f"{beside}; 14b pull ms a page: get + unpack {pull[0]}, install "
        f"{pull[1]}, against phase 9b's in one process "
        f"{earlier('9b_ms_page', str)}; "
        f"{time.perf_counter() - t0:.1f} s; kernel launches {total}; on "
        f"{smi}")
    return total, pids


# ---------------------------------------------------------------- phase 8

# Device kernels by group, matched on the profiler's kernel names.
TRAIN_GROUPS = (
    ("flash forward", ("::fwd_sm90<", "::fwd_kernel<")),
    ("flash backward", ("::dkdv_sm90<", "::dq_sm90<", "::delta_kernel<",
                        "::dkdv_kernel<", "::dq_kernel<")),
    ("fused kernels", ("rms_kernel", "rope_kernel", "swiglu_kernel")),
    ("optimizer", ("multi_tensor_apply", "fused_adam", "FusedAdam")),
    ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "xmma", "cublas")),
)


def train_breakdown(prof, label="phase 8"):
    """Device microseconds by group over the profiled step, and the
    largest kernels of the remainder. User-annotated ranges on the device
    timeline (``Optimizer.step#AdamW.step``) span other kernels and are
    skipped."""
    from torch.autograd import DeviceType

    groups = {g: 0.0 for g, _ in TRAIN_GROUPS}
    groups["other"] = 0.0
    others, fused = {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        us = ev.time_range.elapsed_us()
        group = next((g for g, keys in TRAIN_GROUPS
                      if any(k_ in ev.name for k_ in keys)), "other")
        groups[group] += us
        if group == "other":
            others[ev.name[:60]] = others.get(ev.name[:60], 0.0) + us
        if group == "fused kernels":
            # The glue group by kernel instantiation: (launches, us).
            key = ev.name[:70]
            n_, t_ = fused.get(key, (0, 0.0))
            fused[key] = (n_ + 1, t_ + us)
    log(f"  {label} fused kernels by instantiation (launches, ms): " + "; ".join(
        f"{k_} ({n_}, {t_ / 1e3})" for k_, (n_, t_) in sorted(fused.items())))
    return groups, others


def phase_train(smi):
    """Phase 8, the training cell: full-depth Llama-3-8B bf16 through the
    port's training entry points, every kernel count set to 0 just before
    the 5 steps and read just after. Returns the launch counts."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import ops
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held >= 2 * 2**30:
        raise AssertionError(f"phase 8: {held} bytes still allocated after "
                             "the engines")
    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype, cfg.remat,
            cfg.remat_policy) == (32, 4096, torch.bfloat16, True, "nothing")
    tx = spmd.default_optimizer(lr=1e-4, warmup=1)
    t0 = time.perf_counter()
    state = spmd.init_train_state(cfg, _gen(11), tx)
    torch.cuda.synchronize()
    log(f"phase 8 train: Llama-3-8B bf16, 32 layers, "
        f"{cfg.param_count() / 1e9:.2f}B params, B={TRAIN_B} S={TRAIN_S}, "
        f"remat {cfg.remat_policy}, fused AdamW; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"({held} bytes before)")
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to("cuda")
    step = spmd.make_train_step(cfg, tx)
    torch.cuda.reset_peak_memory_stats()
    for fn in ops.KERNELS.values():
        fn.launches = 0
    losses, gnorms, walls = [], [], []
    prof = None
    for i in range(TRAIN_STEPS):
        t = time.perf_counter()
        if i == TRAIN_STEPS - 1:   # the last step under the profiler
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                state, metrics = step(state, tokens)
                torch.cuda.synchronize()
        else:
            state, metrics = step(state, tokens)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {losses}; grad norms {gnorms}; step wall s {walls}")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError("phase 8: a non-finite loss or grad norm")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"phase 8: the loss did not fall: {losses}")
    per_step = dict(TRAIN_PER_STEP)
    want = {n: c * TRAIN_STEPS for n, c in per_step.items()}
    if launches != want:
        raise AssertionError(f"phase 8 launches {launches}, expected {want}")
    log(f"  phase 8 launch check passed: per step {per_step}")
    steady = sorted(walls[1:-1])[len(walls[1:-1]) // 2]
    tokens_s = TRAIN_B * TRAIN_S / steady
    flops = cfg.flops_per_token(TRAIN_S) * TRAIN_B * TRAIN_S
    MEASURED["phase8"] = {"losses": losses, "step_ms": steady * 1e3,
                          "per_step": per_step, "flops": flops,
                          "peak": peak}
    groups, others = train_breakdown(prof)
    busy = sum(groups.values()) / 1e3
    log(f"  phase 8 step: {steady * 1e3} ms (median of steps 1-"
        f"{TRAIN_STEPS - 2}, unprofiled; step 0 {walls[0] * 1e3} ms with "
        f"AdamW's state made), {tokens_s} tokens/s, MFU {flops / steady / BF16_FLOPS} "
        f"({flops / 1e12} TFLOP a step by flops_per_token), peak memory "
        f"{peak / 1e9} GB ({peak / 2**30} GiB); on {smi}")
    log(f"  phase 8 device time of the profiled step: busy {busy} ms "
        f"(idle share against the unprofiled step {1 - busy / (steady * 1e3)}); "
        "by group ms: " + ", ".join(f"{g} {v / 1e3}"
                                    for g, v in groups.items()))
    top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
    log("  largest 'other' kernels, ms: " + "; ".join(
        f"{n} {v / 1e3}" for n, v in top))
    ops_ = sorted((e for e in prof.key_averages()
                   if e.key.startswith("aten::") or e.key.endswith("Backward")),
                  key=lambda e: -e.self_device_time_total)
    log("  largest ops (aten ops and autograd backward nodes) by their own "
        "device time, ms (calls): " + "; ".join(
            f"{e.key} {e.self_device_time_total / 1e3} ({e.count})"
            for e in ops_[:12]))
    del state, metrics, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 16

# 16b: the pipeline at Llama-3-8B widths, cut to 4 layers; 16c: two ranks
# on the one card over gloo, cut to 2 layers. 16c runs tp=2 and fsdp=2:
# sp=2's ring shifts K/V with point-to-point sends, which gloo cannot make
# of CUDA tensors (the rank aborts in gloo's TCP writev, "Bad address"),
# so sp runs on the CPU ranks of the tests only (PERF.md, section 7).
P16B_LAYERS, P16B_B, P16B_S, P16B_STAGES, P16B_MICRO = 4, 4, 512, 2, 4
P16C_LAYERS, P16C_B, P16C_S, P16C_STEPS = 2, 2, 1024, 3
P16C_MESHES = (("tp=2", {"tp": 2}), ("fsdp=2", {"fsdp": 2}))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rel_close(got, want, rtol, what):
    """Each of the numbers ``got`` within ``rtol`` of ``want``'s, relative."""
    errs = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    if len(got) != len(want) or max(errs) > rtol:
        raise AssertionError(f"{what}: {got} vs {want}, relative errors "
                             f"{errs} (limit {rtol})")
    return max(errs)


def phase16a(smi, mesh):
    """Phase 8's step through the mesh path on a world of one: the same
    weights, tokens and optimizer, the parameters DTensors placed by
    Llama's table. Returns the launch counts of the 5 steps."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel.mesh import mfu_denominator

    p8 = MEASURED["phase8"]
    free_card()
    held = torch.cuda.memory_allocated()
    if held >= 2 * 2**30:
        raise AssertionError(f"phase 16a: {held} bytes still allocated after "
                             "phase 15")
    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True)
    tx = spmd.default_optimizer(lr=1e-4, warmup=1)
    logical = llama.param_logical_axes(cfg)
    params = spmd.shard_params(llama.init_params(cfg, _gen(11)), mesh,
                               logical)
    state = spmd.TrainState(0, params, tx.init(params))
    spmd.assert_params_sharded(state.params, mesh, logical)
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to("cuda")
    step = spmd.make_train_step(cfg, tx, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, gnorms, walls, enqueues = [], [], [], []
    for i in range(TRAIN_STEPS):
        tracer = (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
                  if i == TRAIN_STEPS - 1 else contextlib.nullcontext())
        with tracer as prof:
            t = time.perf_counter()
            state, metrics = step(state, tokens)
            enqueues.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    spmd.assert_params_sharded(state.params, mesh, logical)
    log(f"phase 16a mesh step: Llama-3-8B bf16, 32 layers, B={TRAIN_B} "
        f"S={TRAIN_S}, mesh_2d(1) on NCCL (six axes of 1); losses {losses}; "
        f"grad norms {gnorms}; step wall s {walls}")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError("phase 16a: a non-finite loss or grad norm")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"phase 16a: the loss did not fall: {losses}")
    want = {n: c * TRAIN_STEPS for n, c in p8["per_step"].items()}
    if launches != want:
        raise AssertionError(f"phase 16a launches {launches}, expected "
                             f"phase 8's {want}")
    err = rel_close(losses, p8["losses"], 2e-3, "phase 16a losses vs phase 8")
    steady = median(walls[1:-1])
    groups, _ = train_breakdown(prof, "phase 16a")
    busy = sum(groups.values()) / 1e3
    mfu = p8["flops"] / steady / mfu_denominator(1)
    MEASURED["phase16a"] = {"step_ms": steady * 1e3}
    log(f"  phase 16a launches equal phase 8's per step {p8['per_step']}; "
        f"losses bit-equal to phase 8's: {losses == p8['losses']} (largest "
        f"relative difference {err})")
    log(f"  phase 16a step: {steady * 1e3} ms (median of steps 1-"
        f"{TRAIN_STEPS - 2}, unprofiled) against phase 8's {p8['step_ms']} "
        f"ms in this call, {steady * 1e3 / p8['step_ms']}x; MFU {mfu} "
        f"(mfu_denominator(1)); peak memory {peak / 1e9} GB (phase 8 "
        f"{p8['peak'] / 1e9} GB); on {smi}")
    log(f"  phase 16a profiled step: wall {walls[-1] * 1e3} ms, host enqueue "
        f"{enqueues[-1] * 1e3} ms (unprofiled steps {[e * 1e3 for e in enqueues[:-1]]}), "
        f"device busy {busy} ms, idle share {1 - busy / (walls[-1] * 1e3)} "
        f"(against the unprofiled step {1 - busy / (steady * 1e3)}); by "
        "group ms: " + ", ".join(f"{g} {v / 1e3}" for g, v in groups.items()))
    del state, params, metrics, step
    free_card()
    return launches


def phase16b(smi, mesh):
    """The GPipe rotor on one card: Llama-3-8B widths cut to 4 layers,
    2 stages of 2 layers, 4 microbatches, on the world-of-one mesh (both
    stages local), against the dense forward and step on the same
    weights and tokens."""
    from ray_tpu_torch.models import _tree, llama
    from ray_tpu_torch.parallel import pipeline, spmd

    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True,
                              n_layers=P16B_LAYERS)
    pcfg = pipeline.PipelineConfig(stages=P16B_STAGES,
                                   microbatches=P16B_MICRO)
    whole = llama.init_params(cfg, _gen(12))
    staged = pipeline.stage_params(_tree.map_leaves(torch.clone, whole),
                                   P16B_STAGES)
    dense = spmd.shard_params(whole, mesh, llama.param_logical_axes(cfg))
    logical = pipeline.pipeline_param_logical_axes(cfg)
    staged = spmd.shard_params(staged, mesh, logical)
    spmd.assert_params_sharded(staged, mesh, logical)
    tokens = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (P16B_B, P16B_S))).to("cuda")
    with torch.no_grad():
        want = llama.forward_hidden(dense, tokens, cfg, mesh=mesh).to_local()
        zero_counts()
        got = pipeline.pipeline_forward_hidden(staged, tokens, cfg, pcfg,
                                               mesh=mesh).to_local()
        fwd_launches = read_counts()
    err = close_enough(got, want, 2e-2, 2e-2, "phase 16b pipeline hidden")
    tx = spmd.default_optimizer(lr=1e-4, warmup=1)
    dstep = spmd.make_train_step(cfg, tx, mesh=mesh)
    pstep = pipeline.make_pipeline_train_step(cfg, pcfg, mesh, tx)
    walls = {}
    results = {}
    for label, fn, params in (("dense", dstep, dense),
                              ("pipeline", pstep, staged)):
        state = spmd.TrainState(0, params, tx.init(params))
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = fn(state, tokens)
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - t) * 1e3
        results[label] = (metrics["loss"].item(), read_counts())
        del state, metrics
    loss_err = rel_close([results["pipeline"][0]], [results["dense"][0]],
                         2e-3, "phase 16b pipeline step loss vs dense")
    if results["pipeline"][1]["flash_attention_bwd"] == 0:
        raise AssertionError("phase 16b: the pipeline step ran no flash "
                             "backward")
    log(f"phase 16b pipeline: Llama-3-8B widths, {P16B_LAYERS} layers "
        f"(cut from 32), bf16, B={P16B_B} S={P16B_S}, {P16B_STAGES} stages x "
        f"{P16B_MICRO} microbatches on one card; hidden max abs err vs the "
        f"dense forward {err} (limit 2e-2 + 2e-2 rel); step loss "
        f"{results['pipeline'][0]} vs dense {results['dense'][0]} (relative "
        f"{loss_err}); first-step wall ms pipeline {walls['pipeline']}, dense "
        f"{walls['dense']} (AdamW's state made in the step); launches: "
        f"pipeline forward {fwd_launches}, pipeline step "
        f"{results['pipeline'][1]}, dense step {results['dense'][1]}; on "
        f"{smi}")
    del dense, staged, whole
    free_card()


def phase16c_rank(rank, store, out):
    """One of 16c's two ranks (its own process and CUDA context on card
    0): the mesh step at each of ``P16C_MESHES`` over gloo; saves losses,
    grad norms, step ms, launches and the flash kernels' head counts."""
    import datetime

    import torch.distributed as dist

    import importlib

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    # Started with phase 16 (``start_16c_ranks``): wait for 16c's turn
    # before the first CUDA call, so 16a and 16b have the card alone.
    go = store + ".go"
    deadline = time.monotonic() + 600
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError("phase 16c rank: never started")
        time.sleep(0.05)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=int(rank), world_size=2,
                            timeout=datetime.timedelta(seconds=300))
    heads = set()
    apply = fa.FlashAttention.apply

    def recording(q, k, v, scale):
        heads.add((q.shape[2], k.shape[2]))
        return apply(q, k, v, scale)

    fa.FlashAttention.apply = staticmethod(recording)
    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True,
                              n_layers=P16C_LAYERS)
    logical = llama.param_logical_axes(cfg)
    tokens = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, (P16C_B, P16C_S))).to("cuda")
    results = {}
    for label, spec in P16C_MESHES:
        mesh = make_mesh(MeshSpec(**spec))
        tx = spmd.default_optimizer(lr=1e-4, warmup=1)
        params = spmd.shard_params(llama.init_params(cfg, _gen(13)), mesh,
                                   logical)
        state = spmd.TrainState(0, params, tx.init(params))
        step = spmd.make_train_step(cfg, tx, mesh=mesh)
        heads.clear()
        zero_counts()
        losses, gnorms, walls = [], [], []
        for _ in range(P16C_STEPS):
            t = time.perf_counter()
            state, metrics = step(state, tokens)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            losses.append(metrics["loss"].item())
            gnorms.append(metrics["grad_norm"].item())
        spmd.assert_params_sharded(state.params, mesh, logical)
        results[label] = {"losses": losses, "grad_norms": gnorms,
                          "ms": walls, "launches": read_counts(),
                          "heads": sorted(heads)}
        del state, params, step, metrics
        free_card()
    torch.save(results, out)
    dist.barrier()
    dist.destroy_process_group()


def start_16c_ranks(tmp):
    """16c's two rank processes, started when phase 16 starts: they import
    torch and the port while 16a and 16b run, and touch the card only once
    ``phase16c`` lets them. Returns (procs, store, outs)."""
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--p16c-rank", str(r), store, outs[r]])
             for r in range(2)]
    return procs, store, outs


def phase16c(smi, mesh, ranks):
    """Two ranks on the one card over gloo (``ranks``, from
    ``start_16c_ranks``), against the world-of-one mesh step on the same
    weights and tokens in this process."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True,
                              n_layers=P16C_LAYERS)
    tx = spmd.default_optimizer(lr=1e-4, warmup=1)
    params = spmd.shard_params(llama.init_params(cfg, _gen(13)), mesh,
                               llama.param_logical_axes(cfg))
    state = spmd.TrainState(0, params, tx.init(params))
    step = spmd.make_train_step(cfg, tx, mesh=mesh)
    tokens = torch.from_numpy(np.random.RandomState(10).randint(
        0, cfg.vocab_size, (P16C_B, P16C_S))).to("cuda")
    ref = {"losses": [], "grad_norms": []}
    for _ in range(P16C_STEPS):
        state, metrics = step(state, tokens)
        ref["losses"].append(metrics["loss"].item())
        ref["grad_norms"].append(metrics["grad_norm"].item())
    del state, params, step, metrics
    free_card()
    procs, store, outs = ranks
    t = time.perf_counter()
    open(store + ".go", "w").close()
    rcs = [p.wait(timeout=240) for p in procs]
    if rcs != [0, 0]:
        raise AssertionError(f"phase 16c: ranks exited {rcs}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    wall = time.perf_counter() - t
    log(f"phase 16c: two ranks on one card over gloo, Llama-3-8B widths, "
        f"{P16C_LAYERS} layers (cut from 32), bf16, B={P16C_B} S={P16C_S}, "
        f"{P16C_STEPS} steps a mesh; world of one: losses {ref['losses']}, "
        f"grad norms {ref['grad_norms']}; {wall:.1f} s for both ranks")
    want_heads = {"tp=2": [(cfg.n_heads // 2, cfg.n_kv_heads // 2)],
                  "fsdp=2": [(cfg.n_heads, cfg.n_kv_heads)]}
    for label, _ in P16C_MESHES:
        for r, res in enumerate(ranks):
            got = res[label]
            e1 = rel_close(got["losses"], ref["losses"], 2e-3,
                           f"phase 16c {label} rank {r} losses")
            e2 = rel_close(got["grad_norms"], ref["grad_norms"], 2e-3,
                           f"phase 16c {label} rank {r} grad norms")
            if got["heads"] != want_heads[label]:
                raise AssertionError(f"phase 16c {label}: flash heads "
                                     f"{got['heads']}, expected "
                                     f"{want_heads[label]}")
            if got["launches"]["flash_attention_bwd"] == 0:
                raise AssertionError(f"phase 16c {label}: no flash backward")
            log(f"  16c {label} rank {r}: losses {got['losses']} (rel "
                f"{e1}), grad norms {got['grad_norms']} (rel {e2}); flash "
                f"(H, KH) a rank {got['heads']}; launches {got['launches']}; "
                f"step ms {got['ms']} (gloo through the host, not NCCL); on "
                f"{smi}")


def phase_parallel(smi):
    """Phase 16: the mesh path on the card. The driver joins a NCCL group
    of one; 16a and 16b run on ``mesh_2d(1)``, 16c starts two gloo ranks.
    Returns 16a's launch counts."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import mesh_2d

    import tempfile

    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rtt_16c_")
    ranks = start_16c_ranks(tmp)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_2d(1)
        launches = phase16a(smi, mesh)
        phase16b(smi, mesh)
        phase16c(smi, mesh, ranks)
    finally:
        dist.destroy_process_group()
        for p in ranks[0]:
            if p.poll() is None:
                p.kill()
                p.wait()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 16: {time.perf_counter() - t:.1f} s")
    return launches



# --------------------------------------------------------------- phase 15

# Phase 15b: Llama-3.2-1B's whole state checkpointed every CKPT_EVERY
# steps of CKPT_STEPS, the first attempt failing at step CKPT_FAIL_AT.
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT = 4, 2, 3


def trainer_loops():
    """Phase 15's train loops, defined in a function so that the cluster
    ships them by value to the trainer's GPU worker process (which loads
    no part of this script). Each reports what the driver checks."""
    def llama8b_loop(config):
        """Phase 8's setup and steps in the worker: Llama-3-8B bf16 from
        ``_gen(11)``, 5 steps on phase 8's ``RandomState(8)`` tokens, put
        on the card once or, with ``config["dataset"]``, each step's batch
        from the trainer's shard of that dataset through
        ``train.iter_device_batches(batch_size=1)``. Each step reports its
        loss, grad norm, wall ms (from the batch's fetch to a synchronize,
        before the host reads the loss, as phase 8 times it), the wait for
        its batch, the batch (device, dtype, shape, equal to the tokens),
        the kernels' launches so far, peak memory, the process and its
        visible cards. The last step runs under the profiler (its device
        busy ms); after it, the batches left over and ``copy_ms``."""
        import importlib

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.parallel import spmd

        # Not ``from ray_tpu_torch import ops``: cloudpickle would then take
        # ``torch.ops`` for a submodule this function uses and fail on it.
        kernels = importlib.import_module("ray_tpu_torch.ops").KERNELS

        cfg = dataclasses.replace(llama.LLAMA3_8B, fused_ops=True)
        tx = spmd.default_optimizer(lr=1e-4, warmup=1)
        state = spmd.init_train_state(cfg, _gen(11), tx)
        row = np.random.RandomState(8).randint(0, cfg.vocab_size,
                                               (TRAIN_B, TRAIN_S))
        dataset = config.get("dataset")
        if dataset is None:
            batches = iter([{"tokens": torch.from_numpy(row).to("cuda")}]
                           * TRAIN_STEPS)
        else:
            batches = train.iter_device_batches(dataset, batch_size=TRAIN_B)
        step = spmd.make_train_step(cfg, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        for i in range(TRAIN_STEPS):
            last = i == TRAIN_STEPS - 1
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                    if last else contextlib.nullcontext())
            t = time.perf_counter()
            with prof:
                batch = next(batches)
                wait = time.perf_counter() - t
                tokens = batch["tokens"]
                state, metrics = step(state, tokens)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            busy = (sum(ev.time_range.elapsed_us() for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA
                        and not ev.is_user_annotation) / 1e3
                    if last else None)
            train.report({
                "step": i, "loss": metrics["loss"].item(),
                "grad_norm": metrics["grad_norm"].item(),
                "step_ms": wall * 1e3, "wait_ms": wait * 1e3,
                "on": str(tokens.device), "dtype": str(tokens.dtype),
                "shape": list(tokens.shape),
                "equal": bool(torch.equal(tokens.cpu(),
                                          torch.from_numpy(row))),
                "launches": {n: fn.launches for n, fn in kernels.items()},
                "busy_ms": busy, "peak": torch.cuda.max_memory_allocated(),
                "pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": torch.cuda.get_device_name(0),
                "rest": sum(1 for _ in batches) if last else None,
                "copy_ms": copy_ms(row) if last else None})

    def copy_ms(row, n=20):
        """A standalone copy of one batch's size (the [1, 2048] int64 row,
        pinned) on a side stream, CUDA events, mean of ``n``: what the
        loader's copy of a batch costs, not a timing of its own copies."""
        pinned = torch.from_numpy(row).pin_memory()
        side = torch.cuda.Stream()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        with torch.cuda.stream(side):
            pinned.to("cuda", non_blocking=True)
            start.record(side)
            for _ in range(n):
                pinned.to("cuda", non_blocking=True)
            end.record(side)
        end.synchronize()
        return start.elapsed_time(end) / n

    def ckpt_loop(config):
        """Llama-3.2-1B bf16 trained from ``_gen(12)`` on ``RandomState(9)``
        tokens, rank 0 saving the whole state every CKPT_EVERY steps and
        loading it straight back (every leaf must be ``torch.equal`` to
        the live one); the first attempt fails at CKPT_FAIL_AT, the second
        resumes from the trainer's checkpoint onto the card."""
        import tempfile

        from ray_tpu_torch import train
        from ray_tpu_torch.models import _tree, llama
        from ray_tpu_torch.parallel import spmd

        cfg = dataclasses.replace(llama.LLAMA3_1B, fused_ops=True)
        tx = spmd.default_optimizer(lr=1e-4, warmup=1)
        ckpt = train.get_checkpoint()
        load_ms = rebuild_ms = warm_ms = None
        if ckpt is not None:
            # The process's first fused AdamW, timed apart: what
            # train_state_from_tree's tx.init pays once per process.
            t = time.perf_counter()
            torch.optim.AdamW([torch.zeros(1, device="cuda")], fused=True)
            torch.cuda.synchronize()
            warm_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            tree = train.load_pytree(ckpt.path, device="cuda")
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            state = spmd.train_state_from_tree(tree, cfg, tx)
            torch.cuda.synchronize()
            rebuild_ms = (time.perf_counter() - t) * 1e3
            del tree
        else:
            state = spmd.init_train_state(cfg, _gen(12), tx)
        start = state.step
        tokens = torch.from_numpy(np.random.RandomState(9).randint(
            0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to("cuda")
        step = spmd.make_train_step(cfg, tx)
        for i in range(start, config["num_steps"]):
            state, metrics = step(state, tokens)
            payload = {"step": i, "start": start,
                       "loss": metrics["loss"].item(), "load_ms": load_ms,
                       "rebuild_ms": rebuild_ms, "warm_ms": warm_ms,
                       "pid": os.getpid()}
            if i == config["fail_at"] and ckpt is None:
                raise RuntimeError("phase 15b: injected failure")
            rank = train.get_context().get_world_rank()
            if (i + 1) % config["every"] or rank:
                train.report(payload)
                continue
            d = tempfile.mkdtemp(prefix="ckpt_", dir=config["stage"])
            t = time.perf_counter()
            tree = spmd.train_state_tree(state)
            train.save_pytree(tree, d)
            save_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            back = train.load_pytree(d, device="cuda")
            torch.cuda.synchronize()
            back_ms = (time.perf_counter() - t) * 1e3
            live, got = _tree.leaves(tree), _tree.leaves(back)
            equal = len(live) == len(got) and all(
                torch.equal(a, b) and a.dtype == b.dtype
                if isinstance(a, torch.Tensor) else a == b
                for a, b in zip(live, got))
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
            del tree, back, live, got
            train.report(dict(payload, save_ms=save_ms, back_ms=back_ms,
                              equal=equal, bytes=nbytes,
                              leaves=len(os.listdir(d)) - 1),
                         checkpoint=train.Checkpoint(d))

    def nccl_loop(config):
        """One rank of NCCL on the worker's card: the backend, an
        all_reduce of a CUDA tensor, and one DDP step of a small module on
        the card against the same step without DDP."""
        import torch.distributed as dist
        from torch.nn.parallel import DistributedDataParallel

        from ray_tpu_torch import train
        from ray_tpu_torch.train.torch import prepare_model

        t = torch.arange(4, dtype=torch.float32, device="cuda") + 1
        dist.all_reduce(t)
        torch.manual_seed(0)
        plain = torch.nn.Linear(64, 16).to("cuda")
        model = prepare_model(torch.nn.Linear(64, 16).to("cuda"))
        model.load_state_dict(plain.state_dict())
        ddp = DistributedDataParallel(model, device_ids=[0])
        x = torch.randn(32, 64, device="cuda")
        for m in (plain, ddp):
            opt = torch.optim.SGD(m.parameters(), lr=0.1)
            torch.nn.functional.mse_loss(m(x), x[:, :16]).backward()
            opt.step()
        train.report({
            "backend": dist.get_backend(), "world": dist.get_world_size(),
            "all_reduce": t.tolist(), "on": str(t.device),
            "prepared_is_module": model is ddp.module,
            "params_on": sorted({str(p.device) for p in ddp.parameters()}),
            "ddp_equals_plain": all(
                torch.equal(a, b) for a, b in zip(ddp.module.parameters(),
                                                  plain.parameters())),
            "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    return llama8b_loop, ckpt_loop, nccl_loop


class RoundClock:
    """The driver's clock at each lockstep round the trainer delivers
    (``BackendExecutor.get_next_round`` wrapped while a fit runs)."""

    def __init__(self):
        from ray_tpu_torch.train import backend_executor

        self.times = []
        self._cls = backend_executor.BackendExecutor
        self._orig = self._cls.get_next_round

    def __enter__(self):
        orig, times = self._orig, self.times

        def timed(executor, *args, **kwargs):
            out = orig(executor, *args, **kwargs)
            times.append(time.perf_counter())
            return out

        self._cls.get_next_round = timed
        return self

    def __exit__(self, *exc):
        self._cls.get_next_round = self._orig


def phase15a(smi, loop, phase8):
    """Phase 8's training through ``DataParallelTrainer`` in a GPU worker
    process: the launches, losses and step time against phase 8's."""
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    with RoundClock() as clock:
        t0 = time.perf_counter()
        result = DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="phase15a",
                                 storage_path=phase8["storage"])).fit()
        fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"phase 15a: {result.error}")
    rounds = result.metrics_dataframe
    if [r["step"] for r in rounds] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"phase 15a: rounds {rounds}")
    last = rounds[-1]
    if last["pid"] == os.getpid():
        raise AssertionError("phase 15a: the loop ran in the driver")
    want = {n: c * TRAIN_STEPS for n, c in phase8["per_step"].items()}
    if last["launches"] != want:
        raise AssertionError(f"phase 15a: the worker's launches "
                             f"{last['launches']}, expected {want}")
    losses = [r["loss"] for r in rounds]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase8["losses"])]
    log(f"  phase 15a losses {losses}; phase 8's {phase8['losses']}; "
        f"largest relative difference {max(rel)}, bit-equal "
        f"{losses == phase8['losses']}; grad norms "
        f"{[r['grad_norm'] for r in rounds]}")
    if max(rel) > MODEL_TOL:
        raise AssertionError(f"phase 15a: losses differ from phase 8's by "
                             f"{max(rel)} > {MODEL_TOL}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
        raise AssertionError(f"phase 15a: the loss did not fall: {losses}")
    walls = [r["step_ms"] for r in rounds]
    steady = median(walls[1:-1])
    idle = 1 - last["busy_ms"] / steady
    MEASURED["phase15a"] = {"losses": losses, "step_ms": steady,
                            "idle": idle}
    gaps = [b - a for a, b in zip(clock.times, clock.times[1:])]
    # The last round also carries the profiler's event walk and the copy
    # timing, done after its step and before its report: left out.
    overhead = [g * 1e3 - w for g, w in zip(gaps[:TRAIN_STEPS - 2],
                                            walls[1:-1])]
    log(f"  phase 15a trainer step: {steady} ms (median of steps 1-"
        f"{TRAIN_STEPS - 2}; step 0 {walls[0]} ms) against phase 8's "
        f"direct step {phase8['step_ms']} ms in this call, ratio "
        f"{steady / phase8['step_ms']}; {TRAIN_B * TRAIN_S / steady * 1e3} "
        f"tokens/s, MFU {phase8['flops'] / (steady / 1e3) / BF16_FLOPS}; "
        f"a round's overhead (the driver's time between rounds less the "
        f"worker's step; the profiled last round left out) ms {overhead}, "
        f"median {median(overhead)}; peak "
        f"memory {last['peak'] / 1e9} GB (phase 8 {phase8['peak'] / 1e9} "
        f"GB); the profiled last step's device idle share {idle}; worker "
        f"pid {last['pid']} (driver {os.getpid()}), "
        f"CUDA_VISIBLE_DEVICES={last['visible']!r}, {last['device']}; fit "
        f"{fit_s:.1f} s; launches {last['launches']}; on {smi}")
    return last["launches"]


def phase15b(smi, loop, storage):
    """Checkpoints, a failure and a resume at Llama-3.2-1B: the direct
    uninterrupted run here, then the trainer's two attempts."""
    import shutil

    from ray_tpu_torch.models import _tree, llama
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.train import (CheckpointConfig, DataParallelTrainer,
                                     FailureConfig, RunConfig, ScalingConfig)

    cfg = dataclasses.replace(llama.LLAMA3_1B, fused_ops=True)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        16, 2048, 32, 8, 8192, 128256, torch.bfloat16)
    tx = spmd.default_optimizer(lr=1e-4, warmup=1)
    state = spmd.init_train_state(cfg, _gen(12), tx)
    tokens = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to("cuda")
    step = spmd.make_train_step(cfg, tx)
    direct = []
    for _ in range(CKPT_STEPS):
        state, metrics = step(state, tokens)
        direct.append(metrics["loss"].item())
    state_bytes = sum(t.numel() * t.element_size() for t in _tree.leaves(
        spmd.train_state_tree(state)) if isinstance(t, torch.Tensor))
    del state, metrics, step
    free_card()
    stage = os.path.join(storage, "stage")
    os.makedirs(stage)
    free = shutil.disk_usage(storage).free
    log(f"  phase 15b: Llama-3.2-1B bf16, {cfg.param_count() / 1e9:.3f}B "
        f"params, whole state {state_bytes / 1e9} GB; free disk under the "
        f"storage path {free / 1e9} GB; direct losses {direct}")
    t0 = time.perf_counter()
    result = DataParallelTrainer(
        loop, train_loop_config={"num_steps": CKPT_STEPS,
                                 "every": CKPT_EVERY,
                                 "fail_at": CKPT_FAIL_AT, "stage": stage},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(
            name="phase15b", storage_path=storage,
            checkpoint_config=CheckpointConfig(num_to_keep=1),
            failure_config=FailureConfig(max_failures=1))).fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise AssertionError(f"phase 15b: {result.error}")
    rounds = result.metrics_dataframe
    steps = [(r["start"], r["step"]) for r in rounds]
    if steps != [(0, 0), (0, 1), (0, 2), (2, 2), (2, 3)]:
        raise AssertionError(f"phase 15b: rounds (start, step) {steps}")
    saves = [r for r in rounds if "save_ms" in r]
    if len(saves) != 2 or not all(r["equal"] for r in saves):
        raise AssertionError(f"phase 15b: a checkpoint did not load back "
                             f"bit-equal: {saves}")
    resumed = [r["loss"] for r in rounds[3:]]
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, direct[2:])]
    log(f"  phase 15b resumed losses (steps 2-3) {resumed} against the "
        f"uninterrupted run's {direct[2:]}: largest relative difference "
        f"{max(rel)}, bit-equal {resumed == direct[2:]}; first attempt "
        f"{[r['loss'] for r in rounds[:3]]}")
    if max(rel) > MODEL_TOL:
        raise AssertionError(f"phase 15b: the resumed losses differ by "
                             f"{max(rel)} > {MODEL_TOL}")
    for r in saves:
        log(f"  phase 15b checkpoint after step {r['step']}: {r['bytes']} "
            f"bytes in {r['leaves']} leaf files, bit-equal on load; save "
            f"(tree + host copy + write) {r['save_ms']} ms, "
            f"{r['bytes'] / r['save_ms'] / 1e6} GB/s; load onto the card "
            f"{r['back_ms']} ms, {r['bytes'] / r['back_ms'] / 1e6} GB/s")
    load_ms = rounds[3]["load_ms"]
    log(f"  phase 15b resume in a new worker: load_pytree onto the card "
        f"{load_ms} ms ({saves[0]['bytes'] / load_ms / 1e6} GB/s), then "
        f"train_state_from_tree {rounds[3]['rebuild_ms']} ms (after the "
        f"process's first fused AdamW, {rounds[3]['warm_ms']} ms); fit "
        f"{fit_s:.1f} s (two attempts); on {smi}")


def phase15c(smi, loop):
    """``TorchTrainer`` on one GPU worker: NCCL, a world of one."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    trainer = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="phase15c",
                             storage_path=MEASURED["phase15_storage"]))
    t0 = time.perf_counter()
    result = trainer.fit()
    if result.error is not None:
        raise AssertionError(f"phase 15c: {result.error}")
    m = result.metrics
    ok = (trainer.backend == m["backend"] == "nccl" and m["world"] == 1
          and m["all_reduce"] == [1.0, 2.0, 3.0, 4.0]
          and m["on"].startswith("cuda") and m["prepared_is_module"]
          and m["params_on"] == ["cuda:0"] and m["ddp_equals_plain"]
          and m["pid"] != os.getpid())
    if not ok:
        raise AssertionError(f"phase 15c: {m}")
    log(f"  phase 15c TorchTrainer: backend {m['backend']}, world "
        f"{m['world']}, all_reduce of a CUDA tensor {m['all_reduce']}, one "
        f"DDP step on {m['params_on']} equal to the plain step; worker "
        f"CUDA_VISIBLE_DEVICES={m['visible']!r}; fit "
        f"{time.perf_counter() - t0:.1f} s; on {smi}")


def on_cluster(label, run, warm=(0, 0, True)):
    """``run(storage)`` on a fresh ``ray_tpu_torch.init()`` cluster (the
    card counted as ``GPU``) with a scratch storage path, after checking
    that this process holds under 2 GiB of the card and starting ``warm``
    (GPU, CPU) workers together (``warm_workers``); then the cluster shut
    down, the storage removed, and every cluster process gone."""
    import gc
    import shutil
    import tempfile

    import ray_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held >= 2 * 2**30:
        raise AssertionError(f"{label}: {held} bytes still allocated "
                             "before the trainer's worker starts")
    storage = tempfile.mkdtemp(prefix="rtt_phase_")
    n_gpu, n_cpu, card = warm
    with warm_flags():
        rt = ray_tpu_torch.init(object_store_memory=1 << 30)
    procs = list(rt._procs)
    pids = []
    try:
        if n_gpu or n_cpu:
            pids = warm_workers(label, n_gpu, n_cpu, card)
        out = run(storage)
        spawn_line(label, rt)
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 30
    while any(alive(pid) for pid in [p.pid for p in procs] + pids):
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: cluster processes outlived "
                                 "shutdown")
        time.sleep(0.1)
    return out


def phase_trainer(smi, data=False):
    """Phase 15, after phase 8: ``ray_tpu_torch.train`` on the cluster
    runtime, one GPU worker process at a time (15a Llama-3-8B through the
    trainer, 15b Llama-3.2-1B checkpoints with a failure and a resume, 15c
    ``TorchTrainer`` on NCCL); with ``data``, phase 17a and 17c, then
    phase 11d, after them on the same cluster. Returns the 15a worker's
    launches and 17a's (or None)."""
    phase8 = dict(MEASURED["phase8"])
    llama8b_loop, ckpt_loop, nccl_loop = trainer_loops()

    def run(storage):
        t0 = time.perf_counter()
        MEASURED["phase15_storage"] = phase8["storage"] = storage
        t = time.perf_counter()
        launches = phase15a(smi, llama8b_loop, phase8)
        log(f"phase 15a took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase15b(smi, ckpt_loop, storage)
        log(f"phase 15b took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase15c(smi, nccl_loop)
        log(f"phase 15c took {time.perf_counter() - t:.1f} s")
        log(f"phase 15 trainer: 15a-15c passed in "
            f"{time.perf_counter() - t0:.1f} s; on {smi}")
        if not data:
            return launches, None
        data_launches = phase_data(smi, llama8b_loop, storage)
        phase11d(smi)
        MEASURED["phase20"] = phase20(smi, storage)
        MEASURED["phase21"] = phase21(smi, storage)
        return launches, data_launches

    return on_cluster("phase 15", run,
                      warm=(WARM_GPU_15, WARM_CPU_15, False))


# --------------------------------------------------------------- phase 17

# 17c, bench.py's data suite (bench.py:2348-2480) at its sizes.
P17C_SHUFFLE_ROWS, P17C_SHUFFLE_WIDTH, P17C_SHUFFLE_BLOCKS = 96_000, 16, 48
P17C_INGEST_ROWS, P17C_INGEST_D, P17C_INGEST_BS = 65_536, 256, 4096


def train_dataset(vocab):
    """Phase 17a's source: ``TRAIN_STEPS`` rows, each phase 8's [2048]
    token row, made by a map stage from the row index."""
    from ray_tpu_torch import data as rdata

    def tokens(batch):
        row = np.random.RandomState(8).randint(0, vocab, (TRAIN_B, TRAIN_S))
        return {"tokens": np.repeat(row, len(batch["step"]), axis=0)}

    return rdata.from_numpy({"step": np.arange(TRAIN_STEPS)},
                            parallelism=TRAIN_STEPS).map_batches(tokens)


def phase17a_run(loop, storage, dataset):
    """One ``DataParallelTrainer`` fit of phase 15a's loop in a GPU
    worker, its tokens pre-staged or (``dataset``) from a Dataset; returns
    its rounds."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    result = DataParallelTrainer(
        loop, train_loop_config={"dataset": "train"} if dataset else None,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name=f"phase17a-{int(dataset)}",
                             storage_path=storage),
        datasets=({"train": train_dataset(llama.LLAMA3_8B.vocab_size)}
                  if dataset else None)).fit()
    if result.error is not None:
        raise AssertionError(f"phase 17a: {result.error}")
    rounds = result.metrics_dataframe
    if [r["step"] for r in rounds] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"phase 17a: rounds {rounds}")
    return rounds


def phase17a(smi, loop, storage):
    """Phase 15a's training with its tokens from a ``ray_tpu_torch.data``
    Dataset: ``DataParallelTrainer(datasets={"train": ds})`` ->
    ``streaming_split(1)`` -> ``train.iter_device_batches`` in the GPU
    worker. Losses bit-equal to the pre-staged arm's (15a's in the whole
    run; in ``--data`` 15a's loop run here first); every batch on the
    worker's card; launches a step equal to phase 8's. Returns the
    worker's launches."""
    if "phase15a" in MEASURED:
        pre = dict(MEASURED["phase15a"], label="15a")
    else:
        rounds = phase17a_run(loop, storage, dataset=False)
        steady = median([r["step_ms"] for r in rounds][1:-1])
        pre = {"losses": [r["loss"] for r in rounds], "step_ms": steady,
               "idle": 1 - rounds[-1]["busy_ms"] / steady,
               "label": "the pre-staged arm (15a's loop)"}
    rounds = phase17a_run(loop, storage, dataset=True)
    last = rounds[-1]
    if last["pid"] == os.getpid():
        raise AssertionError("phase 17a: the loop ran in the driver")
    bad = [(r["step"], r["on"], r["dtype"], r["shape"], r["equal"])
           for r in rounds
           if (r["on"], r["dtype"], r["shape"], r["equal"]) != (
               "cuda:0", "torch.int64", [TRAIN_B, TRAIN_S], True)]
    if bad or last["rest"] != 0:
        raise AssertionError(f"phase 17a: batches not phase 8's tokens on "
                             f"the worker's card: {bad}; {last['rest']} "
                             "batches left over")
    want = {n: c * TRAIN_STEPS for n, c in TRAIN_PER_STEP.items()}
    if last["launches"] != want:
        raise AssertionError(f"phase 17a: launches {last['launches']}, "
                             f"expected {want}")
    losses = [r["loss"] for r in rounds]
    if losses != pre["losses"]:
        raise AssertionError(f"phase 17a: losses {losses} not bit-equal to "
                             f"{pre['label']}'s {pre['losses']}")
    walls = [r["step_ms"] for r in rounds]
    steady = median(walls[1:-1])
    idle = 1 - last["busy_ms"] / steady
    waits = [r["wait_ms"] for r in rounds]
    p8 = MEASURED.get("phase8", {}).get("step_ms", "not run in this mode")
    log(f"  phase 17a losses {losses}, bit-equal to {pre['label']}'s; "
        f"every batch a [1, {TRAIN_S}] int64 tensor on cuda:0 of the "
        f"worker (CUDA_VISIBLE_DEVICES={last['visible']!r}, "
        f"{last['device']}), equal to phase 8's tokens; launches "
        f"{last['launches']} (phase 8's a step x {TRAIN_STEPS})")
    log(f"  phase 17a step through the Dataset: {steady} ms (median of steps "
        f"1-{TRAIN_STEPS - 2}, each from the batch's fetch to the step's "
        f"synchronize; step 0 {walls[0]} ms) against {pre['label']}'s "
        f"{pre['step_ms']} ms (ratio {steady / pre['step_ms']}) and phase "
        f"8's {p8} ms; profiled step {walls[-1]} ms, device busy "
        f"{last['busy_ms']} ms, idle share {idle} ({pre['label']}'s "
        f"{pre['idle']}); the consumer's wait for a batch (queue wait) ms "
        f"{waits}; a standalone pinned copy of one batch on a side stream "
        f"{last['copy_ms']} ms; peak memory {last['peak'] / 1e9} GB; on "
        f"{smi}")
    return last["launches"]


def phase17b(smi, cfg, params):
    """Batch inference: ``build_llm_processor`` on
    ``init(local_mode=True)`` over phase 12's Llama-3-8B bf16 (``params``
    by reference), phase 5's engine, ``concurrency=1``, ``batch_size=8``,
    ``from_items`` over phase 5's 16 prompts with ``parallelism=2``, 32
    new tokens each, greedy. Every kernel count is set to 0 just before
    the processor runs and read just after. Each row's tokens are held
    to a direct engine's on the same params with the same prefix-cache
    history: the engine's ``generate`` is wrapped to record each
    request's ``cached_prefix_len`` (the slots fill and hit in whatever
    order the block's 8 concurrent requests arrive, and bf16 greedy
    tokens may differ between a full prefill and a prefix hit's suffix
    prefill); a direct engine takes the 16 prompts in order, and a row
    whose prefix hit differs from its request there is held to a fresh
    direct engine that repeats the row's history. Returns the launches."""
    import ray_tpu_torch
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch import ops
    from ray_tpu_torch.data import build_llm_processor
    from ray_tpu_torch.serve.llm import LLMEngine

    t_phase = time.perf_counter()
    prompts, _ = phase5_prompts(cfg.vocab_size)
    cached, built = {}, []
    generate, construct = LLMEngine.generate, LLMEngine.__init__

    def recording(self, prompt_ids, *args, **kwargs):
        out = generate(self, prompt_ids, *args, **kwargs)
        cached[tuple(prompt_ids)] = out["cached_prefix_len"]
        return out

    def timed(self, *args, **kwargs):
        t = time.perf_counter()
        construct(self, *args, **kwargs)
        built.append(time.perf_counter() - t)

    processor = build_llm_processor(
        engine_kwargs=dict(ENGINE_KW, cfg=cfg, params=params),
        max_new_tokens=SERVE_NEW, batch_size=8, concurrency=1)
    ray_tpu_torch.init(local_mode=True)
    LLMEngine.generate, LLMEngine.__init__ = recording, timed
    try:
        ds = rdata.from_items([{"qid": i, "prompt_ids": p}
                               for i, p in enumerate(prompts)],
                              parallelism=2)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        rows = processor(ds).take_all()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        LLMEngine.generate, LLMEngine.__init__ = generate, construct
        ray_tpu_torch.shutdown()
    if [int(r["qid"]) for r in rows] != list(range(len(prompts))):
        raise AssertionError(f"phase 17b: rows {[r['qid'] for r in rows]}")
    got = [[int(t) for t in r["generated_ids"]] for r in rows]
    history = [cached[tuple(p)] for p in prompts]
    want, direct_cached = [], []
    eng = phase9_engine(cfg, params, "phase 17b direct", smi)
    try:
        for p in prompts:
            out = eng.generate(p, max_new_tokens=SERVE_NEW, timeout=600)
            want.append(out["token_ids"])
            direct_cached.append(out["cached_prefix_len"])
    finally:
        eng.close()
    redone = []
    for j, p in enumerate(prompts):
        if history[j] == direct_cached[j]:
            continue
        eng = phase9_engine(cfg, params, f"phase 17b row {j}", smi)
        try:
            if history[j]:
                holder = next(q for q in prompts[:j] + prompts[j + 1:]
                              if q[:history[j]] == p[:history[j]])
                eng.generate(holder, max_new_tokens=SERVE_NEW, timeout=600)
            out = eng.generate(p, max_new_tokens=SERVE_NEW, timeout=600)
        finally:
            eng.close()
        if out["cached_prefix_len"] != history[j]:
            raise AssertionError(f"phase 17b row {j}: could not repeat its "
                                 f"prefix hit {history[j]}: {out}")
        want[j] = out["token_ids"]
        redone.append(j)
    same_tokens("phase 17b", got, want)
    require_launches("phase 17b", launches,
                     ("paged_decode_attention",) + TRAIN_ONLY)
    if len(built) != 1:
        raise AssertionError(f"phase 17b: the pool built {len(built)} "
                             "engines, not one")
    n_tok = sum(len(g) for g in got)
    decode = sum(len(g) - 1 for g in got)
    served = wall - built[0]
    p5 = MEASURED.get("phase5_decode_tokens_s", "not run in this mode")
    log(f"  phase 17b processor: {len(rows)} rows in {wall} s, of it the "
        f"pool actor's engine build {built[0]} s; after the build "
        f"{len(rows) / served} rows/s, {n_tok / served} generated tokens/s, "
        f"{decode / served} decode tokens/s (the whole run "
        f"{len(rows) / wall} rows/s, {n_tok / wall} generated tokens/s, "
        f"{decode / wall} decode tokens/s; phase 5's closed loop: {p5} "
        f"decode tokens/s); every "
        f"row's tokens identical to a direct engine's (prefix hits "
        f"{history}; the direct sequence's {direct_cached}; rows held to a "
        f"fresh engine repeating their history: {redone}); launches "
        f"{launches}; on {smi}")
    log(f"phase 17b took {time.perf_counter() - t_phase:.1f} s")
    return launches


def data_shuffle(smi):
    """17c, shuffle: ``random_shuffle`` of 96,000 rows of an id and 16
    float64 columns in 48 blocks, the channel exchange against the task
    exchange in turns (2 each, after a warm-up ``materialize``; bench.py
    takes 3); GB/s of the best of each, and the channel exchanges
    counted."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
    from ray_tpu_torch.data import _exchange

    width = P17C_SHUFFLE_WIDTH
    ds = rdata.range(P17C_SHUFFLE_ROWS,
                     parallelism=P17C_SHUFFLE_BLOCKS).map_batches(
        lambda b: {"id": b["id"],
                   "x": np.tile(b["id"][:, None].astype(np.float64),
                                (1, width))})
    nbytes = P17C_SHUFFLE_ROWS * (width + 1) * 8
    counts = {"channel": 0}
    orig = _exchange._channel_exchange

    def counting(*a, **k):
        out = orig(*a, **k)
        counts["channel"] += 1
        return out

    _exchange._channel_exchange = counting
    times = {"channel": [], "tasks": []}
    try:
        ds.materialize()
        for rep in range(2):
            for arm in times:
                cfg.set("data_exchange_transport", arm)
                t0 = time.perf_counter()
                out = ds.random_shuffle(seed=rep).materialize()
                if out.count() != P17C_SHUFFLE_ROWS:
                    raise AssertionError(f"phase 17c: {arm} shuffle lost "
                                         "rows")
                times[arm].append(time.perf_counter() - t0)
    finally:
        cfg.set("data_exchange_transport", "channel")
        _exchange._channel_exchange = orig
    if counts["channel"] < 1:
        raise AssertionError("phase 17c: no channel exchange ran (every "
                             "channel arm fell back to tasks)")
    gbps = {arm: nbytes / min(ts) / 1e9 for arm, ts in times.items()}
    log(f"  phase 17c shuffle ({P17C_SHUFFLE_ROWS} x {width + 1} float64, "
        f"{P17C_SHUFFLE_BLOCKS} blocks, {nbytes / 1e6} MB): channel "
        f"{gbps['channel']} GB/s, tasks {gbps['tasks']} GB/s (best of 2 "
        f"each, in turns; s {times}), channel/tasks "
        f"{gbps['channel'] / gbps['tasks']}; data_channel_exchanges "
        f"{counts['channel']}; on {smi}")


def data_ingest(smi):
    """17c, ingest A/B: ``iter_batches(batch_size=4096,
    device_put="cuda")`` over 65,536 rows of 256 f32 (4 MiB a batch), each
    batch through the same step (three ``torch.matmul``s, the sum read
    back), buffered (the loader thread) against inline (``.to("cuda")`` on
    the consumer's thread) in turns, twice each after a warm-up, and the
    same count of steps on one pre-staged batch; both arms' sums equal."""
    from ray_tpu_torch import data as rdata

    d, bs = P17C_INGEST_D, P17C_INGEST_BS
    ing = rdata.range(P17C_INGEST_ROWS, parallelism=16).map_batches(
        lambda b: {"x": np.tile(b["id"][:, None].astype(np.float32),
                                (1, d))})
    w = torch.full((d, d), 1.0 / d, device="cuda")

    def step(x):
        y = torch.matmul(x, w)
        y = torch.matmul(torch.tanh(y), w)
        return torch.matmul(y, w).sum().item()

    def buffered():
        return [step(b["x"]) for b in ing.iter_batches(batch_size=bs,
                                                       device_put="cuda")]

    def inline():
        return [step(torch.from_numpy(hb["x"]).to("cuda"))
                for hb in ing.iter_batches(batch_size=bs)]

    step(torch.ones((bs, d), device="cuda"))
    if buffered() != inline():
        raise AssertionError("phase 17c ingest: the arms' sums differ")
    t_buf, t_inl = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        n_steps = len(buffered())
        t_buf.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        if len(inline()) != n_steps:
            raise AssertionError("phase 17c ingest: the arms' step counts "
                                 "differ")
        t_inl.append(time.perf_counter() - t0)
    xb = torch.ones((bs, d), device="cuda")
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(xb)
    t_roof = time.perf_counter() - t0
    log(f"  phase 17c ingest ({P17C_INGEST_ROWS} x {d} f32, batches of {bs}"
        f", {n_steps} steps a pass): steps/s buffered "
        f"{n_steps / min(t_buf)}, inline {n_steps / min(t_inl)}, pre-staged "
        f"{n_steps / t_roof}; overlap speedup (inline / buffered) "
        f"{min(t_inl) / min(t_buf)}, efficiency (pre-staged / buffered) "
        f"{t_roof / min(t_buf)}; s buffered {t_buf}, inline {t_inl}; "
        f"host cores {len(os.sched_getaffinity(0))}; on {smi}")


def phase_data(smi, loop, storage):
    """Phase 17a and 17c on phase 15's cluster (or, in ``--data``, one of
    their own): 17a the trainer fed by a Dataset in a GPU worker, 17c the
    shuffle and ingest A/Bs in this driver. Returns 17a's launches."""
    t0 = time.perf_counter()
    launches = phase17a(smi, loop, storage)
    log(f"phase 17a took {time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    data_shuffle(smi)
    data_ingest(smi)
    log(f"phase 17c took {time.perf_counter() - t:.1f} s")
    log(f"phase 17 data: 17a and 17c passed in "
        f"{time.perf_counter() - t0:.1f} s; on {smi}")
    return launches


def phase_data_alone(smi):
    """``--data``: phase 17b on phase 12's tree (``serve_cfg()``) drawn
    here from phase 12's seed, then freed; then 17a and 17c on a cluster
    of their own. Returns nothing."""
    import gc

    from ray_tpu_torch.models import llama

    cfg = serve_cfg()
    params = llama.init_params(cfg, _gen(ENGINE_KW["seed"]))
    phase17b(smi, cfg, params)
    del params
    gc.collect()
    llama8b_loop = trainer_loops()[0]
    on_cluster("phase 17", lambda storage: phase_data(smi, llama8b_loop,
                                                      storage))


# --------------------------------------------------------- phases 19, 20

# Phase 19: ray_tpu's hazard script (four grid trials, ASHA, two at a
# time) as Llama-3.2-1B training trials on the in-process runtime.
P19_LRS = [1e-4, 3e-4, 1e-3, 3e-3]
P19_MAX_T = 6
# The card memory a stopped trial may leave behind, all trials together.
P19_LEFT_BYTES = 64 << 20


def session_threads():
    return [t for t in threading.enumerate() if t.name == "train-session"]


def phase19(smi):
    """``Tuner.fit`` over Llama-3.2-1B training steps on
    ``init(address="local")``: four trials of ``grid_search`` over the
    learning rate, two at a time, ASHA (max_t 6, grace 2, factor 2), each
    trial 15b's state (``_gen(12)``) and token row, one ``tune.report`` a
    step. Checks the first losses against a direct step, ASHA's stops,
    the best result, the stopped trials' threads and memory, and the
    launches. Returns the launches over ``fit``."""
    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama.LLAMA3_1B, fused_ops=True)
    tokens = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to("cuda")
    free_card()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tx = spmd.default_optimizer(lr=P19_LRS[0], warmup=1)
    state = spmd.init_train_state(cfg, _gen(12), tx)
    step = spmd.make_train_step(cfg, tx)
    state, metrics = step(state, tokens)
    direct_loss = metrics["loss"].item()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, metrics = step(state, tokens)
    metrics["loss"].item()
    direct_ms = (time.perf_counter() - t) * 1e3
    del state, metrics, step
    free_card()

    def trainable(config):
        tx = spmd.default_optimizer(lr=config["lr"], warmup=1)
        state = spmd.init_train_state(cfg, _gen(12), tx)
        step = spmd.make_train_step(cfg, tx)
        for _ in range(P19_MAX_T):
            t = time.perf_counter()
            state, metrics = step(state, tokens)
            loss = metrics["loss"].item()
            tune.report({"loss": loss,
                         "step_ms": (time.perf_counter() - t) * 1e3})

    zero_counts()
    ray_tpu_torch.init(address="local")
    t = time.perf_counter()
    try:
        results = tune.Tuner(
            trainable, param_space={"lr": tune.grid_search(P19_LRS)},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=2, seed=0,
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", max_t=P19_MAX_T,
                    grace_period=2, reduction_factor=2))).fit()
        fit_s = time.perf_counter() - t
    finally:
        ray_tpu_torch.shutdown()
    launches = read_counts()
    deadline = time.monotonic() + 60
    while session_threads():
        if time.monotonic() > deadline:
            raise AssertionError("phase 19: a trial's thread outlived fit()")
        time.sleep(0.05)
    free_card()
    # Each thread that ran a matmul holds a cuBLAS workspace of its own
    # from the caching allocator (PyTorch keys them by handle and stream,
    # and keeps them after the thread ends): library caches, not trial
    # state. Read what is left before and after dropping them.
    with_ws = torch.cuda.memory_allocated() - base
    torch._C._cuda_clearCublasWorkspaces()
    left = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated()
    trial_ms = [h["step_ms"] for r in results for h in r.history[1:]]
    ran = {r.config["lr"]: len(r.history) for r in results}
    log(f"  phase 19 trials (lr: steps) {ran}; final losses "
        f"{ {r.config['lr']: r.metrics['loss'] for r in results} }; first "
        f"losses { {r.config['lr']: r.history[0]['loss'] for r in results} }"
        f" against the direct step's {direct_loss}")
    log(f"  phase 19 ms a step: trials' median {median(trial_ms)} (two "
        f"trials share the card; first steps left out), direct "
        f"{direct_ms}; fit {fit_s:.1f} s; peak {peak / 1e9} GB; left "
        f"after shutdown {left} bytes ({with_ws} with the trial threads' "
        f"cuBLAS workspaces); launches {launches}; phase "
        f"{time.perf_counter() - t0:.1f} s; on {smi}")
    for r in results:
        if r.error:
            raise AssertionError(f"phase 19: trial {r.config}: {r.error}")
        first = r.history[0]["loss"]
        if first != direct_loss:
            raise AssertionError(f"phase 19: trial {r.config} first loss "
                                 f"{first} != the direct step's "
                                 f"{direct_loss}")
    stopped = [n for n in ran.values() if n < P19_MAX_T]
    if not stopped or any(n not in (2, 4) for n in stopped):
        raise AssertionError(f"phase 19: ASHA's stops {ran} (steps a trial)")
    full = [r for r in results if len(r.history) == P19_MAX_T]
    best = results.get_best_result()
    want = min(full, key=lambda r: r.metrics["loss"])
    if best.trial_id != want.trial_id:
        raise AssertionError(f"phase 19: best {best.config} is not the "
                             f"lowest final loss of the full trials, "
                             f"{want.config}")
    if left > P19_LEFT_BYTES:
        raise AssertionError(f"phase 19: {left} bytes still allocated "
                             "after fit() and shutdown()")
    if peak >= 80e9:
        raise AssertionError(f"phase 19: peak {peak} bytes")
    require_launches("phase 19", launches,
                     ("decode_attention", "paged_decode_attention"))
    log(f"phase 19 tune: passed in {time.perf_counter() - t0:.1f} s; best "
        f"lr {best.config['lr']}; on {smi}")
    return launches


# Phase 20: a forward of Llama-3.2-1B from seed 0 over a seeded prompt of
# 256 tokens (the flash gate takes S >= 256, a multiple of 128), run by a
# client-mode driver and by a submitted job, each as one {"GPU": 0.5}
# task, held to this driver's own forward. The task's source is shared
# text, so the client and the job's driver ship it by value.
P20_PROMPT = 256
P20_TASK = '''
import os


def p20_forward(prompt, last=False):
    """LLAMA3_1B (fused ops) from seed 0 on this process's card: argmax
    tokens and the f32 logit sum over ``prompt``, with this process's
    kernel launches over the call; with ``last``, also the last
    position's logits as a bf16 tensor on the card."""
    import dataclasses
    import importlib

    import torch

    llama = importlib.import_module("ray_tpu_torch.models.llama")
    kernels = importlib.import_module("ray_tpu_torch.ops").KERNELS
    before = {n: f.launches for n, f in kernels.items()}
    cfg = dataclasses.replace(llama.LLAMA3_1B, fused_ops=True)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    with torch.no_grad():
        raw = llama.forward(params, torch.tensor([prompt], device="cuda"),
                            cfg)[0]
        logits = raw.float()
    out = {"argmax": logits.argmax(-1).tolist(),
           "sum": logits.sum().item(), "pid": os.getpid(),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "launches": {n: f.launches - before[n]
                        for n, f in kernels.items()}}
    if last:
        out["last"] = raw[-1].to(torch.bfloat16).clone()
    del params, logits, raw
    torch.cuda.empty_cache()
    return out
'''
P20_CLIENT = P20_TASK + '''

def main():
    import json
    import sys
    import time

    import ray_tpu_torch

    t0 = time.perf_counter()
    ray_tpu_torch.init(address=sys.argv[1])
    task = ray_tpu_torch.remote(num_gpus=0.5, num_cpus=0)(p20_forward)
    out = ray_tpu_torch.get(task.remote(json.loads(sys.argv[2])),
                            timeout=300)

    class Owned:
        def pid(self):
            return os.getpid()

    owned = ray_tpu_torch.remote(num_cpus=0)(Owned).remote()
    out["actor"] = [owned.actor_id.hex(),
                    ray_tpu_torch.get(owned.pid.remote(), timeout=120)]
    out["client_s"] = time.perf_counter() - t0
    print("P20 " + json.dumps(out), flush=True)
    # Exit without shutdown(): the gateway's session cleanup must kill
    # the actor this session owns.
    os._exit(0)


main()
'''
P20_JOB = P20_TASK + '''

def main():
    import json
    import sys

    import ray_tpu_torch

    ray_tpu_torch.init()  # RTPU_ADDRESS, set by the job's supervisor
    task = ray_tpu_torch.remote(num_gpus=0.5, num_cpus=0)(p20_forward)
    out = ray_tpu_torch.get(task.remote(json.loads(sys.argv[1])),
                            timeout=300)
    print("P20 " + json.dumps(out), flush=True)
    ray_tpu_torch.shutdown()


main()
'''


def p20_line(text, label):
    lines = [ln for ln in text.splitlines() if ln.startswith("P20 ")]
    if len(lines) != 1:
        raise AssertionError(f"phase 20{label}: {len(lines)} result lines "
                             f"in:\n{text[-3000:]}")
    return json.loads(lines[0][4:])


def p20_check(label, got, want):
    if got["argmax"] != want["argmax"]:
        bad = sum(a != b for a, b in zip(got["argmax"], want["argmax"]))
        raise AssertionError(f"phase 20{label}: {bad} argmax tokens differ "
                             "from the driver's forward")
    rel = abs(got["sum"] - want["sum"]) / abs(want["sum"])
    if rel > 1e-3:
        raise AssertionError(f"phase 20{label}: logit sum {got['sum']} vs "
                             f"{want['sum']} (relative {rel})")
    if got["visible"] in (None, ""):
        raise AssertionError(f"phase 20{label}: the GPU task ran in a "
                             f"process that sees no card ({got})")
    require_launches(f"phase 20{label}", got["launches"],
                     ("decode_attention", "paged_decode_attention",
                      "flash_attention_bwd"))
    return rel


def phase20(smi, storage):
    """On an ``init()`` cluster: (a) a client-mode driver (a child
    process) through this process's gateway: one ``{"GPU": 0.5}`` task
    of ``P20_TASK``, then an actor it owns, left alive at its exit; (b)
    ``python -m ray_tpu_torch.scripts.cli submit`` of a job whose driver
    joins the cluster and runs the same task. Returns the two tasks'
    launches, summed."""
    import ray_tpu_torch
    from ray_tpu_torch.client.server import start_gateway
    from ray_tpu_torch.core.runtime_context import require_runtime
    from ray_tpu_torch.jobs import JobStatus, JobSubmissionClient

    t0 = time.perf_counter()
    rt = require_runtime()
    from ray_tpu_torch.models import llama

    prompt = np.random.RandomState(20).randint(
        0, llama.LLAMA3_1B.vocab_size, P20_PROMPT).tolist()
    server = start_gateway(rt)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(ray_tpu_torch.__file__))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    try:
        child = subprocess.Popen(
            [sys.executable, "-c", P20_CLIENT, "client://" + server.address,
             json.dumps(prompt)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
        # The driver's own forward while the client starts.
        scope = {}
        exec(P20_TASK, scope)
        want = scope["p20_forward"](prompt)
        out, _ = child.communicate(timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"phase 20a: the client exited "
                                 f"{child.returncode}:\n{out[-3000:]}")
        got_a = p20_line(out, "a")
        t_a = time.perf_counter() - t0
        # (b) starts at once: its task finds (a)'s GPU worker idle.
        job_py = os.path.join(storage, "p20_job.py")
        with open(job_py, "w") as f:
            f.write(P20_JOB)
        t_b = time.perf_counter()
        submit = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "submit",
             "--address", rt.head_addr, "--submission-id", "phase20b",
             "--timeout", "300", "--", sys.executable, job_py,
             json.dumps(prompt)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
        aid, actor_pid = got_a["actor"]
        deadline = time.monotonic() + 30
        while True:
            live = [a for a in rt.list_actors()
                    if a.get("actor_id") == aid
                    and a.get("state") != "DEAD"]
            if not live and not alive(actor_pid):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 20a: the client's owned actor "
                                     f"outlived its session: {live}")
            time.sleep(0.1)
        gone_s = time.perf_counter() - t0 - t_a
        out, _ = submit.communicate(timeout=300)
        if submit.returncode != 0:
            raise AssertionError(f"phase 20b: cli submit exited "
                                 f"{submit.returncode}:\n{out[-3000:]}")
        t_b = time.perf_counter() - t_b
    finally:
        server.stop()
    client = JobSubmissionClient()
    status = client.get_job_status("phase20b")
    logs = client.get_job_logs("phase20b")
    if status != JobStatus.SUCCEEDED or "job phase20b -> SUCCEEDED" not in out:
        raise AssertionError(f"phase 20b: job status {status}:\n{out[-3000:]}")
    got_b = p20_line(logs, "b")
    if p20_line(out, "b (cli)") != got_b:
        raise AssertionError("phase 20b: the cli's logs differ from the "
                             "job's")
    rel_a = p20_check("a", got_a, want)
    rel_b = p20_check("b", got_b, want)
    MEASURED["phase20_a"] = got_a  # phase 21's reference
    launches = dict(got_a["launches"])
    add_counts(launches, got_b["launches"])
    log(f"  phase 20a client mode: {P20_PROMPT}-token forward of "
        f"Llama-3.2-1B in GPU worker {got_a['pid']} "
        f"(CUDA_VISIBLE_DEVICES={got_a['visible']!r}), argmax equal to the "
        f"driver's, logit sum relative difference {rel_a}; the client's "
        f"run {got_a['client_s']:.1f} s; its owned actor gone "
        f"{gone_s:.1f} s after the client's exit")
    log(f"  phase 20b job through the cli: SUCCEEDED, argmax equal to the "
        f"driver's, logit sum relative difference {rel_b}; task in GPU "
        f"worker {got_b['pid']}: "
        f"{'the same worker as 20a' if got_b['pid'] == got_a['pid'] else 'a new worker, not 20a'}'s; "
        f"submit to exit {t_b:.1f} s")
    log(f"phase 20 client mode and jobs: passed in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}; on {smi}")
    return launches


# --------------------------------------------------------------- phase 21

# Phase 21's steps: shared text run by value in the cluster's workers, on
# top of phase 20's forward. A CPU worker cannot take a CUDA tensor (it
# raises NoCardError), so the CPU check runs before the forward.
P21_STEPS = P20_TASK + '''

def p21_prompt(seed, n, vocab):
    """Phase 20's seeded prompt."""
    import numpy as np

    return np.random.RandomState(seed).randint(0, vocab, n).tolist()


def p21_check(prompt, n, vocab, attempts):
    """Checks the prompt and passes it on; its first attempt fails as a
    dropped connection does."""
    with open(attempts, "a") as f:
        f.write("ran\\n")
    if len(prompt) != n or not all(0 <= t < vocab for t in prompt):
        raise ValueError(f"phase 21: a bad prompt of {len(prompt)} tokens")
    with open(attempts) as f:
        if f.read().count("ran") < 2:
            raise ConnectionResetError("phase 21: the first attempt's "
                                       "connection was reset")
    return prompt


def p21_forward(prompt, marker):
    """Phase 20's forward, with the last position's bf16 logits; appends
    to ``marker`` each time it runs."""
    with open(marker, "a") as f:
        f.write("ran\\n")
    return p20_forward(prompt, last=True)
'''
P21_BUDGET_S = 15.0


def phase21(smi, storage):
    """On phase 20's cluster and its warm ``{"GPU": 0.5}`` worker: (a) a
    durable workflow ``p21_prompt`` (CPU) -> ``p21_check`` (CPU, its
    first attempt raises ``ConnectionResetError`` under
    ``retry_exceptions=(ConnectionError,)``) -> ``p21_forward`` (the
    forward of phase 20 with the last position's bf16 logits on the
    card, in phase 20a's GPU worker; a driver that joined the cluster
    returns its leases when it shuts down, so 20b's job left that worker
    idle on top of the node's pool): argmax and f32 logit sum bit-equal to phase 20a's, the
    forward's launches equal to 20a's exactly and its marker written
    once, the check run twice; ``resume`` of the finished id returns the
    same and launches nothing; the stored bf16 tensor loads back onto
    the card bit-equal. (b) The state API lists the card's node with
    ``GPU`` and the model label (the short form of nvidia-smi's name),
    the three steps' tasks and timeline events; the dashboard's JSON
    carries the label. (c) At most ``P21_BUDGET_S``. Returns the
    forward's launches."""
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import workflow
    from ray_tpu_torch.core.accelerators import gpu_name_to_accelerator_type
    from ray_tpu_torch.core.resources import LABEL_ACCELERATOR_TYPE
    from ray_tpu_torch.core.runtime_context import require_runtime
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import KERNELS
    from ray_tpu_torch.util import dashboard, state, timeline

    t0 = time.perf_counter()
    p20 = MEASURED["phase20_a"]
    rt = require_runtime()
    gpu_workers = sum(s["cold_gpu"] for s in rt.spawn_stats())
    scope = {"__name__": "__main__"}
    exec(P21_STEPS, scope)
    vocab = llama.LLAMA3_1B.vocab_size
    attempts = os.path.join(storage, "p21_check.txt")
    marker = os.path.join(storage, "p21_forward.txt")
    var = "RTPU_TORCH_WORKFLOW_STORAGE"
    old = os.environ.get(var)
    os.environ[var] = os.path.join(storage, "p21_workflows")
    try:
        prompt = workflow.step(name="p21_prompt")(
            scope["p21_prompt"]).bind(20, P20_PROMPT, vocab)
        checked = workflow.step(
            name="p21_check", max_retries=2,
            retry_exceptions=(ConnectionError,))(scope["p21_check"]).bind(
                prompt, P20_PROMPT, vocab, attempts)
        forward = workflow.step(name="p21_forward", max_retries=0)(
            ray_tpu_torch.remote(num_gpus=0.5, num_cpus=0)(
                scope["p21_forward"])).bind(checked, marker)
        t = time.perf_counter()
        out = workflow.run(forward, workflow_id="phase21")
        run_s = time.perf_counter() - t
        before = {n: f.launches for n, f in KERNELS.items()}
        t = time.perf_counter()
        again = workflow.resume("phase21", forward)
        resume_s = time.perf_counter() - t
        resumed = {n: f.launches - before[n] for n, f in KERNELS.items()}
        done, stored = workflow._load_result("phase21", forward.step_id())
        status = workflow.get_status("phase21")
    finally:
        if old is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = old
    if out["argmax"] != p20["argmax"] or out["sum"] != p20["sum"]:
        bad = sum(a != b for a, b in zip(out["argmax"], p20["argmax"]))
        raise AssertionError(
            f"phase 21a: {bad} argmax tokens differ, logit sum "
            f"{out['sum']!r} vs phase 20a's {p20['sum']!r}")
    if out["launches"] != p20["launches"]:
        raise AssertionError(f"phase 21a: the forward's launches "
                             f"{out['launches']} differ from one forward's "
                             f"{p20['launches']}")
    require_launches("phase 21a", out["launches"],
                     ("decode_attention", "paged_decode_attention",
                      "flash_attention_bwd"))
    with open(marker) as f:
        forward_runs = f.read().count("ran")
    with open(attempts) as f:
        check_runs = f.read().count("ran")
    if forward_runs != 1 or check_runs != 2:
        raise AssertionError(f"phase 21a: forward ran {forward_runs} times "
                             f"(want 1), check {check_runs} (want 2)")
    if any(resumed.values()):
        raise AssertionError(f"phase 21a: resume launched {resumed}")
    # Phase 20b's job left 20a's worker idle on top of the node's pool
    # (its joined driver returned the lease at shutdown); an unreturned
    # lease would send the forward to another worker, warm or new.
    spawned = sum(s["cold_gpu"] for s in rt.spawn_stats()) - gpu_workers
    if spawned or out["pid"] != p20["pid"]:
        raise AssertionError(f"phase 21a: the forward ran in GPU worker "
                             f"{out['pid']}, not phase 20a's {p20['pid']} "
                             f"({spawned} started); phase 20b's job must "
                             "return its lease")
    if status["status"] != "SUCCEEDED" or status["steps_completed"] != 3:
        raise AssertionError(f"phase 21a: status {status}")
    bits = out["last"].view(torch.int16)
    for label, got in (("resume", again), ("storage", stored)):
        tensor = got["last"]
        if not (tensor.is_cuda and tensor.dtype == torch.bfloat16
                and torch.equal(tensor.view(torch.int16), bits)):
            raise AssertionError(f"phase 21a: the {label} tensor is not the "
                                 f"run's bf16 logits on the card "
                                 f"({tensor.device}, {tensor.dtype})")
        if {k: v for k, v in got.items() if k != "last"} != \
                {k: v for k, v in out.items() if k != "last"}:
            raise AssertionError(f"phase 21a: the {label} result differs")
    if not (done and out["last"].is_cuda):
        raise AssertionError("phase 21a: no stored forward result")

    # (b) state, timeline, dashboard
    name = torch.cuda.get_device_name(0)
    model = gpu_name_to_accelerator_type(name)
    cards = [n for n in state.list_nodes()
             if n["alive"] and n["resources"].get("GPU")]
    labels = [n["labels"].get(LABEL_ACCELERATOR_TYPE) for n in cards]
    if labels != [model] or model not in smi:
        raise AssertionError(f"phase 21b: card nodes labelled {labels}, "
                             f"want [{model!r}] from {smi!r}")
    steps = ("p21_prompt", "p21_check", "p21_forward")
    tasks = [t["name"] for t in state.list_tasks(limit=1000)]
    events = [e["name"] for e in timeline.dump_timeline()
              if e.get("ph") == "X"]
    for step in steps:
        if not any(step in n for n in tasks):
            raise AssertionError(f"phase 21b: list_tasks has no {step}")
        if not any(step in n for n in events):
            raise AssertionError(f"phase 21b: the timeline has no {step}")
    checks_seen = sum("p21_check" in n for n in events)
    port = dashboard.start(port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api",
                                    timeout=30) as resp:
            api = json.loads(resp.read())
    finally:
        dashboard.stop(port)
    shown = [n.get("accelerator") for n in api["nodes"]
             if n["resources"].get("GPU")]
    if shown != [model]:
        raise AssertionError(f"phase 21b: the dashboard shows {shown}")
    took = time.perf_counter() - t0
    log(f"  phase 21a workflow: prompt -> check (2 attempts, the first "
        f"ConnectionResetError) -> forward in phase 20a's GPU worker "
        f"{out['pid']}: argmax and logit sum "
        f"bit-equal to phase 20a's, launches equal to one forward's, run "
        f"{run_s:.2f} s; resume {resume_s:.3f} s, 0 launches; the stored "
        f"bf16 logits [{out['last'].numel()}] back on {stored['last'].device}"
        f" bit-equal")
    log(f"  phase 21b state: node label {model!r} (nvidia-smi: {name!r}), "
        f"{len(tasks)} tasks listed, {checks_seen} p21_check timeline "
        f"events; dashboard on port {port} shows {shown}")
    log(f"phase 21 workflows, state and dashboard: passed in {took:.1f} s "
        f"(budget {P21_BUDGET_S} s); launches {out['launches']}; on {smi}")
    if took > P21_BUDGET_S:
        raise AssertionError(f"phase 21: {took:.1f} s, over its "
                             f"{P21_BUDGET_S} s budget")
    return out["launches"]


# Worker processes a cluster phase leases one after another, started
# together when its cluster starts (``warm_workers``): phases 13-14 lease
# 9 GPU workers (13a's task and 13b's replica share one), phase 15's
# cluster 8 GPU workers and, for its actors and RL runners, CPU workers.
WARM_GPU_13 = 9
WARM_GPU_15, WARM_CPU_15 = 8, 8
# The cluster flags that let the node start every warm worker at once and
# keep the CPU ones idle until used (GPU workers are never reaped idle).
WARM_FLAGS = {"RTPU_MAX_CONCURRENT_WORKER_SPAWNS": "24",
              "RTPU_WORKER_POOL_IDLE_TTL_S": "1800"}


def _warm_worker(card, n, barrier, hold_s):
    """One warm-up task: import what the phases' workers import (torch,
    the port's serving, training, data and RL modules); with ``card``
    also open the CUDA context, load the kernel libraries and serve two
    tokens of a one-layer model through them (cuBLAS, the kernels' first
    launches), return the cached blocks and set the launch counters back
    to 0. Waits until all ``n`` tasks of its kind are running, so each
    holds its own worker. Returns the worker's pid."""
    import os
    import time

    import torch

    import ray_tpu_torch.data  # noqa: F401
    import ray_tpu_torch.rllib  # noqa: F401
    import ray_tpu_torch.serve.llm  # noqa: F401
    import ray_tpu_torch.train  # noqa: F401

    if card:
        import dataclasses

        from ray_tpu_torch import ops
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.serve.llm import LLMEngine

        ops.build_kernels()
        cfg = dataclasses.replace(llama.tiny_config(max_seq_len=64),
                                  d_model=1024, n_heads=8, n_kv_heads=2,
                                  n_layers=1, d_ff=2048, vocab_size=1024,
                                  fused_ops=True, use_decode_kernel=True,
                                  dtype=torch.bfloat16)
        eng = LLMEngine(cfg, max_batch=1, max_len=64, prompt_buckets=[16],
                        decode_chunk=2, device="cuda")
        try:
            eng.generate([1, 2, 3], max_new_tokens=2, timeout=120)
        finally:
            eng.close()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for fn in ops.KERNELS.values():
            fn.launches = 0
    os.makedirs(barrier, exist_ok=True)
    open(os.path.join(barrier, str(os.getpid())), "w").close()
    deadline = time.monotonic() + hold_s
    while len(os.listdir(barrier)) < n and time.monotonic() < deadline:
        time.sleep(0.05)
    return os.getpid()


def warm_workers(label, n_gpu, n_cpu=0, card=True):
    """Start ``n_gpu`` GPU workers (``num_gpus=1/n_gpu`` each, no CPU) and
    ``n_cpu`` CPU workers on the running cluster together, each through
    ``_warm_worker`` under a scheduling key of its own, so that the node
    starts them at once and the phase's later leases find them idle in its
    pools instead of starting each one cold. ``card``: the GPU workers
    also open their CUDA context and warm the kernels (each idle worker
    then holds its context on the card; phase 15's trainer needs that
    memory, so its cluster warms imports only). Returns their pids."""
    import tempfile
    import types

    import ray_tpu_torch

    t0 = time.perf_counter()
    refs = []
    barrier = tempfile.mkdtemp(prefix="rtt_warm_")
    for gpu, n in ((True, n_gpu), (False, n_cpu)):
        if not n:
            continue
        opts = ({"num_gpus": 1.0 / n, "num_cpus": 0} if gpu
                else {"num_cpus": 1})
        for i in range(n):
            fn = types.FunctionType(_warm_worker.__code__,
                                    _warm_worker.__globals__,
                                    f"warm_{'gpu' if gpu else 'cpu'}_{i}")
            fn.__qualname__ = fn.__name__
            refs.append(ray_tpu_torch.remote(**opts)(fn).remote(
                gpu and card, n, os.path.join(barrier, str(gpu)), 120.0))
    try:
        pids = ray_tpu_torch.get(refs, timeout=300)
        time.sleep(1.0)  # the tasks' leases go back to the node
    finally:
        import shutil

        shutil.rmtree(barrier, ignore_errors=True)
    if len(set(pids)) != len(pids):
        raise AssertionError(f"{label}: warm-up tasks shared workers: {pids}")
    log(f"  {label}: {n_gpu} GPU (CUDA context {card}) and {n_cpu} CPU "
        f"workers started together in {time.perf_counter() - t0:.1f} s, "
        f"idle in the node's pools for the phase's leases: pids {pids}")
    return pids


@contextlib.contextmanager
def warm_flags():
    """``WARM_FLAGS`` in this process's environment (which the cluster's
    processes inherit) while a cluster phase runs."""
    saved = {k: os.environ.get(k) for k in WARM_FLAGS}
    os.environ.update(WARM_FLAGS)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spawn_line(label, rt):
    """Each node's worker starts of a cluster, by route."""
    for s in rt.spawn_stats():
        log(f"  {label} cluster, node {s['node_id'][:8]}: CPU workers "
            f"{s['forked']} forked from the zygote, {s['cold_cpu']} "
            f"cold-spawned; GPU workers {s['cold_gpu']} cold-spawned; "
            f"zygote: {s['zygote_miss'] or 'every CPU worker forked'}")


# --------------------------------------------------------------- phase 10

# Phase 10, the model zoo: (B, S) of the Mixtral cells and their depth.
MOE_CHECK_LAYERS, MOE_CHECK_S = 2, 256
MOE_LAYERS, MOE_B, MOE_S = 4, 1, 2048
ZOO_STEPS = 5


def free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def train_steps(label, loss_of, tx, opt, smi, steps=ZOO_STEPS):
    """``steps`` training steps of a model: its loss through the
    optimizer's leaf views (``loss_of(opt) -> loss``), the backward, then
    ``tx.update``, as ``make_train_step`` composes Llama's; the last step
    under the profiler. The loss must be finite and fall (step 0 has lr
    0). Returns (median ms of steps 1 to steps - 2, peak bytes, the
    profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i in range(steps):
        t = time.perf_counter()
        tracer = (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
                  if i == steps - 1 else contextlib.nullcontext())
        with tracer as prof:
            loss = loss_of(opt)
            loss.backward()
            tx.update(opt, i)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(loss.item())
        del loss
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: a non-finite loss: {losses}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    step_ms = median(walls[1:-1]) * 1e3
    # User annotations on the device timeline span other kernels.
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation) / 1e3
    log(f"  {label}: losses {losses}; step wall s {walls}; step {step_ms} "
        f"ms (median of steps 1-{steps - 2}, unprofiled), device busy "
        f"{busy} ms in the profiled step (idle share against the "
        f"unprofiled step {1 - busy / step_ms}), peak memory {peak / 1e9} "
        f"GB; on {smi}")
    return step_ms, peak, prof


def phase10a(smi):
    """Mixtral through the kernels: 2 layers at MIXTRAL_8X7B's widths in
    f32, B=1, S=256 (the flash gate's smallest length), remat on; the loss
    and every gradient through the flash kernels against the plain route
    (explicit positions keep attention position-masked, off the gate),
    within MODEL_TOL of each tensor's largest value; the top-2 expert set
    of every token and layer identical on both routes."""
    from ray_tpu_torch.models import mixtral

    cfg = dataclasses.replace(mixtral.MIXTRAL_8X7B,
                              n_layers=MOE_CHECK_LAYERS,
                              dtype=torch.float32)
    params = mixtral.init_params(cfg, _gen(40), device="cuda")
    # Leaf views of each layer, as the optimizer makes them: a gradient
    # through a slice of the stacked experts would be stack-sized.
    layers = [{k: w[i].detach().requires_grad_(True)
               for k, w in params["blocks"].items()}
              for i in range(cfg.n_layers)]
    top = ("embed", "ln_out", "lm_head")
    for name in top:
        params[name].requires_grad_(True)
    leaves = [params[n] for n in top] + [w for layer in layers
                                         for w in layer.values()]
    paths = list(top) + [f"blocks.{k}[{i}]" for i, layer in enumerate(layers)
                         for k in layer]
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_CHECK_S),
                           generator=_gen(41), device="cuda")
    positions = torch.arange(MOE_CHECK_S, device="cuda").expand(
        1, MOE_CHECK_S)
    route, picks = mixtral.route, []

    def recorded(*args):
        out = route(*args)
        picks.append(out[2].detach().sort(-1).values)
        return out

    runs = {}
    mixtral.route = recorded      # moe_ffn looks it up at each call
    try:
        for name, pos in (("kernels", None), ("plain", positions)):
            picks.clear()
            zero_counts()
            loss, metrics = mixtral.loss_fn(params, tokens, cfg,
                                            positions=pos, layers=layers)
            chosen = list(picks[:cfg.n_layers])   # the first forward's
            grads = torch.autograd.grad(loss, leaves)
            runs[name] = (loss.detach(), metrics, grads, chosen,
                          read_counts())
            del loss
    finally:
        mixtral.route = route
    (lk, mk, gk, ck, nk), (lp, _, gp, cp, n_plain) = (runs["kernels"],
                                                      runs["plain"])
    if (nk["flash_attention"], nk["flash_attention_bwd"]) != (
            2 * cfg.n_layers, cfg.n_layers) or n_plain["flash_attention"] \
            or n_plain["flash_attention_bwd"]:
        raise AssertionError(f"phase 10a launches: kernels {nk}, plain "
                             f"{n_plain}")
    moved = []
    for layer, (a, b) in enumerate(zip(ck, cp)):
        tokens_moved = (a != b).any(-1).nonzero().flatten().tolist()
        moved += [(layer, t) for t in tokens_moved]
    if moved:
        raise AssertionError(f"phase 10a: {len(moved)} (layer, token) top-2 "
                             f"sets differ between the routes: {moved[:20]}")
    worst = close_enough(lk, lp, MODEL_TOL, MODEL_TOL, "mixtral loss")
    for path, got, want in zip(paths, gk, gp):
        top = want.abs().max().item()
        err = close_enough(got, want, MODEL_TOL, MODEL_TOL * top,
                           f"mixtral grad {path}")
        worst = max(worst, err / max(top, 1e-30))
    log(f"phase 10a Mixtral through the kernels: {cfg.n_layers} layers at "
        f"8x7B widths f32, B=1 S={MOE_CHECK_S}, loss {lk.item()} (ce "
        f"{mk['ce'].item()}, aux {mk['aux'].item()}; plain {lp.item()}), "
        f"every gradient ({len(gk)} tensors) vs the plain route: worst "
        f"error {worst} of the tensor's largest value (tol {MODEL_TOL}); "
        f"top-2 sets identical for {MOE_CHECK_S} tokens x {cfg.n_layers} "
        f"layers; launches {nk}; on {smi}")
    del params, layers, leaves, runs, gk, gp
    free_card()


# Device time of the MoE step by group: kernels by name first, then the
# others by the mixtral.* profiler range (or the backward node of an op
# inside one) that launched them.
MOE_NAMED = (
    ("flash forward", ("::fwd_sm90<", "::fwd_kernel<")),
    ("flash backward", ("::dkdv_sm90<", "::dq_sm90<", "::delta_kernel<",
                        "::dkdv_kernel<", "::dq_kernel<")),
    ("optimizer", ("multi_tensor_apply", "fused_adam", "FusedAdam")),
)
MOE_RANGES = {"mixtral.experts": "expert FFN (bf16 bmm, silu*up)",
              "mixtral.dispatch": "dispatch/combine (f32, with the router)"}


def moe_breakdown(prof):
    """Device ms of the profiled step by group. A kernel belongs to the
    range whose CPU op launched it, or to the range of the forward op
    whose backward node launched it (autograd's sequence number links
    the two); the rest of the step is "other"."""
    from torch.autograd import DeviceType

    def named(kernel):
        return next((g for g, keys in MOE_NAMED
                     if any(k_ in kernel for k_ in keys)), None)

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def in_range(e):
        while e is not None:
            if e.name in MOE_RANGES:
                return e.name
            e = e.cpu_parent
        return None

    seq = {e.sequence_nr: r for e in cpu
           if e.sequence_nr >= 0 and (r := in_range(e))}

    def group(e):
        while e is not None:
            if e.name in MOE_RANGES:
                return e.name
            if (e.name.startswith("autograd::engine::evaluate_function")
                    and e.sequence_nr in seq):
                return seq[e.sequence_nr]
            e = e.cpu_parent
        return None

    groups = {g: 0.0 for g, _ in MOE_NAMED}
    groups.update({g: 0.0 for g in MOE_RANGES.values()})
    total = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        us = ev.time_range.elapsed_us()
        total += us
        g = named(ev.name)
        if g:
            groups[g] += us
    for e in cpu:
        r = group(e)
        if r is None:
            continue
        for k in e.kernels:
            if named(k.name) is None:
                groups[MOE_RANGES[r]] += k.duration
    groups["other"] = total - sum(groups.values())
    return {g: us / 1e3 for g, us in groups.items()}


def phase10b(smi):
    """The Mixtral training step: MIXTRAL_8X7B's widths cut to 4 layers,
    bf16, remat "nothing", B=1 S=2048, default_optimizer(lr=1e-4,
    warmup=1), 5 steps on one batch from a numpy seed, the last under the
    profiler. Returns the kernels' launches a step."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel import spmd

    free_card()
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(mixtral.MIXTRAL_8X7B, n_layers=MOE_LAYERS)
    assert (cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.dtype,
            cfg.remat, cfg.remat_policy) == (4096, 14336, 8, 2,
                                             torch.bfloat16, True, "nothing")
    tx = spmd.default_optimizer(lr=1e-4, warmup=1)
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, _gen(42), device="cuda")
    opt = tx.init(params, stacked=mixtral.STACKED)
    torch.cuda.synchronize()
    log(f"phase 10b Mixtral train: 8x7B widths cut to {cfg.n_layers} of 32 "
        f"layers, {cfg.param_count() / 1e9:.3f}B params "
        f"({cfg.active_param_count() / 1e9:.3f}B active), bf16, B={MOE_B} "
        f"S={MOE_S}, capacity {cfg.capacity(MOE_B * MOE_S)} tokens per "
        f"expert, remat "
        f"{cfg.remat_policy}, fused AdamW; init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({held} "
        "bytes before)")
    tokens = torch.from_numpy(np.random.RandomState(12).randint(
        0, cfg.vocab_size, (MOE_B, MOE_S))).to("cuda")
    aux = []

    def loss_of(opt):
        loss, metrics = mixtral.loss_fn(params, tokens, cfg,
                                        layers=opt.layers["blocks"])
        aux.append((metrics["ce"], metrics["aux"]))
        return loss

    zero_counts()
    step_ms, peak, prof = train_steps("phase 10b", loss_of, tx, opt, smi)
    launches = read_counts()
    parts = [(c.item(), a.item()) for c, a in aux]
    if not all(np.isfinite(parts).flatten()):
        raise AssertionError(f"phase 10b: non-finite ce or aux: {parts}")
    per_step = {n: 0 for n in launches}
    per_step.update(flash_attention=2 * cfg.n_layers,
                    flash_attention_bwd=cfg.n_layers)
    want = {n: c * ZOO_STEPS for n, c in per_step.items()}
    if launches != want:
        raise AssertionError(f"phase 10b launches {launches}, expected "
                             f"{want}")
    if peak >= 80e9:
        raise AssertionError(f"phase 10b: peak memory {peak} bytes")
    tokens_s = MOE_B * MOE_S / (step_ms / 1e3)
    flops = cfg.flops_per_token(MOE_S) * MOE_B * MOE_S
    groups = moe_breakdown(prof)
    log(f"  phase 10b (ce, aux) per step {parts}; launch check passed: per "
        f"step {per_step}")
    log(f"  phase 10b step: {step_ms} ms, {tokens_s} tokens/s, MFU by "
        f"active parameters {flops / (step_ms / 1e3) / BF16_FLOPS} "
        f"({flops / 1e12} TFLOP a step: 6 x {cfg.n_layers} layers' "
        "attention, top-2 experts and router + lm_head, + 12*L*d*S), peak "
        f"memory {peak / 1e9} GB ({peak / 2**30} GiB); on {smi}")
    log("  phase 10b device time of the profiled step by group, ms: "
        + ", ".join(f"{g} {v}" for g, v in groups.items()))
    del params, opt, prof, aux
    free_card()
    return per_step


def phase10c(smi):
    """ViT-B/16 in bf16, B=32 images from a numpy seed, 5 steps."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.parallel import spmd

    cfg = vit.VIT_B_16
    assert (cfg.image_size, cfg.patch_size, cfg.d_model, cfg.n_layers,
            cfg.dtype) == (224, 16, 768, 12, torch.bfloat16)
    params = vit.init_params(cfg, _gen(43), device="cuda")
    tx = spmd.default_optimizer(lr=3e-4, warmup=1)
    opt = tx.init(params, stacked=vit.STACKED)
    b = 32
    rng = np.random.RandomState(13)
    images = torch.from_numpy(rng.rand(b, 224, 224, 3).astype(
        np.float32)).to("cuda")
    labels = torch.from_numpy(rng.randint(0, cfg.num_classes, b)).to("cuda")
    log(f"phase 10c ViT-B/16: {cfg.param_count() / 1e6:.2f}M params, bf16, "
        f"B={b} 224x224")
    step_ms, _, _ = train_steps(
        "phase 10c", lambda opt: vit.loss_fn(
            params, images, labels, cfg, layers=opt.layers["blocks"]),
        tx, opt, smi)
    log(f"  phase 10c: {b / (step_ms / 1e3)} images/s; on {smi}")
    del params, opt
    free_card()


def phase10d(smi):
    """T5-base in bf16, B=8, 512 encoder tokens (padded: each input's
    length from a numpy seed) and 128 decoder tokens, 5 steps; then
    ``greedy_generate`` of 16 tokens for 2 inputs, twice."""
    from ray_tpu_torch.models import t5
    from ray_tpu_torch.parallel import spmd

    cfg = t5.T5_BASE
    params = t5.init_params(cfg, _gen(44), device="cuda")
    tx = spmd.default_optimizer(lr=3e-4, warmup=1)
    opt = tx.init(params, stacked=t5.STACKED)
    b, s, t = 8, 512, 128
    rng = np.random.RandomState(14)
    enc = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to("cuda")
    dec = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, t))).to("cuda")
    lengths = rng.randint(s // 2, s + 1, b)
    enc_mask = torch.from_numpy(np.arange(s)[None, :]
                                < lengths[:, None]).to("cuda")
    log(f"phase 10d T5-base: {cfg.param_count() / 1e6:.2f}M params, bf16, "
        f"B={b}, encoder {s} tokens (valid lengths {lengths.tolist()}), "
        f"decoder {t}")
    step_ms, _, _ = train_steps(
        "phase 10d", lambda opt: t5.loss_fn(params, enc, dec, cfg,
                                            enc_mask=enc_mask,
                                            layers=opt.layers)[0], tx, opt,
        smi)
    t0 = time.perf_counter()
    outs = [t5.greedy_generate(params, enc[:2], cfg, max_len=16,
                               enc_mask=enc_mask[:2]) for _ in range(2)]
    torch.cuda.synchronize()
    gen_s = (time.perf_counter() - t0) / 2
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"phase 10d: greedy tokens differ between two "
                             f"runs: {outs[0].tolist()} vs {outs[1].tolist()}")
    log(f"  phase 10d: {b * (s + t) / (step_ms / 1e3)} tokens/s (encoder + "
        f"decoder); greedy 16 tokens x 2 inputs identical twice, "
        f"{gen_s} s a run: {outs[0].tolist()}; on {smi}")
    del params, opt
    free_card()


def phase10e(smi):
    """The UNet at ``DiffusionConfig()``'s defaults (32x32x3, widths
    64/128/256, f32), B=64 images from a numpy seed, 5 steps on timesteps
    and noise drawn once; then ``sample`` of 4 images over all 1000
    steps."""
    from ray_tpu_torch.models import diffusion
    from ray_tpu_torch.parallel import spmd

    cfg = diffusion.DiffusionConfig()
    params = diffusion.init_params(cfg, _gen(45), device="cuda")
    sched = diffusion.cosine_schedule(cfg, "cuda")
    tx = spmd.default_optimizer(lr=3e-4, warmup=1)
    opt = tx.init(params, stacked=diffusion.STACKED)
    b = 64
    x0 = torch.from_numpy(np.random.RandomState(15).uniform(
        -1, 1, (b, 32, 32, 3)).astype(np.float32)).to("cuda")
    t = torch.randint(0, cfg.num_steps, (b,), generator=_gen(46),
                      device="cuda")
    eps = torch.randn(x0.shape, generator=_gen(47), device="cuda")
    log(f"phase 10e UNet: {cfg.param_count() / 1e6:.3f}M params, f32, B={b} "
        "32x32x3")
    step_ms, _, _ = train_steps(
        "phase 10e", lambda opt: diffusion.loss_fn(params, x0, None, cfg,
                                                   sched, t=t, eps=eps)[0],
        tx, opt, smi)
    t0 = time.perf_counter()
    out = diffusion.sample(params, _gen(48), cfg, batch=4, schedule=sched)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    if out.shape != (4, 32, 32, 3) or not torch.isfinite(out).all():
        raise AssertionError(f"phase 10e: sample {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    log(f"  phase 10e: {b / (step_ms / 1e3)} images/s; sample of 4 over "
        f"{cfg.num_steps} steps {sample_s} s, finite, std "
        f"{out.std().item()}; on {smi}")
    del params, opt
    free_card()


def phase_zoo(smi):
    """Phase 10: Mixtral (10a, 10b), ViT (10c), T5 (10d) and the UNet
    (10e). Returns the kernels' launches a step of 10b. ViT, T5 and the
    UNet run no port kernel (``ray_tpu`` runs no Pallas kernel there)."""
    t0 = time.perf_counter()
    phase10a(smi)
    per_step = phase10b(smi)
    zero_counts()
    phase10c(smi)
    phase10d(smi)
    phase10e(smi)
    stray = {n: c for n, c in read_counts().items() if c}
    if stray:
        raise AssertionError(f"phases 10c-10e launched port kernels: {stray}")
    log(f"phase 10 model zoo: {time.perf_counter() - t0:.1f} s; on {smi}")
    return per_step


# --------------------------------------------------------------- phase 11

# Phase 11a: the card against the CPU, f32 with TF32 off (phase 1): within
# RL_TOL of each tensor's largest value; a scalar stat's scale is
# max(|stat|, 1), as tests/test_torch_rllib*.py hold stats against
# ray_tpu's (stats such as mean_kl are means of differences of O(1) terms).
RL_TOL = 1e-4
# A policy whose action logits differ by at least this much: any correct
# sampler takes the argmax (the rollout check of 11a).
RL_DECISIVE_GAP = 50.0


def rl_close(got, want, what, floor=1e-30):
    got = torch.as_tensor(got).detach().float().cpu()
    want = torch.as_tensor(want).detach().float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite")
    scale = max(want.abs().max().item() if want.numel() else 0.0, floor)
    err = (got - want).abs().max().item() if want.numel() else 0.0
    if err > RL_TOL * scale:
        raise AssertionError(f"{what}: max abs err {err} > {RL_TOL} x "
                             f"{scale}")
    return err / scale


def rl_rollout_batch(rng, T, B, obs_size=4):
    term = rng.random((T, B)) < 0.05
    trunc = (rng.random((T, B)) < 0.02) & ~term
    return {
        "obs": rng.normal(size=(T, B, obs_size)).astype(np.float32),
        "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
        "logp": -rng.uniform(0.4, 1.0, (T, B)).astype(np.float32),
        "values": rng.normal(size=(T, B)).astype(np.float32),
        "rewards": np.ones((T, B), np.float32),
        "terminated": term, "truncated": trunc,
        "bootstrap_value": np.where(trunc, rng.normal(size=(T, B)),
                                    0.0).astype(np.float32),
        "last_value": rng.normal(size=B).astype(np.float32),
    }


def rl_transitions(rng, n, obs_size, act_size=0):
    return {
        "obs": rng.normal(size=(n, obs_size)).astype(np.float32),
        "actions": (rng.uniform(-2, 2, (n, act_size)).astype(np.float32)
                    if act_size else
                    rng.integers(0, 2, n).astype(np.int32)),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_size)).astype(np.float32),
        "dones": (rng.random(n) < 0.05).astype(np.float32),
    }


def rl_learner_cases(rng):
    """(name, make(device), update(learner) -> stats, trees(learner)) of
    one update each, batches and draws from ``rng``, at the gates' batch
    sizes (PPO 16 envs x 256 steps in minibatches of 512; IMPALA 16 x
    128; DQN 64 with prioritised weights; SAC 128; BC and CQL 256)."""
    from ray_tpu_torch.rllib import (BCLearner, CQLLearner, DQNLearner,
                                     PPOLearner, SACLearner)
    from ray_tpu_torch.rllib.impala import IMPALALearner

    ppo = rl_rollout_batch(rng, 256, 16)
    perms = np.stack([rng.permutation(256 * 16) for _ in range(4)])
    impala = rl_rollout_batch(rng, 128, 16)
    dqn = rl_transitions(rng, 64, 4)
    dqn["weights"] = rng.uniform(0.2, 1.0, 64).astype(np.float32)
    sac = rl_transitions(rng, 128, 3, act_size=1)
    noise = [rng.normal(size=(128, 1)).astype(np.float32) for _ in range(2)]
    offline = rl_transitions(rng, 256, 4)

    def sac_update(learner):
        grads, stats, _ = learner.compute_grads(sac, noise=noise)
        learner.apply_grads(grads)
        return stats

    return (
        ("PPOLearner",
         lambda d: PPOLearner(4, 2, minibatch_size=512, seed=0, device=d),
         lambda l: l.update_from_batch(ppo, perms=perms),
         lambda l: [l.params]),
        ("DQNLearner",
         lambda d: DQNLearner(4, 2, target_update_freq=1, seed=0, device=d),
         lambda l: l.update_from_batch(dqn),
         lambda l: [l.params, l.target_params]),
        ("SACLearner",
         lambda d: SACLearner(3, 1, act_scale=2.0, seed=0, device=d),
         sac_update,
         lambda l: [l.actor, l.critic, l.target_critic,
                    {"log_alpha": l.log_alpha}]),
        ("IMPALALearner",
         lambda d: IMPALALearner(4, 2, lr=1e-3, seed=0, device=d),
         lambda l: l.update_from_batch(impala),
         lambda l: [l.params]),
        ("BCLearner",
         lambda d: BCLearner(4, 2, lr=3e-3, seed=0, device=d),
         lambda l: l.update_from_batch(offline),
         lambda l: [l.params]),
        ("CQLLearner",
         lambda d: CQLLearner(4, 2, target_update_freq=1, seed=0,
                              device=d),
         lambda l: l.update_from_batch(offline),
         lambda l: [l.params, l.target_params]),
    )


def decisive_policy(seed=0):
    """The seed's policy weights (CPU tensors) with the action head scaled
    by 1e6: logits far apart wherever the policy is not near a tie."""
    from ray_tpu_torch.rllib import models

    p = models.init_policy_params(torch.Generator().manual_seed(seed), 4,
                                  2, 64, "cpu")
    p["pi"]["w2"] *= 1e6
    p["pi"]["b2"] *= 1e6
    return p


def phase11a(smi):
    """One update of each learner on the card and on the CPU from the same
    seed's weights, batches and draws: every parameter and stat within
    RL_TOL. Then a rollout of ``EnvRunner`` (16 CartPoles x 256 steps) on
    both under a decisive policy: identical actions, flags, rewards and
    episode returns."""
    from ray_tpu_torch.rllib import EnvRunner, models

    for name, make, update, trees in rl_learner_cases(
            np.random.default_rng(0)):
        out = {}
        for dev in ("cuda", "cpu"):
            learner = make(dev)
            stats = update(learner)
            leaves = [t for tree in trees(learner)
                      for t in models.leaves(tree)]
            if dev == "cuda" and any(t.device.type != "cuda"
                                     for t in leaves):
                raise AssertionError(f"phase 11a {name}: a tensor is off "
                                     "the card")
            out[dev] = (stats, leaves)
        (cs, cl), (ps, pl) = out["cuda"], out["cpu"]
        if set(cs) != set(ps):
            raise AssertionError(f"phase 11a {name}: stats {sorted(cs)} vs "
                                 f"{sorted(ps)}")
        worst_stat = max(rl_close(cs[k], ps[k], f"{name} {k}", floor=1.0)
                         for k in ps)
        worst_param = max(rl_close(g, w, f"{name} tensor {i}")
                          for i, (g, w) in enumerate(zip(cl, pl)))
        log(f"  phase 11a {name}: card vs CPU, {len(pl)} tensors, worst "
            f"error / largest value: params {worst_param}, stats "
            f"{worst_stat} (limit {RL_TOL}); on {smi}")
    params = decisive_policy()
    rollouts = {}
    for dev in ("cuda", "cpu"):
        runner = EnvRunner("CartPole", 16, 256, seed=0, device=dev)
        runner.set_weights(params)
        rollouts[dev] = (runner.sample(), runner.get_metrics())
    (cr, cm), (pr, pm) = rollouts["cuda"], rollouts["cpu"]
    with torch.no_grad():
        logits, _ = models.policy_apply(params, torch.from_numpy(pr["obs"]))
    gap = (logits[..., 1] - logits[..., 0]).abs().min().item()
    if gap < RL_DECISIVE_GAP:
        raise AssertionError(f"phase 11a rollout: logit gap {gap} < "
                             f"{RL_DECISIVE_GAP}")
    for k in ("obs", "actions", "rewards", "terminated", "truncated"):
        if not np.array_equal(cr[k], pr[k]):
            raise AssertionError(f"phase 11a rollout: {k} differ")
    if cm != pm or not pm["num_episodes"]:
        raise AssertionError(f"phase 11a rollout: returns {cm} vs {pm}")
    err = max(rl_close(cr[k], pr[k], f"rollout {k}")
              for k in ("logp", "values", "bootstrap_value", "last_value"))
    log(f"  phase 11a rollout: 16 x 256 CartPole steps, actions, flags and "
        f"rewards identical, {pm['num_episodes']} episodes, returns "
        f"{pm['episode_return_mean']} on both; min logit gap {gap}; "
        f"logp/values worst error / largest value {err}; on {smi}")


def expert_batches(n_steps=1500, noise=0.2, seed=0):
    """The scripted PD-controller expert with epsilon-noise of
    tests/test_rllib_sac_offline.py:90-111 (numpy CartPole)."""
    from ray_tpu_torch.rllib.env import CartPoleVecEnv

    env = CartPoleVecEnv(num_envs=8, seed=seed)
    rng = np.random.default_rng(seed)
    obs = env.reset(seed=seed)
    batches = []
    for _ in range(n_steps):
        expert = (obs[:, 2] + 0.4 * obs[:, 3] > 0).astype(np.int32)
        rand = rng.integers(0, 2, len(expert)).astype(np.int32)
        a = np.where(rng.random(len(expert)) < noise, rand, expert)
        prev = obs
        obs, r, done, info = env.step(a)
        batches.append({"obs": prev, "actions": a, "rewards": r,
                        "next_obs": np.where(done[:, None],
                                             info["final_obs"], obs),
                        "dones": info["terminated"].astype(np.float32)})
    return batches


def _runner_return(result):
    return result["env_runners"]["episode_return_mean"]


def _agents_return(result):
    rets = [m["episode_return_mean"] for m in result["env_runners"].values()
            if m["episode_return_mean"] is not None]
    return float(np.mean(rets)) if rets else None


def rl_gate_algos(device):
    """(label, build(), budget, threshold, score(result, algo)) of each
    gate, with the configs, budgets and thresholds of ray_tpu's tests."""
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, DQNConfig,
                                     OfflineData, PPOConfig, SACConfig)
    from ray_tpu_torch.rllib.impala import IMPALAConfig
    from ray_tpu_torch.rllib.multi_agent import (IndependentEnsembleEnv,
                                                 MultiAgentPPOConfig)

    def pair(num_envs, seed):
        return IndependentEnsembleEnv({"a0": "CartPole", "a1": "CartPole"},
                                      num_envs=num_envs, seed=seed)

    data = {}

    def offline():
        if "d" not in data:
            # OfflineData reads a ray_tpu_torch.data Dataset: once, on the
            # in-process runtime; then the columns are held on the host.
            import ray_tpu_torch

            ray_tpu_torch.init(local_mode=True)
            try:
                data["d"] = OfflineData.from_batches(expert_batches())
                len(data["d"])
            finally:
                ray_tpu_torch.shutdown()
        return data["d"]

    def evaluated(result, algo):
        return algo.evaluate()["env_runners"]["episode_return_mean"]

    return (
        ("PPO CartPole (tests/test_rllib.py:118-137)",
         lambda: (PPOConfig(device=device).environment("CartPole")
                  .env_runners(num_env_runners=0,
                               num_envs_per_env_runner=16,
                               rollout_fragment_length=256)
                  .training(lr=3e-4, minibatch_size=512).build()),
         80, 450.0, lambda r, a: _runner_return(r)),
        ("DQN CartPole (tests/test_rllib_dqn.py:71-94)",
         lambda: (DQNConfig(device=device).environment("CartPole")
                  .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                               rollout_fragment_length=32)
                  .training(lr=1e-3, train_batch_size=64,
                            target_network_update_freq=250,
                            num_steps_sampled_before_learning_starts=1000,
                            updates_per_iteration=32).build()),
         120, 130.0, lambda r, a: _runner_return(r)),
        ("IMPALA CartPole, local (tests/test_rllib_impala.py:79-98)",
         lambda: (IMPALAConfig(device=device).environment("CartPole")
                  .env_runners(num_env_runners=0,
                               num_envs_per_env_runner=16,
                               rollout_fragment_length=128)
                  .training(lr=1e-3, entropy_coeff=0.01).build()),
         150, 150.0, lambda r, a: _runner_return(r)),
        ("multi-agent PPO, shared policy (tests/test_rllib_impala.py:"
         "147-172)",
         lambda: MultiAgentPPOConfig(
             env=pair, policies=("shared",),
             policy_mapping={"a0": "shared", "a1": "shared"},
             num_env_runners=0, num_envs_per_runner=8, rollout_len=128,
             minibatch_size=512, seed=0, device=device).build(),
         40, 100.0, lambda r, a: _agents_return(r)),
        ("SAC Pendulum (tests/test_rllib_sac_offline.py:62-83)",
         lambda: (SACConfig(device=device).environment("Pendulum")
                  .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                               rollout_fragment_length=16)
                  .training(actor_lr=3e-4, critic_lr=3e-4,
                            train_batch_size=128,
                            num_steps_sampled_before_learning_starts=500,
                            updates_per_iteration=48).build()),
         120, -700.0, lambda r, a: _runner_return(r)),
        ("BC, scripted expert (tests/test_rllib_sac_offline.py:139-159)",
         lambda: (BCConfig(device=device).environment("CartPole")
                  .training(lr=3e-3, train_batch_size=256,
                            updates_per_iteration=150)
                  .offline_data(offline()).build()),
         6, 150.0, evaluated),
        ("CQL, scripted expert (tests/test_rllib_sac_offline.py:162-183)",
         lambda: (CQLConfig(device=device).environment("CartPole")
                  .training(lr=1e-3, cql_alpha=1.0, train_batch_size=256,
                            target_network_update_freq=200,
                            updates_per_iteration=200)
                  .offline_data(offline()).build()),
         8, 150.0, evaluated),
    )


def phase11b(smi):
    """Each learning gate on the card, stopping at its threshold as
    ray_tpu's tests do. Returns {label: iterations to the threshold}."""
    out = {}
    for label, build, budget, threshold, score in rl_gate_algos("cuda"):
        t = time.perf_counter()
        algo = build()
        best, it, result = -float("inf"), 0, None
        while it < budget and best < threshold:
            result = algo.train()
            it += 1
            s = score(result, algo)
            if s is not None:
                best = max(best, s)
        took = time.perf_counter() - t
        if best < threshold:
            raise AssertionError(f"phase 11b {label}: best {best} < "
                                 f"{threshold} within {budget} iterations")
        if label.startswith("BC"):
            acc = result["learners"]["default_policy"]["action_accuracy"]
            if not acc > 0.7:
                raise AssertionError(f"phase 11b BC: action accuracy {acc}")
            label += f", action accuracy {acc}"
        out[label] = it
        log(f"  phase 11b {label}: best {best} >= {threshold} at iteration "
            f"{it} of {budget}, {took} s; on {smi}")
    return out


class _Clock:
    """Wall time and calls of a wrapped callable."""

    def __init__(self, fn):
        self.fn, self.s, self.calls = fn, 0.0, 0

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.s += time.perf_counter() - t
            self.calls += 1


@contextlib.contextmanager
def count_host_syncs():
    """Counts the operations that wait for the card (PyTorch's sync debug
    mode warns at each) inside the block: ``out["syncs"]``."""
    import warnings

    out = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield out
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["syncs"] = sum("synchronizing" in str(w.message) for w in seen)


def device_busy_ms(fn):
    """fn() under the profiler, ended by a synchronize: the CUDA kernels'
    and copies' time in ms (user annotations span other work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation) / 1e3


def ppo_iteration_split(device, iters):
    """PPO at the gate's config on ``device``: after one warm-up
    iteration, ms an iteration over ``iters``, split into sampling (env
    steps; policy forwards and host copies) and the learner update."""
    algo = rl_gate_algos(device)[0][1]()
    runner = algo.env_runners._local
    algo.train()
    step = runner.env.step = _Clock(runner.env.step)
    sample = runner.sample = _Clock(runner.sample)
    update = algo.learner.update_from_batch = _Clock(
        algo.learner.update_from_batch)
    t = time.perf_counter()
    for _ in range(iters):
        algo.train()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / iters * 1e3
    steps = 16 * 256
    return algo, {
        "iteration_ms": wall,
        "sampling_ms": sample.s / iters * 1e3,
        "env_step_ms": step.s / iters * 1e3,
        "forward_and_copy_ms": (sample.s - step.s) / iters * 1e3,
        "update_ms": update.s / iters * 1e3,
        "env_steps_per_s": steps / (sample.s / iters),
    }


def off_policy_iteration_split(algo, warmup):
    """One iteration of a DQN or SAC algorithm after ``warmup``
    iterations (learning has started): ms of the iteration, of the
    collection (env steps; forwards and copies) and of the updates, env
    steps/s, host syncs, and one update's wall and (profiled) device busy
    time."""
    for _ in range(warmup):
        algo.train()
    if len(algo.buffer) < algo.config.learning_starts:
        raise AssertionError("phase 11c: learning has not started")
    runner = algo.env_runners._local
    step = runner.env.step = _Clock(runner.env.step)
    collect = algo._collect = _Clock(algo._collect)
    update = algo.learner_group.update_from_batch = _Clock(
        algo.learner_group.update_from_batch)
    with count_host_syncs() as syncs:
        t = time.perf_counter()
        algo.train()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    learner = algo.learner_group._local
    batch = algo.buffer.sample(algo.config.train_batch_size)
    learner.update_from_batch(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    learner.update_from_batch(batch)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t) * 1e3
    busy = device_busy_ms(lambda: learner.update_from_batch(batch))
    steps = algo.config.rollout_steps * algo.config.num_envs_per_runner
    return {"iteration_ms": wall, "collect_ms": collect.s * 1e3,
            "env_step_ms": step.s * 1e3,
            "forward_and_copy_ms": (collect.s - step.s) * 1e3,
            "env_steps_per_s": steps / collect.s,
            "updates": update.calls, "updates_ms": update.s * 1e3,
            "host_syncs": syncs["syncs"], "update_ms": update_ms,
            "update_busy_ms": busy, "update_idle_share": 1 - busy / update_ms}


def phase11c(smi):
    """Where an iteration's time goes: PPO at the gate's config on the card
    (sampling and update, host syncs, env steps/s, one profiled update's
    device busy time and idle share), the same on the CPU, then one DQN
    and one SAC iteration on the card."""
    algo, split = ppo_iteration_split("cuda", iters=3)
    with count_host_syncs() as syncs:
        algo.train()
        torch.cuda.synchronize()
    batch = algo.env_runners._local.sample()
    learner = algo.learner
    learner.update_from_batch(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    learner.update_from_batch(batch)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t) * 1e3
    busy = device_busy_ms(lambda: learner.update_from_batch(batch))
    sample_busy = device_busy_ms(algo.env_runners._local.sample)
    log(f"  phase 11c PPO on the card (16 envs x 256 steps, 4 epochs of "
        f"minibatch 512, hidden 64), ms an iteration, mean of 3: "
        f"{json.dumps(split)}; host syncs an iteration {syncs['syncs']}; "
        f"one update: {update_ms} ms wall, device busy {busy} ms (profiled),"
        f" idle share {1 - busy / update_ms}; one rollout's device busy "
        f"{sample_busy} ms against {split['sampling_ms']} ms of sampling; "
        f"on {smi}")
    _, cpu = ppo_iteration_split("cpu", iters=3)
    log(f"  phase 11c PPO on the CPU, same config and host: {json.dumps(cpu)}"
        f"; card / CPU iteration time {split['iteration_ms'] / cpu['iteration_ms']}"
        f", update {split['update_ms'] / cpu['update_ms']}; on {smi}")
    gates = rl_gate_algos("cuda")
    for (label, build, *_), warmup in ((gates[1], 4), (gates[4], 4)):
        out = off_policy_iteration_split(build(), warmup)
        log(f"  phase 11c {label.split(' (')[0]} on the card, one iteration "
            f"after learning starts: {json.dumps(out)}; on {smi}")


def start_p11b(smi):
    """11b's learning gates in a process of their own, started before
    phases 13-14 so they run beside the cluster phases (each gate is a
    host-bound loop on one core; the cluster phases wait on their
    replicas). Returns what ``join_p11b`` takes."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="rtt_p11b_", suffix=".log")
    with os.fdopen(fd, "w") as out:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--p11b", smi, path + ".card"],
                                stdout=out, stderr=subprocess.STDOUT)
    return proc, path, time.perf_counter()


def wait_p11b_card(p11b, timeout=120.0):
    """Wait until 11b's process holds its CUDA context (phase 13 counts
    the card's compute apps before and after its cluster)."""
    proc, path, _ = p11b
    deadline = time.monotonic() + timeout
    while not os.path.exists(path + ".card"):
        if proc.poll() is not None or time.monotonic() > deadline:
            join_p11b(p11b)
            raise AssertionError("phase 11b's process never reached the "
                                 "card")
        time.sleep(0.1)


def join_p11b(p11b):
    """Wait for ``start_p11b``'s process and print its lines; raise with
    its output if it failed."""
    proc, path, t0 = p11b
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        with open(path) as f:
            text = f.read()
        os.unlink(path)
        if os.path.exists(path + ".card"):
            os.unlink(path + ".card")
    for line in text.splitlines():
        log(line)
    if rc != 0:
        raise AssertionError(f"phase 11b's process exited {rc}: "
                             f"{text[-3000:]}")
    log(f"phase 11b's process: {time.perf_counter() - t0:.1f} s from its "
        f"start after phase 9 to this join")


def p11b_main(smi, card_file):
    """``--p11b``: 11b alone in this process; no port kernel may launch.
    Writes ``card_file`` once its CUDA context exists."""
    from ray_tpu_torch import ops

    torch.zeros(1, device="cuda")
    open(card_file, "w").close()
    zero_counts()
    gates = phase11b(smi)
    require_launches("phase 11b", read_counts(), tuple(ops.KERNELS))
    log(f"phase 11b gates (iterations to the threshold): {gates}")


def phase_rllib(smi, p11b):
    """Phase 11: RLlib on the card (11a, 11b, 11c); no port kernel may
    launch. ``p11b``: 11b runs in its own process (``start_p11b``),
    joined here."""
    from ray_tpu_torch import ops

    t0 = time.perf_counter()
    zero_counts()
    phase11a(smi)
    join_p11b(p11b)
    phase11c(smi)
    require_launches("phase 11", read_counts(), tuple(ops.KERNELS))
    log(f"phase 11 RLlib: {time.perf_counter() - t0:.1f} s; on {smi}")


# -------------------------------------------------------------- phase 11d

# ray_tpu's tolerance of a learner gang against one learner
# (tests/test_rllib_dqn.py:150-163).
GANG_RTOL, GANG_ATOL = 1e-4, 1e-5


def phase11d_collectives(smi, world=8):
    """(i) ``world`` CPU rank actors (``num_cpus=0``) join one group at
    once and run allreduce, allgather, barrier, reducescatter and
    broadcast, checked as ray_tpu's test checks them
    (tests/test_rllib_dqn.py:97-131)."""
    import ray_tpu_torch
    from ray_tpu_torch.actor import create_actors

    # Defined here, so the cluster ships the class by value.
    @ray_tpu_torch.remote(num_cpus=0)
    class Rank:
        def __init__(self, rank, world):
            from ray_tpu_torch.util import collective

            collective.init_collective_group(world, rank, "p11d")
            self.rank = rank

        def run(self):
            from ray_tpu_torch.util import collective as col

            out = col.allreduce(np.full(4, self.rank + 1.0), "p11d")
            gathered = col.allgather(np.array([self.rank]), "p11d")
            col.barrier("p11d")
            chunk = col.reducescatter(np.arange(8.0), "p11d")
            b = col.broadcast(np.array([42.0]) if self.rank == 3 else None,
                              root=3, group_name="p11d")
            return (out.tolist(), [g.tolist() for g in gathered],
                    chunk.tolist(), b.tolist())

    t = time.perf_counter()
    ranks = create_actors(lambda i: Rank.remote(i, world), world)
    try:
        results = ray_tpu_torch.get([r.run.remote() for r in ranks],
                                    timeout=120)
    finally:
        for r in ranks:
            ray_tpu_torch.kill(r)
        ray_tpu_torch.kill(ray_tpu_torch.get_actor("rtpu-collective-p11d"))
    total = float(sum(range(1, world + 1)))
    for rank, (red, gathered, chunk, b) in enumerate(results):
        if (red != [total] * 4 or gathered != [[i] for i in range(world)]
                or chunk != [float(rank) * world] or b != [42.0]):
            raise AssertionError(f"phase 11d(i) rank {rank}: {red}, "
                                 f"{gathered}, {chunk}, {b}")
    log(f"  phase 11d(i): {world} rank actors, allreduce, allgather, "
        f"barrier, reducescatter and broadcast as ray_tpu's test checks "
        f"them; {(time.perf_counter() - t) * 1e3} ms with the actors' "
        f"start; on {smi}")


def gpu_held(total, want, timeout=10.0):
    """The cluster's GPU in use, once it reads ``want`` (the head's view
    follows the node's heartbeats) or at ``timeout``."""
    import ray_tpu_torch

    deadline = time.monotonic() + timeout
    while True:
        held = total - ray_tpu_torch.available_resources().get("GPU", 0.0)
        if abs(held - want) < 1e-6 or time.monotonic() > deadline:
            return held
        time.sleep(0.2)


def phase11d_gang(smi, algo, device, rows=128):
    """(ii) The gang of (iii)'s DQN, 2 learners each in a GPU worker on
    ``{"GPU": 0.5}``, before it trains, against one DQN learner built in
    this process as the gang's ranks build theirs (the config's arguments
    and seed): one update on the same seeded batch, every weight within
    GANG_RTOL/GANG_ATOL, ``td_errors`` in batch order. Returns the local
    learner and the batch, which time an update after (iii)."""
    from ray_tpu_torch.rllib import DQNLearner

    c = algo.config
    local = DQNLearner(4, 2, hidden=c.hidden, lr=c.lr, gamma=c.gamma,
                       target_update_freq=c.target_update_freq,
                       seed=c.seed, device=device)
    rng = np.random.default_rng(1)
    batch = {
        "obs": rng.normal(size=(rows, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, rows).astype(np.int32),
        "rewards": rng.normal(size=rows).astype(np.float32),
        "next_obs": rng.normal(size=(rows, 4)).astype(np.float32),
        "dones": np.zeros(rows, np.float32),
    }
    want = local.update_from_batch(dict(batch))
    got = algo.learner_group.update_from_batch(dict(batch))
    td = np.asarray(got["td_errors"])
    if td.shape != (rows,) or not np.allclose(
            td, want["td_errors"], rtol=GANG_RTOL, atol=GANG_ATOL):
        raise AssertionError(f"phase 11d(ii): td_errors {td.shape} not "
                             f"the local learner's in batch order")
    w_gang = algo.learner_group.get_weights()["q"]
    worst = 0.0
    for k, w in local.get_weights()["q"].items():
        w = w.detach().cpu().numpy()
        g = w_gang[k].numpy()
        if not np.allclose(g, w, rtol=GANG_RTOL, atol=GANG_ATOL):
            raise AssertionError(f"phase 11d(ii): weight {k} off by "
                                 f"{np.abs(g - w).max()}")
        worst = max(worst, float(np.abs(g - w).max()))
    log(f"  phase 11d(ii): (iii)'s DQN gang of 2 against one learner on "
        f"the card in this process, {rows} rows: every weight within rtol "
        f"{GANG_RTOL} atol {GANG_ATOL} (worst {worst}), td_errors in batch "
        f"order; on {smi}")
    return local, batch


def phase11d_dqn(smi, device, budget=45, threshold=40.0, timed=10):
    """(ii) and (iii) on one DQN with 2 remote runners (CPU workers) and 2
    learners on the card, ``ray_tpu``'s config and gate
    (tests/test_rllib_dqn.py:172-195): its gang held to one learner before
    it trains (ii, one update, so (iii) starts from it), then trained to
    the gate, best return >= ``threshold`` within ``budget`` iterations
    (iii); then the ms of a gang update and of a local one (medians of
    ``timed``)."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import DQNConfig

    total = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
    t = time.perf_counter()
    algo = (DQNConfig(device=device).environment("CartPole")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .training(lr=1e-3, train_batch_size=64,
                      num_steps_sampled_before_learning_starts=500,
                      updates_per_iteration=32)
            .learners(num_learners=2).build())
    start_s = time.perf_counter() - t
    best, it, learning_ms = -float("inf"), 0, []
    try:
        held = gpu_held(total, 1.0 if device is None else 0.0)
        if device is None and abs(held - 1.0) > 1e-6:
            raise AssertionError(f"phase 11d(ii): the gang holds {held} GPU, "
                                 "not two leases of 0.5")
        local, batch = phase11d_gang(smi, algo, device)
        t0 = time.perf_counter()
        while it < budget and best < threshold:
            t = time.perf_counter()
            result = algo.train()
            if result["learners"]["default_policy"]:
                learning_ms.append((time.perf_counter() - t) * 1e3)
            it += 1
            ret = result["env_runners"]["episode_return_mean"]
            if ret is not None:
                best = max(best, ret)
        took = time.perf_counter() - t0
        gang_ms, local_ms = [], []
        for _ in range(timed):
            t = time.perf_counter()
            algo.learner_group.update_from_batch(dict(batch))
            gang_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            local.update_from_batch(dict(batch))
            if device is None:
                torch.cuda.synchronize()
            local_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        algo.stop()
    if best < threshold:
        raise AssertionError(f"phase 11d(iii): best {best} < {threshold} "
                             f"within {budget} iterations")
    log(f"  phase 11d(iii): DQN, 2 remote runners and 2 learners on the "
        f"card (GPU held {held} of {total}; built with its runners and gang "
        f"in {start_s} s): best {best} >= {threshold} at iteration {it} of "
        f"{budget}, {took} s; ms an iteration once learning started, "
        f"median of {len(learning_ms)}: {median(learning_ms)}; on {smi}")
    log(f"  phase 11d(ii): ms an update of the {len(batch['actions'])}-row "
        f"batch, median of {timed}: gang {median(gang_ms)}, local "
        f"{median(local_ms)} (gang/local "
        f"{median(gang_ms) / median(local_ms)}); on {smi}")
    return {"gang_ms": median(gang_ms), "local_ms": median(local_ms),
            "start_s": start_s, "iterations": it,
            "iteration_ms": median(learning_ms)}


def phase11d_builds(device):
    """The algorithms of (iv) and (v), by label: IMPALA with 2
    asynchronous runners, PPO and multi-agent PPO (phase 11b's shared
    policy) with 2 remote runners each."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.impala import IMPALAConfig
    from ray_tpu_torch.rllib.multi_agent import (IndependentEnsembleEnv,
                                                 MultiAgentPPOConfig)

    def pair(num_envs, seed):
        return IndependentEnsembleEnv({"a0": "CartPole", "a1": "CartPole"},
                                      num_envs=num_envs, seed=seed)

    return {
        "IMPALA": lambda: (IMPALAConfig(device=device).environment("CartPole")
                           .env_runners(num_env_runners=2,
                                        num_envs_per_env_runner=4,
                                        rollout_fragment_length=32).build()),
        "PPO": lambda: (PPOConfig(device=device).environment("CartPole")
                        .env_runners(num_env_runners=2,
                                     num_envs_per_env_runner=8,
                                     rollout_fragment_length=128)
                        .training(lr=3e-4, minibatch_size=512).build()),
        "multi-agent PPO": lambda: MultiAgentPPOConfig(
            env=pair, policies=("shared",),
            policy_mapping={"a0": "shared", "a1": "shared"},
            num_env_runners=2, num_envs_per_runner=8, rollout_len=128,
            minibatch_size=512, seed=0, device=device).build()}


def phase11d_impala(smi, algo, steps=4):
    """(iv) IMPALA with 2 asynchronous runners: ``steps`` training steps,
    each consuming one rollout and re-arming its runner, two rollouts in
    flight throughout; ``_total_steps`` 4 envs x 32 steps a rollout."""
    if len(algo._inflight) != 2:
        raise AssertionError(f"phase 11d(iv): {len(algo._inflight)} "
                             "rollouts in flight after the build")
    ms = []
    for _ in range(steps):
        t = time.perf_counter()
        stats = algo.training_step()
        ms.append((time.perf_counter() - t) * 1e3)
        if not np.isfinite(stats["total_loss"]) or len(algo._inflight) != 2:
            raise AssertionError(f"phase 11d(iv): loss {stats}, "
                                 f"{len(algo._inflight)} in flight")
    if algo._total_steps != steps * 32 * 4:
        raise AssertionError(f"phase 11d(iv): {algo._total_steps} env "
                             f"steps, not {steps * 32 * 4}")
    log(f"  phase 11d(iv): IMPALA, 2 asynchronous runners, {steps} steps, "
        f"2 rollouts in flight throughout, {algo._total_steps} env steps; "
        f"ms a step {ms}; on {smi}")
    return {"steps": steps, "step_ms": ms}


def phase11d_ppo(smi, label, algo):
    """(v) One iteration of PPO or multi-agent PPO with 2 remote runners:
    finite losses."""
    t = time.perf_counter()
    result = algo.train()
    ms = (time.perf_counter() - t) * 1e3
    losses = {pid: s["total_loss"] for pid, s in result["learners"].items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"phase 11d(v) {label}: losses {losses}")
    log(f"  phase 11d(v): {label}, 2 remote runners, one iteration of "
        f"{result['num_env_steps_sampled_lifetime']} env steps in {ms} ms, "
        f"losses {losses}; on {smi}")


def phase11d(smi, device=None):
    """Phase 11d, RLlib's remote modes on the running ``init()`` cluster:
    (i)-(v) above, each algorithm built, run and stopped in turn; (ii) and
    (iii) share one DQN. No port kernel may launch in this process.
    Returns the numbers of (ii)-(iv)."""
    from ray_tpu_torch import ops

    t0 = time.perf_counter()
    zero_counts()
    phase11d_collectives(smi)
    out = {"dqn": phase11d_dqn(smi, device)}
    for label, build in phase11d_builds(device).items():
        t = time.perf_counter()
        algo = build()
        log(f"  phase 11d: {label} built with its 2 runners in "
            f"{time.perf_counter() - t} s")
        try:
            if label == "IMPALA":
                out["impala"] = phase11d_impala(smi, algo)
            else:
                phase11d_ppo(smi, label, algo)
        finally:
            algo.stop()
    require_launches("phase 11d", read_counts(), tuple(ops.KERNELS))
    log(f"phase 11d took {time.perf_counter() - t0:.1f} s; on {smi}")
    return out


# ---------------------------------------------------------------- phase 6

class Timer:
    """Per-call device time with CUDA events. Before each timed call a
    256 MB buffer is read so the call finds the 50 MB L2 cold (as a decode
    step does: the other layers' weights pass through L2 between two
    calls of one layer) and clean: overwriting the buffer instead left up
    to 50 MB of dirty lines whose write-back shared the card's bandwidth
    with the timed call, which slowed memory-bound calls and not the empty
    kernel. A sleep kernel first lets the host queue all calls ahead of
    the card, so host overhead does not show in the device timeline."""

    def __init__(self):
        self.flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8,
                                     device="cuda")
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 10_000_000 / max(s.elapsed_time(e), 1e-3)

    def __call__(self, fn, iters=30, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(int(self.cycles_per_ms * 50))
        for s, e in evs:
            self.flush_buf.max()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in evs)
        return times[len(times) // 2]


# Phase 5's slot lengths while it decodes: prompts of 16-48 tokens plus up
# to 32 new ones, in a 512-row cache.
REAL_LENGTHS = [16, 25, 34, 43, 52, 61, 70, 80]


def launch_floor(timer):
    """The empty kernel's time under ``timer`` (ms): what a launch costs
    with no work. None for a checkout without it."""
    import ctypes

    from ray_tpu_torch.ops import _build

    fn = getattr(_build.load("fused"), "rtt_empty_kernel", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    return timer(lambda: fn(stream))


def decode_rope_times(timer, floor):
    """Rows 1, 2 and 5 at the shapes their redesign is judged at, each
    beside its bytes bound (each input read once, each output written
    once): both decode kernels at B=8 H=32 KH=8 D=128 bf16 with every row
    valid (S=512 contiguous, the engine's S=528 paged, both at S=4096) and
    at phase 5's lengths; RoPE at the decode shape and at phase 8's.
    Returns {label: ms}."""
    from ray_tpu_torch.ops import KERNELS

    b, h, kh, d, dt = 8, 32, 8, 128, torch.bfloat16
    times = {}

    def show(label, fn, nbytes):
        ms = timer(fn)
        bound = nbytes / HBM_BYTES_S * 1e3
        times[label] = ms
        vs_floor = f", {ms / floor} x the launch floor" if floor else ""
        log(f"  {label}: {ms} ms, bytes bound {bound} ms ({bound / ms} of "
            f"it){vs_floor}")

    for name, s, lengths, tag in (
            ("decode_attention", 512, [512] * b, "all rows valid"),
            ("decode_attention", 512, REAL_LENGTHS, "phase 5's lengths"),
            ("decode_attention", 4096, [4096] * b, "all rows valid"),
            ("paged_decode_attention", PAGED_S, [512] * b, "512 rows valid"),
            ("paged_decode_attention", PAGED_S, REAL_LENGTHS,
             "phase 5's lengths"),
            ("paged_decode_attention", 4096, [4096] * b, "all rows valid")):
        q, k, v, lens = decode_inputs(b, h, kh, d, s, dt, 24, lengths)
        nbytes = sum(lengths) * kh * d * 2 * 2 + 2 * q.numel() * 2 + 4 * b
        if name == "decode_attention":
            fn = (lambda q=q, k=k, v=v, lens=lens: KERNELS[name](
                q, k, v, lens, layout="bksd"))
        else:
            table = identity_table(b, s)
            nbytes += 4 * sum(-(-n // PAGE) for n in lengths)
            fn = (lambda q=q, k=k, v=v, lens=lens, table=table: KERNELS[name](
                q, k, v, table, lens, page_size=PAGE))
        show(f"{name} S={s} {tag}", fn, nbytes)
        del q, k, v
    for bb, ss, tag in ((8, 1, "decode"), (TRAIN_B, TRAIN_S, "phase 8")):
        q = _randn((bb, ss, 32, 128), dt, 33)
        k = _randn((bb, ss, 8, 128), dt, 34)
        # Contiguous positions: the wrapper copies an expanded tensor, a
        # second launch the timing would include.
        pos = (torch.arange(ss, device="cuda", dtype=torch.int32)
               + 300).expand(bb, ss).contiguous()
        show(f"qk_rope {tag} q {list(q.shape)} k {list(k.shape)}",
             lambda q=q, k=k, pos=pos: KERNELS["qk_rope"](q, k, pos,
                                                          500000.0),
             2 * (q.numel() + k.numel()) * 2 + bb * ss * 4 + 64 * 4)
    return times


def _bound(nbytes, flops, flop_rate):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_ms(rows, name):
    return next(r["ms"] for r in rows if r["name"] == name)


def phase_timing(launches, launches_phase9, launches_phase12):
    from ray_tpu_torch.ops import (KERNELS, apply_rope,
                                   decode_attention_reference,
                                   paged_decode_attention_reference,
                                   rms_norm, swiglu_reference)

    dt = torch.bfloat16
    it = 2
    timer = Timer()
    floor = launch_floor(timer)
    rows = []

    def entry(name, kernel, plain, library, nbytes, flops, rate):
        got, want = kernel(), plain()
        if isinstance(got, tuple):
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
        else:
            err = (got.float() - want.float()).abs().max().item()
        bound, by = _bound(nbytes, flops, rate)
        row = {"name": name, "route": "cuda",
               "source": KERNEL_META[name][0],
               "replaces": KERNEL_META[name][1],
               "launches": launches[name],
               "launches_phase9": launches_phase9[name],
               "launches_phase12": launches_phase12[name], "max_abs_err": err,
               "ms": timer(kernel), "plain_ms": timer(plain),
               "bound_ms": bound, "bound_by": by,
               "library_ms": timer(library) if library else None,
               "floor_ms": floor}
        rows.append(row)
        log(f"  {name}: {row['ms']} ms (plain {row['plain_ms']}, library "
            f"{row['library_ms']}, bound {bound} by {by}, launch floor "
            f"{floor}), max abs err {err}")
        return row

    log("phase 6 timing (bf16, decode shapes of phase 3, L2 flushed)")
    log(f"  launch floor, an empty kernel (one CTA of 128 threads): {floor} "
        "ms")
    # paged decode attention: the phase-7b engine's cache (S = PAGED_S),
    # every slot at 512 rows, read through the identity table.
    b, h, kh, d, s = 8, 32, 8, 128, PAGED_S
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dt, 22, [512] * b)
    table = identity_table(b, s)
    n_pages = (lens + PAGE - 1) // PAGE
    kv_bytes = int(n_pages.sum().item()) * PAGE * kh * d * 2 * it
    entry("paged_decode_attention",
          lambda: KERNELS["paged_decode_attention"](q, k, v, table, lens,
                                                    page_size=PAGE),
          lambda: paged_decode_attention_reference(q, k, v, table, lens,
                                                   PAGE),
          None,
          kv_bytes + 2 * q.numel() * it + lens.numel() * 4
          + int(n_pages.sum().item()) * 4,
          4 * int(lens.sum().item()) * h * d, BF16_FLOPS)
    # decode attention: the engine's cache, every row valid.
    b, h, kh, d, s = 8, 32, 8, 128, 512
    q, k, v, lens = decode_inputs(b, h, kh, d, s, dt, 20, [s] * b)
    mask = (torch.arange(s, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    kv_bytes = int(lens.clamp(max=s).sum().item()) * kh * d * 2 * it
    entry("decode_attention",
          lambda: KERNELS["decode_attention"](q, k, v, lens, layout="bksd"),
          lambda: decode_attention_reference(q, k, v, lens),
          lambda: F.scaled_dot_product_attention(
              q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
          kv_bytes + 2 * q.numel() * it + lens.numel() * 4,
          4 * int(lens.sum().item()) * h * d, BF16_FLOPS)
    del q, k, v
    decode_rope_times(timer, floor)

    n, dm = 8, 4096
    x = _randn((n, 1, dm), dt, 30)
    r = _randn((n, 1, dm), dt, 31)
    sc = _randn((dm,), dt, 32, scale=0.2)
    w = (1.0 + sc.float()).to(dt)
    entry("rms_norm", lambda: KERNELS["rms_norm"](x, sc, 1e-5),
          lambda: rms_norm(x, sc, 1e-5),
          lambda: F.rms_norm(x, (dm,), weight=w, eps=1e-5),
          (2 * n * dm + dm) * it, 4 * n * dm, F32_SIMT_FLOPS)
    entry("rms_norm_residual",
          lambda: KERNELS["rms_norm_residual"](x, r, sc, 1e-5),
          lambda: (rms_norm(x + r, sc, 1e-5), x + r), None,
          (4 * n * dm + dm) * it, 5 * n * dm, F32_SIMT_FLOPS)
    qd = _randn((n, 1, 32, 128), dt, 33)
    kd = _randn((n, 1, 8, 128), dt, 34)
    pos = torch.randint(0, 512, (n, 1), generator=_gen(35), device="cuda",
                        dtype=torch.int32)
    entry("qk_rope", lambda: KERNELS["qk_rope"](qd, kd, pos, 500000.0),
          lambda: (apply_rope(qd, pos, 500000.0),
                   apply_rope(kd, pos, 500000.0)), None,
          2 * (qd.numel() + kd.numel()) * it + pos.numel() * 4 + 64 * 4,
          3 * (qd.numel() + kd.numel()) + 40 * n * 64, F32_SIMT_FLOPS)
    g = _randn((n, 1, 14336), dt, 36)
    up = _randn((n, 1, 14336), dt, 37)
    entry("swiglu", lambda: KERNELS["swiglu"](g, up),
          lambda: swiglu_reference(g, up), None,
          3 * g.numel() * it, 5 * g.numel(), F32_SIMT_FLOPS)
    del x, r, g, up
    glue_train_times(timer, floor)
    flash_timing(entry, timer)
    return rows


# Launches a training step (phase 8's check) of the glue kernels.
TRAIN_GLUE_LAUNCHES = {"rms_norm": 65, "rms_norm_residual": 64, "qk_rope": 96,
                       "swiglu": 64}


def glue_train_times(timer, floor):
    """Rows 3b, 4b, 5b and 6b: RMSNorm, RMSNorm+residual, RoPE and SwiGLU
    at phase 8's shapes ([1,2048,4096]; q [1,2048,32,128] and k
    [1,2048,8,128]; SwiGLU [1,2048,14336]), bf16, each beside its bytes
    bound (each input read once, each output written once), its plain
    version, the launch floor and its launches a training step; RMSNorm
    also beside F.rms_norm."""
    from ray_tpu_torch.ops import (KERNELS, apply_rope, rms_norm,
                                   swiglu_reference)

    dt, it = torch.bfloat16, 2
    n, dm, ff = TRAIN_B * TRAIN_S, 4096, 14336
    x = _randn((TRAIN_B, TRAIN_S, dm), dt, 60)
    r = _randn((TRAIN_B, TRAIN_S, dm), dt, 61)
    sc = _randn((dm,), dt, 62, scale=0.2)
    w = (1.0 + sc.float()).to(dt)
    g = _randn((TRAIN_B, TRAIN_S, ff), dt, 63)
    up = _randn((TRAIN_B, TRAIN_S, ff), dt, 64)
    q = _randn((TRAIN_B, TRAIN_S, 32, 128), dt, 65)
    k = _randn((TRAIN_B, TRAIN_S, 8, 128), dt, 66)
    pos = torch.arange(TRAIN_S, device="cuda", dtype=torch.int32).expand(
        TRAIN_B, TRAIN_S).contiguous()
    for row, name, fn, plain, lib, nbytes in (
            ("3b", "rms_norm", lambda: KERNELS["rms_norm"](x, sc, 1e-5),
             lambda: rms_norm(x, sc, 1e-5),
             lambda: F.rms_norm(x, (dm,), weight=w, eps=1e-5),
             (2 * n * dm + dm) * it),
            ("4b", "rms_norm_residual",
             lambda: KERNELS["rms_norm_residual"](x, r, sc, 1e-5),
             lambda: (rms_norm(x + r, sc, 1e-5), x + r), None,
             (4 * n * dm + dm) * it),
            ("5b", "qk_rope",
             lambda: KERNELS["qk_rope"](q, k, pos, 500000.0),
             lambda: (apply_rope(q, pos, 500000.0),
                      apply_rope(k, pos, 500000.0)), None,
             2 * (q.numel() + k.numel()) * it + pos.numel() * 4 + 64 * 4),
            ("6b", "swiglu", lambda: KERNELS["swiglu"](g, up),
             lambda: swiglu_reference(g, up), None, 3 * n * ff * it)):
        ms = timer(fn)
        bound = nbytes / HBM_BYTES_S * 1e3
        lib_txt = f", F.rms_norm {timer(lib)} ms" if lib else ""
        log(f"  row {row} {name} at phase 8's shape: {ms} ms, bytes bound "
            f"{bound} ms ({bound / ms} of it), plain {timer(plain)} ms"
            f"{lib_txt}, launch floor {floor} ms; "
            f"{TRAIN_GLUE_LAUNCHES[name]} launches a training step, "
            f"{TRAIN_GLUE_LAUNCHES[name] * ms} ms a step at this time")
    del x, r, g, up, q, k


def sdpa_calls(q, k, v, dout):
    """F.scaled_dot_product_attention (is_causal, enable_gqa) on the same
    values laid out [B,H,S,D]: (its forward, its backward alone from one
    forward's graph, kept, and its forward + backward)."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dt_ = dout.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa()

    sdpa_out = sdpa()
    return (sdpa_fwd,
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dt_,
                                        retain_graph=True),
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt_))


def flash_timing(entry, timer):
    """The flash rows at phase 8's shape (B=1, S=2048, H=32, KH=8, D=128,
    bf16). Operations: 4*D per causal (query, key) pair forward (QK^T and
    PV), 10*D backward (QK^T recomputed, dV, dP, dQ, dK); bytes: each
    input read once and each output written once. The library call is
    F.scaled_dot_product_attention (is_causal, enable_gqa) on the same
    values laid out [B,H,S,D]: its forward, and its backward alone (from
    one forward's graph, kept); its forward + backward is printed."""
    from ray_tpu_torch.ops import (KERNELS, flash_attention_bwd_reference,
                                   flash_attention_reference)

    b, s, h, kh, d = TRAIN_B, TRAIN_S, 32, 8, 128
    q, k, v, dout = flash_inputs(b, s, h, kh, d, torch.bfloat16, 80)
    pairs = b * h * s * (s + 1) // 2
    qo_bytes, kv_bytes, lse_bytes = q.numel() * 2, k.numel() * 2, b * h * s * 4
    out, lse = KERNELS["flash_attention"](q, k, v)
    sdpa_fwd, sdpa_bwd, sdpa_fwd_bwd = sdpa_calls(q, k, v, dout)

    fwd = entry("flash_attention", lambda: KERNELS["flash_attention"](q, k, v),
                lambda: flash_attention_reference(q, k, v), sdpa_fwd,
                2 * qo_bytes + 2 * kv_bytes + lse_bytes, 4 * d * pairs,
                BF16_FLOPS)
    log(f"  flash_attention: {4 * d * pairs / fwd['ms'] / 1e9} TFLOP/s, "
        f"{fwd['bound_ms'] / fwd['ms']} of its bound; SDPA "
        f"{4 * d * pairs / fwd['library_ms'] / 1e9} TFLOP/s")
    bwd = entry("flash_attention_bwd",
                lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse,
                                                       dout),
                lambda: flash_attention_bwd_reference(q, k, v, out, lse,
                                                      dout),
                sdpa_bwd, 4 * qo_bytes + 4 * kv_bytes + lse_bytes,
                10 * d * pairs, BF16_FLOPS)
    log(f"  flash_attention_bwd: {10 * d * pairs / bwd['ms'] / 1e9} TFLOP/s "
        f"counted at 10*D a pair ({14 * d * pairs / bwd['ms'] / 1e9} "
        f"executed, 14*D), {bwd['bound_ms'] / bwd['ms']} of its bound; SDPA "
        f"{10 * d * pairs / bwd['library_ms'] / 1e9} TFLOP/s at 10*D")
    flash_bwd_parts(lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse,
                                                           dout))
    log(f"  SDPA forward + backward: {timer(sdpa_fwd_bwd)} ms")


def flash_bwd_parts(bwd, calls=10):
    """The backward's device time by kernel (delta, dK/dV, dQ), mean of
    ``calls`` back-to-back calls under torch.profiler (L2 warm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            bwd()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(delta_kernel|dkdv_sm90|dq_sm90|dkdv_kernel|"
                      r"dq_kernel)", ev.name)
        key = m.group(1) if m else ev.name[:40]
        parts[key] = parts.get(key, 0.0) + ev.time_range.elapsed_us()
    log("  flash_attention_bwd device ms per call by kernel (profiler, L2 "
        "warm): " + ", ".join(f"{k_} {v_ / calls / 1e3}"
                              for k_, v_ in parts.items()))


def back_to_back(fn, calls=20, warmup=3):
    """Mean ms of ``calls`` launches in a row, L2 warm, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / calls


def flash_probe(smi, root):
    """``--flash``: the flash kernels of the package at ``root`` against
    their plain versions, their times at phase 8's shape, then phase 8."""
    from ray_tpu_torch.ops import KERNELS

    log(f"flash probe of {root}: kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SHAPES:
            check_flash(dtype, *shape)
    q, k, v, dout = flash_inputs(TRAIN_B, TRAIN_S, 32, 8, 128,
                                 torch.bfloat16, 80)
    out, lse = KERNELS["flash_attention"](q, k, v)
    sdpa_fwd, sdpa_bwd, _ = sdpa_calls(q, k, v, dout)
    timer = Timer()
    for name, fn in (
            ("flash_attention", lambda: KERNELS["flash_attention"](q, k, v)),
            ("flash_attention_bwd",
             lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse, dout)),
            ("SDPA forward", sdpa_fwd), ("SDPA backward alone", sdpa_bwd)):
        log(f"  {name} B={TRAIN_B} S={TRAIN_S} H=32 KH=8 D=128 bf16: "
            f"{timer(fn)} ms (median, L2 flushed), {back_to_back(fn)} ms "
            f"(20 back to back, L2 warm); on {smi}")
    flash_bwd_parts(lambda: KERNELS["flash_attention_bwd"](q, k, v, out, lse,
                                                           dout))
    del q, k, v, dout, out, lse, timer, sdpa_fwd, sdpa_bwd
    phase_train(smi)


def decode_probe(smi, root):
    """``--decode``: the decode kernels and RoPE of the package at
    ``root`` against their plain versions at phase 3's shapes, the launch
    floor, then their times at the shapes of ``decode_rope_times``."""
    log(f"decode probe of {root}: kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        for s in (512, 4096):
            check_decode(dtype, s)
        for s in (PAGED_S, 4096):
            check_paged(dtype, s)
        for shape in ((8, 1), (TRAIN_B, TRAIN_S)):
            check_fused(dtype, shape)
        check_rope_bwd(dtype)
    timer = Timer()
    floor = launch_floor(timer)
    log(f"  launch floor, an empty kernel: {floor} ms; on {smi}")
    times = decode_rope_times(timer, floor)
    log("decode A/B times, ms: " + json.dumps(times))
    wrapper_host_cost(smi)


def wrapper_host_cost(smi, calls=500, rounds=5):
    """Host microseconds a call of the decode wrappers and RoPE's forward
    take at the decode shapes (median of ``rounds`` x ``calls`` calls): what
    a decode step's 32 calls of each cost its host enqueue."""
    from ray_tpu_torch.ops import (decode_attention, paged_decode_attention,
                                   fused)

    dt, b = torch.bfloat16, 8
    q, k, v, lens = decode_inputs(b, 32, 8, 128, PAGED_S, dt, 26, [64] * b)
    table = identity_table(b, PAGED_S)
    qd, kd = _randn((b, 1, 32, 128), dt, 27), _randn((b, 1, 8, 128), dt, 28)
    pos = torch.arange(b, device="cuda", dtype=torch.int32)[:, None]
    arms = {"decode_attention": lambda: decode_attention(q, k, v, lens,
                                                         layout="bksd"),
            "paged_decode_attention": lambda: paged_decode_attention(
                q, k, v, table, lens, page_size=PAGE),
            "qk_rope": lambda: fused._rope_fwd(qd, kd, pos, 500000.0)}
    out = {}
    with torch.no_grad():
        for name, fn in arms.items():
            runs = []
            for _ in range(rounds + 1):     # the first round warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                runs.append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
            out[name] = sorted(runs[1:])[rounds // 2]
    log(f"decode wrappers' host us a call (median of {rounds} x {calls}): "
        f"{json.dumps(out)}; on {smi}")


def fused_apply_cost(smi, calls=500, rounds=5):
    """What the fused ops' autograd Functions cost the serving step's host
    with gradients off: per call, each op's ``Function.apply`` against its
    bare forward at the decode shapes (the two alternate, ``calls`` calls
    each, median of ``rounds``), summed over one decode step's 129 fused
    calls (33 RMSNorm, 32 of each other op)."""
    from ray_tpu_torch.ops import fused as fz

    dt = torch.bfloat16
    x, r = _randn((8, 1, 4096), dt, 90), _randn((8, 1, 4096), dt, 91)
    sc = _randn((4096,), dt, 92, scale=0.2)
    qd, kd = _randn((8, 1, 32, 128), dt, 93), _randn((8, 1, 8, 128), dt, 94)
    pos = torch.arange(8, device="cuda", dtype=torch.int32)[:, None]
    g, up = _randn((8, 1, 14336), dt, 95), _randn((8, 1, 14336), dt, 96)
    arms = {
        "rms_norm": (33, lambda: fz._RmsNorm.apply(x, sc, 1e-5),
                     lambda: fz._rms_norm_fwd(x, sc, 1e-5)),
        "rms_norm_residual": (
            32, lambda: fz._RmsNormResidual.apply(x, r, sc, 1e-5),
            lambda: fz._rms_res_fwd(x, r, sc, 1e-5)),
        "qk_rope": (32, lambda: fz._QkRope.apply(qd, kd, pos, 500000.0),
                    lambda: fz._rope_fwd(qd, kd, pos, 500000.0)),
        "swiglu": (32, lambda: fz._SwiGLU.apply(g, up),
                   lambda: fz._swiglu_fwd(g, up)),
    }

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    extra_ms, parts = 0.0, []
    with torch.no_grad():
        for name, (per_step, apply, bare) in arms.items():
            host_us(apply), host_us(bare)          # warm-up
            t_apply, t_bare = [], []
            for _ in range(rounds):
                t_apply.append(host_us(apply))
                t_bare.append(host_us(bare))
            a = sorted(t_apply)[rounds // 2]
            b = sorted(t_bare)[rounds // 2]
            extra_ms += per_step * (a - b) / 1e3
            parts.append(f"{name} {a} vs {b}")
    log("fused ops with gradients off, host us per call, Function.apply "
        f"vs the bare forward (median of {rounds} x {calls} calls): "
        + "; ".join(parts) + f"; over a decode step's 129 fused calls "
        f"{extra_ms} ms of host time; on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    here = os.path.dirname(os.path.abspath(__file__))
    if args[:1] in (["--flash-ab"], ["--decode-ab"],
                    ["--engine-ab"]) and len(args) == 2:
        other, mode = os.path.abspath(args[1]), args[0][:-3]
        for root in (other, here, here, other):
            log(f"{mode[2:]} A/B arm: {root}")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            mode, root], check=True, timeout=900)
        return 0
    root = os.path.abspath(args[1]) if args[:1] in (["--flash"], [
        "--decode"], ["--engine"]) and len(args) == 2 else here
    sys.path.insert(0, root)
    import ray_tpu_torch  # noqa: F401 — fails outside a checkout

    if args[:1] == ["--p16c-rank"] and len(args) == 4:
        phase16c_rank(*args[1:])
        return 0
    if args[:1] == ["--p11b"] and len(args) == 3:
        p11b_main(*args[1:])
        return 0
    t_start = time.perf_counter()
    smi, name = phase_device()
    if args == ["--rllib"]:
        phase_rllib(smi, start_p11b(smi))
        on_cluster("phase 11d", lambda storage: phase11d(smi))
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    phase_build()
    if args == ["--serve"]:
        phase_serve(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args in (["--cluster"], ["--disagg"]):
        phase_cluster(smi, name, only14=args == ["--disagg"])
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args == ["--train"]:
        phase_train(smi)
        phase_trainer(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args == ["--parallel"]:
        phase_train(smi)
        phase_parallel(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args == ["--data"]:
        phase_data_alone(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args in (["--tune"], ["--client"], ["--tune", "--client"]):
        if "--tune" in args:
            phase19(smi)
        if "--client" in args:
            on_cluster("phase 20", lambda storage: (
                phase20(smi, storage), phase21(smi, storage)))
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args == ["--witness"]:
        phase_witness(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args == ["--spec-ab"]:
        spec_ab(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args[:1] in (["--flash"], ["--decode"]):
        (flash_probe if args[0] == "--flash" else decode_probe)(smi, root)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    if args[:1] == ["--engine"]:
        log(f"engine arm: {root}")
        for _ in range(3):
            phase_engine(smi)
        log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    groups = {}

    def done(label):
        now = time.perf_counter() - t_start
        groups[label] = now - sum(groups.values())
        log(f"elapsed {now:.1f} s after {label}")

    done("phases 1-2")
    phase_kernels()
    phase_model()
    done("phases 3-4")
    launches = phase_engine(smi)
    paged = phase_paged_engine(smi)
    launches["paged_decode_attention"] = paged["paged_decode_attention"]
    phase_all_knobs(smi)
    done("phases 5 and 7")
    tier = phase_engine_tier(smi)
    done("phase 9")
    p11b = start_p11b(smi)
    served, phase12 = phase_serve(smi, then=lambda cfg, params: phase17b(
        smi, cfg, params))
    done("phase 12 and 17b")
    wait_p11b_card(p11b)
    cluster, disagg, front = phase_cluster(smi, name, phase12)
    done("phases 13-14")
    train = phase_train(smi)
    done("phase 8")
    trainer, data = phase_trainer(smi, data=True)
    add_counts(data, phase12["then"])
    done("phases 15, 17a, 17c, 11d, 20 and 21")
    parallel = phase_parallel(smi)
    done("phase 16")
    tuned = phase19(smi)
    done("phase 19")
    for kernel in TRAIN_ONLY:
        launches[kernel] = train[kernel]
    zoo = phase_zoo(smi)
    done("phase 10")
    phase_rllib(smi, p11b)
    done("phases 11a-11c")
    rows = phase_timing(launches, tier, served)
    for row in rows:
        if row["name"] in TRAIN_ONLY:
            row["launches_phase10"] = zoo[row["name"]]
        row["launches_phase13"] = cluster[row["name"]]
        row["launches_phase14"] = disagg[row["name"]]
        row["launches_phase18"] = front[row["name"]]
        row["launches_phase15"] = trainer[row["name"]]
        row["launches_phase16"] = parallel[row["name"]]
        row["launches_phase17"] = data[row["name"]]
        row["launches_phase19"] = tuned[row["name"]]
        row["launches_phase20"] = MEASURED["phase20"][row["name"]]
        row["launches_phase21"] = MEASURED["phase21"][row["name"]]
        row["launches_phase22"] = MEASURED["phase22"][row["name"]]
    fused_apply_cost(smi)
    done("kernel timing")
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s on {smi}")
    print("phase seconds " + json.dumps(
        {"groups": {k: round(v, 1) for k, v in groups.items()},
         "total": round(total, 1)}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
