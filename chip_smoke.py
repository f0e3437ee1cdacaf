#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py              # every phase; needs one card

Prints one JSON object per line:

1. ``gpu``: the card as ``nvidia-smi --query-gpu=name,power.limit`` gives
   it (also printed raw on a line of its own); every later line carries it
   as ``card`` beside its times.
2. ``build``: builds the three kernels from ``seldon_core_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and reports the seconds; then
   ``ptxas``: registers, spills and static shared memory of every kernel
   function, from the build's ``-Xptxas -v`` log.
3. ``kernel``: each kernel against its plain PyTorch version on the same
   inputs on the card, at the 7B-class shapes (K1 at decode, M = 8, at a
   speculative verify chunk, M = 8 slots x 5 = 40, at a 64-token extend
   chunk and at the prefill buckets 32 and 128, for every projection; K3
   at B 1 over L 8..1024 and in batched admission prefill, B 8 x L 128
   and B 4 x L 256), at ragged edge shapes and at
   ``llm.json``'s, with the variant the wrapper chose, the max abs error
   and its tolerance, and (7B-class and ``llm.json``) the kernel's, the
   plain version's and a PyTorch yardstick call's times over cold L2 (CUDA
   events), beside the least time the card could take.  K1 also times
   ``torch._int_mm`` on the same int8 operands (``int_mm_ms``, the int8
   product alone; M > 16 only).  K2's cases are
   ``seldon_core_tpu_torch/time_paged_attention.py`` ``CASES``: the 7B
   decode tick, long contexts (8 slots of 512..4096 tokens, one slot of
   8192), 8 slots whose tables share their first 12 pages (an aliased
   prefix), all slots inactive (the kernel's floor), g = 16, MHA at D64,
   float32 D256 and partition edges; each line names the split plan.
   Slice 6a's per-rank shapes at tp = 2 (``7b_tp2_rank_*``): K1 on a
   rank's w1 columns (4096x8192), w2 rows (8192x4096) and lm_head
   vocabulary (4096x16000) at M 8, 128 and the one logit row; K2 at S8
   H16/Hkv4; K3 at B1 L128 H16/Hkv4; each held to its plain version and
   timed as the rows above.  Slice 6b's dp = 2 rank of the int8 ResNet50
   (``resnet_dp2_rank_*``): K1 at the stage-1 1x1 conv of 32 images
   (100352x64x64) and at the head of 32 and 4 rows.
4. ``llm_json``: boots the local runner on the port's copy of
   ``examples/graphs/llm.json`` (automatic prefix caching on) in process,
   POSTs two waves of three greedy requests, the second sharing 32-token
   prefixes with the first, and holds their ids to the same engine and
   knobs on the CPU (at least 3 automatic hits); then boots
   ``llm-slab.json`` (the slab engine) and holds its ids to the paged
   graph's.
5. ``serve_7b``: the 7B-class int8 model (L32 d4096 H32/Hkv8 ff16384
   V32000, bf16, flash prefill) at full depth, weights made on the card
   layer by layer from a seeded generator, served by ``PagedLLMEngine``
   (96 pages of 16, 8 slots, max_len 256) through ``LLMComponent`` behind
   the port's REST server: 8 concurrent requests, TTFT/TPOT medians, peak
   device memory, and the kernels' launch counts during the run.
   ``grpc_7b``: the same weights and engine behind ``GrpcServer`` (the
   ``Seldon`` service over a graph engine, and the component services): 8
   concurrent ``Seldon.Predict`` and 8 concurrent ``Model.Stream``, every
   request's ids equal to ``serve_7b``'s REST ids; TTFT/TPOT medians, peak
   memory, launches; a stream cancelled after its first event gives back
   its slot and pages.
6. ``features_7b``: the same weights behind REST with 192 pages, 8
   slots, max_len 512, automatic prefixes, ``chunk_prefill`` 64 and a
   5 ms batching window: automatic and registered (page-aliased) prefix
   hits with their TTFT and peak pages, the largest token gap of 4
   streams while a 448-token prompt admits (chunked and not), a burst of 8
   prompts with the window on and off, and priority preemption (every
   request answered, ``resumed`` = ``preempted`` >= 1, every slot and page
   back).
7. ``parity_7b``: the same width at 2 layers, the kernel path on the card
   against the plain path (the same weights on the CPU): prefill and 4
   decode ticks of logits, and how many greedy ids agree (all must; an
   exact tie in the CPU logits admits each tied id).
8. ``parity_features_7b``: the same comparison for a prefix-hit extend,
   a chunked prefill's last logits, an 8-row batched prefill and 4 slab
   ticks.
9. ``spec_7b``: speculative decoding with ``serve_7b``'s weights at 32
   layers on ``PagedLLMEngine`` (k_draft 4, 8 slots, max_len 256, 161
   pages of 16) behind REST: 8 requests of 16 new tokens, half through
   ``/api/v0.1/predictions`` and half through ``/api/v0.1/stream``, half
   greedy and half sampled, with (a) the target as its own draft, (b) a
   small seeded bf16 draft (2 layers, d 1024), and the plain engine beside
   them; every answer 200, every slot and page back, each stream's ids
   equal to its request's ``/predictions`` ids, greedy ids equal to the
   plain engine's up to a near-tie of the plain path (top-2 gap <= 0.25,
   counted); acceptance rate, TTFT/TPOT medians, tokens/s, peak memory
   and launches per engine.
10. ``parity_spec_7b``: 2 layers at full width, the card against the same
   weights on the CPU: one ``paged_chunk_step`` verify chunk (logits atol
   0.25) and the speculative engine's generated ids, teacher-forced
   through the CPU plain path; greedy ids counted under ``parity_7b``'s
   exact-tie rule, and any other must lie within 0.25 of the CPU maximum
   (its deficit printed).
11. ``checkpoint_7b``: 2 layers at full width saved as bf16 by the port's
   checkpoint writer, booted through the local runner as ``DemoLLM
   (model_uri=..., int8="full")``; its ids must equal an engine's built in
   process from the same weights.
12. ``resnet50``: full ResNet50 (3, 4, 6, 3), 224x224, 1000 classes, bf16,
   seeded weights with random BatchNorm statistics, as ``ResNet50Model``
   (cuDNN convs) and ``Int8ResNet50Model`` (1x1 convs and head on K1):
   in-process forwards at batch 1, 8 and 64 (ms, images/s, K1 launches
   per forward: 37 int8, 0 float; peak device memory; the profiler's
   kernel times at batch 64 and K1's quantize/product split and share),
   parity with the same weights on the CPU at batch 4 (atol on every
   probability and rtol on the CPU path's top five, per dtype:
   ``RESNET_PARITY_TOL``; every top-1 id agreeing), and REST: the port's
   ``resnet50-int8.json`` and ``resnet50.json`` booted through the local
   runner with their batching annotations (boot seconds with the runner's
   warm-up of every bucket, whose K1 launches must be 37 per bucket for
   int8), then 16 concurrent single-image requests as the
   first traffic (p50 / p95 ms; batches, rows, pad rows, sheds and K1
   launches of those 16 alone), each answer's top-1 equal to the
   in-process forward's.  The ``kernel`` phase also
   holds K1 at every ResNet50 1x1 shape at batch 64 and at the head
   (batch 8 and 64), with ``torch._int_mm`` beside it and, at the
   largest-M shapes, the quantize/product split.
13. ``graphs``: the port's iris, mnist, epsilon-greedy-mab (router
   seeded; feedback over REST must move its routing), ensemble and
   iris-with-outlier graphs served on the card over REST, each answer
   held to the same graph on the CPU with the card's weights: status,
   names and meta (requestPath, routing, outlier scores) equal, ids equal,
   probabilities within atol 1e-5; then a persistence round trip: the MAB
   router (epsilon 0) and the outlier detector take traffic and feedback,
   ``PersistenceManager`` pushes their state to a ``FileStateStore``, and
   a fresh runner that restores it answers the same probes equally.
14. ``plan_resnet50``: ``resnet50.json`` and ``resnet50-int8.json``
    (BASELINE config 3, full width, ``wire_resnet``'s seeded weights) booted
    by ``LocalDeployment`` with ``seldon.io/graph-plan: fused`` and
    ``-warmup`` (every batcher bucket captured as a CUDA graph at boot),
    batcher on, and a walk engine over the same components: a batch of 64
    and 16 concurrent single images bitwise equal to the walk's, one
    replay per batch, K1 37 launches per int8 forward counted across
    replays (and 74 per bucket at boot: the capture's eager run and first
    replay), held against the 37 quantize and 37 product kernels that
    torch.profiler sees in one replay; capture seconds per bucket, the graph pool's bytes, host ms
    and images/s per forward fused and walk at batch 1, 8 and 64, peak
    memory, and 20 single images through each engine, reported.
15. ``plan_graphs``: iris, mnist, epsilon-greedy-mab (a router root over
    fused branches), ensemble and iris-with-outlier (a boundary above a
    fused model), fused against walk on the card: every answer
    byte-identical, one segment call per request.
16. ``cache_resnet50``: the int8 ResNet50 fused with
    ``seldon.io/prediction-cache``: a repeated image hits, launches no
    kernel and answers bitwise equal to its miss; 16 identical concurrent
    requests make one batch row.
17. ``canary``: two predictors (bf16 ResNet50 at replicas 3, int8 at 1)
    behind the runner's REST with a seeded split: 200 requests pick the
    seeded sequence exactly, each answer equal to its predictor's
    in-process answer.
18. ``wire_env``: whether ``aiohttp``, ``grpc``, ``google.protobuf`` and
    ``ml_dtypes`` import here (their versions; the gRPC phases import grpc
    and fail without it), the ``g++`` version, and
    the seconds of the native library's build from ``native/*.cc``
    (informative).
19. ``wire_resnet50``: ResNet50 at full width (bf16 and int8, the
    ``resnet50`` phase's seeds) served by the port's microservice in
    child processes (REST and FRAMED), the local runner in another
    child calling the REST one through its graph's ``endpoint`` (the
    hop keeps the request's encoding): 16 sequential single images as
    binTensor float32 and as ndarray, bitwise equal to the in-process
    graph at batch 1; 16 concurrent per encoding (p50/p95, none shed, ids
    equal, probabilities within ``RESNET_PARITY_TOL``'s atol); one
    binTensor batch of 64, bitwise equal to the in-process graph; the same singles through ``AsyncFramedClient`` to the
    FRAMED child and through the runner's ``NativeRestServer``, bitwise
    equal to the REST answers.  Then gRPC: a GRPC component child called
    by a second runner child through a ``GRPC`` endpoint, driven by
    ``SeldonGrpcClient`` on the runner's ``--grpc-port`` and
    ``--native-grpc-port`` tiers: the 16 singles (bitwise equal to the
    in-process graph), 16 concurrent (none shed, ids equal) and a batch
    (64 images; 32 on the native tier, whose C server takes at most 32 MiB
    a request), bitwise equal, p50/p95 per tier.  Children write their
    launch counts at exit: K1 37 a forward in the int8 ones, 0 in the
    float ones.
20. ``wire_llm``: ``llm.json``'s model served by a microservice child
    and called by a runner child: ``llm_json``'s waves through
    ``/api/v0.1/predictions`` and ``/api/v0.1/stream`` give
    ``llm_json``'s ids; an empty prompt answers 200 with the CPU plain
    path's ids; ``/metrics`` holds the request and stream series;
    ``/pause`` turns predictions into 503 on the runner's Python and
    native tiers and ``/unpause`` restores them; ``/seldon.json`` parses.
    The same model as a GRPC microservice child behind a ``GRPC`` endpoint:
    the waves through the runner's REST predictions and stream and its
    ``Seldon.Predict``, and each prompt's ``Generic.Stream`` on the child,
    all give ``llm_json``'s ids; in process, a ``Generic.Stream`` cancelled
    after its first event gives back its slot and pages.
21. ``wire_persistence``: the MAB router as a microservice child with
    ``--persistence 1``, called by the in-process runner (its models on
    the card): rewarded over REST, stopped with SIGTERM, booted again,
    it answers the same probes as before (error 0.0).
22. ``workers``: ``resnet50-int8.json`` behind a runner child with
    ``--workers 2``, REST, gRPC, native REST and native gRPC on shared
    ``SO_REUSEPORT`` ports: both workers hold the card (their device files;
    ``nvidia-smi --query-compute-apps=pid`` is printed beside, though a
    container's pids need not match its list), 8 images per tier bitwise
    equal to the in-process forward, and one worker killed stops the group
    (the supervisor exits 0, every worker reaped).
23. ``qos_resnet50``: the int8 ResNet50 behind a runner child with
    ``seldon.io/slo-p95-ms``, breakers and a ``seldon.io/qos-fallback``
    node (a SIMPLE_ROUTER over a GRPC primary child and a REST fallback
    child): an open-loop burst of mixed priorities at twice the rate the
    graph serves alone, every answer 200 with the in-process top-1 or 429
    with ``Retry-After``, low shed first and most, goodput per priority; a
    request whose budget has expired answers 504 and launches no kernel
    (every K1 launch of the children is an answered forward's); the
    primary stopped, its breaker opens and the fallback answers
    ``degraded``.
24. ``llm_graphs_7b``: the LLM engines' programs (ticks, prefill and
    extend per shape, the speculative round) as CUDA graphs, which every
    LLM phase above replays by default, against the same programs run
    eagerly (``programs.eager()``) at 32 layers on ``serve_7b``'s weights:
    the paged, slab and speculative engines (both of ``spec_7b``'s
    drafts) answer ``serve_7b``'s prompts, greedy and sampled, with ids
    EQUAL to the eager ids; every first replay bitwise equal to its eager
    run (the count of captures); TTFT/TPOT and tokens/s per mode; the
    decode tick's host ms, device busy ms and idle share per mode
    (``profile_decode``); ms per admission job (128-token prefill, batched
    8 x 128, 64-token extend) per mode; capture seconds per key, pool
    bytes, peak memory; the K1, K2 and K3 launches of one replayed tick,
    prefill, extend and speculative round (paged and slab) held to
    torch.profiler's kernels; the prefill program's retained bytes and the
    pool's after each of 12 (rows, bucket) keys, at the default budget and
    at one that evicts, twice; (i) the same 12 keys and a request's ticks
    at max_len 4096 beside a page pool of the card's free memory less
    twice the programs' retention budget: whether every capture succeeds,
    the graph pool's bytes per key and its peak, the least free memory.
25. ``artifacts_resnet50``: the int8 ResNet50 fused (batching off) behind
    runner children on one ``seldon.io/artifact-store``: a cold child
    (the batch-1 bucket captured by precompile at boot, 4 singles, a batch
    of 8 and one of 64 captured live and published, the kernel library
    published), then a warm child and one on a copy of the store whose
    batch-8 record has a wrong probe digest, booted together: the warm one
    captures every stored bucket at boot with its digest equal, loads the
    kernel library from the store, captures nothing on the request path,
    tags its answers ``aot-cache``; the other quarantines the bad record
    and captures that bucket live; every answer bitwise equal to the cold
    child's.  Per child: boot s, capture s at boot, request-path
    captures, first-request ms, ``/admin/artifacts?coverage=1``, K1
    launches.
26. ``device_plane_resnet50``: ``wire_resnet50``'s topology at int8 with
    ``seldon.io/device-plane`` on and off: 16 singles and a batch of 64
    through a runner child whose node is a REST component child, the
    singles through ``FramedClient`` to a FRAMED child, every answer
    bitwise equal across modes and to the in-process graph; both hops
    negotiate ``shm`` and the framed connection's pooled lane stays one
    segment; in process, a SIMPLE_ROUTER over a model on the card copies
    0 bytes from the card with the plane on (the input with it off);
    p50/p95 per mode, the planes' counters.
27. ``observe_7b`` (after ``llm_graphs_7b``, on ``serve_7b``'s weights):
    ``serve_7b``'s model behind the local runner's REST as a one-node
    graph, the planes off, then ``seldon.io/tracing`` (sample rate 1),
    ``seldon.io/health`` and ``seldon.io/profile`` on: ``serve_7b``'s 8
    prompts with a ``traceparent`` each, ids equal to ``serve_7b``'s, each
    answer's trace id the sent one and ``/trace?puid=`` its span tree;
    ``/admin/introspect``'s device memory from ``torch.cuda`` above the
    weights' bytes and within the card's; a 200 flight record per request;
    ``/admin/health``'s verdict; capture windows with a device trace
    (``torch.profiler``) over a second burst with a new prefill shape
    (graphs, a capture inside the window, its ids equal to eager ones) and
    under ``programs.eager()``: K1's, K2's and K3's ``__global__`` names in
    a trace, a host table not empty.  TTFT/TPOT and tokens/s planes off
    and on, captures in the window, trace bytes: reported.
28. ``observe_resnet50``: ``plan_resnet50``'s int8 fused configuration with
    ``seldon.io/profile`` and ``seldon.io/tracing`` behind REST:
    ``/admin/profile/compile`` lists each captured bucket (wall ms > 0),
    its ``flops`` equal to the host's count from the shapes (meta tensors)
    x rows and within 1% of ResNet50's hand count; ``/admin/profile/
    capacity`` names the card and its peak; no storm after warm-up; a
    traced single's segment span carries ``device_block_ms``.
29. ``lint``: the static-analysis plane (``seldon_core_tpu_torch/
    analysis/``) against what the card ran.  (a) ``--self --fail-on
    warn`` in process over the port and its signature registry (traced on
    fake tensors): no ERROR or WARN; each of the port's example specs
    linted as admission would, host ms each.  (b) Each of the registry's
    five traceable models built on the card by its own constructor and
    run at the trace's probe binding (batch 8): its output (shape, dtype)
    equal to the trace's; the int8 ResNet50's forward launches K1 37
    times.  (c) The GL6xx segments and boundary reasons against the plans
    ``plan_resnet50`` (int8) and ``plan_graphs`` captured; the GL18xx
    tier of ``device_plane_resnet50``'s runner hop, plane on and off,
    against ``GraphPlan.residency_map`` and the tier the hop rode
    (``seldon_device_plane_remote_refs_total`` by mode): equal, but for
    the REST hop with the plane on, where the lint's tier model says
    bytes (GL1801) and the card rides shm: asserted as found and
    reported (ROADMAP.md Queue 3).  (d) Each model's GL3xx ``hbm_bytes``
    beside the growth of ``torch.cuda.memory_allocated()`` its
    construction made (reported); ``HBM_PER_CHIP_GB`` within
    ``total_memory``; the shm hop (``put_shm`` and ``resolve``, 1 KiB to
    64 MiB) fitted to a rate and a per-hop overhead, printed beside
    ``analysis/planlint.py``'s ``TRANSFER_GBPS`` and ``HOP_OVERHEAD_MS``.
30. ``gateway_7b`` (after ``observe_7b``, on ``serve_7b``'s weights): the
    port's gateway in process in front of ``serve_7b``'s model behind the
    runner's REST: a token by form fields; the 8 prompts through
    ``/api/v0.1/predictions`` and ``/api/v0.1/stream``, ids equal to
    ``serve_7b``'s; 401 without a token; a stream abandoned at the gateway
    after its first event gives back its slot and pages at once.  Client
    TTFT/TPOT through the gateway and direct: reported.
31. ``gateway_resnet50``: the gateway as a child (``--firehose jsonl``) in
    front of a runner child serving ``resnet50-int8.json`` (wire seeds,
    batching off); tokens by HTTP Basic and by form; singles (sequential,
    concurrent; binTensor and ndarray) and a batch of 64 over REST, and
    over gRPC ``Seldon.Predict`` with ``oauth_token``, bitwise equal to the
    in-process graph; the cache tier (a hit moves no K1 count, 16 identical
    concurrent bodies one forward), a firehose record per prediction equal
    to the bytes sent and received, and a 2 s burst at twice the path's
    rate answering only 200 or 429 with ``Retry-After``, low shed first.
    p50/p95 through the gateway against direct: reported.
32. ``fleet_resnet50``: a ``LocalFleet`` of 2 fused int8 ResNet50 replicas
    on one artifact store behind the gateway's pool: 64 requests per
    policy bitwise equal to the in-process graph, consistent-hash sticky
    per body, streams pinned per ``X-Seldon-Session``; replica 1 killed
    mid-burst with every answer 200, ejected, ``unreachable`` in a
    ``partial`` ``/admin/fleet/health``; ``autoscale_tick`` to 3, the new
    replica captured from the store at boot and nothing on the request
    path.
33. ``loadtest_7b`` (after ``gateway_7b``, on ``serve_7b``'s weights): the
    port's load harness (``tools/loadtest.py``) against the runner's REST
    in process: ``RestDriver`` and ``SseStreamDriver``, 8 workers each, one
    per ``serve_7b`` prompt (16 new tokens), closed loop; every recorded id
    sequence equal to ``serve_7b``'s; requests, req/s, p50/p95, TTFT/TPOT
    medians and tokens/s reported beside ``serve_7b``'s.
34. ``operator_resnet50``: the port's operator around a real engine.  The
    controller reconciles a CR of ``resnet50-int8.json`` (annotations on
    the predictor, the wire seeds, fused, health plane, an artifact store)
    into a ``FakeKubeApi``; a kubelet stand-in boots the engine
    Deployment's container as a runner child from its env alone (no
    ``--graph``), waits on its readinessProbe and marks it available
    (Creating, then Available).  The port's ``api-test`` (answers bitwise
    equal to the in-process graph) and ``load`` over REST and gRPC (2 s
    each); one request through a gateway child gives a flight record.  A
    rolling update (``seldon.io/batch-max-delay-ms`` 2.0 to 1.0): a new
    spec hash, the old pod's preStop ``/pause`` and SIGTERM, the new pod
    booted from the new env; ``replay`` of the record against it EQUAL to
    the old answer and stamped ``aot-cache``; the delete prunes every
    owned object; one reconcile timed.
35. ``parity_tp_7b`` (after ``parity_spec_7b``): tensor parallelism at
    full width, 2 layers, int8 "ffn", on a tp = 2 mesh of two ranks on
    cuda:0 against the plain path on a tp = 2 CPU mesh with the same
    weights: 8 prompts of 66..127 tokens prefill (K3 and K1 per rank), 4
    decode ticks of 8 slots against the tp-split page pool (K2 per rank);
    logits within atol 0.25, greedy ids exact under ``parity_7b``'s tie
    rule or within ``SPEC_TIE_ATOL`` of the CPU maximum (counted).
36. ``tp_7b``: the 32-layer int8-ffn model served by ``PagedLLMEngine``
    behind REST three times (no mesh, a 1-rank mesh, tp = 2 on cuda:0):
    the 1-rank ids EQUAL the no-mesh ids; each tp = 2 divergence from
    tp = 1 at a near-tie of tp = 1's logits (counted); a 128-token prompt
    prefilled by ring attention at tp = 2 EQUAL to a dense prefill; a
    speculative tp = 2 engine returning every page.  TTFT/TPOT medians,
    tokens/s, peak memory per mode and ``tp_span``: reported.
37. ``placement_resnet50`` (after ``tp_7b``): the placement plane.  The
    int8 ResNet50 fused behind a ``PlacementPlane`` at dp = 2 over
    ``[cuda:0, cuda:0]`` (batching on, a fresh artifact store) answers
    batches of 1, 8 and 64 bitwise equal to the unsharded fused plan and
    to the walk; the probe's and every bucket's verdict, K1 launches of
    one sharded forward (2 x 37) and one unsharded (37), and p50 of
    sequential requests sharded against unsharded: reported.  The MNIST
    classifier at tp = 2 and dp = 2,tp = 2 over ranks of cuda:0: ids
    EQUAL fused and walk, ``tpBytesPerDevice`` measured from the pieces;
    ``MNISTMLP`` at tp = 2 verified or disarmed, answers equal.  The
    engine's ``/admin/placement`` 200 over REST, the placement probe's
    device bytes, a warm engine taking the stored sharded buckets at
    boot; ``iris.json`` with ``seldon.io/mesh: dp=2`` on one card: its
    plane disabled with the warning, 404, the unsharded answers.
38. ``train_moe`` (after ``placement_resnet50``): training at full width.
    The reference's default ``TransformerConfig`` (vocabulary 32000,
    d_model 512, 8 layers of 8 heads of 64, d_ff 2048) with 4 experts,
    top-2, capacity factor 2.0, ``use_flash``, bf16 activations and float32
    master params, seeded on cuda:0; 10 ``make_train_step`` AdamW steps at
    lr 1e-3 on fresh seeded batches of 8 x 512 tokens (drawn from the first
    1000 ids, a distribution the steps can learn): every loss finite,
    the last below the first, K3 launched 8 x 10 times (one forward a
    step; its backward is the dense recompute).  wq/wk/wv gradients
    non-zero and equal to a ``use_flash=False`` step's in relative L2 norm
    within 1e-3 with float32 activations.  With bf16 activations the two
    forwards round differently and the discrete routing carries that on,
    so the flash gradients are held to a witness measured here on three
    batches: two other correct bf16 attentions, the plain version and
    torch's SDPA, read against each other.  The flash gap must stay within
    twice the witness's largest (relative L2 and the largest element's
    error over the largest element, each); a control, SDPA without its
    causal mask, must land above that limit, or the gate could not tell
    a fault.  The share of top-k expert ids that differ from the plain
    forward's is reported beside each.  Step ms, tokens/s, the peak memory
    and what the steps added to what earlier phases hold.  Then a
    checkpoint saved and loaded, and 16 greedy tokens through the MoE
    ``decode_step``: ids EQUAL the in-memory params'.
39. ``train_mesh``: (a) both of the reference's training dryrun lines
    (``dryrun.py``) on 8 ranks of cuda:0 with the port's seeded weights,
    each loss within 1e-4 of the same step with no mesh; (b) mesh(dp=2,
    pp=2, tp=2) at ``train_moe``'s widths with 2 layers in float32 against
    the unsharded step on the card (``lm_loss`` with aux weight 0, as the
    pipeline carries no aux, and the step's AdamW): loss within 1e-4,
    updated params within 1e-6
    wherever the gradient is at least 1e-6 in magnitude; (c) one step of 2
    layers in float32 on the card against the same step on the CPU with the
    plain versions: loss within 1e-4, each gradient within 1e-3 of the
    leaf's largest.  K3's launches counted exactly.
40. ``multihost_dryrun`` (after ``train_mesh``): ``runtime/multihost.py``
    ``run_multihost_dryrun(n_hosts=2, devices_per_host=2, device="cuda")``:
    two OS processes join one gloo group through the env the port's
    operator compiles, each holding two tp ranks on cuda:0 (tp = 4 across
    the processes), and serve the reference's float32 configs through
    ``LLMEngine`` and the speculative ring-prefill prefix-aliasing
    ``PagedLLMEngine``; every assertion of the CPU run holds (ids equal in
    both processes and to the plain one-device decode, spec rounds, pinned
    pages returned, one sampled request equal in both), and the phase
    prints the reference's two multi-host lines (``dryrun_multichip OK:
    multihost ...``).  Its workers' launches are counted in them.
41. ``multihost_7b``: the 32-layer 7B-width int8-ffn model (``tp_7b``'s
    weights, seed 6, flash prefill) served by two processes with the
    operator's env (``NUM_TPU_HOSTS=2``, ``TPU_WORKER_ID`` 0 and 1, the
    coordinator on a free loopback port), one tp rank each on cuda:0
    (``chip_smoke.py --multihost-child``), by ``PagedLLMEngine``
    (``serve_7b``'s 96 pages of 16, 8 slots, max_len 256) on 4 of
    ``serve_7b``'s prompts (21, 54, 87 and 120 tokens) at 16 new tokens,
    one after another.  First the parent serves the same requests through
    the single-controller tp = 2 on [cuda:0, cuda:0] (programs eager, as
    the children's must be) and frees its memory.  Gates: every request's
    ids EQUAL the single-controller's and EQUAL between the processes, and
    K1, K2 and K3 launched in the children (their counts, written by each
    child, are the phase's).  Reported: each prompt's prefill logits in
    both processes against the single controller's (bitwise, the largest
    difference), TTFT/TPOT medians beside the single controller's and
    ``tp_7b``'s, and each decode tick's share in the collectives (CUDA
    events around each exchange over the tick's host time).  Each child
    must end within ``MULTIHOST_DEADLINE_S``; a failing or hung child
    fails the phase, both are stopped.
42. ``multihost_train_dryrun`` (after ``multihost_7b``): ``runtime/
    multihost.py`` ``run_multihost_training(..., device="cuda")`` at 2
    processes x 4 ranks and at 4 x 2 (both layouts at once, their six
    processes sharing cuda:0), all on cuda:0: the reference's two
    training plans (the dryrun's seeded weights and batch) over
    ``process_mesh(..., plan=)``, so dp crosses the boundary at 2 x 4 and
    pp (the dense plan) or tp (the ring plan) at 4 x 2.  Gates: every
    process prints the line ``train_mesh`` (a)'s single controller
    printed, its loss within 1e-6 of the single controller's, and every
    leaf several processes keep bitwise the same in each of them after the
    step; K3 launched 32 times a layout in the workers (the dense plan's
    4 layers x 2 microbatches x dp 2 x tp 2).  Reported: each process's
    step seconds (each layout's with the other's beside it on the card).
43. ``multihost_train_moe``: ``train_moe``'s model and batches (seeds 61,
    62; full width, 8 x 512, 10 AdamW steps at lr 1e-3) at dp = 2 over two
    processes with the operator's env, one rank each on cuda:0
    (``chip_smoke.py --multihost-train-child``): the experts' moves and the
    gradient sums cross the boundary.  Held against the single
    controller's dp = 2 on [cuda:0, cuda:0] with the same seeds, run twice
    first.  Gates: each step's loss within 1e-3 relative of the single
    controller's, or within twice the single controller's own gap between
    its two runs where that is larger; every replicated leaf bitwise equal
    between the processes after step 10; losses finite and falling; K3
    launched 8 x 10 times in each child (one a layer a rank a forward).
    Reported: step ms medians in the processes and for the single
    controller, the moves' CUDA-event ms over a step's host ms
    (``transport_stats``), a step's moves, peak memory.
44. ``native_load_ceiling``: ``bench.py`` ``bench_wire_ceiling``'s two runs
    on the port: ``NativeHttpServer`` answering a static body (no Python
    on either side of a request), driven by ``native.run_native_load``:
    REST with 32 connections, h2c gRPC with 8 x 16 streams, 1.5 s each;
    errors must be 0.  Requests/s and latency percentiles are printed with
    the card and ``os.cpu_count()``: the load generator and the server
    share the host's cores, so these are host figures.
45. ``native_load_engine``: ``bench_rest_socket_native``'s and
    ``bench_grpc_socket_native``'s setups: a SIMPLE_MODEL ``GraphEngine``
    behind ``NativeRestServer`` (32 connections) and ``NativeGrpcServer``
    (8 x 8 streams), the load generator in an executor while the servers'
    loop runs in the script, 3 s each; errors must be 0.
46. ``native_load_llm``: ``llm.json`` (DemoLLM, int8 "full", 65 pages of
    16, GQA 4/2) booted by the local runner, its routes behind the native
    REST tier, 3 s of ``run_native_load`` with 4 connections and one
    greedy body (a 40-token prompt, ``n_new`` 8), Python POSTs of the
    body: one before, three spread over the window (the load keeping the
    engine's 4 slots live) and one after: errors 0, every answer's ids
    EQUAL the CPU plain path's (the same engine and knobs), each in-window
    POST sent inside the window, K1 and K2 launched in the window (their
    counts are the phase's launches).
47. ``save_model``: ``MNISTMLP`` and ``ResNet50Model`` (BASELINE config 3:
    224 x 224 x 3, 1000 classes, bf16; seed 11) exported by
    ``python -m seldon_core_tpu_torch.tools save-model`` in two child
    processes on the card at once; each export booted through
    ``model_uri`` in a fresh component on cuda: its leaves bitwise equal
    to the same seeded instance built in the script, and on 8 seeded
    inputs (one batch) the booted component's answers bitwise equal to
    that instance's.  Export and boot seconds, file bytes: reported.
48. ``seconds``: wall time of every phase (``slice_3a_phases``: the three
    phases of prefix caching, batched and chunked prefill, preemption and
    checkpoints together; ``slice_3b_phases``: ``spec_7b`` and
    ``parity_spec_7b``; ``slice_4a_i_phases``: the ``wire_*`` phases;
    ``slice_4a_ii_qos_phases``: ``grpc_7b``, ``workers``,
    ``qos_resnet50``; ``slice_4b_4c_i_phases``: the four of 14-17;
    ``slice_4c_ii_phases``: ``llm_graphs_7b``; ``slice_4d_4e_phases``:
    25-26; ``slice_5_i_phases``: 27-28; ``slice_5_ii_phases``: 29;
    ``slice_5b_i_phases``: 30-32; ``slice_5b_ii_phases``: 33-34;
    ``slice_6a_phases``: 35-36; ``slice_6b_phases``: 37;
    ``slice_6c_phases``: 38-39; ``slice_6d_phases``: 40-41;
    ``slice_6e_phases``: 42-43; ``slice_7_phases``: 44-47).
49. ``{"kernels": [...]}``: one entry per kernel with its launches in the
    runs through entry points (``llm_json``, ``serve_7b``, ``grpc_7b``,
    ``features_7b``, ``spec_7b``, ``llm_graphs_7b``, ``checkpoint_7b``,
    ``plan_resnet50``,
    ``cache_resnet50``, ``canary``, ``wire_resnet50``,
    ``wire_llm``, ``workers``, ``qos_resnet50``, ``artifacts_resnet50``,
    ``device_plane_resnet50``, ``observe_7b``, ``observe_resnet50``,
    ``lint``, ``gateway_7b``, ``loadtest_7b``, ``parity_tp_7b``,
    ``tp_7b``, ``placement_resnet50``, ``train_moe``, ``train_mesh``,
    ``multihost_dryrun``, ``multihost_7b``, ``multihost_train_dryrun``,
    ``multihost_train_moe``, ``native_load_llm``, ``gateway_resnet50``,
    ``fleet_resnet50`` and ``operator_resnet50``, counted by the child
    processes where the kernels run there; K1 also
    ``resnet50_launches``: the int8 REST run), each phase's count beside,
    its error, times and bound (K2 also at its two long cases and the
    shared-prefix case; each kernel also its ``tp2_rank_cases``, K1 its
    ``dp2_rank_cases``: one dp = 2 rank's row blocks of the int8 ResNet50;
    K3 its ``train_cases``: the autograd Function at the training shape,
    B 8 x L 512 H 8 D 64 bf16, and at the dryrun's, B 4 x L 16 H 4 D 16
    float32, its forward held to the plain version, its q/k/v gradients
    bitwise equal to autograd through the plain version, the forward's
    and the backward's ms beside the forward's bound and SDPA's forward
    and backward).
50. Last: ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Any failed check raises: the script exits non-zero without the ``ok``
line.  Without a card, or run outside a checkout of the repository, it
exits non-zero before printing any result.  Every child process is
stopped (SIGTERM, then SIGKILL after 30 s) and reaped before the script
exits, whatever happened.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
CARD = ""


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time in ms the card could take: bytes over memory rate vs
    operations over the peak rate of their type, whichever is larger."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ----------------------------------------------------------------------
# kernels against their plain versions
# ----------------------------------------------------------------------

def flash_train_case(torch, timer, gen, name, B, L, H, Hkv, D, dt) -> dict:
    """K3 through ``flash_attention``'s autograd Function against autograd
    through its plain version on the same inputs and output gradient: the
    forward within K3's tolerance (bf16 2e-2, float32 1e-5), the q/k/v
    gradients BITWISE equal (the backward is the plain version's recompute).
    Times over cold L2: the Function's forward (K3), its backward (the
    dense recompute), the plain forward and forward + backward, and SDPA's
    forward and forward + backward on GQA-expanded K/V; the forward's bound
    and the backward's (recomputing the scores and the four products of
    attention's gradient over the causal pairs, 10 D operations a pair;
    q, k, v, dO read, dq, dk, dv written)."""
    from seldon_core_tpu_torch.ops import attention

    def rnd(h):
        return torch.randn((B, L, h, D), generator=gen, device="cuda").to(dt)

    q0, k0, v0, g = rnd(H), rnd(Hkv), rnd(Hkv), rnd(H)

    def leaves():
        return [t.clone().requires_grad_() for t in (q0, k0, v0)]

    qa, ka, va = leaves()
    out = attention.flash_attention(qa, ka, va, causal=True)
    out.backward(g)
    qb, kb, vb = leaves()
    ref = attention.flash_attention_ref(qb, kb, vb, causal=True)
    ref.backward(g)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    bitwise = [bool(torch.equal(a.grad, b.grad))
               for a, b in ((qa, qb), (ka, kb), (va, vb))]
    line = {"phase": "kernel", "kernel": "flash_attention",
            "case": f"train_{name}", "variant": attention.flash_variant(dt, D),
            "shape": [B, L, H, Hkv, D], "dtype": str(dt).split(".")[-1],
            "max_abs_err": err, "tolerance": f"atol {tol}",
            "grads_bitwise_equal_plain": bitwise, "card": CARD}
    if not (err <= tol and all(bitwise)):
        emit(line)
        raise AssertionError(f"flash_attention train {name}: {line}")
    isz = q0.element_size()
    pairs = L * (L + 1) / 2
    kind = "bf16" if dt == torch.bfloat16 else "f32"
    b_ms, b_by = bound((2 * q0.numel() + 2 * k0.numel()) * isz,
                       4.0 * B * H * D * pairs, kind)
    bb_ms, bb_by = bound((3 * q0.numel() + 4 * k0.numel()) * isz,
                         10.0 * B * H * D * pairs, kind)
    n_rep = H // Hkv
    qt = q0.transpose(1, 2).detach().requires_grad_()
    kt = k0.repeat_interleave(n_rep, 2).transpose(1, 2).detach() \
        .requires_grad_()
    vt = v0.repeat_interleave(n_rep, 2).transpose(1, 2).detach() \
        .requires_grad_()
    gt = g.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    held = attention.flash_attention(qa, ka, va, causal=True)
    line.update(
        ms=timer(lambda: attention.flash_attention(qa, ka, va, causal=True)),
        bwd_ms=timer(lambda: held.backward(g, retain_graph=True)),
        plain_ms=timer(lambda: attention.flash_attention_ref(
            qb, kb, vb, causal=True), reps=5),
        plain_fwd_bwd_ms=timer(lambda: attention.flash_attention_ref(
            qb, kb, vb, causal=True).backward(g), reps=5),
        library_ms=timer(lambda: sdpa(qt, kt, vt, is_causal=True)),
        library_fwd_bwd_ms=timer(lambda: sdpa(qt, kt, vt, is_causal=True)
                                 .backward(gt)),
        bound_ms=b_ms, bound_by=b_by, bwd_bound_ms=bb_ms, bwd_bound_by=bb_by)
    emit(line)
    return {k: line[k] for k in (
        "shape", "dtype", "variant", "max_abs_err", "ms", "bwd_ms",
        "plain_ms", "plain_fwd_bwd_ms", "library_ms", "library_fwd_bwd_ms",
        "bound_ms", "bound_by", "bwd_bound_ms", "bwd_bound_by")}


def kernel_phase(torch, timer) -> dict:
    """Returns the summary entry per kernel (times at the main-path shape,
    errors over every shape checked)."""
    from seldon_core_tpu_torch.ops import attention, quant
    from seldon_core_tpu_torch.runtime import paged

    summary = {}
    gen = torch.Generator(device="cuda").manual_seed(1234)

    # K1 ------------------------------------------------------------------
    # 7B decode (M = 8 slots), the prefill buckets 32 and 128, a
    # speculative verify chunk (8 slots x (k_draft 4 + 1) = 40 rows) and a
    # 64-token extend chunk (chunk_prefill 64) over every projection shape
    # of a layer plus the lm_head, and llm.json's shapes (d64, f32)
    proj_7b = [("wq_wo", 4096, 4096), ("wk_wv", 4096, 1024),
               ("w1", 4096, 16384), ("w2", 16384, 4096),
               ("lm_head", 4096, 32000)]
    k1_cases = [(f"7b_{stage}_{pn}", M, K, N, torch.bfloat16,
                 (stage, pn) == ("decode", "w1"))
                for stage, M in (("decode", 8), ("prefill32", 32),
                                 ("verify40", 40), ("extend64", 64),
                                 ("prefill128", 128))
                for pn, K, N in proj_7b]
    # slice 6a: each rank's shard at tp = 2 (w1 by column, w2 by row with
    # its input quantized over the local 8192, the lm_head's vocabulary),
    # at decode (8 slots), at the 128-token prefill bucket and at the
    # prefill's one logit row
    proj_tp2 = [("w1", 4096, 8192), ("w2", 8192, 4096),
                ("lm_head", 4096, 16000)]
    k1_cases += [(f"7b_tp2_rank_{stage}_{pn}", M, K, N, torch.bfloat16,
                  False)
                 for stage, M in (("decode", 8), ("prefill128", 128),
                                  ("logit_row", 1))
                 for pn, K, N in proj_tp2
                 if stage != "logit_row" or pn == "lm_head"]
    tp2 = {}  # the per-rank cases' lines, by kernel
    k1_cases += [
        # ragged edges: M not a multiple of 8 or 64, N not of 16 or 64, K
        # not of 64 or 128 (a partial chunk / k-tile), 9-16 rows (two
        # 8-token tiles of the decode schedule), one row
        ("edge_m1", 1, 4096, 4096, torch.bfloat16, False),
        ("edge_m13_n1000_k4112", 13, 4112, 1000, torch.bfloat16, False),
        ("edge_m16_k4112", 16, 4112, 4096, torch.float32, False),
        ("edge_m17_n1000_k4112", 17, 4112, 1000, torch.bfloat16, False),
        ("edge_m200_n48_k80", 200, 80, 48, torch.float32, False),
        # split-K with an empty split and a partial k-tile (9 k-tiles over
        # 4 splits) at 128- and 64-row tiles (M 128 and 64, the largest of
        # each), 32-row tiles on a ragged M, an odd N (single stores)
        ("edge_m128_n4096_k1040", 128, 1040, 4096, torch.bfloat16, False),
        ("edge_m64_n4096_k1040", 64, 1040, 4096, torch.float32, False),
        ("edge_m100_n1000_k4112", 100, 4112, 1000, torch.float32, False),
        ("edge_m65_n999_k2064", 65, 2064, 999, torch.bfloat16, False),
        ("llm_json_wq", 4, 64, 64, torch.float32, False),
        ("llm_json_wk", 4, 64, 32, torch.float32, False),
        ("llm_json_w1", 4, 64, 128, torch.float32, False),
        ("llm_json_w2", 4, 128, 64, torch.float32, False),
        ("llm_json_lm_head", 4, 64, 256, torch.float32, False),
        ("llm_json_prefill_w1", 64, 64, 128, torch.float32, False),
    ]
    errs = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, M, K, N, dt, main in k1_cases:
        x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        w = quant.quantize_int8(
            torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5)
        out = quant.int8_matmul_cuda(x, w.values, w.scales, dt)
        ref = quant.int8_matmul_ref(x, w.values, w.scales, dt)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        bitwise = torch.equal(out, ref)
        errs.append(err)
        variant = quant.int8_variant(M)
        if variant == "mma_gemm":
            plan = quant.gemm_plan(M, K, N, sms)
            variant += f" {plan.bm}x128 tiles, K split {plan.splits}"
        line = {"phase": "kernel", "kernel": "int8_matmul", "case": name,
                "variant": variant,
                "shape": [M, K, N], "dtype": str(dt).split(".")[-1],
                "max_abs_err": err, "tolerance": "bitwise equal",
                "bitwise_equal": bitwise, "card": CARD}
        if not bitwise:
            emit(line)
            raise AssertionError(f"int8_matmul {name}: not bitwise equal "
                                 f"to its plain version (max err {err})")
        if name.startswith("7b") or name.startswith("llm"):
            itemsize = x.element_size()
            nbytes = M * K * itemsize + K * N + N * 4 + M * N * itemsize
            b_ms, b_by = bound(nbytes, 2.0 * M * N * K, "int8")
            wd = (w.values.to(dt) * w.scales.to(dt))  # dequantized, once
            # second yardstick: the int8 product alone (cuBLASLt; M > 16)
            xq = quant.quantize_rows(x)[0].to(torch.int8)
            line.update(
                ms=timer(lambda: quant.int8_matmul_cuda(x, w.values,
                                                        w.scales, dt)),
                plain_ms=timer(lambda: quant.int8_matmul_ref(
                    x, w.values, w.scales, dt), reps=5),
                library_ms=timer(lambda: torch.matmul(x, wd)),
                int_mm_ms=(timer(lambda: torch._int_mm(xq, w.values))
                           if M > 16 else None),
                bound_ms=b_ms, bound_by=b_by)
            del wd, xq
            if name.startswith("7b_tp2"):
                tp2.setdefault("int8_matmul", {})[name] = line
            if main:
                summary["int8_matmul"] = {
                    k: line[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", "variant")}
                summary["int8_matmul"]["shape"] = f"{name} {M}x{K}x{N}"
        emit(line)
        del x, w
    rn_errs, dp2 = resnet_k1_cases(torch, timer, gen, sms)
    errs += rn_errs
    summary["int8_matmul"]["max_abs_err"] = max(errs)

    # K2 ------------------------------------------------------------------
    # the cases of seldon_core_tpu_torch/time_paged_attention.py.  Tolerance
    # atol 1e-3, rtol 1e-3 on active rows (float32 output): the kernel and
    # the plain version sum the same float32 terms in another order (per
    # page partition, then a rescaled merge); an inactive slot's row is
    # unread and only has to be finite.
    from seldon_core_tpu_torch import time_paged_attention as k2cases

    def paged_case(case):
        q, kp, vp, lens, tables = k2cases.make_inputs(case, gen)
        plan = paged.kernel_split_plan(
            case.S, case.H, case.Hkv, case.D, case.page_size,
            tables.shape[1], q.element_size(), sms)
        arrivals = paged.arrival_counters(case.S, case.H, case.Hkv,
                                          q.device)
        out = paged.paged_attention_cuda(q, kp, vp, lens, tables,
                                         arrivals=arrivals)
        ref = paged.paged_attention_ref(q, kp, vp, lens, tables)
        torch.cuda.synchronize()
        active = lens > 0
        if not torch.isfinite(out).all():
            raise AssertionError(f"paged_attention {case.name}: non-finite "
                                 "output")
        err = ((out[active] - ref[active]).abs().max().item()
               if active.any() else 0.0)
        ok = torch.allclose(out[active], ref[active], atol=1e-3, rtol=1e-3)
        line = {"phase": "kernel", "kernel": "paged_attention",
                "case": case.name,
                "variant": f"split {plan.n_split} x {plan.pages} pages",
                "n_split": plan.n_split, "pages_per_split": plan.pages,
                "shape": {"S": case.S, "H": case.H, "Hkv": case.Hkv,
                          "D": case.D, "pages": case.n_pages,
                          "page_size": case.page_size,
                          "lengths": list(case.lengths),
                          "pages_per_slot": tables.shape[1]},
                "dtype": case.dtype, "max_abs_err": err,
                "tolerance": "atol 1e-3, rtol 1e-3", "card": CARD}
        if not ok:
            emit(line)
            raise AssertionError(f"paged_attention {case.name}: error {err}")
        if case.timed:
            nbytes, ops = k2cases.work(case)
            b_ms, b_by = bound(nbytes, ops, "bf16" if case.dtype == "bfloat16"
                               else "f32")
            line.update(ms=timer(lambda: paged.paged_attention_cuda(
                q, kp, vp, lens, tables, arrivals=arrivals)), bound_ms=b_ms,
                bound_by=b_by)
            if active.any():  # the all-inactive case times the kernel only
                line.update(
                    plain_ms=timer(lambda: paged.paged_attention_ref(
                        q, kp, vp, lens, tables), reps=5),
                    library_ms=timer(k2cases.yardstick(q, kp, vp, lens,
                                                       tables)))
        emit(line)
        del q, kp, vp, out, ref, arrivals
        return line

    # slice 6a: one tp = 2 rank's share of the 7B decode tick (its 16 query
    # heads over its 4 KV heads, the pool's pages of those heads)
    tp2_k2 = k2cases.Case("7b_tp2_rank_decode", 8, 16, 4, 128, 96, 16,
                          k2cases.SERVE_LENGTHS, "bfloat16", timed=True)
    lines = {c.name: paged_case(c) for c in (*k2cases.CASES, tp2_k2)}
    tp2["paged_attention"] = {tp2_k2.name: lines[tp2_k2.name]}
    edges = lines["partition_edges"]
    part = edges["pages_per_split"] * edges["shape"]["page_size"]
    if not {part, part + 1} <= set(edges["shape"]["lengths"]):
        raise AssertionError(f"partition_edges: its lengths miss the "
                             f"{part}-token partition boundary")
    at_main = lines["7b_decode"]
    live = sum(at_main["shape"]["lengths"])
    summary["paged_attention"] = {
        k: at_main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "variant")}
    summary["paged_attention"].update(
        shape=f"7b_decode S8 H32/8 D128 tokens {live}",
        max_abs_err=max(ln["max_abs_err"] for ln in lines.values()),
        long_ms=lines["7b_decode_long"]["ms"],
        long_bound_ms=lines["7b_decode_long"]["bound_ms"],
        one_long_ms=lines["7b_decode_one_long"]["ms"],
        one_long_bound_ms=lines["7b_decode_one_long"]["bound_ms"],
        shared_prefix_ms=lines["7b_decode_shared_prefix"]["ms"],
        shared_prefix_bound_ms=lines["7b_decode_shared_prefix"]["bound_ms"])

    # K3 ------------------------------------------------------------------
    # tolerance: bf16 output atol 2e-2 at unit-variance inputs, one bf16
    # ulp (the two sum in another order and each rounds once to bf16);
    # float32 output atol 1e-5 (summation order only)
    def flash_case(name, B, L, H, Hkv, D, dt, main, causal=True):
        q = torch.randn((B, L, H, D), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, L, Hkv, D), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, L, Hkv, D), generator=gen, device="cuda").to(dt)
        out = attention.flash_attention_cuda(q, k, v, causal=causal)
        ref = attention.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2e-2 if dt == torch.bfloat16 else 1e-5
        line = {"phase": "kernel", "kernel": "flash_attention", "case": name,
                "variant": attention.flash_variant(dt, D), "causal": causal,
                "shape": [B, L, H, Hkv, D], "dtype": str(dt).split(".")[-1],
                "max_abs_err": err, "tolerance": f"atol {tol}", "card": CARD}
        if not err <= tol:
            emit(line)
            raise AssertionError(f"flash_attention {name}: error {err}")
        if name.startswith("7b") or name.startswith("llm"):
            isz = q.element_size()
            nbytes = (2 * q.numel() + 2 * k.numel()) * isz
            pairs = L * (L + 1) / 2 if causal else L * L
            ops = 4.0 * B * H * D * pairs
            b_ms, b_by = bound(nbytes, ops,
                               "bf16" if dt == torch.bfloat16 else "f32")
            g = H // Hkv
            qt = q.transpose(1, 2)
            kt = k.repeat_interleave(g, 2).transpose(1, 2)
            vt = v.repeat_interleave(g, 2).transpose(1, 2)
            line.update(
                ms=timer(lambda: attention.flash_attention_cuda(
                    q, k, v, causal=causal)),
                plain_ms=timer(lambda: attention.flash_attention_ref(
                    q, k, v, causal=causal), reps=5),
                library_ms=timer(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal)),
                bound_ms=b_ms, bound_by=b_by)
            if name.startswith("7b_tp2"):
                tp2.setdefault("flash_attention", {})[name] = line
            if main:
                summary["flash_attention"] = {
                    k_: line[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by",
                                            "variant")}
                summary["flash_attention"]["shape"] = (
                    f"{name} B{B} L{L} H{H}/{Hkv} D{D}")
        emit(line)
        return err

    ferrs = [
        flash_case("7b_prefill128", 1, 128, 32, 8, 128, torch.bfloat16, True),
        flash_case("7b_prefill8", 1, 8, 32, 8, 128, torch.bfloat16, False),
        flash_case("7b_prefill256", 1, 256, 32, 8, 128, torch.bfloat16,
                   False),
        flash_case("7b_ragged_100", 2, 100, 32, 8, 128, torch.bfloat16,
                   False),
        flash_case("7b_prefill1024", 1, 1024, 32, 8, 128, torch.bfloat16,
                   False),
        # batched admission prefill: 8 and 4 rows in one launch
        flash_case("7b_batch8_l128", 8, 128, 32, 8, 128, torch.bfloat16,
                   False),
        flash_case("7b_batch4_l256", 4, 256, 32, 8, 128, torch.bfloat16,
                   False),
        flash_case("7b_ragged_777_b2", 2, 777, 32, 8, 128, torch.bfloat16,
                   False),
        flash_case("7b_full_ragged_300", 1, 300, 32, 8, 128, torch.bfloat16,
                   False, causal=False),
        flash_case("d64_ragged_200", 2, 200, 8, 2, 64, torch.bfloat16,
                   False),
        flash_case("d32_mha_ragged_50", 1, 50, 4, 4, 32, torch.bfloat16,
                   False),
        flash_case("7b_prefill128_f32", 1, 128, 32, 8, 128, torch.float32,
                   False),
        flash_case("llm_json_prefill16", 1, 16, 4, 2, 16, torch.float32,
                   False),
        flash_case("llm_json_prefill64", 1, 64, 4, 4, 16, torch.float32,
                   False),
        # slice 6a: one tp = 2 rank's heads of the 128-token prefill
        flash_case("7b_tp2_rank_prefill128", 1, 128, 16, 4, 128,
                   torch.bfloat16, False),
    ]
    summary["flash_attention"]["max_abs_err"] = max(ferrs)
    # slice 6c: K3 under autograd (``ops/attention.py`` FlashAttention),
    # at the training shape and at the dryrun's
    summary["flash_attention"]["train_cases"] = {
        name: flash_train_case(torch, timer, gen, name, *shape)
        for name, shape in (
            ("train_b8_l512", (8, 512, 8, 8, 64, torch.bfloat16)),
            ("dryrun_b4_l16", (4, 16, 4, 4, 16, torch.float32)))}
    keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "variant")
    for kernel, cases in tp2.items():
        summary[kernel]["tp2_rank_cases"] = {
            name: {k: ln[k] for k in keys if k in ln}
            for name, ln in cases.items()}
    summary["int8_matmul"]["dp2_rank_cases"] = {
        name: {k: ln[k] for k in keys + ("quantize_ms", "product_ms")
               if k in ln} for name, ln in dp2.items()}
    return summary


# ResNet50's 1x1 convs as K1 products, per image: (rows, K, N); the batch
# multiplies the rows.  The head is (B, 2048, 1000) on float32 rows.
RESNET_1X1 = [(3136, 64, 64), (3136, 64, 256), (3136, 256, 64),
              (3136, 256, 128), (784, 128, 512), (784, 256, 512),
              (784, 512, 128), (784, 512, 256), (196, 256, 1024),
              (196, 512, 1024), (196, 1024, 256), (196, 1024, 512),
              (49, 512, 2048), (49, 1024, 2048), (49, 2048, 512)]


def _device_ms_by_kernel(torch, fn, reps: int) -> dict:
    """Device ms per call of each kernel name ``fn`` launches, from
    torch.profiler over ``reps`` calls (empty if it sees no device
    event)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    return by_name


#: idle time inside a profiled window before ``fn()`` and after its work
PROFILE_PAD_S = 0.05
#: per profiled window: µs from the window's start to the first device
#: record of the work (the pad, the sentinels and the launch; less would
#: mean the card's clock stands behind the host's)
PROFILE_FIRST_US: list = []
#: per profiled window: its device records' first start and last end (µs
#: from the window's start), their span and count, the CUDA events' ms
#: around ``fn()`` on the card, each kernel name's record starts, and how
#: many of its sentinels the profiler saw.  A record lost at an edge of the
#: window shortens the records' span against the events'; one lost inside
#: leaves a gap between two starts.
PROFILE_WINDOWS: list = []
#: spin kernels (``torch.cuda._sleep``, about 0.1 ms each on an H100)
#: queued after the pad and before ``fn()``: a window that loses its first
#: device records loses these, not ``fn()``'s (PR 17's proof run lost the
#: first 23 records of an int8 ResNet50 replay 55 ms into its window, 5 ms
#: past the pad, and ``plan_resnet50`` saw 36 of 37 K1 passes)
PROFILE_SENTINELS = 128
PROFILE_SENTINEL_CYCLES = 200_000


def _kernels_run(torch, fn) -> dict:
    """How many times each kernel name ran on the card in one ``fn()``,
    from torch.profiler (empty if it sees no device event).  The profiler
    keeps only device records whose card timestamps fall within the
    window's host-clock bounds, so the window opens and closes
    ``PROFILE_PAD_S`` away from the work: with ``fn()`` launched at once
    after the start, a replay of the int8 ResNet50 bucket on an H100 once
    showed 36 of its 37 quantize passes, and once more with the pads, its
    first records lost: ``PROFILE_SENTINELS`` spin kernels now run ahead of
    ``fn()`` inside the window and are left out of the counts, and
    ``PROFILE_WINDOWS`` keeps where each window's records fell."""
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(PROFILE_SENTINELS):
            torch.cuda._sleep(PROFILE_SENTINEL_CYCLES)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    seen: dict = {}
    starts: dict = {}
    sentinels = 0
    first, last = math.inf, -math.inf
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "spin_kernel" in e.name:
            sentinels += 1
            continue
        seen[e.name] = seen.get(e.name, 0) + 1
        starts.setdefault(e.name, []).append(e.time_range.start)
        first = min(first, e.time_range.start)
        last = max(last, e.time_range.end)
    PROFILE_FIRST_US.append(first)
    PROFILE_WINDOWS.append({
        "first_us": first, "last_us": last, "span_us": last - first,
        "events_ms": ev0.elapsed_time(ev1), "records": sum(seen.values()),
        "sentinels_seen": sentinels,
        "starts_us": {k: sorted(v) for k, v in starts.items()}})
    return seen


def _window_report(window: dict, name_part: str) -> dict:
    """A profiled window's bounds against the events', and the records
    of the kernels whose names hold ``name_part``: their count, first and
    last start, and the widest gap between two starts."""
    st = sorted(t for k, v in window["starts_us"].items()
                if name_part in k for t in v)
    gaps = [b - a for a, b in zip(st, st[1:])]
    return {**{k: window[k] for k in ("first_us", "last_us", "span_us",
                                      "events_ms", "records",
                                      "sentinels_seen")},
            name_part: {"records": len(st),
                        "first_start_us": st[0] if st else None,
                        "last_start_us": st[-1] if st else None,
                        "widest_gap_us": max(gaps, default=None),
                        "median_gap_us": (statistics.median(gaps)
                                          if gaps else None)}}


def _k1_split(by_name: dict) -> dict:
    """K1's quantize pass and product (ms per call) in a by-kernel map."""
    quant = sum(ms for n, ms in by_name.items() if "quant_rows" in n)
    prod = sum(ms for n, ms in by_name.items()
               if "int8_gemm" in n or "int8_gemv" in n)
    return {"quantize_ms": quant, "product_ms": prod}


def resnet_k1_cases(torch, timer, gen, sms) -> tuple:
    """K1 at every ResNet50 1x1 shape at batch 64 (bf16 rows) and at the
    head at batch 8 and 64 (float32 rows): bitwise against the plain
    version, timed beside its bound, ``torch._int_mm`` on the same int8
    operands and the dequantized bf16 ``torch.matmul``.  At the largest-M
    shapes the profiler splits the time into the quantize pass and the
    product.  Also one dp = 2 rank's row block (``placement_resnet50``):
    the stage-1 1x1 conv at 32 images and the head at 32 and 4 rows.
    Returns the errors and the dp = 2 rank cases' lines."""
    from seldon_core_tpu_torch.ops import quant

    cases = [(f"resnet_b64_{r}x{k}x{n}", 64 * r, k, n, torch.bfloat16)
             for r, k, n in RESNET_1X1]
    cases += [("resnet_head_b8", 8, 2048, 1000, torch.float32),
              ("resnet_head_b64", 64, 2048, 1000, torch.float32)]
    # slice 6b: a dp = 2 rank's half of the batches of 64 and of 8
    cases += [("resnet_dp2_rank_b32_3136x64x64", 32 * 3136, 64, 64,
               torch.bfloat16),
              ("resnet_dp2_rank_head_b32", 32, 2048, 1000, torch.float32),
              ("resnet_dp2_rank_head_b4", 4, 2048, 1000, torch.float32)]
    errs, dp2 = [], {}
    for name, M, K, N, dt in cases:
        x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        w = quant.quantize_int8(
            torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5)
        out = quant.int8_matmul_cuda(x, w.values, w.scales, dt)
        ref = quant.int8_matmul_ref(x, w.values, w.scales, dt)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        bitwise = torch.equal(out, ref)
        errs.append(err)
        variant = quant.int8_variant(M)
        if variant == "mma_gemm":
            plan = quant.gemm_plan(M, K, N, sms)
            variant += f" {plan.bm}x128 tiles, K split {plan.splits}"
        line = {"phase": "kernel", "kernel": "int8_matmul", "case": name,
                "variant": variant, "shape": [M, K, N],
                "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                "tolerance": "bitwise equal", "bitwise_equal": bitwise,
                "card": CARD}
        if not bitwise:
            emit(line)
            raise AssertionError(f"int8_matmul {name}: not bitwise equal "
                                 f"to its plain version (max err {err})")
        del out, ref
        isz = x.element_size()
        b_ms, b_by = bound(M * K * isz + K * N + N * 4 + M * N * isz,
                           2.0 * M * N * K, "int8")
        wd = w.values.to(dt) * w.scales.to(dt)  # dequantized, once
        xq = quant.quantize_rows(x)[0].to(torch.int8)
        line.update(
            ms=timer(lambda: quant.int8_matmul_cuda(x, w.values, w.scales,
                                                    dt)),
            plain_ms=timer(lambda: quant.int8_matmul_ref(
                x, w.values, w.scales, dt), reps=5),
            library_ms=timer(lambda: torch.matmul(x, wd)),
            int_mm_ms=(timer(lambda: torch._int_mm(xq, w.values))
                       if M > 16 else None),
            bound_ms=b_ms, bound_by=b_by)
        if M in (64 * 3136, 32 * 3136):
            line.update(_k1_split(_device_ms_by_kernel(
                torch, lambda: quant.int8_matmul_cuda(x, w.values, w.scales,
                                                      dt), 10)))
        if name.startswith("resnet_dp2_rank"):
            dp2[name] = line
        emit(line)
        del x, w, wd, xq
    return errs, dp2


# ----------------------------------------------------------------------
# serving phases
# ----------------------------------------------------------------------

def _latencies(engine, since: float) -> list:
    """``engine``'s requests that arrived since ``since``
    (``time.perf_counter()``) and ended ok, from its request records
    (``utils/tracing.py``): per request ``ttft_s`` (arrival to first token),
    ``tokens`` and ``tpot_s`` (per later token; None for one token), host
    clock."""
    from seldon_core_tpu_torch.utils.tracing import request_records

    recs = request_records(since)
    if recs is None:
        raise RuntimeError("the request ring no longer holds every request "
                           "since the mark")
    return [{"ttft_s": r.t_first - r.t_arrive, "tokens": r.tokens,
             "tpot_s": ((r.t_done - r.t_first) / (r.tokens - 1)
                        if r.tokens > 1 else None)}
            for r in recs
            if r.engine == engine.engine_id and r.outcome == "ok"]


def _post(port: int, body: dict, headers: dict = None
          ) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


async def _in_threads(fn, argsets: list) -> list:
    """``fn(*args)`` for every ``args``, each in a thread of a pool of its
    own: the loop's default executor also makes the server's host copies,
    and clients blocked in it would starve them."""
    loop = asyncio.get_running_loop()
    with concurrent.futures.ThreadPoolExecutor(len(argsets)) as pool:
        return await asyncio.gather(*(loop.run_in_executor(pool, fn, *a)
                                      for a in argsets))


async def _post_all(port: int, bodies: list) -> list:
    return await _in_threads(_post, [(port, b) for b in bodies])


def _counters():
    from seldon_core_tpu_torch.ops import attention, quant
    from seldon_core_tpu_torch.runtime import paged

    return {"int8_matmul": quant.int8_matmul_cuda,
            "paged_attention": paged.paged_attention_cuda,
            "flash_attention": attention.flash_attention_cuda}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


#: llm_json's prompts and in-process ids, and the CPU plain path's ids of an
#: empty prompt: wire_llm holds the remote component to them
LLM_JSON: dict = {}
#: serve_7b's prompts and REST ids: grpc_7b holds the gRPC tiers to them
SERVE_7B: dict = {}
#: tp_7b's tp = 2 figures: multihost_7b reports beside them
TP_7B: dict = {}


def llm_json_phase(torch) -> dict:
    """The port's ``llm.json`` (automatic prefix caching on, as the
    reference's) over REST: two waves of three greedy requests, the second
    wave sharing 32-token prefixes with the first, held to the same engine
    and knobs on the CPU; then ``llm-slab.json`` (the slab engine) on the
    same waves, held to the paged graph's ids.  Returns both runs'
    launches."""
    import random

    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine

    examples = ROOT / "seldon_core_tpu_torch" / "examples"
    rng = random.Random(5)
    wave1 = [[rng.randrange(1, 256) for _ in range(n)] for n in (40, 45, 50)]
    wave2 = [p[:32] + [rng.randrange(1, 256) for _ in range(6)]
             for p in wave1]
    waves = [wave1, wave2]

    async def run(graph):
        server, local = await serve(str(examples / graph), port=0,
                                    host="127.0.0.1")
        try:
            reset_launches()
            t0 = time.perf_counter()
            answers = []
            for w in waves:
                answers += await _post_all(server.port, [
                    {"jsonData": {"prompt_ids": p, "n_new": 8}} for p in w])
            return answers, time.perf_counter() - t0, read_launches(), local
        finally:
            await server.stop()

    prompts = wave1 + wave2

    def ids_of(answers, what):
        out = []
        for (code, body), p in zip(answers, prompts):
            if code != 200:
                raise AssertionError(f"{what}: HTTP {code}: {body}")
            ids = body["jsonData"]["ids"]
            if len(ids) != len(p) + 8 or ids[:len(p)] != p or \
                    not all(0 <= t < 256 for t in ids):
                raise AssertionError(f"{what}: bad ids {ids}")
            out.append(ids)
        return out

    answers, dt, launches, local = asyncio.run(run("llm.json"))
    engine = local.engine.node_impl("llm").user.engine
    got = ids_of(answers, "llm_json")
    if engine.free_pages != engine.paged_cfg.n_pages - 1:
        raise AssertionError(f"llm_json: pages not returned "
                             f"({engine.free_pages} free)")
    stats = dict(engine.prefix_stats)
    # reference: the same weights, engine and knobs on the CPU (plain path)
    cpu = PagedLLMEngine(_to_device(engine.params, "cpu"), engine.cfg,
                         engine.paged_cfg, max_slots=engine.max_slots,
                         auto_prefix_tokens=engine._auto_budget)

    async def ref():
        out = []
        for w in waves:
            out += await asyncio.gather(*(cpu.generate(p, 8) for p in w))
        return out

    refs = [r[0].tolist() for r in asyncio.run(ref())]
    # an empty prompt's ids on the plain path, for wire_llm
    empty = asyncio.run(cpu.generate([], 3))[0].tolist()
    cpu.close()
    engine.close()
    same = [a == r for a, r in zip(got, refs)]
    LLM_JSON.update(prompts=prompts, ids=got, empty_ids=empty)
    s_answers, s_dt, s_launches, s_local = asyncio.run(run("llm-slab.json"))
    s_engine = s_local.engine.node_impl("llm").user.engine
    s_got = ids_of(s_answers, "llm_slab_json")
    s_engine.close()
    slab_same = [a == b for a, b in zip(s_got, got)]
    emit({"phase": "llm_json", "requests": len(prompts),
          "prompt_lens": [len(p) for p in prompts], "n_new": 8,
          "shared_prefix": 32, "seconds": dt, "launches": launches,
          "auto_prefix_tokens": engine._auto_budget,
          "auto_hits": stats["auto_hits"],
          "auto_tokens_reused": stats["auto_tokens_reused"],
          "cpu_auto_hits": cpu.prefix_stats["auto_hits"],
          "ids_equal_cpu_plain_path": same,
          "slab_graph": {"seconds": s_dt, "launches": s_launches,
                         "auto_hits": s_engine.prefix_stats["auto_hits"],
                         "ids_equal_paged_graph": slab_same},
          "card": CARD})
    if not all(same):
        raise AssertionError("llm_json: card ids differ from the CPU path")
    if stats["auto_hits"] < 3:
        raise AssertionError(f"llm_json: {stats['auto_hits']} automatic "
                             "prefix hits, want >= 3")
    if not all(slab_same):
        raise AssertionError("llm_json: the slab graph's ids differ from "
                             "the paged graph's")
    if launches["int8_matmul"] == 0 or launches["paged_attention"] == 0:
        raise AssertionError(f"llm_json: kernels not launched {launches}")
    if s_launches["int8_matmul"] == 0:
        raise AssertionError(f"llm_slab_json: K1 not launched {s_launches}")
    return {k: launches[k] + s_launches[k] for k in launches}


def _to_device(tree, device):
    """A tree of dicts, lists and (named) tuples of tensors on ``device``;
    ``.to`` keeps a tensor's strides (the K-major int8 weights)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_to_device(v, device) for v in tree))
    return tree.to(device)


def _cfg_7b(n_layers: int):
    import torch

    from seldon_core_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=n_layers, n_heads=32,
        n_kv_heads=8, d_ff=16384, max_seq=512, dtype=torch.bfloat16,
        use_flash=True)


def serve_7b_phase(torch) -> tuple:
    from seldon_core_tpu_torch.models.transformer import init_params_int8
    from seldon_core_tpu_torch.runtime.llm import LLMComponent, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig
    from seldon_core_tpu_torch.serving.rest import RestServer

    cfg = _cfg_7b(32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params_int8(gen, cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = PagedLLMEngine(params, cfg, PagedConfig(n_pages=96, page_size=16),
                            max_slots=8, max_len=256)
    comp = LLMComponent(engine, n_new=16)
    rng = torch.Generator().manual_seed(7)
    lens = [5 + (115 * i) // 7 for i in range(8)]  # 5 .. 120
    prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist()
               for n in lens]
    bodies = [{"jsonData": {"prompt_ids": p, "n_new": 16}} for p in prompts]

    async def run():
        server = await RestServer(comp, host="127.0.0.1", port=0).start()
        try:
            # warm-up request: first-use costs (cuBLAS handles, allocator)
            # stay out of the measured run
            code, body = await asyncio.to_thread(
                _post, server.port, {"jsonData": {"prompt_ids": [1, 2, 3],
                                                  "n_new": 2}})
            if code != 200:
                raise AssertionError(f"serve_7b warm-up: {code} {body}")
            reset_launches()
            t1 = time.perf_counter()
            answers = await _post_all(server.port, bodies)
            wall = time.perf_counter() - t1
            return answers, wall, read_launches(), t1
        finally:
            await server.stop()

    answers, wall, launches, since = asyncio.run(run())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for (code, body), p in zip(answers, prompts):
        if code != 200:
            raise AssertionError(f"serve_7b: HTTP {code}: {body}")
        ids = body["jsonData"]["ids"]
        if len(ids) != len(p) + 16 or ids[:len(p)] != p or \
                not all(0 <= t < 32000 for t in ids):
            raise AssertionError(f"serve_7b: bad answer {ids}")
    if engine.free_pages != 95:
        raise AssertionError(f"serve_7b: pages not returned "
                             f"({engine.free_pages} free)")
    SERVE_7B.update(prompts=prompts,
                    ids=[body["jsonData"]["ids"] for _, body in answers])
    log = _latencies(engine, since)
    engine.close()
    out = {"phase": "serve_7b",
           "model": "L32 d4096 H32/Hkv8 ff16384 V32000 bf16 int8-full flash",
           "requests": len(bodies), "prompt_lens": lens, "n_new": 16,
           "wall_s": wall,
           "ttft_ms_median": statistics.median(x["ttft_s"] for x in log) * 1e3,
           "tpot_ms_median": statistics.median(
               x["tpot_s"] for x in log if x["tpot_s"] is not None) * 1e3,
           "tokens_per_s": 16 * len(bodies) / wall,
           "peak_device_bytes": peak, "weights_init_s": t_init,
           "launches": launches, "card": CARD}
    emit(out)
    SERVE_7B.update({k: out[k] for k in ("ttft_ms_median", "tpot_ms_median",
                                         "tokens_per_s")})
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"serve_7b: {k} was not launched")
    return launches, params


def _json_msg(prompt: list, n_new: int):
    from seldon_core_tpu_torch.messages import SeldonMessage

    return SeldonMessage(json_data={"prompt_ids": prompt, "n_new": n_new})


def _stream_call(channel, service: str, msg):
    """A ``/seldon.tpu.<service>/Stream`` call of ``msg`` on ``channel``."""
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.convert import message_to_proto

    call = channel.unary_stream(
        f"/seldon.tpu.{service}/Stream",
        request_serializer=pb.SeldonMessage.SerializeToString,
        response_deserializer=pb.SeldonMessage.FromString)
    return call(message_to_proto(msg), timeout=600)


async def _model_stream(channel, prompt: list, n_new: int) -> list:
    """The events of one ``/seldon.tpu.Model/Stream`` call."""
    from seldon_core_tpu_torch.proto.convert import message_from_proto

    out = []
    async for resp in _stream_call(channel, "Model", _json_msg(prompt, n_new)):
        msg = message_from_proto(resp)
        if msg.status is not None and msg.status.status == "FAILURE":
            raise AssertionError(f"stream failed: {msg.status.to_dict()}")
        out.append(msg.json_data)
    return out


def grpc_7b_phase(torch, params) -> dict:
    """``serve_7b``'s model and weights (32 layers) in process behind
    ``GrpcServer`` with the ``Seldon`` service (over a graph engine) and the
    component services: 8 concurrent ``Seldon.Predict``, then 8 concurrent
    ``Model.Stream``, each request's ids equal to ``serve_7b``'s REST ids;
    TTFT/TPOT medians, peak memory, launches; then a stream cancelled after
    its first event gives back its slot and pages."""
    import grpc.aio

    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.runtime.component import ComponentHandle
    from seldon_core_tpu_torch.runtime.llm import LLMComponent, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig
    from seldon_core_tpu_torch.serving.grpc_api import (
        GrpcServer,
        SeldonGrpcClient,
        component_service_handlers,
        seldon_service_handler,
    )

    engine = PagedLLMEngine(params, _cfg_7b(32),
                            PagedConfig(n_pages=96, page_size=16),
                            max_slots=8, max_len=256)
    handle = ComponentHandle(LLMComponent(engine, n_new=16), name="llm")
    graph = GraphEngine({"name": "llm", "type": "MODEL"},
                        resolver=lambda u: handle)
    prompts, want = SERVE_7B["prompts"], SERVE_7B["ids"]

    async def run():
        server = GrpcServer([seldon_service_handler(graph)]
                            + component_service_handlers(handle, "MODEL"),
                            port=0, host="127.0.0.1")
        port = await server.start()
        client = SeldonGrpcClient(f"127.0.0.1:{port}", timeout_s=600)
        channel = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
        try:
            warm = await client.predict(_json_msg([1, 2, 3], 2))
            if warm.status.status != "SUCCESS":
                raise AssertionError(f"grpc_7b warm-up: {warm.to_dict()}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            preds = await asyncio.gather(*(client.predict(_json_msg(p, 16))
                                           for p in prompts))
            t1 = time.perf_counter()
            streams = await asyncio.gather(*(_model_stream(channel, p, 16)
                                             for p in prompts))
            t2 = time.perf_counter()
            launches = read_launches()
            # a stream cancelled after its first event
            cancelled = _stream_call(channel, "Model",
                                     _json_msg(prompts[0], 200))
            await cancelled.__aiter__().__anext__()
            held = (len(engine._slots), engine.free_pages)
            cancelled.cancel()
            t3 = time.monotonic()
            while (engine._slots or engine.free_pages != 95) and \
                    time.monotonic() - t3 < 30:
                await asyncio.sleep(0.01)
            freed = (len(engine._slots), engine.free_pages,
                     time.monotonic() - t3)
            return (preds, streams, (t1 - t0, t2 - t1), launches, held,
                    freed, t0)
        finally:
            await channel.close()
            await client.close()
            await server.stop()

    preds, streams, walls, launches, held, freed, since = asyncio.run(run())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log = _latencies(engine, since)
    engine.close()
    pred_ids = [p.json_data["ids"] if p.status.status == "SUCCESS" else
                p.status.to_dict() for p in preds]
    stream_ids = [ev[-1]["ids"] for ev in streams]
    tokens_ok = all([e["token"] for e in ev[:-1]] == ev[-1]["ids"][len(p):]
                    for ev, p in zip(streams, prompts))
    out = {"phase": "grpc_7b",
           "model": "L32 d4096 H32/Hkv8 ff16384 V32000 bf16 int8-full flash",
           "tier": "grpc.aio GrpcServer: Seldon.Predict over GraphEngine, "
                   "Model.Stream over the component",
           "requests": len(prompts), "n_new": 16,
           "predict_wall_s": walls[0], "stream_wall_s": walls[1],
           "predict_ids_equal_serve_7b": sum(a == b for a, b in
                                             zip(pred_ids, want)),
           "stream_ids_equal_serve_7b": sum(a == b for a, b in
                                            zip(stream_ids, want)),
           "stream_tokens_match_done_ids": tokens_ok,
           "ttft_ms_median": statistics.median(x["ttft_s"] for x in log) * 1e3,
           "tpot_ms_median": statistics.median(
               x["tpot_s"] for x in log if x["tpot_s"] is not None) * 1e3,
           "tokens_per_s_predict": 16 * len(prompts) / walls[0],
           "peak_device_bytes": peak, "launches": launches,
           "cancelled_stream": {"held_slots": held[0],
                                "held_free_pages": held[1],
                                "after_slots": freed[0],
                                "after_free_pages": freed[1],
                                "freed_in_s": freed[2]},
           "card": CARD}
    emit(out)
    if out["predict_ids_equal_serve_7b"] != len(prompts) or \
            out["stream_ids_equal_serve_7b"] != len(prompts) or not tokens_ok:
        raise AssertionError(f"grpc_7b: ids differ from serve_7b's: "
                             f"{pred_ids} {stream_ids} {want}")
    if held[0] != 1 or freed[:2] != (0, 95):
        raise AssertionError(f"grpc_7b: cancelled stream kept its slot or "
                             f"pages: {out['cancelled_stream']}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"grpc_7b: {k} was not launched")
    return launches


def parity_7b_phase(torch) -> None:
    """Kernel path (card) against plain path (the same weights on the CPU)
    at full width, 2 layers.  Tolerance on logits: atol 0.25 at unit-scale
    logits.  The two paths compute bf16 activations; the attention kernels
    sum float32 terms in another order, so an attention output may round to
    the neighbouring bf16 value (relative 2^-8), and int8 activation
    quantization can turn that into a step of absmax/127 for the element it
    moves; through 2 layers this stays well inside 0.25.

    Greedy ids: the logits are bf16, so the CPU path's top two logits are
    sometimes exactly equal (3 of the 10 rows here).  There every id that
    attains the CPU maximum is its greedy id, and which one the card picks
    is decided by differences far below the logit tolerance.  An id agrees
    when the CPU logit at the card's id equals the CPU maximum; all 10 must.
    The strict count (same index) is printed beside it."""
    from seldon_core_tpu_torch.models.transformer import (
        init_params_int8,
        prefill,
    )
    from seldon_core_tpu_torch.runtime.paged import (
        PagedConfig,
        arrival_counters,
        init_paged_cache,
        insert_rows,
        paged_decode_step,
    )

    cfg = _cfg_7b(2)
    arrivals = arrival_counters(2, cfg.n_heads, cfg.kv_heads, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    gpu_params = init_params_int8(gen, cfg)
    cpu_params = _to_device(gpu_params, "cpu")
    paged = PagedConfig(n_pages=24, page_size=16)
    rng = torch.Generator().manual_seed(3)
    lens = [100, 37]
    prompts = [torch.randint(1, 32000, (n,), generator=rng) for n in lens]
    tables = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 0,
                                                       0, 0]],
                          dtype=torch.int32)

    def run(params, device):
        cache = init_paged_cache(cfg, paged, device=device)
        first = []
        with torch.no_grad():
            for s, p in enumerate(prompts):
                b = 128 if len(p) > 64 else 64
                ids = torch.zeros((1, b), dtype=torch.long)
                ids[0, :len(p)] = p
                logits, small = prefill(params, ids.to(device), cfg,
                                        max_len=b, logit_pos=len(p) - 1)
                first.append(logits.float().cpu())
                idx = torch.arange(len(p))
                rows = tables[s][idx // 16].long() * 16 + idx % 16
                insert_rows(cache, small, rows.to(device), true_len=len(p))
        return torch.cat(first), cache

    def gap(logits):  # top-1 minus top-2 logit per row
        top = logits.topk(2, dim=-1).values
        return (top[:, 0] - top[:, 1]).tolist()

    def agree_count(card, cpu):  # card's greedy id attains the CPU maximum
        at = cpu.gather(-1, card.argmax(-1)[:, None])[:, 0]
        return int((at == cpu.max(-1).values).sum())

    def equal_count(card, cpu):
        return int((card.argmax(-1) == cpu.argmax(-1)).sum())

    g_first, g_cache = run(gpu_params, "cuda")
    c_first, c_cache = run(cpu_params, "cpu")
    errs = [(g_first - c_first).abs().max().item()]
    agree = [agree_count(g_first, c_first)]
    equal = [equal_count(g_first, c_first)]
    gaps = [gap(c_first)]
    tok = g_first.argmax(-1)
    pos = torch.tensor(lens, dtype=torch.int32)
    with torch.no_grad():
        for _ in range(4):
            gl, g_cache = paged_decode_step(
                gpu_params, g_cache, tables.cuda(), pos.cuda(), tok.cuda(),
                cfg, paged, arrivals)
            cl, c_cache = paged_decode_step(cpu_params, c_cache, tables, pos,
                                            tok, cfg, paged)
            gl = gl.float().cpu()
            errs.append((gl - cl).abs().max().item())
            agree.append(agree_count(gl, cl))
            equal.append(equal_count(gl, cl))
            gaps.append(gap(cl))
            tok = gl.argmax(-1)  # both paths take the card's ids next
            pos = pos + 1
    scale = c_first.abs().max().item()
    emit({"phase": "parity_7b", "layers": 2,
          "compare": "card kernel path vs CPU plain path, same weights",
          "prompt_lens": lens, "ticks": 4,
          "max_abs_err_prefill": errs[0], "max_abs_err_ticks": errs[1:],
          "tolerance": "atol 0.25", "max_abs_logit": scale,
          "greedy_ids_agree": sum(agree), "greedy_ids_total": 2 * 5,
          "agree_per_step": agree, "greedy_ids_equal_index": sum(equal),
          "cpu_top2_gap_per_step": gaps,
          "card": CARD})
    if max(errs) > 0.25:
        raise AssertionError(f"parity_7b: logits differ by {max(errs)}")
    if sum(agree) != 2 * 5:
        raise AssertionError(f"parity_7b: greedy ids agree {sum(agree)}/10")


# ----------------------------------------------------------------------
# slice 3a: prefix caching, chunked and batched prefill, preemption,
# the slab engine and checkpoints at 7B width
# ----------------------------------------------------------------------

def _rand_ids(torch, rng, n: int) -> list:
    return torch.randint(1, 32000, (n,), generator=rng).tolist()


def _max_gap_ms(times: list) -> float:
    return max((b - a for a, b in zip(times, times[1:])), default=0.0) * 1e3


def features_7b_phase(torch, params) -> dict:
    """The 7B-class int8 model at full depth (``serve_7b``'s weights)
    served by ``PagedLLMEngine`` with 192 pages of 16, 8 slots, max_len
    512, ``auto_prefix_tokens`` 2048, ``chunk_prefill`` 64 and
    ``batch_prefill_ms`` 5 behind the REST server.  Traffic: (a) a
    192-token prefix, then 8 concurrent requests sharing it (automatic
    hits); (b) the same after ``register_prefix`` (aliased pages); (c) 4
    streams decoding while a 448-token prompt admits, chunked and not; (d)
    8 concurrent 16-128-token prompts with the batching window on and off
    (chunking off, so every prompt is a window candidate); (e) 8
    priority-0 requests fill the slots, 2 priority-1 requests preempt.
    Every request must answer 200 and every slot and unpinned page come
    back; ``resumed`` must equal ``preempted`` >= 1.  Greedy agreement of
    (a) with the same prompts on an engine with every feature off is
    reported, not held (bf16 extend attention and K3 round differently).
    Returns the kernels' launches over the phase."""
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.llm import LLMComponent, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig
    from seldon_core_tpu_torch.serving.rest import RestServer

    cfg = _cfg_7b(32)
    paged = PagedConfig(n_pages=192, page_size=16)
    engine = PagedLLMEngine(params, cfg, paged, max_slots=8, max_len=512,
                            auto_prefix_tokens=2048, chunk_prefill=64,
                            batch_prefill_ms=5.0)
    comp = LLMComponent(engine, n_new=16)
    usable = paged.n_pages - 1
    rng = torch.Generator().manual_seed(11)
    prefix = _rand_ids(torch, rng, 192)
    first = prefix + _rand_ids(torch, rng, 8)
    suffix_lens = [8 + (40 * i) // 7 for i in range(8)]  # 8 .. 48
    hits = [prefix + _rand_ids(torch, rng, n) for n in suffix_lens]
    hits_b = [prefix + _rand_ids(torch, rng, n) for n in suffix_lens]
    out: dict = {"phase": "features_7b",
                 "engine": "PagedLLMEngine 192x16 pages, 8 slots, max_len "
                           "512, auto 2048, chunk 64, window 5 ms",
                 "card": CARD}

    def body(p, n_new=16, **kw):
        return {"jsonData": {"prompt_ids": p, "n_new": n_new, **kw}}

    def check(answers, prompts, n_new, what):
        ids = []
        for (code, b), p in zip(answers, prompts):
            if code != 200:
                raise AssertionError(f"features_7b {what}: HTTP {code}: {b}")
            got = b["jsonData"]["ids"]
            if got[:len(p)] != p or len(got) != len(p) + n_new:
                raise AssertionError(f"features_7b {what}: bad ids")
            ids.append(got)
        return ids

    def returned(what):
        if len(engine._free) != 8 or engine._slots or \
                engine.free_pages != usable - engine._pinned_pages:
            raise AssertionError(
                f"features_7b {what}: slots {len(engine._free)} free, pages "
                f"{engine.free_pages} free, {engine._pinned_pages} pinned")

    async def run():
        server = await RestServer(comp, host="127.0.0.1", port=0).start()
        peak = {"pages": 0}

        async def watch():
            while True:
                peak["pages"] = max(peak["pages"], usable - engine.free_pages)
                await asyncio.sleep(0.0005)

        watcher = asyncio.get_running_loop().create_task(watch())
        port = server.port
        try:
            reset_launches()
            t_phase = time.perf_counter()
            # (a) automatic prefix hits
            since = time.perf_counter()
            a0 = check(await _post_all(port, [body(first)]), [first], 16,
                       "a")
            ttft_first = _latencies(engine, since)[-1]["ttft_s"]
            since = time.perf_counter()
            s0 = dict(engine.prefix_stats)
            peak["pages"] = 0
            a_ids = check(await _post_all(port, [body(p) for p in hits]),
                          hits, 16, "a")
            out["a"] = {
                "prompt_lens": [len(first)] + [len(p) for p in hits],
                "auto_hits": engine.prefix_stats["auto_hits"]
                - s0["auto_hits"],
                "auto_tokens_reused": engine.prefix_stats[
                    "auto_tokens_reused"] - s0["auto_tokens_reused"],
                "ttft_ms_first": ttft_first * 1e3,
                "ttft_ms_median_hits": statistics.median(
                    x["ttft_s"] for x in _latencies(engine, since)) * 1e3,
                "peak_pages_in_use": peak["pages"]}
            returned("a")
            # (b) a registered prefix: its 12 full pages aliased
            engine.clear_prefixes()
            engine.register_prefix(prefix)
            since = time.perf_counter()
            peak["pages"] = 0
            s0 = dict(engine.prefix_stats)
            check(await _post_all(port, [body(p) for p in hits_b]), hits_b,
                  16, "b")
            out["b"] = {
                "pinned_pages": engine._pinned_pages,
                "alias_hits": engine.prefix_stats["alias_hits"]
                - s0["alias_hits"],
                "peak_pages_in_use": peak["pages"],
                "peak_pages_in_use_a": out["a"]["peak_pages_in_use"],
                "ttft_ms_median": statistics.median(
                    x["ttft_s"] for x in _latencies(engine, since)) * 1e3}
            returned("b")
            # (c) decode streams while a long prompt admits
            out["c"] = {}
            for chunk in (64, 0):
                engine.chunk_prefill = chunk
                streams = [_rand_ids(torch, rng, 32) for _ in range(4)]
                long_p = _rand_ids(torch, rng, 448)
                times = [[] for _ in streams]
                started = [asyncio.Event() for _ in streams]

                async def consume(i, p):
                    msg = SeldonMessage(json_data={"prompt_ids": p,
                                                   "n_new": 64})
                    async for ev in comp.stream(msg):
                        if "token" in ev:
                            times[i].append(time.perf_counter())
                            started[i].set()

                tasks = [asyncio.get_running_loop().create_task(
                    consume(i, p)) for i, p in enumerate(streams)]
                for ev in started:
                    await ev.wait()
                t_long = time.perf_counter()
                check(await _post_all(port, [body(long_p)]), [long_p], 16,
                      "c")
                t_done = time.perf_counter()
                await asyncio.gather(*tasks)
                # gaps of the streams while the long prompt was in flight
                gaps = [_max_gap_ms(
                    [max([t for t in ts if t < t_long], default=t_long)]
                    + [t for t in ts if t_long <= t <= t_done]
                    + [min([t for t in ts if t > t_done], default=t_done)])
                    for ts in times]
                out["c"][f"chunk_{chunk}"] = {
                    "max_gap_ms": max(gaps),
                    "long_request_ms": (t_done - t_long) * 1e3,
                    "stream_tokens": [len(ts) for ts in times]}
                returned("c")
            engine.chunk_prefill = 64
            # (d) a burst of 8 dense admissions, window on and off
            out["d"] = {}
            engine.chunk_prefill = 0
            for window in (5.0, 0.0):
                engine.batch_prefill_ms = window
                burst = [_rand_ids(torch, rng, 16 + (112 * i) // 7)
                         for i in range(8)]
                s0 = dict(engine.prefill_batch_stats)
                since = time.perf_counter()
                check(await _post_all(port, [body(p) for p in burst]),
                      burst, 16, "d")
                out["d"][f"window_{window:g}ms"] = {
                    "groups": engine.prefill_batch_stats["groups"]
                    - s0["groups"],
                    "requests": engine.prefill_batch_stats["requests"]
                    - s0["requests"],
                    "ttft_ms_median": statistics.median(
                        x["ttft_s"] for x in _latencies(engine, since)) * 1e3}
                returned("d")
            engine.chunk_prefill, engine.batch_prefill_ms = 64, 5.0
            # (e) priority preemption
            lows = [_rand_ids(torch, rng, 32) for _ in range(8)]
            highs = [_rand_ids(torch, rng, 32) for _ in range(2)]
            s0 = dict(engine.preempt_stats)
            since = time.perf_counter()
            low_task = asyncio.get_running_loop().create_task(
                _post_all(port, [body(p, 64) for p in lows]))
            t_fill = time.perf_counter()
            while len(engine._slots) < 8:
                if low_task.done() or time.perf_counter() - t_fill > 30:
                    err = (low_task.exception() if low_task.done()
                           else "30 s passed")
                    raise RuntimeError(
                        f"features_7b (e): {len(engine._slots)} of 8 slots "
                        f"filled, waiters {len(engine._slot_waiters)}, "
                        f"preempt_stats {engine.preempt_stats}: {err!r}")
                await asyncio.sleep(0.001)
            high_ans = await _post_all(port, [body(p, 16, priority=1)
                                              for p in highs])
            check(high_ans, highs, 16, "e")
            check(await low_task, lows, 64, "e")
            pre = engine.preempt_stats["preempted"] - s0["preempted"]
            res = engine.preempt_stats["resumed"] - s0["resumed"]
            out["e"] = {
                "preempted": pre, "resumed": res,
                "ttft_ms_priority1": [x["ttft_s"] * 1e3
                                      for x in _latencies(engine, since)
                                      if x["tokens"] == 16],
                "ttft_ms_median_priority0": statistics.median(
                    x["ttft_s"] for x in _latencies(engine, since)
                    if x["tokens"] == 64) * 1e3}
            returned("e")
            out["seconds"] = time.perf_counter() - t_phase
            out["launches"] = read_launches()
            return a0 + a_ids
        finally:
            watcher.cancel()
            await server.stop()

    a_ids = asyncio.run(run())
    engine.clear_prefixes()
    if engine.free_pages != usable:
        raise AssertionError(f"features_7b: {engine.free_pages} pages free "
                             "after clearing the prefixes")
    engine.close()
    # (a)'s prompts on an engine with every feature off
    plain = PagedLLMEngine(params, cfg, paged, max_slots=8, max_len=512)

    async def ref():
        return await asyncio.gather(*(plain.generate(p, 16)
                                      for p in [first] + hits))

    refs = [r[0].tolist() for r in asyncio.run(ref())]
    plain.close()
    agree = [sum(int(x == y) for x, y in zip(a[len(p):], r[len(p):]))
             for a, r, p in zip(a_ids, refs, [first] + hits)]
    out["a"]["greedy_tokens_equal_features_off"] = agree
    out["a"]["greedy_tokens_total"] = 16 * len(agree)
    emit(out)
    launches = out["launches"]
    e = out["e"]
    if not (e["preempted"] >= 1 and e["resumed"] == e["preempted"]):
        raise AssertionError(f"features_7b (e): {e}")
    if out["a"]["auto_hits"] != 8 or out["b"]["alias_hits"] != 8:
        raise AssertionError(f"features_7b: prefix hits {out['a']} "
                             f"{out['b']}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"features_7b: {k} was not launched")
    return launches


def parity_features_7b_phase(torch) -> None:
    """The engine's new device paths at full width, 2 layers, card against
    the same weights on the CPU (plain path): a prefix-hit extend (192
    cached rows, a 24-token suffix chunk), the last logits of a chunked
    prefill (200 tokens in 64-token chunks), the rows of an 8-row batched
    prefill (K3 at B = 8), and 4 slab ticks of those 8 rows.  Tolerance
    and tie rule as ``parity_7b``: atol 0.25 on logits, and a greedy id
    agrees when the CPU logit at the card's id equals the CPU maximum."""
    import numpy as np

    from seldon_core_tpu_torch.models.transformer import (
        decode_step,
        init_params_int8,
    )
    from seldon_core_tpu_torch.runtime.llm import LLMEngine

    cfg = _cfg_7b(2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    gpu_params = init_params_int8(gen, cfg)
    engines = {"cuda": LLMEngine(gpu_params, cfg, max_slots=8, max_len=256),
               "cpu": LLMEngine(_to_device(gpu_params, "cpu"), cfg,
                                max_slots=8, max_len=256)}
    rng = torch.Generator().manual_seed(6)
    prefix = np.asarray(_rand_ids(torch, rng, 192), np.int64)
    suffix = np.asarray(_rand_ids(torch, rng, 24), np.int64)
    longp = np.asarray(_rand_ids(torch, rng, 200), np.int64)
    lens = [16 + (48 * i) // 7 for i in range(8)]  # 16 .. 64
    rows = np.zeros((8, 64), np.int64)
    for b, n in enumerate(lens):
        rows[b, :n] = _rand_ids(torch, rng, n)

    def padded(ids, bucket):
        out = np.zeros((1, bucket), np.int64)
        out[0, :len(ids)] = ids
        return out

    def paths(eng):
        with torch.no_grad():
            res = {}
            _, small = eng._prefill_rows(padded(prefix, 256), 191)
            lg, _ = eng._extend_job(small, padded(suffix, 32), 192, 23)
            res["extend"] = lg.float().cpu()
            lg, small = eng._prefill_rows(padded(longp[:64], 64), 63)
            done = 64
            while done < 200:
                n = min(64, 200 - done)
                lg, small = eng._extend_job(
                    small, padded(longp[done:done + n], 64 if n > 32 else 8),
                    done, n - 1)
                done += n
            res["chunked"] = lg.float().cpu()
            lg, small = eng._prefill_rows(rows, np.asarray(lens) - 1)
            res["batched"] = lg.float().cpu()
            for b, n in enumerate(lens):
                eng._insert_slab({"k": small["k"][:, b:b + 1],
                                  "v": small["v"][:, b:b + 1]}, b, n)
            return res

    # on each engine's device worker, where its programs capture
    got = {dev: eng._device_worker.submit(paths, eng).result()
           for dev, eng in engines.items()}

    def agree(card, cpu):
        at = cpu.gather(-1, card.argmax(-1)[:, None])[:, 0]
        return int((at == cpu.max(-1).values).sum())

    line = {"phase": "parity_features_7b", "layers": 2,
            "compare": "card kernel path vs CPU plain path, same weights",
            "tolerance": "atol 0.25", "card": CARD}
    errs, n_agree, n_total = [], 0, 0
    for k in ("extend", "chunked", "batched"):
        c, g = got["cpu"][k], got["cuda"][k]
        errs.append((g - c).abs().max().item())
        a = agree(g, c)
        line[k] = {"max_abs_err": errs[-1], "greedy_ids_agree": a,
                   "rows": c.shape[0],
                   "greedy_ids_equal_index": int(
                       (g.argmax(-1) == c.argmax(-1)).sum())}
        n_agree += a
        n_total += c.shape[0]
    tok = got["cuda"]["batched"].argmax(-1)
    pos = torch.tensor(lens, dtype=torch.int32)
    ticks = []
    with torch.no_grad():
        for _ in range(4):
            lg = {}
            for dev, eng in engines.items():
                eng.cache["pos"] = pos.to(dev)
                out, eng.cache = decode_step(eng.params, eng.cache,
                                             tok.to(dev), cfg)
                lg[dev] = out.float().cpu()
            errs.append((lg["cuda"] - lg["cpu"]).abs().max().item())
            a = agree(lg["cuda"], lg["cpu"])
            ticks.append({"max_abs_err": errs[-1], "greedy_ids_agree": a})
            n_agree += a
            n_total += 8
            tok = lg["cuda"].argmax(-1)
            pos = pos + 1
    for eng in engines.values():
        eng.close()
    line.update(slab_ticks=ticks, greedy_ids_agree=n_agree,
                greedy_ids_total=n_total, max_abs_err=max(errs))
    emit(line)
    if max(errs) > 0.25:
        raise AssertionError(f"parity_features_7b: logits differ by "
                             f"{max(errs)}")
    if n_agree != n_total:
        raise AssertionError(f"parity_features_7b: greedy ids agree "
                             f"{n_agree}/{n_total}")


def checkpoint_7b_phase(torch) -> dict:
    """Full width, 2 layers: canonical bf16 weights saved by the port's
    checkpoint writer under ``build/``, then booted through the local
    runner as ``DemoLLM(model_uri=..., int8="full", paged_pages=96)``;
    three concurrent requests' ids must EQUAL those of an engine built on
    the card from the same weights quantized in process.  Reports the
    save and load seconds and the file's bytes.  Returns the runner's
    launches."""
    import shutil

    from seldon_core_tpu_torch.models.transformer import (
        init_params,
        quantize_attn_params,
        quantize_ffn_params,
    )
    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.runtime.checkpoint import save_transformer
    from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig

    cfg = _cfg_7b(2)
    gen = torch.Generator(device="cuda").manual_seed(9)
    params = init_params(gen, cfg)
    params = {k: ({n: w.to(torch.bfloat16) for n, w in v.items()}
                  if isinstance(v, dict) else v.to(torch.bfloat16))
              for k, v in params.items()}
    path = ROOT / "build" / "checkpoint_7b"
    shutil.rmtree(path, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_transformer(str(path), params, cfg)
        save_s = time.perf_counter() - t0
        nbytes = (path / "model.safetensors").stat().st_size
        graph = {"metadata": {"name": "llm-checkpoint-7b"}, "spec": {
            "name": "llm-checkpoint-7b",
            "annotations": {"seldon.io/batching": "false"},
            "predictors": [{"name": "main", "graph": {
                "name": "llm", "type": "MODEL", "parameters": [
                    {"name": "model_class", "type": "STRING",
                     "value": "seldon_core_tpu_torch.models.llm_demo:DemoLLM"},
                    {"name": "model_uri", "type": "STRING",
                     "value": f"file://{path}"},
                    {"name": "int8", "type": "STRING", "value": "full"},
                    {"name": "paged_pages", "type": "INT", "value": "96"},
                    {"name": "page_size", "type": "INT", "value": "16"},
                    {"name": "max_slots", "type": "INT", "value": "4"},
                    {"name": "n_new", "type": "INT", "value": "12"}]}}]}}
        rng = torch.Generator().manual_seed(4)
        prompts = [_rand_ids(torch, rng, n) for n in (7, 60, 130)]
        bodies = [{"jsonData": {"prompt_ids": p}} for p in prompts]

        async def run():
            t1 = time.perf_counter()
            server, local = await serve(graph, port=0, host="127.0.0.1")
            torch.cuda.synchronize()
            boot = time.perf_counter() - t1
            try:
                reset_launches()
                answers = await _post_all(server.port, bodies)
                return answers, boot, read_launches(), local
            finally:
                await server.stop()

        answers, load_s, launches, local = asyncio.run(run())
        served = local.engine.node_impl("llm").user.engine
        served.close()
        del served, local
    finally:
        shutil.rmtree(path, ignore_errors=True)
    q = quantize_attn_params(quantize_ffn_params(params))
    direct = PagedLLMEngine(q, cfg, PagedConfig(96, 16), max_slots=4,
                            auto_prefix_tokens=4 * cfg.max_seq)

    async def ref():
        return await asyncio.gather(*(direct.generate(p, 12)
                                      for p in prompts))

    refs = [r[0].tolist() for r in asyncio.run(ref())]
    direct.close()
    same = []
    for (code, body), r in zip(answers, refs):
        if code != 200:
            raise AssertionError(f"checkpoint_7b: HTTP {code}: {body}")
        same.append(body["jsonData"]["ids"] == r)
    emit({"phase": "checkpoint_7b", "layers": 2, "dtype": "bfloat16",
          "file_bytes": nbytes, "save_s": save_s,
          "boot_with_load_and_quantize_s": load_s,
          "prompt_lens": [len(p) for p in prompts], "n_new": 12,
          "ids_equal_in_process_engine": same, "launches": launches,
          "card": CARD})
    if not all(same):
        raise AssertionError("checkpoint_7b: ids differ from the engine "
                             "built in process")
    if launches["int8_matmul"] == 0 or launches["paged_attention"] == 0:
        raise AssertionError(f"checkpoint_7b: kernels not launched "
                             f"{launches}")
    return launches


# ----------------------------------------------------------------------
# slice 3b: speculative decoding, the token stream, state persistence
# ----------------------------------------------------------------------

def _sse_post(port: int, body: dict) -> tuple[int, dict]:
    """POST to the stream route; ``(status, the done event)``, the token
    events checked against the done event's ids."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/stream",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            events = [json.loads(ln[6:]) for ln in r.read().decode().split(
                "\n\n") if ln.startswith("data: ")]
            code = r.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    done = events[-1] if events else {}
    toks = [e.get("token") for e in events[:-1]]
    if not done.get("done") or toks != done["ids"][done["prompt_len"]:]:
        raise AssertionError(f"stream: bad events {events}")
    return code, done


def _draft_small(torch):
    """Case (b)'s draft: 2 layers at d 1024 (8 heads of 128), vocab 32000,
    bf16 weights from a seeded generator on the card, flash prefill."""
    from seldon_core_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )

    cfg = TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=2, n_heads=8, n_kv_heads=8,
        d_ff=4096, max_seq=512, dtype=torch.bfloat16, use_flash=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = init_params(gen, cfg)
    return {k: ({n: w.to(torch.bfloat16) for n, w in v.items()}
                if isinstance(v, dict) else v.to(torch.bfloat16))
            for k, v in params.items()}, cfg


SPEC_TIE_ATOL = 0.25  # parity_7b's logit tolerance
SPEC_MIN_PERFECT_ACCEPT = 0.8  # the target as its own draft


def spec_7b_phase(torch, params) -> dict:
    """Speculative decoding at full width: the 7B-class int8 model at 32
    layers (``serve_7b``'s weights) on ``PagedLLMEngine`` with
    ``k_draft`` 4, 8 slots, max_len 256 and 161 pages of 16 (17 pages a
    slot with the 5 rows of headroom), behind the REST server.  8 requests
    (prompts of 5..120 tokens, 16 new tokens), half through
    ``/api/v0.1/predictions`` and half through ``/api/v0.1/stream``, half
    greedy and half sampled (temperature 0.8, top-k 50, a seed each), run
    on three engines in turn: (a) the target as its own draft (its tensors
    shared: every draft verifies, the bonus token and the draft's extra
    KV row are exercised), (b) a small seeded bf16 draft (2 layers, d 1024:
    rejections and residual draws), and the plain engine.

    Gates: every answer 200; every slot and page back, the headroom
    included; each stream's ids equal the same request's ``/predictions``
    ids, sent again after the burst (a slot's rows do not depend on the
    others', so even its sampled ids repeat); and each greedy request's ids
    equal the plain engine's up to their first difference, where the plain
    path's top two logits must lie within ``SPEC_TIE_ATOL`` (0.25, the
    parity tolerance): the verify chunk and K2 round differently in bf16,
    so a near-tie may resolve either way, and after it the contexts
    differ.  A teacher-forced forward over the plain engine's ids (prompt
    and generated, one prefill) gives those logits; the count of such
    positions is printed.  Prints each engine's acceptance rate, TTFT and
    TPOT medians, tokens/s, peak device memory and launches per kernel;
    the perfect draft's acceptance must reach ``SPEC_MIN_PERFECT_ACCEPT``.
    Returns the launches of the three runs."""
    from seldon_core_tpu_torch.models.transformer import prefill
    from seldon_core_tpu_torch.runtime.llm import LLMComponent, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig
    from seldon_core_tpu_torch.serving.rest import RestServer

    cfg = _cfg_7b(32)
    paged = PagedConfig(n_pages=161, page_size=16)
    n_new = 16
    rng = torch.Generator().manual_seed(13)
    lens = [5 + (115 * i) // 7 for i in range(8)]  # 5 .. 120
    prompts = [_rand_ids(torch, rng, n) for n in lens]
    bodies, routes = [], []
    for i, p in enumerate(prompts):
        kw = ({"temperature": 0.8, "top_k": 50, "seed": 100 + i} if i % 2
              else {})
        bodies.append({"jsonData": {"prompt_ids": p, "n_new": n_new, **kw}})
        routes.append("stream" if (i // 2) % 2 else "predictions")
    d_params, d_cfg = _draft_small(torch)
    drafts = {"a_perfect_draft": (params, cfg),
              "b_small_draft": (d_params, d_cfg), "plain": (None, None)}

    def call(port, body, route):
        if route == "stream":
            code, done = _sse_post(port, body)
            return code, done.get("ids", done)
        code, out = _post(port, body)
        return code, out["jsonData"]["ids"] if code == 200 else out

    out = {"phase": "spec_7b",
           "model": "L32 d4096 H32/Hkv8 ff16384 V32000 bf16 int8-full flash",
           "engine": "PagedLLMEngine 161x16 pages, 8 slots, max_len 256, "
                     "k_draft 4",
           "prompt_lens": lens, "n_new": n_new, "routes": routes,
           "sampled": [bool(i % 2) for i in range(8)], "card": CARD}
    ids_by = {}
    total = {}
    for name, (dp, dc) in drafts.items():
        engine = PagedLLMEngine(params, cfg, paged, max_slots=8, max_len=256,
                                draft_params=dp, draft_cfg=dc, k_draft=4)
        comp = LLMComponent(engine, n_new=n_new)

        async def run():
            server = await RestServer(comp, host="127.0.0.1", port=0).start()
            try:
                for route in ("predictions", "stream"):  # first-use costs
                    code, res = await asyncio.to_thread(
                        call, server.port,
                        {"jsonData": {"prompt_ids": [1, 2, 3], "n_new": 2}},
                        route)
                    if code != 200:
                        raise AssertionError(f"spec_7b warm-up: {res}")
                s0 = dict(engine.spec_stats)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                answers = await _in_threads(call, [
                    (server.port, b, r) for b, r in zip(bodies, routes)])
                wall = time.perf_counter() - t0
                launches = read_launches()
                peak = torch.cuda.max_memory_allocated()
                stats = {k: engine.spec_stats[k] - s0[k] for k in s0}
                again = await _in_threads(call, [
                    (server.port, b, "predictions")
                    for b, r in zip(bodies, routes) if r == "stream"])
                return answers, again, wall, launches, peak, stats, t0
            finally:
                await server.stop()

        answers, again, wall, launches, peak, stats, since = asyncio.run(
            run())
        for code, res in answers + again:
            if code != 200:
                raise AssertionError(f"spec_7b {name}: HTTP {code}: {res}")
        if engine.free_pages != paged.n_pages - 1 or len(engine._free) != 8 \
                or engine._slots:
            raise AssertionError(f"spec_7b {name}: {engine.free_pages} pages"
                                 f" and {len(engine._free)} slots free")
        ids = [res for _, res in answers]
        streamed = [x for x, r in zip(ids, routes) if r == "stream"]
        if streamed != [res for _, res in again]:
            raise AssertionError(f"spec_7b {name}: stream ids differ from "
                                 "the same requests' /predictions ids")
        for x, p in zip(ids, prompts):
            if len(x) != len(p) + n_new or x[:len(p)] != p or \
                    not all(0 <= t < 32000 for t in x):
                raise AssertionError(f"spec_7b {name}: bad ids {x}")
        log = _latencies(engine, since)
        engine.close()
        ids_by[name] = ids
        total[name] = launches
        out[name] = {
            "accept_rate": (stats["accepted"] / stats["drafted"]
                            if stats["drafted"] else None),
            "spec_stats": stats, "wall_s": wall,
            "ttft_ms_median": statistics.median(
                x["ttft_s"] for x in log) * 1e3,
            "tpot_ms_median": statistics.median(
                x["tpot_s"] for x in log if x["tpot_s"] is not None) * 1e3,
            "tokens_per_s": n_new * len(bodies) / wall,
            "peak_device_bytes": peak, "launches": launches}
    del d_params
    # greedy agreement with the plain engine, up to a near-tie
    near_ties, agree = [], {}
    with torch.no_grad():
        for i, p in enumerate(prompts):
            if i % 2:
                continue
            plain = ids_by["plain"][i]
            ids = torch.tensor([plain], device="cuda")
            logits, _ = prefill(params, ids, cfg, max_len=len(plain))
            top = logits[0].topk(2, dim=-1).values.float().cpu()
            for name in ("a_perfect_draft", "b_small_draft"):
                spec = ids_by[name][i]
                diff = [j for j in range(len(p), len(plain))
                        if spec[j] != plain[j]]
                agree.setdefault(name, []).append(
                    (diff[0] if diff else len(plain)) - len(p))
                if diff:
                    gap = float(top[diff[0] - 1, 0] - top[diff[0] - 1, 1])
                    near_ties.append({"draft": name, "request": i,
                                      "position": diff[0] - len(p),
                                      "plain_top2_gap": gap})
                    if gap > SPEC_TIE_ATOL:
                        emit({**out, "near_ties": near_ties})
                        raise AssertionError(
                            f"spec_7b {name}: greedy request {i} leaves the "
                            f"plain ids at {diff[0] - len(p)} with a top-2 "
                            f"gap of {gap} > {SPEC_TIE_ATOL}")
    out.update(greedy_tokens_equal_plain_before_first_difference=agree,
               near_ties=near_ties, near_tie_count=len(near_ties),
               tie_rule=f"plain top-2 gap <= {SPEC_TIE_ATOL}")
    emit(out)
    # the perfect draft's rejections are bf16 near-ties between its slab
    # step and the paged verify chunk (a per-draft acceptance of 0.955
    # gives 0.90 over k = 4); a draft KV hole would fall far below
    a = out["a_perfect_draft"]["accept_rate"]
    if a is None or a < SPEC_MIN_PERFECT_ACCEPT:
        raise AssertionError(f"spec_7b: the perfect draft accepted {a}")
    for name in ("a_perfect_draft", "b_small_draft"):
        lz = total[name]
        if lz["int8_matmul"] == 0 or lz["flash_attention"] == 0:
            raise AssertionError(f"spec_7b {name}: kernels not launched {lz}")
    if total["plain"]["paged_attention"] == 0:
        raise AssertionError("spec_7b plain: K2 not launched")
    return {k: sum(t[k] for t in total.values()) for k in total["plain"]}


LLM_GRAPHS_REPS = 5  # admission jobs timed per mode and turn
# llm_graphs_7b (h): a prefill budget that 12 keys at 32 layers exceed
RETAIN_PROBE_BYTES = 320 << 20


def _llm_burst(torch, engine, bodies: list, n_new: int) -> tuple:
    """``bodies`` through ``LLMComponent`` behind the REST server twice: a
    warm-up burst (first-use costs and, with graphs, the captures of every
    shape the traffic needs) and the measured burst.  Returns the measured
    ids, the warm-up's ids and the measured burst's TTFT and TPOT medians
    (the engine's request records, host clock), tokens/s and wall seconds."""
    from seldon_core_tpu_torch.runtime.llm import LLMComponent
    from seldon_core_tpu_torch.serving.rest import RestServer

    comp = LLMComponent(engine, n_new=n_new)

    async def run():
        server = await RestServer(comp, host="127.0.0.1", port=0).start()
        try:
            warm = await _post_all(server.port, bodies)
            t0 = time.perf_counter()
            answers = await _post_all(server.port, bodies)
            return warm, answers, time.perf_counter() - t0, t0
        finally:
            await server.stop()

    warm, answers, wall, since = asyncio.run(run())
    for code, body in warm + answers:
        if code != 200:
            raise AssertionError(f"llm_graphs_7b: HTTP {code}: {body}")
    log = _latencies(engine, since)
    return ([b["jsonData"]["ids"] for _, b in answers],
            [b["jsonData"]["ids"] for _, b in warm],
            {"ttft_ms_median": statistics.median(
                x["ttft_s"] for x in log) * 1e3,
             "tpot_ms_median": statistics.median(
                 x["tpot_s"] for x in log if x["tpot_s"] is not None) * 1e3,
             "tokens_per_s": n_new * len(bodies) / wall, "wall_s": wall})


def _graph_pool_probe(torch, params, cfg, sweep) -> dict:
    """``llm_graphs_7b`` (i): a paged engine at max_len 4096 whose page
    pool takes the card's free memory less twice ``GRAPH_RETAIN_BYTES``;
    ``sweep``'s 12 prefill keys and a request's ticks, each shape captured
    at first sight.  Whether every capture succeeded, the graph pool's
    bytes per key and its peak, the least free memory."""
    from seldon_core_tpu_torch.runtime import llm
    from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig

    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    elem = torch.empty((), dtype=cfg.dtype).element_size()
    page_bytes = 2 * cfg.n_layers * cfg.kv_heads * 16 * cfg.d_head * elem
    reserve = 2 * llm.GRAPH_RETAIN_BYTES
    n_pages = int((free0 - reserve) // page_bytes)
    probe = {"max_len": 4096, "free_before_bytes": free0,
             "total_bytes": total, "page_bytes": page_bytes,
             "n_pages": n_pages, "page_pool_bytes": n_pages * page_bytes,
             "retain_budget_bytes": llm.GRAPH_RETAIN_BYTES,
             "reserve_bytes": reserve}
    full = PagedLLMEngine(params, cfg, PagedConfig(n_pages, 16),
                          max_slots=8, max_len=4096)
    try:
        torch.cuda.reset_peak_memory_stats()
        probe["free_after_pool_bytes"] = torch.cuda.mem_get_info()[0]
        try:
            rows, _ = sweep(full, 1)
            probe["captures_ok"] = True
            probe["pool_bytes_by_key"] = [[r["key"], r["pool_bytes"]]
                                          for r in rows]
            probe["pool_peak_bytes"] = max(r["pool_bytes"] for r in rows)
            probe["evicted"] = rows[-1]["evicted"]
            _llm_burst(torch, full, [{"jsonData": {"prompt_ids": _rand_ids(
                torch, torch.Generator().manual_seed(77), 64),
                "n_new": 4}}], 4)
            probe["tick_ok"] = True
            probe["pool_bytes_after_tick"] = full._graph_pool.bytes()
        except Exception as e:  # the finding: which capture ran out
            probe["captures_ok"] = False
            probe["error"] = f"{type(e).__name__}: {str(e)[:400]}"
        probe["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        probe["free_min_bytes"] = torch.cuda.mem_get_info()[0]
    finally:
        full.close()
    return probe


def llm_graphs_7b_phase(torch, params) -> dict:
    """The LLM engines' programs as CUDA graphs against the same programs
    run eagerly (``programs.eager()``), at 32 layers on ``serve_7b``'s
    weights, on five engines in turn: the paged engine (``serve_7b``'s: 96
    pages of 16, 8 slots, max_len 256), the slab engine (8 slots, max_len
    256), the speculative paged engine (``spec_7b``'s: 161 pages, k 4)
    with the target as its own draft and with ``spec_7b``'s small draft,
    and the speculative slab engine with the small draft.

    (a) Every program's first replay is bitwise equal to its eager run (the
    program raises otherwise): the count of (program, key) captures.
    (b) 8 requests of 16 new tokens behind REST, ``serve_7b``'s prompts on
    the plain engines and ``spec_7b``'s on the speculative ones, even
    requests greedy and odd ones sampled (temperature 0.8, top-k 50, a seed
    each): eager then graphs, each a warm-up burst and a measured one; the
    ids of the graphs EQUAL the eager ids, greedy and sampled, and each
    mode's warm-up ids equal its measured ids.  (d) The measured bursts'
    TTFT and TPOT medians and tokens/s.  (c) ``profile_decode``'s host ms
    per tick, device busy ms and idle share on the paged engine, eager,
    graphs, graphs, eager.  (e) Milliseconds per admission job on the paged
    engine's worker (a 128-token prefill with its first token's draw, a
    batched prefill of 8 x 128 rows, a 64-token extend of a 128-row
    prefix with its draw; median of ``LLM_GRAPHS_REPS`` after a warm-up
    that captures), eager, graphs, graphs, eager.  (f) Capture seconds per
    key, replays and pool bytes per engine; peak device memory.  (g) One
    replayed tick's K1 and K2 launches held against the kernels
    torch.profiler sees in it (each K1 launch: one quantize pass and one
    product; 6 projections a layer and the lm_head, and K2 once a layer);
    so are one replayed prefill (1 x 128: K1 and K3, once a layer), extend
    and speculative round (the perfect draft's on pages, K1 in its draft
    steps and its verify chunk; the slab engine's).  (h) The prefill
    program's retained bytes and the pool's after each call of 12 (rows,
    bucket) keys, rows 1, 2, 4, 8 by buckets 64, 128, 256: once on the
    paged engine at ``GRAPH_RETAIN_BYTES``, and twice on a fresh one at
    ``RETAIN_PROBE_BYTES``, which evicts (the second pass captures the
    evicted keys again); the last key's answer bitwise equal on both; beside them, what every key up to 8 rows and the
    bucket of max_len would hold with no budget, at max_len 256 and 4096.
    Returns the launches of the measured and warm-up bursts."""
    import numpy as np

    from seldon_core_tpu_torch import profile_decode
    from seldon_core_tpu_torch.runtime import llm, programs
    from seldon_core_tpu_torch.runtime.llm import LLMEngine, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig

    cfg = _cfg_7b(32)
    n_new = 16

    def traffic(prompts, seed0):
        return [{"jsonData": {
            "prompt_ids": p, "n_new": n_new,
            **({"temperature": 0.8, "top_k": 50, "seed": seed0 + i}
               if i % 2 else {})}} for i, p in enumerate(prompts)]

    # serve_7b's prompts, and spec_7b's (its generator, its seeds)
    rng = torch.Generator().manual_seed(13)
    spec_prompts = [_rand_ids(torch, rng, 5 + (115 * i) // 7)
                    for i in range(8)]
    bodies = {"serve": traffic(SERVE_7B["prompts"], 200),
              "spec": traffic(spec_prompts, 100)}
    d_params, d_cfg = _draft_small(torch)
    makers = {
        "paged": lambda: PagedLLMEngine(
            params, cfg, PagedConfig(n_pages=96, page_size=16), max_slots=8,
            max_len=256),
        "slab": lambda: LLMEngine(params, cfg, max_slots=8, max_len=256),
        "spec_perfect_draft": lambda: PagedLLMEngine(
            params, cfg, PagedConfig(n_pages=161, page_size=16), max_slots=8,
            max_len=256, draft_params=params, draft_cfg=cfg, k_draft=4),
        "spec_small_draft": lambda: PagedLLMEngine(
            params, cfg, PagedConfig(n_pages=161, page_size=16), max_slots=8,
            max_len=256, draft_params=d_params, draft_cfg=d_cfg, k_draft=4),
        "slab_spec": lambda: LLMEngine(
            params, cfg, max_slots=8, max_len=256, draft_params=d_params,
            draft_cfg=d_cfg, k_draft=4),
    }
    out = {"phase": "llm_graphs_7b",
           "model": "L32 d4096 H32/Hkv8 ff16384 V32000 bf16 int8-full flash",
           "prompt_lens": {k: [len(b["jsonData"]["prompt_ids"]) for b in v]
                           for k, v in bodies.items()}, "n_new": n_new,
           "sampled": [bool(i % 2) for i in range(8)], "card": CARD}
    def held(label, engine, job, want=None):
        """One ``job()`` on ``engine``'s worker under torch.profiler: the
        launches it counted against the kernels the profiler saw (K1's
        quantize pass and product each once a launch); ``want``: expected
        counts by kernel."""
        def run():
            return engine._device_worker.submit(job).result()

        before = read_launches()
        seen = _kernels_run(torch, run)
        after = read_launches()
        counted = {k: after[k] - before[k] for k in after}
        seen_k = {"k1_quantize": sum(n for k, n in seen.items()
                                     if "quant_rows" in k),
                  "k1_product": sum(n for k, n in seen.items()
                                    if "int8_gemm" in k or "int8_gemv" in k),
                  "k2": sum(n for k, n in seen.items()
                            if "paged_decode" in k),
                  "k3": sum(n for k, n in seen.items() if "flash_fwd" in k)}
        line = {"launches_counted": counted, "kernels_profiled": seen_k,
                "device_kernels_profiled": sum(seen.values()),
                "first_device_record_us": PROFILE_FIRST_US[-1],
                "sentinels_seen": PROFILE_WINDOWS[-1]["sentinels_seen"],
                "expected": want}
        out.setdefault("replays_profiled", {})[label] = line
        if not (counted["int8_matmul"] == seen_k["k1_quantize"]
                == seen_k["k1_product"]
                and counted["paged_attention"] == seen_k["k2"]
                and counted["flash_attention"] == seen_k["k3"]
                and sum(counted.values()) > 0
                and all(counted[k] == n for k, n in (want or {}).items())):
            emit(out)
            raise AssertionError(f"llm_graphs_7b: one {label} replay "
                                 f"counted {counted}, the profiler saw "
                                 f"{seen_k}, expected {want}")

    want_k1 = 6 * cfg.n_layers + 1  # 6 projections a layer, the lm_head
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    captures = {}  # (program, key) captures per engine, each checked
    kept = {}  # engines used again after the bursts
    for name, make in makers.items():
        engine = make()
        traffic_of = bodies["serve" if name in ("paged", "slab")
                            else "spec"]
        with programs.eager():
            e_ids, e_warm, e_line = _llm_burst(torch, engine, traffic_of,
                                               n_new)
        g_ids, g_warm, g_line = _llm_burst(torch, engine, traffic_of, n_new)
        stats = engine.program_stats()
        captures[name] = sum(p["captures"]
                             for p in stats["programs"].values())
        equal = [a == b for a, b in zip(g_ids, e_ids)]
        out[name] = {"eager": e_line, "graphs": g_line,
                     "ids_equal_eager": equal,
                     "greedy_equal": sum(equal[0::2]),
                     "sampled_equal": sum(equal[1::2]),
                     "programs": stats}
        if not (all(equal) and len(equal) == len(traffic_of)
                and e_warm == e_ids and g_warm == g_ids):
            emit(out)
            raise AssertionError(f"llm_graphs_7b {name}: graph ids differ "
                                 f"from eager ids ({equal}) or a burst "
                                 "repeated differently")
        if name in ("paged", "spec_perfect_draft", "slab_spec"):
            kept[name] = engine
        else:
            engine.close()
    launches = read_launches()
    # (g) one greedy speculative round at profile_decode's lengths (a
    # first call captures its key if the bursts did not)
    for name in ("spec_perfect_draft", "slab_spec"):
        engine = kept.pop(name)
        st = profile_decode.live_state(engine, cfg.vocab_size)
        engine._device_worker.submit(engine._spec_device, st).result()
        held(f"{name} round", engine, lambda: engine._spec_device(st),
             {"int8_matmul": (engine.k_draft + 2) * want_k1
              if engine.draft_params is params else want_k1})
        engine.close()
    del d_params
    engine = kept.pop("paged")
    worker = engine._device_worker

    # (c) the tick, eager and graphs in turns
    state = profile_decode.live_state(engine, cfg.vocab_size)
    ticks = []
    for eager in (True, False, False, True):
        r = profile_decode.profile_ticks(engine, state, 8, eager=eager)
        ticks.append({k: r[k] for k in (
            "mode", "host_ms_per_tick_median", "device_busy_ms_per_tick",
            "device_idle_share", "device_events_per_tick")})
    out["tick"] = ticks

    # (g) one replayed tick's launches against the profiler's kernels
    held("tick", engine, lambda: engine._tick_device(state),
         {"int8_matmul": want_k1, "paged_attention": cfg.n_layers,
          "flash_attention": 0})

    # (e) admission jobs
    rng = torch.Generator().manual_seed(31)
    ids128 = np.asarray([_rand_ids(torch, rng, 128)], np.int64)
    ids8 = np.asarray([_rand_ids(torch, rng, 128) for _ in range(8)],
                      np.int64)
    pos8 = np.asarray([127 - 9 * b for b in range(8)], np.int64)
    ids8[np.arange(128)[None, :] > pos8[:, None]] = 0
    suffix = np.asarray([_rand_ids(torch, rng, 64)], np.int64)
    first = (0.0, 0, 1.0, None)  # a greedy first token's draw
    src = worker.submit(engine._prefill_rows, ids128, 127).result()[1]
    jobs = {
        "prefill_128": lambda: engine._then_first(
            engine._prefill_rows, first)(ids128, 127)[2],
        "batched_prefill_8x128": lambda: engine._prefill_rows(
            ids8, pos8)[0].argmax(-1).tolist(),
        "extend_64_after_128": lambda: engine._then_first(
            engine._extend_job, first)(src, suffix, 128, 63)[2],
    }
    admissions = []
    for eager in (True, False, False, True):
        row = {}
        with programs.eager() if eager else contextlib.nullcontext():
            row["mode"] = ("graphs" if programs.graphs_on(engine.device)
                           else "eager")
            for label, job in jobs.items():
                worker.submit(job).result()  # warm-up (and capture)
                ms = []
                for _ in range(LLM_GRAPHS_REPS):
                    t0 = time.perf_counter()
                    worker.submit(job).result()  # ends with a host read
                    ms.append((time.perf_counter() - t0) * 1e3)
                row[label + "_ms_median"] = statistics.median(ms)
                row[label + "_ms"] = ms
        admissions.append(row)
    out["admission_jobs"] = admissions
    # (g) a replayed prefill (its key captured in (e)) and extend
    held("prefill 1x128", engine, lambda: engine._prefill_rows(ids128, 127),
         {"int8_matmul": want_k1, "flash_attention": cfg.n_layers,
          "paged_attention": 0})
    held("extend 64 after 128", engine,
         lambda: engine._extend_job(src, suffix, 128, 63),
         {"int8_matmul": want_k1, "paged_attention": 0,
          "flash_attention": 0})
    torch.cuda.synchronize()
    # (f) the paged engine again, with the admissions' captures
    stats = out["paged"]["programs"] = engine.program_stats()
    captures["paged"] = sum(p["captures"]
                            for p in stats["programs"].values())

    # (h) what the prefill program retains, key by key
    def key_bytes(B, L):  # static ids, logit positions, logits, K and V
        return (B * L * 8 + B * 8 + B * cfg.vocab_size * 4
                + 2 * cfg.n_layers * B * L * cfg.kv_heads * cfg.d_head
                * 2)

    def sweep(eng, passes):
        """The 12 keys in order, ``passes`` times (each key's ids from a
        seed of its own); a row per call, and the last answer."""
        rows, last = [], None
        for B, L in [(B, L) for B in (1, 2, 4, 8)
                     for L in (64, 128, 256)] * passes:
            rng = torch.Generator().manual_seed(1000 * B + L)
            ids = np.asarray([_rand_ids(torch, rng, L) for _ in range(B)],
                             np.int64)
            last = eng._device_worker.submit(eng._prefill_rows, ids,
                                             L - 1).result()
            prog = eng._programs["prefill"]
            rows.append({"key": [B, L],
                         "retained_bytes": prog.retained_bytes(),
                         "pool_bytes": eng._graph_pool.bytes(),
                         "evicted": prog.evicted})
        return rows, last

    budget_rows, ans = sweep(engine, 1)
    engine.close()
    saved = llm.GRAPH_RETAIN_BYTES
    llm.GRAPH_RETAIN_BYTES = RETAIN_PROBE_BYTES
    try:
        tight = PagedLLMEngine(params, cfg, PagedConfig(96, 16),
                               max_slots=8, max_len=256)
        tight_rows, tight_ans = sweep(tight, 2)
    finally:
        llm.GRAPH_RETAIN_BYTES = saved
    tight.close()
    largest = key_bytes(8, 256)
    same = (programs.bitwise_equal(ans[0], tight_ans[0])
            and all(programs.bitwise_equal(ans[1][k], tight_ans[1][k])
                    for k in ("k", "v")))
    out["prefill_retention"] = {
        "default_budget_bytes": saved, "at_default": budget_rows,
        "probe_budget_bytes": RETAIN_PROBE_BYTES, "at_probe": tight_rows,
        "largest_key_bytes": largest,
        "last_answer_bitwise_equal": same,
        "unbounded_bytes": {
            str(max_len): sum(key_bytes(B, 8 << j) for B in range(1, 9)
                              for j in range(max_len.bit_length() - 3))
            for max_len in (256, 4096)}}
    if not (same and tight_rows[-1]["evicted"] > 0
            and all(r["retained_bytes"] <= RETAIN_PROBE_BYTES + largest
                    for r in tight_rows)):
        emit(out)
        raise AssertionError("llm_graphs_7b: the prefill program's "
                             "eviction did not hold its budget or changed "
                             "an answer")
    out["captures_checked_bitwise"] = captures
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()

    # (i) the graph pool's peak at max_len 4096 beside a page pool that
    # takes the card's free memory less twice the programs' retention
    # budget (what their static buffers may hold, and as much again for
    # the pool): the 12 prefill keys, captured at first sight, and ticks
    probe = _graph_pool_probe(torch, params, cfg, sweep)
    # the engine's programs and worker form reference cycles: collect
    # them, or its 69 GB page pool outlives the probe
    gc.collect()
    torch.cuda.empty_cache()
    probe["free_after_close_bytes"] = torch.cuda.mem_get_info()[0]
    if probe["free_after_close_bytes"] < probe["page_pool_bytes"]:
        emit({**out, "graph_pool_at_4096": probe})
        raise AssertionError("llm_graphs_7b: the probe's page pool was not "
                             "freed")
    out["graph_pool_at_4096"] = probe
    out["launches"] = launches
    emit(out)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"llm_graphs_7b: {k} was not launched")
    return launches


def parity_spec_7b_phase(torch) -> None:
    """The speculative path at full width, 2 layers, card against the same
    weights on the CPU (plain path).  (1) One verify chunk against pages
    (``paged_chunk_step``): 8 slots of 12..54 prompt tokens, 5 tokens
    each, logits within atol 0.25.  (2) The card's speculative engine (the
    target as its own draft, k_draft 4) generates 12 tokens for the first 4
    prompts;
    a CPU prefill over each prompt and the card's ids gives the plain
    path's logits.

    Greedy ids, chunk rows and generated positions alike: the count that
    agrees under ``parity_7b``'s rule (the CPU logit at the card's id
    equals the CPU maximum) is printed, and every other id must be a
    near-tie, its CPU logit within ``SPEC_TIE_ATOL`` (the logit tolerance)
    of the CPU maximum; its deficit is printed.  The exact rule alone does
    not hold over this many positions: the paths' float32 attention sums
    differ in order, a bf16 activation then rounds the other way now and
    then, and a top-2 gap under 0.1 is common at vocab 32000 (the first
    run read 38/40 and 47/48)."""
    from seldon_core_tpu_torch.models.transformer import (
        init_params_int8,
        prefill,
    )
    from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import (
        PagedConfig,
        init_paged_cache,
        insert_rows,
        paged_chunk_step,
    )

    cfg = _cfg_7b(2)
    gen = torch.Generator(device="cuda").manual_seed(8)
    gpu_params = init_params_int8(gen, cfg)
    cpu_params = _to_device(gpu_params, "cpu")
    paged = PagedConfig(n_pages=33, page_size=16)
    rng = torch.Generator().manual_seed(12)
    lens = [12 + 6 * i for i in range(8)]  # 12 .. 54
    prompts = [torch.randint(1, 32000, (n,), generator=rng) for n in lens]
    tables = torch.arange(1, 33, dtype=torch.int32).reshape(8, 4)
    toks = torch.randint(1, 32000, (8, 5), generator=rng)
    pos = torch.tensor(lens, dtype=torch.int32)

    def deficits(card_ids, cpu):
        """CPU maximum minus the CPU logit at each card id."""
        at = cpu.gather(-1, card_ids[:, None])[:, 0]
        return (cpu.max(-1).values - at).tolist()

    def chunk(params, device):
        cache = init_paged_cache(cfg, paged, device=device)
        with torch.no_grad():
            for s, p in enumerate(prompts):
                ids = torch.zeros((1, 64), dtype=torch.long)
                ids[0, :len(p)] = p
                _, small = prefill(params, ids.to(device), cfg, max_len=64,
                                   logit_pos=len(p) - 1)
                idx = torch.arange(len(p))
                rows = tables[s][idx // 16].long() * 16 + idx % 16
                insert_rows(cache, small, rows.to(device), true_len=len(p))
            logits, _ = paged_chunk_step(params, cache, tables.to(device),
                                         pos.to(device), toks.to(device),
                                         cfg, paged)
        return logits.float().cpu().reshape(40, -1)

    g, c = chunk(gpu_params, "cuda"), chunk(cpu_params, "cpu")
    err = (g - c).abs().max().item()
    chunk_def = deficits(g.argmax(-1), c)
    eng = PagedLLMEngine(gpu_params, cfg, PagedConfig(24, 16), max_slots=4,
                         max_len=64, draft_params=gpu_params, draft_cfg=cfg,
                         k_draft=4)
    spec_prompts = [p.tolist() for p in prompts[:4]]

    async def run():
        return await asyncio.gather(*(eng.generate(p, 12)
                                      for p in spec_prompts))

    outs = [o[0].tolist() for o in asyncio.run(run())]
    stats = dict(eng.spec_stats)
    eng.close()
    gen_def = []
    with torch.no_grad():
        for p, o in zip(spec_prompts, outs):
            logits, _ = prefill(cpu_params, torch.tensor([o[:-1]]), cfg,
                                max_len=len(o) - 1)
            gen_def += deficits(torch.tensor(o[len(p):]),
                                logits[0, len(p) - 1:].float())
    near = [d for d in chunk_def + gen_def if d > 0]
    line = {"phase": "parity_spec_7b", "layers": 2,
            "compare": "card speculative path vs CPU plain path, same "
                       "weights",
            "tolerance": "atol 0.25", "chunk_max_abs_err": err,
            "chunk_greedy_ids_agree": chunk_def.count(0.0), "chunk_rows": 40,
            "engine_greedy_ids_agree": gen_def.count(0.0),
            "engine_greedy_ids_total": len(gen_def),
            "near_tie_deficits": near,
            "tie_rule": f"exact, or within {SPEC_TIE_ATOL} of the CPU "
                        "maximum", "spec_stats": stats, "card": CARD}
    emit(line)
    if err > 0.25:
        raise AssertionError(f"parity_spec_7b: chunk logits differ by {err}")
    if any(d > SPEC_TIE_ATOL for d in near):
        raise AssertionError(f"parity_spec_7b: a greedy id is {max(near)} "
                             "below the CPU maximum")


# ----------------------------------------------------------------------
# slice 6a: tensor-parallel serving, two tp ranks on the one card
# ----------------------------------------------------------------------

def _card_meshes(torch):
    """The card's 1-rank and 2-rank tp meshes (both ranks on cuda:0) and
    the CPU's 2-rank mesh."""
    from seldon_core_tpu_torch.parallel.mesh import make_mesh

    return (make_mesh(devices=["cuda:0"], tp=1),
            make_mesh(devices=["cuda:0", "cuda:0"], tp=2),
            make_mesh(devices=["cpu", "cpu"], tp=2))


def parity_tp_7b_phase(torch) -> dict:
    """The tensor-parallel kernel path at full width, 2 layers, int8
    "ffn" (w1, w2 and the lm_head int8, attention in bf16), flash prefill,
    on a tp = 2 mesh of two ranks on cuda:0, against the plain path on the
    CPU at tp = 2 with the same weights.  8 prompts of 66..127 tokens
    prefill one by one (bucket 128: K3 at B1 L128 H16/Hkv4 per rank, K1 on
    each rank's w1 columns and w2 rows, the lm_head's vocabulary shard at
    one row), then 4 decode ticks of the 8 slots against a tp-split page
    pool (K2 at S8 H16/Hkv4 per rank, K1 at M 8).  Logits within
    ``parity_7b``'s atol 0.25.  Greedy ids: the count under its tie rule
    (the CPU logit at the card's id equals the CPU maximum) is printed, and
    every other id must be a near-tie, its CPU logit within
    ``SPEC_TIE_ATOL`` of the CPU maximum (``parity_spec_7b``'s rule: over
    40 positions the exact rule does not hold for the card against the CPU
    at tp = 1 either; the first run read 38 of 40 exact, as that phase's
    first run did).  Returns the card run's launches."""
    from seldon_core_tpu_torch.models.transformer import (
        init_params_int8,
        prefill,
        shard_params,
    )
    from seldon_core_tpu_torch.runtime.paged import (
        PagedConfig,
        arrival_counters,
        init_paged_cache,
        insert_rows,
        paged_decode_step,
    )

    cfg = _cfg_7b(2)
    _, card_mesh, cpu_mesh = _card_meshes(torch)
    gen = torch.Generator(device="cuda").manual_seed(16)
    base = init_params_int8(gen, cfg, int8="ffn")
    gpu_params = shard_params(base, card_mesh, cfg)
    cpu_params = shard_params(_to_device(base, "cpu"), cpu_mesh, cfg)
    del base
    S, pps = 8, 9
    paged = PagedConfig(n_pages=1 + S * pps, page_size=16)
    arrivals = arrival_counters(S, cfg.n_heads, cfg.kv_heads, "cuda",
                                mesh=card_mesh)
    rng = torch.Generator().manual_seed(17)
    lens = [66 + (61 * i) // 7 for i in range(S)]  # 66 .. 127
    prompts = [torch.randint(1, 32000, (n,), generator=rng) for n in lens]
    tables = torch.arange(1, 1 + S * pps, dtype=torch.int32).reshape(S, pps)

    def run(params, mesh, device):
        cache = init_paged_cache(cfg, paged, device=device, mesh=mesh)
        first = []
        with torch.no_grad():
            for s, p in enumerate(prompts):
                ids = torch.zeros((1, 128), dtype=torch.long)
                ids[0, :len(p)] = p
                logits, small = prefill(params, ids.to(device), cfg,
                                        max_len=128, logit_pos=len(p) - 1,
                                        mesh=mesh)
                first.append(logits.float().cpu())
                idx = torch.arange(len(p))
                rows = tables[s][idx // 16].long() * 16 + idx % 16
                insert_rows(cache, small, rows.to(device), true_len=len(p))
        return torch.cat(first), cache

    def deficits(card, cpu):
        """CPU maximum minus the CPU logit at each of the card's ids."""
        at = cpu.gather(-1, card.argmax(-1)[:, None])[:, 0]
        return (cpu.max(-1).values - at).tolist()

    # the CPU path launches nothing: the counts are the card run's
    torch.cuda.synchronize()
    reset_launches()
    g_first, g_cache = run(gpu_params, card_mesh, "cuda")
    c_first, c_cache = run(cpu_params, cpu_mesh, "cpu")
    errs = [(g_first - c_first).abs().max().item()]
    defs = [deficits(g_first, c_first)]
    equal = [int((g_first.argmax(-1) == c_first.argmax(-1)).sum())]
    tok = g_first.argmax(-1)
    pos = torch.tensor(lens, dtype=torch.int32)
    with torch.no_grad():
        for _ in range(4):
            gl, g_cache = paged_decode_step(
                gpu_params, g_cache, tables.cuda(), pos.cuda(), tok.cuda(),
                cfg, paged, arrivals, mesh=card_mesh)
            gl = gl.float().cpu()
            cl, c_cache = paged_decode_step(cpu_params, c_cache, tables, pos,
                                            tok, cfg, paged, mesh=cpu_mesh)
            errs.append((gl - cl).abs().max().item())
            defs.append(deficits(gl, cl))
            equal.append(int((gl.argmax(-1) == cl.argmax(-1)).sum()))
            tok = gl.argmax(-1)  # both paths take the card's ids next
            pos = pos + 1
    launches = read_launches()
    agree = [sum(d == 0.0 for d in step) for step in defs]
    near = [d for step in defs for d in step if d > 0]
    line = {"phase": "parity_tp_7b", "layers": 2, "tp": 2,
            "mesh": "tp=2 on [cuda:0, cuda:0] vs tp=2 on [cpu, cpu]",
            "model": "d4096 H32/Hkv8 ff16384 V32000 bf16 int8-ffn flash",
            "per_rank": "H16/Hkv4, w1 4096x8192, w2 8192x4096, lm_head "
                        "4096x16000",
            "prompt_lens": lens, "ticks": 4,
            "max_abs_err_prefill": errs[0], "max_abs_err_ticks": errs[1:],
            "tolerance": "atol 0.25", "greedy_ids_agree": sum(agree),
            "greedy_ids_total": S * 5, "agree_per_step": agree,
            "greedy_ids_equal_index": sum(equal),
            "near_tie_deficits": near,
            "tie_rule": f"exact, or within {SPEC_TIE_ATOL} of the CPU "
                        "maximum", "launches": launches, "card": CARD}
    emit(line)
    if max(errs) > 0.25:
        raise AssertionError(f"parity_tp_7b: logits differ by {max(errs)}")
    if any(d > SPEC_TIE_ATOL for d in near):
        raise AssertionError(f"parity_tp_7b: a greedy id is {max(near)} "
                             "below the CPU maximum")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"parity_tp_7b: {k} was not launched")
    return launches


TP_RING_PREFILL = 64  # tp_7b's ring engine: buckets of 64+ tokens


def tp_7b_phase(torch) -> dict:
    """Tensor-parallel serving at full depth: the 7B-class model (32
    layers) with int8 "ffn" weights (each copy about 7.4 GB) made on the
    card from a seeded generator, served by ``PagedLLMEngine``
    (``serve_7b``'s 96 pages of 16, 8 slots, max_len 256) inside
    ``LLMComponent`` behind the REST server.  ``serve_7b``'s 8 prompts x 16
    tokens, three times: no mesh, a 1-rank mesh, and a tp = 2 mesh of two
    ranks on cuda:0 (they run one after the other on its stream); each
    engine serves the burst twice, the first capturing its programs, the
    second measured and its ids equal to the first's.

    Gates: the 1-rank ids EQUAL the no-mesh ids.  tp = 2 may leave them
    (w2's input is quantized per row over each rank's hidden shard, as the
    reference's own test expects): each request's first divergence must sit
    at a near-tie of the 1-rank logits (top-2 gap <= ``SPEC_TIE_ATOL``,
    ``spec_7b``'s rule); their count is reported.  One 128-token prompt
    (2 x ``TP_RING_PREFILL``) prefills through ring attention at tp = 2
    (``ring_prefill`` 64), its ids EQUAL to a dense (non-flash, float32
    softmax as the ring's) prefill of the same tp = 2 weights.  A
    speculative tp = 2 engine (``spec_7b``'s 2-layer draft placed on the
    mesh, k_draft 3, 161 pages) serves the 8 prompts and returns every page.
    On a machine of one card ``DemoLLM(tp=2)`` (whose mesh takes the first
    two cards) raises ``MeshPlanError``, as the reference's does on one
    chip.  Reported, not gated: TTFT/TPOT medians and tokens/s per mode,
    peak memory, ``tp_span``.  Returns the launches of the runs."""
    import dataclasses

    from seldon_core_tpu_torch.models.transformer import (
        init_params_int8,
        prefill,
        shard_params,
    )
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM
    from seldon_core_tpu_torch.parallel.mesh import MeshPlanError
    from seldon_core_tpu_torch.runtime.llm import LLMComponent, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig
    from seldon_core_tpu_torch.serving.rest import RestServer

    demo_tp2 = None
    if torch.cuda.device_count() < 2:
        try:
            DemoLLM(tp=2, int8="ffn")
        except MeshPlanError as e:
            demo_tp2 = f"MeshPlanError: {e}"
        else:
            raise AssertionError("tp_7b: DemoLLM(tp=2) built on one card")
    cfg = _cfg_7b(32)
    mesh1, mesh2, _ = _card_meshes(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(6)
    base = init_params_int8(gen, cfg, int8="ffn")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    weights = {"no_mesh": (base, None),
               "tp1": (shard_params(base, mesh1, cfg), mesh1),
               "tp2": (shard_params(base, mesh2, cfg), mesh2)}
    rng = torch.Generator().manual_seed(7)
    lens = [5 + (115 * i) // 7 for i in range(8)]  # serve_7b's prompts
    prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist()
               for n in lens]
    long_prompt = torch.randint(1, 32000, (2 * TP_RING_PREFILL,),
                                generator=rng).tolist()

    def serve(engine, ps, n_new=16):
        comp = LLMComponent(engine, n_new=n_new)

        async def run():
            server = await RestServer(comp, host="127.0.0.1", port=0).start()
            try:
                code, body = await asyncio.to_thread(
                    _post, server.port, {"jsonData": {"prompt_ids": [1, 2, 3],
                                                      "n_new": 2}})
                if code != 200:
                    raise AssertionError(f"tp_7b warm-up: {code} {body}")
                bodies = [{"jsonData": {"prompt_ids": p, "n_new": n_new}}
                          for p in ps]
                # a first burst captures each shape's programs; the
                # second, measured, replays them
                first = await _post_all(server.port, bodies)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t1 = time.perf_counter()
                answers = await _post_all(server.port, bodies)
                wall = time.perf_counter() - t1
                torch.cuda.synchronize()
                return first, answers, wall, read_launches(), t1
            finally:
                await server.stop()

        first, answers, wall, launches, since = asyncio.run(run())
        def ids_of(burst):
            return [b.get("jsonData", {}).get("ids") for _, b in burst]

        if ids_of(first) != ids_of(answers):
            raise AssertionError("tp_7b: a replayed burst's ids differ from "
                                 "the capturing burst's")
        ids = []
        for (code, body), p in zip(answers, ps):
            if code != 200:
                raise AssertionError(f"tp_7b: HTTP {code}: {body}")
            x = body["jsonData"]["ids"]
            if len(x) != len(p) + n_new or x[:len(p)] != p:
                raise AssertionError(f"tp_7b: bad answer {x}")
            ids.append(x)
        log = _latencies(engine, since)
        stats = {"wall_s": wall,
                 "ttft_ms_median": statistics.median(
                     x["ttft_s"] for x in log) * 1e3,
                 "tpot_ms_median": statistics.median(
                     x["tpot_s"] for x in log if x["tpot_s"] is not None)
                 * 1e3,
                 "tokens_per_s": n_new * len(ps) / wall,
                 "peak_device_bytes": torch.cuda.max_memory_allocated(),
                 "launches": launches}
        return ids, stats

    paged = PagedConfig(n_pages=96, page_size=16)
    out = {"phase": "tp_7b",
           "model": "L32 d4096 H32/Hkv8 ff16384 V32000 bf16 int8-ffn flash",
           "engine": "PagedLLMEngine 96x16 pages, 8 slots, max_len 256",
           "prompt_lens": lens, "n_new": 16, "weights_init_s": t_init,
           "demo_llm_tp2_on_one_card": demo_tp2, "card": CARD}
    ids_by, total = {}, {}
    for mode, (params, mesh) in weights.items():
        engine = PagedLLMEngine(params, cfg, paged, max_slots=8, max_len=256,
                                mesh=mesh)
        ids_by[mode], out[mode] = serve(engine, prompts)
        total[mode] = out[mode]["launches"]
        if engine.free_pages != paged.n_pages - 1:
            raise AssertionError(f"tp_7b {mode}: pages not returned")
        out[mode]["graphs"] = engine.program_stats()["graphs"]
        if mode == "tp2":
            out["tp_span"] = engine.tp_span()
            TP_7B.update(out[mode])
        engine.close()
    if ids_by["tp1"] != ids_by["no_mesh"]:
        emit(out)
        raise AssertionError("tp_7b: the 1-rank mesh's ids differ from the "
                             "no-mesh ids")
    # tp = 2 against tp = 1: the first divergence at a near-tie only
    near, firsts = [], []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            one, two = ids_by["tp1"][i], ids_by["tp2"][i]
            diff = [j for j in range(len(p), len(one)) if one[j] != two[j]]
            firsts.append((diff[0] if diff else len(one)) - len(p))
            if not diff:
                continue
            logits, _ = prefill(base, torch.tensor([one], device="cuda"),
                                cfg, max_len=len(one))
            top = logits[0, diff[0] - 1].topk(2).values.float().cpu()
            gap = float(top[0] - top[1])
            near.append({"request": i, "position": diff[0] - len(p),
                         "tp1_top2_gap": gap})
    out.update(tp2_tokens_equal_tp1_before_first_difference=firsts,
               tp2_divergences=near, tp2_divergence_count=len(near),
               tie_rule=f"tp1 top-2 gap <= {SPEC_TIE_ATOL}")
    if any(d["tp1_top2_gap"] > SPEC_TIE_ATOL for d in near):
        emit(out)
        raise AssertionError(f"tp_7b: tp = 2 leaves tp = 1 away from a "
                             f"near-tie: {near}")
    p2 = weights["tp2"][0]
    del weights
    # ring prefill of one long prompt against a dense prefill, tp = 2
    ring = PagedLLMEngine(p2, cfg, paged, max_slots=8, max_len=256,
                          mesh=mesh2, ring_prefill=TP_RING_PREFILL)
    if not ring._ring_eligible(len(long_prompt)):
        raise AssertionError("tp_7b: the long prompt is not ring-eligible")
    ring_ids, out["ring"] = serve(ring, [long_prompt])
    out["ring"]["programs"] = sorted(ring.program_stats()["programs"])
    ring.close()
    if "ring_prefill" not in out["ring"]["programs"]:
        raise AssertionError("tp_7b: no ring prefill program ran")
    dense = PagedLLMEngine(p2, dataclasses.replace(cfg, use_flash=False),
                           paged, max_slots=8, max_len=256, mesh=mesh2)
    dense_ids, out["dense_reference"] = serve(dense, [long_prompt])
    dense.close()
    out["ring_prompt_len"] = len(long_prompt)
    out["ring_ids_equal_dense"] = ring_ids == dense_ids
    total["ring"] = out["ring"]["launches"]
    if ring_ids != dense_ids:
        emit(out)
        raise AssertionError("tp_7b: ring prefill ids differ from dense")
    # speculative tp = 2 with a small draft placed on the mesh
    d_params, d_cfg = _draft_small(torch)
    spec_paged = PagedConfig(n_pages=161, page_size=16)
    spec = PagedLLMEngine(p2, cfg, spec_paged, max_slots=8, max_len=256,
                          mesh=mesh2,
                          draft_params=shard_params(d_params, mesh2, d_cfg),
                          draft_cfg=d_cfg, k_draft=3)
    _, out["spec"] = serve(spec, prompts)
    out["spec"]["spec_stats"] = dict(spec.spec_stats)
    out["spec"]["free_pages"] = spec.free_pages
    spec.close()
    total["spec"] = out["spec"]["launches"]
    emit(out)
    if out["spec"]["free_pages"] != spec_paged.n_pages - 1:
        raise AssertionError(f"tp_7b: the speculative engine kept pages "
                             f"({out['spec']['free_pages']} free)")
    if out["spec"]["spec_stats"]["rounds"] < 1:
        raise AssertionError("tp_7b: no speculative round ran")
    for k, n in total["tp2"].items():
        if n <= 0:
            raise AssertionError(f"tp_7b tp2: {k} was not launched")
    del p2, d_params, base
    torch.cuda.empty_cache()
    return {k: sum(t[k] for t in total.values()) for k in total["tp2"]}


# ----------------------------------------------------------------------
# slice 6b: the placement plane
# ----------------------------------------------------------------------

#: batch sizes of ``placement_resnet50`` (batch 1 pads to 2 under dp = 2)
PLACEMENT_BATCHES = (1, 8, 64)
#: sequential requests per engine and batch size in its p50
PLACEMENT_REPS = 10


def _same_payload(a, b) -> bool:
    """``_same_answer`` less the ``artifact-source`` tag, which only an
    engine with an artifact plane stamps."""
    for m in (a, b):
        m.meta.tags.pop("artifact-source", None)
    return _same_answer(a, b)


def _mnist_on_mesh(torch, model: str, n_devices: int, tp: int,
                   device: str) -> dict:
    """``model`` (``mlp:...``, seeded weights on ``device``) fused behind a
    placement plane over ``n_devices`` ranks of ``device`` at ``tp``, an
    unsharded fused engine and a walk over the same component: batches of
    2, 4 and 8 rows, every answer bitwise equal across the three."""
    import numpy as np

    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.operator.local import resolve_component
    from seldon_core_tpu_torch.parallel.mesh import make_mesh
    from seldon_core_tpu_torch.placement import (
        PlacementConfig,
        PlacementPlane,
    )

    spec = {"name": "clf", "type": "MODEL", "parameters": [{
        "name": "model_class", "type": "STRING",
        "value": f"seldon_core_tpu_torch.models.{model}"}]}
    comps: dict = {}

    def resolve(u):
        if u.name not in comps:
            comps[u.name] = resolve_component(
                u, {"seldon.io/batching": "false"}, device)
        return comps[u.name]

    plane = PlacementPlane(
        PlacementConfig(enabled=True, dp=n_devices // tp, tp=tp),
        mesh=make_mesh(devices=[device] * n_devices, tp=tp))
    sharded = GraphEngine(spec, resolver=resolve, name="p",
                          plan_mode="fused", placement=plane)
    fused = GraphEngine(spec, resolver=resolve, name="p", plan_mode="fused")
    walk = GraphEngine(spec, resolver=resolve, name="p")
    seg = sharded.plan.segments[0]
    equal = {}
    for n in (2, 4, 8):
        x = np.random.RandomState(n).uniform(size=(n, 784)).astype(
            np.float32)
        a, b, c = (asyncio.run(e.predict(_pinned(x)))
                   for e in (sharded, fused, walk))
        equal[n] = _same_answer(a, b) and _same_answer(a, c)
    return {"mesh": plane.mesh_shape(), "shard_parity": seg.shard_parity,
            "sharded_segments": plane.sharded_segments,
            "buckets": {"x".join(map(str, k[0])): v["parity"]
                        for k, v in seg.shard_cost_by_bucket.items()},
            "sharded_calls": seg.n_sharded_calls,
            "equal_fused_and_walk": equal,
            "shardedParamBytes": seg.tp_sharded_param_bytes,
            "tpBytesPerDevice": seg.tp_bytes_per_device,
            "describe": seg.describe()}


def placement_resnet50_phase(torch) -> dict:
    """The placement plane on the one card.

    (1) The int8 ResNet50 of ``resnet50-int8.json`` (BASELINE config 3,
    full width, ``wire_resnet``'s seeds) fused with batching on, behind an
    explicit ``PlacementPlane`` at dp = 2 over ``[cuda:0, cuda:0]`` and a
    fresh artifact store, beside the unsharded fused ``LocalDeployment``
    and a walk over the same components.  Batches of 1 (padded to 2 by
    ``shard_rows``), 8 and 64: every answer bitwise equal across the three.
    Reported: the probe's and each bucket's verdict, K1 launches of one
    sharded forward (2 x 37: each rank's row block) against one unsharded
    (37), and p50 ms of ``PLACEMENT_REPS`` sequential requests per batch
    size, unsharded / sharded / sharded / unsharded (the split's overhead
    on one card, not dp's gain).  (2) ``MNISTMLPClassifier`` at tp = 2 and
    dp = 2,tp = 2 over 2 and 4 ranks of cuda:0: ids EQUAL fused and walk at
    batches 2, 4 and 8, ``tpBytesPerDevice`` measured from the pieces;
    ``MNISTMLP`` at tp = 2 verified, or disarmed with answers still equal.
    (3) The engine's ``/admin/placement`` over REST answers 200 with every
    segment; the placement probe reads ``torch.cuda.memory_stats``; a
    second engine on the store captures the published sharded buckets at
    boot and answers EQUAL without a live capture.  (4) A
    ``LocalDeployment`` of ``iris.json`` with ``seldon.io/mesh: dp=2`` on
    the one card disables its plane with the warning, answers 404 at
    ``/admin/placement`` and serves the unsharded plan's answers.  Returns
    the launches of (1)'s requests."""
    import logging
    import tempfile

    import numpy as np

    from seldon_core_tpu_torch.artifacts import ArtifactConfig, ArtifactPlane
    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.health import placement_probe
    from seldon_core_tpu_torch.operator.local import (
        LocalDeployment,
        _batcher_config,
    )
    from seldon_core_tpu_torch.parallel.mesh import make_mesh
    from seldon_core_tpu_torch.placement import (
        PlacementPlane,
        placement_config_from_annotations,
    )
    from seldon_core_tpu_torch.serving.rest import RestServer
    from seldon_core_tpu_torch.utils.metrics import MetricsRegistry

    out = {"phase": "placement_resnet50", "card": CARD}
    d = _resnet_graph(True, {"seldon.io/graph-plan": "fused"})
    graph, ann = d["spec"]["predictors"][0]["graph"], d["spec"]["annotations"]
    t0 = time.perf_counter()
    local = LocalDeployment(load_deployment(d), seed=0)
    fused = local.engine
    out["boot_s"] = time.perf_counter() - t0
    useg = fused.plan.segments[0]
    # two ranks of the card (of the CPU in a rehearsal without one)
    rank = "cuda:0" if useg.device.type == "cuda" else "cpu"
    row = tuple(fused.node_impl("resnet").handle.user.input_shape)
    rng = np.random.default_rng(17)
    batches = {b: rng.integers(0, 256, (b,) + row).astype(np.float32)
               for b in PLACEMENT_BATCHES}

    def bucket(rows: int) -> str:
        return "x".join(map(str, (rows,) + row))

    walk = GraphEngine(graph, name="main",
                       resolver=lambda u, e=fused: e.node_impl(u.name))
    cfg = placement_config_from_annotations({"seldon.io/mesh": "dp=2"})
    mesh = make_mesh(devices=[rank, rank], tp=1)
    store = tempfile.TemporaryDirectory(prefix="placement-store-")

    def sharded_engine():
        plane = PlacementPlane(cfg, mesh=mesh, deployment="placement")
        art = ArtifactPlane(ArtifactConfig(enabled=True, store=store.name))
        eng = GraphEngine(graph, name="main",
                          resolver=lambda u, e=fused: e.node_impl(u.name),
                          plan_mode="fused", plan_batcher=_batcher_config(ann),
                          placement=plane, artifacts=art)
        return eng, plane, art

    t0 = time.perf_counter()
    sharded, plane, art = sharded_engine()
    out["arm_s"] = time.perf_counter() - t0
    seg = sharded.plan.segments[0]
    out["shard_parity"] = seg.shard_parity
    out["sharded_segments"] = list(plane.sharded_segments)
    out["shard_rows"] = seg.batcher.config.shard_rows

    reset_launches()
    equal, first = {}, {}
    for b, x in batches.items():
        a = asyncio.run(sharded.predict(_pinned(x)))
        first[b] = a
        b_, c_ = (asyncio.run(e.predict(_pinned(x))) for e in (fused, walk))
        equal[b] = _same_payload(a, b_) and _same_payload(a, c_)
    launches = read_launches()
    out["equal_unsharded_and_walk"] = equal
    out["bucket_parity"] = {"x".join(map(str, k[0])): v["parity"]
                            for k, v in seg.shard_cost_by_bucket.items()}
    out["sharded_calls"] = seg.n_sharded_calls
    out["k1_launches_requests"] = launches["int8_matmul"]

    # K1 per forward of each bucket: a verified one replays both ranks'
    # blocks, a failed one the unsharded forward; and one eager sharded run
    def k1_of(fn, x) -> int:
        fn(x)  # a bucket's first sight captures it: count a replay
        torch.cuda.synchronize()
        reset_launches()
        fn(x)
        torch.cuda.synchronize()
        return read_launches()["int8_matmul"]

    xs = {rows: torch.from_numpy(np.repeat(batches[1], rows, axis=0)
                                 if rows == 2 else batches[rows]).to(
        useg.device) for rows in (2, 8, 64)}
    out["k1_per_forward"] = {bucket(r): {"sharded": k1_of(seg, x),
                                         "unsharded": k1_of(useg, x)}
                             for r, x in xs.items()}
    with torch.inference_mode():
        out["k1_per_forward"]["sharded_eager"] = k1_of(seg._run_sharded,
                                                       xs[8])

    # p50 of sequential requests, unsharded / sharded / sharded / unsharded
    async def p50(eng, x):
        ms = []
        for _ in range(PLACEMENT_REPS):
            t = time.perf_counter()
            await eng.predict(_pinned(x))
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)

    out["p50_ms"] = {
        str(b): {mode: asyncio.run(p50(eng, x)) for mode, eng in (
            ("unsharded", fused), ("sharded", sharded),
            ("sharded_again", sharded), ("unsharded_again", fused))}
        for b, x in batches.items()}
    out["p50_note"] = ("host ms per request through the engine (batcher "
                       "window, H2D, forward, D2H); sequential; the "
                       "sharded engine pads batch 1 to 2 rows")

    # (3) the surfaces: REST, the probe, a warm engine from the store
    async def admin(eng):
        srv = await RestServer(eng, host="127.0.0.1", port=0).start()
        try:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, _get, srv.port,
                                              "/admin/placement")
        finally:
            await srv.stop()

    st, body = asyncio.run(admin(sharded))
    body = json.loads(body)
    out["admin_placement"] = {
        "status": st, "segments": [s["segment"] for s in body["segments"]],
        "shardedSegments": body.get("shardedSegments"),
        "shardedDispatches": body.get("shardedDispatches"),
        "devicesVisible": body.get("devicesVisible")}
    reg = MetricsRegistry()
    sample = placement_probe(plane, metrics=reg)()
    allocated = (torch.cuda.memory_stats(rank)["allocated_bytes.all.current"]
                 if rank != "cpu" else 0)
    out["probe"] = {**sample, "allocated_bytes_now": allocated,
                    "gauge_rendered":
                        'seldon_runtime_placement_device_bytes{device="0"}'
                        in reg.render()}
    out["artifacts_cold"] = {k: art.snapshot()[k] for k in (
        "published", "liveCompiles", "parityFailures")}
    t0 = time.perf_counter()
    warm, _, warm_art = sharded_engine()
    out["warm_boot_s"] = time.perf_counter() - t0
    wseg = warm.plan.segments[0]
    out["warm_shard_hydrated"] = sorted("x".join(map(str, k[0]))
                                        for k in wseg.shard_hydrated)
    verified = [b for b, v in out["bucket_parity"].items() if v == "verified"]
    warm_equal = {}
    for b, x in batches.items():
        warm_equal[b] = _same_payload(
            asyncio.run(warm.predict(_pinned(x))), first[b])
    out["warm_equal"] = warm_equal
    out["artifacts_warm"] = {k: warm_art.snapshot()[k] for k in (
        "hydrated", "liveCompiles")}

    # (2) the MNIST classifier over tp spans of cuda:0
    out["mnist"] = {
        "clf_tp2": _mnist_on_mesh(torch, "mlp:MNISTMLPClassifier", 2, 2,
                                  rank),
        "clf_dp2tp2": _mnist_on_mesh(torch, "mlp:MNISTMLPClassifier", 4, 2,
                                     rank),
        "mlp_tp2": _mnist_on_mesh(torch, "mlp:MNISTMLP", 2, 2, rank)}

    # (4) the refusal path: dp = 2 wants two cards
    iris = json.loads((ROOT / "seldon_core_tpu_torch" / "examples"
                       / "iris.json").read_text())
    iris["spec"].setdefault("annotations", {}).update(
        {"seldon.io/graph-plan": "fused"})
    warned = []

    class _Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    catch = _Catch(level=logging.WARNING)
    logger = logging.getLogger("seldon_core_tpu_torch.operator.local")
    logger.addHandler(catch)
    try:
        meshed = json.loads(json.dumps(iris))
        meshed["spec"]["annotations"]["seldon.io/mesh"] = "dp=2"
        refused = LocalDeployment(load_deployment(meshed), seed=0)
    finally:
        logger.removeHandler(catch)
    plain = LocalDeployment(load_deployment(iris), seed=0)
    xi = np.random.RandomState(0).uniform(size=(8, 4)).astype(np.float32)
    st404, _ = asyncio.run(admin(refused))
    out["refusal"] = {
        "plane": refused.placement is not None, "status": st404,
        "warning": [w for w in warned if "placement plane disabled" in w],
        "equal_unsharded": _same_answer(
            asyncio.run(refused.predict(_pinned(xi))),
            asyncio.run(plain.predict(_pinned(xi))))}
    emit(out)

    mn = out["mnist"]
    problems = []
    if not all(equal.values()) or not all(warm_equal.values()):
        problems.append("an answer differs")
    if out["shard_parity"] not in ("verified", "failed"):
        problems.append(f"probe verdict {out['shard_parity']}")
    if out["shard_parity"] == "verified" and (
            set(out["bucket_parity"]) != {bucket(2), bucket(8),
                                          bucket(64)}):
        problems.append(f"buckets gated: {out['bucket_parity']}")
    if out["shard_rows"] != (2 if out["shard_parity"] == "verified" else 1):
        problems.append(f"shard_rows {out['shard_rows']}")
    for r in (2, 8, 64):
        want = 2 * 37 if out["bucket_parity"].get(bucket(r)) == \
            "verified" else 37
        if out["k1_per_forward"][bucket(r)] != {"sharded": want,
                                                "unsharded": 37}:
            problems.append(f"K1 per forward {out['k1_per_forward']}")
    if out["k1_per_forward"]["sharded_eager"] != 2 * 37:
        problems.append("an eager sharded forward is not 2 x 37 K1")
    if out["k1_launches_requests"] <= 0:
        problems.append("no K1 launch")
    if st != 200 or out["admin_placement"]["segments"] != [seg.name]:
        problems.append(f"/admin/placement {st}")
    if not (sample["placement_devices"] == 2.0
            and sample["placement_device_bytes_max"] > 0
            and out["probe"]["gauge_rendered"]):  # device "0": the card
        problems.append(f"probe {sample}")
    if verified and (out["warm_shard_hydrated"] != sorted(verified)
                     or out["artifacts_warm"]["liveCompiles"] != 0):
        problems.append("the warm engine did not take the stored buckets")
    for name in ("clf_tp2", "clf_dp2tp2"):
        m = mn[name]
        if not (m["shard_parity"] == "verified"
                and all(m["equal_fused_and_walk"].values())
                and m["tpBytesPerDevice"] == m["shardedParamBytes"] // 2
                and m["tpBytesPerDevice"] > 0):
            problems.append(f"{name}: {m}")
    if not all(mn["mlp_tp2"]["equal_fused_and_walk"].values()):
        problems.append("mlp_tp2 answers differ")
    if mn["mlp_tp2"]["shard_parity"] not in ("verified", "failed"):
        problems.append(f"mlp_tp2 {mn['mlp_tp2']['shard_parity']}")
    r = out["refusal"]
    if r["plane"] or r["status"] != 404 or not r["warning"] \
            or not r["equal_unsharded"]:
        problems.append(f"refusal {r}")
    if problems:
        raise AssertionError(f"placement_resnet50: {problems}")
    store.cleanup()
    del local, fused, walk, sharded, warm, seg, useg, wseg, xs
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# the BASELINE graphs
# ----------------------------------------------------------------------

def _post_timed(port: int, body: dict, path: str = "/api/v0.1/predictions"
                ) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    return code, out, time.perf_counter() - t0


def _randomize_resnet(torch, module, seed: int) -> None:
    """Random BN scale, bias, mean and var (var > 0) from a numpy seed, and
    the head scaled so the 1000 logits spread over a few units (std about
    3.6 on 0-255 images) instead of saturating the softmax.  A seeded
    ResNet's last BN of each bottleneck has scale 0: its c3 branch, and 16
    of the 37 K1 launches, would be exactly zero and prove nothing."""
    import numpy as np

    from seldon_core_tpu_torch.models.resnet import _BatchNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _BatchNorm):
                c = m.scale.shape[0]
                for name, a in (("scale", rng.uniform(0.5, 1.5, c)),
                                ("bias", rng.normal(0.0, 0.2, c)),
                                ("mean", rng.normal(0.0, 0.2, c)),
                                ("var", rng.uniform(0.5, 2.0, c))):
                    getattr(m, name).copy_(torch.from_numpy(a))
        module.head_w.mul_(0.02)


# ResNet50 card vs CPU at batch 4: (atol on every probability, rtol on the
# CPU path's five largest), per dtype
RESNET_PARITY_TOL = {"bf16": (0.005, 0.05), "int8": (0.01, 0.1)}


def _agree(card, cpu) -> tuple[int, int]:
    """Top-1 ids that agree (the card's id attains the CPU maximum, so an
    exact tie admits each tied id) and that are equal by index."""
    at = cpu.gather(-1, card.argmax(-1)[:, None])[:, 0]
    return (int((at == cpu.max(-1).values).sum()),
            int((card.argmax(-1) == cpu.argmax(-1)).sum()))


def resnet50_phase(torch) -> int:
    """Full ResNet50, float (bf16 convs on cuDNN) and int8 (1x1 convs and
    head on K1): in-process forwards, parity with the CPU plain path, and
    REST through the batcher.  Returns K1's launches in the int8 REST
    run."""
    import copy

    import numpy as np

    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models import resnet, resnet_int8
    from seldon_core_tpu_torch.operator.local import serve

    fm = resnet.ResNet50Model(seed=0)
    _randomize_resnet(torch, fm.module, seed=5)
    qm = resnet_int8.Int8ResNet50Model(source=fm)
    models = {"bf16": fm.module,
              "int8": lambda x: resnet_int8.forward(qm.weights, x)}
    gen = torch.Generator(device="cuda").manual_seed(9)

    # 1. in-process forwards on a device tensor
    out = {"phase": "resnet50",
           "model": "ResNet50 (3, 4, 6, 3), 224x224x3, 1000 classes, bf16; "
                    "int8: BN folded, 1x1 convs and head on K1",
           "card": CARD}
    for label, fwd in models.items():
        per = {}
        for B in (1, 8, 64):
            x = torch.rand((B, 224, 224, 3), generator=gen,
                           device="cuda") * 255
            with torch.inference_mode():
                fwd(x)
                torch.cuda.synchronize()
                reset_launches()
                y = fwd(x)
                torch.cuda.synchronize()
                k1 = read_launches()["int8_matmul"]
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    fwd(x)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                peak = torch.cuda.max_memory_allocated()
            ms = statistics.median(times)
            ok = (tuple(y.shape) == (B, 1000) and bool(torch.isfinite(y).all())
                  and abs(y.sum(-1) - 1).max().item() < 1e-3)
            per[B] = {"ms_per_batch": ms, "images_per_s": B / ms * 1e3,
                      "k1_launches_per_forward": k1,
                      "peak_device_bytes": peak, "output_ok": ok}
            want = 37 if label == "int8" else 0
            if k1 != want or not ok:
                emit({**out, label: per})
                raise AssertionError(f"resnet50 {label} B{B}: K1 launches "
                                     f"{k1} (want {want}), output ok {ok}")
        out[label] = per
        # where the device time of one batch-64 forward goes
        with torch.inference_mode():
            by_name = _device_ms_by_kernel(torch, lambda: fwd(x), 3)
        total = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[label]["b64_device_ms"] = total
        out[label]["b64_top_kernels"] = [{"name": n[:100], "ms": v}
                                         for n, v in top]
        if label == "int8" and total:
            split = _k1_split(by_name)
            out[label]["b64_k1"] = {**split, "share": (
                split["quantize_ms"] + split["product_ms"]) / total}
        del x, y

    # 2. parity: the card against the same weights on the CPU
    x = (torch.rand((4, 224, 224, 3), generator=torch.Generator()
                    .manual_seed(3)) * 255).round()
    cpu_float = copy.deepcopy(fm.module).to("cpu")
    cpu_int8 = _to_device(qm.weights, "cpu")
    parity = {}
    with torch.inference_mode():
        pairs = {"bf16": (fm.module(x.cuda()), cpu_float(x)),
                 "int8": (models["int8"](x.cuda()),
                          resnet_int8.forward(cpu_int8, x))}
    for label, (card, cpu) in pairs.items():
        card = card.float().cpu()
        agree, equal = _agree(card, cpu)
        top5 = cpu.topk(5, dim=-1)
        rel = ((card.gather(-1, top5.indices) - top5.values).abs()
               / top5.values)
        parity[label] = {"max_abs_err": (card - cpu).abs().max().item(),
                         "top5_max_rel_err": rel.max().item(),
                         "top1_agree": agree, "top1_equal_index": equal,
                         "cpu_top2_prob_gap": (top5.values[:, 0]
                                               - top5.values[:, 1]).tolist(),
                         "tolerance": RESNET_PARITY_TOL[label]}
    out["parity"] = {"batch": 4,
                     "compare": "card vs CPU plain path, same weights",
                     **parity}
    emit(out)
    for label, p in parity.items():
        atol, rtol = RESNET_PARITY_TOL[label]
        if (p["max_abs_err"] > atol or p["top5_max_rel_err"] > rtol
                or p["top1_agree"] != 4):
            raise AssertionError(f"resnet50 parity {label}: {p}")

    # 3. REST: 16 concurrent single-image requests per graph
    imgs = np.random.default_rng(7).integers(0, 256, (16, 224, 224, 3))
    bodies = [{"data": {"ndarray": imgs[i:i + 1].tolist()}}
              for i in range(16)]
    rest, k1_rest = {}, 0
    for name in ("resnet50-int8", "resnet50"):
        graph = ROOT / "seldon_core_tpu_torch" / "examples" / f"{name}.json"

        async def run():
            # the runner's boot (weights, every bucket warmed on the card),
            # then the burst is the first traffic the server sees
            reset_launches()
            t0 = time.perf_counter()
            server, local = await serve(str(graph), port=0, host="127.0.0.1")
            boot = time.perf_counter() - t0
            try:
                batched = local.engine.node_impl(name)
                # the warm-up ran every bucket on the card: 37 K1 launches
                # per bucket for the int8 model
                boot_k1 = read_launches()["int8_matmul"]
                want = 37 * len(batched._batcher.buckets) if "int8" in name \
                    else 0
                if boot_k1 != want:
                    raise AssertionError(f"{name} boot: K1 launches "
                                         f"{boot_k1}, want {want}")
                comp = batched.handle
                if name == "resnet50":  # the weights of the phases above
                    comp.user.module = fm.module
                else:
                    comp.user.weights = qm.weights
                reset_launches()
                before = dict(batched._batcher.stats)
                t0 = time.perf_counter()
                answers = await _in_threads(
                    _post_timed, [(server.port, b) for b in bodies])
                wall = time.perf_counter() - t0
                k1 = read_launches()["int8_matmul"]
                stats = {k: v - before[k]
                         for k, v in batched._batcher.stats.items()}
                ref = comp.predict(SeldonMessage.from_ndarray(imgs)
                                   ).data.float().cpu()
                return answers, (boot, boot_k1), wall, k1, stats, ref
            finally:
                await server.stop()

        answers, (boot, boot_k1), wall, k1, stats, ref = asyncio.run(run())
        lat = sorted(a[2] * 1e3 for a in answers)
        bad = [a for a in answers if a[0] != 200]
        if bad:
            raise AssertionError(f"{name}: {len(bad)} of 16 failed, HTTP "
                                 f"{bad[0][0]}: {bad[0][1]}")
        ids = [int(np.argmax(a[1]["data"]["ndarray"][0])) for a in answers]
        same = sum(i == int(r) for i, r in zip(ids, ref.argmax(-1)))
        rest[name] = {"requests": 16, "boot_s": boot,
                      "boot_k1_launches": boot_k1, "wall_s": wall,
                      "p50_ms": statistics.median(lat),
                      "p95_ms": lat[int(0.95 * (len(lat) - 1) + 0.5)],
                      "batches": stats["batches"], "rows": stats["rows"],
                      "pad_rows": stats["pad_rows"], "shed": stats["shed"],
                      "k1_launches": k1,
                      "top1_equal_in_process": same}
        if name == "resnet50-int8":
            k1_rest = k1
        emit({"phase": "resnet50_rest", "graph": name, **rest[name],
              "card": CARD})
    for name, r in rest.items():
        if r["top1_equal_in_process"] != 16:
            raise AssertionError(f"resnet50 REST {name}: top-1 {r}")
    if k1_rest <= 0 or k1_rest % 37:
        raise AssertionError(f"resnet50-int8 REST: K1 launches {k1_rest}")
    return k1_rest


GRAPHS = ["iris", "mnist", "epsilon-greedy-mab", "ensemble",
          "iris-with-outlier"]


def _graph_requests(name: str) -> list:
    import numpy as np

    rng = np.random.default_rng(len(name))
    if name.startswith("iris"):
        rows = [rng.normal([5.8, 3.0, 3.8, 1.2], 0.8, (n, 4))
                for n in (3, 1, 4, 2, 6, 1)]
        rows.append(np.full((1, 4), 30.0))  # an outlier
    else:
        rows = [rng.normal(size=(n, 784)) for n in (2, 1, 3, 8)]
    return [{"data": {"ndarray": r.tolist()}} for r in rows]


def graphs_phase(torch) -> None:
    """Each BASELINE graph served on the card over REST, held to the same
    graph on the CPU with the card's weights: status, names and meta
    (requestPath, routing, tags with the outlier scores) equal, argmax ids
    equal, probabilities within atol 1e-5 (float32 on both)."""
    import numpy as np

    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.messages import Feedback, SeldonMessage
    from seldon_core_tpu_torch.operator.local import LocalDeployment, serve

    def compare(t: dict, c: dict) -> float:
        tm, cm = dict(t["meta"]), dict(c["meta"])
        tm.pop("puid"), cm.pop("puid")
        if t["status"] != c["status"] or tm != cm or \
                t["data"]["names"] != c["data"]["names"]:
            raise AssertionError(f"graphs: card {t['meta']} / {t['status']}"
                                 f" vs CPU {c['meta']} / {c['status']}")
        tv = np.asarray(t["data"]["ndarray"], np.float64)
        cv = np.asarray(c["data"]["ndarray"], np.float64)
        if tv.shape != cv.shape or not (tv.argmax(-1) == cv.argmax(-1)).all():
            raise AssertionError(f"graphs: ids differ {tv.shape} {cv.shape}")
        return float(np.abs(tv - cv).max())

    for name in GRAPHS:
        d = json.loads((ROOT / "seldon_core_tpu_torch" / "examples"
                        / f"{name}.json").read_text())
        if name == "epsilon-greedy-mab":
            d["spec"]["predictors"][0]["graph"]["parameters"].append(
                {"name": "seed", "value": "11", "type": "INT"})

        async def run():
            server, card = await serve(d, port=0, host="127.0.0.1")
            cpu = LocalDeployment(load_deployment(d), device="cpu")
            try:
                for unit in card.spec.graph.walk():
                    if unit.resolved_type == "MODEL":
                        cpu.engine.node_impl(unit.name).user.params = \
                            _to_device(card.engine.node_impl(unit.name)
                                       .user.params, "cpu")
                errs, lat, routes = [], [], []

                async def both(body):
                    code, t, dt = await asyncio.to_thread(_post_timed,
                                                          server.port, body)
                    if code != 200:
                        raise AssertionError(f"{name}: HTTP {code}: {t}")
                    c = (await cpu.predict(SeldonMessage.from_dict(body))
                         ).to_dict()
                    errs.append(compare(t, c))
                    lat.append(dt * 1e3)
                    return t

                for body in _graph_requests(name):
                    t = await both(body)
                moved = None
                if name == "epsilon-greedy-mab":
                    taken = t["meta"]["routing"]["eg-router"]
                    fb = {"response": {"meta": {"routing": {
                        "eg-router": 1 - taken}}}, "reward": 1.0}
                    for _ in range(3):
                        code, res, _ = await asyncio.to_thread(
                            _post_timed, server.port, fb,
                            "/api/v0.1/feedback")
                        if code != 200:
                            raise AssertionError(f"feedback: {code} {res}")
                        await cpu.send_feedback(Feedback.from_dict(fb))
                    for body in _graph_requests(name):
                        t = await both(body)
                        routes.append(t["meta"]["routing"]["eg-router"])
                    moved = routes.count(1 - taken)
                    if moved < len(routes) // 2:
                        raise AssertionError(f"mab: routing did not move "
                                             f"{routes}")
                return errs, lat, moved
            finally:
                await server.stop()

        errs, lat, moved = asyncio.run(run())
        line = {"phase": "graphs", "graph": name, "requests": len(errs),
                "meta_ids_equal_cpu": True, "max_abs_err": max(errs),
                "tolerance": "atol 1e-5", "p50_ms": statistics.median(lat),
                "card": CARD}
        if moved is not None:
            line["routed_to_rewarded_branch"] = moved
        emit(line)
        if max(errs) > 1e-5:
            raise AssertionError(f"graphs {name}: error {max(errs)}")
    persistence_round_trip()


def persistence_round_trip() -> None:
    """The MAB router (epsilon 0: its routing is then a function of its
    state) and the outlier detector served on the card take traffic (and
    the router REST feedback rewarding branch 1); ``PersistenceManager``
    pushes their state to a ``FileStateStore`` in a temporary directory; a
    fresh runner restores it and answers the same probe requests as the
    first: routing and outlier scores equal, outputs within atol 1e-5."""
    import tempfile

    import numpy as np

    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.runtime.persistence import (
        FileStateStore,
        PersistenceManager,
        persistence_key,
    )

    with tempfile.TemporaryDirectory() as root:
        store = FileStateStore(root)
        for name, unit in (("epsilon-greedy-mab", "eg-router"),
                           ("iris-with-outlier", "outlier-detector")):
            d = json.loads((ROOT / "seldon_core_tpu_torch" / "examples"
                            / f"{name}.json").read_text())
            for prm in d["spec"]["predictors"][0]["graph"]["parameters"]:
                if prm["name"] == "epsilon":
                    prm["value"] = "0.0"
            key = persistence_key(d["spec"]["name"], "main", unit)
            bodies = _graph_requests(name)

            async def answers(port):
                outs = []
                for b in bodies:
                    code, o, _ = await asyncio.to_thread(_post_timed, port, b)
                    if code != 200:
                        raise AssertionError(f"persistence {name}: {o}")
                    o["meta"].pop("puid")
                    outs.append(o)
                return outs

            async def run():
                server, first = await serve(d, port=0, host="127.0.0.1")
                try:
                    await answers(server.port)  # traffic
                    if unit == "eg-router":
                        fb = {"response": {"meta": {"routing": {unit: 1}}},
                              "reward": 1.0}
                        for _ in range(3):
                            code, res, _ = await asyncio.to_thread(
                                _post_timed, server.port, fb,
                                "/api/v0.1/feedback")
                            if code != 200:
                                raise AssertionError(f"feedback: {res}")
                    PersistenceManager(first.engine.node_impl(unit).user,
                                       store, key).push()
                    want = await answers(server.port)
                finally:
                    await server.stop()
                server, second = await serve(d, port=0, host="127.0.0.1")
                try:
                    if not PersistenceManager(
                            second.engine.node_impl(unit).user, store,
                            key).restore():
                        raise AssertionError(f"persistence {name}: no state")
                    return want, await answers(server.port), \
                        second.engine.node_impl(unit).user.get_state()
                finally:
                    await server.stop()

            want, got, state = asyncio.run(run())
            err = 0.0
            for w, g in zip(want, got):
                wv = np.asarray(w["data"]["ndarray"], np.float64)
                gv = np.asarray(g["data"]["ndarray"], np.float64)
                err = max(err, float(np.abs(wv - gv).max()))
                if w["meta"] != g["meta"] or w["status"] != g["status"] or \
                        not (wv.argmax(-1) == gv.argmax(-1)).all():
                    raise AssertionError(f"persistence {name}: restored "
                                         f"{g['meta']} vs {w['meta']}")
            emit({"phase": "graphs", "graph": name,
                  "persistence": "FileStateStore push, fresh runner restore",
                  "probes": len(want), "meta_equal": True,
                  "max_abs_err": err, "tolerance": "atol 1e-5",
                  "restored_state": {k: np.asarray(v).tolist()
                                     for k, v in state.items()
                                     if np.asarray(v).size <= 8},
                  "card": CARD})
            if err > 1e-5:
                raise AssertionError(f"persistence {name}: error {err}")


# ----------------------------------------------------------------------
# the wire tiers: components in processes of their own (slice 4a-i)
# ----------------------------------------------------------------------

WIRE_DIR = ROOT / "build" / "wire"
CHILDREN: list = []  # every process started, reaped at exit


class Child:
    """A subprocess of this script: its merged output is read by a thread
    (so its pipe never fills); ``wait_for`` returns the first line holding
    ``marker``.  ``stop`` sends SIGTERM, then kills after 30 s."""

    def __init__(self, cmd: list, env: dict = None, label: str = ""):
        import os
        import threading

        self.label = label or cmd[-1]
        self.lines: list = []
        self._cv = threading.Condition()
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT),
                                **(env or {})},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        CHILDREN.append(self)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self.lines.append(None)  # end of output
            self._cv.notify_all()

    def wait_for(self, marker: str, timeout: float = 600) -> str:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for ln in self.lines:
                    if ln is None:
                        raise AssertionError(
                            f"{self.label} exited (rc {self.proc.poll()}) "
                            f"before {marker!r}: {self.tail()}")
                    if marker in ln:
                        return ln
                left = deadline - time.monotonic()
                if left <= 0:
                    raise AssertionError(f"{self.label}: no {marker!r} in "
                                         f"{timeout} s: {self.tail()}")
                self._cv.wait(left)

    def port(self, marker: str, timeout: float = 600) -> int:
        return int(self.wait_for(marker, timeout).strip().rsplit(":", 1)[1])

    def tail(self, n: int = 30) -> str:
        return "\n".join(ln for ln in self.lines[-n:] if ln is not None)

    def stop(self) -> int:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        if self in CHILDREN:
            CHILDREN.remove(self)
        return self.proc.returncode


def reap_children() -> None:
    for c in list(CHILDREN):
        c.stop()


def component_child(label: str, argv: list, env: dict = None) -> tuple:
    """The port's microservice (``argv``) in a child of this script that
    writes its kernels' launch counts to a file when it exits; returns
    ``(child, counts path)``."""
    WIRE_DIR.mkdir(parents=True, exist_ok=True)
    counts = WIRE_DIR / f"launches_{label}.json"
    counts.unlink(missing_ok=True)
    child = Child([sys.executable, str(ROOT / "chip_smoke.py"),
                   "--component-child", str(counts), *argv,
                   "--host", "127.0.0.1"], env, label)
    return child, counts


def component_child_main(argv: list) -> int:
    """``chip_smoke.py --component-child COUNTS <microservice argv>``: run
    ``seldon_core_tpu_torch.serving.microservice`` and, at exit (SIGTERM
    included), write the launch counts of the process to COUNTS."""
    import atexit
    import signal

    sys.path.insert(0, str(ROOT))
    counts, rest = argv[0], argv[1:]
    from seldon_core_tpu_torch.serving import microservice

    atexit.register(lambda: Path(counts).write_text(
        json.dumps(read_launches())))
    signal.signal(signal.SIGTERM, lambda s, f: sys.exit(0))
    microservice.main(rest)
    return 0


def read_child_launches(path) -> dict:
    return json.loads(Path(path).read_text())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wire_env_phase() -> None:
    """Which packages of the reference's wire tiers this machine has, with
    their versions (the gRPC phases import grpc and protobuf), the
    compiler, and the native library's build from ``native/*.cc``."""
    import importlib

    have = {}
    for mod in ("aiohttp", "grpc", "google.protobuf", "ml_dtypes"):
        try:
            have[mod] = getattr(importlib.import_module(mod), "__version__",
                                True)
        except Exception:
            have[mod] = False
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    from seldon_core_tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    emit({"phase": "wire_env", "imports": have,
          "gxx": (gxx.stdout.splitlines() or ["?"])[0],
          "native_build_s": time.perf_counter() - t0,
          "native_compiled": native.build_stats.get("compiled"),
          "native_library": native.build_stats.get("library")})


def wire_resnet(int8: bool = False, device: str = "cuda"):
    """The wire phases' ResNet50 component: ``ResNet50Model(seed=0)`` with
    ``_randomize_resnet(seed=5)``'s BatchNorm, float (bf16) or its int8
    model; the same seeds make the same weights in every process."""
    import torch

    from seldon_core_tpu_torch.models import resnet, resnet_int8

    fm = resnet.ResNet50Model(seed=0, device=device)
    _randomize_resnet(torch, fm.module, seed=5)
    return resnet_int8.Int8ResNet50Model(source=fm, device=device) \
        if int8 else fm


def _pctl(ms: list) -> dict:
    s = sorted(ms)
    return {"p50_ms": statistics.median(s),
            "p95_ms": s[int(0.95 * (len(s) - 1) + 0.5)], "n": len(s)}


def _post_raw(port: int, path: str, data: bytes) -> tuple:
    """POST ``data``; ``(status, body JSON, seconds)`` (server-sent events
    as their list)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, raw = r.status, r.read()
            ctype = r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        code, raw, ctype = e.code, e.read(), ""
    dt = time.perf_counter() - t0
    if ctype.startswith("text/event-stream"):
        return code, [json.loads(ln[6:]) for ln in raw.decode().split("\n\n")
                      if ln.startswith("data: ")], dt
    return code, json.loads(raw), dt


def _get(port: int, path: str) -> tuple:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


WIRE_IMAGES = 16


def wire_resnet50_phase(torch) -> dict:
    """Full ResNet50, bf16 and int8, served by the port's microservice in
    a child process; the engine is the local runner in another child,
    whose graph's node has an ``endpoint`` (the hop keeps the request's
    encoding).  Per dtype: sequential single images as binTensor float32
    and as ndarray (bitwise equal to the in-process graph at batch 1), 16
    concurrent single images per encoding (p50/p95, sheds 0, ids equal,
    probabilities within RESNET_PARITY_TOL's atol), a binTensor batch of
    64 (bitwise equal to the in-process graph at batch 64), and the same
    single images through AsyncFramedClient to a FRAMED microservice and
    through the engine's NativeRestServer (bitwise equal to REST).
    Returns the components' launches."""
    import base64

    import numpy as np

    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.component import ComponentHandle
    from seldon_core_tpu_torch.serving.framed import AsyncFramedClient

    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, (WIRE_IMAGES, 224, 224, 3)).astype(np.float32)
    batch = rng.integers(0, 256, (64, 224, 224, 3)).astype(np.float32)

    def bin_body(x):
        return json.dumps({"data": {"binTensor": {
            "shape": list(x.shape), "dtype": "float32",
            "b64": base64.b64encode(x.tobytes()).decode()}}}).encode()

    def nd_body(x):
        return json.dumps({"data": {"ndarray": x.astype(np.int64)
                                    .tolist()}}).encode()

    # every child starts at once: the components load on the card while
    # the engines boot
    kids = {}
    for label, int8 in (("bf16", False), ("int8", True)):
        params = json.dumps([{"name": "int8", "value": str(int8).lower(),
                              "type": "BOOL"}])
        env = {"PREDICTIVE_UNIT_ID": "resnet"}
        for api in ("REST", "FRAMED", "GRPC"):
            kids[label, api] = component_child(
                f"resnet_{label}_{api.lower()}",
                ["chip_smoke:wire_resnet", api, "--parameters", params,
                 "--port", "0"], env)
    out = {"phase": "wire_resnet50", "images": WIRE_IMAGES,
           "model": "ResNet50 (3, 4, 6, 3), 224x224x3, 1000 classes",
           "engine": "local runner child, node endpoint REST; the hop "
                     "carries the request's encoding",
           "card": CARD}
    launches = {"int8_matmul": 0, "paged_attention": 0,
                "flash_attention": 0}
    engines, grpc_engines = [], {}
    try:
        for label in ("bf16", "int8"):
            for api, marker in (("REST", "serving on"),
                                ("GRPC", "serving gRPC on")):
                cport = kids[label, api][0].port(marker)
                graph = {"spec": {"name": f"wire-{label}", "annotations": {
                    "seldon.io/rest-read-timeout": "300000",
                    "seldon.io/grpc-read-timeout": "300000"},
                    "predictors": [{"name": "main", "graph": {
                        "name": "resnet", "type": "MODEL", "endpoint": {
                            "service_host": "127.0.0.1",
                            "service_port": cport, "type": api}}}]}}
                path = WIRE_DIR / f"graph_{label}_{api.lower()}.json"
                path.write_text(json.dumps(graph))
                argv = [sys.executable, "-m",
                        "seldon_core_tpu_torch.operator.local", "--graph",
                        str(path), "--port", "0", "--host", "127.0.0.1"]
                if api == "REST":
                    engines.append(Child(
                        argv + ["--grpc-port", "0",
                                "--native-port", str(_free_port())],
                        label=f"engine_{label}"))
                else:
                    grpc_engines[label] = Child(
                        argv + ["--grpc-port", str(_free_port()),
                                "--native-grpc-port", str(_free_port())],
                        label=f"engine_{label}_grpc")
        for label, int8 in (("bf16", False), ("int8", True)):
            eng = engines[int8]
            nport = eng.port("native REST tier on")
            eport = eng.port("serving deployment")
            fport = kids[label, "FRAMED"][0].port("serving FRAMED on")
            # in process: the graph over the same component at batch 1
            local = ComponentHandle(wire_resnet(int8), name="resnet")
            graph = GraphEngine({"name": "resnet", "type": "MODEL"},
                                resolver=lambda u, h=local: h)

            def in_process(x, graph=graph):
                return asyncio.run(graph.predict(
                    SeldonMessage.from_ndarray(x))).to_dict()["data"]

            want_bin = [in_process(imgs[i:i + 1]) for i in range(WIRE_IMAGES)]
            want_nd = [in_process(imgs[i:i + 1].astype(np.int64))
                       for i in range(WIRE_IMAGES)]
            want64 = np.asarray(in_process(batch)["ndarray"], np.float32)
            want32 = np.asarray(in_process(batch[:NATIVE_H2_BATCH])["ndarray"],
                                np.float32)
            want_arr = [np.asarray(w["ndarray"], np.float64) for w in want_bin]
            del local, graph
            torch.cuda.empty_cache()
            res = {}
            # warm the path once (first-use costs stay out of the numbers)
            _post_raw(eport, "/api/v0.1/predictions", bin_body(imgs[:1]))
            for enc, body, want in (("binTensor", bin_body, want_bin),
                                    ("ndarray", nd_body, want_nd)):
                seq = [_post_raw(eport, "/api/v0.1/predictions",
                                 body(imgs[i:i + 1]))
                       for i in range(WIRE_IMAGES)]
                bad = [s for s in seq if s[0] != 200]
                if bad:
                    raise AssertionError(f"wire {label} {enc}: {bad[0][:2]}")
                bitwise = sum(s[1]["data"] == w for s, w in zip(seq, want))
                conc = asyncio.run(_in_threads(_post_raw, [
                    (eport, "/api/v0.1/predictions", body(imgs[i:i + 1]))
                    for i in range(WIRE_IMAGES)]))
                failed = [c[:2] for c in conc if c[0] != 200]
                shed = len(failed)
                if shed:
                    raise AssertionError(f"wire {label} {enc} concurrent: "
                                         f"{failed[0]}")
                got = np.asarray([c[1]["data"]["ndarray"][0] for c in conc])
                ref = np.asarray([w["ndarray"][0] for w in want])
                err = float(np.abs(got - ref).max())
                ids = int((got.argmax(-1) == ref.argmax(-1)).sum())
                res[enc] = {"sequential": _pctl([s[2] * 1e3 for s in seq]),
                            "bitwise_equal_in_process": bitwise,
                            "concurrent": _pctl([c[2] * 1e3 for c in conc]),
                            "concurrent_shed": shed,
                            "concurrent_ids_equal": ids,
                            "concurrent_max_abs_err": err,
                            "body_bytes": len(body(imgs[:1]))}
                if bitwise != WIRE_IMAGES or ids != WIRE_IMAGES or \
                        err > RESNET_PARITY_TOL[label][0]:
                    emit({**out, label: res})
                    raise AssertionError(f"wire {label} {enc}: {res[enc]}")
                if enc == "binTensor":
                    rest_bin = [np.asarray(s[1]["data"]["ndarray"],
                                           np.float32) for s in seq]
            code, b64, dt = _post_raw(eport, "/api/v0.1/predictions",
                                      bin_body(batch))
            got64 = np.asarray(b64["data"]["ndarray"], np.float32) \
                if code == 200 else None
            res["batch64_binTensor"] = {
                "ms": dt * 1e3, "status": code,
                "ids_equal": None if got64 is None else
                int((got64.argmax(-1) == want64.argmax(-1)).sum()),
                "max_abs_err": None if got64 is None else
                float(np.abs(got64 - want64).max())}
            # no batcher between the request and the component: bitwise
            if code != 200 or res["batch64_binTensor"]["max_abs_err"] != 0.0:
                raise AssertionError(f"wire {label} batch 64: "
                                     f"{res['batch64_binTensor']}")
            # the native tier of the same engine, then the framed component
            nat = [_post_raw(nport, "/api/v0.1/predictions",
                             bin_body(imgs[i:i + 1]))
                   for i in range(WIRE_IMAGES)]
            nat_equal = sum(n[0] == 200 and np.array_equal(np.asarray(
                n[1]["data"]["ndarray"], np.float32), r)
                for n, r in zip(nat, rest_bin))

            async def framed():
                c = await AsyncFramedClient(timeout=300).connect(
                    "127.0.0.1", fport)
                try:
                    await c.predict(SeldonMessage.from_ndarray(imgs[:1]))
                    outs = []
                    for i in range(WIRE_IMAGES):
                        t0 = time.perf_counter()
                        o = await c.predict(SeldonMessage.from_ndarray(
                            imgs[i:i + 1]))
                        outs.append((o, time.perf_counter() - t0))
                    return outs
                finally:
                    c.close()

            fr = asyncio.run(framed())
            fr_equal = sum(np.array_equal(np.asarray(o.host_data(),
                                                     np.float32), r)
                           for (o, _), r in zip(fr, rest_bin))
            res["native_rest_binTensor"] = {
                **_pctl([n[2] * 1e3 for n in nat]),
                "bitwise_equal_rest": nat_equal}
            res["framed"] = {**_pctl([t * 1e3 for _, t in fr]),
                             "bitwise_equal_rest": fr_equal,
                             "reply_dtype": str(fr[0][0].data.dtype)}
            out[label] = res
            if nat_equal != WIRE_IMAGES or fr_equal != WIRE_IMAGES:
                emit(out)
                raise AssertionError(f"wire {label}: native {nat_equal}, "
                                     f"framed {fr_equal} of {WIRE_IMAGES}")
            # gRPC: the runner's Seldon service and its native gRPC tier,
            # the hop a GRPC endpoint to the GRPC component child
            geng = grpc_engines[label]
            gport = geng.port("gRPC Seldon service on")
            ngport = geng.port("native gRPC tier on")
            for tier, port, big, want_big in (
                    ("grpc", gport, batch, want64),
                    ("native_grpc", ngport, batch[:NATIVE_H2_BATCH], want32)):
                res[tier] = asyncio.run(_grpc_wire(port, imgs, big))
                r = res[tier]
                r["bitwise_equal_in_process"] = sum(
                    np.array_equal(g, w) for g, w in zip(r.pop("singles"),
                                                          want_arr))
                conc = r.pop("concurrent_answers")
                r["concurrent_bitwise_equal"] = sum(
                    g is not None and np.array_equal(g, w)
                    for g, w in zip(conc, want_arr))
                r["concurrent_ids_equal"] = sum(
                    g is not None and int(g.argmax()) == int(w.argmax())
                    for g, w in zip(conc, want_arr))
                got = r.pop("batch")
                r["batch_max_abs_err"] = None if got is None else \
                    float(np.abs(got - want_big).max())
                if r["bitwise_equal_in_process"] != WIRE_IMAGES or \
                        r["concurrent_shed"] or \
                        r["concurrent_ids_equal"] != WIRE_IMAGES or \
                        r["batch_max_abs_err"] != 0.0:
                    emit({**out, label: res})
                    raise AssertionError(f"wire {label} {tier}: {r}")
    finally:
        for e in engines + list(grpc_engines.values()):
            e.stop()
        for child, _ in kids.values():
            child.stop()
    per = {}
    for (label, api), (child, counts) in kids.items():
        got = read_child_launches(counts)
        per[f"{label}_{api.lower()}"] = got
        for k in launches:
            launches[k] += got[k]
    out["component_launches"] = per
    # one warm-up, 16 x 4 singles and one batch per REST component; per
    # gRPC tier a warm-up, 16 singles, 16 concurrent and one batch: every
    # forward of the int8 ones launches K1 37 times, the float ones never
    rest_forwards = 1 + 4 * WIRE_IMAGES + 1 + WIRE_IMAGES
    grpc_forwards = 2 * (1 + 2 * WIRE_IMAGES + 1)
    out["int8_k1_per_forward"] = per["int8_rest"]["int8_matmul"] / \
        rest_forwards
    out["int8_grpc_k1_per_forward"] = per["int8_grpc"]["int8_matmul"] / \
        grpc_forwards
    emit(out)
    if per["int8_rest"]["int8_matmul"] != 37 * rest_forwards or \
            per["int8_framed"]["int8_matmul"] != 37 * (WIRE_IMAGES + 1) or \
            per["int8_grpc"]["int8_matmul"] != 37 * grpc_forwards or \
            per["bf16_rest"]["int8_matmul"] != 0 or \
            per["bf16_grpc"]["int8_matmul"] != 0:
        raise AssertionError(f"wire_resnet50: K1 launches {per}")
    return launches


#: the native h2c server takes at most 32 MiB in one request
#: (``native/httpserver.cc`` ``kMaxStreamBody``): a batch of 64 float32
#: images is 38.5 MB, so its native gRPC tier gets the first 32
NATIVE_H2_BATCH = 32


async def _grpc_wire(port: int, imgs, batch) -> dict:
    """``SeldonGrpcClient`` against one gRPC tier of a runner: a warm-up,
    the single images in turn and all at once (binTensor), and the batch;
    their answers (float64) and times."""
    import numpy as np

    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.serving.grpc_api import SeldonGrpcClient

    def msg(x):
        return SeldonMessage(data=x, encoding="binTensor")

    async def timed(x):
        t0 = time.perf_counter()
        o = await c.predict(msg(x))
        return o, time.perf_counter() - t0

    def arr(o):
        if o.status is not None and o.status.status == "FAILURE":
            return None
        return np.asarray(o.host_data(), np.float64)

    c = SeldonGrpcClient(f"127.0.0.1:{port}", timeout_s=600)
    try:
        await c.predict(msg(imgs[:1]))
        seq = [await timed(imgs[i:i + 1]) for i in range(len(imgs))]
        conc = await asyncio.gather(*(timed(imgs[i:i + 1])
                                      for i in range(len(imgs))))
        b, tb = await timed(batch)
    finally:
        await c.close()
    return {"sequential": _pctl([t * 1e3 for _, t in seq]),
            "concurrent": _pctl([t * 1e3 for _, t in conc]),
            "concurrent_shed": sum(arr(o) is None for o, _ in conc),
            "batch_rows": len(batch), "batch_ms": tb * 1e3,
            "singles": [arr(o) for o, _ in seq],
            "concurrent_answers": [arr(o) for o, _ in conc],
            "batch": arr(b)}


def wire_llm_phase(torch) -> dict:
    """``llm.json``'s model served by the port's microservice (a child),
    the local runner (another child) calling it through its endpoint node:
    ``llm_json``'s two waves through ``/api/v0.1/predictions`` and
    ``/api/v0.1/stream``, greedy ids equal to ``llm_json``'s in-process
    ids; an empty prompt (200, its ids the CPU plain path's); the engine's
    ``/metrics`` (request and stream series), ``/pause`` (503 on the
    runner's Python and native tiers) and ``/unpause``, ``/seldon.json``.
    Returns the component's launches."""
    examples = ROOT / "seldon_core_tpu_torch" / "examples"
    d = json.loads((examples / "llm.json").read_text())
    node = d["spec"]["predictors"][0]["graph"]
    params = [p for p in node["parameters"] if p["name"] != "model_class"]
    cls = [p["value"] for p in node["parameters"]
           if p["name"] == "model_class"][0]
    node_params = params
    comp, counts = component_child(
        "llm", [cls, "REST", "--parameters", json.dumps(params),
                "--port", "0"], {"PREDICTIVE_UNIT_ID": "llm"})
    gcomp, gcounts = component_child(
        "llm_grpc", [cls, "GRPC", "--parameters", json.dumps(params),
                     "--port", "0"], {"PREDICTIVE_UNIT_ID": "llm"})
    engine = gengine = None
    out = {"phase": "wire_llm", "card": CARD}
    try:
        gport = gcomp.port("serving gRPC on")
        gd = json.loads(json.dumps(d))
        gd["spec"]["predictors"][0]["graph"] = {
            "name": "llm", "type": "MODEL", "endpoint": {
                "service_host": "127.0.0.1", "service_port": gport,
                "type": "GRPC"}}
        gpath = WIRE_DIR / "graph_llm_grpc.json"
        gpath.write_text(json.dumps(gd))
        gengine = Child([sys.executable, "-m",
                         "seldon_core_tpu_torch.operator.local", "--graph",
                         str(gpath), "--port", "0", "--host", "127.0.0.1",
                         "--grpc-port", str(_free_port())],
                        label="engine_llm_grpc")
        cport = comp.port("serving on")
        node = {"name": "llm", "type": "MODEL", "endpoint": {
            "service_host": "127.0.0.1", "service_port": cport,
            "type": "REST"}}
        d["spec"]["predictors"][0]["graph"] = node
        path = WIRE_DIR / "graph_llm.json"
        path.write_text(json.dumps(d))
        engine = Child([sys.executable, "-m",
                        "seldon_core_tpu_torch.operator.local", "--graph",
                        str(path), "--port", "0", "--host", "127.0.0.1",
                        "--grpc-port", "0",
                        "--native-port", str(_free_port())],
                       label="engine_llm")
        nport = engine.port("native REST tier on")
        port = engine.port("serving deployment")
        prompts, want = LLM_JSON["prompts"], LLM_JSON["ids"]
        got, streamed = [], []
        for wave in (prompts[:3], prompts[3:]):
            bodies = [json.dumps({"jsonData": {"prompt_ids": p, "n_new": 8}}
                                 ).encode() for p in wave]
            ans = asyncio.run(_in_threads(_post_raw, [
                (port, "/api/v0.1/predictions", b) for b in bodies]))
            sse = asyncio.run(_in_threads(_post_raw, [
                (port, "/api/v0.1/stream", b) for b in bodies]))
            for a, s in zip(ans, sse):
                if a[0] != 200 or s[0] != 200:
                    raise AssertionError(f"wire_llm: {a[:2]} {s[:2]}")
                got.append(a[1]["jsonData"]["ids"])
                streamed.append(s[1][-1]["ids"])
        empty = json.dumps({"jsonData": {"prompt_ids": [], "n_new": 3}}
                           ).encode()
        e_pred = _post_raw(port, "/api/v0.1/predictions", empty)
        e_sse = _post_raw(port, "/api/v0.1/stream", empty)
        metrics = _get(port, "/metrics")[1]
        # the runner's native tier shares the paused state
        paused = [_get(port, "/pause"),
                  _post_raw(port, "/api/v0.1/predictions", empty)[:2],
                  _get(port, "/ready"),
                  _post_raw(nport, "/api/v0.1/predictions", empty)[:2]]
        resumed = [_get(port, "/unpause"),
                   _post_raw(port, "/api/v0.1/predictions", empty)[0],
                   _post_raw(nport, "/api/v0.1/predictions", empty)[0]]
        spec = json.loads(_get(port, "/seldon.json")[1])
        counters = {
            "requests_200": 'seldon_api_executor_server_requests_seconds'
                            '_count{code="200"' in metrics,
            "stream_tokens": 'seldon_llm_tokens_generated_total'
                             '{model_name="predictor"}' in metrics,
            "node_timer": 'model_name="llm"' in metrics}
        out.update({
            "requests": len(got), "ids_equal_llm_json": got == want,
            "stream_ids_equal_llm_json": streamed == want,
            "empty_prompt": {
                "predictions_status": e_pred[0],
                "stream_status": e_sse[0],
                "ids": e_pred[1].get("jsonData", {}).get("ids"),
                "stream_tokens": [e.get("token") for e in e_sse[1][:-1]]
                if e_sse[0] == 200 else None,
                "cpu_plain_ids": LLM_JSON["empty_ids"]},
            "metrics_series": counters,
            "pause": [p[0] for p in paused],
            "unpause": [resumed[0][0], *resumed[1:]],
            "seldon_json_paths": len(spec.get("paths", {}))})
        # the GRPC component child behind a GRPC endpoint node: the waves
        # through the runner's REST predictions and stream (the hop is
        # Predict and Generic.Stream) and its Seldon gRPC service, and each
        # prompt's Generic.Stream on the child itself
        grport = gengine.port("serving deployment")
        gsport = gengine.port("gRPC Seldon service on")
        g = {"rest_predictions": [], "rest_stream": []}
        for wave in (prompts[:3], prompts[3:]):
            bodies = [json.dumps({"jsonData": {"prompt_ids": p, "n_new": 8}}
                                 ).encode() for p in wave]
            ans = asyncio.run(_in_threads(_post_raw, [
                (grport, "/api/v0.1/predictions", b) for b in bodies]))
            sse = asyncio.run(_in_threads(_post_raw, [
                (grport, "/api/v0.1/stream", b) for b in bodies]))
            g["rest_predictions"] += [a[1]["jsonData"]["ids"] if a[0] == 200
                                      else a[:2] for a in ans]
            g["rest_stream"] += [e[1][-1]["ids"] if e[0] == 200 else e[:2]
                                 for e in sse]
        g.update(asyncio.run(_llm_grpc_calls(gsport, gport, prompts)))
        out["grpc"] = {k: v == want for k, v in g.items()}
    finally:
        for e in (engine, gengine):
            if e is not None:
                e.stop()
        comp.stop()
        gcomp.stop()
    launches = read_child_launches(counts)
    out["component_launches"] = launches
    out["grpc_component_launches"] = read_child_launches(gcounts)
    for k, n in out["grpc_component_launches"].items():
        launches = {**launches, k: launches[k] + n}
    out["grpc_cancelled_stream"], inproc = _llm_grpc_cancel(node_params)
    for k, n in inproc.items():
        launches[k] += n
    emit(out)
    if not all(out["grpc"].values()):
        raise AssertionError(f"wire_llm gRPC: ids differ: {out['grpc']}")
    c = out["grpc_cancelled_stream"]
    if c["held_slots"] != 1 or c["after_slots"] != 0 or \
            c["after_free_pages"] != c["free_pages_idle"]:
        raise AssertionError(f"wire_llm: cancelled gRPC stream {c}")
    if out["grpc_component_launches"]["int8_matmul"] == 0 or \
            out["grpc_component_launches"]["paged_attention"] == 0:
        raise AssertionError(f"wire_llm gRPC child: kernels not launched "
                             f"{out['grpc_component_launches']}")
    e = out["empty_prompt"]
    if not (out["ids_equal_llm_json"] and out["stream_ids_equal_llm_json"]):
        raise AssertionError("wire_llm: ids differ from llm_json's")
    if not (e["predictions_status"] == e["stream_status"] == 200
            and e["ids"] == e["cpu_plain_ids"]
            and e["stream_tokens"] == e["cpu_plain_ids"]):
        raise AssertionError(f"wire_llm: empty prompt {e}")
    if not all(counters.values()) or \
            out["pause"] != [200, 503, 503, 503] or \
            out["unpause"] != [200, 200, 200] or \
            not out["seldon_json_paths"]:
        raise AssertionError(f"wire_llm: routes {out}")
    if launches["int8_matmul"] == 0 or launches["paged_attention"] == 0:
        raise AssertionError(f"wire_llm: kernels not launched {launches}")
    return launches


async def _llm_grpc_calls(seldon_port: int, comp_port: int,
                          prompts: list) -> dict:
    """The prompts' greedy ids through a runner's ``Seldon.Predict`` and
    through ``Generic.Stream`` on the component child."""
    from seldon_core_tpu_torch.serving.grpc_api import (
        GrpcComponentClient,
        SeldonGrpcClient,
    )

    sc = SeldonGrpcClient(f"127.0.0.1:{seldon_port}", timeout_s=600)
    cc = GrpcComponentClient(f"127.0.0.1:{comp_port}", timeout_s=600)
    try:
        out = {"seldon_predict": [], "component_stream": []}
        for wave in (prompts[:3], prompts[3:]):
            preds = await asyncio.gather(*(sc.predict(_json_msg(p, 8))
                                           for p in wave))
            out["seldon_predict"] += [
                p.json_data["ids"] if p.status.status == "SUCCESS"
                else p.status.to_dict() for p in preds]

            async def events(p):
                return [e async for e in cc.stream(_json_msg(p, 8))]

            streams = await asyncio.gather(*(events(p) for p in wave))
            out["component_stream"] += [ev[-1]["ids"] for ev in streams]
        return out
    finally:
        await sc.close()
        await cc.close()


def _llm_grpc_cancel(params: list) -> tuple:
    """``llm.json``'s model in process on the card behind ``GrpcServer``: a
    ``Generic.Stream`` cancelled after its first event gives back its slot
    and pages.  Returns the record and the launches."""
    import grpc.aio

    from seldon_core_tpu_torch.graph.spec import _coerce_param
    from seldon_core_tpu_torch.models.llm_demo import DemoLLM
    from seldon_core_tpu_torch.runtime.component import ComponentHandle
    from seldon_core_tpu_torch.serving.grpc_api import (
        GrpcServer,
        component_service_handlers,
    )

    kw = {p["name"]: _coerce_param(p["value"], p.get("type", "STRING"),
                                   "parameters", p["name"]) for p in params}
    comp = DemoLLM(**kw)
    engine = comp.engine
    idle = engine.free_pages
    handle = ComponentHandle(comp, name="llm")

    async def run():
        server = GrpcServer(component_service_handlers(handle, "MODEL"),
                            port=0, host="127.0.0.1")
        port = await server.start()
        channel = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
        try:
            reset_launches()
            call = _stream_call(channel, "Generic",
                                _json_msg(list(range(1, 20)), 100))
            await call.__aiter__().__anext__()
            held = (len(engine._slots), engine.free_pages)
            call.cancel()
            t0 = time.monotonic()
            while (engine._slots or engine.free_pages != idle) and \
                    time.monotonic() - t0 < 30:
                await asyncio.sleep(0.01)
            return held, (len(engine._slots), engine.free_pages,
                          time.monotonic() - t0), read_launches()
        finally:
            await channel.close()
            await server.stop()

    held, freed, launches = asyncio.run(run())
    engine.close()
    return {"held_slots": held[0], "held_free_pages": held[1],
            "after_slots": freed[0], "after_free_pages": freed[1],
            "free_pages_idle": idle, "freed_in_s": freed[2]}, launches


def wire_persistence_phase() -> None:
    """The MAB graph's router as the port's microservice with
    ``--persistence 1`` (a FileStateStore in a temporary directory): the
    in-process runner (its models on the card) calls it through its
    endpoint node; after probes and REST feedback rewarding branch 1 the
    router is stopped with SIGTERM (its final push) and booted again, and
    the same probes answer as before (error 0.0)."""
    import tempfile

    import numpy as np

    from seldon_core_tpu_torch.operator.local import serve

    d = json.loads((ROOT / "seldon_core_tpu_torch" / "examples"
                    / "epsilon-greedy-mab.json").read_text())
    graph = d["spec"]["predictors"][0]["graph"]
    params = [p for p in graph["parameters"] if p["name"] != "epsilon"] + [
        {"name": "epsilon", "value": "0.0", "type": "FLOAT"}]
    bodies = _graph_requests("epsilon-greedy-mab")
    fb = {"response": {"meta": {"routing": {"eg-router": 1}}}, "reward": 1.0}
    with tempfile.TemporaryDirectory() as root:
        env = {"SELDON_STATE_DIR": root, "PREDICTIVE_UNIT_ID": "eg-router",
               "SELDON_DEPLOYMENT_ID": d["spec"]["name"],
               "PREDICTOR_ID": "main"}
        argv = ["seldon_core_tpu_torch.graph.builtins:EpsilonGreedy", "REST",
                "--service-type", "ROUTER", "--parameters",
                json.dumps(params), "--persistence", "1",
                "--push-frequency", "3600", "--port", "0"]

        async def answers(port):
            outs = []
            for b in bodies:
                code, o, _ = await asyncio.to_thread(_post_timed, port, b)
                if code != 200:
                    raise AssertionError(f"wire persistence: {o}")
                o["meta"].pop("puid")
                outs.append(o)
            return outs

        async def run(router_port, feedback):
            spec = json.loads(json.dumps(d))
            g = spec["spec"]["predictors"][0]["graph"]
            g.pop("implementation")
            g["parameters"] = []
            g["endpoint"] = {"service_host": "127.0.0.1",
                             "service_port": router_port, "type": "REST"}
            server, _ = await serve(spec, port=0, host="127.0.0.1")
            try:
                if feedback:
                    await answers(server.port)
                    for _ in range(3):
                        code, res, _ = await asyncio.to_thread(
                            _post_timed, server.port, fb,
                            "/api/v0.1/feedback")
                        if code != 200:
                            raise AssertionError(f"feedback: {res}")
                return await answers(server.port)
            finally:
                await server.stop()

        results, rcs = [], []
        for feedback in (True, False):
            child, _ = component_child(f"mab_router_{int(feedback)}", argv,
                                       env)
            try:
                results.append(asyncio.run(run(child.port("serving on"),
                                               feedback)))
            finally:
                rcs.append(child.stop())
        stored = sorted(p.name for p in Path(root).iterdir())
    want, got = results
    err = 0.0
    for w, g in zip(want, got):
        wv = np.asarray(w["data"]["ndarray"], np.float64)
        gv = np.asarray(g["data"]["ndarray"], np.float64)
        err = max(err, float(np.abs(wv - gv).max()))
    routes = [w["meta"]["routing"]["eg-router"] for w in want]
    emit({"phase": "wire_persistence", "graph": "epsilon-greedy-mab",
          "router": "microservice REST --persistence 1, SIGTERM, reboot",
          "probes": len(want), "routes": routes, "stored": stored,
          "exit_codes": rcs, "max_abs_err": err,
          "meta_equal": [w["meta"] for w in want] == [g["meta"] for g in got],
          "card": CARD})
    if err != 0.0 or set(routes) != {1} or rcs[0] != 0 or \
            [w["meta"] for w in want] != [g["meta"] for g in got]:
        raise AssertionError(f"wire persistence: routes {routes}, error "
                             f"{err}, exit codes {rcs}")


def runner_child(label: str, argv: list, env: dict = None) -> tuple:
    """The local runner (``argv``) in a child of this script whose every
    process (the supervisor and each worker) writes its launch counts to a
    file of its own when it exits; returns ``(child, counts prefix)``."""
    WIRE_DIR.mkdir(parents=True, exist_ok=True)
    counts = WIRE_DIR / f"launches_{label}"
    for old in WIRE_DIR.glob(f"launches_{label}.*.json"):
        old.unlink()
    child = Child([sys.executable, str(ROOT / "chip_smoke.py"),
                   "--runner-child", str(counts), *argv], env, label)
    return child, counts


def runner_child_main(argv: list) -> int:
    """``chip_smoke.py --runner-child COUNTS <runner argv>``: run
    ``seldon_core_tpu_torch.operator.local`` and, at each process's exit,
    write its launch counts to ``COUNTS.<pid>.json``."""
    import atexit
    import os
    import signal

    sys.path.insert(0, str(ROOT))
    counts, rest = argv[0], argv[1:]
    from seldon_core_tpu_torch.models import register_signature, signature_for
    from seldon_core_tpu_torch.operator import local

    # the smoke ResNet's signature, which a plan's warm-up reads
    register_signature(SMOKE_RESNET, signature_for(
        "seldon_core_tpu_torch.models.resnet:ResNet50Model"))
    atexit.register(lambda: Path(f"{counts}.{os.getpid()}.json").write_text(
        json.dumps(read_launches())))
    # the counts so far, on request (``_child_launches_now``)
    signal.signal(signal.SIGUSR1, lambda s, f: Path(
        f"{counts}-now.{os.getpid()}.json").write_text(
            json.dumps(read_launches())))
    local.engine_main(rest)
    return 0


def _proc_uses_card(pid: int) -> bool:
    """Whether process ``pid`` holds an NVIDIA device file open."""
    import os

    try:
        return any(os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
            "/dev/nvidia") for fd in os.listdir(f"/proc/{pid}/fd"))
    except OSError:
        return False


def workers_phase(torch) -> dict:
    """The port's ``resnet50-int8.json`` behind a runner child with
    ``--workers 2``: REST, gRPC, native REST and native gRPC on
    ``SO_REUSEPORT`` ports shared by both workers.  Both worker pids on the
    card (``nvidia-smi --query-compute-apps=pid``, and each holding the
    card's device files); 8 single images per tier, each answer bitwise
    equal to the in-process forward of the same model at batch 1; then one
    worker is killed and the group stops (the supervisor exits 0, every
    worker reaped).  Returns the surviving processes' launches."""
    import os
    import signal

    import numpy as np

    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.resnet_int8 import Int8ResNet50Model
    from seldon_core_tpu_torch.runtime.component import ComponentHandle

    graph = ROOT / "seldon_core_tpu_torch" / "examples" / "resnet50-int8.json"
    ports = [_free_port() for _ in range(4)]
    child, counts = runner_child("workers", [
        "--graph", str(graph), "--host", "127.0.0.1", "--workers", "2",
        "--port", str(ports[0]), "--grpc-port", str(ports[1]),
        "--native-port", str(ports[2]), "--native-grpc-port",
        str(ports[3])])
    n = 8
    imgs = np.random.default_rng(13).integers(
        0, 256, (n, 224, 224, 3)).astype(np.float32)
    out = {"phase": "workers", "graph": "resnet50-int8.json", "workers": 2,
           "images_per_tier": n, "card": CARD}
    try:
        handle = ComponentHandle(Int8ResNet50Model(image_size=224),
                                 name="resnet50-int8")
        want = [np.asarray(handle.predict(SeldonMessage.from_ndarray(
            imgs[i:i + 1])).host_data(), np.float64) for i in range(n)]
        del handle
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        while sum("serving deployment" in (ln or "")
                  for ln in list(child.lines)) < 2:
            child.wait_for("serving deployment", 600)
            if time.monotonic() - t0 > 600:
                raise AssertionError(f"workers: {child.tail()}")
            time.sleep(0.2)
        pids = sorted(int(ln.split("pid ")[1].rstrip(")"))
                      for ln in list(child.lines)
                      if ln and ln.startswith("worker ") and "(pid " in ln)
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split()
        out.update(worker_pids=pids, supervisor_pid=child.proc.pid,
                   nvidia_smi_compute_pids=smi,
                   nvidia_smi_lists_workers=all(str(p) in smi for p in pids),
                   workers_hold_device_files=[_proc_uses_card(p)
                                              for p in pids])

        def body(x):
            import base64

            return json.dumps({"data": {"binTensor": {
                "shape": list(x.shape), "dtype": "float32",
                "b64": base64.b64encode(x.tobytes()).decode()}}}).encode()

        tiers = {}
        for tier, port in (("rest", ports[0]), ("native_rest", ports[2])):
            got = []
            for i in range(n):
                code, res, _ = _post_raw(port, "/api/v0.1/predictions",
                                         body(imgs[i:i + 1]))
                got.append(np.asarray(res["data"]["ndarray"], np.float64)
                           if code == 200 else None)
            tiers[tier] = got

        async def grpc_tier(port):
            from seldon_core_tpu_torch.serving.grpc_api import (
                SeldonGrpcClient,
            )

            got = []
            for i in range(n):
                # a new channel each time: the kernel spreads connections
                c = SeldonGrpcClient(f"127.0.0.1:{port}", timeout_s=600)
                try:
                    o = await c.predict(SeldonMessage(
                        data=imgs[i:i + 1], encoding="binTensor"))
                finally:
                    await c.close()
                got.append(np.asarray(o.host_data(), np.float64)
                           if o.status.status == "SUCCESS" else None)
            return got

        for tier, port in (("grpc", ports[1]), ("native_grpc", ports[3])):
            tiers[tier] = asyncio.run(grpc_tier(port))
        out["bitwise_equal_in_process"] = {
            t: sum(g is not None and np.array_equal(g, w)
                   for g, w in zip(got, want)) for t, got in tiers.items()}
        # fail-fast: one worker killed stops the group
        os.kill(pids[0], signal.SIGKILL)
        rc = child.proc.wait(timeout=120)
        t0 = time.monotonic()
        while any(os.path.exists(f"/proc/{p}") for p in pids) and \
                time.monotonic() - t0 < 30:
            time.sleep(0.05)
        out.update(supervisor_exit_code=rc,
                   workers_left=[p for p in pids
                                 if os.path.exists(f"/proc/{p}")])
    finally:
        child.stop()
    files = sorted(WIRE_DIR.glob(f"launches_workers.*.json"))
    launches = {"int8_matmul": 0, "paged_attention": 0, "flash_attention": 0}
    for f in files:
        for k, v in json.loads(f.read_text()).items():
            launches[k] += v
    out["launches_of_exited_processes"] = launches
    out["count_files"] = len(files)
    emit(out)
    if len(pids) != 2 or not all(out["workers_hold_device_files"]):
        raise AssertionError(f"workers: not both on the card: {out}")
    if any(v != n for v in out["bitwise_equal_in_process"].values()):
        raise AssertionError(f"workers: answers differ: {out}")
    if out["supervisor_exit_code"] != 0 or out["workers_left"]:
        raise AssertionError(f"workers: the group did not stop: {out}")
    # the surviving worker warmed 7 buckets and served: K1 37 a forward
    if launches["int8_matmul"] <= 0 or launches["int8_matmul"] % 37:
        raise AssertionError(f"workers: K1 launches {launches}")
    return launches


QOS_IMAGES = 8
QOS_BURST_S = 4.0


def _post_qos(port: int, data: bytes, headers: dict) -> tuple:
    """POST a prediction with QoS headers: ``(status, Retry-After, body,
    seconds, send time)``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions", data=data,
        headers={"Content-Type": "application/json", **headers})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, e.headers, e.read()
    return code, hdrs.get("Retry-After"), json.loads(raw), \
        time.perf_counter() - t0, t0


def qos_resnet50_phase(torch) -> dict:
    """The int8 ResNet50 behind the runner with QoS: the graph is a
    SIMPLE_ROUTER over ``primary`` (a GRPC microservice child) and
    ``cheap`` (a REST microservice child, the same weights), with
    ``seldon.io/slo-p95-ms``, breakers (3 calls), and ``cheap`` as the
    ``seldon.io/qos-fallback``.  (1) The rate the graph serves alone (64
    uint8 images from 12 clients in a closed loop); (2) an open-loop burst at twice that rate for
    ``QOS_BURST_S`` seconds, priorities low/normal/high in turn: every
    answer 200 with the in-process top-1, or 429 with ``Retry-After``, low
    shed first and most, goodput per priority; (3) a request whose budget
    has expired answers 504 and launches no kernel: every K1 launch of the
    children is accounted for by an answered forward; (4) the primary child
    is stopped: after 3 failures its breaker opens and the fallback answers,
    ``meta.tags.degraded`` ``breaker_open``.  Returns the children's
    launches."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.component import ComponentHandle

    params = json.dumps([{"name": "int8", "value": "true", "type": "BOOL"}])
    prim, pcounts = component_child(
        "qos_primary", ["chip_smoke:wire_resnet", "GRPC", "--parameters",
                        params, "--port", "0"],
        {"PREDICTIVE_UNIT_ID": "primary"})
    cheap, ccounts = component_child(
        "qos_cheap", ["chip_smoke:wire_resnet", "REST", "--parameters",
                      params, "--port", "0"], {"PREDICTIVE_UNIT_ID": "cheap"})
    ann = {"seldon.io/slo-p95-ms": "250",
           "seldon.io/qos-fallback": "cheap",
           "seldon.io/qos-degrade-shed-level": "3",
           "seldon.io/qos-breaker-min-calls": "3",
           "seldon.io/qos-breaker-open-ms": "600000",
           "seldon.io/grpc-read-timeout": "60000",
           "seldon.io/rest-read-timeout": "60000"}
    # uint8 images (the model's first step casts to bf16, exactly as for
    # float32 0-255 values): 200 KB bodies, so the REST front end parses
    # faster than the primary computes, and the engine, where admission
    # control stands, is the bottleneck
    rng = np.random.default_rng(17)
    imgs = rng.integers(0, 256, (QOS_IMAGES, 224, 224, 3)).astype(np.uint8)
    bodies = [json.dumps({"data": {"binTensor": {
        "shape": [1, 224, 224, 3], "dtype": "uint8",
        "b64": base64.b64encode(imgs[i:i + 1].tobytes()).decode()}}}
        ).encode() for i in range(QOS_IMAGES)]
    out = {"phase": "qos_resnet50", "annotations": ann, "card": CARD}
    engine = None
    try:
        local = ComponentHandle(wire_resnet(True), name="resnet")
        top1 = [int(np.asarray(local.predict(SeldonMessage.from_ndarray(
            imgs[i:i + 1])).host_data()).argmax()) for i in range(QOS_IMAGES)]
        del local
        torch.cuda.empty_cache()
        graph = {"name": "router", "type": "ROUTER",
                 "implementation": "SIMPLE_ROUTER", "children": [
                     {"name": "primary", "type": "MODEL", "endpoint": {
                         "service_host": "127.0.0.1", "type": "GRPC",
                         "service_port": prim.port("serving gRPC on")}},
                     {"name": "cheap", "type": "MODEL", "endpoint": {
                         "service_host": "127.0.0.1", "type": "REST",
                         "service_port": cheap.port("serving on")}}]}
        path = WIRE_DIR / "graph_qos.json"
        path.write_text(json.dumps({"spec": {
            "name": "qos-resnet50", "annotations": ann,
            "predictors": [{"name": "main", "graph": graph}]}}))
        engine = Child([sys.executable, "-m",
                        "seldon_core_tpu_torch.operator.local", "--graph",
                        str(path), "--port", "0", "--host", "127.0.0.1",
                        "--grpc-port", "0"], label="engine_qos")
        port = engine.port("serving deployment")
        answers = []  # (phase, priority, image, result)

        def record(phase, pri, i, res):
            answers.append((phase, pri, i, res))
            return res

        # (1) alone: the rate the graph serves, 12 clients in a closed
        # loop of 64 requests (below the admission limit: none sheds)
        record("warm", "high", 0, _post_qos(port, bodies[0], {}))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(12) as pool:
            alone = list(pool.map(lambda k: (k % QOS_IMAGES, _post_qos(
                port, bodies[k % QOS_IMAGES], {"X-Seldon-Priority": "high"})),
                range(64)))
        rate = 64 / (time.perf_counter() - t0)
        for i, res in alone:
            record("alone", "high", i, res)
        # (2) the burst, open loop at twice that rate
        n = int(2 * rate * QOS_BURST_S)
        pris = ["low", "normal", "high"]
        plan = [(pris[k % 3], k % QOS_IMAGES, k / (2 * rate))
                for k in range(n)]
        with ThreadPoolExecutor(128) as pool:
            start = time.perf_counter()
            futs = []
            for pri, i, at in plan:
                delay = start + at - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futs.append((pri, i, pool.submit(
                    _post_qos, port, bodies[i], {"X-Seldon-Priority": pri})))
            for pri, i, f in futs:
                record("burst", pri, i, f.result())
        metrics = _get(port, "/metrics")[1]
        # (3) an expired budget
        record("expired", "normal", 0, _post_qos(
            port, bodies[0], {"X-Seldon-Deadline-Ms": "0"}))
        # (4) the primary stops: once failures are half its breaker's
        # window (the burst's answers are in it too) the breaker opens, and
        # the fallback answers 4 more
        prim.stop()
        after = 0
        for k in range(20000):
            res = record("primary_down", "normal", k % QOS_IMAGES, _post_qos(
                port, bodies[k % QOS_IMAGES], {}))
            after += res[0] == 200
            if after == 4:
                break
    finally:
        if engine is not None:
            engine.stop()
        prim.stop()
        cheap.stop()
    plaunch, claunch = read_child_launches(pcounts), \
        read_child_launches(ccounts)

    def ok(res, i):
        code, _, body, _, _ = res
        return code == 200 and int(np.asarray(
            body["data"]["ndarray"]).argmax()) == top1[i]

    def degraded(res):
        return res[0] == 200 and "degraded" in res[2].get("meta", {}).get(
            "tags", {})

    burst = [(pri, i, r) for ph, pri, i, r in answers if ph == "burst"]
    per = {}
    for pri in pris:
        mine = [(i, r) for p, i, r in burst if p == pri]
        good = sum(ok(r, i) for i, r in mine)
        per[pri] = {"requests": len(mine), "ok": good,
                    "shed_429": sum(r[0] == 429 for _, r in mine),
                    "goodput_per_s": good / QOS_BURST_S,
                    "goodput_share": good / max(len(mine), 1),
                    "p50_ms_ok": statistics.median(
                        [r[3] * 1e3 for i, r in mine if ok(r, i)] or [0.0])}
    bad = [(pri, r[0], r[2].get("status")) for pri, i, r in burst
           if not ok(r, i) and not (r[0] == 429 and r[1] == "1")]
    sheds = sorted((r[4], pri) for pri, i, r in burst if r[0] == 429)
    expired = [r for ph, _, _, r in answers if ph == "expired"][0]
    down = [r for ph, _, _, r in answers if ph == "primary_down"]
    down_codes = [(r[0], r[2].get("status", {}).get("reason"),
                   r[2].get("meta", {}).get("tags", {}).get("degraded"))
                  for r in down]
    # every forward of a child is an answer it gave: 37 K1 launches each
    served_primary = sum(1 for ph, _, i, r in answers
                         if ph != "primary_down" and r[0] == 200
                         and not degraded(r))
    served_cheap = sum(1 for _, _, _, r in answers if degraded(r))
    out.update({
        "alone_rate_per_s": rate, "burst_rate_per_s": 2 * rate,
        "burst_requests": n, "per_priority": per,
        "burst_not_200_or_429": bad,
        "first_shed_priority": sheds[0][1] if sheds else None,
        "degraded_in_burst": sum(degraded(r) for _, _, r in burst),
        "expired_budget": {"status": expired[0],
                           "reason": expired[2]["status"]["reason"]},
        "primary_down": {"failures_before_open": sum(
            c[0] != 200 for c in down_codes), "after": down_codes[-4:]},
        "forwards": {"primary": served_primary, "cheap": served_cheap},
        "launches": {"primary": plaunch, "cheap": claunch},
        "qos_metrics": [ln for ln in metrics.splitlines()
                        if ln.startswith("seldon_qos_")],
        "alone_p50_ms": statistics.median(
            r[3] * 1e3 for ph, _, _, r in answers if ph == "alone")})
    emit(out)
    if bad:
        raise AssertionError(f"qos_resnet50: answers neither 200-correct nor "
                             f"429 with Retry-After: {bad[:3]}")
    shed = {p: per[p]["shed_429"] / max(per[p]["requests"], 1) for p in pris}
    if not sheds or sheds[0][1] != "low" or \
            not shed["low"] >= shed["normal"] >= shed["high"]:
        raise AssertionError(f"qos_resnet50: low priority not shed first: "
                             f"{per}")
    if expired[0] != 504 or expired[2]["status"]["reason"] != \
            "DEADLINE_EXCEEDED":
        raise AssertionError(f"qos_resnet50: expired budget {expired[:3]}")
    fails = [c for c in down_codes if c[0] != 200]
    if len(fails) < 3 or fails != [(503, "TRANSPORT", None)] * len(fails) \
            or down_codes[len(fails):] != [(200, "", "breaker_open")] * 4 \
            or not all(ok(r, k % QOS_IMAGES) for k, r in enumerate(down)
                       if k >= len(fails)):
        raise AssertionError(f"qos_resnet50: breaker and fallback "
                             f"{down_codes[:3]} ... {down_codes[-5:]}")
    if plaunch["int8_matmul"] != 37 * served_primary or \
            claunch["int8_matmul"] != 37 * served_cheap:
        raise AssertionError(f"qos_resnet50: K1 launches {plaunch} "
                             f"{claunch} for {served_primary} and "
                             f"{served_cheap} forwards")
    return {k: plaunch[k] + claunch[k] for k in plaunch}


# ----------------------------------------------------------------------
# slice 4b/4c-i: fused plans, the prediction cache, several predictors
# ----------------------------------------------------------------------

SMOKE_RESNET = "chip_smoke:wire_resnet"
PLAN_IMAGES = 16
CANARY_SEED = 7
CANARY_REQUESTS = 200


def _resnet_graph(int8: bool, ann: dict, node: str = "resnet") -> dict:
    """The port's ``resnet50(-int8).json`` (its batching annotations) with
    ``ann`` added; the node serves ``wire_resnet``'s weights (random
    BatchNorm, so every K1 launch computes something) and is registered
    with ResNet50's signature, which the plan's warm-up reads."""
    from seldon_core_tpu_torch.models import register_signature, signature_for

    register_signature(SMOKE_RESNET, signature_for(
        "seldon_core_tpu_torch.models.resnet:ResNet50Model"))
    name = "resnet50-int8" if int8 else "resnet50"
    d = json.loads((ROOT / "seldon_core_tpu_torch" / "examples"
                    / f"{name}.json").read_text())
    d["spec"]["annotations"].update(ann)
    d["spec"]["predictors"][0]["graph"] = {
        "name": node, "type": "MODEL", "parameters": [
            {"name": "model_class", "value": SMOKE_RESNET,
             "type": "STRING"},
            {"name": "int8", "value": str(int8).lower(), "type": "BOOL"}]}
    return d


def _pinned(x, puid: str = "smoke"):
    from seldon_core_tpu_torch.messages import SeldonMessage

    m = SeldonMessage.from_ndarray(x)
    m.meta.puid = puid
    return m


def _same_answer(a, b) -> bool:
    """Two responses byte-identical: meta, status, names, and the bytes of
    their data (as the wire would carry them)."""
    import numpy as np

    da, db = a.to_dict(), b.to_dict()
    if da.get("meta") != db.get("meta") or da.get("status") != \
            db.get("status"):
        return False
    if (a.data is None) != (b.data is None):
        return False
    if a.data is None:
        return da == db
    ha, hb = a.host_data(), b.host_data()
    return (list(a.names) == list(b.names) and ha.dtype == hb.dtype
            and ha.shape == hb.shape
            and np.ascontiguousarray(ha).tobytes()
            == np.ascontiguousarray(hb).tobytes())


def _fwd_ms(torch, call, reps: int) -> tuple[float, float]:
    """Median host ms until ``call()`` returns, and median wall ms until
    the card has finished it, over ``reps`` calls."""
    host, wall = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def plan_resnet50_phase(torch) -> dict:
    """Full ResNet50, bf16 and int8, booted by the local runner's
    ``LocalDeployment`` from ``resnet50.json`` / ``resnet50-int8.json``
    with ``seldon.io/graph-plan: fused`` and ``-warmup`` (every batcher
    bucket captured as a CUDA graph at boot), batcher on; a walk engine
    over the same components in the same process beside it.  A batch of
    64 and 16 concurrent single images through each engine: every fused
    answer bitwise equal to the walk's, one replay per batch, K1 37
    launches per int8 forward counted across replays, and as many K1
    kernels seen by torch.profiler in one replay.  Reported, not
    gated: capture seconds per bucket, the graph pool's bytes, host ms per
    forward and images/s (fused replay vs the walk's eager forward) at
    batch 1, 8 and 64 on a device-resident batch, peak memory, and the
    median ms of 20 single host images through each engine in turn (the
    batcher's window, H2D, forward, D2H).  Returns the fused engine's
    launches."""
    import numpy as np

    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.operator.local import LocalDeployment

    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (PLAN_IMAGES, 224, 224, 3)).astype(
        np.float32)
    batch = rng.integers(0, 256, (64, 224, 224, 3)).astype(np.float32)
    total = {"int8_matmul": 0, "paged_attention": 0, "flash_attention": 0}
    for label, int8 in (("bf16", False), ("int8", True)):
        d = _resnet_graph(int8, {"seldon.io/graph-plan": "fused",
                                 "seldon.io/graph-plan-warmup": "true"})
        reset_launches()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        local = LocalDeployment(load_deployment(d), seed=0)
        boot_s = time.perf_counter() - t0
        boot_k1 = read_launches()["int8_matmul"]
        fused = local.engine
        seg = fused.plan.segments[0]
        if int8:  # the partition the lint phase predicts offline
            LINT_OBSERVED["plans"]["resnet50-int8"] = (
                d, fused.plan.describe())
        walk = GraphEngine(d["spec"]["predictors"][0]["graph"], name="main",
                           resolver=lambda u, e=fused: e.node_impl(u.name))
        buckets = len(seg.batcher.buckets)
        out = {"phase": "plan_resnet50", "dtype": label,
               "segments": fused.plan.describe()["segments"],
               "boot_s": boot_s, "buckets_captured": len(seg.capture_s),
               "capture_s_by_rows": {str(k[0][0]): v
                                     for k, v in seg.capture_s.items()},
               "pool_bytes": seg.pool_bytes(),
               "allocated_after_boot_bytes":
                   torch.cuda.memory_allocated() - mem0,
               "boot_k1_launches": boot_k1, "card": CARD}
        # a capture runs the stages once eagerly and replays once
        want_boot = 2 * 37 * buckets if int8 else 0
        if len(seg.capture_s) != buckets or boot_k1 != want_boot:
            emit(out)
            raise AssertionError(f"plan {label}: {len(seg.capture_s)} "
                                 f"buckets of {buckets} captured, boot K1 "
                                 f"{boot_k1} (want {want_boot})")

        async def drive(eng, xs):
            return await asyncio.gather(*(eng.predict(_pinned(x))
                                          for x in xs))

        # the walk first: its first-use costs stay out of the fused counts
        w64 = asyncio.run(walk.predict(_pinned(batch)))
        w16 = asyncio.run(drive(walk, [imgs[i:i + 1]
                                       for i in range(PLAN_IMAGES)]))
        calls0, b0 = seg.n_calls, seg.batcher.stats["batches"]
        reset_launches()
        f64 = asyncio.run(fused.predict(_pinned(batch)))
        k1_64 = read_launches()["int8_matmul"]
        calls64 = seg.n_calls - calls0
        reset_launches()
        f16 = asyncio.run(drive(fused, [imgs[i:i + 1]
                                        for i in range(PLAN_IMAGES)]))
        k1_16 = read_launches()["int8_matmul"]
        calls16 = seg.n_calls - calls0 - calls64
        batches16 = seg.batcher.stats["batches"] - b0 - 1
        run = {"int8_matmul": k1_64 + k1_16}
        for k in total:
            total[k] += run.get(k, 0)
        equal64 = _same_answer(w64, f64)
        equal16 = sum(_same_answer(a, b) for a, b in zip(w16, f16))
        ok = all(r.status.status == "SUCCESS" for r in [f64, *f16])
        out.update({
            "batch64_bitwise_equal_walk": equal64,
            "concurrent16_bitwise_equal_walk": equal16,
            "batch64_calls": calls64, "concurrent16_calls": calls16,
            "concurrent16_batches": batches16,
            "k1_launches_batch64": k1_64, "k1_launches_concurrent16": k1_16})
        want = 37 if int8 else 0
        # the counts above are the capture's record added per replay:
        # hold them against the kernels the profiler sees in one replay
        # of the batch-64 bucket (each K1 call is one quantize pass and
        # one product)
        x64 = torch.from_numpy(batch).cuda()
        seen = _kernels_run(torch, lambda: seg(x64))
        seen_k1 = {"quantize": sum(n for k, n in seen.items()
                                   if "quant_rows" in k),
                   "product": sum(n for k, n in seen.items()
                                  if "int8_gemm" in k or "int8_gemv" in k)}
        out["k1_kernels_profiled_one_replay"] = seen_k1
        out["profile_first_device_record_us"] = PROFILE_FIRST_US[-1]
        # where the window's records fell against the replay's own span
        out["profile_window"] = _window_report(PROFILE_WINDOWS[-1],
                                               "quant_rows")
        out["device_kernels_profiled_one_replay"] = sum(seen.values())
        if not (ok and equal64 and equal16 == PLAN_IMAGES and calls64 == 1
                and calls16 == batches16 and k1_64 == want
                and k1_16 == want * batches16
                and seen_k1 == {"quantize": want, "product": want}
                and sum(seen.values()) > 0):
            emit(out)
            raise AssertionError(f"plan_resnet50 {label}: {out}")

        # forward cost on a batch already on the card: the replay against
        # the walk's eager forward (the handle under the batcher)
        handle = fused.node_impl("resnet").handle
        perf = {}
        for B in (1, 8, 64):
            x = torch.from_numpy(batch[:B]).cuda()
            walk_call = (lambda x=x: handle.predict(SeldonMessage(data=x)))
            fused_call = (lambda x=x: seg(x))
            for fn in (walk_call, fused_call):  # warm
                fn()
            torch.cuda.synchronize()
            row = {}
            for mode, fn in (("walk", walk_call), ("fused", fused_call),
                             ("fused_again", fused_call),
                             ("walk_again", walk_call)):
                torch.cuda.reset_peak_memory_stats()
                host, wall = _fwd_ms(torch, fn, 20)
                row[mode] = {"host_ms": host, "wall_ms": wall,
                             "images_per_s": B / wall * 1e3,
                             "peak_bytes": torch.cuda.max_memory_allocated()}
            perf[f"batch{B}"] = row
        out["forward"] = perf
        out["forward_note"] = ("host_ms: until the call returns; wall_ms: "
                               "until the card is done; medians of 20; "
                               "device-resident batch")

        # one image at a time through the engine as a server calls it:
        # host image, batcher (its 2 ms window), H2D, forward, D2H
        async def sequential(eng, n=20):
            ms = []
            for i in range(n):
                t0 = time.perf_counter()
                await eng.predict(_pinned(imgs[i % PLAN_IMAGES:
                                               i % PLAN_IMAGES + 1]))
                ms.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ms)

        out["engine_single_p50_ms"] = {
            mode: asyncio.run(sequential(eng)) for mode, eng in (
                ("walk", walk), ("fused", fused), ("fused_again", fused),
                ("walk_again", walk))}
        emit(out)
        del local, fused, walk, seg, handle
        torch.cuda.empty_cache()
    return total


def plan_graphs_phase(torch) -> None:
    """Every BASELINE graph (the MAB router seeded: a router root over two
    fused segments; iris-with-outlier: the learning transformer a boundary
    above a fused model) booted twice on the card, walk and fused, the
    walk's components sharing the fused components' weights: every answer
    of ``_graph_requests`` byte-identical, one call per segment per
    request."""
    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.operator.local import LocalDeployment

    for name in GRAPHS:
        base = json.loads((ROOT / "seldon_core_tpu_torch" / "examples"
                           / f"{name}.json").read_text())
        if name == "epsilon-greedy-mab":
            base["spec"]["predictors"][0]["graph"]["parameters"].append(
                {"name": "seed", "value": "11", "type": "INT"})
        deps = {}
        for mode in ("walk", "fused"):
            d = json.loads(json.dumps(base))
            d["spec"]["annotations"]["seldon.io/graph-plan"] = mode
            deps[mode] = LocalDeployment(load_deployment(d), seed=0)
        walk, fused = deps["walk"].engine, deps["fused"].engine
        LINT_OBSERVED["plans"][name] = (d, fused.plan.describe())
        for unit in deps["walk"].spec.graph.walk():
            if unit.implementation:
                continue
            wu = getattr(walk.node_impl(unit.name), "handle",
                         walk.node_impl(unit.name)).user
            fu = getattr(fused.node_impl(unit.name), "handle",
                         fused.node_impl(unit.name)).user
            if hasattr(fu, "params"):
                wu.params = fu.params
        segs = fused.plan.segments
        bodies = _graph_requests(name)

        async def run():
            equal = 0
            for i, body in enumerate(bodies):
                a = await walk.predict(SeldonMessage.from_dict(
                    {**body, "meta": {"puid": f"p{i}"}}))
                b = await fused.predict(SeldonMessage.from_dict(
                    {**body, "meta": {"puid": f"p{i}"}}))
                if a.status.status != "SUCCESS":
                    raise AssertionError(f"plan_graphs {name}: {a.status}")
                equal += _same_answer(a, b)
            return equal

        equal = asyncio.run(run())
        calls = sum(s.n_calls for s in segs)
        line = {"phase": "plan_graphs", "graph": name,
                "requests": len(bodies), "bitwise_equal_walk": equal,
                "segments": [s.label for s in segs],
                "boundaries": [b for b, _ in fused.plan.boundaries],
                "segment_calls": calls,
                "buckets_captured": sum(len(s.capture_s) for s in segs),
                "card": CARD}
        emit(line)
        # one call per request through each segment on its path (the MAB
        # router takes one branch)
        if equal != len(bodies) or calls != len(bodies):
            raise AssertionError(f"plan_graphs {name}: {line}")


def cache_resnet50_phase(torch) -> dict:
    """The int8 ResNet50 fused (``resnet50-int8.json``'s batcher) with
    ``seldon.io/prediction-cache`` on: a repeated image (10 times) is a hit
    that launches no kernel and answers bitwise equal to its miss (its ms
    reported: the first and the median); 16 identical concurrent requests
    of a new image make one batch row (15 coalesced).  Returns the
    launches of those requests."""
    import numpy as np

    from seldon_core_tpu_torch.graph.spec import load_deployment
    from seldon_core_tpu_torch.operator.local import LocalDeployment

    rng = np.random.default_rng(17)
    a, b = (rng.integers(0, 256, (1, 224, 224, 3)).astype(np.float32)
            for _ in range(2))
    d = _resnet_graph(True, {"seldon.io/graph-plan": "fused",
                             "seldon.io/prediction-cache": "true",
                             "seldon.io/spec-hash": "smoke"})
    local = LocalDeployment(load_deployment(d), seed=0)
    eng = local.engine
    seg, cache = eng.plan.segments[0], eng.cache
    hit_ms = []

    async def run():
        miss = await eng.predict(_pinned(a))
        reset_launches()
        calls0 = seg.n_calls
        for _ in range(10):
            t0 = time.perf_counter()
            hit = await eng.predict(_pinned(a))
            hit_ms.append((time.perf_counter() - t0) * 1e3)
        k1_hit, calls_hit = read_launches()["int8_matmul"], \
            seg.n_calls - calls0
        rows0, c0 = seg.batcher.stats["rows"], cache.coalesced
        reset_launches()
        storm = await asyncio.gather(*(eng.predict(_pinned(b))
                                       for _ in range(16)))
        k1_storm = read_launches()["int8_matmul"]
        return (miss, hit, k1_hit, calls_hit, storm, k1_storm,
                seg.batcher.stats["rows"] - rows0, cache.coalesced - c0)

    miss, hit, k1_hit, calls_hit, storm, k1_storm, rows, coalesced = \
        asyncio.run(run())
    storm_equal = sum(_same_answer(storm[0], s) for s in storm)
    out = {"phase": "cache_resnet50", "hit_bitwise_equal_miss":
           _same_answer(miss, hit), "hit_k1_launches": k1_hit,
           "hit_segment_calls": calls_hit, "identical16_batch_rows": rows,
           "identical16_coalesced": coalesced,
           "identical16_k1_launches": k1_storm,
           "identical16_equal": storm_equal, "first_hit_ms": hit_ms[0],
           "hit_p50_ms": statistics.median(hit_ms),
           "stats": cache.stats,
           "card": CARD}
    emit(out)
    if not (out["hit_bitwise_equal_miss"] and k1_hit == 0 and calls_hit == 0
            and rows == 1 and coalesced == 15 and k1_storm == 37
            and storm_equal == 16):
        raise AssertionError(f"cache_resnet50: {out}")
    return {"int8_matmul": k1_hit + k1_storm, "paged_attention": 0,
            "flash_attention": 0}


def canary_phase(torch) -> dict:
    """Two predictors behind the runner's REST (``serve(seed=CANARY_SEED)``):
    ``main`` the bf16 ResNet50 at replicas 3, ``canary`` the int8 one at
    replicas 1, ``resnet50.json``'s batching.  200 sequential requests over
    8 images: the predictor that answered each (its node in
    ``requestPath``) is the seeded sequence of ``random.Random(seed)``
    split 3:1, drawn here independently, and every answer is byte-equal to
    its predictor's in-process answer for that image.  Returns the
    launches of the 200."""
    import random

    import numpy as np

    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.operator.local import serve

    bf16, int8 = (_resnet_graph(q, {}, node=f"resnet-{lab}")
                  for q, lab in ((False, "bf16"), (True, "int8")))
    d = {"metadata": {"name": "canary"}, "spec": {
        "name": "canary", "annotations": bf16["spec"]["annotations"],
        "predictors": [
            {"name": "main", "replicas": 3,
             "graph": bf16["spec"]["predictors"][0]["graph"]},
            {"name": "canary", "replicas": 1,
             "graph": int8["spec"]["predictors"][0]["graph"]}]}}
    imgs = np.random.default_rng(19).integers(0, 256, (8, 1, 224, 224, 3))
    bodies = [{"data": {"ndarray": im.tolist()}} for im in imgs]
    draw = random.Random(CANARY_SEED)
    want = ["resnet-bf16" if draw.random() <= 0.75 else "resnet-int8"
            for _ in range(CANARY_REQUESTS)]

    async def run():
        server, local = await serve(d, port=0, host="127.0.0.1",
                                    seed=CANARY_SEED)
        try:
            ref = {}
            for p in local.predictors:
                node = p.spec.graph.name
                for i, body in enumerate(bodies):
                    ref[node, i] = (await p.engine.predict(
                        SeldonMessage.from_dict(body))).to_dict()["data"]
            reset_launches()
            got, lat = [], []
            for n in range(CANARY_REQUESTS):
                code, res, dt = await asyncio.to_thread(
                    _post_timed, server.port, bodies[n % 8])
                if code != 200:
                    raise AssertionError(f"canary: HTTP {code} {res}")
                node = next(iter(res["meta"]["requestPath"]))
                got.append((node, res["data"] == ref[node, n % 8]))
                lat.append(dt * 1e3)
            return got, lat, read_launches()
        finally:
            await server.stop()

    got, lat, launched = asyncio.run(run())
    picks = [g[0] for g in got]
    out = {"phase": "canary", "requests": CANARY_REQUESTS,
           "replicas": {"main (bf16)": 3, "canary (int8)": 1},
           "picked_int8": picks.count("resnet-int8"),
           "picks_equal_seeded_sequence": picks == want,
           "answers_equal_in_process": sum(g[1] for g in got),
           "k1_launches": launched["int8_matmul"], **_pctl(lat),
           "card": CARD}
    emit(out)
    if not (picks == want and out["answers_equal_in_process"]
            == CANARY_REQUESTS
            and launched["int8_matmul"] == 37 * out["picked_int8"]):
        raise AssertionError(f"canary: {out}")
    return launched


# ----------------------------------------------------------------------

ART_SINGLES = 4


def _bin_body(x) -> bytes:
    """A binTensor request body for a float32 array."""
    import base64

    return json.dumps({"data": {"binTensor": {
        "shape": list(x.shape), "dtype": "float32",
        "b64": base64.b64encode(x.tobytes()).decode()}}}).encode()


def _child_launches(prefix) -> dict:
    """The launch counts a runner child's processes wrote at exit."""
    got = {"int8_matmul": 0, "paged_attention": 0, "flash_attention": 0}
    for f in WIRE_DIR.glob(f"{Path(prefix).name}.*.json"):
        for k, v in read_child_launches(f).items():
            got[k] = got.get(k, 0) + v
    return got


def artifacts_resnet50_phase(torch) -> dict:
    """Slice 4d on the card: int8 ResNet50 fused at full width (BASELINE
    config 3, ``wire_resnet``'s weights) behind a runner child with
    ``seldon.io/artifact-store`` on a fresh directory and batching off.

    (1) cold: boot captures the batch-1 bucket (precompile) and publishes
    it and the kernel library; ART_SINGLES singles, a batch of 8 and one of
    64 follow, the two batches captured live at first sight and published.
    (2) warm (same store) and (3) a copy of the store with the batch-8
    record's probe digest corrupted, booted together: the warm child
    captures every published bucket at boot, each probe digest equal,
    loads the kernel library from the store (no nvcc), captures nothing on
    the request path and tags every answer ``aot-cache``; the third
    quarantines the corrupted bucket, captures it live at first sight and
    serves the rest from boot.  Every answer of (2) and (3) is bitwise
    equal to (1)'s.  Per child: boot seconds, capture seconds at boot,
    captures on the request path, first-request ms at batch 1 and 64,
    quarantines, ``/admin/artifacts?coverage=1`` and its K1 launches."""
    import shutil

    import numpy as np

    WIRE_DIR.mkdir(parents=True, exist_ok=True)
    store = WIRE_DIR / "artifact_store"
    shutil.rmtree(store, ignore_errors=True)
    rng = np.random.default_rng(21)
    traffic = [("b1", rng.integers(0, 256, (1, 224, 224, 3)).astype(
        np.float32)) for _ in range(ART_SINGLES)]
    traffic += [("b8", rng.integers(0, 256, (8, 224, 224, 3)).astype(
        np.float32)), ("b64", rng.integers(0, 256, (64, 224, 224, 3))
                       .astype(np.float32))]

    def graph(root, name):
        path = WIRE_DIR / f"graph_{name}.json"
        path.write_text(json.dumps(_resnet_graph(True, {
            "seldon.io/graph-plan": "fused", "seldon.io/batching": "false",
            "seldon.io/artifact-store": str(root)})))
        return path

    def boot(label, root):
        t0 = time.perf_counter()
        child, counts = runner_child(label, [
            "--graph", str(graph(root, label)), "--port", "0",
            "--host", "127.0.0.1", "--grpc-port", "0"])
        return child, counts, t0

    def serve(child, counts, t0):
        port = child.port("serving deployment")
        boot_s = time.perf_counter() - t0
        at_boot = json.loads(_get(port, "/admin/artifacts")[1])
        answers, first, tags = [], {}, set()
        for name, x in traffic:
            code, body, dt = _post_raw(port, "/api/v0.1/predictions",
                                       _bin_body(x))
            if code != 200:
                raise AssertionError(f"artifacts {child.label}: {code} "
                                     f"{str(body)[:300]}")
            first.setdefault(name, dt * 1e3)
            answers.append(body["data"])
            tags.add(body["meta"]["tags"].get("artifact-source"))
        after = json.loads(_get(port, "/admin/artifacts")[1])
        cov = json.loads(_get(port, "/admin/artifacts?coverage=1")[1])
        child.stop()
        seg = at_boot["segments"][0]
        return {
            "boot_s": boot_s,
            "boot_buckets": seg["buckets"],
            "capture_s_at_boot": sum(
                b.get("hydrate_ms", 0.0) / 1e3 if b["source"] == "aot-cache"
                else b.get("capture_s", 0.0)
                for b in seg["buckets"].values()),
            "hydrated_at_boot": at_boot["hydrated"],
            "live_at_boot": at_boot["liveCompiles"],
            "request_path_captures": after["liveCompiles"]
            - at_boot["liveCompiles"],
            "first_request_ms": first,
            "quarantined": after["quarantined"],
            "parity_failures": after["parityFailures"],
            "published": after["published"],
            "kernel_library": after.get("kernelLibrary"),
            "artifact_source_tags": sorted(tags),
            "coverage": cov,
            "store_stats": after.get("storeStats"),
            "launches": _child_launches(counts),
        }, answers

    out = {"phase": "artifacts_resnet50", "card": CARD,
           "model": "int8 ResNet50 (3, 4, 6, 3), 224x224x3, 1000 classes, "
                    "fused, batching off",
           "traffic": [n for n, _ in traffic]}
    cold, cold_answers = serve(*boot("art_cold", store))
    out["cold"] = cold
    # the batch-8 record's probe digest, corrupted in a copy of the store
    bad_store = WIRE_DIR / "artifact_store_bad"
    shutil.rmtree(bad_store, ignore_errors=True)
    shutil.copytree(store, bad_store)
    bad = [p for p in bad_store.rglob("*.json")
           if json.loads(p.read_text()).get("bucketShape", [0])[0] == 8]
    if len(bad) != 1:
        raise AssertionError(f"artifacts: batch-8 records {bad}")
    sc = json.loads(bad[0].read_text())
    sc["probeDigest"] = "0" * 32
    bad[0].write_text(json.dumps(sc))
    warm_child = boot("art_warm", store)
    bad_child = boot("art_corrupt", bad_store)
    warm, warm_answers = serve(*warm_child)
    corrupt, bad_answers = serve(*bad_child)
    out["warm"], out["corrupt"] = warm, corrupt
    out["warm_bitwise_equal_cold"] = sum(
        a == b for a, b in zip(warm_answers, cold_answers))
    out["corrupt_bitwise_equal_cold"] = sum(
        a == b for a, b in zip(bad_answers, cold_answers))
    emit(out)
    n = len(traffic)
    checks = {
        "cold boot captured bucket 1 live": cold["live_at_boot"] == 1
        and cold["hydrated_at_boot"] == 0,
        "cold captured b8 and b64 on the request path":
            cold["request_path_captures"] == 2 and cold["published"] == 3,
        "cold published the kernel library":
            (cold["kernel_library"] or {}).get("source") in ("live",
                                                              "aot-cache"),
        "warm captured every bucket at boot": warm["hydrated_at_boot"] == 3
        and warm["live_at_boot"] == 0 and warm["quarantined"] == 0,
        "warm made no capture on the request path":
            warm["request_path_captures"] == 0,
        "warm tagged aot-cache": warm["artifact_source_tags"]
        == ["aot-cache"],
        "warm loaded the library from the store":
            (warm["kernel_library"] or {}).get("source") == "aot-cache",
        "warm bitwise equal": out["warm_bitwise_equal_cold"] == n,
        "corrupt quarantined one": corrupt["quarantined"] == 1
        and corrupt["parity_failures"] == 1
        and corrupt["hydrated_at_boot"] == 2,
        "corrupt captured it live at first sight":
            corrupt["request_path_captures"] == 1,
        "corrupt bitwise equal": out["corrupt_bitwise_equal_cold"] == n,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"artifacts_resnet50: {failed}")
    launches = {k: cold["launches"][k] + warm["launches"][k]
                + corrupt["launches"][k] for k in cold["launches"]}
    if min(c["launches"]["int8_matmul"] for c in (cold, warm, corrupt)) \
            <= 0:
        raise AssertionError(f"artifacts_resnet50: K1 launches {launches}")
    return launches


DP_IMAGES = 16


def _metric_values(text: str, name: str) -> dict:
    """``{labels: value}`` of one Prometheus series family."""
    got = {}
    for ln in text.splitlines():
        if ln.startswith(name):
            head, _, val = ln.rpartition(" ")
            got[head[len(name):] or "{}"] = float(val)
    return got


def device_plane_resnet50_phase(torch) -> dict:
    """Slice 4e on the card: ``wire_resnet50``'s topology at int8, a
    runner child whose node's endpoint is a REST component child, plus a
    FRAMED component child called from this process.  With
    ``seldon.io/device-plane: "true"`` and with the plane off: DP_IMAGES
    singles and a batch of 64 through the runner, the singles through the
    framed client, every answer bitwise equal between the modes and to the
    in-process graph; the runner's hop and the framed connection both
    negotiate the ``shm`` tier, and the framed connection's pooled lane is
    one segment for every message.  In process: a SIMPLE_ROUTER (meta
    only) over a model on the card copies nothing from the card with the
    plane on (its D2H bytes: tensors ``SeldonMessage.host_data`` copies
    from the card during the walk), at least the input with it off.
    p50/p95 per mode and the planes' counters."""
    import numpy as np

    from seldon_core_tpu_torch import messages
    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.component import ComponentHandle
    from seldon_core_tpu_torch.runtime.device_plane import (
        DevicePlane,
        DevicePlaneConfig,
    )
    from seldon_core_tpu_torch.serving.framed import FramedClient

    rng = np.random.default_rng(31)
    imgs = rng.integers(0, 256, (DP_IMAGES, 224, 224, 3)).astype(np.float32)
    batch = rng.integers(0, 256, (64, 224, 224, 3)).astype(np.float32)
    params = json.dumps([{"name": "int8", "value": "true", "type": "BOOL"}])
    env = {"PREDICTIVE_UNIT_ID": "resnet"}
    kids = {api: component_child(f"dp_{api.lower()}", [
        "chip_smoke:wire_resnet", api, "--parameters", params,
        "--port", "0"], env) for api in ("REST", "FRAMED")}
    runners = {}
    out = {"phase": "device_plane_resnet50", "card": CARD,
           "model": "int8 ResNet50 (3, 4, 6, 3), 224x224x3, 1000 classes",
           "images": DP_IMAGES}
    try:
        cport = kids["REST"][0].port("serving on")
        for mode in ("on", "off"):
            ann = {"seldon.io/rest-read-timeout": "300000"}
            if mode == "on":
                ann["seldon.io/device-plane"] = "true"
            g = {"spec": {"name": f"dp-{mode}", "annotations": ann,
                          "predictors": [{"name": "main", "graph": {
                              "name": "resnet", "type": "MODEL",
                              "endpoint": {"service_host": "127.0.0.1",
                                           "service_port": cport,
                                           "type": "REST"}}}]}}
            path = WIRE_DIR / f"graph_dp_{mode}.json"
            path.write_text(json.dumps(g))
            LINT_OBSERVED["device_plane"][mode] = {"spec": g}
            runners[mode] = Child([sys.executable, "-m",
                                   "seldon_core_tpu_torch.operator.local",
                                   "--graph", str(path), "--port", "0",
                                   "--host", "127.0.0.1", "--grpc-port", "0"],
                                  label=f"dp_runner_{mode}")
        # the in-process graph's answers while the children boot
        local = ComponentHandle(wire_resnet(True), name="resnet")
        graph = GraphEngine({"name": "resnet", "type": "MODEL"},
                            resolver=lambda u: local)

        def in_process(x):
            return np.asarray(asyncio.run(graph.predict(
                SeldonMessage.from_ndarray(x))).to_dict()["data"]["ndarray"],
                np.float32)

        want = [in_process(imgs[i:i + 1]) for i in range(DP_IMAGES)]
        want64 = in_process(batch)
        del local, graph
        torch.cuda.empty_cache()
        fport = kids["FRAMED"][0].port("serving FRAMED on")
        res = {}
        for mode in ("on", "off"):
            eport = runners[mode].port("serving deployment")
            _post_raw(eport, "/api/v0.1/predictions", _bin_body(imgs[:1]))
            seq = [_post_raw(eport, "/api/v0.1/predictions",
                             _bin_body(imgs[i:i + 1]))
                   for i in range(DP_IMAGES)]
            code, b64, dt64 = _post_raw(eport, "/api/v0.1/predictions",
                                        _bin_body(batch))
            got = [np.asarray(s[1]["data"]["ndarray"], np.float32)
                   if s[0] == 200 else None for s in seq]
            got64 = np.asarray(b64["data"]["ndarray"], np.float32) \
                if code == 200 else None
            metrics = _get(eport, "/metrics")[1]
            plane = DevicePlane(DevicePlaneConfig(enabled=mode == "on"))
            cli = FramedClient(port=fport, timeout=300,
                               device_plane=plane if mode == "on" else None)
            try:
                cli.predict(SeldonMessage.from_ndarray(imgs[:1]))
                lane0 = cli._lane._shm.name if cli._lane else None
                fr = []
                for i in range(DP_IMAGES):
                    t0 = time.perf_counter()
                    o = cli.predict(SeldonMessage.from_ndarray(
                        imgs[i:i + 1]))
                    fr.append((o, time.perf_counter() - t0))
                lane1 = cli._lane._shm.name if cli._lane else None
                gen = cli._lane._gen if cli._lane else 0
                framed_mode = cli._device_mode
            finally:
                cli.close()
            res[mode] = {
                "rest": {**_pctl([s[2] * 1e3 for s in seq]),
                         "bitwise_equal_in_process": sum(
                             g is not None and np.array_equal(g, w)
                             for g, w in zip(got, want)),
                         "batch64_ms": dt64 * 1e3,
                         "batch64_bitwise_equal": got64 is not None
                         and np.array_equal(got64, want64),
                         "answers": got,
                         "runner_plane": {
                             k: _metric_values(metrics, f"seldon_device_"
                                                        f"plane_{k}_total")
                             for k in ("remote_refs", "transfers_avoided",
                                       "downgrades", "donations")},
                         "runner_transfer_bytes": _metric_values(
                             metrics, "seldon_device_registry_transfer_"
                                      "bytes_total")},
                "framed": {**_pctl([t * 1e3 for _, t in fr]),
                           "negotiated": framed_mode,
                           "lane_reused": lane0 is not None
                           and lane0 == lane1,
                           "lane_messages": gen,
                           "bitwise_equal_in_process": sum(
                               np.array_equal(np.asarray(o.host_data(),
                                                         np.float32), w)
                               for (o, _), w in zip(fr, want)),
                           "client_plane": plane.snapshot()}}
            LINT_OBSERVED["device_plane"][mode].update(
                runner_plane=res[mode]["rest"]["runner_plane"],
                requests=DP_IMAGES + 2)
        on, off = res["on"], res["off"]
        modes_equal = sum(
            a is not None and b is not None and np.array_equal(a, b)
            for a, b in zip(on["rest"].pop("answers"),
                            off["rest"].pop("answers")))
        out.update(res)
        out["rest_modes_bitwise_equal"] = modes_equal
    finally:
        for r in runners.values():
            r.stop()
        for child, _ in kids.values():
            child.stop()
    launches = {"int8_matmul": 0, "paged_attention": 0, "flash_attention": 0}
    for api, (child, counts) in kids.items():
        got = read_child_launches(counts)
        out[f"{api.lower()}_component_launches"] = got
        for k in launches:
            launches[k] += got[k]

    # the meta-only route in process: D2H bytes copied by host_data
    copied = [0]
    real = messages._to_numpy

    def counting(x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            copied[0] += x.numel() * x.element_size()
        return real(x)

    class Twice:
        accepts_tensors = True

        def predict(self, X, names):
            return X * 2

    spec = {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
            "children": [{"name": "m", "type": "MODEL"}]}
    x = torch.ones((64, 224, 224, 3), device="cuda")
    route = {}
    messages._to_numpy = counting
    try:
        for mode in ("on", "off"):
            plane = DevicePlane(DevicePlaneConfig(enabled=mode == "on"))
            eng = GraphEngine(spec, resolver=lambda u: ComponentHandle(
                Twice(), name="m"), device_plane=plane)
            copied[0] = 0
            o = asyncio.run(eng.predict(SeldonMessage.from_ndarray(x)))
            torch.cuda.synchronize()
            route[mode] = {"d2h_bytes": copied[0],
                           "answer_on_card": bool(o.data.is_cuda),
                           "plane": plane.snapshot()}
    finally:
        messages._to_numpy = real
    out["meta_only_route"] = route
    emit(out)
    checks = {
        "rest answers bitwise equal to in-process (on)":
            on["rest"]["bitwise_equal_in_process"] == DP_IMAGES,
        "rest answers bitwise equal to in-process (off)":
            off["rest"]["bitwise_equal_in_process"] == DP_IMAGES,
        "rest modes bitwise equal": modes_equal == DP_IMAGES,
        "batch 64 bitwise": on["rest"]["batch64_bitwise_equal"]
        and off["rest"]["batch64_bitwise_equal"],
        "runner hop negotiated shm":
            on["rest"]["runner_plane"]["remote_refs"].get(
                '{mode="shm"}', 0) >= DP_IMAGES,
        "framed negotiated shm": on["framed"]["negotiated"] == "shm",
        "framed lane reused": on["framed"]["lane_reused"]
        and on["framed"]["lane_messages"] == DP_IMAGES + 1,
        "framed bitwise equal": on["framed"]["bitwise_equal_in_process"]
        == DP_IMAGES and off["framed"]["bitwise_equal_in_process"]
        == DP_IMAGES,
        "no downgrade": not on["rest"]["runner_plane"]["downgrades"]
        and not on["framed"]["client_plane"]["downgrades"],
        "meta-only route copies nothing (on)":
            route["on"]["d2h_bytes"] == 0,
        "the route copies the input (off)": route["off"]["d2h_bytes"] >= 1,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"device_plane_resnet50: {failed}")
    return launches


# ---------------------------------------------------------------------------
# slice 5-i: tracing, the health plane and the profiling plane on the card
# ---------------------------------------------------------------------------

#: the weights ``observe_7b_llm`` serves (set by ``observe_7b_phase``)
OBSERVE_7B: dict = {}
#: measured bursts of ``serve_7b``'s 8 prompts per deployment and turn
OBSERVE_BURSTS = 3
#: the kernels' ``__global__`` names in ``csrc/``, by kernel
KERNEL_NAMES = {
    "int8_matmul": ("quant_rows_kernel", "int8_gemv_kernel",
                    "int8_gemm_kernel"),
    "paged_attention": ("paged_decode_kernel",),
    "flash_attention": ("flash_fwd_mma_kernel", "flash_fwd_simt_kernel"),
}


def observe_7b_llm(device: str = "cuda"):
    """The ``observe_7b`` graph's node: ``serve_7b``'s engine and knobs
    (96 pages of 16, 8 slots, max_len 256, 16 new tokens) over the weights
    the phase hands over in ``OBSERVE_7B``."""
    from seldon_core_tpu_torch.runtime.llm import LLMComponent, PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig

    engine = PagedLLMEngine(OBSERVE_7B["params"], _cfg_7b(32),
                            PagedConfig(n_pages=96, page_size=16),
                            max_slots=8, max_len=256)
    return LLMComponent(engine, n_new=16)


def _observe_7b_graph(planes: bool) -> dict:
    ann = {"seldon.io/batching": "false"}
    if planes:
        ann.update({"seldon.io/tracing": "true",
                    "seldon.io/trace-sample": "1",
                    "seldon.io/health": "true",
                    "seldon.io/health-sample-ms": "250",
                    "seldon.io/profile": "true"})
    return {"metadata": {"name": "observe-7b", "annotations": ann},
            "spec": {"predictors": [{"name": "main", "graph": {
                "name": "llm", "type": "MODEL", "parameters": [
                    {"name": "model_class", "type": "STRING",
                     "value": "chip_smoke:observe_7b_llm"}]}}]}}


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


def _get_json(port: int, path: str) -> tuple:
    code, text = _get(port, path)
    return code, json.loads(text)


def _trace_kernels(logdir: Path) -> tuple:
    """``({kernel: count of its device events}, trace bytes, device
    events)`` of the Chrome trace a capture window wrote into ``logdir``."""
    files = sorted(logdir.glob("trace-*.json"))
    if len(files) != 1:
        raise AssertionError(f"observe_7b: {len(files)} traces in {logdir}")
    size = files[0].stat().st_size
    events = json.loads(files[0].read_text()).get("traceEvents", [])
    device = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    seen = {k: sum(1 for e in device
                   if any(n in str(e.get("name", "")) for n in names))
            for k, names in KERNEL_NAMES.items()}
    return seen, size, len(device)


def observe_7b_phase(torch, params) -> dict:
    """``serve_7b``'s model (32 layers, its weights) behind the local
    runner's REST as a one-node graph, in turns with the planes off, on
    (``seldon.io/tracing`` at sample rate 1, ``seldon.io/health``,
    ``seldon.io/profile``) and off again; each deployment takes
    ``serve_7b``'s 8 prompts once to capture its programs and then
    ``OBSERVE_BURSTS`` times, measured, every request with its own
    ``traceparent`` when the planes are on.  Gated: ids
    equal ``serve_7b``'s; each answer's ``trace-id`` the sent one and
    ``/trace?puid=`` its span tree under it, parented by the sent span;
    ``/admin/introspect``'s device probe in use above the weights' bytes
    and at most its limit, from ``torch.cuda``; ``/admin/flightrecorder``
    a 200 record for each of the 8; ``/admin/health`` a verdict; a capture
    window (``/admin/profile/capture?seconds=30&device=<dir>``) over a
    second burst with a 200-token prompt (a new prefill shape, captured
    inside the window) whose ids equal the same prompt's eager ones, and
    a second window under ``programs.eager()``: one of the two traces
    names K1's and K2's kernels (and K3's, a prefill ran in both), and
    the window's host table is not empty.  Reported: TTFT/TPOT and
    tokens/s per burst and their medians per mode (planes off: 6 bursts
    over two deployments; on: 3), captures inside the window, the traces'
    bytes and kernel events.  Returns the phase's launches."""
    import shutil

    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.runtime import programs

    OBSERVE_7B["params"] = params
    prompts, want = SERVE_7B["prompts"], SERVE_7B["ids"]
    bodies = [{"jsonData": {"prompt_ids": p, "n_new": 16}} for p in prompts]
    rng = torch.Generator().manual_seed(11)
    long_body = {"jsonData": {"prompt_ids": torch.randint(
        1, 32000, (200,), generator=rng).tolist(), "n_new": 16}}
    tdir = ROOT / "build" / "observe_7b"
    shutil.rmtree(tdir, ignore_errors=True)
    weights = _tree_bytes(params)
    out = {"phase": "observe_7b", "weights_bytes": weights, "card": CARD}
    failed = []

    def tps(tag: int) -> list:
        return [(f"{tag:08x}{i:024x}", f"{i + 1:016x}") for i in range(8)]

    async def burst(port, bods, parents=None):
        parents = parents or [None] * len(bods)
        return await _in_threads(_post, [
            (port, b, {"traceparent": f"00-{p[0]}-{p[1]}-01"} if p else None)
            for b, p in zip(bods, parents)])

    def ids_of(answers, what):
        got = []
        for code, body in answers:
            if code != 200:
                raise AssertionError(f"observe_7b {what}: HTTP {code}: "
                                     f"{body}")
            got.append(body["jsonData"]["ids"])
        return got

    async def observe(port, local, engine, answers, parents):
        loop = asyncio.get_running_loop()

        async def get(path):
            return await loop.run_in_executor(None, _get_json, port, path)

        res = {}
        # traces: the sent ids, the span tree under each
        tree_ok = 0
        for (code, body), (tid, sid) in zip(answers, parents):
            puid = body["meta"]["puid"]
            c, tr = await get(f"/trace?puid={puid}")
            kids = [(k["name"], k["kind"]) for k in tr.get("children", ())]
            if (body["meta"]["tags"].get("trace-id") == tid and c == 200
                    and tr.get("trace_id") == tid
                    and tr.get("parent_span_id") == sid
                    and ("llm", "MODEL") in kids):
                tree_ok += 1
        res["traces_ok"] = tree_ok
        if tree_ok != len(answers):
            failed.append(f"traces {tree_ok} of {len(answers)}")
        # device memory from torch.cuda, after a sample past the burst
        t_after = time.time()
        for _ in range(100):
            c, intro = await get("/admin/introspect?n=1&probe=device")
            s = intro.get("samples") or [{}]
            if s[-1].get("ts", 0) > t_after:
                break
            await asyncio.sleep(0.1)
        dev = s[-1].get("probes", {}).get("device", {})
        res["introspect_device"] = dev
        res["sampler"] = (await get("/admin/introspect?stats=1"))[1]["stats"]
        if not (weights < dev.get("hbm_bytes_in_use", 0)
                <= dev.get("hbm_bytes_limit", 0)) or "host_rss_bytes" in dev:
            failed.append(f"device probe {dev}")
        # the flight recorder: each measured request, 200
        c, fr = await get("/admin/flightrecorder?n=1000")
        codes = {r["puid"]: r["status"] for r in fr.get("records", ())}
        mine = [codes.get(b["meta"]["puid"]) for _, b in answers]
        res["flight_records"] = {"recorded": fr.get("stats", {}).get(
            "recorded"), "measured_200": sum(x == 200 for x in mine)}
        if mine != [200] * len(answers):
            failed.append(f"flight records {mine}")
        c, verdict = await get("/admin/health")
        res["health"] = {k: verdict.get(k) for k in ("verdict", "signals")}
        if c != 200 or verdict.get("verdict") not in ("ok", "warn",
                                                      "critical"):
            failed.append(f"health {c} {verdict}")
        # window A: graphs; the long prompt's prefill shape is new
        stats0 = engine.program_stats()["programs"]
        c, w = await get(f"/admin/profile/capture?seconds=30&device="
                         f"{tdir / 'graphs'}")
        if c != 200 or w.get("device") is None:
            raise AssertionError(f"observe_7b: capture window {c} {w}")
        t0 = time.perf_counter()
        a_answers = await burst(port, bodies + [long_body])
        a_s = time.perf_counter() - t0
        c, wa = await get(f"/admin/profile/capture?id={w['id']}&stop=1")
        stats1 = engine.program_stats()["programs"]
        a_ids = ids_of(a_answers, "window burst")
        if a_ids[:8] != want:
            failed.append("window burst ids differ from serve_7b's")
        res["window_graphs"] = {
            "burst_s": a_s, "samples": wa.get("samples"),
            "stacks": wa.get("stacks"),
            "captures_in_window": {
                k: stats1[k]["captures"] - stats0[k]["captures"]
                for k in stats1 if stats1[k]["captures"]
                != stats0[k]["captures"]}}
        if not (wa.get("done") and wa.get("stacks", 0) > 0
                and wa.get("folded")):
            failed.append(f"window host table {wa.get('stacks')}")
        seen_a, bytes_a, dev_a = _trace_kernels(tdir / "graphs")
        res["window_graphs"].update(kernels=seen_a, trace_bytes=bytes_a,
                                    device_events=dev_a)
        # window B: the same programs eagerly
        with programs.eager():
            c, w = await get(f"/admin/profile/capture?seconds=30&device="
                             f"{tdir / 'eager'}")
            t0 = time.perf_counter()
            b_answers = await burst(port, [bodies[0], long_body])
            b_s = time.perf_counter() - t0
            c, wb = await get(f"/admin/profile/capture?id={w['id']}&stop=1")
        b_ids = ids_of(b_answers, "eager window burst")
        seen_b, bytes_b, dev_b = _trace_kernels(tdir / "eager")
        res["window_eager"] = {"burst_s": b_s, "samples": wb.get("samples"),
                               "stacks": wb.get("stacks"), "kernels": seen_b,
                               "trace_bytes": bytes_b,
                               "device_events": dev_b}
        if b_ids != [a_ids[0], a_ids[8]]:
            failed.append("the window's graph ids differ from eager ids")
        need = ("int8_matmul", "paged_attention", "flash_attention")
        named = [n for n, seen in (("graphs", seen_a), ("eager", seen_b))
                 if all(seen[k] > 0 for k in need)]
        res["kernels_named_in"] = named
        if not named:
            failed.append(f"no trace names K1, K2 and K3: {seen_a} {seen_b}")
        c, cap = await get("/admin/profile/capacity")
        res["capacity"] = {k: cap.get(k) for k in ("deviceKind",
                                                   "devicePeakTflops")}
        return res

    async def run(planes: bool, turn: int) -> dict:
        server, local = await serve(_observe_7b_graph(planes), port=0,
                                    host="127.0.0.1")
        engine = local.engine.node_impl("llm").user.engine
        try:
            ids_of(await burst(server.port, bodies), "warm-up")
            bursts = []
            for i in range(OBSERVE_BURSTS):
                parents = tps(0xA0 + 16 * turn + i) if planes else None
                t0 = time.perf_counter()
                answers = await burst(server.port, bodies, parents)
                wall = time.perf_counter() - t0
                log = _latencies(engine, t0)
                if ids_of(answers, "burst") != want:
                    mode = "on" if planes else "off"
                    failed.append(f"ids with planes {mode} differ from "
                                  "serve_7b's")
                bursts.append({
                    "ttft_ms_median": statistics.median(
                        x["ttft_s"] for x in log) * 1e3,
                    "tpot_ms_median": statistics.median(
                        x["tpot_s"] for x in log
                        if x["tpot_s"] is not None) * 1e3,
                    "tokens_per_s": 16 * len(bodies) / wall})
            res = {"bursts": bursts}
            if planes:
                res.update(await observe(server.port, local, engine,
                                         answers, parents))
            return res
        finally:
            await server.stop()
            await local.aclose()
            engine.close()

    reset_launches()
    try:
        # in turns, off, on, off: a turn's order effect shows in the spread
        turns = [(planes, asyncio.run(run(planes, t)))
                 for t, planes in enumerate((False, True, False))]
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
        OBSERVE_7B.clear()
    launches = read_launches()
    for name, planes in (("planes_off", False), ("planes_on", True)):
        bursts = [b for p, r in turns if p == planes for b in r["bursts"]]
        out[name] = {k: statistics.median(b[k] for b in bursts)
                     for k in bursts[0]}
        out[name]["by_burst"] = bursts
    out["planes_on"].update({k: v for k, v in turns[1][1].items()
                             if k != "bursts"})
    out["launches"] = launches
    emit(out)
    if failed or not all(n > 0 for n in launches.values()):
        raise AssertionError(f"observe_7b: {failed} {launches}")
    return launches


def resnet50_flops(rows: int, size: int = 224, classes: int = 1000) -> int:
    """ResNet50's (3, 4, 6, 3) multiply-adds x 2 for ``rows`` images,
    counted by hand: every convolution (the stride on the 3x3, as the
    model's) and the head; batch norm, ReLU and pooling count none."""
    macs = 0
    res = size // 2
    macs += res * res * 3 * 64 * 49            # the 7x7 stem
    res //= 2                                  # max pool
    cin = 64
    for n, w, s in ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)):
        for b in range(n):
            stride = s if b == 0 else 1
            out = res // stride
            macs += res * res * cin * w        # 1x1 reduce
            macs += out * out * w * w * 9      # 3x3
            macs += out * out * w * 4 * w      # 1x1 expand
            if b == 0:
                macs += out * out * cin * 4 * w  # projection
            cin, res = 4 * w, out
    macs += cin * classes
    return 2 * macs * rows


def observe_resnet50_phase(torch) -> dict:
    """``plan_resnet50``'s int8 fused configuration (``resnet50-int8.json``,
    BASELINE config 3, ``wire_resnet``'s seeds, every bucket captured at
    boot) with ``seldon.io/profile`` and ``seldon.io/tracing`` on
    (``seldon.io/profile-storm`` 8: the 7 buckets of the warm-up are one
    capture each, not churn) behind the runner's REST.  Gated:
    ``/admin/profile/compile`` lists every captured bucket with
    ``wallMsTotal`` > 0; each bucket's ``flops`` equals, exactly, the cost
    module 9 counts on the host from the shapes (one image on the meta
    device, times the bucket's rows) and lies within 1% of the hand count
    (``resnet50_flops``); ``/admin/profile/capacity`` names the card and
    its peak; no storm after the warm-up; a traced single's segment span
    carries ``device_block_ms``.  Returns the phase's launches."""
    import numpy as np

    from seldon_core_tpu_torch.models import resnet, resnet_int8
    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.ops.cost import CostCount

    d = _resnet_graph(True, {"seldon.io/graph-plan": "fused",
                             "seldon.io/graph-plan-warmup": "true",
                             "seldon.io/profile": "true",
                             "seldon.io/profile-storm": "8",
                             "seldon.io/tracing": "true"})
    failed = []
    # module 9 on the host: one image's cost from the shapes alone (meta
    # tensors: nothing is computed), the int8 model's own forward
    host = resnet_int8.Int8ResNet50Model(
        source=resnet.ResNet50Model(seed=0, device="cpu"), device="cpu")
    meta = _to_device(host.params, "meta")
    with torch.inference_mode(), CostCount() as count:
        host.predict_fn(meta, torch.zeros((1, 224, 224, 3), device="meta"))
    per_row = count.flops
    del host, meta
    x = np.random.default_rng(21).integers(0, 256, (1, 224, 224, 3)).astype(
        np.float32)

    async def run():
        reset_launches()
        t0 = time.perf_counter()
        server, local = await serve(d, port=0, host="127.0.0.1")
        boot_s = time.perf_counter() - t0
        loop = asyncio.get_running_loop()
        try:
            code, body, _ = await loop.run_in_executor(
                None, _post_raw, server.port, "/api/v0.1/predictions",
                _bin_body(x))
            if code != 200:
                raise AssertionError(f"observe_resnet50: {code} {body}")
            got = {}
            for path in (f"/trace?puid={body['meta']['puid']}",
                         "/admin/profile/compile", "/admin/profile/capacity",
                         "/admin/profile?n=5"):
                got[path.split("?")[0]] = await loop.run_in_executor(
                    None, _get_json, server.port, path)
            return boot_s, got, local.engine.plan.segments[0]
        finally:
            await server.stop()
            await local.aclose()

    boot_s, got, seg = asyncio.run(run())
    launches = read_launches()
    code, ledger = got["/admin/profile/compile"]
    rows_by_label = {f"{k[0][0]}x224x224x3:float32": k[0][0]
                     for k in seg.capture_s}
    segs = ledger.get("segments", {})
    buckets = segs.get(seg.label, {}).get("buckets", {})
    out = {"phase": "observe_resnet50", "boot_s": boot_s,
           "host_flops_per_image": per_row,
           "hand_flops_per_image": resnet50_flops(1),
           "ledger": {k: v for k, v in segs.get(seg.label, {}).items()
                      if k != "buckets"},
           "buckets": {b: {k: c[k] for k in ("wall_ms", "flops",
                                             "bytes_accessed",
                                             "peak_hbm_bytes", "source")}
                       for b, c in buckets.items()},
           "storm": ledger.get("storm"), "card": CARD}
    if code != 200 or set(buckets) != set(rows_by_label) or not \
            segs[seg.label]["wallMsTotal"] > 0:
        failed.append(f"ledger buckets {sorted(buckets)} vs captured "
                      f"{sorted(rows_by_label)}")
    for label, rows in rows_by_label.items():
        b = buckets.get(label, {})
        if b.get("flops") != per_row * rows:
            failed.append(f"{label}: flops {b.get('flops')} != host count "
                          f"{per_row * rows}")
        if abs(b.get("flops", 0) / resnet50_flops(rows) - 1) > 0.01:
            failed.append(f"{label}: flops {b.get('flops')} not within 1% "
                          f"of {resnet50_flops(rows)}")
    if ledger.get("storm") != [] or segs.get(seg.label, {}).get("storm"):
        failed.append(f"storm after warm-up: {ledger.get('storm')}")
    code, cap = got["/admin/profile/capacity"]
    out["capacity"] = cap
    if cap.get("deviceKind") != torch.cuda.get_device_name(0) or not \
            (cap.get("devicePeakTflops") or 0) > 0:
        failed.append(f"capacity {cap}")
    code, tree = got["/trace"]
    spans = [c for c in tree.get("children", ())
             if c.get("kind") == "FUSED_SEGMENT"]
    out["segment_span"] = spans[0]["attributes"] if spans else None
    if not spans or "device_block_ms" not in spans[0]["attributes"]:
        failed.append(f"segment span {tree}")
    code, prof = got["/admin/profile"]
    out["host_profile"] = prof.get("stats")
    out["launches"] = launches
    emit(out)
    if failed or launches["int8_matmul"] <= 0:
        raise AssertionError(f"observe_resnet50: {failed}")
    return launches


# ---------------------------------------------------------------------------
# slice 5-ii: the static-analysis plane against the live plan and the card
# ---------------------------------------------------------------------------

#: what earlier phases ran, for ``lint_phase`` to hold the lint's offline
#: prediction against: ``plans`` name -> (deployment dict, the live
#: ``GraphPlan.describe()``), from ``plan_resnet50`` (int8) and
#: ``plan_graphs``; ``device_plane`` mode -> the runner child's deployment
#: and its ``seldon_device_plane_*`` counters, from
#: ``device_plane_resnet50``
LINT_OBSERVED: dict = {"plans": {}, "device_plane": {}}
#: the registry's model classes, each built on the card by its own
#: constructor for ``lint_phase`` (b) and (d)
LINT_MODELS = ("iris:IrisClassifier", "mlp:MNISTMLP",
               "mlp:MNISTMLPClassifier", "resnet:ResNet50Model",
               "resnet_int8:Int8ResNet50Model")
#: shm hop payload sizes (bytes) for the transfer figures: a 1 KiB row up
#: to 64 MiB (about 13 batches of 8 ResNet images in float32)
LINT_HOP_SIZES = (1 << 10, 64 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20)
#: the residency tier a runner's ``remote_refs`` mode shows the hop rode
_MODE_TIER = {"shm": "shm-lane", "loopback": "loopback-ref"}


def _shm_hop_figures(torch) -> dict:
    """The device plane's pageable shm hop on the card, as PR 11's runtime
    takes it: ``put_shm`` (one D2H into a fresh segment) and ``resolve``
    (one H2D off it, unlink), synchronised, at each of LINT_HOP_SIZES
    (median of 5 after 2 warm-ups).  The round trip is two hops, so
    ``analysis/planlint.py``'s figures (one hop: an overhead plus bytes
    over a rate) come out as: the overhead, half the smallest size's
    round trip (its bytes cost microseconds); the rate, both hops' bytes
    of the largest size over its round trip less the two overheads.  (A
    least-squares line over all sizes lets the largest sizes set its
    intercept, which read below zero.)"""
    from seldon_core_tpu_torch.runtime.device_registry import (
        DeviceBufferRegistry,
    )

    reg = DeviceBufferRegistry(device="cuda")
    rows = []
    for n in LINT_HOP_SIZES:
        x = torch.randint(0, 256, (n,), dtype=torch.uint8, device="cuda")
        ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = reg.resolve(reg.put_shm(x))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if not (y.is_cuda and torch.equal(y, x)):
            raise AssertionError(f"lint: the shm hop changed {n} bytes")
        rows.append((n, statistics.median(ms[2:])))
    overhead = rows[0][1] / 2
    n, t = rows[-1]
    return {"round_trip_ms_by_bytes": {str(n): t for n, t in rows},
            "hop_overhead_ms": overhead,
            "transfer_gbps": 2 * n / (t - 2 * overhead) / 1e6}


def _lint_plan_check(graphlint, name: str, spec: dict, live: dict) -> dict:
    """GL6xx offline against one captured plan: the static segments'
    members against ``compile_plan``'s, and the GL602 boundary nodes and
    reasons against the plan's.  The lint also reports an ancestor whose
    subtree a boundary splits ("a descendant prevents whole-subtree
    fusion"); the plan lists the frontier only, so those are set aside.
    A reason both derive from the node's type (a ROUTER, an unfusible
    type) must read the same; the others come from different facts (the
    signature registry's ``pure_fn``, the live object's methods) and are
    reported side by side."""
    from seldon_core_tpu_torch.operator.spec import SeldonDeployment

    dep = SeldonDeployment.from_dict(spec)
    pred = dep.predictors[0]
    ann = {**dep.annotations, **pred.annotations}
    lint_segments = sorted(sorted(u.name for u in seg)
                           for seg in graphlint._static_segments(pred.graph))
    live_segments = sorted(sorted(s["members"]) for s in live["segments"])
    lint_bounds = {}
    for f in graphlint.lint_graph(pred.graph, ann, pred.name):
        if f.code == "GL602":
            reason = f.message.split(": ", 1)[1]
            if reason != "a descendant prevents whole-subtree fusion":
                lint_bounds[f.path.rsplit("/", 1)[-1]] = reason
    live_bounds = {b["node"]: b["reason"] for b in live["boundaries"]}
    structural = {n: r for n, r in live_bounds.items()
                  if r.startswith(("ROUTER:", "type "))}
    return {"graph": name, "segments_lint": lint_segments,
            "segments_live": live_segments,
            "boundaries_lint": lint_bounds, "boundaries_live": live_bounds,
            "equal": lint_segments == live_segments
            and set(lint_bounds) == set(live_bounds)
            and all(lint_bounds.get(n) == r for n, r in structural.items())}


def _lint_tier_check(mode: str, obs: dict) -> dict:
    """GL18xx offline against ``device_plane_resnet50``'s runner child in
    one mode.  Its graph is one node served by a REST component child:
    one remote edge, the runner's hop to the child.  The lint's tier
    (``plan_edges``, its GL1805 map) against ``GraphPlan.residency_map``
    of the same spec and against the tier the hop rode on the card, the
    mode of the runner's ``seldon_device_plane_remote_refs_total`` (none:
    bytes)."""
    from seldon_core_tpu_torch.analysis import lint_deployment, planlint
    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.graph.plan import compile_plan
    from seldon_core_tpu_torch.operator.spec import SeldonDeployment

    dep = SeldonDeployment.from_dict(obs["spec"])
    pred = dep.predictors[0]
    ann = {**dep.annotations, **pred.annotations}
    (edge,) = planlint.plan_edges(pred.graph, ann, pred.name)

    class Remote:  # the node's stand-in: nothing is called
        def predict(self, X, names):
            return X

    # nothing fuses, so the engine keeps no plan: partition its graph
    engine = GraphEngine(obs["spec"]["spec"]["predictors"][0]["graph"],
                         resolver=lambda u: Remote())
    (live,) = compile_plan(engine.root).residency_map(ann)
    refs = obs["runner_plane"]["remote_refs"]
    rode = [_MODE_TIER[m] for m in ("loopback", "shm")
            if refs.get(f'{{mode="{m}"}}', 0) > 0]
    rows = [{"edge": f"{edge.src}->{edge.dst}",
             "hop": f"runner -> component ({pred.graph.endpoint.type})",
             "remote": edge.remote, "lint": edge.state.tier,
             "residency_map": live["tier"],
             "card": "+".join(rode) or "host-bytes"}]
    return {"mode": mode, "rows": rows, "remote_refs": refs,
            "requests": obs["requests"],
            "findings": sorted({f.code for f in lint_deployment(obs["spec"])
                                if f.severity != "INFO"})}


def lint_phase(torch) -> dict:
    """Slice 5-ii on the card.  (a) ``python -m seldon_core_tpu_torch.
    analysis --self --fail-on warn`` in process: the port's package and
    its signature registry traced on fake tensors, no ERROR or WARN; then
    each of the port's example specs linted as admission would, host ms
    each.  (b) GL16xx against reality: each registry model built on the
    card by its own constructor, its real forward at the trace's probe
    binding, whose output (shape, dtype) must equal the trace's; the int8
    ResNet50's forward launches K1 37 times.  (c) GL6xx and GL18xx
    against what the card did: ``plan_resnet50``'s int8 fused cell and
    ``plan_graphs``' graphs (segments and boundary reasons against the
    captured plans), ``device_plane_resnet50``'s runner child in both
    modes (tier per edge against ``residency_map`` and the runner's
    counters by mode; the one disagreement the tier model has with the
    runtime, a REST hop's, is asserted as found and reported).  (d) GL3xx
    against memory, reported: each model's ``hbm_bytes`` beside the growth
    of ``torch.cuda.memory_allocated()`` its construction made; the
    per-device budget against ``total_memory``; the shm hop's measured
    figures beside planlint's.  Returns the forwards' launches."""
    from seldon_core_tpu_torch import models
    from seldon_core_tpu_torch.analysis import graphlint, lint_deployment
    from seldon_core_tpu_torch.analysis import planlint, tracelint
    from seldon_core_tpu_torch.analysis.cli import main as lint_main

    out = {"phase": "lint", "card": CARD}
    t0 = time.perf_counter()
    rc = lint_main(["--self", "--fail-on", "warn"])
    out["self_s"] = time.perf_counter() - t0
    out["self_rc"] = rc
    specs = {}
    for path in sorted((ROOT / "seldon_core_tpu_torch" / "examples").glob(
            "*.json")):
        spec = json.loads(path.read_text())
        t0 = time.perf_counter()
        fs = lint_deployment(spec)
        specs[path.stem] = {
            "host_ms": (time.perf_counter() - t0) * 1e3,
            "not_info": [str(f) for f in fs if f.severity != "INFO"]}
    out["example_specs"] = specs

    # (b) and (d): each registry model on the card
    pkg = "seldon_core_tpu_torch.models"
    traced, mem = {}, {}
    reset_launches()
    k1_int8 = 0
    for cls in LINT_MODELS:
        mc = f"{pkg}.{cls}"
        sig = models.signature_for(mc)
        trace = tracelint._trace_model(mc, sig)
        mod_name, cls_name = cls.split(":")
        module = __import__(f"{pkg}.{mod_name}", fromlist=[cls_name])
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        model = getattr(module, cls_name)(device="cuda")
        gc.collect()
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        shape = tracelint._bind_input_shape(sig)
        x = torch.rand(shape, device="cuda") * 255
        launched = read_launches()["int8_matmul"]
        with torch.inference_mode():
            y = model.predict_fn(model.params, x)
        torch.cuda.synchronize()
        if cls.startswith("resnet_int8"):
            k1_int8 = read_launches()["int8_matmul"] - launched
        real = (tuple(y.shape), tracelint.dtype_name(y.dtype))
        traced[cls] = {"probe": list(shape),
                       "traced": [list(trace.out_shapes[0][0]),
                                  trace.out_shapes[0][1]],
                       "card": [list(real[0]), real[1]],
                       "equal": trace.error is None
                       and len(trace.out_shapes) == 1
                       and trace.out_shapes[0][:2] == real}
        mem[cls] = {"hbm_bytes_lint": sig.hbm_bytes,
                    "allocated_growth_bytes": grown,
                    "ratio": grown / sig.hbm_bytes if sig.hbm_bytes else None}
        del model, y, x
        torch.cuda.empty_cache()
    launches = read_launches()
    out["gl16xx_against_the_card"] = traced
    out["k1_launches_int8_forward"] = k1_int8
    total = torch.cuda.get_device_properties(0).total_memory
    out["gl3xx_against_memory"] = {
        "models": mem, "hbm_per_chip_gb": graphlint.HBM_PER_CHIP_GB,
        "budget_bytes": int(graphlint.HBM_PER_CHIP_GB * (1 << 30)),
        "total_memory": total}
    hop = _shm_hop_figures(torch)
    out["shm_hop"] = {**hop, "planlint_transfer_gbps": planlint.TRANSFER_GBPS,
                      "planlint_hop_overhead_ms": planlint.HOP_OVERHEAD_MS}

    # (c): the lint's offline prediction against what the card ran
    plans = [_lint_plan_check(graphlint, name, spec, live)
             for name, (spec, live) in sorted(
                 LINT_OBSERVED["plans"].items())]
    tiers = [_lint_tier_check(mode, obs) for mode, obs in sorted(
        LINT_OBSERVED["device_plane"].items())]
    out["gl6xx_against_plans"] = plans
    out["gl18xx_against_the_plane"] = tiers
    disagree = [dict(r, mode=t["mode"]) for t in tiers for r in t["rows"]
                if not r["lint"] == r["residency_map"] == r["card"]]
    out["tier_disagreements"] = disagree
    emit(out)

    # the reference's tier model: a REST edge never carries a deviceRef
    # (GL1801); both runtimes negotiate one per peer on REST
    # (ROADMAP.md Queue 3).  Held as found: lint and residency_map say
    # bytes, the card rode shm on every request after the first.
    known = [r for r in disagree
             if r["mode"] == "on" and r["hop"].endswith("(REST)")
             and r["lint"] == r["residency_map"] == "host-bytes"
             and r["card"] == "shm-lane"]
    on = [t for t in tiers if t["mode"] == "on"]
    checks = {
        "--self reports no ERROR or WARN": rc == 0,
        "example specs lint clean": not any(
            s["not_info"] for s in specs.values()),
        "traced outputs equal the card's": all(
            t["equal"] for t in traced.values()),
        "int8 forward launches K1": k1_int8 == 37,
        "budget within the card": out["gl3xx_against_memory"][
            "budget_bytes"] <= total,
        "plans observed": len(plans) >= 2,
        "segments and boundaries equal the live plans": all(
            p["equal"] for p in plans),
        "both plane modes observed": len(tiers) == 2,
        "tiers equal but the known REST hop": disagree == known
        and len(known) == 1,
        "GL1801 raised for the REST hop with the plane on": bool(on)
        and on[0]["findings"] == ["GL1801"],
        "hop figures positive": hop["transfer_gbps"] > 0
        and hop["hop_overhead_ms"] > 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"lint: {failed}")
    return launches


# ----------------------------------------------------------------------
# slice 5b-i: the front door (the gateway) and the fleet data plane
# ----------------------------------------------------------------------

GATEWAY_IMAGES = 16
GATEWAY_BURST_S = 2.0
FLEET_REQUESTS = 64
FLEET_IMAGES = 8


def _gw_token(port: int, key: str, secret: str, how: str) -> str:
    """An OAuth token from the gateway on ``port``: the client's
    credentials in an HTTP Basic header (``how`` "basic") or in the form
    fields (``how`` "form")."""
    import base64

    headers = {"Content-Type": "application/x-www-form-urlencoded"}
    form = "grant_type=client_credentials"
    if how == "basic":
        headers["Authorization"] = "Basic " + base64.b64encode(
            f"{key}:{secret}".encode()).decode()
    else:
        form += f"&client_id={key}&client_secret={secret}"
    req = urllib.request.Request(f"http://127.0.0.1:{port}/oauth/token",
                                 data=form.encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        body = json.loads(r.read())
    if body.get("token_type") != "bearer":
        raise AssertionError(f"gateway token ({how}): {body}")
    return body["access_token"]


def _gw_post(port: int, path: str, data: bytes, headers: dict) -> tuple:
    """POST ``data``: ``(status, headers with lower-case names, body bytes,
    seconds)``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **headers})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, e.headers, e.read()
    return code, {k.lower(): v for k, v in hdrs.items()}, raw, \
        time.perf_counter() - t0


def _sse_timed(port: int, data: bytes, headers: dict) -> tuple:
    """A stream request read event by event: ``(status, events, TTFT s,
    TPOT s)`` as the client sees them (first token event after the send;
    mean gap between token events)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/api/v0.1/stream", body=data,
                     headers={"Content-Type": "application/json",
                              **headers})
        resp = conn.getresponse()
        if not (resp.getheader("Content-Type") or "").startswith(
                "text/event-stream"):
            return resp.status, json.loads(resp.read()), None, None
        events, times = [], []
        for line in resp:
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                times.append(time.perf_counter())
    finally:
        conn.close()
    toks = [i for i, e in enumerate(events) if "token" in e]
    ttft = times[toks[0]] - t0 if toks else None
    tpot = ((times[toks[-1]] - times[toks[0]]) / (len(toks) - 1)
            if len(toks) > 1 else None)
    return resp.status, events, ttft, tpot


def _abandon_stream(port: int, data: bytes, headers: dict) -> float:
    """Open a stream, read its first event, close the connection: the
    ``time.perf_counter()`` of the close."""
    import socket

    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        head = "".join(f"{k}: {v}\r\n" for k, v in {
            "Host": "127.0.0.1", "Content-Type": "application/json",
            "Content-Length": str(len(data)), **headers}.items())
        s.sendall(f"POST /api/v0.1/stream HTTP/1.1\r\n{head}\r\n".encode()
                  + data)
        buf = b""
        while b"data: " not in buf or not buf.split(b"data: ", 1)[1] \
                .count(b"\n\n"):
            chunk = s.recv(65536)
            if not chunk:
                raise AssertionError(f"abandoned stream: closed early {buf}")
            buf += chunk
    finally:
        s.close()
    return time.perf_counter()


def gateway_7b_phase(torch, params) -> dict:
    """``serve_7b``'s model behind the local runner's REST (in process, as
    ``observe_7b`` boots it) and the port's gateway in front of it, in
    process too.  A token from ``/oauth/token`` (form fields);
    ``serve_7b``'s 8 prompts through the gateway's
    ``/api/v0.1/predictions`` and ``/api/v0.1/stream`` (events relayed as
    they arrive), ids equal to ``serve_7b``'s; a request without a token
    answers 401; a stream the client abandons at the gateway after its
    first event frees its slot and pages in the engine (all 95 free pages
    back, well before the generation could have finished).  Reported:
    TTFT and TPOT as the client sees them through the gateway and direct
    (the same 8 concurrent streams), medians.  Returns the launches."""
    from seldon_core_tpu_torch.gateway.app import Gateway
    from seldon_core_tpu_torch.gateway.store import (
        DeploymentRecord,
        DeploymentStore,
    )
    from seldon_core_tpu_torch.operator.local import serve

    OBSERVE_7B["params"] = params
    prompts, want = SERVE_7B["prompts"], SERVE_7B["ids"]
    bodies = [json.dumps({"jsonData": {"prompt_ids": p, "n_new": 16}})
              .encode() for p in prompts]
    long_new = 240  # 8 + 240 tokens fit max_len 256
    abandon = json.dumps({"jsonData": {"prompt_ids": prompts[0][:8],
                                       "n_new": long_new}}).encode()
    out = {"phase": "gateway_7b", "card": CARD,
           "path": "client -> gateway REST -> runner REST -> LLMComponent "
                   "-> PagedLLMEngine (in process)"}
    failed = []

    def ids_of(answers, what):
        got = []
        for code, _, raw, _ in answers:
            if code != 200:
                raise AssertionError(f"gateway_7b {what}: HTTP {code}: "
                                     f"{raw[:300]!r}")
            got.append(json.loads(raw)["jsonData"]["ids"])
        return got

    def stream_ids(streams, what):
        got = []
        for code, events, _, _ in streams:
            if code != 200 or not events or not events[-1].get("done"):
                raise AssertionError(f"gateway_7b {what}: {code} "
                                     f"{str(events)[:300]}")
            done = events[-1]
            toks = [e["token"] for e in events[:-1]]
            if toks != done["ids"][done["prompt_len"]:]:
                failed.append(f"{what}: token events differ from done ids")
            got.append(done["ids"])
        return got

    async def run():
        server, local = await serve(_observe_7b_graph(False), port=0,
                                    host="127.0.0.1")
        engine = local.engine.node_impl("llm").user.engine
        store = DeploymentStore()
        store.put(DeploymentRecord(
            name="gateway-7b", oauth_key="llm-client", oauth_secret="s3cret",
            engine_url=f"http://127.0.0.1:{server.port}"))
        gw = Gateway(store)
        gport = (await gw.start("127.0.0.1", 0)).port
        eport = server.port
        res = {}
        try:
            tok = await asyncio.to_thread(_gw_token, gport, "llm-client",
                                          "s3cret", "form")
            auth = {"Authorization": f"Bearer {tok}"}
            # warm-up: every prefill bucket of the 8 prompts is captured
            ids_of(await _in_threads(_gw_post, [
                (eport, "/api/v0.1/predictions", b, {}) for b in bodies]),
                "warm-up")
            code, _, raw, _ = await asyncio.to_thread(
                _gw_post, gport, "/api/v0.1/predictions", bodies[0], {})
            res["no_token"] = {"status": code, "body": json.loads(raw)}
            if code != 401:
                failed.append(f"no token answered {code}")
            t0 = time.perf_counter()
            answers = await _in_threads(_gw_post, [
                (gport, "/api/v0.1/predictions", b, auth) for b in bodies])
            res["predictions_wall_s"] = time.perf_counter() - t0
            if ids_of(answers, "predictions") != want:
                failed.append("predictions ids differ from serve_7b's")
            timing = {}
            for label, port, hdr in (("gateway", gport, auth),
                                     ("direct", eport, {}),
                                     ("gateway_again", gport, auth)):
                streams = await _in_threads(_sse_timed, [
                    (port, b, hdr) for b in bodies])
                if stream_ids(streams, f"{label} streams") != want:
                    failed.append(f"{label} stream ids differ from "
                                  "serve_7b's")
                timing[label] = {
                    "ttft_ms_median": statistics.median(
                        s[2] for s in streams) * 1e3,
                    "tpot_ms_median": statistics.median(
                        s[3] for s in streams) * 1e3}
            res["streams"] = timing
            tpot_s = timing["direct"]["tpot_ms_median"] / 1e3
            closed = await asyncio.to_thread(_abandon_stream, gport,
                                             abandon, auth)
            while engine.free_pages != 95 and \
                    time.perf_counter() - closed < 60:
                await asyncio.sleep(0.005)
            free_s = time.perf_counter() - closed
            res["abandoned"] = {
                "n_new": long_new, "freed_s": free_s,
                "free_pages": engine.free_pages,
                "full_generation_s_at_tpot": long_new * tpot_s}
            if engine.free_pages != 95 or free_s > 0.25 * long_new * tpot_s:
                failed.append(f"abandoned stream not freed: {res['abandoned']}")
            return res
        finally:
            await gw.close()
            await server.stop()
            await local.aclose()
            engine.close()

    reset_launches()
    try:
        out.update(asyncio.run(run()))
    finally:
        OBSERVE_7B.clear()
    launches = read_launches()
    out["launches"] = launches
    emit(out)
    if failed or not all(n > 0 for n in launches.values()):
        raise AssertionError(f"gateway_7b: {failed} {launches}")
    return launches


def _child_launches_now(child, prefix) -> dict:
    """A runner child's launch counts now: it writes them on SIGUSR1."""
    import signal

    path = Path(f"{prefix}-now.{child.proc.pid}.json")
    path.unlink(missing_ok=True)
    child.proc.send_signal(signal.SIGUSR1)
    deadline = time.monotonic() + 30
    while True:
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            if time.monotonic() > deadline:
                raise AssertionError(f"{child.label}: no launch counts")
            time.sleep(0.01)


def _firehose_records(path: Path, n: int) -> list:
    """The first ``n`` records of a jsonl firehose file, waited for (the
    gateway publishes off its event loop)."""
    deadline = time.monotonic() + 60
    while True:
        lines = path.read_text().splitlines() if path.exists() else []
        if len(lines) >= n or time.monotonic() > deadline:
            return [json.loads(ln) for ln in lines]
        time.sleep(0.05)


def gateway_resnet50_phase(torch) -> dict:
    """The port's gateway as a child (``python -m
    seldon_core_tpu_torch.gateway.app --config ... --firehose jsonl``) in
    front of a runner child serving ``resnet50-int8.json`` (BASELINE
    config 3, full width, ``wire_resnet``'s seeds, batching off so every
    answer is one batch-1 or batch-64 forward).  Three deployment records
    name the runner: ``plain``, ``cached`` (``seldon.io/prediction-cache``)
    and ``qos`` (``seldon.io/slo-p95-ms``).  Tokens by HTTP Basic and by
    form fields.  Gated: 16 sequential and 16 concurrent singles
    (binTensor; ndarray sequential) and a batch of 64 over the gateway's
    REST, and 16 singles and the batch over its gRPC ``Seldon.Predict``
    with ``oauth_token``, every answer bitwise equal to the in-process
    graph; a repeated body answers ``X-Seldon-Cache: hit`` and the child's
    K1 count does not move, 16 identical concurrent bodies make one engine
    forward (one miss, K1 moves by one forward's count); one firehose
    record per answered REST prediction, its request and response the
    JSON of the bytes sent and received; in a 2 s burst at twice the rate
    the gateway path sustains alone (measured here), only 200s and 429s
    with ``Retry-After``, low priority shed first and most.  Reported:
    p50/p95 of the singles through the gateway against direct.  Returns
    the runner child's launches."""
    import base64
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.component import ComponentHandle
    from seldon_core_tpu_torch.serving.grpc_api import SeldonGrpcClient

    WIRE_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(23)
    imgs = rng.integers(0, 256, (GATEWAY_IMAGES, 224, 224, 3)).astype(
        np.float32)
    batch = rng.integers(0, 256, (64, 224, 224, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (8, 224, 224, 3)).astype(np.uint8)

    def nd_body(x):
        return json.dumps({"data": {"ndarray": x.astype(np.int64)
                                    .tolist()}}).encode()

    def u8_body(x):
        return json.dumps({"data": {"binTensor": {
            "shape": list(x.shape), "dtype": "uint8",
            "b64": base64.b64encode(x.tobytes()).decode()}}}).encode()

    gpath = WIRE_DIR / "graph_gateway_resnet50.json"
    gpath.write_text(json.dumps(_resnet_graph(
        True, {"seldon.io/batching": "false"})))
    egrpc, ggrpc, gport = _free_port(), _free_port(), _free_port()
    engine, counts = runner_child("gw_engine", [
        "--graph", str(gpath), "--port", "0", "--host", "127.0.0.1",
        "--grpc-port", str(egrpc)])
    fdir = WIRE_DIR / "gateway_firehose"
    shutil.rmtree(fdir, ignore_errors=True)
    out = {"phase": "gateway_resnet50", "card": CARD,
           "model": "int8 ResNet50 (3, 4, 6, 3), 224x224x3, 1000 classes, "
                    "batching off",
           "path": "client -> gateway child (REST, gRPC) -> runner child"}
    failed = []
    gw = None
    try:
        # in process: the graph over the same component at batch 1 and 64
        local = ComponentHandle(wire_resnet(True), name="resnet")
        graph = GraphEngine({"name": "resnet", "type": "MODEL"},
                            resolver=lambda u, h=local: h)

        def in_process(x):
            return asyncio.run(graph.predict(
                SeldonMessage.from_ndarray(x))).to_dict()["data"]

        want_bin = [in_process(imgs[i:i + 1]) for i in range(GATEWAY_IMAGES)]
        want_nd = [in_process(imgs[i:i + 1].astype(np.int64))
                   for i in range(GATEWAY_IMAGES)]
        want64 = in_process(batch)
        top1_u8 = [int(np.asarray(in_process(u8[i:i + 1])["ndarray"])
                       .argmax()) for i in range(len(u8))]
        del local, graph
        torch.cuda.empty_cache()
        eport = engine.port("serving deployment")
        base = f"http://127.0.0.1:{eport}"
        deps = [
            {"name": "resnet50-int8", "oauth_key": "plain",
             "oauth_secret": "s-plain", "engine_url": base,
             "engine_grpc": f"127.0.0.1:{egrpc}"},
            {"name": "resnet50-int8-cached", "oauth_key": "cached",
             "oauth_secret": "s-cached", "engine_url": base,
             "annotations": {"seldon.io/prediction-cache": "true"}},
            {"name": "resnet50-int8-qos", "oauth_key": "qos",
             "oauth_secret": "s-qos", "engine_url": base,
             "annotations": {"seldon.io/slo-p95-ms": "100"}}]
        cfg = WIRE_DIR / "gateway_deployments.json"
        cfg.write_text(json.dumps({"deployments": deps}))
        gw = Child([sys.executable, "-m", "seldon_core_tpu_torch.gateway.app",
                    "--config", str(cfg), "--port", str(gport),
                    "--host", "127.0.0.1", "--grpc-port", str(ggrpc),
                    "--firehose", "jsonl", "--firehose-dir", str(fdir)],
                   label="gateway")
        gw.wait_for("gateway REST on")
        tok = {"plain": _gw_token(gport, "plain", "s-plain", "basic"),
               "cached": _gw_token(gport, "cached", "s-cached", "form"),
               "qos": _gw_token(gport, "qos", "s-qos", "form")}
        auth = {k: {"Authorization": f"Bearer {v}"} for k, v in tok.items()}
        sent = {k: [] for k in tok}  # (request bytes, answer bytes)

        def post(client, data, hdr=None):
            r = _gw_post(gport, "/api/v0.1/predictions", data,
                         {**auth[client], **(hdr or {})})
            sent[client].append((data, r[2]))
            return r

        def check(res, want, what):
            bad = [r[0] for r in res if r[0] != 200]
            if bad:
                raise AssertionError(f"gateway_resnet50 {what}: {bad[:3]} "
                                     f"{res[0][2][:300]!r}")
            n = sum(json.loads(r[2])["data"] == w for r, w in zip(res, want))
            if n != len(want):
                failed.append(f"{what}: {n} of {len(want)} bitwise equal")
            return n

        # warm the path once, then the traffic
        post("plain", _bin_body(imgs[:1]))
        _post_raw(eport, "/api/v0.1/predictions", _bin_body(imgs[:1]))
        singles = [_bin_body(imgs[i:i + 1]) for i in range(GATEWAY_IMAGES)]
        seq = [post("plain", b) for b in singles]
        direct = [_post_raw(eport, "/api/v0.1/predictions", b)
                  for b in singles]
        nd = [post("plain", nd_body(imgs[i:i + 1]))
              for i in range(GATEWAY_IMAGES)]
        with ThreadPoolExecutor(GATEWAY_IMAGES) as pool:
            conc = list(pool.map(lambda b: post("plain", b), singles))
        b64 = post("plain", _bin_body(batch))
        out["bitwise_equal_in_process"] = {
            "sequential_binTensor": check(seq, want_bin, "sequential"),
            "sequential_ndarray": check(nd, want_nd, "ndarray"),
            "concurrent_binTensor": check(conc, want_bin, "concurrent"),
            "batch_64": check([b64], [want64], "batch of 64")}
        out["latency"] = {
            "gateway_sequential": _pctl([r[3] * 1e3 for r in seq]),
            "direct_sequential": _pctl([r[2] * 1e3 for r in direct]),
            "gateway_concurrent": _pctl([r[3] * 1e3 for r in conc])}
        # gRPC through the gateway, oauth_token in the metadata
        want_arr = [np.asarray(w["ndarray"], np.float64) for w in want_bin]

        async def grpc_calls():
            c = SeldonGrpcClient(f"127.0.0.1:{ggrpc}", token=tok["plain"],
                                 timeout_s=600)
            bad = SeldonGrpcClient(f"127.0.0.1:{ggrpc}", token="bogus",
                                   timeout_s=60)
            try:
                got = []
                for i in range(GATEWAY_IMAGES):
                    o = await c.predict(SeldonMessage(
                        data=imgs[i:i + 1], encoding="binTensor"))
                    got.append(np.asarray(o.host_data(), np.float64))
                o = await c.predict(SeldonMessage(data=batch,
                                                  encoding="binTensor"))
                got.append(np.asarray(o.host_data(), np.float64))
                try:
                    await bad.predict(SeldonMessage(data=imgs[:1],
                                                    encoding="binTensor"))
                    code = "OK"
                except Exception as e:
                    code = str(getattr(e, "code", lambda: e)())
                return got, code
            finally:
                await c.close()
                await bad.close()

        got, bad_code = asyncio.run(grpc_calls())
        n = sum(np.array_equal(g, w) for g, w in
                zip(got, want_arr + [np.asarray(want64["ndarray"],
                                                np.float64)]))
        out["grpc"] = {"bitwise_equal_in_process": n,
                       "bad_token": bad_code}
        if n != GATEWAY_IMAGES + 1:
            failed.append(f"gRPC: {n} of {GATEWAY_IMAGES + 1} bitwise equal")
        if "UNAUTHENTICATED" not in bad_code:
            failed.append(f"gRPC bad token answered {bad_code}")
        # the cache tier: a hit launches nothing; 16 identical concurrent
        # bodies make one engine forward
        c0 = _child_launches_now(engine, counts)["int8_matmul"]
        first = post("cached", singles[0])
        c1 = _child_launches_now(engine, counts)["int8_matmul"]
        again = post("cached", singles[0])
        c2 = _child_launches_now(engine, counts)["int8_matmul"]
        with ThreadPoolExecutor(16) as pool:
            flight = list(pool.map(lambda _: post("cached", singles[1]),
                                   range(16)))
        c3 = _child_launches_now(engine, counts)["int8_matmul"]
        states = sorted(r[1].get("x-seldon-cache", "") for r in flight)
        out["cache"] = {"first": first[1].get("x-seldon-cache"),
                        "again": again[1].get("x-seldon-cache"),
                        "k1_one_forward": c1 - c0, "k1_on_hit": c2 - c1,
                        "k1_for_16_identical": c3 - c2,
                        "identical_states": states}
        check([first, again], [want_bin[0]] * 2, "cache")
        check(flight, [want_bin[1]] * 16, "single-flight")
        if not (out["cache"]["first"] == "miss"
                and out["cache"]["again"] == "hit" and c2 == c1
                and c1 - c0 > 0 and c3 - c2 == c1 - c0
                and states.count("miss") == 1
                and set(states) <= {"miss", "coalesced", "hit"}):
            failed.append(f"cache tier {out['cache']}")
        # the QoS tier: the rate the path sustains alone, then twice it
        ubodies = [u8_body(u8[i:i + 1]) for i in range(len(u8))]

        def qos(k, pri):
            i = k % len(ubodies)
            return i, pri, post("qos", ubodies[i], {"X-Seldon-Priority": pri})

        t0 = time.perf_counter()
        with ThreadPoolExecutor(12) as pool:
            alone = list(pool.map(lambda k: qos(k, "high"), range(48)))
        rate = 48 / (time.perf_counter() - t0)
        n_burst = int(2 * rate * GATEWAY_BURST_S)
        pris = ["low", "normal", "high"]
        with ThreadPoolExecutor(128) as pool:
            start = time.perf_counter()
            futs = []
            for k in range(n_burst):
                delay = start + k / (2 * rate) - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futs.append(pool.submit(qos, k, pris[k % 3]))
            burst = [f.result() for f in futs]
        shed = {p: sum(1 for _, pr, r in burst if pr == p and r[0] == 429)
                for p in pris}
        sent_n = {p: sum(1 for _, pr, _ in burst if pr == p) for p in pris}
        codes = sorted({r[0] for _, _, r in alone + burst})
        no_retry = sum(1 for _, _, r in burst
                       if r[0] == 429 and not r[1].get("retry-after"))
        wrong = sum(1 for i, _, r in alone + burst if r[0] == 200 and int(
            np.asarray(json.loads(r[2])["data"]["ndarray"]).argmax())
            != top1_u8[i])
        out["burst"] = {"alone_rps": rate, "offered_rps": 2 * rate,
                        "seconds": GATEWAY_BURST_S, "sent": sent_n,
                        "shed": shed, "codes": codes,
                        "429_without_retry_after": no_retry,
                        "top1_wrong": wrong,
                        "goodput": {p: sent_n[p] - shed[p] for p in pris}}
        if not (set(codes) <= {200, 429} and no_retry == 0 and wrong == 0
                and shed["low"] > 0
                and shed["low"] >= shed["normal"] >= shed["high"]):
            failed.append(f"burst {out['burst']}")
        # the firehose: one record per answered prediction, its JSON the
        # bytes sent and received
        fh = {}
        for client, pairs in sent.items():
            recs = _firehose_records(fdir / f"{client}.jsonl", len(pairs))
            key = [json.dumps([json.loads(a), json.loads(b)], sort_keys=True)
                   for a, b in pairs]
            got_key = [json.dumps([r["request"], r["response"]],
                                  sort_keys=True) for r in recs]
            fh[client] = {"records": len(recs), "predictions": len(pairs),
                          "equal": sorted(key) == sorted(got_key)}
            if len(recs) != len(pairs) or sorted(key) != sorted(got_key):
                failed.append(f"firehose {client}: {fh[client]}")
        out["firehose"] = fh
    finally:
        if gw is not None:
            gw.stop()
        engine.stop()
        shutil.rmtree(fdir, ignore_errors=True)
    launches = _child_launches(counts)
    out["launches"] = launches
    emit(out)
    if failed or launches["int8_matmul"] <= 0:
        raise AssertionError(f"gateway_resnet50: {failed} {launches}")
    return launches


def fleet_resnet50_phase(torch) -> dict:
    """A ``LocalFleet`` of 2 int8 ResNet50 replicas (full width,
    ``wire_resnet``'s seeds, fused, batching off, one
    ``seldon.io/artifact-store``) behind the port's gateway, in process.
    Per routing policy (round-robin, consistent-hash, least-loaded), 64
    requests over ``FLEET_IMAGES`` distinct images, every answer bitwise
    equal to the in-process graph; under consistent-hash equal bodies land
    on one replica, under round-robin on both.  Session affinity: streams
    with ``X-Seldon-Session`` pin their session to one replica (the
    ResNet answers 501, passed through).  Kill replica 1 after answer 16
    of a 64-request burst, with requests in hand there: every answer 200,
    the pool ejects the replica,
    ``/admin/fleet/health`` shows it ``unreachable`` in a ``partial``
    envelope.  Then ``autoscale_tick`` to 3 replicas: the new one captures
    its bucket at boot from the store (``hydrated`` > 0, no live capture)
    and nothing on the request path, its answers bitwise equal too.
    Returns the launches."""
    import shutil

    import numpy as np

    from seldon_core_tpu_torch.gateway.app import Gateway
    from seldon_core_tpu_torch.gateway.store import (
        DeploymentRecord,
        DeploymentStore,
    )
    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.operator.local import LocalFleet
    from seldon_core_tpu_torch.runtime.component import ComponentHandle

    WIRE_DIR.mkdir(parents=True, exist_ok=True)
    store_dir = WIRE_DIR / "fleet_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    rng = np.random.default_rng(29)
    imgs = rng.integers(0, 256, (FLEET_IMAGES, 224, 224, 3)).astype(
        np.float32)
    bodies = [_bin_body(imgs[i:i + 1]) for i in range(FLEET_IMAGES)]
    local = ComponentHandle(wire_resnet(True), name="resnet")
    graph = GraphEngine({"name": "resnet", "type": "MODEL"},
                        resolver=lambda u, h=local: h)
    want = [asyncio.run(graph.predict(SeldonMessage.from_ndarray(
        imgs[i:i + 1]))).to_dict()["data"] for i in range(FLEET_IMAGES)]
    del local, graph
    torch.cuda.empty_cache()
    ann = {"seldon.io/graph-plan": "fused", "seldon.io/batching": "false",
           "seldon.io/artifact-store": str(store_dir),
           "seldon.io/fleet-replicas": "2",
           "seldon.io/fleet-max-replicas": "3"}
    policies = ("round-robin", "consistent-hash", "least-loaded")
    out = {"phase": "fleet_resnet50", "card": CARD,
           "model": "int8 ResNet50 (3, 4, 6, 3), 224x224x3, 1000 classes, "
                    "fused, batching off, artifact store",
           "requests_per_policy": FLEET_REQUESTS}
    failed = []

    async def run():
        t0 = time.perf_counter()
        fl = await LocalFleet(_resnet_graph(True, ann)).start()
        res = {"boot_s": time.perf_counter() - t0}
        store = DeploymentStore()
        for policy in policies:
            store.put(DeploymentRecord(
                name=f"fleet-{policy}", oauth_key=policy, oauth_secret="s",
                engine_urls=fl.urls(),
                annotations={"seldon.io/fleet-replicas": "2",
                             "seldon.io/fleet-policy": policy}))
        gw = Gateway(store)
        gport = (await gw.start("127.0.0.1", 0)).port
        try:
            auth = {}
            for policy in policies:
                tok = await asyncio.to_thread(_gw_token, gport, policy, "s",
                                              "form")
                auth[policy] = {"Authorization": f"Bearer {tok}"}

            def check(answers, idx, what):
                # each failure with its seconds, replica and body: what
                # ran out (a 504's reason says which budget)
                bad = [(a[0], a[3], a[1].get("x-seldon-replica"),
                        a[2][:300].decode("utf-8", "replace"))
                       for a in answers if a[0] != 200]
                if bad:
                    raise AssertionError(f"fleet_resnet50 {what}: {bad[:3]}")
                n = sum(json.loads(a[2])["data"] == want[i]
                        for a, i in zip(answers, idx))
                if n != len(idx):
                    failed.append(f"{what}: {n} of {len(idx)} bitwise equal")
                return n

            idx = [k % FLEET_IMAGES for k in range(FLEET_REQUESTS)]
            per = {}
            for policy in policies:
                answers = await _in_threads(_gw_post, [
                    (gport, "/api/v0.1/predictions", bodies[i],
                     auth[policy]) for i in idx])
                homes = {}
                for a, i in zip(answers, idx):
                    homes.setdefault(i, set()).add(a[1]["x-seldon-replica"])
                served = sorted({r for s in homes.values() for r in s})
                per[policy] = {
                    "bitwise_equal": check(answers, idx, policy),
                    "replicas_served": served,
                    "p50_p95": _pctl([a[3] * 1e3 for a in answers])}
                if policy == "consistent-hash":
                    sticky = all(len(s) == 1 for s in homes.values())
                    per[policy]["equal_bodies_one_replica"] = sticky
                    if not sticky:
                        failed.append(f"consistent-hash homes {homes}")
                elif policy == "round-robin" and served != ["r0", "r1"]:
                    failed.append(f"round-robin served {served}")
            res["policies"] = per
            # session affinity: the stream route pins a session's replica
            pool = gw._pools["fleet-round-robin"][2]
            bound = {}
            for k in range(8):
                sess = f"session-{k % 2}"
                code, _, raw, _ = await asyncio.to_thread(
                    _gw_post, gport, "/api/v0.1/stream", bodies[0],
                    {**auth["round-robin"], "X-Seldon-Session": sess})
                bound.setdefault(sess, []).append(
                    (code, pool.session_url(sess)))
            res["session_affinity"] = {
                s: sorted({u for _, u in v}) for s, v in bound.items()}
            if not all(len({u for _, u in v}) == 1 and None not in
                       {u for _, u in v} and {c for c, _ in v} == {501}
                       for v in bound.values()):
                failed.append(f"session affinity {bound}")
            # kill replica 1 in a burst of 64: the first 48 go out at
            # once, and r1 is killed when 16 answers are back, so that it
            # holds at least 8 of its 24 (drained, each answered); the
            # last 16 go out once the gateway has seen r1's idle
            # keep-alive connections close, so their picks of r1 fail to
            # connect and are replayed on r0 (a POST on a connection that
            # closes under it may have been read, and is never replayed)
            half = FLEET_REQUESTS * 3 // 4
            answered = []

            def post_counted(i):
                a = _gw_post(gport, "/api/v0.1/predictions", bodies[i],
                             auth["round-robin"])
                answered.append(a[0])
                return a

            first = asyncio.ensure_future(_in_threads(
                post_counted, [(idx[k],) for k in range(half)]))
            while len(answered) < 16 and not first.done():
                await asyncio.sleep(0.001)
            in_hand_r1 = next(r for r in pool.snapshot()["replicas"]
                              if r["replica"] == "r1")["inflight"]
            killing = asyncio.ensure_future(fl.kill(1))
            await asyncio.sleep(0.05)
            rest = await _in_threads(post_counted, [
                (idx[k],) for k in range(half, FLEET_REQUESTS)])
            kill_answers = await first + rest
            await killing
            codes = sorted({a[0] for a in kill_answers})
            check(kill_answers, idx, "kill burst")
            snap = pool.snapshot()
            r1 = next(r for r in snap["replicas"] if r["replica"] == "r1")
            code, health = await asyncio.to_thread(
                _get_json, gport,
                "/admin/fleet/health?deployment=fleet-round-robin&refresh=1")
            res["kill"] = {
                "codes": codes, "r1": r1, "in_hand_at_r1": in_hand_r1,
                "after_kill_served": sorted({a[1].get("x-seldon-replica")
                                             for a in rest}),
                "fleet_health": {k: health.get(k) for k in (
                    "verdict", "partial", "unreachable")},
                "r1_health": health.get("replicas", {}).get("r1")}
            if not (codes == [200] and in_hand_r1 > 0
                    and r1["ejections"] >= 1
                    and r1["state"] in ("ejected", "probing")
                    and code == 200 and health.get("partial") is True
                    and "r1" in health.get("unreachable", ())
                    and (health.get("replicas", {}).get("r1") or {})
                    .get("unreachable") is True):
                failed.append(f"kill drill {res['kill']}")
            # autoscale to 3: the new replica boots warm from the store
            t1 = time.perf_counter()
            d = await fl.autoscale_tick({"demandRps": 20.0,
                                         "capacityRps": 10.0})
            scale_s = time.perf_counter() - t1
            new = fl.replicas()[-1]
            nport = int(new["url"].rsplit(":", 1)[1])
            at_boot = (await asyncio.to_thread(_get_json, nport,
                                               "/admin/artifacts"))[1]
            answers = await _in_threads(_gw_post, [
                (nport, "/api/v0.1/predictions", bodies[i], {})
                for i in range(FLEET_IMAGES)])
            after = (await asyncio.to_thread(_get_json, nport,
                                             "/admin/artifacts"))[1]
            res["autoscale"] = {
                "decision": d.to_dict(), "replicas": len(fl),
                "scale_up_s": scale_s, "new_replica": new["rid"],
                "coverage": new.get("artifact_coverage"),
                "hydrated_at_boot": at_boot.get("hydrated"),
                "live_at_boot": at_boot.get("liveCompiles"),
                "request_path_captures": (after.get("liveCompiles", 0)
                                          - at_boot.get("liveCompiles", 0)),
                "bitwise_equal": check(answers, list(range(FLEET_IMAGES)),
                                       "new replica"),
                "first_request_ms": answers[0][3] * 1e3}
            a = res["autoscale"]
            if not (d.desired == 3 and len(fl) == 3
                    and (a["hydrated_at_boot"] or 0) > 0
                    and a["live_at_boot"] == 0
                    and a["request_path_captures"] == 0):
                failed.append(f"autoscale {a}")
            return res
        finally:
            await gw.close()
            await fl.stop()

    reset_launches()
    try:
        out.update(asyncio.run(run()))
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    launches = read_launches()
    out["launches"] = launches
    emit(out)
    if failed or launches["int8_matmul"] <= 0:
        raise AssertionError(f"fleet_resnet50: {failed} {launches}")
    return launches


LOADTEST_7B_S = 4.0  # seconds of each closed loop


def loadtest_7b_phase(torch, params) -> dict:
    """The port's load harness (``tools/loadtest.py``) against
    ``serve_7b``'s model behind the local runner's REST (in process, as
    ``gateway_7b`` boots it): ``RestDriver`` on ``/api/v0.1/predictions``
    and ``SseStreamDriver`` on ``/api/v0.1/stream``, each as 8 workers,
    one per ``serve_7b`` prompt (16 new tokens), closed loop for
    LOADTEST_7B_S seconds, every answer recorded.  Gated: no failure,
    every recorded greedy id sequence (REST bodies, each stream's last
    event) equal to ``serve_7b``'s for that prompt, and K1, K2 and K3
    launched.  Reported: requests, req/s, p50/p95 latency, the streams'
    TTFT/TPOT medians and tokens/s beside ``serve_7b``'s engine latencies
    medians.  Returns the launches."""
    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.tools.loadtest import (
        RestDriver,
        SseStreamDriver,
        run_load,
    )

    OBSERVE_7B["params"] = params
    prompts, want = SERVE_7B["prompts"], SERVE_7B["ids"]
    out = {"phase": "loadtest_7b", "card": CARD, "workers": len(prompts),
           "n_new": 16, "seconds_each": LOADTEST_7B_S,
           "path": "tools.loadtest -> runner REST -> LLMComponent "
                   "-> PagedLLMEngine (in process)"}
    failed = []

    def keeping(cls):
        class Keeping(cls):
            """``cls`` keeping every answer (REST: the body; SSE: the
            stream's last event) in ``bodies``."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.bodies = []

            async def __call__(self):
                self.bodies.append(await super().__call__())
        Keeping.__name__ = cls.__name__
        return Keeping

    async def drive(cls, base):
        loads = [keeping(cls)(base, {"jsonData": {"prompt_ids": p,
                                                  "n_new": 16}})
                 for p in prompts]
        results = await asyncio.gather(*(
            run_load(d, seconds=LOADTEST_7B_S, concurrency=1, warmup_s=0.0,
                     protocol=cls.__name__) for d in loads))
        return loads, results

    def summary(results) -> dict:
        lat = [x for r in results for x in r.latencies_ms]
        n = sum(r.requests for r in results)
        return {"requests": n,
                "failures": sum(r.failures for r in results),
                "req_per_s": n / LOADTEST_7B_S,
                "latency_ms": _pctl(lat) if lat else None}

    async def run():
        server, local = await serve(_observe_7b_graph(False), port=0,
                                    host="127.0.0.1")
        engine = local.engine.node_impl("llm").user.engine
        base = f"http://127.0.0.1:{server.port}"
        try:
            # warm-up: every prefill bucket of the 8 prompts is captured
            warm = await _post_all(server.port, [
                {"jsonData": {"prompt_ids": p, "n_new": 16}}
                for p in prompts])
            if [b["jsonData"]["ids"] for _, b in warm] != want:
                failed.append("warm-up ids differ from serve_7b's")
            res = {}
            rest, rest_res = await drive(RestDriver, base)
            res["rest"] = summary(rest_res)
            for i, d in enumerate(rest):
                got = [json.loads(b)["jsonData"]["ids"] for b in d.bodies]
                if not got or any(g != want[i] for g in got):
                    failed.append(f"REST prompt {i}: ids differ")
            sse, sse_res = await drive(SseStreamDriver, base)
            res["sse"] = summary(sse_res)
            ttft = [x for d in sse for x in d.ttfts_ms]
            tpot = [x for d in sse for x in d.tpots_ms]
            tokens = sum(d.tokens for d in sse)
            res["sse"].update(
                ttft_ms_median=statistics.median(ttft) if ttft else None,
                tpot_ms_median=statistics.median(tpot) if tpot else None,
                tokens=tokens, tokens_per_s=tokens / LOADTEST_7B_S)
            for i, d in enumerate(sse):
                if not d.bodies or any(
                        not (e or {}).get("done") or e["ids"] != want[i]
                        for e in d.bodies):
                    failed.append(f"stream prompt {i}: ids differ")
            if engine.free_pages != 95:
                failed.append(f"pages not returned ({engine.free_pages})")
            return res
        finally:
            await server.stop()
            await local.aclose()
            engine.close()

    reset_launches()
    try:
        out.update(asyncio.run(run()))
    finally:
        OBSERVE_7B.clear()
    out["serve_7b"] = {k: SERVE_7B.get(k) for k in (
        "ttft_ms_median", "tpot_ms_median", "tokens_per_s")}
    launches = read_launches()
    out["launches"] = launches
    emit(out)
    for what in ("rest", "sse"):
        if out[what]["failures"] or out[what]["requests"] < len(prompts):
            failed.append(f"{what}: {out[what]}")
    if failed or not all(n > 0 for n in launches.values()):
        raise AssertionError(f"loadtest_7b: {failed} {launches}")
    return launches


OPERATOR_SINGLES = 4  # api-test requests
OPERATOR_LOAD_S = 2.0
OPERATOR_LOAD_WORKERS = 8
OPERATOR_DRAIN_LEAD_S = 0.5  # load on the old pod before its preStop runs

# the first reconcile of the CR in a fresh process: the module's import,
# then the reconcile (the admission lint's trace of the registry included)
COLD_RECONCILE = r"""
import json, sys, time
t0 = time.perf_counter()
from seldon_core_tpu_torch.operator.reconcile import (
    FakeKubeApi, SeldonDeploymentController)
t1 = time.perf_counter()
cr = json.load(open(sys.argv[1]))
api = FakeKubeApi()
api.create(cr)
status = SeldonDeploymentController(api).reconcile(api.get(
    "SeldonDeployment", cr["metadata"]["namespace"], cr["metadata"]["name"]))
print(json.dumps({"import_s": t1 - t0, "create_s": time.perf_counter() - t1,
                  "state": status["state"]}))
"""


def _cold_reconcile(cr: dict) -> dict:
    """``COLD_RECONCILE`` over ``cr`` in a child process of its own."""
    import os

    path = WIRE_DIR / "operator_cr.json"
    path.write_text(json.dumps(cr))
    proc = subprocess.run(
        [sys.executable, "-c", COLD_RECONCILE, str(path)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cold reconcile: rc {proc.returncode} "
                             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _operator_cr(store: str) -> dict:
    """The CR the operator phase applies: ``resnet50-int8.json`` with its
    annotations moved onto the predictor (``ENGINE_PREDICTOR`` carries the
    predictor's own, as the reference's compiler writes it), the smoke
    ResNet's node (``wire_resnet``'s seeds, int8), and the fused plan, the
    health plane and the artifact plane on ``store``."""
    d = _resnet_graph(True, {})
    pred = d["spec"]["predictors"][0]
    pred["annotations"] = {**d["spec"].pop("annotations"),
                           "seldon.io/graph-plan": "fused",
                           "seldon.io/health": "true",
                           "seldon.io/artifact-store": store}
    d["metadata"] = {"name": d["spec"]["name"], "namespace": "default",
                     "uid": "uid-operator-smoke"}
    return d


def _u8_body(x) -> bytes:
    """A uint8 binTensor request body (a 224x224x3 image is ~200 KB in
    base64, under the flight recorder's body cap)."""
    import base64

    return json.dumps({"data": {"binTensor": {
        "shape": list(x.shape), "dtype": "uint8",
        "b64": base64.b64encode(x.tobytes()).decode()}}}).encode()


class _Pod:
    """The kubelet stand-in's pod: the workload's engine container booted
    as a runner child with exactly the container's env, the ports moved to
    free ones."""

    def __init__(self, label: str, workload: dict):
        container = workload["spec"]["template"]["spec"]["containers"][0]
        self.container = container
        self.port, self.grpc = _free_port(), _free_port()
        env = {e["name"]: e["value"] for e in container["env"]}
        env.update(ENGINE_SERVER_PORT=str(self.port),
                   ENGINE_SERVER_GRPC_PORT=str(self.grpc))
        self.t0 = time.perf_counter()
        self.child, self.counts = runner_child(label, [], env)
        self.base = f"http://127.0.0.1:{self.port}"

    def ready(self, timeout: float = 600) -> float:
        """Wait on the readinessProbe path; seconds from boot."""
        path = self.container["readinessProbe"]["httpGet"]["path"]
        deadline = time.monotonic() + timeout
        while True:
            if self.child.proc.poll() is not None:
                raise AssertionError(f"{self.child.label} exited: "
                                     f"{self.child.tail()}")
            try:
                if _get(self.port, path)[0] == 200:
                    return time.perf_counter() - self.t0
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.child.label} not ready: "
                                     f"{self.child.tail()}")
            time.sleep(0.2)

    def pre_stop(self) -> tuple:
        """Run the container's preStop hook (its ``curl`` of the engine's
        ``/pause``) against this pod's port; ``(status, body, seconds)``."""
        cmd = " ".join(self.container["lifecycle"]["preStop"]["exec"][
            "command"])
        path = re.search(r"localhost:\d+(/\S*)", cmd).group(1)
        t0 = time.perf_counter()
        code, body = _get(self.port, path)
        return code, body, time.perf_counter() - t0

    def stop_under_load(self, payload: dict) -> dict:
        """The kubelet's stop of this pod while OPERATOR_LOAD_WORKERS
        closed-loop ``RestDriver`` workers keep sending to it: after
        OPERATOR_DRAIN_LEAD_S of load the preStop hook runs, then SIGTERM
        is sent, and the workers stop once the process has exited.  Every
        request is logged as ``(sent, answered, outcome)``; reported: the
        requests in hand when the hook began, the hook's status, body and
        seconds, the exit code, and the outcomes of the requests sent
        before and after the hook began."""
        from seldon_core_tpu_torch.tools.loadtest import RestDriver

        async def run():
            log, done = [], asyncio.Event()

            async def worker(driver):
                while not done.is_set():
                    t0 = time.perf_counter()
                    try:
                        await driver()
                        outcome = "200"
                    except Exception as e:  # logged; judged after the run
                        outcome = f"{type(e).__name__}: {e}"[:120]
                    log.append((t0, time.perf_counter(), outcome))
                    if outcome != "200":
                        await asyncio.sleep(0.01)  # refused: no busy loop

            async with RestDriver(self.base, payload) as driver:
                workers = [asyncio.create_task(worker(driver))
                           for _ in range(OPERATOR_LOAD_WORKERS)]
                await asyncio.sleep(OPERATOR_DRAIN_LEAD_S)
                t_hook = time.perf_counter()
                code, body, hook_s = await asyncio.to_thread(self.pre_stop)
                exit_code = await asyncio.to_thread(self.child.stop)
                done.set()
                await asyncio.gather(*workers)
            return log, t_hook, code, body, hook_s, exit_code

        log, t_hook, code, body, hook_s, exit_code = asyncio.run(run())
        before = [r for r in log if r[0] < t_hook]
        after = [r for r in log if r[0] >= t_hook]

        def outcomes(rows):
            tally: dict = {}
            for _, _, o in rows:
                tally[o] = tally.get(o, 0) + 1
            return tally

        return {
            "in_hand_at_prestop": sum(1 for t0, t1, _ in before
                                      if t1 > t_hook),
            "prestop_status": code, "prestop_body": body.strip(),
            "prestop_s": hook_s, "old_exit": exit_code,
            "sent_before": len(before), "outcomes_before": outcomes(before),
            "last_answer_after_prestop_began_s": max(
                (t1 for _, t1, _ in before), default=t_hook) - t_hook,
            "sent_after": len(after), "outcomes_after": outcomes(after)}


def operator_resnet50_phase(torch) -> dict:
    """Slice 5b-ii: the port's operator around a real engine.  The
    controller reconciles ``_operator_cr`` into a ``FakeKubeApi``
    (Creating); a kubelet stand-in boots the engine Deployment's container
    as a runner child from its env alone (no ``--graph``), waits on its
    readinessProbe and marks the workload available (Available, replicas
    1 of 1).  Through the port's tools: ``api-test`` with
    ``examples/contracts/resnet50.json`` (answers bitwise equal to the
    walk graph in process over the same weights), ``load`` closed loop
    over REST (uint8 binTensor) and gRPC; one request through a gateway
    child with the health plane gives a flight record.  Rolling update:
    one predictor annotation edited, the workload updated with a new spec
    hash, the old pod's preStop run and SIGTERM sent while closed-loop
    workers keep sending to it (every request sent before the hook began
    answers 200, and some are in hand when it begins), the new pod booted
    from the new env; ``replay`` of the record against it answers EQUAL
    to the old pod's answer and stamped ``aot-cache`` (hydrated from the
    store).  Deleting the CR prunes every owned object.  The first
    reconcile (admission lint included) is timed twice: cold, in a fresh
    process (``COLD_RECONCILE``), and warm, in this one, where the
    ``lint`` phase has already traced the registry.  Returns the
    children's launches."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.operator.reconcile import (
        FakeKubeApi,
        SeldonDeploymentController,
    )
    from seldon_core_tpu_torch.runtime.component import ComponentHandle
    from seldon_core_tpu_torch.tools import replay
    from seldon_core_tpu_torch.tools.contract import Contract
    from seldon_core_tpu_torch.tools.loadtest import (
        GrpcDriver,
        RestDriver,
        run_load,
    )
    from seldon_core_tpu_torch.tools.tester import test_api

    local = ComponentHandle(wire_resnet(True), name="resnet")
    graph = GraphEngine({"name": "resnet", "type": "MODEL"},
                        resolver=lambda u, h=local: h)

    def in_process(payload):
        return asyncio.run(graph.predict(SeldonMessage.from_dict(
            payload))).to_dict()["data"]

    WIRE_DIR.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(prefix="operator_store_", dir=WIRE_DIR)
    cr = _operator_cr(store)
    ns, name = cr["metadata"]["namespace"], cr["metadata"]["name"]
    pred = cr["spec"]["predictors"][0]["name"]
    workload = f"{name}-{pred}"
    rng = np.random.default_rng(31)
    single = _u8_body(rng.integers(0, 256, (1, 224, 224, 3)).astype(
        np.uint8))
    load_payload = json.loads(single)
    out = {"phase": "operator_resnet50", "card": CARD, "workload": workload,
           "path": "CR -> controller -> FakeKubeApi -> stand-in kubelet -> "
                   "runner child (env only) -> tools"}
    failed, pods, gw = [], [], None
    api = FakeKubeApi()
    ctl = SeldonDeploymentController(api)

    def reconcile(label):
        t0 = time.perf_counter()
        status = ctl.reconcile(api.get("SeldonDeployment", ns, name))
        out.setdefault("reconcile_s", {})[label] = \
            time.perf_counter() - t0
        return status

    try:
        cold = _cold_reconcile(cr)
        out["reconcile_cold"] = cold
        if cold["state"] != "Creating":
            failed.append(f"cold reconcile: {cold}")
        api.create(cr)
        status = reconcile("create_warm")
        out["status_create"] = status["state"]
        if status["state"] != "Creating":
            failed.append(f"after create: {status}")
        old = _Pod("op_old", api.get("Deployment", ns, workload))
        pods.append(old)
        out["old_ready_s"] = old.ready()
        api.set_workload_available(ns, workload, 1)
        status = reconcile("available")
        out["status_available"] = status
        if status["state"] != "Available" or status["predictorStatus"] != [
                {"name": pred, "replicas": 1, "replicasAvailable": 1}]:
            failed.append(f"after ready: {status}")

        # the tools against the old pod
        c = Contract.load(str(ROOT / "examples" / "contracts"
                              / "resnet50.json"))
        report = asyncio.run(test_api(c, old.base, n_requests=OPERATOR_SINGLES,
                                      seed=0))
        draws = np.random.default_rng(0)  # test_api's draws, seed 0
        want = [in_process(c.rest_request(1, rng=draws))
                for _ in range(OPERATOR_SINGLES)]
        got = [r.get("data") for r in report.responses]
        out["api_test"] = {"sent": report.sent, "ok": report.ok,
                           "failures": report.failures[:3],
                           "bitwise_equal": sum(
                               g == w for g, w in zip(got, want))}
        if not report.ok or out["api_test"]["bitwise_equal"] != \
                OPERATOR_SINGLES:
            failed.append(f"api-test: {out['api_test']}")
        for label, load in (
                ("rest", RestDriver(old.base, load_payload)),
                ("grpc", GrpcDriver(f"127.0.0.1:{old.grpc}", load_payload))):
            res = asyncio.run(run_load(
                load, seconds=OPERATOR_LOAD_S,
                concurrency=OPERATOR_LOAD_WORKERS, warmup_s=0.2,
                protocol=label)).to_dict()
            out[f"load_{label}"] = {k: res[k] for k in (
                "requests", "failures", "req_per_s")} | {
                "p50_ms": res["latency_ms"]["p50"],
                "p95_ms": res["latency_ms"]["p95"]}
            if res["failures"] or not res["requests"]:
                failed.append(f"load {label}: {out[f'load_{label}']}")

        # a flight record of one request, through a gateway child
        gport = _free_port()
        cfg = WIRE_DIR / "operator_gateway.json"
        cfg.write_text(json.dumps({"deployments": [{
            "name": name, "oauth_key": "op", "oauth_secret": "s-op",
            "engine_url": old.base}]}))
        gw = Child([sys.executable, "-m", "seldon_core_tpu_torch.gateway.app",
                    "--config", str(cfg), "--port", str(gport),
                    "--host", "127.0.0.1", "--grpc-port", "0"],
                   env={"SELDON_HEALTH": "true"}, label="op_gateway")
        gw.wait_for("gateway REST on")
        tok = _gw_token(gport, "op", "s-op", "form")
        code, _, old_answer, _ = _gw_post(
            gport, "/api/v0.1/predictions", single,
            {"Authorization": f"Bearer {tok}"})
        if code != 200:
            raise AssertionError(f"operator gateway: {code} "
                                 f"{old_answer[:300]!r}")
        records = json.loads(_get(gport, "/admin/flightrecorder?n=1")[1])[
            "records"]
        record = records[0]
        rec_path = WIRE_DIR / "operator_flight_record.json"
        rec_path.write_text(json.dumps({"records": [record]}))
        out["flight_record"] = {
            "body_bytes": len(single),
            "truncated": record.get("requestTruncated"),
            "path": (record.get("request") or {}).get("path")}
        if record.get("requestTruncated") or not record.get("request"):
            failed.append(f"flight record without its body: "
                          f"{out['flight_record']}")
        gw.stop()
        gw = None

        # rolling update: one annotation edited
        live = api.get("SeldonDeployment", ns, name)
        old_hash = api.get("Deployment", ns, workload)["metadata"][
            "annotations"]["seldon.io/spec-hash"]
        ann = live["spec"]["predictors"][0].setdefault("annotations", {})
        ann["seldon.io/batch-max-delay-ms"] = "1.0"
        api.update(live)
        n_actions = len(api.actions)
        reconcile("update")
        new_dep = api.get("Deployment", ns, workload)
        new_hash = new_dep["metadata"]["annotations"]["seldon.io/spec-hash"]
        out["rolling_update"] = {
            "old_hash": old_hash, "new_hash": new_hash,
            "actions": api.actions[n_actions:]}
        if new_hash == old_hash or ("update", "Deployment", workload) \
                not in api.actions[n_actions:]:
            failed.append(f"rolling update: {out['rolling_update']}")
        drain = old.stop_under_load(load_payload)
        out["rolling_update"].update(drain)
        if drain["prestop_status"] != 200 or \
                drain["prestop_body"] != "paused inflight=0":
            failed.append(f"preStop: {drain}")
        if drain["in_hand_at_prestop"] <= 0 or \
                drain["outcomes_before"] != {"200": drain["sent_before"]}:
            failed.append(f"drain under load: {drain}")
        new = _Pod("op_new", new_dep)
        pods.append(new)
        out["new_ready_s"] = new.ready()
        api.set_workload_available(ns, workload, 1)
        status = reconcile("after_update")
        if status["state"] != "Available":
            failed.append(f"after update: {status}")

        # replay the old pod's record against the new pod
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            rc = replay.main(["--record", str(rec_path), "--to", new.base,
                              "--expect-artifact-source", "aot-cache"])
        code, new_answer = replay.replay_record(record, new.base)
        equal, detail = replay.compare_responses(old_answer, new_answer)
        out["replay"] = {"rc": rc, "status": code, "equal": equal,
                         "detail": detail,
                         "artifact_source": replay.artifact_source(
                             new_answer),
                         "output": buf.getvalue().splitlines()[:3]}
        if rc != 0 or code != 200 or not equal:
            failed.append(f"replay: {out['replay']}")

        # delete: every owned object pruned
        api.delete("SeldonDeployment", ns, name)
        pruned = ctl.prune(ns, name)
        left = [o["metadata"]["name"] for k in ("Deployment", "StatefulSet",
                                                 "Service")
                for o in api.list(k, ns)]
        out["delete"] = {"pruned": pruned, "left": left}
        if pruned < 2 or left:
            failed.append(f"delete: {out['delete']}")
    finally:
        if gw is not None:
            gw.stop()
        for p in pods:
            p.child.stop()
        shutil.rmtree(store, ignore_errors=True)
        del local, graph
        gc.collect()
        torch.cuda.empty_cache()
    launches = {"int8_matmul": 0, "paged_attention": 0, "flash_attention": 0}
    for p in pods:
        for k, v in _child_launches(p.counts).items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    emit(out)
    if launches["int8_matmul"] <= 0:
        failed.append(f"K1 launches {launches}")
    if failed:
        raise AssertionError(f"operator_resnet50: {failed}")
    return launches


def ptxas_report(log: str) -> list:
    """Registers, spills and shared memory per kernel from the build's
    ``-Xptxas -v`` output, names demangled where ``c++filt`` exists."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r["function"] for r in rows),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["function"] = n
    except OSError:
        pass  # mangled names then
    return rows


# ----------------------------------------------------------------------
# slice 6c: training
# ----------------------------------------------------------------------

TRAIN_STEPS = 10


def _train_cfg(torch, **kw):
    """The reference's default ``TransformerConfig`` widths with 4 experts,
    top-2, capacity factor 2.0, ``use_flash`` and bf16 activations."""
    from seldon_core_tpu_torch.models.transformer import TransformerConfig

    base = dict(vocab_size=32000, d_model=512, n_layers=8, n_heads=8,
                d_ff=2048, max_seq=2048, n_experts=4, top_k=2,
                capacity_factor=2.0, use_flash=True, dtype=torch.bfloat16)
    return TransformerConfig(**{**base, **kw})


def _train_batch(torch, gen, B, L, vocab):
    """``B`` rows of ``L`` tokens (and their next tokens as targets) drawn
    uniformly from the first ``vocab // 32`` ids: a distribution a few
    steps can learn (its entropy ln 1000 = 6.9 against the initial loss
    near ln 32000 = 10.4), so fresh batches show the loss fall."""
    ids = torch.randint(0, vocab // 32, (B, L + 1), generator=gen,
                        device="cuda")
    return {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}


def _clone_tree(tree, device=None):
    if isinstance(tree, dict):
        return {k: _clone_tree(v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device or tree.device)


def _grad_tree(tree):
    """A param tree's gradients, placed pieces unsharded."""
    from seldon_core_tpu_torch.parallel.mesh import Shards, unshard

    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return unshard(Shards([_grad_tree(t) for t in tree], tree.dim,
                              tree.axis))
    return tree.grad


def _sdpa(torch, causal_mask=True):
    """Attention through ``torch.nn.functional.scaled_dot_product_attention``
    in ``flash_attention``'s layout; ``causal_mask=False`` drops the mask
    whatever the caller asks (the gate's control)."""
    F = torch.nn.functional

    def attn(q, k, v, causal=True):
        g = q.shape[2] // k.shape[2]
        k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal and causal_mask).transpose(1, 2)

    return attn


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _train_grad_check(torch, params, batches, cfg) -> dict:
    """The flash kernel under autograd (module docstring, phase 38):
    wq/wk/wv gradients of ``lm_loss`` through K3 against the plain
    version's, in float32 on ``batches[0]`` and in bf16 on every batch
    beside the SDPA witness and the unmasked control."""
    import dataclasses

    import seldon_core_tpu_torch.models.transformer as tr
    import seldon_core_tpu_torch.parallel.moe as moe
    from seldon_core_tpu_torch.models.transformer import lm_loss, param_leaves

    names = ("wq", "wk", "wv")

    def grads(batch, dtype, flash, attn=None):
        ids = []
        route = moe.moe_route

        def record(*a, **kw):
            r = route(*a, **kw)
            ids.append(r["gate_idx"])
            return r

        for t in param_leaves(params):
            t.grad = None
            t.requires_grad_(True)
        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(moe, "moe_route", record))
            if attn is not None:
                stack.enter_context(_patched(tr, "flash_attention", attn))
            lm_loss(params, batch, dataclasses.replace(
                cfg, use_flash=flash, dtype=dtype)).backward()
        return ({n: params["blocks"][n].grad.clone() for n in names},
                torch.cat([i.flatten() for i in ids]))

    def gap(a, b):
        return {n: {"rel_l2": ((a[0][n] - b[0][n]).norm()
                               / b[0][n].norm()).item(),
                    "max_err_over_max": ((a[0][n] - b[0][n]).abs().max()
                                         / b[0][n].abs().max()).item()}
                for n in names} | {
            "topk_ids_differing": (a[1] != b[1]).float().mean().item()}

    out = {}
    flash, dense = (grads(batches[0], torch.float32, f) for f in (True,
                                                                   False))
    out["float32"] = gap(flash, dense) | {"tolerance": "rel_l2 1e-3"}
    bad = [n for n in names if not (flash[0][n].abs().sum().item() > 0
                                    and out["float32"][n]["rel_l2"] <= 1e-3)]
    if bad:
        raise AssertionError(f"train_moe float32 gradients of {bad}: {out}")
    out["bfloat16"] = []
    for batch in batches:
        dense = grads(batch, torch.bfloat16, False)
        flash = grads(batch, torch.bfloat16, True)
        out["bfloat16"].append({
            "flash": gap(flash, dense),
            "witness_sdpa": gap(grads(batch, torch.bfloat16, True,
                                      _sdpa(torch)), dense),
            "control_unmasked": gap(grads(batch, torch.bfloat16, True,
                                          _sdpa(torch, False)), dense),
            "flash_abs_sum": {n: flash[0][n].abs().sum().item()
                              for n in names}})
    for t in param_leaves(params):
        t.grad = None
    limit = {m: 2 * max(r["witness_sdpa"][n][m] for r in out["bfloat16"]
                        for n in names)
             for m in ("rel_l2", "max_err_over_max")}
    out["bfloat16_limit"] = limit
    for r in out["bfloat16"]:
        for n in names:
            for m, lim in limit.items():
                if not r["control_unmasked"][n][m] > lim:
                    raise AssertionError(
                        f"train_moe: the bf16 gate cannot tell the control "
                        f"({n} {m}): {out}")
                if not (r["flash_abs_sum"][n] > 0 and r["flash"][n][m] <= lim):
                    raise AssertionError(
                        f"train_moe bf16 gradient of {n} ({m}): {out}")
    return out


def train_moe_phase(torch) -> dict:
    """The MoE transformer trained at full width on the card (module
    docstring, phase 38).  Returns the launches of the ten steps."""
    import shutil

    from seldon_core_tpu_torch.models.transformer import (
        generate,
        init_params,
        make_train_step,
    )
    from seldon_core_tpu_torch.runtime.checkpoint import (
        load_transformer,
        save_transformer,
    )

    cfg = _train_cfg(torch)
    params = init_params(torch.Generator(device="cuda").manual_seed(61),
                         cfg)
    data = torch.Generator(device="cuda").manual_seed(62)
    B, L = 8, 512
    batches = [_train_batch(torch, data, B, L, cfg.vocab_size)
               for _ in range(TRAIN_STEPS)]

    grad_check = _train_grad_check(torch, params, batches[:3], cfg)
    init_opt, step = make_train_step(cfg, learning_rate=1e-3)
    opt = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    reset_launches()
    losses, step_s = [], []
    for batch in batches:
        t = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and launches["flash_attention"] == cfg.n_layers * TRAIN_STEPS):
        raise AssertionError(f"train_moe: losses {losses}, {launches}")
    step_ms = statistics.median(step_s[1:]) * 1e3

    path = ROOT / "build" / "train_moe"
    shutil.rmtree(path, ignore_errors=True)
    save_transformer(str(path), params, cfg)
    loaded, lcfg = load_transformer(str(path), device="cuda")
    shutil.rmtree(path)
    prompt = batches[0]["input_ids"][:2, :16]
    ids = generate(params, prompt, 16, cfg)
    ids_loaded = generate(loaded, prompt, 16, lcfg)
    if lcfg != cfg or not torch.equal(ids, ids_loaded):
        raise AssertionError("train_moe: the loaded checkpoint decodes "
                             "other ids")
    emit({"phase": "train_moe", "card": CARD,
          "model": "vocab 32000, d_model 512, 8 layers x 8 heads of 64, "
                   "d_ff 2048, 4 experts top-2 cf 2.0, flash, bf16 "
                   "activations, float32 params, AdamW lr 1e-3",
          "batch": [B, L], "steps": TRAIN_STEPS, "losses": losses,
          "step_ms_median": step_ms, "step_ms": [x * 1e3 for x in step_s],
          "tokens_per_s": B * L / (step_ms / 1e3),
          "peak_memory_bytes": peak, "allocated_before_bytes": before,
          "peak_over_before_bytes": peak - before,
          "grads_flash_vs_dense": grad_check,
          "checkpoint_decode_ids_equal": True, "launches": launches})
    return launches


def _plain_step(torch, params, batch, cfg, aux_weight):
    """One AdamW step with no mesh: ``make_train_step``'s optimizer over
    ``lm_loss`` with ``aux_weight`` (0 for the loss a pipelined step takes,
    which carries no aux).  Returns ``(loss before the step, params)``;
    the gradients stay on the leaves."""
    from seldon_core_tpu_torch.models.transformer import (
        lm_loss,
        make_train_step,
    )

    init_opt, _ = make_train_step(cfg)
    opt = init_opt(params)
    loss = lm_loss(params, batch, cfg, aux_weight=aux_weight)
    loss.backward()
    opt.step()
    return float(loss.detach()), params


def train_mesh_phase(torch) -> dict:
    """Training over meshes of ranks of cuda:0 (module docstring, phase
    39).  Returns the launches of (a)-(c)."""
    from seldon_core_tpu_torch.dryrun import (
        TRAINING_PLANS,
        dryrun_batch,
        dryrun_config,
        dryrun_training,
        plan_label,
    )
    from seldon_core_tpu_torch.models.transformer import (
        init_params,
        lm_loss,
        make_train_step,
        param_leaves,
        shard_params,
    )
    from seldon_core_tpu_torch.parallel.mesh import make_mesh, plan_mesh

    out = {"phase": "train_mesh", "card": CARD}
    torch.cuda.synchronize()
    reset_launches()
    # (a) the reference's two training dryrun lines
    out["dryrun"] = []
    for kw in TRAINING_PLANS:
        plan = plan_mesh(8, **kw)
        line, loss, _ = dryrun_training(plan, "cuda")
        cfg = dryrun_config(plan)
        loss_one, _ = _plain_step(
            torch, init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg),
            dryrun_batch(plan, cfg, "cuda"), cfg,
            aux_weight=0.0 if plan.pp > 1 else 0.01)
        out["dryrun"].append({"line": line, "loss": loss,
                              "no_mesh_loss": loss_one})
        TRAIN_MESH[plan_label(plan)] = {"line": line, "loss": loss}
        if not abs(loss - loss_one) <= 1e-4:
            raise AssertionError(f"train_mesh (a): {out['dryrun']}")
    # (b) mesh(dp=2, pp=2, tp=2) at full width, 2 layers, float32
    plan = plan_mesh(8, tp=2, pp=2)
    cfg = _train_cfg(torch, n_layers=2, dtype=torch.float32)
    base = init_params(torch.Generator(device="cuda").manual_seed(63), cfg)
    batch = _train_batch(torch, torch.Generator(device="cuda").manual_seed(
        64), 8, 512, cfg.vocab_size)
    mesh = make_mesh(plan, devices=["cuda:0"] * plan.n_devices)
    placed = shard_params(_clone_tree(base), mesh, cfg, pp=2)
    init_opt, step = make_train_step(cfg, mesh=mesh, pp=2, n_microbatches=2)
    t = time.perf_counter()
    placed, _, loss_sh = step(placed, init_opt(placed), batch)
    loss_sh = float(loss_sh)
    sharded_s = time.perf_counter() - t
    t = time.perf_counter()
    loss_one, one = _plain_step(torch, _clone_tree(base), batch, cfg,
                                aux_weight=0.0)
    one_s = time.perf_counter() - t
    from seldon_core_tpu_torch.parallel.mesh import unshard

    def unshard_tree(tree):
        if isinstance(tree, dict):
            return {k: unshard_tree(v) for k, v in tree.items()}
        return unshard(tree)

    p_err = 0.0
    for a, b, g in zip(param_leaves(unshard_tree(placed)), param_leaves(one),
                       param_leaves(_grad_tree(one))):
        sure = g.abs() >= 1e-6
        p_err = max(p_err, (a.detach() - b.detach())[sure].abs().max().item())
    out["pp2_dp2_tp2"] = {"loss": loss_sh, "unsharded_loss": loss_one,
                          "param_max_err": p_err, "sharded_s": sharded_s,
                          "unsharded_s": one_s}
    if not (abs(loss_sh - loss_one) <= 1e-4 and p_err <= 1e-6):
        raise AssertionError(f"train_mesh (b): {out['pp2_dp2_tp2']}")
    del placed, one, base
    # (c) one step of 2 layers in float32: the card against the CPU
    cfg = _train_cfg(torch, n_layers=2, dtype=torch.float32)
    card = init_params(torch.Generator(device="cuda").manual_seed(65), cfg)
    host = _clone_tree(card, "cpu")
    batch = _train_batch(torch, torch.Generator(device="cuda").manual_seed(
        66), 2, 256, cfg.vocab_size)
    hbatch = {k: v.cpu() for k, v in batch.items()}
    res = {}
    for name, params, b in (("card", card, batch), ("cpu", host, hbatch)):
        for t in param_leaves(params):
            t.requires_grad_(True)
        loss = lm_loss(params, b, cfg)
        loss.backward()
        res[name] = (loss.item(), param_leaves(_grad_tree(params)))
    g_err = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(res["card"][1], res["cpu"][1]))
    out["card_vs_cpu"] = {"loss": res["card"][0], "cpu_loss": res["cpu"][0],
                          "grad_max_err_over_max": g_err}
    if not (abs(res["card"][0] - res["cpu"][0]) <= 1e-4 and g_err <= 1e-3):
        raise AssertionError(f"train_mesh (c): {out['card_vs_cpu']}")
    launches = read_launches()
    # K3 per forward: plan (a)1 4 layers x 2 microbatches x dp 2 x tp 2 and
    # its unsharded step's 4; (b) 2 stages x 1 layer x 2 x 2 x 2 and 2;
    # (c) 2 (ring attention in (a)2 launches none)
    want = 32 + 4 + 16 + 2 + 2
    out["launches"] = launches
    if launches["flash_attention"] != want:
        raise AssertionError(f"train_mesh: K3 launched "
                             f"{launches['flash_attention']}, not {want}")
    emit(out)
    return launches


# ----------------------------------------------------------------------
# slice 6d: multi-host
# ----------------------------------------------------------------------

#: how long each multi-host phase's processes may take, start to end
MULTIHOST_DEADLINE_S = 240.0
#: multihost_7b's requests: serve_7b's prompts 1, 3, 5 and 7 (21, 54, 87
#: and 120 tokens)
MULTIHOST_PICK = (1, 3, 5, 7)
MULTIHOST_DIR = ROOT / "build" / "multihost_7b"


def multihost_dryrun_phase(torch) -> dict:
    """Phase 40 (module docstring).  Returns the workers' launches."""
    from seldon_core_tpu_torch.dryrun import multihost_lines
    from seldon_core_tpu_torch.runtime.multihost import run_multihost_dryrun

    t0 = time.perf_counter()
    r = run_multihost_dryrun(n_hosts=2, devices_per_host=2,
                             timeout=MULTIHOST_DEADLINE_S, device="cuda")
    wall = time.perf_counter() - t0
    lines = multihost_lines(r)
    for line in lines:
        print(f"dryrun_multichip OK: {line}", flush=True)
    emit({"phase": "multihost_dryrun", "lines": lines,
          "mesh": "tp=4: 2 processes x 2 ranks on cuda:0, gloo",
          **{k: r[k] for k in ("n_hosts", "global_devices", "tokens",
                               "paged_tokens", "sampled_tokens",
                               "paged_requests", "spec_rounds",
                               "pinned_pages")},
          "fleet_healthy": r["fleet"]["healthy"], "wall_s": wall,
          "launches": r["launches"], "card": CARD})
    return {k: r["launches"].get(k, 0) for k in _counters()}


def _serve_7b_prompts(torch) -> list:
    """``serve_7b``'s (and ``tp_7b``'s) 8 prompts, 5 .. 120 tokens, from
    their seed."""
    rng = torch.Generator().manual_seed(7)
    lens = [5 + (115 * i) // 7 for i in range(8)]
    return [torch.randint(1, 32000, (n,), generator=rng).tolist()
            for n in lens]


def _multihost_serve(torch, engine, prompts: list, mesh, cfg) -> tuple:
    """A warm-up request, then each prompt at 16 new tokens one after
    another through ``engine.generate``: ids, TTFT/TPOT medians, launches,
    and per decode tick its host ms and the collectives' ms in it (CUDA
    events, ``parallel/mesh.py`` ``transport_stats``); then each prompt's
    prefill logits (1, V) in float32 (not counted in the launches)."""
    from seldon_core_tpu_torch.models.transformer import prefill
    from seldon_core_tpu_torch.parallel import mesh as M

    ticks = []
    plain_tick = engine._tick_device

    def timed_tick(state):
        torch.cuda.synchronize()
        s0 = M.transport_stats()
        t = time.perf_counter()
        out = plain_tick(state)  # the sampled ids, on the host
        ms = (time.perf_counter() - t) * 1e3
        s1 = M.transport_stats()
        ticks.append((ms, s1["device_ms"] - s0["device_ms"],
                      s1["calls"] - s0["calls"]))
        return out

    engine._tick_device = timed_tick

    async def run():
        await engine.generate([1, 2, 3], 2)  # first-use costs stay out
        ticks.clear()
        M.reset_transport_stats()
        reset_launches()
        t = time.perf_counter()
        ids = [(await engine.generate(p, 16))[0].tolist() for p in prompts]
        return ids, time.perf_counter() - t, read_launches(), t

    ids, wall, launches, since = asyncio.run(run())
    moved = M.transport_stats()
    log = _latencies(engine, since)
    logits = []
    with torch.no_grad():
        for p in prompts:
            lg, _ = prefill(engine.params,
                            torch.tensor([p], device=engine.device), cfg,
                            max_len=len(p), logit_pos=len(p) - 1, mesh=mesh)
            logits.append(lg.float().cpu())
    tick_ms = sum(t[0] for t in ticks)
    coll_ms = sum(t[1] for t in ticks)
    return {"ids": ids, "wall_s": wall, "launches": launches,
            "ttft_ms_median": statistics.median(
                x["ttft_s"] for x in log) * 1e3,
            "tpot_ms_median": statistics.median(
                x["tpot_s"] for x in log if x["tpot_s"] is not None) * 1e3,
            "ticks": len(ticks), "tick_ms_median": statistics.median(
                t[0] for t in ticks),
            "collective_ms_per_tick": coll_ms / max(len(ticks), 1),
            "collective_share_of_tick": coll_ms / tick_ms if tick_ms else 0.0,
            "exchanges_per_tick": (ticks[0][2] if ticks else 0),
            "exchanges": moved["calls"], "exchanged_bytes": moved["bytes"],
            "exchange_host_s": moved["host_s"]}, torch.cat(logits)


def _multihost_7b_engine(torch, mesh):
    """``tp_7b``'s weights (seed 6) placed over ``mesh``, in
    ``serve_7b``'s paged engine."""
    from seldon_core_tpu_torch.models.transformer import (
        init_params_int8,
        shard_params,
    )
    from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine
    from seldon_core_tpu_torch.runtime.paged import PagedConfig

    cfg = _cfg_7b(32)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(6)
    base = init_params_int8(gen, cfg, int8="ffn")
    params = shard_params(base, mesh, cfg)
    del base
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = PagedLLMEngine(params, cfg, PagedConfig(n_pages=96,
                                                     page_size=16),
                            max_slots=8, max_len=256, mesh=mesh)
    return engine, cfg, init_s


def multihost_child_main(argv: list) -> int:
    """``chip_smoke.py --multihost-child OUT``: one process of
    ``multihost_7b``: join the slice from the operator's env, hold one tp
    rank on cuda:0, serve the phase's requests, and write the result to
    OUT (JSON) and the prefill logits beside it (``.pt``)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from seldon_core_tpu_torch.parallel.mesh import process_mesh
    from seldon_core_tpu_torch.runtime.multihost import (
        maybe_initialize_distributed,
    )

    out = Path(argv[0])
    if not maybe_initialize_distributed():
        raise SystemExit("multihost child: no multi-host env")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    mesh = process_mesh([torch.device("cuda", 0)])
    engine, cfg, init_s = _multihost_7b_engine(torch, mesh)
    prompts = [_serve_7b_prompts(torch)[i] for i in MULTIHOST_PICK]
    res, logits = _multihost_serve(torch, engine, prompts, mesh, cfg)
    res.update(rank=dist.get_rank(), weights_init_s=init_s,
               tp_span=engine.tp_span(), free_pages=engine.free_pages,
               graphs=engine.program_stats()["graphs"],
               peak_device_bytes=torch.cuda.max_memory_allocated())
    engine.close()
    torch.save(logits, out.with_suffix(".pt"))
    out.write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def _run_multihost_children(phase: str, flag: str, out_dir: Path,
                            n: int = 2) -> list:
    """``n`` processes of this script (``flag OUT``) joined through the
    operator's env on a free loopback port; every one must end with rc 0
    within ``MULTIHOST_DEADLINE_S`` (a failing or hung one fails the phase;
    all are stopped).  Returns their OUT paths."""
    from seldon_core_tpu_torch.runtime import multihost

    out_dir.mkdir(parents=True, exist_ok=True)
    outs = [out_dir / f"child{i}.json" for i in range(n)]
    for o in outs:
        o.unlink(missing_ok=True)
    port = _free_port()
    kids = [Child([sys.executable, str(ROOT / "chip_smoke.py"), flag, str(o)],
                  {multihost.ENV_NUM_HOSTS: str(n),
                   multihost.ENV_WORKER_ID: str(i),
                   multihost.ENV_COORDINATOR: f"127.0.0.1:{port}"},
                  f"{phase}-{i}") for i, o in enumerate(outs)]
    try:
        deadline = time.monotonic() + MULTIHOST_DEADLINE_S
        while any(k.proc.poll() is None for k in kids):
            for k in kids:
                if k.proc.poll() not in (None, 0):
                    raise AssertionError(
                        f"{phase}: {k.label} exited rc "
                        f"{k.proc.returncode}: {k.tail()}")
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"{phase}: the processes did not end within "
                    f"{MULTIHOST_DEADLINE_S} s: "
                    + " | ".join(k.tail(10) for k in kids))
            time.sleep(0.1)
        for k in kids:
            if k.proc.returncode != 0:
                raise AssertionError(f"{phase}: {k.label} exited rc "
                                     f"{k.proc.returncode}: {k.tail()}")
    finally:
        for k in kids:
            k.stop()
    return outs


def multihost_7b_phase(torch) -> dict:
    """Phase 41 (module docstring).  Returns the children's launches."""
    from seldon_core_tpu_torch.runtime import programs

    _, mesh2, _ = _card_meshes(torch)
    prompts = [_serve_7b_prompts(torch)[i] for i in MULTIHOST_PICK]
    engine, cfg, init_s = _multihost_7b_engine(torch, mesh2)
    with programs.eager():
        single, single_logits = _multihost_serve(torch, engine, prompts,
                                                 mesh2, cfg)
    engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    outs = _run_multihost_children("multihost_7b", "--multihost-child",
                                   MULTIHOST_DIR)
    children_s = time.perf_counter() - t0
    res = [json.loads(o.read_text()) for o in outs]
    logits = [torch.load(o.with_suffix(".pt")) for o in outs]
    diffs = [float((lg - single_logits).abs().max()) for lg in logits]
    launches = {k: sum(r["launches"][k] for r in res)
                for k in single["launches"]}
    keep = ("ttft_ms_median", "tpot_ms_median", "tick_ms_median",
            "collective_ms_per_tick", "collective_share_of_tick",
            "exchanges_per_tick", "exchanges", "exchanged_bytes",
            "exchange_host_s", "ticks", "wall_s", "launches")
    line = {
        "phase": "multihost_7b",
        "model": "L32 d4096 H32/Hkv8 ff16384 V32000 bf16 int8-ffn flash",
        "engine": "PagedLLMEngine 96x16 pages, 8 slots, max_len 256",
        "mesh": "tp=2: 2 processes x 1 rank on cuda:0, gloo; against the "
                "single controller's tp=2 on [cuda:0, cuda:0], programs "
                "eager in both",
        "prompt_lens": [len(p) for p in prompts], "n_new": 16,
        "ids_equal_single_controller": [r["ids"] == single["ids"]
                                        for r in res],
        "ids_equal_between_processes": res[0]["ids"] == res[1]["ids"],
        "prefill_logits_bitwise_equal": [bool(torch.equal(
            lg, single_logits)) for lg in logits],
        "prefill_logits_max_abs_diff": diffs,
        "processes": [{k: r[k] for k in keep + ("rank", "weights_init_s",
                                                "free_pages", "graphs",
                                                "peak_device_bytes",
                                                "tp_span")} for r in res],
        "single_controller": {k: single[k] for k in keep},
        "tp_7b_tp2_graphs": {k: TP_7B.get(k) for k in
                             ("ttft_ms_median", "tpot_ms_median")},
        "weights_init_s": init_s, "children_s": children_s,
        "launches": launches, "card": CARD}
    emit(line)
    for r in res:
        if r["ids"] != single["ids"]:
            raise AssertionError(
                f"multihost_7b: process {r['rank']}'s ids differ from the "
                f"single controller's: {r['ids']} against {single['ids']}")
    if res[0]["ids"] != res[1]["ids"]:
        raise AssertionError("multihost_7b: the processes' ids differ")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"multihost_7b: {k} was not launched in the "
                                 "children")
    return launches


# ----------------------------------------------------------------------
# slice 6e: training across processes
# ----------------------------------------------------------------------

#: train_mesh (a)'s single-controller lines and losses, by plan label
TRAIN_MESH: dict = {}
MULTIHOST_TRAIN_DIR = ROOT / "build" / "multihost_train_moe"
#: multihost_train_dryrun's layouts: processes x ranks of cuda:0
TRAIN_LAYOUTS = ((2, 4), (4, 2))


def multihost_train_dryrun_phase(torch) -> dict:
    """Phase 42 (module docstring).  Returns the workers' launches."""
    from seldon_core_tpu_torch.runtime.multihost import (
        run_multihost_training,
    )

    out = {"phase": "multihost_train_dryrun", "card": CARD,
           "layouts_at_once": len(TRAIN_LAYOUTS), "layouts": []}
    launches = {k: 0 for k in _counters()}

    def layout(hosts, per):
        t0 = time.perf_counter()
        r = run_multihost_training(hosts, per, timeout=MULTIHOST_DEADLINE_S,
                                   device="cuda")
        return r, time.perf_counter() - t0

    # both layouts at once: each run spends most of its wall time in its
    # processes' start and first step
    with concurrent.futures.ThreadPoolExecutor(len(TRAIN_LAYOUTS)) as pool:
        runs = [pool.submit(layout, *lay) for lay in TRAIN_LAYOUTS]
        done = [f.result() for f in runs]
    for (hosts, per), (r, wall) in zip(TRAIN_LAYOUTS, done):
        rows = []
        for p in r["plans"]:
            single = TRAIN_MESH[p["plan"]]
            rows.append({**{k: p[k] for k in ("plan", "line", "loss",
                                             "step_s", "shared_leaves",
                                             "launches")},
                         "single_controller_line": single["line"],
                         "single_controller_loss": single["loss"],
                         "loss_diff": abs(p["loss"] - single["loss"])})
            print(f"dryrun_training OK ({hosts} processes x {per} ranks): "
                  f"{p['line']}", flush=True)
            for k, n in p["launches"].items():
                launches[k] = launches.get(k, 0) + n
        out["layouts"].append({"processes": hosts, "ranks_each": per,
                               "wall_s": wall, "plans": rows})
    emit(out)
    for lay in out["layouts"]:
        for row in lay["plans"]:
            if not (row["line"] == row["single_controller_line"]
                    and row["loss_diff"] <= 1e-6):
                raise AssertionError(f"multihost_train_dryrun: {row}")
    # K3: the dense plan's 4 layers x 2 microbatches x dp 2 x tp 2 a layout
    # (the ring plan launches none)
    want = 32 * len(TRAIN_LAYOUTS)
    if launches["flash_attention"] != want:
        raise AssertionError(f"multihost_train_dryrun: K3 launched "
                             f"{launches['flash_attention']}, not {want}")
    return launches


def _moe_train_steps(torch, mesh) -> tuple:
    """``train_moe``'s model (seed 61) and batches (seed 62) placed over
    ``mesh``: ``TRAIN_STEPS`` AdamW steps.  Returns ``(result, params)``:
    the losses, each step's host ms (the loss read waits for it), the
    moves between processes a step (``transport_stats``), the launches."""
    from seldon_core_tpu_torch.models.transformer import (
        init_params,
        make_train_step,
        shard_params,
    )
    from seldon_core_tpu_torch.parallel.mesh import (
        reset_transport_stats,
        transport_stats,
    )

    cfg = _train_cfg(torch)
    data = torch.Generator(device="cuda").manual_seed(62)
    batches = [_train_batch(torch, data, 8, 512, cfg.vocab_size)
               for _ in range(TRAIN_STEPS)]
    params = shard_params(init_params(
        torch.Generator(device="cuda").manual_seed(61), cfg), mesh, cfg)
    init_opt, step = make_train_step(cfg, mesh=mesh, learning_rate=1e-3)
    opt = init_opt(params)
    torch.cuda.synchronize()
    reset_launches()
    reset_transport_stats()
    losses, step_ms, moved = [], [], []
    for batch in batches:
        s0 = transport_stats()
        t = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t) * 1e3)
        s1 = transport_stats()
        moved.append({k: s1[k] - s0[k] for k in s1})
    return {"losses": losses, "step_ms": step_ms, "moved": moved,
            "launches": read_launches(),
            "peak_device_bytes": torch.cuda.max_memory_allocated()}, params


def multihost_train_child_main(argv: list) -> int:
    """``chip_smoke.py --multihost-train-child OUT``: one process of
    ``multihost_train_moe``: join the slice from the operator's env, hold
    one dp rank on cuda:0, run the steps, check the replicated leaves
    against the other process's, and write the result to OUT (JSON)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from seldon_core_tpu_torch.parallel.mesh import (
        MeshPlan,
        process_mesh,
        replicas_agree,
    )
    from seldon_core_tpu_torch.runtime.multihost import (
        maybe_initialize_distributed,
    )

    out = Path(argv[0])
    if not maybe_initialize_distributed():
        raise SystemExit("multihost train child: no multi-host env")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    mesh = process_mesh([torch.device("cuda", 0)], plan=MeshPlan(dp=2))
    res, params = _moe_train_steps(torch, mesh)
    res.update(rank=dist.get_rank(), replicas=replicas_agree(params, mesh))
    out.write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def multihost_train_moe_phase(torch) -> dict:
    """Phase 43 (module docstring).  Returns the children's launches."""
    from seldon_core_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    single = []
    for _ in range(2):  # twice: the single controller's own run-to-run gap
        mesh = make_mesh(MeshPlan(dp=2), devices=["cuda:0"] * 2)
        res, params = _moe_train_steps(torch, mesh)
        single.append(res)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = _run_multihost_children("multihost_train_moe",
                                   "--multihost-train-child",
                                   MULTIHOST_TRAIN_DIR)
    children_s = time.perf_counter() - t0
    res = [json.loads(o.read_text()) for o in outs]
    ref = single[0]["losses"]
    gap = [abs(a - b) for a, b in zip(ref, single[1]["losses"])]
    limit = [max(1e-3 * abs(r), 2 * g) for r, g in zip(ref, gap)]
    diffs = [[abs(a - b) for a, b in zip(r["losses"], ref)] for r in res]
    per_step = [statistics.median(r["step_ms"][1:]) for r in res]
    launches = {k: sum(r["launches"][k] for r in res)
                for k in res[0]["launches"]}
    share = []
    for r in res:
        dev = sum(m["device_ms"] for m in r["moved"][1:])
        share.append(dev / sum(r["step_ms"][1:]))
    line = {
        "phase": "multihost_train_moe", "card": CARD,
        "model": "vocab 32000, d_model 512, 8 layers x 8 heads of 64, d_ff "
                 "2048, 4 experts top-2 cf 2.0, flash, bf16 activations, "
                 "float32 params, AdamW lr 1e-3",
        "mesh": "dp=2: 2 processes x 1 rank on cuda:0, gloo; against the "
                "single controller's dp=2 on [cuda:0, cuda:0], twice",
        "batch": [8, 512], "steps": TRAIN_STEPS,
        "losses": [r["losses"] for r in res],
        "single_controller_losses": [s["losses"] for s in single],
        "single_controller_gap": gap, "limit": limit, "loss_diffs": diffs,
        "losses_bitwise_single_controller": [r["losses"] == ref
                                             for r in res],
        "replicas": [r["replicas"] for r in res],
        "step_ms_median": per_step,
        "single_controller_step_ms_median": [
            statistics.median(s["step_ms"][1:]) for s in single],
        "transfer_device_ms_share_of_step": share,
        "moved_per_step": res[0]["moved"][1],
        "peak_device_bytes": [r["peak_device_bytes"] for r in res],
        "children_s": children_s, "launches": launches}
    emit(line)
    for r, d in zip(res, diffs):
        if not all(x <= lim for x, lim in zip(d, limit)):
            raise AssertionError(f"multihost_train_moe: process {r['rank']} "
                                 f"losses {r['losses']} against {ref}")
        if not (r["replicas"]["equal"] and r["replicas"]["leaves"] > 0):
            raise AssertionError(f"multihost_train_moe: process {r['rank']}'s "
                                 f"replicated leaves differ: {r['replicas']}")
        if not (all(math.isfinite(x) for x in r["losses"])
                and r["losses"][-1] < r["losses"][0]):
            raise AssertionError(f"multihost_train_moe: losses {r['losses']}")
        # K3: one launch a layer a rank a forward (one rank a process)
        if r["launches"]["flash_attention"] != 8 * TRAIN_STEPS:
            raise AssertionError(f"multihost_train_moe: K3 launched "
                                 f"{r['launches']} in process {r['rank']}")
    return launches


# ----------------------------------------------------------------------
# slice 7: the native load generator and weight export
# ----------------------------------------------------------------------

NATIVE_BODY = {"data": {"names": ["a", "b"], "ndarray": [[1.0, 2.0]]}}
SAVE_MODEL_DIR = ROOT / "build" / "save_model"
SAVE_MODEL_INPUTS = 8


def _host_line(res: dict) -> dict:
    """A load run's figures with what they were measured on: the load
    generator and the server share the host's cores."""
    import os

    return {**res, "card": CARD, "cpu_count": os.cpu_count()}


def _load_ok(what: str, res: dict) -> None:
    if res["errors"] != 0 or res["requests"] == 0:
        raise AssertionError(f"{what}: {res}")


def _grpc_body() -> bytes:
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.proto.convert import message_to_proto

    return message_to_proto(SeldonMessage.from_dict(NATIVE_BODY)) \
        .SerializeToString()


def native_load_ceiling_phase() -> None:
    """``bench.py`` ``bench_wire_ceiling``'s two runs on the port: a static
    answer from ``NativeHttpServer`` (no Python on either side of a
    request), REST with 32 connections and h2c gRPC with 8 x 16 streams,
    1.5 s each; errors must be 0."""
    from seldon_core_tpu_torch.native import NativeHttpServer, run_native_load

    body = json.dumps(NATIVE_BODY).encode()
    out = {}
    for mode, status, answer, conns, streams in (
            ("rest", 200, body, 32, 1), ("grpc", 0, _grpc_body(), 8, 16)):
        srv = NativeHttpServer(submit=None, http2=mode == "grpc").start()
        try:
            srv.set_static_response(status, answer)
            out[mode] = run_native_load(
                mode, "127.0.0.1", srv.port, "/p" if mode == "rest" else "/x",
                answer, conns, streams, 1.5, 0.2)
        finally:
            srv.stop()
    emit(_host_line({"phase": "native_load_ceiling", **out}))
    for mode, res in out.items():
        _load_ok(f"native_load_ceiling {mode}", res)


def native_load_engine_phase() -> None:
    """``bench.py`` ``bench_rest_socket_native`` and
    ``bench_grpc_socket_native`` on the port: a SIMPLE_MODEL
    ``GraphEngine`` behind ``NativeRestServer`` (32 connections) and
    ``NativeGrpcServer`` (8 x 8 streams), ``run_native_load`` in an
    executor while the servers' loop runs here, 3 s each; errors must be
    0."""
    from seldon_core_tpu_torch.graph.engine import GraphEngine
    from seldon_core_tpu_torch.native import run_native_load
    from seldon_core_tpu_torch.serving.native_http import (
        NativeGrpcServer,
        NativeRestServer,
    )

    async def run(server, *load) -> dict:
        port = await server.start()
        try:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None, lambda: run_native_load(load[0], "127.0.0.1", port,
                                              *load[1:]))
        finally:
            await server.stop()

    spec = {"name": "m", "implementation": "SIMPLE_MODEL"}
    out = {"rest": asyncio.run(run(
        NativeRestServer(engine=GraphEngine(spec), bind="127.0.0.1"),
        "rest", "/api/v0.1/predictions", json.dumps(NATIVE_BODY).encode(),
        32, 1, 3.0, 0.3))}
    out["grpc"] = asyncio.run(run(
        NativeGrpcServer(deployment=GraphEngine(spec), bind="127.0.0.1"),
        "grpc", "/seldon.tpu.Seldon/Predict", _grpc_body(), 8, 8, 3.0, 0.3))
    emit(_host_line({"phase": "native_load_engine", **out}))
    for mode, res in out.items():
        _load_ok(f"native_load_engine {mode}", res)


#: Python POSTs sent inside ``native_load_llm``'s window, spread over it
NATIVE_LLM_IN_WINDOW = 3


def _posts_in_window(port: int, body: dict, n: int, t0: float,
                     warmup_s: float, seconds: float) -> list:
    """``n`` POSTs of ``body``, one after another, each sent at its own
    point of the load's measured window (``t0`` its ``time.monotonic()``
    start, ``warmup_s`` then ``seconds``): ``(code, answer, sent_s,
    answered_s)``, seconds from ``t0``."""
    out = []
    for i in range(n):
        at = t0 + warmup_s + (i + 0.5) * seconds / n
        time.sleep(max(0.0, at - time.monotonic()))
        sent = time.monotonic() - t0
        code, answer = _post(port, body)
        out.append((code, answer, sent, time.monotonic() - t0))
    return out


def native_load_llm_phase(torch) -> dict:
    """``llm.json`` (the main path: DemoLLM, int8 "full", 65 pages of 16,
    GQA 4/2) booted by the local runner, its routes behind the native REST
    tier, driven by ``run_native_load`` for 3 s with 4 connections and one
    greedy body; one Python POST of the same body before the run, one
    after, and ``NATIVE_LLM_IN_WINDOW`` inside the window, where the load's
    4 connections keep the engine's slots live.  Gates: errors 0; every
    answer's ids EQUAL the CPU plain path's for the same engine and knobs,
    and each in-window POST sent inside the window; K1 and K2 launched in
    the window.  Returns the window's launches."""
    import random

    from seldon_core_tpu_torch.native import run_native_load
    from seldon_core_tpu_torch.operator.local import serve
    from seldon_core_tpu_torch.runtime.llm import PagedLLMEngine
    from seldon_core_tpu_torch.serving.native_http import NativeRestServer

    rng = random.Random(21)
    prompt = [rng.randrange(1, 256) for _ in range(40)]
    body = {"jsonData": {"prompt_ids": prompt, "n_new": 8}}
    graph = ROOT / "seldon_core_tpu_torch" / "examples" / "llm.json"

    async def run():
        server, local = await serve(str(graph), port=0, host="127.0.0.1")
        native = NativeRestServer(rest=server, bind="127.0.0.1")
        port = await native.start()
        try:
            before = (await _in_threads(_post, [(port, body)]))[0]
            reset_launches()
            loop = asyncio.get_running_loop()
            t0 = time.monotonic()
            res, (during,) = await asyncio.gather(
                loop.run_in_executor(None, lambda: run_native_load(
                    "rest", "127.0.0.1", port, "/api/v0.1/predictions",
                    json.dumps(body).encode(), 4, 1, 3.0, 0.3)),
                _in_threads(_posts_in_window, [(
                    port, body, NATIVE_LLM_IN_WINDOW, t0, 0.3, 3.0)]))
            launches = read_launches()
            after = (await _in_threads(_post, [(port, body)]))[0]
            return before, after, during, res, launches, local
        finally:
            await native.stop()
            await server.stop()

    before, after, during, res, launches, local = asyncio.run(run())
    engine = local.engine.node_impl("llm").user.engine
    cpu = PagedLLMEngine(_to_device(engine.params, "cpu"), engine.cfg,
                         engine.paged_cfg, max_slots=engine.max_slots,
                         auto_prefix_tokens=engine._auto_budget)
    want = asyncio.run(cpu.generate(prompt, 8))[0].tolist()
    cpu.close()
    engine.close()
    answers = [before, *((c, b) for c, b, _, _ in during), after]
    ids = [b["jsonData"]["ids"] if code == 200 else (code, b)
           for code, b in answers]
    sent = [(round(a, 3), round(b, 3)) for _, _, a, b in during]
    emit(_host_line({"phase": "native_load_llm", **res,
                     "prompt_len": len(prompt), "n_new": 8,
                     "ids_equal": [i == want for i in ids],
                     "in_window_sent_answered_s": sent,
                     "launches_in_window": launches}))
    _load_ok("native_load_llm", res)
    if not all(i == want for i in ids):
        raise AssertionError(f"native_load_llm: ids {ids} (before, "
                             f"{NATIVE_LLM_IN_WINDOW} in the window, after), "
                             f"CPU plain path {want}")
    if not all(0.3 <= a < 3.3 for a, _ in sent):
        raise AssertionError(f"native_load_llm: in-window POSTs sent at "
                             f"{sent} s, outside the window 0.3-3.3 s")
    if launches["int8_matmul"] == 0 or launches["paged_attention"] == 0:
        raise AssertionError(f"native_load_llm: kernels not launched in "
                             f"the window {launches}")
    return launches


def save_model_phase(torch) -> None:
    """``MNISTMLP`` and ``ResNet50Model`` (BASELINE config 3: 224 x 224 x
    3, 1000 classes, bf16, seeded) exported by the port's ``save-model``
    CLI in child processes on the card, both at once; each export booted
    through ``model_uri`` in a fresh component on cuda.  Gates: the
    export's leaves bitwise equal to the same seeded instance built here
    (the child's weights), and on 8 seeded inputs the booted component's
    answers bitwise equal to that instance's."""
    import shutil

    import numpy as np

    from seldon_core_tpu_torch.convert import resnet_to_jax
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.mlp import MNISTMLP
    from seldon_core_tpu_torch.models.resnet import ResNet50Model
    from seldon_core_tpu_torch.runtime.checkpoint import load_checkpoint
    from seldon_core_tpu_torch.runtime.component import ComponentHandle

    shutil.rmtree(SAVE_MODEL_DIR, ignore_errors=True)
    models = {"mlp": (MNISTMLP, (SAVE_MODEL_INPUTS, 784)),
              "resnet": (ResNet50Model, (SAVE_MODEL_INPUTS, 224, 224, 3))}
    t0 = time.perf_counter()
    children = {
        name: Child([sys.executable, "-m", "seldon_core_tpu_torch.tools",
                     "save-model",
                     f"{cls.__module__}:{cls.__name__}",
                     str(SAVE_MODEL_DIR / name), "--param", "seed=11"],
                    label=f"save-model {name}")
        for name, (cls, _) in models.items()}
    export_s = {}
    try:
        for name, child in children.items():
            child.wait_for(str(SAVE_MODEL_DIR / name), timeout=300)
            if child.proc.wait(timeout=60) != 0:
                raise AssertionError(f"save-model {name}: rc "
                                     f"{child.proc.returncode}: "
                                     f"{child.tail()}")
            export_s[name] = time.perf_counter() - t0
    finally:
        for child in children.values():
            child.stop()
    out = {}
    rng = np.random.default_rng(11)
    for name, (cls, shape) in models.items():
        path = str(SAVE_MODEL_DIR / name)
        mine = cls(seed=11, device="cuda")
        tree, meta = load_checkpoint(path)
        want = resnet_to_jax(mine.module) if name == "resnet" else \
            [{k: v.cpu() for k, v in layer.items()} for layer in mine.params]
        same_leaves = _same_tree(tree, want)
        t = time.perf_counter()
        booted = cls(model_uri=path, device="cuda")
        boot_s = time.perf_counter() - t
        x = rng.uniform(0, 255 if name == "resnet" else 1, shape) \
            .astype(np.float32)
        a, b = [ComponentHandle(m, name=name).predict(
            SeldonMessage.from_ndarray(x)) for m in (mine, booted)]
        out[name] = {"leaves_equal": same_leaves, "family": meta["family"],
                     "bytes": sum(f.stat().st_size for f in
                                  (SAVE_MODEL_DIR / name).iterdir()),
                     "export_s": export_s[name], "boot_s": boot_s,
                     "answers_bitwise_equal": _same_answer(a, b),
                     "answer_shape": list(a.host_data().shape),
                     "top1": a.host_data().argmax(-1).tolist()}
        del mine, booted
    shutil.rmtree(SAVE_MODEL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "save_model", **out, "card": CARD})
    for name, r in out.items():
        if not (r["leaves_equal"] and r["answers_bitwise_equal"]
                and r["family"] == ("mlp" if name == "mlp" else "resnet")):
            raise AssertionError(f"save_model {name}: {r}")


def _same_tree(a, b) -> bool:
    """Two trees of tensors with the same structure, dtypes, shapes and
    bytes."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and \
            all(_same_tree(x, y) for x, y in zip(a, b))
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.view(-1).view(torch.uint8).equal(
                b.view(-1).view(torch.uint8)))


_SUMMARY_META = {
    "int8_matmul": ("seldon_core_tpu_torch/csrc/int8_matmul.cu",
                    "seldon_core_tpu/ops/quant.py:52"),
    "paged_attention": ("seldon_core_tpu_torch/csrc/paged_attention.cu",
                        "seldon_core_tpu/runtime/paged.py:166"),
    "flash_attention": ("seldon_core_tpu_torch/csrc/flash_attention.cu",
                        "seldon_core_tpu/ops/attention.py:46"),
}


def main() -> int:
    if sys.argv[1:2] == ["--component-child"]:
        return component_child_main(sys.argv[2:])
    if sys.argv[1:2] == ["--runner-child"]:
        return runner_child_main(sys.argv[2:])
    if sys.argv[1:2] == ["--multihost-child"]:
        return multihost_child_main(sys.argv[2:])
    if sys.argv[1:2] == ["--multihost-train-child"]:
        return multihost_train_child_main(sys.argv[2:])
    try:
        return smoke()
    finally:
        reap_children()


def smoke() -> int:
    global CARD
    if not (ROOT / "seldon_core_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(seldon_core_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # graph nodes name this script's factories as "chip_smoke:..." (the
    # observe_7b node reads OBSERVE_7B): the runner must find this module,
    # not a second copy of it
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    from seldon_core_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    CARD = smi.stdout.strip().splitlines()[0].strip()
    print(CARD, flush=True)
    emit({"phase": "gpu", "nvidia_smi": CARD,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build()
    stats = dict(_build.build_stats)
    _build.load()
    build_s = time.perf_counter() - t0
    log = _build.BUILD_DIR / "build_log.txt"  # nvcc and ptxas -v output
    log.write_text(stats.get("log", ""))
    emit({"phase": "build", "seconds": build_s,
          "compiled": stats.get("compiled"), "library": stats.get("library"),
          "log": str(log)})
    emit({"phase": "ptxas", "kernels": ptxas_report(stats.get("log", ""))})

    from seldon_core_tpu_torch.cuda_timer import ColdTimer

    seconds = {}

    def timed(label, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        seconds[label] = time.perf_counter() - t
        return res

    summary = timed("kernel", kernel_phase, torch, ColdTimer())
    # the main path's launches: every phase that drives an entry point
    runs = {"llm_json": timed("llm_json", llm_json_phase, torch)}
    runs["serve_7b"], params_7b = timed("serve_7b", serve_7b_phase, torch)
    runs["grpc_7b"] = timed("grpc_7b", grpc_7b_phase, torch, params_7b)
    runs["features_7b"] = timed("features_7b", features_7b_phase, torch,
                                params_7b)
    runs["spec_7b"] = timed("spec_7b", spec_7b_phase, torch, params_7b)
    # slice 4c-ii: the engines' programs as CUDA graphs against eager
    runs["llm_graphs_7b"] = timed("llm_graphs_7b", llm_graphs_7b_phase,
                                  torch, params_7b)
    # slice 5-i: the three planes around the same weights behind REST
    runs["observe_7b"] = timed("observe_7b", observe_7b_phase, torch,
                               params_7b)
    # slice 5b-i: the gateway in front of the same weights
    runs["gateway_7b"] = timed("gateway_7b", gateway_7b_phase, torch,
                               params_7b)
    # slice 5b-ii: the port's load harness against the same weights
    runs["loadtest_7b"] = timed("loadtest_7b", loadtest_7b_phase, torch,
                                params_7b)
    del params_7b
    torch.cuda.empty_cache()
    timed("parity_7b", parity_7b_phase, torch)
    timed("parity_features_7b", parity_features_7b_phase, torch)
    timed("parity_spec_7b", parity_spec_7b_phase, torch)
    # slice 6a: tensor-parallel serving, two tp ranks on the one card
    runs["parity_tp_7b"] = timed("parity_tp_7b", parity_tp_7b_phase, torch)
    runs["tp_7b"] = timed("tp_7b", tp_7b_phase, torch)
    # slice 6b: the placement plane, dp and tp ranks on the one card
    runs["placement_resnet50"] = timed("placement_resnet50",
                                       placement_resnet50_phase, torch)
    # slice 6c: training, one card and 8 ranks of it
    runs["train_moe"] = timed("train_moe", train_moe_phase, torch)
    runs["train_mesh"] = timed("train_mesh", train_mesh_phase, torch)
    # slice 6d: multi-host, two processes joined over gloo on the one card
    runs["multihost_dryrun"] = timed("multihost_dryrun",
                                     multihost_dryrun_phase, torch)
    runs["multihost_7b"] = timed("multihost_7b", multihost_7b_phase, torch)
    # slice 6e: training across processes joined over gloo on the one card
    runs["multihost_train_dryrun"] = timed(
        "multihost_train_dryrun", multihost_train_dryrun_phase, torch)
    runs["multihost_train_moe"] = timed("multihost_train_moe",
                                        multihost_train_moe_phase, torch)
    runs["checkpoint_7b"] = timed("checkpoint_7b", checkpoint_7b_phase,
                                  torch)
    resnet_k1 = timed("resnet50", resnet50_phase, torch)
    timed("graphs", graphs_phase, torch)
    # slice 4b/4c-i: fused plans as CUDA graphs, the prediction cache, two
    # predictors behind one runner
    runs["plan_resnet50"] = timed("plan_resnet50", plan_resnet50_phase,
                                  torch)
    timed("plan_graphs", plan_graphs_phase, torch)
    runs["cache_resnet50"] = timed("cache_resnet50", cache_resnet50_phase,
                                   torch)
    runs["canary"] = timed("canary", canary_phase, torch)
    # slice 4a-i: the wire tiers, components in child processes (their
    # launches come from the children's own counts)
    timed("wire_env", wire_env_phase)
    runs["wire_resnet50"] = timed("wire_resnet50", wire_resnet50_phase,
                                  torch)
    runs["wire_llm"] = timed("wire_llm", wire_llm_phase, torch)
    timed("wire_persistence", wire_persistence_phase)
    # slice 4a-ii and the QoS plane (gRPC in wire_resnet50, wire_llm and
    # grpc_7b too)
    runs["workers"] = timed("workers", workers_phase, torch)
    runs["qos_resnet50"] = timed("qos_resnet50", qos_resnet50_phase, torch)
    # slices 4d and 4e: the artifact plane and the device plane
    runs["artifacts_resnet50"] = timed("artifacts_resnet50",
                                       artifacts_resnet50_phase, torch)
    runs["device_plane_resnet50"] = timed(
        "device_plane_resnet50", device_plane_resnet50_phase, torch)
    runs["observe_resnet50"] = timed("observe_resnet50",
                                     observe_resnet50_phase, torch)
    # slice 5-ii: the lint against what the phases above ran
    runs["lint"] = timed("lint", lint_phase, torch)
    # slice 5b-i: the gateway and the fleet data plane
    runs["gateway_resnet50"] = timed("gateway_resnet50",
                                     gateway_resnet50_phase, torch)
    runs["fleet_resnet50"] = timed("fleet_resnet50", fleet_resnet50_phase,
                                   torch)
    # slice 5b-ii: the operator's loop around an engine booted from its
    # own compiled manifest, driven by the port's tools
    runs["operator_resnet50"] = timed("operator_resnet50",
                                      operator_resnet50_phase, torch)
    # slice 7: the native load generator, at its ceiling, over an engine
    # and over the main path; weight export through the CLI
    timed("native_load_ceiling", native_load_ceiling_phase)
    timed("native_load_engine", native_load_engine_phase)
    runs["native_load_llm"] = timed("native_load_llm",
                                    native_load_llm_phase, torch)
    timed("save_model", save_model_phase, torch)
    slice_3a = sum(seconds[k] for k in ("features_7b", "parity_features_7b",
                                        "checkpoint_7b"))
    slice_3b = seconds["spec_7b"] + seconds["parity_spec_7b"]
    slice_4a = sum(v for k, v in seconds.items() if k.startswith("wire_"))
    emit({"phase": "seconds", "build": build_s, **seconds,
          "slice_3a_phases": slice_3a, "slice_3b_phases": slice_3b,
          "slice_4a_i_phases": slice_4a,
          "slice_4a_ii_qos_phases": seconds["grpc_7b"] + seconds["workers"]
          + seconds["qos_resnet50"],
          "slice_4b_4c_i_phases": sum(seconds[k] for k in (
              "plan_resnet50", "plan_graphs", "cache_resnet50", "canary")),
          "slice_4c_ii_phases": seconds["llm_graphs_7b"],
          "slice_4d_4e_phases": seconds["artifacts_resnet50"]
          + seconds["device_plane_resnet50"],
          "slice_5_i_phases": seconds["observe_7b"]
          + seconds["observe_resnet50"],
          "slice_5_ii_phases": seconds["lint"],
          "slice_5b_i_phases": seconds["gateway_7b"]
          + seconds["gateway_resnet50"] + seconds["fleet_resnet50"],
          "slice_5b_ii_phases": seconds["loadtest_7b"]
          + seconds["operator_resnet50"],
          "slice_6a_phases": seconds["parity_tp_7b"] + seconds["tp_7b"],
          "slice_6b_phases": seconds["placement_resnet50"],
          "slice_6c_phases": seconds["train_moe"] + seconds["train_mesh"],
          "slice_6d_phases": seconds["multihost_dryrun"]
          + seconds["multihost_7b"],
          "slice_6e_phases": seconds["multihost_train_dryrun"]
          + seconds["multihost_train_moe"],
          "slice_7_phases": sum(seconds[k] for k in (
              "native_load_ceiling", "native_load_engine",
              "native_load_llm", "save_model")),
          "total": time.perf_counter() - t0})
    launches = {k: sum(r[k] for r in runs.values())
                for k in runs["serve_7b"]}

    entries = []
    for name, (src, replaces) in _SUMMARY_META.items():
        s = summary[name]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "launches_by_phase": {ph: r[name] for ph, r in runs.items()},
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "shape": s["shape"], "variant": s.get("variant"), "card": CARD,
            **{k: s[k] for k in ("long_ms", "long_bound_ms", "one_long_ms",
                                 "one_long_bound_ms", "shared_prefix_ms",
                                 "shared_prefix_bound_ms", "tp2_rank_cases",
                                 "dp2_rank_cases", "train_cases")
               if k in s},
            **({"resnet50_launches": resnet_k1} if name == "int8_matmul"
               else {})})
    emit({"kernels": entries})
    for e in entries:
        if not (e["launches"] > 0 and math.isfinite(e["ms"])):
            raise AssertionError(f"kernel {e['name']}: {e}")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
