#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py                      # as the chip check runs it
    python3 chip_smoke.py --profile <dir>      # plus profiled warm passes
    python3 chip_smoke.py --mesh-only [--mesh-cards 4]   # mesh, chaos_mesh
    python3 chip_smoke.py --vmoe-only                    # build, vmoe

Nine paths, each through the entry points a user calls:

- serving, the README's transfer-learning quickstart: an
  ``ImageFeaturizer`` with a ResNet-50 (random weights from a seed) scores
  a frame of 256x256x3 uint8 images, resized to 224x224 and normalized on
  the card by the hand-written kernel K2
  (``mmlspark_tpu_torch/kernels/csrc/crop_resize_normalize.cu``);
- training, the JAX package's headline train lane: Frame ->
  ``DeviceEpochCache`` -> ``DistributedTrainer`` steps of ResNet-20 CIFAR
  (bf16 compute, batch 256, sgd 0.1 with momentum 0.9), with the uint8
  batch normalized inside the loss by the hand-written kernel K1
  (``mmlspark_tpu_torch/kernels/csrc/fused_normalize.cu``); then
  ``DeepClassifier`` fits an MLP on a tabular frame and
  ``ComputeModelStatistics`` scores it on its device path;
- attention models: ``TorchModel`` scores token ids through
  ``transformer_lm`` at the zoo's width (vocab 32000, dim 512, depth 6,
  8 heads, L 2048; bf16, random weights from a seed) for its ``hidden``
  layer, every block's causal attention running the hand-written kernel K3
  on the tensor cores (``mmlspark_tpu_torch/kernels/csrc/
  flash_attention_wgmma.cu``; f32 takes the CUDA-core
  ``flash_attention.cu``); then the MoE LM the same way, and
  ``ImageFeaturizer`` with ViT-B/16 (K2, no K3);
- tabular AutoML, the README's first quickstart: ``TrainClassifier`` fits
  each of the six learner families on an Adult-census-shaped frame at UCI
  Adult's size, ``FindBestModel`` picks one and ``ComputeModelStatistics``
  scores it; ``TrainRegressor`` fits ``LinearRegression``. The JAX package
  computes these learners with XLA ops, not Pallas, so this path runs no
  hand-written kernel;
- text and token training, the training half of the JAX bench's judged
  lanes on one card: ``DistributedTrainer`` trains ``textcnn`` on
  tokenized and hashed reviews (no kernel) and ``Word2Vec`` fits on them;
  ``transformer_lm`` and the MoE LM train on next-token cross-entropy with
  K3's forward in every block; ViT-B/16 trains at 224x224 with K1 in the
  loss; ``DeepClassifier`` fits with the ``lamb`` and ``adafactor``
  optimizers;
- serve and generate: a ``Server`` scores single-image requests through
  the featurize path's ResNet-50 scoring model and token rows through
  ``transformer_lm``, one CUDA graph per batch bucket replaying K2 and K3;
  its generate lane decodes continuously batched sequences over a paged KV
  arena, one CUDA graph per (program, bucket), K3 in every prefill at
  prompt buckets of 512 and more; the same lane with speculative decoding
  (a draft model's prefill and decode graphs, the target's verify graph)
  and with int8 KV blocks; a ``Fleet`` of in-process replicas behind
  the ``Router`` (prefix affinity fed by the ``FleetScraper``, a kill, a
  ``scale_up`` and a ``rollout`` under traffic); and the process fleet:
  ``python -m mmlspark_tpu_torch.cli serve`` worker processes sharing the
  card under a ``Supervisor``, behind the ``Router``, scaled by the
  ``Autopilot`` through ``ProcessFleet``, K3 in every worker's prefill;
- streamed input and crash-safe resume: a PNG corpus on disk streams
  through the ``data`` pipeline into ``ResilientTrainLoop.run_dataset``
  (ResNet-20, K1 in every step) with ``TrainCheckpointer`` saves; a
  SIGKILLed child's run is finished by a fresh process, bit-equal to an
  uninterrupted one, and ``DeepClassifier(checkpointDir=...)`` resumes a
  fit over a ``DiskFrame`` the same way;
- meshed training: ``python -m mmlspark_tpu_torch.cli run chip_smoke.py
  --nprocs 2`` starts two ranks (``--mesh-child``) sharing the card over
  gloo; each builds ``DeviceMesh``es, places ``transformer_lm``'s shards
  by the sharding rules and trains it split over ``tensor`` (K3 on each
  rank's heads) and over ``seq`` (Ulysses' all-to-all, then K3), and
  ResNet-20 data parallel (K1 on each rank's half of the batch); then the
  MoE LM split over ``expert`` (K3 on every rank), a pipelined MLP over
  ``pipe`` (with a ``reshard_to`` onto the pipe and back) and the DLRM
  with its tables split by rows over ``tensor`` (the fused lookup, the
  sparse gradient);
- tools: ``TorchModel`` capturing an inner node of the featurize path's
  ResNet-50 (K2), the model downloader over a localhost repository, the
  pretrained-weight import (a trained flax checkpoint and a torch state
  dict into a repository, scored by ``ImageFeaturizer`` with K2), four
  chaos scenarios, the four mesh-bound chaos scenarios on two ranks
  through ``python -m mmlspark_tpu_torch.cli chaos --nprocs 2``, and the
  CLI's ``info``, ``check`` and ``top``.

The script:

1. ``device``: names the card (``nvidia-smi`` name and power limit);
2. ``build``: builds every kernel from the sources in the checkout (nvcc,
   one process per source, all at once), times it, prints ptxas's
   registers and spill bytes for every compiled function, and fails if an
   instantiation of any kernel spills;
3. ``kernel_check``: holds each kernel against its plain PyTorch version on
   the same card tensors at the shapes its path gives it (K3 also at the
   JAX bench's ``longctx`` shape and at head dims 16, 128, 256 and 512, each
   variant through the route its dtype and head dim pick, with both K3
   kernels' launches counted across the kernel call and the plain call),
   and times the
   kernel, the plain version, one PyTorch library call as a yardstick
   where one computes the same function (each as device time, replayed
   from a CUDA graph; the kernel also as back-to-back eager calls), and
   the least time the card could take (its bound); K1 and K2 also beside
   their launch floor (an empty kernel on the same grid, from their
   libraries' ``*_empty`` entry points), K1 over the 16 distinct batch
   slices of a resident epoch, and K2 in bf16 (the featurize path's
   output) and f32, through each of its variants (staged, direct-load),
   with ptxas's registers and spills of each kernel's functions;
4. ``featurize``: zeroes the launch counts, runs the featurizer, reads the
   counts (K2's staged variant once per batch, storing bf16; K1 never),
   and checks the features against
   the same backbone fed by the plain preprocess; then a logits pass and a
   float32 pass with TF32 off;
5. ``train``: zeroes the counts, runs 3 warm-up steps, one untimed window
   of 40 steps under CUDA's sync-debug mode (it must sync the host only at
   the metrics-ring reads and the final loss fetch), 3 timed windows of 40
   steps with the debug mode off (each making just those counted syncs;
   the median window sets train images/s), and one eval step, reads the
   counts (K1 once per step, K2 never), then holds the loss of 60 bf16
   steps and of 20 fp32 steps (TF32 off) against the same trainer fed by
   K1's plain version;
6. ``deep``: fits ``DeepClassifier`` on 65,536 rows of 128 features,
   scores them, and checks that ``ComputeModelStatistics``'s device path
   gives the host path's metrics with one counted sync; then fits it with
   ``optimizer="lamb"`` and ``"adafactor"`` (8,192 rows, one epoch, fp32,
   TF32 off) on the card and on the CPU from the same init and batch
   order, each parameter array within ``DEEP_OPT_TOL`` (norm-wise) of the
   CPU fit's;
7. ``lm_score``: zeroes the counts, scores 64 rows of 2048 ids (batch 8),
   reads the counts (K3's tensor-core kernel 6 layers x 8 batches = 48
   times, no other kernel), times 3 warm passes (tokens/s, each pass 48
   launches), and
   holds ``hidden`` against the same module and weights with the
   reference attention (``use_flash="never"``) in bf16 and in fp32 (TF32
   off; the fp32 pass launches K3's CUDA-core kernel instead, and one warm
   fp32 pass is timed); one logits pass checks the default output;
8. ``moe_score``: ``transformer_lm_moe`` over 16 rows (K3's tensor-core
   kernel 6 times a batch), against its reference-attention route;
9. ``featurize_vit``: ViT-B/16 features of 128 uint8 images 256x256x3
   through ``ImageFeaturizer`` (resized to 224 by K2) and through
   ``TorchModel`` center-cropping to 224 on the card (K2), each against
   the plain-preprocess route;
10. ``automl``: 32,561 training and 16,281 test rows of UCI Adult's
    columns (six numeric, eight strings at UCI's cardinalities, ``income``
    24% positive), synthesized from a seed. For each learner
    (LogisticRegression(regParam=0.01) and the golden harness's
    DecisionTree, RandomForest, GBT, NaiveBayes and MLP) two card fits and
    a CPU fit through ``TrainClassifier``, each scored on the test rows:
    (a) card AUC and accuracy within 5e-3 of the CPU fit's; (b) with TF32
    off, LogisticRegression's and NaiveBayes's parameters within 1e-4
    (norm-wise) of the CPU fit's; (c) the two card fits of a tree learner
    split alike; (e) every fit ran on the card (the epoch cache's and the
    bins' device). Then (d) ``FindBestModel`` by AUC picks the same learner
    on the card and the CPU (or two whose CPU AUCs lie within 5e-3), and
    ``TrainRegressor(LinearRegression())`` on a flight-delay frame of the
    same size matches the CPU fit in its numeric weights and its
    predictions within 1e-4 (its one-hot blocks and intercept are
    collinear, so their own weights are not identified; the Gram matrix's
    condition number is printed); (f) K1, K2 and K3 launch 0 times. Fit
    and scoring seconds, the host featurize share, syncs per fit and the
    metrics go on the phase's line;
11. ``text``: the JAX bench's text lane uncut. 10,240 reviews of 40-120
    tokens (seed 3) are tokenized and hashed into 128 ids over 32,768
    slots, uploaded once into a ``DeviceEpochCache``, and ``textcnn``
    (bf16, adam(1e-3), batch 256) trains 6 epochs; the timed region holds
    all of it and ends in one fetch (rows/s, step ms; median of 2 runs).
    Gates: (a) 20 fp32 steps on the card, TF32 off, within
    ``TEXT_F32_TOL`` (relative, per step) of a CPU run from the same
    params and batch order; (b) K1, K2 and K3 launch 0 times; (c) an epoch
    under CUDA's sync-debug mode syncs the host only at the ring reads and
    the final fetch. Then ``Word2Vec`` at its defaults fits the reviews
    (tokenized by the port's ``RegexTokenizer``; pairs/s, fit s) and the
    synonym corpus of ``tests/test_text.py``: w_in, the pair arrays and
    the table cross to the card once a fit, one counted sync a fit (and
    none other under the sync-debug mode), finite vectors, and the
    synonym cluster holds;
12. ``lm_train``: ``transformer_lm`` at the zoo's width (bf16, random
    weights from seed 0, 64 resident rows of 2048 ids, batch 8,
    adamw(1e-3), next-token cross-entropy): 3 warm-up steps, one window of
    8 steps under the sync-debug mode, 2 timed windows of 8 (tokens/s, step
    ms, TFLOP/s, MFU), the counts read after them (K3's tensor-core kernel
    6 a step, no other kernel), and K3's plain backward timed at the
    step's shape (its share of the step). Gates: (a) 10 steps at batch 2
    within ``LM_BF16_TRAIN_TOL`` of the same trainer with the reference
    attention (``use_flash="never"``); (b) depth 2, 2 rows, fp32 with TF32
    off: K3's CUDA-core kernel 2 a step, 5 steps within
    ``LM_F32_TRAIN_TOL`` of the reference route; (c) ``transformer_lm_moe``
    at its zoo defaults, 16 rows at batch 8, loss CE + 0.01 * moe_aux: 5
    steps finite, moe_aux > 0, the last loss below the first, K3 6 a step;
13. ``train_large``: the JAX bench's train_large lane uncut. ViT-B/16 at
    224x224 (1000 classes, bf16) trains on 256 resident uint8 images
    (seed 7) at batch 128 with sgd(0.01, momentum 0.9) and K1 in the loss:
    2 warm-up steps, 3 timed windows of 8 (images/s, step ms, TFLOP/s,
    MFU), K1 once a step and no other kernel; 10 steps' losses within
    ``TL_PARITY_TOL`` of the same trainer fed by K1's plain version (bit
    equality reported);
13b. ``vmoe``: V-MoE-B/16 (``vmoe_b16``, bf16, 1000 classes, seeded
    router noise) at vmoe_b16.train's batch of 128 uint8 224x224 images,
    K1 and the aux loss in the loss: one step with the counts zeroed just
    before it under CUDA's sync-debug mode (K1 once; in each of the 6
    routed blocks 6 ``moe_grouped_gemm``, a ``moe_permute``, 2
    ``moe_unpermute``, a ``moe_unpermute_bwd`` and 2 ``moe_bias_grad``;
    no sync outside ``observability/syncs.py``), ``VM_STEPS`` timed steps,
    then each MoE wrapper against its plain version at the cell's shapes
    (S = 25,216, C = 1,655) within ``VM_TOL``, forward and backward, and
    the kernels' device ms beside their bound, the plain version's and
    cuBLAS's. ``--vmoe-only`` runs the build and this phase alone;
14. ``serve``: a ``Server`` (max_batch 64, buckets 1, 8, 32, 64) over the
    TorchModel ``ImageFeaturizer`` builds for ResNet-50 (``pool``, bf16,
    ``devicePreprocess`` 256^2x3 uint8 -> 224^2; seed 0). Every bucket's
    CUDA graph is captured first (capture ms each: the cold start), then the
    counts are zeroed and 16 client threads send 512 single-image requests,
    each waiting for its answer (images/s, p50/p99 request ms). Gates: (a)
    no capture after warm-up; (b) each graph's capture records K2's staged
    variant once, and K2's launches equal the sum over replays of the
    graphs' recorded launches, K1 and K3 0; one replay of each graph
    under torch.profiler runs on the device exactly the kernels its
    capture recorded; (c) full 64-row batches EQUAL
    ``TorchModel.transform`` at ``miniBatchSize=64`` bit for bit; the
    rows served at the smaller buckets are held within 2% of the
    features' scale (the featurize phase's bf16 gate). A batch's copy-in,
    replay and fetch are timed apart;
15. ``lm_serve``: ``transformer_lm`` (bf16, ``hidden``) behind buckets 1,
    4, 8, 128 requests of 2048 ids from 8 client threads (tokens/s,
    p50/p99). Gates: no capture after warm-up; each graph's capture
    records K3's tensor-core kernel 6 times, its launches equal 6 x
    replays, and one profiled replay of each graph runs just those 6 on
    the device; a full 8-row batch EQUALS ``transform`` at
    ``miniBatchSize=8`` bit for bit, and every served row is within the
    lm_score phase's bf16 limits (max 0.1, mean 0.01) of it;
16. ``generate``: the lane of ``transformer_lm`` (bf16) at
    ``generate.max_seq_len`` 2048, 8 sequences, KV blocks of 16 tokens
    (an arena of 201 MB). Every prefill, decode, chunk and copy-on-write
    graph the traffic uses is captured first; then 128 prompts of
    600-1900 ids (``default_rng(0)``), 32 new tokens each, from 8 client
    threads (generated tokens/s over the round, decode tokens/s over the
    round's decode steps' time, TTFT p50/p99, inter-token ms). Gates: (a)
    no capture after warm-up (``steady_compiles`` 0); (b) K3's
    tensor-core kernel 6 times a prefill replay (every bucket is 512 or
    more), no kernel in the decode, chunk and copy-on-write graphs, and
    no other launch, each graph's recorded launches confirmed by one
    profiled replay on the device (as in the fp32 gate); (c) a
    shared-prefix round (8 prompts on one 1024-id head, the head alone
    among them) has prefix hits and a copy-on-write, and its tokens'
    agreement with the same round with ``generate.prefix_cache=False`` is
    printed; (d) the fp32 gate, TF32 off, ``transformer_lm`` at the zoo's
    width cut to depth 2: 4 prompts of 600-1000 ids give greedy tokens
    EQUAL to the port's full-recompute loop (K3's CUDA-core kernel twice a
    prefill replay), and the shared-prefix round gives tokens EQUAL to the
    cache-off round. The bf16 lane's agreement with its own full
    recompute (the first 16 prompts) is printed without a gate: K3's
    tensor-core route and the decode's plain attention round p to bf16 at
    different places, which can move a near-tied argmax. Then three rounds
    of 32 of the prompts, each its own main path (counts zeroed just
    before, read just after; no capture after warm-up; launches = the
    graphs' recorded launches x replays): (e) ``spec`` with a same-weights
    draft and (f) with a depth-2 draft sharing the target's embeddings,
    first two blocks and head (``spec_tokens`` 3: accept rate, decode
    tokens/s and step ms, K3 launches by the draft's prefill), (g)
    ``int8`` KV blocks at the plain arena's ``arena_mb`` (blocks >= 1.8x
    the bf16 arena's; tokens' agreement with the plain round printed). The
    fp32 gate adds: greedy tokens of a speculative lane EQUAL the plain
    lane's with a same-weights and a divergent draft, one seeded sampling
    request (temperature 0.8, top_k 4, seed 1234) gives the same tokens
    with and without speculation, and after a prefill every dequantized
    element of an int8 arena lies within scale/2 of the fp32 arena's;
17. ``fleet``: ``Fleet(replicas=2)`` of the generate model, every
    replica's graphs captured first, a ``FleetScraper`` polling every
    0.25 s; the counts zeroed, then 64 prompts (half on one 1024-id head)
    from 8 closed-loop clients, r0 killed after 16 answers, one
    ``scale_up`` after 24 and one ``rollout`` to a second version (seed
    1) after 32. Gates: every request completes or fails retryably,
    failovers >= 1, no capture outside warm-up, ``scale_up`` and
    ``rollout``, no failure while the rollout runs, K3 launched exactly
    the replayed plus warm-up launches of every replica's graphs. The
    fp32 gate (depth 2): the fleet's greedy tokens EQUAL one ``Server``'s,
    and a restart off a killed prefix leader is token-identical. Tokens/s
    and TTFT p50/p99 beside one lane's on the same 64 prompts, the share
    of requests routed by affinity, scrape ms and capture ms per replica
    are printed;
18. ``process_fleet``: ``ProcessSpawner`` -> ``Supervisor`` -> ``Router``
    -> ``ProcessFleet``, as ``cli fleet`` builds them: two worker
    processes (``w0``, ``w1``) on the one card, each serving the fleet
    phase's ``lm`` (bf16) and ``lm32`` (fp32, depth 2); one warm round a
    worker and model (its captures and ms reported); the fleet phase's 64
    prompts from 8 closed-loop clients through the ``Router`` (a client
    retries a retryable failure); ``Supervisor.kill_replica("w1")`` (a
    SIGKILL) after 24 answers; an ``Autopilot(ProcessFleet)`` ticked on an
    injected clock with ``min_replicas`` 3 repairs through
    ``Supervisor.add_slot`` (``w2``); after the traffic ``min_replicas`` 2
    and the clock past the scale cooldown retire ``w2`` through
    ``retire_slot`` (SIGTERM drain); then ``shutdown``. Gates: (a) all 64
    requests answered; (b) the ``lm32`` greedy tokens of 4 prompts of
    600-1000 ids (K3's CUDA-core route) through ``w0``, ``w1`` before and
    after its restart, and ``w2`` EQUAL an in-process ``Server``'s (TF32
    off; every worker reports TF32 off for matmuls); (c) ``w1`` restarted
    under a new pid and the same name, back at weight 1; (d) the
    ``scale_up`` and ``scale_down`` decisions actuated, no ``error``; (e)
    ``w2`` exits 0; (f) ``kernels/_build`` lists the same files before and
    after (no worker ran nvcc); (g) every spawned worker reaped (each runs
    in its own process group, killed in a ``finally``); (h) each drained
    worker's K3 launches, read from the ``device`` field of the
    ``serving.summary`` event it writes at its drain, EQUAL its own
    programs' recorded launches times their replays plus one eager run a
    graph captured (6 tensor-core launches a ``lm`` prefill at a bucket of
    512 or more, 2 CUDA-core ones a ``lm32`` prefill, none elsewhere); the
    SIGKILLed incarnation wrote none. Tokens/s and TTFT p50/p99 beside the
    in-process fleet's, spawn-to-ready ms a worker, the restart's, the
    retire's drain s, failovers and each worker's allocator bytes are
    printed;
19. ``stream_resume``: crash-safe training over a streamed image corpus.
    The train cell's 4,096 images (``default_rng(0)``) are written as
    32x32x3 PNG files, each label in its file name, and streamed through
    ``FileSource -> shuffle(window 1024, seed 0) -> decode(4 workers; the
    native libpng/libjpeg codec, built by g++ at first use, else the
    Python decoder) -> map(uint8 flat + label) -> batch(256, drop) ->
    repeat()`` into ``ResilientTrainLoop.run_dataset``: ResNet-20 (bf16,
    sgd(0.1, momentum 0.9), K1 in the loss) for 32 steps (16 an epoch),
    a ``TrainCheckpointer`` save (module, optimizer, count, step,
    generators, and the pipeline's snapshot beside it) every 5 steps.
    Three fresh children (this script with ``--stream-child``) run in
    deterministic mode (``use_deterministic_algorithms``, deterministic
    cuDNN, ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before CUDA starts): A
    runs all 32 steps; B, started beside A, is SIGKILLed once it reports
    step 23 (a save may be in flight); C, started beside both, waits with
    its imports and CUDA context up until B is dead and A done, then
    restores B's directory and finishes (its spawn-to-first-step leaves
    the wait out). The same children fit the deep cell's ``DeepClassifier``
    (65,536 x 128, staged by ``CheckpointData(diskIncluded=True)`` into a
    DiskFrame and streamed from it, a checkpoint every 100 steps): A
    uninterrupted, B stopped by an ``InjectedFault`` at its 333rd step, C
    refitting over B's directory. Gates: (a) C's final module, optimizer
    state, count and step EQUAL A's; (b) C resumed from B's newest
    committed step (>= 20), with that step's mid-epoch data snapshot; (c)
    every step B's directory lists loads (or C quarantined it with a
    ``restore.fallback`` event), and no ``.tmp-`` write is left after C;
    (d) each child's K1 launches equal its steps (restoring launches
    none), no other kernel; (e) the deep refit resumed mid-epoch and its
    params EQUAL the uninterrupted fit's. Timed here, in the normal mode,
    2 runs each: ``run_dataset`` rows/s over an epoch (16 steps) with
    ``save_every`` 0 and 5, the
    JAX bench's ``streaming_input`` host lane (2,048 64x64 BMPs, batch 64,
    4 workers; rows/s and ``vs_baseline`` against ``read_images``), save
    (host snapshot ms, write ms) and restore ms with MB for ResNet-20's
    state and for ``transformer_lm``'s adamw state; C's spawn-to-first-
    step ms split into imports, CUDA context, restore and pipeline seek;
    whether the native codec built (and its build error if not);
20. ``mesh``: first the one-rank runs the meshed ones are held against
    (the same seed-0 params and batches, the trainer without a mesh),
    then two ranks sharing the card over gloo (NCCL refuses two ranks on
    one device), started by ``cli run --nprocs 2 --platform cuda``, each
    on ``cuda:0``: ``transformer_lm`` at the zoo's width (bf16, global
    batch 8 of 2048 ids from a resident epoch split over the data axes,
    adam(1e-3), ``next_token_loss``) at ``tensor=2`` and at ``seq=2``
    with Ulysses, 3 warm-up and 4 timed steps each (step ms, tokens/s a
    rank, counted syncs in the window: 0, host copies); the fp32 gate at
    depth 2 (global batch 4, 5 steps, TF32 off) at ``tensor=2``,
    ``seq=2`` Ulysses and ``seq=2`` ring; a checkpoint saved at
    ``tensor=2``, restored at ``data=2`` and back (``TrainCheckpointer``
    gathers to rank 0), 2 steps on each; ResNet-20 bf16 data parallel
    (the train cell's 4,096 images, global batch 256, sgd(0.1, momentum
    0.9), one epoch of 16 steps, K1 on each rank's 128 rows) and its fp32
    twin (TF32 off). Gates: (a) bf16 LM losses within
    ``LM_BF16_TRAIN_TOL`` of the one-rank run, fp32 within
    ``MESH_F32_TOL``; (b) every rank's ``flash_attention_tc`` 6 a step
    (7 steps), ``flash_attention`` 2 a step under tensor and Ulysses and
    none under the ring, K1 once a ResNet step, no other kernel; (c) every
    restore equal to the save bit for bit, on the new mesh's shards; (d)
    both ranks' ResNet parameters bit-equal after the epoch (bf16 and
    fp32); against one rank the first step's loss (bf16 within
    ``LM_BF16_TRAIN_TOL``, fp32 within ``MESH_F32_TOL``) and the fp32
    first update (norm-wise within ``MESH_UPDATE_TOL`` of the update):
    the run is chaotic beyond it, every step's loss difference printed. Printed: the ranks' devices,
    spawn-to-mesh ms, allocator bytes, images/s a rank, all labelled as
    two ranks sharing one card (not a scaling figure). ``--mesh-only
    --mesh-cards 4`` runs just this phase on four cards, one rank a card
    over NCCL, at ``data=2 x tensor=2``, ``data=2 x seq=2`` and
    ResNet-20 at ``data=4`` (it raises with fewer cards). Then, in the
    same ranks, with one-rank references run first here:
    ``mesh.moe``: ``transformer_lm_moe`` at the zoo's width (vocab 32000,
    dim 512, depth 6, 8 heads, 8 experts, top 2, capacity 1.25, L 2048,
    bf16, global batch 8, adam(1e-3), next-token CE + 0.01 x moe_aux) at
    ``expert=2`` (four cards: ``data=2 x expert=2``), 2 warm-up and 2
    timed steps, and its fp32 twin at depth 2 (batch 4, 3 steps, TF32
    off); gates: bf16 losses within ``MESH_MOE_BF16_TOL`` of one rank's,
    fp32 within ``MESH_F32_TOL`` with the first step's gate indices and
    slot positions of every MoE block EQUAL to one rank's rows of them,
    ``flash_attention_tc`` 6 a step (fp32: ``flash_attention`` 2) on
    every rank, each rank holding E/|expert| experts of every bank.
    ``mesh.pipe``: the JAX bench's ``fleet_reshard`` train half (a
    residual MLP, d 1024, hidden 2048, batch 16, adam(1e-4), 2
    microbatches, fp32, TF32 off) with 2 stages and with 4 (two a rank) at
    ``pipe=2`` (four cards: ``tensor=2 x pipe=2``), 6 steps, and a
    ``ResilientTrainLoop`` of 6 steps from ``data=2`` resharded onto
    ``pipe=2`` at step 3 and back at step 5 (four cards: data 4 and data
    2 x pipe 2); gates: losses within ``MESH_F32_TOL`` of the sequential
    one-rank run, every restore equal to its save, the stage hops' host
    copies counted on gloo (none on NCCL). ``mesh.dlrm``: the JAX bench's
    ``config_recommender`` train half (dense 16, 4 slots, embed 16, two
    tables of 524,288 rows, towers (64,), batch 2048, sgd(0.05), rows from
    ``testing/loadgen.recommender_rows(seed=31)``, 4 steps) at
    ``tensor=2`` (four cards: ``data=2 x tensor=2``); gates: the fused
    lookup of the first batch BIT-equal to ``bag_lookup_reference`` on
    the whole table here, losses within ``MESH_DLRM_TOL`` of the one-rank
    unsharded run, a rank's table bytes half the logical bytes, and the
    collectives' own counters: the steps' all-reduces carry the dense
    gradients and the loss only, never a table's gradient. The bf16 MoE
    runs once more with TF32 off, meshed and one-rank, every step's gate
    indices and slot positions recorded: its losses within
    ``LM_BF16_TRAIN_TOL`` of one rank's, the first step's first MoE
    block routing EQUAL to one rank's (its input is the same computation
    on both), and every step's and block's differing entries counted.
    ``mesh_serve`` (serving on the mesh, ``parallel/leader.py``): rank 0
    leads, the other ranks follow; one-rank
    references run on rank 0 first. ``transformer_lm`` (bf16, ``hidden``)
    behind a ``Server`` at ``tensor=2`` (four cards: ``data=2 x
    tensor=2``) under lm_serve's traffic cut to 64 rows (of 2048 ids, 8
    clients, buckets 1/4/8), rows within ``LM_BF16_MAX``/``LM_BF16_MEAN`` of
    the one-rank server's, ``flash_attention_tc`` 6 a program call on every
    rank; the fp32 depth-2 LM (TF32 off): logits of 2 x 512 ids within
    ``MESH_SERVE_F32_TOL`` of one rank's and greedy tokens of 2 prompts
    equal to one rank's lane; the generate lane at the zoo's width
    (``GEN_CONFIG``, ``MESH_SERVE_GEN_REQUESTS`` prompts of 600-1900 ids,
    32 new tokens, 8 clients) with the arena head-sharded
    (``arena_shard_bytes`` = ``arena_bytes`` / 2), ``flash_attention_tc``
    6 a prefill on every rank; the ``mesh.dlrm`` recommender served at
    ``tensor=2`` (four cards: ``data=2 x tensor=2``), its scores
    BIT-equal to the one-rank server's and a rank's table bytes half the
    logical; ``Fleet.reshard`` of two in-process replicas of it, one
    device -> the mesh -> one device under closed-loop fire, every answer
    bit-equal, no failed request, both replicas ``resharded`` each time;
    ResNet-50 ``ImageFeaturizer`` at ``data=2`` (four cards: 4) on 128
    uint8 images 256^2 -> 224^2, K2 once on every rank, features within
    the featurize phase's 2% of one rank's. Printed per configuration:
    rows/s or tokens/s beside one rank's, p50/p99, allocator bytes and
    host copies a rank, each rank's launches.
    ``mesh_inputs`` (multi-process training inputs): (a) in the same
    ranks, at ``data=2`` (four cards: ``data=2 x tensor=2``, the tensor
    peers holding the same rows), the deep cell's ``DeepClassifier``
    (65,536 x 128, batch 256, 2 epochs, fp32 with TF32 off, deviceCache
    'on') on each rank's ``process_shard(block_rows=128)``, against the
    one-rank fit over the whole frame (run here first): the sha256 of
    every cached batch of both epochs equal to its block of the one-rank
    cache's, the first ``MI_GATED_STEPS`` steps' losses within
    ``MESH_F32_TOL``, and the whole fit within the reference's own
    cross-topology bounds (final loss ``MI_XTOPO_RTOL``, predictions equal
    on ``MI_XTOPO_AGREE`` of the rows), every step's difference printed; (c) the resident-epoch
    verdict cached on every rank, and on none with rank 1's
    ``runtime.device_cache_mb`` under its epoch; (b) three launches of
    ``cli run --nprocs 2 chip_smoke.py -- --inputs-child SPEC``
    (deterministic mode): stream_resume's corpus and lane through a
    meshed ``ResilientTrainLoop.run_dataset``, each rank streaming its
    half of the files (``FileSource(process_shard=True)``) at 128 rows a
    step: A whole, B (beside A) with both ranks SIGKILLed once rank 0
    reports step ``MI_KILL_AT``, C (started beside both, waiting with
    its imports, CUDA context and K1 up until B is dead) resumed from
    B's directory and each rank's ``data_state-<step>.p<rank>.json``
    (its spawn-to-first-step leaves the wait out); gates: C's final state on
    each rank BIT-equal to A's, A's ranks bit-equal, K1 once a step on
    every rank and no other kernel. Printed: rows/s a rank beside one
    rank's, spawn-to-first-step ms, K1 launches a rank;
21. ``record``: a ``utils/profiling.trace`` (``torch.profiler``) around
    5 train steps of ResNet-20 with K1, whose Chrome trace must exist and
    name K1's kernel; ``python -m mmlspark_tpu_torch.cli report --json
    --trace`` over the events logs of stream_resume's child C and of
    mesh_inputs' run C (rank 0), each trace passing ``validate_trace``;
    a watchdog stall on a fake heartbeat, which must write a
    flight-recorder dump. serve, lm_serve and train also print rounds
    with the flight recorder's ring off and on (``ring_rounds``,
    ``ring_images_per_s``), after their counted paths;
22. ``capture``: the featurize configuration (ResNet-50, 512 uint8
    images 256^2 -> K2 -> 224^2, batch 128, bf16) through ``TorchModel``
    with ``outputNodeName="stage3_block2/out"`` (a forward hook on that
    one block; NHWC, the reference's name) and ``"pool"``: K2's staged
    variant once a batch on each, no other kernel; the node's mean over H
    and W (fp32, on the card) equal to ``pool`` within a 49-term fp32
    mean's rounding; images/s of both nodes (the hook's cost);
23. ``downloader``: ResNet-50's weights written by ``LocalRepo.save_model``
    (the flax npz, ``to_jax_params``), served by a localhost
    ``http.server``, fetched by ``HttpRepo`` (sha256 checked) and loaded
    by ``ImageFeaturizer.set_model_from_downloader``: 128 images score
    BIT-equal to ``set_model`` with the same state dict; MB and seconds;
24. ``pretrained``: (a) the committed trained ResNet-20
    (``tests/data/pretrained/resnet20_synthetic.msgpack``, read by
    ``convert.from_flax_msgpack``) published by ``import_pretrained``
    with the reference test's arguments (bf16 convs) and with
    ``dtype="float32"``, loaded through ``ModelDownloader`` into
    ``ImageFeaturizer(cutOutputLayers=1, miniBatchSize=8)`` with TF32 off:
    ``golden.npz``'s 8 images (32^2 -> K2 -> 32^2) give ``pool`` within
    2e-2 of the golden table, the float32 model's within 1e-3 (rtol and
    atol) of the CPU's, the head all 8 labels, K2 once a pass; (b)
    ResNet-50's seed-0 state dict exported as numpy through
    ``from_torch_npz`` -> ``validate_params`` -> ``import_pretrained`` ->
    ``ModelDownloader``: 128 images (256^2 -> K2 -> 224^2, bf16) score
    BIT-equal to ``set_model`` with the same state; validate, save and
    load seconds, payload MB and K2's launches printed;
25. ``chaos``: ``reliability/chaos.py``'s ``train``, ``fleet``,
    ``decode`` and ``host`` scenarios on the card (seed 0, the reference
    tests' sizes), every verdict all-green, seconds and launches each;
26. ``chaos_mesh``: the mesh-bound scenarios ``fleet_sharded``,
    ``decode_sharded``, ``recommender`` and ``reshard``, each through
    ``python -m mmlspark_tpu_torch.cli chaos --scenario NAME --seed 0
    --nprocs 2 --platform cuda`` (two ranks sharing the card over gloo,
    rank 0 leading, the reference tests' sizes): exit 0, every verdict
    all-green, no placement left on either rank; seconds, the verdicts'
    ``restated`` lists and every rank's kernel launches each (none of the
    four reaches a kernel: mlp_tabular and the DLRM have none, and
    decode_sharded's prompts of 3-8 ids never reach K3's prefill buckets
    of 512 and more). ``--mesh-only --mesh-cards 4`` runs them after the
    mesh phase on four ranks, one a card, over NCCL;
27. ``cli``: ``python -m mmlspark_tpu_torch.cli info`` (platform gpu,
    count 1), ``check mmlspark_tpu_torch`` (exit 0) and ``top --once``
    over two in-process replicas served over HTTP;
28. prints the kernel table line (each kernel's launches on each of its
    paths), the whole script's seconds, the card's name and power limit,
    and last ``{"ok": true, "device": {...}}``.

Every phase's line carries ``seconds``, the time since the phase began.
Any failed check raises, so the exit code is nonzero and no result line is
printed. Without CUDA, or outside a checkout of the repository, it fails
before printing anything.
"""
from __future__ import annotations

import time

_T_MODULE = time.time()     # a stream_resume child's interpreter is up

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import warnings  # noqa: E402

import numpy as np

# ImageNet normalization in uint8 units, as the torchvision ResNets take it
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
N_IMAGES, BATCH, SRC, DST = 512, 128, 256, 224
# the JAX package's train lane (bench.py): CIFAR channel statistics in
# uint8 units, 4096 rows of 32x32x3, batch 256, 3 warm-up steps, windows
# of 40 timed steps, 60 steps of loss parity
CIFAR_MEAN = (125.3, 123.0, 113.9)
CIFAR_STD = (63.0, 62.1, 66.7)
TRAIN_ROWS, TRAIN_BATCH, TRAIN_SHAPE = 4096, 256, (32, 32, 3)
TRAIN_WARMUP, TRAIN_STEPS, PARITY_STEPS, PARITY_F32_STEPS = 3, 40, 60, 20
TRAIN_WINDOWS = 3
DEEP_ROWS, DEEP_FEATURES = 65536, 128
# the zoo's transformer_lm (vocab 32000, dim 512, depth 6, 8 heads, L 2048):
# 64 rows of ids scored at batch 8; the MoE LM over 16 rows
LM_ROWS, LM_BATCH, LM_LEN, LM_VOCAB, LM_DEPTH = 64, 8, 2048, 32000, 6
MOE_ROWS, LM_F32_ROWS = 16, 16
# ViT-B/16 as the JAX bench's vit_preprocess lane feeds it: 256x256 uint8,
# 224 on the card, mean = std = 127.5, batch 32
VIT_IMAGES, VIT_BATCH = 128, 32
# the automl phase: UCI Adult's train/test split (archive.ics.uci.edu/
# dataset/2/adult); card against CPU within the golden harness's TOL
# (tests/test_golden_metrics.py), fp32 parameters within 1e-4 (norm-wise)
AUTOML_TRAIN_ROWS, AUTOML_TEST_ROWS = 32561, 16281
AUTOML_TOL, AUTOML_PARAM_RTOL = 5e-3, 1e-4
# timed scoring passes of the test rows a learner (their median is kept)
AUTOML_SCORE_PASSES = 2
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
# K3 against its plain version: fp32 sums in another order (2e-5), and in
# bf16 on the CUDA-core route (D > 128) one bf16 step of the value beyond
# that
K3_F32_TOL = 2e-5
# K3's tensor-core route (bf16, D <= 128) against its plain version, which
# keeps p in fp32: rounding each p_j to bf16 moves it by at most bf16's unit
# roundoff 2^-8 of itself, so an output moves by at most 2^-8 max|v|; plus
# K3_F32_TOL and one bf16 step of the output. The mean |difference| is held
# to 2^-8 of the mean |output|: a CPU emulation of the route's arithmetic
# (tests/test_torch_attention.py, L = 512, D 16/64/128, causal or not)
# reads 0.32-0.38 of that ceiling and at most 0.50 of the bound
TC_P_ROUNDING, TC_MEAN_CEILING = 2.0 ** -8, 2.0 ** -8
# the LM's hidden (unit-variance final-norm output, |x| up to ~5), K3 route
# against the reference-attention route. bf16: the reference rounds the
# normalized p to bf16 before p.v, K3's tensor-core route the p of its
# running max, so attention outputs differ by about one bf16 step, which
# the bf16 residual sums of 6 blocks carry on (one step at
# magnitude 4 is 0.016): max 0.1, mean 0.01. fp32 (TF32 off): 1e-3.
LM_BF16_MAX, LM_BF16_MEAN, LM_F32_MAX = 1e-1, 1e-2, 1e-3
# the MoE LM: a token whose top-2 gates nearly tie may take another expert
# when attention rounds differently, and then moves by O(1); rounding alone
# moves a token by at most ~0.1 (CPU rehearsal at L=512). So: the mean as
# the LM's, and at most 1% of tokens moved by more than 0.25, not a bound
# on the worst token
MOE_MEAN, MOE_MOVED, MOE_SHARE_MOVED = 1e-2, 0.25, 0.01
# the JAX bench's text lane (bench.py): 40 steps x batch 256 of reviews, 128
# hashed ids over 32,768 slots, textcnn trained 6 epochs with adam(1e-3);
# 2 timed runs; 20 fp32 steps (TF32 off) held against a CPU run
TEXT_STEPS, TEXT_BATCH, TEXT_SEQ, TEXT_VOCAB = 40, 256, 128, 1 << 15
TEXT_EPOCHS, TEXT_RUNS, TEXT_PARITY_STEPS = 6, 2, 20
# lm_train: transformer_lm at the zoo's width, 64 resident rows of ids,
# batch 8, adamw(1e-3): 3 warm-up steps, 2 timed windows of 8 steps; the
# bf16 gate at batch 2 over 10 steps against the reference attention; the
# fp32 gate at depth 2 over 2 rows (batch 2), 5 steps; the MoE LM over 16
# rows at batch 8, 5 steps
LM_TRAIN_WARMUP, LM_TRAIN_WINDOW, LM_TRAIN_WINDOWS = 3, 8, 2
LM_GATE_BATCH, LM_GATE_STEPS = 2, 10
LM_F32_DEPTH, LM_F32_TRAIN_ROWS, LM_F32_STEPS = 2, 2, 5
MOE_TRAIN_STEPS = 5
# the JAX bench's train_large lane: ViT-B/16 at 224x224, 1000 classes,
# bf16, 256 resident uint8 images, batch 128, sgd(0.01, momentum 0.9), K1
# (mean = std = 127.5) in the loss; 2 warm-up steps, 3 timed windows of 8
# steps, 10 steps held against K1's plain version
TL_IMAGES, TL_BATCH, TL_SHAPE = 256, 128, (224, 224, 3)
TL_WARMUP, TL_STEPS, TL_WINDOWS, TL_PARITY_STEPS = 2, 8, 3, 10
# deep: a short fit per optimizer on the card and on the CPU, fp32, TF32 off
DEEP_OPT_ROWS = 8192
# the new paths' gates, each the largest relative difference of a per-step
# loss (for the deep fits, of a parameter array, norm-wise) allowed. The
# first card runs read: textcnn fp32 card vs CPU 1.5e-6 and 2.9e-6 (cuDNN
# and the CPU sum the convs in other orders, the card's embedding backward
# scatter-adds in no fixed order, and Adam carries it); the bf16 LM, K3 vs the
# reference attention, 1.4e-5 (the two round p to bf16 at different
# maxima), held at a quarter of one bf16 step (2^-8); the fp32 LM on K3's
# CUDA-core route 2.7e-7; train_large bit-equal to K1's plain version (K1
# is bit-equal; held at the train phase's bf16 bound); lamb 3.2e-7 and
# adafactor 5.5e-7
TEXT_F32_TOL = 2e-5
LM_BF16_TRAIN_TOL, LM_F32_TRAIN_TOL = 1e-3, 1e-4
TL_PARITY_TOL = 1e-3

# the vmoe phase: V-MoE-B/16 (models/zoo/vit.py::vmoe_b16) trained at
# vmoe_b16.train's batch of 128 224x224 images (S = 25,216 tokens; 32
# experts of C = 1,655 slots in each routed block), and each MoE kernel of
# ops/moe.py against its plain version at those shapes. VM_TOL: bf16
# storage of the pre-activation, activation and outputs on both routes,
# fp32 sums in another order, so a value may round to the neighbouring
# bf16 (2^-8 of it); a wrong tile, slot or operand layout reads O(1)
VM_BATCH, VM_STEPS, VM_TOL = 128, 5, 2e-2
DEEP_OPT_TOL = 1e-5
# the serve phases. serve: the featurize path's ResNet-50 scoring model
# (bf16, pool, K2 resizing 256^2 uint8 to 224^2) behind a Server with
# buckets (1, 8, 32, 64), 512 single-image requests from 16 client threads
# (each waits for its answer before the next). lm_serve: transformer_lm
# (bf16, hidden) behind buckets (1, 4, 8), 128 requests of 2048 ids from 8
# clients. generate: transformer_lm's lane at max_seq_len 2048, 8
# sequences, KV blocks of 16 tokens; 128 prompts of 600-1900 ids from 8
# clients, 32 new tokens each (so that the timed windows last seconds and
# p99 is not the maximum), the first 16 also through the full recompute;
# a round of 8 prompts sharing a 1024-id head;
# the fp32 gate at depth 2 over 4 prompts of 600-1000 ids. Served rows of
# a full batch must equal the eager pass at the same batch shape bit for
# bit; rows served at other buckets are held within the featurize phase's
# 2% (serve) and lm_score's bf16 limits (lm_serve)
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_BUCKETS = 512, 16, (1, 8, 32, 64)
SERVE_REL_TOL = 0.02
LM_SERVE_REQUESTS, LM_SERVE_CLIENTS, LM_SERVE_BUCKETS = 128, 8, (1, 4, 8)
GEN_CONFIG = {"generate.max_seq_len": 2048, "generate.max_sequences": 8,
              "generate.kv_block_tokens": 16}
GEN_REQUESTS, GEN_CLIENTS, GEN_NEW_TOKENS = 128, 8, 32
GEN_PROMPT, GEN_RECOMPUTED = (600, 1900), 16
GEN_PREFIX_REQUESTS, GEN_PREFIX_HEAD, GEN_PREFIX_SUFFIX = 8, 1024, (1, 400)
GEN_F32_DEPTH, GEN_F32_PROMPTS, GEN_F32_PROMPT = 2, 4, (600, 1000)
# the spec rounds (a same-weights draft, a depth-2 draft sharing the
# target's embeddings, first two blocks and head) and the int8 round: 32
# of the round's prompts; the fp32 gate's divergent draft has seed 1
GEN_SPEC_REQUESTS, GEN_SPEC_TOKENS, GEN_F32_DRAFT_SEED = 32, 3, 1
# fleet: Fleet(replicas=2) of the generate model on the one card, 64
# prompts from 8 closed-loop clients (half on one 1024-id head, half of
# 600-1900 ids); r0 killed after 16 answers, scale_up after 24, a rollout
# to seed 1 after 32; the scraper polls every 0.25 s; the fp32 gate at
# depth 2 over 4 prompts
FLEET_REQUESTS, FLEET_CLIENTS, FLEET_HEAD, FLEET_SUFFIX = 64, 8, 1024, 400
FLEET_KILL_AT, FLEET_SCALE_AT, FLEET_ROLLOUT_AT = 16, 24, 32
FLEET_SCRAPE_S, FLEET_F32_PROMPTS = 0.25, 4
# process_fleet: two worker processes on the one card serving the fleet's
# 64 prompts from 8 clients (a client retries a retryable failure up to 4
# times); w1 SIGKILLed after 24 answers; the fp32 gate over 4 prompts of
# 600-1000 ids (K3's CUDA-core route) on every worker
PF_REQUESTS, PF_CLIENTS, PF_KILL_AT, PF_ATTEMPTS = 64, 8, 24, 4
PF_F32_PROMPTS, PF_LM = 4, {"seed": 0}
# stream_resume: the train cell's 4,096 images as PNG files, streamed
# through FileSource -> shuffle(1024, seed 0) -> decode(4 workers) -> map
# -> batch(256, drop) -> repeat into ResNet-20 with K1 in the loss, 32 steps
# (16 an epoch), a checkpoint every 5 steps; child B is SIGKILLed once it
# reports step 23 or later. The deep cell's DeepClassifier (65,536 x 128,
# 2 epochs of 256 steps) checkpoints every 100 steps, and child B's fit is
# stopped by a fault at its 333rd step (mid-epoch 2). A child is killed
# after 300 s.
SR_FILES, SR_BATCH, SR_STEPS, SR_SAVE_EVERY, SR_KILL_AT = 4096, 256, 32, 5, 23
SR_WINDOW, SR_WORKERS, SR_CHILD_TIMEOUT_S = 1024, 4, 300
SR_DEEP_EVERY, SR_DEEP_FAULT_AT = 100, 333
# the timed run_dataset runs (2 at save_every 0, 2 at 5): one epoch each;
# the streaming_input lane and save/restore are timed as many times
SR_TIMED_STEPS, SR_TIMED_RUNS = 16, 2
# mesh: meshed training. On one card two ranks share it over gloo (NCCL
# refuses two ranks on one device, "Duplicate GPU detected", probed on the
# card's machine); with --mesh-cards 4 one rank a card over NCCL.
# transformer_lm at the zoo's width (bf16, global batch 8, adam(1e-3)):
# 3 warm-up and 4 timed steps a mesh; the fp32 gate at depth 2 (global
# batch 4, 5 steps, TF32 off); ResNet-20 data parallel over the train
# cell's 4,096 images at global batch 256, one epoch of 16 steps, K1 in
# the loss; a checkpoint saved on one mesh shape, restored on another and
# back, 2 steps on each. A launch of the ranks is killed after
# MESH_CHILD_TIMEOUT_S.
MESH_LM_BATCH, MESH_LM_WARMUP, MESH_LM_STEPS = 8, 3, 4
MESH_F32_BATCH, MESH_F32_STEPS, MESH_CKPT_STEPS = 4, 5, 2
MESH_RESNET_STEPS, MESH_CHILD_TIMEOUT_S = 16, 420
# gates, each the largest relative difference of a per-step loss from the
# one-rank run on the same params and batches: bf16 LM_BF16_TRAIN_TOL (a
# quarter of one bf16 step: the split layers round their partial sums in
# bf16 at other places); fp32 1e-5 (sums reordered over ranks, TF32 off).
# ResNet-20 on these random images is chaotic: on the CPU a 1e-7 change of
# one weight moves the one-device loss by 3e-6 at step 3 and 6e-3 by step
# 12 (sgd 0.1, momentum 0.9; 2e-4 by step 16 at sgd 0.01), and the card's
# first data-parallel run read 2.3e-5 within 3 fp32 steps. So its data
# parallel update is held where chaos has not acted: the first step's
# loss (the forward of the same weights; bf16 within LM_BF16_TRAIN_TOL,
# fp32 within MESH_F32_TOL) and the fp32 first update, norm-wise within
# MESH_UPDATE_TOL of the update itself: a conv's weight gradient sums
# 262,144 products (256 images x 32 x 32), which other batch splits and
# algorithms add in other orders, about sqrt(n) * 2^-24 = 3e-5 of their
# magnitude and more where they cancel (the card read 5.2e-4 at data 2,
# the CPU 8.9e-7); every step's loss is printed
MESH_F32_TOL, MESH_UPDATE_TOL = 1e-5, 1e-3
# the slice-6b-i runs of the mesh phase (module docstring, phase 20): the
# MoE LM (bf16: 2 warm-up + 2 timed steps at global batch 8; fp32 at
# depth 2: 3 steps at batch 4), the pipelined MLP of the JAX bench's
# fleet_reshard lane (6 steps; the reshard's at 3 and 5) and its
# recommender lane's DLRM (4 steps of 2048 rows)
MESH_MOE_BATCH, MESH_MOE_WARMUP, MESH_MOE_STEPS = 8, 2, 2
MESH_MOE_F32_BATCH, MESH_MOE_F32_STEPS = 4, 3
MESH_PIPE_D, MESH_PIPE_HIDDEN, MESH_PIPE_BATCH = 1024, 2048, 16
MESH_PIPE_STEPS, MESH_PIPE_LR, MESH_PIPE_MICRO = 6, 1e-4, 2
MESH_PIPE_RESHARD_AT = (3, 5)
MESH_DLRM_DENSE, MESH_DLRM_SLOTS, MESH_DLRM_EMBED = 16, 4, 16
MESH_DLRM_TABLES = (("user", 524288), ("item", 524288))
MESH_DLRM_BATCH, MESH_DLRM_STEPS, MESH_DLRM_LR = 2048, 4, 0.05
# the MoE LM's bf16 losses against one rank's: in the bf16 runs the
# experts' fp32 GEMMs run on TF32, whose rounding depends on the GEMM's
# shape (4 experts a rank against 8), and a token whose top-2 gates
# nearly tie can then take another expert and move by O(1); so the MoE
# is held wider than the dense LM's LM_BF16_TRAIN_TOL. The first card
# run read 8.75e-4 over 6 steps at expert 2 (fp32 with TF32 off: 8.8e-8,
# the routing equal)
MESH_MOE_BF16_TOL = 3e-3
# the DLRM's losses against the one-rank unsharded run: the lookup and
# the table gradient are exact, the dense towers' sums split otherwise
# (the JAX test's bound)
MESH_DLRM_TOL = 2e-6
# mesh_serve: the LM's served rows (lm_serve's traffic, fewer rows), the
# generate round's prompts (8 sequences in flight), the
# recommender's served rows and bucket, the fleet's replicas and the
# fp32 gate's logits bound (sums reordered over the tensor ranks, TF32
# off; MESH_F32_TOL's bound on one logit)
MESH_SERVE_LM_REQUESTS, MESH_SERVE_GEN_REQUESTS = 64, 8
MESH_SERVE_DLRM_ROWS = 4096
MESH_SERVE_DLRM_BUCKET, MESH_SERVE_FLEET_REPLICAS = 256, 2
MESH_SERVE_F32_LEN, MESH_SERVE_F32_ROWS, MESH_SERVE_F32_NEW = 512, 2, 8
MESH_SERVE_F32_TOL = 1e-5
MESH_SERVE_IMAGES = 128
# mesh_inputs (PR 17), multi-process training inputs at data 2: (a) the
# deep cell's DeepClassifier (65,536 x 128, batch 256, MI_DEEP_EPOCHS
# epochs, deviceCache 'on', fp32 with TF32 off for its MESH_F32_TOL gate),
# each rank fitting its process_shard(block_rows=128), against one rank
# over the whole frame; (b) stream_resume's corpus and lane (ResNet-20
# bf16, K1 in the loss) through a meshed run_dataset, each rank streaming
# its half of the files at 128 rows a step (global batch 256), SR_STEPS
# steps, a checkpoint every SR_SAVE_EVERY: run A whole, run B's two ranks
# SIGKILLed once rank 0 reports step MI_KILL_AT, run C resumed from B's
# directory; a run of the ranks is killed after MI_CHILD_TIMEOUT_S; (c)
# the epoch cache's verdict with one rank's device_cache_mb under its
# epoch
MI_DEEP_BATCH, MI_DEEP_EPOCHS, MI_KILL_AT, MI_CHILD_TIMEOUT_S = 256, 2, 23, 300
# (a)'s gates: the same global batches (their hashes equal), so the first
# MI_GATED_STEPS steps' losses are held at MESH_F32_TOL of one rank's; past
# them adamw turns last-bit gradient differences into steps of the
# learning rate's size (the card's first run read 3.8e-4 on the final
# loss after 512 steps, params 3.2e-3 apart), so the whole fit is held to
# the reference's own cross-topology bounds (tests/test_multiprocess.py:
# 211-218: final loss rtol 2e-2, predictions equal on >= 62/64 of rows)
# and every step's difference is printed
MI_GATED_STEPS, MI_XTOPO_RTOL, MI_XTOPO_AGREE = 16, 2e-2, 62 / 64
# record (PR 17): train steps under profiling.trace; the rounds of the
# flight recorder's ring off and on that serve, lm_serve and train add
RECORD_TRACE_STEPS, RING_ROUNDS = 5, 1
# fp32 operations per output element of the crop-resize-normalize kernel:
# two row lerps (3 each), one column lerp (3), rint, clamp (2), subtract,
# multiply
K2_OPS_PER_ELEMENT = 14
# of the normalize kernel: subtract, multiply
K1_OPS_PER_ELEMENT = 2


# when the running phase of main() began (perf_counter); None outside one
_PHASE_T0 = [None]


def _line(**obj) -> None:
    """One JSON line; a phase's line carries the seconds since its phase
    began (``seconds``) unless it names its own."""
    if "phase" in obj and "seconds" not in obj and _PHASE_T0[0] is not None:
        obj["seconds"] = time.perf_counter() - _PHASE_T0[0]
    print(json.dumps(obj), flush=True)


def _run(phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, its lines timed from here."""
    _PHASE_T0[0] = time.perf_counter()
    try:
        return phase(*args, **kwargs)
    finally:
        _PHASE_T0[0] = None


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _median_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back
    calls, from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured once in a CUDA
    graph, the graph replayed between CUDA events, the median over
    ``reps`` replays of the mean per call. A replay launches without the
    host, whose per-call overhead (Python, ctypes, the allocator) paces
    back-to-back eager calls of a microsecond kernel (``_median_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _bound(nbytes: int, ops: int, peak_ops_s: float = PEAK_FP32_S):
    """(bound ms, what bounds it) from the bytes moved and the operations
    done, at the card's published peaks (fp32 unless ``peak_ops_s``)."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def _ptxas_of(kernel):
    """ptxas's registers and spill bytes of each function of ``kernel``'s
    library, demangled, from its build log."""
    from mmlspark_tpu_torch.kernels import build
    report = build.ptxas_report(kernel.build_log)
    return dict(zip(build.demangle(list(report)), report.values()))


def _floor_ms(torch, fn):
    """Device time of an empty kernel on a kernel's grid (``fn(stream)``
    launches it on the current stream, the one a graph captures): the floor
    the kernel cannot go below."""
    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        _check(fn(stream) == 0, "an empty floor kernel failed to launch")
    return _graph_ms(torch, launch)


def _launches(kernels) -> dict:
    return {k.name: k.launches for k in kernels.KERNELS}


def _want(kernels, **counts) -> dict:
    """Launch counts by kernel name: ``counts`` by the kernels' attribute
    names in ``kernels`` (``FUSED_NORMALIZE=...``), every other kernel 0."""
    want = {k.name: 0 for k in kernels.KERNELS}
    for attr, n in counts.items():
        want[getattr(kernels, attr).name] = n
    return want


def _sync_checked(torch, run):
    """``run()`` under CUDA's sync-debug mode: returns its result, the
    places outside ``observability/syncs.py`` (the counted syncs) that
    synchronized with the host, and the number of sync warnings in all."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncing = [w for w in caught if "synchroniz" in str(w.message)]
    hidden = [f"{w.filename}:{w.lineno}" for w in syncing
              if not w.filename.endswith("syncs.py")]
    return out, hidden, len(syncing)


def _max_step_rel(got, want) -> float:
    """The largest relative difference of two per-step loss histories."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def phase_kernel_check_k1(torch, tpre, kernel, card):
    """K1 against its plain version at its three shapes (bit-equal
    required); times, bound and launch floor (an empty kernel on the same
    grid) at each, and at the train shape K1 over the 16 distinct batch
    slices of a resident epoch as the train step reads them. Returns the
    train shape's bf16 row, with the f32 time beside it."""
    from ctypes import c_int, c_longlong, c_void_p
    empty = kernel.symbol("fused_normalize_empty",
                          [c_longlong, c_int, c_int, c_void_p])
    shapes = [("train_bf16", (TRAIN_BATCH, math.prod(TRAIN_SHAPE)),
               torch.bfloat16, CIFAR_MEAN, CIFAR_STD),
              ("train_f32", (TRAIN_BATCH, math.prod(TRAIN_SHAPE)),
               torch.float32, CIFAR_MEAN, CIFAR_STD),
              ("train_large_bf16", (128, 224 * 224 * 3), torch.bfloat16,
               (127.5,) * 3, (127.5,) * 3)]
    rows = {}
    for name, shape, dt, mean, std in shapes:
        u8 = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, shape, dtype=np.uint8)).to(card)
        consts = (torch.tensor(mean, dtype=torch.float32, device=card),
                  torch.from_numpy(tpre._inv_std(std)).to(card))
        got = tpre.fused_normalize(u8, *consts, dt)
        want = tpre._fused_normalize_plain(u8, *consts, dt)
        torch.cuda.synchronize()
        max_err = (got.float() - want.float()).abs().max().item()
        _check(max_err == 0.0 and got.dtype == want.dtype,
               f"K1 {name}: max err {max_err} against its plain version "
               "(bit-equal required)")
        kernel_ms = _graph_ms(
            torch, lambda: tpre.fused_normalize(u8, *consts, dt))
        plain_ms = _graph_ms(
            torch, lambda: tpre._fused_normalize_plain(u8, *consts, dt))
        eager_ms = _median_ms(
            torch, lambda: tpre.fused_normalize(u8, *consts, dt))
        bf16 = int(dt == torch.bfloat16)
        floor_ms = _floor_ms(torch, lambda s: empty(u8.numel(), 3, bf16, s))
        out_size = torch.empty((), dtype=dt).element_size()
        nbytes = u8.numel() * (1 + out_size) + sum(
            t.numel() * t.element_size() for t in consts)
        bound_ms, bound_by = _bound(nbytes, K1_OPS_PER_ELEMENT * u8.numel())
        rows[name] = dict(
            variant=name, shape=list(shape),
            out_dtype=str(dt).replace("torch.", ""), max_abs_err=max_err,
            ms=kernel_ms, plain_ms=plain_ms, eager_ms=eager_ms,
            floor_ms=floor_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, bound_share=bound_ms / kernel_ms,
            over_floor_ms=kernel_ms - floor_ms)

    # the train step's reads: 16 distinct batch slices of a resident epoch
    # of 4,096 images, against one slice replayed (the rows above)
    epoch = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (TRAIN_ROWS, math.prod(TRAIN_SHAPE)), dtype=np.uint8)).to(card)
    slices = [epoch[i:i + TRAIN_BATCH]
              for i in range(0, TRAIN_ROWS, TRAIN_BATCH)]
    consts = (torch.tensor(CIFAR_MEAN, dtype=torch.float32, device=card),
              torch.from_numpy(tpre._inv_std(CIFAR_STD)).to(card))
    turn = iter(range(10 ** 9))
    epoch_ms = _graph_ms(torch, lambda: tpre.fused_normalize(
        slices[next(turn) % len(slices)], *consts, torch.bfloat16),
        iters=len(slices))
    rows["train_bf16"]["epoch_slices_ms"] = epoch_ms
    ptxas = _ptxas_of(kernel)
    _line(phase="kernel_check", kernel=kernel.name,
          launches_while_checking=kernel.launches,
          variant_launches_while_checking=dict(kernel.variant_launches),
          variants=list(rows.values()),
          epoch_slices=dict(slices=len(slices), ms=epoch_ms,
                            one_slice_replayed_ms=rows["train_bf16"]["ms"]),
          ptxas=ptxas,
          library="none: no single PyTorch call computes a per-channel "
                  "uint8 normalize with a bf16 or f32 store")
    main = dict(rows["train_bf16"])
    main.update(ms_f32=rows["train_f32"]["ms"],
                floor_ms_f32=rows["train_f32"]["floor_ms"],
                bound_ms_f32=rows["train_f32"]["bound_ms"],
                ms_large_bf16=rows["train_large_bf16"]["ms"],
                bound_ms_large_bf16=rows["train_large_bf16"]["bound_ms"],
                ptxas=ptxas)
    return main


def phase_kernel_check(torch, tpre, kernel, card):
    """K2 against its plain version at the main path's geometries and at
    the serve path's batch buckets (untimed); at the
    main shape (256² → 224²) in bf16, the featurize path's output, and
    f32: times, bound, launch floor (an empty kernel on the same grid),
    the direct-load variant's time beside the staged one, and
    ``F.interpolate``'s. Returns the bf16 row with the f32 numbers."""
    from ctypes import c_int, c_void_p
    empty = kernel.symbol("crop_resize_normalize_empty",
                          [c_int, c_int, c_int, c_void_p])
    raw = np.random.default_rng(1).integers(
        0, 256, (BATCH, SRC, SRC, 3), dtype=np.uint8)
    u8 = torch.from_numpy(raw).to(card)
    variants = [
        ("resize_bf16", None, (DST, DST), torch.bfloat16, BATCH),
        ("resize", None, (DST, DST), torch.float32, BATCH),
        ("crop_resize", (240, 240), (DST, DST), torch.float32, BATCH),
        ("crop_resize_bf16", (240, 240), (DST, DST), torch.bfloat16, BATCH),
        ("crop_only", (DST, DST), None, torch.float32, BATCH),
        ("crop_only_bf16", (DST, DST), None, torch.bfloat16, BATCH),
    ] + [   # the serve path's batch buckets, checked and not timed
        (f"serve_b{b}_resize_bf16", None, (DST, DST), torch.bfloat16, b)
        for b in SERVE_BUCKETS]
    xf = u8.permute(0, 3, 1, 2).float()   # NCHW view, channels-last
    library_ms = _graph_ms(torch, lambda: torch.nn.functional.interpolate(
        xf, size=(DST, DST), mode="bilinear", align_corners=False,
        antialias=False))
    rows = {}
    for name, crop, resize, dt, batch in variants:
        x = u8[:batch]
        plan = tpre.CropResizePlan((SRC, SRC, 3), resize=resize, crop=crop,
                                   mean=IMAGENET_MEAN, std=IMAGENET_STD)
        before = kernel.variant_launches.get("staged", 0)
        got = tpre.crop_resize_normalize(x, plan, dt)
        _check(kernel.variant_launches.get("staged", 0) == before + 1,
               f"K2 {name}: the staged variant did not launch")
        want = tpre._crop_resize_normalize_plain(x, plan, dt)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        std = torch.tensor(IMAGENET_STD, device=card)
        quanta = (diff * std).max().item()
        share = (diff > 0).float().mean().item()
        max_err = diff.max().item()
        if crop is not None and resize is None:
            tol = 2e-5                   # a crop alone resamples nothing
        else:
            tol = 1.01 / min(IMAGENET_STD)
            if dt == torch.bfloat16:     # plus one bf16 step
                tol += 2 ** -7 * want.float().abs().max().item()
        _check(max_err <= tol and share <= 0.01,
               f"K2 {name}: max err {max_err} (tol {tol}), "
               f"share differing {share}")
        row = dict(variant=name, out_dtype=str(dt).replace("torch.", ""),
                   batch=batch, band_rows=plan.band_rows,
                   stage_max=plan.stage_max,
                   smem_bytes=plan.smem_bytes(plan.stage_max),
                   max_abs_err=max_err, max_quanta=quanta,
                   share_differing=share, tolerance=tol)
        if name in ("resize_bf16", "resize"):
            direct = tpre.CropResizePlan(
                (SRC, SRC, 3), resize=resize, crop=crop, mean=IMAGENET_MEAN,
                std=IMAGENET_STD, smem_budget=0)
            same = tpre.crop_resize_normalize(u8, direct, dt)
            _check(bool(torch.equal(same, got)),
                   f"K2 {name}: the direct-load variant differs from the "
                   "staged one")
            kernel_ms = _graph_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, plan, dt))
            direct_ms = _graph_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, direct, dt))
            plain_ms = _graph_ms(
                torch, lambda: tpre._crop_resize_normalize_plain(u8, plan, dt))
            eager_ms = _median_ms(
                torch, lambda: tpre.crop_resize_normalize(u8, plan, dt))
            floor_ms = _floor_ms(
                torch, lambda s: empty(BATCH, DST, plan.band_rows, s))
            nbytes = plan.bytes_moved(BATCH, dt) + sum(
                t.numel() * t.element_size() for t in plan.on(card))
            ops = K2_OPS_PER_ELEMENT * BATCH * DST * DST * 3
            bound_ms, bound_by = _bound(nbytes, ops)
            row.update(ms=kernel_ms, direct_ms=direct_ms, plain_ms=plain_ms,
                       library_ms=library_ms, eager_ms=eager_ms,
                       floor_ms=floor_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=ops,
                       bound_share=bound_ms / kernel_ms)
        rows[name] = row
    ptxas = _ptxas_of(kernel)
    _line(phase="kernel_check", kernel=kernel.name, shape=[BATCH, SRC, SRC, 3],
          launches_while_checking=kernel.launches,
          variant_launches_while_checking=dict(kernel.variant_launches),
          variants=list(rows.values()), ptxas=ptxas,
          library="F.interpolate bilinear on the float NCHW view "
                  "(resample only)")
    main = dict(rows["resize_bf16"])
    f32 = rows["resize"]
    main.update(ms_f32=f32["ms"], direct_ms_f32=f32["direct_ms"],
                plain_ms_f32=f32["plain_ms"], floor_ms_f32=f32["floor_ms"],
                bound_ms_f32=f32["bound_ms"],
                max_abs_err_f32=f32["max_abs_err"], ptxas=ptxas)
    return main


def _bf16_steps(got, want):
    """The largest |got - want| beyond K3_F32_TOL, in bf16 steps (ulps) of
    the larger magnitude: at most 1 passes."""
    g, w = got.float(), want.float()
    mag = g.abs().maximum(w.abs())
    ulp = (mag.log2().floor() - 7).exp2().clamp(min=2.0 ** -133)
    return (((g - w).abs() - K3_F32_TOL).clamp(min=0) / ulp).max().item()


def _tc_gate(got, want, v):
    """(worst |got - want| over its bound, mean |got - want| over its
    ceiling) for K3's tensor-core route: both at most 1 pass."""
    g, w = got.float(), want.float()
    mag = g.abs().maximum(w.abs())
    step = (mag.log2().floor() - 7).exp2().clamp(min=2.0 ** -133)
    diff = (g - w).abs()
    bound = TC_P_ROUNDING * v.float().abs().max() + K3_F32_TOL + step
    return ((diff / bound).max().item(),
            (diff.mean() / (TC_MEAN_CEILING * w.abs().mean())).item())


def phase_kernel_check_k3(torch, tatt, kernels, card):
    """K3 against its plain version at the LM's shape (bf16 and f32), the
    JAX bench's longctx shape and other head dims, each through the
    route ``_route`` picks; both K3 kernels' launches are counted across the
    routed call (the route's kernel once, the other never) and across the
    plain call (neither). Times, the library call's time and the bound at
    each, except at the lm_serve and generate prefill shapes, which are
    held to the same gates untimed. Returns the LM shape's row of each
    route."""
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 products in fp32
    ks = {"tc": kernels.FLASH_ATTENTION_TC, "f32": kernels.FLASH_ATTENTION}
    lm = (LM_BATCH, LM_LEN, 8, 64)
    variants = [("lm_bf16", lm, torch.bfloat16, True),
                ("lm_f32", lm, torch.float32, True),
                ("longctx_bf16", (1, 8192, 8, 64), torch.bfloat16, True),
                ("d16_bf16", (8, 512, 8, 16), torch.bfloat16, False),
                ("lm_d128_bf16", (LM_BATCH, LM_LEN, 4, 128), torch.bfloat16,
                 True),
                ("d512_f32", (2, 512, 4, 512), torch.float32, True),
                ("lm_d128_f32", (LM_BATCH, LM_LEN, 4, 128), torch.float32,
                 True),
                # the CUDA-core route's bf16 input; SDPA runs it on the
                # tensor cores
                ("d256_bf16", (2, LM_LEN, 4, 256), torch.bfloat16, True)]
    # the shapes the lm_serve graphs (batch buckets 1 and 4) and the
    # generate prefill graphs (one prompt at buckets 1024 and 2048; bf16,
    # and f32 in the fp32 gate) give K3: checked, not timed
    checked = [("serve_b1_prefill_2048_bf16", (1, LM_LEN, 8, 64),
                torch.bfloat16),
               ("serve_b4_bf16", (4, LM_LEN, 8, 64), torch.bfloat16),
               ("prefill_1024_bf16", (1, 1024, 8, 64), torch.bfloat16),
               ("prefill_1024_f32", (1, 1024, 8, 64), torch.float32),
               ("prefill_2048_f32", (1, LM_LEN, 8, 64), torch.float32)]
    variants = ([v + (True,) for v in variants]
                + [v + (True, False) for v in checked])

    def counted(fn):
        before = {r: k.launches for r, k in ks.items()}
        out = fn()
        return out, {r: k.launches - before[r] for r, k in ks.items()}

    rows, main = [], {}
    for name, shape, dt, causal, timed in variants:
        rng = np.random.default_rng(8)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(card, dt) for _ in range(3))
        b, L, h, d = shape
        route = tatt._route(dt, d)
        got, got_launches = counted(
            lambda: tatt.flash_attention(q, k, v, causal=causal))
        want, want_launches = counted(
            lambda: tatt.flash_attention_plain(q, k, v, causal))
        torch.cuda.synchronize()
        _check(got_launches == {r: int(r == route) for r in ks}
               and want_launches == {r: 0 for r in ks},
               f"K3 {name}: route {route}, launches {got_launches} across "
               f"the kernel call and {want_launches} across the plain call")
        max_err = (got.float() - want.float()).abs().max().item()
        steps = _bf16_steps(got, want)
        gate = None
        if dt == torch.float32:
            ok = max_err <= K3_F32_TOL
        elif route == "tc":
            gate = _tc_gate(got, want, v)
            ok = gate[0] <= 1.0 and gate[1] <= 1.0
        else:
            ok = steps <= 1.0
        _check(ok and got.dtype == dt and bool(torch.isfinite(
            got.float()).all()), f"K3 {name} ({route}): max err {max_err} "
                                 f"({steps} bf16 steps, gate {gate}) against "
                                 "its plain version")
        row = dict(variant=name, route=route, kernel=ks[route].name,
                   shape=list(shape), causal=causal,
                   dtype=str(dt).replace("torch.", ""),
                   launches_kernel_call=got_launches,
                   launches_plain_call=want_launches, max_abs_err=max_err,
                   mean_abs_err=(got.float() - want.float()).abs().mean()
                   .item(), bf16_steps_beyond_f32_tol=steps,
                   tc_gate_worst_over_bound=None if gate is None else gate[0],
                   tc_gate_mean_over_ceiling=None if gate is None
                   else gate[1])
        rows.append(row)
        if not timed:
            continue
        plain_iters = 2 if L >= 8192 else 5
        kernel_ms = _graph_ms(
            torch, lambda: tatt.flash_attention(q, k, v, causal=causal))
        plain_ms = _graph_ms(
            torch, lambda: tatt.flash_attention_plain(q, k, v, causal),
            iters=plain_iters, reps=3)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal))
        eager_ms = _median_ms(
            torch, lambda: tatt.flash_attention(q, k, v, causal=causal))
        # the causal-useful FLOPs (bench.py's longctx count): two products
        # of 2 D operations per (query, key) pair the mask keeps
        pairs = L * (L + 1) // 2 if causal else L * L
        flops = 4 * b * h * d * pairs
        nbytes = 4 * q.numel() * q.element_size()
        bound_ms, bound_by = _bound(
            nbytes, flops, PEAK_BF16_S if dt == torch.bfloat16
            else PEAK_FP32_S)
        row.update(ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                   library_ms=library_ms, over_library=kernel_ms / library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes, tflops=flops / kernel_ms / 1e9,
                   bound_share=bound_ms / kernel_ms)
        main.setdefault(route, row)
    _line(phase="kernel_check", kernel="flash_attention (both routes)",
          launches_while_checking={r: k.launches for r, k in ks.items()},
          variants=rows,
          library="F.scaled_dot_product_attention on (B, H, L, D) views, "
                  "a yardstick the port never calls", tf32="off")
    return main


def phase_featurize(torch, kernels, card, profile_dir=None):
    """The main path through the public entry points, and its checks.
    With ``profile_dir``, one more warm pass runs under ``torch.profiler``
    and its per-kernel device times are written there."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.ops.preprocess import (
        CropResizePlan, _crop_resize_normalize_plain,
    )

    raw = np.random.default_rng(2).integers(
        0, 256, size=(N_IMAGES, SRC, SRC, 3), dtype=np.uint8)
    imgs = np.empty(N_IMAGES, dtype=object)
    for i in range(N_IMAGES):
        imgs[i] = ImageValue(path=f"mem://smoke/{i}", data=raw[i])
    frame = Frame.from_dict({"row": np.arange(N_IMAGES)}, num_partitions=4)
    frame = frame.with_column_values(ColumnSchema("image", DType.IMAGE), imgs)
    batches = math.ceil(N_IMAGES / BATCH)

    def featurizer(cut, compute, **arch):
        fz = ImageFeaturizer(inputCol="image", outputCol="features",
                             cutOutputLayers=cut, miniBatchSize=BATCH,
                             computeDtype=compute)
        return fz.set_model("resnet50", num_classes=1000, seed=0, **arch)

    def reference(compute, **arch):
        """The same backbone and weights, fed by the plain preprocess on
        the card: (pool features, logits) as float32 numpy."""
        spec = build_model("resnet50", num_classes=1000, **arch)
        module = spec["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        module = module.to(card).eval()
        if compute == "bfloat16":
            module = module.to(torch.bfloat16)
        module = module.to(memory_format=torch.channels_last)
        plan = CropResizePlan((SRC, SRC, 3),
                              resize=tuple(spec["input_shape"][:2]))
        pools, logits = [], []
        with torch.inference_mode():
            for i in range(0, N_IMAGES, BATCH):
                x = _crop_resize_normalize_plain(
                    torch.from_numpy(raw[i:i + BATCH]).to(card), plan)
                if compute == "bfloat16":
                    x = x.to(torch.bfloat16)
                lg, inters = module.forward_with_intermediates(x)
                pools.append(inters["pool"].float().cpu().numpy())
                logits.append(lg.float().cpu().numpy())
        return np.concatenate(pools), np.concatenate(logits)

    def rel_err(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    # the main path: counts zeroed just before, read just after
    fz = featurizer(1, "bfloat16")
    kernels.reset_launches()
    t0 = time.perf_counter()
    feats = np.asarray(fz.transform(frame).column("features"))
    first_s = time.perf_counter() - t0
    launches = _launches(kernels)
    _check(feats.shape == (N_IMAGES, 2048), f"features shape {feats.shape}")
    _check(bool(np.isfinite(feats).all()), "features not all finite")
    want = _want(kernels, CROP_RESIZE_NORMALIZE=batches)
    k2_variants = dict(kernels.CROP_RESIZE_NORMALIZE.variant_launches)
    _check(launches == want and k2_variants == {"staged": batches},
           f"kernels launched {launches} times on the featurize path "
           f"(K2's variants {k2_variants}), want {want} (K2's staged "
           "variant once per batch, no other kernel)")

    # timed passes: unroll memo and resident upload are warm, so each is
    # the card's scoring work plus one fetch of the features
    kernels.reset_launches()
    pass_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = np.asarray(fz.transform(frame).column("features"))
        pass_s.append(time.perf_counter() - t0)
    _check(np.array_equal(again, feats), "a repeat pass changed the features")
    _check(kernels.CROP_RESIZE_NORMALIZE.launches == 3 * batches,
           "repeat passes did not launch the kernel once per batch")
    if profile_dir:
        _profile_pass(torch, lambda: fz.transform(frame), profile_dir,
                      "featurize")
    ref_pool, ref_logits = reference("bfloat16")
    # bf16 tolerance: the kernel and the plain preprocess agree to a uint8
    # quantum (in practice bit for bit), and the backbone is the same bf16
    # program on the same card; 2% of the features' scale leaves room for
    # a cuDNN algorithm picked differently between the two runs
    pool_err = rel_err(feats, ref_pool)
    _check(pool_err <= 0.02, f"bf16 features vs plain route: {pool_err}")

    logits = np.asarray(featurizer(0, "bfloat16").transform(frame)
                        .column("features"))
    _check(logits.shape == (N_IMAGES, 1000)
           and bool(np.isfinite(logits).all()), "logits shape/finite")
    logit_err = rel_err(logits, ref_logits)
    _check(logit_err <= 0.02, f"bf16 logits vs plain route: {logit_err}")

    # float32 parity: TF32 off for cuDNN convs and for matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = np.asarray(featurizer(1, "float32", dtype="float32")
                     .transform(frame).column("features"))
    ref32, _ = reference("float32", dtype="float32")
    f32_err = float(np.abs(f32 - ref32).max())
    _check(f32_err <= 1e-3, f"fp32 features vs plain route: {f32_err}")

    best = min(pass_s)
    _line(phase="featurize", card=_smi(), model="resnet50", images=N_IMAGES,
          batch=BATCH, src=[SRC, SRC, 3], dst=[DST, DST], batches=batches,
          launches_main_path=launches, k2_variant_launches=k2_variants,
          k2_out_dtype="bfloat16", first_pass_s=first_s,
          timed_pass_s=pass_s, images_per_s=N_IMAGES / statistics.median(
              pass_s), images_per_s_best=N_IMAGES / best,
          bf16_pool_rel_err=pool_err, bf16_logits_rel_err=logit_err,
          fp32_tf32_off_max_abs_err=f32_err, tf32="off for the fp32 check")
    return launches


def phase_train(torch, kernels, card, profile_dir=None):
    """The train lane through the public entry points (the counts zeroed
    just before, read just after), its sync check, and the loss parity of
    the K1 route against K1's plain version."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.observability.metrics import (
        H100_SXM_BF16_DENSE_FLOPS,
    )
    from mmlspark_tpu_torch.ops.preprocess import (
        _fused_normalize_plain, _inv_std, make_preprocess_fn,
    )
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (TRAIN_ROWS, math.prod(TRAIN_SHAPE)),
                          dtype=np.uint8)
    labels = rng.integers(0, 10, TRAIN_ROWS).astype(np.int32)
    frame = Frame.from_dict({"image": images, "label": labels},
                            num_partitions=8)
    epoch = {"image": frame.column("image").astype(np.uint8),
             "label": frame.column("label").astype(np.int32)}

    def lane(pre, dtype="bfloat16"):
        """ResNet-20 CIFAR at full width (random weights from seed 0),
        sgd(0.1, momentum 0.9), and an endless unshuffled epoch."""
        module = build_model("resnet20_cifar", num_classes=10,
                             dtype=dtype)["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})

        def loss_fn(module, batch, gen):
            logits = module(pre(batch["image"])).float()
            return F.cross_entropy(logits, batch["label"].long())
        trainer = DistributedTrainer(loss_fn, sgd(0.1, momentum=0.9))
        state = trainer.init(lambda: module)
        cache = DeviceEpochCache(epoch, TRAIN_BATCH)

        def batches():
            while True:
                yield from cache.batches(0)
        return trainer, state, batches()

    def plain_pre(out_dtype):
        mean = torch.tensor(CIFAR_MEAN, dtype=torch.float32, device=card)
        istd = torch.from_numpy(_inv_std(CIFAR_STD)).to(card)
        return lambda u8: _fused_normalize_plain(
            u8, mean, istd, out_dtype).reshape((u8.shape[0],) + TRAIN_SHAPE)

    # the main path: counts zeroed just before, read just after
    trainer, state, it = lane(make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN,
                                                 CIFAR_STD))
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, next(it), 1)
    syncs.device_get(m["loss"], "smoke.first_step")
    first_s = time.perf_counter() - t0
    for _ in range(TRAIN_WARMUP - 1):
        state, m = trainer.train_step(state, next(it), 1)
    expected_syncs = TRAIN_STEPS // trainer.flush_steps() + 1

    def window():
        """TRAIN_STEPS steps from a fresh ring read, ending in one fetch of
        the last loss; returns (loss, counted syncs)."""
        nonlocal state
        trainer.flush_metrics()
        sync0 = syncs.total()
        for _ in range(TRAIN_STEPS):
            state, m = trainer.train_step(state, next(it), 1)
        loss = float(syncs.device_get(m["loss"], "smoke.final_fetch"))
        return loss, syncs.total() - sync0

    # the sync check, untimed: any sync outside observability/syncs.py
    # raises a CUDA sync-debug warning
    (_, check_syncs), hidden, n_sync_warnings = _sync_checked(torch, window)
    _check(check_syncs == expected_syncs,
           f"{check_syncs} counted syncs in {TRAIN_STEPS} steps, want "
           f"{expected_syncs} (the ring reads and the final fetch)")
    _check(not hidden, f"uncounted host syncs in the train steps: {hidden}")

    # the timed windows, debug mode off; beside each window's wall time the
    # process's CPU time and the host's load, to tell a host that computes
    # from one that waits
    windows = []
    for _ in range(TRAIN_WINDOWS):
        cpu0, t0 = time.process_time(), time.perf_counter()
        final_loss, timed_syncs = window()
        wall = time.perf_counter() - t0
        _check(timed_syncs == expected_syncs,
               f"{timed_syncs} counted syncs in a timed window, want "
               f"{expected_syncs}")
        windows.append(dict(wall_s=wall, cpu_s=time.process_time() - cpu0,
                            images_per_s=TRAIN_BATCH * TRAIN_STEPS / wall,
                            loadavg_1m=os.getloadavg()[0]))
    eval_loss = float(syncs.device_get(
        trainer.eval_step(state, next(it), 1), "smoke.eval"))
    launches = _launches(kernels)

    steps = TRAIN_WARMUP + TRAIN_STEPS * (1 + TRAIN_WINDOWS)
    want = _want(kernels, FUSED_NORMALIZE=steps + 1)     # + the eval step
    _check(launches == want, f"kernels launched {launches} times on the "
                             f"train path, want {want} (K1 once per train "
                             "and eval step, no other kernel)")
    _check(math.isfinite(final_loss) and math.isfinite(eval_loss)
           and int(syncs.device_get(state["step"], "smoke.step")) == steps,
           "train loss not finite or step counter off")
    # the flight recorder's ring off and on, after the counted path
    def window_rate():
        t0 = time.perf_counter()
        window()
        return TRAIN_BATCH * TRAIN_STEPS / (time.perf_counter() - t0)
    ring = _ring_ab(window_rate)
    rates = [w["images_per_s"] for w in windows]
    images_per_s = statistics.median(rates)
    step_s = TRAIN_BATCH / images_per_s
    flops = trainer.flops_per_step
    tflops = flops / step_s / 1e12
    if profile_dir:
        def five_steps():
            nonlocal state
            for _ in range(5):
                state, _ = trainer.train_step(state, next(it), 1)
            torch.cuda.synchronize()
        _profile_pass(torch, five_steps, profile_dir, "train")

    # loss parity of the K1 route against K1's plain version, with cuDNN
    # deterministic so the two runs differ only in the preprocess
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def losses(pre, n, dtype="bfloat16"):
        tr, st, batches = lane(pre, dtype)
        out = []
        for _ in range(n):
            st, mm = tr.train_step(st, next(batches), 1)
            out.append(mm["loss"])
        return syncs.device_get(torch.stack(out), "smoke.parity")

    k1 = losses(make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN, CIFAR_STD),
                PARITY_STEPS)
    plain = losses(plain_pre(torch.bfloat16), PARITY_STEPS)
    bf16_rel = float(abs(k1[-1] - plain[-1]) / abs(plain[-1]))
    bf16_step = float(np.max(np.abs(k1 - plain) / np.abs(plain)))
    _check(bf16_rel <= 1e-3, f"bf16 {PARITY_STEPS}-step final loss, K1 "
                             f"route vs plain: rel diff {bf16_rel}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_32 = losses(make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN, CIFAR_STD,
                                      out_dtype=torch.float32),
                   PARITY_F32_STEPS, "float32")
    plain_32 = losses(plain_pre(torch.float32), PARITY_F32_STEPS, "float32")
    f32_rel = float(abs(k1_32[-1] - plain_32[-1]) / abs(plain_32[-1]))
    f32_step = float(np.max(np.abs(k1_32 - plain_32) / np.abs(plain_32)))
    _check(f32_rel <= 1e-5, f"fp32 {PARITY_F32_STEPS}-step final loss, K1 "
                            f"route vs plain: rel diff {f32_rel}")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    _check(bool(np.isfinite(k1).all() and np.isfinite(k1_32).all()),
           "parity losses not finite")

    _line(phase="train", card=_smi(), model="resnet20_cifar",
          rows=TRAIN_ROWS, batch=TRAIN_BATCH, compute="bfloat16",
          optimizer="sgd(0.1, momentum=0.9)", warmup_steps=TRAIN_WARMUP,
          steps_per_window=TRAIN_STEPS, windows=windows,
          first_step_s=first_s, step_ms=step_s * 1e3,
          train_images_per_s=images_per_s,
          train_images_per_s_min=min(rates),
          train_images_per_s_max=max(rates),
          spread_max_over_min=max(rates) / min(rates),
          flops_per_step=flops, achieved_tflops=tflops,
          mfu_vs_bf16_dense_peak=tflops * 1e12 / H100_SXM_BF16_DENSE_FLOPS,
          launches_main_path=launches, syncs_per_window=timed_syncs,
          ring_images_per_s=ring,
          expected_syncs=expected_syncs,
          sync_warnings_in_counted_syncs=n_sync_warnings,
          final_loss=final_loss, eval_loss=eval_loss,
          parity_bf16=dict(steps=PARITY_STEPS, final_rel_diff=bf16_rel,
                           max_step_rel_diff=bf16_step, tolerance=1e-3,
                           first_loss=float(k1[0]), last_loss=float(k1[-1])),
          parity_fp32_tf32_off=dict(steps=PARITY_F32_STEPS,
                                    final_rel_diff=f32_rel,
                                    max_step_rel_diff=f32_step,
                                    tolerance=1e-5))
    return launches


def phase_deep(torch, card):
    """DeepClassifier on a tabular frame, scored, then evaluated by
    ComputeModelStatistics on its device path against its host path."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
        ComputeModelStatistics,
    )
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    from mmlspark_tpu_torch.utils import config

    rng = np.random.default_rng(5)
    X = rng.normal(size=(DEEP_ROWS, DEEP_FEATURES)).astype(np.float32)
    y = (X @ rng.normal(size=DEEP_FEATURES) > 0).astype(np.int64)
    frame = Frame.from_dict({"features": X, "label": y}, num_partitions=4)
    learner = DeepClassifier(architecture="mlp_tabular", batchSize=256,
                             epochs=2, deviceCache="on")
    learner.set_params(featuresCol="features", labelCol="label")
    t0 = time.perf_counter()
    model = learner.fit(frame)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scored = model.transform(frame)
    score_s = time.perf_counter() - t0
    pred = scored.column("prediction")
    acc = float((pred.astype(np.int64) == y).mean())
    _check(pred.shape == (DEEP_ROWS,) and acc > 0.9,
           f"DeepClassifier accuracy {acc} on separable data")

    def evaluate(device_rows):
        config.set("evaluate.device_rows", device_rows)
        try:
            ev = ComputeModelStatistics(labelCol="label",
                                        scoredLabelsCol="prediction",
                                        scoresCol="probability")
            row = ev.transform(scored).head(1)[0]
        finally:
            config.unset("evaluate.device_rows")
        return {k: float(v) for k, v in row.items()}, ev.confusion_matrix

    before = syncs.counts().get("evaluate.finalize", 0)
    t0 = time.perf_counter()
    dev, cm_dev = evaluate(0)
    eval_s = time.perf_counter() - t0
    finalize = syncs.counts().get("evaluate.finalize", 0) - before
    host, cm_host = evaluate(10 ** 12)
    _check(finalize == 1, f"evaluate.finalize counted {finalize} times")
    _check(np.array_equal(cm_dev, cm_host) and cm_dev.sum() == DEEP_ROWS,
           f"confusion matrices differ: {cm_dev} vs {cm_host}")
    for name in ("accuracy", "precision", "recall"):
        _check(dev[name] == host[name],
               f"{name}: device {dev[name]} vs host {host[name]}")
    # AUC and areaUnderPR: float32 sums on the card against float64 numpy
    for name in ("AUC", "AUC_PR"):
        _check(abs(dev[name] - host[name]) <= 1e-5,
               f"{name}: device {dev[name]} vs host {host[name]}")

    # lamb and adafactor: a short fp32 fit on the card and on the CPU from
    # the same init and batch order (the resident epoch's permutation comes
    # from a host generator), TF32 off
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = Frame.from_dict({"features": X[:DEEP_OPT_ROWS],
                             "label": y[:DEEP_OPT_ROWS]}, num_partitions=4)
    optimizers = {}
    for opt in ("lamb", "adafactor"):
        fits = {}
        for device in ("cuda", "cpu"):
            config.set("runtime.device", device)
            try:
                fitter = DeepClassifier(
                    architecture="mlp_tabular", batchSize=256, epochs=1,
                    optimizer=opt, trainDtype="float32", deviceCache="on")
                fitter.set_params(featuresCol="features", labelCol="label")
                t0 = time.perf_counter()
                fits[device] = (fitter.fit(small), time.perf_counter() - t0)
            finally:
                config.unset("runtime.device")
        got, want = (fits[d][0]._state["params"] for d in ("cuda", "cpu"))
        rel = {k: float(np.linalg.norm(got[k] - want[k])
                        / max(np.linalg.norm(want[k]), 1e-30)) for k in want}
        pred = fits["cuda"][0].transform(small).column("prediction")
        opt_acc = float((pred.astype(np.int64) == y[:DEEP_OPT_ROWS]).mean())
        _check(max(rel.values()) <= DEEP_OPT_TOL,
               f"DeepClassifier(optimizer={opt!r}) card vs CPU parameters: "
               f"{rel} (norm-wise, tolerance {DEEP_OPT_TOL})")
        optimizers[opt] = dict(rows=DEEP_OPT_ROWS, epochs=1,
                               card_fit_s=fits["cuda"][1],
                               cpu_fit_s=fits["cpu"][1], accuracy=opt_acc,
                               max_param_rel_diff=max(rel.values()),
                               tolerance=DEEP_OPT_TOL)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    _line(phase="deep", card=_smi(), rows=DEEP_ROWS, features=DEEP_FEATURES,
          architecture="mlp_tabular", batch=256, epochs=2,
          fit_s=fit_s, score_s=score_s, eval_device_s=eval_s,
          accuracy=acc, device_metrics=dev, host_metrics=host,
          confusion_matrix=cm_dev.tolist(), evaluate_finalize_syncs=finalize,
          optimizers_fp32_tf32_off=optimizers)


def _lm_reference(torch, card, name, state, ids, batch, **arch):
    """``hidden`` of the same module and weights with the reference
    attention (``full_attention(use_flash="never")``), scored batch by batch
    on the card: float32 numpy."""
    from functools import partial

    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.parallel.sequence import full_attention
    module = build_model(name, attention_fn=partial(
        full_attention, use_flash="never"), **arch)["module"]
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in state.items()})
    module = module.to(card).eval()
    out = []
    with torch.inference_mode():
        for i in range(0, len(ids), batch):
            x = torch.from_numpy(ids[i:i + batch]).to(card)
            _, inters = module.forward_with_intermediates(
                x, layers=("hidden",))
            out.append(inters["hidden"].float().cpu().numpy())
    return np.concatenate(out)


def _lm_scorer(name, node, batch, **arch):
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    tm = TorchModel(inputCol="ids", outputCol="h", outputNodeName=node,
                    miniBatchSize=batch, deviceCache="on")
    return tm.set_model(name, seed=0, **arch)


def _diff_stats(got, want):
    """|got - want| over (rows, L, dim): max, mean, and the share of tokens
    whose largest difference exceeds 5e-2 and MOE_MOVED."""
    d = np.abs(got - want)
    token = d.max(axis=-1)
    return dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                share_tokens_over_5e_2=float((token > 5e-2).mean()),
                share_tokens_moved=float((token > MOE_MOVED).mean()))


def phase_lm_score(torch, kernels, card, profile_dir=None):
    """The attention path through the public entry point: TorchModel scores
    token ids through transformer_lm for ``hidden`` (the counts zeroed just
    before, read just after), its tokens/s over 3 warm passes, and its
    agreement with the reference-attention route in bf16 and fp32."""
    from mmlspark_tpu_torch.core.frame import Frame
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 products in fp32
    ids = np.random.default_rng(0).integers(
        0, LM_VOCAB, (LM_ROWS, LM_LEN)).astype(np.int32)
    frame = Frame.from_dict({"ids": ids})
    batches = math.ceil(LM_ROWS / LM_BATCH)

    def want_launches(n, kernel="FLASH_ATTENTION_TC"):
        """n launches of one K3 route (bf16: the tensor cores), none of any
        other kernel"""
        return _want(kernels, **{kernel: n})

    # the main path: counts zeroed just before, read just after
    tm = _lm_scorer("transformer_lm", "hidden", LM_BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    hidden = np.asarray(tm.transform(frame).column("h"))
    first_s = time.perf_counter() - t0
    launches = _launches(kernels)
    _check(launches == want_launches(LM_DEPTH * batches),
           f"kernels launched {launches} times on the lm_score path, want "
           f"K3's tensor-core kernel {LM_DEPTH} layers x {batches} batches "
           "and no other kernel")
    _check(hidden.shape == (LM_ROWS, LM_LEN, 512)
           and bool(np.isfinite(hidden).all()),
           f"hidden {hidden.shape} not finite or of the wrong shape")

    pass_s, repeat_diff = [], 0.0
    for _ in range(3):
        kernels.reset_launches()
        t0 = time.perf_counter()
        again = np.asarray(tm.transform(frame).column("h"))
        pass_s.append(time.perf_counter() - t0)
        _check(_launches(kernels)
               == want_launches(LM_DEPTH * batches),
               "a warm pass did not launch K3's tensor-core kernel once per "
               "layer and batch")
        repeat_diff = max(repeat_diff, float(np.abs(again - hidden).max()))
    _check(repeat_diff <= 1e-5, f"a repeat pass moved hidden by {repeat_diff}")
    if profile_dir:
        _profile_pass(torch, lambda: tm.transform(frame), profile_dir,
                      "lm_score")
    tokens_s = [LM_ROWS * LM_LEN / s for s in pass_s]

    ref = _lm_reference(torch, card, "transformer_lm", tm._state["params"],
                        ids, LM_BATCH)
    bf16 = _diff_stats(hidden, ref)
    _check(bf16["max_abs"] <= LM_BF16_MAX and bf16["mean_abs"] <= LM_BF16_MEAN,
           f"bf16 hidden vs the reference-attention route: {bf16}")

    # fp32 (dtype=float32, TF32 off): both routes compute in fp32, K3 on
    # its CUDA-core kernel
    ids32 = ids[:LM_F32_ROWS]
    tm32 = _lm_scorer("transformer_lm", "hidden", LM_BATCH, dtype="float32")
    frame32 = Frame.from_dict({"ids": ids32})
    want32 = want_launches(LM_DEPTH * LM_F32_ROWS // LM_BATCH,
                           "FLASH_ATTENTION")
    kernels.reset_launches()
    h32 = np.asarray(tm32.transform(frame32).column("h"))
    launches32 = _launches(kernels)
    _check(launches32 == want32,
           f"fp32 pass: kernels launched {launches32} times, want K3's "
           "CUDA-core kernel once per layer and batch and no other kernel")
    # one warm fp32 pass, timed
    kernels.reset_launches()
    t0 = time.perf_counter()
    again32 = np.asarray(tm32.transform(frame32).column("h"))
    pass32_s = time.perf_counter() - t0
    _check(_launches(kernels) == want32
           and float(np.abs(again32 - h32).max()) <= 1e-5,
           "the warm fp32 pass launched other kernels or moved hidden")
    ref32 = _lm_reference(torch, card, "transformer_lm", tm32._state["params"],
                          ids32, LM_BATCH, dtype="float32")
    f32 = _diff_stats(h32, ref32)
    _check(f32["max_abs"] <= LM_F32_MAX,
           f"fp32 hidden vs the reference-attention route: {f32}")

    # the default output (logits) on 2 rows: the tied fp32 head of the same
    # hidden
    lg_tm = _lm_scorer("transformer_lm", "", 2)
    logits = np.asarray(lg_tm.transform(Frame.from_dict({"ids": ids[:2]}))
                        .column("h"))
    table = torch.from_numpy(np.asarray(
        tm._state["params"]["token_embedding.embedding"])).to(card)
    with torch.inference_mode():
        want_lg = torch.einsum("bld,vd->blv", torch.from_numpy(
            hidden[:2]).to(card), table).cpu().numpy()
    lg_err = float(np.abs(logits - want_lg).max() / np.abs(want_lg).max())
    _check(logits.shape == (2, LM_LEN, LM_VOCAB)
           and bool(np.isfinite(logits).all()) and lg_err <= 1e-5,
           f"logits {logits.shape}: rel err {lg_err} against the head of "
           "the scored hidden")

    _line(phase="lm_score", card=_smi(), model="transformer_lm",
          rows=LM_ROWS, length=LM_LEN, batch=LM_BATCH, compute="bfloat16",
          launches_main_path=launches, k3_launches_per_pass=LM_DEPTH * batches,
          launches_fp32_pass=launches32,
          first_pass_s=first_s, timed_pass_s=pass_s,
          tokens_per_s=statistics.median(tokens_s),
          tokens_per_s_min=min(tokens_s), tokens_per_s_max=max(tokens_s),
          repeat_max_abs_diff=repeat_diff, bf16_vs_reference=bf16,
          bf16_limits=dict(max_abs=LM_BF16_MAX, mean_abs=LM_BF16_MEAN),
          fp32_rows=LM_F32_ROWS, fp32_vs_reference=f32,
          fp32_limit=LM_F32_MAX, fp32_warm_pass_s=pass32_s,
          fp32_tokens_per_s=LM_F32_ROWS * LM_LEN / pass32_s,
          logits_rel_err=lg_err, tf32="off")
    return launches, launches32


def phase_moe_score(torch, kernels, card):
    """transformer_lm_moe at the zoo's defaults over 16 rows at batch 8,
    untimed: K3 once per layer and batch, ``hidden`` against the
    reference-attention route."""
    from mmlspark_tpu_torch.core.frame import Frame
    ids = np.random.default_rng(0).integers(
        0, LM_VOCAB, (MOE_ROWS, LM_LEN)).astype(np.int32)
    tm = _lm_scorer("transformer_lm_moe", "hidden", LM_BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    hidden = np.asarray(tm.transform(Frame.from_dict({"ids": ids}))
                        .column("h"))
    pass_s = time.perf_counter() - t0
    launches = _launches(kernels)
    want = _want(kernels, FLASH_ATTENTION_TC=LM_DEPTH * MOE_ROWS // LM_BATCH)
    _check(launches == want, f"kernels launched {launches} times on the "
                             f"moe_score path, want {want}")
    _check(hidden.shape == (MOE_ROWS, LM_LEN, 512)
           and bool(np.isfinite(hidden).all()), "MoE hidden shape/finite")
    ref = _lm_reference(torch, card, "transformer_lm_moe", tm._state["params"],
                        ids, LM_BATCH)
    stats = _diff_stats(hidden, ref)
    _check(stats["mean_abs"] <= MOE_MEAN
           and stats["share_tokens_moved"] <= MOE_SHARE_MOVED,
           f"MoE bf16 hidden vs the reference-attention route: {stats}")
    _line(phase="moe_score", card=_smi(), model="transformer_lm_moe",
          rows=MOE_ROWS, length=LM_LEN, batch=LM_BATCH,
          launches_main_path=launches, pass_s=pass_s,
          tokens_per_s_untimed_pass=MOE_ROWS * LM_LEN / pass_s,
          bf16_vs_reference=stats,
          limits=dict(mean_abs=MOE_MEAN, moved_over=MOE_MOVED,
                      share_tokens_moved=MOE_SHARE_MOVED))


def phase_featurize_vit(torch, kernels, card):
    """ViT-B/16 features of 128 uint8 images, untimed: ImageFeaturizer
    (K2 resizes 256 -> 224) and TorchModel with a center crop to 224 on the
    card (K2), each against the plain-preprocess route."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.ops.preprocess import (
        CropResizePlan, _crop_resize_normalize_plain,
    )

    raw = np.random.default_rng(7).integers(
        0, 256, size=(VIT_IMAGES, SRC, SRC, 3), dtype=np.uint8)
    imgs = np.empty(VIT_IMAGES, dtype=object)
    for i in range(VIT_IMAGES):
        imgs[i] = ImageValue(path=f"mem://vit/{i}", data=raw[i])
    frame = Frame.from_dict({"row": np.arange(VIT_IMAGES)}).with_column_values(
        ColumnSchema("image", DType.IMAGE), imgs)
    flat = Frame.from_dict({"u8": raw.reshape(VIT_IMAGES, -1)})
    batches = math.ceil(VIT_IMAGES / VIT_BATCH)
    norm = dict(input_mean=(127.5,) * 3, input_std=(127.5,) * 3)

    def route(run):
        kernels.reset_launches()
        t0 = time.perf_counter()
        feats = np.asarray(run())
        seconds = time.perf_counter() - t0
        launches = _launches(kernels)
        want = _want(kernels, CROP_RESIZE_NORMALIZE=batches)
        _check(launches == want, f"featurize_vit: kernels launched "
                                 f"{launches} times, want {want}")
        _check(feats.shape == (VIT_IMAGES, 768)
               and bool(np.isfinite(feats).all()), "ViT features")
        return feats, seconds, launches

    fz = ImageFeaturizer(inputCol="image", outputCol="f", cutOutputLayers=1,
                         miniBatchSize=VIT_BATCH)
    fz.set_model("vit_b16", seed=0, **norm)
    resized, resize_s, launches = route(
        lambda: fz.transform(frame).column("f"))
    tm = TorchModel(inputCol="u8", outputCol="f", outputNodeName="pool",
                    miniBatchSize=VIT_BATCH, devicePreprocess={
                        "srcShape": [SRC, SRC, 3], "crop": [DST, DST]})
    tm.set_model("vit_b16", params=fz._state["params"], **norm)
    cropped, crop_s, _ = route(lambda: tm.transform(flat).column("f"))

    module = build_model("vit_b16")["module"]
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in fz._state["params"].items()})
    module = module.to(card).eval()

    def plain(resize, crop):
        plan = CropResizePlan((SRC, SRC, 3), resize=resize, crop=crop,
                              mean=(127.5,) * 3, std=(127.5,) * 3)
        out = []
        with torch.inference_mode():
            for i in range(0, VIT_IMAGES, VIT_BATCH):
                x = _crop_resize_normalize_plain(
                    torch.from_numpy(raw[i:i + VIT_BATCH]).to(card), plan)
                out.append(module.forward_features(x).float().cpu().numpy())
        return np.concatenate(out)

    errs = {}
    for name, got, want in (("resize", resized, plain((DST, DST), None)),
                            ("crop", cropped, plain(None, (DST, DST)))):
        errs[name] = float(np.abs(got - want).max() / np.abs(want).max())
        # the featurize phase's bf16 limit: 2% of the features' scale
        _check(errs[name] <= 0.02, f"ViT {name} features vs the plain-"
                                   f"preprocess route: rel err {errs[name]}")
    _line(phase="featurize_vit", card=_smi(), model="vit_b16",
          images=VIT_IMAGES, batch=VIT_BATCH, src=[SRC, SRC, 3],
          dst=[DST, DST], launches_main_path=launches,
          rel_err_vs_plain_preprocess=errs, limit=0.02,
          images_per_s_untimed=dict(resize=VIT_IMAGES / resize_s,
                                    crop=VIT_IMAGES / crop_s))


# UCI Adult's string columns and their levels (archive.ics.uci.edu/dataset/2/
# adult; "?" is UCI's missing marker, a level of its own), most common first
ADULT_LEVELS = {
    "workclass": ["Private", "Self-emp-not-inc", "Local-gov", "?",
                  "State-gov", "Self-emp-inc", "Federal-gov", "Without-pay",
                  "Never-worked"],
    "education": ["HS-grad", "Some-college", "Bachelors", "Masters",
                  "Assoc-voc", "11th", "Assoc-acdm", "10th", "7th-8th",
                  "Prof-school", "9th", "12th", "Doctorate", "5th-6th",
                  "1st-4th", "Preschool"],
    "marital-status": ["Married-civ-spouse", "Never-married", "Divorced",
                       "Separated", "Widowed", "Married-spouse-absent",
                       "Married-AF-spouse"],
    "occupation": ["Prof-specialty", "Craft-repair", "Exec-managerial",
                   "Adm-clerical", "Sales", "Other-service",
                   "Machine-op-inspct", "?", "Transport-moving",
                   "Handlers-cleaners", "Farming-fishing", "Tech-support",
                   "Protective-serv", "Priv-house-serv", "Armed-Forces"],
    "relationship": ["Husband", "Not-in-family", "Own-child", "Unmarried",
                     "Wife", "Other-relative"],
    "race": ["White", "Black", "Asian-Pac-Islander", "Amer-Indian-Eskimo",
             "Other"],
    "sex": ["Male", "Female"],
    "native-country": [
        "United-States", "Mexico", "?", "Philippines", "Germany", "Canada",
        "Puerto-Rico", "El-Salvador", "India", "Cuba", "England", "Jamaica",
        "South", "China", "Italy", "Dominican-Republic", "Vietnam",
        "Guatemala", "Japan", "Poland", "Columbia", "Taiwan", "Haiti", "Iran",
        "Portugal", "Nicaragua", "Peru", "France", "Greece", "Ecuador",
        "Ireland", "Hong", "Cambodia", "Trinadad&Tobago", "Laos", "Thailand",
        "Yugoslavia", "Outlying-US(Guam-USVI-etc)", "Honduras", "Hungary",
        "Scotland", "Holand-Netherlands"],
}
# UCI's education-num of each education level
ADULT_EDUCATION_NUM = {
    "Preschool": 1, "1st-4th": 2, "5th-6th": 3, "7th-8th": 4, "9th": 5,
    "10th": 6, "11th": 7, "12th": 8, "HS-grad": 9, "Some-college": 10,
    "Assoc-voc": 11, "Assoc-acdm": 12, "Bachelors": 13, "Masters": 14,
    "Prof-school": 15, "Doctorate": 16}
ADULT_POSITIVE = 0.24       # UCI Adult's share of " >50K"


def adult_frame(n: int, rng, num_partitions: int = 4):
    """An Adult-census-shaped Frame of ``n`` rows drawn from ``rng``: UCI
    Adult's six numeric columns, its eight string columns at UCI's
    cardinalities (levels drawn with Zipf-like weights, most common first)
    and the ``income`` label (" >50K" for the top 24% of a noisy linear
    score of the columns, else " <=50K")."""
    from mmlspark_tpu_torch.core.frame import Frame
    cols = {}
    for name, levels in ADULT_LEVELS.items():
        p = 1.0 / np.arange(1, len(levels) + 1) ** 1.5
        cols[name] = np.asarray(levels, object)[
            rng.choice(len(levels), size=n, p=p / p.sum())]
    age = np.clip(rng.normal(38.6, 13.6, n), 17, 90).round()
    fnlwgt = np.clip(rng.lognormal(12.0, 0.5, n), 1.2e4, 1.5e6).round()
    edu_num = np.asarray([ADULT_EDUCATION_NUM[e] for e in cols["education"]],
                         np.float64)
    gain = np.where(rng.random(n) < 0.08,
                    rng.lognormal(8.5, 1.0, n).clip(0, 99999), 0).round()
    loss = np.where(rng.random(n) < 0.05, rng.normal(1870, 360, n), 0
                    ).clip(0, 4356).round()
    hours = np.clip(rng.normal(40.4, 12.3, n), 1, 99).round()
    married = np.isin(cols["marital-status"],
                      ["Married-civ-spouse", "Married-AF-spouse"])
    skilled = np.isin(cols["occupation"], ["Exec-managerial",
                                           "Prof-specialty", "Tech-support"])
    score = (0.04 * (age - 38.6) + 0.35 * (edu_num - 10) + 1.6 * married
             + 0.9 * skilled + 0.4 * (cols["sex"] == "Male")
             + 2.5 * (gain > 5000) + 0.8 * (loss > 1500)
             + 0.03 * (hours - 40) + rng.normal(0, 1.0, n))
    positive = score > np.quantile(score, 1 - ADULT_POSITIVE)
    data = {"age": age, "workclass": cols["workclass"], "fnlwgt": fnlwgt,
            "education": cols["education"], "education-num": edu_num,
            "marital-status": cols["marital-status"],
            "occupation": cols["occupation"],
            "relationship": cols["relationship"], "race": cols["race"],
            "sex": cols["sex"], "capital-gain": gain, "capital-loss": loss,
            "hours-per-week": hours,
            "native-country": cols["native-country"],
            "income": np.where(positive, " >50K", " <=50K").astype(object)}
    return Frame.from_dict({k: list(v) if v.dtype == object else v
                            for k, v in data.items()},
                           num_partitions=num_partitions)


def flight_frame(n: int, rng, num_partitions: int = 4):
    """A flight-delay-shaped Frame (example 102's columns: Carrier, Origin,
    DepHour, Distance and the numeric ArrDelay label)."""
    from mmlspark_tpu_torch.core.frame import Frame
    carrier = rng.choice(["AA", "DL", "UA", "WN"], n)
    origin = rng.choice(["SEA", "SFO", "JFK", "ORD"], n)
    dep_hour = rng.integers(5, 23, n).astype(np.float64)
    distance = rng.uniform(100, 2800, n)
    bias = np.select([carrier == "AA", carrier == "DL", carrier == "UA"],
                     [4.0, -2.0, 6.0], 0.0)
    delay = bias + 0.9 * dep_hour + distance * 0.004 + rng.normal(0, 1.5, n)
    return Frame.from_dict(
        {"Carrier": carrier.tolist(), "Origin": origin.tolist(),
         "DepHour": dep_hour, "Distance": distance, "ArrDelay": delay},
        num_partitions=num_partitions)


def automl_learners():
    """The README quickstart's learner and the golden harness's
    constructors (``tests/test_golden_metrics.py``), by name."""
    from mmlspark_tpu_torch.train.learners import (
        LogisticRegression, MLPClassifier, NaiveBayes,
    )
    from mmlspark_tpu_torch.train.trees import (
        DecisionTreeClassifier, GBTClassifier, RandomForestClassifier,
    )
    return {
        "LogisticRegression": lambda: LogisticRegression(regParam=0.01),
        "DecisionTreeClassifier": lambda: DecisionTreeClassifier(maxDepth=5),
        "RandomForestClassifier": lambda: RandomForestClassifier(
            numTrees=16, maxDepth=5, seed=7),
        "GBTClassifier": lambda: GBTClassifier(maxIter=20, maxDepth=3),
        "NaiveBayes": lambda: NaiveBayes(),
        "MLPClassifier": lambda: MLPClassifier(maxIter=200, layers=[16],
                                               seed=3),
    }


def _max_rel(got, want) -> float:
    """max |got - want| over max |want|: the norm-wise relative difference
    of two parameter arrays."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def phase_automl(torch, kernels, card):
    """The README's first quickstart at UCI Adult's size: TrainClassifier
    with each of the six learner families fit and scored on the card and on
    the CPU, FindBestModel over the six, ComputeModelStatistics of the
    best, and TrainRegressor(LinearRegression()) on a flight-delay frame."""
    from mmlspark_tpu_torch.evaluate.compute_model_statistics import (
        ComputeModelStatistics,
    )
    from mmlspark_tpu_torch.evaluate.find_best_model import FindBestModel
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.train.learners import LinearRegression
    from mmlspark_tpu_torch.train.train_classifier import (
        TrainClassifier, TrainRegressor,
    )
    from mmlspark_tpu_torch.utils import config

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    train = adult_frame(AUTOML_TRAIN_ROWS, rng)
    test = adult_frame(AUTOML_TEST_ROWS, rng)
    kernels.reset_launches()

    def on_device(device, fn):
        config.set("runtime.device", device)
        try:
            return fn()
        finally:
            config.unset("runtime.device")

    def fit(ctor, frame=train, label="income", cls=TrainClassifier):
        before = syncs.total()
        t0 = time.perf_counter()
        model = cls(model=ctor(), labelCol=label).fit(frame)
        return model, time.perf_counter() - t0, syncs.total() - before

    def metrics(model, frame=test):
        row = ComputeModelStatistics().transform(
            model.transform(frame)).head(1)[0]
        return {k: float(v) for k, v in row.items()
                if k in ("AUC", "accuracy", "r2", "rmse")}

    def check_on_card(model, name):
        on = model.get("learnerModel").fit_device
        _check(torch.device(on).type == card.type,
               f"{name}: the fit ran on {on}, not on {card}")

    results, card_models, cpu_models = {}, [], []
    widths = {}
    for name, ctor in automl_learners().items():
        model, first_s, fit_syncs = fit(ctor)
        check_on_card(model, name)
        again, warm_s, _ = fit(ctor)
        check_on_card(again, name)
        learner, learner2 = (model.get("learnerModel"),
                             again.get("learnerModel"))
        if "feats" in learner._state:
            # (c) deterministic histograms: two card fits, one forest
            for key in ("feats", "thrs"):
                _check(np.array_equal(learner._state[key],
                                      learner2._state[key]),
                       f"{name}: two card fits differ in {key}")
        score_s = []
        for _ in range(AUTOML_SCORE_PASSES):
            t0 = time.perf_counter()
            model.transform(test)
            score_s.append(time.perf_counter() - t0)
        split = _split_times(model, ctor, train, test)
        got = metrics(model)
        cpu = on_device("cpu", lambda: fit(ctor)[0])
        want = on_device("cpu", lambda: metrics(cpu))
        # (a) the card's fit scores as the CPU's, within the golden TOL
        for k in ("AUC", "accuracy"):
            _check(abs(got[k] - want[k]) <= AUTOML_TOL,
                   f"{name}: card {k} {got[k]} vs CPU {want[k]}")
        # (b) fp32 parameters of the closed-form and convex fits
        rel = None
        if name in ("LogisticRegression", "NaiveBayes"):
            keys = ("w", "b") if name == "LogisticRegression" \
                else ("log_prior", "log_cond")
            rel = {k: _max_rel(learner._state[k],
                               cpu.get("learnerModel")._state[k])
                   for k in keys}
            _check(max(rel.values()) <= AUTOML_PARAM_RTOL,
                   f"{name}: card parameters differ from the CPU fit's by "
                   f"{rel} (norm-wise relative)")
        if name in ("LogisticRegression", "DecisionTreeClassifier"):
            widths["one_hot" if name == "LogisticRegression" else "trees"] = \
                int(np.asarray(model.get("featurizeModel").transform(
                    test).head(1)[0][model._state["features_col"]]).size)
        card_models.append(model)
        cpu_models.append(cpu)
        results[name] = dict(
            fit_s_first=first_s, fit_s_warm=warm_s,
            score_rows_per_s=AUTOML_TEST_ROWS / statistics.median(score_s),
            syncs_per_fit=fit_syncs, **split, AUC=got["AUC"],
            accuracy=got["accuracy"], cpu_AUC=want["AUC"],
            cpu_accuracy=want["accuracy"], param_rel_diff=rel)

    # (d) model selection on the test rows, on the card and on the CPU
    t0 = time.perf_counter()
    best = FindBestModel(models=card_models,
                         evaluationMetric="AUC").fit(test)
    select_s = time.perf_counter() - t0
    best_cpu = on_device("cpu", lambda: FindBestModel(
        models=cpu_models, evaluationMetric="AUC").fit(test))
    names = list(results)
    pick = names[card_models.index(best.get("bestModel"))]
    pick_cpu = names[cpu_models.index(best_cpu.get("bestModel"))]
    _check(pick == pick_cpu or abs(results[pick]["cpu_AUC"]
                                   - results[pick_cpu]["cpu_AUC"])
           <= AUTOML_TOL,
           f"FindBestModel picked {pick} on the card, {pick_cpu} on the CPU")
    best_stats = {k: float(v) for k, v in ComputeModelStatistics().transform(
        best.scored_dataset).head(1)[0].items()}
    _check(abs(best_stats["AUC"] - results[pick]["AUC"]) <= 1e-9,
           "the best model's statistics differ from its own scoring")

    # TrainRegressor(LinearRegression()) on a flight-delay frame: the
    # normal equations accumulated and solved on the card
    flights = flight_frame(AUTOML_TRAIN_ROWS, np.random.default_rng(1))
    reg, reg_first_s, reg_syncs = fit(LinearRegression, flights, "ArrDelay",
                                      TrainRegressor)
    check_on_card(reg, "LinearRegression")
    reg_cpu = on_device("cpu", lambda: fit(LinearRegression, flights,
                                           "ArrDelay", TrainRegressor)[0])
    # (b) for LinearRegression: the weights the frame identifies (the
    # numeric columns') and the fitted function; the one-hot blocks and the
    # intercept are collinear, so their own weights are fixed only by the
    # 1e-6 ridge and rounding moves them freely (cond printed below)
    featurized = reg.get("featurizeModel").transform(flights)
    X = np.asarray(featurized.column(reg._state["features_col"]), np.float64)
    Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    gram_cond = float(np.linalg.cond(Xb.T @ Xb + 1e-6 * np.eye(Xb.shape[1])))
    sw, cw = (m.get("learnerModel")._state for m in (reg, reg_cpu))
    slots = featurized.schema[reg._state["features_col"]].metadata
    numeric = [i for i, n in enumerate(_slot_names(slots))
               if n in ("DepHour", "Distance")]
    pred = Xb @ np.append(sw["w"], sw["b"])
    pred_cpu = Xb @ np.append(cw["w"], cw["b"])
    reg_rel = {"numeric_w": _max_rel(sw["w"][numeric], cw["w"][numeric]),
               "prediction": _max_rel(pred, pred_cpu),
               "all_w_b": _max_rel(np.append(sw["w"], sw["b"]),
                                   np.append(cw["w"], cw["b"]))}
    _check(len(numeric) == 2 and reg_rel["numeric_w"] <= AUTOML_PARAM_RTOL
           and reg_rel["prediction"] <= AUTOML_PARAM_RTOL,
           f"LinearRegression: card vs CPU {reg_rel}")
    reg_stats = metrics(reg, flights)

    # (f) this path runs no TPU kernel's counterpart
    launched = _launches(kernels)
    _check(not any(launched.values()), f"kernels launched: {launched}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    _line(phase="automl", card=_smi(),
          source="UCI Adult, archive.ics.uci.edu/dataset/2/adult (shape, "
                 "synthesized from np.random.default_rng(0))",
          train_rows=AUTOML_TRAIN_ROWS, test_rows=AUTOML_TEST_ROWS,
          feature_width=widths, learners=results, best=pick,
          best_cpu=pick_cpu, best_statistics=best_stats,
          find_best_model_s=select_s, kernel_launches=launched,
          regressor=dict(learner="LinearRegression", rows=AUTOML_TRAIN_ROWS,
                         fit_s=reg_first_s, syncs_per_fit=reg_syncs,
                         card_vs_cpu=reg_rel, gram_condition=gram_cond,
                         **reg_stats))
    return results


def _split_times(model, ctor, train, test) -> dict:
    """Where a TrainClassifier fit and a scoring pass spend their time:
    featurizing the rows on the host (``featurize_s``, a transform of the
    fitted Featurize model) against the learner's own fit on the featurized
    frame (``learner_fit_s``, warm) and the learner model's scoring of the
    featurized test rows (``learner_score_rows_per_s``, median of
    ``AUTOML_SCORE_PASSES``)."""
    from mmlspark_tpu_torch.feature.value_indexer import ValueIndexer
    fitted = model.get("learnerModel")
    label = fitted.labelCol
    indexed = ValueIndexer(inputCol="income", outputCol=label).fit(
        train).transform(train)
    featurizer = model.get("featurizeModel")
    t0 = time.perf_counter()
    processed = featurizer.transform(indexed)
    featurize_s = time.perf_counter() - t0
    learner = ctor()
    learner.set_params(featuresCol=fitted.featuresCol, labelCol=label)
    t0 = time.perf_counter()
    learner.fit(processed)
    learner_fit_s = time.perf_counter() - t0
    featurized_test = featurizer.transform(test)
    score_s = []
    for _ in range(AUTOML_SCORE_PASSES):
        t0 = time.perf_counter()
        fitted.transform(featurized_test)
        score_s.append(time.perf_counter() - t0)
    return dict(featurize_s=featurize_s, learner_fit_s=learner_fit_s,
                learner_score_rows_per_s=len(featurized_test)
                / statistics.median(score_s))


def _slot_names(metadata) -> list:
    """The source column(s) of each slot of an assembled features column,
    from Featurize's ``feature_layout`` metadata."""
    names = []
    for name, start, stop, _ in metadata.get("feature_layout", []):
        names += [name] * (int(stop) - int(start))
    return names


def _make_reviews(n: int, seed: int = 3):
    """Amazon-review-shaped texts (the JAX bench's ``_make_reviews``): 40-120
    tokens from a 20k vocabulary, and binary labels."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"word{i}" for i in range(20000)])
    texts = [" ".join(rng.choice(vocab, rng.integers(40, 120)))
             for _ in range(n)]
    labels = rng.integers(0, 2, n).astype(np.int32)
    return texts, labels


def _tokenize_hash(texts) -> np.ndarray:
    """TextFeaturizer's hot path (the JAX bench's ``_tokenize_hash``):
    regex tokenize + Spark-parity murmur3 -> fixed-length id rows (0 =
    pad), through the port's ``ops/hashing.hash_terms``."""
    import re
    from mmlspark_tpu_torch.ops.hashing import hash_terms
    tok = re.compile(r"\w+")
    rows = [tok.findall(t.lower()) for t in texts]
    flat = [w for r in rows for w in r]
    ids = hash_terms(flat, TEXT_VOCAB - 1).astype(np.int32) + 1
    out = np.zeros((len(rows), TEXT_SEQ), np.int32)
    off = 0
    for i, r in enumerate(rows):
        k = min(len(r), TEXT_SEQ)
        out[i, :k] = ids[off:off + k]
        off += len(r)
    return out


def phase_text(torch, kernels, card, profile_dir=None):
    """The JAX bench's text lane on the card: tokenize and hash 10,240
    reviews, train textcnn 6 epochs from a resident epoch (timed end to
    end, the counts zeroed just before, read just after), its sync check,
    20 fp32 steps against the CPU; then Word2Vec on the same reviews and
    on the synonym corpus."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.feature import word2vec as tw2v
    from mmlspark_tpu_torch.feature.text import RegexTokenizer
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.parallel.optim import adam
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )

    n = TEXT_STEPS * TEXT_BATCH
    texts, labels = _make_reviews(n)
    params = {}

    def lane(dtype="bfloat16", device=card):
        """textcnn at its defaults (embed 128, widths 3/4/5, 128 filters),
        random weights from seed 0, adam(1e-3)."""
        module = build_model("textcnn", vocab_size=TEXT_VOCAB, num_classes=2,
                             seq_len=TEXT_SEQ, dtype=dtype)["module"]
        if not params:
            params.update(init_state(module, seed=0))
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in params.items()})

        def loss_fn(module, batch, gen):
            logits = module(batch["ids"]).float()
            return F.cross_entropy(logits, batch["label"].long())
        trainer = DistributedTrainer(loss_fn, adam(1e-3), device=device)
        return trainer, trainer.init(lambda: module)

    trainer, state = lane()
    warm = trainer.put_batch({"ids": _tokenize_hash(texts[:TEXT_BATCH]),
                              "label": labels[:TEXT_BATCH]})
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, warm, 1)
    syncs.device_get(m["loss"], "smoke.first_step")
    first_s = time.perf_counter() - t0
    state, m = trainer.train_step(state, warm, 1)
    syncs.device_get(m["loss"], "smoke.warm")

    def run():
        """The bench's timed region: tokenize + hash, one upload into a
        DeviceEpochCache, 6 epochs of steps, one fetch of the last loss."""
        nonlocal state
        trainer.flush_metrics()
        sync0 = syncs.total()
        cache = DeviceEpochCache({"ids": _tokenize_hash(texts),
                                  "label": labels}, TEXT_BATCH, device=card)
        for epoch in range(TEXT_EPOCHS):
            for batch in cache.batches(epoch):
                state, metrics = trainer.train_step(state, batch, 1)
        loss = float(syncs.device_get(metrics["loss"], "smoke.final_fetch"))
        return loss, syncs.total() - sync0

    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    walls, cpus, region_syncs = [], [], []
    for _ in range(TEXT_RUNS):
        cpu0, t0 = time.process_time(), time.perf_counter()
        final_loss, n_syncs = run()
        walls.append(time.perf_counter() - t0)
        cpus.append(time.process_time() - cpu0)
        region_syncs.append(n_syncs)
    launches = _launches(kernels)
    steps = TEXT_EPOCHS * TEXT_STEPS
    expected = steps // trainer.flush_steps() + 1
    _check(launches == _want(kernels), f"kernels launched {launches} times "
                                       "on the text path, want none")
    _check(all(c == expected for c in region_syncs),
           f"counted syncs per timed run {region_syncs}, want {expected} "
           "(the ring reads and the final fetch)")
    _check(math.isfinite(final_loss), "text loss not finite")

    # the sync check, untimed: an epoch of steps from a resident cache
    cache = DeviceEpochCache({"ids": _tokenize_hash(texts), "label": labels},
                             TEXT_BATCH, device=card)

    def epoch():
        nonlocal state
        trainer.flush_metrics()
        for batch in cache.batches(0):
            state, metrics = trainer.train_step(state, batch, 1)
        return float(syncs.device_get(metrics["loss"], "smoke.final_fetch"))
    _, hidden, _ = _sync_checked(torch, epoch)
    _check(not hidden, f"uncounted host syncs in the text steps: {hidden}")
    rows_s = [n * TEXT_EPOCHS / w for w in walls]
    t0 = time.perf_counter()
    _tokenize_hash(texts)
    tokenize_s = time.perf_counter() - t0
    if profile_dir:
        _profile_pass(torch, epoch, profile_dir, "text")

    # (a) fp32, TF32 off: the card against a CPU run from the same params
    # and batch order
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids = _tokenize_hash(texts)

    def fp32_losses(device):
        tr, st = lane("float32", device)
        c = DeviceEpochCache({"ids": ids, "label": labels}, TEXT_BATCH,
                             device=device)
        out = []
        for batch in list(c.batches(0))[:TEXT_PARITY_STEPS]:
            st, mm = tr.train_step(st, batch, 1)
            out.append(mm["loss"])
        return syncs.device_get(torch.stack(out), "smoke.parity")
    card_f32 = fp32_losses(card)
    cpu_f32 = fp32_losses(torch.device("cpu"))
    f32_rel = _max_step_rel(card_f32, cpu_f32)
    torch.backends.cudnn.allow_tf32 = True
    _check(f32_rel <= TEXT_F32_TOL,
           f"textcnn fp32 {TEXT_PARITY_STEPS} steps, card vs CPU: largest "
           f"relative loss difference {f32_rel} > {TEXT_F32_TOL}")

    # Word2Vec at its defaults on the same reviews, tokenized by the port's
    # RegexTokenizer; the synonym corpus of tests/test_text.py
    tokens = RegexTokenizer(inputCol="text", outputCol="tok").transform(
        Frame.from_dict({"text": texts}))
    uploads = []
    real_to_device = tw2v.to_device

    def spy(x, device):
        uploads.append((tuple(np.shape(x)), device.type))
        return real_to_device(x, device)
    tw2v.to_device = spy
    try:
        kernels.reset_launches()
        sync0 = syncs.total()
        t0 = time.perf_counter()
        w2v = tw2v.Word2Vec(inputCol="tok", outputCol="vec").fit(tokens)
        fit_s = time.perf_counter() - t0
        fit_syncs = syncs.total() - sync0
        w2v_launches = _launches(kernels)
        review_uploads = list(uploads)
        uploads.clear()
        docs = []
        for fruit in ("apple", "orange"):
            docs += [["i", "eat", fruit, "every", "day"],
                     ["fresh", fruit, "juice", "tastes", "sweet"],
                     ["the", fruit, "tree", "grows", "fast"]] * 6
        docs += [["the", "motor", "engine", "runs", "fast"],
                 ["repair", "the", "motor", "with", "tools"]] * 6
        sync0 = syncs.total()
        toy, toy_hidden, _ = _sync_checked(torch, lambda: tw2v.Word2Vec(
            inputCol="tok", outputCol="vec", vectorSize=24, minCount=2,
            maxIter=10, stepSize=0.05, seed=3, batchSize=256).fit(
            Frame.from_dict({"tok": docs})))
        toy_syncs = syncs.total() - sync0
        toy_uploads = list(uploads)
    finally:
        tw2v.to_device = real_to_device
    n_pairs = review_uploads[1][0][0]
    _check(len(review_uploads) == 4 and len(toy_uploads) == 4
           and all(d == "cuda" for _, d in review_uploads + toy_uploads),
           f"Word2Vec uploads {review_uploads} / {toy_uploads}: want w_in, "
           "the two pair arrays and the table, once a fit, to the card")
    _check(fit_syncs == 1 and toy_syncs == 1,
           f"Word2Vec counted syncs a fit {fit_syncs} / {toy_syncs}, want 1")
    _check(not toy_hidden, f"uncounted host syncs in Word2Vec: {toy_hidden}")
    _check(w2v_launches == _want(kernels),
           f"Word2Vec launched kernels {w2v_launches}")
    _check(bool(np.isfinite(w2v.vectors).all())
           and w2v.vectors.shape[1] == 100, "Word2Vec vectors not finite")
    vecs = toy.get_vectors()

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    syn = (cos(vecs["apple"], vecs["orange"]), cos(vecs["apple"],
                                                   vecs["motor"]))
    synonyms = toy.find_synonyms("apple", 3)
    _check(syn[0] > syn[1] and len(synonyms) == 3
           and all(w != "apple" for w, _ in synonyms),
           f"Word2Vec synonym corpus on the card: cos {syn}, {synonyms}")

    _line(phase="text", card=_smi(), model="textcnn", rows=n,
          seq_len=TEXT_SEQ, vocab_slots=TEXT_VOCAB, batch=TEXT_BATCH,
          epochs=TEXT_EPOCHS, optimizer="adam(1e-3)", compute="bfloat16",
          first_step_s=first_s, timed_runs_s=walls, cpu_s=cpus,
          rows_per_s=statistics.median(rows_s), rows_per_s_min=min(rows_s),
          rows_per_s_max=max(rows_s),
          step_ms=statistics.median(walls) / steps * 1e3,
          timed_region=f"tokenize+hash, one upload, {TEXT_EPOCHS} epochs, "
                       "one fetch", tokenize_hash_s=tokenize_s,
          syncs_per_run=region_syncs, expected_syncs=expected,
          flops_per_step=trainer.flops_per_step,
          launches_main_path=launches, final_loss=final_loss,
          parity_fp32_tf32_off=dict(
              steps=TEXT_PARITY_STEPS, max_step_rel_diff=f32_rel,
              tolerance=TEXT_F32_TOL, first_loss=float(card_f32[0]),
              last_loss=float(card_f32[-1])),
          word2vec=dict(rows=n, vocab=len(w2v.get("vocabulary")),
                        pairs=n_pairs, fit_s=fit_s,
                        pairs_per_s=n_pairs / fit_s, syncs=fit_syncs,
                        uploads=len(review_uploads),
                        launches=w2v_launches,
                        synonym_corpus_cos=syn,
                        synonyms=[w for w, _ in synonyms]))


def phase_lm_train(torch, kernels, card, profile_dir=None):
    """Next-token LM training on the card: transformer_lm at the zoo's
    width in bf16 through DistributedTrainer (the counts zeroed just
    before, read just after), its sync check and tokens/s, the share of K3's
    plain backward; then the three gates: bf16 against the reference
    attention, fp32 on K3's CUDA-core route, and the MoE LM."""
    from functools import partial

    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.models.zoo.moe import moe_aux_loss
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.observability.metrics import (
        H100_SXM_BF16_DENSE_FLOPS,
    )
    from mmlspark_tpu_torch.ops.attention import _flash_backward_plain
    from mmlspark_tpu_torch.parallel.optim import adamw
    from mmlspark_tpu_torch.parallel.sequence import full_attention
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    ids = np.random.default_rng(0).integers(
        0, LM_VOCAB, (LM_ROWS, LM_LEN)).astype(np.int32)
    inits = {}
    aux_log = []

    def lane(name="transformer_lm", dtype="bfloat16", batch=LM_BATCH,
             rows=LM_ROWS, reference=False, **arch):
        """``name`` from random weights of seed 0 (one draw per
        architecture), adamw(1e-3), next-token cross-entropy (plus 0.01 *
        moe_aux for the MoE LM), an endless unshuffled resident epoch."""
        attention = partial(full_attention, use_flash="never") \
            if reference else None
        module = build_model(name, dtype=dtype, attention_fn=attention,
                             **arch)["module"]
        key = (name, tuple(sorted(arch.items())))
        if key not in inits:
            inits[key] = init_state(module, seed=0)
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in inits[key].items()})
        moe = name == "transformer_lm_moe"

        def loss_fn(module, batch, gen):
            x = batch["ids"]
            logits, inters = module.forward_with_intermediates(x)
            v = logits.shape[-1]
            ce = F.cross_entropy(logits[:, :-1].reshape(-1, v),
                                 x[:, 1:].reshape(-1).long())
            if not moe:
                return ce
            aux = moe_aux_loss(inters)
            aux_log.append(aux.detach())
            return ce + 0.01 * aux
        trainer = DistributedTrainer(loss_fn, adamw(1e-3))
        state = trainer.init(lambda: module)
        cache = DeviceEpochCache({"ids": ids[:rows]}, batch)

        def batches():
            while True:
                yield from cache.batches(0)
        return trainer, state, batches()

    # the main path: counts zeroed just before, read just after
    trainer, state, it = lane()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, next(it), 1)
    syncs.device_get(m["loss"], "smoke.first_step")
    first_s = time.perf_counter() - t0
    for _ in range(LM_TRAIN_WARMUP - 1):
        state, m = trainer.train_step(state, next(it), 1)
    expected = LM_TRAIN_WINDOW // trainer.flush_steps() + 1

    def window():
        nonlocal state
        trainer.flush_metrics()
        sync0 = syncs.total()
        for _ in range(LM_TRAIN_WINDOW):
            state, m = trainer.train_step(state, next(it), 1)
        loss = float(syncs.device_get(m["loss"], "smoke.final_fetch"))
        return loss, syncs.total() - sync0

    (_, check_syncs), hidden, _ = _sync_checked(torch, window)
    _check(not hidden, f"uncounted host syncs in the LM steps: {hidden}")
    windows = []
    for _ in range(LM_TRAIN_WINDOWS):
        t0 = time.perf_counter()
        final_loss, n_syncs = window()
        windows.append(time.perf_counter() - t0)
        _check(n_syncs == expected, f"{n_syncs} counted syncs in an LM "
                                    f"window, want {expected}")
    launches = _launches(kernels)
    steps = LM_TRAIN_WARMUP + LM_TRAIN_WINDOW * (1 + LM_TRAIN_WINDOWS)
    _check(launches == _want(kernels, FLASH_ATTENTION_TC=LM_DEPTH * steps),
           f"kernels launched {launches} times in {steps} LM train steps, "
           f"want K3's tensor-core kernel {LM_DEPTH} a step and no other")
    _check(check_syncs == expected and math.isfinite(final_loss)
           and int(syncs.device_get(state["step"], "smoke.step")) == steps,
           "LM train loss not finite, step counter or syncs off")
    step_s = statistics.median(windows) / LM_TRAIN_WINDOW
    tokens_s = [LM_BATCH * LM_LEN * LM_TRAIN_WINDOW / w for w in windows]
    flops = trainer.flops_per_step
    if profile_dir:
        def one_step():
            nonlocal state
            state, _ = trainer.train_step(state, next(it), 1)
            torch.cuda.synchronize()
        _profile_pass(torch, one_step, profile_dir, "lm_train")

    # K3's plain backward at the step's shape, 6 a step: its share
    shape = (LM_BATCH, LM_LEN, 8, 64)
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v, out, do = (torch.randn(shape, generator=g, device=card,
                                    dtype=torch.bfloat16) for _ in range(5))
    bwd_ms = _median_ms(torch, lambda: _flash_backward_plain(
        q, k, v, out, do, True), iters=2, reps=3)
    del q, k, v, out, do, trainer, state, it

    # (a) bf16: the K3 route against the reference attention, same params
    # and batches, at a batch whose (b, h, L, L) fp32 scores fit
    def losses(n, **kw):
        tr, st, batches = lane(**kw)
        out = []
        for _ in range(n):
            st, mm = tr.train_step(st, next(batches), 1)
            out.append(mm["loss"])
        return syncs.device_get(torch.stack(out), "smoke.parity")
    kernels.reset_launches()
    k3_bf16 = losses(LM_GATE_STEPS, batch=LM_GATE_BATCH)
    gate_launches = _launches(kernels)
    ref_bf16 = losses(LM_GATE_STEPS, batch=LM_GATE_BATCH, reference=True)
    bf16_rel = _max_step_rel(k3_bf16, ref_bf16)
    _check(gate_launches == _want(kernels, FLASH_ATTENTION_TC=LM_DEPTH
                                  * LM_GATE_STEPS)
           and bf16_rel <= LM_BF16_TRAIN_TOL,
           f"bf16 LM training, K3 vs the reference attention over "
           f"{LM_GATE_STEPS} steps: largest relative loss difference "
           f"{bf16_rel} > {LM_BF16_TRAIN_TOL}, or launches {gate_launches}")

    # (b) fp32, TF32 off: K3's CUDA-core route, 2 a step at depth 2
    kernels.reset_launches()
    k3_f32 = losses(LM_F32_STEPS, dtype="float32", batch=LM_F32_TRAIN_ROWS,
                    rows=LM_F32_TRAIN_ROWS, depth=LM_F32_DEPTH)
    f32_launches = _launches(kernels)
    ref_f32 = losses(LM_F32_STEPS, dtype="float32", batch=LM_F32_TRAIN_ROWS,
                     rows=LM_F32_TRAIN_ROWS, depth=LM_F32_DEPTH,
                     reference=True)
    f32_rel = _max_step_rel(k3_f32, ref_f32)
    _check(f32_launches == _want(kernels, FLASH_ATTENTION=LM_F32_DEPTH
                                 * LM_F32_STEPS)
           and f32_rel <= LM_F32_TRAIN_TOL,
           f"fp32 LM training on K3's CUDA-core route: launches "
           f"{f32_launches}, largest relative loss difference {f32_rel} > "
           f"{LM_F32_TRAIN_TOL}")

    # (c) the MoE LM at its zoo defaults: CE + 0.01 * moe_aux
    kernels.reset_launches()
    aux_log.clear()
    moe = losses(MOE_TRAIN_STEPS, name="transformer_lm_moe", rows=MOE_ROWS)
    moe_launches = _launches(kernels)
    aux = syncs.device_get(torch.stack(aux_log), "smoke.moe_aux")
    _check(moe_launches == _want(kernels, FLASH_ATTENTION_TC=LM_DEPTH
                                 * MOE_TRAIN_STEPS)
           and bool(np.isfinite(moe).all()) and bool((aux > 0).all())
           and moe[-1] < moe[0],
           f"MoE LM training: losses {moe.tolist()}, moe_aux {aux.tolist()}, "
           f"launches {moe_launches}")

    _line(phase="lm_train", card=_smi(), model="transformer_lm",
          rows=LM_ROWS, length=LM_LEN, batch=LM_BATCH, depth=LM_DEPTH,
          compute="bfloat16", optimizer="adamw(1e-3)",
          loss="next-token cross-entropy (mean)", first_step_s=first_s,
          timed_windows_s=windows, steps_per_window=LM_TRAIN_WINDOW,
          step_ms=step_s * 1e3, tokens_per_s=statistics.median(tokens_s),
          tokens_per_s_min=min(tokens_s), tokens_per_s_max=max(tokens_s),
          flops_per_step=flops, achieved_tflops=flops / step_s / 1e12,
          mfu_vs_bf16_dense_peak=flops / step_s / H100_SXM_BF16_DENSE_FLOPS,
          launches_main_path=launches, k3_launches_per_step=LM_DEPTH,
          syncs_per_window=check_syncs, expected_syncs=expected,
          final_loss=final_loss,
          k3_plain_backward=dict(ms_per_call=bwd_ms, calls_per_step=LM_DEPTH,
                                 share_of_step=LM_DEPTH * bwd_ms
                                 / (step_s * 1e3)),
          gate_bf16_vs_reference=dict(
              batch=LM_GATE_BATCH, steps=LM_GATE_STEPS,
              max_step_rel_diff=bf16_rel, tolerance=LM_BF16_TRAIN_TOL,
              k3_losses=k3_bf16.tolist(), reference_losses=ref_bf16.tolist()),
          gate_fp32_cuda_core=dict(
              depth=LM_F32_DEPTH, rows=LM_F32_TRAIN_ROWS, steps=LM_F32_STEPS,
              launches=f32_launches, max_step_rel_diff=f32_rel,
              tolerance=LM_F32_TRAIN_TOL, tf32="off"),
          gate_moe=dict(model="transformer_lm_moe", rows=MOE_ROWS,
                        batch=LM_BATCH, steps=MOE_TRAIN_STEPS,
                        losses=moe.tolist(), moe_aux=aux.tolist(),
                        launches=moe_launches))
    return launches, f32_launches, moe_launches


def phase_train_large(torch, kernels, card, profile_dir=None):
    """The JAX bench's train_large lane on the card: ViT-B/16 at 224x224
    trained from a resident epoch with K1 in the loss (the counts zeroed
    just before, read just after), images/s and MFU; then 10 steps against
    the same trainer fed by K1's plain version."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.observability.metrics import (
        H100_SXM_BF16_DENSE_FLOPS,
    )
    from mmlspark_tpu_torch.ops.preprocess import (
        _fused_normalize_plain, _inv_std, make_preprocess_fn,
    )
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )

    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (TL_IMAGES, math.prod(TL_SHAPE)),
                          dtype=np.uint8)
    labels = rng.integers(0, 1000, TL_IMAGES).astype(np.int32)
    params = {}
    mean = (127.5,) * 3

    def lane(pre):
        module = build_model("vit_b16", num_classes=1000)["module"]
        if not params:
            params.update(init_state(module, seed=0))
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in params.items()})

        def loss_fn(module, batch, gen):
            logits = module(pre(batch["image"])).float()
            return F.cross_entropy(logits, batch["label"].long())
        trainer = DistributedTrainer(loss_fn, sgd(0.01, momentum=0.9))
        state = trainer.init(lambda: module)
        cache = DeviceEpochCache({"image": images, "label": labels},
                                 TL_BATCH)

        def batches():
            while True:
                yield from cache.batches(0)
        return trainer, state, batches()

    def plain_pre(u8):
        m = torch.tensor(mean, dtype=torch.float32, device=card)
        istd = torch.from_numpy(_inv_std(mean)).to(card)
        return _fused_normalize_plain(u8, m, istd, torch.bfloat16).reshape(
            (u8.shape[0],) + TL_SHAPE)

    # the main path: counts zeroed just before, read just after
    trainer, state, it = lane(make_preprocess_fn(TL_SHAPE, mean, mean))
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, next(it), 1)
    syncs.device_get(m["loss"], "smoke.first_step")
    first_s = time.perf_counter() - t0
    for _ in range(TL_WARMUP - 1):
        state, m = trainer.train_step(state, next(it), 1)
    syncs.device_get(m["loss"], "smoke.warm")
    windows = []
    for _ in range(TL_WINDOWS):
        trainer.flush_metrics()
        t0 = time.perf_counter()
        for _ in range(TL_STEPS):
            state, m = trainer.train_step(state, next(it), 1)
        final_loss = float(syncs.device_get(m["loss"], "smoke.final_fetch"))
        windows.append(time.perf_counter() - t0)
    launches = _launches(kernels)
    steps = TL_WARMUP + TL_STEPS * TL_WINDOWS
    _check(launches == _want(kernels, FUSED_NORMALIZE=steps),
           f"kernels launched {launches} times in {steps} train_large steps, "
           "want K1 once a step and no other")
    _check(math.isfinite(final_loss), "train_large loss not finite")
    step_s = statistics.median(windows) / TL_STEPS
    flops = trainer.flops_per_step
    tflops = flops / step_s / 1e12
    if profile_dir:
        def one_step():
            nonlocal state
            state, _ = trainer.train_step(state, next(it), 1)
            torch.cuda.synchronize()
        _profile_pass(torch, one_step, profile_dir, "train_large")
    del trainer, state, it

    # K1 against its plain version in the loss: same params and batches,
    # cuDNN deterministic so the two runs differ only in the preprocess
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def losses(pre):
        tr, st, batches = lane(pre)
        out = []
        for _ in range(TL_PARITY_STEPS):
            st, mm = tr.train_step(st, next(batches), 1)
            out.append(mm["loss"])
        return syncs.device_get(torch.stack(out), "smoke.parity")
    k1 = losses(make_preprocess_fn(TL_SHAPE, mean, mean))
    plain = losses(plain_pre)
    torch.backends.cudnn.deterministic = False
    rel = _max_step_rel(k1, plain)
    _check(bool(np.isfinite(k1).all()) and rel <= TL_PARITY_TOL,
           f"train_large {TL_PARITY_STEPS} steps, K1 vs its plain version: "
           f"largest relative loss difference {rel} > {TL_PARITY_TOL}")
    _line(phase="train_large", card=_smi(), model="vit_b16",
          image=list(TL_SHAPE), classes=1000, images=TL_IMAGES,
          batch=TL_BATCH, compute="bfloat16",
          optimizer="sgd(0.01, momentum=0.9)", first_step_s=first_s,
          timed_windows_s=windows, steps_per_window=TL_STEPS,
          step_ms=step_s * 1e3,
          images_per_s=TL_BATCH / step_s,
          images_per_s_min=TL_BATCH * TL_STEPS / max(windows),
          images_per_s_max=TL_BATCH * TL_STEPS / min(windows),
          flops_per_step=flops, achieved_tflops=tflops,
          mfu_vs_bf16_dense_peak=tflops * 1e12 / H100_SXM_BF16_DENSE_FLOPS,
          launches_main_path=launches, final_loss=final_loss,
          parity_vs_k1_plain=dict(
              steps=TL_PARITY_STEPS, bit_equal=bool(np.array_equal(k1, plain)),
              max_step_rel_diff=rel, tolerance=TL_PARITY_TOL,
              first_loss=float(k1[0]), last_loss=float(k1[-1])))
    return launches


def phase_vmoe(torch, kernels, card):
    """V-MoE-B/16 on the card. One training step at vmoe_b16.train's batch
    (K1 in the loss, the train lane's aux loss) with every launch count
    zeroed just before it and read just after, under CUDA's sync-debug
    mode: each of the 6 routed blocks launches 6 grouped GEMMs, a gather,
    a combine, their backward and 2 bias gradients, and nothing outside
    the counted syncs reads the device. Then VM_STEPS timed steps, and each
    wrapper of ops/moe.py against its plain version on the same inputs at
    the cell's shapes, forward and backward, with the kernels' device ms
    beside their bound, the plain version's and cuBLAS's (``bmm`` on the
    padded buffer, and the same function in PyTorch: ``baddbmm``, GELU,
    ``baddbmm``)."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.models.zoo.moe import moe_aux_loss
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.ops import moe as moe_ops
    from mmlspark_tpu_torch.ops.preprocess import make_preprocess_fn
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

    module = build_model("vmoe_b16", num_classes=1000, noise_seed=1)["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, seed=0).items()})
    pre = make_preprocess_fn(TL_SHAPE, (127.5,) * 3, (127.5,) * 3)

    def loss_fn(m, batch, gen):
        logits = m(pre(batch["image"])).float()
        return F.cross_entropy(logits, batch["label"].long()) \
            + 0.01 * moe_aux_loss(m)
    trainer = DistributedTrainer(loss_fn, sgd(0.01, momentum=0.9))
    state = trainer.init(lambda: module)
    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (VM_BATCH, math.prod(TL_SHAPE)),
                 dtype=np.uint8)).to(card),
             "label": torch.from_numpy(rng.integers(
                 0, 1000, VM_BATCH).astype(np.int32)).to(card)}
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, batch, 1)
    syncs.device_get(m["loss"], "smoke.first_step")
    first_s = time.perf_counter() - t0
    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    (state, m), hidden, n_sync = _sync_checked(
        torch, lambda: trainer.train_step(state, batch, 1))
    launches = _launches(kernels)
    loss = float(syncs.device_get(m["loss"], "smoke.vmoe"))
    want = _want(kernels, FUSED_NORMALIZE=1, MOE_GROUPED_GEMM=36,
                 MOE_PERMUTE=6, MOE_UNPERMUTE=12, MOE_UNPERMUTE_BWD=6,
                 MOE_BIAS_GRAD=12)
    _check(launches == want, f"a vmoe_b16 step launched {launches}, "
                             f"want {want}")
    _check(not hidden, f"a vmoe_b16 step synchronized at {hidden}")
    _check(math.isfinite(loss), "vmoe_b16 loss not finite")
    t0 = time.perf_counter()
    for _ in range(VM_STEPS):
        state, m = trainer.train_step(state, batch, 1)
    syncs.device_get(m["loss"], "smoke.vmoe_timed")
    step_s = (time.perf_counter() - t0) / VM_STEPS
    peak = torch.cuda.max_memory_allocated(card)
    del trainer, state, m, module

    # each wrapper against its plain version at the cell's shapes
    bf16 = torch.bfloat16
    g = torch.Generator(device=card).manual_seed(0)
    E, K, S, D, H = 32, 2, VM_BATCH * 197, 768, 3072
    C = round(K * S * 1.05 / E)
    x = torch.randn(S, D, generator=g, device=card, requires_grad=True)
    gates, gate_idx = torch.topk(torch.softmax(
        torch.randn(S, E, generator=g, device=card), -1), K, dim=-1)
    gates.requires_grad_(True)
    plan = moe_ops.index_plan(gate_idx, E, C)
    leaves = [torch.randn(E, D, H, generator=g, device=card) / D ** 0.5,
              0.02 * torch.randn(E, H, generator=g, device=card),
              torch.randn(E, H, D, generator=g, device=card) / H ** 0.5,
              0.02 * torch.randn(E, D, generator=g, device=card)]
    for t in leaves:
        t.requires_grad_(True)
    dy = torch.randn(S, D, generator=g, device=card).to(bf16)

    def kernel_route():
        xe = moe_ops.permute(x, plan, E, bf16)
        ye = moe_ops.experts(xe.view(E, C, D), *leaves, bf16, bf16)
        return xe, ye, moe_ops.unpermute(ye.view(E * C, D), gates, plan,
                                         bf16)

    def plain_route():
        xe = moe_ops.permute_plain(x, plan.pair_slot, E * C, bf16)
        ye = moe_ops.experts_plain(xe.view(E, C, D), *leaves, bf16, bf16)
        return xe, ye, moe_ops.unpermute_plain(ye.view(E * C, D), gates,
                                               plan.pair_slot, bf16)
    outs = []
    for route in (kernel_route, plain_route):
        xe, ye, y = route()
        y.backward(dy)
        outs.append([xe.detach(), ye.detach(), y.detach(), x.grad, gates.grad]
                    + [t.grad for t in leaves])
        for t in [x, gates] + leaves:
            t.grad = None
    torch.cuda.synchronize()
    names = ["permute", "experts", "unpermute", "d_x", "d_gates", "d_w_up",
             "d_b_up", "d_w_down", "d_b_down"]
    errs = {n: float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) for n, a, b in zip(names, *outs)}
    _check(all(v <= VM_TOL for v in errs.values()),
           f"MoE kernels against their plain versions: {errs} > {VM_TOL}")

    # device ms a call of one routed block's forward, and forward + backward
    with torch.no_grad():
        xe = moe_ops.permute(x, plan, E, bf16)
        ye = moe_ops.experts(xe.view(E, C, D), *leaves, bf16, bf16)
        ms = {"permute": _graph_ms(torch, lambda: moe_ops.permute(
                  x, plan, E, bf16)),
              "experts_fwd": _graph_ms(torch, lambda: moe_ops.experts(
                  xe.view(E, C, D), *leaves, bf16, bf16), iters=5),
              "unpermute": _graph_ms(torch, lambda: moe_ops.unpermute(
                  ye.view(E * C, D), gates, plan, bf16))}
        plain_ms = {"experts_fwd": _median_ms(torch, lambda: moe_ops.experts_plain(
            xe.view(E, C, D), *leaves, bf16, bf16), iters=2, reps=3)}
        xb, wu, wd = xe.view(E, C, D), leaves[0].to(bf16), leaves[2].to(bf16)
        bu, bd = leaves[1].to(bf16)[:, None], leaves[3].to(bf16)[:, None]
        library_ms = {
            "bmm_up_down": _graph_ms(torch, lambda: torch.bmm(
                torch.bmm(xb, wu), wd), iters=5),
            "same_function": _graph_ms(torch, lambda: torch.baddbmm(
                bd, F.gelu(torch.baddbmm(bu, xb, wu), approximate="tanh"),
                wd), iters=5)}

    def fwd_bwd():
        kernel_route()[2].backward(dy)
    ms["layer_fwd_bwd"] = _median_ms(torch, fwd_bwd, iters=3, reps=3)
    gemm_flops = 2 * E * C * D * H
    bound_ms = {"experts_fwd": 2 * gemm_flops / PEAK_BF16_S * 1e3,
                "layer_fwd_bwd_gemms": 6 * gemm_flops / PEAK_BF16_S * 1e3,
                "permute": (S * D * 4 + E * C * D * 2) / PEAK_BYTES_S * 1e3,
                "unpermute": (E * C * D * 2 + S * D * 2) / PEAK_BYTES_S * 1e3}
    _line(phase="vmoe", card=_smi(), model="vmoe_b16", batch=VM_BATCH,
          tokens=S, experts=E, top_k=K, capacity=C,
          first_step_s=first_s, step_ms=step_s * 1e3,
          images_per_s=VM_BATCH / step_s, loss=loss,
          memory_peak_bytes=peak, launches_main_path=launches,
          syncs_outside_counted=hidden, syncs_counted=n_sync,
          max_rel_err=errs, tolerance=VM_TOL, ms=ms, plain_ms=plain_ms,
          library_ms=library_ms, bound_ms=bound_ms,
          experts_fwd_tflops=2 * gemm_flops / ms["experts_fwd"] / 1e9,
          ptxas={k.name: _ptxas_of(k) for k in (kernels.MOE_GROUPED_GEMM,
                                                kernels.MOE_PERMUTE)})
    return {"launches": launches, "errs": errs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms}


def _closed_loop(clients, jobs, call):
    """``call(job)`` for every job, from ``clients`` threads that each take
    every ``clients``-th job in turn and wait for its answer before the
    next: (results, seconds per job, wall seconds). Any failure raises."""
    import threading
    results, lat, errors = [None] * len(jobs), [0.0] * len(jobs), []

    def client(c):
        try:
            for i in range(c, len(jobs), clients):
                t0 = time.perf_counter()
                results[i] = call(jobs[i])
                lat[i] = time.perf_counter() - t0
        except BaseException as e:          # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    _check(not any(t.is_alive() for t in threads), "a client thread hung")
    return results, lat, wall


def _pct_ms(seconds, q) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def _replayed(programs, kernel) -> tuple:
    """(launches, variant launches) of ``kernel`` that the programs' replays
    made: each program's captured launches times its replays."""
    n, variants = 0, {}
    for prog in programs:
        k, v = prog.launches.get(kernel.name, (0, {}))
        n += prog.replays * k
        for name, c in v.items():
            variants[name] = variants.get(name, 0) + prog.replays * c
    return n, variants


# profiling sessions a graph replay gets to record its captured kernels
PROFILE_TRIES = 3
# the seed of the patterns the cow graph's effect check writes
COW_SEED = 7
# the device symbols of each kernel's functions, as the profiler names the
# kernel nodes of a replayed graph
KERNEL_SYMBOLS = {
    "fused_normalize": ("fused_normalize_vec_kernel",
                        "fused_normalize_scalar_kernel"),
    "crop_resize_normalize": ("crop_resize_normalize_kernel",),
    "flash_attention": ("flash_fwd_kernel",),
    "flash_attention_tc": ("flash_tc_kernel",),
    "moe_grouped_gemm": ("moe_grouped_gemm_kernel",),
    "moe_permute": ("moe_permute_kernel",),
    "moe_unpermute": ("moe_unpermute_kernel",),
    "moe_unpermute_bwd": ("moe_unpermute_bwd_kernel",),
    "moe_bias_grad": ("moe_bias_grad_kernel",)}


def _cow_effect(torch, gen, prog) -> dict:
    """The ``cow`` graph checked by what it does: block ``src`` of every
    arena plane (K, V and, in int8, both scale planes) filled with one
    seeded pattern and block ``dst`` with another, the graph replayed
    once, then ``dst`` must equal ``src`` bit for bit and every other
    block keep its bytes. The planes are restored afterwards (the prefix
    cache still indexes them). Measurement only: it adds no launch
    counts."""
    from mmlspark_tpu_torch.serve.programs import DEVICE_LOCK
    kv = gen.kv
    planes = [kv.arena_k, kv.arena_v]
    if kv.quantized:
        planes += [kv.scale_k, kv.scale_v]
    # block 0 is the reserved scratch block; two others of the arena
    src, dst = 1, planes[0].shape[1] - 1
    g = torch.Generator(device=planes[0].device).manual_seed(COW_SEED)
    with DEVICE_LOCK:
        saved = [p.clone() for p in planes]
        for p in planes:
            for block in (src, dst):
                shape = p[:, block].shape
                if p.dtype.is_floating_point:
                    fill = torch.randn(shape, generator=g, device=p.device,
                                       dtype=torch.float32)
                else:
                    fill = torch.randint(-127, 128, shape, generator=g,
                                         device=p.device, dtype=torch.int32)
                p[:, block] = fill.to(p.dtype)
        before = [p.clone() for p in planes]
        prog.inputs[0].fill_(src)
        prog.inputs[1].fill_(dst)
        torch.cuda.synchronize()
        prog.graph.replay()
        torch.cuda.synchronize()
        copied, others = True, True
        for p, b in zip(planes, before):
            want = b.clone()
            want[:, dst] = b[:, src]
            copied &= torch.equal(p[:, dst], b[:, src])
            others &= torch.equal(p, want)
        for p, keep in zip(planes, saved):
            p.copy_(keep)
        torch.cuda.synchronize()
    _check(copied and others,
           f"the cow graph's replay: dst equal to src {copied}, every "
           f"other block unchanged {others}")
    return {"check": "effect", "src": src, "dst": dst,
            "planes": len(planes), "dst_equals_src": copied,
            "others_unchanged": others}


def _profiled_replays(torch, kernels, programs, what, effects=None) -> dict:
    """Each program's graph replayed under torch.profiler, its operands
    zeroed first (padding rows: a generate program then writes only the
    reserved scratch block). The kernel nodes the profiler records on the
    device are counted by kernel and held against the launches the
    program's capture recorded (``prog.launches``), which the launch counts
    add at every replay; the replay must record some device work. A graph
    replays the same nodes every time, but a profiling session can lose
    device records (on the card one session recorded none, another 40 of a
    prefill graph's 343 and no K3 node, for graphs other sessions traced
    in full), so a session that disagrees is repeated, up to
    ``PROFILE_TRIES`` sessions, and the check fails unless one session
    records device work with exactly the recorded kernels. Measurement
    only: it adds no launch counts. Returns the device counts by program
    and the sessions each took, with the check each program got.

    A program whose capture recorded none of our kernels and that has an
    entry in ``effects`` (key -> ``check(prog)``: the ``cow`` graph, a few
    copy nodes, of which the profiler once recorded no device event in
    three sessions) is checked by its effect instead, not by profiler
    device events."""
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.serve.programs import DEVICE_LOCK
    seen = {}
    for key, prog in programs.items():
        want = {k.name: prog.launches.get(k.name, (0, {}))[0]
                for k in kernels.KERNELS}
        if not any(want.values()) and key in (effects or {}):
            seen[str(key)] = effects[key](prog)
            continue
        sessions = []
        for _ in range(PROFILE_TRIES):
            with DEVICE_LOCK:
                for buf in prog.inputs:
                    buf.zero_()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    prog.graph.replay()
                    torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")]
            got = {k.name: sum(1 for n in names
                               if any(sym in n
                                      for sym in KERNEL_SYMBOLS[k.name])
                               and "pytorch" not in n)
                   for k in kernels.KERNELS}
            sessions.append((len(names), got))
            if names and got == want:
                break
        events, got = sessions[-1]
        _check(events > 0 and got == want,
               f"{what} {key}: {len(sessions)} profiled replays ran "
               f"{sessions} (device events, kernels) on the device, its "
               f"capture recorded {want}")
        seen[str(key)] = {"check": "profiler", "device_events": events,
                          "sessions": len(sessions),
                          **{k: n for k, n in got.items() if n}}
    return seen


def _cow_effects(torch, gen, progs) -> dict:
    """``_profiled_replays``' effect checks of a lane's ``cow`` graphs."""
    return {key: (lambda prog: _cow_effect(torch, gen, prog))
            for key in progs if key[0] == "cow"}


def _batch_breakdown(torch, prog, x, reps: int = 5) -> dict:
    """Where one served batch's time goes, medians of ``reps``: the copy of
    the padded host batch into the graph's static input (host clock to a
    synchronize), the replay (CUDA events) and the counted fetch (host
    clock). Measurement only: the replays here add no launch counts."""
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.serve.programs import DEVICE_LOCK
    copy, replay, fetch = [], [], []
    host = torch.from_numpy(np.ascontiguousarray(x))
    with DEVICE_LOCK:
        for _ in range(reps):
            t0 = time.perf_counter()
            prog.inputs[0].copy_(host)
            torch.cuda.synchronize()
            copy.append(time.perf_counter() - t0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog.graph.replay()
            end.record()
            end.synchronize()
            replay.append(start.elapsed_time(end) / 1e3)
            t0 = time.perf_counter()
            syncs.device_get(prog.output, "smoke.breakdown")
            fetch.append(time.perf_counter() - t0)
    return {"copy_in_ms": statistics.median(copy) * 1e3,
            "replay_ms": statistics.median(replay) * 1e3,
            "fetch_ms": statistics.median(fetch) * 1e3}


def phase_serve(torch, kernels, card):
    """The image-scoring seam: a ``Server`` over the featurize path's
    ResNet-50 scoring model (the TorchModel ``ImageFeaturizer`` builds:
    ``pool``, bf16, ``devicePreprocess`` 256^2x3 uint8 -> 224^2), every
    bucket's CUDA graph captured before traffic, then 512 single-image
    requests from 16 client threads (the counts zeroed just before, read
    just after); full 64-row batches against ``TorchModel.transform`` at
    ``miniBatchSize=64``."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve import Server

    k2 = kernels.CROP_RESIZE_NORMALIZE
    rows = np.random.default_rng(0).integers(
        0, 256, (SERVE_REQUESTS, SRC * SRC * 3), dtype=np.uint8)
    tm = TorchModel(inputCol="image", outputCol="features",
                    outputNodeName="pool", miniBatchSize=SERVE_BUCKETS[-1],
                    devicePreprocess={"srcShape": [SRC, SRC, 3],
                                      "resize": [DST, DST]},
                    computeDtype="bfloat16")
    tm.set_model("resnet50", num_classes=1000, seed=0)
    with Server({"resnet50": tm}, max_batch=SERVE_BUCKETS[-1],
                buckets=SERVE_BUCKETS, max_wait_ms=2.0,
                queue_depth=4 * SERVE_REQUESTS) as srv:
        entry = srv.registry.get("resnet50")
        capture_ms = {}
        for b in SERVE_BUCKETS:          # cold start: one capture a bucket
            capture_ms[b] = entry.program_for(b, rows[:b]).capture_s * 1e3
        warm = entry.compile_count
        _check(warm == len(SERVE_BUCKETS), f"{warm} captures for "
                                           f"{len(SERVE_BUCKETS)} buckets")

        # the main path: counts zeroed just before, read just after
        kernels.reset_launches()
        served, lat, wall = _closed_loop(
            SERVE_CLIENTS, list(range(SERVE_REQUESTS)),
            lambda i: srv.submit("resnet50", rows[i], timeout=300))
        launches = _launches(kernels)
        k2_variants = dict(k2.variant_launches)
        progs = {key[0][0]: p for key, p in entry.built_programs().items()}
        _check(entry.compile_count == warm,
               f"{entry.compile_count - warm} captures after warm-up")
        for b, p in progs.items():
            _check(p.launches == {k2.name: (1, {"staged": 1})},
                   f"bucket {b}'s graph holds {p.launches}, want K2's "
                   "staged variant once")
        want_n, want_variants = _replayed(progs.values(), k2)
        _check(launches == _want(kernels, CROP_RESIZE_NORMALIZE=want_n)
               and k2_variants == want_variants and want_n > 0,
               f"kernels launched {launches} ({k2_variants}) on the serve "
               f"path, want K2 {want_n} times ({want_variants}): once per "
               "graph replay, and no other kernel")
        feats = np.concatenate(served)
        _check(feats.shape == (SERVE_REQUESTS, 2048)
               and bool(np.isfinite(feats).all()),
               f"served features {feats.shape} not finite or misshaped")
        replays = {b: p.replays for b, p in sorted(progs.items())}

        def serve_round():
            _, lat_r, wall_r = _closed_loop(
                SERVE_CLIENTS, list(range(SERVE_REQUESTS)),
                lambda i: srv.submit("resnet50", rows[i], timeout=300))
            return dict(images_per_s=SERVE_REQUESTS / wall_r,
                        p50_ms=_pct_ms(lat_r, 50), p99_ms=_pct_ms(lat_r, 99))
        ring = _ring_ab(serve_round)

        # full batches at the transform's shape: bit-equal, or within the
        # featurize phase's bf16 gate
        full = np.concatenate([srv.submit("resnet50", rows[i:i + 64],
                                          timeout=300)
                               for i in range(0, 128, 64)])
        direct = np.asarray(tm.transform(Frame.from_dict(
            {"image": rows})).column("features"))
        scale = float(np.abs(direct).max())
        full_diff = float(np.abs(full - direct[:128]).max())
        _check(bool(np.array_equal(full, direct[:128])),
               f"full 64-row batches vs transform at the same batch shape: "
               f"not bit-equal, max |difference| {full_diff}")
        cross_rel = float(np.abs(feats - direct).max()) / scale
        _check(cross_rel <= SERVE_REL_TOL,
               f"served rows (buckets 1-32) vs transform: rel {cross_rel}")
        device_launches = _profiled_replays(torch, kernels, progs, "serve")
        breakdown = {b: _batch_breakdown(torch, progs[b], rows[:b])
                     for b in (8, 64)}

    _line(phase="serve", card=_smi(), model="resnet50",
          requests=SERVE_REQUESTS, clients=SERVE_CLIENTS,
          buckets=list(SERVE_BUCKETS), compute="bfloat16",
          capture_ms=capture_ms, captures_warm=warm,
          captures_after_warm=entry.compile_count - warm,
          launches_main_path=launches, k2_variant_launches=k2_variants,
          replays_by_bucket=replays, wall_s=wall,
          images_per_s=SERVE_REQUESTS / wall,
          p50_ms=_pct_ms(lat, 50), p99_ms=_pct_ms(lat, 99),
          ring_rounds=ring,
          full_batch_bit_equal=True, full_batch_max_abs=full_diff,
          served_vs_transform_rel=cross_rel, rel_limit=SERVE_REL_TOL,
          device_launches_one_replay=device_launches,
          batch_breakdown=breakdown)
    return launches


def phase_lm_serve(torch, kernels, card):
    """The LM behind the same seam: ``transformer_lm`` (bf16, ``hidden``)
    served at buckets (1, 4, 8) to 128 requests of 2048 ids from 8 client
    threads, K3's tensor-core kernel 6 times a replay; a full 8-row batch
    against ``TorchModel.transform`` at ``miniBatchSize=8``."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.serve import Server

    tc = kernels.FLASH_ATTENTION_TC
    ids = np.random.default_rng(0).integers(
        0, LM_VOCAB, (LM_SERVE_REQUESTS, LM_LEN)).astype(np.int32)
    tm = _lm_scorer("transformer_lm", "hidden", LM_SERVE_BUCKETS[-1])
    with Server({"lm": tm}, max_batch=LM_SERVE_BUCKETS[-1],
                buckets=LM_SERVE_BUCKETS, max_wait_ms=2.0) as srv:
        entry = srv.registry.get("lm")
        capture_ms = {b: entry.program_for(b, ids[:b]).capture_s * 1e3
                      for b in LM_SERVE_BUCKETS}
        warm = entry.compile_count

        # the main path: counts zeroed just before, read just after
        kernels.reset_launches()
        served, lat, wall = _closed_loop(
            LM_SERVE_CLIENTS, list(range(LM_SERVE_REQUESTS)),
            lambda i: srv.submit("lm", ids[i], timeout=300))
        launches = _launches(kernels)
        progs = {key[0][0]: p for key, p in entry.built_programs().items()}
        _check(entry.compile_count == warm,
               f"{entry.compile_count - warm} captures after warm-up")
        for b, p in progs.items():
            _check(p.launches == {tc.name: (LM_DEPTH, {})},
                   f"bucket {b}'s graph holds {p.launches}, want K3's "
                   f"tensor-core kernel {LM_DEPTH} times")
        want_n, _ = _replayed(progs.values(), tc)
        _check(launches == _want(kernels, FLASH_ATTENTION_TC=want_n)
               and want_n > 0,
               f"kernels launched {launches} on the lm_serve path, want "
               f"K3's tensor-core kernel {want_n} times ({LM_DEPTH} a "
               "replay) and no other kernel")
        hidden = np.concatenate(served)
        _check(hidden.shape == (LM_SERVE_REQUESTS, LM_LEN, 512)
               and bool(np.isfinite(hidden).all()),
               f"served hidden {hidden.shape} not finite or misshaped")
        replays = {b: p.replays for b, p in sorted(progs.items())}

        def lm_round():
            _, lat_r, wall_r = _closed_loop(
                LM_SERVE_CLIENTS, list(range(LM_SERVE_REQUESTS)),
                lambda i: srv.submit("lm", ids[i], timeout=300))
            return dict(tokens_per_s=LM_SERVE_REQUESTS * LM_LEN / wall_r,
                        p50_ms=_pct_ms(lat_r, 50), p99_ms=_pct_ms(lat_r, 99))
        ring = _ring_ab(lm_round)

        full = srv.submit("lm", ids[:8], timeout=300)
        direct = np.asarray(tm.transform(Frame.from_dict(
            {"ids": ids})).column("h"))
        cross = _diff_stats(hidden, direct)
        _check(cross["max_abs"] <= LM_BF16_MAX
               and cross["mean_abs"] <= LM_BF16_MEAN,
               f"served rows (buckets 1-8) vs transform: {cross}")
        direct = direct[:8]
        full_stats = _diff_stats(full, direct)
        _check(bool(np.array_equal(full, direct)),
               f"a full 8-row batch vs transform at the same batch shape: "
               f"not bit-equal, {full_stats}")
        device_launches = _profiled_replays(torch, kernels, progs,
                                            "lm_serve")
        breakdown = _batch_breakdown(torch, progs[8], ids[:8])

    _line(phase="lm_serve", card=_smi(), model="transformer_lm",
          requests=LM_SERVE_REQUESTS, clients=LM_SERVE_CLIENTS,
          length=LM_LEN, buckets=list(LM_SERVE_BUCKETS), compute="bfloat16",
          capture_ms=capture_ms, captures_warm=warm,
          captures_after_warm=entry.compile_count - warm,
          launches_main_path=launches, replays_by_bucket=replays,
          wall_s=wall, tokens_per_s=LM_SERVE_REQUESTS * LM_LEN / wall,
          p50_ms=_pct_ms(lat, 50), p99_ms=_pct_ms(lat, 99),
          ring_rounds=ring,
          full_batch_bit_equal=True, full_batch_vs_transform=full_stats,
          served_vs_transform=cross,
          limits=dict(max_abs=LM_BF16_MAX, mean_abs=LM_BF16_MEAN),
          device_launches_one_replay=device_launches,
          batch_breakdown_bucket8=breakdown)
    return launches


def _full_recompute(torch, module, card, prompt, n):
    """The port's full-recompute loop: the whole context through the
    module once per new token, greedy."""
    toks = list(int(t) for t in prompt)
    with torch.no_grad():
        for _ in range(n):
            lg = module(torch.tensor([toks], dtype=torch.int64, device=card))
            toks.append(int(lg[0, -1].argmax()))
    return toks[len(prompt):]


def _warm_lane(lane, prompt_lengths) -> dict:
    """Capture every program the lane's traffic will use before it starts:
    the prefill buckets of ``prompt_lengths``, every decode bucket (the
    verify program's, with a draft), the chunk width and the
    copy-on-write; with a draft, the draft's prefill, decode, chunk and
    copy-on-write programs too. Returns capture ms by (kind, bucket),
    the draft's keys prefixed ``draft.``."""
    from mmlspark_tpu_torch.serve.batcher import bucket_for
    entries = [("", lane.gen, "verify" if lane.draft is not None
                else "decode")]
    if lane.draft is not None:
        entries.append(("draft.", lane.draft, "decode"))
    out = {}
    for tag, gen, step in entries:
        keys = ([("prefill", b) for b in sorted(
            {bucket_for(n, gen.prefill_buckets) for n in prompt_lengths})]
            + [(step, b) for b in gen.decode_buckets]
            + [("chunk", gen.chunk_width), ("cow", 0)])
        out.update({f"{tag}{k}:{b}": gen.program_for(k, b).capture_s * 1e3
                    for k, b in keys})
    return out


def _timed_steps(lane) -> list:
    """Wrap the lane's decode step (the speculative one with a draft) to
    record (sequences, tokens emitted, seconds) per step."""
    name = "_decode_step_spec" if lane.draft is not None else "_decode_step"
    step, steps = getattr(lane, name), []

    def timed():
        active = lane.batcher.active
        n0, t0 = sum(len(s.generated) for s in active), time.perf_counter()
        step()
        steps.append((len(active), sum(len(s.generated) for s in active)
                      - n0, time.perf_counter() - t0))
    setattr(lane, name, timed)
    return steps


def _lane_round(torch, kernels, models, prompts, lengths, overrides,
                what) -> dict:
    """One closed-loop round (GEN_CLIENTS threads, GEN_NEW_TOKENS each)
    through a fresh ``Server`` over ``models`` (``"lm"`` the target) with
    the ``generate.*`` ``overrides``: every program captured first, the
    counts zeroed just before the traffic and read just after. Gates: no
    capture after warm-up; every graph's recorded launches are K3's
    tensor-core kernel once a block in prefills at buckets of 512 and more
    and nothing else; the launches equal the graphs' recorded launches
    times their replays, the draft's prefill among them when there is a
    draft; every request gets its tokens. Returns the round's numbers."""
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.utils import config as tconfig

    tc = kernels.FLASH_ATTENTION_TC
    for k, v in overrides.items():
        tconfig.set(k, v)
    srv = Server(models)
    try:
        lane = srv.enable_generate("lm", start=False)
        capture_ms = _warm_lane(lane, lengths)
        entries = {"lm": lane.gen}
        if lane.draft is not None:
            entries["draft"] = lane.draft
        warm = {n: g.entry.compile_count for n, g in entries.items()}
        steps = _timed_steps(lane)
        stats0 = lane.stats()
        lane.start()
        kernels.reset_launches()
        outs, lat, wall = _closed_loop(
            GEN_CLIENTS, prompts,
            lambda p: srv.generate("lm", p, max_new_tokens=GEN_NEW_TOKENS,
                                   timeout=600))
        launches = _launches(kernels)
        stats = lane.stats()
        n_steps = stats["steps"] - stats0["steps"]
        t_end = time.perf_counter() + 10
        while len(steps) < n_steps and time.perf_counter() < t_end:
            time.sleep(0.001)
        _check(len(steps) == n_steps, f"{what}: {len(steps)} timed steps "
                                      f"for {n_steps} lane steps")
        steady = {n: g.entry.compile_count - warm[n]
                  for n, g in entries.items()}
        _check(not any(steady.values()),
               f"{what}: captures after warm-up {steady}, want none")
        by_entry = {}
        for n, g in entries.items():
            progs = g.built_programs()
            for (kind, b), prog in progs.items():
                want = ({tc.name: (g.depth, {})} if kind == "prefill"
                        and b >= 512 else {})
                _check(prog.launches == want,
                       f"{what}: the {n} {kind}:{b} graph holds "
                       f"{prog.launches}, want {want}")
            by_entry[n] = _replayed(progs.values(), tc)[0]
        want_n = sum(by_entry.values())
        _check(launches == _want(kernels, FLASH_ATTENTION_TC=want_n)
               and all(by_entry.values()),
               f"{what}: kernels launched {launches}, want K3's tensor-core "
               f"kernel {want_n} times ({by_entry} by entry) and no other "
               "kernel")
        tokens = [o["tokens"] for o in outs]
        _check(all(len(t) == GEN_NEW_TOKENS for t in tokens)
               and all(0 <= x < LM_VOCAB for t in tokens for x in t),
               f"{what}: a request did not get its tokens in the vocabulary")
        decode_tokens = sum(n for _, n, _ in steps)
        decode_s = sum(t for _, _, t in steps)
        proposed = stats.get("spec_proposed", 0) - stats0.get(
            "spec_proposed", 0)
        accepted = stats.get("spec_accepted", 0) - stats0.get(
            "spec_accepted", 0)
        ttft = [o["ttft_ms"] for o in outs]
        kv = lane.gen.kv
        return {
            "tokens": tokens, "launches": launches,
            "line": {
                "requests": len(prompts), "overrides": overrides,
                "kv_blocks": kv.num_blocks, "kv_dtype": kv.dtype_name,
                "arena_bytes": kv.arena_bytes(),
                "capture_ms": capture_ms, "steady_compiles": 0,
                "launches_main_path": launches,
                "k3_launches_by_entry": by_entry, "wall_s": wall,
                "tokens_per_s": len(prompts) * GEN_NEW_TOKENS / wall,
                "decode_tokens_per_s": decode_tokens / decode_s,
                "decode_s": decode_s, "decode_steps": len(steps),
                "decode_step_ms_median": statistics.median(
                    t for _, _, t in steps) * 1e3,
                "tokens_per_sequence_step": decode_tokens / sum(
                    n for n, _, _ in steps),
                "spec_proposed": proposed, "spec_accepted": accepted,
                "accept_rate": accepted / proposed if proposed else None,
                "ttft_ms_p50": float(np.percentile(ttft, 50)),
                "ttft_ms_p99": float(np.percentile(ttft, 99))}}
    finally:
        srv.close()
        for k in overrides:
            tconfig.unset(k)


def _depth2_draft(tm):
    """A depth-2 ``transformer_lm`` at ``tm``'s width whose embeddings,
    first two blocks and (tied) head with its final norm are ``tm``'s."""
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    params = {k: v for k, v in tm._state["params"].items()
              if not k.startswith("block")
              or k.split(".")[0] in ("block0", "block1")}
    return TorchModel().set_model("transformer_lm", params=params, depth=2)


def _prefix_round(srv, name, head, suffixes, new_tokens):
    """One shared-prefix round on ``srv``'s lane for ``name`` (started):
    ``head + suffixes[0]`` alone first (its prefill indexes the head's
    blocks), then ``head`` itself (a full hit: copy-on-write) and ``head +
    suffix`` for the rest, concurrently. Returns (tokens per request, the
    lane's prefix hits and copy-on-writes during the round)."""
    lane = srv._lanes[name]
    hits0, cow0 = lane.stats()["prefix_hits"], lane.stats()["cow_copies"]
    prompts = [np.concatenate([head, suffixes[0]]), head] + [
        np.concatenate([head, s]) for s in suffixes[1:]]
    first = srv.generate(name, prompts[0], max_new_tokens=new_tokens,
                         timeout=300)
    futs = [srv.submit_generate(name, p, max_new_tokens=new_tokens)
            for p in prompts[1:]]
    outs = [first] + [f.result(300) for f in futs]
    st = lane.stats()
    return ([o["tokens"] for o in outs], st["prefix_hits"] - hits0,
            st["cow_copies"] - cow0)


def _agreement(got, want) -> dict:
    """Requests whose tokens are equal, and the share of tokens before each
    request's first difference."""
    same = [g == w for g, w in zip(got, want)]
    lead = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 len(w)) for g, w in zip(got, want)]
    return {"requests_equal": int(sum(same)), "requests": len(same),
            "tokens_before_first_difference": float(
                sum(lead) / max(1, sum(len(w) for w in want)))}


def phase_generate(torch, kernels, card):
    """The generate lane on the card: ``transformer_lm`` (bf16) at
    max_seq_len 2048, every program captured before traffic, 128 prompts of
    600-1900 ids from 8 client threads (the counts zeroed just before,
    read just after: K3's tensor-core kernel 6 times a prefill replay, no
    other kernel); a shared-prefix round against the same round with the
    prefix cache off; the fp32 gate (depth 2, TF32 off): greedy tokens
    equal to the full recompute, and the shared-prefix round equal with
    and without the prefix cache."""
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.utils import config as tconfig

    tc = kernels.FLASH_ATTENTION_TC
    for k, v in GEN_CONFIG.items():
        tconfig.set(k, v)
    rng = np.random.default_rng(0)
    lengths = rng.integers(GEN_PROMPT[0], GEN_PROMPT[1] + 1, GEN_REQUESTS)
    prompts = [rng.integers(0, LM_VOCAB, n) for n in lengths]
    head = rng.integers(0, LM_VOCAB, GEN_PREFIX_HEAD)
    suffixes = [rng.integers(0, LM_VOCAB, n) for n in
                rng.integers(*GEN_PREFIX_SUFFIX, GEN_PREFIX_REQUESTS - 1)]
    prefix_lengths = [GEN_PREFIX_HEAD + len(suffixes[0])]

    tm = TorchModel().set_model("transformer_lm", seed=0)
    srv = Server({"lm": tm})
    try:
        lane = srv.enable_generate("lm", start=False)
        gen = lane.gen
        capture_ms = _warm_lane(lane, list(lengths) + prefix_lengths)
        warm = gen.entry.compile_count
        steps = _timed_steps(lane)
        lane.start()

        # the main path: counts zeroed just before, read just after
        kernels.reset_launches()
        outs, lat, wall = _closed_loop(
            GEN_CLIENTS, prompts,
            lambda p: srv.generate("lm", p, max_new_tokens=GEN_NEW_TOKENS,
                                   timeout=600))
        launches = _launches(kernels)
        progs = gen.built_programs()
        # the decode steps of this round alone: the last step's timing is
        # appended just after its requests are answered
        n_decode = sum(p.replays for (k, _), p in progs.items()
                       if k == "decode")
        t_end = time.perf_counter() + 10
        while len(steps) < n_decode and time.perf_counter() < t_end:
            time.sleep(0.001)
        main_steps = list(steps)
        _check(len(main_steps) == n_decode,
               f"{len(main_steps)} timed decode steps for {n_decode} decode "
               "replays")
        steady = gen.entry.compile_count - warm
        _check(steady == 0, f"steady_compiles {steady}, want 0")
        for (kind, b), p in progs.items():
            want = ({tc.name: (LM_DEPTH, {})} if kind == "prefill"
                    and b >= 512 else {})
            _check(p.launches == want, f"the {kind}:{b} graph holds "
                                       f"{p.launches}, want {want}")
        want_n, _ = _replayed(progs.values(), tc)
        _check(launches == _want(kernels, FLASH_ATTENTION_TC=want_n)
               and want_n > 0,
               f"kernels launched {launches} on the generate path, want K3's "
               f"tensor-core kernel {want_n} times ({LM_DEPTH} a prefill "
               "replay) and no other kernel")
        tokens = [o["tokens"] for o in outs]
        _check(all(len(t) == GEN_NEW_TOKENS for t in tokens)
               and all(0 <= x < LM_VOCAB for t in tokens for x in t),
               "a request did not get its 32 tokens in the vocabulary")
        replays = {f"{k}:{b}": p.replays for (k, b), p in progs.items()}
        decode_tokens = sum(n for _, n, _ in main_steps)
        decode_s = sum(s for _, _, s in main_steps)
        ttft = [o["ttft_ms"] for o in outs]
        itl = [o["itl_mean_ms"] for o in outs]
        device_launches = _profiled_replays(
            torch, kernels, progs, "generate",
            effects=_cow_effects(torch, gen, progs))
        breakdown = _batch_breakdown_decode(torch, progs, gen)
        module = srv.registry.get("lm").module
        bf16_agreement = _agreement(tokens[:GEN_RECOMPUTED], [
            _full_recompute(torch, module, card, p, GEN_NEW_TOKENS)
            for p in prompts[:GEN_RECOMPUTED]])

        on = _prefix_round(srv, "lm", head, suffixes, GEN_NEW_TOKENS)
        tconfig.set("generate.prefix_cache", False)
        srv.reset_lane("lm")
        off_lane = srv.enable_generate("lm", start=False)
        _warm_lane(off_lane, prefix_lengths + [GEN_PREFIX_HEAD])
        off_lane.start()
        off = _prefix_round(srv, "lm", head, suffixes, GEN_NEW_TOKENS)
        _check(on[1] > 0 and on[2] >= 1 and off[1] == 0,
               f"bf16 prefix round: {on[1]} hits, {on[2]} copy-on-writes "
               f"(cache off: {off[1]} hits)")
        bf16_prefix = _agreement(on[0], off[0])
        plain_arena_mb = gen.kv.arena_bytes() / 1e6
        plain_blocks = gen.kv.num_blocks
    finally:
        srv.close()
        tconfig.unset("generate.prefix_cache")

    # the spec and int8 rounds: 32 of the round's prompts, each round's
    # main path read on its own
    sub, sub_lengths = prompts[:GEN_SPEC_REQUESTS], list(
        lengths[:GEN_SPEC_REQUESTS])
    rounds = {}
    for label, draft in (("spec_same_weights", TorchModel().set_model(
                              "transformer_lm", seed=0)),
                         ("spec_depth2_draft", _depth2_draft(tm))):
        rounds[label] = _lane_round(
            torch, kernels, {"lm": tm, "draft": draft}, sub, sub_lengths,
            {"generate.draft_model": "draft",
             "generate.spec_tokens": GEN_SPEC_TOKENS}, label)
    rounds["int8"] = _lane_round(
        torch, kernels, {"lm": tm}, sub, sub_lengths,
        {"generate.kv_dtype": "int8", "generate.arena_mb": plain_arena_mb},
        "int8")
    int8_blocks = rounds["int8"]["line"]["kv_blocks"]
    _check(int8_blocks >= 1.8 * plain_blocks,
           f"int8 arena {int8_blocks} blocks at {plain_arena_mb} MB, want "
           f">= 1.8x the bf16 arena's {plain_blocks}")
    for label in ("spec_same_weights", "spec_depth2_draft"):
        line = rounds[label]["line"]
        _check(line["spec_proposed"] > 0 and line["accept_rate"] > 0,
               f"{label}: {line['spec_accepted']} of "
               f"{line['spec_proposed']} proposals accepted")
    spec_lines = {}
    for label, r in rounds.items():
        spec_lines[label] = {
            **r["line"], "tokens_vs_plain_round": _agreement(
                r["tokens"], tokens[:GEN_SPEC_REQUESTS])}
    spec_lines["int8"]["blocks_vs_bf16_arena"] = int8_blocks / plain_blocks

    gate = _generate_fp32_gate(torch, kernels, card, rng, head, suffixes)
    for k in GEN_CONFIG:
        tconfig.unset(k)
    _line(phase="generate", card=_smi(), model="transformer_lm",
          compute="bfloat16", requests=GEN_REQUESTS, clients=GEN_CLIENTS,
          prompt_length_min_median_max=[int(lengths.min()),
                                        float(np.median(lengths)),
                                        int(lengths.max())],
          new_tokens=GEN_NEW_TOKENS, config=GEN_CONFIG,
          kv_blocks=gen.kv.num_blocks, arena_bytes=gen.kv.arena_bytes(),
          capture_ms=capture_ms, captures_warm=warm, steady_compiles=steady,
          launches_main_path=launches, replays=replays, wall_s=wall,
          tokens_per_s=GEN_REQUESTS * GEN_NEW_TOKENS / wall,
          decode_tokens_per_s=decode_tokens / decode_s,
          decode_s=decode_s, decode_steps=len(main_steps),
          decode_step_ms_median=statistics.median(
              s for _, _, s in main_steps) * 1e3,
          ttft_ms_p50=float(np.percentile(ttft, 50)),
          ttft_ms_p99=float(np.percentile(ttft, 99)),
          itl_ms_median=float(np.median(itl)), itl_ms_max=float(max(itl)),
          request_s_p50=float(np.percentile(lat, 50)),
          device_launches_one_replay=device_launches,
          decode_breakdown=breakdown,
          bf16_vs_full_recompute=bf16_agreement,
          prefix_round={"head": GEN_PREFIX_HEAD,
                        "requests": GEN_PREFIX_REQUESTS,
                        "prefix_hits": on[1], "cow_copies": on[2],
                        "bf16_tokens_vs_cache_off": bf16_prefix},
          spec_and_int8_rounds=spec_lines,
          fp32_gate=gate["line"])
    return ({"plain": launches,
             **{k: r["launches"] for k, r in rounds.items()}},
            {"plain": gate["launches"], **gate["spec_launches"]},
            {"tokens_per_s": GEN_REQUESTS * GEN_NEW_TOKENS / wall,
             "ttft_ms_p50": float(np.percentile(ttft, 50)),
             "ttft_ms_p99": float(np.percentile(ttft, 99))})


def _batch_breakdown_decode(torch, progs, gen) -> dict:
    """The largest decode bucket's replay alone (CUDA events) beside its
    copy-in and fetch, on padding-lane operands (scratch writes only)."""
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.serve.programs import DEVICE_LOCK
    b = gen.decode_buckets[-1]
    prog = progs[("decode", b)]
    times = {"copy_in_ms": [], "replay_ms": [], "fetch_ms": []}
    with DEVICE_LOCK:
        for _ in range(5):
            t0 = time.perf_counter()
            for buf in prog.inputs:
                buf.copy_(torch.zeros(buf.shape, dtype=buf.dtype))
            torch.cuda.synchronize()
            times["copy_in_ms"].append((time.perf_counter() - t0) * 1e3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog.graph.replay()
            end.record()
            end.synchronize()
            times["replay_ms"].append(start.elapsed_time(end))
            t0 = time.perf_counter()
            syncs.device_get(prog.output, "smoke.breakdown")
            times["fetch_ms"].append((time.perf_counter() - t0) * 1e3)
    return {"bucket": b, **{k: statistics.median(v)
                            for k, v in times.items()}}


def _generate_fp32_gate(torch, kernels, card, rng, head, suffixes) -> dict:
    """fp32, TF32 off, ``transformer_lm`` at the zoo's width cut to depth 2:
    4 prompts of 600-1000 ids through a manually stepped lane (K3's
    CUDA-core kernel in prefill, twice a replay), greedy tokens equal to
    the full recompute; the shared-prefix round equal with and without
    the prefix cache."""
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.utils import config as tconfig

    f32k = kernels.FLASH_ATTENTION
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lengths = rng.integers(GEN_F32_PROMPT[0], GEN_F32_PROMPT[1] + 1,
                           GEN_F32_PROMPTS)
    prompts = [rng.integers(0, LM_VOCAB, n) for n in lengths]
    tm = TorchModel().set_model("transformer_lm", seed=0, dtype="float32",
                                depth=GEN_F32_DEPTH)
    srv = Server({"lm32": tm})
    try:
        lane = srv.enable_generate("lm32", start=False)
        _warm_lane(lane, list(lengths) + [GEN_PREFIX_HEAD + len(suffixes[0])])
        kernels.reset_launches()
        futs = [srv.submit_generate("lm32", p, max_new_tokens=GEN_NEW_TOKENS)
                for p in prompts]
        for _ in range(8 * GEN_NEW_TOKENS):
            if all(f.done() for f in futs):
                break
            lane.step()
        launches = _launches(kernels)
        progs = lane.gen.built_programs()
        for (kind, b), p in progs.items():
            want = ({f32k.name: (GEN_F32_DEPTH, {})} if kind == "prefill"
                    and b >= 512 else {})
            _check(p.launches == want, f"fp32 {kind}:{b} graph holds "
                                       f"{p.launches}, want {want}")
        want_n, _ = _replayed(progs.values(), f32k)
        _check(launches == _want(kernels, FLASH_ATTENTION=want_n)
               and want_n > 0, f"fp32 lane launched {launches}, want K3's "
                               f"CUDA-core kernel {want_n} times")
        device_launches = _profiled_replays(
            torch, kernels, progs, "fp32 generate",
            effects=_cow_effects(torch, lane.gen, progs))
        tokens = [f.result(1)["tokens"] for f in futs]
        module = srv.registry.get("lm32").module
        want = [_full_recompute(torch, module, card, p, GEN_NEW_TOKENS)
                for p in prompts]
        _check(tokens == want, f"fp32 greedy tokens differ from the full "
                               f"recompute: {_agreement(tokens, want)}")
        lane.start()
        on = _prefix_round(srv, "lm32", head, suffixes,
                           GEN_NEW_TOKENS)
        tconfig.set("generate.prefix_cache", False)
        srv.reset_lane("lm32")
        off_lane = srv.enable_generate("lm32", start=False)
        _warm_lane(off_lane, [GEN_PREFIX_HEAD + len(suffixes[0]),
                              GEN_PREFIX_HEAD])
        off_lane.start()
        off = _prefix_round(srv, "lm32", head, suffixes,
                            GEN_NEW_TOKENS)
        _check(on[1] > 0 and on[2] >= 1 and off[1] == 0,
               f"fp32 prefix round: {on[1]} hits, {on[2]} copy-on-writes "
               f"(cache off: {off[1]} hits)")
        _check(on[0] == off[0],
               "fp32 prefix-cache tokens differ from the cache-off round: "
               f"{_agreement(on[0], off[0])}")
    finally:
        srv.close()
        tconfig.unset("generate.prefix_cache")
    spec = _fp32_spec_gate(torch, kernels, tm, prompts, tokens)
    int8_rows = _fp32_int8_rows_gate(torch, tm, prompts[0])
    return {"launches": launches, "spec_launches": spec.pop("launches"),
            "line": {"depth": GEN_F32_DEPTH, "tf32": "off",
                     "prompt_lengths": [int(n) for n in lengths],
                     "launches": launches,
                     "device_launches_one_replay": device_launches,
                     "tokens_equal_full_recompute": True,
                     "prefix_hits": on[1], "cow_copies": on[2],
                     "prefix_tokens_equal_cache_off": True,
                     "spec": spec, "int8_rows": int8_rows}}


def _fp32_spec_gate(torch, kernels, tm, prompts, plain) -> dict:
    """fp32 (TF32 off), depth 2: the gate's prompts through a speculative
    lane with a same-weights draft and with a divergent one (seed
    ``GEN_F32_DRAFT_SEED``): greedy tokens EQUAL the plain lane's
    (``plain``); one seeded sampling request (temperature 0.8, top_k 4,
    seed 1234) gives the same tokens with and without speculation. The
    draft's prefill launches K3's CUDA-core kernel (counts zeroed before
    the greedy requests, read after)."""
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.utils import config as tconfig

    f32k = kernels.FLASH_ATTENTION
    sample = dict(temperature=0.8, top_k=4, seed=1234)

    def run(models, draft):
        tconfig.set("generate.draft_model", "draft" if draft else "")
        srv = Server(models, start=False)
        try:
            lane = srv.enable_generate("lm32", start=False)
            out, counts = [], None
            for batch, kw in ((prompts, {}), (prompts[:1], sample)):
                if not kw:
                    kernels.reset_launches()
                futs = [srv.submit_generate("lm32", p,
                                            max_new_tokens=GEN_NEW_TOKENS,
                                            **kw) for p in batch]
                for _ in range(8 * GEN_NEW_TOKENS):
                    if all(f.done() for f in futs):
                        break
                    lane.step()
                if not kw:
                    counts = _launches(kernels)
                out.append([f.result(1)["tokens"] for f in futs])
            st = lane.stats()
            by_entry = {"lm32": _replayed(
                lane.gen.built_programs().values(), f32k)[0]}
            if lane.draft is not None:
                by_entry["draft"] = _replayed(
                    lane.draft.built_programs().values(), f32k)[0]
            return out, st, counts, by_entry
        finally:
            srv.close()
            tconfig.unset("generate.draft_model")

    (_, plain_sampled), _, _, _ = run({"lm32": tm}, False)
    line, launches = {}, {}
    for label, seed in (("same_weights", 0),
                        ("divergent", GEN_F32_DRAFT_SEED)):
        draft = TorchModel().set_model("transformer_lm", seed=seed,
                                       dtype="float32", depth=GEN_F32_DEPTH)
        (greedy, sampled), st, counts, by_entry = run(
            {"lm32": tm, "draft": draft}, True)
        _check(greedy == plain, f"fp32 spec ({label}) greedy tokens differ "
                                f"from the plain lane's: "
                                f"{_agreement(greedy, plain)}")
        _check(sampled == plain_sampled,
               f"fp32 spec ({label}) seeded sampling differs from the plain "
               "lane's")
        _check(st["spec_proposed"] > 0 and by_entry["draft"] > 0
               and counts == _want(kernels, FLASH_ATTENTION=counts[
                   f32k.name]),
               f"fp32 spec ({label}): {st['spec_proposed']} proposals, "
               f"launches {counts}, K3 by entry {by_entry}")
        launches[label] = counts
        line[label] = {"tokens_equal_plain": True,
                       "sampled_tokens_equal_plain": True,
                       "spec_proposed": st["spec_proposed"],
                       "spec_accepted": st["spec_accepted"],
                       "accept_rate": st["spec_accepted"]
                       / st["spec_proposed"],
                       "launches": counts,
                       "k3_launches_by_entry_all_requests": by_entry}
    return {**line, "launches": launches}


def _fp32_int8_rows_gate(torch, tm, prompt) -> dict:
    """fp32, depth 2: one prompt prefilled into an fp32 arena and into an
    int8 arena (the same blocks: the free list is deterministic); every
    dequantized element of the int8 arena's leased blocks lies within
    scale/2 of the fp32 arena's element, plus the fp32 rounding of
    x/scale and of q*scale (at |q| <= 127 together under 2**-15 of
    scale/2). Block 0 is scratch: each graph's eager warm-up writes it."""
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.serve.kvcache import dequantize_rows
    from mmlspark_tpu_torch.utils import config as tconfig

    arenas = {}
    for kv in ("", "int8"):
        tconfig.set("generate.kv_dtype", kv)
        srv = Server({"lm32": tm}, start=False)
        try:
            lane = srv.enable_generate("lm32", start=False)
            f = srv.submit_generate("lm32", prompt, max_new_tokens=1)
            lane.step()
            f.result(1)
            k = lane.gen.kv
            arenas[kv] = [t.clone() for t in (k.arena_k, k.arena_v)] + (
                [k.scale_k.clone(), k.scale_v.clone()] if k.quantized
                else [])
        finally:
            srv.close()
            tconfig.unset("generate.kv_dtype")
    fk, fv = (t[:, 1:] for t in arenas[""])
    qk, qv, sk, sv = (t[:, 1:] for t in arenas["int8"])
    worst = 0.0
    for f, q, sc in ((fk, qk, sk), (fv, qv, sv)):
        ratio = ((dequantize_rows(q, sc) - f).abs()
                 / (sc[..., None, None] / 2)).max().item()
        worst = max(worst, ratio)
    _check(worst <= 1 + 2 ** -15, f"int8 arena rows off by {worst} "
                                  "half-scales from the fp32 rows, want "
                                  "<= 1 + 2**-15")
    return {"prompt": len(prompt), "max_error_in_half_scales": worst}


def _lane_programs(server, name="lm") -> list:
    """Every program the generate lane of ``name`` on ``server`` has
    built, the draft's included."""
    lane = server._lanes.get(name)
    if lane is None:
        return []
    progs = list(lane.gen.built_programs().values())
    if lane.draft is not None:
        progs += list(lane.draft.built_programs().values())
    return progs


def _fleet_prompts() -> list:
    """The fleet phases' 64 prompts (``default_rng(1)``): odd ones a
    1024-id shared head plus a suffix of 1-399 ids, even ones 600-1900
    ids."""
    rng = np.random.default_rng(1)
    head = rng.integers(0, LM_VOCAB, FLEET_HEAD)
    prompts = []
    for i in range(FLEET_REQUESTS):
        if i % 2:
            prompts.append(np.concatenate(
                [head, rng.integers(0, LM_VOCAB,
                                    int(rng.integers(1, FLEET_SUFFIX)))]))
        else:
            prompts.append(rng.integers(0, LM_VOCAB, int(rng.integers(
                GEN_PROMPT[0], GEN_PROMPT[1] + 1))))
    return prompts


def phase_fleet(torch, kernels, card, single) -> dict:
    """``Fleet(replicas=2)`` of ``transformer_lm`` (bf16) on the one card,
    prefix affinity fed by a ``FleetScraper`` polling every 0.25 s. Every
    replica's programs are captured first; then the counts are zeroed and
    8 closed-loop clients send 64 prompts (half a 1024-id shared head plus
    a suffix, half 600-1900 ids), 32 new tokens each; r0 is killed after
    16 answers, one ``scale_up`` follows after 24 and one ``rollout`` to a
    second version (seed 1) after 32; the counts are read after the last
    answer. Gates: every request completes or fails retryably; failovers
    >= 1; no capture after warm-up except inside ``scale_up`` and
    ``rollout`` (each replica's captures counted there); no failed request
    while the rollout runs; K3's tensor-core kernel launched exactly the
    captured launches times the replays of every replica's graphs plus one
    eager warm-up run of each graph captured during the traffic, and no
    other kernel. Then the fp32 gate (depth 2, TF32 off): the fleet's
    greedy tokens equal one ``Server``'s, and a failover restart off a
    killed prefix leader is token-identical. The same 64 prompts through
    one ``Server`` lane first give the like-for-like baseline; ``single``,
    the generate phase's plain round, is printed beside."""
    import threading
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.serve import Fleet
    from mmlspark_tpu_torch.utils import config as tconfig

    tc = kernels.FLASH_ATTENTION_TC
    for k, v in GEN_CONFIG.items():
        tconfig.set(k, v)
    prompts = _fleet_prompts()
    lengths = [len(p) for p in prompts] + [FLEET_HEAD]
    tm = TorchModel().set_model("transformer_lm", seed=0)
    same_traffic = _single_lane_round(tm, prompts, lengths)
    fleet = Fleet({"lm": tm}, replicas=2, failover_delay_s=0.0)
    scraper = FleetScraper(fleet)
    stop = threading.Event()
    scrape_ms, scrape_errors = [], []

    def poll():
        # the scrape races scale_up's change of the replica set; a failed
        # round is counted and the next one runs, as FleetScraper.start does
        while not stop.wait(FLEET_SCRAPE_S):
            try:
                scrape_ms.append(scraper.scrape()["scrape_ms"])
            except Exception as e:
                scrape_errors.append(f"{type(e).__name__}: {e}")
    try:
        capture_ms = {}
        for rep in fleet.replicas:
            lane = rep.server.enable_generate("lm")
            capture_ms[rep.name] = sum(_warm_lane(lane, lengths).values())
        captures = {r.name: r.server.registry.stats()["compiles"]
                    for r in fleet.replicas}
        programs = {id(p): p for r in fleet.replicas
                    for p in _lane_programs(r.server)}
        during = set()              # programs captured during the traffic
        finished, lock = [], threading.Lock()

        def call(p):
            t0 = time.perf_counter()
            try:
                out, status = fleet.submit_generate(
                    "lm", p, GEN_NEW_TOKENS), "ok"
            except Exception as e:
                if not getattr(e, "retryable", False):
                    raise
                out, status = None, type(e).__name__
            with lock:
                finished.append((t0, time.perf_counter(), status))
            return out

        def wait_for(n):
            while len(finished) < n and traffic.is_alive():
                time.sleep(0.005)

        result = {}

        def drive():
            try:
                result["outs"], _, result["wall"] = _closed_loop(
                    FLEET_CLIENTS, prompts, call)
            except BaseException as e:      # re-raised below
                result["error"] = e
        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        kernels.reset_launches()
        traffic = threading.Thread(target=drive, daemon=True)
        t_start = time.perf_counter()
        traffic.start()
        wait_for(FLEET_KILL_AT)
        programs.update({id(p): p for p in _lane_programs(
            fleet.replicas[0].server)})
        t_kill = time.perf_counter()
        fleet.kill(0)
        wait_for(FLEET_SCALE_AT)
        t0 = time.perf_counter()
        name = fleet.scale_up()
        scale_up_s = time.perf_counter() - t0
        new = fleet.replicas[-1]
        captures[name] = new.server.registry.stats()["compiles"]
        capture_ms[name] = sum(p.capture_s for p in _lane_programs(
            new.server)) * 1e3
        for p in _lane_programs(new.server):
            programs[id(p)] = p
            during.add(id(p))
        wait_for(FLEET_ROLLOUT_AT)
        for r in fleet.replicas[1:]:
            programs.update({id(p): p for p in _lane_programs(r.server)})
        t_roll0 = time.perf_counter()
        report = fleet.rollout("lm", TorchModel().set_model(
            "transformer_lm", seed=1), "v2")
        t_roll1 = time.perf_counter()
        for step in report["replicas"]:
            if step["status"] == "updated":
                captures[step["replica"]] = step["captures"]
                rep = next(r for r in fleet.replicas
                           if r.name == step["replica"])
                capture_ms[f"{rep.name}@v2"] = sum(
                    p.capture_s for p in _lane_programs(rep.server)) * 1e3
                for p in _lane_programs(rep.server):
                    programs[id(p)] = p
                    during.add(id(p))
        traffic.join(timeout=900)
        if "error" in result:
            raise result["error"]
        _check(not traffic.is_alive() and "outs" in result,
               "fleet traffic did not finish")
        launches = _launches(kernels)
        stop.set()
        poller.join(timeout=10)
        stats = fleet.stats()
        after = {r.name: r.server.registry.stats()["compiles"]
                 for r in fleet.replicas}
        affinity = fleet.router.affinity.stats()
    finally:
        stop.set()
        fleet.close()
    ok = [o for o in result["outs"] if o is not None]
    failed = [f for f in finished if f[2] != "ok"]
    _check(len(finished) == FLEET_REQUESTS,
           f"{len(finished)} of {FLEET_REQUESTS} fleet requests answered")
    _check(all(len(o["tokens"]) == GEN_NEW_TOKENS for o in ok),
           "a fleet request did not get its tokens")
    _check(stats["failovers"] >= 1, "the kill of r0 caused no failover")
    _check(after == captures, f"captures after warm-up: {after}, want "
                              f"{captures} (warm-up, scale_up, rollout)")
    in_rollout = [f for f in failed if t_roll0 <= f[1] <= t_roll1]
    _check(not in_rollout, f"{len(in_rollout)} requests failed during the "
                           "rollout")
    _check([s["status"] for s in report["replicas"]]
           == ["skipped_dead", "updated", "updated"],
           f"rollout report {report['replicas']}")
    want_n = sum(p.replays * p.launches.get(tc.name, (0, {}))[0]
                 for p in programs.values()) + sum(
        programs[i].launches.get(tc.name, (0, {}))[0] for i in during)
    _check(launches == _want(kernels, FLASH_ATTENTION_TC=want_n)
           and want_n > 0,
           f"fleet launched {launches}, want K3's tensor-core kernel "
           f"{want_n} times (replays plus the graphs captured during the "
           "traffic) and no other kernel")
    gate = _fleet_fp32_gate(torch, kernels, card)
    for k in GEN_CONFIG:
        tconfig.unset(k)
    ttft = [o["ttft_ms"] for o in ok]
    _line(phase="fleet", card=_smi(), model="transformer_lm",
          compute="bfloat16", replicas_founding=2, requests=FLEET_REQUESTS,
          clients=FLEET_CLIENTS, head=FLEET_HEAD, new_tokens=GEN_NEW_TOKENS,
          completed=len(ok), failed_retryably=len(failed),
          failed_by_error={e: sum(1 for f in failed if f[2] == e)
                           for e in {f[2] for f in failed}},
          failovers=stats["failovers"], all_shed=stats["all_shed"],
          launches_main_path=launches, wall_s=result["wall"],
          tokens_per_s=len(ok) * GEN_NEW_TOKENS / result["wall"],
          ttft_ms_p50=float(np.percentile(ttft, 50)),
          ttft_ms_p99=float(np.percentile(ttft, 99)),
          single_lane_generate_round={k: single[k] for k in (
              "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99")},
          single_lane_same_traffic=same_traffic,
          affinity_route_share=affinity["affinity_route_share"],
          affinity=affinity, scrapes=len(scrape_ms),
          scrape_errors=scrape_errors,
          scrape_ms_median=statistics.median(scrape_ms) if scrape_ms
          else None, scrape_ms_max=max(scrape_ms) if scrape_ms else None,
          captures=captures, capture_ms=capture_ms, scale_up_s=scale_up_s,
          rollout_s=t_roll1 - t_roll0, rollout=report["replicas"],
          kill_after_s=t_kill - t_start,
          tokens_per_s_before_kill=FLEET_KILL_AT * GEN_NEW_TOKENS
          / (t_kill - t_start),
          fp32_gate=gate["line"])
    return {"bf16": launches, "fp32": gate["launches"],
            "tokens_per_s": len(ok) * GEN_NEW_TOKENS / result["wall"],
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "single_lane_same_traffic": same_traffic}


def _single_lane_round(tm, prompts, lengths) -> dict:
    """The fleet's traffic through ONE ``Server`` lane (programs captured
    first, no kill, no scale or rollout): the fleet's like-for-like
    baseline. Returns tokens/s and TTFT p50/p99."""
    from mmlspark_tpu_torch.serve import Server
    srv = Server({"lm": tm})
    try:
        _warm_lane(srv.enable_generate("lm"), lengths)
        outs, _, wall = _closed_loop(
            FLEET_CLIENTS, prompts,
            lambda p: srv.generate("lm", p, max_new_tokens=GEN_NEW_TOKENS,
                                   timeout=600))
    finally:
        srv.close()
    ttft = [o["ttft_ms"] for o in outs]
    return {"wall_s": wall,
            "tokens_per_s": len(prompts) * GEN_NEW_TOKENS / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99))}


def _fleet_fp32_gate(torch, kernels, card) -> dict:
    """fp32 (TF32 off), depth 2: 4 prompts through one ``Server`` and
    through ``Fleet(replicas=2)``: greedy tokens EQUAL; then r0 alone
    prefills a prompt, a scrape advertises it, r0 is killed, and the
    routed request restarts on r1 with tokens EQUAL to the Server's."""
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability.aggregate import FleetScraper
    from mmlspark_tpu_torch.serve import Fleet, Server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(2)
    # the last prompt is the failover restart's, served by r0 alone first
    prompts = [rng.integers(0, LM_VOCAB, int(n)) for n in rng.integers(
        GEN_F32_PROMPT[0], GEN_F32_PROMPT[1] + 1, FLEET_F32_PROMPTS + 1)]
    tm = TorchModel().set_model("transformer_lm", seed=0, dtype="float32",
                                depth=GEN_F32_DEPTH)
    srv = Server({"lm32": tm})
    try:
        want = [srv.generate("lm32", p, max_new_tokens=GEN_NEW_TOKENS,
                             timeout=300)["tokens"] for p in prompts]
    finally:
        srv.close()
    fleet = Fleet({"lm32": tm}, replicas=2, failover_delay_s=0.0)
    try:
        kernels.reset_launches()
        got = [fleet.submit_generate("lm32", p, GEN_NEW_TOKENS)["tokens"]
               for p in prompts[:-1]]
        launches = _launches(kernels)
        _check(got == want[:-1], "fp32 fleet tokens differ from one "
                                 f"Server's: {_agreement(got, want[:-1])}")
        fleet.replicas[0].server.generate("lm32", prompts[-1],
                                          max_new_tokens=1, timeout=300)
        FleetScraper(fleet).scrape()
        fleet.router.route_log = log = []
        fleet.kill(0)
        restarted = fleet.submit_generate("lm32", prompts[-1],
                                          GEN_NEW_TOKENS)["tokens"]
        failovers = fleet.stats()["failovers"]
    finally:
        fleet.close()
    _check(log == ["r1"] and failovers >= 1 and restarted == want[-1],
           f"fp32 failover restart: routed {log}, {failovers} failovers, "
           f"tokens equal {restarted == want[-1]}")
    _check(launches[kernels.FLASH_ATTENTION.name] > 0,
           f"fp32 fleet launched {launches}: no K3 CUDA-core launch")
    return {"launches": launches,
            "line": {"depth": GEN_F32_DEPTH, "tf32": "off",
                     "prompt_lengths": [len(p) for p in prompts],
                     "tokens_equal_one_server": True,
                     "failover_restart_token_identical": True,
                     "launches": launches}}


class _GroupSpawner:
    """The port's ``ProcessSpawner`` with each worker in a process group of
    its own (``start_new_session``), so that a stray worker and anything it
    started can be killed as a group; keeps every worker it spawned."""

    def __init__(self, spawner):
        self.spawner = spawner
        self.workers = []

    def spawn(self, name):
        import functools
        from mmlspark_tpu_torch.serve import ProcessWorker
        sp = self.spawner
        os.makedirs(sp.events_dir, exist_ok=True)
        w = ProcessWorker(
            name, sp.build_argv(name), env=sp.build_env(name),
            log_path=os.path.join(sp.events_dir, f"worker-{name}.log"),
            popen=functools.partial(subprocess.Popen,
                                    start_new_session=True))
        self.workers.append(w)
        return w

    def kill_all(self) -> None:
        import signal
        for w in self.workers:
            if w.poll() is None:
                try:
                    os.killpg(w.pid, signal.SIGKILL)
                except OSError:
                    pass
                w.wait(10.0)


def _worker_stats(replica) -> dict:
    """A worker's ``Server.stats()``, from its ``/healthz``."""
    import urllib.request
    with urllib.request.urlopen(f"{replica.addr}/healthz",
                                timeout=30) as resp:
        return json.loads(resp.read().decode("utf-8"))["stats"]


def _worker_events(events_dir, pid) -> list:
    path = os.path.join(events_dir, f"events-{pid}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _implied_launches(report, per_prefill) -> dict:
    """The K3 launches a drained worker's programs imply, by kernel name:
    each program's recorded launches times its replays, plus one eager run
    for each graph captured. Every prefill graph at a bucket of 512 or
    more must record exactly ``per_prefill[model]`` = (kernel, count), and
    every other program none."""
    want = {}
    for p in report["programs"]:
        rec = p["launches"]
        if p["kind"] == "prefill" and p["bucket"] >= 512 and p["graph"]:
            kernel, n = per_prefill[p["model"]]
            _check(rec == {kernel: n},
                   f"{p['model']} prefill at {p['bucket']} records {rec}, "
                   f"want {{{kernel!r}: {n}}}")
        else:
            _check(not rec, f"{p['model']} {p['kind']} at {p['bucket']} "
                            f"records {rec}, want no launch")
        for kernel, n in rec.items():
            want[kernel] = want.get(kernel, 0) + n * (
                p["replays"] + (1 if p["graph"] else 0))
    return want


def phase_process_fleet(torch, kernels, card, fleet) -> dict:
    """The process fleet as ``cli fleet`` builds it, through the library:
    ``ProcessSpawner`` -> ``Supervisor`` -> ``Router`` -> ``ProcessFleet``.
    Two worker processes ``w0``, ``w1`` on the one card
    (``devices_per_worker`` 0, each with its own CUDA context), each serving
    ``lm`` (the fleet phase's bf16 ``transformer_lm``) and ``lm32`` (fp32,
    depth 2) behind its own HTTP front. After one warm round per worker and
    model, 8 closed-loop clients send the fleet phase's 64 prompts through
    the ``Router``, retrying a retryable failure; at request 24 ``w1`` is
    SIGKILLed, and an ``Autopilot(ProcessFleet)`` ticked on an injected
    clock with ``min_replicas`` 3 repairs below its minimum through
    ``Supervisor.add_slot`` (``w2``) while the supervisor restarts ``w1``.
    After the traffic, ``min_replicas`` 2 and the clock past the scale
    cooldown make the idle rule retire ``w2`` (SIGTERM drain), and
    ``shutdown`` drains the rest. Gates: every request answered; the
    ``lm32`` greedy tokens of every worker (``w1`` before and after its
    restart, and ``w2``) EQUAL an in-process ``Server``'s (TF32 off, and
    off in every worker); ``w1`` back under a new pid at full weight; the
    ``scale_up`` and ``scale_down`` decisions actuated with no ``error``;
    ``w2`` exits 0; ``kernels/_build`` lists the same files before and
    after (no worker ran nvcc); every spawned worker reaped; each drained
    worker's K3 launches (its ``serving.summary`` event) EQUAL what its own
    prefill replays and captures imply, on both routes."""
    import shutil
    import tempfile
    import threading
    from mmlspark_tpu_torch.control.autopilot import Autopilot, AutopilotPolicy
    from mmlspark_tpu_torch.kernels import build as kbuild
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability import events as tevents
    from mmlspark_tpu_torch.observability.slo import SloEngine
    from mmlspark_tpu_torch.serve import (
        ProcessFleet, ProcessSpawner, Router, Server, Supervisor,
    )
    from mmlspark_tpu_torch.utils import config as tconfig

    tc, f32 = kernels.FLASH_ATTENTION_TC, kernels.FLASH_ATTENTION
    build_before = sorted(os.listdir(kbuild.BUILD_DIR))
    # the workers' event sidecars and logs; kept (and named on stderr)
    # when a check fails, removed when the phase passes
    events_dir = tempfile.mkdtemp(prefix="chip_smoke_process_fleet-")
    print(f"process_fleet: worker events and logs in {events_dir}",
          file=sys.stderr, flush=True)
    prompts = _fleet_prompts()
    rng = np.random.default_rng(2)
    prompts32 = [rng.integers(0, LM_VOCAB, int(n)) for n in rng.integers(
        GEN_F32_PROMPT[0], GEN_F32_PROMPT[1] + 1, PF_F32_PROMPTS)]
    lm32 = {"seed": 0, "dtype": "float32", "depth": GEN_F32_DEPTH}
    for k, v in GEN_CONFIG.items():
        tconfig.set(k, v)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    srv = Server({"lm32": TorchModel().set_model("transformer_lm", **lm32)})
    try:
        want32 = [srv.generate("lm32", p, max_new_tokens=GEN_NEW_TOKENS,
                               timeout=300)["tokens"] for p in prompts32]
    finally:
        srv.close()
    env = {"MMLSPARK_TPU_TORCH_" + k.replace(".", "_").upper(): str(v)
           for k, v in GEN_CONFIG.items()}
    spawner = _GroupSpawner(ProcessSpawner(
        ["lm=transformer_lm:" + json.dumps(PF_LM),
         "lm32=transformer_lm:" + json.dumps(lm32)],
        events_dir=events_dir, env=env, devices_per_worker=0))
    sup_events = os.path.join(events_dir, f"events-{os.getpid()}.jsonl")
    tconfig.set("observability.events_path", sup_events)
    sup = Supervisor(spawner, ["w0", "w1"])
    router = None
    try:
        t0 = time.perf_counter()
        sup.start()
        start_s = time.perf_counter() - t0
        _check(sup.stats()["live_replicas"] == 2,
               f"workers did not start: {sup.stats()}")
        router = Router(sup.replicas, failover_delay_s=0.0)
        pfleet = ProcessFleet(sup, router)
        sup.start_monitor(poll_s=0.1)

        def fp32_tokens(name):
            rep = sup.replica(name)
            return [rep.submit_generate("lm32", p, GEN_NEW_TOKENS)["tokens"]
                    for p in prompts32]

        def warm(name):
            # one request per model and prefill bucket the traffic uses:
            # the lane captures are paid here, apart from the traffic
            rep, t = sup.replica(name), time.perf_counter()
            for p in (prompts[0], prompts[1], prompts[2]):
                rep.submit_generate("lm", p, 2)
            got32 = fp32_tokens(name)
            return (time.perf_counter() - t) * 1e3, got32

        warm_ms, tokens32 = {}, {}
        for name in ("w0", "w1"):
            warm_ms[name], tokens32[name] = warm(name)
        captures = {n: _worker_stats(sup.replica(n))["registry.compiles"]
                    for n in ("w0", "w1")}
        finished, lock, retried = [], threading.Lock(), []

        def call(p):
            for attempt in range(PF_ATTEMPTS):
                try:
                    out = router.submit_generate("lm", p, GEN_NEW_TOKENS)
                    break
                except Exception as e:
                    if not getattr(e, "retryable", False) \
                            or attempt == PF_ATTEMPTS - 1:
                        raise
                    with lock:
                        retried.append(type(e).__name__)
                    time.sleep(0.05)
            with lock:
                finished.append(time.perf_counter())
            return out

        result = {}

        def drive():
            try:
                result["outs"], _, result["wall"] = _closed_loop(
                    PF_CLIENTS, prompts, call)
            except BaseException as e:      # re-raised below
                result["error"] = e
        traffic = threading.Thread(target=drive, daemon=True)
        t_start = time.perf_counter()
        traffic.start()
        while len(finished) < PF_KILL_AT and traffic.is_alive():
            time.sleep(0.005)
        old_pid = sup.pid("w1")
        t_kill = time.perf_counter()
        _check(sup.kill_replica("w1") == old_pid, "w1 was not killed")
        vclock = {"t": 1000.0}
        pilot = Autopilot(pfleet, engine=SloEngine([]),
                          policy=AutopilotPolicy(min_replicas=3,
                                                 max_replicas=3),
                          clock=lambda: vclock["t"])
        t0 = time.perf_counter()
        ups = pilot.tick()
        scale_up_s = time.perf_counter() - t0
        t_up = time.perf_counter()
        deadline = time.perf_counter() + 300.0
        while sup.stats()["replicas"]["w1"]["ready_spawns"] < 2 \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        t_restarted = time.perf_counter()
        traffic.join(timeout=900)
        if "error" in result:
            raise result["error"]
        _check(not traffic.is_alive() and "outs" in result,
               "process fleet traffic did not finish")
        _check(sup.stats()["replicas"]["w1"]["ready_spawns"] == 2,
               f"w1 was not restarted: {sup.stats()['replicas']['w1']}")
        new_pid = sup.pid("w1")
        weights = {n: r["weight"]
                   for n, r in router.stats()["replicas"].items()}
        # the restarted w1 and the new w2 serve both models: the warm
        # round again (the traffic may have ended before they were up)
        for key, name in (("w1_restarted", "w1"), ("w2", "w2")):
            warm_ms[key], tokens32[key] = warm(name)
        captures_after = {
            n: _worker_stats(sup.replica(n))["registry.compiles"]
            for n in ("w0", "w1", "w2")}
        failovers = router.stats()["failovers"]
        w2 = next(w for w in spawner.workers if w.name == "w2")
        pilot.policy = AutopilotPolicy(min_replicas=2, max_replicas=3)
        vclock["t"] += pilot.policy.scale_cooldown_s + 1.0
        t0 = time.perf_counter()
        downs = pilot.tick()
        retire_s = time.perf_counter() - t0
        w2_rc = w2.poll()
        t0 = time.perf_counter()
        sup.shutdown(reason="chip_smoke")
        shutdown_s = time.perf_counter() - t0
        reaped = [w.poll() is not None for w in spawner.workers]
        worker_rcs = {f"{w.name}:{w.pid}": w.poll()
                      for w in spawner.workers}
        sup_stats = sup.stats()
    finally:
        tconfig.unset("observability.events_path")
        tevents.close()
        if router is not None:
            router.close()
        sup.shutdown(reason="chip_smoke")
        spawner.kill_all()
        for k in GEN_CONFIG:
            tconfig.unset(k)
    outs = result["outs"]
    _check(len(finished) == PF_REQUESTS and all(
        o is not None and len(o["tokens"]) == GEN_NEW_TOKENS for o in outs),
        f"{len(finished)} of {PF_REQUESTS} process fleet requests answered")
    for name, got in tokens32.items():
        _check(got == want32, f"process fleet {name}: fp32 tokens differ "
                              f"from one Server's: {_agreement(got, want32)}")
    _check(new_pid not in (None, old_pid) and weights.get("w1") == 1.0,
           f"w1 restart: pid {old_pid} -> {new_pid}, weights {weights}")
    up = [d for d in ups if d["action"] == "scale_up"]
    down = [d for d in downs if d["action"] == "scale_down"]
    _check(len(up) == 1 and not up[0]["suppressed"]
           and "error" not in up[0] and up[0].get("replica") == "w2",
           f"autopilot scale_up: {ups}")
    _check(len(down) == 1 and not down[0]["suppressed"]
           and "error" not in down[0] and down[0]["target"] == "w2",
           f"autopilot scale_down: {downs}")
    _check(w2_rc == 0, f"the retired w2 exited {w2_rc}, want 0 (drained)")
    _check(all(reaped), f"workers alive after shutdown: {worker_rcs}")
    build_after = sorted(os.listdir(kbuild.BUILD_DIR))
    _check(build_after == build_before,
           f"kernels/_build changed: {build_before} -> {build_after}")
    per_prefill = {"lm": (tc.name, LM_DEPTH), "lm32": (f32.name,
                                                       GEN_F32_DEPTH)}
    drained, memory, launches = {}, {}, {tc.name: 0, f32.name: 0}
    for w in spawner.workers:
        if w.pid == old_pid:
            continue                # SIGKILLed: it wrote no summary
        summaries = [e for e in _worker_events(events_dir, w.pid)
                     if e["type"] == "serving" and e["name"] == "summary"]
        _check(len(summaries) == 1, f"worker {w.name} pid {w.pid}: "
                                    f"{len(summaries)} summaries")
        report = summaries[0]["device"]
        want = _implied_launches(report, per_prefill)
        got = {k: n for k, n in report["launches"].items() if n}
        _check(got == want and want.get(tc.name, 0) > 0
               and want.get(f32.name, 0) > 0,
               f"worker {w.name} pid {w.pid} launched {got}, its replays "
               f"imply {want}")
        _check(report["tf32_matmul"] is False,
               f"worker {w.name} runs matmuls in TF32")
        for k in launches:
            launches[k] += got.get(k, 0)
        drained[f"{w.name}:{w.pid}"] = got
        memory[f"{w.name}:{w.pid}"] = {
            k: v / 2**20 for k, v in report["memory_bytes"].items()}
    sup_evs = _worker_events(events_dir, os.getpid())
    ready = [{"replica": e["replica"], "attempt": e["attempt"],
              "spawn_to_ready_ms": e["spawn_to_ready_ms"]}
             for e in sup_evs if e["type"] == "supervisor"
             and e["name"] == "ready"]
    ttft = [o["ttft_ms"] for o in outs]
    _line(phase="process_fleet", card=_smi(), model="transformer_lm",
          compute="bfloat16", workers_founding=2, devices_per_worker=0,
          requests=PF_REQUESTS, clients=PF_CLIENTS,
          new_tokens=GEN_NEW_TOKENS, completed=len(outs),
          client_retries=len(retried),
          client_retries_by_error={e: retried.count(e) for e in
                                   set(retried)},
          failovers=failovers, wall_s=result["wall"],
          tokens_per_s=len(outs) * GEN_NEW_TOKENS / result["wall"],
          ttft_ms_p50=float(np.percentile(ttft, 50)),
          ttft_ms_p99=float(np.percentile(ttft, 99)),
          in_process_fleet={k: fleet[k] for k in (
              "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99")},
          single_lane_same_traffic=fleet["single_lane_same_traffic"],
          start_s=start_s, spawn_to_ready_ms=ready, warm_ms=warm_ms,
          captures_after_warm=captures, captures_after_traffic=captures_after,
          kill_after_s=t_kill - t_start, killed_pid=old_pid,
          restarted_pid=new_pid, weights_after_restart=weights,
          scale_up_tick_s=scale_up_s,
          scale_up_done_before_traffic_end=t_up <= max(finished),
          restart_seen_after_kill_s=t_restarted - t_kill,
          traffic_end_after_kill_s=max(finished) - t_kill,
          retire_tick_s=retire_s, w2_rc=w2_rc, shutdown_s=shutdown_s,
          worker_rcs=worker_rcs, supervisor=sup_stats,
          device_memory_mib_by_worker=memory,
          fp32_gate={"depth": GEN_F32_DEPTH, "tf32": "off",
                     "prompt_lengths": [len(p) for p in prompts32],
                     "tokens_equal_one_server": sorted(tokens32)},
          kernels_build_unchanged=True, launches_drained_workers=drained,
          launches_note="each drained worker's own counts (serving.summary "
                        "at its drain); the SIGKILLed w1 incarnation wrote "
                        "none and is not counted")
    shutil.rmtree(events_dir, ignore_errors=True)
    return launches

# -- stream_resume: streamed input, checkpoints and crash-safe resume -------

def _stream_spec(work: str, deep: bool = True, **overrides) -> dict:
    """What the three children of ``stream_resume`` share: the corpus, the
    checkpoint directories and the constants (children read them from here,
    so a shrunken rehearsal shrinks the children too)."""
    spec = dict(corpus=os.path.join(work, "corpus"),
                ckpt_a=os.path.join(work, "ckpt_A"),
                ckpt_b=os.path.join(work, "ckpt_B"),
                files=SR_FILES, batch=SR_BATCH, steps=SR_STEPS,
                save_every=SR_SAVE_EVERY, kill_at=SR_KILL_AT,
                window=SR_WINDOW, workers=SR_WORKERS, deep=deep,
                deep_rows=DEEP_ROWS, deep_features=DEEP_FEATURES,
                deep_every=SR_DEEP_EVERY, deep_fault_at=SR_DEEP_FAULT_AT,
                deep_a=os.path.join(work, "deep_A"),
                deep_b=os.path.join(work, "deep_B"),
                events=os.path.join(work, "events_C.jsonl"))
    spec.update(overrides)
    return spec


def _write_corpus(spec) -> None:
    """The train cell's images and labels (``default_rng(0)``, as the train
    phase draws them) as PNG files, the label in each file's name."""
    from mmlspark_tpu_torch.io.codecs import encode_png
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (spec["files"], math.prod(TRAIN_SHAPE)),
                          dtype=np.uint8)
    labels = rng.integers(0, 10, spec["files"])
    os.makedirs(spec["corpus"], exist_ok=True)
    for i, (img, lab) in enumerate(zip(images, labels)):
        with open(os.path.join(spec["corpus"], f"{i:05d}_{lab}.png"),
                  "wb") as f:
            f.write(encode_png(img.reshape(TRAIN_SHAPE)))


def _stream_dataset(spec, process_shard=False):
    """FileSource -> shuffle -> decode -> map(uint8 flat + label) ->
    batch(drop) -> repeat: the stream_resume main path's input (with
    ``process_shard``, of this rank's share of the files)."""
    from mmlspark_tpu_torch.data import FileSource

    def to_row(rec):
        label = int(os.path.basename(rec["path"]).split("_")[1][:-4])
        return {"image": rec["image"].reshape(-1), "label": np.int64(label)}
    return (FileSource(spec["corpus"], process_shard=process_shard)
            .shuffle(window=spec["window"], seed=0)
            .decode(workers=spec["workers"])
            .map(to_row)
            .batch(spec["batch"], remainder="drop")
            .repeat())


def _stream_lane(torch, ckpt_dir, save_every):
    """ResNet-20 CIFAR at full width (bf16, random weights from seed 0),
    sgd(0.1, momentum 0.9), K1 in the loss, behind a ResilientTrainLoop
    over a TrainCheckpointer in ``ckpt_dir``."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.ops.preprocess import make_preprocess_fn
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop

    pre = make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN, CIFAR_STD)
    weights = {}

    def init_fn():
        module = build_model("resnet20_cifar", num_classes=10,
                             dtype="bfloat16")["module"]
        if not weights:
            weights.update(init_state(module, seed=0))
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in weights.items()})
        return module

    def loss_fn(module, batch, gen):
        logits = module(pre(batch["image"])).float()
        return F.cross_entropy(logits, batch["label"].long())
    trainer = DistributedTrainer(loss_fn, sgd(0.1, momentum=0.9))
    ckpt = TrainCheckpointer(ckpt_dir)
    return ResilientTrainLoop(trainer, ckpt, init_fn, save_every=save_every)


def _host_copy(torch, obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(torch, v) for v in obj)
    return obj


def _dump_train_state(torch, state, path) -> None:
    """The live state a resume must reproduce, on the host: module,
    optimizer, its counts and the step."""
    opt = state["optimizer"]
    torch.save(_host_copy(torch, {
        "module": state["module"].state_dict(),
        "optimizer": opt.torch.state_dict(),
        "count": opt.count, "step": int(state["step"])}), path)


def _unequal(torch, a, b, where="") -> list:
    """Where two nests of tensors and scalars differ, bit for bit (with
    the largest |difference| of each differing tensor)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return [f"{where}: {a.dtype}{tuple(a.shape)} vs "
                    f"{b.dtype}{tuple(b.shape)}"]
        if torch.equal(a, b):
            return []
        return [f"{where}: max |diff| "
                f"{float((a.double() - b.double()).abs().max())}"]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{where}: keys {sorted(map(str, a))} vs "
                    f"{sorted(map(str, b))}"]
        return [d for k in a for d in _unequal(torch, a[k], b[k],
                                                f"{where}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{where}: lengths {len(a)} vs {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _unequal(torch, x, y, f"{where}[{i}]")]
    return [] if a == b else [f"{where}: {a!r} vs {b!r}"]


def _deep_frame(spec, staging):
    """The deep cell's 65,536 x 128 frame (``default_rng(5)``, as the deep
    phase draws it), staged by ``CheckpointData(diskIncluded=True)``."""
    from mmlspark_tpu_torch.core.disk import DiskFrame
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.stages.stages import CheckpointData
    rng = np.random.default_rng(5)
    X = rng.normal(size=(spec["deep_rows"], spec["deep_features"])
                   ).astype(np.float32)
    y = (X @ rng.normal(size=spec["deep_features"]) > 0).astype(np.int64)
    frame = Frame.from_dict({"features": X, "label": y}, num_partitions=4)
    disk = CheckpointData(diskIncluded=True,
                          checkpointDir=staging).transform(frame)
    _check(isinstance(disk, DiskFrame),
           f"CheckpointData(diskIncluded=True) gave a {type(disk).__name__}")
    return disk


def _deep_fit(spec, frame, ckpt_dir):
    """DeepClassifier over the DiskFrame, streamed (deviceCache 'off': the
    two-level DiskFrame shuffle), checkpointing every ``deep_every``
    steps into ``ckpt_dir``; returns the fitted params."""
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    learner = DeepClassifier(architecture="mlp_tabular", batchSize=256,
                             epochs=2, deviceCache="off",
                             checkpointDir=ckpt_dir,
                             checkpointEvery=spec["deep_every"])
    learner.set_params(featuresCol="features", labelCol="label")
    return learner.fit(frame)._state["params"]


def stream_child(spec: dict) -> int:
    """One child of ``stream_resume`` (``--stream-child ROLE SPEC``): a
    fresh process in deterministic mode. A trains the streamed ResNet-20
    run and the deep fit uninterrupted; B stops a deep fit by an injected
    fault, then trains the streamed run until its parent SIGKILLs it; C
    resumes both from B's directories. C starts beside A and B and, once
    its imports and CUDA context are up, waits for the parent's word (a
    line on stdin) that B is dead: its start-up is measured, not waited
    for. Each prints JSON lines (a ``child_step`` line per step with K1's
    launches so far) and dumps its final state for the parent to
    compare; the parent holds the gates."""
    t_spawn = float(os.environ.get("SMOKE_SPAWN_T", time.time()))
    import torch
    t_torch = time.time()
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t_flags = time.time()
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.reliability.faults import (
        FaultPlan, FaultSpec, InjectedFault,
    )
    from mmlspark_tpu_torch.utils.config import resolve_device
    t_imported = time.time()
    device = resolve_device()
    torch.zeros(1, device=device)
    syncs.synchronize("smoke.child_context", device)
    t_context = time.time()
    role = spec["role"]
    if role == "C":
        _line(child=role, ready=True)
        if sys.stdin.readline().strip() != "go":
            return 1            # the parent went away before B's kill
    t_go = time.time()
    work = os.path.dirname(spec["corpus"])
    t_deep_b = time.perf_counter()
    if role == "B" and spec["deep"]:
        frame = _deep_frame(spec, os.path.join(work, "frame_B"))
        with FaultPlan(FaultSpec("trainer.train_step",
                                 on_hit=spec["deep_fault_at"])):
            try:
                _deep_fit(spec, frame, spec["deep_b"])
            except InjectedFault:
                pass
            else:
                raise RuntimeError("the deep fit was not stopped")
        _line(child=role, deep_stopped_at=spec["deep_fault_at"],
              deep_s=time.perf_counter() - t_deep_b)

    loop = _stream_lane(torch, spec["ckpt_a"] if role == "A"
                        else spec["ckpt_b"], spec["save_every"])
    k1 = kernels.FUSED_NORMALIZE
    marks = {}
    real_restore = loop.restore_or_init

    def restore_or_init():
        marks["restore_t0"] = time.time()
        out = real_restore()
        marks["restore_t1"] = time.time()
        marks["start"] = out[1]
        return out
    loop.restore_or_init = restore_or_init
    it = _stream_dataset(spec).iter()
    real_load = it.load_state_dict

    def load_state_dict(snapshot):
        marks["seek_t0"] = time.time()
        real_load(snapshot)
        marks["seek_t1"] = time.time()
        marks["snapshot"] = snapshot
    it.load_state_dict = load_state_dict
    real_step = loop.trainer.train_step
    done = [0]

    def train_step(state, batch, rng=None):
        out = real_step(state, batch, rng)
        done[0] += 1
        if done[0] == 1:
            syncs.synchronize("smoke.child_first_step", device)
            marks["first_step_t"] = time.time()
        _line(child_step=marks["start"] + done[0], k1=k1.launches)
        return out
    loop.trainer.train_step = train_step

    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    t_run = time.perf_counter()
    state = loop.run_dataset(it, spec["steps"])
    launches = _launches(kernels)
    run_s = time.perf_counter() - t_run
    loop.ckpt.close()
    _dump_train_state(torch, state, os.path.join(work, f"final_{role}.pt"))
    out = dict(child=role, start=marks["start"], steps_run=done[0],
               launches=launches, device=str(device),
               deterministic=torch.are_deterministic_algorithms_enabled(),
               snapshot=marks.get("snapshot"),
               run_dataset_s=run_s,
               interpreter_ms=(_T_MODULE - t_spawn) * 1e3,
               torch_import_ms=(t_torch - _T_MODULE) * 1e3,
               deterministic_flags_ms=(t_flags - t_torch) * 1e3,
               package_import_ms=(t_imported - t_flags) * 1e3,
               imports_ms=(t_imported - t_spawn) * 1e3,
               cuda_context_ms=(t_context - t_imported) * 1e3,
               restore_ms=(marks["restore_t1"] - marks["restore_t0"]) * 1e3,
               seek_ms=((marks["seek_t1"] - marks["seek_t0"]) * 1e3
                        if "seek_t0" in marks else 0.0),
               # C's wait for B's death is left out
               spawn_to_first_step_ms=(marks["first_step_t"] - t_go
                                       + t_context - t_spawn) * 1e3
               if "first_step_t" in marks else None)
    if spec["deep"]:
        deep_dir = spec["deep_a"] if role == "A" else spec["deep_b"]
        listed = _listed_steps(deep_dir) if os.path.isdir(deep_dir) else []
        out["deep_resumed_from"] = listed[-1] if listed else None
        t_deep = time.perf_counter()
        frame = _deep_frame(spec, os.path.join(work, f"frame_{role}"))
        params = _deep_fit(spec, frame, deep_dir)
        out["deep_s"] = time.perf_counter() - t_deep
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in params.items()},
                   os.path.join(work, f"deep_{role}.pt"))
    _line(**out)
    return 0


def _spawn_child(spec, role, log_dir, stdin=None):
    env = dict(os.environ)
    # cuBLAS picks a deterministic workspace only if told before CUDA starts
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    env["SMOKE_SPAWN_T"] = repr(time.time())
    if role == "C":
        env["MMLSPARK_TPU_TORCH_OBSERVABILITY_EVENTS_PATH"] = spec["events"]
    err = open(os.path.join(log_dir, f"child_{role}.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--stream-child",
         json.dumps(dict(spec, role=role))],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdin=stdin, stdout=subprocess.PIPE, stderr=err, text=True)
    proc.err_file = err
    return proc


def _child_lines(proc, until=None) -> list:
    """JSON lines from a child's stdout until it exits, or until
    ``until(line)`` holds (the child keeps running). A child that runs
    past ``SR_CHILD_TIMEOUT_S`` is killed."""
    import threading
    timer = threading.Timer(SR_CHILD_TIMEOUT_S, proc.kill)
    timer.start()
    lines = []
    try:
        for raw in proc.stdout:
            raw = raw.strip()
            if not raw.startswith("{"):
                continue
            lines.append(json.loads(raw))
            if until is not None and until(lines[-1]):
                break
    finally:
        timer.cancel()
    return lines


def _listed_steps(directory) -> list:
    """The committed steps of a checkpoint directory (bare-integer
    names), without opening a checkpointer (which would sweep it)."""
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def _stream_children(torch, kernels, spec, log_dir) -> dict:
    """Start A, B and C together, SIGKILL B once it reports step >=
    kill_at, then let C (ready and waiting) resume from B's directories;
    hold the resume gates. Returns each child's report, B's directory as C
    found it and the comparisons."""
    import signal
    procs = {}
    try:
        procs["A"] = _spawn_child(spec, "A", log_dir)
        procs["B"] = _spawn_child(spec, "B", log_dir)
        procs["C"] = _spawn_child(spec, "C", log_dir, stdin=subprocess.PIPE)
        b_lines = _child_lines(
            procs["B"], until=lambda ln: ln.get("child_step", -1)
            >= spec["kill_at"])
        os.kill(procs["B"].pid, signal.SIGKILL)
        procs["B"].wait(timeout=60)
        a_lines = _child_lines(procs["A"])
        _check(procs["A"].wait(timeout=60) == 0, "child A failed (see "
               f"{log_dir}/child_A.err)")
        b_steps = [ln for ln in b_lines if "child_step" in ln]
        _check(bool(b_steps) and b_steps[-1]["child_step"] >= spec["kill_at"],
               f"child B exited before step {spec['kill_at']} (see "
               f"{log_dir}/child_B.err)")
        # B's directory as the kill left it
        names = sorted(os.listdir(spec["ckpt_b"]))
        b_listed = _listed_steps(spec["ckpt_b"])
        unreadable = []
        for s in b_listed:
            try:
                torch.load(os.path.join(spec["ckpt_b"], str(s), "state.pt"),
                           map_location="cpu", weights_only=True)
            except Exception as e:          # noqa: BLE001 - reported below
                unreadable.append((s, f"{type(e).__name__}: {e}"))
        b_dir = dict(names=names, listed_steps=b_listed,
                     torn_writes=[n for n in names if ".tmp-" in n],
                     unreadable=unreadable)
        _check(_child_lines(procs["C"], until=lambda ln: ln.get("ready"))
               != [], f"child C never got ready (see {log_dir}/child_C.err)")
        procs["C"].stdin.write("go\n")
        procs["C"].stdin.close()
        c_lines = _child_lines(procs["C"])
        _check(procs["C"].wait(timeout=60) == 0, "child C failed (see "
               f"{log_dir}/child_C.err)")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p.err_file.close()
    a = next(ln for ln in a_lines if "launches" in ln)
    c = next(ln for ln in c_lines if "launches" in ln)
    fallbacks = []
    if os.path.exists(spec["events"]):
        with open(spec["events"]) as f:
            fallbacks = [e for e in map(json.loads, f)
                         if e.get("name") == "restore.fallback"]
    k1 = "fused_normalize"
    steps, per_epoch = spec["steps"], spec["files"] // spec["batch"]

    # gates: the uninterrupted child ran every step through K1
    _check(a["start"] == 0 and a["steps_run"] == steps
           and a["launches"] == _want(kernels, FUSED_NORMALIZE=steps),
           f"child A: start {a['start']}, {a['steps_run']} steps, "
           f"launches {a['launches']} (want 0, {steps}, K1 {steps} and no "
           "other kernel)")
    _check(all(ln["k1"] == ln["child_step"] for ln in b_steps),
           f"child B: K1 launches off its steps: {b_steps[-3:]}")
    # C resumed from B's newest committed step (at or after the last
    # cadence step before the kill report) or, if that step did not load,
    # from the next one after a restore.fallback
    quarantined = [e["step"] for e in fallbacks]
    usable = [s for s in b_listed if s not in quarantined]
    _check(set(quarantined) <= {s for s, _ in unreadable} | set(b_listed),
           f"C quarantined {quarantined}, B listed {b_listed}")
    _check(not unreadable or {s for s, _ in unreadable} <= set(quarantined),
           f"B's directory holds unreadable steps {unreadable} that C did "
           "not quarantine")
    _check(bool(usable) and c["start"] == max(usable)
           and c["start"] >= spec["kill_at"] // spec["save_every"]
           * spec["save_every"],
           f"child C resumed from {c['start']}, B's committed steps "
           f"{b_listed} (quarantined {quarantined})")
    snap = c["snapshot"]
    _check(snap is not None and snap["epoch"] == c["start"] // per_epoch
           and (c["start"] % per_epoch == 0 or snap["items"] > 0),
           f"child C's data snapshot {snap} for step {c['start']}")
    _check(c["steps_run"] == steps - c["start"]
           and c["launches"] == _want(kernels,
                                      FUSED_NORMALIZE=c["steps_run"]),
           f"child C ran {c['steps_run']} steps with {c['launches'][k1]} K1 "
           f"launches, want {steps - c['start']} (restore launches none)")
    after = sorted(os.listdir(spec["ckpt_b"]))
    _check(not [n for n in after if ".tmp-" in n]
           and _listed_steps(spec["ckpt_b"])[-1:] == [steps],
           f"B's directory after C: {after}")
    # the bit-equality gate: C's final state is A's
    diff = _unequal(torch, torch.load(os.path.join(log_dir, "final_A.pt"),
                                      weights_only=True),
                    torch.load(os.path.join(log_dir, "final_C.pt"),
                               weights_only=True))
    _check(not diff, f"resumed ResNet-20 state differs from the "
                     f"uninterrupted run's: {diff[:8]}")
    deep = None
    if spec["deep"]:
        ddiff = _unequal(torch, torch.load(os.path.join(log_dir, "deep_A.pt"),
                                           weights_only=True),
                         torch.load(os.path.join(log_dir, "deep_C.pt"),
                                    weights_only=True))
        deep = dict(resumed_from=c["deep_resumed_from"],
                    stopped_at_hit=spec["deep_fault_at"],
                    checkpoint_every=spec["deep_every"],
                    params_bit_equal=not ddiff)
        _check(c["deep_resumed_from"] is not None
               and 0 < c["deep_resumed_from"] < spec["deep_fault_at"],
               f"the deep refit resumed from {c['deep_resumed_from']}")
        _check(not ddiff, f"resumed DeepClassifier params differ: "
                          f"{ddiff[:8]}")
    return dict(A=a, B=dict(steps_reported=b_steps[-1]["child_step"],
                            k1=b_steps[-1]["k1"], killed_at=b_steps[-1]
                            ["child_step"]),
                C=c, b_dir=b_dir, quarantined=quarantined,
                state_bit_equal=True, deep=deep)


def _rows_per_s(torch, spec, save_every, work) -> dict:
    """One timed run_dataset of SR_TIMED_STEPS steps (an epoch) over the
    corpus from a fresh lane (normal mode), from the pipeline's start to
    its final checkpoint's commit."""
    import shutil
    d = os.path.join(work, f"timed_{save_every}")
    shutil.rmtree(d, ignore_errors=True)
    loop = _stream_lane(torch, d, save_every)
    t0 = time.perf_counter()
    loop.run_dataset(_stream_dataset(spec), SR_TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop.ckpt.close()
    return dict(wall_s=wall,
                rows_per_s=SR_TIMED_STEPS * spec["batch"] / wall)


def _streaming_input_lane(work) -> dict:
    """The JAX bench's streaming_input host lane (bench.py
    config_streaming_input): 2,048 64x64 BMPs, FileSource -> decode(4
    workers) -> batch(64), each batch normalized on the host, against
    read_images then batching the column; SR_TIMED_RUNS rounds, each lane
    timed over a full epoch including its ingest."""
    from mmlspark_tpu_torch.data import FileSource
    from mmlspark_tpu_torch.io.codecs import encode_bmp
    from mmlspark_tpu_torch.io.readers import read_images
    n, hw, bs, workers = 2048, 64, 64, 4
    root = os.path.join(work, "streaming_input")
    os.makedirs(root)
    rng = np.random.default_rng(11)
    for i in range(n):
        img = rng.integers(0, 256, size=(hw, hw, 3), dtype=np.uint8)
        with open(os.path.join(root, f"img_{i:05d}.bmp"), "wb") as f:
            f.write(encode_bmp(img))
    ds = FileSource(root).decode(workers=workers).batch(bs,
                                                        remainder="drop")
    sink = []

    def consume(batch):
        sink.append(float((batch.astype(np.float32) / 255.0).mean()))

    def run_fw():
        with ds.iter() as it:
            for b in it:
                consume(b["image"])

    def run_base():
        col = read_images(root, decode_threads=workers).column("image")
        for off in range(0, len(col) - bs + 1, bs):
            consume(np.stack([iv.data for iv in col[off:off + bs]]))

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    run_fw()
    run_base()
    rounds = [(timed(run_fw), timed(run_base))
              for _ in range(SR_TIMED_RUNS)]
    rows = (n // bs) * bs
    rates = [rows / fw for fw, _ in rounds]
    return dict(rows=rows, batch=bs, decode_workers=workers,
                rows_per_s_min=min(rates), rows_per_s_max=max(rates),
                baseline_rows_per_s=[rows / b for _, b in rounds],
                vs_baseline=statistics.median(b / fw for fw, b in rounds))


def _save_restore_ms(torch, trainer, state, init_fn, work, name) -> dict:
    """save (host snapshot, then the background write) and restore of one
    train state, SR_TIMED_RUNS times each; ms and MB."""
    import shutil

    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    runs = []
    for i in range(SR_TIMED_RUNS):
        d = os.path.join(work, f"saverestore_{name}_{i}")
        ckpt = TrainCheckpointer(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(state, step=1)
        returned_ms = (time.perf_counter() - t0) * 1e3
        ckpt.wait()
        total_ms = (time.perf_counter() - t0) * 1e3
        timing = dict(ckpt.last_save)
        t0 = time.perf_counter()
        ckpt.restore(trainer, init_fn)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        ckpt.close()
        shutil.rmtree(d, ignore_errors=True)
        runs.append(dict(save_returned_ms=returned_ms,
                         snapshot_ms=timing["snapshot_s"] * 1e3,
                         write_ms=timing["write_s"] * 1e3,
                         save_total_ms=total_ms, restore_ms=restore_ms,
                         mb=timing["bytes"] / 1e6))
    t0 = time.perf_counter()
    trainer.init(init_fn)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    out = {"mb": runs[0]["mb"], "restore_init_ms": init_ms}
    for key in ("snapshot_ms", "write_ms", "save_total_ms", "restore_ms"):
        vals = [r[key] for r in runs]
        out[key + "_min"], out[key + "_max"] = min(vals), max(vals)
    return out


def _lm_adamw_state(torch):
    """The lm_train model (transformer_lm, vocab 32000, dim 512, depth 6,
    bf16) with adamw(1e-3) state after one step on 2048 ids."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model
    from mmlspark_tpu_torch.parallel.optim import adamw
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

    def init_fn():
        return build_model("transformer_lm", dtype="bfloat16")["module"]

    def loss_fn(module, batch, gen):
        x = batch["ids"]
        logits = module(x)
        v = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                               x[:, 1:].reshape(-1).long())
    trainer = DistributedTrainer(loss_fn, adamw(1e-3))
    state = trainer.init(init_fn)
    ids = np.random.default_rng(0).integers(0, LM_VOCAB, (1, LM_LEN)
                                            ).astype(np.int32)
    state, _ = trainer.train_step(state, trainer.put_batch({"ids": ids}))
    torch.cuda.synchronize()
    return trainer, state, init_fn


def phase_stream_resume(torch, kernels, card, keep_events=None) -> dict:
    """Streamed input, checkpoints and crash-safe resume (see the module
    docstring, phase 19). Returns K1's launches in each child; child C's
    events log is copied into ``keep_events`` when given."""
    import shutil
    import tempfile

    from mmlspark_tpu_torch.utils import native_loader
    native = native_loader.native_available()
    native_error = native_loader.load_error()
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_stream_resume-")
    print(f"stream_resume: work dir {work}", file=sys.stderr, flush=True)
    spec = _stream_spec(work)
    t0 = time.perf_counter()
    _write_corpus(spec)
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    children = _stream_children(torch, kernels, spec, work)
    children_s = time.perf_counter() - t0

    # timed in this process, normal (non-deterministic) mode
    rates = {}
    for every in (0, SR_SAVE_EVERY):
        runs = [_rows_per_s(torch, spec, every, work)
                for _ in range(SR_TIMED_RUNS)]
        rows = [r["rows_per_s"] for r in runs]
        rates[f"save_every_{every}"] = dict(
            rows_per_s_min=min(rows), rows_per_s_max=max(rows),
            wall_s=[r["wall_s"] for r in runs])
    streaming = _streaming_input_lane(work)
    loop = _stream_lane(torch, os.path.join(work, "resnet_state"), 0)
    state = loop.run_dataset(_stream_dataset(spec), SR_SAVE_EVERY)
    loop.ckpt.close()
    resnet = _save_restore_ms(torch, loop.trainer, state,
                              loop.init_params_fn, work, "resnet20")
    lm_trainer, lm_state, lm_init = _lm_adamw_state(torch)
    lm = _save_restore_ms(torch, lm_trainer, lm_state, lm_init, work, "lm")
    c = children["C"]
    _line(phase="stream_resume", card=_smi(), model="resnet20_cifar",
          corpus=dict(files=spec["files"], format="png",
                      shape=list(TRAIN_SHAPE), write_s=corpus_s),
          native_codec=dict(native_available=native,
                            build_error_tail=(native_error or "")[-600:]
                            or None),
          pipeline=(f"FileSource -> shuffle(window {spec['window']}, "
                    f"seed 0) -> decode(workers {spec['workers']}) -> "
                    f"map(uint8 flat + label) -> batch({spec['batch']}, "
                    "drop) -> repeat()"),
          steps=spec["steps"], save_every=spec["save_every"],
          kill_at=spec["kill_at"], children_s=children_s,
          child_A=children["A"], child_B=children["B"], child_C=c,
          b_dir_after_kill=children["b_dir"],
          quarantined=children["quarantined"],
          state_bit_equal=children["state_bit_equal"],
          deep=children["deep"],
          restart_ms=dict(spawn_to_first_step=c["spawn_to_first_step_ms"],
                          imports=c["imports_ms"],
                          interpreter=c["interpreter_ms"],
                          torch_import=c["torch_import_ms"],
                          deterministic_flags=c["deterministic_flags_ms"],
                          package_import=c["package_import_ms"],
                          cuda_context=c["cuda_context_ms"],
                          restore=c["restore_ms"], seek=c["seek_ms"]),
          run_dataset=dict(steps=SR_TIMED_STEPS, **rates),
          streaming_input=streaming,
          save_restore=dict(resnet20_sgd_momentum=resnet,
                            transformer_lm_adamw=lm),
          phase_s=time.perf_counter() - t_phase)
    if keep_events is not None and os.path.exists(spec["events"]):
        shutil.copy(spec["events"],
                    os.path.join(keep_events, "stream_resume_C.jsonl"))
    shutil.rmtree(work, ignore_errors=True)
    return {"A": children["A"]["launches"]["fused_normalize"],
            "B": children["B"]["k1"],
            "C": c["launches"]["fused_normalize"]}


def _mesh_configs(cards: int) -> dict:
    """The meshes of each run: on one card two ranks (tensor 2, seq 2),
    on four (data 2 x tensor 2, data 2 x seq 2, data 4)."""
    if cards == 1:
        lm = [("tensor2", {"data": 1, "tensor": 2}, "full"),
              ("seq2_ulysses", {"data": 1, "seq": 2}, "ulysses")]
        ring = ("seq2_ring", {"data": 1, "seq": 2}, "ring")
        return {"lm": lm, "f32": lm + [ring], "resnet": {"data": 2},
                "inputs": {"data": 2},
                "ckpt": ["1x2", "2x1", "1x2"],
                "moe": ("expert2", {"data": 1, "expert": 2}),
                "pipe": [("pipe2", "1x1x2", 2),
                         ("pipe2_virtual4", "1x1x2", 4)],
                "reshard": ["2", "1x1x2", "2"], "dlrm": "1x2"}
    lm = [("data2_tensor2", {"data": 2, "tensor": 2}, "full"),
          ("data2_seq2_ulysses", {"data": 2, "seq": 2}, "ulysses")]
    ring = ("data2_seq2_ring", {"data": 2, "seq": 2}, "ring")
    return {"lm": lm, "f32": lm + [ring], "resnet": {"data": cards},
            "inputs": {"data": 2, "tensor": 2},
            "ckpt": ["2x2", "4x1", "2x2"],
            "moe": ("data2_expert2", {"data": 2, "expert": 2}),
            "pipe": [("tensor2_pipe2", "1x2x2", 2),
                     ("tensor2_pipe2_virtual4", "1x2x2", 4)],
            "reshard": ["4", "2x1x2", "4"], "dlrm": "2x2"}


def _mesh_lm_ids(batch, steps) -> np.ndarray:
    return np.random.default_rng(5).integers(
        0, LM_VOCAB, (batch * steps, LM_LEN)).astype(np.int64)


def _mesh_lm(torch, kernels, mesh, impl, f32, warmup, steps):
    """transformer_lm (bf16 at the zoo's width, or fp32 at depth 2) from
    the seed-0 host init, adam(1e-3), next-token cross-entropy, batches
    from a resident epoch (each rank's block of it on a mesh). Returns
    the per-step losses, the timed steps' ms, the counted syncs in the
    timed window, and the launches of the steps."""
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.parallel.mesh import mesh_shape
    from mmlspark_tpu_torch.parallel.optim import adam
    from mmlspark_tpu_torch.parallel.sequence import make_attention_fn
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )
    arch = dict(dtype="float32", depth=LM_F32_DEPTH) if f32 \
        else dict(dtype="bfloat16")
    batch = MESH_F32_BATCH if f32 else MESH_LM_BATCH
    seq = "seq" if mesh is not None and mesh_shape(mesh)["seq"] > 1 \
        else None
    attn = make_attention_fn(mesh, impl) if mesh is not None else None

    def init_fn():
        module = build_model("transformer_lm", attention_fn=attn,
                             **arch)["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        return module
    trainer = DistributedTrainer(
        lambda m, b, g: next_token_loss(m, b["ids"]), adam(1e-3),
        mesh=mesh, seq_axis=seq)
    state = trainer.init(init_fn)
    cache = DeviceEpochCache({"ids": _mesh_lm_ids(batch, warmup + steps)},
                             batch, mesh=mesh, seq_axis=seq)
    batches = list(cache.batches(0))
    kernels.reset_launches()
    losses = []
    for b in batches[:warmup]:
        state, m = trainer.train_step(state, b, 0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    sync0, t0 = syncs.total(), time.perf_counter()
    for b in batches[warmup:]:
        state, m = trainer.train_step(state, b, 0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    window_syncs = syncs.total() - sync0
    launches = _launches(kernels)
    out = {"losses": [float(x) for x in torch.stack(losses).cpu()],
           "step_ms": step_ms, "window_syncs": window_syncs,
           "launches": launches, "tokens_per_step": batch * LM_LEN}
    if mesh is not None and not f32 and \
            torch.distributed.get_backend() == "nccl":
        # NCCL's kernels' device time a step, over two profiled steps
        # after the counted ones (gloo's collectives run on the host)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for b in batches[-2:]:
                state, m = trainer.train_step(state, b, 0)
            torch.cuda.synchronize()
        nccl_us = sum(getattr(e, "device_time_total", 0)
                      for e in prof.key_averages()
                      if "nccl" in e.key.lower())
        out["nccl_ms_per_step"] = nccl_us / 1e3 / 2
    return out


def _mesh_resnet(torch, kernels, mesh, f32=False):
    """ResNet-20 (bf16, or fp32 with ``f32``; seed-0 init), sgd(0.1,
    momentum 0.9), K1 in the loss, one unshuffled epoch of the train
    cell's images at batch 256 through a (meshed) DeviceEpochCache.
    Returns the losses, the step ms, the launches and the final
    parameters (host fp32)."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.ops.preprocess import make_preprocess_fn
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (TRAIN_ROWS, math.prod(TRAIN_SHAPE)),
                          dtype=np.uint8)
    labels = rng.integers(0, 10, TRAIN_ROWS).astype(np.int32)
    dtype = torch.float32 if f32 else torch.bfloat16
    pre = make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN, CIFAR_STD,
                             out_dtype=dtype)

    def init_fn():
        module = build_model("resnet20_cifar", num_classes=10,
                             dtype=dtype)["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        return module

    def loss_fn(module, batch, gen):
        return F.cross_entropy(module(pre(batch["image"])).float(),
                               batch["label"].long())
    trainer = DistributedTrainer(loss_fn, sgd(0.1, momentum=0.9), mesh=mesh)
    state = trainer.init(init_fn)
    cache = DeviceEpochCache({"image": images, "label": labels},
                             TRAIN_BATCH, mesh=mesh)
    kernels.reset_launches()
    losses, first = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in list(cache.batches(0))[:MESH_RESNET_STEPS]:
        state, m = trainer.train_step(state, b, 0)
        losses.append(m["loss"])
        if first is None and f32:
            first = {n: p.detach().cpu().numpy().copy()
                     for n, p in state["module"].named_parameters()}
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MESH_RESNET_STEPS
    launches = _launches(kernels)
    return {"losses": [float(x) for x in torch.stack(losses).cpu()],
            "step_ms": step_ms, "launches": launches,
            "local_rows": cache.local_batch, "first_update": first,
            "params": {n: p.detach().float().cpu().numpy()
                       for n, p in state["module"].named_parameters()}}


def _mesh_checkpoint(torch, kernels, shapes, directory) -> dict:
    """The fp32 depth-2 LM: MESH_CKPT_STEPS steps on each mesh shape in
    turn, saved at the end of each and restored on the next; each
    restore's whole parameters must equal the saved ones bit for bit."""
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.parallel.mesh import make_mesh, parse_mesh_shape
    from mmlspark_tpu_torch.parallel.optim import adam
    from mmlspark_tpu_torch.parallel.sharding import whole_state_dict
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    arch = dict(dtype="float32", depth=LM_F32_DEPTH)

    def init_fn():
        module = build_model("transformer_lm", **arch)["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        return module
    ids = _mesh_lm_ids(MESH_F32_BATCH, MESH_CKPT_STEPS * len(shapes))
    saved, out = None, []
    for i, shape in enumerate(shapes):
        mesh = make_mesh(parse_mesh_shape(shape))
        trainer = DistributedTrainer(
            lambda m, b, g: next_token_loss(m, b["ids"]), adam(1e-3),
            mesh=mesh)
        ckpt = TrainCheckpointer(directory)
        state = trainer.init(init_fn) if i == 0 else \
            ckpt.restore(trainer, init_fn)
        whole = whole_state_dict(state["module"])
        equal = saved is None or all(torch.equal(whole[k].cpu(), v)
                                     for k, v in saved.items())
        losses = []
        for j in range(MESH_CKPT_STEPS):
            rows = ids[(i * MESH_CKPT_STEPS + j) * MESH_F32_BATCH:][
                :MESH_F32_BATCH]
            state, m = trainer.train_step(
                state, trainer.put_batch({"ids": rows}), 0)
            losses.append(float(m["loss"]))
        saved = {k: v.cpu() for k, v in
                 whole_state_dict(state["module"]).items()}
        ckpt.save(state, wait=True)
        ckpt.close()
        out.append({"mesh": shape, "restored_equal": equal,
                    "losses": losses, "step": int(state["step"]),
                    "local_query_rows": int(
                        state["module"].block0.attn_query.weight.shape[0])})
    return out


def _mesh_moe(torch, kernels, mesh, f32, warmup, steps, record=False):
    """``transformer_lm_moe`` (bf16 at the zoo's width, or fp32 at depth
    2) from the seed-0 host init, adam(1e-3), next-token CE + 0.01 x
    moe_aux, batches from a resident epoch (each rank's block of it on a
    mesh). Returns the per-step losses, the timed steps' ms, the counted
    syncs in the timed window, the launches, the experts a rank holds,
    and with ``record`` the first step's gate indices and slot positions
    of every MoE block (host arrays) with this rank's batch block
    (``record="all"``: every step's, keyed ``s<step>_...``)."""
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.models.zoo.moe import MoeMlp, moe_aux_loss
    from mmlspark_tpu_torch.models.zoo.transformer import next_token_loss
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.parallel import collectives, sharding
    from mmlspark_tpu_torch.parallel.optim import adam
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )
    arch = dict(dtype="float32", depth=LM_F32_DEPTH) if f32 \
        else dict(dtype="bfloat16")
    batch = MESH_MOE_F32_BATCH if f32 else MESH_MOE_BATCH

    def init_fn():
        module = build_model("transformer_lm_moe", **arch)["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        return module
    trainer = DistributedTrainer(
        lambda m, b, g: next_token_loss(m, b["ids"])
        + 0.01 * moe_aux_loss(m), adam(1e-3), mesh=mesh)
    state = trainer.init(init_fn)
    cache = DeviceEpochCache({"ids": _mesh_lm_ids(batch, warmup + steps)},
                             batch, mesh=mesh)
    batches = list(cache.batches(0))
    moes = [m for m in state["module"].modules() if isinstance(m, MoeMlp)]
    kernels.reset_launches()
    collectives.reset_host_copies()
    losses, routing = [], None
    torch.cuda.synchronize()
    sync0, t0 = syncs.total(), time.perf_counter()
    for i, b in enumerate(batches):
        if i == warmup:
            torch.cuda.synchronize()
            sync0, t0 = syncs.total(), time.perf_counter()
        every = record == "all"
        for m in moes:
            m.record_routing = bool(record) and (every or i == 0)
        state, out = trainer.train_step(state, b, 0)
        losses.append(out["loss"])
        if record and (every or i == 0):
            tag = f"s{i}_" if every else ""
            routing = routing or {}
            routing.update({f"{tag}{n}_{j}": moe.routing[n].cpu().numpy()
                            for j, moe in enumerate(moes)
                            for n in ("gate_idx", "position")})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    out = {"losses": [float(x) for x in torch.stack(losses).cpu()],
           "step_ms": step_ms, "window_syncs": syncs.total() - sync0,
           "launches": _launches(kernels),
           "host_copies": collectives.host_copies(),
           "tokens_per_step": batch * LM_LEN,
           "experts_held": sorted({(tuple(m.experts_up.shape),
                                    tuple(m.experts_down.shape))
                                   for m in moes}),
           "block": sharding.batch_block(mesh) if mesh is not None else 0}
    if routing is not None:
        out["routing"] = routing
    return out


def _pipe_host(n_stages):
    """The bench's fleet_reshard host init (seed 0): stacked stage
    kernels (S, d, hidden) / (S, hidden, d) and the head (d, 1), in the
    port's torch layouts."""
    rng = np.random.default_rng(0)
    d, h = MESH_PIPE_D, MESH_PIPE_HIDDEN
    up = rng.normal(0, 0.02, (n_stages, d, h)).astype(np.float32)
    down = rng.normal(0, 0.02, (n_stages, h, d)).astype(np.float32)
    head = rng.normal(0, 0.02, (d, 1)).astype(np.float32)
    return {"up": np.ascontiguousarray(up.transpose(0, 2, 1)),
            "down": np.ascontiguousarray(down.transpose(0, 2, 1)),
            "head": np.ascontiguousarray(head.T)}


def _pipe_batch(step):
    r = np.random.default_rng(1000 + step)
    x = r.normal(0, 1, (MESH_PIPE_BATCH, MESH_PIPE_D)).astype(np.float32)
    return {"x": x, "y": (x[:, 0] * 0.5).astype(np.float32)}


def _pipe_parts(torch, n_stages):
    """(init_fn, loss_fn) of the pipelined residual MLP: a ``StageStack``
    under ``stages`` and a head outside the pipeline."""
    from mmlspark_tpu_torch.parallel.pipeline_parallel import StageStack
    host = _pipe_host(n_stages)

    def init_fn():
        module = torch.nn.Module()
        module.stages = StageStack({"mlp_up": {"weight": host["up"]},
                                    "mlp_down": {"weight": host["down"]}})
        module.head = torch.nn.Linear(MESH_PIPE_D, 1, bias=False)
        with torch.no_grad():
            module.head.weight.copy_(torch.from_numpy(host["head"]))
        return module

    def stage(p, x):
        return x + torch.tanh(x @ p["mlp_up"]["weight"].T) \
            @ p["mlp_down"]["weight"].T

    def loss_fn(module, batch, gen):
        h = module.stages(stage, batch["x"], MESH_PIPE_MICRO)
        return ((module.head(h)[:, 0] - batch["y"]) ** 2).mean()
    return init_fn, loss_fn


def _pipe_trainer(torch, mesh, loss_fn, losses=None):
    """A trainer of the pipelined MLP (``pipeline_stacked_rules``); with
    ``losses``, each step's loss is appended to it."""
    from mmlspark_tpu_torch.parallel.optim import adam
    from mmlspark_tpu_torch.parallel.sharding import pipeline_stacked_rules
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer

    class Recording(DistributedTrainer):
        def train_step(self, state, batch, rng=None):
            state, out = super().train_step(state, batch, rng)
            if losses is not None:
                losses.append(out["loss"])
            return state, out
    return Recording(loss_fn, adam(MESH_PIPE_LR), mesh=mesh,
                     rules=pipeline_stacked_rules())


def _mesh_pipe(torch, mesh, n_stages):
    """The pipelined MLP, ``n_stages`` stages, MESH_PIPE_STEPS steps
    (fp32; the caller turns TF32 off): the losses, the ms of the steps
    after the first, the stage hops' host copies and this rank's
    stage-leaf shape."""
    from mmlspark_tpu_torch.parallel import collectives
    init_fn, loss_fn = _pipe_parts(torch, n_stages)
    losses = []
    trainer = _pipe_trainer(torch, mesh, loss_fn, losses)
    state = trainer.init(init_fn)
    collectives.reset_host_copies()
    collectives.reset_traffic()
    for step in range(1, MESH_PIPE_STEPS + 1):
        if step == 2:   # the first step counts its FLOPs: not timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, _ = trainer.train_step(state, trainer.put_batch(
            _pipe_batch(step)), 0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (MESH_PIPE_STEPS - 1)
    return {"losses": [float(x) for x in torch.stack(losses).cpu()],
            "step_ms": step_ms, "host_copies": collectives.host_copies(),
            "stage_shifts": collectives.traffic().get(
                "stage_shift", {"calls": 0})["calls"],
            "up_shape": list(state["module"].stages.mlp_up.weight.shape)}


def _mesh_pipe_reshard(torch, shapes, directory):
    """``ResilientTrainLoop.run`` of the 2-stage pipelined MLP from mesh
    ``shapes[0]``, ``reshard_to(shapes[1])`` requested while step
    MESH_PIPE_RESHARD_AT[0] runs and ``reshard_to(shapes[2])`` at [1]:
    the losses, whether every restore equalled its save (the whole
    parameters), and the mesh the run ended on."""
    from mmlspark_tpu_torch.parallel.checkpoint import TrainCheckpointer
    from mmlspark_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from mmlspark_tpu_torch.parallel.mesh import parse_mesh_shape
    from mmlspark_tpu_torch.parallel.sharding import whole_state_dict
    from mmlspark_tpu_torch.reliability.resilient import ResilientTrainLoop
    init_fn, loss_fn = _pipe_parts(torch, 2)
    losses, equal = [], []

    class Checked(TrainCheckpointer):
        saved = None

        def save(self, state, *args, **kwargs):
            Checked.saved = {k: v.cpu().clone() for k, v in
                             whole_state_dict(state["module"]).items()}
            return super().save(state, *args, **kwargs)

        def restore(self, trainer, init, step=None):
            state = super().restore(trainer, init, step)
            got = whole_state_dict(state["module"])
            equal.append(all(torch.equal(got[k].cpu(), v)
                             for k, v in Checked.saved.items()))
            return state

    def factory(mesh):
        return _pipe_trainer(torch, mesh, loss_fn, losses)
    loop = ResilientTrainLoop(factory(make_mesh(parse_mesh_shape(shapes[0]))),
                              Checked(directory), init_fn, save_every=0,
                              trainer_factory=factory)
    at = dict(zip(MESH_PIPE_RESHARD_AT, shapes[1:]))

    def batch_fn(step):
        if step in at:
            loop.reshard_to(at[step])
        return _pipe_batch(step)
    loop.run(batch_fn, MESH_PIPE_STEPS)
    loop.ckpt.close()
    return {"losses": [float(x) for x in torch.stack(losses).cpu()],
            "restores_equal": equal,
            "mesh": mesh_shape(loop.trainer.mesh)}


def _dlrm_parts(torch):
    """(init_fn, loss_fn, host rows, labels) of the bench's recommender
    train half: the DLRM (seed-0 host init) on the loadgen's rows."""
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.testing import loadgen
    kw = dict(dense_dim=MESH_DLRM_DENSE, tables=MESH_DLRM_TABLES,
              embed_dim=MESH_DLRM_EMBED, slots=MESH_DLRM_SLOTS,
              bottom=(64,), top=(64,))
    x = loadgen.recommender_rows(
        MESH_DLRM_BATCH * MESH_DLRM_STEPS, dense=MESH_DLRM_DENSE,
        tables=tuple((rows, MESH_DLRM_SLOTS)
                     for _, rows in MESH_DLRM_TABLES), seed=31)
    y = (x[:, 0] > 0).astype(np.float32)

    def init_fn():
        module = build_model("recommender_dlrm", **kw)["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        return module

    def loss_fn(module, batch, gen):
        return F.binary_cross_entropy_with_logits(module(batch["x"])[:, 0],
                                                  batch["y"])
    return init_fn, loss_fn, x, y


def _first_bags(torch, module, x, lookup):
    """The user table's bags of the first batch's rows ``x`` (this rank's
    block) through ``lookup``, on the initial table."""
    from mmlspark_tpu_torch.embed.tables import PAD_ID
    off = MESH_DLRM_DENSE
    ids = x[:, off:off + MESH_DLRM_SLOTS].long()
    with torch.no_grad():
        return lookup(module.user_embedding, ids, (ids != PAD_ID).float())


def _mesh_dlrm(torch, mesh):
    """The DLRM, MESH_DLRM_STEPS sgd steps over the loadgen's rows (each
    rank's block of every batch on a mesh): the losses, the ms of the
    steps after the first, the
    first batch's fused bags (gathered over the data ranks), the table
    bytes a rank holds, the dense bytes, and the collectives' traffic of
    the steps by op."""
    from mmlspark_tpu_torch.embed.tables import bag_lookup_reference
    from mmlspark_tpu_torch.parallel import collectives, sharding
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import (
        DeviceEpochCache, DistributedTrainer,
    )
    init_fn, loss_fn, x, y = _dlrm_parts(torch)
    trainer = DistributedTrainer(loss_fn, sgd(MESH_DLRM_LR), mesh=mesh)
    state = trainer.init(init_fn)
    module = state["module"]
    cache = DeviceEpochCache({"x": x, "y": y}, MESH_DLRM_BATCH, mesh=mesh)
    batches = list(cache.batches(0))
    bags = _first_bags(torch, module, batches[0]["x"],
                       module.lookup_fn or bag_lookup_reference)
    if mesh is not None:
        bags = collectives.all_gather(
            bags, 0, sharding.axis_group(
                mesh, sharding.active_batch_axes(mesh) or ()))
    collectives.reset_traffic()
    collectives.reset_host_copies()
    losses = []
    for i, b in enumerate(batches):
        if i == 1:      # the first step counts its FLOPs: not timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, out = trainer.train_step(state, b, 0)
        losses.append(out["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    tables = [p for n, p in module.named_parameters()
              if n.endswith("_embedding")]
    return {"losses": [float(v) for v in torch.stack(losses).cpu()],
            "step_ms": step_ms, "bags": bags.cpu().numpy(),
            "table_bytes": sum(p.numel() * p.element_size() for p in tables),
            "logical_table_bytes": sum(
                rows * MESH_DLRM_EMBED * 4 for _, rows in MESH_DLRM_TABLES),
            "dense_bytes": sum(p.numel() * p.element_size() for n, p in
                               module.named_parameters()
                               if not n.endswith("_embedding")),
            "traffic": collectives.traffic(),
            "host_copies": collectives.host_copies(),
            "summed": list(getattr(module, "summed_grads", ()))}


def mesh_child(spec: dict) -> int:
    """One rank of the mesh phase, started by ``cli run --nprocs`` (the
    process group is joined and ``runtime.device`` set): every run of
    the phase on its mesh, each with the counts zeroed just before and
    read just after; writes its results beside the others'."""
    import torch
    import torch.distributed as dist
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.parallel import collectives
    from mmlspark_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                  parse_mesh_shape)
    from mmlspark_tpu_torch.utils import config
    rank, world = dist.get_rank(), dist.get_world_size()
    card = config.resolve_device()
    torch.cuda.set_device(card)
    kernels.build_all()
    configs = _mesh_configs(spec["cards"])
    out = {"rank": rank, "world": world, "device": str(card),
           "card_name": torch.cuda.get_device_name(card),
           "backend": dist.get_backend(), "lm": {}, "f32": {}}
    make_mesh(MeshSpec(data=-1))
    out["spawn_to_mesh_ms"] = (time.time() - spec["spawn_t"]) * 1e3
    # each run's seconds on this rank, for the phase's breakdown
    run_s = out["run_s"] = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        run_s[name] = time.perf_counter() - t
        t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(card)
    for name, axes, impl in configs["lm"]:
        collectives.reset_host_copies()
        run = _mesh_lm(torch, kernels, make_mesh(MeshSpec(**axes)), impl,
                       False, MESH_LM_WARMUP, MESH_LM_STEPS)
        run["host_copies"] = collectives.host_copies()
        out["lm"][name] = run
        lap(f"lm_{name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, axes, impl in configs["f32"]:
        out["f32"][name] = _mesh_lm(torch, kernels,
                                    make_mesh(MeshSpec(**axes)), impl, True,
                                    0, MESH_F32_STEPS)
    lap("lm_f32")
    out["checkpoint"] = _mesh_checkpoint(
        torch, kernels, configs["ckpt"], os.path.join(spec["work"], "ckpt"))
    lap("checkpoint")
    f32_resnet = _mesh_resnet(torch, kernels,
                              make_mesh(MeshSpec(**configs["resnet"])), True)
    np.savez(os.path.join(spec["work"], f"resnet_f32_rank{rank}.npz"),
             **f32_resnet.pop("params"))
    np.savez(os.path.join(spec["work"], f"resnet_f32_first_rank{rank}.npz"),
             **f32_resnet.pop("first_update"))
    out["resnet_f32"] = f32_resnet
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    collectives.reset_host_copies()
    res = _mesh_resnet(torch, kernels,
                       make_mesh(MeshSpec(**configs["resnet"])))
    res["host_copies"] = collectives.host_copies()
    res.pop("first_update")
    np.savez(os.path.join(spec["work"], f"resnet_rank{rank}.npz"),
             **res.pop("params"))
    out["resnet"] = res
    out["max_allocated_bytes"] = int(torch.cuda.max_memory_allocated(card))
    lap("resnet")
    # slice 6b-i: the MoE LM over `expert`, the pipelined MLP over `pipe`,
    # the DLRM's tables over `tensor`
    name, axes = configs["moe"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(card)
    moe = _mesh_moe(torch, kernels, make_mesh(MeshSpec(**axes)), False,
                    MESH_MOE_WARMUP, MESH_MOE_STEPS)
    moe["max_allocated_bytes"] = int(torch.cuda.max_memory_allocated(card))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the bf16 MoE with TF32 off, every step's routing recorded
    moe_nt = _mesh_moe(torch, kernels, make_mesh(MeshSpec(**axes)), False,
                       MESH_MOE_WARMUP, MESH_MOE_STEPS, record="all")
    np.savez(os.path.join(spec["work"], f"moe_notf32_routing_rank{rank}.npz"),
             **moe_nt.pop("routing"))
    moe32 = _mesh_moe(torch, kernels, make_mesh(MeshSpec(**axes)), True, 0,
                      MESH_MOE_F32_STEPS, record=True)
    np.savez(os.path.join(spec["work"], f"moe_routing_rank{rank}.npz"),
             **moe32.pop("routing"))
    out["moe"] = {"bf16": moe, "f32": moe32, "bf16_tf32_off": moe_nt}
    lap("moe")
    torch.cuda.empty_cache()
    out["pipe"] = {n: _mesh_pipe(torch, make_mesh(parse_mesh_shape(shape)),
                                 stages)
                   for n, shape, stages in configs["pipe"]}
    out["pipe_reshard"] = _mesh_pipe_reshard(
        torch, configs["reshard"], os.path.join(spec["work"], "reshard"))
    dlrm = _mesh_dlrm(torch, make_mesh(parse_mesh_shape(configs["dlrm"])))
    np.save(os.path.join(spec["work"], f"dlrm_bags_rank{rank}.npy"),
            dlrm.pop("bags"))
    out["dlrm"] = dlrm
    lap("pipe_dlrm")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    # multi-process inputs: each rank fits its own shard of the deep cell
    from mmlspark_tpu_torch.parallel import sharding
    torch.cuda.empty_cache()
    inputs_mesh = make_mesh(MeshSpec(**configs["inputs"]))
    deep = _mesh_inputs_deep(torch, inputs_mesh)
    deep["params"] = {k: v.tolist() for k, v in deep["params"].items()}
    out["inputs"] = {"deep": deep,
                     "block": sharding.batch_block(inputs_mesh),
                     "verdict": _mesh_inputs_verdict(torch, inputs_mesh,
                                                     rank)}
    lap("inputs_deep")
    # serving on the mesh: rank 0 leads, the others follow
    from mmlspark_tpu_torch.parallel import leader
    torch.cuda.empty_cache()
    if rank == 0:
        with leader.lead() as ch:
            out["serve"] = _mesh_serve(torch, kernels, card, ch,
                                       spec["cards"])
    else:
        out["serve"] = {"follower_commands": leader.follow()}
    lap("serve")
    with open(os.path.join(spec["work"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _mesh_serve_configs(cards: int) -> dict:
    """The meshes of mesh_serve: on one card two ranks, on four the
    reference's data 2 x tensor 2 (featurize over data 4)."""
    t2 = {"data": 1, "tensor": 2}
    if cards == 1:
        return {"lm": t2, "f32": t2, "gen": t2, "dlrm": t2,
                "reshard": "1x2", "featurize": {"data": 2}}
    # the recommender stays at tensor 2 (ranks 0-1, a sub-mesh of the
    # world): a data split changes the dense GEMMs' row counts, and with
    # them cuBLAS's algorithms, where the gate wants bit-equal scores
    d2t2 = {"data": 2, "tensor": 2}
    return {"lm": d2t2, "f32": d2t2, "gen": d2t2, "dlrm": t2,
            "reshard": "1x2", "featurize": {"data": cards}}


def _rank_launches(stats, name) -> list:
    """Each rank's launches of kernel ``name`` from ``rank_stats``."""
    return [s["launches"].get(name, (0, {}))[0] for s in stats]


def _mesh_serve(torch, kernels, card, ch, cards) -> dict:
    """Serving on the mesh (module docstring, phase 20), on rank 0 as the
    leader of the ranks: each configuration's one-rank reference here,
    then the same traffic on the mesh, every rank's counts zeroed just
    before and read just after. Returns the numbers and the failed
    gates."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.observability import memory as devmem
    from mmlspark_tpu_torch.serve import Server
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.testing import loadgen
    from mmlspark_tpu_torch.utils import config
    cfg = _mesh_serve_configs(cards)
    tc, f32 = kernels.FLASH_ATTENTION_TC.name, kernels.FLASH_ATTENTION.name
    k2 = kernels.CROP_RESIZE_NORMALIZE.name
    failed, out = [], {"meshes": cfg}
    t_phase = time.perf_counter()

    def check(ok, what):
        if not ok:
            failed.append(what)

    def serve_lm(tm, ids):
        with Server({"lm": tm}, max_batch=LM_SERVE_BUCKETS[-1],
                    buckets=LM_SERVE_BUCKETS, max_wait_ms=2.0) as srv:
            entry = srv.registry.get("lm")
            for b in LM_SERVE_BUCKETS:
                entry.program_for(b, ids[:b])
            ch.rank_stats(reset=True)
            served, lat, wall = _closed_loop(
                LM_SERVE_CLIENTS, list(range(len(ids))),
                lambda i: srv.submit("lm", ids[i], timeout=300))
            stats = ch.rank_stats()
            progs = entry.built_programs()
            replays = sum(p.replays for p in progs.values())
        return np.concatenate(served), lat, wall, stats, replays

    # -- the LM behind a Server (bf16, hidden) --
    ids = np.random.default_rng(0).integers(
        0, LM_VOCAB, (MESH_SERVE_LM_REQUESTS, LM_LEN)).astype(np.int32)
    one, lat1, wall1, _, _ = serve_lm(
        _lm_scorer("transformer_lm", "hidden", LM_SERVE_BUCKETS[-1]), ids)
    tm = _lm_scorer("transformer_lm", "hidden", LM_SERVE_BUCKETS[-1])
    tm.set_params(meshSpec=cfg["lm"])
    got, lat, wall, stats, replays = serve_lm(tm, ids)
    tm.release_placement()
    cross = _diff_stats(got, one)
    check(cross["max_abs"] <= LM_BF16_MAX and cross["mean_abs"]
          <= LM_BF16_MEAN, f"mesh_serve lm: rows vs one rank {cross}")
    check(got.shape == one.shape and bool(np.isfinite(got).all()),
          f"mesh_serve lm: rows {got.shape}")
    k3 = _rank_launches(stats, tc)
    check(k3 == [LM_DEPTH * replays] * len(stats) and replays > 0,
          f"mesh_serve lm: {tc} launches {k3} a rank, want {LM_DEPTH} x "
          f"{replays} program calls")
    out["lm"] = dict(
        mesh=cfg["lm"], requests=MESH_SERVE_LM_REQUESTS,
        clients=LM_SERVE_CLIENTS,
        tokens_per_s=MESH_SERVE_LM_REQUESTS * LM_LEN / wall,
        tokens_per_s_per_rank=MESH_SERVE_LM_REQUESTS * LM_LEN / wall
        / len(stats),
        one_rank_tokens_per_s=MESH_SERVE_LM_REQUESTS * LM_LEN / wall1,
        p50_ms=_pct_ms(lat, 50), p99_ms=_pct_ms(lat, 99),
        one_rank_p50_ms=_pct_ms(lat1, 50), one_rank_p99_ms=_pct_ms(lat1, 99),
        vs_one_rank=cross, program_calls=replays,
        launches={f"rank{r}": n for r, n in enumerate(k3)},
        host_copies=[st["host_copies"] for st in stats],
        max_allocated_bytes=[st["max_allocated_bytes"] for st in stats])
    del one, got
    torch.cuda.empty_cache()

    # -- fp32, TF32 off on every rank: logits and greedy tokens equal to
    # one rank's --
    ch.set_tf32(False)
    arch32 = dict(dtype="float32", depth=LM_F32_DEPTH)
    ids32 = np.random.default_rng(7).integers(
        0, LM_VOCAB, (MESH_SERVE_F32_ROWS, MESH_SERVE_F32_LEN)).astype(
        np.int32)
    frame32 = Frame.from_dict({"ids": ids32})

    def lm32(mesh):
        m = _lm_scorer("transformer_lm", "logits", MESH_SERVE_F32_ROWS,
                       **arch32)
        m.set_params(deviceCache="off")
        if mesh is not None:
            m.set_params(meshSpec=mesh)
        return m
    want = np.asarray(lm32(None).transform(frame32).column("h"))
    m32 = lm32(cfg["f32"])
    ch.rank_stats(reset=True)
    got = np.asarray(m32.transform(frame32).column("h"))
    stats = ch.rank_stats()
    m32.release_placement()
    logit_diff = float(np.abs(got - want).max())
    check(logit_diff <= MESH_SERVE_F32_TOL,
          f"mesh_serve fp32: logits {logit_diff} from one rank")
    f32_score = _rank_launches(stats, f32)
    check(f32_score == [LM_F32_DEPTH] * len(stats),
          f"mesh_serve fp32: {f32} launches {f32_score} a rank")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, LM_VOCAB, int(n)).tolist() for n in
               rng.integers(GEN_F32_PROMPT[0], GEN_F32_PROMPT[1],
                            MESH_SERVE_F32_ROWS)]
    for k, v in GEN_CONFIG.items():
        config.set(k, v)

    def greedy(mesh):
        m = lm32(mesh)
        with Server({"lm": m}) as srv:
            srv.enable_generate("lm")
            toks = [srv.submit_generate(
                "lm", p, max_new_tokens=MESH_SERVE_F32_NEW).result(300)
                ["tokens"] for p in prompts]
        m.release_placement()
        return toks
    want_toks = greedy(None)
    ch.rank_stats(reset=True)
    got_toks = greedy(cfg["f32"])
    stats = ch.rank_stats()
    check(got_toks == want_toks, "mesh_serve fp32: greedy tokens differ "
                                 f"from one rank's: {got_toks} {want_toks}")
    f32_gen = _rank_launches(stats, f32)
    check(all(n >= LM_F32_DEPTH for n in f32_gen),
          f"mesh_serve fp32 generate: {f32} launches {f32_gen} a rank")
    ch.set_tf32(True)
    out["fp32"] = dict(mesh=cfg["f32"], depth=LM_F32_DEPTH, tf32=False,
                       logits_max_abs_diff=logit_diff,
                       bound=MESH_SERVE_F32_TOL, tokens_equal=True,
                       tokens=got_toks,
                       launches_score={f"rank{r}": n
                                       for r, n in enumerate(f32_score)},
                       launches_generate={f"rank{r}": n
                                          for r, n in enumerate(f32_gen)})
    torch.cuda.empty_cache()

    # -- the generate lane at the zoo's width, the arena head-sharded --
    rng = np.random.default_rng(9)
    lengths = rng.integers(GEN_PROMPT[0], GEN_PROMPT[1],
                           MESH_SERVE_GEN_REQUESTS)
    gprompts = [rng.integers(0, LM_VOCAB, int(n)).tolist() for n in lengths]

    def gen_round(mesh):
        m = TorchModel(inputCol="ids", outputCol="h").set_model(
            "transformer_lm", seed=0)
        if mesh is not None:
            m.set_params(meshSpec=mesh)
        with Server({"lm": m}) as srv:
            lane = srv.enable_generate("lm")
            _warm_lane(lane, lengths)
            ch.rank_stats(reset=True)
            res, lat, wall = _closed_loop(
                GEN_CLIENTS, gprompts, lambda p: srv.submit_generate(
                    "lm", p, max_new_tokens=GEN_NEW_TOKENS).result(300))
            stats = ch.rank_stats()
            gen = lane.gen
            kv = dict(arena_bytes=gen.kv.arena_bytes(),
                      arena_shard_bytes=gen.kv.arena_shard_bytes(),
                      spec=list(gen.kv.arena_sharding or ()))
            prefills = sum(p.replays for (k, _), p in
                           gen.built_programs().items() if k == "prefill")
        m.release_placement()
        toks = sum(len(r["tokens"]) for r in res)
        return toks, lat, wall, stats, kv, prefills, res
    t1, lat1, wall1, _, kv1, _, _ = gen_round(None)
    t2, lat2, wall2, stats, kv, prefills, res = gen_round(cfg["gen"])
    check(all(len(r["tokens"]) == GEN_NEW_TOKENS for r in res),
          "mesh_serve generate: a request fell short of its tokens")
    check(kv["arena_shard_bytes"] * 2 == kv["arena_bytes"]
          and "tensor" in kv["spec"],
          f"mesh_serve generate: arena {kv}, want head-sharded halves")
    k3g = _rank_launches(stats, tc)
    check(k3g == [LM_DEPTH * prefills] * len(stats) and prefills > 0,
          f"mesh_serve generate: {tc} launches {k3g} a rank, want "
          f"{LM_DEPTH} x {prefills} prefills")
    out["generate"] = dict(
        mesh=cfg["gen"], requests=MESH_SERVE_GEN_REQUESTS,
        new_tokens=GEN_NEW_TOKENS, tokens_per_s=t2 / wall2,
        tokens_per_s_per_rank=t2 / wall2 / len(stats),
        one_rank_tokens_per_s=t1 / wall1,
        p50_ms=_pct_ms(lat2, 50), p99_ms=_pct_ms(lat2, 99),
        one_rank_p50_ms=_pct_ms(lat1, 50), one_rank_p99_ms=_pct_ms(lat1, 99),
        arena=kv, one_rank_arena_bytes=kv1["arena_bytes"],
        prefill_calls=prefills,
        launches={f"rank{r}": n for r, n in enumerate(k3g)},
        host_copies=[st["host_copies"] for st in stats],
        max_allocated_bytes=[st["max_allocated_bytes"] for st in stats])
    for k in GEN_CONFIG:
        config.unset(k)
    torch.cuda.empty_cache()

    # -- the recommender served on the mesh, and Fleet.reshard of it --
    kw = dict(dense_dim=MESH_DLRM_DENSE, tables=MESH_DLRM_TABLES,
              embed_dim=MESH_DLRM_EMBED, slots=MESH_DLRM_SLOTS,
              bottom=(64,), top=(64,))
    rows = loadgen.recommender_rows(
        MESH_SERVE_DLRM_ROWS, dense=MESH_DLRM_DENSE,
        tables=tuple((r, MESH_DLRM_SLOTS) for _, r in MESH_DLRM_TABLES),
        seed=32)
    base = TorchModel(inputCol="x", outputCol="y").set_model(
        "recommender_dlrm", seed=0, **kw)

    def rec(mesh):
        m = base.copy()
        m.set_params(meshSpec=mesh)
        return m

    def serve_rec(m):
        with Server({"rec": m}, max_batch=MESH_SERVE_DLRM_BUCKET,
                    max_wait_ms=1.0) as srv:
            entry = srv.registry.get("rec")
            entry.program_for(MESH_SERVE_DLRM_BUCKET,
                              rows[:MESH_SERVE_DLRM_BUCKET])
            ch.rank_stats(reset=True)
            t0 = time.perf_counter()
            got = srv.submit_many("rec", rows, timeout=300)
            wall = time.perf_counter() - t0
            stats = ch.rank_stats()
            tables = [(devmem.shard_bytes_of(p), devmem.param_bytes({n: p}))
                      for n, p in entry.module.named_parameters()
                      if n.endswith("_embedding")]
        m.release_placement()
        return np.asarray(got), wall, stats, tables
    want, wall1, _, tabs1 = serve_rec(rec(None))
    got, wall, stats, tabs = serve_rec(rec(cfg["dlrm"]))
    check(bool(np.array_equal(got, want)),
          "mesh_serve dlrm: scores not bit-equal to one rank's "
          f"(max {float(np.abs(got - want).max())})")
    check(all(local * 2 == whole for local, whole in tabs),
          f"mesh_serve dlrm: table bytes a rank {tabs}")
    out["dlrm"] = dict(
        mesh=cfg["dlrm"], rows=MESH_SERVE_DLRM_ROWS,
        bucket=MESH_SERVE_DLRM_BUCKET, bit_equal=True,
        rows_per_s=MESH_SERVE_DLRM_ROWS / wall,
        rows_per_s_per_rank=MESH_SERVE_DLRM_ROWS / wall
        / math.prod(cfg["dlrm"].values()),
        one_rank_rows_per_s=MESH_SERVE_DLRM_ROWS / wall1,
        table_bytes_per_rank=[t[0] for t in tabs],
        logical_table_bytes=[t[1] for t in tabs1],
        host_copies=[st["host_copies"] for st in stats],
        max_allocated_bytes=[st["max_allocated_bytes"] for st in stats])
    x = rows[:1]
    answers, errors = [], []
    with Fleet({"rec": base}, replicas=MESH_SERVE_FLEET_REPLICAS,
               server_kwargs={"max_batch": 4}) as fleet:
        first = fleet.submit("rec", x)
        stop = threading.Event()

        def fire():
            while not stop.is_set():
                try:
                    answers.append(fleet.submit("rec", x))
                except Exception as e:      # reported by the gate below
                    errors.append(f"{type(e).__name__}: {e}")
                    return
        fired = threading.Thread(target=fire, daemon=True)
        fired.start()
        try:
            wide = fleet.reshard(cfg["reshard"], warm_x=x)
            after = fleet.submit("rec", x)
            narrow = fleet.reshard(None, warm_x=x)
        finally:
            stop.set()
            fired.join(timeout=60)
    statuses = [[r["status"] for r in rep["replicas"]]
                for rep in (wide, narrow)]
    check(not errors and answers, f"mesh_serve reshard: errors {errors}")
    check(all(np.array_equal(a, first) for a in answers + [after]),
          "mesh_serve reshard: an answer differs from the first")
    check(statuses == [["resharded"] * MESH_SERVE_FLEET_REPLICAS] * 2,
          f"mesh_serve reshard: statuses {statuses}")
    out["reshard"] = dict(
        shape=cfg["reshard"], replicas=MESH_SERVE_FLEET_REPLICAS,
        answers=len(answers), failed_requests=len(errors), bit_equal=True,
        statuses=statuses, seconds_to_mesh=wide["seconds"],
        seconds_back=narrow["seconds"])
    del base
    torch.cuda.empty_cache()

    # -- ResNet-50 featurize over the data ranks, K2 on each --
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    raw = np.random.default_rng(2).integers(
        0, 256, size=(MESH_SERVE_IMAGES, SRC, SRC, 3), dtype=np.uint8)
    imgs = np.empty(MESH_SERVE_IMAGES, dtype=object)
    for i in range(MESH_SERVE_IMAGES):
        imgs[i] = ImageValue(path=f"mem://mesh/{i}", data=raw[i])
    frame = Frame.from_dict({"row": np.arange(MESH_SERVE_IMAGES)},
                            num_partitions=2).with_column_values(
        ColumnSchema("image", DType.IMAGE), imgs)

    def featurize(mesh):
        fz = ImageFeaturizer(inputCol="image", outputCol="features",
                             cutOutputLayers=1, miniBatchSize=BATCH,
                             computeDtype="bfloat16", meshSpec=mesh)
        fz.set_model("resnet50", num_classes=1000, seed=0)
        fz.transform(frame)                       # placed, built
        t0 = time.perf_counter()
        feats = np.asarray(fz.transform(frame).column("features"))
        return fz, feats, time.perf_counter() - t0
    fz1, want, s1 = featurize(None)
    del fz1
    ch.rank_stats(reset=True)
    fz, got, s2 = featurize(cfg["featurize"])
    stats = ch.rank_stats()
    fz._tm_cache.release_placement()
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))
    check(got.shape == (MESH_SERVE_IMAGES, 2048) and err <= 0.02,
          f"mesh_serve featurize: {got.shape}, {err} from one rank")
    k2n = _rank_launches(stats, k2)
    # two passes (the warm one included) of one batch, split over the
    # data ranks: K2 twice on every rank
    check(k2n == [2] * len(stats),
          f"mesh_serve featurize: {k2} launches {k2n} a rank")
    out["featurize"] = dict(
        mesh=cfg["featurize"], images=MESH_SERVE_IMAGES, rel_err=err,
        images_per_s=MESH_SERVE_IMAGES / s2,
        images_per_s_per_rank=MESH_SERVE_IMAGES / s2 / len(stats),
        one_rank_images_per_s=MESH_SERVE_IMAGES / s1,
        launches={f"rank{r}": n for r, n in enumerate(k2n)},
        host_copies=[st["host_copies"] for st in stats],
        max_allocated_bytes=[st["max_allocated_bytes"] for st in stats])
    out["placements_left"] = len(ch.placements)
    check(not ch.refs, f"mesh_serve: placements still held {ch.refs}")
    out["seconds"] = time.perf_counter() - t_phase
    out["failed"] = failed
    return out


def _mesh_reference(torch, kernels) -> dict:
    """The one-rank, one-card runs the meshed ones are held against: the
    same params, batches and steps through the trainer without a mesh."""
    ref = {"lm": _mesh_lm(torch, kernels, None, "full", False,
                          MESH_LM_WARMUP, MESH_LM_STEPS)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref["f32"] = _mesh_lm(torch, kernels, None, "full", True, 0,
                          MESH_F32_STEPS)
    ref["resnet_f32"] = _mesh_resnet(torch, kernels, None, True)
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    ref["resnet_f32"]["init"] = init_state(build_model(
        "resnet20_cifar", num_classes=10, dtype="float32")["module"], seed=0)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    ref["resnet"] = _mesh_resnet(torch, kernels, None)
    torch.cuda.empty_cache()
    ref["moe"] = _mesh_moe(torch, kernels, None, False, MESH_MOE_WARMUP,
                           MESH_MOE_STEPS)
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref["moe_nt"] = _mesh_moe(torch, kernels, None, False, MESH_MOE_WARMUP,
                              MESH_MOE_STEPS, record="all")
    torch.cuda.empty_cache()
    ref["moe32"] = _mesh_moe(torch, kernels, None, True, 0,
                             MESH_MOE_F32_STEPS, record=True)
    ref["pipe"] = {n: _mesh_pipe(torch, None, n) for n in (2, 4)}
    ref["dlrm"] = _mesh_dlrm(torch, None)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    ref["inputs_deep"] = _mesh_inputs_deep(torch, None)
    return ref


def phase_mesh(torch, kernels, card, cards: int = 1, keep_events=None
               ) -> dict:
    """Meshed training (see the module docstring, phase 20): the
    one-rank reference here, then ``cards`` ranks (two sharing this
    card when ``cards`` is 1) through ``python -m mmlspark_tpu_torch.cli
    run chip_smoke.py --nprocs N --platform cuda -- --mesh-child SPEC``.
    Returns each kernel's launches per rank and run."""
    import shutil
    import signal
    import tempfile
    if cards > 1 and torch.cuda.device_count() < cards:
        raise RuntimeError(f"--mesh-cards {cards} needs {cards} cards; "
                           f"{torch.cuda.device_count()} are visible")
    t_phase = time.perf_counter()
    ref = _mesh_reference(torch, kernels)
    reference_s = time.perf_counter() - t_phase
    ranks_n = 2 if cards == 1 else cards
    backend = "gloo" if cards == 1 else "nccl"
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh-")
    print(f"mesh: work dir {work}", file=sys.stderr, flush=True)
    spec = {"cards": cards, "work": work, "spawn_t": time.time()}
    env = dict(os.environ, MMLSPARK_TPU_TORCH_RUNTIME_DIST_BACKEND=backend)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, "-m", "mmlspark_tpu_torch.cli", "run",
            os.path.abspath(__file__), "--nprocs", str(ranks_n),
            "--platform", "cuda", "--", "--mesh-child", json.dumps(spec)]
    proc = subprocess.Popen(argv, cwd=root, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        log, _ = proc.communicate(timeout=MESH_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    ranks_s = time.perf_counter() - t_phase
    if proc.returncode != 0:
        print(log[-6000:], file=sys.stderr, flush=True)
    _check(proc.returncode == 0, f"mesh ranks exited {proc.returncode}")
    ranks = []
    for r in range(ranks_n):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out = _mesh_report(kernels, cards, ref, ranks, work,
                       stated=_stated(log),
                       ranks_s=ranks_s, reference_s=reference_s,
                       rank0_run_s=ranks[0]["run_s"], backend=backend,
                       phase_s=time.perf_counter() - t_phase)
    # mesh_inputs: the meshed run_dataset's launches, then its gates
    inputs_work = os.path.join(work, "inputs")
    os.makedirs(inputs_work)
    t0 = time.perf_counter()
    stream = _mesh_inputs_stream(torch, cards, inputs_work)
    stream["s"] = time.perf_counter() - t0
    out["k1_inputs"] = _mesh_inputs_report(ref, ranks, stream)
    if keep_events is not None:
        for role, path in stream["events"].items():
            if os.path.exists(path):
                shutil.copy(path, os.path.join(
                    keep_events, f"mesh_inputs_{role}-0.jsonl"))
    shutil.rmtree(work, ignore_errors=True)
    return out


def _stated(log: str) -> list:
    """The ranks' device statements (the JSON objects ``cli run``'s ranks
    print on stderr; two ranks may write theirs onto one line)."""
    dec, out = json.JSONDecoder(), []
    for line in log.splitlines():
        i = line.find('{"rank"')
        while i >= 0:
            try:
                obj, end = dec.raw_decode(line, i)
            except ValueError:
                break
            out.append(obj)
            i = line.find('{"rank"', end)
    return out


def _mesh_report(kernels, cards, ref, ranks, work, **extra) -> dict:
    """The mesh phase's gates over the ranks' results, and its line
    (printed with the failed gates, which then fail the phase)."""
    ranks_n = len(ranks)
    failed = []

    def _check(ok, what):
        if not ok:
            failed.append(what)
    tc, f32, k1 = (kernels.FLASH_ATTENTION_TC.name,
                   kernels.FLASH_ATTENTION.name, kernels.FUSED_NORMALIZE.name)
    steps = MESH_LM_WARMUP + MESH_LM_STEPS
    report = {"lm": {}, "f32": {}}
    # bf16 LM: losses against the one-rank run, K3's tensor-core kernel 6
    # times a step on every rank, no other kernel, no counted sync between
    # the timed steps (no flush falls in the window)
    for name, _, _ in _mesh_configs(cards)["lm"]:
        runs = [r["lm"][name] for r in ranks]
        rel = max(_max_step_rel(run["losses"], ref["lm"]["losses"])
                  for run in runs)
        _check(rel <= LM_BF16_TRAIN_TOL,
               f"mesh {name}: bf16 losses {rel} from one rank")
        for run in runs:
            _check(run["launches"] == _want(kernels, FLASH_ATTENTION_TC=
                                            LM_DEPTH * steps),
                   f"mesh {name}: launches {run['launches']}")
            _check(run["window_syncs"] == 0,
                   f"mesh {name}: {run['window_syncs']} counted syncs")
        step_ms = max(run["step_ms"] for run in runs)
        report["lm"][name] = dict(
            max_step_rel=rel, losses=runs[0]["losses"],
            step_ms=[run["step_ms"] for run in runs],
            tokens_per_s_per_rank=runs[0]["tokens_per_step"]
            / (step_ms / 1e3) / ranks_n,
            one_rank_step_ms=ref["lm"]["step_ms"],
            one_rank_tokens_per_s=ref["lm"]["tokens_per_step"]
            / (ref["lm"]["step_ms"] / 1e3),
            window_syncs=[run["window_syncs"] for run in runs],
            nccl_ms_per_step=[run.get("nccl_ms_per_step") for run in runs],
            transport_host_copies=[run["host_copies"] for run in runs],
            launches={f"rank{r}": run["launches"][tc]
                      for r, run in enumerate(runs)})
    # the fp32 gate: 1e-5, K3's CUDA-core kernel twice a step but none
    # under the ring (plain torch, as the reference's jnp body)
    for name, _, impl in _mesh_configs(cards)["f32"]:
        runs = [r["f32"][name] for r in ranks]
        rel = max(_max_step_rel(run["losses"], ref["f32"]["losses"])
                  for run in runs)
        _check(rel <= MESH_F32_TOL, f"mesh {name}: fp32 losses {rel}")
        want = _want(kernels, FLASH_ATTENTION=0 if impl == "ring" else
                     LM_F32_DEPTH * MESH_F32_STEPS)
        for run in runs:
            _check(run["launches"] == want,
                   f"mesh {name} fp32: launches {run['launches']}")
        report["f32"][name] = dict(
            max_step_rel=rel, launches={f"rank{r}": run["launches"][f32]
                                        for r, run in enumerate(runs)})
    # ResNet-20 data parallel: K1 once a step on each rank's rows, every
    # rank's parameters bit-equal, the losses near the one-rank run's
    res = [r["resnet"] for r in ranks]
    params = [np.load(os.path.join(work, f"resnet_rank{r}.npz"))
              for r in range(ranks_n)]
    bit_equal = all(np.array_equal(p[k], params[0][k])
                    for p in params[1:] for k in params[0].files)
    _check(bit_equal, "mesh resnet: ranks' parameters differ")
    rel = max(_max_step_rel(run["losses"], ref["resnet"]["losses"])
              for run in res)
    first = max(_max_step_rel(run["losses"][:1], ref["resnet"]["losses"][:1])
                for run in res)
    _check(first <= LM_BF16_TRAIN_TOL, f"mesh resnet: first loss {first}")
    per_step = [_max_step_rel([a], [b]) for a, b in
                zip(res[0]["losses"], ref["resnet"]["losses"])]
    param_diff = max(float(np.max(np.abs(params[0][k] -
                                          ref["resnet"]["params"][k])))
                     for k in params[0].files)
    for run in res:
        _check(run["launches"] == _want(kernels, FUSED_NORMALIZE=
                                        MESH_RESNET_STEPS),
               f"mesh resnet: launches {run['launches']}")
        _check(run["local_rows"] == TRAIN_BATCH // ranks_n,
               f"mesh resnet: {run['local_rows']} rows a rank")
    # the fp32 twin (TF32 off): the data-parallel sums alone
    res32 = [r["resnet_f32"] for r in ranks]
    params32 = [np.load(os.path.join(work, f"resnet_f32_rank{r}.npz"))
                for r in range(ranks_n)]
    rel32 = max(_max_step_rel(run["losses"], ref["resnet_f32"]["losses"])
                for run in res32)
    first32 = max(_max_step_rel(run["losses"][:1],
                                ref["resnet_f32"]["losses"][:1])
                  for run in res32)
    _check(first32 <= MESH_F32_TOL, f"mesh resnet fp32: first loss {first32}")
    per_step32 = [_max_step_rel([a], [b]) for a, b in
                  zip(res32[0]["losses"], ref["resnet_f32"]["losses"])]
    want = ref["resnet_f32"]["first_update"]
    start = ref["resnet_f32"]["init"]
    update = math.sqrt(sum(float(np.sum((want[k] - start[k]) ** 2))
                           for k in want))
    update_diff = max_abs = 0.0
    for r in range(ranks_n):
        got = np.load(os.path.join(work, f"resnet_f32_first_rank{r}.npz"))
        update_diff = max(update_diff, math.sqrt(sum(
            float(np.sum((got[k] - want[k]) ** 2)) for k in got.files)))
        max_abs = max(max_abs, max(float(np.max(np.abs(got[k] - want[k])))
                                   for k in got.files))
    _check(update_diff <= MESH_UPDATE_TOL * update,
           f"mesh resnet fp32: first update off by {update_diff} "
           f"(norm of the update {update})")
    _check(all(np.array_equal(p[k], params32[0][k]) for p in params32[1:]
               for k in params32[0].files),
           "mesh resnet fp32: ranks' parameters differ")
    param_diff32 = max(float(np.max(np.abs(
        params32[0][k] - ref["resnet_f32"]["params"][k])))
        for k in params32[0].files)
    step_ms = max(run["step_ms"] for run in res)
    report["resnet"] = dict(
        first_step_rel=first, step_rel=per_step, fp32_first_step_rel=first32,
        fp32_first_update_rel=update_diff / update,
        fp32_first_update_max_abs_diff=max_abs, fp32_step_rel=per_step32,
        fp32_max_step_rel=rel32,
        fp32_max_param_abs_diff_vs_one_rank=param_diff32,
        mesh=_mesh_configs(cards)["resnet"], max_step_rel=rel,
        ranks_bit_equal=bit_equal, max_param_abs_diff_vs_one_rank=param_diff,
        step_ms=[run["step_ms"] for run in res],
        images_per_s_per_rank=TRAIN_BATCH / (step_ms / 1e3) / ranks_n,
        one_rank_images_per_s=TRAIN_BATCH
        / (ref["resnet"]["step_ms"] / 1e3),
        transport_host_copies=[run["host_copies"] for run in res],
        launches={f"rank{r}": run["launches"][k1]
                  for r, run in enumerate(res)})
    # the checkpoint: every restore equal to the save, on the new shape
    for r in ranks:
        for i, c in enumerate(r["checkpoint"]):
            _check(c["restored_equal"], f"mesh checkpoint {c['mesh']}: "
                                        "restored params differ")
            _check(c["step"] == MESH_CKPT_STEPS * (i + 1) and all(
                math.isfinite(x) for x in c["losses"]),
                f"mesh checkpoint {c['mesh']}: {c}")
    report["checkpoint"] = [
        {k: c[k] for k in ("mesh", "step", "local_query_rows",
                           "restored_equal")}
        for c in ranks[0]["checkpoint"]]
    report.update(_mesh_report_6b(kernels, cards, ref, ranks, work,
                                  _check))
    # serving on the mesh: its gates ran on rank 0, the leader
    serve = ranks[0]["serve"]
    for what in serve["failed"]:
        _check(False, what)
    _check(all(r["serve"].get("follower_commands", 1) > 0
               for r in ranks[1:]), "mesh_serve: a follower ran nothing")
    report["serve"] = serve
    _line(phase="mesh", card=_smi(), cards=cards, ranks=ranks_n,
          sharing=("two ranks share one card over gloo: the step times "
                   "are not a scaling figure" if cards == 1 else
                   "one rank a card over NCCL"),
          devices=[r["device"] for r in ranks],
          spawn_to_mesh_ms=[r["spawn_to_mesh_ms"] for r in ranks],
          max_allocated_bytes=[r["max_allocated_bytes"] for r in ranks],
          failed=failed, **report, **extra)
    if failed:
        raise RuntimeError(f"chip_smoke check failed: mesh: {failed}")
    name = _mesh_configs(cards)["moe"][0]
    return {"tc": {**{n: v["launches"] for n, v in report["lm"].items()},
                   f"moe_{name}": report["moe"]["launches"],
                   "serve_lm": serve["lm"]["launches"],
                   "serve_generate": serve["generate"]["launches"]},
            "f32": {**{n: v["launches"] for n, v in report["f32"].items()},
                    f"moe_{name}": report["moe"]["fp32_launches"],
                    "serve_score": serve["fp32"]["launches_score"],
                    "serve_generate": serve["fp32"]["launches_generate"]},
            "k1": report["resnet"]["launches"],
            "k2": {"serve_featurize": serve["featurize"]["launches"]}}


def _mesh_report_6b(kernels, cards, ref, ranks, work, _check) -> dict:
    """The gates of the mesh phase's slice-6b-i runs (module docstring,
    phase 20) and their part of its line."""
    cfg = _mesh_configs(cards)
    tc, f32 = kernels.FLASH_ATTENTION_TC.name, kernels.FLASH_ATTENTION.name
    ranks_n = len(ranks)
    # the MoE LM: losses against one rank, K3 on every rank, E/|expert|
    # experts a rank; fp32: the first step's routing equal to one rank's
    name, axes = cfg["moe"]
    e = axes["expert"]
    runs = [r["moe"]["bf16"] for r in ranks]
    rel = max(_max_step_rel(run["losses"], ref["moe"]["losses"])
              for run in runs)
    _check(rel <= MESH_MOE_BF16_TOL, f"mesh moe {name}: bf16 losses {rel}")
    step_rel = [_max_step_rel([a], [b]) for a, b in
                zip(runs[0]["losses"], ref["moe"]["losses"])]
    steps = MESH_MOE_WARMUP + MESH_MOE_STEPS
    held = [[[8 // e, 512, 2048], [8 // e, 2048, 512]]]
    for run in runs:
        _check(run["launches"] == _want(kernels, FLASH_ATTENTION_TC=LM_DEPTH
                                        * steps),
               f"mesh moe {name}: launches {run['launches']}")
        _check(run["window_syncs"] == 0,
               f"mesh moe {name}: {run['window_syncs']} counted syncs")
        _check(run["experts_held"] == held,
               f"mesh moe {name}: experts held {run['experts_held']}")
    runs32 = [r["moe"]["f32"] for r in ranks]
    rel32 = max(_max_step_rel(run["losses"], ref["moe32"]["losses"])
                for run in runs32)
    _check(rel32 <= MESH_F32_TOL, f"mesh moe {name}: fp32 losses {rel32}")
    routing_equal = True
    for r, run in enumerate(runs32):
        _check(run["launches"] == _want(kernels, FLASH_ATTENTION=LM_F32_DEPTH
                                        * MESH_MOE_F32_STEPS),
               f"mesh moe {name} fp32: launches {run['launches']}")
        got = np.load(os.path.join(work, f"moe_routing_rank{r}.npz"))
        for key in got.files:
            n = got[key].shape[0]
            want = ref["moe32"]["routing"][key][run["block"] * n:
                                                (run["block"] + 1) * n]
            routing_equal &= bool(np.array_equal(got[key], want))
    _check(routing_equal, f"mesh moe {name} fp32: the first step's gate "
                          "indices or slot positions differ from one rank's")
    # the bf16 MoE with TF32 off: losses at the dense LM's bf16 bound and
    # every step's routing equal to one rank's
    runs_nt = [r["moe"]["bf16_tf32_off"] for r in ranks]
    rel_nt = max(_max_step_rel(run["losses"], ref["moe_nt"]["losses"])
                 for run in runs_nt)
    step_rel_nt = [_max_step_rel([a], [b]) for a, b in
                   zip(runs_nt[0]["losses"], ref["moe_nt"]["losses"])]
    # entries of each step's gate indices / slot positions (per MoE block
    # j, as "<step>_<name>_<j>") that differ from one rank's, and of how
    # many
    routing_nt, sizes_nt = {}, {}
    for r, run in enumerate(runs_nt):
        got = np.load(os.path.join(work, f"moe_notf32_routing_rank{r}.npz"))
        for key in got.files:
            n = got[key].shape[0]
            want = ref["moe_nt"]["routing"][key][run["block"] * n:
                                                 (run["block"] + 1) * n]
            routing_nt[key] = routing_nt.get(key, 0) + int(
                (got[key] != want).sum())
            sizes_nt[key] = sizes_nt.get(key, 0) + int(want.size)
    _check(rel_nt <= LM_BF16_TRAIN_TOL,
           f"mesh moe {name} bf16, TF32 off: losses {rel_nt} from one rank")
    # the first step's first MoE block routes the same input on both runs
    # (everything before it is replicated): its routing must be equal
    _check(routing_nt["s0_gate_idx_0"] == 0
           and routing_nt["s0_position_0"] == 0,
           f"mesh moe {name} bf16, TF32 off: the first step's first MoE "
           f"block routes differently from one rank: {routing_nt}")
    step_ms = max(run["step_ms"] for run in runs)
    moe = dict(
        mesh=axes, max_step_rel=rel, step_rel=step_rel, bound=
        MESH_MOE_BF16_TOL, losses=runs[0]["losses"],
        fp32_max_step_rel=rel32, fp32_routing_equal=routing_equal,
        tf32_off_max_step_rel=rel_nt, tf32_off_step_rel=step_rel_nt,
        tf32_off_routing_entries_differing=routing_nt,
        tf32_off_routing_entries=sizes_nt,
        tf32_off_losses=runs_nt[0]["losses"],
        tf32_off_one_rank_losses=ref["moe_nt"]["losses"],
        step_ms=[run["step_ms"] for run in runs],
        tokens_per_s_per_rank=runs[0]["tokens_per_step"]
        / (step_ms / 1e3) / ranks_n,
        one_rank_step_ms=ref["moe"]["step_ms"],
        one_rank_tokens_per_s=ref["moe"]["tokens_per_step"]
        / (ref["moe"]["step_ms"] / 1e3),
        window_syncs=[run["window_syncs"] for run in runs],
        transport_host_copies=[run["host_copies"] for run in runs],
        max_allocated_bytes=[run["max_allocated_bytes"] for run in runs],
        experts_held=runs[0]["experts_held"],
        launches={f"rank{i}": run["launches"][tc]
                  for i, run in enumerate(runs)},
        fp32_launches={f"rank{i}": run["launches"][f32]
                       for i, run in enumerate(runs32)})
    # the pipelines: losses against the sequential one-rank run, the hops'
    # host copies counted on gloo; the reshard's restores equal its saves
    gloo = cards == 1
    pipe = {}
    for pname, shape, stages in cfg["pipe"]:
        runs = [r["pipe"][pname] for r in ranks]
        prel = max(_max_step_rel(run["losses"], ref["pipe"][stages]["losses"])
                   for run in runs)
        _check(prel <= MESH_F32_TOL, f"mesh pipe {pname}: losses {prel}")
        for run in runs:
            _check(run["stage_shifts"] > 0 and (
                run["host_copies"] >= run["stage_shifts"] if gloo
                else run["host_copies"] == 0),
                f"mesh pipe {pname}: {run['host_copies']} host copies for "
                f"{run['stage_shifts']} stage hops")
        pipe[pname] = dict(
            mesh=shape, stages=stages, max_step_rel=prel,
            losses=runs[0]["losses"],
            step_ms=[run["step_ms"] for run in runs],
            one_rank_step_ms=ref["pipe"][stages]["step_ms"],
            stage_hops=[run["stage_shifts"] for run in runs],
            transport_host_copies=[run["host_copies"] for run in runs],
            stage_leaf_shape=[run["up_shape"] for run in runs])
    runs = [r["pipe_reshard"] for r in ranks]
    rrel = max(_max_step_rel(run["losses"], ref["pipe"][2]["losses"])
               for run in runs)
    _check(rrel <= MESH_F32_TOL, f"mesh pipe reshard: losses {rrel}")
    for run in runs:
        _check(run["restores_equal"] == [True, True],
               f"mesh pipe reshard: restores {run['restores_equal']}")
        _check(run["mesh"]["pipe"] == 1 and len(run["losses"])
               == MESH_PIPE_STEPS, f"mesh pipe reshard: {run}")
    pipe["reshard"] = dict(shapes=cfg["reshard"], at=MESH_PIPE_RESHARD_AT,
                           max_step_rel=rrel,
                           restores_equal=runs[0]["restores_equal"])
    # the DLRM: the fused lookup bit-equal to the reference, losses within
    # MESH_DLRM_TOL, half the table bytes a rank at tensor 2, and no table
    # gradient in any all-reduce (the collectives' own counters)
    runs = [r["dlrm"] for r in ranks]
    t = int(cfg["dlrm"].split("x")[1])
    data = int(cfg["dlrm"].split("x")[0])
    bags_equal = all(np.array_equal(
        np.load(os.path.join(work, f"dlrm_bags_rank{r}.npy")),
        ref["dlrm"]["bags"]) for r in range(ranks_n))
    _check(bags_equal, "mesh dlrm: the fused lookup differs from "
                       "bag_lookup_reference")
    drel = max(float(np.max(np.abs(np.asarray(run["losses"])
                                   - np.asarray(ref["dlrm"]["losses"]))))
               for run in runs)
    _check(drel <= MESH_DLRM_TOL, f"mesh dlrm: losses {drel} from one rank")
    for run in runs:
        _check(run["table_bytes"] * t == run["logical_table_bytes"],
               f"mesh dlrm: {run['table_bytes']} table bytes a rank")
        reduced = run["traffic"].get("all_reduce", {}).get("bytes", 0)
        want = MESH_DLRM_STEPS * (run["dense_bytes"] + 4) if data > 1 else 0
        _check(reduced == want and len(run["summed"]) == 2,
               f"mesh dlrm: all-reduced {reduced} bytes, dense gradients "
               f"and losses are {want}; summed {run['summed']}")
    step_ms = max(run["step_ms"] for run in runs)
    dlrm = dict(
        mesh=cfg["dlrm"], max_abs_loss_diff=drel, fused_bags_bit_equal=
        bags_equal, losses=runs[0]["losses"],
        one_rank_losses=ref["dlrm"]["losses"],
        step_ms=[run["step_ms"] for run in runs],
        rows_per_s_per_rank=MESH_DLRM_BATCH / (step_ms / 1e3) / ranks_n,
        one_rank_step_ms=ref["dlrm"]["step_ms"],
        table_bytes_per_rank=runs[0]["table_bytes"],
        logical_table_bytes=runs[0]["logical_table_bytes"],
        traffic=[run["traffic"] for run in runs],
        transport_host_copies=[run["host_copies"] for run in runs])
    return {"moe": moe, "pipe": pipe, "dlrm": dlrm}


# -- PR 17: multi-process training inputs and the run's record ---------------

def _ring_ab(run, rounds=RING_ROUNDS) -> dict:
    """``run()`` with the flight recorder's ring off, then on (its
    default), ``rounds`` times in turn; each round's result by setting."""
    from mmlspark_tpu_torch.utils import config
    out = {"off": [], "on": []}
    for _ in range(rounds):
        for mode in ("off", "on"):
            if mode == "off":
                config.set("observability.flight_recorder_size", 0)
            try:
                out[mode].append(run())
            finally:
                config.unset("observability.flight_recorder_size")
    return out


def _mesh_inputs_deep(torch, mesh, blocks=2) -> dict:
    """(a) of mesh_inputs: the deep cell's DeepClassifier, fp32 with TF32
    off, on this rank's ``process_shard(block_rows=local rows)`` under
    ``mesh``, or on the whole frame with ``mesh`` None (the one-rank
    reference). Returns every step's loss (read once, after the fit), the
    final loss, params, predictions of the whole frame, rows/s and the
    sha256 of every cached batch of both epochs: this rank's block of
    each, or with ``mesh`` None each of the ``blocks`` blocks of each
    global batch."""
    import hashlib
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.parallel import sharding
    from mmlspark_tpu_torch.parallel import trainer as ptrainer
    from mmlspark_tpu_torch.train.deep import DeepClassifier
    from mmlspark_tpu_torch.train.learners import _epoch_device_cache
    rng = np.random.default_rng(5)
    X = rng.normal(size=(DEEP_ROWS, DEEP_FEATURES)).astype(np.float32)
    y = (X @ rng.normal(size=DEEP_FEATURES) > 0).astype(np.int64)
    frame = whole = Frame.from_dict({"features": X, "label": y})
    local = MI_DEEP_BATCH if mesh is None \
        else sharding.local_batch_rows(mesh, MI_DEEP_BATCH)
    if mesh is not None:
        frame = frame.process_shard(sharding.batch_block(mesh),
                                    sharding.batch_share(mesh)[1],
                                    block_rows=local)
    learner = DeepClassifier(architecture="mlp_tabular",
                             batchSize=MI_DEEP_BATCH, epochs=MI_DEEP_EPOCHS,
                             deviceCache="on", trainDtype="float32",
                             meshSpec=mesh)
    learner.set_params(featuresCol="features", labelCol="label")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # each step's loss kept on the device (no sync in the fit)
    real_step, losses = ptrainer.DistributedTrainer.train_step, []

    def train_step(self, state, batch, rng=None):
        state, m = real_step(self, state, batch, rng)
        losses.append(m["loss"].detach().clone())
        return state, m
    ptrainer.DistributedTrainer.train_step = train_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = learner.fit(frame)
        fit_s = time.perf_counter() - t0
    finally:
        ptrainer.DistributedTrainer.train_step = real_step
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    pred = np.asarray(model.transform(whole).column("prediction"))
    steps = DEEP_ROWS // MI_DEEP_BATCH
    cache = _epoch_device_cache(
        frame, "features", "label", MI_DEEP_BATCH, learner._y_dtype,
        seed=learner.seed, force=True, mesh=mesh,
        local_batch=None if mesh is None else local,
        steps=None if mesh is None else steps)
    hashes = []
    for e in range(MI_DEEP_EPOCHS):
        for b in cache.batches(e):
            host = {k: v.cpu().numpy() for k, v in sorted(b.items())}
            cut = [slice(None)] if mesh is not None else [
                slice(i * local // blocks, (i + 1) * local // blocks)
                for i in range(blocks)]
            hashes.append([hashlib.sha256(b"".join(
                np.ascontiguousarray(v[c]).tobytes()
                for v in host.values())).hexdigest() for c in cut])
    return {"final_loss": float(model._state["final_loss"]),
            "losses": torch.stack(losses).float().cpu().tolist(),
            "prediction": pred.astype(np.int64).tolist(),
            "params": {k: np.asarray(v) for k, v in
                       model._state["params"].items()},
            "rows": frame.count(), "fit_s": fit_s,
            "rows_per_s": frame.count() * MI_DEEP_EPOCHS / fit_s,
            "batch_sha256": hashes}


def _mesh_inputs_verdict(torch, mesh, rank) -> dict:
    """(c) of mesh_inputs: the resident-epoch verdict of the deep cell's
    shard on every rank, with room on every rank, then with rank 1's
    ``runtime.device_cache_mb`` under its epoch."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.parallel import sharding
    from mmlspark_tpu_torch.train.learners import _epoch_device_cache
    from mmlspark_tpu_torch.utils import config
    rng = np.random.default_rng(5)
    X = rng.normal(size=(DEEP_ROWS, DEEP_FEATURES)).astype(np.float32)
    local = sharding.local_batch_rows(mesh, MI_DEEP_BATCH)
    frame = Frame.from_dict(
        {"features": X, "label": np.zeros(DEEP_ROWS, np.int64)}
    ).process_shard(sharding.batch_block(mesh),
                    sharding.batch_share(mesh)[1], block_rows=local)
    out = {}
    for name, mb in (("room_on_every_rank", None),
                     ("rank1_under_its_epoch", 1 if rank == 1 else None)):
        if mb is not None:
            config.set("runtime.device_cache_mb", mb)
        try:
            out[name] = _epoch_device_cache(
                frame, "features", "label", MI_DEEP_BATCH, np.int64,
                mesh=mesh, local_batch=local,
                steps=DEEP_ROWS // MI_DEEP_BATCH) is not None
        finally:
            config.unset("runtime.device_cache_mb")
    return out


def inputs_child(spec: dict) -> int:
    """One rank of mesh_inputs' meshed ``run_dataset`` (``--inputs-child
    SPEC``, under ``cli run --nprocs 2``): deterministic mode,
    stream_resume's lane on the launcher's data-parallel mesh, each rank
    streaming its own shard of the corpus (``FileSource(process_shard=
    True)``) at ``spec["batch"]`` rows a step and writing its own events
    log. Role A runs uninterrupted, B until its parent SIGKILLs both
    ranks, C resumes from B's directory once ``spec["go"]`` exists. Rank
    0 prints a ``mi_step`` line a step; each rank a summary line, and
    dumps its final state."""
    t_spawn = float(os.environ.get("SMOKE_SPAWN_T", time.time()))
    import torch
    import torch.distributed as dist
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.observability import syncs
    from mmlspark_tpu_torch.utils import config
    rank, role = dist.get_rank(), spec["role"]
    device = config.resolve_device()
    if device.type == "cuda":      # a CPU rehearsal builds nothing
        torch.cuda.set_device(device)
        kernels.build_all([kernels.FUSED_NORMALIZE])
    waited_s = _wait_for(spec.get("go"), MI_CHILD_TIMEOUT_S)
    config.set("observability.events_path",
               os.path.join(spec["work"], f"events_{role}-{rank}.jsonl"))
    ckpt_dir = spec["ckpt_a"] if role == "A" else spec["ckpt_b"]
    loop = _stream_lane(torch, ckpt_dir, spec["save_every"])
    k1 = kernels.FUSED_NORMALIZE
    marks = {"start": 0}
    real_restore = loop.restore_or_init

    def restore_or_init():
        out = real_restore()
        marks["start"] = out[1]
        return out
    loop.restore_or_init = restore_or_init
    real_step = loop.trainer.train_step
    done = [0]

    def train_step(state, batch, rng=None):
        out = real_step(state, batch, rng)
        done[0] += 1
        if done[0] == 1:
            syncs.synchronize("smoke.inputs_first_step", device)
            marks["first_step_t"] = time.time()
        if rank == 0:
            _line(mi_step=marks["start"] + done[0], k1=k1.launches)
        return out
    loop.trainer.train_step = train_step
    it = _stream_dataset(spec, process_shard=True).iter()
    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    t_run = time.perf_counter()
    state = loop.run_dataset(it, spec["steps"])
    launches = _launches(kernels)
    run_s = time.perf_counter() - t_run
    loop.ckpt.close()
    _dump_train_state(torch, state, os.path.join(
        spec["work"], f"final_{role}_rank{rank}.pt"))
    _line(mi_child=role, rank=rank, start=marks["start"],
          steps_run=done[0], launches=launches, device=str(device),
          deterministic=torch.are_deterministic_algorithms_enabled(),
          run_dataset_s=run_s,
          rows_per_s=done[0] * spec["batch"] / run_s, waited_s=waited_s,
          spawn_to_first_step_ms=(marks["first_step_t"] - t_spawn
                                  - waited_s) * 1e3)
    return 0


def _wait_for(path, timeout_s: float) -> float:
    """Seconds spent waiting until ``path`` exists (0 when no path is
    given); raises past ``timeout_s``."""
    if not path:
        return 0.0
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout_s:
            raise RuntimeError(f"no word at {path} in {timeout_s} s")
        time.sleep(0.05)
    return time.time() - t0


def _group_lines(proc, until=None) -> list:
    """JSON lines of a ``cli run`` launch's stdout until it exits, or until
    ``until(line)`` holds; a launch past ``MI_CHILD_TIMEOUT_S`` has its
    whole process group (the launcher and its ranks) killed."""
    import signal
    import threading
    timer = threading.Timer(MI_CHILD_TIMEOUT_S,
                            lambda: os.killpg(proc.pid, signal.SIGKILL))
    timer.start()
    lines = []
    try:
        for raw in proc.stdout:
            raw = raw.strip()
            if raw.startswith("{"):
                lines.append(json.loads(raw))
                if until is not None and until(lines[-1]):
                    break
    finally:
        timer.cancel()
    return lines


def _mesh_inputs_stream(torch, cards, work) -> dict:
    """(b) of mesh_inputs: runs A, B and C of the meshed run_dataset
    started together, both ranks of B SIGKILLed once rank 0 reports step
    MI_KILL_AT, then C, waiting until then, from B's directory; the
    gates' facts."""
    import signal
    backend = "gloo" if cards == 1 else "nccl"
    spec = dict(_stream_spec(work, deep=False, batch=SR_BATCH // 2,
                             kill_at=MI_KILL_AT), work=work)
    t0 = time.perf_counter()
    _write_corpus(spec)
    corpus_s = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MMLSPARK_TPU_TORCH_RUNTIME_DIST_BACKEND=backend,
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}

    go = os.path.join(work, "go_C")

    def launch(role, **extra):
        err = open(os.path.join(work, f"launch_{role}.err"), "w")
        procs[role] = subprocess.Popen(
            [sys.executable, "-m", "mmlspark_tpu_torch.cli", "run",
             os.path.abspath(__file__), "--nprocs", "2", "--platform",
             "cuda", "--", "--inputs-child",
             json.dumps(dict(spec, role=role, **extra))],
            cwd=root, env=dict(env, SMOKE_SPAWN_T=repr(time.time())),
            start_new_session=True, stdout=subprocess.PIPE, stderr=err,
            text=True)
        return procs[role]

    lines = {}
    try:
        launch("A")
        b = launch("B")
        c = launch("C", go=go)
        lines["B"] = _group_lines(
            b, until=lambda l: l.get("mi_step", 0) >= spec["kill_at"])
        os.killpg(b.pid, signal.SIGKILL)
        b.wait()
        b_steps = _listed_steps(spec["ckpt_b"])
        b_states = sorted(n for n in os.listdir(spec["ckpt_b"])
                          if n.startswith("data_state-"))
        open(go, "w").close()
        lines["A"] = _group_lines(procs["A"])
        lines["C"] = _group_lines(c)
        rcs = {r: p.wait() for r, p in procs.items() if r != "B"}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if any(rcs.values()):
        for role in rcs:
            with open(os.path.join(work, f"launch_{role}.err")) as f:
                print(f.read()[-4000:], file=sys.stderr, flush=True)
    summaries = {role: sorted((l for l in lines.get(role, ())
                               if "mi_child" in l), key=lambda l: l["rank"])
                 for role in ("A", "C")}
    finals = {(role, r): torch.load(
        os.path.join(work, f"final_{role}_rank{r}.pt"), weights_only=False)
        for role in ("A", "C") for r in (0, 1)
        if os.path.exists(os.path.join(work, f"final_{role}_rank{r}.pt"))}
    diffs = {f"C_vs_A_rank{r}": _unequal(torch, finals.get(("C", r)),
                                         finals.get(("A", r)))
             for r in (0, 1)}
    diffs["A_rank0_vs_rank1"] = _unequal(torch, finals.get(("A", 0)),
                                         finals.get(("A", 1)))
    killed_at = max((l["mi_step"] for l in lines["B"] if "mi_step" in l),
                    default=None)
    return dict(backend=backend, rcs=rcs, corpus_write_s=corpus_s,
                spec={k: spec[k] for k in ("files", "batch", "steps",
                                           "save_every", "kill_at")},
                b_killed_at_step=killed_at, b_steps_after_kill=b_steps,
                b_data_states_after_kill=b_states,
                summaries=summaries, unequal=diffs,
                events={role: os.path.join(work, f"events_{role}-0.jsonl")
                        for role in ("A", "C")})


def _mesh_inputs_report(ref, ranks, stream) -> dict:
    """The gates of mesh_inputs over (a) and (c) from the mesh ranks and
    (b) from its launches, and its line (printed with the failed gates,
    which then fail the phase). Returns K1's launches a rank."""
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)
    one = ref["inputs_deep"]
    deep = [r["inputs"]["deep"] for r in ranks]
    blocks = {r["inputs"]["block"] for r in ranks}
    rel = max(abs(d["final_loss"] - one["final_loss"])
              / abs(one["final_loss"]) for d in deep)
    want = np.asarray(one["losses"])
    step_rel = [np.abs(np.asarray(d["losses"]) - want) / np.abs(want)
                if len(d["losses"]) == len(want) else np.full(1, np.inf)
                for d in deep]
    gated = max(float(r[:MI_GATED_STEPS].max()) for r in step_rel)
    past = [int(np.argmax(r > MESH_F32_TOL)) if (r > MESH_F32_TOL).any()
            else None for r in step_rel]
    agree = min(float(np.mean(np.asarray(d["prediction"])
                              == np.asarray(one["prediction"])))
                for d in deep)
    check(gated <= MESH_F32_TOL,
          f"mesh_inputs deep: the first {MI_GATED_STEPS} steps' losses "
          f"rel {gated} from one rank's (limit {MESH_F32_TOL})")
    check(rel <= MI_XTOPO_RTOL and agree >= MI_XTOPO_AGREE,
          f"mesh_inputs deep: final loss rel {rel} (limit "
          f"{MI_XTOPO_RTOL}), predictions equal on {agree} of the rows "
          f"(limit {MI_XTOPO_AGREE})")
    param_diff = max(float(np.abs(np.asarray(d["params"][k]) - v).max())
                     for d in deep for k, v in one["params"].items())
    # the ranks of a data block hold the same rows
    check(sum(d["rows"] for d in deep) * len(blocks)
          == DEEP_ROWS * len(ranks), f"mesh_inputs deep: the shards hold "
                                     f"{[d['rows'] for d in deep]} rows")
    hashes_equal = all(
        [h[0] for h in d["batch_sha256"]]
        == [h[r["inputs"]["block"]] for h in one["batch_sha256"]]
        for d, r in zip(deep, ranks))
    check(hashes_equal, "mesh_inputs deep: a rank's cached batches differ "
                        "from its block of the one-rank cache's")
    verdicts = [r["inputs"]["verdict"] for r in ranks]
    check(all(v["room_on_every_rank"] for v in verdicts)
          and not any(v["rank1_under_its_epoch"] for v in verdicts),
          f"mesh_inputs verdict not AND-reduced: {verdicts}")
    summ = stream["summaries"]
    check(not any(stream["rcs"].values()),
          f"mesh_inputs run_dataset launches exited {stream['rcs']}")
    check(len(summ["A"]) == 2 and len(summ["C"]) == 2,
          f"mesh_inputs run_dataset: rank summaries {summ}")
    check(not any(stream["unequal"].values()),
          f"mesh_inputs run_dataset: resumed state not bit-equal "
          f"{stream['unequal']}")
    start = summ["C"][0]["start"] if summ["C"] else None
    check(bool(start) and all(c["start"] == start for c in summ["C"])
          and {f"data_state-{start}.p0.json", f"data_state-{start}.p1.json"}
          <= set(stream["b_data_states_after_kill"]),
          f"mesh_inputs run_dataset: C resumed from {start}, B left "
          f"{stream['b_data_states_after_kill']}")
    k1 = "fused_normalize"
    launches = {f"{role}_rank{s['rank']}": s["launches"][k1]
                for role in ("A", "C") for s in summ[role]}
    steps = stream["spec"]["steps"]
    check(all(s["launches"][k1] == s["steps_run"] > 0 and all(
        n == 0 for name, n in s["launches"].items() if name != k1)
        for role in ("A", "C") for s in summ[role])
        and all(s["steps_run"] == steps for s in summ["A"])
        and all(s["steps_run"] == steps - start for s in summ["C"]),
        f"mesh_inputs run_dataset: K1 launches {launches}, want one a "
        "step on every rank and no other kernel")
    check(all(s["deterministic"] for role in ("A", "C")
              for s in summ[role]), "mesh_inputs: a rank not deterministic")
    _line(phase="mesh_inputs", card=_smi(),
          deep=dict(rows=DEEP_ROWS, features=DEEP_FEATURES,
                    batch=MI_DEEP_BATCH, epochs=MI_DEEP_EPOCHS,
                    compute="float32, TF32 off",
                    shard_rows=[d["rows"] for d in deep],
                    steps=len(want), gated_steps=MI_GATED_STEPS,
                    gated_step_rel_max=gated, gated_limit=MESH_F32_TOL,
                    first_step_past_limit=past,
                    step_rel_max=[float(r.max()) for r in step_rel],
                    step_rel_every_16=[[float(x) for x in r[::16]]
                                       for r in step_rel],
                    final_loss_rel_vs_one_rank=rel,
                    final_limit=MI_XTOPO_RTOL,
                    predictions_equal_share=agree,
                    predictions_limit=MI_XTOPO_AGREE,
                    max_param_abs_diff_vs_one_rank=param_diff,
                    cached_batches_hashed=len(one["batch_sha256"]),
                    batch_hashes_equal=hashes_equal,
                    rows_per_s_per_rank=[d["rows_per_s"] for d in deep],
                    one_rank_rows_per_s=one["rows_per_s"],
                    fit_s=[d["fit_s"] for d in deep],
                    one_rank_fit_s=one["fit_s"]),
          verdict=verdicts,
          run_dataset=dict(
              backend=stream["backend"], **stream["spec"],
              launches_s=stream["s"],
              corpus_write_s=stream["corpus_write_s"],
              b_killed_at_step=stream["b_killed_at_step"],
              b_steps_after_kill=stream["b_steps_after_kill"],
              b_data_states_after_kill=stream["b_data_states_after_kill"],
              c_resumed_from=start, state_bit_equal=not any(
                  stream["unequal"].values()),
              rows_per_s_per_rank={f"{role}_rank{s['rank']}":
                                   s["rows_per_s"] for role in ("A", "C")
                                   for s in summ[role]},
              spawn_to_first_step_ms={
                  f"{role}_rank{s['rank']}": s["spawn_to_first_step_ms"]
                  for role in ("A", "C") for s in summ[role]},
              k1_launches=launches),
          failed=failed)
    if failed:
        raise RuntimeError(f"chip_smoke check failed: mesh_inputs: {failed}")
    return launches


def phase_record(torch, kernels, card, logs) -> dict:
    """The run's record on the card: a ``profiling.trace`` around train
    steps, which must write a trace naming K1's kernel; ``cli report
    --json --trace`` over the events logs of earlier phases (``logs``,
    name -> path), each trace validating; a watchdog stall on a fake
    heartbeat, which must write a flight-recorder dump."""
    import shutil
    import tempfile
    import torch.nn.functional as F
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.observability.trace import validate_trace
    from mmlspark_tpu_torch.ops.preprocess import make_preprocess_fn
    from mmlspark_tpu_torch.parallel.optim import sgd
    from mmlspark_tpu_torch.parallel.trainer import DistributedTrainer
    from mmlspark_tpu_torch.reliability import watchdog
    from mmlspark_tpu_torch.utils import config, profiling
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_record-")
    k1 = kernels.FUSED_NORMALIZE
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (TRAIN_BATCH, math.prod(TRAIN_SHAPE)),
                 dtype=np.uint8)).to(card),
             "label": torch.from_numpy(rng.integers(
                 0, 10, TRAIN_BATCH)).to(card)}
    pre = make_preprocess_fn(TRAIN_SHAPE, CIFAR_MEAN, CIFAR_STD)

    def init_fn():
        module = build_model("resnet20_cifar", num_classes=10,
                             dtype="bfloat16")["module"]
        module.load_state_dict({k: torch.from_numpy(v) for k, v in
                                init_state(module, seed=0).items()})
        return module
    trainer = DistributedTrainer(
        lambda m, b, g: F.cross_entropy(m(pre(b["image"])).float(),
                                        b["label"].long()),
        sgd(0.1, momentum=0.9))
    state = trainer.init(init_fn)
    state, _ = trainer.train_step(state, batch, 0)     # warm, untraced
    torch.cuda.synchronize()
    trace_dir = os.path.join(work, "trace")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        for _ in range(RECORD_TRACE_STEPS):
            state, _ = trainer.train_step(state, batch, 0)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    launches = _launches(kernels)
    written = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) \
        else []
    _check(len(written) == 1, f"profiling.trace wrote {written}, want one "
                              "trace")
    with open(os.path.join(trace_dir, written[0])) as f:
        text = f.read()
    named = [sym for sym in KERNEL_SYMBOLS[k1.name] if sym in text]
    _check(bool(named) and launches[k1.name] == RECORD_TRACE_STEPS,
           f"the trace names {named} of K1's {KERNEL_SYMBOLS[k1.name]}; "
           f"K1 launched {launches[k1.name]} times in "
           f"{RECORD_TRACE_STEPS} traced steps")

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    reports = {}
    for name, path in logs.items():
        out = os.path.join(work, f"{name}.trace.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mmlspark_tpu_torch.cli", "report", path,
             "--json", "--trace", out], cwd=root, env=env,
            capture_output=True, text=True, timeout=120)
        report_s = time.perf_counter() - t0
        _check(proc.returncode == 0, f"cli report {name} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(out) as f:
            problems = validate_trace(json.load(f))
        _check(not problems and rep["spans"] > 0,
               f"cli report {name}: {rep['spans']} spans, trace problems "
               f"{problems[:5]}")
        reports[name] = dict(events=rep["events"], spans=rep["spans"],
                             sections=sorted(k for k in rep if k not in (
                                 "path", "paths", "events", "spans",
                                 "metrics")),
                             syncs=rep.get("syncs", {}).get("total"),
                             trace_problems=len(problems),
                             trace_bytes=os.path.getsize(out),
                             report_s=report_s)

    config.set("observability.events_path",
               os.path.join(work, "events.jsonl"))
    hb = watchdog.register("smoke.fake_heartbeat", timeout_s=1.0)
    try:
        fired = watchdog.Watchdog(stall_timeout_s=1.0, start=False).check(
            now=hb.last + 5.0)
    finally:
        hb.close()
        config.unset("observability.events_path")
    dumps = sorted(n for n in os.listdir(work) if n.startswith("flightrec-"))
    header = {}
    if dumps:
        with open(os.path.join(work, dumps[0])) as f:
            header = json.loads(f.readline())
    _check([s.name for s in fired] == ["smoke.fake_heartbeat"]
           and len(dumps) == 1
           and header.get("reason") == "watchdog.stall.smoke.fake_heartbeat",
           f"watchdog stall: fired {[s.name for s in fired]}, dumps "
           f"{dumps}, header {header}")
    _line(phase="record", card=_smi(),
          trace=dict(steps=RECORD_TRACE_STEPS, file=written[0],
                     bytes=os.path.getsize(os.path.join(trace_dir,
                                                        written[0])),
                     k1_symbols_named=named, k1_launches=launches[k1.name],
                     traced_s=traced_s),
          reports=reports,
          stall_dump=dict(file=dumps[0], events=header.get("events"),
                          capacity=header.get("capacity")),
          phase_s=time.perf_counter() - t_phase)
    shutil.rmtree(work, ignore_errors=True)
    return launches


# -- capture, downloader, chaos, cli (slice 7a) -------------------------------

# the node captured at full width: the last bottleneck's output, whose mean
# over H and W is the ``pool`` layer
# the pretrained phase: the committed trained ResNet-20 (flax msgpack,
# 4 synthetic classes) and its golden pool table for 8 images; the
# golden tolerance is the reference test's (tests/test_convert.py), the
# float32 model's card features are held to the CPU's at 1e-3 (rtol and
# atol: fp32 convs summed in other orders, TF32 off)
PRETRAINED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "pretrained")
PRETRAINED_MSGPACK = os.path.join(PRETRAINED_DIR,
                                  "resnet20_synthetic.msgpack")
PRETRAINED_GOLDEN = os.path.join(PRETRAINED_DIR, "golden.npz")
PRETRAINED_GOLDEN_TOL, PRETRAINED_CPU_TOL = 2e-2, 1e-3
CAPTURE_NODE = "stage3_block2/out"
# passes timed per node in the capture phase
CAPTURE_PASSES = 3
# the single-process chaos scenarios run on the card, with their sizes
CHAOS_ON_CARD = (("train", {"requests": 12}),
                 ("fleet", {"replicas": 3, "requests": 12}),
                 ("decode", {"replicas": 2, "requests": 5}),
                 ("host", {"replicas": 2, "requests": 12}))
# the mesh-bound ones (cli chaos --nprocs), with their sizes; a launch of
# a scenario's ranks is killed after CHAOS_MESH_TIMEOUT_S
CHAOS_MESH = (("fleet_sharded", {"replicas": 3, "requests": 12}),
              ("decode_sharded", {"replicas": 2, "requests": 5}),
              ("recommender", {"requests": 12}),
              ("reshard", {"requests": 12}))
CHAOS_MESH_TIMEOUT_S = 300


def _featurize_frame(n: int):
    """The featurize phase's images (seed 2) as a flat uint8 column, and
    the raw array."""
    from mmlspark_tpu_torch.core.frame import Frame
    raw = np.random.default_rng(2).integers(
        0, 256, size=(n, SRC, SRC, 3), dtype=np.uint8)
    return Frame.from_dict({"x": raw.reshape(n, -1)}, num_partitions=4), raw


def _image_frame(images, prefix: str):
    """A frame of one IMAGE column ``image`` over uint8 HWC arrays."""
    from mmlspark_tpu_torch.core.frame import Frame
    from mmlspark_tpu_torch.core.schema import ColumnSchema, DType, ImageValue
    imgs = np.empty(len(images), dtype=object)
    for i, im in enumerate(images):
        imgs[i] = ImageValue(path=f"mem://{prefix}/{i}",
                             data=np.ascontiguousarray(im))
    return Frame.from_dict({"row": np.arange(len(images))}) \
        .with_column_values(ColumnSchema("image", DType.IMAGE), imgs)


def phase_capture(torch, kernels, card) -> dict:
    """Capture-all output nodes at full width: the featurize configuration
    (ResNet-50, 512 uint8 images 256^2 -> K2 -> 224^2, batch 128, bf16)
    scored through ``TorchModel`` with ``outputNodeName`` the last block's
    output (a forward hook) and ``pool``. Gates: K2's staged variant once
    a batch on each main path, no other kernel; the node (B, 7, 7, 2048)
    NHWC float32; its mean over H and W, taken in fp32 on the card in the
    module's own layout (channels-last NCHW), equal to ``pool`` within the
    rounding of a 49-term fp32 mean (48 * 2^-24 * the row's mean |x|), and
    whether it is bit-equal printed."""
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    frame, _ = _featurize_frame(N_IMAGES)
    batches = math.ceil(N_IMAGES / BATCH)

    def model(node):
        tm = TorchModel(inputCol="x", outputCol="f", miniBatchSize=BATCH,
                        computeDtype="bfloat16", outputNodeName=node,
                        devicePreprocess={"srcShape": [SRC, SRC, 3],
                                          "resize": [DST, DST]})
        return tm.set_model("resnet50", num_classes=1000, seed=0)

    out, rates, launches = {}, {}, {}
    for node in (CAPTURE_NODE, "pool"):
        tm = model(node)
        kernels.reset_launches()
        got = np.asarray(tm.transform(frame).column("f"))
        launches[node] = _launches(kernels)
        variants = dict(kernels.CROP_RESIZE_NORMALIZE.variant_launches)
        want = _want(kernels, CROP_RESIZE_NORMALIZE=batches)
        _check(launches[node] == want and variants == {"staged": batches},
               f"capture {node}: kernels launched {launches[node]} "
               f"({variants}), want {want}")
        times = []
        for _ in range(CAPTURE_PASSES):
            t0 = time.perf_counter()
            tm.transform(frame)
            times.append(time.perf_counter() - t0)
        out[node] = got
        rates[node] = N_IMAGES / statistics.median(times)
    node = out[CAPTURE_NODE]
    _check(node.shape == (N_IMAGES, DST // 32, DST // 32, 2048)
           and node.dtype == np.float32
           and bool(np.isfinite(node).all()),
           f"captured node: shape {node.shape} dtype {node.dtype}")
    with torch.inference_mode():
        mean = torch.from_numpy(node).to(card).permute(0, 3, 1, 2).mean(
            dim=(2, 3)).cpu().numpy()
    pool = out["pool"]
    diff = float(np.abs(mean - pool).max())
    bound = float(48 * 2.0 ** -24 * np.abs(node).mean(axis=(1, 2)).max())
    _check(diff <= bound, f"the node's mean over H, W is {diff} from pool, "
                          f"bound {bound}")
    _line(phase="capture", card=_smi(), model="resnet50", images=N_IMAGES,
          batch=BATCH, node=CAPTURE_NODE, node_shape=list(node.shape[1:]),
          launches_main_path=launches,
          images_per_s={k: v for k, v in rates.items()},
          hook_cost=rates["pool"] / rates[CAPTURE_NODE],
          mean_vs_pool_max_abs=diff, mean_vs_pool_bound=bound,
          mean_bit_equal_pool=bool(np.array_equal(mean, pool)))
    return launches[CAPTURE_NODE]


def phase_downloader(torch, kernels, card) -> dict:
    """The model downloader at full width: ResNet-50's seed-0 state dict
    written by ``LocalRepo.save_model`` (the flax npz, through
    ``to_jax_params``) with its MANIFEST, served by a localhost
    ``http.server`` thread, fetched by ``HttpRepo`` into a cache (sha256
    checked), and loaded by ``ImageFeaturizer.set_model_from_downloader``;
    128 of the featurize images must score BIT-equal to
    ``ImageFeaturizer.set_model`` with the same state dict."""
    import functools
    import http.server
    import tempfile

    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models import downloader as dl
    from mmlspark_tpu_torch.models.zoo import build_model, init_state

    n = BATCH
    _, raw = _featurize_frame(n)
    frame = _image_frame(raw, "smoke")
    module = build_model("resnet50", num_classes=1000)["module"]
    state = init_state(module, seed=0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repo-") as work:
        served = os.path.join(work, "served")
        t0 = time.perf_counter()
        schema = dl.LocalRepo(served).save_model(dl.ModelSchema(
            name="resnet50", architecture="resnet50",
            architectureArgs={"num_classes": 1000},
            layerNames=["pool", "head"]), state)
        dl.LocalRepo(served).write_manifest()
        save_s = time.perf_counter() - t0
        class Quiet(http.server.SimpleHTTPRequestHandler):
            def log_message(self, *args):
                pass

        httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), functools.partial(Quiet, directory=served))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            repo = dl.HttpRepo(f"http://127.0.0.1:{httpd.server_address[1]}",
                               os.path.join(work, "cache"), timeout=60.0)
            downloader = dl.ModelDownloader(repo)
            t0 = time.perf_counter()
            path = downloader.download_by_name("resnet50")
            fetch_s = time.perf_counter() - t0
            _check(dl.sha256_file(path) == schema.hash,
                   "the cached payload's sha256 differs from the schema's")
            got_fz = ImageFeaturizer(inputCol="image", outputCol="f",
                                     cutOutputLayers=1, miniBatchSize=BATCH,
                                     computeDtype="bfloat16")
            t0 = time.perf_counter()
            got_fz.set_model_from_downloader(downloader, "resnet50")
            load_s = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            httpd.server_close()
    want_fz = ImageFeaturizer(inputCol="image", outputCol="f",
                              cutOutputLayers=1, miniBatchSize=BATCH,
                              computeDtype="bfloat16")
    want_fz.set_model("resnet50", params=state, num_classes=1000)
    kernels.reset_launches()
    got = np.asarray(got_fz.transform(frame).column("f"))
    launches = _launches(kernels)
    want = np.asarray(want_fz.transform(frame).column("f"))
    _check(got.shape == (n, 2048) and np.array_equal(got, want),
           "features of the downloaded model differ from set_model's: "
           f"max {float(np.abs(got - want).max())}")
    _line(phase="downloader", card=_smi(), model="resnet50",
          payload_mb=schema.size / 1e6, images=n, save_s=save_s,
          fetch_s=fetch_s, load_s=load_s, launches_main_path=launches,
          bit_equal=True)
    return launches


def phase_pretrained(torch, kernels, card) -> dict:
    """Pretrained-weight import (``models/convert.py``) into the
    downloader and the featurizer, K2 on the path.

    (a) The committed trained ResNet-20 (``PRETRAINED_MSGPACK``, a flax
    msgpack) read by ``from_flax_msgpack`` and published by
    ``import_pretrained`` into a ``LocalRepo`` twice: with the reference
    test's arguments (bf16 convs) and with ``dtype="float32"``. Each loads
    through ``ModelDownloader`` into ``ImageFeaturizer(cutOutputLayers=1,
    miniBatchSize=8)`` (TF32 off) and scores ``PRETRAINED_GOLDEN``'s 8
    images on the card: ``pool`` within ``PRETRAINED_GOLDEN_TOL`` of the
    golden table; the float32 model's within ``PRETRAINED_CPU_TOL`` (rtol
    and atol) of the same featurizer on the CPU, the bf16 model's within
    the golden tolerance of it; ``cutOutputLayers=0`` predicts all 8
    labels; K2 once a pass, no other kernel.

    (b) Full width: ResNet-50's seed-0 state dict exported as numpy,
    through ``from_torch_npz`` -> ``validate_params`` ->
    ``import_pretrained`` -> ``ModelDownloader`` -> ``ImageFeaturizer``
    (bf16): 128 of the featurize images (256^2 -> K2 -> 224^2) score
    BIT-equal to ``ImageFeaturizer.set_model`` with the same state; K2
    once, no other kernel."""
    import tempfile

    from mmlspark_tpu_torch.image.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models import convert
    from mmlspark_tpu_torch.models import downloader as dl
    from mmlspark_tpu_torch.models.zoo import build_model, init_state
    from mmlspark_tpu_torch.utils import config

    golden = np.load(PRETRAINED_GOLDEN)
    frame = _image_frame(golden["images"], "golden")
    labels = np.asarray(golden["labels"])
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixture, launches = {}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pre-") as work:
            t0 = time.perf_counter()
            params = convert.from_flax_msgpack(PRETRAINED_MSGPACK)
            read_s = time.perf_counter() - t0
            repo = dl.LocalRepo(work)
            downloader = dl.ModelDownloader(repo)

            def featurize(name, cut):
                fz = ImageFeaturizer(inputCol="image", outputCol="f",
                                     cutOutputLayers=cut, miniBatchSize=8)
                fz.set_model_from_downloader(downloader, name)
                return np.asarray(fz.transform(frame).column("f"))

            for name, extra in (("resnet20-synthetic", {}),
                                ("resnet20-synthetic-fp32",
                                 {"dtype": "float32"})):
                schema = convert.import_pretrained(
                    repo, name, "resnet20_cifar", params,
                    dataset="synthetic-4class", input_mean=[127.5],
                    input_std=[127.5], num_classes=4, **extra)
                _check(schema.layerNames == ["pool", "head"]
                       and schema.inputNode == "pool",
                       f"{name}: schema {schema}")
                kernels.reset_launches()
                feats = featurize(name, 1)
                logits = featurize(name, 0)
                launches[name] = _launches(kernels)
                want = _want(kernels, CROP_RESIZE_NORMALIZE=2)
                _check(launches[name] == want,
                       f"{name}: kernels launched {launches[name]}, want "
                       f"{want} (K2 once a pass)")
                config.set("runtime.device", "cpu")
                try:
                    cpu = featurize(name, 1)
                finally:
                    config.unset("runtime.device")
                _check(feats.shape == (len(labels), 64)
                       and bool(np.isfinite(feats).all()),
                       f"{name}: features {feats.shape}")
                golden_err = float(np.abs(feats - golden["pool"]).max())
                _check(np.allclose(feats, golden["pool"],
                                   rtol=PRETRAINED_GOLDEN_TOL,
                                   atol=PRETRAINED_GOLDEN_TOL),
                       f"{name}: pool is {golden_err} from the golden table")
                cpu_tol = (PRETRAINED_CPU_TOL if extra
                           else PRETRAINED_GOLDEN_TOL)
                cpu_err = float(np.abs(feats - cpu).max())
                _check(np.allclose(feats, cpu, rtol=cpu_tol, atol=cpu_tol),
                       f"{name}: card pool is {cpu_err} from the CPU's "
                       f"(tolerance {cpu_tol})")
                pred = np.argmax(logits, axis=-1)
                correct = int((pred == labels).sum())
                _check(correct == len(labels),
                       f"{name}: {correct}/{len(labels)} labels predicted")
                fixture[name] = dict(
                    architecture_args=schema.architectureArgs,
                    payload_mb=schema.size / 1e6, golden_max_abs=golden_err,
                    golden_tol=PRETRAINED_GOLDEN_TOL, cpu_max_abs=cpu_err,
                    cpu_tol=cpu_tol, labels=f"{correct}/{len(labels)}",
                    k2_launches=launches[name][
                        kernels.CROP_RESIZE_NORMALIZE.name])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    # (b) ResNet-50's seed-0 state, exported as a torch user would
    n = BATCH
    _, raw = _featurize_frame(n)
    frame = _image_frame(raw, "smoke")
    module = build_model("resnet50", num_classes=1000)["module"]
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            init_state(module, seed=0).items()})
    exported = {k: v.detach().numpy()
                for k, v in module.state_dict().items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pre-") as work:
        repo = dl.LocalRepo(work)
        t0 = time.perf_counter()
        tree = convert.from_torch_npz(exported)
        convert.validate_params("resnet50", tree, num_classes=1000)
        validate_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        schema = convert.import_pretrained(repo, "resnet50-imported",
                                           "resnet50", tree,
                                           num_classes=1000)
        save_s = time.perf_counter() - t0
        got_fz = ImageFeaturizer(inputCol="image", outputCol="f",
                                 cutOutputLayers=1, miniBatchSize=BATCH,
                                 computeDtype="bfloat16")
        t0 = time.perf_counter()
        got_fz.set_model_from_downloader(dl.ModelDownloader(repo),
                                         "resnet50-imported")
        load_s = time.perf_counter() - t0
    kernels.reset_launches()
    got = np.asarray(got_fz.transform(frame).column("f"))
    launches["resnet50"] = _launches(kernels)
    want_launches = _want(kernels, CROP_RESIZE_NORMALIZE=1)
    _check(launches["resnet50"] == want_launches,
           f"resnet50 imported: kernels launched {launches['resnet50']}, "
           f"want {want_launches}")
    want_fz = ImageFeaturizer(inputCol="image", outputCol="f",
                              cutOutputLayers=1, miniBatchSize=BATCH,
                              computeDtype="bfloat16")
    want_fz.set_model("resnet50", params=exported, num_classes=1000)
    want = np.asarray(want_fz.transform(frame).column("f"))
    _check(got.shape == (n, 2048) and np.array_equal(got, want),
           "features of the imported ResNet-50 differ from set_model's: "
           f"max {float(np.abs(got - want).max())}")
    _line(phase="pretrained", card=_smi(), fixture=fixture,
          fixture_read_s=read_s, resnet50=dict(
              images=n, payload_mb=schema.size / 1e6,
              validate_s=validate_s, save_s=save_s, load_s=load_s,
              bit_equal=True,
              k2_launches=launches["resnet50"][
                  kernels.CROP_RESIZE_NORMALIZE.name]),
          launches_main_path=launches)
    return {name: v[kernels.CROP_RESIZE_NORMALIZE.name]
            for name, v in launches.items()}


def phase_chaos(torch, kernels, card) -> dict:
    """The single-process chaos scenarios on the card (``reliability/
    chaos.py``), seed 0, the reference tests' sizes: ``train`` (kill +
    resume to bit-equal params, then serve under faults), ``fleet`` (a
    replica of three killed under fire), ``decode`` (a replica killed mid
    generation, ``transformer_lm_tiny``) and ``host`` (a real ``cli
    serve`` worker SIGKILLed and restarted: it captures exactly its
    buckets, builds no kernel). Every verdict all-green; K3's launches in
    decode counted."""
    import tempfile

    from mmlspark_tpu_torch.reliability import chaos
    seconds, launches, restated = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos-") as work:
        for name, kw in CHAOS_ON_CARD:
            kernels.reset_launches()
            t0 = time.perf_counter()
            v = chaos.run_named(name, 0, os.path.join(work, name), **kw)
            seconds[name] = time.perf_counter() - t0
            launches[name] = _launches(kernels)
            _check(v["passed"] and all(v["invariants"].values()),
                   f"chaos {name}: {v['invariants']} {v['errors'][:3]}")
            restated.update({f"{name}.{k}": r for k, r in
                             v.get("restated", {}).items()})
    _line(phase="chaos", card=_smi(), scenario_seconds=seconds,
          launches=launches, restated=restated)
    return launches


def phase_chaos_mesh(torch, kernels, card, cards: int = 1) -> dict:
    """The mesh-bound chaos scenarios (module docstring, phase 26), each
    through ``cli chaos --nprocs``: two ranks sharing this card over gloo
    (``cards`` 1) or one rank a card over NCCL. Returns each scenario's
    kernel launches, summed over its ranks."""
    import signal
    import tempfile
    if cards > 1 and torch.cuda.device_count() < cards:
        raise RuntimeError(f"--mesh-cards {cards} needs {cards} cards; "
                           f"{torch.cuda.device_count()} are visible")
    torch.cuda.empty_cache()
    ranks_n = 2 if cards == 1 else cards
    backend = "gloo" if cards == 1 else "nccl"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MMLSPARK_TPU_TORCH_RUNTIME_DIST_BACKEND=backend)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    seconds, launches, by_rank, restated = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_mesh-") as work:
        for name, kw in CHAOS_MESH:
            argv = [sys.executable, "-m", "mmlspark_tpu_torch.cli", "chaos",
                    "--scenario", name, "--seed", "0", "--nprocs",
                    str(ranks_n), "--platform", "cuda",
                    "--out", os.path.join(work, name)]
            for key, value in kw.items():
                argv += [f"--{key}", str(value)]
            log_path = os.path.join(work, f"{name}.log")
            t0 = time.perf_counter()
            with open(log_path, "w") as log:
                proc = subprocess.Popen(argv, cwd=root, env=env,
                                        start_new_session=True,
                                        stdout=subprocess.PIPE, stderr=log,
                                        text=True)
                try:
                    out, _ = proc.communicate(timeout=CHAOS_MESH_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    out, _ = proc.communicate()
                finally:
                    if proc.poll() is None:
                        os.killpg(proc.pid, signal.SIGKILL)
                        proc.wait()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                with open(log_path) as log:
                    print(log.read()[-6000:], file=sys.stderr, flush=True)
            _check(proc.returncode == 0,
                   f"chaos_mesh {name}: cli chaos exited {proc.returncode}")
            v = json.loads(out)
            _check(v["passed"] and all(v["invariants"].values()),
                   f"chaos_mesh {name}: {v['invariants']} {v['errors'][:3]}")
            ranks = v["ranks"]
            _check(ranks["world"] == ranks_n
                   and ranks["placements_left"] == [[]] * ranks_n,
                   f"chaos_mesh {name}: world {ranks['world']}, "
                   f"placements left {ranks['placements_left']}")
            by_rank[name] = ranks["launches"]
            launches[name] = {k.name: sum(r.get(k.name, 0)
                                          for r in ranks["launches"])
                              for k in kernels.KERNELS}
            restated.update({f"{name}.{k}": r for k, r in
                             v.get("restated", {}).items()})
    _line(phase="chaos_mesh", card=_smi(), ranks=ranks_n, backend=backend,
          scenario_seconds=seconds, launches=launches,
          rank_launches=by_rank,
          restated=restated)
    return launches


def phase_cli(torch, kernels, card) -> dict:
    """The CLI's tools on the card: ``info`` (platform gpu, count 1),
    ``check mmlspark_tpu_torch`` (exit 0: the port's tree is lint-clean)
    and ``top --once`` over two in-process replicas served over HTTP."""
    import contextlib
    import io

    from mmlspark_tpu_torch.cli import main as cli_main
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serve.fleet import Fleet
    from mmlspark_tpu_torch.serve.http import serve_http
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.cli",
                           "info"], capture_output=True, text=True,
                          timeout=300, cwd=root)
    info = json.loads(proc.stdout)
    _check(proc.returncode == 0 and info["platform"] == "gpu"
           and info["count"] == 1, f"cli info: {proc.returncode} "
                                   f"{proc.stdout[-500:]}")
    info_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.cli",
                           "check", "mmlspark_tpu_torch"],
                          capture_output=True, text=True, timeout=300,
                          cwd=root)
    _check(proc.returncode == 0, f"cli check: {proc.stdout[-2000:]}")
    check_s = time.perf_counter() - t0
    model = TorchModel(inputCol="x", outputCol="y", miniBatchSize=8)
    model.set_model("mlp_tabular", input_dim=8, hidden=[16], num_classes=3)
    fleet = Fleet({"m": model}, replicas=2)
    fronts = [serve_http(r.server, port=0) for r in fleet.replicas]
    for httpd, _ in fronts:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        fleet.submit("m", np.zeros((2, 8), np.float32))
        out = io.StringIO()
        argv = ["top", "--once"]
        for _, addr in fronts:
            argv += ["--replica", addr]
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        frame = out.getvalue()
    finally:
        for httpd, _ in fronts:
            httpd.shutdown()
            httpd.server_close()
        fleet.close()
    _check(rc == 0 and "replicas 2/2 ready" in frame,
           f"cli top --once: {rc} {frame[:400]}")
    _line(phase="cli", card=_smi(), info_platform=info["platform"],
          info_count=info["count"], info_kind=info["kind"], info_s=info_s,
          check_rc=0, check_s=check_s, top_frame_lines=frame.count("\n"),
          top_first_line=frame.splitlines()[0])


def _profile_pass(torch, run, out_dir, name) -> None:
    """One warm ``run()`` under torch.profiler: the device time by kernel
    (top 25) and the device's busy share of the run, as a JSON line; the
    full table and a Chrome trace go to ``out_dir`` as ``<name>_*``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:25]
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    _line(phase="profile", of=name, wall_s=wall_s,
          device_busy_s=busy_us / 1e6,
          device_busy_share=busy_us / 1e6 / wall_s,
          top=[{"name": e.key[:80], "device_ms": e.self_device_time_total
                / 1e3, "calls": e.count} for e in top])


def main() -> int:
    if "--stream-child" in sys.argv[1:]:
        return stream_child(json.loads(
            sys.argv[sys.argv.index("--stream-child") + 1]))
    if "--mesh-child" in sys.argv[1:]:
        return mesh_child(json.loads(
            sys.argv[sys.argv.index("--mesh-child") + 1]))
    if "--inputs-child" in sys.argv[1:]:
        return inputs_child(json.loads(
            sys.argv[sys.argv.index("--inputs-child") + 1]))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch import kernels
    from mmlspark_tpu_torch.ops import attention as tatt
    from mmlspark_tpu_torch.ops import preprocess as tpre

    smi = _smi()
    _line(phase="device", seconds=time.time() - _T_MODULE, nvidia_smi=smi,
          name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, cudnn=torch.backends.cudnn.version())

    t0 = time.perf_counter()
    status = kernels.build_all()
    ptxas = {}
    for k in kernels.KERNELS:
        report = kernels.build.ptxas_report(k.build_log)
        ptxas[k.name] = dict(zip(kernels.build.demangle(list(report)),
                                 report.values()))
    _line(phase="build", seconds=time.perf_counter() - t0, status=status,
          cache_hit=all(v == "hit" for v in status.values()), ptxas=ptxas)
    # every instantiation of every kernel keeps its values in registers
    for k in kernels.KERNELS:
        _check(bool(ptxas[k.name]), f"{k.name}: no ptxas report in its "
                                    "build log")
        spills = {fn: r for fn, r in ptxas[k.name].items()
                  if r["spill_stores"] or r["spill_loads"]}
        _check(not spills, f"{k.name} spills: {spills}")

    card = torch.device("cuda", 0)
    if "--vmoe-only" in sys.argv[1:]:
        vmoe = _run(phase_vmoe, torch, kernels, card)
        _line(vmoe_launches=vmoe["launches"])
        print(_smi(), flush=True)
        _line(ok=True, device={"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()})
        return 0
    if "--mesh-only" in sys.argv[1:]:
        cards = 1
        if "--mesh-cards" in sys.argv[1:]:
            cards = int(sys.argv[sys.argv.index("--mesh-cards") + 1])
        mesh = _run(phase_mesh, torch, kernels, card, cards)
        _line(mesh_launches=mesh)
        _run(phase_chaos_mesh, torch, kernels, card, cards)
        print(_smi(), flush=True)
        _line(ok=True, device={"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()})
        return 0
    k1 = _run(phase_kernel_check_k1, torch, tpre, kernels.FUSED_NORMALIZE,
              card)
    k2 = _run(phase_kernel_check, torch, tpre, kernels.CROP_RESIZE_NORMALIZE,
              card)
    k3 = _run(phase_kernel_check_k3, torch, tatt, kernels, card)
    profile_dir = None
    if "--profile" in sys.argv[1:]:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]
    featurize = _run(phase_featurize, torch, kernels, card, profile_dir)
    train = _run(phase_train, torch, kernels, card, profile_dir)
    _run(phase_deep, torch, card)
    lm, lm32 = _run(phase_lm_score, torch, kernels, card, profile_dir)
    _run(phase_moe_score, torch, kernels, card)
    _run(phase_featurize_vit, torch, kernels, card)
    _run(phase_automl, torch, kernels, card)
    _run(phase_text, torch, kernels, card, profile_dir)
    lm_train, lm_train32, moe_train = _run(phase_lm_train, torch, kernels,
                                           card, profile_dir)
    train_large = _run(phase_train_large, torch, kernels, card, profile_dir)
    vmoe = _run(phase_vmoe, torch, kernels, card)
    serve = _run(phase_serve, torch, kernels, card)
    lm_serve = _run(phase_lm_serve, torch, kernels, card)
    generate, generate32, single = _run(phase_generate, torch, kernels, card)
    fleet = _run(phase_fleet, torch, kernels, card, single)
    process_fleet = _run(phase_process_fleet, torch, kernels, card, fleet)
    import tempfile
    kept = tempfile.mkdtemp(prefix="chip_smoke_events-")
    stream_resume = _run(phase_stream_resume, torch, kernels, card, kept)
    mesh = _run(phase_mesh, torch, kernels, card, keep_events=kept)
    record = _run(phase_record, torch, kernels, card, {
        "stream_resume": os.path.join(kept, "stream_resume_C.jsonl"),
        "mesh_inputs": os.path.join(kept, "mesh_inputs_C-0.jsonl")})
    import shutil
    shutil.rmtree(kept, ignore_errors=True)
    capture = _run(phase_capture, torch, kernels, card)
    downloader = _run(phase_downloader, torch, kernels, card)
    pretrained = _run(phase_pretrained, torch, kernels, card)
    chaos = _run(phase_chaos, torch, kernels, card)
    chaos_mesh = _run(phase_chaos_mesh, torch, kernels, card)
    _run(phase_cli, torch, kernels, card)

    k1k, k2k = kernels.FUSED_NORMALIZE, kernels.CROP_RESIZE_NORMALIZE
    tc, f32 = kernels.FLASH_ATTENTION_TC, kernels.FLASH_ATTENTION
    _line(kernels=[{
        "name": k1k.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/fused_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_preprocess.py:43",
        "launches": train[k1k.name],
        "launches_by_path": {"train": train[k1k.name],
                             "train_large": train_large[k1k.name],
                             "stream_resume": stream_resume,
                             "mesh": mesh["k1"],
                             "mesh_inputs": mesh["k1_inputs"],
                             "record": record[k1k.name],
                             **{f"chaos_mesh_{k}": v[k1k.name]
                                for k, v in chaos_mesh.items()}},
        "launches_note": "stream_resume: each child's own run (A "
                         "uninterrupted, B up to its SIGKILL, C from its "
                         "restored step); one launch a step. mesh: each "
                         "rank's ResNet-20 data-parallel steps (two ranks "
                         "sharing the card), one launch a step on its "
                         "half of the batch. mesh_inputs: each rank's "
                         "meshed run_dataset steps on its own stream (A "
                         "whole, C from its restored step), one a step. "
                         "record: the traced train steps",
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "shape": "B=256, 32x32x3 uint8 -> bf16 (the train step's)",
        "ms_bf16": k1["ms"], "floor_ms": k1["floor_ms"],
        "ms_f32": k1["ms_f32"], "floor_ms_f32": k1["floor_ms_f32"],
        "bound_ms_f32": k1["bound_ms_f32"],
        "epoch_slices_ms": k1["epoch_slices_ms"],
        "ms_train_large_bf16": k1["ms_large_bf16"],
        "bound_ms_train_large_bf16": k1["bound_ms_large_bf16"],
        "registers": {f: r["registers"] for f, r in k1["ptxas"].items()}}, {
        "name": k2k.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/crop_resize_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_preprocess.py:147",
        "launches": featurize[k2k.name],
        "launches_by_path": {"featurize": featurize[k2k.name],
                             "capture": capture[k2k.name],
                             "downloader": downloader[k2k.name],
                             **{f"pretrained_{k}": v
                                for k, v in pretrained.items()},
                             "serve": serve[k2k.name],
                             "mesh_serve_featurize":
                                 mesh["k2"]["serve_featurize"],
                             **{f"chaos_mesh_{k}": v[k2k.name]
                                for k, v in chaos_mesh.items()}},
        "launches_note": "mesh_serve_featurize: each rank's count over "
                         "two passes of ResNet-50 featurize split over the "
                         "data ranks (one launch a pass on its rows). "
                         "pretrained_resnet20-*: the imported trained "
                         "ResNet-20's features and logits passes (8 "
                         "images, 32^2 -> 32^2), one launch each",
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "library_note": "F.interpolate bilinear on float input, resample "
                        "only",
        "shape": "B=128, 256x256x3 uint8 -> 224x224x3 bf16 (the featurize "
                 "path's)",
        "ms_bf16": k2["ms"], "floor_ms": k2["floor_ms"],
        "direct_ms": k2["direct_ms"], "ms_f32": k2["ms_f32"],
        "direct_ms_f32": k2["direct_ms_f32"],
        "plain_ms_f32": k2["plain_ms_f32"],
        "bound_ms_f32": k2["bound_ms_f32"],
        "max_abs_err_f32": k2["max_abs_err_f32"],
        "share_differing": k2["share_differing"],
        "registers": {f: r["registers"] for f, r in k2["ptxas"].items()}}, {
        "name": tc.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/flash_attention_wgmma.cu",
        "replaces": "mmlspark_tpu/ops/pallas_attention.py:109",
        "launches": lm[tc.name],
        "launches_by_path": {"lm_score": lm[tc.name],
                             "lm_train": lm_train[tc.name],
                             "lm_train_moe": moe_train[tc.name],
                             "lm_serve": lm_serve[tc.name],
                             **{f"generate_{k}": v[tc.name]
                                for k, v in generate.items()},
                             "fleet": fleet["bf16"][tc.name],
                             "process_fleet": process_fleet[tc.name],
                             "chaos_decode": chaos["decode"][tc.name],
                             **{f"chaos_mesh_{k}": v[tc.name]
                                for k, v in chaos_mesh.items()},
                             **{f"mesh_{k}": v
                                for k, v in mesh["tc"].items()}},
        "launches_note": "mesh_*: each rank's count over the 7 steps of "
                         "a meshed transformer_lm run (6 a step); "
                         "mesh_moe_*: over the 4 steps of the MoE LM split "
                         "over expert (6 a step); mesh_serve_lm: each "
                         "rank's over the served batches (6 a program "
                         "call), mesh_serve_generate: over the prefills",
        "max_abs_err": k3["tc"]["max_abs_err"],
        "ms": k3["tc"]["ms"], "plain_ms": k3["tc"]["plain_ms"],
        "bound_ms": k3["tc"]["bound_ms"], "bound_by": k3["tc"]["bound_by"],
        "library_ms": k3["tc"]["library_ms"],
        "library_note": "F.scaled_dot_product_attention(is_causal=True), "
                        "bf16 (B=8, L=2048, H=8, D=64)"}, {
        "name": f32.name, "route": "cuda",
        "source": "mmlspark_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "mmlspark_tpu/ops/pallas_attention.py:109",
        "launches": lm32[f32.name],
        "launches_by_path": {"lm_score_fp32": lm32[f32.name],
                             "lm_train_fp32": lm_train32[f32.name],
                             **{f"generate_fp32_{k}": v[f32.name]
                                for k, v in generate32.items()},
                             "fleet_fp32": fleet["fp32"][f32.name],
                             "process_fleet_fp32": process_fleet[f32.name],
                             "chaos_decode": chaos["decode"][f32.name],
                             **{f"chaos_mesh_{k}": v[f32.name]
                                for k, v in chaos_mesh.items()},
                             **{f"mesh_fp32_{k}": v
                                for k, v in mesh["f32"].items()}},
        "launches_note": "lm_score's fp32 pass (16 rows): f32 is this "
                         "route's input; the bf16 main paths launch it 0 "
                         "times",
        "max_abs_err": k3["f32"]["max_abs_err"],
        "ms": k3["f32"]["ms"], "plain_ms": k3["f32"]["plain_ms"],
        "bound_ms": k3["f32"]["bound_ms"], "bound_by": k3["f32"]["bound_by"],
        "library_ms": k3["f32"]["library_ms"],
        "library_note": "F.scaled_dot_product_attention(is_causal=True), "
                        "f32, TF32 off (B=8, L=2048, H=8, D=64)"}] + [{
        "name": k.name, "route": "cuda",
        "source": f"mmlspark_tpu_torch/kernels/csrc/{k.source.name}",
        "replaces": None,
        "replaces_note": "no TPU kernel: the JAX package routes experts by "
                         "one-hot einsums",
        "launches": vmoe["launches"][k.name],
        "launches_by_path": {"vmoe": vmoe["launches"][k.name]},
        "launches_note": "one vmoe_b16 training step (6 routed blocks)",
        "max_rel_err": vmoe["errs"], "ms": vmoe["ms"],
        "plain_ms": vmoe["plain_ms"], "bound_ms": vmoe["bound_ms"],
        "library_ms": vmoe["library_ms"],
        "library_note": "torch.bmm on the padded (E, C) buffer, up then "
                        "down; and baddbmm, GELU, baddbmm (vmoe_b16.train's "
                        "shapes)"} for k in (
            kernels.MOE_GROUPED_GEMM, kernels.MOE_PERMUTE,
            kernels.MOE_UNPERMUTE, kernels.MOE_UNPERMUTE_BWD,
            kernels.MOE_BIAS_GRAD)])
    _line(phase="total", seconds=time.time() - _T_MODULE)
    print(_smi(), flush=True)
    _line(ok=True, device={"platform": "gpu",
                           "kind": torch.cuda.get_device_name(0),
                           "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
