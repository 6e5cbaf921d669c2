#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's ``name, power.limit`` (from ``nvidia-smi``); require CUDA;
2. build every kernel of the serving and training paths from
   ``paddle_tpu_torch/csrc`` with ``nvcc`` (one process per source, all at
   once);
3. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes, and time the kernel, the plain version and one PyTorch
   library call that computes the same function (the yardstick; the port
   never calls it); the attention dropout mask of the forward, dQ and
   dK/dV kernels must equal the plain version's bit for bit, and the
   LayerNorm backward must repeat its outputs bit for bit; the attention
   forward is also timed against the port's unfused attention at L = 128
   to 512;
4. serve BERT-base (L=512, flash attention on, f32, random weights from a
   seed) through ``Predictor`` -> ``InferenceServer`` with 2 replicas and
   wait for ``/healthz``: warmup must capture one CUDA graph a bucket
   (``runtime/compiled.py``), shared by the replicas;
5. POST requests of 1-4 rows, some padded, some concurrent; check every
   answer against the port's plain forward of the same weights on the CPU,
   that each forward launched 24 LayerNorm and 12 attention kernels, and
   that the requests captured nothing (``extra_compiles() == 0``, ``/statz``
   ``compiles``); then, as a control, run the same requests with TF32
   matmuls on and require the limits to catch them; then ``Predictor.run``
   captured against eager at every bucket (wall and device busy, the
   kernels a profiled replay ran equal to the booked launches), and 2 x 20
   concurrent replays of one bucket bit-equal to solo ones while a third
   thread captures a new shape (each served model does the same);
6. train BERT-base pretraining (MLM + NSP, AdamW lr 1e-4) through
   ``framework.jit.train_step``: one step at dropout 0, batch 2 x L=512,
   whose loss and every gradient must match the port's plain path on the
   CPU from the same weights (with a TF32 control the limits must catch);
   then steps at the bench's phase-2 shape (batch 32, L=512, 80 masked
   positions, dropout 0.1) on one fixed batch, whose losses must be finite
   and fall, each launching exactly 24 + 24 LayerNorm (forward, backward),
   12 attention forward, 12 dQ and 12 dK/dV kernels; step time, tokens/s
   and, from ``torch.profiler``, where one step's time goes;
6a. AMP: hold the bf16 kernels (the LayerNorm forward in bf16 and in its
   mixed instance, a bf16 x on an f32 residual, at [16384, 768], at H =
   1000 and 4096 and on rows of mean 100; its backward in bf16; the three
   bf16 attention kernels at [32, 12, 512, 64] with dropout 0.1 and a pad
   bias, at rate 0, at L = 128 causal and at other head dims, biases and
   ragged shapes) against their plain versions in bf16 ulps, timed beside
   bf16 SDPA and ``F.layer_norm``, with the forward's stored dropout mask equal to the plain
   mask bit for bit and the backward repeating its gradients bit for bit
   (the wgmma kernels' ``-Xptxas -v`` summaries are printed on stdout);
   then one BERT-base step under ``auto_cast`` (O1, and O2 through
   ``decorate``) at dropout 0, batch 2 x L=512, against the CPU's plain
   path under the same scope (the f32 step as the control the limit on
   differing gradient entries must catch); then bench's phase-2 step under
   ``auto_cast`` for 10 steps (losses finite and falling, the bf16
   attention and LayerNorm kernels launched, median step, tokens/s, peak
   memory) and a profiled step whose matrix products must all be bf16;
7. hold the ResNet path's kernels (fused conv + batch norm + relu, the
   momentum update) against their plain versions at ResNet-50's shapes
   (layer1's 3x3 conv at batch 128, with a one-pass TF32 control the conv
   limit must catch; the stem, a ragged shape, the serving batch 32, the
   33 products of a batch-1 and a batch-8 forward with their split-K calls
   counted, and all 161 parameters besides), timing each with its bound
   and a library call;
8. serve ResNet-50 (224 x 224, eval, f32, random weights from a seed)
   through ``Predictor`` -> ``InferenceServer`` at buckets 1, 8 and 32,
   check every answer against the port's plain forward on the CPU and that
   each forward launched 33 fused eval kernels, with a TF32 control, and
   the compiled-serving checks of step 5;
9. train ResNet-50 with Momentum through ``framework.jit.train_step``: one
   step at batch 2 against the CPU's plain path (loss, gradients, running
   statistics; TF32 control), then 4 steps at bench.py's shape (batch
   128, lr 0.1, momentum 0.9, one fixed batch) whose losses must be finite
   and fall below the first, each launching exactly 33 of each training
   conv kernel and 2 momentum kernels that update all 161 parameters;
10. hold the int8 matmul kernel against a float64 product of the same int8
    values (bit-equal) at the int8 serving path's shapes and two ragged
    ones, its split-K calls counted against the plan (which the C side must
    make alike), and the 25 products of one served forward at buckets 8, 64
    and 512 in a row; and the max-pool backward kernel against its plain
    version (bit-equal) at ResNet-50's stem, on a relu'd input full of ties,
    on distinct values and in the stem's own channels-last layout (with the
    whole autograd backward timed flag on and off); time each in device
    time behind a sleep kernel with its bound and a library call;
11. build the 12-layer 768/3072 feed-forward program (BERT-base's ``mul``s)
    as a static program from a seed, run it in f32, calibrate it, rewrite it
    to int8 and save it; serve the saved directory through
    ``create_predictor(Config(dir))`` -> ``InferenceServer`` at buckets 8, 64
    and 512; check every answer against the port's plain path on the CPU
    from the same directory (with a control, one scale off by 1%, that the
    limit must catch) and against the f32 program within the documented int8
    envelope, and that each forward launched 25 int8 matmul kernels and,
    through the executor's IR gate (``fused_layernorm_residual``), 11
    residual LayerNorm kernels (the first layer's residual, the feed, is
    declared another shape and stays unfused in both packages); the compiled-serving checks of step 5,
    through the static executor's graphs, and a bias replaced through
    ``Scope.set`` showing in the next answer;
11b. ResNet-50 v1.5 built as a static program with step 8's weights, saved
    and served from the directory (``serve_resnet_static``) at buckets 1, 8,
    32 at the default flags: the optimizer's 33 ``fuse_conv_bn_relu``
    rewrites (20 conv + bn pairs left), 33 fused eval kernels a forward,
    answers within step 8's limit of the dygraph ``Predictor``'s on the card
    and of the CPU's plain path; at ``FLAGS_ir_opt_level=0`` no fused launch
    and the same answers, fused and unfused forwards timed; each bucket's
    memory plan against the card's measured peak; a strict budget below the
    plan refused before any capture; the static training program (Momentum,
    batch 8, 2 steps) at level 2 against level 1 (losses bit-equal, planned
    and measured peaks); a malformed program refused by the verifier on the
    card; a replay's host time with the three gates and without; a
    ``dequantize_static`` -> ``mul`` program contracted onto ``mul_int8``
    (one int8 kernel a product); the phase's seconds;
12. train ResNet-50 again with ``FLAGS_use_pallas_pool_bwd`` on, the main
    run: the parity step, then 10 steps that also launch the max-pool
    backward kernel once each; step time and images/s beside the flag-off
    run's, peak memory and a profiled step;
12a. ResNet-50 under AMP (``auto_cast``, O1), with the bf16 kernels held
    in step 3 against their plain versions (rows 8-13 in bf16 from
    ``conv_bn_relu_mm_bf16.cu`` and the bf16 instances of
    ``conv_bn_relu_bn.cu``, and the bf16 max-pool backward, bit-equal, at
    ResNet-50's shapes, the stem with K padded to 152, ragged shapes and the
    serving products with split-K, each timed beside bf16 ``torch.matmul``,
    ``torch.var`` or torch's pool backward): one O1 step at batch 2 against
    the CPU's plain path (the f32 step the control the limits must catch),
    then bench.py's step under ``auto_cast`` with the pool kernel on, 10
    steps at batch 128 whose losses must be finite and fall below the first,
    each launching every training conv kernel 33 times in bf16 and never in
    float32 and the bf16 pool backward once; the median step, images/s, peak
    memory and a profiled step in which no fused conv product runs outside
    the bf16 kernel; then one eval forward under ``auto_cast`` at batch 32
    (33 bf16 eval kernels) against the CPU's plain path;
12b. the compiled step (``train_step(jit=True)``, ``eval_step``: CUDA graphs
    through ``runtime/compiled.py``): bench's BERT-base AMP step and
    ResNet-50 AMP step, each first held from one state over 3 calls (the
    eager first step and 2 replays) against the same calls run eagerly,
    bit for bit wherever an eager control repeats itself bit for bit, with
    BERT's dropout masks and attention seeds equal to the eager step's and
    different between replays, a replay at lr 0 leaving every weight
    bit-identical and one at the lr moving them; then the eager
    (``jit=False``) and the captured step side by side from the same
    weights, 10 steps each (median, host clock, device busy, peak memory,
    launches a step, which must be equal); ``eval_step`` of ResNet-50 under
    AMP at batch 1 and 8 (captured logits bit-equal to eager, wall against
    busy); the refusals: a capture that cannot be made raises and no
    step runs eagerly in its place, and ``GradScaler`` raises inside a
    compiled step; and AdamW's bias correction on the card bit-equal to the
    CPU's at every t up to 10,000;
12c. Transformer-base seq2seq (37,000-token vocabulary, 512 wide, 6 + 6
    layers; ``models.TransformerSeq2Seq``) under ``auto_cast`` (O1): after
    rows 1, 1b, 2 and 2b are held at its LayerNorm shape [4096, 512] in
    step 3 (f32, bf16 and mixed, forward and backward, timed), one f32
    teacher-forced forward at batch 2 against the CPU's (TF32 control) and
    one AMP step against the CPU's plain path (the f32 step the control);
    then 10 eager and 10 captured steps (``train_step(jit=True)``) at 64
    pairs x 64 + 64 tokens, Adam(0.9, 0.98, 1e-9) under
    ``NoamDecay(512, 4000)`` (taken up at step 1000) with
    ``ClipGradByGlobalNorm(1.0)``, the pad-masked cross entropy, each
    launching the 30 residual LayerNorms forward and backward exactly (the
    first of each stack mixed), each step's lr the schedule's (on the card
    the float32 the step wrote before its replay) with one capture;
    medians, target tokens/s, busy share, device time by kind, peak memory;
12d. greedy decoding (16 sources to 32 tokens) and beam search (beam 4, 4
    sources) of seeded Transformer-base weights in f32 eval: tokens and
    beam steps equal to the CPU's up to the first position whose CPU
    top-two margin is under a limit, 12 + 18 LayerNorms a decode step, ms a
    step and a token;
12e. ERNIE-base (``ernie_base_config()``, flash on) pretrained under
    ``auto_cast`` at bench's phase-2 shape with ``knowledge_masking``'s
    spans: 10 eager and 10 captured steps with the bf16 attention and
    LayerNorm kernels' launches exact;
12f. ``BASELINE.json``'s first config: the MNIST LeNet-5 built as a static
    program (``nets.simple_img_conv_pool`` twice, ``static.nn.fc`` x 3,
    ``softmax_with_cross_entropy``, ``mean``, ``accuracy``) and trained by
    ``static.optimizer.SGD`` through ``append_backward`` on synthetic MNIST
    at batch 64 with ``FLAGS_use_pallas_pool_bwd`` on: after the max-pool
    backward kernel is held at LeNet's two pool shapes in step 10 (rows
    16e/16f), 200 steps through the executor's graph: one capture, two
    pool-backward launches a step, the first 5 losses against the CPU
    interpreter from the same startup weights (a control at lr 0 must
    fail), accuracy on a held-out batch above a bar, a replay at lr 0 (the
    lr written in place into the scope, as ``set_lr`` does) moving no
    parameter and one at the lr moving all, with no new capture; step ms
    captured against eager, images/s, and the forward alone (what each
    grad op's re-run of its forward costs);
12f2. the PTB-medium LSTM language model (Zaremba et al. 2014: vocabulary
    10,000, 2 x LSTM 650 over ``scan`` of 35 steps, batch 20, dropout 0.5,
    weights uniform +-0.05 from a seed, SGD lr 1.0 under a global-norm clip
    of 5) as a static program (``static.nn.embedding``, ``lstm``,
    ``dropout``, ``fc``) on a seeded token stream, through the executor's
    graph: (a) at dropout 0 the first 3 captured losses within 1e-4
    relative of the CPU interpreter and the parameters after them within
    1e-5 of their largest entry (an lr-0 control must fail); (b) at
    dropout 0.5 two replays of the forward on one batch differ, its
    ``for_test`` clone's do not; (c) the greedy continuation (4 prompts of
    5 tokens, 20 new) as a ``while_loop`` bounded by ``max_iters`` (a
    captured masked scan) and unbounded (interpreted, counted in
    ``store.uncaptured``), tokens equal to a host loop of the one-step
    program; (d) a captured ``switch_case`` picks each of three branches
    and a batch norm under ``cond`` moves its statistics only when taken;
    (e) ``save_persistables`` after step 5, loaded into a fresh scope and
    executor, gives step 6's loss bit for bit; (f) the captured step
    against the interpreted one; none of the kernels launched, the phase's
    seconds;
12g. BERT-base pretraining under ``Lamb`` (lr 1e-4, decay 0.01, LayerNorm
    weights and biases excluded) at bench's phase 2 under ``auto_cast``
    (O1): its first step at batch 1 at dropout 0, and the loss after it,
    against the CPU's plain path (the f32 step the control the loss limit
    must catch); then the
    captured step, an ``ExponentialMovingAverage(decay=0.999)`` updated
    after each step, a checkpoint saved after step 3 (capture ms on the
    step's thread, write seconds and bytes), 10 timed steps launching rows
    1b, 2b, 3b, 6b and 7b exactly, ``ema.apply()`` keeping every
    parameter's storage; the checked step (``FLAGS_check_nan_inf``, its own
    graph) timed, then a NaN planted in an embedding row the batch reads:
    ``FatalError`` naming the op, every parameter and moment bit-equal
    after; the checkpoint restored into a fresh model and step: every leaf
    bit-equal, no new capture, and the next loss, with the dropout
    generator reseeded alike, bit-equal to the uninterrupted run's;
12h. the dygraph LeNet at batch 64 on synthetic MNIST with the pool kernel
    on: 20 captured steps under each of Adagrad, Adadelta, RMSProp
    (centered, momentum 0.9), Adamax and Lookahead(Momentum) (whose update
    launches the momentum kernel), one graph each, each held against the
    same steps on the CPU (a half-lr control must fail), ``ModelAverage``
    applied after the Lookahead run for the held-out accuracy; the step's
    device time under each;
12i. GPT-2 small at full width (``GPTConfig()``: 12 layers, 768 wide, 12
    heads, 1024 positions, 50,304 tokens; 124,475,904 parameters from a
    seed, eval, f32) through ``generation.GenerationEngine`` (16 slots, a
    ring KV cache of 1024, prefill buckets 64-512: a CUDA graph each and one
    decode graph) and ``serving.GenerationServer``: 4 prompts (17-500
    tokens) decoded 64 greedy tokens, every step's logits against the
    card's uncached forward over the generated sequence (3e-5 of the
    largest; TF32 the control) and the tokens against its argmax where the
    top-two gap is above 1e-3 (a mask blind to each query's own position
    the control), one forward against the CPU's; a ring of 128 decoded
    past its wrap against the forward under a window of 128 (129 the
    control); graphs == buckets + 1 and no capture after; each bucket's
    prefill and 3 decode steps replayed == eager bit for bit, timed both
    ways with a profiled replay and the decode step's bound; 4,096 draws at
    top-k 50 by a chi-square test; then 32 concurrent HTTP requests (4
    streamed) on 16 slots, 8 of them equal to solo runs, ``/statz`` with no
    unexpected capture, tokens/s and inter-token times; none of the port's
    kernels runs on this path (pre-norm, cached: plain PyTorch, as the JAX
    package's);
12j. the same GPT-2 small weights through the int8 ring and the paged layout
    (``serve_gpt_paged``), each against an f32 ring of 16 x 1024: the int8
    ring's bytes exactly 19,584 / 73,728 of the f32 ring's and equal to its
    plan, ``quantize_kv`` on the card bit-equal to the CPU's on GPT-2's K/V
    planes, 256 cached positions and a ring of 128 past its wrap within 5%
    of the card's f32 forward's largest logit (the JAX package's envelope; a
    4-bit grid the control it must catch), argmax equal wherever the f32
    top-two gap exceeds twice the int8 error there, and its timings as
    12i's; the paged layout in f32 (page 16, the default pool) bit-equal to
    the ring where no full page is shared, a ring of 128 wrapped back into
    pages the prefix index holds with the ring's tokens (copy-on-write; on a
    pool of one window, eviction and the index's pressure valve),
    prompts sharing a 256-token system prompt within 3e-5 of the ring's
    logits, its decode step against the ring's; then 64 HTTP requests over
    4 tenants (a 256-token system prompt each, 16-128 unique tokens, 32-128
    new, 4 streamed) to a paged int8 server of 32 slots and to the f32 ring
    at 16: 60 prefix hits in ``/statz`` ``paging``, answers checked for
    length and EOS, tokens/s, TTFT and inter-token times; no capture after
    warmup, none of the port's kernels launched;
12k. the same GPT-2 small weights under speculative decoding and through
    the disaggregated handoff (``serve_gpt_speculative``): a one-layer
    ``truncated_draft``, ``draft_k`` 4, 16 slots x a ring of 1024, buckets
    64-512; 4 prompts (17-500 tokens) decoded 64 greedy tokens with the
    plain engine's tokens at every position before the first where the
    plain run's top-two gap is at or below 1e-3 and each verify position's
    logits within 3e-5 of the plain step's largest (TF32 the control the
    limit must catch; the draft's own greedy chain the control the token
    check must catch), and the same through a ring of 128 past its wrap; a
    self-draft accepting at least 0.99 of its proposals; the truncated
    draft's acceptance; the verify graph's position-0 samples at top-k 50
    by the chi-square test of 12i; ``len(buckets) + 2`` graphs and none
    after warmup; the draft graph, the verify graph and a whole round at
    16 busy slots, captured and eager, a profiled replay of each, tokens a
    round and ms an emitted token against the plain decode step, the
    round's bound; 12i's 32 requests to a speculative server; a ``prefill``
    and a ``decode`` server on the card, 8 requests through ``/prefill`` and
    ``/generate_kv`` equal to the unified engine's under the same near-tie
    rule, the prefill tier holding no decode cache, the ``PTKV`` slab's
    bytes; a paged int8 pair (page 16) where a tenant's second request ships
    its 256-token system prompt's pages header-only after
    ``/prefix_known`` and the decode tier's ``/statz`` ``paging`` counts the
    hits; a speculative decode tier admitting a ``PTKV`` slab with its
    prompt; no capture after warmup, none of the port's kernels launched;
    and one ``/prefill`` leg taken apart on the host clock (the forward, the
    copy to the host, packing with the CRC, HTTP, unpacking);
12l. the serving fleet (``serve_fleet``): GPT-2 small of 12i saved with
    ``save_gpt_model`` and phase 11's int8 program saved anew, then five
    processes of ``python -m paddle_tpu_torch.serving.backend`` on the card
    (two ``predict`` backends at buckets 8, 64, 512, a ``generate`` backend,
    a ``prefill`` and a ``decode`` tier of 16 slots x a ring of 1024) behind
    an in-process ``serving.Router``: 6 clients x 20 ``/predict`` requests
    straight to a backend and through the router, every answer held per row
    against the CPU's plain path under phase 11's limits, each backend's
    ``/statz`` booking 25 ``int8_matmul`` and 11 ``layernorm_residual_fwd``
    launches a forward; 16 greedy
    ``/generate`` requests through the router, unified and then composed
    from the tiers' ``/prefill`` and ``/generate_kv`` (the tiers' ``/statz``
    and the router's legs counted), tokens equal to the in-process engine's
    under 12i's near-tie rule; one predict backend SIGKILLed mid-burst with
    every request answered 200 and an eviction; every ``/loadz`` without an
    unexpected capture, the router's merged histogram counts equal to the
    backends' own, ``/fleetz`` grouped by kind; SIGTERM -> drain -> exit 0
    and no listener left; p50/p99 routed against direct, tokens/s unified
    against disaggregated, the phase's seconds;
12m. Paddle's dygraph front end, as a user script (``import
    paddle_tpu_torch as paddle`` and its public names): ResNet-50 v1.5 at
    224 x 224 and 1,000 classes written from ``nn.Layer``, ``nn.Conv2D``,
    ``nn.BatchNorm2D``, ``nn.ReLU``/``F.relu``, ``nn.MaxPool2D``,
    ``nn.AdaptiveAvgPool2D``, ``paddle.add``, ``paddle.flatten`` and
    ``nn.Linear``, its weights ``set_state_dict`` from step 8's
    ``models.resnet50``; (a) three dygraph steps at batch 32 under
    ``paddle.optimizer.Momentum`` with ``FLAGS_use_pallas_pool_bwd`` on,
    the first loss against ``models.resnet50``'s, rows 14 and 16 launched;
    (b) ``paddle.jit.save`` served by ``create_predictor`` at buckets 1, 8
    and 32 against the dygraph eval forward, 33 fused conv + bn + relu
    launches a forward, the optimized program's chains and pairs those of
    11b's program, forward ms a bucket; (c) ``paddle.jit.load`` against
    ``paddle.jit.to_static`` (one capture, then replays), and a
    ``to_static`` function that reads the host refused; the phase's
    seconds;
12n. the monitor (``paddle_tpu_torch.monitor``) on the port's hot paths:
    20 captured BERT-base AMP steps (12b's step) and 10 captured ResNet-50
    AMP steps inside a ``TrainingMonitor``, the loss read as a float each
    step: the line's ``mfu``, ``hbm_bw_util`` and ``roofline``, both in
    (0, 1]; ``cost/executed_flops`` exactly the replays x the counted
    record's FLOPs; the record within 5% of the closed form; the launches
    those the steps launch; the same BERT step with the flight recorder,
    tracing and the monitor on and off in turns (step and replay host
    time); ``profile_program`` on 11b's static ResNet-50 at bucket 8,
    ``attribute_trace`` coverage >= 0.9 on an interpreted run of it,
    ``measure_pass_deltas`` at IR level 1 against 0; a NaN fed to a captured
    step under ``check_nan_inf_action=dump`` (a dump
    ``tools/debug_dump.py`` reads, with the capture's events, then the
    raise) and a stall past the watchdog's deadline (its dump); one
    ``/predict`` under a ``traceparent`` to an int8 predict server, its
    spans on ``/tracez`` under that trace id, ``/costz``, ``/goodputz``,
    ``/profilez`` and ``/sloz`` answering; the phase's seconds;
12o. value-dependent control flow under ``paddle.jit.to_static`` (the
    AST pass, ``dygraph_to_static.py``): (a) BERT-base (flash on, L = 512)
    under a sentence-embedding head whose ``if`` reads the data
    (``paddle_sentence_encoder``), served at buckets 1 and 8, a padded, an
    unpadded and a padded batch each: one CUDA graph a bucket replays
    either branch (``misses == 2``, ``uncaptured == 0``), every answer
    within 1e-4 of the same layer run eagerly, 24 LayerNorm + 12 flash
    forward launches a forward; captured against eager wall ms a bucket;
    (b) Transformer-base greedy decoding as a ``to_static`` loop with a
    ``break`` on EOS (``paddle_greedy_decode``) at batch 64, 64 source
    tokens, ``max_len`` 64, twice (the second run's EOS the token every
    row of the first emits soonest, so the break fires): tokens equal
    ``greedy_decode(stop_at_eos=True)``'s column by column, both runs
    uncaptured and counted, 12 + 18 LayerNorm launches a step; ms a step;
    (c) a ``to_static`` function with an early ``return`` (its flags
    selected on the device) captured once and replayed for both signs,
    equal to the eager function;
12p. the rest of the op registry (the sequence, detection, compat, niche
    and fake-quant families, ``registry_tail``): (a) every case of
    ``tests/_torch_tail_cases.py`` run on the card and on the CPU through
    the registry, integers exact and floats within 1e-5, the 124 op types
    counted; (b) the Paddle book's sentiment ``convolution_net``
    (``sentiment_conv_net``: vocabulary 5,147, embedding 128, two
    ``sequence_conv_pool`` of 512, batch 128 x 400 tokens, lengths 100 to
    400) trained 20 steps as a static program under Adam (lr 0.002), the
    first three within 1e-5 relative of the CPU interpreter's, one graph
    captured and 19 replays; ms a step captured and interpreted; (c) a
    YOLOv3 head (80 classes, the nine anchors, masks [6,7,8] [3,4,5]
    [0,1,2]): ``yolov3_loss`` at three scales for a 608 x 608 input at
    batch 8, loss and gradient against the CPU, and the 416 x 416
    post-process (``yolo_box`` at three scales, ``multiclass_nms``) as a
    static program, uncaptured (the NMS reads the host), its rows equal to
    a serial greedy NMS on the host over every class; none of the 16
    kernels launched;
12q. Paddle 2.0's data path and high-level API (``hapi_paths``): an
    ``io.Dataset`` of 1,280 seeded uint8 256 x 256 x 3 images over 1,000
    classes; (a) a deterministic loader (``ToTensor``, ``CenterCrop(224)``,
    ``Normalize``; 4 workers) whose first 2 batches on the card are
    bit-equal to its numpy batches, the images/s the workers deliver and
    the transform's own rate in one process, then ``Model(resnet50())``
    prepared with Momentum (0.1, 0.9, L2 1e-4), ``CrossEntropyLoss``,
    ``Accuracy(topk=(1, 5))`` and ``amp_configs="O1"`` and ``fit`` for one
    epoch (10 steps) from ``DataLoader(num_workers=4, batch_size=128,
    shuffle=True, drop_last=True)`` over ``RandomCrop``,
    ``RandomHorizontalFlip`` and ``Normalize`` with the pool kernel on: one
    capture and 9 replays, rows 9c-13b 33 launches a step, row 14 two, row
    16c one; ``evaluate`` on 2 batches and ``predict`` on 1 (33 f32 eval
    launches a forward, the 33 products held at batch 128), ``save`` and
    ``Model.load`` into a fresh ``Model`` giving the same ``predict``
    output; fit's first loss against the bare captured ``train_step`` on
    the same batch and weights; fit's median step, the monitor's
    ``input_wait_ratio``, the batches carried by the ring and the queue;
    (b) VGG-16 in f32 at batch 32, three ``train_batch`` steps launching
    the pool kernel at its 5 pools a step, each pool shape held against the
    plain version (row 16g); (c) MobileNetV2 and SE-ResNeXt-50 eval
    forwards at batch 32 against the CPU's; the phase's seconds;
13. print the card line, then one JSON line with every kernel's numbers;
14. print ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero with no result when CUDA is absent or the package is not
beside this script.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import json
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory, FP32
# outside the tensor cores, TF32 and int8 on them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense TF32 on the tensor cores
INT8_OPS_PER_S = 1979e12  # dense int8 on the tensor cores

LN_ROWS, LN_H = 8 * 512, 768
FLASH_B, FLASH_H, FLASH_D = 8, 12, 64
LN_F32_ATOL = 1e-5
# dw/db sum 16384 rows in another order than the plain version: relative
# to the largest entry
LN_PARAM_RTOL = 1e-5
FLASH_ATOL = 5e-5
# the training path's shapes: bench.py phase 2
TRAIN_B, TRAIN_SEQ, TRAIN_PRED, TRAIN_STEPS = 32, 512, 80, 10
ATTN_DROPOUT = 0.1
TRAIN_ROWS = TRAIN_B * TRAIN_SEQ
# Serving limits against the CPU forward, each about the geometric mean of
# two readings on an H100: full f32 on the card (4.4e-6 / 1.6e-6: 12 layers
# of f32 sums in another order) and the same requests with TF32 matmuls
# (2.2e-3 / 9.9e-4), which tf32_control requires the limits to catch.
SEQ_ATOL, POOLED_ATOL = 1e-4, 4e-5
BUCKETS = (1, 2, 4, 8)
SEQ_LEN = 512


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, arg_sets, iters):
    """Mean ms a call over ``iters`` calls timed with CUDA events, cycling
    through ``arg_sets`` (more bytes than the 50 MB L2 holds, so the inputs
    come from device memory as they do on the serving path)."""
    import torch

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean device ms a call of ``fn()`` over ``iters`` calls with the
    host's launch cost hidden: a sleep kernel holds the card while the host
    enqueues them all, so the CUDA events see only the device's work.
    Returns (device ms, host ms a call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10 ** 7)
    probe[1].record()
    probe[1].synchronize()
    cycles_per_ms = 10 ** 7 / probe[0].elapsed_time(probe[1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (2.0 * host_ms * iters + 5.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_ms_sets(fn, arg_sets, iters):
    """:func:`device_ms` over calls that cycle through ``arg_sets``."""
    it = itertools.cycle(arg_sets)
    return device_ms(lambda: fn(*next(it)), iters)


def bound(bytes_moved, flops, peak=FP32_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(v):
    """Spacing of bfloat16 values at |v| (8 significant bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def exact_bf16_layernorm(x, r, w, b, eps):
    """The exact LayerNorm (f64) of the same bf16-rounded sum ``x + r``, and
    the bf16 ulp of the largest term of ``(a - mean) * rstd * w + b`` at
    each element: an output near 0 by cancellation keeps the f32 error of
    its terms, many ulps of the output itself and under one of the terms."""
    a = (x + r).double()  # the add rounds to bf16 first, as in the kernel
    mean = a.mean(-1, keepdim=True)
    rstd = ((a - mean).square().mean(-1, keepdim=True) + eps).rsqrt()
    t = (a - mean) * rstd * w.double()
    y = t + b.double()
    return y, bf16_ulp(y.abs().maximum(t.abs()).maximum(b.double().abs()))


def check_layernorm(dtype_name, rows, h=LN_H, res_dtype_name=None, mean_offset=0.0, std=1.0,
                    timed=True):
    """The forward kernel at [rows, h] against the plain version: y, and
    the saved f32 mean and rstd the backward reads. ``res_dtype_name``
    float32 under a bf16 x is the mixed instance; ``mean_offset`` and
    ``std`` shape the rows (a large mean tests the two-pass variance);
    which variant runs (a warp a row, a block a row) follows ``h``."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    dtype = getattr(torch, dtype_name)
    rdtype = getattr(torch, res_dtype_name or dtype_name)
    mixed = rdtype != dtype
    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    w = torch.randn(h, generator=g, device=dev)
    b = torch.randn(h, generator=g, device=dev)
    sets = [((torch.randn(rows, h, generator=g, device=dev) * std + mean_offset).to(dtype),
             (torch.randn(rows, h, generator=g, device=dev) * std).to(rdtype), w, b, 1e-5)
            for _ in range(6 if timed else 1)]
    x, r = sets[0][0], sets[0][1]
    counter = ("MIXED_LAUNCHES" if mixed else "LAUNCHES" if dtype == torch.float32
               else "BF16_LAUNCHES")
    before = getattr(lnr, counter)
    y, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, b, 1e-5)
    if getattr(lnr, counter) != before + 1 or y.dtype != dtype:
        raise AssertionError(f"layernorm_residual {dtype_name} on {rdtype}: {y.dtype}, the "
                             f"{counter} kernel not counted")
    yp, mp, rp = lnr._reference(x, r, w, b, 1e-5)
    err = float((y.float() - yp.float()).abs().max())
    # mean absolute, rstd relative to its largest entry (~1/std of a row)
    stat_err = max(float((mean - mp).abs().max()), float((rstd - rp).abs().max() / rp.abs().max()))
    ulps = {}
    # the mean's atol scales with it (f32 sums of values near mean_offset)
    mean_tol = LN_F32_ATOL * max(1.0, mean_offset)
    if dtype == torch.float32 and mean_offset:
        # rows far from 0: y carries the f32 rounding of the sum (an ulp of
        # the mean times rstd) in both; the kernel may be at most LN_F32_ATOL
        # further from the exact (f64) answer than the plain version is
        y64, _ = exact_bf16_layernorm(x, r, w, b, 1e-5)
        ulps = {"kernel_vs_exact": float((y.double() - y64).abs().max()),
                "plain_vs_exact": float((yp.double() - y64).abs().max())}
        ok = (ulps["kernel_vs_exact"] <= ulps["plain_vs_exact"] + LN_F32_ATOL
              and stat_err <= mean_tol)
        tol = (f"kernel within plain + {LN_F32_ATOL} of the exact (f64) answer, mean atol "
               f"{mean_tol}; " + ", ".join(f"{k} {v:.3g}" for k, v in ulps.items()))
    elif dtype == torch.float32:
        ok = err <= LN_F32_ATOL and stat_err <= LN_F32_ATOL
        tol = f"y, mean atol {LN_F32_ATOL}, rstd rtol {LN_F32_ATOL}"
    else:
        # both add x + res alike (bf16: rounded to bf16; mixed: in f32) and
        # differ in the f32 order of the statistics and the affine; the
        # kernel may be at most one output ulp further from the exact answer
        # than the plain version is
        y64, ulp = exact_bf16_layernorm(x, r, w, b, 1e-5)
        ulps = {"kernel_vs_exact_ulps": float(((y.double() - y64).abs() / ulp).max()),
                "plain_vs_exact_ulps": float(((yp.double() - y64).abs() / ulp).max()),
                "kernel_vs_plain_ulps": float(((y.double() - yp.double()).abs() / ulp).max())}
        ok = (ulps["kernel_vs_exact_ulps"] <= ulps["plain_vs_exact_ulps"] + 1.0
              and stat_err <= mean_tol)
        tol = ("kernel within plain + 1 bf16 ulp of the exact (f64) answer, ulps of the largest "
               "affine term; " + ", ".join(f"{k} {v:.3f}" for k, v in ulps.items()))
    if not ok:
        raise AssertionError(f"layernorm_residual {dtype_name} on {rdtype} [{rows}, {h}], mean "
                             f"{mean_offset}: max err {err} stats {stat_err} beyond {tol}")
    variant = lnr._fwd_plan(h, dtype)
    # x and y in x's type, the residual in its own, read and written once
    t_b, by = bound(rows * h * (2 * x.element_size() + r.element_size()) + 8 * rows + 8 * h,
                    9 * rows * h)
    name = "layernorm_residual_fwd" + ("_mixed" if mixed else "" if dtype == torch.float32
                                       else "_bf16")
    entry = {"name": name, "route": "cuda", "source": "paddle_tpu_torch/csrc/layernorm_residual.cu",
             "replaces": "paddle_tpu/ops/pallas/layernorm_residual.py:188",
             "shape": [rows, h], "dtype": dtype_name, "residual_dtype": str(rdtype)[6:],
             "variant": variant, "mean_offset": mean_offset, "std": std, "max_abs_err": err,
             "stats_err": stat_err, "tolerance": tol, **ulps, "bound_ms": t_b, "bound_by": by}
    note = ""
    if timed:
        # device time behind a sleep kernel: at these sizes the wrapper's host
        # work would pace CUDA events around a loop of calls
        ms = device_ms_sets(lnr.layernorm_residual_fwd, sets, 50)[0]
        plain_ms = device_ms_sets(lnr._reference, sets, 20)[0]
        # one PyTorch call chain of the same function: the add (promoted
        # for the mixed case), F.layer_norm, the output in x's type
        lib_ms = device_ms_sets(lambda x, r, w, b, eps: F.layer_norm(
            x + r, (h,), w.to(r.dtype), b.to(r.dtype), eps).to(x.dtype), sets, 50)[0]
        entry.update(ms=ms, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     library="F.layer_norm(x + res) in the sum's type, cast to x's",
                     timing="device time behind a sleep kernel, inputs cycled past L2")
        note = (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{t_b:.4f} ms ({by})")
    log(f"layernorm_residual {dtype_name} on {rdtype} [{rows}, {h}] ({variant} variant, mean "
        f"{mean_offset}, std {std}): max err {err:.3g}, stats {stat_err:.3g} ({tol}){note}")
    return entry


def check_flash(seq, replaces):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    shape = (FLASH_B, FLASH_H, seq, FLASH_D)
    scale = FLASH_D ** -0.5

    def pad_bias():
        # BERT's additive mask: -1e4 on trailing pad keys, one length per row
        lens = torch.randint(seq // 2, seq + 1, (FLASH_B,), generator=g, device=dev)
        keep = torch.arange(seq, device=dev)[None, :] < lens[:, None]
        return ((1.0 - keep.float()) * -1e4)[:, None, None, :]

    sets = [(torch.randn(shape, generator=g, device=dev),
             torch.randn(shape, generator=g, device=dev),
             torch.randn(shape, generator=g, device=dev), pad_bias())
            for _ in range(3)]
    q, k, v, bias = sets[0]
    out, lse = fa.flash_attention_fwd(q, k, v, bias, False, scale)
    ref = fa._plain_attention(q, k, v, bias, False, scale)
    lse_ref = torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) * scale + bias, dim=-1)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    lse_err = float((lse.reshape(lse_ref.shape) - lse_ref).abs().max())
    if not (err <= FLASH_ATOL and lse_err <= FLASH_ATOL):
        raise AssertionError(f"flash_attention L={seq}: max err {err}, lse err {lse_err} "
                             f"beyond atol {FLASH_ATOL}")
    nbytes = 4 * (4 * q.numel() + FLASH_B * seq + FLASH_B * FLASH_H * seq)
    flops = 4 * FLASH_B * FLASH_H * seq * seq * FLASH_D
    t_b, by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)  # 3xTF32: three TF32 passes
    t_b32, by32 = bound(nbytes, flops)
    # device time behind a sleep kernel: at L=128 the host's launch cost is
    # longer than the kernel, and CUDA events around back-to-back calls
    # would time the host
    iters = 100 if seq <= 128 else 30
    ms, host_ms = device_ms_sets(lambda q, k, v, bias: fa.flash_attention_fwd(
        q, k, v, bias, False, scale), sets, iters)
    plain_ms, _ = device_ms_sets(lambda q, k, v, bias: fa._plain_attention(
        q, k, v, bias, False, scale), sets, iters)
    lib_ms, _ = device_ms_sets(lambda q, k, v, bias: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias), sets, iters)
    log(f"flash_attention {shape}: max err {err:.3g}, lse err {lse_err:.3g} (atol {FLASH_ATOL}); "
        f"kernel {ms:.4f} ms of device time (host {host_ms:.4f} ms a call), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound 3xTF32 {t_b:.4f} ms ({by}), FP32 "
        f"{t_b32:.4f} ms ({by32})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "shape": list(shape), "dtype": "float32",
            "max_abs_err": max(err, lse_err), "tolerance": f"atol {FLASH_ATOL}", "ms": ms,
            "kernel_ms": ms, "timing": "device time behind a sleep kernel",
            "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
            "bound_note": "3xTF32: 3 x products / 495 TFLOP/s", "bound_fp32_ms": t_b32,
            "bound_fp32_by": by32, "library_ms": lib_ms}


def check_flash_fwd_shape(batch, seq, lk, d, causal, rate):
    """The forward at [batch, 12, seq, d] with ``lk`` keys, a pad bias,
    causal or not, against the plain version with the same seed: out and
    lse within ``FLASH_ATOL`` (untimed)."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(8)
    shape = (batch, FLASH_H, seq, d)
    q = torch.randn(shape, generator=g, device="cuda")
    k, v = (torch.randn(batch, FLASH_H, lk, d, generator=g, device="cuda") for _ in range(2))
    bias = _pad_bias(g, batch, lk)
    seed = fa._draw_seed(g, "cuda") if rate else None
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
    pout, plse = fa._plain_fwd(q, k, v, bias, causal, scale, rate, seed)
    torch.cuda.synchronize()
    err = float((out - pout).abs().max())
    lse_err = float((lse - plse).abs().max())
    label = (f"flash_attention_fwd {list(shape)} Lk {lk}{' causal' if causal else ''} rate "
             f"{rate}")
    log(f"{label}: out err {err:.3g}, lse err {lse_err:.3g} (atol {FLASH_ATOL})")
    if not (err <= FLASH_ATOL and lse_err <= FLASH_ATOL):
        raise AssertionError(f"{label}: out err {err}, lse err {lse_err} beyond atol {FLASH_ATOL}")
    return {"shape": list(shape), "keys": lk, "causal": causal, "dropout_rate": rate,
            "max_abs_err": err, "lse_err": lse_err, "tolerance": f"atol {FLASH_ATOL}"}


def check_attention_crossover(seqs=(128, 256, 384, 512)):
    """The flash kernel against the port's unfused attention (the branch
    ``MultiHeadAttention`` takes below ``FLASH_ATTENTION_MIN_SEQ``: two
    matmuls, the mask added, the port's softmax) at [8, 12, L, 64] with a pad
    bias: the forward alone (serving), and forward plus backward at rate 0
    (training). Device time behind a sleep kernel, no limits: the numbers
    for the dispatch threshold."""
    import torch

    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def unfused(q, k, v, bias, scale):
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
        return torch.matmul(PF.softmax(scores, axis=-1), v)

    g = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for seq in seqs:
        shape = (FLASH_B, FLASH_H, seq, FLASH_D)
        scale = FLASH_D ** -0.5
        sets = [(*(torch.randn(shape, generator=g, device="cuda") for _ in range(4)),
                 _pad_bias(g, FLASH_B, seq)) for _ in range(3)]
        iters = 50 if seq <= 256 else 20
        fwd = {"flash": device_ms_sets(lambda q, k, v, do, bias: fa.flash_attention_fwd(
                   q, k, v, bias, False, scale), sets, iters)[0],
               "unfused": device_ms_sets(lambda q, k, v, do, bias: unfused(q, k, v, bias, scale),
                                         sets, iters)[0]}

        def train(fn):
            def step(q, k, v, do, bias):
                ins = [t.detach().requires_grad_() for t in (q, k, v)]
                torch.autograd.grad(fn(*ins, bias), ins, do)
            return device_ms_sets(step, sets, iters)[0]

        both = {"flash": train(lambda q, k, v, bias: fa.flash_attention(q, k, v, bias,
                                                                         scale=scale)),
                "unfused": train(lambda q, k, v, bias: unfused(q, k, v, bias, scale))}
        log(f"attention at {list(shape)}, pad bias: forward flash {fwd['flash']:.4f} ms, unfused "
            f"{fwd['unfused']:.4f} ms; forward + backward flash {both['flash']:.4f} ms, unfused "
            f"{both['unfused']:.4f} ms")
        rows.append({"shape": list(shape), "forward_ms": fwd, "forward_backward_ms": both})
    return rows


def check_layernorm_bwd(dtype_name, rows=TRAIN_ROWS, h=LN_H, timed=True):
    """The backward kernel at [rows, h] (the training path's [16384, 768] by
    default) against the plain version on the same inputs and saved
    statistics (the forward's statistics at 768 are checked by
    ``check_layernorm``), and against itself: a second run must give the
    same ``da`` and dw/db partials bit for bit."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(3)
    dev, eps = "cuda", 1e-5
    w = torch.randn(h, generator=g, device=dev)
    b = torch.randn(h, generator=g, device=dev)
    sets = []
    for _ in range(3 if timed else 1):
        x, r, dy = (torch.randn(rows, h, generator=g, device=dev).to(dtype) for _ in range(3))
        _, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, b, eps)
        sets.append((x, r, w, mean, rstd, dy))
    x, r, _, mean, rstd, dy = sets[0]
    variant = lnr._bwd_plan(rows, h, dtype, lnr._sm_count(x.device.index))[0]
    da, dwp, dbp = lnr.layernorm_residual_bwd(*sets[0])
    again = lnr.layernorm_residual_bwd(*sets[0])
    repeats = all(torch.equal(a_, b_) for a_, b_ in zip((da, dwp, dbp), again))
    pa, pw, pb = lnr._reference_bwd(*sets[0])
    dw_err = float((dwp.sum(0) - pw.sum(0)).abs().max() / pw.abs().max())
    db_err = float((dbp.sum(0) - pb.sum(0)).abs().max() / pb.abs().max())
    err = float((da.float() - pa.float()).abs().max())
    if dtype == torch.float32:
        ok = err <= LN_F32_ATOL
        tol = f"da atol {LN_F32_ATOL}"
    else:
        # both compute in f32 and round da once; near-zero outputs by
        # cancellation carry the f32 error of their terms, so the ulp is the
        # largest term's (rstd * w * dy)
        term = (rstd[:, None] * w * dy.float()).abs().maximum(pa.float().abs())
        ulps = float(((da.float() - pa.float()).abs() / bf16_ulp(term)).max())
        ok = ulps <= 1.0
        tol = f"da within 1 bf16 ulp of the largest term (read {ulps:.3f})"
    ok = ok and dw_err <= LN_PARAM_RTOL and db_err <= LN_PARAM_RTOL
    tol += f"; dw, db rtol {LN_PARAM_RTOL} of the largest entry"
    label = f"layernorm_residual_bwd {dtype_name} [{rows}, {h}] ({variant} variant)"
    if not ok:
        raise AssertionError(f"{label}: da err {err}, dw {dw_err}, db {db_err} beyond {tol}")
    if not repeats:
        raise AssertionError(f"{label}: a second run differs (da or the dw/db partials)")
    entry = {"name": "layernorm_residual_bwd" + ("" if dtype == torch.float32 else "_bf16"),
             "route": "cuda",
             "source": "paddle_tpu_torch/csrc/layernorm_residual_bwd.cu",
             "replaces": "paddle_tpu/ops/pallas/layernorm_residual.py:219",
             "shape": [rows, h], "dtype": dtype_name, "variant": variant, "max_abs_err": err,
             "dw_rel_err": dw_err, "db_rel_err": db_err, "tolerance": tol,
             "repeats_bit_for_bit": repeats}
    if not timed:
        log(f"{label}: da err {err:.3g}, dw {dw_err:.3g}, db {db_err:.3g} ({tol}); a second run "
            "equal bit for bit")
        return entry
    in_bytes = x.element_size()
    # x, res, dy read and da written; mean, rstd, w read; dw, db written (the
    # function's outputs: the kernel's per-block partials are its own choice)
    t_b, by = bound(rows * h * 4 * in_bytes + 8 * rows + 4 * h + 8 * h, 12 * rows * h)
    # device time behind a sleep kernel: at [4096, 512] the wrapper's host
    # work would pace CUDA events around a loop of calls
    ms = device_ms_sets(lnr.layernorm_residual_bwd, sets, 100)[0]

    def whole(*args):  # what the autograd Function runs: the kernel, then the two sums
        _, dwp_, dbp_ = lnr.layernorm_residual_bwd(*args)
        return dwp_.sum(0), dbp_.sum(0)

    whole_ms = device_ms_sets(whole, sets, 100)[0]
    plain_ms = device_ms_sets(lnr._reference_bwd, sets, 100)[0]
    graphs = []
    for x_, r_, w_, _, _, dy_ in sets:
        ins = [t.detach().requires_grad_() for t in (x_, r_, w_, b)]
        y = F.layer_norm(ins[0] + ins[1], (h,), ins[2].to(dtype), ins[3].to(dtype), eps)
        graphs.append((y, ins, dy_))
    lib_ms = device_ms_sets(lambda y, ins, dy_: torch.autograd.grad(y, ins, dy_,
                                                                    retain_graph=True),
                            graphs, 100)[0]
    log(f"{label}: da err {err:.3g}, dw {dw_err:.3g}, db {db_err:.3g} ({tol}); a second run "
        f"equal bit for bit; kernel {ms:.4f} ms (with the two partial sums {whole_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {t_b:.4f} ms ({by})")
    entry.update(ms=ms, kernel_ms=ms, whole_backward_ms=whole_ms, plain_ms=plain_ms,
                 bound_ms=t_b, bound_by=by, library_ms=lib_ms,
                 timing="device time behind a sleep kernel, inputs cycled")
    return entry


def _pad_bias(g, batch, seq):
    """BERT's additive mask: -1e4 on trailing pad keys, one length per row."""
    import torch

    lens = torch.randint(seq // 2, seq + 1, (batch,), generator=g, device="cuda")
    keep = torch.arange(seq, device="cuda")[None, :] < lens[:, None]
    return ((1.0 - keep.float()) * -1e4)[:, None, None, :]


def check_flash_bwd(batch, seq, rate, causal, replaces, lk=None, d=FLASH_D, timed=True):
    """The dQ and dK/dV kernels at [batch, 12, seq, d] (keys ``lk``, default
    ``seq``) with a pad bias against autograd through the plain version
    with the same dropout seed. Returns the two kernels' entries. Timed:
    each kernel, the whole backward, the plain version and SDPA's backward
    (rate 0, the same mask), beside two bounds: the products on the FP32
    units, and in 3xTF32 on the tensor cores (three TF32 passes), which the
    kernels use and which is the smaller."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    lk = seq if lk is None else lk
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = (batch, FLASH_H, seq, d)
    kshape = (batch, FLASH_H, lk, d)
    scale = d ** -0.5

    def make():
        q, do = (torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        k, v = (torch.randn(kshape, generator=g, device="cuda") for _ in range(2))
        bias = _pad_bias(g, batch, lk)
        seed = fa._draw_seed(g, "cuda") if rate else None
        out, lse = fa.flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
        delta = (do * out).sum(-1).reshape(-1, seq)
        return q, k, v, bias, lse, delta, do, causal, scale, rate, seed, out

    sets = [make() for _ in range(3 if timed else 1)]
    args = sets[0][:-1]
    q, k, v, bias, lse, delta, do = args[:7]
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    pq, pk, pv = fa._plain_bwd(q, k, v, bias, sets[0][-1], lse, do, causal, scale, rate,
                               args[-1])
    torch.cuda.synchronize()
    errs = [float((a - b_).abs().max()) for a, b_ in zip((dq, dk, dv), (pq, pk, pv))]
    label = (f"flash backward {list(shape)}{f' Lk {lk}' if lk != seq else ''} rate {rate}"
             f"{' causal' if causal else ''}")
    if max(errs) > FLASH_ATOL:
        raise AssertionError(f"{label}: dq/dk/dv err {errs} beyond atol {FLASH_ATOL}")
    # query-key pairs the function needs: all, or the causal triangle
    # (bottom-right aligned: query i sees keys up to i + lk - seq)
    pairs = sum(max(0, min(lk, i + lk - seq + 1)) for i in range(seq)) if causal else seq * lk
    bhld = batch * FLASH_H * pairs * d
    stats = 8 * batch * FLASH_H * seq + 4 * batch * lk  # lse, delta, the [B,1,1,Lk] bias
    qb, kb = 4 * q.numel(), 4 * k.numel()
    dq_io, dkv_io = 3 * qb + 2 * kb + stats, 2 * qb + 4 * kb + stats  # inputs read, grads written
    all_io = 3 * qb + 4 * kb + stats
    bounds = {}
    for name, nbytes, flops in (("dq", dq_io, 6 * bhld), ("dkv", dkv_io, 8 * bhld),
                                ("all", all_io, 10 * bhld)):
        bounds[name] = {"fp32": bound(nbytes, flops),
                        "3xtf32": bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)}
    common = {"route": "cuda", "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "shape": list(shape), "keys": lk, "dtype": "float32", "dropout_rate": rate,
              "causal": causal, "tolerance": f"atol {FLASH_ATOL}"}
    entries = []
    for name, err, rep in (("flash_attention_bwd_dq", errs[0], replaces[0]),
                           ("flash_attention_bwd_dkv", max(errs[1:]), replaces[1])):
        key = "dq" if name.endswith("dq") else "dkv"
        (b3, by3), (b32, by32) = bounds[key]["3xtf32"], bounds[key]["fp32"]
        entries.append({"name": name, "replaces": rep, "max_abs_err": err, "bound_ms": b3,
                        "bound_by": by3, "bound_note": "3xTF32: 3 x products / 495 TFLOP/s",
                        "bound_fp32_ms": b32, "bound_fp32_by": by32, **common})
    if not timed:
        log(f"{label}: err dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (atol "
            f"{FLASH_ATOL})")
        return tuple(entries)
    unpack = lambda *a: a[:-1]  # noqa: E731
    ms_dq = time_ms(lambda *a: fa.flash_attention_bwd_dq(*unpack(*a)), sets, 10)
    ms_dkv = time_ms(lambda *a: fa.flash_attention_bwd_dkv(*unpack(*a)), sets, 10)
    whole_ms = time_ms(lambda q, k, v, bias, lse, delta, do, c, sc, r, seed, out:
                       fa.flash_attention_bwd(q, k, v, bias, out, lse, do, c, sc, r, seed),
                       sets, 10)
    plain_ms = time_ms(lambda q, k, v, bias, lse, delta, do, c, sc, r, seed, out:
                       fa._plain_bwd(q, k, v, bias, out, lse, do, c, sc, r, seed), sets, 5)
    graphs = []
    for q_, k_, v_, bias_, *_rest in sets:
        ins = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        mask = bias_
        if causal:
            mask = bias_ + torch.full((seq, lk), -1e30, device="cuda").triu(lk - seq + 1)
        o = F.scaled_dot_product_attention(*ins, attn_mask=mask)
        graphs.append((o, ins, _rest[2]))
    lib_ms = time_ms(lambda o, ins, do_: torch.autograd.grad(o, ins, do_, retain_graph=True),
                     graphs, 10)
    (t_all, _), (t_all32, _) = bounds["all"]["3xtf32"], bounds["all"]["fp32"]
    log(f"{label}: err dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (atol {FLASH_ATOL}); "
        f"dQ {ms_dq:.4f} ms (bound 3xTF32 {entries[0]['bound_ms']:.4f}, FP32 "
        f"{entries[0]['bound_fp32_ms']:.4f}), dK/dV {ms_dkv:.4f} ms (bound 3xTF32 "
        f"{entries[1]['bound_ms']:.4f}, FP32 {entries[1]['bound_fp32_ms']:.4f}), whole backward "
        f"{whole_ms:.4f} ms (bound 3xTF32 {t_all:.4f}, FP32 {t_all32:.4f}), plain "
        f"{plain_ms:.4f} ms, library (SDPA backward, no dropout) {lib_ms:.4f} ms")
    total = {"ms": whole_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "library": "scaled_dot_product_attention backward, no dropout",
             "bound_ms": t_all, "bound_fp32_ms": t_all32}
    for e, ms in zip(entries, (ms_dq, ms_dkv)):
        e.update(ms=ms, kernel_ms=ms, plain_ms=plain_ms, library_ms=None, backward_total=total)
    return tuple(entries)


def check_dropout_masks():
    """The mask each kernel applies, read back through its outputs, equals
    the plain version's bit for bit at [32, 12, 512, 512]. With q = k = 0
    every probability is 1/L, so one-hot operands expose the mask 64 keys
    (or query rows) at a time: the forward's out > 0, the dK/dV kernel's
    dV > 0 and the dQ kernel's dQ > 0 exactly where an entry is kept."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    b, h, seq, d, rate = TRAIN_B, FLASH_H, TRAIN_SEQ, FLASH_D, ATTN_DROPOUT
    g = torch.Generator(device="cuda").manual_seed(6)
    seed = fa._draw_seed(g, "cuda")
    want = fa.dropout_keep_mask(seed, b, h, seq, seq, rate)
    scale = d ** -0.5
    zero = torch.zeros(b, h, seq, d, device="cuda")
    e0 = torch.zeros_like(zero)
    e0[..., 0] = 1.0
    wrong = {"forward": 0, "dq": 0, "dkv": 0}
    for c in range(seq // d):
        cols = slice(c * d, (c + 1) * d)
        onehot = torch.zeros_like(zero)
        onehot[:, :, cols, :] = torch.eye(d, device="cuda")
        block = want[..., cols]  # [b, h, seq rows, d keys]
        out, lse = fa.flash_attention_fwd(zero, zero, onehot, None, False, scale, rate, seed)
        wrong["forward"] += int(((out > 0) != block).sum())
        out0, lse0 = fa.flash_attention_fwd(zero, zero, zero, None, False, scale, rate, seed)
        delta0 = torch.zeros(b * h, seq, device="cuda")
        _, dv = fa.flash_attention_bwd_dkv(zero, zero, zero, None, lse0, delta0, onehot, False,
                                           scale, rate, seed)
        wrong["dkv"] += int(((dv > 0) != want[:, :, cols, :].transpose(-1, -2)).sum())
        out1, lse1 = fa.flash_attention_fwd(zero, onehot, e0, None, False, scale, rate, seed)
        delta1 = (e0 * out1).sum(-1).reshape(-1, seq)
        dq = fa.flash_attention_bwd_dq(zero, onehot, e0, None, lse1, delta1, e0, False, scale,
                                       rate, seed)
        wrong["dq"] += int(((dq > 0) != block).sum())
    kept = float(want.float().mean())
    log(f"dropout mask [{b}, {h}, {seq}, {seq}] rate {rate}: entries differing from the plain "
        f"version's {wrong} (kept fraction {kept:.5f})")
    if any(wrong.values()):
        raise AssertionError(f"dropout masks differ from the plain version's: {wrong}")
    return {"shape": [b, h, seq, seq], "rate": rate, "kept_fraction": kept,
            "entries_differing": wrong}


def check_flash_dropout_fwd():
    """The forward with in-kernel dropout at the training path's shape
    against the plain version with the same seed."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (TRAIN_B, FLASH_H, TRAIN_SEQ, FLASH_D)
    scale = FLASH_D ** -0.5
    sets = [(*(torch.randn(shape, generator=g, device="cuda") for _ in range(3)),
             _pad_bias(g, TRAIN_B, TRAIN_SEQ), fa._draw_seed(g, "cuda")) for _ in range(3)]
    q, k, v, bias, seed = sets[0]
    out, lse = fa.flash_attention_fwd(q, k, v, bias, False, scale, ATTN_DROPOUT, seed)
    pout, plse = fa._plain_fwd(q, k, v, bias, False, scale, ATTN_DROPOUT, seed)
    err = max(float((out - pout).abs().max()), float((lse - plse).abs().max()))
    if err > FLASH_ATOL:
        raise AssertionError(f"flash forward with dropout: err {err} beyond atol {FLASH_ATOL}")
    nbytes = 4 * (4 * q.numel() + TRAIN_B * TRAIN_SEQ + TRAIN_B * FLASH_H * TRAIN_SEQ)
    flops = 4 * TRAIN_B * FLASH_H * TRAIN_SEQ * TRAIN_SEQ * FLASH_D
    t_b, by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    t_b32, _ = bound(nbytes, flops)
    run = lambda q, k, v, bias, seed: fa.flash_attention_fwd(  # noqa: E731
        q, k, v, bias, False, scale, ATTN_DROPOUT, seed)
    ms = time_ms(run, sets, 10)
    ms_nodrop = time_ms(lambda q, k, v, bias, seed: fa.flash_attention_fwd(
        q, k, v, bias, False, scale), sets, 10)
    plain_ms = time_ms(lambda q, k, v, bias, seed: fa._plain_fwd(
        q, k, v, bias, False, scale, ATTN_DROPOUT, seed), sets, 5)
    # the yardstick draws its mask from torch's own generator: the same kind
    # of work, not the same mask
    lib_ms = time_ms(lambda q, k, v, bias, seed: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias, dropout_p=ATTN_DROPOUT), sets, 10)
    log(f"flash_attention_fwd {list(shape)} dropout {ATTN_DROPOUT}: err {err:.3g} (atol "
        f"{FLASH_ATOL}); kernel {ms:.4f} ms ({ms_nodrop:.4f} ms without dropout), plain "
        f"{plain_ms:.4f} ms, library (SDPA, dropout_p {ATTN_DROPOUT}, its own mask) "
        f"{lib_ms:.4f} ms, bound 3xTF32 {t_b:.4f} ms ({by}), FP32 {t_b32:.4f} ms")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:548", "shape": list(shape),
            "dtype": "float32", "dropout_rate": ATTN_DROPOUT, "max_abs_err": err,
            "tolerance": f"atol {FLASH_ATOL}", "ms": ms, "kernel_ms": ms,
            "kernel_ms_without_dropout": ms_nodrop, "plain_ms": plain_ms, "bound_ms": t_b,
            "bound_by": by, "bound_fp32_ms": t_b32, "library_ms": lib_ms,
            "library": f"scaled_dot_product_attention, dropout_p {ATTN_DROPOUT}, its own mask"}


def check_kernels():
    """One entry per f32 kernel of the serving and training paths (the bf16
    ones: ``check_amp_kernels``). The
    LayerNorm kernels and the attention backward stand at the shape and
    dtype the training path gives them (f32, batch 32 x L=512), the
    attention forward at the serving shape, as before. The other shapes and
    options checked ride along under ``also_checked``, without launch
    counts: the LayerNorm forward at the serving shape and in bf16; its
    backward at a ragged [12345, 1024] in f32 and bf16 and
    at [37, 4100], a width the row variant does not take (untimed); the
    attention forward at the training shape with dropout and at L=128
    (where the TPU took its small variant), the dropout masks, at D = 32
    and 128 and at ragged causal shapes with Lq != Lk (untimed), and
    against the unfused attention at L = 128-512 (timed); the attention
    backward at rate 0 and causal at L=128 (timed), at D = 32 and 128 and at
    ragged causal shapes with Lq != Lk (untimed)."""
    ln = check_layernorm("float32", TRAIN_ROWS)
    ln["also_checked"] = [check_layernorm("float32", LN_ROWS),
                          check_layernorm("bfloat16", LN_ROWS)] + [
        check_layernorm("float32", LN_ROWS, h, timed=False) for h in (1000, 4096)] + [
        check_layernorm("float32", LN_ROWS, mean_offset=100.0, std=0.1, timed=False)]
    ln_bwd = check_layernorm_bwd("float32")
    ln_bwd["also_checked"] = [check_layernorm_bwd("float32", 12345, 1024, timed=False),
                              check_layernorm_bwd("bfloat16", 12345, 1024, timed=False),
                              check_layernorm_bwd("float32", 37, 4100, timed=False)]
    fa = check_flash(SEQ_LEN, "paddle_tpu/ops/pallas/flash_attention.py:548")
    fa["also_checked"] = [check_flash(128, "paddle_tpu/ops/pallas/flash_attention.py:370"),
                          check_flash_dropout_fwd(), {"dropout_masks": check_dropout_masks()},
                          check_flash_fwd_shape(4, 256, 256, 32, True, ATTN_DROPOUT),
                          check_flash_fwd_shape(4, 256, 256, 128, True, ATTN_DROPOUT),
                          check_flash_fwd_shape(2, 300, 257, 64, True, 0.0),
                          check_flash_fwd_shape(2, 257, 300, 32, True, ATTN_DROPOUT),
                          {"crossover_vs_unfused": check_attention_crossover()}]
    tiled = ("paddle_tpu/ops/pallas/flash_attention.py:765",
             "paddle_tpu/ops/pallas/flash_attention.py:815")
    small = ("paddle_tpu/ops/pallas/flash_attention.py:433",) * 2
    dq, dkv = check_flash_bwd(TRAIN_B, TRAIN_SEQ, ATTN_DROPOUT, False, tiled)
    for extra in (check_flash_bwd(TRAIN_B, TRAIN_SEQ, 0.0, False, tiled),
                  check_flash_bwd(FLASH_B, 128, ATTN_DROPOUT, True, small),
                  check_flash_bwd(4, 256, ATTN_DROPOUT, False, tiled, d=32, timed=False),
                  check_flash_bwd(4, 256, ATTN_DROPOUT, True, tiled, d=128, timed=False),
                  check_flash_bwd(2, 300, ATTN_DROPOUT, True, tiled, lk=257, timed=False),
                  check_flash_bwd(2, 257, 0.0, True, tiled, lk=300, d=32, timed=False)):
        dq.setdefault("also_checked", []).append(extra[0])
        dkv.setdefault("also_checked", []).append(extra[1])
    return [ln, ln_bwd, fa, dq, dkv]


def _http(url, body=None, timeout=300):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def make_requests(cfg, rng):
    """Rows of token ids at L=512; even requests end in pad tokens."""
    reqs = []
    for i, rows in enumerate((1, 4, 2, 3, 1, 2)):
        ids = rng.randint(1, cfg.vocab_size, (rows, SEQ_LEN)).astype(np.int64)
        if i % 2 == 0:
            for r in range(rows):
                ids[r, rng.randint(SEQ_LEN // 4, SEQ_LEN):] = cfg.pad_token_id
        types = (np.arange(SEQ_LEN)[None, :] >= SEQ_LEN // 2).astype(np.int64).repeat(rows, 0)
        reqs.append({"input_ids": ids, "token_type_ids": types})
    return reqs


_KERNEL_KINDS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
                 "flash_attention_bwd_dkv_bf16", "layernorm_residual_fwd",
                 "layernorm_residual_bwd", "conv_mm", "conv_mm_bf16", "bn_reduce",
                 "bn_elementwise", "momentum", "int8_mm", "pool_bwd")
# templates that take both dtypes: their bf16 instances count apart
_TEMPLATE_KINDS = ("layernorm_residual_fwd", "layernorm_residual_bwd", "bn_reduce",
                   "bn_elementwise", "pool_bwd")


def _kernel_kind(name):
    n = name.lower().replace("_row_kernel", "_kernel")  # the LayerNorm backward's row variant
    n = n.replace("conv_mm_reduce_kernel", "conv_mm_kernel")  # split-K's second pass
    n = n.replace("pool_bwd_nchw_kernel", "pool_bwd_kernel").replace("pool_bwd_nhwc_kernel",
                                                                      "pool_bwd_kernel")
    for kind in _KERNEL_KINDS:
        if f"{kind}_kernel" in n:
            if kind not in _TEMPLATE_KINDS or "bfloat16" not in n:
                return kind
            # the LayerNorm forward's mixed instance: a bf16 x on an f32 residual
            mixed = kind == "layernorm_residual_fwd" and "bfloat16, float" in n
            return kind + ("_mixed" if mixed else "_bf16")
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if "im2col" in n or "col2im" in n:
        return "im2col/col2im"
    if "conv" in n or "cudnn" in n or "implicit" in n or "wgrad" in n or "dgrad" in n:
        return "cudnn conv"
    if "gemm" in n or "cutlass" in n or "xmma" in n or n.startswith("nvjet"):
        return "matmul"
    return "other"


def _top_kernels(prof, k=10):
    """The ``k`` device kernels that took the most time: (name, ms, calls)."""
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "device_time_total", None)
            rows.append((e.key[:70], (e.cuda_time_total if t is None else t) / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])[:k]


def _device_time_by_kind(prof):
    """Kernel time (ms) by kind from a ``torch.profiler`` run, and the
    number of device events (kernels, copies, sets) behind it."""
    by_kind, events = {}, 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host ops: their device time is their kernels', counted below
        t = getattr(e, "device_time_total", None)
        t = (e.cuda_time_total if t is None else t) / 1e3
        kind = _kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + t
        events += e.count
    return by_kind, events


SERVE_REPLICAS = 2  # worker threads of every served model, sharing one graph per bucket


def _serve(pred, buckets, reqs, label):
    """Serve ``pred`` behind ``InferenceServer`` with ``SERVE_REPLICAS``
    workers on ``buckets``, wait for ``/healthz``, POST ``reqs`` (feeds by
    input name): the first two alone, the rest at once. Warmup must capture
    each bucket once (the store's misses equal the buckets, whatever the
    replica count) and the requests none (``extra_compiles() == 0``,
    ``/statz`` ``compiles``). Returns (answers, kernel launches over the
    requests, forwards run for them, readings); the server is drained and
    stopped."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import InferenceServer

    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    srv = InferenceServer(pred, port=0, replicas=SERVE_REPLICAS, buckets=buckets,
                          batch_timeout_ms=5.0)
    t0 = time.perf_counter()
    srv.start()
    answers = [None] * len(reqs)
    try:
        status, health = _http(srv.url + "/healthz")
        if status != 200:
            raise AssertionError(f"/healthz answered {status}: {health}")
        reserved = torch.cuda.memory_reserved()
        readings = {"replicas": SERVE_REPLICAS, "graphs": len(pred.store),
                    "misses_after_warmup": pred.store.misses,
                    "reserved_before_warmup_mib": reserved0 / 2**20,
                    "reserved_after_warmup_mib": reserved / 2**20}
        log(f"{label} server ready at {srv.url} after {time.perf_counter() - t0:.1f} s "
            f"(warmup over buckets {buckets}, {SERVE_REPLICAS} replicas): {readings}")
        if pred.store.misses != len(buckets) or len(pred.store) != len(buckets):
            raise AssertionError(f"{label}: warmup captured {pred.store.misses} graphs "
                                 f"({len(pred.store)} stored) for {len(buckets)} buckets")
        batches0 = srv.batcher.stats["batches"]
        reset_launch_counts()

        def post(i):
            body = {"inputs": {n: a.tolist() for n, a in reqs[i].items()}}
            t = time.perf_counter()
            answers[i] = _http(srv.url + "/predict", body)
            log(f"{label} request {i} ({len(next(iter(reqs[i].values())))} rows): HTTP round "
                f"trip {(time.perf_counter() - t) * 1e3:.1f} ms")

        for i in (0, 1):
            post(i)
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2, len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        counts = launch_counts()
        forwards = srv.batcher.stats["batches"] - batches0
        compiles = _http(srv.url + "/statz")[1]["compiles"]
    finally:
        srv.stop(drain=True)
    if srv.pool.alive:
        raise AssertionError(f"{label}: replica workers still alive after drain")
    for i, ans in enumerate(answers):
        if ans is None or ans[0] != 200:
            raise AssertionError(f"{label} request {i} failed: {ans and ans[0]} "
                                 f"{ans and str(ans[1])[:300]}")
    readings.update(misses_after_requests=pred.store.misses, hits=pred.store.hits,
                    extra_compiles=srv.pool.extra_compiles(), statz_compiles=compiles)
    log(f"{label}: after {len(reqs)} requests in {forwards} batches: {readings}")
    if (pred.store.misses != len(buckets) or readings["extra_compiles"]
            or compiles != {"buckets": len(buckets), "unexpected": 0}):
        raise AssertionError(f"{label}: the requests captured graphs after warmup: {readings}")
    return answers, counts, forwards, readings


PROFILE_ATTEMPTS = 3
TRACER_WARMUP_KERNELS = 8  # launched and waited for at the start of a checked profile


def _tracer_warmup():
    """Tiny kernels of their own at the start of a profile whose launches
    are checked, waited for: the tracer now and then misses a profile's
    first kernels (in two runs three profiles in a row missed the first of
    ResNet-50's 33 bf16 conv launches at batch 1, the second with one
    warm-up kernel before them), and these then fall on the warm-up
    kernels, which are no kernels of the port's."""
    import torch

    for _ in range(TRACER_WARMUP_KERNELS):
        torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


def _profile_run(fn, feed, label):
    """One call of ``fn(feed)`` (a ``Predictor.run``, host inputs and outputs
    included, or its eager counterpart) under ``torch.profiler``: the port's
    kernels the profile saw run must equal the launches booked over the
    call. The tracer now and then misses a few of the first kernels of a
    profile (1 of ~25 profiled forwards on the H100), so a profile that
    parts from the booking is taken again, up to ``PROFILE_ATTEMPTS`` times;
    a graph that dropped or repeated a launch parts every time. Logs kernel
    time by kind and the top kernels; returns (wall ms, device busy ms,
    device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    fn(feed)
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _tracer_warmup()
            t0 = time.perf_counter()
            fn(feed)  # ends in a copy to the host, so the device is done
            wall_ms = (time.perf_counter() - t0) * 1e3
        try:
            _check_profiled_launches(prof, launch_counts(), label)
            break
        except AssertionError as e:
            if attempt == PROFILE_ATTEMPTS:
                raise
            log(f"{label}: profile {attempt} of {PROFILE_ATTEMPTS} parts from the booking, "
                f"taken again: {e}")
    return _log_profile(prof, wall_ms, label)


def _log_profile(prof, wall_ms, label, top=6):
    by_kind, events = _device_time_by_kind(prof)
    busy = sum(by_kind.values())
    log(f"{label}: {wall_ms:.3f} ms wall, device busy {busy:.3f} ms ({busy / wall_ms:.1%}) in "
        f"{events} device events; by kind (ms): "
        + ", ".join(f"{k} {v:.3f} ({v / busy:.1%})" for k, v in
                    sorted(by_kind.items(), key=lambda kv: -kv[1])))
    log(f"{label}, top kernels (name, ms, calls): "
        + "; ".join(f"{n} {t:.3f} {c}" for n, t, c in _top_kernels(prof, top)))
    return wall_ms, busy, events


SERVE_TIMED_RUNS = 10  # Predictor.run calls a side and a bucket for the mean wall


def _captured_vs_eager(pred, feeds, eager, label):
    """``Predictor.run`` (a replayed graph) against ``eager`` (the same
    forward run op by op from the same host inputs to the same host
    outputs) at each bucket of ``feeds`` ({bucket: host feed}): the mean
    wall of ``SERVE_TIMED_RUNS`` calls (host clock; each call ends in a copy
    to the host) and the device busy time of a profiled call, side by side.
    The two answers are logged against each other. Returns the readings by
    bucket."""
    out = {}
    for bucket, feed in feeds.items():
        r = {}
        for side, fn in (("eager", eager), ("captured", pred.run)):
            ans = fn(feed)
            t0 = time.perf_counter()
            for _ in range(SERVE_TIMED_RUNS):
                fn(feed)
            wall = (time.perf_counter() - t0) * 1e3 / SERVE_TIMED_RUNS
            _, busy, events = _profile_run(fn, feed, f"{label} {side} bucket {bucket}")
            r[side] = {"wall_ms": wall, "busy_ms": busy, "device_events": events}
            r[f"{side}_answer"] = ans
        diff = max(float(np.abs(a - b).max()) for a, b in zip(r.pop("eager_answer"),
                                                               r.pop("captured_answer")))
        r["max_abs_diff"] = diff
        out[bucket] = r
        e, c = r["eager"], r["captured"]
        log(f"{label} bucket {bucket}: Predictor.run wall eager {e['wall_ms']:.3f} ms, captured "
            f"{c['wall_ms']:.3f} ms; device busy eager {e['busy_ms']:.3f} ms, captured "
            f"{c['busy_ms']:.3f} ms; answers apart by {diff:.3g}")
    return out


CONCURRENT_RUNS = 20  # runs of each of two threads replaying one bucket


def _concurrent_replays(pred, make_feed, bucket, off_ladder, label):
    """Two clones of ``pred`` replay one ``bucket`` in two threads,
    ``CONCURRENT_RUNS`` distinct inputs each, while a third thread captures
    a new shape (``off_ladder`` rows) under that traffic: every concurrent
    answer must be bit-equal to its input's answer replayed alone, and the
    capture must neither fail nor spoil a replay. Returns the readings."""
    feeds = [[make_feed(bucket, 1000 * t + i) for i in range(CONCURRENT_RUNS)] for t in range(2)]
    solo = [[pred.run(f) for f in per] for per in feeds]
    got = [[None] * CONCURRENT_RUNS for _ in range(2)]
    errors, started = [], threading.Event()
    captured = {}
    misses0 = pred.store.misses

    def replay(t, clone):
        try:
            for i, f in enumerate(feeds[t]):
                got[t][i] = clone.run(f)
                if i == 1:
                    started.set()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def capture(clone):
        try:
            started.wait(60)
            captured["answer"] = clone.run(make_feed(off_ladder, 99))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=replay, args=(t, pred.clone())) for t in range(2)]
    threads.append(threading.Thread(target=capture, args=(pred.clone(),)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{label}: concurrent replays failed: {errors!r}")
    same = sum(all(np.array_equal(a, b) for a, b in zip(got[t][i], solo[t][i]))
               for t in range(2) for i in range(CONCURRENT_RUNS))
    again = pred.run(make_feed(off_ladder, 99))
    cap_diff = max(float(np.abs(a - b).max()) for a, b in zip(captured["answer"], again))
    r = {"bucket": bucket, "runs": 2 * CONCURRENT_RUNS, "bit_equal_to_solo": same,
         "captured_under_traffic": pred.store.misses - misses0, "off_ladder_rows": off_ladder,
         "capture_vs_its_replay": cap_diff}
    log(f"{label}: concurrent replays {r}")
    if same != 2 * CONCURRENT_RUNS or r["captured_under_traffic"] != 1 or \
            not all(np.isfinite(a).all() for a in captured["answer"]):
        raise AssertionError(f"{label}: concurrent replays part from solo ones: {r}")
    return r


def profile_forward(pred, seq_len):
    """Time of one BERT forward per bucket (inputs already on the card,
    CUDA events around 20 forwards of the module, eagerly), then
    ``Predictor.run`` captured against eager at every bucket
    (:func:`_captured_vs_eager`). Returns the latter's readings."""
    import torch

    rng = np.random.RandomState(5)
    for bucket in BUCKETS:
        ids = torch.from_numpy(rng.randint(1, 1000, (bucket, seq_len))).cuda()
        types = torch.zeros_like(ids)
        with torch.inference_mode():
            ms = time_ms(pred.module, [(ids, types)] * 3, 20)
        log(f"forward bucket {bucket} ({bucket * seq_len} tokens): {ms:.3f} ms, "
            f"{bucket * seq_len / ms * 1e3:.0f} tokens/s")
    feeds = {b: [rng.randint(1, 1000, (b, seq_len)).astype(np.int64),
                 np.zeros((b, seq_len), np.int64)] for b in BUCKETS}
    return _captured_vs_eager(pred, feeds, _eager_module_run(pred), "BERT-base")


def _eager_module_run(pred):
    """``pred.run``'s eager counterpart: the module op by op on the host
    feeds moved to the card, its outputs copied to the host."""
    import torch

    def run(feed):
        with torch.no_grad():
            outs = pred.module(*[torch.from_numpy(a).cuda() for a in feed])
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        return [o.cpu().numpy() for o in outs]

    return run


def _bert_feed(bucket, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 1000, (bucket, SEQ_LEN)).astype(np.int64),
            np.zeros((bucket, SEQ_LEN), np.int64)]


def serve_bert():
    """Phases 4-5. Returns (kernel launches per name on the serving run,
    readings)."""
    import torch

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.jit_api import InputSpec
    from paddle_tpu_torch.models import BertModel, bert_base_config

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    specs = [InputSpec([None, SEQ_LEN], "int64", "input_ids"),
             InputSpec([None, SEQ_LEN], "int64", "token_type_ids")]
    fetches = ["sequence_output", "pooled_output"]
    model = BertModel(cfg, generator=torch.Generator().manual_seed(0))
    cpu_pred = Predictor(copy.deepcopy(model), specs, fetches, device="cpu")
    pred = Predictor(model, specs, fetches)
    reqs = make_requests(cfg, np.random.RandomState(3))
    answers, counts, forwards, readings = _serve(pred, BUCKETS, reqs, "BERT-base")
    wants = []
    for i, (req, ans) in enumerate(zip(reqs, answers)):
        got = [np.asarray(ans[1]["outputs"][n], np.float32) for n in fetches]
        want = cpu_pred.run([req["input_ids"], req["token_type_ids"]])
        wants.append(want)
        for n, g_, w_, tol in zip(fetches, got, want, (SEQ_ATOL, POOLED_ATOL)):
            if g_.shape != w_.shape or not np.isfinite(g_).all():
                raise AssertionError(f"request {i} {n}: shape {g_.shape} vs {w_.shape} "
                                     "or not finite")
            e = float(np.abs(g_ - w_).max())
            if e > tol:
                raise AssertionError(f"request {i} {n}: max err {e} vs CPU > atol {tol}")
            log(f"request {i} ({req['input_ids'].shape[0]} rows) {n}: max err vs CPU {e:.3g} "
                f"(atol {tol})")
    # post-norm BERT: two residual LayerNorms and one attention per layer
    layers = cfg.num_hidden_layers
    want = {"layernorm_residual_fwd": 2 * layers * forwards,
            "flash_attention_fwd": layers * forwards}
    want = {name: want.get(name, 0) for name in counts}
    if forwards <= 0 or counts != want:
        raise AssertionError(f"launches {counts} over {forwards} forwards; want {want}")
    log(f"{forwards} forwards, launches {counts}: {2 * layers} LayerNorm + {layers} attention "
        "kernels each")
    tf32_control(pred, reqs, wants)
    readings["by_bucket"] = profile_forward(pred, SEQ_LEN)
    readings["concurrent"] = _concurrent_replays(pred, _bert_feed, 2, 3, "BERT-base")
    return counts, readings


def tf32_control(pred, reqs, wants):
    """The same requests through ``Predictor.run`` with TF32 matmuls on (the
    precision the predictor switches off), against the same CPU answers:
    the serving limits must catch that blur. The TF32 setting keys new
    graphs, so these runs capture anew and do not replay the f32 ones."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        errs = [0.0, 0.0]
        for req, want in zip(reqs, wants):
            got = pred.run([req["input_ids"], req["token_type_ids"]])
            errs = [max(e, float(np.abs(g_ - w_).max())) for e, g_, w_ in zip(errs, got, want)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    log(f"TF32 control: max err vs CPU sequence_output {errs[0]:.3g} (atol {SEQ_ATOL}), "
        f"pooled_output {errs[1]:.3g} (atol {POOLED_ATOL})")
    if not (errs[0] > SEQ_ATOL and errs[1] > POOLED_ATOL):
        raise AssertionError(f"TF32 control {errs} passes the serving limits "
                             f"{SEQ_ATOL}, {POOLED_ATOL}: they cannot catch it")


# Training limits against the port's plain path on the CPU (dropout 0,
# batch 2 x L=512): the loss, and for every parameter the largest gradient
# error relative to the largest gradient entry of its layer. Each sits
# about at the geometric mean of two readings on an H100: full f32 (loss
# equal to the last bit, < 1e-6; gradients 4.0e-6) and the same step with
# TF32 matmuls (1.24e-4; 2.96e-3), which train_parity requires them to catch.
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4


def pretraining_batch(cfg, batch, seq, n_pred, rng):
    """bench.py's synthetic phase-2 batch: token ids, segment ids, flat
    masked positions (n_pred a row), MLM labels and NSP labels."""
    ids = rng.randint(1, cfg.vocab_size, (batch, seq)).astype(np.int64)
    types = rng.randint(0, 2, (batch, seq)).astype(np.int64)
    pos = np.stack([rng.choice(seq, n_pred, replace=False) + i * seq
                    for i in range(batch)]).ravel().astype(np.int64)
    mlm = rng.randint(0, cfg.vocab_size, (batch * n_pred,)).astype(np.int64)
    nsp = rng.randint(0, 2, (batch, 1)).astype(np.int64)
    return [ids, types, pos, mlm, nsp]


def _pretraining(cfg, seed):
    import torch

    from paddle_tpu_torch.models import BertForPretraining, BertPretrainingCriterion

    model = BertForPretraining(cfg, generator=torch.Generator().manual_seed(seed))
    crit = BertPretrainingCriterion(cfg.vocab_size)

    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)

    return model, loss_fn


def _step_of(model, loss_fn, device=None, jit=False):
    """bench.py's BERT step: AdamW lr 1e-4. ``jit=False`` (the eager step)
    unless the caller asks for the compiled one."""
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW

    return train_step(model, AdamW(learning_rate=1e-4, parameters=model.parameters()), loss_fn,
                      device=device, jit=jit)


def _grad_errors(model, ref_model):
    """(worst gradient error, its parameter name): each parameter's largest
    error relative to the largest gradient entry of its layer (the module
    that owns it), since some gradients are zero up to rounding (the key
    projection's bias: softmax ignores a shift along a row). A parameter
    without a gradient on either side fails."""
    pairs = list(zip(model.named_parameters(), ref_model.named_parameters()))
    for (n, p), (_, pr) in pairs:
        if p.grad is None or pr.grad is None:
            raise AssertionError(f"{n}: no gradient ({'card' if p.grad is None else 'CPU'})")
    scale = {}
    for (n, _), (_, pr) in pairs:
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(pr.grad.abs().max()))
    worst, name = 0.0, None
    for (n, p), (_, pr) in pairs:
        e = float((p.grad.cpu() - pr.grad).abs().max()) / max(scale[n.rpartition(".")[0]],
                                                                1e-30)
        if e > worst:
            worst, name = e, n
    return worst, name


def train_parity():
    """One step at dropout 0, batch 2 x L=512, on the card and on the CPU
    (the plain path) from the same weights; then the same step with TF32
    matmuls on, which the limits must catch. Returns the readings."""
    import torch

    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    model, loss_fn = _pretraining(cfg, seed=0)
    cpu_model, tf32_model = copy.deepcopy(model), copy.deepcopy(model)
    batch = pretraining_batch(cfg, 2, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(8))
    t0 = time.perf_counter()
    cpu_loss = float(_step_of(cpu_model, loss_fn, device="cpu")(*batch)["loss"])
    log(f"parity step on the CPU (plain path): loss {cpu_loss:.6f}, "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    loss = float(_step_of(model, loss_fn)(*batch)["loss"])
    counts = launch_counts()
    layers = cfg.num_hidden_layers
    want = {"layernorm_residual_fwd": 2 * layers, "layernorm_residual_bwd": 2 * layers,
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}
    want = {name: want.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"parity step launched {counts}; want {want}")
    grad_err, worst = _grad_errors(model, cpu_model)
    loss_err = abs(loss - cpu_loss)
    step = _step_of(tf32_model, loss_fn)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_loss = float(step(*batch)["loss"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_grad, tf32_worst = _grad_errors(tf32_model, cpu_model)
    tf32_loss_err = abs(tf32_loss - cpu_loss)
    log(f"parity step on the card: loss {loss:.6f}, err vs CPU {loss_err:.3g} (atol "
        f"{TRAIN_LOSS_ATOL}); worst gradient err {grad_err:.3g} of its layer's largest entry, "
        f"at {worst} (rtol {TRAIN_GRAD_RTOL}); TF32 control: loss err {tf32_loss_err:.3g}, "
        f"worst gradient err {tf32_grad:.3g} at {tf32_worst}")
    if not (np.isfinite(loss) and loss_err <= TRAIN_LOSS_ATOL and grad_err <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"parity step: loss err {loss_err}, gradient err {grad_err} at "
                             f"{worst} beyond {TRAIN_LOSS_ATOL} / {TRAIN_GRAD_RTOL}")
    if not (tf32_loss_err > TRAIN_LOSS_ATOL and tf32_grad > TRAIN_GRAD_RTOL):
        raise AssertionError(f"TF32 control (loss {tf32_loss_err}, gradient {tf32_grad}) passes "
                             f"the training limits {TRAIN_LOSS_ATOL} / {TRAIN_GRAD_RTOL}")
    return {"loss_err": loss_err, "grad_rel_err": grad_err, "worst_param": worst,
            "tf32_loss_err": tf32_loss_err, "tf32_grad_rel_err": tf32_grad}


def _timed_steps(step, batch, steps):
    """One warm-up step (cuBLAS and cuDNN plans, the allocator's pool), then
    ``steps`` steps timed with CUDA events, the launch counts set to 0 just
    before them. Returns (losses, warm-up first; ms of each timed step;
    host-clock ms a step; launches over the timed steps; peak device memory
    in GiB over all of them)."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    losses = [step(*batch)["loss"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        losses.append(step(*batch)["loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = launch_counts()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    return ([float(x) for x in losses], step_ms, wall_ms, counts,
            torch.cuda.max_memory_allocated() / 2**30)


def _profile_step(step, batch, label):
    """One training step under ``torch.profiler``: wall time, the device's
    busy share, kernel time by kind and the top kernels. Returns the
    profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _tracer_warmup()
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, wall, label, top=10)
    return prof


def train_bert():
    """Phase 6. Returns kernel launches per name over the timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import bert_base_config

    train_parity()
    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    model, loss_fn = _pretraining(cfg, seed=1)
    step = _step_of(model, loss_fn)
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, TRAIN_STEPS)
    layers = cfg.num_hidden_layers
    want = {"layernorm_residual_fwd": 2 * layers, "layernorm_residual_bwd": 2 * layers,
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}
    want = {k: want.get(k, 0) * TRAIN_STEPS for k in counts}
    if counts != want:
        raise AssertionError(f"{TRAIN_STEPS} steps launched {counts}; want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    tokens = TRAIN_B * TRAIN_SEQ
    mean_ms = float(np.mean(step_ms))
    log(f"{TRAIN_STEPS} steps at batch {TRAIN_B} x L={TRAIN_SEQ}, {TRAIN_PRED} masked a row, "
        f"dropout {cfg.hidden_dropout_prob}: losses {', '.join(f'{x:.6f}' for x in losses)}")
    log(f"step {mean_ms:.2f} ms (median {float(np.median(step_ms)):.2f}, min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}; host clock {wall_ms:.2f}), {tokens / mean_ms * 1e3:.0f} "
        f"tokens/s; peak device memory "
        f"{peak:.1f} GiB; launches {counts}: "
        f"{2 * layers} + {2 * layers} LayerNorm, {layers} attention forward, {layers} dQ, "
        f"{layers} dK/dV a step")
    _profile_step(step, batch, "train step profiled")
    # the optimizer update alone: how much of the step's idle time is its
    model.train()
    step.optimizer.clear_grad()
    loss_fn(model, *batch).backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.optimizer.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind, events = _device_time_by_kind(prof)
    log(f"AdamW update alone: {wall:.3f} ms wall, device busy {sum(by_kind.values()):.3f} ms "
        f"in {events} device events")
    return counts


# -- AMP: bf16 kernels, the AMP step against the CPU, BERT trained under auto_cast --

BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores (H100 SXM data sheet)
# the bf16 attention kernels against their plain versions, in bf16 ulps of
# the largest output: both round P (or dS) to bf16 at the TPU kernels'
# points and sum in f32 in other orders (read 0.06-1 on the H100)
FLASH_BF16_ULPS = 2.0
# the residual LayerNorm's mixed case through the op (bf16 x, f32 residual;
# the mixed forward, the f32 backward) against the plain version: the output and dx in bf16
# ulps of their largest entry, the residual's f32 gradient relative to its
# largest entry
LN_MIXED_ULPS, LN_MIXED_RTOL = 1.0, 1e-5
_FLASH_SRC_BF16 = "paddle_tpu_torch/csrc/flash_attention_bf16.cu"
_FLASH_BWD_SRC_BF16 = "paddle_tpu_torch/csrc/flash_attention_bwd_bf16.cu"
_FA = "paddle_tpu/ops/pallas/flash_attention.py"


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of the largest |want|."""
    return float((got.float() - want.float()).abs().max() / bf16_ulp(want.float().abs().max()))


def check_flash_bf16(batch, seq, rate, causal, replaces, lk=None, d=FLASH_D, timed=True,
                     bias_kind="pad"):
    """The three bf16 attention kernels at [batch, 12, seq, d] (keys ``lk``,
    default ``seq``) with a bf16 pad bias (the mask in q's dtype, as under
    AMP; ``bias_kind`` "full" takes a random f32 [B, H, Lq, Lk] bias read per
    entry, "none" none), through the route autograd takes: the forward
    storing its dropout mask, the dQ kernel computing delta, the dK/dV kernel
    after it, both reading the stored mask. Against the plain versions with
    the same seed: the output and each gradient within ``FLASH_BF16_ULPS``
    bf16 ulps of the largest entry, lse within ``FLASH_ATOL``. Bit for bit:
    the stored mask against ``dropout_keep_mask`` (the entries the rows can
    see) and the backward against a second run of itself. Timed, all in
    device time behind a sleep kernel: each kernel as the route runs it,
    the whole backward, the plain forward and backward, and bf16 SDPA
    forward and backward (the same mask and dropout rate, its own dropout
    mask) as the library, its backward read three times (median and
    range). Returns the forward's, the dQ and the dK/dV entries."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    lk = seq if lk is None else lk
    g = torch.Generator(device="cuda").manual_seed(11)
    shape, kshape = (batch, FLASH_H, seq, d), (batch, FLASH_H, lk, d)
    scale = d ** -0.5

    def make():
        q, do = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(kshape, generator=g, device="cuda").bfloat16() for _ in range(2))
        bias = {"pad": lambda: _pad_bias(g, batch, lk).bfloat16(), "none": lambda: None,
                "full": lambda: torch.randn(batch, FLASH_H, seq, lk, generator=g,
                                            device="cuda")}[bias_kind]()
        seed = fa._draw_seed(g, "cuda") if rate else None
        return q, k, v, bias, do, seed

    def fwd(q, k, v, bias, do, seed):
        """(out, lse, the mask the forward stored or None)"""
        res = fa.flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
        return res if rate else (*res, None)

    sets = [make() for _ in range(3 if timed else 1)]
    q, k, v, bias, do, seed = sets[0]
    out, lse, keep = fwd(*sets[0])
    pout, plse = fa._plain_fwd(q, k, v, bias, causal, scale, rate, seed)
    grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, causal, scale, rate, keep)
    again = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, causal, scale, rate, keep)
    plain = fa._plain_bwd(q, k, v, bias, out, lse, do, causal, scale, rate, seed)
    torch.cuda.synchronize()
    dq, dk, dv = grads
    if not all(t.dtype == torch.bfloat16 for t in (out, dq, dk, dv)) or lse.dtype != torch.float32:
        raise AssertionError("bf16 attention: outputs not bf16 or lse not f32")
    label = (f"bf16 attention {list(shape)}{f' Lk {lk}' if lk != seq else ''} rate {rate}"
             f"{' causal' if causal else ''}{f' bias {bias_kind}' if bias_kind != 'pad' else ''}")
    bits = {"repeats": all(torch.equal(a, b_) for a, b_ in zip(grads, again))}
    if rate:
        want = fa.dropout_keep_mask(seed, batch, FLASH_H, seq, lk, rate)
        got = fa.unpack_keep(keep, batch, FLASH_H, seq, lk)
        if causal:  # the forward skips the key tiles a block's rows cannot see
            vis = torch.arange(seq, device="cuda")[:, None] + (lk - seq) >= \
                torch.arange(lk, device="cuda")[None, :]
            want, got = want & vis, got & vis
        bits["mask_entries_differing"] = int((want != got).sum())
    if not bits["repeats"] or bits.get("mask_entries_differing", 0):
        raise AssertionError(f"{label}: bit-for-bit checks failed: {bits}")
    pairs_ = {"out": (out, pout), "dq": (dq, plain[0]), "dk": (dk, plain[1]),
              "dv": (dv, plain[2])}
    errs = {n: bf16_ulps(a, b_) for n, (a, b_) in pairs_.items()}
    abs_errs = {n: float((a.float() - b_.float()).abs().max()) for n, (a, b_) in pairs_.items()}
    lse_err = float((lse - plse).abs().max())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, dq, dk, dv))
    tol = f"{FLASH_BF16_ULPS} bf16 ulps of the largest entry, lse atol {FLASH_ATOL}"
    if not finite or max(errs.values()) > FLASH_BF16_ULPS or lse_err > FLASH_ATOL:
        raise AssertionError(f"{label}: ulps {errs}, lse err {lse_err}, finite {finite}; "
                             f"beyond {tol}")
    pairs = sum(max(0, min(lk, i + lk - seq + 1)) for i in range(seq)) if causal else seq * lk
    bhld = batch * FLASH_H * pairs * d
    qb, kb = 2 * q.numel(), 2 * k.numel()  # bf16 bytes
    bias_b = {"pad": 2 * batch * lk, "none": 0, "full": 4 * batch * FLASH_H * seq * lk}[bias_kind]
    # what the function needs; the stored dropout mask is this design's own
    # traffic (the TPU kernels draw it again), reported beside the bound
    mask_b = 4 * keep.numel() if rate else 0
    stats = 8 * batch * FLASH_H * seq + bias_b  # lse, delta f32; the bias
    io = {"fwd": 2 * qb + 2 * kb + 4 * batch * FLASH_H * seq + bias_b,  # q k v out lse
          "dq": 4 * qb + 2 * kb + stats,  # q, dO, O (delta), dq; k, v
          "dkv": 2 * qb + 4 * kb + stats,
          "all": 4 * qb + 4 * kb + stats}
    ops = {"fwd": 4 * bhld, "dq": 6 * bhld, "dkv": 8 * bhld, "all": 10 * bhld}
    bounds = {n: bound(io[n], ops[n], BF16_FLOPS_PER_S) for n in io}
    common = {"route": "cuda", "shape": list(shape), "keys": lk, "dtype": "bfloat16",
              "dropout_rate": rate, "causal": causal, "bias": bias_kind, "tolerance": tol,
              "bit_for_bit": bits, "stored_mask_bytes": mask_b,
              "bound_note": "bf16 products / 989 TFLOP/s, the bytes the function needs / "
                            "3.35 TB/s (not the stored mask)"}
    entries = [dict(name="flash_attention_fwd_bf16", source=_FLASH_SRC_BF16, replaces=replaces[0],
                    max_abs_err=abs_errs["out"], max_err_ulps=errs["out"], lse_err=lse_err,
                    bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1], **common)]
    for name, key, rep in (("flash_attention_bwd_dq_bf16", ("dq",), replaces[1]),
                           ("flash_attention_bwd_dkv_bf16", ("dk", "dv"), replaces[2])):
        b_ = bounds["dq" if name.endswith("dq_bf16") else "dkv"]
        entries.append(dict(name=name, source=_FLASH_BWD_SRC_BF16, replaces=rep,
                            max_abs_err=max(abs_errs[k_] for k_ in key),
                            max_err_ulps=max(errs[k_] for k_ in key), bound_ms=b_[0],
                            bound_by=b_[1], **common))
    msg = (f"{label}: ulps {', '.join(f'{k_} {v_:.3f}' for k_, v_ in errs.items())}, lse err "
           f"{lse_err:.3g} ({tol}); bit for bit {bits}")
    if not timed:
        log(msg)
        return tuple(entries)

    outs = [fwd(*s_) for s_ in sets]
    deltas = [fa.flash_attention_bwd_dq_delta(q_, k_, v_, b_, lse_, o_, do_, causal, scale, rate,
                                              kp)[1]
              for (q_, k_, v_, b_, do_, _), (o_, lse_, kp) in zip(sets, outs)]
    bsets = [(q_, k_, v_, b_, lse_, o_, dl, do_, seed_, kp)
             for (q_, k_, v_, b_, do_, seed_), (o_, lse_, kp), dl in zip(sets, outs, deltas)]
    iters = 100 if seq <= 128 else 20

    def timer(fn, arg_sets, n=iters):  # device ms, the host's launch cost hidden
        return device_ms_sets(fn, arg_sets, n)[0]

    ms = {"fwd": timer(fwd, sets),
          "dq": timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                      fa.flash_attention_bwd_dq_delta(q_, k_, v_, b_, lse_, o_, do_, causal,
                                                      scale, rate, kp), bsets),
          "dkv": timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                       fa.flash_attention_bwd_dkv(q_, k_, v_, b_, lse_, dl, do_, causal, scale,
                                                  rate, kp), bsets),
          "all": timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                       fa.flash_attention_bwd(q_, k_, v_, b_, o_, lse_, do_, causal, scale, rate,
                                              kp), bsets)}
    plain_fwd = timer(lambda q, k, v, bias, do, seed: fa._plain_fwd(
        q, k, v, bias, causal, scale, rate, seed), sets, 5)
    plain_bwd = timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                      fa._plain_bwd(q_, k_, v_, b_, o_, lse_, do_, causal, scale, rate, sd),
                      bsets, 5)
    causal_mask = (torch.full((seq, lk), -1e30, device="cuda").triu(lk - seq + 1).bfloat16()
                   if causal else None)

    def sdpa_mask(b_):
        if b_ is not None:
            b_ = b_.to(torch.bfloat16)
        return b_ if causal_mask is None else (causal_mask if b_ is None else b_ + causal_mask)

    lib_fwd = timer(lambda q, k, v, bias, do, seed: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask(bias), dropout_p=rate), sets)
    graphs = []
    for q_, k_, v_, b_, do_, _seed in sets:
        ins = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        graphs.append((F.scaled_dot_product_attention(*ins, attn_mask=sdpa_mask(b_),
                                                      dropout_p=rate), ins, do_))
    lib_bwds = sorted(timer(lambda o, ins, do_: torch.autograd.grad(o, ins, do_,
                                                                    retain_graph=True), graphs)
                      for _ in range(3))
    lib_bwd = lib_bwds[1]
    log(f"{msg}; forward {ms['fwd']:.4f} ms (bound {bounds['fwd'][0]:.4f}, {bounds['fwd'][1]}), "
        f"dQ with delta {ms['dq']:.4f} (bound {bounds['dq'][0]:.4f}), dK/dV {ms['dkv']:.4f} "
        f"(bound {bounds['dkv'][0]:.4f}), whole backward {ms['all']:.4f} (bound "
        f"{bounds['all'][0]:.4f}); plain forward {plain_fwd:.4f}, backward "
        f"{plain_bwd:.4f}; library (bf16 SDPA, dropout_p {rate}, its own mask) forward "
        f"{lib_fwd:.4f}, backward {lib_bwd:.4f} (median of {', '.join(f'{t:.4f}' for t in lib_bwds)})"
        f" ms; device time behind a sleep kernel; stored mask {mask_b} bytes")
    total = {"ms": ms["all"], "plain_ms": plain_bwd, "library_ms": lib_bwd,
             "library_ms_readings": lib_bwds,
             "library": "bf16 scaled_dot_product_attention backward", "bound_ms": bounds["all"][0]}
    entries[0].update(ms=ms["fwd"], kernel_ms=ms["fwd"], plain_ms=plain_fwd, library_ms=lib_fwd,
                      library=f"bf16 scaled_dot_product_attention, dropout_p {rate}")
    for e, key in zip(entries[1:], ("dq", "dkv")):
        e.update(ms=ms[key], kernel_ms=ms[key], plain_ms=plain_bwd, library_ms=None,
                 backward_total=total)
    return tuple(entries)


def check_layernorm_mixed(rows=TRAIN_ROWS, h=LN_H):
    """The residual LayerNorm's mixed case, the first encoder layer's under
    AMP: a bf16 x (the attention output) on an f32 residual (the embedding
    output) through the op, whose forward is the mixed kernel (no cast
    pass: the f32 sum, f32 statistics, y rounded to bf16 once) and whose
    backward takes x and dy to f32 for the f32 backward kernel; the
    gradient of x comes back bf16, the residual's f32. Against the plain
    version of the same computation; the mixed forward and the f32
    backward launch once each and nothing else. Returns the mixed
    forward's kernel entry (timed by check_layernorm) with this reading."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    g = torch.Generator(device="cuda").manual_seed(12)
    w, b = (torch.randn(h, generator=g, device="cuda") for _ in range(2))
    x, r, dy = (torch.randn(rows, h, generator=g, device="cuda").to(dt)
                for dt in (torch.bfloat16, torch.float32, torch.bfloat16))
    xs, rs = x.detach().requires_grad_(), r.detach().requires_grad_()
    reset_launch_counts()
    y = lnr.layernorm_residual(xs, rs, w, b)
    y.backward(dy)
    counts = {k: v for k, v in launch_counts().items() if v}
    want_counts = {"layernorm_residual_fwd_mixed": 1, "layernorm_residual_bwd": 1}
    py, mean, rstd = lnr._reference(x.float(), r, w, b, 1e-5)
    pa, _, _ = lnr._reference_bwd(x.float(), r, w, mean, rstd, dy.float())
    torch.cuda.synchronize()
    errs = {"y_ulps": bf16_ulps(y, py.bfloat16()), "dx_ulps": bf16_ulps(xs.grad, pa.bfloat16()),
            "dres_rel": float((rs.grad - pa).abs().max() / pa.abs().max())}
    dtypes = (y.dtype, xs.grad.dtype, rs.grad.dtype)
    tol = (f"y and dx {LN_MIXED_ULPS} bf16 ulp of the largest entry, the residual's gradient "
           f"rtol {LN_MIXED_RTOL}")
    if (dtypes != (torch.bfloat16, torch.bfloat16, torch.float32) or counts != want_counts
            or errs["y_ulps"] > LN_MIXED_ULPS or errs["dx_ulps"] > LN_MIXED_ULPS
            or errs["dres_rel"] > LN_MIXED_RTOL):
        raise AssertionError(f"mixed LayerNorm: {errs}, dtypes {dtypes}, launches {counts} "
                             f"(want {want_counts}); beyond {tol}")

    log(f"mixed LayerNorm [{rows}, {h}] bf16 x + f32 residual through the op, forward and "
        f"backward: {errs} ({tol}); launches {counts}")
    entry = check_layernorm("bfloat16", rows, h, res_dtype_name="float32")
    entry["through_the_op"] = {**errs, "tolerance": tol, "launches": counts}
    return entry


def check_amp_kernels():
    """Entries for the bf16 kernels of the AMP path: the LayerNorm forward
    in bf16 and in its mixed instance and the backward in bf16 at the
    training path's [16384, 768] (the block variant at H = 1000 and 4096 and
    rows of mean 100 under ``also_checked``), and the three
    bf16 attention kernels at [32, 12, 512, 64] with dropout 0.1 and a pad
    bias (also at rate 0 and at the short L = 128, causal, where the TPU
    took its small variants; at D = 32 and 128 and at ragged causal shapes
    untimed)."""
    ln = check_layernorm("bfloat16", TRAIN_ROWS)
    ln_mixed = check_layernorm_mixed()
    # the block variant (H = 1000 off the 16-byte width, H = 4096 past a
    # warp's registers) and rows with a large mean, untimed
    ln["also_checked"] = [check_layernorm("bfloat16", LN_ROWS, h, timed=False)
                          for h in (1000, 4096)] + [
        check_layernorm("bfloat16", LN_ROWS, mean_offset=100.0, std=0.1, timed=False)]
    ln_mixed["also_checked"] = [
        check_layernorm("bfloat16", LN_ROWS, h, res_dtype_name="float32", timed=False)
        for h in (1000, 4096)] + [check_layernorm("bfloat16", LN_ROWS, res_dtype_name="float32",
                                                  mean_offset=100.0, std=0.1, timed=False)]
    ln_bwd = check_layernorm_bwd("bfloat16")
    rows = (f"{_FA}:548", f"{_FA}:765", f"{_FA}:815")
    small = (f"{_FA}:370", f"{_FA}:433", f"{_FA}:433")
    fwd, dq, dkv = check_flash_bf16(TRAIN_B, TRAIN_SEQ, ATTN_DROPOUT, False, rows)
    for extra in (check_flash_bf16(TRAIN_B, TRAIN_SEQ, 0.0, False, rows),
                  check_flash_bf16(FLASH_B, 128, ATTN_DROPOUT, True, small),
                  check_flash_bf16(4, 256, ATTN_DROPOUT, True, rows, d=32, timed=False),
                  check_flash_bf16(4, 256, ATTN_DROPOUT, False, rows, d=128, timed=False),
                  check_flash_bf16(2, 300, ATTN_DROPOUT, True, rows, lk=257, timed=False),
                  check_flash_bf16(2, 257, 0.0, True, rows, lk=300, d=32, timed=False),
                  check_flash_bf16(2, 300, ATTN_DROPOUT, True, rows, lk=257, timed=False,
                                   bias_kind="full"),
                  check_flash_bf16(2, 257, ATTN_DROPOUT, False, rows, lk=300, d=128,
                                   timed=False, bias_kind="none")):
        for entry, e in zip((fwd, dq, dkv), extra):
            entry.setdefault("also_checked", []).append(e)
    return [ln, ln_mixed, ln_bwd, fwd, dq, dkv]


# The AMP step against the port's plain path on the CPU under the same
# auto_cast (BERT-base, dropout 0, batch 2 x L=512, the same weights, the
# attention through its kernels' plain versions). In bf16 the two devices
# part the way any two bf16 runs do: a product's output rounds to the
# other side of a bf16 step where the f32 sums differ in their last bits
# (0.04-0.17% of entries), and 12 layers carry that to the noise of bf16
# itself, as far as the f32 step is from either (read on the H100: loss
# 2.1e-3, gradient rel L2 0.021; the f32 step 1.5e-3, 0.022). So the loss
# and the gradient's relative L2 are held to about 2.5 times the bf16
# reading, which catches a wrong kernel or a dropped gradient, not a
# missing cast. What the f32 step cannot match is bf16 values: the share of
# gradient entries that differ from the CPU's in any bit (read 0.830; the
# f32 step 1.000, never a bf16 value) is held at about the geometric mean
# of the two, and amp_train_parity requires the f32 step to fail it.
AMP_LIMITS = {"O1": {"loss": 5e-3, "grad_rel_l2": 0.05},
              "O2": {"loss": 1e-2, "grad_rel_l2": 0.15}}
AMP_GRAD_DIFFERING = 0.91


def _amp_loss_fn(loss_fn, level):
    from paddle_tpu_torch import amp

    def amp_loss(m, *batch):
        with amp.auto_cast(level=level):
            return loss_fn(m, *batch)
    return amp_loss


def _grad_l2(model, ref_model):
    """Against ``ref_model``'s gradients: the relative L2 error of the whole
    gradient (every parameter), the share of its entries (those not 0 on
    both sides) that differ in any bit, and the worst entry relative to the largest gradient entry of its
    layer with the parameter's name (reported: bf16 rounds a layer's
    largest entries by up to 2**-9)."""
    num = den = 0.0
    differ = total = 0
    scale, worst = {}, (0.0, "")
    pairs = list(zip(model.named_parameters(), ref_model.named_parameters()))
    for (n, p), (_, pr) in pairs:
        if p.grad is None or pr.grad is None:
            raise AssertionError(f"{n}: no gradient ({'card' if p.grad is None else 'CPU'})")
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(pr.grad.float().abs().max()))
    for (n, p), (_, pr) in pairs:
        d = p.grad.cpu().double() - pr.grad.double()
        num += float(d.square().sum())
        den += float(pr.grad.double().square().sum())
        live = (p.grad.cpu() != 0) | (pr.grad != 0)  # both 0 (a row no token used) says nothing
        differ += int((d != 0).sum())
        total += int(live.sum())
        e = float(d.abs().max()) / max(scale[n.rpartition(".")[0]], 1e-30)
        worst = max(worst, (e, n))
    return (num / den) ** 0.5, differ / total, worst


@contextlib.contextmanager
def _cpu_kernel_route():
    """CPU tensors take the attention kernels' route with each kernel
    replaced by its plain version (``_plain_fwd``, ``_plain_bwd``): the
    card's arithmetic on the CPU. The CPU's own route differentiates
    ``_plain_attention``, which rounds the normalized weights as the JAX
    package's plain path does, where the kernels round the probabilities
    before normalizing (``_fwd_core``) and dS before its products; in bf16
    that alone moves a BERT-base step as far as leaving out the cast."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    names = ("_use_kernel", "flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dq_delta", "flash_attention_bwd_dkv")
    saved = {n: getattr(fa, n) for n in names}

    def fwd(q, k, v, b, causal, scale, rate, seed):
        res = fa._plain_fwd(q, k, v, b, causal, scale, rate, seed)
        # bf16 with dropout hands its backward a mask: here the seed, which
        # the plain backward draws the same mask from
        return (*res, seed) if q.dtype == torch.bfloat16 and rate else res

    def dq(q, k, v, b, lse, delta, do, causal, scale, rate, seed):
        return fa._plain_bwd(q, k, v, b, None, lse, do, causal, scale, rate, seed)[0]

    def dq_delta(q, k, v, b, lse, out, do, causal, scale, rate, seed):
        delta = (do.float() * out.float()).sum(-1).reshape(-1, q.shape[2])
        return fa._plain_bwd(q, k, v, b, out, lse, do, causal, scale, rate, seed)[0], delta

    def dkv(q, k, v, b, lse, delta, do, causal, scale, rate, seed):
        return fa._plain_bwd(q, k, v, b, None, lse, do, causal, scale, rate, seed)[1:]

    for n, fn in zip(names, (lambda q: True, fwd, dq, dq_delta, dkv)):
        setattr(fa, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(fa, n, fn)


def _amp_launches(level, layers, steps=1):
    """Launches of one AMP step of BERT: the bf16 attention kernels; at O1
    layer 0's first residual LayerNorm is the mixed case (the mixed forward
    and the f32 backward), every other the bf16 kernels; at O2 all are
    bf16."""
    f32_ln = 1 if level == "O1" else 0
    want = {"flash_attention_fwd_bf16": layers, "flash_attention_bwd_dq_bf16": layers,
            "flash_attention_bwd_dkv_bf16": layers,
            "layernorm_residual_fwd_mixed": f32_ln, "layernorm_residual_bwd": f32_ln,
            "layernorm_residual_fwd_bf16": 2 * layers - f32_ln,
            "layernorm_residual_bwd_bf16": 2 * layers - f32_ln}
    return {k: v * steps for k, v in want.items() if v}


def amp_train_parity():
    """One BERT-base step at dropout 0, batch 2 x L=512, under
    ``auto_cast`` (O1), on the card and on the CPU's plain path from the
    same weights, the attention through its kernels' plain versions
    (``_cpu_kernel_route``); the f32 step on the card as the control the
    limits must catch; then one O2 step (``decorate``), held the same way
    against its own CPU step. Returns the readings."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    model, loss_fn = _pretraining(cfg, seed=0)
    batch = pretraining_batch(cfg, 2, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(8))
    control = copy.deepcopy(model)
    control_loss = float(_step_of(control, loss_fn)(*batch)["loss"])
    readings, layers = {}, cfg.num_hidden_layers
    for level in ("O1", "O2"):
        card = copy.deepcopy(model)
        if level == "O2":
            amp.decorate(card, level="O2")
        cpu = copy.deepcopy(card)
        amp_loss = _amp_loss_fn(loss_fn, level)
        t0 = time.perf_counter()
        with _cpu_kernel_route():
            cpu_loss = float(_step_of(cpu, amp_loss, device="cpu")(*batch)["loss"])
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        loss = float(_step_of(card, amp_loss)(*batch)["loss"])
        counts = {k: v for k, v in launch_counts().items() if v}
        want = _amp_launches(level, layers)
        if counts != want:
            raise AssertionError(f"AMP {level} parity step launched {counts}; want {want}")
        l2, differ, worst = _grad_l2(card, cpu)
        c_l2, c_differ, c_worst = _grad_l2(control, cpu)
        lim = AMP_LIMITS[level]
        r = {"loss": loss, "cpu_loss": cpu_loss, "loss_err": abs(loss - cpu_loss),
             "grad_rel_l2": l2, "grad_differing": differ, "worst_entry": worst,
             "control_loss_err": abs(control_loss - cpu_loss), "control_grad_rel_l2": c_l2,
             "control_grad_differing": c_differ, "control_worst_entry": c_worst,
             "cpu_step_s": cpu_s, "limits": dict(lim, grad_differing=AMP_GRAD_DIFFERING)}
        readings[level] = r
        log(f"AMP {level} parity step: card loss {loss:.6f}, CPU (plain path, {cpu_s:.1f} s) "
            f"{cpu_loss:.6f}: loss err {r['loss_err']:.3g} (atol {lim['loss']}), gradient rel "
            f"L2 {l2:.3g} (limit {lim['grad_rel_l2']}), entries differing {differ:.4f} (limit "
            f"{AMP_GRAD_DIFFERING}), worst entry {worst[0]:.3g} of its layer's largest at "
            f"{worst[1]}; f32 control on the card: loss err {r['control_loss_err']:.3g}, "
            f"gradient rel L2 {c_l2:.3g}, entries differing {c_differ:.4f}, worst entry "
            f"{c_worst[0]:.3g} at {c_worst[1]}; launches {counts}")
        del card, cpu
    for level, r in readings.items():  # every reading is logged before any limit fails
        lim = AMP_LIMITS[level]
        if not (np.isfinite(r["loss"]) and r["loss_err"] <= lim["loss"]
                and r["grad_rel_l2"] <= lim["grad_rel_l2"]
                and r["grad_differing"] <= AMP_GRAD_DIFFERING):
            raise AssertionError(f"AMP {level} parity step beyond its limits: {r}")
        if not r["control_grad_differing"] > AMP_GRAD_DIFFERING:
            raise AssertionError(f"AMP {level}: the f32 control passes the limit on differing "
                                 f"entries {AMP_GRAD_DIFFERING}: {r}")
    return readings


def _gemm_kernels(prof):
    """Matrix-product kernels of a profile: {name: (ms, calls)}."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and _kernel_kind(e.key) == "matmul":
            t = getattr(e, "device_time_total", None)
            out[e.key] = ((e.cuda_time_total if t is None else t) / 1e3, e.count)
    return out


def _gemm_dtype(name):
    """The operand type a cuBLAS/CUTLASS kernel's name carries: "bf16",
    "f32" (full f32 or TF32), or "unknown"."""
    n = name.lower()
    if "bf16" in n or n.startswith("nvjet_tst") or "bfloat16" in n:
        return "bf16"
    if any(s in n for s in ("f32f32_f32f32", "sgemm", "tf32", "nvjet_sss", "_s1688", "<float")):
        return "f32"
    return "unknown"


def train_bert_amp():
    """bench.py's phase-2 BERT step under ``auto_cast`` (O1): batch 32 x
    L=512, 80 masked a row, dropout 0.1, AdamW, one fixed batch; 10 timed
    steps whose losses must be finite and fall, each launching the three
    bf16 attention kernels once a layer and the residual LayerNorms (layer
    0's first the mixed case, the mixed forward and the f32 backward, the
    rest bf16); the
    median step, tokens/s and peak memory; one profiled step by kernel
    kind, whose matrix products must all be bf16 (JAX's dtype trace keeps
    no product in f32 under O1). Returns the launches over the timed steps."""
    import torch

    from paddle_tpu_torch.models import bert_base_config

    readings = amp_train_parity()
    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    model, loss_fn = _pretraining(cfg, seed=1)
    step = _step_of(model, _amp_loss_fn(loss_fn, "O1"))
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, TRAIN_STEPS)
    layers = cfg.num_hidden_layers
    want = _amp_launches("O1", layers, TRAIN_STEPS)
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"AMP: {TRAIN_STEPS} steps launched {counts}; want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"AMP losses not finite or not falling: {losses}")
    tokens = TRAIN_B * TRAIN_SEQ
    median = float(np.median(step_ms))
    log(f"AMP (O1, bf16) {TRAIN_STEPS} steps at batch {TRAIN_B} x L={TRAIN_SEQ}: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}")
    log(f"AMP step {float(np.mean(step_ms)):.2f} ms (median {median:.2f}, min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}; host clock {wall_ms:.2f}), {tokens / median * 1e3:.0f} tokens/s "
        f"at the median; peak device memory {peak:.1f} GiB; launches a step "
        f"{ {k: v // TRAIN_STEPS for k, v in counts.items() if v} }")
    prof = _profile_step(step, batch, "AMP train step profiled")
    gemms = _gemm_kernels(prof)
    by_dtype = {}
    for name, (ms, _calls) in gemms.items():
        by_dtype[_gemm_dtype(name)] = by_dtype.get(_gemm_dtype(name), 0.0) + ms
    log("AMP train step, matrix-product kernels (name, ms, calls, operand type): "
        + "; ".join(f"{n[:90]} {ms:.3f} {c} {_gemm_dtype(n)}" for n, (ms, c) in
                    sorted(gemms.items(), key=lambda kv: -kv[1][0])))
    log(f"AMP train step, matrix-product time by operand type (ms): {by_dtype}")
    if not by_dtype.get("bf16") or set(by_dtype) != {"bf16"}:
        raise AssertionError(f"AMP step's matrix products not all bf16: {by_dtype}")
    by_kind, events = _device_time_by_kind(prof)  # logged by _profile_step
    busy = sum(by_kind.values())
    return counts, {"parity": readings, "step_ms_median": median,
                    "tokens_per_s": tokens / median * 1e3, "peak_gib": peak,
                    "gemm_ms_by_dtype": by_dtype, "losses": losses, "busy_ms": busy,
                    "device_ms_by_kind": by_kind, "device_events": events}


# -- the ResNet path -----------------------------------------------------------

# ResNet-50 at bench.py's training shape (bench_resnet50: batch 128 of
# 224 x 224 images, 1000 classes, Momentum lr 0.1, momentum 0.9)
RN_B, RN_HW, RN_CLASSES, RN_STEPS = 128, 224, 1000, 10
RN_LR, RN_MOMENTUM = 0.1, 0.9
RN_BUCKETS = (1, 8, 32)
RN_TRIPLES = 33  # fused conv + bn + relu: the stem, conv1/bn1 and conv2/bn2 of 16 blocks
RN_PARAMS = 161
# layer1's 3x3 conv at batch 128: the counted entry of the six conv kernels
CONV_M, CONV_K, CONV_N = RN_B * 56 * 56, 64 * 9, 64
# products of K float32 terms, relative to the largest output: room for the
# kernels' 3xTF32 products (about 21 bits of each operand, summed in another
# order than cuBLAS's) against the plain f32 product; one TF32 pass (11 bits)
# lands past it, which check_conv_mm's control requires
CONV_MM_RTOL = 2e-5
# channel sums of M float32 terms in another order: relative to the
# channel's sum of |terms|
CONV_SUM_RTOL = 1e-5
_CONV_SRC = "paddle_tpu_torch/csrc/conv_bn_relu_mm.cu"
_BN_SRC = "paddle_tpu_torch/csrc/conv_bn_relu_bn.cu"
_CBR = "paddle_tpu/ops/pallas/conv_bn_relu.py"


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _sum_rel(got, want, terms):
    """max over channels of |got - want| over the channel's sum of |terms|."""
    return float(((got - want).abs() / terms.abs().sum(0).clamp_min(1e-30)).max())


def _conv_sets(g, m, k, n, count):
    """``count`` sets of (p2, w2, scale, shift) for a conv lowered to
    [m, k] @ [k, n]; weights at Kaiming scale, BN vectors as training
    makes them."""
    import torch

    out = []
    for _ in range(count):
        p2 = torch.randn(m, k, generator=g, device="cuda")
        w2 = torch.randn(k, n, generator=g, device="cuda") * (2.0 / k) ** 0.5
        scale = torch.rand(n, generator=g, device="cuda") + 0.5
        shift = torch.randn(n, generator=g, device="cuda") * 0.5
        out.append((p2, w2, scale, shift))
    return out


def _conv_bounds(m, k, n, out_vectors):
    """(3xTF32 bound ms, by what, FP32 bound ms) of one conv product with
    ``out_vectors`` [N] vectors besides p2, w2 and the [M, N] output."""
    flops = 2 * m * k * n
    moved = 4 * (m * k + k * n + m * n + out_vectors * n)
    t, by = bound(moved, flops, peak=TF32_FLOPS_PER_S / 3)
    return t, by, bound(moved, flops)[0]


def check_conv_mm(m, k, n, label, timed=True, tf32_control=False):
    """Rows 8 and 9 (``conv_bn_relu_mm.cu``) at [m, k] @ [k, n] against the
    plain versions on the same inputs: the eval affine + relu output, and
    the training ``co`` with its channel sums, which must repeat bit for
    bit. With ``tf32_control``, ``torch.matmul`` in one TF32 pass on the
    same inputs must land past ``CONV_MM_RTOL``."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(21)
    sets = _conv_sets(g, m, k, n, 2 if timed else 1)
    p2, w2, scale, shift = sets[0]
    y = cbr.mm_affine_relu(p2, w2, scale, shift)
    y_ref = cbr._mm_affine_relu_plain(p2, w2, scale, shift)
    co, part = cbr.mm_stats(p2, w2)
    co2, part2 = cbr.mm_stats(p2, w2)
    co_ref, part_ref = cbr._mm_stats_plain(p2, w2)
    torch.cuda.synchronize()
    err8 = _rel(y, y_ref)
    err9 = _rel(co, co_ref)
    sum_err = _sum_rel(part.sum(0), part_ref.sum(0), co_ref)
    tol8 = f"rtol {CONV_MM_RTOL} of the largest output"
    tol9 = f"co {tol8}; channel sums {CONV_SUM_RTOL} of the channel's sum of |co|"
    if err8 > CONV_MM_RTOL or err9 > CONV_MM_RTOL or sum_err > CONV_SUM_RTOL:
        raise AssertionError(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err "
                             f"{err8}, co err {err9}, sums err {sum_err} beyond {tol9}")
    if not (torch.equal(co, co2) and torch.equal(part, part2)):
        raise AssertionError(f"conv matmul {label}: a second mm_stats run differs")
    b8, by8, f8 = _conv_bounds(m, k, n, 2)
    b9, by9, f9 = _conv_bounds(m, k, n, 0)
    e8 = {"name": "conv_bn_relu_mm_affine_relu", "route": "cuda", "source": _CONV_SRC,
          "replaces": f"{_CBR}:306", "shape": [m, k, n], "label": label, "dtype": "float32",
          "max_abs_err": float((y - y_ref).abs().max()), "rel_err": err8, "tolerance": tol8,
          "bound_ms": b8, "bound_by": by8, "bound_fp32_ms": f8,
          "splits": cbr._split_k(m, k, n)[0]}
    e9 = {"name": "conv_bn_relu_mm_stats", "route": "cuda", "source": _CONV_SRC,
          "replaces": f"{_CBR}:337", "shape": [m, k, n], "label": label, "dtype": "float32",
          "max_abs_err": float((co - co_ref).abs().max()), "rel_err": err9,
          "sums_rel_err": sum_err, "tolerance": tol9, "bound_ms": b9, "bound_by": by9,
          "bound_fp32_ms": f9, "repeats_bit_for_bit": True}
    if tf32_control:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = _rel(torch.matmul(p2, w2), co_ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        log(f"conv matmul {label}: TF32 control (torch.matmul, one TF32 pass) err {tf32:.3g} "
            f"(limit {CONV_MM_RTOL}; the kernel read {err9:.3g})")
        if not tf32 > CONV_MM_RTOL:
            raise AssertionError(f"conv matmul TF32 control {tf32} passes {CONV_MM_RTOL}: the "
                                 "limit cannot tell 3xTF32 from TF32")
        e8["tf32_control_rel_err"] = e9["tf32_control_rel_err"] = tf32
    if timed:
        iters = max(5, min(50, int(1.5e11 / (m * k * n))))
        e8["ms"] = e8["kernel_ms"] = time_ms(cbr.mm_affine_relu, sets, iters)
        e8["plain_ms"] = time_ms(cbr._mm_affine_relu_plain, sets, iters)
        e9["ms"] = e9["kernel_ms"] = time_ms(lambda p, w, s_, b_: cbr.mm_stats(p, w), sets, iters)
        e9["plain_ms"] = time_ms(lambda p, w, s_, b_: cbr._mm_stats_plain(p, w), sets, iters)
        lib = time_ms(lambda p, w, s_, b_: torch.matmul(p, w), sets, iters)
        e8["library_ms"] = e9["library_ms"] = lib
        e8["library"] = e9["library"] = "torch.matmul(p2, w2), f32, TF32 off (the product alone)"
        log(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err {err8:.3g}, co err "
            f"{err9:.3g}, sums {sum_err:.3g} ({tol9}); affine+relu {e8['ms']:.4f} ms (bound "
            f"{b8:.4f} {by8} in 3xTF32, FP32 {f8:.4f}), stats {e9['ms']:.4f} ms (bound "
            f"{b9:.4f}), plain {e8['plain_ms']:.4f} / {e9['plain_ms']:.4f} ms, torch.matmul "
            f"{lib:.4f} ms")
    else:
        log(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err {err8:.3g}, co err "
            f"{err9:.3g}, sums {sum_err:.3g} ({tol9})")
    return e8, e9


def _rn50_fused_products(batch, hw=RN_HW):
    """(M, K, N) of ResNet-50's 33 fused conv + bn + relu products at
    ``batch`` images of ``hw`` x ``hw``: the stem, then each bottleneck's
    conv1 (1x1) and conv2 (3x3, stride 2 in the first block of layers 2-4)."""
    hw //= 2
    out = [(batch * hw * hw, 3 * 7 * 7, 64)]
    hw //= 2  # the stem's max pool
    cin = 64
    for width, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(blocks):
            out.append((batch * hw * hw, cin, width))
            hw //= stride if i == 0 else 1
            out.append((batch * hw * hw, 9 * width, width))
            cin = 4 * width
    return out


def check_conv_serving(batch, per_product=True):
    """Row 8b: the 33 fused eval products of a ResNet-50 forward at serving
    batch ``batch``, each against its plain version, the split-K calls
    counted against the planner's; then the device time of the 33 kernel
    calls in a row against 33 ``torch.matmul`` calls (the L2 cannot hold
    the weights of all 33), and with ``per_product`` each product's."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(23)
    shapes = _rn50_fused_products(batch)
    if len(shapes) != RN_TRIPLES:
        raise AssertionError(f"{len(shapes)} fused products, not {RN_TRIPLES}")
    sets = [_conv_sets(g, m, k, n, 1)[0] for m, k, n in shapes]
    splits0 = cbr.MM_AFFINE_RELU_SPLITS
    worst, worst_abs = 0.0, 0.0
    for (m, k, n), args in zip(shapes, sets):
        y, y_ref = cbr.mm_affine_relu(*args), cbr._mm_affine_relu_plain(*args)
        err = _rel(y, y_ref)
        if err > CONV_MM_RTOL:
            raise AssertionError(f"conv product [{m}, {k}] @ [{k}, {n}] at batch {batch}: err "
                                 f"{err} beyond {CONV_MM_RTOL}")
        worst, worst_abs = max(worst, err), max(worst_abs, float((y - y_ref).abs().max()))
    splits = cbr.MM_AFFINE_RELU_SPLITS - splits0
    want = sum(cbr._split_k(*s)[0] > 1 for s in shapes)
    if splits != want:
        raise AssertionError(f"{splits} of the {len(shapes)} products took split-K; the planner "
                             f"splits {want}")
    per = []
    if per_product:
        for (m, k, n), (p2, w2, sc, sh) in zip(shapes, sets):
            kms = device_ms(lambda: cbr.mm_affine_relu(p2, w2, sc, sh), 20)[0]
            lms = device_ms(lambda: torch.matmul(p2, w2), 20)[0]
            per.append((m, k, n, cbr._split_k(m, k, n)[0], kms, lms))
    ms = device_ms(lambda: [cbr.mm_affine_relu(*a) for a in sets], 10)[0]
    plain = device_ms(lambda: [cbr._mm_affine_relu_plain(*a) for a in sets], 10)[0]
    lib = device_ms(lambda: [torch.matmul(a[0], a[1]) for a in sets], 10)[0]
    bounds = [_conv_bounds(m, k, n, 2) for m, k, n in shapes]
    b, f = sum(x[0] for x in bounds), sum(x[2] for x in bounds)
    by = max(("bytes", "operations"), key=lambda w: sum(x[0] for x in bounds if x[1] == w))
    for m, k, n, s, kms, lms in per:
        log(f"  bucket {batch} product [{m}, {k}] @ [{k}, {n}], {s} slice(s): kernel {kms:.4f} "
            f"ms, torch.matmul {lms:.4f} ms")
    log(f"ResNet-50 bucket {batch}, {len(shapes)} fused products: err {worst:.3g} (limit "
        f"{CONV_MM_RTOL}), {splits} took split-K; device time in a row {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound {b:.4f} ms (3xTF32; FP32 {f:.4f})")
    entry = {"name": "conv_bn_relu_mm_affine_relu", "route": "cuda", "source": _CONV_SRC,
             "replaces": f"{_CBR}:306", "label": f"ResNet-50 serving batch {batch}: the "
             f"{len(shapes)} fused products in a row, device time", "shape": shapes,
             "dtype": "float32", "max_abs_err": worst_abs, "rel_err": worst,
             "tolerance": f"rtol {CONV_MM_RTOL} of each product's largest output",
             "splits": splits, "ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
             "library": "torch.matmul(p2, w2) for each product, f32, TF32 off",
             "bound_ms": b, "bound_by": by, "bound_fp32_ms": f}
    if per:
        entry["per_product"] = [dict(zip(("m", "k", "n", "slices", "ms", "library_ms"), r))
                                for r in per]
    return entry


def check_bn_passes(m, n, label, timed=True, mean_offset=1.0, std=1.0, dtype="float32"):
    """Rows 10-13 (``conv_bn_relu_bn.cu``) over a [m, n] conv output against
    the plain versions: the centred sum of squares, normalize + relu and
    the two backward passes (the relu gate recomputed from co: the
    elementwise passes round as the plain version does, so they must equal
    it bit for bit). ``dtype`` is co's and dy's (and y's); the vectors, the
    sums and d_co are float32 in both."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(22)
    dt = getattr(torch, dtype)
    es = dt.itemsize  # bytes of an element of co, dy and y
    sfx, tag = ("_bf16", "bf16 ") if dt == torch.bfloat16 else ("", "")

    def make():
        co = (torch.randn(m, n, generator=g, device="cuda") * std
              + torch.randn(n, generator=g, device="cuda") * mean_offset).to(dt)
        dy = torch.randn(m, n, generator=g, device="cuda").to(dt)
        mean = co.float().mean(0)
        rstd = torch.rsqrt(co.float().var(0, unbiased=False) + 1e-5)
        gamma = torch.rand(n, generator=g, device="cuda") + 0.5
        beta = torch.randn(n, generator=g, device="cuda") * 0.1
        scale = gamma * rstd
        shift = beta - mean * scale
        k3 = torch.randn(n, generator=g, device="cuda") * 1e-3
        b0 = torch.randn(n, generator=g, device="cuda") * 1e-3
        return co, dy, mean, scale, shift, k3, b0

    sets = [make() for _ in range(2 if timed else 1)]
    co, dy, mean, scale, shift, k3, b0 = sets[0]
    ss = cbr.centered_sumsq(co, mean).sum(0)
    ss_ref = cbr._centered_sumsq_plain(co, mean).sum(0)
    ss64 = (co.double() - co.double().mean(0)).square().sum(0)
    y = cbr.bn_relu(co, scale, shift)
    y_ref = cbr._bn_relu_plain(co, scale, shift)
    pdy, pdyc = cbr.bn_bwd_partials(co, dy, scale, shift)
    rdy, rdyc = cbr._bn_bwd_partials_plain(co, dy, scale, shift)
    dco = cbr.bn_bwd_dco(co, dy, scale, shift, k3, b0)
    dco_ref = cbr._bn_bwd_dco_plain(co, dy, scale, shift, k3, b0)
    torch.cuda.synchronize()
    if y.dtype != dt or dco.dtype != torch.float32 or ss.dtype != torch.float32:
        raise AssertionError(f"{tag}batch-norm passes {label}: dtypes y {y.dtype}, dco "
                             f"{dco.dtype}, sums {ss.dtype}")
    # a channel whose values all round to one bf16 value sums to 0 in all
    # three: the relative error is then 0, not 0 / 0
    err10 = float(((ss - ss_ref).abs() / ss_ref.abs().clamp_min(1e-30)).max())
    err10_64 = float(((ss.double() - ss64).abs() / ss64.clamp_min(1e-30)).max())
    gated = cbr._gated(co, dy, scale, shift).float()
    err12 = max(_sum_rel(pdy.sum(0), rdy.sum(0), gated),
                _sum_rel(pdyc.sum(0), rdyc.sum(0), gated * co.float()))
    err11 = float((y.float() - y_ref.float()).abs().max())
    err13 = float((dco - dco_ref).abs().max())
    tol10 = (f"rtol {CONV_SUM_RTOL} of the plain version's sum (and of a float64 centred sum: "
             f"read {err10_64:.3g})")
    tol12 = f"rtol {CONV_SUM_RTOL} of the channel's sum of |terms|"
    if not (err10 <= CONV_SUM_RTOL and err10_64 <= CONV_SUM_RTOL and err11 == 0.0
            and err12 <= CONV_SUM_RTOL and err13 == 0.0):
        raise AssertionError(f"{tag}batch-norm passes {label} [{m}, {n}]: sumsq {err10} (f64 "
                             f"{err10_64}), bn_relu {err11}, partials {err12}, dco {err13} "
                             f"beyond {tol10} / bit-exact / {tol12} / bit-exact")
    vec = 8 * n  # two float32 vectors
    entries = [
        {"name": f"conv_bn_relu_centered_sumsq{sfx}", "source": _BN_SRC,
         "replaces": f"{_CBR}:370", "max_abs_err": float((ss - ss_ref).abs().max()),
         "rel_err": err10, "rel_err_vs_float64": err10_64, "tolerance": tol10,
         "bound": bound(es * m * n + 8 * n, 3 * m * n)},
        {"name": f"conv_bn_relu_bn_relu{sfx}", "source": _BN_SRC, "replaces": f"{_CBR}:399",
         "max_abs_err": err11, "tolerance": "bit-exact (the same rounding of co * scale + shift)",
         "bound": bound(es * 2 * m * n + vec, 3 * m * n)},
        {"name": f"conv_bn_relu_bn_bwd_partials{sfx}", "source": _BN_SRC,
         "replaces": f"{_CBR}:463",
         "max_abs_err": max(float((pdy.sum(0) - rdy.sum(0)).abs().max()),
                            float((pdyc.sum(0) - rdyc.sum(0)).abs().max())),
         "rel_err": err12, "tolerance": tol12, "bound": bound(es * 2 * m * n + 8 * n + vec,
                                                              5 * m * n)},
        {"name": f"conv_bn_relu_bn_bwd_dco{sfx}", "source": _BN_SRC, "replaces": f"{_CBR}:496",
         "max_abs_err": err13, "tolerance": "bit-exact (the same rounding, gate included)",
         "bound": bound((2 * es + 4) * m * n + 2 * vec, 7 * m * n)},  # d_co float32
    ]
    for e in entries:
        e.update({"route": "cuda", "shape": [m, n], "label": label, "dtype": dtype})
        e["bound_ms"], e["bound_by"] = e.pop("bound")
    if not timed:
        log(f"{tag}batch-norm passes {label} [{m}, {n}]: sumsq err {err10:.3g} (f64 "
            f"{err10_64:.3g}), bn_relu {err11}, partials {err12:.3g}, dco {err13} (bit-exact "
            "where stated)")
        return entries
    runs = [
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.centered_sumsq(co, mean),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._centered_sumsq_plain(co, mean),
         lambda co, dy, mean, s_, b_, k3, b0: torch.var(co, 0, unbiased=False),
         f"torch.var in {dtype}"),
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.bn_relu(co, s_, b_),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._bn_relu_plain(co, s_, b_), None,
         "none: no single PyTorch call computes relu(co * scale + shift)"),
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.bn_bwd_partials(co, dy, s_, b_),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._bn_bwd_partials_plain(co, dy, s_, b_), None,
         "none: no single PyTorch call computes the gated sums"),
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.bn_bwd_dco(co, dy, s_, b_, k3, b0),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._bn_bwd_dco_plain(co, dy, s_, b_, k3, b0),
         None, "none: no single PyTorch call computes the folded batch-norm backward"),
    ]
    # device time behind a sleep kernel: a bf16 pass takes about as long as
    # the host takes to enqueue it, so CUDA events around a loop of launches
    # read the host's pace (0.021-0.044 ms in three runs of one kernel)
    for e, (kern, plain, lib, lib_name) in zip(entries, runs):
        e["ms"] = e["kernel_ms"] = device_ms_sets(kern, sets, 100)[0]
        e["plain_ms"] = device_ms_sets(plain, sets, 20)[0]
        e["library_ms"] = device_ms_sets(lib, sets, 100)[0] if lib else None
        e["library"] = lib_name
        e["timing"] = "device time behind a sleep kernel"
    log(f"{tag}batch-norm passes {label} [{m}, {n}]: sumsq err {err10:.3g} (f64 "
        f"{err10_64:.3g}), bn_relu {err11}, partials {err12:.3g}, dco {err13}; kernel ms "
        + ", ".join(f"{e['name'][13:]} {e['ms']:.4f} (bound {e['bound_ms']:.4f}, plain "
                    f"{e['plain_ms']:.4f})" for e in entries)
        + f"; {tag}torch.var {entries[0]['library_ms']:.4f}")
    return entries


def _resnet50_param_shapes():
    from paddle_tpu_torch.models import resnet50

    return [tuple(p.shape) for p in resnet50(num_classes=RN_CLASSES).parameters()]


def check_momentum(shapes, label, variants, timed=True):
    """Rows 14 / 14a (``optimizer_update.cu``) over parameters of
    ``shapes``: one multi-tensor update of all of them (a launch per
    ``MAX_TENSORS``) against the plain version's expression, bit for bit,
    for each (nesterov, weight decay) of ``variants``; timed beside the plain
    version and ``torch.optim.SGD`` with the same momentum over the same
    parameters in one call."""
    import torch

    from paddle_tpu_torch.ops.cuda import optimizer_update as ou

    g = torch.Generator(device="cuda").manual_seed(23)
    mk = lambda: [torch.randn(s, generator=g, device="cuda") for s in shapes]  # noqa: E731
    params, grads, vels = mk(), mk(), mk()
    lr = torch.full((), RN_LR, dtype=torch.float32, device="cuda")  # read by pointer, as a step's
    launches = len(ou.launch_groups([int(np.prod(s)) for s in shapes]))
    diff = 0
    for nesterov, wd in variants:
        p, v = [t.clone() for t in params], [t.clone() for t in vels]
        want = [ou._plain_update(a, b, c, RN_LR, RN_MOMENTUM, wd, nesterov)
                for a, b, c in zip(p, grads, v)]
        before = ou.LAUNCHES
        ou.fused_momentum_update_multi(p, grads, v, lr, RN_MOMENTUM, wd, nesterov)
        torch.cuda.synchronize()
        if ou.LAUNCHES - before != launches:
            raise AssertionError(f"momentum update {label}: {ou.LAUNCHES - before} launches, "
                                 f"not {launches}")
        diff += sum(int((a != wp).sum()) + int((c != wv).sum())
                    for a, c, (wp, wv) in zip(p, v, want))
    n = sum(int(t.numel()) for t in params)
    if diff:
        raise AssertionError(f"momentum update {label}: {diff} elements differ from the plain "
                             "version (must be bit-exact)")
    b_ms, by = bound(4 * 5 * n, 5 * n)
    entry = {"name": "momentum_update", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/optimizer_update.cu",
             "replaces": "paddle_tpu/ops/pallas/optimizer_update.py:167", "label": label,
             "parameters": len(shapes), "elements": n, "launches_per_update": launches,
             "dtype": "float32", "lr": "float32 read from device memory",
             "variants": [{"nesterov": a, "weight_decay": b} for a, b in variants],
             "max_abs_err": 0.0, "elements_differing": 0, "tolerance": "bit-exact",
             "bound_ms": b_ms, "bound_by": by}
    if not timed:
        log(f"momentum update {label} ({len(shapes)} parameters, {n} elements, {launches} "
            f"launches): bit-exact for {variants}")
        return entry

    # copies whose bytes together exceed the 50 MB L2, cycled, so every call
    # reads from device memory as a training step's update does
    copies = max(1, min(8, -(-200 * 2**20 // (12 * n))))
    sets = [(params, grads, vels)] + [tuple([t.clone() for t in ts] for ts in (params, grads, vels))
                                      for _ in range(copies - 1)]
    turn = [0]

    def next_set():
        turn[0] += 1
        return sets[turn[0] % copies]

    def kernel_all():
        ou.fused_momentum_update_multi(*next_set(), lr, RN_MOMENTUM)

    def plain_all():
        for a, b, c in zip(*next_set()):
            ou._plain_update(a, b, c, RN_LR, RN_MOMENTUM, 0.0, False)

    def sgd_of(ps, gs, fused):
        lib = [torch.nn.Parameter(t.clone()) for t in ps]
        for t, gr in zip(lib, gs):
            t.grad = gr
        kw = {"fused": True} if fused else {"foreach": True}
        return torch.optim.SGD(lib, lr=RN_LR, momentum=RN_MOMENTUM, **kw)

    try:
        sgds = [sgd_of(p_, g_, True) for p_, g_, _ in sets]
        lib_name = "torch.optim.SGD(momentum=0.9, fused=True).step()"
        sgds[0].step()
    except (TypeError, RuntimeError):
        sgds = [sgd_of(p_, g_, False) for p_, g_, _ in sets]
        lib_name = "torch.optim.SGD(momentum=0.9, foreach=True).step()"

    def lib_all():
        turn[0] += 1
        sgds[turn[0] % copies].step()

    iters = 50 if len(shapes) > 1 else 200
    # device time (host hidden) and host time a call of each; the events
    # over back-to-back calls as well, which the slower of the two sets
    entry["ms"], entry["host_ms"] = device_ms(kernel_all, iters)
    entry["kernel_ms"] = entry["ms"]
    # (the plain version's ~800 launches a call fill the launch queue, so
    # its device time includes some host pacing)
    entry["plain_ms"], entry["plain_host_ms"] = device_ms(plain_all, 5)
    entry["library_ms"], entry["library_host_ms"] = device_ms(lib_all, iters)
    entry["library"] = lib_name
    entry["back_to_back_ms"] = time_ms(kernel_all, [()], iters)
    entry["library_back_to_back_ms"] = time_ms(lib_all, [()], iters)
    entry["copies_cycled"] = copies
    log(f"momentum update {label} ({len(shapes)} parameters, {n} elements, {launches} "
        f"launches): bit-exact for {variants}; device ms a call: kernel {entry['ms']:.4f}, "
        f"plain {entry['plain_ms']:.4f}, {lib_name} {entry['library_ms']:.4f}, bound "
        f"{b_ms:.4f} ({by}); host ms a call: kernel {entry['host_ms']:.4f}, plain "
        f"{entry['plain_host_ms']:.4f}, library {entry['library_host_ms']:.4f}; back to back: "
        f"kernel {entry['back_to_back_ms']:.4f}, library {entry['library_back_to_back_ms']:.4f}")
    return entry


def check_resnet_kernels():
    """One entry per kernel of the ResNet path (rows 8-14) at layer1's 3x3
    conv at batch 128 (the momentum update at ResNet-50's largest
    parameter); the stem (K = 147), a ragged shape (M, N off every tile,
    N % 4 != 0), layer4's K = 4608, row 8 at the serving batch 32 and the
    33 products of batches 1 and 8, the large-mean variance and all 161
    parameters ride along under ``also_checked``."""
    import torch

    e8, e9 = check_conv_mm(CONV_M, CONV_K, CONV_N, "layer1 3x3, batch 128", tf32_control=True)
    s8, s9 = check_conv_mm(RN_B * 112 * 112, 3 * 7 * 7, 64, "stem 7x7, batch 128")
    r8, r9 = check_conv_mm(12345, 147, 70, "ragged", timed=False)
    d8, d9 = check_conv_mm(RN_B * 7 * 7, 9 * 512, 512, "layer4 3x3, batch 128 (K = 4608)",
                           timed=False)
    v8, _ = check_conv_mm(RN_BUCKETS[-1] * 56 * 56, CONV_K, CONV_N,
                          f"layer1 3x3, serving batch {RN_BUCKETS[-1]}")
    e8["also_checked"] = [s8, r8, d8, v8, check_conv_serving(RN_BUCKETS[0]),
                          check_conv_serving(RN_BUCKETS[1], per_product=False)]
    e9["also_checked"] = [s9, r9, d9]
    bn = check_bn_passes(CONV_M, CONV_N, "layer1 3x3, batch 128")
    ragged = check_bn_passes(12345, 70, "ragged", timed=False)
    large = check_bn_passes(CONV_M, CONV_N, "mean ~100, std ~0.1", timed=False,
                            mean_offset=100.0, std=0.1)
    for e, r in zip(bn, ragged):
        e["also_checked"] = [r]
    bn[0]["also_checked"].append(large[0])
    shapes = _resnet50_param_shapes()
    if len(shapes) != RN_PARAMS:
        raise AssertionError(f"ResNet-50 has {len(shapes)} parameters, not {RN_PARAMS}")
    largest = max(shapes, key=lambda s: int(np.prod(s)))
    variants = [(False, 0.0), (False, 1e-4), (True, 0.0), (True, 1e-4)]
    mom = check_momentum([largest], f"largest parameter {list(largest)}", variants)
    mom["also_checked"] = [check_momentum(shapes, "all ResNet-50 parameters", variants)]
    torch.cuda.empty_cache()
    return [e8, e9, *bn, mom]


def _images(rng, rows):
    """Images as float64 rounded to 3 decimals: short JSON, and exactly the
    float32 values the server parses."""
    return np.round(rng.randn(rows, 3, RN_HW, RN_HW), 3)


# Serving limit against the CPU forward of the same weights: max |logit
# error| over the largest |logit| of the answer, about the geometric mean of
# two readings on an H100: f32 (2.0e-6: 53 layers of f32 sums in other
# orders) and the same requests with TF32 matmuls and convolutions (5.3e-4),
# which serve_resnet requires the limit to catch.
RN_SERVE_RTOL = 3e-5


def _resnet50(seed):
    import torch

    from paddle_tpu_torch.models import resnet50

    return resnet50(num_classes=RN_CLASSES, generator=torch.Generator().manual_seed(seed))


def serve_resnet():
    """ResNet-50 behind ``Predictor`` -> ``InferenceServer`` at buckets 1,
    8 and 32. Returns (kernel launches per name on the serving run,
    readings)."""
    import torch

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.jit_api import InputSpec
    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    specs = [InputSpec([None, 3, RN_HW, RN_HW], "float32", "image")]
    model = _resnet50(seed=0)
    cpu_pred = Predictor(copy.deepcopy(model), specs, ["logits"], device="cpu")
    pred = Predictor(model, specs, ["logits"])
    rng = np.random.RandomState(13)
    reqs = [{"image": _images(rng, rows)} for rows in (1, 6, 3, 20)]
    answers, counts, forwards, readings = _serve(pred, RN_BUCKETS, reqs, "ResNet-50")
    wants, worst = [], 0.0
    for i, (req, ans) in enumerate(zip(reqs, answers)):
        req = req["image"]
        got = np.asarray(ans[1]["outputs"]["logits"], np.float32)
        want = cpu_pred.run([req.astype(np.float32)])[0]
        wants.append(want)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"ResNet request {i}: shape {got.shape} vs {want.shape} or "
                                 "not finite")
        e = float(np.abs(got - want).max() / np.abs(want).max())
        worst = max(worst, e)
        log(f"ResNet request {i} ({len(req)} images): logits max err vs CPU {e:.3g} of the "
            f"largest |logit| {np.abs(want).max():.4g} (limit {RN_SERVE_RTOL})")
        if e > RN_SERVE_RTOL:
            raise AssertionError(f"ResNet request {i}: err {e} beyond {RN_SERVE_RTOL}")
    want = {"conv_bn_relu_mm_affine_relu": RN_TRIPLES * forwards}
    want = {name: want.get(name, 0) for name in counts}
    if forwards <= 0 or counts != want:
        raise AssertionError(f"ResNet launches {counts} over {forwards} forwards; want {want}")
    splits = cbr.MM_AFFINE_RELU_SPLITS
    at_one = sum(cbr._split_k(*s)[0] > 1 for s in _rn50_fused_products(RN_BUCKETS[0]))
    if not at_one <= splits <= RN_TRIPLES * forwards:
        raise AssertionError(f"ResNet serving: {splits} split-K products over {forwards} "
                             f"forwards; the bucket-1 forward alone splits {at_one}")
    log(f"ResNet-50: {forwards} forwards, launches {counts}: {RN_TRIPLES} fused eval kernels "
        f"each; {splits} of them took split-K")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = max(float(np.abs(pred.run([r["image"].astype(np.float32)])[0] - w).max()
                         / np.abs(w).max()) for r, w in zip(reqs, wants))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log(f"ResNet TF32 control (matmul and cuDNN convs in TF32): max err vs CPU {tf32:.3g} "
        f"(limit {RN_SERVE_RTOL}; f32 read {worst:.3g})")
    if not tf32 > RN_SERVE_RTOL:
        raise AssertionError(f"ResNet TF32 control {tf32} passes the serving limit "
                             f"{RN_SERVE_RTOL}: it cannot catch it")
    readings["by_bucket"] = profile_resnet_forward(pred)
    readings["concurrent"] = _concurrent_replays(pred, _rn_feed, 8, 5, "ResNet-50")
    return counts, readings


def _rn_feed(bucket, seed):
    return [np.random.RandomState(seed).randn(bucket, 3, RN_HW, RN_HW).astype(np.float32)]


def profile_resnet_forward(pred):
    """Forward time per bucket (inputs on the card, CUDA events around 10
    forwards of the module, eagerly), then ``Predictor.run`` captured
    against eager at every bucket (:func:`_captured_vs_eager`). Returns the
    latter's readings."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    for bucket in RN_BUCKETS:
        x = torch.randn(bucket, 3, RN_HW, RN_HW, generator=g, device="cuda")
        with torch.inference_mode():
            ms = time_ms(pred.module, [(x,)] * 2, 10)
        log(f"ResNet-50 forward bucket {bucket}: {ms:.3f} ms, {bucket / ms * 1e3:.1f} images/s")
    feeds = {b: _rn_feed(b, 6 + b) for b in RN_BUCKETS}
    return _captured_vs_eager(pred, feeds, _eager_module_run(pred), "ResNet-50")


# Training parity limits against the CPU's plain path (batch 2 x 224 x 224),
# each about the geometric mean of two readings on an H100, f32 and the same
# step with TF32 matmuls and convolutions (which rn_train_parity requires
# them to catch): the loss (1.9e-5 / 3.7e-3), each BN running buffer over its
# batch norm's largest buffer entry (1.0e-5 / 5.3e-3), the classifier's
# gradients over their layer's largest entry (3.1e-5 / 1.9e-2).
RN_LOSS_ATOL = 2.5e-4
RN_BUF_RTOL = 2e-4
RN_FC_GRAD_RTOL = 7e-4
# Every other gradient sits behind relu gates: a pre-activation within f32
# rounding of 0 lands on opposite sides of the gate on the card and on the
# CPU, and the whole gradient of every layer before it moves (f32 read
# 0.143 of the layer's largest entry at layer3.2.conv1.weight, where batch
# 2 leaves 392 rows a channel). Elementwise, that cannot be told from TF32
# (0.739), so every gradient is held only to 0.5 of its layer's largest
# entry (a wrong sign or a missing term), and the gradient as a whole by
# its relative L2 error over the model: f32 0.0153, TF32 0.488.
RN_GRAD_RTOL = 0.5
RN_GRAD_L2_RTOL = 0.08


def _rn_loss(m, x, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(m(x), y)


def _rn_step_of(model, device=None, loss_fn=_rn_loss, jit=False):
    """bench.py's ResNet step: Momentum lr 0.1, momentum 0.9. ``jit=False``
    (the eager step) unless the caller asks for the compiled one."""
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM, parameters=model.parameters())
    return train_step(model, opt, loss_fn, device=device, jit=jit)


def _buffer_errors(model, ref_model):
    """(worst, its name): each running buffer's largest error over the
    largest entry of its batch norm's two buffers."""
    pairs = list(zip(model.named_buffers(), ref_model.named_buffers()))
    scale = {}
    for (n, _), (_, r) in pairs:
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(r.abs().max()))
    worst, name = 0.0, None
    for (n, b), (_, r) in pairs:
        e = float((b.cpu() - r).abs().max()) / max(scale[n.rpartition(".")[0]], 1e-30)
        if e > worst:
            worst, name = e, n
    return worst, name


def _grad_l2_errors(model, ref_model):
    """(relative L2 error of the whole gradient, worst relative L2 error
    of one parameter's gradient, its name)."""
    num = den = 0.0
    worst, name = 0.0, None
    for (n, p), (_, r) in zip(model.named_parameters(), ref_model.named_parameters()):
        d = float((p.grad.cpu().double() - r.grad.double()).square().sum())
        s = float(r.grad.double().square().sum())
        num, den = num + d, den + s
        if d / max(s, 1e-300) > worst:
            worst, name = d / max(s, 1e-300), n
    return (num / den) ** 0.5, worst ** 0.5, name


def _fc_grad_error(model, ref_model):
    g = [p.grad.cpu() for n, p in model.named_parameters() if n.startswith("fc.")]
    r = [p.grad for n, p in ref_model.named_parameters() if n.startswith("fc.")]
    s = max(float(t.abs().max()) for t in r)
    return max(float((a - b).abs().max()) for a, b in zip(g, r)) / s


def rn_train_parity(pool_kernel=False):
    """One Momentum step at batch 2 x 224 x 224 on the card and on the CPU
    (the plain path) from the same weights, then the same step with TF32
    matmuls and convolutions, which the limits must catch. ``pool_kernel``
    says whether ``FLAGS_use_pallas_pool_bwd`` is on (the caller sets it):
    then the step also launches the max-pool backward kernel once."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _resnet50(seed=2)
    cpu_model, tf32_model = copy.deepcopy(model), copy.deepcopy(model)
    rng = np.random.RandomState(14)
    batch = [rng.randn(2, 3, RN_HW, RN_HW).astype(np.float32),
             rng.randint(0, RN_CLASSES, (2,)).astype(np.int64)]
    t0 = time.perf_counter()
    cpu_loss = float(_rn_step_of(cpu_model, device="cpu")(*batch)["loss"])
    log(f"ResNet parity step on the CPU (plain path): loss {cpu_loss:.6f}, "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    loss = float(_rn_step_of(model)(*batch)["loss"])
    counts = launch_counts()
    want = _rn_step_launches(1, pool_kernel)
    if counts != want:
        raise AssertionError(f"ResNet parity step launched {counts}; want {want}")
    _rn_check_tensors(1, "ResNet parity step")
    readings = {"loss_err": abs(loss - cpu_loss), "grad_rel_err": _grad_errors(model, cpu_model),
                "grad_l2": _grad_l2_errors(model, cpu_model),
                "fc_grad_rel_err": _fc_grad_error(model, cpu_model),
                "buffer_rel_err": _buffer_errors(model, cpu_model)}
    step = _rn_step_of(tf32_model)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_loss = float(step(*batch)["loss"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tf32 = {"loss_err": abs(tf32_loss - cpu_loss),
            "grad_rel_err": _grad_errors(tf32_model, cpu_model),
            "grad_l2": _grad_l2_errors(tf32_model, cpu_model),
            "fc_grad_rel_err": _fc_grad_error(tf32_model, cpu_model),
            "buffer_rel_err": _buffer_errors(tf32_model, cpu_model)}
    log(f"ResNet parity step on the card: loss {loss:.6f}; f32 {readings}; TF32 control {tf32} "
        f"(limits: loss {RN_LOSS_ATOL}, buffers {RN_BUF_RTOL}, fc gradients {RN_FC_GRAD_RTOL}, "
        f"every gradient {RN_GRAD_RTOL}, the gradient's L2 {RN_GRAD_L2_RTOL})")
    ok = (np.isfinite(loss) and readings["loss_err"] <= RN_LOSS_ATOL
          and readings["buffer_rel_err"][0] <= RN_BUF_RTOL
          and readings["fc_grad_rel_err"] <= RN_FC_GRAD_RTOL
          and readings["grad_rel_err"][0] <= RN_GRAD_RTOL
          and readings["grad_l2"][0] <= RN_GRAD_L2_RTOL)
    if not ok:
        raise AssertionError(f"ResNet parity step {readings} beyond its limits")
    if not (tf32["loss_err"] > RN_LOSS_ATOL and tf32["buffer_rel_err"][0] > RN_BUF_RTOL
            and tf32["fc_grad_rel_err"] > RN_FC_GRAD_RTOL
            and tf32["grad_l2"][0] > RN_GRAD_L2_RTOL):
        raise AssertionError(f"ResNet TF32 control {tf32} passes the training limits")
    return readings, tf32


def _rn_momentum_launches():
    """Launches of one Momentum step over ResNet-50's parameters: one per
    ``MAX_TENSORS`` of them."""
    from paddle_tpu_torch.ops.cuda import optimizer_update as ou

    return -(-RN_PARAMS // ou.MAX_TENSORS)


def _rn_check_tensors(steps, label):
    """The momentum launches of ``steps`` steps updated every parameter
    once a step (the count set to 0 with the launch counts)."""
    from paddle_tpu_torch.ops.cuda import optimizer_update as ou

    if ou.TENSORS != RN_PARAMS * steps:
        raise AssertionError(f"{label}: the momentum launches updated {ou.TENSORS} tensors, not "
                             f"{RN_PARAMS} x {steps}")


def _rn_step_launches(steps, pool_kernel=False):
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS

    want = {f"conv_bn_relu_{k}": RN_TRIPLES * steps for k in
            ("mm_stats", "centered_sumsq", "bn_relu", "bn_bwd_partials", "bn_bwd_dco")}
    want["momentum_update"] = _rn_momentum_launches() * steps
    want["max_pool2d_backward"] = steps if pool_kernel else 0  # the stem's pool
    return {name: want.get(name, 0) for name in KERNEL_COUNTERS}


RN_STEPS_FLAG_OFF = 4  # the run without the pool kernel, kept beside the main one


def _rn_timed_run(steps, pool_kernel):
    """``steps`` timed Momentum steps at batch 128 on one fixed batch from
    the same seeds, with the launch counts the flag's setting must give.
    Returns (step, batch, losses, ms of each step, host-clock ms a step,
    launches, peak GiB)."""
    import torch

    model = _resnet50(seed=1)
    step = _rn_step_of(model)
    rng = np.random.RandomState(15)
    batch = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
             torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
    losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, steps)
    want = _rn_step_launches(steps, pool_kernel)
    if counts != want:
        raise AssertionError(f"ResNet {steps} steps launched {counts}; want {want}")
    _rn_check_tensors(steps, f"ResNet {steps} steps")
    # at lr 0.1 with no warm-up the loss on one fixed batch falls for two
    # steps and then swings (7.54 -> 5.43 -> 8.54 -> 5.63 in one run, -> 8.12
    # in another: atomics in cuDNN's and the loss's backward make runs
    # differ), so the check asks that the steps lowered it below the first
    # loss, not that the last is the lowest
    if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
        raise AssertionError(f"ResNet losses not finite or not falling: {losses}")
    return step, batch, losses, step_ms, wall_ms, counts, peak


def train_resnet():
    """ResNet-50 with Momentum. With ``FLAGS_use_pallas_pool_bwd`` off (the
    default): the parity step and ``RN_STEPS_FLAG_OFF`` timed steps at batch
    128. Then with the flag on, the main run: the parity step again and
    ``RN_STEPS`` timed steps, each launching the max-pool backward kernel
    once. Returns kernel launches per name over the flag-on timed steps."""
    import torch

    from paddle_tpu_torch.flags import set_flags

    rn_train_parity()
    torch.cuda.empty_cache()
    _, _, off_losses, off_ms, _, _, _ = _rn_timed_run(RN_STEPS_FLAG_OFF, pool_kernel=False)
    log(f"ResNet-50 flag off, {RN_STEPS_FLAG_OFF} steps: losses "
        f"{', '.join(f'{x:.6f}' for x in off_losses)}")
    torch.cuda.empty_cache()
    set_flags({"use_pallas_pool_bwd": True})
    try:
        rn_train_parity(pool_kernel=True)
        torch.cuda.empty_cache()
        step, batch, losses, step_ms, wall_ms, counts, peak = _rn_timed_run(RN_STEPS,
                                                                           pool_kernel=True)
        mean_ms, off_mean = float(np.mean(step_ms)), float(np.mean(off_ms))
        log(f"ResNet-50 {RN_STEPS} steps at batch {RN_B} x {RN_HW}^2, Momentum lr {RN_LR}, "
            f"max-pool backward kernel on: losses {', '.join(f'{x:.6f}' for x in losses)}")
        log(f"ResNet-50 step {mean_ms:.2f} ms with the pool kernel (median "
            f"{float(np.median(step_ms)):.2f}, min {min(step_ms):.2f}, max {max(step_ms):.2f}; "
            f"host clock {wall_ms:.2f}), {RN_B / mean_ms * 1e3:.1f} images/s; with the flag off "
            f"{off_mean:.2f} ms (median {float(np.median(off_ms)):.2f}, min {min(off_ms):.2f}, max "
            f"{max(off_ms):.2f} over {RN_STEPS_FLAG_OFF} steps), {RN_B / off_mean * 1e3:.1f} "
            f"images/s; peak device "
            f"memory {peak:.1f} GiB; launches {counts}: {RN_TRIPLES} of each training conv kernel, "
            f"{_rn_momentum_launches()} momentum launches updating {RN_PARAMS} tensors and 1 "
            "max-pool backward a step")
        _profile_step(step, batch, "ResNet train step profiled (pool kernel on)")
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    return counts


# -- the ResNet path under AMP ---------------------------------------------------

_CONV_BF16_SRC = "paddle_tpu_torch/csrc/conv_bn_relu_mm_bf16.cu"
_POOL_SRC = "paddle_tpu_torch/csrc/pool_backward.cu"
_POOL_TPU = "paddle_tpu/ops/pallas/pool_backward.py:244"
# bf16 kernels against their plain versions, in bf16 ulps of the largest
# output (bf16_ulp): co rounds a float32 sum taken in another order than
# cuBLAS's, so an entry at a rounding boundary lands one ulp over (1); the
# eval output applies the affine to that co and rounds again, which can add
# an ulp of its own (2)
CONV_BF16_CO_ULPS = 1.0
CONV_BF16_Y_ULPS = 2.0
RN_AMP_STEPS = 10


def _ulps(got, want):
    """max |got - want| in bf16 ulps of the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / bf16_ulp(want.abs().max()))


def _bf16_conv_bounds(m, k, n, out_bytes):
    """(bound ms, by what) of one bf16 conv product: p2, w2 and the bf16
    [M, N] output, plus ``out_bytes`` of float32 vectors."""
    return bound(2 * (m * k + k * n + m * n) + out_bytes, 2 * m * k * n, peak=BF16_FLOPS_PER_S)


def _conv_sets_bf16(g, m, k, n, count):
    return [(p2.bfloat16(), w2.bfloat16(), s_, b_) for p2, w2, s_, b_ in
            _conv_sets(g, m, k, n, count)]


def check_conv_mm_bf16(m, k, n, label, timed=True):
    """Rows 8 and 9 in bf16 (``conv_bn_relu_mm_bf16.cu``) at [m, k] @ [k, n]
    against the plain versions on the same inputs, in bf16 ulps of the
    largest output; the channel sums against a float64 sum of the kernel's
    own rounded co (the sums are of the stored values), and a second run
    must repeat co and the sums bit for bit. Timed beside bf16
    ``torch.matmul``."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(31)
    sets = _conv_sets_bf16(g, m, k, n, 2 if timed else 1)
    p2, w2, scale, shift = sets[0]
    y = cbr.mm_affine_relu(p2, w2, scale, shift)
    y_ref = cbr._mm_affine_relu_plain(p2, w2, scale, shift)
    co, part = cbr.mm_stats(p2, w2)
    co2, part2 = cbr.mm_stats(p2, w2)
    co_ref, _ = cbr._mm_stats_plain(p2, w2)
    torch.cuda.synchronize()
    u8, u9 = _ulps(y, y_ref), _ulps(co, co_ref)
    differ9 = float((co != co_ref).float().mean())
    sum_err = _sum_rel(part.sum(0).double(), co.double().sum(0), co.float())
    tol8 = f"{CONV_BF16_Y_ULPS} bf16 ulps of the largest output"
    tol9 = (f"co {CONV_BF16_CO_ULPS} bf16 ulp of the largest output; channel sums "
            f"{CONV_SUM_RTOL} of the channel's sum of |co| against float64 sums of the stored co")
    if y.dtype != torch.bfloat16 or co.dtype != torch.bfloat16 or part.dtype != torch.float32:
        raise AssertionError(f"bf16 conv matmul {label}: dtypes {y.dtype}, {co.dtype}, "
                             f"{part.dtype}")
    if u8 > CONV_BF16_Y_ULPS or u9 > CONV_BF16_CO_ULPS or sum_err > CONV_SUM_RTOL:
        raise AssertionError(f"bf16 conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu "
                             f"{u8} ulps, co {u9} ulps, sums {sum_err} beyond {tol8} / {tol9}")
    if not (torch.equal(co, co2) and torch.equal(part, part2)):
        raise AssertionError(f"bf16 conv matmul {label}: a second mm_stats run differs")
    b8, by8 = _bf16_conv_bounds(m, k, n, 8 * n)
    b9, by9 = _bf16_conv_bounds(m, k, n, 4 * n)
    e8 = {"name": "conv_bn_relu_mm_affine_relu_bf16", "route": "cuda", "source": _CONV_BF16_SRC,
          "replaces": f"{_CBR}:306", "shape": [m, k, n], "label": label, "dtype": "bfloat16",
          "max_abs_err": float((y.float() - y_ref.float()).abs().max()), "ulps": u8,
          "tolerance": tol8, "bound_ms": b8, "bound_by": by8,
          "splits": cbr._split_k_bf16(m, k, n, cbr._sm_count(0))[0]}
    e9 = {"name": "conv_bn_relu_mm_stats_bf16", "route": "cuda", "source": _CONV_BF16_SRC,
          "replaces": f"{_CBR}:337", "shape": [m, k, n], "label": label, "dtype": "bfloat16",
          "max_abs_err": float((co.float() - co_ref.float()).abs().max()), "ulps": u9,
          "co_entries_differing": differ9, "sums_rel_err": sum_err, "tolerance": tol9,
          "bound_ms": b9, "bound_by": by9, "repeats_bit_for_bit": True}
    note = ""
    if timed:
        iters = max(5, min(50, int(1.5e11 / (m * k * n))))
        e8["ms"] = e8["kernel_ms"] = time_ms(cbr.mm_affine_relu, sets, iters)
        e8["plain_ms"] = time_ms(cbr._mm_affine_relu_plain, sets, iters)
        e9["ms"] = e9["kernel_ms"] = time_ms(lambda p, w, s_, b_: cbr.mm_stats(p, w), sets, iters)
        e9["plain_ms"] = time_ms(lambda p, w, s_, b_: cbr._mm_stats_plain(p, w), sets, iters)
        lib = time_ms(lambda p, w, s_, b_: torch.matmul(p, w), sets, iters)
        e8["library_ms"] = e9["library_ms"] = lib
        e8["library"] = e9["library"] = "torch.matmul(p2, w2) in bf16 (the product alone)"
        note = (f"; affine+relu {e8['ms']:.4f} ms (bound {b8:.4f} {by8}), stats {e9['ms']:.4f} "
                f"ms (bound {b9:.4f}), plain {e8['plain_ms']:.4f} / {e9['plain_ms']:.4f} ms, "
                f"bf16 torch.matmul {lib:.4f} ms")
    log(f"bf16 conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu {u8:.3g} ulps, co "
        f"{u9:.3g} ulps ({differ9:.2e} of co differing), sums {sum_err:.3g} ({tol9}){note}")
    return e8, e9


def _rn50_fused_products_bf16(batch):
    """:func:`_rn50_fused_products` as the bf16 lowering gives them: K
    padded to a multiple of 8 (the stem's 147 to 152)."""
    return [(m, -(-k // 8) * 8, n) for m, k, n in _rn50_fused_products(batch)]


def check_conv_serving_bf16(batch):
    """Row 8b in bf16: the 33 fused eval products of a ResNet-50 forward
    at serving batch ``batch``, each against its plain version and run a
    second time bit-equal (the split-K reduce adds the slices in slice
    order whichever block arrives last), the split-K calls counted against
    the planner's, then the device time of the 33 kernel calls in a row
    against 33 bf16 ``torch.matmul`` calls."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(33)
    shapes = _rn50_fused_products_bf16(batch)
    sets = [_conv_sets_bf16(g, m, k, n, 1)[0] for m, k, n in shapes]
    splits0 = cbr.MM_AFFINE_RELU_SPLITS
    worst, worst_abs = 0.0, 0.0
    for (m, k, n), args in zip(shapes, sets):
        y, y_ref = cbr.mm_affine_relu(*args), cbr._mm_affine_relu_plain(*args)
        u = _ulps(y, y_ref)
        if u > CONV_BF16_Y_ULPS:
            raise AssertionError(f"bf16 conv product [{m}, {k}] @ [{k}, {n}] at batch {batch}: "
                                 f"{u} ulps beyond {CONV_BF16_Y_ULPS}")
        if not torch.equal(y, cbr.mm_affine_relu(*args)):
            raise AssertionError(f"bf16 conv product [{m}, {k}] @ [{k}, {n}] at batch {batch}: "
                                 "a second run differs")
        worst = max(worst, u)
        worst_abs = max(worst_abs, float((y.float() - y_ref.float()).abs().max()))
    splits = (cbr.MM_AFFINE_RELU_SPLITS - splits0) // 2  # each product ran twice
    want = sum(cbr._split_k_bf16(*sh, cbr._sm_count(0))[0] > 1 for sh in shapes)
    if splits != want:
        raise AssertionError(f"bf16: {splits} of the {len(shapes)} products took split-K; the "
                             f"bf16 planner splits {want}")
    ms = device_ms(lambda: [cbr.mm_affine_relu(*a) for a in sets], 10)[0]
    plain = device_ms(lambda: [cbr._mm_affine_relu_plain(*a) for a in sets], 10)[0]
    lib = device_ms(lambda: [torch.matmul(a[0], a[1]) for a in sets], 10)[0]
    bounds = [_bf16_conv_bounds(m, k, n, 8 * n) for m, k, n in shapes]
    b = sum(x[0] for x in bounds)
    by = max(("bytes", "operations"), key=lambda w: sum(x[0] for x in bounds if x[1] == w))
    log(f"ResNet-50 bucket {batch}, {len(shapes)} bf16 fused products: {worst:.3g} ulps (limit "
        f"{CONV_BF16_Y_ULPS}), {splits} took split-K; device time in a row {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bf16 torch.matmul {lib:.4f} ms, bound {b:.4f} ms ({by})")
    return {"name": "conv_bn_relu_mm_affine_relu_bf16", "route": "cuda", "source": _CONV_BF16_SRC,
            "replaces": f"{_CBR}:306", "label": f"ResNet-50 serving batch {batch} under AMP: the "
            f"{len(shapes)} fused products in a row, device time", "shape": shapes,
            "dtype": "bfloat16", "max_abs_err": worst_abs, "ulps": worst,
            "tolerance": f"{CONV_BF16_Y_ULPS} bf16 ulps of each product's largest output",
            "splits": splits, "repeats_bit_for_bit": True, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain, "library_ms": lib,
            "library": "torch.matmul(p2, w2) in bf16 for each product", "bound_ms": b,
            "bound_by": by}


def check_pool_backward_bf16(layout, shape=None, timed=True):
    """Row 16 in bf16 at the stem's [128, 64, 112, 112], 3x3/2/1, on a relu'd
    input (zeros tie all over), in NCHW or the stem's channels-last layout
    (``layout``): bit-equal to the plain version (float32 sums rounded once),
    dx in x's layout; against ``aten.max_pool2d_with_indices_backward`` in
    bf16, the library yardstick, to 4 bf16 ulps of the largest entry (the
    same first-maximum rule)."""
    import torch

    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    g = torch.Generator(device="cuda").manual_seed(34)
    ks, st, pad = POOL_GEOM
    n, c, h, w = shape or POOL_SHAPE
    x = torch.relu(torch.randn(n, h, w, c, generator=g, device="cuda")).bfloat16()
    x = x.permute(0, 3, 1, 2)
    if layout == "nchw":
        x = x.contiguous()
    y, idx = torch.nn.functional.max_pool2d(x, ks, st, pad, return_indices=True)
    dy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    y, dy = y.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt)
    layouts = [pb.memory_layout(t) for t in (x, y, dy)]
    if layouts != [layout] * 3:
        raise AssertionError(f"bf16 max_pool2d_backward ({layout}): x, y, dy lie as {layouts}")
    launches0 = pb.BF16_LAUNCHES
    dx = pb.max_pool2d_backward(x, y, dy, ks, st, pad)
    if pb.BF16_LAUNCHES != launches0 + 1:
        raise AssertionError("bf16 max_pool2d_backward: the bf16 kernel was not counted")
    ref = pb._plain_max_pool2d_backward(x, y, dy, ks, st, pad)
    lib_fn = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731
        dy, x, list(ks), list(st), list(pad), [1, 1], False, idx)
    lib = lib_fn()
    torch.cuda.synchronize()
    lib_u = _ulps(dx, lib)
    if dx.dtype != torch.bfloat16 or not torch.equal(dx, ref):
        raise AssertionError(f"bf16 max_pool2d_backward ({layout}): {dx.dtype}, differs from "
                             f"the plain version by {float((dx.float() - ref.float()).abs().max())}")
    if pb.memory_layout(dx) != layout:
        raise AssertionError(f"bf16 max_pool2d_backward: dx lies as {pb.memory_layout(dx)}")
    if lib_u > 4:
        raise AssertionError(f"bf16 max_pool2d_backward ({layout}): {lib_u} ulps from torch's "
                             "backward: another tie rule?")
    t_b, by = bound(2 * (2 * x.numel() + 2 * y.numel()), 9 * x.numel())
    entry = {"name": "max_pool2d_backward_bf16", "route": "cuda", "source": _POOL_SRC,
             "replaces": _POOL_TPU, "shape": [n, c, h, w], "geometry": "3x3 stride 2 padding 1",
             "input": "relu", "layout": layout, "dtype": "bfloat16", "max_abs_err": 0.0,
             "tolerance": "bit-equal to the plain version", "library_ulps": lib_u,
             "bound_ms": t_b, "bound_by": by}
    if timed:
        args = [(x, y, dy, ks, st, pad)]
        entry["ms"], entry["host_ms"] = device_ms_sets(pb.max_pool2d_backward, args, 20)
        entry["kernel_ms"] = entry["ms"]
        entry["plain_ms"] = device_ms_sets(pb._plain_max_pool2d_backward, args, 5)[0]
        entry["library_ms"] = device_ms(lib_fn, 20)[0]
        entry["library"] = "aten.max_pool2d_with_indices_backward in bf16, the same layout"
        entry["timing"] = "device time behind a sleep kernel"
    log(f"bf16 max_pool2d_backward {[n, c, h, w]} 3x3/2/1 ({layout}): bit-equal to the plain "
        f"version; {lib_u:.3g} ulps from torch's backward"
        + (f"; kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, library "
           f"{entry['library_ms']:.4f} ms, bound {t_b:.4f} ms ({by})" if timed else ""))
    return entry


def check_resnet_kernels_bf16(timed=True):
    """One entry per bf16 kernel of the ResNet path under AMP (rows 8-13 at
    layer1's 3x3 conv at batch 128, row 16 at the stem's pool in its
    channels-last layout); the stem (K padded to 152), layer2's and
    layer3's 3x3 convs (N = 128 and 256: tiles of the other widths), ragged
    shapes (M and N off every tile, N % 8 != 0, an odd N), layer4's K =
    4608 (N = 512: two column tiles), row 8 at the serving batch 32 and the
    33 products of batches 1 and 8 (split-K), the large-mean variance and
    the NCHW pool ride along under ``also_checked``."""
    import torch

    e8, e9 = check_conv_mm_bf16(CONV_M, CONV_K, CONV_N, "layer1 3x3, batch 128", timed)
    others = [check_conv_mm_bf16(RN_B * 112 * 112, 152, 64, "stem 7x7, batch 128, K 147 -> 152",
                                 timed),
              check_conv_mm_bf16(RN_B * 28 * 28, 9 * 128, 128, "layer2 3x3, batch 128 (N = 128)",
                                 timed),
              check_conv_mm_bf16(RN_B * 14 * 14, 9 * 256, 256, "layer3 3x3, batch 128 (N = 256)",
                                 timed),
              check_conv_mm_bf16(12345, 152, 70, "ragged", timed=False),
              check_conv_mm_bf16(1000, 24, 37, "ragged, odd N", timed=False),
              check_conv_mm_bf16(RN_B * 7 * 7, 9 * 512, 512, "layer4 3x3, batch 128 (K = 4608)",
                                 timed=False),
              check_conv_mm_bf16(RN_BUCKETS[-1] * 56 * 56, CONV_K, CONV_N,
                                 f"layer1 3x3, serving batch {RN_BUCKETS[-1]}", timed)]
    e8["also_checked"] = [o[0] for o in others] + [check_conv_serving_bf16(b)
                                                   for b in RN_BUCKETS[:2]]
    e9["also_checked"] = [o[1] for o in others]
    bf16 = dict(dtype="bfloat16")
    bn = check_bn_passes(CONV_M, CONV_N, "layer1 3x3, batch 128", timed, **bf16)
    ragged = [check_bn_passes(12345, 70, "ragged", timed=False, **bf16),
              check_bn_passes(12345, 37, "ragged, odd N", timed=False, **bf16)]
    large = check_bn_passes(CONV_M, CONV_N, "mean ~100, std ~0.1", timed=False,
                            mean_offset=100.0, std=0.1, **bf16)
    for i, e in enumerate(bn):
        e["also_checked"] = [r[i] for r in ragged]
    bn[0]["also_checked"].append(large[0])
    pool = check_pool_backward_bf16("nhwc", timed=timed)
    pool["also_checked"] = [check_pool_backward_bf16("nchw", timed=timed),
                            check_pool_backward_bf16("nchw", (2, 3, 15, 15), timed=False),
                            check_pool_backward_bf16("nhwc", (2, 6, 15, 15), timed=False)]
    torch.cuda.empty_cache()
    return [e8, e9, *bn, pool]


def _rn_amp_loss(m, x, y):
    from paddle_tpu_torch import amp

    with amp.auto_cast():
        return _rn_loss(m, x, y)


def _rn_amp_step_launches(steps):
    """Launches of ``steps`` O1 steps with the pool kernel on: each training
    conv kernel 33 times in bf16 and never in float32, the stem's pool
    backward once in bf16, the float32 momentum update."""
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS

    want = {f"conv_bn_relu_{k}_bf16": RN_TRIPLES * steps for k in
            ("mm_stats", "centered_sumsq", "bn_relu", "bn_bwd_partials", "bn_bwd_dco")}
    want["momentum_update"] = _rn_momentum_launches() * steps
    want["max_pool2d_backward_bf16"] = steps
    return {name: want.get(name, 0) for name in KERNEL_COUNTERS}


# The O1 ResNet step against the CPU's plain path, each limit between two
# readings on an H100 (the bf16 step / the f32 step, which must fail it):
# the loss (0.0060 / 0.1216) and the share of the gradient's entries (not 0
# on both sides) that differ in any bit (0.9932 / 1.0000). At batch 2 this
# random-init ResNet-50's logits reach ~5,000 and its batch norms see 98
# values a channel in layer4: any two bf16 runs part in the gradient about
# as far as bf16 is from f32 (relative L2 1.15 / 1.33), so the gradient's
# relative L2 error is only a gross-fault limit.
RN_AMP_LOSS_ATOL = 3e-2
RN_AMP_GRAD_DIFFERING = 0.997
RN_AMP_GRAD_REL_L2 = 2.0


def rn_amp_train_parity():
    """One Momentum step of ResNet-50 under ``auto_cast`` (O1) at batch 2 x
    224 x 224, ``FLAGS_use_pallas_pool_bwd`` on (the caller sets it), on
    the card and on the CPU's plain path from the same weights; the f32
    step on the card as the control the limit must catch. Returns the
    readings."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _resnet50(seed=2)
    cpu_model, control = copy.deepcopy(model), copy.deepcopy(model)
    rng = np.random.RandomState(16)
    batch = [rng.randn(2, 3, RN_HW, RN_HW).astype(np.float32),
             rng.randint(0, RN_CLASSES, (2,)).astype(np.int64)]
    t0 = time.perf_counter()
    cpu_loss = float(_rn_step_of(cpu_model, device="cpu", loss_fn=_rn_amp_loss)(*batch)["loss"])
    cpu_s = time.perf_counter() - t0
    control_loss = float(_rn_step_of(control)(*batch)["loss"])
    reset_launch_counts()
    loss = float(_rn_step_of(model, loss_fn=_rn_amp_loss)(*batch)["loss"])
    counts = launch_counts()
    want = _rn_amp_step_launches(1)
    if counts != want:
        raise AssertionError(f"ResNet AMP parity step launched {counts}; want {want}")
    l2, differ, worst = _grad_l2(model, cpu_model)
    c_l2, c_differ, c_worst = _grad_l2(control, cpu_model)
    equal = sorted(((int((p.grad.cpu() == q.grad).sum()), n) for (n, p), (_, q) in
                    zip(model.named_parameters(), cpu_model.named_parameters())), reverse=True)
    r = {"loss": loss, "cpu_loss": cpu_loss, "loss_err": abs(loss - cpu_loss),
         "grad_rel_l2": l2, "grad_differing": differ, "worst_entry": worst,
         "control_loss_err": abs(control_loss - cpu_loss), "control_grad_rel_l2": c_l2,
         "control_grad_differing": c_differ, "control_worst_entry": c_worst, "cpu_step_s": cpu_s,
         "buffer_rel_err": _buffer_errors(model, cpu_model),
         "control_buffer_rel_err": _buffer_errors(control, cpu_model),
         "most_equal_entries": equal[:5],
         "limits": {"loss": RN_AMP_LOSS_ATOL, "grad_rel_l2": RN_AMP_GRAD_REL_L2,
                    "grad_differing": RN_AMP_GRAD_DIFFERING}}
    log(f"ResNet AMP (O1) parity step: card loss {loss:.6f}, CPU (plain path, {cpu_s:.1f} s) "
        f"{cpu_loss:.6f}: loss err {r['loss_err']:.3g} (atol {RN_AMP_LOSS_ATOL}), gradient rel L2 "
        f"{l2:.3g} (limit {RN_AMP_GRAD_REL_L2}), entries differing {differ:.4f} (limit "
        f"{RN_AMP_GRAD_DIFFERING}), worst entry {worst[0]:.3g} of its layer's largest at "
        f"{worst[1]}, buffers {r['buffer_rel_err']}, bit-equal entries most in {equal[:5]}; f32 "
        f"control on the card: loss err {r['control_loss_err']:.3g}, gradient rel L2 "
        f"{c_l2:.3g}, entries differing {c_differ:.4f}, worst entry {c_worst[0]:.3g} at "
        f"{c_worst[1]}, buffers {r['control_buffer_rel_err']}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if not (np.isfinite(loss) and r["loss_err"] <= RN_AMP_LOSS_ATOL
            and l2 <= RN_AMP_GRAD_REL_L2 and differ <= RN_AMP_GRAD_DIFFERING):
        raise AssertionError(f"ResNet AMP parity step beyond its limits: {r}")
    if not (r["control_loss_err"] > RN_AMP_LOSS_ATOL and c_differ > RN_AMP_GRAD_DIFFERING):
        raise AssertionError(f"ResNet AMP: the f32 control passes the limits on the loss "
                             f"{RN_AMP_LOSS_ATOL} or on differing entries "
                             f"{RN_AMP_GRAD_DIFFERING}: {r}")
    return r


def train_resnet_amp():
    """bench.py's ResNet-50 step under ``auto_cast`` (O1): the parity step,
    then batch 128 x 224², Momentum lr 0.1, momentum 0.9,
    ``FLAGS_use_pallas_pool_bwd`` on, one fixed batch, ``RN_AMP_STEPS``
    timed steps whose losses must be finite and fall below the first, with
    exact launch counts (every fused conv kernel in bf16, none in float32;
    the bf16 pool backward once a step); the median step, images/s, peak
    memory; one profiled step by kernel kind, in which no fused conv
    product runs outside the bf16 kernel. Returns (launches over the timed
    steps, readings)."""
    import torch

    from paddle_tpu_torch.flags import set_flags

    set_flags({"use_pallas_pool_bwd": True})
    try:
        parity = rn_amp_train_parity()
        torch.cuda.empty_cache()
        model = _resnet50(seed=1)
        step = _rn_step_of(model, loss_fn=_rn_amp_loss)
        rng = np.random.RandomState(15)
        batch = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
                 torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
        losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, RN_AMP_STEPS)
        want = _rn_amp_step_launches(RN_AMP_STEPS)
        if counts != want:
            raise AssertionError(f"ResNet AMP {RN_AMP_STEPS} steps launched {counts}; want {want}")
        _rn_check_tensors(RN_AMP_STEPS, f"ResNet AMP {RN_AMP_STEPS} steps")
        if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
            raise AssertionError(f"ResNet AMP losses not finite or not falling: {losses}")
        median = float(np.median(step_ms))
        log(f"ResNet-50 AMP (O1) {RN_AMP_STEPS} steps at batch {RN_B} x {RN_HW}^2, Momentum lr "
            f"{RN_LR}, pool kernel on: losses {', '.join(f'{x:.6f}' for x in losses)}")
        log(f"ResNet-50 AMP step {float(np.mean(step_ms)):.2f} ms (median {median:.2f}, min "
            f"{min(step_ms):.2f}, max {max(step_ms):.2f}; host clock {wall_ms:.2f}), "
            f"{RN_B / median * 1e3:.1f} images/s at the median; peak device memory {peak:.1f} GiB; "
            f"launches a step { {k: v // RN_AMP_STEPS for k, v in counts.items() if v} }")
        prof = _profile_step(step, batch, "ResNet AMP train step profiled (pool kernel on)")
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    by_kind, events = _device_time_by_kind(prof)
    busy = sum(by_kind.values())
    if by_kind.get("conv_mm", 0.0) > 0 or not by_kind.get("conv_mm_bf16"):
        raise AssertionError(f"ResNet AMP step: fused conv products outside the bf16 kernel: "
                             f"{by_kind}")
    log(f"ResNet-50 AMP step: device busy {busy:.2f} ms in a profiled step, {busy / median:.1%} "
        f"of the median step")
    return counts, {"parity": parity, "step_ms_median": median, "step_ms": step_ms,
                    "images_per_s": RN_B / median * 1e3, "peak_gib": peak, "losses": losses,
                    "busy_ms": busy, "busy_share_of_median": busy / median,
                    "device_ms_by_kind": by_kind, "device_events": events}


# The eval forward under AMP against the CPU's plain path: max |logit error|
# over the largest |logit|, a gross-fault limit about 3x the reading on an
# H100 (0.0065); the f32 forward's error is logged beside it (0.0060): two
# bf16 forwards of 53 layers part about as far as bf16 is from f32, so it is
# no control a limit could reject
RN_AMP_SERVE_RTOL = 2e-2


def eval_resnet_amp():
    """One ResNet-50 eval forward under ``auto_cast`` at serving batch 32 on
    the card: 33 bf16 eval kernels (``mm_affine_relu_bf16``) and nothing
    else; its logits against the CPU's plain path under the same scope
    (the f32 forward's error logged beside); the forward's time. Returns
    the launches of the one forward and the readings."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    batch = RN_BUCKETS[-1]
    model = _resnet50(seed=0)
    model.eval()
    cpu_model = copy.deepcopy(model)
    x = np.random.RandomState(17).randn(batch, 3, RN_HW, RN_HW).astype(np.float32)
    with torch.no_grad(), amp.auto_cast():
        want = cpu_model(torch.from_numpy(x)).float()
    model.cuda()
    xc = torch.from_numpy(x).cuda()
    with torch.no_grad():
        with amp.auto_cast():
            reset_launch_counts()
            got = model(xc).float().cpu()
            counts = launch_counts()
        control = model(xc).float().cpu()
        with amp.auto_cast():
            ms = time_ms(model, [(xc,)] * 2, 10)
    wanted = {name: RN_TRIPLES if name == "conv_bn_relu_mm_affine_relu_bf16" else 0
              for name in counts}
    if counts != wanted:
        raise AssertionError(f"ResNet AMP eval forward launched {counts}; want {wanted}")
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"ResNet AMP eval logits {tuple(got.shape)} not finite or not "
                             f"{tuple(want.shape)}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    c_err = float((control - want).abs().max()) / scale
    log(f"ResNet-50 AMP eval forward, batch {batch}: logits err vs the CPU {err:.3g} of the "
        f"largest |logit| {scale:.4g} (limit {RN_AMP_SERVE_RTOL}; the f32 forward {c_err:.3g}); "
        f"{RN_TRIPLES} bf16 eval kernels; forward {ms:.3f} ms, {batch / ms * 1e3:.1f} images/s")
    if err > RN_AMP_SERVE_RTOL:
        raise AssertionError(f"ResNet AMP eval: err {err} beyond {RN_AMP_SERVE_RTOL}")
    return counts, {"logits_rel_err": err, "f32_forward_rel_err": c_err, "forward_ms": ms}


# -- the compiled step: captured CUDA graphs (runtime/compiled.py) -------------------

COMPILED_STEPS = 10  # timed steps of each of the eager and the captured step
PARITY_CALLS = 3  # the compiled step's eager first step and 2 replays
PARITY_SEED = 21
# BERT's AMP step does not repeat itself bit for bit on the card: torch's
# embedding backward over the position and token-type ids differs run to
# run, and two eager runs of 3 steps part in 80% of the weights. Its
# captured losses are held to an atol near the geometric mean of the
# captured reading and the stale-input control, read on an NVIDIA H100
# 80GB HBM3 at 700.00 W:
# captured 1.24e-3 and 9.6e-4 (eager against eager 1.19e-3 and 1.62e-3),
# stale 3.0
BERT_COMPILED_LOSS_ATOL = 5e-2
# AdamW's moments after the 3 calls, relative L2 distance captured/eager,
# by the same rule, read on the same card: captured 2.7e-3 (eager against
# eager 2.44e-3), stale 0.269
BERT_COMPILED_MOMENT_RTOL = 3e-2


@contextlib.contextmanager
def _recorded_draws():
    """Every random draw of the port (``framework.random.draw``: dropout
    masks, attention seeds) copied as it is made. Eager draws go to the
    list last appended to ``rec["eager"]``; the draws a capture records go
    to ``rec["graph"]`` as copies the graph itself makes, so after each
    replay they hold that replay's draws."""
    import torch

    from paddle_tpu_torch.framework import random as prandom

    rec = {"eager": [], "graph": []}
    orig = prandom.draw

    def recording(device, generator, fn):
        out = orig(device, generator, fn)
        if torch.cuda.is_current_stream_capturing():
            rec["graph"].append(out.clone())
        elif rec["eager"]:
            rec["eager"][-1].append(out.clone())
        return out

    prandom.draw = recording
    try:
        yield rec
    finally:
        prandom.draw = orig


def _snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def _differing(a, b):
    """Entries of two lists of tensors that differ in any bit."""
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def _same_draws(a, b):
    return len(a) == len(b) and all(torch_equal(x, y) for x, y in zip(a, b))


def torch_equal(x, y):
    import torch

    return x.shape == y.shape and bool(torch.equal(x, y))


# launch counter (ops/cuda KERNEL_COUNTERS, less a "_bf16") -> the kind its
# kernel has in a profile (_kernel_kind); the others are named alike
_COUNTER_KINDS = {"conv_bn_relu_mm_affine_relu": "conv_mm", "conv_bn_relu_mm_stats": "conv_mm",
                  "conv_bn_relu_centered_sumsq": "bn_reduce",
                  "conv_bn_relu_bn_bwd_partials": "bn_reduce",
                  "conv_bn_relu_bn_relu": "bn_elementwise",
                  "conv_bn_relu_bn_bwd_dco": "bn_elementwise", "momentum_update": "momentum",
                  "int8_matmul": "int8_mm", "max_pool2d_backward": "pool_bwd"}


def _counter_kind(name):
    base, bf16 = (name[:-len("_bf16")], "_bf16") if name.endswith("_bf16") else (name, "")
    return _COUNTER_KINDS.get(base, base) + bf16


def _booked_by_kind(counts):
    out = {}
    for name, n in counts.items():
        if n:
            kind = _counter_kind(name)
            out[kind] = out.get(kind, 0) + n
    return out


def _profiled_launches(prof):
    """Launches of the port's kernels that a profile saw run on the card, by
    kind: in a replayed graph too, where no wrapper counts. The f32 split-K
    reduce is the second kernel of one counted launch and is left out."""
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS

    ours = {_counter_kind(n) for n in KERNEL_COUNTERS}
    out = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or "conv_mm_reduce" in e.key:
            continue
        kind = _kernel_kind(e.key)
        if kind in ours:
            out[kind] = out.get(kind, 0) + e.count
    return out


def _check_profiled_launches(prof, booked, label):
    """The port's kernels the profile saw run equal, kind by kind, the
    launches the wrappers and the store booked over the same call (a graph
    that dropped or repeated a launch would part them). Returns the
    profile's counts."""
    seen, want = _profiled_launches(prof), _booked_by_kind(booked)
    if seen != want or not seen:
        raise AssertionError(f"{label}: the profile saw the port's kernels run {seen}; "
                             f"the counters booked {want}")
    return seen


def _rel_l2(a, b):
    """Relative L2 distance of two lists of tensors, over all their
    entries (float64 sums)."""
    num = sum(float((x.double() - y.double()).square().sum()) for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return (num / den) ** 0.5 if den else float(num > 0)


def compiled_parity(make_model, make_step, batches, label, lr, draws, loss_atol,
                    moment_rtol):
    """From identical weights and generator state, ``PARITY_CALLS`` calls on
    the batches ``b0, b1, b0`` of: the compiled step (its eager first step,
    then replays); the same calls run eagerly (``TrainStepFn.eager``: the
    same arithmetic, no graph); those eager calls once more (the repeat:
    whether eager repeats itself bit for bit); and eager calls on ``b0``
    three times (the stale-input control: what a replay that missed its
    new batch would compute). Where the repeat is bit-exact the captured
    losses and weights must equal the eager ones bit for bit; else each
    captured loss must lie within ``loss_atol`` of the eager one, and the
    stale control beyond it. The optimizer's accumulators (AdamW's
    moments, Momentum's velocities) are held the same way (bit for bit, or
    a relative L2 distance within ``moment_rtol`` with the stale control
    beyond it), and every run's host and device step counts must both be
    ``PARITY_CALLS`` (a graph that froze the step count would leave the
    device's behind). With ``draws``, every random draw of the
    captured calls must equal the eager step's and every draw of the second
    replay differ from the first's (a frozen seed would repeat it). Then a
    replay at lr 0 must leave every weight bit-identical and one at ``lr``
    move them (a frozen lr would not). Returns the readings."""
    from paddle_tpu_torch.framework import random as prandom

    base = make_model()
    order = (batches[0], batches[1], batches[0])
    runs = {}
    with _recorded_draws() as rec:
        for name in ("captured", "eager", "repeat", "stale"):
            model = copy.deepcopy(base)
            step = make_step(model)
            prandom.seed(PARITY_SEED)
            losses, step_draws, grads = [], [], None
            for i in range(PARITY_CALLS):
                rec["eager"].append([])
                b = batches[0] if name == "stale" else order[i]
                out = step(*b) if name == "captured" else step.eager(*b)
                losses.append(float(out["loss"]))
                step_draws.append([g.clone() for g in rec["graph"]]
                                  if name == "captured" and i else rec["eager"][-1])
                if i == 0 and name in ("eager", "repeat"):
                    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt = step.optimizer
            runs[name] = {"losses": losses, "params": _snapshot(model), "grads": grads,
                          "moments": [a.clone() for accs in opt._accumulators.values()
                                      for a in accs],
                          "step_count": (opt._global_step, int(opt._step_t)),
                          "draws": step_draws if draws and name in ("captured", "eager")
                          else None}
            rec["graph"].clear()
            rec["eager"].clear()
            if name == "captured":
                runs[name].update(step=step, model=model)
            del step, model
    cap, eag, rep, stale = (runs.pop(k) for k in ("captured", "eager", "repeat", "stale"))
    entries = cap["step"].store.entries()
    r = {"losses_captured": cap["losses"], "losses_eager": eag["losses"],
         "losses_repeat": rep["losses"], "losses_stale": stale["losses"],
         "loss_err": max(abs(a - b) for a, b in zip(cap["losses"], eag["losses"])),
         "repeat_loss_err": max(abs(a - b) for a, b in zip(rep["losses"], eag["losses"])),
         "stale_loss_err": abs(stale["losses"][1] - eag["losses"][1]),
         "loss_atol": loss_atol,
         "params_differing": _differing(cap["params"], eag["params"]),
         "repeat_params_differing": _differing(rep["params"], eag["params"]),
         "params": sum(int(p.numel()) for p in cap["params"]),
         "step_counts": {"captured": cap["step_count"], "eager": eag["step_count"]},
         "moments_differing": _differing(cap["moments"], eag["moments"]),
         "repeat_moments_differing": _differing(rep["moments"], eag["moments"]),
         "moments": sum(int(a.numel()) for a in cap["moments"]),
         "moment_err": _rel_l2(cap["moments"], eag["moments"]),
         "repeat_moment_err": _rel_l2(rep["moments"], eag["moments"]),
         "stale_moment_err": _rel_l2(stale["moments"], eag["moments"]),
         "moment_rtol": moment_rtol,
         "repeat_first_grads_differing": sorted(
             n for n in eag["grads"] if not torch_equal(eag["grads"][n], rep["grads"][n])),
         "store": {"entries": len(entries), "hits": cap["step"].store.hits,
                   "misses": cap["step"].store.misses,
                   "cache_keys": [e.cache_key for e in entries.values()]}}
    repeat_exact = r["repeat_loss_err"] == 0 and r["repeat_params_differing"] == 0
    if draws:
        r["draws_a_step"] = len(eag["draws"][0])
        r["draws_equal_eager"] = [_same_draws(c, e) for c, e in zip(cap["draws"], eag["draws"])]
        r["replay_draws_differing"] = sum(not torch_equal(a, b) for a, b in
                                          zip(cap["draws"][1], cap["draws"][2]))
    eag = rep = stale = None
    step, model = cap["step"], cap["model"]
    before = _snapshot(model)
    step.optimizer.set_lr(0.0)
    step(*batches[0])
    r["lr0_params_differing"] = _differing(before, _snapshot(model))
    step.optimizer.set_lr(lr)
    step(*batches[0])
    r["lr_params_differing"] = _differing(before, _snapshot(model))
    log(f"{label} parity, calls on b0, b1, b0 from one state: losses captured "
        f"{r['losses_captured']}, eager {r['losses_eager']}, eager repeat "
        f"{r['losses_repeat']}, stale (b0 thrice) {r['losses_stale']}; loss err captured/eager "
        f"{r['loss_err']:.3g}, repeat/eager {r['repeat_loss_err']:.3g}, stale/eager "
        f"{r['stale_loss_err']:.3g} (atol {loss_atol}); weights differing captured/eager "
        f"{r['params_differing']}, repeat/eager {r['repeat_params_differing']} of "
        f"{r['params']}; first-step gradients differing repeat/eager "
        f"{len(r['repeat_first_grads_differing'])}: {r['repeat_first_grads_differing'][:12]}; "
        f"draws equal to the eager step's {r.get('draws_equal_eager')}, differing between "
        f"replays {r.get('replay_draws_differing')} of {r.get('draws_a_step')}; a replay at lr 0 "
        f"moved {r['lr0_params_differing']} weights, one at lr {lr} "
        f"{r['lr_params_differing']}; store {r['store']}; step counts (host, device) "
        f"{r['step_counts']}; accumulator entries differing captured/eager "
        f"{r['moments_differing']}, repeat/eager {r['repeat_moments_differing']} of "
        f"{r['moments']}, relative L2 captured/eager {r['moment_err']:.3g}, repeat/eager "
        f"{r['repeat_moment_err']:.3g}, stale/eager {r['stale_moment_err']:.3g} "
        f"(rtol {moment_rtol})")
    if draws and (not all(r["draws_equal_eager"]) or not r["draws_a_step"]):
        raise AssertionError(f"{label}: the captured step's random draws differ from the "
                             f"eager step's from the same generator state: {r}")
    if draws and r["replay_draws_differing"] != r["draws_a_step"]:
        raise AssertionError(f"{label}: only {r['replay_draws_differing']} of "
                             f"{r['draws_a_step']} draws differ between consecutive replays: "
                             "a frozen seed")
    if r["lr0_params_differing"] != 0 or r["lr_params_differing"] == 0:
        raise AssertionError(f"{label}: the replayed lr is frozen: {r}")
    if repeat_exact and (r["loss_err"] or r["params_differing"]):
        raise AssertionError(f"{label}: the captured steps part from the eager ones, which "
                             f"repeat themselves bit for bit: {r}")
    if not repeat_exact and not r["loss_err"] <= loss_atol < r["stale_loss_err"]:
        raise AssertionError(f"{label}: captured loss err {r['loss_err']} or the stale "
                             f"control's {r['stale_loss_err']} against atol {loss_atol}: {r}")
    if r["stale_loss_err"] == 0:
        raise AssertionError(f"{label}: the stale-input control equals the eager run: {r}")
    if set(r["step_counts"].values()) != {(PARITY_CALLS, PARITY_CALLS)}:
        raise AssertionError(f"{label}: host and device step counts {r['step_counts']} after "
                             f"{PARITY_CALLS} calls")
    if repeat_exact and r["moments_differing"]:
        raise AssertionError(f"{label}: {r['moments_differing']} optimizer accumulator entries "
                             "part from the eager run's, which repeats itself bit for bit")
    if not repeat_exact and not r["moment_err"] <= moment_rtol < r["stale_moment_err"]:
        raise AssertionError(f"{label}: accumulators' relative L2 distance captured/eager "
                             f"{r['moment_err']}, stale control {r['stale_moment_err']}, "
                             f"against {moment_rtol}")
    return r


def _step_device_ms(step, batch, iters=COMPILED_STEPS):
    """Device ms a step with the host hidden behind a sleep kernel
    (:func:`device_ms`), and its host ms."""
    return device_ms(lambda: step(*batch), iters)


def compiled_timing(make_model, make_step, batch, label, units, unit_name):
    """The eager step (``jit=False``) and the compiled one (``jit=True``)
    from the same weights, ``COMPILED_STEPS`` timed steps each after a first
    step (the compiled one's eager first step and capture): median step,
    host clock, device busy in a profiled step, device time with the host
    hidden, peak memory, launch counts a step, which must be equal, and
    the port's kernels a profiled step saw run, which must equal what its
    counters booked. Returns (the captured run's launches, readings)."""
    import torch

    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    out = {}
    for name, jit in (("eager", False), ("captured", True)):
        torch.cuda.empty_cache()
        model = make_model()
        step = make_step(model, jit)
        prandom.seed(PARITY_SEED)
        losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, COMPILED_STEPS)
        # a profile that parts from the booking is taken again, as in
        # _profile_run: the tracer now and then misses one of a step's first
        # kernels; a step that dropped or repeated a launch parts every time
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            reset_launch_counts()
            prof = _profile_step(step, batch, f"{label} {name} step profiled")
            try:
                profiled = _check_profiled_launches(prof, launch_counts(), f"{label} {name}")
                break
            except AssertionError as e:
                if attempt == PROFILE_ATTEMPTS:
                    raise
                log(f"{label} {name}: profile {attempt} of {PROFILE_ATTEMPTS} parts from the "
                    f"booking, taken again: {e}")
        by_kind, events = _device_time_by_kind(prof)
        dev_ms, host_ms = _step_device_ms(step, batch)
        median = float(np.median(step_ms))
        out[name] = {"losses": losses, "step_ms": step_ms, "step_ms_median": median,
                     "host_clock_ms": wall_ms, "busy_ms": sum(by_kind.values()),
                     "device_ms_by_kind": by_kind,
                     "device_events": events, "device_ms_host_hidden": dev_ms,
                     "host_ms_a_call": host_ms, "peak_gib": peak,
                     f"{unit_name}_per_s": units / median * 1e3,
                     "launches_a_step": {k: v // COMPILED_STEPS for k, v in counts.items() if v},
                     "launches_profiled": profiled, "counts": counts}
        if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
            raise AssertionError(f"{label} {name}: losses not finite or not falling: {losses}")
        log(f"{label} {name} (jit={jit}): {COMPILED_STEPS} steps, median {median:.3f} ms "
            f"(mean {float(np.mean(step_ms)):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}; "
            f"host clock {wall_ms:.3f}), {units / median * 1e3:.1f} {unit_name}/s; device busy "
            f"{out[name]['busy_ms']:.3f} ms in {events} device events of a profiled step; "
            f"{dev_ms:.3f} device ms a step with the host hidden ({host_ms:.3f} host ms a "
            f"call); peak {peak:.2f} GiB; launches a step {out[name]['launches_a_step']}, seen "
            f"run by the profiler {profiled}")
        del model, step, prof
    if out["captured"]["counts"] != out["eager"]["counts"]:
        raise AssertionError(f"{label}: the captured steps launched {out['captured']['counts']}, "
                             f"the eager ones {out['eager']['counts']}")
    counts = out["captured"].pop("counts")
    out["eager"].pop("counts")
    return counts, out


def compiled_bert_amp():
    """bench.py's BERT-base step under ``auto_cast`` (O1, batch 32 x L=512,
    80 masked a row, dropout 0.1, AdamW lr 1e-4) through
    ``train_step(jit=True)``: the parity calls with their draws, then the
    eager and the captured step side by side. Returns (the captured run's
    launches, readings)."""
    import torch

    from paddle_tpu_torch.models import bert_base_config

    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    base, loss_fn = _pretraining(cfg, seed=1)
    loss_fn = _amp_loss_fn(loss_fn, "O1")
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]

    def make_model():
        return copy.deepcopy(base)

    other = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(10))]
    parity = compiled_parity(make_model, lambda m: _step_of(m, loss_fn, jit=True),
                             (batch, other), "BERT AMP compiled step", 1e-4, draws=True,
                             loss_atol=BERT_COMPILED_LOSS_ATOL,
                             moment_rtol=BERT_COMPILED_MOMENT_RTOL)
    torch.cuda.empty_cache()
    counts, timing = compiled_timing(make_model, lambda m, jit: _step_of(m, loss_fn, jit=jit),
                                     batch, "BERT AMP", TRAIN_B * TRAIN_SEQ, "tokens")
    want = _amp_launches("O1", cfg.num_hidden_layers, COMPILED_STEPS)
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"BERT AMP compiled: {counts}; want {want}")
    return counts, {"parity": parity, **timing}


def compiled_resnet_amp():
    """bench.py's ResNet-50 step under ``auto_cast`` (O1, batch 128 x 224²,
    Momentum lr 0.1 / 0.9, the pool kernel on) through
    ``train_step(jit=True)``: the parity calls, then the eager and the
    captured step side by side. Returns (the captured run's launches,
    readings)."""
    import torch

    from paddle_tpu_torch.flags import set_flags

    rng = np.random.RandomState(15)
    batch = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
             torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
    base = _resnet50(seed=1)
    set_flags({"use_pallas_pool_bwd": True})
    try:
        other = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
                 torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
        parity = compiled_parity(
            lambda: copy.deepcopy(base),
            lambda m: _rn_step_of(m, loss_fn=_rn_amp_loss, jit=True), (batch, other),
            "ResNet-50 AMP compiled step", RN_LR, draws=False, loss_atol=0.0, moment_rtol=0.0)
        torch.cuda.empty_cache()
        counts, timing = compiled_timing(
            lambda: copy.deepcopy(base),
            lambda m, jit: _rn_step_of(m, loss_fn=_rn_amp_loss, jit=jit), batch, "ResNet-50 AMP",
            RN_B, "images")
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    if counts != _rn_amp_step_launches(COMPILED_STEPS):
        raise AssertionError(f"ResNet AMP compiled: {counts}")
    return counts, {"parity": parity, **timing}


COMPILED_EVAL_BATCHES = (1, 8)
COMPILED_EVAL_CALLS = 20


def compiled_eval_resnet_amp():
    """``eval_step`` of ResNet-50 under ``auto_cast`` at batch 1 and 8 (the
    bf16 eval kernel with split-K, row 8d): the captured forward bit-equal
    to the eager one (``jit=False``), with the same launches and split-K
    calls a forward, and the launches a profiled forward saw run equal to
    the booked ones; wall a call (host clock to the answer on the card)
    against the device's busy time. Returns (the captured forwards'
    launches, readings)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework.jit import eval_step
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS, launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.cuda import counts as all_counts

    def forward(m, x):
        with amp.auto_cast():
            return m(x)

    model = _resnet50(seed=0)
    total, out = {}, {}
    for batch in COMPILED_EVAL_BATCHES:
        x = torch.from_numpy(np.random.RandomState(18 + batch).randn(
            batch, 3, RN_HW, RN_HW).astype(np.float32)).cuda()
        steps = {"eager": eval_step(model, forward, jit=False),
                 "captured": eval_step(model, forward, jit=True)}
        r = {}
        steps["captured"](x)  # the eager first run and the capture
        for name, step in steps.items():
            step(x)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = step(x)
            torch.cuda.synchronize()
            counts = all_counts()
            t0 = time.perf_counter()
            for _ in range(COMPILED_EVAL_CALLS):
                step(x)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / COMPILED_EVAL_CALLS
            label = f"ResNet AMP eval_step batch {batch} {name}"
            for attempt in range(1, PROFILE_ATTEMPTS + 1):  # as _profile_run
                reset_launch_counts()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    _tracer_warmup()
                    step(x)
                    torch.cuda.synchronize()
                try:
                    profiled = _check_profiled_launches(prof, launch_counts(), label)
                    break
                except AssertionError as err:
                    if attempt == PROFILE_ATTEMPTS:
                        raise
                    log(f"{label}: profile {attempt} of {PROFILE_ATTEMPTS} parts from the "
                        f"booking, taken again: {err}")
            by_kind, events = _device_time_by_kind(prof)
            r[name] = {"logits": got, "counts": counts, "wall_ms": wall,
                       "busy_ms": sum(by_kind.values()), "device_events": events,
                       "launches_profiled": profiled}
        e, c = r["eager"], r["captured"]
        if c["counts"] != e["counts"] or e["counts"]["conv_bn_relu_mm_affine_relu_bf16"] != \
                RN_TRIPLES:
            raise AssertionError(f"ResNet AMP eval_step batch {batch}: captured launched "
                                 f"{c['counts']}, eager {e['counts']}")
        if not torch.equal(c["logits"], e["logits"]) or not torch.isfinite(c["logits"]).all():
            raise AssertionError(f"ResNet AMP eval_step batch {batch}: the captured logits differ "
                                 "from the eager ones or are not finite")
        splits = c["counts"]["conv_bn_relu.MM_AFFINE_RELU_SPLITS"]
        out[f"batch_{batch}"] = {n: {k: v for k, v in r[n].items() if k not in ("logits",
                                                                                "counts")}
                                 for n in r}
        out[f"batch_{batch}"]["split_k_products"] = splits
        log(f"ResNet-50 AMP eval_step batch {batch}: captured logits bit-equal to eager, "
            f"{RN_TRIPLES} bf16 eval launches ({splits} split-K) a forward in both; wall a call "
            f"eager {e['wall_ms']:.3f} ms, captured {c['wall_ms']:.3f} ms; device busy eager "
            f"{e['busy_ms']:.3f} ms ({e['device_events']} events), captured "
            f"{c['busy_ms']:.3f} ms ({c['device_events']} events)")
        for k in KERNEL_COUNTERS:  # the one replayed forward's
            total[k] = total.get(k, 0) + c["counts"][k]
        del steps, r
    return total, out


def check_capture_refusals():
    """On the card nothing gives way to eager: a step that draws from a
    generator its capture did not register raises ``CaptureError`` after
    its one real first step, and the next call raises before it runs
    anything, with no graph stored and the weights as that first step left
    them; a ``GradScaler`` inside a compiled step raises. Returns the
    readings."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.runtime.compiled import CaptureError

    own = torch.Generator(device="cuda").manual_seed(3)
    model = torch.nn.Linear(64, 64)

    def loss_fn(m, x):
        return F.dropout(m(x), 0.5, generator=own).square().mean()

    step = train_step(model, Momentum(learning_rate=0.1, parameters=model.parameters()),
                      loss_fn)
    x = torch.randn(8, 64, device="cuda")
    errors, weights = [], []
    for _ in range(2):
        try:
            step(x)
        except CaptureError as e:
            errors.append(str(e)[:200])
        else:
            raise AssertionError("a step drawing from an unregistered generator was captured")
        torch.cuda.synchronize()
        weights.append(_snapshot(model))
    opt = step.optimizer
    if (len(step.store) or (opt._global_step, int(opt._step_t)) != (1, 1)
            or _differing(*weights) or "failed before" not in errors[1]):
        raise AssertionError(f"after a refused capture and a second call: {len(step.store)} "
                             f"graphs, step counts {opt._global_step} and {int(opt._step_t)} "
                             f"(want 0, 1 and 1), {_differing(*weights)} weights moved by the "
                             f"second call; errors {errors}")
    scaler = amp.GradScaler()

    def scaled(m, x):
        scaler.unscale_(step.optimizer)
        return m(x).square().mean()

    try:
        train_step(model, step.optimizer, scaled)(x)
    except RuntimeError as e:
        scaler_error = str(e)[:200]
    else:
        raise AssertionError("GradScaler ran inside a compiled step")
    log(f"capture refusals: unregistered generator -> {errors[0]}; its second call -> "
        f"{errors[1]}; GradScaler -> {scaler_error}")
    return {"unregistered_generator": errors, "grad_scaler": scaler_error}


FEATURE_WIDTH, FEATURE_ROWS, FEATURE_DROPOUT = 1024, 256, 0.1


def compiled_features():
    """``grad_accum_steps=2`` (two captured variants, accumulate and
    accumulate + apply, sharing one buffer) and ``recompute=True``
    (``torch.utils.checkpoint`` with the port's draws taped) captured on
    the card: an MLP with dropout drawn through the port, AdamW lr 1e-3,
    calls on ``b0, b1, b0, b1`` from one state and generator seed, the
    captured step's losses, weights, moments and draws held bit for bit
    against the same calls run eagerly (``TrainStepFn.eager``), its step
    counts against the calls that applied the optimizer, and its draws new
    at each replay. Returns the readings."""
    import torch

    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    torch.manual_seed(5)
    base = torch.nn.Sequential(torch.nn.Linear(FEATURE_WIDTH, FEATURE_WIDTH), torch.nn.ReLU(),
                               torch.nn.Linear(FEATURE_WIDTH, FEATURE_WIDTH)).cuda()

    def loss_fn(m, x, t):
        h = F.dropout(torch.relu(m[0](x)), FEATURE_DROPOUT)
        return (m[2](h) - t).square().mean()

    rng = np.random.RandomState(23)
    batches = [[torch.from_numpy(rng.randn(FEATURE_ROWS, FEATURE_WIDTH).astype(np.float32)).cuda()
                for _ in range(2)] for _ in range(2)]
    order = (batches[0], batches[1], batches[0], batches[1])
    out = {}
    # feature: (its arguments, the calls of the four that apply the optimizer,
    # the captured variants)
    for feature, (kw, applies, variants) in {
            "grad_accum_steps=2": (dict(grad_accum_steps=2), 2, 2),
            "grad_accum_steps=2 grad_accum_avg=False":
                (dict(grad_accum_steps=2, grad_accum_avg=False), 2, 2),
            "recompute=True": (dict(recompute=True), 4, 1)}.items():
        runs = {}
        with _recorded_draws() as rec:
            for name in ("captured", "eager"):
                model = copy.deepcopy(base)
                step = train_step(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                                  loss_fn, **kw)
                prandom.seed(PARITY_SEED)
                losses, draws = [], []
                for i, b in enumerate(order):
                    rec["eager"].append([])
                    out_i = step(*b) if name == "captured" else step.eager(*b)
                    losses.append(float(out_i["loss"]))
                    torch.cuda.synchronize()
                    if name == "eager" or i < variants:  # a first run: eager draws
                        draws.append(rec["eager"][-1])
                    else:  # the draws the replayed graph (one of variants) recorded
                        per = len(rec["graph"]) // variants
                        v = i % variants
                        draws.append([g.clone() for g in rec["graph"][v * per:(v + 1) * per]])
                opt = step.optimizer
                runs[name] = {"losses": losses, "params": _snapshot(model), "draws": draws,
                              "moments": [a.clone() for accs in opt._accumulators.values()
                                          for a in accs],
                              "step_count": (opt._global_step, int(opt._step_t)),
                              "graphs": len(step.store)}
                rec["graph"].clear()
                rec["eager"].clear()
                del step, model
        c, e = runs["captured"], runs["eager"]
        r = {"losses_captured": c["losses"], "losses_eager": e["losses"],
             "params_differing": _differing(c["params"], e["params"]),
             "moments_differing": _differing(c["moments"], e["moments"]),
             "draws_equal_eager": [_same_draws(a, b) for a, b in zip(c["draws"], e["draws"])],
             "draws_a_call": [len(d) for d in c["draws"]],
             "step_counts": {"captured": c["step_count"], "eager": e["step_count"]},
             "graphs": c["graphs"]}
        # the last call against the one two before: the same variant
        r["replay_draws_differing"] = sum(not torch_equal(a, b) for a, b in
                                          zip(c["draws"][-3], c["draws"][-1]))
        log(f"compiled {feature}: losses captured {c['losses']}, eager {e['losses']}; weights "
            f"differing {r['params_differing']}, moments differing {r['moments_differing']}; "
            f"draws a call {r['draws_a_call']}, equal to eager {r['draws_equal_eager']}, "
            f"differing between the last call and the one two before "
            f"{r['replay_draws_differing']}; step counts "
            f"(host, device) {r['step_counts']}; {r['graphs']} graphs")
        if (c["losses"] != e["losses"] or r["params_differing"] or r["moments_differing"]
                or not all(r["draws_equal_eager"]) or not all(r["draws_a_call"])
                or r["replay_draws_differing"] != r["draws_a_call"][-1]
                or set(r["step_counts"].values()) != {(applies, applies)}
                or r["graphs"] != variants):
            raise AssertionError(f"compiled {feature}: the captured calls part from the eager "
                                 f"ones: {r}")
        out[feature] = r
    return out


BIAS_T = 10000  # steps at which the card's bias correction is read


def bias_correction_on_card():
    """AdamW's compiled bias correction ``1 - beta**t`` on the card, as
    ``Adam._bias_corrections`` computes it there (``optimizer._bias_correction``:
    the power of the float32 ``beta`` widened and the int32 ``t`` in
    float64, rounded once to float32), for t = 1..``BIAS_T`` on 0-dim
    operands, as the optimizer's: it must equal the same formula on the CPU
    bit for bit at every t. Logs where it differs from the CPU's float32
    ``pow`` (the JAX compiled step's value) and by how many float32 ulps.
    Returns the readings."""
    import torch

    from paddle_tpu_torch.optimizer import _bias_correction

    out = {}
    t_card = list(torch.arange(1, BIAS_T + 1, dtype=torch.int32, device="cuda"))
    t_cpu = list(torch.arange(1, BIAS_T + 1, dtype=torch.int32))
    for beta in (0.9, 0.999):
        card = torch.stack([_bias_correction(beta, t) for t in t_card]).cpu()
        f64 = torch.stack([_bias_correction(beta, t) for t in t_cpu])
        b = torch.full((), beta, dtype=torch.float32)
        f32 = torch.stack([1 - b**t for t in t_cpu])  # 0-dim, as the CPU step's
        apart = (card != f64).nonzero().flatten()
        diff = (card != f32).nonzero().flatten()
        ulps = (np.abs(card.numpy().astype(np.float64) - f32.numpy())
                / np.spacing(np.abs(f32.numpy())))
        out[str(beta)] = {"t_differing_from_cpu_float64_route": int(apart.numel()),
                          "t_differing_from_cpu_float32_pow": int(diff.numel()), "of": BIAS_T,
                          "t_float32_pow": [int(i) + 1 for i in diff[:8]],
                          "max_ulps_float32_pow": float(ulps.max())}
        log(f"bias correction 1 - {beta}**t on the card, t = 1..{BIAS_T}: {out[str(beta)]}")
        if apart.numel():
            raise AssertionError(f"bias correction {beta}: the card parts from the CPU's float64 "
                                 f"route at t = {[int(i) + 1 for i in apart[:8]]}")
    return out


def compiled_steps():
    """Phase 12b. Returns (the captured runs' launches, readings)."""
    import torch

    torch.cuda.empty_cache()
    bert_counts, bert = compiled_bert_amp()
    torch.cuda.empty_cache()
    rn_counts, rn = compiled_resnet_amp()
    torch.cuda.empty_cache()
    eval_counts, ev = compiled_eval_resnet_amp()
    features = compiled_features()
    refusals = check_capture_refusals()
    bias = bias_correction_on_card()
    counts = {k: bert_counts.get(k, 0) + rn_counts.get(k, 0) + eval_counts.get(k, 0)
              for k in bert_counts}
    return counts, {"bert_amp": bert, "resnet_amp": rn, "resnet_amp_eval": ev,
                    "features": features, "refusals": refusals, "bias_correction": bias}


# -- Transformer-base seq2seq and ERNIE-base (BASELINE.json's fifth config) ----------

# Transformer-base (Vaswani et al. 2017): 512 wide, 8 heads, 6 + 6 layers, FFN
# 2048, dropout 0.1, over WMT14 En-De's shared 37,000-token vocabulary
S2S_VOCAB, S2S_D, S2S_HEADS, S2S_LAYERS, S2S_FFN, S2S_DROPOUT = 37000, 512, 8, 6, 2048, 0.1
S2S_B, S2S_SRC, S2S_TGT = 64, 64, 64  # pairs a step, source and target tokens a pair
S2S_ROWS = S2S_B * S2S_TGT  # the LayerNorm rows of the decoder: [4096, 512]
# the paper's schedule, NoamDecay(d_model=512, warmup_steps=4000, learning_rate=1.0),
# and ClipGradByGlobalNorm(1.0). The timed runs take the schedule up at step 1000
# (lr 1.75e-4, rising): from step 1 their 11 steps would run at 1.7e-7 to 1.9e-6,
# too little for the falling-loss check to see through dropout's noise.
S2S_WARMUP, S2S_CLIP, S2S_NOAM_START = 4000, 1.0, 1000
S2S_BOS, S2S_EOS, S2S_PAD = 0, 1, 2  # TransformerSeq2Seq's defaults
# post-norm residual LayerNorms a forward: 2 an encoder layer, 3 a decoder layer;
# under AMP the first of each stack adds a bf16 sublayer output to the f32
# embedding sum (the mixed forward, the f32 backward)
S2S_ENC_NORMS, S2S_DEC_NORMS = 2 * S2S_LAYERS, 3 * S2S_LAYERS
# The AMP step at batch 2 against the CPU's plain path under the same
# auto_cast, read on an NVIDIA H100 80GB HBM3 at 700.00 W: loss 1.6e-4
# apart, gradient rel L2 0.0139, 0.762 of the gradient entries differing in
# some bit; the f32 step (the control) 8.2e-5, 0.0197, 1.000. As for BERT
# the loss and L2 limits (about 6 and 2.5 times the reading) catch gross
# faults only; the share of differing entries is held near the geometric
# mean of the two readings, which the f32 control must fail. The f32
# teacher-forced logits read 1.4e-6 of the largest |logit| from the CPU's,
# TF32 (the control) 1.03e-3.
S2S_AMP_LIMITS = {"loss": 1e-3, "grad_rel_l2": 0.035}
S2S_AMP_GRAD_DIFFERING = 0.87
S2S_LOGITS_RTOL = 3e-5
# decoding: the card's greedy tokens, and the hypotheses each beam step
# keeps, must equal the CPU's at every step before the first whose CPU
# margin is under this: the top-two logits' gap (greedy), the gap between
# the last total kept and the first dropped (beam). It is ~700 times the
# f32 logits' card-vs-CPU error at batch 2 (1.4e-6 of the largest |logit|,
# PERF.md section 2) and ~10 times that error summed over 31 steps.
S2S_MARGIN = 1e-3
S2S_GREEDY_B, S2S_BEAM_B, S2S_BEAM, S2S_DECODE_LEN = 16, 4, 4, 32
# ERNIE-base at bench's BERT phase 2: batch 32 x 512, 80 masked a row
ERNIE_MASK_ID = 3  # ERNIE 1.0's [MASK]


def _seq2seq(seed, dropout=S2S_DROPOUT, device=None):
    """Transformer-base from ``seed``, drawn on ``device`` (the CPU by
    default) by a generator of that device."""
    import torch

    from paddle_tpu_torch.models import TransformerSeq2Seq

    return TransformerSeq2Seq(S2S_VOCAB, S2S_VOCAB, d_model=S2S_D, nhead=S2S_HEADS,
                              num_layers=S2S_LAYERS, dim_feedforward=S2S_FFN, dropout=dropout,
                              generator=torch.Generator(device or "cpu").manual_seed(seed),
                              device=device)


def s2s_batch(batch, rng):
    """A synthetic translation batch: source ids with seeded pad tails (at
    least half of each row real), the target fed in (BOS first) and the
    target to predict (EOS after the last real token, pads after that)."""
    src = rng.randint(3, S2S_VOCAB, (batch, S2S_SRC)).astype(np.int64)
    body = rng.randint(3, S2S_VOCAB, (batch, S2S_TGT)).astype(np.int64)
    tin = np.concatenate([np.full((batch, 1), S2S_BOS, np.int64), body[:, :-1]], axis=1)
    tout = body.copy()
    for i in range(batch):
        n = rng.randint(S2S_SRC // 2, S2S_SRC + 1)
        src[i, n:] = S2S_PAD
        t = rng.randint(S2S_TGT // 2, S2S_TGT + 1)
        tout[i, t - 1], tout[i, t:], tin[i, t:] = S2S_EOS, S2S_PAD, S2S_PAD
    return [src, tin, tout]


def _s2s_loss(m, src, tin, tout):
    """The pad-masked cross entropy of tests/test_book.py's WMT14 test."""
    from paddle_tpu_torch.nn import functional as F

    logits = m(src, tin)
    mask = (tout != S2S_PAD).float()
    ce = F.cross_entropy(logits.reshape(-1, S2S_VOCAB), tout.reshape(-1), reduction="none")
    return (ce * mask.reshape(-1)).sum() / mask.sum()


def _noam_lr(step, d_model=S2S_D, warmup=S2S_WARMUP, base=1.0):
    """``paddle_tpu/optimizer/lr.py`` ``NoamDecay.get_lr``, copied: the value
    the port's schedule must give at ``step``."""
    step = max(step, 1)
    return base * d_model**-0.5 * min(step**-0.5, step * warmup**-1.5)


class _NoamStep:
    """A train step under ``NoamDecay``: each call runs the step, keeps the
    lr the optimizer read (under ``jit=True`` a copy of the float32 on the
    card that the step wrote before its replay; else the host float) and the
    schedule's step, then advances the schedule."""

    def __init__(self, step, sched, record):
        self.step, self.sched = step, sched
        self.record = record  # {"lrs": [...], "epochs": [...], "store": ...}
        record.update(lrs=[], epochs=[], store=step.store)

    def __call__(self, *batch):
        out = self.step(*batch)
        opt = self.step.optimizer
        self.record["lrs"].append(opt._lr_t.clone() if self.step.jit else opt.get_lr())
        self.record["epochs"].append(self.sched.last_epoch)
        self.sched.step()
        return out


def _s2s_step_of(model, loss_fn, device=None, jit=False, start=0, record=None):
    """Adam(0.9, 0.98, 1e-9), the paper's moments, under
    ``NoamDecay(512, 4000, 1.0)`` from step ``start`` (0: the first) with
    ``ClipGradByGlobalNorm(1.0)``; ``record`` (a dict) receives the lrs
    (:class:`_NoamStep`)."""
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Adam, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.lr import NoamDecay

    sched = NoamDecay(d_model=S2S_D, warmup_steps=S2S_WARMUP, learning_rate=1.0,
                      last_epoch=start - 1)
    opt = Adam(learning_rate=sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
               parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(S2S_CLIP))
    step = train_step(model, opt, loss_fn, device=device, jit=jit)
    return _NoamStep(step, sched, {} if record is None else record)


def _check_noam(records):
    """The lr each step of the seq2seq runs read: eagerly the schedule's
    float, captured the float32 on the card equal to that float rounded to
    float32 (``_noam_lr``, the JAX package's formula), a new value at every
    step; and the captured run's store one graph, captured once. Returns
    the readings."""
    import torch

    out = {}
    for name, rec in records.items():
        want = [_noam_lr(e) for e in rec["epochs"]]
        if name == "captured":
            got = torch.stack(rec["lrs"]).cpu().numpy().tolist()
            want = [float(np.float32(w)) for w in want]
        else:
            got = rec["lrs"]
        store = rec["store"]
        if got != want or len(set(want)) != len(want):
            raise AssertionError(f"seq2seq {name}: the steps read lrs {got[:4]}...; the "
                                 f"schedule gives {want[:4]}...")
        if name == "captured" and (len(store) != 1 or store.misses != 1):
            raise AssertionError(f"seq2seq captured under Noam: {len(store)} graphs, "
                                 f"{store.misses} captures; want one of each")
        out[name] = {"steps": len(got), "first_lr": got[0], "last_lr": got[-1],
                     "schedule_steps": [rec["epochs"][0], rec["epochs"][-1]],
                     "graphs": len(store), "captures": store.misses}
    log(f"seq2seq under NoamDecay(512, 4000) from step {S2S_NOAM_START}: every step's lr "
        f"equals the schedule's ({out['captured']['steps']} captured steps read the float32 "
        f"on the card, {out['captured']['first_lr']:.6g} to {out['captured']['last_lr']:.6g}); "
        f"one graph, captured once")
    return out


def _s2s_launches(amp, steps=1, backward=True):
    """LayerNorm launches of ``steps`` seq2seq steps (forwards when not
    ``backward``): every residual norm of the encoder and decoder, in f32,
    or under AMP the mixed case at the first norm of each stack and bf16
    at the rest."""
    norms = S2S_ENC_NORMS + S2S_DEC_NORMS
    if amp:
        want = {"layernorm_residual_fwd_mixed": 2, "layernorm_residual_fwd_bf16": norms - 2}
        if backward:
            want.update(layernorm_residual_bwd=2, layernorm_residual_bwd_bf16=norms - 2)
    else:
        want = {"layernorm_residual_fwd": norms}
        if backward:
            want["layernorm_residual_bwd"] = norms
    return {k: v * steps for k, v in want.items()}


def check_layernorm_h512():
    """Rows 1, 1b, 2 and 2b at the seq2seq path's [4096, 512] (H = 512, the
    width no other path gives them): f32, bf16 and the mixed case (through
    the op, forward and backward), each with the existing limits, timed
    beside its bound and ``F.layer_norm``. Returns {kernel name: entry}."""
    out = {"layernorm_residual_fwd": check_layernorm("float32", S2S_ROWS, S2S_D),
           "layernorm_residual_fwd_bf16": check_layernorm("bfloat16", S2S_ROWS, S2S_D),
           "layernorm_residual_fwd_mixed": check_layernorm_mixed(S2S_ROWS, S2S_D),
           "layernorm_residual_bwd": check_layernorm_bwd("float32", S2S_ROWS, S2S_D),
           "layernorm_residual_bwd_bf16": check_layernorm_bwd("bfloat16", S2S_ROWS, S2S_D)}
    for e in out.values():
        e["path"] = "Transformer-base seq2seq"
    return out


def s2s_parity():
    """Transformer-base at dropout 0 and batch 2, from one set of weights:
    one f32 teacher-forced forward on the card against the CPU's (the
    logits relative to the largest; TF32 the control), and one AMP step
    (O1) on the card against the CPU's plain path under the same
    ``auto_cast`` (loss, the gradient's relative L2 and the share of its
    entries that differ in any bit; the f32 step the control), with the
    card's LayerNorm launches exact. Every reading is logged before a
    limit fails. Returns the readings."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _seq2seq(seed=0, dropout=0.0)
    batch = s2s_batch(2, np.random.RandomState(30))
    cpu_model = copy.deepcopy(model).eval()
    card_model = copy.deepcopy(model).cuda().eval()
    src, tin = (torch.from_numpy(a) for a in batch[:2])
    with torch.no_grad():
        t0 = time.perf_counter()
        want = cpu_model(src, tin)
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        got = card_model(src.cuda(), tin.cuda()).cpu()
        counts = {k: v for k, v in launch_counts().items() if v}
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = card_model(src.cuda(), tin.cuda()).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    scale = float(want.abs().max())
    r = {"logits_rel_err": float((got - want).abs().max()) / scale,
         "tf32_logits_rel_err": float((tf32 - want).abs().max()) / scale,
         "logits_rtol": S2S_LOGITS_RTOL, "cpu_forward_s": cpu_s}
    if counts != _s2s_launches(False, backward=False):
        raise AssertionError(f"seq2seq f32 forward launched {counts}")
    del card_model
    control = copy.deepcopy(model)
    control_loss = float(_s2s_step_of(control, _s2s_loss)(*batch)["loss"])
    amp_loss = _amp_loss_fn(_s2s_loss, "O1")
    cpu = copy.deepcopy(model)
    t0 = time.perf_counter()
    cpu_loss = float(_s2s_step_of(cpu, amp_loss, device="cpu")(*batch)["loss"])
    r["cpu_amp_step_s"] = time.perf_counter() - t0
    card = copy.deepcopy(model)
    reset_launch_counts()
    loss = float(_s2s_step_of(card, amp_loss)(*batch)["loss"])
    amp_counts = {k: v for k, v in launch_counts().items() if v}
    l2, differ, worst = _grad_l2(card, cpu)
    c_l2, c_differ, c_worst = _grad_l2(control, cpu)
    r.update(loss=loss, cpu_loss=cpu_loss, loss_err=abs(loss - cpu_loss), grad_rel_l2=l2,
             grad_differing=differ, worst_entry=worst,
             control_loss_err=abs(control_loss - cpu_loss), control_grad_rel_l2=c_l2,
             control_grad_differing=c_differ, control_worst_entry=c_worst,
             limits=dict(S2S_AMP_LIMITS, grad_differing=S2S_AMP_GRAD_DIFFERING),
             launches=amp_counts)
    log(f"seq2seq parity at batch 2: f32 logits rel err {r['logits_rel_err']:.3g} (rtol "
        f"{S2S_LOGITS_RTOL}; TF32 control {r['tf32_logits_rel_err']:.3g}; CPU forward "
        f"{cpu_s:.1f} s); AMP O1 step: card loss {loss:.6f}, CPU {cpu_loss:.6f} "
        f"({r['cpu_amp_step_s']:.1f} s): loss err {r['loss_err']:.3g}, gradient rel L2 "
        f"{l2:.3g}, entries differing {differ:.4f}, worst entry {worst[0]:.3g} at {worst[1]}; "
        f"f32 control: loss err {r['control_loss_err']:.3g}, rel L2 {c_l2:.3g}, differing "
        f"{c_differ:.4f}; launches {amp_counts}")
    if amp_counts != _s2s_launches(True):
        raise AssertionError(f"seq2seq AMP parity step launched {amp_counts}; want "
                             f"{_s2s_launches(True)}")
    if not r["logits_rel_err"] <= S2S_LOGITS_RTOL < r["tf32_logits_rel_err"]:
        raise AssertionError(f"seq2seq f32 logits: {r['logits_rel_err']} (TF32 control "
                             f"{r['tf32_logits_rel_err']}) against rtol {S2S_LOGITS_RTOL}")
    lim = S2S_AMP_LIMITS
    if not (np.isfinite(loss) and r["loss_err"] <= lim["loss"]
            and l2 <= lim["grad_rel_l2"] and differ <= S2S_AMP_GRAD_DIFFERING):
        raise AssertionError(f"seq2seq AMP parity step beyond its limits: {r}")
    if not c_differ > S2S_AMP_GRAD_DIFFERING:
        raise AssertionError(f"seq2seq AMP: the f32 control passes the limit on differing "
                             f"entries {S2S_AMP_GRAD_DIFFERING}: {r}")
    return r


def train_seq2seq_amp():
    """Phase 12c. Transformer-base (37,000-token vocabulary, dropout 0.1)
    trained under ``auto_cast`` (O1) at 64 pairs x 64 + 64 tokens with
    Adam(0.9, 0.98, 1e-9) under ``NoamDecay(512, 4000)`` with
    ``ClipGradByGlobalNorm(1.0)``, the pad-masked cross entropy, through
    ``train_step``: the parity checks at batch 2, then 10 eager steps and
    10 captured ones (``jit=True``: the eager first step, then replays) from
    one set of weights, each launching exactly 30 residual LayerNorms
    forward and backward (2 mixed), every step's lr the schedule's (on the
    card its float32) with one capture. Returns (eager launches, captured
    launches, readings)."""
    import torch

    parity = s2s_parity()
    torch.cuda.empty_cache()
    base = _seq2seq(seed=1)
    batch = [torch.from_numpy(a).cuda() for a in s2s_batch(S2S_B, np.random.RandomState(31))]
    loss_fn = _amp_loss_fn(_s2s_loss, "O1")
    records = {"eager": {}, "captured": {}}
    counts, timing = compiled_timing(
        lambda: copy.deepcopy(base),
        lambda m, jit: _s2s_step_of(m, loss_fn, jit=jit, start=S2S_NOAM_START,
                                    record=records["captured" if jit else "eager"]),
        batch, "seq2seq AMP", S2S_B * S2S_TGT, "target_tokens")
    noam = _check_noam(records)
    del records
    want = _s2s_launches(True, COMPILED_STEPS)
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"seq2seq AMP: {COMPILED_STEPS} steps launched {counts}; want "
                             f"{want}")
    eager = {k: v * COMPILED_STEPS for k, v in timing["eager"]["launches_a_step"].items()}
    real = int((batch[2] != S2S_PAD).sum())
    for run in timing.values():
        run["busy_share"] = run["busy_ms"] / run["step_ms_median"]
        run["real_target_tokens_per_s"] = real / run["step_ms_median"] * 1e3
    log(f"seq2seq AMP: {real} of {S2S_B * S2S_TGT} target positions real; median step eager "
        f"{timing['eager']['step_ms_median']:.3f} ms, captured "
        f"{timing['captured']['step_ms_median']:.3f} ms (busy share "
        f"{timing['captured']['busy_share']:.1%}); device ms by kind, captured: "
        f"{ {k: round(v, 3) for k, v in timing['captured']['device_ms_by_kind'].items()} }")
    return eager, counts, {"parity": parity, **timing, "real_target_tokens": real,
                           "noam": noam}


def _greedy_margins(model, src, ys):
    """The CPU model's top-two margin of the logits that chose each of
    ``ys``' tokens after BOS, ``[B, T - 1]``."""
    import torch

    with torch.no_grad():
        logits = model.decode_logits(model.encode(src), model._pad_mask(src), ys[:, :-1])
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


@contextlib.contextmanager
def _recorded_beam_steps():
    """Every ``beam_search_step`` the seq2seq model calls, recorded as
    (the top k + 1 flat totals, parents, tokens) on the host, the op itself
    unchanged."""
    import torch

    from paddle_tpu_torch.models import seq2seq as s2s
    from paddle_tpu_torch.ops import registry

    rec = []
    step = registry.kernel("beam_search_step")

    def recording(logp, scores, *, beam_size, first_step=False, **kw):
        out = step(logp, scores, beam_size=beam_size, first_step=first_step, **kw)
        b, k, v = logp.shape
        total = scores[:, :, None] + logp
        if first_step:
            total = torch.cat([total[:, :1], torch.full_like(total[:, 1:], float("-inf"))], 1)
        top = total.reshape(b, k * v).topk(beam_size + 1, dim=1).values
        rec.append((top.cpu(), out[1].cpu(), out[2].cpu()))
        return out

    orig = s2s.kernel
    s2s.kernel = lambda name: recording if name == "beam_search_step" else orig(name)
    try:
        yield rec
    finally:
        s2s.kernel = orig


def _beam_hypotheses(rec):
    """The hypotheses (token tuples) each recorded beam step keeps, as a
    sorted list a row: ``[rows][steps]``. Two runs that keep the same
    hypotheses in another slot order compare equal."""
    rows, k = rec[0][1].shape
    hyps = [[()] * k for _ in range(rows)]
    out = [[] for _ in range(rows)]
    for _, parent, token in rec:
        for r in range(rows):
            hyps[r] = [hyps[r][int(parent[r, j])] + (int(token[r, j]),) for j in range(k)]
            out[r].append(sorted(hyps[r]))
    return out


def _held(card, cpu, margins):
    """Positions (``[rows][positions]`` of comparable items) at which the
    card must agree with the CPU: in each row, every one before the first
    with a CPU margin under ``S2S_MARGIN``. Returns (held, positions, held
    ones that differ)."""
    held = bad = 0
    for r, row in enumerate(margins):
        low = np.nonzero(row < S2S_MARGIN)[0]
        n = int(low[0]) if len(low) else len(row)
        held += n
        bad += sum(card[r][i] != cpu[r][i] for i in range(n))
    return held, margins.size, bad


def decode_seq2seq():
    """Phase 12d. Transformer-base in f32 eval from seeded weights: greedy
    decoding of 16 sources to 32 tokens and beam search (beam 4) of 4
    sources to 32, on the card and on the CPU; the card's tokens (greedy)
    and the hypotheses each beam step keeps must equal the CPU's at every
    step before the first whose CPU margin is under
    ``S2S_MARGIN``, and at least a quarter of the positions must be held so
    (the check must not pass on nothing); each
    decode launches exactly 12 LayerNorms for the encoder and 18 a step.
    Returns (launches, readings)."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _seq2seq(seed=2).eval()
    rng = np.random.RandomState(32)
    cpu = copy.deepcopy(model)
    card = model.cuda()
    steps = S2S_DECODE_LEN - 1
    want_counts = {"layernorm_residual_fwd": S2S_ENC_NORMS + S2S_DEC_NORMS * steps}
    total, out = {}, {}
    for kind, b in (("greedy", S2S_GREEDY_B), ("beam", S2S_BEAM_B)):
        src = torch.from_numpy(s2s_batch(b, rng)[0])
        if kind == "greedy":
            run = lambda m, x: m.greedy_decode(x, max_len=S2S_DECODE_LEN)  # noqa: E731
        else:
            run = lambda m, x: m.beam_search(x, S2S_BEAM, S2S_DECODE_LEN)  # noqa: E731
        with _recorded_beam_steps() as card_steps:  # the first run: also cuBLAS's plans
            got = run(card, src.cuda())
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        timed = run(card, src.cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in launch_counts().items() if v}
        repeats = all(torch.equal(a, b) for a, b in zip(
            (got,) if kind == "greedy" else got, (timed,) if kind == "greedy" else timed))
        if counts != want_counts:
            raise AssertionError(f"seq2seq {kind} decode launched {counts}; want {want_counts}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        t0 = time.perf_counter()
        with _recorded_beam_steps() as cpu_steps:
            want = run(cpu, src)
        cpu_s = time.perf_counter() - t0
        if kind == "greedy":
            margins = _greedy_margins(cpu, src, want)
            held, positions, bad = _held(got.cpu().numpy()[:, 1:].tolist(),
                                         want.numpy()[:, 1:].tolist(), margins)
            extra = {}
        else:
            # a step's margin: the last kept total less the first dropped one
            top = torch.stack([t for t, _, _ in cpu_steps], 1)  # [B, T, k + 1]
            margins = (top[..., -2] - top[..., -1]).numpy()
            held, positions, bad = _held(_beam_hypotheses(card_steps),
                                         _beam_hypotheses(cpu_steps), margins)
            # rows held at every step: the same final hypotheses and scores
            full = [r for r in range(b) if (margins[r] >= S2S_MARGIN).all()]
            seqs, scores = (t.cpu() for t in got)

            def final(sq, sc, r):
                return sorted(zip(sc[r].tolist(), map(tuple, sq[:, r].T.tolist())))

            pairs = [(final(seqs, scores, r), final(*want, r)) for r in full]
            extra = {"rows_held_whole": len(full),
                     "final_scores_err": max((abs(a[0] - c[0]) for g, w in pairs
                                              for a, c in zip(g, w)), default=None),
                     "final_sequences_equal": all([a[1] for a in g] == [c[1] for c in w]
                                                  for g, w in pairs)}
            if not extra["final_sequences_equal"]:
                raise AssertionError(f"beam search: rows held at every step end apart: {extra}")
        rows = got.shape[0] if kind == "greedy" else b
        out[kind] = {"ms": ms, "ms_per_step": ms / steps, "ms_per_token": ms / (steps * rows),
                     "tokens_per_s": steps * rows / ms * 1e3, "rows": rows, "steps": steps,
                     "positions_held": held, "positions": positions, "mismatches_held": bad,
                     "min_cpu_margin": float(margins.min()), "cpu_s": cpu_s,
                     "timed_run_equals_checked": repeats, "launches": counts, **extra}
        log(f"seq2seq {kind} decode ({rows} rows to {S2S_DECODE_LEN} tokens): {ms:.1f} ms on "
            f"the card, {ms / steps:.3f} ms a step, {ms / (steps * rows):.4f} ms a token "
            f"(CPU {cpu_s:.1f} s); {held} of {positions} positions held to the CPU's (margin >= "
            f"{S2S_MARGIN}), {bad} differ; the timed run equal to the checked one: {repeats}; "
            f"launches {counts}; {extra}")
        if bad or held < positions / 4:
            raise AssertionError(f"seq2seq {kind} decode: {bad} of {held} held positions differ "
                                 f"from the CPU's ({positions} in all)")
    return total, out


def _ernie_batch(cfg, rng, seed):
    """bench's phase-2 shape with ERNIE's masking: ids, segment ids, spans
    of 1-4 tokens (a quarter of them single tokens), ``knowledge_masking``
    at 0.15 from a seeded generator, the first ``TRAIN_PRED`` masked
    positions of each row predicted (masks past them restored; a row with
    fewer pads its positions with ignored labels at its position 0)."""
    import torch

    from paddle_tpu_torch.models import knowledge_masking

    b, l = TRAIN_B, TRAIN_SEQ
    ids = rng.randint(5, cfg.vocab_size, (b, l)).astype(np.int64)
    spans = np.zeros((b, l), np.int64)
    for r in range(b):
        j, sid = 0, 1
        while j < l:
            n = rng.randint(1, 5)
            spans[r, j:j + n] = 0 if n == 1 else sid
            j, sid = j + n, sid + 1
    masked, mask = knowledge_masking(torch.from_numpy(ids), torch.from_numpy(spans),
                                     ERNIE_MASK_ID, torch.Generator().manual_seed(seed))
    masked, mask = masked.numpy().copy(), mask.numpy()
    pos = np.zeros((b, TRAIN_PRED), np.int64)
    labels = np.full((b, TRAIN_PRED), -100, np.int64)
    counts = []
    for r in range(b):
        where = np.nonzero(mask[r])[0]
        counts.append(len(where))
        masked[r, where[TRAIN_PRED:]] = ids[r, where[TRAIN_PRED:]]
        where = where[:TRAIN_PRED]
        pos[r, :len(where)] = where + r * l
        pos[r, len(where):] = r * l
        labels[r, :len(where)] = ids[r, where]
    types = rng.randint(0, 2, (b, l)).astype(np.int64)
    nsp = rng.randint(0, 2, (b, 1)).astype(np.int64)
    return [masked, types, pos.ravel(), labels.ravel(), nsp], counts


def train_ernie_amp():
    """Phase 12e. ERNIE-base (``ernie_base_config()``, flash on) pretrained
    under ``auto_cast`` (O1) at batch 32 x 512, 80 predictions a row from
    ``knowledge_masking``, AdamW lr 1e-4, dropout 0.1: 10 eager and 10
    captured steps from one set of weights, each launching the three bf16
    attention kernels once a layer and the residual LayerNorms (layer 0's
    first mixed, the rest bf16) exactly. Returns (eager launches, captured
    launches, readings)."""
    import torch

    from paddle_tpu_torch.models import (BertPretrainingCriterion, ErnieForPretraining,
                                         ernie_base_config)

    cfg = ernie_base_config()
    cfg.use_flash_attention = True
    base = ErnieForPretraining(cfg, generator=torch.Generator().manual_seed(3))
    crit = BertPretrainingCriterion(cfg.vocab_size)

    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)

    arrays, masked = _ernie_batch(cfg, np.random.RandomState(33), seed=34)
    batch = [torch.from_numpy(a).cuda() for a in arrays]
    amp_loss = _amp_loss_fn(loss_fn, "O1")
    counts, timing = compiled_timing(lambda: copy.deepcopy(base),
                                     lambda m, jit: _step_of(m, amp_loss, jit=jit), batch,
                                     "ERNIE AMP", TRAIN_B * TRAIN_SEQ, "tokens")
    want = _amp_launches("O1", cfg.num_hidden_layers, COMPILED_STEPS)
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"ERNIE AMP: {counts}; want {want}")
    eager = {k: v * COMPILED_STEPS for k, v in timing["eager"]["launches_a_step"].items()}
    stats = {"masked_a_row_min": min(masked), "masked_a_row_max": max(masked),
             "masked_a_row_mean": float(np.mean(masked)),
             "rows_under_80": sum(c < TRAIN_PRED for c in masked)}
    log(f"ERNIE AMP: knowledge masking {stats}; median step eager "
        f"{timing['eager']['step_ms_median']:.3f} ms, captured "
        f"{timing['captured']['step_ms_median']:.3f} ms")
    return eager, counts, {"masking": stats, **timing}


def train_seq2seq_and_ernie():
    """Phases 12c-12e. Returns ({"training", "compiled", "serving"}: launches,
    readings)."""
    import torch

    torch.cuda.empty_cache()
    s2s_eager, s2s_captured, s2s = train_seq2seq_amp()
    torch.cuda.empty_cache()
    dec_counts, dec = decode_seq2seq()
    torch.cuda.empty_cache()
    er_eager, er_captured, ernie = train_ernie_amp()
    torch.cuda.empty_cache()

    def add(*ds):
        return {k: sum(d.get(k, 0) for d in ds) for d in ds for k in d}

    return ({"training": add(s2s_eager, er_eager), "compiled": add(s2s_captured, er_captured),
             "serving": dec_counts},
            {"seq2seq_amp": s2s, "seq2seq_decode": dec, "ernie_amp": ernie})


# -- BASELINE.json's first config: the MNIST LeNet as a static program, SGD --------

LENET_B, LENET_STEPS, LENET_LR, LENET_SEED = 64, 200, 0.05, 16
LENET_PARITY_STEPS = 5  # steps held against the CPU interpreter
LENET_EAGER_STEPS = 20  # steps of the interpreter run eagerly on the card, timed
LENET_TIMED = 50  # replays of the forward program, timed
# LeNet's pools: [64, 6, 28, 28] -> [64, 6, 14, 14] and [64, 16, 10, 10] -> [64, 16, 5, 5]
LENET_POOLS = ((LENET_B, 6, 28, 28), (LENET_B, 16, 10, 10))
# The card's losses against the CPU interpreter's from the same weights and
# batches; the control is the CPU's run at lr 0 (the update ignored), whose
# losses part from the trained ones at the second step.
LENET_LOSS_ATOL = 1e-4
LENET_ACC_BAR = 0.9  # accuracy on the 512 held-out synthetic images after 200 steps


def _lenet_programs(train):
    """(main, startup, loss, acc) of the LeNet-5 program (the JAX package's
    ``models/lenet.py`` widths), with ``static.optimizer.SGD``'s training
    ops when ``train``. Two builds name their parameters alike (``param_0``
    ... ``param_9``), so a forward-only build reads a training build's
    scope."""
    from paddle_tpu_torch import nets, ops, static

    main, startup = static.Program(), static.Program()
    static.enable_static()
    try:
        with static.program_guard(main, startup):
            img = static.data("img", [None, 1, 28, 28], "float32")
            label = static.data("label", [None, 1], "int64")
            h = nets.simple_img_conv_pool(img, 6, 3, 2, 2, conv_padding=1, act="relu")
            h = nets.simple_img_conv_pool(h, 16, 5, 2, 2, act="relu")
            h = static.nn.fc(h, 120, activation="relu")
            h = static.nn.fc(h, 84, activation="relu")
            logits = static.nn.fc(h, 10)
            loss = ops.mean(ops.softmax_with_cross_entropy(logits, label))
            acc = ops.accuracy(ops.softmax(logits), label)
            if train:
                static.optimizer.SGD(learning_rate=LENET_LR).minimize(loss)
    finally:
        static.disable_static()
    return main, startup, loss, acc


def check_pool_backward_lenet(shape, row=None, path="MNIST LeNet static program", iters=50):
    """Rows 16e/16f: the max-pool backward kernel at one of LeNet's pools
    (2x2, stride 2, no padding; VGG's pools, row 16g, are the same
    geometry) on a relu'd input (whole windows of zeros
    tie), bit-equal to its plain version and within 4 ulps of
    ``aten.max_pool2d_with_indices_backward`` (the library yardstick: the
    same first-maximum rule, another order of adding), each timed in device
    time behind a sleep kernel, with the bound of the table's rule
    ``4·(|x|+|y|+|dy|+|dx|)`` bytes."""
    import torch

    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    g = torch.Generator(device="cuda").manual_seed(40 + shape[1])
    ks = st = (2, 2)
    pad = (0, 0)
    x = torch.relu(torch.randn(shape, generator=g, device="cuda"))
    y, idx = torch.nn.functional.max_pool2d(x, ks, st, pad, return_indices=True)
    dy = torch.randn(y.shape, generator=g, device="cuda")
    dx = pb.max_pool2d_backward(x, y, dy, ks, st, pad)
    ref = pb._plain_max_pool2d_backward(x, y, dy, ks, st, pad)
    lib_fn = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731
        dy, x, list(ks), list(st), list(pad), [1, 1], False, idx)
    lib = lib_fn()
    torch.cuda.synchronize()
    err = float((dx - ref).abs().max())
    lib_err = float((dx - lib).abs().max())
    ulp = float(torch.finfo(torch.float32).eps * ref.abs().max())
    if not torch.equal(dx, ref):
        raise AssertionError(f"max_pool2d_backward {list(shape)} 2x2/2: {err} from the plain "
                             "version")
    if lib_err > 4 * ulp:
        raise AssertionError(f"max_pool2d_backward {list(shape)} 2x2/2: {lib_err} from torch's "
                             f"backward, beyond 4 ulps ({4 * ulp})")
    t_b, by = bound(4 * (2 * x.numel() + 2 * y.numel()), 4 * x.numel())
    args = [(x, y, dy, ks, st, pad)]
    ms, host_ms = device_ms_sets(pb.max_pool2d_backward, args, iters)
    plain_ms = device_ms_sets(pb._plain_max_pool2d_backward, args, max(iters // 2, 5))[0]
    lib_ms = device_ms(lib_fn, iters)[0]
    row = row or ("16e" if shape[1] == 6 else "16f")
    entry = {"name": "max_pool2d_backward", "row": row,
             "path": path, "shape": list(shape),
             "geometry": "2x2 stride 2 padding 0", "input": "relu", "layout": "nchw",
             "dtype": "float32", "max_abs_err": err,
             "tolerance": "bit-equal to the plain version", "library_max_abs_err": lib_err,
             "zeros_share": float((x == 0).float().mean()), "ms": ms, "kernel_ms": ms,
             "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
             "library_ms": lib_ms,
             "library": "aten.max_pool2d_with_indices_backward at the same shape",
             "timing": "device time behind a sleep kernel"}
    log(f"max_pool2d_backward {list(shape)} 2x2/2/0 ({path}, row {row}): bit-equal to "
        f"the plain version, {lib_err:.3g} from torch's backward; kernel {ms:.4f} ms device "
        f"(host {host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {t_b:.5f} ms ({by})")
    return entry


def _lenet_run(exe, program, feeds, fetch, scope):
    """``exe.run`` of ``program`` on each of ``feeds`` (device tensors kept
    on the device); returns the fetches stacked, on the host."""
    import torch

    outs = [exe.run(program, feed=f, fetch_list=fetch, scope=scope, return_numpy=False)
            for f in feeds]
    return [torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(len(fetch))]


def _lenet_interpret_ms(exe, program, feeds, fetch, scope, steps):
    """The executor's interpreter run eagerly on the card (no graph), ``steps``
    steps timed with CUDA events and the host clock: (median ms, host ms a
    step, launches a step)."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    block, names = program.global_block(), [v.name for v in fetch]
    with torch.no_grad():
        exe._interpret(block, dict(feeds[0]), scope, names)
        torch.cuda.synchronize()
        reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(steps):
            exe._interpret(block, dict(feeds[i % len(feeds)]), scope, names)
            ev[i + 1].record()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    return float(np.median(ms)), host, {k: v // steps for k, v in launch_counts().items() if v}


def train_lenet_static():
    """Phase 12f. The LeNet-5 program trained by static SGD on the card
    through the executor's graph, ``FLAGS_use_pallas_pool_bwd`` on. Returns
    (the launches of the 200 steps, readings)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import convert, static
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.vision.datasets import MNIST

    main, startup, loss, acc = _lenet_programs(train=True)
    fwd, _, fwd_loss, fwd_acc = _lenet_programs(train=False)
    train_set, test_set = MNIST(mode="train"), MNIST(mode="test")
    images = torch.from_numpy(train_set.images).cuda()  # the data set on the card, once
    labels = torch.from_numpy(train_set.labels).reshape(-1, 1).cuda()
    n_batches = len(train_set) // LENET_B
    feeds = [{"img": images[i * LENET_B:(i + 1) * LENET_B],
              "label": labels[i * LENET_B:(i + 1) * LENET_B]} for i in range(n_batches)]
    ops_count = len(main.global_block().ops)
    grad_ops = sum(o.type.startswith("grad::") for o in main.global_block().ops)
    set_flags({"use_pallas_pool_bwd": True})
    try:
        ptt.seed(LENET_SEED)
        scope = static.Scope()
        exe = static.Executor()
        exe.run_startup(startup, scope=scope)
        init = {n: scope.numpy(n) for n in scope.var_names()}

        # the CPU interpreter from the same weights: trained, and at lr 0
        host_feeds = [{k: v.cpu().numpy() for k, v in f.items()}
                      for f in feeds[:LENET_PARITY_STEPS]]
        cpu = {}
        for name, lr in (("trained", None), ("control", 0.0)):
            cscope = convert.scope_from_numpy(init, device="cpu")
            if lr is not None:
                cscope.get("learning_rate_0").fill_(lr)
            cexe = static.Executor("cpu")
            cpu[name] = [float(cexe.run(main, feed=f, fetch_list=[loss], scope=cscope)[0])
                         for f in host_feeds]

        # 200 steps through the executor's graph, the counts set to 0 just
        # before: the first runs eagerly and is captured, the rest replay
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = [exe.run(main, feed=feeds[0], fetch_list=[loss, acc], scope=scope,
                        return_numpy=False)]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(LENET_STEPS)]
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(1, LENET_STEPS):
            outs.append(exe.run(main, feed=feeds[i % n_batches], fetch_list=[loss, acc],
                                scope=scope, return_numpy=False))
            ev[i].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (LENET_STEPS - 1)
        counts = {k: v for k, v in launch_counts().items() if v}
        losses = torch.stack([o[0] for o in outs]).cpu().numpy()
        accs = torch.stack([o[1] for o in outs]).cpu().numpy()
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(LENET_STEPS - 1)]
        graphs, captures, replays = len(exe.store), exe.store.misses, exe.store.hits

        # the lr is read by the graph from the scope's tensor, written in place
        # (as set_lr does): a replay at lr 0 moves no parameter, one at the lr
        # moves them, and neither captures again
        params = [n for n in scope.var_names() if n.startswith("param_")]
        lr_t = scope.get("learning_rate_0")
        moved = []
        for lr in (0.0, LENET_LR):
            before = [scope.get(n).clone() for n in params]
            lr_t.fill_(lr)
            exe.run(main, feed=feeds[1], fetch_list=[loss, acc], scope=scope,
                    return_numpy=False)
            moved.append(sum(not torch.equal(scope.get(n), b) for n, b in zip(params, before)))
        lr_captures = exe.store.misses - captures

        # one replay profiled: device busy by kind
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feeds[0], fetch_list=[loss, acc], scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
        by_kind, events = _device_time_by_kind(prof)

        # the forward alone (what the grad ops' re-run of their forwards costs
        # at most) and the held-out accuracy, through another executor's graphs
        fexe = static.Executor()
        _lenet_run(fexe, fwd, feeds[:1], [fwd_loss, fwd_acc], scope)
        torch.cuda.synchronize()
        f0, f1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        f0.record()
        for i in range(LENET_TIMED):
            fexe.run(fwd, feed=feeds[i % n_batches], fetch_list=[fwd_loss, fwd_acc], scope=scope,
                     return_numpy=False)
        f1.record()
        torch.cuda.synchronize()
        fwd_ms = f0.elapsed_time(f1) / LENET_TIMED
        test = {"img": torch.from_numpy(test_set.images).cuda(),
                "label": torch.from_numpy(test_set.labels).reshape(-1, 1).cuda()}
        test_loss, test_acc = (float(v[0]) for v in _lenet_run(fexe, fwd, [test],
                                                                 [fwd_loss, fwd_acc], scope))

        # the same steps run eagerly on the card (the interpreter, no graph)
        escope = convert.scope_from_numpy({n: scope.numpy(n) for n in scope.var_names()})
        eager_ms, eager_host_ms, eager_launches = _lenet_interpret_ms(
            exe, main, feeds, [loss, acc], escope, LENET_EAGER_STEPS)
    finally:
        set_flags({"use_pallas_pool_bwd": False})

    card5 = losses[:LENET_PARITY_STEPS].tolist()
    err = max(abs(a - b) for a, b in zip(card5, cpu["trained"]))
    control_err = max(abs(a - b) for a, b in zip(card5, cpu["control"]))
    median = float(np.median(step_ms))
    r = {"steps": LENET_STEPS, "batch": LENET_B, "lr": LENET_LR, "ops": ops_count,
         "grad_ops": grad_ops, "graphs": graphs, "captures": captures, "replays": replays,
         "launches": counts, "losses_first": card5, "cpu_losses": cpu["trained"],
         "control_losses": cpu["control"], "loss_err": err, "control_loss_err": control_err,
         "loss_atol": LENET_LOSS_ATOL, "loss_last_20_mean": float(losses[-20:].mean()),
         "train_acc_last_20_mean": float(accs[-20:].mean()), "test_loss": test_loss,
         "test_acc": test_acc, "test_acc_bar": LENET_ACC_BAR,
         "first_step_and_capture_ms": first_ms, "captured_step_ms_median": median,
         "captured_step_ms_min": min(step_ms), "captured_host_clock_ms": wall_ms,
         "images_per_s": LENET_B / median * 1e3, "busy_ms": sum(by_kind.values()),
         "device_ms_by_kind": by_kind, "device_events": events,
         "params_moved_at_lr_0_then_lr": moved, "eager_step_ms_median": eager_ms,
         "eager_host_ms": eager_host_ms,
         "eager_launches_a_step": eager_launches, "forward_ms_captured": fwd_ms,
         "forward_share_of_step": fwd_ms / median}
    log(f"LeNet static SGD ({ops_count} ops, {grad_ops} grad ops): {LENET_STEPS} steps at "
        f"batch {LENET_B}, {graphs} graph ({captures} capture, {replays} replays); launches "
        f"{counts}; first losses {[round(x, 6) for x in card5]}, CPU {cpu['trained']} (err "
        f"{err:.3g}, atol {LENET_LOSS_ATOL}; lr-0 control err {control_err:.3g}); last 20 mean "
        f"loss {r['loss_last_20_mean']:.4f}, train acc {r['train_acc_last_20_mean']:.4f}; "
        f"held-out acc {test_acc:.4f} (bar {LENET_ACC_BAR}), loss {test_loss:.4f}; first step "
        f"and capture {first_ms:.1f} ms; captured step {median:.4f} ms median between CUDA "
        f"events (min {min(step_ms):.4f}; host clock {wall_ms:.4f} a replay), "
        f"{r['images_per_s']:.0f} images/s, busy "
        f"{r['busy_ms']:.4f} ms in {events} device events; eager {eager_ms:.3f} ms (host "
        f"{eager_host_ms:.3f}); replays at lr 0 and {LENET_LR} moved {moved} of "
        f"{len(params)} parameters; the forward alone captured {fwd_ms:.4f} ms "
        f"({r['forward_share_of_step']:.1%} of the step)")
    if graphs != 1 or captures != 1 or replays != LENET_STEPS - 1:
        raise AssertionError(f"LeNet: {graphs} graphs, {captures} captures, {replays} replays "
                             f"in {LENET_STEPS} steps; want 1, 1, {LENET_STEPS - 1}")
    if counts != {"max_pool2d_backward": 2 * LENET_STEPS}:
        raise AssertionError(f"LeNet: {LENET_STEPS} steps launched {counts}; want "
                             f"max_pool2d_backward x {2 * LENET_STEPS}")
    if moved != [0, len(params)] or lr_captures:
        raise AssertionError(f"LeNet: replays at lr 0 and {LENET_LR} moved {moved} of "
                             f"{len(params)} parameters and captured {lr_captures} graphs")
    if eager_launches != {"max_pool2d_backward": 2}:
        raise AssertionError(f"LeNet eager: launches a step {eager_launches}")
    if not err <= LENET_LOSS_ATOL < control_err:
        raise AssertionError(f"LeNet: the card's first losses {err} from the CPU's (atol "
                             f"{LENET_LOSS_ATOL}; the lr-0 control {control_err} must fail)")
    if not (np.isfinite(losses).all() and r["loss_last_20_mean"] < losses[0]
            and test_acc > LENET_ACC_BAR):
        raise AssertionError(f"LeNet: did not train: {r}")
    return counts, r


# -- the PTB-medium LSTM language model as a static program (phase 12f2) ------------------

# Zaremba, Sutskever and Vinyals (2014) section 4.1, the medium model (also
# PaddlePaddle's models/language_model): vocabulary 10,000, 2 LSTM layers of
# 650, 35 unrolled steps, batch 20, dropout 0.5 after the embedding and each
# LSTM, weights uniform +-0.05, SGD at lr 1.0 under a global-norm clip of 5
PTB_VOCAB, PTB_H, PTB_LAYERS, PTB_T, PTB_B = 10000, 650, 2, 35, 20
PTB_DROPOUT, PTB_INIT, PTB_LR, PTB_CLIP, PTB_SEED = 0.5, 0.05, 1.0, 5.0, 22
PTB_PARITY_STEPS = 3  # captured steps at dropout 0 held against the CPU interpreter
PTB_LOSS_RTOL = 1e-4
PTB_PARAM_RTOL = 1e-5  # of each parameter's largest entry, after the three steps
PTB_SAVE_AT = 5  # the checkpoint is taken after this step, then step 6 is run twice
PTB_TIMED = 20  # captured steps at dropout 0.5 timed between CUDA events
PTB_EAGER_STEPS = 3  # steps of the interpreter run eagerly on the card, timed
PTB_PROMPTS, PTB_PROMPT_LEN, PTB_NEW = 4, 5, 20


def _ptb_lm_layers(static, ops, x, dropout):
    """Embedding output ``x`` -> the LSTM layers (dropout after each) ->
    the logits."""
    x = static.nn.dropout(x, dropout)
    for _ in range(PTB_LAYERS):
        x, _ = static.nn.lstm(x, PTB_H)
        x = static.nn.dropout(x, dropout)
    return static.nn.fc(x, PTB_VOCAB, num_flatten_dims=2)


def _ptb_program(dropout, train=True):
    """(main, startup, loss) of the LM as a static program, with
    ``static.optimizer.SGD``'s training ops under the clip when ``train``.
    Every build names its parameters alike (``param_0`` the embedding,
    ``param_1``-``param_6`` the LSTMs' ``w_ih``, ``w_hh``, ``b``, ``param_7``
    and ``param_8`` the output layer)."""
    from paddle_tpu_torch import ops, static
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm

    main, startup = static.Program(), static.Program()
    static.enable_static()
    try:
        with static.program_guard(main, startup):
            ids = static.data("ids", [PTB_B, PTB_T], "int64")
            labels = static.data("labels", [PTB_B, PTB_T, 1], "int64")
            logits = _ptb_lm_layers(static, ops, static.nn.embedding(ids, [PTB_VOCAB, PTB_H]),
                                    dropout)
            loss = ops.mean(ops.softmax_with_cross_entropy(logits, labels))
            if train:
                static.optimizer.SGD(PTB_LR, grad_clip=ClipGradByGlobalNorm(PTB_CLIP)).minimize(
                    loss)
    finally:
        static.disable_static()
    return main, startup, loss


def _ptb_step(static, ops, tok, states):
    """One step of both layers on ``tok`` ``[n]`` (a ``scan`` of length 1
    each): the next token (``argmax``) and the layers' new ``h``, ``c``."""
    n = tok.shape[0]
    x = static.nn.embedding(ops.reshape(tok, [n, 1]), [PTB_VOCAB, PTB_H])
    new_states = []
    for k in range(PTB_LAYERS):
        x, (h, c) = static.nn.lstm(x, PTB_H, init_h=states[2 * k], init_c=states[2 * k + 1])
        new_states += [h, c]
    logits = static.nn.fc(x, PTB_VOCAB, num_flatten_dims=2)
    return ops.reshape(ops.argmax(logits, axis=-1), [n]), new_states


def _ptb_greedy_program(bounded):
    """(main, new tokens) of the greedy continuation: a ``while_loop`` over
    ``PTB_PROMPT_LEN + PTB_NEW - 1`` steps fed the prompt's tokens, then
    its own ``argmax``; ``bounded``: ``max_iters`` that trip count (a masked
    scan, captured), else unbounded (the host reads the predicate)."""
    from paddle_tpu_torch import ops, static

    n, p = PTB_PROMPTS, PTB_PROMPT_LEN
    n_iter = p + PTB_NEW - 1
    main = static.Program()
    static.enable_static()
    try:
        with static.program_guard(main, static.Program()):
            prompt = static.data("prompt", [n, p], "int64")
            ppos = np.arange(p, dtype=np.int64)[None, :]
            opos = np.arange(p - 1, n_iter, dtype=np.int64)[None, :]

            def body(i, tok, out, *states):
                from_prompt = ops.sum(ops.where(ops.equal(ppos, i), prompt,
                                                np.zeros((n, p), np.int64)), axis=1)
                inp = ops.where(ops.less_than(i, np.int64(p)), from_prompt, tok)
                nxt, new_states = _ptb_step(static, ops, inp, states)
                out = ops.where(ops.equal(opos, i), ops.reshape(nxt, [n, 1]), out)
                return [ops.add(i, np.int64(1)), nxt, out] + new_states

            init = ([ops.full([], 0, "int64"), ops.full([n], 0, "int64"),
                     ops.full([n, PTB_NEW], 0, "int64")]
                    + [ops.zeros([n, PTB_H], "float32") for _ in range(2 * PTB_LAYERS)])
            finals = static.nn.while_loop(lambda i, *rest: ops.less_than(i, np.int64(n_iter)),
                                          body, init, max_iters=n_iter if bounded else None)
    finally:
        static.disable_static()
    return main, finals[2]


def _ptb_one_step_program():
    """(main, feed names, fetches) of one step alone, for the host loop."""
    from paddle_tpu_torch import ops, static

    main = static.Program()
    static.enable_static()
    try:
        with static.program_guard(main, static.Program()):
            tok = static.data("tok", [PTB_PROMPTS], "int64")
            states = [static.data(f"s{k}", [PTB_PROMPTS, PTB_H], "float32")
                      for k in range(2 * PTB_LAYERS)]
            nxt, new_states = _ptb_step(static, ops, tok, states)
    finally:
        static.disable_static()
    return main, [nxt] + new_states


def _ptb_branch_programs():
    """A ``switch_case`` over a fed index (three branches) and a batch norm
    under ``cond``, at the LM's ``[batch, hidden]``."""
    from paddle_tpu_torch import ops, static

    progs = {}
    static.enable_static()
    try:
        for name in ("switch", "bn"):
            main, startup = static.Program(), static.Program()
            with static.program_guard(main, startup):
                x = static.data("x", [PTB_B, PTB_H], "float32")
                if name == "switch":
                    idx = static.data("idx", [], "int64")
                    out = static.nn.switch_case(idx, {0: lambda: ops.scale(x, 2.0),
                                                      1: lambda: ops.tanh(x),
                                                      2: lambda: ops.scale(x, -1.0, 0.5)})
                else:
                    pred = static.data("pred", [], "bool")
                    out = static.nn.cond(pred, lambda: static.nn.batch_norm(x, momentum=0.5),
                                         lambda: ops.scale(x, 1.0))
            progs[name] = (main, startup, out)
    finally:
        static.disable_static()
    return progs


def _ptb_batches(n):
    """``n`` batches of a token stream drawn uniformly from the vocabulary
    with a seed (the PTB text is not in the repository): ids and the next
    tokens as labels, as numpy."""
    stream = np.random.RandomState(PTB_SEED).randint(0, PTB_VOCAB, size=n * PTB_B * PTB_T + 1)
    out = []
    for k in range(n):
        s = stream[k * PTB_B * PTB_T:(k + 1) * PTB_B * PTB_T + 1]
        out.append({"ids": s[:-1].reshape(PTB_B, PTB_T).astype(np.int64),
                    "labels": s[1:].reshape(PTB_B, PTB_T, 1).astype(np.int64)})
    return out


def _ptb_weights(main, startup):
    """The startup's values (the lr) with every parameter drawn uniform in
    +-``PTB_INIT`` from ``PTB_SEED``, as numpy."""
    from paddle_tpu_torch import static

    scope = static.Scope()
    static.Executor("cpu").run_startup(startup, scope=scope)
    rng = np.random.RandomState(PTB_SEED)
    values = {n: scope.numpy(n) for n in scope.var_names()}
    for v in main.global_block().vars.values():
        if v.is_parameter and v.name.startswith("param_"):
            values[v.name] = rng.uniform(-PTB_INIT, PTB_INIT, v.shape).astype(np.float32)
    return values


def _ptb_steps(exe, main, loss, feeds, scope):
    """Losses of ``exe.run`` of ``main`` on each feed, as floats."""
    return [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]) for f in feeds]


def _ptb_greedy(scope, prompts, dev):
    """(tokens of the bounded loop, of the unbounded one, of the host loop
    of the one-step program; readings): the same trained weights."""
    import torch

    from paddle_tpu_torch import static

    exe = static.Executor()
    out, r = {}, {}
    for bounded in (True, False):
        main, toks = _ptb_greedy_program(bounded)
        before = exe.store.uncaptured
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(exe.run(main, feed={"prompt": prompts}, fetch_list=[toks], scope=scope)[0])
            runs_ms = (time.perf_counter() - t0) * 1e3
        key = "bounded" if bounded else "unbounded"
        if not np.array_equal(runs[0], runs[1]):
            raise AssertionError(f"PTB greedy {key}: two runs gave {runs}")
        out[key] = runs[0]
        r[f"{key}_ms"] = runs_ms
        r[f"{key}_uncaptured_runs"] = exe.store.uncaptured - before
    r["captures"], r["replays"] = exe.store.misses, exe.store.hits

    main, fetch = _ptb_one_step_program()
    sexe = static.Executor()
    states = [torch.zeros(PTB_PROMPTS, PTB_H, device=dev) for _ in range(2 * PTB_LAYERS)]
    prev, host = None, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(PTB_PROMPT_LEN + PTB_NEW - 1):
        feed = {"tok": torch.from_numpy(prompts[:, i]).to(dev) if i < PTB_PROMPT_LEN else prev}
        feed.update({f"s{k}": s for k, s in enumerate(states)})
        prev, *states = sexe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                                 return_numpy=False)
        if i >= PTB_PROMPT_LEN - 1:
            host.append(prev.cpu().numpy())
    r["host_loop_ms"] = (time.perf_counter() - t0) * 1e3
    r["host_loop_captures"] = sexe.store.misses
    out["host_loop"] = np.stack(host, 1)
    return out, r


def _ptb_branches(dev):
    """Check (d): a captured ``switch_case`` picks each branch, and a batch
    norm under ``cond`` moves its running statistics only when its branch
    is taken, both through one graph, on ``dev``. Returns readings."""
    import torch

    from paddle_tpu_torch import static

    progs = _ptb_branch_programs()
    g = torch.Generator(device=dev).manual_seed(PTB_SEED)
    x = torch.randn(PTB_B, PTB_H, generator=g, device=dev) * 2.0 + 0.5
    r = {}
    main, _, out = progs["switch"]
    scope, exe = static.Scope(), static.Executor()
    want = {0: x * 2.0, 1: torch.tanh(x), 2: x * -1.0 + 0.5}
    for i in (0, 1, 2, 0):
        got = exe.run(main, feed={"x": x, "idx": np.int64(i)}, fetch_list=[out], scope=scope,
                      return_numpy=False)[0]
        if not torch.equal(got, want[i]):
            raise AssertionError(f"PTB switch_case: index {i} gave "
                                 f"{float((got - want[i]).abs().max())} from its branch")
    r["switch_case"] = {"captures": exe.store.misses, "replays": exe.store.hits,
                        "uncaptured": exe.store.uncaptured}
    if (exe.store.misses, exe.store.hits, exe.store.uncaptured) != (1, 3, 0):
        raise AssertionError(f"PTB switch_case: {r['switch_case']}; want one capture, three "
                             "replays")

    main, startup, out = progs["bn"]
    scope, exe = static.Scope(), static.Executor()
    exe.run_startup(startup, scope=scope)
    names = sorted(v.name for v in main.global_block().vars.values() if v.is_parameter)
    mean_name, var_name = names[2], names[3]  # scale, bias, running mean, running var
    bm = x.mean(0)
    bv = (x - bm).square().mean(0)
    m, v = torch.zeros(PTB_H, device=dev), torch.ones(PTB_H, device=dev)
    errs = []
    for taken in (True, False, True):
        exe.run(main, feed={"x": x, "pred": np.asarray(taken)}, fetch_list=[out], scope=scope,
                return_numpy=False)
        if taken:
            m, v = 0.5 * m + 0.5 * bm, 0.5 * v + 0.5 * bv
        errs.append(max(float((scope.get(mean_name) - m).abs().max()),
                        float((scope.get(var_name) - v).abs().max())))
    r["bn_under_cond"] = {"stat_errs": errs, "captures": exe.store.misses,
                          "replays": exe.store.hits}
    if max(errs) > 1e-5 or (exe.store.misses, exe.store.hits) != (1, 2):
        raise AssertionError(f"PTB batch norm under cond: {r['bn_under_cond']}")
    return r


def train_ptb_lm_static():
    """Phase 12f2. The PTB-medium LSTM language model as a static program
    trained on the card through the executor's graph, with its greedy
    continuation, branches and a checkpoint. Returns (the launches of the
    phase's runs, readings)."""
    import torch

    from paddle_tpu_torch import convert, static
    from paddle_tpu_torch.device import card_identity
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    card = card_identity()
    main0, startup0, loss0 = _ptb_program(0.0)
    main5, _, loss5 = _ptb_program(PTB_DROPOUT)
    fwd5, _, floss5 = _ptb_program(PTB_DROPOUT, train=False)
    init = _ptb_weights(main0, startup0)
    host = _ptb_batches(max(PTB_TIMED, PTB_SAVE_AT) + 1)
    feeds = [{k: torch.from_numpy(v).cuda() for k, v in f.items()} for f in host]
    dev = feeds[0]["ids"].device
    ops_count = sum(len(b.ops) for b in main5.blocks)
    torch.cuda.synchronize()
    reset_launch_counts()

    # (a) dropout 0: the first three steps captured on the card against the
    # CPU interpreter from the same weights: the losses, and the parameters
    # after them (an lr-0 control must fail the parameters' limit; the
    # losses at this init move by less than 1e-6 in three steps)
    scope0, exe0 = convert.scope_from_numpy(init), static.Executor()
    card_losses = _ptb_steps(exe0, main0, loss0, feeds[:PTB_PARITY_STEPS], scope0)
    params = sorted(n for n in init if n.startswith("param_"))
    card_params = {n: scope0.numpy(n) for n in params}
    cpu, cpu_params = {}, {}
    for name, lr in (("trained", None), ("control", 0.0)):
        cscope = convert.scope_from_numpy(init, device="cpu")
        if lr is not None:
            cscope.get("learning_rate_0").fill_(lr)
        cpu[name] = _ptb_steps(static.Executor("cpu"), main0, loss0, host[:PTB_PARITY_STEPS],
                               cscope)
        cpu_params[name] = {n: cscope.numpy(n) for n in params}
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu["trained"]))
    param_err, control_err = (
        max(float(np.abs(card_params[n] - want[n]).max() / np.abs(want[n]).max())
            for n in params) for want in (cpu_params["trained"], cpu_params["control"]))

    # (e) on to step 5, save_persistables, step 6; a fresh scope and executor
    # load the checkpoint and run step 6 again
    card_losses += _ptb_steps(exe0, main0, loss0, feeds[PTB_PARITY_STEPS:PTB_SAVE_AT], scope0)
    with tempfile.TemporaryDirectory() as d:
        static.save_persistables(exe0, d, main_program=main0, scope=scope0)
        step6 = _ptb_steps(exe0, main0, loss0, feeds[PTB_SAVE_AT:PTB_SAVE_AT + 1], scope0)[0]
        rscope, rexe = static.Scope(), static.Executor()
        static.load_persistables(rexe, d, main_program=main0, scope=rscope)
        resumed6 = _ptb_steps(rexe, main0, loss0, feeds[PTB_SAVE_AT:PTB_SAVE_AT + 1], rscope)[0]
    graphs0 = (exe0.store.misses, exe0.store.hits)

    # (f) the main path: dropout 0.5, one step eagerly and captured, then
    # PTB_TIMED replays between CUDA events
    scope5, exe5 = convert.scope_from_numpy(init), static.Executor()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [exe5.run(main5, feed=feeds[0], fetch_list=[loss5], scope=scope5,
                     return_numpy=False)[0]]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(PTB_TIMED + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(PTB_TIMED):
        outs.append(exe5.run(main5, feed=feeds[1 + i], fetch_list=[loss5], scope=scope5,
                             return_numpy=False)[0])
        ev[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / PTB_TIMED
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(PTB_TIMED)]
    losses5 = torch.stack(outs).cpu().numpy()
    graphs5 = (len(exe5.store), exe5.store.misses, exe5.store.hits, exe5.store.uncaptured)

    # the same step interpreted eagerly on the card (no graph), on a copy
    escope = convert.scope_from_numpy({n: scope5.numpy(n) for n in scope5.var_names()})
    block = main5.global_block()
    with torch.no_grad():
        exe5._interpret(block, dict(feeds[0]), escope, [loss5.name])
        torch.cuda.synchronize()
        eev = [torch.cuda.Event(enable_timing=True) for _ in range(PTB_EAGER_STEPS + 1)]
        t0 = time.perf_counter()
        eev[0].record()
        for i in range(PTB_EAGER_STEPS):
            exe5._interpret(block, dict(feeds[i]), escope, [loss5.name])
            eev[i + 1].record()
        torch.cuda.synchronize()
    eager_host_ms = (time.perf_counter() - t0) * 1e3 / PTB_EAGER_STEPS
    eager_ms = [eev[i].elapsed_time(eev[i + 1]) for i in range(PTB_EAGER_STEPS)]

    # (b) dropout under capture: the forward program replayed twice on one
    # batch draws two masks; its for_test clone (dropout off) repeats
    fexe, drop_losses = static.Executor(), {}
    for name, prog in (("train", fwd5), ("for_test", fwd5.clone(for_test=True))):
        drop_losses[name] = _ptb_steps(fexe, prog, floss5.name, [feeds[0]] * 3, scope5)

    # (c) the greedy continuation from the trained weights
    prompts = np.random.RandomState(PTB_SEED + 1).randint(
        0, PTB_VOCAB, size=(PTB_PROMPTS, PTB_PROMPT_LEN)).astype(np.int64)
    tokens, greedy = _ptb_greedy(scope5, prompts, dev)

    # (d) branches
    branches = _ptb_branches(dev)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    seconds = time.perf_counter() - t_phase

    median = float(np.median(step_ms))
    eager_median = float(np.median(eager_ms))
    r = {"config": {"vocab": PTB_VOCAB, "hidden": PTB_H, "layers": PTB_LAYERS,
                    "steps": PTB_T, "batch": PTB_B, "dropout": PTB_DROPOUT, "init": PTB_INIT,
                    "lr": PTB_LR, "clip": PTB_CLIP},
         "card": card, "ops": ops_count, "launches": counts,
         "parity": {"card": card_losses[:PTB_PARITY_STEPS], "cpu": cpu["trained"],
                    "rel": rel, "rtol": PTB_LOSS_RTOL, "param_err": param_err,
                    "param_rtol": PTB_PARAM_RTOL, "control_lr0_param_err": control_err},
         "checkpoint": {"losses_1_to_5": card_losses, "step6": step6, "resumed_step6": resumed6,
                        "captures_replays": graphs0},
         "dropout_replays": drop_losses,
         "greedy": dict(greedy, tokens=tokens["bounded"].tolist()), "branches": branches,
         "train": {"losses": losses5.tolist(), "graphs_captures_replays_uncaptured": graphs5,
                   "first_step_and_capture_ms": first_ms, "captured_step_ms_median": median,
                   "captured_step_ms_min": min(step_ms), "captured_host_clock_ms": host_ms,
                   "tokens_per_s": PTB_B * PTB_T / median * 1e3,
                   "interpreted_step_ms_median": eager_median,
                   "interpreted_host_ms": eager_host_ms},
         "seconds": seconds}
    log(f"PTB-medium LM static ({card}; {ops_count} ops in {len(main5.blocks)} blocks): "
        f"parity at dropout 0 card {card_losses[:PTB_PARITY_STEPS]} vs CPU {cpu['trained']} "
        f"(rel {rel:.3g}, rtol {PTB_LOSS_RTOL}); parameters after them {param_err:.3g} of "
        f"their largest entry (limit {PTB_PARAM_RTOL}; lr-0 control {control_err:.3g}); step 6 "
        f"{step6!r} unbroken, {resumed6!r} resumed from save_persistables; dropout 0.5 "
        f"replays {drop_losses['train']}, for_test {drop_losses['for_test']}; captured step "
        f"{median:.3f} ms median between CUDA events (min {min(step_ms):.3f}, host clock "
        f"{host_ms:.3f} a step, {r['train']['tokens_per_s']:.0f} tokens/s) against "
        f"{eager_median:.1f} ms interpreted (host {eager_host_ms:.1f}); first step and capture "
        f"{first_ms:.0f} ms; graphs/captures/replays/uncaptured {graphs5}; greedy "
        f"{PTB_PROMPTS} x {PTB_NEW}: bounded {greedy['bounded_ms']:.1f} ms, unbounded "
        f"{greedy['unbounded_ms']:.1f} ms (uncaptured runs {greedy['unbounded_uncaptured_runs']})"
        f", host loop {greedy['host_loop_ms']:.1f} ms; branches {branches}; launches {counts}; "
        f"{seconds:.1f} s")
    if counts:
        raise AssertionError(f"PTB LM: the phase launched {counts}; it runs none of the kernels")
    if not (rel <= PTB_LOSS_RTOL and param_err <= PTB_PARAM_RTOL < control_err):
        raise AssertionError(f"PTB LM: the card's losses {rel} from the CPU's (rtol "
                             f"{PTB_LOSS_RTOL}), parameters {param_err} (limit {PTB_PARAM_RTOL}; "
                             f"the lr-0 control {control_err} must fail)")
    if step6 != resumed6:
        raise AssertionError(f"PTB LM: step 6 {step6!r} unbroken, {resumed6!r} resumed")
    d_train, d_test = drop_losses["train"], drop_losses["for_test"]
    if not (np.isfinite(d_train).all() and d_train[1] != d_train[2]
            and d_test[1] == d_test[2]):
        raise AssertionError(f"PTB LM dropout under capture: replays {d_train}, for_test "
                             f"{d_test}")
    if not (np.array_equal(tokens["bounded"], tokens["unbounded"])
            and np.array_equal(tokens["bounded"], tokens["host_loop"])
            and tokens["bounded"].shape == (PTB_PROMPTS, PTB_NEW)):
        raise AssertionError(f"PTB greedy: {tokens}")
    if (greedy["bounded_uncaptured_runs"], greedy["unbounded_uncaptured_runs"]) != (0, 2):
        raise AssertionError(f"PTB greedy: uncaptured runs {greedy}")
    if graphs5 != (1, 1, PTB_TIMED, 0) or graphs0[0] != 1:
        raise AssertionError(f"PTB LM: graphs {graphs5}, {graphs0}")
    if not (np.isfinite(losses5).all() and abs(float(losses5[0]) - np.log(PTB_VOCAB)) < 0.1):
        raise AssertionError(f"PTB LM: losses {losses5}")
    return counts, r

# -- the rest of training: Lamb, EMA, the NaN check, checkpoints; the other optimizers --------

LAMB_LR, LAMB_WD, LAMB_SEED, LAMB_EMA_DECAY = 1e-4, 0.01, 31, 0.999
LAMB_SAVE_AT = 3  # the step the checkpoint is taken after
LAMB_TIMED = COMPILED_STEPS  # captured steps timed, an EMA update after each
LAMB_CHECKED_TIMED = 5  # checked replays timed
LAMB_PARITY_B = 1  # one step on the card against the CPU's plain path, dropout 0
# Lamb's first step at batch 1 x 512 under O1 on the card against the
# CPU's plain path, read on an NVIDIA H100 80GB HBM3 at 700.00 W: the loss
# after the update (a second step's, then a forward alone) 1.2e-3 apart,
# the f32 step (the control) 3.54e-2; the limit sits near their geometric
# mean, and the control must fail it. The rel L2 of the parameters' change
# read 0.143 (the control 0.142): Lamb's first direction m/(sqrt(v)+eps) is
# about sign(g), so entries whose gradient is near eps swing it either way;
# it is a gross limit only.
LAMB_LOSS_ATOL, LAMB_UPDATE_REL_L2 = 6.5e-3, 0.25
LENET_OPT_STEPS = 20  # captured steps under each optimizer
# the 20 captured losses under each optimizer against the CPU's 20 from the
# same weights and batches, read on an NVIDIA H100 80GB HBM3 at 700.00 W:
# 2.4e-7 to 1.3e-6 apart; the controls at half the lr 0.113 (Adagrad) to
# 0.956; the limit sits near the geometric mean of the worst reading and
# the weakest control
LENET_OPT_LOSS_ATOL = 3e-4
LENET_OPT_HELD_OUT = 512  # held-out images for the accuracy under ModelAverage


def _lamb_exclude(p):
    """LAMB's BERT recipe: no decay on LayerNorm weights and on biases."""
    return "norm" in p.name or "bias" in p.name


def _lamb_step_of(model, loss_fn, device=None, jit=True):
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Lamb

    opt = Lamb(learning_rate=LAMB_LR, lamb_weight_decay=LAMB_WD,
               parameters=model.named_parameters(),
               exclude_from_weight_decay_fn=_lamb_exclude)
    return train_step(model, opt, loss_fn, device=device, jit=jit)


def _bits_equal(a, b):
    """Bit for bit (a NaN equals the same NaN)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _lamb_parity():
    """Lamb's first step (batch 1 x 512, dropout 0, O1) through
    ``train_step(jit=True)`` on the card and the same step on the CPU's
    plain path (the attention kernels' plain versions) from the same
    weights, then the loss after it (a forward); the f32 step on the card
    the control. Returns the readings."""
    import torch

    from paddle_tpu_torch.models import bert_base_config

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    model, loss_fn = _pretraining(cfg, seed=0)
    batch = pretraining_batch(cfg, LAMB_PARITY_B, TRAIN_SEQ, TRAIN_PRED,
                              np.random.RandomState(12))
    amp_loss = _amp_loss_fn(loss_fn, "O1")
    start = [p.detach().clone() for p in model.parameters()]
    runs = {}
    for name, fn, dev in (("cpu", amp_loss, "cpu"), ("card", amp_loss, None),
                          ("control_f32", loss_fn, None)):
        m = copy.deepcopy(model)
        step = _lamb_step_of(m, fn, device=dev)
        t0 = time.perf_counter()
        route = _cpu_kernel_route() if dev == "cpu" else contextlib.nullcontext()
        with route:
            losses = [float(step(*batch)["loss"])]
            with torch.no_grad():
                m.train()
                losses.append(float(fn(m, *[torch.from_numpy(a).to(step.device)
                                            for a in batch])))
        runs[name] = {"losses": losses, "s": time.perf_counter() - t0,
                      "delta": [p.detach().cpu().double() - s.double()
                                for p, s in zip(m.parameters(), start)]}
        del m, step
    ref = runs["cpu"]

    def rel_l2(delta):
        num = sum(float((d - r).square().sum()) for d, r in zip(delta, ref["delta"]))
        return (num / sum(float(r.square().sum()) for r in ref["delta"])) ** 0.5

    out = {}
    for name in ("card", "control_f32"):
        r = runs[name]
        out[name] = {"losses": r["losses"], "loss_err": abs(r["losses"][-1] - ref["losses"][-1]),
                     "update_rel_l2": rel_l2(r["delta"]), "s": r["s"]}
    out["cpu"] = {"losses": ref["losses"], "s": ref["s"]}
    out["limits"] = {"loss_atol": LAMB_LOSS_ATOL, "update_rel_l2": LAMB_UPDATE_REL_L2}
    c, k = out["card"], out["control_f32"]
    log(f"Lamb parity (BERT-base, batch {LAMB_PARITY_B} x {TRAIN_SEQ}, O1, dropout 0, a "
        f"step and the loss after it): card losses {c['losses']}, CPU plain path "
        f"{ref['losses']} ({ref['s']:.1f} s); loss err after the step {c['loss_err']:.3g} (atol "
        f"{LAMB_LOSS_ATOL}), update rel L2 {c['update_rel_l2']:.3g} (limit "
        f"{LAMB_UPDATE_REL_L2}); f32 control: loss err {k['loss_err']:.3g}, update rel L2 "
        f"{k['update_rel_l2']:.3g}")
    if not (np.isfinite(c["losses"]).all() and c["loss_err"] <= LAMB_LOSS_ATOL
            and c["update_rel_l2"] <= LAMB_UPDATE_REL_L2):
        raise AssertionError(f"Lamb parity beyond its limits: {out}")
    if not k["loss_err"] > LAMB_LOSS_ATOL:
        raise AssertionError(f"Lamb parity: the f32 control passes the loss limit: {out}")
    return out


def train_bert_lamb(adamw_ms=None):
    """Phase 12g. BERT-base pretraining under ``Lamb`` at bench's phase 2
    (O1, dropout 0.1) captured, an EMA updated after each step; the checked
    step (``FLAGS_check_nan_inf``) and a planted NaN; a checkpoint taken
    after step 3 and restored into a fresh model and step. Returns (the
    launches of the timed steps, readings)."""
    import os
    import shutil

    import torch

    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.errors import FatalError
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import ExponentialMovingAverage

    r = {"parity": _lamb_parity()}
    torch.cuda.empty_cache()
    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    _, loss_fn = _pretraining(cfg, seed=1)
    loss_fn = _amp_loss_fn(loss_fn, "O1")
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    tokens = TRAIN_B * TRAIN_SEQ
    tmp = tempfile.mkdtemp(prefix="ptt_lamb_ckpt_")
    try:
        model, _ = _pretraining(cfg, seed=LAMB_SEED)
        step = _lamb_step_of(model, loss_fn)
        ema = ExponentialMovingAverage(model.parameters(), decay=LAMB_EMA_DECAY)
        losses = []
        for _ in range(LAMB_SAVE_AT):
            losses.append(float(step(*batch)["loss"]))
            ema.update()
        torch.cuda.synchronize()
        path = os.path.join(tmp, f"step_{LAMB_SAVE_AT}")
        saved = {n: t.detach().clone() for n, t in step.state_leaves()}  # the state saved
        t0 = time.perf_counter()
        step.save_checkpoint(path, step=LAMB_SAVE_AT, async_=True)
        capture_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.wait_pending()
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        prandom.seed(PARITY_SEED)
        resumed_ref = float(step(*batch)["loss"])

        # timed: captured steps, each followed by an EMA update
        torch.cuda.synchronize()
        reset_launch_counts()
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(LAMB_TIMED)]
        t0 = time.perf_counter()
        for e in ev:
            e[0].record()
            losses.append(step(*batch)["loss"])
            e[1].record()
            ema.update()
            e[2].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / LAMB_TIMED
        counts = {k: v for k, v in launch_counts().items() if v}
        losses = [float(x) for x in losses]
        step_ms = [e[0].elapsed_time(e[1]) for e in ev]
        ema_ms = [e[1].elapsed_time(e[2]) for e in ev]
        want = _amp_launches("O1", cfg.num_hidden_layers, LAMB_TIMED)
        if counts != want:
            raise AssertionError(f"Lamb: {LAMB_TIMED} captured steps launched {counts}; "
                                 f"want {want}")
        graphs = len(step.store)
        ptrs = [p.data_ptr() for p in model.parameters()]
        with ema.apply():
            moved = sum(not torch.equal(p, e / (1 - ema._decay_prod))
                        for p, e in zip(model.parameters(), ema._ema))
            kept = [p.data_ptr() for p in model.parameters()] == ptrs
        kept = kept and [p.data_ptr() for p in model.parameters()] == ptrs
        median = float(np.median(step_ms))
        r["captured"] = {"losses": losses, "step_ms": step_ms, "step_ms_median": median,
                         "host_clock_ms": wall_ms, "tokens_per_s": tokens / median * 1e3,
                         "adamw_step_ms_median": adamw_ms, "ema_update_ms": ema_ms,
                         "ema_update_ms_median": float(np.median(ema_ms)),
                         "launches_a_step": {k: v // LAMB_TIMED for k, v in counts.items()},
                         "graphs": graphs}
        log(f"BERT Lamb captured: {LAMB_TIMED} steps, median {median:.3f} ms (host clock "
            f"{wall_ms:.3f} with the EMA), {tokens / median * 1e3:.1f} tokens/s; AdamW's "
            f"captured step {adamw_ms} ms; EMA update median {float(np.median(ema_ms)):.3f} "
            f"ms; launches a step {r['captured']['launches_a_step']}; losses {losses}")
        # (at lr 1e-4 a Lamb step moves each tensor by 1e-4 of its norm: over
        # 13 steps that is below dropout's noise, so only finiteness is held)
        if not np.isfinite(losses).all():
            raise AssertionError(f"Lamb: losses not finite: {losses}")
        if graphs != 1 or not kept or moved:
            raise AssertionError(f"Lamb: {graphs} graphs; ema.apply kept the storage {kept}, "
                                 f"{moved} parameters not the averages under it")

        # the checked step: its own graph; a NaN planted in a row the batch reads
        set_flags({"check_nan_inf": True})
        try:
            step(*batch)  # the checked variant's first run and capture
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(LAMB_CHECKED_TIMED + 1)]
            t0 = time.perf_counter()
            ev[0].record()
            for i in range(LAMB_CHECKED_TIMED):
                step(*batch)
                ev[i + 1].record()
            torch.cuda.synchronize()
            checked_wall = (time.perf_counter() - t0) * 1e3 / LAMB_CHECKED_TIMED
            checked_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(LAMB_CHECKED_TIMED)]
            ops_checked = len(step._nan_names)
            backward_ops = sum(n.endswith("_backward") for n in step._nan_names)
            # every kernel of the step checked under its own name, as often as it launches
            kernel_checks = {n: step._nan_names.count(n) for n in set(step._nan_names)
                             if not n.startswith("aten::")}
            table = model.bert.embeddings.word_embeddings.weight
            row = int(batch[0][0, 0])
            saved_row = table[row].detach().clone()
            with torch.no_grad():
                table[row, 0] = float("nan")
            state = [t.detach().clone() for t in step._state_tensors()]
            host_step = step.optimizer._global_step
            try:
                step(*batch)
                raised = None
            except FatalError as e:
                raised = str(e)
            same = all(_bits_equal(t, s) for t, s in zip(step._state_tensors(), state))
            same = same and step.optimizer._global_step == host_step == int(
                step.optimizer._step_t)
            with torch.no_grad():
                table[row].copy_(saved_row)
            step(*batch)  # clean again: passes
            checked_graphs = len(step.store)
        finally:
            set_flags({"check_nan_inf": False})
        r["checked"] = {"step_ms": checked_ms, "step_ms_median": float(np.median(checked_ms)),
                        "host_clock_ms": checked_wall, "ops_checked": ops_checked,
                        "backward_ops_checked": backward_ops, "kernels_checked": kernel_checks,
                        "graphs": checked_graphs,
                        "planted_nan": raised, "state_kept": same}
        log(f"BERT Lamb checked step (FLAGS_check_nan_inf): median "
            f"{r['checked']['step_ms_median']:.3f} ms (host clock {checked_wall:.3f} with the "
            f"verdict's read), {ops_checked} ops checked ({backward_ops} aten backward ops, "
            f"kernels {kernel_checks}); "
            f"graphs {checked_graphs}; planted NaN: {raised}; state bit-equal after: {same}")
        if (raised is None or "aten::embedding" not in raised or not same
                or checked_graphs != 2 or not backward_ops
                or kernel_checks != r["captured"]["launches_a_step"]):
            raise AssertionError(f"Lamb checked step: {r['checked']}")
        del step, model, ema
        torch.cuda.empty_cache()

        # restore into a freshly built model and step (one step captured first)
        model2, _ = _pretraining(cfg, seed=LAMB_SEED + 1)
        step2 = _lamb_step_of(model2, loss_fn)
        step2(*batch)
        misses = step2.store.misses
        t0 = time.perf_counter()
        manifest = step2.load_checkpoint(path)
        load_s = time.perf_counter() - t0
        leaves = step2.state_leaves()
        differ = [n for n, t in leaves if not _bits_equal(t.detach(), saved.get(n, t[None]))]
        differ += sorted(set(saved) - {n for n, _ in leaves})
        prandom.seed(PARITY_SEED)
        resumed = float(step2(*batch)["loss"])
        r["checkpoint"] = {"capture_ms": capture_ms, "write_s": write_s, "bytes": ckpt_bytes,
                           "load_s": load_s, "leaves": len(saved), "leaves_differing": differ,
                           "manifest_step": manifest["step"], "new_captures":
                           step2.store.misses - misses, "next_loss": resumed,
                           "next_loss_uninterrupted": resumed_ref}
        log(f"BERT Lamb checkpoint after step {LAMB_SAVE_AT}: capture {capture_ms:.1f} ms on "
            f"the step's thread, write {write_s:.2f} s, {ckpt_bytes} bytes, {len(saved)} leaves; "
            f"restored into a fresh step in {load_s:.2f} s with {len(differ)} leaves differing, "
            f"{r['checkpoint']['new_captures']} new captures; next loss {resumed!r}, "
            f"uninterrupted {resumed_ref!r}")
        if (differ or r["checkpoint"]["new_captures"] or resumed != resumed_ref
                or manifest["step"] != LAMB_SAVE_AT
                or step2.optimizer._global_step != LAMB_SAVE_AT + 1):
            raise AssertionError(f"Lamb checkpoint: {r['checkpoint']}")
        del step2, model2, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, r


def _lenet_optimizers():
    """name -> a constructor over LeNet's parameters."""
    from paddle_tpu_torch import optimizer as O

    return {
        "adagrad": lambda p, s=1.0: O.Adagrad(0.01 * s, parameters=p,
                                              initial_accumulator_value=0.1),
        "adadelta": lambda p, s=1.0: O.Adadelta(1.0 * s, parameters=p),
        "rmsprop": lambda p, s=1.0: O.RMSProp(0.001 * s, parameters=p, centered=True,
                                              momentum=0.9),
        "adamax": lambda p, s=1.0: O.Adamax(0.002 * s, parameters=p),
        "lookahead": lambda p, s=1.0: O.Lookahead(O.Momentum(0.05 * s, 0.9, parameters=p),
                                                  alpha=0.5, k=5),
    }


def train_lenet_optimizers():
    """Phase 12h. The dygraph LeNet at batch 64 on synthetic MNIST, pool
    kernel on, 20 captured steps under each of Adagrad, Adadelta, RMSProp,
    Adamax and Lookahead(Momentum), one graph each, each held against the
    same 20 steps on the CPU (a half-lr control must fail); ModelAverage
    accumulated over the Lookahead run and applied for the held-out
    accuracy. Returns (the launches of the captured steps, readings)."""
    import torch

    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.models import LeNet
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import ModelAverage
    from paddle_tpu_torch.vision.datasets import MNIST

    train_set, test_set = MNIST(mode="train"), MNIST(mode="test")
    batches = [(train_set.images[i * LENET_B:(i + 1) * LENET_B],
                train_set.labels[i * LENET_B:(i + 1) * LENET_B].astype(np.int64))
               for i in range(LENET_OPT_STEPS)]
    card_batches = [[torch.from_numpy(a).cuda() for a in b] for b in batches]
    held_x = torch.from_numpy(test_set.images[:LENET_OPT_HELD_OUT]).cuda()
    held_y = torch.from_numpy(test_set.labels[:LENET_OPT_HELD_OUT].astype(np.int64)).cuda()
    init = LeNet(generator=torch.Generator().manual_seed(LENET_SEED)).state_dict()

    def loss_fn(m, x, y):
        return F.cross_entropy(m(x), y)

    def run(name, device, scale=1.0, average=None):
        model = LeNet()
        model.load_state_dict(init)
        opt = _lenet_optimizers()[name](model.parameters(), scale)
        step = train_step(model, opt, loss_fn, jit=True, device=device)
        ma = average(model) if average else None
        data = card_batches if device is None else batches
        out = []
        for b in data:
            out.append(step(*b)["loss"])
            if ma is not None:
                ma.accumulate()
        return [float(x) for x in out], model, step, ma

    r, counts = {}, {}
    set_flags({"use_pallas_pool_bwd": True})
    try:
        for name in _lenet_optimizers():
            cpu = run(name, "cpu")[0]
            control = run(name, "cpu", scale=0.5)[0]
            reset_launch_counts()
            average = ((lambda m: ModelAverage(0.15, m.parameters(), min_average_window=4,
                                               max_average_window=8))
                       if name == "lookahead" else None)
            losses, model, step, ma = run(name, None, average=average)
            torch.cuda.synchronize()
            c = {k: v for k, v in launch_counts().items() if v}
            want = {"max_pool2d_backward": 2 * LENET_OPT_STEPS}
            if name == "lookahead":
                want["momentum_update"] = LENET_OPT_STEPS
            if c != want:
                raise AssertionError(f"LeNet {name}: {LENET_OPT_STEPS} steps launched {c}; "
                                     f"want {want}")
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            err = float(np.abs(np.subtract(losses, cpu)).max())
            control_err = float(np.abs(np.subtract(control, cpu)).max())
            entry = {"losses": losses, "cpu_losses": cpu, "loss_err": err,
                     "control_loss_err": control_err}
            if ma is not None:
                model.eval()
                with torch.no_grad():
                    acc = float((model(held_x).argmax(1) == held_y).float().mean())
                    live = [p.detach().clone() for p in model.parameters()]
                    with ma.apply():
                        avg_acc = float((model(held_x).argmax(1) == held_y).float().mean())
                    back = all(torch.equal(p, q) for p, q in zip(model.parameters(), live))
                entry.update(held_out_acc=acc, held_out_acc_model_average=avg_acc,
                             restored=back, windows=ma.old_num_accumulates)
                if not back or not 0.0 <= avg_acc <= 1.0:
                    raise AssertionError(f"LeNet ModelAverage: {entry}")
            # then the step's device time (it trains on: the readings above come first)
            ms, host_ms = device_ms(lambda: step(*card_batches[0]), 50)
            entry.update(step_ms_host_hidden=ms, host_ms_a_call=host_ms, graphs=len(step.store))
            r[name] = entry
            log(f"LeNet {name}: {LENET_OPT_STEPS} captured steps, {ms:.4f} ms a step (device, "
                f"host hidden; {host_ms:.4f} host ms a call), graphs {entry['graphs']}; losses "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}, {err:.3g} from the CPU's (atol "
                f"{LENET_OPT_LOSS_ATOL}; half-lr control {control_err:.3g})"
                + (f"; held-out accuracy {entry['held_out_acc']:.4f}, under ModelAverage "
                   f"{entry['held_out_acc_model_average']:.4f}" if ma is not None else ""))
            if not (err <= LENET_OPT_LOSS_ATOL < control_err and entry["graphs"] == 1
                    and losses[-1] < losses[0]):
                raise AssertionError(f"LeNet {name}: {entry}")
            del model, step
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    return counts, r


# -- GPT-2 small generation: the ring KV cache, the engine's graphs, continuous serving -------

GPT_SEED = 18
GPT_DEVICE = "cuda"
GPT_SLOTS, GPT_CACHE, GPT_BUCKETS = 16, 1024, (64, 128, 256, 512)
GPT_PARAMS = 124_475_904  # GPT-2 small with the 50,304-token vocabulary
GPT_PARITY_PROMPTS, GPT_NEW = (17, 100, 300, 500), 64
# cached logits against the card's full forward, and the card's full forward
# against the CPU's, relative to the largest |logit|: 12 layers of f32 sums
# in another order sit ~1e-6 apart; a TF32 forward, the control, ~1e-3
GPT_LOGITS_RTOL = 3e-5
GPT_GAP = 1e-3  # tokens are held where the reference's top-two gap is above this
GPT_WRAP_CACHE, GPT_WRAP_BUCKETS, GPT_WRAP_PROMPT, GPT_WRAP_NEW = 128, (32, 64, 128), 100, 100
GPT_EQUAL_STEPS = 3  # decode steps held captured against eager from the same state
GPT_SAMPLES, GPT_TOP_K, GPT_P_MIN = 4096, 50, 1e-3
GPT_REQUESTS, GPT_STREAMED, GPT_SOLO = 32, 4, 8
GPT_PROMPT_LENS, GPT_NEW_LENS = (16, 500), (16, 128)  # the served requests' ranges
GPT_TIMED = 10  # calls a side for each mean wall
_GPT_SRC = "paddle_tpu_torch/generation/engine.py"


def _gpt_model():
    """GPT-2 small (``GPTConfig()``) on the card from a seed, eval, its
    window the cache's."""
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    gen = torch.Generator(device=GPT_DEVICE).manual_seed(GPT_SEED)
    model = GPTForCausalLM(GPTConfig(attention_window=GPT_CACHE), generator=gen, device=GPT_DEVICE)
    return model.eval()


def _gpt_prompt(rng, n, vocab):
    return [int(t) for t in rng.randint(3, vocab, size=n)]


def _full_logits(model, ids, window, blind=False):
    """The card's uncached forward over ``ids``: logits ``[T, V]`` under the
    causal mask of width ``window`` (``blind``: each query also blind to its
    own position, the mask-off-by-one control)."""
    import torch

    from paddle_tpu_torch.nn.transformer import causal_mask

    t = len(ids)
    mask = causal_mask(t, window=window, device=GPT_DEVICE)
    if blind:
        mask = mask + torch.diag(torch.full((t,), -1e9, device=GPT_DEVICE))
    with torch.no_grad():
        return model(torch.tensor([ids], device=GPT_DEVICE), attention_mask=mask)[0]


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


@contextlib.contextmanager
def _tf32():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _tokens_held(tokens, full):
    """(positions held, held ones whose token is not the full forward's
    argmax): a position is held where the top-two gap is above
    ``GPT_GAP``."""
    import torch

    top2 = full.topk(2, dim=-1).values.cpu()
    held = (top2[:, 0] - top2[:, 1]) > GPT_GAP
    wrong = held & (full.argmax(-1).cpu() != torch.tensor(tokens))
    return int(held.sum()), int(wrong.sum())


def _decode_logged(eng, slots, prompts, new):
    """``prompts`` admitted into ``slots`` and decoded greedily to ``new``
    tokens each, every row of logits kept (on the host): (tokens, logits
    ``[new, V]``) by slot."""
    import torch

    toks, rows = {}, {}
    for s, p in zip(slots, prompts):
        toks[s] = [eng.admit(s, p, 0.0)]
        rows[s] = [eng.last_logits[0].to("cpu", copy=True)]
    last = np.zeros(eng.slots, np.int32)
    temps = np.zeros(eng.slots, np.float32)
    for _ in range(new - 1):
        for s in slots:
            last[s] = toks[s][-1]
        nxt = eng.step(last, temps)
        logits = eng.last_logits.to("cpu", copy=True)
        for s in slots:
            toks[s].append(int(nxt[s]))
            rows[s].append(logits[s])
    return toks, {s: torch.stack(r) for s, r in rows.items()}


def _gpt_parity(model, eng):
    """Step 1: 4 prompts decoded 64 greedy tokens through the engine against
    the card's uncached forward over each generated sequence (TF32 and
    mask-off-by-one controls), and one full forward against the CPU's."""
    import torch

    vocab = model.config.vocab_size
    rng = np.random.RandomState(GPT_SEED)
    prompts = [_gpt_prompt(rng, n, vocab) for n in GPT_PARITY_PROMPTS]
    slots = list(range(len(prompts)))
    toks, cached = _decode_logged(eng, slots, prompts, GPT_NEW)
    err = tf32 = 0.0
    held = wrong = wrong_blind = 0
    longest = None
    for s, p in zip(slots, prompts):
        seq = p + toks[s][:-1]
        full = _full_logits(model, seq, GPT_CACHE)[len(p) - 1:]
        with _tf32():
            full_tf32 = _full_logits(model, seq, GPT_CACHE)[len(p) - 1:]
        blind = _full_logits(model, seq, GPT_CACHE, blind=True)[len(p) - 1:]
        err = max(err, _rel_max(cached[s], full.cpu()))
        tf32 = max(tf32, _rel_max(cached[s], full_tf32.cpu()))
        h, w = _tokens_held(toks[s], full)
        held, wrong = held + h, wrong + w
        wrong_blind += _tokens_held(toks[s], blind)[1]
        longest = seq
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        cpu = cpu_model(torch.tensor([longest]))[0]
    card_cpu = _rel_max(_full_logits(model, longest, GPT_CACHE).cpu(), cpu)
    with _tf32():
        card_cpu_tf32 = _rel_max(_full_logits(model, longest, GPT_CACHE).cpu(), cpu)
    del cpu_model
    r = {"prompts": list(GPT_PARITY_PROMPTS), "new_tokens": GPT_NEW,
         "cached_vs_full_rel": err, "control_tf32_rel": tf32, "limit_rel": GPT_LOGITS_RTOL,
         "tokens_held": held, "tokens_compared": GPT_NEW * len(prompts),
         "tokens_differing": wrong, "control_mask_off_by_one_differing": wrong_blind,
         "card_vs_cpu_rel": card_cpu, "card_vs_cpu_control_tf32_rel": card_cpu_tf32}
    log(f"gpt parity: {r}")
    if not (err <= GPT_LOGITS_RTOL < tf32 and card_cpu <= GPT_LOGITS_RTOL < card_cpu_tf32):
        raise AssertionError(f"gpt: logits limit {GPT_LOGITS_RTOL} missed, or a TF32 control "
                             f"passed it: {r}")
    if wrong or not wrong_blind or held < GPT_NEW * len(prompts) // 2:
        raise AssertionError(f"gpt: greedy tokens part from the full forward's argmax at a "
                             f"held position, the off-by-one mask agreed, or too few held: {r}")
    return r


def _gpt_ring_wrap(model):
    """Step 2: a 100-token prompt decoded 100 tokens through a ring of 128
    (it wraps at position 128) against the full forward under a window of
    128; the window of 129 is the control."""
    from paddle_tpu_torch.generation import GenerationEngine

    eng = GenerationEngine(model, slots=1, cache_len=GPT_WRAP_CACHE,
                           prefill_buckets=GPT_WRAP_BUCKETS, seed=GPT_SEED,
                           device=GPT_DEVICE).warmup()
    prompt = _gpt_prompt(np.random.RandomState(GPT_SEED + 1), GPT_WRAP_PROMPT,
                         model.config.vocab_size)
    toks, cached = _decode_logged(eng, [0], [prompt], GPT_WRAP_NEW)
    seq = prompt + toks[0][:-1]
    full = _full_logits(model, seq, GPT_WRAP_CACHE)[len(prompt) - 1:]
    wide = _full_logits(model, seq, GPT_WRAP_CACHE + 1)[len(prompt) - 1:]
    held, wrong = _tokens_held(toks[0], full)
    r = {"cache_len": GPT_WRAP_CACHE, "positions": [len(prompt), len(seq)],
         "cached_vs_window_rel": _rel_max(cached[0], full.cpu()),
         "control_window_plus_one_rel": _rel_max(cached[0], wide.cpu()),
         "limit_rel": GPT_LOGITS_RTOL, "tokens_held": held, "tokens_differing": wrong,
         "graphs": eng.graphs(), "extra_compiles": eng.extra_compiles()}
    log(f"gpt ring wrap: {r}")
    if not (r["cached_vs_window_rel"] <= GPT_LOGITS_RTOL < r["control_window_plus_one_rel"]) \
            or wrong or r["graphs"] != len(GPT_WRAP_BUCKETS) + 1 or r["extra_compiles"]:
        raise AssertionError(f"gpt: the ring past its wrap parts from the windowed forward: {r}")
    return r


def _snapshot_kv(eng):
    return [t.clone() for t in eng.kv]


def _restore_kv(eng, snap):
    for t, s in zip(eng.kv, snap):
        t.copy_(s)


def _gpt_captured_vs_eager(eng, model):
    """Step 3 and 6: every bucket's prefill and ``GPT_EQUAL_STEPS`` decode
    steps at 16 busy slots replayed and run eagerly from the same state,
    bit for bit; TTFT per bucket and the decode step timed both ways (host
    clock, each call ending in the token's copy to the host); one profiled
    decode replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    vocab = model.config.vocab_size
    rng = np.random.RandomState(GPT_SEED + 2)
    r = {"ttft_ms": {}}

    def timed(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(GPT_TIMED):
            fn()
        return (time.perf_counter() - t0) * 1e3 / GPT_TIMED

    for bucket in GPT_BUCKETS:
        prompt = _gpt_prompt(rng, bucket, vocab)
        snap = _snapshot_kv(eng)
        got = (eng.admit(1, prompt), eng.last_logits.clone())
        _restore_kv(eng, snap)
        eng.jit = False
        want = (eng.admit(1, prompt), eng.last_logits.clone())
        eager_ms = timed(lambda: eng.admit(1, prompt))
        eng.jit = True
        captured_ms = timed(lambda: eng.admit(1, prompt))
        if got[0] != want[0] or not torch.equal(got[1], want[1]):
            raise AssertionError(f"gpt: the bucket {bucket} prefill replay parts from eager")
        r["ttft_ms"][bucket] = {"captured": captured_ms, "eager": eager_ms}
        log(f"gpt prefill bucket {bucket}: TTFT captured {captured_ms:.3f} ms, eager "
            f"{eager_ms:.3f} ms (host clock, token on the host); replay == eager bit for bit")
    # 16 busy slots
    last = np.zeros(eng.slots, np.int32)
    for s in range(eng.slots):
        last[s] = eng.admit(s, _gpt_prompt(rng, int(rng.randint(GPT_PROMPT_LENS[0],
                                                                GPT_PROMPT_LENS[1] + 1)), vocab))
    temps = np.zeros(eng.slots, np.float32)
    for _ in range(GPT_EQUAL_STEPS):
        snap = _snapshot_kv(eng)
        got = (eng.step(last, temps), eng.last_logits.clone())
        after = _snapshot_kv(eng)
        _restore_kv(eng, snap)
        eng.jit = False
        want = (eng.step(last, temps), eng.last_logits.clone())
        eng.jit = True
        if not (np.array_equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and all(torch.equal(a, b) for a, b in zip(after, eng.kv))):
            raise AssertionError("gpt: a decode replay parts from the eager step from the "
                                 "same state (tokens, logits or cache)")
        last = got[0]
        del snap, after
    eng.jit = False
    eager_ms = timed(lambda: eng.step(last, temps))
    eng.jit = True
    captured_ms = timed(lambda: eng.step(last, temps))
    eng.step(last, temps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(last, temps)
        wall = (time.perf_counter() - t0) * 1e3
    _, busy, events = _log_profile(prof, wall, "gpt decode replay (16 slots)")
    by_kind = _device_time_by_kind(prof)[0]
    if _profiled_launches(prof):
        raise AssertionError(f"gpt: the decode step ran a port kernel: {_profiled_launches(prof)}")
    bytes_moved = eng.param_nbytes() + eng.cache_nbytes()
    r["decode"] = {"captured_ms": captured_ms, "eager_ms": eager_ms, "profiled_wall_ms": wall,
                   "busy_ms": busy, "device_events": events, "by_kind_ms": by_kind,
                   "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
                   "bytes": bytes_moved, "tokens_per_s": eng.slots / captured_ms * 1e3}
    log(f"gpt decode step at 16 busy slots: captured {captured_ms:.3f} ms, eager "
        f"{eager_ms:.3f} ms (host clock, tokens on the host); bound {r['decode']['bound_ms']:.3f} ms "
        f"({bytes_moved} bytes: the weights and the full 16 x {GPT_CACHE} window, once); "
        f"replay == eager bit for bit over {GPT_EQUAL_STEPS} steps")
    return r


def _gpt_sampling(eng):
    """Step 4: 4,096 draws at temperature 1, top-k 50 from one position's
    logits: all inside the top 50, a chi-square test against the softmax
    (the uniform over the top 50 the control it must reject); the greedy
    rows of a mixed-temperature batch equal to pure greedy."""
    import torch
    from scipy import stats

    from paddle_tpu_torch.generation import sample_logits

    rows = eng.last_logits.clone()  # the last decode step's [16, V]
    gen = torch.Generator(device=GPT_DEVICE).manual_seed(GPT_SEED)
    draws = sample_logits(rows[0].expand(GPT_SAMPLES, -1).contiguous(), gen, 1.0,
                          top_k=GPT_TOP_K).cpu().numpy()
    top = rows[0].topk(GPT_TOP_K)
    ids = top.indices.cpu().numpy()
    z = top.values.double().cpu().numpy()
    p = np.exp(z - z.max())
    p /= p.sum()
    inside = np.isin(draws, ids)
    counts = np.array([(draws == i).sum() for i in ids], np.float64)
    pval = stats.chisquare(counts, p * counts.sum()).pvalue
    pval_uniform = stats.chisquare(counts).pvalue
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7] * (rows.shape[0] // 4), device=GPT_DEVICE)
    mixed = sample_logits(rows, gen, temps, top_k=GPT_TOP_K).cpu()
    greedy = sample_logits(rows, gen, 0.0).cpu()
    g = (temps == 0).cpu()
    r = {"draws": GPT_SAMPLES, "top_k": GPT_TOP_K, "outside_top_k": int((~inside).sum()),
         "chi2_p": float(pval), "control_uniform_p": float(pval_uniform), "p_min": GPT_P_MIN,
         "greedy_rows_equal": bool(torch.equal(mixed[g], greedy[g]))}
    log(f"gpt sampling: {r}")
    if r["outside_top_k"] or not pval > GPT_P_MIN > pval_uniform or not r["greedy_rows_equal"]:
        raise AssertionError(f"gpt: sampling failed its checks: {r}")
    return r


def _stream(url, body, timeout=300):
    """POST a streamed ``/generate``: (tokens, final line, arrival times of
    the token lines)."""
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, times, final = [], [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            obj = json.loads(line)
            if "token" in obj:
                toks.append(obj["token"])
                times.append(time.perf_counter())
            else:
                final = obj
    return toks, final, times


def _gpt_requests(vocab):
    """12i's 32 requests: (prompt of 16-500 tokens, 16-128 new)."""
    rng = np.random.RandomState(GPT_SEED + 3)
    return [(_gpt_prompt(rng, int(rng.randint(GPT_PROMPT_LENS[0], GPT_PROMPT_LENS[1] + 1)),
                         vocab),
             int(rng.randint(GPT_NEW_LENS[0], GPT_NEW_LENS[1] + 1)))
            for _ in range(GPT_REQUESTS)]


def _gpt_http(model, solo_eng):
    """Step 5: ``GenerationServer`` with 16 slots, 32 concurrent requests
    (prompts 16-500 tokens, 16-128 new, 4 streamed); 8 answers against solo
    runs; ``/statz`` with no unexpected capture; tokens/s, TTFT and the
    inter-token times."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.serving import GenerationServer

    reqs = _gpt_requests(model.config.vocab_size)
    eng = GenerationEngine(model, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_BUCKETS, seed=GPT_SEED, device=GPT_DEVICE)
    srv = GenerationServer(eng, port=0, queue_capacity=2 * GPT_REQUESTS)
    t0 = time.perf_counter()
    srv.start()
    warm_s = time.perf_counter() - t0
    out = [None] * GPT_REQUESTS
    gaps = []
    try:
        if _http(srv.url + "/healthz")[0] != 200:
            raise AssertionError("gpt: /healthz not ready after warmup")

        def post(i):
            prompt, new = reqs[i]
            body = {"prompt": prompt, "max_new_tokens": new, "temperature": 0.0}
            if i < GPT_STREAMED:
                toks, final, times = _stream(srv.url, dict(body, stream=True))
                if final is None or final.get("tokens") != toks:
                    raise AssertionError(f"gpt: stream {i} ended {final}")
                gaps.extend(np.diff(times) * 1e3)
                out[i] = toks
            else:
                status, ans = _http(srv.url + "/generate", body)
                if status != 200:
                    raise AssertionError(f"gpt: request {i} answered {status}: {ans}")
                out[i] = ans["tokens"]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(GPT_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        statz = _http(srv.url + "/statz")[1]
    finally:
        srv.stop(drain=True)
    if any(o is None for o in out):
        raise AssertionError(f"gpt: {sum(o is None for o in out)} requests got no answer")
    tokens = sum(len(o) for o in out)
    solo = [solo_eng.generate([p], max_new_tokens=n, temperature=0.0)[0]
            for p, n in reqs[:GPT_SOLO]]
    same = sum(a == b for a, b in zip(out[:GPT_SOLO], solo))
    r = {"requests": GPT_REQUESTS, "streamed": GPT_STREAMED, "warmup_s": warm_s,
         "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
         "inter_token_ms": {"p50": float(np.percentile(gaps, 50)),
                            "p99": float(np.percentile(gaps, 99)), "count": len(gaps)},
         "statz_latency": statz["latency"], "statz_compiles": statz["compiles"],
         "solo_equal": f"{same}/{GPT_SOLO}", "extra_compiles": eng.extra_compiles(),
         "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"gpt HTTP: {r}")
    if same != GPT_SOLO or statz["compiles"]["unexpected"] or eng.extra_compiles() \
            or statz["compiles"]["programs"] != len(GPT_BUCKETS) + 1:
        raise AssertionError(f"gpt: co-batched answers part from solo runs, or the requests "
                             f"captured graphs: {r}")
    return r


def serve_gpt():
    """Phase 12i. GPT-2 small at full width (``GPTConfig()``: 12 layers, 768
    wide, 12 heads, 1024 positions, a 50,304-token vocabulary; 124,475,904
    parameters from a seed, eval) through ``GenerationEngine`` (16 slots, a
    ring of 1024, prefill buckets 64-512, f32) and ``GenerationServer``.
    Returns (the port's kernel launches over the phase, which must be none:
    the path is pre-norm and cached, plain PyTorch as in the JAX package;
    readings)."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _gpt_model()
    params = sum(p.numel() for p in model.parameters())
    if params != GPT_PARAMS:
        raise AssertionError(f"gpt: {params} parameters, GPT-2 small has {GPT_PARAMS}")
    reset_launch_counts()
    eng = GenerationEngine(model, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_BUCKETS, seed=GPT_SEED, device=GPT_DEVICE)
    t0 = time.perf_counter()
    eng.warmup()
    r = {"params": params, "param_bytes": eng.param_nbytes(), "kv_cache_bytes": eng.cache_nbytes(),
         "kv_bytes_per_token": eng.kv_bytes_per_token(), "warmup_s": time.perf_counter() - t0,
         "graphs_after_warmup": eng.graphs()}
    log(f"gpt engine warm: {r}")
    if eng.graphs() != eng.expected_compiles() or eng.compile_count() != len(GPT_BUCKETS) + 1:
        raise AssertionError(f"gpt: warmup captured {eng.graphs()} graphs for "
                             f"{len(GPT_BUCKETS)} buckets + decode")
    r["parity"] = _gpt_parity(model, eng)
    r["ring_wrap"] = _gpt_ring_wrap(model)
    r.update(_gpt_captured_vs_eager(eng, model))
    r["sampling"] = _gpt_sampling(eng)
    eng.reset()
    r["http"] = _gpt_http(model, eng)
    r["extra_compiles"] = eng.extra_compiles()
    r["graphs"] = eng.graphs()
    if r["extra_compiles"] or r["graphs"] != len(GPT_BUCKETS) + 1:
        raise AssertionError(f"gpt: the engine captured after warmup: {r['extra_compiles']}")
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"gpt: the generation path launched the port's kernels: {counts}")
    p = GPT_BUCKETS[-1]
    cfg = model.config
    h, f, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    flops = p * (2 * layers * (4 * h * h + 2 * h * f) + 4 * GPT_CACHE * h * layers
                 + 2 * h * cfg.vocab_size)
    r["prefill_bound_ms"] = {p: max(flops / FP32_FLOPS_PER_S,
                                    eng.param_nbytes() / HBM_BYTES_PER_S) * 1e3}
    r["prefill_flops"] = {p: flops}
    r["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"gpt: phase done in {r['phase_s']:.1f} s, peak {r['peak_memory_gib']:.2f} GiB; "
        f"prefill bound at {p}: {r['prefill_bound_ms'][p]:.3f} ms ({flops / 1e9:.1f} GFLOP)")
    del eng, model
    torch.cuda.empty_cache()
    return counts, r


# -- GPT-2 small: the int8 ring and the paged layout (phase 12j) ----------------------------

GPT_PAGE = 16
# int8 logits against the card's uncached f32 forward, relative to its
# largest |logit|: the JAX package's int8 envelope (tests/test_quant_e2e.py:113)
GPT_INT8_ENVELOPE = 0.05
GPT_INT8_CONTROL_BNT = 7.0  # a 4-bit grid: the control read the envelope must catch
GPT_SHARED_SUFFIXES, GPT_SHARED_NEW = (16, 40, 100, 128), 32  # prefix-reuse parity
GPT_PAGED_SLOTS = 32  # the paged int8 server: twice the f32 ring's slots
GPT_SYSTEM_PROMPTS, GPT_SYSTEM_LEN = 4, 256  # 16 full pages each
GPT_PAGED_REQUESTS, GPT_PAGED_STREAMED, GPT_TENANTS = 64, 4, 4
GPT_SUFFIX_LENS, GPT_PAGED_NEW_LENS = (16, 128), (32, 128)


def _decode_forced(eng, slots, prompts, tokens):
    """``prompts`` admitted into ``slots`` and decoded along the given
    ``tokens`` (teacher forcing: each step is fed the given token, not the
    engine's own): the logits of every position ``[len(tokens), V]`` by
    slot, on the host."""
    import torch

    rows = {}
    for s, p in zip(slots, prompts):
        eng.admit(s, p, 0.0)
        rows[s] = [eng.last_logits[0].to("cpu", copy=True)]
    last = np.zeros(eng.slots, np.int32)
    temps = np.zeros(eng.slots, np.float32)
    for i in range(len(tokens[slots[0]]) - 1):
        for s in slots:
            last[s] = tokens[s][i]
        eng.step(last, temps)
        logits = eng.last_logits.to("cpu", copy=True)
        for s in slots:
            rows[s].append(logits[s])
    return {s: torch.stack(r) for s, r in rows.items()}


def _int8_read(model, prompts, toks, cached):
    """(the largest error relative to the full forward's largest |logit|,
    positions held, held positions whose argmax parts, positions): a
    position is held where the f32 top-two gap is above twice the int8
    logits' own largest error there, so equal argmaxes are implied."""
    rel, held, wrong, n = 0.0, 0, 0, 0
    for s, p in enumerate(prompts):
        full = _full_logits(model, p + toks[s][:-1], GPT_CACHE)[len(p) - 1:].cpu()
        rel = max(rel, _rel_max(cached[s], full))
        err = (cached[s] - full).abs().amax(-1)
        top2 = full.topk(2, dim=-1).values
        h = (top2[:, 0] - top2[:, 1]) > 2 * err
        held += int(h.sum())
        wrong += int((h & (cached[s].argmax(-1) != full.argmax(-1))).sum())
        n += full.shape[0]
    return rel, held, wrong, n


def _gpt_int8_ring(model, ring):
    """12j step 1: the int8 ring, 16 slots x 1024: its bytes against the
    f32 ring's and the plan; ``quantize_kv`` on the card bit-equal to the
    CPU's on GPT-2's K/V planes; 256 cached positions and a ring of 128 past
    its wrap within the int8 envelope of the card's f32 forward (a 4-bit
    grid the control), argmax equal where implied; then the int8 engine's
    timings (``_gpt_captured_vs_eager``)."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.nn import transformer as ptf

    vocab = model.config.vocab_size
    t0 = time.perf_counter()
    eng = GenerationEngine(model, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_BUCKETS, kv_cache_dtype="int8", seed=GPT_SEED,
                           device=GPT_DEVICE).warmup()
    pos_bytes = 4 * GPT_SLOTS
    cfg = model.config
    per_token = eng.kv_bytes_per_token()  # 19,584 at GPT-2 small: 2 x 12 x 12 x (64 + 4)
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    r = {"warmup_s": time.perf_counter() - t0, "graphs": eng.graphs(),
         "kv_bytes_per_token": per_token, "cache_bytes": eng.cache_nbytes(),
         "f32_ring_cache_bytes": ring.cache_nbytes(),
         "plan_bytes": eng.hbm_required_bytes() - eng.param_nbytes(),
         "tensor_bytes": sum(t.numel() * t.element_size() for t in eng.kv)}
    r["bytes_ratio"] = (r["f32_ring_cache_bytes"] - pos_bytes) / (r["cache_bytes"] - pos_bytes)
    log(f"gpt int8 ring: {r}")
    if not (r["cache_bytes"] == r["plan_bytes"] == r["tensor_bytes"]
            == GPT_SLOTS * GPT_CACHE * per_token + pos_bytes
            and per_token == 2 * cfg.num_hidden_layers * cfg.num_attention_heads * (head_dim + 4)
            and (r["f32_ring_cache_bytes"] - pos_bytes) * per_token
            == (r["cache_bytes"] - pos_bytes) * ring.kv_bytes_per_token()
            and r["graphs"] == len(GPT_BUCKETS) + 1):
        raise AssertionError(f"gpt int8: bytes or graphs off the plan: {r}")
    # quantize_kv on the card against the CPU on the same K/V planes
    rng = np.random.RandomState(GPT_SEED + 4)
    ring.admit(0, _gpt_prompt(rng, GPT_BUCKETS[-1], vocab))
    same = True
    for plane in ring.kv[:2]:
        x = plane[:, 0, :, :GPT_BUCKETS[-1]].contiguous()  # [L, H, 512, D]
        q, s = ptf.quantize_kv(x)
        qc, sc = ptf.quantize_kv(x.cpu())
        same = same and torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    ring.reset()
    r["quantize_kv_card_equals_cpu"] = same
    # 256 cached positions against the card's uncached f32 forward
    rs = np.random.RandomState(GPT_SEED)
    prompts = [_gpt_prompt(rs, n, vocab) for n in GPT_PARITY_PROMPTS]
    slots = list(range(len(prompts)))
    toks, cached = _decode_logged(eng, slots, prompts, GPT_NEW)
    rel, held, wrong, n = _int8_read(model, prompts, toks, cached)
    # the control: the same read on a 4-bit grid, eager (a graph keeps the
    # grid it was captured with)
    eng.reset()
    eng.jit = False
    ptf.KV_QUANT_BNT = GPT_INT8_CONTROL_BNT
    try:
        control = _decode_forced(eng, slots, prompts, toks)
    finally:
        ptf.KV_QUANT_BNT = 127.0
        eng.jit = True
    rel_control = _int8_read(model, prompts, toks, control)[0]
    eng.reset()
    # past the wrap of a ring of 128
    w8 = GenerationEngine(model, slots=1, cache_len=GPT_WRAP_CACHE,
                          prefill_buckets=GPT_WRAP_BUCKETS, kv_cache_dtype="int8",
                          seed=GPT_SEED, device=GPT_DEVICE).warmup()
    wprompt = _gpt_prompt(np.random.RandomState(GPT_SEED + 1), GPT_WRAP_PROMPT, vocab)
    wtoks, wcached = _decode_logged(w8, [0], [wprompt], GPT_WRAP_NEW)
    wfull = _full_logits(model, wprompt + wtoks[0][:-1], GPT_WRAP_CACHE)[len(wprompt) - 1:].cpu()
    werr = (wcached[0] - wfull).abs().amax(-1)
    top2 = wfull.topk(2, dim=-1).values
    wheld = (top2[:, 0] - top2[:, 1]) > 2 * werr
    r.update({"positions": n, "int8_vs_f32_rel": rel, "control_4bit_rel": rel_control,
              "envelope_rel": GPT_INT8_ENVELOPE, "argmax_held": held, "argmax_differing": wrong,
              "wrap_rel": _rel_max(wcached[0], wfull), "wrap_held": int(wheld.sum()),
              "wrap_differing": int((wheld & (wcached[0].argmax(-1) != wfull.argmax(-1))).sum()),
              "wrap_graphs": w8.graphs(), "wrap_extra_compiles": w8.extra_compiles()})
    del w8
    log(f"gpt int8 read: {r}")
    if not (same and rel <= GPT_INT8_ENVELOPE < rel_control and not wrong
            and r["wrap_rel"] <= GPT_INT8_ENVELOPE and not r["wrap_differing"]
            and r["wrap_graphs"] == len(GPT_WRAP_BUCKETS) + 1 and not r["wrap_extra_compiles"]):
        raise AssertionError(f"gpt int8: outside the envelope, the 4-bit control inside it, an "
                             f"implied argmax parted, or quantize_kv parted from the CPU: {r}")
    r.update(_gpt_captured_vs_eager(eng, model))
    r["extra_compiles"] = eng.extra_compiles()
    if r["extra_compiles"] or eng.graphs() != len(GPT_BUCKETS) + 1:
        raise AssertionError(f"gpt int8: the engine captured after warmup: {r}")
    del eng
    return r


def _fill_slots(eng, rng, vocab):
    """Every slot admitted with a prompt of 16-500 tokens; the last tokens."""
    last = np.zeros(eng.slots, np.int32)
    for s in range(eng.slots):
        n = int(rng.randint(GPT_PROMPT_LENS[0], GPT_PROMPT_LENS[1] + 1))
        last[s] = eng.admit(s, _gpt_prompt(rng, n, vocab))
    return last


def _gpt_paged_f32(model, ring):
    """12j step 2: the paged layout in f32 (page 16, 16 slots, the default
    pool): bit-equal to the ring where no full page is shared; a ring of 128
    wrapped back into pages the prefix index holds (copy-on-write), tokens
    equal to the ring's, and again on a pool of one window after another
    prompt (LRU eviction at admission, the index forgetting the chain at
    the wrap); prompts sharing a 256-token prefix, logits within
    3e-5 of the ring's largest, tokens equal where its gap is above 1e-3;
    the decode step captured, eager and against the ring's."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine

    vocab = model.config.vocab_size
    kw = dict(kv_cache_layout="paged", kv_page_size=GPT_PAGE, seed=GPT_SEED, device=GPT_DEVICE)
    t0 = time.perf_counter()
    eng = GenerationEngine(model, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_BUCKETS, **kw).warmup()
    st = eng.paging_stats()
    r = {"warmup_s": time.perf_counter() - t0, "graphs": eng.graphs(),
         "pages": st["pages_total"], "page_nbytes": st["page_nbytes"],
         "cache_bytes": eng.cache_nbytes(),
         "plan_bytes": eng.hbm_required_bytes() - eng.param_nbytes()}
    if not (r["pages"] == GPT_SLOTS * GPT_CACHE // GPT_PAGE
            and r["page_nbytes"] == GPT_PAGE * ring.kv_bytes_per_token()
            and r["cache_bytes"] == r["plan_bytes"] and r["graphs"] == len(GPT_BUCKETS) + 1):
        raise AssertionError(f"gpt paged: pool or graphs off the plan: {r}")
    # no full page shared: bit-equal to the ring
    rs = np.random.RandomState(GPT_SEED)
    prompts = [_gpt_prompt(rs, n, vocab) for n in GPT_PARITY_PROMPTS]
    slots = list(range(len(prompts)))
    ring.reset()
    rtoks, rrows = _decode_logged(ring, slots, prompts, GPT_NEW)
    ptoks, prows = _decode_logged(eng, slots, prompts, GPT_NEW)
    r["unshared"] = {"tokens_equal": all(rtoks[s] == ptoks[s] for s in slots),
                     "logits_bit_equal": all(torch.equal(rrows[s], prows[s]) for s in slots),
                     "prefix_hits": eng.paging_stats()["prefix_index"]["hits"]}
    # a ring of 128 decoded past its wrap, into pages the index holds; a
    # pool of two windows has the pages to copy them (with one, the index
    # would forget them instead: the pressure valve)
    wkw = dict(slots=1, cache_len=GPT_WRAP_CACHE, prefill_buckets=GPT_WRAP_BUCKETS)
    wring = GenerationEngine(model, seed=GPT_SEED, device=GPT_DEVICE, **wkw).warmup()
    wpaged = GenerationEngine(model, kv_pool_pages=2 * GPT_WRAP_CACHE // GPT_PAGE, **wkw,
                              **kw).warmup()
    wprompt = _gpt_prompt(np.random.RandomState(GPT_SEED + 1), GPT_WRAP_PROMPT, vocab)
    wr_toks, wr_rows = _decode_logged(wring, [0], [wprompt], GPT_WRAP_NEW)
    wp_toks, wp_rows = _decode_logged(wpaged, [0], [wprompt], GPT_WRAP_NEW)
    wst = wpaged.paging_stats()
    # a pool of one window, another prompt's pages left in the index:
    # admission evicts them (LRU) and the wrap takes the pressure valve
    wvalve = GenerationEngine(model, kv_pool_pages=GPT_WRAP_CACHE // GPT_PAGE, **wkw,
                              **kw).warmup()
    other = _gpt_prompt(np.random.RandomState(GPT_SEED + 8), GPT_WRAP_PROMPT, vocab)
    wvalve.generate([other], max_new_tokens=GPT_WRAP_CACHE - GPT_WRAP_PROMPT, temperature=0.0)
    held = wvalve.paging_stats()["prefix_index"]["pages"]
    wv_toks, wv_rows = _decode_logged(wvalve, [0], [wprompt], GPT_WRAP_NEW)
    vst = wvalve.paging_stats()
    r["wrap"] = {"tokens_equal": wr_toks[0] == wp_toks[0],
                 "logits_max_abs_diff": float((wr_rows[0] - wp_rows[0]).abs().max()),
                 "cow_copies": wst["cow_copies"], "index_pages": wst["prefix_index"]["pages"],
                 "graphs": wpaged.graphs(), "extra_compiles": wpaged.extra_compiles(),
                 "valve_tokens_equal": wr_toks[0] == wv_toks[0],
                 "valve_logits_max_abs_diff": float((wr_rows[0] - wv_rows[0]).abs().max()),
                 "valve_index_pages_before": held,
                 "valve_evictions": vst["prefix_index"]["evictions"],
                 "valve_cow_copies": vst["cow_copies"],
                 "valve_extra_compiles": wvalve.extra_compiles()}
    del wring, wpaged, wvalve
    # prompts sharing a 256-token system prompt: the ring's tokens forced
    # through the paged engine, which prefills only the suffixes
    rs = np.random.RandomState(GPT_SEED + 5)
    system = _gpt_prompt(rs, GPT_SYSTEM_LEN, vocab)
    prompts = [system + _gpt_prompt(rs, n, vocab) for n in GPT_SHARED_SUFFIXES]
    slots = list(range(len(prompts)))
    ring.reset()
    eng.reset()
    rtoks, rrows = _decode_logged(ring, slots, prompts, GPT_SHARED_NEW)
    prows = _decode_forced(eng, slots, prompts, rtoks)
    rel, held, wrong = 0.0, 0, 0
    for s in slots:
        rel = max(rel, _rel_max(prows[s], rrows[s]))
        top2 = rrows[s].topk(2, dim=-1).values
        h = (top2[:, 0] - top2[:, 1]) > GPT_GAP
        held += int(h.sum())
        wrong += int((h & (prows[s].argmax(-1) != torch.tensor(rtoks[s]))).sum())
    st = eng.paging_stats()
    r["shared"] = {"prompts": [len(p) for p in prompts], "rel": rel, "limit_rel": GPT_LOGITS_RTOL,
                   "tokens_held": held, "tokens_differing": wrong,
                   "prefix_hits": st["prefix_index"]["hits"],
                   "shared_tokens": st["per_tenant"]["default"]["shared_tokens"]}
    log(f"gpt paged f32: {r}")
    if not (r["unshared"]["tokens_equal"] and r["unshared"]["logits_bit_equal"]
            and r["wrap"]["tokens_equal"] and r["wrap"]["cow_copies"] > 0
            and not r["wrap"]["extra_compiles"] and r["wrap"]["valve_tokens_equal"]
            and r["wrap"]["valve_evictions"] > r["wrap"]["valve_index_pages_before"] > 0
            and not r["wrap"]["valve_extra_compiles"] and rel <= GPT_LOGITS_RTOL and not wrong
            and r["shared"]["prefix_hits"] == len(prompts) - 1
            and r["shared"]["shared_tokens"] == (len(prompts) - 1) * GPT_SYSTEM_LEN):
        raise AssertionError(f"gpt paged: parts from the ring: {r}")
    # the decode step at 16 busy slots: paged captured and eager, the ring's
    rng = np.random.RandomState(GPT_SEED + 6)
    ring.reset()
    eng.reset()
    last_r = _fill_slots(ring, rng, vocab)
    last_p = _fill_slots(eng, np.random.RandomState(GPT_SEED + 6), vocab)
    temps = np.zeros(GPT_SLOTS, np.float32)

    def timed(e, last):
        e.step(last, temps)
        t = time.perf_counter()
        for _ in range(GPT_TIMED):
            e.step(last, temps)
        return (time.perf_counter() - t) * 1e3 / GPT_TIMED

    ring_ms = timed(ring, last_r)
    captured_ms = timed(eng, last_p)
    eng.jit = False
    eager_ms = timed(eng, last_p)
    eng.jit = True
    captured2_ms, ring2_ms = timed(eng, last_p), timed(ring, last_r)
    r["decode"] = {"captured_ms": [captured_ms, captured2_ms], "eager_ms": eager_ms,
                   "ring_captured_ms": [ring_ms, ring2_ms]}
    r["extra_compiles"] = eng.extra_compiles()
    log(f"gpt paged f32 decode at 16 busy slots (host clock, tokens on the host): {r['decode']}")
    if r["extra_compiles"]:
        raise AssertionError(f"gpt paged: the engine captured after warmup: {r}")
    ring.reset()
    del eng
    return r


def _gpt_traffic(vocab):
    """64 requests over 4 tenants: each a tenant's 256-token system prompt
    (16 full pages) and 16-128 unique tokens, 32-128 new tokens; the first
    4 streamed."""
    rng = np.random.RandomState(GPT_SEED + 7)
    systems = [_gpt_prompt(rng, GPT_SYSTEM_LEN, vocab) for _ in range(GPT_SYSTEM_PROMPTS)]
    reqs = []
    for i in range(GPT_PAGED_REQUESTS):
        t = i % GPT_TENANTS
        n = int(rng.randint(GPT_SUFFIX_LENS[0], GPT_SUFFIX_LENS[1] + 1))
        reqs.append({"prompt": systems[t % GPT_SYSTEM_PROMPTS] + _gpt_prompt(rng, n, vocab),
                     "max_new_tokens": int(rng.randint(GPT_PAGED_NEW_LENS[0],
                                                       GPT_PAGED_NEW_LENS[1] + 1)),
                     "temperature": 0.0, "tenant": f"tenant{t}"})
    return reqs


def _serve_traffic(srv, reqs, eos, out=None):
    """``reqs`` posted at once to a started server: answers (into ``out``
    when given) checked for length and EOS; tokens/s (client clock),
    inter-token gaps of the streamed ones, ``/statz``."""
    out = [None] * len(reqs) if out is None else out
    gaps = []

    def post(i):
        body = reqs[i]
        if i < GPT_PAGED_STREAMED:
            toks, final, times = _stream(srv.url, dict(body, stream=True))
            if final is None or final.get("tokens") != toks:
                raise AssertionError(f"gpt: stream {i} ended {final}")
            gaps.extend(np.diff(times) * 1e3)
            out[i] = toks
        else:
            status, ans = _http(srv.url + "/generate", body)
            if status != 200:
                raise AssertionError(f"gpt: request {i} answered {status}: {ans}")
            out[i] = ans["tokens"]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    statz = _http(srv.url + "/statz")[1]
    bad = [i for i, (o, q) in enumerate(zip(out, reqs))
           if o is None or not 1 <= len(o) <= q["max_new_tokens"]
           or (len(o) < q["max_new_tokens"] and o[-1] != eos)]
    if bad:
        raise AssertionError(f"gpt: requests {bad} got no answer or a wrong length")
    tokens = sum(len(o) for o in out)
    return {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "inter_token_ms": {"p50": float(np.percentile(gaps, 50)),
                               "p99": float(np.percentile(gaps, 99)), "count": len(gaps)},
            "statz_latency": statz["latency"], "statz_compiles": statz["compiles"],
            "paging": statz["paging"], "kv_cache_bytes": statz["generation"]["kv_cache_bytes"]}


def _gpt_paged_http(model, ring):
    """12j step 3: ``GenerationServer`` over a paged int8 engine (32 slots,
    the default pool of 2048 + 1 pages) and over the f32 ring (16 slots),
    the same 64 requests each; ``/statz`` ``paging``: 60 prefix hits."""
    from paddle_tpu_torch.serving import GenerationServer

    reqs = _gpt_traffic(model.config.vocab_size)
    eos = model.config.eos_token_id
    srv = GenerationServer(model, port=0, slots=GPT_PAGED_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_BUCKETS, kv_cache_dtype="int8",
                           kv_cache_layout="paged", kv_page_size=GPT_PAGE,
                           queue_capacity=2 * GPT_PAGED_REQUESTS, device=GPT_DEVICE)
    t0 = time.perf_counter()
    try:
        srv.start()
        warm_s = time.perf_counter() - t0
        paged = _serve_traffic(srv, reqs, eos)
        paged["extra_compiles"] = srv.engine.extra_compiles()
    finally:
        srv.stop(drain=True)
    paged["warmup_s"] = warm_s
    del srv
    ring.reset()
    rsrv = GenerationServer(ring, port=0, queue_capacity=2 * GPT_PAGED_REQUESTS)
    try:
        rsrv.start()
        f32 = _serve_traffic(rsrv, reqs, eos)
        f32["extra_compiles"] = ring.extra_compiles()
    finally:
        rsrv.stop(drain=True)
    pg = paged["paging"]
    prompt_tokens = sum(len(q["prompt"]) for q in reqs)
    shared = sum(t["shared_tokens"] for t in pg["per_tenant"].values())
    r = {"paged_int8_32_slots": paged, "ring_f32_16_slots": f32,
         "prompt_tokens": prompt_tokens, "shared_tokens": shared,
         "shared_share": shared / prompt_tokens}
    log(f"gpt paged int8 HTTP: {r}")
    hits = GPT_PAGED_REQUESTS - GPT_SYSTEM_PROMPTS
    if not (pg["prefix_index"]["hits"] == hits and shared == hits * GPT_SYSTEM_LEN
            and not paged["extra_compiles"] and not f32["extra_compiles"]
            and not paged["statz_compiles"]["unexpected"]
            and paged["statz_compiles"]["programs"] == len(GPT_BUCKETS) + 1
            and paged["kv_cache_bytes"] == (pg["pages_total"] + 1) * pg["page_nbytes"]
            + GPT_PAGED_SLOTS * (GPT_CACHE // GPT_PAGE * 4 + 4)):
        raise AssertionError(f"gpt paged HTTP: prefix hits, bytes or captures off: {r}")
    return r


def serve_gpt_paged():
    """Phase 12j. GPT-2 small (the weights of 12i, from its seed) through
    the int8 ring, the paged layout in f32 and the paged layout in int8
    behind ``GenerationServer``, each against the f32 ring (16 slots x 1024).
    Returns (the port's kernel launches over the phase, which must be none;
    readings)."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _gpt_model()
    reset_launch_counts()
    ring = GenerationEngine(model, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                            prefill_buckets=GPT_BUCKETS, seed=GPT_SEED,
                            device=GPT_DEVICE).warmup()
    r = {"int8_ring": _gpt_int8_ring(model, ring), "paged_f32": _gpt_paged_f32(model, ring),
         "http": _gpt_paged_http(model, ring)}
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"gpt 12j: the generation path launched the port's kernels: "
                             f"{counts}")
    r["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"gpt 12j: phase done in {r['phase_s']:.1f} s, peak {r['peak_memory_gib']:.2f} GiB")
    del ring, model
    torch.cuda.empty_cache()
    return counts, r


# -- GPT-2 small: speculative decoding and the disaggregated handoff (phase 12k) -------------

GPT_DRAFT_K, GPT_DRAFT_LAYERS = 4, 1
GPT_SELF_SLOTS, GPT_SELF_BUCKETS, GPT_SELF_MIN = 4, (512,), 0.99  # the self-draft's engine
GPT_SPEC_ROUNDS = 12  # greedy rounds of 16 busy slots timed on the host clock
GPT_DISAGG_REQUESTS, GPT_DISAGG_SLOTS = 8, 8
GPT_SPEC_DECODE_SLOTS, GPT_SPEC_DECODE_SLABS = 4, 2
HANDOFF_TIMED = 5  # lone /prefill legs taken apart on the host clock


def _spec_decode_logged(eng, slots, prompts, new):
    """``prompts`` admitted into ``slots`` of a speculative engine and
    decoded greedily by rounds to ``new`` tokens each, every emitted
    token's logits kept (the prefill's for the first, then the verify
    position that sampled it; on the host): (tokens, logits ``[new, V]``)
    by slot."""
    import torch

    toks, rows = {}, {}
    for s, p in zip(slots, prompts):
        toks[s] = [eng.admit(s, p, 0.0)]
        rows[s] = [eng.last_logits[0].to("cpu", copy=True)]
    last = np.zeros(eng.slots, np.int32)
    temps = np.zeros(eng.slots, np.float32)
    active = list(slots)
    while active:
        for s in active:
            last[s] = toks[s][-1]
        ts, counts = eng.spec_step(last, temps, busy=active)
        logits = eng.last_logits[active].to("cpu", copy=True)
        for i, s in enumerate(active):
            for j in range(int(counts[s])):
                if len(toks[s]) < new:
                    toks[s].append(int(ts[s, j]))
                    rows[s].append(logits[i, j])
        active = [s for s in active if len(toks[s]) < new]
    return toks, {s: torch.stack(r) for s, r in rows.items()}


def _held_against(toks, rows, ref_toks, ref_rows):
    """(positions compared, tokens differing among them, the largest logit
    error among them relative to the reference's largest |logit| at each
    position): compared are the positions before the first where the
    reference's top-two gap is at or below ``GPT_GAP`` (and inside both
    runs), where the tokens must agree."""
    n = min(len(toks), len(ref_toks))
    top2 = ref_rows[:n].topk(2, dim=-1).values
    ties = ((top2[:, 0] - top2[:, 1]) <= GPT_GAP).nonzero()
    cover = int(ties[0, 0]) if len(ties) else n
    wrong = sum(a != b for a, b in zip(toks[:cover], ref_toks[:cover]))
    err = 0.0
    if rows is not None and cover:
        err = float(((rows[:cover] - ref_rows[:cover]).abs().amax(-1)
                     / ref_rows[:cover].abs().amax(-1)).max())
    return cover, int(wrong), err


def _spec_parity(model, draft, plain, spec):
    """12k step 1: the 4 parity prompts decoded 64 greedy tokens by the
    speculative engine against the plain one (tokens before the first near
    tie, each verify position's logits within ``GPT_LOGITS_RTOL``); the
    TF32 control (the speculative engine run eagerly under TF32) must miss
    the limit, and the draft's own greedy chain must part from the plain
    tokens where the check holds them."""
    from paddle_tpu_torch.generation import GenerationEngine

    vocab = model.config.vocab_size
    rng = np.random.RandomState(GPT_SEED)
    prompts = [_gpt_prompt(rng, n, vocab) for n in GPT_PARITY_PROMPTS]
    slots = list(range(len(prompts)))
    ref_toks, ref_rows = _decode_logged(plain, slots, prompts, GPT_NEW)
    toks, rows = _spec_decode_logged(spec, slots, prompts, GPT_NEW)
    spec.jit = False
    try:
        with _tf32():
            t_toks, t_rows = _spec_decode_logged(spec, slots, prompts, GPT_NEW)
    finally:
        spec.jit = True
    chain = GenerationEngine(draft, slots=len(prompts), cache_len=GPT_CACHE,
                             prefill_buckets=GPT_BUCKETS, seed=GPT_SEED, device=GPT_DEVICE,
                             jit=False)
    d_toks, _ = _decode_logged(chain, slots, prompts, GPT_NEW)
    del chain
    held = wrong = control_wrong = 0
    err = tf32 = 0.0
    for s in slots:
        cover, w, e = _held_against(toks[s], rows[s], ref_toks[s], ref_rows[s])
        held, wrong, err = held + cover, wrong + w, max(err, e)
        # the TF32 run compared where its own tokens still follow the plain run's
        same = next((i for i, (a, b) in enumerate(zip(t_toks[s], ref_toks[s])) if a != b),
                    GPT_NEW)
        tf32 = max(tf32, _held_against(t_toks[s][:same], t_rows[s][:same],
                                       ref_toks[s], ref_rows[s])[2])
        control_wrong += _held_against(d_toks[s], None, ref_toks[s], ref_rows[s])[1]
    r = {"prompts": list(GPT_PARITY_PROMPTS), "new_tokens": GPT_NEW,
         "positions_held": held, "positions": GPT_NEW * len(prompts),
         "tokens_differing": wrong, "verify_vs_plain_rel": err, "limit_rel": GPT_LOGITS_RTOL,
         "control_tf32_rel": tf32, "control_draft_chain_differing": control_wrong}
    log(f"gpt speculative parity: {r}")
    if wrong or not err <= GPT_LOGITS_RTOL < tf32 or not control_wrong \
            or held < GPT_NEW * len(prompts) // 2:
        raise AssertionError(f"gpt 12k: speculative tokens or logits part from the plain "
                             f"engine's, a control passed, or too few positions held: {r}")
    return r, (prompts, ref_toks, ref_rows)


def _spec_wrap_and_sampling(model, draft):
    """12k steps 2 and 4: a speculative engine over a ring of 128 (16 slots,
    top-k 50): a 100-token prompt decoded 100 greedy tokens past the wrap
    against a plain engine of the same ring; then the verify graph's
    position-0 draws at temperature 1 from 16 slots holding one state,
    restored before each round: all inside the top 50 and passing the
    chi-square test against the softmax of that position's logits (the
    uniform over the top 50 the control it must reject)."""
    import torch
    from scipy import stats

    from paddle_tpu_torch.generation import GenerationEngine

    kw = dict(cache_len=GPT_WRAP_CACHE, prefill_buckets=GPT_WRAP_BUCKETS, seed=GPT_SEED,
              device=GPT_DEVICE)
    spec = GenerationEngine(model, slots=GPT_SLOTS, top_k=GPT_TOP_K, draft_model=draft,
                            draft_k=GPT_DRAFT_K, **kw).warmup()
    plain = GenerationEngine(model, slots=1, **kw).warmup()
    prompt = _gpt_prompt(np.random.RandomState(GPT_SEED + 1), GPT_WRAP_PROMPT,
                         model.config.vocab_size)
    ref_toks, ref_rows = _decode_logged(plain, [0], [prompt], GPT_WRAP_NEW)
    toks, rows = _spec_decode_logged(spec, [0], [prompt], GPT_WRAP_NEW)
    cover, wrong, err = _held_against(toks[0], rows[0], ref_toks[0], ref_rows[0])
    wrap = {"cache_len": GPT_WRAP_CACHE, "store_len": spec.store_len,
            "positions": [len(prompt), len(prompt) + GPT_WRAP_NEW], "positions_held": cover,
            "tokens_differing": wrong, "verify_vs_plain_rel": err, "limit_rel": GPT_LOGITS_RTOL}
    log(f"gpt speculative ring wrap: {wrap}")
    if wrong or err > GPT_LOGITS_RTOL or cover < GPT_WRAP_NEW // 2:
        raise AssertionError(f"gpt 12k: the speculative ring past its wrap parts from the "
                             f"plain one: {wrap}")
    # sampling: 16 slots, one state, restored before every round
    base = _gpt_prompt(np.random.RandomState(GPT_SEED + 4), GPT_WRAP_BUCKETS[1],
                       model.config.vocab_size)
    last = np.array([spec.admit(s, base, 0.0) for s in range(spec.slots)], np.int32)
    snap = [t.clone() for t in spec.kv + spec._kv_draft]
    ones = np.ones(spec.slots, np.float32)
    draws, row = [], None
    for _ in range(GPT_SAMPLES // spec.slots):
        for t, c in zip(spec.kv + spec._kv_draft, snap):
            t.copy_(c)
        ts, _ = spec.spec_step(last, ones)
        draws.append(ts[:, 0].copy())
        if row is None:
            row = spec.last_logits[0, 0].to("cpu", copy=True)
    draws = np.concatenate(draws)
    top = row.topk(GPT_TOP_K)
    ids = top.indices.numpy()
    z = top.values.double().numpy()
    p = np.exp(z - z.max())
    p /= p.sum()
    counts = np.array([(draws == i).sum() for i in ids], np.float64)
    sampling = {"draws": int(draws.size), "top_k": GPT_TOP_K,
                "outside_top_k": int((~np.isin(draws, ids)).sum()),
                "chi2_p": float(stats.chisquare(counts, p * counts.sum()).pvalue),
                "control_uniform_p": float(stats.chisquare(counts).pvalue), "p_min": GPT_P_MIN,
                "extra_compiles": spec.extra_compiles()}
    log(f"gpt speculative sampling (verify position 0): {sampling}")
    if sampling["outside_top_k"] or not sampling["chi2_p"] > GPT_P_MIN > \
            sampling["control_uniform_p"] or sampling["extra_compiles"]:
        raise AssertionError(f"gpt 12k: the verify graph's draws failed their checks: "
                             f"{sampling}")
    del spec, plain, snap
    torch.cuda.empty_cache()
    return wrap, sampling


def _spec_self_draft(model, ref):
    """12k step 3: the target as its own draft accepts at least
    ``GPT_SELF_MIN`` of its proposals on the parity prompts; its rounds
    emit several tokens, so verify positions 1..k and the advance of
    ``pos`` by a round's count are held here against the plain engine's
    tokens and logits (``ref``: the prompts and the plain run of
    :func:`_spec_parity`), under the same near-tie rule and limit."""
    from paddle_tpu_torch.generation import GenerationEngine

    prompts, ref_toks, ref_rows = ref
    eng = GenerationEngine(model, slots=GPT_SELF_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_SELF_BUCKETS, seed=GPT_SEED, device=GPT_DEVICE,
                           draft_model=model, draft_k=GPT_DRAFT_K).warmup()
    slots = list(range(len(prompts)))
    toks, rows = _spec_decode_logged(eng, slots, prompts, GPT_NEW)
    r = dict(eng.spec_stats(), param_bytes=eng.param_nbytes())
    held = wrong = 0
    err = 0.0
    for s in slots:
        cover, w, e = _held_against(toks[s], rows[s], ref_toks[s], ref_rows[s])
        held, wrong, err = held + cover, wrong + w, max(err, e)
    r.update(positions_held=held, positions=GPT_NEW * len(prompts), tokens_differing=wrong,
             verify_vs_plain_rel=err, limit_rel=GPT_LOGITS_RTOL)
    log(f"gpt self-draft: {r}")
    if r["acceptance_rate"] is None or r["acceptance_rate"] < GPT_SELF_MIN \
            or eng.extra_compiles():
        raise AssertionError(f"gpt 12k: a self-draft accepted under {GPT_SELF_MIN}: {r}")
    if wrong or err > GPT_LOGITS_RTOL or held < GPT_NEW * len(prompts) // 2:
        raise AssertionError(f"gpt 12k: the self-draft's multi-token rounds part from the "
                             f"plain engine's tokens or logits: {r}")
    return r


def _spec_timing(model, plain, spec):
    """12k step 5: 16 busy slots; ``GPT_SPEC_ROUNDS`` greedy rounds on the
    host clock (tokens a round, ms an emitted token) against the plain
    decode step; the draft graph, the verify graph and a whole round timed
    captured and eager (host clock, outputs on the card synchronized, or
    the tokens on the host for a round), a profiled replay of each; the
    round's bound: the target's weights and window once (verify), the
    draft's weights and window once a chained step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    vocab = model.config.vocab_size
    rng = np.random.RandomState(GPT_SEED + 2)
    prompts = [_gpt_prompt(rng, int(rng.randint(GPT_PROMPT_LENS[0], GPT_PROMPT_LENS[1] + 1)),
                           vocab) for _ in range(spec.slots)]
    last = np.array([spec.admit(s, p) for s, p in enumerate(prompts)], np.int32)
    plain_last = np.array([plain.admit(s, p) for s, p in enumerate(prompts)], np.int32)
    temps = np.zeros(spec.slots, np.float32)
    before = spec.spec_stats()
    emitted, t0 = 0, time.perf_counter()
    for _ in range(GPT_SPEC_ROUNDS):
        ts, counts = spec.spec_step(last, temps)
        last = ts[np.arange(spec.slots), counts - 1]
        emitted += int(counts.sum())
    rounds_ms = (time.perf_counter() - t0) * 1e3 / GPT_SPEC_ROUNDS
    after = spec.spec_stats()
    toks_t = torch.from_numpy(last.astype(np.int64))
    temps_t = torch.from_numpy(temps)

    def draft():
        out = spec._dispatch("draft", (), spec._draft_body, [toks_t], read=lambda o: o,
                             sample=False)
        torch.cuda.synchronize()
        return out

    props = draft()[0].clone()

    def verify():
        spec._dispatch("verify", (), spec._verify_body, [toks_t, props, temps_t],
                       read=lambda o: o)
        torch.cuda.synchronize()

    def rnd():
        spec.spec_step(last, temps)

    def timed(fn):
        fn()
        t = time.perf_counter()
        for _ in range(GPT_TIMED):
            fn()
        return (time.perf_counter() - t) * 1e3 / GPT_TIMED

    snap = [t.clone() for t in spec.kv + spec._kv_draft]
    r = {}
    for name, fn in (("draft", draft), ("verify", verify), ("round", rnd)):
        row = {}
        for side in ("eager", "captured"):
            spec.jit = side == "captured"
            row[f"{side}_ms"] = timed(fn)
            for t, c in zip(spec.kv + spec._kv_draft, snap):
                t.copy_(c)  # keep every call's positions inside the window
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            wall = (time.perf_counter() - t) * 1e3
        _, busy, events = _log_profile(prof, wall, f"gpt speculative {name} replay (16 slots)")
        if _profiled_launches(prof):
            raise AssertionError(f"gpt 12k: the {name} graph ran a port kernel: "
                                 f"{_profiled_launches(prof)}")
        row.update(profiled_wall_ms=wall, busy_ms=busy, device_events=events,
                   by_kind_ms=_device_time_by_kind(prof)[0])
        for t, c in zip(spec.kv + spec._kv_draft, snap):
            t.copy_(c)
        r[name] = row
    del snap
    step_ms = timed(lambda: plain.step(plain_last, temps))
    draft_w = sum(p.numel() * p.element_size() for p in spec.draft_model.parameters())
    draft_ring = sum(t.numel() * t.element_size() for t in spec._kv_draft)
    target_bytes = (sum(p.numel() * p.element_size() for p in model.parameters())
                    + sum(t.numel() * t.element_size() for t in spec.kv))
    round_bytes = target_bytes + (GPT_DRAFT_K + 1) * (draft_w + draft_ring)
    accepted = after["accepted"] - before["accepted"]
    proposed = after["proposed"] - before["proposed"]
    per_round = 1 + GPT_DRAFT_K * accepted / proposed
    r.update({"rounds": GPT_SPEC_ROUNDS, "round_wall_ms": rounds_ms,
              "tokens_emitted": emitted, "tokens_per_round_per_slot": per_round,
              "acceptance_rate_16_slots": accepted / proposed,
              "ms_per_emitted_token": rounds_ms / per_round, "plain_step_ms": step_ms,
              "round_bytes": round_bytes, "round_bound_ms": round_bytes / HBM_BYTES_PER_S * 1e3,
              "verify_bound_ms": target_bytes / HBM_BYTES_PER_S * 1e3,
              "draft_bound_ms": (GPT_DRAFT_K + 1) * (draft_w + draft_ring)
              / HBM_BYTES_PER_S * 1e3})
    log(f"gpt speculative at 16 busy slots: round {rounds_ms:.3f} ms (host clock, tokens on "
        f"the host), {per_round:.3f} tokens a round a slot, {r['ms_per_emitted_token']:.3f} ms "
        f"an emitted token against the plain step's {step_ms:.3f} ms; draft "
        f"{r['draft']['captured_ms']:.3f} / verify {r['verify']['captured_ms']:.3f} ms "
        f"captured; round bound {r['round_bound_ms']:.3f} ms ({round_bytes} bytes)")
    spec.reset()
    plain.reset()
    return r


def _spec_http(model, spec):
    """12k step 6: 12i's 32 requests to a speculative ``GenerationServer``
    (16 slots); 8 answers against the engine's solo runs; ``/statz``
    ``speculative`` and ``compiles``."""
    from paddle_tpu_torch.serving import GenerationServer

    reqs = [{"prompt": p, "max_new_tokens": n, "temperature": 0.0}
            for p, n in _gpt_requests(model.config.vocab_size)]
    out = [None] * len(reqs)
    before = spec.spec_stats()
    srv = GenerationServer(spec, port=0, queue_capacity=2 * GPT_REQUESTS)
    try:
        srv.start()
        r = _serve_traffic(srv, reqs, model.config.eos_token_id, out)
        statz = _http(srv.url + "/statz")[1]
    finally:
        srv.stop(drain=True)
    solo = [spec.generate([q["prompt"]], max_new_tokens=q["max_new_tokens"],
                          temperature=0.0)[0] for q in reqs[:GPT_SOLO]]
    same = sum(a == b for a, b in zip(out[:GPT_SOLO], solo))
    sp = statz["speculative"]
    r.update({"solo_equal": f"{same}/{GPT_SOLO}", "speculative": sp,
              "acceptance_rate": (sp["accepted"] - before["accepted"])
              / max(sp["proposed"] - before["proposed"], 1),
              "extra_compiles": spec.extra_compiles()})
    log(f"gpt speculative HTTP: {r}")
    if same != GPT_SOLO or statz["compiles"]["unexpected"] or spec.extra_compiles() \
            or statz["compiles"]["programs"] != len(GPT_BUCKETS) + 2 or not sp["rounds"]:
        raise AssertionError(f"gpt 12k: speculative answers part from solo runs, or the "
                             f"requests captured graphs: {r}")
    return r


def _post_raw(url, data, timeout=300):
    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read(), resp.headers.get("Content-Type")


def _handoff_breakdown(pre, dec, reqs):
    """12k step 7b: where a lone ``/prefill`` leg's time goes, on the longest
    prompt of ``reqs`` (host clock, ``HANDOFF_TIMED`` runs, medians): the
    export (``prefill_export``: the bucket's forward and the first token's
    read, then the planes' copies to the host through the pinned buffer,
    split by timing the engine's host reads), packing the slab with its CRC
    (and the CRC alone), the whole ``/prefill`` round trip (the rest of it
    is HTTP: the request, the slab written, sent and read), unpacking with
    the CRC check, and the ``/generate_kv`` leg of the same slab."""
    import zlib

    from paddle_tpu_torch.generation import pack_kv_slab, unpack_kv_slab

    eng = pre.engine
    prompt, n = max(reqs, key=lambda r: len(r[0]))
    body = json.dumps({"prompt": prompt, "max_new_tokens": n, "temperature": 0.0}).encode()
    meta = {"params": {"prompt": prompt, "max_new_tokens": n, "temperature": 0.0,
                       "deadline_ms": None, "stream": False, "tenant": None},
            "cache": pre.cache_geometry()}
    reads, host = [], eng._host

    def timed_host(t):
        t0 = time.perf_counter()
        out = host(t)
        reads.append(time.perf_counter() - t0)
        return out

    rows = {k: [] for k in ("export", "forward", "d2h", "pack", "crc", "unpack", "prefill_leg",
                            "http", "generate_kv_leg")}
    eng._host = timed_host
    try:
        for _ in range(HANDOFF_TIMED):
            reads.clear()
            t0 = time.perf_counter()
            planes, length, tok = eng.prefill_export(prompt, 0.0)
            export = time.perf_counter() - t0
            d2h = sum(reads[1:])  # the first read is the token's: it waits for the forward
            t0 = time.perf_counter()
            blob = pack_kv_slab(planes, length, tok, meta=meta)
            pack = time.perf_counter() - t0
            t0 = time.perf_counter()
            zlib.crc32(blob)
            crc = time.perf_counter() - t0
            t0 = time.perf_counter()
            unpack_kv_slab(blob)
            unpack = time.perf_counter() - t0
            t0 = time.perf_counter()
            status, slab, _ = _post_raw(pre.url + "/prefill", body)
            leg = time.perf_counter() - t0
            t0 = time.perf_counter()
            status2, _, _ = _post_raw(dec.url + "/generate_kv", slab)
            leg2 = time.perf_counter() - t0
            if status != 200 or status2 != 200:
                raise AssertionError(f"gpt 12k: a lone handoff answered {status}/{status2}")
            for k, v in (("export", export), ("forward", export - d2h), ("d2h", d2h),
                         ("pack", pack), ("crc", crc), ("unpack", unpack), ("prefill_leg", leg),
                         ("http", leg - export - pack), ("generate_kv_leg", leg2)):
                rows[k].append(v * 1e3)
    finally:
        del eng._host
    r = {f"{k}_ms": float(np.median(v)) for k, v in rows.items()}
    r.update(prompt_tokens=len(prompt), slab_bytes=len(blob), runs=HANDOFF_TIMED)
    log(f"gpt handoff, one /prefill leg taken apart (host clock, median of {HANDOFF_TIMED}): "
        f"{r}")
    return r


def _spec_disagg_f32(model, plain, draft):
    """12k step 7: a ``prefill`` and a ``decode`` server (f32 ring) on the
    card; 8 of 12i's requests through ``/prefill`` then ``/generate_kv``
    (client clock for each leg), answers held against the unified engine's
    greedy run under the near-tie rule; the prefill tier holding no decode
    cache, the slab's bytes, no capture after warmup; then a speculative
    decode tier admitting two of the slabs with their prompts."""
    from paddle_tpu_torch.generation import GenerationEngine, unpack_kv_slab
    from paddle_tpu_torch.serving import GenerationServer

    kw = dict(cache_len=GPT_CACHE, prefill_buckets=GPT_BUCKETS, seed=GPT_SEED,
              device=GPT_DEVICE)
    reqs = _gpt_requests(model.config.vocab_size)[:GPT_DISAGG_REQUESTS]
    slots = list(range(len(reqs)))
    ref_toks, ref_rows = _decode_logged(plain, slots, [p for p, _ in reqs],
                                        max(n for _, n in reqs))
    plain.reset()
    pre = GenerationServer(GenerationEngine(model, slots=1, **kw), kind="prefill", port=0)
    dec = GenerationServer(GenerationEngine(model, slots=GPT_DISAGG_SLOTS, **kw), kind="decode",
                           port=0, queue_capacity=4 * GPT_DISAGG_REQUESTS)
    slabs, answers, legs = [None] * len(reqs), [None] * len(reqs), []
    try:
        t0 = time.perf_counter()
        pre.start()
        dec.start()
        warm_s = time.perf_counter() - t0

        def client(i):
            prompt, n = reqs[i]
            body = json.dumps({"prompt": prompt, "max_new_tokens": n,
                               "temperature": 0.0}).encode()
            t = time.perf_counter()
            status, slab, ctype = _post_raw(pre.url + "/prefill", body)
            t1 = time.perf_counter()
            status2, ans, _ = _post_raw(dec.url + "/generate_kv", slab)
            legs.append(((t1 - t) * 1e3, (time.perf_counter() - t1) * 1e3))
            if status != 200 or status2 != 200 or not ctype.startswith(
                    "application/x-ptpu-kv-slab"):
                raise AssertionError(f"gpt 12k: handoff {i} answered {status}/{status2}")
            slabs[i], answers[i] = slab, json.loads(ans)["tokens"]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        pz, dz = _http(pre.url + "/statz")[1], _http(dec.url + "/statz")[1]
        pre_cache = pre.engine.cache_nbytes()
        breakdown = _handoff_breakdown(pre, dec, reqs)
    finally:
        pre.stop(drain=False)
        dec.stop(drain=True)
    if any(a is None for a in answers):
        raise AssertionError("gpt 12k: a disaggregated request got no answer")
    held = wrong = 0
    for s, a in enumerate(answers):
        cover, w, _ = _held_against(a, None, ref_toks[s], ref_rows[s])
        held, wrong = held + cover, wrong + w
    planes, n, _, meta = unpack_kv_slab(slabs[0])
    plane_bytes = sum(p.nbytes for p in planes)
    r = {"requests": len(reqs), "warmup_s": warm_s, "wall_s": wall,
         "tokens": sum(len(a) for a in answers),
         "prefill_leg_ms": {"p50": float(np.percentile([x for x, _ in legs], 50)),
                            "max": float(max(x for x, _ in legs))},
         "decode_leg_ms": {"p50": float(np.percentile([y for _, y in legs], 50)),
                           "max": float(max(y for _, y in legs))},
         "slab_bytes": len(slabs[0]), "slab_plane_bytes": plane_bytes,
         "positions_held": held, "tokens_differing": wrong,
         "prefill_tier_cache_bytes": pre_cache, "prefill_compiles": pz["compiles"],
         "decode_compiles": dz["compiles"], "decode_latency": dz["latency"],
         "prefill_concurrency": pz["prefill"]["concurrency"], "breakdown": breakdown}
    log(f"gpt disaggregated f32: {r}")
    want_planes = 2 * model.config.num_hidden_layers * GPT_CACHE * model.config.hidden_size * 4
    if wrong or pre_cache or plane_bytes != want_planes or pz["compiles"]["unexpected"] \
            or dz["compiles"]["unexpected"] or pz["compiles"]["programs"] != len(GPT_BUCKETS) \
            or dz["compiles"]["programs"] != 1 or held < r["tokens"] // 2:
        raise AssertionError(f"gpt 12k: the disaggregated answers part from the unified "
                             f"engine's, the prefill tier holds a cache, or a tier captured "
                             f"after warmup: {r}")
    # a speculative decode tier: the slab and its prompt (the draft's prefill)
    sdec = GenerationServer(GenerationEngine(model, slots=GPT_SPEC_DECODE_SLOTS, draft_model=draft,
                                             draft_k=GPT_DRAFT_K, **kw), kind="decode", port=0)
    try:
        sdec.start()
        got = [json.loads(_post_raw(sdec.url + "/generate_kv", slabs[i])[1])["tokens"]
               for i in range(GPT_SPEC_DECODE_SLABS)]
        sz = _http(sdec.url + "/statz")[1]
    finally:
        sdec.stop(drain=True)
    held = wrong = 0
    for s, a in enumerate(got):
        cover, w, _ = _held_against(a, None, ref_toks[s], ref_rows[s])
        held, wrong = held + cover, wrong + w
    r["speculative_decode_tier"] = {"slabs": len(got), "positions_held": held,
                                    "tokens_differing": wrong, "compiles": sz["compiles"],
                                    "speculative": sz["speculative"]}
    log(f"gpt speculative decode tier: {r['speculative_decode_tier']}")
    if wrong or sz["compiles"]["unexpected"] or not held \
            or sz["compiles"]["programs"] != len(GPT_BUCKETS) + 2:
        raise AssertionError(f"gpt 12k: the speculative decode tier parts from the unified "
                             f"engine or captured after warmup: {r['speculative_decode_tier']}")
    return r


def _spec_disagg_paged(model):
    """12k step 8: a paged int8 ``prefill``/``decode`` pair (page 16), each
    of 4 tenants' first two requests of 12j's traffic: the second asks the
    decode tier's ``/prefix_known`` and ships its 256-token system prompt's
    16 pages header-only; ``/statz`` ``paging`` counts 4 hits; answers held
    against an int8 ring engine's greedy run under the near-tie rule."""
    from paddle_tpu_torch.generation import GenerationEngine, chain_hashes, unpack_kv_pages
    from paddle_tpu_torch.serving import GenerationServer

    kw = dict(cache_len=GPT_CACHE, prefill_buckets=GPT_BUCKETS, seed=GPT_SEED,
              device=GPT_DEVICE, kv_cache_dtype="int8")
    traffic = _gpt_traffic(model.config.vocab_size)
    reqs = traffic[:GPT_TENANTS] + traffic[GPT_TENANTS:2 * GPT_TENANTS]
    ring = GenerationEngine(model, slots=len(reqs), **kw).warmup()
    ref_toks, ref_rows = _decode_logged(ring, list(range(len(reqs))),
                                        [q["prompt"] for q in reqs],
                                        max(q["max_new_tokens"] for q in reqs))
    del ring
    paged = dict(kw, kv_cache_layout="paged", kv_page_size=GPT_PAGE)
    pre = GenerationServer(GenerationEngine(model, slots=1, **paged), kind="prefill", port=0)
    dec = GenerationServer(GenerationEngine(model, slots=GPT_TENANTS, **paged), kind="decode",
                           port=0)
    answers, absent, wire = [], [], []
    try:
        pre.start()
        dec.start()
        pinned = [len(dec.engine._pinned)]  # host buffers pinned by warmup
        for q in reqs:
            known = _http(dec.url + "/prefix_known",
                          {"hashes": chain_hashes(q["prompt"], GPT_PAGE)})[1]["known"]
            body = json.dumps(dict(q, page_format=True, known_hashes=known)).encode()
            _, blob, _ = _post_raw(pre.url + "/prefill", body)
            slab = unpack_kv_pages(blob)
            absent.append(sum(p["planes"] is None for p in slab.pages))
            wire.append(len(blob))
            answers.append(json.loads(_post_raw(dec.url + "/generate_kv", blob)[1])["tokens"])
        dz = _http(dec.url + "/statz")[1]
        pinned.append(len(dec.engine._pinned))
    finally:
        pre.stop(drain=False)
        dec.stop(drain=True)
    held = wrong = 0
    for s, a in enumerate(answers):
        cover, w, _ = _held_against(a, None, ref_toks[s], ref_rows[s])
        held, wrong = held + cover, wrong + w
    pg = dz["paging"]
    r = {"requests": len(reqs), "header_only_pages": absent, "wire_bytes": wire,
         "positions_held": held, "tokens_differing": wrong,
         "prefix_hits": pg["prefix_index"]["hits"], "per_tenant": pg["per_tenant"],
         "compiles": dz["compiles"], "pinned_buffers_warm_then_served": pinned}
    log(f"gpt disaggregated paged int8: {r}")
    system_pages = GPT_SYSTEM_LEN // GPT_PAGE
    if wrong or absent != [0] * GPT_TENANTS + [system_pages] * GPT_TENANTS \
            or r["prefix_hits"] != GPT_TENANTS or dz["compiles"]["unexpected"] \
            or pinned[0] != pinned[1] \
            or held < sum(len(a) for a in answers) // 2:
        raise AssertionError(f"gpt 12k: the paged handoff missed its header-only pages, its "
                             f"hits or the int8 ring's tokens, or pinned host memory after "
                             f"warmup: {r}")
    return r


def serve_gpt_speculative():
    """Phase 12k. GPT-2 small (the weights of 12i, from its seed) under
    speculative decoding (a one-layer truncated draft, ``draft_k`` 4) and
    through the disaggregated handoff, each against the plain engine (16
    slots x 1024). Returns (the port's kernel launches over the phase,
    which must be none; readings)."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.models import truncated_draft
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _gpt_model()
    draft = truncated_draft(model, GPT_DRAFT_LAYERS)
    reset_launch_counts()
    kw = dict(slots=GPT_SLOTS, cache_len=GPT_CACHE, prefill_buckets=GPT_BUCKETS, seed=GPT_SEED,
              device=GPT_DEVICE)
    plain = GenerationEngine(model, **kw).warmup()
    spec = GenerationEngine(model, draft_model=draft, draft_k=GPT_DRAFT_K, **kw)
    t0 = time.perf_counter()
    spec.warmup()
    r = {"draft_k": GPT_DRAFT_K, "draft_layers": GPT_DRAFT_LAYERS,
         "store_len": spec.store_len, "warmup_s": time.perf_counter() - t0,
         "graphs_after_warmup": spec.graphs(), "kv_cache_bytes": spec.cache_nbytes(),
         "param_bytes": spec.param_nbytes()}
    log(f"gpt speculative engine warm: {r}")
    if spec.graphs() != spec.expected_compiles() != len(GPT_BUCKETS) + 2 \
            or spec.compile_count() != len(GPT_BUCKETS) + 2:
        raise AssertionError(f"gpt 12k: warmup captured {spec.graphs()} graphs for "
                             f"{len(GPT_BUCKETS)} buckets + draft + verify")
    r["parity"], ref = _spec_parity(model, draft, plain, spec)
    r["acceptance_parity"] = spec.spec_stats()
    r["ring_wrap"], r["sampling"] = _spec_wrap_and_sampling(model, draft)
    r["self_draft"] = _spec_self_draft(model, ref)
    del ref
    torch.cuda.empty_cache()
    spec.reset()
    plain.reset()
    r["timing"] = _spec_timing(model, plain, spec)
    r["http"] = _spec_http(model, spec)
    r["disagg_f32"] = _spec_disagg_f32(model, plain, draft)
    del plain
    torch.cuda.empty_cache()
    r["disagg_paged_int8"] = _spec_disagg_paged(model)
    r["extra_compiles"], r["graphs"] = spec.extra_compiles(), spec.graphs()
    if r["extra_compiles"] or r["graphs"] != len(GPT_BUCKETS) + 2:
        raise AssertionError(f"gpt 12k: the speculative engine captured after warmup: {r}")
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"gpt 12k: the generation path launched the port's kernels: "
                             f"{counts}")
    r["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"gpt 12k: phase done in {r['phase_s']:.1f} s, peak {r['peak_memory_gib']:.2f} GiB")
    del spec, draft, model
    torch.cuda.empty_cache()
    return counts, r


# -- the int8 serving path and the pool backward --------------------------------

# the served program: the part of BERT-base the int8 rewrite computes in int8
# (a ``mul`` by a weight), at bert_base_config()'s widths and depth
Q_HIDDEN, Q_FFN, Q_LAYERS, Q_CLASSES = 768, 3072, 12, 2
Q_MULS = 2 * Q_LAYERS + 1
# residual add + layer_norm pairs the executor's IR gate fuses onto
# fused_layernorm_residual: all but the first layer's, whose residual is the
# feed, declared [None, 768] against the fc output's [-1, 768]; the fusion
# admits equal declared shapes only, in both packages (their optimizers
# rewrite this program to the same op list, tests/test_torch_ir_opt.py)
Q_FUSED_NORMS = Q_LAYERS - 1
Q_BUCKETS = (8, 64, 512)
Q_CALIB_BATCHES, Q_CALIB_ROWS = 4, 64
# the stem's pool at the training batch
POOL_SHAPE, POOL_GEOM = (RN_B, 64, 112, 112), ((3, 3), (2, 2), (1, 1))


_INT8_SRC = "paddle_tpu_torch/csrc/int8_matmul.cu"
_INT8_REPLACES = "paddle_tpu/ops/pallas/int8_matmul.py:154"


def _int8_plan(m, k, n):
    """The split-K slices of ``[m, k] @ [k, n]``: the wrapper's planner,
    required equal to the plan the C side makes for itself."""
    import ctypes

    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import int8_matmul as im

    slices, per = im._split_k(m, k, n)
    fn = _build.library("int8_matmul").ptt_int8_matmul_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    c_slices, c_per = ctypes.c_int(0), ctypes.c_int(0)
    fn(m, k, n, ctypes.byref(c_slices), ctypes.byref(c_per))
    c_plan = (c_slices.value, c_per.value)
    if c_plan != (slices, per):
        raise AssertionError(f"int8 plan at {(m, k, n)}: the C side's {c_plan} is not the "
                             f"planner's {(slices, per)}")
    return slices


def check_int8_matmul(m, k, n, label, timed=True):
    """The int8 kernel at [m, k] @ [k, n] over the full -128..127 range, bit
    for bit against the float64 product of the same values cast back (the
    card has no integer matmul in PyTorch; exact below 2**53)."""
    import torch

    from paddle_tpu_torch.ops.cuda import int8_matmul as im

    g = torch.Generator(device="cuda").manual_seed(21)
    # enough operand sets to exceed the 50 MB L2: on the serving path every
    # weight is read once a forward and comes from device memory
    count = max(2, min(64, -(-60 * 2**20 // (m * k + k * n)))) if timed else 1
    sets = [(torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8),
             torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8))
            for _ in range(count)]
    x, w = sets[0]
    slices = _int8_plan(m, k, n)
    splits0 = im.SPLITS
    out = im.int8_matmul(x, w)
    if im.SPLITS - splits0 != (slices > 1):
        raise AssertionError(f"int8_matmul {label}: {im.SPLITS - splits0} split-K calls counted; "
                             f"the plan has {slices} slices")
    ref = im._plain_int8_matmul(x, w)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    if out.dtype != torch.int32 or err != 0:
        raise AssertionError(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: differs from the "
                             f"float64 product by {err}")
    if min(int(x.min()), int(w.min())) != -128 or max(int(x.max()), int(w.max())) != 127:
        raise AssertionError("the int8 operands do not span -128..127")
    t_b, by = bound(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS_PER_S)
    entry = {"name": "int8_matmul", "route": "cuda", "source": _INT8_SRC,
             "replaces": _INT8_REPLACES, "shape": [m, k, n], "slices": slices,
             "label": label, "dtype": "int8", "max_abs_err": float(err),
             "tolerance": "bit-equal to the float64 product", "bound_ms": t_b, "bound_by": by}
    if not timed:
        log(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: bit-equal")
        return entry
    # device time behind a sleep kernel: at these sizes a call's Python is
    # as long as the kernel, and host-paced events would time the Python
    iters = 100
    ms, host_ms = device_ms_sets(im.int8_matmul, sets, iters)
    plain_ms, _ = device_ms_sets(im._plain_int8_matmul, sets, 20)
    lib_ms, lib_note = None, _int_mm_refusal(x, w, ref)
    if lib_note is None:
        lib_ms, lib_note = device_ms_sets(torch._int_mm, sets, iters)[0], "torch._int_mm"
    log(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: bit-equal, {slices} slice(s); kernel "
        f"{ms:.4f} ms device ({2 * m * k * n / ms / 1e9:.1f} TOP/s; host {host_ms:.4f} ms a "
        f"call), plain (float64) {plain_ms:.4f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} ({lib_note}), bound {t_b:.4f} ms "
        f"({by})")
    entry.update(ms=ms, kernel_ms=ms, host_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                 library=lib_note, timing="device time behind a sleep kernel")
    return entry


def _int_mm_refusal(x, w, ref):
    """None when ``torch._int_mm`` takes ``x @ w`` (and gives ``ref``), else
    why it does not: the library call has shape limits of its own (M > 16,
    K and N multiples of 8)."""
    import torch

    try:
        out = torch._int_mm(x, w)
    except RuntimeError as e:
        return f"torch._int_mm refuses the shape: {str(e).splitlines()[0][:90]}"
    if not torch.equal(out, ref):
        raise AssertionError(f"torch._int_mm at {tuple(x.shape)} @ {tuple(w.shape)} differs "
                             "from the float64 product")
    return None


def _q_forward_products(bucket):
    """(M, K, N) of the int8 program's 25 products in one forward of
    ``bucket`` rows, in the order the program runs them."""
    return [(bucket, Q_HIDDEN, Q_FFN), (bucket, Q_FFN, Q_HIDDEN)] * Q_LAYERS + [
        (bucket, Q_HIDDEN, Q_CLASSES)]


def check_int8_forward(bucket):
    """Row 15b: the 25 products of one served int8 forward at ``bucket``
    rows, each bit-equal to the float64 product with its split-K calls
    counted against the plan, then the device time of the 25 kernel calls in
    a row (each product its own weight, 56.6 MB in all: past the L2, as in
    the forward) against the same products through ``torch._int_mm`` where
    it takes them."""
    import torch

    from paddle_tpu_torch.ops.cuda import int8_matmul as im

    g = torch.Generator(device="cuda").manual_seed(24)
    shapes = _q_forward_products(bucket)
    sets = [(torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8),
             torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8))
            for m, k, n in shapes]
    splits0 = im.SPLITS
    taken = []
    for (m, k, n), (x, w) in zip(shapes, sets):
        ref = im._plain_int8_matmul(x, w)
        if not torch.equal(im.int8_matmul(x, w), ref):
            raise AssertionError(f"int8_matmul [{m}, {k}] @ [{k}, {n}] at bucket {bucket} differs "
                                 "from the float64 product")
        if _int_mm_refusal(x, w, ref) is None:
            taken.append((x, w))
    splits = im.SPLITS - splits0
    want = sum(_int8_plan(*s) > 1 for s in shapes)
    if splits != want:
        raise AssertionError(f"{splits} of the {len(shapes)} int8 products took split-K; the plan "
                             f"splits {want}")
    ms, host_ms = device_ms(lambda: [im.int8_matmul(x, w) for x, w in sets], 10)
    plain = device_ms(lambda: [im._plain_int8_matmul(x, w) for x, w in sets], 3)[0]
    lib = device_ms(lambda: [torch._int_mm(x, w) for x, w in taken], 10)[0] if taken else None
    bounds = [bound(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS_PER_S) for m, k, n in shapes]
    b = sum(t for t, _ in bounds)
    by = max(("bytes", "operations"), key=lambda u: sum(t for t, w in bounds if w == u))
    lib_note = (f"torch._int_mm over the {len(taken)} of {len(shapes)} products it takes"
                + ("" if len(taken) == len(shapes) else " (it refuses the rest)"))
    log(f"int8 forward bucket {bucket}, {len(shapes)} products: bit-equal, {splits} took split-K; "
        f"device time in a row {ms:.4f} ms (host {host_ms:.4f} ms), plain {plain:.4f} ms, "
        f"library {'none' if lib is None else f'{lib:.4f} ms'} ({lib_note}), bound {b:.4f} ms")
    return {"name": "int8_matmul", "route": "cuda", "source": _INT8_SRC,
            "replaces": _INT8_REPLACES, "label": f"int8 program bucket {bucket}: the "
            f"{len(shapes)} products of a forward in a row, device time", "shape": shapes,
            "dtype": "int8", "max_abs_err": 0.0, "tolerance": "bit-equal to the float64 product",
            "splits": splits, "ms": ms, "kernel_ms": ms, "host_ms": host_ms, "plain_ms": plain,
            "library_ms": lib, "library": lib_note, "bound_ms": b, "bound_by": by}


POOL_KINDS = ("relu", "distinct", "stem layout")


def _pool_input(kind, g):
    """x for :func:`check_pool_backward`: a relu output (zeros tie all over),
    a permutation of 0 .. H*W-1 in every plane, or the stem's own layout: the
    relu'd channels-last buffer of the fused conv, viewed as NCHW."""
    import torch

    n, c, h, w = POOL_SHAPE
    if kind == "relu":
        return torch.relu(torch.randn(POOL_SHAPE, generator=g, device="cuda"))
    if kind == "distinct":
        x = torch.rand(n * c, h * w, generator=g, device="cuda").argsort(-1).float()
        return x.reshape(POOL_SHAPE)
    return torch.relu(torch.randn(n, h, w, c, generator=g, device="cuda")).permute(0, 3, 1, 2)


def check_pool_backward(kind):
    """The max-pool backward kernel at the stem's [128, 64, 112, 112], 3x3/2/1
    against its plain version, bit for bit (:func:`_pool_input` for the
    kinds). torch's own backward is the library yardstick; it keeps the first
    maximum too, and adds an element's taps in another order, so it is held
    to 4 ulps of the largest gradient entry. In the stem layout, x, y and dy
    are channels-last as the step gives them, dx must come back
    channels-last, and the whole autograd backward of the pool is timed with
    ``FLAGS_use_pallas_pool_bwd`` on and off, alone and followed by the fused
    conv's move of its dy to NHWC (``.contiguous()``, a copy unless dx is
    channels-last already)."""
    import torch

    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    g = torch.Generator(device="cuda").manual_seed(22)
    ks, st, pad = POOL_GEOM
    stem = kind == "stem layout"
    x = _pool_input(kind, g)
    xr = x.detach().requires_grad_()
    y = PF.max_pool2d(xr, ks, st, pad)
    dy = torch.randn(y.shape, generator=g, device="cuda")
    if stem:  # the gradient from layer1's convs comes back channels-last
        dy = dy.contiguous(memory_format=torch.channels_last)
    yd = y.detach()
    layouts = [pb.memory_layout(t) for t in (x, yd, dy)]
    if layouts != ["nhwc" if stem else "nchw"] * 3:
        raise AssertionError(f"max_pool2d_backward ({kind}): x, y, dy lie as {layouts}")
    dx = pb.max_pool2d_backward(x, yd, dy, ks, st, pad)
    ref = pb._plain_max_pool2d_backward(x, yd, dy, ks, st, pad)
    (lib,) = torch.autograd.grad(y, xr, dy, retain_graph=True)
    torch.cuda.synchronize()
    err = float((dx - ref).abs().max())
    lib_err = float((dx - lib).abs().max())
    ulp = float(torch.finfo(torch.float32).eps * ref.abs().max())
    zeros = float((x == 0).float().mean())
    if not torch.equal(dx, ref):
        raise AssertionError(f"max_pool2d_backward ({kind}): differs from the plain version by "
                             f"{err}")
    if pb.memory_layout(dx) != layouts[0]:
        raise AssertionError(f"max_pool2d_backward ({kind}): dx lies as "
                             f"{pb.memory_layout(dx)}, x as {layouts[0]}")
    if lib_err > 4 * ulp:
        raise AssertionError(f"max_pool2d_backward ({kind}): {lib_err} from torch's backward, "
                             f"beyond 4 ulps ({4 * ulp}): another tie rule?")
    t_b, by = bound(4 * (2 * x.numel() + 2 * yd.numel()), 9 * x.numel())
    args = [(x, yd, dy, ks, st, pad)]
    ms, host_ms = device_ms_sets(pb.max_pool2d_backward, args, 20)
    plain_ms = device_ms_sets(pb._plain_max_pool2d_backward, args, 5)[0]
    lib_ms = device_ms(lambda: torch.autograd.grad(y, xr, dy, retain_graph=True), 20)[0]
    entry = {"name": "max_pool2d_backward", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/pool_backward.cu",
             "replaces": "paddle_tpu/ops/pallas/pool_backward.py:244", "shape": list(POOL_SHAPE),
             "geometry": "3x3 stride 2 padding 1", "input": kind, "layout": layouts[0],
             "dtype": "float32", "max_abs_err": err, "tolerance": "bit-equal to the plain version",
             "library_max_abs_err": lib_err, "ms": ms, "kernel_ms": ms, "host_ms": host_ms,
             "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms,
             "library": "torch's max_pool2d backward (autograd.grad) at the same layout",
             "timing": "device time behind a sleep kernel"}
    note = ""
    if stem:
        whole = {}
        try:
            for on in (True, False, False, True):  # in turns
                set_flags({"use_pallas_pool_bwd": on})
                xs = x.detach().requires_grad_()
                ys = PF.max_pool2d(xs, ks, st, pad)
                launches0 = pb.LAUNCHES
                (gx,) = torch.autograd.grad(ys, xs, dy, retain_graph=True)
                if (pb.LAUNCHES - launches0 != int(on) or not torch.equal(gx, dx if on else lib)
                        or (on and pb.memory_layout(gx) != "nhwc")):
                    raise AssertionError(f"the stem pool's autograd backward, flag {on}: "
                                         f"{pb.LAUNCHES - launches0} launches, layout "
                                         f"{pb.memory_layout(gx)}, or another gradient")
                alone = device_ms(lambda: torch.autograd.grad(ys, xs, dy, retain_graph=True),
                                  20)[0]
                conv = device_ms(lambda: torch.autograd.grad(ys, xs, dy, retain_graph=True)[0]
                                 .permute(0, 2, 3, 1).contiguous(), 20)[0]
                whole.setdefault(on, []).append((alone, conv))
        finally:
            set_flags({"use_pallas_pool_bwd": False})
        for on in (True, False):
            alone, conv = (float(np.mean([r[i] for r in whole[on]])) for i in (0, 1))
            entry[f"autograd_flag_{'on' if on else 'off'}_ms"] = alone
            entry[f"autograd_and_conv_dy_flag_{'on' if on else 'off'}_ms"] = conv
        note = (f"; autograd backward flag on {entry['autograd_flag_on_ms']:.4f} ms, off "
                f"{entry['autograd_flag_off_ms']:.4f} ms; with the conv's dy to NHWC on "
                f"{entry['autograd_and_conv_dy_flag_on_ms']:.4f}, off "
                f"{entry['autograd_and_conv_dy_flag_off_ms']:.4f} ms")
    log(f"max_pool2d_backward {list(POOL_SHAPE)} 3x3/2/1, {kind} input ({layouts[0]})"
        f"{f' ({zeros:.0%} of x is 0)' if kind != 'distinct' else ''}: "
        f"bit-equal to the plain version; {lib_err:.3g} from torch's backward (4 ulps = "
        f"{4 * ulp:.3g}: the same first-maximum rule, another order of adding); kernel "
        f"{ms:.4f} ms device (host {host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, library "
        f"(torch's backward) {lib_ms:.4f} ms, bound {t_b:.4f} ms ({by}){note}")
    return entry


def check_new_kernels():
    """Rows 15 and 16. The int8 kernel's counted entry stands at the largest
    serving bucket's first product ([512, 768] @ [768, 3072]); every other
    shape the served program gives it (three products at three buckets),
    the 4096-row shapes and two ragged ones ride along under
    ``also_checked``."""
    import torch

    mm = check_int8_matmul(Q_BUCKETS[-1], Q_HIDDEN, Q_FFN, "bucket 512, FFN in")
    mm["also_checked"] = [
        check_int8_matmul(Q_BUCKETS[-1], Q_FFN, Q_HIDDEN, "bucket 512, FFN out"),
        check_int8_matmul(LN_ROWS, Q_HIDDEN, Q_FFN, "4096 rows, FFN in"),
        check_int8_matmul(LN_ROWS, Q_FFN, Q_HIDDEN, "4096 rows, FFN out"),
        check_int8_matmul(Q_BUCKETS[1], Q_HIDDEN, Q_FFN, "bucket 64, FFN in"),
        check_int8_matmul(Q_BUCKETS[1], Q_FFN, Q_HIDDEN, "bucket 64, FFN out"),
        check_int8_matmul(Q_BUCKETS[0], Q_HIDDEN, Q_FFN, "bucket 8, FFN in"),
        check_int8_matmul(Q_BUCKETS[0], Q_FFN, Q_HIDDEN, "bucket 8, FFN out"),
        check_int8_matmul(Q_BUCKETS[0], Q_HIDDEN, Q_CLASSES, "bucket 8, classifier"),
        check_int8_matmul(Q_BUCKETS[1], Q_HIDDEN, Q_CLASSES, "bucket 64, classifier",
                          timed=False),
        check_int8_matmul(Q_BUCKETS[2], Q_HIDDEN, Q_CLASSES, "bucket 512, classifier",
                          timed=False),
        check_int8_matmul(37, 70, 130, "ragged", timed=False),
        check_int8_matmul(300, 129, 257, "ragged", timed=False),
        check_int8_matmul(100, 1000, 70, "ragged, split-K", timed=False),
        check_int8_matmul(Q_BUCKETS[0], Q_FFN, Q_CLASSES, "split-K, N = 2", timed=False)]
    mm["also_checked"] += [check_int8_forward(b) for b in Q_BUCKETS]
    pool = check_pool_backward(POOL_KINDS[0])
    pool["also_checked"] = ([check_pool_backward(kind) for kind in POOL_KINDS[1:]]
                            + [check_pool_backward_lenet(shape) for shape in LENET_POOLS])
    torch.cuda.empty_cache()
    return [mm, pool]


def _build_ffn_program(static, ops):
    x = static.data("x", [None, Q_HIDDEN], "float32")
    h = x
    for _ in range(Q_LAYERS):
        a = static.nn.fc(h, Q_FFN, activation="gelu")
        a = static.nn.fc(a, Q_HIDDEN)
        h = static.nn.layer_norm(ops.add(h, a))
    return x, static.nn.fc(h, Q_CLASSES)


def _forward_ms(exe, program, scope, fetch_names, label):
    """Time of one forward per bucket, the rows already on the card: CUDA
    events around 20 forwards enqueued back to back. Each forward is a
    replay of the executor's graph for the bucket (the first call of a
    bucket captures it) and a copy of the fetches on the card, so the card
    no longer waits on the executor's Python between ops as it did when
    the executor interpreted each forward; where the host enqueues a replay
    faster than the card runs it, this is the card's time. Returns
    ``{bucket: ms}``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for bucket in Q_BUCKETS:
        x = torch.randn(bucket, Q_HIDDEN, generator=g, device="cuda")
        out[bucket] = time_ms(lambda x: exe.run(program, feed={"x": x}, fetch_list=fetch_names,
                                                scope=scope, return_numpy=False), [(x,)], 20)
    log(f"{label} forward, replayed, ms a bucket: "
        + ", ".join(f"{b}: {ms:.3f}" for b, ms in out.items()))
    return out


# int8 serving limits, against the port's plain path on the CPU from the same
# directory. The accumulators are integers, so a row differs only by the
# float ops between the products (f32 rounding: Q_ROW_RTOL of the largest
# |logit|) unless that rounding sends one activation to the other side of a
# quantization boundary on the card; from there on the row's later
# activations round differently too, and the row moves by a share of the int8
# noise itself. Such rows are few, so at least Q_ROW_SHARE of all rows must
# be within Q_ROW_RTOL, and every row within Q_FLIP_RTOL. The limits sit
# between the sound reading and a control that they must catch: the same
# requests with the first product's activation scale off by 1%, which moves
# every row.
Q_ROW_RTOL, Q_ROW_SHARE, Q_FLIP_RTOL = 1e-5, 0.9, 0.05
# against the f32 program: the JAX package's documented int8 envelope
Q_F32_ENVELOPE = (0.05, 0.05)


def _make_int8_model(dirname, reqs):
    """Build the f32 program from a seed on the card, answer ``reqs`` with it,
    time it, calibrate, rewrite to int8 and save into ``dirname``. Returns
    (the f32 answers, the f32 forward's ms a bucket)."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import ops, slim, static

    rng = np.random.RandomState(30)
    calib = [{"x": rng.randn(Q_CALIB_ROWS, Q_HIDDEN).astype(np.float32)}
             for _ in range(Q_CALIB_BATCHES)]
    static.enable_static()
    static.reset_default_programs()
    try:
        ptt.seed(0)
        scope = static.Scope()
        _, y = _build_ffn_program(static, ops)
        exe = static.Executor()
        exe.run_startup(scope=scope)
        prog = static.default_main_program()
        muls = [op for op in prog.global_block().ops if op.type == "mul"]
        if len(muls) != Q_MULS:
            raise AssertionError(f"the program has {len(muls)} muls, not {Q_MULS}")
        weights = sum(scope.get(op.inputs["X"][1]).numel() for op in muls)
        refs = [exe.run(prog, feed={"x": r["x"].astype(np.float32)}, fetch_list=[y],
                        scope=scope)[0] for r in reqs]
        f32_ms = _forward_ms(exe, prog, scope, [y.name], "f32 program")
        t0 = time.perf_counter()
        ptq = slim.PostTrainingQuantization(exe, prog, calib, scope=scope)
        ptq.quantize()
        ptq.save_int8_model(dirname, ["x"], [y])
        log(f"int8 program: {Q_MULS} muls, {weights / 1e6:.1f} M weights; calibrated on "
            f"{Q_CALIB_BATCHES} x {Q_CALIB_ROWS} rows, rewritten and saved in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        static.disable_static()
        static.reset_default_programs()
    del scope, exe, ptq
    torch.cuda.empty_cache()
    return refs, f32_ms


def _row_errors(got, want):
    """Each row's largest error over the answer's largest |entry|."""
    return np.abs(got - want).max(axis=1) / np.abs(want).max()


def _row_stats(errs):
    q = np.quantile(errs, [0.5, 0.9, 0.99])
    return (f"row errors median {q[0]:.3g}, 90% {q[1]:.3g}, 99% {q[2]:.3g}, max {errs.max():.3g}, "
            f"{(errs <= Q_ROW_RTOL).mean():.1%} of rows within {Q_ROW_RTOL}")


def serve_int8():
    """Make the int8 model directory, then serve it as a user would: from the
    directory alone. Returns (kernel launches per name on the serving run,
    readings)."""
    import torch

    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.static.program import Program

    rng = np.random.RandomState(31)
    # three decimals: short JSON, and exactly the float32 values the server parses
    reqs = [{"x": np.round(rng.randn(rows, Q_HIDDEN), 3)} for rows in (8, 5, 64, 40, 512, 300)]
    with tempfile.TemporaryDirectory(prefix="ptt_int8_") as dirname:
        refs, f32_ms = _make_int8_model(dirname, reqs)
        pred = create_predictor(Config(dirname))
        cpu_pred = create_predictor(Config(dirname), device="cpu")
        meta = pred.quant_metadata()
    types = [op.type for op in pred._program.global_block().ops]
    if types.count("mul_int8") != Q_MULS or types.count("quantize_static") != Q_MULS \
            or "mul" in types or "quant_dequant_static" in types:
        raise AssertionError(f"the loaded program's ops are not the int8 rewrite's: {types}")
    if len(meta["int8_weights"]) != Q_MULS:
        raise AssertionError(f"{len(meta['int8_weights'])} int8 weights saved, not {Q_MULS}")
    for n in pred._scope.var_names():
        if pred._scope.get(n).device.type != "cuda":
            raise AssertionError(f"{n} lies on {pred._scope.get(n).device}, not on the card")
    for n in meta["int8_weights"]:
        if pred._scope.get(n).dtype != torch.int8 or pred._scope.has(n[:-len("@int8")]):
            raise AssertionError(f"{n}: not int8 in the scope, or a float copy lies beside it")
    int8_bytes = sum(pred._scope.get(n).numel() for n in meta["int8_weights"])
    log(f"loaded int8 program: {len(types)} ops, {Q_MULS} mul_int8, {int8_bytes / 1e6:.1f} MB of "
        f"int8 weights on the card, no float copy")

    answers, counts, forwards, readings = _serve(pred, Q_BUCKETS, reqs, "int8 program")
    fetch = pred.get_output_names()[0]
    wants, row_errs = [], []
    for i, (req, ans, ref) in enumerate(zip(reqs, answers, refs)):
        a = req["x"].astype(np.float32)
        got = np.asarray(ans[1]["outputs"][fetch], np.float32)
        want = cpu_pred.run([a])[0]
        wants.append(want)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"int8 request {i}: shape {got.shape} vs {want.shape} or not "
                                 "finite")
        errs = _row_errors(got, want)
        row_errs.append(errs)
        e32 = float(np.abs(got - ref).max())
        env = Q_F32_ENVELOPE[0] * float(np.abs(ref).max()) + Q_F32_ENVELOPE[1]
        log(f"int8 request {i} ({len(a)} rows): vs the CPU's plain path {_row_stats(errs)} of the "
            f"largest |logit| {np.abs(want).max():.4g}; vs the f32 program {e32:.3g} (envelope "
            f"{env:.3g})")
        if e32 >= env:
            raise AssertionError(f"int8 request {i}: {e32} from the f32 program, outside the "
                                 f"envelope {env}")
    row_errs = np.concatenate(row_errs)
    share = float((row_errs <= Q_ROW_RTOL).mean())
    log(f"int8 answers vs the CPU's plain path over {len(row_errs)} rows: {_row_stats(row_errs)} "
        f"(limits: {Q_ROW_SHARE:.0%} of rows within {Q_ROW_RTOL}, every row within "
        f"{Q_FLIP_RTOL})")
    if share < Q_ROW_SHARE or row_errs.max() > Q_FLIP_RTOL:
        raise AssertionError(f"int8 answers vs the CPU: {share:.1%} of rows within {Q_ROW_RTOL}, "
                             f"worst row {row_errs.max()}")
    # the executor's gate fuses residual add + layer_norm pairs onto
    # fused_layernorm_residual: row 1's kernel Q_FUSED_NORMS times a forward
    per = {"int8_matmul": Q_MULS, "layernorm_residual_fwd": Q_FUSED_NORMS}
    want = {name: per.get(name, 0) * forwards for name in counts}
    if forwards <= 0 or counts != want:
        raise AssertionError(f"int8 launches {counts} over {forwards} forwards; want {want}")
    log(f"int8 program: {forwards} forwards, launches {counts}: {Q_MULS} int8 matmul and "
        f"{Q_FUSED_NORMS} fused residual LayerNorm kernels each")

    # control: the first product's activation scale off by 1%
    ctrl = Program.from_dict(pred._program.to_dict())
    first = next(op for op in ctrl.global_block().ops if op.type == "mul_int8")
    first.attrs["scale_x"] *= 1.01
    ctrl_errs = np.concatenate([
        _row_errors(pred._exe.run(ctrl, feed={"x": req["x"].astype(np.float32)},
                                  fetch_list=[fetch], scope=pred._scope)[0], want)
        for req, want in zip(reqs, wants)])
    ctrl_share = float((ctrl_errs <= Q_ROW_RTOL).mean())
    log(f"int8 control (the first mul_int8's scale_x off by 1%): {_row_stats(ctrl_errs)}")
    if not ctrl_share < Q_ROW_SHARE:
        raise AssertionError(f"int8 control: {ctrl_share:.1%} of rows within {Q_ROW_RTOL} passes "
                             f"the limit {Q_ROW_SHARE:.0%}: it cannot catch a scale 1% off")

    readings["weight_replaced"] = _replace_weight(pred, reqs[0]["x"].astype(np.float32))
    int8_ms = _forward_ms(pred._exe, pred._program, pred._scope, [fetch], "int8 program")
    log("forward ms, replayed, int8 beside f32: "
        + ", ".join(f"bucket {b}: {int8_ms[b]:.3f} / {f32_ms[b]:.3f}" for b in Q_BUCKETS))
    with _flags(ir_opt_level=0):  # the program as saved: no fused residual LayerNorm
        unfused_ms = _forward_ms(pred._exe, pred._program, pred._scope, [fetch],
                                 "int8 program, FLAGS_ir_opt_level=0")
    readings["forward_ms"] = {"fused": int8_ms, "unfused": unfused_ms, "f32": f32_ms}
    feeds = {b: _q_feed(b, 32 + b) for b in Q_BUCKETS}
    readings["by_bucket"] = _captured_vs_eager(pred, feeds, _eager_program_run(pred),
                                               "int8 program")
    readings["concurrent"] = _concurrent_replays(pred, _q_feed, 64, 100, "int8 program")
    return counts, readings


def _q_feed(bucket, seed):
    return [np.random.RandomState(seed).randn(bucket, Q_HIDDEN).astype(np.float32)]


def _eager_program_run(pred):
    """``pred.run``'s eager counterpart: the executor's interpreter, over the
    program its gates hand back for the feed (the fused one), on the host
    feeds moved to the card, the fetches copied to the host."""
    import torch

    def run(feed):
        names, fetch = pred.get_input_names(), pred.get_output_names()
        program = pred._exe.gate(pred._program, names, fetch,
                                 {n: a.shape for n, a in zip(names, feed)})[0]
        with torch.no_grad():
            env = {n: torch.from_numpy(a).cuda() for n, a in zip(names, feed)}
            out = pred._exe._interpret(program.global_block(), env, pred._scope, fetch)
        return [t.cpu().numpy() for t in out]

    return run


def _replace_weight(pred, a):
    """Add 1 to the last product's bias through ``Scope.set``: the next
    answer must follow it (the scope's new generation keys a new graph, so
    the old graph, which reads the old tensor, does not replay), and setting
    the old tensor back must bring the old answer back. Returns the
    readings."""
    ops = pred._program.global_block().ops
    name = next(op.inputs["X"][1] for op in reversed(ops) if op.type == "elementwise_add")
    old = pred._scope.get(name)
    misses0 = pred.store.misses
    before = pred.run([a])[0]
    pred._scope.set(name, old + 1.0)
    try:
        after = pred.run([a])[0]
    finally:
        pred._scope.set(name, old)
    pred.run([a])  # the capture; then a replay, as ``before`` was
    back = pred.run([a])[0]
    err = float(np.abs(after - (before + 1.0)).max())
    r = {"bias": name, "max_err_vs_old_plus_1": err, "restored_bit_equal": bool(
        np.array_equal(back, before)), "captures": pred.store.misses - misses0}
    log(f"int8 program: a weight replaced through Scope.set: {r}")
    if err > 1e-4 or not r["restored_bit_equal"] or r["captures"] != 2:
        raise AssertionError(f"int8 program: the replaced weight did not show: {r}")
    return r


# -- a static ResNet-50 through the executor's IR gates (phase 11b) --------------------------

RN_STAGES = (3, 4, 6, 3)  # ResNet-50's bottlenecks a stage
RN_UNFUSED_PAIRS = 20  # conv + bn with no relu: conv3/bn3 of 16 blocks and the 4 shortcuts
RN_CPU_REQUESTS = 3  # the requests also answered on the CPU (1 + 6 + 3 images)
RN_TRAIN_B, RN_TRAIN_STEPS = 8, 2  # the static training program under the remat gate
GATE_REPLAYS = 200  # replays of bucket 1 timed on the host clock, with the gates and without
# the dequantize_static -> mul program: an FFN product at phase 11's widths
DQ_ROWS, DQ_K, DQ_N = 64, 768, 3072
DQ_RTOL, DQ_ATOL = 1e-4, 1e-5  # the int8 contraction against f32 of the dequantized operands


@contextlib.contextmanager
def _flags(**values):
    """Set port flags for the block, and set them back."""
    from paddle_tpu_torch.flags import flag, set_flags

    old = {k: flag(k) for k in values}
    set_flags(values)
    try:
        yield
    finally:
        set_flags(old)


def build_static_resnet(static, ops, stages=RN_STAGES, classes=RN_CLASSES, hw=RN_HW, batch=None,
                        train=False):
    """ResNet-50 v1.5 (the stride on the 3x3 conv) as a static program, from
    either package's ``static`` and ``ops``: bias-free ``static.nn.conv2d``,
    ``static.nn.batch_norm``, ``ops.relu``, the stem's ``ops.max_pool2d``,
    the residual ``ops.add``, global average pooling as a mean over H and W,
    and ``static.nn.fc``. The convs and batch norms are built in the order
    of the dygraph ``models.resnet50``'s modules (:func:`carry_resnet_weights`).
    Returns (image, logits), and for ``train`` (image, label, logits, loss)
    with a mean softmax cross entropy."""
    def conv_bn(x, c, k, s=1, act=True):
        h = static.nn.conv2d(x, c, k, stride=s, padding=k // 2, bias_attr=False)
        h = static.nn.batch_norm(h, is_test=not train)
        return ops.relu(h) if act else h

    image = static.data("image", [batch, 3, hw, hw], "float32")
    x = ops.max_pool2d(conv_bn(image, 64, 7, 2), kernel_size=3, stride=2, padding=1)
    for i, blocks in enumerate(stages):
        planes = 64 * 2 ** i
        for j in range(blocks):
            out = conv_bn(x, planes, 1)
            out = conv_bn(out, planes, 3, 2 if j == 0 and i > 0 else 1)
            out = conv_bn(out, planes * 4, 1, act=False)
            identity = conv_bn(x, planes * 4, 1, 2 if i > 0 else 1, act=False) if j == 0 else x
            x = ops.relu(ops.add(out, identity))
    logits = static.nn.fc(ops.mean(x, axis=[2, 3]), classes)
    if not train:
        return image, logits
    label = static.data("label", [batch, 1], "int64")
    return image, label, logits, ops.mean(ops.softmax_with_cross_entropy(logits, label))


def carry_resnet_weights(model, program, scope):
    """The dygraph ``model``'s parameters and running statistics into
    ``scope`` under the static program's names: its convs, batch norms and
    fc in the order both build them."""
    from paddle_tpu_torch.nn.layers import BatchNorm2D, Conv2D, Linear

    ops_ = program.global_block().ops
    names = ([[op.inputs["X"][1]] for op in ops_ if op.type == "conv2d"]
             + [op.inputs["X"][1:5] for op in ops_ if op.type == "batch_norm"]
             + [[next(op for op in ops_ if op.type == "mul").inputs["X"][1],
                 [op for op in ops_ if op.type == "elementwise_add"][-1].inputs["X"][1]]])
    mods = [m for kind in (Conv2D, BatchNorm2D, Linear) for m in model.modules()
            if isinstance(m, kind)]
    if len(mods) != len(names):
        raise AssertionError(f"{len(mods)} dygraph layers for {len(names)} static ones")
    for m, ns in zip(mods, names):
        tensors = ([m.weight] if isinstance(m, Conv2D) else
                   [m.weight, m.bias, m._mean, m._variance] if isinstance(m, BatchNorm2D) else
                   [m.weight, m.bias])
        for n, t in zip(ns, tensors):
            var = program.global_block().var(n)
            if list(var.shape) != list(t.shape):
                raise AssertionError(f"{n}: static {var.shape}, dygraph {list(t.shape)}")
            scope.set(n, t.detach().cpu().numpy())


def _save_static_resnet(dirname, model):
    """ResNet-50 v1.5 built as a static program, ``model``'s weights carried
    into its scope, cloned for test and saved with ``save_inference_model``."""
    from paddle_tpu_torch import ops, static

    static.enable_static()
    static.reset_default_programs()
    try:
        _, logits = build_static_resnet(static, ops)
        scope = static.Scope()
        prog = static.default_main_program()
        carry_resnet_weights(model, prog, scope)
        static.save_inference_model(dirname, ["image"], [logits], static.Executor("cpu"),
                                    main_program=prog.clone(for_test=True), scope=scope)
    finally:
        static.disable_static()
        static.reset_default_programs()


def _static_forward_ms(pred, buckets, label):
    """Time of one captured forward of ``pred`` (a ``ProgramPredictor``) per
    bucket, the images already on the card: CUDA events around 20 replays
    enqueued back to back (``_forward_ms``). Returns ``{bucket: ms}``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(29)
    fetch = pred.get_output_names()
    out = {}
    for b in buckets:
        x = torch.randn(b, 3, RN_HW, RN_HW, generator=g, device="cuda")
        out[b] = time_ms(lambda x: pred._exe.run(pred._program, feed={"image": x},
                                                 fetch_list=fetch, scope=pred._scope,
                                                 return_numpy=False), [(x,)], 20)
    log(f"{label} forward, replayed, ms a bucket: "
        + ", ".join(f"{b}: {ms:.3f}" for b, ms in out.items()))
    return out


def _plan_readings(pred, buckets):
    """Each bucket's memory plan (the executor's own, a cache hit) beside what
    the card measured over the signature's first run
    (``analysis.accuracy_records``)."""
    from paddle_tpu_torch.analysis import accuracy_records

    fetch = pred.get_output_names()
    out = {}
    for b in buckets:
        shape = (b, 3, RN_HW, RN_HW)
        prog, plan = pred._exe.gate(pred._program, ["image"], fetch, {"image": shape})
        recs = [r for r in accuracy_records()
                if r["cache_key"].startswith(f"({prog._identity_token}, ")
                and str(shape) in r["cache_key"]]
        if len(recs) != 1 or plan is None:
            raise AssertionError(f"bucket {b}: {len(recs)} measured first runs, plan {plan}")
        rec = recs[0]
        out[b] = {"predicted_peak_mib": plan.peak_bytes / 2**20,
                  "measured_peak_mib": rec["actual_bytes"] / 2**20,
                  "baseline_mib": plan.baseline_bytes / 2**20,
                  "predicted_transient_mib": rec["predicted_transient_bytes"] / 2**20,
                  "measured_transient_mib": rec["actual_transient_bytes"] / 2**20,
                  "plan_accuracy": rec["plan_accuracy"],
                  "high_water_op": f"#{plan.peak_op_index} {plan.peak_op_type}",
                  "top_tensor": plan.top_tensors[0][0] if plan.top_tensors else None}
    return out


def _static_rn_training(model, level, budget=None):
    """The static ResNet-50 training program (Momentum, batch RN_TRAIN_B)
    ``RN_TRAIN_STEPS`` steps from ``model``'s weights on fixed batches, at IR
    level ``level`` under ``budget`` (strict admission) or none. Returns
    (losses, the first step's plan and measured peak, op types run)."""
    import torch

    from paddle_tpu_torch import ops, static
    from paddle_tpu_torch.analysis import accuracy_records

    rng = np.random.RandomState(37)
    batches = [{"image": rng.randn(RN_TRAIN_B, 3, RN_HW, RN_HW).astype(np.float32),
                "label": rng.randint(0, RN_CLASSES, (RN_TRAIN_B, 1)).astype(np.int64)}
               for _ in range(RN_TRAIN_STEPS)]
    static.enable_static()
    static.reset_default_programs()
    try:
        _, _, _, loss = build_static_resnet(static, ops, batch=RN_TRAIN_B, train=True)
        static.optimizer.Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM).minimize(loss)
        prog = static.default_main_program()
        scope, exe = static.Scope(), static.Executor()
        exe.run_startup(scope=scope)
        carry_resnet_weights(model, prog, scope)
        flags = dict(ir_opt_level=level)
        if budget is not None:
            flags.update(memory_budget_check="strict", device_peaks=f"hbm_bytes={budget}")
        with _flags(**flags):
            losses = [float(exe.run(prog, feed=b, fetch_list=[loss], scope=scope)[0])
                      for b in batches]
            shapes = {n: a.shape for n, a in batches[0].items()}
            ran, plan = exe.gate(prog, list(shapes), [loss.name], shapes)
    finally:
        static.disable_static()
        static.reset_default_programs()
    rec = next(r for r in accuracy_records()
               if r["cache_key"].startswith(f"({ran._identity_token}, "))
    torch.cuda.empty_cache()
    return losses, plan, rec, [op.type for op in ran.global_block().ops]


def _level2_plan(program, feeds, fetch, shapes, device):
    """The level-2 plan of a copy of the program under a 1-byte budget: as far
    as remat can cut it (a copy, since the optimizer caches per level, not
    per budget)."""
    from paddle_tpu_torch.analysis import optimize_program, plan_memory
    from paddle_tpu_torch.static.program import Program

    copy_ = Program.from_dict(program.to_dict())
    with _flags(device_peaks="hbm_bytes=1"):
        res = optimize_program(copy_, feeds, [fetch], level=2, feed_shapes=shapes, device=device)
    remat = sum(s.ops_rewritten for s in res.stats if s.name == "rematerialize")
    return plan_memory(res.program, feeds, [fetch], feed_shapes=shapes), remat


def _static_rn_remat(model):
    """(d) The training program at level 1, then at level 2 under a budget
    between the level-2 and the level-1 plans: the level-1 program must be
    refused under that budget, and the level-2 losses equal level 1's bit for
    bit; the measured peaks side by side."""
    import torch

    from paddle_tpu_torch import ops, static
    from paddle_tpu_torch.analysis import MemoryBudgetError, optimize_program, plan_memory

    torch.backends.cudnn.deterministic = True  # bit-equal losses across two runs
    try:
        losses1, plan1, rec1, _ = _static_rn_training(model, 1)
        static.enable_static()
        static.reset_default_programs()
        try:
            _, _, _, loss = build_static_resnet(static, ops, batch=RN_TRAIN_B, train=True)
            static.optimizer.Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM).minimize(loss)
            prog = static.default_main_program()
            feeds = ["image", "label"]
            shapes = {"image": (RN_TRAIN_B, 3, RN_HW, RN_HW), "label": (RN_TRAIN_B, 1)}
            dev = torch.device("cuda", torch.cuda.current_device())
            p1 = plan_memory(optimize_program(prog, feeds, [loss.name], level=1,
                                              feed_shapes=shapes, device=dev).program,
                             feeds, [loss.name], feed_shapes=shapes)
            p2, remat = _level2_plan(prog, feeds, loss.name, shapes, dev)
        finally:
            static.disable_static()
            static.reset_default_programs()
        r = {"level1_plan_mib": p1.peak_bytes / 2**20, "level2_plan_mib": p2.peak_bytes / 2**20,
             "remat_ops": remat, "level1_losses": losses1,
             "level1_measured_peak_mib": rec1["actual_bytes"] / 2**20,
             "level1_measured_transient_mib": rec1["actual_transient_bytes"] / 2**20}
        if p2.peak_bytes < p1.peak_bytes:
            budget = (p1.peak_bytes + p2.peak_bytes) // 2
            try:
                _static_rn_training(model, 1, budget)
                raise AssertionError(f"remat: the level-1 program passed a budget of {budget} "
                                     f"under its plan of {p1.peak_bytes}")
            except MemoryBudgetError as e:
                r["level1_refused"] = str(e)[:200]
        else:
            # no candidate: every activation's late use is a grad:: replay, which
            # remat refuses (as the JAX pass does); level 2 then runs level 1's program
            budget = p1.peak_bytes
        losses2, plan2, rec2, types2 = _static_rn_training(model, 2, budget)
        r.update(budget_mib=budget / 2**20, level2_losses=losses2,
                 level2_measured_peak_mib=rec2["actual_bytes"] / 2**20,
                 level2_measured_transient_mib=rec2["actual_transient_bytes"] / 2**20,
                 remat_ops_run=sum("@remat" in op for op in types2))
    finally:
        torch.backends.cudnn.deterministic = False
    if losses2 != losses1 or not all(np.isfinite(losses1)):
        raise AssertionError(f"remat: level-2 losses {losses2} are not level 1's {losses1}")
    log(f"static ResNet-50 training (batch {RN_TRAIN_B}, {RN_TRAIN_STEPS} Momentum steps): "
        f"{r}")
    return r


def _static_verify_on_card():
    """(e) A program whose op reads an undefined variable: ``VerifyError`` on
    the card, naming it, before anything is captured."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.analysis import VerifyError

    p = static.Program()
    b = p.global_block()
    b.create_var(name="x", shape=[2], dtype="float32", is_data=True)
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["ghost"]}, {"Out": ["o"]}, {})
    exe = static.Executor()
    try:
        exe.run(p, feed={"x": np.ones(2, np.float32)}, fetch_list=["o"])
    except VerifyError as e:
        r = {"pass": e.pass_name, "op": f"#{e.op_index} {e.op_type}", "var": e.var,
             "captures": exe.store.misses}
    else:
        raise AssertionError("a program reading an undefined variable ran on the card")
    if r["var"] != "ghost" or r["captures"] or len(exe.store):
        raise AssertionError(f"verifier on the card: {r}")
    log(f"verifier on the card: {r}")
    return r


def _gate_replay_host(pred):
    """(f) The host time of one replay at bucket 1 with the three gates and
    without them: the same graph (the optimized clone's) either way; and of
    the gates alone."""
    import torch

    fetch = pred.get_output_names()
    x = torch.from_numpy(_rn_feed(1, 41)[0]).cuda()
    shapes = {"image": tuple(x.shape)}
    clone = pred._exe.gate(pred._program, ["image"], fetch, shapes)[0]
    misses = pred.store.misses

    def host_us(program):
        run = lambda: pred._exe.run(program, feed={"image": x}, fetch_list=fetch,  # noqa: E731
                                    scope=pred._scope, return_numpy=False)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GATE_REPLAYS):
            run()
        us = (time.perf_counter() - t0) * 1e6 / GATE_REPLAYS
        torch.cuda.synchronize()
        return us

    on = host_us(pred._program)
    with _flags(program_verify="off", ir_opt_level=0, memory_budget_check="off"):
        off = host_us(clone)
    t0 = time.perf_counter()
    for _ in range(GATE_REPLAYS):
        pred._exe.gate(pred._program, ["image"], fetch, shapes)
    gates = (time.perf_counter() - t0) * 1e6 / GATE_REPLAYS
    r = {"replay_host_us_gates_on": on, "replay_host_us_gates_off": off,
         "gates_alone_us": gates, "captures": pred.store.misses - misses}
    log(f"static ResNet-50 bucket 1, host time a replay: {r}")
    if r["captures"]:
        raise AssertionError(f"gate timing captured {r['captures']} graphs: the gates changed "
                             "the signature")
    return r


def _dequantized_mul_on_card():
    """(g) ``dequantize_static`` of an int8 activation and an int8 weight
    under a ``mul``: the gate contracts it onto ``mul_int8``, which launches
    row 15's kernel once a product; its answer against the f32 product of
    the dequantized operands (level 0)."""
    import torch

    from paddle_tpu_torch import static
    from paddle_tpu_torch.analysis import optimize_program
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    rng = np.random.RandomState(43)
    p = static.Program()
    b = p.global_block()
    b.create_var(name="x8", shape=[-1, DQ_K], dtype="int8", is_data=True)
    b.create_var(name="w8", shape=[DQ_K, DQ_N], dtype="int8", persistable=True)
    for n, shape in (("x", [-1, DQ_K]), ("w", [DQ_K, DQ_N]), ("y", [-1, DQ_N])):
        b.create_var(name=n, shape=shape, dtype="float32")
    b.append_op("dequantize_static", {"X": ["x8"]}, {"Out": ["x"]},
                {"scale": 3.0, "bit_length": 8, "dtype": "float32"})
    b.append_op("dequantize_static", {"X": ["w8"]}, {"Out": ["w"]},
                {"scale": 0.5, "bit_length": 8, "dtype": "float32"})
    b.append_op("mul", {"X": ["x", "w"]}, {"Out": ["y"]}, {})
    scope, exe = static.Scope(), static.Executor()
    scope.set("w8", rng.randint(-127, 128, (DQ_K, DQ_N)).astype(np.int8))
    x8 = rng.randint(-127, 128, (DQ_ROWS, DQ_K)).astype(np.int8)
    types = [op.type for op in optimize_program(p, ["x8"], ["y"], level=1).program
             .global_block().ops]
    got = exe.run(p, feed={"x8": x8}, fetch_list=["y"], scope=scope)[0]  # the capture
    reset_launch_counts()
    for _ in range(3):
        exe.run(p, feed={"x8": x8}, fetch_list=["y"], scope=scope)
    counts = {k: v for k, v in launch_counts().items() if v}
    with _flags(ir_opt_level=0):
        want = exe.run(p, feed={"x8": x8}, fetch_list=["y"], scope=scope)[0]
    err = float(np.abs(got - want).max())
    r = {"ops": types, "launches_3_runs": counts, "max_abs_err": err}
    log(f"dequantize_static -> mul at [{DQ_ROWS}, {DQ_K}] @ [{DQ_K}, {DQ_N}]: {r}")
    if types != ["mul_int8"] or counts != {"int8_matmul": 3}:
        raise AssertionError(f"the dequantized mul did not contract onto mul_int8: {r}")
    np.testing.assert_allclose(got, want, rtol=DQ_RTOL, atol=DQ_ATOL * np.abs(want).max())
    torch.cuda.empty_cache()
    return counts, r


def serve_resnet_static():
    """Phase 11b. ResNet-50 v1.5 at full width built as a static program with
    ``_resnet50``'s weights, saved with ``save_inference_model`` and served
    from the directory through ``create_predictor(Config(dir))`` at buckets
    1, 8, 32 at the default flags: the IR optimizer rewrites its 33 conv +
    bn + relu chains onto ``fused_conv_bn_relu`` (row 8's kernel 33 times a
    forward), answers within RN_SERVE_RTOL of the dygraph Predictor's on the
    card and of the CPU's plain path; the same directory at
    ``FLAGS_ir_opt_level=0`` with no fused launch and the same answers; the
    memory plan against the card's peaks, a strict budget refusal before any
    capture, the training program under level-2 remat; the verifier on the
    card; a replay's host time with the gates and without; a dequantized mul
    onto ``mul_int8``. Returns (kernel launches per name, readings)."""
    import torch

    from paddle_tpu_torch.analysis import MemoryBudgetError, optimize_program
    from paddle_tpu_torch.inference import Config, Predictor, create_predictor
    from paddle_tpu_torch.jit_api import InputSpec
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    model = _resnet50(seed=0)
    rng = np.random.RandomState(23)
    reqs = [{"image": _images(rng, rows)} for rows in (1, 6, 3, 20)]
    with tempfile.TemporaryDirectory(prefix="ptt_rn_static_") as dirname:
        t0 = time.perf_counter()
        _save_static_resnet(dirname, model)
        saved_s = time.perf_counter() - t0
        pred = create_predictor(Config(dirname))
        plain = create_predictor(Config(dirname))
        cpu_pred = create_predictor(Config(dirname), device="cpu")
    fetch = pred.get_output_names()[0]
    dyn = Predictor(model, [InputSpec([None, 3, RN_HW, RN_HW], "float32", "image")], ["logits"])
    r = {"saved_s": saved_s}

    # (b) served at the default flags: the fused chains
    answers, counts, forwards, r["serving"] = _serve(pred, RN_BUCKETS, reqs,
                                                      "static ResNet-50")
    shapes1 = {"image": (1, 3, RN_HW, RN_HW)}
    res = optimize_program(pred._program, ["image"], [fetch], feed_shapes=shapes1,
                           device=pred.device)
    types = [op.type for op in res.program.global_block().ops]
    r["rewrites"] = {s.name: s.ops_rewritten for s in res.stats}
    r["ops"] = {t: types.count(t) for t in ("fused_conv_bn_relu", "conv2d", "batch_norm")}
    log(f"static ResNet-50: {len(pred._program.global_block().ops)} ops saved, {len(types)} run; "
        f"rewrites {r['rewrites']}; {r['ops']}")
    if (r["rewrites"].get("fuse_conv_bn_relu") != RN_TRIPLES
            or r["ops"] != {"fused_conv_bn_relu": RN_TRIPLES, "conv2d": RN_UNFUSED_PAIRS,
                            "batch_norm": RN_UNFUSED_PAIRS}):
        raise AssertionError(f"static ResNet-50: {r['rewrites']}, {r['ops']}")
    want = {"conv_bn_relu_mm_affine_relu": RN_TRIPLES * forwards}
    want = {name: want.get(name, 0) for name in counts}
    if forwards <= 0 or counts != want:
        raise AssertionError(f"static ResNet-50 launches {counts} over {forwards} forwards; "
                             f"want {want}")
    errs = []
    for i, (req, ans) in enumerate(zip(reqs, answers)):
        x = req["image"].astype(np.float32)
        got = np.asarray(ans[1]["outputs"][fetch], np.float32)
        refs = {"dygraph": dyn.run([x])[0]}
        if i < RN_CPU_REQUESTS:
            refs["cpu"] = cpu_pred.run([x])[0]
        e = {k: float(np.abs(got - w).max() / np.abs(w).max()) for k, w in refs.items()}
        errs.append(e)
        log(f"static ResNet-50 request {i} ({len(x)} images): max err over the largest |logit| "
            f"{e} (limit {RN_SERVE_RTOL})")
        if got.shape != refs["dygraph"].shape or max(e.values()) > RN_SERVE_RTOL:
            raise AssertionError(f"static ResNet-50 request {i}: {got.shape}, {e}")
    r["errors"] = errs
    r["fused_ms"] = _static_forward_ms(pred, RN_BUCKETS, "static ResNet-50, fused")
    r["memory"] = _plan_readings(pred, RN_BUCKETS)
    log(f"static ResNet-50 memory plan against the card, by bucket: {r['memory']}")

    # (c) the same directory at FLAGS_ir_opt_level=0: no fused launch, the same answers
    with _flags(ir_opt_level=0):
        feeds = {b: _rn_feed(b, 50 + b) for b in RN_BUCKETS}
        unfused = {b: plain.run(f)[0] for b, f in feeds.items()}  # the captures
        reset_launch_counts()
        for f in feeds.values():
            plain.run(f)
        plain_counts = {k: v for k, v in launch_counts().items() if v}
        r["unfused_ms"] = _static_forward_ms(plain, RN_BUCKETS, "static ResNet-50, unfused")
        r["unfused_memory"] = _plan_readings(plain, RN_BUCKETS)
    r["fused_vs_unfused"] = {b: float(np.abs(pred.run(f)[0] - unfused[b]).max()
                                      / np.abs(unfused[b]).max()) for b, f in feeds.items()}
    log(f"static ResNet-50 at level 0: launches {plain_counts} over {len(feeds)} replays; fused "
        f"against unfused answers {r['fused_vs_unfused']}; ms fused / unfused "
        + ", ".join(f"{b}: {r['fused_ms'][b]:.3f} / {r['unfused_ms'][b]:.3f}" for b in RN_BUCKETS))
    if plain_counts or max(r["fused_vs_unfused"].values()) > RN_SERVE_RTOL:
        raise AssertionError(f"static ResNet-50 unfused: {plain_counts}, "
                             f"{r['fused_vs_unfused']}")

    # (d) a strict budget below bucket 32's plan: refused before any capture
    b = RN_BUCKETS[-1]
    plan = pred._exe.gate(pred._program, ["image"], [fetch], {"image": (b, 3, RN_HW, RN_HW)})[1]
    misses, graphs = pred.store.misses, len(pred.store)
    with _flags(memory_budget_check="strict", device_peaks=f"hbm_bytes={plan.peak_bytes - 1}"):
        try:
            pred.run(feeds[b])
            raise AssertionError("static ResNet-50 ran over a budget below its plan")
        except MemoryBudgetError as e:
            r["refusal"] = {"op": f"#{e.op_index} {e.op_type}", "peak_mib": e.peak_bytes / 2**20,
                            "captures": pred.store.misses - misses}
            if (e.op_index, e.op_type) != (plan.peak_op_index, plan.peak_op_type) \
                    or pred.store.misses != misses or len(pred.store) != graphs:
                raise AssertionError(f"static ResNet-50 refusal: {r['refusal']}") from e
    log(f"static ResNet-50 refused under a budget 1 byte below its bucket-{b} plan: "
        f"{r['refusal']}")
    r["remat"] = _static_rn_remat(model)

    # (e), (f), (g)
    r["verify"] = _static_verify_on_card()
    r["gates"] = _gate_replay_host(pred)
    dq_counts, r["dequantized_mul"] = _dequantized_mul_on_card()
    counts = {k: counts.get(k, 0) + dq_counts.get(k, 0) for k in counts}
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"static ResNet-50: phase 11b done in {r['phase_s']:.1f} s")
    del pred, plain, cpu_pred, dyn, model
    torch.cuda.empty_cache()
    return counts, r


# -- the serving fleet (phase 12l) -----------------------------------------------------------

FLEET_CLIENTS, FLEET_PER_CLIENT = 6, 20
FLEET_ROWS = (1, 2, 4, 8, 16)  # rows of the /predict requests, in turn
FLEET_GEN_REQUESTS = 16  # 12i's first 16 requests
FLEET_KILL_AFTER = 40  # answers of the burst before one predict backend is killed
FLEET_BOOT_S = 300  # the longest a backend process may take to announce its port
FLEET_PROBE_S = 5.0  # long: the kill must be found by the dispatch path, not a probe
_FLEET_TIERS = {  # name: the backend CLI's arguments after --kind
    "predict0": ["predict", "--replicas", "2", "--buckets", "8,64,512", "--batch-timeout-ms", "2"],
    "predict1": ["predict", "--replicas", "2", "--buckets", "8,64,512", "--batch-timeout-ms", "2"],
    "generate": ["generate", "--slots", "16"],
    "prefill": ["prefill", "--slots", "1"],
    "decode": ["decode", "--slots", "16"],
}


def _tail(path, n=3000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _spawn_backend(tmp, name, model_dir, gpt_dir):
    """``python -m paddle_tpu_torch.serving.backend`` for one tier of
    ``_FLEET_TIERS``, its output in ``<tmp>/<name>.log``."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    kind, *extra = _FLEET_TIERS[name]
    args = ["--kind", kind] + (["--model-dir", model_dir] if kind == "predict" else
                               ["--gpt-dir", gpt_dir, "--cache-len", str(GPT_CACHE),
                                "--prefill-buckets", ",".join(map(str, GPT_BUCKETS))]) + extra
    if GPT_DEVICE == "cpu":  # a rehearsal on the CPU
        args += ["--device", "cpu"]
    b = {"name": name, "kind": kind, "log": os.path.join(tmp, f"{name}.log"),
         "port_file": os.path.join(tmp, f"{name}.port"), "url": None, "t0": time.perf_counter()}
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(b["log"], "w") as out:
        b["proc"] = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.backend", *args, "--port-file",
             b["port_file"]], cwd=root, env=env, stdout=out, stderr=subprocess.STDOUT)
    return b


def _await_backends(backends):
    """Wait for every backend's port file (written after its warmup); a
    backend that exits first fails the phase with its log."""
    import os

    deadline = time.monotonic() + FLEET_BOOT_S
    pending = list(backends)
    while pending:
        for b in list(pending):
            if os.path.exists(b["port_file"]):
                with open(b["port_file"]) as f:
                    b["url"] = f"http://127.0.0.1:{int(f.read())}"
                b["ready_s"] = time.perf_counter() - b["t0"]
                pending.remove(b)
            elif b["proc"].poll() is not None:
                raise AssertionError(f"fleet: backend {b['name']} exited {b['proc'].returncode} "
                                     f"before it was ready:\n{_tail(b['log'])}")
        if pending and time.monotonic() > deadline:
            raise AssertionError(f"fleet: {[b['name'] for b in pending]} not ready after "
                                 f"{FLEET_BOOT_S} s")
        time.sleep(0.1)


def _fleet_predict_requests():
    """120 requests of 1-16 rows of the int8 program's input, three decimals
    (short JSON, and exactly the float32 values the server parses)."""
    rng = np.random.RandomState(41)
    return [np.round(rng.randn(FLEET_ROWS[i % len(FLEET_ROWS)], Q_HIDDEN), 3)
            for i in range(FLEET_CLIENTS * FLEET_PER_CLIENT)]


def _cpu_answers(model_dir, reqs):
    """The port's plain path on the CPU from the saved directory, every
    request's rows (run in chunks of the largest bucket: the program's rows
    are independent)."""
    from paddle_tpu_torch.inference import Config, create_predictor

    pred = create_predictor(Config(model_dir), device="cpu")
    rows = np.concatenate([r.astype(np.float32) for r in reqs])
    out = np.concatenate([pred.run([rows[i:i + Q_BUCKETS[-1]]])[0]
                          for i in range(0, len(rows), Q_BUCKETS[-1])])
    bounds = np.cumsum([0] + [len(r) for r in reqs])
    return [out[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _predict_burst(url, reqs, on_answer=None):
    """``FLEET_CLIENTS`` clients at once, client c sending requests c, c + 6,
    ...: (answers as ``(status, body)``, client ms each). ``on_answer(n)``
    runs after the n-th answer."""
    answers, ms = [None] * len(reqs), [None] * len(reqs)
    done, lock = [0], threading.Lock()

    def client(c):
        for i in range(c, len(reqs), FLEET_CLIENTS):
            t = time.perf_counter()
            try:
                answers[i] = _http(url + "/predict", {"inputs": {"x": reqs[i].tolist()}})
            except (urllib.error.URLError, OSError) as e:  # a dropped connection fails too
                answers[i] = (f"connection: {type(e).__name__}", {})
            ms[i] = (time.perf_counter() - t) * 1e3
            with lock:
                done[0] += 1
                n = done[0]
            if on_answer is not None:
                on_answer(n)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return answers, ms


def _held_rows(answers, wants, label):
    """Every answer 200 and held per row against the CPU's plain path under
    phase 11's limits."""
    errs = []
    for i, (ans, want) in enumerate(zip(answers, wants)):
        if ans is None or ans[0] != 200:
            raise AssertionError(f"fleet {label}: request {i} answered {ans and ans[0]}: "
                                 f"{ans and str(ans[1])[:300]}")
        got = np.asarray(next(iter(ans[1]["outputs"].values())), np.float32)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"fleet {label}: request {i} {got.shape} vs {want.shape}, or "
                                 "not finite")
        errs.append(_row_errors(got, want))
    errs = np.concatenate(errs)
    share = float((errs <= Q_ROW_RTOL).mean())
    if share < Q_ROW_SHARE or errs.max() > Q_FLIP_RTOL:
        raise AssertionError(f"fleet {label}: {share:.1%} of rows within {Q_ROW_RTOL}, worst "
                             f"row {errs.max()}")
    return {"requests": len(answers), "rows": int(len(errs)), "share_within": share,
            "worst_row": float(errs.max())}


def _quantiles(ms):
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(np.mean(ms))}


_STAGES = ("serving/queue_ms", "serving/assemble_ms", "serving/dispatch_ms", "serving/e2e_ms")


def _stage_quantiles(before, after):
    """Server-side p50/p99 of each ``/predict`` stage over the requests
    between two sets of ``/histz`` snapshots (lists, one a backend): the
    bucket counts' differences merged, quantiles interpolated inside the
    registry's buckets."""
    from paddle_tpu_torch.monitor import histogram_quantile, merge_histogram_snapshots

    out = {}
    for name in _STAGES:
        snaps = []
        for b, a in zip(before, after):
            a = a[name]
            b = b.get(name) or {"buckets": [0] * len(a["buckets"]), "sum": 0.0, "count": 0}
            snaps.append({"bounds": a["bounds"], "sum": a["sum"] - b["sum"],
                          "count": a["count"] - b["count"],
                          "buckets": [x - y for x, y in zip(a["buckets"], b["buckets"])]})
        h = merge_histogram_snapshots(snaps, name=name)
        if h.count:
            out[name] = {"p50_ms": histogram_quantile(h, 0.5),
                         "p99_ms": histogram_quantile(h, 0.99), "count": h.count,
                         "mean_ms": h.sum / h.count}
    return out


# the kernels a forward of phase 11's int8 program launches, and how often
FLEET_KERNELS = {"int8_matmul": Q_MULS, "layernorm_residual_fwd": Q_FUSED_NORMS}


def _int8_launches(url):
    """A predict backend's ``/statz``: ({kernel: launches} of FLEET_KERNELS,
    forwards dispatched for requests), every other kernel's launches
    required 0."""
    sz = _http(url + "/statz")[1]
    counts = sz["kernel_launches"]
    if any(v for k, v in counts.items() if k not in FLEET_KERNELS):
        raise AssertionError(f"fleet: a predict backend launched other kernels: {counts}")
    return {k: counts.get(k, 0) for k in FLEET_KERNELS}, sz["batches"]["dispatched"]


def _traffic_launches(got, warm, batches, label):
    """The launches of the requests (``got`` less the warmup's ``warm``),
    required FLEET_KERNELS' count a forward over ``batches`` forwards."""
    traffic = {k: got[k] - warm[k] for k in FLEET_KERNELS}
    if traffic != {k: per * batches for k, per in FLEET_KERNELS.items()}:
        raise AssertionError(f"fleet: {label} launched {traffic} over {batches} forwards, not "
                             f"{FLEET_KERNELS} each")
    return traffic


def _fleet_generate(url, reqs, refs, label):
    """``reqs`` as concurrent greedy ``/generate`` requests: every answer
    200 and its tokens the in-process engine's under 12i's near-tie rule.
    Returns the readings."""
    ref_toks, ref_rows = refs
    answers = [None] * len(reqs)

    def client(i):
        prompt, n = reqs[i]
        answers[i] = _http(url + "/generate", {"prompt": prompt, "max_new_tokens": n,
                                               "temperature": 0.0})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    held = wrong = tokens = 0
    for s, ans in enumerate(answers):
        if ans is None or ans[0] != 200:
            raise AssertionError(f"fleet {label}: /generate {s} answered {ans and ans[0]}: "
                                 f"{ans and str(ans[1])[:300]}")
        toks = ans[1]["tokens"]
        cover, w, _ = _held_against(toks, None, ref_toks[s], ref_rows[s])
        held, wrong, tokens = held + cover, wrong + w, tokens + len(toks)
    r = {"requests": len(reqs), "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
         "positions_held": held, "tokens_differing": wrong}
    if wrong or held < tokens // 2:
        raise AssertionError(f"fleet {label}: the answers part from the in-process engine's: {r}")
    return r


def _fleet_accounting(router, live):
    """Every live backend's ``/loadz`` without an unexpected capture; the
    router's merged ``/statz`` counts equal to the sum of the backends' own
    ``/histz`` counts for every ``serving/*`` histogram; ``/fleetz`` by
    kind."""
    loadz = {b["name"]: _http(b["url"] + "/loadz")[1] for b in live}
    for name, lz in loadz.items():
        if lz["compiles"]["unexpected"] or not lz["ready"] or lz["kind"] != _FLEET_TIERS[name][0]:
            raise AssertionError(f"fleet: {name}'s /loadz after the traffic: {lz}")
    merged = _http(router.url + "/statz")[1]["latency"]["backends_merged"]
    own = {b["name"]: _http(b["url"] + "/histz")[1]["histograms"] for b in live}
    sums = {}
    for hists in own.values():
        for name, snap in hists.items():
            sums[name] = sums.get(name, 0) + snap["count"]
    want = {n: c for n, c in sums.items() if c}
    got = {n: row["count"] for n, row in merged.items()}
    if got != want:
        raise AssertionError(f"fleet: merged /statz counts {got} != the backends' own {want}")
    router.probe_once()  # fresh snapshots for /fleetz
    fz = _http(router.url + "/fleetz")[1]
    kinds = {k: sorted(rows) for k, rows in fz["fleet"].items()}
    for kind in ("predict", "generate", "decode"):
        n = sum(_FLEET_TIERS[b["name"]][0] == kind for b in live)
        if kind not in fz["fleet"] or any(row["backends"] != n
                                          for row in fz["fleet"][kind].values()):
            raise AssertionError(f"fleet: /fleetz does not group {n} {kind} backends: {fz}")
    return {"loadz": loadz, "merged_counts": got, "fleetz_kinds": kinds,
            "backends_scraped": fz["backends_scraped"], "fleetz": fz["fleet"]}


def _closed(url):
    import socket
    from urllib.parse import urlsplit

    u = urlsplit(url)
    try:
        socket.create_connection((u.hostname, u.port), timeout=2).close()
    except OSError:
        return True
    return False


def serve_fleet(card):
    """Phase 12l. A fleet of backend processes on the card behind an
    in-process ``Router``: two ``predict`` backends over the int8 program
    of phase 11 (buckets 8, 64, 512), a ``generate`` backend and a
    ``prefill`` and a ``decode`` tier of 12i's GPT-2 small (f32 ring). Six
    clients x 20 ``/predict`` requests straight to a backend, then through
    the router, then through the router while one predict backend is
    SIGKILLed; 16 greedy ``/generate`` requests unified, then composed from
    ``/prefill`` and ``/generate_kv``; the fleet's accounting; SIGTERM ->
    drain -> exit 0. Returns (the int8_matmul and the fused residual
    LayerNorm launches the predict backends booked for the requests,
    readings)."""
    import os
    import shutil
    import signal

    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.models import save_gpt_model
    from paddle_tpu_torch.serving import Router

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ptt_fleet_")
    model_dir, gpt_dir = os.path.join(tmp, "int8"), os.path.join(tmp, "gpt")
    backends, router, r = [], None, {"card": card}
    try:
        model = _gpt_model()
        save_gpt_model(model, gpt_dir)
        _make_int8_model(model_dir, [])
        r["saved_s"] = time.perf_counter() - t_phase
        backends = [_spawn_backend(tmp, name, model_dir, gpt_dir) for name in _FLEET_TIERS]
        by = {b["name"]: b for b in backends}
        # while the processes boot: the CPU's answers and the engine's tokens
        reqs = _fleet_predict_requests()
        wants = [None]
        cpu = threading.Thread(target=lambda: wants.__setitem__(0, _cpu_answers(model_dir, reqs)))
        cpu.start()
        gen_reqs = _gpt_requests(model.config.vocab_size)[:FLEET_GEN_REQUESTS]
        eng = GenerationEngine(model, slots=len(gen_reqs), cache_len=GPT_CACHE,
                               prefill_buckets=GPT_BUCKETS, seed=GPT_SEED, device=GPT_DEVICE)
        eng.warmup()
        refs = _decode_logged(eng, list(range(len(gen_reqs))), [p for p, _ in gen_reqs],
                              max(n for _, n in gen_reqs))
        del eng, model
        torch.cuda.empty_cache()
        cpu.join()
        wants = wants[0]
        _await_backends(backends)
        r["ready_s"] = {b["name"]: b["ready_s"] for b in backends}
        r["boot_s"] = time.perf_counter() - t_phase
        log(f"fleet ({card}): 5 backend processes ready after {r['boot_s']:.1f} s of the phase "
            f"(each from its start: {r['ready_s']})")
        w0 = {n: _int8_launches(by[n]["url"]) for n in ("predict0", "predict1")}
        h0 = [_http(by[n]["url"] + "/histz")[1]["histograms"] for n in ("predict0", "predict1")]
        if any(b or any(not w[k] or w[k] % per for k, per in FLEET_KERNELS.items())
               for w, b in w0.values()):
            raise AssertionError(f"fleet: warmup launches of the predict backends {w0}")

        # /predict straight to one backend, then through the router
        answers, direct_ms = _predict_burst(by["predict0"]["url"], reqs)
        r["direct"] = dict(_held_rows(answers, wants, "direct"), **_quantiles(direct_ms))
        h1 = [_http(by[n]["url"] + "/histz")[1]["histograms"] for n in ("predict0", "predict1")]
        r["direct"]["server_stages"] = _stage_quantiles(h0[:1], h1[:1])
        router = Router(backends=[by[n]["url"] for n in ("predict0", "predict1", "generate")],
                        probe_interval_s=FLEET_PROBE_S).start()
        if router.healthy_count != 3:
            raise AssertionError(f"fleet: the router admitted {router.healthz()}")
        answers, routed_ms = _predict_burst(router.url, reqs)
        r["routed"] = dict(_held_rows(answers, wants, "routed"), **_quantiles(routed_ms))
        h2 = [_http(by[n]["url"] + "/histz")[1]["histograms"] for n in ("predict0", "predict1")]
        r["routed"]["server_stages"] = _stage_quantiles(h1, h2)
        r["routed"]["router_e2e"] = _http(router.url + "/statz")[1]["latency"]["router_e2e"]
        launches = {}
        for n in ("predict0", "predict1"):
            got, batches = _int8_launches(by[n]["url"])
            if not batches:
                raise AssertionError(f"fleet: {n} ran no forward")
            launches[n] = {"warmup": w0[n][0], "forwards": batches,
                           "traffic": _traffic_launches(got, w0[n][0], batches, n)}
        log(f"fleet ({card}): /predict of {len(reqs)} requests, {FLEET_CLIENTS} clients, client "
            f"clock: straight to one backend p50 {r['direct']['p50_ms']:.2f} ms, p99 "
            f"{r['direct']['p99_ms']:.2f}; through the router over two p50 "
            f"{r['routed']['p50_ms']:.2f}, p99 {r['routed']['p99_ms']:.2f}; kernel "
            f"launches {launches}; server-side stages direct {r['direct']['server_stages']}, "
            f"routed {r['routed']['server_stages']}, the router's own {r['routed']['router_e2e']}")

        # /generate: the generate backend alone, then composed from the tiers
        r["generate_unified"] = _fleet_generate(router.url, gen_reqs, refs, "unified")
        submitted = _http(by["generate"]["url"] + "/statz")[1]["requests"]["submitted"]
        router.add_backend(by["prefill"]["url"])
        router.add_backend(by["decode"]["url"])
        if not (router.has_kind("prefill") and router.has_kind("decode")):
            raise AssertionError(f"fleet: the tiers are not in rotation: {router.statz()}")
        r["generate_disagg"] = _fleet_generate(router.url, gen_reqs, refs, "disaggregated")
        gz, dz = (_http(by[n]["url"] + "/statz")[1] for n in ("generate", "decode"))
        legs = {b["url"]: b["completed"] for b in router.statz()["backends"]}
        r["generate_disagg"].update(
            generate_tier_submitted=gz["requests"]["submitted"] - submitted,
            decode_tier_completed=dz["requests"]["completed"],
            prefill_legs=legs[by["prefill"]["url"]], decode_legs=legs[by["decode"]["url"]],
            decode_ttft=dz["latency"]["ttft"])
        g = r["generate_disagg"]
        if g["generate_tier_submitted"] or g["decode_tier_completed"] != len(gen_reqs) \
                or g["prefill_legs"] != len(gen_reqs) or g["decode_legs"] != len(gen_reqs):
            raise AssertionError(f"fleet: the router did not compose every /generate from the "
                                 f"two tiers: {g}")
        log(f"fleet ({card}): /generate of {len(gen_reqs)} greedy requests through the router: "
            f"unified {r['generate_unified']['tokens_per_s']:.1f} tokens/s, disaggregated "
            f"{r['generate_disagg']['tokens_per_s']:.1f}; {r['generate_disagg']}")

        # kill -9 one predict backend mid-burst
        evictions0 = router.statz()["fleet"]["evictions"]
        victim = by["predict0"]

        def kill(n):
            if n == FLEET_KILL_AFTER:
                os.kill(victim["proc"].pid, signal.SIGKILL)

        answers, kill_ms = _predict_burst(router.url, reqs, on_answer=kill)
        victim["proc"].wait(60)
        fleet = router.statz()["fleet"]
        r["kill"] = dict(_held_rows(answers, wants, "kill -9"), **_quantiles(kill_ms),
                         evictions=fleet["evictions"] - evictions0, retries=fleet["retries"],
                         victim_rc=victim["proc"].returncode)
        if r["kill"]["evictions"] < 1 or victim["proc"].returncode != -signal.SIGKILL:
            raise AssertionError(f"fleet: the SIGKILL was not survived by eviction: {r['kill']}")
        got, batches = _int8_launches(by["predict1"]["url"])
        launches["predict1"].update(forwards=batches, traffic=_traffic_launches(
            got, w0["predict1"][0], batches, "predict1 after the kill"))
        r["int8_launches"] = launches
        log(f"fleet ({card}): predict0 SIGKILLed after {FLEET_KILL_AFTER} answers of the burst: "
            f"every request answered 200, {r['kill']}")

        live = [b for b in backends if b is not victim]
        r["accounting"] = _fleet_accounting(router, live)

        # teardown: SIGTERM -> drain -> exit 0, then the router
        t0 = time.perf_counter()
        for b in live:
            b["proc"].send_signal(signal.SIGTERM)
        rcs = {b["name"]: b["proc"].wait(120) for b in live}
        router.stop(drain=True)
        r["teardown_s"] = time.perf_counter() - t0
        r["exit_codes"] = rcs
        open_ports = [u for u in [b["url"] for b in backends] + [router.url] if not _closed(u)]
        if any(rcs.values()) or open_ports:
            raise AssertionError(f"fleet: exits {rcs}, listeners left {open_ports}:\n"
                                 + "\n".join(_tail(b["log"], 800) for b in live))
    finally:
        if router is not None:
            router.stop(drain=False)
        for b in backends:
            if b["proc"].poll() is None:
                b["proc"].kill()
                b["proc"].wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"fleet ({card}): phase 12l done in {r['phase_s']:.1f} s")
    counts = {k: sum(v["traffic"][k] for v in r["int8_launches"].values())
              for k in FLEET_KERNELS}
    return counts, r


# -- Paddle's dygraph front end: a Paddle-style ResNet-50 (phase 12m) ------------------------

DY_BATCH, DY_STEPS = 32, 3  # the dygraph steps at bench.py's ResNet batch
DY_HEAD_OURS = ("adaptive_pool2d", "flatten", "linear")  # the head jit.save writes
DY_HEAD_STATIC = ("reduce_mean", "mul")  # and build_static_resnet's (+ the fc's bias add)


def paddle_style_resnet(paddle, stages=RN_STAGES, classes=RN_CLASSES):
    """ResNet-50 v1.5 (the stride on the 3x3 conv) as a Paddle user writes it
    with ``paddle``'s public names (either package's), its sublayers named as
    ``models/resnet.py`` names them (``conv1``, ``layer1.0.bn2``,
    ``layer2.0.downsample.0``, ``fc``) so a ``models.resnet50`` state dict
    sets it."""
    nn, F = paddle.nn, paddle.nn.functional

    class Bottleneck(nn.Layer):
        def __init__(self, inplanes, planes, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(planes)
            self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride, padding=1, bias_attr=False)
            self.bn2 = nn.BatchNorm2D(planes)
            self.conv3 = nn.Conv2D(planes, planes * 4, 1, bias_attr=False)
            self.bn3 = nn.BatchNorm2D(planes * 4)
            self.relu = nn.ReLU()
            self.downsample = downsample

        def forward(self, x):
            out = self.relu(self.bn1(self.conv1(x)))
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            identity = x if self.downsample is None else self.downsample(x)
            return F.relu(paddle.add(out, identity))

    class ResNet50(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(64)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1)
            inplanes = 64
            for i, blocks in enumerate(stages):
                planes, stride = 64 * 2 ** i, 1 if i == 0 else 2
                downsample = nn.Sequential(
                    nn.Conv2D(inplanes, planes * 4, 1, stride=stride, bias_attr=False),
                    nn.BatchNorm2D(planes * 4))
                layers = [Bottleneck(inplanes, planes, stride, downsample)]
                inplanes = planes * 4
                layers += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
                setattr(self, f"layer{i + 1}", nn.Sequential(*layers))
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
            self.fc = nn.Linear(inplanes, classes)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for i in range(len(stages)):
                x = getattr(self, f"layer{i + 1}")(x)
            return self.fc(paddle.flatten(self.avgpool(x), 1))

    return ResNet50()


def _dy_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _dy_train(paddle, net, ref):
    """(a) ``DY_STEPS`` dygraph Momentum steps of ``net`` at batch
    ``DY_BATCH`` with the max-pool backward kernel on; the first loss
    against ``ref`` (``models.resnet50``, the same weights, on the card).
    Returns (launches, readings)."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    F = paddle.nn.functional
    rng = np.random.RandomState(61)
    x = paddle.to_tensor(rng.randn(DY_BATCH, 3, RN_HW, RN_HW).astype(np.float32))
    y = paddle.to_tensor(rng.randint(0, RN_CLASSES, (DY_BATCH,)).astype(np.int64))
    ref.train()
    with torch.no_grad():
        ref_loss = float(F.cross_entropy(ref(x), y))
    opt = paddle.optimizer.Momentum(RN_LR, RN_MOMENTUM, parameters=net.parameters())
    net.train()
    losses, step_ms = [], []
    with _flags(use_pallas_pool_bwd=True):
        torch.cuda.synchronize()
        reset_launch_counts()
        for _ in range(DY_STEPS):
            t0 = time.perf_counter()
            loss = F.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
    r = {"losses": losses, "ref_loss": ref_loss, "loss_err": abs(losses[0] - ref_loss),
         "step_wall_ms": step_ms,
         "launches": {k: v for k, v in counts.items() if v}}
    log(f"dygraph ResNet-50, {DY_STEPS} Momentum steps at batch {DY_BATCH}: {r} "
        f"(limit {RN_LOSS_ATOL})")
    if (not np.all(np.isfinite(losses)) or r["loss_err"] > RN_LOSS_ATOL
            or not counts["momentum_update"] or not counts["max_pool2d_backward"]):
        raise AssertionError(f"dygraph ResNet-50 training: {r}")
    return counts, r


def _dy_program_types(program, feed, fetch):
    """Op types of ``program`` as the IR gate optimizes it at bucket 1."""
    import collections

    from paddle_tpu_torch.analysis import optimize_program

    res = optimize_program(program, [feed], [fetch], feed_shapes={feed: (1, 3, RN_HW, RN_HW)})
    return collections.Counter(op.type for op in res.program.global_block().ops)


def _dy_serve(paddle, net, dirname):
    """(b) ``jit.save`` of ``net`` served at buckets ``RN_BUCKETS`` through
    ``create_predictor`` against the dygraph eval forward; 33 fused launches
    a forward; the optimized program against ``build_static_resnet``'s.
    Returns (launches, readings, predictor)."""
    import torch

    from paddle_tpu_torch import ops, static
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    paddle.jit.save(net, dirname, input_spec=[
        paddle.jit.InputSpec([None, 3, RN_HW, RN_HW], "float32", "image")])
    r = {"save_s": time.perf_counter() - t0}
    pred = create_predictor(Config(dirname))
    fetch = pred.get_output_names()[0]
    ours = _dy_program_types(pred._program, "image", fetch)
    static.enable_static()
    static.reset_default_programs()
    try:
        _, logits = build_static_resnet(static, ops)
        theirs = _dy_program_types(static.default_main_program(), "image", logits.name)
    finally:
        static.disable_static()
        static.reset_default_programs()
    body = {t: n for t, n in ours.items() if t not in DY_HEAD_OURS}
    body_static = {t: n for t, n in theirs.items() if t not in DY_HEAD_STATIC}
    body_static["elementwise_add"] -= 1  # the fc's bias
    r["ops"] = dict(ours)
    r["static_ops"] = dict(theirs)
    log(f"dygraph ResNet-50 saved in {r['save_s']:.1f} s; optimized ops {r['ops']}; 11b's "
        f"program {r['static_ops']}")
    if (body != body_static or ours["fused_conv_bn_relu"] != RN_TRIPLES
            or ours["conv2d"] != RN_UNFUSED_PAIRS or ours["batch_norm"] != RN_UNFUSED_PAIRS
            or any(ours[t] != 1 for t in DY_HEAD_OURS)):
        raise AssertionError(f"jit.save program {dict(ours)} against {dict(theirs)}")
    rng = np.random.RandomState(67)
    feeds = {b: rng.randn(b, 3, RN_HW, RN_HW).astype(np.float32) for b in RN_BUCKETS}
    net.eval()
    with torch.no_grad():
        want = {b: net(paddle.to_tensor(f)).numpy() for b, f in feeds.items()}
    got = {b: pred.run([f])[0] for b, f in feeds.items()}  # the captures
    torch.cuda.synchronize()
    reset_launch_counts()
    for f in feeds.values():
        pred.run([f])
    counts = launch_counts()
    r["errors"] = {b: _dy_rel(got[b], want[b]) for b in RN_BUCKETS}
    r["replay_launches"] = {k: v for k, v in counts.items() if v}
    log(f"jit.save program served at buckets {RN_BUCKETS}: max err over the largest |logit| "
        f"{r['errors']} (limit {RN_SERVE_RTOL}); launches over {len(feeds)} replays "
        f"{r['replay_launches']}")
    if (max(r["errors"].values()) > RN_SERVE_RTOL
            or r["replay_launches"] != {"conv_bn_relu_mm_affine_relu": RN_TRIPLES * len(feeds)}
            or any(got[b].shape != (b, RN_CLASSES) for b in RN_BUCKETS)):
        raise AssertionError(f"jit.save program served: {r}")
    r["forward_ms"] = _static_forward_ms(pred, RN_BUCKETS, "jit.save ResNet-50")
    r["forward_ms_11b_pr23"] = {1: 2.0, 8: 6.05, 32: 19.5}
    return counts, r, feeds, want


def _dy_load_and_replay(paddle, net, dirname, feeds, want):
    """(c) ``jit.load`` and ``to_static`` agree (the store captures once,
    then replays), and a ``to_static`` function that reads the host
    refuses instead of running eagerly."""
    loaded = paddle.jit.load(dirname)
    static_net = paddle.jit.to_static(net)
    b = RN_BUCKETS[1]
    x = paddle.to_tensor(feeds[b])
    by_load = loaded(x).numpy()
    by_static = [static_net(x).numpy() for _ in range(2)]
    store = static_net.forward.store
    r = {"load_vs_eager": _dy_rel(by_load, want[b]),
         "to_static_vs_load": _dy_rel(by_static[1], by_load),
         "to_static_replay_vs_first": _dy_rel(by_static[1], by_static[0]),
         "captures": store.misses, "replays": store.hits}

    @paddle.jit.to_static
    def reads_host(t):
        if paddle.sum(t).item() > 0:  # item() reads the host; an `if` on the tensor would not
            return paddle.scale(t, 2.0)
        return t

    try:
        reads_host(x)
        r["host_read"] = "ran"
    except Exception as e:  # noqa: BLE001 — what matters is that it refused
        r["host_read"] = f"{type(e).__name__}: {str(e)[:120]}"
    log(f"jit.load and to_static at bucket {b}: {r}")
    if (max(r["load_vs_eager"], r["to_static_vs_load"]) > RN_SERVE_RTOL
            or r["captures"] != 1 or r["replays"] < 1 or r["host_read"] == "ran"
            or len(reads_host.store)):
        raise AssertionError(f"jit.load / to_static: {r}")
    return r


def dygraph_resnet():
    """Phase 12m. A Paddle-style ResNet-50 trained in dygraph, saved with
    ``jit.save``, served, loaded and replayed through ``to_static``.
    Returns (kernel launches per name over the phase, readings)."""
    import torch

    import paddle_tpu_torch as paddle

    t_phase = time.perf_counter()
    ref = _resnet50(seed=0).to("cuda")
    net = paddle_style_resnet(paddle)
    missing, unexpected = net.set_state_dict(ref.state_dict())
    if missing or unexpected:
        raise AssertionError(f"set_state_dict: missing {missing}, unexpected {unexpected}")
    train_counts, r = _dy_train(paddle, net, ref)
    del ref
    torch.cuda.empty_cache()
    r = {"training": r}
    with tempfile.TemporaryDirectory(prefix="ptt_jit_save_") as dirname:
        serve_counts, r["serving"], feeds, want = _dy_serve(paddle, net, dirname)
        r["load_replay"] = _dy_load_and_replay(paddle, net, dirname, feeds, want)
    counts = {k: train_counts.get(k, 0) + serve_counts.get(k, 0) for k in train_counts}
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"dygraph front end: phase 12m done in {r['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return counts, r


# -- the monitor on the port's hot paths (phase 12n) ---------------------------------------

MON_BERT_STEPS, MON_RN_STEPS, MON_TIMED_STEPS = 20, 10, 40
# each monitored step's counted FLOPs against its closed form (PERF.md section 5)
CLOSED_FORM_RTOL = 0.05
OPPROF_BUCKET = 8
OPPROF_COVERAGE_MIN = 0.9
WATCHDOG_TIMEOUT_S = 0.5
# a replay's host time may grow by this much with the recorder, tracing
# and the monitor on before the phase says where it goes
OVERHEAD_NOTE_US = 5.0
OVERHEAD_CALLS = 2000


def _bert_closed_form(cfg, batch, seq, n_pred):
    """A BERT pretraining step's FLOPs in closed form: 6 x the encoder's
    matmul parameters x tokens, 12·B·H·L²·D a layer for attention (forward
    and backward, no recomputation), the MLM head (transform and the tied
    decoder) on the n_pred masked positions a row, the pooler and NSP head
    on the first token."""
    hdim, ff, layers, heads = (cfg.hidden_size, cfg.intermediate_size,
                               cfg.num_hidden_layers, cfg.num_attention_heads)
    encoder = layers * (4 * hdim * hdim + 2 * hdim * ff)
    attention = layers * 12 * batch * heads * seq * seq * (hdim // heads)
    head = 6 * (hdim * hdim + hdim * cfg.vocab_size) * batch * n_pred
    pooled = 6 * (hdim * hdim + hdim * 2) * batch
    return 6 * encoder * batch * seq + attention + head + pooled


def _rn50_closed_form(model, batch):
    """3 x the forward's conv and fc FLOPs x batch: each layer's
    ``2·outputs·(in/groups)·kh·kw`` (fc ``2·outputs·in``) read by hooks on
    one unfused image."""
    import torch

    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.nn.layers import Conv2D, Linear

    fwd = []

    def hook(mod, inp, out):
        w = mod.weight  # conv [Cout, Cin/groups, kh, kw]; fc [in, out]
        fwd.append(2 * out.numel() * (int(np.prod(w.shape[1:])) if w.dim() == 4 else w.shape[0]))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2D, Linear))]
    was = model.training
    set_flags({"use_fused_conv_bn": False})
    try:
        with torch.no_grad():
            model.eval()
            model(torch.zeros(1, 3, RN_HW, RN_HW, device="cuda"))
    finally:
        set_flags({"use_fused_conv_bn": True})
        model.train(was)
        for h in handles:
            h.remove()
    return 3 * sum(fwd) * batch


def _monitor_fields(line):
    import re

    m = re.search(r"step_ms=(\S+) .* mfu=(\S+) hbm_bw_util=(\S+) roofline=(\S+)$", line)
    if m is None:
        raise AssertionError(f"the monitor line lacks its utilization fields: {line}")
    return {"step_ms": float(m.group(1)), "mfu": float(m.group(2)),
            "hbm_bw_util": float(m.group(3)), "roofline": m.group(4)}


def _monitored_run(label, step, batch, steps, examples, want_launches, closed_form):
    """``steps`` replays of a captured step inside a TrainingMonitor, the
    loss read as a float in each (what a training loop does; the monitor
    adds no sync). Checks: ``cost/executed_flops`` grew by exactly steps x
    the record's FLOPs, ``mfu`` and ``hbm_bw_util`` in (0, 1], the
    record's FLOPs within CLOSED_FORM_RTOL of the closed form, the launch
    counts those the steps launched before. Returns readings."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    float(step(*batch)["loss"])  # the counted eager first run, then the capture
    (entry,) = step.store.entries().values()
    rec = entry.record
    if rec is None or rec.partial or not rec.flops:
        raise AssertionError(f"{label}: the capture kept no counted cost record: {rec}")
    lines = []
    executed0 = monitor.counter("cost/executed_flops").value
    bytes0 = monitor.counter("cost/executed_bytes").value
    reset_launch_counts()
    mon = monitor.TrainingMonitor(label, interval=steps, log_fn=lines.append)
    losses = []
    for _ in range(steps):
        with mon.step(examples=examples):
            losses.append(float(step(*batch)["loss"]))
    mon.close()
    counts = {k: v for k, v in launch_counts().items() if v}
    executed = monitor.counter("cost/executed_flops").value - executed0
    moved = monitor.counter("cost/executed_bytes").value - bytes0
    if len(lines) != 1:
        raise AssertionError(f"{label}: {len(lines)} monitor lines, want 1: {lines}")
    fields = _monitor_fields(lines[0])
    rel = rec.flops / closed_form - 1.0
    r = {"line": lines[0], **fields, "record_flops": rec.flops,
         "record_bytes": rec.bytes_accessed, "closed_form_flops": closed_form,
         "closed_form_rel": rel, "executed_flops": executed, "executed_bytes": moved,
         "launches": counts, "losses": losses}
    log(f"{label}: {lines[0]}")
    log(f"{label}: a step counts {rec.flops:.6g} FLOPs and {rec.bytes_accessed:.6g} bytes; the "
        f"closed form {closed_form:.6g} ({rel:+.4%}); executed {executed:.6g} FLOPs over {steps} "
        f"replays; launches {counts}")
    if executed != steps * rec.flops:
        raise AssertionError(f"{label}: executed {executed} FLOPs, not {steps} x {rec.flops}")
    if not (0.0 < fields["mfu"] <= 1.0 and 0.0 < fields["hbm_bw_util"] <= 1.0):
        raise AssertionError(f"{label}: mfu {fields['mfu']} or hbm_bw_util "
                             f"{fields['hbm_bw_util']} not in (0, 1]")
    if abs(rel) > CLOSED_FORM_RTOL:
        raise AssertionError(f"{label}: the counted {rec.flops:.6g} FLOPs are {rel:+.2%} off the "
                             f"closed form {closed_form:.6g} (limit {CLOSED_FORM_RTOL:.0%})")
    if counts != {k: v for k, v in want_launches.items() if v}:
        raise AssertionError(f"{label}: launched {counts}, the steps launch {want_launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses not finite: {losses}")
    return r


def _instrumentation_us(rec, cache_key):
    """Host us a call of each piece the instrumentation adds to a replay,
    over OVERHEAD_CALLS calls each inside a trace: the ledger's two counter
    adds (``note_run``), the span annotation, the graph store's cache-hit
    counter, the watchdog's progress clock."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.monitor import cost_model, tracing
    from paddle_tpu_torch.monitor import flight_recorder as fr

    pieces = {
        "note_run": lambda: cost_model.note_run(rec),
        "annotate": lambda: tracing.annotate(cache_key=cache_key, flops=rec.flops,
                                             cost_bytes=rec.bytes_accessed),
        "cache_hit_counter": lambda: profiler.bump_counter("graph::cache_hit"),
        "notify_progress": lambda: fr.notify_progress("train_step"),
    }
    out = {}
    with tracing.start_trace("overhead::probe"):
        for name, fn in pieces.items():
            t0 = time.perf_counter()
            for _ in range(OVERHEAD_CALLS):
                fn()
            out[name] = (time.perf_counter() - t0) / OVERHEAD_CALLS * 1e6
    return out


def _overhead(step, batch):
    """The same captured step with the flight recorder, tracing and a
    TrainingMonitor on and off, in turns (on, off, off, on, ...),
    MON_TIMED_STEPS a side: a step's host clock (the loss read as a float)
    and a replay's host time (the call alone, after a sync), medians; and
    what each piece a replay adds costs a call."""
    import torch

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.flags import set_flags

    out = {"on": {"step_ms": [], "replay_us": []}, "off": {"step_ms": [], "replay_us": []}}
    mon = monitor.TrainingMonitor("overhead", interval=0)
    try:
        for i in range(2 * MON_TIMED_STEPS):
            side = "on" if i % 4 in (0, 3) else "off"
            set_flags({"flight_recorder": side == "on", "trace_enabled": side == "on"})
            ctx = mon.step() if side == "on" else contextlib.nullcontext()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx:
                t1 = time.perf_counter()
                res = step(*batch)
                t2 = time.perf_counter()
                float(res["loss"])
            out[side]["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out[side]["replay_us"].append((t2 - t1) * 1e6)
    finally:
        set_flags({"flight_recorder": True, "trace_enabled": True})
        mon.close()
    (entry,) = step.store.entries().values()
    r = {side: {"step_ms_median": float(np.median(v["step_ms"])),
                "replay_host_us_median": float(np.median(v["replay_us"])),
                "replay_host_us_quartiles": [float(q) for q in
                                             np.percentile(v["replay_us"], [25, 75])]}
         for side, v in out.items()}
    r["replay_host_us_delta"] = (r["on"]["replay_host_us_median"]
                                 - r["off"]["replay_host_us_median"])
    r["pieces_us_a_call"] = _instrumentation_us(entry.record, entry.cache_key)
    log(f"overhead (BERT AMP captured step, {MON_TIMED_STEPS} a side in turns): step "
        f"{r['on']['step_ms_median']:.3f} ms on / {r['off']['step_ms_median']:.3f} ms off; a "
        f"replay's host time {r['on']['replay_host_us_median']:.1f} us on (quartiles "
        f"{r['on']['replay_host_us_quartiles']}) / {r['off']['replay_host_us_median']:.1f} us "
        f"off ({r['off']['replay_host_us_quartiles']}), {r['replay_host_us_delta']:+.1f} us; "
        f"each piece a replay adds, host us a call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in r["pieces_us_a_call"].items()))
    if r["replay_host_us_delta"] > OVERHEAD_NOTE_US:
        log(f"overhead: the replay's host time grew by more than {OVERHEAD_NOTE_US} us: of the "
            "pieces above, the annotation of the step's trace span is the one the switches "
            "turn off; the ledger and the cache counter run either way; the rest is the spread "
            "of the samples (their quartiles)")
    return r


def _opprof_static_resnet():
    """profile_program on phase 11b's static ResNet-50 (its optimized
    program, bucket OPPROF_BUCKET); attribute_trace over a torch.profiler
    trace of an interpreted run of it (coverage >= OPPROF_COVERAGE_MIN);
    measure_pass_deltas at IR level 1 against level 0."""
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.analysis import measure_pass_deltas
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.monitor import opprof

    model = _resnet50(seed=0)
    with tempfile.TemporaryDirectory(prefix="ptt_rn_opprof_") as dirname:
        _save_static_resnet(dirname, model)
        pred = create_predictor(Config(dirname))
    del model
    fetch = pred.get_output_names()[0]
    x = _images(np.random.RandomState(41), OPPROF_BUCKET).astype(np.float32)
    feed = {"image": x}
    pred.run([x])  # the served run: gates, first run, capture
    exe, scope, dev = pred._exe, pred._scope, pred.device
    prog = exe.gate(pred._program, ["image"], [fetch], {"image": x.shape})[0]
    prof = opprof.profile_program(prog, feed, [fetch], scope=scope, name="resnet50_static_b8",
                                  device=dev)
    top = opprof.top_ops(8)
    image = torch.from_numpy(x).to(dev)  # the feed's upload is no op's work
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="ptt_opprof_trace_") as tdir:
        profiler.start_profiler(trace_dir=tdir)
        try:
            with torch.no_grad():
                exe._interpret(prog.global_block(), {"image": image}, scope, [fetch])
            torch.cuda.synchronize()
        finally:
            profiler.stop_profiler()
        att = opprof.attribute_trace(tdir)
    deltas = measure_pass_deltas(pred._program, feed, [fetch], level=1, scope=scope, device=dev,
                                 warmup=1, repeats=2)
    r = {"total_us": prof["total_us"], "replayed_ops": prof["replayed_ops"],
         "n_ops": prof["n_ops"], "time_accuracy": prof["time_accuracy"],
         "replay_coverage": prof["coverage"], "top_ops": top,
         "interpreted_coverage": att["coverage"], "interpreted_total_us": att["total_us"],
         "pass_deltas": {k: deltas[k] for k in ("before_us", "after_us", "speedup")},
         "deltas_by_type": deltas["deltas"]}
    log(f"opprof static ResNet-50 bucket {OPPROF_BUCKET}: {prof['replayed_ops']}/"
        f"{prof['n_ops']} ops replayed, {prof['total_us']:.1f} us in all, time accuracy "
        f"{prof['time_accuracy']}; top ops " + "; ".join(
            f"{t['scope']} {t['time_us']:.1f} us ({t['share']:.1%}, mfu {t['mfu']:.4f}, "
            f"{t['roofline']})" for t in top))
    log(f"opprof: an interpreted run's trace attributes {att['coverage']} of "
        f"{att['total_us']:.1f} us of kernel time to its ops; measure_pass_deltas level 1 vs 0: "
        f"{deltas['before_us']:.1f} -> {deltas['after_us']:.1f} us (speedup "
        f"{deltas['speedup']}); by type " + ", ".join(
            f"{k} {v['before_us']:.0f}->{v['after_us']:.0f}" for k, v in deltas["deltas"].items()))
    if prof["replayed_ops"] == 0 or not prof["total_us"] > 0:
        raise AssertionError(f"opprof replayed nothing: {prof['ops'][:3]}")
    if att["coverage"] is None or att["coverage"] < OPPROF_COVERAGE_MIN:
        raise AssertionError(f"attribute_trace coverage {att['coverage']} of an interpreted run "
                             f"is below {OPPROF_COVERAGE_MIN}")
    del pred
    return r


def _flight_checks():
    """A NaN fed into a captured step under check_nan_inf_action=dump
    writes a dump (which tools/debug_dump.py reads, holding the capture's
    events), then raises; a step stalled past the watchdog's deadline
    trips it, and it dumps."""
    import importlib.util
    import io
    import os

    import torch

    from paddle_tpu_torch.errors import FatalError
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.monitor import flight_recorder as fr
    from paddle_tpu_torch.optimizer import Momentum

    spec = importlib.util.spec_from_file_location(
        "debug_dump", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                   "debug_dump.py"))
    debug_dump = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(debug_dump)
    r = {}
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.ReLU(), torch.nn.Linear(64, 8))
    step = train_step(model, Momentum(learning_rate=0.01, parameters=model.parameters()),
                      lambda m, x, t: ((m(x) - t) ** 2).mean())
    x = torch.randn(16, 64, device="cuda")
    t = torch.randn(16, 8, device="cuda")
    bad = x.clone()
    bad[3, 5] = float("nan")
    with tempfile.TemporaryDirectory(prefix="ptt_flight_") as d:
        set_flags({"check_nan_inf": True, "check_nan_inf_action": "dump",
                   "flight_recorder_dump_dir": d})
        try:
            step(x, t)  # the checked variant's first run and capture
            step(x, t)  # a replay
            try:
                step(bad, t)
            except FatalError as e:
                r["raised"] = str(e)[:200]
            else:
                raise AssertionError("a NaN in a captured checked step did not raise")
        finally:
            set_flags({"check_nan_inf": False, "check_nan_inf_action": "raise"})
        (dump,) = [os.path.join(d, f) for f in os.listdir(d) if "check_nan_inf" in f]
        with open(dump) as f:
            snap = json.load(f)
        kinds = [e["kind"] for e in snap["events"]]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            debug_dump.main([dump])
        if "runtime_compile" not in kinds or kinds[-1] != "nan_inf" \
                or "check_nan_inf" not in text.getvalue():
            raise AssertionError(f"the NaN dump lacks the capture or the NaN event: {kinds[-8:]}")
        r["nan_dump_events"] = len(kinds)
        log(f"flight recorder: a NaN in a captured step raised ({r['raised'][:80]}...) after "
            f"dumping {len(kinds)} events (runtime_compile among them); debug_dump read it")
        set_flags({"watchdog_timeout_s": WATCHDOG_TIMEOUT_S})
        try:
            wd = fr.start_watchdog()
            step(x, t)
            stall_t0 = time.perf_counter()
            # the stalled "step": no progress; a trip counts, then dumps
            while wd.last_dump is None and time.perf_counter() - stall_t0 < 20 * WATCHDOG_TIMEOUT_S:
                time.sleep(0.05)
            trips, last = wd.trips, wd.last_dump
        finally:
            fr.stop_watchdog()
            set_flags({"watchdog_timeout_s": 0.0, "flight_recorder_dump_dir": ""})
        if trips < 1 or last is None:
            raise AssertionError("a step stalled past the watchdog's deadline did not trip it")
        with open(last) as f:
            wsnap = json.load(f)
        if not any(e["kind"] == "watchdog_trip" for e in wsnap["events"]) or not wsnap["threads"]:
            raise AssertionError("the watchdog's dump lacks its trip or the thread stacks")
        r["watchdog_trips"] = trips
        r["watchdog_reason"] = wsnap["reason"]
        log(f"flight recorder: a stall tripped the watchdog ({wsnap['reason']}), which dumped "
            f"{len(wsnap['events'])} events and {len(wsnap['threads'])} thread stacks")
    return r


def _traced_predict():
    """One /predict with a traceparent to an int8 predict server: /tracez
    holds the request's spans under that trace id; /costz, /goodputz,
    /profilez and /sloz answer."""
    from urllib.request import Request, urlopen

    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.monitor import tracing
    from paddle_tpu_torch.serving import InferenceServer

    rng = np.random.RandomState(43)
    reqs = [{"x": np.round(rng.randn(8, Q_HIDDEN), 3)}]
    with tempfile.TemporaryDirectory(prefix="ptt_int8_traced_") as dirname:
        _make_int8_model(dirname, reqs)
        pred = create_predictor(Config(dirname))
    srv = InferenceServer(pred, port=0, buckets=(8,)).start()
    set_flags({"trace_sample_slowest_k": 1000})  # keep every trace of this check
    try:
        client = tracing.SpanContext(tracing.new_trace_id(), tracing.new_span_id())
        body = json.dumps({"inputs": {"x": reqs[0]["x"].tolist()}}).encode()
        resp = urlopen(Request(srv.url + "/predict", data=body, headers={
            "Content-Type": "application/json",
            tracing.TRACEPARENT_HEADER: tracing.format_traceparent(client)}), timeout=120)
        if resp.status != 200:
            raise AssertionError(f"/predict answered {resp.status}")
        # the handler closes the request's trace just after it answers
        deadline = time.perf_counter() + 5.0
        while True:
            try:
                one = json.loads(urlopen(f"{srv.url}/tracez?id={client.trace_id}",
                                         timeout=60).read())
                break
            except urllib.error.HTTPError as e:
                if e.code != 404 or time.perf_counter() > deadline:
                    raise
                time.sleep(0.05)
        spans = {s["name"]: s for s in one["spans"]}
        want = {"serving::predict", "serving::queue_wait", "serving::assemble",
                "serving::dispatch"}
        if not want <= set(spans) or spans["serving::predict"]["parent_id"] != client.span_id:
            raise AssertionError(f"/tracez holds {sorted(spans)} for the request's trace")
        routes = {}
        for route in ("/costz", "/goodputz", "/profilez", "/sloz"):
            routes[route] = urlopen(srv.url + route, timeout=60).status
        if set(routes.values()) != {200}:
            raise AssertionError(f"the monitor's routes answered {routes}")
        costz = json.loads(urlopen(srv.url + "/costz", timeout=60).read())
    finally:
        set_flags({"trace_sample_slowest_k": 5})
        srv.stop()
    dispatch = spans["serving::dispatch"]["attrs"]
    log(f"tracing: /predict under traceparent {client.trace_id[:8]}...: /tracez holds "
        f"{sorted(spans)}; the dispatch span carries {sorted(dispatch)}; {routes}; /costz holds "
        f"{len(costz['records'])} records on {costz['device_peaks']['kind']}")
    return {"spans": sorted(spans), "dispatch_attrs": dispatch, "routes": routes,
            "costz_records": len(costz["records"]), "peaks": costz["device_peaks"]}


def monitored_steps():
    """Phase 12n. The port's monitor on the captured AMP steps: 20 BERT-base
    steps (32 x 512, AdamW) and 10 ResNet-50 steps (batch 128, Momentum,
    the pool kernel on) inside a TrainingMonitor, their counted FLOPs held
    to the closed forms; the instrumentation's cost on a replay; opprof on
    the static ResNet-50; the NaN dump and the watchdog; a traced /predict.
    Returns (kernel launches per name over the monitored steps, readings)."""
    import torch

    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.monitor import cost_model

    t_phase = time.perf_counter()
    peaks = cost_model.device_peaks()
    log(f"monitor: the card's peak sheet {peaks}")
    r = {"peaks": peaks}
    cfg = bert_base_config()
    cfg.use_flash_attention = True
    model, loss_fn = _pretraining(cfg, seed=1)
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    step = _step_of(model, _amp_loss_fn(loss_fn, "O1"), jit=True)
    r["bert_amp"] = _monitored_run(
        "bert_amp", step, batch, MON_BERT_STEPS, TRAIN_B,
        _amp_launches("O1", cfg.num_hidden_layers, MON_BERT_STEPS),
        _bert_closed_form(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED))
    counts = dict(r["bert_amp"]["launches"])
    r["overhead"] = _overhead(step, batch)
    del model, step, batch
    torch.cuda.empty_cache()

    rng = np.random.RandomState(15)
    batch = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
             torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
    model = _resnet50(seed=1)
    closed = _rn50_closed_form(model.cuda(), RN_B)
    set_flags({"use_pallas_pool_bwd": True})
    try:
        step = _rn_step_of(model, loss_fn=_rn_amp_loss, jit=True)
        r["resnet_amp"] = _monitored_run("resnet_amp", step, batch, MON_RN_STEPS, RN_B,
                                         _rn_amp_step_launches(MON_RN_STEPS), closed)
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    for k, v in r["resnet_amp"]["launches"].items():
        counts[k] = counts.get(k, 0) + v
    del model, step, batch
    torch.cuda.empty_cache()

    r["parts_s"] = {"steps": time.perf_counter() - t_phase}
    for name, fn in (("opprof", _opprof_static_resnet), ("flight_recorder", _flight_checks),
                     ("tracing", _traced_predict)):
        t0 = time.perf_counter()
        r[name] = fn()
        torch.cuda.empty_cache()
        r["parts_s"][name] = time.perf_counter() - t0
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"monitor: the phase's parts (s) {r['parts_s']}")
    log(f"monitor: phase 12n done in {r['phase_s']:.1f} s")
    return counts, r



# -- dygraph-to-static: value-dependent control flow under to_static (phase 12o) -------------

TS_BUCKETS = (1, 8)  # the BERT-base sentence encoder's serving buckets
TS_ATOL = 1e-4  # BERT serving's limit, against the same layer run eagerly
TS_TIMED = 10  # replays a bucket and batch kind timed


def paddle_sentence_encoder(paddle, bert, pad_id=0):
    """A Paddle user's sentence-embedding head over ``bert`` (a ``BertModel``
    of either package), written with ``paddle``'s public names: the mean of
    the non-pad tokens' rows when any token of the batch is a pad, else the
    first token's row; both ``[B, hidden]``. The ``if`` reads the data, so
    under ``jit.to_static`` it goes through the AST pass."""

    class SentenceEncoder(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, input_ids):
            seq, _ = self.bert(input_ids)
            if paddle.any(input_ids == pad_id):
                keep = paddle.unsqueeze(paddle.cast(input_ids != pad_id, "float32"), -1)
                out = paddle.sum(seq * keep, axis=1) / paddle.sum(keep, axis=1)
            else:
                out = seq[:, 0]
            return out

    return SentenceEncoder()


def paddle_greedy_decode(paddle, model, max_len):
    """A Paddle user's greedy decoding of ``model`` (a ``TransformerSeq2Seq``
    of either package) as a ``to_static`` function ``decode(src, eos_id) ->
    (tokens [B, max_len], columns filled)``: the logits of a fixed ``[B,
    max_len]`` buffer (fixed, so that the loop's carries keep their shapes,
    as ``lax.while_loop`` needs), column ``t + 1`` written with
    ``paddle.where``, and a ``break`` once every row has emitted
    ``eos_id``."""

    @paddle.jit.to_static
    def decode(src, eos_id):
        memory = model.encode(src)
        mask = model._pad_mask(src)
        buf = paddle.full([src.shape[0], max_len], model.bos_id, "int64")
        cols = paddle.unsqueeze(paddle.arange(max_len, dtype="int64"), 0)
        finished = paddle.zeros([src.shape[0]], "bool")
        for t in range(max_len - 1):
            logits = model.decode_logits(memory, mask, buf)
            nxt = paddle.argmax(logits[:, t], axis=-1)
            buf = paddle.where(cols == t + 1, paddle.unsqueeze(nxt, 1), buf)
            finished = paddle.logical_or(finished, nxt == eos_id)
            if paddle.all(finished):
                break
        return buf, t + 2

    return decode


def eos_rows(tokens, last):
    """``(token, rows, column)`` for a decode that must stop on EOS: of the
    tokens ``[B, T]`` holds in columns 1 to ``last``, the one the most rows
    emit there (ties: the one those rows have all emitted soonest), those
    rows, and the column by which every one of them has emitted it. A batch
    of those rows' sources, decoded with that token as EOS, stops there."""
    tokens = np.asarray(tokens)[:, 1:last + 1]
    best = (None, np.zeros(0, np.int64), last + 1)
    for v in np.unique(tokens):
        hit = tokens == v
        rows = np.nonzero(hit.any(axis=1))[0]
        col = int(hit[rows].argmax(axis=1).max()) + 1
        if (len(rows), -col) > (len(best[1]), -best[2]):
            best = (int(v), rows, col)
    return best


def _ts_ids(bucket, rng, padded, vocab, pad_id=0):
    """Token ids ``[bucket, SEQ_LEN]``; padded: each row ends in pads from a
    seeded place in its second half (at least one pad a row)."""
    ids = rng.randint(1, vocab, (bucket, SEQ_LEN)).astype(np.int64)
    if padded:
        for r in range(bucket):
            ids[r, rng.randint(SEQ_LEN // 2, SEQ_LEN):] = pad_id
    return ids


def _ts_wall_ms(fn, runs):
    """Mean host ms of ``fn()`` over ``runs`` calls, each ended by a
    synchronize (one warm call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / runs


def _ts_sentence_encoder():
    """Phase 12o (a): BERT-base (flash on, L = 512, f32) under the
    sentence-embedding head whose forward branches on the data, served
    through ``paddle.jit.to_static`` at buckets 1 and 8: a padded, an
    unpadded and a padded batch a bucket, each against the same layer run
    eagerly (its ``if`` read on the host) within ``TS_ATOL``; one capture a
    bucket (``misses == 2``, ``uncaptured == 0``) and 24 LayerNorm + 12
    flash forward launches a forward. Returns (launches, readings)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import BertModel, bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    bert = BertModel(cfg, generator=torch.Generator("cuda").manual_seed(0), device="cuda").eval()
    eager = paddle_sentence_encoder(paddle, bert)
    static = paddle.jit.to_static(paddle_sentence_encoder(paddle, bert))
    rng = np.random.RandomState(26)
    batches = [(b, kind, paddle.to_tensor(_ts_ids(b, rng, kind != "unpadded", cfg.vocab_size)))
               for b in TS_BUCKETS for kind in ("padded", "unpadded", "padded again")]
    with torch.no_grad():
        wants = [eager(ids) for _, _, ids in batches]
        firsts = [bert(ids)[0][:, 0] for _, _, ids in batches]
    torch.cuda.synchronize()
    reset_launch_counts()
    gots = [static(ids) for _, _, ids in batches]
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    store = static.forward.store
    r = {"checked": [], "misses": store.misses, "hits": store.hits,
         "uncaptured": store.uncaptured, "launches": counts}
    for (b, kind, _), got, want, first in zip(batches, gots, wants, firsts):
        err = float((got - want).abs().max())
        took_first = bool(torch.allclose(got, first, rtol=0, atol=TS_ATOL))
        r["checked"].append({"bucket": b, "batch": kind, "max_abs_err": err,
                             "first_token_branch": took_first})
        if tuple(got.shape) != (b, cfg.hidden_size) or not err <= TS_ATOL \
                or took_first != (kind == "unpadded"):
            raise AssertionError(f"to_static sentence encoder, bucket {b}, {kind} batch: shape "
                                 f"{tuple(got.shape)}, max |err| {err} against the eager layer "
                                 f"(limit {TS_ATOL}), first-token branch {took_first}")
    forwards = len(batches)
    want_counts = {"layernorm_residual_fwd": 2 * cfg.num_hidden_layers * forwards,
                   "flash_attention_fwd": cfg.num_hidden_layers * forwards}
    if counts != want_counts or (store.misses, store.uncaptured) != (len(TS_BUCKETS), 0):
        raise AssertionError(f"to_static sentence encoder: launches {counts} (want "
                             f"{want_counts}), misses {store.misses}, uncaptured "
                             f"{store.uncaptured}")
    timing = {}
    for b, kind, ids in batches:
        if kind == "padded again":
            continue
        with torch.no_grad():
            eager_ms = _ts_wall_ms(lambda: eager(ids), TS_TIMED)
        captured_ms = _ts_wall_ms(lambda: static(ids), TS_TIMED)
        timing[f"bucket {b} {kind}"] = {"captured_ms": captured_ms, "eager_ms": eager_ms}
    r["timing"] = timing
    log(f"to_static (a) BERT-base sentence encoder: {r}")
    return counts, r


def _ts_greedy_decode():
    """Phase 12o (b): Transformer-base (the seq2seq configuration of phase
    12d, f32 eval) decoded greedily by ``paddle_greedy_decode``, a
    ``to_static`` function whose loop reads the host: run twice on a batch
    of 64 sources of 64 tokens to ``max_len`` 64. The first run's EOS is the
    model's; the second's is the token the most rows of the first run emit
    by column ``max_len // 2`` (``eos_rows``), on a batch of those rows'
    sources (tiled to 64 rows; with seed weights no token is in every row),
    so that every row emits it and the ``break`` fires by that column. Each run's tokens
    must equal ``greedy_decode(..., stop_at_eos=True)``'s column by column;
    both runs are uncaptured and counted; 12 LayerNorm launches for the
    encoder and 18 a step. Returns (launches, readings)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _seq2seq(seed=2, dropout=0.0, device="cuda").eval()
    src = paddle.to_tensor(s2s_batch(S2S_B, np.random.RandomState(27))[0])
    decode = paddle_greedy_decode(paddle, model, S2S_TGT)
    eos = model.eos_id
    runs, counts = [], {}
    for run in range(2):
        eos_t = paddle.to_tensor(np.asarray(eos, np.int64))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        buf, n = decode(src, eos_t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in launch_counts().items() if v}
        counts = {k: counts.get(k, 0) + v for k, v in got.items()}
        n = int(n)
        steps = n - 1
        model.eos_id = eos
        t0 = time.perf_counter()
        ys = model.greedy_decode(src, max_len=S2S_TGT, stop_at_eos=True)
        torch.cuda.synchronize()
        greedy_ms = (time.perf_counter() - t0) * 1e3
        tokens = buf.cpu().numpy()
        ref = ys.cpu().numpy()
        equal = ref.shape[1] == n and np.array_equal(tokens[:, :n], ref)
        first_diff = None if equal else int(np.argmax((tokens[:, :ref.shape[1]] != ref).any(0)))
        want = {"layernorm_residual_fwd": S2S_ENC_NORMS + S2S_DEC_NORMS * steps}
        runs.append({"eos": eos, "distinct_sources": len(np.unique(src.cpu().numpy(), axis=0)),
                     "columns": n, "steps": steps, "ms": ms, "ms_per_step": ms / steps,
                     "greedy_decode_ms": greedy_ms, "greedy_ms_per_step": greedy_ms / steps,
                     "tokens_equal_greedy_decode": equal, "first_differing_column": first_diff,
                     "launches": got})
        log(f"to_static (b) greedy decode run {run + 1}: {runs[-1]}")
        if not equal or got != want:
            raise AssertionError(f"to_static greedy decode run {run + 1}: tokens equal to "
                                 f"greedy_decode: {equal} (first differing column "
                                 f"{first_diff}, columns {n} vs {ref.shape[1]}); launches {got}, "
                                 f"want {want}")
        if run == 0:
            eos, rows, col = eos_rows(tokens[:, :n], S2S_TGT // 2)
            log(f"to_static (b): EOS {eos} for the second run, emitted by {len(rows)} of "
                f"{S2S_B} rows by column {col}")
            src = src[torch.from_numpy(np.resize(rows, S2S_B)).to(src.device)]
    store = decode.store
    r = {"runs": runs, "misses": store.misses, "uncaptured": store.uncaptured,
         "launches": counts}
    if not runs[1]["columns"] <= S2S_TGT // 2 + 1 \
            or (store.misses, store.uncaptured, len(store)) != (1, 2, 0):
        raise AssertionError(f"to_static greedy decode: the break did not fire before max_len, "
                             f"or the runs were captured: {r}")
    return counts, r


def _ts_early_return():
    """Phase 12o (c): a ``to_static`` function with an early ``return`` on
    the data, whose rewrite selects Python flags and values on the device:
    one graph, replayed for inputs of both signs, each answer equal to the
    same function run eagerly (its ``if`` read on the host)."""
    import torch

    import paddle_tpu_torch as paddle

    def scaled(t):
        if paddle.sum(t) > 0:
            return paddle.scale(t, 2.0)
        u = t - 1.0
        return u * u

    static = paddle.jit.to_static(scaled)
    x = paddle.to_tensor(np.random.RandomState(28).randn(8, 768).astype(np.float32))
    xs = [x, -x, x, -x]
    gots = [static(v) for v in xs]
    wants = [scaled(v) for v in xs]
    errs = [float((g - w).abs().max()) for g, w in zip(gots, wants)]
    store = static.store
    r = {"max_abs_err": max(errs), "misses": store.misses, "hits": store.hits,
         "uncaptured": store.uncaptured}
    log(f"to_static (c) early return: {r}")
    if max(errs) != 0.0 or (store.misses, store.hits, store.uncaptured) != (1, 3, 0):
        raise AssertionError(f"to_static early return: {r}")
    torch.cuda.synchronize()
    return r


def to_static_paths():
    """Phase 12o: value-dependent control flow under ``paddle.jit.to_static``
    on the card, (a) an ``if`` served as one CUDA graph a bucket, (b) a
    loop with a ``break`` run uncaptured, (c) an early ``return`` captured.
    Returns (kernel launches per name over (a) and (b), readings)."""
    import torch

    t_phase = time.perf_counter()
    counts_a, r_a = _ts_sentence_encoder()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    counts_b, r_b = _ts_greedy_decode()
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    r_c = _ts_early_return()
    counts = {k: counts_a.get(k, 0) + counts_b.get(k, 0) for k in set(counts_a) | set(counts_b)}
    r = {"sentence_encoder_if": r_a, "greedy_decode_break": r_b, "early_return": r_c,
         "parts_s": {"a": t_b - t_phase, "b": t_c - t_b, "c": time.perf_counter() - t_c},
         "phase_s": time.perf_counter() - t_phase}
    log(f"to_static: phase 12o done in {r['phase_s']:.1f} s ({r['parts_s']})")
    return counts, r


# -- the rest of the op registry (12p): the sequence, detection, compat, niche and --------
# -- fake-quant families on the card, the book's sentiment conv net, a YOLOv3 head ---------

TAIL_DEVICE = "cuda"  # "cpu" rehearses the phase off the card
TAIL_RTOL = 1e-5  # a float output of the sweep, of its largest magnitude (at least 1)
TAIL_OP_TYPES = 124  # the op types the five families added to the port's registry
SENT_VOCAB = 5147  # words in Paddle's IMDB dictionary (paddle.dataset.imdb.word_dict())
SENT_EMB, SENT_HID, SENT_B, SENT_T, SENT_MIN_LEN = 128, 512, 128, 400, 100
SENT_LR = 0.002  # the book's learning rate, under static Adam (the book's Adagrad is not ported)
SENT_STEPS = 20  # steps through the executor, the first captured and 19 replayed
SENT_PARITY_STEPS = 3  # of them, held against the CPU interpreter from the same weights
SENT_EAGER_STEPS = 3  # the step interpreted on the card, timed
SENT_LOSS_RTOL = 1e-5
SENT_SEED = 27
YOLO_ANCHORS = (10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156, 198, 373, 326)
YOLO_MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))  # of the strides 32, 16, 8
YOLO_CLASSES, YOLO_GT_SLOTS = 80, 50
YOLO_LOSS_IN, YOLO_LOSS_B = 608, 8
YOLO_POST_IN, YOLO_CONF, YOLO_NMS, YOLO_KEEP = 416, 0.01, 0.45, 100
YOLO_OBJ_SHIFT, YOLO_CLS_SHIFT = -8.0, -3.0  # the logits' means: ~1,000 (box, class) pairs pass
YOLO_TIMED = 5
YOLO_GRAD_RTOL = 1e-5  # of the gradient's largest entry


def sentiment_conv_net(static, ops, nets, vocab, emb, hid, seq_len, batch, lr=SENT_LR):
    """The Paddle book's sentiment ``convolution_net`` (chapter 6,
    understand_sentiment) as a static program over padded tokens and their
    lengths: embedding, two ``sequence_conv_pool`` (filter sizes 3 and 4,
    ``tanh``, ``sqrt`` pooling), a softmax ``fc`` of 2, cross entropy,
    trained by static Adam. Returns ``(avg_cost, prediction)``; both
    packages build it alike."""
    words = static.data("words", [batch, seq_len], "int64")
    lengths = static.data("lengths", [batch], "int64")
    label = static.data("label", [batch, 1], "int64")
    x = static.nn.embedding(words, [vocab, emb])
    c3 = nets.sequence_conv_pool(x, lengths, hid, 3, act="tanh", pool_type="sqrt")
    c4 = nets.sequence_conv_pool(x, lengths, hid, 4, act="tanh", pool_type="sqrt")
    pred = static.nn.fc(ops.concat([c3, c4], axis=1), 2, activation="softmax")
    cost = ops.mean(ops.cross_entropy(pred, label, use_softmax=False, reduction="none"))
    static.optimizer.Adam(learning_rate=lr).minimize(cost)
    return cost, pred


def sentiment_batches(n, vocab, seq_len, batch, lo, seed=SENT_SEED):
    """``n`` batches of a seeded token stream (the repository holds no IMDB
    text): lengths drawn per row in ``[lo, seq_len]``, tokens past a row's
    length 0, labels 0 or 1, as numpy."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = rs.randint(lo, seq_len + 1, batch).astype(np.int64)
        words = rs.randint(1, vocab, (batch, seq_len)).astype(np.int64)
        words[np.arange(seq_len)[None, :] >= lens[:, None]] = 0
        out.append({"words": words, "lengths": lens,
                    "label": rs.randint(0, 2, (batch, 1)).astype(np.int64)})
    return out


def yolo_post_process(static, ops, classes, input_size, keep_top_k=YOLO_KEEP,
                      conf_thresh=YOLO_CONF, nms_threshold=YOLO_NMS):
    """YOLOv3's inference head as a static program: ``yolo_box`` at the
    three scales, then ``multiclass_nms`` over the concatenated boxes.
    Returns ``(rows [keep_top_k, 6], num, boxes [M, 4], scores [C, M])``."""
    img = static.data("img_size", [1, 2], "int32")
    all_boxes, all_scores = [], []
    for k, (stride, mask) in enumerate(zip((32, 16, 8), YOLO_MASKS)):
        g = input_size // stride
        x = static.data(f"head{k}", [1, 3 * (5 + classes), g, g], "float32")
        anchors = [v for m in mask for v in YOLO_ANCHORS[2 * m:2 * m + 2]]
        b, sc = ops.yolo_box(x, img, anchors, classes, conf_thresh=conf_thresh,
                             downsample_ratio=stride)
        all_boxes.append(b)
        all_scores.append(sc)
    boxes = ops.reshape(ops.concat(all_boxes, axis=1), [-1, 4])
    scores = ops.transpose(ops.reshape(ops.concat(all_scores, axis=1), [-1, classes]), [1, 0])
    rows, num = ops.multiclass_nms(boxes, scores, score_threshold=conf_thresh,
                                   nms_threshold=nms_threshold, keep_top_k=keep_top_k)
    return rows, num, boxes, scores


def yolo_heads(classes, input_size, seed=0, obj_shift=YOLO_OBJ_SHIFT, cls_shift=YOLO_CLS_SHIFT):
    """Seeded head logits of the three scales, the objectness and class
    logits moved by ``obj_shift`` and ``cls_shift`` (which set how many
    boxes pass the threshold)."""
    rs = np.random.RandomState(seed)
    feed = {"img_size": np.array([[input_size, input_size]], np.int32)}
    for k, stride in enumerate((32, 16, 8)):
        g = input_size // stride
        x = rs.randn(1, 3, 5 + classes, g, g).astype(np.float32) * 2.0
        x[:, :, 4] += obj_shift
        x[:, :, 5:] += cls_shift
        feed[f"head{k}"] = x.reshape(1, 3 * (5 + classes), g, g)
    return feed


def _iou_np(a, b):
    """IoU of box ``a [4]`` with boxes ``b [K, 4]`` in the detection ops'
    float32 expressions and order."""
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:], b[:, 2:])
    wh = np.clip(rb - lt, np.float32(0), None)
    inter = wh[:, 0] * wh[:, 1]

    def area(v):
        return (np.clip(v[..., 2] - v[..., 0], np.float32(0), None)
                * np.clip(v[..., 3] - v[..., 1], np.float32(0), None))

    union = area(a) + area(b) - inter
    return np.where(union > 0, inter / np.maximum(union, np.float32(1e-10)), np.float32(0))


def greedy_rows(bboxes, scores, score_threshold, nms_threshold, keep_top_k, background=-1):
    """Serial greedy NMS on the host, one box a step: every class's
    survivors as rows ``(class, score, box)`` by score (stable: class, then
    rank, on ties), the first ``keep_top_k``, padded with -1. Returns
    ``(rows, count)``."""
    rows = []
    for cls in range(scores.shape[0]):
        if cls == background:
            continue
        s = scores[cls]
        kept = []
        for i in np.argsort(-s, kind="stable"):
            if s[i] < score_threshold:
                break
            if not kept or not (_iou_np(bboxes[i], bboxes[kept]) > nms_threshold).any():
                kept.append(i)
        rows += [(cls, s[i], *bboxes[i]) for i in kept]
    rows.sort(key=lambda r: -r[1])
    out = np.full((keep_top_k, 6), -1.0, np.float32)
    got = np.asarray(rows[:keep_top_k], np.float32).reshape(-1, 6)
    out[:len(got)] = got
    return out, len(got)


def _tail_cases():
    """The parity cases of ``tests/_torch_tail_cases.py`` (numpy only)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "_torch_tail_cases.py")
    spec = importlib.util.spec_from_file_location("_torch_tail_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tail_run(kernel, case, device, seed=0):
    """``case`` through the port's registry kernel on ``device``: its
    outputs as numpy."""
    import torch

    def conv(a):
        return torch.from_numpy(np.array(a)).to(device)

    def to(a):
        return None if a is None else [conv(v) for v in a] if isinstance(a, list) else conv(a)

    attrs = {k: conv(v) if isinstance(v, np.ndarray) else v for k, v in case.attrs.items()}
    if case.kind == "random":
        attrs["generator"] = torch.Generator(device).manual_seed(seed)
    out = kernel(case.op)(*[to(a) for a in case.inputs], **attrs, **case.port_attrs)
    return [o.detach().cpu().numpy() for o in (out if isinstance(out, (tuple, list)) else [out])]


def _random_invariants(case, out):
    """The held parts of a drawing op's outputs on the card."""
    if case.op == "shuffle_batch":
        x = case.inputs[0]
        rows, perm = out
        return sorted(perm.tolist()) == list(range(len(x))) and np.array_equal(rows, x[perm])
    logits, labels = case.inputs
    samples, probs, sampled, slabels = out
    t, c = labels.shape[1], logits.shape[1]
    picked = np.take_along_axis(logits, samples, 1) - np.log(np.float32(1.0 / c))
    hit = np.concatenate([np.zeros_like(labels, bool),
                          (samples[:, None, t:] == labels[:, :, None]).any(1)], 1)
    return (np.array_equal(samples[:, :t], labels) and ((samples >= 0) & (samples < c)).all()
            and np.allclose(probs, 1.0 / c) and np.allclose(sampled[~hit], picked[~hit],
                                                             rtol=TAIL_RTOL)
            and (sampled[hit] < -1e19).all() and np.array_equal(slabels, np.tile(
                np.arange(t), (len(labels), 1))))


def _tail_sweep():
    """(a) Every case of the five families once on the card, held against
    the same op on the CPU: integers exactly, floats within ``TAIL_RTOL``
    of the output's largest magnitude (at least 1); a drawing op by its
    invariants. Returns the readings by family."""
    from paddle_tpu_torch.ops.registry import kernel

    tc = _tail_cases()
    families = {"sequence": tc.SEQUENCE, "detection": tc.DETECTION, "compat": tc.COMPAT,
                "niche": tc.NICHE, "fake_quant": tc.QUANT}
    out, ran, bad = {}, set(), []
    # the print op writes to stdout, whose last lines are this script's result
    with contextlib.redirect_stdout(sys.stderr):
        for fam, cases in families.items():
            worst, worst_case = 0.0, None
            for c in cases:
                card = _tail_run(kernel, c, TAIL_DEVICE)
                if c.kind == "random":
                    if not _random_invariants(c, card):
                        bad.append(c.id)
                    ran.add(c.op)
                    continue
                cpu = _tail_run(kernel, c, "cpu")
                for g, w in zip(card, cpu):
                    if g.shape != w.shape or g.dtype != w.dtype:
                        bad.append(f"{c.id}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
                    elif w.dtype.kind in "biu":
                        if not np.array_equal(g, w):
                            bad.append(f"{c.id}: integers differ")
                    elif w.size:
                        same = g == w  # an empty segment's max is -inf on both
                        with np.errstate(invalid="ignore"):
                            diff = np.where(same, 0.0, np.abs(g.astype(np.float64) - w))
                        err = float(diff.max() / max(1.0, float(np.abs(np.where(same, 0.0,
                                                                                w)).max())))
                        if not err <= TAIL_RTOL:
                            bad.append(f"{c.id}: {err:.3g}")
                        if err >= worst:
                            worst, worst_case = err, c.id
                ran.add(c.op)
            out[fam] = {"cases": len(cases), "op_types": len({c.op for c in cases}),
                        "max_err": worst, "worst_case": worst_case}
            log(f"ops tail sweep {fam}: {len(cases)} cases of {out[fam]['op_types']} op types on "
                f"the card against the CPU, largest float error {worst:.3g} ({worst_case}), "
                f"integers exact")
    out["op_types_ran"] = len(ran)
    if bad or len(ran) != TAIL_OP_TYPES:
        raise AssertionError(f"ops tail sweep: {len(ran)} op types ran (want {TAIL_OP_TYPES}); "
                             f"failed {bad}")
    return out


def _program_of(build):
    """``(main, startup, outputs)`` of ``build()`` in static mode."""
    from paddle_tpu_torch import static

    main, startup = static.Program(), static.Program()
    static.enable_static()
    try:
        with static.program_guard(main, startup):
            outs = build()
    finally:
        static.disable_static()
    return main, startup, outs


def train_sentiment_static():
    """(b) The book's sentiment conv net trained on the card as a static
    program: three steps held against the CPU interpreter, then the rest
    of ``SENT_STEPS`` replayed from the executor's graph; ms a step
    captured and interpreted."""
    import torch

    from paddle_tpu_torch import convert, nets, ops, static

    main, startup, (cost, _) = _program_of(lambda: sentiment_conv_net(
        static, ops, nets, SENT_VOCAB, SENT_EMB, SENT_HID, SENT_T, SENT_B))
    scope = static.Scope()
    static.Executor("cpu").run_startup(startup, scope=scope)
    init = {n: scope.numpy(n) for n in scope.var_names()}
    host = sentiment_batches(SENT_STEPS, SENT_VOCAB, SENT_T, SENT_B, SENT_MIN_LEN)
    feeds = [{k: torch.from_numpy(v).cuda() for k, v in f.items()} for f in host]
    cscope, exe = convert.scope_from_numpy(init), static.Executor()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(exe.run(main, feed=feeds[0], fetch_list=[cost], scope=cscope)[0])]
    first_ms = (time.perf_counter() - t0) * 1e3
    losses += [float(exe.run(main, feed=f, fetch_list=[cost], scope=cscope)[0])
               for f in feeds[1:SENT_PARITY_STEPS]]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(SENT_STEPS - SENT_PARITY_STEPS + 1)]
    ev[0].record()
    outs = []
    for i, f in enumerate(feeds[SENT_PARITY_STEPS:]):
        outs.append(exe.run(main, feed=f, fetch_list=[cost], scope=cscope, return_numpy=False)[0])
        ev[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)]
    losses += [float(o) for o in outs]
    graphs = (len(exe.store), exe.store.misses, exe.store.hits, exe.store.uncaptured)
    pscope = convert.scope_from_numpy(init, device="cpu")
    pexe = static.Executor("cpu")
    cpu = [float(pexe.run(main, feed=f, fetch_list=[cost], scope=pscope)[0])
           for f in host[:SENT_PARITY_STEPS]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu))
    escope = convert.scope_from_numpy(init)
    block = main.global_block()
    with torch.no_grad():
        exe._interpret(block, dict(feeds[0]), escope, [cost.name])
        torch.cuda.synchronize()
        eev = [torch.cuda.Event(enable_timing=True) for _ in range(SENT_EAGER_STEPS + 1)]
        eev[0].record()
        for i in range(SENT_EAGER_STEPS):
            exe._interpret(block, dict(feeds[i]), escope, [cost.name])
            eev[i + 1].record()
        torch.cuda.synchronize()
    eager_ms = [eev[i].elapsed_time(eev[i + 1]) for i in range(SENT_EAGER_STEPS)]
    median = float(np.median(step_ms))
    r = {"config": {"vocab": SENT_VOCAB, "emb": SENT_EMB, "hid": SENT_HID, "batch": SENT_B,
                    "seq_len": SENT_T, "lengths": [SENT_MIN_LEN, SENT_T], "filters": [3, 4],
                    "optimizer": f"static Adam lr {SENT_LR}"},
         "ops": len(block.ops), "losses": losses,
         "parity": {"card": losses[:SENT_PARITY_STEPS], "cpu": cpu, "rel": rel,
                    "rtol": SENT_LOSS_RTOL},
         "graphs_captures_replays_uncaptured": graphs, "first_step_and_capture_ms": first_ms,
         "captured_step_ms_median": median, "captured_step_ms_min": min(step_ms),
         "interpreted_step_ms_median": float(np.median(eager_ms)),
         "tokens_per_s": SENT_B * SENT_T / median * 1e3}
    log(f"sentiment conv net (vocab {SENT_VOCAB}, batch {SENT_B} x {SENT_T}, hid {SENT_HID}): "
        f"card {losses[:SENT_PARITY_STEPS]} vs CPU {cpu} (rel {rel:.3g}, rtol {SENT_LOSS_RTOL}); "
        f"captured step {median:.3f} ms median (min {min(step_ms):.3f}) against "
        f"{r['interpreted_step_ms_median']:.3f} ms interpreted; first step and capture "
        f"{first_ms:.0f} ms; graphs/captures/replays/uncaptured {graphs}")
    if not rel <= SENT_LOSS_RTOL:
        raise AssertionError(f"sentiment: the card's losses {rel} from the CPU's")
    if graphs != (1, 1, SENT_STEPS - 1, 0) or not np.isfinite(losses).all():
        raise AssertionError(f"sentiment: graphs {graphs}, losses {losses}")
    return r


def _yolo_loss_inputs(rng):
    """Head outputs of the three scales for a ``YOLO_LOSS_IN`` input and
    ``YOLO_GT_SLOTS`` ground-truth slots an image (5 to 40 real, the rest
    padding: label -1, box 0)."""
    xs = [(rng.randn(YOLO_LOSS_B, 3 * (5 + YOLO_CLASSES), YOLO_LOSS_IN // s, YOLO_LOSS_IN // s)
           * 0.5).astype(np.float32) for s in (32, 16, 8)]
    gt = np.zeros((YOLO_LOSS_B, YOLO_GT_SLOTS, 4), np.float32)
    lbl = np.full((YOLO_LOSS_B, YOLO_GT_SLOTS), -1, np.int32)
    for b in range(YOLO_LOSS_B):
        n = rng.randint(5, 41)
        gt[b, :n, :2] = rng.uniform(0.05, 0.95, (n, 2))
        gt[b, :n, 2:] = rng.uniform(0.02, 0.5, (n, 2))
        lbl[b, :n] = rng.randint(0, YOLO_CLASSES, n)
    return xs, gt, lbl


def _yolo_loss(ops, xs, gt, lbl):
    """The loss an image summed over the three scales."""
    total = 0
    for x, stride, mask in zip(xs, (32, 16, 8), YOLO_MASKS):
        total = total + ops.yolov3_loss(x, gt, lbl, YOLO_ANCHORS, mask, YOLO_CLASSES,
                                        ignore_thresh=0.7, downsample_ratio=stride)
    return total


def yolo_head():
    """(c) The YOLOv3 head: its loss at three scales for a 608 x 608 input
    at batch 8 forward and backward, against the CPU; its post-process
    (``yolo_box`` at three scales, ``multiclass_nms``) for a 416 x 416
    input as a static program on the card, held against a serial greedy
    NMS on the host over every class."""
    import torch

    from paddle_tpu_torch import ops, static

    xs, gt, lbl = _yolo_loss_inputs(np.random.RandomState(SENT_SEED))
    got = {}
    for dev in (TAIL_DEVICE, "cpu"):
        xt = [torch.from_numpy(x).to(dev).requires_grad_(True) for x in xs]
        loss = _yolo_loss(ops, xt, torch.from_numpy(gt).to(dev), torch.from_numpy(lbl).to(dev))
        loss.sum().backward()
        got[dev] = (loss.detach().cpu().numpy(), [x.grad.cpu().numpy() for x in xt])
    card, cpu = got[TAIL_DEVICE], got["cpu"]
    loss_rel = float(np.abs(card[0] - cpu[0]).max() / np.abs(cpu[0]).max())
    grad_err = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(card[1], cpu[1]))
    xt = [torch.from_numpy(x).cuda().requires_grad_(True) for x in xs]
    gtc, lblc = torch.from_numpy(gt).cuda(), torch.from_numpy(lbl).cuda()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(YOLO_TIMED + 1)]
    ev[0].record()
    for i in range(YOLO_TIMED):
        _yolo_loss(ops, xt, gtc, lblc).sum().backward()
        ev[i + 1].record()
    torch.cuda.synchronize()
    loss_ms = float(np.median([ev[i].elapsed_time(ev[i + 1]) for i in range(YOLO_TIMED)]))

    main, _, (rows, num, boxes, scores) = _program_of(
        lambda: yolo_post_process(static, ops, YOLO_CLASSES, YOLO_POST_IN))
    feed = {k: torch.from_numpy(v).cuda() for k, v in yolo_heads(YOLO_CLASSES,
                                                                  YOLO_POST_IN).items()}
    exe = static.Executor()
    fetch = [rows, num, boxes, scores]
    fetched = exe.run(main, feed=feed, fetch_list=fetch)
    run_ms = []
    for _ in range(YOLO_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = exe.run(main, feed=feed, fetch_list=fetch)
        run_ms.append((time.perf_counter() - t0) * 1e3)
    want, count = greedy_rows(fetched[2], fetched[3], YOLO_CONF, YOLO_NMS, YOLO_KEEP)
    passing = int((fetched[3] >= YOLO_CONF).sum())
    graphs = (len(exe.store), exe.store.misses, exe.store.hits, exe.store.uncaptured)
    r = {"loss": {"input": YOLO_LOSS_IN, "batch": YOLO_LOSS_B, "classes": YOLO_CLASSES,
                  "gt_slots": YOLO_GT_SLOTS, "real_boxes": int((lbl >= 0).sum()),
                  "loss_rel": loss_rel, "grad_err": grad_err, "grad_rtol": YOLO_GRAD_RTOL,
                  "fwd_bwd_ms_median": loss_ms},
         "post_process": {"input": YOLO_POST_IN, "boxes": int(fetched[2].shape[0]),
                          "passing_pairs": passing, "kept": int(fetched[1]),
                          "oracle_kept": count, "run_ms_median": float(np.median(run_ms)),
                          "graphs_captures_replays_uncaptured": graphs}}
    log(f"YOLOv3 head: loss at {YOLO_LOSS_IN}^2 batch {YOLO_LOSS_B} (3 scales, "
        f"{r['loss']['real_boxes']} real boxes in {YOLO_LOSS_B} x {YOLO_GT_SLOTS} slots) card vs CPU "
        f"loss {loss_rel:.3g}, gradient {grad_err:.3g} of its largest entry (limit "
        f"{YOLO_GRAD_RTOL}), forward + backward {loss_ms:.3f} ms; post-process at "
        f"{YOLO_POST_IN}^2: {passing} (box, class) pairs pass {YOLO_CONF} of "
        f"{fetched[2].shape[0]} boxes x {YOLO_CLASSES}, {int(fetched[1])} rows kept (oracle "
        f"{count}), {r['post_process']['run_ms_median']:.2f} ms a run uncaptured; "
        f"graphs/captures/replays/uncaptured {graphs}")
    if not (loss_rel <= SENT_LOSS_RTOL and grad_err <= YOLO_GRAD_RTOL):
        raise AssertionError(f"YOLOv3 loss: card vs CPU loss {loss_rel}, gradient {grad_err}")
    if not (np.array_equal(fetched[0], want) and int(fetched[1]) == count
            and np.array_equal(again[0], want)):
        raise AssertionError("YOLOv3 post-process: the card's rows are not the serial greedy "
                             f"oracle's ({int(fetched[1])} vs {count} kept)")
    if not 100 <= passing <= 10000 or graphs != (0, 1, 0, YOLO_TIMED + 1):
        raise AssertionError(f"YOLOv3 post-process: {passing} passing pairs, graphs {graphs}")
    return r


def registry_tail():
    """Phase 12p: the registry's last five families on the card. (a) every
    new op type once against the CPU, (b) the book's sentiment conv net
    trained as a static program, (c) a YOLOv3 head's loss and
    post-process. None of the 16 kernels runs: the counts must stay 0.
    Returns (launches per name, readings)."""
    import torch

    from paddle_tpu_torch.device import card_identity
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_launch_counts()
    r = {"card": card_identity(), "sweep": _tail_sweep()}
    t_b = time.perf_counter()
    r["sentiment"] = train_sentiment_static()
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    r["yolov3"] = yolo_head()
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    r["launches"] = counts
    r["parts_s"] = {"a": t_b - t_phase, "b": t_c - t_b, "c": time.perf_counter() - t_c}
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"ops tail: phase 12p done in {r['phase_s']:.1f} s ({r['parts_s']}); launches {counts}")
    if counts:
        raise AssertionError(f"ops tail: the phase launched {counts}; it runs none of the kernels")
    return counts, r


# -- the data path and the high-level API (phase 12q) ------------------------------------

HAPI_IMAGES, HAPI_HW, HAPI_CROP = 1280, 256, 224  # seeded uint8 images, 256 x 256 x 3
HAPI_B, HAPI_WORKERS, HAPI_STEPS = 128, 4, 10  # 1,280 / 128 = fit's 10 steps
HAPI_DEVICE = "cuda"  # "cpu" rehearses the phase off the card
HAPI_EVAL_BATCHES, HAPI_PREDICT_BATCHES = 2, 1
HAPI_PARITY_BATCHES = 2  # the deterministic loader's batches held card against host
HAPI_SEED = 28
HAPI_WD = 1e-4  # Momentum's L2 decay
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
VGG_B, VGG_STEPS = 32, 3
VGG_POOLS = tuple((VGG_B, c, hw, hw) for c, hw in ((64, 224), (128, 112), (256, 56),
                                                  (512, 28), (512, 14)))
ZOO_B, ZOO_CPU_ROWS = 32, 4  # the eval forward's batch; its first rows also run on the CPU


def _hapi_dataset(transform):
    """An ``io.Dataset`` of ``HAPI_IMAGES`` seeded uint8 HWC images and int64
    labels over ``RN_CLASSES``, each sample through ``transform``."""
    from paddle_tpu_torch import io

    class SeededImages(io.Dataset):
        def __init__(self, images, labels, transform):
            self.images, self.labels, self.transform = images, labels, transform

        def __getitem__(self, i):
            return self.transform(self.images[i]), self.labels[i]

        def __len__(self):
            return len(self.images)

    rng = np.random.RandomState(HAPI_SEED)
    images = rng.randint(0, 256, (HAPI_IMAGES, HAPI_HW, HAPI_HW, 3), dtype=np.uint8)
    labels = rng.randint(0, RN_CLASSES, HAPI_IMAGES).astype(np.int64)
    return SeededImages(images, labels, transform)


def _io_counts():
    from paddle_tpu_torch.monitor import registry

    return {k: registry.counter(f"io/{k}").value for k in ("ring_batches", "queue_batches")}


def _hapi_det_transform(paddle):
    T = paddle.vision.transforms
    return T.Compose([T.ToTensor(), T.CenterCrop(HAPI_CROP),
                      T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])


def _hapi_loader_parity(paddle, ds):
    """The deterministic loader (``ToTensor``, ``CenterCrop``, ``Normalize``;
    4 workers, no shuffle) over the dataset's first ``HAPI_PARITY_BATCHES``
    batches on the card against the same loader's numpy batches
    (``use_buffer_reader=False``): bit-equal batch for batch. The card pass
    gives the images/s the workers deliver through the transport."""
    import torch

    ds.transform = _hapi_det_transform(paddle)
    sub = paddle.io.Subset(ds, range(HAPI_PARITY_BATCHES * HAPI_B))
    before = _io_counts()
    t0 = time.perf_counter()
    card = [(x.clone(), y.clone()) for x, y in paddle.io.DataLoader(
        sub, batch_size=HAPI_B, num_workers=HAPI_WORKERS, shuffle=False)]
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = list(paddle.io.DataLoader(sub, batch_size=HAPI_B, num_workers=HAPI_WORKERS,
                                     shuffle=False, use_buffer_reader=False))
    host_s = time.perf_counter() - t0
    after = _io_counts()
    if len(card) != len(host) or len(card) != HAPI_PARITY_BATCHES:
        raise AssertionError(f"loader parity: {len(card)} batches on the card, {len(host)} on "
                             "the host")
    for i, ((cx, cy), (hx, hy)) in enumerate(zip(card, host)):
        if cx.device.type != HAPI_DEVICE or cx.dtype != torch.float32:
            raise AssertionError(f"loader batch {i} is {cx.dtype} on {cx.device}")
        if not (torch.equal(cx.cpu(), torch.from_numpy(hx))
                and torch.equal(cy.cpu(), torch.from_numpy(hy))):
            raise AssertionError(f"loader batch {i}: the card's batch differs from the host's")
    n = len(sub)
    r = {"batches": len(card), "bit_equal": True, "card_pass_s": card_s,
         "host_pass_s": host_s, "delivered_images_per_s": n / card_s,
         "transport": {k: after[k] - before[k] for k in after}}
    log(f"hapi: the deterministic loader's {len(card)} batches on the card bit-equal to its "
        f"numpy batches (card pass {card_s:.2f} s, host pass {host_s:.2f} s: "
        f"{n / card_s:.1f} images/s delivered by {HAPI_WORKERS} workers; transport "
        f"{r['transport']})")
    return r


def _hapi_transform_rate(paddle, ds):
    """The training transform alone in this process, on ``HAPI_B`` images,
    and the collate: images/s of one worker's work without the transport."""
    from paddle_tpu_torch.io import default_collate_fn

    tf = _hapi_train_transform(paddle)
    t0 = time.perf_counter()
    batch = default_collate_fn([(tf(ds.images[i]), ds.labels[i]) for i in range(HAPI_B)])
    dt = time.perf_counter() - t0
    r = {"images": HAPI_B, "s": dt, "images_per_s_one_process": HAPI_B / dt,
         "batch_bytes": int(batch[0].nbytes + batch[1].nbytes)}
    log(f"hapi: the training transform and collate run {HAPI_B / dt:.1f} images/s in one "
        f"process; a batch is {r['batch_bytes'] / 2**20:.1f} MiB")
    return r


def _hapi_train_transform(paddle):
    T = paddle.vision.transforms
    return T.Compose([T.ToTensor(), T.RandomCrop(HAPI_CROP), T.RandomHorizontalFlip(),
                      T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])


def _hapi_model(paddle, net):
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM,
                                            parameters=net.parameters(),
                                            weight_decay=paddle.optimizer.L2Decay(HAPI_WD)),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy(topk=(1, 5)),
                  amp_configs="O1")
    return model


def _hapi_fit(paddle, ds):
    """(a) ResNet-50 through ``Model.fit`` over the 4-worker loader, then
    ``evaluate``, ``predict``, ``save`` and ``Model.load``; the bare captured
    step on fit's first batch from the same weights."""
    import torch

    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.monitor import registry
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    net = _resnet50(seed=HAPI_SEED)
    ref_net = copy.deepcopy(net)
    model = _hapi_model(paddle, net)
    first = {}
    train_batch = model.train_batch

    def recording(xs, ys=None):
        if not first:
            first["batch"] = [xs[0].clone(), ys.clone()]
        out = train_batch(xs, ys)
        if "loss" not in first:
            first["loss"] = out["loss"]
        return out

    model.train_batch = recording

    class Clock(Callback):
        def __init__(self):
            self.t, self.losses = [time.perf_counter()], []

        def on_train_batch_end(self, step, logs=None):
            self.t.append(time.perf_counter())
            self.losses.append(logs["loss"])

    ds.transform = _hapi_train_transform(paddle)
    loader = paddle.io.DataLoader(ds, batch_size=HAPI_B, num_workers=HAPI_WORKERS,
                                  shuffle=True, drop_last=True)
    np.random.seed(HAPI_SEED)
    clock = Clock()
    before = _io_counts()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # ProgBarLogger's lines
        model.fit(loader, epochs=1, verbose=1, log_freq=5, callbacks=[clock])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    transport = {k: v - before[k] for k, v in _io_counts().items()}
    want = _rn_amp_step_launches(HAPI_STEPS)
    if counts != want:
        raise AssertionError(f"hapi fit: {HAPI_STEPS} steps launched {counts}; want {want}")
    store = model._train_step.store
    if HAPI_DEVICE == "cuda" and (store.misses != 1 or store.hits != HAPI_STEPS - 1):
        raise AssertionError(f"hapi fit: {store.misses} captures and {store.hits} replays; want "
                             f"1 and {HAPI_STEPS - 1}")
    losses = clock.losses
    if len(losses) != HAPI_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"hapi fit losses: {losses}")
    step_ms = np.diff(clock.t)[2:] * 1e3  # the replays after the first
    wait = registry.gauge("monitor/fit/input_wait_ratio").value
    r = {"losses": losses, "fit_s": fit_s, "step_ms": step_ms.tolist(),
         "step_ms_median": float(np.median(step_ms)), "input_wait_ratio": wait,
         "transport": transport, "captures": store.misses, "replays": store.hits,
         "launches": {k: v for k, v in counts.items() if v}}
    log(f"hapi fit: {HAPI_STEPS} steps in {fit_s:.2f} s, losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; one capture, {store.hits} replays; median "
        f"step {r['step_ms_median']:.2f} ms on the host clock (replays, loss read each step), "
        f"input_wait_ratio {wait:.3f}; "
        f"batches by the ring {transport['ring_batches']}, by the queue "
        f"{transport['queue_batches']}; launches a step "
        f"{ {k: v // HAPI_STEPS for k, v in counts.items() if v} }")

    # evaluate and predict: eval forwards in f32, 33 fused eval launches each
    ds.transform = _hapi_det_transform(paddle)
    eval_ds = paddle.io.Subset(ds, range(HAPI_EVAL_BATCHES * HAPI_B))
    pred_ds = paddle.io.Subset(ds, range(HAPI_PREDICT_BATCHES * HAPI_B))
    reset_launch_counts()
    ev = model.evaluate(eval_ds, batch_size=HAPI_B, num_workers=HAPI_WORKERS, verbose=0)
    torch.cuda.synchronize()
    ev_counts = launch_counts()
    reset_launch_counts()
    out = model.predict(pred_ds, batch_size=HAPI_B, num_workers=HAPI_WORKERS)
    torch.cuda.synchronize()
    pr_counts = launch_counts()
    want_eval = {k: 0 for k in ev_counts}
    want_eval["conv_bn_relu_mm_affine_relu"] = RN_TRIPLES * HAPI_EVAL_BATCHES
    want_pred = dict(want_eval, conv_bn_relu_mm_affine_relu=RN_TRIPLES * HAPI_PREDICT_BATCHES)
    if ev_counts != want_eval or pr_counts != want_pred:
        raise AssertionError(f"hapi evaluate launched {ev_counts}, predict {pr_counts}; want "
                             f"{want_eval}, {want_pred}")
    if not (np.isfinite(ev["loss"]) and 0 <= ev["acc_top1"] <= ev["acc_top5"] <= 1):
        raise AssertionError(f"hapi evaluate: {ev}")
    if len(out) != 1 or out[0].shape != (HAPI_B, RN_CLASSES) or not np.isfinite(out[0]).all():
        raise AssertionError(f"hapi predict: {[o.shape for o in out]}")
    # save, load into a fresh Model, predict again
    with tempfile.TemporaryDirectory(prefix="ptt_hapi_") as d:
        model.save(f"{d}/final")
        fresh = _hapi_model(paddle, _resnet50(seed=HAPI_SEED + 1))
        fresh.load(f"{d}/final")
        out2 = fresh.predict(pred_ds, batch_size=HAPI_B, num_workers=HAPI_WORKERS)
    load_err = float(np.abs(out2[0] - out[0]).max() / np.abs(out[0]).max())
    if load_err > RN_SERVE_RTOL:
        raise AssertionError(f"hapi load: predict after Model.load differs by {load_err} of the "
                             f"largest logit (limit {RN_SERVE_RTOL})")
    r.update(evaluate=ev, predict_shape=list(out[0].shape), load_rel_err=load_err,
             load_bit_equal=bool(np.array_equal(out2[0], out[0])),
             eval_launches={k: v for k, v in ev_counts.items() if v},
             predict_launches={k: v for k, v in pr_counts.items() if v})
    log(f"hapi evaluate on {HAPI_EVAL_BATCHES} batches: {ev}; predict {list(out[0].shape)}; "
        f"after save and Model.load the predict output is {load_err:.3g} of the largest logit "
        f"away (bit-equal: {r['load_bit_equal']}); launches evaluate {r['eval_launches']}, "
        f"predict {r['predict_launches']}")
    del model, fresh
    torch.cuda.empty_cache()

    # the bare captured step on fit's first batch, from the same weights
    ref = _hapi_model(paddle, ref_net)
    step = ref._build_train_step()
    bare = [float(step(*first["batch"])["loss"])]
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    for _ in range(6):
        bare.append(float(step(*first["batch"])["loss"]))
        t.append(time.perf_counter())
    bare_ms = np.diff(t)[1:] * 1e3
    err = abs(bare[0] - first["loss"])
    r.update(bare_first_loss=bare[0], fit_first_loss=first["loss"], first_loss_err=err,
             bare_step_ms_median=float(np.median(bare_ms)), bare_losses=bare)
    log(f"hapi: fit's first loss {first['loss']:.6f}, the bare captured train_step's on the same "
        f"batch and weights {bare[0]:.6f} (err {err:.3g}, limit {RN_AMP_LOSS_ATOL}); the bare "
        f"step's replays {r['bare_step_ms_median']:.2f} ms median on the host clock with the loss "
        f"read, fit's {r['step_ms_median']:.2f} ms")
    if err > RN_AMP_LOSS_ATOL:
        raise AssertionError(f"hapi: fit's first loss {first['loss']} differs from the bare step's "
                             f"{bare[0]} by {err}")
    del ref, step
    torch.cuda.empty_cache()
    return counts, ev_counts, pr_counts, r


def _hapi_vgg(paddle):
    """(b) VGG-16 in f32 at batch 32: three ``Model.train_batch`` steps with
    the pool kernel launched at its five pools a step."""
    import torch

    from paddle_tpu_torch.models import vgg16
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    net = vgg16(num_classes=RN_CLASSES, generator=torch.Generator().manual_seed(HAPI_SEED))
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(learning_rate=0.01, momentum=RN_MOMENTUM,
                                            parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss())
    rng = np.random.RandomState(HAPI_SEED)
    x = rng.randn(VGG_B, 3, RN_HW, RN_HW).astype(np.float32)
    y = rng.randint(0, RN_CLASSES, VGG_B).astype(np.int64)
    torch.cuda.synchronize()
    reset_launch_counts()
    t = [time.perf_counter()]
    losses = []
    for _ in range(VGG_STEPS):
        losses.append(model.train_batch([x], [y])["loss"])
        t.append(time.perf_counter())
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["max_pool2d_backward"] != len(VGG_POOLS) * VGG_STEPS or not all(
            np.isfinite(losses)):
        raise AssertionError(f"VGG-16: {VGG_STEPS} steps launched {counts}, losses {losses}")
    r = {"losses": losses, "step_s": np.diff(t).tolist(),
         "launches": {k: v for k, v in counts.items() if v}}
    log(f"hapi VGG-16 f32 batch {VGG_B}: {VGG_STEPS} train_batch steps, losses {losses}, "
        f"wall {', '.join(f'{v:.2f}' for v in r['step_s'])} s; launches {r['launches']}")
    del model, net
    torch.cuda.empty_cache()
    return counts, r


def _hapi_zoo(paddle):
    """(c) MobileNetV2 and SE-ResNeXt-50 eval forwards at batch 32 through
    ``Model.predict_batch`` against the CPU forward of the same weights on
    the first rows (eval batch norm is per sample)."""
    import torch

    from paddle_tpu_torch.models import mobilenet_v2, se_resnext50_32x4d

    rng = np.random.RandomState(HAPI_SEED + 2)
    x = rng.randn(ZOO_B, 3, RN_HW, RN_HW).astype(np.float32)
    r = {}
    for name, make in (("mobilenet_v2", mobilenet_v2), ("se_resnext50_32x4d",
                                                         se_resnext50_32x4d)):
        net = make(num_classes=RN_CLASSES, generator=torch.Generator().manual_seed(HAPI_SEED))
        cpu = copy.deepcopy(net).eval()
        model = paddle.Model(net)
        t0 = time.perf_counter()
        out = model.predict_batch([x]).cpu().numpy()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu(torch.from_numpy(x[:ZOO_CPU_ROWS])).numpy()
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(out[:ZOO_CPU_ROWS] - want).max() / np.abs(want).max())
        r[name] = {"rel_err": err, "card_s": card_s, "cpu_s": cpu_s, "shape": list(out.shape)}
        log(f"hapi {name}: eval forward at batch {ZOO_B} on the card ({card_s:.2f} s), rows "
            f"0-{ZOO_CPU_ROWS - 1} against the CPU ({cpu_s:.2f} s): {err:.3g} of the largest "
            f"logit (limit {RN_SERVE_RTOL})")
        if out.shape != (ZOO_B, RN_CLASSES) or not np.isfinite(out).all() or err > RN_SERVE_RTOL:
            raise AssertionError(f"hapi {name}: {r[name]}")
        del model, net, cpu
    torch.cuda.empty_cache()
    return r


def hapi_paths():
    """Phase 12q: a Paddle 2.0 image-classification script on the port. (a)
    ResNet-50 trained by ``Model.fit`` from a 4-worker ``DataLoader`` under
    AMP with the pool kernel on, then evaluated, predicted, saved and
    loaded; (b) VGG-16's steps through its five pools; (c) MobileNetV2 and
    SE-ResNeXt-50 eval forwards. Returns (launches per name over the phase,
    also-checked kernel entries by name, readings)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.flags import set_flags

    t_phase = time.perf_counter()
    set_flags({"use_pallas_pool_bwd": True})
    try:
        ds = _hapi_dataset(None)
        r = {"data_s": time.perf_counter() - t_phase}
        r["loader"] = _hapi_loader_parity(paddle, ds)
        r["transform"] = _hapi_transform_rate(paddle, ds)
        t_a = time.perf_counter()
        fit_counts, ev_counts, pr_counts, r["fit"] = _hapi_fit(paddle, ds)
        del ds
        t_b = time.perf_counter()
        also = {"max_pool2d_backward": [
            check_pool_backward_lenet(s, row="16g", path="VGG-16 batch 32 (12q)", iters=10)
            for s in VGG_POOLS]}
        vgg_counts, r["vgg16"] = _hapi_vgg(paddle)
        t_c = time.perf_counter()
        r["zoo"] = _hapi_zoo(paddle)
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    t_d = time.perf_counter()
    entry = check_conv_serving(HAPI_B, per_product=False)
    entry["path"] = "12q evaluate and predict, batch 128"
    also["conv_bn_relu_mm_affine_relu"] = [entry]
    counts = {k: fit_counts[k] + ev_counts[k] + pr_counts[k] + vgg_counts[k] for k in fit_counts}
    r["launches"] = {k: v for k, v in counts.items() if v}
    r["parts_s"] = {"data_and_loaders": t_a - t_phase, "a": t_b - t_a, "b": t_c - t_b,
                    "c": t_d - t_c, "eval_products_check": time.perf_counter() - t_d}
    r["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    log(f"hapi: phase 12q done in {r['phase_s']:.1f} s ({r['parts_s']})")
    return counts, also, r


# the sources rewritten last, whose registers and spills the run logs
PTXAS_SOURCES = ("flash_attention", "flash_attention_bwd", "flash_attention_bf16",
                 "flash_attention_bwd_bf16", "layernorm_residual", "layernorm_residual_bwd",
                 "optimizer_update",
                 "conv_bn_relu_mm", "conv_bn_relu_mm_bf16", "conv_bn_relu_bn", "int8_matmul",
                 "pool_backward")
# of those, the sources whose kernels must not spill
NO_SPILL_SOURCES = ("conv_bn_relu_mm", "conv_bn_relu_mm_bf16", "conv_bn_relu_bn", "int8_matmul",
                    "pool_backward")


def start_ptxas(names=PTXAS_SOURCES):
    """One ``nvcc -Xptxas -v`` per source into a temporary directory,
    started at once (beside the build): returns (directory, processes)."""
    import os
    import subprocess

    from paddle_tpu_torch.ops.cuda import _build

    tmp = tempfile.mkdtemp(prefix="ptt_ptxas_")
    procs = [(n, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(tmp, f"{n}.so"), os.path.join(_build.CSRC_DIR, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)) for n in names]
    return tmp, procs


def finish_ptxas(tmp, procs):
    """Wait for :func:`start_ptxas`'s compilers and log each kernel's
    registers, spills and static shared memory. Returns ``{source:
    {kernel: {...}}}``."""
    import re
    import shutil
    import subprocess

    report = {}
    for name, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{text}")
        if shutil.which("c++filt"):
            text = subprocess.run(["c++filt"], input=text, capture_output=True, text=True).stdout
        kernels, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(.*)' for", line)
            if m:
                cur = m.group(1).replace("(anonymous namespace)::", "")
                cur = re.sub(r"\(.*", "", cur).removeprefix("void ")
                kernels[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                kernels[cur].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[cur]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                kernels[cur]["static_smem"] = int(sm.group(1)) if sm else 0
        report[name] = kernels
        for kname, info in kernels.items():
            log(f"ptxas {name}.cu {kname}: {info}")
            if name in NO_SPILL_SOURCES and (info.get("spill_stores") or info.get("spill_loads")):
                raise AssertionError(f"{name}.cu {kname} spills: {info}")
    shutil.rmtree(tmp, ignore_errors=True)
    return report


def main() -> int:
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("CUDA is not available: this script runs only on the card")
        return 2
    try:
        from paddle_tpu_torch.device import card_identity
        from paddle_tpu_torch.ops.cuda import _build
    except ImportError as e:
        log(f"paddle_tpu_torch is not beside this script: {e}")
        return 2
    card = card_identity()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    ptxas = start_ptxas()
    _build.build_all()
    log(f"built {', '.join(_build.KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    registers = finish_ptxas(*ptxas)
    # the wgmma kernels, and the LayerNorm forward's warp-a-row instances
    for src in ("flash_attention_bf16", "flash_attention_bwd_bf16", "conv_bn_relu_mm_bf16",
                "layernorm_residual"):
        for kname, info in registers[src].items():
            print(f"ptxas {src}.cu {kname}: {json.dumps(info)}")

    kernels = (check_kernels() + check_amp_kernels() + check_resnet_kernels() + check_new_kernels()
               + check_resnet_kernels_bf16())
    for name, entry in check_layernorm_h512().items():  # new shapes of rows 1, 1b, 2, 2b
        next(k for k in kernels if k["name"] == name).setdefault("also_checked", []).append(entry)
    served, serving = {}, {}
    served["bert"], serving["bert"] = serve_bert()
    trained = train_bert()
    torch.cuda.empty_cache()
    amp_trained, amp = train_bert_amp()
    torch.cuda.empty_cache()
    served["resnet"], serving["resnet"] = serve_resnet()
    served["int8"], serving["int8"] = serve_int8()
    torch.cuda.empty_cache()
    served["resnet_static"], serving["resnet_static"] = serve_resnet_static()
    rn_trained = train_resnet()
    torch.cuda.empty_cache()
    rn_amp_trained, rn_amp = train_resnet_amp()
    torch.cuda.empty_cache()
    rn_amp_served, rn_amp["eval"] = eval_resnet_amp()
    torch.cuda.empty_cache()
    compiled_counts, compiled = compiled_steps()
    s2s_counts, s2s = train_seq2seq_and_ernie()
    torch.cuda.empty_cache()
    lenet_counts, lenet = train_lenet_static()
    torch.cuda.empty_cache()
    ptb_counts, ptb = train_ptb_lm_static()
    torch.cuda.empty_cache()
    lamb_counts, lamb = train_bert_lamb(compiled["bert_amp"]["captured"]["step_ms_median"])
    lenet_opt_counts, lenet_opt = train_lenet_optimizers()
    gpt_counts, gpt = serve_gpt()
    paged_counts, gpt_paged = serve_gpt_paged()
    spec_counts, gpt_spec = serve_gpt_speculative()
    torch.cuda.empty_cache()
    fleet_counts, fleet = serve_fleet(card)
    dygraph_counts, dygraph = dygraph_resnet()
    monitored_counts, monitored = monitored_steps()
    to_static_counts, to_static = to_static_paths()
    torch.cuda.empty_cache()
    tail_counts, ops_tail = registry_tail()
    torch.cuda.empty_cache()
    hapi_counts, hapi_also, hapi = hapi_paths()
    for name, entries in hapi_also.items():
        next(k for k in kernels if k["name"] == name).setdefault("also_checked", []).extend(
            entries)
    for k in kernels:
        name = k["name"]
        k["launches_serving"] = (sum(c[name] for c in served.values()) + rn_amp_served[name]
                                 + s2s_counts["serving"].get(name, 0))
        k["launches_training"] = (trained[name] + amp_trained[name] + rn_trained[name]
                                  + rn_amp_trained[name] + s2s_counts["training"].get(name, 0))
        # replayed in CUDA graphs (BERT under Lamb, LeNet under the other optimizers too)
        k["launches_compiled"] = (compiled_counts[name] + s2s_counts["compiled"].get(name, 0)
                                  + lamb_counts.get(name, 0) + lenet_opt_counts.get(name, 0))
        # the LeNet program's steps, replayed from the static executor's graph,
        # and the PTB LM's (12f2): none, checked
        k["launches_static"] = lenet_counts.get(name, 0) + ptb_counts.get(name, 0)
        # GPT-2 small's generation (pre-norm, cached attention; the ring, the
        # int8 ring and the paged layout, 12i and 12j; speculative decoding
        # and the handoff, 12k): none, checked
        k["launches_generation"] = (gpt_counts.get(name, 0) + paged_counts.get(name, 0)
                                    + spec_counts.get(name, 0))
        # the predict backend processes of the fleet (12l), read from their /statz
        k["launches_fleet"] = fleet_counts.get(name, 0)
        # the Paddle-style ResNet-50 of 12m: its dygraph steps and its jit.save
        # program's replays
        k["launches_dygraph"] = dygraph_counts.get(name, 0)
        # the captured AMP steps of BERT and ResNet-50 inside a TrainingMonitor (12n)
        k["launches_monitored"] = monitored_counts.get(name, 0)
        # to_static's BERT-base `if` replayed from its graphs, and the
        # Transformer-base decode's uncaptured loop (12o)
        k["launches_to_static"] = to_static_counts.get(name, 0)
        # the registry's last families, the sentiment conv net and the
        # YOLOv3 head (12p): none, checked
        k["launches_ops_tail"] = tail_counts.get(name, 0)
        # Model.fit over the 4-worker DataLoader, evaluate, predict; VGG-16 (12q)
        k["launches_hapi"] = hapi_counts.get(name, 0)
        k["launches"] = (k["launches_serving"] + k["launches_training"] + k["launches_compiled"]
                         + k["launches_static"] + k["launches_generation"]
                         + k["launches_fleet"] + k["launches_dygraph"]
                         + k["launches_monitored"] + k["launches_to_static"]
                         + k["launches_ops_tail"] + k["launches_hapi"])
        src = k["source"].rsplit("/", 1)[-1][:-len(".cu")]
        if src in registers:
            k["ptxas"] = registers[src]
    print(card)
    print(json.dumps({"kernels": kernels, "amp_bert_training": amp, "amp_resnet": rn_amp,
                      "compiled": compiled, "serving": serving, "seq2seq_ernie": s2s,
                      "lenet_static": lenet, "ptb_lm_static": ptb, "bert_lamb": lamb,
                      "lenet_optimizers": lenet_opt,
                      "gpt_generation": gpt, "gpt_int8_paged": gpt_paged,
                      "gpt_speculative_handoff": gpt_spec, "serving_fleet": fleet,
                      "dygraph_front_end": dygraph, "monitor": monitored,
                      "to_static": to_static, "ops_tail": ops_tail, "hapi": hapi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
